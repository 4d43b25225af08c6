"""Production mesh definition: the port of the JAX package's
``repro.launch.mesh``.

Single pod: 16x16 = 256 ranks, mesh dims ("data", "model").
Multi-pod:  2x16x16 = 512 ranks, mesh dims ("pod", "data", "model") -- the
"pod" dim carries data parallelism across pods (and optionally FSDP for
the 1T-parameter cells via ``fsdp_over_pod``).

Both are built by ``init_device_mesh`` over the process group the caller
started (``torchrun``, a gloo group in the tests, the ``fake`` group of
the dry-run); with a world size other than the mesh's it raises.  The
functions are called, never run at import: importing this module
touches no process group and no device.
"""

from __future__ import annotations

import math

import torch.distributed as dist
from torch.distributed.device_mesh import init_device_mesh


def _make_mesh(shape: tuple[int, ...], names: tuple[str, ...], device_type: str):
    n = math.prod(shape)
    if not dist.is_initialized():
        raise RuntimeError(f"a {shape} mesh needs a process group of {n} ranks; none is "
                           "initialised (launch with torchrun, or init_process_group)")
    if dist.get_world_size() != n:
        raise RuntimeError(f"a {shape} {names} mesh needs {n} ranks, the process group has "
                           f"{dist.get_world_size()}")
    return init_device_mesh(device_type, shape, mesh_dim_names=names)


def make_production_mesh(*, multi_pod: bool = False, device_type: str = "cuda"):
    shape = (2, 16, 16) if multi_pod else (16, 16)
    names = ("pod", "data", "model") if multi_pod else ("data", "model")
    return _make_mesh(shape, names, device_type)


def make_test_mesh(data: int = 2, model: int = 2, device_type: str = "cuda"):
    """Small ("data", "model") mesh: the tests ask for ``device_type="cpu"``
    over gloo ranks; on one card, ``make_test_mesh(1, 1)``."""
    return _make_mesh((data, model), ("data", "model"), device_type)
