"""Write the port's SVHN CNN asset at the published 32x32 frame.

The JAX package compiles VALID convolutions only, so this design is built
by the port alone, and the script imports no JAX.  The weights are the
port's ``init_params(PRNGKey(SEED), svhn_cnn_32(), (32, 32, 3))`` draw
(Glorot-uniform float32, zero biases), compiled with
``CompileConfig(jobs=1)`` on the CPU and saved as a ``da4ml-design``
artifact under ``src/repro_torch/assets/svhn_cnn_32/``, with:

* ``params.npz``: those float32 weights, keys the ``"/"``-joined layer
  paths (``"0/w"``, ``"9/b"``), as beside the other assets;
* ``golden.npz``: ``x``, 1024 inputs drawn with ``np.random.default_rng(0)``
  over the whole 8-bit pixel grid (uint8), and ``y``, the design's
  ``forward_int`` of ``x`` as int32, checked equal to the numpy
  interpreter first.

It also writes the benchmark's copy of the weights,
``dabench/configs/svhn_cnn_32.params.npz``, from which the plain
reference quantizes them itself.  Run from the repository root:

    PYTHONPATH=src python tools/make_svhn_cnn_32.py

The draw, the solve and the arrays are deterministic: a rerun writes the
same ``arrays_sha256``.
"""

from __future__ import annotations

import shutil
import time
from pathlib import Path

import numpy as np
import torch

from repro_torch.flow import CompileConfig
from repro_torch.nn import compile_model, init_params, models, numpy_forward_fn
from repro_torch.random import PRNGKey
from repro_torch.runtime import save_design

ROOT = Path(__file__).resolve().parent.parent
ASSET = ROOT / "src" / "repro_torch" / "assets" / "svhn_cnn_32"
BENCH_PARAMS = ROOT / "dabench" / "configs" / "svhn_cnn_32.params.npz"
SEED = 0
N_GOLDEN = 1024


def flat_params(params) -> dict[str, np.ndarray]:
    """A parameter list as ``{"<layer>/<name>": float32 array}``."""
    return {f"{i}/{k}": v.detach().cpu().numpy().astype(np.float32)
            for i, p in enumerate(params) for k, v in sorted(p.items())}


def build(device: str = "cpu"):
    """The design and its float weights, from the stated seed."""
    model, in_shape, in_quant = models.svhn_cnn_32()
    params, _ = init_params(PRNGKey(SEED), model, in_shape, device=device)
    design = compile_model(model, params, in_shape, in_quant, config=CompileConfig(jobs=1),
                           device=device)
    return design, params


def main() -> None:
    t0 = time.perf_counter()
    design, params = build()
    print(f"svhn_cnn_32: compiled in {time.perf_counter() - t0:.1f} s, "
          f"{design.total_adders} adders, {len(design.tables)} tables")
    q = design.in_quant.qint
    x = np.random.default_rng(0).integers(q.lo, q.hi + 1, size=(N_GOLDEN, *design.in_shape))
    x = x.astype(np.uint8)
    x32 = x.astype(np.int32)
    y = design.forward_int(torch.from_numpy(x32)).numpy().astype(np.int32)
    np.testing.assert_array_equal(y, numpy_forward_fn(design)(x32))
    if ASSET.exists():
        shutil.rmtree(ASSET)
    save_design(design, ASSET)
    flat = flat_params(params)
    np.savez(ASSET / "params.npz", **flat)
    np.savez(BENCH_PARAMS, **flat)
    np.savez_compressed(ASSET / "golden.npz", x=x, y=y)
    size = sum(f.stat().st_size for f in ASSET.iterdir())
    print(f"svhn_cnn_32: wrote {ASSET} ({size} bytes) and {BENCH_PARAMS}")


if __name__ == "__main__":
    main()
