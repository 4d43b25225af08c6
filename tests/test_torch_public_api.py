"""The port's public surface against the JAX package's pinned one.

Every name under the four packages of ``tests/public_api_snapshot.json``
(``repro.flow``, ``repro.core``, ``repro.nn``, ``repro.runtime``) exists
in the ``repro_torch`` counterpart, exported in ``__all__``, of the same
kind, with the pinned members (the port may have more), and with the
pinned signature except for this short list of documented differences:

* ``device=``: the port's entry points take a device (default: the CUDA
  card); a signature equal to the pinned one once its ``device``
  parameter is taken out counts as equal;
* torch types for jnp types in annotations (``torch.Tensor`` for
  ``jnp.ndarray``);
* ``nn.init_params``'s ``rng`` is a key tensor (``repro_torch.random.PRNGKey``),
  annotated ``torch.Tensor``, where the JAX package's is a ``jax.Array``;
* ``ServeEngine``'s legacy kwargs are keyword-only, after ``config`` and
  ``device`` (the JAX package takes them first and positionally);
* ``CompiledDesign`` (and its alias ``Design``) is a ``torch.nn.Module``
  built from keyword arguments; its data fields are instance attributes;
* ``build_steps`` returns an ``nn.ModuleList`` and takes no
  ``use_pallas`` (it selects nothing in the port).
"""

import inspect
import json
from pathlib import Path

import pytest

from test_public_api import _describe

SNAPSHOT = Path(__file__).parent / "public_api_snapshot.json"
PINNED = json.loads(SNAPSHOT.read_text())
NAMES = [(mod, name) for mod in sorted(PINNED) for name in sorted(PINNED[mod])]

# name -> the port's signature, where it differs by more than device=
# and torch types (each one listed in the module docstring)
DIFFERENT_SIGNATURES = {
    "repro.nn.init_params": "(rng: 'torch.Tensor', model: 'Sequential', in_shape: "
                            "'tuple[int, ...]', device: 'str | torch.device | None' = None)",
    "repro.runtime.ServeEngine": "(config: 'ServeConfig | None' = None, device: 'str | "
                                 "torch.device | None' = None, *, max_batch=UNSET, "
                                 "queue_depth=UNSET, max_wait_us=UNSET, buckets=UNSET, "
                                 "overflow=UNSET)",
    "repro.nn.build_steps": "(specs: 'list[StepSpec]', tables: 'list[AdderGraphTables]') "
                            "-> 'nn.ModuleList'",
    **{f"repro.{mod}.{name}": "(*, step_specs: 'list[StepSpec]', tables: "
                              "'list[AdderGraphTables]', programs: 'list[dict]', in_quant: "
                              "'QuantConfig', in_shape: 'tuple', out_shape: 'tuple', "
                              "out_qints: 'list[QInterval]', device: 'str | torch.device | "
                              "None' = None, reports: 'list[LayerReport] | None' = None, "
                              "solver_stats: 'dict | None' = None, use_pallas: 'bool' = "
                              "False, config: 'CompileConfig | None' = None)"
       for mod, name in (("nn", "CompiledDesign"), ("flow", "CompiledDesign"),
                         ("flow", "Design"))},
}
DESIGN_FIELDS = {"config", "in_quant", "in_shape", "out_shape", "use_pallas"}


def _port_module(mod: str):
    import importlib

    return importlib.import_module(mod.replace("repro", "repro_torch", 1))


def _without_device(obj) -> str:
    sig = inspect.signature(obj)
    params = [p for p in sig.parameters.values() if p.name != "device"]
    return str(sig.replace(parameters=params))


def _torch_types(sig: str) -> str:
    return sig.replace("torch.Tensor", "jnp.ndarray")


def _unquoted(sig: str) -> str:
    """A signature without its annotations' quotes (``list['StepSpec']``
    and ``list[StepSpec]`` name the same type)."""
    return sig.replace('"', "").replace("'", "")


def test_the_snapshot_pins_86_names():
    assert len(NAMES) == 86


@pytest.mark.parametrize("mod,name", NAMES, ids=[f"{m}.{n}" for m, n in NAMES])
def test_pinned_name_exists_in_the_port(mod, name):
    port = _port_module(mod)
    assert name in port.__all__
    obj = getattr(port, name)
    want = PINNED[mod][name]
    got = _describe(obj)
    assert got["kind"] == want["kind"]
    if want["kind"] == "class":
        members = set(got["members"])
        if name in ("CompiledDesign", "Design"):
            members |= DESIGN_FIELDS  # instance attributes of the nn.Module
        assert set(want["members"]) <= members
    if want.get("signature") is None:
        return
    key = f"{mod}.{name}"
    if key in DIFFERENT_SIGNATURES:
        assert got["signature"] == DIFFERENT_SIGNATURES[key]
        return
    assert _unquoted(_torch_types(_without_device(obj))) == _unquoted(want["signature"])


def test_compiled_design_fields_are_instance_attributes():
    import numpy as np
    import torch

    from repro_torch import nn as tnn
    from repro_torch.flow import CompileConfig, Design
    from repro_torch.random import PRNGKey

    model = (tnn.QDense(2, tnn.QuantConfig(6, 2)),)
    params, _ = tnn.init_params(PRNGKey(0), model, (3,), "cpu")
    design = tnn.compile_model(model, params, (3,), tnn.QuantConfig(8, 4),
                               config=CompileConfig(jobs=1), device="cpu")
    assert isinstance(design, Design) and isinstance(design, torch.nn.Module)
    assert all(hasattr(design, f) for f in DESIGN_FIELDS)
    assert design.in_shape == (3,) and design.out_shape == (2,)
    x = torch.from_numpy(np.zeros((1, 3), np.int32))
    assert design.forward_int(x).shape == (1, 2)
