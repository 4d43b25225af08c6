"""The committed assets of the port (src/repro_torch/assets/): full-size
designs written by the JAX package, with golden outputs.  Both packages
reproduce the golden outputs bit for bit from the committed artifacts
(the port on the CPU here; chip_smoke.py does it on the card).
Regenerate with ``PYTHONPATH=src python tools/make_torch_assets.py``."""

from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro.runtime import load_design as jax_load_design
from repro_torch.runtime import load_design

ASSETS = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "assets"
NAMES = ["mixer_full", "svhn_cnn"]
IN_SHAPES = {"mixer_full": (64, 16), "svhn_cnn": (30, 30, 3)}


def _golden(name):
    with np.load(ASSETS / name / "golden.npz") as g:
        return g["x"], g["y"]


@pytest.mark.parametrize("name", NAMES)
def test_golden_inputs_cover_the_input_grid(name):
    design = load_design(ASSETS / name, device="cpu")
    x, y = _golden(name)
    q = design.in_quant.qint
    assert x.shape == (1024, *IN_SHAPES[name]) == (1024, *design.in_shape)
    assert x.min() == q.lo and x.max() == q.hi
    assert y.dtype == np.int32 and y.shape == (1024, *design.out_shape)


@pytest.mark.parametrize("name", NAMES)
def test_jax_reproduces_golden(name):
    x, y = _golden(name)
    design = jax_load_design(ASSETS / name)
    np.testing.assert_array_equal(np.asarray(jax.jit(design.forward_int)(x.astype(np.int32))), y)


@pytest.mark.parametrize("name", NAMES)
def test_port_reproduces_golden_on_cpu(name):
    x, y = _golden(name)
    design = load_design(ASSETS / name, device="cpu")
    got = design.forward_int(torch.from_numpy(x.astype(np.int32))).numpy()
    np.testing.assert_array_equal(got, y)
