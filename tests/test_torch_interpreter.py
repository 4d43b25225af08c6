"""The port's numpy StepSpec interpreter (``repro_torch.nn.interpreter``,
the serve fallback) against the JAX package's ``repro.nn.interpreter``
and against the port's own ``forward_int``, on the committed full-size
designs (the 64-particle Mixer and the SVHN CNN, every step kind the
compiler emits) and on random adder graphs (operand shifts up to 31,
output shifts of both signs, negations, masked outputs).  Tolerance:
exact equality (int32 throughout)."""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro.nn.interpreter import adder_graph_numpy as jax_adder_graph_numpy
from repro.nn.interpreter import numpy_forward_fn as jax_numpy_forward_fn
from repro.runtime import load_design as jax_load_design
from repro_torch.core import DAISProgram, QInterval, Term
from repro_torch.kernels.adder_graph import compile_tables
from repro_torch.kernels.adder_graph.ref import adder_graph_ref
from repro_torch.nn import adder_graph_numpy, build_numpy_steps, build_steps, numpy_forward_fn
from repro_torch.runtime import load_design

ASSETS = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "assets"
NAMES = ["mixer_full", "svhn_cnn"]


@pytest.fixture(scope="module", params=NAMES)
def asset(request):
    name = request.param
    with np.load(ASSETS / name / "golden.npz") as g:
        x, y = g["x"].astype(np.int32), g["y"]
    return name, x, y, load_design(ASSETS / name, device="cpu")


def test_interpreter_reproduces_golden(asset):
    _, x, y, design = asset
    got = numpy_forward_fn(design)(x)
    assert got.dtype == np.int32
    np.testing.assert_array_equal(got, y)


def test_interpreter_equals_the_jax_interpreter(asset):
    name, x, _, design = asset
    want = jax_numpy_forward_fn(jax_load_design(ASSETS / name))(x[:256])
    np.testing.assert_array_equal(numpy_forward_fn(design)(x[:256]), want)


def test_interpreter_equals_forward_int(asset):
    _, x, _, design = asset
    xs = x[::7]  # a batch that is no power of two
    want = design.forward_int(torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(numpy_forward_fn(design)(xs), want)


def test_steps_one_by_one_equal_forward_int(asset):
    """Each step of the interpreter against the port's step module (the
    unfolded steps: ``forward_int`` runs them folded, tests/test_torch_fold.py)."""
    _, x, _, design = asset
    v_np = x[:32].reshape(32, -1).astype(np.int32)
    v_t = torch.from_numpy(v_np.copy())
    for np_step, t_step in zip(build_numpy_steps(design.step_specs, design.tables),
                               build_steps(design.step_specs, design.tables), strict=True):
        v_np, v_t = np_step(v_np), t_step(v_t)
        np.testing.assert_array_equal(v_np, v_t.numpy())


def _random_program(seed, n_in=16, n_ops=200, n_out=32):
    rng = np.random.default_rng(seed)
    prog = DAISProgram()
    for _ in range(n_in):
        prog.add_input(QInterval(-128, 127, 0))
    for _ in range(n_ops):
        n = len(prog.rows)
        if rng.random() < 0.1:
            prog.add_neg(int(rng.integers(n)))
            continue
        a, b = (int(i) for i in rng.integers(n, size=2))
        sh = int(rng.integers(0, 32))
        prog.add_op(a, b, *((sh, 0) if rng.random() < 0.5 else (0, sh)), int(rng.choice([-1, 1])))
    for _ in range(n_out):
        if rng.random() < 0.15:
            prog.outputs.append(None)
        else:
            row = int(rng.integers(len(prog.rows)))
            prog.outputs.append(Term(int(rng.choice([-1, 1])), row, int(rng.integers(-20, 21))))
    return prog


@pytest.mark.parametrize("seed", range(4))
def test_adder_graph_numpy_equals_plain_version_and_jax(seed):
    tables = compile_tables(_random_program(seed))
    x = np.random.default_rng(seed).integers(-128, 128, size=(37, 16)).astype(np.int32)
    got = adder_graph_numpy(tables, x)
    np.testing.assert_array_equal(got, adder_graph_ref(tables, torch.from_numpy(x)).numpy())
    np.testing.assert_array_equal(got, jax_adder_graph_numpy(tables, x))


def test_design_without_step_specs_cannot_be_interpreted(asset):
    _, _, _, design = asset

    class Bare:
        step_specs = []
        tables = design.tables
        out_shape = design.out_shape

    with pytest.raises(ValueError, match="no step_specs"):
        numpy_forward_fn(Bare())
