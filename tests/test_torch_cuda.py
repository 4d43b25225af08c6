"""The port on the CUDA card: the hand-written adder-graph kernel against
its plain PyTorch version, the committed full-size designs against their
JAX golden outputs, and the serving engine.  Tolerance: exact equality.

Every test here needs a card and skips without one.  This file imports
neither ``jax`` nor ``repro``, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import DAISProgram, QInterval, Term
from repro_torch.flow import ServeConfig
from repro_torch.kernels.adder_graph import adder_graph_apply, compile_tables
from repro_torch.kernels.adder_graph import kernel as ag_kernel
from repro_torch.kernels.adder_graph.ref import adder_graph_ref
from repro_torch.nn.compiler import count_cmvm_steps
from repro_torch.runtime import ServeEngine, load_design

pytestmark = pytest.mark.cuda

ASSETS = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "assets"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _random_program(seed, n_in=24, n_ops=300, n_out=40):
    """Operand shifts 0..40, output shifts -40..40, negations, masked
    outputs."""
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
        sh = int(rng.integers(0, 41))
        prog.add_op(a, b, *((sh, 0) if rng.random() < 0.5 else (0, sh)), int(rng.choice([-1, 1])))
    for _ in range(n_out):
        if rng.random() < 0.15:
            prog.outputs.append(None)
        else:
            row = int(rng.integers(len(prog.rows)))
            prog.outputs.append(Term(int(rng.choice([-1, 1])), row, int(rng.integers(-40, 41))))
    return prog


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("batch", [1, 7, 256, 1000])
def test_kernel_matches_plain_version(card, seed, batch):
    pt = compile_tables(_random_program(seed))
    x = np.random.default_rng(seed).integers(-128, 128, size=(batch, 24)).astype(np.int32)
    xd = torch.from_numpy(x).to(card)
    before = ag_kernel.launches.value
    got = adder_graph_apply(pt, xd)
    assert ag_kernel.launches.value == before + 1
    assert got.device == card
    np.testing.assert_array_equal(got.cpu().numpy(), adder_graph_ref(pt, xd).cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), adder_graph_apply(pt, torch.from_numpy(x)).numpy())


def test_kernel_wrapper_rejects_what_it_does_not_take(card):
    pt = compile_tables(_random_program(0))
    with pytest.raises(TypeError, match="int32"):
        ag_kernel.adder_graph_cuda(pt, torch.zeros((4, 24), dtype=torch.int64, device=card))
    with pytest.raises(ValueError, match=r"\[batch, 24\]"):
        ag_kernel.adder_graph_cuda(pt, torch.zeros((4, 23), dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        ag_kernel.adder_graph_cuda(pt, torch.zeros((24, 4), dtype=torch.int32, device=card).t())


@pytest.mark.parametrize("name", ["mixer_full", "svhn_cnn"])
def test_designs_reproduce_golden(card, name):
    design = load_design(ASSETS / name)
    assert design.device == card
    with np.load(ASSETS / name / "golden.npz") as g:
        x, y = g["x"].astype(np.int32), g["y"]
    before = ag_kernel.launches.value
    got = design.forward_int(torch.from_numpy(x).to(card)).cpu().numpy()
    assert ag_kernel.launches.value - before == count_cmvm_steps(design.step_specs)
    np.testing.assert_array_equal(got, y)


def test_engine_serves_golden(card):
    with np.load(ASSETS / "mixer_full" / "golden.npz") as g:
        x, y = g["x"][:512].astype(np.int32), g["y"][:512]
    with ServeEngine(ServeConfig(max_batch=64, shards=2)) as eng:
        eng.register("mixer", ASSETS / "mixer_full", warmup=True)
        got = np.stack([f.result(60) for f in eng.submit_batch("mixer", x)])
        s = eng.stats("mixer")
    np.testing.assert_array_equal(got, y)
    assert s["device"] == str(card) and s["n_batches"] > 0 and s["breaker"]["n_trips"] == 0
