"""The integer executor's folded plan (``repro_torch.nn.compiler.plan_steps``)
against the unfolded steps (``build_steps``) on the CPU, bit for bit.

``forward_int`` runs each CMVM step's shift, bias and the ReLU and
requant steps after it in the adder-graph launch's epilogue
(``kernels.adder_graph.Epilogue``).  Held to ``_run_steps`` over
``build_steps``: the committed Mixer and SVHN designs and a jet tagger
compiled here, on seeded grid inputs and the grid's extremes; and seeded
random step chains: a shift array, a bias that wraps int32, requant
shifts left that overflow, right and zero, varying across a sample's
rows, ReLU without requant and requant without ReLU, a transpose between
the table and its ReLU, masked (constant-0) outputs, and orders the
epilogue does not take.  The plan changes no artifact: the committed
designs save to the same arrays and manifest, and their tables keep
their digests."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch.core import DAISProgram, QInterval, Term
from repro_torch.flow import CompileConfig
from repro_torch.kernels.adder_graph import compile_tables, epilogue_table
from repro_torch.nn import compile_model, init_params
from repro_torch.nn import models as nn_models
from repro_torch.nn.compiler import StepSpec, _run_steps, build_steps, plan_steps
from repro_torch.random import PRNGKey
from repro_torch.runtime import load_design, save_design

ASSETS = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "assets"
CPU = torch.device("cpu")


def _unfolded(design, x):
    n = x.shape[0]
    v = _run_steps(build_steps(design.step_specs, design.tables), x.reshape(n, -1), CPU)
    return v.reshape(n, *design.out_shape)


def _grid_inputs(design, n, seed):
    q = design.in_quant.qint
    x = np.random.default_rng(seed).integers(q.lo, q.hi + 1, size=(n, *design.in_shape))
    x[0], x[1] = q.lo, q.hi  # the grid's extremes, everywhere
    return torch.from_numpy(x.astype(np.int32))


def _modules(steps):
    for s in steps:
        yield s
        yield from _modules(getattr(s, "body", []))


def _counts(design):
    """(ReLU and requant steps folded, those left as steps)."""
    mods = list(_modules(design.steps))
    folded = sum(getattr(m, "folded", 0) for m in mods)
    left = sum(m.span in ("executor.relu", "executor.requant") for m in mods)
    return folded, left


@pytest.fixture(scope="module", params=["mixer_full", "svhn_cnn", "jet_tagger"])
def design(request):
    if request.param != "jet_tagger":
        return load_design(ASSETS / request.param, device="cpu")
    model, in_shape, in_quant = nn_models.jet_tagger()
    params, _ = init_params(PRNGKey(0), model, in_shape, "cpu")
    return compile_model(model, params, in_shape, in_quant, config=CompileConfig(jobs=1),
                         device="cpu")


@pytest.mark.parametrize("seed", [0, 1])
def test_designs_folded_equal_unfolded(design, seed):
    x = _grid_inputs(design, 96, seed)
    np.testing.assert_array_equal(design.forward_int(x).numpy(), _unfolded(design, x).numpy())


def test_designs_fold_relu_and_requant_after_every_table_but_the_last(design):
    folded, left = _counts(design)
    n_elem = sum(s.kind in ("relu", "requant") for s in _flat(design.step_specs))
    assert folded + left == n_elem and folded == 2 * (len(design.tables) - 1)


def _flat(specs):
    for s in specs:
        yield s
        yield from _flat(s.body or [])


def test_mixer_plan_is_27_launches():
    d = load_design(ASSETS / "mixer_full", device="cpu")
    mods = list(_modules(d.steps))
    kinds = [m.span for m in mods]
    assert _counts(d) == (18, 2)
    assert kinds.count("executor.dense") == 10 and kinds.count("executor.transpose") == 8
    # kernels a step: a launch, a copy, the merge's 3, a ReLU's 1, a requant's 5
    per_kind = {"executor.dense": 1, "executor.transpose": 1, "executor.residual": 3,
                "executor.relu": 1, "executor.requant": 5}
    assert sum(per_kind[k] for k in kinds) == 27
    assert [m.folded for m in mods if m.span == "executor.dense"] == [2] * 9 + [0]
    assert all(m.epi is not None and m.bias is None for m in mods if m.span == "executor.dense")


def test_committed_artifacts_and_digests_unchanged(tmp_path):
    for name in ("mixer_full", "svhn_cnn"):
        d = load_design(ASSETS / name, device="cpu")
        for t, prog in zip(d.tables, d.programs):
            assert t.digest == compile_tables(DAISProgram.from_arrays(prog)).digest
        save_design(d, tmp_path / name)
        assert (tmp_path / name / "design.npz").read_bytes() == \
            (ASSETS / name / "design.npz").read_bytes()
        got, want = (json.loads((p / "manifest.json").read_text())
                     for p in (tmp_path / name, ASSETS / name))
        # solver_stats records the load itself (its wall time), as before
        assert {k: v for k, v in got.items() if k != "solver_stats"} == \
            {k: v for k, v in want.items() if k != "solver_stats"}


# ----------------------------------------------------------------------
# random step chains
# ----------------------------------------------------------------------
def _program(rng, n_in, n_out, n_ops=120):
    prog = DAISProgram()
    for _ in range(n_in):
        prog.add_input(QInterval(-128, 127, 0))
    for _ in range(n_ops):
        n = len(prog.rows)
        if rng.random() < 0.1:
            prog.add_neg(int(rng.integers(n)))
            continue
        a, b = (int(i) for i in rng.integers(n, size=2))
        sh = int(rng.integers(0, 12))
        prog.add_op(a, b, *((sh, 0) if rng.random() < 0.5 else (0, sh)), int(rng.choice([-1, 1])))
    for _ in range(n_out):
        if rng.random() < 0.15:
            prog.outputs.append(None)  # masked: constant 0
        else:
            row = int(rng.integers(len(prog.rows)))
            prog.outputs.append(Term(int(rng.choice([-1, 1])), row, int(rng.integers(-6, 7))))
    return prog


def _dense(rng, table, d_in, n_out, shift=True):
    arrays = {"bias": rng.integers(-2**31, 2**31, size=n_out) + rng.choice([0, 2**32], n_out)}
    arrays["bias"][: n_out // 4] = 2**31 - 1 - rng.integers(0, 64, size=n_out // 4)  # wraps
    if shift:
        arrays["shift"] = rng.integers(0, 40, size=n_out)  # 32 and more shift everything out
    return StepSpec("dense", params={"d_in": d_in}, arrays=arrays, table=table)


def _requant(rng, n, lo=-100, hi=3000, rows_vary=True):
    d = rng.integers(-40, 40, size=n)  # left that overflows, right, and past 32 both ways
    d[::7] = 0
    if not rows_vary:
        d[:] = d[0]
    return StepSpec("requant", params={"lo": lo, "hi": hi}, arrays={"d": d})


R, K, N = 6, 10, 12  # rows a sample, table inputs, table outputs


def _T(shape):
    return StepSpec("transpose", params={"shape": list(shape), "perm": [1, 0]})


# each chain: steps after the first table, and (folded, left) ReLU/requant steps
CHAINS = {
    "relu_requant": (lambda g: [StepSpec("relu"), _requant(g, R * N)], (2, 0)),
    "relu_only": (lambda g: [StepSpec("relu")], (1, 0)),
    "requant_only": (lambda g: [_requant(g, R * N)], (1, 0)),
    "requant_rows_alike": (lambda g: [StepSpec("relu"), _requant(g, R * N, rows_vary=False)],
                           (2, 0)),
    "transpose_between": (lambda g: [_T((R, N)), StepSpec("relu"), _requant(g, R * N),
                                     _T((N, R))], (2, 0)),
    "relu_transpose_requant": (lambda g: [StepSpec("relu"), _T((R, N)), _requant(g, R * N),
                                          _T((N, R))], (2, 0)),
    "requant_then_relu": (lambda g: [_requant(g, R * N), StepSpec("relu")], (1, 1)),
    "two_requants": (lambda g: [_requant(g, R * N), _requant(g, R * N, lo=0, hi=255)], (1, 1)),
    "relu_relu": (lambda g: [StepSpec("relu"), StepSpec("relu")], (1, 1)),
    "bias_alone": (lambda g: [], (0, 0)),
    "next_table": (lambda g: [StepSpec("relu"), _dense(g, 1, N, K), StepSpec("relu"),
                              _requant(g, R * K)], (3, 0)),
    "residual": (lambda g: [StepSpec("residual", arrays={"sa": g.integers(0, 3, R * N),
                                                         "sb": g.integers(0, 3, R * N)},
                                     body=[StepSpec("relu"), _dense(g, 1, N, N),
                                           _requant(g, R * N)]),
                            StepSpec("relu"), _requant(g, R * N)], (1, 3)),
}


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("chain", sorted(CHAINS))
def test_random_chains_folded_equal_unfolded(chain, seed):
    rng = np.random.default_rng(seed)
    n2 = N if chain == "residual" else K
    tables = [compile_tables(_program(rng, K, N)), compile_tables(_program(rng, N, n2))]
    make, (want_folded, want_left) = CHAINS[chain]
    specs = [_dense(rng, 0, K, N, shift=seed != 2), *make(rng)]
    x = torch.from_numpy(rng.integers(-128, 128, size=(17, R * K)).astype(np.int32))
    x[0] = -128
    x[1] = 127
    plan = plan_steps(specs, tables)
    got = _run_steps(plan, x, CPU)
    want = _run_steps(build_steps(specs, tables), x, CPU)
    np.testing.assert_array_equal(got.numpy(), want.numpy())
    mods = list(_modules(plan))
    assert sum(getattr(m, "folded", 0) for m in mods) == want_folded
    assert sum(m.span in ("executor.relu", "executor.requant") for m in mods) == want_left
    assert sum(m.span == "executor.transpose" for m in mods) == \
        sum(s.kind == "transpose" for s in _flat(specs))


def test_epilogue_table_saturates_shifts_and_collapses_alike_rows():
    t = epilogue_table(3, shift=[0, 33, -1], bias=[2**31, -1, 5],
                       d=[[40, -40, 0], [40, -40, 0]])
    assert t.shape == (1, 3, 2) and t.dtype == np.int32
    assert t[0, :, 0].tolist() == [-2**31, -1, 5]
    assert (t[0, :, 1] & 0xFF).tolist() == [0, 32, 32]
    assert (t[0, :, 1] >> 8).tolist() == [32, -32, 0]
    assert epilogue_table(2, d=[[1, 2], [3, 4]]).shape == (2, 2, 2)
    assert epilogue_table(2).tolist() == [[[0, 0], [0, 0]]]
