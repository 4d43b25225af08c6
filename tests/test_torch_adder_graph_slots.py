"""The slot plan and launch plan of the port's shared-memory adder-graph
kernel (``repro_torch.kernels.adder_graph.slots``).

The kernel itself runs only on the card; here a plain numpy walk of the
slot-planned tables, which does what the kernel does (inputs in slots
0..n_in-1, one level at a time, 16-byte instructions unpacked as the
kernel unpacks them), is held against the port's ``adder_graph_ref``
(itself held against the JAX package's by test_torch_adder_graph.py, on
tables whose digest equals the JAX package's) and against
``DAISProgram.evaluate``, on every table of the committed ``mixer_full``
and ``svhn_cnn`` designs and on hypothesis-drawn random programs.  Tolerance: exact equality (int32 with
wraparound).  The plan's own invariants are checked directly: no op
writes a slot that an op of its level reads or that a later read still
needs, and the slot count is the peak number of live rows, counted here
without the planner's code.
"""

from pathlib import Path

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.core.dais import DAISProgram as JaxDAISProgram
from repro.kernels.adder_graph import compile_tables as jax_compile_tables
from repro_torch.core import DAISProgram, QInterval, Term
from repro_torch.kernels.adder_graph import compile_tables
from repro_torch.kernels.adder_graph.ref import adder_graph_ref
from repro_torch.kernels.adder_graph.slots import (
    SMEM_BLOCK_MAX,
    LaunchPlan,
    launch_plan,
    plan_slots,
)
from repro_torch.runtime import load_design

ASSETS = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "assets"

# peak live rows of the committed mixer_full design's ten tables
MIXER_PEAKS = (129, 127, 1237, 1232, 122, 115, 1207, 1227, 3278, 78)


def _shl(v, s):
    return np.where(s >= 32, 0, v << np.minimum(s, 31).astype(np.uint32)).astype(np.uint32)


def _sar(v, s):
    return (v.view(np.int32) >> np.minimum(s, 31)).view(np.uint32)


def slot_walk(tables, x: np.ndarray) -> np.ndarray:
    """The shared-memory kernel's walk in numpy: x int32 [batch, n_in] ->
    int32 [batch, n_out]."""
    plan = tables.slot_plan
    v = np.zeros((plan.n_slots, x.shape[0]), np.uint32)
    v[: tables.n_inputs] = x.T.view(np.uint32)
    for lo, hi in tables.level_bounds:
        ops = plan.ops[lo:hi]
        word = ops[:, 3].view(np.uint32)
        sh_a = (word & 0xFF)[:, None]
        sh_b = ((word >> 8) & 0xFF)[:, None]
        sign = (ops[:, 3] >> 16).view(np.uint32)[:, None]  # arithmetic: sign-extended
        res = _shl(v[ops[:, 1]], sh_a) + sign * _shl(v[ops[:, 2]], sh_b)
        v[ops[:, 0]] = res
    outs = plan.outs
    r = v[outs[:, 0]]
    sh = outs[:, 1:2]
    r = np.where(sh >= 0, _shl(r, np.maximum(sh, 0)), _sar(r, np.maximum(-sh, 0)))
    r = r * outs[:, 2:3].view(np.uint32) * outs[:, 3:4].view(np.uint32)
    return np.ascontiguousarray(r.T).view(np.int32)


def live_intervals(tables):
    """(first, last) level of every row, from the tables alone: inputs
    are written at level -1, an op row at its level; a row is needed up
    to its last read, to the end (n_levels) if an unmasked output reads
    it, else only where it is written."""
    n_in, n_levels = tables.n_inputs, len(tables.level_bounds)
    first = [-1] * n_in
    for k, (lo, hi) in enumerate(tables.level_bounds):
        first += [k] * (hi - lo)
    last = list(first)
    for k, (lo, hi) in enumerate(tables.level_bounds):
        for a, b in tables.instr[lo:hi, :2].tolist():
            last[a] = max(last[a], k)
            last[b] = max(last[b], k)
    for row, _, _, mask in tables.outs.tolist():
        if mask:
            last[row] = n_levels
    return first, last


def peak_live(tables) -> int:
    first, last = live_intervals(tables)
    n_levels = len(tables.level_bounds)
    return max(sum(f <= k <= e for f, e in zip(first, last)) for k in range(-1, n_levels + 1))


def check_plan(tables):
    """No op writes a slot that an op of its level reads, nor a slot whose
    row a later read still needs; every read finds its row; the slot count
    is the peak of live rows."""
    plan = tables.slot_plan
    n_in = tables.n_inputs
    first, last = live_intervals(tables)
    holder = {s: s for s in range(n_in)}  # slot -> row it holds
    for k, (lo, hi) in enumerate(tables.level_bounds):
        ops = plan.ops[lo:hi]
        read = set(ops[:, 1].tolist()) | set(ops[:, 2].tolist())
        for i, (dst, a, b, _) in enumerate(ops.tolist()):
            row_a, row_b = tables.instr[lo + i, :2].tolist()
            assert holder[a] == row_a and holder[b] == row_b
        dsts = ops[:, 0].tolist()
        assert len(set(dsts)) == len(dsts)
        assert not read & set(dsts), f"level {k} writes a slot it reads"
        for i, dst in enumerate(dsts):
            old = holder.get(dst)
            assert old is None or last[old] < k, f"level {k} overwrites a live row"
            holder[dst] = n_in + lo + i
    for (row, _, _, mask), (slot, *_rest) in zip(tables.outs.tolist(), plan.outs.tolist()):
        if mask:
            assert holder[slot] == row
    assert 0 <= plan.ops[:, :3].min(initial=0) and plan.ops[:, :3].max(initial=0) < plan.n_slots
    assert plan.n_slots == max(peak_live(tables), 1)


def _design_tables(name):
    design = load_design(ASSETS / name, device="cpu")
    return [(t, design.programs[i]) for i, t in enumerate(design.tables)]


def _inputs(prog, batch, seed):
    qs = [r.qint for r in prog.rows[: prog.n_inputs]]
    lo = np.array([q.lo for q in qs], np.int64)
    hi = np.array([q.hi for q in qs], np.int64)
    rng = np.random.default_rng(seed)
    return rng.integers(lo, hi + 1, size=(batch, prog.n_inputs)).astype(np.int32)


@pytest.mark.parametrize("name,n_tables", [("mixer_full", 10), ("svhn_cnn", 6)])
def test_design_tables_walk_exactly(name, n_tables):
    """Every table of a committed design: the slot walk equals the port's
    ``adder_graph_ref`` and ``evaluate``, and the tables digest as the JAX
    package's do."""
    tables = _design_tables(name)
    assert len(tables) == n_tables
    for i, (t, arrays) in enumerate(tables):
        prog = DAISProgram.from_arrays(arrays)
        x = _inputs(prog, 19, seed=i)
        got = slot_walk(t, x)
        np.testing.assert_array_equal(got, adder_graph_ref(t, torch.from_numpy(x)).numpy())
        jt = jax_compile_tables(JaxDAISProgram.from_arrays(arrays))
        assert jt.digest == t.digest
        np.testing.assert_array_equal(got, prog.evaluate(x).astype(np.int32))


@pytest.mark.parametrize("name", ["mixer_full", "svhn_cnn"])
def test_design_plans_hold_their_invariants(name):
    for t, _ in _design_tables(name):
        check_plan(t)
        assert 4 * t.slot_plan.n_slots <= SMEM_BLOCK_MAX  # every such table takes shared memory


def test_mixer_slots_equal_peak_live_rows():
    tables = [t for t, _ in _design_tables("mixer_full")]
    assert tuple(peak_live(t) for t in tables) == MIXER_PEAKS
    assert tuple(t.slot_plan.n_slots for t in tables) == MIXER_PEAKS
    assert tables[8].slot_plan.n_slots == 3278 and tables[8].n_rows == 7137


def test_plan_leaves_the_tables_and_digest_alone():
    t, arrays = _design_tables("mixer_full")[9]
    fresh = compile_tables(DAISProgram.from_arrays(arrays))
    before = (t.digest, t.instr.tobytes(), t.outs.tobytes(), t.level_bounds)
    t.slot_plan  # noqa: B018
    t.device_arrays(torch.device("cpu"))
    assert (t.digest, t.instr.tobytes(), t.outs.tobytes(), t.level_bounds) == before
    assert fresh.digest == t.digest and fresh == t
    assert plan_slots(fresh).n_slots == t.slot_plan.n_slots
    np.testing.assert_array_equal(plan_slots(fresh).ops, t.slot_plan.ops)


def _random_program(seed, n_in, n_ops, n_out, max_shift):
    """Operand shifts 0..max_shift, output shifts -40..40, negations,
    masked outputs; operands drawn from all earlier rows, so rows stay
    live across levels."""
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
        sh = int(rng.integers(0, max_shift + 1))
        prog.add_op(a, b, *((sh, 0) if rng.random() < 0.5 else (0, sh)), int(rng.choice([-1, 1])))
    for _ in range(n_out):
        if rng.random() < 0.15:
            prog.outputs.append(None)
        else:
            row = int(rng.integers(len(prog.rows)))
            prog.outputs.append(Term(int(rng.choice([-1, 1])), row, int(rng.integers(-40, 41))))
    return prog


@settings(max_examples=40, deadline=None)
@given(seed=st.integers(0, 2**31 - 1), n_in=st.integers(1, 12), n_ops=st.integers(0, 150),
       n_out=st.integers(1, 10), max_shift=st.sampled_from([3, 31, 40]),
       batch=st.integers(1, 9))
def test_random_programs_walk_exactly(seed, n_in, n_ops, n_out, max_shift, batch):
    prog = _random_program(seed, n_in, n_ops, n_out, max_shift)
    t = compile_tables(prog)
    check_plan(t)
    x = np.random.default_rng(seed).integers(-128, 128, size=(batch, n_in)).astype(np.int32)
    got = slot_walk(t, x)
    np.testing.assert_array_equal(got, adder_graph_ref(t, torch.from_numpy(x)).numpy())
    want = prog.evaluate(x).astype(np.int32) if max_shift < 32 else None
    lim = 1 << 31
    for j, term in enumerate(prog.outputs):
        if want is None:
            break
        q = prog.rows[term.row].qint if term is not None else None
        # evaluate() mod 2^32 is exact except for a right shift after a wrap
        if term is None or term.shift >= 0 or (-lim <= q.lo << q.exp and q.hi << q.exp < lim):
            np.testing.assert_array_equal(got[:, j], want[:, j])


def test_inputs_dead_from_the_start_free_their_slots():
    """An input that nothing reads frees its slot for level 0."""
    prog = DAISProgram()
    for _ in range(3):
        prog.add_input(QInterval(-8, 7, 0))
    row = prog.add_op(0, 1, 0, 1, 1)
    prog.outputs.append(Term(1, row, 0))
    t = compile_tables(prog)
    assert t.slot_plan.n_slots == 3
    assert t.slot_plan.ops[0, 0] == 2  # the unread input's slot
    check_plan(t)
    x = np.array([[1, 2, 3], [-4, 5, -6]], np.int32)
    np.testing.assert_array_equal(slot_walk(t, x), [[5], [6]])


# a table of the head table's size (mixer_full table 8) and one whose single
# sample does not fit a block's shared memory
HEAD = dict(n_slots=3278, n_ops=6113, n_levels=11)
HUGE = dict(n_slots=60_000, n_ops=60_000, n_levels=2)


@pytest.mark.parametrize("table,batch,want", [
    (HEAD, 1, LaunchPlan("shared", 1, 512, 13_112, 1)),
    (HEAD, 7, LaunchPlan("shared", 1, 512, 13_112, 7)),
    (HEAD, 256, LaunchPlan("shared", 1, 512, 13_112, 256)),
    (HEAD, 4097, LaunchPlan("shared", 8, 512, 104_896, 513)),
    (dict(n_slots=129, n_ops=209, n_levels=7), 16_384, LaunchPlan("shared", 32, 256, 16_512, 512)),
    (dict(n_slots=1237, n_ops=2161, n_levels=9), 65_536, LaunchPlan("shared", 16, 512, 79_168, 4096)),
    (dict(n_slots=78, n_ops=116, n_levels=8), 256, LaunchPlan("shared", 1, 32, 312, 256)),
    (HUGE, 1, LaunchPlan("global", 1, 256, 0, 1)),
    (HUGE, 7, LaunchPlan("global", 8, 256, 0, 1)),
    (HUGE, 4097, LaunchPlan("global", 32, 256, 0, 129)),
], ids=["head-1", "head-7", "head-256", "head-4097", "channel-16384", "token-65536",
        "small-256", "huge-1", "huge-7", "huge-4097"])
def test_launch_plan(table, batch, want):
    assert launch_plan(**table, batch=batch, n_sms=132) == want


def test_launch_plan_size_rule():
    """The entry point turns on one sample's bytes alone."""
    fits = SMEM_BLOCK_MAX // 4
    for batch in (1, 256, 4097):
        assert launch_plan(fits, 10, 2, batch).entry == "shared"
        assert launch_plan(fits + 1, 10, 2, batch).entry == "global"
    for batch in (1, 3, 33, 300, 5000, 70_000):
        p = launch_plan(2000, 3000, 10, batch)
        assert p.tile * p.blocks >= batch > p.tile * (p.blocks - 1)
        assert p.smem_bytes <= SMEM_BLOCK_MAX and p.threads % 32 == 0
