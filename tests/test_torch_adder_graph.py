"""PyTorch port of the adder-graph executor against the JAX package.

The same programs (solved by the JAX package, or built by hand through
both packages' DAIS builders) and the same numpy inputs go through the
port's ``compile_tables`` / ``adder_graph_apply`` on the CPU and through
the JAX ``adder_graph_ref``, the Pallas kernel in interpret mode and
``DAISProgram.evaluate``.  Tolerance: exact equality everywhere (int32
arithmetic with wraparound).  The kernel itself is held against the plain
version on the card by tests/test_torch_cuda.py and chip_smoke.py.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import solve_cmvm
from repro.core.dais import DAISProgram as JaxDAISProgram
from repro.core.dais import Term as JaxTerm
from repro.core.fixed_point import QInterval as JaxQInterval
from repro.flow import SolverConfig
from repro.kernels.adder_graph import compile_tables as jax_compile_tables
from repro.kernels.adder_graph.kernel import adder_graph_pallas
from repro.kernels.adder_graph.ref import adder_graph_ref as jax_adder_graph_ref
from repro_torch.core import DAISProgram, QInterval, Term
from repro_torch.kernels.adder_graph import adder_graph_apply, compile_tables
from repro_torch.kernels.adder_graph import kernel as ag_kernel
from repro_torch.kernels.adder_graph import ops as ag_ops
from repro_torch.kernels.adder_graph.ref import adder_graph_ref


def _port(prog: JaxDAISProgram) -> DAISProgram:
    return DAISProgram.from_arrays(prog.to_arrays())


def _all_paths_equal(jprog: JaxDAISProgram, x: np.ndarray, block_b: int = 16) -> np.ndarray:
    """Port CPU apply == JAX ref == Pallas interpret; tables share a
    digest.  Returns the port's output."""
    jt = jax_compile_tables(jprog)
    pt = compile_tables(_port(jprog))
    assert pt.digest == jt.digest
    assert pt.level_bounds == jt.level_bounds
    got = adder_graph_apply(pt, torch.from_numpy(x)).numpy()
    x2 = jnp.asarray(x.reshape(-1, x.shape[-1]), jnp.int32)
    ref = np.asarray(jax_adder_graph_ref(jt, x2)).reshape(got.shape)
    pallas = np.asarray(adder_graph_pallas(jt, x2, block_b=block_b)).reshape(got.shape)
    np.testing.assert_array_equal(got, ref)
    np.testing.assert_array_equal(got, pallas)
    assert got.dtype == np.int32
    return got


# grids of tests/test_kernels.py and tests/test_pallas_executor.py
_KERNEL_GRID = [(4, 4, 4, -1), (8, 8, 8, -1), (16, 12, 6, 2), (12, 16, 8, 0), (3, 7, 5, 1)]
_PALLAS_GRID = [(0, -1), (1, 0), (2, 2)]


@pytest.mark.parametrize("d_in,d_out,bw,dc", _KERNEL_GRID)
def test_solved_programs_match_jax(d_in, d_out, bw, dc):
    rng = np.random.default_rng(d_in * 100 + d_out)
    m = rng.integers(-(2 ** (bw - 1)), 2 ** (bw - 1), size=(d_in, d_out))
    sol = solve_cmvm(m, config=SolverConfig(dc=dc))
    x = rng.integers(-128, 128, size=(37, d_in)).astype(np.int32)
    got = _all_paths_equal(sol.program, x)
    np.testing.assert_array_equal(got, x.astype(np.int64) @ m)


@pytest.mark.parametrize("seed,dc", _PALLAS_GRID)
def test_matches_evaluate(seed, dc):
    rng = np.random.default_rng(seed)
    m = rng.integers(-64, 64, size=(6, 5))
    sol = solve_cmvm(m, config=SolverConfig(dc=dc))
    x = rng.integers(-32, 32, size=(16, 6)).astype(np.int32)
    got = _all_paths_equal(sol.program, x)
    np.testing.assert_array_equal(got, sol.program.evaluate(x).astype(np.int32))
    np.testing.assert_array_equal(got, _port(sol.program).evaluate(x).astype(np.int32))


@pytest.mark.parametrize("batch", [1, 5, 13])
def test_batch_not_multiple_of_tile(batch):
    rng = np.random.default_rng(3)
    m = rng.integers(-16, 16, size=(4, 3))
    sol = solve_cmvm(m)
    x = rng.integers(-16, 16, size=(batch, 4)).astype(np.int32)
    got = _all_paths_equal(sol.program, x, block_b=8)
    assert got.shape == (batch, 3)
    np.testing.assert_array_equal(got, sol.program.evaluate(x).astype(np.int32))


def test_leading_dims():
    rng = np.random.default_rng(0)
    m = rng.integers(-16, 16, size=(6, 5))
    sol = solve_cmvm(m)
    x = rng.integers(-64, 64, size=(3, 11, 6)).astype(np.int32)
    got = _all_paths_equal(sol.program, x, block_b=8)
    assert got.shape == (3, 11, 5)
    np.testing.assert_array_equal(got.reshape(-1, 5), x.reshape(-1, 6).astype(np.int64) @ m)


@pytest.mark.parametrize(
    "m",
    [np.array([[1, 0], [0, -2]]), np.zeros((3, 2), np.int64), np.array([[3, 0], [5, 0]])],
    ids=["wiring_only", "zero_matrix", "zero_column"],
)
def test_no_ops_and_masked_columns(m):
    sol = solve_cmvm(m)
    pt = compile_tables(_port(sol.program))
    if not m[:, 1].any():
        assert pt.outs[1, 3] == 0  # masked constant-0 column
    x = np.random.default_rng(4).integers(-8, 8, size=(13, m.shape[0])).astype(np.int32)
    got = _all_paths_equal(sol.program, x, block_b=8)
    np.testing.assert_array_equal(got, x.astype(np.int64) @ m)


def _random_program(cls, qint_cls, term_cls, seed, n_in=6, n_ops=40, n_out=12):
    """The same random program through either package's builder:
    operand shifts 0..40, output shifts -40..40, negations and masked
    outputs."""
    rng = np.random.default_rng(seed)
    prog = cls()
    for _ in range(n_in):
        prog.add_input(qint_cls(-128, 127, 0))
    for _ in range(n_ops):
        n = len(prog.rows)
        if rng.random() < 0.1:
            prog.add_neg(int(rng.integers(n)))
            continue
        a, b = (int(i) for i in rng.integers(n, size=2))
        sh = int(rng.integers(0, 41))
        sh_a, sh_b = (sh, 0) if rng.random() < 0.5 else (0, sh)
        prog.add_op(a, b, sh_a, sh_b, int(rng.choice([-1, 1])))
    for _ in range(n_out):
        if rng.random() < 0.15:
            prog.outputs.append(None)
        else:
            row = int(rng.integers(len(prog.rows)))
            shift = int(rng.integers(-40, 41))
            prog.outputs.append(term_cls(int(rng.choice([-1, 1])), row, shift))
    return prog


@pytest.mark.parametrize("seed", range(4))
def test_wide_shifts_wrap_like_xla(seed):
    """Shifts of 32 or more (operand and output), negative output shifts
    and int32 overflow: the port's plain version equals the JAX paths on
    every output, and evaluate() mod 2^32 wherever an arithmetic right
    shift does not follow a wrap."""
    jprog = _random_program(JaxDAISProgram, JaxQInterval, JaxTerm, seed)
    pprog = _random_program(DAISProgram, QInterval, Term, seed)
    def rows(p):
        return [(r.kind, r.a, r.b, r.sh_a, r.sh_b, r.sign, r.depth, r.cost,
                 r.qint.lo, r.qint.hi, r.qint.exp) for r in p.rows]

    assert rows(pprog) == rows(jprog)  # the builders agree row for row
    assert [t and (t.sign, t.row, t.shift) for t in pprog.outputs] == [
        t and (t.sign, t.row, t.shift) for t in jprog.outputs
    ]
    x = np.random.default_rng(100 + seed).integers(-128, 128, size=(19, 6)).astype(np.int32)
    jt = jax_compile_tables(jprog)
    pt = compile_tables(pprog)
    assert pt.digest == jt.digest
    got = adder_graph_apply(pt, torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jax_adder_graph_ref(jt, jnp.asarray(x))))
    np.testing.assert_array_equal(got, np.asarray(adder_graph_pallas(jt, jnp.asarray(x), block_b=8)))
    want = pprog.evaluate(x).astype(np.int32)
    lim = 1 << 31
    for j, t in enumerate(pprog.outputs):
        q = pprog.rows[t.row].qint if t is not None else None
        if t is None or t.shift >= 0 or (-lim <= q.lo and q.hi < lim):
            np.testing.assert_array_equal(got[:, j], want[:, j])


def test_compile_tables_rejects_negative_operand_shift():
    arrays = solve_cmvm(np.array([[3, 5], [7, -6]])).program.to_arrays()
    op = int(np.flatnonzero(arrays["rows"][:, 0] == 1)[0])
    arrays["rows"][op, 3] = -1
    with pytest.raises(ValueError, match="negative operand shift"):
        compile_tables(DAISProgram.from_arrays(arrays))


def test_cpu_tensor_takes_the_plain_version(monkeypatch):
    """A CPU tensor never reaches the kernel wrapper (nor builds it)."""

    def no_kernel(*a, **k):
        raise AssertionError("kernel wrapper called for a CPU tensor")

    monkeypatch.setattr(ag_ops, "adder_graph_cuda", no_kernel)
    sol = solve_cmvm(np.array([[1, 2], [3, -4]]))
    pt = compile_tables(_port(sol.program))
    before = ag_kernel.launches.value
    x = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    np.testing.assert_array_equal(adder_graph_apply(pt, x).numpy(), [[7, -6], [15, -10]])
    np.testing.assert_array_equal(adder_graph_ref(pt, x).numpy(), [[7, -6], [15, -10]])
    assert ag_kernel.launches.value == before


def test_kernel_wrapper_rejects_what_it_does_not_take():
    pt = compile_tables(_port(solve_cmvm(np.array([[1, 2], [3, -4]])).program))
    with pytest.raises(ValueError, match="CUDA tensor"):
        ag_kernel.adder_graph_cuda(pt, torch.zeros((4, 2), dtype=torch.int32))
    with pytest.raises(ValueError, match="unsupported device"):
        adder_graph_apply(pt, torch.zeros((4, 2), dtype=torch.int32, device="meta"))
