"""The port's CMVM solver (``repro_torch.core``) against the JAX
package's (``repro.core``), case by case on the same seeded inputs.

Both are host code (numpy), and the port's is a copy, so the contract is
equality, not closeness: the same CSD digits, the same decomposition,
the same DAIS program (``to_arrays``) with the same adder count, depth
and cost from all three CSE engines over a grid of sizes 2-32, weight
widths 2-8, delay constraints -1/0/2 and stage-1 decomposition on/off;
the same interval arithmetic, pruning, levelization and pipelining; the
same ``solve_key`` digest, and disk-cache entries written by either
package that read back in the other (tolerance: exact equality).
"""

import numpy as np
import pytest

from repro import core as jcore
from repro.flow import SolverConfig as JSolverConfig
from repro_torch import core as tcore
from repro_torch.flow import SolverConfig as TSolverConfig

ENGINES = ("batch", "arena", "heap")
# (size, weight bits): a square matrix of signed ``bits``-bit integers
SHAPES = [(2, 2), (3, 8), (7, 5), (12, 3), (16, 8), (24, 6), (32, 4), (32, 8)]


def _matrix(n, bits, seed):
    rng = np.random.default_rng(seed)
    return rng.integers(-(1 << (bits - 1)), 1 << (bits - 1), size=(n, n))


def _qints(pkg, n, seed):
    """Per-input intervals of mixed width, sign and grid."""
    rng = np.random.default_rng(seed)
    return [pkg.QInterval.from_fixed(bool(rng.integers(2)), int(rng.integers(1, 9)),
                                     int(rng.integers(-2, 6))) for _ in range(n)]


def _assert_same_program(a, b):
    pa, pb = a.program.to_arrays(), b.program.to_arrays()
    assert pa.keys() == pb.keys()
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k], err_msg=k)
    assert (a.n_adders, a.depth, a.cost_bits) == (b.n_adders, b.depth, b.cost_bits)
    assert (a.decomposed, a.out_scale_exp) == (b.decomposed, b.out_scale_exp)


# ----------------------------------------------------------------------
# CSD, decomposition, intervals
# ----------------------------------------------------------------------
@pytest.mark.parametrize("seed", range(3))
def test_csd_digits_and_counts_equal(seed):
    rng = np.random.default_rng(seed)
    x = rng.integers(-(2**40), 2**40, size=(17, 9))
    np.testing.assert_array_equal(tcore.to_csd(x), jcore.to_csd(x))
    np.testing.assert_array_equal(tcore.csd_nnz(x), jcore.csd_nnz(x))
    np.testing.assert_array_equal(tcore.from_csd(tcore.to_csd(x)), x)
    assert tcore.csd_span(x[0, 0]) == jcore.csd_span(x[0, 0])


@pytest.mark.parametrize("dc", [-1, 0, 1, 2])
@pytest.mark.parametrize("n,bits", [(5, 4), (16, 8), (32, 6)])
def test_decompose_equal(n, bits, dc):
    m = _matrix(n, bits, seed=n + dc)
    a, b = jcore.decompose(m, dc), tcore.decompose(m, dc)
    for f in ("m1", "m2", "path_len", "mst_depth"):
        np.testing.assert_array_equal(getattr(a, f), getattr(b, f), err_msg=f)
    assert a.is_trivial == b.is_trivial
    np.testing.assert_array_equal(b.m1 @ b.m2, m)


@pytest.mark.parametrize("seed", range(4))
def test_interval_arithmetic_equal(seed):
    rng = np.random.default_rng(seed)

    def pair():
        lo, hi = sorted(int(v) for v in rng.integers(-300, 300, size=2))
        return (lo, hi, int(rng.integers(-4, 5)))

    for _ in range(50):
        (a, b) = pair(), pair()
        ja, jb = jcore.QInterval(*a), jcore.QInterval(*b)
        ta, tb = tcore.QInterval(*a), tcore.QInterval(*b)
        s, k = int(rng.integers(-3, 4)), int(rng.integers(-9, 10))
        for jq, tq in [(ja.add(jb), ta.add(tb)), (ja.sub(jb), ta.sub(tb)),
                       (ja.shift(s), ta.shift(s)), (ja.scale(k), ta.scale(k)),
                       (ja.union(jb), ta.union(tb)), (ja.neg(), ta.neg()),
                       (jcore.fixed_point.qint_add_shifted(ja, jb, abs(s), 1),
                        tcore.fixed_point.qint_add_shifted(ta, tb, abs(s), 1))]:
            assert (jq.lo, jq.hi, jq.exp) == (tq.lo, tq.hi, tq.exp)
            assert (jq.width, jq.msb, jq.lsb, jq.signed) == (tq.width, tq.msb, tq.lsb, tq.signed)
        v = int(rng.integers(-300, 300))
        assert ja.contains_value(v, a[2]) == ta.contains_value(v, a[2])
        assert jcore.QInterval.constant(v).hi == tcore.QInterval.constant(v).hi
        sh = (int(rng.integers(0, 4)), 0)
        sign = int(rng.choice([-1, 1]))
        assert jcore.adder_cost(ja, jb, *sh, sign) == tcore.adder_cost(ta, tb, *sh, sign)
        assert jcore.overlap_bits(ja, jb, *sh) == tcore.overlap_bits(ta, tb, *sh)


def test_tree_depth_helpers_equal():
    rng = np.random.default_rng(0)
    for _ in range(20):
        leaves = [int(v) for v in rng.integers(0, 6, size=int(rng.integers(1, 30)))]
        assert jcore.min_tree_depth(leaves) == tcore.min_tree_depth(leaves)
        hist = {d: leaves.count(d) for d in set(leaves)}
        assert jcore.min_tree_depth_hist(hist) == tcore.min_tree_depth_hist(hist)
    assert [jcore.ceil_log2(n) for n in range(1, 70)] == [tcore.ceil_log2(n) for n in range(1, 70)]


# ----------------------------------------------------------------------
# the solver grid
# ----------------------------------------------------------------------
@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("decompose", [True, False])
@pytest.mark.parametrize("dc", [-1, 0, 2])
@pytest.mark.parametrize("n,bits", SHAPES)
def test_solve_cmvm_equal(n, bits, dc, decompose, engine):
    m = _matrix(n, bits, seed=1000 * n + 10 * bits + dc)
    jq, tq = _qints(jcore, n, seed=n), _qints(tcore, n, seed=n)
    a = jcore.solve_cmvm(m, jq, config=JSolverConfig(dc=dc, decompose=decompose, engine=engine))
    b = tcore.solve_cmvm(m, tq, config=TSolverConfig(dc=dc, decompose=decompose, engine=engine))
    _assert_same_program(a, b)
    assert b.verify()
    assert b.stats.get("engine") == engine


@pytest.mark.parametrize("weighted,dedup,depth_weight", [(False, True, 0.0), (True, False, 0.0),
                                                         (True, True, 0.5)])
def test_solve_scoring_variants_equal(weighted, dedup, depth_weight):
    m = _matrix(16, 8, seed=3)
    kw = dict(dc=2, weighted=weighted, dedup=dedup, depth_weight=depth_weight)
    _assert_same_program(jcore.solve_cmvm(m, config=JSolverConfig(**kw)),
                         tcore.solve_cmvm(m, config=TSolverConfig(**kw)))


def test_fixed_point_matrix_and_input_depths_equal():
    """A float matrix on a 2^-3 grid, inputs at different adder depths."""
    m = _matrix(10, 7, seed=5) / 8.0
    depths = list(range(10))
    a = jcore.solve_cmvm(m, depth_in=depths, config=JSolverConfig(dc=1))
    b = tcore.solve_cmvm(m, depth_in=depths, config=TSolverConfig(dc=1))
    _assert_same_program(a, b)
    assert b.out_scale_exp == -3


@pytest.mark.parametrize("n,bits", [(4, 3), (16, 8), (32, 5)])
def test_naive_adder_tree_equal(n, bits):
    m = _matrix(n, bits, seed=n)
    _assert_same_program(jcore.naive_adder_tree(m), tcore.naive_adder_tree(m))


def test_solver_config_must_be_typed():
    with pytest.raises(tcore.solver.ConfigError, match="SolverConfig"):
        tcore.solve_cmvm(_matrix(3, 3, 0), config={"dc": 2})


# ----------------------------------------------------------------------
# program utilities and pipelining
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mdps", [1, 2, 5])
def test_program_utilities_and_pipeline_equal(mdps):
    m = _matrix(12, 6, seed=mdps)
    a = jcore.solve_cmvm(m, config=JSolverConfig(dc=-1)).program
    b = tcore.solve_cmvm(m, config=TSolverConfig(dc=-1)).program
    assert a.levelize() == b.levelize()
    assert [(q.lo, q.hi, q.exp) for q in a.output_qints()] == \
        [(q.lo, q.hi, q.exp) for q in b.output_qints()]
    assert a.output_depths() == b.output_depths()
    pa, pb = a.prune().to_arrays(), b.prune().to_arrays()
    for k in pa:
        np.testing.assert_array_equal(pa[k], pb[k])
    ra, rb = jcore.pipeline(a, mdps), tcore.pipeline(b, mdps)
    assert (ra.n_stages, ra.ff_bits, ra.stage_of_row, ra.latency_cycles) == \
        (rb.n_stages, rb.ff_bits, rb.stage_of_row, rb.latency_cycles)
    # a program packed by one package unpacks in the other
    x = np.random.default_rng(0).integers(-128, 128, size=(16, 12))
    np.testing.assert_array_equal(tcore.DAISProgram.from_arrays(a.to_arrays()).evaluate(x),
                                  a.evaluate(x))


# ----------------------------------------------------------------------
# the solution cache
# ----------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["da", "latency"])
def test_solve_key_digest_equal(kind):
    m = _matrix(9, 6, seed=1)
    jq, tq = _qints(jcore, 9, seed=2), _qints(tcore, 9, seed=2)
    cfg_j, cfg_t = JSolverConfig(dc=1, engine="arena"), TSolverConfig(dc=1, engine="arena")
    assert cfg_j.digest() == cfg_t.digest()
    depth = [0, 1, 2] * 3
    assert jcore.solve_key(m, jq, depth, kind=kind, solver=cfg_j.digest()) == \
        tcore.solve_key(m, tq, depth, kind=kind, solver=cfg_t.digest())
    assert jcore.config_solve_key(m, jq, depth, cfg_j) == tcore.config_solve_key(m, tq, depth, cfg_t)


@pytest.mark.parametrize("strategy,opts", [
    ("da", (2,)), ("da", (0,)), ("da", (2, "batch")), ("da", (2, "arena")), ("da", (2, "heap")),
    ("da", ({"dc": 2, "engine": "heap"},)), ("latency", (2,)),
], ids=["dc2", "dc0", "dc2-batch", "dc2-arena", "dc2-heap", "dict", "latency"])
def test_solve_task_legacy_payload_equal(strategy, opts):
    """``solve_task`` takes the dict payload and the legacy
    ``(w_int, qin, strategy, dc[, engine])`` tuple as the JAX package does."""
    m = np.random.default_rng(3).integers(-32, 32, size=(8, 6))
    a = jcore.solver.solve_task((m, [jcore.QInterval.from_fixed(True, 8, 8)] * 8, strategy, *opts))
    b = tcore.solver.solve_task((m, [tcore.QInterval.from_fixed(True, 8, 8)] * 8, strategy, *opts))
    _assert_same_program(a, b)
    np.testing.assert_array_equal(b.evaluate(np.eye(8, dtype=np.int64)), m)


@pytest.mark.parametrize("engine", [None, *ENGINES])
def test_default_solve_key_equal(engine):
    m = _matrix(9, 6, seed=5)
    jq, tq = _qints(jcore, 9, seed=6), _qints(tcore, 9, seed=6)
    depth = [0, 1, 2] * 3
    key = tcore.solver.default_solve_key(m, tq, depth, 2, engine=engine)
    assert key == jcore.solver.default_solve_key(m, jq, depth, 2, engine=engine)
    cfg = TSolverConfig(dc=2) if engine is None else TSolverConfig(dc=2, engine=engine)
    assert key == tcore.config_solve_key(m, tq, depth, cfg)
    assert "default_solve_key" not in tcore.__all__


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_disk_cache_entries_interchange(writer, tmp_path):
    m = _matrix(14, 7, seed=4)
    pkgs = {"jax": (jcore, JSolverConfig), "port": (tcore, TSolverConfig)}
    (wcore, wcfg), (rcore, rcfg) = pkgs[writer], pkgs["port" if writer == "jax" else "jax"]
    cold = wcore.solve_cmvm(m, config=wcfg(dc=2), cache=wcore.SolutionCache(disk_dir=str(tmp_path)))
    assert len(list(tmp_path.glob("*.npz"))) == 1
    reader = rcore.SolutionCache(disk_dir=str(tmp_path))
    hot = rcore.solve_cmvm(m, config=rcfg(dc=2), cache=reader)
    assert reader.stats.disk_hits == 1 and hot.stats.get("cache_hit")
    _assert_same_program(cold, hot)
    x = np.random.default_rng(1).integers(-128, 128, size=(32, 14))
    np.testing.assert_array_equal(hot.evaluate(x), x @ m)
