"""da4ml CMVM solver: two-stage pipeline (paper §4).

``solve_cmvm`` takes a constant matrix (integer, or fixed-point floats on
a power-of-two grid) and emits a :class:`DAISProgram` computing
``y = x @ M`` exactly as a shift-add adder graph:

  stage 1  graph decomposition  M = M1 @ M2      (graph_decompose)
  stage 2  cost-aware CSE on M1 and on M2        (cse)
  final    per-output minimal-depth adder trees  (cse._assemble)

The delay constraint ``dc`` is the number of extra adder-depth levels
allowed beyond each output's minimal achievable depth (dc = -1: none).
"""

from __future__ import annotations

import time
from dataclasses import dataclass, field
from collections.abc import Sequence

import numpy as np

from ..flow.config import UNSET, ConfigError, SolverConfig, resolve_legacy
from ..obs import solvelog, trace
from .cache import SolutionCache, solve_key
from .cost import ceil_log2, min_tree_depth
from .csd import csd_nnz
from .cse import CSE
from .dais import DAISProgram
from .fixed_point import QInterval
from .graph_decompose import decompose


@dataclass
class Solution:
    program: DAISProgram
    matrix: np.ndarray  # integer matrix on the input grid
    out_scale_exp: int  # real M = matrix * 2^out_scale_exp
    dc: int
    solver_time_s: float
    decomposed: bool
    stats: dict = field(default_factory=dict)
    # packed ``DAISProgram.to_arrays`` dict when one already exists (set
    # by the SolutionCache on hit AND on put) — consumers treat it as
    # read-only and skip re-packing the program (see compile_model)
    program_arrays: dict | None = field(default=None, repr=False)

    @property
    def n_adders(self) -> int:
        return self.program.n_adders

    @property
    def depth(self) -> int:
        return self.program.depth

    @property
    def cost_bits(self) -> int:
        return self.program.cost_bits

    @property
    def lut_estimate(self) -> int:
        return self.program.cost_bits

    def evaluate(self, x: np.ndarray) -> np.ndarray:
        """Exact integer evaluation of y = x @ matrix (grid units)."""
        return self.program.evaluate(x)

    def verify(self, n: int = 64, seed: int = 0) -> bool:
        rng = np.random.default_rng(seed)
        lo = np.array([q.lo for q in self._in_qints()], dtype=np.int64)
        hi = np.array([q.hi for q in self._in_qints()], dtype=np.int64)
        x = rng.integers(lo, hi + 1, size=(n, len(lo)), dtype=np.int64)
        want = x @ self.matrix
        got = self.evaluate(x)
        return bool(np.array_equal(want, got))

    def _in_qints(self) -> list[QInterval]:
        return [r.qint for r in self.program.rows[: self.program.n_inputs]]


def _integerize(m: np.ndarray, max_frac_bits: int = 32) -> tuple[np.ndarray, int]:
    """Scale a float matrix on a power-of-two grid to exact integers."""
    m = np.asarray(m)
    if np.issubdtype(m.dtype, np.integer):
        return m.astype(np.int64), 0
    for k in range(max_frac_bits + 1):
        scaled = m * (1 << k)
        if np.allclose(scaled, np.round(scaled), rtol=0, atol=0):
            return np.round(scaled).astype(np.int64), -k
    raise ValueError("matrix entries are not on a power-of-two grid")


def _budgets(
    m: np.ndarray, in_depths: Sequence[int], dc: int
) -> tuple[list[int | None], list[int]]:
    """Per-output depth budgets: minimal achievable depth + dc."""
    if dc < 0:
        # unconstrained: no caller consumes the per-output minima, so
        # skip the CSD population counts and tree simulations entirely
        return [None] * m.shape[1], []
    nnz = csd_nnz(m)  # [d_in, d_out]
    mins: list[int] = []
    for j in range(m.shape[1]):
        leaf_depths: list[int] = []
        for i in range(m.shape[0]):
            leaf_depths.extend([in_depths[i]] * int(nnz[i, j]))
        mins.append(min_tree_depth(leaf_depths) if leaf_depths else 0)
    return [mn + dc for mn in mins], mins


# legacy kwarg name -> SolverConfig field
_LEGACY_SOLVER_KWARGS = {
    "dc": "dc",
    "decompose_stage": "decompose",
    "weighted": "weighted",
    "assembly_dedup": "dedup",
    "depth_weight": "depth_weight",
    "engine": "engine",
}


def solve_cmvm(
    m: np.ndarray,
    qint_in: Sequence[QInterval] | None = None,
    depth_in: Sequence[int] | None = None,
    dc=UNSET,
    decompose_stage=UNSET,
    weighted=UNSET,
    assembly_dedup=UNSET,
    depth_weight=UNSET,
    engine=UNSET,
    program: DAISProgram | None = None,
    input_rows: Sequence[int] | None = None,
    cache: SolutionCache | None = None,
    config: SolverConfig | None = None,
) -> Solution:
    """Optimize ``y = x @ m`` into an adder graph.

    The canonical way to set solver options is ``config=``, a
    :class:`repro_torch.flow.SolverConfig`.  The individual option kwargs
    (``dc``, ``decompose_stage``, ``weighted``, ``assembly_dedup``,
    ``depth_weight``, ``engine``) are the JAX package's deprecated shim:
    they warn, construct the equivalent config and delegate, so both
    spellings give bit-identical programs and the same cache keys.

    Parameters
    ----------
    m : [d_in, d_out] constant matrix (ints, or floats on a 2^-k grid).
    qint_in : per-input quantized intervals (default: signed 8-bit ints).
    depth_in : per-input adder depths (default 0; used when chaining
        CMVMs, e.g. consecutive NN layers).
    program / input_rows : optionally extend an existing program whose
        rows ``input_rows`` are this CMVM's inputs (NN layer chaining).
    cache : optional content-addressed :class:`SolutionCache`; only used
        on the fresh-program path (not when extending via ``program``).
    config : :class:`SolverConfig` (default ``SolverConfig()``) — dc
        (delay constraint, -1 = unconstrained as in the paper's tables),
        CSE ``engine`` ("batch" vectorized default / "arena"
        preallocated-workspace fast path / "heap" exact reference — all
        bit-identical), stage-1 ``decompose``, ``weighted``/``dedup``/
        ``depth_weight`` CSE scoring knobs.
    """
    legacy = {
        name: val
        for name, val in (
            ("dc", dc),
            ("decompose_stage", decompose_stage),
            ("weighted", weighted),
            ("assembly_dedup", assembly_dedup),
            ("depth_weight", depth_weight),
            ("engine", engine),
        )
        if val is not UNSET
    }
    config = resolve_legacy(
        "solve_cmvm", config, legacy, SolverConfig,
        lambda lg: SolverConfig(**{_LEGACY_SOLVER_KWARGS[k]: v for k, v in lg.items()}),
    )
    return _solve_cmvm(
        m, qint_in, depth_in, config, program=program, input_rows=input_rows, cache=cache
    )


def _solve_cmvm(
    m: np.ndarray,
    qint_in: Sequence[QInterval] | None,
    depth_in: Sequence[int] | None,
    cfg: SolverConfig,
    program: DAISProgram | None = None,
    input_rows: Sequence[int] | None = None,
    cache: SolutionCache | None = None,
) -> Solution:
    """Config-consuming solver core (all public paths delegate here).

    Wraps the implementation in a ``solver.solve_cmvm`` trace span (a
    no-op unless ``REPRO_TRACE`` is on) and appends one structured
    record per solve to :mod:`repro_torch.obs.solvelog`.
    """
    shape = getattr(m, "shape", (0, 0))
    with trace.span(
        "solver.solve_cmvm",
        d_in=int(shape[0]),
        d_out=int(shape[1]) if len(shape) > 1 else 1,
        engine=getattr(cfg, "engine", "?"),
        dc=getattr(cfg, "dc", None),
    ):
        return _solve_cmvm_impl(
            m, qint_in, depth_in, cfg,
            program=program, input_rows=input_rows, cache=cache,
        )


def _solve_cmvm_impl(
    m: np.ndarray,
    qint_in: Sequence[QInterval] | None,
    depth_in: Sequence[int] | None,
    cfg: SolverConfig,
    program: DAISProgram | None = None,
    input_rows: Sequence[int] | None = None,
    cache: SolutionCache | None = None,
) -> Solution:
    if not isinstance(cfg, SolverConfig):
        raise ConfigError(
            f"solve_cmvm: config must be a SolverConfig, got {type(cfg).__name__}"
        )
    dc = cfg.dc
    decompose_stage = cfg.decompose
    weighted = cfg.weighted
    assembly_dedup = cfg.dedup
    depth_weight = cfg.depth_weight
    engine = cfg.engine
    t0 = time.perf_counter()
    m_int, scale_exp = _integerize(m)
    d_in, d_out = m_int.shape

    key = None
    if program is None:
        program = DAISProgram()
        if qint_in is None:
            qint_in = [QInterval.from_fixed(True, 8, 8)] * d_in
        if depth_in is None:
            depth_in = [0] * d_in
        if cache is not None:
            # cache identity = matrix/qints/depths + the config digest
            # (one definition of "same solve" across solver and compiler)
            key = solve_key(m_int, qint_in, depth_in, kind="da", solver=cfg.digest())
            hit = cache.get(key)
            if hit is not None:
                hit.out_scale_exp = scale_exp
                _log_solve_record(hit, m_int, cfg, time.perf_counter() - t0, True)
                return hit
        input_rows = [program.add_input(q, d) for q, d in zip(qint_in, depth_in)]
    else:
        if input_rows is None:
            raise ValueError("input_rows required when extending a program")
        input_rows = list(input_rows)
    in_depths = [program.rows[r].depth for r in input_rows]

    budgets, _ = _budgets(m_int, in_depths, dc)

    use_decomp = decompose_stage and dc != 0 and d_out > 1
    stats: dict = {"engine": engine}
    if use_decomp:
        with trace.span("solver.decompose", d_in=d_in, d_out=d_out):
            dec = decompose(m_int, dc)
        stats["decomposition_trivial"] = dec.is_trivial
        stats["m1_cols"] = int(dec.m1.shape[1])
        if dec.is_trivial:
            use_decomp = False

    if use_decomp:
        # ---- stage 2a: CSE on M1 ----
        # budget for M1 column e: tightest consumer budget minus the depth
        # reserve needed to merge that consumer's path terms.
        k = dec.m1.shape[1]
        m1_budgets: list[int | None] = [None] * k
        if dc >= 0:
            for e in range(k):
                consumers = np.nonzero(dec.m2[e, :])[0]
                b = None
                for j in consumers:
                    bj = budgets[j]
                    if bj is None:
                        continue
                    cand = bj - ceil_log2(int(dec.path_len[j]))
                    b = cand if b is None else min(b, cand)
                m1_budgets[e] = None if b is None else max(b, 0)
        cols1 = [
            {input_rows[i]: int(dec.m1[i, e]) for i in range(d_in) if dec.m1[i, e] != 0}
            for e in range(k)
        ]
        cse1 = CSE(
            program, cols1, m1_budgets, weighted, assembly_dedup, depth_weight,
            engine=engine,
        )
        z_terms = cse1.run()
        stats["stage1_cse"] = cse1.stats

        # ---- stage 2b: CSE on M2 (rows rebased onto z program rows) ----
        cols2: list[dict[int, int]] = []
        for j in range(d_out):
            col: dict[int, int] = {}
            for e in range(k):
                c = int(dec.m2[e, j])
                if c == 0 or z_terms[e] is None:
                    continue
                t = z_terms[e]
                col[t.row] = col.get(t.row, 0) + c * t.sign * (1 << t.shift)
            cols2.append(col)
        cse2 = CSE(
            program, cols2, budgets, weighted, assembly_dedup, depth_weight,
            engine=engine,
        )
        outputs = cse2.run()
        stats["stage2_cse"] = cse2.stats
    else:
        cols = [
            {input_rows[i]: int(m_int[i, j]) for i in range(d_in) if m_int[i, j] != 0}
            for j in range(d_out)
        ]
        cse = CSE(
            program, cols, budgets, weighted, assembly_dedup, depth_weight,
            engine=engine,
        )
        outputs = cse.run()
        stats["stage2_cse"] = cse.stats

    program.outputs = outputs
    pruned = program.prune()
    dt = time.perf_counter() - t0
    sol = Solution(pruned, m_int, scale_exp, dc, dt, use_decomp, stats)
    if key is not None:
        cache.put(key, sol)
    _log_solve_record(sol, m_int, cfg, dt, False)
    return sol


def _log_solve_record(
    sol: Solution, m_int: np.ndarray, cfg: SolverConfig,
    wall_s: float, cache_hit: bool,
) -> None:
    """One flat per-solve record (matrix stats -> outcome) for the
    resource-predictor training log (repro_torch.obs.solvelog)."""
    solvelog.log_solve(
        {
            "kind": "cmvm",
            "engine": cfg.engine,
            "dc": cfg.dc,
            "decomposed": bool(sol.decomposed),
            "d_in": int(m_int.shape[0]),
            "d_out": int(m_int.shape[1]),
            "nnz": int(np.count_nonzero(m_int)),
            "w_max_abs": int(np.abs(m_int).max()) if m_int.size else 0,
            "adders": int(sol.n_adders),
            "cost_bits": int(sol.cost_bits),
            "depth": int(sol.depth),
            "wall_s": wall_s,
            "cache_hit": cache_hit,
        }
    )


def config_solve_key(
    m_int, qint_in, depth_in, cfg: SolverConfig, kind: str = "da"
) -> str:
    """Cache key of one solve under ``cfg`` — exactly the key
    ``solve_cmvm(..., config=cfg, cache=...)`` uses internally, so the
    compiler's deferred-solve path and direct solver calls share cache
    entries by construction."""
    return solve_key(m_int, qint_in, depth_in, kind=kind, solver=cfg.digest())


def default_solve_key(
    m_int, qint_in, depth_in, dc: int, kind: str = "da",
    engine: str | None = None,
) -> str:
    """Deprecated shim: cache key for a solve with every option at its
    :class:`SolverConfig` default (``engine`` optionally overridden).
    Use :func:`config_solve_key`."""
    cfg = SolverConfig(dc=dc) if engine is None else SolverConfig(dc=dc, engine=engine)
    return config_solve_key(m_int, qint_in, depth_in, cfg, kind=kind)


def solve_task(payload) -> "Solution":
    """One CMVM solve from a plain-tuple payload
    ``(w_int, qin, strategy, solver_config_dict)`` — the compiler's
    deferred-solve unit.  Legacy ``(w_int, qin, strategy, dc[, engine])``
    tuples are still accepted.

    Solve-pool workers (the compiler's GIL-releasing thread pool, see
    ``repro_torch.nn.compiler``) touch only numpy-land code through it;
    the payload stays picklable for callers that want to farm solves
    across processes.
    """
    w_int, qin, strategy, opts = payload[:4]
    if isinstance(opts, dict):
        cfg = SolverConfig.from_dict(opts)
    else:  # legacy payload: opts is dc, optional 5th element is engine
        engine = payload[4] if len(payload) > 4 else "batch"
        cfg = SolverConfig(dc=opts, engine=engine)
    if strategy == "latency":
        return naive_adder_tree(w_int, qint_in=qin)
    return _solve_cmvm(w_int, qin, None, cfg)


def naive_adder_tree(
    m: np.ndarray,
    qint_in: Sequence[QInterval] | None = None,
    depth_in: Sequence[int] | None = None,
) -> Solution:
    """Baseline: per-output CSD adder tree without any sharing.

    This models the resource behaviour of the fully-unrolled hls4ml
    'latency' strategy (each output is an independent MAC tree), expressed
    in the same adder/cost units so comparisons are apples-to-apples.
    """
    t0 = time.perf_counter()
    m_int, scale_exp = _integerize(m)
    d_in, d_out = m_int.shape
    program = DAISProgram()
    if qint_in is None:
        qint_in = [QInterval.from_fixed(True, 8, 8)] * d_in
    if depth_in is None:
        depth_in = [0] * d_in
    input_rows = [program.add_input(q, d) for q, d in zip(qint_in, depth_in)]
    cols = [
        {input_rows[i]: int(m_int[i, j]) for i in range(d_in) if m_int[i, j] != 0}
        for j in range(d_out)
    ]
    # skip the CSE loop entirely (no counts, empty heap): assembly only
    cse = CSE(
        program, cols, [None] * d_out, weighted=False, assembly_dedup=False,
        build_counts=False,
    )
    outputs = cse.run()
    program.outputs = outputs
    dt = time.perf_counter() - t0
    sol = Solution(program.prune(), m_int, scale_exp, -1, dt, False, {"baseline": True})
    return sol
