"""Model -> adder-graph compiler, and compiled DA designs as PyTorch
modules (the integer executor).

``compile_model`` walks a quantized ``Sequential``, replaces every CMVM
(QDense / QDenseOnAxis / QConv2D-via-im2col) by a da4ml-optimized DAIS
program (strategy="da") or by the per-output naive CSD tree
(strategy="latency", the hls4ml latency-strategy baseline), and stitches
the layers into a bit-exact *integer* executor plus a resource report
(adders, cost bits ~ LUTs, FF estimate from pipelining, adder depth,
latency in pipeline stages) mirroring the paper's network tables.  The
quantization of the weights and the solves are numpy on the host, as in
the JAX package, so that the programs come out byte for byte the same;
the design then lives on a device.

Exact quantized intervals are propagated feature-by-feature through the
whole network — ReLU clips, pool merges, residual sums — so downstream
CMVMs are solved with true per-input ranges (the qint machinery of
paper §4.1 applied end-to-end).

A design's execution pipeline is a list of declarative :class:`StepSpec`
records (the same records, with the same meaning, as in the JAX
package) plus one set of adder-graph tables per unique CMVM.
:func:`build_steps` turns the specs into ``nn.Module`` steps whose
integer constants (bias, shifts, requant deltas) are buffers, so they
move to the design's device once, with the design, and never per call.

Activations flow as int32 ``[batch, prod(shape)]`` in C order.  Every
step reproduces the JAX executor bit for bit: int32 wraparound, a left
shift of 32 or more gives 0, an arithmetic right shift of 32 or more
gives the sign fill, and the avgpool sum stays int32.
"""

from __future__ import annotations

import concurrent.futures
import os
import time
from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..analysis.verify import DesignVerificationError, verify_design
from ..core.cache import SolutionCache, solve_key
from ..core.fixed_point import QInterval
from ..core.pipelining import pipeline
from ..core.solver import Solution, config_solve_key, solve_task
from ..flow.config import UNSET, CompileConfig, ConfigError, SolverConfig, resolve_legacy
from ..kernels.adder_graph import AdderGraphTables, adder_graph_apply, compile_tables
from ..obs import trace
from .layers import (
    AvgPool2D,
    Flatten,
    MaxPool2D,
    QConv2D,
    QDense,
    QDenseOnAxis,
    ReLU,
    Residual,
    Sequential,
)
from .quant import QuantConfig


@dataclass
class LayerReport:
    name: str
    shape: str
    adders: int
    cost_bits: int
    depth: int
    stages: int
    ff_bits: int
    solver_time_s: float


@dataclass
class StepSpec:
    """Declarative description of one executor step.

    kind    one of dense / conv / requant / transpose / relu / maxpool /
            avgpool / residual.
    params  JSON-serializable scalars (shapes, strides, clip bounds).
    arrays  integer numpy arrays (bias, pre-shift, requant shifts).
    table   index into ``CompiledDesign.tables`` for CMVM kinds, else -1.
    body    nested specs (residual only).
    """

    kind: str
    params: dict = field(default_factory=dict)
    arrays: dict = field(default_factory=dict)
    table: int = -1
    body: list[StepSpec] | None = None


def _int_row(arr) -> torch.Tensor:
    """An integer array as an int32 [1, n] tensor (broadcast over the batch)."""
    return torch.as_tensor(np.asarray(arr).astype(np.int32)).reshape(1, -1)


# ----------------------------------------------------------------------
# Steps
# ----------------------------------------------------------------------
class _Cmvm(nn.Module):
    """``y = adder_graph(x) << shift + bias`` on one table."""

    def __init__(self, spec: StepSpec, tables: list[AdderGraphTables]):
        super().__init__()
        self.tables = tables[spec.table]
        a = spec.arrays
        self.register_buffer("bias", _int_row(a["bias"])[0] if "bias" in a else None)
        self.register_buffer("shift", _int_row(a["shift"]) if "shift" in a else None)

    def cmvm(self, v: torch.Tensor) -> torch.Tensor:
        y = adder_graph_apply(self.tables, v)
        if self.shift is not None:
            y = y << self.shift
        return y + self.bias if self.bias is not None else y


class _Dense(_Cmvm):
    def __init__(self, spec, tables):
        super().__init__(spec, tables)
        self.d_in = spec.params["d_in"]

    def forward(self, v):
        return self.cmvm(v.reshape(-1, self.d_in)).reshape(v.shape[0], -1)


class _Conv(_Cmvm):
    """VALID convolution by im2col over NHWC activations."""

    def __init__(self, spec, tables):
        super().__init__(spec, tables)
        p = spec.params
        self.hwc = (p["h"], p["w"], p["cin"])
        self.kernel = (p["kh"], p["kw"])
        self.stride = (p["sh"], p["sw"])
        self.out_hw = (p["oh"], p["ow"])

    def forward(self, v):
        (kh, kw), (sh, sw), (oh, ow) = self.kernel, self.stride, self.out_hw
        x = v.reshape(-1, *self.hwc)
        patches = [
            x[:, dy : dy + sh * (oh - 1) + 1 : sh, dx : dx + sw * (ow - 1) + 1 : sw, :]
            for dy in range(kh)
            for dx in range(kw)
        ]
        cols = torch.cat(patches, dim=-1)  # [B, oh, ow, kh*kw*cin]
        y = self.cmvm(cols.reshape(-1, cols.shape[-1]))
        return y.reshape(-1, oh * ow * y.shape[-1])


class _Requant(nn.Module):
    """Shift each feature onto the target grid (left for d > 0, arithmetic
    right otherwise), then saturate."""

    def __init__(self, spec):
        super().__init__()
        d = np.asarray(spec.arrays["d"], np.int64)
        self.register_buffer("dpos", _int_row(np.maximum(d, 0)))
        self.register_buffer("dneg", _int_row(np.maximum(-d, 0)))
        self.lo, self.hi = spec.params["lo"], spec.params["hi"]

    def forward(self, v):
        v = torch.where(self.dpos > 0, v << self.dpos, v >> self.dneg)
        return v.clamp(self.lo, self.hi)


class _Transpose(nn.Module):
    def __init__(self, spec):
        super().__init__()
        self.shape = tuple(spec.params["shape"])
        self.perm = (0, *[q + 1 for q in spec.params["perm"]])

    def forward(self, v):
        n = v.shape[0]
        return v.reshape(n, *self.shape).permute(self.perm).reshape(n, -1)


class _ReLU(nn.Module):
    def forward(self, v):
        return v.clamp(min=0)


class _Pool(nn.Module):
    def __init__(self, spec):
        super().__init__()
        p = spec.params
        self.is_max = spec.kind == "maxpool"
        self.grid = (p["h"] // p["ph"], p["ph"], p["w"] // p["pw"], p["pw"], p["c"])

    def forward(self, v):
        x = v.reshape(-1, *self.grid)
        # an int32 sum would otherwise widen to int64
        r = x.amax(dim=(2, 4)) if self.is_max else x.sum(dim=(2, 4), dtype=torch.int32)
        return r.reshape(v.shape[0], -1)


class _Residual(nn.Module):
    """``(v << sa) + (body(v) << sb)``: both branches on a common grid."""

    def __init__(self, spec, tables):
        super().__init__()
        self.body = nn.ModuleList(_build_step(s, tables) for s in spec.body or [])
        self.register_buffer("sa", _int_row(spec.arrays["sa"]))
        self.register_buffer("sb", _int_row(spec.arrays["sb"]))

    def forward(self, v):
        u = v
        for s in self.body:
            u = s(u)
        return (v << self.sa) + (u << self.sb)


def build_steps(specs: list[StepSpec], tables: list[AdderGraphTables]) -> nn.ModuleList:
    """The executable pipeline of a design, built on the CPU from its
    step specs and tables (move it with the design)."""
    return nn.ModuleList(_build_step(s, tables) for s in specs)


def _build_step(spec: StepSpec, tables: list[AdderGraphTables]) -> nn.Module:
    kind = spec.kind
    if kind == "dense":
        return _Dense(spec, tables)
    if kind == "conv":
        return _Conv(spec, tables)
    if kind == "requant":
        return _Requant(spec)
    if kind == "transpose":
        return _Transpose(spec)
    if kind == "relu":
        return _ReLU()
    if kind in ("maxpool", "avgpool"):
        return _Pool(spec)
    if kind == "residual":
        return _Residual(spec, tables)
    raise ValueError(f"unknown step kind {kind!r}")


def count_cmvm_steps(specs: list[StepSpec]) -> int:
    """CMVM steps of a pipeline, residual bodies included: the number of
    adder-graph calls one ``forward_int`` makes."""
    return sum(
        (s.kind in ("dense", "conv")) + count_cmvm_steps(s.body or []) for s in specs
    )


# ----------------------------------------------------------------------
# Design
# ----------------------------------------------------------------------
class CompiledDesign(nn.Module):
    """A compiled DA design on one device.

    ``forward_int`` runs the integer pipeline on grid integers;
    ``forward`` (the module's call) quantizes floats onto the input grid
    and scales the integer outputs back.  ``programs`` are the packed
    DAIS programs (``DAISProgram.to_arrays`` dicts) the tables were
    built from; together with ``step_specs`` they are what an artifact
    stores.  ``use_pallas`` is the JAX package's kernel switch, carried
    through so that manifests round-trip; it selects nothing here.
    """

    def __init__(
        self,
        *,
        step_specs: list[StepSpec],
        tables: list[AdderGraphTables],
        programs: list[dict],
        in_quant: QuantConfig,
        in_shape: tuple,
        out_shape: tuple,
        out_qints: list[QInterval],
        device: str | torch.device | None = None,
        reports: list[LayerReport] | None = None,
        solver_stats: dict | None = None,
        use_pallas: bool = False,
        config: CompileConfig | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.step_specs = step_specs
        self.tables = tables
        self.programs = programs
        self.in_quant = in_quant
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.out_qints = out_qints
        self.reports = list(reports or [])
        self.solver_stats = dict(solver_stats or {})
        self.use_pallas = bool(use_pallas)
        self.config = config
        self.steps = build_steps(step_specs, tables)
        exps = np.array([0 if q.is_zero else q.exp for q in out_qints], np.float64)
        self.register_buffer(
            "out_scale", torch.tensor(2.0**exps, dtype=torch.float32).reshape(self.out_shape)
        )
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.out_scale.device

    def _apply(self, fn, recurse=True):
        # every move (to / cuda / cpu) also places the tables on the new
        # device, so no call copies them
        super()._apply(fn, recurse)
        for t in self.tables:
            t.device_arrays(self.device)
        return self

    # ------------------------------------------------------------------
    def save(self, path):
        """Persist as a ``da4ml-design`` artifact (see
        :func:`repro_torch.runtime.save_design`)."""
        from ..runtime.artifact import save_design  # runtime imports nn

        return save_design(self, path)

    @classmethod
    def load(cls, path, device=None, verify: str = "off", on_corrupt: str = "raise"):
        """Rebuild a design from an artifact on ``device`` (see
        :func:`repro_torch.runtime.load_design`)."""
        from ..runtime.artifact import load_design  # runtime imports nn

        return load_design(path, device=device, verify=verify, on_corrupt=on_corrupt)

    @property
    def total_adders(self) -> int:
        return sum(r.adders for r in self.reports)

    @property
    def total_cost_bits(self) -> int:
        return sum(r.cost_bits for r in self.reports)

    @property
    def total_ff_bits(self) -> int:
        return sum(r.ff_bits for r in self.reports)

    @property
    def latency_cycles(self) -> int:
        return sum(r.stages for r in self.reports)

    @property
    def max_depth(self) -> int:
        return max((r.depth for r in self.reports), default=0)

    # ------------------------------------------------------------------
    def forward_int(self, x_int: torch.Tensor) -> torch.Tensor:
        """Run the integer pipeline.  x_int: int tensor [batch, *in_shape]
        of grid integers on the design's device; returns int32
        [batch, *out_shape]."""
        if x_int.device != self.device:
            raise ValueError(
                f"input is on {x_int.device}, the design on {self.device}; "
                "move one of them"
            )
        n = x_int.shape[0]
        v = x_int.reshape(n, -1).to(torch.int32)
        for step in self.steps:
            v = step(v)
        return v.reshape(n, *self.out_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Float in, float out: floor onto the input grid, saturate, run
        the integer pipeline, scale the outputs by their grid steps."""
        q = self.in_quant
        xi = torch.clamp(torch.floor(x / q.step), q.qint.lo, q.qint.hi).to(torch.int32)
        return self.forward_int(xi).to(torch.float32) * self.out_scale

    def summary(self) -> str:
        hdr = (
            f"{'layer':<20}{'shape':<14}{'adders':>8}{'LUTbits':>9}{'depth':>7}"
            f"{'stages':>7}{'FFbits':>8}{'t[s]':>8}"
        )
        rows = [hdr, "-" * len(hdr)]
        for r in self.reports:
            rows.append(
                f"{r.name:<20}{r.shape:<14}{r.adders:>8}{r.cost_bits:>9}{r.depth:>7}"
                f"{r.stages:>7}{r.ff_bits:>8}{r.solver_time_s:>8.2f}"
            )
        rows.append("-" * len(hdr))
        rows.append(
            f"{'TOTAL':<20}{'':<14}{self.total_adders:>8}{self.total_cost_bits:>9}"
            f"{self.max_depth:>7}{self.latency_cycles:>7}{self.total_ff_bits:>8}"
        )
        return "\n".join(rows)


# ----------------------------------------------------------------------
# qint helpers
# ----------------------------------------------------------------------
def _relu_qint(q: QInterval) -> QInterval:
    if q.is_zero:
        return q
    return QInterval(max(q.lo, 0), max(q.hi, 0), q.exp)


def _requant_qint(q: QInterval, cfg: QuantConfig) -> QInterval:
    """floor+saturate of a value with interval q onto cfg's grid."""
    t = cfg.qint
    if q.is_zero:
        return QInterval(0, 0, t.exp)
    d = q.exp - t.exp
    lo = q.lo << d if d >= 0 else q.lo >> (-d)
    hi = q.hi << d if d >= 0 else q.hi >> (-d)
    lo = min(max(lo, t.lo), t.hi)
    hi = min(max(hi, t.lo), t.hi)
    return QInterval(lo, hi, t.exp)


def _union_all(qs: list[QInterval]) -> QInterval:
    q0 = qs[0]
    if all(q is q0 or q == q0 for q in qs):
        return q0
    for q in qs[1:]:
        q0 = q0.union(q)
    return q0


def _exps(qints: list[QInterval], fallback: int = 0) -> np.ndarray:
    return np.array([fallback if q.is_zero else q.exp for q in qints], dtype=np.int64)


def _requant_spec(qints: list[QInterval], cfg: QuantConfig) -> StepSpec:
    t = cfg.qint
    d = _exps(qints, fallback=t.exp) - t.exp
    # "exp" (the target grid exponent) is not read by the executor; it is
    # the metadata that lets the static verifier (repro_torch.analysis)
    # replay this requant's interval transfer exactly
    return StepSpec(
        "requant",
        params={"lo": int(t.lo), "hi": int(t.hi), "exp": int(t.exp)},
        arrays={"d": d},
    )


def _align_exps(qints_a, qints_b):
    """Shift arrays onto the common (finer) per-feature grid + summed qints."""
    ea, eb = _exps(qints_a), _exps(qints_b)
    e = np.minimum(ea, eb)
    out_q = []
    for qa, qb, ee in zip(qints_a, qints_b, e):
        qa2 = QInterval(qa.lo, qa.hi, qa.exp) if not qa.is_zero else QInterval(0, 0, int(ee))
        qb2 = QInterval(qb.lo, qb.hi, qb.exp) if not qb.is_zero else QInterval(0, 0, int(ee))
        out_q.append(qa2.add(qb2))
    return (ea - e).astype(np.int64), (eb - e).astype(np.int64), out_q


# ----------------------------------------------------------------------
# Compiler
# ----------------------------------------------------------------------
# compile_model runs in three phases, all on the host:
#
#   plan    walk the layer graph, quantize weights, and propagate exact
#           per-feature qints WITHOUT solving: the output interval of a
#           CMVM is the exact affine range of y = x @ W (structure-
#           independent), so downstream layers can be planned before any
#           solver runs.  Each unique (matrix, qints, dc, strategy) is
#           registered once as a _SolveSlot.
#   solve   resolve the slots: content-addressed cache first, then the
#           remaining solves either serially or on a GIL-releasing
#           thread pool (``jobs=``; the solver hot loop is pure numpy).
#           Results stitch back by slot identity, so the parallel path
#           is bit-identical to the serial one.
#   stitch  compile instruction tables, pipeline reports, and layer
#           reports in original layer order; place the design on its
#           device.


class _SolveSlot:
    """One deferred CMVM solve.  After stitch, everything except the
    compiled instruction tables is released (the weight matrices and
    solved programs would otherwise stay pinned by the compile)."""

    __slots__ = (
        "idx", "key", "qin", "solution", "solver_cfg", "strategy", "tables", "w_int",
    )

    def __init__(self, w_int, qin, strategy, solver_cfg, idx):
        self.w_int = w_int
        self.qin = qin
        self.strategy = strategy
        self.solver_cfg: SolverConfig = solver_cfg
        self.key = None
        self.solution: Solution | None = None
        self.tables = None
        self.idx = idx  # position in ctx.slots == design.tables index


class _Ctx:
    def __init__(self, cfg: CompileConfig):
        self.cfg = cfg
        self.strategy = cfg.strategy
        self.mdps = cfg.max_delay_per_stage
        self._solver_digest = cfg.solver.digest()
        self.slots: list[_SolveSlot] = []
        self.slot_map: dict = {}
        self.pending_reports: list = []

    def request(self, w_int: np.ndarray, qin: list[QInterval]) -> _SolveSlot:
        dedup = (
            self.strategy, self._solver_digest,
            w_int.shape, w_int.tobytes(), tuple(qin),
        )
        slot = self.slot_map.get(dedup)
        if slot is None:
            slot = _SolveSlot(w_int, qin, self.strategy, self.cfg.solver, len(self.slots))
            self.slot_map[dedup] = slot
            self.slots.append(slot)
        return slot


def _slot_key(slot: _SolveSlot) -> str:
    """Cache key; matches solve_cmvm's internal key for the "da" path
    (both derive from the SolverConfig digest, so they cannot drift)."""
    depth_in = [0] * len(slot.qin)
    if slot.strategy == "latency":
        return solve_key(slot.w_int, slot.qin, depth_in, kind="latency")
    return config_solve_key(slot.w_int, slot.qin, depth_in, slot.solver_cfg)


def _solve_slots(
    slots: list[_SolveSlot],
    jobs: int | None,
    cache: SolutionCache | None,
    slot_names: dict[int, list[str]] | None = None,
) -> dict:
    """Resolve the deferred CMVM solves: cache first, then the remaining
    misses in a thread pool.

    numpy drops the GIL inside its kernels but the solver's Python-level
    bookkeeping still serializes part of each solve, so the thread
    speedup is sublinear.  Each worker thread keeps its own ``CSEArena``
    (see repro_torch.core.cse), so ``engine="arena"`` solves stay
    allocation-quiet across layers.  Results stitch back by slot
    identity: any ``jobs`` value is bit-identical to serial.

    Going serial is never silent: ``pool_fallback`` in the returned
    stats records why the pool was skipped (None when it actually ran).
    The pool is host threads: it picks no device.
    """
    t0 = time.perf_counter()
    cache_before = cache.stats.as_dict() if cache is not None else None
    names = slot_names or {}
    slot_wall: dict[int, float] = {}
    slot_hit: dict[int, bool] = {}
    n_hits = 0
    misses: list[_SolveSlot] = []
    for slot in slots:
        if cache is not None:
            th0 = time.perf_counter()
            slot.key = _slot_key(slot)
            hit = cache.get(slot.key)
            if hit is not None:
                slot.solution = hit
                slot_wall[slot.idx] = time.perf_counter() - th0
                slot_hit[slot.idx] = True
                n_hits += 1
                continue
        misses.append(slot)
    n_pool = 0
    fallback: str | None = None
    if misses:
        # (payload, label) units: the label names the solve's trace span
        # and keys the per-slot wall time
        work = [
            (
                (s.w_int, s.qin, s.strategy, s.solver_cfg.to_dict()),
                names.get(s.idx, [f"slot{s.idx}"])[0],
            )
            for s in misses
        ]
        results: list[tuple[Solution, float]] | None = None
        jobs_eff = os.cpu_count() or 1 if jobs is None else jobs
        if jobs_eff == 1:
            fallback = "jobs=1"
        elif len(misses) == 1:
            fallback = "single_solve"
        else:
            workers = min(jobs_eff, len(misses))
            try:
                with concurrent.futures.ThreadPoolExecutor(
                    workers, thread_name_prefix="da4ml-solve"
                ) as ex:
                    results = list(ex.map(_timed_solve_task, work))
                n_pool = len(results)
            except Exception as e:  # pool unavailable: loud serial fallback
                results = None
                fallback = f"thread_pool_error: {type(e).__name__}: {e}"
        if results is None:
            results = [_timed_solve_task(w) for w in work]
        for slot, (sol, wall) in zip(misses, results):
            slot.solution = sol
            slot_wall[slot.idx] = wall
            slot_hit[slot.idx] = False
            if cache is not None:
                cache.put(slot.key, sol)
    else:
        fallback = "no_cache_misses" if slots else "no_cmvm_layers"
    stats = {
        "n_solves": len(misses),
        "n_cache_hits": n_hits,
        "n_pool_solves": n_pool,
        "pool_fallback": fallback,
        "solver_time_s": sum(s.solution.solver_time_s for s in slots),
        "solve_phase_s": time.perf_counter() - t0,
        "per_layer": _per_layer_stats(slots, names, slot_wall, slot_hit),
    }
    if cache is not None:
        # per-compile delta of the cache counters, so artifact-vs-cache
        # savings are measurable even when one SolutionCache is shared
        after = cache.stats.as_dict()
        stats["cache_stats"] = {k: after[k] - cache_before[k] for k in after}
    return stats


def _timed_solve_task(work: tuple) -> tuple[Solution, float]:
    """One pool unit: solve + wall time, under a labelled trace span so
    the Perfetto timeline shows which layer each pool thread solved."""
    payload, label = work
    t0 = time.perf_counter()
    with trace.span("compile.solve", layer=label):
        sol = solve_task(payload)
    return sol, time.perf_counter() - t0


def _per_layer_stats(
    slots: list[_SolveSlot],
    names: dict[int, list[str]],
    slot_wall: dict[int, float],
    slot_hit: dict[int, bool],
) -> dict:
    """Per-layer solve attribution: wall seconds and cache hit/miss keyed
    by layer name (layers deduplicated onto one slot each get an entry
    pointing at the shared slot)."""
    per_layer: dict[str, dict] = {}
    for slot in slots:
        layer_names = names.get(slot.idx, [f"slot{slot.idx}"])
        sol = slot.solution
        for nm in layer_names:
            per_layer[nm] = {
                "slot": slot.idx,
                "shape": f"{slot.w_int.shape[0]}x{slot.w_int.shape[1]}"
                if slot.w_int is not None
                else "?",
                "cache_hit": slot_hit.get(slot.idx, False),
                "solve_wall_s": slot_wall.get(slot.idx, 0.0),
                "adders": int(sol.n_adders) if sol is not None else 0,
                "cost_bits": int(sol.cost_bits) if sol is not None else 0,
                "depth": int(sol.depth) if sol is not None else 0,
                "shared_slot": len(layer_names) > 1,
            }
    return per_layer


# legacy kwarg name -> its default, from which the CompileConfig is built
_LEGACY_COMPILE_DEFAULTS = {
    "dc": 2,
    "strategy": "da",
    "max_delay_per_stage": 5,
    "use_pallas": False,
    "jobs": None,
    "cache": None,
    "engine": "batch",
}


def compile_model(
    model: Sequential,
    params: list,
    in_shape: tuple[int, ...],
    in_quant: QuantConfig,
    dc=UNSET,
    strategy=UNSET,
    max_delay_per_stage=UNSET,
    use_pallas=UNSET,
    jobs=UNSET,
    cache=UNSET,
    engine=UNSET,
    config: CompileConfig | None = None,
    device: str | torch.device | None = None,
) -> CompiledDesign:
    """Compile a quantized Sequential into a bit-exact integer design on
    ``device`` (default: the CUDA card; raises without one unless
    ``device="cpu"``).

    ``params`` is the parameter list of :func:`repro_torch.nn.init_params`
    or :func:`repro_torch.nn.params_from_numpy` (tensors on any device)
    or of numpy arrays; the weights are quantized with numpy on the
    host.  ``config`` is a :class:`repro_torch.flow.CompileConfig`
    (default ``CompileConfig()``; this is what ``Flow.compile`` passes):
    ``strategy`` ("da" solver / "latency" baseline); ``jobs`` (CMVM
    solver thread-pool width: None = cpu_count, 1 = serial; any value is
    bit-identical, and serial fallbacks are recorded in
    ``solver_stats["pool_fallback"]``); ``cache`` (a
    :class:`SolutionCache` so repeated compiles skip solved CMVMs);
    ``solver`` (nested :class:`SolverConfig`); ``verify`` (the
    static-verification tier; error findings raise
    ``DesignVerificationError``).  The individual option kwargs (``dc``
    ... ``engine``) are the JAX package's deprecated shim: they warn and
    build the equivalent config, so both spellings give bit-identical
    designs.
    """
    legacy = {
        name: val
        for name, val in (
            ("dc", dc),
            ("strategy", strategy),
            ("max_delay_per_stage", max_delay_per_stage),
            ("use_pallas", use_pallas),
            ("jobs", jobs),
            ("cache", cache),
            ("engine", engine),
        )
        if val is not UNSET
    }
    cfg = resolve_legacy("compile_model", config, legacy, CompileConfig, _config_from_legacy)
    return _compile_model(model, params, in_shape, in_quant, cfg, resolve_device(device))


def _config_from_legacy(legacy: dict) -> CompileConfig:
    def get(k):
        return legacy.get(k, _LEGACY_COMPILE_DEFAULTS[k])

    return CompileConfig(
        strategy=get("strategy"),
        max_delay_per_stage=get("max_delay_per_stage"),
        use_pallas=get("use_pallas"),
        jobs=get("jobs"),
        cache=get("cache"),
        solver=SolverConfig(dc=get("dc"), engine=get("engine")),
    )


def _compile_model(
    model: Sequential,
    params: list,
    in_shape: tuple[int, ...],
    in_quant: QuantConfig,
    cfg: CompileConfig,
    dev: torch.device,
) -> CompiledDesign:
    """Config-consuming compiler core (all public paths delegate here)."""
    if not isinstance(cfg, CompileConfig):
        raise ConfigError(
            f"compile_model: config must be a CompileConfig, got {type(cfg).__name__}"
        )
    ctx = _Ctx(cfg)
    shape = tuple(in_shape)
    qints = [in_quant.qint] * int(np.prod(shape))
    # plan
    with trace.span("compile.plan", n_layers=len(model)):
        specs, shape, qints = _compile_seq(model, params, shape, qints, ctx)
    # slot -> unique layer names ("dense0", "conv1", ... in layer order);
    # layers deduplicated onto one slot contribute one name each
    slot_names: dict[int, list[str]] = {}
    for k, (slot, name, _shape_str, _nb, _bb) in enumerate(ctx.pending_reports):
        slot_names.setdefault(slot.idx, []).append(f"{name}{k}")
    # solve
    with trace.span("compile.solve_phase", n_slots=len(ctx.slots)):
        solver_stats = _solve_slots(ctx.slots, cfg.jobs, cfg.cache, slot_names)
    solver_stats["engine"] = cfg.solver.engine
    # stitch
    with trace.span("compile.stitch"):
        reports = []
        for slot, name, shape_str, n_bias, bias_bits in ctx.pending_reports:
            sol = slot.solution
            if slot.tables is None:
                slot.tables = compile_tables(sol.program)
            rep = pipeline(sol.program, ctx.mdps)
            reports.append(
                LayerReport(
                    name=f"{name}[{ctx.strategy}]",
                    shape=shape_str,
                    adders=sol.n_adders + n_bias,
                    cost_bits=sol.cost_bits + bias_bits,
                    depth=sol.depth + (1 if n_bias else 0),
                    stages=rep.n_stages,
                    ff_bits=rep.ff_bits,
                    solver_time_s=sol.solver_time_s,
                )
            )
        tables, programs = [], []
        n_packs = n_reused = 0
        for slot in ctx.slots:
            if slot.tables is None:
                slot.tables = compile_tables(slot.solution.program)
            tables.append(slot.tables)
            # prefer the SolutionCache's already-packed arrays (set on both
            # cache hits and puts) over a fresh to_arrays pack
            parr = slot.solution.program_arrays
            if parr is not None:
                programs.append(parr)
                n_reused += 1
            else:
                try:
                    programs.append(slot.solution.program.to_arrays())
                    n_packs += 1
                except OverflowError:
                    programs.append(None)  # not serializable: save_design rejects
            slot.w_int = slot.qin = slot.solution = slot.key = None
        solver_stats["n_program_packs"] = n_packs
        solver_stats["n_program_arrays_reused"] = n_reused
        design = CompiledDesign(
            step_specs=specs,
            tables=tables,
            programs=programs,
            in_quant=in_quant,
            in_shape=tuple(in_shape),
            out_shape=shape,
            out_qints=qints,
            device=dev,
            reports=reports,
            solver_stats=solver_stats,
            use_pallas=cfg.use_pallas,
            # the design keeps the config identity, not the live cache
            # handle (runtime-only; load_design cannot restore it)
            config=cfg.replace(cache=None),
        )
    if cfg.verify != "off":
        _verify_design_gate(design, cfg, slot_names)
    return design


def _verify_design_gate(design: CompiledDesign, cfg: CompileConfig, slot_names) -> None:
    """Run the static verifier on a freshly compiled design.

    Findings land in ``solver_stats["verify"]`` (overall + per-layer
    pass/fail and wall time, keyed by the same layer names as
    ``per_layer`` solve stats); error-severity findings raise
    ``DesignVerificationError`` — a design the verifier rejects must not
    be silently returned.
    """
    t0 = time.perf_counter()
    with trace.span("analysis.verify", tier=cfg.verify):
        vrep = verify_design(design, tier=cfg.verify, max_delay_per_stage=cfg.max_delay_per_stage)
    wall = time.perf_counter() - t0
    by_prog = vrep.pass_wall_s.get("program_by_index", {})
    per_layer = {}
    for idx, names in slot_names.items():
        n_err = sum(1 for d in vrep.errors if d.loc.get("program") == idx)
        for nm in names:
            per_layer[nm] = {"ok": n_err == 0, "n_errors": n_err, "wall_s": by_prog.get(idx, 0.0)}
    design.solver_stats["verify"] = {
        "tier": cfg.verify,
        "ok": vrep.ok,
        "n_errors": len(vrep.errors),
        "n_warnings": len(vrep.warnings),
        "wall_s": wall,
        "pass_wall_s": {k: v for k, v in vrep.pass_wall_s.items() if isinstance(v, float)},
        "per_layer": per_layer,
    }
    if not vrep.ok:
        raise DesignVerificationError(vrep, context="compiled design")


def _host(a) -> np.ndarray:
    """A parameter as a host numpy array (a tensor from any device)."""
    if isinstance(a, torch.Tensor):
        return a.detach().cpu().numpy()
    return np.asarray(a)


def _affine_out_qints(w_int: np.ndarray, qin: list[QInterval]) -> list[QInterval]:
    """Exact per-output intervals of y = x @ w_int.

    The adder graph computes each output exactly, so its value range is
    the affine-form interval — independent of how the solver structures
    the computation.  This is what lets the plan phase propagate qints
    through the network before any CMVM is solved."""
    out: list[QInterval] = []
    for jcol in range(w_int.shape[1]):
        q: QInterval | None = None
        col = w_int[:, jcol]
        for i in np.nonzero(col)[0]:
            term = qin[int(i)].scale(int(col[i]))
            q = term if q is None else q.add(term)
        out.append(QInterval(0, 0, 0) if q is None else q)
    return out


def _cmvm(name, w, b, wq: QuantConfig, qin: list[QInterval], ctx: _Ctx):
    """Plan one CMVM + bias. Returns ((table_idx, arrays), out_qints)
    for a cmvm-kind StepSpec; the solve itself is deferred to a
    _SolveSlot."""
    w_int = np.clip(
        np.round(np.asarray(w, np.float64) / wq.step), wq.qint.lo, wq.qint.hi
    ).astype(np.int64)
    we = wq.scale_exp()
    slot = ctx.request(w_int, list(qin))
    out_qints = [q.shift(we) for q in _affine_out_qints(w_int, qin)]

    b_int = None
    pre_shift = None
    if b is not None:
        # bias lives on the accumulator grid e_b = in_exp + w_exp; outputs
        # whose qint landed on a coarser grid are shifted down to the
        # common grid first (wiring, not logic).
        e_b = we + min(q.exp for q in qin)
        exps = _exps(out_qints, fallback=e_b)
        tgt = np.minimum(exps, e_b)
        pre_shift = (exps - tgt).astype(np.int64)
        b_int = np.floor(np.asarray(b, np.float64) / (2.0**tgt) + 0.5).astype(np.int64)
        out_qints = [
            QInterval((q.lo << int(s)) + int(bi), (q.hi << int(s)) + int(bi), int(t))
            if not q.is_zero
            else QInterval(min(int(bi), 0), max(int(bi), 0), int(t))
            for q, bi, s, t in zip(out_qints, b_int, pre_shift, tgt)
        ]

    n_bias = int(np.count_nonzero(b_int)) if b_int is not None else 0
    bias_bits = (
        sum(q.width for q, bi in zip(out_qints, b_int) if bi) if b_int is not None else 0
    )
    ctx.pending_reports.append(
        (slot, name, f"{w_int.shape[0]}x{w_int.shape[1]}", n_bias, bias_bits)
    )

    arrays: dict = {}
    if b_int is not None:
        arrays["bias"] = np.asarray(b_int, np.int64)
    if pre_shift is not None and pre_shift.any():
        arrays["shift"] = np.asarray(pre_shift, np.int64)
    return (slot.idx, arrays), out_qints


def _compile_seq(model, params, shape, qints, ctx):
    specs: list[StepSpec] = []
    for spec, p in zip(model, params):
        if isinstance(spec, QDense):
            s, shape, qints = _compile_dense_last(spec, p, shape, qints, ctx)
            specs.append(s)
            if spec.out_quant is not None:
                specs.append(_requant_spec(qints, spec.out_quant))
                qints = [_requant_qint(q, spec.out_quant) for q in qints]
        elif isinstance(spec, QDenseOnAxis):
            ax = spec.axis % len(shape)
            perm = [i for i in range(len(shape)) if i != ax] + [ax]
            inv = np.argsort(perm).tolist()
            pshape = tuple(shape[i] for i in perm)
            specs.append(StepSpec("transpose", params={"shape": list(shape), "perm": perm}))
            qints_t = _transpose_qints(qints, shape, perm)
            inner = QDense(spec.units, spec.w_quant, None, spec.use_bias)
            s, pshape2, qints_t = _compile_dense_last(inner, p, pshape, qints_t, ctx)
            specs.append(s)
            specs.append(StepSpec("transpose", params={"shape": list(pshape2), "perm": inv}))
            shape = tuple(pshape2[i] for i in inv)
            qints = _transpose_qints(qints_t, pshape2, inv)
            if spec.out_quant is not None:
                specs.append(_requant_spec(qints, spec.out_quant))
                qints = [_requant_qint(q, spec.out_quant) for q in qints]
        elif isinstance(spec, QConv2D):
            s, shape, qints = _compile_conv(spec, p, shape, qints, ctx)
            specs.append(s)
            if spec.out_quant is not None:
                specs.append(_requant_spec(qints, spec.out_quant))
                qints = [_requant_qint(q, spec.out_quant) for q in qints]
        elif isinstance(spec, ReLU):
            specs.append(StepSpec("relu"))
            qints = [_relu_qint(q) for q in qints]
            if spec.out_quant is not None:
                specs.append(_requant_spec(qints, spec.out_quant))
                qints = [_requant_qint(q, spec.out_quant) for q in qints]
        elif isinstance(spec, MaxPool2D):
            s, shape, qints = _compile_maxpool(spec, shape, qints)
            specs.append(s)
        elif isinstance(spec, AvgPool2D):
            s, shape, qints = _compile_avgpool(spec, shape, qints)
            specs.append(s)
        elif isinstance(spec, Flatten):
            shape = (int(np.prod(shape)),)
        elif isinstance(spec, Residual):
            body_specs, bshape, bq = _compile_seq(spec.body, p["body"], shape, qints, ctx)
            assert bshape == shape, "residual body must preserve shape"
            sa, sb, qints = _align_exps(qints, bq)
            specs.append(StepSpec("residual", arrays={"sa": sa, "sb": sb}, body=body_specs))
        else:
            raise TypeError(f"cannot compile {spec}")
    return specs, shape, qints


def _compile_dense_last(spec: QDense, p, shape, qints, ctx):
    d_in = shape[-1]
    lead = int(np.prod(shape[:-1]))
    # union input qints across leading positions (shared CMVM instance)
    qarr = np.array(qints, dtype=object).reshape(lead, d_in)
    qin = [_union_all(list(qarr[:, k])) for k in range(d_in)]
    b = _host(p["b"]) if spec.use_bias else None
    (table, arrays), out_q = _cmvm("dense", _host(p["w"]), b, spec.w_quant, qin, ctx)
    # "wscale" (the weight grid exponent) is verifier metadata, like the
    # requant "exp" param — the executor never reads it
    s = StepSpec(
        "dense",
        params={"d_in": d_in, "wscale": int(spec.w_quant.scale_exp())},
        arrays=arrays,
        table=table,
    )
    return s, shape[:-1] + (spec.units,), list(out_q) * lead


def _transpose_qints(qints, shape, perm):
    arr = np.array(qints, dtype=object).reshape(shape)
    return list(arr.transpose(perm).reshape(-1))


def _pool_spec(kind: str, h, w, c, ph, pw) -> StepSpec:
    return StepSpec(kind, params={"h": h, "w": w, "c": c, "ph": ph, "pw": pw})


def _compile_maxpool(spec: MaxPool2D, shape, qints):
    h, w, c = shape
    ph, pw = spec.size
    oh, ow = h // ph, w // pw

    qarr = np.array(qints, dtype=object).reshape(h, w, c)
    new = []
    for i in range(oh):
        for j in range(ow):
            for ch in range(c):
                block = [
                    qarr[i * ph + a, j * pw + bb, ch] for a in range(ph) for bb in range(pw)
                ]
                new.append(_union_all(block))
    return _pool_spec("maxpool", h, w, c, ph, pw), (oh, ow, c), new


def _compile_avgpool(spec: AvgPool2D, shape, qints):
    """Power-of-two window: avg == sum with exponent shift (exact)."""
    h, w, c = shape
    ph, pw = spec.size
    k = ph * pw
    assert k & (k - 1) == 0
    shift = int(np.log2(k))
    oh, ow = h // ph, w // pw

    qarr = np.array(qints, dtype=object).reshape(h, w, c)
    new = []
    for i in range(oh):
        for j in range(ow):
            for ch in range(c):
                q = None
                for a in range(ph):
                    for bb in range(pw):
                        qq = qarr[i * ph + a, j * pw + bb, ch]
                        q = qq if q is None else q.add(qq)
                new.append(q.shift(-shift))
    return _pool_spec("avgpool", h, w, c, ph, pw), (oh, ow, c), new


def _compile_conv(spec: QConv2D, p, shape, qints, ctx):
    """Conv2D via im2col + shared CMVM (kernel reused spatially)."""
    h, w, cin = shape
    kh, kw = spec.kernel
    sh, sw = spec.strides
    assert spec.padding == "VALID", "compile path supports VALID convs"
    oh = (h - kh) // sh + 1
    ow = (w - kw) // sw + 1

    qarr = np.array(qints, dtype=object).reshape(h, w, cin)
    patch_qints = []
    for dy in range(kh):
        for dx in range(kw):
            for ch in range(cin):
                qs = [qarr[i * sh + dy, j * sw + dx, ch] for i in range(oh) for j in range(ow)]
                patch_qints.append(_union_all(qs))

    wmat = _host(p["w"]).reshape(kh * kw * cin, spec.filters)
    b = _host(p["b"]) if spec.use_bias else None
    (table, arrays), out_q = _cmvm("conv", wmat, b, spec.w_quant, patch_qints, ctx)
    s = StepSpec(
        "conv",
        params={
            "h": h, "w": w, "cin": cin, "kh": kh, "kw": kw,
            "sh": sh, "sw": sw, "oh": oh, "ow": ow,
            "wscale": int(spec.w_quant.scale_exp()),
        },
        arrays=arrays,
        table=table,
    )
    return s, (oh, ow, spec.filters), list(out_q) * (oh * ow)
