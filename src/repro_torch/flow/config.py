"""Typed configuration objects, one frozen dataclass per pipeline stage.

    SolverConfig    options of one CMVM solve
    CompileConfig   options of one model compile, nesting a SolverConfig
    ServeConfig     options of one serving deployment

A copy of the JAX package's ``repro.flow.config``: the same fields,
validation, ``to_dict``/``from_dict`` and ``digest()``.  Digests are a
sha256 over a versioned canonical JSON form that names the class, so a
config digested here equals the same config digested by the JAX package
and design-artifact manifests interchange between the two packages.

Runtime-only fields that cannot affect the produced design -- the live
``cache`` handle and the ``jobs`` parallelism of ``CompileConfig`` --
are excluded from ``to_dict``/``digest`` (``jobs`` is serialized but not
digested; ``cache`` is neither).
"""

from __future__ import annotations

import dataclasses
import hashlib
import json
from dataclasses import dataclass, field
from typing import Any, ClassVar

_DIGEST_VERSION = "da4ml-flow-config-v1"


class ConfigError(ValueError):
    """Invalid configuration value."""


@dataclass(frozen=True)
class _ConfigBase:
    # subclass knobs (ClassVar: not dataclass fields)
    _RUNTIME_ONLY: ClassVar[tuple] = ()  # excluded from to_dict AND digest
    _DIGEST_EXCLUDE: ClassVar[tuple] = ()  # in to_dict but excluded from digest
    _NESTED: ClassVar[dict] = {}  # field name -> nested config class

    def to_dict(self) -> dict:
        """Plain JSON-serializable dict (drops runtime-only fields)."""
        out: dict = {}
        for f in dataclasses.fields(self):
            if f.name in self._RUNTIME_ONLY:
                continue
            v = getattr(self, f.name)
            if isinstance(v, _ConfigBase):
                v = v.to_dict()
            elif isinstance(v, tuple):
                v = list(v)
            out[f.name] = v
        return out

    @classmethod
    def from_dict(cls, d: dict) -> "_ConfigBase":
        """Inverse of :meth:`to_dict`; rejects unknown keys."""
        if not isinstance(d, dict):
            raise ConfigError(f"{cls.__name__}.from_dict expects a dict, got {type(d).__name__}")
        names = {f.name for f in dataclasses.fields(cls)} - set(cls._RUNTIME_ONLY)
        unknown = set(d) - names
        if unknown:
            raise ConfigError(f"{cls.__name__}: unknown config keys {sorted(unknown)}")
        kw = dict(d)
        for name, sub in cls._NESTED.items():
            if name in kw and isinstance(kw[name], dict):
                kw[name] = sub.from_dict(kw[name])
        return cls(**kw)

    def digest(self) -> str:
        """sha256 content digest of the config identity (stable across
        processes; changes iff a digested field changes)."""
        d = self.to_dict()
        for name in self._DIGEST_EXCLUDE:
            d.pop(name, None)
        payload = json.dumps(
            [_DIGEST_VERSION, type(self).__name__, d], sort_keys=True, separators=(",", ":")
        )
        return hashlib.sha256(payload.encode()).hexdigest()

    def replace(self, **changes: Any) -> "_ConfigBase":
        """Functional update (configs are frozen)."""
        return dataclasses.replace(self, **changes)

    def _require(self, cond: bool, msg: str) -> None:
        if not cond:
            raise ConfigError(f"{type(self).__name__}: {msg}")


@dataclass(frozen=True)
class SolverConfig(_ConfigBase):
    """Options of one CMVM solve (``y = x @ M`` -> DAIS adder graph).

    dc            delay constraint: extra adder-depth levels allowed
                  beyond each output's minimum (-1 = unconstrained).
    engine        CSE frequency engine: "batch" (vectorized, default),
                  "arena" (preallocated-workspace fast path), or "heap"
                  (exact lazy max-heap reference); all bit-identical.
                  The engine is part of the config digest, so solution-
                  cache keys and artifact manifests distinguish engines.
    decompose     enable stage-1 graph decomposition (M = M1 @ M2).
    weighted      weight CSE pair scores by operand width.
    dedup         deduplicate identical terms during assembly.
    depth_weight  depth penalty mixed into the CSE score (0 = off).
    """

    dc: int = -1
    engine: str = "batch"
    decompose: bool = True
    weighted: bool = True
    dedup: bool = True
    depth_weight: float = 0.0

    def __post_init__(self) -> None:
        self._require(isinstance(self.dc, int) and self.dc >= -1, f"dc must be >= -1, got {self.dc}")
        self._require(
            self.engine in ("batch", "heap", "arena"),
            f"unknown CSE engine {self.engine!r} "
            "(expected 'batch', 'heap', or 'arena')",
        )
        self._require(
            isinstance(self.depth_weight, (int, float)) and self.depth_weight >= 0.0,
            f"depth_weight must be >= 0, got {self.depth_weight}",
        )


def _default_compile_solver() -> SolverConfig:
    # compile_model's historical default is dc=2 (vs the solver-level
    # default dc=-1 used for the paper's unconstrained tables)
    return SolverConfig(dc=2)


@dataclass(frozen=True)
class CompileConfig(_ConfigBase):
    """Options of one model compile (the JAX package's ``compile_model``).

    strategy             "da" (CMVM solver) or "latency" (per-output CSD
                         trees, the hls4ml latency-strategy baseline).
    max_delay_per_stage  pipelining budget per register stage.
    use_pallas           the JAX package's kernel switch, kept so that
                         manifests and digests interchange; in the port
                         it selects nothing (a CUDA tensor always takes
                         the hand-written kernel).
    jobs                 solver thread-pool width (None = cpu_count,
                         1 = in-line serial); never changes the bits —
                         serial fallbacks are recorded loudly in
                         ``solver_stats["pool_fallback"]``.
    cache                optional live ``SolutionCache`` handle; runtime
                         only — excluded from to_dict/digest.
    solver               nested :class:`SolverConfig` (default dc=2).
    verify               static-verification tier run on every compiled
                         design ("off", "cheap", "strict"; default
                         "cheap" — the JAX package's static
                         verifier, not yet ported).  Error-severity
                         findings fail the compile loudly.  Never changes
                         the produced bits, so it is excluded from the
                         config digest (like ``jobs``).
    """

    _RUNTIME_ONLY: ClassVar[tuple] = ("cache",)
    _DIGEST_EXCLUDE: ClassVar[tuple] = ("jobs", "verify")
    _NESTED: ClassVar[dict] = {"solver": SolverConfig}

    strategy: str = "da"
    max_delay_per_stage: int = 5
    use_pallas: bool = False
    jobs: int | None = None
    cache: Any | None = None
    solver: SolverConfig = field(default_factory=_default_compile_solver)
    verify: str = "cheap"

    def __post_init__(self) -> None:
        self._require(
            self.strategy in ("da", "latency"),
            f"unknown strategy {self.strategy!r} (expected 'da' or 'latency')",
        )
        self._require(
            isinstance(self.max_delay_per_stage, int) and self.max_delay_per_stage >= 1,
            f"max_delay_per_stage must be >= 1, got {self.max_delay_per_stage}",
        )
        self._require(
            self.jobs is None or (isinstance(self.jobs, int) and self.jobs >= 1),
            f"jobs must be None or >= 1, got {self.jobs}",
        )
        self._require(
            isinstance(self.solver, SolverConfig),
            f"solver must be a SolverConfig, got {type(self.solver).__name__}",
        )
        self._require(
            self.cache is None or (hasattr(self.cache, "get") and hasattr(self.cache, "put")),
            "cache must be None or a SolutionCache-like object with get/put",
        )
        self._require(
            self.verify in ("off", "cheap", "strict"),
            f"unknown verify tier {self.verify!r} "
            "(expected 'off', 'cheap', or 'strict')",
        )


@dataclass(frozen=True)
class ServeConfig(_ConfigBase):
    """Options of one serving deployment (microbatched engine).

    max_batch     largest microbatch (and largest batch-shape bucket).
    max_wait_us   batching window after the first queued request.
    queue_depth   bounded per-model request queue (backpressure limit;
                  divided across shards).
    backpressure  "block" (submit waits for queue space) or "reject"
                  (submit raises / fails the future with QueueFullError).
    buckets       explicit batch-shape buckets (None: powers of two up
                  to max_batch); the largest bucket must cover max_batch.
    shards        dispatch shards per model: each shard is one request
                  queue + payload slab + dispatcher thread behind the
                  shared submit path (1 = the single-dispatcher engine).

    Resilience knobs:

    deadline_ms   default per-request deadline: requests not dispatched
                  within this budget are *shed* — failed with
                  DeadlineExceededError instead of executed (None: no
                  default; per-call ``deadline_s`` always wins).
    fallback      degraded mode while the circuit breaker is open:
                  "none" fails fast with CircuitOpenError; "interpreter"
                  (the JAX package's numpy StepSpec interpreter) is
                  accepted here so configs interchange, but the port's
                  ServeEngine refuses it until the interpreter is ported.
    breaker_threshold      consecutive dispatch failures that trip the
                  per-model breaker (closed -> open).
    breaker_cooldown_ms    initial open-state cooldown before a single
                  half-open probe; doubles on every failed probe.
    breaker_cooldown_max_ms  cap on the exponential cooldown backoff.
    supervise     run a per-model supervisor thread that detects dead
                  dispatcher threads and restarts them.
    restart_budget  dispatcher restarts allowed per shard before the
                  model is escalated to unhealthy (submits then fail
                  with ModelUnhealthyError).
    """

    max_batch: int = 256
    max_wait_us: float = 200.0
    queue_depth: int = 8192
    backpressure: str = "block"
    buckets: tuple | None = None
    shards: int = 1
    deadline_ms: float | None = None
    fallback: str = "none"
    breaker_threshold: int = 8
    breaker_cooldown_ms: float = 250.0
    breaker_cooldown_max_ms: float = 8000.0
    supervise: bool = True
    restart_budget: int = 2

    def __post_init__(self) -> None:
        self._require(
            isinstance(self.max_batch, int) and self.max_batch >= 1,
            f"max_batch must be >= 1, got {self.max_batch}",
        )
        self._require(
            isinstance(self.max_wait_us, (int, float)) and self.max_wait_us >= 0,
            f"max_wait_us must be >= 0, got {self.max_wait_us}",
        )
        self._require(
            isinstance(self.queue_depth, int) and self.queue_depth >= 1,
            f"queue_depth must be >= 1, got {self.queue_depth}",
        )
        self._require(
            self.backpressure in ("block", "reject"),
            f"backpressure must be 'block' or 'reject', got {self.backpressure!r}",
        )
        self._require(
            isinstance(self.shards, int) and self.shards >= 1,
            f"shards must be >= 1, got {self.shards}",
        )
        self._require(
            self.deadline_ms is None
            or (isinstance(self.deadline_ms, (int, float)) and self.deadline_ms > 0),
            f"deadline_ms must be None or > 0, got {self.deadline_ms}",
        )
        self._require(
            self.fallback in ("none", "interpreter"),
            f"fallback must be 'none' or 'interpreter', got {self.fallback!r}",
        )
        self._require(
            isinstance(self.breaker_threshold, int) and self.breaker_threshold >= 1,
            f"breaker_threshold must be >= 1, got {self.breaker_threshold}",
        )
        self._require(
            isinstance(self.breaker_cooldown_ms, (int, float))
            and self.breaker_cooldown_ms > 0,
            f"breaker_cooldown_ms must be > 0, got {self.breaker_cooldown_ms}",
        )
        self._require(
            isinstance(self.breaker_cooldown_max_ms, (int, float))
            and self.breaker_cooldown_max_ms >= self.breaker_cooldown_ms,
            "breaker_cooldown_max_ms must be >= breaker_cooldown_ms, got "
            f"{self.breaker_cooldown_max_ms}",
        )
        self._require(
            isinstance(self.supervise, bool),
            f"supervise must be a bool, got {self.supervise!r}",
        )
        self._require(
            isinstance(self.restart_budget, int) and self.restart_budget >= 0,
            f"restart_budget must be >= 0, got {self.restart_budget}",
        )
        if self.buckets is not None:
            buckets = tuple(sorted(int(b) for b in self.buckets))
            self._require(
                len(buckets) > 0 and all(b >= 1 for b in buckets),
                f"buckets must be positive ints, got {self.buckets!r}",
            )
            self._require(
                buckets[-1] >= self.max_batch,
                f"largest bucket ({buckets[-1]}) must cover max_batch ({self.max_batch})",
            )
            object.__setattr__(self, "buckets", buckets)
