"""Deterministic fault injection for the serve and artifact paths.

A copy of the JAX package's ``chaos.plan`` (stdlib only), so the port
imports nothing of that package: the same sites, modes, rules and
seeded per-site schedules, so one plan fires the same sequence in
either package.

The resilience machinery in ``repro_torch.runtime`` (circuit breaker, shard
supervision, deadline shedding, crash-safe artifact commit) is only
trustworthy if every failure mode it claims to handle can be *provoked*
on demand.  This module provides that provocation: a seeded
:class:`FaultPlan` that fires scripted faults at named **sites** woven
through the runtime.

Design constraints (mirrors ``repro_torch.obs.trace``):

* **Zero-cost when disabled.**  Call sites invoke the module-level
  :func:`fault_point`.  With no plan installed this is one global read
  and a ``None`` comparison — no allocation, no lock, no clock read.

* **Deterministic and replayable.**  A plan is a list of
  :class:`FaultRule` plus a seed.  Rules can fire on explicit hit
  indices (``at=(0, 3, 7)``) for exact counter assertions, or at a
  probability (``rate=0.2``) drawn from a per-site ``random.Random``
  seeded from ``(seed, site)`` — so the same plan replays the same
  fault schedule regardless of thread interleaving *per site*.

* **Env-driven.**  ``REPRO_CHAOS`` may carry a JSON plan spec (see
  :func:`plan_from_spec`) so chaos runs need no code changes — same
  shape as ``REPRO_TRACE=1`` for tracing.

Fault sites (the registry, the JAX package's, described in
``docs/robustness.md``):

================================  =============================================
site                              effect at the call site
================================  =============================================
``serve.dispatch``                device dispatch: ``raise`` / ``delay`` / ``hang``
``serve.gather``                  slab gather before dispatch: ``raise``
``serve.dispatcher``              dispatcher loop top: ``kill_thread`` (escapes
                                  the ``except Exception`` guard), ``delay``
``artifact.save.arrays``          npz write: ``raise`` (crash before any commit)
``artifact.save.truncate``        npz tmp file: ``truncate`` (torn write)
``artifact.save.commit``          between npz replace and manifest write:
                                  ``raise`` (crash inside the commit window)
``artifact.load.read``            manifest/npz read: ``raise``
================================  =============================================

Modes: ``raise`` (FaultInjectedError), ``delay`` (sleep ``delay_s``),
``hang`` (sleep ``delay_s``, default 30s — long enough to trip deadlines
and heartbeats, short enough to not wedge a test run), ``kill_thread``
(raise :class:`ThreadKillFault`, a ``BaseException`` that escapes
``except Exception`` guards), ``truncate`` (chop a file in half — only
meaningful at ``io_fault`` sites).
"""

from __future__ import annotations

import json
import os
import threading
import time
import zlib
from collections.abc import Iterator
from contextlib import contextmanager
from dataclasses import dataclass, field
from random import Random

__all__ = [
    "FaultInjectedError",
    "ThreadKillFault",
    "FaultRule",
    "FaultPlan",
    "SITES",
    "MODES",
    "fault_point",
    "io_fault",
    "get_plan",
    "set_plan",
    "active",
    "plan_from_spec",
]

SITES: tuple[str, ...] = (
    "serve.dispatch",
    "serve.gather",
    "serve.dispatcher",
    "artifact.save.arrays",
    "artifact.save.truncate",
    "artifact.save.commit",
    "artifact.load.read",
)

MODES: tuple[str, ...] = ("raise", "delay", "hang", "kill_thread", "truncate")

_HANG_S = 30.0  # "hang" sleeps this long: past any deadline, short of a wedge


class FaultInjectedError(RuntimeError):
    """An injected fault fired at a chaos site (``raise`` mode)."""

    def __init__(self, site: str, hit: int) -> None:
        super().__init__(f"injected fault at {site!r} (hit #{hit})")
        self.site = site
        self.hit = hit


class ThreadKillFault(BaseException):
    """Injected dispatcher-thread death.

    Deliberately a ``BaseException`` subclass so it sails past the
    ``except Exception`` guard around batch execution and kills the
    dispatcher thread itself — the scenario shard supervision exists
    to handle.
    """

    def __init__(self, site: str, hit: int) -> None:
        super().__init__(f"injected thread kill at {site!r} (hit #{hit})")
        self.site = site
        self.hit = hit


@dataclass(frozen=True)
class FaultRule:
    """One scripted fault: *where*, *how*, and *when* to fire.

    Exactly one trigger style per rule:

    * ``at``: explicit zero-based hit indices at the site — fully
      deterministic, for exact counter assertions.
    * ``rate``: independent per-hit probability from the plan's seeded
      per-site RNG — deterministic for a fixed (seed, site, hit order).

    ``after`` skips the first N hits before either trigger applies, and
    ``max_fires`` caps total firings (0 = unlimited) so a breaker can
    observe *recovery* after a burst of failures.
    """

    site: str
    mode: str = "raise"
    rate: float = 0.0
    at: tuple[int, ...] = ()
    after: int = 0
    max_fires: int = 0
    delay_s: float = 0.0

    def __post_init__(self) -> None:
        if self.site not in SITES:
            raise ValueError(f"unknown fault site {self.site!r}; known: {SITES}")
        if self.mode not in MODES:
            raise ValueError(f"unknown fault mode {self.mode!r}; known: {MODES}")
        if not 0.0 <= self.rate <= 1.0:
            raise ValueError(f"rate must be in [0, 1], got {self.rate}")
        if self.rate > 0.0 and self.at:
            raise ValueError("give either rate or at, not both")
        object.__setattr__(self, "at", tuple(int(i) for i in self.at))

    def to_dict(self) -> dict:
        return {
            "site": self.site,
            "mode": self.mode,
            "rate": self.rate,
            "at": list(self.at),
            "after": self.after,
            "max_fires": self.max_fires,
            "delay_s": self.delay_s,
        }


@dataclass
class _SiteState:
    """Mutable per-site bookkeeping: hit counter, RNG, fire counts."""

    rng: Random
    hits: int = 0
    fires: dict[int, int] = field(default_factory=dict)  # rule index -> count


class FaultPlan:
    """A seeded, replayable schedule of faults across named sites.

    Thread-safe: the serve path hits sites from many dispatcher threads;
    one plan lock serialises counter updates (the lock is only ever
    taken while a plan is installed, so the disabled path stays free).
    """

    def __init__(self, rules: list[FaultRule] | tuple[FaultRule, ...] = (), seed: int = 0) -> None:
        self.rules: tuple[FaultRule, ...] = tuple(rules)
        self.seed = int(seed)
        self._lock = threading.Lock()
        self._sites: dict[str, _SiteState] = {}
        self._by_site: dict[str, list[tuple[int, FaultRule]]] = {}
        for i, r in enumerate(self.rules):
            self._by_site.setdefault(r.site, []).append((i, r))

    def _state(self, site: str) -> _SiteState:
        st = self._sites.get(site)
        if st is None:
            # per-site RNG keyed on (seed, site): per-site schedules are
            # independent of how other sites interleave
            st = _SiteState(rng=Random((self.seed << 32) ^ zlib.crc32(site.encode())))
            self._sites[site] = st
        return st

    def check(self, site: str) -> tuple[str, int, float] | None:
        """Advance the site's hit counter; return (mode, hit, delay_s) if a rule fires."""
        rules = self._by_site.get(site)
        if not rules:
            return None
        with self._lock:
            st = self._state(site)
            hit = st.hits
            st.hits += 1
            for idx, r in rules:
                if hit < r.after:
                    continue
                n_fired = st.fires.get(idx, 0)
                if r.max_fires and n_fired >= r.max_fires:
                    continue
                if r.at:
                    fire = hit in r.at
                elif r.rate > 0.0:
                    fire = st.rng.random() < r.rate
                else:
                    fire = False
                if fire:
                    st.fires[idx] = n_fired + 1
                    return (r.mode, hit, r.delay_s)
        return None

    def stats(self) -> dict:
        """Hit and fire counts per site — for test assertions and bench JSON."""
        with self._lock:
            out: dict = {"seed": self.seed, "sites": {}}
            for site, st in sorted(self._sites.items()):
                out["sites"][site] = {
                    "hits": st.hits,
                    "fires": sum(st.fires.values()),
                }
            return out

    def reset(self) -> None:
        """Clear all counters and re-seed site RNGs (exact replay)."""
        with self._lock:
            self._sites.clear()

    def to_dict(self) -> dict:
        return {"seed": self.seed, "rules": [r.to_dict() for r in self.rules]}


# ---------------------------------------------------------------------------
# module-level activation (the zero-cost gate)

_PLAN: FaultPlan | None = None


def get_plan() -> FaultPlan | None:
    """The currently installed plan, or None when injection is off."""
    return _PLAN


def set_plan(plan: FaultPlan | None) -> None:
    """Install (or clear, with None) the process-wide fault plan."""
    global _PLAN
    _PLAN = plan


@contextmanager
def active(plan: FaultPlan) -> Iterator[FaultPlan]:
    """Install *plan* for the ``with`` body, restoring the previous plan after."""
    prev = _PLAN
    set_plan(plan)
    try:
        yield plan
    finally:
        set_plan(prev)


def fault_point(site: str) -> None:
    """Maybe fire an injected fault at *site*.

    The disabled path (no plan installed) is a single global read — this
    is the line woven into serve hot paths, so it must stay that cheap.
    """
    plan = _PLAN
    if plan is None:
        return
    fired = plan.check(site)
    if fired is None:
        return
    mode, hit, delay_s = fired
    if mode == "raise":
        raise FaultInjectedError(site, hit)
    if mode == "delay":
        time.sleep(delay_s)
        return
    if mode == "hang":
        time.sleep(delay_s if delay_s > 0.0 else _HANG_S)
        return
    if mode == "kill_thread":
        raise ThreadKillFault(site, hit)
    # "truncate" only makes sense at io_fault sites; at a plain
    # fault_point it degrades to a raise so misconfigurations are loud
    raise FaultInjectedError(site, hit)


def io_fault(site: str, path: str) -> None:
    """Maybe corrupt the file at *path* (torn/truncated write) or raise.

    ``truncate`` mode chops the file to half its size in place —
    simulating a crash mid-write that left a torn artifact on disk.
    Other modes behave as in :func:`fault_point`.
    """
    plan = _PLAN
    if plan is None:
        return
    fired = plan.check(site)
    if fired is None:
        return
    mode, hit, delay_s = fired
    if mode == "truncate":
        size = os.path.getsize(path)
        with open(path, "r+b") as fh:
            fh.truncate(size // 2)
        return
    if mode == "raise":
        raise FaultInjectedError(site, hit)
    if mode in ("delay", "hang"):
        time.sleep(delay_s if delay_s > 0.0 else _HANG_S if mode == "hang" else 0.0)
        return
    raise FaultInjectedError(site, hit)


def plan_from_spec(spec: str | dict) -> FaultPlan:
    """Build a plan from a JSON string or dict.

    Spec shape (also accepted via the ``REPRO_CHAOS`` env var)::

        {"seed": 7, "rules": [
            {"site": "serve.dispatch", "mode": "raise", "rate": 0.1},
            {"site": "artifact.save.truncate", "mode": "truncate", "at": [0]}
        ]}
    """
    doc = json.loads(spec) if isinstance(spec, str) else spec
    rules = [
        FaultRule(
            site=r["site"],
            mode=r.get("mode", "raise"),
            rate=float(r.get("rate", 0.0)),
            at=tuple(r.get("at", ())),
            after=int(r.get("after", 0)),
            max_fires=int(r.get("max_fires", 0)),
            delay_s=float(r.get("delay_s", 0.0)),
        )
        for r in doc.get("rules", ())
    ]
    return FaultPlan(rules, seed=int(doc.get("seed", 0)))


_env_spec = os.environ.get("REPRO_CHAOS", "").strip()
if _env_spec and _env_spec not in ("0", "false", "off"):
    set_plan(plan_from_spec(_env_spec))
