"""Circuit breaker for the serve dispatch path.

One :class:`CircuitBreaker` per registered model (shared across its
dispatch shards) tracks consecutive dispatch failures and cuts the
failing path off instead of letting it take every batch down:

    closed ──(threshold consecutive failures)──> open
    open ──(cooldown expires)──> half_open (admits ONE probe batch)
    half_open ──probe ok──> closed              (cooldown resets)
    half_open ──probe fails──> open             (cooldown doubles, capped)

While open, the dispatcher fails batches fast with ``CircuitOpenError``.
The breaker is touched once per batch and its lock protects only a few
scalar fields.
"""

from __future__ import annotations

import threading
import time
from collections.abc import Callable

__all__ = ["CircuitBreaker"]


class CircuitBreaker:
    """Closed / open / half-open breaker with capped exponential backoff."""

    def __init__(
        self,
        threshold: int = 8,
        cooldown_s: float = 0.25,
        cooldown_max_s: float = 8.0,
        clock: Callable[[], float] = time.monotonic,
    ) -> None:
        if threshold < 1:
            raise ValueError("breaker threshold must be >= 1")
        if cooldown_s <= 0 or cooldown_max_s < cooldown_s:
            raise ValueError("need 0 < cooldown_s <= cooldown_max_s")
        self.threshold = int(threshold)
        self.cooldown_base_s = float(cooldown_s)
        self.cooldown_max_s = float(cooldown_max_s)
        self._clock = clock
        self._lock = threading.Lock()
        self._state = "closed"
        self._failures = 0  # consecutive, while closed
        self._cooldown_s = self.cooldown_base_s
        self._open_until = 0.0
        self._probing = False  # half-open admits one probe at a time
        self.n_trips = 0
        self.n_reopens = 0
        self.n_recoveries = 0

    # -- dispatch-side API ---------------------------------------------
    def route(self) -> str:
        """Route one batch: "run" (closed), "probe" (half-open trial —
        caller MUST follow up with ``record(..., probe=True)``), or
        "reject" (open / a probe is already in flight)."""
        with self._lock:
            if self._state == "closed":
                return "run"
            if self._state == "open":
                if self._clock() >= self._open_until:
                    self._state = "half_open"
                    self._probing = True
                    return "probe"
                return "reject"
            # half_open
            if self._probing:
                return "reject"
            self._probing = True
            return "probe"

    def record(self, ok: bool, probe: bool = False) -> None:
        """Record one dispatch outcome (``probe=True`` iff ``route()``
        said "probe" for this batch)."""
        with self._lock:
            if probe:
                self._probing = False
                if self._state == "half_open":
                    if ok:
                        self._state = "closed"
                        self._failures = 0
                        self._cooldown_s = self.cooldown_base_s
                        self.n_recoveries += 1
                    else:
                        self._cooldown_s = min(
                            self._cooldown_s * 2.0, self.cooldown_max_s
                        )
                        self._state = "open"
                        self._open_until = self._clock() + self._cooldown_s
                        self.n_reopens += 1
            elif self._state == "closed":
                if ok:
                    self._failures = 0
                else:
                    self._failures += 1
                    if self._failures >= self.threshold:
                        self._state = "open"
                        self._open_until = self._clock() + self._cooldown_s
                        self.n_trips += 1
            # outcomes of batches routed before a trip land while open:
            # they carry no new information, drop them

    # -- introspection --------------------------------------------------
    def _snapshot_locked(self) -> dict:
        return {
            "state": self._state,
            "consecutive_failures": self._failures,
            "threshold": self.threshold,
            "cooldown_s": self._cooldown_s,
            "open_remaining_s": (
                max(0.0, self._open_until - self._clock())
                if self._state == "open"
                else 0.0
            ),
            "n_trips": self.n_trips,
            "n_reopens": self.n_reopens,
            "n_recoveries": self.n_recoveries,
        }

    def snapshot(self) -> dict:
        with self._lock:
            return self._snapshot_locked()

    @property
    def state(self) -> str:
        with self._lock:
            return self._state
