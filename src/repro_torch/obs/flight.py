"""Per-shard flight recorder: bounded request ring + slowest-K pinning.

Each serve dispatcher shard owns one :class:`FlightRecorder` and is its
only writer, so the record path is lock-free (ring store + a bounded
min-heap update).  A record carries everything needed to explain one
request postmortem: trace id, shard, bucket, batch size, end-to-end
latency, and the per-stage µs breakdown
(queue_wait / batch_form / pad / dispatch / copy_out).

Tail sampling: besides the ring (which wraps and forgets), the recorder
pins the slowest-K requests *ever seen* so "why was that one request
8 ms" is answerable long after the ring has rolled over.  Shard
recorders merge in ``_ModelRunner.stats()`` via :meth:`merged`.

Besides per-request records, a recorder keeps a small bounded **event
ring** (:meth:`record_event`) for rare lifecycle transitions — circuit
breaker trips/recoveries, shard crashes and restarts, model-unhealthy
escalation — so a postmortem can line the slow requests up against what
the resilience machinery was doing at the time.  Events may be recorded
from any thread (``deque.append`` is atomic).
"""

from __future__ import annotations

import heapq
import itertools
from collections import deque
from collections.abc import Iterable, Sequence

__all__ = ["STAGES", "FlightRecorder"]

STAGES = ("queue_wait", "batch_form", "pad", "dispatch", "copy_out")

# tie-breaker for equal-latency heap entries (records aren't orderable)
_SEQ = itertools.count()


class FlightRecorder:
    """Bounded ring of per-request records plus a slowest-K tail sample."""

    __slots__ = ("capacity", "slow_k", "_ring", "_n", "_slow", "_events", "_n_events")

    def __init__(
        self, capacity: int = 2048, slow_k: int = 16, event_capacity: int = 256
    ) -> None:
        if capacity < 1:
            raise ValueError("flight recorder capacity must be >= 1")
        self.capacity = int(capacity)
        self.slow_k = int(slow_k)
        self._ring: list = [None] * self.capacity
        self._n = 0  # total records ever; ring index is n % capacity
        self._slow: list = []  # min-heap of (lat_us, seq, record)
        self._events: deque = deque(maxlen=max(1, int(event_capacity)))
        self._n_events = 0

    def record(
        self,
        trace_id: int,
        shard: int,
        bucket: int,
        batch_size: int,
        lat_us: float,
        stages_us: Sequence[float],
        ts_us: float = 0.0,
    ) -> None:
        """Store one request record.  ``stages_us`` aligns with STAGES."""
        rec = (trace_id, shard, bucket, batch_size, lat_us, tuple(stages_us), ts_us)
        self._ring[self._n % self.capacity] = rec
        self._n += 1
        if self.slow_k > 0:
            if len(self._slow) < self.slow_k:
                heapq.heappush(self._slow, (lat_us, next(_SEQ), rec))
            elif lat_us > self._slow[0][0]:
                heapq.heapreplace(self._slow, (lat_us, next(_SEQ), rec))

    def record_event(self, kind: str, ts_us: float = 0.0, **fields) -> None:
        """Store one lifecycle event (breaker transition, shard restart,
        ...).  Bounded: the oldest events fall off; ``n_events`` keeps
        the true total.  Safe to call from any thread."""
        self._events.append({"kind": kind, "ts_us": ts_us, **fields})
        self._n_events += 1

    def events(self) -> list[dict]:
        """Retained lifecycle events, oldest first."""
        return list(self._events)

    @staticmethod
    def _as_dict(rec: tuple) -> dict:
        trace_id, shard, bucket, batch_size, lat_us, stages, ts_us = rec
        return {
            "trace_id": trace_id,
            "shard": shard,
            "bucket": bucket,
            "batch_size": batch_size,
            "lat_us": lat_us,
            "ts_us": ts_us,
            "stages_us": dict(zip(STAGES, stages)),
        }

    def recent(self, n: int | None = None) -> list[dict]:
        """Most-recent retained records, newest last."""
        held = min(self._n, self.capacity)
        take = held if n is None else min(n, held)
        out = []
        for i in range(self._n - take, self._n):
            out.append(self._as_dict(self._ring[i % self.capacity]))
        return out

    def slowest(self) -> list[dict]:
        """Pinned slowest-K records, slowest first."""
        return [self._as_dict(rec) for _, _, rec in sorted(self._slow, reverse=True)]

    def snapshot(self) -> dict:
        return {
            "n_records": self._n,
            "capacity": self.capacity,
            "n_evicted": max(0, self._n - self.capacity),
            "slowest": self.slowest(),
            "n_events": self._n_events,
            "events": self.events(),
        }

    @staticmethod
    def merged(recorders: Iterable["FlightRecorder"], slow_k: int | None = None) -> dict:
        """Cross-shard snapshot: summed counts, overall slowest-K,
        time-ordered events."""
        recs = list(recorders)
        k = slow_k if slow_k is not None else max((r.slow_k for r in recs), default=0)
        slowest: list[dict] = []
        events: list[dict] = []
        for r in recs:
            slowest.extend(r.slowest())
            events.extend(r.events())
        slowest.sort(key=lambda d: d["lat_us"], reverse=True)
        events.sort(key=lambda d: d["ts_us"])
        return {
            "n_records": sum(r._n for r in recs),
            "capacity": sum(r.capacity for r in recs),
            "n_evicted": sum(max(0, r._n - r.capacity) for r in recs),
            "slowest": slowest[:k],
            "n_events": sum(r._n_events for r in recs),
            "events": events,
        }
