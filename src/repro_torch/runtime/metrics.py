"""Latency / throughput / per-stage accounting for the serving engine.

A copy of the JAX package's ``repro.runtime.metrics`` (stdlib only).

``LatencyRecorder`` keeps raw per-request latencies (seconds, submit ->
result) up to a cap, then reservoir-samples; ``snapshot`` reduces them
to p50/p95/p99/mean/max in milliseconds plus the completed-request rate.
The sharded engine keeps one recorder per dispatcher shard (one writer
each) and merges them with :meth:`LatencyRecorder.merged_snapshot`.

``StageAccumulator`` charges each dispatched batch's wall seconds to the
five serving stages

    queue_wait   submit -> dequeue, summed per request
    batch_form   batching window after the first request of the batch
    pad          slab gather + zero-pad into the pinned bucket buffer
    dispatch     host-to-device copy, forward_int on the device,
                 device-to-host copy, stream synchronise
    copy_out     future resolution + latency recording
"""

from __future__ import annotations

import random
import time
from collections.abc import Iterable, Sequence


def percentile(values: Sequence[float], q: float) -> float:
    """Nearest-rank percentile (q in [0, 100]) of unsorted values."""
    if not values:
        return float("nan")
    s = sorted(values)
    k = max(0, min(len(s) - 1, int(round(q / 100.0 * (len(s) - 1)))))
    return s[k]


def _reduce(lat: list, n_total: int, t_first: float | None,
            t_last: float | None) -> dict:
    span = (
        (t_last - t_first)
        if (t_first is not None and t_last is not None)
        else 0.0
    )
    return {
        "n_requests": n_total,
        "n_latency_samples": len(lat),
        "n_sampled_out": max(0, n_total - len(lat)),
        "window_s": span,
        "throughput_rps": (n_total / span) if span > 0 else 0.0,
        "p50_ms": percentile(lat, 50) * 1e3 if lat else float("nan"),
        "p95_ms": percentile(lat, 95) * 1e3 if lat else float("nan"),
        "p99_ms": percentile(lat, 99) * 1e3 if lat else float("nan"),
        "mean_ms": (sum(lat) / len(lat) * 1e3) if lat else float("nan"),
        "max_ms": max(lat) * 1e3 if lat else float("nan"),
    }


class LatencyRecorder:
    """Bounded per-request latency log with throughput bookkeeping.

    Beyond ``max_samples`` the recorder switches to reservoir sampling
    (Algorithm R, deterministic seed) so long soaks keep a uniform
    sample over the *whole* window instead of freezing percentiles on
    the first ``max_samples`` requests; ``n_sampled_out`` in snapshots
    counts observations not currently held in the reservoir.
    """

    def __init__(self, max_samples: int = 500_000, seed: int = 0):
        self.max_samples = max_samples
        self.seed = seed
        self._rng = random.Random(seed)
        self._lat: list[float] = []
        self.n_total = 0
        self.t_first: float | None = None
        self.t_last: float | None = None

    @property
    def n_sampled_out(self) -> int:
        """Observations seen but not currently held in the reservoir."""
        return max(0, self.n_total - len(self._lat))

    def record(self, latency_s: float, now: float | None = None) -> None:
        now = time.perf_counter() if now is None else now
        if self.t_first is None:
            self.t_first = now
        self.t_last = now
        self.n_total += 1
        if len(self._lat) < self.max_samples:
            self._lat.append(latency_s)
        else:
            # Algorithm R: keep the i-th observation with p = cap/i
            j = self._rng.randrange(self.n_total)
            if j < self.max_samples:
                self._lat[j] = latency_s

    def record_many(self, latencies_s: Sequence[float],
                    now: float | None = None) -> None:
        """Record one batch of latencies with a single timestamp — the
        dispatcher's per-batch path (one ``extend`` instead of a Python
        call per request until the reservoir fills)."""
        if not latencies_s:
            return
        now = time.perf_counter() if now is None else now
        if self.t_first is None:
            self.t_first = now
        self.t_last = now
        room = self.max_samples - len(self._lat)
        if room >= len(latencies_s):
            self.n_total += len(latencies_s)
            self._lat.extend(latencies_s)
            return
        if room > 0:
            self.n_total += room
            self._lat.extend(latencies_s[:room])
            latencies_s = latencies_s[room:]
        rng = self._rng
        cap = self.max_samples
        lat = self._lat
        n = self.n_total
        for v in latencies_s:
            n += 1
            j = rng.randrange(n)
            if j < cap:
                lat[j] = v
        self.n_total = n

    def reset(self) -> None:
        self.__init__(self.max_samples, self.seed)

    def snapshot(self) -> dict:
        lat = list(self._lat)  # copy: recording may continue concurrently
        return _reduce(lat, self.n_total, self.t_first, self.t_last)

    @staticmethod
    def merged_snapshot(recorders: Iterable["LatencyRecorder"]) -> dict:
        """One snapshot over several recorders (per-shard recorders of
        one model): raw samples are pooled so the percentiles are exact
        over the union, not an average of per-shard percentiles."""
        lat: list[float] = []
        n_total = 0
        t_first: float | None = None
        t_last: float | None = None
        for r in recorders:
            lat.extend(r._lat)
            n_total += r.n_total
            if r.t_first is not None:
                t_first = r.t_first if t_first is None else min(t_first, r.t_first)
            if r.t_last is not None:
                t_last = r.t_last if t_last is None else max(t_last, r.t_last)
        return _reduce(lat, n_total, t_first, t_last)


class StageAccumulator:
    """Per-stage wall-time totals for the dispatch path (single writer).

    ``add(stage, seconds, n)`` charges ``seconds`` of wall time and ``n``
    units to a stage (units are requests for ``queue_wait``, batches for
    the others — the snapshot reports both the total and the mean per
    unit so the two kinds stay interpretable).
    """

    STAGES = ("queue_wait", "batch_form", "pad", "dispatch", "copy_out")

    def __init__(self):
        self.total_s = {s: 0.0 for s in self.STAGES}
        self.count = {s: 0 for s in self.STAGES}

    def add(self, stage: str, seconds: float, n: int = 1) -> None:
        self.total_s[stage] += seconds
        self.count[stage] += n

    def snapshot(self) -> dict:
        return {
            s: {
                "total_ms": self.total_s[s] * 1e3,
                "count": self.count[s],
                "mean_us": (
                    self.total_s[s] / self.count[s] * 1e6
                    if self.count[s]
                    else 0.0
                ),
            }
            for s in self.STAGES
        }

    @staticmethod
    def merged_snapshot(accs: Iterable["StageAccumulator"]) -> dict:
        total = {s: 0.0 for s in StageAccumulator.STAGES}
        count = {s: 0 for s in StageAccumulator.STAGES}
        for a in accs:
            for s in StageAccumulator.STAGES:
                total[s] += a.total_s[s]
                count[s] += a.count[s]
        return {
            s: {
                "total_ms": total[s] * 1e3,
                "count": count[s],
                "mean_us": (total[s] / count[s] * 1e6) if count[s] else 0.0,
            }
            for s in StageAccumulator.STAGES
        }
