"""Process-wide metrics registry: counters, gauges, histograms.

Write path is lock-free after first touch: each writing thread owns a
private *shard* (registered under the module lock exactly once) and all
``inc`` / ``set`` / ``observe`` calls mutate only that shard — the same
single-writer idiom ``runtime.metrics.LatencyRecorder`` and the serve
dispatcher shards already use.  ``snapshot()`` merges the shards:
counters sum, gauges resolve last-write-wins via a global sequence
number, histograms add bucket counts.

Exposition: ``snapshot()`` (plain dict, JSON-ready) and
``to_prometheus()`` (Prometheus text format 0.0.4) — surfaced through
``ServeEngine.metrics_text()`` and ``benchmarks/run.py obs``.

``Histogram`` is also usable standalone (the serve shards keep one per
stage and merge them in ``stats()``), with fixed exponential bucket
edges in microseconds by default.
"""

from __future__ import annotations

import bisect
import itertools
import math
import threading
from collections.abc import Iterable, Sequence

__all__ = [
    "DEFAULT_BUCKETS_US",
    "Histogram",
    "MetricsRegistry",
    "get_registry",
    "render_prometheus",
]

# 1µs .. 10s, roughly 1-2-5 per decade — wide enough for both solver
# phases (ms..s) and serve stages (µs..ms)
DEFAULT_BUCKETS_US: tuple[float, ...] = (
    1.0, 2.0, 5.0,
    10.0, 20.0, 50.0,
    100.0, 200.0, 500.0,
    1_000.0, 2_000.0, 5_000.0,
    10_000.0, 20_000.0, 50_000.0,
    100_000.0, 200_000.0, 500_000.0,
    1_000_000.0, 2_000_000.0, 5_000_000.0, 10_000_000.0,
)

# global monotone sequence for gauge last-write-wins resolution across
# shards; itertools.count() bumps under the GIL without a lock
_GAUGE_SEQ = itertools.count()

LabelsT = tuple[tuple[str, str], ...]


def _labels_key(labels: dict) -> LabelsT:
    return tuple(sorted((str(k), str(v)) for k, v in labels.items()))


def _labels_str(labels: LabelsT) -> str:
    if not labels:
        return ""
    return "{" + ",".join(f'{k}="{v}"' for k, v in labels) + "}"


class Histogram:
    """Fixed-bucket histogram with Prometheus-style cumulative export.

    Single-writer by convention (one per thread/shard); merge shards
    with :meth:`merged`.  Values are unit-free — call sites use µs.
    """

    __slots__ = ("bounds", "counts", "sum", "n")

    def __init__(self, bounds: Sequence[float] = DEFAULT_BUCKETS_US) -> None:
        self.bounds = tuple(float(b) for b in bounds)
        self.counts = [0] * (len(self.bounds) + 1)  # last = +Inf overflow
        self.sum = 0.0
        self.n = 0

    def observe(self, value: float) -> None:
        self.counts[bisect.bisect_left(self.bounds, value)] += 1
        self.sum += value
        self.n += 1

    def merge_from(self, other: "Histogram") -> None:
        if other.bounds != self.bounds:
            raise ValueError("cannot merge histograms with different bucket bounds")
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.sum += other.sum
        self.n += other.n

    @staticmethod
    def merged(hists: Iterable["Histogram"]) -> "Histogram":
        out: Histogram | None = None
        for h in hists:
            if out is None:
                out = Histogram(h.bounds)
            out.merge_from(h)
        return out if out is not None else Histogram()

    def percentile(self, q: float) -> float:
        """Estimate the q-th percentile (0..100) by in-bucket interpolation."""
        if self.n == 0:
            return 0.0
        rank = q / 100.0 * self.n
        cum = 0
        lo = 0.0
        for i, c in enumerate(self.counts):
            if c == 0:
                continue
            hi = self.bounds[i] if i < len(self.bounds) else lo * 2 or 1.0
            if cum + c >= rank:
                frac = (rank - cum) / c
                return lo + frac * (hi - lo)
            cum += c
            lo = hi
        return lo

    def snapshot(self) -> dict:
        """Cumulative-bucket dict mirroring Prometheus histogram semantics."""
        cum = 0
        buckets = {}
        for i, bound in enumerate(self.bounds):
            cum += self.counts[i]
            buckets[bound] = cum
        buckets[math.inf] = self.n
        return {"count": self.n, "sum": self.sum, "buckets": buckets}


class _Shard:
    """One thread's private slice of the registry.  Single writer."""

    __slots__ = ("counters", "gauges", "hists")

    def __init__(self) -> None:
        self.counters: dict[tuple[str, LabelsT], float] = {}
        # gauge value is (seq, value) so merge can pick the latest write
        self.gauges: dict[tuple[str, LabelsT], tuple[int, float]] = {}
        self.hists: dict[tuple[str, LabelsT], Histogram] = {}


class MetricsRegistry:
    """Counters / gauges / histograms with per-thread single-writer shards."""

    def __init__(self, hist_bounds: Sequence[float] = DEFAULT_BUCKETS_US) -> None:
        self._lock = threading.Lock()
        self._shards: list[_Shard] = []
        self._tls = threading.local()
        self._hist_bounds = tuple(hist_bounds)

    def _shard(self) -> _Shard:
        s = getattr(self._tls, "shard", None)
        if s is None:
            s = _Shard()
            with self._lock:
                self._shards.append(s)
            self._tls.shard = s
        return s

    # -- write path (lock-free after first touch) ------------------------
    def inc(self, name: str, value: float = 1.0, **labels: object) -> None:
        s = self._shard()
        key = (name, _labels_key(labels))
        s.counters[key] = s.counters.get(key, 0.0) + value

    def set_gauge(self, name: str, value: float, **labels: object) -> None:
        s = self._shard()
        s.gauges[(name, _labels_key(labels))] = (next(_GAUGE_SEQ), float(value))

    def observe(self, name: str, value: float, **labels: object) -> None:
        s = self._shard()
        key = (name, _labels_key(labels))
        h = s.hists.get(key)
        if h is None:
            h = s.hists[key] = Histogram(self._hist_bounds)
        h.observe(value)

    # -- read path -------------------------------------------------------
    def _merged(self) -> tuple[dict, dict, dict]:
        with self._lock:
            shards = list(self._shards)
        counters: dict[tuple[str, LabelsT], float] = {}
        gauges: dict[tuple[str, LabelsT], tuple[int, float]] = {}
        hists: dict[tuple[str, LabelsT], Histogram] = {}
        for s in shards:
            for key, v in list(s.counters.items()):
                counters[key] = counters.get(key, 0.0) + v
            for key, sv in list(s.gauges.items()):
                cur = gauges.get(key)
                if cur is None or sv[0] > cur[0]:
                    gauges[key] = sv
            for key, h in list(s.hists.items()):
                tgt = hists.get(key)
                if tgt is None:
                    tgt = hists[key] = Histogram(h.bounds)
                tgt.merge_from(h)
        return counters, gauges, hists

    def snapshot(self) -> dict:
        """Merged view as a JSON-ready dict keyed ``name{label="v"}``."""
        counters, gauges, hists = self._merged()
        return {
            "counters": {n + _labels_str(k): v for (n, k), v in sorted(counters.items())},
            "gauges": {n + _labels_str(k): v for (n, k), (_, v) in sorted(gauges.items())},
            "histograms": {
                n + _labels_str(k): {
                    "count": h.n,
                    "sum": h.sum,
                    "p50": h.percentile(50),
                    "p99": h.percentile(99),
                }
                for (n, k), h in sorted(hists.items())
            },
        }

    def to_prometheus(self) -> str:
        """Prometheus text exposition (format 0.0.4) of the merged view."""
        counters, gauges, hists = self._merged()
        families: list[tuple[str, str, list]] = []
        for kind, data in (("counter", counters), ("gauge", gauges)):
            by_name: dict[str, list] = {}
            for (n, k), v in sorted(data.items()):
                val = v[1] if kind == "gauge" else v
                by_name.setdefault(n, []).append((k, val))
            for n, samples in by_name.items():
                families.append((n, kind, samples))
        hist_by_name: dict[str, list] = {}
        for (n, k), h in sorted(hists.items()):
            hist_by_name.setdefault(n, []).append((k, h))
        lines: list[str] = []
        for name, kind, samples in families:
            lines.append(f"# TYPE {name} {kind}")
            for k, val in samples:
                lines.append(f"{name}{_labels_str(k)} {_fmt(val)}")
        for name, samples in hist_by_name.items():
            lines.append(f"# TYPE {name} histogram")
            for k, h in samples:
                lines.extend(render_histogram_lines(name, dict(k), h))
        return "\n".join(lines) + "\n"

    def reset(self) -> None:
        with self._lock:
            for s in self._shards:
                s.counters.clear()
                s.gauges.clear()
                s.hists.clear()


def _fmt(v: float) -> str:
    if v == math.inf:
        return "+Inf"
    if float(v).is_integer() and abs(v) < 1e15:
        return str(int(v))
    return repr(float(v))


def render_histogram_lines(name: str, labels: dict, h: Histogram) -> list[str]:
    """Prometheus `_bucket`/`_sum`/`_count` sample lines for one histogram."""
    base = _labels_key(labels)
    lines = []
    cum = 0
    for i, bound in enumerate(h.bounds):
        cum += h.counts[i]
        lk = _labels_str(base + (("le", _fmt(bound)),))
        lines.append(f"{name}_bucket{lk} {cum}")
    lk = _labels_str(base + (("le", "+Inf"),))
    lines.append(f"{name}_bucket{lk} {h.n}")
    lines.append(f"{name}_sum{_labels_str(base)} {_fmt(h.sum)}")
    lines.append(f"{name}_count{_labels_str(base)} {h.n}")
    return lines


def render_prometheus(families: Iterable[tuple]) -> str:
    """Render ``(name, kind, help, samples)`` tuples as Prometheus text.

    ``samples`` is a list of ``(labels_dict, value)`` for counters and
    gauges, or ``(labels_dict, Histogram)`` for histograms.  Used by
    ``ServeEngine.metrics_text()`` to expose engine-derived families
    without double counting against the process registry.
    """
    lines: list[str] = []
    for name, kind, help_text, samples in families:
        if help_text:
            lines.append(f"# HELP {name} {help_text}")
        lines.append(f"# TYPE {name} {kind}")
        for labels, value in samples:
            if kind == "histogram":
                lines.extend(render_histogram_lines(name, labels, value))
            else:
                lines.append(f"{name}{_labels_str(_labels_key(labels))} {_fmt(value)}")
    return "\n".join(lines) + "\n"


_REGISTRY = MetricsRegistry()


def get_registry() -> MetricsRegistry:
    """The process-wide default registry (solver/compiler counters live here)."""
    return _REGISTRY
