"""Reduce a ``torch.profiler`` trace of the measured window to what the
per-layer metrics read: the device's busy time, each device operation's
time by name, and the idle gaps by what the host was doing meanwhile.

The window is the span of the ``dabench.window`` annotation that the
harness records around its loop; device operations are clipped to it.
"""

from __future__ import annotations

import bisect
from dataclasses import dataclass, field

from torch.autograd import DeviceType

WINDOW = "dabench.window"


@dataclass
class Trace:
    """The device's side of one traced window (times in seconds)."""

    window_s: float
    busy_s: float
    ops: list[tuple[str, str, float]] = field(default_factory=list)  # (kind, name, seconds)
    idle_by_host: dict[str, float] = field(default_factory=dict)

    def op_seconds(self, match=lambda kind, name: True) -> float:
        return sum(s for kind, name, s in self.ops if match(kind, name))

    def count(self, match=lambda kind, name: True) -> int:
        return sum(1 for kind, name, _ in self.ops if match(kind, name))

    def breakdown(self, n: int = 10) -> dict:
        by_name: dict[str, float] = {}
        for _, name, s in self.ops:
            by_name[name] = by_name.get(name, 0.0) + s
        top = sorted(by_name.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.idle_by_host.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k[:120], v] for k, v in top],
                "idle_gaps": [[k[:120], v] for k, v in gaps]}


def _kind(e) -> str:
    """``kernel``, ``memcpy`` or ``memset`` for a device operation, else
    ``host``."""
    if e.device_type() != DeviceType.CUDA:
        return "host"
    name = e.name()
    return "memcpy" if name.startswith("Memcpy") else "memset" if name.startswith("Memset") else "kernel"


def reduce(events) -> Trace | None:
    """The :class:`Trace` of the profiler's raw events (the objects of
    ``prof.profiler.kineto_results.events()``), or ``None`` where the
    trace has no window or no device operation in it."""
    events = list(events)
    # the annotation's host span (with CUDA traced it also has a device-side copy)
    win = [e for e in events if e.name() == WINDOW and e.device_type() != DeviceType.CUDA]
    if not win:
        return None
    t0 = win[0].start_ns()
    t1 = t0 + win[0].duration_ns()
    ops, spans = [], []
    host = []
    for e in events:
        if e.name() == WINDOW:
            continue
        kind = _kind(e)
        s, d = e.start_ns(), e.duration_ns()
        if kind != "host":
            a, b = max(s, t0), min(s + d, t1)
            if b > a:
                ops.append((kind, e.name(), (b - a) * 1e-9))
                spans.append((a, b))
        else:
            host.append((s, s + d, e.name()))
    if not ops:
        return None
    spans.sort()
    busy, gaps = 0, []
    cur_a, cur_b = spans[0]
    if cur_a > t0:
        gaps.append((t0, cur_a))
    for a, b in spans[1:]:
        if a > cur_b:
            busy += cur_b - cur_a
            gaps.append((cur_b, a))
            cur_a, cur_b = a, b
        else:
            cur_b = max(cur_b, b)
    busy += cur_b - cur_a
    if cur_b < t1:
        gaps.append((cur_b, t1))
    host.sort()
    starts = [h[0] for h in host]
    idle: dict[str, float] = {}
    for a, b in gaps:
        label = _host_at(host, starts, (a + b) // 2)
        idle[label] = idle.get(label, 0.0) + (b - a) * 1e-9
    return Trace(window_s=(t1 - t0) * 1e-9, busy_s=busy * 1e-9, ops=ops, idle_by_host=idle)


def _host_at(host, starts, t: int, look_back: int = 256) -> str:
    """The innermost host event running at ``t``: of those that cover it,
    the one that started last."""
    i = bisect.bisect_right(starts, t) - 1
    for j in range(i, max(i - look_back, -1), -1):
        s, e, name = host[j]
        if e >= t:
            return name
    return "host: no traced op"
