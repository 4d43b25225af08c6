"""Low-overhead span tracer on the host's and the card's clocks, with
Chrome trace-event / Perfetto export.

Usage::

    from repro_torch.obs import trace

    with trace.span("cse.select", engine="arena"):
        ...
    with trace.span("executor.forward", device=x.device, batch=n):
        ...  # also timed on the card where x is on a CUDA device

**When it records.**  While ``REPRO_TRACE=1`` or :func:`set_enabled` is
on, or while ``torch.profiler`` records (its flag in
``torch.autograd.profiler``, read only once torch has been imported), so
that a profiled window carries the program's spans with no other switch.
The spans never enter the profiler's own trace: under CUDA activity a
``record_function`` range leaves a device-side copy, which a reader of
the profiler's device events would count as a kernel and as busy time.

Design constraints (this sits inside the solver hot path, the serve
dispatcher loop and the integer executor):

* **Disabled path is a shared no-op context manager.**  ``span(...)``
  returns a module-level singleton when tracing is off: no object
  allocation, no clock read, no thread-local lookup, no CUDA call.  The
  residual cost is the call, its kwargs dict and the profiler flag's
  read, which is why call sites keep spans at *phase* granularity (per
  solve, per batch, per executor step), never per element.

* **Per-thread ring buffers, no locks on the record path.**  Each thread
  owns a bounded span ring it alone writes; the module lock is taken
  only when a thread records its first span (buffer registration) and at
  export.  When a ring wraps, the oldest spans are overwritten and
  counted in ``n_dropped``.  Each span records the id of the span open
  around it on its thread (its parent), so a span's self time is its
  duration less what its children cover.

* **One clock.**  Host times are ``time.time_ns()``, the clock that
  ``torch.profiler`` stamps its events with, so the program's spans and
  the profiler's events share a time base.

* **Device spans.**  ``span(name, device=d)`` with ``d`` a CUDA
  ``torch.device`` also records a timing CUDA event on that device's
  current stream at enter and at exit, taken from the thread's pool of
  reused events (a ring slot that is overwritten returns its events).
  Nothing waits while spans record: the events are read when the spans
  are (:func:`spans`, :func:`export`), after a synchronisation.  One
  anchor event per device, recorded and waited for when the device's
  first span opens, maps the card's clock onto the host's: the outermost
  device span of a thread's nesting is placed from the anchor, the spans
  inside it from its start event (an event pair's time is a float32 of
  milliseconds, precise over short intervals only).  While the stream
  is capturing a CUDA graph no event is recorded and the span is a host
  span; on a CPU device it is one too.  Torch is imported at the first
  device span: importing this module imports neither torch nor jax.

Export is the Chrome trace-event JSON format (``{"traceEvents": [...]}``
with "X" duration events and "M" thread-name metadata), loadable in
https://ui.perfetto.dev or chrome://tracing.  Timestamps are relative to
``baseTimeNanoseconds``, chosen as libkineto chooses its own, so the
events of this export and of ``torch.profiler``'s Chrome trace can be
concatenated into one timeline.
"""

from __future__ import annotations

import itertools
import json
import os
import sys
import threading
import time
from collections.abc import Iterator
from typing import Any, NamedTuple

__all__ = [
    "Span",
    "device_time_ns",
    "enabled",
    "export",
    "n_events",
    "reset",
    "set_capacity",
    "set_enabled",
    "span",
    "spans",
]

DEFAULT_CAPACITY = 65536
# libkineto's Chrome-trace time base: the epoch floored to this many seconds
_KINETO_BASE_S = 7889238

_PID = os.getpid()

_lock = threading.Lock()
_buffers: list["_ThreadBuf"] = []
_tls = threading.local()
_ids = itertools.count(1)
# CUDA device index -> (anchor event, its time on the host clock in ns)
_anchors: dict[int, tuple[Any, int]] = {}
_torch: Any = None

_capacity = int(os.environ.get("REPRO_TRACE_CAPACITY", DEFAULT_CAPACITY))
_enabled = os.environ.get("REPRO_TRACE", "").strip().lower() not in ("", "0", "false", "off")


def enabled() -> bool:
    """Whether span recording is switched on (``REPRO_TRACE=1`` or
    :func:`set_enabled`); spans also record while ``torch.profiler`` does."""
    return _enabled


def set_enabled(flag: bool) -> None:
    """Turn span recording on/off process-wide (also: ``REPRO_TRACE=1``)."""
    global _enabled
    _enabled = bool(flag)


def set_capacity(capacity: int) -> None:
    """Set the per-thread ring size for buffers created *after* this call."""
    global _capacity
    if capacity < 1:
        raise ValueError("trace capacity must be >= 1")
    _capacity = int(capacity)


class Span(NamedTuple):
    """One retained span, resolved.  Times are ns on the host clock
    (``time.time_ns()``, the profiler's); the device times, of a span
    that recorded CUDA events, are the card's, mapped onto that clock."""

    name: str
    id: int
    parent: int | None  # the span open around this one on its thread
    tid: int
    args: dict | None
    start_ns: int
    end_ns: int
    device: int | None = None  # CUDA device index, for a device span
    stream: int | None = None  # the stream's handle
    device_start_ns: int | None = None
    device_end_ns: int | None = None


class _ThreadBuf:
    """One thread's span ring.  Single writer: the owning thread."""

    __slots__ = ("tid", "name", "cap", "events", "n", "stack", "roots", "free")

    def __init__(self, tid: int, name: str, cap: int) -> None:
        self.tid = tid
        self.name = name
        self.cap = cap
        self.events: list[Any] = [None] * cap
        self.n = 0  # total spans ever pushed; ring index is n % cap
        self.stack: list[int] = []  # ids of the open spans, innermost last
        self.roots: dict[int, Any] = {}  # device -> start event of the outermost open device span
        self.free: dict[int, list] = {}  # device -> CUDA events to reuse

    def push(self, rec: tuple) -> None:
        i = self.n % self.cap
        old = self.events[i]
        if old is not None and old[-1] is not None:
            index, _, start, end, _ = old[-1]
            self.free.setdefault(index, []).extend((start, end))
        self.events[i] = rec
        self.n += 1

    def event(self, index: int) -> Any:
        pool = self.free.get(index)
        return pool.pop() if pool else _torch.cuda.Event(enable_timing=True)

    def iter_events(self) -> Iterator[tuple]:
        """Yield retained spans oldest-first: ``(name, id, parent, start_ns,
        end_ns, args, device)``, ``device`` None for a host span."""
        if self.n <= self.cap:
            for i in range(self.n):
                yield self.events[i]
        else:
            start = self.n % self.cap
            for i in range(self.cap):
                yield self.events[(start + i) % self.cap]

    @property
    def n_dropped(self) -> int:
        return max(0, self.n - self.cap)


def _buf() -> _ThreadBuf:
    b = getattr(_tls, "buf", None)
    if b is None:
        b = _ThreadBuf(threading.get_ident(), threading.current_thread().name, _capacity)
        with _lock:
            _buffers.append(b)
        _tls.buf = b
    return b


class _NoopSpan:
    """Shared do-nothing context manager returned while tracing is off."""

    __slots__ = ()

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: object) -> bool:
        return False


_NOOP = _NoopSpan()


class span:
    """Record one span over the ``with`` body.

    ``span(name, device=None, **attrs)`` -- attrs land in the exported
    event's ``args`` (Perfetto's slice details).  ``device``, a CUDA
    ``torch.device``, makes it a device span (module docstring).  When
    tracing is off this returns a shared no-op singleton (no allocation).
    """

    __slots__ = ("name", "args", "device", "id", "parent", "t0", "index", "stream", "start")

    def __new__(cls, name: str, device: Any = None, **attrs: Any) -> "span | _NoopSpan":
        if not _enabled:
            prof = sys.modules.get("torch.autograd.profiler")
            if prof is None or not prof._is_profiler_enabled:
                return _NOOP
        self = object.__new__(cls)
        self.name = name
        self.args = attrs or None
        self.device = device if getattr(device, "type", None) == "cuda" else None
        return self

    def __init__(self, name: str, device: Any = None, **attrs: Any) -> None:
        # attributes are set in __new__; __init__ only runs for the
        # enabled path and must not clobber them
        pass

    def __enter__(self) -> "span":
        b = _buf()
        self.parent = b.stack[-1] if b.stack else None
        self.id = next(_ids)
        self.start = None
        self.t0 = time.time_ns()
        if self.device is not None:
            self._record_start(b)
        b.stack.append(self.id)
        return self

    def _record_start(self, b: _ThreadBuf) -> None:
        global _torch
        if _torch is None:
            import torch

            _torch = torch
        cuda = _torch.cuda
        index = self.device.index if self.device.index is not None else cuda.current_device()
        stream = cuda.current_stream(index)
        if _capturing(index):
            return
        if index not in _anchors:
            _anchor(index, stream)
        ev = b.event(index)
        ev.record(stream)
        b.roots.setdefault(index, ev)
        self.index, self.stream, self.start = index, stream, ev

    def __exit__(self, *exc: object) -> bool:
        b = _buf()
        dev = None
        if self.start is not None:
            end = b.event(self.index)
            end.record(self.stream)
            root = b.roots[self.index]
            if root is self.start:
                del b.roots[self.index]
            dev = (self.index, self.stream.cuda_stream, self.start, end, root)
        t1 = time.time_ns()
        if b.stack and b.stack[-1] == self.id:
            b.stack.pop()
        b.push((self.name, self.id, self.parent, self.t0, t1, self.args, dev))
        return False


def _capturing(index: int) -> bool:
    """Whether the current stream of CUDA device ``index`` is capturing a graph."""
    cuda = _torch.cuda
    if index == cuda.current_device():
        return cuda.is_current_stream_capturing()
    with cuda.device(index):
        return cuda.is_current_stream_capturing()


def _anchor(index: int, stream: Any) -> None:
    """Map device ``index``'s clock onto the host's: an event recorded on
    the drained ``stream`` runs between the host times read before its
    record and after its completion."""
    ev = _torch.cuda.Event(enable_timing=True)
    stream.synchronize()
    before = time.time_ns()
    ev.record(stream)
    ev.synchronize()
    after = time.time_ns()
    _anchors.setdefault(index, (ev, (before + after) // 2))


def device_time_ns(host_ns: int, *elapsed_ms: float) -> int:
    """A device event's time on the host clock: a reference event's host
    time plus the chain of event-pair times (``Event.elapsed_time``, ms)
    from that reference to the event (anchor -> root -> event)."""
    return host_ns + sum(round(ms * 1e6) for ms in elapsed_ms)


def spans() -> tuple[list[Span], int]:
    """Every retained span, resolved, and the number of spans dropped by
    ring wraparound.  Waits for the devices that recorded device spans."""
    with _lock:
        bufs = list(_buffers)
    recs = [(b.tid, rec) for b in bufs for rec in b.iter_events()]
    dropped = sum(b.n_dropped for b in bufs)
    for index in {rec[-1][0] for _, rec in recs if rec[-1] is not None}:
        _torch.cuda.synchronize(index)
    placed: dict[int, int] = {}  # id(root event) -> its host time
    out = []
    for tid, (name, sid, parent, t0, t1, args, dev) in recs:
        if dev is None:
            out.append(Span(name, sid, parent, tid, args, t0, t1))
            continue
        index, stream, start, end, root = dev
        base = placed.get(id(root))
        if base is None:
            anchor, host = _anchors[index]
            base = placed[id(root)] = device_time_ns(host, anchor.elapsed_time(root))
        out.append(Span(name, sid, parent, tid, args, t0, t1, index, stream,
                        device_time_ns(base, root.elapsed_time(start)),
                        device_time_ns(base, root.elapsed_time(end))))
    return out, dropped


def n_events() -> int:
    """Total retained spans across all thread buffers."""
    with _lock:
        bufs = list(_buffers)
    return sum(min(b.n, b.cap) for b in bufs)


def reset() -> None:
    """Drop all recorded spans (buffers stay registered to their threads)."""
    with _lock:
        for b in _buffers:
            b.n = 0
            b.events = [None] * b.cap


def _event(name: str, t0: int, t1: int, base: int, tid: int, args: dict | None) -> dict:
    ev = {"name": name, "cat": "repro", "ph": "X", "ts": round((t0 - base) / 1e3, 3),
          "dur": round((t1 - t0) / 1e3, 3), "pid": _PID, "tid": tid}
    if args:
        ev["args"] = dict(args)
    return ev


def export(path: str | None = None) -> dict:
    """Build (and optionally write) a Chrome trace-event JSON document.

    Every thread's spans on its own track, with "M" thread_name metadata;
    device spans, besides, on a track of their own per device and stream
    (named ``cuda:<index> stream <handle>``).  Timestamps are µs since
    ``baseTimeNanoseconds`` on the profiler's clock.
    """
    items, n_dropped = spans()
    with _lock:
        bufs = list(_buffers)
    base = time.time_ns() // 10**9 // _KINETO_BASE_S * _KINETO_BASE_S * 10**9
    events: list[dict] = [
        {"ph": "M", "name": "thread_name", "pid": _PID, "tid": b.tid, "args": {"name": b.name}}
        for b in bufs
    ]
    tracks: dict[tuple[int, int], int] = {}
    for s in items:
        events.append(_event(s.name, s.start_ns, s.end_ns, base, s.tid, s.args))
        if s.device_start_ns is None:
            continue
        tid = tracks.get((s.device, s.stream))
        if tid is None:
            tid = tracks[(s.device, s.stream)] = len(tracks) + 1
            events.append({"ph": "M", "name": "thread_name", "pid": _PID, "tid": tid,
                           "args": {"name": f"cuda:{s.device} stream {s.stream}"}})
        events.append(_event(s.name, s.device_start_ns, s.device_end_ns, base, tid, s.args))
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "baseTimeNanoseconds": base,
        "otherData": {"producer": "repro_torch.obs.trace", "n_dropped": n_dropped},
    }
    if path is not None:
        with open(path, "w") as fh:
            json.dump(doc, fh)
    return doc
