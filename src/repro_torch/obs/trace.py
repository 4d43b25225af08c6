"""Low-overhead span tracer with Chrome trace-event / Perfetto export.

Usage::

    from repro_torch.obs import trace

    with trace.span("cse.select", engine="arena"):
        ...

Design constraints (this sits inside the solver hot path and the serve
dispatcher loop):

* **Disabled path is a shared no-op context manager.**  ``span(...)``
  returns a module-level singleton when tracing is off — no object
  allocation, no clock read, no thread-local lookup.  The only residual
  cost is the call itself plus the kwargs dict, which is why call sites
  keep spans at *phase* granularity (per solve / per batch), never
  per-element.

* **Per-thread ring buffers, no locks on the record path.**  Each thread
  owns a bounded event ring it alone writes; the module lock is taken
  only when a thread records its first span (buffer registration) and at
  export.  When a ring wraps, the oldest events are overwritten and
  counted in ``n_dropped``.

* **Thread-local span stacks** give each event its nesting depth so the
  exporter can emit well-formed Complete ("X") events even for spans
  closed out of wall-clock order on one thread.

Export is the Chrome trace-event JSON format (``{"traceEvents": [...]}``
with "X" duration events and "M" thread-name metadata), loadable
directly in https://ui.perfetto.dev or chrome://tracing.
"""

from __future__ import annotations

import json
import os
import threading
import time
from collections.abc import Iterator
from typing import Any

__all__ = [
    "enabled",
    "set_enabled",
    "set_capacity",
    "span",
    "instant",
    "reset",
    "export",
    "export_chrome_trace",
    "n_events",
]

DEFAULT_CAPACITY = 65536

_EPOCH = time.perf_counter()
_PID = os.getpid()

_lock = threading.Lock()
_buffers: list["_ThreadBuf"] = []
_tls = threading.local()

_capacity = int(os.environ.get("REPRO_TRACE_CAPACITY", DEFAULT_CAPACITY))
_enabled = os.environ.get("REPRO_TRACE", "").strip().lower() not in ("", "0", "false", "off")


def enabled() -> bool:
    """Whether span recording is currently on."""
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


class _ThreadBuf:
    """One thread's event ring.  Single writer: the owning thread."""

    __slots__ = ("tid", "name", "cap", "events", "n", "stack")

    def __init__(self, tid: int, name: str, cap: int) -> None:
        self.tid = tid
        self.name = name
        self.cap = cap
        self.events: list[Any] = [None] * cap
        self.n = 0  # total events ever pushed; ring index is n % cap
        self.stack: list[str] = []  # open span names (thread-local nesting)

    def push(self, ev: tuple) -> None:
        self.events[self.n % self.cap] = ev
        self.n += 1

    def iter_events(self) -> Iterator[tuple]:
        """Yield retained events oldest-first."""
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
    """Record one Complete ("X") event spanning the ``with`` body.

    ``span(name, **attrs)`` — attrs land in the event's ``args`` and show
    up in the Perfetto slice details pane.  When tracing is disabled this
    returns a shared no-op singleton (no allocation).
    """

    __slots__ = ("name", "args", "t0", "depth")

    def __new__(cls, name: str, **attrs: Any) -> "span | _NoopSpan":
        if not _enabled:
            return _NOOP
        self = object.__new__(cls)
        self.name = name
        self.args = attrs or None
        return self

    def __init__(self, name: str, **attrs: Any) -> None:
        # attributes are set in __new__; __init__ only runs for the
        # enabled path and must not clobber them
        pass

    def __enter__(self) -> "span":
        b = _buf()
        self.depth = len(b.stack)
        b.stack.append(self.name)
        self.t0 = time.perf_counter()
        return self

    def __exit__(self, *exc: object) -> bool:
        t1 = time.perf_counter()
        b = _buf()
        if b.stack and b.stack[-1] == self.name:
            b.stack.pop()
        # (name, ts_us, dur_us, depth, args) — dur None marks an instant
        b.push((self.name, (self.t0 - _EPOCH) * 1e6, (t1 - self.t0) * 1e6, self.depth, self.args))
        return False


def instant(name: str, **attrs: Any) -> None:
    """Record a zero-duration instant event (rendered as an arrow mark)."""
    if not _enabled:
        return
    b = _buf()
    b.push((name, (time.perf_counter() - _EPOCH) * 1e6, None, len(b.stack), attrs or None))


def n_events() -> int:
    """Total retained events across all thread buffers."""
    with _lock:
        bufs = list(_buffers)
    return sum(min(b.n, b.cap) for b in bufs)


def reset() -> None:
    """Drop all recorded events (buffers stay registered to their threads)."""
    with _lock:
        for b in _buffers:
            b.n = 0
            b.events = [None] * b.cap


def export(path: str | None = None) -> dict:
    """Build (and optionally write) a Chrome trace-event JSON document.

    Merges every thread's ring into one ``{"traceEvents": [...]}`` doc
    with per-thread "M" thread_name metadata.  Timestamps are µs since
    the module import epoch, so spans from the solver pool, dispatcher
    shards, and the main thread share one timeline.
    """
    with _lock:
        bufs = list(_buffers)
    events: list[dict] = []
    n_dropped = 0
    for b in bufs:
        events.append(
            {
                "ph": "M",
                "name": "thread_name",
                "pid": _PID,
                "tid": b.tid,
                "args": {"name": b.name},
            }
        )
        n_dropped += b.n_dropped
        for name, ts, dur, _depth, args in b.iter_events():
            ev = {
                "name": name,
                "cat": "repro",
                "ph": "X" if dur is not None else "i",
                "ts": round(ts, 3),
                "pid": _PID,
                "tid": b.tid,
            }
            if dur is not None:
                ev["dur"] = round(dur, 3)
            else:
                ev["s"] = "t"  # instant scope: thread
            if args:
                ev["args"] = dict(args)
            events.append(ev)
    doc = {
        "traceEvents": events,
        "displayTimeUnit": "ms",
        "otherData": {"producer": "repro_torch.obs.trace", "n_dropped": n_dropped},
    }
    if path is not None:
        with open(path, "w") as fh:
            json.dump(doc, fh)
    return doc


# canonical exporter name used by docs/benchmarks; `export` is the short form
export_chrome_trace = export
