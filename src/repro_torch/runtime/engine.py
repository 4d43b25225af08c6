"""Sharded, microbatched serving engine for compiled DA designs, on the
design's device.

Each registered :class:`CompiledDesign` gets:

  * N dispatch *shards* (``ServeConfig.shards``), each a bounded request
    queue + dispatcher thread + preallocated payload slab; ``submit``
    places requests round-robin across shards, ``submit_batch`` spreads
    contiguous chunks, and the per-model ``queue_depth`` backpressure
    budget is divided across shards;
  * a payload **slab** per shard: submitters write samples straight into
    a preallocated ring of slots, and the dispatcher gathers a whole
    batch out of it with one vectorized copy into a **pinned** host
    buffer of the batch's bucket shape (powers of two up to
    ``max_batch``), zero-padded;
  * per-bucket device execution through a CUDA graph: each shard
    captures ``forward_int`` (every CMVM through the adder-graph kernel)
    once per bucket shape, from a static device input buffer into a
    static output, at ``warmup()`` or at the first batch of that shape
    (the JAX engine jits it per shape; ``jit_compiles`` counts the
    captures).  A batch is an explicit ``non_blocking`` host-to-device
    copy on the shard's own CUDA stream, one replay, a device-to-host
    copy into a pinned output buffer, and a synchronise of that stream.
    On ``device="cpu"`` ``forward_int`` runs eagerly, without streams,
    pinning or graphs;
  * per-request latency accounting (p50/p95/p99, throughput) plus
    per-stage accounting (queue wait / batch-form / pad / dispatch /
    copy-out), per-stage microsecond histograms, a per-request flight
    recorder and per-shard counters, merged in ``stats()`` and exposed
    as Prometheus text by ``metrics_text()``; a ``serve.batch`` span
    (``repro_torch.obs.trace``) around each batch.

Requests are single samples on the integer input grid (``in_shape``);
``submit`` returns a ``concurrent.futures.Future`` resolving to the
integer output as a numpy array.

Shutdown discipline: every Future handed out is resolved -- with a
result while draining, or with :class:`EngineClosedError` once the model
is closed.  The closed flag is checked under the shard lock on every
enqueue, so a submit racing ``unregister``/``shutdown`` either lands
before the dispatcher's final drain (and is served) or fails fast.

Resilience: requests may carry a deadline (per call or
``ServeConfig.deadline_ms``) and are shed with
:class:`DeadlineExceededError` once it expires; consecutive dispatch
failures trip a per-model :class:`CircuitBreaker` (batches then fail
fast with :class:`CircuitOpenError`, or, with
``ServeConfig.fallback="interpreter"``, are served bit-exactly by the
numpy interpreter, as are batches whose device dispatch raised for
any reason but the device's own: a kernel that fails to build, load,
launch or capture, or a CUDA error, fails its batch and, until a device
dispatch succeeds again, keeps the interpreter from serving in its
place; every fault a dispatch absorbs or raises is a ``dispatch_fault``
event in the flight view, with its ``repr``); a
supervisor thread revives dead dispatchers within
``ServeConfig.restart_budget``, then escalates to
:class:`ModelUnhealthyError`.  The fault points of
:mod:`repro_torch.chaos` (``serve.dispatcher``, ``serve.dispatch``,
``serve.gather``) provoke each of these paths.  The invariant: every
submitted Future resolves, with a result or a typed error, and every
slab slot returns to the free list.
"""

from __future__ import annotations

import itertools
import threading
import time
from collections import deque
from concurrent.futures import Future
from concurrent.futures import TimeoutError as FutureTimeoutError
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..chaos import fault_point
from ..flow.config import UNSET, ServeConfig, resolve_legacy
from ..kernels._build import KernelError
from ..kernels.graphs import CapturedGraph, capture
from ..nn.compiler import CompiledDesign
from ..nn.interpreter import numpy_forward_fn
from ..obs import trace
from ..obs.flight import FlightRecorder
from ..obs.metrics import Histogram, get_registry, render_prometheus
from .artifact import load_design
from .metrics import LatencyRecorder, StageAccumulator
from .resilience import CircuitBreaker


def _device_fault(e: BaseException) -> bool:
    """Whether a dispatch failed on the card itself (a kernel that did not
    build, load, launch or capture, or a CUDA error), as opposed to the
    other faults the interpreter fallback may cover."""
    accel = getattr(torch, "AcceleratorError", None)
    if isinstance(e, (KernelError, torch.cuda.OutOfMemoryError)):
        return True
    if accel is not None and isinstance(e, accel):
        return True
    return isinstance(e, RuntimeError) and "CUDA error" in str(e)


class QueueFullError(RuntimeError):
    """Raised by ``submit`` when the backpressure policy is "reject" and
    the model's request queue is at capacity."""


class EngineClosedError(RuntimeError):
    """The request raced ``unregister``/``shutdown``: the model's
    dispatchers are stopping or gone, so it was failed fast."""


class DeadlineExceededError(RuntimeError):
    """The request's deadline expired before dispatch; it was shed
    (counted in ``n_shed``) instead of executed."""


class CircuitOpenError(RuntimeError):
    """The model's circuit breaker is open and no fallback is configured:
    the request failed fast instead of hitting the broken dispatch path
    (``n_fast_failed``)."""


class ShardCrashedError(RuntimeError):
    """The dispatch shard's thread died; its in-flight and pending
    futures were failed with this error.  With supervision the shard is
    restarted and new submits retry onto the replacement."""


class ModelUnhealthyError(RuntimeError):
    """The model exhausted its dispatcher restart budget (or crashed
    with supervision disabled); submits fail fast until it is
    re-registered."""


class _Request:
    __slots__ = ("slot", "t_submit", "future", "tid", "deadline")

    def __init__(
        self, slot: int, t_submit: float, future: Future, tid: int, deadline: float | None
    ):
        self.slot = slot
        self.t_submit = t_submit
        self.future = future
        self.tid = tid  # per-shard trace id, stamped at enqueue
        self.deadline = deadline  # absolute perf_counter seconds, or None


def _serve_config_from_legacy(legacy: dict) -> ServeConfig:
    if "overflow" in legacy:
        legacy["backpressure"] = legacy.pop("overflow")
    if legacy.get("buckets") is not None:
        legacy["buckets"] = tuple(legacy["buckets"])
    return ServeConfig(**legacy)


def _default_buckets(max_batch: int) -> tuple[int, ...]:
    out = [1]
    while out[-1] < max_batch:
        out.append(min(out[-1] * 2, max_batch))
    return tuple(out)


class _Shard(threading.Thread):
    """One dispatch lane of a model: bounded request deque + payload
    slab + pinned bucket buffers + CUDA stream and graphs + dispatcher
    thread.

    All shard state (deque, free-slot stack, counters) is guarded by one
    lock; submitters copy their sample into a reserved slab slot while
    holding it, and the dispatcher drains a whole batch in one lock
    acquisition, then gathers it with one vectorized copy.

    Crash discipline: the dispatcher loop is wrapped in a
    ``BaseException`` handler.  On crash the shard marks itself dead,
    fails its in-flight and pending futures with
    :class:`ShardCrashedError`, wakes blocked submitters and sets
    ``_drained``: a dead shard never strands a future or a slab slot.
    """

    def __init__(self, runner: _ModelRunner, idx: int, depth: int):
        super().__init__(daemon=True, name=f"da4ml-serve-{runner.model_name}-s{idx}")
        self.runner = runner
        self.idx = idx
        self.depth = depth
        self.max_batch = runner.max_batch
        self.max_wait_s = runner.max_wait_s
        self.in_shape = runner.in_shape
        self._fallback_fn = runner._fallback_fn
        self._closed = runner._closed  # runner-wide: set first in stop()

        # payload slab: depth queued + max_batch executing slots can be
        # live at once; slots are recycled through a free-list stack
        cap = depth + runner.max_batch
        self.slab = np.empty((cap, *self.in_shape), np.int32)
        self._free: list[int] = list(range(cap))
        self._pending: deque[_Request] = deque()
        self._lock = threading.Lock()
        self._not_empty = threading.Condition(self._lock)
        self._not_full = threading.Condition(self._lock)

        # per-bucket host buffers, reused every batch (safe: each batch
        # synchronises its stream and copies its outputs out before the
        # next one starts); pinned on a CUDA device so the copies are
        # asynchronous on this shard's stream
        design = runner.design
        self.device = design.device
        on_cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if on_cuda else None
        self._x_host = {
            b: torch.zeros((b, *self.in_shape), dtype=torch.int32, pin_memory=on_cuda)
            for b in runner.buckets
        }
        self._y_host = {
            b: torch.empty((b, *design.out_shape), dtype=torch.int32, pin_memory=on_cuda)
            for b in runner.buckets
        }
        # bucket -> (static device input, the graph of forward_int on it);
        # the shard's graphs share one memory pool, safe because only
        # this shard replays them, one at a time.  _device_lock keeps a
        # capture (which warmup() may make from another thread) and a
        # replay off the shard's stream and pool at the same time.
        self._graphs: dict[int, tuple[torch.Tensor, CapturedGraph]] = {}
        self._graph_pool = torch.cuda.graph_pool_handle() if on_cuda else None
        self._device_lock = threading.Lock()
        self.prepared: set[int] = set()  # bucket shapes captured (CPU: run) here
        self.prepare_s = 0.0  # wall seconds spent preparing them
        self.n_replays = 0

        self.metrics = LatencyRecorder()
        self.stage = StageAccumulator()
        # observability (single writer: this dispatcher thread): per-stage
        # µs histograms and the per-request flight recorder; trace ids are
        # stamped at enqueue under the shard lock (shard index in the high
        # bits keeps them unique across shards)
        self.stage_hist = {s: Histogram() for s in StageAccumulator.STAGES}
        self.flight = FlightRecorder(capacity=2048, slow_k=16)
        self._tid_seq = itertools.count()
        self._tid_base = idx << 40
        self.n_batches = 0
        self.n_rejected = 0  # guarded by self._lock (shared with submitters)
        self.n_shed = 0  # guarded by self._lock (submitters + dispatcher)
        self.n_fast_failed = 0  # dispatcher-only writer
        self.n_fallback_batches = 0  # dispatcher-only writer
        self._occupancy_sum = 0.0
        self.bucket_hits: dict[int, int] = {b: 0 for b in runner.buckets}
        self._stopping = threading.Event()  # not _stop: that is a Thread method
        self._drained = threading.Event()
        # crash state: flipped once by _on_crash, read under the lock by
        # submitters and lock-free by the supervisor
        self.dead = False
        self.crash_exc: BaseException | None = None
        self.heartbeat = time.perf_counter()
        self._executing: list[_Request] = []  # claimed, awaiting dispatch

    # -- enqueue (submitter threads) -----------------------------------
    def _closed_error(self) -> EngineClosedError:
        return EngineClosedError(f"model {self.runner.model_name!r}: engine shut down")

    def _full_error(self) -> QueueFullError:
        return QueueFullError(
            f"queue for model {self.runner.model_name!r} is full "
            f"({self.depth} requests on shard {self.idx})"
        )

    def _crash_error(self) -> ShardCrashedError:
        return ShardCrashedError(
            f"model {self.runner.model_name!r}: dispatch shard {self.idx} "
            f"crashed ({self.crash_exc!r})"
        )

    def _deadline_error(self) -> DeadlineExceededError:
        return DeadlineExceededError(
            f"model {self.runner.model_name!r}: deadline expired before dispatch (request shed)"
        )

    def _final_error(self) -> RuntimeError:
        return self._crash_error() if self.dead else self._closed_error()

    def put_one(
        self, x: np.ndarray, t_submit: float, block: bool, deadline: float | None = None
    ) -> Future:
        fut: Future = Future()
        if deadline is not None and t_submit >= deadline:
            # already-expired budget: shed at the door, before a slot is taken
            with self._lock:
                self.n_shed += 1
            if fut.set_running_or_notify_cancel():
                fut.set_exception(self._deadline_error())
            return fut
        with self._lock:
            while True:
                if self.dead:
                    raise self._crash_error()
                if self._closed.is_set():
                    raise self._closed_error()
                if self._free and len(self._pending) < self.depth:
                    break
                if not block:
                    self.n_rejected += 1
                    raise self._full_error()
                # timed wait: re-checks the closed flag even if a racing
                # stop() notified before we started waiting
                self._not_full.wait(0.05)
            slot = self._free.pop()
            self.slab[slot] = x
            self._pending.append(
                _Request(slot, t_submit, fut, self._tid_base | next(self._tid_seq), deadline)
            )
            self._not_empty.notify()
        return fut

    def put_many(
        self, xs: list, t_submit: float, block: bool, deadline: float | None = None
    ) -> list[Future]:
        """Enqueue a chunk under one lock acquisition.  With the reject
        policy, overflowing samples' futures are failed with
        :class:`QueueFullError` (and counted) instead of raising; if the
        shard closes or crashes mid-chunk the remaining futures are
        failed -- every returned Future resolves."""
        futs: list[Future] = [Future() for _ in xs]
        if deadline is not None and t_submit >= deadline:
            with self._lock:
                self.n_shed += len(xs)
            err = self._deadline_error()
            for f in futs:
                if f.set_running_or_notify_cancel():
                    f.set_exception(err)
            return futs
        i, n = 0, len(xs)
        with self._lock:
            while i < n:
                if self.dead or self._closed.is_set():
                    break
                space = min(len(self._free), self.depth - len(self._pending))
                if space <= 0:
                    if not block:
                        self.n_rejected += 1
                        f = futs[i]
                        if f.set_running_or_notify_cancel():
                            f.set_exception(self._full_error())
                        i += 1
                        continue
                    self._not_full.wait(0.05)
                    continue
                for j in range(i, min(i + space, n)):
                    slot = self._free.pop()
                    self.slab[slot] = xs[j]
                    self._pending.append(_Request(
                        slot, t_submit, futs[j], self._tid_base | next(self._tid_seq), deadline
                    ))
                i = min(i + space, n)
                self._not_empty.notify()
        for j in range(i, n):  # chunk tail cut off by a racing shutdown/crash
            f = futs[j]
            if f.set_running_or_notify_cancel():
                f.set_exception(self._final_error())
        return futs

    # -- dispatcher ----------------------------------------------------
    def run(self) -> None:
        try:
            while True:
                self.heartbeat = time.perf_counter()
                fault_point("serve.dispatcher")
                batch, t_first = self._collect()
                if batch:
                    with trace.span("serve.batch", shard=self.idx, n=len(batch)):
                        self._execute(batch, t_first)
                elif self._stopping.is_set():
                    break
            self._fail_pending(self._closed_error)
            self._drained.set()
        except BaseException as e:  # dispatcher death: clean up, never strand
            self._on_crash(e)

    def _collect(self) -> tuple[list[_Request], float]:
        with self._lock:
            while not self._pending:
                if self._stopping.is_set():
                    return [], 0.0
                self.heartbeat = time.perf_counter()
                self._not_empty.wait(0.05)
            t_first = time.perf_counter()
            if len(self._pending) < self.max_batch and not self._stopping.is_set():
                deadline = t_first + self.max_wait_s
                while len(self._pending) < self.max_batch:
                    rem = deadline - time.perf_counter()
                    if rem <= 0 or self._stopping.is_set():
                        break
                    self._not_empty.wait(min(rem, 0.02))
            n = min(len(self._pending), self.max_batch)
            batch = [self._pending.popleft() for _ in range(n)]
            self._not_full.notify_all()
            return batch, t_first

    def _free_slots(self, slots: list) -> None:
        with self._lock:
            self._free.extend(slots)
            self._not_full.notify_all()

    def _fail_pending(self, err_factory) -> None:
        """Fail any requests still queued once the dispatcher is gone."""
        with self._lock:
            reqs = list(self._pending)
            self._pending.clear()
            self._free.extend(r.slot for r in reqs)
            self._not_full.notify_all()
        for r in reqs:
            if r.future.set_running_or_notify_cancel():
                r.future.set_exception(err_factory())

    def _on_crash(self, exc: BaseException) -> None:
        """Dispatcher-thread death: mark dead, wake blocked submitters,
        fail in-flight and pending futures, release their slots, and
        report to the runner."""
        self.crash_exc = exc
        with self._lock:
            self.dead = True
            self._not_empty.notify_all()
            self._not_full.notify_all()
        claimed, self._executing = self._executing, []
        for r in claimed:
            if not r.future.done():
                r.future.set_exception(self._crash_error())
        self._fail_pending(self._crash_error)
        self._drained.set()
        self.runner._note_crash(self, exc)

    def _bucket(self, n: int) -> int:
        for b in self.runner.buckets:
            if b >= n:
                return b
        return self.runner.buckets[-1]

    def prepare(self, b: int) -> None:
        """Make bucket shape ``b`` ready on this shard, once.  On the card:
        capture ``forward_int`` from a static device input into a CUDA
        graph (``kernels.graphs.capture``, after one warm-up run).  On the
        CPU: run it once on zeros."""
        with self._device_lock:
            if b in self.prepared:
                return
            t0 = time.perf_counter()
            design = self.runner.design
            x = torch.zeros((b, *self.in_shape), dtype=torch.int32, device=self.device)
            if self._stream is None:
                design.forward_int(x)
            else:
                graph = capture(lambda: design.forward_int(x), stream=self._stream,
                                pool=self._graph_pool)
                self._graphs[b] = (x, graph)
            self.prepared.add(b)
            self.prepare_s += time.perf_counter() - t0

    def run_bucket(self, b: int) -> np.ndarray:
        """Run the pinned input buffer of bucket ``b`` through the design
        on its device (on the card: the bucket's graph, captured first if
        need be); returns a fresh host array of outputs."""
        x_host, y_host = self._x_host[b], self._y_host[b]
        if self._stream is None:
            y = self.runner.design.forward_int(x_host).numpy().copy()
            self.prepared.add(b)
            return y
        if b not in self.prepared:
            try:
                self.prepare(b)
            except Exception as e:
                raise KernelError(
                    f"capture of bucket {b} on shard {self.idx} failed: {e!r}"
                ) from e
        x_dev, graph = self._graphs[b]
        with self._device_lock, torch.cuda.stream(self._stream):
            x_dev.copy_(x_host, non_blocking=True)
            graph.replay()
            y_host.copy_(graph.output, non_blocking=True)
            self._stream.synchronize()
            self.n_replays += 1
        return y_host.numpy().copy()

    def _fallback(self, b: int) -> np.ndarray:
        return np.asarray(self._fallback_fn(self._x_host[b].numpy()))

    def _dispatch(self, b: int) -> tuple[np.ndarray, bool]:
        """Run one padded batch through the breaker-routed dispatch path.
        Returns (outputs, used_fallback).  The fallback never serves in
        place of a device that failed (:func:`_device_fault`)."""
        runner = self.runner
        breaker = runner.breaker
        route = breaker.route()
        if route == "reject":
            if self._fallback_fn is not None and runner.device_fault is None:
                return self._fallback(b), True
            why = (f"the device failed ({runner.device_fault})"
                   if runner.device_fault is not None else "no fallback configured")
            raise CircuitOpenError(
                f"model {runner.model_name!r}: circuit breaker open and {why}"
            )
        probe = route == "probe"
        try:
            fault_point("serve.dispatch")
            y = self.run_bucket(b)
        except Exception as e:
            breaker.record(ok=False, probe=probe)
            on_device = _device_fault(e)
            if on_device:
                runner.device_fault = repr(e)
            fallback = self._fallback_fn is not None and not on_device
            self.flight.record_event(
                "dispatch_fault", ts_us=time.perf_counter() * 1e6, shard=self.idx,
                error=repr(e), device=on_device, fallback=fallback,
            )
            if fallback:
                return self._fallback(b), True
            raise
        except BaseException:  # a thread kill: never leave a probe hung
            breaker.record(ok=False, probe=probe)
            raise
        breaker.record(ok=True, probe=probe)
        runner.device_fault = None
        return y, False

    def _execute(self, batch: list[_Request], t_first: float) -> None:
        t_formed = time.perf_counter()
        # claim the futures; drop any the client cancelled while queued,
        # shed any whose deadline expired while they sat in the queue
        claimed: list[_Request] = []
        expired: list[_Request] = []
        for r in batch:
            if not r.future.set_running_or_notify_cancel():
                continue
            if r.deadline is not None and t_formed >= r.deadline:
                expired.append(r)
            else:
                claimed.append(r)
        self.stage.add("batch_form", t_formed - t_first)
        slots = [r.slot for r in batch]
        if expired:
            with self._lock:
                self.n_shed += len(expired)
            for r in expired:
                r.future.set_exception(self._deadline_error())
        if not claimed:
            self._free_slots(slots)
            return
        self.stage.add("queue_wait", sum(t_formed - r.t_submit for r in claimed), len(claimed))
        n = len(claimed)
        b = self._bucket(n)
        x = self._x_host[b].numpy()
        self._executing = claimed  # crash handler fails these if we die here
        try:
            try:
                fault_point("serve.gather")
                x[:n] = self.slab[[r.slot for r in claimed]]
                if n < b:
                    x[n:] = 0
            finally:
                self._free_slots(slots)  # slots recycle even on failure
            t_pad = time.perf_counter()
            self.stage.add("pad", t_pad - t_formed)
            y, used_fallback = self._dispatch(b)
        # a thread kill (ThreadKillFault, a BaseException) passes: run()'s
        # crash handler resolves self._executing
        except Exception as e:  # resolve futures instead of killing the thread
            self._executing = []
            if isinstance(e, CircuitOpenError):
                self.n_fast_failed += len(claimed)
            for r in claimed:
                r.future.set_exception(e)
            return
        self._executing = []
        t_done = time.perf_counter()
        self.stage.add("dispatch", t_done - t_pad)
        if used_fallback:
            self.n_fallback_batches += 1
        lats = []
        for i, r in enumerate(claimed):
            r.future.set_result(y[i])
            lats.append(t_done - r.t_submit)
        self.metrics.record_many(lats, t_done)
        self.n_batches += 1
        # counted only on success, keeping sum(bucket_hits) == n_batches
        self.bucket_hits[b] += 1
        self._occupancy_sum += n / b
        t_out = time.perf_counter()
        self.stage.add("copy_out", t_out - t_done)
        self._observe_batch(claimed, lats, b, n, t_first, t_formed, t_pad, t_done, t_out)

    def _observe_batch(
        self, claimed, lats, b, n, t_first, t_formed, t_pad, t_done, t_out
    ) -> None:
        """Feed the per-stage histograms, the flight recorder and the
        process-registry gauges after a successful batch.  This thread is
        the sole writer of all three; the batch-shared stage times are
        charged to every request's flight record while queue_wait stays
        per request."""
        bf_us = (t_formed - t_first) * 1e6
        pad_us = (t_pad - t_formed) * 1e6
        disp_us = (t_done - t_pad) * 1e6
        out_us = (t_out - t_done) * 1e6
        hists = self.stage_hist
        hists["batch_form"].observe(bf_us)
        hists["pad"].observe(pad_us)
        hists["dispatch"].observe(disp_us)
        hists["copy_out"].observe(out_us)
        qh = hists["queue_wait"]
        fl = self.flight
        ts_us = t_done * 1e6
        for r, lat in zip(claimed, lats):
            qw_us = (t_formed - r.t_submit) * 1e6
            qh.observe(qw_us)
            fl.record(
                r.tid, self.idx, b, n, lat * 1e6,
                (qw_us, bf_us, pad_us, disp_us, out_us), ts_us=ts_us,
            )
        # unlocked reads: both lens are single CPython ops, and a gauge
        # only needs to be approximately current
        reg = get_registry()
        model = self.runner.model_name
        reg.set_gauge("serve_queue_depth", len(self._pending), model=model, shard=self.idx)
        reg.set_gauge(
            "serve_slab_occupancy", 1.0 - len(self._free) / self.slab.shape[0],
            model=model, shard=self.idx,
        )

    # -- control -------------------------------------------------------
    def initiate_stop(self) -> None:
        self._stopping.set()
        with self._lock:
            self._not_empty.notify_all()
            self._not_full.notify_all()

    def release_device(self) -> None:
        """Drop a stopped shard's graphs (and with them their memory pool)
        and its pinned buffers, so a drained model gives its device memory
        back at once, not when the garbage collector breaks the runner's
        reference cycles."""
        with self._device_lock:
            self._graphs.clear()
            self._graph_pool = None
            self._x_host.clear()
            self._y_host.clear()

    def snapshot(self) -> dict:
        with self._lock:
            qsize = len(self._pending)
            n_rejected = self.n_rejected
            n_shed = self.n_shed
        n_batches = self.n_batches
        return {
            "shard": self.idx,
            "n_batches": n_batches,
            "n_rejected": n_rejected,
            "n_shed": n_shed,
            "n_fast_failed": self.n_fast_failed,
            "n_fallback_batches": self.n_fallback_batches,
            "n_requests": self.metrics.n_total,
            "queue_depth": qsize,
            "dead": self.dead,
            "heartbeat_age_s": max(0.0, time.perf_counter() - self.heartbeat),
            "mean_batch_occupancy": self._occupancy_sum / n_batches if n_batches else 0.0,
            "bucket_hits": {int(b): int(c) for b, c in self.bucket_hits.items()},
            "prepared": sorted(self.prepared),
            "prepare_ms": self.prepare_s * 1e3,
            "n_graph_replays": self.n_replays,
            "per_stage": self.stage.snapshot(),
            "flight": self.flight.snapshot(),
        }


class _Supervisor(threading.Thread):
    """Per-model watchdog: polls the runner's dispatcher threads and
    revives dead ones."""

    def __init__(self, runner: _ModelRunner, interval_s: float = 0.05):
        super().__init__(daemon=True, name=f"da4ml-supervise-{runner.model_name}")
        self.runner = runner
        self.interval_s = interval_s

    def run(self) -> None:
        r = self.runner
        while not r._closed.wait(self.interval_s):
            for idx in range(r.n_shards):
                sh = r.shards[idx]
                if sh.ident is None:
                    continue  # not started yet
                if (sh.dead or not sh.is_alive()) and not sh._stopping.is_set():
                    r._revive(idx, sh)


class _ModelRunner:
    """One registered model: its design on the device + N dispatch
    shards + circuit breaker + (optional) interpreter fallback +
    (optional) supervisor."""

    def __init__(self, name: str, design: CompiledDesign, config: ServeConfig):
        self.model_name = name
        self.design = design
        self.max_batch = config.max_batch
        self.max_wait_s = config.max_wait_us * 1e-6
        self.buckets = config.buckets or _default_buckets(config.max_batch)
        self.in_shape = tuple(design.in_shape)
        self.supervise = config.supervise
        self.restart_budget = config.restart_budget
        self.deadline_default_s = (
            config.deadline_ms * 1e-3 if config.deadline_ms is not None else None
        )
        self._fallback_fn = (
            numpy_forward_fn(design) if config.fallback == "interpreter" else None
        )
        self.breaker = CircuitBreaker(
            threshold=config.breaker_threshold,
            cooldown_s=config.breaker_cooldown_ms * 1e-3,
            cooldown_max_s=config.breaker_cooldown_max_ms * 1e-3,
            on_event=self._breaker_event,
        )
        # lifecycle events (breaker transitions, crashes, restarts) land
        # in a runner-level recorder merged into the stats flight view
        self.flight_events = FlightRecorder(capacity=8, slow_k=0)
        # repr of the last device fault (_device_fault) of a dispatch, until
        # a device dispatch succeeds; while set, the fallback serves nothing
        self.device_fault: str | None = None
        self.n_shards = config.shards
        # the per-model queue_depth budget is divided across shards (ceil)
        self._depth = -(-config.queue_depth // self.n_shards)
        self._closed = threading.Event()
        self.shards = [_Shard(self, i, self._depth) for i in range(self.n_shards)]
        self._rr = itertools.count()  # round-robin placement cursor
        # supervision state, guarded by _restart_lock (shard swaps too)
        self._restart_lock = threading.Lock()
        self._count_lock = threading.Lock()
        self._retired: list[_Shard] = []
        self.restarts_used = [0] * self.n_shards
        self.n_restarts = 0
        self.n_crashes = 0
        self.n_client_timeouts = 0
        self.healthy = True
        self._supervisor: _Supervisor | None = None

    def start(self) -> None:
        for sh in self.shards:
            sh.start()
        if self.supervise and self._supervisor is None:
            self._supervisor = _Supervisor(self)
            self._supervisor.start()

    # -- resilience plumbing -------------------------------------------
    def _record_event(self, kind: str, **fields) -> None:
        self.flight_events.record_event(kind, ts_us=time.perf_counter() * 1e6, **fields)

    def _breaker_event(self, kind: str, snap: dict) -> None:
        self._record_event(
            kind,
            state=snap["state"],
            n_trips=snap["n_trips"],
            n_reopens=snap["n_reopens"],
            n_recoveries=snap["n_recoveries"],
            cooldown_s=snap["cooldown_s"],
        )

    def _note_crash(self, shard: _Shard, exc: BaseException) -> None:
        with self._count_lock:
            self.n_crashes += 1
        self._record_event("shard_crash", shard=shard.idx, error=repr(exc))
        if not self.supervise and self.healthy:
            # nobody will revive this lane: fail the model loudly
            self.healthy = False
            self._record_event(
                "model_unhealthy", shard=shard.idx, reason="crash with supervision disabled"
            )

    def _revive(self, idx: int, dead_shard: _Shard) -> None:
        """Swap a fresh dispatcher in for a dead one (supervisor thread),
        within the restart budget; past it the model is unhealthy."""
        with self._restart_lock:
            if self._closed.is_set() or self.shards[idx] is not dead_shard:
                return
            if not dead_shard.dead:
                # the thread died without running its crash handler:
                # never leave futures hanging
                dead_shard._on_crash(RuntimeError("dispatcher thread died"))
            if self.restarts_used[idx] >= self.restart_budget:
                if self.healthy:
                    self.healthy = False
                    self._record_event(
                        "model_unhealthy", shard=idx, reason="restart budget exhausted",
                        restarts=self.restarts_used[idx],
                    )
                return
            fresh = _Shard(self, idx, self._depth)
            self.restarts_used[idx] += 1
            self.n_restarts += 1
            self._retired.append(dead_shard)
            self.shards[idx] = fresh
            fresh.start()
            self._record_event("shard_restart", shard=idx, restart_n=self.restarts_used[idx])

    def count_client_timeout(self) -> None:
        with self._count_lock:
            self.n_client_timeouts += 1

    def _unhealthy_error(self) -> ModelUnhealthyError:
        return ModelUnhealthyError(
            f"model {self.model_name!r} is unhealthy "
            f"(dispatcher restart budget of {self.restart_budget} exhausted)"
        )

    def deadline_abs(self, t_submit: float, deadline_s: float | None) -> float | None:
        """Absolute deadline: per-call value, else the config default,
        else None."""
        if deadline_s is None:
            if self.deadline_default_s is None:
                return None
            deadline_s = self.deadline_default_s
        return t_submit + deadline_s

    # -- serving -------------------------------------------------------
    def submit_one(
        self, x: np.ndarray, t_submit: float, block: bool, deadline: float | None = None
    ) -> Future:
        last: ShardCrashedError | None = None
        for _ in range(8):
            if not self.healthy:
                raise self._unhealthy_error()
            sh = self.shards[next(self._rr) % self.n_shards]
            try:
                return sh.put_one(x, t_submit, block, deadline)
            except ShardCrashedError as e:
                last = e
                if self._closed.is_set() or not self.supervise:
                    raise
                # outlast one supervisor poll, or a submit racing the
                # revive fails spuriously
                time.sleep(0.02)
        if not self.healthy:
            raise self._unhealthy_error()
        raise last  # type: ignore[misc]

    def submit_many(
        self, xs: list, t_submit: float, block: bool, deadline: float | None = None
    ) -> list[Future]:
        if not self.healthy:
            raise self._unhealthy_error()
        if self.n_shards == 1 or len(xs) <= 1:
            sh = self.shards[next(self._rr) % self.n_shards]
            return sh.put_many(xs, t_submit, block, deadline)
        # contiguous chunks, one per shard round-robin
        chunk = -(-len(xs) // self.n_shards)
        futs: list[Future] = []
        for i in range(0, len(xs), chunk):
            sh = self.shards[next(self._rr) % self.n_shards]
            futs.extend(sh.put_many(xs[i : i + chunk], t_submit, block, deadline))
        return futs

    # -- control -------------------------------------------------------
    def warmup(self) -> float:
        """Prepare every bucket shape on every shard (on the card: capture
        its graph), on the caller's thread; returns wall seconds.  A
        bucket counts as prepared only once its capture returned."""
        t0 = time.perf_counter()
        with self._restart_lock:
            shards = list(self.shards)
        for sh in shards:
            for b in self.buckets:
                sh.prepare(b)
        if self.design.device.type == "cuda":
            torch.cuda.synchronize(self.design.device)
        return time.perf_counter() - t0

    def stop(self, timeout: float = 5.0) -> None:
        # closed first: from here on every enqueue fails fast and the
        # supervisor revives nothing; queued requests are still drained
        self._closed.set()
        with self._restart_lock:  # no shard swap can race the drain below
            shards = list(self.shards)
        for sh in shards:
            sh.initiate_stop()
        deadline = time.perf_counter() + timeout
        for sh in shards:
            if sh.dead:
                continue  # crashed: its handler already set _drained
            sh._drained.wait(max(0.0, deadline - time.perf_counter()))
        for sh in shards:
            # drain timed out, or the shard died: fail leftovers loudly
            sh._fail_pending(sh._final_error)
        if self._supervisor is not None:
            self._supervisor.join(timeout=1.0)
        with self._restart_lock:
            done = [*self.shards, *self._retired]
        for sh in done:
            # a dispatcher still inside a batch (its drain timed out) keeps
            # its graphs; every other one gives them back now
            if sh.is_alive():
                sh.join(max(0.0, deadline - time.perf_counter()))
            if not sh.is_alive():
                sh.release_device()

    def stats(self) -> dict:
        with self._restart_lock:
            live = list(self.shards)
            retired = list(self._retired)
            restarts_used = list(self.restarts_used)
        all_shards = retired + live
        shard_snaps = []
        for sh in all_shards:
            snap = sh.snapshot()
            snap["retired"] = sh in retired
            shard_snaps.append(snap)
        s = LatencyRecorder.merged_snapshot([sh.metrics for sh in all_shards])
        bucket_hits = {int(b): 0 for b in self.buckets}
        # per bucket shape, the shards that captured its graph (CPU: ran
        # it); the key keeps the JAX engine's name, where it counted jit
        # compiles
        jit_compiles = {int(b): 0 for b in self.buckets}
        n_batches = n_rejected = n_shed = n_fast_failed = n_fallback = qdepth = 0
        n_replays = 0
        prepare_ms = occupancy = 0.0
        for sh, snap in zip(all_shards, shard_snaps):
            n_batches += snap["n_batches"]
            n_rejected += snap["n_rejected"]
            n_shed += snap["n_shed"]
            n_fast_failed += snap["n_fast_failed"]
            n_fallback += snap["n_fallback_batches"]
            n_replays += snap["n_graph_replays"]
            prepare_ms += snap["prepare_ms"]
            qdepth += snap["queue_depth"]
            occupancy += sh._occupancy_sum
            for b, c in snap["bucket_hits"].items():
                bucket_hits[b] += c
            for b in snap["prepared"]:
                jit_compiles[b] += 1
        graph_launches = {}  # bucket -> kernel launches per replay, by kernel
        for sh in all_shards:
            for b, (_, graph) in list(sh._graphs.items()):
                graph_launches.setdefault(int(b), graph.launches_by_kernel())
        with self._count_lock:
            n_client_timeouts = self.n_client_timeouts
            n_crashes = self.n_crashes
        s.update(
            model=self.model_name,
            device=str(self.design.device),
            n_shards=self.n_shards,
            n_batches=n_batches,
            n_rejected=n_rejected,
            n_shed=n_shed,
            n_fast_failed=n_fast_failed,
            n_fallback_batches=n_fallback,
            n_client_timeouts=n_client_timeouts,
            queue_depth=qdepth,
            mean_batch_occupancy=occupancy / n_batches if n_batches else 0.0,
            buckets=list(self.buckets),
            bucket_hits=bucket_hits,
            jit_compiles=jit_compiles,
            n_jit_compiles=sum(jit_compiles.values()),
            jit_compile_ms=prepare_ms,
            n_graph_replays=n_replays,
            graph_launches_per_replay=dict(sorted(graph_launches.items())),
            per_stage=StageAccumulator.merged_snapshot([sh.stage for sh in all_shards]),
            # cross-shard flight view: the slowest-K request records plus
            # the time-ordered lifecycle events of the runner's recorder
            flight=FlightRecorder.merged([sh.flight for sh in all_shards] + [self.flight_events]),
            breaker=self.breaker.snapshot(),
            supervision={
                "supervise": self.supervise,
                "healthy": self.healthy,
                "n_crashes": n_crashes,
                "n_restarts": self.n_restarts,
                "restart_budget": self.restart_budget,
                "restarts_used": restarts_used,
            },
            shards=shard_snaps,
        )
        return s


class ServeEngine:
    """Multi-model registry + sharded microbatched dispatch over compiled
    designs on one device.

    ``config`` is a :class:`repro_torch.flow.ServeConfig` (max_batch,
    max_wait_us, queue_depth, backpressure, buckets, shards, deadline_ms,
    fallback, breaker_*, supervise, restart_budget).  With
    ``fallback="interpreter"`` each registered design gets its numpy
    interpreter (``repro_torch.nn.interpreter``), which serves a batch
    while the breaker is open or when its device dispatch raised, unless
    the card itself failed; with the default ``"none"`` such a batch
    fails.  ``device``
    defaults to the CUDA card and raises without one unless
    ``device="cpu"``; every registered design must live there.

    ``register`` rejects duplicate model names loudly: replacing a model
    in place would mix two designs' results under one name.  Rolling a
    model forward is a versioning operation:
    :class:`repro_torch.flow.Deployment`.

    The keyword-only ``max_batch`` ... ``overflow`` are the JAX package's
    deprecated option kwargs (``overflow`` maps to ``backpressure``):
    they warn and build the equivalent config.  They are keyword-only
    here, where the JAX package takes them first and positionally,
    because the port's callers pass ``config`` first.
    """

    def __init__(
        self,
        config: ServeConfig | None = None,
        device: str | torch.device | None = None,
        *,
        max_batch=UNSET,
        queue_depth=UNSET,
        max_wait_us=UNSET,
        buckets=UNSET,
        overflow=UNSET,
    ):
        legacy = {
            name: val
            for name, val in (
                ("max_batch", max_batch),
                ("queue_depth", queue_depth),
                ("max_wait_us", max_wait_us),
                ("buckets", buckets),
                ("overflow", overflow),
            )
            if val is not UNSET
        }
        self.config = resolve_legacy(
            "ServeEngine", config, legacy, ServeConfig, _serve_config_from_legacy
        )
        self.device = resolve_device(device)
        self._runners: dict[str, _ModelRunner] = {}
        self._lock = threading.Lock()

    # -- registry ------------------------------------------------------
    def register(
        self, name: str, design: CompiledDesign | str | Path, warmup: bool = False
    ) -> CompiledDesign:
        """Register a design (or load one from an artifact path onto the
        engine's device).  ``warmup=True`` prepares every bucket shape on
        every shard first (on the card: captures its graph); with the
        interpreter fallback configured, the card always does so here."""
        if not isinstance(design, CompiledDesign):
            design = load_design(design, device=self.device)
        if design.device != self.device:
            raise ValueError(
                f"model {name!r}: design is on {design.device}, the engine on "
                f"{self.device}; move it with design.to(...)"
            )
        runner = _ModelRunner(name, design, self.config)
        with self._lock:
            if name in self._runners:
                raise ValueError(f"model {name!r} already registered")
            self._runners[name] = runner
        try:
            # with a fallback, every graph is captured here on the card, so
            # a kernel that cannot build or capture fails the registration
            # instead of leaving the interpreter to serve
            if warmup or (runner._fallback_fn is not None and design.device.type == "cuda"):
                runner.warmup()
            runner.start()
        except BaseException:  # failed warmup/start must not leave a dead entry
            with self._lock:
                self._runners.pop(name, None)
            raise
        return design

    def unregister(self, name: str, timeout: float = 5.0) -> None:
        """Drop a model after draining its queues (up to ``timeout``
        seconds; requests still queued after that are failed loudly)."""
        with self._lock:
            runner = self._runners.pop(name)
        runner.stop(timeout)

    def models(self) -> list[str]:
        with self._lock:
            return sorted(self._runners)

    def _runner(self, name: str) -> _ModelRunner:
        try:
            return self._runners[name]
        except KeyError:
            raise KeyError(f"model {name!r} is not registered") from None

    # -- serving -------------------------------------------------------
    def _validate(self, name: str, runner: _ModelRunner, x) -> np.ndarray:
        x = np.asarray(x)
        if x.shape != runner.in_shape:
            raise ValueError(
                f"model {name!r} expects one sample of shape {runner.in_shape}, got {x.shape}"
            )
        if not np.issubdtype(x.dtype, np.integer):
            raise TypeError(
                f"model {name!r} expects integer-grid samples, got dtype "
                f"{x.dtype} (quantize floats with the design's in_quant first)"
            )
        return x

    def submit(self, name: str, x, deadline_s: float | None = None) -> Future:
        """Enqueue one sample (integer grid, shape ``in_shape``).

        ``deadline_s`` (relative seconds; default
        ``ServeConfig.deadline_ms``) bounds how long the request may wait
        for dispatch; on expiry the Future fails with
        :class:`DeadlineExceededError`.  May raise
        :class:`QueueFullError`, :class:`EngineClosedError`,
        :class:`ShardCrashedError` or :class:`ModelUnhealthyError`."""
        runner = self._runner(name)
        x = self._validate(name, runner, x)
        t_submit = time.perf_counter()
        return runner.submit_one(
            x, t_submit, block=self.config.backpressure != "reject",
            deadline=runner.deadline_abs(t_submit, deadline_s),
        )

    def submit_batch(self, name: str, xs, deadline_s: float | None = None) -> list[Future]:
        """Enqueue many samples at once; returns one Future per sample.

        ``xs`` is an iterable of samples or an ``[n, *in_shape]`` array;
        chunks are spread across shards.  With the "reject" policy an
        overflowing sample's Future is failed with
        :class:`QueueFullError` instead of raising; samples cut off by a
        racing shutdown are failed too.  Every returned Future resolves.
        """
        runner = self._runner(name)
        xs = [self._validate(name, runner, x) for x in xs]
        t_submit = time.perf_counter()
        return runner.submit_many(
            xs, t_submit, block=self.config.backpressure != "reject",
            deadline=runner.deadline_abs(t_submit, deadline_s),
        )

    def infer(
        self, name: str, x, timeout: float | None = 30.0, deadline_s: float | None = None
    ):
        """Synchronous single-sample wrapper.  Unless a deadline is
        configured or passed, the request carries ``deadline_s=timeout``,
        so work abandoned by an expired wait is shed, not executed;
        client-side expiries are counted in ``n_client_timeouts``."""
        if deadline_s is None:
            dms = self.config.deadline_ms
            deadline_s = dms * 1e-3 if dms is not None else timeout
        fut = self.submit(name, x, deadline_s=deadline_s)
        try:
            return fut.result(timeout)
        except FutureTimeoutError:
            try:
                self._runner(name).count_client_timeout()
            except KeyError:
                pass  # model unregistered while we waited
            raise

    def warmup(self, name: str) -> float:
        return self._runner(name).warmup()

    def stats(self, name: str | None = None) -> dict:
        if name is not None:
            return self._runner(name).stats()
        with self._lock:
            runners = list(self._runners.items())
        return {n: r.stats() for n, r in runners}

    def metrics_text(self) -> str:
        """Prometheus text exposition (format 0.0.4) over every model, as
        the JAX engine gives it: request/batch/reject counters, per-shard
        queue-depth gauges, per-bucket hit counters, per-stage wall totals
        and µs histograms, latency-percentile gauges, and the resilience
        families (shed, fast-fail, fallback and client-timeout counters,
        breaker state and trips, restarts, health).  Derived from the live
        runners, so it never disagrees with ``stats()``."""
        with self._lock:
            runners = list(self._runners.items())
        req, batches, rejected, qd, bucket, jit = [], [], [], [], [], []
        stage_tot, stage_hist, lat = [], [], []
        shed, fastf, fallb, ctime = [], [], [], []
        brk_state, brk_trips, restarts, healthy = [], [], [], []
        brk_code = {"closed": 0, "half_open": 1, "open": 2}
        for name, r in runners:
            s = r.stats()
            m = {"model": name}
            req.append((m, s["n_requests"]))
            batches.append((m, s["n_batches"]))
            rejected.append((m, s["n_rejected"]))
            jit.append((m, s["n_jit_compiles"]))
            shed.append((m, s["n_shed"]))
            fastf.append((m, s["n_fast_failed"]))
            fallb.append((m, s["n_fallback_batches"]))
            ctime.append((m, s["n_client_timeouts"]))
            brk_state.append((m, brk_code.get(s["breaker"]["state"], -1)))
            brk_trips.append((m, s["breaker"]["n_trips"]))
            restarts.append((m, s["supervision"]["n_restarts"]))
            healthy.append((m, int(s["supervision"]["healthy"])))
            for snap in s["shards"]:
                qd.append(({"model": name, "shard": snap["shard"]}, snap["queue_depth"]))
            for b, c in s["bucket_hits"].items():
                bucket.append(({"model": name, "bucket": b}, c))
            for st in StageAccumulator.STAGES:
                labels = {"model": name, "stage": st}
                stage_tot.append((labels, s["per_stage"][st]["total_ms"] / 1e3))
                stage_hist.append((labels, Histogram.merged(sh.stage_hist[st] for sh in r.shards)))
            if s["n_latency_samples"]:
                for q in ("p50", "p99"):
                    lat.append(({"model": name, "quantile": q}, s[f"{q}_ms"]))
        families = [
            ("serve_requests_total", "counter", "requests completed", req),
            ("serve_batches_total", "counter", "batches dispatched", batches),
            ("serve_rejected_total", "counter", "requests rejected by backpressure", rejected),
            ("serve_shed_total", "counter", "requests shed on an expired deadline", shed),
            ("serve_fast_failed_total", "counter",
             "requests failed fast by an open circuit breaker", fastf),
            ("serve_fallback_batches_total", "counter",
             "batches served by the interpreter fallback", fallb),
            ("serve_client_timeouts_total", "counter",
             "infer() client-side result timeouts", ctime),
            ("serve_breaker_state", "gauge",
             "circuit breaker state (0=closed 1=half_open 2=open)", brk_state),
            ("serve_breaker_trips_total", "counter",
             "circuit breaker closed->open transitions", brk_trips),
            ("serve_restarts_total", "counter",
             "dispatcher threads restarted by supervision", restarts),
            ("serve_healthy", "gauge",
             "1 while the model serves, 0 once escalated unhealthy", healthy),
            ("serve_queue_depth", "gauge", "queued requests per shard", qd),
            ("serve_bucket_hits_total", "counter", "batches dispatched per bucket shape", bucket),
            ("serve_jit_compiled_buckets", "gauge",
             "bucket shapes captured as CUDA graphs (CPU: run), summed over shards", jit),
            ("serve_stage_seconds_total", "counter",
             "wall seconds charged per dispatch stage", stage_tot),
            ("serve_stage_us", "histogram",
             "per-stage wall microseconds per batch (queue_wait: per request)", stage_hist),
            ("serve_latency_ms", "gauge", "end-to-end latency percentiles", lat),
        ]
        return render_prometheus(families)

    # -- lifecycle -----------------------------------------------------
    def shutdown(self, timeout: float = 5.0) -> None:
        """Stop all dispatchers after draining their queues."""
        with self._lock:
            runners = list(self._runners.values())
            self._runners.clear()
        for r in runners:
            r.stop(timeout)

    def __enter__(self) -> ServeEngine:
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
