"""repro_torch.obs — telemetry of the port: span tracing, metrics, flight
recorder.

A copy of the JAX package's ``obs`` layer (stdlib only), so the port
imports nothing of that package.  The serve engine consumes it; the
solver and the compiler will once they are ported.  The environment
variables are the JAX package's own (``REPRO_TRACE``,
``REPRO_TRACE_CAPACITY``, ``REPRO_SOLVE_LOG``):

``repro_torch.obs.trace``
    Low-overhead span tracer with per-thread ring buffers and a Chrome
    trace-event / Perfetto JSON exporter.  Disabled by default; enable
    with ``REPRO_TRACE=1`` or :func:`trace.set_enabled`.

``repro_torch.obs.metrics``
    Process-wide registry of counters / gauges / histograms with
    single-writer per-thread shards merged at snapshot, plus JSON and
    Prometheus-text exposition.

``repro_torch.obs.flight``
    Per-shard flight recorder: a bounded ring of per-request records
    with tail-sampling that pins the slowest-K requests' full per-stage
    breakdowns for postmortem p99 triage.

``repro_torch.obs.solvelog``
    Structured per-solve result records (matrix statistics → adders /
    cost / depth / wall) kept in a bounded in-memory ring and optionally
    appended to a JSONL file — the training log for a future learned
    resource predictor.

Everything here is stdlib only; importing ``repro_torch.obs`` pulls in
neither torch nor jax.
"""

from . import flight, metrics, solvelog, trace
from .flight import FlightRecorder
from .metrics import Histogram, MetricsRegistry, get_registry

__all__ = [
    "FlightRecorder",
    "Histogram",
    "MetricsRegistry",
    "flight",
    "get_registry",
    "metrics",
    "solvelog",
    "trace",
]
