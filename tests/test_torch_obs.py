"""The port's telemetry (``repro_torch.obs``), mirroring the
telemetry cases of tests/test_obs.py: the tracer is a shared no-op when
disabled and valid Chrome trace JSON when enabled, the sharded metrics
registry merges concurrent writers without losing a count, the flight
recorder's ring and slowest-K bookkeeping are exact through wraparound,
``render_prometheus`` and the registry give the JAX package's text for
the same contents, and the serve engine (``device="cpu"``) carries
flight records, ``serve.batch`` spans and Prometheus text without
changing its results (tolerance: exact equality)."""

import json
import re
import threading

import jax
import numpy as np
import pytest

from repro.flow import CompileConfig, SolverConfig
from repro.nn import QDense, QuantConfig, compile_model, init_params
from repro.obs import metrics as jax_metrics
from repro.runtime import save_design as jax_save_design
from repro_torch.flow import ServeConfig
from repro_torch.obs import flight as flight_mod
from repro_torch.obs import solvelog, trace
from repro_torch.obs.flight import FlightRecorder
from repro_torch.obs.metrics import Histogram, MetricsRegistry, render_prometheus
from repro_torch.runtime import ServeEngine, load_design
from repro_torch.runtime.metrics import LatencyRecorder


@pytest.fixture(autouse=True)
def _clean_tracer():
    was = trace.enabled()
    trace.set_enabled(False)
    trace.reset()
    yield
    trace.set_enabled(was)
    trace.reset()


# ---------------------------------------------------------------- trace
def test_disabled_span_is_shared_noop():
    assert not trace.enabled()
    s1 = trace.span("a", k=1)
    assert s1 is trace.span("b")
    with s1:
        pass
    trace.instant("tick")
    assert trace.n_events() == 0


def test_span_records_nesting_and_args():
    trace.set_enabled(True)
    with trace.span("outer", phase="x"):
        with trace.span("inner"):
            pass
        trace.instant("mark", n=3)
    doc = trace.export()
    xs = {e["name"]: e for e in doc["traceEvents"] if e["ph"] == "X"}
    assert set(xs) == {"outer", "inner"}
    assert xs["outer"]["args"] == {"phase": "x"}
    assert xs["outer"]["dur"] >= xs["inner"]["dur"] >= 0
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] == "i"] == ["mark"]


def test_trace_ring_wraparound_counts_dropped():
    trace.set_enabled(True)
    results = {}

    def work():
        for i in range(10):
            with trace.span(f"s{i}"):
                pass
        b = trace._buf()
        results["names"] = [ev[0] for ev in b.iter_events()]
        results["n_dropped"] = b.n_dropped

    old_cap = trace._capacity
    trace.set_capacity(4)
    try:
        t = threading.Thread(target=work)
        t.start()
        t.join(10)
    finally:
        trace.set_capacity(old_cap)
    assert results["names"] == ["s6", "s7", "s8", "s9"]
    assert results["n_dropped"] == 6
    assert trace.export()["otherData"]["n_dropped"] >= 6


def test_export_is_valid_chrome_trace_json(tmp_path):
    trace.set_enabled(True)

    def work():
        with trace.span("pool.work", idx=1):
            pass

    t = threading.Thread(target=work, name="worker-0")
    t.start()
    t.join(10)
    with trace.span("main.work"):
        pass
    path = tmp_path / "trace.json"
    doc = trace.export(str(path))
    assert json.loads(path.read_text()) == doc
    xs = [e for e in doc["traceEvents"] if e["ph"] == "X"]
    ms = [e for e in doc["traceEvents"] if e["ph"] == "M"]
    assert {e["name"] for e in xs} == {"pool.work", "main.work"}
    for e in xs:
        assert {"name", "cat", "ph", "ts", "dur", "pid", "tid"} <= set(e)
        assert e["ts"] >= 0 and e["dur"] >= 0
    assert len({e["tid"] for e in xs}) == 2
    assert {e["tid"] for e in xs} <= {e["tid"] for e in ms}
    assert any(e["args"]["name"] == "worker-0" for e in ms)


# -------------------------------------------------------------- metrics
def test_registry_empty_snapshot_and_prometheus():
    reg = MetricsRegistry()
    assert reg.snapshot() == {"counters": {}, "gauges": {}, "histograms": {}}
    assert reg.to_prometheus() == "\n"


def test_registry_concurrent_writers_sum_exactly():
    reg = MetricsRegistry()
    n_threads, n_incs = 8, 500

    def work(i):
        for k in range(n_incs):
            reg.inc("ops_total", kind="w")
            reg.observe("lat_us", float(k % 100))
        reg.set_gauge("depth", i, shard=str(i))

    threads = [threading.Thread(target=work, args=(i,)) for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(30)
        assert not t.is_alive()
    snap = reg.snapshot()
    assert snap["counters"]['ops_total{kind="w"}'] == n_threads * n_incs
    assert snap["histograms"]["lat_us"]["count"] == n_threads * n_incs
    for i in range(n_threads):
        assert snap["gauges"][f'depth{{shard="{i}"}}'] == i


def test_histogram_merge_and_percentiles():
    a, b = Histogram(), Histogram()
    for v in (5.0, 50.0, 500.0):
        a.observe(v)
    b.observe(5_000.0)
    m = Histogram.merged([a, b])
    assert (m.n, m.sum) == (4, 5555.0)
    assert Histogram.merged([]).n == 0
    snap = m.snapshot()
    assert snap["buckets"][float("inf")] == 4
    cum = list(snap["buckets"].values())
    assert cum == sorted(cum)
    assert m.percentile(0) <= m.percentile(50) <= m.percentile(100)
    with pytest.raises(ValueError):
        a.merge_from(Histogram(bounds=(1.0, 2.0)))


def _fill(reg_cls, hist_cls):
    """The same contents in a registry and in explicit families."""
    reg = reg_cls()
    reg.inc("serve_requests_total", 7, model="m")
    reg.inc("serve_requests_total", 2.5, model="n")
    reg.set_gauge("serve_queue_depth", 3, model="m", shard=1)
    for v in (1.0, 40.0, 40.0, 9e9):
        reg.observe("serve_stage_us", v, stage="pad")
    h = hist_cls(bounds=(10.0, 100.0))
    for v in (5.0, 50.0, 500.0):
        h.observe(v)
    families = [
        ("stage_us", "histogram", "per-stage µs", [({"stage": "pad"}, h)]),
        ("serve_batches_total", "counter", "batches", [({"model": "m"}, 12), ({"model": "n"}, 0)]),
        ("serve_latency_ms", "gauge", "latency", [({"model": "m", "quantile": "p99"}, 0.125)]),
    ]
    return reg, families


def test_prometheus_text_equals_the_jax_package():
    """``render_prometheus`` and ``MetricsRegistry.to_prometheus`` give
    the JAX package's text, byte for byte, for the same contents."""
    reg, fams = _fill(MetricsRegistry, Histogram)
    jreg, jfams = _fill(jax_metrics.MetricsRegistry, jax_metrics.Histogram)
    assert render_prometheus(fams) == jax_metrics.render_prometheus(jfams)
    assert reg.to_prometheus() == jreg.to_prometheus()
    assert reg.snapshot() == jreg.snapshot()
    lines = render_prometheus(fams[:1]).strip().splitlines()
    assert "# TYPE stage_us histogram" in lines
    assert 'stage_us_bucket{stage="pad",le="10"} 1' in lines
    assert 'stage_us_bucket{stage="pad",le="+Inf"} 3' in lines
    assert 'stage_us_count{stage="pad"} 3' in lines


# --------------------------------------------------------------- flight
def test_flight_ring_wraparound_and_slowest_k():
    fr = FlightRecorder(capacity=8, slow_k=3)
    for i in range(20):
        fr.record(i, shard=0, bucket=16, batch_size=4, lat_us=float(i * 10),
                  stages_us=(1, 2, 3, 4, float(i)))
    snap = fr.snapshot()
    assert (snap["n_records"], snap["n_evicted"]) == (20, 12)
    assert [r["trace_id"] for r in fr.recent()] == list(range(12, 20))
    assert [r["lat_us"] for r in snap["slowest"]] == [190.0, 180.0, 170.0]
    assert snap["slowest"][0]["stages_us"] == {
        "queue_wait": 1, "batch_form": 2, "pad": 3, "dispatch": 4, "copy_out": 19.0}
    assert set(snap["slowest"][0]["stages_us"]) == set(flight_mod.STAGES)


def test_flight_merged_over_empty_and_mixed():
    assert FlightRecorder.merged([]) == {
        "n_records": 0, "capacity": 0, "n_evicted": 0, "slowest": [], "n_events": 0,
        "events": []}
    empty, busy = FlightRecorder(capacity=4, slow_k=2), FlightRecorder(capacity=4, slow_k=2)
    busy.record(1, 0, 16, 1, 100.0, (1, 1, 1, 1, 1))
    busy.record(2, 0, 16, 1, 900.0, (2, 2, 2, 2, 2))
    m = FlightRecorder.merged([empty, busy])
    assert m["n_records"] == 2 and [r["trace_id"] for r in m["slowest"]] == [2, 1]


def test_latency_reservoir_is_deterministic():
    r1, r2 = LatencyRecorder(max_samples=100, seed=3), LatencyRecorder(max_samples=100, seed=3)
    vals = [float(i) for i in range(1000)]
    for v in vals:
        r1.record(v, now=0.0)
    r2.record_many(vals, now=0.0)
    assert r1.n_total == r2.n_total == 1000 and r1.n_sampled_out == 900
    assert r1._lat == r2._lat and max(r1._lat) >= 100.0


def test_solvelog_ring_and_jsonl_sink(tmp_path):
    """The solver is not ported yet; its log is, and behaves as the JAX
    package's: a ring always, a JSONL file when a path is set."""
    solvelog.reset()
    old = solvelog.get_path()
    solvelog.set_path(str(tmp_path / "solves.jsonl"))
    try:
        solvelog.log_solve({"kind": "cmvm", "d_in": 10, "adders": 3})
    finally:
        solvelog.set_path(old)
    assert solvelog.records()[-1]["adders"] == 3
    on_disk = [json.loads(ln) for ln in (tmp_path / "solves.jsonl").read_text().splitlines()]
    assert on_disk[-1]["d_in"] == 10


# ------------------------------------------------- the instrumented engine
@pytest.fixture(scope="module")
def design(tmp_path_factory):
    wq = QuantConfig(6, 2, signed=True)
    model = (QDense(8, wq), QDense(4, wq))
    params, _ = init_params(jax.random.PRNGKey(0), model, (8,))
    jd = compile_model(model, params, (8,), QuantConfig(8, 4, signed=True),
                       config=CompileConfig(solver=SolverConfig(dc=2)))
    path = jax_save_design(jd, tmp_path_factory.mktemp("obs") / "d")
    return jax.jit(jd.forward_int), load_design(path, device="cpu")


def test_engine_stats_carry_flight_and_metrics_text(design):
    fwd, d = design
    xs = np.random.default_rng(2).integers(-8, 8, size=(32, 8)).astype(np.int32)
    with ServeEngine(ServeConfig(max_batch=8, max_wait_us=100.0, shards=2), device="cpu") as eng:
        eng.register("m", d)
        eng.warmup("m")
        got = np.stack([f.result(30) for f in [eng.submit("m", x) for x in xs]])
        stats = eng.stats("m")
        text = eng.metrics_text()
    np.testing.assert_array_equal(got, np.asarray(fwd(xs)))
    flight = stats["flight"]
    assert flight["n_records"] >= len(xs) and flight["slowest"]
    for rec in flight["slowest"]:
        assert set(rec["stages_us"]) == set(flight_mod.STAGES) and rec["lat_us"] > 0
    tids = [r["trace_id"] for r in flight["slowest"]]
    assert len(tids) == len(set(tids))  # unique across shards
    assert stats["jit_compiles"] == {1: 2, 2: 2, 4: 2, 8: 2}  # every bucket on both shards
    samples = [ln for ln in text.splitlines() if ln.strip() and not ln.startswith("#")]
    pat = re.compile(r'^[a-zA-Z_:][a-zA-Z0-9_:]*(\{[^}]*\})? [^ ]+$')
    assert samples and all(pat.match(ln) for ln in samples)
    assert f'serve_requests_total{{model="m"}} {len(xs)}' in samples
    assert 'serve_jit_compiled_buckets{model="m"} 8' in samples
    for family in ("serve_batches_total", "serve_stage_us_bucket", "serve_queue_depth"):
        assert family in text


def test_serve_batch_spans_when_tracing(design):
    """With tracing on, each dispatched batch leaves one ``serve.batch``
    span on its shard's thread; results do not change."""
    fwd, d = design
    xs = np.random.default_rng(3).integers(-8, 8, size=(12, 8)).astype(np.int32)
    trace.set_enabled(True)
    with ServeEngine(ServeConfig(max_batch=4, max_wait_us=0.0), device="cpu") as eng:
        eng.register("m", d, warmup=True)
        got = np.stack([f.result(30) for f in eng.submit_batch("m", xs)])
        n_batches = eng.stats("m")["n_batches"]
    np.testing.assert_array_equal(got, np.asarray(fwd(xs)))
    spans = [e for e in trace.export()["traceEvents"]
             if e["ph"] == "X" and e["name"] == "serve.batch"]
    assert len(spans) == n_batches and sum(e["args"]["n"] for e in spans) == len(xs)
