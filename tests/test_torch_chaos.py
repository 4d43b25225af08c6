"""The port's fault injection (``repro_torch.chaos``) and resilient
serving on ``device="cpu"``, mirroring tests/test_chaos.py case by case:

* the port's ``FaultPlan`` itself (validation, seeded replay, per-site
  independence, ``at``/``after``/``max_fires``, spec round trip), and
  that it fires the same sequence as the JAX package's for one spec and
  seed;
* dispatch failures (breaker trip, fast fail, half-open recovery, the
  interpreter fallback serving bit-exact while the breaker is open),
  gather failures, deadlines and client timeouts, dispatcher death and
  supervision;
* crash-safe artifacts (torn npz, crash before any write, crash in the
  commit window, mixed generations, quarantine, load fault);
* the resilience metric families, and the randomized soak at a small
  size: every future resolves, results that arrive are bit-exact, and
  every slab slot returns to the free list.

Designs are compiled by the JAX package and loaded by the port; results
are held against the JAX ``forward_int`` (tolerance: exact equality).
"""

import time
from concurrent.futures import TimeoutError as FutureTimeoutError

import jax
import numpy as np
import pytest
import torch

from repro import chaos as jax_chaos
from repro.flow import CompileConfig, SolverConfig
from repro.nn import QDense, QuantConfig, ReLU, compile_model, init_params
from repro.runtime import save_design as jax_save_design
from repro_torch.chaos import FaultInjectedError, FaultPlan, FaultRule, active, plan_from_spec
from repro_torch.flow import ServeConfig
from repro_torch.kernels._build import KernelError
from repro_torch.runtime import (
    ArtifactCorruptError,
    CircuitOpenError,
    DeadlineExceededError,
    ModelUnhealthyError,
    ServeEngine,
    load_design,
    save_design,
)
from repro_torch.runtime.engine import _Shard, _device_fault

IN_QUANT = QuantConfig(8, 4, signed=True)


def _compile(key):
    wq = QuantConfig(6, 2, signed=True)
    aq = QuantConfig(8, 4, signed=False)
    model = (QDense(8, wq), ReLU(aq), QDense(6, wq))
    params, _ = init_params(jax.random.PRNGKey(key), model, (8,))
    return compile_model(model, params, (8,), IN_QUANT,
                         config=CompileConfig(solver=SolverConfig(dc=2)))


@pytest.fixture(scope="module")
def jax_design():
    return _compile(7)


@pytest.fixture(scope="module")
def design(jax_design, tmp_path_factory):
    """The JAX design loaded by the port onto the CPU."""
    return load_design(jax_save_design(jax_design, tmp_path_factory.mktemp("chaos") / "d"),
                       device="cpu")


@pytest.fixture(scope="module")
def design2(tmp_path_factory):
    """A second design with other weights (mixed-generation artifacts)."""
    path = jax_save_design(_compile(8), tmp_path_factory.mktemp("chaos2") / "d")
    return load_design(path, device="cpu")


def _samples(n, seed=0, d=8):
    q = IN_QUANT.qint
    return np.random.default_rng(seed).integers(q.lo, q.hi + 1, size=(n, d)).astype(np.int32)


def _want(jax_design, xs):
    return np.asarray(jax.jit(jax_design.forward_int)(xs))


def _engine(design, **overrides):
    base = dict(max_batch=8, max_wait_us=0.0, shards=1)
    base.update(overrides)
    eng = ServeEngine(ServeConfig(**base), device="cpu")
    eng.register("m", design, warmup=True)
    return eng


def _drain(futures, timeout=10.0):
    oks, errs = [], []
    for f in futures:
        try:
            exc = f.exception(timeout=timeout)
        except FutureTimeoutError:
            pytest.fail("future left hanging past the resolution timeout")
        (errs if exc is not None else oks).append(exc if exc is not None else f.result(0))
    return oks, errs


def _free_lists_full(eng, name="m"):
    """Once traffic has drained, every slab slot of every shard (live and
    retired) is back on the free list."""
    runner = eng._runner(name)
    with runner._restart_lock:
        shards = list(runner._retired) + list(runner.shards)
    for sh in shards:
        with sh._lock:
            assert len(sh._free) == sh.slab.shape[0], f"shard {sh.idx} leaked slab slots"
            assert not sh._pending


# -- FaultPlan mechanics ---------------------------------------------------
def test_fault_rule_validation():
    with pytest.raises(ValueError, match="unknown fault site"):
        FaultRule("serve.nonsense")
    with pytest.raises(ValueError, match="unknown fault mode"):
        FaultRule("serve.dispatch", mode="explode")
    with pytest.raises(ValueError, match="rate must be in"):
        FaultRule("serve.dispatch", rate=1.5)
    with pytest.raises(ValueError, match="either rate or at"):
        FaultRule("serve.dispatch", rate=0.5, at=(1,))


def test_fault_plan_replays_identically():
    def schedule(plan, n=200):
        return [plan.check("serve.dispatch") is not None for _ in range(n)]

    p1 = FaultPlan([FaultRule("serve.dispatch", rate=0.3)], seed=42)
    s1 = schedule(p1)
    p1.reset()
    assert schedule(p1) == s1
    assert schedule(FaultPlan([FaultRule("serve.dispatch", rate=0.3)], seed=42)) == s1
    assert schedule(FaultPlan([FaultRule("serve.dispatch", rate=0.3)], seed=43)) != s1
    assert any(s1)


def test_fault_plan_per_site_independence():
    rules = [FaultRule("serve.dispatch", rate=0.3), FaultRule("serve.gather", rate=0.3)]
    pure = FaultPlan(rules, seed=9)
    want = [pure.check("serve.dispatch") is not None for _ in range(100)]
    mixed = FaultPlan(rules, seed=9)
    got = []
    for i in range(100):
        if i % 3 == 0:
            mixed.check("serve.gather")
        got.append(mixed.check("serve.dispatch") is not None)
    assert got == want


def test_fault_plan_at_after_max_fires():
    plan = FaultPlan([FaultRule("serve.dispatch", at=(1, 3, 4), after=2, max_fires=1)])
    fires = [plan.check("serve.dispatch") is not None for _ in range(6)]
    assert fires == [False, False, False, True, False, False]
    assert plan.stats()["sites"]["serve.dispatch"] == {"hits": 6, "fires": 1}


def test_plan_from_spec_round_trip():
    spec = {"seed": 5, "rules": [
        {"site": "serve.dispatch", "mode": "raise", "rate": 0.1},
        {"site": "artifact.save.truncate", "mode": "truncate", "at": [0]},
    ]}
    plan = plan_from_spec(spec)
    assert plan.seed == 5 and len(plan.rules) == 2
    assert plan_from_spec(plan.to_dict()).to_dict() == plan.to_dict()


@pytest.mark.parametrize("seed", [0, 7, 1234])
def test_fault_plan_fires_as_the_jax_package_does(seed):
    """One spec and seed: the port's plan and the JAX package's fire the
    same sequence at every site, interleaved the same way."""
    spec = {"seed": seed, "rules": [
        {"site": "serve.dispatch", "mode": "raise", "rate": 0.2},
        {"site": "serve.gather", "mode": "delay", "rate": 0.05, "delay_s": 0.001},
        {"site": "serve.dispatcher", "mode": "kill_thread", "rate": 0.1, "max_fires": 3},
        {"site": "artifact.save.commit", "at": [1, 4], "after": 2},
    ]}
    port, ref = plan_from_spec(spec), jax_chaos.plan_from_spec(spec)
    assert port.to_dict() == ref.to_dict()
    sites = [r["site"] for r in spec["rules"]]
    order = np.random.default_rng(seed).integers(len(sites), size=600)
    got = [port.check(sites[i]) for i in order]
    want = [ref.check(sites[i]) for i in order]
    assert got == want and any(g is not None for g in got)
    assert port.stats() == ref.stats()


def test_disabled_fault_point_does_no_work(monkeypatch):
    """With no plan installed a fault point reads one global and returns:
    it touches no plan, lock or clock (the serve path's cost of carrying
    the sites)."""
    from repro_torch.chaos import plan as plan_mod

    def forbidden(*a, **k):
        raise AssertionError("a disabled fault point reached the plan")

    monkeypatch.setattr(plan_mod.FaultPlan, "check", forbidden)
    monkeypatch.setattr(plan_mod.time, "sleep", forbidden)
    assert plan_mod.get_plan() is None
    for site in plan_mod.SITES:
        plan_mod.fault_point(site)
        plan_mod.io_fault(site, "/nonexistent")


# -- interpreter fallback ----------------------------------------------------
def test_interpreter_fallback_serves_bit_exact_while_open(design, jax_design):
    """With fallback="interpreter" and the device path failing on every
    dispatch, every request is still answered, bit-exactly, through the
    numpy interpreter, and the breaker sits open."""
    plan = FaultPlan([FaultRule("serve.dispatch", rate=1.0)])
    with active(plan):
        eng = _engine(design, fallback="interpreter", breaker_threshold=2,
                      breaker_cooldown_ms=50.0)
        try:
            xs = _samples(24, seed=4)
            got = np.stack([f.result(10) for f in [eng.submit("m", x) for x in xs]])
            np.testing.assert_array_equal(got, _want(jax_design, xs))
            s = eng.stats("m")
            assert s["breaker"]["state"] == "open"
            assert s["n_fallback_batches"] > 0
            assert s["n_requests"] == 24  # nothing failed
            text = eng.metrics_text()
            assert f'serve_fallback_batches_total{{model="m"}} {s["n_fallback_batches"]}' in text
        finally:
            eng.shutdown()


def test_fallback_also_serves_a_batch_whose_dispatch_raised(design, jax_design):
    """A dispatch that raises with the breaker closed is served by the
    fallback too (and counted as a failure by the breaker)."""
    plan = FaultPlan([FaultRule("serve.dispatch", at=(0,))])
    with active(plan):
        eng = _engine(design, fallback="interpreter", breaker_threshold=3)
        try:
            xs = _samples(3, seed=16)
            want = _want(jax_design, xs)
            for i in range(3):
                np.testing.assert_array_equal(eng.submit("m", xs[i]).result(10), want[i])
            s = eng.stats("m")
            assert s["n_fallback_batches"] == 1 and s["breaker"]["state"] == "closed"
            faults = [e for e in s["flight"]["events"] if e["kind"] == "dispatch_fault"]
            assert len(faults) == 1 and faults[0]["fallback"] and not faults[0]["device"]
            assert faults[0]["error"].startswith("FaultInjectedError(")
        finally:
            eng.shutdown()


@pytest.mark.parametrize("fault", [
    KernelError("adder-graph kernel launch failed: invalid argument (cudaError 1)"),
    RuntimeError("CUDA error: an illegal memory access was encountered"),
], ids=["kernel", "cuda"])
def test_fallback_never_serves_in_place_of_a_failed_device(design, jax_design, fault,
                                                           monkeypatch):
    """A dispatch that fails on the card itself (a kernel that does not
    build, load, launch or capture, or a CUDA error) fails its batch even
    with the fallback configured, and the open breaker then fails fast
    instead of serving from the interpreter, until a device dispatch
    succeeds again."""
    real = _Shard.run_bucket
    failing = [True]

    def run_bucket(self, b):
        if failing[0]:
            raise fault
        return real(self, b)

    monkeypatch.setattr(_Shard, "run_bucket", run_bucket)
    eng = _engine(design, fallback="interpreter", breaker_threshold=2,
                  breaker_cooldown_ms=50.0)
    try:
        xs = _samples(5, seed=18)
        want = _want(jax_design, xs)
        for i in range(2):
            with pytest.raises(type(fault)):
                eng.submit("m", xs[i]).result(10)
        s = eng.stats("m")
        assert s["breaker"]["state"] == "open" and s["n_fallback_batches"] == 0
        with pytest.raises(CircuitOpenError, match="the device failed"):
            eng.submit("m", xs[2]).result(10)
        faults = [e for e in s["flight"]["events"] if e["kind"] == "dispatch_fault"]
        assert len(faults) == 2
        assert all(f["device"] and not f["fallback"] and f["error"] == repr(fault)
                   for f in faults)
        failing[0] = False
        time.sleep(0.08)  # past the cooldown: the probe reaches the device
        np.testing.assert_array_equal(eng.submit("m", xs[3]).result(10), want[3])
        s = eng.stats("m")
        assert s["breaker"]["state"] == "closed" and s["n_fallback_batches"] == 0
        assert eng._runner("m").device_fault is None
        np.testing.assert_array_equal(eng.submit("m", xs[4]).result(10), want[4])
        _free_lists_full(eng)
    finally:
        eng.shutdown()


def test_device_fault_classification():
    """What counts as the card failing: the kernels' own error, a CUDA
    error, a device out of memory; not an injected or a host-side fault."""
    assert _device_fault(KernelError("nvcc failed for adder_graph"))
    assert _device_fault(RuntimeError("CUDA error: device-side assert triggered"))
    assert _device_fault(torch.cuda.OutOfMemoryError("out of memory"))
    assert not _device_fault(FaultInjectedError("serve.dispatch", 0))
    assert not _device_fault(ValueError("bad shape"))
    assert not _device_fault(RuntimeError("queue closed"))


def test_without_fallback_a_failing_dispatch_fails_its_batch(design):
    """The default fallback "none": a dispatch failure fails the batch; no
    interpreter carries on in its place."""
    plan = FaultPlan([FaultRule("serve.dispatch", at=(0,))])
    with active(plan):
        eng = _engine(design)
        try:
            with pytest.raises(FaultInjectedError):
                eng.submit("m", _samples(1, seed=17)[0]).result(10)
            assert eng.stats("m")["n_fallback_batches"] == 0
        finally:
            eng.shutdown()


# -- dispatch failures: breaker trip / fast fail / recovery -------------------
def test_dispatch_fault_fails_future_and_trips_breaker(design):
    plan = FaultPlan([FaultRule("serve.dispatch", at=(0, 1))])
    with active(plan):
        eng = _engine(design, breaker_threshold=2, breaker_cooldown_ms=60_000.0,
                      breaker_cooldown_max_ms=60_000.0)
        try:
            xs = _samples(3, seed=2)
            for i in range(2):
                with pytest.raises(FaultInjectedError):
                    eng.submit("m", xs[i]).result(10)
            s = eng.stats("m")
            assert s["breaker"]["state"] == "open" and s["breaker"]["n_trips"] == 1
            with pytest.raises(CircuitOpenError):
                eng.submit("m", xs[2]).result(10)
            s = eng.stats("m")
            assert s["n_fast_failed"] == 1
            assert "breaker_open" in {e["kind"] for e in s["flight"]["events"]}
        finally:
            eng.shutdown()
        assert plan.stats()["sites"]["serve.dispatch"]["fires"] == 2


def test_breaker_half_open_recovery(design, jax_design):
    plan = FaultPlan([FaultRule("serve.dispatch", at=(0, 1))])
    with active(plan):
        eng = _engine(design, breaker_threshold=2, breaker_cooldown_ms=50.0)
        try:
            xs = _samples(4, seed=3)
            want = _want(jax_design, xs)
            for i in range(2):
                with pytest.raises(FaultInjectedError):
                    eng.submit("m", xs[i]).result(10)
            assert eng.stats("m")["breaker"]["state"] == "open"
            time.sleep(0.08)  # past the cooldown: the next batch is the probe
            np.testing.assert_array_equal(eng.submit("m", xs[2]).result(10), want[2])
            s = eng.stats("m")
            assert s["breaker"]["state"] == "closed" and s["breaker"]["n_recoveries"] == 1
            np.testing.assert_array_equal(eng.submit("m", xs[3]).result(10), want[3])
            assert {"breaker_open", "breaker_closed"} <= {e["kind"] for e in s["flight"]["events"]}
        finally:
            eng.shutdown()


# -- gather failures ---------------------------------------------------------
def test_gather_fault_fails_batch_but_not_engine(design, jax_design):
    plan = FaultPlan([FaultRule("serve.gather", at=(0,))])
    with active(plan):
        eng = _engine(design)
        try:
            xs = _samples(5, seed=5)
            want = _want(jax_design, xs)
            with pytest.raises(FaultInjectedError):
                eng.submit("m", xs[0]).result(10)
            for i in range(1, 5):
                np.testing.assert_array_equal(eng.submit("m", xs[i]).result(10), want[i])
            assert eng.stats("m")["breaker"]["state"] == "closed"
            _free_lists_full(eng)
        finally:
            eng.shutdown()


# -- deadlines and client timeouts ------------------------------------------
def test_expired_deadline_shed_at_the_door(design):
    eng = _engine(design)
    try:
        with pytest.raises(DeadlineExceededError):
            eng.submit("m", _samples(1, seed=6)[0], deadline_s=0.0).result(5)
        assert eng.stats("m")["n_shed"] == 1
    finally:
        eng.shutdown()


def test_deadline_shed_at_batch_form(design):
    plan = FaultPlan([FaultRule("serve.dispatch", mode="delay", at=(0,), delay_s=0.3)])
    with active(plan):
        eng = _engine(design)
        try:
            xs = _samples(2, seed=7)
            slow = eng.submit("m", xs[0])
            time.sleep(0.05)
            doomed = eng.submit("m", xs[1], deadline_s=0.05)
            assert slow.result(10).shape == (6,)
            with pytest.raises(DeadlineExceededError):
                doomed.result(10)
            assert eng.stats("m")["n_shed"] == 1
            _free_lists_full(eng)
        finally:
            eng.shutdown()


def test_client_timeout_counted_and_work_shed(design):
    plan = FaultPlan([FaultRule("serve.dispatch", mode="delay", at=(0,), delay_s=0.4)])
    with active(plan):
        eng = _engine(design)
        try:
            xs = _samples(2, seed=9)
            blocker = eng.submit("m", xs[0])
            # wait until the blocker is inside its delayed dispatch, so the
            # second request queues behind it rather than joining its batch
            t_end = time.perf_counter() + 5.0
            while (plan.stats()["sites"].get("serve.dispatch", {}).get("fires", 0) == 0
                   and time.perf_counter() < t_end):
                time.sleep(0.005)
            with pytest.raises(FutureTimeoutError):
                eng.infer("m", xs[1], timeout=0.05)
            assert blocker.result(10).shape == (6,)
            # the abandoned request is shed when the dispatcher forms its
            # next batch, after the blocker's future is already set
            t_end = time.perf_counter() + 5.0
            while eng.stats("m")["n_shed"] < 1 and time.perf_counter() < t_end:
                time.sleep(0.005)
            s = eng.stats("m")
            assert s["n_client_timeouts"] == 1 and s["n_shed"] == 1
        finally:
            eng.shutdown()


# -- dispatcher death and supervision -----------------------------------------
def test_supervised_restart_serves_through_thread_death(design, jax_design):
    plan = FaultPlan([FaultRule("serve.dispatcher", mode="kill_thread", at=(0,))])
    with active(plan):
        eng = _engine(design, supervise=True, restart_budget=2)
        try:
            xs = _samples(8, seed=10)
            got = np.stack([f.result(10) for f in [eng.submit("m", x) for x in xs]])
            np.testing.assert_array_equal(got, _want(jax_design, xs))
            s = eng.stats("m")
            sup = s["supervision"]
            assert sup["healthy"] and sup["n_restarts"] == 1 and sup["n_crashes"] == 1
            assert any(snap["retired"] for snap in s["shards"])
            assert {"shard_crash", "shard_restart"} <= {e["kind"] for e in s["flight"]["events"]}
            _free_lists_full(eng)
        finally:
            eng.shutdown()


def test_restart_budget_exhaustion_escalates_unhealthy(design):
    plan = FaultPlan([FaultRule("serve.dispatcher", mode="kill_thread", at=(0,))])
    with active(plan):
        eng = _engine(design, supervise=True, restart_budget=0)
        try:
            deadline = time.perf_counter() + 5.0
            while time.perf_counter() < deadline and eng.stats("m")["supervision"]["healthy"]:
                time.sleep(0.02)
            s = eng.stats("m")
            assert not s["supervision"]["healthy"]
            with pytest.raises(ModelUnhealthyError):
                eng.submit("m", _samples(1, seed=11)[0])
            assert "model_unhealthy" in {e["kind"] for e in s["flight"]["events"]}
        finally:
            eng.shutdown()


def test_unsupervised_crash_fails_fast_and_stop_does_not_hang(design):
    plan = FaultPlan([FaultRule("serve.dispatch", mode="kill_thread", at=(0,))])
    with active(plan):
        eng = _engine(design, supervise=False)
        _, errs = _drain([eng.submit("m", x) for x in _samples(6, seed=12)], timeout=5.0)
        assert errs and all(isinstance(e, RuntimeError) for e in errs)
        assert not eng.stats("m")["supervision"]["healthy"]
        _free_lists_full(eng)
        t0 = time.perf_counter()
        eng.shutdown(timeout=5.0)
        assert time.perf_counter() - t0 < 3.0


# -- crash-safe artifacts ------------------------------------------------------
def test_torn_npz_write_is_detected(design, tmp_path):
    with active(FaultPlan([FaultRule("artifact.save.truncate", mode="truncate", at=(0,))])):
        save_design(design, tmp_path / "d")
    with pytest.raises(ArtifactCorruptError):
        load_design(tmp_path / "d", device="cpu")


def test_crash_before_any_write_preserves_previous_artifact(design, jax_design, tmp_path):
    path = save_design(design, tmp_path / "d")
    xs = _samples(4, seed=13)
    with active(FaultPlan([FaultRule("artifact.save.arrays", at=(0,))])):
        with pytest.raises(FaultInjectedError):
            save_design(design, path)
    got = load_design(path, device="cpu").forward_int(torch.from_numpy(xs)).numpy()
    np.testing.assert_array_equal(got, _want(jax_design, xs))


def test_crash_inside_commit_window_never_commits(design, tmp_path):
    with active(FaultPlan([FaultRule("artifact.save.commit", at=(0,))])):
        with pytest.raises(FaultInjectedError):
            save_design(design, tmp_path / "d")
    assert (tmp_path / "d" / "design.npz").exists()
    assert not (tmp_path / "d" / "manifest.json").exists()
    with pytest.raises(ArtifactCorruptError, match="never committed"):
        load_design(tmp_path / "d", device="cpu")


def test_mixed_generation_after_partial_resave(design, design2, tmp_path):
    path = save_design(design, tmp_path / "d")
    with active(FaultPlan([FaultRule("artifact.save.commit", at=(0,))])):
        with pytest.raises(FaultInjectedError):
            save_design(design2, path)
    with pytest.raises(ArtifactCorruptError, match="does not match"):
        load_design(path, device="cpu")


def test_quarantine_moves_corrupt_artifact_aside(design, tmp_path):
    with active(FaultPlan([FaultRule("artifact.save.truncate", mode="truncate", at=(0,))])):
        save_design(design, tmp_path / "d")
    with pytest.raises(ArtifactCorruptError) as ei:
        load_design(tmp_path / "d", device="cpu", on_corrupt="quarantine")
    assert not (tmp_path / "d").exists()
    q = ei.value.quarantined_to
    assert q is not None and q.exists() and q.name == "d.quarantined"
    with pytest.raises(FileNotFoundError):
        load_design(tmp_path / "d", device="cpu", on_corrupt="quarantine")


def test_injected_load_read_fault(design, tmp_path):
    path = save_design(design, tmp_path / "d")
    with active(FaultPlan([FaultRule("artifact.load.read", at=(0,))])):
        with pytest.raises(FaultInjectedError):
            load_design(path, device="cpu")
    assert load_design(path, device="cpu") is not None


# -- metrics surface --------------------------------------------------------------
def test_resilience_metrics_families_exposed(design):
    eng = _engine(design)
    try:
        eng.submit("m", _samples(1, seed=14)[0]).result(10)
        text = eng.metrics_text()
        for family in ("serve_shed_total", "serve_client_timeouts_total",
                       "serve_fallback_batches_total", "serve_fast_failed_total",
                       "serve_breaker_state", "serve_breaker_trips_total",
                       "serve_restarts_total", "serve_healthy"):
            assert family in text
        s = eng.stats("m")
        assert s["breaker"]["state"] == "closed" and s["supervision"]["healthy"]
    finally:
        eng.shutdown()


# -- randomized soak --------------------------------------------------------------
@pytest.mark.parametrize("shards", [1, 4])
def test_chaos_soak_every_future_resolves(design, jax_design, shards):
    """Seeded faults over {dispatch failure, gather failure, thread kill}
    with the interpreter fallback armed: every future resolves, results
    that arrive are bit-exact, and every slab slot returns."""
    plan = FaultPlan([
        FaultRule("serve.dispatch", rate=0.05),
        FaultRule("serve.gather", rate=0.02),
        FaultRule("serve.dispatcher", mode="kill_thread", rate=0.02, max_fires=2),
    ], seed=1234)
    with active(plan):
        eng = ServeEngine(ServeConfig(
            max_batch=8, max_wait_us=200.0, shards=shards, fallback="interpreter",
            breaker_threshold=4, breaker_cooldown_ms=20.0, supervise=True, restart_budget=4,
        ), device="cpu")
        eng.register("m", design, warmup=True)
        try:
            xs = _samples(240, seed=15)
            want = _want(jax_design, xs)
            futs = []
            for i in range(0, 240, 12):
                chunk = xs[i:i + 12]
                if (i // 12) % 3 == 0:
                    futs.extend(eng.submit_batch("m", chunk))
                else:
                    futs.extend(eng.submit("m", x) for x in chunk)
            oks = errs = 0
            for i, f in enumerate(futs):
                try:
                    exc = f.exception(timeout=15.0)
                except FutureTimeoutError:
                    pytest.fail(f"future {i} hung under chaos")
                if exc is None:
                    np.testing.assert_array_equal(f.result(0), want[i])
                    oks += 1
                else:
                    assert isinstance(exc, RuntimeError), exc
                    errs += 1
            assert oks + errs == 240 and oks > 0
            _free_lists_full(eng)
            assert eng.stats("m")["supervision"]["n_crashes"] <= 2
        finally:
            eng.shutdown()
        assert plan.stats()["sites"]["serve.dispatch"]["hits"] > 0
