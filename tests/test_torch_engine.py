"""The port's serving engine on ``device="cpu"``, mirroring
tests/test_runtime_engine.py: served results are bit-identical to the
JAX ``forward_int`` with one and two shards, shutdown never leaves a
future hanging, backpressure rejects loudly, ``stats()`` has the JAX
engine's shape, and the interpreter fallback is refused only for a
design it cannot run.  Tolerance: exact equality (integer outputs)."""

import threading
import time
from concurrent.futures import TimeoutError as FutureTimeoutError

import jax
import numpy as np
import pytest

from repro import flow as jax_flow
from repro.nn import QDense, QuantConfig, ReLU, compile_model, init_params
from repro.runtime import save_design as jax_save_design
from repro_torch.flow import ServeConfig
from repro_torch.runtime import EngineClosedError, QueueFullError, ServeEngine, load_design


@pytest.fixture(scope="module")
def designs(tmp_path_factory):
    """name -> (jitted JAX forward_int, its artifact path, the port's CPU design)."""
    root = tmp_path_factory.mktemp("engine_designs")
    wq = QuantConfig(6, 2, signed=True)
    aq = QuantConfig(8, 4, signed=False)
    in_quant = QuantConfig(8, 4, signed=True)
    out = {}
    for name, units in (("a", 6), ("b", 3)):
        model = (QDense(8, wq), ReLU(aq), QDense(units, wq))
        params, _ = init_params(jax.random.PRNGKey(ord(name)), model, (8,))
        jd = compile_model(
            model, params, (8,), in_quant,
            config=jax_flow.CompileConfig(solver=jax_flow.SolverConfig(dc=2)),
        )
        path = jax_save_design(jd, root / name)
        out[name] = (jax.jit(jd.forward_int), path, load_design(path, device="cpu"))
    return out


def _samples(n, d=8, seed=0):
    q = QuantConfig(8, 4, signed=True).qint
    return np.random.default_rng(seed).integers(q.lo, q.hi + 1, size=(n, d)).astype(np.int32)


def _jax_forward(designs, name, xs):
    return np.asarray(designs[name][0](xs))


@pytest.mark.parametrize("shards", [1, 2])
def test_results_bit_identical(designs, shards):
    xs = _samples(120)
    cfg = ServeConfig(max_batch=16, max_wait_us=100.0, shards=shards)
    with ServeEngine(cfg, device="cpu") as eng:
        eng.register("a", designs["a"][2], warmup=True)
        futs = [eng.submit("a", x) for x in xs[:60]]
        futs += eng.submit_batch("a", xs[60:])
        got = np.stack([f.result(30) for f in futs])
        s = eng.stats("a")
    np.testing.assert_array_equal(got, _jax_forward(designs, "a", xs))
    assert s["n_shards"] == shards and len(s["shards"]) == shards
    assert all(ss["n_requests"] > 0 for ss in s["shards"])
    assert s["n_fallback_batches"] == 0 and s["breaker"]["n_trips"] == 0


def test_multi_model_registry_and_artifact_path(designs):
    xs = _samples(40, seed=5)
    with ServeEngine(ServeConfig(max_batch=8, max_wait_us=100.0), device="cpu") as eng:
        eng.register("a", designs["a"][2])
        loaded = eng.register("b", designs["b"][1])  # from the artifact path
        assert loaded.solver_stats["n_solves"] == 0 and loaded.device.type == "cpu"
        assert eng.models() == ["a", "b"]
        futs = [(n, i, eng.submit(n, xs[i])) for i in range(40) for n in ("a", "b")]
        want = {n: _jax_forward(designs, n, xs) for n in ("a", "b")}
        for n, i, f in futs:
            np.testing.assert_array_equal(f.result(30), want[n][i])
        with pytest.raises(ValueError, match="already registered"):
            eng.register("a", designs["a"][2])
        with pytest.raises(ValueError, match="expects one sample"):
            eng.submit("a", np.zeros((3, 8), np.int32))
        with pytest.raises(TypeError, match="integer-grid"):
            eng.submit("a", np.zeros((8,), np.float64))
    with pytest.raises(KeyError, match="not registered"):
        eng.submit("a", xs[0])


def test_interpreter_fallback_is_refused(designs):
    """``fallback="interpreter"`` is accepted, and refused at ``register``
    for a design the interpreter cannot run (one without step specs), as
    the JAX engine refuses it; the engine keeps no entry for it."""
    design = load_design(designs["a"][1], device="cpu")
    design.step_specs = []
    with ServeEngine(ServeConfig(fallback="interpreter"), device="cpu") as eng:
        with pytest.raises(ValueError, match="no step_specs"):
            eng.register("a", design)
        assert eng.models() == []
        eng.register("b", designs["b"][2])
        assert eng.models() == ["b"]


def test_shutdown_never_leaves_hanging_futures(designs):
    eng = ServeEngine(ServeConfig(max_batch=4, max_wait_us=500_000.0), device="cpu")
    eng.register("a", designs["a"][2], warmup=True)
    f = eng.submit("a", _samples(1, seed=6)[0])
    eng.shutdown()
    try:
        assert f.result(5).shape == (6,)
    except RuntimeError as e:
        assert "shut down" in str(e)


def test_backpressure_reject(designs):
    # tiny queue + long batching window: the dispatcher waits in collect
    # while the queue floods, so submits must overflow
    cfg = ServeConfig(max_batch=4, queue_depth=4, max_wait_us=200_000.0, backpressure="reject")
    eng = ServeEngine(cfg, device="cpu")
    try:
        eng.register("a", designs["a"][2], warmup=True)
        rejected = 0
        futs = []
        for x in _samples(200, seed=1):
            try:
                futs.append(eng.submit("a", x))
            except QueueFullError:
                rejected += 1
        assert rejected > 0
        assert eng.stats("a")["n_rejected"] == rejected
        for f in futs:
            assert f.result(30).shape == (6,)
    finally:
        eng.shutdown()


def test_stats_shape(designs):
    with ServeEngine(ServeConfig(max_batch=8, max_wait_us=100.0), device="cpu") as eng:
        eng.register("a", designs["a"][2])
        s0 = eng.stats("a")
        assert s0["bucket_hits"] == {1: 0, 2: 0, 4: 0, 8: 0}
        assert s0["n_jit_compiles"] == 0
        assert eng.warmup("a") > 0
        assert eng.stats("a")["jit_compiles"] == {1: 1, 2: 1, 4: 1, 8: 1}
        for f in [eng.submit("a", x) for x in _samples(30, seed=2)]:
            f.result(30)
        s = eng.stats("a")
    assert s["n_requests"] == 30
    assert s["n_batches"] >= 1
    assert sum(s["bucket_hits"].values()) == s["n_batches"]
    assert 0 < s["mean_batch_occupancy"] <= 1.0
    for k in ("p50_ms", "p95_ms", "p99_ms", "mean_ms", "throughput_rps"):
        assert np.isfinite(s[k]) and s[k] >= 0
    assert s["buckets"][-1] == 8
    assert s["per_stage"]["dispatch"]["count"] == s["n_batches"]
    assert s["per_stage"]["queue_wait"]["count"] == 30
    assert s["device"] == "cpu"
    assert s["supervision"]["healthy"] and s["supervision"]["n_crashes"] == 0


@pytest.mark.parametrize("shards", [1, 2])
def test_shutdown_stress_no_hung_futures(designs, shards):
    """Hammer submit + submit_batch from several threads while shutdown
    proceeds: every Future handed out resolves within a bounded time."""
    eng = ServeEngine(ServeConfig(max_batch=8, max_wait_us=200.0, shards=shards), device="cpu")
    eng.register("a", designs["a"][2], warmup=True)
    xs = _samples(8, seed=10)
    futures: list = []
    flock = threading.Lock()
    stop = threading.Event()

    def hammer(i):
        n = 0
        while not stop.is_set():
            try:
                fs = eng.submit_batch("a", xs) if n % 3 == 0 else [eng.submit("a", xs[n % 8])]
            except (EngineClosedError, KeyError):
                break
            with flock:
                futures.extend(fs)
            n += 1

    threads = [threading.Thread(target=hammer, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    time.sleep(0.15)
    eng.shutdown(timeout=5.0)
    stop.set()
    for t in threads:
        t.join(5.0)
        assert not t.is_alive()
    n_ok = 0
    want = _jax_forward(designs, "a", xs)
    for f in futures:
        try:
            exc = f.exception(timeout=5.0)
        except FutureTimeoutError:
            pytest.fail("future left hanging past the resolution timeout")
        if exc is None:
            n_ok += 1
            assert any(np.array_equal(f.result(), w) for w in want)
        else:
            assert isinstance(exc, RuntimeError)
    assert n_ok > 0
