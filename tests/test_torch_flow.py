"""The port's flow facade (``repro_torch.flow``: ``Flow``, ``Deployment``)
and the legacy option kwargs of ``solve_cmvm``, ``compile_model`` and
``ServeEngine``, on ``device="cpu"``, against the JAX package: the
behaviour of tests/test_flow_api.py and tests/test_deployment.py.

* ``Flow.compile`` gives the JAX ``Flow.compile``'s ``arrays_sha256`` on
  the same weights (carried across with ``params_from_numpy``), and the
  committed ``params.npz`` of mixer_full and svhn_cnn compile through it
  to the committed (JAX-written) digests;
* each legacy spelling warns ``DeprecationWarning`` and equals the config
  spelling: the same programs, digests and cache keys (and the JAX
  package's legacy spelling's); mixing the two raises ``TypeError``, a
  config of the wrong type ``ConfigError``;
* rollout: v1's queued futures complete with v1's results while v2
  serves, explicit versions and rollback, registry isolation, a drained
  version's dispatchers release their buffers;
* ``submit_batch`` bit-identical to ``submit``; the reject policy fails
  futures, not the batch.

Tolerance: exact equality throughout (integer designs, digests, keys).
"""

import dataclasses
import json
import subprocess
import sys
import warnings
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from repro import core as jcore
from repro import flow as jflow
from repro import nn as jnn
from repro.runtime import save_design as jsave
from repro_torch import nn as tnn
from repro_torch.core import QInterval, SolutionCache, config_solve_key, solve_cmvm
from repro_torch.flow import (
    UNSET,
    CompileConfig,
    ConfigError,
    Deployment,
    Design,
    Flow,
    ServeConfig,
    SolverConfig,
)
from repro_torch.runtime import QueueFullError, ServeEngine, load_design, save_design

ROOT = Path(__file__).resolve().parent.parent
ASSETS = ROOT / "src" / "repro_torch" / "assets"
IN_QUANT = (8, 4, True)


def _legacy(fn, *args, **kw):
    """Call a deprecated-kwarg shim with its warning silenced."""
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", DeprecationWarning)
        return fn(*args, **kw)


def _mat(d_in=8, d_out=8, seed=0):
    return np.random.default_rng(seed).integers(-128, 128, size=(d_in, d_out))


def _tiny_model(pkg):
    wq = pkg.QuantConfig(6, 2, signed=True)
    aq = pkg.QuantConfig(8, 4, signed=False)
    return (pkg.QDense(6, wq), pkg.ReLU(aq), pkg.QDense(4, wq))


@pytest.fixture(scope="module")
def tiny():
    """(JAX model, port model, in_shape, JAX in_quant, port in_quant, JAX
    params, port params on the CPU)."""
    params, _ = jnn.init_params(jax.random.PRNGKey(0), _tiny_model(jnn), (8,))
    tparams = tnn.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return (_tiny_model(jnn), _tiny_model(tnn), (8,), jnn.QuantConfig(*IN_QUANT),
            tnn.QuantConfig(*IN_QUANT), params, tparams)


def _manifest(design, save, path):
    return json.loads((save(design, path) / "manifest.json").read_text())


def _fwd(design, xs):
    """A port design's ``forward_int`` of numpy samples, as numpy."""
    return design.forward_int(torch.from_numpy(xs)).numpy()


def _samples(n, seed=0):
    rng = np.random.default_rng(seed)
    return np.asarray(rng.integers(-8, 8, size=(n, 8)), np.int32)


# ----------------------------------------------------------------------
# Flow.compile against the JAX package's
# ----------------------------------------------------------------------
NETWORKS = {
    "tiny": lambda pkg: (_tiny_model(pkg), (8,), pkg.QuantConfig(*IN_QUANT)),
    "jet_tagger": lambda pkg: pkg.models.jet_tagger(),
    "muon_tracker": lambda pkg: pkg.models.muon_tracker(),
}


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_flow_compile_gives_the_jax_digest(name, tmp_path):
    jmodel, in_shape, jiq = NETWORKS[name](jnn)
    tmodel, _, tiq = NETWORKS[name](tnn)
    params = jax.jit(lambda k: jnn.init_params(k, jmodel, in_shape)[0])(jax.random.PRNGKey(3))
    cfg = dict(jobs=1, solver=dict(dc=2, engine="batch"))
    jd = jflow.Flow.compile(jmodel, params, in_shape, jiq,
                            config=jflow.CompileConfig.from_dict(cfg))
    td = Flow.compile(tmodel, tnn.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
                      in_shape, tiq, config=CompileConfig.from_dict(cfg), device="cpu")
    want = _manifest(jd, jsave, tmp_path / "jax")
    got = _manifest(td, save_design, tmp_path / "port")
    assert got["arrays_sha256"] == want["arrays_sha256"]
    assert got["compile_config_digest"] == want["compile_config_digest"]
    assert got["resources"] == want["resources"]


@pytest.mark.parametrize("name", ["mixer_full", "svhn_cnn"])
def test_flow_compile_of_committed_params_gives_committed_digest(name, tmp_path):
    """The committed manifests were written by the JAX package's compile
    of the same ``params.npz`` (tools/make_torch_assets.py)."""
    model, in_shape, in_quant = (tnn.models.mlp_mixer_jet(full_size=True)
                                 if name == "mixer_full" else tnn.models.svhn_cnn())
    committed = json.loads((ASSETS / name / "manifest.json").read_text())
    with np.load(ASSETS / name / "params.npz") as z:
        params = tnn.params_from_numpy(z, device="cpu", model=model)
    cfg = CompileConfig.from_dict({**committed["compile_config"], "jobs": None})
    design = Flow.compile(model, params, in_shape, in_quant, config=cfg, device="cpu")
    got = _manifest(design, save_design, tmp_path / name)
    assert got["arrays_sha256"] == committed["arrays_sha256"]
    assert got["compile_config_digest"] == committed["compile_config_digest"]


def test_wrong_config_type_rejected(tiny):
    _, tmodel, in_shape, _, tiq, _, tparams = tiny
    with pytest.raises(ConfigError, match="CompileConfig"):
        Flow.compile(tmodel, tparams, in_shape, tiq, config=SolverConfig(), device="cpu")
    with pytest.raises(ConfigError, match="SolverConfig"):
        solve_cmvm(_mat(), config=CompileConfig())
    with pytest.raises(ConfigError, match="ServeConfig"):
        ServeEngine(config=SolverConfig(), device="cpu")
    # the JAX package's positional legacy spelling: the port takes config
    # first, so a bare max_batch lands in config and is refused
    with pytest.raises(ConfigError, match="ServeConfig"):
        ServeEngine(256, device="cpu")


def test_design_config_does_not_pin_live_cache(tiny):
    _, tmodel, in_shape, _, tiq, _, tparams = tiny
    design = Flow.compile(tmodel, tparams, in_shape, tiq,
                          config=CompileConfig(jobs=1, cache=SolutionCache()), device="cpu")
    assert design.config.cache is None
    assert design.config.digest() == CompileConfig(jobs=1).digest()


# ----------------------------------------------------------------------
# the legacy spellings
# ----------------------------------------------------------------------
LEGACY_SOLVER = [  # legacy kwarg -> (value, SolverConfig field)
    ("dc", 2, "dc"),
    ("decompose_stage", False, "decompose"),
    ("weighted", False, "weighted"),
    ("assembly_dedup", False, "dedup"),
    ("depth_weight", 0.5, "depth_weight"),
    ("engine", "heap", "engine"),
]


@pytest.mark.parametrize("kwarg,value,field", LEGACY_SOLVER)
def test_solve_cmvm_legacy_kwarg_warns_and_equals_config(kwarg, value, field):
    m = _mat(seed=7)
    with pytest.warns(DeprecationWarning, match=r"repro_torch\.flow\.SolverConfig"):
        legacy = solve_cmvm(m, **{kwarg: value})
    cfg = solve_cmvm(m, config=SolverConfig(**{field: value}))
    ref = _legacy(jcore.solve_cmvm, m, **{kwarg: value})
    a, b, c = legacy.program.to_arrays(), cfg.program.to_arrays(), ref.program.to_arrays()
    assert sorted(a) == sorted(b) == sorted(c)
    for k in a:
        np.testing.assert_array_equal(a[k], b[k])
        np.testing.assert_array_equal(a[k], c[k])


def test_solve_cmvm_legacy_shares_cache_keys():
    m = _mat(6, 5, seed=3)
    cache = SolutionCache()
    _legacy(solve_cmvm, m, dc=2, engine="arena", cache=cache)
    assert cache.stats.puts == 1
    qin8 = [QInterval.from_fixed(True, 8, 8)] * 6
    key = config_solve_key(m, qin8, [0] * 6, SolverConfig(dc=2, engine="arena"))
    assert cache.get(key) is not None
    hot = solve_cmvm(m, config=SolverConfig(dc=2, engine="arena"), cache=cache)
    assert hot.stats.get("cache_hit")


def test_mixed_spellings_raise(tiny):
    _, tmodel, in_shape, _, tiq, _, tparams = tiny
    with pytest.raises(TypeError, match="not both"):
        solve_cmvm(_mat(), dc=2, config=SolverConfig())
    with pytest.raises(TypeError, match="not both"):
        tnn.compile_model(tmodel, tparams, in_shape, tiq, dc=2, config=CompileConfig(),
                          device="cpu")
    with pytest.raises(TypeError, match="not both"):
        ServeEngine(ServeConfig(), device="cpu", max_batch=8)


@pytest.mark.parametrize("strategy", ["da", "latency"])
@pytest.mark.parametrize("engine", ["batch", "heap", "arena"])
def test_compile_model_legacy_equals_flow_compile(tiny, strategy, engine, tmp_path):
    """The acceptance grid: the legacy kwargs and Flow.compile(config=)
    give bit-identical programs, steps, outputs, reports and digests --
    and the JAX package's legacy spelling's digest."""
    jmodel, tmodel, in_shape, jiq, tiq, params, tparams = tiny
    with pytest.warns(DeprecationWarning, match=r"repro_torch\.flow\.CompileConfig"):
        legacy = tnn.compile_model(tmodel, tparams, in_shape, tiq, dc=2, strategy=strategy,
                                   engine=engine, jobs=1, device="cpu")
    cfg = CompileConfig(strategy=strategy, jobs=1, solver=SolverConfig(dc=2, engine=engine))
    flow = Flow.compile(tmodel, tparams, in_shape, tiq, config=cfg, device="cpu")
    ref = _legacy(jnn.compile_model, jmodel, params, in_shape, jiq, dc=2, strategy=strategy,
                  engine=engine, jobs=1)
    assert len(legacy.programs) == len(flow.programs)
    for pa, pb in zip(legacy.programs, flow.programs):
        for k in pa:
            np.testing.assert_array_equal(pa[k], pb[k])
    assert [s.kind for s in legacy.step_specs] == [s.kind for s in flow.step_specs]
    x = _samples(32, seed=1)
    np.testing.assert_array_equal(_fwd(legacy, x), _fwd(flow, x))

    def reps(d):
        return [{k: v for k, v in dataclasses.asdict(r).items() if k != "solver_time_s"}
                for r in d.reports]

    assert reps(legacy) == reps(flow)
    assert legacy.config.digest() == flow.config.digest() == ref.config.digest()
    keys = ("arrays_sha256", "compile_config", "compile_config_digest", "resources")
    got = _manifest(legacy, save_design, tmp_path / "legacy")
    flow_m = _manifest(flow, save_design, tmp_path / "flow")
    ref_m = _manifest(ref, jsave, tmp_path / "jax")
    assert [got[k] for k in keys] == [flow_m[k] for k in keys] == [ref_m[k] for k in keys]


def test_config_roundtrips_through_artifact(tiny, tmp_path):
    _, tmodel, in_shape, _, tiq, _, tparams = tiny
    cfg = CompileConfig(jobs=1, solver=SolverConfig(dc=1, engine="heap"))
    design = Flow.compile(tmodel, tparams, in_shape, tiq, config=cfg, device="cpu")
    design.save(tmp_path / "d")
    loaded = Flow.load(tmp_path / "d", device="cpu", verify="strict")
    assert loaded.config == CompileConfig.from_dict(cfg.to_dict())
    assert loaded.config.digest() == cfg.digest()
    assert loaded.solver_stats["verify"]["ok"]
    again = Design.load(tmp_path / "d", device="cpu")
    x = _samples(5, seed=2)
    np.testing.assert_array_equal(_fwd(loaded, x), _fwd(again, x))
    np.testing.assert_array_equal(_fwd(loaded, x), _fwd(design, x))
    assert Flow.verify(tmp_path / "d").ok


def test_serve_engine_legacy_kwargs_warn_and_equal_config():
    with pytest.warns(DeprecationWarning, match=r"repro_torch\.flow\.ServeConfig"):
        eng = ServeEngine(device="cpu", max_batch=8, overflow="reject", buckets=[8, 2, 1])
    assert eng.config == ServeConfig(max_batch=8, backpressure="reject", buckets=(8, 2, 1))
    with pytest.warns(DeprecationWarning):
        eng = ServeEngine(device="cpu", queue_depth=64, max_wait_us=50.0)
    assert eng.config == ServeConfig(queue_depth=64, max_wait_us=50.0)
    assert ServeEngine(device="cpu").config == ServeConfig()
    assert repr(UNSET) == "UNSET"


def test_flow_config_import_does_not_pull_in_the_facade():
    code = ("import sys, json; import repro_torch.core, repro_torch.flow.config; "
            "print(json.dumps(sorted(m for m in sys.modules if m.startswith('repro_torch.flow')"
            " or m.startswith('repro_torch.runtime'))))")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         check=True, cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"),
                                                    "PATH": "/usr/bin:/bin"})
    assert json.loads(out.stdout.strip().splitlines()[-1]) == [
        "repro_torch.flow", "repro_torch.flow.config"]


# ----------------------------------------------------------------------
# Deployment: versioned rollout
# ----------------------------------------------------------------------
@pytest.fixture(scope="module")
def two_designs():
    """Two port designs over the same in/out shapes with different
    weights, and the JAX designs compiled from the same weights."""
    iq = (jnn.QuantConfig(*IN_QUANT), tnn.QuantConfig(*IN_QUANT))
    wq = (jnn.QuantConfig(6, 2, signed=True), tnn.QuantConfig(6, 2, signed=True))
    out = []
    for seed in (1, 2):
        params, _ = jnn.init_params(jax.random.PRNGKey(seed), (jnn.QDense(4, wq[0]),), (8,))
        jd = jflow.Flow.compile((jnn.QDense(4, wq[0]),), params, (8,), iq[0],
                                config=jflow.CompileConfig(jobs=1))
        td = Flow.compile((tnn.QDense(4, wq[1]),),
                          tnn.params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
                          (8,), iq[1], config=CompileConfig(jobs=1), device="cpu")
        out.append((jd, td))
    return out


def _want(jd, xs):
    return np.asarray(jax.jit(jd.forward_int)(xs))


def test_rollout_v1_drains_v2_serves(two_designs):
    (j1, d1), (j2, d2) = two_designs
    xs = _samples(24)
    want1, want2 = _want(j1, xs), _want(j2, xs)
    assert not np.array_equal(want1, want2)
    # long batching window: v1's requests sit queued while v2 rolls out
    with Flow.serve(ServeConfig(max_batch=4, max_wait_us=300_000.0), device="cpu") as dep:
        assert dep.register("m", d1, warmup=True) == 1
        inflight = [dep.submit("m", x) for x in xs]
        assert dep.register("m", d2, warmup=True) == 2  # flip + drain v1
        np.testing.assert_array_equal(np.stack([f.result(30) for f in inflight]), want1)
        assert dep.versions("m") == [2]
        assert dep.active_version("m") == 2
        assert dep.engine.models() == ["m@v2"]
        got2 = np.stack([f.result(30) for f in dep.submit_batch("m", xs)])
        np.testing.assert_array_equal(got2, want2)
        s = dep.stats("m")
        assert (s["version"], s["model"]) == (2, "m")
        assert 'model="m@v2"' in dep.metrics_text()
        assert set(dep.stats()) == {"m"}


def test_rollout_explicit_versions_and_rollback(two_designs):
    (j1, d1), (j2, d2) = two_designs
    x = _samples(1, seed=9)[0]
    w1, w2 = _want(j1, x[None])[0], _want(j2, x[None])[0]
    with Deployment(ServeConfig(max_batch=4, max_wait_us=100.0), device="cpu") as dep:
        dep.register("m", d1, version=10)
        assert dep.active_version("m") == 10
        dep.register("m", d2, version=20, drain=False)  # keep v10 alive
        assert dep.versions("m") == [10, 20]
        np.testing.assert_array_equal(dep.infer("m", x), w2)
        dep.activate("m", 10)  # rollback
        np.testing.assert_array_equal(dep.infer("m", x), w1)
        with pytest.raises(ValueError, match="already registered"):
            dep.register("m", d1, version=20)
        with pytest.raises(KeyError, match="no live version"):
            dep.activate("m", 99)
        dep.unregister("m", 10)
        with pytest.raises(KeyError, match="no active version"):
            dep.infer("m", x)  # the active version was dropped explicitly
        dep.activate("m", 20)
        np.testing.assert_array_equal(dep.infer("m", x), w2)


def test_deployment_registry_isolation_and_artifact_paths(two_designs, tmp_path):
    (j1, d1), (j2, d2) = two_designs
    x = _samples(1, seed=3)[0]
    path = save_design(d2, tmp_path / "b")
    with Flow.serve(models={"a": d1, "b": path}, device="cpu") as dep:
        assert dep.models() == ["a", "b"]
        assert dep.versions("a") == [1] and dep.versions("b") == [1]
        np.testing.assert_array_equal(dep.infer("a", x), _want(j1, x[None])[0])
        np.testing.assert_array_equal(dep.infer("b", x), _want(j2, x[None])[0])
        dep.unregister("a")
        assert dep.models() == ["b"]
        with pytest.raises(KeyError, match="no active version"):
            dep.submit("a", x)
    with pytest.raises(ValueError, match="not both"):
        Deployment(ServeConfig(), engine=ServeEngine(device="cpu"))


def test_drained_version_releases_its_buffers(two_designs):
    (_, d1), (_, d2) = two_designs
    with Flow.serve(ServeConfig(max_batch=4, shards=2), device="cpu") as dep:
        dep.register("m", d1, warmup=True)
        old = dep.engine._runner("m@v1")
        assert all(sh._x_host for sh in old.shards)
        dep.register("m", d2)
        assert all(not sh.is_alive() and not sh._x_host and not sh._graphs
                   for sh in old.shards)


def test_submit_batch_bit_identical(two_designs):
    (j1, d1), _ = two_designs
    xs = _samples(50, seed=4)
    with ServeEngine(ServeConfig(max_batch=16, max_wait_us=100.0), device="cpu") as eng:
        eng.register("m", d1, warmup=True)
        futs = eng.submit_batch("m", xs)
        assert len(futs) == 50
        got = np.stack([f.result(30) for f in futs])
        one = np.stack([eng.submit("m", x).result(30) for x in xs])
    np.testing.assert_array_equal(got, _want(j1, xs))
    np.testing.assert_array_equal(one, got)


def test_submit_batch_reject_fails_futures_not_batch(two_designs):
    _, (_, d2) = two_designs
    cfg = ServeConfig(max_batch=4, queue_depth=4, max_wait_us=200_000.0, backpressure="reject")
    eng = ServeEngine(cfg, device="cpu")
    try:
        eng.register("m", d2, warmup=True)
        futs = eng.submit_batch("m", _samples(64, seed=5))
        assert len(futs) == 64
        ok = rejected = 0
        for f in futs:
            try:
                assert f.result(30).shape == (4,)
                ok += 1
            except QueueFullError:
                rejected += 1
        assert rejected > 0 and ok > 0
        assert eng.stats("m")["n_rejected"] == rejected
    finally:
        eng.shutdown()


def test_engine_duplicate_register_is_loud(two_designs):
    (_, d1), (_, d2) = two_designs
    with ServeEngine(ServeConfig(max_batch=4), device="cpu") as eng:
        eng.register("m", d1)
        with pytest.raises(ValueError, match="already registered"):
            eng.register("m", d2)  # silent replacement would mix designs
        assert eng.models() == ["m"]


def test_load_design_round_trip_through_flow(two_designs, tmp_path):
    (j1, d1), _ = two_designs
    path = d1.save(tmp_path / "d1")
    loaded = Flow.load(path, device="cpu")
    assert loaded.solver_stats["n_solves"] == 0
    xs = _samples(9, seed=6)
    np.testing.assert_array_equal(_fwd(loaded, xs), _want(j1, xs))
    assert load_design(path, device="cpu").config == loaded.config
