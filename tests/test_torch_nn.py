"""The port's NN front end and compiler (``repro_torch.nn``) against the
JAX package's (``repro.nn``), on the same weights carried across with
``params_from_numpy``.

* ``fake_quant``/``to_grid_int`` values equal, and the straight-through
  gradient equal to ``jax.grad``, in float32 (exact);
* ``apply_model`` in float32 (atol 1e-6: every partial sum lies on the
  grid, so the two agree in practice bit for bit) and in float64
  (exact), and its gradient in float32 (rtol 1e-5, atol 1e-7: the
  backward products sum in another order);
* ``compile_model`` on jet_tagger, muon_tracker, a small mixer and a
  small svhn_cnn: the same step specs, program arrays, ``arrays_sha256``
  and reports (wall times aside) as the JAX compile, for either
  strategy, any ``jobs`` and a warm cache;
* the port's float64 ``apply_model`` equal to the design's ``forward``
  (the contract of tests/test_nn_compile.py, exact);
* the committed ``params.npz`` compile, in the port, to the committed
  svhn_cnn artifact;
* ``init_params(PRNGKey(k), ...)`` equal to the JAX package's draw bit
  for bit (jet_tagger, the Mixer with its ``Residual`` bodies, svhn_cnn;
  three seeds), and the jet tagger the port compiles from its own
  ``PRNGKey(0)`` draw equal to the JAX compile (``arrays_sha256``).

JAX runs in float64 only inside ``jax.enable_x64(True)``, so these tests
neither depend on the global flag nor leak it.
"""

import functools
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import nn as jnn
from repro.flow import CompileConfig as JCompileConfig
from repro.runtime import save_design as jsave
from repro_torch import nn as tnn
from repro_torch.core import SolutionCache
from repro_torch.flow import CompileConfig, SolverConfig
from repro_torch.random import PRNGKey
from repro_torch.runtime import load_design, save_design

ASSETS = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "assets"
NETWORKS = {
    "jet_tagger": (lambda m: m.jet_tagger(), None, 0),
    "muon_tracker": (lambda m: m.muon_tracker(), None, 0),
    "mixer_small": (lambda m: m.mlp_mixer_jet(n_particles=8, n_features=8, d_ff=8), None, 0),
    "svhn_small": (lambda m: m.svhn_cnn(), (22, 22, 3), 1),
}


@functools.cache
def _jax_net(name):
    build, shape, key = NETWORKS[name]
    jmodel, in_shape, jiq = build(jnn.models)
    in_shape = shape or in_shape
    # jitted: the draws are the eager ones, without an eager dispatch per op
    params = jax.jit(lambda k: jnn.init_params(k, jmodel, in_shape)[0])(jax.random.PRNGKey(key))
    return jmodel, in_shape, jiq, params


def _japply(params, model, x, in_quant):
    return np.asarray(jax.jit(lambda p, v: jnn.apply_model(p, model, v, in_quant=in_quant))(
        params, x))


def _net(name):
    """(JAX model, port model, in_shape, JAX in_quant, port in_quant,
    JAX params, port params on the CPU, carried across afresh)."""
    jmodel, in_shape, jiq, params = _jax_net(name)
    tmodel, _, tiq = NETWORKS[name][0](tnn.models)
    tparams = tnn.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    return jmodel, tmodel, in_shape, jiq, tiq, params, tparams


def _inputs(in_shape, iq, batch=16, seed=0):
    return np.random.default_rng(seed).uniform(iq.lo, iq.hi, size=(batch, *in_shape))


@pytest.fixture(scope="module")
def compiled():
    """Each network compiled once by each package: name -> (jax, port)."""
    out = {}
    for name in NETWORKS:
        jmodel, tmodel, in_shape, jiq, tiq, params, tparams = _net(name)
        jd = jnn.compile_model(jmodel, params, in_shape, jiq, config=JCompileConfig(jobs=1))
        td = tnn.compile_model(tmodel, tparams, in_shape, tiq, config=CompileConfig(jobs=1),
                               device="cpu")
        out[name] = (jd, td)
    return out


# ----------------------------------------------------------------------
# quantization
# ----------------------------------------------------------------------
QUANTS = [(8, 4, True), (6, 2, True), (8, 1, False), (1, 1, False), (24, 20, True)]


@pytest.mark.parametrize("rounding", ["floor", "round"])
@pytest.mark.parametrize("bits,int_bits,signed", QUANTS)
def test_fake_quant_values_and_gradient_equal(bits, int_bits, signed, rounding):
    jq, tq = jnn.QuantConfig(bits, int_bits, signed), tnn.QuantConfig(bits, int_bits, signed)
    rng = np.random.default_rng(bits)
    x = (rng.standard_normal(500) * 2.0 ** (int_bits - 1)).astype(np.float32)
    w = rng.standard_normal(500).astype(np.float32)
    xt = torch.tensor(x, requires_grad=True)
    yt = tnn.fake_quant(xt, tq, rounding)
    np.testing.assert_array_equal(yt.detach().numpy(), np.asarray(jnn.fake_quant(x, jq, rounding)))
    (yt * torch.tensor(w)).sum().backward()
    gj = jax.grad(lambda v: (jnn.fake_quant(v, jq, rounding) * w).sum())(jnp.asarray(x))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(gj))
    from repro.nn.quant import to_grid_int as j_to_grid_int

    gi = tnn.to_grid_int(torch.tensor(x), tq, rounding)
    assert gi.dtype == torch.int32
    np.testing.assert_array_equal(gi.numpy(), np.asarray(j_to_grid_int(x, jq, rounding)))
    assert (tq.lo, tq.hi, tq.step, tq.scale_exp()) == (jq.lo, jq.hi, jq.step, jq.scale_exp())


def test_bit_count_surrogate_and_its_gradient():
    from repro.nn.quant import bit_count_surrogate as j_surrogate

    jq, tq = jnn.QuantConfig(6, 2), tnn.QuantConfig(6, 2)
    w = np.random.default_rng(0).standard_normal((16, 8)).astype(np.float32)
    wt = torch.tensor(w, requires_grad=True)
    s = tnn.bit_count_surrogate(wt, tq)
    np.testing.assert_allclose(s.item(), float(j_surrogate(w, jq)), rtol=1e-6)
    s.backward()
    np.testing.assert_allclose(wt.grad.numpy(),
                               np.asarray(jax.grad(lambda v: j_surrogate(v, jq))(w)), rtol=1e-6)


# ----------------------------------------------------------------------
# the float forward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_apply_model_float32_matches_jax(name):
    jmodel, tmodel, in_shape, jiq, tiq, params, tparams = _net(name)
    x = _inputs(in_shape, jiq).astype(np.float32)
    yj = _japply(params, jmodel, x, jiq)
    yt = tnn.apply_model(tparams, tmodel, torch.tensor(x), in_quant=tiq)
    assert yj.dtype == np.float32 and yt.dtype == torch.float32 and yt.shape == yj.shape
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=1e-6)


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_apply_model_float64_matches_jax_exactly(name):
    jmodel, tmodel, in_shape, jiq, tiq, params, tparams = _net(name)
    x = _inputs(in_shape, jiq, seed=1)
    with jax.enable_x64(True):
        yj = _japply(params, jmodel, x, jiq)
    yt = tnn.apply_model(tparams, tmodel, torch.tensor(x, dtype=torch.float64), in_quant=tiq)
    assert yj.dtype == np.float64 and yt.dtype == torch.float64
    np.testing.assert_array_equal(yt.numpy(), yj)


def test_apply_model_gradient_and_bit_penalty_match_jax():
    jmodel, tmodel, in_shape, jiq, tiq, params, tparams = _net("jet_tagger")
    x = _inputs(in_shape, jiq, batch=32, seed=2).astype(np.float32)

    def jloss(p):
        y, pen = jnn.apply_model(p, jmodel, jnp.asarray(x), in_quant=jiq, collect_bits=True)
        return (y**2).mean() + 1e-3 * pen

    gj = jax.jit(jax.grad(jloss))(params)
    for p in tparams:
        for v in p.values():
            v.requires_grad_(True)
    y, pen = tnn.apply_model(tparams, tmodel, torch.tensor(x), in_quant=tiq, collect_bits=True)
    ((y**2).mean() + 1e-3 * pen).backward()
    loss = ((y**2).mean() + 1e-3 * pen).item()
    np.testing.assert_allclose(loss, float(jax.jit(jloss)(params)), rtol=1e-6)
    for pj, pt in zip(gj, tparams):
        for k in pj:
            np.testing.assert_allclose(pt[k].grad.numpy(), np.asarray(pj[k]), rtol=1e-5,
                                       atol=1e-7, err_msg=k)


def test_conv_same_padding_matches_jax():
    """The front end's SAME padding (the compile path takes VALID only)."""
    jspec = (jnn.QConv2D(4, (3, 3), strides=(2, 2), padding="SAME"),)
    tspec = (tnn.QConv2D(4, (3, 3), strides=(2, 2), padding="SAME"),)
    params, out_shape = jnn.init_params(jax.random.PRNGKey(3), jspec, (7, 6, 2))
    tparams = tnn.params_from_numpy(jax.tree.map(np.asarray, params), device="cpu")
    x = np.random.default_rng(0).uniform(-1, 1, size=(3, 7, 6, 2))
    with jax.enable_x64(True):
        yj = np.asarray(jnn.apply_model(params, jspec, jnp.asarray(x, jnp.float64)))
    yt = tnn.apply_model(tparams, tspec, torch.tensor(x, dtype=torch.float64))
    assert yt.shape[1:] == out_shape
    np.testing.assert_allclose(yt.numpy(), yj, rtol=0, atol=1e-12)


def test_init_params_shapes_and_generator():
    """The port's draw has the JAX package's tree, shapes and dtypes; one
    key gives one draw; a ``torch.Generator`` is refused."""
    jmodel, tmodel, in_shape, *_ = _net("mixer_small")
    jp, jshape = jnn.init_params(jax.random.PRNGKey(0), jmodel, in_shape)
    a, shape = tnn.init_params(PRNGKey(5), tmodel, in_shape, device="cpu")
    b, _ = tnn.init_params(PRNGKey(5), tmodel, in_shape, device="cpu")
    assert shape == jshape
    flat = jax.tree_util.tree_flatten_with_path
    ja, ta = flat(jax.tree.map(np.asarray, jp))[0], flat(jax.tree.map(lambda t: t.numpy(), a))[0]
    assert [(p, v.shape, v.dtype) for p, v in ja] == [(p, v.shape, v.dtype) for p, v in ta]
    for (_, u), (_, v) in zip(ta, flat(jax.tree.map(lambda t: t.numpy(), b))[0]):
        np.testing.assert_array_equal(u, v)
    with pytest.raises(TypeError, match="torch.Generator"):
        tnn.init_params(torch.Generator().manual_seed(5), tmodel, in_shape, device="cpu")


INIT_NETWORKS = {
    "jet_tagger": (lambda m: m.jet_tagger(), None),
    "mixer": (lambda m: m.mlp_mixer_jet(), None),  # its token and channel MLPs are Residuals
    "svhn_cnn": (lambda m: m.svhn_cnn(), None),
}


@pytest.mark.parametrize("seed", [0, 1, 7])
@pytest.mark.parametrize("name", sorted(INIT_NETWORKS))
def test_init_params_equals_jax_bit_for_bit(name, seed):
    """``init_params(PRNGKey(k), ...)`` is the JAX package's draw of the
    same seed: every weight and bias equal, bit for bit."""
    build, _ = INIT_NETWORKS[name]
    jmodel, in_shape, _ = build(jnn.models)
    tmodel, _, _ = build(tnn.models)
    assert any(isinstance(s, tnn.Residual) for s in tmodel) == (name == "mixer")
    jp, jshape = jnn.init_params(jax.random.PRNGKey(seed), jmodel, in_shape)
    tp, tshape = tnn.init_params(PRNGKey(seed), tmodel, in_shape, device="cpu")
    assert tshape == jshape
    flat = jax.tree_util.tree_flatten_with_path
    want = flat(jax.tree.map(np.asarray, jp))[0]
    got = flat(jax.tree.map(lambda t: t.numpy(), tp))[0]
    assert [p for p, _ in got] == [p for p, _ in want]
    for (path, g), (_, w) in zip(got, want):
        assert g.dtype == w.dtype == np.float32, path
        np.testing.assert_array_equal(g, w, err_msg=str(path))


def test_port_draw_compiles_to_the_jax_design(compiled, tmp_path):
    """The jet tagger compiled by the port from its own ``PRNGKey(0)``
    draw has the JAX compile's ``arrays_sha256`` (the JAX package's
    ``PRNGKey(0)`` weights, the ``compiled`` fixture): no weights crossed."""
    assert NETWORKS["jet_tagger"][2] == 0
    tmodel, in_shape, tiq = tnn.models.jet_tagger()
    tp, _ = tnn.init_params(PRNGKey(0), tmodel, in_shape, device="cpu")
    td = tnn.compile_model(tmodel, tp, in_shape, tiq, config=CompileConfig(jobs=1), device="cpu")
    mj = _manifest(compiled["jet_tagger"][0], jsave, tmp_path / "jax")
    mt = _manifest(td, save_design, tmp_path / "port")
    assert mt["arrays_sha256"] == mj["arrays_sha256"]


# ----------------------------------------------------------------------
# compile
# ----------------------------------------------------------------------
def _spec_tree(specs):
    return [(s.kind, s.params, {k: np.asarray(v).tolist() for k, v in s.arrays.items()}, s.table,
             None if s.body is None else _spec_tree(s.body)) for s in specs]


def _manifest(design, save, path):
    return json.loads((save(design, path) / "manifest.json").read_text())


def _without_times(reports):
    return [{k: v for k, v in r.items() if k != "solver_time_s"} for r in reports]


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_compile_matches_jax(compiled, name, tmp_path):
    jd, td = compiled[name]
    assert _spec_tree(td.step_specs) == _spec_tree(jd.step_specs)
    assert len(td.programs) == len(jd.programs)
    for a, b in zip(jd.programs, td.programs):
        for k in ("rows", "outputs", "n_inputs"):
            np.testing.assert_array_equal(b[k], a[k], err_msg=k)
    assert td.out_qints == [type(td.out_qints[0])(q.lo, q.hi, q.exp) for q in jd.out_qints]
    assert (td.in_shape, td.out_shape) == (tuple(jd.in_shape), tuple(jd.out_shape))
    mj, mt = _manifest(jd, jsave, tmp_path / "jax"), _manifest(td, save_design, tmp_path / "port")
    assert mt["arrays_sha256"] == mj["arrays_sha256"]
    assert mt["compile_config_digest"] == mj["compile_config_digest"]
    assert mt["resources"] == mj["resources"]
    assert _without_times(mt["reports"]) == _without_times(mj["reports"])
    v = td.solver_stats["verify"]
    assert v["tier"] == "cheap" and v["ok"] and v["per_layer"].keys() == \
        jd.solver_stats["verify"]["per_layer"].keys()


@pytest.mark.parametrize("name", sorted(NETWORKS))
def test_float64_apply_model_equals_forward(compiled, name):
    _, tmodel, in_shape, jiq, tiq, _, tparams = _net(name)
    _, td = compiled[name]
    x = torch.tensor(_inputs(in_shape, jiq, seed=3), dtype=torch.float64)
    y_float = tnn.apply_model(tparams, tmodel, x, in_quant=tiq)
    y_int = td.forward(x)
    np.testing.assert_array_equal(y_int.numpy().astype(np.float64), y_float.numpy())


def test_latency_strategy_matches_jax():
    jmodel, tmodel, in_shape, jiq, tiq, params, tparams = _net("jet_tagger")
    jd = jnn.compile_model(jmodel, params, in_shape, jiq,
                           config=JCompileConfig(strategy="latency", jobs=1))
    td = tnn.compile_model(tmodel, tparams, in_shape, tiq,
                           config=CompileConfig(strategy="latency", jobs=1), device="cpu")
    for a, b in zip(jd.programs, td.programs):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    assert td.total_adders == jd.total_adders and td.latency_cycles == jd.latency_cycles


def test_jobs_and_cache_leave_the_bits_alone(compiled):
    jmodel, tmodel, in_shape, jiq, tiq, params, tparams = _net("mixer_small")
    _, serial = compiled["mixer_small"]
    cache = SolutionCache()
    cfg = CompileConfig(jobs=4, cache=cache, solver=SolverConfig(dc=2, engine="arena"))
    pooled = tnn.compile_model(tmodel, tparams, in_shape, tiq, config=cfg, device="cpu")
    warm = tnn.compile_model(tmodel, tparams, in_shape, tiq, config=cfg, device="cpu")
    assert pooled.solver_stats["n_pool_solves"] == pooled.solver_stats["n_solves"] > 1
    assert pooled.solver_stats["pool_fallback"] is None
    assert serial.solver_stats["pool_fallback"] == "jobs=1"
    assert warm.solver_stats["n_solves"] == 0
    assert warm.solver_stats["n_cache_hits"] == len(warm.programs)
    assert warm.solver_stats["pool_fallback"] == "no_cache_misses"
    for d in (pooled, warm):
        for a, b in zip(serial.programs, d.programs):
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
    assert warm.config.cache is None


def test_compile_takes_tensors_numpy_and_refuses_untyped_config():
    _, tmodel, in_shape, jiq, tiq, params, _ = _net("jet_tagger")
    d = tnn.compile_model(tmodel, jax.tree.map(np.asarray, params), in_shape, tiq,
                          config=CompileConfig(jobs=1, verify="off"), device="cpu")
    assert "verify" not in d.solver_stats and d.device == torch.device("cpu")
    with pytest.raises(ValueError, match="CompileConfig"):
        tnn.compile_model(tmodel, jax.tree.map(np.asarray, params), in_shape, tiq,
                          config={"jobs": 1}, device="cpu")


def test_committed_params_compile_to_the_committed_svhn_design(tmp_path):
    """The CPU twin of the card's compile phase, at the asset's full size."""
    model, in_shape, in_quant = tnn.models.svhn_cnn()
    with np.load(ASSETS / "svhn_cnn" / "params.npz") as z:
        params = tnn.params_from_numpy(z, device="cpu", model=model)
    assert [sorted(p) for p in params] == [["b", "w"] if isinstance(
        spec, (tnn.QDense, tnn.QConv2D)) else [] for spec in model]
    committed = json.loads((ASSETS / "svhn_cnn" / "manifest.json").read_text())
    cfg = CompileConfig.from_dict({**committed["compile_config"], "jobs": None})
    design = tnn.compile_model(model, params, in_shape, in_quant, config=cfg, device="cpu")
    got = _manifest(design, save_design, tmp_path / "svhn")
    assert got["arrays_sha256"] == committed["arrays_sha256"]
    assert got["resources"] == committed["resources"]
    loaded = load_design(tmp_path / "svhn", device="cpu", verify="strict")
    with np.load(ASSETS / "svhn_cnn" / "golden.npz") as g:
        x, y = g["x"][:64].astype(np.int32), g["y"][:64]
    np.testing.assert_array_equal(loaded.forward_int(torch.tensor(x)).numpy(), y)


def test_params_from_numpy_needs_the_model_for_a_flat_mapping():
    with pytest.raises(ValueError, match="model="):
        tnn.params_from_numpy({"0/w": np.zeros((2, 2))}, device="cpu")


def test_quantized_training_step_reduces_loss():
    """QAT through the straight-through estimator, as the JAX package's
    tests/test_nn_compile.py does it: a few SGD steps on a toy task
    reduce the loss."""
    model, in_shape, in_quant = tnn.models.jet_tagger(w_bits=8)
    params, _ = tnn.init_params(PRNGKey(5), model, in_shape, device="cpu")
    gen = torch.Generator().manual_seed(6)
    x = torch.randn(256, 16, generator=gen)
    y = (x @ torch.randn(16, 5, generator=gen)).argmax(dim=-1)
    leaves = [v for p in params for v in p.values()]
    for v in leaves:
        v.requires_grad_(True)

    def loss_fn():
        logits = tnn.apply_model(params, model, x, in_quant=in_quant)
        return torch.nn.functional.cross_entropy(logits, y)

    loss0 = loss_fn().item()
    for _ in range(11):
        grads = torch.autograd.grad(loss_fn(), leaves)
        with torch.no_grad():
            for v, g in zip(leaves, grads):
                v -= 0.05 * g
    assert loss_fn().item() < loss0
