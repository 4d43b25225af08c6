"""The port's LM serving path (configs, layers, attention block, dense
transformer, engine) on the CPU against the JAX package, on the same
weights (moved across with ``params_from_numpy``) and the same numpy
inputs.

Tolerance: atol 1e-4 on float32 logits and caches (the same arithmetic
with sums in another order, through a few layers; logits are O(1)),
1e-5 on single layers, and exact equality of greedy tokens (the
committed asset records a smallest top-two gap of 8e-3).  The JAX side
is jitted, as its engine runs it, and takes both attention paths:
``use_flash_kernel`` True (the Pallas kernel in interpret mode) and
False (``attention_ref``).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models import layers as jax_layers
from repro.models.transformer import prefill as jax_prefill
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch import configs
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.models import (
    decode_step,
    forward,
    init_params,
    layers,
    param_specs,
    params_from_numpy,
    prefill,
    unflatten,
)
from repro_torch.random import PRNGKey
from repro_torch.serve import Engine, Request

ASSET = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "assets" / "smollm_smoke"
ATOL = 1e-4
SMOLLM = dict(n_heads=9, n_kv_heads=3)  # the reduced smollm keeps its 9:3 GQA group


def _smoke(name, **kw):
    return configs.get_smoke(name, **kw), jax_configs.get_smoke(name, **kw)


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


@pytest.fixture(scope="module")
def smollm():
    """(port cfg, JAX cfg, JAX params, port params) of the reduced
    smollm-135m with 9:3 heads, float32, JAX weights from PRNGKey(0)."""
    cfg, jcfg = _smoke("smollm-135m", **SMOLLM)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, jparams, params


# ----------------------------------------------------------------------
# configs
# ----------------------------------------------------------------------
@pytest.mark.parametrize("name", sorted(jax_configs.ARCHS))
def test_config_copy_equals_reference(name):
    port, ref = configs.get(name), jax_configs.get(name)
    assert dataclasses.asdict(port) == dataclasses.asdict(ref)
    assert dataclasses.asdict(configs.get_smoke(name)) == dataclasses.asdict(
        jax_configs.get_smoke(name))
    assert port.param_count() == ref.param_count()
    assert port.active_param_count() == ref.active_param_count()
    assert port.layer_pattern() == ref.layer_pattern()
    assert (port.hd, port.padded_vocab) == (ref.hd, ref.padded_vocab)
    assert configs.applicable_shapes(port) == jax_configs.applicable_shapes(ref)


def test_config_registry_and_shapes_equal_reference():
    assert sorted(configs.ARCHS) == sorted(jax_configs.ARCHS)
    assert {k: dataclasses.asdict(v) for k, v in configs.SHAPES.items()} == {
        k: dataclasses.asdict(v) for k, v in jax_configs.SHAPES.items()}
    assert configs.get("smollm-135m").param_count() == 162_826_560


# ----------------------------------------------------------------------
# layers, one by one
# ----------------------------------------------------------------------
def test_layers_match_reference():
    rng = np.random.default_rng(0)
    x = rng.standard_normal((2, 5, 3, 16)).astype(np.float32) * 3
    scale = rng.standard_normal(16).astype(np.float32)
    np.testing.assert_allclose(
        _np(layers.rmsnorm(torch.from_numpy(x), torch.from_numpy(scale))),
        _np(jax_layers.rmsnorm(jnp.asarray(x), jnp.asarray(scale))), atol=1e-5, rtol=1e-5)
    for pos in (np.arange(5), np.array([[0, 1, 2, 3, 4], [200, 201, 202, 203, 511]])):
        np.testing.assert_allclose(
            _np(layers.rope(torch.from_numpy(x), torch.from_numpy(pos), 1e4)),
            _np(jax_layers.rope(jnp.asarray(x), jnp.asarray(pos), 1e4)), atol=1e-5, rtol=0)
    h = rng.standard_normal((2, 5, 32)).astype(np.float32)
    w = [rng.standard_normal(s).astype(np.float32) / 6 for s in ((32, 64), (32, 64), (64, 32))]
    np.testing.assert_allclose(
        _np(layers.swiglu(torch.from_numpy(h), *map(torch.from_numpy, w))),
        _np(jax_layers.swiglu(jnp.asarray(h), *map(jnp.asarray, w))), atol=1e-5, rtol=0)
    emb = rng.standard_normal((50, 32)).astype(np.float32)
    tok = rng.integers(0, 50, size=(2, 7)).astype(np.int32)
    np.testing.assert_array_equal(
        _np(layers.embed_tokens(torch.from_numpy(emb), torch.from_numpy(tok))),
        _np(jax_layers.embed_tokens(jnp.asarray(emb), jnp.asarray(tok))))
    np.testing.assert_allclose(
        _np(layers.unembed(torch.from_numpy(h), torch.from_numpy(w[2].T.copy()))),
        _np(jax_layers.unembed(jnp.asarray(h), jnp.asarray(w[2].T))), atol=1e-5, rtol=0)


def test_rmsnorm_and_rope_keep_bf16():
    x = torch.randn(2, 3, 4, 16, generator=torch.Generator().manual_seed(0)).to(torch.bfloat16)
    assert layers.rmsnorm(x, torch.ones(16)).dtype == torch.bfloat16
    assert layers.rope(x, torch.arange(3), 1e4).dtype == torch.bfloat16


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------
def test_param_specs_match_reference(smollm):
    cfg, _, jparams, params = smollm
    want = jax.tree.map(lambda a: tuple(a.shape), jparams)
    got = jax.tree.map(lambda s: tuple(s.shape), param_specs(cfg),
                       is_leaf=lambda s: hasattr(s, "fan_in_axis"))
    assert got == want
    assert jax.tree.map(lambda t: tuple(t.shape), params) == want


def test_params_from_numpy_takes_bf16_bits_and_checks_shapes(smollm):
    cfg, jcfg, _, _ = smollm
    cfg16 = dataclasses.replace(cfg, dtype="bfloat16")
    j16 = jax_init_params(dataclasses.replace(jcfg, dtype="bfloat16"), jax.random.PRNGKey(1))
    p16 = params_from_numpy(cfg16, jax.tree.map(np.asarray, j16), device="cpu")
    assert p16["embed"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(p16["blocks"][0]["attn"]["wq"]),
                                  _np(j16["blocks"][0]["attn"]["wq"]))
    bad = jax.tree.map(np.asarray, j16)
    bad["head"] = bad["head"][:, :-1]
    with pytest.raises(ValueError, match="head"):
        params_from_numpy(cfg16, bad, device="cpu")


def test_init_params_is_seeded_and_scaled():
    cfg = configs.get_smoke("smollm-135m", **SMOLLM)
    a = init_params(cfg, PRNGKey(0), device="cpu")
    b = init_params(cfg, PRNGKey(0), device="cpu")
    assert torch.equal(a["head"], b["head"])
    assert torch.equal(a["final_norm"], torch.ones(cfg.d_model))
    assert abs(float(a["embed"].std()) - 0.02) < 2e-3
    wq = a["blocks"][0]["attn"]["wq"]
    assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.01
    assert wq.shape == (cfg.n_layers, cfg.d_model, cfg.n_heads * cfg.hd)


# ----------------------------------------------------------------------
# prefill / decode / forward against the JAX functions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("use_flash_kernel", [True, False])
@pytest.mark.parametrize("name,kw", [("smollm-135m", SMOLLM), ("qwen3-32b", {})])
def test_prefill_and_decode_match_reference(name, kw, use_flash_kernel):
    """Logits and caches of prefill and three decode steps; qwen3-32b's
    reduced config adds qk-norm."""
    cfg, jcfg = _smoke(name, **kw)
    jcfg = dataclasses.replace(jcfg, use_flash_kernel=use_flash_kernel)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    max_seq, b, s = 32, 2, 9
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    j_pre = jax.jit(lambda p, t: jax_prefill(jcfg, p, {"tokens": t}, max_seq))
    j_dec = jax.jit(lambda p, t, c: jax_decode_step(jcfg, p, t, c))
    jl, jc = j_pre(jparams, jnp.asarray(tokens))
    tl, tc = prefill(cfg, params, {"tokens": torch.from_numpy(tokens)}, max_seq)
    for step in range(4):
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0, err_msg=f"step {step}")
        for key in ("k", "v"):
            np.testing.assert_allclose(_np(tc["blocks"][0][key]), _np(jc["blocks"][0][key]),
                                       atol=ATOL, rtol=0)
        assert int(tc["pos"]) == int(jc["pos"]) == s + step
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[:, None]
        jl, jc = j_dec(jparams, jnp.asarray(nxt), jc)
        tl, tc = decode_step(cfg, params, torch.from_numpy(nxt), tc)


def test_forward_matches_reference_and_prefill(smollm):
    cfg, jcfg, jparams, params = smollm
    from repro.models import forward as jax_forward

    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    got, aux = forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    want, _ = jax.jit(lambda p, t: jax_forward(jcfg, p, {"tokens": t}))(jparams, tokens)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    assert float(aux) == 0.0
    last, _ = prefill(cfg, params, {"tokens": torch.from_numpy(tokens)}, 16)
    np.testing.assert_allclose(_np(last), _np(got[:, -1]), atol=1e-5, rtol=0)


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
def _requests(cls, vocab, n_new, prompt_len=10, seed=4):
    rng = np.random.default_rng(seed)
    return [cls(rng.integers(2, vocab, size=prompt_len).astype(np.int32), n) for n in n_new]


@pytest.mark.parametrize("n_new,eos_id", [([6, 3, 6], 1), ([5, 5], None)])
def test_engine_greedy_tokens_equal_reference(smollm, n_new, eos_id):
    """The port's engine against the JAX engine, request by request,
    padding included.  With ``eos_id=None`` the EOS id is taken from the
    reference's own output, so a request stops on it."""
    cfg, jcfg, jparams, params = smollm
    jcfg = dataclasses.replace(jcfg, use_flash_kernel=True)
    if eos_id is None:
        probe = JaxEngine(jcfg, jparams, 4, 24).generate(_requests(JaxRequest, cfg.vocab_size, n_new))
        eos_id = probe[0].out_tokens[1]
    want = JaxEngine(jcfg, jparams, 4, 24, eos_id=eos_id).generate(
        _requests(JaxRequest, cfg.vocab_size, n_new))
    reqs = _requests(Request, cfg.vocab_size, n_new)
    got = Engine(cfg, params, 4, 24, eos_id=eos_id, device="cpu").generate(reqs)
    assert got is reqs and len(reqs) == 4  # padded in the caller's list, as the reference does
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert [r.done for r in got] == [r.done for r in want]


def test_engine_categorical_is_seeded(smollm):
    """The categorical pick draws from the engine's key: ``PRNGKey(0)``
    at construction, as the reference's; the same key gives the same
    tokens, another key others, and the key carries across ``generate``
    calls."""
    cfg, _, _, params = smollm

    def engine(seed):
        eng = Engine(cfg, params, 2, 24, sample="categorical", temperature=0.7, device="cpu")
        assert torch.equal(eng.key, PRNGKey(0))
        eng.key = PRNGKey(seed)
        return eng

    def run(eng):
        return [r.out_tokens for r in eng.generate(_requests(Request, cfg.vocab_size, [6, 6]))]

    eng = engine(0)
    a = run(eng)
    assert a == run(engine(0)) and a != run(engine(1))
    assert run(eng) != a  # the second call draws from the carried key
    assert all(0 <= t < cfg.padded_vocab for toks in a for t in toks)


def test_engine_refuses_bad_requests(smollm):
    cfg, _, _, params = smollm
    eng = Engine(cfg, params, 2, 24, device="cpu")
    with pytest.raises(ValueError, match="3 requests"):
        eng.generate(_requests(Request, cfg.vocab_size, [2, 2, 2]))
    with pytest.raises(ValueError, match="sample"):
        Engine(cfg, params, 2, 24, sample="top_p", device="cpu")


# ----------------------------------------------------------------------
# the committed asset (chip_smoke.py holds the card to it)
# ----------------------------------------------------------------------
def _asset():
    manifest = json.loads((ASSET / "manifest.json").read_text())
    cfg = configs.get_smoke(manifest["arch"], **manifest["smoke_kwargs"])
    with np.load(ASSET / "weights.npz") as w:
        tree = unflatten(dict(w))
    with np.load(ASSET / "golden.npz") as g:
        golden = dict(g)
    return manifest, cfg, tree, golden


def test_asset_weights_are_the_reference_init():
    manifest, cfg, tree, _ = _asset()
    jcfg = jax_configs.get_smoke(manifest["arch"], **manifest["smoke_kwargs"])
    want = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    jax.tree.map(np.testing.assert_array_equal, tree, want)
    assert cfg.dtype == "float32" and manifest["n_params"] == cfg.param_count()


def test_port_reproduces_asset_golden_on_cpu():
    manifest, cfg, tree, golden = _asset()
    params = params_from_numpy(cfg, tree, device="cpu")
    reqs = [Request(p, int(n)) for p, n in zip(golden["prompts"], golden["max_new_tokens"])]
    before = fa_kernel.launches.value
    Engine(cfg, params, manifest["batch_size"], manifest["max_seq"],
           eos_id=manifest["eos_id"], device="cpu").generate(reqs)
    assert fa_kernel.launches.value == before  # the CPU runs the plain version
    for r, want in zip(reqs, golden["tokens"]):
        assert r.out_tokens == [int(t) for t in want if t >= 0]
    tokens = torch.from_numpy(np.stack([r.prompt for r in reqs]))
    logits, cache = prefill(cfg, params, {"tokens": tokens}, manifest["max_seq"])
    np.testing.assert_allclose(_np(logits), golden["prefill_logits"], atol=ATOL, rtol=0)
    logits, _ = decode_step(cfg, params, logits.argmax(-1)[:, None], cache)
    np.testing.assert_allclose(_np(logits), golden["decode_logits"], atol=ATOL, rtol=0)
