"""The port's hybrid, encoder-decoder and VLM families (jamba, whisper,
internvl2: the layer pattern of Mamba, attention and MoE; the encoder,
cross-attention and its cache; image embeddings before the tokens) on
the CPU against the JAX package, on the same weights (moved across with
``params_from_numpy``) and the same numpy inputs (tokens, ``enc_frames``
and ``img_embeds`` from ``np.random.default_rng``).

Tolerance: atol 1e-4 on float32 logits and caches (the same arithmetic
with sums in another order, through up to 16 layers; logits are O(1)),
1e-5 on one attention block, and exact equality of greedy tokens.  The
JAX side is jitted, as its engine runs it, and takes both attention
paths: ``use_flash_kernel`` True (the Pallas kernel in interpret mode,
which needs sequence lengths its blocks divide: ``encoder_seq`` 16, and
8 vision with 8 text tokens) and False (``attention_ref``).

A port twin of ``tests/test_archs_smoke.py``'s forward and
prefill/decode-consistency tests runs over all ten architectures, and
the committed reduced assets of the three families reproduce their JAX
golden outputs here.
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
from repro.models import attention as jax_attention
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import param_specs as jax_param_specs
from repro.models.transformer import prefill as jax_prefill
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch import configs
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.ssm_scan import kernel as ss_kernel
from repro_torch.models import (
    decode_step,
    forward,
    init_cache,
    init_params,
    param_specs,
    params_from_numpy,
    prefill,
    unflatten,
)
from repro_torch.models.attention import attention_block, precompute_cross_cache
from repro_torch.models.transformer import check_supported, tree_map
from repro_torch.random import PRNGKey
from repro_torch.serve import Engine, Request

FAMILY_ARCHS = ["jamba-v0.1-52b", "whisper-base", "internvl2-26b"]
ALL_ARCHS = sorted(configs.ARCHS)
ASSETS = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "assets"
FAMILY_ASSETS = ["jamba_smoke", "whisper_smoke", "internvl2_smoke"]
ATOL = 1e-4
BLOCK_ATOL = 1e-5
TEXT_LEN = 8  # with internvl2's 8 vision tokens, 16 rows: the Pallas blocks divide it
MAX_SEQ = 32


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _extra(cfg, b, seed):
    """The stub front ends' outputs for a batch of ``b``, float32 numpy."""
    rng = np.random.default_rng(seed)
    if cfg.family == "encdec":
        return {"enc_frames": rng.standard_normal((b, cfg.encoder_seq, cfg.d_model))
                .astype(np.float32)}
    if cfg.family == "vlm":
        return {"img_embeds": rng.standard_normal((b, cfg.vision_tokens, cfg.d_model))
                .astype(np.float32)}
    return {}


def _batches(cfg, b, s, seed):
    """The same batch for both packages: (port batch of tensors, JAX batch)."""
    rng = np.random.default_rng(seed)
    np_batch = {"tokens": rng.integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32),
                **_extra(cfg, b, seed + 1)}
    return ({k: torch.from_numpy(v) for k, v in np_batch.items()},
            {k: jnp.asarray(v) for k, v in np_batch.items()})


@pytest.fixture(scope="module", params=FAMILY_ARCHS)
def family(request):
    """(port cfg, JAX cfg, JAX params, port params) of a reduced family
    config, float32, JAX weights from PRNGKey(0)."""
    cfg = configs.get_smoke(request.param)
    jcfg = jax_configs.get_smoke(request.param)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, jparams, params


# ----------------------------------------------------------------------
# parameters
# ----------------------------------------------------------------------
def test_param_trees_equal_reference(family):
    cfg, jcfg, jparams, params = family
    want = jax.tree.map(lambda a: tuple(a.shape), jparams)
    assert jax.tree.map(lambda t: tuple(t.shape), params) == want
    got = jax.tree.map(lambda s: (tuple(s.shape), s.init, s.fan_in_axis), param_specs(cfg),
                       is_leaf=lambda s: hasattr(s, "fan_in_axis"))
    ref = jax.tree.map(lambda s: (tuple(s.shape), s.init, s.fan_in_axis), jax_param_specs(jcfg),
                       is_leaf=lambda s: hasattr(s, "fan_in_axis"))
    assert got == ref
    assert sum(t.numel() for t in jax.tree.leaves(params)) == cfg.param_count()


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_full_width_param_specs_equal_reference(name):
    shapes = jax.tree.map(lambda s: tuple(s.shape), param_specs(configs.get(name)),
                          is_leaf=lambda s: hasattr(s, "fan_in_axis"))
    want = jax.tree.map(lambda s: tuple(s.shape), jax_param_specs(jax_configs.get(name)),
                        is_leaf=lambda s: hasattr(s, "fan_in_axis"))
    assert shapes == want


@pytest.mark.parametrize("name", FAMILY_ARCHS)
def test_init_params_draws_every_stack(name):
    """``enc_blocks`` are period-stacked, as ``blocks`` are: drawn one
    period slice at a time, seeded, scaled by fan-in."""
    cfg = configs.get_smoke(name)
    a = init_params(cfg, PRNGKey(0), device="cpu")
    b = init_params(cfg, PRNGKey(0), device="cpu")
    jax.tree.map(lambda x, y: torch.testing.assert_close(x, y, atol=0, rtol=0), a, b)
    specs = jax.tree.map(lambda s: tuple(s.shape), param_specs(cfg),
                         is_leaf=lambda s: hasattr(s, "fan_in_axis"))
    assert jax.tree.map(lambda t: tuple(t.shape), a) == specs
    if cfg.family == "encdec":
        wq = a["enc_blocks"][0]["attn"]["wq"]
        assert wq.shape[0] == cfg.encoder_layers
        assert abs(float(wq.std()) - cfg.d_model ** -0.5) < 0.02
        assert not torch.equal(wq[0], wq[1])
        assert torch.equal(a["enc_final_norm"], torch.ones(cfg.d_model))


# ----------------------------------------------------------------------
# one attention block: cross-attention and its cache
# ----------------------------------------------------------------------
def test_cross_attention_block_matches_reference():
    """``attention_block`` with ``kv_source`` (no RoPE, full) from the
    encoder output, then from the cache ``precompute_cross_cache`` built,
    against the JAX functions; qk-norm on, as a config may have it."""
    cfg = dataclasses.replace(configs.get_smoke("whisper-base"), qk_norm=True)
    jcfg = dataclasses.replace(jax_configs.get_smoke("whisper-base"), qk_norm=True)
    rng = np.random.default_rng(5)
    d, hq, hkv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.hd
    p = {"wq": rng.standard_normal((d, hq * hd)), "wk": rng.standard_normal((d, hkv * hd)),
         "wv": rng.standard_normal((d, hkv * hd)), "wo": rng.standard_normal((hq * hd, d)),
         "q_norm": 1 + rng.standard_normal(hd) / 4, "k_norm": 1 + rng.standard_normal(hd) / 4}
    p = {k: (v / (8 if v.ndim == 2 else 1)).astype(np.float32) for k, v in p.items()}
    x = rng.standard_normal((2, 5, d)).astype(np.float32)
    enc = rng.standard_normal((2, 16, d)).astype(np.float32)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    pos = np.arange(5)
    got, _ = attention_block(cfg, tp, torch.from_numpy(x), torch.from_numpy(pos),
                             kv_source=torch.from_numpy(enc))
    want, _ = jax_attention.attention_block(jcfg, jp, jnp.asarray(x), jnp.asarray(pos),
                                            None, False, jnp.asarray(enc))
    np.testing.assert_allclose(_np(got), _np(want), atol=BLOCK_ATOL, rtol=0)

    cc = precompute_cross_cache(cfg, tp, torch.from_numpy(enc))
    jcc = jax_attention.precompute_cross_cache(jcfg, jp, jnp.asarray(enc))
    for key in ("k", "v"):
        assert cc[key].shape == (2, hkv, 16, hd)
        np.testing.assert_allclose(_np(cc[key]), _np(jcc[key]), atol=BLOCK_ATOL, rtol=0)
    # decode: one token against the cross cache, which is read and not written
    x1 = x[:, :1]
    before = {k: v.clone() for k, v in cc.items()}
    got, new = attention_block(cfg, tp, torch.from_numpy(x1), torch.tensor([[7], [7]]), cc,
                               False, torch.from_numpy(x1))
    want, _ = jax_attention.attention_block(jcfg, jp, jnp.asarray(x1), jnp.full((2, 1), 7),
                                            jcc, False, jnp.asarray(x1))
    np.testing.assert_allclose(_np(got), _np(want), atol=BLOCK_ATOL, rtol=0)
    assert new is cc and all(torch.equal(cc[k], before[k]) for k in cc)


# ----------------------------------------------------------------------
# forward / prefill / decode / the engine against the JAX functions
# ----------------------------------------------------------------------
@pytest.mark.parametrize("use_flash_kernel", [True, False])
def test_forward_matches_reference(family, use_flash_kernel):
    cfg, jcfg, jparams, params = family
    jcfg = dataclasses.replace(jcfg, use_flash_kernel=use_flash_kernel)
    tb, jb = _batches(cfg, 2, TEXT_LEN, seed=1)
    got, aux = forward(cfg, params, tb)
    want, jaux = jax.jit(lambda p, b: jax_forward(jcfg, p, b))(jparams, jb)
    assert got.shape == (2, TEXT_LEN, cfg.padded_vocab)  # vision positions cut
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)


@pytest.mark.parametrize("use_flash_kernel", [True, False])
def test_prefill_and_decode_match_reference(family, use_flash_kernel):
    """Logits and every cache leaf (K/V, the SSM's conv and state, the
    cross K/V) of prefill and five decode steps."""
    cfg, jcfg, jparams, params = family
    jcfg = dataclasses.replace(jcfg, use_flash_kernel=use_flash_kernel)
    tb, jb = _batches(cfg, 2, TEXT_LEN, seed=2)
    j_pre = jax.jit(lambda p, b: jax_prefill(jcfg, p, b, MAX_SEQ))
    j_dec = jax.jit(lambda p, t, c: jax_decode_step(jcfg, p, t, c))
    jl, jc = j_pre(jparams, jb)
    tl, tc = prefill(cfg, params, tb, MAX_SEQ)
    assert sorted(tc) == sorted(jc)
    n_img = cfg.vision_tokens if cfg.family == "vlm" else 0
    for step in range(6):
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0, err_msg=f"step {step}")
        assert int(tc["pos"]) == int(jc["pos"]) == n_img + TEXT_LEN + step
        jax.tree.map(lambda a, b: np.testing.assert_allclose(
            _np(a), _np(b), atol=ATOL, rtol=0, err_msg=f"cache at step {step}"),
            {k: v for k, v in tc.items() if k != "pos"}, {k: v for k, v in jc.items() if k != "pos"})
        if step == 5:
            break
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[:, None]
        jl, jc = j_dec(jparams, jnp.asarray(nxt), jc)
        tl, tc = decode_step(cfg, params, torch.from_numpy(nxt), tc)


@pytest.mark.parametrize("use_flash_kernel", [True, False])
def test_engine_greedy_tokens_equal_reference(family, use_flash_kernel):
    """The port's ``Engine(extra_inputs=...)`` against the JAX engine,
    request by request, padding included."""
    cfg, jcfg, jparams, params = family
    jcfg = dataclasses.replace(jcfg, use_flash_kernel=use_flash_kernel)
    extra = _extra(cfg, 4, seed=3)
    rng = np.random.default_rng(4)
    prompts = rng.integers(2, cfg.vocab_size, size=(3, TEXT_LEN)).astype(np.int32)
    n_new = [6, 3, 6]
    want = JaxEngine(jcfg, jparams, 4, MAX_SEQ, extra_inputs={
        k: jnp.asarray(v) for k, v in extra.items()}).generate(
        [JaxRequest(p, n) for p, n in zip(prompts, n_new)])
    reqs = [Request(p, n) for p, n in zip(prompts, n_new)]
    eng = Engine(cfg, params, 4, MAX_SEQ, device="cpu", extra_inputs=extra)
    got = eng.generate(reqs)
    assert got is reqs and len(reqs) == 4
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert [r.done for r in got] == [r.done for r in want]


def test_engine_takes_extra_inputs_as_tensors_or_arrays(family):
    cfg, _, _, params = family
    extra = _extra(cfg, 2, seed=6)
    prompts = np.random.default_rng(7).integers(2, cfg.vocab_size, size=(2, TEXT_LEN))
    runs = []
    for given in (extra, {k: torch.from_numpy(v) for k, v in extra.items()}):
        eng = Engine(cfg, params, 2, MAX_SEQ, device="cpu", extra_inputs=given)
        assert all(t.device.type == "cpu" and isinstance(t, torch.Tensor)
                   for t in eng.extra_inputs.values())
        runs.append([r.out_tokens for r in eng.generate([Request(p.astype(np.int32), 4)
                                                         for p in prompts])])
    assert runs[0] == runs[1]


def test_prefill_into_a_given_cache_keeps_its_tensors():
    """``prefill(..., cache=)`` writes the encoder's cross K/V into the
    cache's own tensors (a captured decode step reads those), and resets
    the self-attention cache, whatever an earlier batch left there."""
    cfg = configs.get_smoke("whisper-base")
    params = init_params(cfg, PRNGKey(0), device="cpu")
    cache = init_cache(cfg, 2, MAX_SEQ, device="cpu")
    ptrs = tree_map(lambda t: t.data_ptr(), cache)
    for seed in (0, 1):
        tb, _ = _batches(cfg, 2, TEXT_LEN, seed=10 + seed)
        logits, got = prefill(cfg, params, tb, MAX_SEQ, cache=cache)
        assert got is cache and tree_map(lambda t: t.data_ptr(), cache) == ptrs
        want_l, want_c = prefill(cfg, params, tb, MAX_SEQ)
        torch.testing.assert_close(logits, want_l, atol=0, rtol=0)
        jax.tree.map(lambda a, b: torch.testing.assert_close(a, b, atol=0, rtol=0), cache, want_c)
        decode_step(cfg, params, logits.argmax(-1)[:, None], cache)  # dirties the cache


def test_prefill_counts_vision_tokens_against_max_seq():
    cfg = configs.get_smoke("internvl2-26b")
    params = init_params(cfg, PRNGKey(0), device="cpu")
    tb, _ = _batches(cfg, 1, 10, seed=0)
    prefill(cfg, params, tb, cfg.vision_tokens + 10)
    with pytest.raises(ValueError, match="vision tokens"):
        prefill(cfg, params, tb, cfg.vision_tokens + 9)


# ----------------------------------------------------------------------
# every architecture: the port twin of tests/test_archs_smoke.py
# ----------------------------------------------------------------------
def _port_batch(cfg, b, s, seed):
    g = torch.Generator().manual_seed(seed)
    batch = {"tokens": torch.randint(0, cfg.vocab_size, (b, s), generator=g)}
    if cfg.family == "encdec":
        batch["enc_frames"] = torch.randn(b, cfg.encoder_seq, cfg.d_model, generator=g)
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.randn(b, cfg.vision_tokens, cfg.d_model, generator=g)
    return batch


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_forward_shapes_and_finite(name):
    cfg = configs.get_smoke(name)
    check_supported(cfg)
    params = init_params(cfg, PRNGKey(0), device="cpu")
    logits, aux = forward(cfg, params, _port_batch(cfg, 2, 32, 0))
    assert logits.shape == (2, 32, cfg.padded_vocab)
    assert bool(torch.isfinite(logits).all()) and bool(torch.isfinite(aux))


@pytest.mark.parametrize("name", ALL_ARCHS)
def test_prefill_decode_consistency(name):
    """Greedy decode after prefill equals teacher-forced logits: position
    bookkeeping, cache masking and RoPE offsets all line up (the JAX
    test's tolerances: 1e-2 with MoE routing, 5e-4 without)."""
    cfg = configs.get_smoke(name)
    params = init_params(cfg, PRNGKey(2), device="cpu")
    b, s = 2, 16
    batch = _port_batch(cfg, b, s, 2)
    extra = cfg.vision_tokens if cfg.family == "vlm" else 0
    atol = 1e-2 if cfg.n_experts else 5e-4
    logits_full, _ = forward(cfg, params, batch)
    lg, cache = prefill(cfg, params, batch, max_seq=s + extra + 8)
    torch.testing.assert_close(lg, logits_full[:, -1, :], atol=atol, rtol=0)
    tok = lg.argmax(-1)[:, None]
    lg2, cache = decode_step(cfg, params, tok, cache)
    logits_ext, _ = forward(cfg, params, {**batch, "tokens": torch.cat([batch["tokens"], tok], 1)})
    torch.testing.assert_close(lg2, logits_ext[:, -1, :], atol=atol, rtol=0)


# ----------------------------------------------------------------------
# the committed assets (chip_smoke.py holds the card to them)
# ----------------------------------------------------------------------
def _asset(name):
    asset = ASSETS / name
    manifest = json.loads((asset / "manifest.json").read_text())
    cfg = configs.get_smoke(manifest["arch"], **manifest["smoke_kwargs"])
    with np.load(asset / "weights.npz") as w:
        tree = unflatten(dict(w))
    with np.load(asset / "golden.npz") as g:
        golden = dict(g)
    return manifest, cfg, tree, golden


@pytest.mark.parametrize("name", FAMILY_ASSETS)
def test_asset_weights_are_the_reference_init(name):
    manifest, cfg, tree, golden = _asset(name)
    jcfg = jax_configs.get_smoke(manifest["arch"], **manifest["smoke_kwargs"])
    want = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    jax.tree.map(np.testing.assert_array_equal, tree, want)
    assert cfg.dtype == "float32" and manifest["n_params"] == cfg.param_count()
    want_extra = _extra(cfg, manifest["batch_size"], seed=0)
    assert manifest["extra_inputs"] == sorted(want_extra)
    for k, v in want_extra.items():
        np.testing.assert_array_equal(golden[k], v)


@pytest.mark.parametrize("name", FAMILY_ASSETS)
def test_port_reproduces_asset_golden_on_cpu(name):
    manifest, cfg, tree, golden = _asset(name)
    params = params_from_numpy(cfg, tree, device="cpu")
    extra = {k: golden[k] for k in manifest["extra_inputs"]}
    reqs = [Request(p, int(n)) for p, n in zip(golden["prompts"], golden["max_new_tokens"])]
    before = (fa_kernel.launches.value, ss_kernel.launches.value)
    Engine(cfg, params, manifest["batch_size"], manifest["max_seq"], eos_id=manifest["eos_id"],
           device="cpu", extra_inputs=extra).generate(reqs)
    assert (fa_kernel.launches.value, ss_kernel.launches.value) == before  # the plain versions
    for r, want in zip(reqs, golden["tokens"]):
        assert r.out_tokens == [int(t) for t in want if t >= 0]
    batch = {"tokens": torch.from_numpy(np.stack([r.prompt for r in reqs])),
             **{k: torch.from_numpy(v) for k, v in extra.items()}}
    logits, cache = prefill(cfg, params, batch, manifest["max_seq"])
    np.testing.assert_allclose(_np(logits), golden["prefill_logits"], atol=ATOL, rtol=0)
    logits, _ = decode_step(cfg, params, logits.argmax(-1)[:, None], cache)
    np.testing.assert_allclose(_np(logits), golden["decode_logits"], atol=ATOL, rtol=0)
