"""The port's MoE family (``repro_torch.models.moe``, the MoE layers of
``models/transformer.py`` and the engine over them) on the CPU against
the JAX package, on the same weights (``params_from_numpy``) and the
same numpy inputs.

* ``moe_block`` against the JAX ``moe_block`` on the reduced
  qwen3-moe-30b-a3b and kimi-k2-1t-a32b configs: f32 outputs within
  atol 1e-5 and the Switch aux loss within 1e-6 (the same arithmetic,
  sums in another order), at a capacity factor that drops tokens and at
  one that does not, and with forced router ties (twin experts with
  equal router columns: the lower index must win, as ``lax.top_k``);
* ``param_specs`` equal to the JAX ones (shapes, initialiser, fan-in
  axis), at full width too;
* prefill, decode (three steps) and ``forward`` logits of both reduced
  models, and of a reduced qwen3-moe with ``moe_every=2``, within 1e-4
  (logits are O(1) after a few f32 layers), and ``forward``'s aux;
* greedy tokens of the port's ``Engine`` equal to the JAX engine's.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_params as jax_init_params
from repro.models import param_specs as jax_param_specs
from repro.models import moe as jax_moe
from repro.models.transformer import prefill as jax_prefill
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch import configs
from repro_torch.models import decode_step, forward, param_specs, params_from_numpy, prefill
from repro_torch.models import moe
from repro_torch.serve import Engine, Request

MOE_ARCHS = ["kimi-k2-1t-a32b", "qwen3-moe-30b-a3b"]
BLOCK_ATOL = 1e-5
LOGIT_ATOL = 1e-4


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _smoke(name, **kw):
    return configs.get_smoke(name, **kw), jax_configs.get_smoke(name, **kw)


def _block_params(cfg, rng, twins=False):
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    router = rng.standard_normal((d, e)).astype(np.float32) / 8
    if twins:  # experts 2i and 2i+1 get equal router columns: exact ties
        router[:, 1::2] = router[:, 0::2]
    return {
        "router": router,
        "w_gate": rng.standard_normal((e, d, f)).astype(np.float32) / 8,
        "w_up": rng.standard_normal((e, d, f)).astype(np.float32) / 8,
        "w_down": rng.standard_normal((e, f, d)).astype(np.float32) / 11,
    }


def _drops(cfg, p, x):
    """Picks past their expert's capacity for input x (numpy)."""
    logits = torch.from_numpy(x.reshape(-1, cfg.d_model)) @ torch.from_numpy(p["router"])
    _, idx = moe.top_k_lower_index(torch.softmax(logits, -1), cfg.experts_per_token)
    counts = np.bincount(idx.numpy().ravel(), minlength=cfg.n_experts)
    return int(np.maximum(counts - moe.capacity(cfg, x.shape[0] * x.shape[1]), 0).sum())


@pytest.mark.parametrize("twins", [False, True])
@pytest.mark.parametrize("cf,drops", [(0.5, True), (4.0, False)])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_block_matches_reference(name, cf, drops, twins):
    cfg, jcfg = _smoke(name, capacity_factor=cf)
    rng = np.random.default_rng([MOE_ARCHS.index(name), int(cf * 2), twins])
    p = _block_params(cfg, rng, twins)
    x = rng.standard_normal((3, 24, cfg.d_model)).astype(np.float32)
    assert (_drops(cfg, p, x) > 0) == drops
    y, aux = moe.moe_block(cfg, {k: torch.from_numpy(v) for k, v in p.items()},
                           torch.from_numpy(x))
    jy, jaux = jax.jit(lambda p, x: jax_moe.moe_block(jcfg, p, x))(p, x)
    assert y.shape == x.shape and y.dtype == torch.float32
    np.testing.assert_allclose(_np(y), np.asarray(jy), atol=BLOCK_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-6, rtol=0)


def test_ties_go_to_the_lower_index():
    rng = np.random.default_rng(5)
    probs = rng.integers(0, 4, size=(64, 16)).astype(np.float32)  # ties everywhere
    vals, idx = moe.top_k_lower_index(torch.from_numpy(probs), 5)
    jvals, jidx = jax.lax.top_k(jnp.asarray(probs), 5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(vals.numpy(), np.asarray(jvals))


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_moe_block_keeps_bf16(name):
    cfg, _ = _smoke(name)
    p = {k: torch.from_numpy(v).to(torch.bfloat16)
         for k, v in _block_params(cfg, np.random.default_rng(1)).items()}
    x = torch.randn(2, 5, cfg.d_model, generator=torch.Generator().manual_seed(0))
    y, aux = moe.moe_block(cfg, p, x.to(torch.bfloat16))
    assert y.dtype == torch.bfloat16 and aux.dtype == torch.float32
    y32, _ = moe.moe_block(cfg, {k: v.float() for k, v in p.items()},
                           x.to(torch.bfloat16).float())
    assert float((y.float() - y32).abs().max()) < 0.1


def _specs(tree, leaf):
    if isinstance(tree, dict):
        return {k: _specs(v, leaf) for k, v in tree.items()}
    if isinstance(tree, list):
        return [_specs(v, leaf) for v in tree]
    return leaf(tree)


@pytest.mark.parametrize("smoke", [True, False])
@pytest.mark.parametrize("name", MOE_ARCHS)
def test_param_specs_equal_reference(name, smoke):
    cfg, jcfg = _smoke(name) if smoke else (configs.get(name), jax_configs.get(name))
    got = _specs(param_specs(cfg), lambda s: (tuple(s.shape), s.init, s.fan_in_axis))
    want = _specs(jax_param_specs(jcfg), lambda s: (tuple(s.shape), s.init, s.fan_in_axis))
    assert got == want


CASES = [(name, {}) for name in MOE_ARCHS] + [("qwen3-moe-30b-a3b", {"moe_every": 2})]


def _models(name, kw, seed=3):
    cfg, jcfg = _smoke(name, **kw)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(seed))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, jparams, params


@pytest.mark.parametrize("name,kw", CASES)
def test_prefill_decode_and_forward_match_reference(name, kw):
    cfg, jcfg, jparams, params = _models(name, kw)
    assert sum(f == "moe" for _, f in cfg.layer_pattern()[0]) == 1
    max_seq, b, s = 32, 2, 9
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    j_pre = jax.jit(lambda p, t: jax_prefill(jcfg, p, {"tokens": t}, max_seq))
    j_dec = jax.jit(lambda p, t, c: jax_decode_step(jcfg, p, t, c))
    jl, jc = j_pre(jparams, jnp.asarray(tokens))
    tl, tc = prefill(cfg, params, {"tokens": torch.from_numpy(tokens)}, max_seq)
    for step in range(4):
        np.testing.assert_allclose(_np(tl), _np(jl), atol=LOGIT_ATOL, rtol=0,
                                   err_msg=f"step {step}")
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[:, None]
        jl, jc = j_dec(jparams, jnp.asarray(nxt), jc)
        tl, tc = decode_step(cfg, params, torch.from_numpy(nxt), tc)
    got, aux = forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    want, jaux = jax.jit(lambda p, t: jax_forward(jcfg, p, {"tokens": t}))(jparams, tokens)
    np.testing.assert_allclose(_np(got), _np(want), atol=LOGIT_ATOL, rtol=0)
    np.testing.assert_allclose(float(aux), float(jaux), atol=1e-5, rtol=0)
    assert float(aux) > 0


@pytest.mark.parametrize("name", MOE_ARCHS)
def test_engine_greedy_tokens_equal_reference(name):
    cfg, jcfg, jparams, params = _models(name, {}, seed=0)
    jcfg = dataclasses.replace(jcfg, use_flash_kernel=True)
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, cfg.vocab_size, size=10).astype(np.int32) for _ in range(3)]
    n_new = [6, 3, 6]
    want = JaxEngine(jcfg, jparams, 4, 24).generate(
        [JaxRequest(p, n) for p, n in zip(prompts, n_new)])
    got = Engine(cfg, params, 4, 24, device="cpu").generate(
        [Request(p, n) for p, n in zip(prompts, n_new)])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert [r.done for r in got] == [r.done for r in want]
