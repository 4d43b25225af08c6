"""Attention at head_dim 80 (stablelm-3b) and 112 (kimi-k2), and decode
at granite-20b's 48:1 GQA group, on the CPU against the JAX package.

* The plain flash version against ``attention_ref`` and, where the
  blocks divide, the Pallas kernel in interpret mode: f32 and bf16,
  causal and full, prefill and decode against a mostly unwritten cache.
  Tolerances, the JAX kernel tests': atol 2e-5 in f32, 2e-2 in bf16.
* Reduced dense LMs at head_dim 80 and 112 (stablelm-3b's and
  qwen3-32b's reduced configs with the head_dim set; qwen3 adds qk-norm)
  served by the port's ``Engine`` reproduce the JAX engine's greedy
  tokens exactly, and prefill and decode logits agree within 1e-4 (f32,
  sums in another order).
* ``flash_plan`` sends head_dim 80/112 decode to the decode kernel and
  the 48:1 decode to the prefill kernels (48 rows pass the decode
  kernel's 16).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref
from repro.models import decode_step as jax_decode_step
from repro.models import init_params as jax_init_params
from repro.models.transformer import prefill as jax_prefill
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch import configs
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.models import decode_step, params_from_numpy, prefill
from repro_torch.serve import Engine, Request

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}
LM_ATOL = 1e-4

jax_attention_ref = jax.jit(attention_ref, static_argnames=("causal", "scale"))


def _inputs(seed, b, hq, hkv, sq, sk, d, dtype):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    return ([torch.from_numpy(a).to(TORCH[dtype]) for a in arrs],
            [jnp.asarray(a, JNP[dtype]) for a in arrs])


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.asarray(x, np.float32)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (2, 4, 4, 64, 64, 80),  # stablelm-3b's MHA at head_dim 80
    (1, 8, 2, 64, 128, 112),  # GQA at head_dim 112
    (2, 4, 1, 37, 53, 80),  # ragged
    (1, 6, 3, 29, 29, 112),  # ragged
])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax(b, hq, hkv, sq, sk, d, causal, dtype):
    (q, k, v), (jq, jk, jv) = _inputs(sq * 10 + d + int(causal), b, hq, hkv, sq, sk, d, dtype)
    got = flash_attention(q, k, v, causal=causal)
    assert got.dtype == TORCH[dtype] and got.shape == (b, hq, sq, d)
    np.testing.assert_allclose(_np(got), _np(jax_attention_ref(jq, jk, jv, causal=causal)),
                               atol=ATOL[dtype], rtol=0)
    if sq % 64 == 0 and sk % 64 == 0:  # the Pallas wrapper needs divisible blocks
        want = jax_flash_attention(jq, jk, jv, causal=causal, use_pallas=True, block_q=64,
                                   block_k=64)
        np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("hq,hkv,d", [(32, 32, 80), (8, 1, 112), (48, 1, 128)],
                         ids=["stablelm-80", "gqa-112", "granite-48:1"])
@pytest.mark.parametrize("pos", [0, 127, 255])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_decode_against_a_cache(hq, hkv, d, pos, dtype):
    """One query per head at cache position ``pos`` (an int32 tensor) in a
    256-slot cache whose unwritten slots hold garbage."""
    (q, k, v), (jq, _, _) = _inputs(pos + d, 2, hq, hkv, 1, 256, d, dtype)
    for t in (k, v):
        t[:, :, pos + 1:] = 1e4
    jk, jv = (jnp.asarray(t.float().numpy(), JNP[dtype]) for t in (k, v))
    got = flash_attention(q, k, v, causal=True, offset=torch.tensor(pos, dtype=torch.int32))
    want = jax_attention_ref(jq, jk, jv, causal=True, offset=jnp.int32(pos))
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL[dtype], rtol=0)
    want_pallas = jax_flash_attention(jq, jk, jv, causal=True, offset=jnp.int32(pos),
                                      use_pallas=True, block_q=1, block_k=128)
    np.testing.assert_allclose(_np(got), _np(want_pallas), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("shape,dtype,want", [
    ((8, 32, 32, 1, 512), torch.bfloat16, ("decode", 1)),  # stablelm-3b: 256 (b, KV head) pairs
    ((8, 32, 32, 128, 128), torch.bfloat16, ("tensor_core", 1)),  # stablelm-3b's prefill
    ((1, 8, 1, 1, 512), torch.float32, ("decode", 8)),
    ((8, 48, 1, 1, 512), torch.bfloat16, ("tensor_core", 1)),  # granite-20b: 48 rows per group
    ((8, 48, 1, 1, 512), torch.float32, ("cuda_core", 1)),
], ids=["stablelm-decode", "stablelm-prefill", "gqa-decode", "granite-bf16", "granite-f32"])
def test_flash_plan(shape, dtype, want):
    assert tuple(fa_kernel.flash_plan(*shape, dtype, n_sms=132)) == want
    assert 80 in fa_kernel.HEAD_DIMS and 112 in fa_kernel.HEAD_DIMS


LMS = [("stablelm-3b", dict(head_dim=80)), ("qwen3-32b", dict(head_dim=112))]


@pytest.fixture(scope="module", params=LMS, ids=["stablelm-hd80", "qwen3-hd112"])
def lm(request):
    name, kw = request.param
    cfg, jcfg = configs.get_smoke(name, **kw), jax_configs.get_smoke(name, **kw)
    assert cfg.hd == kw["head_dim"]
    jcfg = dataclasses.replace(jcfg, use_flash_kernel=True)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(5))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jcfg, jparams, params


def test_prefill_and_decode_logits_match_reference(lm):
    cfg, jcfg, jparams, params = lm
    max_seq, b, s = 32, 2, 9
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    jl, jc = jax.jit(lambda p, t: jax_prefill(jcfg, p, {"tokens": t}, max_seq))(
        jparams, jnp.asarray(tokens))
    j_dec = jax.jit(lambda p, t, c: jax_decode_step(jcfg, p, t, c))
    tl, tc = prefill(cfg, params, {"tokens": torch.from_numpy(tokens)}, max_seq)
    for step in range(3):
        np.testing.assert_allclose(_np(tl), _np(jl), atol=LM_ATOL, rtol=0, err_msg=f"step {step}")
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[:, None]
        jl, jc = j_dec(jparams, jnp.asarray(nxt), jc)
        tl, tc = decode_step(cfg, params, torch.from_numpy(nxt), tc)


def test_engine_greedy_tokens_equal_reference(lm):
    cfg, jcfg, jparams, params = lm
    rng = np.random.default_rng(4)
    prompts = [rng.integers(2, cfg.vocab_size, size=10).astype(np.int32) for _ in range(3)]
    n_new = [6, 3, 6]
    want = JaxEngine(jcfg, jparams, 4, 24).generate(
        [JaxRequest(p, n) for p, n in zip(prompts, n_new)])
    got = Engine(cfg, params, 4, 24, device="cpu").generate(
        [Request(p, n) for p, n in zip(prompts, n_new)])
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert all(len(r.out_tokens) == n for r, n in zip(got, n_new))
