"""The port's attention op on the CPU (its plain PyTorch version) against
the JAX package: ``attention_ref`` and the Pallas kernel in interpret
mode (``flash_attention(..., use_pallas=True)``).

The sweep of ``tests/test_kernels.py`` (shapes, causal and full, f32 and
bf16, decode with one query, future keys masked), plus smollm-135m's 9:3
GQA group at head_dim 64, decode against a mostly unwritten cache at
offsets given as an int32 tensor, and the chunked path.  Inputs come
from a numpy seed and are cast to the working dtype on both sides (the
same round-to-nearest-even bits).  Tolerances, those of the JAX kernel
tests: atol 2e-5 in f32 (sums in another order) and 2e-2 in bf16 (the
Pallas kernel keeps ``p`` in f32 where the references cast it to bf16,
and the outputs round to bf16).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.flash_attention import flash_attention as jax_flash_attention
from repro.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ref as fa_ref

ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
JNP = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}
TORCH = {"float32": torch.float32, "bfloat16": torch.bfloat16}

# jitted once per shape: eager JAX compiles every op of the reference anew
jax_attention_ref = jax.jit(attention_ref, static_argnames=("causal", "scale"))


def _inputs(seed, b, hq, hkv, sq, sk, d, dtype):
    """(torch q, k, v), (jax q, k, v) of the same values in ``dtype``."""
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal(s).astype(np.float32)
            for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]
    return ([torch.from_numpy(a).to(TORCH[dtype]) for a in arrs],
            [jnp.asarray(a, JNP[dtype]) for a in arrs])


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.float().numpy()
    return np.asarray(x, np.float32)


SHAPES = [
    (2, 4, 4, 128, 128, 64),  # MHA square
    (1, 8, 2, 128, 128, 32),  # GQA 4:1
    (2, 4, 1, 64, 256, 32),  # MQA, decode-ish (sq < sk)
    (1, 2, 2, 256, 256, 128),  # larger head dim
    (2, 9, 3, 64, 64, 64),  # smollm-135m: 9 query heads on 3 KV heads
    (1, 4, 2, 37, 53, 16),  # ragged: divides no tile
]


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", SHAPES)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_plain_version_matches_jax(b, hq, hkv, sq, sk, d, causal, dtype):
    (q, k, v), (jq, jk, jv) = _inputs(b * 1000 + hq * 100 + sq + int(causal), b, hq, hkv, sq,
                                      sk, d, dtype)
    got = flash_attention(q, k, v, causal=causal)
    assert got.dtype == TORCH[dtype] and got.shape == (b, hq, sq, d)
    want_ref = jax_attention_ref(jq, jk, jv, causal=causal)
    np.testing.assert_allclose(_np(got), _np(want_ref), atol=ATOL[dtype], rtol=0)
    if sq % 64 == 0 and sk % 64 == 0:  # the Pallas wrapper needs divisible blocks
        want_pallas = jax_flash_attention(jq, jk, jv, causal=causal, use_pallas=True,
                                          block_q=64, block_k=64)
        np.testing.assert_allclose(_np(got), _np(want_pallas), atol=ATOL[dtype], rtol=0)


def test_decode_single_query():
    (q, k, v), (jq, jk, jv) = _inputs(7, 2, 8, 2, 1, 512, 64, "float32")
    got = flash_attention(q, k, v, causal=True)
    want = jax_flash_attention(jq, jk, jv, causal=True, use_pallas=True, block_q=1,
                               block_k=128)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL["float32"], rtol=0)
    np.testing.assert_allclose(_np(got), _np(jax_attention_ref(jq, jk, jv)),
                               atol=ATOL["float32"], rtol=0)


def test_causal_masks_future():
    """Perturbing future keys does not change the causal output."""
    (q, k, v), _ = _inputs(3, 1, 2, 2, 128, 128, 32, "float32")
    out1 = flash_attention(q, k, v, causal=True)
    k2, v2 = k.clone(), v.clone()
    k2[:, :, 64:] = 99.0
    v2[:, :, 64:] = -99.0
    out2 = flash_attention(q, k2, v2, causal=True)
    np.testing.assert_allclose(_np(out1[:, :, :64]), _np(out2[:, :, :64]), atol=1e-6, rtol=0)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("pos", [0, 1, 127, 128, 255])
def test_decode_against_a_cache(dtype, pos):
    """Decode as the LM runs it: smollm's 9:3 heads, one query at cache
    position ``pos`` (an int32 tensor), a 256-slot cache of which only
    slots 0..pos are written; the unwritten slots hold garbage that the
    mask must hide."""
    max_seq = 256
    (q, k, v), (jq, jk, jv) = _inputs(pos, 2, 9, 3, 1, max_seq, 64, dtype)
    for t in (k, v):
        t[:, :, pos + 1:] = 1e4
    jk = jnp.asarray(k.float().numpy(), JNP[dtype])
    jv = jnp.asarray(v.float().numpy(), JNP[dtype])
    got = flash_attention(q, k, v, causal=True, offset=torch.tensor(pos, dtype=torch.int32))
    want_ref = jax_attention_ref(jq, jk, jv, causal=True, offset=jnp.int32(pos))
    np.testing.assert_allclose(_np(got), _np(want_ref), atol=ATOL[dtype], rtol=0)
    want_pallas = jax_flash_attention(jq, jk, jv, causal=True, offset=jnp.int32(pos),
                                      use_pallas=True, block_q=1, block_k=128)
    np.testing.assert_allclose(_np(got), _np(want_pallas), atol=ATOL[dtype], rtol=0)
    live = flash_attention(q, k[:, :, : pos + 1], v[:, :, : pos + 1], causal=True)
    np.testing.assert_allclose(_np(got), _np(live), atol=ATOL[dtype], rtol=0)


@pytest.mark.parametrize("causal", [True, False])
def test_chunked_path_matches_jax(monkeypatch, causal):
    """Above ``Sq * Sk = 2**24`` the plain version loops over query
    chunks; shrink the threshold so a small input takes that path."""
    monkeypatch.setattr(fa_ref, "_DENSE_MAX_ELEMS", 1 << 10)
    monkeypatch.setattr(fa_ref, "_CHUNK", 64)
    (q, k, v), (jq, jk, jv) = _inputs(11, 1, 4, 2, 200, 328, 32, "float32")
    got = fa_ref.attention_ref(q, k, v, causal=causal, offset=128)
    want = attention_ref(jq, jk, jv, causal=causal, offset=128)  # chunked: needs an int offset
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL["float32"], rtol=0)
    with pytest.raises(ValueError, match="int offset"):
        fa_ref.attention_ref(q, k, v, causal=True, offset=torch.tensor(128, dtype=torch.int32))


def test_scale_and_offset_defaults():
    (q, k, v), (jq, jk, jv) = _inputs(5, 1, 4, 2, 16, 48, 32, "float32")
    got = flash_attention(q, k, v, causal=True, scale=0.3)
    want = jax_attention_ref(jq, jk, jv, causal=True, scale=0.3)  # offset Sk - Sq = 32
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL["float32"], rtol=0)
    np.testing.assert_allclose(
        _np(flash_attention(q, k, v, causal=True, offset=32)),
        _np(flash_attention(q, k, v, causal=True)), atol=0, rtol=0)


def test_cpu_tensors_take_the_plain_version_and_launch_nothing():
    (q, k, v), _ = _inputs(1, 1, 4, 2, 8, 8, 16, "float32")
    before = fa_kernel.launches.value
    np.testing.assert_array_equal(_np(flash_attention(q, k, v)), _np(fa_ref.attention_ref(q, k, v)))
    assert fa_kernel.launches.value == before
    with pytest.raises(ValueError, match="CUDA tensors"):
        fa_kernel.flash_attention_cuda(q, k, v)



@pytest.mark.parametrize("shape,dtype,want", [
    ((8, 9, 3, 1, 512), torch.bfloat16, ("decode", 4)),  # smollm-135m's decode: 24 (b, KV head) pairs
    ((8, 9, 3, 128, 128), torch.bfloat16, ("tensor_core", 1)),  # smollm-135m's prefill
    ((8, 9, 3, 128, 128), torch.float32, ("cuda_core", 1)),
    ((1, 4, 4, 1, 512), torch.float32, ("decode", 8)),
    ((64, 8, 8, 1, 512), torch.bfloat16, ("decode", 1)),  # 512 pairs fill the card alone
    ((2, 32, 1, 1, 128), torch.bfloat16, ("tensor_core", 1)),  # 32 rows: past the decode tile
    ((1, 2, 1, 8, 40), torch.float32, ("decode", 1)),  # 40 keys: one split of at least 32
], ids=["smollm-decode", "smollm-prefill", "f32-prefill", "mha-decode", "wide-batch",
        "mqa-32-rows", "short-cache"])
def test_flash_plan(shape, dtype, want):
    """The kernel and the decode splits follow from the shapes and dtype
    alone (never the offset), on a 132-SM card."""
    assert tuple(fa_kernel.flash_plan(*shape, dtype, n_sms=132)) == want
