"""The backward kernels' host side on the CPU: the plain row statistic and
chunk states that the forward kernels store for the backward, against the
JAX package, and the backward kernels' launch plans from shapes alone.

* ``attention_lse_ref`` (the forward's stored log-sum-exp, base 2 of the
  scaled, masked logits, +inf for a row that sees no key) against
  ``jax.nn.logsumexp`` of the same logits built in JAX, divided by ln 2:
  within 1e-5 + 1e-6 |lse| (f32, two summation orders), the +inf rows
  exactly.
* ``selective_scan_chunk_states_ref`` (the scan forward's stored state
  before every 8th step): entry c against the final state of the JAX
  ``selective_scan_ref`` run on the first 8 c steps, within 1e-5 of the
  largest state (f32, the same recurrence in another loop).
* ``flash_bwd_plan`` and ``scan_bwd_plan``: block counts, padding, tile
  sizes, scratch and shared memory, as the C entry points check them.

Inputs come from a numpy seed.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan.ref import selective_scan_ref
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import attention_lse_ref
from repro_torch.kernels.ssm_scan import kernel as ss_kernel
from repro_torch.kernels.ssm_scan.ref import selective_scan_chunk_states_ref

H100_SMEM = 232_448  # bytes of shared memory a block may use on the H100
H100_SM_SMEM = 233_472  # of an SM's 256 KB, what its blocks may share (228 KB)


def _jax_lse2(q, k, causal, offset):
    """log2 of sum_j 2^(scaled logit) per row, built in JAX: GQA by a
    repeat of K, the causal mask as the JAX attention_ref builds it."""
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    kk = jnp.repeat(jnp.asarray(k), hq // hkv, axis=1)
    logits = jnp.einsum("bhqd,bhkd->bhqk", jnp.asarray(q), kk) * d**-0.5
    if causal:
        start = sk - sq if offset is None else offset
        mask = jnp.arange(sk)[None, :] <= jnp.arange(sq)[:, None] + start
        logits = jnp.where(mask, logits, -jnp.inf)
    lse = jax.nn.logsumexp(logits, axis=-1) / math.log(2.0)
    return np.asarray(jnp.where(jnp.isneginf(lse), jnp.inf, lse))


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal,offset", [
    (2, 9, 3, 33, 33, 64, True, None),     # smollm-135m's 9:3
    (1, 8, 1, 17, 40, 32, True, None),     # Sq < Sk, end-aligned, group 8
    (1, 6, 2, 12, 50, 16, False, None),    # full, Sq < Sk
    (2, 4, 2, 9, 9, 16, True, -4),         # a negative offset: rows that see no key
    (1, 4, 4, 1, 33, 80, True, None),      # one query row (the decode kernel's case)
])
def test_attention_lse_ref_matches_jax_logsumexp(b, hq, hkv, sq, sk, d, causal, offset):
    rng = np.random.default_rng(sq * 31 + d)
    q = rng.standard_normal((b, hq, sq, d)).astype(np.float32)
    k = rng.standard_normal((b, hkv, sk, d)).astype(np.float32)
    got = attention_lse_ref(torch.from_numpy(q), torch.from_numpy(k), causal=causal,
                            offset=offset).numpy()
    want = _jax_lse2(q, k, causal, offset)
    assert got.shape == (b, hq, sq) and got.dtype == np.float32
    np.testing.assert_array_equal(np.isinf(got), np.isinf(want))
    fin = np.isfinite(want)
    assert np.all(np.abs(got[fin] - want[fin]) <= 1e-5 + 1e-6 * np.abs(want[fin]))
    if offset is not None and offset < 0:
        assert np.isinf(got).any() and (got[np.isinf(got)] > 0).all()


def _scan_inputs(rng, b, s, d, n):
    dt = np.log1p(np.exp(rng.standard_normal((b, s, d)) - 1.0)).astype(np.float32)  # softplus
    bm = rng.standard_normal((b, s, n)).astype(np.float32)
    cm = rng.standard_normal((b, s, n)).astype(np.float32)
    x = rng.standard_normal((b, s, d)).astype(np.float32)
    a = -np.exp(0.5 * rng.standard_normal((d, n))).astype(np.float32)
    h0 = rng.standard_normal((b, d, n)).astype(np.float32)
    return dt, bm, cm, x, a, h0


@pytest.mark.parametrize("b,s,d,n", [(2, 33, 24, 16), (1, 8, 16, 4), (3, 17, 7, 5), (1, 1, 9, 1)])
def test_chunk_states_ref_matches_jax_prefix_scans(b, s, d, n):
    rng = np.random.default_rng(s * 7 + n)
    args = _scan_inputs(rng, b, s, d, n)
    got = selective_scan_chunk_states_ref(*(torch.from_numpy(a) for a in args)).numpy()
    assert got.shape == ss_kernel.chunk_states_shape(b, s, d, n) == (b, -(-s // 8), d, n)
    np.testing.assert_array_equal(got[:, 0], args[5])  # chunk 0's state is h0
    scan = jax.jit(selective_scan_ref)
    for c in range(1, got.shape[1]):
        t = 8 * c
        _, want = scan(*(jnp.asarray(a[:, :t]) for a in args[:4]), jnp.asarray(args[4]),
                       jnp.asarray(args[5]))
        want = np.asarray(want)
        assert np.abs(got[:, c] - want).max() <= 1e-5 * max(np.abs(want).max(), 1.0)


@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (8, 9, 3, 128, 128, 64),      # smollm-135m's step at the launcher's defaults
    (16, 9, 3, 1024, 1024, 64),   # smollm-135m's timed stretch
    (8, 32, 4, 128, 128, 128),    # qwen3-moe: group 8, head_dim 128
    (8, 48, 8, 384, 384, 128),    # internvl2: group 6, 384 rows
    (8, 8, 8, 128, 1500, 64),     # whisper's cross-attention over 1,500 frames
    (2, 32, 32, 33, 33, 80),      # stablelm-3b's head_dim 80
    (1, 4, 1, 17, 40, 16),        # head_dim 16, Sq < Sk
])
def test_flash_bwd_plan_from_shapes(b, hq, hkv, sq, sk, d):
    plan = fa_kernel.flash_bwd_plan(b, hq, hkv, sq, sk, d, torch.bfloat16)
    assert plan.kernel == "wgmma" and plan.threads == 160  # a warpgroup and the producer warp
    assert plan.head_dim == (64 if d <= 64 else 128)  # 16, 32 padded; 80, 112 run at 128
    assert plan.query_tile == (64 if plan.head_dim == 64 else 32)
    assert plan.key_rows == plan.query_rows == 64
    assert plan.dkdv_blocks == math.ceil(sk / 64) * hkv * b  # 64 keys of one KV head each
    assert plan.dq_blocks == math.ceil(sq / 64) * hq * b  # 64 rows of one query head each
    assert plan.blocks == plan.dkdv_blocks + plan.dq_blocks
    # K, V (or Q, dO) resident, the ring, barriers; tiles on 1,024 bytes
    assert plan.stages == (4 if plan.head_dim == 64 else 2)
    tile = 64 * plan.head_dim * 2
    stage = max(2 * tile, 2 * plan.query_tile * plan.head_dim * 2 + 2 * plan.query_tile * 4)
    assert 2 * tile + plan.stages * stage <= plan.smem_bytes <= H100_SMEM
    assert H100_SM_SMEM // plan.smem_bytes >= 2  # two blocks an SM
    # the model's transposed views read in place where q, k, v and dO take
    # at most half the L2
    assert plan.read_views == (4 * d * (b * hq * sq + b * hkv * sk) <= 25 << 20)
    # the same shapes in f32: the CUDA-core kernels, blocks of 16 rows or keys
    f32 = fa_kernel.flash_bwd_plan(b, hq, hkv, sq, sk, d, torch.float32)
    assert f32.kernel == "cuda_core" and f32.head_dim == d and f32.threads == 128
    assert f32.dkdv_blocks == math.ceil(sk / 16) * hkv * b
    assert f32.dq_blocks == math.ceil(sq / 16) * hq * b
    assert f32.smem_bytes <= 48 * 1024 or d > 64 and not f32.read_views


def test_tma_layout_from_strides():
    """Which of the two tensor-map layouts reads a [B, H, S, D] tensor in
    place: 0 for the contiguous layout (or one batch element), 1 for the
    model's [B, S, H, D] viewed as [B, H, S, D] with S a multiple of 64,
    None (copy first) otherwise."""
    bf = torch.bfloat16
    assert fa_kernel.tma_layout(torch.empty(2, 9, 128, 64, dtype=bf)) == 0
    view = torch.empty(2, 128, 9, 64, dtype=bf).transpose(1, 2)
    assert fa_kernel.tma_layout(view) == 1
    assert fa_kernel.tma_layout(torch.empty(2, 100, 9, 64, dtype=bf).transpose(1, 2)) is None
    assert fa_kernel.tma_layout(torch.empty(1, 100, 9, 64, dtype=bf).transpose(1, 2)) == 0
    assert fa_kernel.tma_layout(torch.empty(2, 9, 128, 72, dtype=bf)[..., :64]) == 0  # 144 B rows
    assert fa_kernel.tma_layout(torch.empty(2, 9, 128, 68, dtype=bf)[..., :64]) is None  # 136 B
    assert fa_kernel.tma_layout(torch.empty(2, 9, 64, 128, dtype=bf).transpose(2, 3)) is None
    assert fa_kernel.tma_layout(torch.empty(2 * 9 * 128 * 64 + 1, dtype=bf)[1:].view(
        2, 9, 128, 64)) is None  # a base off 16 bytes


def test_flash_bwd_plan_fills_the_card_at_smollms_step():
    """At seq 128 the dK/dV blocks alone are 48 on 132 SMs; with the dQ
    blocks in the same grid every SM gets work."""
    plan = fa_kernel.flash_bwd_plan(8, 9, 3, 128, 128, 64, torch.bfloat16)
    assert plan.dkdv_blocks == 48 and plan.blocks == 192 >= fa_kernel.H100_SMS
    assert plan.read_views  # 3 MB of q, k, v, dO: read in place
    # the timed stretch (seq 1024, batch 16): 48 MB, copied first
    long = fa_kernel.flash_bwd_plan(16, 9, 3, 1024, 1024, 64, torch.bfloat16)
    assert long.blocks == 768 + 2304 and not long.read_views
    with pytest.raises(TypeError):
        fa_kernel.flash_bwd_plan(8, 9, 3, 128, 128, 64, torch.float16)


@pytest.mark.parametrize("n,lanes,channels", [(1, 1, 256), (4, 1, 256), (5, 2, 128), (8, 2, 128),
                                              (12, 4, 64), (16, 4, 64)])
def test_scan_bwd_plan_from_shapes(n, lanes, channels):
    b, s, d = 8, 128, 8192  # falcon-mamba's training step
    plan = ss_kernel.scan_bwd_plan(b, s, d, n)
    assert (plan.lanes, plan.channels) == (lanes, channels)
    assert plan.lanes * plan.channels == ss_kernel.BWD_THREADS
    assert plan.lanes * 4 >= n  # 4 states a lane
    assert plan.blocks == math.ceil(d / channels)
    assert plan.part_bc == b * plan.blocks * s * n and plan.part_a == b * d * n
    assert plan.scratch == 2 * plan.part_bc + plan.part_a
    assert plan.smem_bytes <= H100_SMEM
    if n > 4:  # two blocks an SM
        assert 2 * plan.smem_bytes <= H100_SM_SMEM
    ragged = ss_kernel.scan_bwd_plan(3, 17, 100, n)
    assert ragged.blocks == math.ceil(100 / channels)
    assert ragged.part_bc == 3 * ragged.blocks * 17 * n


def test_scan_bwd_plan_at_falcon_mambas_step():
    plan = ss_kernel.scan_bwd_plan(8, 128, 8192, 16)
    assert plan.blocks * 8 == 1024 and plan.smem_bytes == 80_896
    # the scratch: 2 x 8 MB of dB/dC partials and 4 MB of dA partials; the
    # forward's chunk states 67 MB
    assert plan.scratch * 4 == 20_971_520
    assert math.prod(ss_kernel.chunk_states_shape(8, 128, 8192, 16)) * 4 == 67_108_864
