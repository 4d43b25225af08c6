"""The port's W8A8 matmul op on the CPU (its plain PyTorch version)
against the JAX package: bit-equal to the oracle ``quant_matmul_ref``
(exact int32 sums, then ``* x_scale * w_scale`` in f32) on the sweep of
``tests/test_quant_matmul.py``, with unit scales, and at K = 4096 where
sums pass 2^24; and equal to the Pallas kernel in interpret mode where
K <= 512, whose f32 sums are exact there.  Tolerance: none, every
comparison is exact."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.quant_matmul import quant_matmul as jax_quant_matmul
from repro.kernels.quant_matmul.ref import quant_matmul_ref as jax_quant_matmul_ref
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.quant_matmul import kernel as qmm_kernel
from repro_torch.kernels.quant_matmul import layout


def _inputs(m, k, n, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, size=(m, k)).astype(np.int8)
    w = rng.integers(-128, 128, size=(k, n)).astype(np.int8)
    xs = rng.uniform(0.5, 2.0, m).astype(np.float32)
    ws = rng.uniform(0.01, 0.1, n).astype(np.float32)
    return x, w, xs, ws


def _port(x, w, xs, ws):
    return quant_matmul(*(torch.from_numpy(u) for u in (x, w, xs, ws))).numpy()


@pytest.mark.parametrize("m,k,n,bm,bn,bk", [
    (128, 256, 128, 128, 128, 256),  # exactly one block
    (256, 512, 256, 128, 128, 256),  # multi-block all dims
    (64, 128, 32, 32, 32, 64),  # small blocks
    (100, 200, 60, 32, 32, 64),  # ragged (padded by the JAX op)
])
def test_matches_jax_ref_and_pallas_bit_for_bit(m, k, n, bm, bn, bk):
    x, w, xs, ws = _inputs(m, k, n, seed=m + n)
    got = _port(x, w, xs, ws)
    assert got.dtype == np.float32 and got.shape == (m, n)
    np.testing.assert_array_equal(got, np.asarray(jax_quant_matmul_ref(x, w, xs, ws)))
    pallas = jax_quant_matmul(*map(jnp.asarray, (x, w, xs, ws)), use_pallas=True,
                              block_m=bm, block_n=bn, block_k=bk)
    np.testing.assert_array_equal(got, np.asarray(pallas))


def test_unit_scales_give_the_exact_integer_product():
    x, w, _, _ = _inputs(64, 128, 64, seed=7)
    got = _port(x, w, np.ones(64, np.float32), np.ones(64, np.float32))
    np.testing.assert_array_equal(got.astype(np.int64), x.astype(np.int64) @ w.astype(np.int64))


def test_sums_past_2_24_stay_exact():
    """K = 4096 with rows and columns of extreme values: sums reach 2^26,
    where f32 summation (the Pallas kernel's) rounds; the oracle's int32
    sums, and the port's, do not."""
    x, w, xs, ws = _inputs(64, 4096, 48, seed=11)
    x[:8], w[:, :8] = 127, 127
    w[0, :8] = 126  # odd sums: not representable in f32 above 2^24
    x[8:12], w[:, 8:12] = -128, -128
    exact = x.astype(np.int64) @ w.astype(np.int64)
    assert np.abs(exact).max() >= 2**25 and (exact[:8, :8] % 2 == 1).all()
    got = _port(x, w, xs, ws)
    np.testing.assert_array_equal(got, np.asarray(jax_quant_matmul_ref(x, w, xs, ws)))
    ones_m, ones_n = np.ones(64, np.float32), np.ones(48, np.float32)
    np.testing.assert_array_equal(_port(x, w, ones_m, ones_n), exact.astype(np.float32))


def test_cpu_tensors_take_the_plain_version():
    x, w, xs, ws = (torch.from_numpy(u) for u in _inputs(20, 40, 12, seed=3))
    before = qmm_kernel.launches.value
    got = quant_matmul(x, w, xs, ws)
    assert qmm_kernel.launches.value == before
    want = (x.long() @ w.long()).float() * xs[:, None] * ws[None, :]
    assert torch.equal(got, want)
    with pytest.raises(ValueError, match="CUDA or CPU"):
        quant_matmul(x.to("meta"), w.to("meta"), xs.to("meta"), ws.to("meta"))


# ----------------------------------------------------------------------
# the entry rule and the TMA/wgmma kernel's operand layout (layout.py),
# walked in numpy because the kernel runs only on the card
# ----------------------------------------------------------------------
@pytest.mark.parametrize("n,k,x_ptr,w_ptr,out_ptr,entry", [
    (16384, 4096, 0, 1 << 20, 1 << 30, "tma"),  # falcon-mamba-7b's in_proj at prefill
    (16400, 4096, 256, 512, 1024, "tma"),  # a ragged N tile, aligned rows
    (16, 16, 16, 32, 48, "tma"),
    (60, 200, 0, 0, 0, "mma_sync"),  # N % 16 != 0: w's rows cannot be a tensor map
    (128, 200, 0, 0, 0, "mma_sync"),  # K % 16 != 0: x's rows
    (128, 256, 8, 0, 0, "mma_sync"),  # x 8 bytes off 16-byte alignment
    (128, 256, 0, 4, 0, "mma_sync"),
    (128, 256, 0, 0, 8, "mma_sync"),  # the epilogue's 16-byte stores
    (128, 0, 0, 0, 0, "mma_sync"),  # K = 0: nothing to load
])
def test_qmm_entry_picks_by_shape_and_alignment(n, k, x_ptr, w_ptr, out_ptr, entry):
    assert qmm_kernel.qmm_entry(n, k, x_ptr, w_ptr, out_ptr) == entry
    assert entry in qmm_kernel.KERNELS


@pytest.mark.parametrize("k,seed", [(128, 0), (256, 1), (384, 2)])
def test_wgmma_layout_emulation_is_the_exact_product(k, seed):
    """x and w through the TMA boxes' swizzle, w's A fragments (shared loads
    and byte transposes), the B descriptor's addressing and the
    accumulator map back to (m, n): exactly x @ w."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-128, 128, (layout.BLOCK_M, k)).astype(np.int8)
    w = rng.integers(-128, 128, (k, layout.BLOCK_N)).astype(np.int8)
    x[0], w[:, 0] = 127, -128  # the extremes
    np.testing.assert_array_equal(layout.emulate_tile(x, w),
                                  x.astype(np.int64) @ w.astype(np.int64))


def test_a_fragment_loads_hit_32_banks():
    """Threads t = 2, 3 load their rows rotated by two: every load
    instruction of a warp is one wavefront; unrotated, two."""
    assert {layout.bank_wavefronts(kk, p) for kk in range(4) for p in range(2)} == {1}
    assert layout.load_rows(0) == layout.load_rows(1) == [0, 1, 2, 3]
    assert layout.load_rows(2) == layout.load_rows(3) == [2, 3, 0, 1]


@pytest.mark.parametrize("t", range(4))
def test_byte_transpose_undoes_the_rotation(t):
    rng = np.random.default_rng(t)
    block = rng.integers(0, 256, (4, 4))  # [row k][byte n]
    word = lambda row: int(sum(int(v) << (8 * i) for i, v in enumerate(row)))  # noqa: E731
    loaded = [word(block[r]) for r in layout.load_rows(t)]
    assert layout.transpose_loaded(loaded, t) == [word(block[:, j]) for j in range(4)]


def test_swizzle_and_fragment_maps_are_bijections():
    atom = np.arange(1024)
    assert sorted(layout.swizzle128(atom)) == list(atom)
    a_cells = {layout.a_reg_coords(w, lane, r, b)
               for w in range(4) for lane in range(32) for r in range(4) for b in range(4)}
    assert a_cells == {(row, k) for row in range(64) for k in range(32)}
    d_cells = {layout.d_coords(w, lane, r)
               for w in range(4) for lane in range(32) for r in range(layout.BLOCK_M // 2)}
    assert d_cells == {(row, m) for row in range(64) for m in range(layout.BLOCK_M)}
    ns = [layout.n_of(c, w, g, s, h) for c in range(layout.CONSUMERS) for w in range(4)
          for g in range(8) for s in range(layout.SLABS) for h in range(2)]
    assert sorted(ns) == list(range(layout.BLOCK_N))
    # the ring fits a block's 227 KB of shared memory
    assert layout.STAGES * (layout.X_STAGE_BYTES + layout.W_STAGE_BYTES) + 1024 <= 232448
