"""The port's selective-scan op on the CPU (its plain PyTorch version)
against the JAX package: the oracle ``selective_scan_ref`` and the Pallas
kernel in interpret mode (``selective_scan(..., use_pallas=True)``).

The shapes of ``tests/test_ssm_kernel.py``, decode (S = 1), a ragged
channel count, the chained-state case (two halves with the state carried
equal one scan), the in-place state update a decode cache relies on,
and B/C given as strided views of one projection.  Inputs come from a
numpy seed.  Tolerance: atol and rtol 1e-5, the JAX kernel tests' own
(the same f32 arithmetic, with the C . h sum taken in another order).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels.ssm_scan import selective_scan as jax_selective_scan
from repro.kernels.ssm_scan.ref import selective_scan_ref as jax_selective_scan_ref
from repro_torch.kernels.ssm_scan import selective_scan
from repro_torch.kernels.ssm_scan import kernel as scan_kernel
from repro_torch.kernels.ssm_scan.kernel import scan_kernel_for
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

TOL = dict(atol=1e-5, rtol=1e-5)

jax_ref = jax.jit(jax_selective_scan_ref)


def _inputs(b, s, d, n, seed=0):
    """dt (post-softplus), B, C, x, A (negative), h0 as f32 numpy arrays."""
    rng = np.random.default_rng(seed)

    def normal(*shape):
        return rng.standard_normal(shape).astype(np.float32)

    dt = np.logaddexp(normal(b, s, d) - 1.0, 0.0).astype(np.float32)
    a = -np.exp(normal(d, n) * 0.3).astype(np.float32)
    return dt, normal(b, s, n) * 0.5, normal(b, s, n) * 0.5, normal(b, s, d), a, normal(b, d, n) * 0.1


def _torch(args):
    return [torch.from_numpy(u) for u in args]


@pytest.mark.parametrize("b,s,d,n,tile", [
    (2, 16, 32, 8, 32),  # the JAX kernel tests' shapes: single tile
    (1, 32, 64, 16, 16),  # multi-tile channels
    (3, 8, 16, 4, 8),  # small odd-ish
    (8, 1, 96, 16, 32),  # decode: one step
    (2, 10, 37, 5, 37),  # ragged channel count
])
def test_scan_matches_jax_ref_and_pallas(b, s, d, n, tile):
    args = _inputs(b, s, d, n, seed=b * 10 + s)
    y, h = selective_scan(*_torch(args))
    y_ref, h_ref = jax_ref(*map(jnp.asarray, args))
    y_pl, h_pl = jax_selective_scan(*map(jnp.asarray, args), use_pallas=True, tile_d=tile)
    assert y.dtype == h.dtype == torch.float32
    assert tuple(y.shape) == (b, s, d) and tuple(h.shape) == (b, d, n)
    for want_y, want_h in ((y_ref, h_ref), (y_pl, h_pl)):
        np.testing.assert_allclose(y.numpy(), np.asarray(want_y), **TOL)
        np.testing.assert_allclose(h.numpy(), np.asarray(want_h), **TOL)


def test_state_chaining_matches_one_scan():
    """Two halves with the state carried equal one scan, and the JAX
    Pallas kernel's full scan."""
    dt, bm, cm, x, a, h0 = _torch(_inputs(2, 24, 16, 8, seed=5))
    y_full, h_full = selective_scan(dt, bm, cm, x, a, h0)
    y1, h1 = selective_scan(dt[:, :12], bm[:, :12], cm[:, :12], x[:, :12], a, h0)
    y2, h2 = selective_scan(dt[:, 12:], bm[:, 12:], cm[:, 12:], x[:, 12:], a, h1)
    np.testing.assert_allclose(torch.cat([y1, y2], dim=1).numpy(), y_full.numpy(), atol=1e-5)
    np.testing.assert_allclose(h2.numpy(), h_full.numpy(), atol=1e-5)
    y_pl, h_pl = jax_selective_scan(*map(jnp.asarray, (dt, bm, cm, x, a, h0)), use_pallas=True,
                                    tile_d=16)
    np.testing.assert_allclose(y_full.numpy(), np.asarray(y_pl), **TOL)
    np.testing.assert_allclose(h_full.numpy(), np.asarray(h_pl), **TOL)


def test_h_out_updates_the_state_in_place():
    """The decode cache's use: h_out is h0 itself, stepped one token at a
    time, against one scan of the whole sequence."""
    dt, bm, cm, x, a, h0 = _torch(_inputs(2, 6, 24, 16, seed=3))
    y_full, h_full = selective_scan(dt, bm, cm, x, a, h0)
    state = h0.clone()
    ys = []
    for t in range(6):
        y_t, h_t = selective_scan(dt[:, t:t + 1], bm[:, t:t + 1], cm[:, t:t + 1],
                                  x[:, t:t + 1], a, state, h_out=state)
        assert h_t is state
        ys.append(y_t)
    np.testing.assert_allclose(torch.cat(ys, dim=1).numpy(), y_full.numpy(), atol=1e-5)
    np.testing.assert_allclose(state.numpy(), h_full.numpy(), atol=1e-5)
    with pytest.raises(ValueError, match="h_out"):
        selective_scan(dt, bm, cm, x, a, h0, h_out=torch.zeros(2, 24, 16, dtype=torch.float64))


def test_strided_b_and_c_views_and_dtype_cast():
    """B and C as slices of one projection (how the SSM block passes them),
    bf16 inputs cast to f32 as the JAX op casts them; a CPU tensor never
    reaches the kernel."""
    dt, bm, cm, x, a, h0 = _torch(_inputs(2, 9, 20, 8, seed=7))
    proj = torch.cat([torch.zeros(2, 9, 3), bm, cm], dim=-1)
    bv, cv = proj[..., 3:11], proj[..., 11:]
    assert not bv.is_contiguous()
    before = scan_kernel.launches.value
    y, h = selective_scan(dt, bv, cv, x, a, h0)
    y_want, h_want = selective_scan_ref(dt, bm, cm, x, a, h0)
    assert torch.equal(y, y_want) and torch.equal(h, h_want)
    y16, _ = selective_scan(*(u.to(torch.bfloat16) for u in (dt, bm, cm, x, a, h0)))
    y16_ref, _ = jax_selective_scan(  # the JAX op casts to f32 as the port's does
        *(jnp.asarray(u.numpy()).astype(jnp.bfloat16) for u in (dt, bm, cm, x, a, h0)))
    assert y16.dtype == torch.float32
    np.testing.assert_allclose(y16.numpy(), np.asarray(y16_ref), **TOL)
    assert scan_kernel.launches.value == before


@pytest.mark.parametrize("s,kernel", [
    (1, "decode"),  # one step: the decode kernel, at any width and state size
    (0, "prefill"),  # no steps: the state is copied through
    (2, "prefill"), (33, "prefill"), (128, "prefill"),  # falcon-mamba-7b's prefill is 128
])
def test_scan_kernel_for_picks_by_length(s, kernel):
    """The wrapper's rule: S == 1 takes the decode kernel, any other S the
    prefill kernel."""
    assert scan_kernel_for(s) == kernel
    assert kernel in scan_kernel.KERNELS
