"""Plain PyTorch version of the Mamba-1 selective scan: the port of the
JAX package's ``selective_scan_ref``, a time-major loop with its
arithmetic.  The tests use it, and so does every CPU tensor; on the card
it is what the kernel is held against."""

from __future__ import annotations

import torch


def selective_scan_ref(
    dt: torch.Tensor,  # f32 [B, S, D]   (post-softplus)
    bmat: torch.Tensor,  # f32 [B, S, N]
    cmat: torch.Tensor,  # f32 [B, S, N]
    x: torch.Tensor,  # f32 [B, S, D]
    a: torch.Tensor,  # f32 [D, N]      (negative)
    h0: torch.Tensor,  # f32 [B, D, N]
    h_out: torch.Tensor | None = None,  # f32 [B, D, N]; may be h0 itself
):
    """h_t = exp(dt_t * A) h_{t-1} + dt_t B_t x_t ; y_t = C_t . h_t.

    Returns (y [B, S, D], h_final [B, D, N]); ``h_final`` is written into
    ``h_out`` when one is given (the kernel's contract), and ``h0`` is
    otherwise left alone."""
    b, s, d = dt.shape
    if h_out is not None and (h_out.shape != h0.shape or h_out.dtype != torch.float32):
        raise ValueError(f"h_out must be f32 {tuple(h0.shape)}, got {h_out.dtype} "
                         f"{tuple(h_out.shape)}")
    y = dt.new_empty((b, s, d))
    h = h0
    for t in range(s):
        dt_t = dt[:, t, :, None]  # [B, D, 1]
        decay = torch.exp(dt_t * a)
        h = decay * h + dt_t * bmat[:, t, None, :] * x[:, t, :, None]
        y[:, t] = (h * cmat[:, t, None, :]).sum(dim=-1)
    if h_out is not None:
        return y, h_out.copy_(h)
    return y, h.clone() if s == 0 else h


def selective_scan_chunk_states_ref(dt, bmat, cmat, x, a, h0, chunk: int = 8):
    """The plain chunk-start states the forward kernel keeps for the
    backward: [B, ceil(S / chunk), D, N], entry c the state before step
    chunk c (entry 0 is h0), by the recurrence of ``selective_scan_ref``."""
    b, s, d = dt.shape
    states = [h0]
    h = h0
    for t in range(s):
        dt_t = dt[:, t, :, None]
        h = torch.exp(dt_t * a) * h + dt_t * bmat[:, t, None, :] * x[:, t, :, None]
        if (t + 1) % chunk == 0 and t + 1 < s:
            states.append(h)
    return torch.stack(states, dim=1)


def selective_scan_bwd_ref(dt, bmat, cmat, x, a, h0, dy, dh=None):
    """The plain backward: (ddt, dB, dC, dx, dA, dh0) of
    ``selective_scan_ref`` for the gradients ``dy`` of y and ``dh`` of the
    final state (None: zero), by autograd through it."""
    with torch.enable_grad():
        leaves = [t.detach().requires_grad_(True) for t in (dt, bmat, cmat, x, a, h0)]
        y, h = selective_scan_ref(*leaves)
        outs, grads = [y], [dy]
        if dh is not None:
            outs.append(h)
            grads.append(dh)
        return torch.autograd.grad(outs, leaves, grads, allow_unused=True)
