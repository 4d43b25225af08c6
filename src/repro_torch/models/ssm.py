"""Mamba-1 selective-state-space block (the falcon-mamba mixer).

    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t x_t
    y_t = C_t . h_t + D x_t

The port of the JAX package's ``mamba_block`` for prefill and decode.
The recurrence, at prefill (S > 1) and at decode (S == 1) alike, goes
through the ``selective_scan`` op: the hand-written Hopper kernel on the
card, its plain version on the CPU.  The JAX block writes the recurrence
out itself, as a time-major ``lax.scan`` (``ssm_mode="seq"``), a chunked
associative scan (``"assoc"``) or one step at decode; all three compute
the same function, so ``cfg.ssm_mode`` and ``cfg.ssm_chunk`` select
nothing here.  The cache (``conv`` [B, k-1, d_inner], ``h`` [B, d_inner,
N] in f32) is updated in place; the JAX block returns new buffers.  Its
sharding hints (``constrain``) have no counterpart on one device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from ..kernels.ssm_scan import selective_scan

F32_LEAVES = ("x_proj", "dt_proj", "dt_bias", "a_log", "d")  # read in f32 by mamba_block


def f32_leaves(p: dict) -> dict:
    """The block's parameters with the leaves ``mamba_block`` reads in
    f32 (``F32_LEAVES``) cast once.  The block casts them the same way on
    every call, and the cast of an f32 tensor is the tensor itself, so it
    computes bit for bit the same from either; the serving engine casts
    once instead of every step."""
    return {k: v.float() if k in F32_LEAVES else v for k, v in p.items()}


def _ssm_params(p):
    a = -torch.exp(p["a_log"].float())  # [d_inner, state]
    d = p["d"].float()  # [d_inner]
    return a, d


def _dt_bx(cfg, p, x):
    """Input-dependent dt, B, C. x: [B, L, d_inner] (f32).  B and C are
    views of one projection; the scan reads them in place."""
    proj = x @ p["x_proj"].float()  # [B, L, dt_rank + 2*state]
    dtr, st = cfg.dt_rank, cfg.ssm_state
    dt, bmat, cmat = torch.split(proj, [dtr, st, st], dim=-1)
    dt = F.softplus(dt @ p["dt_proj"].float() + p["dt_bias"].float())
    return dt, bmat, cmat  # [B,L,d_inner], [B,L,state], [B,L,state]


def mamba_block(
    cfg,
    p: dict,
    x: torch.Tensor,  # [B, S, D]
    cache: dict | None = None,  # {"conv": [B, k-1, d_inner], "h": [B, d_inner, state] f32}
) -> torch.Tensor:
    """Returns y [B, S, D]; ``cache``, where given, is updated in place."""
    b, s, _ = x.shape
    di, st, k = cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    xz = x @ p["in_proj"]  # [B, S, 2*d_inner]
    xs, z = torch.split(xz, di, dim=-1)

    # depthwise causal conv1d (kernel k) in the input dtype, summed tap by
    # tap in the reference's order, then SiLU in f32
    if cache is not None:
        conv_in = torch.cat([cache["conv"].to(xs.dtype), xs], dim=1)
    else:
        conv_in = F.pad(xs, (0, 0, k - 1, 0))
    w = p["conv"]  # [d_inner, k]
    xc = sum(conv_in[:, i : i + s, :] * w[:, i] for i in range(k))
    xc = F.silu(xc.float())

    a, d = _ssm_params(p)
    dt, bmat, cmat = _dt_bx(cfg, p, xc)
    if cache is not None:
        cache["conv"].copy_(conv_in[:, -(k - 1):, :])
        h = cache["h"]
        y, _ = selective_scan(dt, bmat, cmat, xc, a, h, h_out=h)
    else:
        h0 = torch.zeros((b, di, st), dtype=torch.float32, device=x.device)
        y, _ = selective_scan(dt, bmat, cmat, xc, a, h0)

    y = y + d * xc
    y = (y * F.silu(z.float())).to(x.dtype)
    return y @ p["out_proj"]
