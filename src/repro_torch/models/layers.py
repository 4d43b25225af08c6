"""Shared LM building blocks: RMSNorm, RoPE, SwiGLU, embeddings.

The JAX package's sharding hints (``constrain``, ``gathered``) are no-ops
on one device and are left out.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rmsnorm(x: torch.Tensor, scale: torch.Tensor, eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    var = (x * x).mean(dim=-1, keepdim=True)
    return (x * torch.rsqrt(var + eps) * scale.float()).to(dt)


def rope(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over halves of each head (not interleaved).
    x: [B, S, H, D]; positions: [B, S] or [S]."""
    d = x.shape[-1]
    half = d // 2
    # a Python scalar base: a tensor made from theta would be a host-to-device
    # copy, which waits for the card, on every call
    freqs = torch.pow(theta, -torch.arange(half, dtype=torch.float32, device=x.device) / half)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * freqs  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = x @ w_gate
    u = x @ w_up
    h = F.silu(g.float()).to(x.dtype) * u
    return h @ w_down


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    return embedding[tokens]


def unembed(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    return x @ head
