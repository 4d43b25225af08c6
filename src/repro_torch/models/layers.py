"""Shared LM building blocks: RMSNorm, RoPE, SwiGLU, embeddings.

Under active sharding rules (:mod:`repro_torch.distributed`) tensors are
DTensors and the reference's hints become redistributions: ``gathered``
brings a weight to its compute layout (the fsdp dim unsharded) before
use, and ``constrain`` lays an activation out by its logical tokens.
Without rules both are no-ops and every function computes what it
computes on one device.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed import constrain
from ..distributed.sharding import gathered, like, run_local


def dense(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` for ``x`` [..., K] and ``w`` [K, N].  ``torch.matmul``
    folds ``x`` into one [-1, K] ``mm`` or expands ``w`` into a batched
    product by ``x``'s strides; on a DTensor it judges by the DTensor's
    own strides, which can differ from the local shard's, and the two
    products round differently.  So on DTensors the fold is decided as
    the plain product would decide it on the local shard (always, where
    ``w`` needs a gradient; else where the leading dims can be viewed
    as one), and the sharded path keeps the plain path's bits."""
    if not isinstance(x, DTensor) or x.ndim == 2:
        return x @ w
    loc = x.to_local()
    fold = w.requires_grad or all(loc.stride(i) == loc.stride(i + 1) * loc.size(i + 1)
                                  for i in range(loc.dim() - 2))
    if not fold:
        return x @ w
    return (x.reshape(-1, x.shape[-1]) @ w).reshape(*x.shape[:-1], w.shape[-1])


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
    positions = like(positions, x)
    if positions.dim() == 1:
        positions = positions[None, :]
    ang = positions[..., None].float() * like(freqs, positions)  # [B, S, half]
    cos = torch.cos(ang)[:, :, None, :]
    sin = torch.sin(ang)[:, :, None, :]
    x1, x2 = x[..., :half].float(), x[..., half:].float()
    return torch.cat([x1 * cos - x2 * sin, x2 * cos + x1 * sin], dim=-1).to(x.dtype)


def swiglu(x: torch.Tensor, w_gate, w_up, w_down) -> torch.Tensor:
    g = constrain(dense(x, gathered(w_gate, None, "model")), "batch", "seq", "model")
    u = constrain(dense(x, gathered(w_up, None, "model")), "batch", "seq", "model")
    h = F.silu(g.float()).to(x.dtype) * u
    return constrain(dense(h, gathered(w_down, "model", None)), "batch", "seq", None)


def embed_tokens(embedding: torch.Tensor, tokens: torch.Tensor) -> torch.Tensor:
    if isinstance(embedding, DTensor):
        return _embed_sharded(embedding, tokens)
    return embedding[tokens]


def _embed_sharded(embedding, tokens):
    """The lookup on DTensors: the table gathered whole, and each rank
    looking up its own rows of tokens with the plain ``table[tokens]``
    (so the backward is the same index-put as unsharded, on each rank's
    rows); the table's gradient is then a partial sum over the batch
    dims, reduced back to the table's own sharding."""
    tok = constrain(tokens, "batch", None)
    mesh = tok.device_mesh
    rep = tuple(Replicate() for _ in range(mesh.ndim))
    part = tuple(Partial() if p == Shard(0) else Replicate() for p in tok.placements)
    table = gathered(embedding, None, None)
    out = run_local(lambda w, t: w[t], (table, tok), (rep, tuple(tok.placements)),
                    tuple(tok.placements), mesh,
                    in_grad_placements=(part, tuple(tok.placements)))
    return constrain(out, "batch", "seq", None)


def unembed(x: torch.Tensor, head: torch.Tensor) -> torch.Tensor:
    return constrain(dense(x, head), "batch", "seq", "model")
