"""Top-k token-choice MoE with capacity dispatch, on one device.

The port of the JAX package's ``repro.models.moe.moe_block`` with its
shard dimension at 1 (the sharding constraints mean nothing on one
device): every token picks its ``k`` experts from the f32 softmax of
the router logits (ties to the lower expert id, as ``lax.top_k``), the
gates are renormalised, each expert takes at most
C = roundup8(max(int(cf * T * k / E), 1)) slots ranked by a stable sort
on the expert id, and tokens past capacity are dropped (Switch/GShard
semantics).  The experts are a batched SwiGLU (``silu`` in f32, cast
back).  The Switch load-balance loss is returned for training.

Nothing here has a shape or a branch that depends on the data (no
``nonzero``, no boolean-mask indexing, no ``.item()``), so the decode
step that runs it can be captured as a CUDA graph.  The dispatch
scatter adds only zeros where slots collide (a dropped slot writes 0
into its expert's slot 0), so it is exact in any order; the combine is
a sum over the ``k`` contributions of each token in a fixed order, so
the result is the same bits on every run, eager or replayed.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def top_k_lower_index(probs: torch.Tensor, k: int) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``k`` largest entries of the last dim and their indices, ties
    broken toward the lower index (``jax.lax.top_k``'s order), by a
    stable descending sort; ``torch.topk`` promises no order for ties."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


def capacity(cfg, t: int) -> int:
    """Slots per expert for ``t`` tokens, rounded up to a multiple of 8."""
    c = max(int(cfg.capacity_factor * t * cfg.experts_per_token / cfg.n_experts), 1)
    return -(-c // 8) * 8


def router_topk(cfg, router: torch.Tensor, xt: torch.Tensor):
    """Route tokens ``xt`` [T, D]: the router logits in xt's dtype, their
    f32 softmax, its top ``experts_per_token`` (ties to the lower index),
    renormalised.  Returns (probs [T, E] f32, gate_vals [T, k], gate_idx
    [T, k])."""
    logits = (xt @ router.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = top_k_lower_index(probs, cfg.experts_per_token)
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9), gate_idx


def dispatch_slots(cfg, gate_idx: torch.Tensor):
    """Capacity slots of the picks ``gate_idx`` [T, k], slot-major (all
    tokens' first picks, then their second picks, ...), ranked within each
    expert by a stable sort on the expert id.  Returns (dest [k*T], each
    pick's row of the [E * C] expert buffer -- slot 0 of its expert where
    dropped --, keep [k*T], whether the pick is within capacity, C)."""
    t, k = gate_idx.shape
    cap = capacity(cfg, t)
    flat_e = gate_idx.t().reshape(k * t)
    order = torch.argsort(flat_e, stable=True)
    sorted_e = flat_e[order]
    ar = torch.arange(k * t, device=gate_idx.device)
    seg_start = torch.ones_like(sorted_e, dtype=torch.bool)
    seg_start[1:] = sorted_e[1:] != sorted_e[:-1]
    seg_origin = torch.cummax(torch.where(seg_start, ar, 0), dim=0).values
    ranks = torch.empty_like(ar).scatter_(0, order, ar - seg_origin)
    keep = ranks < cap
    return flat_e * cap + torch.where(keep, ranks, 0), keep, cap


def moe_block(cfg, p: dict, x: torch.Tensor):
    """x: [B, S, D] -> (y [B, S, D], aux_loss f32 scalar).

    ``p``: ``router`` [D, E], ``w_gate``/``w_up`` [E, D, F], ``w_down``
    [E, F, D] (one layer's slice)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    xt = x.reshape(t, d)
    probs, gate_vals, gate_idx = router_topk(cfg, p["router"], xt)

    # Switch load-balance loss: E * sum_e f_e * p_e (counts of picks are
    # integers: exact in f32 whatever the order of the adds)
    me = probs.mean(0)
    ce = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, gate_idx.reshape(-1), torch.ones(t * k, dtype=torch.float32, device=x.device)
    ) / (t * k)
    aux = e * torch.sum(me * ce)

    dest, keep, cap = dispatch_slots(cfg, gate_idx)
    tok_idx = torch.arange(t, device=x.device).repeat(k)
    contrib = torch.where(keep[:, None], xt[tok_idx], 0)
    xe = torch.zeros(e * cap, d, dtype=x.dtype, device=x.device).index_add_(0, dest, contrib)
    xe = xe.view(e, cap, d)

    # the experts: SwiGLU, batched over E
    g = torch.bmm(xe, p["w_gate"].to(x.dtype))
    u = torch.bmm(xe, p["w_up"].to(x.dtype))
    h = F.silu(g.float()).to(x.dtype) * u
    ye = torch.bmm(h, p["w_down"].to(x.dtype)).view(e * cap, d)

    # combine: tok_idx tiles arange(T) k times, so token j's contributions
    # are rows j, T + j, ... of the slot-major view: a sum over k
    out = torch.where(keep[:, None], ye[dest], 0)
    w = gate_vals.t().reshape(k * t, 1).to(out.dtype)
    y = (out * w).view(k, t, d).sum(0)
    return y.view(b, s, d), aux
