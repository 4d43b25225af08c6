"""Top-k token-choice MoE with group-local capacity dispatch: the port of
the JAX package's ``repro.models.moe.moe_block``.

Tokens [T, D] are viewed as [n, T/n, D] groups, n the extent of the
"batch" axis under the sharding rules (1 without rules, or where n does
not divide T), each group on its data rank; every group routes its own
tokens with a *local* capacity C = roundup8(max(int(cf * T/n * k / E),
1)), so a sharded MoE drops exactly the tokens the reference's sharded
MoE drops.  Every token picks its ``k`` experts from the f32 softmax of
the router logits (ties to the lower expert id, as ``lax.top_k``), the
gates are renormalised, slots within an expert are ranked by a stable
sort on the expert id, and tokens past capacity are dropped
(Switch/GShard semantics).  The experts are a batched SwiGLU (``silu``
in f32, cast back), their dim on "model".  The Switch load-balance loss
is returned for training.

Nothing here has a shape or a branch that depends on the data (no
``nonzero``, no boolean-mask indexing, no ``.item()``), so the decode
step that runs it can be captured as a CUDA graph.  The dispatch
scatter adds only zeros where slots collide (a dropped slot writes 0
into its expert's slot 0), so it is exact in any order; the combine is
a sum over the ``k`` contributions of each token in a fixed order, so
the result is the same bits on every run, eager or replayed.

Under the rules five steps run per group through ``local_map``
(:func:`~repro_torch.distributed.sharding.batch_local`), because DTensor
has no sharding strategy for them (or, for the top-k's sort, its
backward builds a plain tensor): the top-k, the slot ranking (``cummax``
and an in-place ``scatter_``), the dispatch scatter (``scatter_add_``),
the expert products (a matmul over two sharded batch dims, groups and
experts) and the combine gather.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F
from torch.distributed.tensor import DTensor, Partial, Replicate, Shard

from ..distributed import constrain
from ..distributed.sharding import axis_size, batch_local, gathered, like, run_local
from .layers import dense


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
    """Route tokens ``xt`` [..., T, D]: the router logits in xt's dtype,
    their f32 softmax, its top ``experts_per_token`` (ties to the lower
    index), renormalised.  Returns (probs [..., T, E] f32, gate_vals
    [..., T, k], gate_idx [..., T, k])."""
    logits = dense(xt, router.to(xt.dtype)).float()
    probs = torch.softmax(logits, dim=-1)
    # per batch group under the rules: the sort's backward builds a plain
    # zeros tensor (torch 2.11), which a DTensor sort cannot take
    gate_vals, gate_idx = batch_local(lambda p: top_k_lower_index(p, cfg.experts_per_token),
                                      probs, n_out=2)
    return probs, gate_vals / gate_vals.sum(-1, keepdim=True).clamp_min(1e-9), gate_idx


def dispatch_slots(cfg, gate_idx: torch.Tensor):
    """Capacity slots of the picks ``gate_idx`` [..., T, k] (a leading
    group dim, or none), slot-major within a group (all tokens' first
    picks, then their second picks, ...), ranked within each expert by a
    stable sort on the expert id.  Returns (dest [..., k*T], each pick's
    row of its group's [E * C] expert buffer -- slot 0 of its expert
    where dropped --, keep [..., k*T], whether the pick is within
    capacity, C)."""
    *lead, t, k = gate_idx.shape
    cap = capacity(cfg, t)
    flat_e = gate_idx.transpose(-1, -2).reshape(*lead, k * t)
    order = torch.argsort(flat_e, dim=-1, stable=True)
    sorted_e = flat_e.gather(-1, order)
    ar = torch.arange(k * t, device=gate_idx.device).expand_as(flat_e)
    seg_start = torch.ones_like(sorted_e, dtype=torch.bool)
    seg_start[..., 1:] = sorted_e[..., 1:] != sorted_e[..., :-1]
    seg_origin = torch.cummax(torch.where(seg_start, ar, 0), dim=-1).values
    ranks = torch.empty_like(ar).scatter_(-1, order, ar - seg_origin)
    keep = ranks < cap
    return flat_e * cap + torch.where(keep, ranks, 0), keep, cap


def _dispatch(xt, dest, keep, tok_idx, rows: int):
    """Each group's kept picks' tokens into its [rows, D] expert buffer."""
    contrib = torch.where(keep[..., None], xt[:, tok_idx], 0)
    buf = torch.zeros(xt.shape[0], rows, xt.shape[-1], dtype=xt.dtype, device=xt.device)
    return buf.scatter_add_(1, dest[..., None].expand_as(contrib), contrib)


def _experts(xe, w_gate, w_up, w_down):
    """The experts' SwiGLU: xe [n, E, C, D] -> [n, E, C, D]."""
    g = torch.matmul(xe, w_gate.to(xe.dtype))
    u = torch.matmul(xe, w_up.to(xe.dtype))
    h = F.silu(g.float()).to(xe.dtype) * u
    return torch.matmul(h, w_down.to(xe.dtype))


def _combine(ye, dest, keep, w):
    """Each pick's expert output, weighted by its gate: [n, k*T, D]."""
    out = torch.where(keep[..., None], ye.gather(1, dest[..., None].expand(*dest.shape,
                                                                           ye.shape[-1])), 0)
    return out * w


def _expert_counts(gate_idx: torch.Tensor, e: int) -> torch.Tensor:
    """Picks per expert over all groups, f32 (integers: exact)."""
    if isinstance(gate_idx, DTensor):
        experts = like(torch.arange(e, device=gate_idx.device), gate_idx)
        return (gate_idx[..., None] == experts).sum((0, 1, 2)).float()
    ones = torch.ones(gate_idx.numel(), dtype=torch.float32, device=gate_idx.device)
    return torch.zeros(e, dtype=torch.float32, device=gate_idx.device).index_add_(
        0, gate_idx.reshape(-1), ones)


def moe_block(cfg, p: dict, x: torch.Tensor):
    """x: [B, S, D] -> (y [B, S, D], aux_loss f32 scalar).

    ``p``: ``router`` [D, E], ``w_gate``/``w_up`` [E, D, F], ``w_down``
    [E, F, D] (one layer's slice)."""
    b, s, d = x.shape
    e, k = cfg.n_experts, cfg.experts_per_token
    t = b * s
    n = axis_size("batch")
    if t % n or n < 1:
        n = 1
    tl = t // n
    xt = constrain(x.reshape(n, tl, d), "batch", None, None)
    probs, gate_vals, gate_idx = router_topk(cfg, gathered(p["router"], None, None), xt)

    # Switch load-balance loss: E * sum_e f_e * p_e
    me = probs.mean((0, 1))
    aux = e * torch.sum(me * (_expert_counts(gate_idx, e) / (t * k)))

    dest, keep = batch_local(lambda g: dispatch_slots(cfg, g)[:2], gate_idx, n_out=2)
    cap = capacity(cfg, tl)
    tok_idx = torch.arange(tl, device=x.device).repeat(k)
    xe = batch_local(lambda *a: _dispatch(*a, tok_idx, e * cap), xt, dest, keep)
    xe = constrain(xe.view(n, e, cap, d), "batch", "model", None, None)

    # the experts, batched over E: E on "model", the weights' fsdp dim
    # gathered before use
    w = [gathered(p[name], "model", None, None) for name in ("w_gate", "w_up", "w_down")]
    ye = _run_experts(xe, *w)
    ye = constrain(ye.reshape(n, e * cap, d), "batch", None, None)

    # combine: tok_idx tiles arange(T/n) k times, so token j's contributions
    # are rows j, T/n + j, ... of the slot-major view: a sum over k
    gates = gate_vals.transpose(1, 2).reshape(n, k * tl, 1)
    out = batch_local(_combine, ye, dest, keep, gates.to(ye.dtype))
    y = out.view(n, k, tl, d).sum(1)
    return constrain(y.reshape(b, s, d), "batch", "seq", None), aux


def _run_experts(xe, wg, wu, wd):
    """:func:`_experts`, on each rank's (groups, experts) block under the rules."""
    if not isinstance(xe, DTensor):
        return _experts(xe, wg, wu, wd)
    mesh = xe.device_mesh
    x_pl = tuple(xe.placements)
    w_pl = tuple(Shard(0) if p == Shard(1) else Replicate() for p in x_pl)
    # each data rank's groups give a part of the weights' gradient: a sum
    w_grad = tuple(Partial() if p == Shard(0) else w for p, w in zip(x_pl, w_pl))
    return run_local(_experts, (xe, wg, wu, wd), (x_pl, w_pl, w_pl, w_pl), x_pl, mesh,
                     in_grad_placements=(x_pl, w_grad, w_grad, w_grad))
