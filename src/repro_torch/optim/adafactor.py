"""Adafactor (Shazeer & Stern 2018), momentum-free, with a factored
second moment: the port of the JAX package's ``repro.optim.adafactor``.

O(n+m) state for an n x m matrix instead of O(nm).  Tensors of rank >= 2
factor over their last two dims; vectors fall back to a full second
moment.  ``beta2 = 1 - t^-0.8`` is computed in f32, and updates are
clipped to RMS <= ``clip_threshold``.  ``update`` overwrites the
parameters and the moments in place; the arithmetic is the reference's,
in f32 and in its order (the means sum in PyTorch's order).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch.distributed.tensor import DTensor, Replicate, Shard
from torch.distributed.tensor import zeros as dtensor_zeros

from ..tree import tree_map
from .adamw import _step_device


class AdafactorState(NamedTuple):
    step: torch.Tensor
    vr: Any  # row second moments (or full v for rank < 2)
    vc: Any  # col second moments (or None)


def make_adafactor(
    eps: float = 1e-30,
    clip_threshold: float = 1.0,
    weight_decay: float = 0.0,
    min_dim_size_to_factor: int = 16,
):
    def _factored(shape):
        return (len(shape) >= 2 and shape[-1] >= min_dim_size_to_factor
                and shape[-2] >= min_dim_size_to_factor)

    def _moment(p, drop: int | None):
        """Zeros for ``p``'s second moment, f32, without dim ``drop`` (the
        factored row or column means) or whole.  A DTensor parameter's
        moment keeps its layout on the dims that stay, so the
        preconditioner, their broadcast product, comes out sharded as the
        parameter is (a replicated moment would make it whole on every rank)."""
        if drop is None:
            return torch.zeros_like(p, dtype=torch.float32)
        drop %= p.ndim
        shape = p.shape[:drop] + p.shape[drop + 1:]
        if not isinstance(p, DTensor):
            return torch.zeros(shape, dtype=torch.float32, device=p.device)
        placements = [Replicate() if isinstance(pl, Shard) and pl.dim == drop else
                      Shard(pl.dim - 1) if isinstance(pl, Shard) and pl.dim > drop else pl
                      for pl in p.placements]
        return dtensor_zeros(shape, dtype=torch.float32, device_mesh=p.device_mesh,
                             placements=placements)

    def init(params):
        def vr(p):
            return _moment(p, -1 if _factored(p.shape) else None)

        def vc(p):
            return _moment(p, -2) if _factored(p.shape) else None

        step = torch.zeros((), dtype=torch.int32, device=_step_device(params))
        return AdafactorState(step, tree_map(vr, params), tree_map(vc, params))

    def update(grads, state: AdafactorState, params, lr):
        step = state.step + 1
        t = step.to(torch.float32)
        beta2 = 1.0 - t ** (-0.8)  # the paper's decay schedule

        @torch.no_grad()
        def upd(g, vr, vc, p):
            g = g.to(torch.float32)
            g2 = g * g + eps
            if _factored(p.shape):
                vr.copy_(beta2 * vr + (1 - beta2) * g2.mean(dim=-1))
                vc.copy_(beta2 * vc + (1 - beta2) * g2.mean(dim=-2))
                denom = vr.mean(dim=-1, keepdim=True)[..., None]
                precond = (vr[..., None] / torch.clamp_min(denom, eps)) * vc[..., None, :]
                u = g / torch.sqrt(torch.clamp_min(precond, eps))
            else:
                vr.copy_(beta2 * vr + (1 - beta2) * g2)
                u = g / torch.sqrt(torch.clamp_min(vr, eps))
            # update clipping (RMS(u) <= clip_threshold)
            rms = torch.sqrt(torch.mean(u * u) + eps)
            u = u / torch.clamp_min(rms / clip_threshold, 1.0)
            pf = p.to(torch.float32)
            p.copy_(pf - lr * u - lr * weight_decay * pf)

        tree_map(upd, grads, state.vr, state.vc, params)
        return params, AdafactorState(step, state.vr, state.vc)

    return init, update
