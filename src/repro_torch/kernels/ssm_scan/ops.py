"""Public selective-scan op: the Hopper kernel (``kernel.py``) for a CUDA
tensor, the plain PyTorch version (``ref.py``) for a CPU tensor.

The JAX op's ``use_pallas``, ``tile_d`` and ``interpret`` have no
counterpart: the device of the tensors decides.  ``h_out``, where given,
receives the final state, and may be ``h0`` itself: a decode cache is
then updated in place.

On the card, when grad is enabled and an input requires it (training),
the call goes through ``_SelectiveScan``: its forward launches the
same kernel with a ``chunk_states`` output (the state every 8 steps,
saved for the backward), and its backward the hand-written backward
kernel (``csrc/ssm_scan_bwd.cu``) from them.  Otherwise the launch is the
plain kernel call, with no chunk states.  On the CPU autograd
differentiates the plain version itself.  Fake tensors (the dry-run's)
take the kernel's abstract form (``kernels.abstract``): its outputs'
shapes.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from .. import abstract
from .kernel import chunk_states_shape, selective_scan_bwd_cuda, selective_scan_cuda
from .ref import selective_scan_ref


class _SelectiveScan(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, dt, bmat, cmat, x, a, h0):
        ctx.set_materialize_grads(False)
        hc = torch.empty(chunk_states_shape(*dt.shape, a.shape[1]), dtype=torch.float32,
                         device=dt.device)
        y, h = selective_scan_cuda(dt, bmat, cmat, x, a, h0, chunk_states=hc)
        ctx.save_for_backward(dt, bmat, cmat, x, a, h0, hc)
        return y, h

    @staticmethod
    def backward(ctx, dy, dh):
        *saved, hc = ctx.saved_tensors
        if dy is None:  # only the final state is used
            dy = torch.zeros_like(saved[0])
        return selective_scan_bwd_cuda(*saved, dy, dh, hc)


def selective_scan(
    dt: torch.Tensor,
    bmat: torch.Tensor,
    cmat: torch.Tensor,
    x: torch.Tensor,
    a: torch.Tensor,
    h0: torch.Tensor,
    h_out: torch.Tensor | None = None,
):
    """Mamba-1 recurrence. Returns (y [B,S,D], h_final [B,D,N]), both f32;
    ``h_final`` is ``h_out`` when one is given."""
    if any(isinstance(t, DTensor) for t in (dt, bmat, cmat, x, a, h0)):
        raise TypeError("selective_scan takes local tensors: call it on a DTensor's shards "
                        "through local_map (models.ssm._scan)")
    # the scan's contract is f32, whatever the surrounding compute dtype
    dt, bmat, cmat, x, a, h0 = (u.float() for u in (dt, bmat, cmat, x, a, h0))
    if abstract.is_abstract(dt):  # the dry-run's fake tensors: the kernel's shapes
        y, h = abstract.selective_scan(dt, bmat, cmat, x, a, h0)
        return y, (h if h_out is None else h_out.copy_(h))
    if dt.device.type == "cuda":
        if torch.is_grad_enabled() and any(u.requires_grad for u in (dt, bmat, cmat, x, a, h0)):
            if h_out is not None:
                raise ValueError("a gradient through selective_scan cannot write h_out in place")
            return _SelectiveScan.apply(dt, bmat, cmat, x, a, h0)
        return selective_scan_cuda(dt, bmat, cmat, x, a, h0, h_out=h_out)
    if dt.device.type == "cpu":
        return selective_scan_ref(dt, bmat, cmat, x, a, h0, h_out=h_out)
    raise ValueError(f"selective_scan runs on a CUDA or CPU tensor, got one on {dt.device}")
