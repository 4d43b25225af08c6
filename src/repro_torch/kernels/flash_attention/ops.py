"""Public attention op: the Hopper kernel (``kernel.py``) for a CUDA
tensor, the plain PyTorch version (``ref.py``) for a CPU tensor.

``offset`` is the absolute position of the first query row: ``None``
means end-aligned (prefill without a cache, offset = Sk - Sq); decode
into a preallocated cache passes the cache position, as an int32 tensor
on the card, so unwritten cache slots are masked out.

On the card, when grad is enabled and an input requires it (training),
the call goes through ``_FlashAttention``: its forward launches the same
kernel with an ``lse`` output (each row's log-sum-exp, saved for the
backward), and its backward the hand-written backward kernel
(``csrc/flash_attention_bwd.cu``) from it.  Otherwise (serving, under
no_grad or with no input that requires grad) the launch is the plain
kernel call, with no lse.  On the CPU autograd differentiates the plain
version itself.
"""

from __future__ import annotations

import torch
from torch.distributed.tensor import DTensor

from .. import abstract
from .kernel import flash_attention_bwd_cuda, flash_attention_cuda
from .ref import attention_ref


class _FlashAttention(torch.autograd.Function):
    """The forward kernel, with the backward kernel as its gradient."""

    @staticmethod
    def forward(ctx, q, k, v, causal, scale, offset):
        lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
        out = flash_attention_cuda(q, k, v, causal=causal, scale=scale, offset=offset, lse=lse)
        ctx.save_for_backward(q, k, v, out, lse)
        ctx.causal, ctx.scale, ctx.offset = causal, scale, offset
        return out

    @staticmethod
    def backward(ctx, dout):
        q, k, v, out, lse = ctx.saved_tensors
        dq, dk, dv = flash_attention_bwd_cuda(q, k, v, out, dout, lse, causal=ctx.causal,
                                              scale=ctx.scale, offset=ctx.offset)
        return dq, dk, dv, None, None, None


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: float | None = None,
    offset: int | torch.Tensor | None = None,
) -> torch.Tensor:
    """GQA attention. q: [B, Hq, Sq, D]; k/v: [B, Hkv, Sk, D] with Hq % Hkv == 0."""
    if any(isinstance(t, DTensor) for t in (q, k, v)):
        raise TypeError("flash_attention takes local tensors: call it on a DTensor's shards "
                        "through local_map (models.attention._attend)")
    if abstract.is_abstract(q):  # the dry-run's fake tensors: the kernel's shapes
        return abstract.flash_attention(q, k, v, causal)
    if q.device.type == "cuda":
        if torch.is_grad_enabled() and (q.requires_grad or k.requires_grad or v.requires_grad):
            if isinstance(offset, torch.Tensor):
                raise ValueError("a gradient through flash_attention needs an int offset")
            return _FlashAttention.apply(q, k, v, causal, scale, offset)
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale, offset=offset)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale, offset=offset)
    raise ValueError(f"flash_attention runs on a CUDA or CPU tensor, got one on {q.device}")
