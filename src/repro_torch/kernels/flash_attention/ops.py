"""Public attention op: the Hopper kernel (``kernel.py``) for a CUDA
tensor, the plain PyTorch version (``ref.py``) for a CPU tensor.

``offset`` is the absolute position of the first query row: ``None``
means end-aligned (prefill without a cache, offset = Sk - Sq); decode
into a preallocated cache passes the cache position, as an int32 tensor
on the card, so unwritten cache slots are masked out.
"""

from __future__ import annotations

import torch

from .kernel import flash_attention_cuda
from .ref import attention_ref


def flash_attention(
    q: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    causal: bool = True,
    scale: float | None = None,
    offset: int | torch.Tensor | None = None,
) -> torch.Tensor:
    """GQA attention. q: [B, Hq, Sq, D]; k/v: [B, Hkv, Sk, D] with Hq % Hkv == 0."""
    if q.device.type == "cuda":
        return flash_attention_cuda(q, k, v, causal=causal, scale=scale, offset=offset)
    if q.device.type == "cpu":
        return attention_ref(q, k, v, causal=causal, scale=scale, offset=offset)
    raise ValueError(f"flash_attention runs on a CUDA or CPU tensor, got one on {q.device}")
