"""Public W8A8 matmul op: the Hopper kernel (``kernel.py``) for a CUDA
tensor, the plain PyTorch version (``ref.py``) for a CPU tensor.

The JAX op pads M, N and K up to block multiples for its Pallas path; the
Hopper kernel masks the ragged edges itself, so nothing is padded here.
``use_pallas``, ``interpret`` and the block sizes have no counterpart.
Both routes sum exactly (int32 in the kernel, float64 in the plain
version), as the JAX oracle ``quant_matmul_ref`` does; the Pallas kernel,
which sums in f32, is inexact once a sum passes 2^24.
"""

from __future__ import annotations

import torch

from .kernel import quant_matmul_cuda
from .ref import quant_matmul_ref


def quant_matmul(
    x: torch.Tensor,
    w: torch.Tensor,
    x_scale: torch.Tensor,
    w_scale: torch.Tensor,
) -> torch.Tensor:
    """y = (x_int8 @ w_int8) * x_scale[:,None] * w_scale[None,:], float32 [M, N]."""
    if x.device.type == "cuda":
        return quant_matmul_cuda(x, w, x_scale, w_scale)
    if x.device.type == "cpu":
        return quant_matmul_ref(x, w, x_scale, w_scale)
    raise ValueError(f"quant_matmul runs on a CUDA or CPU tensor, got one on {x.device}")
