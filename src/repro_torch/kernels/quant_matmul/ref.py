"""Plain PyTorch version of the W8A8 matmul: the port of the JAX
package's ``quant_matmul_ref``,

    float32(x_i8 @ w_i8, summed exactly) * x_scale[:, None] * w_scale[None, :]

multiplied in that order.  ``torch.matmul`` has no integer product on
CUDA, so the exact sum is taken in float64: every partial sum is an
integer of magnitude at most K * 2^14, far below 2^53, so float64 holds
it exactly, and a float64 integer rounds to float32 exactly as the
reference's int32 does.  The result is bit-equal to the JAX oracle on
either device."""

from __future__ import annotations

import torch


def quant_matmul_ref(
    x: torch.Tensor,  # int8 [M, K]
    w: torch.Tensor,  # int8 [K, N]
    x_scale: torch.Tensor,  # f32 [M] per-row scales
    w_scale: torch.Tensor,  # f32 [N] per-channel scales
) -> torch.Tensor:
    acc = torch.matmul(x.to(torch.float64), w.to(torch.float64))
    return acc.to(torch.float32) * x_scale[:, None] * w_scale[None, :]
