"""Public selective-scan op: the Hopper kernel (``kernel.py``) for a CUDA
tensor, the plain PyTorch version (``ref.py``) for a CPU tensor.

The JAX op's ``use_pallas``, ``tile_d`` and ``interpret`` have no
counterpart: the device of the tensors decides.  ``h_out``, where given,
receives the final state, and may be ``h0`` itself: a decode cache is
then updated in place.
"""

from __future__ import annotations

import torch

from .kernel import selective_scan_cuda
from .ref import selective_scan_ref


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
    # the scan's contract is f32, whatever the surrounding compute dtype
    dt, bmat, cmat, x, a, h0 = (u.float() for u in (dt, bmat, cmat, x, a, h0))
    if dt.device.type == "cuda":
        return selective_scan_cuda(dt, bmat, cmat, x, a, h0, h_out=h_out)
    if dt.device.type == "cpu":
        return selective_scan_ref(dt, bmat, cmat, x, a, h0, h_out=h_out)
    raise ValueError(f"selective_scan runs on a CUDA or CPU tensor, got one on {dt.device}")
