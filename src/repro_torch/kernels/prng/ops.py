"""Public draw and pick ops: the Hopper kernels (``kernel.py``) for CUDA
tensors, the plain PyTorch versions (``ref.py``) for CPU tensors, or, for
a draw, meta tensors, which hold no data (the draw's shapes and
temporaries only)."""

from __future__ import annotations

import torch

from .kernel import draw_cuda, gumbel_pick_cuda
from .ref import Draw, draw_many_ref, gumbel_pick_ref


def draw_many(draws, kind: str, minval: float = 0.0, maxval: float = 1.0) -> None:
    """Fill each :class:`~.ref.Draw`'s ``out`` with its draw ``kind``
    ("bits", "uniform" or "normal"): on the card one kernel launch a draw,
    elsewhere the plain version over all of them at once.  The outputs lie
    on one device."""
    draws = list(draws)
    devices = {d.out.device.type for d in draws}
    if len(devices) > 1:
        raise ValueError(f"draws on several devices: {sorted(devices)}")
    if devices == {"cuda"}:
        for d in draws:
            draw_cuda(d.out, d.k0, d.k1, d.shape, d.offset, kind, d.scale, minval, maxval)
    elif devices <= {"cpu", "meta"}:
        draw_many_ref(draws, kind, minval, maxval)
    else:
        raise ValueError(f"the draw runs on CUDA, CPU or meta tensors, got {devices}")


def draw(out: torch.Tensor, k0: int, k1: int, shape, offset, kind: str, scale: float = 1.0,
         minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Fill the contiguous ``out``, the block at ``offset`` of an array of
    ``shape``, with the draw ``kind`` of key (k0, k1); returns ``out``."""
    draw_many([Draw(out, k0, k1, tuple(shape), tuple(offset), scale)], kind, minval, maxval)
    return out


def gumbel_pick(logits: torch.Tensor, k0: int, k1: int, temperature: float = 1.0) -> torch.Tensor:
    """Each row's categorical pick from ``logits`` [B, V] at temperature
    ``temperature`` under key (k0, k1), as ``jax.random.categorical(key,
    logits / T)``: on the card the pick kernel (one launch), on the CPU the
    plain version.  int64 [B] on the logits' device."""
    if logits.device.type == "cuda":
        return gumbel_pick_cuda(logits, k0, k1, temperature)
    if logits.device.type == "cpu":
        return gumbel_pick_ref(logits, k0, k1, temperature)
    raise ValueError(f"the pick runs on CUDA or CPU tensors, got {logits.device}")
