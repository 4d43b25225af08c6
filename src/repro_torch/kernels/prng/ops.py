"""Public draw ops: the Hopper kernel (``kernel.py``) for CUDA tensors,
the plain PyTorch version (``ref.py``) for CPU tensors, or for meta
tensors, which hold no data (the draw's shapes and temporaries only)."""

from __future__ import annotations

import torch

from .kernel import draw_cuda
from .ref import Draw, draw_many_ref


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
