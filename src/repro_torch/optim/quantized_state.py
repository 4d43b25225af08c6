"""Blockwise 8-bit optimizer-state compression (8-bit Adam style): the
port of the JAX package's ``repro.optim.quantized_state``.

Blocks are 256 elements over the flattened tensor; m uses symmetric
signed scaling (int8), v (non-negative) unsigned scaling (uint8), each
block with one f32 scale.  The division, the rounding (half to even, as
``jnp.round``) and the clip are f32, so the payload and the scales equal
the JAX package's bit for bit.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import torch

from ..tree import register_dataclass

BLOCK = 256


@dataclass(frozen=True)
class Quantized:
    q: torch.Tensor  # int8 (signed) or uint8 payload, [n_blocks, BLOCK]
    scale: torch.Tensor  # f32 per-block scales, [n_blocks]
    shape: tuple = field(metadata=dict(static=True))
    signed: bool = field(metadata=dict(static=True))


register_dataclass(Quantized, ("q", "scale"))


def _pad_len(n: int) -> int:
    return -(-n // BLOCK) * BLOCK


def quantize(x: torch.Tensor, signed: bool) -> Quantized:
    shape = tuple(x.shape)
    flat = x.float().reshape(-1)
    pad = _pad_len(flat.numel()) - flat.numel()
    if pad:
        flat = torch.nn.functional.pad(flat, (0, pad))
    blocks = flat.reshape(-1, BLOCK)
    if signed:
        scale = blocks.abs().amax(dim=1, keepdim=True) / 127.0
    else:
        scale = blocks.amax(dim=1, keepdim=True) / 255.0
    scale = scale.clamp_min(1e-12)
    q = torch.round(blocks / scale)
    q = q.clamp(-127 if signed else 0, 127 if signed else 255)
    return Quantized(q.to(torch.int8 if signed else torch.uint8), scale[:, 0], shape, signed)


def dequantize(z: Quantized) -> torch.Tensor:
    blocks = z.q.float() * z.scale[:, None]
    n = 1
    for s in z.shape:
        n *= s
    return blocks.reshape(-1)[:n].reshape(z.shape)
