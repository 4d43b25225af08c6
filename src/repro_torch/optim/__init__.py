"""Optimizers with large-scale memory modes (f32 master / bf16 / int8
moments / factored): the port of the JAX package's ``repro.optim``."""

from __future__ import annotations

import math

import torch

from .adafactor import AdafactorState, make_adafactor
from .adamw import AdamWState, make_adamw
from .quantized_state import Quantized, dequantize, quantize


def lr_schedule(run_cfg, step) -> torch.Tensor:
    """Linear warmup then cosine decay to 10%, as an f32 scalar tensor on
    the CPU, computed in f32 as the JAX package computes it (Python
    floats would be f64, and the updates would drift from JAX's)."""
    lr, warm = run_cfg.learning_rate, max(run_cfg.warmup_steps, 1)
    t = torch.as_tensor(step, dtype=torch.float32) + 1.0  # step 0 trains at lr/warmup
    warmup = lr * torch.clamp_max(t / warm, 1.0)
    total = 10000.0
    frac = torch.clamp((t - warm) / (total - warm), 0.0, 1.0)
    cos = 0.1 * lr + 0.9 * lr * 0.5 * (1 + torch.cos(math.pi * frac))
    return torch.where(t < warm, warmup, cos)


def make_optimizer(run_cfg):
    if run_cfg.optimizer == "adafactor":
        return make_adafactor(weight_decay=run_cfg.weight_decay)
    return make_adamw(
        weight_decay=run_cfg.weight_decay,
        master_dtype=run_cfg.master_dtype,
        state_dtype=run_cfg.state_dtype,
    )


__all__ = [
    "AdafactorState",
    "AdamWState",
    "Quantized",
    "dequantize",
    "lr_schedule",
    "make_adafactor",
    "make_adamw",
    "make_optimizer",
    "quantize",
]
