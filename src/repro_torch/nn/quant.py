"""Fixed-point quantization-aware training utilities (HGQ-lite), in
PyTorch: the port's copy of the JAX package's ``repro.nn.quant``.

  * every tensor lives on a power-of-two grid fixed<S, W, I>
    (step 2^(I-W), range [-2^(I-1), 2^(I-1) - step] when signed);
  * the forward pass is *bit-exact* with the integer hardware semantics:
    floor rounding, saturation clipping — so a compiled adder graph
    reproduces the float forward exactly (in float64);
  * straight-through estimators pass gradients through round/clip;
  * an optional bit-count regulariser (mean |w|/step surrogate) drives
    weights toward few CSD digits, mimicking HGQ's resource loss.
"""

from __future__ import annotations

from dataclasses import dataclass

import torch

from ..core.fixed_point import QInterval


@dataclass(frozen=True)
class QuantConfig:
    """fixed<signed, bits, int_bits> (int_bits includes the sign bit)."""

    bits: int
    int_bits: int
    signed: bool = True

    @property
    def step(self) -> float:
        return 2.0 ** (self.int_bits - self.bits)

    @property
    def qint(self) -> QInterval:
        return QInterval.from_fixed(self.signed, self.bits, self.int_bits)

    @property
    def lo(self) -> float:
        return self.qint.lo * self.step

    @property
    def hi(self) -> float:
        return self.qint.hi * self.step

    def scale_exp(self) -> int:
        return self.int_bits - self.bits


def _grid(x: torch.Tensor, cfg: QuantConfig, rounding: str) -> torch.Tensor:
    """Grid coordinates of x as floats: floor (or round half to even,
    as ``jnp.round``) of x / step, saturated to the grid's range."""
    q = torch.floor(x / cfg.step) if rounding == "floor" else torch.round(x / cfg.step)
    return torch.clamp(q, cfg.qint.lo, cfg.qint.hi)


def fake_quant(x: torch.Tensor, cfg: QuantConfig, rounding: str = "floor") -> torch.Tensor:
    """Quantize to the fixed-point grid with a straight-through gradient.

    ``x + (q - x).detach()``, in that order, as the JAX package's
    ``x + stop_gradient(q - x)``: in float32 the sum is not always ``q``,
    and the port rounds as the reference does."""
    q = _grid(x, cfg, rounding) * cfg.step
    return x + (q - x).detach()


def to_grid_int(x: torch.Tensor, cfg: QuantConfig, rounding: str = "floor") -> torch.Tensor:
    """Integer grid coordinates of x (exact deployment representation)."""
    return _grid(x, cfg, rounding).to(torch.int32)


def bit_count_surrogate(w: torch.Tensor, cfg: QuantConfig) -> torch.Tensor:
    """Differentiable proxy for the CSD digit count of quantized weights.

    log2(1 + |w|/step) grows ~linearly in the bitwidth a weight needs;
    minimising its sum drives bit-level sparsity like HGQ's resource
    term.
    """
    return torch.log2(1.0 + torch.abs(w) / cfg.step).sum()
