"""Fixed-point quantization spec (the port's copy of ``QuantConfig``).

Every tensor of a design lives on a power-of-two grid fixed<S, W, I>:
step 2^(I-W), range [-2^(I-1), 2^(I-1) - step] when signed.
"""

from __future__ import annotations

from dataclasses import dataclass

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
