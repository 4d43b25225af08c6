"""Quantized intervals (paper §4.1), as far as DAIS programs and design
artifacts need them.

A qint ``(lo, hi, exp)`` is the real interval ``[lo * 2^exp, hi * 2^exp]``
with step ``2^exp``; ``lo`` and ``hi`` are exact Python ints.  The
constant 0 is ``(0, 0, 0)``.
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class QInterval:
    """Quantized interval [lo * 2^exp, hi * 2^exp] with step 2^exp."""

    lo: int
    hi: int
    exp: int

    def __post_init__(self) -> None:
        if self.lo > self.hi:
            raise ValueError(f"QInterval lo {self.lo} > hi {self.hi}")

    @staticmethod
    def from_fixed(signed: bool, width: int, int_bits: int) -> QInterval:
        """Build from a fixed<S, W, I> spec (I includes the sign bit)."""
        if width <= 0:
            raise ValueError("width must be positive")
        n_mag = width - (1 if signed else 0)
        lo = -(1 << n_mag) if signed else 0
        return QInterval(lo, (1 << n_mag) - 1, int_bits - width)

    @property
    def is_zero(self) -> bool:
        return self.lo == 0 and self.hi == 0

    @property
    def width(self) -> int:
        """Total bitwidth needed to represent every point on the grid."""
        if self.is_zero:
            return 0
        if self.lo < 0:
            mag = max(self.hi, -self.lo - 1)
            return mag.bit_length() + 1 if mag > 0 else 1
        return self.hi.bit_length()

    def neg(self) -> QInterval:
        return QInterval(-self.hi, -self.lo, self.exp)
