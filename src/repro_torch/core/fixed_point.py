"""Fixed-point / quantized-interval arithmetic for the da4ml solver.

The paper (§4.1) tracks every value in the adder graph as a *quantized
interval* ``[l, h, delta]``: the lowest representable value, the highest
representable value, and the step size.  For a generic fixed-point number
``fixed<S, W, I>`` (S = sign bit, W = total width, I = integer bits
including sign):

    l     = -S * 2^(I-S)
    h     =  2^(I-S) - 2^(-W+I)
    delta =  2^(-W+I)

Tracking intervals instead of (W, I) pairs lets the solver accumulate many
terms without paying a blanket carry bit per addition: the exact reachable
range is propagated instead.

All interval endpoints are stored as *exact* integers scaled by the step:
we represent a qint as ``(lo, hi, exp)`` meaning the real interval
``[lo * 2^exp, hi * 2^exp]`` with step ``2^exp``, where ``lo``/``hi`` are
Python ints (arbitrary precision, no overflow).
"""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class QInterval:
    """Quantized interval [lo * 2^exp, hi * 2^exp] with step 2^exp.

    ``lo`` and ``hi`` are exact integers; ``exp`` is the base-2 exponent of
    the quantization step.  ``lo <= hi`` always.  The degenerate constant 0
    is represented as (0, 0, 0).
    """

    lo: int
    hi: int
    exp: int

    def __post_init__(self) -> None:
        if self.lo > self.hi:
            raise ValueError(f"QInterval lo {self.lo} > hi {self.hi}")

    # ------------------------------------------------------------------
    # Constructors
    # ------------------------------------------------------------------
    @staticmethod
    def from_fixed(signed: bool, width: int, int_bits: int) -> "QInterval":
        """Build from a fixed<S, W, I> spec (I includes the sign bit)."""
        if width <= 0:
            raise ValueError("width must be positive")
        s = 1 if signed else 0
        exp = int_bits - width  # step = 2^(I - W)
        n_mag = width - s
        if signed:
            lo = -(1 << n_mag)
            hi = (1 << n_mag) - 1
        else:
            lo = 0
            hi = (1 << n_mag) - 1
        return QInterval(lo, hi, exp)

    @staticmethod
    def constant(value_num: int, exp: int = 0) -> "QInterval":
        return QInterval(value_num, value_num, exp)

    # ------------------------------------------------------------------
    # Properties
    # ------------------------------------------------------------------
    @property
    def is_zero(self) -> bool:
        return self.lo == 0 and self.hi == 0

    @property
    def signed(self) -> bool:
        return self.lo < 0

    @property
    def width(self) -> int:
        """Total bitwidth W needed to represent every point on the grid."""
        if self.is_zero:
            return 0
        # magnitude bits to cover max(|lo|, hi) given two's complement
        if self.lo < 0:
            mag = max(self.hi, -self.lo - 1)
            return mag.bit_length() + 1 if mag > 0 else 1
        return self.hi.bit_length()

    @property
    def msb(self) -> int:
        """Position (exponent) of the most significant bit, inclusive."""
        return self.exp + self.width - 1

    @property
    def lsb(self) -> int:
        """Position (exponent) of the least significant bit."""
        return self.exp

    # ------------------------------------------------------------------
    # Arithmetic
    # ------------------------------------------------------------------
    def shift(self, s: int) -> "QInterval":
        """Multiply by 2^s (free in hardware: bit reinterpretation)."""
        if s == 0 or self.is_zero:
            return self
        return QInterval(self.lo, self.hi, self.exp + s)

    def neg(self) -> "QInterval":
        return QInterval(-self.hi, -self.lo, self.exp)

    def add(self, other: "QInterval") -> "QInterval":
        return _combine(self, other, +1)

    def sub(self, other: "QInterval") -> "QInterval":
        return _combine(self, other, -1)

    def scale(self, k: int) -> "QInterval":
        """Multiply by an exact integer constant k."""
        if k == 0:
            return QInterval(0, 0, 0)
        a, b = self.lo * k, self.hi * k
        return QInterval(min(a, b), max(a, b), self.exp)

    def union(self, other: "QInterval") -> "QInterval":
        if self.is_zero:
            return other
        if other.is_zero:
            return self
        exp = min(self.exp, other.exp)
        lo = min(self.lo << (self.exp - exp), other.lo << (other.exp - exp))
        hi = max(self.hi << (self.exp - exp), other.hi << (other.exp - exp))
        return QInterval(lo, hi, exp)

    def contains_value(self, v_num: int, v_exp: int) -> bool:
        """Whether value v_num * 2^v_exp lies on this interval's grid."""
        if self.is_zero:
            return v_num == 0
        d = v_exp - self.exp
        if d < 0:
            return False
        n = v_num << d
        return self.lo <= n <= self.hi


def _combine(a: QInterval, b: QInterval, sign: int) -> QInterval:
    """a + sign*b with exact interval propagation."""
    if b.is_zero:
        return a
    if a.is_zero:
        return b if sign > 0 else b.neg()
    exp = min(a.exp, b.exp)
    alo, ahi = a.lo << (a.exp - exp), a.hi << (a.exp - exp)
    blo, bhi = b.lo << (b.exp - exp), b.hi << (b.exp - exp)
    if sign > 0:
        return QInterval(alo + blo, ahi + bhi, exp)
    return QInterval(alo - bhi, ahi - blo, exp)


def qint_add_shifted(a: QInterval, b: QInterval, shift: int, sign: int) -> QInterval:
    """Interval of ``a + sign * (b << shift)``."""
    return _combine(a, b.shift(shift), sign)
