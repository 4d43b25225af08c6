"""Canonical signed digit (CSD) representation (Avizienis 1961).

CSD is a radix-2 signed-digit encoding with digits in {-1, 0, +1} in which
no two consecutive digits are non-zero.  It is the minimum-weight signed
digit representation: an x-digit number has at most floor(x/2 + 1)
non-zero digits (~1/3 of positions non-zero on average).  The da4ml CSE
stage (paper §4.4) operates on the CSD digit tensor of the constant
matrix.

All functions here are vectorised over numpy integer arrays.
"""

from __future__ import annotations

import numpy as np


def csd_span(values: np.ndarray) -> int:
    """Number of digit positions B needed to CSD-encode all of ``values``.

    CSD of an n-bit number can carry into bit n, so we add one guard
    position.
    """
    m = int(np.max(np.abs(values.astype(np.int64)))) if values.size else 0
    return max(m.bit_length() + 1, 1)


def to_csd(values: np.ndarray, span: int | None = None) -> np.ndarray:
    """CSD-encode an integer array.

    Returns an int8 array of shape ``values.shape + (B,)`` with entries in
    {-1, 0, +1}; position b carries weight 2^b.
    """
    x = np.asarray(values, dtype=np.int64).copy()
    B = span if span is not None else csd_span(x)
    digits = np.zeros(x.shape + (B,), dtype=np.int8)
    for b in range(B):
        odd = (x & 1) != 0
        # For odd x: digit = +1 if x ≡ 1 (mod 4) else -1 (x ≡ 3 mod 4).
        rem4 = x & 3
        d = np.where(odd, np.where(rem4 == 3, -1, 1), 0).astype(np.int8)
        digits[..., b] = d
        x = (x - d) >> 1
    if np.any(x != 0):
        raise ValueError(f"span {B} too small to CSD-encode values")
    return digits


def from_csd(digits: np.ndarray) -> np.ndarray:
    """Decode a CSD digit tensor back to int64 values."""
    B = digits.shape[-1]
    weights = (1 << np.arange(B, dtype=np.int64))
    return (digits.astype(np.int64) * weights).sum(axis=-1)


def csd_nnz(values: np.ndarray) -> np.ndarray:
    """Number of non-zero CSD digits of each element (vectorised).

    Uses the closed form: nnz(x) = popcount((x ^ 3x) >> 1) — the CSD
    non-zero digit count equals the number of positions where x and 3x
    differ above bit 0 (carries in x + 2x mark signed-digit boundaries).
    """
    x = np.abs(np.asarray(values, dtype=np.int64))
    y = (x ^ (3 * x)) >> 1
    return popcount64(y)


def popcount64(x: np.ndarray) -> np.ndarray:
    x = x.astype(np.uint64)
    x = x - ((x >> np.uint64(1)) & np.uint64(0x5555555555555555))
    x = (x & np.uint64(0x3333333333333333)) + ((x >> np.uint64(2)) & np.uint64(0x3333333333333333))
    x = (x + (x >> np.uint64(4))) & np.uint64(0x0F0F0F0F0F0F0F0F)
    return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(np.int64)


def vector_csd_nnz(vec: np.ndarray) -> int:
    """Total CSD non-zero digit count of an integer vector."""
    return int(csd_nnz(vec).sum())
