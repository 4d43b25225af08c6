"""Cost and delay models for the adder graph (paper §3, Eq. 1).

The dominant operation is ``a +/- (b << s)``.  Its expected cost is the
number of full/half adders needed, i.e. the number of output bits that
depend on more than one input bit:

    cost(bw_a, bw_b, s, sign) = max(bw_a, bw_b + s) - min(0, s) + 1   (1)

We evaluate the model on exact quantized intervals, which is strictly
tighter than raw (W, I) bookkeeping: accumulating k terms only pays carry
bits the reachable range actually requires.

Delay is modelled as adder depth (every adder = 1 unit, routing dominates
— §3), following [4, 5, 23].
"""

from __future__ import annotations

import heapq
from collections.abc import Iterable

import numpy as np

from .fixed_point import QInterval


def adder_cost(qa: QInterval, qb: QInterval, sh_a: int, sh_b: int, sign: int) -> int:
    """Eq. (1) on quantized intervals for ``(a<<sh_a) + sign*(b<<sh_b)``.

    Bit positions are absolute (qint exps included), so differently-scaled
    operands are costed exactly.  Returns the number of output bit
    positions at or above the higher of the two LSBs, plus one carry —
    bits below both LSBs are wiring, not logic.
    """
    if qa.is_zero or qb.is_zero:
        return 0
    a = qa.shift(sh_a)
    b = qb.shift(sh_b)
    msb = max(a.msb, b.msb)
    lsb_hi = max(a.lsb, b.lsb)
    lsb_lo = min(a.lsb, b.lsb)
    if lsb_hi > msb:
        # disjoint ranges: pure concatenation, no adder logic in theory;
        # charge 1 for the splice (sign handling / carry into the gap).
        # Eq. (1) is stated only for overlapping operands (§3).
        return 1
    # Eq. (1): max(bw_a, bw_b + s) - min(0, s) + 1, expressed in absolute
    # bit positions: every position from the lower LSB to the MSB, plus
    # one carry bit.
    return msb - lsb_lo + 2


def overlap_bits(qa: QInterval, qb: QInterval, sh_a: int, sh_b: int) -> int:
    """Number of bit positions where both operands carry data (CSE weight).

    The paper weights subexpression frequency by operand bit overlap so
    that half-adder 'overhead' bits (which widen downstream accumulators)
    are not rewarded.
    """
    if qa.is_zero or qb.is_zero:
        return 0
    a = qa.shift(sh_a)
    b = qb.shift(sh_b)
    lo = max(a.lsb, b.lsb)
    hi = min(a.msb, b.msb)
    return max(hi - lo + 1, 0)


def ceil_log2(n: int) -> int:
    if n <= 1:
        return 0
    return (n - 1).bit_length()


def min_tree_depth(depths: Iterable[int]) -> int:
    """Minimal achievable max-depth of a binary merge tree over leaves
    with given depths (merge cost: max(d1, d2) + 1).

    Greedy on a min-heap (always merge the two shallowest) is optimal for
    this objective — the min-max analogue of Huffman coding.
    """
    h = list(depths)
    if not h:
        return 0
    heapq.heapify(h)
    while len(h) > 1:
        d1 = heapq.heappop(h)
        d2 = heapq.heappop(h)
        heapq.heappush(h, max(d1, d2) + 1)
    return h[0]


def min_tree_depth_hist(hist: dict) -> int:
    """``min_tree_depth`` over a depth histogram ``{depth: count}``.

    Equivalent to expanding the histogram into a leaf list, but O(distinct
    depths) instead of O(n log n): within one depth level, greedy pairwise
    merging sends ceil(n/2) nodes to the next level (an odd leftover at
    depth d merges with the next-shallowest node at some d' > d, yielding
    d' + 1 — exactly as if it already sat at depth d'), and a lone node
    floats up to the next populated level unchanged.
    """
    items = sorted((d, c) for d, c in hist.items() if c > 0)
    if not items:
        return 0
    carry = 0
    pos = 0
    for d, c in items:
        if carry == 0:
            pos, carry = d, c
            continue
        while pos < d and carry > 1:
            carry = (carry + 1) // 2
            pos += 1
        pos = d  # a lone leftover merges as if at the deeper level
        carry += c
    while carry > 1:
        carry = (carry + 1) // 2
        pos += 1
    return pos


def min_tree_depth_hist_batch(levels: np.ndarray, counts: np.ndarray) -> np.ndarray:
    """:func:`min_tree_depth_hist` for a *batch* of histograms sharing one
    sorted level axis: ``counts[b, l]`` leaves at depth ``levels[l]``.

    This is the CSE delay-constraint batch scorer: one call evaluates the
    feasibility of every candidate acceptance count k = 1..n of a pattern
    in a column (each k shifts k leaves per operand row onto the merged
    row's depth), replacing n sequential scalar simulations per trial.

    Exactly matches the scalar recurrence: within one level, ``c`` leaves
    plus an incoming carry merge pairwise; advancing a carry across a gap
    of ``t`` levels is ``max(ceil(carry / 2^t), 1)`` (ceil-division
    composes across stages, and the ``max(. , 1)`` clamp commutes with
    it).  ``pos`` only advances while the carry still has pairs to merge
    (``ceil_log2(carry)`` steps), so zero-count levels — which the scalar
    version filters out before iterating — are exact no-ops.
    """
    levels = np.asarray(levels, dtype=np.int64)
    counts = np.asarray(counts, dtype=np.int64)
    n_b, n_l = counts.shape
    pos = np.zeros(n_b, dtype=np.int64)
    carry = np.zeros(n_b, dtype=np.int64)
    for li in range(n_l):
        d = int(levels[li])
        c = counts[:, li]
        started = carry > 0
        if started.any():
            t = np.minimum(np.where(started, d - pos, 0), 62)
            # halvings until the carry collapses to 1 = ceil_log2(carry);
            # frexp is exact here (carry - 1 < 2^53)
            h = np.frexp(np.maximum(carry - 1, 0).astype(np.float64))[1]
            pos = pos + np.minimum(t, h.astype(np.int64))
            carry = np.where(
                started, np.maximum((carry + (1 << t) - 1) >> t, 1), carry
            )
        pos = np.where(c > 0, d, pos)
        carry = carry + c
    while True:
        m = carry > 1
        if not m.any():
            break
        carry = np.where(m, (carry + 1) >> 1, carry)
        pos = np.where(m, pos + 1, pos)
    return np.where(carry > 0, pos, 0)


def lut_estimate(cost_bits: int) -> int:
    """FPGA LUT estimate: ~1 LUT per full/half adder bit (6-input LUTs
    with carry chains absorb one result bit each on UltraScale+)."""
    return cost_bits


def delay_estimate_ns(depth: int, per_adder_ns: float = 0.45) -> float:
    """Rough logic+routing delay estimate used for pipelining decisions."""
    return depth * per_adder_ns
