"""Stage 2 of da4ml: cost-aware two-term common subexpression elimination.

Operates on the CSD digit tensor of an integer coefficient matrix whose
rows are *existing program values* (inputs, or stage-1 intermediates).
State (paper §4.4):

  * ``M_expr`` — sparse digit storage, per output column a compacted
    numpy triple ``(rows, poss, digs)`` with digit in {-1, +1} plus a
    ``(row, pos) -> slot`` index (:class:`_ColStore`);
  * ``L_impl`` — the DAIS program rows (implemented values).

Each update step selects a two-term subexpression — canonical four-tuple
``(i, j, s, sign)`` encoding ``u = (x_i << max(0,-s)) + sign * (x_j <<
max(0,s))``, packed into a single int64 key — and implements it,
replacing every occurrence's digit pair with a single digit on the new
row.

Key differences from prior art that this module reproduces:

  * subexpressions are matched across *different power-of-two scalings*
    (relative shift ``s`` is part of the key, not a uniform row/column
    shift as in MCMT [13]) and across *signed digits* (``sign`` in key),
    unlike Scalable CMVM [57];
  * selection is most-frequent-first via a cached frequency table, not
    the O(|L_impl|^2) one-step-lookahead of [4, 14] — the paper measures
    the lookahead is worth <2% adders;
  * frequency is weighted by the *operand bit overlap* (paper §4.4): the
    cost model (Eq. 1) prefers operands with similar bitwidths/shifts, but
    weighting by full cost would reward half-adder overhead bits; overlap
    weighting is the paper's compromise;
  * a delay constraint is enforced per output column: a replacement is
    rejected if the column's minimal achievable merge-tree depth would
    exceed its budget.

Selection semantics (shared by both engines, enforced identical by
test): repeatedly implement the key with the maximum priority
``count * weight`` among keys with ``count >= 2`` that are not dormant,
breaking priority ties toward the smallest packed key.  A key whose
implementation fails (all occurrences depth-rejected, or fewer than two
disjoint occurrences survive) goes *dormant* and is reconsidered only
when its count next increases.

Three interchangeable engines realise this rule
(``engine="batch"`` is the default; see docs/solver_performance.md):

  * ``engine="heap"`` — exact lazy max-heap of ``(-priority, key)``
    entries with lazy deletion: a fresh entry is pushed whenever a key's
    count increases, so for every eligible key some entry bounds its
    current priority from above; stale entries are corrected (or
    discarded) at pop time.
  * ``engine="batch"`` — generation-stamped top-k candidate array.
    Cached priorities are upper bounds (counts only decay without a
    re-append); each implementation step bumps a generation counter, and
    an entry's cached score is exact iff its stamp is current.  One
    selection round takes the running max of the cached scores,
    re-scores the stale entries *at that value* in one vectorized sweep,
    and implements the smallest exact winner — the common path performs
    zero heap operations.  Keys outside the top-k array live in a
    deferred *rest* tier summarised by one stale upper bound; only when
    the running best decays to that bound is the tier re-scored (one
    vectorized sweep) and re-partitioned.
  * ``engine="arena"`` — the batch selection rule over a fully
    array-resident core (:class:`CSEArena`): column digit stores are
    bump-allocated windows over flat reusable buffers carrying packed
    ``row << 16 | pos`` tokens, the pair-count table (with per-key
    dormancy bytes) lives in preallocated open-addressed arrays, and the
    per-step replace/count-delta pass is fused — pair keys are computed
    straight from (token, digit) windows and scattered into the count
    table with one ``np.add.at`` instead of the batch engine's
    sort + ``reduceat`` dedup.  Buffers persist (per thread, see
    :func:`get_thread_arena`) so repeated solves run allocation-quiet.
    Selection semantics are shared with ``batch`` verbatim, so programs
    are bit-identical across all three engines.

Performance notes (the solver fast path; see docs/solver_performance.md):

  * pattern keys are packed int64s; the initial pair-count table is built
    in a single vectorized pass (one ``_canon_pack`` + one ``np.unique``
    over every column's upper-triangle pairs at once);
  * the count update after an implementation step is ONE signed-delta
    batch (removed/added digits against the live stores, all accepted
    columns concatenated into a single packed-key array), deduplicated
    with a single ``np.unique`` and applied through the vectorized
    open-addressed :class:`_CountTable`;
  * ``row_cols`` maps each program row to the set of columns that may
    hold its digits (pruned lazily when a scan finds none), so locating a
    pattern's columns is one set intersection — no per-(key, column)
    count bookkeeping on the hot path;
  * priorities (overlap-bit weights) are computed vectorized from
    per-row ``lsb/msb/depth`` metadata arrays synced with the program;
  * the delay-constraint simulation in ``_implement`` evaluates a whole
    candidate batch per trial: replacing k occurrences shifts exactly
    k digits of row i and k of row j onto the new row's depth, so the
    feasibility of every acceptance count k = 1..n is one
    :func:`min_tree_depth_hist_batch` call on an O(distinct depths)
    histogram instead of n scalar tree simulations.
"""

from __future__ import annotations

import heapq
import threading
import weakref
from dataclasses import dataclass

import numpy as np

from ..obs import trace
from ..obs.metrics import get_registry
from .cost import min_tree_depth_hist, min_tree_depth_hist_batch, overlap_bits  # noqa: F401
from .csd import to_csd
from .dais import DAISProgram, Term

# ----------------------------------------------------------------------
# Pattern keys
# ----------------------------------------------------------------------
# Canonical key (i, j, s, sign): rows i <= j in program order; when i == j,
# s > 0.  Digit pair ((i, p), (j, p + s)) with product sign realises
#   d_i * 2^min(p, p+s) * u,   u = (x_i << max(0,-s)) + sign*(x_j << max(0,s))
#
# Keys are packed into a single int64 (rows < 2^21, |s| < 2^14, 1 sign
# bit) so they can be produced and deduplicated by vectorized numpy code.
# ``key >> 17`` strips shift and sign, leaving the packed row pair.

_ROW_BITS = 21
_ROW_MASK = (1 << _ROW_BITS) - 1
_S_OFF = 1 << 14

# Digit tokens: row << _TOK_BITS | pos packs one digit slot into an int64
# whose natural order IS the (row, pos) lexicographic order the canonical
# key needs — the arena engine's pair builder swaps with min/max instead
# of the 4-way compare of _canon_pack.  Positions are CSD digit indices
# (< csd_span <= 66), far below the 2^16 field.
_TOK_BITS = 16
_TOK_MASK = (1 << _TOK_BITS) - 1

# batch engine: size of the active candidate tier (the rest is deferred
# behind a single stale upper bound).  1024 won the sweep in
# docs/solver_performance.md: small enough that the per-selection running
# max is cheap, large enough that the stale bound effectively never binds.
_TIER = 1024


def _pack_keys(r1, r2, s, sg):
    """Pack canonical key components (scalars or arrays) into int64."""
    return (((r1 << _ROW_BITS) | r2) << 16 | (s + _S_OFF)) << 1 | (sg > 0)


def _unpack_key(key: int) -> tuple[int, int, int, int]:
    sign = 1 if (key & 1) else -1
    rest = key >> 1
    s = (rest & 0xFFFF) - _S_OFF
    rest >>= 16
    return (rest >> _ROW_BITS, rest & _ROW_MASK, s, sign)


def _canon_pack(rA, pA, dA, rB, pB, dB):
    """Vectorized canonical packed keys for digit pairs (arrays broadcast)."""
    swap = (rB < rA) | ((rB == rA) & (pB < pA))
    r1 = np.where(swap, rB, rA)
    p1 = np.where(swap, pB, pA)
    r2 = np.where(swap, rA, rB)
    p2 = np.where(swap, pA, pB)
    return _pack_keys(r1, r2, p2 - p1, dA * dB)


def _pack_pair_keys(tA, dA, tB, dB):
    """Canonical packed keys for digit pairs given (token, digit) arrays.

    Bit-for-bit identical to :func:`_canon_pack` on the unpacked
    components: token order equals (row, pos) lexicographic order, so the
    canonical swap is one ``minimum``/``maximum`` pair, and the sign bit
    is ``(dA * dB + 1) >> 1`` (digits are +-1)."""
    mn = np.minimum(tA, tB)
    mx = np.maximum(tA, tB)
    key = ((mn >> _TOK_BITS) << _ROW_BITS) | (mx >> _TOK_BITS)
    key = (key << 16) | ((mx & _TOK_MASK) - (mn & _TOK_MASK) + _S_OFF)
    return (key << 1) | ((dA * dB + 1) >> 1)


_HASH_MULT = np.uint64(0x9E3779B97F4A7C15)


class _CountTable:
    """Open-addressed int64 -> int64 counter with vectorized batch ops.

    Replaces a Python dict on the CSE hot path: a whole implementation
    step's count delta becomes a handful of numpy gathers/scatters with
    linear probing (multiplicative hashing on the HIGH product bits)
    instead of one dict operation per key.  Keys must be >= 0 (-1 is the
    empty sentinel); absent keys read as 0 and zeroed entries are kept.
    """

    __slots__ = ("mask", "shift", "keys", "vals", "n")

    def __init__(self, cap: int = 1 << 16) -> None:
        self.mask = cap - 1
        self.shift = np.uint64(64 - (cap.bit_length() - 1))
        self.keys = np.full(cap, -1, dtype=np.int64)
        self.vals = np.zeros(cap, dtype=np.int64)
        self.n = 0

    def _slots_claim(self, k: np.ndarray) -> np.ndarray:
        """Slot per key (existing or newly claimed); keys must be unique.
        (The arena engine's duplicate-bearing per-step stream goes
        through :meth:`_ArenaCountTable.scatter_add` instead.)"""
        mask = self.mask
        idx = ((k.astype(np.uint64) * _HASH_MULT) >> self.shift).astype(np.int64)
        out = np.empty(k.shape[0], dtype=np.int64)
        pending = np.arange(k.shape[0])
        while pending.size:
            slots = idx[pending]
            cur = self.keys[slots]
            hit = cur == k[pending]
            empty = cur == -1
            if empty.any():
                e = pending[empty]
                self.keys[idx[e]] = k[e]  # duplicate slots: last write wins
                won = self.keys[idx[e]] == k[e]
                self.n += int(won.sum())
                hit = hit.copy()
                hit[empty] = won
            out[pending[hit]] = idx[pending[hit]]
            pending = pending[~hit]
            idx[pending] = (idx[pending] + 1) & mask
        return out

    def add_batch(self, k: np.ndarray, delta: np.ndarray) -> np.ndarray:
        """counts[k] += delta for unique keys; returns the new counts."""
        # grow until the worst case (every key new) fits under 33% load —
        # probes then almost always resolve in one vectorized round, and a
        # single under-sized growth step could leave the table full and
        # turn the linear probe into an infinite loop
        while (self.n + k.shape[0]) * 3 > self.mask + 1:
            self._grow()
        slots = self._slots_claim(k)
        new = self.vals[slots] + delta
        self.vals[slots] = new
        return new

    def get_batch(self, k: np.ndarray) -> np.ndarray:
        mask = self.mask
        idx = ((k.astype(np.uint64) * _HASH_MULT) >> self.shift).astype(np.int64)
        out = np.zeros(k.shape[0], dtype=np.int64)
        pending = np.arange(k.shape[0])
        while pending.size:
            slots = idx[pending]
            cur = self.keys[slots]
            hit = cur == k[pending]
            out[pending[hit]] = self.vals[slots[hit]]
            done = hit | (cur == -1)
            pending = pending[~done]
            idx[pending] = (idx[pending] + 1) & mask
        return out

    def get(self, key: int) -> int:
        mask = self.mask
        keys = self.keys
        idx = ((key * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF) >> int(self.shift)
        while True:
            cur = keys[idx]
            if cur == key:
                return int(self.vals[idx])
            if cur == -1:
                return 0
            idx = (idx + 1) & mask

    def _grow(self) -> None:
        live = self.keys != -1
        lk, lv = self.keys[live], self.vals[live]
        cap = (self.mask + 1) * 2
        while self.n * 2 > cap:
            cap *= 2
        self.mask = cap - 1
        self.shift = np.uint64(64 - (cap.bit_length() - 1))
        self.keys = np.full(cap, -1, dtype=np.int64)
        self.vals = np.zeros(cap, dtype=np.int64)
        self.n = 0
        slots = self._slots_claim(lk)
        self.vals[slots] = lv


class CSEArena:
    """Reusable numpy workspace for ``engine="arena"`` CSE solves.

    Every long-lived mutable buffer of one arena-engine run lives here:
    the open-addressed pair-count table (plus per-key dormancy bytes),
    the candidate-tier arrays, the flat column-store buffers (handed out
    as bump-allocated windows), and the per-step scratch vectors.
    Buffers only ever grow — ``n_reallocs`` counts growth events — so a
    second solve of the same shape reports zero new reallocations and
    the hot loop runs entirely inside memory allocated by the first.

    One arena serves one CSE run at a time; ``CSE`` falls back to a
    fresh private arena when the thread's arena is busy.  Use
    :func:`get_thread_arena` for the per-thread instance that
    ``CSE(engine="arena")`` picks up automatically — per-thread reuse is
    what keeps the compiler's thread-pool solves allocation-quiet
    across layers.  Not thread-safe; never share one arena between
    threads.
    """

    __slots__ = (
        "scratch", "tab_keys", "tab_vals", "tab_dorm", "col_bufs",
        "col_cap", "col_top", "n_reallocs", "n_solves", "busy",
        "_col_demand", "_col_demand_hw", "_owner",
    )

    _COL_FIELDS = ("rows", "poss", "digs", "toks")

    def __init__(self) -> None:
        self.scratch: dict[str, np.ndarray] = {}
        self.tab_keys: np.ndarray | None = None
        self.tab_vals: np.ndarray | None = None
        self.tab_dorm: np.ndarray | None = None
        self.col_bufs: dict[str, np.ndarray] = {}
        self.col_cap = 0
        self.col_top = 0
        self.n_reallocs = 0
        self.n_solves = 0
        self.busy = False
        self._col_demand = 0
        self._col_demand_hw = 0
        self._owner: weakref.ref | None = None

    # -- lifecycle -----------------------------------------------------
    def acquire(self, owner=None) -> bool:
        """Claim the arena for one CSE run; False when already in use.

        The owner is held by weakref: if a previous owner died without
        releasing (e.g. its ``__init__`` raised after acquiring), the
        arena is reclaimed here instead of staying busy forever."""
        if self.busy and not (
            self._owner is not None and self._owner() is None
        ):
            return False
        self.busy = True
        self._owner = weakref.ref(owner) if owner is not None else None
        self.n_solves += 1
        self.col_top = 0
        self._col_demand = 0
        return True

    def release(self) -> None:
        # grow the column arena to this run's high-water NOW (not at the
        # next acquire), so the realloc is charged to the run that
        # discovered the demand and a repeat solve starts preallocated
        self._col_demand_hw = max(self._col_demand_hw, self._col_demand)
        if self.col_cap < self._col_demand_hw:
            self._grow_cols(self._col_demand_hw)
        self.busy = False
        self._owner = None

    # -- named scratch vectors ----------------------------------------
    def take(self, name: str, n: int, dtype=np.int64) -> np.ndarray:
        """A named scratch buffer of capacity >= n (slice ``[:n]``)."""
        buf = self.scratch.get(name)
        if buf is None or buf.shape[0] < n or buf.dtype != dtype:
            cap = 256
            while cap < n:
                cap <<= 1
            self.scratch[name] = buf = np.empty(cap, dtype=dtype)
            self.n_reallocs += 1
        return buf

    # -- column-store bump allocator ----------------------------------
    def col_alloc(self, cap: int) -> dict[str, np.ndarray]:
        """One column window (rows/poss/digs/toks) of capacity ``cap``."""
        self._col_demand += cap
        if self.col_top + cap > self.col_cap:
            self._grow_cols(max(2 * self.col_cap, self.col_top + cap))
        k = self.col_top
        self.col_top = k + cap
        return {f: self.col_bufs[f][k : k + cap] for f in self._COL_FIELDS}

    def _grow_cols(self, need: int) -> None:
        cap = 1 << 12
        while cap < need:
            cap <<= 1
        # live windows keep referencing the orphaned buffers (their views
        # hold the old base arrays alive); only new windows land here
        self.col_bufs = {f: np.empty(cap, dtype=np.int64) for f in self._COL_FIELDS}
        self.col_cap = cap
        self.col_top = 0
        self.n_reallocs += 1


_ARENA_TLS = threading.local()


def get_thread_arena() -> CSEArena:
    """The calling thread's shared :class:`CSEArena` (created on first
    use).  ``CSE(engine="arena")`` picks this up when no explicit arena
    is passed, so consecutive solves on one thread — including each of
    the compiler's thread-pool workers — reuse warm buffers."""
    ar = getattr(_ARENA_TLS, "arena", None)
    if ar is None:
        ar = _ARENA_TLS.arena = CSEArena()
    return ar


class _ArenaCountTable(_CountTable):
    """Arena-resident :class:`_CountTable` with per-key dormancy flags.

    The key/value/dormancy arrays live in (and are reused from) a
    :class:`CSEArena`; ``reset`` re-claims them for a new run and
    ``_grow`` re-homes them, each charging the arena a reallocation only
    on a genuine capacity increase.  Dormancy is a parallel byte per
    slot, so the selection loop tests a whole candidate batch with one
    vectorized probe instead of Python set membership."""

    __slots__ = ("arena", "dorm")

    def __init__(self, arena: CSEArena) -> None:
        self.arena = arena
        self.mask = 0
        self.shift = np.uint64(0)
        self.keys = None
        self.vals = None
        self.dorm = None
        self.n = 0

    def reset(self, n_expected: int) -> None:
        """Clear and size for ~n_expected initial keys, kept under 1/10
        load: a CSE run roughly triples its key population (every minted
        row spawns fresh pair keys) and occupancy may overcount duplicate
        claims, so the generous factor is what keeps the hot loop free of
        mid-run rehashes.  Reuses the arena's buffers whenever they are
        already big enough."""
        cap = 1 << 16
        while n_expected * 10 > cap:
            cap <<= 1
        self._rehome(cap)

    def _rehome(self, cap: int) -> None:
        """Point this table at a cleared ``cap``-entry slice of the
        arena's buffers, (re)allocating them only on a genuine capacity
        increase.  Slice, don't adopt, an oversized buffer: a small run
        (e.g. the stage-2 CSE after a big stage 1) then only wipes what
        it uses."""
        ar = self.arena
        if ar.tab_keys is None or ar.tab_keys.shape[0] < cap:
            ar.tab_keys = np.empty(cap, dtype=np.int64)
            ar.tab_vals = np.empty(cap, dtype=np.int64)
            ar.tab_dorm = np.empty(cap, dtype=np.int8)
            ar.n_reallocs += 1
        self.keys = ar.tab_keys[:cap]
        self.vals = ar.tab_vals[:cap]
        self.dorm = ar.tab_dorm[:cap]
        self.keys.fill(-1)
        self.vals.fill(0)
        self.dorm.fill(0)
        self.mask = cap - 1
        self.shift = np.uint64(64 - (cap.bit_length() - 1))
        self.n = 0

    def reserve(self, k: int) -> None:
        """Ensure ``k`` further (possibly new) keys fit under 50% load."""
        while (self.n + k) * 2 > self.mask + 1:
            self._grow()

    def _grow(self) -> None:
        live = self.keys != -1
        lk, lv, ld = self.keys[live], self.vals[live], self.dorm[live]
        cap = (self.mask + 1) * 2
        while self.n * 4 > cap:
            cap *= 2
        self._rehome(cap)
        slots = self._slots_claim(lk)
        self.vals[slots] = lv
        self.dorm[slots] = ld

    def scatter_add(self, k: np.ndarray, delta: np.ndarray):
        """Fused claim + scatter for a (possibly duplicated) key batch:
        returns ``(slots, before, after)`` where ``before``/``after`` are
        each key's count on either side of one ``np.add.at``.  The first
        probe round runs without index indirection (it touches every
        key); later rounds only handle the collision tail.  Occupancy may
        overcount duplicate new keys — it only drives the growth
        heuristic, which the 50% reserve threshold absorbs."""
        self.reserve(k.shape[0])
        mask = self.mask
        keys = self.keys
        idx = ((k.view(np.uint64) * _HASH_MULT) >> self.shift).view(np.int64)
        cur = keys[idx]
        hit = cur == k
        if not hit.all():
            empty = cur == -1
            if empty.any():
                e = np.flatnonzero(empty)
                keys[idx[e]] = k[e]  # duplicate slots: last write wins
                won = keys[idx[e]] == k[e]
                # exact occupancy (duplicate winners share a slot): the
                # unique() runs only over this step's new keys, and keeps
                # `n` honest so the 1/10 reset sizing never rehashes
                self.n += int(np.unique(idx[e][won]).size)
                hit[e] = won
            pending = np.flatnonzero(~hit)
            while pending.size:
                slots = (idx[pending] + 1) & mask
                idx[pending] = slots
                cur = keys[slots]
                hitp = cur == k[pending]
                empty = cur == -1
                if empty.any():
                    e = pending[empty]
                    keys[idx[e]] = k[e]
                    won = keys[idx[e]] == k[e]
                    self.n += int(np.unique(idx[e][won]).size)
                    hitp = hitp.copy()
                    hitp[empty] = won
                pending = pending[~hitp]
        vals = self.vals
        before = vals[idx]
        np.add.at(vals, idx, delta)
        after = vals[idx]
        return idx, before, after

    # -- dormancy ------------------------------------------------------
    def slots_lookup(self, k: np.ndarray) -> np.ndarray:
        """Slot per key, -1 when absent (read-only probe)."""
        mask = self.mask
        idx = ((k.astype(np.uint64) * _HASH_MULT) >> self.shift).astype(np.int64)
        out = np.full(k.shape[0], -1, dtype=np.int64)
        pending = np.arange(k.shape[0])
        while pending.size:
            slots = idx[pending]
            cur = self.keys[slots]
            hit = cur == k[pending]
            out[pending[hit]] = slots[hit]
            done = hit | (cur == -1)
            pending = pending[~done]
            idx[pending] = (idx[pending] + 1) & mask
        return out

    def dormant_mask(self, k: np.ndarray) -> np.ndarray:
        slots = self.slots_lookup(k)
        out = np.zeros(k.shape[0], dtype=bool)
        found = slots >= 0
        out[found] = self.dorm[slots[found]] != 0
        return out

    def set_dormant(self, key: int) -> None:
        mask = self.mask
        keys = self.keys
        idx = ((key * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF) >> int(self.shift)
        while True:
            cur = keys[idx]
            if cur == key:
                self.dorm[idx] = 1
                return
            if cur == -1:
                return  # absent keys have count 0: nothing to mark
            idx = (idx + 1) & mask

    def is_dormant(self, key: int) -> bool:
        mask = self.mask
        keys = self.keys
        idx = ((key * 0x9E3779B97F4A7C15) & 0xFFFFFFFFFFFFFFFF) >> int(self.shift)
        while True:
            cur = keys[idx]
            if cur == key:
                return bool(self.dorm[idx])
            if cur == -1:
                return False
            idx = (idx + 1) & mask


_TRIU_CACHE: dict[int, tuple[np.ndarray, np.ndarray]] = {}


def _triu(m: int) -> tuple[np.ndarray, np.ndarray]:
    hit = _TRIU_CACHE.get(m)
    if hit is None:
        hit = _TRIU_CACHE[m] = np.triu_indices(m, k=1)
    return hit


def _concat3(parts: list[tuple]) -> tuple:
    """Concatenate a list of (rows, poss, digs) triples componentwise."""
    if len(parts) == 1:
        return parts[0]
    return (
        np.concatenate([t[0] for t in parts]),
        np.concatenate([t[1] for t in parts]),
        np.concatenate([t[2] for t in parts]),
    )


def _step_pairs(sets: list[tuple], snaps: list[tuple], set_signs: list[int]):
    """All digit pairs one implementation step contributes for a list of
    per-column digit sets: each set element against every live digit of
    its column's (post-removal) store snapshot, plus the pairs within the
    set itself.  Columns are processed as one block-structured cross
    product — A-side components repeated per element, B-side gathered
    through a block-local index — so the whole step (removed and added
    sets together) needs a handful of numpy ops instead of per-column
    tiling.  Returns componentwise (A, B) tuples plus the per-pair count
    delta sign (the A-side set's sign), or None for an empty step."""
    cat_a = _concat3(sets)
    cat_s = _concat3(snaps)
    m = np.array([t[0].shape[0] for t in sets], dtype=np.int64)
    n = np.array([t[0].shape[0] for t in snaps], dtype=np.int64)
    sgn = np.asarray(set_signs, dtype=np.int64)
    a_parts: list[list] = [[], [], []]
    b_parts: list[list] = [[], [], []]
    s_parts: list[np.ndarray] = []
    reps = np.repeat(n, m)  # pairs per set element
    total = int(reps.sum())
    if total:
        ends = np.cumsum(reps)
        off_elem = np.repeat(np.cumsum(n) - n, m)  # store offset per element
        gidx = np.arange(total, dtype=np.int64) - np.repeat(
            ends - reps - off_elem, reps
        )
        for q in range(3):
            a_parts[q].append(np.repeat(cat_a[q], reps))
            b_parts[q].append(cat_s[q][gidx])
        s_parts.append(np.repeat(np.repeat(sgn, m), reps))
    ii_parts: list[np.ndarray] = []
    jj_parts: list[np.ndarray] = []
    tri_n = np.zeros(len(sets), dtype=np.int64)
    off = 0
    for si, t in enumerate(sets):
        mm = t[0].shape[0]
        if mm > 1:
            ii, jj = _triu(mm)
            tri_n[si] = ii.shape[0]
            ii_parts.append(ii + off)
            jj_parts.append(jj + off)
        off += mm
    if ii_parts:
        ii = np.concatenate(ii_parts) if len(ii_parts) > 1 else ii_parts[0]
        jj = np.concatenate(jj_parts) if len(jj_parts) > 1 else jj_parts[0]
        for q in range(3):
            a_parts[q].append(cat_a[q][ii])
            b_parts[q].append(cat_a[q][jj])
        s_parts.append(np.repeat(sgn, tri_n))
    if not a_parts[0]:
        return None
    a = tuple(np.concatenate(p) if len(p) > 1 else p[0] for p in a_parts)
    b = tuple(np.concatenate(p) if len(p) > 1 else p[0] for p in b_parts)
    s = np.concatenate(s_parts) if len(s_parts) > 1 else s_parts[0]
    return a, b, s


class _ColStore:
    """Compacted column digit store: parallel (rows, poss, digs, toks)
    vectors for the live digits plus a ``(row, pos) -> slot`` index.
    Removal swaps the last live slot in, so ``[:n]`` is always dense and
    directly usable by vectorized pair-key / occurrence / depth
    computations.  ``toks`` caches ``row << _TOK_BITS | pos`` per digit;
    the arena engine's pair builder consumes (toks, digs) windows
    directly.  With ``alloc`` (an arena's bump allocator) the vectors
    are windows into flat reusable buffers, and growth is an
    index-window move — the live slice relocates to a fresh window, the
    backing buffers persist across solves."""

    __slots__ = ("rows", "poss", "digs", "toks", "n", "index", "by_row", "_alloc")

    def __init__(self, rows, poss, digs, alloc=None) -> None:
        rows = np.asarray(rows, dtype=np.int64)
        poss = np.asarray(poss, dtype=np.int64)
        digs = np.asarray(digs, dtype=np.int64)
        n = int(rows.shape[0])
        self._alloc = alloc
        if alloc is not None:
            # digits only ever move within a column (k removed pairs are
            # replaced by k digits of the new row), so n never exceeds
            # the initial count; +4 absorbs the degenerate tiny columns
            w = alloc(n + 4)
            w["rows"][:n] = rows
            w["poss"][:n] = poss
            w["digs"][:n] = digs
            self.rows = w["rows"]
            self.poss = w["poss"]
            self.digs = w["digs"]
            self.toks = w["toks"]
        else:
            self.rows, self.poss, self.digs = rows, poss, digs
            self.toks = np.empty(n, dtype=np.int64)
        np.left_shift(self.rows[:n], _TOK_BITS, out=self.toks[:n])
        np.bitwise_or(self.toks[:n], self.poss[:n], out=self.toks[:n])
        self.n = n
        self.index = {}
        self.by_row: dict[int, dict[int, int]] = {}
        for k, (r, p, d) in enumerate(
            zip(rows.tolist(), poss.tolist(), digs.tolist())
        ):
            self.index[(r, p)] = k
            self.by_row.setdefault(r, {})[p] = d

    def __len__(self) -> int:
        return self.n

    def __contains__(self, rp) -> bool:
        return rp in self.index

    def get(self, row: int, pos: int) -> int:
        return int(self.digs[self.index[(row, pos)]])

    def live(self):
        return self.rows[: self.n], self.poss[: self.n], self.digs[: self.n]

    def add(self, row: int, pos: int, d: int) -> None:
        assert (row, pos) not in self.index, "duplicate digit slot"
        if self.n == self.rows.shape[0]:
            cap = max(2 * self.n, 8)
            if self._alloc is not None:
                w = self._alloc(cap)
                for name in ("rows", "poss", "digs", "toks"):
                    w[name][: self.n] = getattr(self, name)[: self.n]
                    setattr(self, name, w[name])
            else:
                for name in ("rows", "poss", "digs", "toks"):
                    a = getattr(self, name)
                    b = np.zeros(cap, dtype=np.int64)
                    b[: self.n] = a[: self.n]
                    setattr(self, name, b)
        k = self.n
        self.rows[k] = row
        self.poss[k] = pos
        self.digs[k] = d
        self.toks[k] = (row << _TOK_BITS) | pos
        self.index[(row, pos)] = k
        self.by_row.setdefault(row, {})[pos] = d
        self.n += 1

    def remove(self, row: int, pos: int) -> int:
        k = self.index.pop((row, pos))
        d = int(self.digs[k])
        last = self.n - 1
        if k != last:
            r2, p2 = int(self.rows[last]), int(self.poss[last])
            self.rows[k] = r2
            self.poss[k] = p2
            self.digs[k] = self.digs[last]
            self.toks[k] = self.toks[last]
            self.index[(r2, p2)] = k
        self.n = last
        m = self.by_row[row]
        del m[pos]
        if not m:
            del self.by_row[row]
        return d


@dataclass
class CSEStats:
    n_patterns_implemented: int = 0
    n_occurrences_replaced: int = 0
    n_rejected_by_depth: int = 0
    n_assembly_adders: int = 0
    # engine introspection (batch: tier reloads / stale-entry corrections;
    # heap: pops that had to correct or discard a stale entry)
    n_tier_reloads: int = 0
    n_stale_corrections: int = 0
    # observability: candidate-tier compactions this run, and arena
    # buffer-growth events charged to this run (0 for heap/batch)
    n_compactions: int = 0
    n_arena_reallocs: int = 0


class CSE:
    def __init__(
        self,
        prog: DAISProgram,
        coeff_cols: list[dict[int, int]],
        budgets: list[int | None] | None = None,
        weighted: bool = True,
        assembly_dedup: bool = True,
        depth_weight: float = 0.0,
        *,
        engine: str = "batch",
        build_counts: bool = True,
        arena: CSEArena | None = None,
    ) -> None:
        if engine not in ("heap", "batch", "arena"):
            raise ValueError(f"unknown CSE engine {engine!r}")
        self.prog = prog
        self.budgets = budgets if budgets is not None else [None] * len(coeff_cols)
        self.weighted = weighted
        self.assembly_dedup = assembly_dedup
        self.engine = engine
        # engine="arena": claim the (per-thread, unless given) workspace
        # for this run; released at the end of run().  A busy arena —
        # another live arena CSE on this thread — falls back to a fresh
        # private workspace so correctness never depends on reuse.
        self.arena: CSEArena | None = None
        self._arena_owned = False
        alloc = None
        if engine == "arena":
            ar = arena if arena is not None else get_thread_arena()
            if not ar.acquire(owner=self):
                ar = CSEArena()
                ar.acquire(owner=self)
            self.arena = ar
            self._arena_owned = True
            self._arena_reallocs0 = ar.n_reallocs
            alloc = ar.col_alloc
        # beyond-paper: under tight delay budgets, prefer subexpressions
        # with shallow operands (they leave headroom for further reuse
        # before the per-output depth budget binds):
        # priority /= (1 + depth_weight * max(depth_a, depth_b))
        self.depth_weight = depth_weight
        self.stats = CSEStats()

        # Column digit state, vectorized: the CSD digits of every column
        # are computed in one batch instead of per coefficient.
        self.cols: list[_ColStore] = []
        for col in coeff_cols:
            items = [(r, c) for r, c in col.items() if c != 0]
            if not items:
                self.cols.append(_ColStore([], [], []))
                continue
            rows = np.array([r for r, _ in items], dtype=np.int64)
            coeffs = np.array([c for _, c in items], dtype=np.int64)
            csd = to_csd(coeffs)  # [n, B]
            rr, pp = np.nonzero(csd)
            self.cols.append(
                _ColStore(
                    rows[rr], pp.astype(np.int64), csd[rr, pp].astype(np.int64),
                    alloc=alloc,
                )
            )

        # Frequency machinery (packed-int keyed).  Start tiny: the real
        # table is sized by _build_initial_counts, and the assembly-only
        # path (build_counts=False) never touches it.
        if engine == "arena":
            self.counts: _CountTable = _ArenaCountTable(self.arena)
            if not build_counts:
                self.counts.reset(0)
        else:
            self.counts = _CountTable(1 << 8)
        # program row -> columns that may contain digits of that row
        self.row_cols: dict[int, set[int]] = {}
        self._weights: dict[int, float] = {}
        # keys whose last implementation attempt failed; excluded from
        # selection until their count next increases.  heap/batch track
        # them in a Python set; arena keeps a dormancy byte per count-
        # table slot (_any_dormant just gates the vectorized probe).
        self._dormant: set[int] = set()
        self._any_dormant = False
        self._impl_cache: dict[int, int] = {}
        self._combine_cache: dict[tuple, Term] = {}

        # engine="heap": (-priority, key) entries, lazy deletion
        self.heap: list[tuple[float, int]] = []
        # engine="batch"/"arena": active candidate arrays + deferred rest
        # tier (arena: tier arrays live in the reusable workspace)
        self._gen = 0
        self._an = 0
        if engine == "arena":
            self._akeys = self.arena.take("tier_keys", 1024)
            self._apri = self.arena.take("tier_pri", 1024, np.float64)
            self._awt = self.arena.take("tier_wt", 1024, np.float64)
            self._agen = self.arena.take("tier_gen", 1024)
        else:
            self._akeys = np.empty(0, dtype=np.int64)
            self._apri = np.empty(0, dtype=np.float64)
            self._awt = np.empty(0, dtype=np.float64)  # static per-key weights
            self._agen = np.empty(0, dtype=np.int64)
        self._rest: np.ndarray | None = None
        self._rest_bound = -np.inf

        # Per-program-row metadata mirrors (lsb, msb, depth, is_zero) for
        # vectorized weight computation; synced lazily as rows are added.
        self._meta_n = 0
        self._meta_lsb = np.zeros(0, dtype=np.int64)
        self._meta_msb = np.zeros(0, dtype=np.int64)
        self._meta_depth = np.zeros(0, dtype=np.int64)
        self._meta_zero = np.zeros(0, dtype=bool)

        if build_counts:
            with trace.span("cse.pair_build", engine=engine, n_cols=len(coeff_cols)):
                self._build_initial_counts()

    # ------------------------------------------------------------------
    # Weights (static per key: operand qints are fixed at row creation)
    # ------------------------------------------------------------------
    def _sync_meta(self) -> None:
        n = len(self.prog.rows)
        if self._meta_n == n:
            return
        if n > self._meta_lsb.shape[0]:
            cap = max(2 * n, 64)
            for name in ("_meta_lsb", "_meta_msb", "_meta_depth"):
                a = getattr(self, name)
                b = np.zeros(cap, dtype=np.int64)
                b[: self._meta_n] = a[: self._meta_n]
                setattr(self, name, b)
            z = np.zeros(cap, dtype=bool)
            z[: self._meta_n] = self._meta_zero[: self._meta_n]
            self._meta_zero = z
        for k in range(self._meta_n, n):
            r = self.prog.rows[k]
            q = r.qint
            self._meta_depth[k] = r.depth
            if q.is_zero:
                self._meta_zero[k] = True
            else:
                self._meta_lsb[k] = q.lsb
                self._meta_msb[k] = q.msb
        self._meta_n = n

    def _weights_vec(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized priority weights for an array of packed keys."""
        self._sync_meta()
        rest = keys >> 1
        s = (rest & 0xFFFF) - _S_OFF
        rest = rest >> 16
        j = rest & _ROW_MASK
        i = rest >> _ROW_BITS
        w = np.ones(keys.shape[0], dtype=np.float64)
        if self.weighted:
            sh_a = np.maximum(0, -s)
            sh_b = np.maximum(0, s)
            msb_a = self._meta_msb[i] + sh_a
            lsb_a = self._meta_lsb[i] + sh_a
            msb_b = self._meta_msb[j] + sh_b
            lsb_b = self._meta_lsb[j] + sh_b
            ov = np.minimum(msb_a, msb_b) - np.maximum(lsb_a, lsb_b) + 1
            ov = np.where(
                self._meta_zero[i] | self._meta_zero[j], 0, np.maximum(ov, 0)
            )
            w = (ov + 1).astype(np.float64)
        if self.depth_weight:
            d = np.maximum(self._meta_depth[i], self._meta_depth[j])
            w = w / (1.0 + self.depth_weight * d)
        return w

    def _weight(self, key: int) -> float:
        """Scalar weight; bitwise-identical to :meth:`_weights_vec` (both
        engines compare the two with exact float equality, so the scalar
        and vector paths must stay in lockstep)."""
        w = self._weights.get(key)
        if w is not None:
            return w
        self._sync_meta()
        i, j, s, _sign = _unpack_key(key)
        w = 1.0
        if self.weighted:
            if self._meta_zero[i] or self._meta_zero[j]:
                ov = 0
            else:
                sh_a = -s if s < 0 else 0
                sh_b = s if s > 0 else 0
                msb_a = int(self._meta_msb[i]) + sh_a
                lsb_a = int(self._meta_lsb[i]) + sh_a
                msb_b = int(self._meta_msb[j]) + sh_b
                lsb_b = int(self._meta_lsb[j]) + sh_b
                ov = min(msb_a, msb_b) - max(lsb_a, lsb_b) + 1
                if ov < 0:
                    ov = 0
            w = float(ov + 1)
        if self.depth_weight:
            d = max(int(self._meta_depth[i]), int(self._meta_depth[j]))
            w = w / (1.0 + self.depth_weight * d)
        self._weights[key] = w
        return w

    # ------------------------------------------------------------------
    # Frequency table construction and maintenance
    # ------------------------------------------------------------------
    def _register_rows(self, rows: np.ndarray, c: int) -> None:
        """Record that column c holds digits of these program rows."""
        rc = self.row_cols
        for r in np.unique(rows).tolist():
            cols = rc.get(r)
            if cols is None:
                rc[r] = {c}
            else:
                cols.add(c)

    def _build_initial_counts(self) -> None:
        # One vectorized pass: concatenate every column's live digits,
        # offset each column's cached upper-triangle indices into the
        # concatenated frame, then pack and count ALL pairs with one
        # pack + np.unique — no per-column tables or gathers.  The arena
        # engine packs straight from the cached (token, digit) vectors
        # and counts into the reusable pre-sized table.
        arena = self.engine == "arena"
        stores: list[_ColStore] = []
        ii_parts: list[np.ndarray] = []
        jj_parts: list[np.ndarray] = []
        off = 0
        for c, store in enumerate(self.cols):
            n = len(store)
            if n < 2:
                continue
            self._register_rows(store.rows[:n], c)
            stores.append(store)
            ii, jj = _triu(n)
            ii_parts.append(ii + off)
            jj_parts.append(jj + off)
            off += n
        if not stores:
            if arena:
                self.counts.reset(0)
            return
        ii = np.concatenate(ii_parts) if len(ii_parts) > 1 else ii_parts[0]
        jj = np.concatenate(jj_parts) if len(jj_parts) > 1 else jj_parts[0]
        if arena:
            cat_tok = np.concatenate([s.toks[: s.n] for s in stores])
            cat_dig = np.concatenate([s.digs[: s.n] for s in stores])
            packed = _pack_pair_keys(
                cat_tok[ii], cat_dig[ii], cat_tok[jj], cat_dig[jj]
            )
        else:
            cat = _concat3([s.live() for s in stores])
            packed = _canon_pack(
                cat[0][ii], cat[1][ii], cat[2][ii],
                cat[0][jj], cat[1][jj], cat[2][jj],
            )
        uniq, cnt = np.unique(packed, return_counts=True)
        sums = cnt.astype(np.int64)
        if arena:
            self.counts.reset(uniq.shape[0])
        else:
            cap = 1 << 16
            while uniq.shape[0] * 3 > cap:
                cap *= 2
            self.counts = _CountTable(cap)
        self.counts.add_batch(uniq, sums)
        mask = sums >= 2
        keys2, cnts2 = uniq[mask], sums[mask]
        if keys2.shape[0] == 0:
            return
        wts = self._weights_vec(keys2)
        pris = cnts2 * wts
        if self.engine == "heap":
            self.heap = list(zip((-pris).tolist(), keys2.tolist()))
            heapq.heapify(self.heap)
            return
        # batch engine: seed the active tier with the top-k priorities and
        # summarise the rest behind one stale upper bound.  The bound stays
        # valid because a deferred key's count can only decrease without
        # routing through _apply_deltas's increase path, which re-appends
        # it to the active tier at its exact new priority.
        if keys2.shape[0] > _TIER:
            thr = np.partition(pris, pris.shape[0] - _TIER)[pris.shape[0] - _TIER]
            hi = pris >= thr
            lo_pris = pris[~hi]
            if lo_pris.shape[0]:
                self._rest = keys2[~hi]
                self._rest_bound = float(lo_pris.max())
            keys2, pris, wts = keys2[hi], pris[hi], wts[hi]
        self._active_append(keys2, pris, wts)

    def _active_append(self, keys: np.ndarray, pris: np.ndarray,
                       wts: np.ndarray) -> None:
        """Append exact-scored entries to the active tier (stamped with the
        current generation)."""
        m = keys.shape[0]
        if m == 0:
            return
        if self._an + m > self._akeys.shape[0]:
            self._compact(m)
        k = self._an
        self._akeys[k : k + m] = keys
        self._apri[k : k + m] = pris
        self._awt[k : k + m] = wts
        self._agen[k : k + m] = self._gen
        self._an = k + m

    def _compact(self, m: int) -> None:
        """Drop dead entries; if the live tier still exceeds 2x _TIER,
        demote everything below the top-_TIER cached priorities back to
        the rest tier (their cached scores are upper bounds, so folding
        them into the stale bound keeps selection exact) — the running-max
        scan stays O(_TIER) for the whole run."""
        self.stats.n_compactions += 1
        if self.engine == "arena":
            self._compact_arena(m)
            return
        live = self._apri[: self._an] > 0.0
        an = int(live.sum())
        ak = self._akeys[: self._an][live]
        ap = self._apri[: self._an][live]
        aw = self._awt[: self._an][live]
        ag = self._agen[: self._an][live]
        if an > 2 * _TIER:
            thr = np.partition(ap, an - _TIER)[an - _TIER]
            hi = ap >= thr
            self._demote_to_rest(ak[~hi], ap[~hi])
            ak, ap, aw, ag = ak[hi], ap[hi], aw[hi], ag[hi]
            an = ak.shape[0]
        cap = max(self._akeys.shape[0], 1024)
        while an + m > cap:
            cap *= 2
        for name, src, dt in (
            ("_akeys", ak, np.int64), ("_apri", ap, np.float64),
            ("_awt", aw, np.float64), ("_agen", ag, np.int64),
        ):
            buf = np.empty(cap, dtype=dt)
            buf[:an] = src
            setattr(self, name, buf)
        self._an = an

    def _compact_arena(self, m: int) -> None:
        """Arena tier compaction: live entries are moved down **inside**
        the workspace buffers (gather through a scratch window, write
        back — an index-window move) instead of copied into fresh
        arrays; only a genuine capacity shortfall reallocates."""
        an = self._an
        ar = self.arena
        live_idx = np.flatnonzero(self._apri[:an] > 0.0)
        k = live_idx.shape[0]
        if k > 2 * _TIER:
            ap = self._apri[live_idx]
            thr = np.partition(ap, k - _TIER)[k - _TIER]
            hi = ap >= thr
            demoted = live_idx[~hi]
            self._demote_to_rest(self._akeys[demoted], self._apri[demoted])
            live_idx = live_idx[hi]
            k = live_idx.shape[0]
        for name, arr, dt in (
            ("c_keys", self._akeys, np.int64), ("c_pri", self._apri, np.float64),
            ("c_wt", self._awt, np.float64), ("c_gen", self._agen, np.int64),
        ):
            tmp = ar.take(name, k, dt)
            np.take(arr, live_idx, out=tmp[:k])
            arr[:k] = tmp[:k]
        self._an = k
        if k + m > self._akeys.shape[0]:
            cap = self._akeys.shape[0]
            while k + m > cap:
                cap *= 2
            for nm, dt, attr in (
                ("tier_keys", np.int64, "_akeys"), ("tier_pri", np.float64, "_apri"),
                ("tier_wt", np.float64, "_awt"), ("tier_gen", np.int64, "_agen"),
            ):
                old = getattr(self, attr)
                buf = ar.take(nm, cap, dt)
                buf[:k] = old[:k]
                setattr(self, attr, buf)

    def _demote_to_rest(self, keys: np.ndarray, pris: np.ndarray) -> None:
        """Fold demoted candidate entries into the deferred rest tier.
        Their cached priorities are upper bounds, so folding them into
        the single stale bound keeps selection exact (shared by the
        batch and arena compaction paths — the demotion rule must stay
        identical for the engines to stay bit-identical)."""
        if not keys.shape[0]:
            return
        if self._rest is None:
            self._rest = keys
            self._rest_bound = float(pris.max())
        else:
            self._rest = np.concatenate([self._rest, keys])
            self._rest_bound = max(self._rest_bound, float(pris.max()))

    def _reload_rest(self) -> None:
        """Re-score the deferred tier in one vectorized sweep and
        re-partition it (called when the running best decays to the stale
        bound, so a deferred key could now be the global max)."""
        rest, self._rest = self._rest, None
        self._rest_bound = -np.inf
        self.stats.n_tier_reloads += 1
        cnts = self.counts.get_batch(rest)
        viable = cnts >= 2
        if viable.any():
            dorm = self._dormant_mask_of(rest)
            if dorm is not None:
                viable &= ~dorm
        keys = rest[viable]
        if keys.shape[0] == 0:
            return
        wts = self._weights_vec(keys)
        pris = cnts[viable] * wts
        if keys.shape[0] > _TIER:
            thr = np.partition(pris, pris.shape[0] - _TIER)[pris.shape[0] - _TIER]
            hi = pris >= thr
            lo_pris = pris[~hi]
            if lo_pris.shape[0]:
                self._rest = keys[~hi]
                self._rest_bound = float(lo_pris.max())
            keys, pris, wts = keys[hi], pris[hi], wts[hi]
        self._active_append(keys, pris, wts)

    def _mark_dormant(self, key: int) -> None:
        if self.engine == "arena":
            self.counts.set_dormant(key)
        else:
            self._dormant.add(key)
        self._any_dormant = True

    def _is_dormant(self, key: int) -> bool:
        if not self._any_dormant:
            return False
        if self.engine == "arena":
            return self.counts.is_dormant(key)
        return key in self._dormant

    def _dormant_mask_of(self, keys: np.ndarray) -> np.ndarray | None:
        """Boolean dormancy mask for an array of keys (None = none are)."""
        if not self._any_dormant:
            return None
        if self.engine == "arena":
            return self.counts.dormant_mask(keys)
        d = self._dormant
        if not d:
            return None
        return np.fromiter((k in d for k in keys.tolist()), bool, keys.shape[0])

    def _apply_deltas(self, keys: np.ndarray, signs: np.ndarray) -> None:
        """One signed-delta count update for a whole implementation step
        (``signs``: -1 for removed digit pairs, +1 for added ones).  Keys
        whose count increased to >= 2 leave dormancy and are (re)inserted
        into the engine's candidate pool at their exact new priority.
        """
        if not keys.shape[0]:
            return
        order = np.argsort(keys)
        sk = keys[order]
        first = np.empty(sk.shape[0], dtype=bool)
        first[0] = True
        np.not_equal(sk[1:], sk[:-1], out=first[1:])
        starts = np.flatnonzero(first)
        uniq = sk[starts]
        delta = np.add.reduceat(signs[order], starts)
        changed = delta != 0
        uniq = uniq[changed]
        delta = delta[changed]
        if not uniq.shape[0]:
            return
        self._gen += 1  # cached batch-engine scores may now be stale
        new = self.counts.add_batch(uniq, delta)
        pmask = (delta > 0) & (new >= 2)
        if pmask.any():
            pkeys = uniq[pmask]
            wts = self._weights_vec(pkeys)
            pris = new[pmask] * wts
            if self._dormant:
                dormant = self._dormant
                for k in pkeys.tolist():
                    dormant.discard(k)
            if self.engine == "heap":
                heap = self.heap
                for key, neg in zip(pkeys.tolist(), (-pris).tolist()):
                    heapq.heappush(heap, (neg, key))
            else:
                self._active_append(pkeys, pris, wts)

    def _apply_deltas_arena(self, keys: np.ndarray, signs: np.ndarray) -> None:
        """Fused count update of one implementation step: claim a slot
        per (non-unique) pair key, scatter the signed deltas with one
        ``np.add.at``, and read each key's net movement off the before /
        after slot values — no per-step sort, reduceat, or dedup.  A key
        whose count rose to >= 2 wakes from dormancy and (re)enters the
        active tier at its exact new priority, matching the batch
        engine's rule bit for bit (within one step a key's deltas all
        share a sign, so before/after comparison equals the net-delta
        test on the deduplicated stream)."""
        n = keys.shape[0]
        if not n:
            return
        tab: _ArenaCountTable = self.counts
        slots, before, after = tab.scatter_add(keys, signs)
        self._gen += 1  # cached tier scores may now be stale
        inc = (after > before) & (after >= 2)
        if not inc.any():
            return
        tab.dorm[slots[inc]] = 0
        uq, ui = np.unique(keys[inc], return_index=True)
        pv = after[inc][ui]
        wts = self._weights_vec(uq)
        self._active_append(uq, pv * wts, wts)

    # ------------------------------------------------------------------
    # Occurrence search
    # ------------------------------------------------------------------
    def _find_occurrences(self, key: int) -> dict[int, np.ndarray]:
        """Disjoint occurrences per column: sorted base positions p such
        that the digit pair ((i, p), (j, p+s)) matches the pattern.

        ``row_cols`` may contain stale columns; a column with no digits
        left on the pattern's rows is pruned here."""
        i, j, s, sign = _unpack_key(key)
        out: dict[int, np.ndarray] = {}
        ci = self.row_cols.get(i)
        cj = self.row_cols.get(j) if j != i else ci
        if not ci or not cj:
            return out
        cols = ci & cj if j != i else list(ci)
        for c in cols:
            store = self.cols[c]
            di_map = store.by_row.get(i)
            if not di_map:
                ci.discard(c)  # column no longer holds row i digits
                continue
            if i != j:
                dj_map = store.by_row.get(j)
                if not dj_map:
                    cj.discard(c)
                    continue
                # digits are +-1, so d_i * d_j == sign  <=>  d_j == sign * d_i
                dj_get = dj_map.get
                if len(di_map) == 1:
                    (p, d), = di_map.items()
                    ps = [p] if dj_get(p + s) == sign * d else []
                else:
                    ps = sorted(
                        p for p, d in di_map.items() if dj_get(p + s) == sign * d
                    )
            else:
                if len(di_map) < 2:
                    continue
                # chains like p, p+s, p+2s share digits: greedy disjoint match
                used: set[int] = set()
                ps = []
                dj_get = di_map.get
                for p in sorted(di_map):
                    if p in used or (p + s) in used:
                        continue
                    if dj_get(p + s) == sign * di_map[p]:
                        ps.append(p)
                        used.add(p)
                        used.add(p + s)
            if ps:
                out[c] = np.array(ps, dtype=np.int64)
        return out

    # ------------------------------------------------------------------
    # Main loop
    # ------------------------------------------------------------------
    def run(self) -> list[Term | None]:
        try:
            with trace.span("cse.select", engine=self.engine):
                if self.engine == "heap":
                    self._run_heap()
                else:
                    self._run_batch()
            with trace.span("cse.assemble", engine=self.engine):
                return self._assemble()
        finally:
            if self._arena_owned:
                self.stats.n_arena_reallocs = (
                    self.arena.n_reallocs - self._arena_reallocs0
                )
                # hand the workspace back for the next solve on this
                # thread; the stores' windows become reusable, so a CSE
                # must not be mutated after run() (solve_cmvm never does)
                self.arena.release()
                self._arena_owned = False
            self._emit_counters()

    def _emit_counters(self) -> None:
        """Fold this run's CSEStats into the process metrics registry
        (one dict update per solve — nowhere near the hot path)."""
        st = self.stats
        reg = get_registry()
        eng = self.engine
        reg.inc("cse_runs_total", 1, engine=eng)
        reg.inc("cse_patterns_implemented_total", st.n_patterns_implemented, engine=eng)
        reg.inc("cse_occurrences_replaced_total", st.n_occurrences_replaced, engine=eng)
        reg.inc("cse_compactions_total", st.n_compactions, engine=eng)
        reg.inc("cse_tier_reloads_total", st.n_tier_reloads, engine=eng)
        if st.n_arena_reallocs:
            reg.inc("cse_arena_reallocs_total", st.n_arena_reallocs, engine=eng)

    def _run_heap(self) -> None:
        """Exact lazy max-heap realisation of the selection rule."""
        counts = self.counts
        dormant = self._dormant
        heap = self.heap
        while heap:
            neg_pri, key = heapq.heappop(heap)
            if key in dormant:
                continue
            cnt = counts.get(key)
            if cnt < 2:
                continue
            cur = cnt * self._weight(key)
            if -neg_pri != cur:
                self.stats.n_stale_corrections += 1
                if -neg_pri > cur:
                    # stale-high: this entry may be the key's only cover
                    heapq.heappush(heap, (-cur, key))
                # stale-low: a fresher entry pushed by the count increase
                # already bounds the key from above — drop this one
                continue
            if self._implement(key):
                cnt = counts.get(key)
                if cnt >= 2:
                    heapq.heappush(heap, (-cnt * self._weight(key), key))
            else:
                dormant.add(key)

    def _run_batch(self) -> None:
        """Generation-stamped candidate-array realisation of the selection
        rule (shared by the batch and arena engines): zero heap
        operations on the common path."""
        counts = self.counts
        while True:
            an = self._an
            best = self._apri[:an].max() if an else -np.inf
            if self._rest is not None and best <= self._rest_bound:
                # a deferred key could tie or beat the active best
                self._reload_rest()
                continue
            if best <= 0.0:
                break
            idxs = np.nonzero(self._apri[:an] == best)[0]
            kk = self._akeys[idxs]
            stale = self._agen[idxs] != self._gen
            n_stale = int(stale.sum())
            if n_stale:
                self.stats.n_stale_corrections += n_stale
                if n_stale <= 4:
                    # scalar probes beat the vectorized machinery on the
                    # typical 1-2 entry correction (same arithmetic)
                    gen = self._gen
                    for q in idxs[stale].tolist():
                        kq = int(self._akeys[q])
                        cnt = counts.get(kq)
                        if cnt >= 2 and not self._is_dormant(kq):
                            self._apri[q] = cnt * self._awt[q]
                        else:
                            self._apri[q] = 0.0
                        self._agen[q] = gen
                else:
                    sk = kk[stale]
                    cnts = counts.get_batch(sk)
                    pri = np.where(cnts >= 2, cnts * self._awt[idxs[stale]], 0.0)
                    dorm = self._dormant_mask_of(sk)
                    if dorm is not None:
                        pri[dorm] = 0.0
                    self._apri[idxs[stale]] = pri
                    self._agen[idxs[stale]] = self._gen
            winners = kk[self._apri[idxs] == best]
            if winners.shape[0] == 0:
                continue  # every entry at `best` was stale-high
            key = int(winners.min())
            if self._implement(key):
                # eagerly re-score the winner's entries at its post-step
                # count: its cached best is now stale, and correcting it
                # here saves one full selection round per implementation.
                # (positions are re-scanned: the step's appends may have
                # compacted/reordered the active arrays)
                sel = np.flatnonzero(self._akeys[: self._an] == key)
                cnt = counts.get(key)
                pri = cnt * self._awt[sel] if cnt >= 2 else 0.0
                self._apri[sel] = pri
                self._agen[sel] = self._gen
            else:
                self._mark_dormant(key)
                # zero the key's cached entries so the running max moves on
                sel = self._akeys[: self._an] == key
                self._apri[: self._an][sel] = 0.0
            if self._an > 3 * _TIER and self.engine == "arena":
                # keep the running-max scan short: drop dead entries in
                # place (exactness-preserving whenever it runs)
                self._compact(0)

    def _implement(self, key: int) -> bool:
        i, j, s, sign = _unpack_key(key)
        occs = self._find_occurrences(key)
        d_i_depth = self.prog.rows[i].depth
        d_j_depth = self.prog.rows[j].depth
        u_depth = max(d_i_depth, d_j_depth) + 1
        # Delay-constraint filter, per column.  Replacing k occurrences
        # moves exactly k digits of row i and k of row j onto the new row
        # (depth u_depth), so the column's leaf-depth multiset after k
        # acceptances depends only on k: score the whole candidate batch
        # k = 1..n in one histogram sweep (min_tree_depth_hist_batch).
        accepted: dict[int, np.ndarray] = {}
        total = 0
        for c, ps in occs.items():
            budget = self.budgets[c]
            if budget is None:
                accepted[c] = ps
                total += ps.shape[0]
                continue
            store = self.cols[c]
            self._sync_meta()
            dep = self._meta_depth[store.rows[: store.n]]
            lv, cn = np.unique(dep, return_counts=True)
            extra = np.array([d_i_depth, d_j_depth, u_depth], dtype=np.int64)
            levels = np.union1d(lv, extra)
            base = np.zeros(levels.shape[0], dtype=np.int64)
            base[np.searchsorted(levels, lv)] = cn
            li = int(np.searchsorted(levels, d_i_depth))
            lj = int(np.searchsorted(levels, d_j_depth))
            lu = int(np.searchsorted(levels, u_depth))
            n_ps = ps.shape[0]
            ks = np.arange(1, n_ps + 1, dtype=np.int64)
            hists = np.broadcast_to(base, (n_ps, levels.shape[0])).copy()
            hists[:, li] -= ks
            hists[:, lj] -= ks  # li == lj when i == j: both ops apply
            hists[:, lu] += ks
            feas = min_tree_depth_hist_batch(levels, hists) <= budget
            n_keep = n_ps if bool(feas.all()) else int(feas.argmin())
            if n_keep < n_ps:
                # feasibility depends only on k, so every occurrence past
                # the first infeasible acceptance is rejected too
                self.stats.n_rejected_by_depth += n_ps - n_keep
            if n_keep:
                accepted[c] = ps[:n_keep]
                total += n_keep
        if total < 2:
            return False  # dormant until counts increase again
        u = self._impl_cache.get(key)
        if u is None:
            u = self.prog.add_op(i, j, max(0, -s), max(0, s), sign)
            self._impl_cache[key] = u
        self.stats.n_patterns_implemented += 1
        if self.engine == "arena":
            self._replace_occurrences_arena(u, i, j, s, accepted)
            return True
        # Replace occurrences column by column, collecting the removed and
        # added digit sets plus a view of each column's post-removal store;
        # every digit pair the step touches is then built block-structured
        # and counted in ONE _canon_pack + _apply_deltas call (_step_pairs).
        rem_sets: list[tuple] = []
        add_sets: list[tuple] = []
        snaps: list[tuple] = []
        for c, ps in accepted.items():
            store = self.cols[c]
            k = ps.shape[0]
            r_rows = np.empty(2 * k, dtype=np.int64)
            r_rows[:k] = i
            r_rows[k:] = j
            r_poss = np.concatenate([ps, ps + s])
            ds = [
                store.remove(r, p)
                for r, p in zip(r_rows.tolist(), r_poss.tolist())
            ]
            r_digs = np.array(ds, dtype=np.int64)
            # the live slices below stay valid without copying: from here
            # on this store only appends (slots < n_c are never disturbed,
            # and a capacity grow leaves the viewed buffer intact)
            n_c = store.n
            snaps.append((store.rows[:n_c], store.poss[:n_c], store.digs[:n_c]))
            rem_sets.append((r_rows, r_poss, r_digs))
            a_poss = ps + min(0, s)
            a_digs = r_digs[:k]
            # read-only broadcast view: gathers/repeats in _step_pairs copy
            a_rows = np.broadcast_to(np.int64(u), (k,))
            add_sets.append((a_rows, a_poss, a_digs))
            cols_u = self.row_cols.get(u)
            if cols_u is None:
                self.row_cols[u] = {c}
            else:
                cols_u.add(c)
            for p, d in zip(a_poss.tolist(), a_digs.tolist()):
                store.add(u, p, d)
            self.stats.n_occurrences_replaced += k
        res = _step_pairs(
            rem_sets + add_sets,
            snaps + snaps,
            [-1] * len(rem_sets) + [1] * len(add_sets),
        )
        if res is not None:
            a, b, signs = res
            packed = _canon_pack(a[0], a[1], a[2], b[0], b[1], b[2])
            self._apply_deltas(packed, signs)
        return True

    def _replace_occurrences_arena(self, u, i, j, s, accepted) -> None:
        """Fused replace + count-delta pass of the arena engine.

        Removes and adds digits through the arena-resident stores, then
        builds every pair key the step touches straight from the cached
        (token, digit) windows into reusable scratch — one pass replaces
        ``_step_pairs`` + ``_canon_pack`` + the sort/reduceat dedup of
        ``_apply_deltas``.  The pair multiset is identical to the batch
        engine's: each removed/added digit against its column's
        post-removal snapshot, plus the pairs inside each set.  The
        snapshot of a column is concatenated once and shared by that
        column's removed and added sets via per-set offsets."""
        ar = self.arena
        cols = self.cols
        row_cols = self.row_cols
        stats = self.stats
        ncols = len(accepted)
        n_occ = 0
        for ps in accepted.values():
            n_occ += ps.shape[0]
        na = 3 * n_occ  # A-side digits: 2 removed + 1 added per occurrence
        a_tok = ar.take("a_tok", na)
        a_dig = ar.take("a_dig", na)
        nsets = 2 * ncols
        set_m = ar.take("set_m", nsets)
        set_n = ar.take("set_n", nsets)
        set_off = ar.take("set_off", nsets)
        i_t = np.int64(i) << _TOK_BITS
        j_t = np.int64(j) << _TOK_BITS
        u_t = np.int64(u) << _TOK_BITS
        off0 = min(0, s)
        w = 0           # removed sets fill [0, 2*n_occ)
        wa = 2 * n_occ  # added sets fill [2*n_occ, 3*n_occ)
        si = 0
        boff = 0
        snaps: list[tuple[np.ndarray, np.ndarray]] = []
        i_ti = int(i_t)
        j_ti = int(j_t)
        u_ti = int(u_t)
        for c, ps in accepted.items():
            store = cols[c]
            k = ps.shape[0]
            pl = ps.tolist()
            if k <= 2:
                # scalar writes beat 1-2 element vector ops (same values)
                for t, p in enumerate(pl):
                    a_tok[w + t] = i_ti | p
                    a_tok[w + k + t] = j_ti | (p + s)
                    a_tok[wa + t] = u_ti | (p + off0)
            else:
                a_tok[w : w + k] = i_t | ps
                a_tok[w + k : w + 2 * k] = j_t | (ps + s)
                a_tok[wa : wa + k] = u_t | (ps + off0)
            rd = a_dig[w : w + 2 * k]
            rem = store.remove
            for t, p in enumerate(pl):
                d = rem(i, p)
                rd[t] = d
                a_dig[wa + t] = d
            for t, p in enumerate(pl):
                rd[k + t] = rem(j, p + s)
            n_c = store.n
            set_m[si] = 2 * k
            set_n[si] = n_c
            set_off[si] = boff
            set_m[ncols + si] = k
            set_n[ncols + si] = n_c
            set_off[ncols + si] = boff
            # live views stay valid without copying: from here on this
            # store only appends (and a window move freezes, never
            # mutates, the viewed buffer)
            snaps.append((store.toks[:n_c], store.digs[:n_c]))
            boff += n_c
            cols_u = row_cols.get(u)
            if cols_u is None:
                row_cols[u] = {c}
            else:
                cols_u.add(c)
            add = store.add
            for t, p in enumerate(pl):
                add(u, p + off0, int(rd[t]))
            stats.n_occurrences_replaced += k
            w += 2 * k
            wa += k
            si += 1
        # ---- pair-key build: A x snapshot cross products + intra-set ----
        b_tok = ar.take("b_tok", max(boff, 1))
        b_dig = ar.take("b_dig", max(boff, 1))
        o = 0
        for tk, dg in snaps:
            nn = tk.shape[0]
            b_tok[o : o + nn] = tk
            b_dig[o : o + nn] = dg
            o += nn
        m_t = set_m[:nsets]
        reps = np.repeat(set_n[:nsets], m_t)  # pairs per A element
        n_cross = int(reps.sum())
        # intra-set pairs: concatenate every set's offset upper-triangle
        # indices, then gather once (removed sets lead, so signs are two
        # contiguous fills)
        tri_ii: list[np.ndarray] = []
        tri_jj: list[np.ndarray] = []
        tri_n = 0
        rem_tri = 0
        off_a = 0
        for t in range(nsets):
            mm = int(set_m[t])
            if mm > 1:
                ii, jj = _triu(mm)
                tri_ii.append(ii + off_a)
                tri_jj.append(jj + off_a)
                tri_n += ii.shape[0]
                if t < ncols:
                    rem_tri = tri_n
            off_a += mm
        tot = n_cross + tri_n
        if tot == 0:
            return
        p_tA = ar.take("p_tA", tot)
        p_dA = ar.take("p_dA", tot)
        p_tB = ar.take("p_tB", tot)
        p_dB = ar.take("p_dB", tot)
        p_sg = ar.take("p_sg", tot)
        if n_cross:
            ends = np.cumsum(reps)
            off_elem = np.repeat(set_off[:nsets], m_t)  # B offset per element
            base = np.repeat(ends - reps - off_elem, reps)
            gidx = np.arange(n_cross, dtype=np.int64) - base
            p_tA[:n_cross] = np.repeat(a_tok[:na], reps)
            p_dA[:n_cross] = np.repeat(a_dig[:na], reps)
            np.take(b_tok, gidx, out=p_tB[:n_cross])
            np.take(b_dig, gidx, out=p_dB[:n_cross])
            # A elements are laid out removed-first, so pair signs are two
            # contiguous fills instead of a repeat chain
            rem_cross = int(reps[: 2 * n_occ].sum())
            p_sg[:rem_cross] = -1
            p_sg[rem_cross:n_cross] = 1
        if tri_n:
            ii = np.concatenate(tri_ii) if len(tri_ii) > 1 else tri_ii[0]
            jj = np.concatenate(tri_jj) if len(tri_jj) > 1 else tri_jj[0]
            np.take(a_tok, ii, out=p_tA[n_cross:tot])
            np.take(a_dig, ii, out=p_dA[n_cross:tot])
            np.take(a_tok, jj, out=p_tB[n_cross:tot])
            np.take(a_dig, jj, out=p_dB[n_cross:tot])
            p_sg[n_cross : n_cross + rem_tri] = -1
            p_sg[n_cross + rem_tri : tot] = 1
        keys = _pack_pair_keys(p_tA[:tot], p_dA[:tot], p_tB[:tot], p_dB[:tot])
        self._apply_deltas_arena(keys, p_sg[:tot])

    # ------------------------------------------------------------------
    # Final adder-tree assembly per column
    # ------------------------------------------------------------------
    def _combine(self, t1: Term, t2: Term) -> Term:
        if self.assembly_dedup:
            ck = (t1, t2) if (t1.row, t1.shift, t1.sign) <= (t2.row, t2.shift, t2.sign) else (t2, t1)
            hit = self._combine_cache.get(ck)
            if hit is not None:
                return hit
        if t1.sign == t2.sign:
            m = min(t1.shift, t2.shift)
            u = self.prog.add_op(t1.row, t2.row, t1.shift - m, t2.shift - m, +1)
            res = Term(t1.sign, u, m)
        else:
            pos, neg = (t1, t2) if t1.sign > 0 else (t2, t1)
            m = min(pos.shift, neg.shift)
            u = self.prog.add_op(pos.row, neg.row, pos.shift - m, neg.shift - m, -1)
            res = Term(1, u, m)
        self.stats.n_assembly_adders += 1
        if self.assembly_dedup:
            self._combine_cache[ck] = res
        return res

    def _assemble(self) -> list[Term | None]:
        outputs: list[Term | None] = []
        for store in self.cols:
            if not len(store):
                outputs.append(None)
                continue
            R, P, D = store.live()
            order = np.lexsort((P, R))  # (row, pos) lexicographic
            # merge two shallowest first: optimal max-depth (min-max Huffman)
            h: list[tuple[int, int, int, Term]] = []
            seq = 0
            for k in order.tolist():
                row, pos, d = int(R[k]), int(P[k]), int(D[k])
                t = Term(d, row, pos)
                h.append((self.prog.rows[row].depth, self.prog.rows[row].qint.width, seq, t))
                seq += 1
            heapq.heapify(h)
            while len(h) > 1:
                _, _, _, t1 = heapq.heappop(h)
                _, _, _, t2 = heapq.heappop(h)
                t = self._combine(t1, t2)
                heapq.heappush(h, (self.prog.rows[t.row].depth, self.prog.rows[t.row].qint.width, seq, t))
                seq += 1
            outputs.append(h[0][3])
        return outputs
