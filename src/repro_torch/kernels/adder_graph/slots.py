"""Host-side plans of the Hopper adder-graph kernel: where each row's
values live in shared memory, and how a call is cut into blocks.

The shared-memory entry point of ``csrc/adder_graph.cu`` keeps a tile of
samples' values in shared memory.  A row does not need its own place for
the whole program: it is live from the level that writes it to the
level that last reads it (to the end if an output reads it), and after
that its slot can take a row written later.  :func:`plan_slots` assigns
every row such a slot.  The plan is derived data: it is computed from
the tables and kept beside their device copies, and never enters the
tables' fields or their digest.

:func:`launch_plan` picks the entry point (by the size rule alone: one
sample's slots fit a block's shared memory or not), the samples per block
and the threads per block.
"""

from __future__ import annotations

import heapq
from typing import NamedTuple

import numpy as np

SMEM_BLOCK_MAX = 232_448  # bytes of shared memory a Hopper block may use (opt-in above 48 KB)
SMEM_SM = 233_472  # bytes of shared memory on one Hopper SM
MAX_TILE = 32  # samples per block
MAX_THREADS = 512  # the kernels' __launch_bounds__
GLOBAL_THREADS = 256  # the global-scratch entry point's block
MIN_BLOCKS_PER_SM = 2  # grow the tile only while the grid keeps this many blocks per SM
H100_SMS = 132


class SlotPlan(NamedTuple):
    """Rows mapped onto reused value slots.

    n_slots : slots one sample needs (at least 1).
    ops     : int32 [n_ops, 4], one 16-byte instruction per op:
              (dst slot, a slot, b slot, sh_a | sh_b << 8 | sign << 16), the
              shifts clamped to 32 (a shift of 32 or more gives 0 either way)
              and the sign as a signed 16-bit field.
    outs    : int32 [n_out, 4], (slot, shift, sign, mask) as in the tables.
    Input i sits in slot i.
    """

    n_slots: int
    ops: np.ndarray
    outs: np.ndarray


def _write_levels(tables) -> np.ndarray:
    """The level that writes each row: -1 for the inputs (staged before
    level 0)."""
    write = np.full(tables.n_inputs + tables.n_ops, -1, np.int64)
    for k, (lo, hi) in enumerate(tables.level_bounds):
        write[tables.n_inputs + lo:tables.n_inputs + hi] = k
    return write


def _last_levels(tables, write: np.ndarray) -> np.ndarray:
    """The last level at which each row is needed: its last read, the end
    (``n_levels``) if an unmasked output reads it, its own write level if
    nothing reads it."""
    last = write.copy()
    for k, (lo, hi) in enumerate(tables.level_bounds):
        np.maximum.at(last, tables.instr[lo:hi, 0], k)
        np.maximum.at(last, tables.instr[lo:hi, 1], k)
    live_outs = tables.outs[tables.outs[:, 3] != 0, 0]
    last[live_outs] = len(tables.level_bounds)
    return last


def plan_slots(tables) -> SlotPlan:
    """Assign every row of ``tables`` (an ``AdderGraphTables``) a slot.

    Inputs take slots 0 .. n_in-1, then each level's rows take the lowest
    free slots.  A slot is freed after the level of its row's last use and
    given only to a row written at a later level, so no op writes a slot
    that an op of its own level reads.  Taking slots in order of the
    write level, the greedy plan uses exactly the peak number of rows live
    at one level."""
    n_in = tables.n_inputs
    write = _write_levels(tables)
    last = _last_levels(tables, write)
    freed_after: dict[int, list[int]] = {}
    for row, k in enumerate(last.tolist()):
        freed_after.setdefault(k, []).append(row)

    slot = np.empty(n_in + tables.n_ops, np.int64)
    slot[:n_in] = np.arange(n_in)
    n_slots = n_in
    free: list[int] = []
    for k, (lo, hi) in enumerate(tables.level_bounds):
        for row in freed_after.get(k - 1, ()):
            heapq.heappush(free, int(slot[row]))
        for row in range(n_in + lo, n_in + hi):
            if free:
                slot[row] = heapq.heappop(free)
            else:
                slot[row] = n_slots
                n_slots += 1

    instr = tables.instr.astype(np.int64)
    sign = instr[:, 4]
    if np.any((sign < -(1 << 15)) | (sign >= 1 << 15)):
        raise ValueError("an op's sign does not fit the instruction's 16-bit field")
    shifts = np.minimum(instr[:, 2], 32) | np.minimum(instr[:, 3], 32) << 8
    word = (shifts | (sign & 0xFFFF) << 16).astype(np.uint32).view(np.int32)
    ops = np.stack([
        slot[n_in:].astype(np.int32), slot[instr[:, 0]].astype(np.int32),
        slot[instr[:, 1]].astype(np.int32), word,
    ], axis=1).reshape(-1, 4)
    outs = tables.outs.copy()
    if len(outs):
        outs[:, 0] = np.where(outs[:, 3] != 0, slot[outs[:, 0]], 0)
    return SlotPlan(max(n_slots, 1), np.ascontiguousarray(ops, np.int32),
                    np.ascontiguousarray(outs, np.int32))


class LaunchPlan(NamedTuple):
    """How one call of the kernel is launched."""

    entry: str  # "shared" (values in shared memory) or "global" (a global scratch)
    tile: int  # samples per block (a power of two)
    threads: int  # threads per block
    smem_bytes: int  # dynamic shared memory per block
    blocks: int


def _pow2_ceil(n: int) -> int:
    return 1 << max(n - 1, 0).bit_length()


def launch_plan(n_slots: int, n_ops: int, n_levels: int, batch: int,
                n_sms: int = H100_SMS) -> LaunchPlan:
    """The launch of a table with ``n_slots`` slots, ``n_ops`` ops in
    ``n_levels`` levels, at ``batch`` samples on a card with ``n_sms`` SMs.

    Where one sample's slots exceed a block's shared memory, the
    global-scratch entry point takes the call, with up to 32 samples per
    block.  Otherwise the tile starts at one sample and doubles while the
    grid keeps at least two blocks per SM and two blocks' values fit one
    SM; the threads cover a level of average width for the whole tile
    (four samples per thread where the tile allows), 32 to 512."""
    batch = max(batch, 1)
    if 4 * n_slots > SMEM_BLOCK_MAX:
        tile = min(MAX_TILE, _pow2_ceil(batch))
        return LaunchPlan("global", tile, GLOBAL_THREADS, 0, -(-batch // tile))
    tile = 1
    while (tile < MAX_TILE and -(-batch // (2 * tile)) >= MIN_BLOCKS_PER_SM * n_sms
           and 2 * (2 * tile * 4 * n_slots) <= SMEM_SM):
        tile *= 2
    width = -(-n_ops // max(n_levels, 1))  # ops of an average level
    pairs = width * tile // min(4, tile)
    threads = min(MAX_THREADS, max(32, -(-pairs // 32) * 32))
    return LaunchPlan("shared", tile, threads, 4 * n_slots * tile, -(-batch // tile))
