"""The operand layout of the W8A8 matmul's TMA/wgmma kernel, on the host.

``csrc/quant_matmul.cu`` mirrors these constants and index maps; the CPU
tests walk them in numpy (``emulate_tile``) against ``x @ w``, because the
kernel itself runs only on the card.

For 8-bit operands ``wgmma`` reads A and B K-major only, and w [K, N] is
N-major.  The kernel therefore computes ``out^T = w^T x^T`` one tile at a
time: w is the A operand (its rows are the tile's n), built in registers
from the TMA-loaded w tile by 4 x 4 byte transposes (``a_fragment``), and
x is the B operand (its columns are the tile's m), read by the tensor
cores from shared memory through a 128-byte-swizzled K-major descriptor
(``b_operand``).  The accumulator fragment is then n by m; the map of the
A fragment's rows to n (``n_of``) gives each thread four consecutive n of
one m, so the epilogue stores 16-byte vectors of out [M, N] directly.

Tile: BLOCK_M rows of x by BLOCK_N columns of w, BLOCK_K bytes of K per
pipeline stage.  Two consumer warpgroups each own 128 of the tile's n as
two 64-row slabs (two ``wgmma.m64n128k32`` per 32 of K, 2 x 64 int32
accumulators per thread); one producer warp issues the TMA loads.
"""

from __future__ import annotations

import numpy as np

BLOCK_M = 128  # rows of x per tile: the wgmma N
BLOCK_N = 256  # columns of w per tile: CONSUMERS x SLABS x 64 wgmma rows
BLOCK_K = 128  # bytes of K per stage: one 128-byte swizzle row
STAGES = 4  # the shared-memory ring: 4 x 48 KB
CONSUMERS = 2  # warpgroups that issue wgmma
SLABS = 2  # 64-row wgmma slabs per consumer warpgroup
WGMMA_K = 32  # bytes of K per wgmma
W_BOX = 128  # n bytes per TMA box of w (the 128-byte swizzle's limit)
X_STAGE_BYTES = BLOCK_M * BLOCK_K
W_STAGE_BYTES = BLOCK_N * BLOCK_K
SBO = 1024  # descriptor stride between 8-row groups: 8 rows x 128 bytes


def swizzle128(offset):
    """The 128-byte swizzle of TMA and of the wgmma descriptor: the 16-byte
    chunk (bits 4-6) of a byte offset XOR its row within the 1,024-byte
    atom (bits 7-9).  Offsets are relative to a 1,024-byte-aligned buffer."""
    offset = np.asarray(offset)
    return offset ^ (((offset >> 7) & 7) << 4)


def tma_box(tile: np.ndarray) -> np.ndarray:
    """The shared-memory bytes a TMA box load writes for ``tile`` [rows,
    128] (int8) with the 128-byte swizzle."""
    rows, width = tile.shape
    assert width == 128
    smem = np.zeros(rows * 128, np.int8)
    offs = np.arange(rows)[:, None] * 128 + np.arange(128)[None, :]
    smem[swizzle128(offs)] = tile
    return smem


def n_of(consumer, warp, g, slab, half):
    """The tile column n (of w, of out) that row ``16 warp + g + 8 half`` of
    a consumer's slab holds.  Thread (warp, g) owns the four n = nl .. nl + 3,
    nl = 128 consumer + 32 warp + 4 g."""
    return 128 * consumer + 32 * warp + 4 * g + 2 * slab + half


def a_reg_coords(warp, lane, reg, byte):
    """(row of the 64-row slab, k of the 32) that byte ``byte`` of A register
    ``reg`` (0..3) of thread ``lane`` in warp ``warp`` holds: the
    register-A fragment of ``wgmma .m64nNk32`` for 8-bit types."""
    g, t = lane // 4, lane % 4
    return 16 * warp + g + 8 * (reg & 1), 16 * (reg >> 1) + 4 * t + byte


def d_coords(warp, lane, reg):
    """(row, column) of the 64 x N accumulator that int32 register ``reg``
    of thread ``lane`` in warp ``warp`` holds."""
    g, t = lane // 4, lane % 4
    return 16 * warp + g + 8 * ((reg >> 1) & 1), 8 * (reg >> 2) + 2 * t + (reg & 1)


def _byte_perm(x: int, y: int, selector: int) -> int:
    """CUDA's ``__byte_perm``: byte i of the result is byte (selector >> 4 i)
    & 7 of the eight bytes of x (0..3) and y (4..7)."""
    pool = [(x >> (8 * i)) & 0xFF for i in range(4)] + [(y >> (8 * i)) & 0xFF for i in range(4)]
    return sum(pool[(selector >> (4 * i)) & 7] << (8 * i) for i in range(4))


def load_rows(t: int) -> list[int]:
    """The row (0..3, within a 4-row k group) of the thread's i-th shared
    load: threads t = 2, 3 start two rows on, so the four rows a warp
    instruction reads (4 t + row) fall in four different pairs of swizzle
    phases and the 32 words hit 32 banks."""
    return [(i + 2 * (t >> 1)) & 3 for i in range(4)]


def transpose_loaded(words: list[int], t: int) -> list[int]:
    """Column j (n) of the 4 x 4 byte block whose loaded words (in load
    order, rows ``load_rows(t)``) are ``words``: 4 bytes of k, lowest
    first.  The kernel's four ``__byte_perm`` pairs; the rotation of the
    rows for t >= 2 is undone by the second pair's selectors alone."""
    rot = t >> 1
    p0 = _byte_perm(words[0], words[1], 0x5140)  # rows l0, l1 interleaved: bytes 0, 1
    p1 = _byte_perm(words[0], words[1], 0x7362)  # bytes 2, 3
    p2 = _byte_perm(words[2], words[3], 0x5140)
    p3 = _byte_perm(words[2], words[3], 0x7362)
    lo, hi = (0x1054, 0x3276) if rot else (0x5410, 0x7632)
    return [_byte_perm(p0, p2, lo), _byte_perm(p0, p2, hi),
            _byte_perm(p1, p3, lo), _byte_perm(p1, p3, hi)]


def a_fragment(w_smem: np.ndarray, consumer: int, warp: int, lane: int, kk: int) -> np.ndarray:
    """Thread (consumer, warp, lane)'s A registers for the kk-th 32 bytes of
    K of a stage: [SLABS, 4 registers, 4 bytes].  ``w_smem`` is the stage's
    w tile as its TMA boxes wrote it: BLOCK_N / W_BOX boxes of [BLOCK_K rows
    (k)][128 bytes (n)], each 128-byte swizzled, one after the other.

    For k part p (0, 1) the thread reads the four 32-bit words at rows
    k = 32 kk + 16 p + 4 t + load_rows(t)[i], bytes cb .. cb + 3 of box
    ``consumer`` (cb = 32 warp + 4 g), and transposes them: column j of the
    result is the register (half j % 2, part p) of slab j // 2."""
    g, t = lane // 4, lane % 4
    box = w_smem[consumer * W_BOX * BLOCK_K:(consumer + 1) * W_BOX * BLOCK_K]
    cb = 32 * warp + 4 * g
    regs = np.zeros((SLABS, 4, 4), np.int8)
    for p in range(2):
        words = []
        for row in load_rows(t):
            r = WGMMA_K * kk + 16 * p + 4 * t + row
            word = box[swizzle128(r * 128 + cb + np.arange(4))].view(np.uint8).astype(np.int64)
            words.append(int(sum(int(b) << (8 * i) for i, b in enumerate(word))))
        for j, col in enumerate(transpose_loaded(words, t)):
            regs[j // 2, 2 * p + j % 2] = np.array([(col >> (8 * i)) & 0xFF for i in range(4)],
                                                   np.uint8).view(np.int8)
    return regs


def bank_wavefronts(kk: int = 0, p: int = 0) -> int:
    """The most shared-memory wavefronts any A-fragment load instruction of
    a warp needs (1 = conflict-free): 32 threads, 4-byte words, 32 banks."""
    worst = 1
    for warp in range(4):
        for i in range(4):
            banks: dict[int, set[int]] = {}
            for lane in range(32):
                g, t = lane // 4, lane % 4
                r = WGMMA_K * kk + 16 * p + 4 * t + load_rows(t)[i]
                off = int(swizzle128(r * 128 + 32 * warp + 4 * g))
                banks.setdefault((off // 4) % 32, set()).add(off // 4)
            worst = max(worst, max(len(v) for v in banks.values()))
    return worst


def b_operand(x_smem: np.ndarray, kk: int) -> np.ndarray:
    """B [32 (k), BLOCK_M (m)] as ``wgmma`` reads it through the descriptor
    (start = stage base + 32 kk, SBO = 1,024, 128-byte swizzle, K-major):
    column m's byte k sits at start + (m // 8) SBO + (m % 8) 128 + k, then
    swizzled."""
    m = np.arange(BLOCK_M)[None, :]
    k = np.arange(WGMMA_K)[:, None]
    addr = WGMMA_K * kk + (m // 8) * SBO + (m % 8) * 128 + k
    return x_smem[swizzle128(addr)]


def emulate_tile(x: np.ndarray, w: np.ndarray) -> np.ndarray:
    """One output tile, walked as the kernel walks it: x int8 [BLOCK_M, K],
    w int8 [K, BLOCK_N] with K a multiple of BLOCK_K; returns the exact
    int64 [BLOCK_M, BLOCK_N] that the epilogue stores, placed by each
    thread's accumulator registers."""
    k_total = x.shape[1]
    assert x.shape[0] == BLOCK_M and w.shape == (k_total, BLOCK_N)
    assert k_total % BLOCK_K == 0
    acc = np.zeros((CONSUMERS, SLABS, 64, BLOCK_M), np.int64)  # per slab: n rows x m
    for k0 in range(0, k_total, BLOCK_K):
        x_smem = tma_box(x[:, k0:k0 + BLOCK_K])  # box (BLOCK_K, BLOCK_M) at (k0, m0)
        w_smem = np.concatenate([tma_box(w[k0:k0 + BLOCK_K, c0:c0 + W_BOX])
                                 for c0 in range(0, BLOCK_N, W_BOX)])
        for kk in range(BLOCK_K // WGMMA_K):
            bmat = b_operand(x_smem, kk).astype(np.int64)
            for c in range(CONSUMERS):
                amat = np.zeros((SLABS, 64, WGMMA_K), np.int64)
                for warp in range(4):
                    for lane in range(32):
                        regs = a_fragment(w_smem, c, warp, lane, kk)
                        for reg in range(4):
                            for byte in range(4):
                                row, k = a_reg_coords(warp, lane, reg, byte)
                                amat[:, row, k] = regs[:, reg, byte]
                acc[c] += amat @ bmat
    out = np.full((BLOCK_M, BLOCK_N), np.iinfo(np.int64).min, np.int64)
    for c in range(CONSUMERS):
        for warp in range(4):
            for lane in range(32):
                g = lane // 4
                for s in range(SLABS):
                    for reg in range(BLOCK_M // 2):
                        row, m = d_coords(warp, lane, reg)
                        half = (reg >> 1) & 1
                        assert row == 16 * warp + g + 8 * half
                        out[m, n_of(c, warp, g, s, half)] = acc[c, s, row, m]
    return out
