"""Plain PyTorch version of the counter-based draw: the port of what the
JAX package uses from ``jax.random`` (threefry2x32 over the flat index,
the uniform's mantissa trick, ``normal`` as sqrt(2) erf_inv(u) with
XLA's float32 ``ErfInv32``, ``gumbel`` as -log(-log(u)) in float32 or
bfloat16), and of the serve engine's categorical pick,
``argmax(logits / T + gumbel)`` (:func:`gumbel_pick_ref`).

The 32-bit words are held in int64 tensors and every sum is masked to
32 bits.  The tests use it against ``jax.random``, and so does every CPU
(or meta) tensor; on the card it is what the kernel is held against.
Draws go in passes of at most ``CHUNK`` elements, so no temporary holds
more than that, whatever the size of the draw; many small draws (an
initialiser's leaves and period slices) share a pass, so they cost one
pass's operations and not each its own.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch

MASK = 0xFFFFFFFF
CHUNK = 1 << 24  # elements per chunk of a draw: its temporaries' size
ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))
KS_PARITY = 0x1BD11BDA
KINDS = ("bits", "uniform", "normal", "gumbel")

# XLA's ErfInv32 (M. Giles, "Approximating the erfinv function"): the
# polynomial in w - 2.5 below w = 5, in sqrt(w) - 3 above
ERFINV_W_LT_5 = (2.81022636e-08, 3.43273939e-07, -3.5233877e-06, -4.39150654e-06,
                 0.00021858087, -0.00125372503, -0.00417768164, 0.246640727, 1.50140941)
ERFINV_W_GE_5 = (-0.000200214257, 0.000100950558, 0.00134934322, -0.00367342844,
                 0.00573950773, -0.0076224613, 0.00943887047, 1.00167406, 2.83297682)
SQRT2 = float(np.float32(np.sqrt(2.0)))
# normal's uniform runs from the float32 after -1 towards 0, up to 1
NORMAL_LO = float(np.nextafter(np.float32(-1.0), np.float32(0.0)))
# gumbel's uniform runs from the smallest normal float (float32's and
# bfloat16's alike) up to 1
TINY = float(np.finfo(np.float32).tiny)


def f32(x: float) -> float:
    """``x`` rounded to float32, as JAX rounds a weakly typed Python float."""
    return float(np.float32(x))


def _rotl(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) | (x >> (32 - r))) & MASK


def threefry2x32(k0: int, k1: int, x0: torch.Tensor, x1: torch.Tensor):
    """Threefry-2x32, 20 rounds, of the word pairs (x0, x1) under the key
    (k0, k1): int64 tensors of values in [0, 2^32) in and out."""
    ks = (k0, k1, k0 ^ k1 ^ KS_PARITY)
    x0 = (x0 + ks[0]) & MASK
    x1 = (x1 + ks[1]) & MASK
    for i in range(5):
        for r in ROTATIONS[i % 2]:
            x0 = (x0 + x1) & MASK
            x1 = _rotl(x1, r) ^ x0
        x0 = (x0 + ks[(i + 1) % 3]) & MASK
        x1 = (x1 + (ks[(i + 2) % 3] + i + 1)) & MASK
    return x0, x1


def fma32(a: torch.Tensor, b, c) -> torch.Tensor:
    """a * b + c in float32 with one rounding, as XLA's CPU backend fuses
    a product and a sum (and as the kernel's ``fmaf`` does).  The product
    of two floats is exact in float64; the sum rounds there and again to
    float32, which differs from one rounding only where the first lands
    on a float32 halfway point."""
    return (a.double() * b + c).float()


def uniform_from_bits(bits: torch.Tensor, minval: float, maxval: float) -> torch.Tensor:
    """float32 uniforms in [minval, maxval) from 32 random bits, as
    ``jax.random``'s ``_uniform``: the top 23 bits as the mantissa of a
    float in [1, 2), minus 1, scaled and shifted (one fused step), and
    clamped below."""
    f = ((bits >> 9) | 0x3F800000).to(torch.int32).view(torch.float32) - 1.0
    lo = f32(minval)
    return torch.clamp_min(fma32(f, f32(f32(maxval) - lo), lo), lo)


def sqrt32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 square root of ``x`` (float32, >= 0),
    as IEEE's ``sqrtf`` (the card's, XLA's).  ``torch.sqrt`` on the CPU
    was seen to return a value some 4e-4 off on whole threads' chunks of
    a tensor, now and then, at a process's first draws; so: a float64
    estimate, two Newton steps, and the float32 neighbour whose halfway
    points bracket ``x`` (their squares are exact in float64)."""
    xd = x.double()
    s = torch.sqrt(xd)
    for _ in range(2):
        s = torch.where(xd > 0, 0.5 * (s + xd / s), s)
    c = s.float()
    up, down = torch.nextafter(c, c + 1.0), torch.nextafter(c, c - 1.0)
    c = torch.where(((c.double() + up.double()) / 2) ** 2 < xd, up, c)
    return torch.where((c > 0) & (((c.double() + down.double()) / 2) ** 2 > xd), down, c)


def log32(x: torch.Tensor) -> torch.Tensor:
    """The correctly rounded float32 ``log`` of float32 ``x``, through
    float64.  ``torch.log`` of float32 on the CPU was seen to return values
    some 1e-4 off in one of a dozen fresh processes (as ``torch.sqrt``,
    :func:`sqrt32`); XLA's and the card's ``logf`` are within one ulp of
    this."""
    return torch.log(x.double()).float()


def gumbel_from_bits(bits: torch.Tensor, dtype: torch.dtype) -> torch.Tensor:
    """Gumbel noise from 32 random bits, as ``jax.random.gumbel`` (mode
    "low", ``-log(-log(u))``, u uniform on [tiny, 1)) in ``dtype``.

    float32: u from the top 23 bits, as ``uniform``.  bfloat16: JAX draws
    8 bits (the low byte) and keeps 7 as the mantissa, so u takes 128
    values; each ``log`` runs in float32 and rounds to bfloat16, as XLA
    computes a bfloat16 op."""
    if dtype == torch.bfloat16:
        f = ((bits & 0xFF) >> 1).float() * (1.0 / 128)  # exact: the bf16 in [1, 2) less 1
        u = torch.where(f > 0, f, TINY)
        inner = log32(u).bfloat16().float()
        return -log32(-inner).bfloat16()
    if dtype != torch.float32:
        raise TypeError(f"gumbel draws float32 or bfloat16, got {dtype}")
    return -log32(-log32(uniform_from_bits(bits, TINY, 1.0)))


def erf_inv32(x: torch.Tensor) -> torch.Tensor:
    """XLA's float32 ``ErfInv32``; each step of the polynomial a fused
    multiply-add."""
    w = -torch.log1p(-x * x)
    lt = w < 5.0
    w = torch.where(lt, w - 2.5, sqrt32(w) - 3.0).double()
    p = torch.where(lt, ERFINV_W_LT_5[0], ERFINV_W_GE_5[0])
    for a, b in zip(ERFINV_W_LT_5[1:], ERFINV_W_GE_5[1:]):
        p = fma32(p, w, torch.where(lt, a, b).double())
    return torch.where(x.abs() == 1.0, x * math.inf, p * x)


def values_at(k0, k1, index: torch.Tensor, kind: str, scale=1.0, minval: float = 0.0,
              maxval: float = 1.0, dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """The draw at the global flat indices ``index`` (int64): the 32 bits
    (int64), the uniform or the normal times ``scale`` (float32), or the
    Gumbel noise in ``dtype``.  The key words (ints, or int64 tensors of
    ``index``'s shape) and ``scale`` (a float, or a float32 tensor of that
    shape) may differ element by element."""
    y0, y1 = threefry2x32(k0, k1, index >> 32, index & MASK)
    bits = y0 ^ y1
    if kind == "bits":
        return bits
    if kind == "gumbel":
        return gumbel_from_bits(bits, dtype)
    if kind == "uniform":
        return uniform_from_bits(bits, minval, maxval)
    v = erf_inv32(uniform_from_bits(bits, NORMAL_LO, 1.0)) * SQRT2
    return v * (scale if isinstance(scale, torch.Tensor) else f32(scale))


def window_plan(shape, offset, block) -> tuple[int, list[tuple[int, int]]]:
    """(base, dims) of a block of ``block``'s shape at ``offset`` in an
    array of ``shape``: the block's element at local flat index i lies at
    global flat index base + sum(l_m * s_m), where i's digits l_m run over
    the merged dims (extent, global stride) ``dims``, outermost first.
    Dims of extent 1 are dropped, and a dim is merged into the one outside
    it where the two are contiguous in the global array."""
    shape, offset, block = tuple(shape), tuple(offset), tuple(block)
    if not len(shape) == len(offset) == len(block):
        raise ValueError(f"a window of {block} at {offset} in {shape}: ranks differ")
    for n, o, b in zip(shape, offset, block):
        if o < 0 or b < 0 or o + b > n:
            raise ValueError(f"a window of {block} at {offset} lies outside {shape}")
    strides, s = [], 1
    for n in reversed(shape):
        strides.append(s)
        s *= n
    strides.reverse()
    base = sum(o * st for o, st in zip(offset, strides))
    dims: list[tuple[int, int]] = []
    for b, st in zip(block, strides):
        if b == 1:
            continue
        if dims and dims[-1][1] == b * st:
            dims[-1] = (dims[-1][0] * b, st)
        else:
            dims.append((b, st))
    return base, dims


def global_index(local: torch.Tensor, base: int, dims) -> torch.Tensor:
    """Global flat indices (int64) of the local flat indices ``local``
    under a :func:`window_plan`."""
    if not dims:
        return torch.full_like(local, base)
    g, rem = torch.full_like(local, base), local
    for extent, stride in reversed(dims[1:]):
        g += (rem % extent) * stride
        rem = rem // extent
    return g + rem * dims[0][1]


class Draw(NamedTuple):
    """One draw: fill the contiguous ``out``, the block at ``offset`` of an
    array of ``shape``, with key (k0, k1)'s values there (normals times
    ``scale``)."""

    out: torch.Tensor
    k0: int
    k1: int
    shape: tuple
    offset: tuple
    scale: float = 1.0


def draw_many_ref(draws, kind: str, minval: float = 0.0, maxval: float = 1.0) -> None:
    """Fill every draw's ``out``: bits into int64, uniforms and normals
    into a floating dtype (cast from float32), Gumbel noise in its
    ``out``'s dtype (float32 or bfloat16, one for all the draws).  The
    draws are cut into pieces of at most ``CHUNK`` elements and taken
    together in passes of at most ``CHUNK`` elements, each piece its own
    key and scale."""
    if kind not in KINDS:
        raise ValueError(f"unknown draw {kind!r}; one of {KINDS}")
    draws = list(draws)
    if kind == "gumbel" and len({d.out.dtype for d in draws}) > 1:
        raise ValueError("gumbel draws in one call share one dtype")
    pieces, size = [], 0
    for d in draws:
        base, dims = window_plan(d.shape, d.offset, d.out.shape)
        flat = d.out.view(-1)
        for start in range(0, flat.numel(), CHUNK):
            n = min(flat.numel() - start, CHUNK)
            if size + n > CHUNK:
                _fill(pieces, kind, minval, maxval)
                pieces, size = [], 0
            pieces.append((flat[start:start + n], d, base, dims, start))
            size += n
    if pieces:
        _fill(pieces, kind, minval, maxval)


def _fill(pieces, kind: str, minval: float, maxval: float) -> None:
    """One pass over ``pieces`` (flat slice, draw, base, dims, start)."""
    dev = pieces[0][0].device

    def per_piece(value, dtype):  # one value a piece, as a tensor over the pass
        if len(pieces) == 1:
            return value(pieces[0][1])
        return torch.cat([torch.full((p[0].numel(),), value(p[1]), dtype=dtype, device=dev)
                          for p in pieces])

    index = torch.cat([global_index(torch.arange(start, start + part.numel(), device=dev),
                                    base, dims) for part, _, base, dims, start in pieces])
    values = values_at(per_piece(lambda d: d.k0, torch.int64),
                       per_piece(lambda d: d.k1, torch.int64), index, kind,
                       per_piece(lambda d: f32(d.scale), torch.float32), minval, maxval,
                       pieces[0][0].dtype)
    at = 0
    for part, *_ in pieces:
        part.copy_(values[at:at + part.numel()])
        at += part.numel()


def draw_ref(out: torch.Tensor, k0: int, k1: int, shape, offset, kind: str,
             scale: float = 1.0, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Fill the contiguous ``out`` (the block at ``offset`` of an array of
    ``shape``) with the draw of key (k0, k1) there (:func:`draw_many_ref`
    of one draw); returns ``out``."""
    draw_many_ref([Draw(out, k0, k1, tuple(shape), tuple(offset), scale)], kind, minval, maxval)
    return out


def weak_scalar(x: float, dtype: torch.dtype) -> float:
    """A Python float as JAX takes it beside an array of ``dtype``: a weak
    type, rounded to that dtype (float32 or bfloat16)."""
    return float(torch.tensor(float(x), dtype=dtype).float())


def pick_scores_ref(logits: torch.Tensor, k0: int, k1: int, temperature: float = 1.0,
                    first_row: int = 0) -> torch.Tensor:
    """``logits / T + gumbel(key, [B, V], dtype)`` of the rows ``logits``
    [n, V] (float32 or bfloat16), the rows from ``first_row`` on of the
    whole [B, V] draw, with the JAX engine's roundings: T rounded to the
    logits' dtype (a weak type), the quotient and the sum each rounded to
    it, the noise of element (b, v) drawn at flat index b * V + v.  In
    the logits' dtype."""
    dtype = logits.dtype
    n, v = logits.shape
    index = torch.arange(first_row * v, (first_row + n) * v, dtype=torch.int64,
                         device=logits.device)
    noise = values_at(k0, k1, index, "gumbel", dtype=dtype).view(n, v)
    scaled = (logits.float() / weak_scalar(temperature, dtype)).to(dtype)
    return (scaled.float() + noise.float()).to(dtype)


def gumbel_pick_ref(logits: torch.Tensor, k0: int, k1: int,
                    temperature: float = 1.0) -> torch.Tensor:
    """The plain version of the categorical pick: for each row of
    ``logits`` [B, V] (float32 or bfloat16), the first index of the maximum
    of :func:`pick_scores_ref`, as the JAX engine's
    ``jax.random.categorical(key, logits / T)``.  int64 [B]; the rows go
    in passes of at most ``CHUNK`` elements."""
    if logits.dim() != 2:
        raise ValueError(f"the pick takes logits [B, V], got {tuple(logits.shape)}")
    if logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the pick takes float32 or bfloat16 logits, got {logits.dtype}")
    b, v = logits.shape
    out = torch.empty(b, dtype=torch.int64, device=logits.device)
    rows = max(1, CHUNK // max(v, 1))
    for r0 in range(0, b, rows):
        out[r0:r0 + rows] = pick_scores_ref(logits[r0:r0 + rows], k0, k1, temperature,
                                            r0).argmax(-1)
    return out
