"""The part of ``jax.random`` that the JAX package uses, with the same
numbers from the same keys: ``PRNGKey``, ``split``, ``bits``,
``uniform``, ``normal``, ``randint``, ``gumbel`` and ``categorical``.

A key is JAX's raw threefry key: two 32-bit words, held on the host as
an int64 tensor of shape [2] (or [n, 2] for :func:`split`'s keys).  A
draw hashes each element's global flat index (hi and lo words) under the
key with threefry2x32, as JAX does under ``jax_threefry_partitionable``
(its default since 0.5), so an element's value depends only on the key
and its index.  Every draw therefore takes an index window: the array's
global ``shape``, and the ``offset`` and ``block`` shape of the part
drawn.  A rank of a mesh, or a slice of a period stack, draws exactly its
elements of the larger array, with the values the whole draw has there.

The draws run on the card (the hand-written kernel,
``kernels/prng/csrc/threefry.cu``) unless ``device="cpu"`` is asked for
(the plain version, ``kernels/prng/ref.py``); ``categorical`` runs where
its logits lie (on the card the pick kernel, ``csrc/gumbel_pick.cu``).
``bits``, ``uniform`` and ``randint`` equal ``jax.random``'s bit for
bit, and so does ``gumbel`` in bfloat16; ``normal`` is XLA's float32
``ErfInv32`` of the uniform times sqrt(2), within a few float32 ulp of
``jax.random.normal`` (the two ``log1p`` differ), and float32 ``gumbel``
is within an ulp of each ``log`` (XLA's and the card's ``logf`` are not
correctly rounded).
"""

from __future__ import annotations

from collections.abc import Sequence

import numpy as np
import torch

from ._device import resolve_device
from .kernels.prng import ref
from .kernels.prng.ops import draw, draw_many, gumbel_pick

__all__ = ["PRNGKey", "bits", "categorical", "gumbel", "key_words", "normal", "normal_",
           "normal_many", "randint", "split", "uniform"]

INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


def PRNGKey(seed: int) -> torch.Tensor:  # noqa: N802 -- the reference's name
    """The raw key of ``seed``: [seed >> 32, seed & 0xffffffff], as
    ``jax.random.PRNGKey``.  A negative seed is taken as JAX takes an
    int32 one (high word 0); seeds run from -2^31 to 2^64 - 1."""
    seed = int(seed)
    if not -(2**31) <= seed < 2**64:
        raise ValueError(f"a seed runs from -2^31 to 2^64 - 1, got {seed}")
    hi = 0 if seed < 0 else seed >> 32
    return torch.tensor([hi, seed & ref.MASK], dtype=torch.int64)


def key_words(key) -> tuple[int, int]:
    """The two words of one key (a tensor or array of shape [2])."""
    if isinstance(key, torch.Generator):
        raise TypeError("a draw takes a key from repro_torch.random.PRNGKey(seed), "
                        "not a torch.Generator")
    k = key.cpu().numpy() if isinstance(key, torch.Tensor) else np.asarray(key)
    if k.shape != (2,) or not np.issubdtype(k.dtype, np.integer):
        raise TypeError(f"a key is two integer words, shape [2], as PRNGKey(seed) gives; "
                        f"got {k.dtype} {k.shape}")
    k0, k1 = (int(w) & ref.MASK for w in k.tolist())
    return k0, k1


def split(key, num: int = 2) -> torch.Tensor:
    """``num`` new keys [num, 2] from ``key``, as ``jax.random.split``
    (the fold-like split: key i is the hash of the count (0, i))."""
    k0, k1 = key_words(key)
    y0, y1 = ref.threefry2x32(k0, k1, torch.zeros(num, dtype=torch.int64),
                              torch.arange(num, dtype=torch.int64))
    return torch.stack([y0, y1], dim=1)


def _window(shape, offset, block):
    shape = tuple(int(n) for n in shape)
    offset = (0,) * len(shape) if offset is None else tuple(int(o) for o in offset)
    block = tuple(n - o for n, o in zip(shape, offset)) if block is None else tuple(
        int(b) for b in block)
    return shape, offset, block


def _draw(kind, dtype, key, shape, offset, block, device, **kw) -> torch.Tensor:
    k0, k1 = key_words(key)
    shape, offset, block = _window(shape, offset, block)
    out = torch.empty(block, dtype=dtype, device=resolve_device(device))
    return draw(out, k0, k1, shape, offset, kind, **kw)


def bits(key, shape: Sequence[int], *, offset=None, block=None, device=None) -> torch.Tensor:
    """32 random bits an element (int64 values < 2^32), as
    ``jax.random.bits(key, shape)``: the block of shape ``block`` (default:
    to the end of every dim) at ``offset`` (default: the origin)."""
    return _draw("bits", torch.int64, key, shape, offset, block, device)


def uniform(key, shape: Sequence[int], minval: float = 0.0, maxval: float = 1.0, *,
            offset=None, block=None, device=None) -> torch.Tensor:
    """float32 uniforms on [minval, maxval), as ``jax.random.uniform``
    (float32), over the window ``offset``/``block`` of ``shape``."""
    return _draw("uniform", torch.float32, key, shape, offset, block, device,
                 minval=minval, maxval=maxval)


def normal(key, shape: Sequence[int], *, offset=None, block=None, device=None) -> torch.Tensor:
    """float32 standard normals, as ``jax.random.normal`` (float32), over
    the window ``offset``/``block`` of ``shape``."""
    return _draw("normal", torch.float32, key, shape, offset, block, device)


def randint(key, shape: Sequence[int], minval: int, maxval: int, *, device=None) -> torch.Tensor:
    """int32 integers on [minval, maxval), as ``jax.random.randint(key,
    shape, minval, maxval)`` (int32): two 32-bit draws from ``split(key)``,
    ``hi`` and ``lo``, reduced modulo the span in uint32 arithmetic as
    ``jax._src.random._randint`` does (a span of 1 where maxval <=
    minval).  ``minval`` and ``maxval`` are int32 ints."""
    minval, maxval = int(minval), int(maxval)
    if not (INT32_MIN <= minval <= INT32_MAX and INT32_MIN <= maxval <= INT32_MAX):
        raise ValueError(f"randint takes int32 bounds, got [{minval}, {maxval})")
    k_hi, k_lo = split(key)
    hi = bits(k_hi, shape, device=device)
    lo = bits(k_lo, shape, device=device)
    span = (maxval - minval) & ref.MASK if maxval > minval else 1
    m = (1 << 16) % span
    multiplier = ((m * m) & ref.MASK) % span  # 2^32 mod span, as uint32 computes it
    offset = ((((hi % span) * multiplier) & ref.MASK) + lo % span) & ref.MASK
    value = (minval + offset % span) & ref.MASK
    return torch.where(value > INT32_MAX, value - (1 << 32), value).to(torch.int32)


def gumbel(key, shape: Sequence[int], dtype: torch.dtype = torch.float32, *, offset=None,
           block=None, device=None) -> torch.Tensor:
    """Gumbel noise in ``dtype`` (float32 or bfloat16), as
    ``jax.random.gumbel(key, shape, dtype)`` (mode "low"), over the window
    ``offset``/``block`` of ``shape``."""
    return _draw("gumbel", dtype, key, shape, offset, block, device)


def categorical(key, logits: torch.Tensor, axis: int = -1) -> torch.Tensor:
    """Samples of the categorical distributions of ``logits`` (float32 or
    bfloat16) along ``axis``, as ``jax.random.categorical(key, logits,
    axis)``: the first index of the maximum of ``logits + gumbel(key,
    logits.shape, logits.dtype)``, the sum in the logits' dtype; int64, on
    the logits' device.  Along the last axis the pick runs fused (on the
    card the pick kernel, which writes no noise); along another, the noise
    is drawn and added."""
    k0, k1 = key_words(key)
    axis = axis % logits.dim()
    if axis == logits.dim() - 1:
        rows = logits.reshape(-1, logits.shape[-1])
        if rows.stride(-1) != 1:
            rows = rows.contiguous()
        return gumbel_pick(rows, k0, k1).reshape(logits.shape[:-1])
    noise = gumbel(key, logits.shape, logits.dtype, device=logits.device)
    return (logits + noise).argmax(axis)


def normal_(out: torch.Tensor, key, shape: Sequence[int], offset=None,
            scale: float = 1.0) -> torch.Tensor:
    """Fill the contiguous ``out`` (float32 or bfloat16) -- the block of
    its shape at ``offset`` of an array of ``shape`` -- with
    ``(normal(key, shape) * scale).astype(out.dtype)`` there, the product
    in float32 (``scale`` rounded to float32 first, as JAX rounds a weakly
    typed float); on ``out``'s device.  Returns ``out``."""
    normal_many([(out, key, shape, offset, scale)])
    return out


def normal_many(draws) -> None:
    """:func:`normal_` for each (out, key, shape, offset, scale) of
    ``draws``, all on one device: on the card one kernel launch each, on
    the CPU together in passes of the plain version (many small draws, as
    an initialiser's, then cost a few passes' operations)."""
    fills = []
    for out, key, shape, offset, scale in draws:
        k0, k1 = key_words(key)
        shape, offset, _ = _window(shape, offset, None)
        fills.append(ref.Draw(out, k0, k1, shape, offset, scale))
    draw_many(fills, "normal")
