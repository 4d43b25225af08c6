"""Launch wrappers of the Hopper counter-based draw (``csrc/threefry.cu``)
and of the categorical pick built on it (``csrc/gumbel_pick.cu``).

Neither replaces a TPU kernel.  The JAX package draws its parameters
with ``jax.random`` (``src/repro/models/transformer.py``, ``_init_leaf``;
``src/repro/nn/layers.py``, ``_glorot``), which XLA lowers to its own
threefry.  The draw kernel gives the same numbers: one thread per
element of a window of a larger array, the element's global flat index
hashed under the key, then the bits, the uniform, the normal (times a
scale, as float32 or bfloat16) or the Gumbel noise written in place.
The JAX engine's categorical pick (``src/repro/serve/engine.py``,
``jax.random.categorical`` of ``logits / T``) is XLA's threefry,
``-log(-log(u))``, an add and an ``argmax``; the pick kernel fuses them
and writes one index a row, each row split over blocks by
:func:`pick_plan` (shapes and the SM count only).  Each wrapper checks
what its kernel takes, launches on the current stream, raises
:class:`KernelError` on a launch error, and counts its launches
(``launches``, ``pick_launches``).  Nothing is built on import: a library
is built and loaded on its first launch.
"""

from __future__ import annotations

import ctypes
import functools
import math
import threading
from typing import NamedTuple

import torch

from .._build import KernelError, LaunchCounter, library, sm_count
from .ref import KINDS, NORMAL_LO, f32, weak_scalar, window_plan

MAX_DIMS = 4  # merged dims of a window the kernel takes
BLOCK = 256  # threads a block, one element each
# the kernel's work per element, for its bound: int32 operations -- the
# index (2), the hash's 20 rounds of add, rotate and xor and its 5 key
# injections (72), the bits and the mantissa (3) -- and float32 flops of
# the uniform and the normal (an fmaf counted as two; log1pf as the ~10
# flops of its own polynomial)
INT32_OPS_PER_ELEMENT = 77
F32_FLOPS_PER_ELEMENT = 50
# the pick's work per logit, for its bound: the index and the hash (74
# int32 operations) and the noise's index or mantissa, the compare and
# the select (4); float32 flops: bf16 -- the division, the sum and two
# roundings (the noise is one of 128 values, from a table built once) --
# or f32 -- the division, the sum and two logf (~20 each)
PICK_INT32_OPS_PER_ELEMENT = 78
PICK_F32_FLOPS_PER_ELEMENT = {torch.bfloat16: 4, torch.float32: 42}
# the SM pipes the pick's int32 operations run on, 64 lanes each: the
# INT32 pipe (rotates, xors, compares) and the FMA pipe, which ptxas gives
# the hash's adds as IMAD; the bound divides the 78 operations by both
# (on the card the kernel's time a logit at large V is below that of the
# INT32 pipe alone)
PICK_INT32_PIPES = 2
# the pick's launch geometry (csrc/gumbel_pick.cu's constants)
PICK_THREADS = 256  # a block's threads
PICK_BLOCKS_PER_SM = 2  # __launch_bounds__'s residency; 4 fit by registers but ran slower
PICK_GROUP = 4  # logits a thread takes a pass; a block starts at a multiple of it
PICK_MIN_BLOCK = 1024  # logits a block at least (4 a thread), unless the row is shorter
MAX_GRID_Y = 65535  # rows: the grid's y dimension
H100_SMS = 132
NOISE_VALUES = 128  # the bfloat16 Gumbel noise's values
# the noise table's work a value, for its bound: float32 flops -- the
# uniform, two logf (~20 each) and two roundings
NOISE_F32_FLOPS_PER_VALUE = 44

launches = LaunchCounter("prng")
pick_launches = LaunchCounter("gumbel_pick")
noise_table_launches = LaunchCounter("gumbel_noise_table")  # bf16's noise table, once a device

_OUT_DTYPES = {"bits": (torch.int64,), "uniform": (torch.float32,),
               "normal": (torch.float32, torch.bfloat16),
               "gumbel": (torch.float32, torch.bfloat16)}

_c_int = ctypes.c_int
_c_uint = ctypes.c_uint
_c_ll = ctypes.c_longlong
_c_ull = ctypes.c_ulonglong
_c_float = ctypes.c_float
_c_ptr = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = library("threefry")
    if lib.da4ml_threefry.argtypes is None:
        lib.da4ml_threefry.argtypes = [
            _c_int,  # kind: bits, uniform, normal f32, normal bf16
            _c_uint, _c_uint,  # the key's two words
            _c_ull, _c_ll, _c_int,  # base, elements, merged dims
            *[_c_ll] * MAX_DIMS,  # their extents
            *[_c_ll] * MAX_DIMS,  # their global strides
            _c_float, _c_float, _c_float,  # maxval - minval, minval, scale
            _c_ptr,  # out
            _c_ptr,  # stream
        ]
        lib.da4ml_threefry.restype = _c_int
        lib.da4ml_cuda_error_string.argtypes = [_c_int]
        lib.da4ml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _pick_lib() -> ctypes.CDLL:
    lib = library("gumbel_pick")
    if lib.da4ml_gumbel_pick.argtypes is None:
        lib.da4ml_gumbel_pick.argtypes = [
            _c_int,  # bfloat16 logits (1) or float32 (0)
            _c_ptr,  # logits
            _c_int, _c_int, _c_ll,  # rows, their length, the row stride in elements
            _c_uint, _c_uint,  # the key's two words
            _c_float,  # the temperature, rounded to the logits' dtype
            ctypes.c_double, _c_int,  # its reciprocal in float64; 1: divide (exact_division)
            _c_int,  # blocks a row (pick_plan)
            _c_ptr,  # bfloat16's noise table (or null)
            _c_ptr,  # scratch: [rows, 2] zero int64 (or null with one block a row)
            _c_ptr,  # out: int64 [rows]
            _c_ptr,  # stream
        ]
        lib.da4ml_gumbel_pick.restype = _c_int
        lib.da4ml_gumbel_noise_table.argtypes = [_c_ptr, _c_ptr]
        lib.da4ml_gumbel_noise_table.restype = _c_int
        lib.da4ml_capture_id.argtypes = [_c_ptr]
        lib.da4ml_capture_id.restype = _c_ull
        lib.da4ml_capture_watch.argtypes = [_c_ptr]
        lib.da4ml_capture_watch.restype = _c_int
        lib.da4ml_released_captures.argtypes = [ctypes.POINTER(_c_ull), _c_int]
        lib.da4ml_released_captures.restype = _c_int
        lib.da4ml_cuda_error_string.argtypes = [_c_int]
        lib.da4ml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def kernel_kind(kind: str, dtype: torch.dtype) -> int:
    """The C entry point's code of a draw of ``kind`` into ``dtype``."""
    if kind not in KINDS or dtype not in _OUT_DTYPES[kind]:
        raise TypeError(f"a {kind} draw goes to {_OUT_DTYPES.get(kind)}, got {dtype}")
    bf16 = dtype == torch.bfloat16
    return {"bits": 0, "uniform": 1, "normal": 2 + bf16, "gumbel": 4 + bf16}[kind]


def draw_cuda(out: torch.Tensor, k0: int, k1: int, shape, offset, kind: str,
              scale: float = 1.0, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Fill the contiguous CUDA tensor ``out`` -- the block at ``offset``
    of an array of ``shape`` -- with the draw of key (k0, k1) there: the
    32 random bits (int64 ``out``), the uniform on [minval, maxval)
    (float32), the normal times ``scale`` (float32 or bfloat16) or the
    Gumbel noise (float32 or bfloat16).  One launch (none for an empty
    block)."""
    if out.device.type != "cuda":
        raise ValueError(f"draw_cuda takes a CUDA tensor, got one on {out.device}")
    if not out.is_contiguous():
        raise ValueError("draw_cuda needs a contiguous output")
    code = kernel_kind(kind, out.dtype)
    base, dims = window_plan(shape, offset, out.shape)
    if len(dims) > MAX_DIMS:
        raise ValueError(f"draw_cuda takes windows of at most {MAX_DIMS} merged dims, got "
                         f"{out.shape} at {tuple(offset)} in {tuple(shape)}")
    n = out.numel()
    if n == 0:
        return out
    if n > BLOCK * (2**31 - 1):
        raise ValueError(f"draw_cuda: {n} elements exceed one launch")
    dims = dims or [(1, 0)]
    lens = [e for e, _ in dims] + [1] * (MAX_DIMS - len(dims))
    strides = [s for _, s in dims] + [0] * (MAX_DIMS - len(dims))
    if kind == "normal":
        minval, maxval = NORMAL_LO, 1.0
    lo = f32(minval)
    lib = _lib()
    with torch.cuda.device(out.device):
        err = lib.da4ml_threefry(
            code, k0, k1, base, n, len(dims), *lens, *strides, f32(f32(maxval) - lo), lo,
            f32(scale), out.data_ptr(), torch.cuda.current_stream(out.device).cuda_stream,
        )
    if err != 0:
        msg = lib.da4ml_cuda_error_string(err).decode()
        raise KernelError(f"threefry kernel launch failed: {msg} (cudaError {err})")
    launches.add()
    return out


class PickPlan(NamedTuple):
    """How the pick kernel splits [b, v] logits over the card."""

    splits: int  # blocks a row: the grid's x dimension
    blocks: int  # the grid: splits x b
    blocks_per_sm: int  # the most blocks an SM takes, the grid spread evenly


def pick_bounds(v: int, splits: int) -> list[int]:
    """Where each of a row's ``splits`` blocks starts, and ``v`` last:
    block i takes the logits from floor(i v / splits) to floor((i + 1) v /
    splits), each rounded down to a multiple of ``PICK_GROUP`` (the
    kernel's ``pick_bound``)."""
    return [(i * v // splits) & -PICK_GROUP for i in range(splits)] + [v]


@functools.lru_cache(maxsize=1024)
def pick_plan(b: int, v: int, n_sm: int = H100_SMS) -> PickPlan:
    """The pick kernel's grid for logits [b, v] on a card of ``n_sm`` SMs.

    Each row is split over at most as many blocks as fill the card at
    ``PICK_BLOCKS_PER_SM`` (n_sm * 2 // b: 33 at b = 8 on 132 SMs), and
    over at most v // (PICK_MIN_BLOCK + PICK_GROUP) blocks, so that every
    block keeps ``PICK_MIN_BLOCK`` logits (one block where the row is
    shorter).  Among those counts it takes the one whose busiest SM
    holds the fewest logits, the grid spread evenly (ties: more blocks).
    Shapes and the SM count decide it, never the values."""
    if b < 1 or v < 1:
        raise ValueError(f"the pick plans for b, v >= 1, got {b}, {v}")
    cap = max(1, min(n_sm * PICK_BLOCKS_PER_SM // b, v // (PICK_MIN_BLOCK + PICK_GROUP)))

    def busiest(s: int) -> int:  # logits on the busiest SM, about
        return -(-b * s // n_sm) * -(-v // s)

    splits = min(range(cap, 0, -1), key=busiest)
    return PickPlan(splits, b * splits, -(-b * splits // n_sm))


def exact_division(t: float) -> bool:
    """Whether the pick kernel divides the logits by the temperature ``t``
    (a float32 or bfloat16 value) with ``__fdiv_rn`` rather than the
    float64 product with 1 / t: where t = odd * 2^a with an odd factor
    above 1 and a >= 1 (6, 10, 12, ...), a subnormal quotient can lie on a
    float32 rounding midpoint, which the argument for the product leaves
    out (``csrc/gumbel_pick.cu``, ``quotient``).  Zero, infinite and NaN
    temperatures take the product, which gives __fdiv_rn's results."""
    if t == 0 or not math.isfinite(t):
        return False
    num, den = abs(t).as_integer_ratio()  # den a power of two
    odd = num >> ((num & -num).bit_length() - 1)
    return odd > 1 and num // odd >= 2 * den


def pick_keys(scores: torch.Tensor) -> torch.Tensor:
    """The 64-bit words the pick kernel reduces, of scores [..., V]
    (float32 or bfloat16), as int64 in the same order: the score's key
    (every NaN above every number and equal to the others, -0 equal to
    +0, else the floats' order) above the inverted index, so that the
    largest word of a row holds ``scores.argmax(-1)`` (:func:`pick_index`)."""
    s = scores.float() + 0.0  # -0 + 0 = +0
    u = s.view(torch.int32).to(torch.int64) & 0xFFFFFFFF
    key = torch.where(u >= 1 << 31, u ^ 0xFFFFFFFF, u | (1 << 31))
    key = torch.where(torch.isnan(s), torch.full_like(key, 0xFFFFFFFF), key)
    index = torch.arange(s.shape[-1], dtype=torch.int64, device=s.device)
    return ((key - (1 << 31)) << 32) | (index ^ 0xFFFFFFFF)


def pick_index(words: torch.Tensor) -> torch.Tensor:
    """The index a word of :func:`pick_keys` holds."""
    return (words & 0xFFFFFFFF) ^ 0xFFFFFFFF


_pick_lock = threading.Lock()
_noise_tables: dict[int, torch.Tensor] = {}  # device index -> bfloat16's noise table
# (device, stream) -> the scratch of eager picks on that stream
_stream_scratch: dict[tuple[int, int], torch.Tensor] = {}
# capture id -> the scratch tensors and the noise table a capture's picks
# use, held until the captured graph is destroyed
_capture_buffers: dict[int, dict] = {}


def _build_noise_table(lib: ctypes.CDLL, device: torch.device, stream) -> torch.Tensor:
    """bfloat16's 128 noise values as float32, by the source's one-block
    kernel on ``stream`` (not waited for)."""
    table = torch.empty(NOISE_VALUES, dtype=torch.float32, device=device)
    err = lib.da4ml_gumbel_noise_table(table.data_ptr(), stream.cuda_stream)
    if err != 0:
        msg = lib.da4ml_cuda_error_string(err).decode()
        raise KernelError(f"gumbel noise table launch failed: {msg} (cudaError {err})")
    noise_table_launches.add()
    return table


def _drop_released(lib: ctypes.CDLL) -> None:
    """Let go of the buffers of captures whose graphs are gone."""
    ids = (_c_ull * 64)()
    while (n := lib.da4ml_released_captures(ids, 64)) > 0:
        for i in range(n):
            _capture_buffers.pop(ids[i], None)


def _pick_buffers(lib: ctypes.CDLL, device: torch.device, stream, rows: int, bf16: bool,
                  splits: int) -> tuple:
    """The noise table (bf16) and the combine's scratch (more than one block
    a row) of a pick on ``stream``, or None each.

    The table is built once a device, at its first bf16 pick outside a
    capture, and waited for (picks on other streams read it too).  The
    scratch, zero int64 [rows, 2] that every pick leaves zero, is one a
    stream for eager picks (a stream's picks run one after another).  A
    CUDA-graph capture gets scratch of its own, allocated and zeroed inside
    it (so a replay zeroes it first and shares it with nothing else), and a
    table of its own if the device has none yet; these are held until the
    graph and its instances are destroyed (``da4ml_capture_watch``), so no
    later allocation, in a shared graph pool or not, takes memory that a
    replay still writes."""
    capture = lib.da4ml_capture_id(stream.cuda_stream)
    with _pick_lock:
        _drop_released(lib)
        table = _noise_tables.get(device.index) if bf16 else None
        if bf16 and table is None and not capture:
            table = _noise_tables[device.index] = _build_noise_table(lib, device, stream)
            stream.synchronize()
        if not capture:
            scratch = _stream_scratch.get((device.index, stream.cuda_stream))
            if splits > 1 and (scratch is None or scratch.shape[0] < rows):
                scratch = torch.zeros((rows, 2), dtype=torch.int64, device=device)
                _stream_scratch[(device.index, stream.cuda_stream)] = scratch
            return table, (scratch if splits > 1 else None)
        held = _capture_buffers.get(capture)
        if held is None:
            err = lib.da4ml_capture_watch(stream.cuda_stream)
            if err != 0:
                msg = lib.da4ml_cuda_error_string(err).decode()
                raise KernelError(f"cannot tie the pick's buffers to the captured graph: {msg} "
                                  f"(cudaError {err})")
            held = _capture_buffers[capture] = {"scratch": [], "table": None}
        scratch = held["scratch"][-1] if held["scratch"] else None
        if splits > 1 and (scratch is None or scratch.shape[0] < rows):
            scratch = torch.zeros((rows, 2), dtype=torch.int64, device=device)
            held["scratch"].append(scratch)  # earlier picks of the graph keep theirs
        if bf16 and table is None:
            if held["table"] is None:
                held["table"] = _build_noise_table(lib, device, stream)
            table = held["table"]
        return table, (scratch if splits > 1 else None)


def gumbel_pick_cuda(logits: torch.Tensor, k0: int, k1: int,
                     temperature: float = 1.0) -> torch.Tensor:
    """For each row of the CUDA tensor ``logits`` [B, V] (float32 or
    bfloat16, unit stride along V), the first index of the maximum of
    ``logits / T + gumbel(key, [B, V], dtype)``, with the JAX engine's
    roundings (``ref.gumbel_pick_ref``).  Returns int64 [B]; one launch,
    on the grid of :func:`pick_plan`."""
    if logits.device.type != "cuda":
        raise ValueError(f"gumbel_pick_cuda takes a CUDA tensor, got one on {logits.device}")
    if logits.dim() != 2 or logits.dtype not in (torch.float32, torch.bfloat16):
        raise TypeError(f"the pick takes float32 or bfloat16 logits [B, V], got "
                        f"{logits.dtype} {tuple(logits.shape)}")
    b, v = logits.shape
    if v == 0 or (v > 1 and logits.stride(1) != 1):
        raise ValueError(f"the pick needs V >= 1 and unit stride along V, got {tuple(logits.shape)} "
                         f"strides {logits.stride()}")
    if v >= 2**31 or b > MAX_GRID_Y:
        raise ValueError(f"the pick takes V < 2^31 and B <= {MAX_GRID_Y}, got {tuple(logits.shape)}")
    out = torch.empty(b, dtype=torch.int64, device=logits.device)
    if b == 0:
        return out
    device = logits.device
    plan = pick_plan(b, v, sm_count(device))
    bf16 = logits.dtype == torch.bfloat16
    t = weak_scalar(temperature, logits.dtype)
    rcp = 1.0 / t if t != 0 else math.copysign(math.inf, t)
    lib = _pick_lib()
    with torch.cuda.device(device):
        stream = torch.cuda.current_stream(device)
        table, scratch = _pick_buffers(lib, device, stream, b, bf16, plan.splits)
        err = lib.da4ml_gumbel_pick(
            int(bf16), logits.data_ptr(), b, v, logits.stride(0), k0, k1, t, rcp,
            int(exact_division(t)), plan.splits, None if table is None else table.data_ptr(),
            None if scratch is None else scratch.data_ptr(), out.data_ptr(), stream.cuda_stream,
        )
    if err != 0:
        msg = lib.da4ml_cuda_error_string(err).decode()
        raise KernelError(f"gumbel pick kernel launch failed: {msg} (cudaError {err})")
    pick_launches.add()
    return out
