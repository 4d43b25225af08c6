"""Launch wrapper of the Hopper counter-based draw (``csrc/threefry.cu``).

It replaces no TPU kernel: the JAX package draws its parameters with
``jax.random`` (``src/repro/models/transformer.py``, ``_init_leaf``),
which XLA lowers to its own threefry.  The kernel draws the same
numbers: one thread per element of a window of a larger array, the
element's global flat index hashed under the key, then the bits, the
uniform or the normal (times a scale, as float32 or bfloat16) written in
place.  The wrapper checks what the kernel takes, launches on the current
stream, raises :class:`KernelError` on a launch error, and counts its
launches in ``launches``.  Nothing is built on import: the library is
built and loaded on the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import KernelError, LaunchCounter, library
from .ref import KINDS, NORMAL_LO, f32, window_plan

MAX_DIMS = 4  # merged dims of a window the kernel takes
BLOCK = 256  # threads a block, one element each
# the kernel's work per element, for its bound: int32 operations -- the
# index (2), the hash's 20 rounds of add, rotate and xor and its 5 key
# injections (72), the bits and the mantissa (3) -- and float32 flops of
# the uniform and the normal (an fmaf counted as two; log1pf as the ~10
# flops of its own polynomial)
INT32_OPS_PER_ELEMENT = 77
F32_FLOPS_PER_ELEMENT = 50

launches = LaunchCounter("prng")

_OUT_DTYPES = {"bits": (torch.int64,), "uniform": (torch.float32,),
               "normal": (torch.float32, torch.bfloat16)}

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


def kernel_kind(kind: str, dtype: torch.dtype) -> int:
    """The C entry point's code of a draw of ``kind`` into ``dtype``."""
    if kind not in KINDS or dtype not in _OUT_DTYPES[kind]:
        raise TypeError(f"a {kind} draw goes to {_OUT_DTYPES.get(kind)}, got {dtype}")
    return {"bits": 0, "uniform": 1}.get(kind, 2 if dtype == torch.float32 else 3)


def draw_cuda(out: torch.Tensor, k0: int, k1: int, shape, offset, kind: str,
              scale: float = 1.0, minval: float = 0.0, maxval: float = 1.0) -> torch.Tensor:
    """Fill the contiguous CUDA tensor ``out`` -- the block at ``offset``
    of an array of ``shape`` -- with the draw of key (k0, k1) there: the
    32 random bits (int64 ``out``), the uniform on [minval, maxval)
    (float32) or the normal times ``scale`` (float32 or bfloat16).  One
    launch (none for an empty block)."""
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
