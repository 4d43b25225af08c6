"""Launch wrapper of the Hopper W8A8 matmul kernel (``csrc/quant_matmul.cu``).

It replaces the TPU kernel ``repro/kernels/quant_matmul/kernel.py``
(``_qmm_kernel``, launched by ``quant_matmul_pallas``).  The source
holds two kernels: wgmma on TMA-fed tiles where a tensor map can describe
the operands, and mma.sync with the threads' own loads for the rest;
``qmm_entry`` picks one by a rule on shapes and alignment alone.  The
wrapper checks what the kernels take, allocates the output with
``torch.empty``, launches on the current stream, raises on a launch
error, and counts its launches in ``launches`` (and by kernel in
``kernel_launches``).  Nothing is built on import: the library is built
and loaded on the first launch.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import KernelError, LaunchCounter, library

# |x_i8 * w_i8| <= 2^14, so an int32 sum of K products cannot overflow
# while K * 2^14 < 2^31
MAX_K = (1 << 31) // (128 * 128) - 1

KERNELS = ("tma", "mma_sync")  # the source's kernels, in the C entry point's numbering

launches = LaunchCounter("quant_matmul")
# the same launches, by kernel
kernel_launches = {k: LaunchCounter(f"quant_matmul.{k}") for k in KERNELS}

_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = library("quant_matmul")
    if lib.da4ml_quant_matmul.argtypes is None:
        lib.da4ml_quant_matmul.argtypes = [
            _c_int,  # kernel: an index into KERNELS
            _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # x, w, x_scale, w_scale, out
            _c_int, _c_int, _c_int,  # M, N, K
            _c_ptr,  # stream
        ]
        lib.da4ml_quant_matmul.restype = _c_int
        lib.da4ml_cuda_error_string.argtypes = [_c_int]
        lib.da4ml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def qmm_entry(n: int, k: int, x_ptr: int, w_ptr: int, out_ptr: int) -> str:
    """The kernel that x int8 [M, k] @ w int8 [k, n] into a float32 out
    takes, from the shapes and the three base addresses alone: ``"tma"``
    where a tensor map can describe x and w (rows a multiple of 16 bytes,
    bases on 16 bytes; out on 16 bytes for the epilogue's vector stores),
    ``"mma_sync"`` otherwise.  Any M, and n and k past their multiples of
    the tile, may be ragged on either kernel."""
    aligned = all(p % 16 == 0 for p in (x_ptr, w_ptr, out_ptr))
    return "tma" if k > 0 and k % 16 == 0 and n % 16 == 0 and aligned else "mma_sync"


def quant_matmul_cuda(
    x: torch.Tensor,  # int8 [M, K]
    w: torch.Tensor,  # int8 [K, N]
    x_scale: torch.Tensor,  # f32 [M]
    w_scale: torch.Tensor,  # f32 [N]
) -> torch.Tensor:
    """(x @ w) summed exactly in int32, then ``* x_scale[:, None] *
    w_scale[None, :]`` in float32: a contiguous float32 [M, N] on x's
    device.  All four are contiguous CUDA tensors on one device; K must be
    at most ``MAX_K``."""
    named = {"x": (x, torch.int8, 2), "w": (w, torch.int8, 2),
             "x_scale": (x_scale, torch.float32, 1), "w_scale": (w_scale, torch.float32, 1)}
    for name, (t, dtype, ndim) in named.items():
        if t.device.type != "cuda" or t.device != x.device:
            raise ValueError(f"quant_matmul_cuda takes CUDA tensors on one device, "
                             f"got {name} on {t.device}")
        if t.dtype != dtype:
            raise TypeError(f"quant_matmul_cuda takes {dtype} {name}, got {t.dtype}")
        if t.dim() != ndim:
            raise ValueError(f"quant_matmul_cuda: {name} has shape {tuple(t.shape)}")
        if not t.is_contiguous():
            raise ValueError(f"quant_matmul_cuda needs a contiguous {name}")
    m, k = x.shape
    n = w.shape[1]
    if w.shape[0] != k or x_scale.shape[0] != m or w_scale.shape[0] != n:
        raise ValueError(f"quant_matmul_cuda: x {tuple(x.shape)}, w {tuple(w.shape)}, "
                         f"x_scale {tuple(x_scale.shape)}, w_scale {tuple(w_scale.shape)} "
                         f"are not [M, K], [K, N], [M], [N]")
    if k > MAX_K:
        raise ValueError(f"quant_matmul_cuda: K = {k} could overflow the int32 sum "
                         f"(at most {MAX_K})")
    out = torch.empty((m, n), dtype=torch.float32, device=x.device)
    if out.numel() == 0:
        return out
    lib = _lib()
    with torch.cuda.device(x.device):
        entry = qmm_entry(n, k, x.data_ptr(), w.data_ptr(), out.data_ptr())
        err = lib.da4ml_quant_matmul(
            KERNELS.index(entry), x.data_ptr(), w.data_ptr(), x_scale.data_ptr(),
            w_scale.data_ptr(), out.data_ptr(),
            m, n, k, torch.cuda.current_stream(x.device).cuda_stream,
        )
    if err != 0:
        msg = lib.da4ml_cuda_error_string(err).decode()
        raise KernelError(f"W8A8 matmul kernel launch failed: {msg} (cudaError {err})")
    launches.add()
    kernel_launches[entry].add()
    return out
