"""Launch wrapper of the Hopper flash-attention kernel
(``csrc/flash_attention.cu``).

It replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py``
(``_flash_kernel``, launched by ``flash_attention_pallas``).  The wrapper
checks what the kernel takes, picks one of the source's three kernels by
:func:`flash_plan` (shapes and dtype only), allocates the output with
``torch.empty``, launches on the current stream, raises on a launch
error, and counts its launches in ``launches``.  Nothing is built on
import: the library is built and loaded on the first launch.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .._build import KernelError, LaunchCounter, library, sm_count

HEAD_DIMS = (16, 32, 64, 80, 112, 128)  # the head_dims the kernel is compiled for
_DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}
_KERNEL_CODES = {"cuda_core": 0, "decode": 1, "tensor_core": 2}
DECODE_ROWS = 16  # the decode kernel packs at most this many (query head, query row) pairs
MAX_SPLITS = 8  # blocks of a decode cluster (the portable cluster size)
SPLIT_MIN_KEYS = 32  # cached keys per split at least: one warp's worth
H100_SMS = 132

launches = LaunchCounter("flash_attention")

_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p


class FlashPlan(NamedTuple):
    """Which of the source's kernels a call takes, and its key splits."""

    kernel: str  # "decode", "tensor_core" (bf16) or "cuda_core" (f32)
    splits: int  # blocks of a decode cluster that share the keys (1 elsewhere)


def flash_plan(b: int, hq: int, hkv: int, sq: int, sk: int, dtype: torch.dtype,
               n_sms: int = H100_SMS) -> FlashPlan:
    """The kernel for q [b, hq, sq, D] against k/v [b, hkv, sk, D].

    Decode, where one GQA group's rows (hq / hkv query heads times sq)
    fit one block: the splits double, up to 8, while b * hkv * splits
    blocks fit the card's SMs and every split keeps 32 of the sk cached
    keys.  Otherwise bf16 takes the tensor cores and f32 the CUDA cores.
    The plan depends on shapes alone, never on the offset's value."""
    if (hq // hkv) * sq <= DECODE_ROWS:
        splits = 1
        while (splits < MAX_SPLITS and b * hkv * 2 * splits <= n_sms
               and 2 * splits * SPLIT_MIN_KEYS <= sk):
            splits *= 2
        return FlashPlan("decode", splits)
    return FlashPlan("tensor_core" if dtype == torch.bfloat16 else "cuda_core", 1)


def _lib() -> ctypes.CDLL:
    lib = library("flash_attention")
    if lib.da4ml_flash_attention.argtypes is None:
        lib.da4ml_flash_attention.argtypes = [
            _c_int, _c_int, _c_int, _c_int,  # dtype, kernel, splits, head_dim
            _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # q, k, v, o
            _c_int, _c_int, _c_int, _c_int, _c_int,  # B, Hq, Hkv, Sq, Sk
            ctypes.POINTER(ctypes.c_longlong),  # the 9 strides of q, k, v
            ctypes.c_float, _c_int,  # scale, causal
            _c_ptr, _c_int,  # offset on the device (or null), offset on the host
            _c_int, _c_ptr,  # 16-byte aligned, stream
        ]
        lib.da4ml_flash_attention.restype = _c_int
        lib.da4ml_cuda_error_string.argtypes = [_c_int]
        lib.da4ml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _aligned16(*tensors: torch.Tensor) -> bool:
    """Whether each tensor starts on 16 bytes and its batch, head and
    sequence strides are multiples of 16 bytes (the kernel's 16-byte loads)."""
    return all(t.data_ptr() % 16 == 0 and all(st * t.element_size() % 16 == 0
                                              for st in t.stride()[:3]) for t in tensors)


def flash_attention_cuda(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,  # [B, Hkv, Sk, D]
    causal: bool = True,
    scale: float | None = None,
    offset: int | torch.Tensor | None = None,
) -> torch.Tensor:
    """GQA attention on the card; returns a contiguous [B, Hq, Sq, D]
    tensor in q's dtype.

    q, k and v are CUDA tensors of one dtype (float32 or bfloat16) on one
    device, with a unit stride on the head dim (any strides elsewhere).
    ``offset`` is the absolute position of q's first row: ``None`` means
    ``Sk - Sq``; an int is passed by value; an int32 CUDA tensor of one
    element is read by the kernel on the device (no host sync).
    """
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_cuda takes CUDA tensors on one device, "
                             f"got {name} on {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash_attention_cuda takes float32 or bfloat16 q, k, v of one "
                            f"dtype, got {q.dtype}, {k.dtype}, {v.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_cuda takes 4-d tensors, got {name} "
                             f"{tuple(t.shape)}")
        if t.stride(3) != 1:
            raise ValueError(f"flash_attention_cuda needs a unit stride on {name}'s head dim")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv:
        raise ValueError(f"flash_attention_cuda: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)} are not [B, Hq, Sq, D], [B, Hkv, Sk, D] with "
                         f"Hq % Hkv == 0")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_cuda supports head_dim {HEAD_DIMS}, got {d}")
    off_ptr, off_host = None, sk - sq
    if isinstance(offset, torch.Tensor):
        if offset.device != q.device or offset.dtype != torch.int32 or offset.numel() != 1:
            raise ValueError("a tensor offset must be one int32 on q's device")
        off_ptr = offset.data_ptr()
    elif offset is not None:
        off_host = int(offset)
    out = torch.empty((b, hq, sq, d), dtype=q.dtype, device=q.device)
    if out.numel() == 0:
        return out
    strides = (ctypes.c_longlong * 9)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3])
    scale = d**-0.5 if scale is None else scale
    plan = flash_plan(b, hq, hkv, sq, sk, q.dtype, sm_count(q.device))
    lib = _lib()
    with torch.cuda.device(q.device):
        err = lib.da4ml_flash_attention(
            _DTYPE_CODES[q.dtype], _KERNEL_CODES[plan.kernel], plan.splits, d,
            q.data_ptr(), k.data_ptr(), v.data_ptr(),
            out.data_ptr(), b, hq, hkv, sq, sk, strides, scale, int(causal),
            off_ptr, off_host, int(_aligned16(q, k, v)),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        msg = lib.da4ml_cuda_error_string(err).decode()
        raise KernelError(f"flash-attention kernel launch failed: {msg} (cudaError {err})")
    launches.add()
    return out
