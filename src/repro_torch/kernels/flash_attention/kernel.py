"""Launch wrapper of the Hopper flash-attention kernel
(``csrc/flash_attention.cu``).

It replaces the TPU kernel ``repro/kernels/flash_attention/kernel.py``
(``_flash_kernel``, launched by ``flash_attention_pallas``).  The wrapper
checks what the kernel takes, picks one of the source's three kernels by
:func:`flash_plan` (shapes and dtype only), allocates the output with
``torch.empty``, launches on the current stream, raises on a launch
error, and counts its launches in ``launches``.  Nothing is built on
import: the library is built and loaded on the first launch.

On the training path ``flash_attention_cuda`` also writes each row's
log-sum-exp into an ``lse`` tensor the caller gives (serving gives none,
and the kernel is passed a null pointer).  ``flash_attention_bwd_cuda``
launches the backward (``csrc/flash_attention_bwd.cu``, a library of its
own: in bf16 the delta kernel, then one grid of dK/dV and dQ blocks on
wgmma, its geometry from :func:`flash_bwd_plan`; in f32 the dQ kernel,
then the dK/dV kernel) from that lse and counts one launch per call in
``bwd_launches``.
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
            _c_ptr,  # lse (or null: serving)
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
    lse: torch.Tensor | None = None,
) -> torch.Tensor:
    """GQA attention on the card; returns a contiguous [B, Hq, Sq, D]
    tensor in q's dtype.

    q, k and v are CUDA tensors of one dtype (float32 or bfloat16) on one
    device, with a unit stride on the head dim (any strides elsewhere).
    ``offset`` is the absolute position of q's first row: ``None`` means
    ``Sk - Sq``; an int is passed by value; an int32 CUDA tensor of one
    element is read by the kernel on the device (no host sync).  ``lse``,
    where given (the training path), is a contiguous f32 [B, Hq, Sq] on
    q's device that receives each row's log-sum-exp, base 2 of the scaled
    logits (+inf for a row that sees no key), from whichever kernel
    :func:`flash_plan` picks; without it the launch is the serving one.
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
    if lse is not None and (lse.device != q.device or lse.dtype != torch.float32
                            or tuple(lse.shape) != (b, hq, sq) or not lse.is_contiguous()):
        raise ValueError(f"lse must be a contiguous float32 {(b, hq, sq)} on q's device, got "
                         f"{lse.dtype} {tuple(lse.shape)} on {lse.device}")
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
            out.data_ptr(), None if lse is None else lse.data_ptr(),
            b, hq, hkv, sq, sk, strides, scale, int(causal),
            off_ptr, off_host, int(_aligned16(q, k, v)),
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        msg = lib.da4ml_cuda_error_string(err).decode()
        raise KernelError(f"flash-attention kernel launch failed: {msg} (cudaError {err})")
    launches.add()
    return out


# ----------------------------------------------------------------------
# the backward (csrc/flash_attention_bwd.cu)
# ----------------------------------------------------------------------
bwd_launches = LaunchCounter("flash_attention_bwd")  # one per backward (all its kernels)

BWD_TILE = 64  # keys or query rows of one consumer warpgroup (bf16)
# q, k, v and dO at most this many bytes: the bf16 backward reads the
# model's transposed views where they lie (half the H100's 50 MB L2)
BWD_VIEW_BYTES = 25 << 20
BWD_SIMT_ROWS = 16  # keys or query rows of an f32 block


class FlashBwdPlan(NamedTuple):
    """The backward's launch geometry: which kernels, their blocks and
    shared memory."""

    kernel: str  # "wgmma" (bf16) or "cuda_core" (f32)
    head_dim: int  # the head dim the kernel runs at: bf16 pads to 64 or 128
    dkdv_blocks: int  # blocks that write dK and dV (each owns `key_rows` keys of a KV head)
    dq_blocks: int  # blocks that write dQ (each owns `query_rows` rows of a query head)
    key_rows: int
    query_rows: int
    query_tile: int  # query rows a dK/dV block takes a step
    stages: int  # the ring's depth (bf16)
    threads: int  # per block
    smem_bytes: int  # dynamic shared memory per block
    read_views: bool  # bf16: read the model's transposed views in place (else copy them)

    @property
    def blocks(self) -> int:
        return self.dkdv_blocks + self.dq_blocks


def flash_bwd_plan(b: int, hq: int, hkv: int, sq: int, sk: int, d: int,
                   dtype: torch.dtype) -> FlashBwdPlan:
    """The backward's geometry for q [b, hq, sq, d] against k/v [b, hkv, sk,
    d], from the shapes alone (mirrored by the C entry point, which checks
    the block counts).

    bf16: one grid of dK/dV blocks (each owns 64 keys of a KV head), then
    dQ blocks (64 rows of a query head), each a consumer warpgroup and a
    producer warp: the smallest tiles wgmma takes (smollm-135m's step,
    [8, 9, 128, 64] on 3 KV heads: 48 + 144 blocks, where dK/dV alone would
    leave 84 of the H100's 132 SMs idle).  The head dim runs padded to 64
    (d <= 64) or 128, with query tiles of 64 or 32 rows; the ring is 4
    stages deep at 64, 2 at 128.  The model's q, k, v and dO are
    [B, S, H, D] viewed as [B, H, S, D]: a tensor map reads them in place
    (``tma_layout``) where the four take at most ``BWD_VIEW_BYTES``, and
    they are copied to [B, H, S, D] first where they take more (measured on
    the H100: in place as fast at smollm-135m's step, 1.6x as slow at seq
    1024, batch 16, where the copies cost ~30 us).  f32: the CUDA-core
    kernels, blocks of 16 rows or keys."""
    if dtype == torch.bfloat16:
        dp = 64 if d <= 64 else 128
        bq = 64 if dp == 64 else 32
        stages = 4 if dp == 64 else 2
        tile = BWD_TILE * dp * 2
        stage = -(-max(2 * tile, 2 * bq * dp * 2 + 2 * bq * 4) // 1024) * 1024
        smem = 1024 + 2 * tile + stages * stage + (2 * stages + 1) * 8
        views = 2 * 2 * d * (b * hq * sq + b * hkv * sk) <= BWD_VIEW_BYTES
        return FlashBwdPlan("wgmma", dp, -(-sk // BWD_TILE) * hkv * b, -(-sq // BWD_TILE) * hq * b,
                            BWD_TILE, BWD_TILE, bq, stages, 160, smem, views)
    if dtype == torch.float32:
        smem = (2 * BWD_SIMT_ROWS * d + 2 * 32 * (d + 1) + 2 * 32) * 4
        return FlashBwdPlan("cuda_core", d, -(-sk // BWD_SIMT_ROWS) * hkv * b,
                            -(-sq // BWD_SIMT_ROWS) * hq * b, BWD_SIMT_ROWS, BWD_SIMT_ROWS, 32,
                            0, 128, smem, False)
    raise TypeError(f"the flash backward takes float32 or bfloat16, got {dtype}")


def _bwd_lib() -> ctypes.CDLL:
    lib = library("flash_attention_bwd")
    if lib.da4ml_flash_attention_bwd.argtypes is None:
        lib.da4ml_flash_attention_bwd.argtypes = [
            _c_int, _c_int,  # dtype, head_dim
            _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # q, k, v, o, dout
            _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # dq, dk, dv, lse, delta
            _c_int, _c_int, _c_int, _c_int, _c_int,  # B, Hq, Hkv, Sq, Sk
            ctypes.POINTER(ctypes.c_longlong),  # bf16: the 12 strides of q, k, v, dout
            _c_int,  # bf16: the tensor maps merge rows with batches (tma_layout 1)
            ctypes.c_float, _c_int, _c_int,  # scale, causal, offset
            _c_int, _c_int,  # the plan's dK/dV and dQ blocks
            _c_ptr,  # stream
        ]
        lib.da4ml_flash_attention_bwd.restype = _c_int
        lib.da4ml_cuda_error_string.argtypes = [_c_int]
        lib.da4ml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def _dense(t: torch.Tensor, width: int) -> torch.Tensor:
    """``t`` contiguous, its last dim zero-padded to ``width``, starting on
    16 bytes (a copy where it is not)."""
    if t.shape[-1] < width:
        t = torch.nn.functional.pad(t, (0, width - t.shape[-1]))
    t = t.contiguous()
    return t if t.data_ptr() % 16 == 0 else t.clone()


def tma_layout(t: torch.Tensor) -> int | None:
    """How the bf16 backward's 3-d tensor maps read a [B, H, S, D] tensor
    where it lies: 0, heads merged with batches (contiguous in its batch
    and head dims); 1, rows merged with batches (the model's [B, S, H, D]
    viewed as [B, H, S, D], with S a multiple of the 64-row tiles); None,
    neither, or strides TMA cannot take (a unit-strided D, 16-byte bases
    and strides): the tensor is copied first."""
    b, h, s, _ = t.shape
    st = t.stride()
    if (st[3] != 1 or t.data_ptr() % 16
            or any(x * t.element_size() % 16 for x in st[:3])):
        return None
    if b == 1 or st[0] == h * st[1]:
        return 0
    if st[0] == s * st[2] and s % BWD_TILE == 0:
        return 1
    return None


def flash_attention_bwd_cuda(
    q: torch.Tensor,  # [B, Hq, Sq, D]
    k: torch.Tensor,  # [B, Hkv, Sk, D]
    v: torch.Tensor,  # [B, Hkv, Sk, D]
    o: torch.Tensor,  # [B, Hq, Sq, D]: the forward's output
    dout: torch.Tensor,  # [B, Hq, Sq, D]: the gradient of o
    lse: torch.Tensor,  # f32 [B, Hq, Sq]: the forward's log-sum-exp (``flash_attention_cuda``)
    causal: bool = True,
    scale: float | None = None,
    offset: int | None = None,
):
    """The gradient of ``flash_attention_cuda`` on the card: returns (dq,
    dk, dv), contiguous, in q's dtype, dk and dv summed over each GQA
    group's query heads.  Every tensor is a CUDA tensor of q's dtype
    (float32 or bfloat16) on q's device, but ``lse``, the f32 row
    statistic the forward wrote for the same inputs; ``offset`` is an int
    (None means ``Sk - Sq``).  Deterministic: two calls give the same
    bits."""
    named = {"q": q, "k": k, "v": v, "o": o, "dout": dout}
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"flash_attention_bwd_cuda takes CUDA tensors on one device, "
                             f"got {name} on {t.device}")
        if t.dtype != q.dtype or t.dtype not in _DTYPE_CODES:
            raise TypeError(f"flash_attention_bwd_cuda takes float32 or bfloat16 tensors of one "
                            f"dtype, got {name} {t.dtype} beside q {q.dtype}")
        if t.dim() != 4:
            raise ValueError(f"flash_attention_bwd_cuda takes 4-d tensors, got {name} "
                             f"{tuple(t.shape)}")
    b, hq, sq, d = q.shape
    _, hkv, sk, _ = k.shape
    if (k.shape != v.shape or k.shape[0] != b or k.shape[3] != d or hkv == 0 or hq % hkv
            or o.shape != q.shape or dout.shape != q.shape):
        raise ValueError(f"flash_attention_bwd_cuda: q {tuple(q.shape)}, k {tuple(k.shape)}, "
                         f"v {tuple(v.shape)}, o {tuple(o.shape)}, dout {tuple(dout.shape)}")
    if d not in HEAD_DIMS:
        raise ValueError(f"flash_attention_bwd_cuda supports head_dim {HEAD_DIMS}, got {d}")
    if (lse.device != q.device or lse.dtype != torch.float32
            or tuple(lse.shape) != (b, hq, sq)):
        raise ValueError(f"flash_attention_bwd_cuda: lse must be float32 {(b, hq, sq)} on q's "
                         f"device, got {lse.dtype} {tuple(lse.shape)} on {lse.device}")
    if isinstance(offset, torch.Tensor):
        raise ValueError("flash_attention_bwd_cuda takes an int offset, not a tensor")
    off = sk - sq if offset is None else int(offset)
    scale = d**-0.5 if scale is None else scale
    plan = flash_bwd_plan(b, hq, hkv, sq, sk, d, q.dtype)
    width = plan.head_dim if plan.kernel == "wgmma" and d < 64 else d
    if q.numel() == 0 or k.numel() == 0:
        return torch.zeros_like(q), torch.zeros_like(k), torch.zeros_like(v)
    # bf16 reads q, k, v and dout where they lie where the plan says so and
    # one tensor-map layout takes all four (the model's transposed views at
    # its sequence lengths: layout 1), else copies those that layout 0
    # cannot take; f32 copies all to contiguous
    seq = 0
    if plan.kernel == "wgmma" and width == d:
        layouts = [tma_layout(t) for t in (q, k, v, dout)]
        seq = int(plan.read_views and layouts == [1, 1, 1, 1])
        if not seq:
            q, k, v, dout = (t if lay == 0 else _dense(t, width)
                             for t, lay in zip((q, k, v, dout), layouts))
    else:
        q, k, v, dout = (_dense(t, width) for t in (q, k, v, dout))
    o = _dense(o, width)
    lse = lse.contiguous()
    dq, dk, dv = (torch.empty(t.shape, dtype=t.dtype, device=t.device) for t in (q, k, v))
    delta = torch.empty_like(lse)
    strides = (ctypes.c_longlong * 12)(*q.stride()[:3], *k.stride()[:3], *v.stride()[:3],
                                       *dout.stride()[:3])
    lib = _bwd_lib()
    with torch.cuda.device(q.device):
        err = lib.da4ml_flash_attention_bwd(
            _DTYPE_CODES[q.dtype], width, q.data_ptr(), k.data_ptr(), v.data_ptr(), o.data_ptr(),
            dout.data_ptr(), dq.data_ptr(), dk.data_ptr(), dv.data_ptr(), lse.data_ptr(),
            delta.data_ptr(), b, hq, hkv, sq, sk, strides, seq, scale, int(causal), off,
            plan.dkdv_blocks, plan.dq_blocks,
            torch.cuda.current_stream(q.device).cuda_stream,
        )
    if err != 0:
        msg = lib.da4ml_cuda_error_string(err).decode()
        raise KernelError(f"flash-attention backward launch failed: {msg} (cudaError {err})")
    bwd_launches.add()
    if width != d:
        return tuple(t[..., :d].contiguous() for t in (dq, dk, dv))
    return dq, dk, dv
