"""Launch wrapper of the Hopper selective-scan kernel (``csrc/ssm_scan.cu``).

It replaces the TPU kernel ``repro/kernels/ssm_scan/kernel.py``
(``_ssm_kernel``, launched by ``selective_scan_pallas``).  The source
holds two kernels, decode (S == 1) and prefill (any other S);
``scan_kernel_for`` picks one from the shape alone.  The wrapper
checks what the kernels take, allocates ``y`` (and ``h_out`` unless the
caller gives one) with ``torch.empty``, launches on the current stream,
raises on a launch error, and counts its launches in ``launches`` (and
by kernel in ``kernel_launches``).  Nothing is built on import: the
library is built and loaded on the first launch.

``selective_scan_bwd_cuda`` launches the backward
(``csrc/ssm_scan_bwd.cu``, a library of its own: the reverse scan, then
a fixed-order reduction) and counts one launch per call in
``bwd_launches``.
"""

from __future__ import annotations

import ctypes

import torch

from .._build import KernelError, LaunchCounter, library

MAX_STATE = 16  # the state sizes N the kernel is compiled for: 1 .. 16
KERNELS = ("decode", "prefill")  # the source's kernels, in the C entry point's numbering

launches = LaunchCounter("ssm_scan")
# the same launches, by kernel
kernel_launches = {k: LaunchCounter(f"ssm_scan.{k}") for k in KERNELS}

_c_int = ctypes.c_int
_c_ll = ctypes.c_longlong
_c_ptr = ctypes.c_void_p


def _lib() -> ctypes.CDLL:
    lib = library("ssm_scan")
    if lib.da4ml_ssm_scan.argtypes is None:
        lib.da4ml_ssm_scan.argtypes = [
            _c_int,  # kernel: an index into KERNELS
            _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # dt, B, C, x, A, h0
            _c_ptr, _c_ptr,  # y, h_out
            _c_int, _c_int, _c_int, _c_int,  # B, S, D, N
            _c_ll, _c_ll, _c_ll, _c_ll,  # strides of B and C over batch and sequence
            _c_ptr,  # stream
        ]
        lib.da4ml_ssm_scan.restype = _c_int
        lib.da4ml_cuda_error_string.argtypes = [_c_int]
        lib.da4ml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def scan_kernel_for(s: int) -> str:
    """The kernel that a scan of S = s steps takes: ``"decode"`` for one
    step, ``"prefill"`` for any other length.  The choice depends on the
    shape alone, so calls capture into a CUDA graph."""
    return "decode" if s == 1 else "prefill"


def selective_scan_cuda(
    dt: torch.Tensor,  # f32 [B, S, D]
    bmat: torch.Tensor,  # f32 [B, S, N]
    cmat: torch.Tensor,  # f32 [B, S, N]
    x: torch.Tensor,  # f32 [B, S, D]
    a: torch.Tensor,  # f32 [D, N]
    h0: torch.Tensor,  # f32 [B, D, N]
    h_out: torch.Tensor | None = None,  # f32 [B, D, N]; may be h0 itself
):
    """The Mamba-1 recurrence on the card; returns (y [B, S, D], h_final
    [B, D, N]), with ``h_final`` written into ``h_out`` when one is given.

    All tensors are float32 CUDA tensors on one device.  dt, x, a, h0 and
    h_out are contiguous; bmat and cmat need only a unit stride on N (a
    slice of a wider projection is read in place).  N is 1 to 16.
    """
    named = {"dt": dt, "bmat": bmat, "cmat": cmat, "x": x, "a": a, "h0": h0}
    if h_out is not None:
        named["h_out"] = h_out
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != dt.device:
            raise ValueError(f"selective_scan_cuda takes CUDA tensors on one device, "
                             f"got {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"selective_scan_cuda takes float32, got {name} {t.dtype}")
        if t.dim() != (2 if name == "a" else 3):
            raise ValueError(f"selective_scan_cuda: {name} has shape {tuple(t.shape)}")
    b, s, d = dt.shape
    n = a.shape[1]
    want = {"dt": (b, s, d), "x": (b, s, d), "bmat": (b, s, n), "cmat": (b, s, n),
            "a": (d, n), "h0": (b, d, n), "h_out": (b, d, n)}
    for name, t in named.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"selective_scan_cuda: {name} {tuple(t.shape)}, want {want[name]}")
        if name in ("bmat", "cmat") and t.stride(2) != 1 and n > 1:
            raise ValueError(f"selective_scan_cuda needs a unit stride on {name}'s state dim")
        if name not in ("bmat", "cmat") and not t.is_contiguous():
            raise ValueError(f"selective_scan_cuda needs a contiguous {name}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan_cuda supports state sizes 1 to {MAX_STATE}, got {n}")
    if b > 65535:
        raise ValueError(f"selective_scan_cuda supports at most 65535 batch rows, got {b}")
    y = torch.empty((b, s, d), dtype=torch.float32, device=dt.device)
    if h_out is None:
        h_out = torch.empty_like(h0)
    if b == 0 or d == 0:
        return y, h_out
    lib = _lib()
    kernel = scan_kernel_for(s)
    with torch.cuda.device(dt.device):
        err = lib.da4ml_ssm_scan(
            KERNELS.index(kernel), dt.data_ptr(), bmat.data_ptr(),
            cmat.data_ptr(), x.data_ptr(), a.data_ptr(),
            h0.data_ptr(), y.data_ptr(), h_out.data_ptr(), b, s, d, n,
            bmat.stride(0), bmat.stride(1), cmat.stride(0), cmat.stride(1),
            torch.cuda.current_stream(dt.device).cuda_stream,
        )
    if err != 0:
        msg = lib.da4ml_cuda_error_string(err).decode()
        raise KernelError(f"selective-scan kernel launch failed: {msg} (cudaError {err})")
    launches.add()
    kernel_launches[kernel].add()
    return y, h_out


# ----------------------------------------------------------------------
# the backward (csrc/ssm_scan_bwd.cu)
# ----------------------------------------------------------------------
bwd_launches = LaunchCounter("ssm_scan_bwd")  # one per backward (its two kernels)


def _bwd_lib() -> ctypes.CDLL:
    lib = library("ssm_scan_bwd")
    if lib.da4ml_ssm_scan_bwd.argtypes is None:
        lib.da4ml_ssm_scan_bwd.argtypes = [
            *[_c_ptr] * 8,  # dt, B, C, x, A, h0, dy, dh (or null)
            *[_c_ptr] * 6,  # ddt, dB, dC, dx, dA, dh0
            _c_ptr,  # scratch
            _c_int, _c_int, _c_int, _c_int,  # B, S, D, N
            _c_ptr,  # stream
        ]
        lib.da4ml_ssm_scan_bwd.restype = _c_int
        lib.da4ml_ssm_scan_bwd_scratch.argtypes = [_c_int, _c_int, _c_int, _c_int]
        lib.da4ml_ssm_scan_bwd_scratch.restype = _c_ll
        lib.da4ml_cuda_error_string.argtypes = [_c_int]
        lib.da4ml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def selective_scan_bwd_cuda(
    dt: torch.Tensor,  # f32 [B, S, D]
    bmat: torch.Tensor,  # f32 [B, S, N]
    cmat: torch.Tensor,  # f32 [B, S, N]
    x: torch.Tensor,  # f32 [B, S, D]
    a: torch.Tensor,  # f32 [D, N]
    h0: torch.Tensor,  # f32 [B, D, N]
    dy: torch.Tensor,  # f32 [B, S, D]: the gradient of y
    dh: torch.Tensor | None = None,  # f32 [B, D, N]: of the final state (None: zero)
):
    """The gradient of ``selective_scan_cuda`` on the card: returns (ddt,
    dB, dC, dx, dA, dh0), contiguous f32.  dA sums over batch and time.
    Inputs of any strides are made contiguous first.  Deterministic: two
    calls give the same bits."""
    named = {"dt": dt, "bmat": bmat, "cmat": cmat, "x": x, "a": a, "h0": h0, "dy": dy}
    if dh is not None:
        named["dh"] = dh
    for name, t in named.items():
        if t.device.type != "cuda" or t.device != dt.device:
            raise ValueError(f"selective_scan_bwd_cuda takes CUDA tensors on one device, "
                             f"got {name} on {t.device}")
        if t.dtype != torch.float32:
            raise TypeError(f"selective_scan_bwd_cuda takes float32, got {name} {t.dtype}")
    b, s, d = dt.shape
    n = a.shape[1]
    want = {"dt": (b, s, d), "x": (b, s, d), "dy": (b, s, d), "bmat": (b, s, n),
            "cmat": (b, s, n), "a": (d, n), "h0": (b, d, n), "dh": (b, d, n)}
    for name, t in named.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"selective_scan_bwd_cuda: {name} {tuple(t.shape)}, "
                             f"want {want[name]}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan_bwd_cuda supports state sizes 1 to {MAX_STATE}, "
                         f"got {n}")
    if b > 65535:
        raise ValueError(f"selective_scan_bwd_cuda supports at most 65535 batch rows, got {b}")
    dt, bmat, cmat, x, a, h0, dy = (t.contiguous() for t in (dt, bmat, cmat, x, a, h0, dy))
    dh = None if dh is None else dh.contiguous()
    outs = [torch.empty_like(t) for t in (dt, bmat, cmat, x, a, h0)]
    if b == 0 or s == 0 or d == 0:
        for t in outs:
            t.zero_()
        if s == 0 and dh is not None:  # no step: dh0 is dh
            outs[-1].copy_(dh)
        return tuple(outs)
    lib = _bwd_lib()
    scratch = torch.empty(lib.da4ml_ssm_scan_bwd_scratch(b, s, d, n), dtype=torch.float32,
                          device=dt.device)
    with torch.cuda.device(dt.device):
        err = lib.da4ml_ssm_scan_bwd(
            *(t.data_ptr() for t in (dt, bmat, cmat, x, a, h0, dy)),
            None if dh is None else dh.data_ptr(),
            *(t.data_ptr() for t in outs), scratch.data_ptr(), b, s, d, n,
            torch.cuda.current_stream(dt.device).cuda_stream,
        )
    if err != 0:
        msg = lib.da4ml_cuda_error_string(err).decode()
        raise KernelError(f"selective-scan backward launch failed: {msg} (cudaError {err})")
    bwd_launches.add()
    return tuple(outs)
