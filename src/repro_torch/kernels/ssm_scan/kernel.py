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

On the training path the kernel also writes the state at the start of
every ``CHUNK`` steps into a ``chunk_states`` tensor the caller gives
(serving gives none, and the kernel is passed a null pointer).
``selective_scan_bwd_cuda`` launches the backward
(``csrc/ssm_scan_bwd.cu``, a library of its own: the reverse scan from
those states, then a fixed-order reduction; its sizes from
:func:`scan_bwd_plan`) and counts one launch per call in
``bwd_launches``.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple

import torch

from .._build import KernelError, LaunchCounter, library

MAX_STATE = 16  # the state sizes N the kernel is compiled for: 1 .. 16
CHUNK = 8  # steps between the chunk-start states of the training path
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
            _c_ptr,  # chunk_states (or null: serving)
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
    chunk_states: torch.Tensor | None = None,  # f32 [B, ceil(S / CHUNK), D, N]
):
    """The Mamba-1 recurrence on the card; returns (y [B, S, D], h_final
    [B, D, N]), with ``h_final`` written into ``h_out`` when one is given.

    All tensors are float32 CUDA tensors on one device.  dt, x, a, h0 and
    h_out are contiguous; bmat and cmat need only a unit stride on N (a
    slice of a wider projection is read in place).  N is 1 to 16.
    ``chunk_states``, where given (the training path), is a contiguous
    tensor of :func:`chunk_states_shape` that receives the state at the
    start of every ``CHUNK`` steps (chunk 0's is h0) for
    :func:`selective_scan_bwd_cuda`; the kernel, its outputs and their bits
    are serving's.
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
    if chunk_states is not None and (
            chunk_states.device != dt.device or chunk_states.dtype != torch.float32
            or tuple(chunk_states.shape) != chunk_states_shape(b, s, d, n)
            or not chunk_states.is_contiguous()):
        raise ValueError(f"chunk_states must be a contiguous float32 "
                         f"{chunk_states_shape(b, s, d, n)} on dt's device")
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
            h0.data_ptr(), y.data_ptr(), h_out.data_ptr(),
            None if chunk_states is None else chunk_states.data_ptr(), b, s, d, n,
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
BWD_THREADS = 256  # per block of the reverse scan


def chunk_states_shape(b: int, s: int, d: int, n: int) -> tuple[int, int, int, int]:
    """The training path's chunk-start states: [B, ceil(S / CHUNK), D, N]."""
    return (b, -(-s // CHUNK), d, n)


class ScanBwdPlan(NamedTuple):
    """The scan backward's launch and scratch sizes."""

    lanes: int  # lanes per channel (each holds 4 states)
    channels: int  # channels per block
    blocks: int  # blocks per batch row (the grid is blocks x B)
    part_bc: int  # floats of each of the dB and dC partials: [B, blocks, S, N]
    part_a: int  # floats of the dA partial: [B, D, N]
    smem_bytes: int  # dynamic shared memory per block

    @property
    def scratch(self) -> int:
        return 2 * self.part_bc + self.part_a


def scan_bwd_plan(b: int, s: int, d: int, n: int) -> ScanBwdPlan:
    """Sizes of the reverse-scan kernel for dt [b, s, d] and N = n states,
    from the shapes alone (mirrored by ``csrc/ssm_scan_bwd.cu``, which
    checks the block count): 1, 2 or 4 lanes a channel (N <= 4, 8, 16),
    256 threads a block; per block two buffers of a chunk's dt, x, dy (per
    channel), B and C (per padded state), and the chunk's per-channel dB and
    dC contributions (rows padded by one word)."""
    lanes = 1 if n <= 4 else (2 if n <= 8 else 4)
    ch = BWD_THREADS // lanes
    n_pad = 4 * lanes
    blocks = -(-d // ch)
    smem = 4 * (2 * CHUNK * (3 * ch + 2 * n_pad) + 2 * CHUNK * n_pad * (ch + 1))
    return ScanBwdPlan(lanes, ch, blocks, b * blocks * s * n, b * d * n, smem)


def _bwd_lib() -> ctypes.CDLL:
    lib = library("ssm_scan_bwd")
    if lib.da4ml_ssm_scan_bwd.argtypes is None:
        lib.da4ml_ssm_scan_bwd.argtypes = [
            *[_c_ptr] * 8,  # dt, B, C, x, A, dy, dh (or null), chunk_states
            *[_c_ptr] * 6,  # ddt, dB, dC, dx, dA, dh0
            *[_c_ptr] * 3,  # the dB, dC and dA partials
            _c_int, _c_int, _c_int, _c_int,  # B, S, D, N
            _c_int,  # the plan's blocks per batch row
            _c_ptr,  # stream
        ]
        lib.da4ml_ssm_scan_bwd.restype = _c_int
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
    dh: torch.Tensor | None,  # f32 [B, D, N]: of the final state (None: zero)
    chunk_states: torch.Tensor,  # the forward's, from selective_scan_cuda(chunk_states=)
):
    """The gradient of ``selective_scan_cuda`` on the card: returns (ddt,
    dB, dC, dx, dA, dh0), contiguous f32.  dA sums over batch and time.
    ``chunk_states`` are the states the forward wrote for the same inputs.
    Inputs of any strides are made contiguous first.  Deterministic: two
    calls give the same bits."""
    named = {"dt": dt, "bmat": bmat, "cmat": cmat, "x": x, "a": a, "h0": h0, "dy": dy,
             "chunk_states": chunk_states}
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
            "cmat": (b, s, n), "a": (d, n), "h0": (b, d, n), "dh": (b, d, n),
            "chunk_states": chunk_states_shape(b, s, d, n)}
    for name, t in named.items():
        if tuple(t.shape) != want[name]:
            raise ValueError(f"selective_scan_bwd_cuda: {name} {tuple(t.shape)}, "
                             f"want {want[name]}")
    if not 1 <= n <= MAX_STATE:
        raise ValueError(f"selective_scan_bwd_cuda supports state sizes 1 to {MAX_STATE}, "
                         f"got {n}")
    if b > 65535:
        raise ValueError(f"selective_scan_bwd_cuda supports at most 65535 batch rows, got {b}")
    dt, bmat, cmat, x, a, dy, chunk_states = (
        t.contiguous() for t in (dt, bmat, cmat, x, a, dy, chunk_states))
    dh = None if dh is None else dh.contiguous()
    outs = [torch.empty_like(t) for t in (dt, bmat, cmat, x, a, h0)]
    if b == 0 or s == 0 or d == 0:
        for t in outs:
            t.zero_()
        if s == 0 and dh is not None:  # no step: dh0 is dh
            outs[-1].copy_(dh)
        return tuple(outs)
    plan = scan_bwd_plan(b, s, d, n)
    scratch = torch.empty(plan.scratch, dtype=torch.float32, device=dt.device)
    part_b, part_c, part_a = scratch.split([plan.part_bc, plan.part_bc, plan.part_a])
    lib = _bwd_lib()
    with torch.cuda.device(dt.device):
        err = lib.da4ml_ssm_scan_bwd(
            *(t.data_ptr() for t in (dt, bmat, cmat, x, a, dy)),
            None if dh is None else dh.data_ptr(), chunk_states.data_ptr(),
            *(t.data_ptr() for t in outs), part_b.data_ptr(), part_c.data_ptr(),
            part_a.data_ptr(), b, s, d, n, plan.blocks,
            torch.cuda.current_stream(dt.device).cuda_stream,
        )
    if err != 0:
        msg = lib.da4ml_cuda_error_string(err).decode()
        raise KernelError(f"selective-scan backward launch failed: {msg} (cudaError {err})")
    bwd_launches.add()
    return tuple(outs)
