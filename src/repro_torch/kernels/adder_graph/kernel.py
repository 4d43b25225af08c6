"""Launch wrapper of the Hopper adder-graph kernel (``csrc/adder_graph.cu``).

It replaces the TPU kernel ``repro/kernels/adder_graph/kernel.py``
(``_adder_graph_kernel``, launched by ``adder_graph_pallas``).  The
wrapper checks what the kernel takes, picks the entry point and the
launch by ``slots.launch_plan``, allocates the output (and, for the
global-scratch entry point, the value scratch) with ``torch.empty``,
launches on the current stream, raises on a launch error, and counts
its launches in ``launches``.  Each launch is traced as an
``adder_graph`` device span (``repro_torch.obs.trace``).
Nothing is built on import: the library is built and loaded on the
first launch.
"""

from __future__ import annotations

import ctypes

import torch

from ...obs import trace
from .._build import KernelError, LaunchCounter, library, sm_count
from .slots import LaunchPlan, launch_plan

launches = LaunchCounter("adder_graph")

_c_int = ctypes.c_int
_c_ptr = ctypes.c_void_p
_EPILOGUE_ARGS = [_c_ptr, _c_int, _c_int, _c_int, _c_int]  # table, rows, floor, lo, hi
_NO_EPILOGUE = (None, 0, 0, 0, 0)


def _lib() -> ctypes.CDLL:
    lib = library("adder_graph")
    if lib.da4ml_adder_graph_smem.argtypes is None:
        lib.da4ml_adder_graph_smem.argtypes = [
            _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # x, ops, outs, level_starts
            _c_int, _c_int, _c_int, _c_int,  # n_levels, n_in, n_out, batch
            _c_int, _c_int, _c_int,  # n_slots, log2(tile), threads
            *_EPILOGUE_ARGS,
            _c_ptr, _c_ptr,  # y, stream
        ]
        lib.da4ml_adder_graph_smem.restype = _c_int
        lib.da4ml_adder_graph_global.argtypes = [
            _c_ptr, _c_ptr, _c_ptr, _c_ptr,  # x, instr, outs, level_starts
            _c_int, _c_int, _c_int, _c_int, _c_int,  # n_levels, n_in, n_out, batch, tile
            *_EPILOGUE_ARGS,
            _c_ptr, _c_ptr, _c_ptr,  # scratch, y, stream
        ]
        lib.da4ml_adder_graph_global.restype = _c_int
        lib.da4ml_cuda_error_string.argtypes = [_c_int]
        lib.da4ml_cuda_error_string.restype = ctypes.c_char_p
    return lib


def plan_for(tables, batch: int, device: torch.device) -> LaunchPlan:
    """The launch plan of ``tables`` at ``batch`` samples on ``device``."""
    return launch_plan(tables.slot_plan.n_slots, tables.n_ops, len(tables.level_bounds), batch,
                       sm_count(device))


def adder_graph_cuda(tables, x: torch.Tensor, epilogue=None) -> torch.Tensor:
    """Run the adder graph on the card.

    tables: AdderGraphTables; x: contiguous int32 CUDA tensor
    [batch, n_inputs]; epilogue: an ``ops.Epilogue`` applied to each
    output before its store, or None.  Returns int32 [batch, n_outputs]
    on x's device.  The launch plan (``slots.launch_plan``) picks the
    entry point.
    """
    if x.device.type != "cuda":
        raise ValueError(f"adder_graph_cuda takes a CUDA tensor, got one on {x.device}")
    if x.dtype != torch.int32:
        raise TypeError(f"adder_graph_cuda takes int32, got {x.dtype}")
    if x.dim() != 2 or x.shape[1] != tables.n_inputs:
        raise ValueError(
            f"adder_graph_cuda takes [batch, {tables.n_inputs}], got {tuple(x.shape)}"
        )
    if not x.is_contiguous():
        raise ValueError("adder_graph_cuda takes a contiguous tensor")
    epi = _NO_EPILOGUE
    if epilogue is not None:
        t = epilogue.table
        if (t.device != x.device or t.dtype != torch.int32 or not t.is_contiguous()
                or t.dim() != 3 or t.shape[1:] != (tables.n_outputs, 2)):
            raise ValueError(
                f"adder_graph_cuda takes an epilogue table of int32 [rows, {tables.n_outputs}, 2]"
                f" on {x.device}"
            )
        epi = (t.data_ptr(), t.shape[0], epilogue.floor, epilogue.lo, epilogue.hi)
    batch = x.shape[0]
    y = torch.empty((batch, tables.n_outputs), dtype=torch.int32, device=x.device)
    if batch == 0 or tables.n_outputs == 0:
        return y
    dev = tables.device_arrays(x.device)
    plan = plan_for(tables, batch, x.device)
    lib = _lib()
    stream = torch.cuda.current_stream(x.device).cuda_stream
    with (
        trace.span("adder_graph", device=x.device, table=tables.digest, n_in=tables.n_inputs,
                   n_out=tables.n_outputs, batch=batch, entry=plan.entry),
        torch.cuda.device(x.device),
    ):
        if plan.entry == "shared":
            err = lib.da4ml_adder_graph_smem(
                x.data_ptr(), dev.slot_ops.data_ptr(), dev.slot_outs.data_ptr(),
                dev.level_starts.data_ptr(), len(tables.level_bounds), tables.n_inputs,
                tables.n_outputs, batch, tables.slot_plan.n_slots,
                plan.tile.bit_length() - 1, plan.threads, *epi, y.data_ptr(), stream,
            )
        else:
            scratch = torch.empty((tables.n_rows, batch), dtype=torch.int32, device=x.device)
            err = lib.da4ml_adder_graph_global(
                x.data_ptr(), dev.instr.data_ptr(), dev.outs.data_ptr(),
                dev.level_starts.data_ptr(), len(tables.level_bounds), tables.n_inputs,
                tables.n_outputs, batch, plan.tile, *epi, scratch.data_ptr(), y.data_ptr(),
                stream,
            )
    if err != 0:
        msg = lib.da4ml_cuda_error_string(err).decode()
        raise KernelError(f"adder-graph kernel launch failed: {msg} (cudaError {err})")
    launches.add()
    return y
