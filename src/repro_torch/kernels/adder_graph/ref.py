"""Plain PyTorch version of the levelized adder-graph executor.

The same arithmetic as the Hopper kernel and as the JAX package's
``adder_graph_ref``: int32 values with wraparound, a left shift of 32 or
more gives 0 and an arithmetic right shift of 32 or more gives the sign
fill (PyTorch defines both shifts so, on the CPU and on CUDA).  The
same holds for the optional epilogue (``ops.Epilogue``).  The wrapper
uses it for CPU tensors; the tests and the card's smoke test
hold the kernel against it.
"""

from __future__ import annotations

import torch


def adder_graph_ref(tables, x: torch.Tensor, epilogue=None) -> torch.Tensor:
    """tables: AdderGraphTables; x: int32 [batch, n_inputs] on any
    device; epilogue: an ``ops.Epilogue`` or None (:func:`epilogue_ref`).
    Returns int32 [batch, n_outputs] on x's device."""
    dev = tables.device_arrays(x.device)
    v = x.t().to(torch.int32)  # [n_rows so far, batch]
    for lo, hi in tables.level_bounds:
        ops = dev.instr[lo:hi]
        a = v[ops[:, 0]] << ops[:, 2:3]
        b = v[ops[:, 1]] << ops[:, 3:4]
        v = torch.cat([v, a + ops[:, 4:5] * b])
    outs = dev.outs
    y = v[outs[:, 0]]
    shift = outs[:, 1:2]
    y = torch.where(shift >= 0, y << shift.clamp(min=0), y >> (-shift).clamp(min=0))
    y = y * outs[:, 2:3] * outs[:, 3:4]
    y = y.t().contiguous()
    return y if epilogue is None else epilogue_ref(y, epilogue)


def epilogue_ref(y: torch.Tensor, epilogue) -> torch.Tensor:
    """The kernel's epilogue on its int32 outputs y [batch, n_out]: row b
    takes the table's row ``b % rows``."""
    t = epilogue.table[torch.arange(y.shape[0], device=y.device) % epilogue.table.shape[0]]
    bias, packed = t[..., 0], t[..., 1]
    d = packed >> 8
    y = torch.clamp((y << (packed & 0xFF)) + bias, min=epilogue.floor)
    y = torch.where(d > 0, y << d.clamp(min=0), y >> (-d).clamp(min=0))
    return y.clamp(epilogue.lo, epilogue.hi)
