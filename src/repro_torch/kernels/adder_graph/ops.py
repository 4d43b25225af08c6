"""DAIS -> levelized instruction tables, and the CMVM entry point that
routes a tensor to the Hopper kernel (``kernel.py``) or, on the CPU, to
the plain PyTorch version (``ref.py``)."""

from __future__ import annotations

import hashlib
from dataclasses import dataclass, field
from typing import NamedTuple

import numpy as np
import torch

from ...core.dais import KIND_ADD, KIND_INPUT, KIND_NEG, DAISProgram
from .kernel import adder_graph_cuda
from .ref import adder_graph_ref
from .slots import SlotPlan, plan_slots


INT32_MIN, INT32_MAX = -(2**31), 2**31 - 1


class Epilogue(NamedTuple):
    """Elementwise steps applied to each output of a launch before its
    store, in int32 with wraparound: for output j of row b, with
    ``(bias, packed) = table[b % rows, j]``,
    ``y = max((y << (packed & 0xff)) + bias, floor)``, then ``y`` shifted
    by ``d = packed >> 8`` (left for d > 0, arithmetic right otherwise),
    then clamped to ``[lo, hi]``.  :func:`epilogue_table` builds the
    table; the defaults leave a value as it is."""

    table: torch.Tensor  # int32 [rows, n_out, 2]
    floor: int = INT32_MIN
    lo: int = INT32_MIN
    hi: int = INT32_MAX


def _saturated(s: np.ndarray) -> np.ndarray:
    """Shift amounts as PyTorch's int32 shifts read them: one below 0 or
    above 31 acts as 32 (a left shift gives 0, a right one the sign fill)."""
    s = np.asarray(s).astype(np.int32).astype(np.int64)
    return np.where((s >= 0) & (s < 32), s, 32)


def epilogue_table(n_out: int, shift=None, bias=None, d=None) -> np.ndarray:
    """The int32 [rows, n_out, 2] table of an :class:`Epilogue`.

    shift, bias: [n_out] (the left shift, then the bias added, of each
    output); d: [rows, n_out] requant shifts (left by d for d > 0, else
    arithmetic right by -d), or None.  Each integer is first cast to int32
    as the executor's steps cast it.  Rows that are all alike collapse to
    one."""
    sh = _saturated(np.zeros(n_out) if shift is None else shift)
    b = np.zeros(n_out, np.int64) if bias is None else np.asarray(bias).astype(np.int32)
    if d is None:
        dd = np.zeros((1, n_out), np.int64)
    else:
        d = np.asarray(d, np.int64).reshape(-1, n_out)
        dpos = np.maximum(d, 0).astype(np.int32)
        dd = np.where(dpos > 0, _saturated(dpos), -_saturated(np.maximum(-d, 0)))
        if (dd == dd[:1]).all():
            dd = dd[:1]
    packed = sh[None, :] | (dd << 8)
    return np.stack([np.broadcast_to(b, dd.shape), packed], axis=-1).astype(np.int32)


class DeviceTables(NamedTuple):
    """The tables as int32 tensors on one device."""

    instr: torch.Tensor  # [n_ops, 5]
    outs: torch.Tensor  # [n_out, 4]
    level_starts: torch.Tensor  # [n_levels + 1]: level k is instr[starts[k]:starts[k+1]]
    slot_ops: torch.Tensor  # [n_ops, 4]: the slot plan's instructions (shared-memory kernel)
    slot_outs: torch.Tensor  # [n_out, 4]: the slot plan's output table


@dataclass(frozen=True)
class AdderGraphTables:
    """Levelized instruction tables.

    instr : int32 [n_ops, 5] -- (a_idx, b_idx, sh_a, sh_b, sign), rows
            ordered level-contiguously; ops of level k only reference
            rows produced before level k (inputs are rows [0, n_inputs),
            op i writes row n_inputs + i).
    level_bounds : (lo, hi) op ranges per level, as Python ints.
    outs  : int32 [n_out, 4] -- (row, shift, sign, mask); a negative
            shift is an arithmetic right shift, mask zeroes the constant-0
            outputs.
    digest : sha256 over every field that determines execution; the same
            program gives the same digest here and in the JAX package.
            Hash and equality key on it.  The arrays are frozen read-only
            to keep it truthful.

    :meth:`device_arrays` keeps one copy of the tables per device, made
    on first use, so a call never copies them again; with them the slot
    plan of the shared-memory kernel (:attr:`slot_plan`), which is
    derived from the fields above and enters neither them nor the digest.
    """

    n_inputs: int
    n_rows: int
    level_bounds: tuple[tuple[int, int], ...]
    instr: np.ndarray = field(repr=False)
    outs: np.ndarray = field(repr=False)
    digest: str = ""

    def __post_init__(self):
        if not self.digest:
            object.__setattr__(self, "digest", self._content_digest())
        for arr in (self.instr, self.outs):
            arr.setflags(write=False)
        object.__setattr__(self, "_on_device", {})

    def _content_digest(self) -> str:
        h = hashlib.sha256(b"adder-graph-tables-v1")
        h.update(np.array([self.n_inputs, self.n_rows], np.int64).tobytes())
        h.update(repr(self.level_bounds).encode())
        h.update(np.ascontiguousarray(self.instr).tobytes())
        h.update(np.ascontiguousarray(self.outs).tobytes())
        return h.hexdigest()

    def __hash__(self):
        return hash(self.digest)

    def __eq__(self, other):
        return isinstance(other, AdderGraphTables) and self.digest == other.digest

    @property
    def n_ops(self) -> int:
        return int(self.instr.shape[0])

    @property
    def n_outputs(self) -> int:
        return int(self.outs.shape[0])

    @property
    def slot_plan(self) -> SlotPlan:
        """Each row's slot in the shared-memory kernel (planned once)."""
        plan = self.__dict__.get("_slot_plan")
        if plan is None:
            plan = plan_slots(self)
            object.__setattr__(self, "_slot_plan", plan)
        return plan

    def device_arrays(self, device: torch.device) -> DeviceTables:
        """The tables and their slot plan on ``device`` (copied there
        once, then reused)."""
        cache = self._on_device  # type: ignore[attr-defined]
        dev = cache.get(device)
        if dev is None:
            starts = [lo for lo, _ in self.level_bounds[:1]] + [hi for _, hi in self.level_bounds]
            plan = self.slot_plan
            dev = DeviceTables(
                torch.tensor(self.instr, dtype=torch.int32, device=device).reshape(-1, 5),
                torch.tensor(self.outs, dtype=torch.int32, device=device).reshape(-1, 4),
                torch.tensor(starts or [0], dtype=torch.int32, device=device),
                torch.tensor(plan.ops, dtype=torch.int32, device=device).reshape(-1, 4),
                torch.tensor(plan.outs, dtype=torch.int32, device=device).reshape(-1, 4),
            )
            dev = cache.setdefault(device, dev)
        return dev


def compile_tables(prog: DAISProgram) -> AdderGraphTables:
    """Reorder a DAIS program level-contiguously and pack instruction
    tables.  Negation rows are lowered onto the add/sub datapath as
    ``u = (a << 0) - (a << 1) = -a``.  Raises ``ValueError`` on a
    negative operand shift, which the kernel does not take."""
    order = sorted(
        range(len(prog.rows)),
        key=lambda i: (prog.rows[i].kind != KIND_INPUT, prog.rows[i].depth, i),
    )
    remap = {old: new for new, old in enumerate(order)}
    n_inputs = prog.n_inputs

    by_depth: dict[int, list[int]] = {}
    for i in order:
        r = prog.rows[i]
        if r.kind != KIND_INPUT:
            by_depth.setdefault(r.depth, []).append(i)

    instr_rows: list[tuple[int, int, int, int, int]] = []
    bounds: list[tuple[int, int]] = []
    for d in sorted(by_depth):
        lo = len(instr_rows)
        for i in by_depth[d]:
            r = prog.rows[i]
            if r.kind == KIND_ADD:
                if r.sh_a < 0 or r.sh_b < 0:
                    raise ValueError(f"row {i}: negative operand shift ({r.sh_a}, {r.sh_b})")
                instr_rows.append((remap[r.a], remap[r.b], r.sh_a, r.sh_b, r.sign))
            elif r.kind == KIND_NEG:
                instr_rows.append((remap[r.a], remap[r.a], 0, 1, -1))
            else:
                raise ValueError(f"row {i}: unknown row kind {r.kind}")
        bounds.append((lo, len(instr_rows)))

    instr = np.array(instr_rows, dtype=np.int32).reshape(-1, 5)
    # level contiguity: every operand is a row written before its level
    start = n_inputs
    for lo, hi in bounds:
        if hi > lo and instr[lo:hi, :2].max() >= start:
            raise ValueError("program is not levelized: an operand is produced in its own level")
        start += hi - lo

    outs = []
    for t in prog.outputs:
        if t is None:
            outs.append((0, 0, 1, 0))
        else:
            outs.append((remap[t.row], t.shift, t.sign, 1))
    return AdderGraphTables(
        n_inputs=n_inputs,
        n_rows=len(prog.rows),
        level_bounds=tuple(bounds),
        instr=instr,
        outs=np.array(outs, dtype=np.int32).reshape(-1, 4),
    )


def adder_graph_apply(
    tables: AdderGraphTables, x: torch.Tensor, epilogue: Epilogue | None = None
) -> torch.Tensor:
    """Evaluate ``y = x @ M`` through the adder graph.

    x: int tensor [..., n_inputs] on the integer grid.  Returns int32
    [..., n_outputs] on x's device.  A CUDA tensor always goes to the
    Hopper kernel; a CPU tensor to the plain PyTorch version.  An
    ``epilogue`` (its table on x's device) is applied to each output
    before it is stored; its rows count the rows of x flattened to
    [-1, n_inputs].
    """
    lead = x.shape[:-1]
    x2 = x.reshape(-1, x.shape[-1]).to(torch.int32).contiguous()
    if x2.device.type == "cuda":
        y = adder_graph_cuda(tables, x2, epilogue)
    elif x2.device.type == "cpu":
        y = adder_graph_ref(tables, x2, epilogue)
    else:
        raise ValueError(f"adder_graph_apply: unsupported device {x2.device}")
    return y.reshape(*lead, y.shape[-1])
