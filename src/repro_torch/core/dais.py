"""DAIS — Distributed Arithmetic Instruction Set (paper §5.2).

A DAIS program is a static-single-assignment list of shift-add operations
that directly describes a combinational circuit.  Every value is a row in
the program; every non-input row is one two-operand adder/subtractor of
the canonical form

    u = (a << sh_a)  +/-  (b << sh_b)          (sh_a, sh_b >= 0, min == 0)

plus a rare unary negation ``u = -a`` (realised in hardware as ``0 - a``
and therefore costed as an adder).  Outputs are *terms*: a row reference
with a free power-of-two scale and a sign, ``y = sign * (row << shift)``
(shift may be negative for fractional fixed point).

The program carries exact quantized intervals (:class:`QInterval`) and
adder depths per row, which drive the paper's cost model (Eq. 1) and the
delay-constraint machinery.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

from .fixed_point import QInterval

KIND_INPUT = 0
KIND_ADD = 1  # u = (a << sh_a) + sign * (b << sh_b)
KIND_NEG = 2  # u = -a


def qints_to_array(qints: list[QInterval]) -> np.ndarray:
    """Pack QIntervals into an int64 [n, 3] (lo, hi, exp) array.

    Shared serialization helper for the solution cache and the design
    artifact format.  Raises ``OverflowError`` when an endpoint does not
    fit in int64 (callers then skip serialization)."""
    lim = 1 << 62
    out = np.empty((len(qints), 3), dtype=np.int64)
    for i, q in enumerate(qints):
        if not (-lim < q.lo <= q.hi < lim):
            raise OverflowError("qint endpoints exceed int64 range")
        out[i] = (q.lo, q.hi, q.exp)
    return out


def qints_from_array(arr: np.ndarray) -> list[QInterval]:
    """Exact inverse of :func:`qints_to_array`."""
    return [
        QInterval(lo, hi, exp)
        for lo, hi, exp in np.asarray(arr, dtype=np.int64).tolist()
    ]


@dataclass
class Row:
    kind: int
    a: int = -1
    b: int = -1
    sh_a: int = 0
    sh_b: int = 0
    sign: int = 1  # sign applied to operand b
    qint: QInterval = QInterval(0, 0, 0)
    depth: int = 0
    cost: int = 0  # full/half adder bits (Eq. 1)


@dataclass(frozen=True)
class Term:
    """A value reference: ``sign * (row << shift)``."""

    sign: int
    row: int
    shift: int


@dataclass
class DAISProgram:
    """SSA shift-add program with per-row interval/depth metadata."""

    rows: list[Row] = field(default_factory=list)
    n_inputs: int = 0
    # One entry per output; None encodes the constant 0 output.
    outputs: list[Term | None] = field(default_factory=list)

    # ------------------------------------------------------------------
    # Construction
    # ------------------------------------------------------------------
    def add_input(self, qint: QInterval, depth: int = 0) -> int:
        if any(r.kind != KIND_INPUT for r in self.rows):
            raise ValueError("inputs must be added before ops")
        self.rows.append(Row(KIND_INPUT, qint=qint, depth=depth))
        self.n_inputs += 1
        return len(self.rows) - 1

    def add_op(self, a: int, b: int, sh_a: int, sh_b: int, sign: int) -> int:
        """Append ``u = (a << sh_a) + sign * (b << sh_b)``; returns row idx.

        The interval and cost arithmetic is inlined (equivalent to
        ``qint_add_shifted`` + ``adder_cost`` on the shifted qints, with
        operands pre-shifted so the cost model sees zero shifts): this is
        the solver's per-adder hot path, and constructing the
        intermediate shifted QIntervals dominated its runtime.
        """
        if min(sh_a, sh_b) != 0:
            # normalise: factor out the common power of two (free shift)
            m = min(sh_a, sh_b)
            sh_a, sh_b = sh_a - m, sh_b - m
        ra, rb = self.rows[a], self.rows[b]
        qA, qB = ra.qint, rb.qint
        alo, ahi = qA.lo, qA.hi
        blo, bhi = qB.lo, qB.hi
        az = alo == 0 == ahi
        bz = blo == 0 == bhi
        # QInterval.shift keeps exp unchanged on zero intervals
        aexp = qA.exp if az else qA.exp + sh_a
        bexp = qB.exp if bz else qB.exp + sh_b
        if bz:
            qint = QInterval(alo, ahi, aexp)
            cost = 0
        elif az:
            qint = (
                QInterval(blo, bhi, bexp) if sign > 0 else QInterval(-bhi, -blo, bexp)
            )
            cost = 0
        else:
            exp = aexp if aexp <= bexp else bexp
            al, ah = alo << (aexp - exp), ahi << (aexp - exp)
            bl, bh = blo << (bexp - exp), bhi << (bexp - exp)
            if sign > 0:
                qint = QInterval(al + bl, ah + bh, exp)
            else:
                qint = QInterval(al - bh, ah - bl, exp)
            # two's-complement widths (QInterval.width inlined)
            if alo < 0:
                mag = ahi if ahi > -alo - 1 else -alo - 1
                wa = mag.bit_length() + 1 if mag > 0 else 1
            else:
                wa = ahi.bit_length()
            if blo < 0:
                mag = bhi if bhi > -blo - 1 else -blo - 1
                wb = mag.bit_length() + 1 if mag > 0 else 1
            else:
                wb = bhi.bit_length()
            amsb = aexp + wa - 1
            bmsb = bexp + wb - 1
            msb = amsb if amsb >= bmsb else bmsb
            lsb_hi = aexp if aexp >= bexp else bexp
            lsb_lo = aexp if aexp <= bexp else bexp
            # disjoint ranges: splice, not adder logic (see adder_cost)
            cost = 1 if lsb_hi > msb else msb - lsb_lo + 2
        depth = max(ra.depth, rb.depth) + 1
        self.rows.append(Row(KIND_ADD, a, b, sh_a, sh_b, sign, qint, depth, cost))
        return len(self.rows) - 1

    def add_neg(self, a: int) -> int:
        ra = self.rows[a]
        self.rows.append(
            Row(KIND_NEG, a, -1, 0, 0, -1, ra.qint.neg(), ra.depth + 1, ra.qint.width + 1)
        )
        return len(self.rows) - 1

    # ------------------------------------------------------------------
    # Stats
    # ------------------------------------------------------------------
    @property
    def n_adders(self) -> int:
        return sum(1 for r in self.rows if r.kind != KIND_INPUT)

    @property
    def depth(self) -> int:
        """Longest adder path from any input to any output."""
        d = 0
        for t in self.outputs:
            if t is not None:
                d = max(d, self.rows[t.row].depth)
        return d

    @property
    def cost_bits(self) -> int:
        """Total full/half-adder bit cost (proxy for FPGA LUTs)."""
        return sum(r.cost for r in self.rows if r.kind != KIND_INPUT)

    def output_qints(self) -> list[QInterval]:
        """Intervals of the *evaluated* outputs, on the evaluation grid.

        ``evaluate`` (and the adder-graph kernel) returns integers with the
        term shift already applied, i.e. on the term's row grid — so the
        interval endpoints are shifted while ``exp`` stays the row's.
        """
        out = []
        for t in self.outputs:
            if t is None:
                out.append(QInterval(0, 0, 0))
            else:
                q = self.rows[t.row].qint
                if t.shift >= 0:
                    q = QInterval(q.lo << t.shift, q.hi << t.shift, q.exp)
                else:
                    q = QInterval(q.lo >> (-t.shift), q.hi >> (-t.shift), q.exp)
                out.append(q.neg() if t.sign < 0 else q)
        return out

    def output_depths(self) -> list[int]:
        return [0 if t is None else self.rows[t.row].depth for t in self.outputs]

    # ------------------------------------------------------------------
    # Pruning
    # ------------------------------------------------------------------
    def prune(self) -> "DAISProgram":
        """Drop rows not reachable from any output (keep all inputs)."""
        live = [False] * len(self.rows)
        stack = [t.row for t in self.outputs if t is not None]
        while stack:
            i = stack.pop()
            if live[i]:
                continue
            live[i] = True
            r = self.rows[i]
            if r.kind != KIND_INPUT:
                stack.append(r.a)
                if r.kind == KIND_ADD:
                    stack.append(r.b)
        remap: dict[int, int] = {}
        new = DAISProgram()
        rows = new.rows
        for i, r in enumerate(self.rows):
            if r.kind == KIND_INPUT:
                remap[i] = len(rows)
                rows.append(Row(KIND_INPUT, qint=r.qint, depth=r.depth))
                new.n_inputs += 1
            elif live[i]:
                # qint/depth/cost are invariant under pruning: copy the row
                # with remapped operands instead of recomputing through
                # add_op (which would redo the exact interval arithmetic)
                remap[i] = len(rows)
                b = remap[r.b] if r.kind == KIND_ADD else -1
                rows.append(
                    Row(r.kind, remap[r.a], b, r.sh_a, r.sh_b, r.sign,
                        r.qint, r.depth, r.cost)
                )
        new.outputs = [
            None if t is None else Term(t.sign, remap[t.row], t.shift) for t in self.outputs
        ]
        return new

    # ------------------------------------------------------------------
    # Array round-trip (solution cache / disk serialization)
    # ------------------------------------------------------------------
    def to_arrays(self) -> dict[str, np.ndarray]:
        """Pack the program into plain int64 numpy arrays.

        The row table stores (kind, a, b, sh_a, sh_b, sign, depth, cost,
        q_lo, q_hi, q_exp); outputs store (present, sign, row, shift).
        Exact round-trip via :meth:`from_arrays` — qints are stored, not
        recomputed.  Raises ``OverflowError`` if an interval endpoint does
        not fit in int64 (callers should then skip caching).
        """
        lim = 1 << 62
        rows = np.empty((len(self.rows), 11), dtype=np.int64)
        for i, r in enumerate(self.rows):
            q = r.qint
            if not (-lim < q.lo <= q.hi < lim):
                raise OverflowError("qint endpoints exceed int64 range")
            rows[i] = (
                r.kind, r.a, r.b, r.sh_a, r.sh_b, r.sign, r.depth, r.cost,
                q.lo, q.hi, q.exp,
            )
        outs = np.zeros((len(self.outputs), 4), dtype=np.int64)
        for i, t in enumerate(self.outputs):
            if t is not None:
                outs[i] = (1, t.sign, t.row, t.shift)
        return {
            "rows": rows,
            "outputs": outs,
            "n_inputs": np.array([self.n_inputs], dtype=np.int64),
        }

    @staticmethod
    def from_arrays(arrays: dict[str, np.ndarray]) -> "DAISProgram":
        """Exact inverse of :meth:`to_arrays`."""
        prog = DAISProgram()
        prog.n_inputs = int(arrays["n_inputs"][0])
        for row in np.asarray(arrays["rows"], dtype=np.int64).tolist():
            kind, a, b, sh_a, sh_b, sign, depth, cost, lo, hi, exp = row
            prog.rows.append(
                Row(kind, a, b, sh_a, sh_b, sign, QInterval(lo, hi, exp), depth, cost)
            )
        prog.outputs = [
            Term(sign, row, shift) if present else None
            for present, sign, row, shift in
            np.asarray(arrays["outputs"], dtype=np.int64).tolist()
        ]
        return prog

    # ------------------------------------------------------------------
    # Evaluation (exact, integer)
    # ------------------------------------------------------------------
    def evaluate(self, x: np.ndarray) -> np.ndarray:
        """Evaluate the program on integer inputs.

        ``x``: int array [..., n_inputs] on the *integer grid* of each
        input's qint (i.e. x_real = x * 2^exp).  Returns the outputs as
        int64 on the grids given by :meth:`output_qints` — concretely,
        output j equals ``sign * (value_row << shift)`` computed exactly,
        with negative shifts handled by the caller via the qint exps.
        Here all shifts produced by the solver on the integer grid are
        non-negative, so plain int64 shifts are exact.
        """
        x = np.asarray(x)
        if x.shape[-1] != self.n_inputs:
            raise ValueError(f"expected {self.n_inputs} inputs, got {x.shape[-1]}")
        vals: list[np.ndarray] = []
        for i, r in enumerate(self.rows):
            if r.kind == KIND_INPUT:
                vals.append(x[..., i].astype(np.int64))
            elif r.kind == KIND_ADD:
                vals.append((vals[r.a] << r.sh_a) + r.sign * (vals[r.b] << r.sh_b))
            else:
                vals.append(-vals[r.a])
        outs = []
        zero = np.zeros(x.shape[:-1], dtype=np.int64)
        for t in self.outputs:
            if t is None:
                outs.append(zero)
            elif t.shift >= 0:
                outs.append(t.sign * (vals[t.row] << t.shift))
            else:
                outs.append(t.sign * (vals[t.row] >> (-t.shift)))
        return np.stack(outs, axis=-1)

    # ------------------------------------------------------------------
    # Levelisation (for the adder-graph kernel)
    # ------------------------------------------------------------------
    def levelize(self) -> list[list[int]]:
        """Group op row indices by adder depth (ascending)."""
        by_depth: dict[int, list[int]] = {}
        for i, r in enumerate(self.rows):
            if r.kind != KIND_INPUT:
                by_depth.setdefault(r.depth, []).append(i)
        return [by_depth[d] for d in sorted(by_depth)]
