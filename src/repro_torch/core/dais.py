"""DAIS — Distributed Arithmetic Instruction Set (paper §5.2).

A DAIS program is a static-single-assignment list of shift-add
operations.  Every value is a row; every non-input row is one adder of
the form

    u = (a << sh_a)  +/-  (b << sh_b)          (sh_a, sh_b >= 0, min == 0)

or a negation ``u = -a``.  Outputs are terms ``y = sign * (row << shift)``
(shift may be negative: an arithmetic right shift).  Rows carry exact
quantized intervals and adder depths; ``compile_tables`` levelizes a
program by depth for the adder-graph kernel.

The builder methods make programs by hand (the card's smoke test builds
random ones with them, since the solver is not part of the port), and
:meth:`DAISProgram.evaluate` is the exact int64 numpy oracle.
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

    Raises ``OverflowError`` when an endpoint does not fit in int64."""
    lim = 1 << 62
    out = np.empty((len(qints), 3), dtype=np.int64)
    for i, q in enumerate(qints):
        if not (-lim < q.lo <= q.hi < lim):
            raise OverflowError("qint endpoints exceed int64 range")
        out[i] = (q.lo, q.hi, q.exp)
    return out


def qints_from_array(arr: np.ndarray) -> list[QInterval]:
    """Exact inverse of :func:`qints_to_array`."""
    return [QInterval(lo, hi, exp) for lo, hi, exp in np.asarray(arr, dtype=np.int64).tolist()]


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
    cost: int = 0  # full/half adder bits (paper Eq. 1)


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

    def add_input(self, qint: QInterval, depth: int = 0) -> int:
        if any(r.kind != KIND_INPUT for r in self.rows):
            raise ValueError("inputs must be added before ops")
        self.rows.append(Row(KIND_INPUT, qint=qint, depth=depth))
        self.n_inputs += 1
        return len(self.rows) - 1

    def add_op(self, a: int, b: int, sh_a: int, sh_b: int, sign: int) -> int:
        """Append ``u = (a << sh_a) + sign * (b << sh_b)``; returns the row.

        The common power of two of the shifts is factored out (a free
        shift), so one of the two stored shifts is always 0.  Interval and
        cost arithmetic is the JAX package's, term for term.
        """
        if min(sh_a, sh_b) != 0:
            m = min(sh_a, sh_b)
            sh_a, sh_b = sh_a - m, sh_b - m
        ra, rb = self.rows[a], self.rows[b]
        qA, qB = ra.qint, rb.qint
        alo, ahi = qA.lo, qA.hi
        blo, bhi = qB.lo, qB.hi
        az = alo == 0 == ahi
        bz = blo == 0 == bhi
        aexp = qA.exp if az else qA.exp + sh_a
        bexp = qB.exp if bz else qB.exp + sh_b
        if bz:
            qint = QInterval(alo, ahi, aexp)
            cost = 0
        elif az:
            qint = QInterval(blo, bhi, bexp) if sign > 0 else QInterval(-bhi, -blo, bexp)
            cost = 0
        else:
            exp = min(aexp, bexp)
            al, ah = alo << (aexp - exp), ahi << (aexp - exp)
            bl, bh = blo << (bexp - exp), bhi << (bexp - exp)
            if sign > 0:
                qint = QInterval(al + bl, ah + bh, exp)
            else:
                qint = QInterval(al - bh, ah - bl, exp)
            wa = QInterval(alo, ahi, 0).width
            wb = QInterval(blo, bhi, 0).width
            msb = max(aexp + wa - 1, bexp + wb - 1)
            # disjoint bit ranges are spliced, not added
            cost = 1 if max(aexp, bexp) > msb else msb - min(aexp, bexp) + 2
        depth = max(ra.depth, rb.depth) + 1
        self.rows.append(Row(KIND_ADD, a, b, sh_a, sh_b, sign, qint, depth, cost))
        return len(self.rows) - 1

    def add_neg(self, a: int) -> int:
        ra = self.rows[a]
        self.rows.append(
            Row(KIND_NEG, a, -1, 0, 0, -1, ra.qint.neg(), ra.depth + 1, ra.qint.width + 1)
        )
        return len(self.rows) - 1

    def to_arrays(self) -> dict[str, np.ndarray]:
        """Pack the program into int64 numpy arrays (the artifact format).

        Rows: (kind, a, b, sh_a, sh_b, sign, depth, cost, q_lo, q_hi,
        q_exp); outputs: (present, sign, row, shift).  Raises
        ``OverflowError`` if an interval endpoint does not fit in int64.
        """
        lim = 1 << 62
        rows = np.empty((len(self.rows), 11), dtype=np.int64)
        for i, r in enumerate(self.rows):
            q = r.qint
            if not (-lim < q.lo <= q.hi < lim):
                raise OverflowError("qint endpoints exceed int64 range")
            rows[i] = (r.kind, r.a, r.b, r.sh_a, r.sh_b, r.sign, r.depth, r.cost,
                       q.lo, q.hi, q.exp)
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
    def from_arrays(arrays: dict[str, np.ndarray]) -> DAISProgram:
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
            for present, sign, row, shift in np.asarray(arrays["outputs"], dtype=np.int64).tolist()
        ]
        return prog

    def evaluate(self, x: np.ndarray) -> np.ndarray:
        """Evaluate the program exactly in int64 on integer inputs.

        ``x``: int array [..., n_inputs].  Returns int64 [..., n_outputs]
        with output j equal to ``sign * (value_row << shift)`` (an
        arithmetic right shift for a negative shift).
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
