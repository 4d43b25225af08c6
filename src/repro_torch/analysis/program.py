"""DAIS program verifier: abstract interpretation over shift-add rows.

The solver annotates every row of a :class:`~repro_torch.core.dais.DAISProgram`
with an exact :class:`~repro_torch.core.fixed_point.QInterval`, an adder depth,
and an Eq.(1) adder-bit cost — and the compiler, the pipeliner, and the
Verilog emitter all *trust* those annotations.  This pass re-derives
every annotation from the input intervals alone (shift/add/sub/neg
transfer functions) and reports any row where the claimed metadata
differs from the derived truth, plus structural defects (dangling refs,
op-before-input, un-normalised shifts, dead rows).

Two further checks catch schedule and emission defects without running
a single test vector:

* :func:`check_pipeline` re-derives the greedy register schedule and the
  carry-register (FF) bill with an independent implementation and
  compares it against :func:`repro_torch.core.pipelining.pipeline`'s claim —
  a clobbered ``last_use`` carry (assignment where a ``max`` is needed)
  shows up as an FF/latency disagreement (``DA010``).
* :func:`check_emission` emits the Verilog and audits the *text*: every
  declared wire must be at least the minimal signed width its interval
  requires — including the explicit sign bit a non-negative interval
  pays on a ``signed`` wire (``DA009``) — and the netlist's own
  register-balance analysis must pass (``DA011``).
"""

from __future__ import annotations

import re

from ..core.cost import adder_cost
from ..core.dais import KIND_ADD, KIND_INPUT, KIND_NEG, DAISProgram
from ..core.fixed_point import QInterval
from ..core.pipelining import PipelineReport, pipeline
from ..core.rtlsim import RTLSimError, parse_verilog
from ..core.verilog import emit_verilog
from .diagnostics import DiagnosticReport

__all__ = [
    "check_emission",
    "check_pipeline",
    "check_program",
    "derive_row_qints",
    "required_signed_width",
]

_PASS = "program"


def required_signed_width(q: QInterval) -> int:
    """Minimal width of a ``signed`` wire that can carry interval ``q``.

    Independent restatement of the emission rule: the minimal
    two's-complement width of the interval, plus one explicit sign bit
    when the interval is non-negative (a non-negative value on a signed
    wire of its magnitude width would read back negative), floor 1.
    Deliberately NOT delegated to ``repro_torch.core.verilog`` — this is the
    verifier's own ground truth the emitter is audited against.
    """
    if q.is_zero:
        return 1
    if q.lo < 0:
        mag = max(q.hi, -q.lo - 1)
        w = (mag.bit_length() + 1) if mag > 0 else 1
    else:
        w = q.hi.bit_length() + 1  # magnitude bits + explicit sign bit
    return max(w, 1)


def derive_row_qints(prog: DAISProgram) -> list[QInterval | None]:
    """Abstract interpretation: per-row intervals derived from inputs.

    Input rows are ground truth (they are the caller's specification);
    every op row's interval is re-derived through the exact transfer
    functions.  Rows whose operands are structurally invalid derive to
    ``None`` (reported separately by :func:`check_program`).
    """
    # raw (lo, hi, exp) endpoint arithmetic — semantically identical to
    # QInterval.shift + add/sub/neg (zero intervals keep their exp), but
    # without the per-op object churn: this runs on every compile.
    derived: list[QInterval | None] = []
    vals: list[tuple[int, int, int] | None] = []
    for i, r in enumerate(prog.rows):
        if r.kind == KIND_INPUT:
            q = r.qint
            derived.append(q)
            vals.append((q.lo, q.hi, q.exp))
            continue
        va = vals[r.a] if 0 <= r.a < i else None
        if r.kind == KIND_NEG:
            if va is None:
                derived.append(None)
                vals.append(None)
                continue
            alo, ahi, ae = va
            v = (-ahi, -alo, ae)
        else:
            vb = vals[r.b] if 0 <= r.b < i else None
            if va is None or vb is None or r.sh_a < 0 or r.sh_b < 0:
                derived.append(None)
                vals.append(None)
                continue
            alo, ahi, ae = va
            blo, bhi, be = vb
            if alo != 0 or ahi != 0:
                ae += r.sh_a
            if blo != 0 or bhi != 0:
                be += r.sh_b
            if blo == 0 == bhi:
                v = (alo, ahi, ae)
            elif alo == 0 == ahi:
                v = (blo, bhi, be) if r.sign > 0 else (-bhi, -blo, be)
            else:
                e = ae if ae < be else be
                al, ah = alo << (ae - e), ahi << (ae - e)
                bl, bh = blo << (be - e), bhi << (be - e)
                v = (al + bl, ah + bh, e) if r.sign > 0 else (al - bh, ah - bl, e)
        vals.append(v)
        derived.append(QInterval(*v))
    return derived


def check_program(
    prog: DAISProgram,
    report: DiagnosticReport | None = None,
    *,
    program_index: int | None = None,
) -> DiagnosticReport:
    """Structural + metadata verification of one DAIS program."""
    rep = report if report is not None else DiagnosticReport()

    def loc(**kw: object) -> dict:
        base: dict = {} if program_index is None else {"program": program_index}
        base.update(kw)
        return base

    n = len(prog.rows)
    n_inputs = sum(1 for r in prog.rows if r.kind == KIND_INPUT)
    if n_inputs != prog.n_inputs:
        rep.add(
            "DA002",
            f"program claims n_inputs={prog.n_inputs} but has {n_inputs} input rows",
            loc=loc(), passname=_PASS,
        )
    seen_op = False
    structural_ok = True
    for i, r in enumerate(prog.rows):
        if r.kind == KIND_INPUT:
            if seen_op:
                rep.add(
                    "DA002", "input row appears after an op row",
                    loc=loc(row=i), passname=_PASS,
                )
                structural_ok = False
            continue
        seen_op = True
        if r.kind not in (KIND_ADD, KIND_NEG):
            rep.add("DA001", f"unknown row kind {r.kind}", loc=loc(row=i), passname=_PASS)
            structural_ok = False
            continue
        operands = (r.a, r.b) if r.kind == KIND_ADD else (r.a,)
        for o in operands:
            if not 0 <= o < i:
                rep.add(
                    "DA001",
                    f"operand ref {o} is dangling (must name an earlier row, got row {i})",
                    loc=loc(row=i), passname=_PASS,
                )
                structural_ok = False
        if r.kind == KIND_ADD:
            if r.sign not in (-1, 1):
                rep.add("DA001", f"op sign must be ±1, got {r.sign}", loc=loc(row=i), passname=_PASS)
                structural_ok = False
            if r.sh_a < 0 or r.sh_b < 0:
                rep.add(
                    "DA003", f"negative operand shift ({r.sh_a}, {r.sh_b})",
                    loc=loc(row=i), passname=_PASS,
                )
                structural_ok = False
            elif min(r.sh_a, r.sh_b) != 0:
                rep.add(
                    "DA003",
                    f"shift pair ({r.sh_a}, {r.sh_b}) not normalised (min must be 0)",
                    loc=loc(row=i), passname=_PASS,
                )
        else:  # KIND_NEG
            if r.sh_a != 0 or r.sh_b != 0:
                rep.add(
                    "DA003", "negation row must carry zero shifts",
                    loc=loc(row=i), passname=_PASS,
                )

    for j, t in enumerate(prog.outputs):
        if t is None:
            continue
        if not 0 <= t.row < n:
            rep.add(
                "DA007", f"output {j} references row {t.row} (program has {n} rows)",
                loc=loc(output=j), passname=_PASS,
            )
            structural_ok = False
        if t.sign not in (-1, 1):
            rep.add(
                "DA007", f"output {j} sign must be ±1, got {t.sign}",
                loc=loc(output=j), passname=_PASS,
            )

    # metadata re-derivation (only meaningful on structurally sound rows)
    derived = derive_row_qints(prog)
    for i, r in enumerate(prog.rows):
        if r.kind == KIND_INPUT:
            continue
        dq = derived[i]
        if dq is None:
            continue  # structural defect already reported
        if r.qint != dq:
            rep.add(
                "DA004",
                f"row interval {r.qint} differs from derived {dq}",
                loc=loc(row=i), passname=_PASS,
            )
        ra = prog.rows[r.a]
        d_depth = (max(ra.depth, prog.rows[r.b].depth) if r.kind == KIND_ADD else ra.depth) + 1
        if r.depth != d_depth:
            rep.add(
                "DA005",
                f"row depth {r.depth} differs from derived {d_depth}",
                loc=loc(row=i), passname=_PASS,
            )
        if r.kind == KIND_ADD:
            d_cost = adder_cost(derived[r.a], derived[r.b], r.sh_a, r.sh_b, r.sign)
        else:
            d_cost = (derived[r.a].width if derived[r.a] is not None else 0) + 1
        if r.cost != d_cost:
            rep.add(
                "DA006",
                f"row cost {r.cost} differs from the cost-model value {d_cost}",
                loc=loc(row=i), passname=_PASS,
            )

    # dead rows: ops unreachable from any output (the solver prunes, so a
    # shipped program carrying dead logic is suspicious, not fatal)
    if structural_ok:
        live = [False] * n
        stack = [t.row for t in prog.outputs if t is not None and 0 <= t.row < n]
        while stack:
            i = stack.pop()
            if live[i]:
                continue
            live[i] = True
            r = prog.rows[i]
            if r.kind != KIND_INPUT:
                stack.append(r.a)
                if r.kind == KIND_ADD:
                    stack.append(r.b)
        dead = [i for i, r in enumerate(prog.rows) if r.kind != KIND_INPUT and not live[i]]
        if dead:
            rep.add(
                "DA008",
                f"{len(dead)} op row(s) unreachable from any output "
                f"(first: row {dead[0]})",
                loc=loc(), passname=_PASS,
            )
    return rep


# ----------------------------------------------------------------------
# Pipeline re-derivation
# ----------------------------------------------------------------------
def _derive_schedule(prog: DAISProgram, max_delay_per_stage: int) -> tuple[int, list[int], int]:
    """Independent re-derivation of the greedy register schedule.

    Returns ``(n_stages, stage_of_row, ff_bits)`` computed from scratch:
    the same local greedy rule the paper specifies, with the carry bill
    built from a per-row *latest consumer stage* that honours both op
    consumers and output taps (a ``max``, not an assignment).
    """
    n = len(prog.rows)
    stage = [0] * n
    within = [0] * n
    for i, r in enumerate(prog.rows):
        if r.kind == KIND_INPUT:
            continue
        ops = [r.a, r.b] if r.kind == KIND_ADD else [r.a]
        s = max(stage[o] for o in ops)
        d = 1 + max((within[o] for o in ops if stage[o] == s), default=0)
        if d > max_delay_per_stage:
            s += 1
            d = 1
        stage[i], within[i] = s, d
    tapped = [stage[t.row] for t in prog.outputs if t is not None]
    n_stages = max(tapped, default=0) + 1

    # latest stage each row's value is still needed in: every op consumer
    # AND the final output stage for tapped rows — never an overwrite.
    needed_until = list(stage)
    for i, r in enumerate(prog.rows):
        if r.kind == KIND_INPUT:
            continue
        for o in ([r.a, r.b] if r.kind == KIND_ADD else [r.a]):
            if stage[i] > needed_until[o]:
                needed_until[o] = stage[i]
    for t in prog.outputs:
        if t is not None and n_stages - 1 > needed_until[t.row]:
            needed_until[t.row] = n_stages - 1
    ff_bits = sum(
        (needed_until[i] - stage[i]) * r.qint.width
        for i, r in enumerate(prog.rows)
        if needed_until[i] > stage[i]
    )
    return n_stages, stage, ff_bits


def check_pipeline(
    prog: DAISProgram,
    max_delay_per_stage: int,
    report: DiagnosticReport | None = None,
    *,
    program_index: int | None = None,
    claimed: PipelineReport | None = None,
    derived: tuple[int, list[int], int] | None = None,
) -> DiagnosticReport:
    """Compare the production pipeliner's claim against a re-derivation.

    ``claimed`` defaults to calling :func:`repro_torch.core.pipelining.pipeline`
    fresh, so a regression in the pipeliner itself (not just a stale
    stored report) is caught.  ``derived`` lets callers that already ran
    :func:`_derive_schedule` (verify_design shares it with the report
    matcher) skip the recomputation.
    """
    rep = report if report is not None else DiagnosticReport()
    loc: dict = {} if program_index is None else {"program": program_index}
    loc["max_delay_per_stage"] = max_delay_per_stage
    if claimed is None:
        claimed = pipeline(prog, max_delay_per_stage)
    n_stages, stage, ff_bits = (
        derived if derived is not None else _derive_schedule(prog, max_delay_per_stage)
    )
    if claimed.n_stages != n_stages:
        rep.add(
            "DA010",
            f"claimed n_stages={claimed.n_stages}, derived {n_stages}",
            loc=loc, passname=_PASS,
        )
    if list(claimed.stage_of_row) != stage:
        first = next(
            (i for i, (a, b) in enumerate(zip(claimed.stage_of_row, stage)) if a != b),
            None,
        )
        rep.add(
            "DA010",
            f"claimed stage assignment differs from derived (first at row {first})",
            loc=loc, passname=_PASS,
        )
    if claimed.ff_bits != ff_bits:
        rep.add(
            "DA010",
            f"claimed ff_bits={claimed.ff_bits}, derived {ff_bits} "
            "(a clobbered last-use/stage-carry produces exactly this drift)",
            loc=loc, passname=_PASS,
        )
    if claimed.latency_cycles != n_stages - 1:
        rep.add(
            "DA010",
            f"claimed latency_cycles={claimed.latency_cycles}, derived {n_stages - 1}",
            loc=loc, passname=_PASS,
        )
    return rep


# ----------------------------------------------------------------------
# Emission audit
# ----------------------------------------------------------------------
_VALUE_WIRE_RE = re.compile(r"^v(\d+)_s(\d+)$")


def check_emission(
    prog: DAISProgram,
    max_delay_per_stage: int | None,
    report: DiagnosticReport | None = None,
    *,
    program_index: int | None = None,
    src: str | None = None,
) -> DiagnosticReport:
    """Audit the emitted Verilog text against the program's intervals.

    ``src`` defaults to a fresh :func:`repro_torch.core.verilog.emit_verilog`
    call so emitter regressions are caught; tests may pass doctored text.
    No simulation runs — the netlist is parsed, its declared widths are
    compared against :func:`required_signed_width` of the (re-derived)
    intervals, and the parser's structural register-balance analysis must
    accept it.
    """
    rep = report if report is not None else DiagnosticReport()
    loc: dict = {} if program_index is None else {"program": program_index}
    if src is None:
        try:
            src = emit_verilog(prog, max_delay_per_stage=max_delay_per_stage)
        except Exception as e:
            rep.add(
                "DA011", f"emit_verilog failed: {type(e).__name__}: {e}",
                loc=loc, passname=_PASS,
            )
            return rep
    try:
        mod = parse_verilog(src)
    except RTLSimError as e:
        if "the simulator supports" in str(e):
            rep.add("DA013", f"emission audit skipped: {e}", loc=loc, passname=_PASS)
        else:
            rep.add(
                "DA011",
                f"emitted RTL failed structural analysis: {e}",
                loc=loc, passname=_PASS,
            )
        return rep

    derived = derive_row_qints(prog)

    def want_width(q: QInterval | None) -> int | None:
        return None if q is None else required_signed_width(q)

    n_rows = len(prog.rows)
    for name, sig in mod.signals.items():
        m = _VALUE_WIRE_RE.match(name)
        q: QInterval | None = None
        if m is not None:
            row = int(m.group(1))
            q = derived[row] if row < n_rows else None
        elif name.startswith("x") and name[1:].isdigit():
            i = int(name[1:])
            q = prog.rows[i].qint if i < prog.n_inputs else None
        elif name.startswith("y") and name[1:].isdigit():
            j = int(name[1:])
            outs = prog.output_qints()
            q = outs[j] if j < len(outs) else None
        need = want_width(q)
        if need is None:
            continue
        if not sig.signed:
            rep.add(
                "DA009",
                f"signal {name} is unsigned; all emitted values must be signed wires",
                loc={**loc, "signal": name}, passname=_PASS,
            )
        if sig.width < need:
            rep.add(
                "DA009",
                f"signal {name} declared [{sig.width - 1}:0] but interval {q} "
                f"needs {need} signed bits (sign-bit rule included)",
                loc={**loc, "signal": name}, passname=_PASS,
            )

    if max_delay_per_stage is not None:
        want_lat = _derive_schedule(prog, max_delay_per_stage)[0] - 1
        if mod.latency_cycles != want_lat:
            rep.add(
                "DA011",
                f"emitted module exhibits latency {mod.latency_cycles}, "
                f"schedule derivation says {want_lat}",
                loc=loc, passname=_PASS,
            )
    return rep
