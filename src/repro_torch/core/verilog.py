"""Synthesizable Verilog emission from DAIS programs (paper §5.2).

Each DAIS op maps 1:1 to an RTL statement; pipelining inserts register
stages per :mod:`pipelining`.  Values are signed wires on the integer
grid (the power-of-two exponent is a compile-time annotation, free in
hardware).  The module is fully pipelined with II = 1, or purely
combinational when ``max_delay_per_stage`` is None.
"""

from __future__ import annotations


from .dais import KIND_ADD, KIND_INPUT, KIND_NEG, DAISProgram
from .pipelining import pipeline


def _signed_width(q) -> int:
    """Declared width of a value carried on a ``signed`` wire.

    ``QInterval.width`` is the minimal two's-complement width for the
    interval — but for a non-negative interval (e.g. unsigned inputs or
    all-positive dot products) that count has no sign bit, and a
    ``signed [w-1:0]`` wire of that width wraps the upper half of the
    range (255 on an 8-bit signed wire reads back as -1, and every
    downstream sign-extension propagates the corruption).  All wires in
    the emitted module are declared signed so the Verilog expression
    rules keep arithmetic signed throughout; non-negative values
    therefore pay one explicit sign bit.  Caught by RTL co-simulation
    (see rtlsim/cosim); exercised in tests/test_rtlsim.py.
    """
    w = q.width + (0 if q.lo < 0 else 1)
    return max(w, 1)


def _w(prog: DAISProgram, i: int) -> int:
    return _signed_width(prog.rows[i].qint)


def emit_verilog(
    prog: DAISProgram,
    module_name: str = "cmvm",
    max_delay_per_stage: int | None = 5,
) -> str:
    """Emit a Verilog-2001 module computing the program's outputs."""
    pipelined = max_delay_per_stage is not None
    rep = pipeline(prog, max_delay_per_stage if pipelined else 1 << 30)
    n_stage = rep.n_stages if pipelined else 1

    lines: list[str] = []
    ports = ["input wire clk"] if pipelined else []
    for i in range(prog.n_inputs):
        ports.append(f"input wire signed [{_w(prog, i)-1}:0] x{i}")
    out_widths = [_signed_width(q) for q in prog.output_qints()]
    for j, w in enumerate(out_widths):
        ports.append(f"output wire signed [{w-1}:0] y{j}")
    lines.append(f"module {module_name} (")
    lines.append("  " + ",\n  ".join(ports))
    lines.append(");")

    # Declarations: each row value, once per pipeline stage it survives.
    names: dict[tuple[int, int], str] = {}  # (row, stage) -> wire/reg name

    def declare(i: int, s: int, reg: bool) -> str:
        name = f"v{i}_s{s}"
        kind = "reg" if reg else "wire"
        lines.append(f"  {kind} signed [{_w(prog, i)-1}:0] {name};")
        names[(i, s)] = name
        return name

    last_use = [rep.stage_of_row[i] for i in range(len(prog.rows))]
    for i, r in enumerate(prog.rows):
        if r.kind != KIND_INPUT:
            for o in ([r.a] if r.b < 0 else [r.a, r.b]):
                last_use[o] = max(last_use[o], rep.stage_of_row[i])
    for t in prog.outputs:
        if t is not None:
            # max, not assignment: an output row may also feed an op in a
            # LATER stage than any output (dead or auxiliary logic), and
            # clobbering its last_use would drop the stage-carry register
            # — the late op would then read a value one cycle too new
            # (caught by rtlsim's register-balance check)
            last_use[t.row] = max(last_use[t.row], n_stage - 1)

    regs: list[tuple[str, str]] = []  # (dst, src) clocked assignments
    for i, r in enumerate(prog.rows):
        s0 = rep.stage_of_row[i]
        name = declare(i, s0, reg=False)
        if r.kind == KIND_INPUT:
            lines.append(f"  assign {name} = x{i};")
        elif r.kind == KIND_ADD:
            a = names[(r.a, s0)] if (r.a, s0) in names else names[(r.a, rep.stage_of_row[r.a])]
            b = names[(r.b, s0)] if (r.b, s0) in names else names[(r.b, rep.stage_of_row[r.b])]
            sa = f"({a} <<< {r.sh_a})" if r.sh_a else a
            sb = f"({b} <<< {r.sh_b})" if r.sh_b else b
            op = "+" if r.sign > 0 else "-"
            lines.append(f"  assign {name} = {sa} {op} {sb};")
        else:  # KIND_NEG
            a = names[(r.a, s0)]
            lines.append(f"  assign {name} = -{a};")
        # carry across stage boundaries
        for s in range(s0 + 1, last_use[i] + 1):
            nm = declare(i, s, reg=pipelined)
            if pipelined:
                regs.append((nm, names[(i, s - 1)]))
            else:
                lines.append(f"  assign {nm} = {names[(i, s - 1)]};")

    if regs:
        lines.append("  always @(posedge clk) begin")
        for dst, src in regs:
            lines.append(f"    {dst} <= {src};")
        lines.append("  end")

    for j, t in enumerate(prog.outputs):
        if t is None:
            lines.append(f"  assign y{j} = 0;")
            continue
        src = names[(t.row, n_stage - 1)]
        expr = f"({src} <<< {t.shift})" if t.shift > 0 else (f"({src} >>> {-t.shift})" if t.shift < 0 else src)
        if t.sign < 0:
            expr = f"-{expr}"
        lines.append(f"  assign y{j} = {expr};")
    lines.append("endmodule")
    return "\n".join(lines)
