"""Pure-Python RTL simulator for the Verilog subset of :mod:`verilog`.

``emit_verilog`` produces the hardware claim of the paper — a shift-add
adder graph as synthesizable Verilog-2001 — but structural goldens alone
never *execute* that RTL.  This module closes the loop without any
external toolchain: it parses the emitted module into a small netlist IR
and evaluates it cycle-accurately with real Verilog expression
semantics, so divergences between the Python integer model and what the
HDL actually computes (width truncation, signedness, arithmetic-shift
behaviour, pipeline misalignment) become test failures.

Supported subset (everything ``emit_verilog`` emits, plus a little
slack so hand-written regression modules stay convenient):

* ``module NAME ( ports );`` with ``input``/``output`` ``wire``/``reg``
  port declarations, optional ``signed``, optional ``[msb:0]`` ranges;
* body declarations ``wire|reg [signed] [msb:0] name;``;
* continuous assignments ``assign dst = expr;`` where ``expr`` is built
  from identifiers, decimal integer literals, unary ``-``, binary
  ``+``/``-``, and parenthesised shifts ``(e <<< k)`` / ``(e >>> k)``
  (``<<`` and ``>>`` are also accepted);
* a single ``always @(posedge clk) begin ... end`` region of
  non-blocking assignments ``dst <= src_expr;``.

Semantics implemented (IEEE 1364-2001 expression evaluation):

* the size of the RHS of an assignment is
  ``max(width(LHS), self_size(RHS))`` where shifts take their left
  operand's size, ``+``/``-`` take the max of their operands, and shift
  amounts are self-determined;
* the expression is signed iff every context-determined operand is
  signed (shift results inherit the left operand's signedness; the
  LHS never affects signedness);
* context-determined operands are extended to the final size
  (sign-extended only for signed expressions) *before* any operation,
  every operation wraps modulo ``2**size``, and ``>>>`` is an
  arithmetic shift only for signed expressions;
* the result is truncated to the LHS width on assignment — every signal
  stores exactly the two's-complement value its declared width can hold;
* registers initialise to 0 and update simultaneously (non-blocking) on
  the clock edge.

The simulator also derives the pipeline structure from the netlist
itself: every input→output path is walked counting register crossings,
unbalanced paths (a real pipelining bug) raise, and the resulting
latency is cross-checked against :class:`pipelining.PipelineReport` by
the co-sim harness (:mod:`cosim`).
"""

from __future__ import annotations

import re
from dataclasses import dataclass, field

import numpy as np

__all__ = [
    "RTLSimError",
    "RTLModule",
    "RTLSimulator",
    "SimResult",
    "parse_verilog",
]

_MAX_WIDTH = 62  # int64 evaluation with post-op masking stays exact below this


class RTLSimError(Exception):
    """Parse error, unsupported construct, or netlist inconsistency."""


# ----------------------------------------------------------------------
# Netlist IR
# ----------------------------------------------------------------------
#
# Expressions are plain nested tuples (hashable, cheap to walk):
#   ("ref", name)            signal reference
#   ("const", value)         decimal literal (32-bit signed, like Verilog)
#   ("neg", e)               unary minus
#   ("add", l, r) / ("sub", l, r)
#   ("shl", e, k) / ("sra", e, k) / ("srl", e, k)
# ``sra`` is the `>>>` token; whether it actually shifts arithmetically
# is decided by the signedness of the whole expression, per the LRM.

Expr = tuple


@dataclass(frozen=True)
class Signal:
    name: str
    width: int
    signed: bool
    kind: str  # "input" | "output" | "wire" | "reg"


@dataclass
class Assign:
    dst: str
    expr: Expr


@dataclass
class RTLModule:
    """Parsed netlist of one module."""

    name: str
    clock: str | None
    signals: dict[str, Signal]
    inputs: list[str]  # data inputs, clock excluded, declaration order
    outputs: list[str]
    assigns: list[Assign]  # continuous assignments
    clocked: list[Assign]  # non-blocking assignments in the always block
    # filled by _analyze():
    comb_order: list[Assign] = field(default_factory=list)
    latency_of: dict[str, int | None] = field(default_factory=dict)

    @property
    def latency_cycles(self) -> int:
        """Register stages between inputs and outputs (0 = combinational)."""
        return max(
            (self.latency_of[o] for o in self.outputs if self.latency_of[o] is not None),
            default=0,
        )

    @property
    def n_registers(self) -> int:
        return len(self.clocked)

    def register_bits(self) -> int:
        """Total flip-flop bits (sum of clocked destination widths)."""
        return sum(self.signals[a.dst].width for a in self.clocked)

    def stage_register_bits(self) -> list[int]:
        """FF bits per stage boundary: entry ``s`` counts registers whose
        destination lives after boundary ``s``/``s+1`` (i.e. has register
        depth ``s+1``).  Registers can sit deeper than the last output
        (auxiliary logic past the final output stage), so the list is
        sized by the deepest register, not by ``latency_cycles``."""
        depths = [
            self.latency_of[a.dst]
            for a in self.clocked
            if self.latency_of[a.dst] is not None
        ]
        bits = [0] * max([self.latency_cycles] + depths)
        for a in self.clocked:
            d = self.latency_of[a.dst]
            if d is not None and d >= 1:
                bits[d - 1] += self.signals[a.dst].width
        return bits


# ----------------------------------------------------------------------
# Parsing
# ----------------------------------------------------------------------
_TOKEN_RE = re.compile(r"\s*(<<<|>>>|<<|>>|[A-Za-z_]\w*|\d+|[()+\-=;])")


def _tokenize(text: str) -> list[str]:
    toks, pos = [], 0
    while pos < len(text):
        m = _TOKEN_RE.match(text, pos)
        if not m:
            if text[pos:].strip():
                raise RTLSimError(f"cannot tokenize {text[pos:]!r}")
            break
        toks.append(m.group(1))
        pos = m.end()
    return toks


class _ExprParser:
    """Recursive-descent parser for the expression subset."""

    def __init__(self, toks: list[str], context: str):
        self.toks = toks
        self.i = 0
        self.context = context

    def peek(self) -> str | None:
        return self.toks[self.i] if self.i < len(self.toks) else None

    def next(self) -> str:
        if self.i >= len(self.toks):
            raise RTLSimError(f"unexpected end of expression in {self.context!r}")
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect(self, tok: str) -> None:
        t = self.next()
        if t != tok:
            raise RTLSimError(f"expected {tok!r}, got {t!r} in {self.context!r}")

    def parse(self) -> Expr:
        e = self.expr()
        if self.peek() is not None:
            raise RTLSimError(f"trailing tokens {self.toks[self.i:]} in {self.context!r}")
        return e

    def expr(self) -> Expr:
        e = self.unary()
        while self.peek() in ("+", "-"):
            op = self.next()
            e = ("add" if op == "+" else "sub", e, self.unary())
        return e

    def unary(self) -> Expr:
        if self.peek() == "-":
            self.next()
            return ("neg", self.unary())
        return self.primary()

    def primary(self) -> Expr:
        t = self.next()
        if t == "(":
            e = self.expr()
            if self.peek() in ("<<<", ">>>", "<<", ">>"):
                op = self.next()
                k = self.next()
                if not k.isdigit():
                    raise RTLSimError(
                        f"only constant shift amounts supported, got {k!r} "
                        f"in {self.context!r}"
                    )
                tag = {"<<<": "shl", "<<": "shl", ">>>": "sra", ">>": "srl"}[op]
                e = (tag, e, int(k))
            self.expect(")")
            return e
        if t.isdigit():
            return ("const", int(t))
        if re.fullmatch(r"[A-Za-z_]\w*", t):
            return ("ref", t)
        raise RTLSimError(f"unexpected token {t!r} in {self.context!r}")


def _parse_expr(text: str) -> Expr:
    return _ExprParser(_tokenize(text), text.strip()).parse()


_PORT_RE = re.compile(
    r"^(input|output)\s+(?:(wire|reg)\s+)?(signed\s+)?(?:\[(\d+):0\]\s*)?([A-Za-z_]\w*)$"
)
_DECL_RE = re.compile(
    r"^(wire|reg)\s+(signed\s+)?(?:\[(\d+):0\]\s*)?([A-Za-z_]\w*)\s*;$"
)
_ASSIGN_RE = re.compile(r"^assign\s+([A-Za-z_]\w*)\s*=\s*(.+?)\s*;$")
_ALWAYS_RE = re.compile(r"^always\s*@\s*\(\s*posedge\s+([A-Za-z_]\w*)\s*\)\s*begin$")
_NBA_RE = re.compile(r"^([A-Za-z_]\w*)\s*<=\s*(.+?)\s*;$")


def parse_verilog(src: str) -> RTLModule:
    """Parse one module in the emitted subset into an :class:`RTLModule`."""
    # strip comments, normalise whitespace
    src = re.sub(r"//[^\n]*", "", src)
    src = re.sub(r"/\*.*?\*/", "", src, flags=re.S)

    m = re.search(r"\bmodule\s+([A-Za-z_]\w*)\s*\((.*?)\)\s*;(.*?)\bendmodule\b",
                  src, flags=re.S)
    if not m:
        raise RTLSimError("no `module ... ( ... ); ... endmodule` found")
    name, portlist, body = m.group(1), m.group(2), m.group(3)

    signals: dict[str, Signal] = {}
    inputs: list[str] = []
    outputs: list[str] = []
    clock: str | None = None

    for raw in portlist.split(","):
        decl = " ".join(raw.split())
        if not decl:
            continue
        pm = _PORT_RE.match(decl)
        if not pm:
            raise RTLSimError(f"unsupported port declaration {decl!r}")
        direction, _, signed, msb, pname = pm.groups()
        width = int(msb) + 1 if msb is not None else 1
        if direction == "input" and pname == "clk" and msb is None:
            clock = pname
            continue
        sig = Signal(pname, width, signed is not None, direction)
        if pname in signals:
            raise RTLSimError(f"duplicate signal {pname!r}")
        signals[pname] = sig
        (inputs if direction == "input" else outputs).append(pname)

    assigns: list[Assign] = []
    clocked: list[Assign] = []
    in_always = False
    for raw in body.split("\n"):
        line = " ".join(raw.split())
        if not line:
            continue
        if in_always:
            if line == "end":
                in_always = False
                continue
            nm = _NBA_RE.match(line)
            if not nm:
                raise RTLSimError(f"unsupported statement in always block: {line!r}")
            clocked.append(Assign(nm.group(1), _parse_expr(nm.group(2))))
            continue
        am = _ALWAYS_RE.match(line)
        if am:
            if clock is None:
                raise RTLSimError("always @(posedge ...) in a module with no clk port")
            if am.group(1) != clock:
                raise RTLSimError(f"unknown clock {am.group(1)!r}")
            in_always = True
            continue
        dm = _DECL_RE.match(line)
        if dm:
            kind, signed, msb, dname = dm.groups()
            width = int(msb) + 1 if msb is not None else 1
            if dname in signals:
                raise RTLSimError(f"duplicate signal {dname!r}")
            signals[dname] = Signal(dname, width, signed is not None, kind)
            continue
        sm = _ASSIGN_RE.match(line)
        if sm:
            assigns.append(Assign(sm.group(1), _parse_expr(sm.group(2))))
            continue
        raise RTLSimError(f"unsupported construct: {line!r}")
    if in_always:
        raise RTLSimError("always block not closed with `end`")

    mod = RTLModule(name, clock, signals, inputs, outputs, assigns, clocked)
    _analyze(mod)
    return mod


# ----------------------------------------------------------------------
# Static analysis: drivers, schedule, register depth
# ----------------------------------------------------------------------
def _refs(expr: Expr) -> list[str]:
    out: list[str] = []
    stack = [expr]
    while stack:
        node = stack.pop()
        tag = node[0]
        if tag == "ref":
            out.append(node[1])
        elif tag == "const":
            pass
        elif tag == "neg":
            stack.append(node[1])
        elif tag in ("add", "sub"):
            stack.append(node[1])
            stack.append(node[2])
        else:  # shifts
            stack.append(node[1])
    return out


def _analyze(mod: RTLModule) -> None:
    sigs = mod.signals
    for w in (s for s in sigs.values()):
        if w.width > _MAX_WIDTH:
            raise RTLSimError(
                f"signal {w.name!r} is {w.width} bits; the simulator supports "
                f"at most {_MAX_WIDTH} (int64 evaluation)"
            )
    driver: dict[str, Assign] = {}
    for a in mod.assigns:
        if a.dst not in sigs:
            raise RTLSimError(f"assignment to undeclared signal {a.dst!r}")
        if a.dst in driver:
            raise RTLSimError(f"multiple drivers for {a.dst!r}")
        if sigs[a.dst].kind == "reg":
            raise RTLSimError(f"continuous assignment to reg {a.dst!r}")
        driver[a.dst] = a
    reg_driver: dict[str, Assign] = {}
    for a in mod.clocked:
        if a.dst not in sigs:
            raise RTLSimError(f"clocked assignment to undeclared signal {a.dst!r}")
        if sigs[a.dst].kind != "reg":
            raise RTLSimError(f"non-blocking assignment to non-reg {a.dst!r}")
        if a.dst in reg_driver:
            raise RTLSimError(f"multiple clocked drivers for {a.dst!r}")
        reg_driver[a.dst] = a
    for a in mod.assigns + mod.clocked:
        for r in _refs(a.expr):
            if r not in sigs:
                raise RTLSimError(f"{a.dst!r} reads undeclared signal {r!r}")
    for s in sigs.values():
        if s.kind in ("wire", "output") and s.name not in driver:
            raise RTLSimError(f"undriven {s.kind} {s.name!r}")

    # combinational schedule: topological order over assign dependencies
    # (registers and inputs are state and break the ordering).  Iterative
    # DFS so deep adder chains never hit the Python recursion limit.
    order: list[Assign] = []
    state = {a.dst: 0 for a in mod.assigns}  # 0=unvisited 1=visiting 2=done

    for root in mod.assigns:
        if state[root.dst] == 2:
            continue
        stack: list[tuple[str, int]] = [(root.dst, 0)]
        while stack:
            nm, phase = stack.pop()
            if phase == 1:
                state[nm] = 2
                order.append(driver[nm])
                continue
            if state[nm] == 2:
                continue
            if state[nm] == 1:
                raise RTLSimError(f"combinational loop through {nm!r}")
            state[nm] = 1
            stack.append((nm, 1))
            for r in _refs(driver[nm].expr):
                if r in state and sigs[r].kind != "reg" and state[r] != 2:
                    if state[r] == 1:
                        raise RTLSimError(f"combinational loop through {r!r}")
                    stack.append((r, 0))
    mod.comb_order = order

    # register depth per signal: None for signals with no input dependency
    # (constants); otherwise (min, max) register crossings from any input.
    # Unbalanced min/max on a signal is a genuine pipeline bug: two
    # arrivals of the same logical value from different cycles.  The
    # comb schedule above is already topological, and every reg source is
    # combinational (or an input/reg), so one pass over `order` followed
    # by rounds of reg relaxation terminates: reg depths only ever depend
    # on values produced strictly earlier in clock time.
    depth: dict[str, tuple[int, int] | None] = {
        nm: (0, 0) for nm in sigs if sigs[nm].kind == "input"
    }
    for nm in sigs:
        if sigs[nm].kind == "reg" and nm not in reg_driver:
            depth[nm] = None  # free-running reg; stays at reset value

    def expr_depth(expr: Expr) -> tuple[int, int] | None:
        # callers guarantee every ref is already resolved in `depth`
        ds = [d for d in (depth[r] for r in _refs(expr)) if d is not None]
        if not ds:
            return None
        return (min(d[0] for d in ds), max(d[1] for d in ds))

    # regs first (their sources are pre-edge values: any signal), then
    # wires in topological order; iterate until the reg depths are fixed
    # (two rounds suffice for feed-forward pipelines, but loop defensively)
    for _ in range(len(mod.clocked) + 2):
        changed = False
        for a in mod.comb_order:
            if all(r in depth for r in _refs(a.expr)):
                d = expr_depth(a.expr)
                if depth.get(a.dst, "missing") != d:
                    depth[a.dst] = d
                    changed = True
        for a in mod.clocked:
            if all(r in depth for r in _refs(a.expr)):
                d = expr_depth(a.expr)
                d = None if d is None else (d[0] + 1, d[1] + 1)
                if depth.get(a.dst, "missing") != d:
                    depth[a.dst] = d
                    changed = True
        if not changed:
            break
    unresolved = [
        a.dst for a in mod.comb_order + mod.clocked if a.dst not in depth
    ]
    if unresolved:
        raise RTLSimError(
            f"register feedback loop: pipeline depth does not settle for {unresolved}"
        )

    lat: dict[str, int | None] = {}
    for nm in sigs:
        d = depth.get(nm)
        if d is not None and d[0] != d[1]:
            raise RTLSimError(
                f"unbalanced pipeline: {nm!r} mixes values that crossed "
                f"{d[0]} and {d[1]} register stages"
            )
        lat[nm] = None if d is None else d[0]
    mod.latency_of = lat


# ----------------------------------------------------------------------
# Expression sizing / signedness (IEEE 1364-2001 §4.4-4.5)
# ----------------------------------------------------------------------
def _self_size(expr: Expr, sigs: dict[str, Signal]) -> int:
    tag = expr[0]
    if tag == "ref":
        return sigs[expr[1]].width
    if tag == "const":
        return 32
    if tag == "neg":
        return _self_size(expr[1], sigs)
    if tag in ("add", "sub"):
        return max(_self_size(expr[1], sigs), _self_size(expr[2], sigs))
    return _self_size(expr[1], sigs)  # shifts: left operand's size


def _self_signed(expr: Expr, sigs: dict[str, Signal]) -> bool:
    tag = expr[0]
    if tag == "ref":
        return sigs[expr[1]].signed
    if tag == "const":
        return True  # unsized decimal literals are signed
    if tag == "neg":
        return _self_signed(expr[1], sigs)
    if tag in ("add", "sub"):
        return _self_signed(expr[1], sigs) and _self_signed(expr[2], sigs)
    return _self_signed(expr[1], sigs)  # shift: left operand only


def _wrap(v: np.ndarray, width: int, signed: bool) -> np.ndarray:
    """Truncate to ``width`` bits and reinterpret (two's complement)."""
    mask = (1 << width) - 1
    u = v & mask
    if not signed:
        return u
    sbit = 1 << (width - 1)
    return (u ^ sbit) - sbit


def _eval_expr(
    expr: Expr,
    size: int,
    signed: bool,
    values: dict[str, np.ndarray],
    sigs: dict[str, Signal],
) -> np.ndarray:
    """Evaluate at context ``size``/``signed``; result wrapped to size."""
    tag = expr[0]
    if tag == "ref":
        sig = sigs[expr[1]]
        v = values[expr[1]]
        # stored canonically at declared width; extension to the context
        # follows the *expression* signedness (LRM: operands of an
        # unsigned expression are zero-extended even if declared signed)
        if not signed and sig.signed:
            v = v & ((1 << sig.width) - 1)
        return v
    if tag == "const":
        return _wrap(np.int64(expr[1]), size, signed)
    if tag == "neg":
        return _wrap(-_eval_expr(expr[1], size, signed, values, sigs), size, signed)
    if tag in ("add", "sub"):
        a = _eval_expr(expr[1], size, signed, values, sigs)
        b = _eval_expr(expr[2], size, signed, values, sigs)
        return _wrap(a - b if tag == "sub" else a + b, size, signed)
    # shifts: amount is a self-determined constant
    k = expr[2]
    v = _eval_expr(expr[1], size, signed, values, sigs)
    if k >= 64:
        raise RTLSimError(f"shift amount {k} out of simulator range")
    if tag == "shl":
        return _wrap(v << k, size, signed)
    if tag == "srl" or not signed:
        return (v & ((1 << size) - 1)) >> k  # logical
    return v >> k  # arithmetic: v is already sign-correct at `size`


# ----------------------------------------------------------------------
# Simulation
# ----------------------------------------------------------------------
@dataclass
class SimResult:
    """Outputs plus the cycle accounting of one streamed simulation."""

    y: np.ndarray  # int64 [T, ..., n_outputs], aligned to the input stream
    latency_cycles: int
    n_cycles: int  # total clock cycles simulated (T + latency)
    n_registers: int
    register_bits: int
    stage_register_bits: list[int]

    def accounting(self) -> dict:
        """JSON-ready per-stage cycle/register accounting."""
        return {
            "latency_cycles": self.latency_cycles,
            "ii": 1,
            "n_cycles": self.n_cycles,
            "n_registers": self.n_registers,
            "register_bits": self.register_bits,
            "stage_register_bits": list(self.stage_register_bits),
        }


class RTLSimulator:
    """Cycle-accurate evaluator for a parsed :class:`RTLModule`.

    Values are numpy ``int64`` arrays over an arbitrary *lane* shape —
    lanes are independent instances of the module (batch dimension), all
    clocked in lockstep.  Registers reset to 0.
    """

    def __init__(self, module: RTLModule | str):
        if isinstance(module, str):
            module = parse_verilog(module)
        self.module = module
        self._sigs = module.signals
        # precompute (context size, context signedness) per assignment
        self._ctx: dict[int, tuple[int, bool]] = {}
        for a in module.comb_order + module.clocked:
            lhs = self._sigs[a.dst]
            # signal widths are bounded by _MAX_WIDTH (checked in _analyze)
            # and decimal literals self-size to 32, so the context never
            # exceeds the exact-int64 range
            size = max(lhs.width, _self_size(a.expr, self._sigs))
            if size > _MAX_WIDTH:
                raise RTLSimError(f"expression for {a.dst!r} exceeds {_MAX_WIDTH} bits")
            self._ctx[id(a)] = (size, _self_signed(a.expr, self._sigs))
        self.reset()

    # -- state ---------------------------------------------------------
    def reset(self, lane_shape: tuple[int, ...] = ()) -> None:
        self._lanes = tuple(lane_shape)
        z = np.zeros(self._lanes, dtype=np.int64)
        self.values: dict[str, np.ndarray] = {s: z.copy() for s in self._sigs}

    # -- one cycle -----------------------------------------------------
    def _drive(self, x: np.ndarray) -> None:
        x = np.asarray(x, dtype=np.int64)
        if x.shape[-1] != len(self.module.inputs):
            raise RTLSimError(
                f"expected {len(self.module.inputs)} inputs, got {x.shape[-1]}"
            )
        if x.shape[:-1] != self._lanes:
            self.reset(x.shape[:-1])
        for i, nm in enumerate(self.module.inputs):
            s = self._sigs[nm]
            self.values[nm] = _wrap(x[..., i], s.width, s.signed)

    def _compute(self, a: Assign) -> np.ndarray:
        size, signed = self._ctx[id(a)]
        v = _eval_expr(a.expr, size, signed, self.values, self._sigs)
        lhs = self._sigs[a.dst]
        v = _wrap(v, lhs.width, lhs.signed)
        if np.shape(v) != self._lanes:  # constant expressions are scalar
            v = np.broadcast_to(np.asarray(v, dtype=np.int64), self._lanes)
        return v

    def _settle(self) -> None:
        for a in self.module.comb_order:
            self.values[a.dst] = self._compute(a)

    def _clock_edge(self) -> None:
        nxt = [(a.dst, self._compute(a)) for a in self.module.clocked]
        for dst, v in nxt:  # non-blocking: commit after all samples
            self.values[dst] = v

    def step(self, x: np.ndarray) -> np.ndarray:
        """Drive one input vector, settle, sample outputs, clock.

        ``x``: int array [..., n_inputs].  Returns int64 [..., n_outputs]
        as observed *this* cycle (pre-edge), i.e. the module's response
        to the input presented ``latency_cycles`` cycles ago.
        """
        self._drive(x)
        self._settle()
        y = np.stack([self.values[o] for o in self.module.outputs], axis=-1)
        if self.module.clock is not None:
            self._clock_edge()
        return y

    # -- streams -------------------------------------------------------
    def run_stream(self, x: np.ndarray) -> SimResult:
        """Stream ``x`` at II=1 and return latency-aligned outputs.

        ``x``: int array [T, ..., n_inputs] — one new vector per clock
        cycle.  The stream is padded with ``latency_cycles`` flush
        vectors; the returned ``y[t]`` is the output observed at cycle
        ``t + latency_cycles``, i.e. the module's response to ``x[t]``.
        """
        x = np.asarray(x, dtype=np.int64)
        if x.ndim < 2:
            raise RTLSimError("run_stream expects [T, ..., n_inputs]")
        mod = self.module
        lat = mod.latency_cycles
        self.reset(x.shape[1:-1])
        t_total = x.shape[0] + lat
        ys = []
        flush = np.zeros_like(x[0])
        for t in range(t_total):
            ys.append(self.step(x[t] if t < x.shape[0] else flush))
        y = np.stack(ys[lat:], axis=0)
        return SimResult(
            y=y,
            latency_cycles=lat,
            n_cycles=t_total,
            n_registers=mod.n_registers,
            register_bits=mod.register_bits(),
            stage_register_bits=mod.stage_register_bits(),
        )

    def run_combinational(self, x: np.ndarray) -> np.ndarray:
        """Evaluate a combinational module on a whole batch in one settle."""
        if self.module.clock is not None:
            raise RTLSimError("module is clocked; use run_stream")
        x = np.asarray(x, dtype=np.int64)
        self.reset(x.shape[:-1])
        return self.step(x)
