"""Three-way RTL co-simulation harness (the hardware-honest gate).

The paper's claims are hardware claims: the DA adder graphs must
produce bit-exact CMVM results *as RTL*, cycle-accurately, not just as
integer math on a device.  This module drives the same fixed-seed
vectors through three implementations of one :class:`DAISProgram` and
asserts bit equality per output and per cycle:

1. **simulated RTL** -- ``emit_verilog`` output executed by the
   pure-Python netlist simulator (:mod:`rtlsim`), streamed at II=1 with
   real register fill latency;
2. **the DAIS interpreter** -- ``DAISProgram.evaluate`` (exact int64);
3. **the device leg** -- ``compile_tables`` + ``adder_graph_apply`` on
   ``device``: on the CUDA card the hand-written adder-graph kernel, on
   the CPU its plain PyTorch version.  The report keeps the JAX
   package's key ``jit`` for it.  Its only skips are ``jit="skip"`` and
   a program wider than the kernel's int32 (with ``jit="auto"``); a
   missing card, or a kernel that does not build or launch, raises.

On top of value equality the harness cross-checks the *cycle*
contract: the latency the netlist actually exhibits (register crossings
counted by :func:`rtlsim.parse_verilog`) must equal
``PipelineReport.latency_cycles``, and every input->output path must
cross the same number of registers (checked structurally by rtlsim).

An optional external leg replays the exact same vectors through a real
event-driven simulator (Verilator 5 ``--binary --timing``, or Icarus
Verilog) via a generated self-checking testbench.

A port of the JAX package's ``repro.core.cosim``: the same grid, the
same vectors, the same report.
"""

from __future__ import annotations

import shutil
import subprocess
import tempfile
from pathlib import Path
from collections.abc import Sequence

import numpy as np
import torch

from .._device import resolve_device
from ..flow.config import SolverConfig
from .dais import DAISProgram
from .fixed_point import QInterval
from .pipelining import pipeline
from .rtlsim import RTLSimulator, parse_verilog
from .solver import _solve_cmvm, naive_adder_tree
from .verilog import emit_verilog

__all__ = [
    "cosim_program",
    "cosim_case",
    "cosim_grid",
    "default_grid",
    "external_tool",
    "run_external",
]

_JIT_SAFE_BITS = 31  # the adder-graph kernel evaluates in int32


def random_vectors(prog: DAISProgram, n: int, seed: int) -> np.ndarray:
    """Uniform random integer vectors within each input's exact interval."""
    rng = np.random.default_rng(seed)
    qs = [prog.rows[i].qint for i in range(prog.n_inputs)]
    lo = np.array([q.lo for q in qs], dtype=np.int64)
    hi = np.array([q.hi for q in qs], dtype=np.int64)
    return rng.integers(lo, hi + 1, size=(n, len(qs)), dtype=np.int64)


def _jit_leg(
    prog: DAISProgram, x: np.ndarray, want: np.ndarray, mode: str, device
) -> dict:
    """Run the program's instruction tables through ``adder_graph_apply``
    on ``device`` (the card's kernel, or the CPU's plain version).

    mode: "require" (a program past int32 raises), "auto" (records that
    skip), "skip" (never attempt).  Nothing else is skipped: without a
    card ``device=None`` raises, as a failed kernel build or launch does.
    """
    if mode == "skip":
        return {"status": "skipped", "reason": "disabled"}
    if mode not in ("require", "auto"):
        raise ValueError(f"jit must be 'require', 'auto' or 'skip', got {mode!r}")
    widths = [q.width for q in prog.output_qints()] + [
        prog.rows[i].qint.width for i in range(prog.n_inputs)
    ]
    if max(widths, default=0) > _JIT_SAFE_BITS:
        if mode == "require":
            raise ValueError("program exceeds the adder-graph kernel's int32 range")
        return {"status": "skipped", "reason": "exceeds int32"}
    from ..kernels.adder_graph import adder_graph_apply, compile_tables

    dev = resolve_device(device)
    tables = compile_tables(prog)
    got = adder_graph_apply(tables, torch.from_numpy(x).to(dev)).cpu().numpy().astype(np.int64)
    mismatches = int(np.count_nonzero(np.any(got != want, axis=-1)))
    return {"status": "checked", "bit_exact": mismatches == 0, "mismatches": mismatches}


def cosim_program(
    prog: DAISProgram,
    *,
    module_name: str = "cmvm",
    max_delay_per_stage: int | None = 3,
    n_vectors: int = 64,
    seed: int = 0,
    jit: str = "auto",
    external: str = "skip",
    device: str | torch.device | None = None,
) -> dict:
    """Co-simulate one DAIS program; returns a JSON-ready report.
    ``device`` carries the device leg (default: the CUDA card).

    The report never raises on a mismatch — gates key off
    ``bit_exact``/``latency_ok`` so a failing case still reports which
    outputs and how many vectors diverged.
    """
    pipelined = max_delay_per_stage is not None
    verilog = emit_verilog(prog, module_name, max_delay_per_stage)
    module = parse_verilog(verilog)
    rep = pipeline(prog, max_delay_per_stage if pipelined else 1 << 30)

    x = random_vectors(prog, n_vectors, seed)
    want = prog.evaluate(x)

    sim = RTLSimulator(module)
    if pipelined:
        res = sim.run_stream(x)
        got = res.y
        accounting = res.accounting()
    else:
        got = sim.run_combinational(x)
        accounting = {
            "latency_cycles": 0,
            "ii": 1,
            "n_cycles": 1,
            "n_registers": 0,
            "register_bits": 0,
            "stage_register_bits": [],
        }

    per_output = np.count_nonzero(got != want, axis=0)
    mismatches = int(np.count_nonzero(np.any(got != want, axis=-1)))
    expected_latency = rep.latency_cycles if pipelined else 0
    report = {
        "module": module_name,
        "pipelined": pipelined,
        "max_delay_per_stage": max_delay_per_stage,
        "n_vectors": int(n_vectors),
        "seed": int(seed),
        "n_inputs": prog.n_inputs,
        "n_outputs": len(prog.outputs),
        "adders": prog.n_adders,
        "cost_bits": prog.cost_bits,
        "n_stages": rep.n_stages if pipelined else 1,
        "expected_latency_cycles": expected_latency,
        "latency_ok": module.latency_cycles == expected_latency,
        "bit_exact": mismatches == 0,
        "mismatched_vectors": mismatches,
        "mismatches_per_output": [int(c) for c in per_output],
        "accounting": accounting,
        "jit": _jit_leg(prog, x, want, jit, device),
    }
    if external != "skip":
        report["external"] = run_external(
            verilog, module_name, x, want, expected_latency, mode=external
        )
    return report


def cosim_case(
    m: np.ndarray,
    *,
    name: str | None = None,
    strategy: str = "da",
    engine: str = "batch",
    dc: int = -1,
    max_delay_per_stage: int | None = 3,
    qint_in: Sequence[QInterval] | None = None,
    n_vectors: int = 64,
    seed: int = 0,
    jit: str = "auto",
    external: str = "skip",
    device: str | torch.device | None = None,
) -> dict:
    """Solve ``y = x @ m`` with the given strategy/engine and co-simulate."""
    m = np.asarray(m)
    if strategy == "latency":
        sol = naive_adder_tree(m, qint_in=qint_in)
    elif strategy == "da":
        sol = _solve_cmvm(m, qint_in, None, SolverConfig(dc=dc, engine=engine))
    else:
        raise ValueError(f"unknown strategy {strategy!r}")
    mdps = max_delay_per_stage
    label = name or (
        f"{strategy}-{engine if strategy == 'da' else 'tree'}-"
        f"{m.shape[0]}x{m.shape[1]}-{'p' + str(mdps) if mdps else 'comb'}"
    )
    report = cosim_program(
        sol.program,
        module_name=label.replace("-", "_"),
        max_delay_per_stage=mdps,
        n_vectors=n_vectors,
        seed=seed,
        jit=jit,
        external=external,
        device=device,
    )
    report.update(
        name=label,
        shape=[int(m.shape[0]), int(m.shape[1])],
        strategy=strategy,
        engine=engine if strategy == "da" else None,
        dc=dc,
    )
    return report


# ----------------------------------------------------------------------
# The grid
# ----------------------------------------------------------------------
def _grid_matrix(shape: tuple[int, int], seed: int, lo: int = -64, hi: int = 64) -> np.ndarray:
    return np.random.default_rng(seed).integers(lo, hi, size=shape)


def default_grid(seed: int = 0, n_vectors: int = 64) -> list[dict]:
    """The CI co-sim grid: {strategy × engine × pipelined/comb × shape}.

    Shapes include an all-zero output column (emitted as ``assign y = 0``)
    and an all-negative column; one case drives unsigned (non-negative)
    input intervals — the regression for the signed-width emission fix —
    and one exercises the negative-shift (``>>>``) output path via
    fractional fixed-point inputs.
    """
    m_zero_neg = _grid_matrix((3, 4), seed + 1)
    m_zero_neg[:, 1] = 0  # constant-zero output column
    m_zero_neg[:, 2] = -np.abs(m_zero_neg[:, 2]) - 1  # all-negative column
    shapes = {
        "3x4-zeroneg": m_zero_neg,
        "4x4": _grid_matrix((4, 4), seed + 2),
        "6x3": _grid_matrix((6, 3), seed + 3),
        "8x8": _grid_matrix((8, 8), seed + 4, lo=-32, hi=32),
    }
    cases: list[dict] = []
    for label, m in shapes.items():
        for mdps in (1, 3, None):
            for strategy, engine in (
                ("da", "batch"),
                ("da", "heap"),
                ("da", "arena"),
                ("latency", None),
            ):
                # full engine cross only on the pipelined mdps=3 leg;
                # engines are bit-identical by construction (enforced in
                # tests/test_cse_engines.py) so one engine suffices on
                # the other timing legs
                if mdps != 3 and engine not in ("batch", None):
                    continue
                cases.append(dict(
                    name=f"{strategy}-{engine or 'tree'}-{label}-"
                         f"{'p' + str(mdps) if mdps else 'comb'}",
                    m=m,
                    strategy=strategy,
                    engine=engine or "batch",
                    max_delay_per_stage=mdps,
                    n_vectors=n_vectors,
                    seed=seed + len(cases),
                ))
    # unsigned (non-negative) input intervals: the signed-width regression
    cases.append(dict(
        name="da-batch-4x3-unsigned-p2",
        m=_grid_matrix((4, 3), seed + 5),
        strategy="da",
        engine="batch",
        max_delay_per_stage=2,
        qint_in=[QInterval.from_fixed(False, 8, 8)] * 4,
        n_vectors=n_vectors,
        seed=seed + 101,
    ))
    # fractional fixed-point inputs: output terms carry negative shifts,
    # exercising the `(src >>> k)` / `-(src >>> k)` emission paths
    cases.append(dict(
        name="da-batch-4x4-fracgrid-comb",
        m=_grid_matrix((4, 4), seed + 6) / 4.0,
        strategy="da",
        engine="batch",
        max_delay_per_stage=None,
        qint_in=[QInterval.from_fixed(True, 10, 4)] * 4,
        n_vectors=n_vectors,
        seed=seed + 102,
    ))
    return cases


def cosim_grid(
    cases: list[dict] | None = None,
    *,
    jit: str = "auto",
    external: str = "skip",
    device: str | torch.device | None = None,
) -> dict:
    """Run a list of :func:`cosim_case` kwargs; aggregate into one report."""
    if cases is None:
        cases = default_grid()
    reports = []
    for c in cases:
        kw = dict(c)
        m = kw.pop("m")
        reports.append(cosim_case(m, jit=jit, external=external, device=device, **kw))
    jit_checked = sum(1 for r in reports if r["jit"].get("status") == "checked")
    ext = [r.get("external") for r in reports if r.get("external") is not None]
    ext_checked = sum(1 for e in ext if e.get("status") == "checked")
    all_ok = all(r["bit_exact"] and r["latency_ok"] for r in reports)
    jit_ok = all(
        r["jit"].get("bit_exact", True) for r in reports
    )
    ext_ok = all(e.get("bit_exact", True) for e in ext)
    return {
        "kind": "rtl_cosim",
        "n_cases": len(reports),
        "n_bit_exact": sum(1 for r in reports if r["bit_exact"]),
        "all_bit_exact": all_ok and jit_ok and ext_ok,
        "jit": {
            "checked": jit_checked,
            "skipped": len(reports) - jit_checked,
            "ok": jit_ok,
        },
        "external": {
            "tool": ext[0].get("tool") if ext else None,
            "checked": ext_checked,
            "ok": ext_ok,
        },
        "cases": reports,
    }


# ----------------------------------------------------------------------
# External reference simulators (Verilator / Icarus Verilog)
# ----------------------------------------------------------------------
def external_tool() -> str | None:
    """Which external simulator is available: 'verilator', 'iverilog', None."""
    if shutil.which("verilator"):
        return "verilator"
    if shutil.which("iverilog"):
        return "iverilog"
    return None


def _make_testbench(module, module_name: str, x: np.ndarray) -> str:
    """Self-contained Verilog testbench replaying ``x`` at II=1.

    The event ordering matches :meth:`RTLSimulator.step`: drive inputs,
    let combinational logic settle (#1), display outputs, then clock.
    Outputs are printed every cycle; the first ``latency`` lines are
    pipeline fill (Icarus prints x's there — ignored by the parser).
    """
    sigs = module.signals
    lines = ["`timescale 1ns/1ps", "module tb;"]
    conns = []
    if module.clock is not None:
        lines.append("  reg clk = 0;")
        conns.append(".clk(clk)")
    for nm in module.inputs:
        s = sigs[nm]
        lines.append(f"  reg signed [{s.width - 1}:0] {nm};")
        conns.append(f".{nm}({nm})")
    for nm in module.outputs:
        s = sigs[nm]
        lines.append(f"  wire signed [{s.width - 1}:0] {nm};")
        conns.append(f".{nm}({nm})")
    lines.append(f"  {module_name} u_dut ({', '.join(conns)});")
    fmt = " ".join(["%0d"] * len(module.outputs))
    args = ", ".join(module.outputs)
    lat = module.latency_cycles
    lines.append("  initial begin")
    total = x.shape[0] + lat
    for t in range(total):
        row = x[t] if t < x.shape[0] else np.zeros(x.shape[1], dtype=np.int64)
        for i, nm in enumerate(module.inputs):
            lines.append(f"    {nm} = {int(row[i])};")
        lines.append("    #1;")
        lines.append(f'    $display("{fmt}", {args});')
        if module.clock is not None:
            lines.append("    clk = 1; #1; clk = 0;")
    lines.append("    $finish;")
    lines.append("  end")
    lines.append("endmodule")
    return "\n".join(lines)


def run_external(
    verilog_src: str,
    module_name: str,
    x: np.ndarray,
    want: np.ndarray,
    latency: int,
    mode: str = "auto",
    tool: str | None = None,
) -> dict:
    """Replay ``x`` through a real simulator and compare against ``want``.

    mode: "require" raises when no tool is available; "auto" returns a
    loud skip record instead.  Returns a JSON-ready report.
    """
    tool = tool or external_tool()
    if tool is None:
        msg = "no external simulator found (need verilator or iverilog on PATH)"
        if mode == "require":
            raise RuntimeError(msg)
        print(f"SKIP external co-sim: {msg}")
        return {"status": "skipped", "reason": msg}
    module = parse_verilog(verilog_src)
    tb = _make_testbench(module, module_name, x)
    with tempfile.TemporaryDirectory(prefix="rtl_cosim_") as td:
        tdir = Path(td)
        (tdir / "dut.v").write_text(verilog_src)
        (tdir / "tb.v").write_text(tb)
        if tool == "verilator":
            build = subprocess.run(
                ["verilator", "--binary", "--timing", "-Wno-fatal", "-Wno-WIDTH",
                 "--Mdir", str(tdir / "obj"), "-o", "sim", "tb.v", "dut.v"],
                cwd=tdir, capture_output=True, text=True,
            )
            if build.returncode != 0:
                return {"status": "error", "tool": tool,
                        "reason": build.stderr[-2000:]}
            run = subprocess.run(
                [str(tdir / "obj" / "sim")], cwd=tdir, capture_output=True, text=True
            )
        else:
            build = subprocess.run(
                ["iverilog", "-g2001", "-o", "tb.vvp", "tb.v", "dut.v"],
                cwd=tdir, capture_output=True, text=True,
            )
            if build.returncode != 0:
                return {"status": "error", "tool": tool,
                        "reason": build.stderr[-2000:]}
            run = subprocess.run(
                ["vvp", "tb.vvp"], cwd=tdir, capture_output=True, text=True
            )
        if run.returncode != 0:
            return {"status": "error", "tool": tool, "reason": run.stderr[-2000:]}
    rows = []
    for line in run.stdout.splitlines():
        parts = line.split()
        if len(parts) == len(module.outputs) and all(
            p.lstrip("-").isdigit() or "x" in p.lower() for p in parts
        ):
            rows.append(parts)
    if len(rows) < x.shape[0] + latency:
        return {"status": "error", "tool": tool,
                "reason": f"expected {x.shape[0] + latency} output lines, "
                          f"got {len(rows)}"}
    got = np.zeros((x.shape[0], len(module.outputs)), dtype=np.int64)
    bad = 0
    for t in range(x.shape[0]):
        for j, p in enumerate(rows[latency + t]):
            if "x" in p.lower():
                bad += 1  # X after the fill window is itself a failure
            else:
                got[t, j] = int(p)
    mismatches = int(np.count_nonzero(np.any(got != want, axis=-1))) + bad
    return {
        "status": "checked",
        "tool": tool,
        "bit_exact": mismatches == 0,
        "mismatched_vectors": mismatches,
        "x_states_after_fill": bad,
    }
