"""``verify_design``: one entry point over the three analysis passes.

Tiers:

``off``     no checks, empty report.
``cheap``   program verifier (structure, intervals, depth, cost, pipeline
            re-derivation) + step-flow checker + report/program matching.
            Pure Python over the packed programs — fast enough to run on
            every compile (``CompileConfig.verify`` defaults to it).
``strict``  everything in cheap, plus the Verilog emission audit of every
            program (declared widths vs required signed widths, netlist
            register balance).  This is what the CLI runs.

``verify_design`` accepts either a compiled design object or an artifact
directory path; a path additionally runs the artifact auditor first and
then verifies the loaded design.
"""

from __future__ import annotations

import time
from pathlib import Path
from typing import Any

from ..core.dais import DAISProgram
from .artifact import audit_artifact
from .diagnostics import DiagnosticReport
from .program import _derive_schedule, check_emission, check_pipeline, check_program
from .steps import check_steps

__all__ = ["DesignVerificationError", "TIERS", "verify_design"]

TIERS = ("off", "cheap", "strict")

_STRUCTURAL = frozenset({"DA001", "DA002", "DA007"})


class DesignVerificationError(RuntimeError):
    """A verification gate found error-severity diagnostics.

    Carries the full :class:`DiagnosticReport` as ``.report``.
    """

    def __init__(self, report: DiagnosticReport, context: str = "design") -> None:
        self.report = report
        errs = report.errors
        head = ", ".join(d.code for d in errs[:4]) + ("…" if len(errs) > 4 else "")
        super().__init__(
            f"{context} failed static verification with {len(errs)} "
            f"error(s) [{head}] — see .report for diagnostics"
        )


def _unpack_programs(design: Any, rep: DiagnosticReport) -> list:
    progs = []
    for i, parr in enumerate(list(getattr(design, "programs", None) or [])):
        if parr is None:
            rep.add(
                "DA013",
                f"program {i} is not int64-packable; its checks are skipped",
                loc={"program": i}, passname="program",
            )
            progs.append(None)
        elif isinstance(parr, DAISProgram):
            progs.append(parr)
        else:
            try:
                progs.append(DAISProgram.from_arrays(parr))
            except Exception as e:
                rep.add(
                    "DA001",
                    f"program {i} arrays do not decode: {type(e).__name__}: {e}",
                    loc={"program": i}, passname="program",
                )
                progs.append(None)
    return progs


def _check_reports(design: Any, progs: list, scheds: list, rep: DiagnosticReport) -> None:
    """Match every LayerReport against some program's re-derived schedule.

    Reports do not name their program (layers deduplicate onto shared
    slots), so each report must be *explained by* at least one program:
    same stage count and FF bill (DA047 when none matches), and cost
    totals consistent with that program plus a bias stage (DA012).
    ``scheds`` holds each program's already-derived ``_derive_schedule``
    result (None where the program was skipped)."""
    reports = list(getattr(design, "reports", None) or [])
    if not reports:
        return
    derived = []
    for p, sched in zip(progs, scheds):
        if p is None or sched is None:
            derived.append(None)
            continue
        n_stages, _, ff = sched
        derived.append((n_stages, ff, p.n_adders, p.cost_bits, p.depth))
    if not any(d is not None for d in derived):
        return
    for k, r in enumerate(reports):
        loc = {"report": k, "layer": getattr(r, "name", f"report{k}")}
        sched = [
            d for d in derived if d is not None and d[0] == r.stages and d[1] == r.ff_bits
        ]
        if not sched:
            rep.add(
                "DA047",
                f"report claims {r.stages} stages / {r.ff_bits} FF bits but no "
                "program's re-derived schedule matches",
                loc=loc, passname="program",
            )
            continue
        # bias adds at most: +n_out adders / one depth level / bias widths
        if not any(
            r.adders >= na and r.cost_bits >= cb and d <= r.depth <= d + 1
            for (_, _, na, cb, d) in sched
        ):
            rep.add(
                "DA012",
                f"report totals (adders={r.adders}, cost_bits={r.cost_bits}, "
                f"depth={r.depth}) are inconsistent with every schedule-matched "
                "program",
                loc=loc, passname="program",
            )


def verify_design(
    design: Any,
    tier: str = "cheap",
    *,
    max_delay_per_stage: int | None = None,
) -> DiagnosticReport:
    """Statically verify a compiled design (or an artifact directory).

    Returns a :class:`DiagnosticReport`; ``report.ok`` is the gate
    predicate (no error-severity findings).  Never raises on findings —
    gate callers (compile, CLI, CI bench) decide how to fail.
    """
    if tier not in TIERS:
        raise ValueError(f"unknown verify tier {tier!r} (expected one of {TIERS})")
    rep = DiagnosticReport(tier=tier)
    if tier == "off":
        return rep

    if isinstance(design, (str, Path)):
        t0 = time.perf_counter()
        rep, loaded = audit_artifact(design, rep)
        rep.pass_wall_s["artifact"] = time.perf_counter() - t0
        if loaded is None:
            return rep
        design = loaded

    cfg = getattr(design, "config", None)
    mdps = max_delay_per_stage
    if mdps is None:
        mdps = getattr(cfg, "max_delay_per_stage", None) or 5

    # -- program pass --------------------------------------------------
    t0 = time.perf_counter()
    progs = _unpack_programs(design, rep)
    structural_ok: list[bool] = []
    scheds: list[tuple | None] = []
    by_prog: dict[int, float] = {}
    for i, p in enumerate(progs):
        tp = time.perf_counter()
        if p is None:
            structural_ok.append(False)
            scheds.append(None)
            continue
        sub = DiagnosticReport()
        check_program(p, sub, program_index=i)
        ok = not any(d.code in _STRUCTURAL for d in sub.errors)
        structural_ok.append(ok)
        rep.extend(sub)
        if ok:
            sched = _derive_schedule(p, mdps)
            check_pipeline(p, mdps, rep, program_index=i, derived=sched)
        else:
            sched = None
        scheds.append(sched)
        by_prog[i] = time.perf_counter() - tp
    _check_reports(
        design, [p if s else None for p, s in zip(progs, structural_ok)], scheds, rep
    )
    rep.pass_wall_s["program"] = time.perf_counter() - t0
    # per-program wall (keyed by program index) for per-layer attribution
    rep.pass_wall_s["program_by_index"] = by_prog

    # -- steps pass ----------------------------------------------------
    t0 = time.perf_counter()
    check_steps(design, rep, programs=progs)
    rep.pass_wall_s["steps"] = time.perf_counter() - t0

    # -- emission audit (strict only: emits + parses every program) ----
    if tier == "strict":
        t0 = time.perf_counter()
        for i, (p, ok) in enumerate(zip(progs, structural_ok)):
            if p is not None and ok:
                check_emission(p, mdps, rep, program_index=i)
        rep.pass_wall_s["emission"] = time.perf_counter() - t0
    return rep
