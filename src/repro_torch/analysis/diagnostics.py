"""Structured diagnostics for the design verifier.

Every finding of every analysis pass is a :class:`Diagnostic` with a
stable ``DA0xx`` code, a severity, a human message, and a structured
location (program index / row / step path / artifact file).  Codes are
append-only: a code, once assigned a meaning, is never reused for a
different defect class — CI logs and mutation-canary tests key on them.

Code blocks by pass:

    DA001-DA019   DAIS program verifier (repro_torch.analysis.program)
    DA020-DA039   StepSpec pipeline checker (repro_torch.analysis.steps)
    DA040-DA059   artifact auditor (repro_torch.analysis.artifact)

Severity semantics: ``error`` findings mean the design is provably
malformed or its metadata provably inconsistent — gates (compile-time
verify, the design-lint CI job, the CLI) fail on them.  ``warning``
findings are suspicious-but-legal constructs (possible requant
saturation, dead steps, orphan arrays).  ``info`` is narration (skipped
checks on legacy artifacts).
"""

from __future__ import annotations

import json
from dataclasses import dataclass, field

__all__ = [
    "CODES",
    "Diagnostic",
    "DiagnosticReport",
    "Severity",
]

Severity = str  # "error" | "warning" | "info"

# code -> (default severity, one-line description); the reference table
# rendered in docs/analysis.md is generated from this registry.
CODES: dict[str, tuple[str, str]] = {
    # -- DAIS program verifier ----------------------------------------
    "DA001": ("error", "malformed row: bad kind, operand slot, or sign"),
    "DA002": ("error", "input-section violation: op before input, or n_inputs mismatch"),
    "DA003": ("error", "shift violation: negative shift or un-normalised shift pair"),
    "DA004": ("error", "row interval differs from abstract-interpretation derivation"),
    "DA005": ("error", "row adder depth differs from derived depth"),
    "DA006": ("error", "row cost differs from the Eq.(1) adder-cost model"),
    "DA007": ("error", "dangling output term: row out of range or bad sign"),
    "DA008": ("warning", "dead row: op not reachable from any output"),
    "DA009": ("error", "emitted wire narrower than the signed width its interval needs"),
    "DA010": ("error", "pipeline report disagrees with re-derived schedule/FF/latency"),
    "DA011": ("error", "emitted RTL is structurally unsound (register imbalance, parse)"),
    "DA012": ("error", "program totals (cost_bits/depth) disagree with claimed report"),
    "DA013": ("info", "program check skipped (simulator width limit or unpackable program)"),
    # -- StepSpec pipeline checker ------------------------------------
    "DA020": ("error", "CMVM step references a missing or out-of-range table/program"),
    "DA021": ("error", "shape flow broken: step input size incompatible with params"),
    "DA022": ("error", "CMVM arity/interval mismatch between step flow and program inputs"),
    "DA023": ("error", "malformed step arrays (bias/shift/requant lengths or values)"),
    "DA024": ("warning", "requant may saturate: derived interval exceeds clip range"),
    "DA025": ("warning", "dead step: provably a no-op on every reachable value"),
    "DA026": ("error", "design output intervals differ from re-derived interval flow"),
    "DA027": ("error", "unknown step kind"),
    "DA028": ("warning", "derived interval exceeds the int32 executor range"),
    "DA029": ("info", "step check skipped (legacy artifact lacks wscale/exp metadata)"),
    # -- artifact auditor ---------------------------------------------
    "DA040": ("error", "not a loadable design artifact (missing/bad manifest or format)"),
    "DA041": ("error", "design.npz content does not match the manifest digest"),
    "DA042": ("error", "compile-config digest inconsistent with the embedded config"),
    "DA043": ("warning", "orphan npz arrays not referenced by any step or program"),
    "DA044": ("error", "manifest references an npz key that does not exist"),
    "DA045": ("error", "manifest resource totals disagree with the layer reports"),
    "DA046": ("error", "artifact load failed or re-ran solves"),
    "DA047": ("error", "layer report claims match no program (stages/FF/adders)"),
}

_SEVERITIES = ("error", "warning", "info")


@dataclass(frozen=True)
class Diagnostic:
    """One verifier finding."""

    code: str
    message: str
    severity: Severity = ""
    # structured location, e.g. {"program": 0, "row": 17} or
    # {"step": "3/residual.1"} or {"artifact": "manifest.json"}
    loc: dict = field(default_factory=dict)
    passname: str = ""

    def __post_init__(self) -> None:
        if self.code not in CODES:
            raise ValueError(f"unknown diagnostic code {self.code!r}")
        if not self.severity:
            object.__setattr__(self, "severity", CODES[self.code][0])
        if self.severity not in _SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}")

    def to_dict(self) -> dict:
        return {
            "code": self.code,
            "severity": self.severity,
            "message": self.message,
            "loc": dict(self.loc),
            "pass": self.passname,
        }

    def __str__(self) -> str:
        loc = ",".join(f"{k}={v}" for k, v in sorted(self.loc.items()))
        where = f" [{loc}]" if loc else ""
        return f"{self.code} {self.severity}{where}: {self.message}"


@dataclass
class DiagnosticReport:
    """Ordered collection of findings plus per-pass accounting.

    ``ok`` is the gate predicate: no error-severity findings.  Reports
    compose — pass functions append into one shared report so one
    ``verify_design`` call yields one flat, JSON-serializable result.
    """

    diagnostics: list[Diagnostic] = field(default_factory=list)
    # pass name -> wall seconds (filled by verify_design)
    pass_wall_s: dict = field(default_factory=dict)
    tier: str = "cheap"

    def add(
        self,
        code: str,
        message: str,
        *,
        loc: dict | None = None,
        passname: str = "",
        severity: str = "",
    ) -> Diagnostic:
        d = Diagnostic(code, message, severity, dict(loc or {}), passname)
        self.diagnostics.append(d)
        return d

    def extend(self, other: "DiagnosticReport") -> None:
        self.diagnostics.extend(other.diagnostics)
        self.pass_wall_s.update(other.pass_wall_s)

    @property
    def errors(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "error"]

    @property
    def warnings(self) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.severity == "warning"]

    @property
    def ok(self) -> bool:
        return not self.errors

    def codes(self) -> set[str]:
        return {d.code for d in self.diagnostics}

    def by_code(self, code: str) -> list[Diagnostic]:
        return [d for d in self.diagnostics if d.code == code]

    def to_dict(self) -> dict:
        return {
            "ok": self.ok,
            "tier": self.tier,
            "n_errors": len(self.errors),
            "n_warnings": len(self.warnings),
            "diagnostics": [d.to_dict() for d in self.diagnostics],
            "pass_wall_s": dict(self.pass_wall_s),
        }

    def to_json(self, indent: int | None = 2) -> str:
        return json.dumps(self.to_dict(), indent=indent, sort_keys=True)

    def summary(self) -> str:
        head = (
            f"verify[{self.tier}]: "
            f"{'OK' if self.ok else 'FAIL'} "
            f"({len(self.errors)} errors, {len(self.warnings)} warnings)"
        )
        return "\n".join([head] + [f"  {d}" for d in self.diagnostics])
