"""Static design verification: abstract-interpretation lint passes.

Three passes over a compiled design (or a saved artifact directory),
each emitting structured :class:`Diagnostic` findings with stable
``DA0xx`` codes:

* :mod:`repro_torch.analysis.program` — DAIS program verifier: re-derives
  every row's interval/depth/cost from the inputs, re-derives the
  pipeline schedule, audits the emitted Verilog's declared widths.
* :mod:`repro_torch.analysis.steps` — StepSpec pipeline checker: replays the
  compiler's interval flow across the step topology and checks every
  baked array (requant shifts, bias pre-shifts, residual alignments)
  and the final output intervals against the re-derivation.
* :mod:`repro_torch.analysis.artifact` — artifact auditor: content digests,
  config-digest consistency, npz key integrity, solve-free loadability.

Entry points: :func:`verify_design` (design object or artifact path,
``tier`` in ``off``/``cheap``/``strict``), ``python -m repro_torch.analysis``
over artifact directories, ``CompileConfig(verify=...)`` (the
compile-time gate of ``repro_torch.nn.compile_model``), and
``load_design(verify=...)``.

A copy of the JAX package's static verifier (pure Python over numpy
arrays): the same codes, severities and locations on the same design.

See ``docs/analysis.md`` for the full diagnostic-code reference.
"""

from .artifact import audit_artifact
from .diagnostics import CODES, Diagnostic, DiagnosticReport
from .program import (
    check_emission,
    check_pipeline,
    check_program,
    derive_row_qints,
    required_signed_width,
)
from .steps import check_steps
from .verify import TIERS, DesignVerificationError, verify_design

__all__ = [
    "CODES",
    "TIERS",
    "DesignVerificationError",
    "Diagnostic",
    "DiagnosticReport",
    "audit_artifact",
    "check_emission",
    "check_pipeline",
    "check_program",
    "check_steps",
    "derive_row_qints",
    "required_signed_width",
    "verify_design",
]
