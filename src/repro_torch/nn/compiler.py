"""Compiled DA designs as PyTorch modules: the integer executor.

A design's execution pipeline is a list of declarative :class:`StepSpec`
records (the same records, with the same meaning, as in the JAX
package) plus one set of adder-graph tables per unique CMVM.
:func:`build_steps` turns the specs into ``nn.Module`` steps whose
integer constants (bias, shifts, requant deltas) are buffers, so they
move to the design's device once, with the design, and never per call.

Activations flow as int32 ``[batch, prod(shape)]`` in C order.  Every
step reproduces the JAX executor bit for bit: int32 wraparound, a left
shift of 32 or more gives 0, an arithmetic right shift of 32 or more
gives the sign fill, and the avgpool sum stays int32.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch
from torch import nn

from .._device import resolve_device
from ..core.fixed_point import QInterval
from ..flow.config import CompileConfig
from ..kernels.adder_graph import AdderGraphTables, adder_graph_apply
from .quant import QuantConfig


@dataclass
class LayerReport:
    name: str
    shape: str
    adders: int
    cost_bits: int
    depth: int
    stages: int
    ff_bits: int
    solver_time_s: float


@dataclass
class StepSpec:
    """Declarative description of one executor step.

    kind    one of dense / conv / requant / transpose / relu / maxpool /
            avgpool / residual.
    params  JSON-serializable scalars (shapes, strides, clip bounds).
    arrays  integer numpy arrays (bias, pre-shift, requant shifts).
    table   index into ``CompiledDesign.tables`` for CMVM kinds, else -1.
    body    nested specs (residual only).
    """

    kind: str
    params: dict = field(default_factory=dict)
    arrays: dict = field(default_factory=dict)
    table: int = -1
    body: list[StepSpec] | None = None


def _int_row(arr) -> torch.Tensor:
    """An integer array as an int32 [1, n] tensor (broadcast over the batch)."""
    return torch.as_tensor(np.asarray(arr).astype(np.int32)).reshape(1, -1)


# ----------------------------------------------------------------------
# Steps
# ----------------------------------------------------------------------
class _Cmvm(nn.Module):
    """``y = adder_graph(x) << shift + bias`` on one table."""

    def __init__(self, spec: StepSpec, tables: list[AdderGraphTables]):
        super().__init__()
        self.tables = tables[spec.table]
        a = spec.arrays
        self.register_buffer("bias", _int_row(a["bias"])[0] if "bias" in a else None)
        self.register_buffer("shift", _int_row(a["shift"]) if "shift" in a else None)

    def cmvm(self, v: torch.Tensor) -> torch.Tensor:
        y = adder_graph_apply(self.tables, v)
        if self.shift is not None:
            y = y << self.shift
        return y + self.bias if self.bias is not None else y


class _Dense(_Cmvm):
    def __init__(self, spec, tables):
        super().__init__(spec, tables)
        self.d_in = spec.params["d_in"]

    def forward(self, v):
        return self.cmvm(v.reshape(-1, self.d_in)).reshape(v.shape[0], -1)


class _Conv(_Cmvm):
    """VALID convolution by im2col over NHWC activations."""

    def __init__(self, spec, tables):
        super().__init__(spec, tables)
        p = spec.params
        self.hwc = (p["h"], p["w"], p["cin"])
        self.kernel = (p["kh"], p["kw"])
        self.stride = (p["sh"], p["sw"])
        self.out_hw = (p["oh"], p["ow"])

    def forward(self, v):
        (kh, kw), (sh, sw), (oh, ow) = self.kernel, self.stride, self.out_hw
        x = v.reshape(-1, *self.hwc)
        patches = [
            x[:, dy : dy + sh * (oh - 1) + 1 : sh, dx : dx + sw * (ow - 1) + 1 : sw, :]
            for dy in range(kh)
            for dx in range(kw)
        ]
        cols = torch.cat(patches, dim=-1)  # [B, oh, ow, kh*kw*cin]
        y = self.cmvm(cols.reshape(-1, cols.shape[-1]))
        return y.reshape(-1, oh * ow * y.shape[-1])


class _Requant(nn.Module):
    """Shift each feature onto the target grid (left for d > 0, arithmetic
    right otherwise), then saturate."""

    def __init__(self, spec):
        super().__init__()
        d = np.asarray(spec.arrays["d"], np.int64)
        self.register_buffer("dpos", _int_row(np.maximum(d, 0)))
        self.register_buffer("dneg", _int_row(np.maximum(-d, 0)))
        self.lo, self.hi = spec.params["lo"], spec.params["hi"]

    def forward(self, v):
        v = torch.where(self.dpos > 0, v << self.dpos, v >> self.dneg)
        return v.clamp(self.lo, self.hi)


class _Transpose(nn.Module):
    def __init__(self, spec):
        super().__init__()
        self.shape = tuple(spec.params["shape"])
        self.perm = (0, *[q + 1 for q in spec.params["perm"]])

    def forward(self, v):
        n = v.shape[0]
        return v.reshape(n, *self.shape).permute(self.perm).reshape(n, -1)


class _ReLU(nn.Module):
    def forward(self, v):
        return v.clamp(min=0)


class _Pool(nn.Module):
    def __init__(self, spec):
        super().__init__()
        p = spec.params
        self.is_max = spec.kind == "maxpool"
        self.grid = (p["h"] // p["ph"], p["ph"], p["w"] // p["pw"], p["pw"], p["c"])

    def forward(self, v):
        x = v.reshape(-1, *self.grid)
        # an int32 sum would otherwise widen to int64
        r = x.amax(dim=(2, 4)) if self.is_max else x.sum(dim=(2, 4), dtype=torch.int32)
        return r.reshape(v.shape[0], -1)


class _Residual(nn.Module):
    """``(v << sa) + (body(v) << sb)``: both branches on a common grid."""

    def __init__(self, spec, tables):
        super().__init__()
        self.body = nn.ModuleList(_build_step(s, tables) for s in spec.body or [])
        self.register_buffer("sa", _int_row(spec.arrays["sa"]))
        self.register_buffer("sb", _int_row(spec.arrays["sb"]))

    def forward(self, v):
        u = v
        for s in self.body:
            u = s(u)
        return (v << self.sa) + (u << self.sb)


def build_steps(specs: list[StepSpec], tables: list[AdderGraphTables]) -> nn.ModuleList:
    """The executable pipeline of a design, built on the CPU from its
    step specs and tables (move it with the design)."""
    return nn.ModuleList(_build_step(s, tables) for s in specs)


def _build_step(spec: StepSpec, tables: list[AdderGraphTables]) -> nn.Module:
    kind = spec.kind
    if kind == "dense":
        return _Dense(spec, tables)
    if kind == "conv":
        return _Conv(spec, tables)
    if kind == "requant":
        return _Requant(spec)
    if kind == "transpose":
        return _Transpose(spec)
    if kind == "relu":
        return _ReLU()
    if kind in ("maxpool", "avgpool"):
        return _Pool(spec)
    if kind == "residual":
        return _Residual(spec, tables)
    raise ValueError(f"unknown step kind {kind!r}")


def count_cmvm_steps(specs: list[StepSpec]) -> int:
    """CMVM steps of a pipeline, residual bodies included: the number of
    adder-graph calls one ``forward_int`` makes."""
    return sum(
        (s.kind in ("dense", "conv")) + count_cmvm_steps(s.body or []) for s in specs
    )


# ----------------------------------------------------------------------
# Design
# ----------------------------------------------------------------------
class CompiledDesign(nn.Module):
    """A compiled DA design on one device.

    ``forward_int`` runs the integer pipeline on grid integers;
    ``forward`` (the module's call) quantizes floats onto the input grid
    and scales the integer outputs back.  ``programs`` are the packed
    DAIS programs (``DAISProgram.to_arrays`` dicts) the tables were
    built from; together with ``step_specs`` they are what an artifact
    stores.  ``use_pallas`` is the JAX package's kernel switch, carried
    through so that manifests round-trip; it selects nothing here.
    """

    def __init__(
        self,
        *,
        step_specs: list[StepSpec],
        tables: list[AdderGraphTables],
        programs: list[dict],
        in_quant: QuantConfig,
        in_shape: tuple,
        out_shape: tuple,
        out_qints: list[QInterval],
        device: str | torch.device | None = None,
        reports: list[LayerReport] | None = None,
        solver_stats: dict | None = None,
        use_pallas: bool = False,
        config: CompileConfig | None = None,
    ):
        super().__init__()
        dev = resolve_device(device)
        self.step_specs = step_specs
        self.tables = tables
        self.programs = programs
        self.in_quant = in_quant
        self.in_shape = tuple(in_shape)
        self.out_shape = tuple(out_shape)
        self.out_qints = out_qints
        self.reports = list(reports or [])
        self.solver_stats = dict(solver_stats or {})
        self.use_pallas = bool(use_pallas)
        self.config = config
        self.steps = build_steps(step_specs, tables)
        exps = np.array([0 if q.is_zero else q.exp for q in out_qints], np.float64)
        self.register_buffer(
            "out_scale", torch.tensor(2.0**exps, dtype=torch.float32).reshape(self.out_shape)
        )
        self.to(dev)

    @property
    def device(self) -> torch.device:
        return self.out_scale.device

    def _apply(self, fn, recurse=True):
        # every move (to / cuda / cpu) also places the tables on the new
        # device, so no call copies them
        super()._apply(fn, recurse)
        for t in self.tables:
            t.device_arrays(self.device)
        return self

    # ------------------------------------------------------------------
    def save(self, path):
        """Persist as a ``da4ml-design`` artifact (see
        :func:`repro_torch.runtime.save_design`)."""
        from ..runtime.artifact import save_design  # runtime imports nn

        return save_design(self, path)

    @classmethod
    def load(cls, path, device=None, verify: str = "off", on_corrupt: str = "raise"):
        """Rebuild a design from an artifact on ``device`` (see
        :func:`repro_torch.runtime.load_design`)."""
        from ..runtime.artifact import load_design  # runtime imports nn

        return load_design(path, device=device, verify=verify, on_corrupt=on_corrupt)

    @property
    def total_adders(self) -> int:
        return sum(r.adders for r in self.reports)

    @property
    def total_cost_bits(self) -> int:
        return sum(r.cost_bits for r in self.reports)

    @property
    def total_ff_bits(self) -> int:
        return sum(r.ff_bits for r in self.reports)

    @property
    def latency_cycles(self) -> int:
        return sum(r.stages for r in self.reports)

    @property
    def max_depth(self) -> int:
        return max((r.depth for r in self.reports), default=0)

    # ------------------------------------------------------------------
    def forward_int(self, x_int: torch.Tensor) -> torch.Tensor:
        """Run the integer pipeline.  x_int: int tensor [batch, *in_shape]
        of grid integers on the design's device; returns int32
        [batch, *out_shape]."""
        if x_int.device != self.device:
            raise ValueError(
                f"input is on {x_int.device}, the design on {self.device}; "
                "move one of them"
            )
        n = x_int.shape[0]
        v = x_int.reshape(n, -1).to(torch.int32)
        for step in self.steps:
            v = step(v)
        return v.reshape(n, *self.out_shape)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Float in, float out: floor onto the input grid, saturate, run
        the integer pipeline, scale the outputs by their grid steps."""
        q = self.in_quant
        xi = torch.clamp(torch.floor(x / q.step), q.qint.lo, q.qint.hi).to(torch.int32)
        return self.forward_int(xi).to(torch.float32) * self.out_scale

    def summary(self) -> str:
        hdr = (
            f"{'layer':<20}{'shape':<14}{'adders':>8}{'LUTbits':>9}{'depth':>7}"
            f"{'stages':>7}{'FFbits':>8}{'t[s]':>8}"
        )
        rows = [hdr, "-" * len(hdr)]
        for r in self.reports:
            rows.append(
                f"{r.name:<20}{r.shape:<14}{r.adders:>8}{r.cost_bits:>9}{r.depth:>7}"
                f"{r.stages:>7}{r.ff_bits:>8}{r.solver_time_s:>8.2f}"
            )
        rows.append("-" * len(hdr))
        rows.append(
            f"{'TOTAL':<20}{'':<14}{self.total_adders:>8}{self.total_cost_bits:>9}"
            f"{self.max_depth:>7}{self.latency_cycles:>7}{self.total_ff_bits:>8}"
        )
        return "\n".join(rows)
