"""Compiled-design artifacts (``da4ml-design`` v1), shared with the JAX
package in both directions.

A design's execution is fully determined by plain integer data: the
packed DAIS program of every unique CMVM, the bias / pre-shift / requant
arrays of each step, the step topology and the quantization metadata.
``save_design`` writes exactly that -- ``design.npz`` (int64 arrays, no
pickle) and ``manifest.json`` -- in the JAX package's format, and
``load_design`` rebuilds a design from an artifact either package wrote.
:func:`design_from_arrays` is the step that carries a design's integer
data (the manifest dict and its arrays) onto a device.

Crash safety: ``save_design`` commits in order -- arrays first, manifest
last -- each written to a temp name, fsync'd, renamed into place, and the
directory fsync'd after each rename.  The manifest binds the arrays by
content digest (``arrays_sha256``) and is the commit record: a crash
leaves the previous complete artifact or a stray temp file, never a
manifest pointing at missing or torn arrays.  ``load_design`` maps every
torn, truncated or mixed-generation shape to :class:`ArtifactCorruptError`
and can quarantine the directory aside.  The fault points of
:mod:`repro_torch.chaos` (``artifact.save.arrays``,
``artifact.save.truncate``, ``artifact.save.commit``,
``artifact.load.read``) provoke each crash window, as in the JAX package.
"""

from __future__ import annotations

import hashlib
import json
import os
import time
import zipfile
from dataclasses import asdict
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..analysis.verify import TIERS, DesignVerificationError, verify_design
from ..chaos import fault_point, io_fault
from ..core.dais import DAISProgram, qints_from_array, qints_to_array
from ..flow.config import CompileConfig
from ..kernels.adder_graph import compile_tables
from ..nn.compiler import CompiledDesign, LayerReport, StepSpec
from ..nn.quant import QuantConfig
from ..obs import trace

FORMAT_NAME = "da4ml-design"
FORMAT_VERSION = 1
_PROGRAM_KEYS = ("rows", "outputs", "n_inputs")


class ArtifactCorruptError(ValueError):
    """The artifact directory exists but its contents are damaged:
    truncated or torn ``design.npz``, unparsable ``manifest.json``, a
    manifest whose digest does not match the arrays (mixed generation),
    or arrays missing keys the manifest references.  When
    ``load_design(..., on_corrupt="quarantine")`` moved the directory
    aside, the destination is on ``quarantined_to``."""

    def __init__(self, message: str, quarantined_to: Path | None = None):
        super().__init__(message)
        self.quarantined_to = quarantined_to


def _fsync_replace(tmp: Path, dst: Path) -> None:
    """fsync ``tmp``, rename it over ``dst``, fsync the directory."""
    with open(tmp, "rb") as fh:
        os.fsync(fh.fileno())
    tmp.replace(dst)
    dfd = os.open(dst.parent, os.O_RDONLY)
    try:
        os.fsync(dfd)
    finally:
        os.close(dfd)


def _arrays_digest(arrays: dict[str, np.ndarray]) -> str:
    """Content hash binding manifest.json to its design.npz."""
    h = hashlib.sha256(b"da4ml-design-arrays-v1")
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def _sanitize(obj):
    """Keep only JSON-serializable scalars (recursively) from a stats dict."""
    if isinstance(obj, dict):
        out = {}
        for k, v in obj.items():
            s = _sanitize(v)
            if s is not None:
                out[str(k)] = s
        return out
    if isinstance(obj, (bool, int, float, str)):
        return obj
    if isinstance(obj, np.integer):
        return int(obj)
    if isinstance(obj, np.floating):
        return float(obj)
    return None


def save_design(design: CompiledDesign, path: str | Path) -> Path:
    """Persist a design to ``path`` (a directory, created) in the
    ``da4ml-design`` v1 format.  Raises ``ValueError`` if a program or
    the output qints cannot be packed into int64 arrays."""
    path = Path(path)
    path.mkdir(parents=True, exist_ok=True)
    arrays: dict[str, np.ndarray] = {}

    for i, parr in enumerate(design.programs):
        if parr is None:
            raise ValueError(f"program {i} is not int64-serializable; design cannot be saved")
        for k in _PROGRAM_KEYS:
            arrays[f"prog{i}_{k}"] = parr[k]

    counter = iter(range(1 << 30))

    def spec_json(s: StepSpec) -> dict:
        entry: dict = {"kind": s.kind, "params": s.params, "table": s.table}
        refs: dict[str, str] = {}
        for name, arr in s.arrays.items():
            key = f"step{next(counter)}_{name}"
            arrays[key] = np.asarray(arr, np.int64)
            refs[name] = key
        entry["arrays"] = refs
        if s.body is not None:
            entry["body"] = [spec_json(b) for b in s.body]
        return entry

    steps_json = [spec_json(s) for s in design.step_specs]
    try:
        arrays["out_qints"] = qints_to_array(design.out_qints)
    except OverflowError as e:
        raise ValueError(f"output qints not int64-serializable: {e}") from e

    manifest = {
        "format": FORMAT_NAME,
        "version": FORMAT_VERSION,
        "arrays_sha256": _arrays_digest(arrays),
        "in_quant": {
            "bits": design.in_quant.bits,
            "int_bits": design.in_quant.int_bits,
            "signed": design.in_quant.signed,
        },
        "in_shape": list(design.in_shape),
        "out_shape": list(design.out_shape),
        "use_pallas": bool(design.use_pallas),
        "n_programs": len(design.programs),
        "steps": steps_json,
        "compile_config": design.config.to_dict() if design.config is not None else None,
        "compile_config_digest": design.config.digest() if design.config is not None else None,
        "reports": [asdict(r) for r in design.reports],
        "solver_stats": _sanitize(design.solver_stats),
        "resources": {
            "total_adders": design.total_adders,
            "total_cost_bits": design.total_cost_bits,
            "total_ff_bits": design.total_ff_bits,
            "latency_cycles": design.latency_cycles,
            "max_depth": design.max_depth,
        },
    }

    # ordered commit: arrays first, manifest (the commit record) last
    tmp = path / "design.tmp.npz"
    fault_point("artifact.save.arrays")
    np.savez_compressed(tmp, **arrays)
    io_fault("artifact.save.truncate", tmp)  # simulated torn write
    _fsync_replace(tmp, path / "design.npz")
    fault_point("artifact.save.commit")  # crash between arrays and commit
    tmp_manifest = path / "manifest.tmp.json"
    tmp_manifest.write_text(json.dumps(manifest, indent=2, sort_keys=True))
    _fsync_replace(tmp_manifest, path / "manifest.json")
    return path


def _quarantine(path: Path) -> Path:
    """Rename a corrupt artifact directory aside (``<name>.quarantined``,
    numeric suffix on collision)."""
    dst = path.with_name(path.name + ".quarantined")
    n = 1
    while dst.exists():
        dst = path.with_name(f"{path.name}.quarantined.{n}")
        n += 1
    path.rename(dst)
    return dst


def _corrupt(path: Path, message: str, on_corrupt: str) -> ArtifactCorruptError:
    """Build (and, if asked, quarantine for) a corruption error."""
    quarantined_to = None
    if on_corrupt == "quarantine":
        try:
            quarantined_to = _quarantine(path)
            message += f" (quarantined to {quarantined_to})"
        except OSError:
            pass  # read-only store: still raise the typed error
    return ArtifactCorruptError(message, quarantined_to=quarantined_to)


def load_design(
    path: str | Path,
    device: str | torch.device | None = None,
    verify: str = "off",
    on_corrupt: str = "raise",
) -> CompiledDesign:
    """Rebuild a design from a ``da4ml-design`` artifact on ``device``
    (default: the CUDA card; raises without one unless ``device="cpu"``).

    No solver runs: the tables are recompiled from the packed programs.
    ``verify`` ("off" default / "cheap" / "strict") runs the static
    verifier (:mod:`repro_torch.analysis`) on the rebuilt design and
    records it in ``solver_stats["verify"]``; error-severity findings
    raise ``DesignVerificationError``.  Damage raises :class:`ArtifactCorruptError`; a wrong format or
    version stays a plain ``ValueError``.  ``on_corrupt="quarantine"``
    first renames the damaged directory to ``<name>.quarantined``.
    Traced as a host span ``design.load`` (``repro_torch.obs.trace``).
    """
    dev = resolve_device(device)
    if verify not in TIERS:
        raise ValueError(f"unknown verify tier {verify!r} (expected one of {TIERS})")
    if on_corrupt not in ("raise", "quarantine"):
        raise ValueError(f"on_corrupt must be 'raise' or 'quarantine', got {on_corrupt!r}")
    with trace.span("design.load"):
        t0 = time.perf_counter()
        path = Path(path)
        fault_point("artifact.load.read")
        try:
            manifest_text = (path / "manifest.json").read_text()
        except FileNotFoundError:
            if (path / "design.npz").exists():
                raise _corrupt(
                    path,
                    f"{path}: design.npz present but manifest.json missing "
                    "(interrupted save; artifact never committed)",
                    on_corrupt,
                ) from None
            raise
        try:
            manifest = json.loads(manifest_text)
        except json.JSONDecodeError as e:
            raise _corrupt(
                path, f"{path}: manifest.json is not valid JSON ({e})", on_corrupt
            ) from e
        if not isinstance(manifest, dict) or manifest.get("format") != FORMAT_NAME:
            raise ValueError(f"{path}: not a {FORMAT_NAME} artifact")
        if manifest.get("version") != FORMAT_VERSION:
            raise ValueError(f"{path}: unsupported artifact version {manifest.get('version')}")
        try:
            with np.load(path / "design.npz", allow_pickle=False) as z:
                arrays = {k: z[k] for k in z.files}
        except FileNotFoundError:
            raise _corrupt(
                path, f"{path}: manifest.json present but design.npz missing", on_corrupt
            ) from None
        except (zipfile.BadZipFile, OSError, ValueError, EOFError) as e:
            raise _corrupt(
                path, f"{path}: design.npz is torn or truncated ({e})", on_corrupt
            ) from e
        want = manifest.get("arrays_sha256")
        if want is not None and _arrays_digest(arrays) != want:
            raise _corrupt(
                path,
                f"{path}: design.npz does not match manifest.json "
                "(corrupt or mixed-generation artifact)",
                on_corrupt,
            )
        try:
            design = design_from_arrays(manifest, arrays, dev)
        except KeyError as e:
            raise _corrupt(
                path,
                f"{path}: manifest references missing array {e} "
                "(corrupt or mixed-generation artifact)",
                on_corrupt,
            ) from e
        design.solver_stats["load_s"] = time.perf_counter() - t0
        if verify != "off":
            vrep = verify_design(design, tier=verify)
            design.solver_stats["verify"] = {
                "tier": verify,
                "ok": vrep.ok,
                "n_errors": len(vrep.errors),
                "n_warnings": len(vrep.warnings),
                "pass_wall_s": {k: v for k, v in vrep.pass_wall_s.items() if isinstance(v, float)},
            }
            if not vrep.ok:
                raise DesignVerificationError(vrep, context=f"artifact {path}")
        return design


def design_from_arrays(
    manifest: dict, arrays: dict[str, np.ndarray], device: str | torch.device | None = None
) -> CompiledDesign:
    """Build a design on ``device`` from an artifact's manifest dict and
    its integer arrays (what ``save_design`` writes, in either package).
    Raises ``KeyError`` when the manifest references a missing array."""
    device = resolve_device(device)
    programs = []
    tables = []
    for i in range(manifest["n_programs"]):
        parr = {k: arrays[f"prog{i}_{k}"] for k in _PROGRAM_KEYS}
        programs.append(parr)
        tables.append(compile_tables(DAISProgram.from_arrays(parr)))

    def spec_from(entry: dict) -> StepSpec:
        return StepSpec(
            entry["kind"],
            params=entry["params"],
            arrays={name: arrays[key] for name, key in entry["arrays"].items()},
            table=entry.get("table", -1),
            body=[spec_from(b) for b in entry["body"]] if "body" in entry else None,
        )

    iq = manifest["in_quant"]
    cfg_dict = manifest.get("compile_config")
    return CompiledDesign(
        step_specs=[spec_from(e) for e in manifest["steps"]],
        tables=tables,
        programs=programs,
        in_quant=QuantConfig(iq["bits"], iq["int_bits"], iq["signed"]),
        in_shape=tuple(manifest["in_shape"]),
        out_shape=tuple(manifest["out_shape"]),
        out_qints=qints_from_array(arrays["out_qints"]),
        device=device,
        reports=[LayerReport(**r) for r in manifest["reports"]],
        solver_stats={
            "n_solves": 0,
            "n_cache_hits": 0,
            "n_pool_solves": 0,
            "pool_fallback": "loaded_from_artifact",
            "solver_time_s": 0.0,
            "loaded_from_artifact": True,
            "compile_solver_stats": manifest.get("solver_stats", {}),
        },
        use_pallas=bool(manifest.get("use_pallas", False)),
        config=CompileConfig.from_dict(cfg_dict) if cfg_dict is not None else None,
    )
