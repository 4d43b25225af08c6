"""Artifact auditor: is this ``da4ml-design`` directory trustworthy?

Audits a saved design directory (``manifest.json`` + ``design.npz``)
without trusting the loader: the content digest is recomputed from the
format specification (sha256 over ``"da4ml-design-arrays-v1"`` plus the
sorted npz keys and raw bytes — the contract ``save_design`` writes),
the embedded compile-config digest is recomputed through the typed
config, every npz key the manifest references must exist (and every npz
array should be referenced by something), and the manifest's resource
totals must equal what its own per-layer reports sum to.

The deep check then actually loads the design — through the real
``load_design`` path — and asserts the load ran **zero** solver calls,
which is the artifact format's core promise.  The loaded design is
returned so the program/steps passes can run on it.
"""

from __future__ import annotations

import hashlib
import json
from pathlib import Path
from typing import Any

import numpy as np

from .diagnostics import DiagnosticReport

__all__ = ["audit_artifact"]

_PASS = "artifact"
_FORMAT = "da4ml-design"
_VERSION = 1
_PROGRAM_KEYS = ("rows", "outputs", "n_inputs")


def _digest(arrays: dict[str, np.ndarray]) -> str:
    # the format's content-digest spec, restated (not imported from
    # runtime.artifact — the auditor must not inherit a loader bug)
    h = hashlib.sha256(b"da4ml-design-arrays-v1")
    for k in sorted(arrays):
        h.update(k.encode())
        h.update(np.ascontiguousarray(arrays[k]).tobytes())
    return h.hexdigest()


def _referenced_keys(manifest: dict) -> set[str]:
    keys: set[str] = {"out_qints"}
    for i in range(int(manifest.get("n_programs", 0))):
        keys.update(f"prog{i}_{k}" for k in _PROGRAM_KEYS)

    def walk(entries: list) -> None:
        for e in entries:
            keys.update((e.get("arrays") or {}).values())
            if "body" in e:
                walk(e["body"])

    walk(manifest.get("steps", []))
    return keys


def audit_artifact(
    path: str | Path,
    report: DiagnosticReport | None = None,
    *,
    load: bool = True,
) -> tuple[DiagnosticReport, Any]:
    """Audit one artifact directory.  Returns ``(report, design)`` —
    ``design`` is the loaded :class:`CompiledDesign` when ``load`` is
    true and the artifact was loadable, else None."""
    rep = report if report is not None else DiagnosticReport()
    path = Path(path)
    loc = {"artifact": str(path)}

    manifest_path = path / "manifest.json"
    npz_path = path / "design.npz"
    if not manifest_path.is_file() or not npz_path.is_file():
        rep.add(
            "DA040",
            "not a design artifact directory (manifest.json/design.npz missing)",
            loc=loc, passname=_PASS,
        )
        return rep, None
    try:
        manifest = json.loads(manifest_path.read_text())
    except (OSError, json.JSONDecodeError) as e:
        rep.add("DA040", f"manifest.json unreadable: {e}", loc=loc, passname=_PASS)
        return rep, None
    if manifest.get("format") != _FORMAT or manifest.get("version") != _VERSION:
        rep.add(
            "DA040",
            f"unsupported format/version "
            f"({manifest.get('format')!r} v{manifest.get('version')!r})",
            loc=loc, passname=_PASS,
        )
        return rep, None
    try:
        with np.load(npz_path, allow_pickle=False) as z:
            arrays = {k: z[k] for k in z.files}
    except Exception as e:
        rep.add("DA040", f"design.npz unreadable: {e}", loc=loc, passname=_PASS)
        return rep, None

    want = manifest.get("arrays_sha256")
    if want is None:
        rep.add(
            "DA041", "manifest carries no arrays_sha256 content digest",
            loc=loc, passname=_PASS, severity="warning",
        )
    elif _digest(arrays) != want:
        rep.add(
            "DA041",
            "design.npz content does not match the manifest digest "
            "(tampered or mixed-generation artifact)",
            loc=loc, passname=_PASS,
        )

    cfg_dict = manifest.get("compile_config")
    cfg_digest = manifest.get("compile_config_digest")
    if cfg_dict is not None:
        from ..flow.config import CompileConfig, ConfigError  # stdlib-only module

        try:
            derived = CompileConfig.from_dict(cfg_dict).digest()
        except (ConfigError, TypeError) as e:
            rep.add(
                "DA042", f"embedded compile_config does not validate: {e}",
                loc=loc, passname=_PASS,
            )
        else:
            if cfg_digest is not None and derived != cfg_digest:
                rep.add(
                    "DA042",
                    "compile_config_digest does not match the embedded config",
                    loc=loc, passname=_PASS,
                )

    wanted = _referenced_keys(manifest)
    missing = sorted(wanted - set(arrays))
    if missing:
        rep.add(
            "DA044",
            f"manifest references {len(missing)} missing npz key(s) "
            f"(first: {missing[0]!r})",
            loc=loc, passname=_PASS,
        )
    orphans = sorted(set(arrays) - wanted)
    if orphans:
        rep.add(
            "DA043",
            f"{len(orphans)} npz array(s) referenced by nothing "
            f"(first: {orphans[0]!r})",
            loc=loc, passname=_PASS,
        )

    reports = manifest.get("reports") or []
    res = manifest.get("resources")
    if res is not None and reports:
        derived_res = {
            "total_adders": sum(r.get("adders", 0) for r in reports),
            "total_cost_bits": sum(r.get("cost_bits", 0) for r in reports),
            "total_ff_bits": sum(r.get("ff_bits", 0) for r in reports),
            "latency_cycles": sum(r.get("stages", 0) for r in reports),
            "max_depth": max((r.get("depth", 0) for r in reports), default=0),
        }
        bad = {k: (res.get(k), v) for k, v in derived_res.items() if res.get(k) != v}
        if bad:
            k, (claimed, v) = next(iter(sorted(bad.items())))
            rep.add(
                "DA045",
                f"manifest resource totals disagree with the layer reports "
                f"({len(bad)} field(s); first: {k} claimed {claimed}, derived {v})",
                loc=loc, passname=_PASS,
            )

    design = None
    if load and not missing:
        from ..runtime.artifact import load_design  # lazy: runtime imports analysis

        try:
            # the passes read the design's host arrays only: no card needed
            design = load_design(path, device="cpu")
        except Exception as e:
            rep.add(
                "DA046", f"load_design failed: {type(e).__name__}: {e}",
                loc=loc, passname=_PASS,
            )
        else:
            stats = design.solver_stats or {}
            if stats.get("n_solves", 0) != 0 or not stats.get("loaded_from_artifact"):
                rep.add(
                    "DA046",
                    "artifact load ran solver work (cold start must be solve-free)",
                    loc=loc, passname=_PASS,
                )
    return rep, design
