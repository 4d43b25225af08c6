"""The ``repro_torch.flow`` facade: compile once, deploy versioned, serve many.

``Flow`` is the single entrypoint over the three pipeline stages --

    Flow.compile(model, params, in_shape, in_quant, config=CompileConfig())
        -> CompiledDesign            (design.save(path) persists it)
    Flow.load(path)
        -> CompiledDesign            (zero solver calls)
    Flow.serve(ServeConfig())
        -> Deployment                (versioned registry over ServeEngine)

The port of the JAX package's ``repro.flow.facade``, with its semantics;
every entry point also takes ``device`` (default: the CUDA card, which
raises without one; ``device="cpu"`` runs on the CPU).

``Deployment`` adds the rollout layer the bare :class:`ServeEngine`
refuses to provide (its ``register`` rejects duplicate names): every
model name maps to numbered versions, ``register`` of an existing name
creates the next version, flips the serving alias atomically, and then
drains the previous version -- queued and in-flight requests of v1
complete with v1's results while new traffic already lands on v2.
``activate`` flips back for rollback when old versions are kept alive
(``drain=False``).  A drained version's CUDA graphs and their memory
pool are released when its dispatchers stop.
"""

from __future__ import annotations

import threading
from pathlib import Path

import numpy as np
import torch

from .._device import resolve_device
from ..nn.compiler import CompiledDesign, _compile_model
from ..runtime.engine import EngineClosedError, ServeEngine
from .config import CompileConfig, ServeConfig

__all__ = ["Deployment", "Flow"]


class Flow:
    """Facade over compile -> artifact -> serve (all methods static)."""

    @staticmethod
    def compile(
        model,
        params,
        in_shape,
        in_quant,
        config: CompileConfig | None = None,
        device: str | torch.device | None = None,
    ) -> CompiledDesign:
        """Compile a quantized model into a bit-exact integer design on
        ``device``.

        Equivalent to ``repro_torch.nn.compile_model(..., config=config,
        device=device)``: the two paths share one implementation, so
        designs are bit-identical however they are built.
        """
        return _compile_model(model, params, in_shape, in_quant, config or CompileConfig(),
                              resolve_device(device))

    @staticmethod
    def load(
        path: str | Path,
        device: str | torch.device | None = None,
        verify: str = "off",
        on_corrupt: str = "raise",
    ) -> CompiledDesign:
        """Load a ``design.save(path)`` artifact onto ``device`` (zero
        solver calls).

        ``verify`` runs the static verifier on the loaded design ("off"
        default, "cheap", "strict"); error-severity findings raise
        :class:`repro_torch.analysis.DesignVerificationError`.

        Torn/truncated/mixed-generation artifacts raise
        :class:`repro_torch.runtime.ArtifactCorruptError`;
        ``on_corrupt="quarantine"`` first renames the damaged directory
        to ``<name>.quarantined``.
        """
        from ..runtime.artifact import load_design

        return load_design(path, device=device, verify=verify, on_corrupt=on_corrupt)

    @staticmethod
    def verify(design_or_path, tier: str = "strict"):
        """Statically verify a compiled design or artifact directory.

        Returns a :class:`repro_torch.analysis.DiagnosticReport` (never
        raises on findings; check ``report.ok`` / ``report.errors``).
        Artifact paths additionally run the artifact auditor before the
        program and step passes.
        """
        from ..analysis import verify_design

        return verify_design(design_or_path, tier=tier)

    @staticmethod
    def serve(
        config: ServeConfig | None = None,
        models: dict | None = None,
        warmup: bool = False,
        device: str | torch.device | None = None,
    ) -> "Deployment":
        """Create a :class:`Deployment` on ``device``; optionally register
        ``models`` (name -> design or artifact path) as version 1 each."""
        dep = Deployment(config, device=device)
        for name, design in (models or {}).items():
            dep.register(name, design, warmup=warmup)
        return dep


class Deployment:
    """Versioned model registry + serving alias over a :class:`ServeEngine`.

    Each registered design gets an engine entry ``{name}@v{version}``;
    ``name`` is a serving *alias* pointing at the active version.  The
    rollout sequence of ``register`` on an existing name is:

      1. register v_new (optionally warmed up) next to v_old;
      2. flip the alias to v_new atomically (new submits land on v_new);
      3. drain v_old: its dispatchers finish queued and in-flight
         requests -- their futures complete with v_old's results -- then
         shut down and release its graphs (skipped with ``drain=False``,
         keeping v_old around for ``activate``-based rollback).
    """

    def __init__(
        self,
        config: ServeConfig | None = None,
        engine: ServeEngine | None = None,
        drain_timeout: float = 30.0,
        device: str | torch.device | None = None,
    ):
        if engine is not None and (config is not None or device is not None):
            raise ValueError("pass either config=/device= or an existing engine=, not both")
        self.engine = (
            engine if engine is not None
            else ServeEngine(config or ServeConfig(), device=device)
        )
        self.config = self.engine.config
        # how long a retired version may take to finish its queued work
        # before remaining requests are failed loudly
        self.drain_timeout = drain_timeout
        self._lock = threading.Lock()
        # name -> {version: engine key}; None marks a registration in flight
        self._versions: dict[str, dict[int, str | None]] = {}
        self._active: dict[str, int] = {}

    # -- registry ------------------------------------------------------
    @staticmethod
    def _key(name: str, version: int) -> str:
        return f"{name}@v{version}"

    def register(
        self,
        name: str,
        design: CompiledDesign | str | Path,
        version: int | None = None,
        warmup: bool = False,
        drain: bool = True,
    ) -> int:
        """Register ``design`` (or an artifact path, loaded onto the
        deployment's device) as a version of ``name`` and make it the
        active one.  Returns the version number.

        ``version=None`` auto-increments; an explicit duplicate version
        raises ``ValueError``.  See the class docstring for the rollout
        sequence; ``drain=False`` keeps the previous version serving its
        engine key (for rollback via :meth:`activate`).
        """
        with self._lock:
            vers = self._versions.setdefault(name, {})
            if version is None:
                version = max(vers, default=0) + 1
            elif version in vers:
                raise ValueError(f"model {name!r} version {version} already registered")
            vers[version] = None  # reserve against concurrent registers
        key = self._key(name, version)
        try:
            self.engine.register(key, design, warmup=warmup)
        except BaseException:
            with self._lock:
                vers = self._versions.get(name)
                if vers is not None:
                    vers.pop(version, None)
                    if not vers:
                        del self._versions[name]
            raise
        with self._lock:
            # setdefault: a concurrent whole-model unregister may have
            # dropped the map; this register then (re)creates the model
            self._versions.setdefault(name, {})[version] = key
            old = self._active.get(name)
            self._active[name] = version  # atomic alias flip
        if drain and old is not None and old != version:
            self._retire(name, old)
        return version

    def _retire(self, name: str, version: int) -> None:
        """Drain and drop one version (its queued/in-flight futures
        complete before the dispatchers stop, bounded by
        ``drain_timeout``)."""
        with self._lock:
            key = self._versions.get(name, {}).pop(version, None)
        if key is not None:
            self.engine.unregister(key, timeout=self.drain_timeout)

    def activate(self, name: str, version: int) -> None:
        """Flip the serving alias to an already-registered version
        (rollback path for ``register(..., drain=False)``)."""
        with self._lock:
            if self._versions.get(name, {}).get(version) is None:
                raise KeyError(f"model {name!r} has no live version {version}")
            self._active[name] = version

    def unregister(self, name: str, version: int | None = None) -> None:
        """Drop one version, or the whole model (all versions + alias)."""
        if version is not None:
            with self._lock:
                if self._active.get(name) == version:
                    del self._active[name]
            self._retire(name, version)
            return
        # claim the whole version map atomically so a concurrent register
        # of the same name starts a fresh history instead of being
        # clobbered (and no engine runner can leak untracked)
        with self._lock:
            vers = self._versions.pop(name, {})
            self._active.pop(name, None)
        for _, key in sorted(vers.items()):
            if key is not None:
                self.engine.unregister(key, timeout=self.drain_timeout)

    def models(self) -> list[str]:
        with self._lock:
            return sorted(self._active)

    def versions(self, name: str) -> list[int]:
        """Live versions of ``name`` (drained versions drop out)."""
        with self._lock:
            return sorted(v for v, k in self._versions.get(name, {}).items() if k is not None)

    def active_version(self, name: str) -> int:
        with self._lock:
            try:
                return self._active[name]
            except KeyError:
                raise KeyError(f"model {name!r} has no active version") from None

    def _active_key(self, name: str) -> str:
        with self._lock:
            try:
                return self._versions[name][self._active[name]]
            except KeyError:
                raise KeyError(f"model {name!r} has no active version") from None

    def _on_active(self, name: str, call):
        """Resolve the alias and call the engine, re-resolving if the
        version was retired between the two steps (a submit racing a
        rollout must land on the new version, not KeyError -- and a
        submit that reached the old runner just as it closed gets
        EngineClosedError from the engine, which is the same race one
        step later, so it retries onto the new version too)."""
        for _ in range(8):
            key = self._active_key(name)
            try:
                return call(key)
            except KeyError:
                continue  # alias flipped and the old runner drained mid-call
            except EngineClosedError:
                continue  # runner grabbed just before its drain closed it
        raise KeyError(f"model {name!r}: active version kept changing; giving up")

    # -- serving (alias-resolved passthrough) --------------------------
    def submit(self, name: str, x: np.ndarray, deadline_s: float | None = None):
        return self._on_active(
            name, lambda key: self.engine.submit(key, x, deadline_s=deadline_s)
        )

    def submit_batch(self, name: str, xs, deadline_s: float | None = None) -> list:
        return self._on_active(
            name, lambda key: self.engine.submit_batch(key, xs, deadline_s=deadline_s)
        )

    def infer(
        self,
        name: str,
        x: np.ndarray,
        timeout: float | None = 30.0,
        deadline_s: float | None = None,
    ):
        return self._on_active(
            name, lambda key: self.engine.infer(key, x, timeout, deadline_s=deadline_s)
        )

    def warmup(self, name: str) -> float:
        return self._on_active(name, self.engine.warmup)

    def stats(self, name: str | None = None) -> dict:
        """Per-model stats of the *active* version (annotated with the
        version number), or all models when ``name`` is None."""
        if name is not None:
            s = self._on_active(name, self.engine.stats)
            s["version"] = self.active_version(name)
            s["model"] = name
            return s
        return {n: self.stats(n) for n in self.models()}

    def metrics_text(self) -> str:
        """Prometheus text exposition over every live engine entry
        (``{name}@v{version}`` keys; see ``ServeEngine.metrics_text``)."""
        return self.engine.metrics_text()

    # -- lifecycle -----------------------------------------------------
    def shutdown(self, timeout: float = 5.0) -> None:
        self.engine.shutdown(timeout)
        with self._lock:
            self._versions.clear()
            self._active.clear()

    def __enter__(self) -> "Deployment":
        return self

    def __exit__(self, *exc) -> None:
        self.shutdown()
