"""repro_torch.flow -- the one coherent entrypoint for the da4ml pipeline
in the port.

Typed configs (digest-compatible with ``repro.flow``; stdlib only):

    SolverConfig    one CMVM solve           (repro_torch.core.solve_cmvm)
    CompileConfig   one model compile        (repro_torch.nn.compile_model)
    ServeConfig     one serving deployment   (repro_torch.runtime engine)

Facade (loaded lazily):

    Flow            Flow.compile / Flow.load / Flow.serve
    Deployment      versioned model rollout over a ServeEngine
    Design          alias of repro_torch.nn.CompiledDesign (save/load)

Quickstart::

    from repro_torch.flow import CompileConfig, Design, Flow, ServeConfig, SolverConfig

    design = Flow.compile(model, params, in_shape, in_quant,
                          config=CompileConfig(solver=SolverConfig(dc=2)))
    design.save("artifacts/jet")

    dep = Flow.serve(ServeConfig(max_batch=256))           # on the CUDA card
    dep.register("jet", Design.load("artifacts/jet"))      # -> version 1
    y = dep.infer("jet", x_int)
    dep.register("jet", new_design)                        # v2: flip + drain v1

The facade symbols are exported via module ``__getattr__`` (PEP 562), so
``from repro_torch.flow.config import SolverConfig`` -- the import the
solver core uses -- never pulls in the facade and its engine.
"""

from .config import UNSET, CompileConfig, ConfigError, ServeConfig, SolverConfig

__all__ = [
    "UNSET",
    "CompileConfig",
    "CompiledDesign",
    "ConfigError",
    "Deployment",
    "Design",
    "Flow",
    "ServeConfig",
    "SolverConfig",
]

_LAZY = ("Flow", "Deployment", "Design", "CompiledDesign")


def __getattr__(name: str):
    if name in ("Flow", "Deployment"):
        from . import facade

        return getattr(facade, name)
    if name in ("Design", "CompiledDesign"):
        from ..nn.compiler import CompiledDesign

        return CompiledDesign
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")


def __dir__():
    return sorted(set(globals()) | set(_LAZY))
