"""Integer execution of compiled DA designs (the execution half of
``repro.nn``; the float front end and the compiler stay in the JAX
package for now), and its numpy interpreter, the serve fallback."""

from .compiler import CompiledDesign, LayerReport, StepSpec, build_steps
from .interpreter import adder_graph_numpy, build_numpy_steps, numpy_forward_fn
from .quant import QuantConfig

__all__ = [
    "CompiledDesign",
    "LayerReport",
    "QuantConfig",
    "StepSpec",
    "adder_graph_numpy",
    "build_numpy_steps",
    "build_steps",
    "numpy_forward_fn",
]
