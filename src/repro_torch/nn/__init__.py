"""Integer execution of compiled DA designs (the execution half of
``repro.nn``; the float front end and the compiler stay in the JAX
package for now)."""

from .compiler import CompiledDesign, LayerReport, StepSpec, build_steps
from .quant import QuantConfig

__all__ = ["CompiledDesign", "LayerReport", "QuantConfig", "StepSpec", "build_steps"]
