"""Quantized-NN substrate of the port: HGQ-style QAT layers in PyTorch,
the paper's benchmark networks, the da4ml compile path (the weights are
quantized and the CMVMs solved with numpy on the host), compiled
designs on the card, and their numpy interpreter, the serve fallback."""

from . import models
from .compiler import CompiledDesign, LayerReport, StepSpec, build_steps, compile_model
from .interpreter import adder_graph_numpy, build_numpy_steps, numpy_forward_fn
from .layers import (
    AvgPool2D,
    Flatten,
    MaxPool2D,
    QConv2D,
    QDense,
    QDenseOnAxis,
    ReLU,
    Residual,
    Sequential,
    apply_model,
    init_params,
    params_from_numpy,
)
from .quant import QuantConfig, bit_count_surrogate, fake_quant, to_grid_int

__all__ = [
    "AvgPool2D",
    "CompiledDesign",
    "Flatten",
    "LayerReport",
    "MaxPool2D",
    "QConv2D",
    "QDense",
    "QDenseOnAxis",
    "QuantConfig",
    "ReLU",
    "Residual",
    "Sequential",
    "StepSpec",
    "adder_graph_numpy",
    "apply_model",
    "bit_count_surrogate",
    "build_numpy_steps",
    "build_steps",
    "compile_model",
    "fake_quant",
    "init_params",
    "models",
    "numpy_forward_fn",
    "params_from_numpy",
    "to_grid_int",
]
