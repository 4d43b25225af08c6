"""Functional quantized NN layers in PyTorch, with explicit parameter
lists: the port's copy of the JAX package's ``repro.nn.layers``.

Models are ``Sequential`` tuples of frozen layer specs (the same specs
as the JAX package's).  The float forward path (``apply_model``) uses
straight-through fixed-point fake quantization and is *bit-compatible*
with the compiled integer adder graph (see compiler.py): floor rounding,
saturation, power-of-two-exact average pooling.  Run in float64 for
exact equality; float32 is within a few ulp of the hardware semantics.

Parameters are a list with one dict per layer (``{"w", "b"}`` for the
CMVM layers, ``{}`` for the rest, ``{"body": [...]}`` for a
``Residual``), the layout of the JAX package's; :func:`params_from_numpy`
carries that package's parameters across.
"""

from __future__ import annotations

from collections.abc import Mapping
from dataclasses import dataclass

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..random import key_words, split, uniform
from .quant import QuantConfig, bit_count_surrogate, fake_quant

# ----------------------------------------------------------------------
# Layer specs
# ----------------------------------------------------------------------


@dataclass(frozen=True)
class QDense:
    units: int
    w_quant: QuantConfig = QuantConfig(8, 2)
    out_quant: QuantConfig | None = None  # activation re-quantization
    use_bias: bool = True


@dataclass(frozen=True)
class QDenseOnAxis:
    """Dense along a non-final axis (EinsumDense, e.g. MLP-Mixer token mix)."""

    units: int
    axis: int
    w_quant: QuantConfig = QuantConfig(8, 2)
    out_quant: QuantConfig | None = None
    use_bias: bool = True


@dataclass(frozen=True)
class QConv2D:
    filters: int
    kernel: tuple[int, int] = (3, 3)
    strides: tuple[int, int] = (1, 1)
    padding: str = "VALID"
    w_quant: QuantConfig = QuantConfig(8, 2)
    out_quant: QuantConfig | None = None
    use_bias: bool = True


@dataclass(frozen=True)
class ReLU:
    out_quant: QuantConfig | None = None


@dataclass(frozen=True)
class MaxPool2D:
    size: tuple[int, int] = (2, 2)


@dataclass(frozen=True)
class AvgPool2D:
    """Power-of-two window: exact on the grid (sum then exponent shift)."""

    size: tuple[int, int] = (2, 2)


@dataclass(frozen=True)
class Flatten:
    pass


@dataclass(frozen=True)
class Residual:
    """y = x + body(x) (MLP-Mixer skip connection)."""

    body: tuple = ()


LayerSpec = QDense | QDenseOnAxis | QConv2D | ReLU | MaxPool2D | AvgPool2D | Flatten | Residual
Sequential = tuple  # tuple[LayerSpec, ...]


# ----------------------------------------------------------------------
# Initialisation
# ----------------------------------------------------------------------
def _glorot(key, shape: tuple, device: torch.device) -> torch.Tensor:
    fan_in = int(np.prod(shape[:-1]))
    lim = (3.0 / fan_in) ** 0.5
    return uniform(key, shape, -lim, lim, device=device)


def _out_shape(spec, shape: tuple) -> tuple:
    """Shape (batch excluded) after one layer."""
    if isinstance(spec, QDense):
        return shape[:-1] + (spec.units,)
    if isinstance(spec, QDenseOnAxis):
        ax = spec.axis % len(shape)
        return tuple(spec.units if i == ax else s for i, s in enumerate(shape))
    if isinstance(spec, QConv2D):
        (kh, kw), (sh, sw) = spec.kernel, spec.strides
        h, wd = shape[0], shape[1]
        if spec.padding == "VALID":
            h, wd = (h - kh) // sh + 1, (wd - kw) // sw + 1
        else:
            h, wd = -(-h // sh), -(-wd // sw)
        return (h, wd, spec.filters)
    if isinstance(spec, (MaxPool2D, AvgPool2D)):
        return (shape[0] // spec.size[0], shape[1] // spec.size[1], shape[2])
    if isinstance(spec, Flatten):
        return (int(np.prod(shape)),)
    if isinstance(spec, (ReLU, Residual)):
        return shape
    raise TypeError(f"unknown layer spec {spec}")


def init_params(
    rng: torch.Tensor,
    model: Sequential,
    in_shape: tuple[int, ...],
    device: str | torch.device | None = None,
):
    """Returns (params_list, out_shape); ``in_shape`` excludes the batch.

    The JAX package's ``init_params(rng, model, in_shape)``: each layer
    takes ``rng, sub = split(rng)``, a CMVM layer's weights are the
    Glorot-uniform float32 ``uniform(sub, shape, -lim, lim)`` and its
    biases zeros, and a ``Residual`` draws its body from ``sub``; so a
    key from ``repro_torch.random.PRNGKey(seed)`` gives that package's
    parameters of the same seed, bit for bit.  Drawn on ``device``
    (default: the CUDA card, by the threefry kernel; raises without one
    unless ``device="cpu"``).  A ``torch.Generator`` is refused.
    """
    key_words(rng)  # a key, not a torch.Generator
    dev = resolve_device(device)
    params: list[dict] = []
    shape = tuple(in_shape)
    for spec in model:
        rng, sub = split(rng)
        out = _out_shape(spec, shape)
        if isinstance(spec, (QDense, QDenseOnAxis, QConv2D)):
            if isinstance(spec, QDense):
                wshape = (shape[-1], spec.units)
            elif isinstance(spec, QDenseOnAxis):
                wshape = (shape[spec.axis % len(shape)], spec.units)
            else:
                wshape = (*spec.kernel, shape[-1], spec.filters)
            p = {"w": _glorot(sub, wshape, dev)}
            if spec.use_bias:
                p["b"] = torch.zeros(wshape[-1], dtype=torch.float32, device=dev)
            params.append(p)
        elif isinstance(spec, Residual):
            body, body_shape = init_params(sub, spec.body, shape, dev)
            assert body_shape == shape, "residual body must preserve shape"
            params.append({"body": body})
        else:
            params.append({})
        shape = out
    return params, shape


def params_from_numpy(
    tree, device: str | torch.device | None = None, model: Sequential | None = None
):
    """The JAX package's parameters as float32 tensors on ``device``
    (default: the CUDA card; raises without one unless ``device="cpu"``).

    ``tree`` is that package's parameter list (a list of dicts, with
    ``Residual`` entries nested under ``"body"``) holding numpy arrays,
    or, with ``model=``, a flat mapping whose keys are the ``"/"``-joined
    tree paths (``"0/w"``, ``"4/body/0/b"``; what ``params.npz`` holds):
    the model restores the layers that hold no array.
    """
    dev = resolve_device(device)
    if isinstance(tree, Mapping):
        if model is None:
            raise ValueError("a flat parameter mapping needs model= to restore its structure")
        tree = _unflatten(dict(tree.items()), model, "")

    def conv(t):
        if isinstance(t, dict):
            return {k: conv(v) for k, v in t.items()}
        if isinstance(t, (list, tuple)):
            return [conv(v) for v in t]
        return torch.tensor(np.asarray(t, np.float32), device=dev)

    return conv(tree)


def _unflatten(flat: dict, model: Sequential, prefix: str) -> list[dict]:
    params = []
    for i, spec in enumerate(model):
        if isinstance(spec, Residual):
            params.append({"body": _unflatten(flat, spec.body, f"{prefix}{i}/body/")})
            continue
        keys = {k: f"{prefix}{i}/{k}" for k in ("w", "b")}
        params.append({k: flat[key] for k, key in keys.items() if key in flat})
    return params


# ----------------------------------------------------------------------
# Forward pass (float, STE quantization)
# ----------------------------------------------------------------------
def _bias_quant(spec_w: QuantConfig, in_quant: QuantConfig) -> QuantConfig:
    """Bias lives on the accumulator grid (in_step * w_step), wide range."""
    exp = spec_w.scale_exp() + in_quant.scale_exp()
    bits = 24
    return QuantConfig(bits, bits + exp, True)


def _bias(spec, p: dict, cur_quant: QuantConfig | None) -> torch.Tensor:
    if cur_quant is None:
        return p["b"]
    return fake_quant(p["b"], _bias_quant(spec.w_quant, cur_quant), rounding="round")


def apply_model(
    params: list,
    model: Sequential,
    x: torch.Tensor,
    in_quant: QuantConfig | None = None,
    collect_bits: bool = False,
):
    """Run the float/STE forward pass on ``x`` [batch, *in_shape], in the
    dtype and on the device of ``x`` (the parameters must be on that
    device; float32 parameters are widened to a float64 ``x``).

    Every QDense/QConv input must already be on a known grid; pass
    ``in_quant`` to quantize the model input.  Returns y (and the
    bit-count regularisation penalty if collect_bits).
    """
    penalty = 0.0
    cur_quant = in_quant
    if in_quant is not None:
        x = fake_quant(x, in_quant)
    for spec, p in zip(model, params):
        if isinstance(spec, (QDense, QDenseOnAxis)):
            wq = fake_quant(p["w"], spec.w_quant, rounding="round").to(x.dtype)
            if collect_bits:
                penalty = penalty + bit_count_surrogate(p["w"], spec.w_quant)
            if isinstance(spec, QDenseOnAxis):
                ax = spec.axis % (x.ndim - 1) + 1  # feature axes exclude batch
                x = torch.movedim(torch.movedim(x, ax, -1) @ wq, -1, ax)
                bshape = tuple(spec.units if i == ax else 1 for i in range(1, x.ndim))
            else:
                x = x @ wq
                bshape = (spec.units,)
            if spec.use_bias:
                x = x + _bias(spec, p, cur_quant).reshape(bshape)
            cur_quant = spec.out_quant
            if cur_quant is not None:
                x = fake_quant(x, cur_quant)
        elif isinstance(spec, QConv2D):
            wq = fake_quant(p["w"], spec.w_quant, rounding="round").to(x.dtype)
            if collect_bits:
                penalty = penalty + bit_count_surrogate(p["w"], spec.w_quant)
            x = _conv_nhwc(x, wq, spec)
            if spec.use_bias:
                x = x + _bias(spec, p, cur_quant)
            cur_quant = spec.out_quant
            if cur_quant is not None:
                x = fake_quant(x, cur_quant)
        elif isinstance(spec, ReLU):
            # torch.maximum splits the gradient at a tie, as jnp.maximum does
            x = torch.maximum(x, x.new_zeros(()))
            if spec.out_quant is not None:
                x = fake_quant(x, spec.out_quant)
                cur_quant = spec.out_quant
        elif isinstance(spec, MaxPool2D):
            x = _pool_windows(x, spec.size).amax(dim=(2, 4))
        elif isinstance(spec, AvgPool2D):
            k = spec.size[0] * spec.size[1]
            assert k & (k - 1) == 0, "AvgPool window must be a power of two"
            x = _pool_windows(x, spec.size).sum(dim=(2, 4)) / k
        elif isinstance(spec, Flatten):
            x = x.reshape(x.shape[0], -1)
        elif isinstance(spec, Residual):
            x = x + apply_model(p["body"], spec.body, x, in_quant=cur_quant)
            cur_quant = None
        else:
            raise TypeError(f"unknown layer spec {spec}")
    if collect_bits:
        return x, penalty
    return x


def same_pads(n: int, k: int, s: int) -> tuple[int, int]:
    """Zeros before and after an axis of ``n`` for a SAME window of ``k``
    at stride ``s``, by the JAX package's rule: ``ceil(n / s)`` outputs,
    ``total // 2`` zeros before and the rest after."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _conv_nhwc(x: torch.Tensor, w: torch.Tensor, spec: QConv2D) -> torch.Tensor:
    """NHWC x HWIO convolution with the JAX package's VALID / SAME padding
    (:func:`same_pads`)."""
    xc = x.permute(0, 3, 1, 2)
    if spec.padding != "VALID":
        pads = [same_pads(n, k, s) for n, k, s in zip(xc.shape[2:], spec.kernel, spec.strides)]
        xc = F.pad(xc, (*pads[1], *pads[0]))
    y = F.conv2d(xc, w.permute(3, 2, 0, 1), stride=tuple(spec.strides))
    return y.permute(0, 2, 3, 1)


def _pool_windows(x: torch.Tensor, size: tuple[int, int]) -> torch.Tensor:
    """[B, H, W, C] -> [B, H//ph, ph, W//pw, pw, C] (VALID: a ragged
    edge is dropped)."""
    ph, pw = size
    oh, ow = x.shape[1] // ph, x.shape[2] // pw
    x = x[:, : oh * ph, : ow * pw]
    return x.reshape(x.shape[0], oh, ph, ow, pw, x.shape[3])
