"""The port's SAME convolutions against the plain reference, on the CPU at
small sizes and on seeded random weights: ``forward_int`` of a design the
port compiles equals, integer for integer, the reference
(``reference/network.py``, which quantizes the float weights itself), the
port's numpy interpreter and its float64 layers on grid inputs.

Three networks: the SVHN CNN's own layers (``svhn_cnn_32``) at 16x16x3;
its layer kinds at a 12x12x3 frame (conv, ReLU, max pool, conv, ReLU,
average pool, dense); and one SAME conv at 16x16 with stride 2, whose
zeros are 0 before and 1 after each axis, so a swap of the two shows."""

import numpy as np
import pytest
import torch

from dabench.reference import network
from repro_torch import nn as tnn
from repro_torch.flow import CompileConfig
from repro_torch.random import PRNGKey

W, A = tnn.QuantConfig(6, 2, signed=True), tnn.QuantConfig(8, 4, signed=False)
IN = tnn.QuantConfig(8, 1, signed=False)
NETWORKS = {
    "svhn_cnn_32_at_16": (tnn.models.svhn_cnn_32()[0], (16, 16, 3)),
    "kinds_at_12": ((tnn.QConv2D(8, (3, 3), padding="SAME", w_quant=W), tnn.ReLU(A),
                     tnn.MaxPool2D((2, 2)),
                     tnn.QConv2D(12, (3, 3), padding="SAME", w_quant=W), tnn.ReLU(A),
                     tnn.AvgPool2D((2, 2)), tnn.Flatten(),
                     tnn.QDense(16, W), tnn.ReLU(A), tnn.QDense(10, W)), (12, 12, 3)),
    "stride_2_at_16": ((tnn.QConv2D(8, (3, 3), (2, 2), padding="SAME", w_quant=W),), (16, 16, 3)),
}


def _quant(q: tnn.QuantConfig) -> dict:
    return {"bits": q.bits, "int_bits": q.int_bits, "signed": q.signed}


def _config(model, in_shape) -> dict:
    """The reference's configuration of a port model."""
    layers = []
    for spec in model:
        if isinstance(spec, tnn.QConv2D):
            layers.append({"kind": "conv2d", "filters": spec.filters, "kernel": list(spec.kernel),
                           "strides": list(spec.strides), "w_quant": "w",
                           "padding": spec.padding.lower()})
        elif isinstance(spec, tnn.QDense):
            layers.append({"kind": "dense", "units": spec.units, "w_quant": "w"})
        elif isinstance(spec, tnn.ReLU):
            layers.append({"kind": "relu", "out_quant": "a"})
        elif isinstance(spec, (tnn.MaxPool2D, tnn.AvgPool2D)):
            kind = "maxpool" if isinstance(spec, tnn.MaxPool2D) else "avgpool"
            layers.append({"kind": kind, "size": list(spec.size)})
        else:
            layers.append({"kind": "flatten"})
    return {"in_shape": list(in_shape), "in_quant": _quant(IN), "layers": layers,
            "quant": {"w": _quant(W), "a": _quant(A)}}


def _params(model, in_shape, seed, biased):
    """The port's Glorot draw; ``biased``: with biases drawn beside it, so
    that they count (the draw's own are zero)."""
    params, _ = tnn.init_params(PRNGKey(seed), model, in_shape, device="cpu")
    g = torch.Generator().manual_seed(seed)
    for p in params:
        if "b" in p and biased:
            p["b"] = torch.randn(p["b"].shape, generator=g) * 0.25
    return params


def _compile(model, in_shape, params):
    return tnn.compile_model(model, params, in_shape, IN, config=CompileConfig(jobs=1),
                             device="cpu")


@pytest.fixture(scope="module", params=sorted(NETWORKS))
def compiled(request):
    """The network's name, model, input shape and grid inputs, and for
    ``biased`` False and True its parameters and design."""
    model, in_shape = NETWORKS[request.param]
    x = torch.randint(0, 256, (48, *in_shape), generator=torch.Generator().manual_seed(6),
                      dtype=torch.int32)
    designs = {}
    for biased in (False, True):
        params = _params(model, in_shape, 5, biased)
        designs[biased] = params, _compile(model, in_shape, params)
    return request.param, model, in_shape, x, designs


@pytest.mark.parametrize("biased", [False, True])
def test_forward_int_equals_the_reference(compiled, biased):
    _, model, in_shape, x, designs = compiled
    params, design = designs[biased]
    flat = {f"{i}/{k}": v.numpy() for i, p in enumerate(params) for k, v in p.items()}
    want = network.Reference(_config(model, in_shape), flat)(x)
    got = design.forward_int(x).to(torch.int64)
    assert torch.equal(got.reshape(want.shape), want)


@pytest.mark.parametrize("biased", [False, True])
def test_forward_int_equals_the_interpreter(compiled, biased):
    *_, x, designs = compiled
    design = designs[biased][1]
    want = tnn.numpy_forward_fn(design)(x.numpy())
    np.testing.assert_array_equal(design.forward_int(x).numpy(), want)


def test_forward_int_equals_the_float_layers(compiled):
    """On the draw's zero biases, as ``tests/test_torch_nn.py`` compares
    VALID designs: the float layers put a bias on the grid of the layer's
    input type, which after an average pool is coarser than the grid the
    design and the reference give it."""
    _, model, _, x, designs = compiled
    params, design = designs[False]
    p64 = [{k: v.double() for k, v in p.items()} for p in params]
    want = tnn.apply_model(p64, model, x.double() * IN.step, in_quant=IN)
    got = design.forward_int(x).double() * design.out_scale.double()
    assert torch.equal(got, want)


def test_design_pads_as_the_reference(compiled):
    name, *_, designs = compiled
    convs = [s for s in designs[True][1].step_specs if s.kind == "conv"]
    for s in convs:
        p = s.params
        want = [*network.same_pads(p["h"], p["kh"], p["sh"]),
                *network.same_pads(p["w"], p["kw"], p["sw"])]
        assert p["pads"] == want
        assert (p["oh"], p["ow"]) == (-(-p["h"] // p["sh"]), -(-p["w"] // p["sw"]))
    if name == "stride_2_at_16":
        assert convs[0].params["pads"] == [0, 1, 0, 1]


def test_a_swap_of_the_zeros_would_show():
    """The stride-2 conv with its zeros after each axis swapped to before
    gives other outputs, so the equalities above hold the pads' order."""
    model, in_shape = NETWORKS["stride_2_at_16"]
    design = _compile(model, in_shape, _params(model, in_shape, 5, True))
    x = torch.randint(0, 256, (8, *in_shape), generator=torch.Generator().manual_seed(6),
                      dtype=torch.int32)
    right = design.forward_int(x)
    design.steps[0].pads = (1, 0, 1, 0)
    assert not torch.equal(design.forward_int(x), right)
