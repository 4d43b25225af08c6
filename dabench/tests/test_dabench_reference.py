"""The plain reference against each asset's committed golden outputs (the
JAX package's, read as data), and the control a precision below it."""

import json
import math

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from dabench import yardstick
from dabench.harness import ROOT
from dabench.reference import network

BENCH_CONFIGS = [c["file"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]]
# the port's committed SVHN CNN, kept as test data: it drives the reference's convolution and pools
CONFIGS = BENCH_CONFIGS + ["dabench/tests/svhn_cnn_30x30.json"]
# the SVHN CNN at its published 32x32 frame with SAME convolutions: a layer list with no design
SAME_SVHN = "dabench/tests/svhn_cnn_32x32_same.json"


def _config(file):
    return json.loads((ROOT / file).read_text())


def _golden(config):
    with np.load(ROOT / config["asset"] / "golden.npz") as z:
        return torch.as_tensor(z["x"].astype(np.int32)), z["y"]


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_equals_golden(name):
    config = _config(name)
    x, y = _golden(config)
    got = network.load(config, ROOT)(x).numpy()
    assert got.shape == y.shape
    np.testing.assert_array_equal(got, y)


@pytest.mark.parametrize("name", CONFIGS)
def test_reference_is_exact_in_float32_and_blocked(name):
    # every value fits 24 bits, so float32 is no lower precision here; blocks change nothing
    config = _config(name)
    x, y = _golden(config)
    got = network.load(config, ROOT, dtype=torch.float32).forward(x, block=100).numpy()
    np.testing.assert_array_equal(got, y)


@pytest.mark.parametrize("name", CONFIGS)
def test_bfloat16_control_is_caught(name):
    config = _config(name)
    x, y = _golden(config)
    got = network.load(config, ROOT, dtype=torch.bfloat16)(x).numpy()
    assert (got != y).mean() > 0.5


@pytest.mark.parametrize("name", BENCH_CONFIGS)
def test_weights_are_the_assets(name):
    # the benchmark's copy of the weights is the committed design's source
    config = _config(name)
    with np.load(ROOT / config["params"]) as a, np.load(ROOT / config["asset"] / "params.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_on_device_matches_forward():
    config = _config("dabench/configs/mixer_full.json")
    x, _ = _golden(config)
    ref = network.load(config, ROOT)
    np.testing.assert_array_equal(ref.on_device(x[:64]).numpy(), ref(x[:64]).numpy())


def test_grid():
    assert network.grid({"bits": 8, "int_bits": 4, "signed": True}) == (-4, -128, 127)
    assert network.grid({"bits": 8, "int_bits": 1, "signed": False}) == (-7, 0, 255)


def _drawn(config, seed, n=64):
    """Float weights for every table of ``config`` and ``n`` samples of
    grid integers, drawn from ``seed``: normals at twice the He scale, so
    that the ReLUs both clip at 0 and saturate."""
    g = torch.Generator().manual_seed(seed)
    params = {}
    calls = iter(yardstick.matrix_calls(config))
    for i, layer in enumerate(config["layers"]):
        if layer["kind"] in ("dense", "conv2d"):
            c = next(calls)
            shape = ((*layer["kernel"], c["n_in"] // math.prod(layer["kernel"]), c["n_out"])
                     if layer["kind"] == "conv2d" else (c["n_in"], c["n_out"]))
            w = torch.randn(shape, generator=g, dtype=torch.float64) * 2 * (2 / c["n_in"]) ** 0.5
            params[f"{i}/w"] = w.numpy()
            params[f"{i}/b"] = (torch.randn(c["n_out"], generator=g, dtype=torch.float64) * 0.1).numpy()
    lo, hi = network.grid(config["in_quant"])[1:]
    x = torch.randint(lo, hi + 1, (n, *config["in_shape"]), generator=g, dtype=torch.int32)
    return params, x


# (input, kernel, stride, zeros before and after each axis, worked by hand)
SAME_SHAPES = [((32, 32, 3), 3, 1, (1, 1)),
               ((15, 15, 16), 3, 2, (1, 1)),
               ((16, 16, 16), 3, 2, (0, 1)),
               ((8, 8, 24), 1, 1, (0, 0))]


@pytest.mark.parametrize("hwc,k,s,pads", SAME_SHAPES, ids=lambda v: str(v).replace(" ", ""))
def test_same_conv_is_torchs_on_zero_padded_input(hwc, k, s, pads):
    from repro_torch.nn.layers import QConv2D, _conv_nhwc

    g = torch.Generator().manual_seed(hwc[0] * 100 + k * 10 + s)
    x = torch.randint(0, 256, (4, *hwc), generator=g).double()
    w = torch.randint(-32, 32, (k, k, hwc[2], 8), generator=g).double()
    layer = {"kind": "conv2d", "filters": 8, "kernel": [k, k], "strides": [s, s], "padding": "same"}
    got = network.Reference._conv(x, w, layer)
    assert got.shape == (4, -(-hwc[0] // s), -(-hwc[1] // s), 8)
    padded = F.pad(x.permute(0, 3, 1, 2), (*pads, *pads))
    want = F.conv2d(padded, w.permute(3, 2, 0, 1), stride=s).permute(0, 2, 3, 1)
    assert torch.equal(got, want)
    # the program's SAME is the benchmark's
    assert torch.equal(got, _conv_nhwc(x, w, QConv2D(8, (k, k), (s, s), padding="SAME")))


def test_valid_is_the_default_padding():
    g = torch.Generator().manual_seed(5)
    x = torch.randint(0, 256, (2, 9, 9, 3), generator=g).double()
    w = torch.randint(-32, 32, (3, 3, 3, 4), generator=g).double()
    layer = {"kind": "conv2d", "filters": 4, "kernel": [3, 3], "strides": [2, 2]}
    got = network.Reference._conv(x, w, layer)
    assert got.shape == (2, 4, 4, 4)
    assert torch.equal(got, network.Reference._conv(x, w, {**layer, "padding": "valid"}))


def test_same_list_is_exact_in_float32_and_blocked():
    config = _config(SAME_SVHN)
    params, x = _drawn(config, 2**31 + 7)
    want = network.Reference(config, params)(x)
    assert want.shape == (x.shape[0], 10) and want.unique().numel() > x.shape[0]
    f32 = network.Reference(config, params, dtype=torch.float32)
    assert torch.equal(f32(x), want)
    assert torch.equal(f32.forward(x, block=10), want)
    assert torch.equal(network.Reference(config, params).forward(x, block=10), want)


def test_bfloat16_control_is_caught_on_the_same_list():
    config = _config(SAME_SVHN)
    params, x = _drawn(config, 2**31 + 9)
    want = network.Reference(config, params)(x)
    got = network.Reference(config, params, dtype=torch.bfloat16)(x)
    assert (got != want).double().mean() > 0.5


@pytest.mark.parametrize("pad", ["full", "SAME", ""])
def test_unknown_padding_is_refused(pad):
    config = _config(SAME_SVHN)
    params, x = _drawn(config, 3, n=1)
    config["layers"][3]["padding"] = pad
    with pytest.raises(ValueError):
        network.Reference(config, params)(x)
