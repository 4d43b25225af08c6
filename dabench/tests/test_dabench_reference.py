"""The plain reference against each asset's committed golden outputs (the
JAX package's, read as data), and the control a precision below it."""

import json

import numpy as np
import pytest
import torch

from dabench.harness import ROOT
from dabench.reference import network

BENCH_CONFIGS = [c["file"] for c in json.loads((ROOT / "BENCHMARK.json").read_text())["configs"]]
# the port's committed SVHN CNN, kept as test data: it drives the reference's convolution and pools
CONFIGS = BENCH_CONFIGS + ["dabench/tests/svhn_cnn_30x30.json"]


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
