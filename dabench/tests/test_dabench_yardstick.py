"""The work counting and the bound against hand-worked shapes."""

import json

import pytest

from dabench import yardstick
from dabench.harness import ROOT

PEAKS = yardstick.PEAKS["NVIDIA H100 80GB HBM3"]


MIXER = "dabench/configs/mixer_full.json"
SVHN = "dabench/tests/svhn_cnn_30x30.json"
SAME_SVHN = "dabench/tests/svhn_cnn_32x32_same.json"


def _config(file):
    return json.loads((ROOT / file).read_text())


def test_mixer_macs_by_hand():
    # 4 tables 16x16 on 64 particles, 4 tables 64x64 on 16 features, 1024x32, 32x5
    assert yardstick.macs_per_sample(_config(MIXER)) == (
        4 * 64 * 16 * 16 + 4 * 16 * 64 * 64 + 1024 * 32 + 32 * 5) == 360608


def test_svhn_macs_by_hand():
    # conv 27x16 at 28x28, 144x16 at 12x12, 144x24 at 4x4, then 96x42, 42x64, 64x10
    assert yardstick.macs_per_sample(_config(SVHN)) == (
        784 * 27 * 16 + 144 * 144 * 16 + 16 * 144 * 24 + 96 * 42 + 42 * 64 + 64 * 10) == 733120


def test_same_svhn_macs_by_hand():
    # SAME keeps 32x32, 16x16 and 8x8 through the convs: 27x16 at 32x32, 144x16 at 16x16,
    # 144x24 at 8x8, then the 4x4x24 flatten: 384x42, 42x64, 64x10
    config = _config(SAME_SVHN)
    assert [c["rows"] for c in yardstick.matrix_calls(config)] == [1024, 256, 64, 1, 1, 1]
    assert yardstick.macs_per_sample(config) == (
        1024 * 27 * 16 + 256 * 144 * 16 + 64 * 144 * 24 + 384 * 42 + 42 * 64 + 64 * 10) == 1272832
    assert config["macs_per_sample"] == 1272832


@pytest.mark.parametrize("pad,side", [("same", 8), ("valid", 7)])
def test_stride_two_on_an_odd_size(pad, side):
    # 15x15 at stride 2 with a 3x3 kernel: SAME gives ceil(15 / 2) = 8 a side, VALID (15 - 3) // 2 + 1 = 7
    config = {"in_shape": [15, 15, 16], "layers": [
        {"kind": "conv2d", "filters": 8, "kernel": [3, 3], "strides": [2, 2], "padding": pad},
        {"kind": "flatten"}, {"kind": "dense", "units": 10}]}
    conv, dense = yardstick.matrix_calls(config)
    assert conv == {"rows": side * side, "n_in": 144, "n_out": 8}
    assert dense == {"rows": 1, "n_in": side * side * 8, "n_out": 10}


@pytest.mark.parametrize("pad", ["full", "SAME", ""])
def test_unknown_padding_is_refused(pad):
    config = {"in_shape": [8, 8, 3], "layers": [
        {"kind": "conv2d", "filters": 4, "kernel": [3, 3], "strides": [1, 1], "padding": pad}]}
    with pytest.raises(ValueError):
        yardstick.matrix_calls(config)


# the counts of the committed layer lists as they stood before SAME was read: they may not move
PINNED = {
    MIXER: ([(64, 16, 16), (64, 16, 16), (16, 64, 64), (16, 64, 64), (64, 16, 16), (64, 16, 16),
             (16, 64, 64), (16, 64, 64), (1, 1024, 32), (1, 32, 5)],
            360608, {1: 2.086805970149253e-08, 256: 5.342223283582088e-06,
                     65536: 0.0013676091605970145}),
    SVHN: ([(784, 27, 16), (144, 144, 16), (16, 144, 24), (1, 96, 42), (1, 42, 64), (1, 64, 10)],
           733120, {1: 7.135283582089554e-08, 256: 1.8266325970149257e-05,
                    65536: 0.00467617944835821}),
}


@pytest.mark.parametrize("name", PINNED)
def test_committed_lists_count_as_before(name):
    calls, macs, bounds = PINNED[name]
    config = _config(name)
    assert [(c["rows"], c["n_in"], c["n_out"]) for c in yardstick.matrix_calls(config)] == calls
    assert yardstick.macs_per_sample(config) == macs
    for samples, want in bounds.items():
        assert yardstick.bound_s(config, samples, PEAKS) == want


@pytest.mark.parametrize("name", [MIXER, SVHN])
def test_matrix_shapes_are_the_designs_tables(name):
    config = _config(name)
    manifest = json.loads((ROOT / config["asset"] / "manifest.json").read_text())
    shapes = [f"{c['n_in']}x{c['n_out']}" for c in yardstick.matrix_calls(config)]
    assert shapes == [r["shape"] for r in manifest["reports"]]
    assert len(shapes) == config["n_tables"] == manifest["n_programs"]
    assert manifest["resources"]["total_adders"] == config["total_adders"]
    assert yardstick.macs_per_sample(config) == config["macs_per_sample"]


def test_bound_by_hand():
    # one 64x64 table on 2 rows: 2*(64+64)*4 bytes against 2*2*4096 operations
    config = {"in_shape": [2, 64], "layers": [{"kind": "dense", "units": 64}]}
    by_bytes = 1024 / PEAKS["hbm_bytes_per_s"]
    by_ops = 16384 / PEAKS["int8_ops_per_s"]
    assert yardstick.bound_s(config, 1, PEAKS) == pytest.approx(max(by_bytes, by_ops))
    assert yardstick.bound_s(config, 1000, PEAKS) == pytest.approx(1000 * by_bytes)


def test_mixer_is_bytes_bound():
    config = _config(MIXER)
    calls = yardstick.matrix_calls(config)
    by_bytes = sum(4 * c["rows"] * (c["n_in"] + c["n_out"]) for c in calls) / PEAKS["hbm_bytes_per_s"]
    assert yardstick.bound_s(config, 1, PEAKS) == pytest.approx(by_bytes)


def test_unknown_layer_is_refused():
    with pytest.raises(ValueError):
        yardstick.matrix_calls({"in_shape": [4], "layers": [{"kind": "softmax"}]})


@pytest.mark.parametrize("q,want", [(0, 1), (50, 3), (95, 5), (100, 5)])
def test_percentile_nearest_rank(q, want):
    assert yardstick.percentile([5, 1, 4, 2, 3], q) == want
