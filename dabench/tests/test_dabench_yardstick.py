"""The work counting and the bound against hand-worked shapes."""

import json

import pytest

from dabench import yardstick
from dabench.harness import ROOT

PEAKS = yardstick.PEAKS["NVIDIA H100 80GB HBM3"]


MIXER = "dabench/configs/mixer_full.json"
SVHN = "dabench/tests/svhn_cnn_30x30.json"


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
