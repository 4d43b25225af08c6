"""BENCHMARK.json and the files it names, found by name."""

import json
import re

import pytest

from dabench import harness
from dabench.harness import HERE, ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]
NAME = re.compile(r"[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "dabench/run.py"]
    assert BENCH["paths"] == ["dabench"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_and_keys():
    names = [c["name"] for c in BENCH["configs"]] + CELLS + [m["name"] for m in METRICS]
    assert len(set(names)) == len(names)
    for n in names:
        assert NAME.match(n), n
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("dabench/") and (ROOT / c["file"]).is_file()
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and len(w["why"]) <= 200
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["moves"] in [e["name"] for e in BENCH["end_to_end"]]
    for m in METRICS:
        assert m["better"] in ("lower", "higher")
        assert re.fullmatch(r"[A-Za-z0-9_/%.-]{1,16}", m["unit"]), m["unit"]


@pytest.mark.parametrize("name", CELLS)
def test_cell_loads_by_name(name):
    cell = harness.load_cell(name)
    assert cell.config["name"] == next(w["config"] for w in BENCH["workloads"] if w["name"] == name)
    assert (HERE / "drivers" / f"{cell.params['driver']}.py").is_file()
    names = [m["name"] for m in cell.end_to_end]
    assert "setup_s" in names and len(names) >= 2 and cell.per_layer


@pytest.mark.parametrize("name", [m["name"] for m in METRICS])
def test_metric_reader_by_name(name):
    assert callable(harness.reader(name))


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_file(config):
    data = json.loads((ROOT / config["file"]).read_text())
    assert data["name"] == config["name"] and data["reduced"] == config["reduced"]
    assert (ROOT / data["asset"] / "manifest.json").is_file()
    manifest = json.loads((ROOT / data["asset"] / "manifest.json").read_text())
    assert manifest["in_quant"] == data["in_quant"]
    assert manifest["in_shape"] == data["in_shape"] and manifest["out_shape"] == data["out_shape"]


def test_unknown_cell_is_refused():
    with pytest.raises(KeyError):
        harness.load_cell("no_such_cell")


def test_grid_of_the_input():
    assert harness.grid({"bits": 8, "int_bits": 4, "signed": True}) == (-128, 127)
    assert harness.grid({"bits": 8, "int_bits": 1, "signed": False}) == (0, 255)


def test_check_time_fits_the_driver():
    # a full check: 2 + 14 x 24 cells runs, each run_seconds + 60, 2 x 90 s a cell, 1200 spare
    assert (2 + 14 * 24) * (BENCH["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
