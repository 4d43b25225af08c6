"""Short runs of each cell on the card (skips without one; on the card:
``python -m pytest -m cuda dabench/tests``): the program comes out
correct, and each fault planted on the timed path, captured into the
graph where the cell replays one, comes out not correct."""

import json

import pytest
import torch

from dabench import harness
from dabench.harness import ROOT
from dabench.tests.faults import FAULTS

pytestmark = pytest.mark.cuda
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.mark.parametrize("name", CELLS)
def test_cell_runs_correct_on_the_card(name, card):
    r = harness.run_cell(harness.load_cell(name), 2**31 + 11, 1.0, False, card)
    assert r["correct"] and r["device"]["kind"] == torch.cuda.get_device_name(card)
    assert r["device"]["memory_peak_bytes"] > 0


@pytest.mark.parametrize("fault", FAULTS.values(), ids=FAULTS.keys())
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_caught_on_the_card(name, fault, card):
    from repro_torch.runtime import load_design

    cell = harness.load_cell(name)
    design = load_design(ROOT / cell.config["asset"], device=card)
    r = harness.run_cell(cell, 2**31 + 13, 0.5, False, card, design=design, forward=fault(design))
    assert not r["correct"]
    assert r["check"]["mismatched_outputs"]["value"] > 0
