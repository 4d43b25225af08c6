"""``svhn_bulk`` on the card (skips without one; on the card: ``python -m
pytest -m cuda dabench/tests/test_dabench_svhn_card.py``, ~4 min, most of
it the CPU run): the program comes out correct on two more seeds; the
control (the reference in bfloat16 in the program's place) comes out not
correct; and the ``svhn_cnn_32`` design's ``forward_int`` on the card
equals its run on the CPU over one whole chunk of the cell's traffic.
The planted faults run in every cell, this one too, in
``test_dabench_card.py``."""

import pytest
import torch

from dabench import control, harness
from dabench.drivers import bulk
from dabench.harness import ROOT

pytestmark = pytest.mark.cuda
CELL = "svhn_bulk"


@pytest.fixture(scope="module")
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


@pytest.fixture(scope="module")
def design(card):
    from repro_torch.runtime import load_design

    return load_design(ROOT / harness.load_cell(CELL).config["asset"], device=card)


@pytest.mark.parametrize("seed", [2**31 + 21, 2**33 + 5])
def test_correct_on_the_card(seed, card, design):
    r = harness.run_cell(harness.load_cell(CELL), seed, 1.0, False, card, design=design)
    assert r["correct"], r["check"]
    assert r["checked_outputs"] == harness.CHECK_SAMPLES * 10


def test_control_is_not_correct_on_the_card(card, design):
    cell = harness.load_cell(CELL)
    r = harness.run_cell(cell, 2**31 + 23, 0.5, False, card, design=design,
                         forward=control.control_forward(cell, card))
    assert not r["correct"]
    assert r["check"]["mismatched_outputs"]["value"] > 0


def test_card_equals_cpu_on_one_chunk(card, design):
    from repro_torch.runtime import load_design

    cell = harness.load_cell(CELL)
    gen = torch.Generator(device=card)
    gen.manual_seed(2**31 + 27)
    x = bulk.Driver(design.forward_int, cell.config, cell.params, card, gen).inputs(0)
    got = design.forward_int(x).cpu()
    cpu = load_design(ROOT / cell.config["asset"], device="cpu")
    x = x.cpu()
    # in blocks, so that the CPU adder graph's value rows fit the host's memory
    want = torch.cat([cpu.forward_int(x[i:i + 4096]) for i in range(0, x.shape[0], 4096)])
    assert x.shape[0] == cell.params["samples_per_call"]
    assert torch.equal(got, want)
