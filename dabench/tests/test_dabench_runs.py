"""Whole runs of each cell on the CPU at a small size, the card's look
skipped: the program comes out correct, and the control and each planted
fault on the timed path come out not correct.

The drivers' card primitives (``dabench.drivers.card``) are replaced by
host stand-ins here: events stamp the host clock and a "captured" graph
calls its function again at each replay, so these runs drive the
drivers' own loops with an eager forward.  ``test_dabench_card.py``
drives the captured graph itself on the card.
"""

import contextlib
import json
import time

import pytest
import torch

from dabench import control, harness
from dabench.drivers import card
from dabench.harness import ROOT
from dabench.tests.faults import FAULTS

CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
CPU = torch.device("cpu")
SMALL = {"samples_per_call": 4, "pool_calls": 3}


class HostEvent:
    """``card.event()`` on the CPU, where every call is synchronous: it
    stamps the host clock when recorded."""

    def record(self, stream=None) -> None:
        self.t = time.perf_counter()

    def synchronize(self) -> None:
        pass

    def elapsed_time(self, end: "HostEvent") -> float:
        return (end.t - self.t) * 1e3


class HostStream:
    """``card.stream(device)`` on the CPU: nothing to wait for."""

    def synchronize(self) -> None:
        pass


class EagerGraph:
    """``card.capture(fn, stream)`` on the CPU: each replay calls ``fn``."""

    def __init__(self, fn):
        self.fn = fn
        self.output = fn()

    def replay(self) -> None:
        self.output = self.fn()


@pytest.fixture(autouse=True)
def cpu_card(monkeypatch):
    monkeypatch.setattr(card, "event", HostEvent)
    monkeypatch.setattr(card, "stream", lambda device: HostStream())
    monkeypatch.setattr(card, "use", lambda s: contextlib.nullcontext())
    monkeypatch.setattr(card, "host_buffer", lambda shape: torch.empty(shape, dtype=torch.int32))
    monkeypatch.setattr(card, "capture", lambda fn, s: EagerGraph(fn))


@pytest.fixture(autouse=True)
def few_checked(monkeypatch):
    # a planted fault runs thousands of calls in a short window; check 16 of them
    monkeypatch.setattr(harness, "CHECK_SAMPLES", 64)


@pytest.fixture(scope="module")
def designs():
    from repro_torch.runtime import load_design

    cache = {}

    def get(cell):
        name = cell.config["name"]
        if name not in cache:
            cache[name] = load_design(ROOT / cell.config["asset"], device=CPU)
        return cache[name]

    return get


def _cell(name):
    cell = harness.load_cell(name)
    cell.params.update(SMALL)
    return cell


def _run(name, designs, forward=None, seed=2**31 + 7, seconds=0.2):
    cell = _cell(name)
    design = designs(cell)
    fwd = forward(design) if forward else None
    return harness.run_cell(cell, seed, seconds, False, CPU, design=design, forward=fwd)


@pytest.mark.parametrize("name", CELLS)
def test_program_is_correct(name, designs):
    r = _run(name, designs)
    assert r["correct"], r["check"]
    assert r["failed"] == 0 and r["attempted"] > 0 and r["checked_outputs"] > 0
    assert r["check"]["mismatched_outputs"]["value"] == 0


@pytest.mark.parametrize("name", CELLS)
def test_control_is_not_correct(name, designs):
    ctl = lambda design: control.control_forward(_cell(name), CPU)  # noqa: E731
    r = _run(name, designs, ctl)
    assert not r["correct"]
    assert r["check"]["mismatched_outputs"]["value"] > 0


@pytest.mark.parametrize("fault", FAULTS.values(), ids=FAULTS.keys())
@pytest.mark.parametrize("name", CELLS)
def test_planted_fault_is_not_correct(name, fault, designs):
    r = _run(name, designs, fault)
    assert not r["correct"], fault.__name__
    assert r["check"]["mismatched_outputs"]["value"] > 0


@pytest.mark.parametrize("name", CELLS)
def test_result_line_format(name, designs):
    r = _run(name, designs)
    assert list(r)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(r)[-1] == "check"
    for c in r["check"].values():
        assert set(c) == {"value", "limit"}
    cell = _cell(name)
    assert set(r["metrics"]) == {m["name"] for m in cell.end_to_end}
    for m in cell.end_to_end:
        assert r["metrics"][m["name"]]["unit"] == m["unit"] and r["metrics"][m["name"]]["value"] > 0
    assert set(r["device"]) == {"platform", "kind", "count", "memory_peak_bytes"}
    json.loads(json.dumps(r))


def test_traced_run_reports_per_layer_metrics_it_can_read(designs, monkeypatch):
    # on the CPU there is no device trace: the device readers find nothing
    monkeypatch.setattr(harness, "TRACE_SECONDS", 0.1)
    cell = _cell("mixer_b256")
    r = harness.run_cell(cell, 5, 0.1, True, CPU, design=designs(cell))
    assert r["correct"]
    assert set(r["metrics"]) == {"load_s"}
    assert "breakdown" not in r and "busy_s" not in r["device"]


@pytest.mark.parametrize("name", CELLS)
def test_inputs_follow_the_seed(name, designs):
    cell = _cell(name)
    mod = __import__(f"dabench.drivers.{cell.params['driver']}", fromlist=["Driver"])

    def pool(seed):
        g = torch.Generator(device=CPU)
        g.manual_seed(seed)
        d = mod.Driver(lambda x: x, cell.config, cell.params, CPU, g)
        return torch.stack([d.inputs(k) for k in range(SMALL["pool_calls"])])

    a, b, c = pool(2**33 + 1), pool(2**33 + 1), pool(2**33 + 2)
    assert torch.equal(a, b) and not torch.equal(a, c)
    lo, hi = cell.params["grid"]
    assert a.min() >= lo and a.max() <= hi and a.dtype == torch.int32
    assert tuple(a.shape[2:]) == tuple(cell.config["in_shape"])
    # distinct calls get distinct inputs
    assert not torch.equal(a[0], a[1])


def test_keeper_samples_uniformly_from_the_seed():
    def kept(seed):
        k = harness.Keeper(seed, 4)
        for i in range(100):
            k(i, torch.tensor([i]))
        return sorted(i for i, _ in k.kept.values())

    assert kept(3) == kept(3) and kept(3) != kept(4)
    assert len(kept(3)) == 4 and max(kept(3)) < 100


def test_foreign_modules_compares_whole_top_level_names():
    import subprocess
    import sys

    code = ("import sys; sys.path[:0] = [%r, %r]; import dabench.harness as h; "
            "import repro_torch.runtime; print(h.foreign_modules())" % (str(ROOT / "src"), str(ROOT)))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True)
    assert out.stdout.strip() == "[]"
