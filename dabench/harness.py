"""The benchmark of the port's DA path, driven by data.

``BENCHMARK.json`` names the cells, configurations and metrics; each is a
file of its own here, found by its name:

* ``workloads/<cell>.json``: the configuration and traffic mix it pairs,
  and the mix's parameters for this pair (``params``);
* ``configs/<config>.json``: the design's committed asset, its input grid
  and shapes, and the network's layer list and weights for the reference;
* ``traffic/<mix>.json``: the driver (``drivers/<driver>.py``) and its
  parameters;
* ``metrics/<metric>.py``: a ``read(run)`` that returns the metric's
  value from a :class:`Run`, or ``None`` where it finds nothing to read.

A run loads the design, draws the inputs from the seed on the device,
warms up (set-up), measures for the given seconds, with ``trace`` runs a
short second window under the profiler, and then compares a sample of
the outputs of both windows, drawn from the seed, with the plain
reference (``reference/network.py``).
"""

from __future__ import annotations

import importlib
import importlib.util
import json
import math
import random
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import torch

from . import devtrace, yardstick
from .drivers import Window
from .reference import network

ROOT = Path(__file__).resolve().parent.parent
HERE = ROOT / "dabench"
# samples of each run's outputs compared with the reference (whole calls)
CHECK_SAMPLES = 262144
# length of the traced window of a --trace 1 run
TRACE_SECONDS = 2.0
# modules that no run may hold once its window has closed (top-level names)
FOREIGN = ("jax", "jaxlib", "flax", "repro")


@dataclass
class Cell:
    name: str
    chips: int
    config: dict
    params: dict
    end_to_end: list[dict]
    per_layer: list[dict]


@dataclass
class Run:
    """What one run measured, as the metric readers see it."""

    cell: Cell
    device_kind: str
    setup_s: float
    load_s: float
    window: Window
    traced: Window | None = None
    trace: devtrace.Trace | None = None

    @property
    def config(self) -> dict:
        return self.cell.config

    @property
    def peaks(self) -> dict | None:
        return yardstick.PEAKS.get(self.device_kind)


def _json(path: Path) -> dict:
    return json.loads(path.read_text())


def grid(in_quant: dict) -> tuple[int, int]:
    """The lowest and highest grid integer of an input grid."""
    b = in_quant["bits"]
    return (-(1 << (b - 1)), (1 << (b - 1)) - 1) if in_quant["signed"] else (0, (1 << b) - 1)


def load_cell(name: str, bench: dict | None = None) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json``, with its configuration,
    its traffic parameters and the metrics it reports."""
    bench = bench if bench is not None else _json(ROOT / "BENCHMARK.json")
    entry = next((w for w in bench["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    pair = _json(HERE / "workloads" / f"{name}.json")
    if (pair["config"], pair["traffic"]) != (entry["config"], entry["traffic"]):
        raise ValueError(f"workloads/{name}.json pairs other files than BENCHMARK.json")
    cfg_entry = next(c for c in bench["configs"] if c["name"] == entry["config"])
    config = _json(ROOT / cfg_entry["file"])
    params = {**_json(HERE / "traffic" / f"{entry['traffic']}.json"), **pair.get("params", {})}
    params["grid"] = grid(config["in_quant"])

    def applies(m):
        return name in m.get("workloads", [name])

    return Cell(name, entry["chips"], config, params,
                [m for m in bench["end_to_end"] if applies(m)],
                [m for m in bench["per_layer"] if applies(m)])


def reader(metric: str):
    """The ``read`` function of ``metrics/<metric>.py``, or, where there is
    none, of the reader of the quantity the name starts with: one quantity
    split by the cells' mixes (``samples_per_s.bulk``, ``samples_per_s.b256``)
    is read by ``metrics/samples_per_s.py``."""
    path = HERE / "metrics" / f"{metric}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{metric.split('.')[0]}.py"
    spec = importlib.util.spec_from_file_location(
        f"dabench.metrics.{path.stem.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class Keeper:
    """A uniform sample of ``size`` calls' outputs, drawn from the seed as
    the calls complete (reservoir sampling): ``{slot: (k, outputs)}``."""

    def __init__(self, seed: int, size: int):
        self.rng = random.Random(seed)
        self.size = size
        self.seen = 0
        self.kept: dict[int, tuple[int, torch.Tensor]] = {}

    def __call__(self, k: int, y_host: torch.Tensor) -> None:
        i = self.seen
        self.seen += 1
        j = i if i < self.size else self.rng.randrange(i + 1)
        if j < self.size:
            self.kept[j] = (k, y_host.clone())


def check_program_source() -> None:
    """Refuse a ``repro_torch`` that is not this checkout's ``src/``: one
    installed elsewhere would be measured in place of the tree under test."""
    import repro_torch

    src = (ROOT / "src").resolve()
    if not Path(repro_torch.__file__).resolve().is_relative_to(src):
        raise ImportError(f"repro_torch is imported from {repro_torch.__file__}, not from {src}")


def foreign_modules() -> list[str]:
    """Top-level names of ``FOREIGN`` modules loaded in this process."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FOREIGN))


def run_cell(cell: Cell, seed: int, seconds: float, trace: bool, device: torch.device,
             t_start: float | None = None, design=None, forward=None) -> dict:
    """One run of ``cell``: the result line's dict.  ``t_start`` is when
    the process started on the host clock (set-up counts from there);
    ``design`` a design already loaded on ``device``; ``forward`` what the
    window drives in place of the design's ``forward_int`` (the control,
    a planted fault)."""
    t_start = time.perf_counter() if t_start is None else t_start
    # set-up, phase by phase on the host clock (printed, not compared)
    phases: dict[str, float] = {}
    t = t_start

    def phase(name: str) -> None:
        nonlocal t
        now = time.perf_counter()
        phases[name] = now - t
        t = now

    phase("imports")
    torch.empty(1, device=device)
    _sync(device)
    phase("context")
    check_program_source()
    from repro_torch.runtime import load_design

    phase("program_import")
    if design is None:
        design = load_design(ROOT / cell.config["asset"], device=device)
    phase("load_design")
    if tuple(design.in_shape) != tuple(cell.config["in_shape"]):
        raise ValueError(f"the design takes {design.in_shape}, the configuration {cell.config['in_shape']}")
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    driver_mod = importlib.import_module(f"dabench.drivers.{cell.params['driver']}")
    driver = driver_mod.Driver(forward or design.forward_int, cell.config, cell.params, device, gen)
    _sync(device)
    phase("inputs")
    driver.warmup()
    _sync(device)
    phase("warmup")
    setup_s = t - t_start

    keep = Keeper(seed, max(1, math.ceil(CHECK_SAMPLES / driver.samples_per_call)))
    window = driver.run(seconds, keep)
    traced = tr = None
    if trace:
        traced, tr = _traced(driver, keep, device)
    _sync(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0

    ref = network.load(cell.config, ROOT, device=device)
    mismatched = checked = 0
    for k, y in keep.kept.values():
        want = ref(driver.inputs(k))
        got = y.to(torch.int64).reshape(want.shape)
        mismatched += int((got != want).sum())
        checked += want.numel()

    run = Run(cell, _device_kind(device), setup_s, phases["load_design"], window, traced, tr)
    wanted = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in wanted:
        value = reader(m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    attempted = window.attempted + (traced.attempted if traced else 0)
    completed = window.completed + (traced.completed if traced else 0)
    dev = {"platform": "gpu" if device.type == "cuda" else device.type, "kind": run.device_kind,
           "count": cell.chips, "memory_peak_bytes": peak}
    result = {
        "correct": checked > 0 and mismatched == 0 and completed == attempted,
        "attempted": attempted,
        "failed": attempted - completed,
        "metrics": metrics,
        "device": dev,
    }
    if tr is not None:
        dev["busy_s"] = tr.busy_s
        dev["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    result["checked_outputs"] = checked
    result["setup_phases_s"] = phases
    if traced is not None:
        # the profiler's own cost on the host: the traced window's rate against the measured one's
        result["traced_samples_per_s"] = traced.samples / traced.seconds
        result["window_samples_per_s"] = window.samples / window.seconds
    # the numbers compared, each with its limit: the line's last key
    result["check"] = {"mismatched_outputs": {"value": mismatched, "limit": 0},
                       "unfinished_calls": {"value": attempted - completed, "limit": 0}}
    return result


def _traced(driver, keep, device):
    """A second window of ``TRACE_SECONDS`` under the profiler."""
    from torch.profiler import ProfilerActivity, profile, record_function

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device.type == "cuda" else [])
    with profile(activities=acts) as prof:
        with record_function(devtrace.WINDOW):
            win = driver.run(TRACE_SECONDS, keep)
            _sync(device)
    return win, devtrace.reduce(prof.profiler.kineto_results.events())


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _device_kind(device: torch.device) -> str:
    return torch.cuda.get_device_name(device) if device.type == "cuda" else device.type
