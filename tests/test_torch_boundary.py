"""The port's boundary: it imports neither ``jax`` nor any module of
``repro``, its entry points refuse to fall back to the CPU when no card
is present, and importing it builds no kernel."""

import json
import pkgutil
import re
import subprocess
import sys
from pathlib import Path

import pytest
import torch

import repro_torch
from repro_torch._device import resolve_device
from repro_torch import configs
from repro_torch.models import init_params
from repro_torch.runtime import ServeEngine, design_from_arrays, load_design
from repro_torch.serve import Engine

ROOT = Path(__file__).resolve().parent.parent
MIXER = ROOT / "src" / "repro_torch" / "assets" / "mixer_full"
FORBIDDEN = re.compile(r"import jax|from jax|from repro[ .]|import repro\b")


def _modules():
    return sorted(
        m.name for m in pkgutil.walk_packages(repro_torch.__path__, "repro_torch.")
    )


def _run(code: str) -> dict:
    out = subprocess.run(
        [sys.executable, "-c", code], capture_output=True, text=True, check=True,
        cwd=ROOT, env={"PYTHONPATH": str(ROOT / "src"), "PATH": "/usr/bin:/bin"},
    )
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_importing_every_module_pulls_in_neither_jax_nor_repro():
    mods = _modules()
    assert "repro_torch.runtime.engine" in mods and "repro_torch.kernels._build" in mods
    assert "repro_torch.serve.engine" in mods and "repro_torch.kernels.flash_attention.kernel" in mods
    res = _run(
        "import importlib, json, sys\n"
        f"for m in {mods!r}: importlib.import_module(m)\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or m.startswith('jax.')"
        " or m == 'repro' or m.startswith('repro.'))\n"
        "print(json.dumps({'bad': bad, 'n': len(" + repr(mods) + ")}))\n"
    )
    assert res == {"bad": [], "n": len(mods)}


def test_no_source_names_jax_or_repro():
    files = [*sorted((ROOT / "src" / "repro_torch").rglob("*.py")), ROOT / "chip_smoke.py"]
    hits = [f"{f}:{i}" for f in files
            for i, line in enumerate(f.read_text().splitlines(), 1) if FORBIDDEN.search(line)]
    assert hits == []


def test_importing_the_kernel_wrapper_builds_nothing():
    res = _run(
        "import json, subprocess\n"
        "def refuse(*a, **k): raise AssertionError('a process was started on import')\n"
        "subprocess.Popen = refuse\n"
        "import repro_torch.kernels.adder_graph.kernel as k\n"
        "import repro_torch.kernels.flash_attention.kernel as fa\n"
        "import repro_torch.serve\n"
        "from repro_torch.kernels import _build\n"
        "print(json.dumps({'loaded': sorted(_build._loaded),"
        " 'launches': k.launches.value + fa.launches.value}))\n"
    )
    assert res == {"loaded": [], "launches": 0}


@pytest.fixture
def no_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)


def test_no_card_means_raise_not_cpu(no_card):
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device(None)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        load_design(MIXER)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ServeEngine()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        design_from_arrays({}, {})
    cfg = configs.get_smoke("smollm-135m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, torch.Generator().manual_seed(0))
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params, batch_size=1, max_seq=8)
    assert Engine(cfg, params, 1, 8, device="cpu").device == torch.device("cpu")
    assert resolve_device("cpu") == torch.device("cpu")
    assert load_design(MIXER, device="cpu").device == torch.device("cpu")


def test_unsupported_device_is_refused():
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
