"""The port's boundary: it imports neither ``jax`` nor any module of
``repro``, its entry points refuse to fall back to the CPU when no card
is present, and importing it builds no kernel."""

import inspect
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
from repro_torch.kernels.quant_matmul import kernel as qm_kernel
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.ssm_scan import kernel as ss_kernel
from repro_torch.kernels.ssm_scan import selective_scan
from repro_torch.models import init_cache, init_params
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
    assert {"repro_torch.models.ssm", "repro_torch.kernels.ssm_scan.kernel",
            "repro_torch.kernels.ssm_scan.ops", "repro_torch.kernels.quant_matmul.kernel",
            "repro_torch.kernels.quant_matmul.ops"} <= set(mods)
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
        "import repro_torch.kernels.ssm_scan.kernel as ss\n"
        "import repro_torch.kernels.quant_matmul.kernel as qm\n"
        "import repro_torch.serve\n"
        "from repro_torch.kernels import _build\n"
        "print(json.dumps({'loaded': sorted(_build._loaded), 'launches': k.launches.value"
        " + fa.launches.value + ss.launches.value + qm.launches.value}))\n"
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
    ssm_cfg = configs.get_smoke("falcon-mamba-7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(ssm_cfg, torch.Generator().manual_seed(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(ssm_cfg, 1, 8)
    ssm_params = init_params(ssm_cfg, torch.Generator().manual_seed(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(ssm_cfg, ssm_params, batch_size=1, max_seq=8)
    assert Engine(ssm_cfg, ssm_params, 1, 8, device="cpu").device == torch.device("cpu")
    # the two ops take no device: the tensors' device decides, and a CPU
    # tensor takes the plain version, never a kernel
    for op in (selective_scan, quant_matmul):
        assert "device" not in inspect.signature(op).parameters
    n = ss_kernel.launches.value + qm_kernel.launches.value
    y, _ = selective_scan(*(torch.ones(s) for s in ((1, 2, 3), (1, 2, 4), (1, 2, 4), (1, 2, 3),
                                                    (3, 4), (1, 3, 4))))
    q = quant_matmul(torch.ones(2, 3, dtype=torch.int8), torch.ones(3, 2, dtype=torch.int8),
                     torch.ones(2), torch.ones(2))
    assert y.device == q.device == torch.device("cpu")
    assert ss_kernel.launches.value + qm_kernel.launches.value == n
    assert resolve_device("cpu") == torch.device("cpu")
    assert load_design(MIXER, device="cpu").device == torch.device("cpu")


def test_unsupported_device_is_refused():
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")
