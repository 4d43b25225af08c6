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
from repro_torch.nn import compile_model, params_from_numpy
from repro_torch.nn import init_params as nn_init_params
from repro_torch.nn import models as nn_models
from repro_torch.random import PRNGKey
from repro_torch.runtime import ServeEngine, design_from_arrays, load_design
from repro_torch.serve import Engine
from repro_torch.configs.base import RunConfig
from repro_torch.examples import train_jet_tagger
from repro_torch.launch import train as launch_train
from repro_torch.train import Trainer, make_train_step

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
    assert {"repro_torch.obs.trace", "repro_torch.obs.metrics", "repro_torch.obs.flight",
            "repro_torch.obs.solvelog", "repro_torch.chaos.plan", "repro_torch.nn.interpreter",
            "repro_torch.kernels.graphs"} <= set(mods)
    # the compile path: the solver, emission, the verifier and the NN front end
    assert {f"repro_torch.core.{m}" for m in (
        "cache", "cost", "csd", "cse", "graph_decompose", "pipelining", "rtlsim", "solver",
        "verilog")} <= set(mods)
    assert {f"repro_torch.analysis.{m}" for m in (
        "artifact", "diagnostics", "program", "steps", "verify")} <= set(mods)
    assert {"repro_torch.nn.layers", "repro_torch.nn.models", "repro_torch.nn.compiler",
            "repro_torch.nn.quant"} <= set(mods)
    # the facade, the co-sim gate and the MoE family
    assert {"repro_torch.flow.facade", "repro_torch.core.cosim",
            "repro_torch.models.moe"} <= set(mods)
    # training: the optimizers, data, checkpoints, the train step, the
    # launcher and the jet-tagger example
    assert {"repro_torch.tree", "repro_torch.optim.adamw", "repro_torch.optim.adafactor",
            "repro_torch.optim.quantized_state", "repro_torch.data.pipeline",
            "repro_torch.train.checkpoint", "repro_torch.train.train_lib",
            "repro_torch.launch.train", "repro_torch.examples.train_jet_tagger"} <= set(mods)
    # the twins of the remaining examples
    assert {f"repro_torch.examples.{m}" for m in (
        "quickstart", "rtl_codegen", "serve_lm", "train_lm_resumable")} <= set(mods)
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
        "import repro_torch.serve, repro_torch.train, repro_torch.launch.train\n"
        "from repro_torch.kernels import _build\n"
        "print(json.dumps({'loaded': sorted(_build._loaded), 'launches': k.launches.value"
        " + fa.launches.value + ss.launches.value + qm.launches.value"
        " + fa.bwd_launches.value + ss.bwd_launches.value}))\n"
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
    jet, jet_shape, jet_quant = nn_models.jet_tagger()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        nn_init_params(jet, jet_shape, torch.Generator().manual_seed(0))
    jet_params, _ = nn_init_params(jet, jet_shape, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        compile_model(jet, jet_params, jet_shape, jet_quant)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        params_from_numpy([{}])
    cfg = configs.get_smoke("smollm-135m")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(cfg, PRNGKey(0))
    params = init_params(cfg, PRNGKey(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(cfg, params, batch_size=1, max_seq=8)
    assert Engine(cfg, params, 1, 8, device="cpu").device == torch.device("cpu")
    ssm_cfg = configs.get_smoke("falcon-mamba-7b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(ssm_cfg, PRNGKey(0))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache(ssm_cfg, 1, 8)
    ssm_params = init_params(ssm_cfg, PRNGKey(0), device="cpu")
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
    # training: the train step, the Trainer, the launcher and the example
    run_cfg = RunConfig()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_train_step(cfg, run_cfg)
    step, opt_init = make_train_step(cfg, run_cfg, device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer(cfg, run_cfg, None, params, step, opt_init(params))
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Trainer.resume_or_init(cfg, run_cfg, None, lambda: params, step, opt_init)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        launch_train.main(["--smoke", "--steps", "1"])
    with pytest.raises(RuntimeError, match="device='cpu'"):
        train_jet_tagger.main(["--steps", "1"])


def test_unsupported_device_is_refused():
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_no_card_means_raise_for_the_facade_cosim_and_moe(no_card):
    from repro_torch.core import cosim_grid
    from repro_torch.flow import Deployment, Flow

    with pytest.raises(RuntimeError, match="device='cpu'"):
        Flow.load(MIXER)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Flow.serve()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Deployment()
    jet, jet_shape, jet_quant = nn_models.jet_tagger()
    jet_params, _ = nn_init_params(jet, jet_shape, torch.Generator().manual_seed(0), "cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Flow.compile(jet, jet_params, jet_shape, jet_quant)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cosim_grid()
    moe_cfg = configs.get_smoke("qwen3-moe-30b-a3b")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_params(moe_cfg, PRNGKey(0))
    moe_params = init_params(moe_cfg, PRNGKey(0), device="cpu")
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Engine(moe_cfg, moe_params, batch_size=1, max_seq=8)
    assert Engine(moe_cfg, moe_params, 1, 8, device="cpu").device == torch.device("cpu")


SHARDING_MODULES = ("repro_torch.distributed", "repro_torch.distributed.sharding",
                    "repro_torch.launch.mesh", "repro_torch.launch.specs",
                    "repro_torch.launch.hlo_analysis", "repro_torch.launch.roofline",
                    "repro_torch.launch.dryrun")


def test_sharding_and_launch_modules_import_without_jax_a_kernel_or_a_process_group():
    """The seven modules of the sharded path and the launch tools import
    without JAX or ``repro``, load no kernel and start no process or
    process group; and a DTensor that reaches a kernel wrapper is refused
    (it has to go through ``local_map``), not run on its plain version."""
    assert set(SHARDING_MODULES) <= set(_modules())
    res = _run(
        "import importlib, json, subprocess, sys\n"
        "def refuse(*a, **k): raise AssertionError('a process was started on import')\n"
        "subprocess.Popen = refuse\n"
        f"for m in {SHARDING_MODULES!r}: importlib.import_module(m)\n"
        "import torch, torch.distributed as dist\n"
        "from repro_torch.kernels import _build\n"
        "out = {'group': dist.is_initialized(), 'loaded': sorted(_build._loaded),\n"
        "       'bad': sorted(m for m in sys.modules if m.split('.')[0] in ('jax', 'repro'))}\n"
        "from repro_torch.launch.dryrun import fake_group\n"
        "from torch.distributed.tensor import Replicate, distribute_tensor\n"
        "from repro_torch.kernels.flash_attention import flash_attention\n"
        "from repro_torch.kernels.ssm_scan import selective_scan\n"
        "from repro_torch.launch.mesh import make_test_mesh\n"
        "refused = []\n"
        "with fake_group(1):\n"
        "    mesh = make_test_mesh(1, 1, device_type='cpu')\n"
        "    d = lambda *s: distribute_tensor(torch.ones(s), mesh, [Replicate()] * 2)\n"
        "    for call in (lambda: flash_attention(d(1, 2, 3, 4), d(1, 2, 3, 4), d(1, 2, 3, 4)),\n"
        "                 lambda: selective_scan(d(1, 2, 3), d(1, 2, 4), d(1, 2, 4), d(1, 2, 3),\n"
        "                                        d(3, 4), d(1, 3, 4))):\n"
        "        try:\n"
        "            call()\n"
        "        except TypeError as e:\n"
        "            refused.append('local_map' in str(e))\n"
        "out['refused'] = refused\n"
        "out['group_after'] = dist.is_initialized()\n"
        "print(json.dumps(out))\n"
    )
    assert res == {"group": False, "loaded": [], "bad": [], "refused": [True, True],
                   "group_after": False}
