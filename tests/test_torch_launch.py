"""The port's launch tools: the per-rank cost count (``hlo_analysis``,
held to the three calibration programs of ``tests/test_hlo_analysis.py``),
the H100 roofline, the abstract inputs of every family (``specs``,
against the JAX package's), the dry-run on the ``fake`` process group at
full size, and the launcher's ``--mesh single`` on 256 fake ranks.

Everything that starts a process group runs in one subprocess with its
own time limit, so no group outlives it in the test worker.
"""

import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest

from repro import configs as jconfigs
from repro.configs.base import SHAPES as JSHAPES
from repro.launch import specs as jspecs
from repro_torch import configs
from repro_torch.configs.base import SHAPES
from repro_torch.distributed import MeshRules
from repro_torch.launch import roofline, specs
from repro_torch.tree import tree_leaves

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

SCRIPT = r"""
import json, os, sys, tempfile
import torch
import torch.distributed as dist
from torch.distributed.tensor import DTensor, Replicate, Shard, distribute_tensor
from repro_torch.launch.dryrun import dryrun_cell, fake_group
from repro_torch.launch.hlo_analysis import analyze
from repro_torch.launch.mesh import make_test_mesh

out = {}
with fake_group(8):
    mesh = make_test_mesh(2, 4, device_type="cpu")

    def put(x, pl):
        return distribute_tensor(x, mesh, pl, src_data_rank=None)

    # 1) a loop of known trip count: flops = trips x body, per rank
    w = put(torch.randn(8, 512, 512), [Shard(1), Shard(2)])
    x = put(torch.randn(128, 512), [Shard(0), Replicate()])

    def loop(w, c):
        for i in range(8):
            c = torch.tanh(c @ w[i])
        return c

    out["scan_flops"] = analyze(loop, w, x, n_devices=8).flops
    out["scan_expected"] = 8 * 2 * 128 * 512 * 512 / 8
    # 2) one sharded matmul: per-rank flops
    a = put(torch.randn(1024, 1024), [Shard(0), Replicate()])
    b = put(torch.randn(1024, 1024), [Replicate(), Shard(1)])
    out["mm_flops"] = analyze(lambda a, b: a @ b, a, b, n_devices=8).flops
    out["mm_expected"] = 2 * 1024**3 / 8
    # 3) a sum reduced to replicated: collective bytes
    s = put(torch.randn(128, 256), [Shard(0), Replicate()])
    r3 = analyze(lambda s: s.sum(0).redistribute(mesh, [Replicate(), Replicate()]), s,
                 n_devices=8)
    out["reduce_coll"] = r3.coll_wire_bytes
    out["reduce_kinds"] = sorted(r3.coll_by_kind)

# the launcher on 256 fake ranks
from repro_torch.launch import train as launch_train
from repro_torch.models import param_shardings
from repro_torch.tree import tree_leaves, tree_map
seen = {}
run = launch_train.Trainer.run
def spy(self, n, **kw):
    seen["trainer"] = self
    return run(self, n, **kw)
launch_train.Trainer.run = spy
with fake_group(256):
    metrics = launch_train.main(["--smoke", "--mesh", "single", "--steps", "1", "--device", "cpu",
                                 "--seq-len", "16", "--batch", "32",
                                 "--ckpt-dir", tempfile.mkdtemp()])
    tr = seen["trainer"]
    from repro_torch.distributed import MeshRules
    rules = MeshRules(tr.params["embed"].device_mesh)
    want = param_shardings(tr.cfg, rules)
    out["launch"] = {
        "step": tr.step,
        "metrics": sorted(metrics),
        "mesh": list(tr.params["embed"].device_mesh.shape),
        "all_dtensor": all(isinstance(p, DTensor) for p in tree_leaves(tr.params)),
        "placed": all(tree_leaves(tree_map(lambda p, sh: tuple(p.placements) == sh[1],
                                           tr.params, want))),
    }

# the dry-run at full size on the production mesh
cells = {}
for arch, shape in (("smollm-135m", "decode_32k"), ("qwen3-moe-30b-a3b", "decode_32k")):
    cells[arch] = dryrun_cell(arch, shape, False, verbose=False)
out["cells"] = cells
print(json.dumps(out, default=str))
"""


@pytest.fixture(scope="module")
def result():
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", SCRIPT], capture_output=True, text=True,
                         env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_scan_trip_weighting_exact(result):
    assert result["scan_flops"] == pytest.approx(result["scan_expected"], rel=1e-6)


def test_single_matmul_per_chip(result):
    assert result["mm_flops"] == pytest.approx(result["mm_expected"], rel=1e-6)


def test_collectives_detected(result):
    assert result["reduce_coll"] > 0
    assert result["reduce_kinds"] == ["all-reduce"]


def test_launcher_trains_sharded_on_256_fake_ranks(result):
    got = result["launch"]
    assert got["step"] == 1 and got["metrics"] == ["grad_norm", "loss", "lr"]
    assert got["mesh"] == [16, 16]
    assert got["all_dtensor"] and got["placed"]


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-30b-a3b"])
def test_dryrun_cell_is_ok_at_full_size(result, arch):
    row = result["cells"][arch]
    cfg = configs.get(arch)
    assert row["status"] == "ok" and row["mesh"] == "pod16x16"
    # every rank holds its shard: 256 shards hold at least the whole model
    model_bytes = cfg.param_count() * 2  # bf16
    assert row["params_gb"] * 2**30 * 256 >= model_bytes
    assert row["cache_gb"] > 0 and row["flops_per_chip"] > 0
    assert row["bottleneck"] in ("compute", "memory", "collective")
    assert row["memory_per_chip_gb"] * 2**30 >= (row["params_gb"] + row["cache_gb"]) * 2**30


def test_roofline_row_at_a_known_count():
    rl = roofline.Roofline(arch="a", shape="s", mesh="m", n_devices=4,
                           flops_per_chip=989e12, bytes_per_chip=3.35e12 / 2,
                           coll_bytes_per_chip=450e9 * 2, coll_by_kind={"all-reduce": 9e11},
                           model_flops_total=2 * 989e12, memory_per_chip_bytes=2**30)
    row = rl.row()
    assert row["t_compute_s"] == pytest.approx(1.0)
    assert row["t_memory_s"] == pytest.approx(0.5)
    assert row["t_collective_s"] == pytest.approx(2.0)
    assert row["bottleneck"] == "collective"
    assert row["useful_flops_fraction"] == pytest.approx(0.5)
    assert row["mfu_bound"] == pytest.approx(2 * 989e12 / (4 * 989e12 * 2.0))
    assert row["memory_per_chip_gb"] == pytest.approx(1.0)


def test_model_flops_match_the_jax_package():
    from repro.launch.roofline import model_flops as jax_model_flops

    for name in configs.ARCHS:
        for shape in SHAPES:
            assert roofline.model_flops(configs.get(name), SHAPES[shape]) == \
                jax_model_flops(jconfigs.get(name), JSHAPES[shape])


class _Mesh:
    def __init__(self, shape, names):
        self.shape, self.mesh_dim_names = shape, names

    def size(self, i):
        return self.shape[i]


@pytest.mark.parametrize("name", sorted(configs.ARCHS))
def test_specs_match_the_jax_package_for_every_family(name):
    cfg, jcfg = configs.get(name), jconfigs.get(name)
    assert specs.cell_names(cfg) == jspecs.cell_names(jcfg)
    rules = MeshRules(_Mesh((16, 16), ("data", "model")))
    for shape in specs.cell_names(cfg):
        ours = specs.input_specs(cfg, SHAPES[shape])
        theirs = jspecs.input_specs(jcfg, JSHAPES[shape])
        assert sorted(ours) == sorted(theirs)
        for k in ours:
            assert ours[k].device.type == "meta"
            assert tuple(ours[k].shape) == tuple(theirs[k].shape), (shape, k)
            assert str(ours[k].dtype).removeprefix("torch.") == np.dtype(theirs[k].dtype).name
        sh = specs.batch_shardings(cfg, SHAPES[shape], rules)
        for k, leaf in ours.items():
            assert sh[k][1] == rules.spec(("batch",) + (None,) * (leaf.ndim - 1), leaf.shape)
    cache = specs.abstract_cache(cfg, SHAPES["decode_32k"])
    jcache = jspecs.abstract_cache(jcfg, JSHAPES["decode_32k"])
    assert [tuple(x.shape) for x in tree_leaves(cache)] == \
        [tuple(x.shape) for x in jax.tree.leaves(jcache)]
    assert all(x.device.type == "meta" for x in tree_leaves(cache))
