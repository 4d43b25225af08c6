"""Elastic rescale in the port: the port of ``tests/test_elastic.py``.  A
checkpoint written under a 2x4 mesh restores onto a 4x2 mesh, and onto
one device, with identical values, and ``restore(..., shardings=)``
applies the target layout (the restart-after-resize path).  Eight gloo
ranks in one subprocess with its own time limit."""

import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

SCRIPT = r"""
import json, sys
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, world, store, ckpt_dir, out_json):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
    from repro_torch import configs
    from repro_torch.distributed import MeshRules, use_rules
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import init_params, param_shardings, shard_params
    from repro_torch.random import PRNGKey
    from repro_torch.train import checkpoint
    from repro_torch.tree import tree_leaves, tree_map

    cfg = configs.get_smoke("stablelm-3b")
    params = init_params(cfg, PRNGKey(0), device="cpu")

    # save under a 2x4 mesh
    rules_a = MeshRules(make_test_mesh(2, 4, device_type="cpu"))
    with use_rules(rules_a):
        params_a = shard_params(params, param_shardings(cfg, rules_a))
    checkpoint.save(ckpt_dir, 3, {"p": params_a})

    # restore under a 4x2 mesh (elastic reshape), then on one device
    rules_b = MeshRules(make_test_mesh(4, 2, device_type="cpu"))
    with use_rules(rules_b):
        sh_b = param_shardings(cfg, rules_b)
        restored_b = checkpoint.restore(ckpt_dir, 3, {"p": params}, shardings={"p": sh_b})
    restored_1 = checkpoint.restore(ckpt_dir, 3, {"p": params})

    def dmax(got):
        return max(float((a - (b.full_tensor() if hasattr(b, "full_tensor") else b)).abs().max())
                   for a, b in zip(tree_leaves(params), tree_leaves(got)))

    res = {
        "d_mesh_b": dmax(restored_b["p"]),
        "d_single": dmax(restored_1["p"]),
        "resharded": all(tree_leaves(tree_map(
            lambda x, sh: x.device_mesh is sh[0] and tuple(x.placements) == sh[1],
            restored_b["p"], sh_b))),
        "local_shapes_b": [list(x.to_local().shape) for x in tree_leaves(restored_b["p"])][:3],
        "plain_single": not any(hasattr(x, "placements") for x in tree_leaves(restored_1["p"])),
        "n_ranks": dist.get_world_size(),
    }
    if rank == 0:
        with open(out_json, "w") as fh:
            json.dump(res, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    store, ckpt_dir, out_json = sys.argv[1:4]
    mp.spawn(rank_main, args=(8, store, ckpt_dir, out_json), nprocs=8, join=True)
"""


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    d = tmp_path_factory.mktemp("elastic")
    (d / "ckpt").mkdir()
    (d / "run.py").write_text(SCRIPT)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, str(d / "run.py"), str(d / "store"), str(d / "ckpt"),
                          str(d / "out.json")], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads((d / "out.json").read_text())


def test_values_identical_after_mesh_reshape(result):
    assert result["n_ranks"] == 8
    assert result["d_mesh_b"] == 0.0


def test_values_identical_on_single_device(result):
    assert result["d_single"] == 0.0
    assert result["plain_single"]


def test_target_shardings_applied(result):
    assert result["resharded"]
