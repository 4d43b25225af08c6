"""The port's sharded path on the CPU: the port of ``tests/test_distributed.py``.

Eight gloo ranks on a 2x4 ("data", "model") mesh run qwen3-moe's smoke
config -- the MoE, the hardest sharding path -- and check that the
sharding rules change layout, not math: the sharded train step's loss and
parameters equal the unsharded step's, sharded prefill equals unsharded,
and a checkpoint written sharded restores unsharded.  The parameters and
the batch come from the JAX package (``init_params`` with PRNGKey(0)) and
cross as numpy.  The JAX package's own sharded loss, on a 2x4 mesh of
eight forced CPU devices, holds the port's group-local MoE capacity: the
tokens are grouped by the extent of the batch axes, and each group drops
its own tokens past capacity.

Everything runs in two subprocesses (one JAX, one that spawns the eight
torch ranks), each with its own time limit, so a hang fails the fixture
instead of eating the suite's clock.
"""

import json
import os
import subprocess
import sys

import pytest

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")

JAX_SCRIPT = r"""
import os, sys, json, dataclasses
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax, jax.numpy as jnp, numpy as np
from repro import configs
from repro.distributed import MeshRules, use_rules
from repro.launch.mesh import make_test_mesh
from repro.models import init_params, param_shardings, loss_fn

out_npz, out_json = sys.argv[1], sys.argv[2]
cfg = configs.get_smoke("qwen3-moe-30b-a3b")
params = init_params(cfg, jax.random.PRNGKey(0))
key = jax.random.PRNGKey(1)
batch = {
    "tokens": jax.random.randint(key, (4, 16), 0, cfg.vocab_size),
    "labels": jax.random.randint(key, (4, 16), 0, cfg.vocab_size),
}

flat = {}
def walk(node, path):
    if isinstance(node, dict):
        for k, v in node.items():
            walk(v, path + [k])
    elif isinstance(node, (list, tuple)):
        for i, v in enumerate(node):
            walk(v, path + [str(i)])
    else:
        flat["p/" + "/".join(path)] = np.asarray(node)
walk(params, [])
np.savez(out_npz, tokens=np.asarray(batch["tokens"]), labels=np.asarray(batch["labels"]), **flat)

mesh = make_test_mesh(2, 4)
rules = MeshRules(mesh)
res = {}
for name, c in (("", cfg), ("lc_", dataclasses.replace(cfg, capacity_factor=0.5))):
    f = jax.jit(lambda p, b, c=c: loss_fn(c, p, b)[0])
    res[name + "ref_loss"] = float(f(params, batch))
    with use_rules(rules):
        p_s = jax.device_put(params, param_shardings(c, rules))
        b_s = jax.device_put(batch, jax.tree.map(
            lambda x: rules.sharding(("batch",) + (None,) * (x.ndim - 1), x.shape), batch))
        res[name + "sh_loss"] = float(f(p_s, b_s))
res["n_dev"] = jax.device_count()
with open(out_json, "w") as fh:
    json.dump(res, fh)
"""

TORCH_SCRIPT = r"""
import dataclasses, json, os, sys
import numpy as np
import torch
import torch.distributed as dist
import torch.multiprocessing as mp


def rank_main(rank, world, store, npz, ckpt_dir, out_json):
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method="file://" + store, rank=rank, world_size=world)
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.distributed import MeshRules, use_rules
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import (loss_fn, param_shardings, params_from_numpy, prefill,
                                    shard_params, unflatten)
    from repro_torch.train import checkpoint
    from repro_torch.train.train_lib import make_train_step
    from repro_torch.tree import tree_leaves, tree_map

    data = np.load(npz)
    tree = unflatten({k[2:]: data[k] for k in data.files if k.startswith("p/")})
    batch = {k: torch.from_numpy(data[k]).long() for k in ("tokens", "labels")}
    cfg = configs.get_smoke("qwen3-moe-30b-a3b")
    run_cfg = RunConfig(learning_rate=1e-3, warmup_steps=1)
    step_fn, opt_init = make_train_step(cfg, run_cfg, device="cpu")

    def fresh():
        return params_from_numpy(cfg, tree, device="cpu")

    # --- one device (every rank computes it; rank 0 reports) ---
    p1 = fresh()
    p1, _, m1 = step_fn(p1, opt_init(p1), batch, 0)
    with torch.no_grad():
        lg_r, _ = prefill(cfg, fresh(), {"tokens": batch["tokens"]}, 24)

    # --- sharded on a 2x4 (data x model) mesh ---
    mesh = make_test_mesh(2, 4, device_type="cpu")
    rules = MeshRules(mesh)
    res = {"n_ranks": dist.get_world_size(), "ref_loss": float(m1["loss"])}
    with use_rules(rules):
        shardings = param_shardings(cfg, rules)
        bs = {k: rules.distribute(v, "batch", None) for k, v in batch.items()}
        p2 = shard_params(fresh(), shardings)
        p2, _, m2 = step_fn(p2, opt_init(p2), bs, 0)
        res["sh_loss"] = float(m2["loss"])
        placed = tree_leaves(tree_map(lambda x, sh: tuple(x.placements) == sh[1], p2, shardings))
        res["placed"] = all(placed)
        with torch.no_grad():
            lg_s, cache = prefill(cfg, shard_params(fresh(), shardings), {"tokens": bs["tokens"]},
                                  24)
        res["decode_dmax"] = float((lg_s.full_tensor() - lg_r).abs().max())
        full2 = [x.full_tensor() for x in tree_leaves(p2)]
        res["param_dmax"] = max(float((a.float() - b.float()).abs().max())
                                for a, b in zip(tree_leaves(p1), full2))
        for name, c in (("lc_", dataclasses.replace(cfg, capacity_factor=0.5)),):
            with torch.no_grad():
                res[name + "sh_loss"] = float(loss_fn(c, shard_params(fresh(), shardings), bs)[0])
    with torch.no_grad():
        res["lc_ref_loss"] = float(loss_fn(dataclasses.replace(cfg, capacity_factor=0.5),
                                           fresh(), batch)[0])

    # --- the hybrid family (Mamba scan on each rank's channels) ---
    from repro_torch.models import decode_step, init_params
    from repro_torch.random import PRNGKey
    cfg_h = configs.get_smoke("jamba-v0.1-52b")
    tok_h = {k: v[:, :8] for k, v in batch.items()}

    def fresh_h():
        return init_params(cfg_h, PRNGKey(2), device="cpu")

    def loss_and_grads(params, b):
        leaves = tree_leaves(params)
        for x in leaves:
            x.requires_grad_(True)
        loss = loss_fn(cfg_h, params, b)[0]
        return float(loss), torch.autograd.grad(loss, leaves)

    l1, g1 = loss_and_grads(fresh_h(), tok_h)
    with use_rules(rules):
        l2, g2 = loss_and_grads(shard_params(fresh_h(), param_shardings(cfg_h, rules)),
                                {k: rules.distribute(v, "batch", None) for k, v in tok_h.items()})
        g2 = [g.full_tensor() for g in g2]
    res["hybrid_loss_diff"] = abs(l1 - l2)
    res["hybrid_grad_rel"] = max(float((a - b).abs().max() / a.abs().max().clamp_min(1e-30))
                                 for a, b in zip(g1, g2))

    # --- greedy decode: a sequence-sharded cache (6 query heads, 2 KV
    # heads: no exact replication on a 4-way model axis) and whisper's
    # cross cache ---
    res["decode"] = {}
    for name, c in (("seq_cache", configs.get_smoke("smollm-135m", n_heads=6, n_kv_heads=2)),
                    ("encdec", configs.get_smoke("whisper-base"))):
        pc = init_params(c, PRNGKey(3), device="cpu")
        b = {"tokens": batch["tokens"][:, :8]}
        if c.family == "encdec":
            b["enc_frames"] = torch.randn(4, c.encoder_seq, c.d_model,
                                          generator=torch.Generator().manual_seed(4))
        outs = []
        for sharded in (False, True):
            with use_rules(rules if sharded else None), torch.no_grad():
                pp, bb = pc, b
                if sharded:
                    pp = shard_params(pc, param_shardings(c, rules))
                    bb = {k: rules.distribute(v, "batch", *([None] * (v.ndim - 1)))
                          for k, v in b.items()}
                lg, cache = prefill(c, pp, bb, 16)
                steps = [lg]
                for _ in range(4):
                    nxt = lg.argmax(-1, keepdim=True).to(torch.int32)
                    lg, cache = decode_step(c, pp, nxt, cache)
                    steps.append(lg)
                outs.append([x.full_tensor() if sharded else x for x in steps])
                if sharded:
                    k0 = cache["blocks"][0]["k"]
                    res["decode"][name + "_placements"] = [str(p) for p in k0.placements]
        res["decode"][name] = max(float((a - b).abs().max()) for a, b in zip(*outs))

    # --- a checkpoint written sharded, restored unsharded ---
    checkpoint.save(ckpt_dir, 1, {"p": p2})
    restored = checkpoint.restore(ckpt_dir, 1, {"p": p1})
    res["ckpt_dmax"] = max(float((a.float() - b.float()).abs().max())
                           for a, b in zip(full2, tree_leaves(restored["p"])))
    if rank == 0:
        with open(out_json, "w") as fh:
            json.dump(res, fh)
    dist.destroy_process_group()


if __name__ == "__main__":
    store, npz, ckpt_dir, out_json = sys.argv[1:5]
    mp.spawn(rank_main, args=(8, store, npz, ckpt_dir, out_json), nprocs=8, join=True)
"""


def _run(script_path, args, env, timeout):
    out = subprocess.run([sys.executable, script_path, *args], capture_output=True, text=True,
                         env=env, timeout=timeout)
    assert out.returncode == 0, out.stderr[-3000:]


@pytest.fixture(scope="module")
def result(tmp_path_factory):
    d = tmp_path_factory.mktemp("dist")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu")
    (d / "jax_side.py").write_text(JAX_SCRIPT)
    (d / "torch_side.py").write_text(TORCH_SCRIPT)
    _run(str(d / "jax_side.py"), [str(d / "in.npz"), str(d / "jax.json")], env, 300)
    (d / "ckpt").mkdir()
    _run(str(d / "torch_side.py"), [str(d / "store"), str(d / "in.npz"), str(d / "ckpt"),
                                    str(d / "torch.json")], env, 300)
    res = json.loads((d / "torch.json").read_text())
    res["jax"] = json.loads((d / "jax.json").read_text())
    return res


def test_eight_ranks_on_a_2x4_mesh(result):
    assert result["n_ranks"] == 8 and result["jax"]["n_dev"] == 8


def test_sharded_train_step_matches_reference(result):
    assert abs(result["ref_loss"] - result["sh_loss"]) < 1e-4
    assert result["param_dmax"] < 5e-5


def test_sharded_params_keep_the_rules_placements(result):
    assert result["placed"]


def test_sharded_loss_matches_the_jax_packages_sharded_loss(result):
    assert abs(result["sh_loss"] - result["jax"]["sh_loss"]) < 1e-4
    assert abs(result["ref_loss"] - result["jax"]["ref_loss"]) < 1e-4


def test_group_local_capacity_drops_what_the_jax_package_drops(result):
    """At capacity factor 0.5 the four ranks' two groups drop other tokens
    than one group of all tokens: the sharded loss differs from the
    unsharded one, in both packages alike."""
    jx = result["jax"]
    assert abs(result["lc_sh_loss"] - jx["lc_sh_loss"]) < 1e-4
    assert abs(result["lc_ref_loss"] - jx["lc_ref_loss"]) < 1e-4
    assert abs(jx["lc_sh_loss"] - jx["lc_ref_loss"]) > 1e-3


def test_sharded_decode_matches_reference(result):
    assert result["decode_dmax"] < 1e-3


def test_hybrid_gradients_match_reference(result):
    """jamba's smoke config (16 layers of Mamba, attention and MoE): the
    loss, and every gradient leaf within 1e-4 of its largest entry -- the
    scan's local_map gradients (B and C summed over the channel shards, A
    over the batch shards) are the unsharded ones up to f32 reassociation.
    (Parameters after one AdamW step are not compared here: its first
    update is lr * sign(g) for a gradient far above eps, and the 16 layers
    leave entries near zero whose sign the reassociation can flip.)"""
    assert result["hybrid_loss_diff"] < 1e-4
    assert result["hybrid_grad_rel"] < 1e-4


def test_sequence_sharded_cache_decodes_as_unsharded(result):
    dec = result["decode"]
    assert dec["seq_cache_placements"][1] == "S(3)"  # the sequence on "model"
    assert dec["seq_cache"] < 1e-3


def test_encoder_decoder_decodes_as_unsharded(result):
    assert result["decode"]["encdec"] < 1e-3


def test_checkpoint_reshard_roundtrip(result):
    assert result["ckpt_dmax"] == 0.0
