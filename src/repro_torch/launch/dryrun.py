"""Dry-run of every (arch x shape x mesh) cell on the production meshes:
the port of the JAX package's ``repro.launch.dryrun``.

For each cell this starts a ``fake`` process group of 256 (16x16) or 512
(2x16x16) ranks in this one process, as rank 0, builds the production
mesh over it, lays abstract params / optimizer state / batches / caches
out on it as fake tensors (``FakeTensorMode``: shapes, no storage), and
runs rank 0's shard of the real train step, prefill or decode step,
allocating nothing.  It records, per rank:

  * the bytes of parameters, optimizer state and cache, from the local
    shard shapes;
  * the peak, estimated as the most bytes live at once over the step
    (``hlo_analysis.CostMode``: the state held plus every local storage
    until its last tensor dies), beside the H100's 80 GB.  On the CPU the
    attention runs its plain version, which holds the [B, H, Sq, Sk]
    scores that the card's flash kernel never writes, so for the long
    prefill and train cells the estimate is high;
  * FLOPs, bytes and collective wire bytes (``hlo_analysis.analyze``),
    and the three roofline terms, the bottleneck and the MFU bound
    (``roofline.py``, H100 data-sheet figures);
  * the microbatch, the optimizer and the sharding fallbacks.

A train cell runs one microbatch of the step (``RunConfig.microbatch``
set to 1 on the microbatch's rows) and weights its FLOPs, bytes and
collectives by the number of microbatches, as the reference weights its
scan body by the trip count (the optimizer update, counted once per
microbatch so, moves bytes that are small beside the layers'); the peak
adds the f32 gradient accumulator the real step holds.

No number here is a measurement of the card: it is arithmetic on shapes
and data-sheet rates.  A cell that raises is a FAIL row: a fault of the
port, not of the harness.  Importing this module starts no process
group; ``main`` and ``dryrun_cell`` start (and destroy) the fake one.

Usage:
    PYTHONPATH=src python -m repro_torch.launch.dryrun --arch all --shape all \\
        --mesh both --out experiments/dryrun_torch.json
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import os
import time
import traceback

import torch
import torch.distributed as dist
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.fx.experimental.symbolic_shapes import ShapeEnv
from torch.distributed.tensor import DTensor
from torch.distributed.tensor import empty as dtensor_empty

from .. import configs
from ..configs.base import SHAPES, RunConfig
from ..distributed import MeshRules, use_rules
from ..models import decode_step, param_shardings
from ..models.transformer import init_cache, param_specs, prefill, torch_dtype
from ..train.train_lib import make_train_step
from ..tree import tree_leaves, tree_map
from .hlo_analysis import CostMode
from .mesh import make_production_mesh
from .roofline import HBM_BYTES, Roofline, model_flops
from .specs import batch_shardings, input_specs


def _microbatch_for(cfg, shape, n_data: int) -> int:
    """Grad-accumulation factor bounding the per-rank per-microbatch
    activation memory -- the layer inputs saved for backward plus the f32
    logits of the loss -- to ~4 GiB (the reference's rule)."""
    per_chip_batch = max(shape.global_batch // n_data, 1)
    tokens_chip = per_chip_batch * shape.seq_len
    carry = tokens_chip * cfg.d_model * 2 * cfg.n_layers  # bf16 per layer
    logits = tokens_chip * (cfg.padded_vocab // 16) * 4 * 2  # f32, vocab/model
    total = carry + logits
    mb = 1
    while total / mb > 4e9 and mb < per_chip_batch:
        mb *= 2
    return mb


def _run_cfg_for(cfg, shape=None, n_data: int = 16) -> RunConfig:
    """Memory-appropriate optimizer settings per architecture scale."""
    mb = _microbatch_for(cfg, shape, n_data) if shape is not None else 1
    if cfg.param_count() > 3e11:  # 1T-class: factored states, pod-fsdp
        return RunConfig(optimizer="adafactor", master_dtype=None, fsdp_over_pod=True,
                         microbatch=mb)
    if cfg.param_count() > 1.5e10:  # 20B+: bf16 params are the master
        return RunConfig(master_dtype=None, microbatch=mb)
    return RunConfig(microbatch=mb)


@contextlib.contextmanager
def fake_group(world: int, rank: int = 0):
    """A ``fake`` process group of ``world`` ranks, this process rank
    ``rank`` (its collectives move nothing); destroyed on exit."""
    from torch.testing._internal.distributed.fake_pg import FakeStore

    dist.init_process_group("fake", store=FakeStore(), rank=rank, world_size=world)
    try:
        yield
    finally:
        dist.destroy_process_group()


def _abstract(shape, dtype, sharding):
    """A fake DTensor: rank 0's shard of a ``shape`` tensor laid out by
    ``sharding`` (mesh, placements)."""
    mesh, placements = sharding
    return dtensor_empty(shape, dtype=dtype, device_mesh=mesh, placements=list(placements))


def _local_bytes(tree) -> int:
    return sum(x.to_local().numel() * x.element_size() if isinstance(x, DTensor)
               else x.numel() * x.element_size() for x in tree_leaves(tree))


def dryrun_cell(arch: str, shape_name: str, multi_pod: bool, verbose: bool = True) -> dict:
    cfg = configs.get(arch)
    shape = SHAPES[shape_name]
    world = 512 if multi_pod else 256
    ctx = (contextlib.nullcontext() if dist.is_initialized() and dist.get_world_size() == world
           else fake_group(world))
    with ctx:
        return _dryrun_cell(cfg, arch, shape, shape_name, multi_pod, verbose)


def _dryrun_cell(cfg, arch, shape, shape_name, multi_pod, verbose):
    mesh = make_production_mesh(multi_pod=multi_pod, device_type="cpu")
    names = mesh.mesh_dim_names
    n_data = mesh.size(names.index("data")) * (mesh.size(0) if "pod" in names else 1)
    run_cfg = _run_cfg_for(cfg, shape if shape.kind == "train" else None, n_data)
    # inference: replicate params over data unless they don't fit per rank
    serve_fsdp = cfg.param_count() * 2 / mesh.size(names.index("model")) > 8e9
    fsdp = True if shape.kind == "train" else serve_fsdp
    rules = MeshRules(mesh, fsdp_over_pod=run_cfg.fsdp_over_pod, fsdp=fsdp)
    mesh_name = "pod2x16x16" if multi_pod else "pod16x16"
    n_dev = mesh.size()
    dtype = torch_dtype(cfg)

    t0 = time.perf_counter()
    fake = FakeTensorMode(allow_non_fake_inputs=False, shape_env=ShapeEnv())
    with use_rules(rules), fake:
        p_sh = param_shardings(cfg, rules)
        params = tree_map(lambda s, sh: _abstract(s.shape, dtype, sh), param_specs(cfg), p_sh)
        b_sh = batch_shardings(cfg, shape, rules)
        batch = tree_map(lambda leaf, sh: _abstract(leaf.shape, leaf.dtype, sh),
                         input_specs(cfg, shape), b_sh)
        param_b = _local_bytes(params)
        opt_b = cache_b = 0
        cost = CostMode(n_dev, fake_mode=fake)
        cost.hold(*tree_leaves(params))
        if shape.kind == "train":
            # the microbatches run one program each: count one, weight it
            # by their number (the reference weights its scan body by the
            # trip count); the real step also holds an f32 accumulator
            mb = run_cfg.microbatch
            one = dataclasses.replace(run_cfg, microbatch=1)
            step_fn, opt_init = make_train_step(cfg, one, device="cpu")
            rows = shape.global_batch // mb
            micro = tree_map(lambda leaf, sh: _abstract((rows, *leaf.shape[1:]), leaf.dtype, sh),
                             input_specs(cfg, shape), batch_shardings(
                                 cfg, dataclasses.replace(shape, global_batch=rows), rules))
            micro = {k: v.long() if k in ("tokens", "labels") else v for k, v in micro.items()}
            opt = opt_init(params)
            opt_b = _local_bytes(opt)
            cost.hold(*tree_leaves(opt))
            with cost:
                step_fn(params, opt, micro, 0)
            cost.costs.scale(mb)
            if mb > 1:
                cost.costs.peak_bytes += sum(x.to_local().numel() * 4 for x in tree_leaves(params))
        elif shape.kind == "prefill":
            batch = {k: v.long() if k == "tokens" else v for k, v in batch.items()}
            with cost, torch.no_grad():
                _, cache = prefill(cfg, params, batch, shape.seq_len)
            cache_b = _local_bytes(cache)
        else:  # decode: one token against a seq_len-deep cache
            cache = init_cache(cfg, shape.global_batch, shape.seq_len)
            cache_b = _local_bytes(cache)
            cost.hold(*tree_leaves(cache))
            with cost, torch.no_grad():
                decode_step(cfg, params, batch["tokens"].long(), cache)
        peak = cost.costs.peak_bytes
    t_run = time.perf_counter() - t0

    wc = cost.costs
    rl = Roofline(
        arch=arch, shape=shape_name, mesh=mesh_name, n_devices=n_dev,
        flops_per_chip=wc.flops, bytes_per_chip=wc.hbm_bytes,
        coll_bytes_per_chip=wc.coll_wire_bytes, coll_by_kind=wc.coll_by_kind,
        model_flops_total=model_flops(cfg, shape), memory_per_chip_bytes=peak,
    )
    row = rl.row()
    row.update({
        "status": "ok",
        "params_gb": param_b / 2**30,
        "opt_gb": opt_b / 2**30,
        "cache_gb": cache_b / 2**30,
        "fits_80gb": peak <= HBM_BYTES,
        "microbatch": run_cfg.microbatch,
        "run_s": round(t_run, 1),
        "n_collectives": wc.n_collectives,
        "sharding_fallbacks": sorted({str(f) for f in rules.fallbacks}),
        "optimizer": run_cfg.optimizer
        + ("/int8" if run_cfg.state_dtype == "int8" else "")
        + ("/f32master" if run_cfg.master_dtype == "float32" else ""),
    })
    if verbose:
        print(f"[{arch} x {shape_name} x {mesh_name}] OK  "
              f"params/rank={row['params_gb']:.2f}GiB peak~{row['memory_per_chip_gb']:.2f}GiB  "
              f"t_comp={rl.t_compute*1e3:.2f}ms t_mem={rl.t_memory*1e3:.2f}ms "
              f"t_coll={rl.t_collective*1e3:.2f}ms -> {rl.bottleneck}  ({t_run:.0f}s)",
              flush=True)
    return row


def main(argv=None) -> list:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="all")
    ap.add_argument("--shape", default="all")
    ap.add_argument("--mesh", default="both", choices=["single", "multi", "both"])
    ap.add_argument("--out", default="experiments/dryrun_torch.json")
    args = ap.parse_args(argv)

    archs = list(configs.ARCHS) if args.arch == "all" else args.arch.split(",")
    meshes = {"single": [False], "multi": [True], "both": [False, True]}[args.mesh]

    results = []
    if os.path.exists(args.out):
        with open(args.out) as f:
            results = json.load(f)
    done = {(r["arch"], r["shape"], r["mesh"]) for r in results if r.get("status") == "ok"}

    for multi in meshes:  # one fake group per mesh: its world size is the mesh's
        mesh_name = "pod2x16x16" if multi else "pod16x16"
        with fake_group(512 if multi else 256):
            for arch in archs:
                cfg = configs.get(arch)
                shapes = (configs.applicable_shapes(cfg) if args.shape == "all"
                          else args.shape.split(","))
                for shape_name in shapes:
                    if shape_name not in configs.applicable_shapes(cfg):
                        print(f"[{arch} x {shape_name}] SKIPPED (inapplicable family)")
                        continue
                    if (arch, shape_name, mesh_name) in done:
                        continue
                    try:
                        row = dryrun_cell(arch, shape_name, multi)
                    except Exception as e:  # noqa: BLE001 -- a failing cell is a FAIL row
                        traceback.print_exc()
                        row = {"arch": arch, "shape": shape_name, "mesh": mesh_name,
                               "status": f"FAIL: {type(e).__name__}: {e}"}
                        print(f"[{arch} x {shape_name} x {mesh_name}] {row['status']}",
                              flush=True)
                    results = [r for r in results
                               if (r["arch"], r["shape"], r["mesh"])
                               != (arch, shape_name, mesh_name)] + [row]
                    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
                    with open(args.out, "w") as f:
                        json.dump(results, f, indent=1, default=str)

    n_ok = sum(1 for r in results if r.get("status") == "ok")
    print(f"\n{n_ok}/{len(results)} cells OK -> {args.out}")
    return results


if __name__ == "__main__":
    main()
