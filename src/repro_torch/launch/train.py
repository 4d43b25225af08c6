"""Training launcher: the port of the JAX package's ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --seq-len 128 --batch 8 [--smoke] [--device cuda]

Runs the fault-tolerant ``Trainer`` (async checkpoints, crash recovery,
deterministic data resume): the CUDA card by default, ``--device cpu`` on
the CPU (with ``--smoke``, the reduced config, for a run there).  Above
1.5e10 parameters the bf16 parameters are their own master
(``master_dtype=None``), as in the reference.

``--mesh single|multi`` runs sharded on the production mesh (16x16, or
2x16x16) over the ranks ``torchrun`` started (or a process group the
caller already started): parameters, optimizer state and batches are
laid out by the sharding rules, each rank training its shard.  Each rank
draws only its blocks of the parameters (``init_params(...,
shardings=)``), the values the JAX launcher's sharded init gives there:

    torchrun --nproc-per-node 8 --nnodes 32 ... -m repro_torch.launch.train \
        --arch smollm-135m --mesh single

The mesh needs exactly 256 (or 512) ranks; with another world size the
launcher refuses.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch
import torch.distributed as dist

from .. import configs
from .._device import resolve_device
from ..configs.base import RunConfig
from ..data.pipeline import DataConfig, Pipeline
from ..distributed import MeshRules, use_rules
from ..models import init_params, param_shardings
from ..random import PRNGKey
from ..train.train_lib import Trainer, make_train_step
from .mesh import make_production_mesh


def _mesh_for(kind: str, dev: torch.device):
    """The production mesh over the job's ranks (None for ``none``)."""
    if kind == "none":
        return None
    n = 512 if kind == "multi" else 256
    if not dist.is_initialized() and "WORLD_SIZE" in os.environ:  # started by torchrun
        if dev.type == "cuda":
            torch.cuda.set_device(int(os.environ.get("LOCAL_RANK", 0)))
        dist.init_process_group("nccl" if dev.type == "cuda" else "gloo")
    world = dist.get_world_size() if dist.is_initialized() else 1
    if world != n:
        raise ValueError(f"--mesh {kind} needs {n} ranks (launch with torchrun); "
                         f"this job has {world}")
    return make_production_mesh(multi_pod=kind == "multi", device_type=dev.type)


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="none", choices=["none", "single", "multi"])
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)
    mesh = _mesh_for(args.mesh, dev)

    cfg = configs.get_smoke(args.arch) if args.smoke else configs.get(args.arch)
    run_cfg = RunConfig(
        learning_rate=args.lr,
        checkpoint_dir=args.ckpt_dir,
        checkpoint_every=args.ckpt_every,
        microbatch=args.microbatch,
        master_dtype=None if cfg.param_count() > 1.5e10 else "float32",
    )
    pipe = Pipeline(
        DataConfig(vocab_size=cfg.vocab_size, seq_len=args.seq_len, global_batch=args.batch)
    )
    rules = None if mesh is None else MeshRules(mesh, fsdp_over_pod=run_cfg.fsdp_over_pod,
                                                seq_shard=run_cfg.seq_shard)
    with use_rules(rules):
        step_fn, opt_init = make_train_step(cfg, run_cfg, device=dev)

        def init_fn():  # under a mesh each rank draws only its blocks of the parameters
            shardings = None if rules is None else param_shardings(cfg, rules)
            return init_params(cfg, PRNGKey(0), device=dev, shardings=shardings)

        trainer = Trainer.resume_or_init(cfg, run_cfg, pipe, init_fn, step_fn, opt_init,
                                         device=dev)
        print(f"training {cfg.name}: {cfg.param_count():,} params on {dev}"
              f"{'' if mesh is None else f' over a {tuple(mesh.shape)} mesh'}, "
              f"resuming at step {trainer.step}")
        metrics = trainer.run(args.steps)
    print(f"done at step {trainer.step}: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
