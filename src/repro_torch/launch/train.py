"""Training launcher: the port of the JAX package's ``repro.launch.train``.

    PYTHONPATH=src python -m repro_torch.launch.train --arch smollm-135m \
        --steps 200 --seq-len 128 --batch 8 [--smoke] [--device cuda]

Runs the fault-tolerant ``Trainer`` (async checkpoints, crash recovery,
deterministic data resume) on one device: the CUDA card by default,
``--device cpu`` on the CPU (with ``--smoke``, the reduced config, for a
run there).  Above 1.5e10 parameters the bf16 parameters are their own
master (``master_dtype=None``), as in the reference.  ``--mesh`` takes
only ``none``: sharding over several cards is not ported yet.
"""

from __future__ import annotations

import argparse
import logging
import os
import tempfile

import torch

from .. import configs
from .._device import resolve_device
from ..configs.base import RunConfig
from ..data.pipeline import DataConfig, Pipeline
from ..models import init_params
from ..train.train_lib import Trainer, make_train_step


def main(argv=None) -> dict:
    logging.basicConfig(level=logging.INFO)
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--steps", type=int, default=200)
    ap.add_argument("--seq-len", type=int, default=128)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--mesh", default="none")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--ckpt-dir", default=os.path.join(tempfile.gettempdir(),
                                                       "repro_torch_train_ckpt"))
    ap.add_argument("--ckpt-every", type=int, default=100)
    ap.add_argument("--microbatch", type=int, default=1)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    if args.mesh != "none":
        raise ValueError(f"--mesh {args.mesh}: only 'none' is supported (one device)")
    dev = resolve_device(args.device)

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
    step_fn, opt_init = make_train_step(cfg, run_cfg, device=dev)

    def init_fn():
        return init_params(cfg, torch.Generator(dev).manual_seed(0), device=dev)

    trainer = Trainer.resume_or_init(cfg, run_cfg, pipe, init_fn, step_fn, opt_init,
                                     device=dev)
    print(f"training {cfg.name}: {cfg.param_count():,} params on {dev}, "
          f"resuming at step {trainer.step}")
    metrics = trainer.run(args.steps)
    print(f"done at step {trainer.step}: {metrics}")
    return metrics


if __name__ == "__main__":
    main()
