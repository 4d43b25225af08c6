"""Fault-tolerant LM training: train a small LM for a few hundred
steps with periodic async checkpoints, then kill and resume mid-run; the
port of ``examples/train_lm_resumable.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_lm_resumable [--device cuda|cpu]

Phase 1 runs 120 steps through ``Trainer`` and survives a failure
simulated at step 90 by restoring the last checkpoint (step 50); phase 2
is a new ``Trainer`` (fresh process semantics) that resumes at step 120
and runs 80 more.  On the card attention runs the hand-written flash
kernels, forward and backward.  The weights are drawn from a
``torch.Generator`` (seed 0), which gives other numbers than the JAX
example's ``jax.random`` key.  The checkpoint directory, which the
example creates, is removed at the end.
"""

from __future__ import annotations

import argparse
import os
import shutil
import tempfile

import torch

from .. import configs
from .._device import resolve_device
from ..configs.base import RunConfig
from ..data import DataConfig, Pipeline
from ..models import init_params
from ..train import Trainer, make_train_step


def setup(device, ckpt_dir: str, checkpoint_every: int = 50):
    """(cfg, run_cfg, pipe, init_fn, step_fn, opt_init) of the example's
    run, checkpointing to ``ckpt_dir``."""
    cfg = configs.get_smoke("stablelm-3b", d_model=128, n_layers=4, d_ff=256)
    run_cfg = RunConfig(
        learning_rate=3e-3, warmup_steps=20,
        checkpoint_every=checkpoint_every, checkpoint_dir=ckpt_dir, keep_checkpoints=2,
    )
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=8, seed=0))
    step_fn, opt_init = make_train_step(cfg, run_cfg, device=device)

    def init_fn():
        return init_params(cfg, torch.Generator(device).manual_seed(0), device=device)

    return cfg, run_cfg, pipe, init_fn, step_fn, opt_init


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=120)
    ap.add_argument("--fail-at", type=int, default=90)
    ap.add_argument("--resume-steps", type=int, default=80)
    ap.add_argument("--checkpoint-every", type=int, default=50)
    ap.add_argument("--ckpt-dir", default=None,
                    help="checkpoint directory, which must not exist yet: created, and "
                         "removed at the end (default: a fresh temporary directory)")
    args = ap.parse_args(argv)
    if args.ckpt_dir is not None and os.path.lexists(args.ckpt_dir):
        ap.error(f"--ckpt-dir {args.ckpt_dir} already exists; the example removes its "
                 "checkpoint directory at the end, so it only takes a new one")
    dev = resolve_device(args.device)

    ckpt_dir = args.ckpt_dir or tempfile.mkdtemp(prefix="repro_ckpt_")
    if args.ckpt_dir is not None:
        os.makedirs(ckpt_dir)
    try:
        cfg, run_cfg, pipe, init_fn, step_fn, opt_init = setup(dev, ckpt_dir,
                                                               args.checkpoint_every)
        print(f"training {cfg.name} ({cfg.param_count():,} params), ckpts -> {ckpt_dir}")
        trainer = Trainer.resume_or_init(cfg, run_cfg, pipe, init_fn, step_fn, opt_init,
                                         device=dev)

        # phase 1: run the steps, then simulate a pod loss at fail_at
        boom = {"armed": True}

        def fail_hook(step):
            if step == args.fail_at and boom["armed"]:
                boom["armed"] = False
                raise RuntimeError("simulated: pod 1 lost heartbeat")

        m1 = trainer.run(args.steps, fail_hook=fail_hook)
        print(f"phase 1 done at step {trainer.step}: loss {m1['loss']:.3f} "
              f"(survived 1 simulated failure, resumed from checkpoint)")

        # phase 2: a *new* Trainer (fresh process semantics) resumes seamlessly
        trainer2 = Trainer.resume_or_init(cfg, run_cfg, pipe, init_fn, step_fn, opt_init,
                                          device=dev)
        if trainer2.step != args.steps:
            raise AssertionError(f"resumed at step {trainer2.step}, not {args.steps}")
        resumed_at = trainer2.step
        m2 = trainer2.run(args.resume_steps)
        print(f"phase 2 (restart) done at step {trainer2.step}: loss {m2['loss']:.3f}")
    finally:
        shutil.rmtree(ckpt_dir, ignore_errors=True)
    return {"phase1_step": trainer.step, "phase1_loss": m1["loss"],
            "failures_survived": int(not boom["armed"]), "resumed_at": resumed_at,
            "phase2_step": trainer2.step, "phase2_loss": m2["loss"],
            "phase1_params": trainer.params, "device": str(dev)}


if __name__ == "__main__":
    main()
