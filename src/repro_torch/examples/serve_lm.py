"""Serve a small LM with batched requests (the paper's kind is real-time
inference, so the end-to-end path is a serving loop); the port of
``examples/serve_lm.py``.

    PYTHONPATH=src python -m repro_torch.examples.serve_lm [--arch smollm-135m] [--device cuda|cpu]

Briefly trains a reduced same-family model on the deterministic Markov
pipeline so generation is non-trivial (``train``), then serves
mixed-length batched requests through the slot-based engine: prefill,
then decode with a preallocated cache, on the card through a captured
CUDA graph (``serve``).  On the card attention runs the hand-written
flash kernels, forward and backward (a Mamba model: the selective-scan
kernels).  The step updates the parameters in place.  The weights are
the JAX example's: ``init_params(cfg, PRNGKey(0))`` draws what its
``jax.random`` key draws (on the card, the threefry kernel); ``serve``
takes any parameter tree, the JAX package's carried across with
``models.params_from_numpy`` included.
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from .. import configs
from .._device import resolve_device
from ..configs.base import RunConfig
from ..data import DataConfig, Pipeline
from ..models import init_params
from ..random import PRNGKey
from ..serve import Engine, Request
from ..train import make_train_step


def config(arch: str):
    """The reduced same-family model of ``arch`` the example trains and serves."""
    return configs.get_smoke(arch, d_model=128, n_layers=4, d_ff=256)


def data(cfg) -> Pipeline:
    """The example's deterministic Markov pipeline: training batches, and
    the prompts (batches 1000-1003)."""
    return Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=16, seed=7))


def train(cfg, params, pipe, device, steps: int) -> tuple[dict, list[float]]:
    """``steps`` AdamW steps on ``pipe``'s batches; returns the parameters
    (updated in place) and each step's loss."""
    step_fn, opt_init = make_train_step(
        cfg, RunConfig(learning_rate=3e-3, warmup_steps=10), device=device)
    opt = opt_init(params)
    losses = []
    for s in range(steps):
        batch = {k: torch.from_numpy(v).to(device) for k, v in pipe.batch_at(s).items()}
        params, opt, m = step_fn(params, opt, batch, s)
        losses.append(float(m["loss"]))
        if s % 20 == 0:
            print(f"  warmup-train step {s}: loss {losses[-1]:.3f}")
    return params, losses


def serve(cfg, params, pipe, device) -> dict:
    """Serve four requests of 16-token prompts and 8, 12, 16 and 20 new
    tokens, greedily, in one batch; returns the prompts, the served
    requests and the wall time."""
    engine = Engine(cfg, params, batch_size=4, max_seq=96, eos_id=-1, sample="greedy",
                    device=device)
    prompts = [pipe.batch_at(1000 + i)["tokens"][0, :16] for i in range(4)]
    reqs = [Request(np.asarray(p, np.int32), max_new_tokens=8 + 4 * i)
            for i, p in enumerate(prompts)]

    t0 = time.time()
    out = engine.generate(reqs)
    dt = time.time() - t0
    n_tok = sum(len(r.out_tokens) for r in out)
    print(f"\nserved {len(out)} requests, {n_tok} tokens in {dt:.2f}s ({n_tok/dt:.1f} tok/s)")
    for i, r in enumerate(out):
        print(f"  req{i}: prompt {list(np.asarray(prompts[i])[:6])}... -> {r.out_tokens}")
    return {"prompts": prompts, "requests": out, "serve_s": dt, "tokens": n_tok,
            "tokens_per_s": n_tok / dt}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m")
    ap.add_argument("--train-steps", type=int, default=60)
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    cfg = config(args.arch)
    print(f"serving {cfg.name}: {cfg.param_count():,} params")

    params = init_params(cfg, PRNGKey(0), device=dev)
    pipe = data(cfg)
    t0 = time.perf_counter()
    params, losses = train(cfg, params, pipe, dev, args.train_steps)
    train_s = time.perf_counter() - t0
    out = serve(cfg, params, pipe, dev)
    return {"arch": cfg.name, "config": cfg, "params": params, "losses": losses,
            "train_s": train_s, "tokens_out": [r.out_tokens for r in out["requests"]],
            **{k: out[k] for k in ("serve_s", "tokens", "tokens_per_s")}, "device": str(dev)}


if __name__ == "__main__":
    main()
