"""Two checks behind findings about the parameter draw, each run on its own.

    python tools/prng_diagnostics.py falcon-steps [--steps 30]    (on a CUDA card)
    python tools/prng_diagnostics.py cpu-sqrt [--runs 30]         (on the CPU)

``falcon-steps`` runs chip_smoke phase 24's training setup --
falcon-mamba-7b cut to 8 layers, bf16 with an f32 master and int8
moments, lr 3e-3 after the default warm-up, ``Pipeline`` batches of 8 x
128, parameters ``init_params(cfg, PRNGKey(0))`` -- twice: on the kernel
path and with the selective scan swapped for its plain version.  For each
it prints one JSON line: the loss of batches 0-9 at the initial
parameters, the loss of every step, and the loss of batches 0-9 after the
last step.  It shows how far ten warm-up steps move the loss against how
far the batches differ.

``cpu-sqrt`` starts ``--runs`` fresh processes; each draws the
smollm-135m smoke config's parameters on the CPU, with the plain draw's
square root taken by ``torch.sqrt`` and by ``sqrt32``, as the first work
of the process.  It prints, for each way, how many processes gave an
embedding other than a one-thread process's, and how many elements
differed at most.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT / "src"))


def falcon_steps(steps: int) -> None:
    import torch

    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.models import init_params, loss_fn
    from repro_torch.random import PRNGKey
    from repro_torch.train import make_train_step

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = dataclasses.replace(configs.get("falcon-mamba-7b"), n_layers=cs.FALCON_TRAIN_LAYERS)
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=cs.TRAIN_SEQ,
                               global_batch=cs.TRAIN_BATCH))
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(i).items()}
               for i in range(steps)]
    run_cfg = RunConfig(learning_rate=3e-3, state_dtype="int8", master_dtype="float32")

    def evals(params):
        with torch.no_grad():
            return [float(loss_fn(cfg, params, b)[0]) for b in batches[:10]]

    plain = cs.op_swaps(cs.lm_paths()["falcon-mamba-7b"], "plain")
    for label, swaps in (("kernel", []), ("plain", plain)):
        t0 = time.perf_counter()
        with cs.swapped(swaps):
            step, opt_init = make_train_step(cfg, run_cfg, device=dev)
            params = init_params(cfg, PRNGKey(0), device=dev)
            at_init = evals(params)
            opt = opt_init(params)
            losses = []
            for i in range(steps):
                params, opt, metrics = step(params, opt, batches[i], i)
                losses.append(float(metrics["loss"]))
            after = evals(params)
        print(json.dumps({"path": label, "card": torch.cuda.get_device_name(0), "s":
                          time.perf_counter() - t0, "at_init_batches_0_9": at_init,
                          "train_losses": losses, f"after_{steps}_steps_batches_0_9": after}),
              flush=True)
        del params, opt
        torch.cuda.empty_cache()


_CHILD = r"""
import sys, torch
sys.path.insert(0, sys.argv[1])
from repro_torch import configs, random as R
from repro_torch.kernels.prng import ref
from repro_torch.models import init_params
if sys.argv[3] == "torch.sqrt":
    ref.sqrt32 = torch.sqrt
p = init_params(configs.get_smoke("smollm-135m"), R.PRNGKey(0), device="cpu")
torch.save(p["embed"], sys.argv[2])
"""


def cpu_sqrt(runs: int) -> None:
    import torch

    env = dict(os.environ)
    with tempfile.TemporaryDirectory() as tmp:
        for way in ("torch.sqrt", "sqrt32"):
            ref_path = os.path.join(tmp, "ref.pt")
            subprocess.run([sys.executable, "-c", _CHILD, str(ROOT / "src"), ref_path, way],
                           env={**env, "OMP_NUM_THREADS": "1"}, check=True)
            want = torch.load(ref_path)
            differ = []
            for i in range(runs):
                path = os.path.join(tmp, f"{i}.pt")
                subprocess.run([sys.executable, "-c", _CHILD, str(ROOT / "src"), path, way],
                               env=env, check=True)
                n = int((torch.load(path) != want).sum())
                if n:
                    differ.append(n)
            print(json.dumps({"sqrt": way, "runs": runs, "threads": torch.get_num_threads(),
                              "runs_differing": len(differ), "elements_differing": differ}),
                  flush=True)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("check", choices=["falcon-steps", "cpu-sqrt"])
    ap.add_argument("--steps", type=int, default=30)
    ap.add_argument("--runs", type=int, default=30)
    args = ap.parse_args(argv)
    if args.check == "falcon-steps":
        falcon_steps(args.steps)
    else:
        cpu_sqrt(args.runs)


if __name__ == "__main__":
    main()
