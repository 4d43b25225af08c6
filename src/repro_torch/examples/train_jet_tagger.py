"""End-to-end QAT -> da4ml deployment, the paper's headline workflow, on
one device: the port of ``examples/train_jet_tagger.py``.

    PYTHONPATH=src python -m repro_torch.examples.train_jet_tagger [--device cuda] [--steps 300]

Trains the high-level-feature jet tagger (16 -> 64 -> 32 -> 16 -> 16 -> 5,
paper §6.2.1) with HGQ-style quantization-aware training (the STE
``fake_quant`` and the ``collect_bits`` bit-count penalty) on a
synthetic 5-class task by plain SGD, compiles it to adder-graph designs
with both strategies, checks that the deployed integer pipeline equals
the trained float model bit for bit (float64 ``apply_model`` against the
design's ``forward``), and serves it through ``ServeEngine``: on the card
every CMVM step runs on the adder-graph kernel.  The keys follow the
JAX example's: ``PRNGKey(seed)`` (``--seed``, 0 by default, the
example's key) draws the initial weights and is then split once a step;
the data come from ``PRNGKey(1)`` (the class centres) and each step's
key (``make_batch``), the evaluation batch from ``PRNGKey(99)``.  So the
weights and batches are the JAX example's, drawn on the device by the
threefry kernel (on the CPU by its plain version).
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch
import torch.nn.functional as F

from .._device import resolve_device
from ..flow import CompileConfig, ServeConfig, SolverConfig
from ..nn import apply_model, compile_model, init_params, models, to_grid_int
from ..random import PRNGKey, normal, randint, split
from ..runtime import ServeEngine
from ..tree import tree_leaves

N_CLASSES, N_FEATURES = 5, 16


def class_centres(device) -> torch.Tensor:
    """The synthetic task's class centres: ``kd, kw = split(PRNGKey(1))``,
    ``normal(kw, (5, 16)) * 2.0``, as the JAX example draws them."""
    _, kw = split(PRNGKey(1))
    return normal(kw, (N_CLASSES, N_FEATURES), device=device) * 2.0


def make_batch(centres: torch.Tensor, key, n: int = 512):
    """(x [n, 16], y [n]) of key ``key``, as the JAX example's
    ``make_batch(k, n)``: ``ky, kx = split(k)``, labels ``randint(ky, (n,),
    0, 5)``, features the label's centre plus ``normal(kx, (n, 16))``."""
    ky, kx = split(key)
    y = randint(ky, (n,), 0, N_CLASSES, device=centres.device).long()
    return centres[y] + normal(kx, (n, N_FEATURES), device=centres.device), y


def sgd_step(params, model, in_quant, centres, key, lr: float) -> torch.Tensor:
    """One step of the JAX example's ``step(params, k, lr)``: the batch of
    ``key``, the QAT loss (the NLL plus 1e-5 times the bit count) and plain
    SGD on ``params`` in place.  Returns the batch's NLL."""
    leaves = tree_leaves(params)
    x, y = make_batch(centres, key)
    logits, bits = apply_model(params, model, x, in_quant=in_quant, collect_bits=True)
    nll = F.cross_entropy(logits, y)
    loss = nll + 1e-5 * bits  # HGQ-style bit-count regularizer
    grads = torch.autograd.grad(loss, leaves)
    with torch.no_grad():
        for p, g in zip(leaves, grads):
            p.sub_(lr * g)
    return nll.detach()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--steps", type=int, default=300)
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    model, in_shape, in_quant = models.jet_tagger(w_bits=6, a_bits=8)
    key = PRNGKey(args.seed)
    params, _ = init_params(key, model, in_shape, device=dev)
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)

    # synthetic 5-class jet dataset: gaussian clusters + noise
    centres = class_centres(dev)

    t0 = time.perf_counter()
    for i in range(args.steps):
        key, sub = split(key)
        nll = sgd_step(params, model, in_quant, centres, sub, 0.02)
        if i % 100 == 0:
            print(f"step {i:4d}  nll {float(nll):.3f}")
    for p in leaves:
        p.requires_grad_(False)
    x, y = make_batch(centres, PRNGKey(99), 2048)
    acc = float((apply_model(params, model, x, in_quant=in_quant).argmax(-1) == y).float().mean())
    train_s = time.perf_counter() - t0
    print(f"trained {args.steps} steps in {train_s:.1f}s, accuracy {acc:.1%}")

    # --- deploy: compile to adder graphs, compare strategies ---
    adders = {}
    for strategy in ("latency", "da"):
        design = compile_model(model, params, in_shape, in_quant, device=dev,
                               config=CompileConfig(strategy=strategy,
                                                    solver=SolverConfig(dc=2)))
        adders[strategy] = sum(r.adders for r in design.reports)
        print(f"\n=== strategy={strategy} ===")
        print(design.summary())

    # --- bit-exactness of the deployed design (float64 reference) ---
    t1 = time.perf_counter()
    design = compile_model(model, params, in_shape, in_quant, device=dev)
    compile_s = time.perf_counter() - t1
    x64 = x[:64].double()
    want = apply_model(params, model, x64, in_quant=in_quant)
    got = design.forward(x64).double()
    if not torch.equal(got, want):
        raise AssertionError("the compiled design differs from the trained float model")
    print("\ncompiled integer design == trained float model (bit-exact): OK")

    # --- serve the design: every CMVM step on the adder-graph kernel ---
    x_int = to_grid_int(x, in_quant)
    with ServeEngine(ServeConfig(max_batch=256, shards=1), device=dev) as eng:
        eng.register("jet", design)
        t2 = time.perf_counter()
        served = np.stack([f.result(120) for f in eng.submit_batch("jet", x_int.cpu().numpy())])
        serve_s = time.perf_counter() - t2
    direct = design.forward_int(x_int).cpu().numpy()
    if not np.array_equal(served, direct):
        raise AssertionError("the served outputs differ from forward_int")
    acc_hw = float((served.argmax(-1) == y.cpu().numpy()).mean())
    print(f"hardware-design accuracy: {acc_hw:.1%}; served {len(served)} requests in "
          f"{serve_s:.3f}s on {dev}")
    return {"steps": args.steps, "accuracy": acc, "hw_accuracy": acc_hw, "train_s": train_s,
            "compile_s": compile_s, "serve_s": serve_s, "requests": len(served),
            "adders": adders, "device": str(dev)}


if __name__ == "__main__":
    main()
