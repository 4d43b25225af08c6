"""Standalone RTL generation (paper §5.2): quantized model -> Verilog,
no HLS in the loop; the port of ``examples/rtl_codegen.py``.

    PYTHONPATH=src python -m repro_torch.examples.rtl_codegen [--device cuda|cpu] [--out FILE]

Host code but the muon tracker's initial draw (on the card one threefry
launch a dense layer).  The single CMVM comes from numpy's
``default_rng(3)`` as in the JAX example, so its modules are that
example's text.  The muon tracker's weights are
``init_params(PRNGKey(0), ...)``, the JAX example's parameters, so its
design and its ``dense0`` Verilog are that example's too;
``tracker_report`` compiles any parameter list.
"""

from __future__ import annotations

import argparse
import os
import tempfile

import numpy as np

from .._device import resolve_device
from ..core import emit_verilog, pipeline, solve_cmvm
from ..core.fixed_point import QInterval
from ..flow import CompileConfig, SolverConfig
from ..nn import compile_model, init_params, models
from ..random import PRNGKey


def tracker_report(params, device) -> dict:
    """Compile the muon tracker (binary inputs, ``d_in=32``) with
    ``params`` and print its DA design's resource report and the head of
    the first dense layer's Verilog.  Returns the design and both texts."""
    model, in_shape, in_quant = models.muon_tracker(d_in=32)
    design = compile_model(
        model, params, in_shape, in_quant, device=device,
        config=CompileConfig(strategy="da", solver=SolverConfig(dc=2)),
    )
    print("\nmuon tracker (binary inputs) DA design:")
    summary = design.summary()
    print(summary)
    print("\nper-layer Verilog emission of the first dense layer:")
    first = solve_cmvm(
        np.round(params[0]["w"].cpu().numpy() / model[0].w_quant.step).astype(np.int64),
        qint_in=[in_quant.qint] * in_shape[0],
        config=SolverConfig(dc=2),
    )
    v = emit_verilog(first.program, "dense0")
    print("\n".join(v.splitlines()[:5]) + "\n...")
    return {"design": design, "summary": summary, "dense0": v}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    ap.add_argument("--out", default=os.path.join(tempfile.gettempdir(), "cmvm_piped.v"),
                    help="the pipelined module's file (default: cmvm_piped.v in the "
                         "temporary directory)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- single CMVM -> combinational + pipelined Verilog ---
    rng = np.random.default_rng(3)
    M = rng.integers(-32, 32, size=(8, 6))
    sol = solve_cmvm(
        M, qint_in=[QInterval.from_fixed(True, 8, 8)] * 8, config=SolverConfig(dc=2)
    )
    comb = emit_verilog(sol.program, "cmvm_comb", max_delay_per_stage=None)
    piped = emit_verilog(sol.program, "cmvm_piped", max_delay_per_stage=3)
    n_stages = pipeline(sol.program, 3).n_stages
    print(f"combinational module: {len(comb.splitlines())} lines")
    print(f"pipelined module:     {len(piped.splitlines())} lines, {n_stages} stages")
    with open(args.out, "w") as f:
        f.write(piped)
    print(f"wrote {args.out}")

    # --- whole-network resource report through the model compiler ---
    model, in_shape, _ = models.muon_tracker(d_in=32)
    params, _ = init_params(PRNGKey(0), model, in_shape, device=dev)
    rep = tracker_report(params, dev)
    design = rep["design"]
    return {"comb": comb, "piped": piped, "n_stages": n_stages, "out": args.out,
            "summary": rep["summary"], "dense0": rep["dense0"],
            "total_adders": design.total_adders, "total_cost_bits": design.total_cost_bits,
            "max_depth": design.max_depth, "latency_cycles": design.latency_cycles,
            "total_ff_bits": design.total_ff_bits, "device": str(dev)}


if __name__ == "__main__":
    main()
