"""Quickstart: optimize one CMVM with da4ml and inspect everything; the
port of ``examples/quickstart.py``.

    PYTHONPATH=src python -m repro_torch.examples.quickstart [--device cuda|cpu]

Covers the full core API: solve, verify bit-exactness, compare against
the hls4ml latency-strategy baseline, execute through the adder-graph
executor (on the card the hand-written CUDA kernel, on the CPU its plain
PyTorch version), pipeline, and emit synthesizable Verilog.  The matrix
and inputs come from numpy's ``default_rng(42)``, as in the JAX example,
so every figure but the solve time equals that example's.
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from .._device import resolve_device
from ..core import emit_verilog, naive_adder_tree, pipeline, solve_cmvm
from ..flow import SolverConfig
from ..kernels.adder_graph import adder_graph_apply, compile_tables

ROUTES = {"cuda": "CUDA adder-graph kernel", "cpu": "plain PyTorch version"}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda (the default) or cpu")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # --- a random 16x16 8-bit constant matrix (paper Table 2 convention) ---
    rng = np.random.default_rng(42)
    M = rng.integers(2**7 + 1, 2**8, size=(16, 16))

    baseline = naive_adder_tree(M)
    # delay constraint: 2 extra adder levels
    sol = solve_cmvm(M, config=SolverConfig(dc=2))

    print(f"matrix 16x16, 8-bit  |  baseline adders: {baseline.n_adders}")
    print(
        f"da4ml (dc=2): {sol.n_adders} adders "
        f"({1 - sol.n_adders / baseline.n_adders:.0%} fewer), "
        f"depth {sol.depth}, LUT-bit estimate {sol.cost_bits}, "
        f"solved in {sol.solver_time_s*1e3:.1f} ms"
    )

    # --- bit-exactness: the adder graph computes x @ M exactly ---
    if not sol.verify():
        raise AssertionError("never happens: full numerical precision is guaranteed")
    x = rng.integers(-128, 128, size=(8, 16))
    np.testing.assert_array_equal(sol.evaluate(x), x @ M)
    print("bit-exact vs x @ M: OK")

    # --- execute through the levelized adder-graph executor ---
    tables = compile_tables(sol.program)
    y = adder_graph_apply(tables, torch.from_numpy(x.astype(np.int32)).to(dev))
    np.testing.assert_array_equal(y.cpu().numpy(), x @ M)
    route = ROUTES[dev.type]
    print(f"{route} on {dev}: OK")

    # --- pipelining + RTL ---
    rep = pipeline(sol.program, max_delay_per_stage=5)
    print(f"pipelined: {rep.n_stages} stages, {rep.ff_bits} FF bits, II=1")
    verilog = emit_verilog(sol.program, module_name="cmvm16", max_delay_per_stage=5)
    print(f"Verilog: {len(verilog.splitlines())} lines; first 3:")
    print("\n".join(verilog.splitlines()[:3]))
    return {"baseline_adders": baseline.n_adders, "adders": sol.n_adders, "depth": sol.depth,
            "cost_bits": sol.cost_bits, "solve_ms": sol.solver_time_s * 1e3, "route": route,
            "n_stages": rep.n_stages, "ff_bits": rep.ff_bits,
            "verilog_lines": len(verilog.splitlines()), "device": str(dev)}


if __name__ == "__main__":
    main()
