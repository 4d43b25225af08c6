#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            (from the repository root)

Builds every CUDA kernel of the port from the sources in the checkout,
then runs five phases, each of which must pass:

1. probe    the card (``nvidia-smi`` name and power limit), CUDA and nvcc
            versions, ptxas resource usage of each kernel, and that
            PyTorch's int32 shifts and wraparound on the card match XLA's;
2. kernels  the adder-graph kernel against its plain PyTorch version on
            the card and against ``DAISProgram.evaluate`` (int64, reduced
            mod 2^32), exactly, on random programs (operand shifts 0-31,
            output shifts -40..40, no ops, masked outputs) and on the 10
            tables of the committed 64-particle Mixer, at batches 1, 7,
            256, 1000 and 4097;
3. designs  the committed Mixer and SVHN artifacts, loaded onto the card,
            reproduce their JAX golden outputs bit for bit, with exactly
            one kernel launch per CMVM step;
4. serve    the main path, as a user drives it: ``load_design`` ->
            ``ServeEngine(ServeConfig(max_batch=256, shards=2))`` ->
            ``register`` -> ``submit_batch`` of 4096 requests -> results
            and ``stats``.  Launch counts are zeroed just before and read
            just after; every future must resolve to the golden output;
5. times    per Mixer table, at the shapes one forward at 256 and at 4096
            samples gives it: the kernel, held exactly against its plain
            version and the library yardstick (one float64
            ``torch.matmul`` by the table's dense matrix, which the port
            never calls) on those inputs, then the three timed with CUDA
            events, beside the table's bound.

The line before the last is the ``kernels`` JSON object; the last line
is ``{"ok": true, "device": {...}}``.  Without a CUDA card, or without
the rest of the repository beside it, the script fails before printing
any result.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ASSETS = ROOT / "src" / "repro_torch" / "assets"
BATCHES = (1, 7, 256, 1000, 4097)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
INT32_LANES_PER_SM = 64  # Hopper SM: 64 INT32 lanes per clock (architecture white paper)


class SmokeFailure(RuntimeError):
    pass


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SmokeFailure(msg)


def log(*args) -> None:
    print(*args, flush=True)


# ----------------------------------------------------------------------
# 1. probe
# ----------------------------------------------------------------------
def probe(torch) -> dict:
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    log(smi)
    clocks = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm,clocks.sm,power.draw,temperature.gpu",
         "--format=csv,noheader,nounits"],
        capture_output=True, text=True, check=True,
    ).stdout.strip().splitlines()[0]
    max_sm_mhz = float(clocks.split(",")[0])
    from repro_torch.kernels import _build

    nvcc = _build._nvcc()
    nvcc_version = subprocess.run(
        [nvcc, "--version"], capture_output=True, text=True, check=True
    ).stdout.strip().splitlines()[-1]
    props = torch.cuda.get_device_properties(0)
    log(f"torch {torch.__version__} cuda {torch.version.cuda}; {nvcc_version}")
    log(f"clocks.max.sm, clocks.sm, power.draw, temperature: {clocks}; SMs {props.multi_processor_count}")
    t0 = time.perf_counter()
    paths = _build.build_all()
    log(f"built {sorted(paths)} in {time.perf_counter() - t0:.2f} s")
    ptxas = {}
    for name, src in _build.sources().items():
        out = _build.BUILD_DIR / f"{name}.ptxas.o"
        res = subprocess.run(
            [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
             "-Xptxas", "-v", "-c", "-o", str(out), str(src)],
            capture_output=True, text=True, check=True,
        )
        out.unlink(missing_ok=True)
        ptxas[name] = [ln.strip() for ln in res.stderr.splitlines() if "ptxas info" in ln]
        for ln in ptxas[name]:
            log(f"  {name}: {ln}")
    return {
        "nvidia_smi": smi,
        "clocks": clocks,
        "torch": torch.__version__,
        "cuda": torch.version.cuda,
        "nvcc": nvcc_version,
        "sms": props.multi_processor_count,
        "int32_ops_per_s": props.multi_processor_count * INT32_LANES_PER_SM * max_sm_mhz * 1e6,
        "ptxas": ptxas,
    }


def check_torch_int_semantics(torch, dev) -> None:
    """The glue steps (requant, residual, pool) rely on PyTorch's int32
    shifts and wraparound matching XLA's on the card."""
    import numpy as np

    v = torch.tensor([5, -5, 2**31 - 1, -(2**31)], dtype=torch.int32, device=dev)
    s32 = torch.full_like(v, 32)
    s40 = torch.full_like(v, 40)
    got = {
        "shl32": (v << s32).cpu().numpy(),
        "shr40": (v >> s40).cpu().numpy(),
        "add": (v + v).cpu().numpy(),
        "mul": (v * torch.full_like(v, -1)).cpu().numpy(),
        "sum": v.reshape(1, 4).sum(dim=1, dtype=torch.int32).cpu().numpy(),
    }
    wrap = lambda a: np.asarray(a, np.int64).astype(np.int32)  # noqa: E731
    want = {
        "shl32": np.zeros(4, np.int32),
        "shr40": np.array([0, -1, 0, -1], np.int32),
        "add": wrap([10, -10, 2**32 - 2, -(2**32)]),
        "mul": wrap([-5, 5, -(2**31) + 1, 2**31]),
        "sum": wrap([5 - 5 + 2**31 - 1 - 2**31]),
    }
    for k in want:
        check(np.array_equal(got[k], want[k]), f"torch int32 {k} on the card: {got[k]} != {want[k]}")
    log("torch int32 shifts >= 32, wraparound and int32 sums match XLA's on the card")


# ----------------------------------------------------------------------
# 2. kernel vs plain version vs evaluate
# ----------------------------------------------------------------------
def random_program(rng, n_in, n_ops, n_out, max_shift, out_shifts, p_mask, p_neg):
    from repro_torch.core import DAISProgram, QInterval, Term

    prog = DAISProgram()
    for _ in range(n_in):
        prog.add_input(QInterval(-128, 127, 0))
    for _ in range(n_ops):
        n = len(prog.rows)
        if rng.random() < p_neg:
            prog.add_neg(int(rng.integers(n)))
            continue
        a, b = (int(i) for i in rng.integers(n, size=2))
        sh = int(rng.integers(0, max_shift + 1))
        sh_a, sh_b = (sh, 0) if rng.random() < 0.5 else (0, sh)
        prog.add_op(a, b, sh_a, sh_b, int(rng.choice([-1, 1])))
    lim = 1 << 31
    for _ in range(n_out):
        if rng.random() < p_mask:
            prog.outputs.append(None)
            continue
        row = int(rng.integers(len(prog.rows)))
        shift = int(rng.integers(out_shifts[0], out_shifts[1] + 1))
        q = prog.rows[row].qint
        # a right shift only commutes with the int32 wrap when the exact
        # value fits int32: elsewhere use the left shift, so evaluate()
        # mod 2^32 stays an exact oracle
        if shift < 0 and not (-lim <= q.lo << q.exp and q.hi << q.exp < lim):
            shift = -shift
        prog.outputs.append(Term(int(rng.choice([-1, 1])), row, shift))
    return prog


def kernel_cases(torch, np, dev, mixer):
    from repro_torch.core import DAISProgram
    from repro_torch.kernels.adder_graph import compile_tables
    from repro_torch.kernels.adder_graph.kernel import adder_graph_cuda
    from repro_torch.kernels.adder_graph.ref import adder_graph_ref

    rng = np.random.default_rng(0)
    progs = {
        "shifts_0_31_out_-40_40": random_program(rng, 24, 400, 48, 31, (-40, 40), 0.1, 0.05),
        "no_ops": random_program(rng, 16, 0, 24, 0, (-40, 40), 0.25, 0.0),
        "masked": random_program(rng, 32, 200, 40, 3, (0, 2), 0.5, 0.05),
    }
    for i, parr in enumerate(mixer.programs):
        progs[f"mixer_table{i}"] = DAISProgram.from_arrays(parr)
    max_err = 0
    n_cases = 0
    for name, prog in progs.items():
        tables = compile_tables(prog)
        qs = [r.qint for r in prog.rows[: prog.n_inputs]]
        lo = np.array([q.lo for q in qs])
        hi = np.array([q.hi for q in qs])
        for batch in BATCHES:
            x = rng.integers(lo, hi + 1, size=(batch, prog.n_inputs)).astype(np.int32)
            xd = torch.from_numpy(x).to(dev)
            got = adder_graph_cuda(tables, xd).cpu().numpy()
            plain = adder_graph_ref(tables, xd).cpu().numpy()
            want = prog.evaluate(x).astype(np.int32)  # int64 reduced mod 2^32
            err = int(np.abs(got.astype(np.int64) - plain.astype(np.int64)).max(initial=0))
            max_err = max(max_err, err)
            check(np.array_equal(got, plain), f"kernel != plain version on {name}, batch {batch}")
            check(np.array_equal(got, want), f"kernel != evaluate on {name}, batch {batch}")
            n_cases += 1
        log(f"  {name}: n_in {tables.n_inputs} n_ops {tables.n_ops} "
            f"levels {len(tables.level_bounds)} n_out {tables.n_outputs}: exact at batches {BATCHES}")
    return max_err, n_cases


# ----------------------------------------------------------------------
# 5. times
# ----------------------------------------------------------------------
def time_ms(torch, fn, iters: int = 50) -> float:
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def capture_cmvm_inputs(torch, design, x):
    """The (tables, x) of every adder-graph call one forward makes: the
    shapes and values the main path gives the kernel."""
    from repro_torch.nn import compiler

    seen = []
    orig = compiler.adder_graph_apply

    def record(tables, v):
        seen.append((tables, v.reshape(-1, v.shape[-1]).to(torch.int32).contiguous()))
        return orig(tables, v)

    compiler.adder_graph_apply = record
    try:
        design.forward_int(x)
    finally:
        compiler.adder_graph_apply = orig
    return seen


def int32_ops_per_row(np, tables) -> int:
    """The int32 operations one row of ``tables`` needs: per adder one
    add or subtract (the sign is +-1) and one shift per nonzero operand
    shift; per unmasked output one shift if its shift is nonzero and one
    negation if its sign is -1.  Masked outputs are constant zeros."""
    instr, outs = tables.instr, tables.outs
    live = outs[:, 3] != 0
    return int(
        tables.n_ops
        + np.count_nonzero(instr[:, 2]) + np.count_nonzero(instr[:, 3])
        + np.count_nonzero(outs[live, 1]) + np.count_nonzero(outs[live, 2] < 0)
    )


def table_times(torch, np, design, x, info) -> tuple[list[dict], int]:
    from repro_torch.core import DAISProgram
    from repro_torch.kernels.adder_graph.kernel import adder_graph_cuda
    from repro_torch.kernels.adder_graph.ref import adder_graph_ref

    index = {t.digest: i for i, t in enumerate(design.tables)}
    rows = []
    max_err = 0
    for tables, xt in capture_cmvm_inputs(torch, design, x):
        i = index[tables.digest]
        prog = DAISProgram.from_arrays(design.programs[i])
        m = prog.evaluate(np.eye(tables.n_inputs, dtype=np.int64))
        md = torch.from_numpy(m.astype(np.float64)).to(xt.device)
        xf = xt.to(torch.float64)
        got = adder_graph_cuda(tables, xt)
        plain = adder_graph_ref(tables, xt)
        max_err = max(max_err, int((got.to(torch.int64) - plain.to(torch.int64)).abs().max()))
        check(torch.equal(got, plain), f"table {i}, {xt.shape[0]} rows: kernel != plain version")
        check(torch.equal(torch.matmul(xf, md).to(torch.int32), got),
              f"table {i}, {xt.shape[0]} rows: kernel != float64 matmul yardstick")
        del got, plain
        k_ms = time_ms(torch, lambda t=tables, v=xt: adder_graph_cuda(t, v))
        p_ms = time_ms(torch, lambda t=tables, v=xt: adder_graph_ref(t, v))
        l_ms = time_ms(torch, lambda a=xf, b=md: torch.matmul(a, b))
        dev = tables.device_arrays(xt.device)
        n = xt.shape[0]
        nbytes = 4 * n * (tables.n_inputs + tables.n_outputs) + sum(
            a.numel() * 4 for a in dev)
        ops = n * int32_ops_per_row(np, tables)
        rows.append({
            "table": i, "rows": n, "n_in": tables.n_inputs, "n_ops": tables.n_ops,
            "levels": len(tables.level_bounds), "n_out": tables.n_outputs,
            "kernel_ms": k_ms, "plain_ms": p_ms, "library_ms": l_ms,
            "bytes": nbytes, "int32_ops": ops,
            "bytes_ms": nbytes / HBM_BYTES_PER_S * 1e3,
            "ops_ms": ops / info["int32_ops_per_s"] * 1e3,
        })
    return rows, max_err


def forward_breakdown(torch, design, x) -> dict:
    """One forward of the design: its time per call (CUDA events, back to
    back) and, from the profiler's trace, the device time of the
    adder-graph kernel and of all kernels (None where the trace shows no
    device time)."""
    from torch.profiler import ProfilerActivity, profile

    fwd_ms = time_ms(torch, lambda: design.forward_int(x), iters=20)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        design.forward_int(x)
        torch.cuda.synchronize()
    kernel_us = all_us = 0.0
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue  # host-side ops; their kernels are listed on their own
        us = getattr(ev, "self_device_time_total", 0.0) or 0.0
        all_us += us
        if "adder_graph_kernel" in ev.key:
            kernel_us += us
    return {
        "forward_ms": fwd_ms,
        "profiler_kernel_ms": kernel_us / 1e3 if kernel_us > 0 else None,
        "profiler_all_kernels_ms": all_us / 1e3 if all_us > 0 else None,
    }


# ----------------------------------------------------------------------
def main() -> int:
    import numpy as np
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device is available", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.flow import ServeConfig
    from repro_torch.kernels.adder_graph import kernel as ag_kernel
    from repro_torch.nn.compiler import count_cmvm_steps
    from repro_torch.runtime import ServeEngine, load_design

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)

    log("== 1. probe")
    info = probe(torch)
    check_torch_int_semantics(torch, dev)

    log("== 2. kernel vs plain version vs DAISProgram.evaluate")
    mixer_path = ASSETS / "mixer_full"
    mixer = load_design(mixer_path, device=dev)
    max_err, n_cases = kernel_cases(torch, np, dev, mixer)
    log(f"{n_cases} cases exact; max |kernel - plain| = {max_err}")

    log("== 3. committed designs on the card")
    golden = {}
    for name in ("mixer_full", "svhn_cnn"):
        design = mixer if name == "mixer_full" else load_design(ASSETS / name, device=dev)
        g = np.load(ASSETS / name / "golden.npz")
        golden[name] = (g["x"].astype(np.int32), g["y"])
        n_cmvm = count_cmvm_steps(design.step_specs)
        before = ag_kernel.launches.value
        y = design.forward_int(torch.from_numpy(golden[name][0]).to(dev)).cpu().numpy()
        launched = ag_kernel.launches.value - before
        check(np.array_equal(y, golden[name][1]), f"{name}: forward_int on the card != JAX golden")
        check(launched == n_cmvm, f"{name}: {launched} kernel launches, {n_cmvm} CMVM steps")
        log(f"{name}: {len(y)} golden outputs bit-exact on the card; "
            f"{launched} launches = {n_cmvm} CMVM steps")

    log("== 4. serve (main path)")
    x_gold, y_gold = golden["mixer_full"]
    reps = 4
    cfg = ServeConfig(max_batch=256, shards=2)
    ag_kernel.launches.reset()
    t0 = time.perf_counter()
    served = load_design(mixer_path)
    with ServeEngine(cfg) as eng:
        eng.register("mixer", served, warmup=True)
        t_reg = time.perf_counter()
        futs = eng.submit_batch("mixer", np.concatenate([x_gold] * reps))
        outs = [f.result(120) for f in futs]
        t_done = time.perf_counter()
        stats = eng.stats("mixer")
        main_launches = ag_kernel.launches.value
    got = np.stack(outs)
    check(np.array_equal(got, np.concatenate([y_gold] * reps)), "served outputs != JAX golden")
    check(stats["n_fallback_batches"] == 0, "fallback batches")
    check(stats["breaker"]["n_trips"] == 0, "the circuit breaker opened")
    check(stats["supervision"]["n_crashes"] == 0, "a dispatch shard crashed")
    n_steps = count_cmvm_steps(served.step_specs)
    want_launches = (stats["n_batches"] + len(stats["buckets"])) * n_steps
    check(main_launches == want_launches,
          f"{main_launches} launches on the main path, expected {want_launches}")
    rps = len(futs) / (t_done - t_reg)
    log(f"serve: {len(futs)} requests bit-exact; {rps:.0f} req/s, p50 {stats['p50_ms']:.3f} ms, "
        f"p99 {stats['p99_ms']:.3f} ms, {stats['n_batches']} batches, {main_launches} launches; "
        f"load + register + warm-up {t_reg - t0:.2f} s")
    log("serve stages: " + json.dumps(stats["per_stage"]))

    log("== 5. times (CUDA events; per call, back to back)")
    timings = {}
    for batch in (256, 4096):
        xb = torch.from_numpy(np.concatenate([x_gold] * (batch // 1024 or 1))[:batch]).to(dev)
        rows, err = table_times(torch, np, mixer, xb, info)
        max_err = max(max_err, err)
        timings[batch] = {"tables": rows, **forward_breakdown(torch, mixer, xb)}
        for r in rows:
            log(json.dumps({"batch": batch, **r}))
        log(f"batch {batch}: one forward " + json.dumps(
            {k: v for k, v in timings[batch].items() if k != "tables"}))

    fwd = timings[256]["tables"]
    nbytes = sum(r["bytes"] for r in fwd)
    ops = sum(r["int32_ops"] for r in fwd)
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    ops_ms = ops / info["int32_ops_per_s"] * 1e3
    kernels = {"kernels": [{
        "name": "adder_graph",
        "route": "cuda",
        "source": "src/repro_torch/kernels/adder_graph/csrc/adder_graph.cu",
        "replaces": "src/repro/kernels/adder_graph/kernel.py:31",
        "launches": main_launches,
        "max_abs_err": max_err,
        "ms": sum(r["kernel_ms"] for r in fwd),
        "kernel_ms": sum(r["kernel_ms"] for r in fwd),
        "plain_ms": sum(r["plain_ms"] for r in fwd),
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "library_ms": sum(r["library_ms"] for r in fwd),
        "shape": "one forward of the 64-particle Mixer at 256 samples: its 10 CMVM calls",
    }]}
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(info["nvidia_smi"])
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
