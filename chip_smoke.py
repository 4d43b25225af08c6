#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            (from the repository root)

Builds every CUDA kernel of the port from the sources in the checkout,
then runs eleven phases, each of which must pass:

1. probe    the card (``nvidia-smi`` name and power limit), CUDA and nvcc
            versions, ptxas resource usage of each kernel, and that
            PyTorch's int32 shifts and wraparound on the card match XLA's;
2. kernels  the adder-graph kernel against its plain PyTorch version on
            the card and against ``DAISProgram.evaluate`` (int64, reduced
            mod 2^32), exactly, on random programs (operand shifts 0-31,
            output shifts -40..40, no ops, masked outputs), on one of
            60,032 live rows (past a block's shared memory: the
            global-scratch entry point) and on the 10 tables of the
            committed 64-particle Mixer (the shared-memory entry point),
            at batches 1, 7, 256, 1000 and 4097, printing each case's
            entry point and launch plan;
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
            never calls) on those inputs, then the three timed as device
            time per call (CUDA-graph replays), beside the table's bound
            and launch plan;
6. flash    the flash-attention kernel against its plain PyTorch version
            on the card: f32 and bf16, causal and full, MHA, GQA 4:1,
            MQA and smollm's 9:3, head_dim 16/32/64/128, ragged Sq and
            Sk, and decode (Sq=1) against a 512-slot cache at offsets 0,
            1, 127, 128 and 511 read from the card, at GQA group sizes 1,
            3, 4 and 8; max abs error per dtype against atol 2e-5 (f32)
            and 2e-2 (bf16), and how many cases each of the source's
            kernels (decode, tensor-core, CUDA-core) took;
7. lm       the reduced smollm-135m from the committed JAX weights
            (``assets/smollm_smoke``) served on the card reproduces the
            JAX engine's greedy tokens exactly and its prefill and first
            decode logits within 1e-4 (f32), with n_layers x (1 + decode
            steps) kernel launches;
8. serve    the LM main path at full width: smollm-135m (30 layers,
            d_model 576, 9:3 heads, vocab 49152, bf16) with the port's own
            random weights (seed 0; the repository ships no checkpoint)
            in ``Engine(batch_size=8, max_seq=512)`` serves 8 requests of
            128-token prompts and 64 new tokens.  Launch counts are zeroed
            just before and read just after (30 x 64 flash launches); the
            plain path, teacher-forced on the kernel path's tokens, agrees
            on the logits within 0.25 and on every argmax whose top-two gap
            is at least that; prefill and decode times, tokens/s and the
            profiler's device time of one decode step, which must not
            sync the host (``set_sync_debug_mode("error")``); then the kernel at
            the main path's prefill and decode inputs, held against its
            plain version and ``scaled_dot_product_attention`` (the
            library yardstick, which the port never calls), then the three
            timed as device time per call (CUDA-graph replays between CUDA
            events) beside the kernel's bound;
9. kernels  every kernel of the selective-scan source against its plain
            PyTorch version on the card (atol 1e-5): the decode kernel
            (S = 1) at every N from 1 to 16 with ragged channels (D 129),
            B 1 and 8, the state updated in place and B and C as strided
            views, and at falcon-mamba-7b's decode shapes; the prefill
            kernel at the ``tests/test_ssm_kernel.py`` shapes, S 2, 33 and
            128, ragged channels, N 1/4/5/8/13/16, falcon-mamba-7b's
            prefill, two halves chained through the state in place, B and C
            as strided views; and both kernels of the W8A8 source against
            their plain version, exactly: the TMA/wgmma kernel at aligned
            rows with ragged M and N tiles and at K = 4096 with sums past
            2^24, the mma.sync kernel at rows TMA cannot describe (K or N
            not a multiple of 16) and at a base 8 bytes off 16-byte
            alignment.  Each case prints the kernel it took, and each
            kernel must have run;
10. ssm     the reduced falcon-mamba from the committed JAX weights
            (``assets/falcon_mamba_smoke``) served on the card reproduces
            the JAX engine's greedy tokens exactly and its prefill and
            first decode logits within 1e-4 (f32), with n_layers x (1 +
            decode steps) scan launches;
11. serve   the SSM main path at full width: falcon-mamba-7b (64 Mamba-1
            layers, d_model 4096, d_inner 8192, state 16, vocab 65024,
            bf16, 7,272,140,800 parameters) with the port's own random
            weights (seed 0, drawn on the card) in ``Engine(batch_size=8,
            max_seq=512)`` serves 8 requests of 128-token prompts and 64
            new tokens, as phase 8 does, counted (64 x 64 scan launches, no
            other kernel: 64 on the prefill kernel, 64 x 63 on the decode
            kernel) and checked by phase 8's rule against the plain path;
            then the scan at the main path's layer-0 prefill and decode
            inputs against its plain version, timed by CUDA-graph replay
            beside its bound, each call on its own of 32 states (128 MB at
            decode, past the 50 MB L2, as the main path's 64 layers bring
            theirs from device memory) and, labelled L2-warm, on one state
            again and again; and the W8A8 matmul, run once through its
            public op (its only path, on the TMA kernel), held exactly
            against its plain version and ``torch._int_mm`` times the
            scales (the library yardstick, which the port never calls) at
            M 1024, K 4096, N 16384, the three timed beside its bound.

The line before the last is the ``kernels`` JSON object, with each
source's kernels under ``entry_points``; the last line is ``{"ok": true,
"device": {...}}``.  Without a CUDA card, or without the rest of the
repository beside it, the script fails before printing any result.
"""

from __future__ import annotations

import dataclasses
import itertools
import json
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
ASSETS = ROOT / "src" / "repro_torch" / "assets"
BATCHES = (1, 7, 256, 1000, 4097)
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
BF16_FLOPS_PER_S = 989e12  # H100 SXM data sheet, dense bf16 tensor cores
F32_FLOPS_PER_S = 67e12  # H100 SXM data sheet, float32 outside the tensor cores
FA_ATOL = {"float32": 2e-5, "bfloat16": 2e-2}
LM_F32_ATOL = 1e-4  # phase 7: float32 logits, the same arithmetic as JAX in another order
# phase 8: bf16 logits of the kernel path against the plain path.  The two
# round attention outputs to bf16 at different places (the decode kernel
# keeps p in f32), and 30 layers carry those differences to logits whose
# bf16 spacing is 1/32 at |x| in [4, 8): 0.25 is 8 such steps.
LM_BF16_ATOL = 0.25
INT32_LANES_PER_SM = 64  # Hopper SM: 64 INT32 lanes per clock (architecture white paper)
MUFU_PER_SM = 16  # Hopper SM: 16 special-function (exp2) results per clock
INT8_OPS_PER_S = 1979e12  # H100 SXM data sheet, dense int8 tensor cores
SCAN_ATOL = 1e-5  # the JAX selective-scan kernel tests' own
SCAN_STATES = 32  # distinct states per timed graph: 32 x 4 MB at falcon-mamba's decode


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
        "exp_per_s": props.multi_processor_count * MUFU_PER_SM * max_sm_mhz * 1e6,
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


def wide_program(rng, n_in, n_wide, n_out):
    """One level of ``n_wide`` ops over the inputs, read by the outputs:
    n_in + n_wide rows live at once, past a block's shared memory (the
    global-scratch entry point) for n_wide above 58,080."""
    from repro_torch.core import DAISProgram, QInterval, Term

    prog = DAISProgram()
    for _ in range(n_in):
        prog.add_input(QInterval(-128, 127, 0))
    for _ in range(n_wide):
        a, b = (int(i) for i in rng.integers(n_in, size=2))
        prog.add_op(a, b, int(rng.integers(0, 4)), int(rng.integers(0, 4)), int(rng.choice([-1, 1])))
    for _ in range(n_out):
        row = int(rng.integers(len(prog.rows)))
        prog.outputs.append(Term(int(rng.choice([-1, 1])), row, int(rng.integers(-4, 5))))
    return prog


def evaluate(np, prog, x, chunk: int = 1024):
    """``prog.evaluate`` (int64, reduced mod 2^32) a chunk of samples at a
    time, so a program of 60,000 rows needs no more than 0.5 GB."""
    return np.concatenate([prog.evaluate(x[i:i + chunk]) for i in range(0, len(x), chunk)]
                          ).astype(np.int32)


def plan_text(plan) -> str:
    return (f"{plan.entry} tile {plan.tile} x {plan.blocks} blocks, {plan.threads} threads, "
            f"{plan.smem_bytes} B")


def kernel_cases(torch, np, dev, mixer):
    from repro_torch.core import DAISProgram
    from repro_torch.kernels.adder_graph import compile_tables
    from repro_torch.kernels.adder_graph.kernel import adder_graph_cuda, plan_for
    from repro_torch.kernels.adder_graph.ref import adder_graph_ref

    rng = np.random.default_rng(0)
    progs = {
        "shifts_0_31_out_-40_40": random_program(rng, 24, 400, 48, 31, (-40, 40), 0.1, 0.05),
        "no_ops": random_program(rng, 16, 0, 24, 0, (-40, 40), 0.25, 0.0),
        "masked": random_program(rng, 32, 200, 40, 3, (0, 2), 0.5, 0.05),
        "wide_60000": wide_program(rng, 32, 60_000, 48),
    }
    for i, parr in enumerate(mixer.programs):
        progs[f"mixer_table{i}"] = DAISProgram.from_arrays(parr)
    max_err = 0
    n_cases = 0
    entries = set()
    for name, prog in progs.items():
        tables = compile_tables(prog)
        qs = [r.qint for r in prog.rows[: prog.n_inputs]]
        lo = np.array([q.lo for q in qs])
        hi = np.array([q.hi for q in qs])
        plans = []
        for batch in BATCHES:
            x = rng.integers(lo, hi + 1, size=(batch, prog.n_inputs)).astype(np.int32)
            xd = torch.from_numpy(x).to(dev)
            got = adder_graph_cuda(tables, xd).cpu().numpy()
            plain = adder_graph_ref(tables, xd).cpu().numpy()
            want = evaluate(np, prog, x)
            err = int(np.abs(got.astype(np.int64) - plain.astype(np.int64)).max(initial=0))
            max_err = max(max_err, err)
            check(np.array_equal(got, plain), f"kernel != plain version on {name}, batch {batch}")
            check(np.array_equal(got, want), f"kernel != evaluate on {name}, batch {batch}")
            n_cases += 1
            plan = plan_for(tables, batch, dev)
            entries.add(plan.entry)
            plans.append(f"{batch}: {plan_text(plan)}")
        log(f"  {name}: n_in {tables.n_inputs} n_ops {tables.n_ops} "
            f"levels {len(tables.level_bounds)} n_out {tables.n_outputs} "
            f"slots {tables.slot_plan.n_slots} of {tables.n_rows} rows: exact at batches {BATCHES}")
        log("    plans: " + "; ".join(plans))
    check(entries == {"shared", "global"}, f"phase 2 drove the entry points {sorted(entries)}")
    return max_err, n_cases


def launch_counters() -> dict:
    """Every kernel's launch counter, by kernel name.  Each main path is
    driven with all of them zeroed just before and read just after."""
    from repro_torch.kernels.adder_graph import kernel as ag_kernel
    from repro_torch.kernels.flash_attention import kernel as fa_kernel
    from repro_torch.kernels.quant_matmul import kernel as qm_kernel
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel

    return {"adder_graph": ag_kernel.launches, "flash_attention": fa_kernel.launches,
            "ssm_scan": ss_kernel.launches, "quant_matmul": qm_kernel.launches}


def kernel_counters() -> dict:
    """The launch counters by kernel of the sources that hold several, as
    "source.kernel": each launch counted in ``launch_counters`` is also
    counted here under the kernel it took."""
    from repro_torch.kernels.quant_matmul import kernel as qm_kernel
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel

    return {f"{source}.{name}": counter
            for source, mod in (("ssm_scan", ss_kernel), ("quant_matmul", qm_kernel))
            for name, counter in mod.kernel_launches.items()}


def check_only(counts: dict, kernel: str | None, what: str) -> None:
    """No kernel but ``kernel`` was launched in the run that gave ``counts``."""
    others = {k: v for k, v in counts.items() if k != kernel and v}
    check(not others, f"{what} launched other kernels: {others}")


def reset_counts() -> None:
    for counter in [*launch_counters().values(), *kernel_counters().values()]:
        counter.reset()


def read_counts() -> dict:
    return {name: counter.value for name, counter in launch_counters().items()}


def read_kernel_counts(source: str) -> dict:
    """Launches by kernel of ``source`` since the last ``reset_counts``."""
    return {name.split(".", 1)[1]: counter.value for name, counter in kernel_counters().items()
            if name.startswith(source + ".")}


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


def graph_ms(torch, fn, calls: int = 20, replays: int = 20) -> float:
    """Device time per call of ``fn``: ``calls`` calls captured in one CUDA
    graph, replayed ``replays`` times between CUDA events.  Unlike
    back-to-back eager calls, this leaves out the host's launch time, which
    is longer than a short kernel."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / (replays * calls)


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
    """Each adder-graph call of one forward at the main path's inputs: the
    kernel held exactly against its plain version and the float64
    ``torch.matmul`` yardstick, then the three timed as device time per
    call (CUDA-graph replays), beside the table's bound."""
    from repro_torch.core import DAISProgram
    from repro_torch.kernels.adder_graph.kernel import adder_graph_cuda, plan_for
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
        dev = tables.device_arrays(xt.device)  # the tables on the card before any capture
        got = adder_graph_cuda(tables, xt)
        plain = adder_graph_ref(tables, xt)
        max_err = max(max_err, int((got.to(torch.int64) - plain.to(torch.int64)).abs().max()))
        check(torch.equal(got, plain), f"table {i}, {xt.shape[0]} rows: kernel != plain version")
        check(torch.equal(torch.matmul(xf, md).to(torch.int32), got),
              f"table {i}, {xt.shape[0]} rows: kernel != float64 matmul yardstick")
        del got, plain
        k_ms = graph_ms(torch, lambda t=tables, v=xt: adder_graph_cuda(t, v))
        p_ms = graph_ms(torch, lambda t=tables, v=xt: adder_graph_ref(t, v), calls=2, replays=5)
        l_ms = graph_ms(torch, lambda a=xf, b=md: torch.matmul(a, b))
        n = xt.shape[0]
        plan = plan_for(tables, n, xt.device)
        # the bytes the entry point must move: x, y and the tables it reads
        read = ((dev.slot_ops, dev.slot_outs) if plan.entry == "shared" else (dev.instr, dev.outs))
        nbytes = 4 * n * (tables.n_inputs + tables.n_outputs) + sum(
            a.numel() * 4 for a in (*read, dev.level_starts))
        ops = n * int32_ops_per_row(np, tables)
        rows.append({
            "table": i, "rows": n, "n_in": tables.n_inputs, "n_ops": tables.n_ops,
            "levels": len(tables.level_bounds), "n_out": tables.n_outputs,
            "slots": tables.slot_plan.n_slots, "plan": plan_text(plan),
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
        if "namespace)::adder_graph_" in ev.key:  # either entry point
            kernel_us += us
    return {
        "forward_ms": fwd_ms,
        "profiler_kernel_ms": kernel_us / 1e3 if kernel_us > 0 else None,
        "profiler_all_kernels_ms": all_us / 1e3 if all_us > 0 else None,
    }


# ----------------------------------------------------------------------
# 6. flash kernel vs plain version
# ----------------------------------------------------------------------
FLASH_SHAPES = [  # (B, Hq, Hkv, Sq, Sk, D)
    (2, 4, 4, 128, 128, 64),  # MHA
    (1, 8, 2, 128, 128, 32),  # GQA 4:1
    (2, 4, 1, 64, 256, 32),  # MQA, Sq < Sk
    (8, 9, 3, 128, 128, 64),  # smollm-135m's prefill
    (1, 2, 2, 256, 256, 128),  # head_dim 128
    (1, 4, 2, 37, 53, 16),  # head_dim 16, ragged
    (2, 9, 3, 77, 77, 64),  # ragged square
    (1, 4, 4, 100, 300, 32),  # ragged, Sq < Sk
]
DECODE_OFFSETS = (0, 1, 127, 128, 511)
DECODE_GROUPS = (1, 3, 4, 8)  # GQA group sizes (query heads per KV head) of the decode cases
DECODE_MAX_SEQ = 512


def flash_cases(torch, dev) -> dict:
    """Max |kernel - plain| per dtype over the phase's cases."""
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, flash_plan
    from repro_torch.kernels.flash_attention.ref import attention_ref

    gen = torch.Generator(dev).manual_seed(0)

    def rand(*shape, dtype):
        return torch.randn(shape, generator=gen, device=dev).to(dtype)

    errs = {}
    for dname, dtype in (("float32", torch.float32), ("bfloat16", torch.bfloat16)):
        worst = 0.0
        cases = []
        for b, hq, hkv, sq, sk, d in FLASH_SHAPES:
            for causal in (True, False):
                cases.append((f"{(b, hq, hkv, sq, sk, d)} causal={causal}",
                              rand(b, hq, sq, d, dtype=dtype), rand(b, hkv, sk, d, dtype=dtype),
                              rand(b, hkv, sk, d, dtype=dtype), causal, None))
        for causal in (True, False):  # views off a 16-byte boundary: element-wise loads
            q, k, v = (rand(2, h, s, 65, dtype=dtype)[..., 1:] for h, s in
                       ((9, 40), (3, 70), (3, 70)))
            cases.append((f"unaligned (2, 9, 3, 40, 70, 64) causal={causal}", q, k, v, causal,
                          None))
        for group in DECODE_GROUPS:
            for pos in DECODE_OFFSETS:
                k = rand(8, 3, DECODE_MAX_SEQ, 64, dtype=dtype)
                v = rand(8, 3, DECODE_MAX_SEQ, 64, dtype=dtype)
                k[:, :, pos + 1:] = 1e4  # unwritten slots: the mask must hide them
                v[:, :, pos + 1:] = -1e4
                cases.append((f"decode group {group} offset {pos}",
                              rand(8, 3 * group, 1, 64, dtype=dtype), k, v, True,
                              torch.tensor(pos, dtype=torch.int32, device=dev)))
        plans = {}
        for name, q, k, v, causal, off in cases:
            plan = flash_plan(*q.shape[:2], k.shape[1], q.shape[2], k.shape[2], q.dtype,
                              sm_count(q.device))
            key = f"{plan.kernel} x{plan.splits}"
            plans[key] = plans.get(key, 0) + 1
            got = flash_attention_cuda(q, k, v, causal=causal, offset=off)
            torch.cuda.synchronize()
            if off is None:
                want = attention_ref(q, k, v, causal=causal)
            else:  # the plain version over the live prefix only: no garbage in its sums
                live = int(off) + 1
                want = attention_ref(q, k[:, :, :live], v[:, :, :live], causal=causal)
            err = float((got.float() - want.float()).abs().max())
            check(err <= FA_ATOL[dname], f"flash {dname} {name}: max |kernel - plain| {err}")
            worst = max(worst, err)
        errs[dname] = worst
        log(f"  {dname}: {len(cases)} cases, max |kernel - plain| = {worst:.3g} "
            f"(atol {FA_ATOL[dname]}); cases per kernel and splits: {json.dumps(plans)}")
    return errs


# ----------------------------------------------------------------------
# 7 and 10. reduced LMs against the committed JAX golden outputs
# ----------------------------------------------------------------------
def lm_golden(torch, np, dev, asset_name: str, kernel: str) -> None:
    """The reduced LM of ``assets/<asset_name>`` served on the card: the JAX
    engine's greedy tokens exactly, its logits within ``LM_F32_ATOL``, and
    one launch of ``kernel`` per layer per step."""
    from repro_torch import configs
    from repro_torch.models import decode_step, params_from_numpy, prefill, unflatten
    from repro_torch.serve import Engine, Request

    asset = ASSETS / asset_name
    manifest = json.loads((asset / "manifest.json").read_text())
    cfg = configs.get_smoke(manifest["arch"], **manifest["smoke_kwargs"])
    with np.load(asset / "weights.npz") as w:
        params = params_from_numpy(cfg, unflatten(dict(w)), device=dev)
    with np.load(asset / "golden.npz") as g:
        golden = dict(g)
    reqs = [Request(p, int(n)) for p, n in zip(golden["prompts"], golden["max_new_tokens"])]
    eng = Engine(cfg, params, manifest["batch_size"], manifest["max_seq"],
                 eos_id=manifest["eos_id"], device=dev)
    reset_counts()
    eng.generate(reqs)
    counts = read_counts()
    launched = counts[kernel]
    check_only(counts, kernel, f"{asset_name}'s serve")
    want_launches = cfg.n_layers * (1 + manifest["decode_steps"])
    check(launched == want_launches, f"{asset_name}: {launched} {kernel} launches, "
                                     f"want {want_launches}")
    for i, (r, want) in enumerate(zip(reqs, golden["tokens"])):
        want = [int(t) for t in want if t >= 0]
        check(r.out_tokens == want, f"{asset_name}: request {i} tokens {r.out_tokens} != JAX {want}")
    tokens = torch.from_numpy(np.stack([r.prompt for r in reqs])).to(dev)
    logits, cache = prefill(cfg, params, {"tokens": tokens}, manifest["max_seq"])
    err0 = float(np.abs(logits.cpu().numpy() - golden["prefill_logits"]).max())
    logits, _ = decode_step(cfg, params, logits.argmax(-1)[:, None], cache)
    err1 = float(np.abs(logits.cpu().numpy() - golden["decode_logits"]).max())
    check(max(err0, err1) <= LM_F32_ATOL,
          f"{asset_name}: logits differ from JAX by {err0:.3g} (prefill), {err1:.3g} (decode)")
    log(f"{cfg.name} ({cfg.param_count()} params, f32): {len(reqs)} requests' greedy tokens equal "
        f"the JAX engine's; {launched} {kernel} launches = {cfg.n_layers} layers x "
        f"(1 + {manifest['decode_steps']}); max |logits - JAX| prefill {err0:.3g}, "
        f"decode {err1:.3g} (atol {LM_F32_ATOL})")


# ----------------------------------------------------------------------
# 8 and 11. an LM main path at full width
# ----------------------------------------------------------------------
PROMPT_LEN, NEW_TOKENS, SERVE_BATCH, SERVE_MAX_SEQ = 128, 64, 8, 512
DECODE_TIMING_OFFSET = 160  # flash: about the mean cache position of the 63 decode steps


def plain_selective_scan_f64(dt, bmat, cmat, x, a, h0, h_out=None):
    """The plain version's recurrence in float64, rounded to f32: another
    correct scan, to measure how far two correct versions drift apart."""
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

    y, h = selective_scan_ref(*(u.double() for u in (dt, bmat, cmat, x, a, h0)))
    y, h = y.float(), h.float()
    return (y, h) if h_out is None else (y, h_out.copy_(h))


def lm_paths() -> dict:
    """Per served architecture: its kernel (launch counter and profiler
    name), the model module's name for the op that reaches the kernel, the
    plain version that replaces it on the plain path, where the weights
    are drawn, and which layer-0 calls of the op to keep for timing (call
    index -> name; the layer loop makes one call per layer per step)."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref
    from repro_torch.models import attention, ssm

    return {
        "smollm-135m": {
            "kernel": "flash_attention", "profile_key": "namespace)::flash_",
            "module": attention, "attr": "flash_attention", "plain": attention_ref,
            "init_on_card": False,  # 0.3 GB: drawn on the host, as phase 8 always has
            "f32_atol": None,  # held by LM_BF16_ATOL in bf16
            "plain_f64": None,
            "capture": {"prefill": 0, "decode": DECODE_TIMING_OFFSET - PROMPT_LEN + 1},
        },
        "falcon-mamba-7b": {
            "kernel": "ssm_scan", "profile_key": "namespace)::ssm_",
            "module": ssm, "attr": "selective_scan", "plain": selective_scan_ref,
            "init_on_card": True,  # 14.5 GB of bf16 weights, 29 GB of f32 draws
            # 64 random bf16 layers amplify a one-ulp f32 difference in the
            # scan's output (it flips a bf16 rounding) into logit differences
            # above LM_BF16_ATOL: two correct plain versions of the scan (f32,
            # and f64 rounded to f32) differ as much.  In f32 the same weights
            # agree within about 1e-3, so the paths are held there, at 1e-2;
            # the bf16 agreement is measured and printed.
            "f32_atol": 1e-2,
            "plain_f64": plain_selective_scan_f64,
            "capture": {"prefill": 0, "decode": 1},
        },
    }


def capture_op_inputs(torch, eng, path, prompts):
    """Serve ``prompts`` once through a fresh engine and keep the (args,
    kwargs) of the layer-0 calls of the path's op that ``path["capture"]``
    names (by decode step: 0 is prefill): the main path's shapes and values.
    (Calls are counted, not inspected, so nothing syncs.)"""
    layers = eng.cfg.n_layers
    wanted = {layers * step: name for name, step in path["capture"].items()}
    seen, n_calls = {}, [0]
    module, attr = path["module"], path["attr"]
    orig = getattr(module, attr)

    def clone(v):
        return v.clone() if isinstance(v, torch.Tensor) else v

    def record(*args, **kw):
        name = wanted.get(n_calls[0])
        if name is not None:
            seen[name] = ([clone(a) for a in args], {k: clone(v) for k, v in kw.items()})
        n_calls[0] += 1
        return orig(*args, **kw)

    setattr(module, attr, record)
    try:
        eng.generate(requests_for(prompts, max(path["capture"].values()) + 1))
    finally:
        setattr(module, attr, orig)
    return seen


def requests_for(prompts, new_tokens):
    from repro_torch.serve import Request

    return [Request(p, new_tokens) for p in prompts]


def teacher_forced(torch, cfg, params, prompts, dev, tokens, path, op) -> list:
    """Logits of prefill and of one decode step per entry of ``tokens``
    but the last, each step fed the given tokens, with the path's op
    replaced by ``op`` (``None``: the op itself, which reaches the kernel)."""
    from repro_torch.models import decode_step, prefill

    module, attr = path["module"], path["attr"]
    kernel_op = getattr(module, attr)
    if op is not None:
        setattr(module, attr, op)
    try:
        with torch.inference_mode():
            logits, cache = prefill(cfg, params, {"tokens": torch.from_numpy(prompts).to(dev)},
                                    SERVE_MAX_SEQ)
            out = [logits]
            for tok in tokens[:-1]:
                logits, cache = decode_step(cfg, params, tok[:, None], cache)
                out.append(logits)
    finally:
        setattr(module, attr, kernel_op)
    return out


def agreement(torch, kernel_logits, kernel_tokens, plain_logits, atol) -> dict:
    """How a kernel path's logits and picks agree with the plain path's:
    the max |difference|, the argmaxes that differ, those among them whose
    plain top-two gap is at least ``atol`` (far flips), and the picks whose
    gap is under it."""
    worst, n_flip, n_far, n_close = 0.0, 0, 0, 0
    for k_logits, k_tok, plain in zip(kernel_logits, kernel_tokens, plain_logits):
        worst = max(worst, float((plain.float() - k_logits.float()).abs().amax()))
        top2 = plain.float().topk(2, dim=-1).values
        close = (top2[:, 0] - top2[:, 1]) < atol
        flip = plain.argmax(-1) != k_tok
        n_flip += int(flip.sum())
        n_far += int((flip & ~close).sum())
        n_close += int(close.sum())
    return {"atol": atol, "max_abs_diff": worst, "n_picks": len(kernel_tokens) * SERVE_BATCH,
            "n_flips": n_flip, "n_far_flips": n_far, "n_close_picks": n_close}


def serve_lm(torch, np, dev, arch: str) -> dict:
    """Drive the main path of ``arch`` once, counted; then check it against
    the plain path and time it.  Returns what the kernels line and PERF.md
    need."""
    from repro_torch import configs
    from repro_torch.models import decode_step, init_params, prefill
    from repro_torch.serve import Engine

    path = lm_paths()[arch]
    kernel = path["kernel"]
    cfg = configs.get(arch)
    t0 = time.perf_counter()
    gen = torch.Generator(dev if path["init_on_card"] else "cpu").manual_seed(0)
    params = init_params(cfg, gen, device=dev)
    torch.cuda.synchronize()
    log(f"{cfg.name}: {cfg.param_count()} params in {cfg.dtype}, random (seed 0, the port's "
        f"init_params, drawn on the {gen.device.type}; no checkpoint ships), made in "
        f"{time.perf_counter() - t0:.2f} s; {torch.cuda.memory_allocated() / 1e9:.2f} GB on the card")
    prompts = np.random.default_rng(0).integers(
        2, cfg.vocab_size, size=(SERVE_BATCH, PROMPT_LEN)).astype(np.int32)

    def engine():  # no EOS id: every request runs its 64 tokens
        return Engine(cfg, params, batch_size=SERVE_BATCH, max_seq=SERVE_MAX_SEQ, eos_id=-1)

    # warm-up (CUDA context, cuBLAS handles), which also keeps the kernel's
    # main-path inputs for the timing below
    inputs = capture_op_inputs(torch, engine(), path, prompts)

    eng = engine()
    picks, stamps = [], []
    pick = eng._pick

    def recording_pick(logits):
        tok = pick(logits)
        torch.cuda.synchronize()
        stamps.append(time.perf_counter())
        picks.append((logits.clone(), tok.clone()))
        return tok

    eng._pick = recording_pick
    reqs = requests_for(prompts, NEW_TOKENS)
    torch.cuda.synchronize()
    reset_counts()
    t_start = time.perf_counter()
    eng.generate(reqs)
    t_end = time.perf_counter()
    counts = read_counts()
    launches = counts[kernel]
    by_kernel = read_kernel_counts(kernel)
    check_only(counts, kernel, f"{arch}'s serve")

    n_tok = sum(len(r.out_tokens) for r in reqs)
    check(launches == cfg.n_layers * NEW_TOKENS,
          f"serve: {launches} {kernel} launches, want {cfg.n_layers} x {NEW_TOKENS}")
    check(all(len(r.out_tokens) == NEW_TOKENS for r in reqs), "serve: a request fell short")
    check(all(0 <= t < cfg.vocab_size for r in reqs for t in r.out_tokens),
          "serve: a token outside the vocabulary")
    check(all(bool(torch.isfinite(lg).all()) for lg, _ in picks), "serve: non-finite logits")
    prefill_ms = (stamps[0] - t_start) * 1e3
    decode_ms = (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)
    log(f"serve: {len(reqs)} requests x {NEW_TOKENS} tokens, {launches} {kernel} launches "
        f"= {cfg.n_layers} x {NEW_TOKENS}; prefill {prefill_ms:.3f} ms, decode "
        f"{decode_ms:.3f} ms per step, {n_tok / (t_end - t_start):.1f} generated tokens/s "
        f"({t_end - t_start:.3f} s for {n_tok} tokens); finite logits")

    # the plain path, teacher-forced on the kernel path's tokens
    toks = [t for _, t in picks]
    t_plain = time.perf_counter()
    plain = teacher_forced(torch, cfg, params, prompts, dev, toks, path, path["plain"])
    agree = agreement(torch, [lg for lg, _ in picks], toks, plain, LM_BF16_ATOL)
    log(f"serve: plain path teacher-forced on the kernel path's tokens "
        f"({time.perf_counter() - t_plain:.1f} s), bf16: " + json.dumps(agree))
    if path["plain_f64"] is not None:
        # the spread between two correct plain versions, for scale
        alt = teacher_forced(torch, cfg, params, prompts, dev, toks, path, path["plain_f64"])
        spread = agreement(torch, alt, [lg.argmax(-1) for lg in alt], plain, LM_BF16_ATOL)
        del alt
        log("serve: the plain path with its op in float64, against the plain path, bf16: "
            + json.dumps(spread))
        agree = {"bf16": agree, "bf16_plain_f64_vs_plain": spread}
    del plain
    if path["f32_atol"] is None:
        check(agree["n_far_flips"] == 0,
              f"serve: an argmax differs where the plain top-two gap >= {LM_BF16_ATOL}")
        check(agree["max_abs_diff"] <= LM_BF16_ATOL,
              f"serve: kernel vs plain logits differ by {agree['max_abs_diff']}")
    else:
        # the same weights in f32: the kernel path against the plain path,
        # both teacher-forced on the served tokens, held to f32_atol
        from repro_torch.models.transformer import tree_map

        t32 = time.perf_counter()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = tree_map(lambda t: t.float(), params)
        k32 = teacher_forced(torch, cfg32, params32, prompts, dev, toks, path, None)
        p32 = teacher_forced(torch, cfg32, params32, prompts, dev, toks, path, path["plain"])
        agree32 = agreement(torch, k32, [lg.argmax(-1) for lg in k32], p32, path["f32_atol"])
        del params32, k32, p32
        torch.cuda.empty_cache()
        log(f"serve: f32 at full width, kernel path vs plain path, both teacher-forced on the "
            f"served tokens ({time.perf_counter() - t32:.1f} s): " + json.dumps(agree32))
        check(agree32["n_far_flips"] == 0,
              f"serve f32: an argmax differs where the plain top-two gap >= {path['f32_atol']}")
        check(agree32["max_abs_diff"] <= path["f32_atol"],
              f"serve f32: kernel vs plain logits differ by {agree32['max_abs_diff']}")
        agree["f32"] = agree32

    step = decode_breakdown(torch, cfg, params, prompts, dev, path["profile_key"])
    return {"launches": launches, "launches_by_kernel": by_kernel, "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "tokens_per_s": n_tok / (t_end - t_start), "inputs": inputs,
            "kernel_vs_plain": agree, **step}


def decode_breakdown(torch, cfg, params, prompts, dev, profile_key: str) -> dict:
    """One decode step at cache position ~PROMPT_LEN: its time (host clock
    over 20 back-to-back steps, ending in a sync) and, from the profiler,
    the device time of the path's kernel (profiler name containing
    ``profile_key``) and of all kernels in one step, and the step's kernel
    launches."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.models import decode_step, prefill

    with torch.inference_mode():
        tokens = torch.from_numpy(prompts).to(dev)
        logits, cache = prefill(cfg, params, {"tokens": tokens}, SERVE_MAX_SEQ)
        tok = logits.argmax(-1)[:, None]
        for _ in range(3):
            logits, cache = decode_step(cfg, params, tok, cache)
        torch.cuda.synchronize()
        n = 20
        t0 = time.perf_counter()
        for _ in range(n):
            logits, cache = decode_step(cfg, params, tok, cache)
        torch.cuda.synchronize()
        step_ms = (time.perf_counter() - t0) * 1e3 / n
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            logits, cache = decode_step(cfg, params, tok, cache)
            torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")  # a step that waits for the card raises
        try:
            logits, cache = decode_step(cfg, params, tok, cache)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        torch.cuda.synchronize()
    by_kernel, launches = {}, 0
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue
        us = getattr(ev, "self_device_time_total", 0.0) or 0.0
        if us > 0:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us
            launches += ev.count
    host = sorted(((ev.self_cpu_time_total, ev.count, ev.key) for ev in prof.key_averages()
                   if not str(getattr(ev, "device_type", "")).endswith("CUDA")), reverse=True)
    all_us = sum(by_kernel.values())
    kernel_us = sum(us for k, us in by_kernel.items() if profile_key in k)
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    rank = next((i + 1 for i, (k, _) in enumerate(ranked) if profile_key in k), None)
    log(f"decode step (back to back, position ~{PROMPT_LEN + 3}; no host sync inside): "
        f"{step_ms:.3f} ms; device time: "
        f"all kernels {all_us / 1e3:.4f} ms in {launches} launches, {profile_key} "
        f"{kernel_us / 1e3:.4f} ms (rank {rank} of {len(ranked)} kernels); idle "
        f"{(1 - all_us / 1e3 / step_ms) * 100 if all_us else float('nan'):.1f}%")
    for k, us in ranked[:8]:
        log(f"  {us / 1e3:.4f} ms  {k[:110]}")
    log(f"host ops of the step: {sum(h[1] for h in host)} calls, "
        f"{sum(h[0] for h in host) / 1e3:.3f} ms of self CPU time under the profiler; the largest:")
    for us, n, k in host[:8]:
        log(f"  {us / 1e3:.4f} ms  {n:5d} x {k[:90]}")
    return {
        "step_ms": step_ms,
        "profiler_all_kernels_ms": all_us / 1e3 if all_us else None,
        "profiler_kernel_ms": kernel_us / 1e3 if kernel_us else None,
        "profiler_launches": launches,
        "kernel_rank": rank,
        "idle_share": 1 - all_us / 1e3 / step_ms if all_us else None,
    }


def sdpa(torch, q, k, v, causal, offset):
    """``torch.nn.functional.scaled_dot_product_attention`` on the same
    inputs: GQA by ``enable_gqa`` where this PyTorch has it, else K/V
    repeated to Hq heads first (outside the timed call); an explicit mask
    for a decode offset.  Returns a callable."""
    import torch.nn.functional as F

    sq, sk, g = q.shape[2], k.shape[2], q.shape[1] // k.shape[1]
    mask = None
    if causal and offset is not None:
        pos = torch.arange(sq, device=q.device)[:, None] + int(offset)
        mask = torch.arange(sk, device=q.device)[None, :] <= pos
    is_causal = causal and mask is None
    try:
        F.scaled_dot_product_attention(q[:1, :g, :1], k[:1, :1, :1], v[:1, :1, :1],
                                       enable_gqa=True)
        kw = {"enable_gqa": True}
    except TypeError:
        k, v, kw = k.repeat_interleave(g, dim=1), v.repeat_interleave(g, dim=1), {}
    return lambda: F.scaled_dot_product_attention(q, k, v, attn_mask=mask, is_causal=is_causal,
                                                  **kw)


def flash_times(torch, inputs) -> dict:
    """The kernel at the main path's prefill and decode inputs: held
    against its plain version and the library yardstick, then the three
    timed with CUDA events, beside the bound."""
    from repro_torch.kernels._build import sm_count
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda, flash_plan
    from repro_torch.kernels.flash_attention.ref import attention_ref

    out = {}
    for name, (args, kw) in inputs.items():
        q, k, v = args
        causal, offset = kw.get("causal", True), kw.get("offset")
        b, hq, sq, d = q.shape
        hkv, sk = k.shape[1], k.shape[2]
        start = (sk - sq) if offset is None else int(offset)
        # live (query, key) pairs and the live K/V prefix this call needs
        pairs = sum(min(max(start + i + 1, 0), sk) for i in range(sq)) if causal else sq * sk
        live = min(start + sq, sk) if causal else sk
        esz = q.element_size()
        nbytes = esz * (2 * b * hq * sq * d + 2 * b * hkv * live * d)
        flops = 4 * d * b * hq * pairs
        peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S
        bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
        lib = sdpa(torch, q, k, v, causal, offset)
        got = flash_attention_cuda(q, k, v, causal=causal, offset=offset)
        plain = attention_ref(q, k, v, causal=causal, offset=offset)
        err = float((got.float() - plain.float()).abs().max())
        lib_err = float((got.float() - lib().float()).abs().max())
        atol = FA_ATOL["bfloat16" if q.dtype == torch.bfloat16 else "float32"]
        check(err <= atol, f"flash at the {name} inputs: max |kernel - plain| {err}")
        check(lib_err <= atol, f"flash at the {name} inputs: max |kernel - library| {lib_err}")
        kern = lambda: flash_attention_cuda(q, k, v, causal=causal, offset=offset)  # noqa: E731
        plan = flash_plan(b, hq, hkv, sq, sk, q.dtype, sm_count(q.device))
        row = {
            "shape": f"q {list(q.shape)}, k/v {list(k.shape)}, {str(q.dtype)[6:]}, "
                     f"causal={causal}, offset {start}",
            "plan": f"{plan.kernel} kernel, {plan.splits} split(s)",
            "ms": graph_ms(torch, kern),
            "plain_ms": graph_ms(torch, lambda: attention_ref(q, k, v, causal=causal,
                                                                offset=offset)),
            "library_ms": graph_ms(torch, lib),
            "eager_ms": time_ms(torch, kern, iters=200),
            "bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms, "flops_ms": flops_ms,
            "bound_ms": max(bytes_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
            "max_abs_err": err, "library_max_abs_err": lib_err,
        }
        out[name] = row
        log(f"flash {name}: " + json.dumps(row))
    return out


# ----------------------------------------------------------------------
# 9. selective-scan and W8A8 matmul kernels vs their plain versions
# ----------------------------------------------------------------------
SCAN_SHAPES = [  # (B, S, D, N)
    (2, 16, 32, 8), (1, 32, 64, 16), (3, 8, 16, 4),  # tests/test_ssm_kernel.py
    (2, 100, 300, 16),  # ragged channels, several chunks of steps
    (4, 70, 129, 8), (1, 5, 7, 1),  # ragged, N = 8 and N = 1
    (2, 2, 129, 16), (4, 33, 129, 5), (2, 128, 129, 13),  # prefill at S 2, 33 and 128
    (8, 1, 8192, 16), (8, 1, 8192, 8),  # decode at falcon-mamba-7b's width
    (8, 128, 8192, 16),  # falcon-mamba-7b's prefill
]
# decode (S = 1) at every state size, ragged channels, one and eight batch
# rows, the state updated in place and B and C as strided views
SCAN_DECODE = [(b, 1, 129, n) for n in range(1, 17) for b in (1, 8)]
QMM_SHAPES = [  # (M, K, N)
    (128, 256, 128), (256, 512, 256), (64, 128, 32),  # tests/test_quant_matmul.py
    (1000, 4096, 16400), (129, 48, 272), (1, 16, 16),  # TMA: ragged M and N tiles, aligned rows
    (100, 200, 60), (33, 1000, 77), (1, 5, 3),  # mma.sync: rows TMA cannot describe
    (300, 4096, 520),
]


def scan_inputs(torch, dev, gen, b, s, d, n):
    def normal(*shape):
        return torch.randn(shape, generator=gen, device=dev)

    return (torch.nn.functional.softplus(normal(b, s, d) - 1.0), normal(b, s, n) * 0.5,
            normal(b, s, n) * 0.5, normal(b, s, d), -torch.exp(normal(d, n) * 0.3),
            normal(b, d, n) * 0.1)


def scan_cases(torch, dev) -> dict:
    """Every case within SCAN_ATOL of the plain version; returns the max
    |kernel - plain| and the number of cases by the kernel each took."""
    from repro_torch.kernels.ssm_scan.kernel import scan_kernel_for, selective_scan_cuda
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

    gen = torch.Generator(dev).manual_seed(0)
    worst = {"decode": 0.0, "prefill": 0.0}
    taken = {"decode": 0, "prefill": 0}

    def held(name, shape, got, want):
        torch.cuda.synchronize()
        err = max(float((g - w).abs().max()) for g, w in zip(got, want))
        check(err <= SCAN_ATOL, f"scan {name}: max |kernel - plain| {err}")
        kernel = scan_kernel_for(shape[1])
        worst[kernel] = max(worst[kernel], err)
        taken[kernel] += 1
        return kernel

    for shape in SCAN_SHAPES:
        args = scan_inputs(torch, dev, gen, *shape)
        kernel = held(shape, shape, selective_scan_cuda(*args), selective_scan_ref(*args))
        log(f"  scan {shape}: {kernel}")
    for shape in SCAN_DECODE:
        b, s, d, n = shape
        dt, bm, cm, x, a, h0 = scan_inputs(torch, dev, gen, *shape)
        want = selective_scan_ref(dt, bm, cm, x, a, h0)
        proj = torch.cat([torch.zeros(b, s, 3, device=dev), bm, cm], dim=-1)
        state = h0.clone()
        got = selective_scan_cuda(dt, proj[..., 3:3 + n], proj[..., 3 + n:], x, a, state,
                                  h_out=state)
        held(f"decode {shape} in place, strided B/C", shape, got, want)
    log(f"  scan decode: N 1..16 at D 129, B 1 and 8, in place, strided B/C: "
        f"{len(SCAN_DECODE)} cases")
    dt, bm, cm, x, a, h0 = scan_inputs(torch, dev, gen, 2, 24, 160, 16)
    want = selective_scan_ref(dt, bm, cm, x, a, h0)
    state = h0.clone()  # two halves, the state carried in place (the decode cache's use)
    y1, _ = selective_scan_cuda(dt[:, :12].contiguous(), bm[:, :12], cm[:, :12],
                                x[:, :12].contiguous(), a, state, h_out=state)
    y2, _ = selective_scan_cuda(dt[:, 12:].contiguous(), bm[:, 12:], cm[:, 12:],
                                x[:, 12:].contiguous(), a, state, h_out=state)
    held("two halves chained in place", (2, 12, 160, 16), (torch.cat([y1, y2], dim=1), state),
         want)
    proj = torch.cat([torch.zeros_like(bm[..., :3]), bm, cm], dim=-1)
    held("B and C as strided views", (2, 24, 160, 16),
         selective_scan_cuda(dt, proj[..., 3:19], proj[..., 19:], x, a, h0), want)
    check(all(taken.values()), f"phase 9 drove the scan kernels {taken}")
    log(f"  scan: {sum(taken.values())} cases, by kernel {taken}, max |kernel - plain| "
        f"{worst} (atol {SCAN_ATOL})")
    return {"max_abs_err": max(worst.values()),
            "entry_points": {k: {"cases": taken[k], "max_abs_err": worst[k]} for k in taken}}


def qmm_inputs(torch, dev, gen, m, k, n):
    x = torch.randint(-128, 128, (m, k), generator=gen, device=dev, dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=gen, device=dev, dtype=torch.int8)
    xs = torch.rand(m, generator=gen, device=dev) * 1.5 + 0.5
    ws = torch.rand(n, generator=gen, device=dev) * 0.09 + 0.01
    return x, w, xs, ws


def qmm_cases(torch, dev) -> dict:
    """Every case bit-equal to the plain version; returns the max |kernel -
    plain| (0) and the number of cases by the kernel each took."""
    from repro_torch.kernels.quant_matmul.kernel import qmm_entry, quant_matmul_cuda
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

    gen = torch.Generator(dev).manual_seed(1)
    cases = {str(shape): qmm_inputs(torch, dev, gen, *shape) for shape in QMM_SHAPES}
    x, w, xs, ws = qmm_inputs(torch, dev, gen, 64, 256, 128)
    base = torch.empty(x.numel() + 8, dtype=torch.int8, device=dev)[8:]  # 8 bytes off 16
    cases["(64, 256, 128), x 8 bytes off 16-byte alignment"] = (
        base.view(64, 256).copy_(x), w, xs, ws)
    x, w, xs, ws = qmm_inputs(torch, dev, gen, 64, 4096, 48)
    x[:8], w[:, :8] = 127, 127
    w[0, :8] = 126  # odd sums near 2^26: f32 summation would round them
    x[8:12], w[:, 8:12] = -128, -128
    exact = x.cpu().long() @ w.cpu().long()
    check(int(exact.abs().max()) >= 2**25, "the K = 4096 case does not pass 2^24")
    cases["(64, 4096, 48), sums to 2^26"] = (x, w, xs, ws)
    ones = (torch.ones(64, device=dev), torch.ones(48, device=dev))
    got = quant_matmul_cuda(x, w, *ones)
    check(torch.equal(got.cpu(), exact.float()), "W8A8 kernel != exact integer product at K 4096")
    worst = {"tma": 0.0, "mma_sync": 0.0}
    taken = {"tma": 0, "mma_sync": 0}
    for name, args in cases.items():
        got = quant_matmul_cuda(*args)
        want = quant_matmul_ref(*args)
        (m, k), n = args[0].shape, args[1].shape[1]
        entry = qmm_entry(n, k, args[0].data_ptr(), args[1].data_ptr(), got.data_ptr())
        worst[entry] = max(worst[entry], float((got - want).abs().max()))
        check(torch.equal(got, want), f"W8A8 kernel ({entry}) != plain version on {name}")
        taken[entry] += 1
        log(f"  W8A8 {name}: {entry}")
    check(all(taken.values()), f"phase 9 drove the W8A8 kernels {taken}")
    log(f"  W8A8 matmul: {len(cases)} cases bit-equal to the plain version (and the unit-scale "
        f"K 4096 case to the exact int64 product), by kernel {taken}")
    return {"max_abs_err": max(worst.values()),
            "entry_points": {k: {"cases": taken[k], "max_abs_err": worst[k]} for k in taken}}


# ----------------------------------------------------------------------
# 11. the scan at the main path's inputs; the W8A8 matmul through its op
# ----------------------------------------------------------------------
def scan_times(torch, inputs, info) -> dict:
    """The kernel at the main path's layer-0 prefill and decode inputs:
    held against its plain version, then both timed as device time per
    call (CUDA-graph replays) beside the bound.  The call is made as the
    main path makes it, the state written in place (into copies): ``ms``
    cycles through SCAN_STATES distinct states, as the main path's layers
    do, so each call reads its state from device memory; ``l2_warm_ms``
    calls one state again and again, which then sits in L2."""
    from repro_torch.kernels.ssm_scan.kernel import scan_kernel_for, selective_scan_cuda
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

    out = {}
    for name, (args, _) in inputs.items():
        dt, bm, cm, x, a, h0 = args
        b, s, d = dt.shape
        n = a.shape[1]
        y, h = selective_scan_cuda(*args)
        y_p, h_p = selective_scan_ref(*args)
        err = max(float((y - y_p).abs().max()), float((h - h_p).abs().max()))
        check(err <= SCAN_ATOL, f"scan at the {name} inputs: max |kernel - plain| {err}")
        state = h0.clone()
        # each input read once, each output written once; B and C are read as
        # the rows of the projection they are views of, counted at N each
        nbytes = 4 * (3 * b * s * d + 2 * b * s * n + d * n + 2 * b * d * n)
        exps = b * s * d * n
        flops = 7 * exps  # dt*A, dt*B, *x, decay*h + bx (2), y += C*h (2)
        bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
        exp_ms = exps / info["exp_per_s"] * 1e3
        flops_ms = flops / F32_FLOPS_PER_S * 1e3
        kern = lambda: selective_scan_cuda(dt, bm, cm, x, a, state, h_out=state)  # noqa: E731
        # the main path's 64 layers each bring their own state from device
        # memory; one state buffer called again and again stays in L2 instead
        states = [h0.clone() for _ in range(SCAN_STATES)]
        cycle = itertools.cycle(states)
        from_hbm = lambda: (lambda st: selective_scan_cuda(  # noqa: E731
            dt, bm, cm, x, a, st, h_out=st))(next(cycle))
        row = {
            "shape": f"dt/x [{b}, {s}, {d}], B/C [{b}, {s}, {n}] (strided views), f32, "
                     f"state in place",
            "kernel": scan_kernel_for(s),
            "ms": graph_ms(torch, from_hbm, calls=SCAN_STATES),
            "timed": f"{SCAN_STATES} distinct states in one graph "
                     f"({SCAN_STATES * h0.numel() * 4 / 1e6:.0f} MB, past the 50 MB L2)",
            "l2_warm_ms": graph_ms(torch, kern),
            "plain_ms": graph_ms(torch, lambda: selective_scan_ref(*args),
                                 calls=2 if s > 1 else 20, replays=5 if s > 1 else 20),
            "library_ms": None,
            "library": "none: no single PyTorch call computes the recurrence",
            "eager_ms": time_ms(torch, kern, iters=200),
            "bytes": nbytes, "exps": exps, "flops": flops, "bytes_ms": bytes_ms,
            "exp_ms": exp_ms, "flops_ms": flops_ms,
            "bound_ms": max(bytes_ms, exp_ms, flops_ms),
            "bound_by": "bytes" if bytes_ms >= max(exp_ms, flops_ms) else "operations",
            "max_abs_err": err,
        }
        del states
        out[name] = row
        log(f"scan {name}: " + json.dumps(row))
    return out


QMM_TIMED = (1024, 4096, 16384)  # falcon-mamba-7b's in_proj at the prefill batch (M, K, N)


def qmm_path_and_times(torch, dev) -> dict:
    """The W8A8 op's main path (its public op, as a caller uses it; nothing
    in the port calls it) at QMM_TIMED, counted; the kernel held exactly
    against its plain version and ``torch._int_mm`` times the scales (the
    yardstick, which the port never calls); the three timed as device time
    per call beside the bound."""
    from repro_torch.kernels.quant_matmul import quant_matmul
    from repro_torch.kernels.quant_matmul.kernel import quant_matmul_cuda
    from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref

    m, k, n = QMM_TIMED
    x, w, xs, ws = qmm_inputs(torch, dev, torch.Generator(dev).manual_seed(2), m, k, n)
    torch.cuda.synchronize()
    reset_counts()
    got = quant_matmul(x, w, xs, ws)
    torch.cuda.synchronize()
    counts = read_counts()
    by_kernel = read_kernel_counts("quant_matmul")
    check_only(counts, "quant_matmul", "the W8A8 op")
    check(counts["quant_matmul"] == 1, f"the W8A8 op launched {counts}")
    check(by_kernel == {"tma": 1, "mma_sync": 0}, f"the W8A8 op took {by_kernel}")
    lib = lambda: torch._int_mm(x, w).float() * xs[:, None] * ws[None, :]  # noqa: E731
    plain = quant_matmul_ref(x, w, xs, ws)
    check(torch.equal(got, plain), "W8A8 kernel != plain version at the timed shape")
    check(torch.equal(got, lib()), "W8A8 kernel != torch._int_mm yardstick at the timed shape")
    del plain
    nbytes = m * k + k * n + 4 * (m + n) + 4 * m * n
    ops = 2 * m * n * k
    bytes_ms, ops_ms = nbytes / HBM_BYTES_PER_S * 1e3, ops / INT8_OPS_PER_S * 1e3
    row = {
        "shape": f"x int8 [{m}, {k}], w int8 [{k}, {n}], f32 scales -> f32 [{m}, {n}]",
        "launches": counts["quant_matmul"],
        "launches_by_kernel": by_kernel,
        "ms": graph_ms(torch, lambda: quant_matmul_cuda(x, w, xs, ws), calls=10, replays=10),
        "plain_ms": graph_ms(torch, lambda: quant_matmul_ref(x, w, xs, ws), calls=2, replays=5),
        "library_ms": graph_ms(torch, lib, calls=10, replays=10),
        "library": "torch._int_mm, then * x_scale[:, None] * w_scale[None, :]",
        "bytes": nbytes, "int8_ops": ops, "bytes_ms": bytes_ms, "ops_ms": ops_ms,
        "bound_ms": max(bytes_ms, ops_ms),
        "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
        "max_abs_err": 0.0,
    }
    log("W8A8 matmul: " + json.dumps(row))
    return row


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
    reset_counts()
    t0 = time.perf_counter()
    served = load_design(mixer_path)
    with ServeEngine(cfg) as eng:
        eng.register("mixer", served, warmup=True)
        t_reg = time.perf_counter()
        futs = eng.submit_batch("mixer", np.concatenate([x_gold] * reps))
        outs = [f.result(120) for f in futs]
        t_done = time.perf_counter()
        stats = eng.stats("mixer")
        counts = read_counts()
        main_launches = counts["adder_graph"]
    got = np.stack(outs)
    check(np.array_equal(got, np.concatenate([y_gold] * reps)), "served outputs != JAX golden")
    check(stats["n_fallback_batches"] == 0, "fallback batches")
    check(stats["breaker"]["n_trips"] == 0, "the circuit breaker opened")
    check(stats["supervision"]["n_crashes"] == 0, "a dispatch shard crashed")
    n_steps = count_cmvm_steps(served.step_specs)
    want_launches = (stats["n_batches"] + len(stats["buckets"])) * n_steps
    check(main_launches == want_launches,
          f"{main_launches} launches on the main path, expected {want_launches}")
    check_only(counts, "adder_graph", "the Mixer's serve")
    rps = len(futs) / (t_done - t_reg)
    log(f"serve: {len(futs)} requests bit-exact; {rps:.0f} req/s, p50 {stats['p50_ms']:.3f} ms, "
        f"p99 {stats['p99_ms']:.3f} ms, {stats['n_batches']} batches, {main_launches} launches; "
        f"load + register + warm-up {t_reg - t0:.2f} s")
    log("serve stages: " + json.dumps(stats["per_stage"]))

    log("== 5. times (device time per call: CUDA-graph replays)")
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
        "at_4096": {k: sum(r[k] for r in timings[4096]["tables"])
                    for k in ("kernel_ms", "plain_ms", "library_ms", "bytes_ms", "ops_ms")},
    }]}

    log("== 6. flash-attention kernel vs plain version")
    torch.backends.cuda.matmul.allow_tf32 = False  # float32 products in full float32
    torch.backends.cudnn.allow_tf32 = False
    flash_errs = flash_cases(torch, dev)

    log("== 7. reduced smollm-135m against the committed JAX golden outputs")
    lm_golden(torch, np, dev, "smollm_smoke", "flash_attention")

    log("== 8. serve smollm-135m at full width (main path)")
    lm = serve_lm(torch, np, dev, "smollm-135m")
    ft = flash_times(torch, lm["inputs"])
    dec, pre = ft["decode"], ft["prefill"]
    kernels["kernels"].append({
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
        "launches": lm["launches"],
        "max_abs_err": max(*flash_errs.values(), dec["max_abs_err"], pre["max_abs_err"]),
        "ms": dec["ms"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "shape": "one decode launch of the main path (layer 0): " + dec["shape"],
        "prefill": {k: pre[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
    })
    log("serve summary: " + json.dumps({k: v for k, v in lm.items() if k != "inputs"}))
    del lm, ft

    log("== 9. selective-scan and W8A8 matmul kernels vs their plain versions")
    scan_phase9 = scan_cases(torch, dev)
    qmm_phase9 = qmm_cases(torch, dev)

    log("== 10. reduced falcon-mamba against the committed JAX golden outputs")
    lm_golden(torch, np, dev, "falcon_mamba_smoke", "ssm_scan")

    log("== 11. serve falcon-mamba-7b at full width (main path); the W8A8 matmul's op")
    sm = serve_lm(torch, np, dev, "falcon-mamba-7b")
    n_layers = sm["launches"] // NEW_TOKENS
    want = {"decode": n_layers * (NEW_TOKENS - 1), "prefill": n_layers}
    check(sm["launches_by_kernel"] == want,
          f"falcon-mamba's serve took the scan kernels {sm['launches_by_kernel']}, want {want}")
    log(f"serve: scan launches by kernel {sm['launches_by_kernel']}")
    st = scan_times(torch, sm["inputs"], info)
    dec, pre = st["decode"], st["prefill"]
    entry_keys = ("shape", "kernel", "ms", "timed", "l2_warm_ms", "plain_ms", "bound_ms",
                  "bound_by", "library_ms", "library", "max_abs_err")
    kernels["kernels"].append({
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:25",
        "launches": sm["launches"],
        "max_abs_err": max(scan_phase9["max_abs_err"], dec["max_abs_err"], pre["max_abs_err"]),
        "ms": dec["ms"],
        "l2_warm_ms": dec["l2_warm_ms"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"],
        "library_ms": None,
        "library": dec["library"],
        "shape": "one decode launch of the main path (layer 0), its state read from device "
                 "memory: " + dec["shape"],
        "decode": {k: dec[k] for k in entry_keys},
        "prefill": {k: pre[k] for k in entry_keys},
        "entry_points": {k: {**v, "launches": sm["launches_by_kernel"][k]}
                         for k, v in scan_phase9["entry_points"].items()},
    })
    log("serve summary: " + json.dumps({k: v for k, v in sm.items() if k != "inputs"}))
    del sm, st
    qm = qmm_path_and_times(torch, dev)
    kernels["kernels"].append({
        "name": "quant_matmul",
        "route": "cuda",
        "source": "src/repro_torch/kernels/quant_matmul/csrc/quant_matmul.cu",
        "replaces": "src/repro/kernels/quant_matmul/kernel.py:24",
        "launches": qm["launches"],
        "max_abs_err": max(qmm_phase9["max_abs_err"], qm["max_abs_err"]),
        **{k: qm[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                              "library")},
        "shape": "one call of the public op quant_matmul (its only path): " + qm["shape"],
        "entry_points": {k: {**v, "launches": qm["launches_by_kernel"][k]}
                         for k, v in qmm_phase9["entry_points"].items()},
    })
    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(info["nvidia_smi"])
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
