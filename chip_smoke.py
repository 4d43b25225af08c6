#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA card.

    python3 chip_smoke.py            (from the repository root)

Builds every CUDA kernel of the port from the sources in the checkout,
then runs thirty phases, each of which must pass:

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
            ``register`` (no warm-up) -> ``submit_batch`` of 4096 requests
            -> results and ``stats``, then the same burst again (every
            graph captured: the steady state).  Each shard captures a
            bucket's CUDA graph at its first batch of that shape:
            ``jit_compiles`` must
            count exactly the (shard, bucket) pairs used, every batch must
            be one replay, no batch may fall back.  Launch counts are
            zeroed just before and read just after (one eager warm-up per
            capture plus one replay per batch, each one launch per CMVM
            step), and the profiler's kernel count of one replay must equal
            the launches recorded at capture; every future must resolve to
            the golden output;
5. times    per Mixer table, at the shapes one forward at 256 and at 4096
            samples gives it: the kernel, held exactly against its plain
            version and the library yardstick (one float64
            ``torch.matmul`` by the table's dense matrix, which the port
            never calls) on those inputs, then the three timed as device
            time per call (CUDA-graph replays), beside the table's bound
            and launch plan; one forward eagerly and as a graph replay;
6. flash    the flash-attention kernel against its plain PyTorch version
            on the card: f32 and bf16, causal and full, MHA, GQA 4:1,
            MQA and smollm's 9:3, head_dim 16/32/64/80/112/128
            (stablelm-3b's prefill at 80), ragged Sq and Sk, and decode
            (Sq=1) against a 512-slot cache at offsets 0, 1, 127, 128 and
            511 read from the card, at GQA group sizes 1, 3, 4 and 8
            (head_dim 64) and 1, 4 and 8 (head_dim 80 and 112), at
            granite-20b's 48:1 (head_dim 128: 48 rows, the prefill
            kernels) and at qwen3-moe-30b-a3b's 32:4 (head_dim 128, group
            8); max abs error per dtype against atol 2e-5 (f32) and
            2e-2 (bf16), and how many cases each of the source's kernels
            (decode, tensor-core, CUDA-core) took;
7. lm       the reduced smollm-135m from the committed JAX weights
            (``assets/smollm_smoke``) served on the card reproduces the
            JAX engine's greedy tokens exactly and its prefill and first
            decode logits within 1e-4 (f32), with n_layers x (1 + decode
            steps) kernel launches;
8. serve    the LM main path at full width: smollm-135m (30 layers,
            d_model 576, 9:3 heads, vocab 49152, bf16) with random
            weights, the JAX package's of ``PRNGKey(0)`` drawn on the card
            by the threefry kernel (the repository ships no checkpoint;
            the draw counted: phase 29) in ``Engine(batch_size=8,
            max_seq=512)``, which captures its
            decode step as a CUDA graph, serves 8 requests of 128-token
            prompts and 64 new tokens.  Launch counts are zeroed just
            before and read just after (30 x 64 flash launches: prefill
            eager, 63 replays counted as recorded at capture); the tokens
            equal exactly those of an eager loop over ``prefill`` and
            ``decode_step`` on the same kernels; the plain path,
            teacher-forced on the kernel path's tokens, agrees on the
            logits within 0.25 and on every argmax whose top-two gap is at
            least that; prefill and decode times and tokens/s of the
            served run and of the eager loop; the time, and the profiler's
            device time, launches and idle share, of one decode step
            replayed and one run eagerly, neither of which may sync the
            host (``set_sync_debug_mode("error")``), the profiler's kernel
            count of the replay held to the capture's; then the kernel at
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
            bf16, 7,272,140,800 parameters) with random weights
            (``PRNGKey(0)``, drawn on the card) in ``Engine(batch_size=8,
            max_seq=512)`` serves 8 requests of 128-token prompts and 64
            new tokens through its decode graph, as phase 8 does, counted
            (64 x 64 scan launches, no other kernel: 64 on the prefill
            kernel, 64 x 63 on the decode kernel), held to an eager loop's
            tokens exactly and by phase 8's rule against the plain path;
            then the scan at the main path's layer-0 prefill and decode
            inputs against its plain version, timed by CUDA-graph replay
            beside its bound, each call on its own of 32 states (128 MB at
            decode, past the 50 MB L2, as the main path's 64 layers bring
            theirs from device memory) and, labelled L2-warm, on one state
            again and again; and the W8A8 matmul, run once through its
            public op (its only path, on the TMA kernel), held exactly
            against its plain version and ``torch._int_mm`` times the
            scales (the library yardstick, which the port never calls) at
            M 1024, K 4096, N 16384, the three timed beside its bound;
12. fallback the Mixer registered with ``fallback="interpreter"`` (which
            captures every bucket on both shards at ``register``) under a
            seeded fault plan on ``serve.dispatch`` (its first three hits
            raise) that opens the breaker: bursts of the golden inputs,
            past the cooldown between them, until the probes go back to the
            kernel and one whole burst runs on it.  Every future resolves
            to the golden output, ``n_fallback_batches > 0``, each fault is
            one ``dispatch_fault`` flight event (none taken for the
            device's), the breaker ends closed, and the adder-graph
            launches are those of the replays;
13. serve   the dense main path at head_dim 80: stablelm-3b (32 layers,
            d_model 2560, 32:32 heads, head_dim 80, d_ff 6912, vocab
            50304, bf16) with random weights (seed 0, drawn on the card),
            served and checked as phase 8 serves smollm-135m (32 x 64 flash
            launches); the kernel timed at its prefill and decode inputs,
            at kimi-k2's head_dim 112 and qwen3-moe's 32:4 at head_dim
            128 (prefill and decode), and granite-20b's 48:1 decode;
14. compile the port compiles the committed weights (``params.npz``) of
            the 64-particle Mixer and the SVHN CNN itself, on the host
            (``compile_model`` with the committed manifest's config,
            ``jobs=None``): each saved artifact equals the committed one
            (``arrays_sha256``, resources, reports without wall times) and
            passes ``load_design(verify="strict")``; its ``forward_int`` on
            the card reproduces the JAX golden outputs bit for bit, one
            launch per CMVM step, and the float64 ``apply_model`` on the card
            equals its ``forward`` exactly; then the port-compiled Mixer
            serves a burst of 4096 through ``ServeEngine(ServeConfig(
            max_batch=256, shards=2))``, counted as phase 4 counts, every
            output golden and no fallback.  Prints the compile and verify
            times, the number of solves and the solve pool's fallback;
15. flow    the README quickstart through the port's facade:
            ``Flow.load`` the committed Mixer, ``Flow.serve(ServeConfig(
            max_batch=256, shards=2))``, ``register`` it as v1, submit a
            burst of 4096 and, while it is in flight, register phase 14's
            port-compiled Mixer as v2 (every bucket captured while v1
            replays): every future golden, v1 drained with its graphs
            released, v2 serving, launches counted as phase 4 counts for
            both versions; two jet_tagger designs compiled on the card by
            ``Flow.compile`` from the weights of ``PRNGKey(0)`` and
            ``PRNGKey(1)`` (the JAX package's, drawn on the card), rolled
            v1 -> v2 (v1 kept) ->
            ``activate(1)`` -> ``unregister``, every output its own
            version's ``forward_int`` and the two versions different; five
            register/drain cycles of the Mixer, device memory read after
            each (allocated must stay at the first cycle's level within
            1 MiB); the legacy spelling ``ServeEngine(max_batch=256)``
            warns and equals the config spelling;
16. cosim   ``cosim_grid(jit="require")`` with the device leg on the card:
            all 34 programs of ``default_grid()`` RTL == interpreter ==
            the adder-graph kernel, latency as pipelined, one kernel launch
            per program's table, and every case's report equal to a CPU
            run of the same grid;
17. serve   the MoE main path at full width: qwen3-moe-30b-a3b (48 layers,
            d_model 2048, 32:4 heads, head_dim 128, 128 experts top-8,
            d_ff 768, vocab 151936, qk_norm, bf16, 30,532,646,912
            parameters, not cut) with random weights (seed 0, drawn on the
            card, after the earlier phases' weights are freed), served as
            phase 8 serves smollm-135m (48 x 64 flash launches, the decode
            graph's tokens equal to an eager loop's) and held to the plain
            path by the MoE rule (end to end as phase 8, or, where two
            correct plain versions fail that too, layer by layer with the
            routing flips explained; see "MoE rule" below); the peak device
            memory, the decode step against its bytes bound, and the kernel
            timed at its prefill and decode inputs;
18. lm      the reduced jamba, whisper and internvl2 from their committed JAX
            weights and stub inputs (``assets/{jamba,whisper,internvl2}_smoke``)
            served on the card through ``Engine(extra_inputs=...)`` reproduce
            the JAX engine's greedy tokens exactly and its prefill and first
            decode logits within 1e-4 (f32), flash (and the scan) launched
            once per attention (cross-attention, encoder, Mamba) layer per
            step;
19. serve   the encoder-decoder main path at full width: whisper-base (6
            encoder and 6 decoder layers, d_model 512, 8:8 heads, vocab
            51865, bf16, 109,854,720 parameters, not cut) with random
            weights and ``enc_frames`` [8, 1500, 512] (numpy, seed 0) as its
            stub front end's output, served as phase 8 serves smollm-135m
            (18 flash launches at prefill -- 6 encoder, 6 self, 6 cross --
            and 12 per replay: 774), the static cross cache never rebound,
            held by phase 8's rule; then flash timed at the encoder's
            non-causal 1500 x 1500, the cross-attention at prefill and at
            decode, and the decoder's self-attention;
20. serve   the VLM main path at full width: internvl2-26b (48 layers,
            d_model 6144, 48:8 heads, head_dim 128, d_ff 16384, vocab 92553,
            bf16, 19,862,722,560 parameters, not cut) with ``img_embeds``
            [8, 256, 6144] (numpy, seed 0) before the prompts: a 384-row
            prefill, decode from position 384; 48 x 64 flash launches;
            phase 8's rule;
21. serve   the hybrid main path at full width, cut to 16 of its 32 layers
            (103 GB whole does not fit the card): jamba-v0.1-52b (14 Mamba
            and 2 attention layers, d_model 4096, 32:8 heads, MoE of 16
            experts top-2 on odd layers, d_ff 14336, bf16, 26,053,480,448
            parameters); 128 flash launches, 14 on the scan's prefill kernel
            and 882 on its decode kernel; held by the MoE rule with both
            ops swapped; flash and the scan timed at the path's inputs;
22. bwd     both backward kernels against their plain versions on the
            card: flash in f32 and bf16 at head_dim 16/32/64/80/112/128,
            GQA groups 1 to 4, causal and full, Sq < Sk, held to the f32
            gradient of the same inputs (2e-5 f32, 2^-6 bf16, relative to
            the largest element); the scan at ragged channels, N 1/4/5/16,
            S 1 to 128, with and without dh, held to the plain backward
            (2e-5); every case launched twice, bit-equal;
23. train   the training main path at full width: smollm-135m (162,826,560
            parameters, bf16, AdamW with an f32 master, remat "full")
            through ``Trainer`` and ``Pipeline`` at the launcher's defaults
            (seq 128, batch 8, lr 3e-3).  First-step gradients of every
            parameter against the plain path (each op swapped for its plain
            version), per leaf within GRAD_BF16_REL of its largest element,
            beside another correct plain version's distance, and wq, wk, wv
            and wo non-zero; 20 steps counted (30 x 2 flash forward and 30
            backward launches a step, no other kernel), loss falling; a
            crash at step 5 by ``fail_hook``, resumed from the async
            checkpoint of step 4, reaches the uninterrupted run's
            parameters at step 8 bit for bit; the flash backward at one of
            the main path's backward calls against the f32 gradient and
            the plain backward, timed beside its bound and SDPA's backward;
            a timed stretch at seq 1024, batch 16: step ms, tokens/s, peak
            memory and the model-FLOPs share of the bf16 dense peak;
24. train   falcon-mamba-7b at full width cut to 8 of its 64 layers
            (1,375,113,216 parameters): first-step gradients of an f32 copy
            against the plain path within 1e-4 of the largest element, and
            in_proj, a_log, x_proj, dt_proj and conv non-zero; 20 steps of
            ``make_train_step`` with int8 moments (8 x 2 scan forward, all
            on the prefill kernel, and 8 backward launches a step), loss
            falling; the scan backward at the main path's inputs timed
            beside its bound;
25. qat     the jet tagger's QAT workflow through its example entry point
            (``python -m repro_torch.examples.train_jet_tagger``) on the
            JAX example's keys (its weights, class centres and batches,
            drawn on the card: one threefry launch a layer, the centres and
            each batch's labels and features counted): 300 steps, both
            compile strategies, the design bit-exact to the float model,
            served through ``ServeEngine`` on the adder-graph kernel;
26. shard   the sharded path on the card: a one-rank NCCL group (a
            ``FileStore`` in a temporary directory) and a 1x1 ("data",
            "model") mesh.  smollm-135m at full width: one train step under
            the sharding rules (parameters, optimizer state and batch as
            DTensors; the flash forward and backward kernels on each rank's
            shard through ``local_map``) bit for bit with the unsharded
            step, parameters and optimizer state leaf by leaf, with the same
            launches (30 x 2 flash forward, 30 backward); prefill and 32
            greedy ``decode_step``s under the rules, tokens and logits bit
            for bit with the unsharded loop (30 x 33 flash launches); the
            committed ``jamba_smoke`` asset's prefill and 7 greedy decode
            steps under the rules (the scan and the MoE dispatch inside
            ``local_map``) bit for bit with the unsharded loop and equal to
            the JAX engine's golden tokens; a checkpoint written sharded,
            restored with ``shardings=`` and without, exactly; the process
            group destroyed;
27. launch  ``launch.hlo_analysis.analyze`` on phase 23's smollm-135m train
            step (seq 1024, batch 16): its FLOPs within 1% of what the
            model's matrix products come to (the layers' 8N a token under
            remat "full" but the last product of each period, which the
            checkpoint's early stop does not run again, the tied head's
            6N, and no attention: the flash kernels are no aten ops),
            printed beside ``train_flops``; the three H100 roofline terms
            (data-sheet peaks) beside phase 23's measured step, as shares
            of it; the dry-run CLI (``--arch smollm-135m,qwen3-moe-30b-a3b
            --shape train_4k,decode_32k``, one process for each production
            mesh, the fake process group, CPU only) started in the
            background before phase 26 (after every phase that times the
            host), awaited here within its time limit, its eight rows
            printed, each "ok".  Phases 26-27 must leave allocated memory within
            1 MiB of its level before phase 26.
28. examples the twins of the JAX package's examples, each driven
            through its ``main`` on the card at its defaults, counted:
            ``quickstart`` (``x @ M`` through exactly one adder-graph
            launch, whose output equals its plain version's on the same
            tensor); ``serve_lm`` (smollm-135m's smoke model trained 60
            steps and serving 4 requests, then again with ``--arch
            falcon-mamba-7b``: the loss falls, flash (scan) forward and
            backward launches as layers x steps say and no other kernel,
            the served tokens equal to the same engine's with every op
            swapped for its plain version, or held by phase 8's
            teacher-forced rule at f32); ``train_lm_resumable`` (a failure
            at step 90 survived, the second Trainer back at step 120 and
            on to 200, flash launches for every step run, the parameters
            at step 120 bit for bit those of an uninterrupted run).  For
            each LM twin the first step's gradients on fresh weights and
            batch 0, kernel path against plain path, leaf by leaf within
            ``BWD_REL["float32"]`` (the backward kernels at the twins'
            shapes: f32 flash at head_dim 16, the scan at state 8).  The
            phase must leave allocated memory within 1 MiB of its level
            before it (cuBLAS workspaces cleared on both sides);
29. prng    the threefry kernel (``kernels/prng``, the port of the
            JAX package's ``jax.random`` draw) against its plain version,
            both on the card: bits and uniforms exactly, normals (f32,
            scaled) within 4 ulp and in bf16 equal but for one-ulp
            roundings, at odd shapes and windows of 1 to 4 merged dims,
            across the count's high word; its device time per call (graph
            replays) beside its bound and the plain version's at the
            largest launch of qwen3-moe-30b-a3b's init; every served
            init of phases 8-21 (each LM path starts with
            ``init_params(cfg, PRNGKey(0))`` on the card, its launches
            zeroed before and read after: one a normal leaf, one a period
            slice of a stacked leaf, and no other kernel); in a process of
            its own, rank 0 of a fake 256-rank group over the production
            16x16 mesh draws its 8.16 GB shard of kimi-k2-1t-a32b
            (``init_params(..., shardings=)``) with the card's peak within
            one chunk of the shard, 10^6 sampled elements against the
            plain version at the same global indices, and one launch over
            the shard's largest leaf (1,343 M elements) timed beside its
            bound.
Phases 23, 25 and 28 draw parameters inside their counted runs (the
Trainer's and the examples' inits, the jet tagger's data): their
launches include the threefry kernel's; phase 26 draws its sharded parameters through ``shardings=``.
Phases 17-21 each start on an emptied card (what stays allocated is
printed) and print the decode step's device time by kernel, launches,
idle share and bytes bound.  Around phase 19 the allocator's snapshot
names what stays allocated: each active block, the live tensor that owns
it and what refers to that tensor, and the blocks phase 19 left; then
the cuBLAS workspaces (one per stream a product ran on, kept by PyTorch)
are cleared, and the snapshot taken again shows which blocks they were.

The line before the last is the ``kernels`` JSON object, with each
source's kernels under ``entry_points``; the last line is ``{"ok": true,
"device": {...}}``.  Without a CUDA card, or without the rest of the
repository beside it, the script fails before printing any result.
"""

from __future__ import annotations

import atexit
import contextlib
import dataclasses
import itertools
import json
import math
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
    for name in sorted(paths):  # ptxas's -v report, from the build's own log
        ptxas[name] = [ln.strip() for ln in _build.build_log(name).splitlines()
                       if "ptxas info" in ln]
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
    from repro_torch.kernels.prng import kernel as prng_kernel
    from repro_torch.kernels.quant_matmul import kernel as qm_kernel
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel

    return {"adder_graph": ag_kernel.launches, "flash_attention": fa_kernel.launches,
            "ssm_scan": ss_kernel.launches, "quant_matmul": qm_kernel.launches,
            "flash_attention_bwd": fa_kernel.bwd_launches, "ssm_scan_bwd": ss_kernel.bwd_launches,
            "prng": prng_kernel.launches, "gumbel_pick": prng_kernel.pick_launches}


def kernel_counters() -> dict:
    """The launch counters by kernel of the sources that hold several, as
    "source.kernel": each launch counted in ``launch_counters`` is also
    counted here under the kernel it took."""
    from repro_torch.kernels.quant_matmul import kernel as qm_kernel
    from repro_torch.kernels.ssm_scan import kernel as ss_kernel

    return {f"{source}.{name}": counter
            for source, mod in (("ssm_scan", ss_kernel), ("quant_matmul", qm_kernel))
            for name, counter in mod.kernel_launches.items()}


def check_only(counts: dict, kernels, what: str) -> None:
    """No kernel but ``kernels`` (a name or a set of them) was launched in
    the run that gave ``counts``."""
    kernels = {kernels} if isinstance(kernels, str) else set(kernels)
    others = {k: v for k, v in counts.items() if k not in kernels and v}
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


PROFILE_TRIES = 3  # a trace with no device time at all is taken again, up to this many times


def profile_once(torch, fn, key: str, keys=(), expect=None) -> dict:
    """One call of ``fn`` under the profiler (ending in a synchronise): the
    device time and launches of all kernels and of those whose profiler
    name contains ``key`` (and, under ``by_key``, each of ``keys``), device
    time by kernel, and the host ops by self CPU time.  Kernels launched
    by a CUDA-graph replay are listed as kernels too.  Now and then the
    profiler returns a trace with no device time in it (seen in a decode
    replay and in a train step, not reproduced on demand), or one that
    lacks a kernel of a graph replay (13 of jamba's 14 scan launches, seen
    twice, one replay each): ``fn`` is then called and profiled again,
    up to ``PROFILE_TRIES`` calls in all, and ``tries`` says how many it
    took.  ``expect`` (a key of ``keys`` -> launches), where given, is what
    one call launches; the caller still checks the last trace's counts."""
    for tries in range(1, PROFILE_TRIES + 1):
        out = _profile_call(torch, fn, key, keys)
        out["tries"] = tries
        short = {k: out["by_key"][k]["launches"] for k, n in (expect or {}).items()
                 if out["by_key"][k]["launches"] != n}
        if out["all_ms"] is not None and not short:
            break
        log(f"the profiler showed no device time or other launches than one call makes "
            f"({short}; try {tries} of {PROFILE_TRIES})")
    return out


def _profile_call(torch, fn, key: str, keys) -> dict:
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    by_kernel, n_by_kernel, launches, key_launches = {}, {}, 0, 0
    for ev in prof.key_averages():
        if not str(getattr(ev, "device_type", "")).endswith("CUDA"):
            continue  # host-side ops; their kernels are listed on their own
        us = getattr(ev, "self_device_time_total", 0.0) or 0.0
        if us > 0:
            by_kernel[ev.key] = by_kernel.get(ev.key, 0.0) + us
            n_by_kernel[ev.key] = n_by_kernel.get(ev.key, 0) + ev.count
            launches += ev.count
            key_launches += ev.count if key in ev.key else 0
    host = sorted(((ev.self_cpu_time_total, ev.count, ev.key) for ev in prof.key_averages()
                   if not str(getattr(ev, "device_type", "")).endswith("CUDA")), reverse=True)
    all_us = sum(by_kernel.values())
    key_us = sum(us for k, us in by_kernel.items() if key in k)
    ranked = sorted(by_kernel.items(), key=lambda kv: -kv[1])
    return {
        "all_ms": all_us / 1e3 if all_us else None,
        "key_ms": key_us / 1e3 if key_us else None,
        "launches": launches,
        "key_launches": key_launches,
        "rank": next((i + 1 for i, (k, _) in enumerate(ranked) if key in k), None),
        "n_kernels": len(ranked),
        "ranked": ranked,
        "host": host,
        "by_key": {k: {"ms": sum(us for n, us in by_kernel.items() if k in n) / 1e3,
                       "launches": sum(c for n, c in n_by_kernel.items() if k in n)}
                   for k in keys},
    }


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
    back) run eagerly and as the replay of a CUDA graph (as the serve
    engine runs it), and, from the profiler's trace, the device time of
    the adder-graph kernel (either entry point) and of all kernels (None
    where the trace shows no device time)."""
    from repro_torch.kernels.graphs import capture

    fwd_ms = time_ms(torch, lambda: design.forward_int(x), iters=20)
    graph = capture(lambda: design.forward_int(x))
    graph_ms_ = time_ms(torch, graph.replay, iters=20)
    prof = profile_once(torch, lambda: design.forward_int(x), "namespace)::adder_graph_")
    return {
        "forward_ms": fwd_ms,
        "forward_graph_ms": graph_ms_,
        "profiler_kernel_ms": prof["key_ms"],
        "profiler_all_kernels_ms": prof["all_ms"],
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
    (8, 32, 32, 128, 128, 80),  # stablelm-3b's prefill, head_dim 80
    (2, 4, 1, 77, 130, 80),  # ragged, head_dim 80
    (1, 8, 2, 128, 128, 112),  # head_dim 112 (kimi-k2's)
    (2, 6, 3, 37, 300, 112),  # ragged, head_dim 112
]
DECODE_OFFSETS = (0, 1, 127, 128, 511)
# (head_dim, GQA group sizes: query heads per KV head) of the decode cases
DECODE_GROUPS = ((64, (1, 3, 4, 8)), (80, (1, 4, 8)), (112, (1, 4, 8)))
GRANITE_DECODE = (8, 48, 1, 128)  # granite-20b's decode: B, Hq, Hkv, head_dim (48 rows)
QWEN3_MOE_DECODE = (8, 32, 4, 128)  # qwen3-moe-30b-a3b's decode: GQA group 8 at head_dim 128
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
        by_dim = {}
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
        decodes = [(8, 3 * group, 3, d, f"decode head_dim {d} group {group}")
                   for d, groups in DECODE_GROUPS for group in groups]
        b, hq, hkv, d = GRANITE_DECODE
        decodes.append((b, hq, hkv, d, f"decode head_dim {d} group {hq // hkv} (granite-20b)"))
        b, hq, hkv, d = QWEN3_MOE_DECODE
        decodes.append((b, hq, hkv, d,
                        f"decode head_dim {d} group {hq // hkv} (qwen3-moe-30b-a3b)"))
        for b, hq, hkv, d, what in decodes:
            for pos in DECODE_OFFSETS:
                k = rand(b, hkv, DECODE_MAX_SEQ, d, dtype=dtype)
                v = rand(b, hkv, DECODE_MAX_SEQ, d, dtype=dtype)
                k[:, :, pos + 1:] = 1e4  # unwritten slots: the mask must hide them
                v[:, :, pos + 1:] = -1e4
                cases.append((f"{what} offset {pos}", rand(b, hq, 1, d, dtype=dtype), k, v,
                              True, torch.tensor(pos, dtype=torch.int32, device=dev)))
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
            d = q.shape[3]
            by_dim[d] = max(by_dim.get(d, 0.0), err)
        errs[dname] = worst
        log(f"  {dname}: {len(cases)} cases, max |kernel - plain| = {worst:.3g} "
            f"(atol {FA_ATOL[dname]}); by head_dim {json.dumps(dict(sorted(by_dim.items())))}; "
            f"cases per kernel and splits: {json.dumps(plans)}")
    return errs


# ----------------------------------------------------------------------
# 7 and 10. reduced LMs against the committed JAX golden outputs
# ----------------------------------------------------------------------
def expected_launches(cfg) -> dict:
    """Kernel launches of one prefill and of one decode step of ``cfg``'s
    stack, by kernel: flash for every attention layer (the encoder's at
    prefill, and each decoder block's cross-attention, of an
    encoder-decoder too), the scan for every Mamba layer."""
    from repro_torch.configs.base import ATTN, SSM

    pattern, n_periods = cfg.layer_pattern()
    n_attn = sum(m == ATTN for m, _ in pattern) * n_periods
    n_ssm = sum(m == SSM for m, _ in pattern) * n_periods
    n_cross = len(pattern) * n_periods if cfg.family == "encdec" else 0
    n_enc = cfg.encoder_layers if cfg.family == "encdec" else 0
    out = {"prefill": {"flash_attention": n_attn + n_cross + n_enc, "ssm_scan": n_ssm},
           "decode": {"flash_attention": n_attn + n_cross, "ssm_scan": n_ssm}}
    return {k: {kern: n for kern, n in v.items() if n} for k, v in out.items()}


def lm_golden(torch, np, dev, asset_name: str) -> dict:
    """The reduced LM of ``assets/<asset_name>`` served on the card, with
    its stored extra inputs: the JAX engine's greedy tokens exactly, its
    logits within ``LM_F32_ATOL``, and each kernel of the stack launched
    as ``expected_launches`` says per step.  Returns the launches."""
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
    extra = {k: torch.from_numpy(golden[k]).to(dev) for k in manifest.get("extra_inputs", [])}
    reqs = [Request(p, int(n)) for p, n in zip(golden["prompts"], golden["max_new_tokens"])]
    eng = Engine(cfg, params, manifest["batch_size"], manifest["max_seq"],
                 eos_id=manifest["eos_id"], device=dev, extra_inputs=extra)
    reset_counts()
    eng.generate(reqs)
    counts = read_counts()
    per_step = expected_launches(cfg)
    check_only(counts, set(per_step["decode"]), f"{asset_name}'s serve")
    want = {k: per_step["prefill"][k] + manifest["decode_steps"] * n
            for k, n in per_step["decode"].items()}
    got = {k: counts[k] for k in want}
    check(got == want, f"{asset_name}: launches {got}, want {want}")
    for i, (r, want_tok) in enumerate(zip(reqs, golden["tokens"])):
        want_tok = [int(t) for t in want_tok if t >= 0]
        check(r.out_tokens == want_tok,
              f"{asset_name}: request {i} tokens {r.out_tokens} != JAX {want_tok}")
    tokens = torch.from_numpy(np.stack([r.prompt for r in reqs])).to(dev)
    logits, cache = prefill(cfg, params, {"tokens": tokens, **extra}, manifest["max_seq"])
    err0 = float(np.abs(logits.cpu().numpy() - golden["prefill_logits"]).max())
    logits, _ = decode_step(cfg, params, logits.argmax(-1)[:, None], cache)
    err1 = float(np.abs(logits.cpu().numpy() - golden["decode_logits"]).max())
    check(max(err0, err1) <= LM_F32_ATOL,
          f"{asset_name}: logits differ from JAX by {err0:.3g} (prefill), {err1:.3g} (decode)")
    log(f"{cfg.name} ({cfg.param_count()} params, f32{', extra inputs ' if extra else ''}"
        f"{', '.join(f'{k} {list(v.shape)}' for k, v in extra.items())}): {len(reqs)} requests' "
        f"greedy tokens equal the JAX engine's; launches {json.dumps(got)} = prefill "
        f"{json.dumps(per_step['prefill'])} + {manifest['decode_steps']} x "
        f"{json.dumps(per_step['decode'])}; max |logits - JAX| prefill {err0:.3g}, decode "
        f"{err1:.3g} (atol {LM_F32_ATOL})")
    return got


# ----------------------------------------------------------------------
# 8, 11, 13, 17, 19-21. an LM main path at full width
# ----------------------------------------------------------------------
PROMPT_LEN, NEW_TOKENS, SERVE_BATCH, SERVE_MAX_SEQ = 128, 64, 8, 512
DECODE_TIMING_OFFSET = 160  # flash: about the mean cache position of the 63 decode steps
DECODE_TIMING_STEP = DECODE_TIMING_OFFSET - PROMPT_LEN + 1  # the decode step that reaches it
JAMBA_LAYERS = 16  # of 32: 2 of the 4 periods (26.05e9 parameters, 52.1 GB in bf16)


def plain_selective_scan_f64(dt, bmat, cmat, x, a, h0, h_out=None):
    """The plain version's recurrence in float64, rounded to f32: another
    correct scan, to measure how far two correct versions drift apart."""
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref

    y, h = selective_scan_ref(*(u.double() for u in (dt, bmat, cmat, x, a, h0)))
    y, h = y.float(), h.float()
    return (y, h) if h_out is None else (y, h_out.copy_(h))


def plain_attention_f32(q, k, v, causal=True, offset=None):
    """The plain attention with every operand in f32 (``p`` is not rounded
    to bf16 before PV, as the decode kernel keeps it), rounded to q's
    dtype: another correct plain version, to measure how far two correct
    versions drift apart."""
    from repro_torch.kernels.flash_attention.ref import attention_ref

    return attention_ref(q.float(), k.float(), v.float(), causal=causal,
                         offset=offset).to(q.dtype)


def stub_inputs(torch, np, cfg, dev) -> dict:
    """The stub front ends' outputs for a served batch, drawn with numpy
    (seed 0) and cast to ``cfg.dtype`` on the card: whisper's
    ``enc_frames`` [8, encoder_seq, d_model], a VLM's ``img_embeds`` [8,
    vision_tokens, d_model]; nothing for the other families."""
    from repro_torch.models.transformer import torch_dtype

    rows = {"encdec": ("enc_frames", cfg.encoder_seq), "vlm": ("img_embeds", cfg.vision_tokens)}
    if cfg.family not in rows:
        return {}
    name, n = rows[cfg.family]
    x = np.random.default_rng(0).standard_normal((SERVE_BATCH, n, cfg.d_model), dtype=np.float32)
    return {name: torch.from_numpy(x).to(dev, torch_dtype(cfg))}


def lm_paths() -> dict:
    """Per served architecture: its ops (each a kernel with its launch
    counter and profiler name, the model module's name for the op that
    reaches it, the plain version that replaces it on the plain path and
    another correct plain version, and which calls of the op to keep for
    timing: name -> (step, index of the call within the step), step 0
    being prefill), the config served (jamba's cut), and how the path is
    held to its plain path."""
    from repro_torch import configs
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.kernels.ssm_scan.ref import selective_scan_ref
    from repro_torch.models import attention, ssm

    flash = {
        "kernel": "flash_attention", "profile_key": "namespace)::flash_",
        "module": attention, "attr": "flash_attention", "plain": attention_ref,
        "plain_alt": plain_attention_f32,
        "capture": {"prefill": (0, 0), "decode": (DECODE_TIMING_STEP, 0)},
    }
    scan = {
        "kernel": "ssm_scan", "profile_key": "namespace)::ssm_",
        "module": ssm, "attr": "selective_scan", "plain": selective_scan_ref,
        "plain_alt": plain_selective_scan_f64,
        "capture": {"prefill": (0, 0), "decode": (1, 0)},
    }
    whisper = configs.get("whisper-base")
    dense = {"ops": [flash], "f32_atol": None, "alt": False,
             "moe": False, "n_layers": None, "cut": None}
    return {
        # 0.3 GB of bf16 weights
        "smollm-135m": dense,
        # 5.6 GB of bf16 weights (head_dim 80)
        "stablelm-3b": dense,
        # 61 GB of bf16 weights (128 experts, head_dim 128, GQA 32:4): held by
        # the MoE rule (phase 17), beside attention kept in f32, another
        # correct plain version that rounds to bf16 at other places
        "qwen3-moe-30b-a3b": {**dense, "alt": True, "moe": True},
        "falcon-mamba-7b": {
            **dense, "ops": [scan],  # 14.5 GB of bf16 weights, 29 GB of f32 draws
            # 64 random bf16 layers amplify a one-ulp f32 difference in the
            # scan's output (it flips a bf16 rounding) into logit differences
            # above LM_BF16_ATOL: two correct plain versions of the scan (f32,
            # and f64 rounded to f32) differ as much.  In f32 the same weights
            # agree within about 1e-3, so the paths are held there, at 1e-2;
            # the bf16 agreement is measured and printed.
            "f32_atol": 1e-2, "alt": True,
        },
        # 0.2 GB: the encoder's 1500 frames, cross-attention, held by phase 8's rule.
        # Prefill calls flash for the 6 encoder layers first, then for each
        # decoder layer its self-attention and its cross-attention; a decode
        # step for each decoder layer's self- and cross-attention
        "whisper-base": {**dense, "ops": [{**flash, "capture": {
            "encoder prefill": (0, 0),
            "prefill": (0, whisper.encoder_layers),
            "cross prefill": (0, whisper.encoder_layers + 1),
            "decode": (DECODE_TIMING_STEP, 0),
            "cross decode": (DECODE_TIMING_STEP, 1)}}]},
        # 39.7 GB: 256 image embeddings before the 128 tokens (a 384-row
        # prefill; decode from position 384), head_dim 128 at GQA 48:8
        "internvl2-26b": {**dense, "alt": True},
        # 52.1 GB at 16 of 32 layers (103 GB whole does not fit 80 GB; 24
        # layers, 77.6 GB, leave no room for caches and workspace): 14 Mamba
        # layers and 2 attention, MoE (16 experts top-2) on the odd ones.
        # Held by the MoE rule with both ops swapped (104 GB in f32)
        "jamba-v0.1-52b": {**dense, "ops": [flash, scan], "alt": True, "moe": True,
                           "n_layers": JAMBA_LAYERS,
                           "cut": f"n_layers 32 -> {JAMBA_LAYERS}: the whole model, 103 GB "
                                  "in bf16, does not fit one 80 GB card"},
    }


def path_config(arch: str, path: dict):
    """The config a path serves: the catalog's, cut where the path says."""
    from repro_torch import configs

    cfg = configs.get(arch)
    return cfg if path["n_layers"] is None else dataclasses.replace(cfg, n_layers=path["n_layers"])


@contextlib.contextmanager
def swapped(swaps):
    """Within the block, each (module, attr, fn) of ``swaps`` has
    ``module.attr`` set to ``fn``; restored after."""
    saved = [(m, a, getattr(m, a)) for m, a, _ in swaps]
    for m, a, fn in swaps:
        setattr(m, a, fn)
    try:
        yield
    finally:
        for m, a, fn in saved:
            setattr(m, a, fn)


def op_swaps(path, which: str) -> list:
    """(module, attr, the op's ``which`` version) for each op of the path:
    ``plain`` or ``plain_alt``."""
    return [(op["module"], op["attr"], op[which]) for op in path["ops"]]


def eager_serve(torch, cfg, params, prompts, dev, path, extra, want) -> dict:
    """The engine's loop run eagerly on the same kernels: prefill, then 63
    greedy decode steps through ``decode_step``, each pick brought to the
    host (``tolist``) as the engine brings it.  Returns the picks per step,
    the loop's prefill ms, decode ms per step and tokens/s, and under
    ``inputs`` (by kernel) the (args, kwargs) of the calls of each op that
    its ``capture`` names: the main path's shapes and values.  (Calls are
    counted from ``want``, the launches per prefill and per step, not
    inspected, so nothing syncs; an op is unwrapped after its last.)"""
    from repro_torch.models import decode_step, prefill

    def clone(v):
        return v.clone() if isinstance(v, torch.Tensor) else v

    def recorder(op, orig, wanted, kept):
        calls = [0]

        def record(*args, **kw):
            name = wanted.get(calls[0])
            if name is not None:
                kept[name] = ([clone(a) for a in args], {k: clone(v) for k, v in kw.items()})
                if len(kept) == len(wanted):
                    setattr(op["module"], op["attr"], orig)
            calls[0] += 1
            return orig(*args, **kw)

        return record

    seen, wraps = {}, []
    for op in path["ops"]:
        kern = op["kernel"]
        pre, dec = want["prefill"][kern], want["decode"][kern]
        wanted = {(i if step == 0 else pre + (step - 1) * dec + i): name
                  for name, (step, i) in op["capture"].items()}
        seen[kern] = {}
        wraps.append((op["module"], op["attr"],
                      recorder(op, getattr(op["module"], op["attr"]), wanted, seen[kern])))
    with swapped(wraps), torch.inference_mode():
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tokens = torch.from_numpy(prompts).to(dev).long()
        logits, cache = prefill(cfg, params, {"tokens": tokens, **extra}, SERVE_MAX_SEQ)
        tok = logits.argmax(-1)
        picks = [tok.tolist()]
        t_first = time.perf_counter()
        for _ in range(NEW_TOKENS - 1):
            logits, cache = decode_step(cfg, params, tok[:, None], cache)
            tok = logits.argmax(-1)
            picks.append(tok.tolist())
        t_end = time.perf_counter()
    for op in path["ops"]:
        got = seen[op["kernel"]]
        check(len(got) == len(op["capture"]), f"eager loop: kept {sorted(got)} of "
                                              f"{op['kernel']}'s calls, want {sorted(op['capture'])}")
    n_tok = SERVE_BATCH * NEW_TOKENS
    return {"picks": picks, "inputs": seen, "prefill_ms": (t_first - t0) * 1e3,
            "decode_ms": (t_end - t_first) * 1e3 / (NEW_TOKENS - 1),
            "tokens_per_s": n_tok / (t_end - t0)}


def requests_for(prompts, new_tokens):
    from repro_torch.serve import Request

    return [Request(p, new_tokens) for p in prompts]


def teacher_forced(torch, cfg, params, prompts, dev, tokens, swaps, extra) -> list:
    """Logits of prefill (with the extra inputs) and of one decode step
    per entry of ``tokens`` but the last, each step fed the given tokens,
    with the ops of ``swaps`` replaced (none: the ops themselves, which
    reach the kernels)."""
    from repro_torch.models import decode_step, prefill

    with swapped(swaps), torch.inference_mode():
        batch = {"tokens": torch.from_numpy(prompts).to(dev), **extra}
        logits, cache = prefill(cfg, params, batch, SERVE_MAX_SEQ)
        out = [logits]
        for tok in tokens[:-1]:
            logits, cache = decode_step(cfg, params, tok[:, None], cache)
            out.append(logits)
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
    return {"atol": atol, "max_abs_diff": worst,
            "n_picks": sum(int(t.numel()) for t in kernel_tokens),
            "n_flips": n_flip, "n_far_flips": n_far, "n_close_picks": n_close}


# ----------------------------------------------------------------------
# 17. the MoE path against the plain path
# ----------------------------------------------------------------------
# MoE rule.  The kernel path is held to the plain path, both teacher-forced
# on the served tokens, by phase 8's end-to-end rule (LM_BF16_ATOL on the
# bf16 logits, far argmax flips none).  The router's logits are rounded to
# bf16 before the f32 softmax, so ties and near-ties among the 128 experts
# are common: a bf16 difference in one attention output can move a token
# to another expert (and, at prefill, another token past its expert's
# capacity), and 48 random layers carry that on.  Where the end-to-end
# rule fails, the failure counts as the model's amplification, not the
# kernel's, only if two correct plain versions (the plain attention with p
# rounded to bf16, and all in f32) fail it as well; the path is then held
# layer by layer: every layer run on the plain path's own input (and
# cache), once with the kernel and once with the plain attention, must
# agree within LAYER_ULPS bf16 steps at each token's largest element on
# every token routed and kept alike by the two.  A token routed otherwise
# (its ordered top-k differs: another expert, or the same ones in another
# order) must have two of its top k+1 plain router logits no further apart
# than twice the largest change of its router logits between the two (two
# experts swap only if each moved by half their gap), and a token kept
# otherwise (its routing alike) is allowed only in a call with such a
# flip: the capacity ranks follow the slot-major order of every pick, so
# one token's flip moves the ranks of later picks.  Routing flips of the
# end-to-end paths are counted by layer, with their margins.
LAYER_ULPS = 8  # at |x| in [4, 8): 0.25, phase 8's LM_BF16_ATOL


def record_routing(torch, calls: list):
    """Wrap the MoE block of the port's transformer so that each call
    appends (each token's top-k expert ids in order [T, k]; its kept ones,
    the dropped as -1, sorted [T, k]; its k-th minus (k+1)-th router logit
    [T]; the smallest gap between consecutive ones of its top k+1 [T]; the
    router logits [T, E] in f32) to ``calls``.  Returns the restore
    function."""
    from repro_torch.models import moe, transformer

    orig = transformer.moe_block

    def recording(cfg, p, x):
        xt = x.reshape(-1, x.shape[-1])
        logits = (xt @ p["router"].to(x.dtype)).float()
        _, _, idx = moe.router_topk(cfg, p["router"], xt)
        _, keep, _ = moe.dispatch_slots(cfg, idx)
        k = cfg.experts_per_token
        kept = torch.where(keep.view(k, -1).t(), idx, -1)
        top = torch.sort(logits, dim=-1, descending=True, stable=True).values[:, :k + 1]
        gaps = top[:, :-1] - top[:, 1:]
        calls.append((idx, kept.sort(-1).values, gaps[:, -1], gaps.amin(-1), logits))
        return orig(cfg, p, x)

    transformer.moe_block = recording
    return lambda: setattr(transformer, "moe_block", orig)


def bf16_step(torch, mag):
    """One bf16 step (8 significant bits) at magnitudes ``mag``."""
    return torch.exp2(torch.floor(torch.log2(mag.clamp_min(2.0 ** -120))) - 7)


def routing_flips(torch, a: list, b: list, n_layers: int) -> dict:
    """Tokens routed to another expert set between two runs (calls in the
    same order, ``n_layers`` MoE layers a step), in total and by layer,
    the first call that differs, the margins of the flips in the second
    run (exact ties, and under one bf16 step), and the tokens routed alike
    but kept otherwise."""
    flips, ties, close, drops, by_layer, first = 0, 0, 0, 0, [0] * n_layers, None
    for i, ((ia, ka, _, _, _), (ib, kb, mb, _, lb)) in enumerate(zip(a, b)):
        diff = (ia.sort(-1).values != ib.sort(-1).values).any(-1)
        drops += int((~diff & (ka != kb).any(-1)).sum())
        n = int(diff.sum())
        if not n:
            continue
        flips += n
        ties += int((diff & (mb == 0)).sum())
        close += int((diff & (mb < bf16_step(torch, lb.abs().amax(-1)))).sum())
        by_layer[i % n_layers] += n
        first = i if first is None else first
    return {"calls": len(a), "token_calls": sum(int(x[0].shape[0]) for x in a),
            "flips": flips, "flips_at_exact_ties": ties, "flips_under_one_bf16_step": close,
            "kept_otherwise": drops, "first_flip_call": first, "flips_by_layer": by_layer}


def moe_layerwise(torch, cfg, params, prompts, dev, tokens, path, extra) -> dict:
    """The plain path teacher-forced on ``tokens``, each layer run twice on
    its own input (and cache, restored between the two): with the kernel
    ops, then with the plain ops (whose output goes on).  Summed over the
    layer calls: the tokens, the routing flips
    between the two (ordered top-k; of them, another expert set) and those
    not explained by their router-logit change, the tokens kept otherwise
    and those in a call without an explained flip, and the largest
    |kernel - plain| over the tokens routed and kept alike, in tolerances
    of LAYER_ULPS bf16 steps at each token's largest element (over 1
    fails)."""
    from repro_torch.models import transformer

    kernel_ops = [(op["module"], op["attr"], getattr(op["module"], op["attr"]))
                  for op in path["ops"]]
    plain_ops = op_swaps(path, "plain")
    orig_block = transformer._apply_block
    stats = []
    routes: list = []

    def checking(*args):
        cache = args[6]  # this layer's cache slice: the SSM's state moves on in place
        saved = None if cache is None else {k: t.clone() for k, t in cache.items()}
        routes.clear()
        with swapped(kernel_ops):
            yk, _ = orig_block(*args)
        if saved is not None:
            for k, t in saved.items():
                cache[k].copy_(t)
        with swapped(plain_ops):
            yp, aux = orig_block(*args)
        yp2, yk2 = yp.reshape(-1, yp.shape[-1]).float(), yk.reshape(-1, yk.shape[-1]).float()
        zero = torch.zeros(yp2.shape[0], dtype=torch.bool, device=yp2.device)
        flip, set_flip, kept_other, unexplained, ties = zero, zero, zero, zero, zero
        if routes:  # a MoE layer: the kernel leg's routing, then the plain leg's
            (ik, kk, _, _, lk), (ip, kp, mp, gp, lp) = routes
            flip = (ik != ip).any(-1)
            set_flip = (ik.sort(-1).values != ip.sort(-1).values).any(-1)
            kept_other = ~flip & (kk != kp).any(-1)
            unexplained = flip & (gp > 2 * (lk - lp).abs().amax(-1))
            ties = mp == 0
        alike = ~flip & ~kept_other
        tol = LAYER_ULPS * bf16_step(torch, yp2.abs().amax(-1))
        ratio = torch.where(alike, (yk2 - yp2).abs().amax(-1) / tol, 0.0)
        n_explained = (flip & ~unexplained).sum()
        stats.append(torch.stack([
            torch.tensor(float(flip.numel()), device=yp2.device), flip.sum().float(),
            unexplained.sum().float(), kept_other.sum().float(),
            torch.where(n_explained > 0, 0, kept_other.sum()).float(), ratio.amax(),
            ties.sum().float(), set_flip.sum().float()]))
        return yp, aux

    restore = record_routing(torch, routes)
    try:
        with swapped([(transformer, "_apply_block", checking)]):
            teacher_forced(torch, cfg, params, prompts, dev, tokens, plain_ops, extra)
    finally:
        restore()
    st = torch.stack(stats).cpu()
    worst = int(st[:, 5].argmax())
    return {"layer_calls": len(stats), "token_calls": int(st[:, 0].sum()),
            "flips": int(st[:, 1].sum()), "expert_set_flips": int(st[:, 7].sum()),
            "unexplained_flips": int(st[:, 2].sum()),
            "kept_otherwise": int(st[:, 3].sum()),
            "kept_otherwise_without_a_flip": int(st[:, 4].sum()),
            "max_diff_in_tolerances": float(st[:, 5].max()),
            "worst_call": {"step": worst // cfg.n_layers, "layer": worst % cfg.n_layers},
            "exact_router_ties_at_top_k": int(st[:, 6].sum()), "layer_ulps": LAYER_ULPS}


def moe_rule(torch, cfg, params, prompts, dev, toks, path, agree, extra) -> dict:
    """Phase 17's and 21's check of the kernel path against the plain path
    (the MoE rule above, every op of the path swapped); returns what it
    measured."""
    e2e, spread = agree["bf16"], agree["bf16_plain_alt_vs_plain"]

    def meets(a):
        return a["n_far_flips"] == 0 and a["max_abs_diff"] <= LM_BF16_ATOL

    runs = {}
    for name, swaps in (("kernel", []), ("plain", op_swaps(path, "plain"))):
        calls: list = []
        restore = record_routing(torch, calls)
        try:
            teacher_forced(torch, cfg, params, prompts, dev, toks, swaps, extra)
        finally:
            restore()
        runs[name] = calls
    pattern, n_periods = cfg.layer_pattern()
    n_moe = sum(ffn == "moe" for _, ffn in pattern) * n_periods
    flips = routing_flips(torch, runs["kernel"], runs["plain"], n_moe)
    del runs
    log("serve: routing of the kernel path against the plain path (both teacher-forced): "
        + json.dumps(flips))
    layer = moe_layerwise(torch, cfg, params, prompts, dev, toks, path, extra)
    log("serve: layer by layer, kernel vs plain on the plain path's input: " + json.dumps(layer))
    out = {**agree, "routing_flips": flips, "layerwise": layer,
           "end_to_end_rule_met": meets(e2e)}
    if meets(e2e):
        log("serve: the end-to-end rule holds (kernel vs plain, bf16 logits)")
        return out
    check(not meets(spread),
          f"serve: kernel vs plain logits fail the end-to-end rule ({json.dumps(e2e)}) where two "
          f"correct plain versions meet it ({json.dumps(spread)})")
    check(layer["unexplained_flips"] == 0,
          f"serve: {layer['unexplained_flips']} routing flips between the kernel and the plain "
          "ops exceed their router-logit change")
    check(layer["kept_otherwise_without_a_flip"] == 0,
          f"serve: {layer['kept_otherwise_without_a_flip']} tokens kept otherwise in a layer "
          "call without a routing flip")
    check(layer["max_diff_in_tolerances"] <= 1.0,
          f"serve: a layer's kernel output is {layer['max_diff_in_tolerances']:.2f} tolerances "
          f"({LAYER_ULPS} bf16 steps) from the plain one, at {layer['worst_call']}")
    log("serve: the end-to-end rule fails for two correct plain versions too; held layer by "
        "layer instead (MoE rule): every layer within tolerance, every routing flip explained")
    return out


def serve_lm(torch, np, dev, arch: str) -> dict:
    """Drive the main path of ``arch`` once, counted; then check it against
    the plain path and time it.  Returns what the kernels line and PERF.md
    need."""
    from repro_torch.models import init_params, prefill
    from repro_torch.models.transformer import init_launches
    from repro_torch.random import PRNGKey
    from repro_torch.serve import Engine
    from repro_torch.tree import tree_leaves

    path = lm_paths()[arch]
    ops = path["ops"]
    cfg = path_config(arch, path)
    want = expected_launches(cfg)
    kernels = sorted(want["decode"])
    # the path starts with its parameters: drawn on the card by the
    # threefry kernel, counted
    reset_counts()
    t0 = time.perf_counter()
    params = init_params(cfg, PRNGKey(0), device=dev)
    torch.cuda.synchronize()
    init = {"s": time.perf_counter() - t0, "launches": read_counts()["prng"],
            "params": cfg.param_count(),
            "gb": sum(t.numel() * t.element_size() for t in tree_leaves(params)) / 1e9}
    check_only(read_counts(), "prng", f"{arch}'s init")
    check(init["launches"] == init_launches(cfg),
          f"{arch}'s init: {init['launches']} threefry launches, want {init_launches(cfg)}")
    extra = stub_inputs(torch, np, cfg, dev)
    torch.cuda.synchronize()
    log(f"{cfg.name}: {cfg.n_layers} layers{' (cut: ' + path['cut'] + ')' if path['cut'] else ''}, "
        f"{cfg.param_count()} params in {cfg.dtype}, random (init_params(cfg, PRNGKey(0)): the "
        f"JAX package's parameters of seed 0, no checkpoint ships), drawn on the card in "
        f"{init['s']:.3f} s by {init['launches']} threefry launches; "
        f"{torch.cuda.memory_allocated() / 1e9:.2f} GB on the card"
        + "".join(f"; {k} {list(v.shape)} {str(v.dtype)[6:]} (numpy seed 0)"
                  for k, v in extra.items()))
    prompts = np.random.default_rng(0).integers(
        2, cfg.vocab_size, size=(SERVE_BATCH, PROMPT_LEN)).astype(np.int32)

    # warm-up of the eager prefill (cuBLAS's choices for these shapes), so
    # neither the served nor the eager loop's prefill pays for it
    with torch.inference_mode():
        prefill(cfg, params, {"tokens": torch.from_numpy(prompts).to(dev).long(), **extra},
                SERVE_MAX_SEQ)
    torch.cuda.synchronize()

    # no EOS id: every request runs its 64 tokens.  The engine captures its
    # decode step here, before the counted run
    t_cap = time.perf_counter()
    eng = Engine(cfg, params, batch_size=SERVE_BATCH, max_seq=SERVE_MAX_SEQ, eos_id=-1,
                 extra_inputs=extra)
    capture_s = time.perf_counter() - t_cap
    # by source (the counters of launch_counters; a source's kernels are counted apart too)
    per_replay = {k: n for k, n in eng.decode_graph.launches_by_kernel().items()
                  if n and k in launch_counters()}
    check(per_replay == want["decode"],
          f"{arch}: the decode graph records {per_replay} launches per replay, want "
          f"{want['decode']}")
    log(f"serve: decode step captured as a CUDA graph in {capture_s:.2f} s (warm-up step "
        f"included); launches per replay, recorded at capture: {json.dumps(per_replay)}")
    picks, stamps = [], []
    pick = eng._pick
    cross_ptrs = [t.data_ptr() for c in eng.static_cache.get("cross", []) for t in c.values()]

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
    launches = {k: counts[k] for k in kernels}
    by_kernel = read_kernel_counts("ssm_scan") if "ssm_scan" in want["decode"] else {}
    check_only(counts, set(kernels), f"{arch}'s serve")
    check(cross_ptrs == [t.data_ptr() for c in eng.static_cache.get("cross", [])
                         for t in c.values()], "serve: the static cross cache was rebound")

    n_tok = sum(len(r.out_tokens) for r in reqs)
    served = {k: want["prefill"][k] + (NEW_TOKENS - 1) * want["decode"][k] for k in kernels}
    check(launches == served, f"serve: launches {launches}, want {served} (prefill "
                              f"{want['prefill']} + {NEW_TOKENS - 1} x {want['decode']})")
    if by_kernel:
        scan = {"prefill": want["prefill"]["ssm_scan"],
                "decode": (NEW_TOKENS - 1) * want["decode"]["ssm_scan"]}
        check(by_kernel == scan, f"serve: the scan's kernels took {by_kernel}, want {scan}")
    check(all(len(r.out_tokens) == NEW_TOKENS for r in reqs), "serve: a request fell short")
    # the logits span the padded vocabulary, and neither this engine nor the
    # JAX engine masks the padding; with random weights an argmax can land
    # there (stablelm-3b: 50,304 ids padded to 50,432)
    check(all(0 <= t < cfg.padded_vocab for r in reqs for t in r.out_tokens),
          "serve: a token outside the logits")
    n_pad = sum(t >= cfg.vocab_size for r in reqs for t in r.out_tokens)
    check(all(bool(torch.isfinite(lg).all()) for lg, _ in picks), "serve: non-finite logits")
    prefill_ms = (stamps[0] - t_start) * 1e3
    decode_ms = (stamps[-1] - stamps[0]) * 1e3 / (len(stamps) - 1)
    log(f"serve (decode graph): {len(reqs)} requests x {NEW_TOKENS} tokens, launches "
        f"{json.dumps(launches)} = prefill {json.dumps(want['prefill'])} + {NEW_TOKENS - 1} x "
        f"{json.dumps(want['decode'])}{'; scan kernels ' + json.dumps(by_kernel) if by_kernel else ''}"
        f"; prefill {prefill_ms:.3f} ms, decode {decode_ms:.3f} ms per step, "
        f"{n_tok / (t_end - t_start):.1f} generated tokens/s ({t_end - t_start:.3f} s for {n_tok} "
        f"tokens); finite logits; {n_pad} tokens in the vocabulary's padding ({cfg.vocab_size} to "
        f"{cfg.padded_vocab})")

    # the same loop eagerly, on the same kernels: the same tokens exactly
    eager = eager_serve(torch, cfg, eng.params, prompts, dev, path, extra, want)
    inputs = eager.pop("inputs")
    served_toks = [[r.out_tokens[i] for r in reqs] for i in range(NEW_TOKENS)]
    n_diff = sum(a != b for a, b in zip(served_toks, eager["picks"]))
    check(n_diff == 0, f"serve: {n_diff} of {NEW_TOKENS} steps' tokens differ between the "
                       "decode graph and the eager loop")
    log(f"serve (eager loop over prefill/decode_step): the same {n_tok} tokens exactly; prefill "
        f"{eager['prefill_ms']:.3f} ms, decode {eager['decode_ms']:.3f} ms per step, "
        f"{eager['tokens_per_s']:.1f} generated tokens/s")
    del eager["picks"]

    # the plain path, teacher-forced on the kernel path's tokens
    toks = [t for _, t in picks]
    t_plain = time.perf_counter()
    plain = teacher_forced(torch, cfg, params, prompts, dev, toks, op_swaps(path, "plain"), extra)
    agree = agreement(torch, [lg for lg, _ in picks], toks, plain, LM_BF16_ATOL)
    log(f"serve: plain path teacher-forced on the kernel path's tokens "
        f"({time.perf_counter() - t_plain:.1f} s), bf16: " + json.dumps(agree))
    if path["alt"]:
        # the spread between two correct plain versions, for scale
        alt = teacher_forced(torch, cfg, params, prompts, dev, toks, op_swaps(path, "plain_alt"),
                             extra)
        spread = agreement(torch, alt, [lg.argmax(-1) for lg in alt], plain, LM_BF16_ATOL)
        del alt
        log(f"serve: the plain path with its ops as "
            f"{', '.join(op['plain_alt'].__name__ for op in ops)}, against the plain path, "
            "bf16: " + json.dumps(spread))
        agree = {"bf16": agree, "bf16_plain_alt_vs_plain": spread}
    del plain
    if path["moe"]:
        agree = moe_rule(torch, cfg, params, prompts, dev, toks, path, agree, extra)
    elif path["f32_atol"] is None:
        e2e = agree["bf16"] if path["alt"] else agree
        check(e2e["n_far_flips"] == 0,
              f"serve: an argmax differs where the plain top-two gap >= {LM_BF16_ATOL}")
        check(e2e["max_abs_diff"] <= LM_BF16_ATOL,
              f"serve: kernel vs plain logits differ by {e2e['max_abs_diff']}")
    else:
        # the same weights in f32: the kernel path against the plain path,
        # both teacher-forced on the served tokens, held to f32_atol
        from repro_torch.models.transformer import tree_map

        t32 = time.perf_counter()
        cfg32 = dataclasses.replace(cfg, dtype="float32")
        params32 = tree_map(lambda t: t.float(), params)
        extra32 = {k: v.float() for k, v in extra.items()}
        k32 = teacher_forced(torch, cfg32, params32, prompts, dev, toks, [], extra32)
        p32 = teacher_forced(torch, cfg32, params32, prompts, dev, toks, op_swaps(path, "plain"),
                             extra32)
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

    step = decode_breakdown(torch, cfg, eng, prompts, dev, ops, per_replay, extra)
    return {"config": {"n_layers": cfg.n_layers, "params": cfg.param_count(), "cut": path["cut"]},
            "launches": launches, "launches_by_kernel": by_kernel,
            "launches_per_replay": per_replay, "capture_s": capture_s,
            "prefill_ms": prefill_ms, "decode_ms": decode_ms,
            "tokens_per_s": n_tok / (t_end - t_start), "eager": eager, "inputs": inputs,
            "kernel_vs_plain": agree, "init": init, **step}


def decode_breakdown(torch, cfg, eng, prompts, dev, ops, per_replay: dict, extra) -> dict:
    """One decode step at cache position ~PROMPT_LEN (after the vision
    tokens of a VLM), run eagerly and as the engine's graph replay: its
    time (host clock over 20 back-to-back steps, ending in a sync) and,
    from the profiler, the device time of the path's kernels (profiler
    names containing each op's ``profile_key``) and of all kernels in one
    step, the step's kernel launches and its idle share.  Neither may sync
    the host.  The profiler's count of each of the path's kernels in one
    replay must equal ``per_replay``, the launches the capture recorded."""
    from repro_torch.models import decode_step, prefill

    graph = eng.decode_graph
    keys = {op["kernel"]: op["profile_key"] for op in ops}
    first = ops[0]["profile_key"]
    with torch.inference_mode():
        batch = {"tokens": torch.from_numpy(prompts).to(dev).long(), **extra}
        logits, cache = prefill(cfg, eng.params, batch, SERVE_MAX_SEQ)
        tok = logits.argmax(-1)[:, None]
        state = {"cache": cache}
        start = PROMPT_LEN + sum(v.shape[1] for k, v in extra.items() if k == "img_embeds")

        def eager_step():
            state["cache"] = decode_step(cfg, eng.params, tok, state["cache"])[1]

        def replay_step():
            eng.static_tokens.copy_(tok)
            graph.replay()

        logits, _ = prefill(cfg, eng.params, batch, SERVE_MAX_SEQ, cache=eng.static_cache)
        out = {}
        for name, step in (("eager", eager_step), ("graph", replay_step)):
            for _ in range(3):
                step()
            torch.cuda.synchronize()
            n = 20
            t0 = time.perf_counter()
            for _ in range(n):
                step()
            torch.cuda.synchronize()
            step_ms = (time.perf_counter() - t0) * 1e3 / n
            # the host's time to enqueue one step (no sync inside), the card idle
            launch_ms = 0.0
            for _ in range(5):
                t1 = time.perf_counter()
                step()
                launch_ms += (time.perf_counter() - t1) * 1e3 / 5
                torch.cuda.synchronize()
            prof = profile_once(torch, step, first, keys=list(keys.values()),
                                expect=None if name == "eager" else
                                {keys[k]: n for k, n in per_replay.items()})
            torch.cuda.set_sync_debug_mode("error")  # a step that waits for the card raises
            try:
                step()
            finally:
                torch.cuda.set_sync_debug_mode("default")
            torch.cuda.synchronize()
            all_ms = prof["all_ms"]
            by_key = {kern: prof["by_key"][key] for kern, key in keys.items()}
            log(f"decode step, {name} (back to back, position ~{start + 3}; no host sync "
                f"inside): {step_ms:.3f} ms; the host enqueues one in "
                f"{launch_ms:.3f} ms; device time: all kernels "
                f"{all_ms if all_ms is None else round(all_ms, 4)} ms in {prof['launches']} "
                f"launches; the path's kernels {json.dumps(by_key)} (rank of {first} "
                f"{prof['rank']} of {prof['n_kernels']} kernels); idle "
                f"{(1 - all_ms / step_ms) * 100 if all_ms else float('nan'):.1f}%")
            for k, us in prof["ranked"][:8]:
                log(f"  {us / 1e3:.4f} ms  {k[:110]}")
            host = prof["host"]
            log(f"  host ops of the step: {sum(h[1] for h in host)} calls, "
                f"{sum(h[0] for h in host) / 1e3:.3f} ms of self CPU time under the profiler; "
                "the largest:")
            for us, cnt, k in host[:6]:
                log(f"    {us / 1e3:.4f} ms  {cnt:5d} x {k[:90]}")
            out[name] = {
                "step_ms": step_ms,
                "enqueue_ms": launch_ms,
                "profiler_all_kernels_ms": all_ms,
                "profiler_launches": prof["launches"],
                "profiler_by_kernel": by_key,
                "kernel_rank": prof["rank"],
                "profiler_tries": prof["tries"],
                "idle_share": 1 - all_ms / step_ms if all_ms else None,
            }
    check(out["graph"]["profiler_all_kernels_ms"] is not None,
          "the profiler shows no device time inside a graph replay: the launches per replay "
          "cannot be cross-checked")
    seen = {kern: v["launches"] for kern, v in out["graph"]["profiler_by_kernel"].items()}
    check(seen == per_replay, f"the profiler sees {seen} launches in one replay, the capture "
                              f"recorded {per_replay}")
    log(f"profiler cross-check: {json.dumps(seen)} launches in one replay = {json.dumps(per_replay)} "
        "recorded at capture")
    return {"decode_step": out, "step_ms": out["graph"]["step_ms"],
            "idle_share": out["graph"]["idle_share"]}


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
# 12. the interpreter fallback; 13. flash at the head dims of stablelm-3b,
# kimi-k2 and granite-20b's group
# ----------------------------------------------------------------------
FALLBACK_FIRES = 3  # the fault plan's raises at serve.dispatch: open, reopen, then recover
FALLBACK_COOLDOWN_MS = 50.0


def serve_fallback(torch, np, mixer_path, x_gold, y_gold, n_steps: int) -> dict:
    """The Mixer behind ``fallback="interpreter"`` with a seeded fault plan
    whose first FALLBACK_FIRES hits of ``serve.dispatch`` raise: the first
    two batches (one per shard) fail and open the breaker, the interpreter
    serves what follows, a probe after the cooldown fails once more
    (reopen), the next one succeeds and the batches go back to the graphs.
    Bursts of the golden inputs, past the cooldown between them, run until
    one whole burst has run on the kernel.  Every output must be golden."""
    from repro_torch.chaos import FaultPlan, FaultRule, active
    from repro_torch.flow import ServeConfig
    from repro_torch.runtime import ServeEngine, load_design

    cfg = ServeConfig(max_batch=256, shards=2, fallback="interpreter", breaker_threshold=2,
                      breaker_cooldown_ms=FALLBACK_COOLDOWN_MS,
                      breaker_cooldown_max_ms=2 * FALLBACK_COOLDOWN_MS)
    plan = FaultPlan([FaultRule("serve.dispatch", rate=1.0, max_fires=FALLBACK_FIRES)], seed=12)
    bursts = []
    reset_counts()
    t0 = time.perf_counter()
    with active(plan), ServeEngine(cfg) as eng:
        # with the fallback, register captures every bucket on every shard
        eng.register("mixer", load_design(mixer_path))
        captured = eng.stats("mixer")["jit_compiles"]
        check(set(captured.values()) == {cfg.shards},
              f"fallback phase: register captured {captured}, want every bucket on "
              f"{cfg.shards} shards")
        for _ in range(8):
            before = eng.stats("mixer")["n_fallback_batches"]
            futs = eng.submit_batch("mixer", x_gold)
            got = np.stack([f.result(120) for f in futs])
            check(np.array_equal(got, y_gold), f"fallback phase: burst {len(bursts)} != golden")
            s = eng.stats("mixer")
            bursts.append({"fallback_batches": s["n_fallback_batches"] - before,
                           "breaker": s["breaker"]["state"]})
            if bursts[-1]["fallback_batches"] == 0 and s["breaker"]["state"] == "closed":
                break
            time.sleep(2 * 2 * FALLBACK_COOLDOWN_MS / 1e3)  # past the (doubled) cooldown
        stats = eng.stats("mixer")
    counts = read_counts()
    fires = plan.stats()["sites"]["serve.dispatch"]["fires"]
    faults = [e for e in stats["flight"]["events"] if e["kind"] == "dispatch_fault"]
    events = [e["kind"] for e in stats["flight"]["events"] if e["kind"] != "dispatch_fault"]
    log(f"fallback: {len(bursts)} bursts of {len(x_gold)} requests, every output golden; "
        f"{json.dumps(bursts)}; {fires} injected faults; breaker events {events}")
    check(fires == FALLBACK_FIRES, f"fallback phase: {fires} faults fired")
    check(len(faults) == fires and all(f["fallback"] and not f["device"] for f in faults),
          f"fallback phase: {len(faults)} dispatch_fault events for {fires} faults, or one "
          "taken for the device's")
    check(stats["n_fallback_batches"] > 0, "fallback phase: no batch was served by the fallback")
    check(stats["breaker"]["n_trips"] >= 1 and stats["breaker"]["state"] == "closed",
          f"fallback phase: breaker {stats['breaker']}")
    check(bursts[-1]["fallback_batches"] == 0, "fallback phase: the probes never went back to "
                                               "the kernel")
    check(stats["n_graph_replays"] + stats["n_fallback_batches"] == stats["n_batches"],
          f"fallback phase: {stats['n_graph_replays']} replays + {stats['n_fallback_batches']} "
          f"fallback batches != {stats['n_batches']} batches")
    want = (stats["n_jit_compiles"] + stats["n_graph_replays"]) * n_steps
    check(counts["adder_graph"] == want,
          f"fallback phase: {counts['adder_graph']} adder-graph launches, want {want}")
    check_only(counts, "adder_graph", "the fallback phase")
    return {"bursts": bursts, "faults": fires, "n_batches": stats["n_batches"],
            "n_fallback_batches": stats["n_fallback_batches"],
            "n_graph_replays": stats["n_graph_replays"], "breaker": stats["breaker"],
            "events": events, "adder_graph_launches": counts["adder_graph"],
            "seconds": time.perf_counter() - t0}


# ----------------------------------------------------------------------
# 14. compile in the port, serve on the card
# ----------------------------------------------------------------------
COMPILED_NETWORKS = {
    "mixer_full": lambda models: models.mlp_mixer_jet(full_size=True),
    "svhn_cnn": lambda models: models.svhn_cnn(),
}


def first_difference(np, got, want) -> str:
    """Where two arrays first differ, for a failure message."""
    if got.shape != want.shape:
        return f"shapes {got.shape} != {want.shape}"
    diff = np.argwhere(got != want)
    if not len(diff):
        return "no element differs"
    idx = tuple(int(i) for i in diff[0])
    return f"{len(diff)} elements differ, first at {idx}: {got[idx]!r} != {want[idx]!r}"


def compile_in_port(torch, np, dev, golden: dict, info: dict) -> dict:
    """The committed weights (``params.npz``) compiled by the port itself
    with each committed manifest's ``compile_config`` (``jobs=None``: it
    does not enter the digest): the saved artifact must equal the committed
    one (``arrays_sha256``, resources, reports without wall times) and pass
    ``load_design(verify="strict")``; ``forward_int`` on the card through
    the adder-graph kernel must give the golden outputs exactly, one launch
    per CMVM step, and the float64 ``apply_model`` on the card the design's
    ``forward`` exactly.  Then the port-compiled Mixer is served: one
    ``submit_batch`` burst of 4096 through ``ServeEngine(ServeConfig(
    max_batch=256, shards=2))``, counts zeroed just before the engine
    starts and read just after it stops; every output golden, no fallback."""
    import tempfile

    from repro_torch.flow import CompileConfig, ServeConfig
    from repro_torch.kernels.adder_graph import kernel as ag_kernel
    from repro_torch.nn import apply_model, compile_model, models, params_from_numpy
    from repro_torch.nn.compiler import count_cmvm_steps
    from repro_torch.runtime import ServeEngine, load_design, save_design

    def without_times(reports):
        return [{k: v for k, v in r.items() if k != "solver_time_s"} for r in reports]

    out, designs = {}, {}
    with tempfile.TemporaryDirectory(prefix=".chip_smoke_", dir=ROOT) as tmp:
        for name, build in COMPILED_NETWORKS.items():
            model, in_shape, in_quant = build(models)
            committed = json.loads((ASSETS / name / "manifest.json").read_text())
            with np.load(ASSETS / name / "params.npz") as z:
                params = params_from_numpy(z, device=dev, model=model)
            cfg = CompileConfig.from_dict({**committed["compile_config"], "jobs": None})
            t0 = time.perf_counter()
            design = compile_model(model, params, in_shape, in_quant, config=cfg, device=dev)
            compile_s = time.perf_counter() - t0
            st = design.solver_stats
            manifest = json.loads((save_design(design, Path(tmp) / name) / "manifest.json")
                                  .read_text())
            for key in ("arrays_sha256", "resources", "compile_config_digest"):
                check(manifest[key] == committed[key],
                      f"{name}: the port's compile gives {key} {manifest[key]}, the committed "
                      f"artifact {committed[key]}")
            check(without_times(manifest["reports"]) == without_times(committed["reports"]),
                  f"{name}: the port's layer reports differ from the committed ones")
            t0 = time.perf_counter()
            loaded = load_design(Path(tmp) / name, device=dev, verify="strict")
            strict_s = time.perf_counter() - t0
            check(loaded.solver_stats["verify"]["ok"], f"{name}: verify='strict' found errors")
            check(design.device == dev, f"{name}: the compiled design is on {design.device}")

            x_gold, y_gold = golden[name]
            xg = torch.from_numpy(x_gold).to(dev)
            n_cmvm = count_cmvm_steps(design.step_specs)
            before = ag_kernel.launches.value
            y = design.forward_int(xg).cpu().numpy()
            launched = ag_kernel.launches.value - before
            check(np.array_equal(y, y_gold), f"{name}: the port-compiled design's forward_int "
                  "on the card != JAX golden: " + first_difference(np, y, y_gold))
            check(launched == n_cmvm, f"{name}: {launched} launches for {n_cmvm} CMVM steps")
            # the float front end in float64 on the card, on the grid values
            x64 = xg.to(torch.float64) * in_quant.step
            y_float = apply_model(params, model, x64, in_quant=in_quant).cpu().numpy()
            y_fwd = design.forward(x64).cpu().numpy().astype(np.float64)
            check(np.array_equal(y_float, y_fwd),
                  f"{name}: float64 apply_model on the card != forward: "
                  + first_difference(np, y_float, y_fwd))
            out[name] = {
                "compile_s": compile_s, "solve_phase_s": st["solve_phase_s"],
                "verify_wall_s": st["verify"]["wall_s"], "verify_tier": st["verify"]["tier"],
                "strict_load_s": strict_s, "n_solves": st["n_solves"],
                "n_pool_solves": st["n_pool_solves"], "pool_fallback": st["pool_fallback"],
                "total_adders": manifest["resources"]["total_adders"],
                "arrays_sha256": manifest["arrays_sha256"][:12],
                "forward_int_launches": launched,
            }
            log(f"{name}: compiled in the port in {compile_s:.2f} s (solve phase "
                f"{st['solve_phase_s']:.2f} s, {st['n_solves']} solves, pool "
                f"{st['n_pool_solves']} solves, pool_fallback {st['pool_fallback']}; verify "
                f"'{st['verify']['tier']}' {st['verify']['wall_s']:.2f} s); arrays_sha256 "
                f"{manifest['arrays_sha256'][:12]} = committed; strict load {strict_s:.2f} s; "
                f"{len(y)} golden outputs bit-exact on the card in {launched} launches; "
                f"float64 apply_model == forward on the card [{info['nvidia_smi']}]")
            designs[name] = design
            del params, loaded

    x_gold, y_gold = golden["mixer_full"]
    n_steps = count_cmvm_steps(designs["mixer_full"].step_specs)
    reps = 4
    reset_counts()
    with ServeEngine(ServeConfig(max_batch=256, shards=2), device=dev) as eng:
        eng.register("mixer", designs["mixer_full"])
        t0 = time.perf_counter()
        futs = eng.submit_batch("mixer", np.concatenate([x_gold] * reps))
        got = np.stack([f.result(120) for f in futs])
        t_done = time.perf_counter()
        stats = eng.stats("mixer")
    counts = read_counts()
    check(np.array_equal(got, np.concatenate([y_gold] * reps)),
          "the port-compiled Mixer's served outputs != JAX golden")
    check(stats["n_fallback_batches"] == 0, "compile phase: fallback batches")
    check(stats["n_graph_replays"] == stats["n_batches"],
          f"compile phase: {stats['n_graph_replays']} replays for {stats['n_batches']} batches")
    want = (stats["n_jit_compiles"] + stats["n_batches"]) * n_steps
    check(counts["adder_graph"] == want,
          f"compile phase: {counts['adder_graph']} adder-graph launches, want {want}")
    check_only(counts, "adder_graph", "the port-compiled Mixer's serve")
    out["serve"] = {"requests": len(futs), "req_per_s": len(futs) / (t_done - t0),
                    "n_batches": stats["n_batches"], "n_jit_compiles": stats["n_jit_compiles"],
                    "adder_graph_launches": counts["adder_graph"]}
    log(f"serve: the port-compiled Mixer, {len(futs)} requests all golden, "
        f"{out['serve']['req_per_s']:.0f} req/s, {stats['n_batches']} batches, "
        f"{counts['adder_graph']} adder-graph launches = ({stats['n_jit_compiles']} captures + "
        f"{stats['n_batches']} replays) x {n_steps}")
    return out, designs["mixer_full"]


# ----------------------------------------------------------------------
# 15. the flow facade: versioned rollouts on the card
# ----------------------------------------------------------------------
ROLLOUT_CYCLES = 5
# allocated device memory after a register/drain cycle (with one version
# live) may differ from the first cycle's by at most this: the drained
# version's graphs and pool are released when its dispatchers stop, and
# what else it held (the design's tables, < 1 MB for the Mixer) goes with
# the garbage collector
ROLLOUT_SLACK_BYTES = 1 << 20


def serve_flow(torch, np, dev, mixer_path, x_gold, y_gold, port_mixer) -> dict:
    """The README quickstart through the port: ``Flow.load`` ->
    ``Flow.serve`` -> ``register`` v1 -> a 4096 burst, during which the
    port-compiled Mixer is registered (its graphs captured) as v2 -> every
    future golden, v1 drained.  Then two jet_tagger designs compiled on
    the card by ``Flow.compile`` from two seeds, rolled v1 -> v2 (v1 kept)
    -> ``activate(1)`` -> ``unregister``, each output its own version's
    ``forward_int``; then ROLLOUT_CYCLES register/drain cycles of the
    Mixer with device memory read after each; and the legacy spelling
    ``ServeEngine(max_batch=256)`` once."""
    import gc
    import warnings

    from repro_torch.flow import CompileConfig, Flow, ServeConfig
    from repro_torch.nn import init_params, models
    from repro_torch.nn.compiler import count_cmvm_steps
    from repro_torch.random import PRNGKey
    from repro_torch.runtime import ServeEngine

    out = {}
    reps = 4
    cfg = ServeConfig(max_batch=256, shards=2)
    n_steps = count_cmvm_steps(port_mixer.step_specs)
    reset_counts()
    t0 = time.perf_counter()
    with Flow.serve(cfg) as dep:
        check(dep.register("mixer", Flow.load(mixer_path)) == 1, "flow: v1 is not version 1")
        v1 = dep.engine._runner("mixer@v1")
        futs = dep.submit_batch("mixer", np.concatenate([x_gold] * reps))
        t_reg = time.perf_counter()
        check(dep.register("mixer", port_mixer, warmup=True) == 2, "flow: v2 is not version 2")
        rollout_s = time.perf_counter() - t_reg
        got = np.stack([f.result(120) for f in futs])
        check(np.array_equal(got, np.concatenate([y_gold] * reps)),
              "flow: v1's futures across the rollout != JAX golden")
        s1 = v1.stats()
        check(s1["n_batches"] > 0 and sum(sh["queue_depth"] for sh in s1["shards"]) == 0,
              "flow: v1 did not drain")
        check(all(not sh._graphs and not sh.is_alive() for sh in v1.shards),
              "flow: the drained v1 kept its graphs")
        check(dep.versions("mixer") == [2] and dep.engine.models() == ["mixer@v2"],
              f"flow: live versions {dep.versions('mixer')}")
        futs = dep.submit_batch("mixer", np.concatenate([x_gold] * reps))
        got = np.stack([f.result(120) for f in futs])
        check(np.array_equal(got, np.concatenate([y_gold] * reps)), "flow: v2's outputs != golden")
        s2 = dep.stats("mixer")
        check(s2["version"] == 2 and s2["n_fallback_batches"] == 0, f"flow: v2 stats {s2}")
        check(s2["jit_compiles"] == {b: cfg.shards for b in s2["buckets"]},
              f"flow: v2 captured {s2['jit_compiles']} at register")
    counts = read_counts()
    want = (s1["n_jit_compiles"] + s1["n_batches"] + s2["n_jit_compiles"]
            + s2["n_batches"]) * n_steps
    check(counts["adder_graph"] == want,
          f"flow: {counts['adder_graph']} adder-graph launches, want {want} (captures + batches "
          f"of both versions, {n_steps} CMVM steps each)")
    check_only(counts, "adder_graph", "the flow rollout")
    out["mixer_rollout"] = {
        "requests": 2 * reps * len(x_gold), "v1_batches": s1["n_batches"],
        "v1_captures": s1["n_jit_compiles"], "v2_captures_at_register": s2["n_jit_compiles"],
        "v2_batches": s2["n_batches"], "register_v2_s": rollout_s,
        "adder_graph_launches": counts["adder_graph"], "seconds": time.perf_counter() - t0}
    log("flow: mixer v1 -> v2 (captured at register while v1 served its burst) " + json.dumps(
        out["mixer_rollout"]))

    # two versions that differ: jet_tagger from two seeds, compiled on the card
    model, in_shape, in_quant = models.jet_tagger()
    jets = []
    t0 = time.perf_counter()
    for seed in (0, 1):
        params, _ = init_params(PRNGKey(seed), model, in_shape, dev)
        jets.append(Flow.compile(model, params, in_shape, in_quant, config=CompileConfig(),
                                 device=dev))
    compile_s = time.perf_counter() - t0
    q = in_quant.qint
    xj = np.random.default_rng(0).integers(q.lo, q.hi + 1, size=(4096, *in_shape)).astype(np.int32)
    wants = [d.forward_int(torch.from_numpy(xj).to(dev)).cpu().numpy() for d in jets]
    check(not np.array_equal(*wants), "flow: the two jet_tagger versions agree")

    def burst(dep, want, what):
        got = np.stack([f.result(120) for f in dep.submit_batch("jet", xj)])
        check(np.array_equal(got, want), f"flow: jet_tagger {what} != its forward_int")

    with Flow.serve(ServeConfig(max_batch=256, shards=2)) as dep:
        dep.register("jet", jets[0])
        burst(dep, wants[0], "v1")
        dep.register("jet", jets[1], drain=False)
        check(dep.versions("jet") == [1, 2], f"flow: jet versions {dep.versions('jet')}")
        burst(dep, wants[1], "v2")
        dep.activate("jet", 1)
        burst(dep, wants[0], "v1 after rollback")
        dep.unregister("jet")
        check(dep.models() == [] and dep.engine.models() == [], "flow: jet not unregistered")
    out["jet_rollout"] = {"compile_s": compile_s, "requests": 3 * len(xj),
                          "adders": [d.total_adders for d in jets]}
    log("flow: jet_tagger v1 -> v2 (v1 kept) -> activate(1) -> unregister, every output its "
        "version's forward_int: " + json.dumps(out["jet_rollout"]))

    # register/drain cycles: device memory must not grow with the rollouts
    mem = []
    with Flow.serve(ServeConfig(max_batch=256, shards=2)) as dep:
        for cycle in range(ROLLOUT_CYCLES):
            # v(n) drained once v(n+1) is live; every bucket captured at register,
            # so each cycle allocates the same graphs whatever batches the burst forms
            dep.register("mixer", mixer_path, warmup=True)
            got = np.stack([f.result(120) for f in dep.submit_batch("mixer", x_gold)])
            check(np.array_equal(got, y_gold), f"flow: cycle {cycle} != golden")
            torch.cuda.synchronize()
            row = {"cycle": cycle + 1, "allocated": torch.cuda.memory_allocated(),
                   "reserved": torch.cuda.memory_reserved()}
            gc.collect()
            row["allocated_after_gc"] = torch.cuda.memory_allocated()
            mem.append(row)
            log("flow: rollout cycle " + json.dumps(row))
        check(dep.versions("mixer") == [ROLLOUT_CYCLES], f"flow: versions {dep.versions('mixer')}")
        # a drained version's graph pool goes back to the allocator's cache,
        # which returns it to the card on empty_cache() or when an allocation
        # would otherwise fail: reserved memory may grow by a pool a cycle,
        # but none of it stays pinned
        torch.cuda.empty_cache()
        reserved = torch.cuda.memory_reserved()
        check(reserved <= mem[0]["reserved"],
              f"flow: {reserved} bytes reserved after empty_cache(), {mem[0]['reserved']} after "
              "the first cycle")
        log(f"flow: after empty_cache() with version {ROLLOUT_CYCLES} live: {reserved} bytes "
            f"reserved, {torch.cuda.memory_allocated()} allocated")
    base = mem[0]["allocated_after_gc"]
    for row in mem[1:]:
        check(abs(row["allocated_after_gc"] - base) <= ROLLOUT_SLACK_BYTES,
              f"flow: allocated memory {row['allocated_after_gc']} after cycle {row['cycle']}, "
              f"{base} after the first (bound {ROLLOUT_SLACK_BYTES} bytes)")
        check(row["allocated"] - base <= 2 * ROLLOUT_SLACK_BYTES,
              f"flow: allocated memory before collection {row['allocated']} after cycle "
              f"{row['cycle']}, {base} after the first")
    out["memory"] = mem
    out["reserved_after_empty_cache"] = reserved

    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        legacy = ServeEngine(max_batch=256)
    check(legacy.config == ServeConfig(max_batch=256), f"flow: legacy config {legacy.config}")
    check(any(issubclass(w.category, DeprecationWarning) for w in caught),
          "flow: ServeEngine(max_batch=256) did not warn")
    legacy.shutdown()
    log("flow: ServeEngine(max_batch=256) warns DeprecationWarning and equals "
        "ServeEngine(ServeConfig(max_batch=256))")
    return out


# ----------------------------------------------------------------------
# 16. the co-sim gate with the device leg on the card
# ----------------------------------------------------------------------
def cosim_on_card(torch, dev) -> dict:
    """``cosim_grid(jit="require")``: RTL == DAIS interpreter == the
    adder-graph kernel on all 34 programs of ``default_grid()``, one
    kernel launch per program's table; every case's report equal to a CPU
    run of the same grid (the plain version as the device leg)."""
    from repro_torch.core import cosim_grid, default_grid

    n_cases = len(default_grid())
    reset_counts()
    t0 = time.perf_counter()
    rep = cosim_grid(jit="require", device=dev)
    card_s = time.perf_counter() - t0
    counts = read_counts()
    check(rep["n_cases"] == n_cases == 34, f"cosim: {rep['n_cases']} cases")
    bad = [r["name"] for r in rep["cases"] if not (r["bit_exact"] and r["latency_ok"])]
    check(not bad, f"cosim: RTL != interpreter or latency off in {bad}")
    check(rep["jit"] == {"checked": n_cases, "skipped": 0, "ok": True},
          f"cosim: device leg {rep['jit']}")
    check(rep["all_bit_exact"], "cosim: not bit-exact on every leg")
    check(counts["adder_graph"] == n_cases,
          f"cosim: {counts['adder_graph']} adder-graph launches for {n_cases} tables")
    check_only(counts, "adder_graph", "the co-sim grid")
    t0 = time.perf_counter()
    cpu = cosim_grid(jit="require", device="cpu")
    cpu_s = time.perf_counter() - t0
    diff = [a["name"] for a, b in zip(rep["cases"], cpu["cases"]) if a != b]
    check(not diff, f"cosim: the card's reports differ from the CPU run's in {diff}")
    out = {"cases": n_cases, "bit_exact": rep["n_bit_exact"], "jit": rep["jit"],
           "adder_graph_launches": counts["adder_graph"], "card_s": card_s, "cpu_s": cpu_s,
           "external": rep["external"]}
    log("cosim: " + json.dumps(out) + "; every case's report equals the CPU run's")
    return out


def head_dim_inputs(torch, dev) -> dict:
    """Flash inputs of the main path's shapes at the head dims and groups
    of models phase 13 does not serve: kimi-k2's (64:8 heads, head_dim
    112) and qwen3-moe's (32:4, head_dim 128; phase 17 serves it), at
    decode (cache of 512, offset DECODE_TIMING_OFFSET) and at a 128-token
    prefill, and granite-20b's 48:1 decode (head_dim 128: 48 packed rows,
    the prefill kernels).  Random bf16 values, seed 3."""
    gen = torch.Generator(dev).manual_seed(3)

    def rand(*shape):
        return torch.randn(shape, generator=gen, device=dev).to(torch.bfloat16)

    off = torch.tensor(DECODE_TIMING_OFFSET, dtype=torch.int32, device=dev)
    out = {}
    for name, (b, hq, hkv, d) in (("kimi-k2 head_dim 112", (SERVE_BATCH, 64, 8, 112)),
                                  ("granite-20b 48:1", GRANITE_DECODE),
                                  ("qwen3-moe head_dim 128 32:4", QWEN3_MOE_DECODE)):
        out[f"{name} decode"] = ([rand(b, hq, 1, d), rand(b, hkv, SERVE_MAX_SEQ, d),
                                  rand(b, hkv, SERVE_MAX_SEQ, d)], {"causal": True, "offset": off})
    for name, (b, hq, hkv, d) in (("kimi-k2 head_dim 112", (SERVE_BATCH, 64, 8, 112)),
                                  ("qwen3-moe head_dim 128 32:4", QWEN3_MOE_DECODE)):
        out[f"{name} prefill"] = ([rand(b, hq, PROMPT_LEN, d), rand(b, hkv, PROMPT_LEN, d),
                                   rand(b, hkv, PROMPT_LEN, d)], {"causal": True})
    return out


# ----------------------------------------------------------------------
def decode_bound(cfg, n_img: int = 0) -> dict:
    """The least time of one decode step at batch SERVE_BATCH, dense over
    any experts as the model computes it: every weight a decode step reads
    (all but the embedding table and an encoder's) read once (bf16); each
    attention layer's K/V read up to the mean cache position of the served
    decode steps (after ``n_img`` vision tokens), an encoder-decoder's
    cross K/V whole; each Mamba layer's f32 state read and written and its
    conv window read; at HBM_BYTES_PER_S."""
    import math

    from repro_torch.configs.base import ATTN, SSM
    from repro_torch.models import param_specs
    from repro_torch.models.transformer import tree_map

    sizes = []
    tree_map(lambda spec: sizes.append(math.prod(spec.shape)),
             {k: v for k, v in param_specs(cfg).items()
              if k not in ("embed", "enc_blocks", "enc_final_norm")})
    weight_bytes = 2 * sum(sizes)
    pattern, n_periods = cfg.layer_pattern()
    n_attn = sum(m == ATTN for m, _ in pattern) * n_periods
    n_ssm = sum(m == SSM for m, _ in pattern) * n_periods
    mean_pos = n_img + PROMPT_LEN + (NEW_TOKENS - 1) / 2
    kv = 2 * 2 * SERVE_BATCH * cfg.n_kv_heads * cfg.hd  # bf16 K and V, per cached position
    kv_bytes = n_attn * kv * mean_pos
    if cfg.family == "encdec":
        kv_bytes += len(pattern) * n_periods * kv * cfg.encoder_seq
    ssm_bytes = n_ssm * SERVE_BATCH * cfg.d_inner * (2 * 4 * cfg.ssm_state + 2 * (cfg.ssm_conv - 1))
    step_ms = (weight_bytes + kv_bytes + ssm_bytes) / HBM_BYTES_PER_S * 1e3
    return {"weight_bytes": weight_bytes, "kv_bytes": kv_bytes, "ssm_state_bytes": ssm_bytes,
            "step_ms": step_ms, "tokens_per_s": SERVE_BATCH / step_ms * 1e3}


def fresh_card(torch) -> None:
    """Free what the earlier phases left (engines and weights, reference
    cycles included) and print what stays allocated."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    log(f"before: {torch.cuda.memory_allocated() / 1e9:.3f} GB allocated, "
        f"{torch.cuda.memory_reserved() / 1e9:.3f} GB reserved on the card")
    torch.cuda.reset_peak_memory_stats()


HEAD_DIM_KEYS = ("shape", "plan", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                 "max_abs_err")


def serve_phase(torch, np, dev, arch: str, flash_entry: dict, scan_entry: dict,
                info: dict) -> dict:
    """Phases 17 and 19-21: serve ``arch`` at full width on an emptied
    card, its decode step against its bytes bound, then flash (and the
    scan) timed at the path's own inputs; the kernels line takes the
    launches and the rows."""
    fresh_card(torch)
    log(f"card: {info['nvidia_smi']}")
    out = serve_lm(torch, np, dev, arch)
    cfg = path_config(arch, lm_paths()[arch])
    out["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["bound"] = decode_bound(cfg, cfg.vision_tokens if cfg.family == "vlm" else 0)
    log(f"{arch}: peak {out['peak_allocated_gb']:.3f} GB allocated; decode step bound "
        f"{json.dumps(out['bound'])}; the replayed step {out['step_ms']:.3f} ms, "
        f"{out['step_ms'] / out['bound']['step_ms']:.2f}x the bound")
    inputs = out.pop("inputs")
    tag = arch.replace("-", "_").replace(".", "")
    for kern, entry in (("flash_attention", flash_entry), ("ssm_scan", scan_entry)):
        if kern not in inputs:
            continue
        named = {f"{arch} {k}": v for k, v in inputs[kern].items()}
        rows = flash_times(torch, named) if kern == "flash_attention" else scan_times(
            torch, named, info)
        entry.setdefault("paths", {}).update(
            {name: {k: row.get(k) for k in (*HEAD_DIM_KEYS, "kernel", "l2_warm_ms")
                    if k in row} for name, row in rows.items()})
        entry[f"launches_{tag}"] = out["launches"][kern]
        entry["max_abs_err"] = max(entry["max_abs_err"], *(r["max_abs_err"] for r in rows.values()))
    log("serve summary: " + json.dumps(out))
    return out


# ----------------------------------------------------------------------
# 22-25. training: the backward kernels, smollm-135m and falcon-mamba-7b
# trained at full width, the jet tagger's QAT workflow
# ----------------------------------------------------------------------
TRAIN_SEQ, TRAIN_BATCH = 128, 8  # the launcher's defaults
TRAIN_STEPS, CRASH_AT, CKPT_EVERY, RESUME_STEPS = 20, 5, 4, 8
LONG_SEQ, LONG_BATCH, LONG_STEPS = 1024, 16, 5  # the timed stretch
# of 64 layers: the whole 7.27 B with its state does not fit.  20 steps, as
# phase 23: the first 10 train at warm-up rates up to 3e-4, where the loss
# moves less than it differs between batches (11.530-11.609 at init on the
# JAX package's weights), so over 10 steps "the loss falls" tossed a coin
FALCON_TRAIN_LAYERS, FALCON_STEPS = 8, 20
# bf16 gradients of the kernel path against the plain path, per leaf,
# relative to the leaf's largest element: the flash backward rounds P and
# dS to bf16 where the plain backward keeps f32, and 30 bf16 layers carry
# that on; the two correct plain versions (p rounded to bf16 before PV,
# and all f32) are printed beside it
GRAD_BF16_REL = 2**-4
GRAD_F32_REL = 1e-4  # f32 gradients, relative to the model's largest element
BWD_REL = {"float32": 2e-5, "bfloat16": 2**-6}  # a backward kernel against the f32 gradient
# the forward's stored log-sum-exp (base 2, f32) against attention_lse_ref:
# another summation order and exp2.approx, within 1e-4 + 1e-5 |lse|
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5
BWD_FLASH_CASES = (  # (B, Hq, Hkv, Sq, Sk, D, causal)
    (2, 9, 3, 128, 128, 64, True),  # smollm-135m's step, cut to batch 2
    (2, 4, 4, 33, 33, 16, True),
    (1, 8, 2, 40, 40, 80, True),
    (2, 4, 1, 17, 40, 32, True),  # Sq < Sk, end-aligned
    (2, 6, 2, 70, 70, 112, False),
    (1, 4, 2, 100, 130, 128, False),
)
# the regimes the other families train in, drawn from a generator of their
# own so that the cases above and the scan's keep their inputs
BWD_FLASH_FAMILY_CASES = (
    (1, 3, 3, 1, 33, 64, True),  # one query row: the decode kernel writes the lse
    (2, 32, 4, 100, 100, 128, True),  # qwen3-moe's 32:4, group 8, head_dim 128
    (1, 48, 8, 72, 72, 128, True),  # internvl2's 48:8, group 6
    (2, 8, 8, 40, 1500, 64, False),  # whisper's cross-attention over 1,500 frames
)
# kernel names summed in a train step's profile: the backward kernels, the
# forward kernels, cuBLAS's GEMMs (by their Hopper names) and PyTorch's
# element-wise kernels
TRAIN_PROFILE_KEYS = ("fa_bwd", "ssm_bwd", "flash_mma", "ssm_prefill", "nvjet", "xmma", "gemm",
                      "elementwise")


def rel_err(got, want) -> float:
    return float((got.float() - want.float()).abs().max()) / max(float(want.float().abs().max()),
                                                                  1e-6)


def flash_fwd_lse(torch, q, k, v, causal=True):
    """The forward as the training path launches it: (out, lse)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_cuda

    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return flash_attention_cuda(q, k, v, causal=causal, lse=lse), lse


def scan_fwd_states(torch, args):
    """The scan forward as the training path launches it: its chunk states."""
    from repro_torch.kernels.ssm_scan.kernel import chunk_states_shape, selective_scan_cuda

    b, s, d = args[0].shape
    hc = torch.empty(chunk_states_shape(b, s, d, args[4].shape[1]), device=args[0].device)
    selective_scan_cuda(*args, chunk_states=hc)
    return hc


def bwd_cases(torch, dev) -> float:
    """Both backward kernels against their plain versions on the card: flash
    in f32 and bf16 at the head dims and GQA groups of the forward and of
    the families that train (group 8 and 6 at head_dim 128, non-causal over
    1,500 keys), causal and full, Sq < Sk, one query row, held to the f32
    gradient of the same inputs, its forward's stored log-sum-exp to the
    plain one; the scan at ragged channels, N 1/5/12/16, S 1/33/128, with
    and without dh, held to the plain backward, its forward's chunk states
    to the plain ones; every case launched twice, bit-equal, and the
    forward with the training path's output equal to serving's.  Returns
    the largest relative error."""
    from repro_torch.kernels.flash_attention.kernel import (flash_attention_bwd_cuda,
                                                            flash_attention_cuda)
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref, attention_lse_ref
    from repro_torch.kernels.ssm_scan.kernel import selective_scan_bwd_cuda, selective_scan_cuda
    from repro_torch.kernels.ssm_scan.ref import (selective_scan_bwd_ref,
                                                  selective_scan_chunk_states_ref)

    gen = torch.Generator(dev).manual_seed(9)
    gen_family = torch.Generator(dev).manual_seed(10)
    worst = 0.0
    for dtype in (torch.float32, torch.bfloat16):
        for case in BWD_FLASH_CASES + BWD_FLASH_FAMILY_CASES:
            b, hq, hkv, sq, sk, d, causal = case
            g = gen if case in BWD_FLASH_CASES else gen_family
            q, k, v, do = (torch.randn(s, generator=g, device=dev).to(dtype)
                           for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d),
                                     (b, hq, sq, d)))
            o, lse = flash_fwd_lse(torch, q, k, v, causal=causal)
            want_lse = attention_lse_ref(q, k, causal=causal)
            fin = torch.isfinite(want_lse)
            lse_err = float(((lse - want_lse)[fin].abs()
                             / (LSE_ATOL + LSE_RTOL * want_lse[fin].abs())).max())
            check(torch.equal(o, flash_attention_cuda(q, k, v, causal=causal))
                  and torch.equal(torch.isinf(lse), torch.isinf(want_lse)) and lse_err <= 1,
                  f"flash forward {str(dtype)[6:]} q {[b, hq, sq, d]}: the training launch's "
                  f"output differs from serving's, or its lse is off the plain one "
                  f"({lse_err} of the tolerance)")
            got = flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal)
            again = flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal)
            want = attention_bwd_ref(q.float(), k.float(), v.float(), do.float(), causal=causal)
            err = max(rel_err(g, w) for g, w in zip(got, want))
            check(err <= BWD_REL[str(dtype)[6:]] and all(map(torch.equal, got, again)),
                  f"flash backward {str(dtype)[6:]} q {[b, hq, sq, d]} k {[b, hkv, sk, d]} "
                  f"causal={causal}: relative error {err}, or two launches differ")
            worst = max(worst, err)
    for b, s, d, n in ((2, 33, 129, 16), (1, 1, 64, 4), (2, 128, 256, 16), (3, 17, 100, 5),
                       (1, 8, 33, 1), (2, 40, 70, 12)):
        r = lambda *shape: torch.randn(shape, generator=gen, device=dev)  # noqa: E731
        args = (torch.nn.functional.softplus(r(b, s, d) - 1), r(b, s, n), r(b, s, n),
                r(b, s, d), -torch.exp(0.5 * r(d, n)), r(b, d, n))
        hc = scan_fwd_states(torch, args)
        hc_err = rel_err(hc, selective_scan_chunk_states_ref(*args))
        served = selective_scan_cuda(*args)
        check(hc_err <= BWD_REL["float32"]
              and all(map(torch.equal, selective_scan_cuda(*args, chunk_states=hc), served)),
              f"scan forward {[b, s, d, n]}: chunk states {hc_err} off the plain ones, or the "
              f"training launch's outputs differ from serving's")
        for dh in (None, r(b, d, n)):
            dy = r(b, s, d)
            got = selective_scan_bwd_cuda(*args, dy, dh, hc)
            again = selective_scan_bwd_cuda(*args, dy, dh, hc)
            want = selective_scan_bwd_ref(*args, dy, dh)
            err = max(rel_err(g, w) for g, w in zip(got, want))
            check(err <= BWD_REL["float32"] and all(map(torch.equal, got, again)),
                  f"scan backward {[b, s, d, n]} dh={dh is not None}: relative error {err}, or "
                  f"two launches differ")
            worst = max(worst, err)
    return worst


def grad_leaves(torch, cfg, params, batch, swaps=()):
    """The gradient of every parameter (JAX's leaf order) of one
    ``loss_fn`` on ``batch``, with the ops of ``swaps`` replaced."""
    from repro_torch.models import loss_fn
    from repro_torch.tree import tree_leaves

    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    try:
        with swapped(swaps):
            loss, _ = loss_fn(cfg, params, batch)
            grads = torch.autograd.grad(loss, leaves)
    finally:
        for p in leaves:
            p.requires_grad_(False)
    return float(loss.detach()), list(grads)


def grads_against_plain(torch, cfg, params, batch, path, rel_bound, per_leaf, must_move) -> dict:
    """First-step gradients of the kernel path against the plain path (each
    op swapped for its plain version) and, beside them, another correct
    plain version against the plain path; the named parameters' gradients
    must be non-zero."""
    from repro_torch.tree import tree_leaves

    reset_counts()
    loss_k, got = grad_leaves(torch, cfg, params, batch)
    ran = read_counts()
    loss_p, want = grad_leaves(torch, cfg, params, batch, op_swaps(path, "plain"))
    _, alt = grad_leaves(torch, cfg, params, batch, op_swaps(path, "plain_alt"))

    def err(a, b):
        if per_leaf:
            return max(rel_err(x, y) for x, y in zip(a, b))
        top = max(float(y.float().abs().max()) for y in b)
        return max(float((x.float() - y.float()).abs().max()) for x, y in zip(a, b)) / top

    out = {"loss_kernel": loss_k, "loss_plain": loss_p, "rel_err": err(got, want),
           "plain_alt_rel_err": err(alt, want), "bound": rel_bound,
           "per_leaf": per_leaf, "launches": ran}
    check(out["rel_err"] <= rel_bound,
          f"{cfg.name}: first-step gradients of the kernel path {out['rel_err']} off the plain "
          f"path's (bound {rel_bound}; another plain version: {out['plain_alt_rel_err']})")
    by_id = {id(p): g for p, g in zip(tree_leaves(params), got)}
    for block, name in must_move:
        g = by_id[id(params["blocks"][0][block][name])]
        check(float(g.float().abs().max()) > 0, f"{cfg.name}: the gradient of {name} is zero")
    out["nonzero"] = [name for _, name in must_move]
    return out


def record_calls(module, attr: str, calls: list, keep: int = 1):
    """(module, attr, wrapper) that appends the (args, kwargs) of the first
    ``keep`` calls of ``module.attr`` to ``calls``."""
    fn = getattr(module, attr)

    def wrapper(*args, **kw):
        if len(calls) < keep:
            calls.append((args, kw))
        return fn(*args, **kw)

    return (module, attr, wrapper)


def bwd_event_ms(torch, modules, fn) -> dict:
    """Device ms per call of ``fn`` spent in each backward wrapper
    (``modules``: (module, attr) of the ops' backward launches), by CUDA
    events around every launch: where the profiler shows nothing."""
    spans = {attr: [] for _, attr in modules}

    def timed(attr, orig):
        def call(*a, **kw):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            res = orig(*a, **kw)
            end.record()
            spans[attr].append((start, end))
            return res
        return call

    with swapped([(m, attr, timed(attr, getattr(m, attr))) for m, attr in modules]):
        fn()
    torch.cuda.synchronize()
    return {attr: {"ms": sum(a.elapsed_time(b) for a, b in ev), "launches": len(ev)}
            for attr, ev in spans.items()}


def train_profile(torch, fn, step_ms: float, modules) -> dict:
    """A train step's device time by kernel (``profile_once`` of one more
    step, which profiles another step where the trace shows no device
    time) and the device's idle share of the step's wall time.  Where
    every try shows none, the backward kernels are timed with CUDA events
    around their launches in one more step (``bwd_events``), and the
    output says so."""
    prof = profile_once(torch, fn, "_bwd_", keys=TRAIN_PROFILE_KEYS)
    busy = prof["all_ms"]
    out = {"device_ms": busy, "launches": prof["launches"], "profiler_tries": prof["tries"],
           "idle_share": None if busy is None else 1 - busy / step_ms,
           "by_key": prof["by_key"], "top": [(k, us / 1e3) for k, us in prof["ranked"][:10]]}
    if busy is None:
        out["bwd_events"] = bwd_event_ms(torch, modules, fn)
        out["note"] = (f"the profiler showed no device time {PROFILE_TRIES} times: the backward "
                       "kernels are timed with CUDA events around their launches (bwd_events)")
        log(out["note"] + ": " + json.dumps(out["bwd_events"]))
    return out


def timed_train_stretch(torch, cfg, step, params, opt_state, pipe, n_steps, first_step,
                        modules) -> dict:
    """Device-synchronised wall time per train step over ``n_steps`` steps
    (after two warm-up steps), tokens/s and the peak device memory; the
    profile of one more step (``train_profile`` over the backward wrappers
    ``modules``)."""
    batches = [{k: torch.from_numpy(v).to(params["embed"].device)
                for k, v in pipe.batch_at(first_step + i).items()} for i in range(n_steps + 2)]
    for b in batches[:2]:
        params, opt_state, m = step(params, opt_state, b, first_step)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for i, b in enumerate(batches[2:]):
        params, opt_state, m = step(params, opt_state, b, first_step + 2 + i)
    float(m["loss"])
    torch.cuda.synchronize()
    step_s = (time.perf_counter() - t0) / n_steps
    tokens = batches[0]["tokens"].numel()
    out = {"step_ms": step_s * 1e3, "tokens_per_s": tokens / step_s,
           "peak_allocated_gb": torch.cuda.max_memory_allocated() / 1e9,
           "seq": batches[0]["tokens"].shape[1], "batch": batches[0]["tokens"].shape[0],
           "loss": float(m["loss"])}
    # where one more step's device time goes, by kernel
    out["profile"] = train_profile(
        torch, lambda: step(params, opt_state, batches[-1], first_step + n_steps),
        out["step_ms"], modules)
    return out


def train_flops(cfg, seq: int, batch: int) -> float:
    """Model FLOPs of one train step: 6 N per token (N every parameter:
    the tied embedding is the head's product) plus causal attention, 3 x
    (QK^T and PV over the live pairs) per layer and query head."""
    pairs = seq * (seq + 1) // 2
    attn = 3 * 4 * cfg.hd * pairs * cfg.n_heads * cfg.n_layers * batch
    return 6 * cfg.param_count() * seq * batch + attn


def flash_bwd_row(torch, args, kw, calls: int = 20) -> dict:
    """The flash backward at one of the main path's backward calls: held to
    the f32 gradient and the plain backward, then timed beside its bound
    and SDPA's backward (autograd through ``scaled_dot_product_attention``
    less its forward; the library yardstick, which the port never calls)."""
    from repro_torch.kernels.flash_attention.kernel import flash_attention_bwd_cuda
    from repro_torch.kernels.flash_attention.ref import attention_bwd_ref

    q, k, v, o, do, lse = (t.detach() for t in args)
    causal = kw.get("causal", True)
    b, hq, sq, d = q.shape
    hkv, sk = k.shape[1], k.shape[2]
    got = flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal)
    plain = attention_bwd_ref(q, k, v, do, causal=causal)
    want = attention_bwd_ref(q.float(), k.float(), v.float(), do.float(), causal=causal)
    err = max(float((g.float() - w).abs().max()) for g, w in zip(got, want))
    rel = max(rel_err(g, w) for g, w in zip(got, want))
    plain_rel = max(rel_err(p, w) for p, w in zip(plain, want))
    check(rel <= BWD_REL[str(q.dtype)[6:]],
          f"flash backward at the main path's inputs: relative error {rel}")
    import torch.nn.functional as F

    # K/V repeated to the query heads outside the timed calls, so SDPA takes
    # its fused backend (the dK/dV sum over each group is not counted)
    qs, ks, vs = (t.clone().requires_grad_(True) for t in (
        q, k.repeat_interleave(hq // hkv, dim=1), v.repeat_interleave(hq // hkv, dim=1)))

    def lib():
        return F.scaled_dot_product_attention(qs, ks, vs, is_causal=causal)

    def lib_fwd_bwd():
        torch.autograd.grad(lib(), (qs, ks, vs), do)

    start = sk - sq
    pairs = sum(min(max(start + i + 1, 0), sk) for i in range(sq)) if causal else sq * sk
    esz = q.element_size()
    nbytes = esz * 4 * (b * hq * sq * d + b * hkv * sk * d)  # q, o, dO, dq; k, v, dk, dv
    flops = 10 * d * b * hq * pairs  # S, dP, dV, dK, dQ: five products of 2 pairs D
    peak = BF16_FLOPS_PER_S if q.dtype == torch.bfloat16 else F32_FLOPS_PER_S
    bytes_ms, flops_ms = nbytes / HBM_BYTES_PER_S * 1e3, flops / peak * 1e3
    row = {
        "shape": f"q/o/dO {list(q.shape)}, k/v {list(k.shape)}, {str(q.dtype)[6:]}, "
                 f"causal={causal}",
        "ms": graph_ms(torch, lambda: flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                                               causal=causal), calls=calls),
        "eager_ms": time_ms(torch, lambda: flash_attention_bwd_cuda(q, k, v, o, do, lse,
                                                                     causal=causal), iters=50),
        "plain_ms": graph_ms(torch, lambda: attention_bwd_ref(q, k, v, do, causal=causal),
                             calls=calls, replays=min(calls, 20)),
        "library_ms": graph_ms(torch, lib_fwd_bwd, calls=calls)
        - graph_ms(torch, lib, calls=calls),
        "library": "scaled_dot_product_attention's backward (fwd+bwd less fwd) on K/V repeated "
                   "to the query heads",
        "timed": "CUDA-graph replays (autograd's backward captured with the forward)",
        "bytes": nbytes, "flops": flops, "bytes_ms": bytes_ms, "flops_ms": flops_ms,
        "bound_ms": max(bytes_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= flops_ms else "operations",
        "max_abs_err": err, "rel_err": rel, "plain_rel_err": plain_rel,
    }
    log("flash backward: " + json.dumps(row))
    return row


def scan_bwd_row(torch, args, info) -> dict:
    """The scan backward at one of the main path's backward calls: held to
    the plain backward, then timed beside its bound (no single PyTorch
    call computes it)."""
    from repro_torch.kernels.ssm_scan.kernel import selective_scan_bwd_cuda
    from repro_torch.kernels.ssm_scan.ref import selective_scan_bwd_ref

    args = [None if t is None else t.detach() for t in args]
    got = selective_scan_bwd_cuda(*args)
    plain = selective_scan_bwd_ref(*args[:8])  # all but the forward's chunk states
    err = max(float((g - p).abs().max()) for g, p in zip(got, plain))
    rel = max(rel_err(g, p) for g, p in zip(got, plain))
    check(rel <= BWD_REL["float32"], f"scan backward at the main path's inputs: relative "
                                     f"error {rel}")
    dt, bm = args[0], args[1]
    b, s, d = dt.shape
    n = bm.shape[2]
    # each input read once, each output written once: dt, x, dy in; ddt, dx
    # out; B, C in, dB, dC out; A in, dA out; h0 in, dh0 out (f32)
    nbytes = 4 * (5 * b * s * d + 4 * b * s * n + 2 * d * n + 2 * b * d * n)
    exps = b * s * d * n  # one decay per state update
    flops = 20 * exps  # the forward's 5 per update recomputed, 15 for the gradients
    bytes_ms = nbytes / HBM_BYTES_PER_S * 1e3
    exp_ms = exps / info["exp_per_s"] * 1e3
    flops_ms = flops / F32_FLOPS_PER_S * 1e3
    row = {
        "shape": f"dt/x/dy [{b}, {s}, {d}], B/C [{b}, {s}, {n}], f32",
        "ms": graph_ms(torch, lambda: selective_scan_bwd_cuda(*args), calls=5, replays=5),
        "eager_ms": time_ms(torch, lambda: selective_scan_bwd_cuda(*args), iters=20),
        "plain_ms": graph_ms(torch, lambda: selective_scan_bwd_ref(*args[:8]), calls=2,
                             replays=3),
        "timed": "CUDA-graph replays (autograd's backward captured with the forward)",
        "library_ms": None,
        "library": "none: no single PyTorch call computes the recurrence's gradient",
        "bytes": nbytes, "exps": exps, "flops": flops, "bytes_ms": bytes_ms,
        "exp_ms": exp_ms, "flops_ms": flops_ms, "bound_ms": max(bytes_ms, exp_ms, flops_ms),
        "bound_by": "bytes" if bytes_ms >= max(exp_ms, flops_ms) else "operations",
        "max_abs_err": err, "rel_err": rel,
    }
    log("scan backward: " + json.dumps(row))
    return row


def train_launches(cfg, steps: int, inits: int = 0) -> dict:
    """Kernel launches of ``steps`` train steps of ``cfg``: each attention
    or Mamba layer's forward kernel once, and again where remat recomputes
    it in the backward, and its backward kernel once; and the threefry
    kernel's of ``inits`` draws of its parameters."""
    from repro_torch.models.transformer import init_launches

    fwd = expected_launches(cfg)["prefill"]
    runs = 1 if cfg.remat == "none" else 2
    return {**{k: runs * n * steps for k, n in fwd.items()},
            **{f"{k}_bwd": n * steps for k, n in fwd.items()},
            **({"prng": inits * init_launches(cfg)} if inits else {})}


def expect_train_launches(counts: dict, want: dict, what: str) -> None:
    got = {k: v for k, v in counts.items() if v}
    check(got == want, f"{what}: launches {got}, want {want}")


def train_smollm(torch, np, dev, info) -> dict:
    """Phase 23: smollm-135m at full width trained through ``Trainer`` and
    ``Pipeline`` at the launcher's defaults (AdamW, f32 master, remat
    "full"): first-step gradients against the plain path; 20 steps counted
    (flash forward 2 x 30 and backward 30 a step), loss falling; a crash at
    step 5 resumed from the async checkpoint to the uninterrupted run's
    parameters at step 8; the flash backward at the main path's inputs;
    the timed stretch at seq 1024, batch 16."""
    import shutil
    import tempfile

    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.kernels.flash_attention import ops as fa_ops
    from repro_torch.models import init_params
    from repro_torch.random import PRNGKey
    from repro_torch.train import Trainer, make_train_step
    from repro_torch.tree import tree_leaves

    cfg = configs.get("smollm-135m")
    check(cfg.param_count() == 162_826_560, f"smollm-135m has {cfg.param_count()} parameters")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_train_"))
    out = {"params": cfg.param_count(), "remat": cfg.remat}
    try:
        run_cfg = RunConfig(learning_rate=3e-3, checkpoint_every=100,
                            checkpoint_dir=str(tmp / "main"), master_dtype="float32")
        pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH))
        step, opt_init = make_train_step(cfg, run_cfg, device=dev)

        def init_fn():
            return init_params(cfg, PRNGKey(0), device=dev)

        params = init_fn()
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(0).items()}
        out["grads"] = grads_against_plain(
            torch, cfg, params, batch, lm_paths()["smollm-135m"], GRAD_BF16_REL, True,
            [("attn", "wq"), ("attn", "wk"), ("attn", "wv"), ("attn", "wo")])
        log(f"smollm-135m first-step gradients: {json.dumps(out['grads'])}")
        del params

        losses = []

        def recording_step(*a):
            res = step(*a)
            losses.append(res[2]["loss"])
            return res

        bwd_calls = []
        reset_counts()
        t0 = time.perf_counter()
        with swapped([record_calls(fa_ops, "flash_attention_bwd_cuda", bwd_calls)]):
            trainer = Trainer.resume_or_init(cfg, run_cfg, pipe, init_fn, recording_step,
                                             opt_init, device=dev)
            trainer.run(RESUME_STEPS)
            at_resume = [x.clone() for x in tree_leaves(trainer.params)]
            trainer.run(TRAIN_STEPS - RESUME_STEPS)
        torch.cuda.synchronize()
        out["run_s"] = time.perf_counter() - t0
        counts = read_counts()
        out["launches"] = {k: v for k, v in counts.items() if v}
        # the Trainer draws the parameters once (resume_or_init)
        expect_train_launches(counts, train_launches(cfg, TRAIN_STEPS, inits=1),
                              "smollm-135m's training")
        out["losses"] = [float(x) for x in losses]
        check(all(np.isfinite(out["losses"])), f"smollm-135m: losses {out['losses']}")
        first, last = np.mean(out["losses"][:5]), np.mean(out["losses"][-5:])
        check(last < first, f"smollm-135m: the loss did not fall ({first} -> {last})")
        log(f"smollm-135m: {TRAIN_STEPS} steps in {out['run_s']:.2f} s (checkpoints at "
            f"{RESUME_STEPS} and {TRAIN_STEPS} included), loss {out['losses'][0]:.4f} -> "
            f"{out['losses'][-1]:.4f}; launches {out['launches']}")

        # a crash at step 5, resumed from the async checkpoint of step 4
        crash_cfg = dataclasses.replace(run_cfg, checkpoint_dir=str(tmp / "crash"),
                                        checkpoint_every=CKPT_EVERY)
        armed = {"on": True}

        def fail_hook(s):
            if armed["on"] and s == CRASH_AT:
                armed["on"] = False
                raise RuntimeError("simulated node failure")

        crashed = Trainer.resume_or_init(cfg, crash_cfg, pipe, init_fn, step, opt_init,
                                         device=dev)
        crashed.run(RESUME_STEPS, fail_hook=fail_hook)
        check(not armed["on"] and crashed.step == RESUME_STEPS, "the crash was not simulated")
        diffs = [float((a.float() - b.float()).abs().max())
                 for a, b in zip(at_resume, tree_leaves(crashed.params))]
        out["resume"] = {"crash_at": CRASH_AT, "restored_from": CKPT_EVERY,
                         "compared_at": RESUME_STEPS, "bitwise": all(map(
                             torch.equal, at_resume, tree_leaves(crashed.params))),
                         "max_abs_diff": max(diffs)}
        check(out["resume"]["bitwise"], f"the resumed run's parameters differ from the "
                                        f"uninterrupted run's: {out['resume']}")
        log(f"smollm-135m crash recovery: {json.dumps(out['resume'])}")
        del crashed, at_resume

        out["flash_bwd"] = flash_bwd_row(torch, *bwd_calls[0])
        del bwd_calls
        long_pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=LONG_SEQ,
                                        global_batch=LONG_BATCH))
        reset_counts()
        long_calls = []  # one backward call of the timed stretch, for its own row
        with swapped([record_calls(fa_ops, "flash_attention_bwd_cuda", long_calls)]):
            out["long"] = timed_train_stretch(
                torch, cfg, step, trainer.params, trainer.opt_state, long_pipe, LONG_STEPS,
                trainer.step, [(fa_ops, "flash_attention_bwd_cuda")])
        n_long = LONG_STEPS + 3  # two warm-up steps, the timed ones and the profiled one
        expect_train_launches(read_counts(), train_launches(cfg, n_long), "the timed stretch")
        flops = train_flops(cfg, LONG_SEQ, LONG_BATCH)
        out["long"].update({"model_flops": flops,
                            "mfu": flops / (out["long"]["step_ms"] / 1e3) / BF16_FLOPS_PER_S,
                            "peak": "989 TFLOP/s dense bf16, H100 SXM data sheet",
                            "card": info["nvidia_smi"]})
        log(f"smollm-135m timed stretch: {json.dumps(out['long'])}")
        out["flash_bwd_long"] = flash_bwd_row(torch, *long_calls[0], calls=4)
        del long_calls
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def train_falcon(torch, np, dev, info) -> dict:
    """Phase 24: falcon-mamba-7b at full width cut to 8 of 64 layers:
    first-step gradients of an f32 copy against the plain path; 20 steps
    of ``make_train_step`` on ``Pipeline`` batches with bf16 parameters,
    an f32 master and int8 moments (scan forward 2 x 8 and backward 8 a
    step), loss falling; the scan backward at the main path's inputs.
    (The Trainer would end with an 11 GB checkpoint: phase 23 drives it.)"""
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.kernels.ssm_scan import ops as ss_ops
    from repro_torch.models import init_params
    from repro_torch.random import PRNGKey
    from repro_torch.optim import Quantized
    from repro_torch.train import make_train_step

    full = configs.get("falcon-mamba-7b")
    cfg = dataclasses.replace(full, n_layers=FALCON_TRAIN_LAYERS)
    out = {"params": cfg.param_count(), "full_params": full.param_count(),
           "cut": f"n_layers 64 -> {FALCON_TRAIN_LAYERS}: the whole model ({full.param_count():,} "
                  "parameters) with its AdamW state (2 + 4 + 2 bytes a parameter with int8 "
                  "moments, 58 GB, before gradients and activations) does not fit one card "
                  "beside the earlier phases' workspace"}
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                               global_batch=TRAIN_BATCH))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(0).items()}
    cfg32 = dataclasses.replace(cfg, dtype="float32")
    params32 = init_params(cfg32, PRNGKey(0), device=dev)
    out["grads"] = grads_against_plain(
        torch, cfg32, params32, batch, lm_paths()["falcon-mamba-7b"], GRAD_F32_REL, False,
        [("ssm", "in_proj"), ("ssm", "a_log"), ("ssm", "x_proj"), ("ssm", "dt_proj"),
         ("ssm", "conv")])
    log(f"falcon-mamba-7b (8 layers, f32) first-step gradients: {json.dumps(out['grads'])}")
    del params32

    run_cfg = RunConfig(learning_rate=3e-3, state_dtype="int8", master_dtype="float32")
    step, opt_init = make_train_step(cfg, run_cfg, device=dev)
    fresh_card(torch)
    params = init_params(cfg, PRNGKey(0), device=dev)
    opt_state = opt_init(params)
    batches = [{k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(i).items()}
               for i in range(FALCON_STEPS)]
    losses, bwd_calls = [], []
    reset_counts()
    t0 = time.perf_counter()
    with swapped([record_calls(ss_ops, "selective_scan_bwd_cuda", bwd_calls)]):
        for i, b in enumerate(batches):
            params, opt_state, metrics = step(params, opt_state, b, i)
            losses.append(float(metrics["loss"]))
    torch.cuda.synchronize()
    out["run_s"] = time.perf_counter() - t0
    out["step_ms"] = out["run_s"] * 1e3 / FALCON_STEPS
    out["tokens_per_s"] = TRAIN_SEQ * TRAIN_BATCH / (out["run_s"] / FALCON_STEPS)
    out["peak_allocated_gb"] = torch.cuda.max_memory_allocated() / 1e9
    counts, by_kernel = read_counts(), read_kernel_counts("ssm_scan")
    out["launches"] = {k: v for k, v in counts.items() if v}
    out["profile"] = train_profile(
        torch, lambda: step(params, opt_state, batches[-1], FALCON_STEPS), out["step_ms"],
        [(ss_ops, "selective_scan_bwd_cuda")])
    expect_train_launches(counts, train_launches(cfg, FALCON_STEPS), "falcon-mamba-7b's training")
    check(by_kernel == {"decode": 0, "prefill": 2 * cfg.n_layers * FALCON_STEPS},
          f"falcon-mamba-7b's training took the scan kernels {by_kernel}")
    check(isinstance(opt_state.m["embed"], Quantized)
          and opt_state.m["embed"].q.dtype == torch.int8, "the moments are not int8")
    out["losses"] = losses
    check(all(np.isfinite(out["losses"])), f"falcon-mamba-7b: losses {out['losses']}")
    first, last = np.mean(out["losses"][:3]), np.mean(out["losses"][-3:])
    check(last < first, f"falcon-mamba-7b: the loss did not fall ({first} -> {last})")
    log(f"falcon-mamba-7b ({FALCON_TRAIN_LAYERS} layers, int8 moments): {FALCON_STEPS} steps "
        f"in {out['run_s']:.2f} s, loss "
        f"{out['losses'][0]:.4f} -> {out['losses'][-1]:.4f}, peak "
        f"{out['peak_allocated_gb']:.2f} GB; launches {out['launches']}")
    del params, opt_state, batches
    out["scan_bwd"] = scan_bwd_row(torch, bwd_calls[0][0], info)
    return out


def nn_draws(model) -> int:
    """The threefry launches of the NN front end's ``init_params`` on the
    card: one a CMVM layer's weights (a ``Residual``'s body counted
    within)."""
    from repro_torch.nn import QConv2D, QDense, QDenseOnAxis, Residual

    return sum(nn_draws(spec.body) if isinstance(spec, Residual)
               else isinstance(spec, (QDense, QDenseOnAxis, QConv2D)) for spec in model)


def train_jet_tagger_phase(torch) -> dict:
    """Phase 25: the paper's QAT workflow on the card through its example
    entry point: the JAX example's keys (the weights of ``PRNGKey(0)``,
    the data of ``PRNGKey(1)``, a split a step) drawn by the threefry
    kernel, 300 SGD steps with the STE ``fake_quant`` and the
    ``collect_bits`` penalty, ``compile_model`` with both strategies,
    float64 ``apply_model`` == the design's ``forward`` (checked inside),
    and a burst served through ``ServeEngine`` on the adder-graph kernel
    equal to ``forward_int``."""
    from repro_torch.examples import train_jet_tagger
    from repro_torch.nn import models

    steps = 300
    reset_counts()
    out = train_jet_tagger.main(["--device", "cuda", "--steps", str(steps)])
    counts = read_counts()
    check(counts["adder_graph"] > 0, "the jet tagger was not served on the adder-graph kernel")
    check_only(counts, {"adder_graph", "prng"}, "the jet tagger's workflow")
    # the init, the class centres, each batch (two bits draws for the
    # labels, one normal for the features) and the evaluation batch
    draws = nn_draws(models.jet_tagger()[0]) + 1 + 3 * (steps + 1)
    check(counts["prng"] == draws, f"the jet tagger: {counts['prng']} threefry launches, want "
                                   f"{draws}")
    check(out["accuracy"] > 0.9 and out["hw_accuracy"] > 0.9,
          f"the jet tagger's accuracy {out['accuracy']}, on the design {out['hw_accuracy']}")
    out["adder_graph_launches"] = counts["adder_graph"]
    out["prng_launches"] = counts["prng"]
    log("jet tagger: " + json.dumps(out))
    return out



# ----------------------------------------------------------------------
# 19. what stays allocated between phases
# ----------------------------------------------------------------------
def left_on_card(torch, tag: str) -> dict:
    """What stays allocated on the card after a phase: every active block
    of the caching allocator's snapshot, matched to the live tensors whose
    storage starts there and, for each, the chain of objects that refer to
    it (two levels up); blocks no Python tensor owns are listed by pool
    (a CUDA graph's private pool) and stream.  Returns the blocks by
    address, to diff two phases."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    snap = torch.cuda.memory._snapshot()
    blocks = {}
    for seg in snap["segments"]:
        addr = seg["address"]
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated":
                blocks[addr] = {"size": blk["size"], "pool": str(seg.get("segment_pool_id")),
                                "stream": seg.get("stream")}
            addr += blk["size"]
    owners = {}
    for obj in gc.get_objects():
        if isinstance(obj, torch.Tensor) and obj.is_cuda:
            ptr = obj.untyped_storage().data_ptr()
            if ptr in blocks:
                owners.setdefault(ptr, []).append(obj)

    skip = {id(lst) for lst in owners.values()}

    def describe(obj, depth=2):
        """Up to two objects referring to ``obj``, each with its own referrer."""
        out = []
        for ref in gc.get_referrers(obj):
            if id(ref) in skip or type(ref).__name__ == "frame":
                continue
            if isinstance(ref, dict):
                keys = [k for k, v in ref.items() if v is obj][:1]
                name = f"dict[{keys[0]!r}]" if keys else "dict"
            else:
                name = type(ref).__name__
            if depth > 1:
                up = describe(ref, depth - 1)
                name += " <- " + (up[0] if up else "?")
            out.append(name)
            if len(out) >= 2:
                break
        return out

    for ptr, blk in blocks.items():
        ts = owners.get(ptr)
        if ts:
            t = ts[0]
            blk["tensor"] = f"{tuple(t.shape)} {str(t.dtype).removeprefix('torch.')}"
            blk["held_by"] = describe(t)
    total = sum(b["size"] for b in blocks.values())
    owned = sum(b["size"] for b in blocks.values() if "tensor" in b)
    log(f"{tag}: {total / 1e9:.4f} GB in {len(blocks)} active blocks, {owned / 1e9:.4f} GB "
        f"owned by live tensors")
    return blocks


def diff_left(before: dict, after: dict) -> dict:
    """The blocks active after a phase that were not before it, largest
    first, with their owners; and the total."""
    new = {a: b for a, b in after.items() if before.get(a, {}).get("size") != b["size"]}
    rows = sorted(new.values(), key=lambda b: -b["size"])
    out = {"new_bytes": sum(b["size"] for b in rows), "n_blocks": len(rows),
           "largest": rows[:12]}
    log("left after the phase: " + json.dumps(out))
    return out


def cublas_share(torch, blocks: dict) -> dict:
    """How much of ``blocks`` (active, no live tensor owns them) are
    cuBLAS workspaces: PyTorch keeps one per (cuBLAS handle, stream) a
    product ran on, for the process's life.  Clearing them (no graph is
    alive here to read them; the next product allocates its own again)
    and taking the snapshot again shows which blocks they were."""
    import gc

    clear = getattr(torch._C, "_cuda_clearCublasWorkspaces", None)
    if clear is None:
        log("cuBLAS workspaces: this PyTorch cannot clear them; not told apart")
        return {}
    clear()
    gc.collect()
    torch.cuda.empty_cache()
    still = set()
    for seg in torch.cuda.memory._snapshot()["segments"]:
        addr = seg["address"]
        for blk in seg["blocks"]:
            if blk["state"] == "active_allocated":
                still.add(addr)
            addr += blk["size"]
    unowned = {a: b for a, b in blocks.items() if "tensor" not in b}
    freed = {a: b for a, b in unowned.items() if a not in still}
    out = {"unowned_bytes": sum(b["size"] for b in unowned.values()),
           "freed_as_cublas_workspaces": sum(b["size"] for b in freed.values()),
           "workspaces": len(freed), "sizes": sorted({b["size"] for b in freed.values()}),
           "streams": len({b["stream"] for b in freed.values()}),
           "allocated_after": torch.cuda.memory_allocated()}
    log("cuBLAS workspaces among them: " + json.dumps(out))
    return out


# ----------------------------------------------------------------------
# 26. the sharded path on the card; 27. the launch tools
# ----------------------------------------------------------------------
SHARD_DECODE_STEPS = 32
SHARD_LEFT_BYTES = 1 << 20  # what phases 26-27 may leave allocated


def _same(a, b) -> bool:
    """Bit-equal values: ``b`` a DTensor (its local shard: the whole tensor
    on a one-rank mesh) or a plain tensor."""
    from torch.distributed.tensor import DTensor

    b = b.to_local() if isinstance(b, DTensor) else b
    return a.dtype == b.dtype and a.shape == b.shape and a.equal(b)


def sharded_on_card(torch, np, dev, cfg=None, jamba_asset: str = "jamba_smoke") -> dict:
    """Phase 26: the sharded path on a one-rank NCCL group (a ``FileStore``
    in a temporary directory) and a 1x1 ("data", "model") mesh, through the
    hand-written kernels (the flash forward and backward and the scan run
    on each rank's shard, inside ``local_map``): smollm-135m at full width
    -- one sharded train step against the unsharded one, and prefill plus
    32 greedy ``decode_step``s under the rules against the unsharded loop,
    each bit for bit, the kernels' launches counted under the rules; the
    committed jamba asset's prefill and greedy decode under the rules (the
    scan and the MoE dispatch inside ``local_map``) against the unsharded
    loop and the JAX engine's golden tokens; a checkpoint written sharded,
    restored with and without ``shardings=``, exactly.  The process group
    is destroyed at the end."""
    import shutil
    import tempfile

    import torch.distributed as dist

    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.distributed import MeshRules, use_rules
    from repro_torch.launch.mesh import make_test_mesh
    from repro_torch.models import (decode_step, init_params, param_shardings, params_from_numpy,
                                    prefill, unflatten)
    from repro_torch.random import PRNGKey
    from repro_torch.train import checkpoint, make_train_step
    from repro_torch.tree import tree_leaves

    cfg = cfg or configs.get("smollm-135m")
    tmp = Path(tempfile.mkdtemp(prefix="chip_smoke_shard_"))
    backend = "nccl" if dev.type == "cuda" else "gloo"
    dist.init_process_group(backend, init_method=f"file://{tmp / 'store'}", rank=0,
                            world_size=1, **({"device_id": dev} if dev.type == "cuda" else {}))
    out = {"backend": backend, "arch": cfg.name}
    try:
        rules = MeshRules(make_test_mesh(1, 1, device_type=dev.type))
        out["mesh"] = {"shape": list(rules.mesh.shape), "dims": list(rules.names)}

        def fresh():
            return init_params(cfg, PRNGKey(0), device=dev)

        # one train step, unsharded and sharded, from the same parameters
        run_cfg = RunConfig(learning_rate=3e-3, master_dtype="float32")
        step, opt_init = make_train_step(cfg, run_cfg, device=dev)
        pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=TRAIN_SEQ,
                                   global_batch=TRAIN_BATCH))
        batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(0).items()}
        p1 = fresh()
        o1 = opt_init(p1)
        reset_counts()
        p1, o1, m1 = step(p1, o1, batch, 0)
        if dev.type == "cuda":
            torch.cuda.synchronize(dev)
        plain_counts = read_counts()
        with use_rules(rules):
            shardings = param_shardings(cfg, rules)
            # drawn as the launcher draws them: each rank its blocks only
            p2 = init_params(cfg, PRNGKey(0), device=dev, shardings=shardings)
            o2 = opt_init(p2)
            b2 = {k: rules.distribute(v, "batch", None) for k, v in batch.items()}
            reset_counts()
            p2, o2, m2 = step(p2, o2, b2, 0)
            if dev.type == "cuda":
                torch.cuda.synchronize(dev)
            counts = read_counts()
        leaves = [("params", a, b) for a, b in zip(tree_leaves(p1), tree_leaves(p2))] + \
            [("opt", a, b) for a, b in zip(tree_leaves(o1), tree_leaves(o2))]
        differ = [(w, i) for i, (w, a, b) in enumerate(leaves) if not _same(a, b)]
        out["train"] = {
            "loss": float(m1["loss"]), "loss_sharded": float(m2["loss"]),
            "loss_bitwise": _same(m1["loss"], m2["loss"]),
            "grad_norm_bitwise": _same(m1["grad_norm"], m2["grad_norm"]),
            "leaves": len(leaves), "leaves_differing": len(differ),
            "max_abs_diff": max(float((a.float() - (b.to_local() if hasattr(b, "to_local")
                                                   else b).float()).abs().max())
                                for _, a, b in leaves),
            "launches": {k: v for k, v in counts.items() if v},
            "launches_unsharded": {k: v for k, v in plain_counts.items() if v},
        }
        log(f"sharded train step: {json.dumps(out['train'])}")
        check(not differ and out["train"]["loss_bitwise"],
              f"the sharded train step differs from the unsharded one: {out['train']}")
        if dev.type == "cuda":
            check(counts["flash_attention"] > 0 and counts["flash_attention_bwd"] > 0,
                  f"the sharded train step did not run the flash kernels: {counts}")
            check(counts == plain_counts, f"launches {counts} sharded, {plain_counts} unsharded")

        # a checkpoint written sharded, restored with and without shardings=
        ck = str(tmp / "ckpt")
        checkpoint.save(ck, 1, {"p": p2})
        back = checkpoint.restore(ck, 1, {"p": p2}, shardings=checkpoint.shardings_of({"p": p2}))
        whole = checkpoint.restore(ck, 1, {"p": p1})
        out["checkpoint"] = {
            "resharded_exact": all(_same(a.to_local(), b) and tuple(a.placements) ==
                                   tuple(b.placements)
                                   for a, b in zip(tree_leaves(p2), tree_leaves(back["p"]))),
            "unsharded_exact": all(_same(a, b) for a, b in zip(tree_leaves(whole["p"]),
                                                               tree_leaves(p2))),
        }
        log(f"checkpoint written sharded: {json.dumps(out['checkpoint'])}")
        check(all(out["checkpoint"].values()), f"checkpoint round trip: {out['checkpoint']}")
        del p1, o1, p2, o2, back, whole, leaves

        # prefill and greedy decode_step under the rules, against the plain loop
        g = torch.Generator(dev).manual_seed(1)
        prompts = torch.randint(2, cfg.vocab_size, (SERVE_BATCH, PROMPT_LEN), generator=g,
                                device=dev)
        out["decode"] = greedy_pair(torch, cfg, fresh(), {"tokens": prompts}, SERVE_MAX_SEQ,
                                    SHARD_DECODE_STEPS, rules, shardings, param_shardings)
        out["decode"].pop("tokens")
        if dev.type == "cuda":
            want = cfg.n_layers * (1 + SHARD_DECODE_STEPS)
            check(out["decode"]["launches"].get("flash_attention") == want,
                  f"sharded decode: launches {out['decode']['launches']}, flash {want}")

        # the committed jamba asset under the rules against its golden tokens
        asset = ASSETS / jamba_asset
        manifest = json.loads((asset / "manifest.json").read_text())
        cfg_j = configs.get_smoke(manifest["arch"], **manifest["smoke_kwargs"])
        with np.load(asset / "weights.npz") as w:
            pj = params_from_numpy(cfg_j, unflatten(dict(w)), device=dev)
        with np.load(asset / "golden.npz") as gz:
            golden = dict(gz)
        # the engine's batch: the prompts, padded with the first one (a done request)
        pad = [*golden["prompts"]] + [golden["prompts"][0]] * (
            manifest["batch_size"] - len(golden["prompts"]))
        tokens = torch.from_numpy(np.stack(pad).astype(np.int64)).to(dev)
        jam = greedy_pair(torch, cfg_j, pj, {"tokens": tokens}, manifest["max_seq"],
                          manifest["decode_steps"], rules, None, param_shardings)
        picked = jam.pop("tokens")
        for i, want_tok in enumerate(golden["tokens"][:len(golden["prompts"])]):
            want_tok = [int(t) for t in want_tok if t >= 0]
            check(picked[i][:len(want_tok)] == want_tok,
                  f"sharded jamba: request {i} tokens {picked[i]} != JAX {want_tok}")
        jam["golden_tokens_equal"] = True
        out["jamba"] = jam
        if dev.type == "cuda":
            check(jam["launches"].get("ssm_scan", 0) > 0 and
                  jam["launches"].get("flash_attention", 0) > 0,
                  f"sharded jamba did not run the kernels: {jam['launches']}")
        log(f"sharded jamba asset: {json.dumps(jam)}")
    finally:
        dist.destroy_process_group()
        shutil.rmtree(tmp, ignore_errors=True)
    return out


def greedy_pair(torch, cfg, params, batch, max_seq, steps, rules, shardings,
                param_shardings) -> dict:
    """Prefill then ``steps`` greedy ``decode_step``s, unsharded and under
    ``rules`` (the parameters laid out by ``param_shardings``, the batch on
    the batch dims), counted: tokens and logits bit for bit."""
    from repro_torch.distributed import use_rules
    from repro_torch.models import decode_step, prefill, shard_params

    def loop(p, b):
        logits, cache = prefill(cfg, p, b, max_seq)
        toks, lgs = [], [logits]
        for _ in range(steps):
            tok = logits.argmax(-1)
            toks.append(tok)
            logits, cache = decode_step(cfg, p, tok[:, None], cache)
            lgs.append(logits)
        toks.append(logits.argmax(-1))
        return toks, lgs

    with torch.no_grad():
        t1, l1 = loop(params, batch)
        with use_rules(rules):
            p2 = shard_params(params, param_shardings(cfg, rules))
            b2 = {k: rules.distribute(v, "batch", *([None] * (v.ndim - 1)))
                  for k, v in batch.items()}
            reset_counts()
            t2, l2 = loop(p2, b2)
            counts = read_counts()
    toks = torch.stack(t1, dim=1).tolist()
    out = {"steps": steps, "tokens_equal": all(_same(a, b) for a, b in zip(t1, t2)),
           "logits_bitwise": all(_same(a, b) for a, b in zip(l1, l2)),
           "max_abs_logit_diff": max(float((a.float() - b.to_local().float()).abs().max())
                                     for a, b in zip(l1, l2)),
           "launches": {k: v for k, v in counts.items() if v}, "tokens": toks}
    check(out["tokens_equal"] and out["logits_bitwise"],
          f"sharded greedy decode of {cfg.name} differs: "
          f"{ {k: v for k, v in out.items() if k != 'tokens'} }")
    return out


def launch_tools_phase(torch, np, dev, info, sm_train: dict, cfg=None,
                       seq: int = LONG_SEQ, batch_size: int = LONG_BATCH) -> dict:
    """Phase 27: ``launch.hlo_analysis.analyze`` on phase 23's smollm-135m
    train step (seq 1024, batch 16), its FLOPs held to what the model's
    matrix products must come to (``train_flops`` counts 6N per token and
    the causal attention; the count sees the forward twice under remat
    "full", the tied head once, and not the flash kernels, which are no
    aten ops); the three H100 roofline terms beside phase 23's measured
    step, as shares of it (a reading, not a claim).  (The phase's dry-run
    is awaited by ``finish_dryrun``.)"""
    from repro_torch import configs
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.launch import roofline
    from repro_torch.launch.hlo_analysis import analyze
    from repro_torch.models import init_params
    from repro_torch.random import PRNGKey
    from repro_torch.train import make_train_step

    cfg = cfg or configs.get("smollm-135m")
    run_cfg = RunConfig(learning_rate=3e-3, master_dtype="float32")
    step, opt_init = make_train_step(cfg, run_cfg, device=dev)
    params = init_params(cfg, PRNGKey(0), device=dev)
    opt = opt_init(params)
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=seq, global_batch=batch_size))
    batch = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(0).items()}
    costs = analyze(step, params, opt, batch, 0, n_devices=1)
    tokens = seq * batch_size
    head = cfg.d_model * cfg.padded_vocab
    layer_mm = sum(v.numel() for blk in params["blocks"] for part in blk.values()
                   if isinstance(part, dict) for v in part.values() if v.dim() == 3)
    # remat "full" recomputes a period's forward in the backward, up to the
    # last tensor the backward needs: the period's last product (w_down),
    # whose output no backward reads, is not run again (checkpoint's early stop)
    remat = 2 if cfg.remat == "full" else 0
    down = params["blocks"][-1]["mlp"]["w_down"].numel() if remat else 0
    expect = tokens * ((6 + remat) * layer_mm - remat * down + 6 * head)
    model = train_flops(cfg, seq, batch_size)
    out = {"shape": f"seq {seq}, batch {batch_size}", "flops": costs.flops,
           "hbm_bytes": costs.hbm_bytes, "coll_bytes": costs.coll_wire_bytes,
           "train_flops": model, "matmul_flops_expected": expect,
           "counted_over_expected": costs.flops / expect,
           "counted_over_train_flops": costs.flops / model,
           "why": f"train_flops = 6N per token + causal attention; the count sees every "
                  f"aten matrix product: the layers' {6 + remat}N (remat {cfg.remat!r} "
                  f"recomputes the forward but its last product, w_down), the tied head's "
                  f"6N, and no attention (the flash kernels are ctypes calls, not aten ops)"}
    if dev.type == "cuda":  # on the CPU the plain attention's products are aten ops too
        check(abs(out["counted_over_expected"] - 1) < 0.01,
              f"the counted FLOPs are {out['counted_over_expected']:.4f}x the matrix products'")
    terms = {"t_compute_ms": costs.flops / roofline.PEAK_FLOPS * 1e3,
             "t_memory_ms": costs.hbm_bytes / roofline.HBM_BW * 1e3, "t_collective_ms": 0.0}
    long = (sm_train or {}).get("long", {})
    step_ms = long.get("step_ms")
    device_ms = long.get("profile", {}).get("device_ms")
    out["roofline"] = {**terms, "measured_step_ms": step_ms, "measured_device_ms": device_ms,
                       "card": info.get("nvidia_smi"),
                       "peaks": "989e12 FLOP/s bf16, 3.35e12 B/s, 450e9 B/s NVLink: H100 SXM "
                                "data sheet",
                       "share_of_step": None if not step_ms else
                       {k: v / step_ms for k, v in terms.items()}}
    log(f"hlo_analysis of the train step: {json.dumps(out)}")
    return out


DRYRUN_ARGS = ["--arch", "smollm-135m,qwen3-moe-30b-a3b", "--shape", "train_4k,decode_32k"]
DRYRUN_MESHES = ("single", "multi")  # one process each
DRYRUN_TIMEOUT_S = 900


def start_dryrun() -> list:
    """Start the dry-run CLI (CPU only, the fake process group) in the
    background at low priority, one process per production mesh: a list
    of (process, output path)."""
    import os
    import tempfile

    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), CUDA_VISIBLE_DEVICES="")
    runs = []
    for mesh in DRYRUN_MESHES:
        fd, path = tempfile.mkstemp(prefix=f"chip_smoke_dryrun_{mesh}_", suffix=".json")
        os.close(fd)
        os.unlink(path)
        proc = subprocess.Popen(["nice", "-n", "19", sys.executable, "-m",
                                 "repro_torch.launch.dryrun", *DRYRUN_ARGS, "--mesh", mesh,
                                 "--out", path], env=env, cwd=str(ROOT),
                                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        runs.append((proc, path))
    return runs


def finish_dryrun(runs: list, started: float) -> dict:
    """Wait for the dry-run (within its time limit from ``started``), print
    its rows and check that every cell is ok."""
    import os

    rows = []
    for proc, path in runs:
        left = max(DRYRUN_TIMEOUT_S - (time.perf_counter() - started), 1)
        try:
            text, _ = proc.communicate(timeout=left)
        except subprocess.TimeoutExpired:
            for p, _ in runs:
                p.kill()
                p.communicate()
            raise SmokeFailure(f"the dry-run did not end within {DRYRUN_TIMEOUT_S} s")
        check(proc.returncode == 0, f"the dry-run exited {proc.returncode}: {text[-2000:]}")
        rows += json.loads(Path(path).read_text())
        os.unlink(path)
    keys = ("arch", "shape", "mesh", "status", "params_gb", "opt_gb", "cache_gb",
            "memory_per_chip_gb", "t_compute_s", "t_memory_s", "t_collective_s", "bottleneck",
            "microbatch", "optimizer", "run_s")
    for r in rows:
        log("dry-run row: " + json.dumps({k: r.get(k) for k in keys}))
    bad = [(r["arch"], r["shape"], r["mesh"], r["status"]) for r in rows if r["status"] != "ok"]
    check(len(rows) == 8 and not bad, f"dry-run: {len(rows)} rows, failing {bad}")
    return {"cells": len(rows), "ok": len(rows) - len(bad),
            "wall_s": time.perf_counter() - started}


# ----------------------------------------------------------------------
# 28. the examples' twins
# ----------------------------------------------------------------------
def twin_grads(torch, cfg, params, batch, arch: str) -> dict:
    """First-step gradients of a twin's model on its first batch: the
    kernel path (each forward kernel once a layer, again under remat, and
    its backward kernel once a layer) against the plain path, leaf by leaf
    within ``BWD_REL["float32"]`` of the leaf's largest element: the
    backward kernels at the twins' own shapes (the f32 flash backward at
    head_dim 16 with 2 KV heads, the scan backward at state 8)."""
    path = lm_paths()[arch]
    moved = ([("ssm", n) for n in ("in_proj", "a_log", "x_proj", "dt_proj", "conv")]
             if path["ops"][0]["kernel"] == "ssm_scan"
             else [("attn", n) for n in ("wq", "wk", "wv", "wo")])
    out = grads_against_plain(torch, cfg, params, batch, path, BWD_REL["float32"], True, moved)
    expect_train_launches(out["launches"], train_launches(cfg, 1),
                          f"{cfg.name}'s first-step gradients")
    out["launches"] = {k: v for k, v in out["launches"].items() if v}
    return out


def quickstart_twin(torch) -> dict:
    """quickstart on the card: the solve, ``x @ M`` through the adder-graph
    kernel (one launch, its output equal to its plain version's on the
    same tensor), pipelining and Verilog."""
    from repro_torch.examples import quickstart
    from repro_torch.kernels.adder_graph import ops as ag_ops
    from repro_torch.kernels.adder_graph.ref import adder_graph_ref

    kernel = ag_ops.adder_graph_cuda
    calls = []

    def recording(tables, x):
        y = kernel(tables, x)
        calls.append((tables, x, y))
        return y

    reset_counts()
    t0 = time.perf_counter()
    with swapped([(ag_ops, "adder_graph_cuda", recording)]):
        out = quickstart.main(["--device", "cuda"])
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    check(out["route"] == "CUDA adder-graph kernel", f"quickstart took the route {out['route']}")
    check(counts["adder_graph"] == 1 and len(calls) == 1,
          f"quickstart: {counts['adder_graph']} adder-graph launches, want 1")
    check_only(counts, "adder_graph", "quickstart")
    tables, x, y = calls[0]
    check(x.is_cuda and torch.equal(y, adder_graph_ref(tables, x)),
          "quickstart: the kernel's output differs from its plain version's")
    return {**out, "launches": {"adder_graph": counts["adder_graph"]}, "wall_s": wall_s,
            "kernel_vs_plain": "equal", "shape": list(x.shape)}


def serve_lm_twin(torch, np, dev, arch: str) -> dict:
    """serve_lm on the card at its defaults (``arch`` aside): the loss
    falls, the flash (or scan) forward and backward kernels are launched
    as many times as layers x steps say and nothing else, and the served
    tokens equal those of the same engine with every op swapped for its
    plain version, or are held to it by phase 8's teacher-forced rule;
    the first step's gradients are held to the plain path's
    (``twin_grads``)."""
    from repro_torch.examples import serve_lm
    from repro_torch.models import init_params
    from repro_torch.random import PRNGKey

    argv = ["--device", "cuda"] + ([] if arch == "smollm-135m" else ["--arch", arch])
    reset_counts()
    t0 = time.perf_counter()
    out = serve_lm.main(argv)
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    by_kernel = read_kernel_counts("ssm_scan")
    cfg, params = out.pop("config"), out.pop("params")
    steps, served = len(out["losses"]), out.pop("tokens_out")
    per = expected_launches(cfg)
    n_decode = max(map(len, served)) - 1
    # the engine's warm-up decode step before its capture, prefill, then
    # one replay per decode step
    serving = {k: per["prefill"][k] + (1 + n_decode) * n for k, n in per["decode"].items()}
    trained = train_launches(cfg, steps, inits=1)  # the example draws its parameters once
    want = {k: trained.get(k, 0) + serving.get(k, 0) for k in {*trained, *serving}}
    expect_train_launches(counts, want, f"serve_lm --arch {arch}")
    if "ssm_scan" in per["decode"]:
        n = per["decode"]["ssm_scan"]
        scan = {"prefill": trained["ssm_scan"] + n, "decode": (1 + n_decode) * n}
        check(by_kernel == scan, f"serve_lm {arch}: the scan's kernels took {by_kernel}, "
                                 f"want {scan}")
    losses = out["losses"]
    check(all(np.isfinite(losses)) and np.mean(losses[-5:]) < np.mean(losses[:5]),
          f"serve_lm {arch}: the loss did not fall ({losses[:5]} ... {losses[-5:]})")
    check([len(t) for t in served] == [8, 12, 16, 20], f"serve_lm {arch}: served {served}")
    pipe = serve_lm.data(cfg)
    first = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(0).items()}
    grads = twin_grads(torch, cfg, init_params(cfg, PRNGKey(0),
                                               device=dev), first, arch)
    log(f"serve_lm {arch}: first-step gradients: " + json.dumps(grads))

    # the same engine on the plain path (every op swapped), and both paths
    # teacher-forced on the served tokens
    path = lm_paths()[arch]
    with swapped(op_swaps(path, "plain")):
        plain = serve_lm.serve(cfg, params, pipe, dev)
    plain_tokens = [r.out_tokens for r in plain["requests"]]
    prompts = np.stack([np.asarray(p, np.int64) for p in plain["prompts"]])
    toks = [torch.tensor([t[i] if i < len(t) else 0 for t in served], device=dev)
            for i in range(n_decode + 1)]
    kern = teacher_forced(torch, cfg, params, prompts, dev, toks, [], {})
    ref = teacher_forced(torch, cfg, params, prompts, dev, toks, op_swaps(path, "plain"), {})
    agree = agreement(torch, kern, [lg.argmax(-1) for lg in kern], ref, LM_F32_ATOL)
    flips = [(i, j) for i, (a, b) in enumerate(zip(served, plain_tokens))
             for j, (x, y) in enumerate(zip(a, b)) if x != y]
    log(f"serve_lm {arch}: served tokens {'equal' if not flips else 'differ from'} the plain "
        f"path's{'' if not flips else ' at (request, token) ' + str(flips)}; teacher-forced, "
        f"f32: " + json.dumps(agree))
    if flips:
        check(agree["n_far_flips"] == 0 and agree["max_abs_diff"] <= LM_F32_ATOL,
              f"serve_lm {arch}: kernel vs plain path beyond phase 8's rule: {agree}")
    del params, kern, ref
    return {**out, "launches": {k: v for k, v in counts.items() if v},
            "scan_kernels": by_kernel if "ssm_scan" in per["decode"] else None,
            "layers": cfg.n_layers, "train_steps": steps, "decode_steps": n_decode,
            "tokens_equal_plain": not flips, "flips": flips, "kernel_vs_plain": agree,
            "grads": grads, "wall_s": wall_s}


def train_resumable_twin(torch, np, dev) -> dict:
    """train_lm_resumable on the card at its defaults: one failure
    survived, the second Trainer back at step 120 and on to 200, the flash
    launches of every step run (the 40 steps redone from the step-50
    checkpoint included) and nothing else, the first step's gradients held
    to the plain path's (``twin_grads``), and the parameters at step 120
    equal to an uninterrupted 120-step run's bit for bit."""
    import shutil
    import tempfile

    from repro_torch.examples import train_lm_resumable as ex
    from repro_torch.train import Trainer
    from repro_torch.tree import tree_leaves

    steps, fail_at, resume_steps, every = 120, 90, 80, 50
    reset_counts()
    t0 = time.perf_counter()
    out = ex.main(["--device", "cuda"])
    torch.cuda.synchronize()
    wall_s = time.perf_counter() - t0
    counts = read_counts()
    got = out.pop("phase1_params")
    check((out["failures_survived"], out["phase1_step"], out["resumed_at"], out["phase2_step"])
          == (1, steps, steps, steps + resume_steps), f"train_lm_resumable: {out}")
    ran = steps + fail_at % every + resume_steps
    tmp = tempfile.mkdtemp(prefix="chip_smoke_resumable_")
    try:
        cfg, run_cfg, pipe, init_fn, step_fn, opt_init = ex.setup(dev, tmp, every)
        # each of the example's two Trainers draws the parameters (resume_or_init)
        expect_train_launches(counts, train_launches(cfg, ran, inits=2), "train_lm_resumable")
        first = {k: torch.from_numpy(v).to(dev) for k, v in pipe.batch_at(0).items()}
        grads = twin_grads(torch, cfg, init_fn(), first, "stablelm-3b")
        log("train_lm_resumable: first-step gradients: " + json.dumps(grads))
        losses = []

        def recording_step(*a):
            res = step_fn(*a)
            losses.append(float(res[2]["loss"]))
            return res

        ref = Trainer.resume_or_init(cfg, run_cfg, pipe, init_fn, recording_step, opt_init,
                                     device=dev)
        ref.run(steps)
        want = tree_leaves(ref.params)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    bitwise = len(want) == len(tree_leaves(got)) and all(map(torch.equal, want, tree_leaves(got)))
    check(bitwise, "train_lm_resumable: the parameters at step 120 differ from an "
                   "uninterrupted run's")
    check(np.mean(losses[-5:]) < np.mean(losses[:5]) and out["phase2_loss"] < losses[0],
          f"train_lm_resumable: the loss did not fall ({losses[0]} -> {out['phase1_loss']} -> "
          f"{out['phase2_loss']})")
    del got, want, ref
    return {**out, "steps_run": ran, "launches": {k: v for k, v in counts.items() if v},
            "bitwise_at_120": bitwise, "uninterrupted_losses": [losses[0], losses[-1]],
            "grads": grads, "wall_s": wall_s}


def examples_phase(torch, np, dev) -> dict:
    """Phase 28: each twin of the examples driven through its ``main`` on
    the card, its launch counts zeroed just before and read just after."""
    out = {"quickstart": quickstart_twin(torch)}
    log("quickstart: " + json.dumps(out["quickstart"]))
    for arch in ("smollm-135m", "falcon-mamba-7b"):
        out[f"serve_lm {arch}"] = serve_lm_twin(torch, np, dev, arch)
        log(f"serve_lm {arch}: " + json.dumps(out[f"serve_lm {arch}"]))
    out["train_lm_resumable"] = train_resumable_twin(torch, np, dev)
    log("train_lm_resumable: " + json.dumps(out["train_lm_resumable"]))
    return out


# ----------------------------------------------------------------------
# 29. the counter-based draw: the threefry kernel
# ----------------------------------------------------------------------
PRNG_CASES = (  # (global shape, offset, block): odd sizes, windows of 1 to 4 merged dims
    ((1,), (0,), (1,)),
    ((1000003,), (0,), (1000003,)),
    ((37, 129), (5, 3), (20, 100)),
    ((6, 40, 72), (1, 8, 0), (4, 16, 72)),
    ((3, 5, 7, 9), (1, 1, 2, 3), (2, 3, 4, 5)),
    ((2**33,), (2**32 - 100,), (4096,)),  # across the count's high word
    ((4, 2**16, 2**16), (3, 2**16 - 1, 2**16 - 77), (1, 1, 77)),  # the end of 2^34 elements
    ((61, 384, 7168, 2048), (60, 383, 5, 1920), (1, 1, 4000, 128)),  # kimi-k2's experts' end
)
PRNG_NORMAL_ULPS = 4  # the card's log1pf against the host's log1p, carried by ErfInv32
PRNG_KIMI_SAMPLES = 10**6
PRNG_SERVED_ARCH = "qwen3-moe-30b-a3b"  # phase 17's init: its largest launch is timed


def _ordered_f32(torch, t):
    """float32 bits as integers in the order of the floats: ulp distances."""
    i = t.float().view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


def bf16_apart(torch, got, want, n: int, what: str) -> int:
    """bfloat16 draws of the kernel and the plain version: equal but where
    their float32 values round apart, by one ulp, at most one in 10^4."""
    a, b = got.view(torch.int16).int(), want.view(torch.int16).int()
    diff = a != b
    nd = int(diff.sum())
    check(nd <= max(2, n // 10_000) and bool(((a - b)[diff].abs() == 1).all()),
          f"{what}: {nd} of {n} bf16 values differ, or by more than one ulp")
    return nd


def prng_cases(torch, dev) -> dict:
    """The kernel against its plain version, both on the card, on the
    same windows: the bits and the uniforms exactly, the normals (times a
    scale) within PRNG_NORMAL_ULPS float32 ulp, in bfloat16 equal but
    where the two round apart."""
    from repro_torch import random as R
    from repro_torch.kernels.prng import kernel as prng_kernel
    from repro_torch.kernels.prng.ref import draw_ref

    k0, k1 = R.key_words(R.split(R.PRNGKey(17), 4)[3])
    draws = (("bits", torch.int64, {}), ("uniform", torch.float32, {"minval": -3.0, "maxval": 2.5}),
             ("normal", torch.float32, {"scale": 72 ** -0.5}),
             ("normal", torch.bfloat16, {"scale": 72 ** -0.5}))
    out = {"cases": 0, "elements": 0, "max_ulps": 0, "max_abs_err": 0.0, "bf16_apart": 0}
    for shape, offset, block in PRNG_CASES:
        n = 1
        for b in block:
            n *= b
        for kind, dtype, kw in draws:
            what = f"threefry {kind} {dtype} of {block} at {offset} in {shape}"
            got = prng_kernel.draw_cuda(torch.empty(block, dtype=dtype, device=dev), k0, k1,
                                        shape, offset, kind, **kw)
            want = draw_ref(torch.empty(block, dtype=dtype, device=dev), k0, k1, shape, offset,
                            kind, **kw)
            torch.cuda.synchronize()
            if kind != "normal":
                check(torch.equal(got, want), f"{what}: the kernel != its plain version")
            elif dtype == torch.float32:
                ulps = int((_ordered_f32(torch, got) - _ordered_f32(torch, want)).abs().max())
                check(ulps <= PRNG_NORMAL_ULPS, f"{what}: {ulps} ulp from its plain version")
                out["max_ulps"] = max(out["max_ulps"], ulps)
                out["max_abs_err"] = max(out["max_abs_err"], float((got - want).abs().max()))
            else:
                out["bf16_apart"] += bf16_apart(torch, got, want, n, what)
            out["cases"] += 1
        out["elements"] += n
    return out


def prng_bound(info: dict, n: int, out_bytes: int) -> dict:
    """The least time of a draw of ``n`` elements: its output written once
    at the memory's rate, or its int32 operations at the SMs' int32 lanes
    (the float part, on the FP32 lanes beside them, is shorter)."""
    from repro_torch.kernels.prng import kernel as prng_kernel

    bytes_ms = n * out_bytes / HBM_BYTES_PER_S * 1e3
    ops_ms = max(n * prng_kernel.INT32_OPS_PER_ELEMENT / info["int32_ops_per_s"],
                 n * prng_kernel.F32_FLOPS_PER_ELEMENT / F32_FLOPS_PER_S) * 1e3
    return {"bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms, "ops_ms": ops_ms,
            "bound_by": "bytes" if bytes_ms >= ops_ms else "operations"}


def prng_served_launch(torch, dev, info: dict) -> dict:
    """The largest launch of PRNG_SERVED_ARCH's init (one period slice of
    its largest stacked leaf, bf16), as the init makes it: the kernel's
    device time per call (graph replays), the plain version's on the card,
    the two outputs held together, beside the bound."""
    from repro_torch import configs
    from repro_torch import random as R
    from repro_torch.kernels.prng import kernel as prng_kernel
    from repro_torch.kernels.prng.ref import draw_ref
    from repro_torch.models import param_specs
    from repro_torch.models.transformer import _STACKED, init_scale
    from repro_torch.tree import tree_leaves

    cfg = configs.get(PRNG_SERVED_ARCH)
    specs = param_specs(cfg)
    leaves = tree_leaves(specs)
    stacked = [s for k in _STACKED for s in tree_leaves(specs.get(k, []))
               if s.init in ("normal", "embed")]
    spec = max(stacked, key=lambda s: math.prod(s.shape[1:]))
    k0, k1 = R.key_words(R.split(R.PRNGKey(0), len(leaves))[leaves.index(spec)])
    block, offset = (1, *spec.shape[1:]), (0,) * len(spec.shape)
    n = math.prod(block)
    scale = init_scale(spec)
    buf = torch.empty(block, dtype=torch.bfloat16, device=dev)
    plain = torch.empty_like(buf)

    def kern():
        prng_kernel.draw_cuda(buf, k0, k1, spec.shape, offset, "normal", scale)

    def ref_draw():
        draw_ref(plain, k0, k1, spec.shape, offset, "normal", scale)

    ms = graph_ms(torch, kern, calls=5, replays=5)
    kern()
    plain_ms = time_ms(torch, ref_draw, iters=1)
    apart = bf16_apart(torch, buf, plain, n, f"{PRNG_SERVED_ARCH}'s largest init launch")
    del buf, plain
    torch.cuda.empty_cache()
    return {"shape": f"{PRNG_SERVED_ARCH}'s largest init launch: one period slice {list(block)} "
                     f"of a {list(spec.shape)} leaf, normal x {scale:.6g} to bf16 ({n} elements)",
            "n": n, "ms": ms, "plain_ms": plain_ms, "bf16_apart": apart, "library_ms": None,
            **prng_bound(info, n, 2)}


def kimi_shard_child() -> int:
    """Rank 0 of a fake 256-rank group over the production 16x16 mesh draws
    its shard of kimi-k2-1t-a32b on the card (``init_params(...,
    shardings=)``): launches, time, its bytes and the card's peak; 10^6
    sampled elements against the plain version at the same global
    indices; then one launch over the shard's largest leaf timed by graph
    replay.  Run in a process of its own (the fake group is global);
    prints one JSON line."""
    import torch

    sys.path.insert(0, str(ROOT / "src"))
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    from repro_torch import configs
    from repro_torch import random as R
    from repro_torch.distributed import MeshRules
    from repro_torch.kernels.prng import kernel as prng_kernel
    from repro_torch.kernels.prng import ref
    from repro_torch.launch.dryrun import fake_group
    from repro_torch.launch.mesh import make_production_mesh
    from repro_torch.models import init_params, param_shardings, param_specs
    from repro_torch.models.transformer import init_scale
    from repro_torch.tree import tree_leaves

    dev = torch.device("cuda", 0)
    torch.cuda.set_device(dev)
    cfg = configs.get("kimi-k2-1t-a32b")
    out = {"arch": cfg.name, "whole_gb": cfg.param_count() * 2 / 1e9}
    with fake_group(256):
        mesh = make_production_mesh(device_type="cuda")
        shardings = param_shardings(cfg, MeshRules(mesh))
        torch.cuda.synchronize()
        base = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        prng_kernel.launches.reset()
        t0 = time.perf_counter()
        params = init_params(cfg, R.PRNGKey(0), device=dev, shardings=shardings)
        torch.cuda.synchronize()
        out["s"] = time.perf_counter() - t0
        out["launches"] = prng_kernel.launches.value
        out["peak_bytes"] = torch.cuda.max_memory_allocated() - base
        leaves = tree_leaves(params)
        locals_ = [p.to_local() for p in leaves]
        out["bytes"] = sum(t.numel() * t.element_size() for t in locals_)
        out["largest_leaf"] = max(t.numel() for t in locals_)
        out["chunk_bytes"] = ref.CHUNK * 8
        specs = tree_leaves(param_specs(cfg))
        keys = R.split(R.PRNGKey(0), len(specs))
        normal = [i for i, s in enumerate(specs) if s.init in ("normal", "embed")]
        total = sum(locals_[i].numel() for i in normal)
        gen = torch.Generator().manual_seed(0)
        n_samples = n_apart = 0
        for i in normal:
            p, local, spec = leaves[i], locals_[i], specs[i]
            k = max(1, PRNG_KIMI_SAMPLES * local.numel() // total)
            pos = torch.randint(local.numel(), (k,), generator=gen)
            shape, offset = compute_local_shape_and_global_offset(
                p.shape, p.device_mesh, p.placements)
            check(tuple(shape) == tuple(local.shape), f"kimi-k2 leaf {i}: local {local.shape} "
                                                      f"!= {shape}")
            # local flat position -> global flat index, one dim at a time
            g, rem, stride = torch.zeros_like(pos), pos.clone(), 1
            for d in reversed(range(len(shape))):
                g += (rem % shape[d] + offset[d]) * stride
                rem //= shape[d]
                stride *= spec.shape[d]
            want = ref.values_at(*R.key_words(keys[i]), g.to(dev), "normal",
                                 init_scale(spec)).to(local.dtype)
            got = local.reshape(-1)[pos.to(dev)]
            n_apart += bf16_apart(torch, got, want, k, f"kimi-k2 leaf {i}")
            n_samples += k
        out["samples"], out["samples_apart"] = n_samples, n_apart
        # one launch over the shard's largest leaf, timed
        i = max(range(len(leaves)), key=lambda j: locals_[j].numel())
        shape, offset = compute_local_shape_and_global_offset(
            leaves[i].shape, leaves[i].device_mesh, leaves[i].placements)
        spec = specs[i]
        del params, leaves, locals_
        torch.cuda.empty_cache()
        buf = torch.empty(tuple(shape), dtype=torch.bfloat16, device=dev)
        k0, k1 = R.key_words(keys[i])
        out["leaf"] = {"global": list(spec.shape), "offset": list(offset), "block": list(shape),
                       "n": buf.numel()}
        out["leaf"]["ms"] = graph_ms(torch, lambda: prng_kernel.draw_cuda(
            buf, k0, k1, spec.shape, offset, "normal", init_scale(spec)), calls=2, replays=3)
    print(json.dumps(out), flush=True)
    return 0


def prng_phase(torch, np, dev, info: dict, inits: dict) -> dict:
    """Phase 29: the threefry kernel against its plain version; its time
    at the largest launch of a served init and over kimi-k2's largest
    local leaf beside the bound; every served init of phases 8-21
    (``inits``: arch -> ``serve_lm``'s ``init``); rank 0's kimi-k2 shard
    drawn on the card in a process of its own."""
    cases = prng_cases(torch, dev)
    log("threefry kernel vs plain version on the card: " + json.dumps(cases))
    served = prng_served_launch(torch, dev, info)
    log("threefry at the served init: " + json.dumps(served))
    for arch, init in inits.items():
        log(f"init {arch}: {init['params']} parameters, {init['gb']:.3f} GB drawn on the card in "
            f"{init['s']:.3f} s ({init['gb'] / init['s']:.1f} GB/s of parameters) by "
            f"{init['launches']} threefry launches")
    fresh_card(torch)
    t0 = time.perf_counter()
    child = subprocess.run(
        [sys.executable, "-c", "import sys, chip_smoke; sys.exit(chip_smoke.kimi_shard_child())"],
        cwd=ROOT, capture_output=True, text=True, timeout=900)
    check(child.returncode == 0, "the kimi-k2 shard draw failed:\n" + child.stdout[-4000:]
          + child.stderr[-4000:])
    kimi = json.loads(child.stdout.strip().splitlines()[-1])
    kimi["wall_s"] = time.perf_counter() - t0
    check(kimi["peak_bytes"] <= kimi["bytes"] + kimi["chunk_bytes"],
          f"kimi-k2 rank 0: peak {kimi['peak_bytes']} B beyond its shard {kimi['bytes']} B and "
          f"one chunk's {kimi['chunk_bytes']} B")
    check(round(kimi["bytes"] / 1e9, 2) == 8.16, f"kimi-k2 rank 0 holds {kimi['bytes']} B")
    kimi["leaf"].update(prng_bound(info, kimi["leaf"]["n"], 2))
    log("kimi-k2-1t-a32b rank 0 of 256 (16x16 mesh, fake group): " + json.dumps(kimi))
    return {
        "name": "prng",
        "route": "cuda",
        "source": "src/repro_torch/kernels/prng/csrc/threefry.cu",
        "replaces": "src/repro/models/transformer.py:146",
        "replaces_note": "no TPU kernel: the JAX package's jax.random.normal per leaf "
                         "(_init_leaf), which XLA lowers to its own threefry",
        "launches": inits["smollm-135m"]["launches"],  # phase 8's init
        "max_abs_err": cases["max_abs_err"],
        **{k: served[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                  "shape")},
        "served": served,
        "cases": cases,
        "inits": inits,
        "kimi_shard": kimi,
    }


# ----------------------------------------------------------------------
# 30. the categorical pick: the Gumbel-max kernel
# ----------------------------------------------------------------------
PICK_ULPS = 4  # float32: the card's logf against the plain version's log, carried to the scores
PICK_TEMPERATURES = (1.0, 0.7)
PICK_TIED_ROWS = 2  # rows of one logit value each case: the noise's ties decide them
PICK_SERVED_ARCH = "smollm-135m"
PICK_F32_ARCH = "falcon-mamba-7b"  # held in float32 at full width (phase 11)


def pick_logits(torch, dev, b, v, dtype, seed):
    """[b, v] decode-like logits (normal x 3) in ``dtype``, the first
    PICK_TIED_ROWS rows of one value each (bfloat16: 0, where the largest
    of the 128 noise values ties; float32: 2^26, whose spacing of 8 rounds
    most of the noise away)."""
    gen = torch.Generator(dev).manual_seed(seed)
    x = torch.randn((b, v), generator=gen, device=dev) * 3
    x[:PICK_TIED_ROWS] = 0.0 if dtype == torch.bfloat16 else 2.0**26
    return x.to(dtype)


def pick_cases(torch, dev) -> dict:
    """The pick kernel against its plain version, both on the card, at each
    served architecture's decode logits [8, padded vocabulary] in bfloat16
    and at falcon-mamba-7b's in float32, at PICK_TEMPERATURES, with tied
    rows: bfloat16 picks equal; float32 picks equal but where the plain
    scores of the two picks lie within PICK_ULPS ulp (counted).  Then the
    threefry kernel's Gumbel draws against the plain version's: bfloat16
    equal (every one of its 128 values), float32 within two ulp of the
    larger of |x| and 1."""
    from repro_torch import configs
    from repro_torch import random as R
    from repro_torch.kernels.prng import kernel as prng_kernel
    from repro_torch.kernels.prng.ref import draw_ref, gumbel_pick_ref, pick_scores_ref

    shapes = {arch: (configs.get(arch).padded_vocab, torch.bfloat16) for arch in lm_paths()}
    shapes[PICK_F32_ARCH + " (f32)"] = (configs.get(PICK_F32_ARCH).padded_vocab, torch.float32)
    out = {"cases": 0, "rows": 0, "rows_apart": 0, "max_abs_err": 0.0, "ties": 0, "by_arch": {}}
    for i, (arch, (v, dtype)) in enumerate(shapes.items()):
        x = pick_logits(torch, dev, SERVE_BATCH, v, dtype, i)
        for temperature in PICK_TEMPERATURES:
            k0, k1 = R.key_words(R.split(R.PRNGKey(i), 2)[1])
            got = prng_kernel.gumbel_pick_cuda(x, k0, k1, temperature)
            want = gumbel_pick_ref(x, k0, k1, temperature)
            scores = pick_scores_ref(x, k0, k1, temperature).float()
            torch.cuda.synchronize()
            rows = torch.arange(SERVE_BATCH, device=dev)
            apart = got != want
            top = scores.max(-1).values
            out["ties"] += int(((scores == top[:, None]).sum(-1) > 1).sum())
            err = float((scores[rows, got] - scores[rows, want]).abs().max())
            what = f"pick {arch} {str(dtype)[6:]} [{SERVE_BATCH}, {v}] T {temperature}"
            if dtype == torch.bfloat16:
                check(not bool(apart.any()), f"{what}: kernel {got.tolist()} != plain "
                                             f"{want.tolist()}")
            else:
                ulps = (_ordered_f32(torch, scores[rows, got])
                        - _ordered_f32(torch, scores[rows, want])).abs()
                check(bool((ulps[apart] <= PICK_ULPS).all()),
                      f"{what}: rows {apart.nonzero().flatten().tolist()} apart by "
                      f"{ulps[apart].tolist()} ulp of their scores")
            out["cases"] += 1
            out["rows"] += SERVE_BATCH
            out["rows_apart"] += int(apart.sum())
            out["max_abs_err"] = max(out["max_abs_err"], err)
            out["by_arch"].setdefault(arch, []).append(
                {"T": temperature, "rows_apart": int(apart.sum()), "max_abs_err": err})
    check(out["ties"] >= PICK_TIED_ROWS, f"pick: only {out['ties']} rows tie at their maximum")
    # the Gumbel draws of the threefry kernel
    k0, k1 = R.key_words(R.PRNGKey(5))
    n = 1 << 20
    got = prng_kernel.draw_cuda(torch.empty(n, dtype=torch.bfloat16, device=dev), k0, k1, (n,),
                                (0,), "gumbel")
    want = draw_ref(torch.empty(n, dtype=torch.bfloat16, device=dev), k0, k1, (n,), (0,),
                    "gumbel")
    check(torch.equal(got, want), "gumbel bf16: the threefry kernel != its plain version")
    out["gumbel_bf16_values"] = int(torch.unique(got).numel())
    got = prng_kernel.draw_cuda(torch.empty(n, device=dev), k0, k1, (n,), (0,), "gumbel")
    want = draw_ref(torch.empty(n, device=dev), k0, k1, (n,), (0,), "gumbel")
    scale = torch.maximum(want.abs(), torch.ones_like(want))
    scale = (torch.nextafter(scale, scale * 2) - scale).double()
    far = float(((got.double() - want.double()).abs() / scale).max())
    check(far <= 2, f"gumbel f32: the threefry kernel {far} ulp of max(|x|, 1) from its plain "
                    "version")
    out["gumbel_f32_ulps_of_max_x_1"] = far
    out["gumbel_f32_apart"] = float((got != want).float().mean())
    return out


def pick_time(torch, dev, info: dict, v: int, dtype) -> dict:
    """The pick at [SERVE_BATCH, v] logits in ``dtype``: the kernel's and
    the plain version's device time per call (graph replays), beside the
    bound and ``torch.multinomial`` of the softmax (another draw, a
    yardstick only: no PyTorch call draws JAX's numbers)."""
    from repro_torch.kernels.prng import kernel as prng_kernel
    from repro_torch.kernels.prng.ref import gumbel_pick_ref

    x = pick_logits(torch, dev, SERVE_BATCH, v, dtype, 99)
    n = SERVE_BATCH * v
    ms = graph_ms(torch, lambda: prng_kernel.gumbel_pick_cuda(x, 1, 2, 0.7))
    plain_ms = graph_ms(torch, lambda: gumbel_pick_ref(x, 1, 2, 0.7), calls=2, replays=5)
    multinomial_ms = graph_ms(
        torch, lambda: torch.multinomial(torch.softmax(x.float() / 0.7, -1), 1))
    bytes_ms = (n * x.element_size() + SERVE_BATCH * 8) / HBM_BYTES_PER_S * 1e3
    ops_ms = max(n * prng_kernel.PICK_INT32_OPS_PER_ELEMENT / info["int32_ops_per_s"],
                 n * prng_kernel.PICK_F32_FLOPS_PER_ELEMENT[dtype] / F32_FLOPS_PER_S) * 1e3
    return {"shape": f"logits [{SERVE_BATCH}, {v}] {str(dtype)[6:]}, T 0.7", "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bytes_ms, ops_ms), "bytes_ms": bytes_ms,
            "ops_ms": ops_ms, "bound_by": "bytes" if bytes_ms >= ops_ms else "operations",
            "library_ms": None, "multinomial_ms": multinomial_ms}


def serve_categorical(torch, np, dev) -> dict:
    """PICK_SERVED_ARCH served as phase 8 serves it, with
    ``sample="categorical"``: counted (the flash launches of phase 8, one
    pick launch a pick -- after prefill and after each decode step -- and
    no other kernel); the tokens equal to the same engine's with the pick
    swapped for its plain version (the key reset to the reference's
    PRNGKey(0)); tokens/s beside greedy's on the same engine."""
    from repro_torch import configs
    from repro_torch.kernels.prng import ref
    from repro_torch.models import init_params
    from repro_torch.random import PRNGKey
    from repro_torch.serve import engine as engine_mod

    cfg = configs.get(PICK_SERVED_ARCH)
    want = expected_launches(cfg)
    params = init_params(cfg, PRNGKey(0), device=dev)
    prompts = np.random.default_rng(0).integers(
        2, cfg.vocab_size, size=(SERVE_BATCH, PROMPT_LEN)).astype(np.int32)
    eng = engine_mod.Engine(cfg, params, batch_size=SERVE_BATCH, max_seq=SERVE_MAX_SEQ,
                            eos_id=-1, sample="categorical", temperature=0.7)

    def run(sample):
        eng.sample, eng.key = sample, PRNGKey(0)
        reqs = requests_for(prompts, NEW_TOKENS)
        torch.cuda.synchronize()
        reset_counts()
        t0 = time.perf_counter()
        eng.generate(reqs)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        return [r.out_tokens for r in reqs], read_counts(), dt

    run("categorical")  # warm-up: the first prefill's cuBLAS choices
    greedy, _, greedy_s = run("greedy")
    toks, counts, cat_s = run("categorical")
    flash = {k: want["prefill"][k] + (NEW_TOKENS - 1) * want["decode"][k] for k in want["decode"]}
    picks = NEW_TOKENS  # one after prefill, one after each of the NEW_TOKENS - 1 decode steps
    check(counts["gumbel_pick"] == picks,
          f"categorical serve: {counts['gumbel_pick']} pick launches, want {picks}")
    check({k: counts[k] for k in flash} == flash,
          f"categorical serve: launches {counts}, want {flash} and {picks} picks")
    check_only(counts, {"gumbel_pick", *flash}, "the categorical serve")
    check(all(len(t) == NEW_TOKENS and all(0 <= x < cfg.padded_vocab for x in t) for t in toks),
          "categorical serve: a request fell short or a token lies outside the logits")
    check(toks != greedy, "categorical serve: the same tokens as greedy")
    plain_pick = lambda logits, k0, k1, t: ref.gumbel_pick_ref(logits, k0, k1, t)  # noqa: E731
    with swapped([(engine_mod, "gumbel_pick", plain_pick)]):
        plain, plain_counts, _ = run("categorical")
    check(plain_counts["gumbel_pick"] == 0, "the plain-swapped engine launched the pick kernel")
    n_diff = sum(a != b for ta, tb in zip(toks, plain) for a, b in zip(ta, tb))
    check(n_diff == 0, f"categorical serve: {n_diff} tokens differ from the plain pick's")
    n_tok = SERVE_BATCH * NEW_TOKENS
    out = {"arch": cfg.name, "launches": {k: counts[k] for k in ("gumbel_pick", *flash)},
           "picks": picks, "tokens_per_s": n_tok / cat_s, "greedy_tokens_per_s": n_tok / greedy_s,
           "tokens_equal_plain_pick": True}
    del eng, params
    torch.cuda.empty_cache()
    return out


def pick_phase(torch, np, dev, info: dict) -> dict:
    """Phase 30: the Gumbel-max pick kernel against its plain version, its
    time beside its bound, and smollm-135m served categorically through
    it."""
    from repro_torch import configs

    cases = pick_cases(torch, dev)
    log("pick kernel vs plain version on the card: " + json.dumps(cases))
    main_t = pick_time(torch, dev, info, configs.get(PICK_SERVED_ARCH).padded_vocab,
                       torch.bfloat16)
    f32_t = pick_time(torch, dev, info, configs.get(PICK_F32_ARCH).padded_vocab, torch.float32)
    log("pick times: " + json.dumps({"bf16": main_t, "f32": f32_t}))
    served = serve_categorical(torch, np, dev)
    log(f"serve {served['arch']} categorically (T 0.7): " + json.dumps(served))
    return {
        "name": "gumbel_pick",
        "route": "cuda",
        "source": "src/repro_torch/kernels/prng/csrc/gumbel_pick.cu",
        "replaces": "src/repro/serve/engine.py:60",
        "replaces_note": "no TPU kernel: the JAX engine's jax.random.categorical(sub, logits / T), "
                         "which XLA runs as threefry, -log(-log(u)), an add and an argmax",
        "launches": served["launches"]["gumbel_pick"],
        "max_abs_err": cases["max_abs_err"],
        **{k: main_t[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
                                  "shape", "multinomial_ms")},
        "library": "none: no PyTorch call draws JAX's numbers (torch.multinomial of the "
                   "softmax, another draw, timed as multinomial_ms)",
        "f32": f32_t,
        "cases": cases,
        "serve": served,
    }


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
    n_steps = count_cmvm_steps(served.step_specs)
    with ServeEngine(cfg) as eng:
        eng.register("mixer", served)  # no warm-up: graphs are captured at first use
        t_reg = time.perf_counter()
        futs = eng.submit_batch("mixer", np.concatenate([x_gold] * reps))
        outs = [f.result(120) for f in futs]
        t_done = time.perf_counter()
        first = eng.stats("mixer")
        # the same burst again, every graph captured: the steady state
        t_again = time.perf_counter()
        futs2 = eng.submit_batch("mixer", np.concatenate([x_gold] * reps))
        outs += [f.result(120) for f in futs2]
        t_done2 = time.perf_counter()
        stats = eng.stats("mixer")
        counts = read_counts()
        main_launches = counts["adder_graph"]
        # the profiler's count of one replay of a shard's graph, against
        # the launches its capture recorded
        shard = eng._runner("mixer").shards[0]
        with shard._device_lock:
            bucket, (_, graph) = max(shard._graphs.items())
            prof = profile_once(torch, graph.replay, "namespace)::adder_graph_")
    got = np.stack(outs)
    check(np.array_equal(got, np.concatenate([y_gold] * 2 * reps)), "served outputs != JAX golden")
    check(stats["n_fallback_batches"] == 0, "fallback batches")
    check(stats["breaker"]["n_trips"] == 0, "the circuit breaker opened")
    check(stats["supervision"]["n_crashes"] == 0, "a dispatch shard crashed")
    used = {b: sum(sh["bucket_hits"][b] > 0 for sh in stats["shards"]) for b in stats["buckets"]}
    check(stats["jit_compiles"] == used,
          f"graphs captured {stats['jit_compiles']}, (shard, bucket) pairs used {used}")
    check(stats["n_graph_replays"] == stats["n_batches"],
          f"{stats['n_graph_replays']} replays for {stats['n_batches']} batches")
    per_replay = stats["graph_launches_per_replay"]
    check(all(v == {"adder_graph": n_steps} for v in per_replay.values()),
          f"launches per replay {per_replay}, want {n_steps} adder-graph launches")
    want_launches = (stats["n_jit_compiles"] + stats["n_batches"]) * n_steps
    check(main_launches == want_launches,
          f"{main_launches} launches on the main path, expected {want_launches} (one warm-up "
          f"per capture and one replay per batch, {n_steps} CMVM steps each)")
    check_only(counts, "adder_graph", "the Mixer's serve")
    check(prof["all_ms"] is not None,
          "the profiler shows no device time inside a graph replay: the launches per replay "
          "cannot be cross-checked")
    check(prof["key_launches"] == n_steps,
          f"the profiler sees {prof['key_launches']} adder-graph launches in one replay, "
          f"the capture recorded {n_steps}")
    rps = len(futs) / (t_done - t_reg)
    rps2 = len(futs2) / (t_done2 - t_again)

    def second_burst_mean_us(st):  # per batch (queue_wait: per request)
        total = stats["per_stage"][st]["total_ms"] - first["per_stage"][st]["total_ms"]
        count = stats["per_stage"][st]["count"] - first["per_stage"][st]["count"]
        return total * 1e3 / max(1, count)

    log(f"serve: {len(futs)} requests, then {len(futs2)} again, all bit-exact; first burst "
        f"(graphs captured at first use) {rps:.0f} req/s, p50 {first['p50_ms']:.3f} ms, p99 "
        f"{first['p99_ms']:.3f} ms, {first['n_batches']} batches; second burst {rps2:.0f} req/s, "
        f"{stats['n_batches'] - first['n_batches']} batches; {main_launches} launches = "
        f"({stats['n_jit_compiles']} captures + {stats['n_batches']} replays) x {n_steps}; "
        f"graphs captured per bucket (shards): {json.dumps(stats['jit_compiles'])} in "
        f"{stats['jit_compile_ms']:.1f} ms (warm-up runs included); "
        f"load + register {t_reg - t0:.2f} s")
    log("serve stage means, us: first burst "
        + json.dumps({st: v["mean_us"] for st, v in first["per_stage"].items()})
        + "; second burst " + json.dumps({st: second_burst_mean_us(st) for st in first["per_stage"]}))
    log(f"serve: profiler over one replay of bucket {bucket}: {prof['key_launches']} adder-graph "
        f"launches (recorded at capture: {n_steps}), device time {prof['all_ms']} ms, of which "
        f"the kernel {prof['key_ms']} ms, in {prof['launches']} launches")

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
    lm_golden(torch, np, dev, "smollm_smoke")

    log("== 8. serve smollm-135m at full width (main path)")
    lm = serve_lm(torch, np, dev, "smollm-135m")
    inits = {"smollm-135m": lm["init"]}  # each served path's init, for phase 29
    ft = flash_times(torch, lm["inputs"]["flash_attention"])
    dec, pre = ft["decode"], ft["prefill"]
    flash_entry = {
        "name": "flash_attention",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
        "launches": lm["launches"]["flash_attention"],
        "max_abs_err": max(*flash_errs.values(), dec["max_abs_err"], pre["max_abs_err"]),
        "ms": dec["ms"],
        "plain_ms": dec["plain_ms"],
        "bound_ms": dec["bound_ms"],
        "bound_by": dec["bound_by"],
        "library_ms": dec["library_ms"],
        "shape": "one decode launch of the main path (layer 0): " + dec["shape"],
        "prefill": {k: pre[k] for k in ("shape", "ms", "plain_ms", "bound_ms", "bound_by",
                                        "library_ms")},
    }
    kernels["kernels"].append(flash_entry)
    log("serve summary: " + json.dumps({k: v for k, v in lm.items() if k != "inputs"}))
    del lm, ft

    log("== 9. selective-scan and W8A8 matmul kernels vs their plain versions")
    scan_phase9 = scan_cases(torch, dev)
    qmm_phase9 = qmm_cases(torch, dev)

    log("== 10. reduced falcon-mamba against the committed JAX golden outputs")
    lm_golden(torch, np, dev, "falcon_mamba_smoke")

    log("== 11. serve falcon-mamba-7b at full width (main path); the W8A8 matmul's op")
    sm = serve_lm(torch, np, dev, "falcon-mamba-7b")
    inits["falcon-mamba-7b"] = sm["init"]
    n_layers = sm["launches"]["ssm_scan"] // NEW_TOKENS
    want = {"decode": n_layers * (NEW_TOKENS - 1), "prefill": n_layers}
    check(sm["launches_by_kernel"] == want,
          f"falcon-mamba's serve took the scan kernels {sm['launches_by_kernel']}, want {want}")
    log(f"serve: scan launches by kernel {sm['launches_by_kernel']}")
    st = scan_times(torch, sm["inputs"]["ssm_scan"], info)
    dec, pre = st["decode"], st["prefill"]
    entry_keys = ("shape", "kernel", "ms", "timed", "l2_warm_ms", "plain_ms", "bound_ms",
                  "bound_by", "library_ms", "library", "max_abs_err")
    scan_entry = {
        "name": "ssm_scan",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:25",
        "launches": sm["launches"]["ssm_scan"],
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
    }
    kernels["kernels"].append(scan_entry)
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
    log("== 12. the interpreter fallback while the breaker is open")
    fb = serve_fallback(torch, np, mixer_path, x_gold, y_gold, n_steps)

    log("== 13. serve stablelm-3b at full width (head_dim 80)")
    sl = serve_lm(torch, np, dev, "stablelm-3b")
    inits["stablelm-3b"] = sl["init"]
    ft = flash_times(torch, {f"stablelm-3b {k}": v
                             for k, v in sl["inputs"]["flash_attention"].items()})
    ft.update(flash_times(torch, head_dim_inputs(torch, dev)))
    flash_entry["head_dims"] = {name: {k: row[k] for k in HEAD_DIM_KEYS}
                                for name, row in ft.items()}
    flash_entry["launches_stablelm_3b"] = sl["launches"]["flash_attention"]
    flash_entry["max_abs_err"] = max(flash_entry["max_abs_err"],
                                     *(row["max_abs_err"] for row in ft.values()))
    log("serve summary: " + json.dumps({k: v for k, v in sl.items() if k != "inputs"}))
    log("fallback summary: " + json.dumps(fb))
    del sl, ft

    log("== 14. compile in the port, serve on the card")
    cp, port_mixer = compile_in_port(torch, np, dev, golden, info)
    kernels["kernels"][0]["launches_compiled_in_port"] = cp["serve"]["adder_graph_launches"]
    log("compile summary: " + json.dumps(cp))

    log("== 15. the flow facade: versioned rollouts on the card")
    fl = serve_flow(torch, np, dev, mixer_path, x_gold, y_gold, port_mixer)
    kernels["kernels"][0]["launches_flow_rollout"] = fl["mixer_rollout"]["adder_graph_launches"]
    log("flow summary: " + json.dumps(fl))
    del port_mixer

    log("== 16. the co-sim gate, its device leg on the card")
    cs = cosim_on_card(torch, dev)
    kernels["kernels"][0]["launches_cosim"] = cs["adder_graph_launches"]

    log("== 17. serve qwen3-moe-30b-a3b at full width (MoE)")
    inits["qwen3-moe-30b-a3b"] = serve_phase(
        torch, np, dev, "qwen3-moe-30b-a3b", flash_entry, scan_entry, info)["init"]

    log("== 18. reduced jamba, whisper and internvl2 against the committed JAX golden outputs")
    fresh_card(torch)
    for name in ("jamba_smoke", "whisper_smoke", "internvl2_smoke"):
        got = lm_golden(torch, np, dev, name)
        for kern, n in got.items():
            (flash_entry if kern == "flash_attention" else scan_entry)[f"launches_{name}"] = n

    left_18 = left_on_card(torch, "after phase 18")
    log("== 19. serve whisper-base at full width (encoder-decoder)")
    inits["whisper-base"] = serve_phase(
        torch, np, dev, "whisper-base", flash_entry, scan_entry, info)["init"]
    left_19 = left_on_card(torch, "after phase 19")
    diff_left(left_18, left_19)
    cublas_share(torch, left_19)
    del left_18, left_19

    log("== 20. serve internvl2-26b at full width (VLM)")
    inits["internvl2-26b"] = serve_phase(
        torch, np, dev, "internvl2-26b", flash_entry, scan_entry, info)["init"]

    log(f"== 21. serve jamba-v0.1-52b at full width, cut to {JAMBA_LAYERS} layers (hybrid)")
    inits["jamba-v0.1-52b"] = serve_phase(
        torch, np, dev, "jamba-v0.1-52b", flash_entry, scan_entry, info)["init"]

    log("== 22. the backward kernels vs their plain versions")
    fresh_card(torch)
    bwd_err = bwd_cases(torch, dev)
    log(f"backward kernels: largest relative error {bwd_err}")

    log("== 23. train smollm-135m at full width (main path: Trainer, Pipeline)")
    sm_train = train_smollm(torch, np, dev, info)
    flash_entry["launches_train_smollm_135m"] = sm_train["launches"]["flash_attention"]
    fb = sm_train["flash_bwd"]
    kernels["kernels"].append({
        "name": "flash_attention_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/flash_attention/csrc/flash_attention_bwd.cu",
        "replaces": "src/repro/kernels/flash_attention/kernel.py:28",
        "replaces_note": "the backward of the flash kernel: the JAX package differentiates "
                         "attention_ref instead (it has no backward kernel)",
        "launches": sm_train["launches"]["flash_attention_bwd"],
        "max_abs_err": fb["max_abs_err"],
        "rel_err": max(bwd_err, fb["rel_err"]),
        **{k: fb[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "library")},
        "shape": "one backward launch of smollm-135m's train step: " + fb["shape"],
        "timed_stretch": {k: sm_train["flash_bwd_long"][k] for k in (
            "shape", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms", "max_abs_err",
            "rel_err")},
    })
    log("smollm-135m training summary: " + json.dumps(sm_train))

    log(f"== 24. train falcon-mamba-7b at full width, cut to {FALCON_TRAIN_LAYERS} layers")
    fresh_card(torch)
    fm_train = train_falcon(torch, np, dev, info)
    scan_entry["launches_train_falcon_mamba_7b"] = fm_train["launches"]["ssm_scan"]
    sb = fm_train["scan_bwd"]
    kernels["kernels"].append({
        "name": "ssm_scan_bwd",
        "route": "cuda",
        "source": "src/repro_torch/kernels/ssm_scan/csrc/ssm_scan_bwd.cu",
        "replaces": "src/repro/kernels/ssm_scan/kernel.py:25",
        "replaces_note": "the backward of the scan kernel: the JAX package differentiates the "
                         "Mamba block's lax.scan instead (it has no backward kernel)",
        "launches": fm_train["launches"]["ssm_scan_bwd"],
        "max_abs_err": sb["max_abs_err"],
        "rel_err": max(bwd_err, sb["rel_err"]),
        **{k: sb[k] for k in ("ms", "eager_ms", "plain_ms", "bound_ms", "bound_by",
                              "library_ms", "library")},
        "shape": "one backward launch of falcon-mamba-7b's train step: " + sb["shape"],
    })
    log("falcon-mamba-7b training summary: " + json.dumps(fm_train))

    log("== 25. the jet tagger's QAT workflow on the card")
    fresh_card(torch)
    jet = train_jet_tagger_phase(torch)
    kernels["kernels"][0]["launches_jet_tagger"] = jet["adder_graph_launches"]

    # phase 27's dry-run (CPU only) runs in the background from here on,
    # after every phase that times the host or holds a profile to a capture
    dry_runs = start_dryrun()
    dry_started = time.perf_counter()
    atexit.register(lambda: [p.kill() for p, _ in dry_runs if p.poll() is None])

    log("== 26. the sharded path on the card (one-rank NCCL group, 1x1 mesh)")
    fresh_card(torch)
    base = torch.cuda.memory_allocated()
    t26 = time.perf_counter()
    sh = sharded_on_card(torch, np, dev)
    flash_entry["launches_sharded_train_smollm_135m"] = sh["train"]["launches"]["flash_attention"]
    flash_entry["launches_sharded_decode_smollm_135m"] = sh["decode"]["launches"][
        "flash_attention"]
    scan_entry["launches_sharded_jamba_smoke"] = sh["jamba"]["launches"]["ssm_scan"]
    log("sharded path summary: " + json.dumps(sh))

    log("== 27. the launch tools: step analysis, H100 roofline, dry-run")
    lt = launch_tools_phase(torch, np, dev, info, sm_train)
    lt["dryrun"] = finish_dryrun(dry_runs, dry_started)
    log("launch tools summary: " + json.dumps(lt))
    del sh, lt
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base
    log(f"phases 26-27: {time.perf_counter() - t26:.1f} s; allocated {left} bytes more than "
        f"before phase 26")
    check(abs(left) <= SHARD_LEFT_BYTES,
          f"phases 26-27 left {left} bytes allocated (at most {SHARD_LEFT_BYTES})")

    log("== 28. the examples' twins on the card")
    # PyTorch keeps a cuBLAS workspace for each stream a product ran on
    # (each engine captures on a stream from its pool): cleared on both
    # sides of the phase, as the allocator's cache is emptied
    clear_workspaces = getattr(torch._C, "_cuda_clearCublasWorkspaces", lambda: None)
    gc.collect()
    clear_workspaces()
    torch.cuda.empty_cache()
    base = torch.cuda.memory_allocated()
    t28 = time.perf_counter()
    ex = examples_phase(torch, np, dev)
    entries = {e["name"]: e for e in kernels["kernels"]}
    ex_launches = {twin: r["launches"] for twin, r in ex.items()}
    for name, entry in entries.items():
        runs = {twin: n[name] for twin, n in ex_launches.items() if n.get(name)}
        if runs:
            entry["launches_examples"] = runs
    del ex
    gc.collect()
    torch.cuda.empty_cache()
    with_workspaces = torch.cuda.memory_allocated() - base
    clear_workspaces()
    torch.cuda.empty_cache()
    left = torch.cuda.memory_allocated() - base
    log(f"phase 28: {time.perf_counter() - t28:.1f} s; allocated {left} bytes more than "
        f"before it ({with_workspaces} before the cuBLAS workspaces were cleared)")
    check(abs(left) <= SHARD_LEFT_BYTES,
          f"phase 28 left {left} bytes allocated (at most {SHARD_LEFT_BYTES})")

    log("== 29. the counter-based draw: the threefry kernel")
    fresh_card(torch)
    prng_entry = prng_phase(torch, np, dev, info, inits)
    prng_entry["launches_train_smollm_135m"] = sm_train["launches"].get("prng")
    prng_entry["launches_examples"] = {twin: n["prng"] for twin, n in ex_launches.items()
                                       if n.get("prng")}
    prng_entry["launches_jet_tagger"] = jet["prng_launches"]
    kernels["kernels"].append(prng_entry)

    log("== 30. the categorical pick: the Gumbel-max kernel")
    fresh_card(torch)
    kernels["kernels"].append(pick_phase(torch, np, dev, info))

    log(f"total {time.perf_counter() - t_start:.1f} s")
    print(info["nvidia_smi"])
    print(json.dumps(kernels))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
