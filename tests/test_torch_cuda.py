"""The port on the CUDA card: the hand-written adder-graph kernel (both
entry points: values in shared memory, and the global scratch for a
table too large for it) against its plain PyTorch version, the committed
full-size designs against their JAX golden outputs, and the serving
engine (tolerance: exact equality); the hand-written flash-attention
kernel (decode at GQA group sizes 1, 3, 4 and 8, tensor-core and
CUDA-core prefill) against its plain PyTorch version (atol 2e-5 in
float32, 2e-2 in bfloat16: the decode kernel keeps ``p`` in f32 where
the plain version casts it to the working dtype, and the outputs round
to bf16), at head_dim 80 and 112 as at the powers of two, and decode at
granite-20b's 48:1 group; the hand-written selective-scan kernels (decode at every N from 1
to 16, prefill) against their plain version (atol 1e-5, the JAX kernel
tests' own) and the W8A8 matmul kernels (TMA/wgmma and mma.sync)
against their plain version (exact); and the reduced smollm-135m
falcon-mamba, jamba, whisper and internvl2 LMs against their committed
JAX golden tokens (exact) and logits (atol 1e-4 in float32); flash at
the regimes of those three families at full width (non-causal 1500 x
1500, cross-attention over 1500 frames at prefill and decode, GQA groups
6 and 4 at head_dim 128, a 384-row prefill).  The serving paths run through CUDA
graphs: the LM engine's replayed decode step gives exactly the tokens of
an eager loop over ``prefill``/``decode_step`` (for the hybrid,
encoder-decoder and VLM families too, whose static cross cache is never
rebound), the DA engine's graphs
(two shards) give the golden outputs bit for bit with one capture per
shard and bucket used, and with ``fallback="interpreter"`` and every
dispatch failing the numpy interpreter serves the golden outputs (every
bucket captured at registration, so a capture that fails fails there);
and a design the port compiled itself (jet_tagger, weights drawn on the
card) runs each CMVM step through the kernel as ``DAISProgram.evaluate``
computes it (exact).  A ``Deployment`` rolls a model from one version
to the next while v1 is in flight (every future its own version's
output, v1's graphs released once drained); the co-sim gate's device
leg runs all 34 programs of ``default_grid()`` on the kernel, bit-exact
and equal to its CPU run; ``moe_block`` on the card equals its CPU run
(f32, atol 1e-5) and replays as a CUDA graph with no host sync, bit for
bit.  Training: the two backward kernels (flash attention, f32 and bf16,
at the head dims and GQA groups of the forward and of the families that
train, GQA group 8 and 6 at head_dim 128, non-causal over 1,500 keys;
the selective scan) against their plain versions (tolerances at
``BWD_REL``), two launches bit-equal, the forward's stored log-sum-exp
against ``attention_lse_ref`` and chunk states against
``selective_scan_chunk_states_ref``, a no-grad forward launching exactly
as before (also inside a CUDA-graph capture), ``loss.backward()``
through the reduced smollm-135m, falcon-mamba, qwen3-moe, jamba, whisper
and internvl2 reaching every attention and Mamba call's backward kernel
with the plain path's gradients, and the Trainer resuming from a crash
to the same parameters bit for bit.  The threefry kernel (the port of
the JAX package's ``jax.random`` draw) against its plain version: bits
and uniforms exactly, normals within 4 f32 ulp (the card's ``log1pf``
against the host's ``log1p``) and in bf16 equal but for one-ulp
roundings, at windows of 1 to 4 merged dims and across the count's high
word; ``init_params`` on the card launching it, within 4 ulp of the CPU
draw; its Gumbel draws (bf16 equal, f32 within two ulp of max(|x|, 1)).
The categorical pick kernel against its plain version (bf16 picks equal,
f32 equal but where the two picks' scores lie within 4 ulp), on strided
rows and in a captured graph, and the LM engine's categorical tokens on
the card equal to its tokens on the CPU.

Every test here needs a card and skips without one.  This file imports
neither ``jax`` nor ``repro``, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import dataclasses
import json
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.chaos import FaultPlan, FaultRule, active
from repro_torch.core import DAISProgram, QInterval, Term, cosim_grid
from repro_torch.flow import CompileConfig, Flow, ServeConfig
from repro_torch.kernels.adder_graph import adder_graph_apply, compile_tables
from repro_torch.kernels.adder_graph import kernel as ag_kernel
from repro_torch.kernels.adder_graph.ref import adder_graph_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention import ref as fa_ref
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.quant_matmul import kernel as qm_kernel
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
from repro_torch.kernels.ssm_scan import kernel as ss_kernel
from repro_torch.kernels.ssm_scan import selective_scan
from repro_torch.kernels.ssm_scan.ref import (selective_scan_bwd_ref,
                                              selective_scan_chunk_states_ref, selective_scan_ref)
from repro_torch.kernels.graphs import capture
from repro_torch.models import decode_step, init_params, params_from_numpy, prefill, unflatten
from repro_torch.models import moe
from repro_torch.nn import compile_model, numpy_forward_fn
from repro_torch.nn import compiler as nn_compiler
from repro_torch.nn import init_params as nn_init_params
from repro_torch.nn import models as nn_models
from repro_torch.nn.compiler import count_cmvm_steps
from repro_torch.kernels._build import KernelError
from repro_torch.random import PRNGKey
from repro_torch.runtime import ServeEngine, load_design
from repro_torch.runtime import engine as serve_engine
from repro_torch.serve import Engine, Request

pytestmark = pytest.mark.cuda

ASSETS = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "assets"


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda", 0)


def _random_program(seed, n_in=24, n_ops=300, n_out=40):
    """Operand shifts 0..40, output shifts -40..40, negations, masked
    outputs."""
    rng = np.random.default_rng(seed)
    prog = DAISProgram()
    for _ in range(n_in):
        prog.add_input(QInterval(-128, 127, 0))
    for _ in range(n_ops):
        n = len(prog.rows)
        if rng.random() < 0.1:
            prog.add_neg(int(rng.integers(n)))
            continue
        a, b = (int(i) for i in rng.integers(n, size=2))
        sh = int(rng.integers(0, 41))
        prog.add_op(a, b, *((sh, 0) if rng.random() < 0.5 else (0, sh)), int(rng.choice([-1, 1])))
    for _ in range(n_out):
        if rng.random() < 0.15:
            prog.outputs.append(None)
        else:
            row = int(rng.integers(len(prog.rows)))
            prog.outputs.append(Term(int(rng.choice([-1, 1])), row, int(rng.integers(-40, 41))))
    return prog


@pytest.mark.parametrize("seed", range(4))
@pytest.mark.parametrize("batch", [1, 7, 256, 1000])
def test_kernel_matches_plain_version(card, seed, batch):
    pt = compile_tables(_random_program(seed))
    x = np.random.default_rng(seed).integers(-128, 128, size=(batch, 24)).astype(np.int32)
    xd = torch.from_numpy(x).to(card)
    before = ag_kernel.launches.value
    got = adder_graph_apply(pt, xd)
    assert ag_kernel.launches.value == before + 1
    assert got.device == card
    np.testing.assert_array_equal(got.cpu().numpy(), adder_graph_ref(pt, xd).cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), adder_graph_apply(pt, torch.from_numpy(x)).numpy())


def _wide_program(seed, n_wide, n_in=32, n_out=48):
    """One level of ``n_wide`` ops over the inputs, read by the outputs:
    about ``n_in + n_wide`` rows live at once, so the size rule sends the
    table to one entry point or the other."""
    rng = np.random.default_rng(seed)
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


@pytest.mark.parametrize("batch", [1, 7, 300])
@pytest.mark.parametrize("n_wide,entry", [(50_000, "shared"), (60_000, "global")])
def test_both_entry_points_match_plain_version(card, n_wide, entry, batch):
    """A table just inside and one just outside a block's shared memory
    (one sample: 50,032 and 60,032 slots of 4 bytes against 232,448):
    each entry point is bit-equal to the plain version and evaluate()."""
    prog = _wide_program(n_wide, n_wide)
    pt = compile_tables(prog)
    assert pt.slot_plan.n_slots == n_wide + 32
    assert ag_kernel.plan_for(pt, batch, card).entry == entry
    x = np.random.default_rng(batch).integers(-128, 128, size=(batch, 32)).astype(np.int32)
    xd = torch.from_numpy(x).to(card)
    before = ag_kernel.launches.value
    got = ag_kernel.adder_graph_cuda(pt, xd).cpu().numpy()
    assert ag_kernel.launches.value == before + 1
    np.testing.assert_array_equal(got, adder_graph_ref(pt, xd).cpu().numpy())
    np.testing.assert_array_equal(got, prog.evaluate(x).astype(np.int32))


@pytest.mark.parametrize("batch", [1, 5, 64, 4097])
def test_mixer_tables_match_plain_version_at_every_tile(card, batch):
    """Every table of the committed Mixer through the shared-memory entry
    point, at batches whose launch plans take tiles of 1 to 32 samples."""
    design = load_design(ASSETS / "mixer_full")
    tiles = set()
    for i, t in enumerate(design.tables):
        prog = DAISProgram.from_arrays(design.programs[i])
        plan = ag_kernel.plan_for(t, batch * 16, card)
        assert plan.entry == "shared"
        tiles.add(plan.tile)
        qs = [r.qint for r in prog.rows[: prog.n_inputs]]
        rng = np.random.default_rng(i)
        x = rng.integers([q.lo for q in qs], [q.hi + 1 for q in qs],
                         size=(batch * 16, prog.n_inputs)).astype(np.int32)
        xd = torch.from_numpy(x).to(card)
        got = ag_kernel.adder_graph_cuda(t, xd).cpu().numpy()
        np.testing.assert_array_equal(got, adder_graph_ref(t, xd).cpu().numpy())
        np.testing.assert_array_equal(got, prog.evaluate(x).astype(np.int32))
    assert tiles


def test_kernel_wrapper_rejects_what_it_does_not_take(card):
    pt = compile_tables(_random_program(0))
    with pytest.raises(TypeError, match="int32"):
        ag_kernel.adder_graph_cuda(pt, torch.zeros((4, 24), dtype=torch.int64, device=card))
    with pytest.raises(ValueError, match=r"\[batch, 24\]"):
        ag_kernel.adder_graph_cuda(pt, torch.zeros((4, 23), dtype=torch.int32, device=card))
    with pytest.raises(ValueError, match="contiguous"):
        ag_kernel.adder_graph_cuda(pt, torch.zeros((24, 4), dtype=torch.int32, device=card).t())


@pytest.mark.parametrize("name", ["mixer_full", "svhn_cnn"])
def test_designs_reproduce_golden(card, name):
    design = load_design(ASSETS / name)
    assert design.device == card
    with np.load(ASSETS / name / "golden.npz") as g:
        x, y = g["x"].astype(np.int32), g["y"]
    before = ag_kernel.launches.value
    got = design.forward_int(torch.from_numpy(x).to(card)).cpu().numpy()
    assert ag_kernel.launches.value - before == count_cmvm_steps(design.step_specs)
    np.testing.assert_array_equal(got, y)


def test_port_compiled_design_on_the_card(card, monkeypatch):
    """jet_tagger compiled by the port from its own random weights (drawn
    on the card): every CMVM step's kernel output equals
    ``DAISProgram.evaluate`` of its program (int64, reduced mod 2^32), and
    the whole ``forward_int`` the numpy interpreter's."""
    model, in_shape, in_quant = nn_models.jet_tagger()
    params, _ = nn_init_params(PRNGKey(0), model, in_shape, card)
    design = compile_model(model, params, in_shape, in_quant, config=CompileConfig(jobs=2),
                           device=card)
    assert design.device == card and design.solver_stats["verify"]["ok"]
    calls = []

    def recording(tables, v):
        y = adder_graph_apply(tables, v)
        calls.append((design.tables.index(tables), v.cpu().numpy(), y.cpu().numpy()))
        return y

    monkeypatch.setattr(nn_compiler, "adder_graph_apply", recording)
    q = in_quant.qint
    x = np.random.default_rng(0).integers(q.lo, q.hi + 1, size=(1000, *in_shape)).astype(np.int32)
    before = ag_kernel.launches.value
    got = design.forward_int(torch.from_numpy(x).to(card)).cpu().numpy()
    assert ag_kernel.launches.value - before == count_cmvm_steps(design.step_specs) == len(calls)
    for i, v, y in calls:
        want = DAISProgram.from_arrays(design.programs[i]).evaluate(v.astype(np.int64))
        np.testing.assert_array_equal(y, want.astype(np.uint32).view(np.int32))
    np.testing.assert_array_equal(got, numpy_forward_fn(design)(x))


def test_engine_serves_golden(card):
    with np.load(ASSETS / "mixer_full" / "golden.npz") as g:
        x, y = g["x"][:512].astype(np.int32), g["y"][:512]
    with ServeEngine(ServeConfig(max_batch=64, shards=2)) as eng:
        eng.register("mixer", ASSETS / "mixer_full", warmup=True)
        got = np.stack([f.result(60) for f in eng.submit_batch("mixer", x)])
        s = eng.stats("mixer")
    np.testing.assert_array_equal(got, y)
    assert s["device"] == str(card) and s["n_batches"] > 0 and s["breaker"]["n_trips"] == 0
    # warmup captured every bucket on both shards; every batch replayed one
    assert s["jit_compiles"] == {b: 2 for b in s["buckets"]}
    assert s["n_graph_replays"] == s["n_batches"] and s["n_fallback_batches"] == 0


@pytest.mark.parametrize("name", ["mixer_full", "svhn_cnn"])
def test_engine_graphs_are_bit_exact_and_captured_per_bucket_used(card, name):
    """Two shards, no warm-up: each shard captures a bucket's graph at its
    first batch of that shape, and only then; one replay per batch, with
    one adder-graph launch per CMVM step counted per replay."""
    with np.load(ASSETS / name / "golden.npz") as g:
        x, y = g["x"][:300].astype(np.int32), g["y"][:300]
    design = load_design(ASSETS / name)
    n_steps = count_cmvm_steps(design.step_specs)
    before = ag_kernel.launches.value
    with ServeEngine(ServeConfig(max_batch=32, shards=2)) as eng:
        eng.register("m", design)
        futs = eng.submit_batch("m", x) + [eng.submit("m", xi) for xi in x[:7]]
        got = np.stack([f.result(120) for f in futs])
        s = eng.stats("m")
    launched = ag_kernel.launches.value - before
    np.testing.assert_array_equal(got, np.concatenate([y, y[:7]]))
    used = {b: sum(sh["bucket_hits"][b] > 0 for sh in s["shards"]) for b in s["buckets"]}
    assert s["jit_compiles"] == used and s["n_jit_compiles"] > 0
    assert s["n_graph_replays"] == s["n_batches"]
    assert all(per == {"adder_graph": n_steps}
               for per in s["graph_launches_per_replay"].values())
    # one eager warm-up per capture, one replay per batch
    assert launched == (s["n_jit_compiles"] + s["n_batches"]) * n_steps


def test_interpreter_fallback_serves_golden_while_the_breaker_is_open(card):
    """Every device dispatch fails: the breaker opens and the numpy
    interpreter serves every batch, bit for bit.  Then, with the faults
    gone, the probe after the cooldown goes back to the graphs."""
    with np.load(ASSETS / "mixer_full" / "golden.npz") as g:
        x, y = g["x"][:96].astype(np.int32), g["y"][:96]
    cfg = ServeConfig(max_batch=16, shards=2, fallback="interpreter", breaker_threshold=2,
                      breaker_cooldown_ms=100.0)
    with ServeEngine(cfg) as eng:
        eng.register("m", ASSETS / "mixer_full", warmup=True)
        with active(FaultPlan([FaultRule("serve.dispatch", rate=1.0)], seed=3)):
            got = np.stack([f.result(60) for f in eng.submit_batch("m", x)])
            s = eng.stats("m")
        np.testing.assert_array_equal(got, y)
        assert s["breaker"]["state"] == "open" and s["n_fallback_batches"] == s["n_batches"]
        replays = s["n_graph_replays"]
        time.sleep(0.25)  # past the cooldown
        np.testing.assert_array_equal(
            np.stack([eng.submit("m", xi).result(60) for xi in x[:4]]), y[:4])
        s = eng.stats("m")
        assert s["breaker"]["state"] == "closed" and s["n_graph_replays"] > replays


def test_fallback_captures_every_bucket_at_register(card, monkeypatch):
    """With the fallback configured, registration on the card captures
    every bucket on every shard, so a kernel that cannot be captured fails
    the registration instead of leaving the interpreter to serve."""
    cfg = ServeConfig(max_batch=16, shards=2, fallback="interpreter")
    with ServeEngine(cfg) as eng:
        eng.register("m", ASSETS / "mixer_full")
        s = eng.stats("m")
        assert s["jit_compiles"] == {b: 2 for b in s["buckets"]}

        def broken_capture(*args, **kwargs):
            raise KernelError("adder-graph kernel launch failed: invalid argument")

        monkeypatch.setattr(serve_engine, "capture", broken_capture)
        with pytest.raises(KernelError):
            eng.register("n", ASSETS / "mixer_full")
        assert eng.models() == ["m"]


FA_ATOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _qkv(card, dtype, b, hq, hkv, sq, sk, d, seed=0):
    g = torch.Generator(card).manual_seed(seed)
    return [torch.randn(shape, generator=g, device=card, dtype=torch.float32).to(dtype)
            for shape in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d))]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (2, 4, 4, 128, 128, 64),  # MHA
    (1, 8, 2, 128, 128, 32),  # GQA 4:1
    (2, 4, 1, 64, 256, 32),  # MQA, sq < sk
    (1, 2, 2, 256, 256, 128),
    (2, 9, 3, 128, 128, 64),  # smollm-135m's 9:3
    (1, 4, 2, 37, 53, 16),  # ragged
    (8, 32, 32, 128, 128, 80),  # stablelm-3b's prefill, head_dim 80
    (2, 4, 1, 77, 130, 80),  # ragged, head_dim 80
    (1, 8, 2, 128, 128, 112),  # head_dim 112
    (2, 6, 3, 37, 300, 112),  # ragged, head_dim 112
])
def test_flash_kernel_matches_plain_version(card, dtype, causal, b, hq, hkv, sq, sk, d):
    q, k, v = _qkv(card, dtype, b, hq, hkv, sq, sk, d)
    before = fa_kernel.launches.value
    got = flash_attention(q, k, v, causal=causal)
    assert fa_kernel.launches.value == before + 1
    torch.cuda.synchronize()
    assert got.dtype == dtype and got.shape == (b, hq, sq, d) and got.device == card
    want = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=FA_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 1, 127, 128, 511])
def test_flash_kernel_decode_reads_the_offset_on_the_card(card, dtype, pos):
    """One query against a 512-slot cache whose slots past ``pos`` hold
    garbage; the offset is an int32 tensor on the card, transposed
    (strided) K/V views as prefill passes them work too."""
    q, k, v = _qkv(card, dtype, 2, 9, 3, 1, 512, 64, seed=pos)
    k[:, :, pos + 1:] = 1e4
    v[:, :, pos + 1:] = -1e4
    off = torch.tensor(pos, dtype=torch.int32, device=card)
    got = flash_attention(q, k, v, causal=True, offset=off)
    want = attention_ref(q, k[:, :, : pos + 1], v[:, :, : pos + 1], causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=FA_ATOL[dtype], rtol=0)
    kt = k.transpose(1, 2).contiguous().transpose(1, 2)
    torch.testing.assert_close(flash_attention(q, kt, v, causal=True, offset=off), got,
                               atol=0, rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("group", [1, 3, 4, 8])
@pytest.mark.parametrize("pos", [0, 1, 127, 128, 511])
def test_flash_decode_packs_gqa_groups(card, dtype, group, pos):
    """Decode (Sq = 1) at GQA group sizes 1, 3, 4 and 8: the group's query
    heads share one block and the live keys are split over a cluster;
    slots past ``pos`` hold garbage that the mask must hide."""
    hkv = 2
    q, k, v = _qkv(card, dtype, 3, hkv * group, hkv, 1, 512, 64, seed=group * 1000 + pos)
    k[:, :, pos + 1:] = 1e4
    v[:, :, pos + 1:] = -1e4
    off = torch.tensor(pos, dtype=torch.int32, device=card)
    plan = fa_kernel.flash_plan(3, hkv * group, hkv, 1, 512, dtype)
    assert plan.kernel == "decode" and plan.splits == 8
    got = flash_attention(q, k, v, causal=True, offset=off)
    want = attention_ref(q, k[:, :, : pos + 1], v[:, :, : pos + 1], causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=FA_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d", [
    (2, 4, 4, 4, 300, 32),  # 4 rows of one head: decode with Sq > 1
    (1, 8, 2, 4, 64, 128),  # 16 rows: the decode kernel's widest tile
    (1, 16, 1, 2, 40, 16),  # MQA, 32 rows: past the decode tile
])
def test_flash_kernel_short_queries(card, dtype, b, hq, hkv, sq, sk, d):
    """Short query blocks on either side of the decode kernel's 16 rows."""
    q, k, v = _qkv(card, dtype, b, hq, hkv, sq, sk, d)
    for causal in (True, False):
        got = flash_attention(q, k, v, causal=causal)
        want = attention_ref(q, k, v, causal=causal)
        torch.testing.assert_close(got.float(), want.float(), atol=FA_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_kernel_unaligned_views(card, dtype):
    """Views that start off a 16-byte boundary take the kernel's
    element-wise loads and agree all the same."""
    q, k, v = _qkv(card, dtype, 2, 9, 3, 40, 70, 65)
    q, k, v = q[..., 1:], k[..., 1:], v[..., 1:]
    assert not fa_kernel._aligned16(q, k, v)
    got = flash_attention(q, k, v, causal=True)
    want = attention_ref(q, k, v, causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=FA_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("d", [80, 112])
@pytest.mark.parametrize("group", [1, 4])
@pytest.mark.parametrize("pos", [0, 1, 127, 511])
def test_flash_decode_at_head_dims_80_and_112(card, dtype, d, group, pos):
    """The decode kernel at head_dim 80 and 112 (rows of 10/14 bf16 or
    20/28 f32 vectors), against a cache whose slots past ``pos`` hold
    garbage."""
    q, k, v = _qkv(card, dtype, 4, 8 * group, 8, 1, 512, d, seed=d * 1000 + pos)
    k[:, :, pos + 1:] = 1e4
    v[:, :, pos + 1:] = -1e4
    assert fa_kernel.flash_plan(4, 8 * group, 8, 1, 512, dtype).kernel == "decode"
    got = flash_attention(q, k, v, causal=True, offset=torch.tensor(pos, dtype=torch.int32,
                                                                    device=card))
    want = attention_ref(q, k[:, :, : pos + 1], v[:, :, : pos + 1], causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=FA_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("pos", [0, 160, 511])
def test_flash_decode_at_granite_48_to_1(card, dtype, pos):
    """granite-20b's decode: 48 query heads on one KV head, Sq = 1, so 48
    packed rows, past the decode kernel's 16: the prefill kernels take it."""
    q, k, v = _qkv(card, dtype, 8, 48, 1, 1, 512, 128, seed=pos)
    k[:, :, pos + 1:] = 1e4
    v[:, :, pos + 1:] = -1e4
    plan = fa_kernel.flash_plan(8, 48, 1, 1, 512, dtype)
    assert plan.kernel == ("tensor_core" if dtype == torch.bfloat16 else "cuda_core")
    got = flash_attention(q, k, v, causal=True, offset=torch.tensor(pos, dtype=torch.int32,
                                                                    device=card))
    want = attention_ref(q, k[:, :, : pos + 1], v[:, :, : pos + 1], causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=FA_ATOL[dtype], rtol=0)


def test_flash_wrapper_rejects_what_it_does_not_take(card):
    q, k, v = _qkv(card, torch.float32, 1, 4, 2, 8, 8, 64)
    with pytest.raises(ValueError, match="head_dim"):
        fa_kernel.flash_attention_cuda(*_qkv(card, torch.float32, 1, 4, 2, 8, 8, 96))
    with pytest.raises(TypeError, match="bfloat16"):
        fa_kernel.flash_attention_cuda(q, k.bfloat16(), v)
    with pytest.raises(TypeError, match="bfloat16"):
        fa_kernel.flash_attention_cuda(q.half(), k.half(), v.half())
    with pytest.raises(ValueError, match="unit stride"):
        fa_kernel.flash_attention_cuda(q, k.transpose(2, 3), v)
    with pytest.raises(ValueError, match="Hq % Hkv"):
        fa_kernel.flash_attention_cuda(*_qkv(card, torch.float32, 1, 4, 3, 8, 8, 64))
    with pytest.raises(ValueError, match="int32"):
        fa_kernel.flash_attention_cuda(q, k, v, offset=torch.tensor(0, device=card))


@pytest.mark.parametrize("asset,counter", [("smollm_smoke", fa_kernel),
                                           ("falcon_mamba_smoke", ss_kernel)])
def test_lm_asset_reproduces_jax_golden(card, asset, counter):
    """A reduced LM from its committed JAX weights, served on the card:
    the JAX engine's greedy tokens exactly, prefill and first decode
    logits within 1e-4, one kernel launch (flash attention or selective
    scan) per layer per step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    asset = ASSETS / asset
    manifest = json.loads((asset / "manifest.json").read_text())
    cfg = configs.get_smoke(manifest["arch"], **manifest["smoke_kwargs"])
    with np.load(asset / "weights.npz") as w:
        params = params_from_numpy(cfg, unflatten(dict(w)))
    with np.load(asset / "golden.npz") as g:
        golden = dict(g)
    reqs = [Request(p, int(n)) for p, n in zip(golden["prompts"], golden["max_new_tokens"])]
    eng = Engine(cfg, params, manifest["batch_size"], manifest["max_seq"],
                 eos_id=manifest["eos_id"])
    assert eng.decode_graph.launches_by_kernel()[counter.launches.name] == cfg.n_layers
    before = counter.launches.value  # the capture's warm-up step is done
    eng.generate(reqs)
    assert counter.launches.value - before == cfg.n_layers * (1 + manifest["decode_steps"])
    for r, want in zip(reqs, golden["tokens"]):
        assert r.out_tokens == [int(t) for t in want if t >= 0]
    tokens = torch.from_numpy(np.stack([r.prompt for r in reqs])).to(card)
    logits, cache = prefill(cfg, params, {"tokens": tokens}, manifest["max_seq"])
    np.testing.assert_allclose(logits.cpu().numpy(), golden["prefill_logits"], atol=1e-4, rtol=0)
    logits, _ = decode_step(cfg, params, logits.argmax(-1)[:, None], cache)
    np.testing.assert_allclose(logits.cpu().numpy(), golden["decode_logits"], atol=1e-4, rtol=0)


def _eager_tokens(cfg, params, prompts, max_seq, n_new):
    """Greedy tokens of an eager loop over prefill and decode_step;
    ``prompts`` is the tokens, or a whole batch with extra inputs."""
    batch = prompts if isinstance(prompts, dict) else {"tokens": prompts}
    with torch.inference_mode():
        logits, cache = prefill(cfg, params, batch, max_seq)
        tok = logits.argmax(-1)
        out = [tok]
        for _ in range(n_new - 1):
            logits, cache = decode_step(cfg, params, tok[:, None], cache)
            tok = logits.argmax(-1)
            out.append(tok)
    return torch.stack(out, dim=1).tolist()


@pytest.mark.parametrize("name,dtype", [("smollm-135m", "bfloat16"), ("smollm-135m", "float32"),
                                        ("falcon-mamba-7b", "bfloat16"),
                                        ("stablelm-3b", "bfloat16"),
                                        ("qwen3-moe-30b-a3b", "bfloat16")])
def test_graph_replayed_tokens_equal_an_eager_loop(card, name, dtype):
    """The engine's decode graph against an eager loop over the same
    prefill/decode_step on the card: the same greedy tokens exactly, over
    two batches through one engine (the static cache is reset by each
    prefill), with the kernel's launches counted per replay."""
    kw = {"n_heads": 9, "n_kv_heads": 3} if name == "smollm-135m" else {}
    if name == "stablelm-3b":
        kw = {"head_dim": 80}
    cfg = dataclasses.replace(configs.get_smoke(name, n_layers=3, **kw), dtype=dtype)
    params = init_params(cfg, PRNGKey(0), device=card)
    counter = ss_kernel if cfg.family == "ssm" else fa_kernel
    eng = Engine(cfg, params, 4, 48, eos_id=-1)
    assert eng.decode_graph.launches_by_kernel()[counter.launches.name] == cfg.n_layers
    rng = np.random.default_rng(0)
    for prompt_len in (11, 20):
        prompts = rng.integers(2, cfg.vocab_size, size=(4, prompt_len)).astype(np.int32)
        reqs = [Request(p, 9) for p in prompts]
        before = counter.launches.value
        eng.generate(reqs)
        assert counter.launches.value - before == cfg.n_layers * 9
        want = _eager_tokens(cfg, eng.params, torch.from_numpy(prompts.astype(np.int64)).to(card),
                             48, 9)
        assert [r.out_tokens for r in reqs] == want


def _stub_inputs(cfg, b, card, seed=0):
    """A family's stub front-end outputs for a batch of ``b``, on the card."""
    g = torch.Generator(card).manual_seed(seed)
    dtype = {"float32": torch.float32, "bfloat16": torch.bfloat16}[cfg.dtype]
    rows = {"encdec": ("enc_frames", cfg.encoder_seq), "vlm": ("img_embeds", cfg.vision_tokens)}
    if cfg.family not in rows:
        return {}
    name, n = rows[cfg.family]
    return {name: torch.randn(b, n, cfg.d_model, generator=g, device=card).to(dtype)}


def _calls_per_step(cfg):
    """Flash and scan launches of one prefill and of one decode step."""
    pattern, n_periods = cfg.layer_pattern()
    attn = sum(m == "attn" for m, _ in pattern) * n_periods
    scan = sum(m == "ssm" for m, _ in pattern) * n_periods
    cross = len(pattern) * n_periods if cfg.family == "encdec" else 0
    enc = cfg.encoder_layers if cfg.family == "encdec" else 0
    return {fa_kernel: (attn + cross + enc, attn + cross), ss_kernel: (scan, scan)}


@pytest.mark.parametrize("asset", ["jamba_smoke", "whisper_smoke", "internvl2_smoke"])
def test_family_asset_reproduces_jax_golden(card, asset):
    """A reduced hybrid, encoder-decoder or VLM from its committed JAX
    weights and stub inputs, served on the card through
    ``Engine(extra_inputs=...)``: the JAX engine's greedy tokens exactly,
    prefill and first decode logits within 1e-4, each kernel launched
    once per attention (or cross-attention, or Mamba) layer per step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    asset = ASSETS / asset
    manifest = json.loads((asset / "manifest.json").read_text())
    cfg = configs.get_smoke(manifest["arch"], **manifest["smoke_kwargs"])
    with np.load(asset / "weights.npz") as w:
        params = params_from_numpy(cfg, unflatten(dict(w)))
    with np.load(asset / "golden.npz") as g:
        golden = dict(g)
    extra = {k: torch.from_numpy(golden[k]) for k in manifest["extra_inputs"]}
    reqs = [Request(p, int(n)) for p, n in zip(golden["prompts"], golden["max_new_tokens"])]
    eng = Engine(cfg, params, manifest["batch_size"], manifest["max_seq"],
                 eos_id=manifest["eos_id"], extra_inputs=extra)
    per_step = _calls_per_step(cfg)
    want = {c.launches.name: dec for c, (_, dec) in per_step.items() if dec}
    got = eng.decode_graph.launches_by_kernel()
    assert {k: got.get(k, 0) for k in (fa_kernel.launches.name, ss_kernel.launches.name)
            if got.get(k)} == want
    before = {c: c.launches.value for c in per_step}
    eng.generate(reqs)
    for c, (pre, dec) in per_step.items():
        assert c.launches.value - before[c] == pre + dec * manifest["decode_steps"]
    for r, want in zip(reqs, golden["tokens"]):
        assert r.out_tokens == [int(t) for t in want if t >= 0]
    batch = {"tokens": torch.from_numpy(np.stack([r.prompt for r in reqs])).to(card),
             **{k: v.to(card) for k, v in extra.items()}}
    logits, cache = prefill(cfg, params, batch, manifest["max_seq"])
    np.testing.assert_allclose(logits.cpu().numpy(), golden["prefill_logits"], atol=1e-4, rtol=0)
    logits, _ = decode_step(cfg, params, logits.argmax(-1)[:, None], cache)
    np.testing.assert_allclose(logits.cpu().numpy(), golden["decode_logits"], atol=1e-4, rtol=0)


@pytest.mark.parametrize("name", ["jamba-v0.1-52b", "whisper-base", "internvl2-26b"])
def test_family_graph_tokens_equal_an_eager_loop(card, name):
    """The hybrid, encoder-decoder and VLM families in bf16 through the
    engine's decode graph, in two engines with other stub inputs (given
    per engine), each serving two batches: the greedy tokens of an eager
    loop exactly, and the static cache's tensors, cross K/V included, the
    same before and after (prefill writes into them; the graph reads them)."""
    cfg = dataclasses.replace(configs.get_smoke(name), dtype="bfloat16")
    params = init_params(cfg, PRNGKey(0), device=card)
    rng = np.random.default_rng(0)
    for seed in (0, 1):
        extra = _stub_inputs(cfg, 4, card, seed)
        eng = Engine(cfg, params, 4, 48, eos_id=-1, extra_inputs=extra)
        ptrs = [t.data_ptr() for t in _leaves(eng.static_cache)]
        for prompt_len in (11, 20):
            prompts = rng.integers(2, cfg.vocab_size, size=(4, prompt_len)).astype(np.int32)
            reqs = [Request(p, 9) for p in prompts]
            eng.generate(reqs)
            batch = {"tokens": torch.from_numpy(prompts.astype(np.int64)).to(card), **extra}
            assert [r.out_tokens for r in reqs] == _eager_tokens(cfg, eng.params, batch, 48, 9)
        assert [t.data_ptr() for t in _leaves(eng.static_cache)] == ptrs


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    if isinstance(tree, list):
        return [t for v in tree for t in _leaves(v)]
    return [tree]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    (8, 8, 8, 1500, 1500, 64, False),  # whisper-base's encoder: Sk not a multiple of a key tile
    (8, 8, 8, 128, 1500, 64, False),  # whisper's cross-attention at prefill
    (8, 8, 8, 1, 1500, 64, False),  # whisper's cross-attention at decode: 2 splits of 750 keys
    (8, 48, 8, 384, 384, 128, True),  # internvl2-26b's prefill: 256 vision + 128 text rows
    (8, 32, 8, 128, 128, 128, True),  # jamba's prefill, group 4
])
def test_flash_at_the_families_regimes(card, dtype, b, hq, hkv, sq, sk, d, causal):
    """Flash against its plain version at the full-width shapes of the
    encoder-decoder, VLM and hybrid paths."""
    q, k, v = _qkv(card, dtype, b, hq, hkv, sq, sk, d, seed=sq + sk)
    plan = fa_kernel.flash_plan(b, hq, hkv, sq, sk, dtype)
    if sq == 1:
        assert plan == fa_kernel.FlashPlan("decode", 2)
    got = flash_attention(q, k, v, causal=causal)
    want = attention_ref(q, k, v, causal=causal)
    torch.testing.assert_close(got.float(), want.float(), atol=FA_ATOL[dtype], rtol=0)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("hq", [48, 32])  # internvl2-26b's group 6, jamba's group 4
@pytest.mark.parametrize("pos", [0, 160, 416, 511])
def test_flash_decode_at_groups_6_and_4_head_dim_128(card, dtype, hq, pos):
    """Decode at head_dim 128 with 8 KV heads and GQA group 6 or 4 (the
    decode kernel's 16-row tile, partly filled), against a cache whose
    slots past ``pos`` hold garbage."""
    q, k, v = _qkv(card, dtype, 8, hq, 8, 1, 512, 128, seed=hq * 1000 + pos)
    k[:, :, pos + 1:] = 1e4
    v[:, :, pos + 1:] = -1e4
    assert fa_kernel.flash_plan(8, hq, 8, 1, 512, dtype).kernel == "decode"
    got = flash_attention(q, k, v, causal=True, offset=torch.tensor(pos, dtype=torch.int32,
                                                                    device=card))
    want = attention_ref(q, k[:, :, : pos + 1], v[:, :, : pos + 1], causal=True)
    torch.testing.assert_close(got.float(), want.float(), atol=FA_ATOL[dtype], rtol=0)


# ----------------------------------------------------------------------
# the selective-scan kernel (atol 1e-5: the JAX kernel tests' own)
# ----------------------------------------------------------------------
def _scan_inputs(card, b, s, d, n, seed=0):
    g = torch.Generator(card).manual_seed(seed)

    def normal(*shape):
        return torch.randn(shape, generator=g, device=card)

    return (torch.nn.functional.softplus(normal(b, s, d) - 1.0), normal(b, s, n) * 0.5,
            normal(b, s, n) * 0.5, normal(b, s, d), -torch.exp(normal(d, n) * 0.3),
            normal(b, d, n) * 0.1)


@pytest.mark.parametrize("b,s,d,n", [
    (2, 16, 32, 8), (1, 32, 64, 16), (3, 8, 16, 4),  # tests/test_ssm_kernel.py's shapes
    (2, 100, 300, 16),  # ragged channels, several 32-step chunks
    (8, 1, 8192, 16),  # falcon-mamba-7b's decode
    (4, 70, 129, 8), (1, 5, 7, 1),
])
def test_scan_kernel_matches_plain_version(card, b, s, d, n):
    args = _scan_inputs(card, b, s, d, n, seed=s + d)
    before = ss_kernel.launches.value
    y, h = selective_scan(*args)
    assert ss_kernel.launches.value == before + 1
    torch.cuda.synchronize()
    y_ref, h_ref = selective_scan_ref(*args)
    torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(h, h_ref, atol=1e-5, rtol=1e-5)


def test_scan_kernel_chains_state_in_place_and_reads_strided_b_c(card):
    """Two halves with the state carried equal one scan; the state written
    into h0 itself (the decode cache's use); B and C as views of one
    projection."""
    dt, bm, cm, x, a, h0 = _scan_inputs(card, 2, 24, 160, 16, seed=5)
    y_full, h_full = selective_scan(dt, bm, cm, x, a, h0)
    state = h0.clone()
    y1, _ = selective_scan(dt[:, :12].contiguous(), bm[:, :12], cm[:, :12],
                           x[:, :12].contiguous(), a, state, h_out=state)
    y2, h2 = selective_scan(dt[:, 12:].contiguous(), bm[:, 12:], cm[:, 12:],
                            x[:, 12:].contiguous(), a, state, h_out=state)
    assert h2 is state
    torch.testing.assert_close(torch.cat([y1, y2], dim=1), y_full, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(state, h_full, atol=1e-5, rtol=1e-5)
    proj = torch.cat([torch.zeros_like(bm[..., :3]), bm, cm], dim=-1)
    y_v, h_v = selective_scan(dt, proj[..., 3:19], proj[..., 19:], x, a, h0)
    assert torch.equal(y_v, y_full) and torch.equal(h_v, h_full)


@pytest.mark.parametrize("b", [1, 8])
@pytest.mark.parametrize("n", range(1, 17))
def test_scan_decode_kernel_every_state_size(card, b, n):
    """S = 1 takes the decode kernel at every N (1, 2 or 4 lanes of 4
    states; a slice past N masked), ragged channels, the state written into
    h0 itself and B and C as strided views of one projection."""
    dt, bm, cm, x, a, h0 = _scan_inputs(card, b, 1, 129, n, seed=n)
    y_ref, h_ref = selective_scan_ref(dt, bm, cm, x, a, h0)
    proj = torch.cat([torch.zeros(b, 1, 3, device=card), bm, cm], dim=-1)
    state = h0.clone()
    before = ss_kernel.kernel_launches["decode"].value
    y, h = selective_scan(dt, proj[..., 3:3 + n], proj[..., 3 + n:], x, a, state, h_out=state)
    assert h is state and ss_kernel.kernel_launches["decode"].value == before + 1
    torch.cuda.synchronize()
    torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(state, h_ref, atol=1e-5, rtol=1e-5)


@pytest.mark.parametrize("s", [2, 33, 128])
@pytest.mark.parametrize("n", [5, 13, 16])
def test_scan_prefill_kernel_lengths(card, s, n):
    dt, bm, cm, x, a, h0 = _scan_inputs(card, 3, s, 129, n, seed=s + n)
    before = ss_kernel.kernel_launches["prefill"].value
    state = h0.clone()
    y, _ = selective_scan(dt, bm, cm, x, a, state, h_out=state)
    assert ss_kernel.kernel_launches["prefill"].value == before + 1
    torch.cuda.synchronize()
    y_ref, h_ref = selective_scan_ref(dt, bm, cm, x, a, h0)
    torch.testing.assert_close(y, y_ref, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(state, h_ref, atol=1e-5, rtol=1e-5)


def test_scan_decode_steps_in_place_equal_one_prefill(card):
    """The decode cache's use with several lanes per channel: six decode
    calls on one state, in place, equal one prefill scan of the six steps."""
    dt, bm, cm, x, a, h0 = _scan_inputs(card, 8, 6, 300, 16, seed=9)
    y_full, h_full = selective_scan(dt, bm, cm, x, a, h0)
    state = h0.clone()
    ys = [selective_scan(dt[:, t:t + 1].contiguous(), bm[:, t:t + 1], cm[:, t:t + 1],
                         x[:, t:t + 1].contiguous(), a, state, h_out=state)[0] for t in range(6)]
    torch.testing.assert_close(torch.cat(ys, dim=1), y_full, atol=1e-5, rtol=1e-5)
    torch.testing.assert_close(state, h_full, atol=1e-5, rtol=1e-5)


def test_scan_wrapper_rejects_what_it_does_not_take(card):
    dt, bm, cm, x, a, h0 = _scan_inputs(card, 2, 4, 32, 8)
    with pytest.raises(TypeError, match="float32"):
        ss_kernel.selective_scan_cuda(dt.double(), bm, cm, x, a, h0)
    with pytest.raises(ValueError, match="one device"):
        ss_kernel.selective_scan_cuda(dt, bm, cm, x, a.cpu(), h0)
    with pytest.raises(ValueError, match="contiguous x"):
        ss_kernel.selective_scan_cuda(dt, bm, cm, x.transpose(0, 1).contiguous().transpose(0, 1),
                                      a, h0)
    with pytest.raises(ValueError, match="unit stride"):
        ss_kernel.selective_scan_cuda(dt, bm.transpose(1, 2).contiguous().transpose(1, 2), cm,
                                      x, a, h0)
    with pytest.raises(ValueError, match="state sizes"):
        ss_kernel.selective_scan_cuda(*_scan_inputs(card, 1, 2, 8, 17))
    with pytest.raises(ValueError, match="h_out"):
        ss_kernel.selective_scan_cuda(dt, bm, cm, x, a, h0, h_out=h0[:1])


# ----------------------------------------------------------------------
# the W8A8 matmul kernel (exact: int32 sums, the oracle's epilogue order)
# ----------------------------------------------------------------------
def _qmm_inputs(card, m, k, n, seed=0):
    g = torch.Generator(card).manual_seed(seed)
    x = torch.randint(-128, 128, (m, k), generator=g, device=card, dtype=torch.int8)
    w = torch.randint(-128, 128, (k, n), generator=g, device=card, dtype=torch.int8)
    xs = torch.rand(m, generator=g, device=card) * 1.5 + 0.5
    ws = torch.rand(n, generator=g, device=card) * 0.09 + 0.01
    return x, w, xs, ws


@pytest.mark.parametrize("m,k,n", [
    (128, 256, 128), (256, 512, 256), (64, 128, 32),  # tests/test_quant_matmul.py's sweep
    (100, 200, 60), (33, 1000, 77), (1, 5, 3),  # ragged M, N and K
    (300, 4096, 520),
])
def test_qmm_kernel_matches_plain_version_exactly(card, m, k, n):
    args = _qmm_inputs(card, m, k, n, seed=m + n)
    before = qm_kernel.launches.value
    got = quant_matmul(*args)
    assert qm_kernel.launches.value == before + 1
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == (m, n)
    assert torch.equal(got, quant_matmul_ref(*args))


@pytest.mark.parametrize("m,k,n", [
    (1000, 512, 16400), (129, 48, 272), (1, 16, 16), (300, 4096, 512),  # TMA: aligned rows
    (100, 200, 60), (33, 1000, 77), (64, 256, 520),  # mma.sync: rows TMA cannot describe
])
def test_qmm_each_kernel_bit_exact(card, m, k, n):
    args = _qmm_inputs(card, m, k, n, seed=m * n)
    entry = qm_kernel.qmm_entry(n, k, args[0].data_ptr(), args[1].data_ptr(), 0)
    assert entry == ("tma" if k % 16 == 0 and n % 16 == 0 else "mma_sync")
    before = qm_kernel.kernel_launches[entry].value
    got = quant_matmul(*args)
    assert qm_kernel.kernel_launches[entry].value == before + 1
    torch.cuda.synchronize()
    assert torch.equal(got, quant_matmul_ref(*args))


def test_qmm_unaligned_base_takes_the_mma_sync_kernel(card):
    x, w, xs, ws = _qmm_inputs(card, 64, 256, 128, seed=5)
    off = torch.empty(x.numel() + 8, dtype=torch.int8, device=card)[8:].view(64, 256)
    off.copy_(x)
    assert off.data_ptr() % 16 == 8
    before = qm_kernel.kernel_launches["mma_sync"].value
    got = quant_matmul(off, w, xs, ws)
    assert qm_kernel.kernel_launches["mma_sync"].value == before + 1
    assert torch.equal(got, quant_matmul_ref(x, w, xs, ws))
    assert torch.equal(quant_matmul(x, w, xs, ws), got)  # the TMA kernel agrees


def test_qmm_kernel_sums_past_2_24_exactly(card):
    x, w, xs, ws = _qmm_inputs(card, 64, 4096, 48, seed=11)
    x[:8], w[:, :8] = 127, 127
    w[0, :8] = 126  # odd sums near 2^26: not representable in f32
    exact = x.cpu().long() @ w.cpu().long()
    assert int(exact.abs().max()) >= 2**25
    ones_m, ones_n = torch.ones(64, device=card), torch.ones(48, device=card)
    assert torch.equal(quant_matmul(x, w, ones_m, ones_n).cpu(), exact.float())
    assert torch.equal(quant_matmul(x, w, xs, ws), quant_matmul_ref(x, w, xs, ws))


def test_qmm_wrapper_rejects_what_it_does_not_take(card):
    x, w, xs, ws = _qmm_inputs(card, 16, 32, 8)
    with pytest.raises(TypeError, match="int8"):
        qm_kernel.quant_matmul_cuda(x.int(), w, xs, ws)
    with pytest.raises(TypeError, match="float32"):
        qm_kernel.quant_matmul_cuda(x, w, xs.double(), ws)
    with pytest.raises(ValueError, match="contiguous"):
        qm_kernel.quant_matmul_cuda(x, w.t().contiguous().t(), xs, ws)
    with pytest.raises(ValueError, match="one device"):
        qm_kernel.quant_matmul_cuda(x, w.cpu(), xs, ws)
    with pytest.raises(ValueError, match=r"\[M, K\]"):
        qm_kernel.quant_matmul_cuda(x, w[:16], xs, ws)
    big = torch.zeros(1, qm_kernel.MAX_K + 1, dtype=torch.int8, device=card)
    with pytest.raises(ValueError, match="overflow"):
        qm_kernel.quant_matmul_cuda(big, big.t().contiguous(), xs[:1], xs[:1])


# ----------------------------------------------------------------------
# the flow facade, the co-sim gate and the MoE block on the card
# ----------------------------------------------------------------------
def test_deployment_rollout_on_the_card(card):
    """Two jet_tagger designs compiled on the card from two seeds: v2 is
    registered (and captured) while v1's burst is in flight; every v1
    future resolves to v1's ``forward_int``, v2 serves its own, and the
    drained v1 gives its graphs back."""
    model, in_shape, in_quant = nn_models.jet_tagger()
    designs = []
    for seed in (0, 1):
        params, _ = nn_init_params(PRNGKey(seed), model, in_shape, card)
        designs.append(Flow.compile(model, params, in_shape, in_quant,
                                    config=CompileConfig(jobs=2), device=card))
    q = in_quant.qint
    x = np.random.default_rng(0).integers(q.lo, q.hi + 1, size=(2048, *in_shape)).astype(np.int32)
    want = [d.forward_int(torch.from_numpy(x).to(card)).cpu().numpy() for d in designs]
    assert not np.array_equal(*want)
    with Flow.serve(ServeConfig(max_batch=64, shards=2)) as dep:
        assert dep.register("jet", designs[0]) == 1
        v1 = dep.engine._runner("jet@v1")
        futs = dep.submit_batch("jet", x)
        assert dep.register("jet", designs[1], warmup=True) == 2
        np.testing.assert_array_equal(np.stack([f.result(60) for f in futs]), want[0])
        got = np.stack([f.result(60) for f in dep.submit_batch("jet", x)])
        np.testing.assert_array_equal(got, want[1])
        s = dep.stats("jet")
        assert s["version"] == 2 and s["jit_compiles"] == {b: 2 for b in s["buckets"]}
        assert all(not sh._graphs and not sh.is_alive() for sh in v1.shards)


def test_cosim_device_leg_on_the_card(card):
    before = ag_kernel.launches.value
    rep = cosim_grid(jit="require", device=card)
    launched = ag_kernel.launches.value - before
    assert rep["n_cases"] == rep["n_bit_exact"] == 34 and rep["all_bit_exact"]
    assert rep["jit"] == {"checked": 34, "skipped": 0, "ok": True}
    assert launched == 34  # one table per program, one launch per table
    assert rep["cases"] == cosim_grid(jit="require", device="cpu")["cases"]


def _moe_inputs(cfg, seed):
    rng = np.random.default_rng(seed)
    d, e, f = cfg.d_model, cfg.n_experts, cfg.d_ff
    router = rng.standard_normal((d, e)).astype(np.float32) / 8
    router[:, 1::2] = router[:, 0::2]  # twin experts: exact router ties
    p = {"router": router,
         "w_gate": rng.standard_normal((e, d, f)).astype(np.float32) / 8,
         "w_up": rng.standard_normal((e, d, f)).astype(np.float32) / 8,
         "w_down": rng.standard_normal((e, f, d)).astype(np.float32) / 11}
    x = rng.standard_normal((4, 32, d)).astype(np.float32)
    return {k: torch.from_numpy(v) for k, v in p.items()}, torch.from_numpy(x)


@pytest.mark.parametrize("cf", [0.5, 4.0])
def test_moe_block_on_the_card_equals_its_cpu_run(card, cf):
    cfg = configs.get_smoke("qwen3-moe-30b-a3b", capacity_factor=cf)
    p, x = _moe_inputs(cfg, seed=int(cf * 2))
    want, want_aux = moe.moe_block(cfg, p, x)
    got, aux = moe.moe_block(cfg, {k: v.to(card) for k, v in p.items()}, x.to(card))
    np.testing.assert_allclose(got.cpu().numpy(), want.numpy(), atol=1e-5, rtol=0)
    np.testing.assert_allclose(float(aux), float(want_aux), atol=1e-6, rtol=0)


def test_moe_block_replays_as_a_graph_without_a_sync(card):
    cfg = configs.get_smoke("qwen3-moe-30b-a3b", d_model=256, d_ff=128, n_experts=128,
                            experts_per_token=8, capacity_factor=1.25)
    p, x = _moe_inputs(cfg, seed=7)
    p = {k: v.to(card, torch.bfloat16) for k, v in p.items()}
    x = x.to(card, torch.bfloat16)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # any implicit sync in the block raises
    try:
        eager, _ = moe.moe_block(cfg, p, x)
    finally:
        torch.cuda.set_sync_debug_mode("default")
    graph = capture(lambda: moe.moe_block(cfg, p, x)[0])  # a sync would break the capture
    graph.replay()
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(graph.output, eager)


# ----------------------------------------------------------------------
# training: the two backward kernels and autograd through the model
# ----------------------------------------------------------------------
# f32: the kernels' sums run in another order than the plain backward's:
# within 2e-5 of the largest gradient element.  bf16: the flash backward
# rounds P and dS to bf16 as the operands of its second products (as
# FA2); the plain bf16 backward computes in f32 and rounds at the end.
# Both are held to the f32 gradient of the same bf16 inputs: within 2^-6
# of its largest element (either lands about 2^-8 off).
BWD_REL = {torch.float32: 2e-5, torch.bfloat16: 2**-6}


# The forward's stored log-sum-exp (base 2, f32) against the plain one:
# the kernels sum the exponentials in another order and by exp2.approx,
# within 1e-4 + 1e-5 |lse|; +inf (a row that sees no key) exactly.
LSE_ATOL, LSE_RTOL = 1e-4, 1e-5


def _rel_err(got, want):
    return float((got.float() - want.float()).abs().max()) / max(float(want.abs().max()), 1e-6)


def _flash_fwd(q, k, v, causal=True):
    """The forward as the training path launches it: (out, lse)."""
    lse = torch.empty(q.shape[:3], dtype=torch.float32, device=q.device)
    return fa_kernel.flash_attention_cuda(q, k, v, causal=causal, lse=lse), lse


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,sq,sk,d,causal", [
    (2, 9, 3, 128, 128, 64, True),   # smollm-135m's training shape, cut to batch 2
    (2, 4, 4, 33, 33, 16, True),
    (1, 8, 2, 40, 40, 80, True),
    (2, 4, 1, 17, 40, 32, True),     # Sq < Sk, end-aligned
    (2, 6, 2, 70, 70, 112, False),
    (1, 4, 2, 100, 130, 128, False),
    (1, 3, 3, 1, 33, 64, True),      # one query row: the decode kernel writes the lse
    (2, 32, 4, 100, 100, 128, True),  # qwen3-moe's 32:4, group 8, head_dim 128
    (1, 48, 8, 72, 72, 128, True),   # internvl2's 48:8, group 6
    (2, 8, 8, 40, 1500, 64, False),  # whisper's cross-attention over 1,500 frames
])
def test_flash_backward_kernel_matches_plain_version(card, dtype, b, hq, hkv, sq, sk, d, causal):
    gen = torch.Generator(card).manual_seed(sq * 7 + d)
    q, k, v, do = (torch.randn(s, generator=gen, device=card).to(dtype)
                   for s in ((b, hq, sq, d), (b, hkv, sk, d), (b, hkv, sk, d), (b, hq, sq, d)))
    o, lse = _flash_fwd(q, k, v, causal=causal)
    assert torch.equal(o, fa_kernel.flash_attention_cuda(q, k, v, causal=causal))
    want_lse = fa_ref.attention_lse_ref(q, k, causal=causal)
    assert torch.equal(torch.isinf(lse), torch.isinf(want_lse))
    fin = torch.isfinite(want_lse)
    assert bool(((lse - want_lse)[fin].abs() <= LSE_ATOL + LSE_RTOL * want_lse[fin].abs()).all())
    before = fa_kernel.bwd_launches.value
    got = fa_kernel.flash_attention_bwd_cuda(q, k, v, o, do, lse, causal=causal)
    assert fa_kernel.bwd_launches.value == before + 1
    want = fa_ref.attention_bwd_ref(q.float(), k.float(), v.float(), do.float(), causal=causal)
    for g, w, x in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == x.shape
        assert _rel_err(g, w) <= BWD_REL[dtype]
    if dtype == torch.float32:
        for g, p in zip(got, fa_ref.attention_bwd_ref(q, k, v, do, causal=causal)):
            assert _rel_err(g, p) <= BWD_REL[dtype]


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_flash_backward_is_deterministic(card, dtype):
    gen = torch.Generator(card).manual_seed(11)
    q = torch.randn((4, 9, 128, 64), generator=gen, device=card).to(dtype)
    k, v = (torch.randn((4, 3, 128, 64), generator=gen, device=card).to(dtype) for _ in range(2))
    do = torch.randn_like(q)
    o, lse = _flash_fwd(q, k, v)
    first = fa_kernel.flash_attention_bwd_cuda(q, k, v, o, do, lse)
    second = fa_kernel.flash_attention_bwd_cuda(q, k, v, o, do, lse)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


@pytest.mark.parametrize("s", [128, 100])
def test_flash_backward_reads_the_models_views(card, s):
    """The model's q, k, v and dO are [B, S, H, D] viewed as [B, H, S, D]:
    the bf16 backward reads them in place (S a multiple of 64) or copies
    them (S = 100), with the bits of contiguous copies."""
    gen = torch.Generator(card).manual_seed(s)
    q, do = (torch.randn((2, s, 9, 64), generator=gen, device=card).bfloat16().transpose(1, 2)
             for _ in range(2))
    k, v = (torch.randn((2, s, 3, 64), generator=gen, device=card).bfloat16().transpose(1, 2)
            for _ in range(2))
    assert fa_kernel.tma_layout(q) == (1 if s % 64 == 0 else None)
    o, lse = _flash_fwd(q, k, v)
    got = fa_kernel.flash_attention_bwd_cuda(q, k, v, o, do, lse)
    dense = fa_kernel.flash_attention_bwd_cuda(q.contiguous(), k.contiguous(), v.contiguous(), o,
                                               do.contiguous(), lse)
    assert all(torch.equal(a, b) for a, b in zip(got, dense))
    want = fa_ref.attention_bwd_ref(q.float(), k.float(), v.float(), do.float())
    assert max(_rel_err(g, w) for g, w in zip(got, want)) <= BWD_REL[torch.bfloat16]


def _scan_args(card, b, s, d, n, seed):
    gen = torch.Generator(card).manual_seed(seed)
    r = lambda *shape: torch.randn(shape, generator=gen, device=card)  # noqa: E731
    return (torch.nn.functional.softplus(r(b, s, d) - 1), r(b, s, n), r(b, s, n), r(b, s, d),
            -torch.exp(0.5 * r(d, n)), r(b, d, n))


def _chunk_states(args):
    """The chunk-start states the training path's forward writes."""
    b, s, d = args[0].shape
    hc = torch.empty(ss_kernel.chunk_states_shape(b, s, d, args[4].shape[1]), device=args[0].device)
    y, h = ss_kernel.selective_scan_cuda(*args, chunk_states=hc)
    y0, h0 = ss_kernel.selective_scan_cuda(*args)
    assert torch.equal(y, y0) and torch.equal(h, h0)  # the same forward as serving's
    return hc


@pytest.mark.parametrize("with_dh", [False, True])
@pytest.mark.parametrize("b,s,d,n", [(2, 33, 129, 16), (1, 1, 64, 4), (2, 128, 256, 16),
                                     (3, 17, 100, 5), (1, 8, 33, 1)])
def test_scan_backward_kernel_matches_plain_version(card, b, s, d, n, with_dh):
    args = _scan_args(card, b, s, d, n, seed=s + n)
    gen = torch.Generator(card).manual_seed(5)
    dy = torch.randn((b, s, d), generator=gen, device=card)
    dh = torch.randn((b, d, n), generator=gen, device=card) if with_dh else None
    hc = _chunk_states(args)
    assert _rel_err(hc, selective_scan_chunk_states_ref(*args)) <= 2e-5
    before = ss_kernel.bwd_launches.value
    got = ss_kernel.selective_scan_bwd_cuda(*args, dy, dh, hc)
    assert ss_kernel.bwd_launches.value == before + 1
    want = selective_scan_bwd_ref(*args, dy, dh)
    for g, w in zip(got, want):
        assert g.shape == w.shape and _rel_err(g, w) <= 2e-5


def test_scan_backward_is_deterministic(card):
    args = _scan_args(card, 8, 128, 1024, 16, seed=3)
    dy = torch.randn_like(args[0])
    hc = _chunk_states(args)
    first = ss_kernel.selective_scan_bwd_cuda(*args, dy, None, hc)
    second = ss_kernel.selective_scan_bwd_cuda(*args, dy, None, hc)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_forward_without_grad_launches_as_before(card):
    """Under no_grad, or with no input that requires grad, the ops launch
    the forward kernels exactly as serving does (no autograd node), also
    inside a CUDA-graph capture; with grad they launch the same forward
    (the same bits) and the backward kernels in the backward."""
    gen = torch.Generator(card).manual_seed(2)
    q = torch.randn((2, 9, 64, 64), generator=gen, device=card).to(torch.bfloat16)
    k, v = (torch.randn((2, 3, 64, 64), generator=gen, device=card).to(torch.bfloat16)
            for _ in range(2))
    served = fa_kernel.flash_attention_cuda(q, k, v)
    counts = (fa_kernel.launches.value, fa_kernel.bwd_launches.value)
    plain = flash_attention(q, k, v)
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        no_grad = flash_attention(qg, k, v)
    assert plain.grad_fn is None and no_grad.grad_fn is None
    assert torch.equal(plain, served) and torch.equal(no_grad, served)
    graph = capture(lambda: flash_attention(q, k, v))
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(graph.output, served)
    assert graph.launches_by_kernel() == {"flash_attention": 1}
    with_grad = flash_attention(qg, k, v)
    assert with_grad.grad_fn is not None and torch.equal(with_grad.detach(), served)
    with_grad.float().sum().backward()
    # two eager calls, the capture's warm-up and replay, the call with grad
    assert fa_kernel.launches.value == counts[0] + 5
    assert fa_kernel.bwd_launches.value == counts[1] + 1 and qg.grad is not None
    # the scan: the same
    args = _scan_args(card, 2, 16, 64, 16, seed=4)
    y0, _ = ss_kernel.selective_scan_cuda(*args)
    xg = args[3].clone().requires_grad_(True)
    with torch.no_grad():
        y1, _ = selective_scan(*args[:3], xg, *args[4:])
    y2, _ = selective_scan(*args[:3], xg, *args[4:])
    assert y1.grad_fn is None and y2.grad_fn is not None
    assert torch.equal(y1, y0) and torch.equal(y2.detach(), y0)
    n = ss_kernel.bwd_launches.value
    y2.sum().backward()
    assert ss_kernel.bwd_launches.value == n + 1 and xg.grad is not None


@pytest.mark.parametrize("arch", ["smollm-135m", "falcon-mamba-7b", "qwen3-moe-30b-a3b",
                                  "jamba-v0.1-52b", "whisper-base", "internvl2-26b"])
def test_backward_through_the_model_reaches_attention_and_the_scan(card, arch):
    """``loss.backward()`` through the port's model on the card: every
    attention and Mamba call runs its backward kernel (with remat the
    forward kernel twice), the projections before them get non-zero
    gradients, and the gradients agree with the plain path's (f32)."""
    from repro_torch.kernels.flash_attention.ref import attention_ref
    from repro_torch.models import attention as attention_mod
    from repro_torch.models import loss_fn
    from repro_torch.models import ssm as ssm_mod
    from repro_torch.tree import tree_leaves

    cfg = configs.get_smoke(arch)
    params = init_params(cfg, PRNGKey(0), device=card)
    rng = np.random.default_rng(0)
    batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32)).astype(np.int64))
             .to(card) for k in ("tokens", "labels")}
    if cfg.family == "encdec":
        batch["enc_frames"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.encoder_seq, cfg.d_model), dtype=np.float32)).to(card)
    if cfg.family == "vlm":
        batch["img_embeds"] = torch.from_numpy(rng.standard_normal(
            (2, cfg.vision_tokens, cfg.d_model), dtype=np.float32)).to(card)
    leaves = tree_leaves(params)

    def grads():
        for p in leaves:
            p.grad = None
            p.requires_grad_(True)
        loss, _ = loss_fn(cfg, params, batch)
        loss.backward()
        out = [p.grad.clone() for p in leaves]
        for p in leaves:
            p.requires_grad_(False)
        return out

    counters = (fa_kernel.launches, fa_kernel.bwd_launches, ss_kernel.launches,
                ss_kernel.bwd_launches)
    before = {c: c.value for c in counters}
    with torch.no_grad():  # the forward's calls of each op, launched as serving launches them
        loss_fn(cfg, params, batch)
    calls = {c.name: c.value - before[c] for c in counters}
    before = {c: c.value for c in counters}
    got = grads()
    ran = {c.name: c.value - n for c, n in before.items()}
    for kern in ("flash_attention", "ssm_scan"):
        # each call's backward once; its forward once, or twice where remat recomputes it
        assert ran[kern + "_bwd"] == calls[kern], (kern, ran, calls)
        assert calls[kern] <= ran[kern] <= 2 * calls[kern], (kern, ran, calls)
    if cfg.family in ("dense", "ssm"):  # one op a layer, every layer rematerialised
        kern = "ssm_scan" if cfg.family == "ssm" else "flash_attention"
        assert ran[kern] == 2 * cfg.n_layers and ran[kern + "_bwd"] == cfg.n_layers, ran
    by_id = {id(p): g for p, g in zip(leaves, got)}
    for mixer, names in (("ssm", ("in_proj", "a_log", "x_proj", "dt_proj", "conv")),
                         ("attn", ("wq", "wk", "wv"))):
        for period in params["blocks"]:
            if mixer in period:
                for name in names:
                    assert float(by_id[id(period[mixer][name])].abs().max()) > 0, name
                break
        else:
            assert calls["ssm_scan" if mixer == "ssm" else "flash_attention"] == 0
    saved = attention_mod.flash_attention, ssm_mod.selective_scan
    attention_mod.flash_attention, ssm_mod.selective_scan = attention_ref, selective_scan_ref
    try:
        want = grads()
    finally:
        attention_mod.flash_attention, ssm_mod.selective_scan = saved
    bound = 1e-4 * max(float(w.abs().max()) for w in want)
    for g, w in zip(got, want):
        assert float((g - w).abs().max()) <= bound


def test_trainer_resumes_exactly_on_the_card(card, tmp_path):
    """A crash at step 5, resumed from the async checkpoint, reaches the
    parameters of an uninterrupted run bit for bit on the card."""
    from repro_torch.configs.base import RunConfig
    from repro_torch.data import DataConfig, Pipeline
    from repro_torch.train import Trainer, make_train_step
    from repro_torch.tree import tree_leaves

    cfg = dataclasses.replace(configs.get_smoke("smollm-135m"), dtype="bfloat16")
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=64, global_batch=4))

    def run(ckpt, fail_at):
        run_cfg = RunConfig(learning_rate=1e-3, warmup_steps=2, checkpoint_every=2,
                            checkpoint_dir=str(ckpt))
        step, opt_init = make_train_step(cfg, run_cfg, device=card)
        t = Trainer.resume_or_init(
            cfg, run_cfg, pipe,
            lambda: init_params(cfg, PRNGKey(0), device=card),
            step, opt_init, device=card)
        armed = {"on": fail_at is not None}

        def hook(s):
            if armed["on"] and s == fail_at:
                armed["on"] = False
                raise RuntimeError("simulated node failure")

        t.run(8, fail_hook=hook)
        return [x.clone() for x in tree_leaves(t.params)]

    want, got = run(tmp_path / "a", None), run(tmp_path / "b", 5)
    assert all(torch.equal(a, b) for a, b in zip(want, got))


@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_changes_no_gradient_on_the_card(card, remat):
    """Remat around the kernels' autograd functions (checkpointed, or the
    selective "dots" policy) recomputes the same forward: the gradients
    equal those without remat bit for bit (the backward kernels are
    deterministic)."""
    from repro_torch.models import loss_fn
    from repro_torch.tree import tree_leaves

    grads = {}
    for mode in ("none", remat):
        cfg = dataclasses.replace(configs.get_smoke("jamba-v0.1-52b"), remat=mode)
        params = init_params(cfg, PRNGKey(0), device=card)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        rng = np.random.default_rng(1)
        batch = {k: torch.from_numpy(rng.integers(0, cfg.vocab_size, (2, 32))).to(card)
                 for k in ("tokens", "labels")}
        loss, _ = loss_fn(cfg, params, batch)
        grads[mode] = torch.autograd.grad(loss, leaves)
    assert all(torch.equal(a, b) for a, b in zip(grads["none"], grads[remat]))


# ----------------------------------------------------------------------
# the counter-based draw (kernels/prng): the kernel against its plain version
# ----------------------------------------------------------------------
PRNG_WINDOWS = [
    ((1,), (0,), (1,)),
    ((1000003,), (0,), (1000003,)),  # odd size, one merged dim
    ((37, 129), (5, 3), (20, 100)),  # a column block: two dims
    ((6, 40, 72), (1, 8, 0), (4, 16, 72)),  # inner dim whole
    ((3, 5, 7, 9), (1, 1, 2, 3), (2, 3, 4, 5)),  # four dims
    ((2**33,), (2**32 - 100,), (4096,)),  # across the count's high word
    ((4, 2**16, 2**16), (3, 2**16 - 1, 2**16 - 77), (1, 1, 77)),  # the last element of 2^34
]


def _ordered_f32(t: torch.Tensor) -> torch.Tensor:
    i = t.float().view(torch.int32).long()
    return torch.where(i < 0, -(i & 0x7FFFFFFF), i)


@pytest.mark.parametrize("shape,offset,block", PRNG_WINDOWS)
def test_prng_kernel_against_plain_version(card, shape, offset, block):
    """Bits exactly; uniforms exactly (one fmaf each side); normals (f32,
    scaled) within 4 f32 ulp (log1pf on the card, log1p on the host); in
    bf16 equal but where the two f32 values round apart, by one ulp."""
    from repro_torch import random as R
    from repro_torch.kernels.prng import kernel as prng_kernel

    key = R.split(PRNGKey(17), 4)[3]
    before = prng_kernel.launches.value
    got = R.bits(key, shape, offset=offset, block=block, device=card)
    assert torch.equal(got.cpu(), R.bits(key, shape, offset=offset, block=block, device="cpu"))
    u = R.uniform(key, shape, -3.0, 2.5, offset=offset, block=block, device=card)
    assert torch.equal(u.cpu(), R.uniform(key, shape, -3.0, 2.5, offset=offset, block=block,
                                          device="cpu"))
    scale = 1.0 / np.sqrt(72)
    for dtype in (torch.float32, torch.bfloat16):
        k_out = torch.empty(block, dtype=dtype, device=card)
        p_out = torch.empty(block, dtype=dtype)
        R.normal_(k_out, key, shape, offset, scale=scale)
        R.normal_(p_out, key, shape, offset, scale=scale)
        k_out = k_out.cpu()
        if dtype == torch.float32:
            assert int((_ordered_f32(k_out) - _ordered_f32(p_out)).abs().max()) <= 4
        else:
            diff = k_out.view(torch.int16) != p_out.view(torch.int16)
            assert int(diff.sum()) <= max(2, k_out.numel() // 10_000)
            steps = (k_out.view(torch.int16).int() - p_out.view(torch.int16).int())[diff].abs()
            assert bool((steps == 1).all())
    torch.cuda.synchronize()
    assert prng_kernel.launches.value - before == 4


def test_prng_init_params_on_the_card_equals_the_cpu_draw(card):
    """init_params on the card draws with the kernel (its launches counted)
    the CPU draw's parameters: the f32 leaves within 4 ulp."""
    from repro_torch.kernels.prng import kernel as prng_kernel
    from repro_torch.tree import tree_leaves

    cfg = configs.get_smoke("qwen3-moe-30b-a3b")
    before = prng_kernel.launches.value
    on_card = tree_leaves(init_params(cfg, PRNGKey(0), device=card))
    torch.cuda.synchronize()
    assert prng_kernel.launches.value > before
    on_cpu = tree_leaves(init_params(cfg, PRNGKey(0), device="cpu"))
    for a, b in zip(on_card, on_cpu):
        assert a.dtype == b.dtype == torch.float32
        assert int((_ordered_f32(a.cpu()) - _ordered_f32(b)).abs().max()) <= 4


def test_prng_kernel_refuses_what_it_cannot_take(card):
    from repro_torch.kernels.prng import kernel as prng_kernel

    with pytest.raises(TypeError):
        prng_kernel.draw_cuda(torch.empty(4, dtype=torch.int32, device=card), 0, 0, (4,), (0,),
                              "bits")
    with pytest.raises(ValueError, match="contiguous"):
        prng_kernel.draw_cuda(torch.empty(4, 4, device=card).t(), 0, 0, (4, 4), (0, 0),
                              "normal")
    with pytest.raises(ValueError, match="merged dims"):
        prng_kernel.draw_cuda(torch.empty(2, 2, 2, 2, 2, device=card), 0, 0, (3, 3, 3, 3, 3),
                              (0,) * 5, "normal")


# ----------------------------------------------------------------------
# the categorical pick (kernels/prng/csrc/gumbel_pick.cu): the kernel
# against its plain version
# ----------------------------------------------------------------------
PICK_SHAPES = [(1, 1), (3, 7), (8, 2049), (8, 49152), (5, 152064), (64, 512)]


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("b,v", PICK_SHAPES)
def test_pick_kernel_against_plain_version(card, b, v, dtype):
    """One launch a call; bfloat16 picks equal the plain version's (rows of
    one value included, which the noise's ties decide); float32 picks equal
    but where the plain scores of the two picks lie within 4 ulp (the
    card's logf against the host's log)."""
    from repro_torch import random as R
    from repro_torch.kernels.prng import kernel as prng_kernel
    from repro_torch.kernels.prng.ref import gumbel_pick_ref, pick_scores_ref

    gen = torch.Generator(card).manual_seed(b * v)
    x = (torch.randn((b, v), generator=gen, device=card) * 3).to(dtype)
    x[: max(1, b // 4)] = 0.0 if dtype == torch.bfloat16 else 2.0**26
    for temperature in (1.0, 0.7):
        k0, k1 = R.key_words(R.split(PRNGKey(v), 2)[1])
        before = prng_kernel.pick_launches.value
        got = prng_kernel.gumbel_pick_cuda(x, k0, k1, temperature)
        torch.cuda.synchronize()
        assert prng_kernel.pick_launches.value - before == 1
        want = gumbel_pick_ref(x, k0, k1, temperature)
        assert got.dtype == torch.int64 and got.shape == (b,)
        if dtype == torch.bfloat16:
            assert torch.equal(got, want)
        else:
            s = pick_scores_ref(x, k0, k1, temperature).float()
            rows = torch.arange(b, device=card)
            ulps = (_ordered_f32(s[rows, got].cpu()) - _ordered_f32(s[rows, want].cpu())).abs()
            assert int(ulps.max()) <= 4


def test_pick_kernel_takes_a_row_stride_and_graphs(card):
    """Rows of a larger tensor (the last position of [B, S, V] logits),
    and a capture replayed: the same picks as the contiguous rows."""
    from repro_torch.kernels.prng import kernel as prng_kernel

    x = torch.randn((4, 3, 1000), device=card).bfloat16()
    rows = x[:, -1]
    assert not rows.is_contiguous()
    want = prng_kernel.gumbel_pick_cuda(rows.contiguous(), 5, 6, 0.7)
    assert torch.equal(prng_kernel.gumbel_pick_cuda(rows, 5, 6, 0.7), want)
    graph = torch.cuda.CUDAGraph()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        prng_kernel.gumbel_pick_cuda(rows, 5, 6, 0.7)
    torch.cuda.current_stream().wait_stream(side)
    with torch.cuda.graph(graph):
        out = prng_kernel.gumbel_pick_cuda(rows, 5, 6, 0.7)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def test_gumbel_draws_on_the_card_equal_the_plain_version(card):
    """The threefry kernel's Gumbel noise: bfloat16 equal on 2^20 draws
    (its 128 values), float32 within two ulp of the larger of |x| and 1."""
    from repro_torch import random as R

    key = PRNGKey(5)
    n = 1 << 20
    got = R.gumbel(key, (n,), torch.bfloat16, device=card).cpu()
    assert torch.equal(got, R.gumbel(key, (n,), torch.bfloat16, device="cpu"))
    assert torch.unique(got).numel() == 128
    got = R.gumbel(key, (n,), device=card).cpu().double()
    want = R.gumbel(key, (n,), device="cpu")
    scale = torch.maximum(want.abs(), torch.ones_like(want))
    assert float(((got - want.double()).abs() / (torch.nextafter(scale, scale * 2) - scale)
                  .double()).max()) <= 2


def test_engine_picks_categorically_on_the_card(card):
    """``Engine(sample="categorical")`` on the card: one pick launch a pick,
    the tokens those of the same engine on the CPU (float32 smoke model,
    the same key)."""
    from repro_torch.kernels.prng import kernel as prng_kernel
    from repro_torch.serve import Engine, Request

    cfg = configs.get_smoke("smollm-135m")
    params = init_params(cfg, PRNGKey(0), device="cpu")
    prompts = np.random.default_rng(0).integers(2, cfg.vocab_size, size=(4, 10)).astype(np.int32)

    def serve(device):
        eng = Engine(cfg, params, 4, 24, eos_id=-1, sample="categorical", temperature=0.7,
                     device=device)
        before = prng_kernel.pick_launches.value
        reqs = eng.generate([Request(p, 5) for p in prompts])
        return [r.out_tokens for r in reqs], prng_kernel.pick_launches.value - before

    on_card, picks = serve(card)
    on_cpu, none = serve("cpu")
    assert picks == 5 and none == 0
    assert on_card == on_cpu
