"""The port on the CUDA card: the hand-written adder-graph kernel (both
entry points: values in shared memory, and the global scratch for a
table too large for it) against its plain PyTorch version, the committed
full-size designs against their JAX golden outputs, and the serving
engine (tolerance: exact equality); the hand-written flash-attention
kernel (decode at GQA group sizes 1, 3, 4 and 8, tensor-core and
CUDA-core prefill) against its plain PyTorch version (atol 2e-5 in
float32, 2e-2 in bfloat16: the decode kernel keeps ``p`` in f32 where
the plain version casts it to the working dtype, and the outputs round
to bf16); the hand-written selective-scan kernels (decode at every N from 1
to 16, prefill) against their plain version (atol 1e-5, the JAX kernel
tests' own) and the W8A8 matmul kernels (TMA/wgmma and mma.sync)
against their plain version (exact); and the reduced smollm-135m
and falcon-mamba LMs against their committed JAX golden tokens (exact)
and logits (atol 1e-4 in float32).

Every test here needs a card and skips without one.  This file imports
neither ``jax`` nor ``repro``, so it runs where only PyTorch is
installed:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.core import DAISProgram, QInterval, Term
from repro_torch.flow import ServeConfig
from repro_torch.kernels.adder_graph import adder_graph_apply, compile_tables
from repro_torch.kernels.adder_graph import kernel as ag_kernel
from repro_torch.kernels.adder_graph.ref import adder_graph_ref
from repro_torch.kernels.flash_attention import flash_attention
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.flash_attention.ref import attention_ref
from repro_torch.kernels.quant_matmul import kernel as qm_kernel
from repro_torch.kernels.quant_matmul import quant_matmul
from repro_torch.kernels.quant_matmul.ref import quant_matmul_ref
from repro_torch.kernels.ssm_scan import kernel as ss_kernel
from repro_torch.kernels.ssm_scan import selective_scan
from repro_torch.kernels.ssm_scan.ref import selective_scan_ref
from repro_torch.models import decode_step, params_from_numpy, prefill, unflatten
from repro_torch.nn.compiler import count_cmvm_steps
from repro_torch.runtime import ServeEngine, load_design
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


def test_engine_serves_golden(card):
    with np.load(ASSETS / "mixer_full" / "golden.npz") as g:
        x, y = g["x"][:512].astype(np.int32), g["y"][:512]
    with ServeEngine(ServeConfig(max_batch=64, shards=2)) as eng:
        eng.register("mixer", ASSETS / "mixer_full", warmup=True)
        got = np.stack([f.result(60) for f in eng.submit_batch("mixer", x)])
        s = eng.stats("mixer")
    np.testing.assert_array_equal(got, y)
    assert s["device"] == str(card) and s["n_batches"] > 0 and s["breaker"]["n_trips"] == 0


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


def test_flash_wrapper_rejects_what_it_does_not_take(card):
    q, k, v = _qkv(card, torch.float32, 1, 4, 2, 8, 8, 64)
    with pytest.raises(ValueError, match="head_dim"):
        fa_kernel.flash_attention_cuda(*_qkv(card, torch.float32, 1, 4, 2, 8, 8, 80))
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
    before = counter.launches.value
    Engine(cfg, params, manifest["batch_size"], manifest["max_seq"],
           eos_id=manifest["eos_id"]).generate(reqs)
    assert counter.launches.value - before == cfg.n_layers * (1 + manifest["decode_steps"])
    for r, want in zip(reqs, golden["tokens"]):
        assert r.out_tokens == [int(t) for t in want if t >= 0]
    tokens = torch.from_numpy(np.stack([r.prompt for r in reqs])).to(card)
    logits, cache = prefill(cfg, params, {"tokens": tokens}, manifest["max_seq"])
    np.testing.assert_allclose(logits.cpu().numpy(), golden["prefill_logits"], atol=1e-4, rtol=0)
    logits, _ = decode_step(cfg, params, logits.argmax(-1)[:, None], cache)
    np.testing.assert_allclose(logits.cpu().numpy(), golden["decode_logits"], atol=1e-4, rtol=0)


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
