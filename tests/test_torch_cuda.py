"""The port on the CUDA card: the hand-written adder-graph kernel against
its plain PyTorch version, the committed full-size designs against their
JAX golden outputs, and the serving engine (tolerance: exact equality);
the hand-written flash-attention kernel against its plain PyTorch version
(atol 2e-5 in float32, 2e-2 in bfloat16: the kernel keeps ``p`` in f32
where the plain version casts it to the working dtype) and the reduced
smollm-135m LM against its committed JAX golden tokens (exact) and logits
(atol 1e-4 in float32).

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


def test_lm_asset_reproduces_jax_golden(card):
    """The reduced smollm-135m from the committed JAX weights, served on
    the card: the JAX engine's greedy tokens exactly, prefill and first
    decode logits within 1e-4, one kernel launch per layer per step."""
    torch.backends.cuda.matmul.allow_tf32 = False
    asset = ASSETS / "smollm_smoke"
    manifest = json.loads((asset / "manifest.json").read_text())
    cfg = configs.get_smoke(manifest["arch"], **manifest["smoke_kwargs"])
    with np.load(asset / "weights.npz") as w:
        params = params_from_numpy(cfg, unflatten(dict(w)))
    with np.load(asset / "golden.npz") as g:
        golden = dict(g)
    reqs = [Request(p, int(n)) for p, n in zip(golden["prompts"], golden["max_new_tokens"])]
    before = fa_kernel.launches.value
    Engine(cfg, params, manifest["batch_size"], manifest["max_seq"],
           eos_id=manifest["eos_id"]).generate(reqs)
    assert fa_kernel.launches.value - before == cfg.n_layers * (1 + manifest["decode_steps"])
    for r, want in zip(reqs, golden["tokens"]):
        assert r.out_tokens == [int(t) for t in want if t >= 0]
    tokens = torch.from_numpy(np.stack([r.prompt for r in reqs])).to(card)
    logits, cache = prefill(cfg, params, {"tokens": tokens}, manifest["max_seq"])
    np.testing.assert_allclose(logits.cpu().numpy(), golden["prefill_logits"], atol=1e-4, rtol=0)
    logits, _ = decode_step(cfg, params, logits.argmax(-1)[:, None], cache)
    np.testing.assert_allclose(logits.cpu().numpy(), golden["decode_logits"], atol=1e-4, rtol=0)
