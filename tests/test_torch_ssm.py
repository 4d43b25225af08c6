"""The port's SSM family (falcon-mamba) on the CPU against the JAX
package, on the same weights (moved across with ``params_from_numpy``)
and the same numpy inputs: the Mamba-1 block at prefill and at decode,
the reduced falcon-mamba's prefill and decode steps with their caches,
parameters and caches by shape, the engine's greedy tokens, and the
committed ``falcon_mamba_smoke`` asset.

The JAX block writes its recurrence out in one of two modes,
``ssm_mode="seq"`` (a time-major ``lax.scan``) and ``"assoc"`` (a chunked
associative scan), and as one explicit step at decode; the port sends
every recurrence through its ``selective_scan`` op, and is held against
both modes.  Tolerance: atol 1e-5 on one block, 1e-4 on float32 logits
and caches after the whole stack (the same arithmetic with sums in
another order; logits are O(1)), and exact equality of greedy tokens
(the asset records a smallest top-two gap of 1.4e-2).
"""

import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import decode_step as jax_decode_step
from repro.models import forward as jax_forward
from repro.models import init_cache as jax_init_cache
from repro.models import init_params as jax_init_params
from repro.models.ssm import mamba_block as jax_mamba_block
from repro.models.transformer import prefill as jax_prefill
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch import configs
from repro_torch.kernels.ssm_scan import kernel as scan_kernel
from repro_torch.models import (
    decode_step,
    forward,
    init_cache,
    init_params,
    param_specs,
    params_from_numpy,
    prefill,
    ssm,
    unflatten,
)
from repro_torch.random import PRNGKey
from repro_torch.serve import Engine, Request

ARCH = "falcon-mamba-7b"
ASSET = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "assets" / "falcon_mamba_smoke"
ATOL = 1e-4
MODES = ["seq", "assoc"]


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().float().numpy()
    return np.asarray(x, np.float32)


def _jcfg(mode="seq", **kw):
    return dataclasses.replace(jax_configs.get_smoke(ARCH, **kw), ssm_mode=mode)


@pytest.fixture(scope="module")
def mamba():
    """(port cfg, JAX params, port params) of the reduced falcon-mamba,
    float32, JAX weights from PRNGKey(0)."""
    cfg = configs.get_smoke(ARCH)
    jparams = jax_init_params(_jcfg(), jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    return cfg, jparams, params


def _layer(params, i=0):
    return jax.tree.map(lambda a: a[i], params["blocks"][0]["ssm"])


# ----------------------------------------------------------------------
# the Mamba-1 block
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_block_without_cache_matches_reference(mamba, mode):
    cfg, jparams, params = mamba
    x = np.random.default_rng(1).standard_normal((2, 20, cfg.d_model)).astype(np.float32) * 0.3
    want, _ = jax.jit(lambda p, v: jax_mamba_block(_jcfg(mode), p, v))(_layer(jparams), x)
    got = ssm.mamba_block(cfg, _layer(params), torch.from_numpy(x))
    np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0)


@pytest.mark.parametrize("mode", MODES)
def test_block_prefill_then_decode_matches_reference(mamba, mode):
    """A 7-token prefill into a zeroed cache, then four one-token decode
    steps: outputs and the conv / state caches, updated in place."""
    cfg, jparams, params = mamba
    b, di, st, k = 2, cfg.d_inner, cfg.ssm_state, cfg.ssm_conv
    xs = np.random.default_rng(2).standard_normal((b, 11, cfg.d_model)).astype(np.float32) * 0.3
    jblock = jax.jit(lambda p, v, c: jax_mamba_block(_jcfg(mode), p, v, c))
    jcache = {"conv": jnp.zeros((b, k - 1, di)), "h": jnp.zeros((b, di, st), jnp.float32)}
    cache = {"conv": torch.zeros(b, k - 1, di), "h": torch.zeros(b, di, st)}
    conv, h = cache["conv"], cache["h"]
    for lo, hi in ((0, 7), (7, 8), (8, 9), (9, 10), (10, 11)):
        want, jcache = jblock(_layer(jparams), xs[:, lo:hi], jcache)
        got = ssm.mamba_block(cfg, _layer(params), torch.from_numpy(xs[:, lo:hi]), cache)
        np.testing.assert_allclose(_np(got), _np(want), atol=1e-5, rtol=0, err_msg=f"{lo}:{hi}")
        for key in ("conv", "h"):
            np.testing.assert_allclose(_np(cache[key]), _np(jcache[key]), atol=1e-5, rtol=0)
    assert cache["conv"] is conv and cache["h"] is h  # written in place


def test_every_recurrence_goes_through_selective_scan(mamba, monkeypatch):
    """One scan call per layer at prefill and at each decode step, with the
    cache's state as ``h_out``; on the CPU none reaches the kernel."""
    cfg, _, params = mamba
    calls = []
    orig = ssm.selective_scan

    def spy(dt, bmat, cmat, x, a, h0, h_out=None):
        calls.append((dt.shape[1], h_out is not None and h_out.data_ptr() == h0.data_ptr()))
        return orig(dt, bmat, cmat, x, a, h0, h_out=h_out)

    monkeypatch.setattr(ssm, "selective_scan", spy)
    before = scan_kernel.launches.value
    tokens = torch.from_numpy(np.arange(2, 14, dtype=np.int64).reshape(2, 6))
    logits, cache = prefill(cfg, params, {"tokens": tokens}, 16)
    for _ in range(3):
        logits, cache = decode_step(cfg, params, logits.argmax(-1)[:, None], cache)
    assert calls == [(6, True)] * cfg.n_layers + [(1, True)] * (3 * cfg.n_layers)
    assert scan_kernel.launches.value == before


# ----------------------------------------------------------------------
# parameters and caches
# ----------------------------------------------------------------------
def test_param_specs_and_init_cache_match_reference(mamba):
    cfg, jparams, params = mamba
    want = jax.tree.map(lambda a: tuple(a.shape), jparams)
    got = jax.tree.map(lambda s: tuple(s.shape), param_specs(cfg),
                       is_leaf=lambda s: hasattr(s, "fan_in_axis"))
    assert got == want
    assert jax.tree.map(lambda t: tuple(t.shape), params) == want
    assert "norm2" not in params["blocks"][0]  # a block without an FFN has no norm2
    jc = jax_init_cache(_jcfg(), 3, 16)
    tc = init_cache(cfg, 3, 16, device="cpu")
    assert jax.tree.map(lambda a: (tuple(a.shape), str(a.dtype)), jc) == jax.tree.map(
        lambda t: (tuple(t.shape), str(t.dtype).removeprefix("torch.")), tc)
    assert int(tc["pos"]) == 0 and not tc["blocks"][0]["h"].any()


def test_params_from_numpy_takes_bf16_bits_and_checks_shapes():
    cfg16 = configs.get_smoke(ARCH, dtype="bfloat16")
    j16 = jax_init_params(_jcfg(dtype="bfloat16"), jax.random.PRNGKey(1))
    p16 = params_from_numpy(cfg16, jax.tree.map(np.asarray, j16), device="cpu")
    assert p16["blocks"][0]["ssm"]["in_proj"].dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(p16["blocks"][0]["ssm"]["x_proj"]),
                                  _np(j16["blocks"][0]["ssm"]["x_proj"]))
    bad = jax.tree.map(np.asarray, j16)
    bad["blocks"][0]["ssm"]["a_log"] = bad["blocks"][0]["ssm"]["a_log"][:, :, :-1]
    with pytest.raises(ValueError, match="a_log"):
        params_from_numpy(cfg16, bad, device="cpu")


def test_init_params_uses_the_reference_initialisers(mamba):
    """zeros and ones leaves equal the JAX package's exactly, log(1..N)
    within one f32 ulp (the two libraries' log rounds one of the eight
    values the other way); random leaves are seeded and scaled by
    1/sqrt(fan_in)."""
    cfg, jparams, _ = mamba
    a = init_params(cfg, PRNGKey(0), device="cpu")
    b = init_params(cfg, PRNGKey(0), device="cpu")
    s, js = a["blocks"][0]["ssm"], jparams["blocks"][0]["ssm"]
    for key in ("dt_bias", "d"):
        np.testing.assert_array_equal(_np(s[key]), _np(js[key]))
    np.testing.assert_allclose(_np(s["a_log"]), _np(js["a_log"]), rtol=2**-23, atol=0)
    assert torch.equal(a["blocks"][0]["norm1"], torch.ones(cfg.n_layers, cfg.d_model))
    assert torch.equal(s["in_proj"], b["blocks"][0]["ssm"]["in_proj"])
    assert abs(float(s["in_proj"].std()) - cfg.d_model ** -0.5) < 0.01
    assert abs(float(s["conv"].std()) - cfg.ssm_conv ** -0.5) < 0.05
    assert not torch.equal(s["in_proj"][0], s["in_proj"][1])  # each period slice drawn anew


# ----------------------------------------------------------------------
# the stack: prefill, decode, forward
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mode", MODES)
def test_prefill_and_decode_match_reference(mode):
    """Logits and the conv / state caches of prefill and three decode steps."""
    cfg, jcfg = configs.get_smoke(ARCH), _jcfg(mode)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(3))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    max_seq, b, s = 32, 2, 9
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(b, s)).astype(np.int32)
    j_pre = jax.jit(lambda p, t: jax_prefill(jcfg, p, {"tokens": t}, max_seq))
    j_dec = jax.jit(lambda p, t, c: jax_decode_step(jcfg, p, t, c))
    jl, jc = j_pre(jparams, jnp.asarray(tokens))
    tl, tc = prefill(cfg, params, {"tokens": torch.from_numpy(tokens)}, max_seq)
    for step in range(4):
        np.testing.assert_allclose(_np(tl), _np(jl), atol=ATOL, rtol=0, err_msg=f"step {step}")
        for key in ("conv", "h"):
            np.testing.assert_allclose(_np(tc["blocks"][0][key]), _np(jc["blocks"][0][key]),
                                       atol=ATOL, rtol=0, err_msg=f"{key}, step {step}")
        assert int(tc["pos"]) == int(jc["pos"]) == s + step
        nxt = np.asarray(jnp.argmax(jl, axis=-1)).astype(np.int32)[:, None]
        jl, jc = j_dec(jparams, jnp.asarray(nxt), jc)
        tl, tc = decode_step(cfg, params, torch.from_numpy(nxt), tc)


def test_forward_matches_reference_and_prefill(mamba):
    cfg, jparams, params = mamba
    tokens = np.random.default_rng(2).integers(0, cfg.vocab_size, size=(2, 11)).astype(np.int32)
    got, aux = forward(cfg, params, {"tokens": torch.from_numpy(tokens)})
    want, _ = jax.jit(lambda p, t: jax_forward(_jcfg(), p, {"tokens": t}))(jparams, tokens)
    np.testing.assert_allclose(_np(got), _np(want), atol=ATOL, rtol=0)
    assert float(aux) == 0.0
    last, _ = prefill(cfg, params, {"tokens": torch.from_numpy(tokens)}, 16)
    np.testing.assert_allclose(_np(last), _np(got[:, -1]), atol=1e-5, rtol=0)


# ----------------------------------------------------------------------
# the engine
# ----------------------------------------------------------------------
def _requests(cls, vocab, n_new, prompt_len=10, seed=4):
    rng = np.random.default_rng(seed)
    return [cls(rng.integers(2, vocab, size=prompt_len).astype(np.int32), n) for n in n_new]


@pytest.mark.parametrize("mode", MODES)
def test_engine_greedy_tokens_equal_reference(mamba, mode):
    """Request by request, padding included, against the JAX engine."""
    cfg, jparams, params = mamba
    n_new = [6, 3, 6]
    want = JaxEngine(_jcfg(mode), jparams, 4, 24).generate(_requests(JaxRequest, cfg.vocab_size, n_new))
    reqs = _requests(Request, cfg.vocab_size, n_new)
    got = Engine(cfg, params, 4, 24, device="cpu").generate(reqs)
    assert got is reqs and len(reqs) == 4
    assert [r.out_tokens for r in got] == [r.out_tokens for r in want]
    assert [r.done for r in got] == [r.done for r in want]


# ----------------------------------------------------------------------
# the committed asset (chip_smoke.py holds the card to it)
# ----------------------------------------------------------------------
def _asset():
    manifest = json.loads((ASSET / "manifest.json").read_text())
    cfg = configs.get_smoke(manifest["arch"], **manifest["smoke_kwargs"])
    with np.load(ASSET / "weights.npz") as w:
        tree = unflatten(dict(w))
    with np.load(ASSET / "golden.npz") as g:
        golden = dict(g)
    return manifest, cfg, tree, golden


def test_asset_weights_are_the_reference_init():
    manifest, cfg, tree, _ = _asset()
    assert manifest["arch"] == ARCH and cfg.family == "ssm"
    jcfg = jax_configs.get_smoke(manifest["arch"], **manifest["smoke_kwargs"])
    want = jax.tree.map(np.asarray, jax_init_params(jcfg, jax.random.PRNGKey(0)))
    jax.tree.map(np.testing.assert_array_equal, tree, want)
    assert cfg.dtype == "float32" and manifest["n_params"] == cfg.param_count()


def test_port_reproduces_asset_golden_on_cpu():
    manifest, cfg, tree, golden = _asset()
    params = params_from_numpy(cfg, tree, device="cpu")
    reqs = [Request(p, int(n)) for p, n in zip(golden["prompts"], golden["max_new_tokens"])]
    before = scan_kernel.launches.value
    Engine(cfg, params, manifest["batch_size"], manifest["max_seq"],
           eos_id=manifest["eos_id"], device="cpu").generate(reqs)
    assert scan_kernel.launches.value == before  # the CPU runs the plain version
    for r, want in zip(reqs, golden["tokens"]):
        assert r.out_tokens == [int(t) for t in want if t >= 0]
    tokens = torch.from_numpy(np.stack([r.prompt for r in reqs]))
    logits, cache = prefill(cfg, params, {"tokens": tokens}, manifest["max_seq"])
    np.testing.assert_allclose(_np(logits), golden["prefill_logits"], atol=ATOL, rtol=0)
    logits, _ = decode_step(cfg, params, logits.argmax(-1)[:, None], cache)
    np.testing.assert_allclose(_np(logits), golden["decode_logits"], atol=ATOL, rtol=0)
