"""The port's optimizers on the CPU against the JAX package's:
``quantize``/``dequantize`` (8-bit states, bit for bit), AdamW in its
three memory modes (f32 master, bf16-as-master, int8 moments) and
Adafactor on the toy tree of ``tests/test_runtime.py`` (states and
parameters after 1 and after 20 updates), and ``lr_schedule``.

The same numpy inputs and the same gradients (computed by JAX) go to
both.  Tolerances: the first AdamW update is bit for bit (the
arithmetic is the reference's, in f32 and in its order); after 20
updates states and parameters agree within 1e-6 in f32 (XLA's f32 pow
and PyTorch's differ in the last bit at some t, e.g. 0.95^6, and the
bias corrections carry that ulp on), and an int8 payload within one
step.  Adafactor's means sum in another order than XLA's: 2e-6 after 1
and 20 updates.  ``lr_schedule`` is exact at steps 0, 1, the end of
warmup and 10,000.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.configs.base import RunConfig as JaxRunConfig
from repro.optim import lr_schedule as jax_lr_schedule
from repro.optim import make_adafactor as jax_adafactor
from repro.optim import make_adamw as jax_adamw
from repro.optim.quantized_state import dequantize as jax_dequantize
from repro.optim.quantized_state import quantize as jax_quantize
from repro_torch.configs.base import RunConfig
from repro_torch.optim import (
    AdafactorState,
    AdamWState,
    Quantized,
    dequantize,
    lr_schedule,
    make_adafactor,
    make_adamw,
    make_optimizer,
    quantize,
)
from repro_torch.tree import tree_leaves


@pytest.mark.parametrize("signed", [True, False])
@pytest.mark.parametrize("n", [1, 256, 1000, 4096 + 3])
def test_quantize_matches_jax_bit_for_bit(n, signed):
    rng = np.random.default_rng(n)
    x = (rng.standard_normal(n) * 3.0).astype(np.float32)
    if not signed:
        x = x * x
    jz = jax_quantize(jnp.asarray(x), signed)
    tz = quantize(torch.from_numpy(x), signed)
    assert isinstance(tz, Quantized) and tz.shape == (n,) and tz.signed == signed
    assert tz.q.dtype == (torch.int8 if signed else torch.uint8)
    np.testing.assert_array_equal(tz.q.numpy(), np.asarray(jz.q))
    np.testing.assert_array_equal(tz.scale.numpy(), np.asarray(jz.scale))
    np.testing.assert_array_equal(dequantize(tz).numpy(), np.asarray(jax_dequantize(jz)))


def _toy():
    """The toy tree of tests/test_runtime.py, drawn with numpy."""
    rng = np.random.default_rng(0)
    return {
        "w": rng.standard_normal((32, 16)).astype(np.float32),
        "b": np.zeros((16,), np.float32),
        "deep": [{"u": rng.standard_normal((16, 8)).astype(np.float32)}],
    }


def _quad_loss(p, x):
    h = jnp.tanh(x @ p["w"] + p["b"])
    return jnp.sum((h @ p["deep"][0]["u"]) ** 2) / x.shape[0]


MODES = {
    "adamw_f32_master": (lambda: jax_adamw(), lambda: make_adamw()),
    "adamw_bf16_master": (lambda: jax_adamw(master_dtype=None),
                          lambda: make_adamw(master_dtype=None)),
    "adamw_int8": (lambda: jax_adamw(state_dtype="int8"), lambda: make_adamw(state_dtype="int8")),
    "adafactor": (lambda: jax_adafactor(), lambda: make_adafactor()),
}


def _run(mode, n_updates):
    """(JAX leaves, port leaves) of (params, state) after n_updates, and
    whether the port descended."""
    make_j, make_t = MODES[mode]
    (j_init, j_update), (t_init, t_update) = make_j(), make_t()
    jp = jax.tree.map(jnp.asarray, _toy())
    tp = jax.tree.map(lambda a: torch.from_numpy(a.copy()), _toy())
    js, ts = j_init(jp), t_init(tp)
    x = jnp.asarray(np.random.default_rng(1).standard_normal((64, 32)).astype(np.float32))
    grad = jax.jit(jax.grad(_quad_loss))
    for _ in range(n_updates):
        g = grad(jp, x)
        tg = jax.tree.map(lambda a: torch.from_numpy(np.array(a)), g)
        jp, js = j_update(g, js, jp, 1e-2)
        tp, ts = t_update(tg, ts, tp, 1e-2)
    return [np.asarray(a) for a in jax.tree.leaves((jp, js))], [t.numpy() for t in
                                                                  tree_leaves((tp, ts))]


@pytest.mark.parametrize("mode", list(MODES))
def test_one_update_matches_jax(mode):
    jl, tl = _run(mode, 1)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and a.shape == b.shape
        if mode == "adafactor":
            np.testing.assert_allclose(b, a, rtol=0, atol=2e-6)
        else:
            np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize("mode", list(MODES))
def test_twenty_updates_match_jax(mode):
    jl, tl = _run(mode, 20)
    assert len(jl) == len(tl)
    for a, b in zip(jl, tl):
        assert a.dtype == b.dtype and a.shape == b.shape
        if a.dtype.kind in "iu" and a.ndim:  # an int8 payload
            assert np.abs(a.astype(np.int64) - b.astype(np.int64)).max() <= 1
        else:
            np.testing.assert_allclose(b, a, rtol=0, atol=2e-6 if mode == "adafactor" else 1e-6)


def test_states_flatten_like_jax():
    """The port's states have the JAX states' leaves in the same order:
    a checkpoint of one restores into the other."""
    for mode, (make_j, make_t) in MODES.items():
        js = make_j()[0](jax.tree.map(jnp.asarray, _toy()))
        ts = make_t()[0](jax.tree.map(lambda a: torch.from_numpy(a.copy()), _toy()))
        assert isinstance(ts, AdafactorState if mode == "adafactor" else AdamWState)
        jl, tl = jax.tree.leaves(js), tree_leaves(ts)
        assert [(np.asarray(a).shape, np.asarray(a).dtype) for a in jl] == \
            [(t.shape, t.numpy().dtype) for t in tl], mode


@pytest.mark.parametrize("step", [0, 1, 99, 10_000])
def test_lr_schedule_matches_jax(step):
    kw = dict(learning_rate=3e-3, warmup_steps=100)
    want = np.asarray(jax_lr_schedule(JaxRunConfig(**kw), step))
    got = lr_schedule(RunConfig(**kw), step)
    assert got.dtype == torch.float32
    assert got.numpy().tobytes() == want.tobytes()


def test_make_optimizer_picks_the_configured_one():
    p = {"w": torch.zeros(32, 32)}
    assert isinstance(make_optimizer(RunConfig(optimizer="adafactor"))[0](p), AdafactorState)
    state = make_optimizer(RunConfig(state_dtype="int8", master_dtype=None))[0](p)
    assert isinstance(state, AdamWState) and state.master is None
    assert isinstance(state.m["w"], Quantized) and state.m["w"].signed
    assert not state.v["w"].signed
