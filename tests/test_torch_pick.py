"""The rest of ``jax.random`` in the port (``randint``, ``gumbel``,
``categorical``) and the LM engine's categorical pick, on the CPU (the
plain versions of ``kernels/prng``) against ``jax.random`` and the JAX
package's engine.

- ``randint`` equals ``jax.random.randint`` exactly, at spans 5, 8 and
  2^16 (powers of two), 1003 from a negative ``minval``, 70,000 (the
  uint32 multiplier wraps), the whole int32 range and empty spans.
- ``gumbel`` in bfloat16 equals ``jax.random.gumbel`` exactly on 2^20
  draws (every one of its 128 values); in float32 each of its two
  ``log`` is within one float32 ulp of XLA's, so the noise is within two
  ulp of the larger of |x| and 1 (near x = 0 the outer ``log`` carries
  one ulp of the inner one, near 1, into many ulp of a tiny x).
- ``categorical`` against ``jax.random.categorical`` on 64 rows of widths
  49,152 (smollm-135m's padded vocabulary) and 65,024 (falcon-mamba-7b's)
  with forced ties (bfloat16 rows of one value, where 1 in 128 of the
  noise values is the largest; float32 rows at 2^26, whose spacing of 8
  rounds most of the noise away): bfloat16 equal; float32 equal but in
  the rows where the reference's scores of the two picks lie within 4
  ulp, which are counted (the two ``log`` differ).  The pick at
  temperature 0.7 equals the JAX engine's ``categorical(key, logits /
  0.7)`` (T rounded to bfloat16, as a weak type).
- The port's ``Engine(sample="categorical")`` gives the JAX engine's
  tokens over two ``generate`` calls (the key carried from one to the
  next): on a float32 smoke config end to end, on a bfloat16 one picking
  from the JAX engine's logits (the two bfloat16 models round apart).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.models import init_params as jax_init_params
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro_torch import configs
from repro_torch import random as R
from repro_torch.kernels.prng import kernel as prng_kernel
from repro_torch.kernels.prng import ref
from repro_torch.models import params_from_numpy
from repro_torch.serve import Engine, Request

F32_LOG_ULPS = 1
PICK_ULPS = 4
WIDTHS = (49152, 65024)
ROWS = 64


def _jkey(key: torch.Tensor):
    return jnp.asarray(key.numpy().astype(np.uint32))


def _ordered(a: np.ndarray) -> np.ndarray:
    """float32 bits as integers in the order of the floats: ulp distances."""
    i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


@pytest.fixture(autouse=True)
def jax_32_bit():
    """JAX in its default 32-bit mode, whose draws the port reproduces
    (int32 ``randint``): other test modules turn x64 on for the whole
    process when they are imported."""
    with jax.enable_x64(False):
        yield


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The plain draws are many small element-wise ops: one intra-op
    thread keeps them fast beside the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize("minval,maxval", [
    (0, 5), (0, 8), (0, 2**16), (-3, 1000), (0, 70000), (-(2**31), 2**31 - 1), (5, 5), (7, 3)])
def test_randint_matches_jax(minval, maxval):
    key = R.split(R.PRNGKey(11), 3)[2]
    got = R.randint(key, (37, 29), minval, maxval, device="cpu")
    want = np.asarray(jax.random.randint(_jkey(key), (37, 29), minval, maxval))
    assert got.dtype == torch.int32 and want.dtype == np.int32
    np.testing.assert_array_equal(got.numpy(), want)


def test_randint_refuses_bounds_past_int32():
    with pytest.raises(ValueError, match="int32"):
        R.randint(R.PRNGKey(0), (3,), 0, 2**31)


def test_gumbel_bf16_matches_jax_exactly():
    key = R.PRNGKey(5)
    got = R.gumbel(key, (1 << 20,), torch.bfloat16, device="cpu")
    want = np.asarray(jax.random.gumbel(_jkey(key), (1 << 20,), jnp.bfloat16).astype(jnp.float32))
    assert got.dtype == torch.bfloat16
    assert len(np.unique(want)) == 128  # every value the 7-bit uniform gives
    np.testing.assert_array_equal(got.float().numpy(), want)


def test_gumbel_f32_within_an_ulp_of_each_log():
    key = R.PRNGKey(5)
    n = 1 << 20
    got = R.gumbel(key, (n,), device="cpu").numpy()
    want = np.asarray(jax.random.gumbel(_jkey(key), (n,), jnp.float32))
    # the inner log, -log(u), on the same uniforms
    bits = R.bits(key, (n,), device="cpu")
    u = ref.uniform_from_bits(bits, ref.TINY, 1.0)
    inner = np.asarray(jnp.log(jnp.asarray(u.numpy())))
    assert np.abs(_ordered(ref.log32(u).numpy()) - _ordered(inner)).max() <= F32_LOG_ULPS
    scale = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32)).astype(np.float64)
    far = np.abs(got.astype(np.float64) - want) / scale
    assert far.max() <= 2 * F32_LOG_ULPS
    assert (got != want).mean() < 0.3  # 23% in this draw: logf is not correctly rounded in XLA


def test_gumbel_windows_equal_the_whole_draw():
    key = R.PRNGKey(3)
    for dtype in (torch.float32, torch.bfloat16):
        whole = R.gumbel(key, (7, 300), dtype, device="cpu")
        part = R.gumbel(key, (7, 300), dtype, offset=(2, 17), block=(3, 200), device="cpu")
        assert torch.equal(part, whole[2:5, 17:217])


def _logits(width: int, dtype, seed: int) -> np.ndarray:
    """ROWS rows of normal x 3 logits, the first 8 forced to tie: bfloat16
    rows of one value (the largest noise value, 1 in 128, ties), float32
    rows at 2^26 (a spacing of 8 rounds most of the noise away)."""
    x = np.random.default_rng(seed).standard_normal((ROWS, width)).astype(np.float32) * 3
    x[:8] = 0.0 if dtype == torch.bfloat16 else 2.0**26
    return x


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("width", WIDTHS)
def test_categorical_matches_jax(width, dtype):
    key = R.split(R.PRNGKey(width), 2)[1]
    x = _logits(width, dtype, width)
    jdtype = jnp.bfloat16 if dtype == torch.bfloat16 else jnp.float32
    jx = jnp.asarray(x, jdtype)
    want = np.asarray(jax.random.categorical(_jkey(key), jx, axis=-1))
    got = R.categorical(key, torch.from_numpy(x).to(dtype)).numpy()
    # the reference's scores, to see ties and the rows whose top two are close
    scores = np.asarray((jx + jax.random.gumbel(_jkey(key), jx.shape, jdtype)).astype(jnp.float32))
    tied = [int((s == s.max()).sum()) for s in scores[:8]]
    assert max(tied) > 1, tied  # the forced rows do tie
    rows = np.arange(ROWS)
    apart = got != want
    if dtype == torch.bfloat16:
        np.testing.assert_array_equal(got, want)
    else:
        gap = np.abs(_ordered(scores[rows, got]) - _ordered(scores[rows, want]))
        assert (gap[apart] <= PICK_ULPS).all(), (np.flatnonzero(apart), gap[apart])
        assert apart.sum() <= 2, f"{apart.sum()} of {ROWS} rows apart"
    print(f"categorical {width} {dtype}: {int(apart.sum())} of {ROWS} rows apart, ties {tied}")


def test_categorical_on_another_axis_draws_the_same_noise():
    key = R.PRNGKey(8)
    x = np.random.default_rng(1).standard_normal((300, 5)).astype(np.float32)
    want = np.asarray(jax.random.categorical(_jkey(key), jnp.asarray(x, jnp.bfloat16), axis=0))
    got = R.categorical(key, torch.from_numpy(x).bfloat16(), axis=0)
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("temperature", [0.7, 1.3])
def test_pick_divides_as_the_jax_engine(temperature):
    """``gumbel_pick_ref(logits, key, T)`` is the JAX engine's
    ``categorical(sub, logits / T)``: bfloat16 logits, T a weak type."""
    key = R.split(R.PRNGKey(2), 2)[1]
    x = _logits(WIDTHS[0], torch.bfloat16, 3)[8:24]
    jx = jnp.asarray(x, jnp.bfloat16)
    want = np.asarray(jax.random.categorical(_jkey(key), jx / temperature, axis=-1))
    got = ref.gumbel_pick_ref(torch.from_numpy(x).bfloat16(), *R.key_words(key), temperature)
    np.testing.assert_array_equal(got.numpy(), want)
    assert ref.weak_scalar(temperature, torch.bfloat16) != temperature  # T rounds to bf16


def test_pick_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        prng_kernel.gumbel_pick_cuda(torch.zeros(2, 8), 0, 1)
    with pytest.raises(TypeError, match="float32 or bfloat16"):
        ref.gumbel_pick_ref(torch.zeros(2, 8, dtype=torch.float16), 0, 1)


def _requests(cls, vocab, n_new, prompt_len=10, seed=4):
    rng = np.random.default_rng(seed)
    return [cls(rng.integers(2, vocab, size=prompt_len).astype(np.int32), n) for n in n_new]


@pytest.mark.parametrize("dtype,temperature", [("float32", 1.0), ("float32", 0.7),
                                               ("bfloat16", 1.0), ("bfloat16", 0.7)])
def test_engine_categorical_tokens_equal_the_jax_engines(dtype, temperature):
    """The smoke smollm-135m on the JAX package's weights, served by both
    engines with ``sample="categorical"``: the same tokens, request by
    request, over two ``generate`` calls on one engine each (the second
    draws from the key the first left).  In float32 each engine runs its
    own model.  In bfloat16 the two models' logits differ by a bfloat16
    ulp here and there (up to 0.047 on this config), which moves a pick
    where the noise ties or nearly ties; so the port's engine picks from
    the logits the JAX engine picked from, step by step: its loop, its
    key's schedule and its pick are held, not its model."""
    kw = dict(n_heads=9, n_kv_heads=3, dtype=dtype)
    cfg = configs.get_smoke("smollm-135m", **kw)
    jcfg = dataclasses.replace(jax_configs.get_smoke("smollm-135m", **kw), use_flash_kernel=False)
    jparams = jax_init_params(jcfg, jax.random.PRNGKey(0))
    params = params_from_numpy(cfg, jax.tree.map(np.asarray, jparams), device="cpu")
    jeng = JaxEngine(jcfg, jparams, 4, 24, eos_id=-1, sample="categorical",
                     temperature=temperature)
    eng = Engine(cfg, params, 4, 24, eos_id=-1, sample="categorical", temperature=temperature,
                 device="cpu")
    seen, jax_pick, port_pick = [], jeng._pick, eng._pick

    def recording(logits):
        seen.append(np.asarray(logits.astype(jnp.float32)))
        return jax_pick(logits)

    def replaying(logits):
        want = seen.pop(0)
        assert logits.shape == want.shape and logits.dtype == torch.bfloat16
        return port_pick(torch.from_numpy(want).to(logits.dtype))

    jeng._pick = recording
    if dtype == "bfloat16":
        eng._pick = replaying
    for call in range(2):
        want = jeng.generate(_requests(JaxRequest, cfg.vocab_size, [6, 4, 6], seed=call))
        got = eng.generate(_requests(Request, cfg.vocab_size, [6, 4, 6], seed=call))
        assert [r.out_tokens for r in got] == [r.out_tokens for r in want], call
        assert dtype == "float32" or not seen
        seen.clear()
    np.testing.assert_array_equal(eng.key.numpy().astype(np.uint32), np.asarray(jeng.key))
