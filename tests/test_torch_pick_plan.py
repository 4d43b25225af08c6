"""The categorical pick kernel's launch plan and its order rule, on the CPU
(no card, no JAX).

- ``kernel.pick_plan`` at batches 1, 8, 64 and 65,535 against the seven
  served architectures' padded vocabularies (falcon-mamba-7b's 65,024
  among them) and vocabularies of 1, 3 and 512, on 132 SMs: the blocks of
  a row (``pick_bounds``, the kernel's ``pick_bound``) cover each logit
  once, start at multiples of ``PICK_GROUP``, and hold at least
  ``PICK_MIN_BLOCK`` logits each unless the row is shorter; at batch 8
  and a vocabulary of 49,152 or more the grid fills every SM; the grid
  stays within CUDA's limits.
- ``kernel.pick_keys``, the 64-bit words the kernel's combine reduces:
  the largest word of a row holds ``torch.argmax``'s index, on float32
  and bfloat16 rows with NaNs (the first wins), all NaN, +-inf, all
  -inf, ties (the lowest index) and -0.0 beside 0.0 (equal).
- The kernel's division: the float64 product of a logit with 1 / T,
  rounded to float32, is float32 division's quotient for every bfloat16
  logit and float32 logits of every exponent, at temperatures rounded to
  bfloat16 and float32; ``kernel.exact_division`` flags the temperatures
  (odd * 2^a, a >= 1) where a subnormal quotient can be a midpoint, the
  case the product's argument leaves out, which the kernel divides.
"""

from fractions import Fraction

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels.prng import kernel as pk

SERVED = ("smollm-135m", "falcon-mamba-7b", "stablelm-3b", "qwen3-moe-30b-a3b", "whisper-base",
          "internvl2-26b", "jamba-v0.1-52b")
VOCABS = sorted({configs.get(a).padded_vocab for a in SERVED} | {65024, 1, 3, 512})
SMS = 132
MAX_GRID_X = 2**31 - 1


def test_the_vocabularies_are_the_served_ones():
    assert len(VOCABS) == 10  # seven served (falcon-mamba's 65,024 one of them), 1, 3, 512
    assert 65024 in VOCABS and 152064 in VOCABS


@pytest.mark.parametrize("v", VOCABS)
@pytest.mark.parametrize("b", [1, 8, 64, 65535])
def test_pick_plan_covers_every_logit_once(b, v):
    plan = pk.pick_plan(b, v, SMS)
    assert plan.blocks == b * plan.splits
    assert plan.blocks_per_sm == -(-plan.blocks // SMS)
    assert 1 <= plan.splits <= MAX_GRID_X and b <= pk.MAX_GRID_Y
    assert pk.PICK_THREADS <= 1024 and pk.PICK_THREADS % 32 == 0
    bounds = pk.pick_bounds(v, plan.splits)
    assert bounds[0] == 0 and bounds[-1] == v and len(bounds) == plan.splits + 1
    sizes = np.diff(bounds)
    assert (sizes > 0).all()  # each logit in exactly one block, no block empty
    assert all(lo % pk.PICK_GROUP == 0 for lo in bounds[:-1])
    assert sizes.min() >= min(v, pk.PICK_MIN_BLOCK)
    if b == 8 and v >= 49152:
        assert plan.blocks >= SMS
    if plan.blocks <= SMS * pk.PICK_BLOCKS_PER_SM:
        assert plan.blocks_per_sm <= pk.PICK_BLOCKS_PER_SM


def test_pick_plan_at_decode_fills_the_card_evenly():
    """B = 8: two blocks on every SM; B = 1: one block on every SM."""
    assert pk.pick_plan(8, 49152, SMS) == pk.PickPlan(33, 264, 2)
    assert pk.pick_plan(8, 152064, SMS) == pk.PickPlan(33, 264, 2)
    assert pk.pick_plan(1, 152064, SMS) == pk.PickPlan(132, 132, 1)
    assert pk.pick_plan(64, 512, SMS).splits == 1  # short rows are not split


def _rows(dtype):
    nan, inf = float("nan"), float("inf")
    g = np.random.default_rng(0)
    x = torch.from_numpy(g.standard_normal((9, 40)).astype(np.float32)).to(dtype).float()
    x[0, [17, 5, 30]] = nan
    x[1] = nan
    x[2] = -inf
    x[3, [29, 7]] = inf
    x[4] = -inf
    x[4, 11] = 1.0
    x[5] = 2.0
    x[5, [3, 20]] = 2.5  # ties: the lower index
    x[6] = torch.where(torch.arange(40) % 2 == 0, -0.0, 0.0)  # all equal: index 0
    x[7] = -0.0
    x[7, 0] = -1.0
    x[8, [13, 2]] = 9.0
    return x.to(dtype)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_pick_keys_order_as_argmax(dtype):
    x = _rows(dtype)
    want = torch.argmax(x, -1)
    assert want.tolist()[:8] == [5, 0, 0, 7, 11, 3, 0, 1]
    words = pk.pick_keys(x)
    assert words.dtype == torch.int64
    assert torch.equal(pk.pick_index(words.max(-1).values), want)
    # in any order of combining: the max over shuffled halves is the same word
    perm = torch.from_numpy(np.random.default_rng(1).permutation(40))
    halves = torch.stack([words[:, perm[:20]].max(-1).values, words[:, perm[20:]].max(-1).values])
    assert torch.equal(halves.max(0).values, words.max(-1).values)


def test_pick_keys_put_every_nan_above_inf_and_signed_zeros_together():
    x = torch.tensor([-float("inf"), -1.0, -0.0, 0.0, 1.0, float("inf"), float("nan"),
                      -float("nan")])
    keys = pk.pick_keys(x) >> 32
    assert keys.tolist() == sorted(keys.tolist())
    assert keys[2] == keys[3] and keys[6] == keys[7]
    assert len(set(keys.tolist())) == 6


def _bf16_values() -> np.ndarray:
    """Every finite bfloat16 value, as float32."""
    bits = np.arange(1 << 16, dtype=np.uint32) << 16
    x = bits.view(np.float32)
    return x[np.isfinite(x)]


TEMPERATURES = [0.7, 1.0, 0.5, 1.5, 3.0, 0.1, 2.0**-20, 7.0 / 16, 1e-30, 2.0**100, 0.0, np.inf]


@pytest.mark.parametrize("t_dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("t", TEMPERATURES)
def test_the_float64_product_divides_as_fdiv_rn(t, t_dtype):
    """The kernel's quotient where ``exact_division`` is false: the float64
    product of x with 1 / t (rounded to float64), rounded to float32, is
    float32 division's x / t for every bfloat16 x and for float32 x over
    all exponents (zeros, subnormals, infinities and NaN included), with t
    rounded to bfloat16 or float32 as the logits' dtype rounds it."""
    t32 = np.float32(pk.weak_scalar(t, t_dtype) if t not in (0.0, np.inf) else t)
    assert not pk.exact_division(float(t32))
    g = np.random.default_rng(7)
    x = np.concatenate([
        _bf16_values(),
        (g.integers(0, 1 << 32, 1 << 18, dtype=np.uint64).astype(np.uint32)).view(np.float32),
        np.array([0.0, -0.0, np.inf, -np.inf, np.nan, 2.0**-149, -(2.0**-149)], np.float32)])
    with np.errstate(all="ignore"):
        want = x / t32
        rcp = 1.0 / np.float64(t32) if t32 != 0 else np.inf
        got = (x.astype(np.float64) * rcp).astype(np.float32)
    same = (got.view(np.uint32) == want.view(np.uint32)) | (np.isnan(got) & np.isnan(want))
    assert same.all(), (x[~same][:5], got[~same][:5], want[~same][:5])


def test_exact_division_flags_the_temperatures_with_midpoint_quotients():
    """t = odd * 2^a with an odd factor above 1 and a >= 1 (6, 10, 12, ...)
    is where a subnormal quotient of two float32 can lie exactly on a
    float32 rounding midpoint (x = 9 * 2^-149, t = 6: 1.5 * 2^-149), the
    case the float64 product's argument leaves out: those temperatures
    divide.  Elsewhere no quotient is a midpoint (x = 9 * 2^-149 by 3 or
    by 0.75 is not)."""
    assert [pk.exact_division(t) for t in (6.0, 10.0, 12.0, 3.0, 1.5, 0.75, 4.0, 0.7, -6.0)] == [
        True, True, True, False, False, False, False, False, True]
    x = Fraction(9, 2**149)
    assert x / 6 == Fraction(3, 2**150)  # an odd multiple of half the spacing 2^-149
    for t in (Fraction(3), Fraction(3, 4)):
        assert (x / t / Fraction(1, 2**150)).denominator != 1 or (x / t * 2**150) % 2 == 0
