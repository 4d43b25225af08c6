"""The port's counter-based draw (``repro_torch.random``, the plain version
of ``kernels/prng``) against ``jax.random`` on the CPU, and the
parameters ``init_params`` draws with it against the JAX package's.

- ``PRNGKey``, ``split``, ``bits`` and ``uniform`` equal ``jax.random``'s
  bit for bit, at odd shapes and at index windows inside larger arrays;
  the hash equals ``jax.extend.random.threefry_2x32`` at counts whose
  high word is not zero (kimi-k2's expert stacks pass 2^32 elements,
  more than a test can draw in JAX), and a window across 2^32 equals the
  hash of its indices.
- ``normal`` is within 4 float32 ulp of ``jax.random.normal`` on 2^20
  draws: the two ``log1p`` differ by up to 2 ulp, which XLA's ErfInv32
  carries to the result.
- ``init_params(cfg, PRNGKey(0))`` equals the JAX package's for the
  smoke config of each of the ten architectures: zeros and ones exactly,
  normal leaves within 4 float32 ulp, ``a_log`` within 1 ulp (``log``
  of 1..N in each package); in bfloat16 every element equal but for a
  handful, each one bfloat16 ulp off.
- Each rank's sharded draw on a fake 8-rank 2x4 mesh equals the slice of
  the unsharded draw bit for bit, rank by rank (in a subprocess); rank 0
  of kimi-k2-1t-a32b at full width on 256 fake ranks, on the meta device,
  allocates no tensor larger than its largest local leaf or one chunk,
  and its leaves hold 8.16 GB.
"""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import jax.extend.random as jrandom
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jconfigs
from repro.models import init_params as jax_init_params
from repro_torch import configs
from repro_torch import random as R
from repro_torch.kernels.prng import kernel as prng_kernel
from repro_torch.kernels.prng import ops as prng_ops
from repro_torch.kernels.prng import ref
from repro_torch.models import init_params, param_specs
from repro_torch.models.transformer import init_launches, init_scale
from repro_torch.tree import tree_leaves

SRC = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..", "src")
NORMAL_ULPS = 4
ARCHS = sorted(configs.ARCHS)


def _ordered(a: np.ndarray) -> np.ndarray:
    """float32 bits as integers in the order of the floats: ulp distances."""
    i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def _ulps(a, b) -> int:
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return int(np.abs(_ordered(a) - _ordered(b)).max()) if a.size else 0


def _jkey(key: torch.Tensor):
    return jnp.asarray(key.numpy().astype(np.uint32))


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The draws are many small element-wise ops: one intra-op thread
    keeps them fast beside the other test workers' threads."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(autouse=True)
def jax_32_bit():
    """JAX in its default 32-bit mode, whose keys and draws the port
    reproduces: other test modules turn x64 on for the whole process when
    they are imported."""
    with jax.enable_x64(False):
        yield


@pytest.mark.parametrize("seed", [0, 1, 42, 2**31 - 1, -1, -7])
def test_prng_key_matches_jax(seed):
    assert np.array_equal(R.PRNGKey(seed).numpy(), np.asarray(jax.random.PRNGKey(seed)))


def test_prng_key_high_word():
    assert R.PRNGKey(2**40 + 5).tolist() == [2**8, 5]
    with pytest.raises(ValueError):
        R.PRNGKey(2**64)


@pytest.mark.parametrize("num", [1, 2, 5, 300])
def test_split_matches_jax(num):
    key = R.PRNGKey(7)
    want = np.asarray(jax.random.split(jax.random.PRNGKey(7), num))
    assert np.array_equal(R.split(key, num).numpy(), want)
    # a split key splits again as JAX's does
    sub = R.split(key, num)[num - 1]
    assert np.array_equal(R.split(sub, 3).numpy(), np.asarray(jax.random.split(want[-1], 3)))


def test_threefry_2x32_at_high_word_counts():
    key = R.PRNGKey(3)
    rng = np.random.default_rng(0)
    hi = np.concatenate([[1, 2, 0x1F], rng.integers(1, 2**32, 61)]).astype(np.uint32)
    lo = rng.integers(0, 2**32, hi.size).astype(np.uint32)
    # jax's threefry_2x32 hashes the first half of the count with the second
    want = np.asarray(jrandom.threefry_2x32(_jkey(key), jnp.asarray(np.concatenate([hi, lo]))))
    y0, y1 = ref.threefry2x32(*R.key_words(key), torch.from_numpy(hi.astype(np.int64)),
                              torch.from_numpy(lo.astype(np.int64)))
    assert np.array_equal(np.concatenate([y0.numpy(), y1.numpy()]), want)


def test_bits_across_the_high_word():
    """A window across global index 2^32 of an array of 2^33 elements:
    each element is the hash of its index's (hi, lo) words."""
    key = R.PRNGKey(5)
    start, n = 2**32 - 5, 11
    idx = np.arange(start, start + n, dtype=np.uint64)
    count = np.concatenate([(idx >> 32).astype(np.uint32), (idx & 0xFFFFFFFF).astype(np.uint32)])
    y = np.asarray(jrandom.threefry_2x32(_jkey(key), jnp.asarray(count)))
    want = y[:n] ^ y[n:]
    got = R.bits(key, (2**33,), offset=(start,), block=(n,), device="cpu").numpy()
    assert np.array_equal(got, want)
    # the same elements as a window of a 3-d array of 2^33 elements
    got3 = R.bits(key, (2, 2**16, 2**16), offset=(0, 2**16 - 1, 2**16 - 5), block=(2, 1, 5),
                  device="cpu").numpy()
    assert np.array_equal(got3[0, 0], want[:5])


BIT_SHAPES = [(1,), (7,), (3, 5), (2, 3, 37), (4, 1, 6, 9), (2, 3, 1, 5, 7)]


@pytest.mark.parametrize("shape", BIT_SHAPES)
def test_bits_match_jax(shape):
    key = R.PRNGKey(9)
    want = np.asarray(jax.random.bits(_jkey(key), shape, jnp.uint32))
    assert np.array_equal(R.bits(key, shape, device="cpu").numpy(), want)


WINDOWS = [
    ((10, 12), (3, 0), (4, 12)),  # whole rows: one merged dim
    ((10, 12), (2, 5), (6, 4)),  # a column block
    ((4, 6, 8), (1, 2, 0), (2, 3, 8)),  # inner dim whole: two merged dims
    ((4, 6, 8), (0, 5, 3), (4, 1, 2)),  # a dim of extent 1 in the middle
    ((3, 5, 7, 9), (1, 1, 2, 3), (2, 3, 4, 5)),  # four dims, none merged
    ((3, 5, 7, 9), (2, 4, 6, 8), (1, 1, 1, 1)),  # one element
    ((6, 7), (6, 0), (0, 7)),  # empty
]


@pytest.mark.parametrize("shape,offset,block", WINDOWS)
def test_windows_equal_the_whole_draw(shape, offset, block):
    key = R.PRNGKey(4)
    whole = np.asarray(jax.random.bits(_jkey(key), shape, jnp.uint32))
    sl = tuple(slice(o, o + b) for o, b in zip(offset, block))
    got = R.bits(key, shape, offset=offset, block=block, device="cpu")
    assert tuple(got.shape) == block
    assert np.array_equal(got.numpy(), whole[sl])
    wn = R.normal(key, shape, device="cpu").numpy()
    assert np.array_equal(R.normal(key, shape, offset=offset, block=block, device="cpu").numpy(),
                          wn[sl])


def test_window_plan_merges_contiguous_dims():
    assert ref.window_plan((10, 12), (3, 0), (4, 12)) == (36, [(48, 1)])
    assert ref.window_plan((10, 12), (2, 5), (6, 4)) == (29, [(6, 12), (4, 1)])
    assert ref.window_plan((4, 6, 8), (1, 2, 0), (2, 3, 8)) == (64, [(2, 48), (24, 1)])
    assert ref.window_plan((4, 6, 8), (0, 5, 3), (4, 1, 2)) == (43, [(4, 48), (2, 1)])
    assert ref.window_plan((5,), (4,), (1,)) == (4, [])
    with pytest.raises(ValueError):
        ref.window_plan((5, 5), (3, 0), (3, 5))


def test_draws_go_in_chunks(monkeypatch):
    """A draw larger than a chunk gives the values of one pass."""
    key = R.PRNGKey(2)
    want = R.normal(key, (37, 41), offset=(3, 2), block=(30, 39), device="cpu")
    monkeypatch.setattr(ref, "CHUNK", 64)
    assert torch.equal(R.normal(key, (37, 41), offset=(3, 2), block=(30, 39), device="cpu"), want)


@pytest.mark.parametrize("shape,minval,maxval", [
    ((1000,), 0.0, 1.0), ((13, 17), -3.0, 2.5), ((3, 1, 129), -1.0, 1.0),
    ((257,), 1e-3, 7.0), ((5, 11), float(ref.NORMAL_LO), 1.0)])
def test_uniform_matches_jax(shape, minval, maxval):
    key = R.PRNGKey(12)
    want = np.asarray(jax.random.uniform(_jkey(key), shape, jnp.float32, minval, maxval))
    got = R.uniform(key, shape, minval, maxval, device="cpu").numpy()
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    n = shape[0]
    win = R.uniform(key, shape, minval, maxval, offset=(n // 2,) + (0,) * (len(shape) - 1),
                    block=(n - n // 2, *shape[1:]), device="cpu").numpy()
    assert np.array_equal(win, want[n // 2:])


def test_normal_within_four_ulp_of_jax():
    key = R.PRNGKey(0)
    n = 2**20
    want = np.asarray(jax.random.normal(_jkey(key), (n,), jnp.float32))
    got = R.normal(key, (n,), device="cpu").numpy()
    d = np.abs(_ordered(got) - _ordered(want))
    print(f"normal vs jax.random.normal over {n} draws: max {d.max()} ulp, "
          f"{int((d > 0).sum())} not exact")
    assert d.max() <= NORMAL_ULPS
    assert np.isfinite(got).all()


def test_normal_fill_scales_and_casts_as_jax():
    key = R.PRNGKey(21)
    shape, scale = (6, 40), 1.0 / np.sqrt(40)
    want = np.asarray((jax.random.normal(_jkey(key), shape, jnp.float32) * scale)
                      .astype(jnp.bfloat16))
    out = torch.empty(shape, dtype=torch.bfloat16)
    R.normal_(out, key, shape, scale=scale)
    diff = out.view(torch.int16).numpy() != want.view(np.int16)
    assert diff.sum() <= 2
    f32 = torch.empty(shape)
    R.normal_(f32, key, shape, scale=scale)
    assert _ulps(f32.numpy(), np.asarray(jax.random.normal(_jkey(key), shape, jnp.float32)
                                         * scale)) <= NORMAL_ULPS


def test_draws_refuse_generators_and_bad_keys():
    with pytest.raises(TypeError, match="PRNGKey"):
        R.normal(torch.Generator().manual_seed(0), (3,), device="cpu")
    with pytest.raises(TypeError):
        R.bits(torch.zeros(3, dtype=torch.int64), (3,), device="cpu")
    with pytest.raises(TypeError):
        R.bits(torch.zeros(2), (3,), device="cpu")


def test_kernel_kind_codes_and_dtypes():
    assert prng_kernel.kernel_kind("bits", torch.int64) == 0
    assert prng_kernel.kernel_kind("uniform", torch.float32) == 1
    assert prng_kernel.kernel_kind("normal", torch.float32) == 2
    assert prng_kernel.kernel_kind("normal", torch.bfloat16) == 3
    with pytest.raises(TypeError):
        prng_kernel.kernel_kind("bits", torch.int32)
    with pytest.raises(TypeError):
        prng_kernel.kernel_kind("uniform", torch.bfloat16)


def test_cuda_wrapper_refuses_cpu_tensors():
    with pytest.raises(ValueError, match="CUDA"):
        prng_kernel.draw_cuda(torch.empty(4), 0, 0, (4,), (0,), "normal")


def test_entry_points_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is valid")
    with pytest.raises(RuntimeError, match="CUDA"):
        R.normal(R.PRNGKey(0), (3,))


# ----------------------------------------------------------------------
# init_params against the JAX package's
# ----------------------------------------------------------------------
def _compare_params(cfg, jcfg):
    """Per-leaf comparison of the two packages' init_params(PRNGKey(0))."""
    got = tree_leaves(init_params(cfg, R.PRNGKey(0), device="cpu"))
    want = jax.tree.leaves(jax_init_params(jcfg, jax.random.PRNGKey(0)))
    specs = tree_leaves(param_specs(cfg))
    assert len(got) == len(want) == len(specs)
    return list(zip(specs, got, want))


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_f32_matches_jax(arch):
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="float32")
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="float32")
    worst = 0
    for spec, g, w in _compare_params(cfg, jcfg):
        w = np.asarray(w)
        assert tuple(g.shape) == w.shape and g.dtype == torch.float32
        if spec.init in ("zeros", "ones"):
            assert np.array_equal(g.numpy(), w)
        elif spec.init == "ssm_a":
            assert _ulps(g.numpy(), w) <= 1
        else:
            worst = max(worst, _ulps(g.numpy(), w))
    print(f"{arch}: normal leaves within {worst} f32 ulp of the JAX package's")
    assert worst <= NORMAL_ULPS


@pytest.mark.parametrize("arch", ARCHS)
def test_init_params_bf16_matches_jax(arch):
    cfg = dataclasses.replace(configs.get_smoke(arch), dtype="bfloat16")
    jcfg = dataclasses.replace(jconfigs.get_smoke(arch), dtype="bfloat16")
    n_diff = n_all = 0
    for spec, g, w in _compare_params(cfg, jcfg):
        assert g.dtype == torch.bfloat16
        a = g.view(torch.int16).numpy().astype(np.int64)
        b = np.asarray(w).view(np.int16).astype(np.int64)
        diff = a != b
        if spec.init in ("zeros", "ones"):
            assert not diff.any()
        # one bf16 ulp: the same sign, neighbouring bit patterns
        assert (np.abs(a[diff] - b[diff]) == 1).all()
        n_diff += int(diff.sum())
        n_all += diff.size
    print(f"{arch}: {n_diff} of {n_all} bf16 parameters one ulp off the JAX package's")
    assert n_diff <= max(3, n_all // 100_000)


def test_init_launches_counts_the_draws(monkeypatch):
    """One draw a normal leaf, one a period slice of a stacked leaf: what
    the card's launch counter must show after an init."""
    cfg = configs.get_smoke("jamba-v0.1-52b")
    calls = []

    def counting(draws, *a, **kw):
        calls.extend(draws)
        return ref.draw_many_ref(draws, *a, **kw)

    monkeypatch.setattr(prng_ops, "draw_many_ref", counting)
    init_params(cfg, R.PRNGKey(0), device="cpu")
    assert len(calls) == init_launches(cfg) > len(tree_leaves(param_specs(cfg)))


def test_draws_together_equal_draws_alone(monkeypatch):
    """Draws taken together in one pass, or split across passes, hold the
    values each has drawn alone."""
    keys = R.split(R.PRNGKey(6), 3)
    wins = [((9, 33), (2, 1), (5, 30)), ((1000,), (17,), (700,)), ((4, 6, 8), (1, 0, 0), (3, 6, 8))]
    alone = [R.normal(k, s, offset=o, block=b, device="cpu") * ref.f32(0.5)
             for k, (s, o, b) in zip(keys, wins)]
    for chunk in (ref.CHUNK, 128):
        monkeypatch.setattr(ref, "CHUNK", chunk)
        outs = [torch.empty(b) for _, _, b in wins]
        R.normal_many([(out, k, s, o, 0.5) for out, k, (s, o, _) in zip(outs, keys, wins)])
        assert all(torch.equal(a, b) for a, b in zip(alone, outs))


def test_init_params_refuses_a_generator():
    cfg = configs.get_smoke("smollm-135m")
    with pytest.raises(TypeError, match="PRNGKey"):
        init_params(cfg, torch.Generator().manual_seed(0), device="cpu")


def test_init_params_stacked_slices_equal_whole_draws():
    """A period-stacked leaf, drawn slice by slice, holds the whole leaf's
    draw: the normal of the leaf's key over its global shape."""
    cfg = configs.get_smoke("jamba-v0.1-52b")
    params = init_params(cfg, R.PRNGKey(0), device="cpu")
    specs = tree_leaves(param_specs(cfg))
    keys = R.split(R.PRNGKey(0), len(specs))
    for i, (spec, leaf) in enumerate(zip(specs, tree_leaves(params))):
        if spec.init in ("normal", "embed") and len(spec.shape) >= 3:
            want = R.normal(keys[i], spec.shape, device="cpu") * ref.f32(init_scale(spec))
            assert torch.equal(leaf, want.to(leaf.dtype))


# ----------------------------------------------------------------------
# the sharded draw
# ----------------------------------------------------------------------
def _sharded_script() -> str:
    return r"""
import json, sys
import torch
from torch.distributed.tensor import DTensor
from torch.distributed.tensor._utils import compute_local_shape_and_global_offset
from repro_torch import configs, random as R
from repro_torch.distributed import MeshRules
from repro_torch.launch.dryrun import fake_group
from repro_torch.launch.mesh import make_test_mesh
from repro_torch.models import init_params, param_shardings
from repro_torch.tree import tree_leaves, tree_map

archs = json.loads(sys.argv[1])
whole = {a: init_params(configs.get_smoke(a), R.PRNGKey(0), device="cpu") for a in archs}
out = {a: {"leaves": 0, "sharded": 0, "equal": 0, "ranks": []} for a in archs}
for rank in range(8):
    with fake_group(8, rank=rank):
        mesh = make_test_mesh(2, 4, device_type="cpu")
        for a in archs:
            cfg = configs.get_smoke(a)
            sh = param_shardings(cfg, MeshRules(mesh))
            got = init_params(cfg, R.PRNGKey(0), device="cpu", shardings=sh)

            def check(g, w, s):
                shape, offset = compute_local_shape_and_global_offset(w.shape, s[0], list(s[1]))
                local = g.to_local()
                sl = tuple(slice(o, o + n) for o, n in zip(offset, shape))
                ok = (isinstance(g, DTensor) and tuple(g.shape) == tuple(w.shape)
                      and tuple(g.placements) == tuple(s[1])
                      and tuple(local.shape) == tuple(shape) and torch.equal(local, w[sl]))
                return 2 * ok + (local.numel() < w.numel())  # (equal, a part) as one leaf

            res = tree_leaves(tree_map(check, got, whole[a], sh))
            o = out[a]
            o["leaves"] += len(res)
            o["equal"] += sum(r >> 1 for r in res)
            o["sharded"] += sum(r & 1 for r in res)
            o["ranks"].append(rank)
print(json.dumps(out))
"""


@pytest.fixture(scope="module")
def sharded_draws():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    archs = ["smollm-135m", "qwen3-moe-30b-a3b", "jamba-v0.1-52b", "whisper-base"]
    out = subprocess.run([sys.executable, "-c", _sharded_script(), json.dumps(archs)],
                         capture_output=True, text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("arch", ["smollm-135m", "qwen3-moe-30b-a3b", "jamba-v0.1-52b",
                                  "whisper-base"])
def test_sharded_draw_is_the_unsharded_slice_at_every_rank(sharded_draws, arch):
    got = sharded_draws[arch]
    assert got["ranks"] == list(range(8))
    assert got["equal"] == got["leaves"] > 0
    assert got["sharded"] > 0  # some leaves are split over the 2x4 mesh


KIMI = r"""
import json
import torch
from torch.utils._python_dispatch import TorchDispatchMode
from repro_torch import configs, random as R
from repro_torch.distributed import MeshRules
from repro_torch.kernels.prng import ref
from repro_torch.launch.dryrun import fake_group
from repro_torch.launch.mesh import make_production_mesh
from repro_torch.models import init_params, param_shardings
from repro_torch.tree import tree_leaves


class Allocations(TorchDispatchMode):
    # the largest tensor any op makes
    def __init__(self):
        super().__init__()
        self.largest = 0
        self.n = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        for t in (out if isinstance(out, (tuple, list)) else [out]):
            if isinstance(t, torch.Tensor):
                self.largest = max(self.largest, t.numel())
                self.n += 1
        return out


cfg = configs.get("kimi-k2-1t-a32b")
with fake_group(256):
    mesh = make_production_mesh(device_type="cpu")
    sh = param_shardings(cfg, MeshRules(mesh))
    rec = Allocations()
    with rec:
        params = init_params(cfg, R.PRNGKey(0), device="meta", shardings=sh)
    local = [p.to_local() for p in tree_leaves(params)]
    print(json.dumps({
        "largest_alloc": rec.largest, "ops": rec.n, "chunk": ref.CHUNK,
        "largest_leaf": max(t.numel() for t in local),
        "bytes": sum(t.numel() * t.element_size() for t in local),
        "meta": all(t.is_meta for t in local),
        "whole_bytes": cfg.param_count() * 2,
    }))
"""


def test_kimi_rank0_draws_only_its_shard():
    env = dict(os.environ, PYTHONPATH=SRC, OMP_NUM_THREADS="1")
    out = subprocess.run([sys.executable, "-c", KIMI], capture_output=True, text=True, env=env,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-3000:]
    got = json.loads(out.stdout.strip().splitlines()[-1])
    print(got)
    assert got["meta"]
    assert got["largest_alloc"] <= max(got["largest_leaf"], got["chunk"])
    assert got["largest_leaf"] == 1_343_225_856
    assert round(got["bytes"] / 1e9, 2) == 8.16
    assert got["whole_bytes"] > 2e12
