"""What the CUDA-graph serving path rests on, checked on the CPU:

* launch counting across a capture: inside ``_build.tally()`` a
  wrapper's launch is tallied, not counted, and each replay of a
  ``CapturedGraph`` adds the tally to the counters (the graph itself is
  a stub here: capturing needs a card);
* ``prefill(..., cache=)`` writes a static cache in place, zeroing what
  an earlier step left there, and gives exactly what a fresh cache gives
  (dense and SSM families);
* the SSM blocks' f32 leaves cast once (``f32_leaves``) give exactly the
  logits of the per-step casts, in bf16 and f32;
* on the CPU the engine captures nothing.

Tolerance: exact equality throughout (the same arithmetic)."""

import dataclasses
import threading

import numpy as np
import pytest
import torch

from repro_torch import configs
from repro_torch.kernels import _build
from repro_torch.kernels.adder_graph import kernel as ag_kernel
from repro_torch.kernels.flash_attention import kernel as fa_kernel
from repro_torch.kernels.graphs import CapturedGraph
from repro_torch.models import decode_step, init_cache, init_params, prefill
from repro_torch.models.ssm import F32_LEAVES, f32_leaves
from repro_torch.models.transformer import tree_map
from repro_torch.serve import Engine, Request


def test_a_tallied_launch_is_not_counted():
    counter = _build.LaunchCounter("test")
    counter.add()
    with _build.tally() as launches:
        counter.add()
        counter.add(2)
    assert counter.value == 1 and launches == {counter: 3}
    counter.add()
    assert counter.value == 2
    with pytest.raises(RuntimeError, match="already"), _build.tally(), _build.tally():
        pass


def test_tally_is_per_thread():
    """A capture on one thread leaves another thread's launches counted."""
    counter = _build.LaunchCounter("test")
    started, done = threading.Event(), threading.Event()

    def other():
        started.wait(10)
        for _ in range(5):
            counter.add()
        done.set()

    t = threading.Thread(target=other)
    t.start()
    with _build.tally() as launches:
        counter.add()
        started.set()
        assert done.wait(10)
    t.join(10)
    assert not t.is_alive()
    assert counter.value == 5 and launches == {counter: 1}


class _StubGraph:
    def __init__(self):
        self.n = 0

    def replay(self):
        self.n += 1


def test_replay_adds_the_captured_launches():
    with _build.tally() as launches:
        ag_kernel.launches.add()
        ag_kernel.launches.add()
        fa_kernel.launches.add()
    stub = _StubGraph()
    graph = CapturedGraph(stub, "out", launches)
    assert graph.launches_by_kernel() == {"adder_graph": 2, "flash_attention": 1}
    ag0, fa0 = ag_kernel.launches.value, fa_kernel.launches.value
    for _ in range(3):
        graph.replay()
    assert stub.n == 3
    assert ag_kernel.launches.value - ag0 == 6 and fa_kernel.launches.value - fa0 == 3


def _cfg(name):
    return configs.get_smoke(name)


@pytest.mark.parametrize("name", ["smollm-135m", "falcon-mamba-7b"])
def test_prefill_into_a_static_cache_equals_a_fresh_one(name):
    cfg = _cfg(name)
    params = init_params(cfg, torch.Generator().manual_seed(0), device="cpu")
    tokens = torch.from_numpy(
        np.random.default_rng(0).integers(2, cfg.vocab_size, size=(2, 7)).astype(np.int64))
    static = init_cache(cfg, 2, 16, device="cpu")
    # dirty it the way the engine's warm-up and capture do
    decode_step(cfg, params, torch.ones((2, 1), dtype=torch.int64), static)
    tree_map(lambda t: t.fill_(3) if t.is_floating_point() else t.fill_(5), static)
    logits, cache = prefill(cfg, params, {"tokens": tokens}, 16, cache=static)
    want_logits, want = prefill(cfg, params, {"tokens": tokens}, 16)
    assert cache is static
    torch.testing.assert_close(logits, want_logits, rtol=0, atol=0)
    for got_leaf, want_leaf in zip(_leaves(cache), _leaves(want)):
        torch.testing.assert_close(got_leaf, want_leaf, rtol=0, atol=0)
    nxt = logits.argmax(-1)[:, None]
    torch.testing.assert_close(decode_step(cfg, params, nxt, cache)[0],
                               decode_step(cfg, params, nxt, want)[0], rtol=0, atol=0)


def _leaves(tree):
    out = []
    tree_map(out.append, tree)
    return out


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_f32_leaves_cast_once_give_the_same_logits(dtype):
    cfg = dataclasses.replace(_cfg("falcon-mamba-7b"), dtype=dtype)
    params = init_params(cfg, torch.Generator().manual_seed(1), device="cpu")
    cast = dict(params, blocks=[dict(b, ssm=f32_leaves(b["ssm"])) for b in params["blocks"]])
    for k in F32_LEAVES:
        assert cast["blocks"][0]["ssm"][k].dtype == torch.float32
    assert cast["blocks"][0]["ssm"]["in_proj"].dtype == params["blocks"][0]["ssm"]["in_proj"].dtype
    tokens = torch.from_numpy(
        np.random.default_rng(1).integers(2, cfg.vocab_size, size=(2, 6)).astype(np.int64))
    la, ca = prefill(cfg, params, {"tokens": tokens}, 12)
    lb, cb = prefill(cfg, cast, {"tokens": tokens}, 12)
    torch.testing.assert_close(la, lb, rtol=0, atol=0)
    nxt = la.argmax(-1)[:, None]
    torch.testing.assert_close(decode_step(cfg, params, nxt, ca)[0],
                               decode_step(cfg, cast, nxt, cb)[0], rtol=0, atol=0)


@pytest.mark.parametrize("name", ["smollm-135m", "falcon-mamba-7b"])
def test_cpu_engine_captures_nothing_and_casts_once(name):
    cfg = dataclasses.replace(_cfg(name), dtype="bfloat16")
    params = init_params(cfg, torch.Generator().manual_seed(2), device="cpu")
    eng = Engine(cfg, params, 2, 16, device="cpu")
    assert eng.decode_graph is None
    if cfg.family == "ssm":  # the engine's copies are f32, the caller's stay bf16
        for k in F32_LEAVES:
            assert eng.params["blocks"][0]["ssm"][k].dtype == torch.float32
            assert params["blocks"][0]["ssm"][k].dtype == torch.bfloat16
    rng = np.random.default_rng(2)
    reqs = [Request(rng.integers(2, cfg.vocab_size, size=5).astype(np.int32), 4)
            for _ in range(2)]
    assert all(len(r.out_tokens) == 4 for r in eng.generate(reqs))
