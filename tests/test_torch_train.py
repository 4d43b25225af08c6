"""Training in the port on the CPU against the JAX package: ``loss_fn``
and its gradients for one smoke config of every family (dense, moe, ssm,
hybrid, encdec, vlm) against ``jax.value_and_grad`` of the reference;
one ``make_train_step`` step at microbatch 1 and 2 (the port of
``test_microbatch_equivalence``); remat ``full``, ``dots`` and ``none``
giving the same gradients; ``Pipeline.batch_at`` from both sources; the
Trainer's loss falling and its crash recovery resuming exactly (the
ports of ``tests/test_runtime.py``'s trainer tests); checkpoints across
the packages (a JAX-written f32 checkpoint restores in the port, and the
port's in JAX) and a bf16 tree round-tripping in the port; and the
launcher.

Weights cross from JAX with ``params_from_numpy``; inputs come from numpy
seeds.  Tolerances: the loss within 2e-6 relative, gradients within 1e-4
of the largest gradient element (f32 sums in another order, amplified
through the hybrid's 16 layers); one train step's parameters within
2e-5 (the JAX test's own bound between microbatch 1 and 2); remat, the
data batches, checkpoint round trips and the Trainer's resumed run are
bit for bit.
"""

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs.base import RunConfig as JaxRunConfig
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import Pipeline as JaxPipeline
from repro.models import init_params as jax_init_params
from repro.models import loss_fn as jax_loss_fn
from repro.optim import make_adamw as jax_adamw
from repro.train import checkpoint as jax_checkpoint
from repro.train.train_lib import make_train_step as jax_make_train_step
from repro_torch import configs
from repro_torch.configs.base import RunConfig
from repro_torch.data import DataConfig, Pipeline
from repro_torch.examples import train_jet_tagger
from repro_torch.launch import train as launch_train
from repro_torch.models import init_params, loss_fn, params_from_numpy
from repro_torch.random import PRNGKey
from repro_torch.optim import make_adamw
from repro_torch.train import Trainer, checkpoint, make_train_step
from repro_torch.tree import tree_leaves, tree_map

FAMILIES = {
    "dense": "smollm-135m",
    "moe": "qwen3-moe-30b-a3b",
    "ssm": "falcon-mamba-7b",
    "hybrid": "jamba-v0.1-52b",
    "encdec": "whisper-base",
    "vlm": "internvl2-26b",
}


def _batch(cfg, seed=0, b=2, s=16):
    rng = np.random.default_rng(seed)
    batch = {
        "tokens": rng.integers(0, cfg.vocab_size, (b, s)).astype(np.int32),
        "labels": rng.integers(-1, cfg.vocab_size, (b, s)).astype(np.int32),  # -1: masked
    }
    if cfg.family == "encdec":
        batch["enc_frames"] = rng.standard_normal((b, cfg.encoder_seq, cfg.d_model),
                                                  dtype=np.float32)
    if cfg.family == "vlm":
        batch["img_embeds"] = rng.standard_normal((b, cfg.vision_tokens, cfg.d_model),
                                                  dtype=np.float32)
    return batch


def _cross(arch):
    """(JAX cfg, port cfg, JAX params, the same params in the port on the CPU)."""
    jcfg, cfg = jax_configs.get_smoke(arch), configs.get_smoke(arch)
    jp = jax_init_params(jcfg, jax.random.PRNGKey(0))
    return jcfg, cfg, jp, params_from_numpy(cfg, jax.tree.map(np.asarray, jp), device="cpu")


def _port_grads(cfg, params, batch):
    leaves = tree_leaves(params)
    for p in leaves:
        p.requires_grad_(True)
    loss, parts = loss_fn(cfg, params, {k: torch.from_numpy(v) for k, v in batch.items()})
    grads = torch.autograd.grad(loss, leaves)
    for p in leaves:
        p.requires_grad_(False)
    return loss, parts, grads


@pytest.mark.parametrize("family", list(FAMILIES))
def test_loss_and_grads_match_jax(family):
    jcfg, cfg, jp, tp = _cross(FAMILIES[family])
    batch = _batch(cfg)
    (jl, jparts), jg = jax.jit(jax.value_and_grad(
        lambda p, b: jax_loss_fn(jcfg, p, b), has_aux=True))(
        jp, {k: jnp.asarray(v) for k, v in batch.items()})
    loss, parts, grads = _port_grads(cfg, tp, batch)
    assert set(parts) == {"nll", "aux"}
    np.testing.assert_allclose(float(loss.detach()), float(jl), rtol=2e-6)
    np.testing.assert_allclose(float(parts["nll"]), float(jparts["nll"]), rtol=2e-6)
    np.testing.assert_allclose(float(parts["aux"]), float(jparts["aux"]), rtol=2e-6, atol=1e-7)
    jleaves = jax.tree.leaves(jg)
    assert len(jleaves) == len(grads)
    bound = 1e-4 * max(float(np.abs(np.asarray(g)).max()) for g in jleaves)
    for want, got in zip(jleaves, grads):
        assert tuple(got.shape) == want.shape
        assert float(np.abs(got.numpy() - np.asarray(want)).max()) <= bound


@pytest.mark.parametrize("arch", ["smollm-135m", "falcon-mamba-7b", "qwen3-moe-30b-a3b"])
@pytest.mark.parametrize("remat", ["full", "dots"])
def test_remat_changes_no_gradient(arch, remat):
    """Remat changes memory, never a number: the gradients of "full" and
    "dots" equal those of "none" bit for bit."""
    _, cfg, _, tp = _cross(arch)
    batch = _batch(cfg, seed=3)
    _, _, want = _port_grads(dataclasses.replace(cfg, remat="none"), tp, batch)
    loss, _, got = _port_grads(dataclasses.replace(cfg, remat=remat), tp, batch)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.parametrize("mb", [1, 2])
def test_train_step_matches_jax(mb, tmp_path):
    """One step of the port's ``make_train_step`` against the JAX package's
    on the same weights and batch, at microbatch 1 and 2."""
    jcfg, cfg, jp, tp = _cross("smollm-135m")
    kw = dict(learning_rate=1e-3, warmup_steps=1, checkpoint_dir=str(tmp_path), microbatch=mb)
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4))
    batch = pipe.batch_at(0)
    j_step, j_init = jax_make_train_step(jcfg, JaxRunConfig(**kw))
    jp2, _, jm = jax.jit(j_step)(jp, j_init(jp), {k: jnp.asarray(v) for k, v in batch.items()}, 0)
    t_step, t_init = make_train_step(cfg, RunConfig(**kw), device="cpu")
    tp2, state, tm = t_step(tp, t_init(tp), {k: torch.from_numpy(v) for k, v in batch.items()}, 0)
    assert int(state.step) == 1
    np.testing.assert_allclose(float(tm["loss"]), float(jm["loss"]), rtol=1e-5)
    np.testing.assert_allclose(float(tm["grad_norm"]), float(jm["grad_norm"]), rtol=1e-5)
    assert float(tm["lr"]) == float(jm["lr"])
    for a, b in zip(jax.tree.leaves(jp2), tree_leaves(tp2)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0, atol=2e-5)


def test_microbatch_equivalence(tmp_path):
    """Gradient accumulation over 2 microbatches ~= one big batch (the port
    of the JAX test, with its tolerances)."""
    cfg = configs.get_smoke("smollm-135m")
    base = dict(learning_rate=1e-3, warmup_steps=1, checkpoint_dir=str(tmp_path))
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4))
    batch = {k: torch.from_numpy(v) for k, v in pipe.batch_at(0).items()}
    params = init_params(cfg, PRNGKey(0), device="cpu")
    out = []
    for mb in (1, 2):
        step, opt_init = make_train_step(cfg, RunConfig(microbatch=mb, **base), device="cpu")
        p = tree_map(torch.clone, params)
        out.append(step(p, opt_init(p), batch, 0))
    (p1, _, m1), (p2, _, m2) = out
    np.testing.assert_allclose(float(m1["loss"]), float(m2["loss"]), rtol=1e-5)
    for a, b in zip(tree_leaves(p1), tree_leaves(p2)):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=2e-5)


@pytest.mark.parametrize("shard,n_shards", [(0, 1), (1, 2)])
@pytest.mark.parametrize("source", ["synthetic", "corpus"])
def test_pipeline_batches_equal_jax(source, shard, n_shards, tmp_path):
    path = None
    if source == "corpus":
        path = str(tmp_path / "tokens.bin")
        corpus = np.random.default_rng(5).integers(0, 1000, 50_000).astype(np.int32)
        corpus.tofile(path)
    kw = dict(vocab_size=1000, seq_len=32, global_batch=8, seed=7, source=source,
              corpus_path=path)
    jpipe, tpipe = JaxPipeline(JaxDataConfig(**kw)), Pipeline(DataConfig(**kw))
    for step in (0, 1, 17):
        want, got = jpipe.batch_at(step, shard, n_shards), tpipe.batch_at(step, shard, n_shards)
        assert set(got) == {"tokens", "labels"}
        for k in want:
            assert got[k].dtype == want[k].dtype
            np.testing.assert_array_equal(got[k], want[k])


def _trainer_setup(ckpt_dir, ckpt_every=2):
    cfg = configs.get_smoke("smollm-135m")
    run_cfg = RunConfig(learning_rate=1e-3, warmup_steps=2, checkpoint_every=ckpt_every,
                        checkpoint_dir=str(ckpt_dir), microbatch=1)
    pipe = Pipeline(DataConfig(vocab_size=cfg.vocab_size, seq_len=16, global_batch=4, seed=0))
    step, opt_init = make_train_step(cfg, run_cfg, device="cpu")

    def init_fn():
        return init_params(cfg, PRNGKey(0), device="cpu")

    return cfg, run_cfg, pipe, init_fn, step, opt_init


def test_trainer_loss_decreases(tmp_path):
    cfg, run_cfg, pipe, init_fn, step, opt_init = _trainer_setup(tmp_path)
    t = Trainer.resume_or_init(cfg, run_cfg, pipe, init_fn, step, opt_init, device="cpu")
    first = t._one_step()
    losses = [t._one_step()["loss"] for _ in range(30)]
    assert losses[-1] < first["loss"]


def test_trainer_crash_recovery_resumes_exactly(tmp_path):
    """Crash at step 5; recovery resumes from the last (async) checkpoint
    and reaches the same parameters as an uninterrupted run, bit for bit."""
    cfg, run_cfg, pipe, init_fn, step, opt_init = _trainer_setup(tmp_path / "a")
    t_ref = Trainer.resume_or_init(cfg, run_cfg, pipe, init_fn, step, opt_init, device="cpu")
    for _ in range(8):
        t_ref._one_step()
    want = [x.clone() for x in tree_leaves(t_ref.params)]

    run_cfg2 = dataclasses.replace(run_cfg, checkpoint_dir=str(tmp_path / "b"))
    t = Trainer.resume_or_init(cfg, run_cfg2, pipe, init_fn, step, opt_init, device="cpu")
    boom = {"armed": True}

    def fail_hook(s):
        if s == 5 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated node failure")

    t.run(8, fail_hook=fail_hook)
    assert t.step == 8 and not boom["armed"]
    for a, b in zip(want, tree_leaves(t.params)):
        assert torch.equal(a, b)
    # a fresh Trainer resumes from the final checkpoint
    t2 = Trainer.resume_or_init(cfg, run_cfg2, pipe, init_fn, step, opt_init, device="cpu")
    assert t2.step == 8
    for a, b in zip(want, tree_leaves(t2.params)):
        assert torch.equal(a, b)


def test_jax_checkpoint_restores_in_the_port_and_back(tmp_path):
    """A JAX-written f32 checkpoint of (params, AdamW state) restores in
    the port leaf for leaf, and the port's restores in the JAX package."""
    jcfg, cfg, jp, tp = _cross("smollm-135m")
    j_init, _ = jax_adamw()
    jtree = {"p": jp, "o": j_init(jp)}
    jax_checkpoint.save(str(tmp_path / "jax"), 3, jtree)
    t_init, _ = make_adamw()
    like = {"p": init_params(cfg, PRNGKey(1), device="cpu")}
    like["o"] = t_init(like["p"])
    assert checkpoint.latest_step(str(tmp_path / "jax")) == 3
    got = checkpoint.restore(str(tmp_path / "jax"), 3, like)
    jleaves = jax.tree.leaves(jtree)
    assert len(jleaves) == len(tree_leaves(got))
    for a, b in zip(jleaves, tree_leaves(got)):
        assert b.numpy().dtype == np.asarray(a).dtype
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    checkpoint.save(str(tmp_path / "port"), 4, got)
    back = jax_checkpoint.restore(str(tmp_path / "port"), 4, jtree)
    for a, b in zip(jleaves, jax.tree.leaves(back)):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))


@pytest.mark.parametrize("async_", [False, True])
def test_bf16_tree_round_trips(async_, tmp_path):
    """bf16 leaves are written as the JAX package writes them (header
    descr '<V2') and read back bit for bit; so are int8 moments and the
    f32 master.  The async save copies every leaf before it returns."""
    cfg = dataclasses.replace(configs.get_smoke("smollm-135m"), dtype="bfloat16")
    params = init_params(cfg, PRNGKey(0), device="cpu")
    init, _ = make_adamw(state_dtype="int8")
    tree = {"p": params, "o": init(params)}
    want = [x.clone() for x in tree_leaves(tree)]
    thread = checkpoint.save(str(tmp_path), 1, tree, async_=async_)
    for x in tree_leaves(tree):  # the next step would update in place
        x.zero_()
    if thread is not None:
        thread.join()
    like = {"p": init_params(cfg, PRNGKey(2), device="cpu")}
    like["o"] = init(like["p"])
    got = checkpoint.restore(str(tmp_path), 1, like)
    for a, b in zip(want, tree_leaves(got)):
        assert a.dtype == b.dtype and torch.equal(a, b)
    # the header of a bf16 leaf is the one the JAX package writes for one
    i = next(i for i, x in enumerate(want) if x.dtype == torch.bfloat16)
    jax_checkpoint.save(str(tmp_path / "jax"), 0, [jnp.zeros(3, jnp.bfloat16)])
    headers = []
    for path in (tmp_path / "step_00000001" / f"leaf_{i:05d}.npy",
                 tmp_path / "jax" / "step_00000000" / "leaf_00000.npy"):
        with open(path, "rb") as f:
            np.lib.format.read_magic(f)
            headers.append(np.lib.format.read_array_header_1_0(f)[2])
    assert headers[0] == headers[1] and headers[0].kind == "V" and headers[0].itemsize == 2


def test_jax_bf16_checkpoint_restores_in_the_port(tmp_path):
    """The JAX package saves a bf16 leaf but cannot restore it (its
    ``restore`` casts the '<V2' array); the port restores it."""
    x = np.random.default_rng(0).standard_normal(4).astype(np.float32)
    jax_checkpoint.save(str(tmp_path), 0, {"a": jnp.asarray(x, jnp.bfloat16),
                                            "b": jnp.asarray(x[:2])})
    like = {"a": torch.zeros(4, dtype=torch.bfloat16), "b": torch.zeros(2)}
    got = checkpoint.restore(str(tmp_path), 0, like)
    assert torch.equal(got["a"], torch.from_numpy(x).to(torch.bfloat16))
    assert torch.equal(got["b"], torch.from_numpy(x[:2]))


def test_launcher_trains_on_the_cpu(tmp_path, capsys):
    metrics = launch_train.main(["--arch", "smollm-135m", "--smoke", "--device", "cpu",
                                 "--steps", "3", "--seq-len", "16", "--batch", "4",
                                 "--ckpt-dir", str(tmp_path), "--ckpt-every", "2"])
    assert set(metrics) == {"loss", "grad_norm", "lr"} and np.isfinite(metrics["loss"])
    assert checkpoint.latest_step(str(tmp_path)) == 3
    assert "resuming at step 0" in capsys.readouterr().out
    with pytest.raises(ValueError, match="mesh"):
        launch_train.main(["--smoke", "--device", "cpu", "--mesh", "single"])
    assert os.listdir(tmp_path)


def test_jet_tagger_example_on_the_cpu(capsys):
    """The paper's QAT workflow in the port: trained, compiled with both
    strategies, bit-exact to the float model and served (a short run)."""
    out = train_jet_tagger.main(["--device", "cpu", "--steps", "40"])
    assert out["requests"] == 2048 and set(out["adders"]) == {"latency", "da"}
    assert out["accuracy"] > 0.5 and out["hw_accuracy"] > 0.5
    assert "(bit-exact): OK" in capsys.readouterr().out


def test_restore_waits_for_the_async_save_in_flight(tmp_path, monkeypatch):
    """A crash while the latest async checkpoint is still being written:
    recovery waits for it and resumes from it, not from nothing."""
    import time as _time

    from repro_torch.train import checkpoint as ckpt_mod

    real_rename = ckpt_mod.os.rename

    def slow_rename(a, b):
        _time.sleep(0.5)
        real_rename(a, b)

    cfg, run_cfg, pipe, init_fn, step, opt_init = _trainer_setup(tmp_path / "a", ckpt_every=1)
    t_ref = Trainer.resume_or_init(cfg, run_cfg, pipe, init_fn, step, opt_init, device="cpu")
    for _ in range(3):
        t_ref._one_step()
    monkeypatch.setattr(ckpt_mod.os, "rename", slow_rename)
    run_cfg2 = dataclasses.replace(run_cfg, checkpoint_dir=str(tmp_path / "b"))
    t = Trainer.resume_or_init(cfg, run_cfg2, pipe, init_fn, step, opt_init, device="cpu")
    boom = {"armed": True}

    def fail_hook(s):
        if s == 1 and boom["armed"]:
            boom["armed"] = False
            raise RuntimeError("simulated node failure")

    t.run(3, fail_hook=fail_hook)
    assert t.step == 3 and not boom["armed"]
    for a, b in zip(tree_leaves(t_ref.params), tree_leaves(t.params)):
        assert torch.equal(a, b)
