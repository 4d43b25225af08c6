"""The port's twins of the JAX package's examples (``repro_torch.examples``)
on the CPU, against the JAX package.

- quickstart: every printed line equals ``examples/quickstart.py``'s but
  the executor's route line, and the solve line up to its time.
- rtl_codegen: the single CMVM's combinational and pipelined modules are
  the JAX package's text, and the file ``--out`` names (by default in the
  temporary directory) holds the pipelined one; on the JAX package's
  ``PRNGKey(0)`` muon-tracker parameters carried across, the design's
  per-layer report (all columns but the solve time) and the ``dense0``
  Verilog equal the JAX compile's; and with no weights crossed the
  twin's own ``PRNGKey(0)`` draw gives the JAX example's report and
  ``dense0`` text.
- serve_lm: a short run serves four requests of 8/12/16/20 tokens; on a
  3-step JAX-trained parameter tree carried across, the port's engine
  gives the JAX engine's greedy tokens exactly (f32), and the first
  training step's loss is within 1e-5 of the JAX step's.
- train_jet_tagger: the twin's class centres and batches (the JAX
  example's lines, reproduced here) from the same keys: labels equal,
  features within 4 float32 ulp of the larger of the feature and its
  class centre (the normals are within 4 ulp; a feature near 0 is the
  difference of two larger numbers); the first step's NLL within 1e-5 of
  the example's jitted ``step`` on the port's own ``PRNGKey(0)`` weights.
- train_lm_resumable: a short run survives its failure, resumes at the
  end of phase 1 and runs on; its parameters at the end of phase 1 equal
  an uninterrupted run's bit for bit.  It takes no ``--ckpt-dir`` that
  exists already, since it removes its checkpoint directory at the end.
"""

import re
import runpy
import tempfile
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import configs as jax_configs
from repro.configs.base import RunConfig as JaxRunConfig
from repro.core import emit_verilog as jax_emit_verilog
from repro.core import solve_cmvm as jax_solve_cmvm
from repro.core.fixed_point import QInterval as JaxQInterval
from repro.data.pipeline import DataConfig as JaxDataConfig
from repro.data.pipeline import Pipeline as JaxPipeline
from repro.flow import CompileConfig as JaxCompileConfig
from repro.flow import SolverConfig as JaxSolverConfig
from repro.models import init_params as jax_init_params
from repro.nn import compile_model as jax_compile_model
from repro.nn import init_params as jax_nn_init_params
from repro.nn import models as jax_nn_models
from repro.serve.engine import Engine as JaxEngine
from repro.serve.engine import Request as JaxRequest
from repro.train.train_lib import make_train_step as jax_make_train_step
from repro_torch import random as R
from repro_torch.examples import (quickstart, rtl_codegen, serve_lm, train_jet_tagger,
                                  train_lm_resumable)
from repro_torch.models import params_from_numpy
from repro_torch.nn import init_params as nn_init_params
from repro_torch.nn import models as nn_models
from repro_torch.nn import params_from_numpy as nn_params_from_numpy
from repro_torch.train import Trainer
from repro_torch.tree import tree_leaves

ROOT = Path(__file__).resolve().parent.parent
SOLVED_IN = re.compile(r", solved in [0-9.]+ ms$")


# ----------------------------------------------------------------------
# quickstart
# ----------------------------------------------------------------------
def test_quickstart_prints_the_jax_example_lines(capsys):
    runpy.run_path(str(ROOT / "examples" / "quickstart.py"), run_name="__main__")
    want = capsys.readouterr().out.splitlines()
    out = quickstart.main(["--device", "cpu"])
    got = capsys.readouterr().out.splitlines()
    assert len(got) == len(want)
    route = [i for i, line in enumerate(want) if "adder-graph kernel" in line]
    assert route == [3] and got[3] == "plain PyTorch version on cpu: OK"
    assert [SOLVED_IN.sub("", line) for i, line in enumerate(got) if i != 3] == \
        [SOLVED_IN.sub("", line) for i, line in enumerate(want) if i != 3]
    assert SOLVED_IN.search(got[1])
    assert (out["baseline_adders"], out["adders"], out["depth"], out["cost_bits"],
            out["n_stages"], out["ff_bits"], out["verilog_lines"]) == \
        (882, 366, 8, 5211, 2, 551, 882)
    assert out["route"] == "plain PyTorch version"


# ----------------------------------------------------------------------
# rtl_codegen
# ----------------------------------------------------------------------
def test_rtl_codegen_single_cmvm_is_the_jax_text(tmp_path, capsys):
    out_file = tmp_path / "cmvm_piped.v"
    out = rtl_codegen.main(["--device", "cpu", "--out", str(out_file)])
    m = np.random.default_rng(3).integers(-32, 32, size=(8, 6))
    sol = jax_solve_cmvm(m, qint_in=[JaxQInterval.from_fixed(True, 8, 8)] * 8,
                         config=JaxSolverConfig(dc=2))
    assert out["comb"] == jax_emit_verilog(sol.program, "cmvm_comb", max_delay_per_stage=None)
    assert out["piped"] == jax_emit_verilog(sol.program, "cmvm_piped", max_delay_per_stage=3)
    assert out_file.read_text() == out["piped"]
    assert out["n_stages"] == 2
    text = capsys.readouterr().out
    assert f"wrote {out_file}" in text and "TOTAL" in text and "module dense0 (" in text


def test_rtl_codegen_default_out_is_in_the_temporary_directory(tmp_path, monkeypatch):
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    out = rtl_codegen.main(["--device", "cpu"])
    assert out["out"] == str(tmp_path / "cmvm_piped.v")
    assert (tmp_path / "cmvm_piped.v").read_text() == out["piped"]


@pytest.fixture(scope="module")
def jax_tracker():
    """The JAX example's muon tracker: its ``PRNGKey(0)`` parameters, the
    DA design and the first dense layer's Verilog."""
    model, in_shape, in_quant = jax_nn_models.muon_tracker(d_in=32)
    jparams, _ = jax_nn_init_params(jax.random.PRNGKey(0), model, in_shape)
    design = jax_compile_model(
        model, jparams, in_shape, in_quant,
        config=JaxCompileConfig(strategy="da", solver=JaxSolverConfig(dc=2)))
    first = jax_solve_cmvm(
        np.round(np.asarray(jparams[0]["w"]) / model[0].w_quant.step).astype(np.int64),
        qint_in=[in_quant.qint] * in_shape[0], config=JaxSolverConfig(dc=2))
    return jparams, design, jax_emit_verilog(first.program, "dense0")


_REPORT_COLS = ("name", "shape", "adders", "cost_bits", "depth", "stages", "ff_bits")


def test_rtl_codegen_tracker_report_equals_the_jax_compile(jax_tracker, capsys):
    jparams, want, dense0 = jax_tracker
    params = nn_params_from_numpy(jax.tree.map(np.asarray, jparams), device="cpu")
    got = rtl_codegen.tracker_report(params, "cpu")
    cols = _REPORT_COLS
    assert [[getattr(r, c) for c in cols] for r in got["design"].reports] == \
        [[getattr(r, c) for c in cols] for r in want.reports]
    # the summary's TOTAL line (no time column) is the JAX package's
    assert got["summary"].splitlines()[-1] == want.summary().splitlines()[-1]
    assert want.summary().splitlines()[-1].split()[1:] == ["4185", "37397", "9", "9", "3783"]
    assert got["dense0"] == dense0
    assert "\n".join(got["dense0"].splitlines()[:5]) in capsys.readouterr().out


def test_rtl_codegen_draws_the_jax_examples_tracker(jax_tracker, tmp_path):
    """No weights crossed: the twin's ``init_params(PRNGKey(0), ...)``
    gives the JAX example's design and ``dense0`` Verilog text."""
    _, want, dense0 = jax_tracker
    out = rtl_codegen.main(["--device", "cpu", "--out", str(tmp_path / "piped.v")])
    assert out["dense0"] == dense0
    assert out["summary"].splitlines()[-1] == want.summary().splitlines()[-1]
    assert (out["total_adders"], out["total_cost_bits"], out["max_depth"]) == \
        (want.total_adders, want.total_cost_bits, want.max_depth)


# ----------------------------------------------------------------------
# serve_lm
# ----------------------------------------------------------------------
def test_serve_lm_short_run_serves_four_requests(capsys):
    out = serve_lm.main(["--train-steps", "3", "--device", "cpu"])
    assert [len(t) for t in out["tokens_out"]] == [8, 12, 16, 20]
    assert len(out["losses"]) == 3 and all(np.isfinite(out["losses"]))
    assert out["tokens"] == 56 and out["tokens_per_s"] > 0
    text = capsys.readouterr().out
    assert "serving smollm-135m-smoke: 623,744 params" in text
    assert "served 4 requests, 56 tokens" in text


@pytest.fixture(scope="module")
def jax_trained():
    """(JAX cfg, the JAX initial params, the first step's loss, the params
    after 3 JAX steps) of the example's smoke model and data."""
    jcfg = jax_configs.get_smoke("smollm-135m", d_model=128, n_layers=4, d_ff=256)
    jp0 = jax_init_params(jcfg, jax.random.PRNGKey(0))
    pipe = JaxPipeline(JaxDataConfig(vocab_size=jcfg.vocab_size, seq_len=64, global_batch=16,
                                     seed=7))
    step_fn, opt_init = jax_make_train_step(jcfg, JaxRunConfig(learning_rate=3e-3,
                                                               warmup_steps=10))
    jit_step = jax.jit(step_fn)
    params, opt, losses = jp0, opt_init(jp0), []
    for s in range(3):
        batch = {k: jnp.asarray(v) for k, v in pipe.batch_at(s).items()}
        params, opt, m = jit_step(params, opt, batch, s)
        losses.append(float(m["loss"]))
    return jcfg, jax.tree.map(np.asarray, jp0), losses[0], params


def _example_parts():
    cfg = serve_lm.config("smollm-135m")
    return cfg, serve_lm.data(cfg)


def test_serve_lm_first_step_loss_equals_jax(jax_trained, capsys):
    _, jp0, jax_loss, _ = jax_trained
    cfg, pipe = _example_parts()
    _, losses = serve_lm.train(cfg, params_from_numpy(cfg, jp0, device="cpu"), pipe, "cpu", 1)
    assert abs(losses[0] - jax_loss) <= 1e-5
    assert "warmup-train step 0" in capsys.readouterr().out


def test_serve_lm_serves_the_jax_engine_tokens(jax_trained):
    jcfg, _, _, jparams = jax_trained
    cfg, pipe = _example_parts()
    prompts = [pipe.batch_at(1000 + i)["tokens"][0, :16] for i in range(4)]
    want = JaxEngine(jcfg, jparams, batch_size=4, max_seq=96, eos_id=-1, sample="greedy").generate(
        [JaxRequest(np.asarray(p, np.int32), max_new_tokens=8 + 4 * i)
         for i, p in enumerate(prompts)])
    got = serve_lm.serve(cfg, params_from_numpy(cfg, jax.tree.map(np.asarray, jparams),
                                                device="cpu"), pipe, "cpu")
    assert [r.out_tokens for r in got["requests"]] == [r.out_tokens for r in want]
    assert [len(r.out_tokens) for r in want] == [8, 12, 16, 20]


# ----------------------------------------------------------------------
# train_lm_resumable
# ----------------------------------------------------------------------
@pytest.fixture
def one_thread():
    """CPU ``index_put_(accumulate=True)`` (the embedding's backward) sums
    in another order from run to run with several threads: bit-for-bit
    comparisons of training runs take one."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def test_train_lm_resumable_resumes_bit_for_bit(tmp_path, capsys, one_thread):
    ckpt = tmp_path / "ckpt"
    out = train_lm_resumable.main([
        "--steps", "6", "--fail-at", "4", "--resume-steps", "3", "--checkpoint-every", "2",
        "--device", "cpu", "--ckpt-dir", str(ckpt)])
    assert (out["failures_survived"], out["phase1_step"], out["resumed_at"],
            out["phase2_step"]) == (1, 6, 6, 9)
    assert not ckpt.exists()
    text = capsys.readouterr().out
    assert "phase 1 done at step 6" in text and "phase 2 (restart) done at step 9" in text

    cfg, run_cfg, pipe, init_fn, step_fn, opt_init = train_lm_resumable.setup(
        torch.device("cpu"), str(tmp_path / "ref"), checkpoint_every=2)
    ref = Trainer.resume_or_init(cfg, run_cfg, pipe, init_fn, step_fn, opt_init, device="cpu")
    ref.run(6)
    want, got = tree_leaves(ref.params), tree_leaves(out["phase1_params"])
    assert len(want) == len(got)
    assert all(torch.equal(a, b) for a, b in zip(want, got))


def test_train_lm_resumable_refuses_an_existing_ckpt_dir(tmp_path, capsys):
    kept = tmp_path / "runs" / "step_50" / "params.pt"
    kept.parent.mkdir(parents=True)
    kept.write_bytes(b"earlier run")
    with pytest.raises(SystemExit):
        train_lm_resumable.main(["--device", "cpu", "--ckpt-dir", str(tmp_path / "runs")])
    assert kept.read_bytes() == b"earlier run"
    assert "already exists" in capsys.readouterr().err


# ----------------------------------------------------------------------
# train_jet_tagger
# ----------------------------------------------------------------------
JET_ULPS = 4


@pytest.fixture
def jax_32_bit():
    """JAX in its default 32-bit mode, the example's (int32 ``randint``):
    other test modules turn x64 on for the whole process when they are
    imported."""
    with jax.enable_x64(False):
        yield


@pytest.fixture(scope="module")
def jax_jet():
    """The lines of ``examples/train_jet_tagger.py`` up to its first step,
    as it writes them (in JAX's default 32-bit mode): the model,
    ``init_params`` of ``PRNGKey(0)``, the class centres of ``PRNGKey(1)``,
    ``make_batch`` and the jitted ``step``."""
    with jax.enable_x64(False):
        return _jax_jet_example()


def _jax_jet_example():
    from repro.nn import apply_model as jax_apply_model

    model, in_shape, in_quant = jax_nn_models.jet_tagger(w_bits=6, a_bits=8)
    key = jax.random.PRNGKey(0)
    params, _ = jax_nn_init_params(key, model, in_shape)
    kd, kw = jax.random.split(jax.random.PRNGKey(1))
    centers = jax.random.normal(kw, (5, 16)) * 2.0

    def make_batch(k, n=512):
        ky, kx = jax.random.split(k)
        y = jax.random.randint(ky, (n,), 0, 5)
        x = centers[y] + jax.random.normal(kx, (n, 16))
        return x, y

    @jax.jit
    def step(params, k, lr):
        x, y = make_batch(k)

        def loss_fn(p):
            logits, bits = jax_apply_model(p, model, x, in_quant=in_quant, collect_bits=True)
            lp = jax.nn.log_softmax(logits)
            nll = -jnp.take_along_axis(lp, y[:, None], axis=-1).mean()
            return nll + 1e-5 * bits, nll

        (loss, nll), g = jax.value_and_grad(loss_fn, has_aux=True)(params)
        params = jax.tree.map(lambda p, gg: p - lr * gg, params, g)
        return params, nll

    key, sub = jax.random.split(key)
    return {"params": params, "centers": np.asarray(centers), "make_batch": make_batch,
            "step": step, "sub": sub}


def _ordered(a) -> np.ndarray:
    i = np.asarray(a, np.float32).view(np.int32).astype(np.int64)
    return np.where(i < 0, -(i & 0x7FFFFFFF), i)


def test_train_jet_tagger_batches_are_the_jax_examples(jax_jet, jax_32_bit):
    centres = train_jet_tagger.class_centres("cpu")
    assert np.abs(_ordered(centres.numpy()) - _ordered(jax_jet["centers"])).max() <= JET_ULPS
    _, sub = R.split(R.PRNGKey(0))
    for tkey, jkey, n in ((sub, jax_jet["sub"], 512), (R.PRNGKey(99), jax.random.PRNGKey(99), 2048)):
        x, y = jax_jet["make_batch"](jkey, n)
        x, y = np.asarray(x), np.asarray(y)
        tx, ty = train_jet_tagger.make_batch(centres, tkey, n)
        np.testing.assert_array_equal(ty.numpy(), y)
        assert tx.shape == (n, 16)
        scale = np.spacing(np.maximum(np.abs(x), np.abs(jax_jet["centers"][y]))).astype(np.float64)
        assert (np.abs(tx.numpy().astype(np.float64) - x) <= JET_ULPS * scale).all()


def test_train_jet_tagger_first_step_nll_is_the_jax_examples(jax_jet, jax_32_bit):
    model, in_shape, in_quant = nn_models.jet_tagger(w_bits=6, a_bits=8)
    params, _ = nn_init_params(R.PRNGKey(0), model, in_shape, device="cpu")
    for leaf in tree_leaves(params):
        leaf.requires_grad_(True)
    _, sub = R.split(R.PRNGKey(0))
    nll = train_jet_tagger.sgd_step(params, model, in_quant,
                                    train_jet_tagger.class_centres("cpu"), sub, 0.02)
    _, want = jax_jet["step"](jax_jet["params"], jax_jet["sub"], 0.02)
    assert abs(float(nll) - float(want)) < 1e-5
