"""Write the committed assets that the PyTorch port is held against.

The JAX package compiles two of the paper's networks, with weights from
``init_params(jax.random.PRNGKey(0), ...)`` and ``CompileConfig(jobs=1)``,
and saves each as a ``da4ml-design`` artifact under
``src/repro_torch/assets/<name>/``:

    mixer_full   mlp_mixer_jet(full_size=True): 64 particles x 16 features
    svhn_cnn     svhn_cnn(): conv / maxpool / avgpool

Beside each artifact, ``params.npz`` holds those float32 weights (keys
are ``"/"``-joined tree paths, ``"0/w"``, ``"4/body/0/b"``), from which
the port compiles the same design itself, and ``golden.npz`` holds
``x``, 1024 inputs drawn with
``np.random.default_rng(0)`` over the full input grid (stored in the
smallest integer type that holds the grid), and ``y``, the JAX
``forward_int`` of ``x`` as int32, checked equal to the numpy
interpreter before it is written.

It also writes two LM assets, each a reduced float32 config with
weights from ``init_params(cfg, PRNGKey(0))`` in ``weights.npz`` (keys
are ``"/"``-joined tree paths), and in ``golden.npz`` the JAX
``Engine``'s greedy serve of three prompts (``default_rng(0)``) padded to
a batch of 4: the prompts, each request's ``max_new_tokens`` and output
tokens, and the logits of prefill and of the first decode step.
``manifest.json`` holds the engine's settings, the number of decode
steps it ran and the smallest gap between the top two logits of any
greedy pick.

    smollm_smoke        configs.get_smoke("smollm-135m", n_heads=9, n_kv_heads=3)
    falcon_mamba_smoke  configs.get_smoke("falcon-mamba-7b"): 2 Mamba-1 layers,
                        d_model 64, d_inner 128, state 8

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_torch_assets.py [NAME ...]

``--params-only mixer_full svhn_cnn`` writes only ``params.npz``, after
checking that compiling those weights with the committed manifest's
``compile_config`` reproduces its ``arrays_sha256``; the committed
design, golden and manifest stay untouched.
"""

from __future__ import annotations

import json
import shutil
import sys
import tempfile
import time
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

from repro import configs
from repro.flow import CompileConfig
from repro.models import init_params as lm_init_params
from repro.nn import compile_model, init_params, models, numpy_forward_fn
from repro.runtime import save_design
from repro.serve.engine import Engine, Request

ASSETS = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "assets"
N_GOLDEN = 1024

NETWORKS = {
    "mixer_full": lambda: models.mlp_mixer_jet(full_size=True),
    "svhn_cnn": models.svhn_cnn,
}


def _grid_dtype(lo: int, hi: int) -> np.dtype:
    for dt in (np.int8, np.uint8, np.int16, np.uint16, np.int32):
        info = np.iinfo(dt)
        if info.min <= lo and hi <= info.max:
            return np.dtype(dt)
    raise ValueError(f"input grid [{lo}, {hi}] does not fit int32")


def make(name: str) -> None:
    model, in_shape, in_quant = NETWORKS[name]()
    params, _ = init_params(jax.random.PRNGKey(0), model, in_shape)
    t0 = time.perf_counter()
    design = compile_model(model, params, in_shape, in_quant, config=CompileConfig(jobs=1))
    print(f"{name}: compiled in {time.perf_counter() - t0:.1f} s, "
          f"{design.total_adders} adders, {len(design.tables)} tables")
    q = in_quant.qint
    rng = np.random.default_rng(0)
    x = rng.integers(q.lo, q.hi + 1, size=(N_GOLDEN, *in_shape)).astype(_grid_dtype(q.lo, q.hi))
    x32 = x.astype(np.int32)
    y = np.asarray(design.forward_int(x32), np.int32)
    np.testing.assert_array_equal(y, numpy_forward_fn(design)(x32))
    out = ASSETS / name
    if out.exists():
        shutil.rmtree(out)
    save_design(design, out)
    np.savez(out / "params.npz", **_flatten(jax.tree.map(np.asarray, params)))
    np.savez_compressed(out / "golden.npz", x=x, y=y)
    size = sum(f.stat().st_size for f in out.iterdir())
    print(f"{name}: wrote {out} ({size} bytes)")


def make_params(name: str) -> None:
    """Write ``params.npz`` beside a committed artifact, once the weights
    are shown to compile to that artifact's arrays."""
    model, in_shape, in_quant = NETWORKS[name]()
    params, _ = init_params(jax.random.PRNGKey(0), model, in_shape)
    out = ASSETS / name
    manifest = json.loads((out / "manifest.json").read_text())
    cfg = CompileConfig.from_dict(manifest["compile_config"])
    design = compile_model(model, params, in_shape, in_quant, config=cfg)
    tmp = Path(tempfile.mkdtemp())
    try:
        got = json.loads((save_design(design, tmp / name) / "manifest.json").read_text())
    finally:
        shutil.rmtree(tmp)
    if got["arrays_sha256"] != manifest["arrays_sha256"]:
        raise SystemExit(f"{name}: the weights do not compile to the committed design")
    np.savez(out / "params.npz", **_flatten(jax.tree.map(np.asarray, params)))
    print(f"{name}: wrote {out / 'params.npz'} ({(out / 'params.npz').stat().st_size} bytes)")


def _flatten(tree, prefix=""):
    if isinstance(tree, dict):
        items = tree.items()
    elif isinstance(tree, list | tuple):
        items = ((str(i), v) for i, v in enumerate(tree))
    else:
        return {prefix[:-1]: np.asarray(tree)}
    out = {}
    for k, v in items:
        out.update(_flatten(v, f"{prefix}{k}/"))
    return out


_SERVE = {"batch_size": 4, "max_seq": 32, "eos_id": 1, "prompt_len": 12,
          "max_new_tokens": [8, 5, 8]}
LMS = {
    "smollm_smoke": {"arch": "smollm-135m", "smoke_kwargs": {"n_heads": 9, "n_kv_heads": 3},
                     **_SERVE},
    "falcon_mamba_smoke": {"arch": "falcon-mamba-7b", "smoke_kwargs": {}, **_SERVE},
}


def make_lm_smoke(name: str) -> None:
    m = dict(LMS[name])
    cfg = configs.get_smoke(m["arch"], **m["smoke_kwargs"])
    params = lm_init_params(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(0)
    prompts = rng.integers(2, cfg.vocab_size, size=(len(m["max_new_tokens"]), m["prompt_len"]))
    prompts = prompts.astype(np.int32)
    eng = Engine(cfg, params, m["batch_size"], m["max_seq"], eos_id=m["eos_id"])
    picked, n_decode = [], [0]
    pick, decode = eng._pick, eng._decode

    def record_pick(logits):
        picked.append(np.asarray(logits, np.float32))
        return pick(logits)

    def count_decode(*a):
        n_decode[0] += 1
        return decode(*a)

    eng._pick, eng._decode = record_pick, count_decode
    reqs = [Request(p, n) for p, n in zip(prompts, m["max_new_tokens"])]
    eng.generate(reqs)
    width = max(m["max_new_tokens"])
    tokens = np.full((len(reqs), width), -1, np.int32)
    for i, r in enumerate(reqs):
        tokens[i, : len(r.out_tokens)] = r.out_tokens
    top2 = np.sort(np.concatenate(picked), axis=-1)[:, -2:]
    # prefill and the first decode step, called as the engine calls them
    padded = np.stack([r.prompt for r in reqs])
    logits0, cache = eng._prefill(params, {"tokens": jnp.asarray(padded)})
    logits1, _ = decode(params, jnp.argmax(logits0, axis=-1)[:, None], cache)
    np.testing.assert_array_equal(np.asarray(logits0, np.float32), picked[0])
    m.update(decode_steps=n_decode[0], min_top2_gap=float((top2[:, 1] - top2[:, 0]).min()),
             n_params=cfg.param_count())
    out = ASSETS / name
    if out.exists():
        shutil.rmtree(out)
    out.mkdir(parents=True)
    np.savez(out / "weights.npz", **_flatten(jax.tree.map(np.asarray, params)))
    np.savez_compressed(
        out / "golden.npz", prompts=prompts, max_new_tokens=np.asarray(m["max_new_tokens"]),
        tokens=tokens, prefill_logits=np.asarray(logits0, np.float32),
        decode_logits=np.asarray(logits1, np.float32),
    )
    (out / "manifest.json").write_text(json.dumps(m, indent=1) + "\n")
    size = sum(f.stat().st_size for f in out.iterdir())
    print(f"{name}: {n_decode[0]} decode steps, min top-2 gap {m['min_top2_gap']:.4f}; "
          f"wrote {out} ({size} bytes)")


if __name__ == "__main__":
    args = sys.argv[1:]
    if args[:1] == ["--params-only"]:
        for name in args[1:] or NETWORKS:
            make_params(name)
    else:
        for name in args or [*NETWORKS, *LMS]:
            (make_lm_smoke if name in LMS else make)(name)
