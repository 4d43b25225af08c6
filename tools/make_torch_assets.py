"""Write the committed assets that the PyTorch port is held against.

The JAX package compiles two of the paper's networks, with weights from
``init_params(jax.random.PRNGKey(0), ...)`` and ``CompileConfig(jobs=1)``,
and saves each as a ``da4ml-design`` artifact under
``src/repro_torch/assets/<name>/``:

    mixer_full   mlp_mixer_jet(full_size=True): 64 particles x 16 features
    svhn_cnn     svhn_cnn(): conv / maxpool / avgpool

Beside each artifact, ``golden.npz`` holds ``x``, 1024 inputs drawn with
``np.random.default_rng(0)`` over the full input grid (stored in the
smallest integer type that holds the grid), and ``y``, the JAX
``forward_int`` of ``x`` as int32, checked equal to the numpy
interpreter before it is written.

Run from the repository root:

    PYTHONPATH=src JAX_PLATFORMS=cpu python tools/make_torch_assets.py
"""

from __future__ import annotations

import shutil
import sys
import time
from pathlib import Path

import jax
import numpy as np

from repro.flow import CompileConfig
from repro.nn import compile_model, init_params, models, numpy_forward_fn
from repro.runtime import save_design

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
    np.savez_compressed(out / "golden.npz", x=x, y=y)
    size = sum(f.stat().st_size for f in out.iterdir())
    print(f"{name}: wrote {out} ({size} bytes)")


if __name__ == "__main__":
    for name in sys.argv[1:] or NETWORKS:
        make(name)
