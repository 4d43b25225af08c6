"""SAME convolutions in the port's compile path (``repro_torch.nn``), on
the CPU:

* a VALID design is specified as before: the committed ``mixer_full`` and
  ``svhn_cnn`` compile from their ``params.npz`` to the committed step
  specs and ``arrays_sha256`` byte for byte (the JAX package wrote them),
  and a VALID conv spec has no ``pads``;
* the static checker (``analysis/steps.py``) passes a consistent SAME
  design and flags, as DA021, a SAME conv whose output grid disagrees
  with its pads;
* each conv span's ``unfold_cells`` and ``pad_cells`` equal a count of an
  unfold of ones;
* the committed ``svhn_cnn_32`` asset: its ``params.npz`` is the port's
  ``init_params(PRNGKey(0))`` draw, and compiles to the committed
  manifest (reports' wall times aside), whose design reproduces the
  committed golden outputs.

The comparison with the plain reference, the interpreter and the float
layers is ``dabench/tests/test_dabench_same_conv.py``.
"""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from repro_torch import nn as tnn
from repro_torch.analysis.steps import check_steps
from repro_torch.flow import CompileConfig
from repro_torch.nn.compiler import conv_cells
from repro_torch.random import PRNGKey
from repro_torch.runtime import load_design, save_design

ASSETS = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "assets"
MODELS = {
    "mixer_full": lambda: tnn.models.mlp_mixer_jet(full_size=True),
    "svhn_cnn": tnn.models.svhn_cnn,
    "svhn_cnn_32": tnn.models.svhn_cnn_32,
}


def _committed(name):
    """The model, input shape and grid, the committed manifest, and the
    committed weights as the port's parameters."""
    model, in_shape, in_quant = MODELS[name]()
    manifest = json.loads((ASSETS / name / "manifest.json").read_text())
    with np.load(ASSETS / name / "params.npz") as z:
        params = tnn.params_from_numpy(z, device="cpu", model=model)
    return model, in_shape, in_quant, manifest, params


def _recompile(name, tmp_path):
    """The committed weights compiled with the committed compile config,
    saved: the new manifest and the design loaded back."""
    model, in_shape, in_quant, committed, params = _committed(name)
    cfg = CompileConfig.from_dict({**committed["compile_config"], "jobs": None})
    design = tnn.compile_model(model, params, in_shape, in_quant, config=cfg, device="cpu")
    save_design(design, tmp_path / name)
    manifest = json.loads((tmp_path / name / "manifest.json").read_text())
    return committed, manifest, load_design(tmp_path / name, device="cpu", verify="strict")


@pytest.mark.parametrize("name", ["mixer_full", "svhn_cnn"])
def test_valid_designs_keep_their_specs_and_digest(name, tmp_path):
    committed, got, _ = _recompile(name, tmp_path)
    assert json.dumps(got["steps"]) == json.dumps(committed["steps"])
    assert got["arrays_sha256"] == committed["arrays_sha256"]
    convs = [s for s in got["steps"] if s["kind"] == "conv"]
    assert all("pads" not in s["params"] for s in convs) and len(convs) == 3 * (name == "svhn_cnn")


def _reports(manifest):
    return [{k: v for k, v in r.items() if k != "solver_time_s"} for r in manifest["reports"]]


def test_svhn_cnn_32_params_are_the_stated_draw():
    model, in_shape, _, _, params = _committed("svhn_cnn_32")
    drawn, _ = tnn.init_params(PRNGKey(0), model, in_shape, device="cpu")
    assert [sorted(p) for p in params] == [sorted(p) for p in drawn]
    for p, q in zip(params, drawn):
        for k in p:
            assert torch.equal(p[k], q[k])


def test_svhn_cnn_32_params_compile_to_the_committed_design(tmp_path):
    committed, got, design = _recompile("svhn_cnn_32", tmp_path)
    # the compile config as committed but for ``jobs``, which its digest leaves out
    for key in ("arrays_sha256", "steps", "resources", "in_shape", "in_quant", "out_shape",
                "compile_config_digest"):
        assert got[key] == committed[key], key
    assert _reports(got) == _reports(committed)
    assert [s["params"].get("pads") for s in got["steps"] if s["kind"] == "conv"] == [[1, 1, 1, 1]] * 3
    with np.load(ASSETS / "svhn_cnn_32" / "golden.npz") as g:
        x, y = g["x"].astype(np.int32), g["y"]
    np.testing.assert_array_equal(design.forward_int(torch.from_numpy(x)).numpy(), y)
    assert x.min() == 0 and x.max() == 255 and x.shape == (1024, 32, 32, 3)


def _small_same_design():
    model = (tnn.QConv2D(4, (3, 3), (2, 2), padding="SAME", w_quant=tnn.QuantConfig(6, 2)),
             tnn.ReLU(tnn.QuantConfig(8, 4, signed=False)))
    params, _ = tnn.init_params(PRNGKey(2), model, (9, 10, 2), device="cpu")
    return tnn.compile_model(model, params, (9, 10, 2), tnn.QuantConfig(8, 1, signed=False),
                             config=CompileConfig(jobs=1, verify="off"), device="cpu")


def _codes(report):
    return [d.code for d in report.errors]


def test_checker_passes_a_consistent_same_conv():
    design = _small_same_design()
    conv = design.step_specs[0]
    assert conv.params["pads"] == [1, 1, 0, 1] and (conv.params["oh"], conv.params["ow"]) == (5, 5)
    assert check_steps(design).ok


@pytest.mark.parametrize("edit", [{"oh": 4}, {"ow": 6}, {"pads": [0, 0, 0, 0]},
                                  {"pads": [1, 1, 0, 0]}, {"pads": [3, 1, 0, 1]}])
def test_checker_flags_a_same_conv_whose_grid_disagrees_with_its_pads(edit):
    design = _small_same_design()
    design.step_specs[0].params.update(edit)
    assert "DA021" in _codes(check_steps(design))


def test_checker_flags_malformed_pads():
    design = _small_same_design()
    design.step_specs[0].params["pads"] = [0, 1, 0]
    assert "DA023" in _codes(check_steps(design))


@pytest.mark.parametrize("hw,k,s,pads", [((32, 32), 3, 1, [1, 1, 1, 1]), ((16, 16), 3, 2, [0, 1, 0, 1]),
                                         ((9, 10), 3, 2, [1, 1, 0, 1]), ((7, 7), 3, 1, [0, 0, 0, 0])])
def test_conv_cells_count_the_zeros_the_unfold_writes(hw, k, s, pads):
    (h, w), cin = hw, 3
    top, bottom, left, right = pads
    oh, ow = (h + top + bottom - k) // s + 1, (w + left + right - k) // s + 1
    ones = F.pad(torch.ones(1, cin, h, w), (left, right, top, bottom))
    cols = F.unfold(ones, k, stride=s)  # [1, cin*k*k, oh*ow]
    p = {"h": h, "w": w, "cin": cin, "kh": k, "kw": k, "sh": s, "sw": s, "oh": oh, "ow": ow}
    if any(pads):
        p["pads"] = pads
    assert conv_cells(p) == {"unfold_cells": cols.numel(), "pad_cells": int((cols == 0).sum())}


def test_conv_spans_carry_the_cells():
    design = load_design(ASSETS / "svhn_cnn_32", device="cpu")
    convs = [s for s in design.steps if s.span == "executor.conv"]
    # 1,024, 256 and 64 positions of 27, 144 and 144 cells; zeros on the frame's edge
    assert [c.span_args["unfold_cells"] for c in convs] == [27648, 36864, 9216]
    assert [c.span_args["pad_cells"] for c in convs] == [1140, 3008, 1472]
    valid = load_design(ASSETS / "svhn_cnn", device="cpu")
    assert [c.span_args["pad_cells"] for c in valid.steps if c.span == "executor.conv"] == [0, 0, 0]
