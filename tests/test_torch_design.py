"""The port's integer executor and artifacts against the JAX package.

Three of the paper's networks (jet tagger, SVHN CNN, the 16-particle
Mixer; together every step kind) are compiled once by the JAX package
and saved; the port loads the artifacts on the CPU.  The same numpy
inputs go through the port's ``forward_int`` / ``forward``, the JAX
``forward_int`` / ``forward`` (jitted, as the JAX serving engine runs
them) and the numpy interpreter.  Tolerance:
exact equality (integer pipeline; the float outputs are integers scaled
by powers of two).  Artifacts cross in both directions with equal
content digests; damaged ones raise ``ArtifactCorruptError``.
"""

import json
import shutil

import jax
import numpy as np
import pytest
import torch

from repro import flow as jax_flow
from repro.nn import compile_model, init_params, models, numpy_forward_fn
from repro.runtime import load_design as jax_load_design
from repro.runtime import save_design as jax_save_design
from repro_torch import flow
from repro_torch.nn.compiler import count_cmvm_steps
from repro_torch.runtime import ArtifactCorruptError, load_design, save_design

NETWORKS = {
    "jet_tagger": models.jet_tagger,
    "svhn_cnn": models.svhn_cnn,
    "mlp_mixer_jet": models.mlp_mixer_jet,
}


@pytest.fixture(scope="module")
def compiled(tmp_path_factory):
    """name -> (JAX design, path of its JAX-written artifact, jitted JAX
    forward_int, jitted JAX forward)."""
    root = tmp_path_factory.mktemp("jax_designs")
    out = {}
    for name, make in NETWORKS.items():
        model, in_shape, in_quant = make()
        params, _ = init_params(jax.random.PRNGKey(0), model, in_shape)
        design = compile_model(
            model, params, in_shape, in_quant, config=jax_flow.CompileConfig(jobs=1)
        )
        out[name] = (
            design,
            jax_save_design(design, root / name),
            jax.jit(design.forward_int),
            jax.jit(design.forward),
        )
    return out


def _grid_inputs(design, n=48, seed=0):
    q = design.in_quant.qint
    rng = np.random.default_rng(seed)
    return rng.integers(q.lo, q.hi + 1, size=(n, *design.in_shape)).astype(np.int32)


@pytest.mark.parametrize("name", NETWORKS)
def test_forward_int_bit_exact(compiled, name):
    jd, path, jax_forward_int, _ = compiled[name]
    pd = load_design(path, device="cpu")
    x = _grid_inputs(jd)
    got = pd.forward_int(torch.from_numpy(x)).numpy()
    assert got.dtype == np.int32 and got.shape == (len(x), *jd.out_shape)
    np.testing.assert_array_equal(got, np.asarray(jax_forward_int(x)))
    np.testing.assert_array_equal(got, numpy_forward_fn(jd)(x))


@pytest.mark.parametrize("name", NETWORKS)
def test_forward_float_exact(compiled, name):
    jd, path, _, jax_forward = compiled[name]
    pd = load_design(path, device="cpu")
    q = jd.in_quant
    rng = np.random.default_rng(1)
    # a little beyond the input range on both sides, to reach the clip
    x = rng.uniform(q.qint.lo * q.step * 1.1 - 0.1, q.qint.hi * q.step * 1.1 + 0.1,
                    size=(48, *jd.in_shape)).astype(np.float32)
    got = pd(torch.from_numpy(x)).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, np.asarray(jax_forward(x)))


@pytest.mark.parametrize("name", NETWORKS)
def test_tables_and_reports_match(compiled, name):
    jd, path, _, _ = compiled[name]
    pd = load_design(path, device="cpu")
    assert [t.digest for t in pd.tables] == [t.digest for t in jd.tables]
    assert pd.summary() == jd.summary()
    assert (pd.total_adders, pd.total_cost_bits, pd.max_depth, pd.latency_cycles) == (
        jd.total_adders, jd.total_cost_bits, jd.max_depth, jd.latency_cycles)
    assert pd.config.digest() == jd.config.digest()
    assert (pd.in_shape, pd.out_shape) == (tuple(jd.in_shape), tuple(jd.out_shape))
    assert count_cmvm_steps(pd.step_specs) == sum(
        1 for s in _flat_specs(jd.step_specs) if s.kind in ("dense", "conv"))


def _flat_specs(specs):
    for s in specs:
        yield s
        yield from _flat_specs(s.body or [])


@pytest.mark.parametrize("name", NETWORKS)
def test_port_artifact_loads_in_jax(compiled, name, tmp_path):
    jd, path, jax_forward_int, _ = compiled[name]
    pd = load_design(path, device="cpu")
    save_design(pd, tmp_path / "port")
    ours = json.loads((tmp_path / "port" / "manifest.json").read_text())
    theirs = json.loads((path / "manifest.json").read_text())
    assert ours["arrays_sha256"] == theirs["arrays_sha256"]
    for key in ("steps", "in_quant", "in_shape", "out_shape", "use_pallas", "n_programs",
                "compile_config", "compile_config_digest", "reports", "resources"):
        assert ours[key] == theirs[key], key
    back = jax_load_design(tmp_path / "port")
    x = _grid_inputs(jd, seed=2)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(back.forward_int)(x)), np.asarray(jax_forward_int(x))
    )


def _truncate_npz(d):
    p = d / "design.npz"
    p.write_bytes(p.read_bytes()[: p.stat().st_size // 2])


def _garbage_manifest(d):
    (d / "manifest.json").write_text("{not json")


def _drop_manifest(d):
    (d / "manifest.json").unlink()


def _drop_npz(d):
    (d / "design.npz").unlink()


def _missing_array(d):
    m = json.loads((d / "manifest.json").read_text())
    m["steps"][0]["arrays"]["bias"] = "no_such_key"
    m.pop("arrays_sha256")
    (d / "manifest.json").write_text(json.dumps(m))


_CORRUPTIONS = {
    "truncated_npz": _truncate_npz,
    "garbage_manifest": _garbage_manifest,
    "manifest_missing": _drop_manifest,
    "npz_missing": _drop_npz,
    "missing_array": _missing_array,
}


@pytest.mark.parametrize("damage", [*_CORRUPTIONS, "mixed_generation"])
def test_damaged_artifacts_raise(compiled, tmp_path, damage):
    path = compiled["jet_tagger"][1]
    d = tmp_path / "a"
    shutil.copytree(path, d)
    if damage == "mixed_generation":
        shutil.copy(compiled["mlp_mixer_jet"][1] / "design.npz", d / "design.npz")
    else:
        _CORRUPTIONS[damage](d)
    with pytest.raises(ArtifactCorruptError):
        load_design(d, device="cpu")


def test_quarantine_moves_damaged_artifact(compiled, tmp_path):
    d = tmp_path / "a"
    shutil.copytree(compiled["jet_tagger"][1], d)
    _garbage_manifest(d)
    with pytest.raises(ArtifactCorruptError) as ei:
        load_design(d, device="cpu", on_corrupt="quarantine")
    assert not d.exists()
    assert ei.value.quarantined_to == tmp_path / "a.quarantined"
    assert (tmp_path / "a.quarantined" / "design.npz").exists()


def test_wrong_format_and_unported_verify(compiled, tmp_path):
    d = tmp_path / "a"
    shutil.copytree(compiled["jet_tagger"][1], d)
    with pytest.raises(ValueError, match="not yet ported"):
        load_design(d, device="cpu", verify="cheap")
    m = json.loads((d / "manifest.json").read_text())
    m["format"] = "something-else"
    (d / "manifest.json").write_text(json.dumps(m))
    with pytest.raises(ValueError, match="not a da4ml-design") as ei:
        load_design(d, device="cpu")
    assert not isinstance(ei.value, ArtifactCorruptError)


def test_design_device_and_input_placement(compiled):
    pd = load_design(compiled["jet_tagger"][1], device="cpu")
    assert pd.device == torch.device("cpu")
    assert pd.to("cpu") is pd
    with pytest.raises(ValueError, match="move one of them"):
        pd.forward_int(torch.zeros((2, 16), dtype=torch.int32, device="meta"))


_CONFIGS = [
    ("SolverConfig", {}),
    ("SolverConfig", {"dc": 3, "engine": "arena", "weighted": False}),
    ("CompileConfig", {}),
    ("CompileConfig", {"strategy": "latency", "jobs": 4, "verify": "off", "use_pallas": True}),
    ("ServeConfig", {}),
    ("ServeConfig", {"max_batch": 16, "buckets": (16, 1, 8), "shards": 3, "deadline_ms": 5.0}),
]


@pytest.mark.parametrize("cls,kw", _CONFIGS)
def test_config_digests_interchange(cls, kw):
    ours, theirs = getattr(flow, cls)(**kw), getattr(jax_flow, cls)(**kw)
    assert ours.digest() == theirs.digest()
    assert ours.to_dict() == theirs.to_dict()
    assert getattr(flow, cls).from_dict(theirs.to_dict()) == ours
    with pytest.raises(flow.ConfigError):
        getattr(flow, cls).from_dict({**ours.to_dict(), "bogus": 1})
