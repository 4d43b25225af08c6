"""The port's Verilog emission, RTL simulator and static verifier
(``repro_torch.core.verilog``/``rtlsim``, ``repro_torch.analysis``)
against the JAX package's, case by case.

* ``emit_verilog`` gives the same text, and ``RTLSimulator`` the same
  outputs (equal to ``DAISProgram.evaluate``), on the programs of
  tests/test_verilog.py and tests/test_rtlsim.py;
* ``verify_design`` gives the same ``DiagnosticReport`` (the same codes,
  severities, messages and locations) on the committed assets and on
  the corruptions of tests/test_analysis.py, applied alike to a design
  compiled by each package from the same weights;
* ``load_design(verify=...)`` gates as the JAX package's does.

Tolerance: exact equality throughout.
"""

import copy
import json
import re
import sys
import types
from dataclasses import replace
from pathlib import Path

import jax
import numpy as np
import pytest

import repro.analysis as janalysis
import repro.core as jcore
import repro_torch.analysis as tanalysis
import repro_torch.core as tcore
import repro_torch.core.pipelining as tpipelining
import repro_torch.core.verilog as tverilog
from repro.flow import CompileConfig as JCompileConfig
from repro.nn import QDense as JQDense
from repro.nn import QuantConfig as JQuantConfig
from repro.nn import ReLU as JReLU
from repro.nn import compile_model as jcompile
from repro.nn import init_params as jinit
from repro.runtime import load_design as jload
from repro.runtime import save_design as jsave
from repro_torch.analysis.__main__ import main as analysis_cli
from repro_torch.flow import CompileConfig as TCompileConfig
from repro_torch.nn import QDense, QuantConfig, ReLU, compile_model, params_from_numpy
from repro_torch.runtime import load_design, save_design

ASSETS = Path(__file__).resolve().parent.parent / "src" / "repro_torch" / "assets"
# rows-array columns (see DAISProgram.to_arrays)
_KIND, _A, _B, _SH_A, _SH_B, _SIGN, _DEPTH, _COST, _QLO, _QHI, _QEXP = range(11)


def _toy(pkg):
    p = pkg.DAISProgram()
    q8 = pkg.QInterval.from_fixed(True, 8, 8)
    i0, i1 = p.add_input(q8), p.add_input(q8)
    r2 = p.add_op(i0, i1, 0, 0, 1)
    r3 = p.add_op(r2, i1, 0, 2, 1)
    r4 = p.add_op(r3, i0, 0, 0, -1)
    p.outputs = [pkg.Term(1, r4, 0), pkg.Term(-1, r2, 1)]
    return p


def _negation(pkg):
    p = pkg.DAISProgram()
    q = pkg.QInterval.from_fixed(True, 6, 6)
    a, b = p.add_input(q), p.add_input(q)
    s = p.add_op(a, b, 0, 1, 1)
    p.outputs = [pkg.Term(-1, s, 0), None, pkg.Term(1, p.add_neg(s), 2)]
    return p


def _unsigned(pkg):
    p = pkg.DAISProgram()
    qu = pkg.QInterval.from_fixed(False, 8, 8)
    a, b = p.add_input(qu), p.add_input(qu)
    p.outputs = [pkg.Term(1, p.add_op(a, b, 0, 0, 1), 0)]
    return p


def _negative_shift(pkg):
    p = pkg.DAISProgram()
    q = pkg.QInterval.from_fixed(True, 8, 8)
    a, b = p.add_input(q), p.add_input(q)
    s = p.add_op(a, b, 0, 3, -1)
    p.outputs = [pkg.Term(1, s, -2), pkg.Term(-1, s, -5)]
    return p


def _solved(pkg, cfg_pkg, seed=3, n=6):
    m = np.random.default_rng(seed).integers(-64, 64, size=(n, n))
    return pkg.solve_cmvm(m, config=cfg_pkg.SolverConfig(dc=-1)).program


PROGRAMS = {
    "toy": lambda pkg, cfg: _toy(pkg),
    "negation": lambda pkg, cfg: _negation(pkg),
    "unsigned": lambda pkg, cfg: _unsigned(pkg),
    "negative_shift": lambda pkg, cfg: _negative_shift(pkg),
    "solved": _solved,
}


def _pair(name):
    import repro.flow as jflow
    import repro_torch.flow as tflow

    return PROGRAMS[name](jcore, jflow), PROGRAMS[name](tcore, tflow)


# ----------------------------------------------------------------------
# emission and the RTL simulator
# ----------------------------------------------------------------------
@pytest.mark.parametrize("mdps", [None, 1, 2, 10])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_emit_verilog_text_equal(name, mdps):
    jp, tp = _pair(name)
    src = tcore.emit_verilog(tp, "m", max_delay_per_stage=mdps)
    assert src == jcore.emit_verilog(jp, "m", max_delay_per_stage=mdps)
    mod, jmod = tcore.parse_verilog(src), jcore.parse_verilog(src)
    assert (mod.inputs, mod.outputs, mod.latency_cycles) == \
        (jmod.inputs, jmod.outputs, jmod.latency_cycles)
    assert sorted(a.dst for a in mod.clocked) == sorted(a.dst for a in jmod.clocked)


@pytest.mark.parametrize("mdps", [None, 1, 2])
@pytest.mark.parametrize("name", sorted(PROGRAMS))
def test_rtlsim_outputs_equal(name, mdps):
    jp, tp = _pair(name)
    src = tcore.emit_verilog(tp, "m", max_delay_per_stage=mdps)
    lo = min(r.qint.lo for r in tp.rows[: tp.n_inputs])
    hi = max(r.qint.hi for r in tp.rows[: tp.n_inputs])
    x = np.random.default_rng(7).integers(lo, hi + 1, size=(40, tp.n_inputs), dtype=np.int64)
    res, jres = tcore.RTLSimulator(src).run_stream(x), jcore.RTLSimulator(src).run_stream(x)
    np.testing.assert_array_equal(res.y, jres.y)
    np.testing.assert_array_equal(res.y, tp.evaluate(x))
    assert res.n_cycles == jres.n_cycles
    assert res.accounting() == jres.accounting()
    comb = tcore.emit_verilog(tp, "c", max_delay_per_stage=None)
    np.testing.assert_array_equal(tcore.RTLSimulator(comb).run_combinational(x), jp.evaluate(x))


def test_rtlsim_rejects_what_the_reference_rejects():
    bad = "module m (input wire a, output wire y);\n assign y = b;\nendmodule"
    with pytest.raises(tcore.RTLSimError, match="undeclared"):
        tcore.parse_verilog(bad)
    with pytest.raises(jcore.RTLSimError, match="undeclared"):
        jcore.parse_verilog(bad)


# ----------------------------------------------------------------------
# the verifier: one design compiled by each package
# ----------------------------------------------------------------------
def _small_dense_specs(qd, relu, quant):
    wq, aq = quant(6, 2, signed=True), quant(8, 4, signed=False)
    return (qd(12, wq), relu(aq), qd(5, wq)), (10,), quant(8, 4, signed=True)


@pytest.fixture(scope="module")
def designs():
    """The small dense net of tests/test_analysis.py, compiled from the
    same weights by the JAX package and by the port."""
    jmodel, in_shape, jiq = _small_dense_specs(JQDense, JReLU, JQuantConfig)
    tmodel, _, tiq = _small_dense_specs(QDense, ReLU, QuantConfig)
    params, _ = jinit(jax.random.PRNGKey(0), jmodel, in_shape)
    jd = jcompile(jmodel, params, in_shape, jiq, config=JCompileConfig(verify="off"))
    td = compile_model(tmodel, params_from_numpy(jax.tree.map(np.asarray, params), "cpu"),
                       in_shape, tiq, config=TCompileConfig(verify="off"), device="cpu")
    return jd, td


def _mutant(design):
    d = copy.copy(design)
    d.programs = [None if p is None else {k: np.array(v) for k, v in p.items()}
                  for p in design.programs]
    d.reports = list(design.reports)
    return d


def _diags(rep):
    return [(d.code, d.severity, d.message, d.loc, d.passname) for d in rep.diagnostics]


def _first_op_row(parr):
    return int(np.nonzero(parr["rows"][:, _KIND] != 0)[0][0])


def _stale_interval(d):
    d.programs[0]["rows"][_first_op_row(d.programs[0]), _QHI] += 1


def _flipped_shift(d):
    rows = d.programs[0]["rows"]
    i = int(np.nonzero((rows[:, _KIND] == 1) & (rows[:, _SH_A] + rows[:, _SH_B] > 0))[0][0])
    col = _SH_A if rows[i, _SH_A] > 0 else _SH_B
    rows[i, col] = -rows[i, col]


def _dangling(d):
    i = _first_op_row(d.programs[0])
    d.programs[0]["rows"][i, _A] = i


def _wrong_latency(d):
    d.reports[0] = replace(d.reports[0], stages=d.reports[0].stages + 1)


def _wrong_cost(d):
    d.programs[-1]["rows"][_first_op_row(d.programs[-1]), _COST] += 3


MUTATIONS = {
    "DA004": _stale_interval,
    "DA003": _flipped_shift,
    "DA001": _dangling,
    "DA047": _wrong_latency,
    "DA006": _wrong_cost,
}


def test_designs_compile_alike(designs):
    jd, td = designs
    for a, b in zip(jd.programs, td.programs):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])


@pytest.mark.parametrize("tier", ["cheap", "strict"])
def test_clean_design_reports_equal(designs, tier):
    jd, td = designs
    rep = tanalysis.verify_design(td, tier=tier)
    assert rep.ok, rep.summary()
    assert _diags(rep) == _diags(janalysis.verify_design(jd, tier=tier))
    assert set(rep.pass_wall_s) == set(janalysis.verify_design(jd, tier=tier).pass_wall_s)


@pytest.mark.parametrize("code", sorted(MUTATIONS))
def test_corruption_reports_equal(designs, code):
    jd, td = designs
    jm, tm = _mutant(jd), _mutant(td)
    MUTATIONS[code](jm)
    MUTATIONS[code](tm)
    rep = tanalysis.verify_design(tm, tier="strict")
    assert not rep.ok and code in rep.codes(), rep.summary()
    assert _diags(rep) == _diags(janalysis.verify_design(jm, tier="strict"))


def test_doctored_emission_width_da009(designs):
    jd, td = designs
    prog = tcore.DAISProgram.from_arrays(td.programs[0])
    src = tcore.emit_verilog(prog, max_delay_per_stage=5)
    m = re.search(r"(wire|reg) signed \[(\d+):0\] v\d+_s\d+", src)
    doctored = src[: m.start(2)] + str(int(m.group(2)) - 1) + src[m.end(2):]
    rep = tanalysis.check_emission(prog, 5, src=doctored)
    assert "DA009" in rep.codes()
    jprog = jcore.DAISProgram.from_arrays(jd.programs[0])
    assert _diags(rep) == _diags(janalysis.check_emission(jprog, 5, src=doctored))
    assert tanalysis.check_emission(prog, 5, src=src).ok


def _artifact_tamper(path):
    with np.load(path / "design.npz", allow_pickle=False) as z:
        arrays = {k: np.array(z[k]) for k in z.files}
    key = next(k for k in sorted(arrays) if arrays[k].size)
    arrays[key].flat[0] += 1
    np.savez_compressed(path / "design.npz", **arrays)


def _manifest_edit(fn):
    def edit(path):
        manifest = json.loads((path / "manifest.json").read_text())
        fn(manifest)
        (path / "manifest.json").write_text(json.dumps(manifest))

    return edit


ARTIFACT_MUTATIONS = {
    "DA041": _artifact_tamper,
    "DA042": _manifest_edit(lambda m: m["compile_config"].update(
        max_delay_per_stage=m["compile_config"]["max_delay_per_stage"] + 1)),
    "DA045": _manifest_edit(lambda m: m["resources"].update(
        total_adders=m["resources"]["total_adders"] + 1)),
    "DA047": _manifest_edit(lambda m: m["reports"][0].update(stages=m["reports"][0]["stages"] + 1)),
    "DA044": _manifest_edit(lambda m: m["steps"][0]["arrays"].update(bias="step_missing")),
}


@pytest.mark.parametrize("code", sorted(ARTIFACT_MUTATIONS))
def test_corrupted_artifact_reports_equal(designs, tmp_path, code):
    """The port saves, the corruption is applied, and both packages audit
    the one directory."""
    _, td = designs
    path = save_design(td, tmp_path / "art")
    ARTIFACT_MUTATIONS[code](path)
    rep = tanalysis.verify_design(path, tier="cheap")
    assert not rep.ok and code in rep.codes(), rep.summary()
    assert _diags(rep) == _diags(janalysis.verify_design(path, tier="cheap"))


@pytest.mark.parametrize("name", ["mixer_full", "svhn_cnn"])
def test_committed_assets_report_equal(name):
    rep = tanalysis.verify_design(ASSETS / name, tier="strict")
    assert rep.ok, rep.summary()
    assert {"artifact", "program", "steps", "emission"} <= set(rep.pass_wall_s)
    assert _diags(rep) == _diags(janalysis.verify_design(ASSETS / name, tier="strict"))


# ----------------------------------------------------------------------
# gates: load and CLI
# ----------------------------------------------------------------------
@pytest.mark.parametrize("tier", ["cheap", "strict"])
def test_load_gate_accepts_and_records(designs, tmp_path, tier):
    _, td = designs
    path = save_design(td, tmp_path / "art")
    d = load_design(path, device="cpu", verify=tier)
    v = d.solver_stats["verify"]
    assert v["tier"] == tier and v["ok"] and v["n_errors"] == 0
    assert "program" in v["pass_wall_s"]
    assert d.solver_stats["n_solves"] == 0


def test_load_gate_raises_as_the_reference(designs, tmp_path):
    jd, td = designs
    path = save_design(td, tmp_path / "art")
    ARTIFACT_MUTATIONS["DA047"](path)
    with pytest.raises(tanalysis.DesignVerificationError) as ei:
        load_design(path, device="cpu", verify="cheap")
    with pytest.raises(janalysis.DesignVerificationError) as ej:
        jload(path, verify="cheap")
    assert _diags(ei.value.report) == _diags(ej.value.report)
    assert "DA047" in {d.code for d in ei.value.report.errors}
    assert load_design(path, device="cpu").solver_stats["n_solves"] == 0  # default stays off
    with pytest.raises(ValueError, match="tier"):
        load_design(path, device="cpu", verify="bogus")
    # a JAX-saved artifact passes the port's gate
    assert load_design(jsave(jd, tmp_path / "jax"), device="cpu", verify="strict")


def test_cli_roundtrip(designs, tmp_path, capsys):
    _, td = designs
    good = save_design(td, tmp_path / "good")
    out = tmp_path / "diag.json"
    assert analysis_cli([str(good), "--tier", "cheap", "--json", str(out)]) == 0
    assert json.loads(out.read_text())[str(good)]["ok"]
    bad = save_design(td, tmp_path / "bad")
    ARTIFACT_MUTATIONS["DA045"](bad)
    assert analysis_cli([str(bad), "--tier", "cheap", "--quiet"]) == 1
    assert "FAIL" in capsys.readouterr().out


# ----------------------------------------------------------------------
# defects re-introduced at the source level, and unit seams
# ----------------------------------------------------------------------
def _exec_mutant(module, old: str, new: str) -> types.ModuleType:
    src = Path(module.__file__).read_text()
    assert old in src, f"mutation anchor not found in {module.__name__}"
    mod = types.ModuleType(module.__name__ + "_mutant")
    mod.__package__ = module.__package__
    mod.__file__ = module.__file__
    sys.modules[mod.__name__] = mod
    exec(compile(src.replace(old, new), module.__file__, "exec"), mod.__dict__)
    return mod


def _carry_tap_program():
    p = tcore.DAISProgram()
    x0 = p.add_input(tcore.QInterval(-8, 7, 0))
    x1 = p.add_input(tcore.QInterval(-8, 7, 0))
    o = p.add_op(x0, x1, 0, 0, 1)
    t = p.add_op(o, x0, 0, 0, 1)
    p.add_op(t, x1, 0, 0, 1)
    p.outputs = [tcore.Term(1, o, 0)]
    return p


def test_signed_width_defect_da009(designs, monkeypatch):
    _, td = designs
    buggy = _exec_mutant(tverilog, "w = q.width + (0 if q.lo < 0 else 1)", "w = q.width")
    import repro_torch.analysis.program as program_mod

    prog = tcore.DAISProgram.from_arrays(td.programs[-1])
    assert tanalysis.check_emission(prog, 5).ok
    monkeypatch.setattr(program_mod, "emit_verilog", buggy.emit_verilog)
    assert "DA009" in tanalysis.check_emission(prog, 5).codes()


def test_carry_clobber_defects_da010_da011(monkeypatch):
    prog = _carry_tap_program()
    buggy_pipe = _exec_mutant(tpipelining, "last_use[t.row] = max(last_use[t.row], n_stages - 1)",
                              "last_use[t.row] = n_stages - 1")
    assert tanalysis.check_pipeline(prog, 1).ok
    rep = tanalysis.check_pipeline(prog, 1, claimed=buggy_pipe.pipeline(prog, 1))
    assert "DA010" in rep.codes()
    buggy_emit = _exec_mutant(tverilog, "last_use[t.row] = max(last_use[t.row], n_stage - 1)",
                              "last_use[t.row] = n_stage - 1")
    import repro_torch.analysis.program as program_mod

    assert tanalysis.check_emission(prog, 1).ok
    monkeypatch.setattr(program_mod, "emit_verilog", buggy_emit.emit_verilog)
    rep = tanalysis.check_emission(prog, 1)
    assert "DA011" in rep.codes() and "DA009" not in rep.codes()


def test_codes_and_width_rule_equal():
    assert tanalysis.CODES == janalysis.CODES
    for q in [(0, 0, 0), (0, 1, 0), (0, 255, 0), (-1, 0, 0), (-256, 255, 0), (-3, 700, 2)]:
        assert tanalysis.required_signed_width(tcore.QInterval(*q)) == \
            janalysis.required_signed_width(jcore.QInterval(*q))


def test_dead_row_warning_da008():
    p = tcore.DAISProgram()
    x0 = p.add_input(tcore.QInterval(-4, 3, 0))
    x1 = p.add_input(tcore.QInterval(-4, 3, 0))
    o = p.add_op(x0, x1, 0, 0, 1)
    p.add_op(o, x1, 0, 0, 1)  # never tapped
    p.outputs = [tcore.Term(1, o, 0)]
    rep = tanalysis.check_program(p)
    assert rep.ok and "DA008" in rep.codes()
