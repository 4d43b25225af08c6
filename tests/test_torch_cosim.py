"""The port's co-simulation gate (``repro_torch.core.cosim``) against the
JAX package's (``repro.core.cosim``), on the CPU.

* ``default_grid()`` is the JAX grid: the same 34 case names, matrices
  and keyword arguments;
* every case's report equals the JAX report (RTL stream, interpreter,
  latency, accounting, adders) on every key but the device leg's
  (``jit``), which the JAX side skips here;
* the device leg (``compile_tables`` + ``adder_graph_apply``, on the CPU
  the kernel's plain version) is ``checked`` and bit-exact on all 34,
  and catches a wrong executor;
* its only skips are ``jit="skip"`` and the int32 width guard: without
  a card ``jit="require"`` (and "auto") raises instead of skipping, and
  a kernel that fails fails the case.

Tolerance: exact equality (integer outputs, reports as JSON values).
"""

import numpy as np
import pytest
import torch

from repro.core import cosim as jcosim
from repro_torch.core import QInterval, cosim
from repro_torch.core import cosim_case, cosim_grid, cosim_program, default_grid, solve_cmvm
from repro_torch.kernels import adder_graph
from repro_torch.kernels._build import KernelError

JAX_GRID = jcosim.default_grid()
NAMES = [c["name"] for c in JAX_GRID]


def _kwargs(case: dict) -> dict:
    """A grid case with its QIntervals as plain tuples, for comparison."""
    out = {k: v for k, v in case.items() if k != "m"}
    if "qint_in" in out:
        out["qint_in"] = [(q.lo, q.hi, q.exp) for q in out["qint_in"]]
    return out


def test_default_grid_equals_jax():
    grid = default_grid()
    assert len(grid) == len(JAX_GRID) == 34
    for ours, ref in zip(grid, JAX_GRID):
        assert _kwargs(ours) == _kwargs(ref)
        np.testing.assert_array_equal(ours["m"], ref["m"])
        assert np.asarray(ours["m"]).dtype == np.asarray(ref["m"]).dtype


@pytest.mark.parametrize("name", NAMES)
def test_case_report_equals_jax(name):
    case = dict(default_grid()[NAMES.index(name)])
    ref_case = dict(JAX_GRID[NAMES.index(name)])
    m, ref_m = case.pop("m"), ref_case.pop("m")
    ours = cosim_case(m, device="cpu", **case)
    ref = jcosim.cosim_case(ref_m, jit="skip", **ref_case)
    assert ours.pop("jit") == {"status": "checked", "bit_exact": True, "mismatches": 0}
    ref.pop("jit")
    assert ours == ref
    assert ours["bit_exact"] and ours["latency_ok"]


def test_grid_device_leg_checked_on_every_case():
    rep = cosim_grid(device="cpu")
    assert rep["n_cases"] == rep["n_bit_exact"] == 34
    assert rep["all_bit_exact"]
    assert rep["jit"] == {"checked": 34, "skipped": 0, "ok": True}
    assert all(r["jit"]["status"] == "checked" and r["jit"]["bit_exact"] for r in rep["cases"])
    assert rep["external"] == {"tool": None, "checked": 0, "ok": True}
    ref = jcosim.cosim_grid(jit="skip")
    assert [{k: v for k, v in r.items() if k != "jit"} for r in rep["cases"]] == [
        {k: v for k, v in r.items() if k != "jit"} for r in ref["cases"]]
    assert {k: v for k, v in rep.items() if k not in ("jit", "cases")} == {
        k: v for k, v in ref.items() if k not in ("jit", "cases")}


def test_require_without_a_card_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = dict(default_grid()[0])
    m = case.pop("m")
    for mode in ("require", "auto"):
        with pytest.raises(RuntimeError, match="device='cpu'"):
            cosim_case(m, jit=mode, **case)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        cosim_grid(jit="require")
    # skipping the device leg by name needs no card
    assert cosim_case(m, jit="skip", **case)["jit"] == {"status": "skipped",
                                                        "reason": "disabled"}


def test_only_the_int32_guard_skips():
    wide = [QInterval.from_fixed(True, 30, 30)] * 3
    sol = solve_cmvm(np.array([[3, 5], [7, -6], [1, 9]]), qint_in=wide)
    rep = cosim_program(sol.program, jit="auto", device="cpu")
    assert rep["jit"] == {"status": "skipped", "reason": "exceeds int32"}
    assert rep["bit_exact"]
    with pytest.raises(ValueError, match="int32"):
        cosim_program(sol.program, jit="require", device="cpu")
    with pytest.raises(ValueError, match="jit must be"):
        cosim_program(sol.program, jit="maybe", device="cpu")


def test_device_leg_catches_a_wrong_executor(monkeypatch):
    real = adder_graph.adder_graph_apply

    def off_by_one(tables, x):
        y = real(tables, x)
        y[::3, 0] += 1
        return y

    monkeypatch.setattr(adder_graph, "adder_graph_apply", off_by_one)
    case = dict(default_grid()[0])
    rep = cosim_case(case.pop("m"), device="cpu", **case)
    assert rep["jit"]["status"] == "checked" and not rep["jit"]["bit_exact"]
    assert rep["jit"]["mismatches"] == (case["n_vectors"] + 2) // 3
    assert rep["bit_exact"]  # the RTL and the interpreter still agree


def test_external_leg_and_testbench_equal_jax(monkeypatch):
    case = dict(default_grid()[3])
    sol = solve_cmvm(case["m"])
    from repro.core import solve_cmvm as jsolve
    from repro.core.rtlsim import parse_verilog as jparse
    from repro.core.verilog import emit_verilog as jemit
    from repro_torch.core import emit_verilog, parse_verilog

    src = emit_verilog(sol.program, "dut", 3)
    assert src == jemit(jsolve(case["m"]).program, "dut", 3)
    x = cosim.random_vectors(sol.program, 8, seed=1)
    np.testing.assert_array_equal(x, jcosim.random_vectors(jsolve(case["m"]).program, 8, seed=1))
    assert cosim._make_testbench(parse_verilog(src), "dut", x) == jcosim._make_testbench(
        jparse(src), "dut", x)
    monkeypatch.setattr(cosim, "external_tool", lambda: None)
    want = sol.program.evaluate(x)
    assert cosim.run_external(src, "dut", x, want, 1, mode="auto")["status"] == "skipped"
    with pytest.raises(RuntimeError, match="no external simulator"):
        cosim.run_external(src, "dut", x, want, 1, mode="require")


def test_a_failing_kernel_fails_the_leg(monkeypatch):
    def refuse(tables, x):
        raise KernelError("launch refused")

    monkeypatch.setattr(adder_graph, "adder_graph_apply", refuse)
    case = dict(default_grid()[0])
    with pytest.raises(KernelError, match="launch refused"):
        cosim_case(case.pop("m"), device="cpu", **case)
