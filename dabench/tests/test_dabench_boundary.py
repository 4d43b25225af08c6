"""What the benchmark may import: neither JAX nor the JAX package, the
JAX package's benchmarks or the smoke script (top-level names compared
whole, since the port's name begins with the JAX package's); and the
reference nothing of the program."""

import ast
import subprocess
import sys

import pytest

from dabench.harness import HERE, ROOT

FORBIDDEN = {"jax", "jaxlib", "flax", "repro", "benchmarks", "chip_smoke"}
SOURCES = sorted(p for p in HERE.rglob("*.py") if "__pycache__" not in p.parts)


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", SOURCES, ids=lambda p: str(p.relative_to(HERE)))
def test_no_forbidden_import(path):
    assert not set(_imports(path)) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((HERE / "reference").glob("*.py")), ids=lambda p: p.name)
def test_reference_imports_nothing_of_the_program(path):
    assert set(_imports(path)) <= {"__future__", "math", "numpy", "torch"}


def test_the_check_compares_whole_names():
    assert "repro_torch" not in FORBIDDEN and "repro" in FORBIDDEN


def test_importing_the_harness_loads_no_jax():
    code = ("import sys; sys.path[:0] = [%r, %r]; import dabench.harness, dabench.control; "
            "import dabench.drivers.bulk, dabench.drivers.replay; "
            "print(sorted({m.split('.')[0] for m in sys.modules} & %r))"
            % (str(ROOT / "src"), str(ROOT), FORBIDDEN))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, check=True,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.stdout.strip() == "[]"


def test_run_without_a_card_prints_no_result():
    out = subprocess.run([sys.executable, str(HERE / "run.py"), "--workload", "mixer_b256",
                          "--seed", "1", "--seconds", "1", "--trace", "0"],
                         capture_output=True, text=True, env={"PATH": "/usr/bin:/bin",
                                                              "CUDA_VISIBLE_DEVICES": ""})
    assert out.returncode != 0 and out.stdout == ""


def test_program_from_another_tree_is_refused(tmp_path):
    # a copy of the benchmark alone, beside no src/: the program found elsewhere is refused
    import shutil

    shutil.copytree(HERE, tmp_path / "dabench", ignore=shutil.ignore_patterns("__pycache__"))
    code = ("import sys; sys.path[:0] = [%r, %r]; import dabench.harness as h; h.check_program_source()"
            % (str(tmp_path), str(ROOT / "src")))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         env={"PATH": "/usr/bin:/bin"})
    assert out.returncode != 0 and "not from" in out.stderr


def test_program_from_this_tree_is_taken():
    from dabench import harness

    harness.check_program_source()
