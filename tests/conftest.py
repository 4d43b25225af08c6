"""Shared test configuration.

The six property-test modules below use ``hypothesis``.  The package is
an optional dev dependency (see requirements-dev.txt); when it is not
installed those modules are skipped at collection so the rest of the
suite still collects and runs green.
"""

_HYPOTHESIS_MODULES = [
    "test_csd.py",
    "test_fixed_point.py",
    "test_nn_property.py",
    "test_pipelining_verilog.py",
    "test_rtlsim_property.py",
    "test_solver.py",
]

try:
    import hypothesis  # noqa: F401

    collect_ignore: list[str] = []
except ImportError:
    collect_ignore = list(_HYPOTHESIS_MODULES)


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "cuda: needs a CUDA card; skips without one (run on the card with "
        "`python -m pytest -m cuda tests/test_torch_*.py`)",
    )
