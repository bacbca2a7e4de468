"""Suite-wide fixtures/shims.

If `hypothesis` is not installed, alias the deterministic stub in
`tests/_hypothesis_stub.py` into ``sys.modules`` *before* test modules are
collected, so `from hypothesis import given, settings, strategies as st`
keeps working and the property tests run with a small fixed example set.
"""
import importlib.util
import pathlib
import sys

try:
    import hypothesis  # noqa: F401 — real package wins when available
except ImportError:
    _spec = importlib.util.spec_from_file_location(
        "_hypothesis_stub", pathlib.Path(__file__).parent / "_hypothesis_stub.py"
    )
    _stub = importlib.util.module_from_spec(_spec)
    _spec.loader.exec_module(_stub)
    sys.modules["hypothesis"] = _stub
    sys.modules["hypothesis.strategies"] = _stub.strategies


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs a CUDA card; skips where there is none")
