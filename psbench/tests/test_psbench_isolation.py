"""The benchmark measures the port alone: nothing under ``psbench/`` imports
JAX or the JAX package, and the plain reference imports nothing of the port.

Top-level module names are compared whole: ``parameter_server_tpu_torch``
begins with ``parameter_server_tpu`` and is allowed outside the reference."""

from __future__ import annotations

import ast
import importlib.util
import sys
from pathlib import Path

import pytest

PKG = Path(__file__).resolve().parents[1]
FORBIDDEN = {"jax", "jaxlib", "flax", "parameter_server_tpu", "bench", "chip_smoke"}
PORT = "parameter_server_tpu_torch"


def _sources() -> list[Path]:
    return sorted(p for p in PKG.rglob("*.py") if "__pycache__" not in p.parts)


def _top_level_imports(path: Path) -> set[str]:
    names = set()
    for node in ast.walk(ast.parse(path.read_text(), str(path))):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif (isinstance(node, ast.Call) and getattr(node.func, "attr", "") == "import_module"
              and node.args and isinstance(node.args[0], ast.Constant)):
            names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", _sources(), ids=lambda p: str(p.relative_to(PKG)))
def test_no_jax_and_no_jax_package(path):
    assert not _top_level_imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")),
                         ids=lambda p: p.name)
def test_reference_takes_nothing_of_the_program(path):
    names = _top_level_imports(path)
    assert PORT not in names
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.ImportFrom) and node.module and node.module.startswith("psbench"):
            assert node.module.startswith("psbench.reference"), node.module


def test_every_module_loads_without_jax(monkeypatch):
    """Each module of ``psbench`` loads with ``jax`` and the JAX package
    made unimportable (``sys.modules[name] = None``)."""
    for name in ("jax", "jaxlib", "flax", "parameter_server_tpu"):
        monkeypatch.setitem(sys.modules, name, None)
    root = str(PKG.parent)
    if root not in sys.path:
        monkeypatch.syspath_prepend(root)
    loaded = set()
    for path in _sources():
        if path.name == "__init__.py":
            continue
        name = "psbench_iso_" + "_".join(
            path.relative_to(PKG).with_suffix("").parts).replace(".", "_")
        spec = importlib.util.spec_from_file_location(name, path)
        mod = importlib.util.module_from_spec(spec)
        monkeypatch.setitem(sys.modules, name, mod)
        spec.loader.exec_module(mod)
        loaded.add(path.relative_to(PKG).as_posix())
    assert {"run.py", "apps/linear_1chip.py", "reference/ftrl.py", "metrics/step_mfu.py"} <= loaded
    held = {m.split(".")[0] for m, v in sys.modules.items() if v is not None}
    assert not held & {"jax", "jaxlib", "flax", "parameter_server_tpu"}
