"""Find a cell's pieces by name: the cell in ``BENCHMARK.json``, its
configuration, its traffic mix, its app and the readers of its metrics.

Nothing here names a cell, a configuration, a mix or a metric: a later
change adds one by adding a file and an entry."""

from __future__ import annotations

import importlib.util
import json
import sys
from dataclasses import dataclass, field
from pathlib import Path
from types import ModuleType
from typing import Any

HERE = Path(__file__).resolve().parent


@dataclass
class Cell:
    """One workload of ``BENCHMARK.json`` with everything it names."""

    name: str
    chips: int
    config: dict[str, Any]
    traffic: dict[str, Any]
    end_to_end: list[dict[str, Any]]
    per_layer: list[dict[str, Any]]
    root: Path = field(default=HERE.parent)

    @property
    def app(self) -> str:
        return self.config["app"]


def _reports(metric: dict[str, Any], cell: str, e2e_names: set[str]) -> bool:
    """Whether ``metric`` is reported in ``cell``: its ``workloads`` list
    names the cell, or it has none and the cell reports what it moves."""
    if "workloads" in metric:
        return cell in metric["workloads"]
    return metric.get("moves", metric["name"]) in e2e_names


def load_cell(name: str, root: Path | None = None) -> Cell:
    """The cell ``name`` of ``<root>/BENCHMARK.json``; its configuration and
    mix are read from the files that name them under ``psbench/``."""
    root = Path(root) if root is not None else HERE.parent
    spec = json.loads((root / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; known: {sorted(cells)}")
    w = cells[name]
    cfg_entry = next(c for c in spec["configs"] if c["name"] == w["config"])
    config = json.loads((root / cfg_entry["file"]).read_text())
    pkg = root / spec["paths"][0]
    traffic = json.loads((pkg / "traffic" / f"{w['traffic']}.json").read_text())
    e2e = [m for m in spec["end_to_end"] if "workloads" not in m or name in m["workloads"]]
    e2e_names = {m["name"] for m in e2e}
    per_layer = [m for m in spec["per_layer"] if _reports(m, name, e2e_names)]
    return Cell(name, int(w["chips"]), config, traffic, e2e, per_layer, root)


def _load_file(path: Path, modname: str) -> ModuleType:
    s = importlib.util.spec_from_file_location(modname, path)
    if s is None or s.loader is None:
        raise ImportError(f"cannot load {path}")
    mod = importlib.util.module_from_spec(s)
    sys.modules[modname] = mod
    s.loader.exec_module(mod)
    return mod


def app_module(cell: Cell) -> ModuleType:
    """``psbench/apps/<app>.py`` of the cell's configuration."""
    return _load_file(cell.root / "psbench" / "apps" / f"{cell.app}.py",
                      f"psbench_app_{cell.app}")


def metric_reader(name: str, root: Path | None = None) -> ModuleType:
    """``psbench/metrics/<name>.py``: a module whose ``read(ctx)`` returns
    the metric's value, or None where the run has nothing to read."""
    root = Path(root) if root is not None else HERE.parent
    return _load_file(root / "psbench" / "metrics" / f"{name}.py",
                      "psbench_metric_" + name.replace(".", "_"))


def read_per_layer(cell: Cell, ctx: dict[str, Any]) -> dict[str, dict[str, Any]]:
    """Every per-layer metric of the cell that its reader finds something
    to read for; a reader that returns None is left out of the line."""
    out = {}
    for m in cell.per_layer:
        v = metric_reader(m["name"], cell.root).read(ctx)
        if v is not None:
            out[m["name"]] = {"value": float(v), "unit": m["unit"]}
    return out
