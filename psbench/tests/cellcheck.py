"""The shared checks of every cell, for the benchmark at ``root``: each cell
against its plain reference at its app's CPU size (``TINY``), each fault
its app declares (``FAULTS``) planted underneath, and its control. Nothing
here knows a model: what a cell's app knows of itself, the app says."""

from __future__ import annotations

import json
from pathlib import Path
from types import ModuleType

from psbench.checks import checks_from
from psbench.run import run_cell
from psbench.spec import Cell, app_module, load_cell

ROOT = Path(__file__).resolve().parents[2]
SEED = (1 << 31) + 12345


def cells(root: Path = ROOT) -> list[str]:
    return [w["name"] for w in json.loads((root / "BENCHMARK.json").read_text())["workloads"]]


def app_of(cell: str, root: Path = ROOT) -> ModuleType:
    return app_module(load_cell(cell, root))


def cell_faults(root: Path = ROOT) -> list[tuple[str, str]]:
    """(cell, fault) for each fault that the cell's own app declares."""
    return [(c, f) for c in cells(root) for f in app_of(c, root).FAULTS]


def fault_ids(cases: list[tuple[str, str]]) -> list[str]:
    return [f"{f}-{c}" for c, f in cases]


def shrunk(cell: str, root: Path = ROOT) -> Cell:
    """The cell with its app's ``TINY`` applied, each key where ``run_cell``
    puts an override: into the configuration where it holds the key and the
    mix does not, else into the mix."""
    c = load_cell(cell, root)
    for k, v in app_module(c).TINY.items():
        (c.config if k in c.config and k not in c.traffic else c.traffic)[k] = v
    return c


def run_tiny(cell: str, root: Path = ROOT, seed: int = SEED) -> dict:
    return run_cell(cell, seed, 1.0, False, device="cpu", root=root,
                    overrides=dict(app_of(cell, root).TINY))


def check_agrees(cell: str, root: Path = ROOT) -> None:
    out = run_tiny(cell, root)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def check_fault(cell: str, fault: str, monkeypatch, root: Path = ROOT) -> None:
    """Plant the app's fault underneath and drive the run as the benchmark
    drives it: ``correct`` has to come out false."""
    app_of(cell, root).FAULTS[fault](monkeypatch)
    out = run_tiny(cell, root)
    assert not out["correct"], out["checks"]


def check_control(cell: str, root: Path = ROOT) -> None:
    c = shrunk(cell, root)
    low = app_module(c).control(c, SEED)
    assert not all(ch.ok for ch in checks_from(low, c.config["limits"])), low
