"""The control of each cell on the card, at the cell's own size: the plain
reference computed in bfloat16 in the program's place (the configurations
state float32) has to fail at least one of the cell's limits, on three
seeds; and so has each fault that the cell's app declares in ``FAULTS``
(for ``LinearMethod``: the step that returns its state unchanged, half of
the batch left out with the mean taken over the rest, the loss altered
where it is produced), planted in the program at the cell's size.

    python -m pytest psbench/tests/test_psbench_control.py -m cuda -s

prints each reading (``CONTROL <cell> <seed> <name> <reading> limit
<limit>``, ``FAULT <cell> <fault> <seed> <name> <reading> <limit>``): the
limits in the configurations were set between the program's readings and
these. The control's readings go through the same checks as a run's, and
``correct`` has to come out false."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from psbench.checks import checks_from  # noqa: E402
from psbench.run import run_cell  # noqa: E402
from psbench.spec import app_module, load_cell  # noqa: E402
from psbench.tests.cellcheck import app_of, cell_faults, cells, fault_ids  # noqa: E402

SEEDS = [2147483911, 2147483923, 2147483947]
CELLS = cells()
FAULT_CASES = cell_faults()


@pytest.fixture
def card():
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card: the control runs at the cell's size")


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct_at_the_cell_size(card, cell, seed):
    c = load_cell(cell)
    low = app_module(c).control(c, seed)
    checks = checks_from(low, c.config["limits"])
    for ch in checks:
        print(f"CONTROL {cell} {seed} {ch.line()}", flush=True)
    assert not all(ch.ok for ch in checks), low


@pytest.mark.cuda
@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize(("cell", "fault"), FAULT_CASES, ids=fault_ids(FAULT_CASES))
def test_fault_fails_a_limit_at_the_cell_size(card, cell, fault, seed, monkeypatch):
    app_of(cell).FAULTS[fault](monkeypatch)
    out = run_cell(cell, seed, 2.0, False)
    for k, c in out["checks"].items():
        print(f"FAULT {cell} {fault} {seed} {k} {c['value']!r} {c['limit']!r}", flush=True)
    assert not out["correct"], out["checks"]
