"""Each cell against its plain reference on the CPU at its app's tiny size,
and each fault that its app declares: the run is driven as the benchmark
drives it (the look for a card skipped), with the timed path broken
underneath, and ``correct`` has to come out false. The bodies are the
helpers of ``cellcheck``, which take the benchmark's root."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from parameter_server_tpu_torch.models import linear as L  # noqa: E402

from psbench.spec import load_cell  # noqa: E402
from psbench.tests.cellcheck import (  # noqa: E402
    cell_faults,
    cells,
    check_agrees,
    check_control,
    check_fault,
    fault_ids,
    run_tiny,
)

CELLS = cells()
FAULT_CASES = cell_faults()
LINEAR = [c for c in CELLS if load_cell(c).app == "linear_1chip"]


@pytest.mark.parametrize("cell", CELLS)
def test_cell_agrees_with_its_reference(cell):
    check_agrees(cell)


@pytest.mark.parametrize(("cell", "fault"), FAULT_CASES, ids=fault_ids(FAULT_CASES))
def test_fault_is_not_correct(cell, fault, monkeypatch):
    check_fault(cell, fault, monkeypatch)


@pytest.mark.parametrize("cell", LINEAR)
def test_checked_steps_run_as_the_window_runs(cell, monkeypatch):
    """The checked steps and the window go through ``LinearMethod.train``
    alike: one call over a stream of batches at one report cadence."""
    calls = []
    train = L.LinearMethod.train

    def spy(self, batches, report_every=50):
        seen = []

        def counted():
            for b in batches:
                seen.append(b)
                yield b

        out = train(self, counted(), report_every=report_every)
        calls.append((len(seen), report_every, type(batches).__name__))
        return out

    monkeypatch.setattr(L.LinearMethod, "train", spy)
    out = run_tiny(cell)
    assert out["correct"], out["checks"]
    assert len(calls) == 2, calls
    (checked, every0, kind0), (window, every1, kind1) = calls
    assert checked == 3 and window == out["attempted"] > 0
    assert every0 == every1 and kind0 == kind1 == "generator"


# -- the controls at a tiny size (the card's run is test_psbench_control) ----


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    check_control(cell)
