"""Each cell against its plain reference on the CPU at a tiny size, and each
fault a cell can have: the run is driven as the benchmark drives it (the
look for a card skipped), with the timed path broken underneath, and
``correct`` has to come out false."""

from __future__ import annotations

import json
import sys
from pathlib import Path

import pytest
import torch

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from parameter_server_tpu_torch.models import linear as L  # noqa: E402

from psbench.checks import checks_from  # noqa: E402
from psbench.run import run_cell  # noqa: E402
from psbench.spec import app_module, load_cell  # noqa: E402

TINY = {"num_keys": 1 << 16, "batch_size": 256, "batches": 8}
CELLS = [w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"]]
SEED = (1 << 31) + 12345


def _run(cell: str, seed: int = SEED) -> dict:
    return run_cell(cell, seed, 1.0, False, device="cpu", overrides=dict(TINY))


@pytest.mark.parametrize("cell", CELLS)
def test_cell_agrees_with_its_reference(cell):
    out = _run(cell)
    assert out["correct"], out["checks"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "checks"


def _unchanged_step(updater, state, batch):
    """A step that computes everything and returns the state unchanged."""
    rows, logits = L._forward(updater, state, batch)
    loss, _ = L.logistic_loss(logits, batch["labels"], batch["example_mask"])
    return state, {"loss_sum": loss, "probs": torch.sigmoid(logits), "logits": logits}


def _half_batch_loss(orig):
    def loss(logits, labels, mask):
        total, err = orig(logits, labels, mask)
        half = logits.shape[0] // 2
        err = torch.cat([2.0 * err[:half], torch.zeros_like(err[half:])])
        return total, err
    return loss


def _altered_loss(orig):
    def loss(logits, labels, mask):
        total, err = orig(logits, labels, mask)
        return total * 1.001, err
    return loss


@pytest.mark.parametrize("cell", CELLS)
@pytest.mark.parametrize("fault", ["unchanged", "half_batch", "altered"])
def test_lr_fault_is_not_correct(cell, fault, monkeypatch):
    if fault == "unchanged":
        monkeypatch.setattr(L, "train_step", _unchanged_step)
    elif fault == "half_batch":
        monkeypatch.setattr(L, "logistic_loss", _half_batch_loss(L.logistic_loss))
    else:
        monkeypatch.setattr(L, "logistic_loss", _altered_loss(L.logistic_loss))
    out = _run(cell)
    assert not out["correct"], out["checks"]


def test_checked_steps_run_as_the_window_runs(monkeypatch):
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
    out = _run(CELLS[0])
    assert out["correct"], out["checks"]
    assert len(calls) == 2, calls
    (checked, every0, kind0), (window, every1, kind1) = calls
    assert checked == 3 and window == out["attempted"] > 0
    assert every0 == every1 and kind0 == kind1 == "generator"


# -- the controls at a tiny size (the card's run is test_psbench_control) ----


@pytest.mark.parametrize("cell", CELLS)
def test_control_is_not_correct(cell):
    c = load_cell(cell)
    c.config.update(num_keys=TINY["num_keys"])
    c.traffic.update(batch_size=TINY["batch_size"])
    low = app_module(c).control(c, SEED)
    assert not all(ch.ok for ch in checks_from(low, c.config["limits"])), low
