"""The program's own spans and counters in a traced run of the cell, and the
readers that turn them into per-layer metrics, on the CPU: a tiny copy of
the cell driven as the benchmark drives it, then each reader against values
counted by hand on a synthetic device trace and tracer ring."""

from __future__ import annotations

import sys
from pathlib import Path

import pytest
import torch
from torch.profiler import ProfilerActivity, profile

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from parameter_server_tpu_torch.models import linear as L  # noqa: E402
from parameter_server_tpu_torch.utils import trace  # noqa: E402

from psbench import spec  # noqa: E402
from psbench.apps.linear_1chip import TINY  # noqa: E402
from psbench.devtrace import DeviceTrace  # noqa: E402
from psbench.run import run_cell  # noqa: E402

CELL = "lr.cached_b8192"
SEED = (1 << 31) + 4242
NEW = ("report_host_ms", "h2d_ms", "launch_ms", "pad_slot_share", "idle_unattributed")


@pytest.fixture(autouse=True)
def _fresh_ring():
    trace.configure(None)
    yield
    trace.configure(None)


@pytest.fixture
def traced(monkeypatch):
    """One traced run of a tiny copy of the cell: its result line, the
    context its readers saw, and (slots, real unique keys) of each batch
    that a step of the profiled window copied to the device."""
    fed, seen = [], {}
    copy, readers = L.batch_to_device, spec.read_per_layer

    def batch_to_device(b, device):
        if torch.autograd.profiler._is_profiler_enabled:
            fed.append((len(b.unique_keys), b.num_unique))
        return copy(b, device)

    def read_per_layer(cell, ctx):
        seen.update(ctx)
        return readers(cell, ctx)

    monkeypatch.setattr(L, "batch_to_device", batch_to_device)
    monkeypatch.setattr(spec, "read_per_layer", read_per_layer)
    out = run_cell(CELL, SEED, 1.0, True, device="cpu", overrides=dict(TINY))
    return out, seen, fed


def _inside(child, parents) -> bool:
    return any(s <= child[0] and child[1] <= e for s, e, _ in parents)


def test_the_window_holds_one_step_span_a_step(traced):
    out, ctx, _ = traced
    assert out["correct"], out["checks"]
    host = ctx["trace"].host
    by = {n: [h for h in host if h[2] == n] for n in {h[2] for h in host}}
    assert len(by["linear.step"]) == ctx["steps"] == out["attempted"] > 0
    for child, parent in (("linear.h2d", "linear.step"), ("linear.launch", "linear.step"),
                          ("linear.report.readback", "linear.report"),
                          ("linear.report.auc", "linear.report")):
        assert by[child] and all(_inside(c, by[parent]) for c in by[child]), child
    assert not any(_inside(r, by["linear.step"]) for r in by["linear.report"])
    ring = [e["name"] for e in trace.tracer.events() if e["ph"] == "X"]
    assert ring.count("linear.step") == ctx["steps"]


def test_the_traced_line_reports_the_program_metrics(traced):
    out, _, _ = traced
    # the CPU has no device intervals: idle_unattributed, like device_idle,
    # has nothing to read here
    assert {"report_host_ms", "h2d_ms", "launch_ms", "pad_slot_share"} <= set(out["metrics"])
    assert "idle_unattributed" not in out["metrics"]
    assert all(out["metrics"][m]["value"] >= 0 for m in NEW if m in out["metrics"])


def test_pad_slot_share_is_the_batches_own(traced):
    out, ctx, fed = traced
    assert len(fed) == ctx["steps"]
    want = 100.0 * (1.0 - sum(u for _, u in fed) / sum(s for s, _ in fed))
    assert out["metrics"]["pad_slot_share"]["value"] == pytest.approx(want, rel=1e-12)


# -- the readers against hand counts ------------------------------------------


def _synthetic_trace() -> DeviceTrace:
    """A 10 s window: the device busy over [1, 2], [4, 5] and [8, 9], so
    idle over [0, 1], [2, 4], [5, 8] and [9, 10] (7 s); two steps and one
    report of the program's spans cover [0.5, 8.5]."""
    host = [
        (0.5, 3.0, "linear.step"), (0.5, 1.0, "linear.h2d"), (1.0, 1.5, "linear.launch"),
        (1.5, 3.0, "linear.fetch"),
        (3.0, 4.5, "linear.step"), (3.0, 3.2, "linear.h2d"), (3.2, 3.6, "linear.launch"),
        (3.6, 4.5, "linear.fetch"),
        (4.5, 8.5, "linear.report"), (4.5, 5.5, "linear.report.readback"),
        (5.5, 8.0, "linear.report.auc"),
        (9.2, 9.8, "aten::add"),
    ]
    return DeviceTrace((0.0, 10.0), [(1.0, 2.0), (4.0, 5.0), (8.0, 9.0)], {}, host)


def _synthetic_ring() -> None:
    """Two steps' spans and counters (100 slots with 90 pads, then 200 with
    150) recorded by the port's tracer under the profiler, no dir armed."""
    with profile(activities=[ProfilerActivity.CPU]):
        for slots, pads in ((100, 90), (200, 150)):
            with trace.span("linear.step", cat="step"):
                trace.counter("linear.slots", slots, cat="step")
                trace.counter("linear.pad_slots", pads, cat="step")


HAND = {
    "report_host_ms": (4.0 - 1.0) / 2 * 1e3,
    "h2d_ms": (0.5 + 0.2) / 2 * 1e3,
    "launch_ms": (0.5 + 0.4) / 2 * 1e3,
    "pad_slot_share": 100.0 * (90 + 150) / (100 + 200),
    # covered: 0.5 of [0, 1], all of [2, 4] and [5, 8], none of [9, 10]
    "idle_unattributed": 100.0 * (1.0 - 5.5 / 7.0),
}


@pytest.mark.parametrize("name", NEW)
def test_reader_matches_the_hand_count(name):
    _synthetic_ring()
    got = spec.metric_reader(name).read({"trace": _synthetic_trace(), "steps": 2})
    assert got == pytest.approx(HAND[name], rel=1e-12)


@pytest.mark.parametrize("name", NEW)
def test_reader_reports_nothing_unless_a_step_span_a_step(name):
    """A window whose trace or ring holds another count of ``linear.step``
    spans than its steps (an overflowed ring, a program without the
    spans) reports nothing rather than a wrong number."""
    read = spec.metric_reader(name).read
    bare = _synthetic_trace()
    bare.host = [h for h in bare.host if not h[2].startswith("linear.")]
    # the program before it had spans: none in the trace, none in the ring
    assert read({"trace": bare, "steps": 2}) is None
    _synthetic_ring()
    assert read({"trace": _synthetic_trace(), "steps": 3}) is None
    assert read({"trace": None, "steps": 2}) is None
