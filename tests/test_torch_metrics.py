"""``metrics.auc_tensor`` and ``metrics.auc`` (which reads ``auc_tensor`` on
the CPU) against the JAX package's numpy rank-statistic ``auc``, and the
report of ``LinearMethod.train`` that computes its AUC with it, on the CPU.

``auc_tensor`` counts the same pairs as the rank statistic in exact
integers and makes the same final float64 division, so they must agree
bit for bit (``==`` on the float, NaN on both sides where a class is
empty)."""

import math

import numpy as np
import pytest
import torch

from parameter_server_tpu.models import metrics as JM
from parameter_server_tpu_torch.data.batch import BatchBuilder
from parameter_server_tpu_torch.data.synthetic import make_sparse_logistic
from parameter_server_tpu_torch.models import linear as L
from parameter_server_tpu_torch.models import metrics as M
from parameter_server_tpu_torch.utils import trace
from parameter_server_tpu_torch.utils.config import PSConfig
from parameter_server_tpu_torch.utils.metrics import ProgressReporter

B = 128


def _same(a: float, b: float) -> bool:
    return a == b or (math.isnan(a) and math.isnan(b))


def _case(kind: str, n: int, seed: int) -> tuple[np.ndarray, np.ndarray]:
    rng = np.random.default_rng(seed)
    scores = rng.random(n, dtype=np.float32)
    labels = (rng.random(n) < 0.27).astype(np.float32)
    if kind == "ties":
        scores = np.round(scores * 64).astype(np.float32) / 64
    elif kind == "equal":
        scores[:] = 0.5
    elif kind == "one_class":
        labels[:] = 1.0
    return labels, scores


@pytest.mark.parametrize("n", [1, 2, 4096])
@pytest.mark.parametrize("kind", ["random", "ties", "equal", "one_class"])
def test_auc_tensor_equals_auc(kind, n):
    for seed in range(4):
        labels, scores = _case(kind, n, seed)
        if n == 2 and kind != "one_class":
            labels = np.array([seed % 2, 1 - seed % 2], dtype=np.float32)
        got = M.auc_tensor(torch.from_numpy(labels), torch.from_numpy(scores))
        assert got.dtype == torch.float64 and got.dim() == 0
        want = JM.auc(labels, scores)
        assert _same(got.item(), want), (seed, got.item(), want)
        assert _same(M.auc(labels, scores), want), seed
    if kind == "one_class":
        assert math.isnan(want)


def _app_and_batches(n_batches: int = 8):
    labels, keys, vals, _ = make_sparse_logistic(
        B * n_batches, 1500, nnz_per_example=12, noise=0.3, seed=21)
    builder = BatchBuilder(num_keys=4096, batch_size=B, max_nnz_per_example=48)
    # the last batch is short, so a report also ranks fewer than its steps' slots
    ends = [min(i + B, B * n_batches - 37) for i in range(0, B * n_batches, B)]
    batches = [builder.build(labels[i:e], keys[i:e], vals[i:e])
               for i, e in zip(range(0, B * n_batches, B), ends)]
    cfg = PSConfig()
    cfg.data.num_keys = 4096
    cfg.solver.minibatch = B
    cfg.data.max_nnz_per_example = 48
    app = L.LinearMethod(cfg, ProgressReporter(print_fn=lambda s: None), device="cpu")
    return app, batches


@pytest.mark.parametrize("report_every", [1, 3, 8])
def test_report_auc_equals_auc_over_its_window(report_every, monkeypatch):
    """Each report's ``auc`` is ``metrics.auc`` over the labels and the
    probabilities of its window's steps (the first step's probabilities are
    all 0.5, one tie)."""
    app, batches = _app_and_batches()
    probs = []
    step = L.train_step

    def train_step(updater, state, batch):
        state, out = step(updater, state, batch)
        probs.append(out["probs"].clone())
        return state, out

    monkeypatch.setattr(L, "train_step", train_step)
    app.train(batches, report_every=report_every)
    hist = app.reporter.history
    assert len(hist) == -(-len(batches) // report_every)
    for r, rec in enumerate(hist):
        window = range(r * report_every, min((r + 1) * report_every, len(batches)))
        y = np.concatenate([batches[i].labels[: batches[i].num_examples] for i in window])
        p = np.concatenate([probs[i][: batches[i].num_examples].numpy() for i in window])
        assert rec["auc"] == M.auc(y, p), r
        assert rec["examples"] == sum(b.num_examples for b in batches[: window[-1] + 1])


@pytest.mark.parametrize("report_every", [3, 8])
def test_report_counts_the_examples_it_ranked(report_every):
    """Under the profiler, ``linear.report.ranked`` records once a report,
    inside its ``linear.report.auc``, and sums to the examples seen."""
    from torch.profiler import ProfilerActivity, profile

    app, batches = _app_and_batches()
    trace.configure(None)
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            app.train(iter(batches), report_every=report_every)
        ring = trace.tracer.events()
    finally:
        trace.configure(None)
    ranked = [e for e in ring if e["ph"] == "C" and e["name"] == "linear.report.ranked"]
    auc_spans = [e for e in ring if e["ph"] == "X" and e["name"] == "linear.report.auc"]
    assert len(ranked) == len(auc_spans) == -(-len(batches) // report_every)
    assert sum(e["args"]["value"] for e in ranked) == app.examples_seen
    for c in ranked:
        assert any(s["ts"] <= c["ts"] <= s["ts"] + s["dur"] for s in auc_spans)
