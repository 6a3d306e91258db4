"""The dense logistic model of ``second_app/program.py`` on one device.

Set-up draws every batch from the seed, then drives the first three steps
through the model's own ``train``, reading the weights' norm after each.
The same object runs the window. After it the plain reference
(``reference/dense_lr.py``) trains three steps from the same batches, and
the worst step's gaps of loss and of the weights' norm are held to the
configuration's limits."""

from __future__ import annotations

import math
import time
from typing import Any

import torch

from psbench.checks import checks_from, rel_gap
from psbench.devtrace import Profiled
from psbench.tests.second_app import program

CHECK_STEPS = 3
TINY = {"batch_size": 256}


def _batches(cell, seed: int, device: str):
    cfg, mix = cell.config, cell.traffic
    f, size, count = int(cfg["features"]), int(mix["batch_size"]), int(mix["batches"])
    g = torch.Generator(device=device).manual_seed(seed)
    x = torch.randn(count, size, f, generator=g, device=device)
    truth = torch.randn(f, generator=g, device=device) / math.sqrt(f)
    y = torch.bernoulli(torch.sigmoid(x @ truth), generator=g)
    return list(zip(x.unbind(), y.unbind()))


def _gaps(got: dict, want: dict) -> dict[str, float]:
    return {
        "loss_gap": max(rel_gap(g, w) for g, w in zip(got["loss"], want["loss"], strict=True)),
        "change_gap": max(rel_gap(g, w)
                          for g, w in zip(got["w_norm"], want["w_norm"], strict=True)),
    }


def _reference(cell, batches, dtype=torch.float64) -> dict[str, list[float]]:
    from psbench.reference import dense_lr as ref

    xs, ys = zip(*batches[:CHECK_STEPS])
    return ref.sgd_steps(xs, ys, float(cell.config["lr"]), dtype)


def run(cell, seed: int, seconds: float, traced: bool, device: str, workdir,
        t_start: float, log) -> dict[str, Any]:
    batches = _batches(cell, seed, device)
    model = program.DenseLR(int(cell.config["features"]), float(cell.config["lr"]), device)
    got: dict[str, list[float]] = {"loss": [], "w_norm": []}
    for b in batches[:CHECK_STEPS]:
        got["loss"] += model.train([b])
        got["w_norm"].append(float(model.w.double().norm()))
    setup_s = time.monotonic() - t_start

    size, steps = batches[0][1].shape[0], 0
    with Profiled(traced, workdir, device) as prof:
        t0 = time.monotonic()
        while time.monotonic() < t0 + seconds:
            model.train(batches)
            steps += len(batches)
        t1 = time.monotonic()
    values = _gaps(got, _reference(cell, batches))
    return {
        "e2e": {"setup_s": setup_s, "examples_per_s": steps * size / (t1 - t0)},
        "attempted": steps,
        "failed": 0,
        "checks": checks_from(values, cell.config["limits"]),
        "memory_peak_bytes": torch.cuda.max_memory_allocated() if device != "cpu" else 0,
        "ctx": {"steps": steps, "trace": prof.trace, "dense_steps": steps},
        "trace": prof.trace,
    }


def control(cell, seed: int) -> dict[str, float]:
    """The reference computed in bfloat16 in the program's place, held
    against the float64 reference on the same batches."""
    batches = _batches(cell, seed, "cpu")
    return _gaps(_reference(cell, batches, torch.bfloat16), _reference(cell, batches))


def _stale_step(w, x, y, lr):
    """A step that computes the loss and returns the weights unchanged."""
    return w, torch.nn.functional.binary_cross_entropy_with_logits(x @ w, y)


FAULTS = {"stale_weights": lambda mp: mp.setattr(program, "step", _stale_step)}
