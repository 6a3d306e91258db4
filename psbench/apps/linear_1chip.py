"""One card that holds the whole table: the port's ``LinearMethod`` (sparse
logistic regression under FTRL-proximal) trains on Criteo-shaped batches.

The mix's ``batches`` are built by the port's ``BatchBuilder`` in set-up
and cycled through the window.

``correct``: set-up builds one ``LinearMethod`` and drives its first three
steps, on batches 0-2 of the feed, through one ``LinearMethod.train`` call
with the window's feed and report cadence, as the window drives its
steps: queued without a host sync, read back only at the report. Between
steps, when the call asks its feed for the next batch, the harness queues
the sums of the state on the device behind the step just launched, and
reads them after the call. The call's report gives the mean loss of the
three steps (the program reads a step's loss back only at a report); the
sums give the first gradient's norm (from n after one step: n = g^2) and
the norms of z and n after each step. The same object then runs the
window. After the window the plain reference trains three steps from the
same raw rows (``reference/ftrl.py``) and the gaps are held to the
configuration's limits.

``TINY`` shrinks the cell for the CPU tests; ``FAULTS`` breaks the timed
path underneath, in the port, for the tests that see ``correct`` come out
false."""

from __future__ import annotations

import math
import statistics
import time
from typing import Any

import numpy as np
import torch

from parameter_server_tpu_torch.models import linear as L
from psbench.checks import checks_from, norm_gap, rel_gap
from psbench.devtrace import Profiled
from psbench.reference import ftrl as ref
from psbench.rows import CriteoRows

CHECK_STEPS = 3
REPORT_EVERY = 50  # the window's report cadence, which the checked steps share
SLICE = 1 << 24
TINY = {"num_keys": 1 << 16, "batch_size": 256, "batches": 8}


def _port_config(cfg: dict, batch: int):
    from parameter_server_tpu_torch.utils.config import PSConfig

    pc = PSConfig()
    pc.data.num_keys = int(cfg["num_keys"])
    pc.solver.minibatch = batch
    pc.solver.algo = "ftrl"
    f = cfg["ftrl"]
    pc.lr.alpha, pc.lr.beta = f["alpha"], f["beta"]
    pc.penalty.lambda_l1, pc.penalty.lambda_l2 = f["lambda_l1"], f["lambda_l2"]
    return pc


def _state_sums(state, torch):
    """[sum z^2, sum n^2, sum n] of the whole table in float64, queued on the
    device (no host sync), in slices so that no float64 copy of the table is
    made."""
    z, n = state["z"].reshape(-1), state["n"].reshape(-1)
    acc = torch.zeros(3, dtype=torch.float64, device=z.device)
    for zc, nc in zip(z.split(SLICE), n.split(SLICE)):
        zc, nc = zc.double(), nc.double()
        acc += torch.stack([torch.dot(zc, zc), torch.dot(nc, nc), nc.sum()])
    return acc


def _gaps(got: dict, want: dict) -> dict[str, float]:
    """The numbers compared: the mean loss of the checked steps, the first
    gradient's norm, and the worst step's gap of the norms of z and n."""
    return {
        "loss_gap": rel_gap(got["loss"], statistics.fmean(want["loss"])),
        "grad_norm_gap": rel_gap(got["grad_norm"], want["grad_norm"]),
        "change_gap": max(norm_gap(g, {"z": z, "n": n}) for g, z, n in
                          zip(got["norms"], want["z_norm"], want["n_norm"], strict=True)),
    }


def run(cell, seed: int, seconds: float, traced: bool, device: str, workdir,
        t_start: float, log) -> dict[str, Any]:
    import torch

    from parameter_server_tpu_torch.models.linear import LinearMethod
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    cfg, mix = cell.config, cell.traffic
    gen = CriteoRows(cfg)
    size, count = int(mix["batch_size"]), int(mix["batches"])
    fields = gen.fields
    raw = [gen.batch(seed, 0, i, size) for i in range(count)]
    keys = [r.ids.ravel().astype(np.uint64) for r in raw]
    slots = gen.slots(size)
    splits = np.arange(0, size * fields + 1, fields, dtype=np.int64)
    vals = np.ones(size * fields, dtype=np.float32)

    log(f"set-up: rows made at {time.monotonic() - t_start:.3f} s")
    lm = LinearMethod(_port_config(cfg, size), reporter=ProgressReporter(print_fn=log),
                      device=device)
    builder = lm.make_builder("hash")

    cached = [builder.build_flat(r.labels, splits, k, vals, slots) for r, k in zip(raw, keys)]
    fed = [0]

    def feed(first: int, more):
        """Batches ``first``, ``first + 1``, ... (cycled) while ``more(i)``
        holds."""
        i = first
        while more(i):
            fed[0] = i + 1
            yield cached[i % count]
            i += 1

    log(f"set-up: table and batches ready at {time.monotonic() - t_start:.3f} s")
    # the first steps, through the window's own call, feed and cadence; a
    # step's state is summed once the call asks for the next batch, that is
    # once the step has been queued
    sums = []

    def checked(i: int) -> bool:
        if i:
            sums.append(_state_sums(lm.store.state, torch))
        return i < CHECK_STEPS

    objv = float(lm.train(feed(0, checked), report_every=REPORT_EVERY)["objv"])
    sums = torch.stack(sums).tolist()
    got = {
        "loss": objv,
        "grad_norm": math.sqrt(sums[0][2]),
        "norms": [{"z": math.sqrt(s[0]), "n": math.sqrt(s[1])} for s in sums],
    }
    sync = torch.cuda.synchronize if device != "cpu" else (lambda: None)
    sync()
    setup_s = time.monotonic() - t_start

    ex0 = lm.examples_seen
    with Profiled(traced, workdir, device) as prof:
        t0 = time.monotonic()
        deadline = t0 + seconds
        last = lm.train(feed(CHECK_STEPS, lambda i: time.monotonic() < deadline),
                        report_every=REPORT_EVERY)
        sync()
        t1 = time.monotonic()
    step = fed[0]
    steps = step - CHECK_STEPS
    examples = lm.examples_seen - ex0
    log(f"window: {steps} steps, {examples} examples in {t1 - t0:.6f} s; "
        f"progressive AUC {last.get('auc')}")
    peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
    del lm, cached, builder
    if device != "cpu":
        torch.cuda.empty_cache()

    want = ref.lr_steps(
        [gen.global_keys(raw[i], cfg["num_keys"]) for i in range(CHECK_STEPS)],
        [raw[i].labels for i in range(CHECK_STEPS)],
        ref.Hyper.of(cfg),
    )
    values = _gaps(got, want)

    ctx: dict[str, Any] = {"steps": steps, "trace": prof.trace}
    if traced:
        uniq: dict[int, int] = {}
        for i in range(CHECK_STEPS, step):
            j = i % count
            if j not in uniq:
                uniq[j] = len(np.unique(gen.global_keys(raw[j], cfg["num_keys"])))
        ctx["lr_steps"] = [(size, size * fields, uniq[i % count])
                           for i in range(CHECK_STEPS, step)]
    return {
        "e2e": {"setup_s": setup_s, "examples_per_s": examples / (t1 - t0)},
        "attempted": steps,
        "failed": 0,
        "checks": checks_from(values, cfg["limits"]),
        "memory_peak_bytes": peak,
        "ctx": ctx,
        "trace": prof.trace,
    }


def control(cell, seed: int) -> dict[str, float]:
    """The control's readings: the reference computed in bfloat16 in the
    program's place, held against the float64 reference on the same rows."""
    import torch

    cfg = cell.config
    gen = CriteoRows(cfg)
    size = int(cell.traffic["batch_size"])
    raw = [gen.batch(seed, 0, i, size) for i in range(CHECK_STEPS)]
    keys = [gen.global_keys(r, cfg["num_keys"]) for r in raw]
    labels = [r.labels for r in raw]
    h = ref.Hyper.of(cfg)
    want = ref.lr_steps(keys, labels, h)
    low = ref.lr_steps(keys, labels, h, dtype=torch.bfloat16)
    return _gaps({"loss": statistics.fmean(low["loss"]), "grad_norm": low["grad_norm"],
                  "norms": [{"z": z, "n": n} for z, n in zip(low["z_norm"], low["n_norm"])]},
                 want)


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


FAULTS = {
    "unchanged": lambda mp: mp.setattr(L, "train_step", _unchanged_step),
    "half_batch": lambda mp: mp.setattr(L, "logistic_loss", _half_batch_loss(L.logistic_loss)),
    "altered": lambda mp: mp.setattr(L, "logistic_loss", _altered_loss(L.logistic_loss)),
}
