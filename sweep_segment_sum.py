"""Darlin's segment sums on the card: atomics against lanes.

Darlin sums each column block's entries by feature (g, h) and by example
(Xd). On the card ``index_add_`` does that with atomic adds, whose order,
and so whose float32 rounding, changes from run to run; the solver's
``_lane_segment_sum`` deals an id's entries over lanes, sums each lane
with ``index_put_(..., accumulate=True)`` (sorted, in entry order) and the
lanes in one fixed reduction. This script holds the three ways against
each other at ``chip_smoke.py`` phase 15 (a)'s shape (RCV1's rows hashed
into 2^16 keys in 16 blocks):

- ``sums``: on three blocks (the largest, the one with the hottest id,
  a small one), the g sum by feature and the Xd sum by example: ms a sum
  by CUDA events, whether 4 calls give the same bits, and g's largest
  distance from the float64 sum; ``index_put_`` with one lane on g alone
  (it walks the hot id's entries in sequence);
- ``solves``: two 20-pass solves with the lane sums and two with
  ``index_add_``: seconds each and how far apart their histories are.

Run from the root of a checkout on a machine with one NVIDIA card:

    python3 sweep_segment_sum.py

It prints the card's name and power limit and one JSON line a part, and
writes nothing.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
BLOCKS = (10, 6, 8)  # the largest, the hottest id's, a small one


def atomic(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, ids, x)


def one_lane(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros(n, dtype=x.dtype, device=x.device)
    return out.index_put_((ids.long(),), x, accumulate=True)


def event_ms(f, reps: int) -> float:
    f()
    torch.cuda.synchronize()
    s, e = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    s.record()
    for _ in range(reps):
        f()
    e.record()
    torch.cuda.synchronize()
    return s.elapsed_time(e) / reps


def sums(dm, cb, dev, n_examples: int) -> dict:
    ext = dm.block_extents(cb.values)
    gen = torch.Generator(device=dev).manual_seed(15)
    err = torch.randn(n_examples, device=dev, generator=gen)
    out = {}
    for b in BLOCKS:
        fl, rows, vals = (torch.tensor(a[b][: ext[b]], device=dev)
                          for a in (cb.feat_local, cb.rows, cb.values))
        x = vals * err.index_select(0, rows)
        exact = torch.zeros(cb.block_size, dtype=torch.float64).index_add_(
            0, fl.long().cpu(), x.double().cpu())
        r: dict = {"entries": ext[b], "hottest": int(torch.bincount(fl.long()).max())}
        ways = (("atomic", atomic, 10), ("lanes", dm._lane_segment_sum, 10),
                ("one_lane", one_lane, 3))
        for name, f, reps in ways:
            g = [f(x, fl, cb.block_size) for _ in range(4)]
            r[name] = {"g_ms": event_ms(lambda: f(x, fl, cb.block_size), reps),
                       "g_repeats": all(torch.equal(g[0], t) for t in g),
                       "g_err": float((g[0].double().cpu() - exact).abs().max())}
            if name != "one_lane":
                xd = [f(x, rows, n_examples) for _ in range(4)]
                r[name].update(xd_ms=event_ms(lambda: f(x, rows, n_examples), reps),
                               xd_repeats=all(torch.equal(xd[0], t) for t in xd))
        out[b] = r
    return out


def solves(dm, cs, cb, dev) -> dict:
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    quiet = ProgressReporter(print_fn=lambda s: None)
    dm.Darlin(cs.darlin_cfg(block_iters=1), reporter=quiet, device=dev).fit_blocks(cb)
    out = {}
    lanes = dm._segment_sum
    for name, f in (("lanes", lanes), ("atomic", atomic)):
        dm._segment_sum = f
        runs = []
        try:
            for _ in range(2):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                res = dm.Darlin(cs.darlin_cfg(), reporter=quiet, device=dev).fit_blocks(cb)
                torch.cuda.synchronize()
                runs.append((time.perf_counter() - t0, np.asarray(res["history"])))
        finally:
            dm._segment_sum = lanes
        (t1, h1), (t2, h2) = runs
        out[name] = {"seconds": [t1, t2], "passes": len(h1),
                     "apart": float(np.max(np.abs(h1 - h2) / np.abs(h2)))}
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("sweep_segment_sum: needs an NVIDIA card", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT))
    import chip_smoke as cs
    from parameter_server_tpu_torch.data.blockcache import ColumnBlocks
    from parameter_server_tpu_torch.models import darlin as dm

    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    print(smi, flush=True)
    dev = torch.device("cuda")
    rows = cs.rcv1_rows(dev)
    cb = ColumnBlocks.from_batches(cs.darlin_batches(rows, cs.RCV1_EXAMPLES), cs.DARLIN_KEYS,
                                   cs.DARLIN_BLOCKS)
    print(json.dumps({"sums": sums(dm, cb, dev, cs.RCV1_EXAMPLES)}), flush=True)
    print(json.dumps({"solves": solves(dm, cs, cb, dev)}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
