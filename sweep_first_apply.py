"""Where a card shard server's first apply spends its time.

A card ``ShardServer`` loads the kernel library at start; its first apply
still takes far longer than the next. This script splits that first apply
on the card, each arm in a fresh process (a first call is only first
once), under CUDA's lazy module loading (the default) and under
``CUDA_MODULE_LOADING=EAGER``:

- ``whole``: the server's first ``_apply`` of ~16k unique keys (phase 13
  (a)'s server range, 2^23 FTRL rows), then a second one on other keys,
  each ended by a synchronize;
- ``pieces``: the same first apply's steps one at a time, each ended by a
  synchronize: the index's copy to the card, the gradient's, the store's
  int32 conversion of the index, K1's launch on the converted inputs,
  then a whole apply after them.

Each process also reports the CUDA context's creation (a 1-element tensor
on the card) and the server's kernel library load. Run from the root of a
checkout on a machine with one NVIDIA card and nvcc:

    python3 sweep_first_apply.py

It builds the kernels under ``parameter_server_tpu_torch/_build/``,
prints the card's name and power limit and one JSON line an arm, and
writes nothing else.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
RANGE_ROWS = 1 << 23  # phase 13 (a): 2^24 keys over 2 servers
KEYS = 16_000
SEED = 7


def _child(arm: str) -> dict:
    import numpy as np
    import torch

    from parameter_server_tpu_torch.kv import store as kv_store
    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.parallel.multislice import ShardServer
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    def timed(fn):
        t0 = time.perf_counter()
        out = fn()
        torch.cuda.synchronize()
        return out, (time.perf_counter() - t0) * 1e3

    rng = np.random.default_rng(SEED)
    draws = [np.unique(rng.integers(0, RANGE_ROWS, KEYS)) for _ in range(2)]
    grads = [rng.normal(size=len(k)).astype(np.float32) for k in draws]
    dev = torch.device("cuda", 0)
    out: dict = {"arm": arm, "loading": os.environ.get("CUDA_MODULE_LOADING", "LAZY")}
    _, out["context_ms"] = timed(lambda: torch.zeros(1, device=dev))
    upd = Ftrl(alpha=0.1, beta=1.0, lambda_l1=1.0, lambda_l2=0.0)
    srv, out["server_init_ms"] = timed(lambda: ShardServer(
        upd, KeyRange(0, RANGE_ROWS), device="cuda"))
    out["kernel_load_ms"] = srv.kernel_load_s * 1e3
    try:
        if arm == "whole":
            _, out["first_apply_ms"] = timed(lambda: srv._apply(draws[0], grads[0]))
        else:
            idx, out["idx_h2d_ms"] = timed(lambda: torch.from_numpy(draws[0]).to(dev))
            g, out["grad_h2d_ms"] = timed(
                lambda: torch.from_numpy(grads[0]).to(dev).reshape(-1, 1))
            i32, out["idx_int32_ms"] = timed(lambda: idx.to(torch.int32).contiguous())
            _, out["k1_first_ms"] = timed(lambda: kv_store.ftrl_push(
                srv.state["z"], srv.state["n"], i32, g, **upd.hyper))
            _, out["apply_after_pieces_ms"] = timed(lambda: srv._apply(draws[0], grads[0]))
        _, out["second_apply_ms"] = timed(lambda: srv._apply(draws[1], grads[1]))
    finally:
        srv.server.stop()
    return out


def main() -> int:
    if len(sys.argv) == 3 and sys.argv[1] == "--child":
        sys.path.insert(0, str(ROOT))
        print(json.dumps(_child(sys.argv[2])))
        return 0
    sys.path.insert(0, str(ROOT))
    from parameter_server_tpu_torch.ops import cuda_build

    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip(), flush=True)
    cuda_build.build()
    for loading in ("LAZY", "EAGER"):
        for arm in ("whole", "pieces", "whole", "pieces"):
            env = {**os.environ, "CUDA_MODULE_LOADING": loading,
                   "PYTHONPATH": str(ROOT)}
            r = subprocess.run([sys.executable, __file__, "--child", arm], env=env,
                               capture_output=True, text=True, timeout=300)
            if r.returncode != 0:
                print(r.stdout + r.stderr, file=sys.stderr)
                return 1
            print(r.stdout.strip().splitlines()[-1], flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
