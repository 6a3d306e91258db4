"""Phase 12 (a)'s wire pushes on the card, in a fresh process of any tree.

Runs, from the tree at ``--root`` (default: this file's directory), with
that tree's ``chip_smoke.py`` inputs and helpers and its package:

- the deterministic arm: 48 FTRL pushes (phase 12 (a)'s 24, twice, as
  phase 17 (c) sends them) one at a time through 2 loopback card servers
  of 2^26 rows each, the pull of every touched key held against the CPU
  replay. It prints pushes/s three ways: over pushes 9-24 (what phase 12
  (a) times, after its 8 profiled pushes), over pushes 1-24 (phase 16
  (c)) and over all 48 (phase 17 (c)); p50/p99 over all 48, and the mean
  latency of the first 8 against that of the rest;
- the concurrent arm: 8 handles x 12 pipelined pushes into an SGD table
  (``chip_smoke.wire_concurrent``): pushes/s, p50/p99, apply batches and
  pushes coalesced.

Where the tree's package has the key-heat sketch (``utils/metrics.py``
``key_heat``), it also times ``KeyHeatSketch.add`` on a fresh sketch fed
what the 2 servers feed it in the deterministic arm (each server's share
of each push, offset to global keys), and reports ms a push. With
``--no-heat`` the sketch's ``add`` is replaced by a no-op for the whole
run: a diagnostic that attributes its cost, not a mode of the program.

With ``--warm S`` the card first runs matrix products for S seconds
before each arm, so the arm starts at the clocks of a loaded card (each
arm is preceded by ``nvidia-smi``'s pstate and SM clock either way): the
pushes launch tiny kernels and wait on small copies, which a card that
has idled down answers more slowly.

With ``--cluster N`` it instead runs phase 13 (b)'s asynchronous
``cli launch`` (2 card servers, 2 workers, max_delay 1, over phase 13's
8 libsvm files) N times and prints each run's validation AUC, its apply
batches and pushes coalesced: over 8 steps the AUC depends on how the
two workers' steps interleave, which host time a push moves.

Run from any directory on a machine with one NVIDIA card and nvcc:

    python3 sweep_wire.py [--root DIR] [--reps N] [--no-heat] [--warm S]
    python3 sweep_wire.py [--root DIR] --cluster N

To compare two commits, unpack the other with ``git archive`` into a
directory that ``.gitignore`` lists, and run parent, change, change,
parent, each in its own process, in one session on the card. It builds
the kernels under the tree's ``parameter_server_tpu_torch/_build/``, prints
the card's name and power limit, and writes nothing else.
"""

from __future__ import annotations

import argparse
import subprocess
import sys
import time
from pathlib import Path


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--root", default=str(Path(__file__).resolve().parent))
    ap.add_argument("--reps", type=int, default=2)
    ap.add_argument("--no-heat", action="store_true")
    ap.add_argument("--warm", type=float, default=0.0)
    ap.add_argument("--cluster", type=int, default=0)
    args = ap.parse_args()
    root = Path(args.root).resolve()
    sys.path.insert(0, str(root))

    import numpy as np
    import torch

    import chip_smoke as cs
    from parameter_server_tpu_torch.kv.updaters import Ftrl, Sgd
    from parameter_server_tpu_torch.ops import cuda_build
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.parallel.backend import local_socket_backend
    from parameter_server_tpu_torch.utils import metrics
    from parameter_server_tpu_torch.utils.config import PSConfig

    if not torch.cuda.is_available():
        print("sweep_wire: no CUDA card", file=sys.stderr)
        return 2
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip()
    has_heat = hasattr(metrics, "key_heat")
    if args.no_heat:
        if not has_heat:
            raise SystemExit("--no-heat: this tree has no key_heat")
        metrics.key_heat.add = lambda keys: None
    tag = (f"{root.name}{' no-heat' if args.no_heat else ''}"
           f"{f' warm {args.warm:g} s' if args.warm else ''}")

    def card_state() -> str:
        """Warm the card for --warm seconds, then read its pstate and SM
        clock."""
        if args.warm:
            a = torch.randn(4096, 4096, device="cuda")
            t_end = time.perf_counter() + args.warm
            while time.perf_counter() < t_end:
                for _ in range(8):
                    a = torch.tanh(a @ a)
                torch.cuda.synchronize()
            del a
        return subprocess.run(
            ["nvidia-smi", "--query-gpu=pstate,clocks.sm", "--format=csv,noheader"],
            capture_output=True, text=True, check=True).stdout.strip()

    print(f"[sweep_wire] {tag}: {smi}; torch {torch.__version__}", flush=True)
    cuda_build.build()
    cuda_build.load()
    if args.cluster:
        return cluster(root, tag, args.cluster, cs)
    rng = np.random.default_rng(cs.SEED)
    rounds = [cs.simulated_pushes(rng, cs.SERVER_KEYS, cs.SERVER_WORKERS, cs.SERVER_DRAWS,
                                  4096, 1) for _ in range(cs.SERVER_ROUNDS)]
    pushes = [(k, g) for idx_list, grad_list in rounds for k, g in zip(idx_list, grad_list)]
    n12 = len(pushes)
    pushes = pushes * 2

    def ftrl():
        return Ftrl(alpha=cs.HYPER["alpha"], beta=cs.HYPER["beta"],
                    lambda_l1=cs.HYPER["l1"], lambda_l2=cs.HYPER["l2"])

    for rep in range(args.reps):
        be = local_socket_backend(ftrl, cs.SERVER_KEYS, cs.WIRE_SERVERS, cfg=PSConfig(),
                                  device="cuda")
        try:
            state = card_state()
            torch.cuda.synchronize()
            fk.LAUNCHES["ftrl_push"] = 0
            lat, ends = [], []
            t0 = time.perf_counter()
            for k, g in pushes:
                t1 = time.perf_counter()
                be.push(k, g)
                ends.append(time.perf_counter())
                lat.append(ends[-1] - t1)
            be.flush()
            launches = fk.LAUNCHES["ftrl_push"]
            union, want = cs.cpu_replay(ftrl, pushes, 1)
            err = cs.check_close("sweep_wire pull", torch.from_numpy(be.pull(union)), want)
            ranges = be.ranges
        finally:
            be.close()
        del be
        torch.cuda.empty_cache()
        if launches != cs.WIRE_SERVERS * len(pushes):
            raise AssertionError(f"ftrl_push launched {launches} times, want "
                                 f"{cs.WIRE_SERVERS} x {len(pushes)}")
        lt = cs.latency_ms(lat)
        r12 = (n12 - 8) / (ends[n12 - 1] - ends[7])
        r16 = n12 / (ends[n12 - 1] - t0)
        r17 = len(pushes) / (ends[-1] - t0)
        print(f"[sweep_wire] {tag} rep {rep}: card {state}; deterministic {len(pushes)} "
              f"pushes, K1 {launches}, max abs err {err:.3g}; pushes/s {r12:.1f} "
              f"(9-{n12}), {r16:.1f} (1-{n12}), {r17:.1f} (1-{len(pushes)}); p50 "
              f"{lt['p50_ms']:.3f} / p99 "
              f"{lt['p99_ms']:.3f} ms; first 8 mean {np.mean(lat[:8]) * 1e3:.3f} ms, the "
              f"rest {np.mean(lat[8:]) * 1e3:.3f} ms", flush=True)

        cfg = PSConfig()
        be = local_socket_backend(lambda: Sgd(eta=cs.WIRE_SGD_ETA), cs.SERVER_KEYS,
                                  cs.WIRE_SERVERS, cfg=cfg, device="cuda")
        try:
            state = card_state()
            c = cs.wire_concurrent(be, be.ranges, rounds, cfg)
        finally:
            be.close()
        del be
        torch.cuda.empty_cache()
        print(f"[sweep_wire] {tag} rep {rep}: card {state}; concurrent {c['pushes']} pushes "
              f"{c['pushes_per_s']:.1f} pushes/s, p50 {c['latency']['p50_ms']:.3f} / p99 "
              f"{c['latency']['p99_ms']:.3f} ms, {c['push_coalesced']} coalesced into "
              f"{c['apply_batches']} apply batches", flush=True)

    if has_heat and not args.no_heat:
        sk = metrics.KeyHeatSketch()
        shares = [(k[(k >= r.begin) & (k < r.end)]) for k, _ in pushes for r in ranges]
        t = []
        for keys in shares:
            t1 = time.perf_counter()
            sk.add(keys)
            t.append(time.perf_counter() - t1)
        per_push = np.add.reduceat(np.asarray(t), np.arange(0, len(t), len(ranges))) * 1e3
        print(f"[sweep_wire] {tag}: key_heat.add {np.mean(per_push):.3f} ms a push "
              f"(p50 {np.percentile(per_push, 50):.3f}, max {per_push.max():.3f}) over "
              f"{len(per_push)} pushes of {np.mean([len(k) for k, _ in pushes]):.0f} keys",
              flush=True)
    return 0


def cluster(root: Path, tag: str, runs: int, cs) -> int:
    """Phase 13 (b)'s `cli launch` ``runs`` times over one set of files."""
    import json
    import os
    import tempfile

    ids, y = cs.zipf_rows()
    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = Path(tmp_s)
        files = cs.zipf_row_files(tmp, ids, y, with_val=True)
        files, val = files[:-1], files[-1]
        app = tmp / "async.json"
        app.write_text(json.dumps(cs.cluster_conf(files, val, max_delay=1)))
        env = {**os.environ, "PYTHONPATH": str(root)}
        for i in range(runs):
            proc = subprocess.run(
                [sys.executable, "-m", "parameter_server_tpu_torch.cli", "launch",
                 "--app_file", str(app), "--num_servers", str(cs.CLUSTER_SERVERS),
                 "--num_workers", "2", "--device", "cuda"],
                cwd=tmp, env=env, capture_output=True, text=True,
                timeout=cs.CLUSTER_TIMEOUT_S + 60)
            if proc.returncode != 0:
                raise AssertionError(f"cli launch exited {proc.returncode}:\n"
                                     f"{proc.stderr[-3000:]}")
            b = json.loads(proc.stdout.strip().splitlines()[-1])
            st = b["server_stats"]
            print(f"[sweep_wire] {tag} cluster {i}: val AUC {b['val_auc']:.6f}, apply "
                  f"batches {[s['apply_batches'] for s in st]}, coalesced "
                  f"{[s['push_coalesced'] for s in st]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
