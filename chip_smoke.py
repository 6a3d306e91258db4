#!/usr/bin/env python3
"""Chip smoke run of parameter_server_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises and
the script exits nonzero without printing a result:

1. probe   — require a CUDA card; print its name and power limit.
2. build   — compile the port's CUDA kernels (csrc/ftrl.cu, nvcc, sm_90a).
3. kernels — hold each kernel against its plain PyTorch version on the card
             (rtol 1e-5, atol 1e-6; untouched table rows bit-identical; two
             hyperparameter sets, one with l2 > 0) and time both with CUDA
             events beside the kernel's bound, cycling input sets that
             together exceed the L2 cache so each call finds its rows cold.
4. worker  — LinearMethod trains 12 minibatches (8192 examples, 32 nnz per
             example, 2^18 features) against a 2^24-key FTRL table; the
             first 3 steps' loss matches a CPU run of the port (rtol 1e-4).
5. server  — a 2^27-key FTRL KVStore answers coalesced pushes from 8
             simulated workers and pulls of their keys; the pulled weights
             match a CPU plain update of the touched rows.

Launch counters are reset just before the worker and server phases and
read just after: each phase must have launched its kernel. The line before
the last is the kernels' JSON summary; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet): device-memory rate
# and float32 rate outside the tensor cores
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
# flops of one FTRL element update (weight, sigma, both deltas; sqrt and
# division counted as one operation each)
FTRL_FLOPS = 18
RTOL, ATOL = 1e-5, 1e-6
HYPER = {"alpha": 0.1, "beta": 1.0, "l1": 1.0, "l2": 0.0}
# checked only: every term of the kernels' weight, l2 included
HYPER_L2 = {"alpha": 0.3, "beta": 1.0, "l1": 0.5, "l2": 0.1}

WORKER_KEYS = 1 << 24
SERVER_KEYS = 1 << 27
BATCH, NNZ_PER, FEATURES, STEPS = 8192, 32, 1 << 18, 12
SERVER_WORKERS, SERVER_DRAWS, SERVER_ROUNDS = 8, 1 << 14, 3
SEED = 7
# K1 timing: each set is the unique keys of 2^17 uniform draws into the
# server table (bench.py's fused-push cell); 16 sets touch ~150 MB of
# 32-byte sectors, three times the H100's 50 MB L2
PUSH_SETS, PUSH_DRAWS = 16, 1 << 17
# the plain versions issue ~15 launches a call: few enough calls that all
# of them fit the launch queue behind the spin kernel (see cuda_ms)
PLAIN_ITERS = 40


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / F32_FLOPS_PER_S * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, iters: int) -> tuple[float, float]:
    """(device ms, host-inclusive ms) of one call, by CUDA events around
    ``iters`` calls after one warm-up call.

    Host-inclusive: the events bracket the calls as the host issues them,
    so where a call's Python and launch overhead outlasts its kernels the
    device idles in between and the time is the host's. Device: the same
    calls are queued behind a spinning kernel (``torch.cuda._sleep``) long
    enough to cover their issue, so they run back to back and the events
    time the device work alone."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run() -> float:
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host_ms = run()
    issue_s = time.perf_counter() - t0
    # spin for twice the measured issue time at up to 2 GHz
    torch.cuda._sleep(int(2 * issue_s * 2e9))
    return run(), host_ms


def profile(fn) -> tuple[float, float, list]:
    """(wall ms, device-busy ms, top device-time entries) of ``fn`` under
    torch.profiler (CUPTI): the device's busy time is the sum of the
    self device times of everything it ran."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx

    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, copies, fills): CPU-op rows repeat
    # the time of the kernels they launched
    rows = [
        (e.key, e.self_device_time_total / 1e3)
        for e in prof.key_averages()
        if str(e.device_type).endswith(("CUDA", "PrivateUse1"))
    ]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    busy_ms = sum(t for _, t in rows)
    return wall_ms, busy_ms, [(k[:60], round(t, 4)) for k, t in rows[:8]]


def check_close(name: str, got, want) -> float:
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{name}: kernel disagrees with plain, max abs err {err}")
    return err


def bits_changed(a, b):
    """Per-row mask of rows whose bits differ anywhere."""
    return (a.view(torch.int32) != b.view(torch.int32)).reshape(a.shape[0], -1).any(1)


def check_delta(fk, dev, gen, rows: int, vdim: int, hyper: dict = HYPER) -> float:
    """K2 vs its plain version; w == 0 exactly (dz == g) where |z| <= l1."""
    z = torch.randn((rows, vdim), generator=gen, device=dev) * 2
    n = torch.rand((rows, vdim), generator=gen, device=dev) * 4
    g = torch.randn((rows, vdim), generator=gen, device=dev)
    dz, dn = fk.ftrl_delta(z, n, g, **hyper)
    pz, pn = fk.ftrl_delta_plain(z, n, g, **hyper)
    torch.cuda.synchronize()
    err = max(check_close(f"ftrl_delta dz {rows}x{vdim}", dz, pz),
              check_close(f"ftrl_delta dn {rows}x{vdim}", dn, pn))
    inside = z.abs() <= hyper["l1"]
    if not inside.any() or not torch.equal(dz[inside], g[inside]):
        raise AssertionError("ftrl_delta: w must be exactly 0 where |z| <= l1")
    return err


def check_push(fk, dev, gen, idx_np, vdim: int, hyper: dict = HYPER) -> float:
    """K1 vs its plain version on a SERVER_KEYS-row table with random
    state, plus repeated pad slots; rows the push does not touch (and the
    pad row) keep their bits."""
    pads = 37
    idx = torch.from_numpy(
        np.concatenate([idx_np, np.zeros(pads, idx_np.dtype)]).astype(np.int32)
    ).to(dev)
    g = torch.randn((idx.shape[0], vdim), generator=gen, device=dev)
    g[-pads:] = 0.0
    z0 = torch.randn((SERVER_KEYS, vdim), generator=gen, device=dev) * 2
    n0 = torch.rand((SERVER_KEYS, vdim), generator=gen, device=dev) * 4
    zk, nk = z0.clone(), n0.clone()
    fk.ftrl_push(zk, nk, idx, g, **hyper)
    changed = bits_changed(zk, z0) | bits_changed(nk, n0)
    touched = idx[:-pads].long()
    changed[touched] = False
    if changed.any():
        raise AssertionError(
            f"ftrl_push vdim {vdim}: {int(changed.sum())} untouched rows changed"
        )
    del changed
    z_plain, n_plain = fk.ftrl_push_plain(z0, n0, idx, g, **hyper)  # in place
    torch.cuda.synchronize()
    return max(
        check_close(f"ftrl_push z vdim {vdim}", zk[touched], z_plain[touched]),
        check_close(f"ftrl_push n vdim {vdim}", nk[touched], n_plain[touched]),
    )


def server_pushes(rng):
    """One round of pushes from SERVER_WORKERS simulated workers: each draws
    its keys uniformly (as bench.py's fused-push cell) plus a shared hot
    set, so coalescing has duplicate keys to sum."""
    hot = np.arange(1, 4097)
    idx_list, grad_list = [], []
    for _ in range(SERVER_WORKERS):
        keys = np.unique(
            np.concatenate([rng.integers(1, SERVER_KEYS, SERVER_DRAWS), hot])
        )
        idx_list.append(keys)
        grad_list.append(rng.normal(size=(len(keys), 1)).astype(np.float32))
    return idx_list, grad_list


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "parameter_server_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: parameter_server_tpu_torch not found beside this "
              "script; run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from parameter_server_tpu_torch.data.batch import BatchBuilder
    from parameter_server_tpu_torch.data.synthetic import make_sparse_logistic
    from parameter_server_tpu_torch.kv.store import KVStore, coalesce_pushes
    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.models.linear import LinearMethod
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.utils.config import PSConfig
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. probe
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"device {kind}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = fk.build()
    fk._load()
    log(f"built {lib_path.name} in {time.perf_counter() - t0:.2f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"ptxas: {line.strip()}")

    # set-up: the worker's minibatches and the server's pushes (host data,
    # made from the seed as bench.py's headline cell makes them)
    t0 = time.perf_counter()
    labels, keys, vals, _ = make_sparse_logistic(
        BATCH * STEPS, FEATURES, nnz_per_example=NNZ_PER, noise=0.4, seed=SEED
    )
    builder = BatchBuilder(
        num_keys=WORKER_KEYS, batch_size=BATCH, max_nnz_per_example=4 * NNZ_PER
    )
    batches = [
        builder.build(labels[i:i + BATCH], keys[i:i + BATCH], vals[i:i + BATCH])
        for i in range(0, BATCH * STEPS, BATCH)
    ]
    rng = np.random.default_rng(SEED)
    rounds = [server_pushes(rng) for _ in range(SERVER_ROUNDS)]
    push_idx, _ = coalesce_pushes(*rounds[0])
    u_worker = batches[0].unique_keys.shape[0]
    log(f"set-up data in {time.perf_counter() - t0:.2f} s: batch (B, NNZ, U) "
        f"= {batches[0].shape}; server push of {len(push_idx)} unique rows")

    # 3. kernel checks and times
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    kernels = []
    err_delta = max(
        check_delta(fk, dev, gen, 1 << 20, 1),
        check_delta(fk, dev, gen, 1 << 17, 8),
        check_delta(fk, dev, gen, u_worker, 1),
        check_delta(fk, dev, gen, 1 << 17, 8, HYPER_L2),
    )
    # time at the worker step's shape (U, 1), cycling input sets so the
    # 50 MB L2 cache cannot hold them between calls
    sets = [
        (torch.randn((u_worker, 1), generator=gen, device=dev),
         torch.rand((u_worker, 1), generator=gen, device=dev),
         torch.randn((u_worker, 1), generator=gen, device=dev))
        for _ in range(8)
    ]
    k_ms, k_call = cuda_ms(lambda i: fk.ftrl_delta(*sets[i % 8], **HYPER), 200)
    p_ms, p_call = cuda_ms(lambda i: fk.ftrl_delta_plain(*sets[i % 8], **HYPER), PLAIN_ITERS
    )
    b_ms, b_by = bound(20 * u_worker, FTRL_FLOPS * u_worker)
    kernels.append({
        "name": "ftrl_delta", "route": "cuda",
        "source": "parameter_server_tpu_torch/csrc/ftrl.cu",
        "replaces": "parameter_server_tpu/ops/pallas_kernels.py:84",
        "shape": [u_worker, 1], "max_abs_err": err_delta,
        "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "call_ms": k_call, "plain_call_ms": p_call,
    })
    del sets
    log(f"ftrl_delta ok: max abs err {err_delta:.3g}; device {k_ms:.5f} ms kernel, "
        f"{p_ms:.5f} ms plain, bound {b_ms:.5f} ms ({b_by}) at ({u_worker}, 1); "
        f"host-inclusive per call {k_call:.5f} ms kernel, {p_call:.5f} ms plain")

    err_push = []
    for vdim, hyper in ((1, HYPER), (8, HYPER), (1, HYPER_L2)):
        err_push.append(check_push(fk, dev, gen, push_idx, vdim, hyper))
        torch.cuda.empty_cache()
        log(f"ftrl_push vdim {vdim} l2 {hyper['l2']} ok on {SERVER_KEYS} rows: "
            f"max abs err {err_push[-1]:.3g}; untouched rows bit-identical")
    # time at the server's shape (2^27, 1), cycling PUSH_SETS touched sets so
    # each call finds its rows cold, as a push to a large table does
    sets = []
    for _ in range(PUSH_SETS):
        keys_np = np.unique(rng.integers(1, SERVER_KEYS, PUSH_DRAWS)).astype(np.int32)
        sets.append((torch.from_numpy(keys_np).to(dev),
                     torch.randn((len(keys_np), 1), generator=gen, device=dev)))
    u = sum(k.shape[0] for k, _ in sets) / PUSH_SETS
    z = torch.zeros((SERVER_KEYS, 1), device=dev)
    n = torch.zeros((SERVER_KEYS, 1), device=dev)
    k_ms, k_call = cuda_ms(
        lambda i: fk.ftrl_push(z, n, *sets[i % PUSH_SETS], **HYPER), 200)
    p_ms, p_call = cuda_ms(
        lambda i: fk.ftrl_push_plain(z, n, *sets[i % PUSH_SETS], **HYPER), PLAIN_ITERS)
    b_ms, b_by = bound(u * (4 + 4 + 16), FTRL_FLOPS * u)
    kernels.insert(0, {
        "name": "ftrl_push", "route": "cuda",
        "source": "parameter_server_tpu_torch/csrc/ftrl.cu",
        "replaces": "parameter_server_tpu/ops/pallas_kernels.py:335",
        "shape": [SERVER_KEYS, 1, u], "max_abs_err": max(err_push),
        "ms": k_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "call_ms": k_call, "plain_call_ms": p_call,
    })
    log(f"ftrl_push: device {k_ms:.5f} ms kernel, {p_ms:.5f} ms plain, bound "
        f"{b_ms:.5f} ms ({b_by}; {u:.1f} rows into {SERVER_KEYS}, {PUSH_SETS} "
        f"sets cycled); sector-granular traffic bound "
        f"{u * 136 / HBM_BYTES_PER_S * 1e3:.5f} ms; host-inclusive per call "
        f"{k_call:.5f} ms kernel, {p_call:.5f} ms plain")
    del z, n, sets
    torch.cuda.empty_cache()

    # 4. worker: the linear_method trainer on the card
    cfg = PSConfig()
    cfg.data.num_keys = WORKER_KEYS
    cfg.solver.minibatch = BATCH
    cfg.data.max_nnz_per_example = 4 * NNZ_PER
    cfg.lr.alpha, cfg.lr.beta = HYPER["alpha"], HYPER["beta"]
    cfg.penalty.lambda_l1, cfg.penalty.lambda_l2 = HYPER["l1"], HYPER["l2"]
    rep = ProgressReporter(print_fn=lambda s: log(f"train | {s}"))
    app = LinearMethod(cfg, reporter=rep, device="cuda")
    torch.cuda.synchronize()
    fk.reset_launches()
    t0 = time.perf_counter()
    app.train(batches, report_every=1)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    worker_launches = dict(fk.LAUNCHES)
    if worker_launches["ftrl_delta"] < STEPS:
        raise AssertionError(f"worker phase launched ftrl_delta "
                             f"{worker_launches['ftrl_delta']} times, want {STEPS}")
    hist = rep.history
    if not all(np.isfinite(r["objv"]) for r in hist) or not hist[-1]["auc"] > 0.5:
        raise AssertionError(f"worker: bad progress {hist[-1]}")
    cpu_rep = ProgressReporter(print_fn=lambda s: None)
    LinearMethod(cfg, reporter=cpu_rep, device="cpu").train(batches[:3], report_every=1)
    for step, (a, b) in enumerate(zip(hist[:3], cpu_rep.history)):
        loss_gpu, loss_cpu = a["objv"] * BATCH, b["objv"] * BATCH
        if not np.isclose(loss_gpu, loss_cpu, rtol=1e-4, atol=0.0):
            raise AssertionError(
                f"worker step {step}: loss_sum {loss_gpu} on the card vs "
                f"{loss_cpu} on the CPU"
            )
    ex_s = sorted(r["ex_per_sec"] for r in hist[1:])
    log(f"worker ok: {STEPS} steps in {t_train:.3f} s; median {ex_s[len(ex_s) // 2]:.1f}"
        f" ex/s over steps 2-{STEPS}; progressive AUC {hist[-1]['auc']:.4f}; "
        f"loss_sum of steps 1-3 matches the CPU run; launches {worker_launches}")
    wall_ms, busy_ms, top = profile(lambda: app.train(batches[:4], report_every=4))
    log(f"worker profile, 4 steps: wall {wall_ms:.3f} ms, device busy "
        f"{busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.3f}); top device "
        f"time: {top}")
    del app
    torch.cuda.empty_cache()

    # 5. server: pushes from simulated workers, then pulls
    store = KVStore(Ftrl(alpha=HYPER["alpha"], beta=HYPER["beta"],
                         lambda_l1=HYPER["l1"], lambda_l2=HYPER["l2"]),
                    num_keys=SERVER_KEYS, device="cuda")
    torch.cuda.synchronize()
    fk.reset_launches()
    t0 = time.perf_counter()
    for r, (idx_list, grad_list) in enumerate(rounds):
        if r == len(rounds) - 1:
            uniq, summed = coalesce_pushes(idx_list, grad_list)
            sel = torch.from_numpy(uniq.astype(np.int64)).to(dev)
            pre = {k: v.index_select(0, sel).cpu() for k, v in store.state.items()}
        store.push_multi(idx_list, grad_list)
    pulled = store.pull(uniq).cpu()
    t_server = time.perf_counter() - t0
    server_launches = dict(fk.LAUNCHES)
    if server_launches["ftrl_push"] < SERVER_ROUNDS:
        raise AssertionError(f"server phase launched ftrl_push "
                             f"{server_launches['ftrl_push']} times, want {SERVER_ROUNDS}")
    zc = torch.cat([torch.zeros(1, 1), pre["z"]])
    nc = torch.cat([torch.zeros(1, 1), pre["n"]])
    local = torch.arange(1, len(uniq) + 1, dtype=torch.int32)
    fk.ftrl_push_plain(zc, nc, local, torch.from_numpy(summed), **HYPER)
    want = store.updater.weights({"z": zc[1:], "n": nc[1:]})
    err_pull = check_close("server pull", pulled, want)
    if not torch.isfinite(pulled).all() or not (pulled != 0).any():
        raise AssertionError("server: pulled weights are not finite and nonzero")
    log(f"server ok: {SERVER_ROUNDS} coalesced pushes of {SERVER_WORKERS} workers "
        f"and a pull of {len(uniq)} keys in {t_server:.3f} s; pulled weights "
        f"match the CPU plain update (max abs err {err_pull:.3g}); launches "
        f"{server_launches}; nnz {store.nnz()}")

    kernels[0]["launches"] = server_launches["ftrl_push"]
    kernels[1]["launches"] = worker_launches["ftrl_delta"]
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
