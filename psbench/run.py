"""Run one cell of the benchmark once and print its result line.

    python3 psbench/run.py --workload <name> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout. The run makes its inputs from the seed, sets
up, warms up every shape it uses, measures for ``--seconds``, then checks
what the timed path produced against the plain reference. The last line of
standard output is one JSON object (``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` also ``breakdown``, and last
``checks``: each number compared beside its limit); the same numbers close
standard error. With ``--trace 0`` the metrics are the cell's end-to-end
metrics, with ``--trace 1`` its per-layer metrics.

It exits non-zero and prints no result when CUDA sees fewer cards than the
cell asks for, or when the process holds JAX or the JAX package once the
window has closed."""

from __future__ import annotations

import time

T_START = time.monotonic()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import shutil  # noqa: E402
import sys  # noqa: E402
import tempfile  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "parameter_server_tpu")


def _cache_env() -> None:
    """Every build and kernel cache inside the checkout, at fixed paths, so
    only a checkout's first run builds."""
    cache = ROOT / ".psbench_cache"
    os.environ["TRITON_CACHE_DIR"] = str(cache / "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = str(cache / "torch_extensions")
    # one thread in torch's and OpenMP's CPU pools, whatever the caller's
    # environment: the timed path runs no torch CPU operation, and the
    # process's load stays the same from run to run
    os.environ["OMP_NUM_THREADS"] = "1"


def forbidden_modules() -> list[str]:
    """Modules in this process whose top-level name, compared whole, is JAX,
    its relatives, or the JAX package."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def log(msg: str) -> None:
    print(f"[psbench] {msg}", file=sys.stderr, flush=True)


def run_cell(workload: str, seed: int, seconds: float, trace: bool,
             device: str = "cuda", root: Path | None = None,
             overrides: dict | None = None) -> dict:
    """One run of one cell; returns the result line's object. ``device``
    ``cpu`` and ``overrides`` (configuration and mix keys replaced) serve
    the CPU tests: a measured run takes neither."""
    from psbench import device as dev
    from psbench.spec import app_module, load_cell, read_per_layer

    cell = load_cell(workload, root or ROOT)
    for k, v in (overrides or {}).items():
        (cell.config if k in cell.config and k not in cell.traffic else cell.traffic)[k] = v
    if device != "cpu":
        dev.require_cards(cell.chips)
    app = app_module(cell)
    workdir = Path(tempfile.mkdtemp(prefix="psbench-"))
    try:
        out = app.run(cell, seed, seconds, trace, device, workdir, T_START, log)
    finally:
        shutil.rmtree(workdir, ignore_errors=True)
    checks = out["checks"]
    correct = all(c.ok for c in checks)
    if trace:
        metrics = read_per_layer(cell, out["ctx"])
    else:
        metrics = {m["name"]: {"value": float(out["e2e"][m["name"]]), "unit": m["unit"]}
                   for m in cell.end_to_end}
    device_rec = dev.record(cell.chips, out["memory_peak_bytes"], device)
    result: dict = {
        "correct": correct,
        "attempted": int(out["attempted"]),
        "failed": int(out["failed"]),
        "metrics": metrics,
        "device": device_rec,
    }
    tr = out.get("trace")
    if trace and tr is not None:
        device_rec["busy_s"] = tr.busy_s()
        device_rec["window_s"] = tr.window_s
        result["breakdown"] = tr.breakdown()
    for k, v in out["e2e"].items():
        log(f"{k} {v!r}")
    for line in out.get("notes", []):
        log(line)
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in checks}
    return result


def main(argv: list[str] | None = None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    _cache_env()
    # the checkout's root, not this folder, so that every module is found
    # by its package name
    sys.path[0] = str(ROOT)
    from psbench.device import NoCard

    try:
        result = run_cell(args.workload, args.seed, args.seconds, bool(args.trace))
    except NoCard as e:
        log(f"no result: {e}")
        return 2
    held = forbidden_modules()
    if held:
        log(f"no result: the process holds {held} once the window has closed")
        return 3
    for name, c in result["checks"].items():
        log(f"check {name} {c['value']!r} limit {c['limit']!r}")
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
