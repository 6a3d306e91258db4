"""The training progress table (the JAX package's ``ProgressReporter``),
a copy of the wire tier's counters (``CounterSet``, the process-global
``wire_counters``), the log2 latency ``Histogram`` and ``hist_percentile``
that the adaptive RPC window reads (trimmed to ``observe`` / ``snapshot``:
no exemplars, no named registry), and the scheduler's merges:
``merge_progress`` of the workers' reports and counters-only
``telemetry_snapshot`` / ``merge_telemetry`` (the JAX package's latency
histogram registry and named timers are not ported, so their blocks come
back empty)."""

from __future__ import annotations

import json
import threading
import time
from pathlib import Path
from typing import Any


class ProgressReporter:
    """Merge progress dicts; print a step table; append JSONL.

    Columns follow the reference's printed progress: objective, relative
    objective, AUC, nnz(w), examples/sec, plus the wire tier's recovery
    counters (empty on the single-host path)."""

    _COLS = (
        "sec", "examples", "objv", "rel_objv", "auc", "nnz_w", "ex_per_sec",
        "rpc_retries", "rpc_reconnects", "rpc_dedup_hits",
    )
    #: re-print the header periodically so long runs stay readable
    _HEADER_EVERY = 25

    def __init__(self, jsonl_path: str | Path | None = None, print_fn=print):
        self._path = Path(jsonl_path) if jsonl_path else None
        self._print = print_fn
        self._start = time.perf_counter()
        self._last_objv: float | None = None
        self._rows_since_header = self._HEADER_EVERY  # first row prints it
        self.history: list[dict[str, Any]] = []

    def report(self, **fields: Any) -> dict[str, Any]:
        now = time.perf_counter() - self._start
        rec: dict[str, Any] = {"sec": round(now, 3), **fields}
        objv = fields.get("objv")
        if objv is not None and self._last_objv not in (None, 0.0):
            rec["rel_objv"] = (self._last_objv - objv) / abs(self._last_objv)
        if objv is not None:
            self._last_objv = float(objv)
        self.history.append(rec)
        if self._path is not None:
            with self._path.open("a") as f:
                f.write(json.dumps(rec) + "\n")
        self._print_row(rec)
        return rec

    def _print_row(self, rec: dict[str, Any]) -> None:
        if self._rows_since_header >= self._HEADER_EVERY:
            self._print("  ".join(f"{c:>12}" for c in self._COLS))
            self._rows_since_header = 0
        self._rows_since_header += 1
        cells = []
        for c in self._COLS:
            v = rec.get(c, "")
            if isinstance(v, float):
                cells.append(f"{v:>12.5g}")
            else:
                cells.append(f"{v!s:>12}")
        self._print("  ".join(cells))


class CounterSet:
    """Thread-safe named monotonic counters (ref: the Postoffice per-node
    counter tables). One process-global instance, ``wire_counters``, is the
    observability spine of the self-healing control plane: RpcClient bumps
    ``rpc_retries``/``rpc_reconnects`` on every mid-call failure it
    absorbs, RpcServer bumps ``rpc_dedup_hits`` when the reply cache
    suppresses a resent/duplicated non-idempotent command — so a recovery
    test can assert not just that a run survived but that the machinery it
    claims to test actually engaged."""

    def __init__(self) -> None:
        self._d: dict[str, int] = {}
        # windowed high-watermarks: the same *_peak gauges, but reset at
        # every roll_peaks snapshot — so the telemetry plane reports
        # peak-since-last-snapshot and a one-time spike DECAYS out of
        # ``cli stats`` instead of latching forever
        self._win: dict[str, int] = {}
        self._lock = threading.Lock()

    def inc(self, name: str, n: int = 1) -> None:
        with self._lock:
            self._d[name] = self._d.get(name, 0) + n

    def inc_many(self, items: dict[str, int]) -> None:
        """Several counters under ONE lock acquisition (hot-path callers
        like the header codec bump two per frame)."""
        with self._lock:
            d = self._d
            for name, n in items.items():
                d[name] = d.get(name, 0) + n

    def observe_max(self, name: str, v: int) -> None:
        """High-watermark counter (e.g. ``rpc_inflight_peak``: the deepest
        pipelined request window any connection actually reached).
        Tracked twice: cumulative (``get``/plain ``snapshot``) and per
        telemetry window (``snapshot(roll_peaks=True)``)."""
        with self._lock:
            if v > self._d.get(name, 0):
                self._d[name] = v
            if v > self._win.get(name, 0):
                self._win[name] = v

    def get(self, name: str) -> int:
        with self._lock:
            return self._d.get(name, 0)

    def snapshot(self, roll_peaks: bool = False) -> dict[str, int]:
        """Counter snapshot. ``roll_peaks=True`` (the telemetry/heartbeat
        path) reports each ``observe_max`` gauge's peak SINCE THE LAST
        ROLL and resets that window — so the cluster dashboard shows
        recent peaks, not peak-since-boot; ``get()`` and the default
        snapshot keep the cumulative value for tests and process-exit
        reporting."""
        with self._lock:
            out = dict(self._d)
            if roll_peaks:
                out.update(self._win)
                for k in self._win:
                    self._win[k] = 0
            return out

    def reset(self) -> None:
        """Zero everything (tests only: production counters are cumulative
        for the life of the process, like the reference's)."""
        with self._lock:
            self._d.clear()
            self._win.clear()


#: process-global wire/recovery counters (see CounterSet docstring)
wire_counters = CounterSet()


#: log2 latency buckets: bucket i covers [2^(i-1), 2^i) microseconds
#: (bucket 0 is < 1 us); 40 buckets reach ~9 days, nothing clips
_HIST_BUCKETS = 40


class Histogram:
    """Thread-safe log2-bucketed latency histogram. Observations are
    seconds; buckets are powers of two of microseconds, so the whole
    distribution is ~40 ints, exact to subtract and to merge."""

    __slots__ = ("_counts", "_count", "_sum", "_lock")

    def __init__(self) -> None:
        self._counts = [0] * _HIST_BUCKETS
        self._count = 0
        self._sum = 0.0
        self._lock = threading.Lock()

    def observe(self, seconds: float) -> None:
        i = int(seconds * 1e6).bit_length()
        if i >= _HIST_BUCKETS:
            i = _HIST_BUCKETS - 1
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += seconds

    def snapshot(self) -> dict[str, Any]:
        """Sparse ``{bucket_index: count}`` (JSON string keys) plus
        count/sum."""
        with self._lock:
            return {
                "count": self._count,
                "sum_s": self._sum,
                "buckets": {
                    str(i): c for i, c in enumerate(self._counts) if c
                },
            }


def hist_percentile(snap: dict[str, Any], p: float) -> float:
    """p-quantile (0..1) in seconds from a Histogram snapshot: the upper
    edge of the bucket holding the p-th observation."""
    total = snap.get("count", 0)
    if not total:
        return 0.0
    target = max(1, int(p * total + 0.9999999))
    cum = 0
    for i in sorted(int(k) for k in snap.get("buckets", {})):
        cum += snap["buckets"][str(i)]
        if cum >= target:
            return (1 << i) / 1e6  # bucket i upper edge in us
    return (1 << (_HIST_BUCKETS - 1)) / 1e6


def telemetry_snapshot(roll_peaks: bool = True) -> dict[str, Any]:
    """This process's telemetry state, counters only: nodes piggyback it
    on every heartbeat and the coordinator merges the cluster view. Peak
    gauges roll here (see ``CounterSet.snapshot``); ``roll_peaks=False``
    observes without consuming the window. ``hists`` and ``timers`` stay
    empty: those registries are not ported."""
    return {
        "counters": wire_counters.snapshot(roll_peaks=roll_peaks),
        "hists": {},
        "timers": {},
    }


def merge_telemetry(snaps: list[dict[str, Any]]) -> dict[str, Any]:
    """Cluster merge of telemetry snapshots: counters sum, high-watermark
    gauges (``*_peak``, fed by ``observe_max``) merge as a max: summing
    per-node peaks would report a depth nothing reached."""
    counters: dict[str, int] = {}
    for s in snaps:
        for k, v in s.get("counters", {}).items():
            if k.endswith("_peak"):
                counters[k] = max(counters.get(k, 0), v)
            else:
                counters[k] = counters.get(k, 0) + v
    return {"counters": counters, "hists": {}, "timers": {}}


def merge_progress(reports: list[dict[str, Any]]) -> dict[str, Any]:
    """Merge per-worker progress the way the reference scheduler does:
    sums for counters, example-weighted means for metrics."""
    if not reports:
        return {}
    out: dict[str, Any] = {}
    n = sum(r.get("examples", 0) for r in reports)
    out["examples"] = n
    for k in ("objv", "auc", "logloss"):
        pairs = [(r[k], r.get("examples", 0)) for r in reports if k in r]
        if pairs:
            if all(w > 0 for _, w in pairs):
                tot = sum(w for _, w in pairs)
                out[k] = sum(x * w for x, w in pairs) / tot
            else:  # any report without a count: fall back to unweighted mean
                out[k] = sum(x for x, _ in pairs) / len(pairs)
    for k in (
        "nnz_w",
        "ex_per_sec",
        "bytes_pushed",
        "bytes_pulled",
        "wire_bytes_out",
        "wire_bytes_in",
        "wire_bytes_saved",
        "wire_comp_skipped",
        "est_collective_bytes",
        # self-healing control plane (each worker reports its cumulative
        # wire_counters; the merge is the cluster total)
        "rpc_retries",
        "rpc_reconnects",
        "rpc_dedup_hits",
    ):
        vals = [r[k] for r in reports if k in r]
        if vals:
            out[k] = sum(vals)
    return out
