"""Progress reporting and metrics (reference analog: learner/sgd.h Progress
protos merged at the scheduler + glog step tables, util/resource_usage.h
tic/toc timers).

The reference's scheduler merges per-worker ``Progress`` protos (objective,
relative objv, AUC, nnz(w), examples/sec) every ``report_interval`` and
prints a table. Here ``ProgressReporter`` does the same for the SPMD pod:
workers contribute dicts, process 0 prints the table and appends JSONL.

A copy of the JAX package's ``utils/metrics.py``: the wire counters, the
latency histograms with their exemplars, the slowest-op records, the
per-range series, the named timers, the per-key heat sketch and the
telemetry snapshot and cluster merge that heartbeats carry. The race
witness hook ``race_track`` and the profiler looked up for the snapshot
resolve the port's own modules, and the heat sketch merges a large batch of hot candidates in numpy, to the
JAX loop's result.
"""

from __future__ import annotations

import json
import sys
import threading
import time
from pathlib import Path
from typing import Any

import numpy as np


class CounterSet:
    """Thread-safe named monotonic counters (ref: the Postoffice per-node
    counter tables). One process-global instance, ``wire_counters``, is the
    observability spine of the self-healing control plane: RpcClient bumps
    ``rpc_retries``/``rpc_reconnects`` on every mid-call failure it
    absorbs, RpcServer bumps ``rpc_dedup_hits`` when the reply cache
    suppresses a resent/duplicated non-idempotent command, and the chaos
    layer bumps ``fault_<action>`` per injected fault — so a recovery test
    can assert not just that a run survived but that the machinery it
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


def race_track(obj, fields: tuple[str, ...], name: str = "") -> None:
    """Register one shared object's fields with the Eraser-style lockset
    race witness (analysis/racewitness.py) IF it is armed
    (``PS_RACE_WITNESS=1`` or an explicit ``install()``). Resolved
    through ``sys.modules`` so production code never imports the
    analysis package: disarmed cost is one dict lookup at CONSTRUCTION
    time and zero per attribute access. The owning constructors are the
    registration sites — an instance built before arming keeps raw
    attributes (its locks are raw too; observing it would report
    phantom races)."""
    rw = sys.modules.get("parameter_server_tpu_torch.analysis.racewitness")
    if rw is not None and rw.installed():
        rw.track(obj, fields, name)


#: log2 latency buckets: bucket i covers [2^(i-1), 2^i) microseconds
#: (bucket 0 is < 1 us); 40 buckets reach ~9 days — nothing clips
_HIST_BUCKETS = 40


class Histogram:
    """Thread-safe log2-bucketed latency histogram (ref: the scheduler's
    per-link latency accounting the comm-optimization papers require).

    Observations are seconds; buckets are powers of two of microseconds,
    so the whole distribution is ~40 ints — cheap to snapshot into a
    heartbeat and exact to merge across nodes (bucket-wise sums).

    **Tail-trace exemplars**: an observation may carry an
    exemplar id (the trace id of the RPC it measures); the histogram
    retains the id of the max-latency observation of the current window
    (rolled with the peak-gauge discipline — ``snapshot(roll_exemplar=
    True)`` is the telemetry/heartbeat path, plain reads observe
    without consuming). The exemplar rides snapshots as ``ex`` and the
    OpenMetrics exposition as the standard exemplar syntax, linking a
    p99 blowup on a dashboard to the retained trace that caused it."""

    __slots__ = ("_counts", "_count", "_sum", "_ex", "_lock")

    def __init__(self) -> None:
        self._counts = [0] * _HIST_BUCKETS
        self._count = 0
        self._sum = 0.0
        self._ex: tuple[float, str, float] | None = None  # (v_s, tid, ts)
        self._lock = threading.Lock()

    def observe(self, seconds: float, exemplar: str | None = None) -> None:
        i = int(seconds * 1e6).bit_length()
        if i >= _HIST_BUCKETS:
            i = _HIST_BUCKETS - 1
        with self._lock:
            self._counts[i] += 1
            self._count += 1
            self._sum += seconds
            if exemplar is not None and (
                self._ex is None or seconds > self._ex[0]
            ):
                self._ex = (seconds, exemplar, time.time())

    def snapshot(self, roll_exemplar: bool = False) -> dict[str, Any]:
        """Wire-friendly form: sparse ``{bucket_index: count}`` (JSON
        string keys) plus count/sum — what heartbeats piggyback — and
        the window's max-latency exemplar (``ex``) when one was
        recorded. ``roll_exemplar=True`` resets the exemplar window
        (the telemetry plane's roll; observe-only readers like the
        blackbox flusher and ``/metrics`` scrapes must not consume)."""
        with self._lock:
            out: dict[str, Any] = {
                "count": self._count,
                "sum_s": self._sum,
                "buckets": {
                    str(i): c for i, c in enumerate(self._counts) if c
                },
            }
            if self._ex is not None:
                out["ex"] = {
                    "v": self._ex[0], "tid": self._ex[1], "ts": self._ex[2],
                }
                if roll_exemplar:
                    self._ex = None
            return out

    def percentile(self, p: float) -> float:
        return hist_percentile(self.snapshot(), p)


def hist_percentile(snap: dict[str, Any], p: float) -> float:
    """p-quantile (0..1) in SECONDS from a Histogram snapshot: the upper
    edge of the bucket holding the p-th observation (log2 resolution —
    good enough for p50/p99 dashboards, exact under merging)."""
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


def merge_hist_snapshots(snaps: list[dict[str, Any]]) -> dict[str, Any]:
    """Bucket-wise sum of Histogram snapshots (the cluster-wide merge);
    exemplars merge as the max-latency one — the cluster's worst
    observation keeps its trace id through the merge."""
    out: dict[str, Any] = {"count": 0, "sum_s": 0.0, "buckets": {}}
    for s in snaps:
        out["count"] += s.get("count", 0)
        out["sum_s"] += s.get("sum_s", 0.0)
        for k, c in s.get("buckets", {}).items():
            out["buckets"][k] = out["buckets"].get(k, 0) + c
        ex = s.get("ex")
        if ex and ex.get("v", 0.0) > (out.get("ex") or {}).get("v", 0.0):
            out["ex"] = dict(ex)
    return out


class HistogramSet:
    """Named histograms (thread-safe, created on first observe). One
    process-global instance, ``latency_histograms``, holds per-command
    RPC latencies: ``client.<cmd>`` (client-observed, includes retries)
    and ``server.<cmd>`` (server dispatch/service time)."""

    def __init__(self) -> None:
        self._d: dict[str, Histogram] = {}
        self._lock = threading.Lock()

    def observe(
        self, name: str, seconds: float, exemplar: str | None = None
    ) -> None:
        h = self._d.get(name)
        if h is None:
            with self._lock:
                h = self._d.setdefault(name, Histogram())
        h.observe(seconds, exemplar=exemplar)

    def get(self, name: str) -> Histogram | None:
        with self._lock:
            return self._d.get(name)

    def snapshot(
        self, roll_exemplars: bool = False
    ) -> dict[str, dict[str, Any]]:
        with self._lock:
            hists = dict(self._d)
        return {
            k: h.snapshot(roll_exemplar=roll_exemplars)
            for k, h in hists.items()
        }

    def reset(self) -> None:
        """Tests/benchmarks only (see CounterSet.reset)."""
        with self._lock:
            self._d.clear()


#: process-global per-command RPC latency histograms
latency_histograms = HistogramSet()


class SlowOps:
    """Bounded slowest-K RPCs per command with a per-call segment split
    (the live leg of latency forensics).

    Fed by the RPC client's completion path: every reply now echoes the
    server's service time (``_svc_us``; batched pushes add apply-queue
    wait ``_apw_us`` and jitted-apply ``_apl_us``), so the client can
    split its observed wall time into **wire** (client-observed minus
    server-observed — queueing on the socket, the network, server recv
    buffering, any reply-lane withholding) vs **server** (dispatch)
    vs **apply_wait** / **apply**, with no span shipping. Records carry
    the trace id when tracing is armed, linking a live slow op to its
    retained tail trace. Entries expire after ``window_s`` so the view
    tracks *now*; the whole structure rides the heartbeat piggyback
    (``telemetry_snapshot()["slow"]``) the way hot stacks do."""

    def __init__(self, k: int = 8, window_s: float = 60.0):
        self.k = max(1, int(k))
        self.window_s = float(window_s)
        self._d: dict[str, list[dict[str, Any]]] = {}
        self._lock = threading.Lock()

    def observe(
        self,
        cmd: str,
        total_s: float,
        svc_us: float | None = None,
        apw_us: float | None = None,
        apl_us: float | None = None,
        tid: str | None = None,
    ) -> None:
        now = time.time()
        with self._lock:
            recs = self._d.get(cmd)
            if recs is None:
                recs = self._d[cmd] = []
            lo = now - self.window_s
            if recs:
                # prune unconditionally: recs is DURATION-sorted, so no
                # single position's timestamp proves the rest are live —
                # stale giants must not hold slots, evict live records
                # or fast-reject new ones against a dead floor (k <= 8,
                # the scan is trivial)
                recs[:] = [r for r in recs if r["ts"] >= lo]
            if len(recs) >= self.k and total_s * 1e3 <= recs[-1]["dur_ms"]:
                return  # fast reject: not in the window's slowest-K
            rec: dict[str, Any] = {
                "cmd": cmd,
                "dur_ms": round(total_s * 1e3, 3),
                "ts": now,
            }
            if tid is not None:
                rec["tid"] = tid
            if svc_us is not None:
                svc_ms = float(svc_us) / 1e3
                apw_ms = float(apw_us or 0) / 1e3
                apl_ms = float(apl_us or 0) / 1e3
                seg = {
                    "wire": round(max(total_s * 1e3 - svc_ms, 0.0), 3),
                    "server": round(max(svc_ms - apw_ms - apl_ms, 0.0), 3),
                }
                if apw_us is not None:
                    seg["apply_wait"] = round(apw_ms, 3)
                if apl_us is not None:
                    seg["apply"] = round(apl_ms, 3)
                rec["seg"] = seg
            recs.append(rec)
            recs.sort(key=lambda r: -r["dur_ms"])
            del recs[self.k:]

    def snapshot(self) -> dict[str, list[dict[str, Any]]]:
        """Per-cmd slowest-K records (duration-descending), window-
        expired; {} when nothing slow was seen."""
        now = time.time()
        lo = now - self.window_s
        with self._lock:
            out = {}
            for cmd, recs in self._d.items():
                live = [dict(r) for r in recs if r["ts"] >= lo]
                if live:
                    out[cmd] = live
            return out

    def reset(self) -> None:
        """Tests/benchmarks only (see CounterSet.reset)."""
        with self._lock:
            self._d.clear()


#: process-global slowest-RPC records (fed by RpcClient completions)
slow_ops = SlowOps()


def merge_slow_ops(
    blocks: list[dict[str, list[dict[str, Any]]]], k: int = 8
) -> dict[str, list[dict[str, Any]]]:
    """Cluster merge of SlowOps snapshots: per-cmd concatenation,
    duration-descending, trimmed to the slowest ``k``."""
    out: dict[str, list[dict[str, Any]]] = {}
    for b in blocks:
        for cmd, recs in (b or {}).items():
            out.setdefault(cmd, []).extend(recs)
    for cmd, recs in out.items():
        recs.sort(key=lambda r: -r.get("dur_ms", 0.0))
        del recs[k:]
    return out


def observe_scalar(name: str, value: float) -> None:
    """Dimensionless histogram observation (apply-batch sizes, queue
    depths) through the same log2-bucketed machinery as the latency
    histograms: the value is recorded as if it were that many
    microseconds, so ``hist_percentile(snap, p) * 1e6`` recovers the
    value percentile. Sharing ``latency_histograms`` means these ride
    the heartbeat/telemetry plane (and ``cli stats``) with zero extra
    plumbing; the ``.n`` suffix convention (``server.apply_batch.n``)
    marks a series as a count, not a latency."""
    latency_histograms.observe(name, value / 1e6)


#: range-series naming (freshness plane): every per-key-range
#: metric is an ORDINARY counter/histogram whose name carries a
#: ``range.<begin>-<end>.`` prefix. The encoding is the whole design:
#: the heartbeat piggyback, the coordinator's delta rings,
#: merge_telemetry, beat saturation and the SLO engine all treat the
#: series like any other, so the per-range matrix rides the existing
#: plumbing end to end; only render time (the OpenMetrics endpoint,
#: ``cli ranges``) parses the prefix back into a bounded label.
RANGE_PREFIX = "range."

#: the overflow bucket every cardinality guard folds excess ranges into
#: (a real range id is always ``<begin>-<end>``, so it can never collide)
RANGE_OTHER = "other"


def split_range_series(name: str) -> tuple[str, str] | None:
    """``range.<id>.<metric>`` -> ``(<id>, <metric>)``; None for any
    other series name (the id itself never contains a dot)."""
    if not name.startswith(RANGE_PREFIX):
        return None
    rest = name[len(RANGE_PREFIX):]
    rid, dot, metric = rest.partition(".")
    if not dot or not rid or not metric:
        return None
    return rid, metric


class RangeScope:
    """Booking facade for one key range's traffic matrix: push/pull
    counts, bytes, apply cost and realized data age, all landing in the
    shared ``wire_counters``/``latency_histograms`` under this range's
    name prefix (see RANGE_PREFIX). One instance per ShardServer (its
    owned range) and per serving handle (the range it proxies) — both
    sides contribute to the SAME series, which is exactly right: a
    cached client serve is a serve of that range's data, and
    merge_telemetry unions the contributions cluster-wide."""

    __slots__ = (
        "rid", "_c_pull", "_c_pull_bytes", "_c_push", "_c_push_bytes",
        "_h_apply", "_h_age",
    )

    def __init__(self, begin: int, end: int) -> None:
        self.rid = f"{int(begin)}-{int(end)}"
        p = RANGE_PREFIX + self.rid + "."
        self._c_pull = p + "pull"
        self._c_pull_bytes = p + "pull_bytes"
        self._c_push = p + "push"
        self._c_push_bytes = p + "push_bytes"
        self._h_apply = p + "apply"
        self._h_age = p + "age"

    def pull(self, nbytes: int = 0) -> None:
        wire_counters.inc(self._c_pull)
        if nbytes:
            wire_counters.inc(self._c_pull_bytes, int(nbytes))

    def push(self, n: int = 1, nbytes: int = 0) -> None:
        if n:
            wire_counters.inc(self._c_push, int(n))
        if nbytes:
            wire_counters.inc(self._c_push_bytes, int(nbytes))

    def apply(self, seconds: float) -> None:
        latency_histograms.observe(self._h_apply, seconds)

    def age(self, age_s: float) -> None:
        latency_histograms.observe(self._h_age, max(age_s, 0.0))


def known_ranges(telemetry: dict[str, Any]) -> list[tuple[int, int]]:
    """The distinct key ranges present in a telemetry block's
    ``range.<begin>-<end>.*`` series names, sorted by begin. The rid
    string IS the range boundary, so the shard layout is recoverable
    from the metrics alone — no side channel to the coordinator's
    config, and a merged cluster block yields the cluster layout."""
    rids: set[str] = set()
    for blk in ("counters", "hists"):
        for name in (telemetry.get(blk) or {}):
            parsed = split_range_series(name)
            if parsed and parsed[0] != RANGE_OTHER:
                rids.add(parsed[0])
    out: list[tuple[int, int]] = []
    for rid in rids:
        b, dash, e = rid.partition("-")
        if dash and b.isdigit() and e.isdigit():
            out.append((int(b), int(e)))
    return sorted(out)


def owning_range(
    key: int, ranges: list[tuple[int, int]]
) -> tuple[int, tuple[int, int]] | None:
    """``(server rank, (begin, end))`` owning global ``key`` — ranks
    follow sorted-range order, the ``even_divide`` assignment every
    backend uses; None when no known range covers the key."""
    for i, (b, e) in enumerate(ranges):
        if b <= key < e:
            return i, (b, e)
    return None


class Timer:
    """tic/toc accumulator (ref: util/resource_usage.h).

    Thread-safe: the live ``t0`` is thread-local (the checkpoint thread
    and serve threads tic/toc concurrently without racing each other's
    start marks) and the totals are lock-protected."""

    def __init__(self) -> None:
        self._local = threading.local()
        self._lock = threading.Lock()
        self.total = 0.0
        self.count = 0

    def tic(self) -> None:
        self._local.t0 = time.perf_counter()

    def toc(self) -> float:
        t0 = getattr(self._local, "t0", None)
        assert t0 is not None, "toc without tic"
        dt = time.perf_counter() - t0
        self._local.t0 = None
        with self._lock:
            self.total += dt
            self.count += 1
        return dt

    def snapshot(self) -> dict[str, float]:
        with self._lock:
            return {"total_s": self.total, "count": self.count}

    def __enter__(self) -> "Timer":
        self.tic()
        return self

    def __exit__(self, *exc: Any) -> None:
        self.toc()


class TimerRegistry:
    """Process-global named timers (ref: resource_usage.h's named tic/toc
    tables): ``timers.timer("trainer.dispatch")`` returns one shared
    Timer per name, and ``snapshot()`` rides the telemetry plane."""

    def __init__(self) -> None:
        self._d: dict[str, Timer] = {}
        self._lock = threading.Lock()

    def timer(self, name: str) -> Timer:
        t = self._d.get(name)
        if t is None:
            with self._lock:
                t = self._d.setdefault(name, Timer())
        return t

    def snapshot(self) -> dict[str, dict[str, float]]:
        with self._lock:
            ts = dict(self._d)
        return {k: t.snapshot() for k, t in ts.items()}

    def reset(self) -> None:
        """Tests/benchmarks only."""
        with self._lock:
            self._d.clear()


#: process-global named-timer registry (included in telemetry snapshots)
timers = TimerRegistry()


#: count-min hash seeds (splitmix64 salts; must agree across every node
#: for the sketch tables to be mergeable by elementwise sum)
_HEAT_SEEDS = (0x9E37, 0x85EB, 0xC2B2, 0x27D4)


class KeyHeatSketch:
    """Per-key access heat: a small count-min sketch over the GLOBAL key
    ids touched by pulls and pushes, plus an exact hot-candidate list
    (— the feed hot-key replication (#1) and tiered-store
    promotion (#4) will consume).

    Mergeable like the histograms: same seeds + geometry on every
    node, so tables sum elementwise and estimates stay one-sided
    (count-min never under-counts). ``snapshot()`` is heartbeat-sized:
    the sparse table rows ride along until they saturate
    (``_SNAP_MAX_NNZ`` nonzeros), after which only the bounded
    hot-candidate list travels — a terabyte-scale run degrades to
    heavy-hitters-only, never to an unbounded beat payload."""

    _SNAP_MAX_NNZ = 4096

    def __init__(
        self, width: int = 1024, depth: int = 2,
        hot_min: int = 8, hot_cap: int = 64,
    ):
        if depth > len(_HEAT_SEEDS):
            raise ValueError(f"depth <= {len(_HEAT_SEEDS)}")
        self.width = int(width)
        self.depth = int(depth)
        self.hot_min = int(hot_min)
        self.hot_cap = int(hot_cap)
        self._t = np.zeros((self.depth, self.width), np.int64)
        self._n = 0
        self._hot: dict[int, int] = {}  # candidate key -> last estimate
        self._lock = threading.Lock()
        # the sketch is fed from server conn threads and drained by
        # heartbeat snapshots: every _t/_n/_hot access holds _lock
        race_track(self, ("_t", "_n", "_hot"), "KeyHeatSketch")

    def _rows(self, keys: np.ndarray) -> np.ndarray:
        from parameter_server_tpu_torch.utils.hashing import splitmix64

        k = np.asarray(keys).astype(np.uint64, copy=False)
        out = np.empty((self.depth, len(k)), np.int64)
        for d in range(self.depth):
            with np.errstate(over="ignore"):
                out[d] = (
                    splitmix64(k ^ np.uint64(_HEAT_SEEDS[d]))
                    % np.uint64(self.width)
                ).astype(np.int64)
        return out

    def add(self, keys: np.ndarray) -> None:
        """Count one access of each key (vectorized; GLOBAL key ids —
        callers offset range-relative keys by their range begin)."""
        keys = np.asarray(keys)
        if len(keys) == 0:
            return
        idx = self._rows(keys)
        # the sketch is process-global and every serving/decode thread
        # feeds it, so the scatter (ufunc.at is slow) happens OUTSIDE
        # the lock as a per-depth bincount; the critical section is one
        # dense (depth, width) add + the gather
        contrib = np.stack([
            np.bincount(idx[d], minlength=self.width)
            for d in range(self.depth)
        ])
        with self._lock:
            self._t += contrib
            self._n += len(keys)
            est = self._t[np.arange(self.depth)[:, None], idx].min(axis=0)
            hot = est >= self.hot_min
            if hot.any():
                self._merge_hot(keys[hot], est[hot])

    def _merge_hot(self, hk: np.ndarray, hc: np.ndarray) -> None:
        """The candidate update: each hot key's estimate set in ``_hot``
        (a key already there keeps its place, a new one is appended),
        then, past ``2 * hot_cap`` entries, the ``hot_cap`` largest kept,
        ties in place order (a stable sort). A batch that could overflow
        merges in numpy: a server push of ~16k keys, every one past
        ``hot_min`` once the table fills, took ~18 ms a push as a Python
        loop and sort. The result is the loop's, order included."""
        cap = self.hot_cap
        if len(self._hot) + len(hk) <= 2 * cap:
            for k, c in zip(hk.tolist(), hc.tolist()):
                self._hot[int(k)] = int(c)
            return
        hk, hc = hk.astype(np.int64), hc.astype(np.int64)
        ok = np.fromiter(self._hot.keys(), np.int64, len(self._hot))
        oc = np.fromiter(self._hot.values(), np.int64, len(self._hot))
        if len(ok):
            # the listed keys take their new estimate in place
            srt = np.argsort(ok)
            at = np.minimum(np.searchsorted(ok[srt], hk), len(ok) - 1)
            seen = ok[srt][at] == hk
            oc[srt[at[seen]]] = hc[seen]
            hk, hc = hk[~seen], hc[~seen]
        if len(hk) > 1 and not (np.diff(hk) > 0).all():
            # distinct new keys, in first-occurrence order
            first = np.sort(np.unique(hk, return_index=True)[1])
            hk, hc = hk[first], hc[first]
        if len(ok) + len(hk) > 2 * cap:
            if len(hk) > cap:
                # a new key below the cap-th largest new estimate has cap
                # new keys ahead of it, so it cannot be kept
                thr = np.partition(hc, len(hc) - cap)[len(hc) - cap]
                pool = hc >= thr
                hk, hc = hk[pool], hc[pool]
            mk, mc = np.concatenate([ok, hk]), np.concatenate([oc, hc])
            keep = np.argsort(-mc, kind="stable")[:cap]
            mk, mc = mk[keep], mc[keep]
        else:
            mk, mc = np.concatenate([ok, hk]), np.concatenate([oc, hc])
        self._hot = dict(zip(mk.tolist(), mc.tolist()))

    def count(self, keys: np.ndarray) -> np.ndarray:
        """Estimated access counts (never under-estimates)."""
        keys = np.asarray(keys)
        if len(keys) == 0:
            return np.zeros(0, np.int64)
        idx = self._rows(keys)
        with self._lock:
            return self._t[np.arange(self.depth)[:, None], idx].min(axis=0)

    def snapshot(self) -> dict[str, Any]:
        """Heartbeat-piggyback form ({} when nothing was counted): JSON
        ints only, sparse rows while under the nnz budget."""
        with self._lock:
            if self._n == 0:
                return {}
            out: dict[str, Any] = {
                "w": self.width, "d": self.depth, "n": int(self._n),
                "hot": {str(k): int(c) for k, c in self._hot.items()},
            }
            nnz = int(np.count_nonzero(self._t))
            if nnz <= self._SNAP_MAX_NNZ:
                out["rows"] = [
                    {
                        str(i): int(c)
                        for i, c in zip(
                            np.nonzero(self._t[d])[0].tolist(),
                            self._t[d][np.nonzero(self._t[d])].tolist(),
                        )
                    }
                    for d in range(self.depth)
                ]
            else:
                out["saturated"] = True
            return out

    def reset(self) -> None:
        """Tests/benchmarks only (see CounterSet.reset)."""
        with self._lock:
            self._t[:] = 0
            self._n = 0
            self._hot.clear()


#: process-global per-key heat (shard servers add touched pull/push keys)
key_heat = KeyHeatSketch()


def merge_heat_snapshots(snaps: list[dict[str, Any]]) -> dict[str, Any]:
    """Cluster merge of KeyHeatSketch snapshots: tables sum elementwise
    (same geometry/seeds everywhere), candidate lists sum per key.
    Geometry mismatches and saturated tables degrade to candidates-only."""
    snaps = [s for s in snaps if s]
    if not snaps:
        return {}
    out: dict[str, Any] = {
        "w": snaps[0].get("w"), "d": snaps[0].get("d"),
        "n": sum(s.get("n", 0) for s in snaps),
    }
    hot: dict[str, int] = {}
    for s in snaps:
        for k, c in s.get("hot", {}).items():
            hot[k] = hot.get(k, 0) + int(c)
    out["hot"] = hot
    rows: list[dict[str, int]] | None = None
    for s in snaps:
        sr = s.get("rows")
        if sr is None or (s.get("w"), s.get("d")) != (out["w"], out["d"]):
            rows = None
            out["saturated"] = True
            break
        if rows is None:
            rows = [dict(r) for r in sr]
        else:
            for d, r in enumerate(sr):
                acc = rows[d]
                for i, c in r.items():
                    acc[i] = acc.get(i, 0) + int(c)
    if rows is not None:
        out["rows"] = rows
    return out


def heat_top(snap: dict[str, Any], k: int = 10) -> list[tuple[int, int]]:
    """Top-k (key, estimated count) from a (possibly merged) heat
    snapshot. With the sparse table present, candidate keys re-query the
    merged table (consistent cluster-wide estimates); a saturated
    snapshot falls back to the summed candidate counts."""
    if not snap:
        return []
    cand = [int(key) for key in snap.get("hot", {})]
    if not cand:
        return []
    rows = snap.get("rows")
    if rows is not None:
        sk = KeyHeatSketch(width=int(snap["w"]), depth=int(snap["d"]))
        for d, r in enumerate(rows):
            for i, c in r.items():
                sk._t[d, int(i)] = int(c)
        counts = sk.count(np.asarray(cand, np.uint64))
        pairs = [(key, int(c)) for key, c in zip(cand, counts.tolist())]
    else:
        pairs = [(int(key), int(c)) for key, c in snap["hot"].items()]
    pairs.sort(key=lambda kv: (-kv[1], kv[0]))
    return pairs[:k]


def _profiler_top() -> list[dict[str, Any]] | None:
    """The continuous profiler's top-N hot stacks IF it is armed
    (utils/profiler.py), resolved through ``sys.modules`` so an
    unprofiled process never imports the profiler
    and the disarmed cost is one dict lookup per snapshot."""
    pm = sys.modules.get("parameter_server_tpu_torch.utils.profiler")
    if pm is not None and pm.enabled():
        return pm.top_stacks()
    return None


def telemetry_snapshot(roll_peaks: bool = True) -> dict[str, Any]:
    """This process's full telemetry state — counters, per-command
    latency histograms, named timers, per-key heat. Small (sparse
    dicts), so nodes piggyback it on every heartbeat and the coordinator
    merges the cluster view without a second collection path. Peak
    gauges roll here: each snapshot reports peak-since-last-snapshot
    (see ``CounterSet.snapshot``). ``roll_peaks=False`` observes without
    consuming the window — for readers that are not the telemetry plane
    (the blackbox flusher dumps every second; if it rolled, heartbeats
    and ``cli stats`` would always see ~0 peaks on an armed node)."""
    out = {
        "counters": wire_counters.snapshot(roll_peaks=roll_peaks),
        # exemplars roll with the peak windows: the telemetry plane
        # consumes each window's max-latency trace id exactly once
        "hists": latency_histograms.snapshot(roll_exemplars=roll_peaks),
        "timers": timers.snapshot(),
    }
    heat = key_heat.snapshot()
    if heat:
        out["key_heat"] = heat
    prof = _profiler_top()
    if prof:
        out["prof"] = prof
    slow = slow_ops.snapshot()
    if slow:
        out["slow"] = slow
    return out


def merge_telemetry(snaps: list[dict[str, Any]]) -> dict[str, Any]:
    """Cluster merge of telemetry snapshots: counters and timers sum,
    histograms merge bucket-wise (exact — no quantile averaging).
    High-watermark gauges (``*_peak``, fed by ``observe_max``) merge as a
    max — summing per-node peaks would report a depth nothing reached."""
    counters: dict[str, int] = {}
    hists: dict[str, list[dict]] = {}
    tmr: dict[str, dict[str, float]] = {}
    heat: list[dict[str, Any]] = []
    prof: dict[str, int] = {}
    slow: list[dict[str, Any]] = []
    for s in snaps:
        for k, v in s.get("counters", {}).items():
            if k.endswith("_peak"):
                counters[k] = max(counters.get(k, 0), v)
            else:
                counters[k] = counters.get(k, 0) + v
        for k, v in s.get("hists", {}).items():
            hists.setdefault(k, []).append(v)
        for k, v in s.get("timers", {}).items():
            t = tmr.setdefault(k, {"total_s": 0.0, "count": 0})
            t["total_s"] += v.get("total_s", 0.0)
            t["count"] += v.get("count", 0)
        if s.get("key_heat"):
            heat.append(s["key_heat"])
        if s.get("slow"):
            slow.append(s["slow"])
        for p in s.get("prof") or ():
            stack = str(p.get("s", ""))
            prof[stack] = prof.get(stack, 0) + int(p.get("n", 0))
    out = {
        "counters": counters,
        "hists": {k: merge_hist_snapshots(v) for k, v in hists.items()},
        "timers": tmr,
    }
    if heat:
        out["key_heat"] = merge_heat_snapshots(heat)
    if slow:
        out["slow"] = merge_slow_ops(slow)
    if prof:
        # cluster-wide hot stacks: sum per folded stack, keep a bounded
        # heaviest-first list (each node's block is already top-N)
        ranked = sorted(prof.items(), key=lambda kv: -kv[1])[:20]
        out["prof"] = [{"s": s, "n": n} for s, n in ranked]
    return out


def format_latency_table(hists: dict[str, dict[str, Any]]) -> str:
    """Per-command latency table (count / mean / p50 / p99 in ms) from a
    ``hists`` snapshot — the core of the ``cli stats`` dashboard."""
    lines = [f"{'command':<28} {'count':>9} {'mean_ms':>9} {'p50_ms':>9} {'p99_ms':>9}"]
    for name in sorted(hists):
        s = hists[name]
        n = s.get("count", 0)
        mean = (s.get("sum_s", 0.0) / n * 1e3) if n else 0.0
        lines.append(
            f"{name:<28} {n:>9} {mean:>9.3f} "
            f"{hist_percentile(s, 0.5) * 1e3:>9.3f} "
            f"{hist_percentile(s, 0.99) * 1e3:>9.3f}"
        )
    return "\n".join(lines)


def format_cluster_stats(rep: dict[str, Any]) -> str:
    """The cluster telemetry dump (ref: the reference scheduler's live
    dashboard table): one row per node (liveness stats + headline
    counters), then the merged per-command latency table."""
    lines = [
        f"{'node':>5} {'role':<10} {'rank':>5} {'rss_mb':>8} "
        f"{'wire_out':>12} {'wire_in':>12} {'saved':>10} "
        f"{'retries':>8} {'dedup':>6}"
    ]
    for nid in sorted(rep.get("nodes", {}), key=lambda x: int(x)):
        n = rep["nodes"][nid]
        stats = n.get("stats", {})
        ctr = (n.get("telemetry") or {}).get("counters", {})
        lines.append(
            f"{nid:>5} {str(n.get('role', '?')):<10} "
            f"{str(n.get('rank', '')):>5} "
            f"{stats.get('max_rss_mb', float('nan')):>8.1f} "
            f"{ctr.get('wire_bytes_out', 0):>12} "
            f"{ctr.get('wire_bytes_in', 0):>12} "
            f"{ctr.get('wire_bytes_saved', 0):>10} "
            f"{ctr.get('rpc_retries', 0):>8} "
            f"{ctr.get('rpc_dedup_hits', 0):>6}"
        )
    merged = rep.get("merged", {})
    lines.append("")
    lines.append("cluster counters (merged):")
    ctr = merged.get("counters", {})
    for k in sorted(ctr):
        lines.append(f"  {k:<28} {ctr[k]}")
    heat = merged.get("key_heat")
    if heat:
        lines.append("")
        lines.append(
            f"hot keys (count-min heat, {heat.get('n', 0)} accesses "
            "counted, top 10):"
        )
        # freshness plane: place each hot key on the shard
        # map — the owning range/rank comes straight from the merged
        # range.<begin>-<end>.* series names, no extra plumbing
        ranges = known_ranges(merged)
        for key, c in heat_top(heat, 10):
            own = owning_range(int(key), ranges)
            loc = (
                f"  [range {own[1][0]}-{own[1][1]} @ server {own[0]}]"
                if own else ""
            )
            lines.append(f"  key {key:<24} ~{c}{loc}")
    lines.append("")
    lines.append("per-command latency (merged across nodes):")
    lines.append(format_latency_table(merged.get("hists", {})))
    return "\n".join(lines)


class ProgressReporter:
    """Merge progress dicts; print a step table; append JSONL.

    Columns follow the reference's printed progress (objv, relative objv,
    AUC, nnz(w), examples/sec) plus bytes moved by collectives — the
    reference's Postoffice per-filter byte counters become a statically
    computed collective-traffic estimate.
    """

    _COLS = (
        "sec", "examples", "objv", "rel_objv", "auc", "nnz_w", "ex_per_sec",
        # recovery columns (merge_progress sums these cluster-wide; a table
        # that never showed them hid the self-healing plane's activity)
        "rpc_retries", "rpc_reconnects", "rpc_dedup_hits",
    )
    #: re-print the header periodically so long runs stay readable when
    #: the top scrolled away (ref: glog's repeating table headers)
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
