"""Live cluster time series: bounded rings of telemetry DELTAS.

Reference analog: none — the reference's scheduler dashboard printed the
*latest* heartbeat and nothing else, so "is the shed rate rising?" was
unanswerable while the cluster ran. This module is the missing axis:
every process's cumulative telemetry (``metrics.telemetry_snapshot()``
— monotonic counters + log2-bucketed latency histograms) is observed
into a :class:`TimeSeriesRing`, which stores the timestamped DELTA since
the previous observation. Deltas make the history composable:

- a counter delta over ``dt`` seconds is an exact windowed **rate**;
- a histogram delta is an exact bucket-wise difference, so a window's
  **p50/p99** comes from summing the window's delta buckets and reading
  the percentile — no quantile averaging, the same discipline as the
  cluster merge;
- ``*_peak`` gauges (already rolled per heartbeat window upstream) ride
  each entry as-is and merge as a max.

Fed from two sides: **client-side**, every node rolls its own
ring from the same ``telemetry_snapshot()`` call its heartbeat
piggybacks (``local_roll``); **cluster-side**, ``HeartbeatMonitor``
retains each node's beat stream in a per-node ring instead of
overwriting the last beat — the feed for the coordinator ``telemetry``
command's windowed view, ``cli top`` and the ``[slo]`` burn-rate engine
(utils/slo.py).

The **OpenMetrics endpoint** (``start_metrics_server``) serves this
process's cumulative telemetry at ``/metrics`` (strict OpenMetrics text:
counters with ``_total``, log2 histograms with cumulative ``le``
buckets, ``# EOF`` terminator) plus a ``/healthz`` liveness probe, over
a stdlib ``ThreadingHTTPServer`` — an external Prometheus can scrape
any node with zero dependencies.

The **heartbeat payload guard** rides here too: ``beat_telemetry()`` is
what ``_Beats`` actually piggybacks — the full snapshot saturates to
summaries once it outgrows the per-beat budget (the
``KeyHeatSketch._SNAP_MAX_NNZ`` discipline), so a long run's beat stays
bounded no matter how many histogram series or profiler stacks the
process accumulates.
"""

from __future__ import annotations

import json
import threading
import time
from collections import deque
from typing import Any, Callable

from parameter_server_tpu_torch.utils import flightrec
from parameter_server_tpu_torch.utils.metrics import (
    _HIST_BUCKETS,
    RANGE_OTHER,
    RANGE_PREFIX,
    hist_percentile,
    merge_hist_snapshots,
    split_range_series,
    telemetry_snapshot,
    wire_counters,
)

#: clip bucket for exemplar placement (metrics.Histogram's top bucket)
_HIST_TOP_BUCKET = _HIST_BUCKETS - 1

METRICS_PORT_ENV = "PS_METRICS_PORT"

#: heartbeat payload guard: a beat's telemetry
#: block keeps at most this many histogram series — beyond it, the
#: largest-count series survive and the rest collapse into one
#: ``{count, sum_s}``-only summary entry, flagged ``hists_saturated``
BEAT_MAX_HISTS = 64
#: ... and at most this many piggybacked profiler stacks, each folded
#: string truncated (utils/profiler.py already bounds depth; this bound
#: holds even against a misconfigured profiler)
BEAT_MAX_PROF = 8
BEAT_MAX_STACK_CHARS = 1024
#: freshness plane: at most this many DISTINCT key ranges may
#: ride one beat's ``range.<id>.*`` matrix — a resharded or synthetic
#: run with thousands of ranges collapses its cold tail into one
#: ``range.other.*`` aggregate, so range cardinality can never blow up
#: a heartbeat (the same discipline BEAT_MAX_HISTS applies to series
#: count, applied one level up to the range axis specifically: without
#: this, 10k ranges x 6 series each would saturate the hist guard and
#: crowd every NON-range series out of the beat)
BEAT_MAX_RANGES = 32


def _counter_deltas(
    cur: dict[str, int], prev: dict[str, int]
) -> dict[str, int]:
    out: dict[str, int] = {}
    for k, v in cur.items():
        if k.endswith("_peak"):
            # windowed gauge (rolled upstream per snapshot): the entry
            # value IS the window's peak, not a cumulative difference
            if v:
                out[k] = v
            continue
        d = v - prev.get(k, 0)
        if d < 0:
            d = v  # process restart reset the counter: re-baseline
        if d:
            out[k] = d
    return out


def _hist_delta(
    cur: dict[str, Any], prev: dict[str, Any] | None
) -> dict[str, Any] | None:
    if prev is None or cur.get("count", 0) < prev.get("count", 0):
        # first sight, or the count went BACKWARDS (restart — or a
        # series that fell out of a saturated beat payload and came
        # back): baseline only, book NO delta. Booking the cumulative
        # snapshot here would re-count the series' whole history as one
        # window delta and inflate every rate/percentile the SLO engine
        # reads; losing one interval is the safe failure mode.
        return None
    c = cur.get("count", 0) - prev.get("count", 0)
    if c <= 0:
        return None
    pb = prev.get("buckets", {})
    buckets = {}
    for k, v in cur.get("buckets", {}).items():
        d = v - pb.get(k, 0)
        if d > 0:
            buckets[k] = d
    out = {
        "count": c,
        "sum_s": max(cur.get("sum_s", 0.0) - prev.get("sum_s", 0.0), 0.0),
        "buckets": buckets,
    }
    if "ex" in cur:
        # the exemplar is already windowed upstream (rolled per
        # telemetry snapshot): ride the delta as-is
        out["ex"] = cur["ex"]
    return out


def series_scale(name: str) -> float:
    """Display scale for a histogram series' percentile: latency series
    read in milliseconds; ``.n``-suffixed count-valued series
    (``observe_scalar``'s as-if-microseconds encoding) read back as raw
    values (``hist_percentile * 1e6``)."""
    return 1e6 if name.endswith(".n") else 1e3


#: committed series renamed for unit-suffix hygiene (pslint v3's
#: ``units`` checker: a duration-valued series name must carry its
#: unit): old name -> canonical. Rule strings and dashboard lookups
#: canonicalize through here, so persisted ``[slo] rules`` entries and
#: beats from pre-rename nodes in a mixed-version cluster keep working.
SERIES_ALIASES: dict[str, str] = {
    "serve.age": "serve.age_s",
}
#: canonical -> legacy, for read-side fallbacks against old beats
LEGACY_SERIES: dict[str, str] = {v: k for k, v in SERIES_ALIASES.items()}


def canonical_series(name: str) -> str:
    """The canonical (unit-suffixed) name for a telemetry series."""
    return SERIES_ALIASES.get(name, name)


class TimeSeriesRing:
    """Bounded ring of timestamped telemetry deltas (thread-safe).

    ``observe(cumulative_snapshot, ts)`` appends the delta vs the
    previous observation; windowed reads (``window``/``rate``/
    ``percentile``/``summary``) merge the entries younger than
    ``window_s``. The same class serves both feeds: a node observing its
    own rolls and the coordinator observing each node's beat stream."""

    def __init__(self, capacity: int = 360):
        self.capacity = max(int(capacity), 2)
        self._buf: deque[dict[str, Any]] = deque(maxlen=self.capacity)
        self._prev: dict[str, Any] | None = None
        self._prev_ts: float | None = None
        self._lock = threading.Lock()

    def observe(
        self, snap: dict[str, Any], ts: float | None = None
    ) -> dict[str, Any] | None:
        """Record the delta between ``snap`` (a cumulative telemetry
        snapshot) and the previous observation. The first observation
        only baselines (returns None) — a delta needs two points."""
        if ts is None:
            ts = time.time()
        with self._lock:
            prev, prev_ts = self._prev, self._prev_ts
            if prev_ts is not None and ts <= prev_ts:
                # out-of-order feeder race: discard WITHOUT touching the
                # baseline — regressing _prev to the older snapshot
                # would make the next delta double-count this interval
                return None
            self._prev, self._prev_ts = snap, ts
            if prev is None or prev_ts is None:
                return None
            hists: dict[str, Any] = {}
            for name, cur in (snap.get("hists") or {}).items():
                d = _hist_delta(cur, (prev.get("hists") or {}).get(name))
                if d is not None:
                    hists[name] = d
            entry = {
                "ts": ts,
                "dt_s": ts - prev_ts,
                "counters": _counter_deltas(
                    snap.get("counters") or {}, prev.get("counters") or {}
                ),
                "hists": hists,
            }
            self._buf.append(entry)
            return entry

    def entries(
        self, window_s: float | None = None, now: float | None = None
    ) -> list[dict[str, Any]]:
        with self._lock:
            out = list(self._buf)
        if window_s is None:
            return out
        if now is None:
            now = time.time()
        lo = now - window_s
        # strict cut: an entry stamped exactly at the window edge covers
        # the second BEFORE the window, so it stays out — a "4 s window"
        # then merges exactly 4 s of delta coverage, not 5
        return [e for e in out if e["ts"] > lo]

    def window(
        self, window_s: float, now: float | None = None
    ) -> dict[str, Any]:
        """One merged delta over the window: summed counters (peaks as
        max), bucket-wise merged histogram deltas, total covered dt."""
        counters: dict[str, int] = {}
        hists: dict[str, list[dict]] = {}
        dt = 0.0
        n = 0
        for e in self.entries(window_s, now):
            dt += e["dt_s"]
            n += 1
            for k, v in e["counters"].items():
                if k.endswith("_peak"):
                    counters[k] = max(counters.get(k, 0), v)
                else:
                    counters[k] = counters.get(k, 0) + v
            for k, v in e["hists"].items():
                hists.setdefault(k, []).append(v)
        return {
            "dt_s": dt,
            "samples": n,
            "counters": counters,
            "hists": {k: merge_hist_snapshots(v) for k, v in hists.items()},
        }

    def rate(
        self, counter: str, window_s: float, now: float | None = None
    ) -> float:
        w = self.window(window_s, now)
        return w["counters"].get(counter, 0) / w["dt_s"] if w["dt_s"] else 0.0

    def percentile(
        self, hist: str, p: float, window_s: float,
        now: float | None = None,
    ) -> float:
        """Windowed percentile in SECONDS (callers scale for display —
        see ``series_scale``); 0.0 when the window has no observations."""
        w = self.window(window_s, now)
        snap = w["hists"].get(hist)
        return hist_percentile(snap, p) if snap else 0.0

    def summary(
        self, window_s: float, now: float | None = None
    ) -> dict[str, Any]:
        """The wire/dashboard form: windowed counter rates (per second)
        and per-series p50/p99 in display units (ms for latency series,
        raw values for ``.n`` count series)."""
        w = self.window(window_s, now)
        dt = w["dt_s"]
        rates = {
            k: round(v / dt, 3)
            for k, v in sorted(w["counters"].items())
            if not k.endswith("_peak")
        } if dt else {}
        p50: dict[str, float] = {}
        p99: dict[str, float] = {}
        hist_rates: dict[str, float] = {}
        for name, snap in sorted(w["hists"].items()):
            if snap.get("buckets"):
                # bucketless deltas (the beat guard's "_saturated"
                # count/sum summary) have no percentile — emitting one
                # would report the top bucket edge (~6 days) as a p99
                sc = series_scale(name)
                p50[name] = round(hist_percentile(snap, 0.5) * sc, 3)
                p99[name] = round(hist_percentile(snap, 0.99) * sc, 3)
            if dt:
                # observations per second: command histograms double as
                # the dashboard's push/s / pull/s throughput columns
                hist_rates[name] = round(snap.get("count", 0) / dt, 3)
        return {
            "window_s": window_s,
            "dt_s": round(dt, 3),
            "samples": w["samples"],
            "rates": rates,
            "hist_rates": hist_rates,
            "peaks": {
                k: v for k, v in sorted(w["counters"].items())
                if k.endswith("_peak")
            },
            "p50": p50,
            "p99": p99,
        }


# -- the node-local ring + roll ---------------------------------------------

_local = TimeSeriesRing()


def local_ring() -> TimeSeriesRing:
    """This process's own ring (fed by ``local_roll``; served windowed
    by the metrics endpoint and piggybacked summaries)."""
    return _local


def reset_local_ring(capacity: int = 360) -> TimeSeriesRing:
    """Swap in a fresh ring (process start / tests)."""
    global _local
    _local = TimeSeriesRing(capacity)
    return _local


def local_roll(snap: dict[str, Any] | None = None) -> dict[str, Any]:
    """Observe one cumulative snapshot into the local ring (the
    heartbeat path passes the snapshot it is about to piggyback so one
    beat costs one snapshot). Returns the snapshot."""
    if snap is None:
        snap = telemetry_snapshot()
    _local.observe(snap)
    wire_counters.inc("ts_rolls")
    flightrec.record("ts.roll", n=len(snap.get("counters") or {}))
    return snap


class Roller:
    """Background roll cadence for processes with no heartbeat (the
    train path, benches): one daemon thread calling ``local_roll`` every
    ``interval_s``."""

    def __init__(self, interval_s: float = 5.0):
        self.interval_s = interval_s
        self._stop = threading.Event()
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="ps-ts-roller"
        )
        self._thread.start()

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            local_roll()

    def close(self) -> None:
        self._stop.set()
        self._thread.join(timeout=2.0)


# -- heartbeat payload guard ------------------------------------------------


def _saturate_ranges(
    counters: dict[str, int], hists: dict[str, Any]
) -> tuple[dict[str, int], dict[str, Any], int, int]:
    """Bound the distinct key ranges in one telemetry block to
    ``BEAT_MAX_RANGES``: the highest-traffic ranges keep their own
    ``range.<id>.*`` series, the tail folds into summed
    ``range.other.*`` counters and bucket-merged histograms (percentiles
    over the folded tail stay exact — the merge discipline).
    Returns ``(counters, hists, n_ranges, n_folded)``."""
    traffic: dict[str, int] = {}
    for name, v in counters.items():
        parsed = split_range_series(name)
        if parsed and parsed[0] != RANGE_OTHER:
            traffic[parsed[0]] = traffic.get(parsed[0], 0) + int(v)
    for name, s in hists.items():
        parsed = split_range_series(name)
        if parsed and parsed[0] != RANGE_OTHER:
            traffic[parsed[0]] = traffic.get(parsed[0], 0) + int(
                s.get("count", 0)
            )
    n = len(traffic)
    if n <= BEAT_MAX_RANGES:
        return counters, hists, n, 0
    keep = set(
        sorted(traffic, key=lambda r: (-traffic[r], r))[:BEAT_MAX_RANGES]
    )
    c_out: dict[str, int] = {}
    for name, v in counters.items():
        parsed = split_range_series(name)
        if parsed is None or parsed[0] in keep:
            c_out[name] = v
        else:
            oname = RANGE_PREFIX + RANGE_OTHER + "." + parsed[1]
            c_out[oname] = c_out.get(oname, 0) + int(v)
    h_out: dict[str, Any] = {}
    folded: dict[str, list] = {}
    for name, s in hists.items():
        parsed = split_range_series(name)
        if parsed is None or parsed[0] in keep:
            h_out[name] = s
        else:
            folded.setdefault(parsed[1], []).append(s)
    for metric, snaps in folded.items():
        oname = RANGE_PREFIX + RANGE_OTHER + "." + metric
        if oname in h_out:  # an upstream fold already contributed
            snaps = snaps + [h_out[oname]]
        h_out[oname] = merge_hist_snapshots(snaps)
    return c_out, h_out, n, n - BEAT_MAX_RANGES


def beat_telemetry(snap: dict[str, Any] | None = None) -> dict[str, Any]:
    """The bounded beat payload: the cumulative snapshot with its
    range matrix, histogram and profiler blocks saturated to summaries
    past the per-beat budget. Also rolls the local ring (one snapshot
    serves the beat, the ring and the guard)."""
    snap = local_roll(snap)
    out = dict(snap)
    counters, hists, n_ranges, folded = _saturate_ranges(
        dict(snap.get("counters") or {}), dict(snap.get("hists") or {})
    )
    out["counters"] = counters
    if n_ranges:
        if folded:
            out["ranges_saturated"] = folded
            # always-rendered OpenMetrics saturation counter: a scraper
            # can tell "tail folded into range=other" from "few ranges"
            wire_counters.inc("range_label_saturated", folded)
        flightrec.record("range.roll", ranges=n_ranges, folded=folded)
    if len(hists) > BEAT_MAX_HISTS:
        # keep the heaviest series whole; the tail collapses into ONE
        # count/sum-only summary so the beat can never grow unboundedly
        # with series cardinality (the KeyHeatSketch saturation move)
        ranked = sorted(
            hists.items(), key=lambda kv: -kv[1].get("count", 0)
        )
        kept = dict(ranked[:BEAT_MAX_HISTS])
        dropped = ranked[BEAT_MAX_HISTS:]
        kept["_saturated"] = {
            "count": sum(s.get("count", 0) for _, s in dropped),
            "sum_s": sum(s.get("sum_s", 0.0) for _, s in dropped),
            "buckets": {},
        }
        hists = kept
        out["hists_saturated"] = len(dropped)
    out["hists"] = hists
    prof = snap.get("prof")
    if prof:
        out["prof"] = [
            {
                "s": str(p.get("s", ""))[:BEAT_MAX_STACK_CHARS],
                "n": int(p.get("n", 0)),
            }
            for p in prof[:BEAT_MAX_PROF]
        ]
    return out


# -- OpenMetrics endpoint ---------------------------------------------------

_NAME_OK = "abcdefghijklmnopqrstuvwxyzABCDEFGHIJKLMNOPQRSTUVWXYZ0123456789_:"


def _metric_name(raw: str) -> str:
    cleaned = "".join(c if c in _NAME_OK else "_" for c in raw)
    if not cleaned or cleaned[0].isdigit():
        cleaned = "_" + cleaned
    return "ps_" + cleaned


def _fmt(v: float) -> str:
    return repr(round(float(v), 9)) if isinstance(v, float) else str(v)


def build_info(proc: str = "") -> dict[str, str]:
    """The ``ps_build_info`` labels: package name and version plus the
    role/rank parsed from the process name (``worker-3`` -> worker/3 —
    the naming convention every armed plane shares). The ``package``
    label is the port's own: a scrape names which package a node runs."""
    import parameter_server_tpu_torch

    role, _, rank = (proc or "").rpartition("-")
    if not role or not rank.isdigit():
        role, rank = proc, ""
    return {
        "package": parameter_server_tpu_torch.__name__,
        "version": getattr(parameter_server_tpu_torch, "__version__", "0"),
        "role": role,
        "rank": rank,
    }


#: hard cap on distinct ``range="<id>"`` label values per scrape — a
#: Prometheus time-series database pays per label combination forever,
#: so the exposition folds the cold tail into ``range="other"`` rather
#: than letting reshards mint unbounded series (the classic cardinality
#: explosion). Tighter than BEAT_MAX_RANGES: a scrape is an external,
#: durable sink; a beat is internal and windowed.
OM_MAX_RANGE_LABELS = 16


def _label_set(*parts: str) -> str:
    """``{a="1",b="2"}`` from the non-empty parts ('' when none)."""
    body = ",".join(p for p in parts if p)
    return "{" + body + "}" if body else ""


def _fold_render_ranges(
    counters: dict[str, Any], hists: dict[str, Any]
) -> tuple[dict[str, dict], dict[str, dict], int]:
    """Pull every ``range.<id>.<metric>`` series OUT of the two blocks
    (mutating them) into per-metric ``{rid: value}`` / ``{rid: hist}``
    maps for labeled rendering, keeping only the ``OM_MAX_RANGE_LABELS``
    highest-traffic ids distinct — the rest (including any upstream
    ``other`` fold riding the snapshot) merge into ``rid="other"``.
    Returns ``(range_counters, range_hists, n_folded)``."""
    traffic: dict[str, int] = {}
    rc: dict[str, dict] = {}
    rh: dict[str, dict] = {}
    for name in list(counters):
        parsed = split_range_series(name)
        if parsed is None:
            continue
        rid, metric = parsed
        v = counters.pop(name)
        rc.setdefault(metric, {})[rid] = v
        if rid != RANGE_OTHER:
            traffic[rid] = traffic.get(rid, 0) + int(v)
    for name in list(hists):
        parsed = split_range_series(name)
        if parsed is None:
            continue
        rid, metric = parsed
        s = hists.pop(name)
        rh.setdefault(metric, {})[rid] = s
        if rid != RANGE_OTHER:
            traffic[rid] = traffic.get(rid, 0) + int(s.get("count", 0))
    if len(traffic) <= OM_MAX_RANGE_LABELS:
        return rc, rh, 0
    keep = set(
        sorted(traffic, key=lambda r: (-traffic[r], r))[:OM_MAX_RANGE_LABELS]
    )
    for metric, by_rid in rc.items():
        out: dict[str, Any] = {}
        for rid, v in by_rid.items():
            if rid in keep:
                out[rid] = v
            else:
                out[RANGE_OTHER] = out.get(RANGE_OTHER, 0) + int(v)
        rc[metric] = out
    for metric, by_rid in rh.items():
        out = {}
        fold: list[dict] = []
        for rid, s in by_rid.items():
            if rid in keep:
                out[rid] = s
            else:
                fold.append(s)
        if fold:
            out[RANGE_OTHER] = merge_hist_snapshots(fold)
        rh[metric] = out
    return rc, rh, len(traffic) - OM_MAX_RANGE_LABELS


def _render_hist(
    lines: list[str], m: str, s: dict[str, Any], base: str,
    count_valued: bool,
) -> None:
    """One histogram exposition (cumulative ``le`` buckets, sum, count)
    under label body ``base`` (e.g. ``proc="w-0",range="0-64"``)."""
    buckets = {int(k): int(v) for k, v in s.get("buckets", {}).items()}
    # tail-trace exemplar: the window's max-latency
    # observation carries its trace id — rendered with the
    # OpenMetrics exemplar syntax on the bucket containing it, so a
    # dashboard's p99 spike links straight to the retained trace
    ex = s.get("ex") or {}
    ex_sfx = ""
    ex_bucket = -1
    if ex.get("tid") and not count_valued:
        v = float(ex.get("v", 0.0))
        ex_bucket = min(int(v * 1e6).bit_length(), _HIST_TOP_BUCKET)
        ex_ts = ex.get("ts")
        ex_sfx = (
            f' # {{trace_id="{ex["tid"]}"}} {_fmt(v)}'
            + (f" {_fmt(float(ex_ts))}" if ex_ts else "")
        )
    cum = 0
    for i in sorted(buckets):
        cum += buckets[i]
        edge = float(1 << i) if count_valued else (1 << i) / 1e6
        lab = _label_set(base, f'le="{_fmt(edge)}"')
        sfx = ex_sfx if i == ex_bucket else ""
        if sfx:
            ex_sfx = ""  # attach exactly once
        lines.append(f"{m}_bucket{lab} {cum}{sfx}")
    inf_lab = _label_set(base, 'le="+Inf"')
    # an exemplar whose bucket is absent (merged/rolled snapshots)
    # attaches to +Inf — an exemplar must never be silently lost
    lines.append(f"{m}_bucket{inf_lab} {s.get('count', 0)}{ex_sfx}")
    total = s.get("sum_s", 0.0)
    if count_valued:
        total *= 1e6  # decode the as-if-microseconds value encoding
    blab = _label_set(base)
    lines.append(f"{m}_sum{blab} {_fmt(float(total))}")
    lines.append(f"{m}_count{blab} {s.get('count', 0)}")


def render_openmetrics(
    snap: dict[str, Any], proc: str = ""
) -> str:
    """Strict OpenMetrics text exposition of one cumulative telemetry
    snapshot: counters (``_total``), ``*_peak`` gauges, histograms with
    cumulative ``le`` buckets at the log2 microsecond edges (exposed in
    seconds; ``.n`` count series in raw values), timers as two counters,
    ``# EOF`` terminator.

    The freshness plane's ``range.<id>.<metric>`` series render as
    LABELED families instead of one metric name per range —
    ``ps_range_pull_total{range="0-64"}``,
    ``ps_range_age_seconds_bucket{range="0-64",le=...}`` — capped at
    ``OM_MAX_RANGE_LABELS`` distinct ids (tail folds to
    ``range="other"``) so a reshard can never mint unbounded label
    cardinality into a scraper's TSDB.

    Three series are emitted UNCONDITIONALLY (the tier-1 format
    validator requires them): ``ps_build_info`` (the Prometheus
    info-metric idiom — constant 1 with version/role/rank labels, what
    dashboards join on), ``ps_audit_violations_total`` and
    ``ps_range_label_saturated_total`` — a clean cluster
    scrapes explicit 0s, so "nothing fired/folded" and "plane absent"
    are different observations."""
    plabel = f'proc="{proc}"' if proc else ""
    label = _label_set(plabel)
    lines: list[str] = []
    info = build_info(proc)
    info_labels = ",".join(
        f'{k}="{v}"' for k, v in sorted(info.items())
    )
    if proc:
        info_labels = f'proc="{proc}",' + info_labels
    lines.append("# TYPE ps_build_info gauge")
    lines.append(f"ps_build_info{{{info_labels}}} 1")
    counters = dict(snap.get("counters") or {})
    # always-present audit verdict counter (0 until a violation fires)
    counters.setdefault("audit_violations", 0)
    # ... and the range-label saturation counter (0 until a fold)
    counters.setdefault("range_label_saturated", 0)
    hists = dict(snap.get("hists") or {})
    range_c, range_h, _folded = _fold_render_ranges(counters, hists)
    for name in sorted(counters):
        v = counters[name]
        m = _metric_name(name)
        if name.endswith("_peak"):
            lines.append(f"# TYPE {m} gauge")
            lines.append(f"{m}{label} {_fmt(v)}")
        else:
            lines.append(f"# TYPE {m} counter")
            lines.append(f"{m}_total{label} {_fmt(v)}")
    for metric in sorted(range_c):
        m = _metric_name("range_" + metric)
        lines.append(f"# TYPE {m} counter")
        for rid in sorted(range_c[metric]):
            lab = _label_set(plabel, f'range="{rid}"')
            lines.append(f"{m}_total{lab} {_fmt(range_c[metric][rid])}")
    for name in sorted(hists):
        s = hists[name]
        count_valued = name.endswith(".n")
        m = _metric_name(name if count_valued else name + "_seconds")
        lines.append(f"# TYPE {m} histogram")
        _render_hist(lines, m, s, plabel, count_valued)
    for metric in sorted(range_h):
        count_valued = metric.endswith(".n")
        m = _metric_name(
            "range_" + (metric if count_valued else metric + "_seconds")
        )
        lines.append(f"# TYPE {m} histogram")
        for rid in sorted(range_h[metric]):
            base = ",".join(
                p for p in (plabel, f'range="{rid}"') if p
            )
            _render_hist(
                lines, m, range_h[metric][rid], base, count_valued
            )
    for name in sorted(snap.get("timers") or {}):
        t = snap["timers"][name]
        m = _metric_name("timer_" + name)
        lines.append(f"# TYPE {m}_seconds counter")
        lines.append(
            f"{m}_seconds_total{label} {_fmt(float(t.get('total_s', 0.0)))}"
        )
        lines.append(f"# TYPE {m}_calls counter")
        lines.append(f"{m}_calls_total{label} {int(t.get('count', 0))}")
    lines.append("# EOF")
    return "\n".join(lines) + "\n"


class MetricsServer:
    """Stdlib HTTP scrape endpoint: ``/metrics`` (OpenMetrics text of
    this process's cumulative telemetry — Prometheus derives its own
    rates) + ``/healthz`` (JSON liveness INCLUDING this node's own
    windowed view: the local ring's rates/p99 summary, so a human or a
    load balancer can read "how is this node doing right now" without
    the coordinator). ``port=0`` binds an ephemeral port (tests);
    ``.port`` is the bound port either way.

    Port-collision fallback: a requested port
    already in use — a stale process, two clusters sharing one base
    port, a host service squatting on the offset — retries the next
    per-role offsets (``port + 1``, ``port + 2``, ... up to
    ``fallback_attempts``) instead of killing the node at arm time;
    telemetry must degrade to a different port, never take the data
    plane down. The chosen port is logged and served in ``/healthz``
    (``port`` + ``requested_port``), so a scraper that found nothing
    at the configured offset can still discover where the node went."""

    def __init__(
        self,
        port: int = 0,
        host: str = "127.0.0.1",
        process_name: str = "",
        snapshot_fn: Callable[[], dict[str, Any]] | None = None,
        health_fn: Callable[[], dict[str, Any]] | None = None,
        window_s: float = 60.0,
        fallback_attempts: int = 8,
    ):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        self.process_name = process_name
        self.requested_port = port
        # observe-only snapshots: a scrape must never consume the
        # heartbeat plane's rolled peak windows
        snap_fn = snapshot_fn or (
            lambda: telemetry_snapshot(roll_peaks=False)
        )
        # default health: liveness + the node's own windowed summary
        # over the configured [timeseries] window (the local ring is
        # fed by beat_telemetry / a Roller; _local resolves at call
        # time so a later reset_local_ring is picked up). The bound +
        # requested ports ride every health doc — the port-collision
        # fallback's discovery contract.
        hf = health_fn or (
            lambda: {"ok": True, "window": _local.summary(window_s)}
        )
        outer = self

        class Handler(BaseHTTPRequestHandler):
            def do_GET(self) -> None:  # noqa: N802 — stdlib handler API
                try:
                    if self.path.split("?")[0] == "/metrics":
                        wire_counters.inc("ts_scrapes")
                        body = render_openmetrics(
                            snap_fn(), outer.process_name
                        ).encode()
                        ctype = (
                            "application/openmetrics-text; "
                            "version=1.0.0; charset=utf-8"
                        )
                    elif self.path.split("?")[0] == "/healthz":
                        doc = {
                            "proc": outer.process_name,
                            "time": time.time(),
                            "port": outer.port,
                            "requested_port": outer.requested_port,
                            **hf(),
                        }
                        body = (json.dumps(doc) + "\n").encode()
                        ctype = "application/json"
                    else:
                        self.send_error(404)
                        return
                    self.send_response(200)
                    self.send_header("Content-Type", ctype)
                    self.send_header("Content-Length", str(len(body)))
                    self.end_headers()
                    self.wfile.write(body)
                except BrokenPipeError:  # scraper hung up mid-reply
                    pass

            def log_message(self, *a: Any) -> None:  # stay silent
                pass

        # bind, walking past EADDRINUSE up to fallback_attempts per-role
        # offsets (ephemeral port 0 never collides: one bind, no walk)
        import errno

        attempts = max(int(fallback_attempts), 1) if port else 1
        httpd = None
        for i in range(attempts):
            try:
                httpd = ThreadingHTTPServer((host, port + i), Handler)
                break
            except OSError as e:
                if e.errno != errno.EADDRINUSE or i == attempts - 1:
                    raise
        self._httpd = httpd
        self._httpd.daemon_threads = True
        self.host = host
        self.port = self._httpd.server_address[1]
        self.address = f"{host}:{self.port}"
        if port and self.port != port:
            print(
                f"[metrics] {process_name or 'node'}: port {port} in "
                f"use, bound {self.port} instead (fallback offset "
                f"+{self.port - port})",
                flush=True,
            )
        self._closed = False
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.2},
            daemon=True,
            name="ps-metrics",
        )
        self._thread.start()

    def close(self) -> None:
        if self._closed:  # idempotent: the train path's finally may
            return        # race an explicit close in tests
        self._closed = True
        self._httpd.shutdown()
        self._httpd.server_close()
        self._thread.join(timeout=5.0)


def start_metrics_server(
    port: int,
    process_name: str = "",
    snapshot_fn: Callable[[], dict[str, Any]] | None = None,
    health_fn: Callable[[], dict[str, Any]] | None = None,
    window_s: float = 60.0,
    host: str = "127.0.0.1",
) -> MetricsServer:
    """Bind and serve the OpenMetrics endpoint (see MetricsServer).
    The loopback default serves same-host scrapers; pass
    ``[timeseries] metrics_host = "0.0.0.0"`` for an off-host
    Prometheus."""
    return MetricsServer(
        port=port, host=host, process_name=process_name,
        snapshot_fn=snapshot_fn, health_fn=health_fn, window_s=window_s,
    )
