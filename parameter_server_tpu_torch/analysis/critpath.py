"""Cross-process critical-path engine: attribute one logical
push/pull's wall time to named pipeline segments.

The observability planes can say *that* p99 blew up; this module says
*why*: it stitches one logical operation across processes and splits its
client-observed wall time into the named phases of the pipeline —

- ``encode``       client-side payload encode before the RPC is issued
- ``client_queue`` window admission + frame build/queue (the
  ``rpc.<cmd>`` issue span)
- ``wire``         issue -> server dispatch: socket send, the network,
  server recv buffering (and any injected delay fault — this is where
  a straggling link shows up)
- ``server``       the server's dispatch span (decode, dedup, enqueue;
  the whole handler on the inline path)
- ``apply_wait``   batched-apply queue wait (dispatch end -> the apply
  thread picked the push up)
- ``apply``        the jitted coalesced apply itself
- ``reply_lane``   reply queued/withheld + the return wire
- ``ssp_wait``     the SSP gate (step-level ops)
- ``other``        whatever the instrumentation didn't cover (honesty
  column: attribution percentages must sum to ~100, not pretend to)

Two offline feeds, one stitch discipline:

- **trace mode** — a ``PS_TRACE_DIR`` capture: spans share a trace id
  across processes (the propagation), flow events
  (``ps.<cmd>.inflight``) mark completion, and tail-capture sidecars
  (``tracetail-*.json``) are rescued for any trace id a main file
  retained, so the slow half of a cross-process op is present even
  when only one side promoted it;
- **blackbox mode** — a ``PS_BLACKBOX_DIR`` postmortem: flight-recorder
  events stitch by (cid, seq) (``rpc.issue`` -> ``rpc.in`` ->
  ``apply.commit`` -> ``rpc.reply``), the wreckage-grade segmentation
  when no trace was armed.

**Clock-skew hardening**: the stitch crosses wall clocks, and skewed
nodes can reorder a chain into negative segment durations. Negative
raw segments CLAMP to zero and flag the op ``skewed`` (surfaced in the
report and the aggregate) — attribution never reports negative time,
and a skew-heavy capture says so instead of bluffing.

``cli whylate`` is the surface: top-K slowest ops with per-segment
breakdowns over a trace/blackbox dir or a live cluster, plus
``--baseline`` per-segment latency budgets with tiered exit codes (the
pslint ``--baseline`` pattern) so CI fails on *which segment*
regressed.
"""

from __future__ import annotations

import json
import math
import os
from typing import Any

#: canonical segment order (reports render in pipeline order)
SEGMENTS = (
    "encode", "client_queue", "wire", "server", "apply_wait", "apply",
    "reply_lane", "ssp_wait", "other",
)

#: negative-duration tolerance before an op is flagged skewed (us):
#: sub-millisecond inversions are clock granularity, not skew
_SKEW_EPS_US = 1000.0


# -- loading ----------------------------------------------------------------


def load_trace_dir(trace_dir: str) -> list[dict[str, Any]]:
    """Every span/flow/instant event of a trace-dir capture: the shared
    reader + sidecar-rescue rule from utils/trace.py (ONE definition of
    which limbo'd events join the capture), minus ``M`` metadata."""
    from parameter_server_tpu_torch.utils import trace as trace_mod

    main, side = trace_mod.read_trace_dir(trace_dir)
    main.extend(trace_mod.rescue_sidecar_events(main, side))
    return [e for e in main if e.get("ph") != "M"]


def _percentile(vals: list[float], p: float) -> float:
    if not vals:
        return 0.0
    vs = sorted(vals)
    return vs[min(len(vs) - 1, max(0, math.ceil(p * len(vs)) - 1))]


def _clamp(raw_us: float, op: dict[str, Any]) -> float:
    """Negative raw segment -> 0 + the op's skew flag (satellite:
    cross-node wall-clock skew must clamp and flag, never report
    negative attribution)."""
    if raw_us < -_SKEW_EPS_US:
        op["skewed"] = True
    return max(raw_us, 0.0)


def _cap_to_total(
    seg_us: dict[str, float], total_us: float, op: dict[str, Any]
) -> None:
    """Skew's other face: a clock offset that deflates one segment
    inflates its complement past the op's wall time. Cap cumulative
    coverage at the total (pipeline order — seg_us insertion order) and
    flag the op, so attribution can never sum past 100%."""
    alloc = 0.0
    for k in list(seg_us):
        v = seg_us[k]
        if alloc + v > total_us + _SKEW_EPS_US:
            seg_us[k] = max(total_us - alloc, 0.0)
            op["skewed"] = True
        alloc += seg_us[k]


# -- trace mode -------------------------------------------------------------


def _span_end(e: dict[str, Any]) -> float:
    return e.get("ts", 0.0) + e.get("dur", 0.0)


def ops_from_trace(events: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """One op per stitched trace: client root span (``ps.<cmd>`` — or a
    parentless ``rpc.<cmd>`` for raw clients), the issue-side rpc span,
    the server dispatch span, the per-push updater marker and the
    completion flow event. Fan-out ops (one push over many shards) use
    the critical chain: the shard whose spans end LAST is the one the
    op actually waited for."""
    by_tid: dict[str, list[dict[str, Any]]] = {}
    for e in events:
        tid = (e.get("args") or {}).get("trace_id")
        if tid is not None:
            by_tid.setdefault(tid, []).append(e)
    ops: list[dict[str, Any]] = []
    for tid, evs in by_tid.items():
        spans = [e for e in evs if e.get("ph") == "X"]
        named: dict[str, list[dict[str, Any]]] = {}
        for s in spans:
            named.setdefault(s["name"], []).append(s)
        root = None
        for name in named:
            if name.startswith("ps.") and "." not in name[3:]:
                root = max(named[name], key=lambda s: s.get("dur", 0.0))
                break
        if root is None and named.get("step"):
            root = max(named["step"], key=lambda s: s.get("dur", 0.0))
        if root is None:
            # raw client: a parentless rpc.<cmd> span is the op
            cands = [
                s for s in spans
                if s["name"].startswith("rpc.")
                and not s["name"].startswith("rpc.serve.")
                and "parent_id" not in (s.get("args") or {})
            ]
            if cands:
                root = max(cands, key=lambda s: s.get("dur", 0.0))
        if root is not None and root["name"] == "step":
            ops.append(_step_op(tid, root, named))
            continue
        if root is None:
            continue
        cmd = root["name"].rsplit(".", 1)[-1]
        op: dict[str, Any] = {
            "cmd": cmd, "tid": tid, "skewed": False,
            "ts": root.get("ts", 0.0) / 1e6,
            "procs": len({e.get("pid") for e in evs}),
        }
        rpc = (
            max(named.get(f"rpc.{cmd}", []), key=_span_end)
            if named.get(f"rpc.{cmd}") and root["name"] != f"rpc.{cmd}"
            else root if root["name"] == f"rpc.{cmd}" else None
        )
        serve = (
            max(named.get(f"rpc.serve.{cmd}", []), key=_span_end)
            if named.get(f"rpc.serve.{cmd}") else None
        )
        upd = (
            max(named.get("server.updater", []), key=_span_end)
            if named.get("server.updater") else None
        )
        flows = [
            e for e in evs
            if e.get("ph") == "f" and e["name"] == f"ps.{cmd}.inflight"
        ]
        t0_us = root["ts"]
        done_us = max(
            [f["ts"] for f in flows] + [_span_end(s) for s in spans]
        )
        total_us = max(done_us - t0_us, 0.0)
        seg_us: dict[str, float] = {}
        if rpc is not None:
            seg_us["encode"] = _clamp(rpc["ts"] - t0_us, op)
            seg_us["client_queue"] = rpc.get("dur", 0.0)
            issue_end_us = _span_end(rpc)
        else:
            issue_end_us = t0_us
        if serve is not None:
            seg_us["wire"] = _clamp(serve["ts"] - issue_end_us, op)
            seg_us["server"] = serve.get("dur", 0.0)
            tail_start_us = _span_end(serve)
            # the apply segments exist only on the BATCHED path, where
            # the updater span runs on the apply thread after dispatch
            # returned; an updater span nested inside the serve span is
            # the inline path — its time is already in "server"
            if upd is not None and upd["ts"] >= tail_start_us:
                gap_us = _clamp(_span_end(upd) - tail_start_us, op)
                # the marker fires AFTER the apply with the MEASURED
                # jitted-apply time in its args (multislice stamps
                # apl_us) — a first-batch jit compile lands in "apply",
                # not in the queue-wait column; the gap's remainder is
                # the real apply_wait
                apl_us = min(
                    float((upd.get("args") or {}).get(
                        "apl_us", upd.get("dur", 0.0)
                    )),
                    gap_us,
                )
                seg_us["apply_wait"] = gap_us - apl_us
                seg_us["apply"] = apl_us
                tail_start_us = max(tail_start_us, _span_end(upd))
            seg_us["reply_lane"] = _clamp(done_us - tail_start_us, op)
        else:
            # server segment missing (not captured/rescued): everything
            # past the issue span is wire-or-beyond — an honest catch-all
            seg_us["wire"] = _clamp(done_us - issue_end_us, op)
        _cap_to_total(seg_us, total_us, op)
        covered = sum(seg_us.values())
        seg_us["other"] = max(total_us - covered, 0.0)
        op["dur_ms"] = round(total_us / 1e3, 3)
        op["segments"] = {
            k: round(v / 1e3, 3) for k, v in seg_us.items() if v > 0.0
        }
        op["pct"] = _pct(seg_us, total_us)
        ops.append(op)
    return ops


def _step_op(
    tid: str, root: dict[str, Any], named: dict[str, list[dict[str, Any]]]
) -> dict[str, Any]:
    """Worker step anatomy: the ``step`` span's children are already the
    segmentation (ssp_wait / pull / compute); pushes stay in flight past
    the span, so the step op covers the synchronous part only."""
    op: dict[str, Any] = {
        "cmd": "step", "tid": tid, "skewed": False,
        "ts": root.get("ts", 0.0) / 1e6, "procs": 1,
    }
    total_us = root.get("dur", 0.0)
    seg_us: dict[str, float] = {}
    for child, seg in (
        ("step.ssp_wait", "ssp_wait"),
        ("step.pull", "wire"),
        ("step.compute", "other"),
    ):
        if named.get(child):
            seg_us[seg] = sum(s.get("dur", 0.0) for s in named[child])
    covered = sum(seg_us.values())
    seg_us["other"] = seg_us.get("other", 0.0) + max(total_us - covered, 0.0)
    op["dur_ms"] = round(total_us / 1e3, 3)
    op["segments"] = {
        k: round(v / 1e3, 3) for k, v in seg_us.items() if v > 0.0
    }
    op["pct"] = _pct(seg_us, total_us)
    return op


def _pct(seg_us: dict[str, float], total_us: float) -> dict[str, float]:
    if total_us <= 0:
        return {}
    return {
        k: round(100.0 * v / total_us, 1)
        for k, v in seg_us.items() if v > 0.0
    }


# -- blackbox mode ----------------------------------------------------------


def ops_from_blackbox(
    timeline: list[dict[str, Any]],
) -> list[dict[str, Any]]:
    """(cid, seq)-stitched chains from flight-recorder wreckage:
    ``rpc.issue`` (client) -> ``rpc.in`` (server) -> ``apply.commit``
    (server, via its pairs) -> ``rpc.reply`` (client). Coarser than
    trace mode (three segments) but needs nothing armed beyond the
    always-on black box."""
    from parameter_server_tpu_torch.utils.postmortem import stitch_calls

    ops: list[dict[str, Any]] = []
    for (cid, seq), evs in stitch_calls(timeline).items():
        issue = reply = first_in = commit = None
        cmd = None
        for e in evs:
            et = e["etype"]
            if et == "rpc.issue" and issue is None:
                issue, cmd = e, e["args"].get("cmd")
            elif et == "rpc.in" and first_in is None:
                first_in = e
            elif et in ("apply.commit", "apply.replay"):
                commit = e if commit is None else commit
            elif et == "rpc.reply":
                reply = e  # last reply wins: retries re-deliver
        if issue is None or reply is None:
            continue  # a half chain can't be segmented honestly
        op: dict[str, Any] = {
            "cmd": cmd or "?", "tid": f"{cid}/{seq}", "skewed": False,
            "ts": issue["ts"],
            "procs": len({(e["proc"], e["pid"]) for e in evs}),
        }
        t0_us = issue["ts"] * 1e6
        done_us = reply["ts"] * 1e6
        total_us = max(done_us - t0_us, 0.0)
        seg_us: dict[str, float] = {}
        if first_in is not None:
            in_ts_us = first_in["ts"] * 1e6
            seg_us["wire"] = _clamp(in_ts_us - t0_us, op)
            srv_end_us = in_ts_us
            if commit is not None:
                seg_us["server"] = _clamp(commit["ts"] * 1e6 - in_ts_us, op)
                srv_end_us = commit["ts"] * 1e6
            seg_us["reply_lane"] = _clamp(done_us - srv_end_us, op)
        _cap_to_total(seg_us, total_us, op)
        covered = sum(seg_us.values())
        seg_us["other"] = max(total_us - covered, 0.0)
        op["dur_ms"] = round(total_us / 1e3, 3)
        op["segments"] = {
            k: round(v / 1e3, 3) for k, v in seg_us.items() if v > 0.0
        }
        op["pct"] = _pct(seg_us, total_us)
        ops.append(op)
    return ops


# -- aggregation ------------------------------------------------------------


def aggregate(
    ops: list[dict[str, Any]], top: int = 5
) -> dict[str, dict[str, Any]]:
    """Per-cmd window view: op-latency p50/p99, per-segment p99s,
    duration-weighted attribution percentages, the top-K slowest ops
    (duration-descending, full breakdowns attached) and the skew
    count."""
    by_cmd: dict[str, list[dict[str, Any]]] = {}
    for op in ops:
        by_cmd.setdefault(op["cmd"], []).append(op)
    out: dict[str, dict[str, Any]] = {}
    for cmd, group in sorted(by_cmd.items()):
        durs = [op["dur_ms"] for op in group]
        seg_tot: dict[str, float] = {}
        seg_vals: dict[str, list[float]] = {}
        for op in group:
            for k, v in op.get("segments", {}).items():
                seg_tot[k] = seg_tot.get(k, 0.0) + v
                seg_vals.setdefault(k, []).append(v)
        total = sum(durs) or 1.0
        slowest = sorted(group, key=lambda o: -o["dur_ms"])[:top]
        out[cmd] = {
            "n": len(group),
            "p50_ms": round(_percentile(durs, 0.5), 3),
            "p99_ms": round(_percentile(durs, 0.99), 3),
            "attribution_pct": {
                k: round(100.0 * v / total, 1)
                for k, v in sorted(seg_tot.items(), key=lambda kv: -kv[1])
            },
            "segments_p99_ms": {
                k: round(_percentile(v, 0.99), 3)
                for k, v in sorted(seg_vals.items())
            },
            "slowest": slowest,
            "skewed": sum(1 for op in group if op.get("skewed")),
        }
    return out


def analyze_dir(path: str, top: int = 5) -> dict[str, Any]:
    """End-to-end over a capture dir, auto-detected: ``blackbox-*.json``
    dumps -> blackbox mode, else trace mode."""
    names = os.listdir(path)
    if any(
        fn.startswith("blackbox-") and fn.endswith(".json") for fn in names
    ):
        from parameter_server_tpu_torch.utils.postmortem import (
            load_dumps,
            merge_timeline,
        )

        ops = ops_from_blackbox(merge_timeline(load_dumps(path)))
        mode = "blackbox"
    else:
        ops = ops_from_trace(load_trace_dir(path))
        mode = "trace"
    return {
        "mode": mode,
        "ops": len(ops),
        "skewed_ops": sum(1 for op in ops if op.get("skewed")),
        "cmds": aggregate(ops, top=top),
    }


def analyze_live(rep: dict[str, Any], top: int = 5) -> dict[str, Any]:
    """The live-cluster view from one coordinator ``telemetry`` reply:
    the heartbeat-piggybacked slowest-K records (utils/metrics.py
    SlowOps — client wall time split by the reply's server-timing echo)
    shaped like the offline aggregate so one renderer serves both."""
    merged = rep.get("merged") or {}
    cmds: dict[str, dict[str, Any]] = {}
    for cmd, recs in sorted((merged.get("slow") or {}).items()):
        ops = []
        for r in recs[:top]:
            seg = dict(r.get("seg") or {})
            dur = float(r.get("dur_ms", 0.0))
            covered = sum(seg.values())
            if seg and dur > covered:
                seg["other"] = round(dur - covered, 3)
            op = {
                "cmd": cmd, "dur_ms": dur, "segments": seg,
                "pct": {
                    k: round(100.0 * v / dur, 1)
                    for k, v in seg.items() if dur > 0
                },
                "ts": r.get("ts"), "skewed": False,
            }
            if r.get("tid"):
                op["tid"] = r["tid"]
            ops.append(op)
        seg_tot: dict[str, float] = {}
        for op in ops:
            for k, v in op["segments"].items():
                seg_tot[k] = seg_tot.get(k, 0.0) + v
        total = sum(op["dur_ms"] for op in ops) or 1.0
        cmds[cmd] = {
            "n": len(recs),
            "p50_ms": round(_percentile(
                [float(r.get("dur_ms", 0.0)) for r in recs], 0.5
            ), 3),
            "p99_ms": round(_percentile(
                [float(r.get("dur_ms", 0.0)) for r in recs], 0.99
            ), 3),
            "attribution_pct": {
                k: round(100.0 * v / total, 1)
                for k, v in sorted(seg_tot.items(), key=lambda kv: -kv[1])
            },
            "segments_p99_ms": {},
            "slowest": ops,
            "skewed": 0,
        }
    return {
        "mode": "live",
        "ops": sum(c["n"] for c in cmds.values()),
        "skewed_ops": 0,
        "cmds": cmds,
    }


# -- report -----------------------------------------------------------------


def render_report(summary: dict[str, Any], top: int = 5) -> str:
    """The human ``cli whylate`` output: per cmd, the window's latency
    and the slowest ops with their segment breakdowns."""
    lines = [
        f"whylate — {summary['ops']} op(s) stitched "
        f"({summary['mode']} mode)"
        + (
            f", {summary['skewed_ops']} clock-skew-clamped"
            if summary.get("skewed_ops") else ""
        )
    ]
    for cmd, agg in summary.get("cmds", {}).items():
        lines.append("")
        lines.append(
            f"{cmd}: n={agg['n']} p50={agg['p50_ms']}ms "
            f"p99={agg['p99_ms']}ms"
            + (f"  [{agg['skewed']} skewed]" if agg.get("skewed") else "")
        )
        att = agg.get("attribution_pct") or {}
        if att:
            lines.append(
                "  attribution: "
                + "  ".join(f"{k} {v}%" for k, v in att.items())
            )
        for op in (agg.get("slowest") or [])[:top]:
            segs = op.get("segments") or {}
            ordered = sorted(segs.items(), key=lambda kv: -kv[1])
            lines.append(
                f"  slow {op['dur_ms']:>9.3f}ms"
                + (f" tid={op['tid']}" if op.get("tid") else "")
                + (" SKEWED" if op.get("skewed") else "")
                + "  "
                + "  ".join(f"{k}={v}ms" for k, v in ordered)
            )
    if not summary.get("cmds"):
        lines.append("no stitchable ops found")
    return "\n".join(lines)


# -- baseline gate (the pslint --baseline pattern) --------------------------


def load_baseline(path: str) -> dict[str, Any]:
    with open(path) as f:
        doc = json.load(f)
    if "budgets_ms" not in doc:
        raise ValueError(
            f"{path}: not a whylate baseline (missing budgets_ms)"
        )
    return doc


def check_baseline(
    summary: dict[str, Any], baseline: dict[str, Any]
) -> list[dict[str, Any]]:
    """Per-segment budget findings: a (cmd, segment) whose measured p99
    exceeds its budget is a WARN; past ``hard_factor`` x budget it is an
    ERROR. Segments without budgets are ungated (new instrumentation
    never fails CI until someone budgets it)."""
    hard = float(baseline.get("hard_factor", 2.0))
    out: list[dict[str, Any]] = []
    for cmd, budgets in sorted((baseline.get("budgets_ms") or {}).items()):
        agg = (summary.get("cmds") or {}).get(cmd)
        if agg is None:
            continue  # nothing measured for this cmd: nothing regressed
        measured = agg.get("segments_p99_ms") or {}
        for seg, budget in sorted(budgets.items()):
            got = measured.get(seg)
            if got is None or got <= float(budget):
                continue
            out.append({
                "cmd": cmd,
                "segment": seg,
                "p99_ms": got,
                "budget_ms": float(budget),
                "tier": "error" if got > hard * float(budget) else "warn",
            })
    return out


def baseline_exit_code(findings: list[dict[str, Any]]) -> int:
    """pslint's tiered convention: 1 = hard (error-tier) regressions,
    2 = soft (warn-tier only), 0 = within budget."""
    if any(f["tier"] == "error" for f in findings):
        return 1
    return 2 if findings else 0


def update_baseline(
    summary: dict[str, Any], path: str, slack: float = 2.0
) -> dict[str, Any]:
    """Rewrite the baseline from the current capture: each measured
    per-segment p99 x ``slack`` becomes the budget (floored at 1 ms so
    scheduler jitter can't institutionalize a microsecond budget)."""
    budgets: dict[str, dict[str, float]] = {}
    for cmd, agg in (summary.get("cmds") or {}).items():
        segs = {
            seg: round(max(v * slack, 1.0), 3)
            for seg, v in (agg.get("segments_p99_ms") or {}).items()
        }
        if segs:
            budgets[cmd] = segs
    doc = {"version": 1, "hard_factor": 2.0, "budgets_ms": budgets}
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f, indent=1, sort_keys=True)
        f.write("\n")
    os.replace(tmp, path)
    return doc
