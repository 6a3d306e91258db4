"""Cluster postmortem: merge per-node black-box dumps into one causal
timeline and name what went wrong.

Input: a ``PS_BLACKBOX_DIR`` full of ``blackbox-<proc>-<pid>.json``
dumps (utils/flightrec.py — one per process, written by the periodic
flusher, the stall watchdog, crash hooks or at exit). Output, via
``cli postmortem <dir>``:

- a **merged timeline**: every process's ring events on one wall-clock
  axis, each stamped with its process name/pid/tid;
- **cross-process stitching**: RPC events carry (cid, seq), so one
  logical push shows up as client ``rpc.issue`` -> server ``rpc.in`` ->
  server ``apply.commit`` -> client ``rpc.reply`` — the postmortem's
  analog of the tracing plane's trace-id propagation, but reconstructed
  from the wreckage instead of recorded live;
- **anomaly flags**: acked-but-unapplied pushes (a client holds an ok
  push reply no surviving server ledgered), RCU version regressions
  within one server life, reconnects that never healed, shed storms,
  and any watchdog stall dumps (source + thread named). The protocol
  detectors are not local code: they ARE the shared streaming monitors
  (analysis/monitors.py) the live audit plane (utils/auditor.py) runs
  at the coordinator, fed the merged timeline with end-of-stream
  semantics — one automaton per invariant, so the live and postmortem
  planes cannot drift. What stays postmortem-specific is
  the EVIDENCE gating: a live stream is complete by construction, a
  pile of wreckage is not, so acked-but-unapplied verdicts here are
  additionally gated on a surviving server box that saw the cid within
  its retained ring window;
- a **Perfetto-loadable** rendering through the existing trace exporter
  (``trace.write_chrome_trace``): load the merged timeline next to a
  trace of the same run;
- the merged **per-key heat** view (telemetry ``key_heat`` snapshots
  ride every dump) — which keys were hot when the music stopped.
"""

from __future__ import annotations

import json
import os
from typing import Any

from parameter_server_tpu_torch.utils.metrics import heat_top, merge_heat_snapshots

#: dump filename prefix (see flightrec.dump)
_PREFIX = "blackbox-"

#: the declared PASS-THROUGH inventory: flight-recorder events this
#: plane knows about but interprets only as timeline context — they are
#: stitched by (cid, seq) when they carry one (rpc.issue/rpc.out) and
#: rendered on the merged timeline, but no anomaly detector keys off
#: them. The pslint ``flightrec-contract`` checker diffs this set plus
#: the detectors' literal etype comparisons against every
#: ``flightrec.record()`` call site package-wide, BOTH ways: an emitted
#: event missing here (and from every detector) is wreckage nobody will
#: interpret; a name listed here that nobody emits is rename drift.
#: Growing this set is a deliberate, reviewed act.
_CONTEXT_EVENTS = frozenset({
    "apply.begin",       # multislice: batch entered the apply engine
    "coord.dead_worker", # coordinator sweep promoted a dead worker
    "freshness.serve",   # client serve booked a realized data age
    "heartbeat.beat",    # reporter liveness tick
    "mesh.apply",        # mesh backend: sharded update dispatched
    "mesh.pull",         # mesh backend: gather+psum pull issued
    "mesh.push",         # mesh backend: push payload (bytes post-quant)
    "prof.dump",         # continuous profiler wrote its exports
    "range.roll",        # beat guard rolled the per-range matrix
    "rpc.conn_died",     # wire: connection death observed
    "rpc.issue",         # client issue side of the (cid, seq) stitch
    "rpc.out",           # frame left the process
    "signal",            # fatal-signal crash hook fired
    "step.dispatch",     # trainer step anatomy
    "step.retire",
    "thread.exception",  # threading.excepthook crash hook fired
    "trace.promote",     # tail capture promoted a head-dropped trace
    "ts.roll",           # local time-series ring rolled a delta
    "watchdog.stall",    # stall firing (the dump's stalls list is the
                         # detector's source; the event is context)
})

#: the detectors'/stitchers' etype literals complementing
#: _CONTEXT_EVENTS for the RUNTIME unknown-event check below. The
#: protocol detectors are the shared streaming monitors, so their
#: consumed-event sets are UNIONED in from the registry.
from parameter_server_tpu_torch.analysis.monitors import monitor_events as _mev

_DETECTOR_EVENTS = frozenset({
    "rpc.in",           # evidence windows (which server boxes saw a cid)
    "slo.alert",        # burn-rate engine firings
    "audit.violation",  # the live auditor's own verdicts
}) | _mev()


def unknown_events(timeline: list[dict[str, Any]]) -> dict[str, int]:
    """etype -> count for merged-timeline events NEITHER a detector nor
    the pass-through inventory knows. Nonempty means the dumps came from
    a build newer than this postmortem code (or flightrec-contract was
    bypassed) — the events still render on the timeline, but nothing
    interprets them."""
    seen: dict[str, int] = {}
    for ev in timeline:
        et = ev["etype"]
        if et not in _CONTEXT_EVENTS and et not in _DETECTOR_EVENTS:
            seen[et] = seen.get(et, 0) + 1
    return seen


def load_dumps(box_dir: str) -> list[dict[str, Any]]:
    """Every parseable ``blackbox-*.json`` in the dir (skipping torn or
    foreign files — a postmortem must work with whatever survived)."""
    out: list[dict[str, Any]] = []
    for fn in sorted(os.listdir(box_dir)):
        if not (fn.startswith(_PREFIX) and fn.endswith(".json")):
            continue
        try:
            with open(os.path.join(box_dir, fn)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        if doc.get("schema") != "psbb/1":
            continue
        doc["_file"] = fn
        out.append(doc)
    return out


def crash_sidecars(box_dir: str) -> list[str]:
    """faulthandler ``.crash.txt`` sidecars present in the dir (a fatal
    signal dumped C-level stacks there; surfaced, not parsed)."""
    return sorted(
        fn
        for fn in os.listdir(box_dir)
        if fn.startswith(_PREFIX) and fn.endswith(".crash.txt")
        and os.path.getsize(os.path.join(box_dir, fn)) > 0
    )


def merge_timeline(dumps: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """All dumps' ring events on one wall-clock axis (ts ascending),
    each normalized to {ts, proc, pid, tid, etype, args}."""
    out: list[dict[str, Any]] = []
    for d in dumps:
        proc, pid = d.get("process", "?"), d.get("pid", 0)
        for ev in d.get("events", []):
            try:
                ts, tid, etype, args = ev
            except (TypeError, ValueError):
                continue
            out.append({
                "ts": float(ts), "proc": proc, "pid": pid, "tid": tid,
                "etype": etype, "args": args or {},
            })
    out.sort(key=lambda e: e["ts"])
    return out


def _call_key(ev: dict[str, Any]) -> tuple[str, str] | None:
    a = ev["args"]
    cid, seq = a.get("cid"), a.get("seq")
    if cid is None or seq is None:
        return None
    return (str(cid), str(seq))


def stitch_calls(
    timeline: list[dict[str, Any]],
) -> dict[tuple[str, str], list[dict[str, Any]]]:
    """Group events by (cid, seq) — the wire's dedup identity doubles as
    the postmortem's stitch key. ``apply.commit`` events contribute every
    (cid, seq) pair in their batch."""
    out: dict[tuple[str, str], list[dict[str, Any]]] = {}
    for ev in timeline:
        k = _call_key(ev)
        if k is not None:
            out.setdefault(k, []).append(ev)
        for pair in ev["args"].get("pairs", ()):
            try:
                cid, seq = pair
            except (TypeError, ValueError):
                continue
            if cid is None:
                continue
            out.setdefault((str(cid), str(seq)), []).append(ev)
    return out


def find_anomalies(
    dumps: list[dict[str, Any]],
    timeline: list[dict[str, Any]],
    shed_storm_n: int = 10,
    shed_window_s: float = 1.0,
) -> list[dict[str, Any]]:
    """The flag list (each: {kind, detail fields...}), most severe first."""
    out: list[dict[str, Any]] = []

    # watchdog stalls: the dump itself names the sources and threads
    # (the full firing history when present; older/synthetic dumps fall
    # back to the trigger reasons + the last firing's extra)
    for d in dumps:
        stalls = d.get("stalls")
        if stalls is None:
            stalls = []
            for r in d.get("trigger_reasons", []):
                if not r.startswith("stall:"):
                    continue
                src = r[len("stall:"):]
                st = d.get("stall") or {}
                if st.get("source") not in (None, src):
                    st = {}  # the extra belongs to a different firing
                stalls.append({
                    "source": st.get("source", src),
                    "thread": st.get("thread", ""),
                    "stalled_s": st.get("stalled_s"),
                })
        for st in stalls:
            out.append({
                "kind": "stall",
                "proc": d.get("process"),
                "source": st.get("source"),
                "thread": st.get("thread", ""),
                "stalled_s": st.get("stalled_s"),
            })
        for r in d.get("trigger_reasons", []):
            if r.startswith("thread-exception"):
                out.append({
                    "kind": "thread-exception",
                    "proc": d.get("process"),
                    "detail": r,
                })

    calls = stitch_calls(timeline)

    # The protocol detectors: the SHARED streaming monitors
    # (analysis/monitors.py), fed the merged timeline offline — life is
    # (proc, pid), the watermark clock is event time, and finish()
    # judges everything still unpaired at end-of-stream. The live
    # auditor (utils/auditor.py) runs the same automata at the
    # coordinator, so the two planes flag the same anomaly set from the
    # same event stream by construction.
    from parameter_server_tpu_torch.analysis import monitors as monitors_mod

    mons = monitors_mod.make_monitors(
        shed_storm_n=shed_storm_n, shed_storm_window_s=shed_window_s,
    )
    viols: list[dict[str, Any]] = []
    for ev in timeline:
        nev = {
            "ts": ev["ts"], "life": (ev["proc"], ev["pid"]),
            "etype": ev["etype"], "args": ev["args"], "at": ev["ts"],
        }
        for m in mons:
            if ev["etype"] in m.EVENTS:
                viols += m.feed(nev)
    for m in mons:
        viols += m.finish()

    # Postmortem-specific EVIDENCE gating for acked-but-unapplied: only
    # judged when a server dump that saw THIS cid exists (otherwise the
    # server's box simply didn't survive, which is absence of
    # evidence), and only for acks inside that server ring's retained
    # window. The ring is bounded: a server records more events per
    # push than the client, so on a long healthy run the oldest client
    # replies outlive their commits' ring slots — those are evictions,
    # not anomalies. A commit always precedes the ack it triggers, so
    # an ack at ts >= the server window start would have its commit
    # retained.
    win_start: dict[tuple[str, int], float] = {}
    for ev in timeline:  # ts-sorted: first hit is each box's oldest event
        win_start.setdefault((ev["proc"], ev["pid"]), ev["ts"])
    server_cid_win: dict[str, float] = {}
    for ev in timeline:
        if ev["etype"] in ("rpc.in", "apply.commit", "apply.replay"):
            cids = []
            cid = ev["args"].get("cid")
            if cid is not None:
                cids.append(str(cid))
            for pair in ev["args"].get("pairs", ()):
                if pair and pair[0] is not None:
                    cids.append(str(pair[0]))
            w = win_start[(ev["proc"], ev["pid"])]
            for c in cids:
                server_cid_win[c] = min(server_cid_win.get(c, w), w)

    for v in viols:
        kind = v["kind"]
        if kind == "acked-but-unapplied":
            cid, seq = v["cid"], v["seq"]
            win = server_cid_win.get(cid)
            if win is None or v.get("ack_ts", 0.0) < win:
                continue  # no surviving server evidence: no verdict
            out.append({
                "kind": kind, "cid": cid, "seq": seq,
                "procs": sorted(
                    {e["proc"] for e in calls.get((cid, seq), ())}
                ),
            })
        elif kind in ("version-regression", "reconnect-without-heal"):
            proc, pid = v["life"]
            flat = {
                k: x for k, x in v.items()
                if k not in ("life", "monitor")
            }
            out.append({**flat, "proc": proc, "pid": pid})
        else:  # shed-storm, double-applied, ssp-staleness, future kinds
            flat = {
                k: x for k, x in v.items() if k not in ("life", "monitor")
            }
            out.append(flat)

    # SLO alerts: the coordinator's burn-rate engine fired —
    # each rising edge is one episode, rendered with its burn multiples
    # so the postmortem reads "which objective was burning, how hard"
    for ev in timeline:
        if ev["etype"] == "slo.alert":
            a = ev["args"]
            out.append({
                "kind": "slo-alert",
                "proc": ev["proc"],
                "rule": a.get("rule"),
                "node": a.get("node"),
                "burn_short": a.get("burn_short"),
                "burn_long": a.get("burn_long"),
                "ts": ev["ts"],
            })

    # audit.violation: the LIVE auditor's verdicts land in
    # the coordinator's black box — a postmortem over a cluster that
    # ran with the audit plane armed replays what the sentinel saw
    for ev in timeline:
        if ev["etype"] == "audit.violation":
            a = ev["args"]
            out.append({
                "kind": "audit-violation",
                "proc": ev["proc"],
                "violation": a.get("kind"),
                "node": a.get("node"),
                "ts": ev["ts"],
                **{
                    k: a[k] for k in ("cid", "seq", "worker") if k in a
                },
            })
    return out


def merged_heat(dumps: list[dict[str, Any]]) -> dict[str, Any]:
    """The cluster's per-key heat at dump time (telemetry piggyback)."""
    return merge_heat_snapshots([
        (d.get("telemetry") or {}).get("key_heat") or {} for d in dumps
    ])


def to_trace_events(timeline: list[dict[str, Any]]) -> list[dict[str, Any]]:
    """The merged timeline as Chrome instant events (one Perfetto track
    per process/thread, same schema the tracing plane exports)."""
    return [
        {
            "name": ev["etype"],
            "cat": "blackbox",
            "ph": "i",
            "s": "t",
            "ts": ev["ts"] * 1e6,
            "pid": ev["pid"],
            "tid": ev["tid"],
            "args": dict(ev["args"]),
        }
        for ev in timeline
    ]


def export_trace(
    dumps: list[dict[str, Any]],
    timeline: list[dict[str, Any]],
    path: str,
) -> str:
    """Write the Perfetto-loadable rendering via the existing trace
    exporter (thread names recovered from each dump's stack section)."""
    from parameter_server_tpu_torch.utils import trace

    tnames: dict[tuple[int, int], str] = {}
    for d in dumps:
        for t in d.get("threads", []):
            # events record thread IDENTS (the cheap id — see
            # flightrec._live_record); the dump's thread table maps them
            # back to names
            ident = t.get("ident")
            if ident is not None:
                tnames[(d.get("pid", 0), ident)] = t.get("name", "")
    return trace.write_chrome_trace(
        to_trace_events(timeline), path,
        process_names={
            d.get("pid", 0): d.get("process", "?") for d in dumps
        },
        thread_names=tnames,
    )


def render_report(
    dumps: list[dict[str, Any]],
    timeline: list[dict[str, Any]],
    anomalies: list[dict[str, Any]],
    tail: int = 40,
) -> str:
    """The human postmortem: per-process box inventory, anomaly flags,
    hot keys, and the merged timeline's tail."""
    lines = [f"postmortem over {len(dumps)} process box(es)"]
    lines.append("")
    lines.append(
        f"{'process':<18} {'pid':>7} {'events':>7} {'reason':<24} window"
    )
    for d in dumps:
        evs = d.get("events", [])
        window = (
            f"{evs[0][0]:.3f} .. {evs[-1][0]:.3f}" if evs else "-"
        )
        lines.append(
            f"{d.get('process', '?'):<18} {d.get('pid', 0):>7} "
            f"{len(evs):>7} {str(d.get('reason', '?')):<24} {window}"
        )
    lines.append("")
    if anomalies:
        lines.append(f"ANOMALIES ({len(anomalies)}):")
        for a in anomalies:
            kind = a["kind"]
            rest = ", ".join(
                f"{k}={v}" for k, v in a.items() if k != "kind"
            )
            lines.append(f"  [{kind}] {rest}")
    else:
        lines.append("no anomalies flagged")
    unknown = unknown_events(timeline)
    if unknown:
        lines.append("")
        lines.append(
            f"UNINTERPRETED event type(s) ({len(unknown)}) — dumps from "
            "a newer build than this postmortem code?"
        )
        for et, n in sorted(unknown.items()):
            lines.append(f"  {et} x{n}")
    heat = merged_heat(dumps)
    if heat:
        lines.append("")
        lines.append(
            f"hot keys at dump time ({heat.get('n', 0)} accesses, top 10):"
        )
        for key, c in heat_top(heat, 10):
            lines.append(f"  key {key:<24} ~{c}")
    if timeline:
        lines.append("")
        lines.append(f"merged timeline (last {min(tail, len(timeline))} "
                     f"of {len(timeline)} events):")
        for ev in timeline[-tail:]:
            args = " ".join(
                f"{k}={v}" for k, v in sorted(ev["args"].items())
                if k != "pairs"
            )
            lines.append(
                f"  {ev['ts']:.6f} {ev['proc']:<14} tid={ev['tid']:<8} "
                f"{ev['etype']:<20} {args}"
            )
    return "\n".join(lines)


def postmortem(
    box_dir: str, trace_out: str = "", tail: int = 40,
) -> dict[str, Any]:
    """End-to-end: load, merge, stitch, flag, render. Returns the
    machine-readable summary (the CLI prints the human report first)."""
    dumps = load_dumps(box_dir)
    timeline = merge_timeline(dumps)
    anomalies = find_anomalies(dumps, timeline)
    calls = stitch_calls(timeline)
    cross = sorted(
        k for k, evs in calls.items()
        if len({(e["proc"], e["pid"]) for e in evs}) >= 2
    )
    out: dict[str, Any] = {
        "processes": len(dumps),
        "events": len(timeline),
        "stitched_calls": len(calls),
        "cross_process_calls": len(cross),
        "anomalies": anomalies,
        "unknown_events": unknown_events(timeline),
        "crash_sidecars": crash_sidecars(box_dir) if dumps else [],
        "report": render_report(dumps, timeline, anomalies, tail=tail),
    }
    heat = merged_heat(dumps)
    if heat:
        out["heat_top"] = heat_top(heat, 10)
    if trace_out:
        out["trace_out"] = export_trace(dumps, timeline, trace_out)
    return out
