"""SLO burn-rate engine + the live ``cli top`` dashboard renderer.

Reference analog: none — the reference's operator watched glog scroll.
This is the alerting half of the live operations plane:
declarative ``[slo]`` rules (utils/config.py SloConfig documents the
grammar) are evaluated as **multi-window burn rates** over each node's
time-series ring (utils/timeseries.py) at the coordinator:

- a rule's *bad fraction* over a window is the dt-weighted fraction of
  ring entries violating the threshold (rate rules compare each entry's
  counter delta / dt; percentile rules compare each entry's histogram
  delta's p50/p99);
- the *burn rate* is ``bad_fraction / (1 - target)`` — how many times
  faster than budget the error budget is burning (the SRE-workbook
  multi-window alert, scaled to a cluster that measures in heartbeats);
- an alert **fires once per episode**: the rising edge requires the
  burn to exceed the rule's threshold in BOTH the short window (it is
  happening now) and the long window (it is sustained, not a blip);
  the episode stays active while EITHER window still burns, and only a
  full recovery re-arms it. Rising edges record a ``slo.alert``
  flight-recorder event (+ the ``slo_alerts`` counter), so every alert
  lands in the black box and ``cli postmortem`` renders it.

Per-node **health** is the fraction of data-bearing rules not burning
(scored 0-100); a rule whose series has no data in the window neither
burns nor counts — ``replication_lag_s`` stays declared-but-dormant
until direction #1 emits it.

``format_top`` renders the auto-refreshing ``cli top`` frame from the
coordinator ``telemetry`` reply: per-node windowed rates + p99s, the
health column, hot keys (the heat sketch) and the active alerts.
"""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field
from typing import Any

from parameter_server_tpu_torch.utils import flightrec
from parameter_server_tpu_torch.utils.metrics import (
    heat_top,
    hist_percentile,
    owning_range,
    split_range_series,
    wire_counters,
)
from parameter_server_tpu_torch.utils.timeseries import (
    LEGACY_SERIES,
    TimeSeriesRing,
    canonical_series,
    series_scale,
)


@dataclass
class SloRule:
    """One parsed rule (grammar: utils/config.py SloConfig)."""

    name: str
    kind: str  # rate | p50 | p99
    series: str
    threshold: float
    target: float = 0.99
    burn: float = 10.0

    @property
    def budget(self) -> float:
        return max(1.0 - self.target, 1e-9)


_KINDS = ("rate", "p50", "p99")


def parse_rule(spec: str) -> SloRule:
    """``<name> <kind>:<series> <= <threshold> [target f] [burn x]``."""
    toks = spec.split()
    if len(toks) < 4 or toks[2] != "<=":
        raise ValueError(
            f"bad [slo] rule {spec!r}: expected "
            "'<name> <kind>:<series> <= <threshold> [target f] [burn x]'"
        )
    kind, _, series = toks[1].partition(":")
    if kind not in _KINDS or not series:
        raise ValueError(
            f"bad [slo] rule {spec!r}: kind must be one of {_KINDS} "
            "with a ':<series>' suffix"
        )
    rule = SloRule(
        # persisted rule strings may predate a series' unit-suffix
        # rename (serve.age -> serve.age_s): normalize at parse time
        name=toks[0], kind=kind, series=canonical_series(series),
        threshold=float(toks[3]),
    )
    rest = toks[4:]
    if len(rest) % 2:
        raise ValueError(f"bad [slo] rule {spec!r}: dangling option token")
    for k, v in zip(rest[::2], rest[1::2]):
        if k == "target":
            rule.target = float(v)
        elif k == "burn":
            rule.burn = float(v)
        else:
            raise ValueError(f"bad [slo] rule {spec!r}: unknown option {k!r}")
    return rule


def parse_rules(specs: list[str]) -> list[SloRule]:
    return [parse_rule(s) for s in specs]


@dataclass
class _Episode:
    since: float
    burn_short: float = 0.0
    burn_long: float = 0.0


@dataclass
class SloEngine:
    """Stateful multi-window evaluator (one per coordinator)."""

    rules: list[SloRule]
    short_window_s: float = 60.0
    long_window_s: float = 300.0
    _active: dict[tuple[str, str], _Episode] = field(default_factory=dict)
    episodes: int = 0  # rising edges fired this life
    # the recovery sweep and telemetry handlers evaluate concurrently;
    # episode check-then-fire must be atomic or one storm double-fires
    # (lambda, not the bare constructor: resolve threading.Lock at
    # instance-creation time so the runtime lock witness sees it)
    _lock: threading.Lock = field(default_factory=lambda: threading.Lock())

    def _bad_fraction(
        self, ring: TimeSeriesRing, rule: SloRule, window_s: float,
        now: float,
    ) -> float | None:
        """dt-weighted violating fraction over the window; None when the
        window holds no data for the rule's series (no data != bad —
        a dormant series must never page)."""
        total = bad = 0.0
        saw_data = False
        for e in ring.entries(window_s, now):
            dt = e["dt_s"]
            total += dt
            if rule.kind == "rate":
                v = e["counters"].get(rule.series, 0) / dt
                saw_data = True  # a counter absent from a delta is 0/s
            else:
                snap = e["hists"].get(rule.series)
                if snap is None:
                    # mixed-version cluster: an older node's beats still
                    # carry the pre-rename series name
                    legacy = LEGACY_SERIES.get(rule.series)
                    if legacy is not None:
                        snap = e["hists"].get(legacy)
                if not snap or not snap.get("buckets"):
                    # no observations this entry (or a bucketless
                    # saturation summary — no percentile): no verdict
                    continue
                saw_data = True
                p = 0.5 if rule.kind == "p50" else 0.99
                v = hist_percentile(snap, p) * series_scale(rule.series)
            if v > rule.threshold:
                bad += dt
        if not saw_data or total <= 0:
            return None
        return bad / total

    def evaluate(
        self,
        rings: dict[Any, TimeSeriesRing],
        now: float | None = None,
    ) -> dict[str, Any]:
        """One evaluation pass over every node's ring: returns
        ``{"alerts": [...], "health": {node: {...}}, "rules": [...]}``
        and fires/clears episodes as a side effect."""
        if now is None:
            now = time.time()
        with self._lock:
            return self._evaluate_locked(rings, now)

    def _evaluate_locked(
        self, rings: dict[Any, TimeSeriesRing], now: float
    ) -> dict[str, Any]:
        alerts: list[dict[str, Any]] = []
        health: dict[str, dict[str, Any]] = {}
        seen_keys: set[tuple[str, str]] = set()
        for node, ring in rings.items():
            nk = str(node)
            burning: list[str] = []
            evaluable = 0
            for rule in self.rules:
                fs = self._bad_fraction(ring, rule, self.short_window_s, now)
                fl = self._bad_fraction(ring, rule, self.long_window_s, now)
                if fs is None and fl is None:
                    # dormant series (e.g. replication_lag_s) — but a
                    # data GAP during an active episode must not end it:
                    # clearing here would make one sustained incident
                    # with a beat pause fire a second "rising edge" when
                    # data resumes. The episode survives (still alerted,
                    # last known burns) until real data recovers it.
                    ep = self._active.get((nk, rule.name))
                    if ep is not None:
                        seen_keys.add((nk, rule.name))
                        evaluable += 1  # still counts against health
                        burning.append(rule.name)
                        alerts.append({
                            "node": nk,
                            "rule": rule.name,
                            "burn_short": round(ep.burn_short, 1),
                            "burn_long": round(ep.burn_long, 1),
                            "since": round(ep.since, 3),
                            "stale": True,  # no fresh data this pass
                        })
                    continue
                evaluable += 1
                burn_s = (fs or 0.0) / rule.budget
                burn_l = (fl or 0.0) / rule.budget
                key = (nk, rule.name)
                seen_keys.add(key)
                ep = self._active.get(key)
                rising = burn_s >= rule.burn and burn_l >= rule.burn
                staying = burn_s >= rule.burn or burn_l >= rule.burn
                if ep is None and rising:
                    ep = self._active[key] = _Episode(since=now)
                    self.episodes += 1
                    wire_counters.inc("slo_alerts")
                    flightrec.record(
                        "slo.alert", rule=rule.name, node=nk,
                        burn_short=round(burn_s, 1),
                        burn_long=round(burn_l, 1),
                    )
                elif ep is not None and not staying:
                    # full recovery on both windows: the episode ends and
                    # the alert re-arms (fire-once-per-episode hysteresis)
                    del self._active[key]
                    ep = None
                if ep is not None:
                    ep.burn_short, ep.burn_long = burn_s, burn_l
                    burning.append(rule.name)
                    alerts.append({
                        "node": nk,
                        "rule": rule.name,
                        "burn_short": round(burn_s, 1),
                        "burn_long": round(burn_l, 1),
                        "since": round(ep.since, 3),
                    })
            score = (
                round(100.0 * (1.0 - len(burning) / evaluable))
                if evaluable else 100
            )
            health[nk] = {
                "score": score,
                "burning": burning,
                "rules_evaluated": evaluable,
            }
        # a node whose ring vanished (forgotten/dead) ends its episodes
        for key in [k for k in self._active if k not in seen_keys]:
            del self._active[key]
        return {
            "alerts": alerts,
            "health": health,
            "rules": [r.name for r in self.rules],
        }


# -- the `cli top` frame ----------------------------------------------------


def _first(d: dict[str, float], *names: str) -> float:
    for n in names:
        if n in d:
            return d[n]
    return 0.0


def format_violation(
    v: dict[str, Any], exclude: tuple[str, ...] = ("kind", "monitor"),
) -> str:
    """One audit violation as ``[kind] k=v ...`` — the ONE renderer the
    `cli audit` panel, its follow loop and `cli top` all share, so a
    new violation field shows up on every surface at once."""
    kv = " ".join(
        f"{k}={v[k]}" for k in sorted(v) if k not in exclude
    )
    return f"  [{v.get('kind')}] {kv}"


def format_top(rep: dict[str, Any], window_s: float) -> str:
    """Render one dashboard frame from a coordinator ``telemetry`` reply
    carrying ``series`` (per-node windowed summaries), ``slo`` and the
    ``audit`` plane's verdict."""
    series: dict[str, Any] = rep.get("series") or {}
    slo: dict[str, Any] = rep.get("slo") or {}
    health: dict[str, Any] = slo.get("health") or {}
    nodes: dict[str, Any] = rep.get("nodes") or {}
    audit: dict[str, Any] = rep.get("audit") or {}
    audit_nodes: dict[str, Any] = audit.get("nodes") or {}
    lines = [
        f"ps top — {len(nodes)} node(s), window {window_s:.0f}s, "
        f"{time.strftime('%H:%M:%S')}",
        "",
        f"{'node':>5} {'role':<10} {'rank':>4} {'push/s':>9} "
        f"{'pull/s':>9} {'shed/s':>8} {'p99_push':>9} {'q_p99':>7} "
        f"{'age_p99':>8} {'health':>7} {'audit':>6}  alerts",
    ]
    def _row(nid: str, role: str, rank: str) -> str:
        s = series.get(nid) or {}
        rates = s.get("rates") or {}
        p99 = s.get("p99") or {}
        h = health.get(nid) or {}
        # a node is a client OR a server of each verb: show whichever
        # side of the wire it actually observed this window
        hr = s.get("hist_rates") or {}
        push_rate = _first(hr, "server.push", "client.push")
        pull_rate = _first(hr, "server.pull", "client.pull")
        shed_rate = rates.get("serve_shed", 0.0)
        p99_push = _first(p99, "server.push", "client.push")
        q_p99 = p99.get("server.apply_queue.n", 0.0)
        # realized data age of this node's serves (ms) — the freshness
        # plane's headline number
        age_p99 = _first(p99, "serve.age_s", "serve.age")
        burning = ",".join(h.get("burning") or []) or "-"
        score = h.get("score")
        # the audit column: violations attributed to this node's event
        # stream; "ok" beats a zero so a clean column reads as a verdict
        an = audit_nodes.get(nid) or {}
        viol = int(an.get("violations") or 0)
        audit_cell = str(viol) if viol else ("ok" if an else "-")
        return (
            f"{nid:>5} {role:<10} "
            f"{rank:>4} {push_rate:>9.1f} "
            f"{pull_rate:>9.1f} {shed_rate:>8.1f} {p99_push:>9.2f} "
            f"{q_p99:>7.0f} {age_p99:>8.1f} "
            f"{(str(score) if score is not None else '-'):>7} "
            f"{audit_cell:>6}  {burning}"
        )

    for nid in sorted(nodes, key=lambda x: int(x)):
        info = nodes[nid]
        lines.append(_row(
            nid, str(info.get("role", "?")), str(info.get("rank", ""))
        ))
    if "coord" in series or "coord" in health:
        # the scheduler process itself: SSP blocked time and control-
        # plane counters live only here (it never heartbeats to itself)
        lines.append(_row("coord", "coordinator", "-"))
    alerts = slo.get("alerts") or []
    lines.append("")
    if alerts:
        lines.append(f"ACTIVE SLO ALERTS ({len(alerts)}):")
        for a in alerts:
            lines.append(
                f"  [{a['rule']}] node={a['node']} "
                f"burn_short={a['burn_short']}x burn_long={a['burn_long']}x"
            )
    else:
        lines.append("no active SLO alerts")
    total_viol = int(audit.get("total") or 0)
    if total_viol:
        lines.append("")
        lines.append(f"AUDIT VIOLATIONS ({total_viol}):")
        for v in (audit.get("recent") or [])[-5:]:
            lines.append(
                format_violation(v, exclude=("kind", "monitor", "at"))
            )
    elif audit:
        lines.append("audit: no protocol violations")
    # the latency-forensics line: the cluster's slowest push
    # of the window with its segment split (wire vs server vs apply,
    # from the reply's server-timing echo) and the tail-trace id that
    # links it to the retained trace — `cli whylate` is the deep dive
    slow = (rep.get("merged") or {}).get("slow") or {}
    worst = None
    for cmd in ("push", "pull"):
        recs = slow.get(cmd) or []
        if recs and (worst is None or recs[0].get(
            "dur_ms", 0.0
        ) > worst.get("dur_ms", 0.0)):
            worst = recs[0]
    if worst:
        seg = worst.get("seg") or {}
        parts = "  ".join(
            f"{k}={v}ms"
            for k, v in sorted(seg.items(), key=lambda kv: -kv[1])
        )
        lines.append("")
        lines.append(
            f"slowest {worst.get('cmd', '?')}: "
            f"{worst.get('dur_ms', 0.0)}ms"
            + (f"  {parts}" if parts else "")
            + (f"  tid={worst['tid']}" if worst.get("tid") else "")
        )
    # the freshness line: the window's stalest serve — the
    # worst realized data-age p99 across nodes, and the key range the
    # staleness concentrates in (`cli ranges` is the deep dive)
    stalest: tuple[str | None, float] = (None, 0.0)
    stale_rng: tuple[str | None, float] = (None, 0.0)
    for nid, s in series.items():
        for name, v in ((s or {}).get("p99") or {}).items():
            if canonical_series(name) == "serve.age_s" and v > stalest[1]:
                stalest = (nid, v)
            parsed = split_range_series(name)
            if parsed and parsed[1] == "age" and v > stale_rng[1]:
                stale_rng = (parsed[0], v)
    if stalest[0] is not None or stale_rng[0] is not None:
        bits = []
        if stalest[0] is not None:
            bits.append(f"node={stalest[0]} age_p99={stalest[1]}ms")
        if stale_rng[0] is not None:
            bits.append(f"range={stale_rng[0]} age_p99={stale_rng[1]}ms")
        lines.append("")
        lines.append("stalest serve: " + "  ".join(bits))
    heat = (rep.get("merged") or {}).get("key_heat")
    if heat:
        pairs = heat_top(heat, 5)
        if pairs:
            lines.append("")
            lines.append(
                "hot keys: "
                + "  ".join(f"{k}~{c}" for k, c in pairs)
            )
    prof = (rep.get("merged") or {}).get("prof")
    if prof:
        lines.append("")
        lines.append("hot stacks (cluster, sampled):")
        for p in prof[:3]:
            tail = ";".join(str(p.get("s", "")).split(";")[-3:])
            lines.append(f"  {p.get('n', 0):>6}  ...{tail}")
    return "\n".join(lines)


def ranges_view(rep: dict[str, Any], window_s: float) -> dict[str, Any]:
    """Aggregate a coordinator ``telemetry`` reply's per-node windowed
    series into ONE per-range traffic/freshness matrix (the `cli
    ranges` data model, also its ``--json`` document): rates sum across
    nodes (each node books its own contribution to a range's series);
    percentiles take the cross-node MAX (a summary carries no buckets
    to merge, and the worst node's p99 is the honest bound a dashboard
    wants); hot-key heat folds the merged count-min sketch onto the
    owning range."""
    series: dict[str, Any] = rep.get("series") or {}
    ranges: dict[str, dict[str, float]] = {}
    for s in series.values():
        s = s or {}
        for blk in ("rates", "hist_rates"):
            for name, v in (s.get(blk) or {}).items():
                parsed = split_range_series(name)
                if parsed is None:
                    continue
                d = ranges.setdefault(parsed[0], {})
                key = parsed[1] + "_rate"
                d[key] = round(d.get(key, 0.0) + float(v), 3)
        for blk in ("p50", "p99"):
            for name, v in (s.get(blk) or {}).items():
                parsed = split_range_series(name)
                if parsed is None:
                    continue
                d = ranges.setdefault(parsed[0], {})
                key = f"{parsed[1]}_{blk}_ms"
                d[key] = max(d.get(key, 0.0), float(v))
    rngs: list[tuple[int, int]] = []
    for rid in ranges:
        b, dash, e = rid.partition("-")
        if dash and b.isdigit() and e.isdigit():
            rngs.append((int(b), int(e)))
    rngs.sort()
    heat = (rep.get("merged") or {}).get("key_heat")
    if heat and rngs:
        for key, c in heat_top(heat, 32):
            own = owning_range(int(key), rngs)
            if own:
                rid = f"{own[1][0]}-{own[1][1]}"
                d = ranges.setdefault(rid, {})
                d["heat"] = d.get("heat", 0) + int(c)
    return {"window_s": window_s, "ranges": ranges}


def format_ranges(rep: dict[str, Any], window_s: float) -> str:
    """Render one ``cli ranges`` frame: the per-range matrix — push/pull
    rates, bytes moved, apply cost and the realized data-age
    distribution of serves touching each range — from a coordinator
    ``telemetry`` reply."""
    view = ranges_view(rep, window_s)
    ranges: dict[str, dict[str, float]] = view["ranges"]
    lines = [
        f"ps ranges — {len(ranges)} range(s), window {window_s:.0f}s, "
        f"{time.strftime('%H:%M:%S')}",
        "",
        f"{'range':<16} {'pull/s':>9} {'push/s':>9} {'out_B/s':>11} "
        f"{'in_B/s':>11} {'apply_p99':>10} {'age_p50':>9} {'age_p99':>9} "
        f"{'heat':>7}",
    ]

    def _rid_key(rid: str) -> tuple:
        b, _, _ = rid.partition("-")
        # numeric ranges in key order; the saturation fold ("other") and
        # anything unparsable sorts last
        return (0, int(b), rid) if b.isdigit() else (1, 0, rid)

    for rid in sorted(ranges, key=_rid_key):
        d = ranges[rid]
        lines.append(
            f"{rid:<16} {d.get('pull_rate', 0.0):>9.1f} "
            f"{d.get('push_rate', 0.0):>9.1f} "
            f"{d.get('pull_bytes_rate', 0.0):>11.0f} "
            f"{d.get('push_bytes_rate', 0.0):>11.0f} "
            f"{d.get('apply_p99_ms', 0.0):>10.2f} "
            f"{d.get('age_p50_ms', 0.0):>9.1f} "
            f"{d.get('age_p99_ms', 0.0):>9.1f} "
            f"{int(d.get('heat', 0)):>7}"
        )
    if not ranges:
        lines.append(
            "(no range series in the window — freshness plane idle)"
        )
    return "\n".join(lines)


def format_audit(rep: dict[str, Any]) -> str:
    """Render one ``cli audit`` frame from the coordinator's ``audit``
    reply (utils/auditor.py ``Auditor.summary``): stream accounting per
    node, violation totals by kind, and the recent-violations panel."""
    lines = [
        f"ps audit — {int(rep.get('total') or 0)} violation(s), "
        f"{int(rep.get('suppressed') or 0)} suppressed (holed stream), "
        f"{time.strftime('%H:%M:%S')}",
        "",
        f"{'node':>6} {'batches':>8} {'events':>8} {'gaps':>5} "
        f"{'dropped':>8} {'violations':>11}",
    ]
    for nk in sorted(rep.get("nodes") or {}):
        st = rep["nodes"][nk]
        lines.append(
            f"{nk:>6} {st.get('batches', 0):>8} {st.get('events', 0):>8} "
            f"{st.get('gaps', 0):>5} {st.get('dropped', 0):>8} "
            f"{st.get('violations', 0):>11}"
        )
    by_kind = rep.get("by_kind") or {}
    if by_kind:
        lines.append("")
        lines.append("violations by kind:")
        for kind in sorted(by_kind):
            lines.append(f"  {kind:<28} {by_kind[kind]}")
        lines.append("")
        lines.append("recent:")
        for v in rep.get("recent") or []:
            lines.append(format_violation(v))
    else:
        lines.append("")
        lines.append(
            "no protocol violations — monitors armed: "
            + ", ".join(rep.get("monitors") or [])
        )
    return "\n".join(lines)
