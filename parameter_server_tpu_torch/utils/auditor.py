"""The live audit plane's coordinator half: a streaming auditor over
the cluster event bus.

Nodes spool audit-relevant flight-recorder events
(utils/flightrec.py ``EventSpool``) and ship them as sequence-numbered
batches on their heartbeat piggyback; this module ingests those
batches at the coordinator — per-node seq dedup (re-shipped batches
from a failed beat are dropped, not double-counted), gap and
saturation accounting — and runs every event through the shared
streaming monitors (analysis/monitors.py), the SAME automata
``cli postmortem`` feeds offline. A violation:

- fires an ``audit.violation`` flight-recorder event (so it lands in
  the coordinator's black box and the postmortem renders it),
- bumps ``audit_violations`` (the coordinator's own time-series ring
  carries it, so the shipped ``[slo]`` rule pages on a sustained
  violation stream with no extra plumbing),
- lands in the bounded recent-violations panel ``cli top`` and
  ``cli audit`` render.

**Evidence discipline**: the online plane never bluffs. Pairing-based
verdicts (acked-but-unapplied, SSP staleness) are SUPPRESSED — counted
in ``audit_suppressed``, not raised — while a stream that could hold
the missing half of the pair has known holes (that node's spool
saturated, or its batch seqs jumped), because "the commit never
arrived" and "the commit was dropped on the floor" are different
facts. Holes are tracked PER NODE with the roles the coordinator
knows, so the targeting is as tight as the evidence allows: an
acked-but-unapplied verdict is suppressed only while a *server*
stream (or a role-unknown stream other than the acking node's own) is
holed — the missing commit could only live there; an SSP verdict only
while the clock-owning stream itself is holed. One busy worker
saturating its spool therefore cannot blind the auditor to violations
whose evidence lives entirely in clean streams. Self-contained
verdicts (version regressions, double applies, heal divergence, shed
storms) stay live regardless: a hole can only make them false
negatives, never false positives.
"""

from __future__ import annotations

import threading
import time
from collections import deque
from typing import Any

from parameter_server_tpu_torch.utils import flightrec
from parameter_server_tpu_torch.utils.metrics import wire_counters

#: verdicts that pair facts across nodes — the ones a holed stream
#: could turn into false alarms (see the module docstring)
_SUPPRESSIBLE = frozenset({"acked-but-unapplied", "ssp-staleness"})

#: violation fields forwarded into the audit.violation event (scalars
#: only — the flight-recorder contract keeps dump rows small)
_EVENT_FIELDS = ("cid", "seq", "worker", "step", "from", "to", "count")


class Auditor:
    """Coordinator-side streaming monitor harness (thread-safe)."""

    def __init__(self, cfg: "AuditConfig | None" = None):
        from parameter_server_tpu_torch.analysis import monitors as monitors_mod
        from parameter_server_tpu_torch.utils.config import AuditConfig

        self.cfg = cfg or AuditConfig()
        self._monitors = monitors_mod.make_monitors(
            watermark_s=self.cfg.watermark_s,
            heal_timeout_s=self.cfg.heal_timeout_s,
            shed_storm_n=self.cfg.shed_storm_n,
            shed_storm_window_s=self.cfg.shed_storm_window_s,
        )
        self._by_event: dict[str, list] = {}
        for m in self._monitors:
            for et in m.EVENTS:
                self._by_event.setdefault(et, []).append(m)
        self._lock = threading.Lock()
        #: per-node stream accounting: last seq, event/batch counts,
        #: the spool's cumulative drop watermark, seq gaps, violations
        self._nodes: dict[str, dict[str, Any]] = {}
        self._recent: deque[dict[str, Any]] = deque(
            maxlen=max(int(self.cfg.recent), 8)
        )
        self._by_kind: dict[str, int] = {}
        self.total = 0
        self.suppressed = 0
        #: per-node stream holes (feeder-supplied now) + known roles —
        #: the targeting data for pairing-verdict suppression
        self._holes: dict[str, float] = {}
        self._roles: dict[str, str] = {}
        #: the auditor's notion of "now": the max feeder-supplied clock
        #: (wall time in production, test-supplied in drills) — summary
        #: reads it so hole windows stay in ONE clock domain
        self._clock = 0.0

    # -- ingest ------------------------------------------------------------

    def _node(self, node: str) -> dict[str, Any]:
        st = self._nodes.get(node)
        if st is None:
            st = self._nodes[node] = {
                "seq": -1, "batches": 0, "events": 0,
                "dropped": 0, "gaps": 0, "violations": 0,
            }
        return st

    def ingest(
        self,
        node: Any,
        batches: list[dict[str, Any]],
        now: float | None = None,
        role: str | None = None,
    ) -> int:
        """Feed one node's piggybacked batches; returns violations
        raised. Batches are deduped by seq per node (at-least-once
        delivery upstream); gaps and saturation are booked as THAT
        node's stream holes, which suppress the pairing-based verdicts
        whose missing half could live in it. ``role`` (the coordinator
        knows it from the registry) tightens the targeting."""
        if now is None:
            now = time.time()
        nk = str(node)
        found = 0
        fed = 0
        with self._lock:
            self._clock = max(self._clock, now)
            if role:
                self._roles[nk] = role
            st = self._node(nk)
            for batch in sorted(
                batches or (), key=lambda b: int(b.get("seq", 0))
            ):
                try:
                    seq = int(batch["seq"])
                    events = batch["events"]
                except (KeyError, TypeError, ValueError):
                    continue  # a torn batch is a hole, not a crash
                if seq <= st["seq"]:
                    continue  # re-shipped after a lost beat ack: dup
                if st["seq"] >= 0 and seq > st["seq"] + 1:
                    st["gaps"] += 1
                    self._holes[nk] = now
                    wire_counters.inc("audit_gaps")
                st["seq"] = seq
                dropped = int(batch.get("dropped", 0))
                if dropped > st["dropped"]:
                    st["dropped"] = dropped
                    self._holes[nk] = now  # spool saturated: holes
                st["batches"] += 1
                wire_counters.inc("audit_batches")
                for raw in events:
                    try:
                        ts, _tid, etype, fields = raw
                    except (TypeError, ValueError):
                        continue
                    mons = self._by_event.get(etype)
                    if not mons:
                        continue
                    st["events"] += 1
                    fed += 1
                    ev = {
                        "ts": float(ts), "life": nk, "etype": etype,
                        "args": fields or {}, "at": now,
                    }
                    for m in mons:
                        for v in m.feed(ev):
                            found += self._emit(v, now)
            if fed:
                wire_counters.inc("audit_events", fed)
        return found

    def flush(self, now: float | None = None) -> int:
        """Watermark pass (the coordinator sweep cadence): expire
        unpaired facts into violations."""
        if now is None:
            now = time.time()
        found = 0
        with self._lock:
            self._clock = max(self._clock, now)
            for m in self._monitors:
                for v in m.flush(now):
                    found += self._emit(v, now)
        return found

    def finish(self, now: float | None = None) -> int:
        """End-of-stream (tests / offline parity): judge everything."""
        if now is None:
            now = time.time()
        found = 0
        with self._lock:
            self._clock = max(self._clock, now)
            for m in self._monitors:
                for v in m.finish():
                    found += self._emit(v, now)
        return found

    def set_ssp(self, num_workers: int, max_delay: int) -> None:
        """Teach the SSP monitor the clock's bound (from ssp_init)."""
        with self._lock:
            for m in self._monitors:
                if hasattr(m, "set_bounds"):
                    m.set_bounds(max_delay, num_workers)

    # -- verdicts ----------------------------------------------------------

    def _holed_nodes(self, now: float) -> list[str]:
        horizon = 2 * self.cfg.watermark_s
        return [
            n for n, t in self._holes.items() if now - t < horizon
        ]

    def _evidence_holed(self, v: dict[str, Any], now: float) -> bool:
        """Could the verdict's MISSING pairing half live in a currently
        holed stream? (the per-kind targeting in the module docstring)"""
        holed = self._holed_nodes(now)
        if not holed:
            return False
        life = str(v.get("life", ""))
        if v["kind"] == "ssp-staleness":
            # the justifying ssp.finish lives in the SAME stream as the
            # wait that raised the suspicion (the clock owner's)
            return life in holed
        # acked-but-unapplied: the ack survived (it is the evidence);
        # the missing commit lives in a SERVER stream — a holed stream
        # only suppresses if it is one (or its role is unknown) and is
        # not the acking node's own
        return any(
            n != life and self._roles.get(n, "server") in ("server", "")
            for n in holed
        )

    def _emit(self, v: dict[str, Any], now: float) -> int:
        """Book one monitor violation (caller holds the lock); returns
        1 if raised, 0 if suppressed for lack of stream evidence."""
        kind = v["kind"]
        if kind in _SUPPRESSIBLE and self._evidence_holed(v, now):
            self.suppressed += 1
            wire_counters.inc("audit_suppressed")
            return 0
        self.total += 1
        self._by_kind[kind] = self._by_kind.get(kind, 0) + 1
        life = v.get("life")
        nk = str(life) if life is not None else ""
        if nk in self._nodes:
            self._nodes[nk]["violations"] += 1
        wire_counters.inc("audit_violations")
        fields = {
            k: v[k] for k in _EVENT_FIELDS if v.get(k) is not None
        }
        flightrec.record(
            "audit.violation", kind=kind, monitor=v.get("monitor", ""),
            node=nk, **fields,
        )
        self._recent.append({**v, "at": round(now, 3)})
        return 1

    # -- reads -------------------------------------------------------------

    def summary(self, recent: int = 20) -> dict[str, Any]:
        """The ``cli audit`` / ``cli top`` / telemetry block."""
        with self._lock:
            return {
                "total": self.total,
                "suppressed": self.suppressed,
                "by_kind": dict(sorted(self._by_kind.items())),
                "nodes": {n: dict(st) for n, st in self._nodes.items()},
                "recent": list(self._recent)[-max(int(recent), 0):],
                "monitors": sorted(m.name for m in self._monitors),
                # which streams currently degrade pairing verdicts —
                # the operator's "why is detection suppressed" answer
                "holed": sorted(self._holed_nodes(self._clock)),
            }

    def violations(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._recent)
