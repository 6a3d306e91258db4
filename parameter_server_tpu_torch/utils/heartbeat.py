"""Heartbeats and failure detection.

A copy of the JAX package's ``utils/heartbeat.py``: each node runs a
``HeartbeatReporter`` thread publishing stats into a ``HeartbeatMonitor``
(in-process, or the coordinator's over the wire); the monitor flags nodes
whose last beat is older than a timeout, the trigger for recovery. The
monitor keeps each node's telemetry stream in a bounded time-series ring,
and the reporter ships the process's audit event spool on every beat."""

from __future__ import annotations

import os
import threading
import time

from parameter_server_tpu_torch.utils import flightrec


def host_stats() -> dict:
    """CPU/mem snapshot for this process (ref: heartbeat_info fields)."""
    out: dict = {"pid": os.getpid(), "time": time.time()}
    try:
        import resource

        ru = resource.getrusage(resource.RUSAGE_SELF)
        out["max_rss_mb"] = ru.ru_maxrss / 1024.0
        out["utime_s"] = ru.ru_utime
        out["stime_s"] = ru.ru_stime
    except Exception:  # pragma: no cover - platform-specific
        pass
    try:
        out["load1"] = os.getloadavg()[0]
    except OSError:  # pragma: no cover
        pass
    return out


class HeartbeatMonitor:
    """Scheduler-side registry of last-seen beats (thread-safe).

    Beyond the latest beat, the monitor RETAINS each node's telemetry
    stream: every piggybacked ``telemetry`` snapshot feeds a
    per-node bounded :class:`~parameter_server_tpu_torch.utils.timeseries.
    TimeSeriesRing` of deltas stamped at receive time (receive-time
    stamping is clock-skew-proof; the beat cadence bounds the error).
    That history — not the point sample — is what the coordinator's
    windowed ``telemetry`` view, ``cli top`` and the ``[slo]`` burn-rate
    engine read."""

    def __init__(self, timeout_s: float = 30.0, series_capacity: int = 360):
        self.timeout_s = timeout_s
        self.series_capacity = series_capacity
        self._beats: dict[int, dict] = {}
        self._series: dict[int, "TimeSeriesRing"] = {}
        self._lock = threading.Lock()

    def beat(self, node_id: int, stats: dict | None = None) -> None:
        self.beat_many([(node_id, stats)])

    def beat_many(self, items: list[tuple[int, dict | None]]) -> None:
        """Record a whole batch of beats under ONE lock acquisition (the
        coordinator's batched ingest drain): at cluster scale the beat
        stream is the monitor's hottest writer, and per-frame acquires
        made it contend with every dead()/alive() sweep."""
        from parameter_server_tpu_torch.utils.timeseries import TimeSeriesRing

        now = time.monotonic()
        wall = time.time()
        feeds: list[tuple["TimeSeriesRing", dict]] = []
        with self._lock:
            for node_id, stats in items:
                self._beats[node_id] = {"t": now, "stats": stats or {}}
                tel = (stats or {}).get("telemetry")
                if tel:
                    ring = self._series.get(node_id)
                    if ring is None:
                        ring = self._series[node_id] = TimeSeriesRing(
                            self.series_capacity
                        )
                    feeds.append((ring, tel))
        # delta computation (O(series) dict diffing per beat) happens
        # OUTSIDE the monitor lock — the beat stream is this lock's
        # hottest writer and must not serialize against dead()/alive()
        # sweeps. Rings lock themselves; a racing out-of-order observe
        # is discarded by the ring's monotonic-ts check (beats are
        # last-writer-wins telemetry).
        for ring, tel in feeds:
            ring.observe(tel, ts=wall)

    def node_series(self) -> dict[int, "TimeSeriesRing"]:
        """Per-node retained telemetry rings (live references — ring
        reads are internally thread-safe)."""
        with self._lock:
            return dict(self._series)

    def alive(self) -> list[int]:
        now = time.monotonic()
        with self._lock:
            return sorted(
                n for n, b in self._beats.items() if now - b["t"] <= self.timeout_s
            )

    def dead(self) -> list[int]:
        """Nodes that have beaten before but are now overdue (ref: the
        dead-node list driving recovery)."""
        now = time.monotonic()
        with self._lock:
            return sorted(
                n for n, b in self._beats.items() if now - b["t"] > self.timeout_s
            )

    def latest_stats(self) -> dict[int, dict]:
        """Last-reported stats per node (the telemetry plane's raw feed:
        nodes piggyback counter/histogram snapshots on their beats)."""
        with self._lock:
            return {n: dict(b["stats"]) for n, b in self._beats.items()}

    def forget(self, node_id: int) -> None:
        """Drop a node's record once its death has been *handled* (workloads
        requeued, clock retired) or it finished cleanly: ``dead()`` stays
        the actionable list instead of accumulating corpses that would
        re-trigger recovery every sweep. A late beat from a falsely-flagged
        node simply re-registers it."""
        with self._lock:
            self._beats.pop(node_id, None)
            self._series.pop(node_id, None)


class HeartbeatReporter:
    """Per-node thread beating into a monitor every ``interval_s``.

    ``stats_fn`` builds each beat's stats payload (default: host_stats);
    the multi-process tier passes a function that piggybacks the node's
    telemetry snapshot so the scheduler's cluster view needs no second
    collection path (ref: heartbeat_info carrying the dashboard stats)."""

    def __init__(
        self,
        monitor: HeartbeatMonitor,
        node_id: int,
        interval_s: float = 5.0,
        stats_fn=host_stats,
    ):
        self.monitor = monitor
        self.node_id = node_id
        self.interval_s = interval_s
        self._stats_fn = stats_fn
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        #: completed beats — the watchdog's heartbeat-silence progress
        #: probe (a beat thread wedged in a dead sink stops advancing it)
        self.beats = 0

    def start(self) -> "HeartbeatReporter":
        self._beat_once()  # immediate first beat
        self._thread = threading.Thread(
            target=self._run, daemon=True, name="ps-heartbeat"
        )
        self._thread.start()
        return self

    def _beat_once(self) -> None:
        stats = self._stats_fn()
        # audit plane: the beat carries this process's spooled
        # audit events as seq-numbered batches and acks them only after a
        # successful send — a beat that dies on the wire leaves them
        # in-flight and the NEXT beat re-ships the same seqs (the
        # coordinator's auditor dedups by (node, seq), so at-least-once
        # delivery here never double-counts there)
        spool = flightrec.audit_spool()
        if spool is not None and isinstance(stats, dict):
            batches = spool.drain()
            if batches:
                stats["audit"] = batches
        # a sink returning False reports delivery failure (the remote
        # RPC sink); None (the in-process monitor) means delivered
        ok = self.monitor.beat(self.node_id, stats)
        if spool is not None and ok is not False:
            spool.ack()
        self.beats += 1
        flightrec.record("heartbeat.beat", node=self.node_id, n=self.beats)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._beat_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
