"""Heartbeats and failure detection.

A copy of the JAX package's ``utils/heartbeat.py``: each node runs a
``HeartbeatReporter`` thread publishing stats into a ``HeartbeatMonitor``
(in-process, or the coordinator's over the wire); the monitor flags nodes
whose last beat is older than a timeout, the trigger for recovery.
Trimmed: no per-node telemetry history (the time-series plane is not
ported) and no flight-recorder or audit-spool hooks."""

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
    """Scheduler-side registry of last-seen beats (thread-safe)."""

    def __init__(self, timeout_s: float = 30.0):
        self.timeout_s = timeout_s
        self._beats: dict[int, dict] = {}
        self._lock = threading.Lock()

    def beat(self, node_id: int, stats: dict | None = None) -> None:
        self.beat_many([(node_id, stats)])

    def beat_many(self, items: list[tuple[int, dict | None]]) -> None:
        """Record a whole batch of beats under one lock acquisition (the
        coordinator's batched ingest drain)."""
        now = time.monotonic()
        with self._lock:
            for node_id, stats in items:
                self._beats[node_id] = {"t": now, "stats": stats or {}}

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
        """Last-reported stats per node (nodes piggyback counter
        snapshots on their beats)."""
        with self._lock:
            return {n: dict(b["stats"]) for n, b in self._beats.items()}

    def forget(self, node_id: int) -> None:
        """Drop a node's record once its death has been handled or it
        finished cleanly, so ``dead()`` stays the actionable list. A late
        beat from a falsely-flagged node simply re-registers it."""
        with self._lock:
            self._beats.pop(node_id, None)


class HeartbeatReporter:
    """Per-node thread beating into a monitor every ``interval_s``.

    ``stats_fn`` builds each beat's stats payload (default: host_stats);
    the multi-process tier passes one that piggybacks the node's counter
    snapshot."""

    def __init__(
        self,
        monitor,
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
        self.monitor.beat(self.node_id, self._stats_fn())
        self.beats += 1
        flightrec.record("heartbeat.beat", node=self.node_id, n=self.beats)

    def _run(self) -> None:
        while not self._stop.wait(self.interval_s):
            self._beat_once()

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
