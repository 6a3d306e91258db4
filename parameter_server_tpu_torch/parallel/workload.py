"""Scheduler-side workload (file shard) assignment.

A copy of the JAX package's ``WorkloadPool`` (``parallel/workload.py``),
trimmed to what word2vec's ``PairStream`` uses: ``fetch``, ``finish``,
``all_done`` and ``stats``. Straggler and dead-worker reassignment come
with the wire tier."""

from __future__ import annotations

import threading


class WorkloadPool:
    """Thread-safe pool of named workloads (file shards)."""

    def __init__(self, workloads: list[str]):
        self._pending: list[str] = list(workloads)
        self._active: dict[str, int] = {}  # workload -> worker holding it
        self._done: set[str] = set()
        self._attempts: dict[str, int] = {}  # workload -> times handed out
        self._lock = threading.Lock()

    def fetch(self, worker: int) -> str | None:
        """Next workload for ``worker``; None when nothing is pending. Pop
        and assignment are one atomic step under the lock."""
        with self._lock:
            if not self._pending:
                return None
            w = self._pending.pop(0)
            self._active[w] = worker
            self._attempts[w] = self._attempts.get(w, 0) + 1
            return w

    def finish(self, workload: str) -> None:
        """Mark complete. A workload still pending is dropped from the
        queue: the work is done."""
        with self._lock:
            if self._active.pop(workload, None) is None:
                if workload in self._pending:
                    self._pending.remove(workload)
                elif workload not in self._done:
                    raise KeyError(f"unknown workload {workload!r}")
            self._done.add(workload)

    @property
    def all_done(self) -> bool:
        with self._lock:
            return not self._pending and not self._active

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "pending": len(self._pending),
                "active": len(self._active),
                "done": len(self._done),
                "attempts": sum(self._attempts.values()),
            }
