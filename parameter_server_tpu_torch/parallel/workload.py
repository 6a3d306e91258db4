"""Scheduler-side workload (file shard) assignment.

A copy of the JAX package's ``WorkloadPool`` (``parallel/workload.py``):
the scheduler hands data file shards to workers on demand, tracks
completion, and reassigns a shard whose worker died or straggles.
word2vec's ``PairStream`` and ``PodTrainer`` use it in-process; the
coordinator serves it over the wire (``parallel/control.py``)."""

from __future__ import annotations

import threading
import time
from dataclasses import dataclass, field


@dataclass
class _Assignment:
    workload: str
    worker: int
    t_assigned: float = field(default_factory=time.monotonic)


class WorkloadPool:
    """Thread-safe pool of named workloads (file shards)."""

    def __init__(self, workloads: list[str]):
        self._pending: list[str] = list(workloads)
        self._active: dict[str, _Assignment] = {}
        self._done: set[str] = set()
        self._attempts: dict[str, int] = {}  # workload -> times handed out
        self._reassigned = 0
        self._lock = threading.Lock()

    def fetch(self, worker: int) -> str | None:
        """Next workload for ``worker``; None when nothing is pending.
        Pop and assignment are one atomic step under the lock: two workers
        racing for a reassigned workload can never both become its owner
        (``_active`` is keyed by workload — one assignment at a time)."""
        with self._lock:
            if not self._pending:
                return None
            w = self._pending.pop(0)
            self._active[w] = _Assignment(w, worker)
            self._attempts[w] = self._attempts.get(w, 0) + 1
            return w

    def finish(self, workload: str) -> None:
        """Mark complete. A finish from a slow-but-alive worker whose shard
        was already requeued by reassign_stragglers still counts: the work
        is done, so drop it from pending instead of redoing it."""
        with self._lock:
            a = self._active.pop(workload, None)
            if a is None:
                if workload in self._pending:
                    self._pending.remove(workload)
                elif workload not in self._done:
                    raise KeyError(f"unknown workload {workload!r}")
            self._done.add(workload)

    def reassign_stragglers(self, older_than_s: float) -> list[str]:
        """Requeue workloads assigned longer than ``older_than_s`` ago
        (ref: straggler / dead-worker reassignment). Requeued work goes to
        the FRONT of the queue: recovery drains the stranded tasks before
        untouched pending ones."""
        now = time.monotonic()
        requeued = []
        with self._lock:
            for w, a in list(self._active.items()):
                if now - a.t_assigned > older_than_s:
                    del self._active[w]
                    requeued.append(w)
            self._pending[:0] = requeued
            self._reassigned += len(requeued)
        return requeued

    def reassign_worker(self, worker: int) -> list[str]:
        """Requeue everything held by a dead worker (front of the queue,
        like reassign_stragglers)."""
        requeued = []
        with self._lock:
            for w, a in list(self._active.items()):
                if a.worker == worker:
                    del self._active[w]
                    requeued.append(w)
            self._pending[:0] = requeued
            self._reassigned += len(requeued)
        return requeued

    def owner_of(self, workload: str) -> int | None:
        """Current owner rank, or None when not active (observability +
        the reassign-race tests' single-owner assertion)."""
        with self._lock:
            a = self._active.get(workload)
            return None if a is None else a.worker

    def attempts(self, workload: str) -> int:
        """How many times ``workload`` has been handed out (1 = never
        reassigned)."""
        with self._lock:
            return self._attempts.get(workload, 0)

    @property
    def all_done(self) -> bool:
        with self._lock:
            return not self._pending and not self._active

    @property
    def reassigned_total(self) -> int:
        with self._lock:
            return self._reassigned

    def stats(self) -> dict[str, int]:
        with self._lock:
            return {
                "pending": len(self._pending),
                "active": len(self._active),
                "done": len(self._done),
                # exactly-once ledger: every hand-out either completed or
                # was requeued, so attempts == done + reassigned at the end
                # of a healthy run — a double-applied (non-deduped) fetch
                # breaks this invariant visibly
                "attempts": sum(self._attempts.values()),
                "reassigned": self._reassigned,
            }
