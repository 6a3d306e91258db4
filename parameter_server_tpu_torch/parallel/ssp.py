"""Bounded-staleness (SSP) dispatch: the host-side window of in-flight
steps, and the SSP clock.

Copies of the JAX package's ``DispatchWindow``, ``PushWindow`` (the wire
tier's window of in-flight push futures) and ``SSPClock``
(``parallel/ssp.py``), the clock without its flight-recorder,
wire-counter and watchdog hooks. PyTorch
queues CUDA work
asynchronously as JAX dispatches jitted steps, so the same window bounds
how far the host runs ahead of the device: an entry (a step's device loss)
is read back only when it retires."""

from __future__ import annotations

import threading
import time
from collections import deque
from collections.abc import Callable
from typing import Any


class DispatchWindow:
    """Protocol, for step t about to be dispatched:
        window.gate(t)          # retire every entry <= t - max_delay - 1
        ... dispatch step t ...
        window.add(t, entry)
    and at a sync point: window.drain().

    ``retire(step, entry)`` is the caller's completion hook (it may block
    on device results — that block IS the SSP bound taking effect).
    """

    def __init__(self, max_delay: int, retire: Callable[[int, Any], None]):
        self.max_delay = max_delay
        self._retire = retire
        self._q: deque[tuple[int, Any]] = deque()
        self.max_inflight = 0  # observability: peak run-ahead reached

    def gate(self, step: int) -> None:
        target = step - self.max_delay - 1
        while self._q and self._q[0][0] <= target:
            self._retire(*self._q.popleft())

    def add(self, step: int, entry: Any) -> None:
        self._q.append((step, entry))
        self.max_inflight = max(self.max_inflight, len(self._q))

    def drain(self) -> None:
        while self._q:
            self._retire(*self._q.popleft())

    def __len__(self) -> int:
        return len(self._q)


class PushWindow:
    """Bounded window of in-flight push *futures* — the wire tier's sibling
    of :class:`DispatchWindow`. The worker loop issues one step's fan-out
    of async pushes (one future per shard server), then:

        window.gate()            # retire done heads; block over the bound
        ... issue step t's pushes ...
        window.add(t, futures)
    and at a sync point: window.wait_all().

    ``retire(step)`` fires exactly once per step, AFTER every one of its
    pushes completed (the worker hangs its ``ssp_finish`` there, so the
    SSP clock's bounded-delay contract holds with a pipelined wire:
    a step only counts as finished when its pushes are actually applied).
    ``max_inflight`` bounds whole steps riding the wire; blocking on the
    oldest step's futures IS the bound taking effect."""

    def __init__(self, max_inflight: int, retire: Callable[[int], None]):
        self.max_inflight = max(0, max_inflight)
        self._retire = retire
        self._q: deque[tuple[int, list]] = deque()
        self.max_inflight_seen = 0  # observability: peak step depth reached

    def gate(self) -> None:
        """Retire every finished head step, then keep retiring (blocking
        on unfinished pushes) until at most ``max_inflight`` steps remain
        in flight."""
        while self._q and (
            len(self._q) > self.max_inflight
            or all(f.done() for f in self._q[0][1])
        ):
            self._retire_head()

    def add(self, step: int, futures: list) -> None:
        self._q.append((step, list(futures)))
        self.max_inflight_seen = max(self.max_inflight_seen, len(self._q))

    def wait_all(self) -> None:
        """Full sync point: block until every in-flight push completed and
        every step retired (surfacing any push error)."""
        while self._q:
            self._retire_head()

    def _retire_head(self) -> None:
        step, futs = self._q.popleft()
        for f in futs:
            f.result()  # blocks; surfaces push errors to the caller
        self._retire(step)

    def __len__(self) -> int:
        return len(self._q)


class SSPClock:
    """Host-side bounded-delay clock over ``num_workers`` logical workers.

    Protocol per worker w at step t:
        clock.wait(w, t)    # blocks until min_finished >= t - max_delay
        ... run step t ...
        clock.finish(w, t)  # marks w's step t complete

    max_delay < 0 means fully asynchronous (never block).
    """

    RETIRED = 1 << 60

    def __init__(self, num_workers: int, max_delay: int):
        if num_workers < 1:
            raise ValueError("num_workers must be >= 1")
        self.num_workers = num_workers
        self.max_delay = max_delay
        self._finished = [-1] * num_workers  # highest finished step per worker
        # per-worker time parked on the gate, and the number of waits
        self._blocked_s = [0.0] * num_workers
        self._blocked_n = [0] * num_workers
        self._cv = threading.Condition()

    def _min_finished(self) -> int:
        return min(self._finished)

    def ready(self, worker: int, step: int) -> bool:
        """Non-blocking: may ``worker`` start ``step`` now?"""
        if self.max_delay < 0:
            return True
        with self._cv:
            return self._min_finished() >= step - self.max_delay - 1

    def wait(self, worker: int, step: int, timeout: float | None = None) -> bool:
        """Block until ``worker`` may start ``step``: every worker has
        finished step ``step - max_delay - 1``. Returns False on timeout."""
        if self.max_delay < 0:
            return True
        target = step - self.max_delay - 1
        with self._cv:
            if self._min_finished() >= target:
                return True
            t0 = time.perf_counter()
            ok = self._cv.wait_for(
                lambda: self._min_finished() >= target, timeout=timeout
            )
            self._blocked_s[worker] += time.perf_counter() - t0
            self._blocked_n[worker] += 1
        return ok

    def finish(self, worker: int, step: int) -> None:
        with self._cv:
            if step > self._finished[worker]:
                self._finished[worker] = step
                self._cv.notify_all()

    def retire(self, worker: int) -> None:
        """Mark ``worker`` done forever: it no longer gates the others.
        Idempotent; a later ``finish`` is absorbed by the monotonic max."""
        self.finish(worker, self.RETIRED)

    def is_retired(self, worker: int) -> bool:
        with self._cv:
            return self._finished[worker] >= self.RETIRED

    def progress(self) -> dict[str, Any]:
        with self._cv:
            return {
                "min_finished": self._min_finished(),
                "max_finished": max(self._finished),
                "retired": [
                    w for w, f in enumerate(self._finished) if f >= self.RETIRED
                ],
                "blocked_s": [round(s, 6) for s in self._blocked_s],
                "blocked_n": list(self._blocked_n),
            }

    def state_dict(self) -> dict:
        with self._cv:
            return {"finished": list(self._finished), "max_delay": self.max_delay}

    def load_state_dict(self, d: dict) -> None:
        with self._cv:
            self._finished = list(d["finished"])
            self.max_delay = d["max_delay"]
            self._blocked_s = [0.0] * len(self._finished)
            self._blocked_n = [0] * len(self._finished)
            self._cv.notify_all()
