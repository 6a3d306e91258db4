"""Bounded-staleness (SSP) dispatch: the host-side window of in-flight
steps.

A copy of the JAX package's ``DispatchWindow`` (``parallel/ssp.py``);
the rest of that module (the SSP clock, the push window) is not ported
yet. PyTorch queues CUDA work
asynchronously as JAX dispatches jitted steps, so the same window bounds
how far the host runs ahead of the device: an entry (a step's device loss)
is read back only when it retires."""

from __future__ import annotations

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
