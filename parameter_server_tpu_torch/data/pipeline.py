"""Parallel prefetching host input pipeline.

A copy of the JAX package's ``PrefetchPipeline`` (``data/pipeline.py``):
one builder thread per worker stream pushes that stream's batches into a
bounded queue; one stacker thread assembles them into ready step items
(``prepare``), and, with ``group_size`` > 1, into one device call's group
of microsteps (``assemble``), in a bounded output queue. The dispatch loop
only pops items, so host batch building overlaps device compute.

Draining contract: ``get()`` returns ``None`` once every stream is
exhausted (and forever after). An exception on a builder or the stacker
thread re-raises in ``get()``. ``close()`` (or leaving the ``with``
block) stops and joins every thread.
"""

from __future__ import annotations

import queue
import threading
from collections.abc import Callable, Sequence
from typing import Any

_END = object()


class PrefetchPipeline:
    """Bounded parallel producer of ready-to-dispatch step items.

    streams: objects exposing ``next_batch() -> batch | None`` (None =
        drained) and ``_empty() -> batch`` (inert all-padding batch).
    prepare: ``prepare(batches: list) -> item``, run on the stacker thread.
    depth: bound of every internal queue (per-stream and output).
    group_size / assemble: every ``group_size`` prepared items are combined
        by ``assemble(items) -> group_item`` on the stacker thread; a
        partial final group is padded with prepared inert items.
    """

    def __init__(
        self,
        streams: Sequence[Any],
        prepare: Callable[[list], Any],
        depth: int = 2,
        group_size: int = 1,
        assemble: Callable[[list], Any] | None = None,
    ):
        if depth < 1:
            raise ValueError(f"pipeline depth must be >= 1, got {depth}")
        if group_size > 1 and assemble is None:
            raise ValueError("group_size > 1 requires an assemble callable")
        self.streams = list(streams)
        self.prepare = prepare
        self.group_size = group_size
        self.assemble = assemble
        self._qs = [queue.Queue(maxsize=depth) for _ in self.streams]
        self._out: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._errs: list[BaseException] = []
        self._drained = False
        self._threads = [
            threading.Thread(target=self._produce, args=(i,), daemon=True)
            for i in range(len(self.streams))
        ]
        self._threads.append(
            threading.Thread(target=self._stack_loop, daemon=True)
        )
        for t in self._threads:
            t.start()

    # -- queue helpers that respect shutdown ------------------------------
    def _put(self, q: queue.Queue, item) -> bool:
        while not self._stop.is_set():
            try:
                q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _get(self, q: queue.Queue):
        while not self._stop.is_set():
            try:
                return q.get(timeout=0.1)
            except queue.Empty:
                continue
        return _END

    # -- threads -----------------------------------------------------------
    def _produce(self, i: int) -> None:
        try:
            while not self._stop.is_set():
                b = self.streams[i].next_batch()
                if b is None:
                    break
                if not self._put(self._qs[i], b):
                    return
        except BaseException as e:  # re-raised on the consumer side
            self._errs.append(e)
        finally:
            self._put(self._qs[i], _END)

    def _stack_loop(self) -> None:
        done = [False] * len(self.streams)
        pending: list = []  # partially-filled multistep group
        try:
            while not self._stop.is_set():
                batches = []
                for i, q in enumerate(self._qs):
                    if done[i]:
                        batches.append(self.streams[i]._empty())
                        continue
                    item = self._get(q)
                    if item is _END:
                        done[i] = True
                        batches.append(self.streams[i]._empty())
                    else:
                        batches.append(item)
                if all(done):
                    break
                prepared = self.prepare(batches)
                if self.group_size == 1:
                    if not self._put(self._out, prepared):
                        return
                    continue
                pending.append(prepared)
                if len(pending) == self.group_size:
                    if not self._put(self._out, self.assemble(pending)):
                        return
                    pending = []
            if pending and not self._stop.is_set():
                # pad the final partial group with inert prepared items
                empty = self.prepare([s._empty() for s in self.streams])
                pending += [empty] * (self.group_size - len(pending))
                self._put(self._out, self.assemble(pending))
        except BaseException as e:
            self._errs.append(e)
        finally:
            self._put(self._out, _END)

    # -- consumer API ------------------------------------------------------
    def get(self):
        """Next ready step item; None once (and forever after) every
        stream has drained. Producer-thread exceptions re-raise here."""
        if self._errs:
            self._stop.set()
            raise self._errs[0]
        if self._drained:
            return None
        item = self._out.get()
        if item is _END:
            self._drained = True
            if self._errs:
                raise self._errs[0]
            return None
        return item

    def close(self) -> None:
        """Unstick and retire all threads (safe to call twice)."""
        self._stop.set()
        for q in [*self._qs, self._out]:
            try:
                q.get_nowait()
            except queue.Empty:
                pass
        for t in self._threads:
            t.join(timeout=5)

    def __enter__(self) -> "PrefetchPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
