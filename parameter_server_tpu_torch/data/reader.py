"""Streaming minibatch reader with prefetch, and the flat row stream.

A parser thread feeds a bounded queue (the reference's MinibatchReader).
``iter_flat_rows`` yields the raw-key stream of whole files. Both parser
backends of the JAX package: the native C++ chunk parser
(``data/native.py``) for the formats it knows when its library loads, and
the Python row parsers; they give the same batches."""

from __future__ import annotations

import queue
import threading
from collections.abc import Iterator
from pathlib import Path

import numpy as np

from parameter_server_tpu_torch.data import native as _native
from parameter_server_tpu_torch.data.batch import BatchBuilder, CSRBatch
from parameter_server_tpu_torch.data.libsvm import iter_format


class MinibatchReader:
    """Streams CSRBatches from text files through a prefetch thread.

    ``epochs`` and ``drop_remainder`` control the stream; a worker id /
    num_workers pair shards *files* across workers. The prefetch thread is
    stopped and joined when the iteration ends, including when the consumer
    breaks out early (closing the generator)."""

    def __init__(
        self,
        files: list[str | Path],
        fmt: str,
        builder: BatchBuilder,
        epochs: int = 1,
        prefetch: int = 4,
        worker_id: int = 0,
        num_workers: int = 1,
        drop_remainder: bool = False,
        backend: str = "auto",  # auto | native | python
    ):
        if not files:
            raise ValueError("no input files")
        if backend not in ("auto", "native", "python"):
            raise ValueError(f"bad backend {backend!r}")
        self.files = [f for i, f in enumerate(sorted(map(str, files))) if i % num_workers == worker_id]
        self.fmt = fmt
        self.builder = builder
        self.epochs = epochs
        self.prefetch = prefetch
        self.drop_remainder = drop_remainder
        self.use_native = backend == "native" or (
            backend == "auto"
            and fmt in _native.NATIVE_FORMATS
            and _native.native_available()
        )
        if backend == "native" and not _native.native_available():
            raise RuntimeError("native parser requested but not available")

    def _epoch_rows(self) -> Iterator:
        for f in self.files:
            yield from iter_format(self.fmt, f)

    def _flat_batches(self) -> Iterator[CSRBatch]:
        """Native path: C++ chunk parse -> vectorized batch slicing."""
        bs, nnz_cap = self.builder.batch_size, self.builder.nnz_capacity

        def take(slots, sl):
            # slots is None for slotless formats (native.SLOTLESS_FORMATS)
            return None if slots is None else slots[sl]

        def slices(flat):
            """Yield CSRBatches of full size from ``flat``; return leftover."""
            labels, splits, keys, vals, slots = flat
            i = 0
            n = len(labels)
            while i < n:
                # largest j with rows<=bs and entries<=nnz_cap
                j_row = min(n, i + bs)
                base = splits[i]
                j = int(np.searchsorted(splits, base + nnz_cap, side="right") - 1)
                j = max(i + 1, min(j_row, j))
                if j < n or (n - i) >= bs:
                    yield self.builder.build_flat(
                        labels[i:j],
                        (splits[i : j + 1] - base),
                        keys[base : splits[j]],
                        vals[base : splits[j]],
                        take(slots, slice(base, splits[j])),
                    )
                    i = j
                else:
                    break  # tail smaller than a batch: keep pending
            base = splits[i]
            return (
                labels[i:],
                splits[i:] - base,
                keys[base:],
                vals[base:],
                take(slots, slice(base, None)),
            )

        def cat(a, b):
            la, sa, ka, va, oa = a
            lb, sb, kb, vb, ob = b
            return (
                np.concatenate([la, lb]),
                np.concatenate([sa, sb[1:] + sa[-1]]),
                np.concatenate([ka, kb]),
                np.concatenate([va, vb]),
                # slots-ness is per-format, fixed per reader
                None if oa is None else np.concatenate([oa, ob]),
            )

        for _ in range(self.epochs):
            leftover = None
            for f in self.files:
                for flat in _native.iter_chunks(f, self.fmt):
                    merged = cat(leftover, flat) if leftover is not None else flat
                    gen = slices(merged)
                    while True:
                        try:
                            yield next(gen)
                        except StopIteration as s:
                            leftover = s.value
                            break
            # epoch boundary flushes (epochs=N == N runs of epochs=1)
            if leftover is not None and len(leftover[0]) and not self.drop_remainder:
                yield self.builder.build_flat(*leftover)

    def _batches(self) -> Iterator[CSRBatch]:
        if self.use_native:
            yield from self._flat_batches()
            return
        for _ in range(self.epochs):
            labels: list[float] = []
            keys: list[np.ndarray] = []
            vals: list[np.ndarray] = []
            slots: list[np.ndarray] = []
            nnz = 0
            for label, k, v, s in self._epoch_rows():
                # flush if the next row would overflow either capacity
                if labels and (
                    len(labels) == self.builder.batch_size
                    or nnz + len(k) > self.builder.nnz_capacity
                ):
                    yield self.builder.build(np.array(labels), keys, vals, slots)
                    labels, keys, vals, slots, nnz = [], [], [], [], 0
                labels.append(label)
                keys.append(k)
                vals.append(v)
                slots.append(s)
                nnz += len(k)
            if labels and not self.drop_remainder:
                yield self.builder.build(np.array(labels), keys, vals, slots)

    def __iter__(self) -> Iterator[CSRBatch]:
        q: queue.Queue = queue.Queue(maxsize=self.prefetch)
        _END = object()
        err: list[BaseException] = []
        stop = threading.Event()

        def _put(item) -> bool:
            while not stop.is_set():
                try:
                    q.put(item, timeout=0.1)
                    return True
                except queue.Full:
                    continue
            return False

        def produce() -> None:
            try:
                for b in self._batches():
                    if not _put(b):
                        return  # consumer abandoned iteration
            except BaseException as e:  # surfaced on the consumer side
                err.append(e)
            finally:
                _put(_END)

        t = threading.Thread(target=produce, name="minibatch-reader", daemon=True)
        t.start()
        try:
            while True:
                item = q.get()
                if item is _END:
                    if err:
                        raise err[0]
                    return
                yield item
        finally:
            # unstick the producer if the consumer broke out early, and
            # wait for it: it returns at its next queue put
            stop.set()
            t.join()


# Formats whose slot id is constant 0: ``iter_flat_rows`` yields None for
# their slots.
SLOTLESS_FORMATS = _native.SLOTLESS_FORMATS


def iter_flat_rows(files: list[str | Path], fmt: str):
    """Yield flat CSR chunks ``(labels, row_splits, keys, vals, slots)``
    from text files: the raw-key stream of ingest-side components that
    need no batches (the sketch app). The native chunk parser when its
    library loads (chunks of ~2 MiB), else the Python row parsers (one
    chunk a file). ``slots`` is None for slotless formats
    (native.SLOTLESS_FORMATS: every slot id is 0 there) on both."""
    paths = sorted(map(str, files))
    if fmt in _native.NATIVE_FORMATS and _native.native_available():
        for f in paths:
            yield from _native.iter_chunks(f, fmt)
        return
    for f in paths:
        labels, splits, keys, vals, slots = [], [0], [], [], []
        for label, k, v, s in iter_format(fmt, f):
            labels.append(label)
            splits.append(splits[-1] + len(k))
            keys.append(k)
            vals.append(v)
            slots.append(s)
        if labels:
            yield (
                np.asarray(labels, dtype=np.float32),
                np.asarray(splits, dtype=np.int64),
                np.concatenate(keys) if keys else np.zeros(0, np.uint64),
                np.concatenate(vals) if vals else np.zeros(0, np.float32),
                (
                    None
                    if fmt in SLOTLESS_FORMATS
                    else np.concatenate(slots)
                    if slots
                    else np.zeros(0, np.uint64)
                ),
            )
