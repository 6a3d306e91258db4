"""Streaming minibatch reader with prefetch, and the flat row stream.

A parser thread feeds a bounded queue (the reference's MinibatchReader).
``iter_flat_rows`` yields the raw-key stream of whole files. Only the
Python parser backend is ported; the JAX package's native C++ chunk
parser is not ported yet, and asking for it raises."""

from __future__ import annotations

import queue
import threading
from collections.abc import Iterator
from pathlib import Path

import numpy as np

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
        if backend == "native":
            raise NotImplementedError(
                "the native parser backend is not ported yet; use "
                "backend='python' (or 'auto')"
            )
        self.files = [f for i, f in enumerate(sorted(map(str, files))) if i % num_workers == worker_id]
        self.fmt = fmt
        self.builder = builder
        self.epochs = epochs
        self.prefetch = prefetch
        self.drop_remainder = drop_remainder

    def _epoch_rows(self) -> Iterator:
        for f in self.files:
            yield from iter_format(self.fmt, f)

    def _batches(self) -> Iterator[CSRBatch]:
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
# their slots (the JAX package's ``data/native.py`` SLOTLESS_FORMATS).
SLOTLESS_FORMATS = frozenset({"libsvm"})


def iter_flat_rows(files: list[str | Path], fmt: str):
    """Yield flat CSR chunks ``(labels, row_splits, keys, vals, slots)``,
    one a file, from text files: the raw-key stream of ingest-side
    components that need no batches (the sketch app). ``slots`` is None
    for slotless formats (SLOTLESS_FORMATS: every slot id is 0 there)."""
    for f in sorted(map(str, files)):
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
