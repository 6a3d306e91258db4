"""Distributed count-min sketch app.

Host code (numpy) in both packages: this is the JAX package's module on
the port's own copies of ``CountMinSketch`` and ``iter_flat_rows``. It
has no device.

Reference analog: src/app/sketch/ — the reference tree carries a
distributed count-min sketch demo ([UNCERTAIN] maturity there, see
SURVEY.md §2.7): workers sketch the keys of their data shards; the
scheduler's merged sketch answers frequency queries and feeds the
tail-feature admission filter.

Here the sketch itself is the library component filters/frequency.py
(already the frequency filter's engine); this app adds what the reference
app adds on top: per-shard sketching, the **merge** (count-min tables are
mergeable by elementwise sum — that is the whole distributed story),
streaming heavy-hitter candidate tracking, and a CLI surface. On a pod the
per-worker sketches ride the same progress path as gradients; across
processes they go through the control-plane KV (parallel/control.py), as
exercised in the tests.
"""

from __future__ import annotations

from typing import Any

import numpy as np

from parameter_server_tpu_torch.filters.frequency import CountMinSketch
from parameter_server_tpu_torch.utils.config import PSConfig


def merge_sketches(sketches: list[CountMinSketch]) -> CountMinSketch:
    """Elementwise-sum merge (valid because every sketch hashes with the
    same seeds/width; the count-min estimate of a sum is the sum bound)."""
    if not sketches:
        raise ValueError("nothing to merge")
    first = sketches[0]
    out = CountMinSketch(width=first.width, depth=first.depth, dtype=first.table.dtype)
    for s in sketches:
        if (s.width, s.depth) != (first.width, first.depth):
            raise ValueError("sketch shapes differ; cannot merge")
        out.table += s.table
    return out


class SketchApp:
    """Stream key frequencies into a sketch; track heavy-hitter candidates.

    Candidate tracking is the standard streaming trick: a key becomes a
    candidate the moment its (over-)estimate crosses ``min_count``; the
    final report re-queries the merged sketch so estimates are consistent.
    """

    def __init__(self, cfg: PSConfig):
        self.cfg = cfg
        self.sketch = CountMinSketch(
            width=cfg.sketch.width, depth=cfg.sketch.depth
        )
        self.min_count = cfg.sketch.min_count
        self._candidates: set[int] = set()
        self.keys_seen = 0

    def add(self, keys: np.ndarray) -> None:
        keys = np.asarray(keys, dtype=np.uint64)
        self.sketch.add(keys)
        self.keys_seen += len(keys)
        hot = keys[self.sketch.admit(keys, self.min_count)]
        self._candidates.update(int(k) for k in np.unique(hot))

    def add_files(self, files: list[str]) -> None:
        """Sketch the raw (pre-hash) feature keys of data files — the same
        ingest position the frequency filter occupies."""
        from parameter_server_tpu_torch.data.reader import iter_flat_rows

        for flat in iter_flat_rows(files, self.cfg.data.format):
            self.add(flat[2])

    def heavy_hitters(self) -> tuple[np.ndarray, np.ndarray]:
        """(keys, estimated counts) of all candidates, sorted by count
        descending. Count-min never under-estimates, so every true heavy
        hitter is present (possibly with over-estimated count)."""
        if not self._candidates:
            return np.zeros(0, np.uint64), np.zeros(0, np.int64)
        keys = np.fromiter(self._candidates, dtype=np.uint64)
        counts = self.sketch.count(keys).astype(np.int64)
        keep = counts >= self.min_count
        keys, counts = keys[keep], counts[keep]
        order = np.argsort(-counts, kind="stable")
        return keys[order], counts[order]

    def result(self) -> dict[str, Any]:
        keys, counts = self.heavy_hitters()
        return {
            "keys_seen": self.keys_seen,
            "heavy_hitters": len(keys),
            "top_count": int(counts[0]) if len(counts) else 0,
        }

    def dump_heavy_hitters(self, path: str) -> int:
        keys, counts = self.heavy_hitters()
        with open(path, "w") as f:
            for k, c in zip(keys, counts):
                f.write(f"{k}\t{c}\n")
        return len(keys)
