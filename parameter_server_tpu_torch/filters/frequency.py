"""Tail-feature frequency filter (count-min sketch).

Only keys seen at least k times are admitted into batches: at 10^9+ raw CTR
features the tail is noise and would blow up the model. Host-side ingest
component: feed raw (pre-hash) keys as they stream by; ask ``admit`` before
including them in batches."""

from __future__ import annotations

import numpy as np

from parameter_server_tpu_torch.utils.hashing import splitmix64

_SEEDS = np.array([0x9E37, 0x85EB, 0xC2B2, 0x27D4], dtype=np.uint64)


class CountMinSketch:
    """Vectorized count-min over uint64 keys with ``depth`` hash rows."""

    def __init__(self, width: int = 1 << 20, depth: int = 4, dtype=np.uint32):
        if depth > len(_SEEDS):
            raise ValueError(f"depth <= {len(_SEEDS)}")
        self.width = int(width)
        self.depth = int(depth)
        self.table = np.zeros((depth, self.width), dtype=dtype)

    def _rows(self, keys: np.ndarray) -> np.ndarray:
        k = np.asarray(keys, dtype=np.uint64)
        out = np.empty((self.depth, len(k)), dtype=np.int64)
        for d in range(self.depth):
            with np.errstate(over="ignore"):
                out[d] = (splitmix64(k ^ _SEEDS[d]) % np.uint64(self.width)).astype(
                    np.int64
                )
        return out

    def add(self, keys: np.ndarray) -> None:
        idx = self._rows(keys)
        for d in range(self.depth):
            np.add.at(self.table[d], idx[d], 1)

    def count(self, keys: np.ndarray) -> np.ndarray:
        """Estimated counts (never under-estimates)."""
        idx = self._rows(keys)
        ests = np.stack([self.table[d][idx[d]] for d in range(self.depth)])
        return ests.min(axis=0)

    def admit(self, keys: np.ndarray, min_count: int) -> np.ndarray:
        """Bool mask of keys seen at least ``min_count`` times."""
        return self.count(keys) >= min_count

    def state_dict(self) -> dict:
        return {"table": self.table}

    def load_state_dict(self, d: dict) -> None:
        t = np.asarray(d["table"])
        if t.shape != self.table.shape:
            raise ValueError(f"sketch shape {t.shape} != {self.table.shape}")
        self.table = t.copy()
