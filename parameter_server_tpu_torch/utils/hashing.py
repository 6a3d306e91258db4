"""Feature-id hashing into a static dense key space.

Raw 64-bit feature ids are hashed once, at ingest, into ``[1, num_keys)``;
row 0 of every table is the pad row. The hash is splitmix64's finalizer
(bijective on uint64), so it agrees bit for bit with the JAX package's
numpy hashing and its native parser. Slot ids salt the hash so distinct
feature groups land in decorrelated regions of one space.
"""

from __future__ import annotations

import numpy as np

_C1 = np.uint64(0x9E3779B97F4A7C15)
_C2 = np.uint64(0xBF58476D1CE4E5B9)
_C3 = np.uint64(0x94D049BB133111EB)


def splitmix64(x: np.ndarray) -> np.ndarray:
    """Vectorized splitmix64 finalizer. Bijective on uint64."""
    z = x.astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        z += _C1
        z = (z ^ (z >> np.uint64(30))) * _C2
        z = (z ^ (z >> np.uint64(27))) * _C3
        z = z ^ (z >> np.uint64(31))
    return z


def hash_keys(
    raw_keys: np.ndarray, num_keys: int, slot_ids: np.ndarray | int = 0
) -> np.ndarray:
    """Hash raw 64-bit feature ids (optionally salted by slot) into
    ``[1, num_keys)``; index 0 is the reserved pad row."""
    if num_keys < 2:
        raise ValueError(f"num_keys must be >= 2 (pad row + data), got {num_keys}")
    raw = np.asarray(raw_keys, dtype=np.uint64)
    salt = np.asarray(slot_ids, dtype=np.uint64)
    with np.errstate(over="ignore"):
        mixed = raw ^ (splitmix64(salt + _C1))
    h = splitmix64(mixed)
    usable = np.uint64(num_keys - 1)
    return (h % usable + np.uint64(1)).astype(np.int64)


PAD_KEY = 0  # reserved padding row in every table
