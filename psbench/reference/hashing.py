"""Feature hashing as the system states it: splitmix64's finalizer, salted
by the field, into ``[1, num_keys)``; row 0 is the pad row.

A copy of the arithmetic that ``parameter_server_tpu_torch/utils/hashing.py``
documents, so that the benchmark works out every key itself and takes none
from the program."""

from __future__ import annotations

import numpy as np

_C1 = np.uint64(0x9E3779B97F4A7C15)
_C2 = np.uint64(0xBF58476D1CE4E5B9)
_C3 = np.uint64(0x94D049BB133111EB)


def splitmix64(x: np.ndarray) -> np.ndarray:
    z = np.asarray(x).astype(np.uint64, copy=True)
    with np.errstate(over="ignore"):
        z += _C1
        z = (z ^ (z >> np.uint64(30))) * _C2
        z = (z ^ (z >> np.uint64(27))) * _C3
        z = z ^ (z >> np.uint64(31))
    return z


def hash_keys(raw: np.ndarray, num_keys: int, salt: np.ndarray | int = 0) -> np.ndarray:
    """Raw ids, salted by ``salt`` (the field), into ``[1, num_keys)``."""
    s = np.asarray(salt, dtype=np.uint64)
    with np.errstate(over="ignore"):
        mixed = np.asarray(raw, dtype=np.uint64) ^ splitmix64(s + _C1)
    h = splitmix64(mixed)
    return (h % np.uint64(num_keys - 1) + np.uint64(1)).astype(np.int64)
