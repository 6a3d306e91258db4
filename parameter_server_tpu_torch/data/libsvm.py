"""libsvm / criteo / adfea text parsers (the Python implementations).

The C++ parser (``data/native.py``) produces the same rows.
"""

from __future__ import annotations

import gzip
from collections.abc import Iterator
from pathlib import Path

import numpy as np

Row = tuple[float, np.ndarray, np.ndarray, np.ndarray]  # label, keys, vals, slots


def _open(path: str | Path):
    p = Path(path)
    if p.suffix == ".gz":
        return gzip.open(p, "rt")
    return p.open("r")


def iter_libsvm(path: str | Path) -> Iterator[Row]:
    """Parse ``label idx:val idx:val ...``; labels -1/0/+1 -> 0/1. Slot id
    is 0 for all features (libsvm has no feature groups)."""
    with _open(path) as f:
        for line in f:
            parts = line.split()
            if not parts:
                continue
            label = 1.0 if float(parts[0]) > 0 else 0.0
            n = len(parts) - 1
            keys = np.empty(n, dtype=np.uint64)
            vals = np.empty(n, dtype=np.float32)
            for i, tok in enumerate(parts[1:]):
                k, _, v = tok.partition(":")
                keys[i] = int(k)
                vals[i] = float(v) if v else 1.0
            yield label, keys, vals, np.zeros(n, dtype=np.uint64)


def iter_criteo(path: str | Path) -> Iterator[Row]:
    """Parse Criteo CTR TSV: label, 13 integer slots, 26 categorical slots.

    Integer column j becomes key j in slot j+1 with value sign(x)*log1p|x|;
    categorical column j becomes its hex id in slot j+14. Missing or
    malformed fields are skipped."""
    with _open(path) as f:
        for line in f:
            cols = line.rstrip("\n").split("\t")
            if len(cols) < 40:
                continue
            label = 1.0 if cols[0] == "1" else 0.0
            keys, vals, slots = [], [], []
            for j in range(13):
                c = cols[1 + j]
                try:
                    x = int(c)
                except ValueError:
                    continue
                keys.append(j)
                vals.append(np.sign(x) * np.log1p(abs(x)))
                slots.append(j + 1)
            for j in range(26):
                c = cols[14 + j]
                if c == "":
                    continue
                try:
                    k = int(c, 16)
                except ValueError:
                    continue
                keys.append(k)
                vals.append(1.0)
                slots.append(j + 14)
            yield (
                label,
                np.array(keys, dtype=np.uint64),
                np.array(vals, dtype=np.float32),
                np.array(slots, dtype=np.uint64),
            )


def iter_adfea(path: str | Path) -> Iterator[Row]:
    """Parse ``line_id label fea:grp fea:grp ...``: the group id is the
    slot, the value is 1.0, a token without ``:`` gets slot 0, and the
    leading line id is dropped."""
    with _open(path) as f:
        for line in f:
            parts = line.split()
            if len(parts) < 2:
                continue
            label = 1.0 if float(parts[1]) > 0 else 0.0
            n = len(parts) - 2
            keys = np.empty(n, dtype=np.uint64)
            slots = np.zeros(n, dtype=np.uint64)
            for i, tok in enumerate(parts[2:]):
                k, _, g = tok.partition(":")
                keys[i] = int(k)
                if g:
                    slots[i] = int(g)
            yield label, keys, np.ones(n, dtype=np.float32), slots


FORMATS = {"libsvm": iter_libsvm, "criteo": iter_criteo, "adfea": iter_adfea}


def iter_format(fmt: str, path: str | Path) -> Iterator[Row]:
    if fmt not in FORMATS:
        raise ValueError(f"unknown data format {fmt!r}; known: {sorted(FORMATS)}")
    return FORMATS[fmt](path)
