"""Columnar feature-block layout + disk cache for the batch solver.

A copy of the JAX package's module: the same layout, ``.npy`` names,
``meta.json``, CACHE_VERSION and fingerprint, so a cache written by either
package's ``convert`` loads in the other.

Reference analog: src/data/slot_reader.h/.cc — the reference's SlotReader
parses the training text once and caches per-slot column blocks as binary
files in a local cache dir; later passes (and re-runs) read the cache
instead of re-parsing. Same contract here:

  - ``ColumnBlocks`` is the feature-major (CSC-ish) layout the DARLIN
    solver sweeps: entries grouped by contiguous dense-key block, padded to
    a static per-block width so every block has one shape.
  - ``save_column_blocks`` / ``load_column_blocks`` persist the arrays as
    ``.npy`` files plus a ``meta.json`` stats sidecar carrying a source
    fingerprint (file paths, sizes, mtimes, parse parameters). Loads are
    ``mmap_mode="r"`` so a reload never re-parses text and only pages in
    what a pass touches.
  - ``cached_column_blocks`` orchestrates: fingerprint-hit -> mmap load;
    miss (or no cache dir) -> parse + build + save.
"""

from __future__ import annotations

import hashlib
import json
import os
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from parameter_server_tpu_torch.data.batch import CSRBatch

CACHE_VERSION = 1
_ARRAYS = ("feat_local", "rows", "values", "labels")


@dataclass
class ColumnBlocks:
    """Feature-major (CSC-ish) layout of the full training set.

    Entries are grouped by feature block (contiguous ranges of the dense
    key space — the reference picks blocks from slots/feature groups; dense
    hashed ranges stand in for them), padded per block to a common length
    so the solver sweeps blocks of one shape. Padding entries point at
    local feature 0 / row 0 with value 0 (inert, as everywhere else)."""

    feat_local: np.ndarray  # (n_blocks, E) int32 — gid - block_begin
    rows: np.ndarray  # (n_blocks, E) int32
    values: np.ndarray  # (n_blocks, E) float32
    labels: np.ndarray  # (N,) float32
    num_keys: int
    block_size: int
    num_examples: int

    @property
    def n_blocks(self) -> int:
        return len(self.feat_local)

    @classmethod
    def from_batches(
        cls, batches: list[CSRBatch], num_keys: int, n_blocks: int
    ) -> "ColumnBlocks":
        """Build from CSRBatches (uses their global hashed unique_keys)."""
        if num_keys % n_blocks:
            raise ValueError(f"num_keys {num_keys} % n_blocks {n_blocks} != 0")
        gids, rows, vals, labels = [], [], [], []
        row0 = 0
        for b in batches:
            n, e = b.num_examples, b.num_entries
            gids.append(b.unique_keys[b.local_ids[:e]])
            rows.append(b.row_ids[:e].astype(np.int64) + row0)
            vals.append(b.values[:e])
            labels.append(b.labels[:n])
            row0 += n
        gid = np.concatenate(gids)
        row = np.concatenate(rows)
        val = np.concatenate(vals)
        y = np.concatenate(labels)

        block_size = num_keys // n_blocks
        blk = (gid // block_size).astype(np.int64)
        order = np.argsort(blk, kind="stable")
        gid, row, val, blk = gid[order], row[order], val[order], blk[order]
        counts = np.bincount(blk, minlength=n_blocks)
        e_max = max(1, int(counts.max()))
        feat_local = np.zeros((n_blocks, e_max), dtype=np.int32)
        rows_out = np.zeros((n_blocks, e_max), dtype=np.int32)
        vals_out = np.zeros((n_blocks, e_max), dtype=np.float32)
        starts = np.concatenate([[0], np.cumsum(counts)])
        for i in range(n_blocks):
            s, e = starts[i], starts[i + 1]
            c = e - s
            feat_local[i, :c] = gid[s:e] - i * block_size
            rows_out[i, :c] = row[s:e]
            vals_out[i, :c] = val[s:e]
        return cls(
            feat_local=feat_local,
            rows=rows_out,
            values=vals_out,
            labels=y,
            num_keys=num_keys,
            block_size=block_size,
            num_examples=len(y),
        )


def source_fingerprint(
    files: list[str],
    fmt: str,
    num_keys: int,
    n_blocks: int,
    max_nnz_per_example: int,
) -> str:
    """Hash of everything that determines the cache contents: source file
    identities (path, size, mtime) + the parse/layout parameters."""
    ident = {
        "version": CACHE_VERSION,
        "fmt": fmt,
        "num_keys": num_keys,
        "n_blocks": n_blocks,
        "max_nnz": max_nnz_per_example,
        "files": [],
    }
    for f in sorted(map(str, files)):
        st = Path(f).stat()  # missing source files are a hard error
        ident["files"].append([f, st.st_size, st.st_mtime_ns])
    return hashlib.sha256(json.dumps(ident).encode()).hexdigest()


def save_column_blocks(cache_dir: str | Path, cb: ColumnBlocks, fingerprint: str) -> None:
    d = Path(cache_dir)
    d.mkdir(parents=True, exist_ok=True)
    # invalidate any previous cache before touching the arrays, so a crash
    # mid-write can never leave a valid-looking sidecar over mixed contents
    (d / "meta.json").unlink(missing_ok=True)
    for name in _ARRAYS:
        np.save(d / f"{name}.npy", getattr(cb, name))
    meta = {
        "version": CACHE_VERSION,
        "fingerprint": fingerprint,
        "num_keys": cb.num_keys,
        "block_size": cb.block_size,
        "num_examples": cb.num_examples,
        "n_blocks": cb.n_blocks,
        "nnz": int((cb.values != 0).sum()),
    }
    # sidecar written last and atomically: its presence marks a complete
    # cache, so a partial write must never be observable at the final path
    tmp = d / "meta.json.tmp"
    tmp.write_text(json.dumps(meta, indent=1))
    os.replace(tmp, d / "meta.json")


def load_column_blocks(
    cache_dir: str | Path, fingerprint: str | None = None
) -> ColumnBlocks | None:
    """mmap-load a cache; None when absent, incomplete, or stale."""
    d = Path(cache_dir)
    meta_path = d / "meta.json"
    if not meta_path.exists():
        return None
    try:
        meta = json.loads(meta_path.read_text())
        if meta.get("version") != CACHE_VERSION:
            return None
        if fingerprint is not None and meta.get("fingerprint") != fingerprint:
            return None
        arrays = {}
        for name in _ARRAYS:
            p = d / f"{name}.npy"
            if not p.exists():
                return None
            arrays[name] = np.load(p, mmap_mode="r")
        return ColumnBlocks(
            **arrays,
            num_keys=meta["num_keys"],
            block_size=meta["block_size"],
            num_examples=meta["num_examples"],
        )
    except (json.JSONDecodeError, KeyError, ValueError, OSError):
        return None  # corrupt/truncated cache == cache miss, rebuild it


def cached_column_blocks(cfg) -> ColumnBlocks:
    """SlotReader behavior for a PSConfig: reuse ``data.cache_dir`` when its
    fingerprint matches the sources, else parse once and populate it."""
    from parameter_server_tpu_torch.data.batch import BatchBuilder
    from parameter_server_tpu_torch.data.reader import MinibatchReader

    n_blocks = cfg.solver.feature_blocks
    fp = source_fingerprint(
        cfg.data.files,
        cfg.data.format,
        cfg.data.num_keys,
        n_blocks,
        cfg.data.max_nnz_per_example,
    )
    if cfg.data.cache_dir:
        cb = load_column_blocks(cfg.data.cache_dir, fp)
        if cb is not None:
            return cb
    builder = BatchBuilder(
        num_keys=cfg.data.num_keys,
        batch_size=cfg.solver.minibatch,
        max_nnz_per_example=cfg.data.max_nnz_per_example,
    )
    batches = list(MinibatchReader(cfg.data.files, cfg.data.format, builder))
    cb = ColumnBlocks.from_batches(batches, cfg.data.num_keys, n_blocks)
    if cfg.data.cache_dir:
        save_column_blocks(cfg.data.cache_dir, cb, fp)
    return cb
