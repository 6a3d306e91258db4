"""Sharded checkpoints and text model dumps.

The same on-disk format as the JAX package, so a checkpoint written by
either package loads into the other:

- ``save_checkpoint`` writes one ``shard-K-of-N.npz`` per kv shard plus a
  JSON manifest (array shapes and dtypes, and run metadata);
- ``dump_weights_text`` / ``load_weights_text`` is the text model dump, one
  ``key\\tweight`` line per nonzero weight.
"""

from __future__ import annotations

import json
from pathlib import Path
from typing import Any

import numpy as np

MANIFEST = "manifest.json"


def _flatten(state: dict[str, Any], prefix: str = "") -> dict[str, np.ndarray]:
    out = {}
    for k, v in state.items():
        name = f"{prefix}{k}"
        if isinstance(v, dict):
            out.update(_flatten(v, name + "/"))
        else:
            out[name] = np.asarray(v)
    return out


def _unflatten(flat: dict[str, np.ndarray]) -> dict[str, Any]:
    out: dict[str, Any] = {}
    for k, v in flat.items():
        parts = k.split("/")
        d = out
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        d[parts[-1]] = v
    return out


def save_checkpoint(
    ckpt_dir: str | Path,
    state: dict[str, Any],
    meta: dict[str, Any] | None = None,
    shard_id: int = 0,
    num_shards: int = 1,
) -> Path:
    """Write this shard's slice of ``state`` (a nested dict of numpy
    arrays) and, from shard 0, the manifest."""
    d = Path(ckpt_dir)
    d.mkdir(parents=True, exist_ok=True)
    flat = _flatten(state)
    np.savez(d / f"shard-{shard_id}-of-{num_shards}.npz", **flat)
    if shard_id == 0:
        manifest = {
            "num_shards": num_shards,
            "arrays": {k: {"shape": list(v.shape), "dtype": str(v.dtype)} for k, v in flat.items()},
            "meta": meta or {},
        }
        (d / MANIFEST).write_text(json.dumps(manifest, indent=1))
    return d


def load_checkpoint(
    ckpt_dir: str | Path, shard_id: int | None = None
) -> tuple[dict[str, Any], dict[str, Any]]:
    """Load (state, meta). shard_id=None concatenates all shards on axis 0
    (the key axis: shards are contiguous ranges); shard_id=k loads one."""
    d = Path(ckpt_dir)
    manifest = json.loads((d / MANIFEST).read_text())
    n = manifest["num_shards"]
    if shard_id is not None:
        flat = dict(np.load(d / f"shard-{shard_id}-of-{n}.npz"))
        return _unflatten(flat), manifest["meta"]
    shards = [dict(np.load(d / f"shard-{i}-of-{n}.npz")) for i in range(n)]
    flat = {
        k: (np.concatenate([s[k] for s in shards], axis=0) if n > 1 else shards[0][k])
        for k in shards[0]
    }
    return _unflatten(flat), manifest["meta"]


def dump_weights_text(weights: np.ndarray, path: str | Path, tol: float = 0.0) -> int:
    """One ``key\\tweight`` line per nonzero weight (vdim == 1). Returns
    the number of lines written."""
    w = np.asarray(weights).reshape(-1)
    nz = np.nonzero(np.abs(w) > tol)[0]
    with open(path, "w") as f:
        for k in nz:
            f.write(f"{int(k)}\t{w[k]:.9g}\n")
    return len(nz)


def load_weights_text(path: str | Path, num_keys: int) -> np.ndarray:
    """Inverse of dump_weights_text -> dense (num_keys,) float32."""
    w = np.zeros(num_keys, dtype=np.float32)
    with open(path) as f:
        for line in f:
            if not line.strip():
                continue
            k, _, v = line.partition("\t")
            ki = int(k)
            if not 0 <= ki < num_keys:
                raise ValueError(f"key {ki} outside [0, {num_keys}) in {path}")
            w[ki] = float(v)
    return w
