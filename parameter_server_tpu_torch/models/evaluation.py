"""Batch model evaluation: load a text model dump (key\\tweight) plus
validation files, compute AUC and logloss."""

from __future__ import annotations

from pathlib import Path
from typing import Any

import numpy as np
import torch

from parameter_server_tpu_torch.data.batch import BatchBuilder
from parameter_server_tpu_torch.data.reader import MinibatchReader
from parameter_server_tpu_torch.device import resolve_device
from parameter_server_tpu_torch.models import metrics as M
from parameter_server_tpu_torch.ops.sparse import csr_logits
from parameter_server_tpu_torch.utils.checkpoint import load_weights_text


def evaluate_model(
    weights: np.ndarray | str | Path,
    files: list[str],
    fmt: str,
    num_keys: int,
    batch_size: int = 8192,
    max_nnz_per_example: int = 256,
    key_mode: str = "hash",
    device: Any = "cuda",
) -> dict:
    """AUC / logloss of a weight vector over validation files."""
    dev = resolve_device(device)
    if isinstance(weights, (str, Path)):
        weights = load_weights_text(weights, num_keys)
    w = torch.from_numpy(
        np.asarray(weights, dtype=np.float32).reshape(-1, 1).copy()
    ).to(dev)
    builder = BatchBuilder(
        num_keys=num_keys,
        batch_size=batch_size,
        max_nnz_per_example=max_nnz_per_example,
        key_mode=key_mode,
    )
    ys, ps = [], []
    n = 0
    for b in MinibatchReader(files, fmt, builder):
        t = {
            f: torch.from_numpy(getattr(b, f)).to(dev)
            for f in ("unique_keys", "values", "local_ids", "row_ids")
        }
        logits = csr_logits(
            w.index_select(0, t["unique_keys"]),
            t["values"], t["local_ids"], t["row_ids"],
            num_rows=len(b.labels),
        )
        ps.append(torch.sigmoid(logits)[: b.num_examples].cpu().numpy())
        ys.append(b.labels[: b.num_examples])
        n += b.num_examples
    y = np.concatenate(ys)
    p = np.concatenate(ps)
    return {
        "auc": M.auc(y, p),
        "logloss": M.logloss(y, p),
        "examples": n,
        "nnz_w": int((np.asarray(weights) != 0).sum()),
    }
