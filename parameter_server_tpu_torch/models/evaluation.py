"""Batch model evaluation: load a text model dump (key\\tweight) plus
validation files, compute AUC and logloss; and the linear predict that
every linear model's evaluation runs (``linear_predict``)."""

from __future__ import annotations

from collections.abc import Callable, Iterable
from pathlib import Path
from typing import Any

import numpy as np
import torch

from parameter_server_tpu_torch.data.batch import (
    BatchBuilder,
    CSRBatch,
    batch_to_device,
    trim_batch,
)
from parameter_server_tpu_torch.data.reader import MinibatchReader
from parameter_server_tpu_torch.device import resolve_device
from parameter_server_tpu_torch.models import metrics as M
from parameter_server_tpu_torch.ops.sparse import csr_logits
from parameter_server_tpu_torch.utils.checkpoint import load_weights_text


def linear_predict(
    batches: Iterable[CSRBatch], device: Any,
    weights_of: Callable[[torch.Tensor], torch.Tensor],
) -> tuple[np.ndarray, np.ndarray]:
    """Host (labels, probs) of a linear model over ``batches``: each batch's
    real prefix (``trim_batch``) on ``device``, sigmoid of its CSR logits
    from ``weights_of(unique_keys)``, the (U,) or (U, 1) weights of its
    unique keys. A pad entry adds an exact zero onto example row 0, so the
    probabilities are the padded batch's, and the pads stay on the host."""
    ys, ps = [], []
    for b in batches:
        dev = batch_to_device(trim_batch(b), device)
        logits = csr_logits(
            weights_of(dev["unique_keys"]), dev["values"], dev["local_ids"],
            dev["row_ids"], num_rows=len(b.labels),
        )
        ps.append(torch.sigmoid(logits)[: b.num_examples].cpu().numpy())
        ys.append(b.labels[: b.num_examples])
    return np.concatenate(ys), np.concatenate(ps)


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
    y, p = linear_predict(MinibatchReader(files, fmt, builder), dev,
                          lambda u: w.index_select(0, u))
    return {
        "auc": M.auc(y, p),
        "logloss": M.logloss(y, p),
        "examples": len(y),
        "nnz_w": int((np.asarray(weights) != 0).sum()),
    }
