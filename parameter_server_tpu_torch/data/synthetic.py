"""Synthetic sparse classification data for tests and the chip smoke run.

A sparse logistic ground-truth model generates separable-but-noisy data
with a long-tailed (Zipf) feature distribution, the shape of CTR data."""

from __future__ import annotations

import numpy as np


def make_sparse_logistic(
    num_examples: int,
    num_features: int,
    nnz_per_example: int = 32,
    noise: float = 0.5,
    seed: int = 0,
    zipf_a: float = 1.3,
):
    """Returns (labels, keys, values, true_w). Feature ids follow a Zipf
    law so batches have realistic hot/cold key overlap."""
    rng = np.random.default_rng(seed)
    true_w = (rng.normal(size=num_features) * (rng.random(num_features) < 0.2)).astype(
        np.float32
    )
    labels = np.empty(num_examples, dtype=np.float32)
    keys: list[np.ndarray] = []
    values: list[np.ndarray] = []
    for i in range(num_examples):
        n = max(1, int(rng.poisson(nnz_per_example)))
        k = np.minimum(rng.zipf(zipf_a, size=n) - 1, num_features - 1).astype(
            np.uint64
        )
        k = np.unique(k)
        v = rng.normal(loc=1.0, scale=0.3, size=len(k)).astype(np.float32)
        margin = float(v @ true_w[k.astype(np.int64)]) + noise * rng.normal()
        labels[i] = 1.0 if margin > 0 else 0.0
        keys.append(k)
        values.append(v)
    return labels, keys, values, true_w


def write_libsvm(path, labels, keys, values) -> None:
    """Dump rows in libsvm text format."""
    with open(path, "w") as f:
        for y, k, v in zip(labels, keys, values):
            feats = " ".join(f"{int(ki)}:{vi:.6g}" for ki, vi in zip(k, v))
            f.write(f"{int(y)} {feats}\n")
