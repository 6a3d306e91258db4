"""Evaluation metrics: exact ROC AUC and logloss."""

from __future__ import annotations

import numpy as np


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact ROC AUC via the rank statistic (ties averaged)."""
    y = np.asarray(labels).astype(bool)
    s = np.asarray(scores, dtype=np.float64)
    n_pos = int(y.sum())
    n_neg = len(y) - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(s, kind="mergesort")
    ranks = np.empty(len(s), dtype=np.float64)
    s_sorted = s[order]
    uniq, inv, counts = np.unique(s_sorted, return_inverse=True, return_counts=True)
    cum = np.cumsum(counts)
    avg_rank = (cum - (counts - 1) / 2.0).astype(np.float64)
    ranks[order] = avg_rank[inv]
    return float((ranks[y].sum() - n_pos * (n_pos + 1) / 2) / (n_pos * n_neg))


def logloss(labels: np.ndarray, probs: np.ndarray, eps: float = 1e-12) -> float:
    y = np.asarray(labels, dtype=np.float64)
    p = np.clip(np.asarray(probs, dtype=np.float64), eps, 1 - eps)
    return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())
