"""Evaluation metrics: exact ROC AUC and logloss."""

from __future__ import annotations

import numpy as np
import torch


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Exact ROC AUC via the rank statistic (ties averaged): ``auc_tensor``
    on the CPU over the scores widened to float64; NaN when a class is
    empty."""
    return float(auc_tensor(torch.from_numpy(np.asarray(labels).astype(bool)),
                            torch.from_numpy(np.ascontiguousarray(scores, dtype=np.float64))))


def auc_tensor(labels: torch.Tensor, scores: torch.Tensor) -> torch.Tensor:
    """Exact ROC AUC on tensors, on their own device and without a host
    sync: a 0-dim float64 tensor (``auc`` reads it on the CPU).

    Sorted, the scores fall into groups of equal value. A positive beats
    the negatives of lower groups and ties half of its own group's, so
    2U = sum over groups of pos_g * (2 * neg_before_g + neg_g), counted
    exactly in int64; AUC = 2U / (2 * n_pos * n_neg), one float64
    division of exact integers, the rank statistic's bits. The group
    buffers are N long whatever the number of groups, so no size is read
    back; with a class empty the division is 0/0, NaN.
    """
    s, order = torch.sort(scores.reshape(-1))
    pos = (labels.reshape(-1) != 0).to(torch.int64)[order]
    n = s.numel()
    starts = torch.ones(n, dtype=torch.int64, device=s.device)
    starts[1:] = s[1:] != s[:-1]
    group = torch.cumsum(starts, 0) - 1
    pos_g = torch.zeros_like(pos).index_add_(0, group, pos)
    neg_g = torch.zeros_like(pos).index_add_(0, group, 1 - pos)
    neg_before = torch.cumsum(neg_g, 0) - neg_g
    twice_u = (pos_g * (2 * neg_before + neg_g)).sum()
    n_pos = pos.sum()
    return twice_u.double() / (2 * n_pos * (n - n_pos)).double()


def logloss(labels: np.ndarray, probs: np.ndarray, eps: float = 1e-12) -> float:
    y = np.asarray(labels, dtype=np.float64)
    p = np.clip(np.asarray(probs, dtype=np.float64), eps, 1 - eps)
    return float(-(y * np.log(p) + (1 - y) * np.log(1 - p)).mean())
