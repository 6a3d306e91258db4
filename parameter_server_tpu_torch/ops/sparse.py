"""Sparse CSR compute as segment sums.

The two hot loops of the async SGD worker: the CSR sparse matvec
``p = X w`` and its transpose ``g = X^T (sigma(p) - y)``, as
``index_select`` + ``index_add_`` over the flattened CSR entry list.
Padding entries (value 0 -> slot 0, row 0) vanish arithmetically. These are
XLA segment sums in the JAX package, not Pallas kernels.
"""

from __future__ import annotations

import torch


def csr_logits(
    w_u: torch.Tensor,  # (U,) or (U, 1) weights for the batch's unique keys
    values: torch.Tensor,  # (NNZ,)
    local_ids: torch.Tensor,  # (NNZ,) entry -> unique slot
    row_ids: torch.Tensor,  # (NNZ,) entry -> example row
    num_rows: int,
) -> torch.Tensor:
    """p[i] = sum_j X[i,j] * w[j] over the batch's CSR entries -> (B,)."""
    contrib = values * w_u.reshape(-1).index_select(0, local_ids)
    out = torch.zeros(num_rows, dtype=contrib.dtype, device=contrib.device)
    return out.index_add_(0, row_ids, contrib)


def csr_grad(
    err: torch.Tensor,  # (B,) per-example residual, already masked
    values: torch.Tensor,
    local_ids: torch.Tensor,
    row_ids: torch.Tensor,
    num_unique: int,
) -> torch.Tensor:
    """g[u] = sum_i X[i,u] * err[i] -> (U, 1), aligned with unique_keys:
    the pre-aggregation over duplicate keys that the push contract needs."""
    contrib = values * err.index_select(0, row_ids)
    g = torch.zeros(num_unique, dtype=contrib.dtype, device=contrib.device)
    return g.index_add_(0, local_ids, contrib)[:, None]


def logistic_loss(
    logits: torch.Tensor, labels: torch.Tensor, mask: torch.Tensor
) -> tuple[torch.Tensor, torch.Tensor]:
    """Masked summed logloss and the residual (p - y) * mask.

    Stable formulation: log(1+e^x) - y*x = softplus(x) - y*x, with softplus
    as logaddexp(x, 0) (as jax.nn.softplus), not F.softplus, which switches
    to x above its threshold."""
    m = mask.to(logits.dtype)
    softplus = torch.logaddexp(logits, torch.zeros_like(logits))
    loss = torch.sum(m * (softplus - labels * logits))
    err = (torch.sigmoid(logits) - labels) * m
    return loss, err
