"""The plain reference: sparse logistic regression under FTRL-proximal.

Plain PyTorch on the CPU, in the precision it is given (float64 for the
reference, a lower one for the control). It imports nothing of the program
and takes nothing that the program made: it hashes the raw ids itself
(``reference/hashing.py``), finds the unique keys itself and keeps its own
tables. The equations are McMahan et al.'s, as the system states them:

    w(z, n)  = 0                                    if |z| <= l1
             = -(z - sign(z) l1) / ((beta + sqrt(n)) / alpha + l2)
    sigma    = (sqrt(n + g^2) - sqrt(n)) / alpha
    z       += g - sigma w(z, n)
    n       += g^2

A step's gradient is the sum over its examples of x (p - y)."""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch


@dataclass(frozen=True)
class Hyper:
    alpha: float
    beta: float
    l1: float
    l2: float

    @classmethod
    def of(cls, cfg: dict) -> "Hyper":
        f = cfg["ftrl"]
        return cls(f["alpha"], f["beta"], f["lambda_l1"], f["lambda_l2"])


def weights(z: torch.Tensor, n: torch.Tensor, h: Hyper) -> torch.Tensor:
    shrunk = torch.sign(z) * torch.clamp(torch.abs(z) - h.l1, min=0.0)
    return -shrunk / ((h.beta + torch.sqrt(n)) / h.alpha + h.l2)


def delta(z: torch.Tensor, n: torch.Tensor, g: torch.Tensor, h: Hyper):
    """(dz, dn) of one FTRL step on rows ``z``, ``n`` with gradient ``g``."""
    w = weights(z, n, h)
    sigma = (torch.sqrt(n + g * g) - torch.sqrt(n)) / h.alpha
    return g - sigma * w, g * g


def lr_steps(keys: list[np.ndarray], labels: list[np.ndarray], h: Hyper,
             dtype: torch.dtype = torch.float64) -> dict:
    """Train from zero tables over batches of (B, F) keys (every value 1)
    and (B,) labels. Returns each step's mean loss, the norm of the first
    step's gradient, and the norms of z and n after each step."""
    table = np.unique(np.concatenate([k.ravel() for k in keys]))
    z = torch.zeros(len(table), dtype=dtype)
    n = torch.zeros(len(table), dtype=dtype)
    losses, grad_norm, z_norms, n_norms = [], None, [], []
    for k, y in zip(keys, labels):
        b, f = k.shape
        uniq, inv = np.unique(k.ravel(), return_inverse=True)
        pos = torch.from_numpy(np.searchsorted(table, uniq))
        inv_t = torch.from_numpy(inv.ravel())
        zu, nu = z[pos], n[pos]
        logit = weights(zu, nu, h)[inv_t].reshape(b, f).sum(dim=1)
        yt = torch.from_numpy(np.asarray(y)).to(dtype)
        softplus = torch.logaddexp(logit, torch.zeros_like(logit))
        losses.append(float(torch.sum(softplus - yt * logit)) / b)
        err = torch.sigmoid(logit) - yt
        g = torch.zeros(len(uniq), dtype=dtype).index_add_(
            0, inv_t, err.repeat_interleave(f))
        if grad_norm is None:
            grad_norm = float(torch.linalg.vector_norm(g.double()))
        dz, dn = delta(zu, nu, g, h)
        z.index_add_(0, pos, dz)
        n.index_add_(0, pos, dn)
        z_norms.append(float(torch.linalg.vector_norm(z.double())))
        n_norms.append(float(torch.linalg.vector_norm(n.double())))
    return {"loss": losses, "grad_norm": grad_norm, "z_norm": z_norms, "n_norm": n_norms}

