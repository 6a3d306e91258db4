"""The plain reference of the dense logistic model: SGD on the mean
logistic loss from zero weights, in the precision it is given (float64 for
the reference, bfloat16 for the control). It imports nothing of the
program."""

from __future__ import annotations

import torch


def sgd_steps(xs, ys, lr: float, dtype=torch.float64) -> dict[str, list[float]]:
    """Each step's loss and the weights' norm after it."""
    w = torch.zeros(xs[0].shape[1], dtype=dtype)
    out: dict[str, list[float]] = {"loss": [], "w_norm": []}
    for x, y in zip(xs, ys):
        x, y = x.cpu().to(dtype), y.cpu().to(dtype)
        z = x @ w
        # log(1 + e^z) - y z, written so that no e^z overflows
        loss = (torch.clamp(z, min=0) + torch.log1p(torch.exp(-torch.abs(z))) - y * z).mean()
        w = w - lr * (x.T @ (1 / (1 + torch.exp(-z)) - y) / y.shape[0])
        out["loss"].append(float(loss))
        out["w_norm"].append(float(w.double().norm()))
    return out
