"""Dense logistic regression under plain SGD, in float32: a model that is
not ``LinearMethod``, for the benchmark's own tests."""

from __future__ import annotations

import torch


def step(w: torch.Tensor, x: torch.Tensor, y: torch.Tensor, lr: float):
    """One SGD step on the batch's mean logistic loss: the new weights and
    the loss, left on the device."""
    z = x @ w
    loss = torch.nn.functional.binary_cross_entropy_with_logits(z, y)
    return w - lr * (x.T @ (torch.sigmoid(z) - y) / y.shape[0]), loss


class DenseLR:
    def __init__(self, features: int, lr: float, device: str):
        self.w = torch.zeros(features, dtype=torch.float32, device=device)
        self.lr = lr

    def train(self, batches) -> list[float]:
        """One step a batch; the steps' losses, read back once at the end."""
        losses = []
        for x, y in batches:
            self.w, loss = step(self.w, x, y, self.lr)
            losses.append(loss)
        return torch.stack(losses).tolist()
