"""Server-side updaters: SGD, AdaGrad, FTRL-proximal.

Each updater is a frozen dataclass of hyperparameters with methods over
*row slices* (the touched keys' state). Every step is an exact additive
``delta``, so a push is a scatter-ADD of the delta into the tables
(duplicate pad slots contribute zero). ``apply`` == rows + delta.

State layout per table (vdim = values per key):
  sgd:     {"w": (K, vdim)}
  adagrad: {"w": (K, vdim), "n": (K, vdim)}
  ftrl:    {"z": (K, vdim), "n": (K, vdim)}   -- w is DERIVED lazily

``Ftrl.delta`` runs the hand-written CUDA kernel on CUDA tensors and its
plain version on CPU tensors (``ops.ftrl_kernels.ftrl_delta``): the device
of the rows decides, so the JAX package's ``use_pallas`` switch has no
counterpart here.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Any, Protocol

import torch

from parameter_server_tpu_torch.ops.ftrl_kernels import ftrl_delta, ftrl_weights_plain

Rows = dict[str, torch.Tensor]  # name -> (U, vdim) slice of touched keys


class Updater(Protocol):
    """All updaters express their step as an exact additive ``delta``."""

    name: str

    def init(
        self, num_keys: int, vdim: int, dtype: torch.dtype, device: Any
    ) -> Rows: ...

    def delta(self, rows: Rows, grad: torch.Tensor) -> Rows: ...

    def weights(self, rows: Rows) -> torch.Tensor: ...


def apply_update(updater: "Updater", rows: Rows, grad: torch.Tensor) -> Rows:
    d = updater.delta(rows, grad)
    return {k: rows[k] + d[k] for k in rows}


def _zeros(num_keys: int, vdim: int, dtype: torch.dtype, device: Any) -> torch.Tensor:
    return torch.zeros((num_keys, vdim), dtype=dtype, device=device)


@dataclass(frozen=True)
class Sgd:
    """Plain SGD with optional L2: w -= eta * (g + l2 * w)."""

    eta: float = 0.1
    lambda_l2: float = 0.0
    name: str = "sgd"

    def init(self, num_keys: int, vdim: int = 1, dtype: torch.dtype = torch.float32,
             device: Any = "cuda") -> Rows:
        return {"w": _zeros(num_keys, vdim, dtype, device)}

    def delta(self, rows: Rows, grad: torch.Tensor) -> Rows:
        return {"w": -self.eta * (grad + self.lambda_l2 * rows["w"])}

    def weights(self, rows: Rows) -> torch.Tensor:
        return rows["w"]


@dataclass(frozen=True)
class Adagrad:
    """AdaGrad: n += g^2; w -= eta * g / (sqrt(n) + eps)."""

    eta: float = 0.1
    eps: float = 1e-8
    lambda_l2: float = 0.0
    name: str = "adagrad"

    def init(self, num_keys: int, vdim: int = 1, dtype: torch.dtype = torch.float32,
             device: Any = "cuda") -> Rows:
        return {
            "w": _zeros(num_keys, vdim, dtype, device),
            "n": _zeros(num_keys, vdim, dtype, device),
        }

    def delta(self, rows: Rows, grad: torch.Tensor) -> Rows:
        g = grad + self.lambda_l2 * rows["w"]
        dn = g * g
        n = rows["n"] + dn
        return {"w": -self.eta * g / (torch.sqrt(n) + self.eps), "n": dn}

    def weights(self, rows: Rows) -> torch.Tensor:
        return rows["w"]


@dataclass(frozen=True)
class Ftrl:
    """FTRL-proximal (McMahan et al.), the flagship updater.

    Per touched key:
        w      = prox(z, n)                      # current weight, derived
        sigma  = (sqrt(n + g^2) - sqrt(n)) / alpha
        z     += g - sigma * w
        n     += g^2
    and the lazy weight:
        w(z,n) = 0                                   if |z| <= lambda_l1
               = -(z - sign(z)*lambda_l1)
                 / ((beta + sqrt(n))/alpha + lambda_l2)   otherwise
    """

    alpha: float = 0.1
    beta: float = 1.0
    lambda_l1: float = 1.0
    lambda_l2: float = 0.0
    name: str = "ftrl"

    @property
    def hyper(self) -> dict[str, float]:
        """The kernels' keyword hyperparameters."""
        return {"alpha": self.alpha, "beta": self.beta,
                "l1": self.lambda_l1, "l2": self.lambda_l2}

    def init(self, num_keys: int, vdim: int = 1, dtype: torch.dtype = torch.float32,
             device: Any = "cuda") -> Rows:
        return {
            "z": _zeros(num_keys, vdim, dtype, device),
            "n": _zeros(num_keys, vdim, dtype, device),
        }

    def delta(self, rows: Rows, grad: torch.Tensor) -> Rows:
        dz, dn = ftrl_delta(rows["z"], rows["n"], grad, **self.hyper)
        return {"z": dz, "n": dn}

    def weights(self, rows: Rows) -> torch.Tensor:
        return ftrl_weights_plain(rows["z"], rows["n"], **self.hyper)


def make_updater(algo: str, **kw: Any) -> Updater:
    """Factory by config name."""
    table = {"sgd": Sgd, "adagrad": Adagrad, "ftrl": Ftrl}
    if algo not in table:
        raise ValueError(f"unknown updater '{algo}'; known: {sorted(table)}")
    cls = table[algo]
    valid = {f.name for f in dataclasses.fields(cls)} - {"name"}
    bad = set(kw) - valid
    if bad:
        raise ValueError(f"unknown {algo} hyperparameter(s) {sorted(bad)}")
    return cls(**kw)
