"""The FTRL kernels: hand-written CUDA for Hopper, with their plain versions.

Two kernels replace the two Pallas kernels on the main path
(``parameter_server_tpu/ops/pallas_kernels.py``):

- ``ftrl_delta`` (CUDA ``ftrl_delta_kernel`` in ``csrc/ftrl.cu``) replaces
  ``ftrl_delta_pallas``: the elementwise FTRL delta ``(dz, dn)``.
- ``ftrl_push`` (CUDA ``ftrl_push_kernel``) replaces ``ftrl_push_pallas``:
  the in-place fused gather -> FTRL -> scatter over the touched rows.

Each wrapper checks its inputs (float32 tables and gradients, int32 row
indices, shapes, contiguity, one device) and raises on anything else. On
CPU tensors it runs its plain PyTorch version (``*_plain``); on CUDA
tensors it launches the kernel or raises — nothing falls back. The plain
versions repeat the JAX package's op order; the CPU tests hold them
against the JAX package, and ``chip_smoke.py`` holds each kernel against
its plain version on the card.

The CUDA source is compiled on first use with the port's other kernels
(``ops/cuda_build.py``) and called through ``ctypes``. Every successful
launch adds one to ``LAUNCHES[name]``.
"""

from __future__ import annotations

import ctypes

import torch

from parameter_server_tpu_torch.ops import cuda_build

#: launches of each kernel since the last ``reset_launches()``
LAUNCHES = {"ftrl_delta": 0, "ftrl_push": 0}

_P, _F, _I64, _INT = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong, ctypes.c_int
_DELTA_ARGS = [_P, _P, _P, _P, _P, _I64, _F, _F, _F, _F, _INT, _P]
_PUSH_ARGS = [_P, _P, _P, _P, _I64, _I64, _I64, _F, _F, _F, _F, _INT, _P]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


# ---------------------------------------------------------------------------
# plain versions (the JAX package's op order)
# ---------------------------------------------------------------------------


def ftrl_weights_plain(
    z: torch.Tensor, n: torch.Tensor, *, alpha: float, beta: float,
    l1: float, l2: float,
) -> torch.Tensor:
    """The lazy FTRL weight w(z, n): 0 where |z| <= l1, else
    -(z - sign(z)*l1) / ((beta + sqrt(n))/alpha + l2)."""
    shrunk = torch.sign(z) * torch.clamp(torch.abs(z) - l1, min=0.0)
    denom = (beta + torch.sqrt(n)) / alpha + l2
    return -shrunk / denom


def ftrl_delta_plain(
    z: torch.Tensor, n: torch.Tensor, g: torch.Tensor, *, alpha: float,
    beta: float, l1: float, l2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """(dz, dn) of one FTRL step: sigma = (sqrt(n + g^2) - sqrt(n))/alpha,
    dz = g - sigma*w(z, n), dn = g^2."""
    w = ftrl_weights_plain(z, n, alpha=alpha, beta=beta, l1=l1, l2=l2)
    n_new = n + g * g
    sigma = (torch.sqrt(n_new) - torch.sqrt(n)) / alpha
    return g - sigma * w, g * g


def ftrl_push_plain(
    z: torch.Tensor, n: torch.Tensor, idx: torch.Tensor, grad: torch.Tensor,
    *, alpha: float, beta: float, l1: float, l2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """gather -> delta -> ``index_add_``, in place on ``z`` and ``n``. Slots
    whose row lies outside [0, K) are skipped, as the kernel skips them (a
    kv shard's push hands it the keys of other shards that way)."""
    keep = (idx >= 0) & (idx < z.shape[0])
    idx, grad = idx[keep], grad[keep]
    dz, dn = ftrl_delta_plain(
        z.index_select(0, idx), n.index_select(0, idx), grad,
        alpha=alpha, beta=beta, l1=l1, l2=l2,
    )
    z.index_add_(0, idx, dz)
    n.index_add_(0, idx, dn)
    return z, n


# ---------------------------------------------------------------------------
# wrappers
# ---------------------------------------------------------------------------


def ftrl_delta(
    z: torch.Tensor, n: torch.Tensor, g: torch.Tensor, *, alpha: float,
    beta: float, l1: float, l2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused FTRL delta ``(dz, dn)`` over row slices of any (equal) shape."""
    for name, t in (("z", z), ("n", n), ("g", g)):
        cuda_build.check_tensor(name, t, torch.float32)
    if not z.shape == n.shape == g.shape:
        raise ValueError(
            f"z, n, g shapes differ: {tuple(z.shape)}, {tuple(n.shape)}, "
            f"{tuple(g.shape)}"
        )
    dev = cuda_build.common_device(z=z, n=n, g=g)
    if dev.type == "cpu":
        return ftrl_delta_plain(z, n, g, alpha=alpha, beta=beta, l1=l1, l2=l2)
    dz = torch.empty_like(z)
    dn = torch.empty_like(n)
    if z.numel():
        code = cuda_build.function("ps_ftrl_delta", _DELTA_ARGS)(
            z.data_ptr(), n.data_ptr(), g.data_ptr(), dz.data_ptr(),
            dn.data_ptr(), z.numel(), alpha, beta, l1, l2, dev.index or 0,
            torch.cuda.current_stream(dev).cuda_stream,
        )
        cuda_build.raise_on(code, "ftrl_delta")
        LAUNCHES["ftrl_delta"] += 1
    return dz, dn


def ftrl_push(
    z: torch.Tensor, n: torch.Tensor, idx: torch.Tensor, grad: torch.Tensor,
    *, alpha: float, beta: float, l1: float, l2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """In-place fused FTRL push over the touched rows: ``z``, ``n`` are
    (K, vdim) tables, updated in place and returned; ``idx`` (U,) int32 row
    indices, each real key at most once, pad slots idx 0 with zero
    ``grad``, slots outside [0, K) skipped; ``grad`` (U, vdim)."""
    dev = cuda_build.check_push(z=z, n=n, idx=idx, grad=grad)
    if dev.type == "cpu":
        return ftrl_push_plain(
            z, n, idx, grad, alpha=alpha, beta=beta, l1=l1, l2=l2
        )
    if idx.numel() and z.shape[1]:
        code = cuda_build.function("ps_ftrl_push", _PUSH_ARGS)(
            z.data_ptr(), n.data_ptr(), idx.data_ptr(), grad.data_ptr(),
            idx.shape[0], z.shape[1], z.shape[0], alpha, beta, l1, l2,
            dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
        )
        cuda_build.raise_on(code, "ftrl_push")
        LAUNCHES["ftrl_push"] += 1
    return z, n
