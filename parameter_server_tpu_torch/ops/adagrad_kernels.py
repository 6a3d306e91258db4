"""The AdaGrad push kernel: hand-written CUDA for Hopper, with its plain
version.

``adagrad_push`` (CUDA ``adagrad_push_kernel`` in ``csrc/adagrad.cu``)
replaces ``adagrad_push_pallas`` (``parameter_server_tpu/ops/
pallas_kernels.py``): the in-place fused gather -> AdaGrad -> scatter over
the touched rows of an embedding table's ``w``, ``n`` (vdim 16-64 in the
apps that use it). The store's ``push`` runs it for every ``Adagrad``
updater, and so do ``push_multi``, ``KVStore`` and the matrix-factorization
step.

The wrapper checks its inputs (float32 tables and gradient, int32 row
indices, shapes, contiguity, one device) and raises on anything else. On
CPU tensors it runs ``adagrad_push_plain``; on CUDA tensors it launches the
kernel or raises — nothing falls back. The kernel is built with the port's
other kernels (``ops/cuda_build.py``). Every successful launch adds one to
``LAUNCHES["adagrad_push"]``.
"""

from __future__ import annotations

import ctypes

import torch

from parameter_server_tpu_torch.ops import cuda_build

#: launches of the kernel since the last ``reset_launches()``
LAUNCHES = {"adagrad_push": 0}

_P, _F, _I64 = ctypes.c_void_p, ctypes.c_float, ctypes.c_longlong
_PUSH_ARGS = [_P, _P, _P, _P, _I64, _I64, _I64, _F, _F, _F, ctypes.c_int, _P]


def reset_launches() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


def adagrad_push_plain(
    w: torch.Tensor, n: torch.Tensor, idx: torch.Tensor, grad: torch.Tensor,
    *, eta: float, eps: float, l2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """gather -> ``Adagrad.delta`` -> ``index_add_``, in place on ``w`` and
    ``n``, in the JAX package's op order: g' = g + l2*w, dn = g'^2,
    dw = -eta*g'/(sqrt(n + dn) + eps). Slots whose row lies outside [0, K)
    are skipped, as the kernel skips them."""
    keep = (idx >= 0) & (idx < w.shape[0])
    idx, grad = idx[keep], grad[keep]
    w_rows = w.index_select(0, idx)
    g = grad + l2 * w_rows
    dn = g * g
    n_new = n.index_select(0, idx) + dn
    w.index_add_(0, idx, -eta * g / (torch.sqrt(n_new) + eps))
    n.index_add_(0, idx, dn)
    return w, n


def adagrad_push(
    w: torch.Tensor, n: torch.Tensor, idx: torch.Tensor, grad: torch.Tensor,
    *, eta: float, eps: float, l2: float,
) -> tuple[torch.Tensor, torch.Tensor]:
    """In-place fused AdaGrad push over the touched rows: ``w``, ``n`` are
    (K, vdim) tables, updated in place and returned; ``idx`` (U,) int32 row
    indices, each real key at most once, pad slots idx 0 with zero
    ``grad`` (and, when ``l2 > 0``, a zero row 0), slots outside [0, K)
    skipped; ``grad`` (U, vdim)."""
    dev = cuda_build.check_push(w=w, n=n, idx=idx, grad=grad)
    if dev.type == "cpu":
        return adagrad_push_plain(w, n, idx, grad, eta=eta, eps=eps, l2=l2)
    if idx.numel() and w.shape[1]:
        code = cuda_build.function("ps_adagrad_push", _PUSH_ARGS)(
            w.data_ptr(), n.data_ptr(), idx.data_ptr(), grad.data_ptr(),
            idx.shape[0], w.shape[1], w.shape[0], eta, eps, l2,
            dev.index or 0, torch.cuda.current_stream(dev).cuda_stream,
        )
        cuda_build.raise_on(code, "adagrad_push")
        LAUNCHES["adagrad_push"] += 1
    return w, n
