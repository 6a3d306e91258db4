"""The KV store core: pull/push over dense state tables.

``pull`` is a row gather and ``push`` applies the server updater to the
touched rows only, never the whole table. Unlike the JAX package's
functional ``push``, the port's ``push`` updates the tables IN PLACE and
returns the same state dict: for an ``Ftrl`` updater on CUDA it launches
the fused push kernel (``ops.ftrl_kernels.ftrl_push``); every other updater,
and every updater on the CPU, runs gather -> ``delta`` -> ``index_add_``.

Invariants (kept by the data layer's localizer):
  - ``idx`` passed to ``push`` contains each real key at most once; padding
    slots carry ``idx == PAD_KEY (0)`` and ``grad == 0``. Duplicate real
    keys must be pre-aggregated (segment-summed) by the caller: the updater
    computes one *delta* per (key, grad) pair.
  - Row 0 is the pad row: it absorbs zero-gradient updates and is excluded
    from dumps and nnz counts.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from parameter_server_tpu_torch.device import resolve_device
from parameter_server_tpu_torch.kv.updaters import Ftrl, Updater
from parameter_server_tpu_torch.ops.ftrl_kernels import ftrl_push

State = dict[str, torch.Tensor]


def state_from_numpy(state: dict[str, np.ndarray], device: Any = "cuda") -> State:
    """Carry a state dict of numpy arrays (e.g. the JAX package's state,
    or a checkpoint's ``kv`` tables) onto ``device``, as copies."""
    dev = resolve_device(device)
    return {
        k: torch.tensor(np.ascontiguousarray(v), device=dev)
        for k, v in state.items()
    }


def state_to_numpy(state: State) -> dict[str, np.ndarray]:
    """Host copies of every table, in the JAX package's layout."""
    return {k: v.detach().to("cpu", copy=True).numpy() for k, v in state.items()}


def pad_state_rows(state: State, num_rows: int) -> State:
    """Zero-extend every table of ``state`` on axis 0 up to ``num_rows``
    (identity when already there). Pad rows stay exactly zero and are
    never pushed, so they are invisible to pulls, dumps and nnz counts."""
    have = next(iter(state.values())).shape[0]
    if have == num_rows:
        return state
    if have > num_rows:
        raise ValueError(f"cannot pad {have} rows down to {num_rows}")
    return {
        k: torch.cat(
            [v, v.new_zeros((num_rows - have, *v.shape[1:]))], dim=0
        )
        for k, v in state.items()
    }


def _as_index(idx: Any, num_rows: int, device: torch.device) -> torch.Tensor:
    """Row indices as a contiguous int32 tensor on ``device``; indices that
    arrive from the host are bounds-checked here."""
    if not isinstance(idx, torch.Tensor):
        a = np.asarray(idx)
        if a.size and (int(a.min()) < 0 or int(a.max()) >= num_rows):
            raise IndexError(
                f"row index outside [0, {num_rows}): "
                f"min {int(a.min())}, max {int(a.max())}"
            )
        idx = torch.from_numpy(np.ascontiguousarray(a))
    return idx.to(device=device, dtype=torch.int32).contiguous()


def _as_grad(grad: Any, num_slots: int, device: torch.device,
             dtype: torch.dtype) -> torch.Tensor:
    if not isinstance(grad, torch.Tensor):
        grad = torch.from_numpy(np.ascontiguousarray(grad))
    return grad.to(device=device, dtype=dtype).reshape(num_slots, -1).contiguous()


def pull(updater: Updater, state: State, idx: Any) -> torch.Tensor:
    """Gather weights for (unique, padded) key indices: (U,) -> (U, vdim)."""
    table = next(iter(state.values()))
    i = _as_index(idx, table.shape[0], table.device)
    rows = {k: v.index_select(0, i) for k, v in state.items()}
    return updater.weights(rows)


def push(updater: Updater, state: State, idx: Any, grad: Any) -> State:
    """Apply the server updater to the touched rows, IN PLACE; returns
    ``state`` itself.

    grad: (U, vdim) pre-aggregated gradient aligned with ``idx``.
    """
    table = next(iter(state.values()))
    i = _as_index(idx, table.shape[0], table.device)
    g = _as_grad(grad, i.shape[0], table.device, table.dtype)
    if isinstance(updater, Ftrl):
        ftrl_push(state["z"], state["n"], i, g, **updater.hyper)
        return state
    rows = {k: v.index_select(0, i) for k, v in state.items()}
    deltas = updater.delta(rows, g)
    for k, v in state.items():
        v.index_add_(0, i, deltas[k])
    return state


def materialize_weights(updater: Updater, state: State) -> torch.Tensor:
    """Full (K, vdim) weight table (FTRL: lazily derived from z, n)."""
    return updater.weights(state)


def coalesce_pushes(
    idx_list: list[np.ndarray],
    grad_list: list[np.ndarray],
) -> tuple[np.ndarray, np.ndarray]:
    """Pre-aggregate several concurrent pushes into ONE (idx, grad) pair
    honoring the store invariant: each real key at most once, duplicate
    keys segment-summed, so a nonlinear updater (FTRL) sees each gradient
    contribution exactly once in the aggregate.

    ``grad_list`` entries are (U_i, vdim) (or (U_i,), normalized here);
    returns (unique_idx, (U, vdim) summed grads) as numpy host arrays.
    """
    if len(idx_list) == 1:
        # a single push carries no duplicates (the localizer contract)
        uniq = np.asarray(idx_list[0])
        summed = np.asarray(grad_list[0]).reshape(len(uniq), -1)
    else:
        idx = np.concatenate([np.asarray(i) for i in idx_list])
        g = np.concatenate(
            [
                np.asarray(x).reshape(len(i), -1)
                for i, x in zip(idx_list, grad_list)
            ]
        )
        uniq, inv = np.unique(idx, return_inverse=True)
        summed = np.zeros((len(uniq), g.shape[1]), dtype=g.dtype)
        np.add.at(summed, inv, g)
    return uniq, summed


def push_multi(
    updater: Updater,
    state: State,
    idx_list: list[np.ndarray],
    grad_list: list[np.ndarray],
) -> State:
    """Batched multi-push: coalesce N pushes (segment-summing duplicate
    keys across them) and apply the updater ONCE over the union of touched
    rows, in place. Deltas are computed from the pre-batch rows and the
    summed gradient (the paper's server-side aggregation)."""
    idx, grad = coalesce_pushes(idx_list, grad_list)
    return push(updater, state, idx, grad)


class KVStore:
    """Stateful wrapper an app holds: an updater bound to its state tables
    on one device (``cuda`` unless the caller passes ``device="cpu"``)."""

    def __init__(
        self,
        updater: Updater,
        num_keys: int,
        vdim: int = 1,
        dtype: torch.dtype = torch.float32,
        device: Any = "cuda",
    ):
        self.updater = updater
        self.num_keys = int(num_keys)
        self.vdim = int(vdim)
        self.device = resolve_device(device)
        self.state: State = updater.init(self.num_keys, self.vdim, dtype, self.device)

    def pull(self, idx: Any) -> torch.Tensor:
        return pull(self.updater, self.state, idx)

    def push(self, idx: Any, grad: Any) -> None:
        push(self.updater, self.state, idx, grad)

    def push_multi(
        self, idx_list: list[np.ndarray], grad_list: list[np.ndarray]
    ) -> None:
        """Apply N pushes as one coalesced, segment-summed update."""
        push_multi(self.updater, self.state, idx_list, grad_list)

    def weights(self) -> torch.Tensor:
        return materialize_weights(self.updater, self.state)

    def nnz(self, tol: float = 0.0) -> int:
        """Count of nonzero weights excluding the pad row, counted on the
        store's device."""
        return int((self.weights()[1:].abs() > tol).sum())
