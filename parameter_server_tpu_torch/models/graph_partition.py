"""Streaming bipartite graph partitioning ("Parsa"-style).

Reference analog: src/app/graph_partition/ — examples (U-vertices) stream
past and are greedily assigned to one of k partitions so that the features
(V-vertices) they touch are co-located, with a balance penalty keeping
partitions even; the parameter server holds each feature's
partition-presence state.

The JAX package's batched assignment, one step a minibatch on the
explicit device:

  gather   presence rows for the batch's unique features        (U, k)
  affinity A[e, p] = #features of e already present in p        (B, k)
  score    A - balance_penalty * normalized partition sizes
  assign   argmax_p score (first index on ties)                 (B,)
  scatter  one-hot(assign) back into feature presence + sizes

The presence table is updated in place (the JAX step donates it). Every
presence, affinity and size value is a count held in float32 below 2^24,
so every sum is exact in any order: the card, the CPU and the JAX package
give the same assignments and state bit for bit.
"""

from __future__ import annotations

from collections.abc import Iterable
from typing import Any

import numpy as np
import torch
import torch.nn.functional as F

from parameter_server_tpu_torch.data.batch import CSRBatch, batch_to_device, trim_batch
from parameter_server_tpu_torch.device import resolve_device
from parameter_server_tpu_torch.kv.store import state_from_numpy, state_to_numpy
from parameter_server_tpu_torch.utils.config import PSConfig

State = dict[str, torch.Tensor]  # {"presence": (K, k), "sizes": (k,)}


def init_state(num_keys: int, num_partitions: int, device: Any = "cuda") -> State:
    dev = resolve_device(device)
    return {
        "presence": torch.zeros((num_keys, num_partitions), dtype=torch.float32, device=dev),
        "sizes": torch.zeros(num_partitions, dtype=torch.float32, device=dev),
    }


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    out = torch.zeros((n, *x.shape[1:]), dtype=x.dtype, device=x.device)
    return out.index_add_(0, ids, x)


@torch.no_grad()
def partition_step(
    state: State,
    batch: dict[str, torch.Tensor],
    num_partitions: int,
    balance_penalty: float,
    refine_passes: int = 2,
) -> tuple[State, torch.Tensor]:
    """Assign one batch of examples; updates ``state`` in place and returns
    (state, assignments (B,)).

    Pass 0 scores against the start-of-batch presence; the refinement
    passes re-score against presence *including the batch's provisional
    votes* (own vote removed)."""
    idx = batch["unique_keys"]
    local_ids, row_ids = batch["local_ids"], batch["row_ids"]
    num_rows = batch["labels"].shape[0]
    rows = state["presence"].index_select(0, idx)  # (U, k) pull
    # binary edge weights (presence, not values): co-location is set overlap
    entry_w = (batch["values"] != 0).float()[:, None]
    mask = batch["example_mask"].float()

    def affinity_of(presence_rows: torch.Tensor) -> torch.Tensor:
        # binary presence: "how many of my features are already IN p"
        here = (presence_rows > 0).float()
        contrib = entry_w * here.index_select(0, local_ids)
        return _segment_sum(contrib, row_ids, num_rows)

    def votes_of(assign: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
        onehot = F.one_hot(assign, num_partitions).float() * mask[:, None]
        votes = entry_w * onehot.index_select(0, row_ids)  # (NNZ, k)
        return onehot, _segment_sum(votes, local_ids, idx.shape[0])

    sizes = state["sizes"]
    mean_size = torch.clamp_min(sizes.mean(), 1.0)
    # deterministic round-robin tie-break: a cold start (all-zero affinity)
    # must spread examples, not argmax-pile them onto partition 0
    tie = 1e-3 * F.one_hot(
        torch.arange(num_rows, device=idx.device) % num_partitions, num_partitions
    ).float()
    base = affinity_of(rows)
    assign = torch.argmax(base - balance_penalty * sizes / mean_size + tie, dim=1)
    for _ in range(refine_passes):
        onehot, delta = votes_of(assign)
        batch_sizes = sizes + onehot.sum(0)
        mean2 = torch.clamp_min(batch_sizes.mean(), 1.0)
        # re-score with the batch's votes in, each example's own vote
        # removed per entry BEFORE the presence threshold
        total = (rows + delta).index_select(0, local_ids)  # (NNZ, k)
        others = total - entry_w * onehot.index_select(0, row_ids)
        contrib = entry_w * (others > 0).float()
        aff = _segment_sum(contrib, row_ids, num_rows)
        assign = torch.argmax(aff - balance_penalty * batch_sizes / mean2 + tie, dim=1)
    onehot, delta = votes_of(assign)
    # pad slot 0 stays zero (its entries have value 0, so their votes are 0)
    state["presence"].index_add_(0, idx, delta)
    state["sizes"].add_(onehot.sum(0))
    return state, assign


def device_batch(b: CSRBatch, device: Any) -> dict[str, torch.Tensor]:
    """The batch's real prefixes on ``device``: pad entries (value 0) vote
    nothing, and the pad slots' zero deltas, all at key 0, would serialize
    the presence update's atomic adds on one row."""
    return batch_to_device(trim_batch(b), device)


def partition_metrics(state: State | dict[str, np.ndarray]) -> dict[str, float]:
    """Partition quality: replication factor (mean #partitions each touched
    feature lands in — the communication cost proxy) and size balance
    (max/mean)."""
    presence = _host(state["presence"])
    touched = presence.sum(axis=1) > 0
    if not touched.any():
        return {"replication": 0.0, "balance": 0.0, "features": 0}
    reps = (presence[touched] > 0).sum(axis=1)
    sizes = _host(state["sizes"])
    return {
        "replication": float(reps.mean()),
        "balance": float(sizes.max() / max(sizes.mean(), 1e-9)),
        "features": int(touched.sum()),
    }


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


class GraphPartition:
    """The app object (ref: the graph_partition App), on one device
    (``cuda`` unless the caller passes ``device="cpu"``).

    Streams example batches, maintains the presence table, and reports
    replication/balance the way the linear app reports objv/AUC."""

    def __init__(self, cfg: PSConfig, device: Any = "cuda"):
        self.cfg = cfg
        self.k = cfg.graph.num_partitions
        self.balance_penalty = cfg.graph.balance_penalty
        self.device = resolve_device(device)
        self.state = init_state(cfg.data.num_keys, self.k, self.device)
        self.examples = 0

    def load_state(self, state: dict[str, np.ndarray]) -> None:
        """Continue from a host state (``presence``, ``sizes``: e.g. the JAX
        app's state as numpy arrays)."""
        for k, v in self.state.items():
            if k not in state or tuple(np.shape(state[k])) != tuple(v.shape):
                raise ValueError(f"partition state {k!r} must have shape {tuple(v.shape)}")
        self.state = state_from_numpy(
            {k: np.asarray(state[k], np.float32) for k in self.state}, self.device)

    def state_dict(self) -> dict[str, np.ndarray]:
        return state_to_numpy(self.state)

    def partition(self, batches: Iterable[CSRBatch]) -> dict[str, Any]:
        assignments: list[np.ndarray] = []
        for b in batches:
            self.state, assign = partition_step(
                self.state, device_batch(b, self.device), self.k, self.balance_penalty
            )
            assignments.append(assign[: b.num_examples].cpu().numpy())
            self.examples += b.num_examples
        out = partition_metrics(self.state)
        out["examples"] = self.examples
        self.assignments = (
            np.concatenate(assignments) if assignments else np.zeros(0, np.int64)
        )
        return out

    def partition_files(self, files: list[str]) -> dict[str, Any]:
        from parameter_server_tpu_torch.data.batch import BatchBuilder
        from parameter_server_tpu_torch.data.reader import MinibatchReader

        builder = BatchBuilder(
            num_keys=self.cfg.data.num_keys,
            batch_size=self.cfg.solver.minibatch,
            max_nnz_per_example=self.cfg.data.max_nnz_per_example,
        )
        return self.partition(MinibatchReader(files, self.cfg.data.format, builder))

    def feature_partition(self) -> np.ndarray:
        """Per-feature home partition (argmax presence, first index on ties;
        -1 = untouched) — the partition map a data-placement pass consumes."""
        presence = _host(self.state["presence"])
        home = presence.argmax(axis=1)
        home[presence.sum(axis=1) == 0] = -1
        return home

    def dump_partition(self, path: str) -> int:
        """Text dump ``feature_id\\tpartition`` for touched features (the
        graph analog of the key\\tweight model dump)."""
        home = self.feature_partition()
        n = 0
        with open(path, "w") as f:
            for fid in np.nonzero(home >= 0)[0]:
                f.write(f"{fid}\t{home[fid]}\n")
                n += 1
        return n
