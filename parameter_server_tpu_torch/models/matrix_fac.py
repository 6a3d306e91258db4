"""Matrix factorization over the KV store.

The port of the JAX package's ``models/matrix_fac.py``, on one device.
User and item factor tables are KV tables with ``vdim = rank``. A rating
minibatch is localized as the sparse-LR batches are: the unique touched
users and items are pulled, per-pair gradients are segment-summed onto
the unique sets, and each table is pushed once through the store's
``push``. With AdaGrad on CUDA that push is the hand-written fused kernel
(``ops.adagrad_kernels.adagrad_push``); the step's unique key sets with
zero-gradient pad slots on key 0 are exactly its contract.

Unlike the JAX step, which donates the tables and returns new ones, the
port updates them IN PLACE. The forward pass gathers copies of the touched
rows (``index_select``), so the deltas come from the pre-step rows as in
the JAX step.

On a mesh (``parallel/mesh.py``) each rank holds its kv slice of both
tables and feeds its data shard's slice of every global step; the pushes
are the SPMD tier's (``parallel/spmd.py``): ``per_worker`` runs K3 once a
data shard a table on every kv shard, ``aggregate`` one AdaGrad step over
the whole shard. Unlike the JAX app, which refuses a kv count that does
not divide num_users + 1 and num_items + 1, the port zero-pads the tables
to the next kv multiple, as the linear tier does; no key reaches a pad row.
"""

from __future__ import annotations

import time
from dataclasses import dataclass
from typing import Any

import numpy as np
import torch

from parameter_server_tpu_torch.device import resolve_device
from parameter_server_tpu_torch.kv.store import (
    State,
    check_state_like,
    push,
    state_from_numpy,
    state_to_numpy,
)
from parameter_server_tpu_torch.kv.updaters import Adagrad, Sgd, Updater
from parameter_server_tpu_torch.parallel.ssp import DispatchWindow
from parameter_server_tpu_torch.utils.hashing import PAD_KEY
from parameter_server_tpu_torch.utils.metrics import ProgressReporter


@dataclass
class MFBatch:
    """Localized rating minibatch (static shapes)."""

    user_keys: np.ndarray  # (Uu,) unique user ids (slot 0 = pad)
    item_keys: np.ndarray  # (Ui,) unique item ids (slot 0 = pad)
    user_ids: np.ndarray  # (B,) pair -> unique user slot
    item_ids: np.ndarray  # (B,) pair -> unique item slot
    ratings: np.ndarray  # (B,)
    mask: np.ndarray  # (B,)
    num_pairs: int


class MFBatchBuilder:
    """The MF localizer: unique users/items per batch, padded."""

    def __init__(self, batch_size: int, user_capacity: int | None = None,
                 item_capacity: int | None = None):
        self.batch_size = batch_size
        self.user_capacity = user_capacity or batch_size + 1
        self.item_capacity = item_capacity or batch_size + 1

    def build(
        self, users: np.ndarray, items: np.ndarray, ratings: np.ndarray
    ) -> MFBatch:
        b = len(ratings)
        if b > self.batch_size:
            raise ValueError(f"{b} pairs > batch_size {self.batch_size}")
        uu, uinv = np.unique(users, return_inverse=True)
        ii, iinv = np.unique(items, return_inverse=True)
        if len(uu) + 1 > self.user_capacity or len(ii) + 1 > self.item_capacity:
            raise ValueError("unique capacity exceeded")
        out = MFBatch(
            user_keys=np.zeros(self.user_capacity, dtype=np.int64),
            item_keys=np.zeros(self.item_capacity, dtype=np.int64),
            user_ids=np.zeros(self.batch_size, dtype=np.int32),
            item_ids=np.zeros(self.batch_size, dtype=np.int32),
            ratings=np.zeros(self.batch_size, dtype=np.float32),
            mask=np.zeros(self.batch_size, dtype=np.float32),
            num_pairs=b,
        )
        out.user_keys[1 : len(uu) + 1] = uu + 1  # +1: key 0 is the pad row
        out.item_keys[1 : len(ii) + 1] = ii + 1
        out.user_ids[:b] = uinv + 1
        out.item_ids[:b] = iinv + 1
        out.ratings[:b] = ratings
        out.mask[:b] = 1.0
        assert PAD_KEY == 0
        return out


_MF_FIELDS = ("user_keys", "item_keys", "user_ids", "item_ids", "ratings", "mask")
_KEY_FIELDS = ("user_keys", "item_keys")


def batch_to_device(b: MFBatch, device: Any) -> dict[str, torch.Tensor]:
    """The batch's fields as tensors on ``device``; the int64 table keys
    become the int32 row indices the push kernels take."""
    return {
        f: torch.from_numpy(
            np.ascontiguousarray(getattr(b, f), dtype=np.int32)
            if f in _KEY_FIELDS else getattr(b, f)
        ).to(device)
        for f in _MF_FIELDS
    }


def _mf_loss_and_grads(
    U: torch.Tensor, V: torch.Tensor, batch: dict[str, torch.Tensor], l2: float
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """SSE loss + per-unique-key factor gradients (pad slot 0 is excluded
    from L2). The JAX package's ``segment_sum`` is ``index_add_`` here."""
    u = U.index_select(0, batch["user_ids"])  # (B, r)
    v = V.index_select(0, batch["item_ids"])
    pred = torch.sum(u * v, dim=1)
    err = (pred - batch["ratings"]) * batch["mask"]
    loss = torch.sum(err * err)
    uu, ui = U.shape[0], V.shape[0]
    # d/du = err * v (+ l2 u), aggregated over duplicate users in the batch
    g_u = torch.zeros_like(U).index_add_(
        0, batch["user_ids"], err[:, None] * v
    ) + l2 * U * (torch.arange(uu, device=U.device) > 0)[:, None]
    g_v = torch.zeros_like(V).index_add_(
        0, batch["item_ids"], err[:, None] * u
    ) + l2 * V * (torch.arange(ui, device=V.device) > 0)[:, None]
    return loss, g_u, g_v


def mf_train_step(
    user_up: Updater,
    item_up: Updater,
    user_state: State,
    item_state: State,
    batch: dict[str, torch.Tensor],
    l2: float,
) -> tuple[State, State, torch.Tensor]:
    """One MF step, IN PLACE: gather the touched factors (copies), SSE
    gradient, push both tables through ``kv.store.push``. Returns the
    (same) states and the step's SSE as a device scalar. MF's updaters
    (AdaGrad, SGD) keep their weights in ``w``."""
    uk, ik = batch["user_keys"], batch["item_keys"]
    U = user_state["w"].index_select(0, uk)  # (Uu, r)
    V = item_state["w"].index_select(0, ik)  # (Ui, r)
    loss, g_u, g_v = _mf_loss_and_grads(U, V, batch, l2)
    push(user_up, user_state, uk, g_u)
    push(item_up, item_state, ik, g_v)
    return user_state, item_state, loss


def _make_mf_spmd(
    user_up: Updater, item_up: Updater, mesh, num_user_rows: int,
    num_item_rows: int, l2: float, push_mode: str, multistep: bool,
):
    """The MF step on this rank's mesh cell, one microstep or K stacked
    (K, ...) ones: step(user_state, item_state, batch) -> (user_state,
    item_state, the data group's SSE), the tables updated in place."""
    from parameter_server_tpu_torch.parallel.spmd import (
        _local_push,
        _local_push_aggregate,
        _shard_size,
        pull,
    )

    if push_mode not in ("per_worker", "aggregate"):
        raise ValueError(f"unknown push_mode {push_mode!r}")
    u_shard = _shard_size(num_user_rows, mesh.kv)
    i_shard = _shard_size(num_item_rows, mesh.kv)

    def micro(user_l: State, item_l: State, b: dict) -> torch.Tensor:
        uk, ik = b["user_keys"], b["item_keys"]
        U = pull(user_up, user_l, uk, u_shard, mesh)
        V = pull(item_up, item_l, ik, i_shard, mesh)
        loss, g_u, g_v = _mf_loss_and_grads(U, V, b, l2)
        if push_mode == "aggregate":
            _local_push_aggregate(user_up, user_l, uk, g_u, u_shard, mesh)
            _local_push_aggregate(item_up, item_l, ik, g_v, i_shard, mesh)
        else:
            _local_push(user_up, user_l, mesh.all_gather(uk, "data"),
                        mesh.all_gather(g_u, "data"), mesh.k * u_shard, u_shard)
            _local_push(item_up, item_l, mesh.all_gather(ik, "data"),
                        mesh.all_gather(g_v, "data"), mesh.k * i_shard, i_shard)
        return loss

    def step(user_state: State, item_state: State, batch: dict):
        if multistep:
            loss = sum(micro(user_state, item_state, {k: v[i] for k, v in batch.items()})
                       for i in range(batch["mask"].shape[0]))
        else:
            loss = micro(user_state, item_state, batch)
        return user_state, item_state, mesh.psum_(loss.reshape(1), "data")[0]

    return step


def make_mf_spmd_train_step(
    user_up: Updater, item_up: Updater, mesh, num_user_rows: int,
    num_item_rows: int, l2: float, push_mode: str = "per_worker",
):
    """Multi-rank MF step: both factor tables range-sharded over the kv
    ranks, rating batches over the data ranks. ``aggregate`` pre-sums the
    factor gradients over the data group and applies ONE updater step
    (exactly ``per_worker`` for plain SGD)."""
    return _make_mf_spmd(user_up, item_up, mesh, num_user_rows, num_item_rows,
                         l2, push_mode, multistep=False)


def make_mf_spmd_train_multistep(
    user_up: Updater, item_up: Updater, mesh, num_user_rows: int,
    num_item_rows: int, l2: float, push_mode: str = "per_worker",
):
    """K sequential MF steps a call: batch fields stacked (K, ...); returns
    the summed SSE."""
    return _make_mf_spmd(user_up, item_up, mesh, num_user_rows, num_item_rows,
                         l2, push_mode, multistep=True)


def iter_rating_blocks(
    files: list[str], block_lines: int = 1 << 20
):
    """Stream ``user item rating`` text files (the MovieLens-style triple
    format the reference's MF app consumes) in bounded blocks of
    (users, items, ratings) int64/int64/float32 arrays."""
    for path in sorted(map(str, files)):
        us: list[int] = []
        it: list[int] = []
        rt: list[float] = []
        with open(path) as f:
            for line in f:
                parts = line.split()
                if len(parts) < 3:
                    continue
                try:
                    u, v, x = int(parts[0]), int(parts[1]), float(parts[2])
                except ValueError:
                    continue  # header / malformed line: skip, don't crash
                us.append(u)
                it.append(v)
                rt.append(x)
                if len(us) >= block_lines:
                    yield (
                        np.asarray(us, dtype=np.int64),
                        np.asarray(it, dtype=np.int64),
                        np.asarray(rt, dtype=np.float32),
                    )
                    us, it, rt = [], [], []
        if us:
            yield (
                np.asarray(us, dtype=np.int64),
                np.asarray(it, dtype=np.int64),
                np.asarray(rt, dtype=np.float32),
            )


class MatrixFactorization:
    """The MF app. num_users/num_items rows + 1 pad row each, on one
    device (``cuda`` unless the caller passes ``device="cpu"``), or, with
    ``mesh``, range-sharded over its kv ranks on the mesh's device, rating
    batches over its data ranks (then every rank of the world runs the
    same calls: training, ``state_dict`` and ``predict`` are collective).
    """

    def __init__(
        self,
        num_users: int,
        num_items: int,
        rank: int = 64,
        eta: float = 0.05,
        l2: float = 0.01,
        algo: str = "adagrad",
        init_scale: float = 0.1,
        seed: int = 0,
        reporter: ProgressReporter | None = None,
        mesh=None,
        push_mode: str = "per_worker",
        max_delay: int = 0,
        steps_per_call: int = 1,
        device: Any = "cuda",
    ):
        # push_mode is read on a mesh only; one device ignores it, as the JAX app does
        if mesh is not None and push_mode not in ("per_worker", "aggregate"):
            raise ValueError(f"unknown push_mode {push_mode!r}")
        self.rank = rank
        self.l2 = l2
        # K sequential MF steps per window entry (the solver.steps_per_call
        # idiom): their SSE is summed on the device and read back once;
        # max_delay then counts such K-step groups in flight
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
        self.steps_per_call = steps_per_call
        # on a mesh the table prints on rank 0; every rank keeps its history
        self.reporter = reporter or ProgressReporter(
            print_fn=print if mesh is None or mesh.rank == 0 else (lambda *_: None))
        make = {"adagrad": lambda: Adagrad(eta=eta), "sgd": lambda: Sgd(eta=eta)}
        if algo not in make:
            raise ValueError(f"mf algo must be one of {sorted(make)}")
        self.user_up = make[algo]()
        self.item_up = make[algo]()
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.num_user_rows, self.num_item_rows = num_users + 1, num_items + 1
        self.max_delay = max_delay  # SSP dispatch bound (ref: wait_time)
        # factors start small-random (a zero product has zero gradient);
        # pad row 0 stays zero. The draws are the JAX package's (float64,
        # user table first), so both start from the same tables bit for bit.
        rng = np.random.default_rng(seed)
        u0 = rng.normal(scale=init_scale, size=(num_users + 1, rank))
        i0 = rng.normal(scale=init_scale, size=(num_items + 1, rank))
        u0[0] = 0.0
        i0[0] = 0.0
        if mesh is None:
            self.user_state = self.user_up.init(num_users + 1, rank, device=self.device)
            self.item_state = self.item_up.init(num_items + 1, rank, device=self.device)
            self.user_state["w"] = torch.from_numpy(u0.astype(np.float32)).to(self.device)
            self.item_state["w"] = torch.from_numpy(i0.astype(np.float32)).to(self.device)
            return
        from parameter_server_tpu_torch.parallel.spmd import shard_state

        maker = make_mf_spmd_train_multistep if steps_per_call > 1 else make_mf_spmd_train_step
        self._spmd_step = maker(self.user_up, self.item_up, mesh, num_users + 1,
                                num_items + 1, l2=l2, push_mode=push_mode)
        names = list(self.user_up.init(1, 1, device="cpu"))  # "w" (and "n")

        def full(w0: np.ndarray) -> dict[str, np.ndarray]:
            return {k: w0.astype(np.float32) if k == "w" else np.zeros(w0.shape, np.float32)
                    for k in names}

        self.user_state = shard_state(full(u0), mesh)
        self.item_state = shard_state(full(i0), mesh)

    def state_dict(self) -> dict[str, dict[str, np.ndarray]]:
        """Host copies of both tables' state, in the JAX package's layout
        (on a mesh: the full tables, gathered; collective)."""
        if self.mesh is not None:
            from parameter_server_tpu_torch.parallel.spmd import unshard_state

            return {"user": unshard_state(self.user_state, self.mesh, self.num_user_rows),
                    "item": unshard_state(self.item_state, self.mesh, self.num_item_rows)}
        return {"user": state_to_numpy(self.user_state),
                "item": state_to_numpy(self.item_state)}

    def load_state(self, user: dict[str, np.ndarray], item: dict[str, np.ndarray]) -> None:
        """Replace both tables' state with numpy dicts of the same layout
        (e.g. the JAX app's ``user_state``/``item_state`` via ``np.asarray``;
        on a mesh, the full tables: each rank keeps its slice)."""
        if self.mesh is not None:
            from parameter_server_tpu_torch.parallel.spmd import full_like, shard_state

            # the full tables' shapes (this rank holds a padded slice)
            for name, have, rows, new in (("user", self.user_state, self.num_user_rows, user),
                                          ("item", self.item_state, self.num_item_rows, item)):
                check_state_like(name, full_like(have, rows), new)
            self.user_state = shard_state(user, self.mesh)
            self.item_state = shard_state(item, self.mesh)
            return
        check_state_like("user", self.user_state, user)
        check_state_like("item", self.item_state, item)
        self.user_state = state_from_numpy(user, self.device)
        self.item_state = state_from_numpy(item, self.device)

    def _check_ids(self, users: np.ndarray, items: np.ndarray) -> None:
        """Raw ids must address a table row (row = id + 1); checked on the
        host, since an out-of-range row on the card is a device fault."""
        for what, ids, rows in (("user", users, self.num_user_rows),
                                ("item", items, self.num_item_rows)):
            if len(ids) and (int(ids.min()) < 0 or int(ids.max()) + 1 >= rows):
                raise IndexError(
                    f"{what} id outside [0, {rows - 1}): min {int(ids.min())}, "
                    f"max {int(ids.max())}"
                )

    def _run_pairs(
        self, users, items, ratings, batch_size: int, builder: MFBatchBuilder
    ) -> tuple[float, int]:
        """Dispatch (already shuffled) rating triples as minibatches, SSP-
        gated every ``steps_per_call`` steps: each group's summed loss is
        read back only on retirement, never a per-batch device sync;
        returns (sse, pairs)."""
        self._check_ids(users, items)
        sse, n = 0.0, 0

        def _retire(step: int, loss_arr) -> None:
            nonlocal sse
            sse += float(loss_arr)

        gate = DispatchWindow(self.max_delay, _retire)
        K = self.steps_per_call
        if self.mesh is not None:
            n = self._run_pairs_mesh(users, items, ratings, batch_size, builder, gate)
            return sse, n  # the gate's retirements summed the SSE
        starts = range(0, len(ratings), batch_size)
        for call_i, c in enumerate(range(0, len(starts), K)):
            gate.gate(call_i)
            loss = None
            for s in starts[c : c + K]:
                sel = slice(s, s + batch_size)
                b = builder.build(users[sel], items[sel], ratings[sel])
                n += b.num_pairs
                step_loss = mf_train_step(
                    self.user_up, self.item_up, self.user_state,
                    self.item_state, batch_to_device(b, self.device), self.l2,
                )[2]
                loss = step_loss if loss is None else loss + step_loss
            gate.add(call_i, loss)
        gate.drain()
        return sse, n

    def _run_pairs_mesh(self, users, items, ratings, batch_size: int,
                        builder: MFBatchBuilder, gate: DispatchWindow) -> int:
        """The mesh branch of ``_run_pairs``: a global step takes
        ``batch_size`` pairs for each of the D data shards, and this rank
        builds only its own shard's slice of it (an inert batch where the
        slice is empty), so every rank runs the same collectives. Returns
        the pod's pairs; the SSE accumulates through ``gate``."""
        D, d, K = self.mesh.data, self.mesh.d, self.steps_per_call
        global_bs = batch_size * D
        empty = None
        n = 0
        starts = range(0, len(ratings), global_bs)
        for call_i, c in enumerate(range(0, len(starts), K)):
            gate.gate(call_i)
            micro = []
            for s in starts[c : c + K]:
                sel = slice(s + d * batch_size, s + (d + 1) * batch_size)
                if len(ratings[sel]):
                    b = builder.build(users[sel], items[sel], ratings[sel])
                else:
                    if empty is None:
                        empty = builder.build(np.zeros(0, np.int64), np.zeros(0, np.int64),
                                              np.zeros(0, np.float32))
                    b = empty
                micro.append(batch_to_device(b, self.device))
                n += min(len(ratings), s + global_bs) - s
            batch = (micro[0] if K == 1
                     else {k: torch.stack([m[k] for m in micro]) for k in micro[0]})
            loss = self._spmd_step(self.user_state, self.item_state, batch)[2]
            gate.add(call_i, loss)
        gate.drain()
        return n

    def train_epoch(
        self, users, items, ratings, batch_size: int = 4096, seed: int = 0
    ) -> float:
        """One shuffled pass; returns train RMSE."""
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(ratings))
        builder = MFBatchBuilder(batch_size)
        t0 = time.perf_counter()
        sse, n = self._run_pairs(
            np.asarray(users)[order], np.asarray(items)[order],
            np.asarray(ratings)[order], batch_size, builder,
        )
        rmse = float(np.sqrt(sse / max(n, 1)))
        self.reporter.report(
            examples=n, objv=rmse, ex_per_sec=n / max(time.perf_counter() - t0, 1e-9)
        )
        return rmse

    def train_files(
        self,
        files: list[str],
        batch_size: int = 4096,
        epochs: int = 1,
        block_lines: int = 1 << 20,
        seed: int = 0,
    ) -> float:
        """Stream ``user item rating`` text files: blocks of block_lines
        triples are shuffled in bounded memory and dispatched — ratings are
        never materialized file-set-wide. Returns the final epoch's train
        RMSE."""
        builder = MFBatchBuilder(batch_size)
        rmse = float("nan")
        for ep in range(max(1, epochs)):
            rng = np.random.default_rng(seed + 1009 * ep)
            sse, n = 0.0, 0
            t0 = time.perf_counter()
            for us, it, rt in iter_rating_blocks(files, block_lines):
                perm = rng.permutation(len(rt))
                s, c = self._run_pairs(
                    us[perm], it[perm], rt[perm], batch_size, builder
                )
                sse += s
                n += c
            if n == 0:
                # a perfect 0.0 RMSE over an unparseable file set (e.g.
                # comma-separated input) would pass any quality check
                raise ValueError(
                    f"no rating triples parsed from {files}: expected "
                    "whitespace-separated 'user item rating' lines"
                )
            rmse = float(np.sqrt(sse / n))
            self.reporter.report(
                examples=n, objv=rmse,
                ex_per_sec=n / max(time.perf_counter() - t0, 1e-9),
            )
        return rmse

    def predict(self, users, items) -> np.ndarray:
        """Predicted ratings (on a mesh: from the gathered tables;
        collective)."""
        users, items = np.asarray(users), np.asarray(items)
        self._check_ids(users, items)
        if self.mesh is None:
            tables = (self.user_state["w"], self.item_state["w"])
        else:
            st = self.state_dict()
            tables = (torch.from_numpy(st["user"]["w"]), torch.from_numpy(st["item"]["w"]))
        rows = [
            w.index_select(0, torch.from_numpy(ids.astype(np.int64) + 1).to(w.device))
            for w, ids in zip(tables, (users, items))
        ]
        return torch.sum(rows[0] * rows[1], dim=1).cpu().numpy()

    def rmse(self, users, items, ratings) -> float:
        p = self.predict(users, items)
        return float(np.sqrt(np.mean((p - ratings) ** 2)))
