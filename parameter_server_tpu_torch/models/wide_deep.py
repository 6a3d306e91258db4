"""Wide & Deep CTR model with its embedding table in the KV store.

The port of the JAX package's ``models/wide_deep.py``, on one device. The
wide half is the sparse linear model (FTRL over the hashed key space); the
deep half is an AdaGrad embedding table in the same key space (vdim = the
embedding dim) feeding a small ReLU MLP. ``torch.autograd`` takes the
gradients with respect to the pulled wide weights, the pulled embedding
rows and the MLP (``jax.value_and_grad`` in the JAX package); both tables
are then pushed through ``kv.store.push`` and the MLP steps with Adam.
Pull and push stay the only interface to model state. On CUDA the wide
push is the hand-written fused FTRL kernel (``ops.ftrl_kernels.ftrl_push``)
and the embedding push the fused AdaGrad kernel
(``ops.adagrad_kernels.adagrad_push``): a batch's unique keys, with a
zero-gradient pad slot on key 0, are exactly their contract. The step
pushes only the batch's real prefix of unique keys, not its pad slots.

Unlike the JAX step, which donates the tables and returns new ones, the
port updates them IN PLACE.

On a mesh (``parallel/mesh.py``) each rank holds its kv slice of both
tables and a replica of the MLP and Adam, and runs the JAX mesh step
(``make_wd_spmd_train_step``): both tables pulled by masked gathers
summed over the kv group; ``per_worker`` pushes gathered over the data
group and applied one data shard after another (K1 for the wide table,
K3 for the embeddings: D launches of each a step on every kv rank);
``aggregate`` one FTRL step (K2 over the whole shard) and one AdaGrad
step over the summed gradients; ``quantized`` ``per_worker`` with int8
gradients on the wire (streams 1 and 2); the MLP's gradients summed over
the data group in one all-reduce, and Adam stepped only when some data
shard had examples. Every rank reads the whole batch stream and keeps
batch ``k*D + d`` of each group of D*K, as the JAX app deals them.
"""

from __future__ import annotations

import dataclasses
import itertools
import time
from collections.abc import Iterable
from typing import Any

import numpy as np
import torch

from parameter_server_tpu_torch.data.batch import CSRBatch, batch_to_device, zero_extend
from parameter_server_tpu_torch.data.reader import MinibatchReader
from parameter_server_tpu_torch.device import resolve_device
from parameter_server_tpu_torch.kv.store import (
    State,
    check_state_like,
    push,
    state_from_numpy,
    state_to_numpy,
)
from parameter_server_tpu_torch.kv.updaters import Adagrad, Ftrl, Updater
from parameter_server_tpu_torch.models import metrics as M
from parameter_server_tpu_torch.ops.sparse import csr_logits
from parameter_server_tpu_torch.parallel.spmd import (
    _check_push_mode,
    _local_push,
    _local_push_aggregate,
    _local_push_quantized,
    _push_seed,
    _shard_size,
    full_like,
    pull,
    shard_state,
    unshard_state,
)
from parameter_server_tpu_torch.parallel.ssp import DispatchWindow
from parameter_server_tpu_torch.utils.metrics import ProgressReporter

#: rows of the embedding init drawn at a time: the float64 draw of a
#: 10^8-row table would take 12.8 GB of host memory at once
INIT_CHUNK_ROWS = 1 << 20


def init_mlp(dim: int, hidden: list[int], seed: int = 0) -> list[dict[str, np.ndarray]]:
    """He-normal MLP layers as float32 numpy, the JAX package's draws
    (float64, then cast): ``W`` (fan_in, fan_out), ``b`` zeros."""
    rng = np.random.default_rng(seed)
    sizes = [dim, *hidden, 1]
    return [
        {"W": rng.normal(scale=np.sqrt(2.0 / fan_in), size=(fan_in, fan_out)).astype(np.float32),
         "b": np.zeros(fan_out, dtype=np.float32)}
        for fan_in, fan_out in zip(sizes, sizes[1:])
    ]


def normal_table(
    rng: np.random.Generator, num_rows: int, dim: int, scale: float, device: Any,
    lo: int = 0, hi: int | None = None,
) -> torch.Tensor:
    """Rows [lo, hi) (all by default) of ``rng.normal(scale=scale,
    size=(num_rows, dim))`` cast to float32 on ``device``, drawn
    ``INIT_CHUNK_ROWS`` rows at a time; rows at or past ``num_rows`` (a kv
    shard's pad rows) are zero. The generator fills sequentially, so the
    rows equal the one-shot draw's; the rows before ``lo`` are drawn and
    dropped, so a kv shard never holds the whole table."""
    hi = num_rows if hi is None else hi
    out = torch.zeros((hi - lo, dim), dtype=torch.float32, device=device)
    end = min(hi, num_rows)
    for c in range(0, end, INIT_CHUNK_ROWS):
        e = min(c + INIT_CHUNK_ROWS, end)
        block = rng.normal(scale=scale, size=(e - c, dim))
        if e > lo:
            first = max(c, lo)
            out[first - lo:e - lo].copy_(torch.from_numpy(block[first - c:].astype(np.float32)))
    return out


class MLP(torch.nn.Module):
    """The deep half: ReLU layers and a scalar output, each ``W`` held
    (fan_in, fan_out) as in the JAX package."""

    def __init__(self, layers: list[dict[str, np.ndarray]], device: Any):
        super().__init__()

        def param(a) -> torch.nn.Parameter:
            return torch.nn.Parameter(torch.tensor(np.asarray(a, np.float32), device=device))

        self.W = torch.nn.ParameterList([param(layer["W"]) for layer in layers])
        self.b = torch.nn.ParameterList([param(layer["b"]) for layer in layers])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        last = len(self.W) - 1
        for i in range(last):
            x = torch.relu(x @ self.W[i] + self.b[i])
        return (x @ self.W[last] + self.b[last])[:, 0]

    def layers(self) -> list[dict[str, np.ndarray]]:
        """Host copies of the layers, in the JAX package's layout."""
        return [
            {"W": W.detach().to("cpu", copy=True).numpy(),
             "b": b.detach().to("cpu", copy=True).numpy()}
            for W, b in zip(self.W, self.b)
        ]


def _forward(
    w_u: torch.Tensor, emb_rows_w: torch.Tensor, mlp: MLP, b: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Wide logits + deep logits -> (masked summed logloss, logits)."""
    num_rows = b["labels"].shape[0]
    wide = csr_logits(w_u, b["values"], b["local_ids"], b["row_ids"], num_rows=num_rows)
    # mean-pool the batch's unique-key embeddings per example; pad entries
    # (value 0, slot 0) are masked out, so slot 0 gets no gradient
    ones = (b["values"] != 0).to(emb_rows_w.dtype)
    ent_emb = emb_rows_w.index_select(0, b["local_ids"]) * ones[:, None]
    num = torch.zeros((num_rows, emb_rows_w.shape[1]), dtype=ent_emb.dtype,
                      device=ent_emb.device).index_add_(0, b["row_ids"], ent_emb)
    cnt = torch.zeros(num_rows, dtype=ones.dtype, device=ones.device).index_add_(
        0, b["row_ids"], ones)
    pooled = num / torch.clamp(cnt, min=1.0)[:, None]
    logits = wide + mlp(pooled)
    m = b["example_mask"].to(logits.dtype)
    softplus = torch.logaddexp(logits, torch.zeros_like(logits))  # as jax.nn.softplus
    loss = torch.sum(m * (softplus - b["labels"] * logits))
    return loss, logits


def _pull_rows(updater: Updater, state: State, idx: torch.Tensor) -> torch.Tensor:
    """The weights of the touched rows as a detached leaf for autograd."""
    rows = {k: v.index_select(0, idx) for k, v in state.items()}
    return updater.weights(rows).detach().requires_grad_()


def wd_train_step(
    wide_up: Updater,
    emb_up: Updater,
    wide_state: State,
    emb_state: State,
    mlp: MLP,
    opt: torch.optim.Optimizer,
    batch: dict[str, torch.Tensor],
    num_examples: int,
    num_unique: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """One Wide&Deep step, IN PLACE: pull the touched rows of both tables,
    take the gradients by autograd, push both tables, step Adam. Returns
    the step's summed loss and its probabilities, on the device.

    Only the batch's first ``num_unique`` slots (``CSRBatch.num_unique``,
    pad slot 0 included) are pulled and pushed. Every entry's local id is
    below that count and pad entries point at slot 0, so the slots after
    it get an autograd gradient of exactly 0 on row 0: pushing them would
    be a no-op, and the JAX step, which pushes all of them, computes the
    same function.

    A batch with no examples (``num_examples == 0``) moves neither the MLP
    nor Adam's state: Adam would still advance its moment decay on a zero
    gradient, so the update is gated on activity as in the JAX step. The
    host knows both counts, so neither costs a device sync."""
    idx = batch["unique_keys"][:num_unique]
    w_u = _pull_rows(wide_up, wide_state, idx)
    e_w = _pull_rows(emb_up, emb_state, idx)
    params = list(mlp.parameters())
    loss, logits = _forward(w_u, e_w, mlp, batch)
    g_wide, g_emb, *g_mlp = torch.autograd.grad(loss, [w_u, e_w, *params])
    push(wide_up, wide_state, idx, g_wide)
    push(emb_up, emb_state, idx, g_emb)
    if num_examples > 0:
        for p, g in zip(params, g_mlp):
            p.grad = g
        opt.step()
    return loss.detach(), torch.sigmoid(logits.detach())


def _make_wd_spmd(
    wide_up: Updater, emb_up: Updater, mesh, num_keys: int, push_mode: str,
    multistep: bool,
):
    """The Wide&Deep step on this rank's mesh cell, one microstep or K
    (see the two makers below)."""
    _check_push_mode(push_mode)
    shard_size = _shard_size(num_keys, mesh.kv)
    begin = mesh.k * shard_size

    def micro(wide_l, emb_l, mlp, opt, b, num_unique: int, active: bool, seed: int):
        idx = b["unique_keys"][:num_unique]
        # the pulled weights as leaves for autograd, as ``_pull_rows``
        w_u = pull(wide_up, wide_l, idx, shard_size, mesh).requires_grad_()
        e_u = pull(emb_up, emb_l, idx, shard_size, mesh).requires_grad_()
        params = list(mlp.parameters())
        loss, logits = _forward(w_u, e_u, mlp, b)
        g_wide, g_emb, *g_mlp = torch.autograd.grad(loss, [w_u, e_u, *params])
        if push_mode == "aggregate":
            _local_push_aggregate(wide_up, wide_l, idx, g_wide, shard_size, mesh)
            _local_push_aggregate(emb_up, emb_l, idx, g_emb, shard_size, mesh)
        elif push_mode == "quantized":
            # the JAX app's streams: the two tables' rounding noise is
            # independent under the microstep's one seed
            _local_push_quantized(wide_up, wide_l, idx, g_wide, shard_size, mesh, seed,
                                  stream=1)
            _local_push_quantized(emb_up, emb_l, idx, g_emb, shard_size, mesh, seed,
                                  stream=2)
        else:
            all_idx = mesh.all_gather(idx, "data")
            _local_push(wide_up, wide_l, all_idx, mesh.all_gather(g_wide, "data"), begin,
                        shard_size)
            _local_push(emb_up, emb_l, all_idx, mesh.all_gather(g_emb, "data"), begin,
                        shard_size)
        # the MLP's gradients and the loss, summed over the data group in
        # one buffer: every replica then takes the same Adam step
        flat = mesh.psum_(torch.cat([*(g.reshape(-1) for g in g_mlp),
                                     loss.detach().reshape(1)]), "data")
        if active:
            for p, g in zip(params, flat[:-1].split([p.numel() for p in params])):
                p.grad = g.view_as(p)
            opt.step()
        return flat[-1], torch.sigmoid(logits.detach())

    def step(wide_l, emb_l, mlp, opt, batch, num_unique, active, push_seed=None):
        seed = _push_seed(push_seed, push_mode)
        if not multistep:
            return micro(wide_l, emb_l, mlp, opt, batch, int(num_unique), bool(active), seed)
        losses, probs = [], []
        for i, (b, u, act) in enumerate(zip(batch, num_unique, active)):
            if act:
                loss, p = micro(wide_l, emb_l, mlp, opt, b, int(u), True, seed + i)
            else:
                # inert on every data shard: an exact no-op in the JAX
                # program (zero gradients, Adam gated), and every rank knows
                # it from the host, so all of them skip it
                loss = torch.zeros((), device=mesh.device)
                p = torch.zeros(b["labels"].shape, device=mesh.device)
            losses.append(loss)
            probs.append(p)
        return torch.stack(losses), torch.stack(probs)

    return step


def make_wd_spmd_train_step(
    wide_up: Updater, emb_up: Updater, mesh, num_keys: int, push_mode: str = "per_worker"
):
    """The Wide&Deep step over the (data, kv) mesh, both tables range-
    sharded over the kv ranks, the MLP and Adam replicated.

    step(wide_l, emb_l, mlp, opt, batch, num_unique, active, push_seed=None)
    -> (the data group's loss sum, (B,) this shard's probabilities), the
    tables, the MLP and Adam updated in place. ``batch``: this rank's data
    shard's batch on the device (``data.batch.batch_to_device``);
    ``num_unique``: the largest ``num_unique`` of the microstep's D
    batches, the real prefix of unique keys pulled and pushed (the slots
    past a shard's own count are pads, key 0 with zero gradient, so this
    is the JAX step, which pushes them all); ``active``: whether any data
    shard has examples (Adam steps only then). Both are the same on every
    rank, and known on the host. ``quantized`` needs a per-call
    ``push_seed``."""
    return _make_wd_spmd(wide_up, emb_up, mesh, num_keys, push_mode, multistep=False)


def make_wd_spmd_train_multistep(
    wide_up: Updater, emb_up: Updater, mesh, num_keys: int, push_mode: str = "per_worker"
):
    """K Wide&Deep steps a call, one after another: ``batch``,
    ``num_unique`` and ``active`` are K-long sequences, and microstep i
    draws push seed ``push_seed + i``. Returns the (K,) loss sums and the
    (K, B) probabilities; a microstep inert on every data shard is
    skipped (loss 0, probabilities 0)."""
    return _make_wd_spmd(wide_up, emb_up, mesh, num_keys, push_mode, multistep=True)


def _inert_like(b: CSRBatch) -> CSRBatch:
    """The JAX app's pad of a partial group: b's shapes, every field zero
    (no example, no entry; slot 0, the pad key)."""
    return CSRBatch(**{f: np.zeros_like(getattr(b, f)) for f in
                       ("unique_keys", "local_ids", "row_ids", "values", "labels",
                        "example_mask", "row_splits")},
                    num_examples=0, num_unique=1, num_entries=0)


class WideDeep:
    """The Wide&Deep app: one hashed key space for the wide weights and
    the embeddings, on one device (``cuda`` unless the caller passes
    ``device="cpu"``), or, with ``mesh``, both tables range-sharded over
    its kv ranks on the mesh's device and the batch stream dealt over its
    data ranks (then every rank of the world runs the same calls:
    training, ``predict``/``evaluate``, ``state_dict``, ``load_state`` and
    ``dump_model`` are collective)."""

    def __init__(
        self,
        num_keys: int,
        emb_dim: int = 16,
        hidden: list[int] | None = None,
        ftrl_kw: dict | None = None,
        emb_eta: float = 0.1,
        mlp_lr: float = 1e-3,
        seed: int = 0,
        reporter: ProgressReporter | None = None,
        steps_per_call: int = 1,
        mesh=None,
        push_mode: str = "per_worker",
        max_delay: int = 0,
        device: Any = "cuda",
    ):
        if mesh is not None:
            _check_push_mode(push_mode)
        # K sequential steps per window entry: their losses are summed on
        # the device and read back once; report_every counts such groups
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
        self.num_keys = num_keys
        # on a mesh the table prints on rank 0; every rank keeps its history
        self.reporter = reporter or ProgressReporter(
            print_fn=print if mesh is None or mesh.rank == 0 else (lambda *_: None))
        self.steps_per_call = steps_per_call
        self.hidden = list(hidden or [32, 16])
        self.emb_dim = emb_dim
        self.mlp_lr = mlp_lr
        self.push_mode = push_mode  # inert on one device, as in the JAX app
        self.max_delay = max_delay  # SSP dispatch bound
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        self.wide_up = Ftrl(**(ftrl_kw or {"alpha": 0.1, "lambda_l1": 0.5}))
        self.emb_up = Adagrad(eta=emb_eta)
        # the JAX package's embedding draw (one float64 normal table, cast;
        # pad row 0 zeroed), made in row chunks on the host; on a mesh each
        # rank keeps its own rows
        rng = np.random.default_rng(seed)
        if mesh is None:
            self.wide_state = self.wide_up.init(num_keys, 1, device=self.device)
            w = normal_table(rng, num_keys, emb_dim, 0.05, self.device)
            w[0] = 0.0
        else:
            s = _shard_size(num_keys, mesh.kv)
            self.wide_state = self.wide_up.init(s, 1, device=self.device)
            w = normal_table(rng, num_keys, emb_dim, 0.05, self.device, mesh.k * s,
                             (mesh.k + 1) * s)
            if mesh.k == 0:
                w[0] = 0.0
            maker = make_wd_spmd_train_multistep if steps_per_call > 1 else make_wd_spmd_train_step
            self._spmd_step = maker(self.wide_up, self.emb_up, mesh, num_keys, push_mode)
        self.emb_state = {"w": w, "n": torch.zeros_like(w)}
        self._set_mlp(init_mlp(emb_dim, self.hidden, seed=seed))
        self.examples_seen = 0
        # quantized push: each call draws seeds call * K + i, so the
        # rounding noise never repeats
        self._push_calls = 0

    def _set_mlp(self, layers: list[dict[str, np.ndarray]]) -> None:
        """The MLP from numpy layers, with a fresh Adam (optax.adam's
        defaults: b1 0.9, b2 0.999, eps 1e-8, bias-corrected)."""
        self.mlp = MLP(layers, self.device)
        self.opt = torch.optim.Adam(self.mlp.parameters(), lr=self.mlp_lr)

    @classmethod
    def from_config(cls, cfg, mesh=None, reporter=None, device: Any = "cuda") -> "WideDeep":
        """Build the app from a PSConfig: wide half from [lr]/[penalty]
        FTRL fields, deep half from [wd], dispatch shape from [solver]."""
        return cls(
            num_keys=cfg.data.num_keys,
            emb_dim=cfg.wd.emb_dim,
            hidden=list(cfg.wd.hidden),
            ftrl_kw=dict(
                alpha=cfg.lr.alpha, beta=cfg.lr.beta,
                lambda_l1=cfg.penalty.lambda_l1,
                lambda_l2=cfg.penalty.lambda_l2,
            ),
            emb_eta=cfg.wd.emb_eta,
            mlp_lr=cfg.wd.mlp_lr,
            seed=cfg.seed,
            reporter=reporter,
            steps_per_call=cfg.solver.steps_per_call,
            mesh=mesh,
            push_mode=cfg.parallel.push_mode,
            max_delay=max(cfg.solver.max_delay, 0),
            device=device,
        )

    def state_dict(self) -> dict[str, Any]:
        """Host copies of both tables' state and the MLP layers, in the JAX
        package's layout (``wide_state``, ``emb_state``, ``mlp_params``;
        on a mesh the full tables of ``num_keys`` rows, gathered)."""
        if self.mesh is not None:
            return {"wide": unshard_state(self.wide_state, self.mesh, self.num_keys),
                    "emb": unshard_state(self.emb_state, self.mesh, self.num_keys),
                    "mlp": self.mlp.layers()}
        return {"wide": state_to_numpy(self.wide_state),
                "emb": state_to_numpy(self.emb_state),
                "mlp": self.mlp.layers()}

    def load_state(self, wide: dict[str, np.ndarray], emb: dict[str, np.ndarray],
                   mlp: list[dict[str, np.ndarray]]) -> None:
        """Replace both tables and the MLP with numpy state of the same
        layout (on a mesh the full tables: each rank keeps its slice); Adam
        starts fresh."""
        for name, have, new in (("wide", self.wide_state, wide), ("emb", self.emb_state, emb)):
            if self.mesh is not None:  # the full tables' shapes, not the slice's
                have = full_like(have, self.num_keys)
            check_state_like(name, have, new)
        have = self.mlp.layers()
        if len(mlp) != len(have) or any(
            set(new) != {"W", "b"} or any(np.shape(new[k]) != old[k].shape for k in old)
            for new, old in zip(mlp, have)
        ):
            raise ValueError("mlp layers do not match "
                             f"{[{k: v.shape for k, v in old.items()} for old in have]}")
        if self.mesh is not None:
            self.wide_state = shard_state(wide, self.mesh)
            self.emb_state = shard_state(emb, self.mesh)
        else:
            self.wide_state = state_from_numpy(wide, self.device)
            self.emb_state = state_from_numpy(emb, self.device)
        self._set_mlp(mlp)

    def _dispatch(self, chunk: list[CSRBatch]):
        """One window entry: up to K steps issued back to back. Returns
        (summed loss, (k, B) probabilities, metas), all unretired; metas
        align step k -> (num_examples, labels). A partial group is not
        padded: the JAX app's inert pad batches are exact no-ops."""
        if self.mesh is not None:
            return self._dispatch_mesh(chunk)
        loss, probs = None, []
        for b in chunk:
            step_loss, p = wd_train_step(
                self.wide_up, self.emb_up, self.wide_state, self.emb_state,
                self.mlp, self.opt, batch_to_device(b, self.device), b.num_examples,
                b.num_unique,
            )
            loss = step_loss if loss is None else loss + step_loss
            probs.append(p)
        metas = [(b.num_examples, b.labels[: b.num_examples]) for b in chunk]
        return loss, torch.stack(probs), metas

    def _dispatch_mesh(self, chunk: list[CSRBatch]):
        """``_dispatch`` on a mesh: ``chunk`` holds up to D*K batches of the
        pod's stream, batch k*D + d for data shard d of microstep k, and a
        partial group is padded with inert batches, as the JAX app deals
        them. Every rank sees the whole chunk, so it knows each
        microstep's real prefix and activity without a collective; it
        moves only its own shard's batches to the device. Returns the
        pod's summed loss, this shard's (K, B) probabilities, its metas."""
        D, d, K = self.mesh.data, self.mesh.d, self.steps_per_call
        full = chunk + [_inert_like(chunk[0])] * (D * K - len(chunk))
        batches, uniq, active, metas = [], [], [], []
        for k in range(K):
            group = full[k * D:(k + 1) * D]
            u = max(b.num_unique for b in group)
            mine = group[d]
            if len(mine.unique_keys) < u:  # bucketed capacities differ
                mine = dataclasses.replace(mine, unique_keys=zero_extend(mine.unique_keys, u))
            batches.append(batch_to_device(mine, self.device))
            uniq.append(u)
            active.append(any(b.num_examples for b in group))
            metas.append((mine.num_examples, mine.labels[: mine.num_examples]))
        seed = self._push_calls * K
        self._push_calls += 1
        if K == 1:
            loss, probs = self._spmd_step(self.wide_state, self.emb_state, self.mlp, self.opt,
                                          batches[0], uniq[0], active[0], seed)
            return loss, probs[None], metas
        losses, probs = self._spmd_step(self.wide_state, self.emb_state, self.mlp, self.opt,
                                        batches, uniq, active, seed)
        return losses.sum(), probs, metas

    def train(self, batches: Iterable[CSRBatch], report_every: int = 100) -> dict:
        """Train over a CSRBatch stream, ``steps_per_call`` steps a window
        entry. Dispatch is SSP-gated (``max_delay`` entries in flight;
        losses and probabilities are read back only on retirement).
        report_every counts window entries. On a mesh ``batches`` is the
        pod's whole stream, the same on every rank; each entry takes D*K
        batches of it."""
        window_p, window_y, losses = [], [], []
        n_since = 0
        t0 = time.perf_counter()
        last: dict = {}

        def _retire(step: int, entry) -> None:
            loss, probs, metas = entry
            losses.append(float(loss))
            p = probs.cpu().numpy()
            for k, (n_ex, lab) in enumerate(metas):
                if n_ex:
                    window_p.append(p[k, :n_ex])
                    window_y.append(lab)

        gate = DispatchWindow(self.max_delay, _retire)
        it = iter(batches)
        call_i = 0
        per_call = self.steps_per_call * (self.mesh.data if self.mesh is not None else 1)
        while True:
            chunk = list(itertools.islice(it, per_call))
            if not chunk:
                break
            gate.gate(call_i)
            gate.add(call_i, self._dispatch(chunk))
            n_group = sum(b.num_examples for b in chunk)
            self.examples_seen += n_group
            n_since += n_group
            call_i += 1
            if call_i % report_every == 0:
                gate.drain()
                last = self._flush(losses, window_p, window_y, n_since, t0)
                losses, window_p, window_y = [], [], []
                n_since, t0 = 0, time.perf_counter()
        gate.drain()
        if n_since:
            last = self._flush(losses, window_p, window_y, n_since, t0)
        return last

    def train_files(self, files: list[str], fmt: str, builder, epochs: int = 1,
                    report_every: int = 100) -> dict:
        """Streaming file-driven training: parse -> localize -> W&D step,
        per epoch. On a mesh every rank parses every file (the JAX app's
        one stream, dealt by ``train``)."""
        last: dict = {}
        for _ in range(max(1, epochs)):
            last = self.train(MinibatchReader(files, fmt, builder),
                              report_every=report_every) or last
        return last

    def evaluate_files(self, files: list[str], fmt: str, builder) -> dict:
        return self.evaluate(MinibatchReader(files, fmt, builder))

    def dump_model(self, path: str) -> str:
        """Dump the inference weights as an npz with the JAX package's keys:
        derived wide weights, embedding table, MLP layers. On a mesh the
        tables are gathered (every rank calls it) as the JAX app's sharded
        tables hold them, zero-padded to the kv multiple, and rank 0
        writes."""
        if self.mesh is None:
            host = {
                "wide_w": self.wide_up.weights(self.wide_state).cpu().numpy(),
                "emb_w": self.emb_up.weights(self.emb_state).cpu().numpy(),
            }
        else:
            wide = unshard_state(self.wide_state, self.mesh)
            host = {
                "wide_w": self.wide_up.weights(
                    {k: torch.from_numpy(v) for k, v in wide.items()}).numpy(),
                "emb_w": unshard_state(self.emb_state, self.mesh)["w"],
            }
            if self.mesh.rank != 0:
                return path
        for i, layer in enumerate(self.mlp.layers()):
            host[f"mlp_W{i}"] = layer["W"]
            host[f"mlp_b{i}"] = layer["b"]
        np.savez(path, **host)
        return path

    def _flush(self, losses, window_p, window_y, n_since, t0):
        p = np.concatenate(window_p) if window_p else np.zeros(0)
        y = np.concatenate(window_y) if window_y else np.zeros(0)
        if self.mesh is not None:
            # the AUC over every data shard: the ranks of kv column 0 send
            # their shards' labels and probabilities (the host-side group)
            parts = [x for x in self.mesh.all_gather_object(
                (y, p) if self.mesh.k == 0 else None) if x is not None]
            y = np.concatenate([x[0] for x in parts])
            p = np.concatenate([x[1] for x in parts])
        return self.reporter.report(
            examples=self.examples_seen,
            objv=float(sum(losses)) / max(n_since, 1),
            auc=M.auc(y, p) if len(y) else float("nan"),
            ex_per_sec=n_since / max(time.perf_counter() - t0, 1e-9),
        )

    def predict(self, batches: Iterable[CSRBatch]) -> tuple[np.ndarray, np.ndarray]:
        """Returns (labels, probabilities) over the stream (on a mesh the
        rows are pulled through the kv group; collective)."""
        if self.mesh is None:
            return _predict(
                batches, self.device, self.mlp,
                lambda idx: self.wide_up.weights(
                    {k: v.index_select(0, idx) for k, v in self.wide_state.items()}),
                lambda idx: self.emb_state["w"].index_select(0, idx),
            )
        s = _shard_size(self.num_keys, self.mesh.kv)
        return _predict(batches, self.device, self.mlp,
                        lambda idx: pull(self.wide_up, self.wide_state, idx, s, self.mesh),
                        lambda idx: pull(self.emb_up, self.emb_state, idx, s, self.mesh))

    def evaluate(self, batches: Iterable[CSRBatch]) -> dict:
        y, p = self.predict(batches)
        return {"auc": M.auc(y, p), "logloss": M.logloss(y, p), "examples": len(y)}


def _predict(batches, device, mlp: MLP, wide_rows, emb_rows):
    ys, ps = [], []
    with torch.no_grad():
        for b in batches:
            dev = batch_to_device(b, device)
            idx = dev["unique_keys"]
            _, logits = _forward(wide_rows(idx), emb_rows(idx), mlp, dev)
            ps.append(torch.sigmoid(logits)[: b.num_examples].cpu().numpy())
            ys.append(b.labels[: b.num_examples])
    return np.concatenate(ys), np.concatenate(ps)


def evaluate_dump(model_path: str, files: list[str], fmt: str, builder,
                  device: Any = "cuda") -> dict:
    """Evaluate a ``WideDeep.dump_model`` npz (either package's) over
    files: the CLI ``evaluate`` path for app wide_deep."""
    dev = resolve_device(device)
    d = np.load(model_path)
    wide_w = torch.from_numpy(d["wide_w"]).to(dev)
    emb_w = torch.from_numpy(d["emb_w"]).to(dev)
    layers = []
    while f"mlp_W{len(layers)}" in d:
        i = len(layers)
        layers.append({"W": d[f"mlp_W{i}"], "b": d[f"mlp_b{i}"]})
    y, p = _predict(
        MinibatchReader(files, fmt, builder), dev, MLP(layers, dev),
        lambda idx: wide_w.index_select(0, idx), lambda idx: emb_w.index_select(0, idx),
    )
    return {"auc": M.auc(y, p), "logloss": M.logloss(y, p), "examples": len(y)}
