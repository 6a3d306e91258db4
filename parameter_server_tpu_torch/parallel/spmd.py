"""SPMD pull/push: the parameter server's wire protocol as collectives.

The port of the JAX package's ``parallel/spmd.py``. The JAX step is one
``shard_map`` program over the (data, kv) device mesh; here every rank of
the world runs this module's step on its own cell (``parallel/mesh.py``):

  pull  — a masked gather of the batch's keys against this rank's
          contiguous kv range, then a sum over the kv group (keys of other
          shards contribute zero);
  push  — ``per_worker``: the D data shards' (keys, grads) are gathered
          over the data group and each kv shard applies them one after
          another, in data-index order, each as its own updater step (the
          JAX ``lax.scan``), given ``keys - begin``, through the store's
          ``push`` (FTRL through K1, AdaGrad through K3) or, when the
          caller's ids may repeat (``unique=False``, word2vec), its
          ``push_repeated``; the store skips the rows of other shards;
          ``aggregate``: one dense (S, vdim) buffer of this shard's range
          and a touched count, summed over the data group, then ONE updater
          step over the whole shard (FTRL on the card: K2 over S rows),
          applied only where a row was touched;
          ``quantized``: ``per_worker`` with int8 gradients on the wire.

State: every table is this rank's (S, vdim) slice, rows ``[k*S, (k+1)*S)``
of the table zero-padded to ``padded_num_keys``; pad rows past the real
``num_keys`` are never touched. The steps update it IN PLACE, as the
port's store does (the JAX steps donate it). A batch is this rank's own
data shard's batch; the kv ranks of one data row feed the same batch.

The quantized push cannot reproduce ``jax.random``: its uniforms come from
a ``torch.Generator`` per (push seed, data index, stream) (see
``push_generator``), so it agrees with the JAX push in distribution, not
bit for bit.
"""

from __future__ import annotations

from typing import Any

import numpy as np
import torch

from parameter_server_tpu_torch.kv import store as kv_store
from parameter_server_tpu_torch.kv.updaters import Updater
from parameter_server_tpu_torch.ops.sparse import csr_grad, csr_logits, logistic_loss
from parameter_server_tpu_torch.parallel.mesh import Mesh
from parameter_server_tpu_torch.utils.hashing import splitmix64

State = dict[str, torch.Tensor]
Batch = dict[str, torch.Tensor]

PUSH_MODES = ("per_worker", "aggregate", "quantized")


def padded_num_keys(num_keys: int, kv_size: int) -> int:
    """``num_keys`` rounded up to the next multiple of the kv axis size —
    the table rows the sharded tier allocates. The rows past the real
    ``num_keys`` are pad rows: exactly zero and never touched."""
    if num_keys < 1:
        raise ValueError(f"num_keys must be >= 1, got {num_keys}")
    return -(-num_keys // kv_size) * kv_size


def _shard_size(num_keys: int, kv_size: int) -> int:
    return padded_num_keys(num_keys, kv_size) // kv_size


def shard_state(state: dict[str, Any], mesh: Mesh) -> State:
    """This rank's kv slice of a full host state (numpy arrays or
    tensors), its tables first zero-padded to the next kv multiple."""
    rows = next(iter(state.values())).shape[0]
    s = _shard_size(rows, mesh.kv)
    out = {}
    for name, v in state.items():
        v = torch.as_tensor(np.asarray(v))
        piece = v[mesh.k * s : (mesh.k + 1) * s]
        if piece.shape[0] < s:
            piece = torch.cat([piece, piece.new_zeros((s - piece.shape[0], *v.shape[1:]))])
        out[name] = piece.contiguous().to(mesh.device)
    return out


def unshard_state(state: State, mesh: Mesh, rows: int | None = None) -> dict[str, np.ndarray]:
    """The FULL tables on every rank of this data row, gathered over its kv
    group, as host arrays (the first ``rows`` rows: the real ones, without
    the kv pad). Collective: every rank calls it."""
    out = {}
    for name, t in state.items():
        full = mesh.all_gather(t, "kv").reshape(-1, *t.shape[1:])
        out[name] = full[:rows].cpu().numpy()
    return out


# ---------------------------------------------------------------------------
# host-side batch fields (the JAX package's helpers, numpy only)
# ---------------------------------------------------------------------------


CSR_FULL_FIELDS = (
    "unique_keys", "local_ids", "row_ids", "values", "labels", "example_mask",
)
# Compact wire format: row structure rides as (B+1,) row_splits instead of
# (NNZ,) row_ids; the step rebuilds row ids with one searchsorted
CSR_COMPACT_FIELDS = (
    "unique_keys", "local_ids", "row_splits", "values", "labels", "example_mask",
)

_F16_MAX = 65504.0  # largest finite float16


def batch_arrays(b, compact: bool = False, values_f16: bool = False) -> dict[str, np.ndarray]:
    """The wire fields of one CSR batch (this rank's data shard's): the
    JAX package's ``stack_batches`` without its leading data axis, since a
    rank feeds one shard. ``values_f16`` (the data.wire_values "f16" knob)
    clips the values to the finite float16 range and casts them; the step
    casts them back (``_values_of``)."""
    fields = CSR_COMPACT_FIELDS if compact else CSR_FULL_FIELDS
    out = {f: getattr(b, f) for f in fields}
    if values_f16:
        out["values"] = np.clip(out["values"], -_F16_MAX, _F16_MAX).astype(np.float16)
    return out


def stack_step_groups(items: list[dict]) -> dict[str, np.ndarray]:
    """Stack K steps' ``batch_arrays`` into one (K, ...) multistep group,
    each field first zero-padded to the group max on its trailing axis."""
    from parameter_server_tpu_torch.data.batch import zero_extend

    targets = {f: max(d[f].shape[-1] for d in items) for f in items[0]}
    return {
        f: np.stack([zero_extend(d[f], targets[f], axis=-1) for d in items])
        for f in items[0]
    }


def _row_ids_of(b: Batch) -> torch.Tensor:
    """Entry -> example-row ids: the full wire format's row_ids, or one
    searchsorted over the compact format's (B+1,) row_splits. Padded
    entries (value 0) clamp to the last row and stay inert."""
    if "row_ids" in b:
        return b["row_ids"]
    nnz = b["values"].shape[0]
    num_rows = b["labels"].shape[0]
    e = torch.arange(nnz, dtype=torch.int64, device=b["values"].device)
    r = torch.searchsorted(b["row_splits"].long(), e, right=True) - 1
    return torch.clamp(r, 0, num_rows - 1)


def _values_of(b: Batch) -> torch.Tensor:
    v = b["values"]
    return v.float() if v.dtype != torch.float32 else v


# ---------------------------------------------------------------------------
# pull and push on this rank's kv shard
# ---------------------------------------------------------------------------


def _local_pull(
    updater: Updater, state_l: State, idx: torch.Tensor, shard_size: int, begin: int
) -> torch.Tensor:
    """This shard's contribution to the pulled weights of global ids
    ``idx``: (U, vdim), zero for the keys of other shards."""
    local = idx.long() - begin
    in_range = (local >= 0) & (local < shard_size)
    safe = torch.where(in_range, local, 0)
    rows = {k: v.index_select(0, safe) for k, v in state_l.items()}
    return torch.where(in_range[:, None], updater.weights(rows), 0.0)


def pull(
    updater: Updater, state_l: State, idx: torch.Tensor, shard_size: int, mesh: Mesh
) -> torch.Tensor:
    """The pulled weights of global ids ``idx``, (U, vdim): every shard's
    masked gather summed over this rank's kv group. Collective."""
    return mesh.psum_(_local_pull(updater, state_l, idx, shard_size, mesh.k * shard_size),
                      "kv")


def full_like(state_l: State, rows: int) -> dict[str, torch.Tensor]:
    """Shape-only (meta) tensors of the full tables of ``rows`` rows whose
    kv slice is ``state_l``: what an app's ``load_state`` on a mesh holds
    the full host tables to before each rank takes its slice."""
    return {k: v.new_empty((rows, *v.shape[1:]), device="meta") for k, v in state_l.items()}


def _local_index(idx: torch.Tensor, begin: int, shard_size: int) -> torch.Tensor:
    """Global ids as int32 rows of this shard; every key of another shard
    lands on -1 or ``shard_size``, which the fused pushes skip."""
    return torch.clamp(idx.long() - begin, -1, shard_size).to(torch.int32)


def _push_one(
    updater: Updater, state_l: State, idx: torch.Tensor, g: torch.Tensor,
    begin: int, shard_size: int, unique: bool = True,
) -> None:
    """One worker's push into this shard, in place (``unique``: see
    ``_local_push``)."""
    push = kv_store.push if unique else kv_store.push_repeated
    push(updater, state_l, _local_index(idx, begin, shard_size), g)


def _local_push(
    updater: Updater, state_l: State, all_idx: torch.Tensor, all_grad: torch.Tensor,
    begin: int, shard_size: int, unique: bool = True,
) -> State:
    """Apply every worker's push to this kv shard, one after another in
    data-index order (each worker's push is its own updater step).
    ``all_idx`` (D, U) global ids, ``all_grad`` (D, U, vdim).

    ``unique`` states the contract of each worker's ids. True: a key at
    most once in a worker's push, but for zero-gradient pad slots (a
    batch's unique keys); FTRL and AdaGrad then push through the fused
    kernels K1 and K3, which take each key at most once and store with
    plain stores, no atomics (``csrc/adagrad.cu:60-63``). False: ids may
    repeat (word2vec's centers, contexts and negatives); every updater
    then gathers the rows, takes one delta per occurrence from the same
    pulled row and ``index_add_``s the deltas, the JAX push's function,
    and no kernel runs (``kv.store.push_repeated``). The caller states
    which holds: nothing checks."""
    for j in range(all_idx.shape[0]):
        _push_one(updater, state_l, all_idx[j], all_grad[j], begin, shard_size, unique)
    return state_l


def _local_push_aggregate(
    updater: Updater, state_l: State, idx: torch.Tensor, grad: torch.Tensor,
    shard_size: int, mesh: Mesh,
) -> State:
    """Aggregate-then-update push: every data shard scatters its grads into
    a dense buffer of this shard's range, one sum over the data group
    pre-sums them, and the updater applies ONE step over the shard, kept
    only on the touched rows (untouched rows keep their bits). Exactly
    ``per_worker`` for a linear delta (SGD without L2); standard
    synchronous aggregation otherwise."""
    begin = mesh.k * shard_size
    local = idx.long() - begin
    in_range = (local >= 0) & (local < shard_size)
    safe = torch.where(in_range, local, 0)
    mask = in_range[:, None].to(grad.dtype)
    vdim = grad.shape[-1]
    g_slice = torch.zeros((shard_size, vdim), dtype=grad.dtype, device=grad.device)
    g_slice.index_add_(0, safe, mask * grad)
    touched = torch.zeros((shard_size, 1), dtype=grad.dtype, device=grad.device)
    touched.index_add_(0, safe, mask)
    mesh.psum_(g_slice, "data")
    mesh.psum_(touched, "data")
    deltas = updater.delta(state_l, g_slice)
    hit = (touched > 0).to(grad.dtype)
    for k, v in state_l.items():
        v.add_(hit * deltas[k])
    return state_l


_M63 = (1 << 63) - 1


def push_generator(
    push_seed: int, data_index: int, stream: int, device: torch.device
) -> torch.Generator:
    """The uniforms of data shard ``data_index``'s quantized push at
    ``push_seed`` on sub-stream ``stream`` (0 for a one-table app): a
    ``torch.Generator`` on ``device`` seeded with
    splitmix64(splitmix64(splitmix64(push_seed) ^ data_index) ^ stream),
    63 bits. Every kv rank of a data row draws the same stream, so each
    worker's push is quantized once; neighbouring seeds, data indices and
    streams draw unrelated streams. (The JAX push folds the same three
    into a ``jax.random`` key, which torch cannot reproduce.)"""
    h = np.uint64(push_seed & ((1 << 64) - 1))
    for salt in (data_index, stream):
        h = splitmix64(np.array([h], dtype=np.uint64))[0] ^ np.uint64(salt)
    seed = int(splitmix64(np.array([h], dtype=np.uint64))[0]) & _M63
    return torch.Generator(device=device).manual_seed(seed)


def int8_scale(grad: torch.Tensor) -> torch.Tensor:
    """max|g| * float32(1/127) + 1e-30, the reference as it runs: the JAX
    push divides by the constant 127 inside a jitted step, and XLA folds
    that division into a product with the float32 reciprocal (the
    compiled HLO is ``multiply(reduce_max, constant)``), which is one ulp
    from the quotient for some maxima. The reciprocal is a float32 tensor
    on the gradient's device, so the product rounds once, the same bits on
    the CPU and on the card."""
    top = grad.abs().max()
    r = torch.full((), np.float32(1.0 / 127.0), dtype=top.dtype, device=top.device)
    return top * r + 1e-30


def quantize_int8(
    grad: torch.Tensor, generator: torch.Generator
) -> tuple[torch.Tensor, torch.Tensor]:
    """Symmetric int8 with one scale and stochastic (unbiased) rounding, as
    the JAX quantized push: scale = max|g| / 127 + 1e-30, t = g / scale,
    q = floor(t) + (u < t - floor(t)), clipped to [-127, 127]."""
    scale = int8_scale(grad)
    t = grad / scale
    floor = torch.floor(t)
    u = torch.rand(grad.shape, generator=generator, device=grad.device)
    q = floor + (u < (t - floor)).to(grad.dtype)
    return torch.clamp(q, -127, 127).to(torch.int8), scale


def audit_rounding(audit: dict, grad: torch.Tensor, q: torch.Tensor,
                   scale: torch.Tensor) -> None:
    """Hold one quantized push to its rounding bounds, as this rank's data
    shard's gradient came back from the gather: the scale must be
    max|g| / 127 + 1e-30 and every q floor(t) or floor(t) + 1 of
    t = g / scale. Adds to ``audit``'s "pushes" (an int), "off_grid" and
    "scale_mismatch" (device counts, read when the run ends, so the audit
    adds no host sync)."""
    want = int8_scale(grad)
    fl = torch.floor(grad / want)
    qf = q.to(grad.dtype)
    off = ((qf != fl) & (qf != fl + 1)).sum()
    audit["pushes"] = audit.get("pushes", 0) + 1
    audit["off_grid"] = audit.get("off_grid", 0) + off
    audit["scale_mismatch"] = audit.get("scale_mismatch", 0) + (scale != want).long()


def _local_push_quantized(
    updater: Updater, state_l: State, idx: torch.Tensor, grad: torch.Tensor,
    shard_size: int, mesh: Mesh, push_seed: int, stream: int = 0,
) -> State:
    """``per_worker`` push with int8 gradients on the wire: each data shard
    quantizes its gradient (``quantize_int8``), the gathers move 1 byte a
    value, and the gradients are decoded after the gather, so the server
    semantics stay ``_local_push``'s."""
    gen = push_generator(push_seed, mesh.d, stream, grad.device)
    q, scale = quantize_int8(grad, gen)
    all_idx = mesh.all_gather(idx, "data")  # (D, U)
    all_q = mesh.all_gather(q, "data")  # (D, U, vdim) int8
    all_scale = mesh.all_gather(scale.reshape(1), "data")  # (D, 1)
    if mesh.quant_audit is not None:
        audit_rounding(mesh.quant_audit, grad, all_q[mesh.d], all_scale[mesh.d, 0])
    all_grad = all_q.to(grad.dtype) * all_scale[:, :, None]
    return _local_push(updater, state_l, all_idx, all_grad, mesh.k * shard_size,
                       shard_size)


# ---------------------------------------------------------------------------
# the steps
# ---------------------------------------------------------------------------


def _check_push_mode(push_mode: str) -> None:
    if push_mode not in PUSH_MODES:
        raise ValueError(f"unknown push_mode {push_mode!r}; known: {PUSH_MODES}")


def _push_seed(push_seed, push_mode: str) -> int:
    """The push_seed contract of every step maker: a seed that varies per
    step, required in quantized mode, 0 by default otherwise."""
    if push_seed is None:
        if push_mode == "quantized":
            # a defaulted seed would reuse the same uniforms every step,
            # correlating the rounding noise instead of averaging it out
            raise ValueError(
                "quantized push mode requires a per-step push_seed: "
                "pass the step's index as push_seed"
            )
        return 0
    return int(push_seed)


def _wrap_stepper(step, push_mode: str):
    """``step(state, batch, push_seed=None)`` over the single- and
    multi-step makers' ``step(state, batch, push_seed)``."""

    def stepper(state: State, batch: Batch, push_seed=None):
        return step(state, batch, _push_seed(push_seed, push_mode))

    return stepper


def _microstep(
    updater: Updater, state_l: State, b: Batch, mesh: Mesh, shard_size: int,
    push_mode: str, push_seed: int,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One parameter-server step on this rank: pull -> CSR grad -> push,
    in place on ``state_l``. Returns (data-group loss sum, data-group
    example count, this shard's probabilities)."""
    begin = mesh.k * shard_size
    idx = b["unique_keys"]
    row_ids = _row_ids_of(b)
    values = _values_of(b)
    w_u = pull(updater, state_l, idx, shard_size, mesh)
    logits = csr_logits(
        w_u, values, b["local_ids"], row_ids, num_rows=b["labels"].shape[0]
    )
    loss, err = logistic_loss(logits, b["labels"], b["example_mask"])
    g = csr_grad(err, values, b["local_ids"], row_ids, num_unique=idx.shape[0])
    if push_mode == "aggregate":
        _local_push_aggregate(updater, state_l, idx, g, shard_size, mesh)
    elif push_mode == "quantized":
        _local_push_quantized(updater, state_l, idx, g, shard_size, mesh, push_seed)
    else:
        all_idx = mesh.all_gather(idx, "data")  # (D, U)
        all_grad = mesh.all_gather(g, "data")  # (D, U, vdim)
        _local_push(updater, state_l, all_idx, all_grad, begin, shard_size)
    # the data group's loss and real-example count in one sum: the count is
    # the pod-wide termination signal (a drained rank keeps feeding inert
    # batches; every rank stops after retiring a step that counts 0)
    sums = torch.stack([loss, b["example_mask"].sum().to(loss.dtype)])
    mesh.psum_(sums, "data")
    return sums[0], sums[1], torch.sigmoid(logits)


def make_spmd_train_step(
    updater: Updater, mesh: Mesh, num_keys: int, push_mode: str = "per_worker"
):
    """This rank's train step over the mesh.

    step(state, batch, push_seed=None) -> (state, out), state updated in
    place, with out keys:
      "loss_sum" — the data group's loss sum (every rank of the pod holds it)
      "examples" — the pod's real-example count (the termination signal)
      "probs"    — (B,) this shard's probabilities
    """
    _check_push_mode(push_mode)
    shard_size = _shard_size(num_keys, mesh.kv)

    def step(state: State, batch: Batch, push_seed: int):
        loss, ex, probs = _microstep(
            updater, state, batch, mesh, shard_size, push_mode, push_seed
        )
        return state, {"loss_sum": loss, "examples": ex, "probs": probs}

    return _wrap_stepper(step, push_mode)


def make_spmd_train_multistep(
    updater: Updater, mesh: Mesh, num_keys: int, push_mode: str = "per_worker"
):
    """K parameter-server steps per call, run one after another (microstep
    i + 1 pulls weights that include microstep i's push). Batch fields are
    stacked (K, ...); microstep i draws push seed ``push_seed + i``.
    out: "loss_sum" (K,), "examples" (K,), "probs" (K, B)."""
    _check_push_mode(push_mode)
    shard_size = _shard_size(num_keys, mesh.kv)

    def step(state: State, batch: Batch, push_seed: int):
        outs = [
            _microstep(updater, state, {k: v[i] for k, v in batch.items()}, mesh,
                       shard_size, push_mode, push_seed + i)
            for i in range(batch["labels"].shape[0])
        ]
        losses, exs, probs = (torch.stack(t) for t in zip(*outs))
        return state, {"loss_sum": losses, "examples": exs, "probs": probs}

    return _wrap_stepper(step, push_mode)


def make_spmd_predict_step(updater: Updater, mesh: Mesh, num_keys: int):
    """predict(state, batch) -> (B,) this shard's probabilities."""
    shard_size = _shard_size(num_keys, mesh.kv)

    def predict(state: State, batch: Batch) -> torch.Tensor:
        idx = batch["unique_keys"]
        w_u = pull(updater, state, idx, shard_size, mesh)
        logits = csr_logits(
            w_u, _values_of(batch), batch["local_ids"], _row_ids_of(batch),
            num_rows=batch["labels"].shape[0],
        )
        return torch.sigmoid(logits)

    return predict
