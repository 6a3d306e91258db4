"""DARLIN: delayed block proximal gradient for L1 logistic regression.

Reference analog: src/app/linear_method/darlin.* / batch_solver.* — the
reference's batch solver:

  reference                                this module
  ---------                                -----------
  SlotReader column-block cache            ColumnBlocks (data/blockcache.py):
                                             entries sorted by feature
                                             block, padded to one per-block
                                             width, stacked (n_blocks, E)
  worker keeps prediction vector Xw        pred (N,) on the device, updated
                                             incrementally per block
  per-block grad + diag-Hessian push       segment sums (sorted, in one
                                             order every run) over the
                                             block's entries
  server proximal (soft-threshold) step    _prox_newton_direction
  KKT filter active-set bitmap             active (K,) bool; inactive
                                             zero coordinates get d == 0
  bounded-delay block pipelining           groups of delay+1 blocks compute
                                             their gradients against the
                                             same stale pred

A pass is a Python loop over the blocks that only enqueues device work:
the block order, each block's key range and the delay groups are host
integers, the line search's step and the violation maximum stay device
scalars, and the host reads the device once a pass (the objective and
nnz(w)), as the JAX package's one ``lax.scan`` a pass does.

On a mesh (``parallel/mesh.py``: one process a (data, kv) cell) every rank
holds its data shard's examples (pred, labels, mask and its slice of each
block's entries) and its kv range of w and active; the reduction over
example shards is a sum over the data group, the owner's w/active slice
reaches the other kv ranks as a masked sum over the kv group.
"""

from __future__ import annotations

from collections.abc import Callable, Iterable, Sequence
from typing import Any

import numpy as np
import torch

from parameter_server_tpu_torch.data.batch import CSRBatch
from parameter_server_tpu_torch.data.blockcache import ColumnBlocks
from parameter_server_tpu_torch.device import resolve_device
from parameter_server_tpu_torch.models import metrics as M
from parameter_server_tpu_torch.utils.config import PSConfig
from parameter_server_tpu_torch.utils.metrics import ProgressReporter

__all__ = [
    "ColumnBlocks",
    "Darlin",
    "DarlinSpmdFns",
    "darlin_pass",
    "make_darlin_spmd_fns",
    "shard_blocks_for_mesh",
    "shard_examples_for_mesh",
]

#: the line search's step scales: 1, 1/2, ..., 1/128 (exact in float32)
ALPHAS = tuple(0.5**t for t in range(8))
_BLOCK_ARRAYS = ("feat_local", "rows", "values")


# ---------------------------------------------------------------------------
# Per-block coordinate math, shared by the single-device and mesh solvers:
# the 2e-4 trajectory contract between them depends on the formulas living
# in one place. The mesh solver passes its sum over example shards in as
# ``reduce`` (identity on one device).
# ---------------------------------------------------------------------------


def _identity(x: torch.Tensor) -> torch.Tensor:
    return x


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as ``logaddexp(x, 0)``, the JAX package's softplus
    (torch's ``softplus`` returns x itself above its threshold)."""
    return torch.logaddexp(x, torch.zeros_like(x))


# _segment_sum's lanes an id on the card, and the most partial sums it keeps
SEGMENT_LANES, SEGMENT_PARTIALS = 1024, 1 << 22


def _segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """Sum ``x`` by ``ids`` into ``n`` slots, in one order every run: on
    the CPU ``index_add_`` (one pass in entry order), on the card
    :func:`_lane_segment_sum`."""
    if x.is_cuda:
        return _lane_segment_sum(x, ids, n)
    return torch.zeros(n, dtype=x.dtype, device=x.device).index_add_(0, ids, x)


def _lane_segment_sum(x: torch.Tensor, ids: torch.Tensor, n: int) -> torch.Tensor:
    """The card's segment sum, without atomics.

    The atomic adds of ``index_add_`` on the card sum a hot key's entries
    in another order each run, and a reordered sum can flip a coordinate
    across the KKT filter, so two solves on the same data would part.
    ``index_put_`` with ``accumulate`` sorts its indices and sums each
    index's entries in their order, but in sequence, so an id's entries
    are first dealt by position over ``lanes`` partials (SEGMENT_LANES,
    fewer where n x lanes would pass SEGMENT_PARTIALS), whose (n, lanes)
    sum is one fixed reduction. The lanes depend on n alone, so entries
    past the last real one (zeros) leave the sums exactly as they were."""
    lanes = max(1, min(SEGMENT_LANES, SEGMENT_PARTIALS // max(n, 1)))
    key = ids.long() * lanes + torch.arange(x.shape[0], device=x.device) % lanes
    part = torch.zeros(n * lanes, dtype=x.dtype, device=x.device)
    part.index_put_((key,), x, accumulate=True)
    return part.view(n, lanes).sum(1)


def _alphas(device) -> torch.Tensor:
    return torch.tensor(ALPHAS, dtype=torch.float32, device=device)


def _kkt_viol(w_b: torch.Tensor, g: torch.Tensor, lambda_l1: float) -> torch.Tensor:
    """KKT violation per coordinate (ref: the filter score deciding the
    active set)."""
    return torch.where(
        w_b != 0.0,
        (g + torch.sign(w_b) * lambda_l1).abs(),
        torch.clamp_min(g.abs() - lambda_l1, 0.0),
    )


def _prox_newton_direction(
    w_b: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    skip: torch.Tensor,
    lambda_l1: float,
    lambda_l2: float,
    learning_rate: float,
) -> torch.Tensor:
    """Proximal Newton direction per coordinate (diagonal model):
    z = w*h - eta*g ; d = soft_threshold(z, eta*lambda_l1)/h - w."""
    h_safe = h + lambda_l2 + 1e-6
    z = w_b * h_safe - learning_rate * g
    w_cand = (
        torch.sign(z)
        * torch.clamp_min(z.abs() - learning_rate * lambda_l1, 0.0)
        / h_safe
    )
    return torch.where(skip, torch.zeros_like(w_cand), w_cand - w_b)


def _line_search_alpha(
    pred: torch.Tensor,
    Xd: torch.Tensor,
    y: torch.Tensor,
    w_b: torch.Tensor,
    d: torch.Tensor,
    lambda_l1: float,
    lambda_l2: float,
    mask: torch.Tensor | None = None,
    reduce: Callable[[torch.Tensor], torch.Tensor] = _identity,
    alphas: torch.Tensor | None = None,
) -> torch.Tensor:
    """The step scale, a device scalar: the TRUE objective at 8 geometric
    step scales, the best of them if it beats the current point, else 0.
    ``reduce`` sums the 8 + 1 nll sums over example shards (one call)."""
    if alphas is None:
        alphas = _alphas(pred.device)
    zs = pred[None, :] + alphas[:, None] * Xd[None, :]  # (T, N)
    terms = _softplus(zs) - y[None, :] * zs
    terms0 = _softplus(pred) - y * pred
    if mask is not None:
        terms = terms * mask[None, :]
        terms0 = terms0 * mask
    nll = reduce(torch.cat([terms.sum(dim=1), terms0.sum().reshape(1)]))
    wa = w_b[None, :] + alphas[:, None] * d[None, :]  # (T, block)
    reg = lambda_l1 * wa.abs().sum(dim=1) + 0.5 * lambda_l2 * (wa * wa).sum(dim=1)
    obj_a = nll[:8] + reg
    obj_0 = (
        nll[8]
        + lambda_l1 * w_b.abs().sum()
        + 0.5 * lambda_l2 * (w_b * w_b).sum()
    )
    best_obj, best = torch.min(obj_a, dim=0)  # first index on ties, as argmin
    alpha = alphas.index_select(0, best.reshape(1))[0]
    return torch.where(best_obj < obj_0, alpha, torch.zeros_like(alpha))


def _block_grad(
    pred: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor | None,
    fl: torch.Tensor,
    rows: torch.Tensor,
    vals: torch.Tensor,
    block_size: int,
) -> tuple[torch.Tensor, torch.Tensor]:
    """This example shard's gradient and diagonal Hessian over the block's
    coordinates."""
    p = torch.sigmoid(pred)
    err = p - y
    h_ex = p * (1.0 - p)
    if mask is not None:
        err = err * mask
        h_ex = h_ex * mask
    g = _segment_sum(vals * err.index_select(0, rows), fl, block_size)
    h = _segment_sum(vals * vals * h_ex.index_select(0, rows), fl, block_size)
    return g, h


def _block_update(
    w_b: torch.Tensor,
    act_b: torch.Tensor,
    g: torch.Tensor,
    h: torch.Tensor,
    pred: torch.Tensor,
    y: torch.Tensor,
    mask: torch.Tensor | None,
    fl: torch.Tensor,
    rows: torch.Tensor,
    vals: torch.Tensor,
    hyper: tuple[float, float, float],
    reduce: Callable[[torch.Tensor], torch.Tensor],
    alphas: torch.Tensor,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """One block's proximal step from its (reduced) g and h: returns the
    block's new weights, the new pred and the block's largest violation."""
    lambda_l1, lambda_l2, learning_rate = hyper
    viol = _kkt_viol(w_b, g, lambda_l1).max()
    # inactive zero-weight coords with tiny gradient are skipped
    skip = (~act_b) & (w_b == 0.0)
    d = _prox_newton_direction(w_b, g, h, skip, lambda_l1, lambda_l2, learning_rate)
    Xd = _segment_sum(vals * d.index_select(0, fl), rows, pred.shape[0])
    alpha = _line_search_alpha(
        pred, Xd, y, w_b, d, lambda_l1, lambda_l2, mask=mask, reduce=reduce, alphas=alphas
    )
    # incremental prediction update: pred += alpha * X_b @ d (ref: Xw)
    return w_b + alpha * d, pred + alpha * Xd, viol


@torch.no_grad()
def darlin_pass(
    w: torch.Tensor,  # (K,)
    pred: torch.Tensor,  # (N,)
    active: torch.Tensor,  # (K,) bool — KKT active set
    blocks: dict,  # (n_blocks, E) stacked block arrays [+ "extent"]
    order: Sequence[int],  # the pass's block order
    labels: torch.Tensor,
    lambda_l1: float,
    lambda_l2: float,
    learning_rate: float,
    block_size: int,
    delay: int = 0,
) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """One pass over the blocks in ``order``. Returns (w, pred, active,
    viol_max); ``w`` is updated in place. ``blocks["extent"]``, where
    given, is each block's ``block_extents``.

    ``delay`` > 0 reproduces the reference's bounded-delay pipelining: the
    gradient of the t-th block is computed against the prediction vector
    as of block t - (t mod (delay+1)), i.e. groups of delay+1 consecutive
    blocks all read the same stale pred."""
    alphas = _alphas(w.device)
    hyper = (lambda_l1, lambda_l2, learning_rate)
    viol_max = torch.zeros((), dtype=torch.float32, device=w.device)
    stale = pred
    for i, b in enumerate(order):
        if i % (delay + 1) == 0:  # refresh the stale snapshot
            stale = pred
        fl, rows, vals = _block(blocks, int(b))
        begin = int(b) * block_size
        g, h = _block_grad(stale, labels, None, fl, rows, vals, block_size)
        new_w_b, pred, viol = _block_update(
            w[begin : begin + block_size], active[begin : begin + block_size], g, h,
            pred, labels, None, fl, rows, vals, hyper, _identity, alphas,
        )
        viol_max = torch.maximum(viol_max, viol)
        w[begin : begin + block_size] = new_w_b
    return w, pred, active, viol_max


def _objective(
    w: torch.Tensor, pred: torch.Tensor, labels: torch.Tensor, lambda_l1: float,
    lambda_l2: float,
) -> torch.Tensor:
    nll = (_softplus(pred) - labels * pred).sum()
    return nll + lambda_l1 * w.abs().sum() + 0.5 * lambda_l2 * (w * w).sum()


def _kkt_threshold(viol_max: torch.Tensor, kkt_filter_threshold: float) -> torch.Tensor:
    """threshold * max(viol_max, 1e-12) in float64, rounded to float32, on
    the device (the JAX solvers compute it on the host)."""
    return (viol_max.double().clamp_min(1e-12) * kkt_filter_threshold).float()


def _host_scalars(*xs: torch.Tensor) -> list[float]:
    """Device scalars to host floats in one read."""
    return torch.stack([x.double() for x in xs]).tolist()


def block_extents(values: np.ndarray) -> list[int]:
    """Per block (a row of ``values``), the count of its entries up to its
    last nonzero value. The pads past it (value 0 at local feature 0 and
    row 0, up to the widest block's count) add nothing to any sum, but
    summed into that one slot and that one row they serialize the card's
    atomic adds, so the passes take each block's entries up to here."""
    nz = np.asarray(values) != 0
    last = nz.shape[1] - np.argmax(nz[:, ::-1], axis=1)
    return np.where(nz.any(axis=1), last, 0).tolist()


def _block(blocks: dict, i: int) -> tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Block ``i``'s (feat_local, rows, values), up to its extent where
    ``blocks`` has them."""
    n = blocks["extent"][i] if "extent" in blocks else None
    return tuple(blocks[k][i][:n] for k in _BLOCK_ARRAYS)


def _to_device(a: np.ndarray, device) -> torch.Tensor:
    # a copy: the cache's arrays are read-only memory maps
    return torch.tensor(np.asarray(a), device=device)


# ---------------------------------------------------------------------------
# Distributed DARLIN over the (data, kv) mesh
#
# Reference analog (SURVEY §3.3): workers hold example shards (their column
# blocks + their slice of the prediction vector Xw), servers hold the weight
# by key range. Per block: each worker computes its shard's gradient /
# diag-Hessian contribution (push == sum over the data group), the owning
# kv range's w/active slice is pulled by every kv rank (a masked sum over
# the kv group), every rank takes the same proximal step and updates its Xw
# slice, and the owner stores the block's new weights.
# ---------------------------------------------------------------------------


def shard_examples_for_mesh(cb: ColumnBlocks, data_shards: int) -> dict:
    """(labels, mask) reshaped to (D, per) — examples padded to D * per."""
    D = data_shards
    N = cb.num_examples
    per = -(-N // D)
    labels = np.zeros(D * per, dtype=np.float32)
    mask = np.zeros(D * per, dtype=np.float32)
    labels[:N] = np.asarray(cb.labels, dtype=np.float32)
    mask[:N] = 1.0
    return {
        "labels": labels.reshape(D, per),
        "mask": mask.reshape(D, per),
        "per_shard_examples": per,
    }


def shard_blocks_for_mesh(
    cb: ColumnBlocks,
    data_shards: int,
    blocks: np.ndarray | None = None,
    pad_pow2: bool = False,
) -> dict:
    """Host-side prep: partition block entries by example shard — fully
    vectorized (one argsort over the selected entries; no per-block Python
    loops). A copy of the JAX package's function.

    blocks: optional subset/order of block indices to pack. The streaming
      solver packs one chunk at a time straight from the (possibly mmap'd)
      block cache, so only the chunk's rows are ever read into RAM.
    pad_pow2: round the entry width E up to a power of two.

    Returns numpy arrays:
      feat_local/rows/values: (B, D, E) with rows LOCAL to the shard and
        E = the max per-(block, shard) entry count of THIS selection
      block_idx: (B,) absolute block ids; counts: (B, D) real entry counts
    (labels/mask come from ``shard_examples_for_mesh``.)
    """
    D = data_shards
    N = cb.num_examples
    per = -(-N // D)  # ceil: examples padded to D * per
    sel = (
        np.arange(cb.n_blocks, dtype=np.int64)
        if blocks is None
        else np.asarray(blocks, dtype=np.int64)
    )
    B = len(sel)
    # fancy-index (mmap-friendly: reads only the selected blocks' rows)
    feat_src = np.asarray(cb.feat_local[sel])
    rows_src = np.asarray(cb.rows[sel])
    vals_src = np.asarray(cb.values[sel])
    E_src = feat_src.shape[1]
    s = rows_src // per  # (B, E_src) example shard per entry (contiguous
    # ranges); cb pad entries (value == 0) sit at row 0 => shard 0, inert
    key = (
        np.arange(B, dtype=np.int64)[:, None] * D + s
    ).ravel()  # group = (block, shard)
    order = np.argsort(key, kind="stable")
    k_sorted = key[order]
    counts = np.bincount(key, minlength=B * D)
    starts = np.zeros(B * D + 1, dtype=np.int64)
    np.cumsum(counts, out=starts[1:])
    pos = np.arange(B * E_src, dtype=np.int64) - starts[k_sorted]
    E = max(1, int(counts.max()))
    if pad_pow2:
        E = 1 << (E - 1).bit_length()
    feat = np.zeros((B * D, E), dtype=feat_src.dtype)
    rows = np.zeros((B * D, E), dtype=rows_src.dtype)
    vals = np.zeros((B * D, E), dtype=vals_src.dtype)
    local_rows = rows_src - s * per  # localize BEFORE packing: packed
    # padding slots stay 0 (a valid inert local row), never negative
    feat[k_sorted, pos] = feat_src.ravel()[order]
    rows[k_sorted, pos] = local_rows.ravel()[order]
    vals[k_sorted, pos] = vals_src.ravel()[order]
    return {
        "feat_local": feat.reshape(B, D, E),
        "rows": rows.reshape(B, D, E),
        "values": vals.reshape(B, D, E),
        "block_idx": sel.astype(np.int32),
        "counts": counts.reshape(B, D),
        "per_shard_examples": per,
    }


class DarlinSpmdFns:
    """The distributed solver's programs on this rank's mesh cell.

    pass_blocks / kkt_blocks — a pass, or the KKT refresh, over this
      rank's resident (n_blocks, E) slices, put on the device once per
      solve and indexed through the pass's permutation, or over a streamed
      chunk of blocks handed in as its own (C, E) slices with their
      ``block_idx``.
    obj, nnz — mesh-wide objective and nnz(w); place / place_blocks — this
      rank's slice of host arrays, on its device.

    Every rank issues the same collectives in the same order: a block's
    sum of (g, h) over the data group, the owner's (w, active) slice summed
    over the kv group, the line search's 9 sums over the data group. The
    KKT refresh needs g on the owner's kv column only, so only that
    column's data group sums it; the other columns skip the block whole.
    Sums over an axis of size 1 are skipped on every rank alike.
    """

    def __init__(
        self,
        mesh,
        *,
        num_keys: int,
        block_size: int,
        per_shard_examples: int,
        lambda_l1: float,
        lambda_l2: float,
        learning_rate: float,
        delay: int,
    ):
        kv = mesh.shape["kv"]
        if num_keys % kv:
            raise ValueError(f"num_keys {num_keys} not divisible by kv={kv}")
        shard_size = num_keys // kv
        if shard_size % block_size:
            raise ValueError(
                f"kv range {shard_size} not aligned to block_size {block_size}: "
                "each feature block must live wholly on one kv shard"
            )
        self.mesh = mesh
        self.block_size = block_size
        self.shard_size = shard_size
        self.hyper = (lambda_l1, lambda_l2, learning_rate)
        self.delay = delay
        self.alphas = _alphas(mesh.device)

    def _psum(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        if self.mesh.shape[axis] == 1:
            return t
        return self.mesh.psum_(t, axis)

    def _owner(self, b: int) -> tuple[bool, int]:
        """(this rank owns block b, the block's offset in its kv range)."""
        begin = b * self.block_size
        owner = begin // self.shard_size
        return owner == self.mesh.k, begin - owner * self.shard_size

    def _pass(self, w_l, pred_l, active_l, blocks_l, positions, block_ids, y_l, mask_l):
        bs = self.block_size
        viol_max = torch.zeros((), dtype=torch.float32, device=w_l.device)
        stale = pred_l
        for i, (pos, b) in enumerate(zip(positions, block_ids)):
            if i % (self.delay + 1) == 0:
                stale = pred_l
            fl, rows, vals = _block(blocks_l, pos)
            is_owner, lo = self._owner(int(b))
            g, h = _block_grad(stale, y_l, mask_l, fl, rows, vals, bs)
            gh = self._psum(torch.stack([g, h]), "data")  # push
            # pull: the owner's (w, active) slice, zeros elsewhere, summed
            wa = torch.zeros((2, bs), dtype=torch.float32, device=w_l.device)
            if is_owner:
                wa[0] = w_l[lo : lo + bs]
                wa[1] = active_l[lo : lo + bs].float()
            wa = self._psum(wa, "kv")
            new_w_b, pred_l, viol = _block_update(
                wa[0], wa[1] > 0, gh[0], gh[1], pred_l, y_l, mask_l, fl, rows, vals,
                self.hyper, lambda x: self._psum(x, "data"), self.alphas,
            )
            viol_max = torch.maximum(viol_max, viol)
            if is_owner:
                w_l[lo : lo + bs] = new_w_b
        return w_l, pred_l, viol_max

    def _kkt(self, active_l, w_l, pred_l, blocks_l, positions, block_ids, y_l, mask_l, thr):
        bs = self.block_size
        for pos, b in zip(positions, block_ids):
            is_owner, lo = self._owner(int(b))
            if not is_owner:  # the whole kv column skips it alike
                continue
            fl, rows, vals = _block(blocks_l, pos)
            g, _ = _block_grad(pred_l, y_l, mask_l, fl, rows, vals, bs)
            g = self._psum(g, "data")
            w_b = w_l[lo : lo + bs]
            active_l[lo : lo + bs] = (w_b != 0.0) | (_kkt_viol(w_b, g, self.hyper[0]) > thr)
        return active_l

    @staticmethod
    def _walk(blocks_l: dict, order) -> tuple[Sequence[int], list[int]]:
        """(positions in ``blocks_l``, block ids) of a pass: resident slices
        in ``order``, or a streamed chunk (``order`` None) in its own."""
        if order is None:
            ids = [int(b) for b in blocks_l["block_idx"]]
            return range(len(ids)), ids
        order = [int(b) for b in order]
        return order, order

    @torch.no_grad()
    def pass_blocks(self, w_l, pred_l, active_l, blocks_l, order, y_l, mask_l):
        """One pass (or one streamed chunk of it); returns (w_l, pred_l,
        viol_max)."""
        return self._pass(w_l, pred_l, active_l, blocks_l, *self._walk(blocks_l, order),
                          y_l, mask_l)

    @torch.no_grad()
    def kkt_blocks(self, w_l, pred_l, active_l, blocks_l, order, y_l, mask_l, thr):
        """The KKT refresh of the active set over the same blocks."""
        return self._kkt(active_l, w_l, pred_l, blocks_l, *self._walk(blocks_l, order),
                         y_l, mask_l, thr)

    @torch.no_grad()
    def obj(self, w_l, pred_l, y_l, mask_l) -> torch.Tensor:
        lambda_l1, lambda_l2, _ = self.hyper
        nll = self._psum((mask_l * (_softplus(pred_l) - y_l * pred_l)).sum().reshape(1),
                         "data")
        reg = self._psum(
            (lambda_l1 * w_l.abs().sum() + 0.5 * lambda_l2 * (w_l * w_l).sum()).reshape(1),
            "kv",
        )
        return (nll + reg)[0]

    def nnz(self, w_l) -> torch.Tensor:
        return self._psum(torch.count_nonzero(w_l).reshape(1), "kv")[0]

    def place(self, name: str, arr: np.ndarray) -> torch.Tensor:
        """This rank's slice of a full host array: its kv range of w and
        active, its data shard's row of pred, labels and mask."""
        m = self.mesh
        if name in ("w", "active"):
            arr = arr[m.k * self.shard_size : (m.k + 1) * self.shard_size]
        elif name in ("pred", "labels", "mask"):
            arr = arr[m.d]
        else:
            raise ValueError(f"unknown solver array {name!r}")
        return _to_device(arr, m.device)

    def place_blocks(self, sharded: dict, with_idx: bool) -> dict:
        """This rank's data shard's (B, E) slices of packed (B, D, E) block
        arrays (``shard_blocks_for_mesh``), on its device, with their
        ``block_extents``."""
        local = {k: np.ascontiguousarray(sharded[k][:, self.mesh.d]) for k in _BLOCK_ARRAYS}
        out: dict[str, Any] = {k: _to_device(v, self.mesh.device) for k, v in local.items()}
        out["extent"] = block_extents(local["values"])
        if with_idx:
            out["block_idx"] = np.asarray(sharded["block_idx"])
        return out


def make_darlin_spmd_fns(
    mesh,
    *,
    num_keys: int,
    block_size: int,
    per_shard_examples: int,
    lambda_l1: float,
    lambda_l2: float,
    learning_rate: float,
    delay: int,
) -> DarlinSpmdFns:
    """The solver's programs on ``mesh`` (see DarlinSpmdFns). Requires
    num_keys divisible by kv and every block wholly inside one kv range.
    ``per_shard_examples`` keeps the JAX function's signature: the programs
    read it off the pred slice they are given."""
    return DarlinSpmdFns(
        mesh, num_keys=num_keys, block_size=block_size,
        per_shard_examples=per_shard_examples, lambda_l1=lambda_l1,
        lambda_l2=lambda_l2, learning_rate=learning_rate, delay=delay,
    )


class Darlin:
    """Batch L1-LR solver app (scheduler role of the reference's Darlin*),
    on one device (``cuda`` unless the caller passes ``device="cpu"``).

    With ``mesh`` (this rank's cell of a (data, kv) mesh) the solver runs
    distributed on the mesh's device: example shards over "data", weight
    ranges over "kv" — the reference's worker/server split (SURVEY §3.3).
    Then every rank of the world makes the same calls."""

    def __init__(
        self,
        cfg: PSConfig,
        reporter: ProgressReporter | None = None,
        mesh=None,
        device: Any = "cuda",
    ):
        self.cfg = cfg
        self.reporter = reporter or ProgressReporter()
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)

    def fit(self, batches: list[CSRBatch], shuffle_blocks: bool = True) -> dict:
        cb = ColumnBlocks.from_batches(
            batches, self.cfg.data.num_keys, self.cfg.solver.feature_blocks
        )
        return self.fit_blocks(cb, shuffle_blocks=shuffle_blocks)

    def fit_blocks(self, cb: ColumnBlocks, shuffle_blocks: bool = True) -> dict:
        if self.mesh is not None:
            return self._fit_blocks_spmd(cb, shuffle_blocks=shuffle_blocks)
        return self._fit_blocks_single(cb, shuffle_blocks=shuffle_blocks)

    def _delay(self) -> int:
        return self.cfg.solver.max_delay if self.cfg.solver.max_delay > 0 else 0

    def _report(self, n: int, obj: float, nnz: int, history: list, prev_obj: float,
                it: int) -> bool:
        """Report a pass; True when the relative gain fell below epsilon."""
        rel = (prev_obj - obj) / max(abs(prev_obj), 1e-12)
        self.reporter.report(examples=n, objv=obj / n, nnz_w=nnz, auc=float("nan"))
        history.append(obj)
        return 0 <= rel < self.cfg.solver.epsilon and it > 0

    def _result(self, cb: ColumnBlocks, history: list) -> dict:
        probs = 1.0 / (1.0 + np.exp(-self.pred))
        return {
            "objv": history[-1] / cb.num_examples,
            "iters": len(history),
            "nnz_w": int((self.w != 0).sum()),
            "train_auc": M.auc(cb.labels, probs),
            "history": history,
        }

    @torch.no_grad()
    def _fit_blocks_spmd(self, cb: ColumnBlocks, shuffle_blocks: bool = True) -> dict:
        """Distributed solve over the mesh (see the module section above).

        Two data-residency modes (cfg.solver.block_chunk):
          0 (default) — resident: this rank's slices of the packed
            (n_blocks, D, E) entry arrays go to the device ONCE; the
            per-iteration block shuffle is an order the pass indexes by.
          C > 0 — streaming: each pass packs and uploads C blocks at a time
            straight from the (possibly mmap'd) block cache, so device and
            host memory hold one chunk, not the dataset. Chunk widths pad to
            powers of two, as the JAX solver pads them. With delay > 0 the
            stale snapshot refreshes at chunk boundaries (pick C a multiple
            of delay+1 to keep parity with the resident mode).
        """
        cfg, mesh = self.cfg, self.mesh
        D = mesh.shape["data"]
        chunk = cfg.solver.block_chunk
        ex = shard_examples_for_mesh(cb, D)
        fns = make_darlin_spmd_fns(
            mesh,
            num_keys=cb.num_keys,
            block_size=cb.block_size,
            per_shard_examples=ex["per_shard_examples"],
            lambda_l1=cfg.penalty.lambda_l1,
            lambda_l2=cfg.penalty.lambda_l2,
            learning_rate=cfg.lr.eta,
            delay=self._delay(),
        )
        w = fns.place("w", np.zeros(cb.num_keys, np.float32))
        active = fns.place("active", np.ones(cb.num_keys, bool))
        pred = fns.place("pred", np.zeros_like(ex["labels"]))
        labels = fns.place("labels", ex["labels"])
        mask = fns.place("mask", ex["mask"])
        rng = np.random.default_rng(cfg.seed)

        resident = None
        if chunk <= 0:
            resident = fns.place_blocks(shard_blocks_for_mesh(cb, D), with_idx=False)

        def blocks_of(order):
            """A pass's blocks: the resident slices in ``order``, or the
            order's chunks, each packed and uploaded as it comes."""
            if resident is not None:
                yield resident, order
                return
            for lo in range(0, len(order), chunk):
                yield fns.place_blocks(
                    shard_blocks_for_mesh(cb, D, blocks=order[lo : lo + chunk], pad_pow2=True),
                    with_idx=True,
                ), None

        prev_obj = _host_scalars(fns.obj(w, pred, labels, mask))[0]
        history: list[float] = []
        for it in range(cfg.solver.block_iters):
            order = (
                rng.permutation(cb.n_blocks) if shuffle_blocks else np.arange(cb.n_blocks)
            )
            viol = torch.zeros((), dtype=torch.float32, device=w.device)
            for blk, o in blocks_of(order):
                w, pred, v = fns.pass_blocks(w, pred, active, blk, o, labels, mask)
                viol = torch.maximum(viol, v)
            if cfg.solver.kkt_filter_threshold > 0:
                thr = _kkt_threshold(viol, cfg.solver.kkt_filter_threshold)
                for blk, o in blocks_of(order):
                    active = fns.kkt_blocks(w, pred, active, blk, o, labels, mask, thr)
            obj, nnz = _host_scalars(fns.obj(w, pred, labels, mask), fns.nnz(w))
            if self._report(cb.num_examples, obj, int(nnz), history, prev_obj, it):
                break
            prev_obj = obj

        self.w = _gather(mesh, w, "kv").cpu().numpy()
        real = ex["mask"].ravel() > 0
        self.pred = _gather(mesh, pred, "data").cpu().numpy()[real]
        return self._result(cb, history)

    @torch.no_grad()
    def _fit_blocks_single(self, cb: ColumnBlocks, shuffle_blocks: bool = True) -> dict:
        """Run the solver on prebuilt (possibly disk-cached) column blocks.

        The JAX solver uploads the blocks in each pass's order every pass;
        here they go to the device once, and each pass indexes them through
        its permutation: the same arithmetic in the same block order."""
        cfg = self.cfg
        dev = self.device
        K, N = cb.num_keys, cb.num_examples
        l1, l2 = cfg.penalty.lambda_l1, cfg.penalty.lambda_l2
        w = torch.zeros(K, dtype=torch.float32, device=dev)
        pred = torch.zeros(N, dtype=torch.float32, device=dev)
        active = torch.ones(K, dtype=torch.bool, device=dev)
        labels = _to_device(cb.labels, dev)
        blocks = {k: _to_device(getattr(cb, k), dev) for k in _BLOCK_ARRAYS}
        blocks["extent"] = block_extents(cb.values)
        rng = np.random.default_rng(cfg.seed)

        prev_obj = _host_scalars(_objective(w, pred, labels, l1, l2))[0]
        history: list[float] = []
        for it in range(cfg.solver.block_iters):
            order = (
                rng.permutation(cb.n_blocks) if shuffle_blocks else np.arange(cb.n_blocks)
            )  # ref: randomized block order per iteration
            w, pred, active, viol = darlin_pass(
                w, pred, active, blocks, order, labels, l1, l2, cfg.lr.eta,
                block_size=cb.block_size, delay=self._delay(),
            )
            if cfg.solver.kkt_filter_threshold > 0:
                # refresh the active set from the violation scale (ref: the
                # KKT filter's adaptive threshold)
                active = self._kkt_active(w, pred, labels, blocks, cb.block_size, viol)
            obj, nnz = _host_scalars(_objective(w, pred, labels, l1, l2),
                                     torch.count_nonzero(w))
            if self._report(N, obj, int(nnz), history, prev_obj, it):
                break
            prev_obj = obj

        self.w = w.cpu().numpy()
        self.pred = pred.cpu().numpy()
        return self._result(cb, history)

    def _kkt_active(self, w, pred, labels, blocks: dict, block_size: int,
                    viol_max: torch.Tensor) -> torch.Tensor:
        """Recompute the active bitmap: keep coords with weight, or with
        gradient violation above threshold * max violation."""
        thr = _kkt_threshold(viol_max, self.cfg.solver.kkt_filter_threshold)
        err = torch.sigmoid(pred) - labels
        g = torch.empty_like(w)
        for i in range(blocks["values"].shape[0]):
            fl, rows, vals = _block(blocks, i)
            g[i * block_size : (i + 1) * block_size] = _segment_sum(
                vals * err.index_select(0, rows), fl, block_size)
        return (w != 0.0) | (_kkt_viol(w, g, self.cfg.penalty.lambda_l1) > thr)

    @torch.no_grad()
    def predict(self, batches: Iterable[CSRBatch]) -> np.ndarray:
        from parameter_server_tpu_torch.models.linear import batch_to_device
        from parameter_server_tpu_torch.ops.sparse import csr_logits

        out = []
        w = _to_device(self.w, self.device)
        for b in batches:
            dev = batch_to_device(b, self.device)
            logits = csr_logits(
                w.index_select(0, dev["unique_keys"]), dev["values"], dev["local_ids"],
                dev["row_ids"], num_rows=dev["labels"].shape[0],
            )
            out.append(torch.sigmoid(logits).cpu().numpy()[: b.num_examples])
        return np.concatenate(out)


def _gather(mesh, t: torch.Tensor, axis: str) -> torch.Tensor:
    """The full array from this rank's slice along ``axis`` (collective on
    that axis's group)."""
    if mesh.shape[axis] == 1:
        return t.reshape(-1)
    return mesh.all_gather(t, axis).reshape(-1)
