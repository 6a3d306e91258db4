"""word2vec skip-gram with negative sampling (SGNS) over the KV store.

The port of the JAX package's ``models/word2vec.py``, on one device. The
input and output embedding tables are AdaGrad KV tables with
``vdim = dim``; a step batch is (center, context, K negatives) id arrays,
the negatives pre-sampled on the host from the unigram^0.75 distribution.

A step gathers the touched rows of both tables once (``pull_rows``),
derives the weights from them, and pushes each table's gradients through
the store's ``push_repeated``, handing it those rows, IN PLACE: every
occurrence's AdaGrad delta from its pulled row, ``index_add_``ed. A batch
repeats hot ids, and the JAX step scatter-adds one delta per occurrence;
the fused AdaGrad push kernel takes each key at most once, and coalescing
first would change the function (AdaGrad is not linear in g), so the step
launches no hand-written kernel. The data side (sampler, window pairs,
token blocks, the streaming ``PairStream``) is host numpy copied from the
JAX package, so both draw the same batches.

On a mesh (``parallel/mesh.py``) each rank holds its kv slice of both
tables and feeds its data shard's pairs: pulls are masked gathers summed
over the kv group; ``per_worker`` gathers every shard's ids and gradients
over the data group and applies them one shard after another through the
SPMD push's route for repeated ids (``_local_push(..., unique=False)``:
gather, one delta an occurrence, ``index_add_``; never K3), and
``aggregate`` sums the gradients over the data group before one AdaGrad
step. ``train_epoch`` draws every shard's negatives from the one sampler,
in shard order, as the JAX loop does; ``train_files`` runs one
``PairStream`` a data shard over its own file shard, and a drained rank
feeds inert batches until a step counts no pair pod-wide.
"""

from __future__ import annotations

import contextlib
import time
from typing import Any

import numpy as np
import torch

from parameter_server_tpu_torch.data.pipeline import PrefetchPipeline
from parameter_server_tpu_torch.device import resolve_device
from parameter_server_tpu_torch.kv import store as kv_store
from parameter_server_tpu_torch.kv.store import (
    State,
    check_state_like,
    state_from_numpy,
    state_to_numpy,
)
from parameter_server_tpu_torch.kv.updaters import Adagrad, Updater
from parameter_server_tpu_torch.parallel.spmd import (
    _local_push,
    _local_push_aggregate,
    _shard_size,
    full_like,
    pull,
    shard_state,
    unshard_state,
)
from parameter_server_tpu_torch.parallel.ssp import DispatchWindow
from parameter_server_tpu_torch.parallel.workload import WorkloadPool
from parameter_server_tpu_torch.utils.metrics import ProgressReporter


def _softplus(x: torch.Tensor) -> torch.Tensor:
    """log(1 + e^x) as logaddexp(x, 0), as jax.nn.softplus."""
    return torch.logaddexp(x, torch.zeros_like(x))


def _sgns_weights_math(u, v_flat, B: int, K: int, mask=None):
    """SGNS loss and gradients from materialized weights.

    loss: -log sig(pos) - sum log sig(-neg), in softplus form.
    mask: optional (B,) float; padded pairs get zero loss and zero
    gradient, so their (id 0) rows are never moved."""
    v_all = v_flat.reshape(B, 1 + K, -1)  # (B, 1+K, d)
    logits = torch.einsum("bd,bkd->bk", u, v_all)  # (B, 1+K)
    labels = torch.zeros_like(logits)
    labels[:, 0] = 1.0
    terms = _softplus(logits) - labels * logits
    err = torch.sigmoid(logits) - labels
    if mask is not None:
        terms = terms * mask[:, None]
        err = err * mask[:, None]
    loss = torch.sum(terms)
    g_u = torch.einsum("bk,bkd->bd", err, v_all)  # (B, d)
    g_v = (err[:, :, None] * u[:, None, :]).reshape(B * (1 + K), -1)
    return loss, g_u, g_v


def sgns_train_step(
    in_up: Updater,
    out_up: Updater,
    in_state: State,
    out_state: State,
    batch: dict[str, torch.Tensor],  # center (B,), context (B,), negatives (B, K)
) -> torch.Tensor:
    """One SGNS step, IN PLACE on both tables; returns the step's summed
    loss as a device scalar. Each occurrence of an id computes its delta
    from the same pulled row, and the deltas are scatter-added: the JAX
    step's within-step semantics for duplicate ids."""
    center, context, negatives = batch["center"], batch["context"], batch["negatives"]
    B, K = negatives.shape
    out_ids = torch.cat([context[:, None], negatives], dim=1).reshape(-1)
    in_rows = kv_store.pull_rows(in_state, center)
    out_rows = kv_store.pull_rows(out_state, out_ids)
    loss, g_u, g_v = _sgns_weights_math(
        in_up.weights(in_rows), out_up.weights(out_rows), B, K, mask=batch.get("mask"),
    )
    # the tables share no tensor: the first push leaves out_rows as pulled
    kv_store.push_repeated(in_up, in_state, center, g_u, rows=in_rows)
    kv_store.push_repeated(out_up, out_state, out_ids, g_v, rows=out_rows)
    return loss


W2V_PUSH_MODES = ("per_worker", "aggregate")


def _make_w2v_spmd(
    in_up: Updater, out_up: Updater, mesh, vocab_size: int, push_mode: str,
    multistep: bool,
):
    """The SGNS step on this rank's mesh cell, one microstep or K stacked
    (K, ...) ones (see the two makers below)."""
    if push_mode not in W2V_PUSH_MODES:
        raise ValueError(f"unknown push_mode {push_mode!r}")
    shard_size = _shard_size(vocab_size, mesh.kv)
    begin = mesh.k * shard_size

    def micro(in_l: State, out_l: State, b: dict) -> torch.Tensor:
        center, context, negatives = b["center"], b["context"], b["negatives"]
        B, K = negatives.shape
        out_ids = torch.cat([context[:, None], negatives], dim=1).reshape(-1)
        loss, g_u, g_v = _sgns_weights_math(
            pull(in_up, in_l, center, shard_size, mesh),
            pull(out_up, out_l, out_ids, shard_size, mesh), B, K,
            mask=b.get("mask"),
        )
        if push_mode == "aggregate":
            # the dense buffers' scatter sums repeated ids before the one
            # update, as the JAX push does
            _local_push_aggregate(in_up, in_l, center, g_u, shard_size, mesh)
            _local_push_aggregate(out_up, out_l, out_ids, g_v, shard_size, mesh)
        else:
            # ids repeat within a shard's batch and across shards: each
            # occurrence's delta from the same pulled row, scatter-added
            _local_push(in_up, in_l, mesh.all_gather(center, "data"),
                        mesh.all_gather(g_u, "data"), begin, shard_size, unique=False)
            _local_push(out_up, out_l, mesh.all_gather(out_ids, "data"),
                        mesh.all_gather(g_v, "data"), begin, shard_size, unique=False)
        pairs = b["mask"].sum() if "mask" in b else loss.new_tensor(float(B))
        return torch.stack([loss, pairs])

    def step(in_state: State, out_state: State, batch: dict):
        if multistep:
            sums = sum(micro(in_state, out_state, {k: v[i] for k, v in batch.items()})
                       for i in range(batch["center"].shape[0]))
        else:
            sums = micro(in_state, out_state, batch)
        return in_state, out_state, mesh.psum_(sums, "data")

    return step


def make_w2v_spmd_train_step(
    in_up: Updater, out_up: Updater, mesh, vocab_size: int, push_mode: str = "per_worker"
):
    """The SGNS step over the (data, kv) mesh: both tables range-sharded
    over the kv ranks, pair batches over the data ranks.

    step(in_state, out_state, batch) -> (in_state, out_state, sums), the
    tables updated in place; ``batch`` this rank's data shard's
    (center (B,), context (B,), negatives (B, K)[, mask (B,)]) on the
    device; ``sums`` (2,): the data group's loss sum and real-pair count
    (the drained signal of ``train_files``). ``aggregate`` pre-sums the
    gradients over the data group and applies ONE AdaGrad step (standard
    synchronous aggregation: another trajectory than ``per_worker``)."""
    return _make_w2v_spmd(in_up, out_up, mesh, vocab_size, push_mode, multistep=False)


def make_w2v_spmd_train_multistep(
    in_up: Updater, out_up: Updater, mesh, vocab_size: int, push_mode: str = "per_worker"
):
    """K SGNS steps a call, one after another: batch fields stacked
    (K, ...); ``sums`` summed over the microsteps."""
    return _make_w2v_spmd(in_up, out_up, mesh, vocab_size, push_mode, multistep=True)


def _group_microbatches(items: list[dict], k_steps: int) -> dict:
    """Stack up to K per-microstep host batch dicts on a new leading
    microstep axis. A ones mask is added where absent, and a partial final
    group is padded with all-zero microsteps: mask 0 makes them inert."""
    items = [
        dict(b, mask=b.get("mask", np.ones_like(b["center"], dtype=np.float32)))
        for b in items
    ]
    if len(items) < k_steps:
        pad = {k: np.zeros_like(v) for k, v in items[0].items()}
        items = items + [pad] * (k_steps - len(items))
    return {k: np.stack([b[k] for b in items]) for k in items[0]}


class NegativeSampler:
    """unigram^0.75 sampler: inverse-CDF via searchsorted."""

    def __init__(self, counts: np.ndarray, power: float = 0.75, seed: int = 0):
        p = np.asarray(counts, dtype=np.float64) ** power
        self.p = p / p.sum()
        self._cdf = np.cumsum(self.p)
        self._cdf[-1] = 1.0
        self.rng = np.random.default_rng(seed)

    def sample(self, shape) -> np.ndarray:
        u = self.rng.random(size=shape)
        return np.searchsorted(self._cdf, u, side="right")

    def sample_shard(self, shape, shards: int, index: int) -> np.ndarray:
        """Shard ``index`` of ``shards`` consecutive ``sample(shape)``
        draws: the uniforms of all of them are drawn (``random`` fills
        sequentially, so one (shards, *shape) draw equals ``shards`` draws
        of ``shape``), and only this shard's are looked up."""
        u = self.rng.random(size=(shards, *shape))[index]
        return np.searchsorted(self._cdf, u, side="right")


# ---------------------------------------------------------------------------
# The streaming corpus path: skip-gram pairs are never materialized for the
# whole corpus. Token files flow through a WorkloadPool; each worker stream
# reads blocks of tokens, windows them into pairs, block-shuffles, and emits
# fixed-size batches, so host memory is bounded by one block's pairs.
# ---------------------------------------------------------------------------


def _window_pairs(
    tokens: np.ndarray, window: int, skip_prefix: int = 0
) -> tuple[np.ndarray, np.ndarray]:
    """(center, context) pairs within ``window``; with skip_prefix = W,
    pairs whose LATER token falls inside the first W tokens are dropped —
    the cross-block carry: prepend the previous block's last W tokens,
    and boundary-crossing pairs appear exactly once."""
    cs, xs = [], []
    for off in range(1, window + 1):
        a, b = tokens[:-off], tokens[off:]  # pair i: (i, i + off)
        lo = max(0, skip_prefix - off)  # keep i + off >= skip_prefix
        cs.append(a[lo:])
        xs.append(b[lo:])
        cs.append(b[lo:])
        xs.append(a[lo:])
    if not cs:
        z = np.zeros(0, dtype=tokens.dtype)
        return z, z
    return np.concatenate(cs), np.concatenate(xs)


def iter_token_blocks(path: str, block_tokens: int = 1 << 20):
    """Stream int token-id blocks from a corpus file: ``.npy`` arrays are
    mmap'd and sliced; anything else is whitespace-separated integer text
    read in bounded chunks (partial tokens carried across chunk reads)."""
    if str(path).endswith(".npy"):
        arr = np.load(path, mmap_mode="r")
        for lo in range(0, len(arr), block_tokens):
            yield np.asarray(arr[lo : lo + block_tokens], dtype=np.int64)
        return
    carry = b""
    pending: list[np.ndarray] = []
    n_pending = 0
    with open(path, "rb") as f:
        while True:
            chunk = f.read(1 << 22)
            if not chunk:
                break
            chunk = carry + chunk
            cut = max(chunk.rfind(b" "), chunk.rfind(b"\n"), chunk.rfind(b"\t"))
            if cut < 0:
                carry = chunk
                continue
            carry = chunk[cut + 1 :]
            toks = chunk[:cut].split()
            if toks:
                pending.append(np.array(toks, dtype=np.int64))
                n_pending += len(pending[-1])
            if n_pending >= block_tokens:
                # concatenate once per read chunk and yield fixed-offset
                # slices
                flat = np.concatenate(pending)
                usable = len(flat) // block_tokens * block_tokens
                for off in range(0, usable, block_tokens):
                    yield flat[off : off + block_tokens]
                rest = flat[usable:]
                pending, n_pending = ([rest], len(rest)) if len(rest) else ([], 0)
    if carry.strip():
        pending.append(np.array([int(carry)], dtype=np.int64))
        n_pending += 1
    if n_pending:
        yield np.concatenate(pending)


def count_vocab(
    files: list[str], vocab_size: int, block_tokens: int = 1 << 20
) -> np.ndarray:
    """Streaming unigram counts over corpus files (the sampler's input)."""
    counts = np.zeros(vocab_size, dtype=np.int64)
    for f in files:
        for block in iter_token_blocks(str(f), block_tokens):
            if len(block) and (block.min() < 0 or block.max() >= vocab_size):
                bad = block[(block < 0) | (block >= vocab_size)][0]
                raise ValueError(
                    f"corpus file {f!r} has token id {int(bad)} outside "
                    f"[0, vocab_size={vocab_size})"
                )
            counts += np.bincount(block, minlength=vocab_size)
    return counts


class PairStream:
    """One worker's streaming pair source: drains corpus files from the
    pool, windows token blocks into block-shuffled (center, context) pair
    batches with negatives. Feeds ``PrefetchPipeline`` (``next_batch`` /
    ``_empty``)."""

    def __init__(
        self,
        worker_id: int,
        pool: WorkloadPool,
        *,
        window: int,
        batch_size: int,
        num_negatives: int,
        sampler: NegativeSampler,
        block_tokens: int = 1 << 20,
        seed: int = 0,
    ):
        self.worker_id = worker_id
        self.pool = pool
        self.window = window
        self.batch_size = batch_size
        self.K = num_negatives
        self.sampler = sampler
        self.block_tokens = block_tokens
        self.rng = np.random.default_rng(seed * 100003 + worker_id * 7919)
        self._blocks = None  # token-block iterator of the current file
        self._current: str | None = None
        self._tail: np.ndarray | None = None  # last W tokens of prev block
        self._buf_c = np.zeros(0, dtype=np.int64)
        self._buf_x = np.zeros(0, dtype=np.int64)
        self.max_buffered = 0  # observability: peak pairs held

    def _next_block(self) -> np.ndarray | None:
        while True:
            if self._blocks is not None:
                block = next(self._blocks, None)
                if block is not None:
                    return block
                if self._current is not None:
                    self.pool.finish(self._current)
                self._blocks = None
                self._current = None
                self._tail = None  # windows never span files
            w = self.pool.fetch(self.worker_id)
            if w is None:
                return None
            self._current = w
            self._blocks = iter_token_blocks(str(w), self.block_tokens)

    def _fill(self) -> None:
        if len(self._buf_c) >= self.batch_size:
            return
        new_c, new_x = [], []
        n_new = 0
        while len(self._buf_c) + n_new < self.batch_size:
            block = self._next_block()
            if block is None:
                break
            if self._tail is not None and len(self._tail):
                t = np.concatenate([self._tail, block])
                c, x = _window_pairs(t, self.window, skip_prefix=len(self._tail))
            else:
                t = block
                c, x = _window_pairs(block, self.window)
            # carry the last W tokens of the CONCATENATED stream (a block
            # shorter than W must not truncate the window)
            self._tail = t[-self.window :].copy()
            if len(c):
                new_c.append(c)
                new_x.append(x)
                n_new += len(c)
        if n_new:
            # block shuffle: ONE permutation over (buffer + new pairs) per fill
            c = np.concatenate([self._buf_c, *new_c])
            x = np.concatenate([self._buf_x, *new_x])
            perm = self.rng.permutation(len(c))
            self._buf_c, self._buf_x = c[perm], x[perm]
            self.max_buffered = max(self.max_buffered, len(self._buf_c))

    def next_batch(self) -> dict | None:
        self._fill()
        n = min(len(self._buf_c), self.batch_size)
        if n == 0:
            return None
        b = self._make(self._buf_c[:n], self._buf_x[:n])
        self._buf_c = self._buf_c[n:]
        self._buf_x = self._buf_x[n:]
        return b

    def _make(self, c: np.ndarray, x: np.ndarray) -> dict:
        bs = self.batch_size
        out = {
            "center": np.zeros(bs, dtype=np.int32),
            "context": np.zeros(bs, dtype=np.int32),
            "negatives": self.sampler.sample((bs, self.K)).astype(np.int32),
            "mask": np.zeros(bs, dtype=np.float32),
        }
        out["center"][: len(c)] = c
        out["context"][: len(c)] = x
        out["mask"][: len(c)] = 1.0
        return out

    def _empty(self) -> dict:
        return {
            "center": np.zeros(self.batch_size, dtype=np.int32),
            "context": np.zeros(self.batch_size, dtype=np.int32),
            "negatives": np.zeros((self.batch_size, self.K), dtype=np.int32),
            "mask": np.zeros(self.batch_size, dtype=np.float32),
        }


class Word2Vec:
    """SGNS app over vocab_size words, dim-dimensional embeddings, on one
    device (``cuda`` unless the caller passes ``device="cpu"``), or, with
    ``mesh``, both tables range-sharded over its kv ranks on the mesh's
    device and the pairs over its data ranks (then every rank of the world
    runs the same calls: training, ``state_dict``, ``load_state``,
    ``embeddings`` and ``similarity`` are collective)."""

    def __init__(
        self,
        vocab_size: int,
        dim: int = 64,
        eta: float = 0.3,
        num_negatives: int = 5,
        window: int = 2,
        seed: int = 0,
        reporter: ProgressReporter | None = None,
        mesh=None,
        max_delay: int = 0,
        push_mode: str = "per_worker",
        steps_per_call: int = 1,
        device: Any = "cuda",
    ):
        if mesh is not None and push_mode not in W2V_PUSH_MODES:
            raise ValueError(f"unknown push_mode {push_mode!r}")
        # K sequential SGNS steps per window entry (the solver.steps_per_call
        # idiom): their loss is summed on the device and read back once;
        # max_delay then counts such K-step groups in flight
        if steps_per_call < 1:
            raise ValueError(f"steps_per_call must be >= 1, got {steps_per_call}")
        self.vocab_size = vocab_size
        self.dim = dim
        self.K = num_negatives
        self.window = window
        # on a mesh the table prints on rank 0; every rank keeps its history
        self.reporter = reporter or ProgressReporter(
            print_fn=print if mesh is None or mesh.rank == 0 else (lambda *_: None))
        self.in_up = Adagrad(eta=eta)
        self.out_up = Adagrad(eta=eta)
        self.max_delay = max_delay  # SSP dispatch bound
        self.push_mode = push_mode  # inert on one device, as in the JAX app
        self.steps_per_call = steps_per_call
        self.mesh = mesh
        self.device = mesh.device if mesh is not None else resolve_device(device)
        # the JAX package's float64 draw, cast once: both packages start
        # from the same input table bit for bit; the output table starts
        # at zero (standard word2vec init). On a mesh each rank keeps its
        # slice, zero-padded to the kv multiple.
        rng = np.random.default_rng(seed)
        w0 = rng.uniform(-0.5 / dim, 0.5 / dim, size=(vocab_size, dim)).astype(np.float32)
        if mesh is None:
            self.in_state = self.in_up.init(vocab_size, dim, device=self.device)
            self.out_state = self.out_up.init(vocab_size, dim, device=self.device)
            self.in_state["w"] = torch.from_numpy(w0).to(self.device)
            return
        self.in_state = shard_state({"w": w0, "n": np.zeros_like(w0)}, mesh)
        self.out_state = self.out_up.init(_shard_size(vocab_size, mesh.kv), dim,
                                          device=self.device)
        maker = make_w2v_spmd_train_multistep if steps_per_call > 1 else make_w2v_spmd_train_step
        self._spmd_step = maker(self.in_up, self.out_up, mesh, vocab_size, push_mode)

    def state_dict(self) -> dict[str, dict[str, np.ndarray]]:
        """Host copies of both tables' state, in the JAX package's layout
        (on a mesh the full tables of ``vocab_size`` rows, gathered)."""
        if self.mesh is not None:
            return {"in": unshard_state(self.in_state, self.mesh, self.vocab_size),
                    "out": unshard_state(self.out_state, self.mesh, self.vocab_size)}
        return {"in": state_to_numpy(self.in_state), "out": state_to_numpy(self.out_state)}

    def load_state(self, in_state: dict[str, np.ndarray],
                   out_state: dict[str, np.ndarray]) -> None:
        """Replace both tables' state with numpy dicts of the same layout
        (e.g. the JAX app's ``in_state``/``out_state`` via ``np.asarray``;
        on a mesh the full tables of ``vocab_size`` rows: each rank keeps
        its slice)."""
        for name, have, new in (("in", self.in_state, in_state),
                                ("out", self.out_state, out_state)):
            if self.mesh is not None:  # the full tables' shapes, not the slice's
                have = full_like(have, self.vocab_size)
            check_state_like(name, have, new)
        if self.mesh is not None:
            self.in_state = shard_state(in_state, self.mesh)
            self.out_state = shard_state(out_state, self.mesh)
            return
        self.in_state = state_from_numpy(in_state, self.device)
        self.out_state = state_from_numpy(out_state, self.device)

    def make_pairs(self, corpus: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
        """(center, context) skip-gram pairs within the window."""
        centers, contexts = [], []
        for off in range(1, self.window + 1):
            centers.append(corpus[:-off])
            contexts.append(corpus[off:])
            centers.append(corpus[off:])
            contexts.append(corpus[:-off])
        return np.concatenate(centers), np.concatenate(contexts)

    def _make_batch(self, centers, contexts, sampler, sel) -> dict:
        return {
            "center": centers[sel].astype(np.int32),
            "context": contexts[sel].astype(np.int32),
            "negatives": sampler.sample((len(sel), self.K)).astype(np.int32),
        }

    def _make_shard_batch(self, centers, contexts, sampler, sel, batch_size: int) -> dict:
        """This data shard's batch of a global step ``sel``: its slice of
        the pairs and its draw of the negatives of all D shards, so the
        sampler advances as the JAX loop's D draws do."""
        D, d = self.mesh.data, self.mesh.d
        mine = sel[d * batch_size:(d + 1) * batch_size]
        return {
            "center": centers[mine].astype(np.int32),
            "context": contexts[mine].astype(np.int32),
            "negatives": sampler.sample_shard((batch_size, self.K), D, d).astype(np.int32),
        }

    def _dispatch_prepared(self, batch_np: dict, k_steps: int) -> torch.Tensor:
        """Issue one window entry on ready host arrays (microstep-grouped on
        a leading axis when ``k_steps > 1``): one host-to-device copy a
        field, then the microsteps back to back; returns their summed loss
        on the device, unretired. A group's padded microsteps (mask all 0)
        are exact no-ops in the JAX step and are skipped. On a mesh every
        microstep runs (a pad on this shard may be real on another) and
        the result is the (2,) pod-wide loss and pair count."""
        dev = {k: torch.from_numpy(np.ascontiguousarray(v)).to(self.device)
               for k, v in batch_np.items()}
        if self.mesh is not None:
            return self._spmd_step(self.in_state, self.out_state, dev)[2]
        if k_steps == 1:
            return sgns_train_step(self.in_up, self.out_up, self.in_state,
                                   self.out_state, dev)
        loss = None
        for k in range(k_steps):
            if not batch_np["mask"][k].any():
                continue
            step = sgns_train_step(self.in_up, self.out_up, self.in_state,
                                   self.out_state, {f: v[k] for f, v in dev.items()})
            loss = step if loss is None else loss + step
        return loss if loss is not None else torch.zeros((), device=self.device)

    def _dispatch(self, micro: list[dict], k_steps: int) -> torch.Tensor:
        """Group up to ``k_steps`` microstep batches inline and issue one
        window entry (the in-memory and serial paths; the streaming
        pipeline groups on its stacker thread instead)."""
        if k_steps == 1:
            return self._dispatch_prepared(micro[0], 1)
        return self._dispatch_prepared(_group_microbatches(micro, k_steps), k_steps)

    def train_epoch(
        self,
        corpus: np.ndarray,
        batch_size: int = 8192,
        seed: int = 0,
    ) -> float:
        """One shuffled pass. Dispatch is SSP-gated: up to ``max_delay + 1``
        window entries stay in flight and losses are read back only on
        retirement, never a per-batch device sync. On a mesh a global step
        takes ``batch_size`` pairs a data shard (every step is full, so no
        rank drains early)."""
        counts = np.bincount(corpus, minlength=self.vocab_size)
        sampler = NegativeSampler(counts, seed=seed)
        centers, contexts = self.make_pairs(corpus)
        rng = np.random.default_rng(seed)
        order = rng.permutation(len(centers))
        global_bs = batch_size * (self.mesh.data if self.mesh is not None else 1)

        total_loss, n = 0.0, 0
        t0 = time.perf_counter()

        def _retire(step: int, loss_arr) -> None:
            nonlocal total_loss
            # sync point, bounded by the gate; a mesh step's (loss, pairs)
            total_loss += float(loss_arr if self.mesh is None else loss_arr[0])

        gate = DispatchWindow(self.max_delay, _retire)
        K_steps = self.steps_per_call
        starts = list(range(0, len(order) - global_bs + 1, global_bs))
        for call_i, c in enumerate(range(0, len(starts), K_steps)):
            gate.gate(call_i)
            micro = []
            for s in starts[c : c + K_steps]:
                sel = order[s : s + global_bs]
                micro.append(
                    self._make_batch(centers, contexts, sampler, sel) if self.mesh is None
                    else self._make_shard_batch(centers, contexts, sampler, sel, batch_size))
                n += len(sel)
            gate.add(call_i, self._dispatch(micro, K_steps))
        gate.drain()
        mean = total_loss / max(n, 1)
        self.reporter.report(
            examples=n, objv=mean, ex_per_sec=n / max(time.perf_counter() - t0, 1e-9)
        )
        return mean

    def train_files(
        self,
        files: list[str],
        batch_size: int = 8192,
        epochs: int = 1,
        block_tokens: int = 1 << 20,
        seed: int = 0,
        counts: np.ndarray | None = None,
        pipeline_depth: int = 2,
    ) -> float:
        """Streaming corpus training: corpus files flow through a
        WorkloadPool to a PairStream; pair batches are built on
        PrefetchPipeline threads (``pipeline_depth`` > 0) or inline (0) and
        dispatched SSP-gated. Pairs are never materialized corpus-wide.

        On a mesh data shard d streams its file shard ``files[d::D]`` as
        the JAX app's stream d (its sampler and shuffle seeds), which is
        the JAX app's assignment when the streams take one file each.

        counts: pre-computed unigram counts (else one streaming counting
        pass over every file feeds the negative sampler)."""
        if counts is None:
            counts = count_vocab(files, self.vocab_size, block_tokens)
        d, D = (self.mesh.d, self.mesh.data) if self.mesh is not None else (0, 1)
        total_loss, n_pairs = 0.0, 0
        t0 = time.perf_counter()
        for ep in range(epochs):
            pool = WorkloadPool([str(f) for f in files][d::D])
            stream = PairStream(
                d, pool,
                window=self.window, batch_size=batch_size,
                num_negatives=self.K,
                sampler=NegativeSampler(counts, seed=seed + 31 * ep + d),
                block_tokens=block_tokens, seed=seed + 997 * ep,
            )
            loss, n = self._train_stream([stream], pipeline_depth)
            total_loss += loss
            n_pairs += n
        mean = total_loss / max(n_pairs, 1)
        self.reporter.report(
            examples=n_pairs, objv=mean,
            ex_per_sec=n_pairs / max(time.perf_counter() - t0, 1e-9),
        )
        return mean

    def _train_stream(self, streams, pipeline_depth: int) -> tuple[float, int]:
        """SSP-gated dispatch of streamed pair batches; returns (sum loss,
        real pairs). pipeline_depth 0 builds batches serially inline (no
        threads).

        On a mesh (the drained contract): a drained rank keeps issuing
        inert window entries (mask 0) and every rank stops after retiring
        one whose pod-wide pair count is 0; the retirement schedule is the
        same on every rank, so all stop at the same step."""

        def prepare(batches: list[dict]) -> tuple[dict, int]:
            # one stream: its lone batch
            return batches[0], int(sum(b["mask"].sum() for b in batches))

        total_loss, n_pairs = 0.0, 0
        drained = False  # a mesh: a retired entry counted no pair pod-wide
        mesh = self.mesh is not None

        def _retire(step: int, loss_arr) -> None:
            nonlocal total_loss, n_pairs, drained
            if not mesh:
                total_loss += float(loss_arr)
                return
            loss, pairs = loss_arr.tolist()
            total_loss += loss
            n_pairs += int(pairs)
            drained = pairs == 0

        gate = DispatchWindow(self.max_delay, _retire)
        K_steps = self.steps_per_call

        def assemble(items: list[tuple]) -> tuple[dict, int]:
            # K-way group stacking on the pipeline's stacker thread
            grouped = _group_microbatches([it[0] for it in items], K_steps)
            return grouped, sum(it[1] for it in items)

        piped = pipeline_depth > 0
        if piped:
            pipeline = PrefetchPipeline(
                streams, prepare, depth=pipeline_depth, group_size=K_steps,
                assemble=assemble if K_steps > 1 else None,
            )
            next_item = pipeline.get
        else:
            pipeline = contextlib.nullcontext()

            def next_item():
                batches = [s.next_batch() for s in streams]
                if all(b is None for b in batches):
                    return None
                return prepare([
                    b if b is not None else streams[i]._empty()
                    for i, b in enumerate(batches)
                ])

        inert = None  # a drained mesh rank's window entry

        def inert_entry() -> dict:
            nonlocal inert
            if inert is None:
                empty = streams[0]._empty()
                inert = empty if K_steps == 1 else _group_microbatches([empty], K_steps)
            return inert

        call_i = 0
        with pipeline:
            while True:
                gate.gate(call_i)
                if drained:
                    break
                if piped or K_steps == 1:
                    item = next_item()  # pre-assembled when piped and K > 1
                    if item is None and not mesh:
                        break
                    batch, n = item if item is not None else (inert_entry(), 0)
                    if not mesh:
                        n_pairs += n
                    loss = self._dispatch_prepared(batch, K_steps)
                else:  # serial path: group inline
                    micro = []
                    for _ in range(K_steps):
                        item = next_item()
                        if item is None:
                            break
                        micro.append(item[0])
                        if not mesh:
                            n_pairs += item[1]
                    if micro:
                        loss = self._dispatch(micro, K_steps)
                    elif mesh:
                        loss = self._dispatch_prepared(inert_entry(), K_steps)
                    else:
                        break
                gate.add(call_i, loss)
                call_i += 1
            gate.drain()
        return total_loss, n_pairs

    def embeddings(self) -> np.ndarray:
        """The input table's weights (on a mesh gathered over the kv group,
        collective, and, as the JAX app's sharded table, zero-padded to
        the kv multiple)."""
        if self.mesh is not None:
            return unshard_state(self.in_state, self.mesh)["w"]
        return self.in_up.weights(self.in_state).cpu().numpy()

    def similarity(self, a: int, b: int) -> float:
        E = self.embeddings()
        x, y = E[a], E[b]
        den = np.linalg.norm(x) * np.linalg.norm(y)
        return float(x @ y / den) if den > 0 else 0.0
