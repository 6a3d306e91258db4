"""Static-shape CSR minibatches and the localizer.

Per minibatch, ``unique`` the touched global keys and remap entries to
dense local ids, so the compute works on a small dense index space; the
unique key list is what pull and push are issued against.

Every batch is padded to a static (B, NNZ, U) shape. Padding contract (see
kv.store):
  - ``unique_keys[0] == PAD_KEY (0)`` always; unused unique slots repeat 0.
  - padded CSR entries have ``value == 0`` and point at unique slot 0, row 0.
  - padded example rows have ``label == 0`` and ``example_mask == False``.
  - real entries and unique slots come first, pads after: entries
    ``[:num_entries]`` and slots ``[:num_unique]`` (slot 0 among them) are
    the real ones. ``build_flat``, ``pad_batch`` and ``zero_extend`` keep
    this order, so ``trim_batch`` can cut a batch back to that prefix.

The localizer is the native C++ kernel (``data/native.py``
``hash_localize``, hash + sort-unique with the GIL released) when its
library loads, else numpy; both give the same arrays bit for bit.

A builder given a CUDA device writes each batch into one page-locked
host block (``CSRBatch.pinned``), its arrays numpy views of it, and
``batch_to_device`` copies such a batch ``non_blocking``: the host only
enqueues the copies. Every other builder allocates plain numpy arrays,
whose copies block the host until they are done.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Any

import numpy as np
import torch

from parameter_server_tpu_torch.utils.hashing import PAD_KEY, hash_keys


@dataclass
class CSRBatch:
    """One device-ready minibatch. All arrays have static shapes, except
    after ``trim_batch``, which yields the real prefix for single-device steps.

    ``unique_keys`` is int32 whenever num_keys fits, and ``row_splits``
    carries the same row structure as ``row_ids`` in B+1 ints."""

    unique_keys: np.ndarray  # (U,) int32/int64 — hashed global ids, slot 0 = pad
    local_ids: np.ndarray  # (NNZ,) int32 — entry -> unique slot
    row_ids: np.ndarray  # (NNZ,) int32 — entry -> example row
    values: np.ndarray  # (NNZ,) float32
    labels: np.ndarray  # (B,) float32 in {0, 1}
    example_mask: np.ndarray  # (B,) bool
    row_splits: np.ndarray  # (B+1,) int32 — cumulative real entries per row
    num_examples: int
    num_unique: int  # real unique keys (including pad slot 0)
    num_entries: int
    # the page-locked uint8 block every array above is a view of (a builder
    # on a CUDA device), else None; a copy that replaces an array drops it
    pinned: torch.Tensor | None = None

    @property
    def shape(self) -> tuple[int, int, int]:
        return (len(self.labels), len(self.values), len(self.unique_keys))


def training_builder(cfg, key_mode: str = "hash", device: Any = None) -> "BatchBuilder":
    """The training-ingest builder for a PSConfig: wires the frequency
    filter (cfg.data.freq_min_count + [sketch] geometry) into admission.
    ``device`` is where its batches will be copied (see ``BatchBuilder``)."""
    freq_filter = None
    if cfg.data.freq_min_count > 0:
        from parameter_server_tpu_torch.filters.frequency import CountMinSketch

        freq_filter = CountMinSketch(cfg.sketch.width, cfg.sketch.depth)
    return BatchBuilder(
        num_keys=cfg.data.num_keys,
        batch_size=cfg.solver.minibatch,
        max_nnz_per_example=cfg.data.max_nnz_per_example,
        key_mode=key_mode,
        freq_filter=freq_filter,
        freq_min_count=cfg.data.freq_min_count,
        bucket_nnz=cfg.data.bucket_nnz,
        device=device,
    )


def eval_builder(cfg, key_mode: str = "hash") -> "BatchBuilder":
    """The evaluation-ingest builder: no frequency admission (a fresh
    filter would drop keys the model trained on; unadmitted keys carry
    zero weight anyway)."""
    return BatchBuilder(
        num_keys=cfg.data.num_keys,
        batch_size=cfg.solver.minibatch,
        max_nnz_per_example=cfg.data.max_nnz_per_example,
        key_mode=key_mode,
        bucket_nnz=cfg.data.bucket_nnz,
    )


# bucketed batches never shrink below this many entries
BUCKET_FLOOR = 2048


def _nnz_bucket(n: int, cap: int, floor: int = BUCKET_FLOOR) -> int:
    """Smallest power-of-two >= n (>= floor), capped at the static max."""
    b = max(floor, 1 << max(n - 1, 0).bit_length())
    return min(b, cap)


def pad_group(batches: list["CSRBatch"]) -> list["CSRBatch"]:
    """Bring a group of (possibly bucketed) batches to one static shape,
    the group max per dimension."""
    nnz_t = max(len(b.values) for b in batches)
    u_t = max(len(b.unique_keys) for b in batches)
    return [pad_batch(b, nnz_t, u_t) for b in batches]


def zero_extend(a: np.ndarray, n: int, axis: int = 0) -> np.ndarray:
    """Zero-pad ``a`` to length ``n`` along ``axis`` (zeros are inert
    everywhere by the PAD_KEY == slot 0 convention)."""
    if a.shape[axis] == n:
        return a
    if a.shape[axis] > n:
        raise ValueError(f"cannot shrink axis {axis}: {a.shape[axis]} > {n}")
    pad = [(0, 0)] * a.ndim
    pad[axis] = (0, n - a.shape[axis])
    return np.pad(a, pad)


def pad_batch(b: CSRBatch, nnz_cap: int, u_cap: int) -> CSRBatch:
    """Re-pad a (possibly bucketed) batch to the given capacities."""
    if len(b.values) == nnz_cap and len(b.unique_keys) == u_cap:
        return b
    if len(b.values) > nnz_cap or len(b.unique_keys) > u_cap:
        raise ValueError(
            f"cannot shrink batch ({len(b.values)}, {len(b.unique_keys)}) "
            f"to ({nnz_cap}, {u_cap})"
        )
    return CSRBatch(
        unique_keys=zero_extend(b.unique_keys, u_cap),
        local_ids=zero_extend(b.local_ids, nnz_cap),
        row_ids=zero_extend(b.row_ids, nnz_cap),
        values=zero_extend(b.values, nnz_cap),
        labels=b.labels,
        example_mask=b.example_mask,
        row_splits=b.row_splits,  # fixed (B+1,): counts real entries only
        num_examples=b.num_examples,
        num_unique=b.num_unique,
        num_entries=b.num_entries,
    )


def trim_batch(b: CSRBatch) -> CSRBatch:
    """The batch's real prefix, as numpy views (``pad_batch``'s inverse):
    slots ``[:num_unique]``, pad slot 0 included, and entries
    ``[:num_entries]``; the example rows and counts are left as they are."""
    n = b.num_entries
    return replace(b, unique_keys=b.unique_keys[: b.num_unique], local_ids=b.local_ids[:n],
                   row_ids=b.row_ids[:n], values=b.values[:n])


_BATCH_FIELDS = (
    "unique_keys", "local_ids", "row_ids", "values", "labels", "example_mask",
)
_TORCH_DTYPES = {
    np.dtype(np.int32): torch.int32, np.dtype(np.int64): torch.int64,
    np.dtype(np.float32): torch.float32, np.dtype(np.bool_): torch.bool,
}


def _block_view(block: torch.Tensor, a: np.ndarray) -> torch.Tensor:
    """``a``, a numpy view into ``block``, as a torch view of ``block``."""
    off = a.__array_interface__["data"][0] - block.data_ptr()
    if not 0 <= off <= block.numel() - a.nbytes:
        raise ValueError("a batch array lies outside the batch's page-locked block")
    return block[off: off + a.nbytes].view(_TORCH_DTYPES[a.dtype])


def batch_to_device(b: CSRBatch, device: Any) -> dict[str, torch.Tensor]:
    """The CSRBatch arrays as tensors on ``device``. A batch that carries a
    page-locked block is copied from torch views of the block,
    ``non_blocking``: the host only enqueues the copies, and the host
    allocator records the stream's use of the block, so a block whose
    batch is dropped is not handed out again before its copies are done.
    Any other batch is copied from its numpy arrays."""
    block = getattr(b, "pinned", None)
    if block is None:
        return {f: torch.from_numpy(getattr(b, f)).to(device) for f in _BATCH_FIELDS}
    return {f: _block_view(block, getattr(b, f)).to(device, non_blocking=True)
            for f in _BATCH_FIELDS}


# every array a batch carries, in the order a page-locked block holds them
_ARRAY_FIELDS = _BATCH_FIELDS + ("row_splits",)
_BLOCK_ALIGN = 16  # bytes


def _pinned_block(nbytes: int) -> torch.Tensor:
    return torch.empty(nbytes, dtype=torch.uint8, pin_memory=True)


def _carve(shapes: list[tuple[int, Any]]) -> tuple[torch.Tensor, list[np.ndarray]]:
    """One page-locked block for arrays of the given (length, dtype), each
    starting on a 16-byte boundary, and the arrays as numpy views of it."""
    offsets, nbytes = [], 0
    for n, dt in shapes:
        offsets.append(nbytes)
        nbytes += -(-n * np.dtype(dt).itemsize // _BLOCK_ALIGN) * _BLOCK_ALIGN
    block = _pinned_block(nbytes)
    raw = block.numpy()
    return block, [raw[o: o + n * np.dtype(dt).itemsize].view(dt)
                   for o, (n, dt) in zip(offsets, shapes)]


class BatchBuilder:
    """Turns parsed (label, keys, values) rows into CSRBatches.

    key_mode:
      "hash"     — splitmix64 into [1, num_keys) (production path; slots salt)
      "identity" — key+1 used directly (requires raw keys < num_keys - 1)

    ``device`` is where the batches will be copied: on a CUDA device each
    batch is built in one page-locked block (``CSRBatch.pinned``), which
    ``batch_to_device`` copies without blocking the host; else (None, the
    CPU) in plain numpy arrays.
    """

    def __init__(
        self,
        num_keys: int,
        batch_size: int,
        max_nnz_per_example: int = 256,
        unique_capacity: int | None = None,
        key_mode: str = "hash",
        freq_filter=None,
        freq_min_count: int = 0,
        bucket_nnz: bool = False,
        device: Any = None,
    ):
        if key_mode not in ("hash", "identity"):
            raise ValueError(f"bad key_mode {key_mode!r}")
        self.num_keys = num_keys
        self.batch_size = batch_size
        self.nnz_capacity = batch_size * max_nnz_per_example
        # +1 for the pad slot; capped at nnz (can't see more uniques than entries)
        self.unique_capacity = unique_capacity or min(
            self.nnz_capacity + 1, num_keys
        )
        self.key_mode = key_mode
        # pad entry/unique arrays to the next power of two above the real
        # count instead of the worst case
        self.bucket_nnz = bucket_nnz
        self.page_locked = device is not None and torch.device(device).type == "cuda"
        # streaming admission: the sketch counts RAW pre-hash keys; entries
        # below the threshold are dropped before localization
        self.freq_filter = freq_filter
        self.freq_min_count = freq_min_count
        if freq_min_count > 0 and freq_filter is None:
            from parameter_server_tpu_torch.filters.frequency import CountMinSketch

            self.freq_filter = CountMinSketch()

    def build(
        self,
        labels: np.ndarray,
        keys: list[np.ndarray],
        values: list[np.ndarray],
        slot_ids: list[np.ndarray] | None = None,
    ) -> CSRBatch:
        """labels: (b,); keys[i]/values[i]: per-example sparse features."""
        counts = np.array([len(k) for k in keys], dtype=np.int64)
        row_splits = np.zeros(len(labels) + 1, dtype=np.int64)
        np.cumsum(counts, out=row_splits[1:])
        nnz = int(row_splits[-1])
        return self.build_flat(
            np.asarray(labels),
            row_splits,
            np.concatenate(keys) if nnz else np.zeros(0, dtype=np.uint64),
            (
                np.concatenate(values).astype(np.float32)
                if nnz
                else np.zeros(0, dtype=np.float32)
            ),
            np.concatenate(slot_ids) if slot_ids is not None else None,
        )

    def build_flat(
        self,
        labels: np.ndarray,
        row_splits: np.ndarray,
        flat_keys: np.ndarray,
        flat_vals: np.ndarray,
        flat_slots: np.ndarray | None = None,
    ) -> CSRBatch:
        """Vectorized build from flat CSR arrays."""
        b = len(labels)
        if b > self.batch_size:
            raise ValueError(f"{b} examples > batch_size {self.batch_size}")
        nnz = int(row_splits[-1])
        if nnz > self.nnz_capacity:
            raise ValueError(f"{nnz} entries > nnz capacity {self.nnz_capacity}")
        flat_vals = np.asarray(flat_vals, dtype=np.float32)
        row_ids = np.repeat(
            np.arange(b, dtype=np.int32), np.diff(row_splits).astype(np.int64)
        )

        splits_src = row_splits  # reusable unless the filter drops entries
        if self.freq_min_count > 0 and nnz:
            # count the whole batch first, then admit: a key is admitted,
            # with all its occurrences in this batch, once its running
            # count crosses the threshold
            raw = np.asarray(flat_keys, dtype=np.uint64)
            self.freq_filter.add(raw)
            keep = self.freq_filter.admit(raw, self.freq_min_count)
            flat_keys = raw[keep]
            flat_vals = flat_vals[keep]
            row_ids = row_ids[keep]
            if flat_slots is not None:
                flat_slots = np.asarray(flat_slots)[keep]
            nnz = int(keep.sum())
            splits_src = None  # row structure changed; rederive below

        # Localizer: unique + inverse, with the pad key forced into slot 0.
        # The native kernel fuses hash + sort-unique with the GIL released;
        # the numpy path below is the exact-parity fallback.
        from parameter_server_tpu_torch.data import native as _native

        nat = (
            _native.hash_localize(
                flat_keys, flat_slots, self.num_keys,
                identity=self.key_mode != "hash",
            )
            if nnz
            else None
        )
        if nat is not None:
            uniq, inverse = nat
        else:
            if self.key_mode == "hash":
                salts = flat_slots if flat_slots is not None else 0
                gids = hash_keys(flat_keys, self.num_keys, slot_ids=salts)
            else:
                gids = np.asarray(flat_keys, dtype=np.int64) + 1
                if nnz and gids.max() >= self.num_keys:
                    raise ValueError(
                        f"identity key {gids.max() - 1} >= num_keys-1; "
                        "grow num_keys or use key_mode='hash'"
                    )
            uniq, inverse = np.unique(gids, return_inverse=True)

        key_dtype = (
            np.int32 if self.num_keys <= np.iinfo(np.int32).max else np.int64
        )
        n_uniq = len(uniq) + 1  # + the forced PAD row at slot 0
        if n_uniq > self.unique_capacity:
            raise ValueError(
                f"{n_uniq} unique keys > capacity {self.unique_capacity}"
            )

        if self.bucket_nnz:
            nnz_cap = _nnz_bucket(nnz, self.nnz_capacity)
            u_cap = min(nnz_cap + 1, self.unique_capacity, self.num_keys)
        else:
            nnz_cap = self.nnz_capacity
            u_cap = self.unique_capacity
        shapes = [(u_cap, key_dtype), (nnz_cap, np.int32), (nnz_cap, np.int32),
                  (nnz_cap, np.float32), (self.batch_size, np.float32),
                  (self.batch_size, np.bool_), (self.batch_size + 1, np.int32)]
        if self.page_locked:
            block, arrays = _carve(shapes)
            for a in arrays[4:]:  # labels, example_mask, row_splits start at 0
                a.fill(0)
        else:
            block = None
            arrays = ([np.empty(n, dtype=dt) for n, dt in shapes[:4]]
                      + [np.zeros(n, dtype=dt) for n, dt in shapes[4:]])
        out = CSRBatch(
            **dict(zip(_ARRAY_FIELDS, arrays)),
            num_examples=b,
            num_unique=n_uniq,
            num_entries=nnz,
            pinned=block,
        )
        out.unique_keys[0] = PAD_KEY
        out.unique_keys[1:n_uniq] = uniq
        out.unique_keys[n_uniq:] = PAD_KEY
        # local ids shift by one for the PAD row
        np.add(inverse, 1, out=out.local_ids[:nnz], casting="unsafe")
        out.local_ids[nnz:] = 0
        out.row_ids[:nnz] = row_ids
        out.row_ids[nnz:] = 0
        out.values[:nnz] = flat_vals
        out.values[nnz:] = 0.0
        out.labels[:b] = np.asarray(labels, dtype=np.float32)
        out.example_mask[:b] = True
        # row_ids over REAL entries is non-decreasing by construction
        if splits_src is not None:
            out.row_splits[: b + 1] = splits_src
        elif nnz:
            np.cumsum(
                np.bincount(row_ids, minlength=b), out=out.row_splits[1 : b + 1]
            )
        out.row_splits[b + 1 :] = out.row_splits[b]
        return out
