"""The mesh KV backend: push/pull over the kv ranks of a world.

The port of the JAX package's ``parallel/meshbackend.py``. There the KV
store is one ``(num_keys, vdim)`` table sharded over the ``kv`` axis of a
device mesh inside one program. Here it is the port's SPMD tier
(``parallel/mesh.py``): one process a kv cell, each rank holding its
contiguous ``(S, vdim)`` slice of the table, ``S = padded_num_keys(K, KV)
// KV`` (the pad rows past ``num_keys`` stay zero and are never touched).
Every rank runs the same ``train_linear`` loop on the same data, so every
rank makes the same collective calls (the drained contract):

  pull  -> the masked local gather of each rank's range, summed over the
           kv group (``spmd.pull``; out-of-range rows contribute zero);
  push  -> the reduce-scatter shape: each rank slices the sorted global
           keys at the shard boundaries (the JAX ``_segment_layout``) and
           applies only its own segment, ``spmd._local_push(...,
           unique=True)``: K1 (FTRL) or K3 (AdaGrad) on the card. Every
           rank already holds the whole push, so no collective moves it;
  quant -> the per-segment int8/int16 codec with the host error-feedback
           residual, in the JAX backend's layout: every kv segment padded
           to one power-of-two bucket of keys and to whole codec
           segments, encoded on the host by the numpy ``SegmentQuantizer``
           with a seed counter, as the JAX backend encodes. Every rank
           therefore draws the same codes (and the JAX backend's, byte for
           byte), and each decodes its own segment on its device.

``push_async`` resolves at issue (device-program order makes a later pull
see it); ``flush`` waits for the device. Not thread-safe for concurrent
pushes: one logical trainer owns the table.
"""

from __future__ import annotations

import itertools
import threading
from concurrent.futures import Future
from typing import Any

import numpy as np
import torch

from parameter_server_tpu_torch.parallel.backend import PSBackend
from parameter_server_tpu_torch.utils import flightrec
from parameter_server_tpu_torch.utils.metrics import race_track, wire_counters

#: rows of one kv shard: the push's local row indices are int32
_MAX_ROWS = 1 << 31


class MeshBackend(PSBackend):
    """This rank's kv slice of one range-sharded table. ``mesh``: this
    rank's ``parallel.mesh.Mesh``; without one the backend joins a world
    of one on ``device`` (``cuda`` unless the caller asks for ``cpu``;
    NCCL on the card) and leaves it on ``close``."""

    def __init__(
        self,
        updater,
        num_keys: int,
        vdim: int = 1,
        mesh=None,
        kv_shards: int | None = None,
        quant: str = "off",
        quant_seg: int = 256,
        device: Any = "cuda",
    ):
        from parameter_server_tpu_torch.parallel.spmd import padded_num_keys

        if quant not in ("off", "int8", "int16"):
            raise ValueError(
                f"mesh quant must be off|int8|int16, got {quant!r}"
            )
        self._runtime = None
        if mesh is None:
            if kv_shards not in (None, 1):
                raise ValueError(
                    f"kv_shards={kv_shards} needs a world of that many kv "
                    "ranks: pass the mesh of parallel.runtime.init"
                )
            from parameter_server_tpu_torch.parallel import runtime

            self._runtime = runtime.init(None, kv_shards=1, device=device)
            mesh = self._runtime.mesh
        elif kv_shards is not None and kv_shards != mesh.kv:
            raise ValueError(f"kv_shards={kv_shards} but the mesh has {mesh.kv}")
        self.mesh = mesh
        self.device = mesh.device
        self.updater = updater
        self.num_keys = int(num_keys)
        self.vdim = int(vdim)
        kv = mesh.kv
        self._rows = padded_num_keys(self.num_keys, kv)
        self._shard = self._rows // kv
        if self._shard >= _MAX_ROWS:
            raise ValueError(
                f"shard rows {self._shard} overflow the int32 local index"
            )
        self._begin = mesh.k * self._shard
        self._quant_bytes = {"off": 0, "int8": 1, "int16": 2}[quant]
        self._seg = max(1, int(quant_seg))
        if self._quant_bytes:
            from parameter_server_tpu_torch.filters.quant import SegmentQuantizer

            self._quantizer = SegmentQuantizer(self._quant_bytes, self._seg)
            self._codecs: dict[int, SegmentQuantizer] = {}
        # error-feedback accumulator (the socket handle's residual,
        # host-side): what each quantized push loses to stochastic
        # rounding, folded into the NEXT push of the same keys exactly
        # once per logical push. Dense over the padded table, and the
        # same on every rank (each encodes the whole push).
        self._res_lock = threading.Lock()
        self._residual: np.ndarray | None = None
        self._quant_seed = itertools.count()
        self._pool = None  # lazy 1-thread executor for pull_async syncs
        self.state = updater.init(self._shard, self.vdim, device=self.device)
        # lockset race witness (PS_RACE_WITNESS=1): the residual is the
        # one piece of shared mutable host state on this backend — every
        # access must hold _res_lock or the exactly-once folding breaks
        race_track(self, ("_residual",), f"MeshBackend:{id(self):x}")

    # -- host-side layout --------------------------------------------------

    @staticmethod
    def _bucket_cap(u: int) -> int:
        return 1 << max(u - 1, 0).bit_length()

    def _bounds(self, keys: np.ndarray) -> np.ndarray:
        """Segment bounds of the sorted global ``keys`` at the shard range
        boundaries (one searchsorted)."""
        begins = np.arange(self.mesh.kv + 1, dtype=np.int64) * self._shard
        return np.searchsorted(keys, begins)

    def _to_device(self, a: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(a)).to(self.device)

    # -- the interface -----------------------------------------------------

    def _issue_pull(self, keys: np.ndarray) -> torch.Tensor:
        from parameter_server_tpu_torch.parallel.spmd import pull

        idx = self._to_device(np.asarray(keys, dtype=np.int64))
        return pull(self.updater, self.state, idx, self._shard, self.mesh)

    def pull(self, keys: np.ndarray) -> np.ndarray:
        if len(keys) == 0:
            return np.zeros((0, self.vdim), np.float32)
        # no pow-2 key bucket here: the bucket is the pull's own key count
        flightrec.record("mesh.pull", keys=len(keys), bucket=len(keys))
        return self._finish_pull(self._issue_pull(keys))

    @staticmethod
    def _finish_pull(dev: torch.Tensor) -> np.ndarray:
        return dev.cpu().numpy().astype(np.float32, copy=False)

    def pull_async(self, keys: np.ndarray) -> Future:
        """The gather and the kv sum are issued on the calling thread (a
        collective: every rank issues it in the same order); only the
        device-to-host copy moves to a 1-thread executor."""
        f: Future = Future()
        if len(keys) == 0:
            f.set_result(np.zeros((0, self.vdim), np.float32))
            return f
        flightrec.record("mesh.pull", keys=len(keys), bucket=len(keys))
        try:
            dev = self._issue_pull(keys)
        except BaseException as e:  # noqa: BLE001 — future boundary
            f.set_exception(e)
            return f
        return self._sync_pool().submit(self._finish_pull, dev)

    def _sync_pool(self):
        if self._pool is None:
            from concurrent.futures import ThreadPoolExecutor

            self._pool = ThreadPoolExecutor(max_workers=1)
        return self._pool

    def push(self, keys: np.ndarray, grads: np.ndarray) -> None:
        from parameter_server_tpu_torch.parallel.spmd import _local_push

        keys = np.asarray(keys, dtype=np.int64)
        u = len(keys)
        if u == 0:
            return
        g = np.asarray(grads, np.float32).reshape(u, -1)
        bounds = self._bounds(keys)
        lo, hi = int(bounds[self.mesh.k]), int(bounds[self.mesh.k + 1])
        if self._quant_bytes:
            q, qs, seg_q = self._encode_push(keys, g, bounds)
            flightrec.record("mesh.push", keys=u, bytes=int(q.nbytes + qs.nbytes))
            flightrec.record("mesh.apply", bucket=hi - lo, quant=self._quant_bytes)
            from parameter_server_tpu_torch.filters.quant import dequantize_flat

            row = self._to_device(q[self.mesh.k])
            scales = self._to_device(qs[self.mesh.k])
            g_seg = dequantize_flat(row, scales, seg=seg_q)[: (hi - lo) * self.vdim]
            g_seg = g_seg.reshape(hi - lo, self.vdim)
        else:
            wire_counters.inc("mesh_push_payload_bytes", int(g.nbytes))
            flightrec.record("mesh.push", keys=u, bytes=int(g.nbytes))
            flightrec.record("mesh.apply", bucket=hi - lo, quant=0)
            g_seg = self._to_device(g[lo:hi])
        if hi > lo:
            idx = self._to_device(keys[lo:hi])
            _local_push(self.updater, self.state, idx[None], g_seg[None],
                        self._begin, self._shard, unique=True)

    def _encode_push(
        self, keys: np.ndarray, g: np.ndarray, bounds: np.ndarray,
    ) -> tuple[np.ndarray, np.ndarray, int]:
        """Quantize one push into the JAX backend's sharded layout with
        error feedback: fold the residual of the previous pushes of these
        keys, scatter the folded gradient into per-shard rows (each
        padded to one power-of-two bucket of keys and to whole codec
        segments, so every row's scales slice is self-contained), encode
        with a fresh stochastic-rounding seed, store back what THIS
        encode loses. Returns the (kv, row_pad) codes, the (kv, nseg)
        scales and the codec's segment length."""
        kv = self.mesh.kv
        counts = bounds[1:] - bounds[:-1]
        c = self._bucket_cap(int(counts.max() or 1))
        row = c * self.vdim
        seg_q = min(self._seg, row)
        row_pad = -(-row // seg_q) * seg_q
        codec = self._codec(seg_q)
        with self._res_lock:
            if self._residual is None:
                self._residual = np.zeros((self._rows, self.vdim), np.float32)
            g_tot = g + self._residual[keys]
            g_sh = np.zeros((kv, row_pad), np.float32)
            for s in range(kv):
                n = counts[s]
                g_sh[s, : n * self.vdim] = g_tot[bounds[s] : bounds[s + 1]].ravel()
            q, qs = codec.encode(next(self._quant_seed), g_sh)
            dec = codec.decode(q, qs).reshape(kv, row_pad)
            dec_rows = np.empty_like(g_tot)
            for s in range(kv):
                n = counts[s]
                dec_rows[bounds[s] : bounds[s + 1]] = dec[s, : n * self.vdim].reshape(
                    n, self.vdim)
            self._residual[keys] = g_tot - dec_rows
        q = q.reshape(kv, row_pad)
        qs = qs.reshape(kv, row_pad // seg_q)
        payload = int(q.nbytes + qs.nbytes)
        wire_counters.inc("mesh_push_payload_bytes", payload)
        wire_counters.inc(
            "mesh_push_bytes_saved", max(kv * row_pad * 4 - payload, 0)
        )
        return q, qs, seg_q

    def _codec(self, seg_q: int):
        """The segment codec at an effective segment length (shrunk for
        pushes smaller than one configured segment, so a row's scales
        always tile it exactly)."""
        if seg_q == self._seg:
            return self._quantizer
        from parameter_server_tpu_torch.filters.quant import SegmentQuantizer

        q = self._codecs.get(seg_q)
        if q is None:
            q = self._codecs[seg_q] = SegmentQuantizer(self._quant_bytes, seg_q)
        return q

    def push_async(self, keys: np.ndarray, grads: np.ndarray) -> Future:
        # a mesh push IS its issue: device-program order guarantees any
        # later pull sees it, and flush() is the applied barrier
        f: Future = Future()
        try:
            self.push(keys, grads)
            f.set_result(None)
        except BaseException as e:  # noqa: BLE001 — future boundary
            f.set_exception(e)
        return f

    def flush(self) -> None:
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def close(self) -> None:
        try:
            self.flush()
        finally:
            if self._pool is not None:
                self._pool.shutdown(wait=True)
                self._pool = None
            if self._runtime is not None:
                self._runtime.shutdown()
                self._runtime = None

    def weights(self) -> np.ndarray:
        """The full (num_keys, vdim) table, gathered over the kv group.
        Collective: every rank calls it."""
        w = self.mesh.all_gather(self.updater.weights(self.state), "kv")
        w = w.reshape(-1, self.vdim)[: self.num_keys]
        return w.cpu().numpy()

    def residual_norm(self) -> float:
        """Mean |residual| over the table."""
        with self._res_lock:
            if self._residual is None:
                return 0.0
            return float(np.abs(self._residual).mean())

    def residual_rows(self, keys: np.ndarray) -> np.ndarray:
        """Current residual rows for global ``keys`` (zeros before the
        first quantized push) — read-only."""
        idx = np.asarray(keys, np.int64)
        with self._res_lock:
            if self._residual is None:
                return np.zeros((len(idx), self.vdim), np.float32)
            return self._residual[idx].copy()

    def stats(self) -> dict[str, Any]:
        return {
            "backend": "mesh",
            "kv_shards": self.mesh.kv,
            "table_rows": self._rows,
            "quant_bytes": self._quant_bytes,
            "residual_mean_abs": self.residual_norm(),
        }
