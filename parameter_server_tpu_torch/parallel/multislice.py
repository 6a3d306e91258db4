"""The wire tier's data plane: range-sharded shard servers and their handles.

The port of the data-plane half of the JAX package's
``parallel/multislice.py``. Each ``ShardServer`` owns one contiguous key
range of the model, holds its updater tables on a device (``cuda`` unless
the caller asks for ``cpu``) and answers pull / push / dump / stats /
shutdown over the wire (``parallel/control.py``). A worker reaches it
through a ``ServerHandle``, which applies the send filters: key caching
(a signature instead of the key list once the server holds it), zlib,
the negotiated per-segment int8/int16 codec with client-side error
feedback, and the fixed-point codec. The frames are the JAX package's,
byte for byte: a JAX handle talks to a port server and a port handle to
a JAX server.

Pushes go through the batched apply engine: each decoded push lands in a
bounded queue, one apply thread drains whatever has arrived (up to
``[server] max_batch``), segment-sums the duplicate keys across them
(``kv.store.coalesce_pushes``) and applies the updater once over the
union through the port's in-place ``kv.store.push``: K1 (``ftrl_push``)
for FTRL and K3 (``adagrad_push``) for AdaGrad on the card. A resent push
applies once: the RPC layer's reply cache answers it, and the apply
engine's ledger (``_applied_push``) drops any that reach it twice.

In place against snapshot pulls. The JAX server publishes a new immutable
(state, version, publish-ts) tuple per batch and pulls read it without a
lock. The port's push changes the tables in place, so one publish lock
(``_pub_lock``) is held while an apply is issued and while a pull's or a
dump's gathers are issued; the version and its publish timestamp move
inside the apply's hold, and a pull reads them inside its gather's hold,
so a reply's ``ver`` names exactly the table its rows came from. On the
card both only enqueue work on the one current stream, so stream order
makes every gather see whole batches; on the CPU they run under the lock.
The copies to the host run outside it.

The serving plane. A version is an opaque per-life id: a random 23-bit
nonce above a 40-bit counter, redrawn by a checkpoint restore, so a
version a client cached in an earlier life never validates. A pull that
carries ``if_newer`` equal to the current version is answered
``not_modified`` with no rows; under overload (``[serve] shed_*``) a
revalidation the client flagged ``shed_ok`` is shed with a retry-after
hint; hot key sets share one encoded reply a version (the single-flight
encode cache, bounded in entries and bytes), and a hot conditional pull
of a range within ``snapshot_keys_max`` rows reads a host copy of the
whole weights table taken once a version. A ``ServerHandle(serving=True)``
with ``[serve] cache`` keeps the decoded rows in a ``ClientKeyCache``
(``filters/keycache.py``), invalidated exactly by its own pushes.

Chaos: a ``FaultPlan`` (``parallel/chaos.py``) armed on a server, by
``fault_plan=``, ``[fault] fault_plan`` or ``PS_FAULT_PLAN``, perturbs its
frames; ``launch_local(fault_plan=...)`` arms every node it spawns. The
reply cache and the push ledger keep every push applied once. The adaptive
knobs: ``[server] adaptive_batch`` ramps the apply thread's drain ceiling
to the arrival rate, ``[wire] adaptive_window`` the handle's in-flight
window to its latency.

A server checkpoints its range (``save_state`` / ``load_state``) in the
JAX server's file name and layout, ledger included, so a dump of either
package's server loads into the other's.

The node entry points run the cluster, one process a node (ref:
script/local.sh): ``run_scheduler`` (the coordinator, the monitor loop,
the model dump and its evaluation), ``run_server`` (a ``ShardServer`` on
its device, checkpoint-backed restart), ``run_worker`` (the async-SGD
loop: segment sums on its device, pulls and pushes through a
``SocketBackend``, a ``PushWindow`` bounded by the SSP delay),
``run_node`` (role dispatch, what ``cli node`` calls) and
``launch_local`` (what ``cli launch`` calls: spawns them all, optionally
kills and restarts one). Every node runs on ``cuda`` unless asked for
``cpu``.

Tracing and the black box are the JAX module's, at the same call sites
with the same span names and recorder events: ``ps.pull``/``ps.push``
(with their in-flight flows) on a handle, ``rpc.serve.<cmd>`` joined to
the caller's trace and ``server.updater`` re-joined across the apply
thread's hop on a server, ``step.*`` spans on a worker; ``rcu.publish``,
``apply.begin``/``apply.commit``/``apply.replay`` and ``serve.shed`` on a
server. ``launch_local(trace_dir=, blackbox_dir=)`` and ``run_node`` arm
them. The live operations plane is the JAX module's too: each beat
carries the node's telemetry (``beat_telemetry``) and audit spool;
``run_node`` arms the sampling profiler, the OpenMetrics endpoint and the
scheduler's SLO engine and auditor; a server books its range's traffic,
apply cost and data age (``RangeScope``) and its keys' heat
(``key_heat``); a handle books each serve's realized age into the
``serve.age_s`` histogram and the recorder's ``freshness.serve`` event.
"""

from __future__ import annotations

import hashlib
import itertools
import json
import os
import queue as queue_mod
import threading
import time
from collections import OrderedDict
from concurrent.futures import Future, ThreadPoolExecutor
from typing import Any

import numpy as np
import torch

from parameter_server_tpu_torch.device import resolve_device
from parameter_server_tpu_torch.kv import store as kv_store
from parameter_server_tpu_torch.kv.updaters import Updater
from parameter_server_tpu_torch.ops import cuda_build
from parameter_server_tpu_torch.parallel.chaos import PLAN_ENV, SEED_ENV, FaultPlan
from parameter_server_tpu_torch.parallel.control import (
    Arrays,
    ControlClient,
    Coordinator,
    DeferredReply,
    RpcClient,
    RpcServer,
)
from parameter_server_tpu_torch.utils import flightrec, trace
from parameter_server_tpu_torch.utils.config import (
    PSConfig,
    ServeConfig,
    ServerConfig,
    load_config,
)
from parameter_server_tpu_torch.utils.flightrec import watchdog
from parameter_server_tpu_torch.utils.heartbeat import HeartbeatReporter, host_stats
from parameter_server_tpu_torch.utils.keyrange import KeyRange
from parameter_server_tpu_torch.utils.clock import now_wall_us, skew_clamped_age_s
from parameter_server_tpu_torch.utils.metrics import (
    RangeScope,
    key_heat,
    latency_histograms,
    observe_scalar,
    race_track,
    wire_counters,
)


def _plan_from_cfg(cfg: PSConfig) -> FaultPlan | None:
    """FaultPlan from [fault] fault_plan/fault_seed ("" = rely on the
    PS_FAULT_PLAN env fallback inside RpcServer)."""
    if not cfg.fault.fault_plan:
        return None
    return FaultPlan.parse(cfg.fault.fault_plan, seed=cfg.fault.fault_seed)


def _ver_base() -> int:
    """A fresh per-life version namespace: a random 23-bit nonce above a
    40-bit counter, so every version fits the binary header's unsigned
    fixed slot."""
    return (int.from_bytes(os.urandom(3), "big") & ((1 << 23) - 1)) << 40


def _sig(keys: np.ndarray) -> str:
    """Key-list signature (ref: key_caching.h signatures)."""
    return hashlib.blake2b(keys.tobytes(), digest_size=8).hexdigest()


# Bound on cached key lists per endpoint. Streamed minibatches mostly have
# distinct key sets (hits come from pull->push pairs and epoch repeats), so
# an unbounded cache would grow linearly with steps; the need_keys retry
# makes eviction always safe.
_KEY_CACHE_CAP = 512


class _LruSigs:
    """Tiny thread-safe LRU over signature -> value (value may be None for a
    set). Locked: server connection threads and the worker's in-flight push
    threads touch these caches concurrently."""

    def __init__(self, cap: int = _KEY_CACHE_CAP):
        self._d: OrderedDict = OrderedDict()
        self._cap = cap
        self._lock = threading.Lock()

    def get(self, k):
        with self._lock:
            if k in self._d:
                self._d.move_to_end(k)
                return self._d[k]
            return None

    def __contains__(self, k) -> bool:
        with self._lock:
            return k in self._d

    def put(self, k, v=None) -> None:
        with self._lock:
            self._d[k] = v
            self._d.move_to_end(k)
            while len(self._d) > self._cap:
                self._d.popitem(last=False)

    def __len__(self) -> int:
        with self._lock:
            return len(self._d)


class _EncodeEntry:
    """One single-flight encoded pull reply: the first puller of a hot
    key set at a given version computes the encode; concurrent and later
    pulls of the same (signature, version, codec) wait on ``event`` and
    reuse the same reply header and arrays (``rep is None`` after the
    event fires means the owner's encode failed: followers encode for
    themselves). ``nbytes`` is the payload counted against the cache's
    byte budget: 0 until filled, and 0 forever if the entry was evicted
    before its owner filled it."""

    __slots__ = ("event", "rep", "arrays", "nbytes")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.rep: dict[str, Any] | None = None
        self.arrays: Arrays | None = None
        self.nbytes = 0


class _QueuedPush:
    """One decoded push waiting in the apply queue: keys + decoded grad,
    its durable dedup identity, and the Future the deferred RPC reply
    resolves from."""

    __slots__ = ("keys", "grad", "cid", "seq", "future", "t_enq", "tctx")

    def __init__(
        self, keys: np.ndarray, grad: np.ndarray,
        cid: str | None, seq: str | None,
        tctx: dict[str, str] | None = None,
    ):
        self.keys = keys
        self.grad = grad
        self.cid = cid
        self.seq = seq
        # the dispatch span's wire identity (None untraced): the apply
        # thread's server.updater span re-joins this push's trace
        self.tctx = tctx
        self.future: Future = Future()
        # enqueue mark: the reply carries the queue wait (_apw_us)
        self.t_enq = time.perf_counter()


def _host_array(a: np.ndarray, dtype=None) -> np.ndarray:
    """A wire array as an aligned, contiguous, writable host array (frames
    land as views of one receive buffer, at any offset)."""
    return np.require(a, dtype=dtype, requirements=("C", "A", "W"))


def _strictly_unique(idx: np.ndarray) -> bool:
    """Does every key occur once? Sorted input (the backend's fan-out)
    answers in one pass."""
    if len(idx) < 2 or bool(np.all(idx[1:] > idx[:-1])):
        return True
    return len(np.unique(idx)) == len(idx)


class ShardServer:
    """One server: updater state over its key range on ``device``, served
    via RPC. Commands: pull / push / dump / stats / shutdown.

    ``[server] apply_queue = 0`` disables the apply engine: pushes apply
    inline under the apply lock, the JAX package's serial discipline.
    ``serve_cfg`` (``[serve]``) sizes the serving plane: the encode
    cache, the host snapshot gate and the shedding thresholds."""

    def __init__(
        self,
        updater: Updater,
        key_range: KeyRange,
        vdim: int = 1,
        host: str = "127.0.0.1",
        port: int = 0,
        advertise_host: str = "",
        fault_plan: FaultPlan | None = None,
        server_cfg: ServerConfig | None = None,
        serve_cfg: ServeConfig | None = None,
        device: Any = "cuda",
    ):
        scfg = server_cfg or ServerConfig()
        svcfg = serve_cfg or ServeConfig()
        self.device = resolve_device(device)
        #: host seconds of the kernel library's load at start (None on the
        #: CPU) and of the first apply (None until one ran)
        self.kernel_load_s: float | None = None
        self.first_apply_s: float | None = None
        if self.device.type == "cuda":
            # the kernel library (K1, K3) is built and loaded here, outside
            # every lock: left to the first apply, that would run under
            # _pub_lock and park every pull for the load (or a cold build)
            t0 = time.perf_counter()
            cuda_build.load()
            self.kernel_load_s = time.perf_counter() - t0
        self.updater = updater
        self.range = key_range
        self.vdim = int(vdim)
        self.state = updater.init(key_range.size, self.vdim, device=self.device)
        # the publish lock (module docstring): every in-place apply and
        # every gather a reply is built from is issued under it, and the
        # version and its publish timestamp (µs epoch) change only under it
        self._pub_lock = threading.Lock()
        self._version = _ver_base() + 1
        self._pts = now_wall_us()
        self._serve_cfg = svcfg
        # freshness plane: this range's traffic/age matrix (per-range
        # counters+hists riding the ordinary telemetry namespaces)
        self._range_scope = RangeScope(key_range.begin, key_range.end)
        # single-flight encoded-pull cache: (sig, version, codec) -> entry
        self._enc_lock = threading.Lock()
        self._enc_cache: OrderedDict[tuple, _EncodeEntry] = OrderedDict()
        self._enc_cap = max(0, int(svcfg.encode_cache_entries))
        self._enc_bytes = 0  # filled entries' payload bytes (LRU-bounded)
        self._enc_bytes_max = max(0, int(svcfg.encode_cache_mb)) << 20
        # hot-key detection: pull counts per key-set signature (advisory:
        # a lost increment under a race only delays hotness by a pull)
        self._hot_counts = _LruSigs(cap=4096)
        # host weights snapshot: (version, whole weights table on the
        # host), taken on the first hot conditional pull of a version and
        # shared by every encode at that version; swapped as one tuple
        self._host_w: tuple[int, np.ndarray] | None = None
        self._key_cache = _LruSigs()  # (worker, sig) -> key array
        # the apply lock: the ledger check, the apply and the ledger record
        # of one batch (or one serial push) are one unit
        self._lock = threading.Lock()
        self._max_batch = max(1, int(scfg.max_batch))
        # adaptive batch ceiling ([server] adaptive_batch): ramp the drain
        # bound to the observed arrival rate, doubling while batches fill
        # and the queue stays hot, halving when arrivals go sparse;
        # max_batch stays the hard ceiling
        self._adaptive_batch = bool(scfg.adaptive_batch)
        self._eff_batch = (
            min(4, self._max_batch) if self._adaptive_batch else self._max_batch
        )
        self._apply_q: queue_mod.Queue[_QueuedPush] | None = (
            queue_mod.Queue(maxsize=int(scfg.apply_queue))
            if scfg.apply_queue > 0
            else None
        )
        self._apply_open = self._apply_q is not None
        self._apply_thread: threading.Thread | None = None
        self._ckpt_write_lock = threading.Lock()  # one dump writer at a time
        self._ckpt_thread: threading.Thread | None = None
        self._ctr_lock = threading.Lock()  # counters bumped by conn threads
        # durable push dedup: cid -> recently applied push seqs (str-keyed).
        # Mutated ONLY under self._lock, in the same critical section as
        # the apply it describes, so a push that reaches the engine twice
        # (a duplicate within one batch, or a resend after the reply
        # cache evicted it) is acked without applying again.
        self._applied_push: OrderedDict[str, OrderedDict[str, None]] = OrderedDict()
        self.counters = {
            "pulls": 0, "pushes": 0, "cache_hits": 0, "need_keys": 0,
            "push_replays": 0, "apply_batches": 0, "push_coalesced": 0,
            # serving plane: conditional pulls answered without a payload,
            # pulls shed under overload, real row encodes, and encodes
            # shared across pulls by the single-flight cache
            "not_modified": 0, "shed": 0, "pull_encodes": 0,
            "encode_reuse": 0,
        }
        if host in ("0.0.0.0", "::", "") and not advertise_host:
            raise ValueError(
                "binding a wildcard address requires advertise_host: "
                "publishing 0.0.0.0 would point remote workers at their "
                "own loopback"
            )
        self.server = RpcServer(
            self._handle, host, port, fault_plan=fault_plan,
            # pull/dump/stats re-apply harmlessly — bypassing the reply
            # cache keeps their row-payload replies from being pinned
            idempotent_cmds=frozenset({"pull", "dump", "stats"}),
            expose_identity=True,  # push branch keeps the durable ledger
            lane_hi=scfg.lane_hi,
            lane_lo=scfg.lane_lo,
            withheld_max_bytes=scfg.withheld_max_mb << 20,
            # this server decodes the per-segment quantized codec: acking
            # "qwire" is what lets a quantized client leave the float path
            features=frozenset({"qwire"}),
        )
        _, bound_port = self.server.address.rsplit(":", 1)
        self.address = f"{advertise_host or host}:{bound_port}"
        # lockset race witness (PS_RACE_WITNESS=1): the encode-cache
        # byte budget moves under _enc_lock, and the durable ledger is
        # read and recorded under _lock (the apply engine's batch, the
        # serial push path) and replaced under _lock and _pub_lock by a
        # restore — the two pieces of serving/apply state a refactor is
        # most likely to touch lock-free by accident
        race_track(
            self, ("_enc_bytes", "_applied_push"),
            f"ShardServer:{self.address}",
        )

    # push-ledger bounds: wider than the reply cache's — entries are tiny
    # (short strings) and must cover more than the last in-flight call per
    # client
    _LEDGER_SEQS = 64
    _LEDGER_CLIENTS = 1024

    def _record_push(self, cid: str, seq: str) -> None:
        """Record an applied push in the dedup ledger. Caller holds
        ``self._lock``."""
        per = self._applied_push.get(cid)
        if per is None:
            per = self._applied_push[cid] = OrderedDict()
            while len(self._applied_push) > self._LEDGER_CLIENTS:
                self._applied_push.popitem(last=False)
        else:
            self._applied_push.move_to_end(cid)
        per[seq] = None
        while len(per) > self._LEDGER_SEQS:
            per.popitem(last=False)

    def _bump(self, name: str) -> None:
        with self._ctr_lock:
            self.counters[name] += 1

    @property
    def version(self) -> int:
        """The current published version (opaque; see the module
        docstring)."""
        with self._pub_lock:
            return self._version

    def _publish(self) -> None:
        """Move the version and its publish timestamp. Caller holds
        ``_pub_lock``, in the same hold that issued the change."""
        self._version += 1
        self._pts = now_wall_us()
        # flight recorder: every publish, whatever the writer — the
        # postmortem's version-regression detector reads this stream
        flightrec.record("rcu.publish", ver=self._version)

    # -- serving plane: overload signal + single-flight encode cache ------

    def overloaded(self) -> bool:
        """Admission-control signal (``[serve] shed_*``): the apply queue
        is backing up or this server's withheld coalesced replies pin too
        many bytes: time to shed cache-backed pulls."""
        svcfg = self._serve_cfg
        if (
            svcfg.shed_queue_depth > 0
            and self._apply_q is not None
            and self._apply_q.qsize() >= svcfg.shed_queue_depth
        ):
            return True
        mb = svcfg.shed_withheld_mb
        return mb > 0 and self.server.withheld_bytes() >= (mb << 20)

    def _note_pull(self, sig: str) -> bool:
        """Count one pull of this key-set signature; True once the sig is
        hot (its encoded reply is worth caching). The threshold keeps
        one-off training sweeps out of the encode cache."""
        c = (self._hot_counts.get(sig) or 0) + 1
        self._hot_counts.put(sig, c)
        if c == self._serve_cfg.hot_min_pulls:
            wire_counters.inc("serve_hot_keys")
        return c >= self._serve_cfg.hot_min_pulls

    def _enc_claim(self, ck: tuple) -> tuple[_EncodeEntry, bool]:
        """(entry, owner): owner=True means this pull computes the
        encode; False means another pull (possibly already finished) owns
        it and the entry's event and result are to be shared."""
        with self._enc_lock:
            ent = self._enc_cache.get(ck)
            if ent is not None:
                self._enc_cache.move_to_end(ck)
                return ent, False
            ent = self._enc_cache[ck] = _EncodeEntry()
            self._enc_evict_over_budget()
            return ent, True

    def _enc_evict_over_budget(self) -> None:
        """LRU-evict past the entry AND byte budgets (caller holds
        ``_enc_lock``): each filled entry pins its reply payload."""
        while self._enc_cache and (
            len(self._enc_cache) > self._enc_cap
            or self._enc_bytes > self._enc_bytes_max
        ):
            _, old = self._enc_cache.popitem(last=False)
            self._enc_bytes -= old.nbytes

    def _enc_fill(
        self, ck: tuple, ent: _EncodeEntry, rep: dict[str, Any], arrays: Arrays,
    ) -> None:
        """Publish the owner's finished encode to its followers and count
        its payload against the byte budget (only while the entry is still
        cached: a concurrent eviction wins)."""
        nb = sum(int(a.nbytes) for a in arrays.values())
        with self._enc_lock:
            ent.rep, ent.arrays = rep, arrays
            if self._enc_cache.get(ck) is ent:
                ent.nbytes = nb
                self._enc_bytes += nb
                self._enc_evict_over_budget()
        ent.event.set()

    def _enc_fail(self, ck: tuple, ent: _EncodeEntry) -> None:
        """The owner's encode raised, or its rows are not of the claimed
        version: drop the entry and release any followers (they see
        ``rep is None`` and encode for themselves)."""
        with self._enc_lock:
            if self._enc_cache.get(ck) is ent:
                del self._enc_cache[ck]
        ent.event.set()

    def start(self) -> "ShardServer":
        self._start_apply_thread()
        self.server.start()
        return self

    def serve_forever(self) -> None:
        """Start serving and block until a ``shutdown`` stops the server;
        the apply thread has exited when this returns."""
        self.start()
        while not self.server._stop.wait(0.2):
            pass
        self.join()

    def join(self, timeout: float | None = None) -> None:
        """Wait for the apply thread to exit after a ``shutdown``."""
        if self._apply_thread is not None:
            self._apply_thread.join(timeout)

    # -- checkpoint/restart (ref: each server dumps its own key range;
    # resume = reload the range before continuing) ------------------------

    def _ckpt_path(self, ckpt_dir: str) -> str:
        r = self.range
        return os.path.join(ckpt_dir, f"server-{r.begin}-{r.end}.npz")

    def save_state(self, ckpt_dir: str) -> None:
        """Atomic dump of this range's updater state, in the JAX server's
        file name and layout (its tables and the ``__push_ledger__``), so
        either package's server loads the other's dump. Tmp + rename: a
        crash mid-write never leaves a torn checkpoint; writers serialize.

        The tables change in place, so the state is captured as a device
        copy of every table, taken under the apply lock and the publish
        lock together with the ledger: the dump holds exactly the pushes
        its ledger lists. On the card the copies are enqueued on the one
        current stream before any later apply, so an apply issued after
        the locks are released is not in them. The device-to-host copy
        and the write run outside the locks."""
        with trace.span(
            "server.checkpoint.save", cat="ckpt",
            range=f"{self.range.begin}-{self.range.end}",
        ):
            with self._lock, self._pub_lock:
                state = {k: v.clone() for k, v in self.state.items()}
                ledger = json.dumps(
                    {cid: list(per) for cid, per in self._applied_push.items()}
                )
            host = {k: v.cpu().numpy() for k, v in state.items()}
            del state
            with self._ckpt_write_lock:
                os.makedirs(ckpt_dir, exist_ok=True)
                path = self._ckpt_path(ckpt_dir)
                tmp = path + ".tmp.npz"  # .npz: savez must not append one
                np.savez(
                    tmp,
                    __push_ledger__=np.frombuffer(ledger.encode(), dtype=np.uint8),
                    **host,
                )
                os.replace(tmp, path)

    def load_state(self, ckpt_dir: str) -> bool:
        """Load this range's dump if one exists; False when absent. The
        host-to-device copies run outside the locks; the new tables and
        the ledger are swapped in under them, as one unit."""
        path = self._ckpt_path(ckpt_dir)
        if not os.path.exists(path):
            return False
        with trace.span("server.checkpoint.load", cat="ckpt"), np.load(path) as z:
            host = {k: z[k] for k in z.files}
        ledger_raw = host.pop("__push_ledger__", None)
        if set(host) != set(self.state) or any(
            host[k].shape != tuple(self.state[k].shape) for k in host
        ):
            raise ValueError(
                f"checkpoint {path} does not match this server's state "
                "layout (different updater or key range?)"
            )
        applied: OrderedDict[str, OrderedDict[str, None]] = OrderedDict()
        if ledger_raw is not None:  # absent in pre-ledger checkpoints
            for cid, seqs in json.loads(ledger_raw.tobytes().decode()).items():
                applied[cid] = OrderedDict((str(s), None) for s in seqs)
        new_state = {
            k: torch.from_numpy(_host_array(v, np.float32)).to(self.device)
            for k, v in host.items()
        }
        with self._lock, self._pub_lock:
            self.state = new_state
            self._applied_push = applied
            # a restored table is a new life: a version cached against
            # the rows this restore replaced must never validate
            self._version = _ver_base()
            self._publish()
        return True

    def start_checkpointing(self, ckpt_dir: str, interval_s: float) -> None:
        """Background periodic dumps until the server stops (pushes since
        the last dump are lost on a crash: the bounded-staleness price of
        checkpoint recovery)."""

        def loop() -> None:
            while not self.server._stop.wait(interval_s):
                self.save_state(ckpt_dir)

        self._ckpt_thread = threading.Thread(
            target=loop, daemon=True, name="ps-ckpt"
        )
        self._ckpt_thread.start()

    def stop_checkpointing(self) -> None:
        """Join the periodic dump thread (the stop event must already be
        set: ``serve_forever`` has returned)."""
        if self._ckpt_thread is not None:
            self._ckpt_thread.join(timeout=30)
            self._ckpt_thread = None

    # -- the state, in place under the publish lock -------------------------

    def _apply(self, idx: np.ndarray, grad: np.ndarray) -> int:
        """Apply one coalesced push in place and bump the version; returns
        the version it published, read in the same publish-lock hold.

        ``idx`` holds the union's unique keys only. The JAX engine pads
        the union to a power of two with PAD_KEY 0 and zero gradients
        (``coalesce_pushes(..., pad_to_pow2=True)``,
        ``parameter_server_tpu/parallel/multislice.py:697``) to bound its
        compile count; the port compiles nothing, and on a server whose
        range begins above 0 local row 0 is a real key: a pad slot on it
        beside the key's own slot would be a write race in K1 and K3,
        which take each key at most once and store without atomics
        (``csrc/adagrad.cu:60-63``). A single push whose keys repeat (the
        JAX ``.at[].add`` of its rows) goes through ``push_repeated``:
        gather, a delta an occurrence, ``index_add_``, no kernel."""
        t0 = time.perf_counter() if self.first_apply_s is None else 0.0
        i = torch.from_numpy(_host_array(idx, np.int64)).to(self.device)
        g = torch.from_numpy(_host_array(grad, np.float32)).to(self.device).reshape(len(idx), -1)
        push = kv_store.push if _strictly_unique(idx) else kv_store.push_repeated
        with self._pub_lock:
            # psl: ignore[blocking-under-lock]: the K1/K3 launch under the publish lock is the counterpart of the JAX server's jitted apply under its apply lock (rows and version move in one hold); on the card it only enqueues on the current stream: i and g are on the device already (the store's host asarray and .to() do nothing to them), and a card server loaded the kernel library at start, so no build or load runs in this hold
            push(self.updater, self.state, i, g)
            self._publish()
            ver = self._version
        if t0:
            self.first_apply_s = time.perf_counter() - t0
        return ver

    def _table_weights(self) -> torch.Tensor:
        """The weights of the whole table as a tensor of its own. Caller
        holds ``_pub_lock``: where the updater's weights ARE a table (SGD,
        AdaGrad), they are cloned, so a later in-place apply cannot reach
        the copy."""
        w = self.updater.weights(self.state)
        if any(w.data_ptr() == v.data_ptr() for v in self.state.values()):
            w = w.clone()
        return w

    def _host_weights(self, ver: int, w: torch.Tensor) -> np.ndarray:
        """The host snapshot of version ``ver``: ``w`` is the table's
        weights as issued under the publish lock at ``ver``
        (``_table_weights``); the device-to-host copy runs here, outside
        the lock, and is kept for every later encode at ``ver``. Two
        threads materializing a fresh version duplicate bounded work; the
        tuple swap is last-writer-wins, never torn."""
        host = w.cpu().numpy().reshape(self.range.size, -1)
        self._host_w = (ver, host)
        return host

    def _gather_weights(
        self, keys: np.ndarray, snap: bool = False
    ) -> tuple[np.ndarray, int, int]:
        """(U, vdim) host weights of ``keys`` and the (version, publish
        ts) of the table they were read from, both taken in one publish
        lock hold. A host snapshot already taken at that version serves
        the rows; with ``snap`` (a hot conditional pull of a range within
        ``[serve] snapshot_keys_max``) a missing one is taken here."""
        idx = torch.from_numpy(_host_array(keys, np.int64)).to(self.device)
        full = None
        with self._pub_lock:
            ver, pts = self._version, self._pts
            cur = self._host_w
            if cur is not None and cur[0] == ver:
                return cur[1][keys], ver, pts
            if snap and 0 < self.range.size <= self._serve_cfg.snapshot_keys_max:
                full = self._table_weights()
            else:
                rows = {k: v.index_select(0, idx) for k, v in self.state.items()}
        if full is not None:
            return self._host_weights(ver, full)[keys], ver, pts
        w = self.updater.weights(rows).cpu().numpy().reshape(len(keys), -1)
        return w, ver, pts

    def weights(self) -> np.ndarray:
        """(range size, vdim) host weights of one published state."""
        with self._pub_lock:
            w = self._table_weights()
        return w.cpu().numpy()

    # -- batched apply engine ---------------------------------------------

    def _start_apply_thread(self) -> None:
        if self._apply_q is None or self._apply_thread is not None:
            return
        # watchdog: a non-advancing apply engine is THE server stall the
        # flight recorder exists to catch — busy means work queued or a
        # batch mid-apply; progress is the completed-batch counter. The
        # id suffix keeps the name unique per server instance.
        self._applying = False
        self._wd_name = (
            f"apply:{self.range.begin}-{self.range.end}:{id(self):x}"
        )

        def probe() -> tuple[bool, int]:
            q = self._apply_q
            busy = (q is not None and not q.empty()) or self._applying
            return busy, self.counters["apply_batches"]

        watchdog.register(self._wd_name, probe, thread_name="ps-apply")
        self._apply_thread = threading.Thread(
            target=self._apply_loop, daemon=True, name="ps-apply"
        )
        self._apply_thread.start()

    @staticmethod
    def _fail_stopping(item: _QueuedPush) -> None:
        """Fail a push stranded by engine shutdown with ConnectionError —
        the RPC layer severs the connection instead of sending a clean
        error reply, so the client's transport heal resends the push
        rather than hard-failing the worker on a transient condition."""
        if not item.future.done():
            try:
                item.future.set_exception(ConnectionError(
                    "shard server stopping; push not applied"
                ))
            except Exception:  # noqa: BLE001 — the drain beat us to it
                pass

    def _enqueue_push(self, item: _QueuedPush) -> None:
        """Admit one decoded push into the apply queue (backpressure: a
        full queue parks this serving thread until the engine drains).
        Never raises — a shutdown race resolves the item's future with
        ConnectionError instead (see _fail_stopping)."""
        q = self._apply_q
        assert q is not None
        observe_scalar("server.apply_queue.n", q.qsize() + 1)
        trace.counter("server.apply_queue_depth", q.qsize() + 1)
        while True:
            if not self._apply_open:
                self._fail_stopping(item)
                return
            try:
                q.put(item, timeout=0.05)
            except queue_mod.Full:
                continue
            if not self._apply_open:
                # raced with engine shutdown: the grace drain may already
                # have finished, leaving this item parked in a queue
                # nobody drains — fail it here (drain may also have)
                self._fail_stopping(item)
            return

    def _apply_loop(self) -> None:
        """The apply thread: drain whatever pushes have concurrently
        arrived (bounded by max_batch) and apply them as ONE coalesced
        update. Exits once the server stops, failing stragglers so no
        serving thread parks on an unresolvable deferred reply."""
        q = self._apply_q
        assert q is not None
        stop = self.server._stop
        try:
            while not stop.is_set():
                try:
                    first = q.get(timeout=0.2)
                except queue_mod.Empty:
                    continue
                self._applying = True
                try:
                    batch = [first]
                    limit = self._eff_batch if self._adaptive_batch else self._max_batch
                    while len(batch) < limit:
                        try:
                            batch.append(q.get_nowait())
                        except queue_mod.Empty:
                            break
                    if self._adaptive_batch:
                        self._adapt_batch(len(batch), q.qsize())
                    try:
                        self._apply_batch(batch)
                    except Exception:  # noqa: BLE001 — isolate the offender
                        # one malformed push (bad grad shape, poison
                        # payload) must not fail the innocent pushes it
                        # happened to coalesce with: each item re-runs as
                        # its own batch and only the offender's future
                        # fails (a failing batch raises before it mutates
                        # a table: coalescing and the device copies come
                        # first)
                        for p in batch:
                            if p.future.done():
                                continue
                            try:
                                self._apply_batch([p])
                            except Exception as e1:  # noqa: BLE001
                                if not p.future.done():
                                    p.future.set_exception(e1)
                finally:
                    self._applying = False
        finally:
            # the watchdog must stop probing a dead engine (and a
            # re-start() after stop re-registers a fresh probe)
            watchdog.unregister(self._wd_name)
        self._apply_open = False
        deadline = time.monotonic() + 0.5  # grace: racing enqueuers land
        while time.monotonic() < deadline:
            try:
                p = q.get_nowait()
            except queue_mod.Empty:
                time.sleep(0.05)
                continue
            self._fail_stopping(p)

    def _adapt_batch(self, got: int, backlog: int) -> None:
        """Adaptive batch-ceiling policy (``[server] adaptive_batch``),
        called by the apply thread after each drain with the batch it
        collected and the queue depth left behind. A full batch with more
        still queued means arrivals outpace the ceiling: double it. A
        batch far below the ceiling means arrivals are sparse: halve it,
        so a slow client's trickle applies at low latency instead of
        waiting to fill a ceiling sized for a burst. Every change bumps
        ``server_batch_adapts``; ``max_batch`` stays the hard ceiling."""
        eff = self._eff_batch
        if got >= eff and backlog > 0 and eff < self._max_batch:
            self._eff_batch = min(eff * 2, self._max_batch)
        elif got <= max(1, eff // 4) and eff > 1:
            self._eff_batch = max(1, eff // 2)
        if self._eff_batch != eff:
            wire_counters.inc("server_batch_adapts")

    def _apply_batch(self, batch: list[_QueuedPush]) -> None:
        """Coalesce and apply one batch: segment-sum duplicate keys across
        the batch's pushes, ONE updater apply over the union of touched
        rows, the whole batch recorded in the ledger in the same critical
        section."""
        flightrec.record("apply.begin", pushes=len(batch))
        todo: list[_QueuedPush] = []
        dups: list[_QueuedPush] = []
        commit_ver = 0
        t_apply0 = t_apply1 = 0.0
        with self._lock:
            seen: set[tuple[str | None, str | None]] = set()
            for p in batch:
                if p.cid is not None:
                    per = self._applied_push.get(p.cid)
                    if per is not None and p.seq in per:
                        # already applied (and ledgered): ack immediately
                        self._bump("push_replays")
                        wire_counters.inc("rpc_dedup_hits")
                        flightrec.record(
                            "apply.replay", cid=p.cid, seq=p.seq,
                        )
                        if not p.future.done():
                            p.future.set_result(({"ok": True}, {}))
                        continue
                    if (p.cid, p.seq) in seen:
                        # duplicate within THIS batch: its first instance
                        # has not applied yet, so the ack must WAIT for
                        # the apply — acking now would break 'acked =>
                        # applied' if the apply then fails
                        self._bump("push_replays")
                        wire_counters.inc("rpc_dedup_hits")
                        dups.append(p)
                        continue
                    seen.add((p.cid, p.seq))
                todo.append(p)
            if todo:
                t_apply0 = time.perf_counter()
                # psl: ignore[blocking-under-lock]: the apply lock must span the ledger check, the coalesce + in-place K1/K3 apply and the publish — the serial raw-frame path mutates state under this same lock, so an unlocked compute window would lose any raw push that interleaved
                idx, grad = kv_store.coalesce_pushes(
                    [p.keys for p in todo], [p.grad for p in todo]
                )
                with trace.span(
                    "server.apply_batch", cat="ps",
                    pushes=len(todo), keys=len(idx),
                ):
                    # psl: ignore[blocking-under-lock]: same unit as the coalesce above — ledger check, in-place apply and publish are one atomic section vs the serial raw-frame path
                    commit_ver = self._apply(idx, grad)
                    for p in todo:
                        if p.cid is not None:
                            self._record_push(p.cid, p.seq)
        t_apply1 = time.perf_counter()
        apl_us = int(max(t_apply1 - t_apply0, 0.0) * 1e6) if todo else 0
        if todo:
            # the postmortem's acked-vs-applied ledger: every (cid, seq)
            # this commit applied, against the version it produced (the
            # full batch, never a slice)
            flightrec.record(
                "apply.commit", ver=commit_ver, pushes=len(todo),
                pairs=[
                    [p.cid, p.seq] for p in todo if p.cid is not None
                ],
            )
            # per-range matrix: applied pushes, their payload bytes and
            # the apply's cost (the batch's, once: the coalesced apply is
            # this range's cost, not per push). On the card this is the
            # host time that issues the apply, as the JAX server's is its
            # dispatch time: nothing here waits for the device
            self._range_scope.push(
                len(todo), sum(int(p.grad.nbytes) for p in todo)
            )
            self._range_scope.apply(max(t_apply1 - t_apply0, 0.0))
        with self._ctr_lock:
            self.counters["pushes"] += len(todo)
            self.counters["apply_batches"] += 1
            # only genuinely APPLIED pushes count as coalesced
            self.counters["push_coalesced"] += max(len(todo) - 1, 0)
        if len(todo) > 1:
            wire_counters.inc("push_coalesced", len(todo) - 1)
        observe_scalar("server.apply_batch.n", len(batch))
        trace.counter("server.apply_batch_size", len(batch))
        if trace.enabled():
            # per-push updater spans re-join each caller's trace across
            # the thread hop (one logical push is one trace id: client
            # span -> dispatch span -> updater span). The marker fires
            # after the batch applied, with the measured queue-wait and
            # apply split as args
            for p in todo:
                with trace.activate(p.tctx), trace.span(
                    "server.updater", cat="ps",
                    keys=len(p.keys), batched=len(todo),
                    apw_us=int(max(t_apply0 - p.t_enq, 0.0) * 1e6),
                    apl_us=apl_us,
                ):
                    pass
        # dups resolve here too: the apply they waited on has happened.
        # The reply carries the queue wait (_apw_us) and the apply's host
        # time (_apl_us), as the JAX server's does.
        for p in todo + dups:
            if not p.future.done():  # the shutdown race may fail one first
                try:
                    p.future.set_result((
                        {
                            "ok": True,
                            "_apw_us": int(
                                max(t_apply0 - p.t_enq, 0.0) * 1e6
                            ),
                            "_apl_us": apl_us,
                        },
                        {},
                    ))
                except Exception:  # noqa: BLE001 — lost the race benignly
                    pass
        # per-key heat of every push the batch took, once its replies are
        # out. The JAX server counts a push's keys as its serving thread
        # decodes it; a serving thread that spent ~1 ms a push on the
        # sketch handed the engine one push at a time, and concurrent
        # pushes to a card server stopped coalescing
        for p in batch:
            key_heat.add(p.keys + self.range.begin)

    # -- request handling ---------------------------------------------------

    def _resolve_keys(
        self, h: dict[str, Any], arrays: Arrays
    ) -> np.ndarray | None:
        """Key-caching filter, server side: prefer the cached list for this
        (worker, signature); fall back to the sent keys and cache them."""
        ck = (int(h["worker"]), h["sig"])
        if "keys" in arrays:
            keys = arrays["keys"].astype(np.int64)
            self._key_cache.put(ck, keys)
            return keys
        keys = self._key_cache.get(ck)
        if keys is None:
            self._bump("need_keys")
            return None
        self._bump("cache_hits")
        return keys

    def _handle(self, h: dict[str, Any], arrays: Arrays):
        cmd = h["cmd"]
        if cmd == "pull":
            return self._handle_pull(h, arrays)
        if cmd == "push":
            cid = h.get("_cid")
            seq = None if cid is None else str(h.get("_seq"))
            if cid is not None:
                with self._lock:
                    per = self._applied_push.get(cid)
                    if per is not None and seq in per:
                        # this exact push already applied; its reply was
                        # lost and the resend must not re-apply
                        self._bump("push_replays")
                        wire_counters.inc("rpc_dedup_hits")
                        flightrec.record("apply.replay", cid=cid, seq=seq)
                        return {"ok": True}, {}
            keys = self._resolve_keys(h, arrays)
            if keys is None:
                # _transient: nothing committed — the reply cache must NOT
                # pin this bounce, so the keyed follow-up (same seq) re-runs
                return {"ok": True, "need_keys": True, "_transient": True}, {}
            g = self._decode_grad(h, arrays).reshape(len(keys), -1)
            if (
                self._apply_q is not None
                and self._apply_thread is not None
                and cid is not None
            ):
                # batched apply engine: enqueue the DECODED push and defer
                # the reply — the serving thread keeps draining buffered
                # requests and the RPC layer settles this reply once the
                # batch applied, so an acked push is an applied one. Raw
                # no-cid frames and a handler driven directly (no
                # start()) keep the inline path.
                item = _QueuedPush(
                    _host_array(keys, np.int64), _host_array(g, np.float32),
                    cid, seq,
                    # the dispatch span's identity: the apply thread's
                    # server.updater span re-joins this push's trace
                    tctx=trace.wire_context() if trace.enabled() else None,
                )
                self._enqueue_push(item)
                return DeferredReply(item.future), {}
            # serial path ([server] apply_queue = 0): apply inline under
            # the apply lock; pushed global keys feed the heat sketch
            key_heat.add(np.asarray(keys, np.int64) + self.range.begin)
            with trace.span("server.updater", cat="ps", keys=len(keys)):
                with self._lock:
                    # psl: ignore[blocking-under-lock]: the serial path ([server] apply_queue = 0) applies INLINE under the write lock by definition — that serialization is the pre-engine baseline discipline the engine is benchmarked against
                    serial_ver = self._apply(keys, g)
                    if cid is not None:
                        self._record_push(cid, seq)
            self._bump("pushes")
            self._range_scope.push(1, int(g.nbytes))
            flightrec.record(
                "apply.commit", ver=serial_ver, pushes=1,
                pairs=[[cid, seq]] if cid is not None else [],
            )
            return {"ok": True}, {}
        if cmd == "dump":
            return {"ok": True, "begin": self.range.begin, "end": self.range.end}, {
                "w": self.weights()
            }
        if cmd == "stats":
            rep = {
                "ok": True,
                **self.counters,
                # NOT the key "ver": that is a binary-header-v2 slot, and
                # stats replies stay v1-decodable
                "state_ver": self.version,
                "bytes_out": self.server.bytes_out,
                "bytes_in": self.server.bytes_in,
                "frames_in": self.server.frames_in,
                "cached_sigs": len(self._key_cache),
                # process-wide counters, as the JAX server reports them
                "rpc_dedup_hits": wire_counters.get("rpc_dedup_hits"),
                "wire_quant_bytes_saved": wire_counters.get(
                    "wire_quant_bytes_saved"
                ),
            }
            faults = self.server.fault_stats()
            if faults is not None:
                rep["faults"] = faults
            return rep, {}
        if cmd == "shutdown":
            raise RpcServer.Shutdown
        raise ValueError(f"unknown server command {cmd!r}")

    def _handle_pull(
        self, h: dict[str, Any], arrays: Arrays
    ) -> tuple[dict[str, Any], Arrays]:
        """The read path, in the JAX server's order:

        1. conditional pull: ``if_newer=<ver>`` equal to the current
           version answers ``not_modified``: no gather, no payload;
        2. admission control: under overload, a revalidation the client
           flagged ``shed_ok`` (it holds a within-bounds cached fallback)
           is shed with a retry-after hint;
        3. single-flight encode: pulls of a hot key set at one version
           share one encoded reply.

        Replies to version-aware pulls (``sv: 1``, sent by serving
        handles; implied by ``if_newer``) carry ``ver`` and ``pts``, the
        version and publish time of exactly the table the rows were
        gathered from (read in the gather's publish-lock hold); other
        pulls get the reply shape without them, byte for byte as
        before."""
        keys = self._resolve_keys(h, arrays)
        if keys is None:
            return {"ok": True, "need_keys": True}, {}
        with self._pub_lock:
            ver, pts = self._version, self._pts
        ifn = h.get("if_newer")
        sv = bool(h.get("sv")) or ifn is not None
        if ifn is not None and int(ifn) == ver:
            # the client's cached rows ARE this version (equality, not
            # ordering: versions are opaque per-life ids)
            self._bump("pulls")
            self._bump("not_modified")
            wire_counters.inc("serve_not_modified")
            self._range_scope.pull(0)
            return {"ok": True, "not_modified": True, "ver": ver, "pts": pts}, {}
        if ifn is not None and h.get("shed_ok") and self.overloaded():
            # shed: the client holds a cached fallback within its
            # staleness ceiling. No ``ver``: nothing was validated.
            self._bump("pulls")
            self._bump("shed")
            wire_counters.inc("serve_shed")
            flightrec.record("serve.shed", sig=h.get("sig"))
            return {"ok": True, "not_modified": True, "shed": True,
                    "retry_after_ms": self._serve_cfg.retry_after_ms}, {}
        qn = int(h.get("quant", 0))
        ent = None
        hot = self._enc_cap > 0 and self._note_pull(h["sig"])
        # sv is part of the key: a version-stamped reply cached for a
        # serving client must never be replayed to one that did not ask
        ck = (h["sig"], ver, qn, int(h.get("qseg", 256)), bool(h.get("zip")), sv)
        if hot:
            ent, owner = self._enc_claim(ck)
            if not owner:
                # single-flight: another pull of the same keys at the same
                # version owns the encode: share its buffers
                if ent.event.wait(timeout=5.0) and ent.rep is not None:
                    self._bump("pulls")
                    self._bump("encode_reuse")
                    wire_counters.inc("serve_encode_reuse")
                    self._range_scope.pull(
                        sum(a.nbytes for a in ent.arrays.values())
                    )
                    self._range_scope.age(skew_clamped_age_s(pts))
                    return ent.rep, ent.arrays
                ent = None  # owner failed or timed out: encode ourselves
        try:
            # the host snapshot is taken only for a hot conditional pull
            # (``if_newer`` proves a caching serving client): a training
            # tier with per-step version churn must never pay a whole-
            # table copy a step because its key sets went hot
            rep, out, ver_g, pts_g = self._encode_pull(
                keys, h, qn, hot and ifn is not None, with_ver=sv,
            )
        except BaseException:
            if ent is not None:
                self._enc_fail(ck, ent)
            raise
        self._bump("pulls")
        self._bump("pull_encodes")
        # per-range matrix: rows left this range at their table's age
        self._range_scope.pull(sum(a.nbytes for a in out.values()))
        self._range_scope.age(skew_clamped_age_s(pts_g))
        if ent is not None:
            if ver_g == ver:
                self._enc_fill(ck, ent, rep, out)
            else:
                # an apply landed between the version read and the
                # gather: these rows are of a later table than the key
                self._enc_fail(ck, ent)
        return rep, out

    def _encode_pull(
        self, keys: np.ndarray, h: dict[str, Any], qn: int, snap: bool = False,
        with_ver: bool = False,
    ) -> tuple[dict[str, Any], Arrays, int, int]:
        """Gather and encode one pull reply (shared verbatim across
        clients by the single-flight cache: nothing here may depend on
        the requesting connection): float32 rows or, for a
        quant-negotiated ``quant`` request, round-to-nearest per-segment
        integers. Returns the reply, its arrays and the version and
        publish ts of the table the rows were gathered from."""
        # per-key heat, read side: only real row encodes count (a
        # not_modified / shed / single-flight-reused reply moves no rows)
        key_heat.add(np.asarray(keys, np.int64) + self.range.begin)
        w, ver, pts = self._gather_weights(keys, snap)
        if qn:
            # quantized pull (read-mostly traffic): round-to-NEAREST, not
            # stochastic — reads have no error-feedback loop, and repeated
            # reads of one unchanged state stay bit-identical
            from parameter_server_tpu_torch.filters.quant import SegmentQuantizer

            qz = SegmentQuantizer(qn, int(h.get("qseg", 256)))
            q, qs = qz.encode_nearest(w.ravel())
            wire_counters.inc(
                "wire_quant_bytes_saved",
                # psl: ignore[idtype]: w holds float32 rows, not a version: it carries id:ver only because _gather_weights returns (w, ver, pts) as one tuple, whose elements the dataflow joins
                max(w.nbytes - q.nbytes - qs.nbytes, 0),
            )
            rep: dict[str, Any] = {"ok": True, "codec": qn, "qseg": qz.seg}
            out: Arrays = {"q": q, "qs": qs}
        else:
            rep, out = {"ok": True, "zip": h.get("zip", False)}, {"w": w.ravel()}
        if with_ver:  # only version-aware clients (see _handle_pull)
            rep["ver"] = ver
            rep["pts"] = pts  # the wire layer derives each serve's _age_us
        return rep, out, ver, pts

    def _decode_grad(self, h: dict[str, Any], arrays: Arrays) -> np.ndarray:
        """The push's float32 gradient on the host: as sent, the
        per-segment codec (``"qwire"``) decoded on the host, or the
        fixed-point codec decoded on this server's device."""
        codec_bytes = int(h.get("codec", 0))
        if not codec_bytes:
            return arrays["g"]
        if "qs" in arrays:
            from parameter_server_tpu_torch.filters.quant import SegmentQuantizer

            qz = SegmentQuantizer(codec_bytes, int(h.get("qseg", 256)))
            return qz.decode(arrays["q"], arrays["qs"])
        # legacy whole-array affine codec (filters/fixed_point, the
        # un-negotiated [filter] fixing_float_bytes knob)
        from parameter_server_tpu_torch.filters.fixed_point import (
            Encoded,
            FixedPointCodec,
        )

        def dev(a):
            return torch.from_numpy(_host_array(a)).to(self.device)

        e = Encoded(dev(arrays["q"]), dev(arrays["lo"])[0], dev(arrays["scale"])[0])
        return FixedPointCodec(num_bytes=codec_bytes).decode(e).cpu().numpy()


class ServerHandle:
    """Worker-side proxy to one shard server, applying the send filters
    (ref: SharedParameter's per-call FilterConfigs). ``device`` is where
    the fixed-point codec encodes (``[filter] fixing_float_bytes``): K4
    on the card."""

    def __init__(
        self,
        address: str,
        rank: int,
        worker: int,
        cfg: PSConfig,
        range_size: int = 0,
        resolve_addr=None,  # () -> current address, for server-restart recovery
        reconnect_timeout_s: float | None = None,
        serving: bool = False,
        key_cache=None,
        device: Any = "cuda",
        key_range: KeyRange | None = None,
    ):
        """``serving=True`` marks this handle as part of the read-mostly
        serving tier: with ``[serve] cache`` on, it arms the client-side
        versioned key cache (``filters/keycache.py``): pulls are served
        locally within the TTL, revalidated by version past it, and
        invalidated exactly by this handle's own pushes. ``key_cache``
        lets a serving frontend share one cache across all its handles,
        one shard or many: entries and the inverted invalidation index
        are namespaced by this handle's ``rank``. The training tier never
        passes serving=True: its staleness contract is the SSP clock, not
        a TTL (see ``_connect_servers``).

        ``key_range`` (optional) names the server range this handle
        proxies: with it, every serve this client answers (cached,
        bounded-stale, shed-fallback or fresh off the wire) books its
        realized data age into that range's matrix beside the server's
        own bookings."""
        self.device = resolve_device(device)
        self.rank = rank
        self.worker = worker
        self._range_scope = (
            RangeScope(key_range.begin, key_range.end)
            if key_range is not None else None
        )
        self._kcache = None
        if serving and cfg.serve.cache:
            from parameter_server_tpu_torch.filters.keycache import ClientKeyCache

            # `is not None`, NOT `or`: the cache defines __len__, so a
            # shared instance that happens to be empty is falsy
            self._kcache = key_cache if key_cache is not None else ClientKeyCache(
                cap=cfg.serve.cache_entries,
                ttl_s=cfg.serve.ttl_ms / 1e3,
                max_stale_s=cfg.serve.max_stale_ms / 1e3,
            )
        self._resolve_addr = resolve_addr
        self._reconnect_timeout_s = (
            reconnect_timeout_s
            if reconnect_timeout_s is not None
            else cfg.fault.reconnect_timeout_s
        )
        # client-internal same-address retry window: short, so transient
        # connection loss heals in place with the SAME sequence numbers
        # (dedup-safe), while a genuinely moved server falls through to
        # the resolver loop in _keyed_call quickly
        self._client_window_s = min(3.0, self._reconnect_timeout_s)
        self._pipeline_window = max(1, cfg.wire.window)
        self._hdr_codec = cfg.wire.hdr_codec
        self._adaptive_window = cfg.wire.adaptive_window
        # quantized push transport ([wire] quant, filters/quant.py):
        # negotiated per connection via the "qwire" feature advert —
        # until (unless) the peer acks, pushes stay on the float path
        qmode = cfg.wire.quant
        if qmode not in ("off", "int8", "int16"):
            raise ValueError(
                f"[wire] quant must be off|int8|int16, got {qmode!r}"
            )
        self._quant_bytes = {"off": 0, "int8": 1, "int16": 2}[qmode]
        self._quant_pull = bool(cfg.wire.quant_pull) and self._quant_bytes > 0
        self._features = (
            frozenset({"qwire"}) if self._quant_bytes else frozenset()
        )
        if self._quant_bytes:
            from parameter_server_tpu_torch.filters.quant import SegmentQuantizer

            self._quantizer = SegmentQuantizer(
                self._quant_bytes, max(1, int(cfg.wire.quant_seg))
            )
        # error-feedback accumulator: the residual each quantized push
        # loses to rounding, folded into the NEXT push of the same keys.
        # Folded exactly once per logical push at encode time (resends
        # reuse the encoded payload), guarded by its own lock so a
        # recovery-thread re-encode can never race the worker loop.
        self._res_lock = threading.Lock()
        self._residual: np.ndarray | None = None
        self._res_vdim = 0
        self._res_range = int(range_size)
        self._res_map: dict[int, int] | None = None
        self.client = RpcClient(
            address, reconnect_timeout_s=self._client_window_s,
            window=self._pipeline_window,
            hdr_codec=self._hdr_codec,
            adaptive_window=self._adaptive_window,
            features=self._features,
        )
        # a worker's pull and in-flight push threads share this handle;
        # concurrent failures must rebuild the connection once — the
        # generation counter lets a late-arriving failing thread see that
        # another thread already replaced the client and just retry
        self._reconnect_lock = threading.Lock()
        # the recovery executor's own lock: the client's reader thread
        # calls _recovery() from a completion callback and must never park
        # behind a thread sleeping inside _reconnect
        self._pool_lock = threading.Lock()
        self._conn_gen = 0
        self._sent_sigs = _LruSigs()
        self._key_caching = cfg.filter.key_caching
        self._zip = cfg.filter.compressing
        self._codec_bytes = cfg.filter.fixing_float_bytes
        # local (range-relative) keys ride the wire as u32 when the range
        # fits, u64 otherwise — a silent u32 truncation at 10^9+ feature
        # scale would corrupt the model
        self._key_dtype = (
            np.uint64 if range_size > (1 << 32) else np.uint32
        )
        # atomic: concurrent in-flight push threads must not reuse a
        # stochastic-rounding seed
        self._quant_seed = itertools.count()
        # logical-call sequence numbers ("k<n>" — a namespace disjoint from
        # RpcClient's internal integer counter): one per _keyed_call, held
        # constant across client rebuilds so every delivery of a logical
        # push is one dedup identity on the server
        self._kseq = itertools.count()
        # lazy single-thread executor for the RESOLVER retry path of async
        # calls: a reader thread completing a failed future must never run
        # the blocking reconnect loop itself
        self._recovery_pool: ThreadPoolExecutor | None = None
        # watchdog: this handle's client carries only pull/push/dump/stats
        # (nothing that legitimately parks), so in-flight requests whose
        # completions stop moving mean a reader parked past every
        # deadline. ``self.client`` is re-read per poll, so the probe
        # follows recovery rebuilds.
        self._wd_name = f"handle:{rank}:w{worker}:{id(self):x}"
        watchdog.register(
            self._wd_name, lambda: self.client.stall_probe(),
            thread_name="ps-rpc-reader",
        )
        if self._codec_bytes:
            from parameter_server_tpu_torch.filters.fixed_point import FixedPointCodec

            self._codec = FixedPointCodec(num_bytes=self._codec_bytes)
        # lockset race witness (PS_RACE_WITNESS=1): the error-feedback
        # residual state is shared between the worker loop and the
        # recovery/reader threads — every access must hold _res_lock or
        # the exactly-once folding guarantee is a race away from double
        # counting
        race_track(
            self, ("_residual", "_res_map", "_res_vdim"),
            f"ServerHandle:{rank}:w{worker}",
        )

    def _keyed_call(
        self, cmd: str, keys: np.ndarray, arrays: Arrays,
        lseq: str | None = None, **fields,
    ):
        """Issue a keyed request, sending the key list only when the server
        doesn't hold it (key-caching filter, worker side). A lost
        connection triggers reconnect-and-retry against the (possibly
        relaunched) server when a resolver was provided. ``lseq`` re-enters
        a logical call that already holds a dedup identity (the async
        recovery path); fresh calls allocate their own."""
        if lseq is None:
            lseq = f"k{next(self._kseq)}"
        gen = self._conn_gen
        try:
            return self._keyed_call_once(cmd, keys, arrays, lseq, **fields)
        except (ConnectionError, BrokenPipeError, OSError):
            if self._resolve_addr is None:
                raise
        # retry until the reconnect window closes: a connect can land in a
        # dying listen socket's backlog and reset on first use
        t0 = time.monotonic()
        deadline = t0 + self._reconnect_timeout_s
        while True:
            self._reconnect(gen, deadline)
            gen = self._conn_gen
            try:
                return self._keyed_call_once(cmd, keys, arrays, lseq, **fields)
            except (ConnectionError, BrokenPipeError, OSError) as e:
                if time.monotonic() > deadline:
                    raise ConnectionError(
                        f"server rank {self.rank} kept resetting for "
                        f"{time.monotonic() - t0:.1f}s across reconnects: {e}"
                    ) from e
                time.sleep(0.3)

    def _reconnect(self, failed_gen: int, deadline: float | None = None) -> None:
        """Rebuild the connection to wherever this rank's server now lives.
        The relaunch starts with an empty key cache, so our sent-signature
        memory is dropped.

        failed_gen: the connection generation the caller's failure was
        observed on — if another thread already replaced that connection,
        this call must NOT tear the fresh one down, just retry on it."""
        if deadline is None:
            deadline = time.monotonic() + self._reconnect_timeout_s
        with self._reconnect_lock:
            if self._conn_gen != failed_gen:
                return  # a concurrent failure already rebuilt the client
            self.client.close()
            # the rebuilt client must BE the old one to the server's dedup
            # machinery: same cid so retried "k<n>" seqs are recognized,
            # start_seq past the old internal counter so fresh un-keyed
            # calls (dump/stats) can't collide with cached old replies
            cid, next_seq = self.client.identity
            last: Exception | None = None
            while time.monotonic() < deadline:
                try:
                    addr = self._resolve_addr()
                    # psl: ignore[blocking-under-lock]: _reconnect_lock IS the serialization of connection rebuilds — concurrent failing threads must park until exactly one rebuild completes; no completion/reader thread takes it (the recovery pool moved to _pool_lock)
                    self.client = RpcClient(
                        addr, retries=1,
                        reconnect_timeout_s=self._client_window_s,
                        cid=cid, start_seq=next_seq,
                        window=self._pipeline_window,
                        hdr_codec=self._hdr_codec,
                        adaptive_window=self._adaptive_window,
                        features=self._features,
                    )
                    self._sent_sigs = _LruSigs()
                    self._conn_gen += 1
                    return
                except (ConnectionError, OSError) as e:
                    last = e
                    # psl: ignore[blocking-under-lock]: rebuild-retry backoff under the rebuild serialization lock — waiters WANT to park until the one rebuild lands (see the pragma above)
                    time.sleep(0.3)
        raise ConnectionError(
            f"server rank {self.rank} unreachable for "
            f"{self._reconnect_timeout_s}s: {last}"
        )

    def _keyed_call_once(
        self, cmd: str, keys: np.ndarray, arrays: Arrays, lseq: str, **fields
    ):
        sig = _sig(keys)
        send_keys = not (self._key_caching and sig in self._sent_sigs)
        payload = dict(arrays)
        if send_keys:
            payload["keys"] = keys.astype(self._key_dtype)
        rep, out = self.client.call(
            cmd, arrays=payload, worker=self.worker, sig=sig,
            zip=self._zip, _seq=lseq, **fields,
        )
        if rep.get("need_keys"):  # cache miss on a sig we believed was cached
            # SAME lseq: a need_keys bounce is marked non-committing server
            # side, so this follow-up re-runs the handler while the logical
            # mutation keeps a single dedup identity end to end
            payload["keys"] = keys.astype(self._key_dtype)
            rep, out = self.client.call(
                cmd, arrays=payload, worker=self.worker, sig=sig,
                zip=self._zip, _seq=lseq, **fields,
            )
        self._sent_sigs.put(sig)
        return rep, out

    # -- async (pipelined) issue path -------------------------------------

    def _keyed_call_async(
        self, cmd: str, keys: np.ndarray, arrays: Arrays, **fields
    ):
        """Async twin of ``_keyed_call``: issues the request onto the
        client's pipelined window and returns a Future of (rep, arrays).
        The need_keys bounce re-issues with the SAME "k<n>" seq from the
        completion callback (``_urgent``: a reader thread must not block
        on window space it is responsible for freeing), and a connection
        that outlives the client's own heal window falls back to the
        blocking resolver retry loop on the handle's recovery thread."""
        outer: Future = Future()
        lseq = f"k{next(self._kseq)}"
        sig = _sig(keys)
        send_keys = not (self._key_caching and sig in self._sent_sigs)
        payload = dict(arrays)
        if send_keys:
            payload["keys"] = keys.astype(self._key_dtype)

        def on_reply(f, bounced: bool = False) -> None:
            # NOTHING may escape this callback: concurrent.futures logs
            # and swallows done-callback exceptions, which would leave
            # ``outer`` unresolved and its waiter parked forever
            try:
                try:
                    rep, out = f.result()
                except (ConnectionError, BrokenPipeError, OSError):
                    if self._resolve_addr is None:
                        raise
                    self._recovery().submit(
                        self._recover_async, cmd, keys, arrays, lseq,
                        fields, outer,
                    )
                    return
                if rep.get("need_keys"):
                    if bounced:  # keys were in the frame: a repeat is a bug
                        raise RuntimeError(
                            f"server rank {self.rank} bounced a keyed {cmd}"
                        )
                    p2 = dict(arrays)
                    p2["keys"] = keys.astype(self._key_dtype)
                    f2 = self.client.call_async(
                        cmd, arrays=p2, worker=self.worker, sig=sig,
                        zip=self._zip, _seq=lseq, _urgent=True, **fields,
                    )
                    f2.add_done_callback(lambda g: on_reply(g, bounced=True))
                    return
                self._sent_sigs.put(sig)
                outer.set_result((rep, out))
            except BaseException as e:  # noqa: BLE001 — future boundary
                if not outer.done():
                    outer.set_exception(e)

        try:
            f1 = self.client.call_async(
                cmd, arrays=payload, worker=self.worker, sig=sig,
                zip=self._zip, _seq=lseq, **fields,
            )
        except (ConnectionError, BrokenPipeError, OSError):
            if self._resolve_addr is None:
                raise
            self._recovery().submit(
                self._recover_async, cmd, keys, arrays, lseq, fields, outer
            )
            return outer
        f1.add_done_callback(on_reply)
        return outer

    def _recover_async(
        self, cmd, keys, arrays, lseq, fields, outer
    ) -> None:
        """Recovery-thread tail of a failed async call: the synchronous
        resolver retry loop, completing the caller's outer future."""
        try:
            outer.set_result(
                self._keyed_call(cmd, keys, arrays, lseq=lseq, **fields)
            )
        except BaseException as e:  # noqa: BLE001 — future boundary
            outer.set_exception(e)

    def _recovery(self) -> ThreadPoolExecutor:
        with self._pool_lock:
            if self._recovery_pool is None:
                self._recovery_pool = ThreadPoolExecutor(
                    max_workers=1,
                    thread_name_prefix=f"ps-recover-{self.rank}",
                )
            return self._recovery_pool

    def pull_async(self, local_keys: np.ndarray):
        """Issue a pull without blocking; Future of the float32 rows.
        Serving handles consult the key cache first: a fresh entry
        resolves the future at once with no wire traffic."""
        out_f: Future = Future()
        if len(local_keys) == 0:
            out_f.set_result(np.zeros(0, dtype=np.float32))
            return out_f
        extra: dict[str, Any] = {}
        sig = ent = gen = None
        own = False
        if self._kcache is not None:
            vals, extra, sig, ent, own, gen = self._cache_try(local_keys)
            if vals is not None:
                out_f.set_result(vals)
                return out_f
        try:
            with trace.span(
                "ps.pull", cat="ps", rank=self.rank, keys=len(local_keys)
            ):
                flow = trace.flow_start("ps.pull.inflight", cat="ps")
                ctx = trace.wire_context()
                inner = self._keyed_call_async(
                    "pull", local_keys, {}, **self._pull_fields(), **extra
                )
        except BaseException:
            if own:
                self._kcache.end_refresh(sig)
            raise

        def done(f) -> None:
            # nothing may escape (see _keyed_call_async.on_reply)
            try:
                with trace.activate(ctx):
                    trace.flow_end("ps.pull.inflight", cat="ps", flow_id=flow)
                rep, out = f.result()
                if self._kcache is not None:
                    out_f.set_result(
                        self._cache_settle(rep, out, local_keys, sig, ent, own, gen)
                    )
                else:
                    out_f.set_result(self._decode_pull(out))
            except BaseException as e:  # noqa: BLE001 — future boundary
                if own:
                    self._kcache.end_refresh(sig)  # idempotent release
                if not out_f.done():
                    out_f.set_exception(e)

        inner.add_done_callback(done)
        return out_f

    def push_async(self, local_keys: np.ndarray, grads: np.ndarray):
        """Issue a push without blocking; the Future resolves (to None)
        once the server acked the apply. A flow event pair links the issue
        span to the completion event (the in-flight arrow in Perfetto)."""
        done_f: Future = Future()
        if len(local_keys) == 0:
            done_f.set_result(None)
            return done_f
        fields, arrays = self._encode_push(local_keys, grads)
        with trace.span(
            "ps.push", cat="ps", rank=self.rank, keys=len(local_keys),
            bytes=int(sum(a.nbytes for a in arrays.values())),
        ):
            flow = trace.flow_start("ps.push.inflight", cat="ps")
            ctx = trace.wire_context()
            inner = self._keyed_call_async("push", local_keys, arrays, **fields)

        def done(f) -> None:
            # nothing may escape (see _keyed_call_async.on_reply)
            try:
                with trace.activate(ctx):
                    trace.flow_end("ps.push.inflight", cat="ps", flow_id=flow)
                f.result()
                if self._kcache is not None:
                    # second, ack-time invalidation: the server defers the
                    # ack until the batched apply published, so a pull
                    # raced between the encode-time invalidation and this
                    # ack may have re-cached the pre-apply rows: drop
                    # them now, and read-your-writes holds from the moment
                    # this future resolves
                    self._kcache.invalidate_keys(local_keys, rank=self.rank)
                done_f.set_result(None)
            except BaseException as e:  # noqa: BLE001 — future boundary
                if not done_f.done():
                    done_f.set_exception(e)

        inner.add_done_callback(done)
        return done_f

    # -- error-feedback accumulator (quantized transport) ------------------

    #: above this many rows the accumulator switches from a dense
    #: range-indexed array to a compact touched-keys-only map — a sparse
    #: workload on a 10^9-key shard must not allocate the whole range
    #: client-side just because one high key was pushed
    _DENSE_RESIDUAL_ROWS = 1 << 22

    def _res_rows(self, keys: np.ndarray, vdim: int) -> np.ndarray:
        """Row indices into the residual buffer for ``keys``, allocating
        as needed (caller holds ``_res_lock``). Small known ranges index
        the buffer by the range-relative key directly; large or unknown
        ranges go through a compact key->row map."""
        if self._residual is None or self._res_vdim != vdim:
            self._residual = np.zeros((0, vdim), np.float32)
            self._res_vdim = vdim
            self._res_map = (
                None
                if 0 < self._res_range <= self._DENSE_RESIDUAL_ROWS
                else {}
            )
        if self._res_map is None:
            rows = keys
            hi = int(keys.max()) + 1 if len(keys) else 0
        else:
            m = self._res_map
            rows = np.empty(len(keys), np.int64)
            for i, k in enumerate(keys.tolist()):
                j = m.get(k)
                if j is None:
                    j = m[k] = len(m)
                rows[i] = j
            hi = len(m)
        if hi > len(self._residual):
            grown = np.zeros(
                (max(hi, 2 * len(self._residual)), vdim), np.float32
            )
            grown[: len(self._residual)] = self._residual
            self._residual = grown
        return rows

    def residual_rows(self, keys: np.ndarray) -> np.ndarray:
        """Current residual rows for ``keys``, zeros where nothing
        accumulated. Strictly read-only: it never allocates map entries
        or grows the buffer."""
        with self._res_lock:
            if self._residual is None:
                return np.zeros((len(keys), 1), np.float32)
            out = np.zeros((len(keys), self._res_vdim), np.float32)
            if self._res_map is None:
                known = keys < len(self._residual)
                out[known] = self._residual[keys[known]]
            else:
                m = self._res_map
                for i, k in enumerate(keys.tolist()):
                    j = m.get(k)
                    if j is not None:
                        out[i] = self._residual[j]
            return out

    def residual_norm(self) -> float:
        """Mean |residual| over allocated rows."""
        with self._res_lock:
            if self._residual is None:
                return 0.0
            n = (
                len(self._res_map)
                if self._res_map is not None
                else len(self._residual)
            )
            if n == 0:
                return 0.0
            return float(np.abs(self._residual[:n]).mean())

    def _encode_push(
        self, local_keys: np.ndarray, grads: np.ndarray
    ) -> tuple[dict[str, Any], Arrays]:
        """Apply the send filters to one push payload: the negotiated
        per-segment quantized codec with error feedback, the legacy
        fixed-point filter, else f32.

        Called exactly once per LOGICAL push — transport resends, the
        need_keys bounce and the keyed-seq recovery path all reuse the
        returned arrays — so the residual fold happens exactly once. The
        per-segment codec is the JAX handle's numpy encode with the same
        seed counter, so its payload is the JAX handle's byte for byte;
        the fixed-point codec encodes on this handle's device (K4 on the
        card), where the JAX handle draws from threefry: those payloads
        agree with the JAX handle's in distribution only."""
        if self._kcache is not None:
            # exact self-invalidation (serving handles): this handle must
            # never read its own write stale out of its own cache. Done at
            # encode time, once per logical push
            self._kcache.invalidate_keys(local_keys, rank=self.rank)
        fields: dict[str, Any] = {"codec": 0}
        g = grads.astype(np.float32, copy=False).reshape(len(local_keys), -1)
        if self._quant_bytes and "qwire" in self.client.peer_features:
            with self._res_lock:
                rows = self._res_rows(local_keys, g.shape[1])
                g_tot = g + self._residual[rows]
                q, qs = self._quantizer.encode(next(self._quant_seed), g_tot)
                res = g_tot - self._quantizer.decode(q, qs).reshape(
                    g_tot.shape
                )
                self._residual[rows] = res
            arrays: Arrays = {"q": q, "qs": qs}
            fields["codec"] = self._quant_bytes
            fields["qseg"] = self._quantizer.seg
            wire_counters.inc(
                "wire_quant_bytes_saved",
                max(int(g_tot.nbytes) - q.nbytes - qs.nbytes, 0),
            )
        elif self._quant_bytes:
            # quant configured but the peer never acked "qwire" (the
            # pre-negotiation first frames, or an old server): float path
            # — flushing any residual accumulated before a downgrade so no
            # gradient mass is ever stranded
            with self._res_lock:
                if self._residual is not None and len(self._residual):
                    rows = self._res_rows(local_keys, g.shape[1])
                    g = g + self._residual[rows]  # fresh buffer
                    self._residual[rows] = 0.0
                else:
                    g = np.array(g, dtype=np.float32)  # own the buffer
            arrays = {"g": g}
        elif self._codec_bytes:
            x = torch.from_numpy(np.array(grads, dtype=np.float32)).to(self.device)
            e = self._codec.encode(next(self._quant_seed), x)
            arrays = {
                "q": e.q.cpu().numpy(),
                "lo": e.lo.cpu().numpy()[None],
                "scale": e.scale.cpu().numpy()[None],
            }
            fields["codec"] = self._codec_bytes
        else:
            # own the buffer (np.array always copies): the async pipeline
            # serializes at send — and heal RESEND — time, so aliasing
            # the caller's gradient array would let a reused buffer
            # silently corrupt an in-flight push
            arrays = {"g": np.array(g, dtype=np.float32)}
        # push payload accounting (pre-compression, keys excluded)
        wire_counters.inc(
            "wire_push_payload_bytes",
            sum(int(a.nbytes) for a in arrays.values()),
        )
        return fields, arrays

    # -- quantized pull (read-mostly traffic) ------------------------------

    def _pull_fields(self) -> dict[str, Any]:
        """Extra pull request fields: ask for quantized rows only once
        the peer negotiated the codec ([wire] quant_pull)."""
        if self._quant_pull and "qwire" in self.client.peer_features:
            return {"quant": self._quant_bytes, "qseg": self._quantizer.seg}
        return {}

    def _decode_pull(self, out: Arrays) -> np.ndarray:
        """Decode one pull reply: quantized rows when the server sent
        them, the float rows otherwise."""
        if "q" in out:
            return self._quantizer.decode(out["q"], out["qs"])
        return out["w"].astype(np.float32)

    # -- client-side versioned key cache (serving handles only) -----------

    def _book_serve_age(self, age_us: float, src: str) -> None:
        """Book the realized data age one serve handed its consumer
        (``src``: cache, stale, shed, revalidate, pull): the global
        ``serve.age_s`` histogram (what `cli top`'s age column and the
        ``pull_age_ms`` SLO read), this handle's per-range matrix when it
        knows its range, and the flight recorder."""
        age_s = max(float(age_us), 0.0) / 1e6
        latency_histograms.observe("serve.age_s", age_s)
        if self._range_scope is not None:
            self._range_scope.age(age_s)
        flightrec.record(
            "freshness.serve", rank=self.rank, src=src,
            age_us=int(age_us),
        )

    def _cache_try(
        self, local_keys: np.ndarray
    ) -> tuple[np.ndarray | None, dict[str, Any], Any, Any, bool, int]:
        """Consult the key cache for one pull: (locally served rows or
        None, extra wire fields, sig, entry, owns-refresh, the cache's
        invalidation generation at issue). A fresh entry short-circuits
        the wire; a stale one turns the pull into an ``if_newer``
        revalidation, claimed single-flight, so while one caller
        refreshes, concurrent pulls of the same keys serve the
        bounded-stale rows. ``shed_ok`` is advertised only while the
        entry is within the hard staleness ceiling. A caller holding the
        refresh claim must settle it (``_cache_settle`` or
        ``end_refresh``)."""
        # (rank, digest): keys are range-relative, so a shared multi-shard
        # cache must namespace entries by shard
        sig = (self.rank, _sig(local_keys))
        gen = self._kcache.gen
        ent = self._kcache.lookup(sig)
        if ent is None:
            wire_counters.inc("serve_cache_misses")
            return None, {"sv": 1}, sig, None, False, gen
        # one clock reading decides the serve and dates it: the age booked
        # is the age the freshness and ceiling checks passed
        now = time.monotonic()
        if self._kcache.fresh(ent, now):
            wire_counters.inc("serve_cache_hits")
            self._book_serve_age(ent.age_us(now), "cache")
            # a copy: callers own their rows, the cache stays pristine
            return ent.values.copy(), {}, sig, ent, False, gen
        if not self._kcache.begin_refresh(sig):
            if self._kcache.can_shed(ent, now):
                # another thread's refresh is in flight: serve the
                # bounded-stale rows rather than duplicate its round trip
                wire_counters.inc("serve_cache_stale_hits")
                self._book_serve_age(ent.age_us(now), "stale")
                return ent.values.copy(), {}, sig, ent, False, gen
            # past the staleness ceiling: correctness wins
            return None, {"if_newer": ent.version}, sig, ent, False, gen
        fields: dict[str, Any] = {"if_newer": ent.version}
        if self._kcache.can_shed(ent, now):
            fields["shed_ok"] = 1
        return None, fields, sig, ent, True, gen

    def _cache_settle(
        self, rep: dict[str, Any], out: Arrays, local_keys: np.ndarray,
        sig, ent, own: bool = False, gen: int | None = None,
    ) -> np.ndarray:
        """Interpret one pull reply against the cache and return the
        rows. ``ent`` is the entry captured at issue time; ``own``
        releases this pull's refresh claim; ``gen`` makes an install lose
        to any invalidation since the pull was issued."""
        try:
            age = rep.get("_age_us")  # server-measured realized age
            if rep.get("not_modified") and ent is not None:
                if rep.get("shed"):
                    # the server shed our revalidation: keep serving the
                    # cached rows (shed_ok was advertised only inside
                    # max_stale) and back off for retry_after
                    wire_counters.inc("serve_shed_served")
                    self._kcache.shed_backoff(
                        sig, float(rep.get("retry_after_ms", 20)) / 1e3
                    )
                    self._book_serve_age(ent.age_us(), "shed")
                else:
                    self._kcache.revalidated(sig, int(rep["ver"]), age_us=age)
                    self._book_serve_age(
                        age if age is not None else ent.age_us(), "revalidate"
                    )
                return ent.values.copy()
            vals = self._decode_pull(out)
            ver = rep.get("ver")
            if ver is not None:
                self._kcache.put(
                    sig, local_keys, vals, int(ver), as_of=gen,
                    rank=self.rank, age_us=age,
                )
                if age is not None:
                    self._book_serve_age(age, "pull")
            return vals
        finally:
            if own:
                self._kcache.end_refresh(sig)

    def pull(self, local_keys: np.ndarray) -> np.ndarray:
        if len(local_keys) == 0:
            return np.zeros(0, dtype=np.float32)
        extra: dict[str, Any] = {}
        sig = ent = gen = None
        own = False
        if self._kcache is not None:
            vals, extra, sig, ent, own, gen = self._cache_try(local_keys)
            if vals is not None:
                return vals  # served locally: zero wire traffic
        try:
            with trace.span(
                "ps.pull", cat="ps", rank=self.rank, keys=len(local_keys)
            ) as sp:
                rep, out = self._keyed_call(
                    "pull", local_keys, {}, **self._pull_fields(), **extra
                )
                sp.set(bytes=int(sum(a.nbytes for a in out.values())))
        except BaseException:
            if own:
                self._kcache.end_refresh(sig)
            raise
        if self._kcache is not None:
            return self._cache_settle(rep, out, local_keys, sig, ent, own, gen)
        return self._decode_pull(out)

    def push(self, local_keys: np.ndarray, grads: np.ndarray) -> None:
        if len(local_keys) == 0:
            return
        fields, arrays = self._encode_push(local_keys, grads)
        with trace.span(
            "ps.push", cat="ps", rank=self.rank, keys=len(local_keys),
            bytes=int(sum(a.nbytes for a in arrays.values())),
        ):
            self._keyed_call("push", local_keys, arrays, **fields)
        if self._kcache is not None:
            # ack-time invalidation (see push_async.done): a pull that
            # raced the deferred apply may have re-cached pre-push rows
            self._kcache.invalidate_keys(local_keys, rank=self.rank)

    def dump(self) -> tuple[int, np.ndarray]:
        rep, out = self.client.call("dump")
        return int(rep["begin"]), out["w"]

    def stats(self) -> dict[str, Any]:
        rep, _ = self.client.call("stats")
        return {k: v for k, v in rep.items() if k != "ok"}

    def shutdown(self) -> None:
        self.client.call("shutdown")

    def close(self) -> None:
        watchdog.unregister(self._wd_name)
        self.client.close()
        if self._recovery_pool is not None:
            self._recovery_pool.shutdown(wait=False)


# ---------------------------------------------------------------------------
# node entry points (ref: main.cc role dispatch; spawned by launch_local or
# the `cli node` subcommand: one process per node, like script/local.sh)
# ---------------------------------------------------------------------------


def _launch_counts() -> dict[str, int]:
    """This process's kernel launches so far (the counters start at 0 in
    a spawned node)."""
    from parameter_server_tpu_torch.ops import adagrad_kernels, ftrl_kernels, quantize_kernels

    return {**ftrl_kernels.LAUNCHES, **adagrad_kernels.LAUNCHES,
            **quantize_kernels.LAUNCHES}


class _RemoteBeatSink:
    """Adapter giving ``HeartbeatReporter`` a coordinator RPC sink.

    Opens its OWN connection: the node's main ControlClient serializes
    calls and legitimately parks for long stretches (blocking kv_get,
    ssp_wait); beats riding it would stall and read as a dead node
    exactly when the node is merely waiting."""

    def __init__(self, scheduler: str):
        self._scheduler = scheduler
        # short retry window: a beat is periodic, and retrying one for
        # longer than the beat interval just delays the next, fresher one
        self._ctl: ControlClient | None = ControlClient(
            scheduler, reconnect_timeout_s=1.0
        )

    def beat(self, node_id: int, stats: dict | None = None) -> bool:
        # a single transient socket failure must not silence beats forever
        # (a healthy node would read as dead): drop the connection and
        # rebuild it on the next beat
        try:
            if self._ctl is None:
                self._ctl = ControlClient(
                    self._scheduler, retries=1, retry_delay=0.0,
                    reconnect_timeout_s=1.0,
                )
            self._ctl.beat(node_id, stats)
            return True
        except Exception:  # noqa: BLE001 — the next beat retries
            if self._ctl is not None:
                self._ctl.close()
            self._ctl = None
            return False

    def close(self) -> None:
        if self._ctl is not None:
            self._ctl.close()


class _Beats:
    """A node's liveness heartbeat: HeartbeatReporter over a dedicated
    coordinator connection (liveness must not depend on training
    cadence). Each beat piggybacks the host stats and this process's
    telemetry snapshot (counters + latency histograms + named timers),
    which the coordinator's ``telemetry`` merges into the cluster view,
    and, with ``audit_cfg`` enabled, the audit event spool's batches."""

    def __init__(
        self,
        scheduler: str,
        node_id: int,
        interval_s: float,
        audit_cfg: "AuditConfig | None" = None,
    ):
        self._sink = _RemoteBeatSink(scheduler)
        # audit plane: heartbeating nodes arm the flightrec event spool
        # so their protocol-invariant events (push acks, apply commits,
        # publishes, heals, sheds) ride every beat to the coordinator's
        # streaming auditor; the reporter drains and acks it
        self._armed_spool = False
        if audit_cfg is not None and audit_cfg.enabled:
            flightrec.configure_spool(
                audit_cfg.spool_capacity, audit_cfg.batch_events
            )
            self._armed_spool = True

        def beat_stats() -> dict:
            # one snapshot serves three planes: the beat piggyback, this
            # node's local time-series ring roll, and the heartbeat
            # payload guard's saturation caps
            from parameter_server_tpu_torch.utils.timeseries import beat_telemetry

            return {**host_stats(), "telemetry": beat_telemetry()}

        self._rep = HeartbeatReporter(
            self._sink, node_id, interval_s, stats_fn=beat_stats
        )
        self._rep.start()
        # watchdog: heartbeat silence, seen from INSIDE the silent node —
        # the beat thread is always "busy" (liveness is its whole job),
        # so a beats counter that stops advancing is a wedged reporter
        self._wd_name = f"heartbeat:{node_id}"
        watchdog.register(
            self._wd_name, lambda: (True, self._rep.beats),
            thread_name="ps-heartbeat",
        )

    def stop(self) -> None:
        watchdog.unregister(self._wd_name)
        self._rep.stop()
        self._sink.close()
        if self._armed_spool:
            flightrec.configure_spool(None)


def run_server(
    cfg: PSConfig,
    scheduler: str,
    rank: int,
    num_servers: int,
    bind_host: str = "127.0.0.1",
    advertise_host: str = "",
    ckpt_dir: str = "",
    device: Any = "cuda",
) -> dict[str, Any]:
    """One server process: a ``ShardServer`` over this rank's range of
    the key space, its tables on ``device``. ``bind_host="0.0.0.0"`` + a
    routable ``advertise_host`` lets workers on other hosts connect.

    ``ckpt_dir`` enables recovery: an existing dump for this range is
    loaded on start-up (a relaunched server resumes where its last dump
    left off), with ``[fault] server_ckpt_interval_s > 0`` the state is
    re-dumped periodically while serving, and once more at shutdown.
    Returns this node's report (its kernel launches, its counters)."""
    from parameter_server_tpu_torch.models.linear import updater_from_config

    dev = resolve_device(device)
    ranges = KeyRange(0, cfg.data.num_keys).even_divide(num_servers)
    srv = ShardServer(
        updater_from_config(cfg), ranges[rank], host=bind_host,
        advertise_host=advertise_host, fault_plan=_plan_from_cfg(cfg),
        server_cfg=cfg.server, serve_cfg=cfg.serve, device=dev,
    )
    resumed = False
    if ckpt_dir:
        resumed = srv.load_state(ckpt_dir)
        if resumed:
            print(f"[server {rank}] resumed from {ckpt_dir}", flush=True)
        if cfg.fault.server_ckpt_interval_s > 0:
            srv.start_checkpointing(ckpt_dir, cfg.fault.server_ckpt_interval_s)
    ctl = ControlClient(scheduler, reconnect_timeout_s=cfg.fault.reconnect_timeout_s)
    node_id = ctl.register("server", rank=rank)
    t_register = time.time()
    # set AFTER any resume: workers re-resolving this key must never beat
    # the state load and pull pre-resume zeros
    ctl.kv_set(f"server_addr/{rank}", addr=srv.address)
    beats = _Beats(
        scheduler, node_id, cfg.fault.heartbeat_interval_s,
        audit_cfg=cfg.audit,
    )
    srv.start()
    srv.server._stop.wait()  # until the scheduler's shutdown
    # the scheduler and its coordinator are going away: stop beating into
    # them before the apply thread's exit grace (a beat into the stopped
    # coordinator would fail its heal, which a postmortem reads as an
    # anomaly)
    beats.stop()
    srv.join()
    if ckpt_dir:
        srv.stop_checkpointing()  # no periodic writer behind the final dump
        srv.save_state(ckpt_dir)
    ctl.close()
    trace.tracer.flush()  # export this process's spans (no-op if disabled)
    return {"t_register": t_register, "resumed": resumed, "counters": dict(srv.counters),
            "kernel_load_s": srv.kernel_load_s, "first_apply_s": srv.first_apply_s}


def _connect_servers(
    ctl: ControlClient, worker_rank: int, num_servers: int, cfg: PSConfig,
    device: Any = "cuda",
) -> list[ServerHandle]:
    ranges = KeyRange(0, cfg.data.num_keys).even_divide(num_servers)
    handles = []
    for s in range(num_servers):
        fields, _ = ctl.kv_get(f"server_addr/{s}", block=True, timeout=60)

        def resolve(s=s) -> str:
            # re-read the registry: a relaunched server re-publishes its
            # (new) address under the same rank key
            f, _ = ctl.kv_get(f"server_addr/{s}", block=True, timeout=10)
            return f["addr"]

        handles.append(
            ServerHandle(
                fields["addr"], s, worker_rank, cfg,
                range_size=ranges[s].size, key_range=ranges[s],
                resolve_addr=resolve,
                # the training tier is never a serving handle: its
                # staleness contract is the SSP clock
                serving=False, device=device,
            )
        )
    return handles


def run_worker(
    cfg: PSConfig,
    scheduler: str,
    rank: int,
    num_servers: int,
    report_interval: int = 20,
    device: Any = "cuda",
) -> dict[str, Any]:
    """The async-SGD worker loop over the wire (ref: AsyncSGDWorker): the
    step's logits, loss and gradient are segment sums on ``device``; pulls
    and pushes go through a ``SocketBackend`` over the servers' handles.
    Returns this node's report."""
    from parameter_server_tpu_torch.data.batch import training_builder
    from parameter_server_tpu_torch.data.reader import MinibatchReader
    from parameter_server_tpu_torch.models import metrics as M
    from parameter_server_tpu_torch.ops.sparse import csr_grad, csr_logits, logistic_loss
    from parameter_server_tpu_torch.parallel.backend import SocketBackend
    from parameter_server_tpu_torch.parallel.ssp import PushWindow

    dev = resolve_device(device)
    ctl = ControlClient(scheduler, reconnect_timeout_s=cfg.fault.reconnect_timeout_s)
    node_id = ctl.register("worker", rank=rank)
    t_register = time.time()
    beats = _Beats(
        scheduler, node_id, cfg.fault.heartbeat_interval_s,
        audit_cfg=cfg.audit,
    )
    # the scheduler's ssp_init/workload_init must land before our first
    # fetch; registration order doesn't guarantee it, this kv flag does
    ctl.kv_get("scheduler_init_done", block=True, timeout=120)
    servers = _connect_servers(ctl, rank, num_servers, cfg, device=dev)
    ranges = KeyRange(0, cfg.data.num_keys).even_divide(num_servers)
    backend = SocketBackend(servers, ranges, cfg.data.num_keys, own_handles=False)
    builder = training_builder(cfg)

    def grad_step(w_u: np.ndarray, b) -> tuple[float, np.ndarray, np.ndarray]:
        t = {f: torch.from_numpy(getattr(b, f)).to(dev)
             for f in ("values", "local_ids", "row_ids", "labels", "example_mask")}
        w = torch.from_numpy(w_u).to(dev)
        logits = csr_logits(w, t["values"], t["local_ids"], t["row_ids"],
                            num_rows=len(b.labels))
        loss, err = logistic_loss(logits, t["labels"], t["example_mask"])
        g = csr_grad(err, t["values"], t["local_ids"], t["row_ids"], num_unique=len(w_u))
        return (float(loss), torch.sigmoid(logits).cpu().numpy(),
                g.reshape(-1).cpu().numpy())

    # in-flight push bound, in whole steps: the SSP delay shapes it (a step
    # only ssp_finishes when its pushes applied), and [wire]
    # max_inflight_pushes tightens it when wire memory binds
    max_delay = cfg.solver.max_delay
    ssp_limit = max_delay if max_delay >= 0 else (1 << 30)
    cap = cfg.wire.max_inflight_pushes
    inflight_limit = ssp_limit if cap <= 0 else min(ssp_limit, cap)
    pushes = PushWindow(
        inflight_limit, retire=lambda step_i: ctl.ssp_finish(rank, step_i)
    )

    step = 0
    window: list[tuple[float, np.ndarray, np.ndarray]] = []
    t0 = time.perf_counter()
    t_first_step = None  # wall clock, for the node's report
    ex_seen = 0

    def flush_window() -> None:
        """Send the window's merged progress (ref: per-report_interval
        Progress protos merged at the scheduler)."""
        nonlocal window, t0
        if not window:
            return
        n = sum(len(y) for _, _, y in window)
        y = np.concatenate([y for _, _, y in window])
        p = np.concatenate([pr for _, pr, _ in window])
        ctl.progress(
            rank,
            {
                "examples": n,
                "examples_total": ex_seen,
                "objv": sum(l for l, _, _ in window) / n,
                "auc": M.auc(y, p),
                "ex_per_sec": n / max(time.perf_counter() - t0, 1e-9),
                # measured wire traffic, cumulative for this worker,
                # counted at the frame layer (summed over workers)
                "wire_bytes_out": wire_counters.get("wire_bytes_out"),
                "wire_bytes_in": wire_counters.get("wire_bytes_in"),
                "wire_bytes_saved": wire_counters.get("wire_bytes_saved"),
                "wire_comp_skipped": wire_counters.get("wire_comp_skipped"),
                # self-healing counters, cumulative for this worker process
                "rpc_retries": wire_counters.get("rpc_retries"),
                "rpc_reconnects": wire_counters.get("rpc_reconnects"),
            },
        )
        window = []
        t0 = time.perf_counter()

    while True:
        with trace.span("step.workload_fetch", cat="step"):
            workload = ctl.workload_fetch(rank)
        if workload is None:
            if ctl.workload_all_done():
                break
            # nothing pending, but another worker still holds active
            # shards: if it dies the scheduler requeues them, so keep
            # polling instead of exiting
            time.sleep(0.2)
            continue
        _epoch, path = workload.split(":", 1)
        for b in MinibatchReader([path], cfg.data.format, builder):
            # retire our own in-flight pushes first: the clock's gate for
            # step t includes this worker's finished counter, so draining
            # after the gate would self-deadlock
            pushes.gate()
            if t_first_step is None:
                t_first_step = time.time()
            # step anatomy: one enclosing step span; ssp_wait / pull /
            # compute are its children, and flow events tie each push's
            # issue span to its completion (ps.push.inflight)
            with trace.span("step", cat="step", step=step):
                with trace.span("step.ssp_wait", cat="step"):
                    ctl.ssp_wait(rank, step)
                # the batch's (sorted) unique global keys, pad slot 0 left out
                real = b.unique_keys[1 : b.num_unique]
                with trace.span("step.pull", cat="step"):
                    pulled = backend.pull(real)
                with trace.span("step.compute", cat="step"):
                    w_u = np.zeros(len(b.unique_keys), dtype=np.float32)
                    w_u[1 : b.num_unique] = pulled.ravel()
                    loss, probs, g = grad_step(w_u, b)
                    g_real = g[1 : b.num_unique]
                futs = [backend.push_async(real, g_real)]
            pushes.add(step, futs)
            ex_seen += b.num_examples
            window.append(
                (loss, probs[: b.num_examples], b.labels[: b.num_examples])
            )
            if len(window) >= report_interval:
                flush_window()
            step += 1
        ctl.workload_finish(workload)
    pushes.wait_all()  # the sync point: every in-flight push acked
    t_done = time.time()
    flush_window()
    ctl.ssp_retire(rank)  # out of data: stop gating the still-running workers
    # completion signal: the scheduler's monitor waits for every rank to
    # be done or dead
    ctl.kv_set(f"worker_done/{rank}")
    beats.stop()
    for sh in servers:
        sh.close()
    ctl.close()
    trace.tracer.flush()  # export this process's spans (no-op if disabled)
    return {"t_register": t_register, "t_first_step": t_first_step, "t_done": t_done,
            "steps": step, "examples": ex_seen,
            "max_inflight_seen": pushes.max_inflight_seen}


def run_scheduler(
    cfg: PSConfig,
    coordinator: Coordinator,
    num_servers: int,
    num_workers: int,
    model_out: str = "",
    device: Any = "cuda",
) -> dict[str, Any]:
    """Drive a run: init the pool and the clock, wait for completion,
    assemble the model from the servers' dumps, evaluate it on ``device``,
    shut everything down."""
    dev = resolve_device(device)
    ctl = ControlClient(coordinator.address)
    ctl.register("scheduler")
    ctl.ssp_init(num_workers, cfg.solver.max_delay)
    items = [
        f"{e}:{f}" for e in range(max(cfg.solver.epochs, 1)) for f in cfg.data.files
    ]
    ctl.workload_init(items)
    ctl.kv_set("scheduler_init_done")  # workers block on this before fetching
    if cfg.fault.recovery_sweep_interval_s > 0:
        # dead-WORKER recovery (requeue + clock release) runs inside the
        # coordinator's sweep thread; this loop records its verdicts.
        # Dead-SERVER policy (grace window / fail fast) stays here
        coordinator.start_recovery(cfg.fault.recovery_sweep_interval_s)

    # monitor loop: wait until every worker rank is done or dead (a plain
    # barrier would park forever on a dead worker's missing arrival)
    dead_ranks: set[int] = set()
    server_dead_since: dict[int, float] = {}  # rank -> first seen dead
    t_start = time.monotonic()

    def declare_dead(r: int, why: str) -> None:
        requeued = ctl.workload_reassign(worker=r)
        ctl.ssp_retire(r)
        dead_ranks.add(r)
        print(f"[scheduler] worker {r} {why}; requeued {len(requeued)} "
              f"shard(s), retired its clock", flush=True)

    while True:
        done = {
            r for r in range(num_workers)
            if ctl.kv_get(f"worker_done/{r}") is not None
        }
        if done | dead_ranks >= set(range(num_workers)):
            break
        for r, info in ctl.recovered_workers().items():
            if r not in dead_ranks:
                dead_ranks.add(r)
                print(f"[scheduler] worker {r} dead (missed heartbeats); sweep "
                      f"requeued {len(info['requeued'])} shard(s) and retired "
                      "its clock", flush=True)
        registry = ctl.nodes()
        dead_ids, _alive = ctl.dead_nodes()
        dead_set = {int(x) for x in dead_ids}
        alive_server_ranks = {
            int(n["rank"])
            for nid2, n in registry.items()
            if n.get("role") == "server" and "rank" in n and int(nid2) not in dead_set
        }
        for nid in dead_ids:
            info = registry.get(str(nid), {})
            role = info.get("role")
            if role == "server":
                r = int(info.get("rank", -1))
                grace = cfg.fault.server_restart_grace_s
                if r in alive_server_ranks:
                    # a replacement re-registered under this rank (resumed
                    # from its checkpoint); the old corpse can be ignored
                    server_dead_since.pop(r, None)
                    continue
                now = time.monotonic()
                since = server_dead_since.setdefault(r, now)
                if grace <= 0 or now - since > grace:
                    # without checkpoint-backed restart a dead server's
                    # key range is gone: fail fast with the cause
                    raise RuntimeError(
                        f"shard server rank {r} died (missed heartbeats) "
                        + (f"and no replacement registered within {grace}s; "
                           if grace > 0 else "; ")
                        + "aborting the run"
                    )
                continue
            if role != "worker":
                continue
            r = int(info.get("rank", -1))
            if r not in dead_ranks and r not in done:
                # sweep disabled (recovery_sweep_interval_s == 0): fall
                # back to scheduler-driven recovery over the wire
                declare_dead(r, "dead (missed heartbeats)")
        if time.monotonic() - t_start > cfg.fault.startup_grace_s:
            # a rank that NEVER registered is neither dead (no beats) nor
            # done: without this it would park the monitor forever
            registered = {
                int(n["rank"]) for n in registry.values()
                if n.get("role") == "worker" and "rank" in n
            }
            for r in set(range(num_workers)) - registered - dead_ranks - done:
                declare_dead(r, "never registered (startup failure?)")
        if cfg.fault.straggler_reassign_s > 0:
            ctl.workload_reassign(older_than=cfg.fault.straggler_reassign_s)
        time.sleep(0.5)

    from parameter_server_tpu_torch.parallel.backend import SocketBackend

    servers = _connect_servers(ctl, -1, num_servers, cfg, device=dev)
    w = SocketBackend(
        servers, KeyRange(0, cfg.data.num_keys).even_divide(num_servers),
        cfg.data.num_keys, own_handles=False,
    ).weights().ravel()
    out: dict[str, Any] = {
        "merged": ctl.progress_merged(),
        "server_stats": [sh.stats() for sh in servers],
        "nnz_w": int(np.count_nonzero(w)),
        "workloads": ctl.workload_stats(),
        "dead_workers": sorted(dead_ranks),
        # scheduler-process wire/recovery counters (the coordinator runs
        # in-process)
        "wire": wire_counters.snapshot(),
        # cluster telemetry merged from every node's heartbeat snapshot
        # (+ this process): counters, per-command latency histograms,
        # named timers: the `cli stats` view, embedded in the run result
        "telemetry": ctl.telemetry()["merged"],
    }
    if model_out:
        from parameter_server_tpu_torch.utils.checkpoint import dump_weights_text

        dump_weights_text(w, model_out)
        out["model_out"] = model_out
    if cfg.data.val_files:
        from parameter_server_tpu_torch.models.evaluation import evaluate_model

        ev = evaluate_model(
            w, cfg.data.val_files, cfg.data.format, cfg.data.num_keys,
            batch_size=cfg.solver.minibatch,
            max_nnz_per_example=cfg.data.max_nnz_per_example, device=dev,
        )
        out["val_auc"] = ev["auc"]
        out["val_logloss"] = ev["logloss"]
    for sh in servers:
        sh.shutdown()
        sh.close()
    ctl.close()
    coordinator.stop()
    trace.tracer.flush()  # export this process's spans (no-op if disabled)
    return out


def _export_witness_env(child_env: dict) -> None:
    """Arm the runtime lock-order witness in spawned children whenever
    THIS process runs under it — whether it was armed by the
    ``PS_LOCK_WITNESS`` env var (already inherited via the env copy) or
    by an explicit ``witness.install()``, which an env copy alone would
    silently fail to propagate. Children arm at package import
    (parallel/__init__), so every lock a spawned node constructs is
    order-checked too. The lockset race witness rides the same rule: an
    armed parent spawns armed children, so the registered shared objects
    of every node in a launch_local cluster are lockset-checked."""
    from parameter_server_tpu_torch.analysis import racewitness, witness

    if witness.installed():
        child_env[witness.ENV_VAR] = "1"
    if racewitness.installed():
        child_env[racewitness.ENV_VAR] = "1"


def launch_local(
    app_file: str,
    num_servers: int,
    num_workers: int,
    model_out: str = "",
    timeout: float = 600.0,
    device: Any = "cuda",
    fault_kill: str = "",
    fault_restart_after: float = -1.0,
    ckpt_dir: str = "",
    fault_plan: str = "",
    fault_seed: int = 0,
    trace_dir: str = "",
    trace_sample: int = 1,
    blackbox_dir: str = "",
    log_dir: str = "",
) -> dict[str, Any]:
    """Spawn scheduler + servers + workers as real processes on this host
    (ref: script/local.sh): each a ``python -m parameter_server_tpu_torch.
    cli node --device <device>`` process. On the card every node shares
    the one card (no collective runs on this path).

    ``fault_kill="worker:1@2.0"`` SIGKILLs the named node 2.0 s after it
    registers with the coordinator (dead-node detection + workload
    requeue); ``fault_restart_after >= 0`` respawns it that many seconds
    after the kill, which with ``ckpt_dir`` (server checkpoints, see
    ``run_server``) exercises checkpoint-backed server recovery: such a
    server is killed no earlier than its first range dump is on disk,
    however long the dump takes at its table's size.

    The nodes' output lands in ``log_dir`` (a fresh temporary directory
    by default) as ``<role>-<rank>.out`` / ``.err``. Returns the
    scheduler's result, plus ``nodes``: each node's spawn time, exit code
    and the JSON report it printed at exit (its launches, its register
    time).

    ``fault_plan`` (a ``parallel/chaos.py`` spec) arms a seeded FaultPlan
    on every spawned node's RpcServers through the ``PS_FAULT_PLAN`` /
    ``PS_FAULT_SEED`` environment variables: frame-level drop, delay,
    disconnect and duplicate chaos on top of (or instead of) the
    process-kill fault.

    ``trace_dir`` arms tracing on every spawned node through
    ``PS_TRACE_DIR`` (``trace_sample`` > 1 rides along as
    ``PS_TRACE_SAMPLE``): each exports ``trace-<role>-<rank>-<pid>.json``
    there at exit; ``utils/trace.py`` ``merge_trace_dir`` merges them.
    ``blackbox_dir`` arms the flight recorder and watchdog on every
    spawned node through ``PS_BLACKBOX_DIR``: each leaves a
    ``blackbox-<role>-<rank>-<pid>.json`` dump behind, flushed
    periodically, so even a SIGKILL'd node's box survives for the JAX
    package's ``cli postmortem`` to merge."""
    import socket as socket_mod
    import subprocess
    import sys
    import tempfile

    resolve_device(device)  # no card: raise here, before spawning anything

    with socket_mod.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    addr = f"127.0.0.1:{port}"
    child_env = dict(os.environ)
    # the children import this package from where this process found it
    pkg_root = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in (pkg_root, child_env.get("PYTHONPATH", "")) if p
    )
    if fault_plan:
        FaultPlan.parse(fault_plan, seed=fault_seed)  # fail fast on a typo
        child_env[PLAN_ENV] = fault_plan
        child_env[SEED_ENV] = str(fault_seed)
    if trace_dir:
        # arm tracing on EVERY spawned node (the PS_FAULT_PLAN pattern)
        os.makedirs(trace_dir, exist_ok=True)
        child_env[trace.TRACE_DIR_ENV] = trace_dir
        if trace_sample > 1:
            # head sampling rides along: children keep whole traces or
            # drop them, consistently with every other node (the
            # decision is keyed off the trace id, not the process)
            child_env[trace.TRACE_SAMPLE_ENV] = str(int(trace_sample))
    if blackbox_dir:
        # arm the flight recorder on EVERY spawned node (same pattern)
        os.makedirs(blackbox_dir, exist_ok=True)
        child_env[flightrec.BLACKBOX_DIR_ENV] = blackbox_dir
    _export_witness_env(child_env)
    logdir = log_dir or tempfile.mkdtemp(prefix="pslaunch_")
    os.makedirs(logdir, exist_ok=True)

    def spawn(role: str, rank: int, attempt: int = 0) -> subprocess.Popen:
        cmd = [
            sys.executable, "-m", "parameter_server_tpu_torch.cli", "node",
            "--role", role, "--rank", str(rank), "--scheduler", addr,
            "--num_servers", str(num_servers), "--num_workers", str(num_workers),
            "--app_file", app_file, "--device", str(device),
        ]
        if role == "scheduler" and model_out:
            cmd += ["--model_out", model_out]
        if role == "server" and ckpt_dir:
            cmd += ["--ckpt_dir", ckpt_dir]
        # child output goes to files, not pipes: nobody drains N pipes
        # while training runs, and a chatty child must never block
        tag = f"{role}-{rank}" + (f"-r{attempt}" if attempt else "")
        out_f = open(f"{logdir}/{tag}.out", "w+")
        err_f = open(f"{logdir}/{tag}.err", "w+")
        t_spawn = time.time()
        p = subprocess.Popen(cmd, stdout=out_f, stderr=err_f, text=True, env=child_env)
        p._ps_logs = (out_f, err_f)  # type: ignore[attr-defined]
        p._ps_tag = f"{role}:{rank}"  # type: ignore[attr-defined]
        p._ps_name = tag  # type: ignore[attr-defined]
        p._ps_spawn = t_spawn  # type: ignore[attr-defined]
        return p

    def logs_of(p: subprocess.Popen) -> tuple[str, str]:
        out_f, err_f = p._ps_logs  # type: ignore[attr-defined]
        out_f.seek(0)
        err_f.seek(0)
        return out_f.read(), err_f.read()

    procs = [spawn("scheduler", 0)]
    procs += [spawn("server", r) for r in range(num_servers)]
    procs += [spawn("worker", r) for r in range(num_workers)]
    victims: list[subprocess.Popen] = []  # processes whose death is the test
    replacement_box: list[subprocess.Popen] = []  # assassin -> main handoff
    respawn_lock = threading.Lock()
    harness_done = threading.Event()
    assassin_thread: threading.Thread | None = None
    if fault_kill:
        role_rank, delay_s = fault_kill.split("@")
        kill_role, kill_rank = role_rank.split(":")
        killed_tag = f"{kill_role}:{int(kill_rank)}"
        victim = next(p for p in procs if p._ps_tag == killed_tag)  # type: ignore[attr-defined]
        victims.append(victim)
        dump_path = ""  # the victim's range dump (ShardServer._ckpt_path)
        if kill_role == "server" and ckpt_dir and fault_restart_after >= 0:
            r = KeyRange(0, load_config(app_file).data.num_keys).even_divide(
                num_servers)[int(kill_rank)]
            dump_path = os.path.join(ckpt_dir, f"server-{r.begin}-{r.end}.npz")

        def assassin() -> None:
            # wait for the victim to REGISTER first: killing a process that
            # never reached the coordinator would leave the scheduler unable
            # to tell "dead" from "still starting up"
            ctl = ControlClient(addr, retries=600)
            try:
                while not harness_done.is_set():
                    if any(
                        n.get("role") == kill_role
                        and int(n.get("rank", -1)) == int(kill_rank)
                        for n in ctl.nodes().values()
                    ):
                        break
                    time.sleep(0.2)
            except Exception:  # noqa: BLE001 — the run ended first
                return
            finally:
                ctl.close()
            if harness_done.wait(float(delay_s)):
                return
            if dump_path:
                # a server killed before its first range dump would restart
                # empty: the kill would test nothing of checkpoint recovery
                while not os.path.exists(dump_path):
                    if harness_done.wait(0.05):
                        return
            victim.kill()
            if fault_restart_after >= 0:
                if harness_done.wait(fault_restart_after):
                    return
                # checkpoint-backed recovery: the replacement re-registers
                # under the same rank and reloads its range dump; spawned
                # only while the scheduler is alive, or nobody would ever
                # shut it down
                with respawn_lock:
                    if not harness_done.is_set() and procs[0].poll() is None:
                        replacement_box.append(
                            spawn(kill_role, int(kill_rank), attempt=1)
                        )

        assassin_thread = threading.Thread(target=assassin, daemon=True,
                                           name="ps-launch-assassin")
        assassin_thread.start()
    deadline = time.monotonic() + timeout
    timed_out = False
    try:
        for p in procs:
            try:
                p.wait(timeout=max(deadline - time.monotonic(), 1))
            except subprocess.TimeoutExpired:
                timed_out = True
                break
        # the replacement (if any) exits when the scheduler shuts it down;
        # one spawned too close to the run's end may have nobody left to
        # do that: reap it leniently rather than hang or fail the run
        with respawn_lock:
            harness_done.set()  # no further respawns
        for p in replacement_box:
            if not timed_out:
                try:
                    p.wait(timeout=30)
                except subprocess.TimeoutExpired:
                    pass
    finally:
        with respawn_lock:
            harness_done.set()
        if assassin_thread is not None:
            assassin_thread.join(timeout=30)
        for p in replacement_box:
            victims.append(p)  # its rc never decides the run's outcome
            procs.append(p)
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    outs = [(p, *logs_of(p)) for p in procs]
    for p, _, _ in outs:
        p._ps_logs[0].close()  # type: ignore[attr-defined]
        p._ps_logs[1].close()  # type: ignore[attr-defined]
    if timed_out:
        tails = "\n".join(
            f"--- {p._ps_tag} rc={p.returncode} ---\n{err[-1500:]}"  # type: ignore[attr-defined]
            for p, _, err in outs
        )
        raise RuntimeError(f"multi-process run timed out after {timeout}s:\n{tails}")
    for p, stdout, stderr in outs:
        if p.returncode != 0 and not any(p is v for v in victims):
            raise RuntimeError(
                f"node {p._ps_tag} failed rc={p.returncode}:\n{stderr[-2000:]}"  # type: ignore[attr-defined]
            )
    # every node prints its result JSON on its last stdout line (the
    # scheduler's is the run's result)
    nodes: dict[str, dict[str, Any]] = {}
    for p, stdout, _ in outs:
        lines = stdout.strip().splitlines()
        report = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {}
        nodes[p._ps_name] = {"spawn_time": p._ps_spawn, "rc": p.returncode,  # type: ignore[attr-defined]
                             **({} if p._ps_name == "scheduler-0" else report)}  # type: ignore[attr-defined]
    result = json.loads(outs[0][1].strip().splitlines()[-1])
    result["nodes"] = nodes
    return result


def run_node(
    cfg: PSConfig,
    role: str,
    rank: int,
    scheduler: str,
    num_servers: int,
    num_workers: int,
    model_out: str = "",
    bind_host: str = "127.0.0.1",
    advertise_host: str = "",
    ckpt_dir: str = "",
    device: Any = "cuda",
) -> dict[str, Any]:
    """Role dispatch for one spawned process (ref: App::Create + main.cc).
    The scheduler returns the run's result; a server or a worker its
    report: ``{"node": "server-0", "device": ..., "launches": {...}}``
    with its kernel launches, its register time and its counters."""
    # the one unknown-role gate, before any arming side effects; the
    # table doubles as the metrics-endpoint port layout below
    metrics_offset = {
        "scheduler": 0,
        "server": 1 + rank,
        "worker": 1 + num_servers + rank,
    }.get(role)
    if metrics_offset is None:
        raise ValueError(f"unknown role {role!r}")
    dev = resolve_device(device)
    # arm tracing for this node: config [trace] trace_dir wins, then the
    # inherited PS_TRACE_DIR env (launch_local's arming path); the process
    # name makes each node's export file self-describing
    tdir = cfg.trace.trace_dir or os.environ.get(trace.TRACE_DIR_ENV, "")
    if tdir:
        # head-sampling rate: an explicit [trace] sample wins, else the
        # inherited PS_TRACE_SAMPLE (launch_local's arming path)
        sample = cfg.trace.sample
        if sample <= 1:
            sample = trace._env_sample()
        trace.configure(
            tdir, capacity=cfg.trace.capacity,
            process_name=f"{role}-{rank}",
            sample=sample,
            # tail-biased capture: on by default, promotion rescues the
            # slow traces head sampling would drop
            tail=cfg.trace.tail,
            tail_k=cfg.trace.tail_k,
            tail_limbo=cfg.trace.tail_limbo,
        )
    # arm the black box: config [blackbox] dir wins, then the inherited
    # PS_BLACKBOX_DIR (launch_local's arming path) — re-configured even
    # when env-armed at import so the dump carries a role-rank name
    bdir = cfg.blackbox.dir or os.environ.get(flightrec.BLACKBOX_DIR_ENV, "")
    if bdir:
        flightrec.configure(
            bdir, capacity=cfg.blackbox.capacity,
            process_name=f"{role}-{rank}",
            flush_interval_s=cfg.blackbox.flush_interval_s,
            watchdog_interval_s=cfg.blackbox.watchdog_interval_s,
            stall_timeout_s=cfg.blackbox.stall_timeout_s,
        )
    # arm the continuous profiler: config [profile] hz wins, then the
    # inherited PS_PROFILE (env-armed at import; re-configured here so
    # the dump carries a role-rank name)
    from parameter_server_tpu_torch.utils import profiler, timeseries

    prof_hz = cfg.profile.hz if cfg.profile.hz > 0 else profiler.env_hz()
    if prof_hz > 0:
        profiler.configure(
            prof_hz, top_n=cfg.profile.top_n,
            max_depth=cfg.profile.max_depth,
            dump_dir=cfg.profile.dump_dir
            or os.environ.get(profiler.PROFILE_DIR_ENV, ""),
            process_name=f"{role}-{rank}",
        )
    # OpenMetrics scrape endpoint: [timeseries] metrics_port (or the
    # inherited PS_METRICS_PORT) is the base port; each role-rank binds
    # a deterministic offset so one host's processes never collide
    mbase = cfg.timeseries.metrics_port or int(
        os.environ.get(timeseries.METRICS_PORT_ENV, "0") or 0
    )
    # size this node's local delta ring (fed by each beat's
    # beat_telemetry roll; served windowed by /healthz)
    timeseries.reset_local_ring(cfg.timeseries.capacity)
    msrv = roller = None
    if mbase > 0:
        msrv = timeseries.start_metrics_server(
            mbase + metrics_offset, process_name=f"{role}-{rank}",
            host=cfg.timeseries.metrics_host,
            window_s=cfg.timeseries.window_s,
        )
        if role == "scheduler":
            # servers/workers roll the local ring on every beat; the
            # scheduler never beats, so without this its /healthz
            # window would stay empty and read as a wedged node
            roller = timeseries.Roller(cfg.fault.heartbeat_interval_s)
    # audit plane: the scheduler has no heartbeat reporter, so its own
    # spool (SSP clock movements, control rpc.reply acks) is drained
    # inline by the coordinator's audit pass; armed here, with the same
    # role gate the _Beats path applies on servers/workers
    armed_spool = False
    if role == "scheduler" and cfg.audit.enabled:
        flightrec.configure_spool(
            cfg.audit.spool_capacity, cfg.audit.batch_events
        )
        armed_spool = True
    from parameter_server_tpu_torch.analysis import racewitness, witness

    try:
        if role == "scheduler":
            host, port = scheduler.rsplit(":", 1)
            coord = Coordinator(
                host, int(port),
                heartbeat_timeout_s=cfg.fault.heartbeat_timeout_s,
                fault_plan=_plan_from_cfg(cfg),
                slo_cfg=cfg.slo,
                series_capacity=cfg.timeseries.capacity,
                series_window_s=cfg.timeseries.window_s,
                audit_cfg=cfg.audit,
            )
            res = run_scheduler(
                cfg, coord, num_servers, num_workers, model_out, device=dev
            )
            if witness.installed():
                res["witness"] = witness.report()
            if racewitness.installed():
                res["race_witness"] = racewitness.report()
            return res
        if role == "server":
            report = run_server(
                cfg, scheduler, rank, num_servers, bind_host=bind_host,
                advertise_host=advertise_host, ckpt_dir=ckpt_dir, device=dev,
            )
        else:
            report = run_worker(cfg, scheduler, rank, num_servers, device=dev)
        if witness.installed():
            # the lock-order witness (PS_LOCK_WITNESS): what this node took
            report["witness"] = witness.report()
        if racewitness.installed():
            # the lockset race witness (PS_RACE_WITNESS): what it tracked
            report["race_witness"] = racewitness.report()
        return {"node": f"{role}-{rank}", "device": str(dev),
                "launches": _launch_counts(), **report}
    finally:
        if roller is not None:
            roller.close()
        if msrv is not None:
            msrv.close()
        if armed_spool:
            flightrec.configure_spool(None)
