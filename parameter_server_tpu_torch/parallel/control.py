"""The wire tier's frame protocol, RPC layer and coordinator over TCP.

The port of the JAX package's ``parallel/control.py``: the frame layout,
the header codecs, per-array compression and the pipelined, self-healing
``RpcServer`` / ``RpcClient`` the shard servers and their handles talk
over, and the control plane on top of them: the scheduler's
``Coordinator`` (node registry, barriers, a blob KV, the workload pool,
merged progress, heartbeats, the SSP clock, the dead-worker recovery
sweep) and its typed ``ControlClient``. Nothing here touches a tensor:
frames carry numpy arrays, as in the JAX package, so a JAX client and a
port server (or the reverse) share one wire, byte for byte, and a JAX
``ControlClient`` drives a port ``Coordinator`` (and the reverse).

Wire format (ref: Message = Task proto header + SArray payloads):

    u32 header_len | u32 payload_len | header bytes | payload bytes

The header carries the command and scalar fields; ``arrays`` in the header
describes the (name, dtype, shape, compressed_len) of each contiguous numpy
payload chunk. Header bytes come in two self-describing codecs, sniffed by
the first byte: ``{`` (0x7B) is JSON, ``0xB7`` opens the versioned
fixed-layout binary codec (magic / version / flags / cmd-id / seq / cid /
array-descriptor table, with a JSON tail for residual fields). Binary is
negotiated per connection: a client that prefers it sends JSON requests
carrying ``_bh: 1`` until a reply confirms the peer decodes binary. Wire
features (the quantized push codec, ``"qwire"``) negotiate the same way
through a ``_feat`` advert. Versions 1-3 of the binary header decode;
each frame is stamped with the lowest version whose layout it uses.

Delivery: every ``RpcClient`` request carries a client id and a sequence
number; a dead connection reconnects and resends its whole pending window
under the same identities, and the server's per-client reply cache
answers a resent non-idempotent command from the cache: at-least-once on
the wire, exactly-once at the handler.

Chaos: a seeded ``FaultPlan`` (``parallel/chaos.py``), passed as
``fault_plan=`` or read from ``PS_FAULT_PLAN`` / ``PS_FAULT_SEED``, is
consulted once per received frame and may drop it (before it applies),
delay it, dispatch it twice (the second reply discarded) or apply it and
sever the connection before the reply: the client's heal and the reply
cache keep every command applied once. Serving plane: a handler that
stamps a reply with its publish timestamp ``pts`` gets the realized data
age ``_age_us`` stamped here, per serve; ``withheld_bytes`` is the
current coalesced-reply backlog that the shard servers shed on. A client
with ``adaptive_window`` shapes its in-flight window from its own
completion-latency histogram.

The flight recorder (``rpc.in``/``rpc.out`` a frame on the server,
``rpc.issue``/``rpc.reply`` and the heal transitions on the client),
tracing (the client's ``rpc.<cmd>`` span sends its ``_trace`` context in
the header; the server's ``rpc.serve.<cmd>`` span joins it, a JAX
client's too) and the watchdog probes are the JAX module's, and so is
the live operations plane: the per-command latency histograms
(``client.<cmd>``, ``server.<cmd>``) and slowest-op records, the
coordinator's per-node time series, SLO engine and audit plane (its
``telemetry`` reply carries ``nodes``, ``coordinator``, ``merged``,
``series``, ``slo`` and ``audit``; ``audit`` answers ``cli audit``). The
process-global ``wire_counters`` (``utils/metrics.py``) keep the counts
that ``stats`` replies carry.
"""

from __future__ import annotations

import json
import random
import socket
import struct
import threading
import time
import uuid
import zlib
from collections import OrderedDict, deque
from concurrent.futures import Future
from typing import Any, Callable

import numpy as np

from parameter_server_tpu_torch.parallel.chaos import FaultPlan
from parameter_server_tpu_torch.parallel.ssp import SSPClock
from parameter_server_tpu_torch.parallel.workload import WorkloadPool
from parameter_server_tpu_torch.utils import flightrec, trace
from parameter_server_tpu_torch.utils.flightrec import watchdog
from parameter_server_tpu_torch.utils.heartbeat import HeartbeatMonitor
from parameter_server_tpu_torch.utils.metrics import (
    Histogram,
    hist_percentile,
    merge_progress,
    latency_histograms,
    merge_telemetry,
    race_track,
    slow_ops,
    telemetry_snapshot,
    wire_counters,
)

_LEN = struct.Struct("<II")

Arrays = dict[str, np.ndarray]

# adaptive per-array compression (the compressing filter, rebuilt):
_COMP_MIN_BYTES = 1024  # arrays below this floor are never worth the CPU
_COMP_PROBE_BYTES = 4096  # sampled-ratio window for large arrays
_COMP_PROBE_RATIO = 0.9  # the probe must beat this or the array stays raw


def _recv_exact(sock: socket.socket, n: int) -> memoryview:
    """Read exactly ``n`` bytes into ONE preallocated buffer and return a
    view of it — no trailing ``bytes(buf)`` copy; ``np.frombuffer`` on the
    receive side views this buffer directly."""
    buf = bytearray(n)
    view = memoryview(buf)
    got = 0
    while got < n:
        k = sock.recv_into(view[got:], n - got)
        if k == 0:
            raise ConnectionError("peer closed")
        got += k
    return view


class FrameReader:
    """Buffered socket reads for a frame stream. Small reads (length
    words, headers, small payloads) are served from one shared buffer
    filled by large recv calls — ~1 syscall per small frame instead of 3,
    and a burst of pipelined replies often lands in ONE recv. Reads with
    an empty buffer that exceed its capacity fall through to a direct
    ``recv_into`` (multi-MiB payloads keep the single-landing-buffer
    zero-copy path with no intermediate hop).

    Duck-typed as the ``recv_into`` side of a socket so
    ``recv_frame_sized`` accepts either; each reader owns ONE stream
    (the per-connection reader threads), never a shared socket."""

    __slots__ = ("_sock", "_buf", "_lo", "_hi")

    def __init__(self, sock: socket.socket, cap: int = 1 << 16):
        self._sock = sock
        self._buf = memoryview(bytearray(cap))
        self._lo = 0
        self._hi = 0

    def buffered(self) -> bool:
        """More bytes already landed? (The server's reply-coalescing cue:
        while requests are queued in the buffer, replies batch into one
        gather write; the moment input drains, replies flush — so a
        lockstep caller never waits on a withheld reply.)"""
        return self._hi > self._lo

    def recv_into(self, view, n: int) -> int:
        avail = self._hi - self._lo
        if avail == 0:
            if n >= len(self._buf):
                return self._sock.recv_into(view, n)  # big read: direct
            self._lo = 0
            k = self._sock.recv_into(self._buf)
            if k == 0:
                return 0
            self._hi = k
            avail = k
        take = min(avail, n)
        view[:take] = self._buf[self._lo : self._lo + take]
        self._lo += take
        return take


def _compressible(a: np.ndarray) -> bool:
    """Only real-float payloads above the floor are candidates: integer key
    lists and quantized int8/int16 (and f16) chunks are already dense."""
    return a.dtype.kind == "f" and a.itemsize >= 4 and a.nbytes >= _COMP_MIN_BYTES


def _try_compress(view) -> bytes | None:
    """zlib level-1 with an adaptive probe: sample the head of a large
    array first — random float32 gradients cost CPU for ~0% savings, so an
    unpromising ratio skips the full pass. Returns None to send raw."""
    n = len(view)
    if n > _COMP_PROBE_BYTES:
        probe = zlib.compress(view[:_COMP_PROBE_BYTES], 1)
        if len(probe) > _COMP_PROBE_RATIO * _COMP_PROBE_BYTES:
            wire_counters.inc("wire_comp_skipped")
            return None
    comp = zlib.compress(view, 1)
    if len(comp) >= n:
        wire_counters.inc("wire_comp_skipped")
        return None
    return comp


# ---------------------------------------------------------------------------
# binary header codec (versioned fixed layout; ref: the protobuf Task header
# the reference packed instead of a text format). json.dumps/json.loads on
# every frame was a visible share of small-frame cost once the payload path
# went zero-copy — the codec replaces it for the fields every data-plane
# frame carries, with a JSON tail for anything else.
# ---------------------------------------------------------------------------

_BMAGIC = 0xB7  # first header byte; JSON always starts with '{' (0x7B)
# version 2 = version 1 + the serving-plane flags2 slots (ver / if_newer
# / not_modified). Flag evolution is append-only: a v1 frame never sets
# the new bits, so the v2 decoder reads both layouts; the version byte
# still hard-rejects anything newer than this build understands.
_BVERSION = 2
# version 3 = version 2 + the freshness plane. Both flag
# bytes were full, so v3 adds STRUCTURE instead of bits: a third flags
# byte rides immediately after the fixed prefix, gating the publish-ts
# and realized-age slots a freshness-stamped pull reply carries. The
# lowest-version stamping rule below extends naturally — only a frame
# that actually carries a flags3 slot is stamped 3, so every other
# frame stays decodable by v1/v2 peers.
_BVERSION3 = 3
_BVERSIONS_OK = (1, 2, 3)

# flags1
_BF_CID = 1
_BF_SEQ = 2
_BF_RSEQ = 4
_BF_EXTRA = 8
_BF_OK_TRUE = 16
_BF_OK_FALSE = 32
_BF_ZIP = 64
_BF_CMD_STR = 128
# flags2
_BF2_WORKER = 1
_BF2_SIG = 2
_BF2_CODEC = 4
_BF2_NEED_KEYS = 8
_BF2_TRANSIENT = 16
# serving plane (version 2): the RCU publish version a pull reply
# carries, the client's conditional-pull floor, and the not-modified
# reply flag — first-class slots because a serving tier pays them on
# EVERY pull; the rarer shed fields (retry_after_ms, shed) ride the
# JSON tail like any residual field
_BF2_NOT_MODIFIED = 32
_BF2_VER = 64
_BF2_IF_NEWER = 128
_BF2_V2_MASK = _BF2_NOT_MODIFIED | _BF2_VER | _BF2_IF_NEWER
# flags3 (version 3; freshness plane): the wall-clock publish timestamp
# (µs since epoch) stamped at RCU publish, and the server-computed
# realized age of the data at serve time (µs). First-class slots
# because a serving tier pays them on EVERY pull reply; any
# slot-unfit value (non-int, out of range) rides the JSON tail like
# every other residual field — the codec never gates correctness.
_BF3_PTS = 1
_BF3_AGE = 2

_BFIX = struct.Struct("<BBBBBH")  # magic, version, flags1, flags2, cmd_id, narrays
_I32 = struct.Struct("<i")
_I64 = struct.Struct("<q")
_U32 = struct.Struct("<I")

#: cmd -> compact id (1-based; 0 = absent/unknown). Append-only: ids are
#: wire contract across versions.
_CMD_IDS: dict[str, int] = {
    c: i + 1
    for i, c in enumerate((
        "push", "pull", "dump", "stats", "shutdown", "register", "nodes",
        "barrier", "kv_set", "kv_get", "workload_init", "workload_fetch",
        "workload_finish", "workload_stats", "workload_reassign", "progress",
        "progress_merged", "beat", "telemetry", "dead", "recovered",
        "ssp_init", "ssp_wait", "ssp_finish", "ssp_retire", "ssp_progress",
        "echo", "audit",
    ))
}
_CMD_NAMES = {i: c for c, i in _CMD_IDS.items()}

_B1 = tuple(bytes((i,)) for i in range(256))  # single-byte length prefixes


def _vstr(s: str) -> bytes | None:
    b = s.encode()
    if len(b) > 255:
        return None
    return _B1[len(b)] + b


def _seq_bytes(v) -> bytes | None:
    if type(v) is int:
        if not (-(1 << 63) <= v < (1 << 63)):
            return None
        return b"\x00" + _I64.pack(v)
    if type(v) is str:
        vs = _vstr(v)
        return None if vs is None else b"\x01" + vs
    return None


def _encode_bin_header(h: dict[str, Any], metas: list) -> bytes | None:
    """Encode a header dict + array-descriptor table into the binary
    layout; None when a field can't be represented at all (the caller
    falls back to JSON — correctness never depends on the binary codec
    applying; a merely slot-unfit field rides the JSON tail instead).

    ``hdr_bytes_saved`` is counted against an in-loop ESTIMATE of the
    length json.dumps would have produced (running the real thing per
    frame is exactly the cost this codec removes) — accurate to a few
    bytes per frame."""
    flags1 = flags2 = flags3 = 0
    cmd_id = 0
    cmd_b = cid_b = seq_b = rseq_b = worker_b = sig_b = codec_b = None
    ver_b = ifn_b = pts_b = age_b = None
    extra: dict[str, Any] | None = None
    est = 14  # {} plus "arrays": []
    for k, v in h.items():
        if k == "cmd":
            if type(v) is not str:
                return None
            cmd_id = _CMD_IDS.get(v, 0)
            if cmd_id == 0:
                cmd_b = _vstr(v)
                if cmd_b is None:
                    return None
                flags1 |= _BF_CMD_STR
            est += 9 + len(v)
        elif k == "_cid" and type(v) is str and (cid_b := _vstr(v)) is not None:
            flags1 |= _BF_CID
            est += 10 + len(v)
        elif k == "_seq" and (seq_b := _seq_bytes(v)) is not None:
            flags1 |= _BF_SEQ
            est += 10 + (len(str(v)) if type(v) is int else len(v) + 2)
        elif k == "_rseq" and (rseq_b := _seq_bytes(v)) is not None:
            flags1 |= _BF_RSEQ
            est += 11 + (len(str(v)) if type(v) is int else len(v) + 2)
        elif k == "ok" and v is True:
            flags1 |= _BF_OK_TRUE
            est += 12
        elif k == "ok" and v is False:
            flags1 |= _BF_OK_FALSE
            est += 13
        elif k == "zip" and type(v) is bool:
            if v:
                flags1 |= _BF_ZIP
            est += 14
        elif k == "need_keys" and v is True:
            flags2 |= _BF2_NEED_KEYS
            est += 18
        elif k == "_transient" and v is True:
            flags2 |= _BF2_TRANSIENT
            est += 19
        elif (
            k == "worker" and type(v) is int and -(1 << 31) <= v < (1 << 31)
        ):
            flags2 |= _BF2_WORKER
            worker_b = _I32.pack(v)
            est += 12 + len(str(v))
        elif k == "sig" and type(v) is str and (sig_b := _vstr(v)) is not None:
            flags2 |= _BF2_SIG
            est += 9 + len(v)
        elif k == "codec" and type(v) is int and 0 <= v < 256:
            flags2 |= _BF2_CODEC
            codec_b = _B1[v]
            est += 11
        elif (
            k == "ver" and type(v) is int and 0 <= v < (1 << 63)
        ):
            flags2 |= _BF2_VER
            ver_b = _I64.pack(v)
            est += 9 + len(str(v))
        elif (
            k == "if_newer" and type(v) is int and 0 <= v < (1 << 63)
        ):
            flags2 |= _BF2_IF_NEWER
            ifn_b = _I64.pack(v)
            est += 14 + len(str(v))
        elif k == "not_modified" and v is True:
            flags2 |= _BF2_NOT_MODIFIED
            est += 21
        elif (
            k == "pts" and type(v) is int and 0 <= v < (1 << 63)
        ):
            flags3 |= _BF3_PTS
            pts_b = _I64.pack(v)
            est += 9 + len(str(v))
        elif (
            k == "_age_us" and type(v) is int and 0 <= v < (1 << 63)
        ):
            flags3 |= _BF3_AGE
            age_b = _I64.pack(v)
            est += 13 + len(str(v))
        else:
            if extra is None:
                extra = {}
            extra[k] = v
    parts: list[bytes] = [b""]  # slot 0: the fixed prefix, packed below
    if flags3:
        # the flags3 byte rides directly after the fixed prefix, BEFORE
        # the flags1/flags2 slots — a v3 decoder reads it first, then
        # falls through the shared v1/v2 slot walk
        parts.append(_B1[flags3])
    if cmd_b is not None:
        parts.append(cmd_b)
    if cid_b is not None:
        parts.append(cid_b)
    if seq_b is not None:
        parts.append(seq_b)
    if rseq_b is not None:
        parts.append(rseq_b)
    if worker_b is not None:
        parts.append(worker_b)
    if sig_b is not None:
        parts.append(sig_b)
    if codec_b is not None:
        parts.append(codec_b)
    if ver_b is not None:
        parts.append(ver_b)
    if ifn_b is not None:
        parts.append(ifn_b)
    if pts_b is not None:
        parts.append(pts_b)
    if age_b is not None:
        parts.append(age_b)
    if len(metas) > 0xFFFF:
        return None
    for name, dt, shape, clen in metas:
        nb = _vstr(name)
        db = _vstr(dt)
        if nb is None or db is None or len(shape) > 255:
            return None
        for d in shape:
            if not 0 <= d < (1 << 32):
                return None
        parts.append(nb)
        parts.append(db)
        parts.append(_B1[len(shape)])
        parts.extend(_U32.pack(d) for d in shape)
        parts.append(_U32.pack(clen))
        est += 11 + len(name) + len(dt) + len(str(clen))
        est += sum(len(str(d)) + 1 for d in shape)
    if extra is not None:
        try:
            extra_b = json.dumps(extra).encode()
        except (TypeError, ValueError):
            return None
        flags1 |= _BF_EXTRA
        parts.append(_U32.pack(len(extra_b)))
        parts.append(extra_b)
        est += len(extra_b)
    # stamp the LOWEST version whose layout this frame actually uses: a
    # frame with no v2 slots is byte-identical to a v1 frame, and
    # stamping it 1 keeps every non-serving frame decodable by v1 peers
    # (a binary-negotiated mixed cluster must degrade, not livelock —
    # the _bh ack carries no version, so the stamp is the only guard).
    # Only a frame carrying a flags3 slot is stamped 3: the freshness
    # fields are reply decoration, so a v1/v2 peer that never asked for
    # them never receives a version-3 frame either.
    ver_byte = (
        _BVERSION3 if flags3
        else _BVERSION if flags2 & _BF2_V2_MASK
        else 1
    )
    parts[0] = _BFIX.pack(
        _BMAGIC, ver_byte, flags1, flags2, cmd_id, len(metas)
    )
    out = b"".join(parts)
    wire_counters.inc_many({
        "hdr_frames_bin": 1,
        "hdr_bytes_saved": max(est - len(out), 0),
    })
    return out


def _decode_bin_header(raw: memoryview) -> dict[str, Any]:
    """Decode the binary layout back into the header dict the JSON codec
    would have produced (``arrays`` included)."""
    buf = bytes(raw)
    magic, version, flags1, flags2, cmd_id, narrays = _BFIX.unpack_from(buf, 0)
    if version not in _BVERSIONS_OK:
        raise ValueError(f"unsupported binary header version {version}")
    off = _BFIX.size
    flags3 = 0
    if version >= _BVERSION3:
        flags3 = buf[off]
        off += 1
    h: dict[str, Any] = {}
    if flags1 & _BF_CMD_STR:
        n = buf[off]
        h["cmd"] = buf[off + 1 : off + 1 + n].decode()
        off += 1 + n
    elif cmd_id:
        # a cmd id appended by a NEWER peer must degrade to an unknown
        # command (graceful ok:False reply from the handler), not a
        # KeyError that kills the serving thread
        h["cmd"] = _CMD_NAMES.get(cmd_id) or f"unknown_cmd_{cmd_id}"
    if flags1 & _BF_CID:
        n = buf[off]
        h["_cid"] = buf[off + 1 : off + 1 + n].decode()
        off += 1 + n
    if flags1 & _BF_SEQ:
        if buf[off] == 0:
            h["_seq"] = _I64.unpack_from(buf, off + 1)[0]
            off += 9
        else:
            n = buf[off + 1]
            h["_seq"] = buf[off + 2 : off + 2 + n].decode()
            off += 2 + n
    if flags1 & _BF_RSEQ:
        if buf[off] == 0:
            h["_rseq"] = _I64.unpack_from(buf, off + 1)[0]
            off += 9
        else:
            n = buf[off + 1]
            h["_rseq"] = buf[off + 2 : off + 2 + n].decode()
            off += 2 + n
    if flags2 & _BF2_WORKER:
        h["worker"] = _I32.unpack_from(buf, off)[0]
        off += 4
    if flags2 & _BF2_SIG:
        n = buf[off]
        h["sig"] = buf[off + 1 : off + 1 + n].decode()
        off += 1 + n
    if flags2 & _BF2_CODEC:
        h["codec"] = buf[off]
        off += 1
    if flags2 & _BF2_VER:
        h["ver"] = _I64.unpack_from(buf, off)[0]
        off += 8
    if flags2 & _BF2_IF_NEWER:
        h["if_newer"] = _I64.unpack_from(buf, off)[0]
        off += 8
    if flags3 & _BF3_PTS:
        h["pts"] = _I64.unpack_from(buf, off)[0]
        off += 8
    if flags3 & _BF3_AGE:
        h["_age_us"] = _I64.unpack_from(buf, off)[0]
        off += 8
    if flags1 & _BF_OK_TRUE:
        h["ok"] = True
    elif flags1 & _BF_OK_FALSE:
        h["ok"] = False
    if flags1 & _BF_ZIP:
        h["zip"] = True
    if flags2 & _BF2_NEED_KEYS:
        h["need_keys"] = True
    if flags2 & _BF2_TRANSIENT:
        h["_transient"] = True
    if flags2 & _BF2_NOT_MODIFIED:
        h["not_modified"] = True
    metas = []
    for _ in range(narrays):
        n = buf[off]
        name = buf[off + 1 : off + 1 + n].decode()
        off += 1 + n
        n = buf[off]
        dt = buf[off + 1 : off + 1 + n].decode()
        off += 1 + n
        ndim = buf[off]
        off += 1
        shape = [
            _U32.unpack_from(buf, off + 4 * i)[0] for i in range(ndim)
        ]
        off += 4 * ndim
        clen = _U32.unpack_from(buf, off)[0]
        off += 4
        metas.append([name, dt, shape, clen])
    if flags1 & _BF_EXTRA:
        n = _U32.unpack_from(buf, off)[0]
        off += 4
        h.update(json.loads(buf[off : off + n]))
        off += n
    h["arrays"] = metas
    return h


#: control-plane commands that ride the HIGH priority lane: they must
#: never queue behind a multi-MiB pull reply sharing the connection
#: (heartbeats read as death, the SSP clock stalls every worker).
#: NOT ``shutdown``: promoting it in the client writer's lane sort would
#: reorder it AHEAD of still-queued pushes on the same connection — the
#: server would stop before applying them.
_PRIO_CMDS = frozenset({
    "beat", "barrier", "register", "nodes", "dead", "recovered", "stats",
    "ssp_init", "ssp_wait", "ssp_finish", "ssp_retire",
    "ssp_progress", "workload_fetch", "workload_finish", "workload_stats",
    "workload_reassign", "audit",
})


def _send_gather(sock, bufs: list) -> None:
    """Gather-write a frame's buffers with one-or-few ``sendmsg`` calls —
    the zero-copy half of send_frame. Transports without sendmsg (test
    sinks, exotic sockets) fall back to a single joined sendall."""
    sendmsg = getattr(sock, "sendmsg", None)
    if sendmsg is None:
        sock.sendall(b"".join(bufs))
        return
    wire_counters.inc("wire_frames_zero_copy")
    views = [memoryview(b) for b in bufs if len(b)]
    while views:
        sent = sendmsg(views[:1024])  # IOV_MAX guard for coalesced batches
        while sent:  # partial gather writes happen at multi-MiB payloads
            if sent >= len(views[0]):
                sent -= len(views[0])
                views.pop(0)
            else:
                views[0] = views[0][sent:]
                sent = 0


def build_frame(
    header: dict[str, Any], arrays: Arrays | None = None,
    bin_hdr: bool = False,
) -> tuple[list, int]:
    """Encode one framed message as a list of gather buffers (length word,
    header bytes, then each array's memoryview — no tobytes/join copies)
    plus its total wire size. Callers hand the buffers to one gather
    write, possibly COALESCED with other frames' buffers (the pipelined
    client's flusher batches a window of small frames into a single
    sendmsg). With ``zip`` in the header each eligible array is
    compressed only when the adaptive probe says it wins (meta entry:
    compressed length, 0 = raw). ``bin_hdr`` uses the binary header
    codec — callers must only pass True once the peer negotiated it
    (a field the fixed layout can't carry falls back to JSON silently)."""
    arrays = arrays or {}
    metas = []
    bufs: list = []
    plen = 0
    zip_ok = bool(header.get("zip"))
    for name, a in arrays.items():
        a = np.ascontiguousarray(a)
        chunk = memoryview(a).cast("B") if a.ndim else a.tobytes()
        clen = 0
        if zip_ok and _compressible(a):
            comp = _try_compress(chunk)
            if comp is not None:
                wire_counters.inc("wire_bytes_saved", a.nbytes - len(comp))
                chunk = comp
                clen = len(comp)
        metas.append([name, a.dtype.str, list(a.shape), clen])
        bufs.append(chunk)
        plen += len(chunk)
    hb = _encode_bin_header(header, metas) if bin_hdr else None
    if hb is None:
        h = dict(header)
        h["arrays"] = metas
        hb = json.dumps(h).encode()
    nbytes = _LEN.size + len(hb) + plen
    # frame-layer byte accounting: EVERY framed message — coordinator and
    # control traffic included — lands in the process-global counters, so
    # the cluster's wire-byte columns no longer undercount to just the
    # ServerHandle data plane
    wire_counters.inc("wire_bytes_out", nbytes)
    return [_LEN.pack(len(hb), plen), hb, *bufs], nbytes


def send_frame(
    sock: socket.socket, header: dict[str, Any], arrays: Arrays | None = None
) -> int:
    """Send one framed message; returns bytes put on the wire (ref: the
    Postoffice per-message byte counters)."""
    bufs, nbytes = build_frame(header, arrays)
    _send_gather(sock, bufs)
    return nbytes


def recv_frame_ex(
    sock: socket.socket,
) -> tuple[dict[str, Any], Arrays, int, bool]:
    """recv_frame plus the frame's wire size (for traffic counters) and
    whether the header arrived in the binary codec (the receiver's half
    of per-connection codec negotiation — the first header byte is the
    sniff: ``{`` is JSON, ``_BMAGIC`` is binary).

    Raw array chunks are returned as ``np.frombuffer`` views of the single
    preallocated receive buffer — zero copies on the landing path;
    compressed chunks (meta compressed_len > 0) decompress per array."""
    hlen, plen = _LEN.unpack(_recv_exact(sock, _LEN.size))
    hraw = _recv_exact(sock, hlen)
    was_bin = hlen > 0 and hraw[0] == _BMAGIC
    if was_bin:
        header = _decode_bin_header(hraw)
    else:
        header = json.loads(hraw.tobytes())
    payload = _recv_exact(sock, plen) if plen else memoryview(b"")
    nbytes = _LEN.size + hlen + plen
    wire_counters.inc("wire_bytes_in", nbytes)  # frame layer (see send_frame)
    arrays: Arrays = {}
    off = 0
    for name, dtype, shape, clen in header.pop("arrays", []):
        dt = np.dtype(dtype)
        n = int(np.prod(shape)) if shape else 1
        if clen:
            raw = zlib.decompress(payload[off : off + clen])
            arrays[name] = np.frombuffer(raw, dtype=dt, count=n).reshape(shape)
            off += clen
        else:
            arrays[name] = np.frombuffer(
                payload, dtype=dt, count=n, offset=off
            ).reshape(shape)
            off += n * dt.itemsize
    return header, arrays, nbytes, was_bin


def recv_frame_sized(
    sock: socket.socket,
) -> tuple[dict[str, Any], Arrays, int]:
    header, arrays, nbytes, _ = recv_frame_ex(sock)
    return header, arrays, nbytes


def recv_frame(sock: socket.socket) -> tuple[dict[str, Any], Arrays]:
    header, arrays, _, _ = recv_frame_ex(sock)
    return header, arrays


class DeferredReply:
    """Handler return marker for a reply that is not ready yet: the
    ``future`` resolves to ``(rep_header, rep_arrays)`` later (the shard
    server's batched apply engine acks a push only once its batch
    applied). The serving connection thread keeps draining buffered
    requests — pulls keep flowing past queued pushes — and settles every
    deferred reply before it would block on the socket, so 'reply sent'
    still means 'side effect durable'."""

    __slots__ = ("future",)

    def __init__(self, future: Future):
        self.future = future


class _DedupEntry:
    """One cached reply. ``event`` lets a resent/duplicated frame that
    arrives while the first delivery is still being applied (e.g. parked in
    a barrier) wait for THAT application's reply instead of re-applying."""

    __slots__ = ("event", "rep", "arrays")

    def __init__(self) -> None:
        self.event = threading.Event()
        self.rep: dict[str, Any] | None = None
        self.arrays: Arrays | None = None


# Reply-cache bounds: a pipelined client may hold a full window of
# non-idempotent requests in flight, and a reconnect resends them ALL — the
# per-client cache must cover the window (with slack for bounce re-issues)
# or a resent, already-applied push would miss the cache and double-apply.
_DEDUP_PER_CLIENT = 64
_DEDUP_CLIENTS = 1024


class RpcServer:
    """Thread-per-connection TCP server dispatching framed requests to a
    handler (the shard servers' or the coordinator's). The handler may
    raise ``Shutdown`` to stop the server after replying.

    Requests carrying a client id + sequence number are deduplicated
    through a per-client reply cache (see module docstring). A
    :class:`~parameter_server_tpu_torch.parallel.chaos.FaultPlan` may be
    armed, explicitly or through the ``PS_FAULT_PLAN`` environment
    variable, to perturb received frames for recovery testing."""

    class Shutdown(Exception):
        pass

    def __init__(
        self,
        handler: Callable[[dict[str, Any], Arrays], tuple[dict[str, Any], Arrays]],
        host: str = "127.0.0.1",
        port: int = 0,
        fault_plan: FaultPlan | None = None,
        idempotent_cmds: frozenset[str] = frozenset(),
        expose_identity: bool = False,
        blocking_cmds: frozenset[str] = frozenset(),
        prio_cmds: frozenset[str] = _PRIO_CMDS,
        lane_hi: int = 4,
        lane_lo: int = 16,
        withheld_max_bytes: int = 8 << 20,
        features: frozenset[str] = frozenset(),
    ):
        self._handler = handler
        # optional wire features this server's handler understands (e.g.
        # "qwire"): replies ack the intersection with a client's _feat
        # advert, never more — the negotiation contract that lets a
        # quantized client degrade to floats against an old server
        self._features = frozenset(features)
        # reply priority lanes: replies to prio_cmds flush first (and at a
        # tighter withheld bound) so a control ack sharing the connection
        # never queues behind a multi-MiB coalesced pull reply
        self._prio_cmds = prio_cmds
        self._lane_hi = max(1, int(lane_hi))
        self._lane_lo = max(1, int(lane_lo))
        self._withheld_max_bytes = int(withheld_max_bytes)
        # commands whose handler may PARK the connection thread (barrier,
        # ssp_wait, blocking kv_get): coalesced replies must flush before
        # dispatching one, or earlier requests' replies would be withheld
        # for as long as the blocking command parks
        self._blocking_cmds = blocking_cmds
        # re-applying these is harmless, so resends bypass the reply cache
        # entirely — caching their (potentially large: pull/dump/kv_get
        # payloads) replies would pin the arrays of the last
        # _DEDUP_PER_CLIENT requests per client for no correctness gain
        self._idempotent_cmds = idempotent_cmds
        # hand the deduped (cid, seq) identity to the handler (as _cid/_seq
        # header fields) so it can keep its own durable dedup ledger — the
        # shard server persists applied push seqs into its checkpoint
        self._expose_identity = expose_identity
        self._sock = socket.socket(socket.AF_INET, socket.SOCK_STREAM)
        self._sock.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
        self._sock.bind((host, port))
        self._sock.listen(64)
        self.address = f"{host}:{self._sock.getsockname()[1]}"
        self._stop = threading.Event()
        self.bytes_in = 0
        self.bytes_out = 0
        self.frames_in = 0
        self._counter_lock = threading.Lock()  # counters shared by conn threads
        # live withheld coalesced-reply bytes across ALL connections (the
        # lo lane pins pull payloads while withheld): the serving plane's
        # load-shedding signal, distinct from the *_peak gauge telemetry
        # keeps — shedding needs the current depth, not the high-water
        self._withheld_now = 0
        self._accept_thread: threading.Thread | None = None
        self._conns: set[socket.socket] = set()  # live, for stop() to sever
        # cid -> (seq -> _DedupEntry), both LRU-bounded
        self._dedup: OrderedDict[str, OrderedDict[int, _DedupEntry]] = OrderedDict()
        self._dedup_lock = threading.Lock()
        self.fault_plan = fault_plan if fault_plan is not None else FaultPlan.from_env()

    def start(self) -> "RpcServer":
        self._accept_thread = threading.Thread(target=self._accept, daemon=True)
        self._accept_thread.start()
        return self

    def _accept(self) -> None:
        while not self._stop.is_set():
            try:
                conn, _ = self._sock.accept()
            except OSError:
                return  # socket closed by stop()
            threading.Thread(target=self._serve, args=(conn,), daemon=True).start()

    def _serve(self, conn: socket.socket) -> None:
        conn.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        reader = FrameReader(conn)  # this thread owns the receive side
        # reply coalescing, now in TWO priority lanes: while further
        # requests sit in the read buffer (a pipelined burst), replies
        # accumulate and flush as ONE gather write with the hi (control)
        # lane ahead of the lo (bulk) lane; with nothing buffered the
        # reply flushes immediately, so lockstep latency is untouched.
        # Reordering replies across lanes is safe: pipelined clients
        # match replies by the _rseq echo, and raw no-seq clients only
        # ever see the in-order single-reply path (both lanes flush
        # together, hi first, and a raw client gets one reply per
        # lockstep request anyway).
        hi_bufs: list = []
        lo_bufs: list = []
        hi_n = lo_n = 0
        hi_frames = lo_frames = 0
        # deferred replies (batched apply): settled before this thread
        # blocks on the socket, so an acked push is always applied;
        # entries are (seq, deferred, cmd, t_svc, bin_hdr, advert,
        # feats, trace_ctx)
        deferred: list[
            tuple[
                Any, DeferredReply, str, float, bool, bool,
                list | None, dict | None,
            ]
        ] = []

        def queue_reply(
            rep: dict[str, Any], rep_arrays: Arrays | None,
            hi: bool = False, bin_hdr: bool = False,
        ) -> None:
            nonlocal hi_n, lo_n, hi_frames, lo_frames
            fb, n = build_frame(rep, rep_arrays, bin_hdr=bin_hdr)
            # flight recorder: the reply side of the frame ledger (the
            # request side records at dispatch) — rseq is the caller's
            # seq echo, the postmortem's stitch key
            flightrec.record(
                "rpc.out", rseq=rep.get("_rseq"),
                ok=rep.get("ok", True), n=n,
            )
            if hi:
                hi_bufs.extend(fb)
                hi_n += n
                hi_frames += 1
            else:
                lo_bufs.extend(fb)
                lo_n += n
                lo_frames += 1
            # reply-coalescing memory gauge: the deepest withheld-bytes
            # point any connection reached (merged cluster-wide as a max)
            wire_counters.observe_max("wire_withheld_bytes_peak", hi_n + lo_n)
            with self._counter_lock:
                self._withheld_now += n

        def flush_replies() -> None:
            nonlocal hi_bufs, lo_bufs, hi_n, lo_n, hi_frames, lo_frames
            if not hi_bufs and not lo_bufs:
                return
            _send_gather(conn, hi_bufs + lo_bufs)  # control lane first
            with self._counter_lock:
                self.bytes_out += hi_n + lo_n
                self._withheld_now -= hi_n + lo_n
            hi_bufs, lo_bufs = [], []
            hi_n = lo_n = 0
            hi_frames = lo_frames = 0

        def decorated(
            rep: dict[str, Any], seq_d: Any, adv_d: bool,
            feat_d: list | None = None, svc_us: int | None = None,
        ) -> dict[str, Any]:
            """One copy of the reply decoration: echo the request's seq
            (``_rseq``), ack the codec advert (``_bh``) and/or the
            feature advert (``_feat``), and stamp the server-observed
            service time (``_svc_us``, which JAX clients read) on a COPY
            — ``rep`` may be a shared reply-cache dict.

            A handler that stamped its reply with the publish timestamp
            (``pts``, µs epoch) gets the realized data age (``_age_us``)
            computed here, per serve: the publish ts is version-constant
            and may ride shared or cached reply dicts, but the age each
            consumer sees depends on when this serve happened, and both
            clocks are this process's, so the delta is skew-free."""
            pts_d = rep.get("pts")
            if (
                seq_d is None and not adv_d and feat_d is None
                and svc_us is None and pts_d is None
            ):
                return rep
            rep = dict(rep)
            if type(pts_d) is int:
                rep["_age_us"] = max(int(time.time() * 1e6) - pts_d, 0)
            if seq_d is not None:
                rep["_rseq"] = seq_d
            if adv_d:
                rep["_bh"] = 1
            if feat_d is not None:
                rep["_feat"] = feat_d
            if svc_us is not None:
                rep["_svc_us"] = svc_us
            return rep

        def settle_deferred() -> None:
            """Resolve every pending deferred reply into the lo lane (in
            arrival order). Called before any point where this thread
            would block on the socket or sever the connection. Entries
            pop as they settle, so on the error edge below the finally
            drain sees exactly the entries whose replies were never
            queued — none stranded, none double-counted."""
            while deferred:
                seq_d, d, cmd_d, t_d, bin_d, adv_d, feat_d, tctx_d = (
                    deferred[0]
                )
                try:
                    rep_d, arrays_d = d.future.result()
                except ConnectionError:
                    # the apply engine is stopping under this push: a
                    # clean ok:False reply would read as a PERMANENT
                    # remote error and the client would never resend —
                    # sever the connection instead, so the transport heal
                    # retries against the relaunched server (the durable
                    # ledger dedups any half-applied overlap). The
                    # still-parked remainder (this entry included) is
                    # consumed by the conn teardown's finally drain.
                    flush_replies()
                    raise
                except Exception as e:  # noqa: BLE001 — surfaced remotely
                    rep_d, arrays_d = {"ok": False, "error": repr(e)}, {}
                deferred.pop(0)
                svc_d = time.perf_counter() - t_d
                latency_histograms.observe(
                    f"server.{cmd_d}", svc_d,
                    exemplar=(tctx_d or {}).get("tid"),
                )
                queue_reply(
                    decorated(
                        rep_d, seq_d, adv_d, feat_d,
                        svc_us=int(svc_d * 1e6),
                    ),
                    arrays_d, hi=False, bin_hdr=bin_d,
                )
        with self._counter_lock:
            self._conns.add(conn)
        # register-then-check pairs with stop()'s set-then-sever: a conn
        # accepted concurrently with stop() is either seen by the sweep
        # above or bails here — it can never serve a stopped server
        if self._stop.is_set():
            with self._counter_lock:
                self._conns.discard(conn)
            try:
                conn.close()
            except OSError:
                pass
            return
        try:
            while True:
                header, arrays, nbytes, was_bin = recv_frame_ex(reader)
                with self._counter_lock:
                    self.bytes_in += nbytes
                    self.frames_in += 1
                fault = (
                    self.fault_plan.decide(header.get("cmd", ""))
                    if self.fault_plan is not None
                    else None
                )
                if fault is not None and fault.action == "drop":
                    # the fault models THIS request lost on the wire, not
                    # the whole batch: earlier requests' withheld replies
                    # still go out, or a periodic drop would livelock a
                    # pipelined client (every resend round re-killed
                    # before any reply lands)
                    settle_deferred()
                    flush_replies()
                    return  # request lost before it applied; conn closed below
                if fault is not None and fault.action == "delay":
                    time.sleep(fault.delay_s)
                cid = header.pop("_cid", None)
                seq = header.pop("_seq", None)
                tctx = header.pop("_trace", None)  # caller's span identity
                # codec negotiation: the reply rides the request's codec
                # (echo — a binary request proves the peer decodes binary);
                # a JSON request advertising _bh gets _bh acked back so the
                # client knows it may switch this connection to binary
                advert = bool(header.pop("_bh", False)) and not was_bin
                # feature negotiation: ack the intersection of the
                # client's advertised features with what this server's
                # handler actually understands (an old client sends no
                # _feat and gets no ack; an old server leaves _feat in
                # the header, which every handler ignores)
                feat_req = header.pop("_feat", None)
                feat_ack = (
                    sorted(self._features.intersection(feat_req))
                    if isinstance(feat_req, (list, tuple))
                    else None
                )
                cmd_name = header.get("cmd", "?")
                # flight recorder: every received frame with its dedup
                # identity — what the postmortem stitches across processes
                flightrec.record(
                    "rpc.in", cmd=cmd_name, cid=cid, seq=seq, n=nbytes,
                )
                # copy BEFORE dispatch: handlers mutate the header (pop cmd)
                dup_header = (
                    dict(header)
                    if fault is not None and fault.action == "duplicate"
                    else None
                )
                if (hi_bufs or lo_bufs or deferred) and (
                    cmd_name in self._blocking_cmds
                ):
                    settle_deferred()
                    flush_replies()  # see blocking_cmds in __init__
                t_svc = time.perf_counter()
                try:
                    # activate() binds the wire-borne trace context so the
                    # dispatch span (and any handler spans under it) joins
                    # the client's trace — one logical push is one trace id
                    # across processes, a JAX client's included
                    with trace.activate(tctx), trace.span(
                        f"rpc.serve.{cmd_name}", cat="rpc", bytes_in=nbytes
                    ):
                        rep, rep_arrays = self._dispatch(cid, seq, header, arrays)
                        if dup_header is not None:
                            # the same frame delivered twice: without dedup
                            # this double-applies (the copy's reply discarded)
                            self._dispatch(cid, seq, dup_header, arrays)
                    if not isinstance(rep, DeferredReply):
                        latency_histograms.observe(
                            f"server.{cmd_name}", time.perf_counter() - t_svc,
                            exemplar=(tctx or {}).get("tid"),
                        )
                except RpcServer.Shutdown:
                    try:
                        settle_deferred()
                        queue_reply(
                            decorated({"ok": True}, seq, advert, feat_ack),
                            None, hi=True, bin_hdr=was_bin,
                        )
                        flush_replies()
                    finally:
                        # stop() even when the ack send fails: the reply
                        # cache would answer a resent shutdown without
                        # re-running the handler, so nothing would ever
                        # stop the server (shutdown is the one command
                        # whose side effect happens after the reply)
                        self.stop()
                    return
                if fault is not None and fault.action == "disconnect":
                    # lose THIS reply only (see the drop branch): earlier
                    # withheld replies flush before the conn severs. A
                    # deferred apply is still settled first: 'disconnect'
                    # loses the reply, never the side effect's durability.
                    if isinstance(rep, DeferredReply):
                        try:
                            rep.future.result()
                        except Exception:  # noqa: BLE001 — reply is lost
                            pass
                    settle_deferred()
                    flush_replies()
                    return  # applied, but the reply is lost; conn closed below
                if isinstance(rep, DeferredReply):
                    deferred.append((
                        seq, rep, cmd_name, t_svc, was_bin, advert,
                        feat_ack, tctx,
                    ))
                    if len(deferred) >= 64:  # bound parked futures
                        settle_deferred()
                else:
                    # the seq echo lets a pipelined client match this
                    # reply to the right in-flight future
                    queue_reply(
                        decorated(
                            rep, seq, advert, feat_ack,
                            svc_us=int(
                                (time.perf_counter() - t_svc) * 1e6
                            ),
                        ),
                        rep_arrays,
                        hi=cmd_name in self._prio_cmds, bin_hdr=was_bin,
                    )
                # flush when input drains — or at a lane bound: withheld
                # pull replies pin their row arrays (frames AND bytes are
                # bounded), and control acks flush at the tighter hi bound
                if not reader.buffered():
                    settle_deferred()
                    flush_replies()
                elif (
                    lo_frames >= self._lane_lo
                    or hi_frames >= self._lane_hi
                    or hi_n + lo_n >= self._withheld_max_bytes
                ):
                    flush_replies()
        except (ConnectionError, OSError):
            return  # client went away; its requests died with it
        except (ValueError, KeyError, IndexError, struct.error, zlib.error):
            return  # undecodable frame: framing lost, sever the conn
        finally:
            # settle-exactly-once, exception edges included: a conn torn down by a
            # socket error or an undecodable frame may still hold parked
            # deferred replies. Their SENDS are lost with the connection
            # (the client's heal resends; the durable ledger dedups) but
            # every future is still consumed here, so a parked apply's
            # error can't vanish with the conn thread and the parked
            # result arrays drop their last reference promptly.
            for _, d, *_rest in deferred:
                wire_counters.inc("rpc_deferred_orphaned")
                try:
                    # the apply engine resolves every queued push, even
                    # at shutdown (_fail_stopping) — the timeout is a
                    # backstop, not an expected path
                    d.future.exception(timeout=30)
                except Exception:  # noqa: BLE001 — reply already lost
                    pass
            deferred.clear()
            try:
                conn.close()
            except OSError:
                pass
            with self._counter_lock:
                self._conns.discard(conn)
                # replies withheld when the conn died were never sent:
                # release their bytes from the live gauge (zero when the
                # last flush landed) so shedding can't latch on a corpse
                self._withheld_now -= hi_n + lo_n

    def _dispatch(
        self, cid: str | None, seq: int | None, header: dict[str, Any], arrays: Arrays
    ) -> tuple[dict[str, Any], Arrays]:
        """Apply-or-replay: the first delivery of (cid, seq) runs the
        handler and caches its reply; every later delivery returns that
        cached reply (waiting for it if the first is still in flight)."""
        if cid is None or seq is None:  # legacy/raw frame: no dedup contract
            return self._apply(header, arrays)
        if header.get("cmd") in self._idempotent_cmds:
            return self._apply(header, arrays)  # re-apply beats caching
        if self._expose_identity:
            header["_cid"], header["_seq"] = cid, seq
        with self._dedup_lock:
            per = self._dedup.get(cid)
            if per is None:
                per = self._dedup[cid] = OrderedDict()
                while len(self._dedup) > _DEDUP_CLIENTS:
                    self._dedup.popitem(last=False)
            else:
                self._dedup.move_to_end(cid)
            ent = per.get(seq)
            owner = ent is None
            if owner:
                ent = per[seq] = _DedupEntry()
                while len(per) > _DEDUP_PER_CLIENT:
                    per.popitem(last=False)
        if not owner:
            ent.event.wait()  # may park on a blocking command's first apply
            wire_counters.inc("rpc_dedup_hits")
            return ent.rep, ent.arrays  # type: ignore[return-value]
        try:
            rep, rep_arrays = self._apply(header, arrays)
        except RpcServer.Shutdown:
            # cache the ack a resend would expect, then let _serve stop us
            ent.rep, ent.arrays = {"ok": True}, {}
            ent.event.set()
            raise
        if not isinstance(rep, DeferredReply) and rep.get("_transient"):
            # did-not-commit reply (e.g. the shard server's need_keys
            # bounce): nothing was applied, so a later delivery of this
            # SAME (cid, seq) must re-run the handler, not replay this
            # bounce — drop the entry instead of caching it. This is what
            # lets one logical mutation keep one dedup identity across
            # the key-caching protocol's two-phase exchange.
            with self._dedup_lock:
                per = self._dedup.get(cid)
                if per is not None and per.get(seq) is ent:
                    del per[seq]
        ent.rep, ent.arrays = rep, rep_arrays
        ent.event.set()
        return rep, rep_arrays

    def _apply(
        self, header: dict[str, Any], arrays: Arrays
    ) -> tuple[dict[str, Any], Arrays]:
        try:
            return self._handler(header, arrays)
        except RpcServer.Shutdown:
            raise
        except Exception as e:  # surface handler errors to the caller
            return {"ok": False, "error": repr(e)}, {}

    def stop(self) -> None:
        self._stop.set()
        # shutdown BEFORE close: the accept thread parked in accept() holds
        # the open file description, so a bare close() leaves the kernel
        # socket listening forever — the port could never be rebound by a
        # restarted server and stop() would not actually stop accepting
        try:
            self._sock.shutdown(socket.SHUT_RDWR)
        except OSError:
            pass
        try:
            self._sock.close()
        except OSError:
            pass
        # sever live connections: a stopped server must look DEAD to its
        # clients (their self-healing reconnect logic owns what happens
        # next), not leave them parked on a half-alive socket
        with self._counter_lock:
            conns = list(self._conns)
        for c in conns:
            try:
                c.shutdown(socket.SHUT_RDWR)
            except OSError:
                pass

    def fault_stats(self) -> dict[str, int] | None:
        """Armed plan's fire counts (None when no plan is armed)."""
        return None if self.fault_plan is None else self.fault_plan.stats()

    def withheld_bytes(self) -> int:
        """Current coalesced-reply bytes withheld across every live
        connection (the serving plane's shed signal: withheld lo-lane
        replies pin their pull payload arrays until flushed)."""
        with self._counter_lock:
            return self._withheld_now


class _PendingCall:
    """One in-flight request: everything needed to complete OR resend it."""

    __slots__ = ("seq", "cmd", "header", "arrays", "future", "t0", "retry", "sent")

    def __init__(
        self, seq: Any, cmd: str, header: dict[str, Any],
        arrays: Arrays | None, retry: bool,
    ):
        self.seq = seq
        self.cmd = cmd
        self.header = header
        self.arrays = arrays
        self.future: Future = Future()
        self.t0 = time.perf_counter()
        self.retry = retry  # False: fail on a lost connection, never resend
        self.sent = False  # sent on the CURRENT connection generation


class RpcClient:
    """One persistent connection carrying a bounded window of pipelined
    requests (ref: the per-remote-node send queue, now actually async).

    ``call_async`` admits up to ``window`` seq-numbered requests onto the
    wire without waiting for replies; a reader thread matches each reply
    (by the server's ``_rseq`` echo) to its future. ``call`` is
    ``call_async(...).result()`` — so concurrent callers overlap their
    round trips instead of serializing a full RTT each.

    Self-healing: every request carries this client's id and a sequence
    number. A dead connection triggers ONE heal (transparent reconnect
    with exponential backoff + jitter, bounded by ``reconnect_timeout_s``)
    that resends every pending request with its SAME sequence number — the
    server's reply cache makes the resends exactly-once even for
    non-idempotent commands, with the whole window in flight. The window
    only bounds time spent *retrying after a failure*; a healthy blocking
    call (barrier, ssp_wait) may park indefinitely as before."""

    #: completions between window adaptations (adaptive_window)
    _ADAPT_EVERY = 64

    def __init__(
        self,
        address: str,
        retries: int = 50,
        retry_delay: float = 0.1,
        reconnect_timeout_s: float = 30.0,
        cid: str | None = None,
        start_seq: int = 0,
        window: int = 8,
        hdr_codec: str = "bin",
        adaptive_window: bool = False,
        features: frozenset[str] | tuple = (),
    ):
        """``cid``/``start_seq`` transfer a logical client identity into a
        rebuilt connection (ServerHandle recovery): the server's dedup
        state is keyed by cid, so a resend after the rebuild is only
        recognized if the identity survives. ``start_seq`` must clear the
        old client's counter or fresh requests would collide with (and be
        swallowed by) cached replies of old sequence numbers.

        ``hdr_codec="bin"`` prefers the binary header codec: requests go
        JSON carrying ``_bh: 1`` until a reply proves the peer decodes
        binary, then this connection switches (re-negotiated per
        reconnect, so a downgraded replacement server degrades to JSON).

        ``adaptive_window=True`` derives the EFFECTIVE in-flight window
        from this client's completion-latency histogram: halve on a p99
        blowup, creep back up while latency is healthy and the window is
        saturated. ``window`` stays the hard ceiling.

        ``features`` are optional wire capabilities to negotiate (the
        ``_feat`` advert): ``peer_features`` stays empty until a reply
        acks what the server supports, and resets on every reconnect."""
        self._address = address
        self._cid = cid or uuid.uuid4().hex[:16]
        self._next_seq = start_seq
        self._reconnect_timeout_s = reconnect_timeout_s
        self._window = max(1, int(window))
        self._adaptive = bool(adaptive_window)
        self._eff_window = self._window
        self._lat_hist = Histogram()  # this client's own completions
        self._adapt_last: dict[str, Any] | None = None
        self._adapt_n = 0
        self._adapt_peak = 0
        self._completed_n = 0  # watchdog probe: replies matched to futures
        self._ema_p50 = 0.0
        self._hdr_bin = hdr_codec == "bin"
        self._bin_gen_ok = False  # this connection negotiated binary
        self._rseq_gen_ok = False  # peer echoes _rseq on this connection
        self._features = frozenset(features)
        self._peer_features: frozenset[str] = frozenset()
        self._feat_gen_ok = False  # peer acked _feat on this connection
        self._rng = random.Random()  # backoff jitter: no determinism contract
        self._cv = threading.Condition()  # guards all connection/pending state
        # serializes actual socket writes (inline fast path vs the writer
        # thread) WITHOUT holding _cv: a send blocked on backpressure must
        # never starve the reader completing replies
        self._send_lock = threading.Lock()
        self._pending: OrderedDict[Any, _PendingCall] = OrderedDict()
        self._closed = False
        self._healing = False
        self._gen = 0
        self._sock: socket.socket | None = None
        self.bytes_out = 0
        self.bytes_in = 0
        # lockset race witness (PS_RACE_WITNESS=1): the pipelined window
        # map and the adaptive effective window are shared by every
        # caller, the reader/writer threads and the healer — all under
        # _cv, or the whole-window resend-on-heal accounting breaks
        race_track(
            self, ("_pending", "_eff_window"), f"RpcClient:{self._cid}"
        )
        last: Exception | None = None
        for _ in range(retries):
            try:
                sock = self._connect()
                break
            except OSError as e:  # server may still be binding
                last = e
                time.sleep(retry_delay)
        else:
            raise ConnectionError(f"cannot reach {address}: {last}")
        with self._cv:
            self._install(sock)

    def _connect(self) -> socket.socket:
        host, port = self._address.rsplit(":", 1)
        s = socket.create_connection((host, int(port)), timeout=30)
        # blocking calls (barrier, ssp_wait) may legitimately park for longer
        # than any fixed socket timeout; request-level timeouts are carried in
        # the header and enforced server-side, the launcher is the backstop
        s.settimeout(None)
        s.setsockopt(socket.IPPROTO_TCP, socket.TCP_NODELAY, 1)
        return s

    def _install(self, sock: socket.socket) -> None:
        """Adopt a connected socket (caller holds ``_cv``): bump the
        connection generation and start the generation's reader and
        writer threads."""
        self._gen += 1
        self._bin_gen_ok = False  # codec re-negotiates per connection
        self._rseq_gen_ok = False  # until the peer proves it echoes seqs
        self._feat_gen_ok = False  # features re-negotiate per connection
        self._peer_features = frozenset()
        self._sock = sock
        threading.Thread(
            target=self._read_loop, args=(sock, self._gen), daemon=True,
            name="ps-rpc-reader",
        ).start()
        threading.Thread(
            target=self._write_loop, args=(sock, self._gen), daemon=True,
            name="ps-rpc-writer",
        ).start()

    # -- completion side --------------------------------------------------

    def _read_loop(self, sock: socket.socket, gen: int) -> None:
        reader = FrameReader(sock)  # this thread owns the receive side
        while True:
            try:
                rep, arrays, nbytes, was_bin = recv_frame_ex(reader)
            except (ConnectionError, OSError):
                break
            except (ValueError, KeyError, IndexError, struct.error,
                    zlib.error):
                # undecodable frame (corrupt stream or compressed chunk,
                # incompatible codec version): framing is lost — treat
                # the connection as dead so the heal reconnects and
                # resends the window, instead of stranding every pending
                # future forever
                break
            p: _PendingCall | None = None
            bin_ok = was_bin or bool(rep.pop("_bh", False))
            feat_ack = rep.pop("_feat", None)
            with self._cv:
                if self._closed or self._gen != gen:
                    return  # stale reader: a heal already replaced this conn
                if bin_ok and self._hdr_bin and not self._bin_gen_ok:
                    # the peer proved it decodes binary (replied binary,
                    # or acked our _bh advert): switch this connection
                    self._bin_gen_ok = True
                if feat_ack is not None and not self._feat_gen_ok:
                    # the peer named the features it supports: the
                    # connection may use exactly those from here on
                    self._peer_features = frozenset(feat_ack)
                    self._feat_gen_ok = True
                self.bytes_in += nbytes
                seq = rep.pop("_rseq", None)
                if seq is not None:
                    # the peer echoes sequence numbers: reply matching is
                    # order-independent, so the writer may prioritize
                    self._rseq_gen_ok = True
                    p = self._pending.pop(seq, None)  # None: dup of a resend
                elif self._pending:
                    # reply without an echo (legacy server): per-connection
                    # dispatch is serial and in order, the oldest wins
                    _, p = self._pending.popitem(last=False)
                self._cv.notify_all()  # window space freed
            if p is not None:
                self._complete(p, rep, arrays)
        self._conn_died(sock, gen)

    def _complete(self, p: _PendingCall, rep: dict[str, Any], arrays: Arrays) -> None:
        # client-observed latency: queueing + wire + service + any
        # transparent retries/reconnects this call absorbed
        dt = time.perf_counter() - p.t0
        tid = (p.header.get("_trace") or {}).get("tid")
        latency_histograms.observe(f"client.{p.cmd}", dt, exemplar=tid)
        # latency forensics: the reply's server-timing echo splits this
        # call's wall time into wire vs server vs apply segments; the
        # slowest-K records ride the heartbeat piggyback for
        # `cli whylate --scheduler` and the `cli top` breakdown line
        slow_ops.observe(
            p.cmd, dt,
            svc_us=rep.get("_svc_us"),
            apw_us=rep.get("_apw_us"),
            apl_us=rep.get("_apl_us"),
            tid=tid,
        )
        self._completed_n += 1  # GIL-atomic; feeds the stall probe
        flightrec.record(
            "rpc.reply", cmd=p.cmd, cid=self._cid, seq=p.seq,
            ok=rep.get("ok", True),
        )
        if self._adaptive:
            self._lat_hist.observe(dt)
            self._adapt_n += 1
            if self._adapt_n >= self._ADAPT_EVERY:
                self._adapt_n = 0
                self._maybe_adapt()
        if not rep.get("ok", True):
            p.future.set_exception(
                RuntimeError(f"{p.cmd} failed remotely: {rep.get('error')}")
            )
        else:
            p.future.set_result((rep, arrays))

    def _maybe_adapt(self) -> None:
        """Adaptive window policy over the last ``_ADAPT_EVERY``
        completions' latency-histogram DELTA (log2 buckets, exact under
        subtraction): a p99 blowup past 4x the p50 EMA halves the
        effective window (queueing delay is the symptom of a window the
        server can't drain); a healthy p99 while the window was actually
        saturated grows it back one step toward the ceiling."""
        snap = self._lat_hist.snapshot()
        last, self._adapt_last = self._adapt_last, snap
        if last is None:
            return
        delta = {
            "count": snap["count"] - last.get("count", 0),
            "buckets": {
                k: c - last.get("buckets", {}).get(k, 0)
                for k, c in snap.get("buckets", {}).items()
            },
        }
        if delta["count"] <= 0:
            return
        p50 = hist_percentile(delta, 0.5)
        p99 = hist_percentile(delta, 0.99)
        if self._ema_p50 == 0.0:
            self._ema_p50 = p50
        with self._cv:
            peak, self._adapt_peak = self._adapt_peak, 0
            if p99 > 4 * max(self._ema_p50, 1e-6) and self._eff_window > 1:
                self._eff_window = max(1, self._eff_window // 2)
                wire_counters.inc("wire_window_shrinks")
            elif (
                self._eff_window < self._window
                and p99 <= 2 * max(self._ema_p50, 1e-6)
                and peak >= self._eff_window
            ):
                self._eff_window += 1
                wire_counters.inc("wire_window_grows")
                self._cv.notify_all()  # a waiter may now fit the window
        self._ema_p50 = 0.8 * self._ema_p50 + 0.2 * p50

    @property
    def effective_window(self) -> int:
        """Current in-flight bound (the configured window unless
        adaptive_window is shaping it)."""
        with self._cv:
            return self._eff_window

    @property
    def peer_features(self) -> frozenset[str]:
        """Features the CURRENT connection's peer acked (empty until the
        first ack, and after every reconnect until re-negotiated) —
        callers must treat an empty set as 'assume the baseline wire'."""
        with self._cv:
            return self._peer_features

    def _conn_died(self, sock: socket.socket, gen: int) -> None:
        """A connection failed under its reader (or a sender): tear it
        down and, when requests are stranded in flight, run the heal."""
        flightrec.record(
            "rpc.conn_died", addr=self._address, cid=self._cid, gen=gen,
        )
        heal = False
        with self._cv:
            if self._closed or self._gen != gen:
                return
            if self._sock is sock:
                try:
                    sock.close()
                except OSError:
                    pass
                self._sock = None
            if self._pending and not self._healing:
                self._healing = True
                heal = True
            self._cv.notify_all()
        if heal:
            self._heal()

    # -- healing ----------------------------------------------------------

    def _heal(self) -> None:
        """Reconnect and resend EVERY pending request under the same cid +
        sequence numbers (the server's reply cache turns the at-least-once
        resends into exactly-once applies, whole window included). Caller
        owns ``self._healing``. On an exhausted window every pending
        future fails with ConnectionError."""
        wire_counters.inc("rpc_retries")
        trace.instant("rpc.retry", cat="rpc", addr=self._address)
        if trace.enabled():
            # the heal usually runs on a reader/writer thread with no
            # live span: mark the retry on EVERY stranded call's OWN
            # trace (explicit ctx), so tail capture's anomaly gate
            # promotes the traces that actually absorbed this reconnect
            with self._cv:
                tctxs = [
                    p.header.get("_trace") for p in self._pending.values()
                ]
            for tctx in tctxs:
                if tctx:
                    trace.instant(
                        "rpc.retry", cat="rpc", ctx=tctx,
                        addr=self._address,
                    )
        flightrec.record(
            "rpc.heal.begin", addr=self._address, cid=self._cid,
        )
        deadline = time.monotonic() + self._reconnect_timeout_s
        attempt = 0
        while True:
            with self._cv:
                closed = self._closed
                # futures that opted out of retrying die with the conn
                doomed = (
                    [] if closed
                    else [p for p in self._pending.values() if not p.retry]
                )
                for p in doomed:
                    del self._pending[p.seq]
            if closed:
                self._abort_heal(
                    ConnectionError(f"client to {self._address} is closed")
                )
                return
            for p in doomed:
                p.future.set_exception(
                    ConnectionError(f"connection to {self._address} lost")
                )
            try:
                sock = self._connect()
            except OSError as e:
                if time.monotonic() >= deadline:
                    self._abort_heal(ConnectionError(
                        f"server {self._address} unreachable for "
                        f"{self._reconnect_timeout_s}s: {e}"
                    ))
                    return
                # exponential backoff + jitter: a server resetting every
                # connect must not be hammered at full speed, and lockstep
                # clients must not reconnect in synchronized waves
                delay = min(0.05 * (1 << min(attempt, 6)), 2.0)
                delay *= 0.5 + self._rng.random()
                time.sleep(min(delay, max(deadline - time.monotonic(), 0.0)))
                attempt += 1
                continue
            with self._cv:
                closed = self._closed
                if not closed:
                    self._install(sock)
                    pend = list(self._pending.values())
            if closed:
                try:
                    sock.close()
                except OSError:
                    pass
                self._abort_heal(
                    ConnectionError(f"client to {self._address} is closed")
                )
                return
            wire_counters.inc("rpc_reconnects")
            trace.instant("rpc.reconnect", cat="rpc", addr=self._address)
            try:
                # one coalesced gather: the whole stranded window resends
                # in a single write, same seqs (dedup makes it exactly-once)
                bufs: list = []
                total = 0
                for p in pend:
                    fb, n = build_frame(p.header, p.arrays)
                    bufs.extend(fb)
                    total += n
                if bufs:
                    _send_gather(sock, bufs)
                with self._cv:
                    self.bytes_out += total
                    for p in pend:
                        p.sent = True
            except (ConnectionError, OSError):
                # the replacement died mid-resend: drop it and retry
                # within the same window (its reader sees a stale gen
                # after the next install, or tears the sock down first)
                with self._cv:
                    if self._sock is sock:
                        try:
                            sock.close()
                        except OSError:
                            pass
                        self._sock = None
                if time.monotonic() >= deadline:
                    self._abort_heal(ConnectionError(
                        f"server {self._address} kept resetting for "
                        f"{self._reconnect_timeout_s}s"
                    ))
                    return
                continue
            with self._cv:
                # the resend "succeeded" locally (bytes in the kernel
                # buffer), but the replacement may ALREADY be dead: its
                # reader, seeing EOF while _healing was still True,
                # deferred to this heal (see _conn_died) and nulled the
                # socket. Declaring victory then would strand the whole
                # window — sent-claimed pending entries with no socket,
                # no writer and no healer (a real livelock caught by the
                # chaos drills under load). Only a still-installed
                # socket ends the heal; otherwise retry in-window.
                healed = self._sock is sock
                if healed:
                    self._healing = False
                    self._cv.notify_all()
            if not healed:
                if time.monotonic() >= deadline:
                    self._abort_heal(ConnectionError(
                        f"server {self._address} kept resetting for "
                        f"{self._reconnect_timeout_s}s"
                    ))
                    return
                continue
            flightrec.record(
                "rpc.healed", addr=self._address, cid=self._cid,
                resent=len(pend),
            )
            return

    def _abort_heal(self, exc: Exception) -> None:
        """Fail every pending future and release the heal. Futures complete
        OUTSIDE the lock: a done-callback may issue a follow-up call on
        this client, and ``_cv`` is not reentrant."""
        flightrec.record(
            "rpc.heal.failed", addr=self._address, cid=self._cid,
        )
        with self._cv:
            failed = list(self._pending.values())
            self._pending.clear()
            self._healing = False
            self._cv.notify_all()
        for p in failed:
            if not p.future.done():
                p.future.set_exception(exc)

    # -- issue side -------------------------------------------------------

    def call_async(
        self, cmd: str, arrays: Arrays | None = None, *, _retry: bool = True,
        _seq: int | str | None = None, _urgent: bool = False,
        _inline: bool = False, **fields: Any,
    ) -> Future:
        """Issue one request without waiting for its reply; returns a
        Future of ``(reply_header, reply_arrays)`` (failed remotely =>
        RuntimeError, connection exhausted => ConnectionError).

        ``_seq`` overrides the auto-allocated sequence number: a caller
        that re-issues a logical request across *rebuilt* clients (e.g.
        ``ServerHandle._keyed_call``) passes the same value each time so
        every delivery is one dedup identity. Caller-owned seqs must live
        in a disjoint namespace (the handle uses ``"k<n>"`` strings) so
        they can never collide with the internal integer counter.

        ``_retry=False`` opts this call out of the heal: a lost connection
        fails it with ConnectionError instead of resending it (a caller
        that would rather re-decide than replay).

        ``_urgent`` bypasses the window bound — ONLY for re-issues of an
        already-admitted logical call (the need_keys bounce), which may
        run on the reader thread and must never block on window space
        that same thread is responsible for freeing."""
        with trace.span(f"rpc.{cmd}", cat="rpc", addr=self._address):
            # propagate this span's identity in the header so the server's
            # dispatch span joins the same trace
            ctx = trace.wire_context()
            with self._cv:
                if not _urgent:
                    self._cv.wait_for(
                        lambda: self._closed
                        or len(self._pending) < self._eff_window
                    )
                if self._closed:
                    raise ConnectionError(
                        f"client to {self._address} is closed"
                    )
                if _seq is None:
                    _seq = self._next_seq
                    self._next_seq += 1
                header = {"cmd": cmd, "_cid": self._cid, "_seq": _seq, **fields}
                if self._hdr_bin and not self._bin_gen_ok:
                    # codec advert: ask the peer to confirm binary headers
                    # (ignored by old servers, acked by new ones)
                    header["_bh"] = 1
                if self._features and not self._feat_gen_ok:
                    # feature advert (see __init__): repeats until the
                    # first ack; old servers leave it in the header,
                    # where every handler ignores it
                    header["_feat"] = sorted(self._features)
                if ctx is not None:
                    header["_trace"] = ctx
                p = _PendingCall(_seq, cmd, header, arrays, _retry)
                self._pending[_seq] = p
                flightrec.record(
                    "rpc.issue", cmd=cmd, cid=self._cid, seq=_seq,
                )
                if len(self._pending) > self._adapt_peak:
                    self._adapt_peak = len(self._pending)
                wire_counters.observe_max(
                    "rpc_inflight_peak", len(self._pending)
                )
                sock, gen = self._sock, self._gen
                # fast path for LATENCY-bound callers (sync `call`): no
                # unsent backlog and a live conn — claim and send inline,
                # skipping the writer-thread handoff a lockstep caller
                # would only pay latency for. THROUGHPUT-bound async
                # callers skip it: their frames queue for the writer,
                # whose batches coalesce into single gather writes (and
                # arrive at the server as bursts its reply coalescing
                # batches right back).
                inline = (
                    _inline
                    and sock is not None
                    and not self._healing
                    and not any(
                        q is not p and not q.sent and not q.future.done()
                        for q in self._pending.values()
                    )
                )
                use_bin = self._hdr_bin and self._bin_gen_ok
                if inline:
                    p.sent = True
                else:
                    self._cv.notify_all()  # wake the connection's writer
            if inline:
                bufs, n = build_frame(p.header, p.arrays, bin_hdr=use_bin)
                try:
                    with self._send_lock:
                        # psl: ignore[blocking-under-lock]: _send_lock exists solely to serialize writes to one socket between this inline fast path and the writer thread; it guards no other state and the reader thread never takes it
                        _send_gather(sock, bufs)
                    with self._cv:
                        self.bytes_out += n
                except (ConnectionError, OSError):
                    self._conn_died(sock, gen)  # heal resends the claim
            else:
                self._pump(p)
        return p.future

    def _pump(self, p: _PendingCall) -> None:
        """After registering ``p``: make sure a connection exists for the
        writer thread to carry it, healing (or failing fast for no-retry
        callers) when the wire is down."""
        while True:
            with self._cv:
                if p.future.done() or p.sent:
                    return
                if self._healing:
                    self._cv.wait()  # the healer resends p for us
                    continue
                if self._sock is not None:
                    return  # the connection's writer thread owns the send
                if self._closed or not p.retry:
                    self._pending.pop(p.seq, None)
                    self._cv.notify_all()
                    raise ConnectionError(
                        f"client to {self._address} is "
                        + ("closed" if self._closed else "disconnected")
                    )
                # connection down and nobody healing: this caller becomes
                # the healer (fresh retry window)
                self._healing = True
            self._heal()

    def _write_loop(self, sock: socket.socket, gen: int) -> None:
        """The connection's writer: drain every unsent pending frame,
        COALESCING each batch into one gather write. While a sendmsg
        blocks on backpressure, new requests pile up in pending — so with
        syscall-priced hosts and small frames a full window rides ONE
        syscall, and the peer's FrameReader often picks the burst up in
        one recv. Claims (``sent``) happen under the lock BEFORE the
        write: a died connection hands everything to the heal, which
        resends the whole pending map regardless of claims."""
        while True:
            with self._cv:
                while True:
                    if self._closed or self._gen != gen or self._sock is not sock:
                        return
                    if not self._healing:
                        batch = [
                            q for q in self._pending.values()
                            if not q.sent and not q.future.done()
                        ]
                        if batch:
                            break
                    self._cv.wait()
                for q in batch:
                    q.sent = True  # claimed; heal ignores claims on resend
                use_bin = self._hdr_bin and self._bin_gen_ok
                prio_ok = self._rseq_gen_ok
            # two-lane writer: control frames (heartbeat, ssp clock,
            # workload fetch) lead the coalesced gather so they never
            # queue behind a multi-MiB push sharing this connection
            # (stable sort: FIFO preserved within each lane). ONLY once
            # the peer has echoed an _rseq: a legacy no-echo server is
            # matched by reply ORDER, which reordering would corrupt.
            if prio_ok:
                batch.sort(key=lambda q: q.cmd not in _PRIO_CMDS)
            bufs: list = []
            total = 0
            for q in batch:
                fb, n = build_frame(q.header, q.arrays, bin_hdr=use_bin)
                bufs.extend(fb)
                total += n
            if len(batch) > 1:
                wire_counters.inc("wire_frames_coalesced", len(batch) - 1)
            try:
                with self._send_lock:
                    # psl: ignore[blocking-under-lock]: _send_lock exists solely to serialize socket writes between the writer thread and the inline fast path; a send parked on backpressure is the socket's own flow control, not contended state
                    _send_gather(sock, bufs)
            except (ConnectionError, OSError):
                self._conn_died(sock, gen)  # heal resends the claimed batch
                return
            with self._cv:
                self.bytes_out += total

    def call(
        self, cmd: str, arrays: Arrays | None = None, *, _retry: bool = True,
        _seq: int | str | None = None, **fields: Any,
    ) -> tuple[dict[str, Any], Arrays]:
        """Synchronous round trip: ``call_async(...).result()`` on the
        latency fast path. Concurrent callers pipeline on the shared
        window instead of serializing."""
        fut = self.call_async(
            cmd, arrays, _retry=_retry, _seq=_seq, _inline=True, **fields
        )
        return fut.result()

    def stall_probe(self) -> tuple[bool, int]:
        """Watchdog probe for data-plane clients (pull/push pipelines,
        where no command legitimately parks): busy while requests are in
        flight and no heal owns them; progress is matched completions.
        Control clients (barrier/ssp_wait park by design) must NOT be
        registered on this."""
        with self._cv:
            return (
                bool(self._pending) and not self._healing and not self._closed,
                self._completed_n,
            )

    @property
    def identity(self) -> tuple[str, int]:
        """(cid, next unused internal seq) — transfer into a replacement
        client (``RpcClient(..., cid=, start_seq=)``) so the server's
        dedup state keeps recognizing the logical caller across rebuilds."""
        with self._cv:
            return self._cid, self._next_seq

    def close(self) -> None:
        with self._cv:
            self._closed = True  # no reconnects on behalf of a closed client
            sock, self._sock = self._sock, None
            failed = list(self._pending.values())
            self._pending.clear()
            self._cv.notify_all()
        if sock is not None:
            try:
                sock.close()
            except OSError:
                pass
        for p in failed:
            if not p.future.done():
                p.future.set_exception(
                    ConnectionError(f"client to {self._address} is closed")
                )


class Coordinator:
    """The scheduler endpoint (ref: Postoffice on the scheduler node).

    Owns: node registry, named barriers, a blob KV (small host arrays),
    the workload pool, merged progress, heartbeats, and the SSP clock.
    All commands are served by ``RpcServer`` threads; blocking commands
    (barrier / blocking kv_get / ssp_wait) park the connection's thread.

    Self-healing control plane: ``start_recovery`` runs a sweep thread that
    promotes ``HeartbeatMonitor.dead()`` into ``WorkloadPool.
    reassign_worker`` + SSP-clock release, so a dead worker's tasks drain
    onto survivors without any scheduler-side polling logic.
    """

    def __init__(
        self,
        host: str = "127.0.0.1",
        port: int = 0,
        heartbeat_timeout_s: float = 30.0,
        recovery_interval_s: float = 0.0,
        fault_plan: FaultPlan | None = None,
        slo_cfg: "SloConfig | None" = None,
        series_capacity: int = 360,
        series_window_s: float = 60.0,
        audit_cfg: "AuditConfig | None" = None,
    ):
        from parameter_server_tpu_torch.utils.auditor import Auditor
        from parameter_server_tpu_torch.utils.config import SloConfig
        from parameter_server_tpu_torch.utils.slo import SloEngine, parse_rules
        from parameter_server_tpu_torch.utils.timeseries import TimeSeriesRing

        self._nodes: dict[int, dict[str, Any]] = {}
        self._next_id = 0
        self._barriers: dict[str, list[int]] = {}  # name -> [arrived, generation]
        self._kv: dict[str, tuple[dict, Arrays]] = {}
        self._pool: WorkloadPool | None = None
        self._progress: dict[int, dict[str, Any]] = {}
        self._monitor = HeartbeatMonitor(
            heartbeat_timeout_s, series_capacity=series_capacity
        )
        # the live-ops plane: per-node telemetry history is retained by
        # the monitor; this engine turns it into multi-window burn-rate
        # alerts, evaluated on every recovery sweep (alerts fire with no
        # viewer attached) and on every telemetry query
        scfg = slo_cfg or SloConfig()
        self._slo = SloEngine(
            parse_rules(scfg.rules),
            short_window_s=scfg.short_window_s,
            long_window_s=scfg.long_window_s,
        )
        self._series_window_s = series_window_s
        # the scheduler process never heartbeats to itself, but it owns
        # cluster-level signals (the SSP clock's ssp_blocked_ms, control
        # dedup/recovery counters): its own ring, fed by _observe_self()
        # on every sweep/telemetry pass, rate-limited so a polling
        # dashboard can't flood it with sub-second entries
        self._self_ring = TimeSeriesRing(series_capacity)
        self._self_last = 0.0
        # the live audit plane: heartbeat-piggybacked event batches from
        # every node stream through the shared protocol monitors here;
        # the coordinator's own spooled events are drained inline each
        # sweep as the "coord" stream
        self._auditor = Auditor(audit_cfg)
        self._clock: SSPClock | None = None
        self._cv = threading.Condition()
        # batched beat/progress ingestion: these commands arrive from
        # EVERY node at heartbeat cadence. Frames land in this deque
        # (GIL-atomic append, no lock) and ONE serving thread at a time
        # drains everything queued under a single _cv acquire + a single
        # monitor-lock acquire (beat_many); concurrent ingest threads skip
        # the drain and their frames ride the owner's loop. Beats and
        # progress are last-writer-wins telemetry; readers (dead /
        # telemetry / progress_merged / sweep) drain with wait=True first,
        # so every frame acked before a read is visible to it.
        self._ingest: deque[tuple[str, int, Any]] = deque()
        self._ingest_lock = threading.Lock()  # one drainer at a time
        self._recovered: dict[int, dict[str, Any]] = {}  # worker rank -> info
        self._sweep_stop = threading.Event()
        self._sweep_thread: threading.Thread | None = None
        self.server = RpcServer(
            self._handle, host, port, fault_plan=fault_plan,
            # reads and last-writer-wins/monotonic writes: re-applying a
            # resend is harmless, and kv_get replies can carry model-sized
            # blobs that must not be pinned in the reply cache
            idempotent_cmds=frozenset({
                "kv_get", "kv_set", "nodes", "beat", "progress",
                "progress_merged", "workload_stats", "ssp_progress",
                "telemetry", "audit",
            }),
            blocking_cmds=frozenset({"barrier", "ssp_wait", "kv_get"}),
        )
        self.server.start()
        self.address = self.server.address
        if recovery_interval_s > 0:
            self.start_recovery(recovery_interval_s)

    # -- recovery sweep --------------------------------------------------

    def start_recovery(self, interval_s: float = 0.5) -> None:
        """Arm the dead-node sweep (idempotent): every ``interval_s`` the
        monitor's overdue workers have their workloads requeued and their
        SSP clock retired, so surviving workers drain their tasks."""
        if self._sweep_thread is not None:
            return

        def sweep() -> None:
            while not self._sweep_stop.wait(interval_s):
                self._sweep_once()

        self._sweep_thread = threading.Thread(
            target=sweep, daemon=True, name="ps-coord-sweep"
        )
        self._sweep_thread.start()

    def _observe_self(self) -> None:
        """Roll the coordinator's own telemetry into its ring (at most
        ~4x/second however often sweeps and dashboards ask)."""
        now = time.time()
        if now - self._self_last < 0.25:
            return
        self._self_last = now
        self._self_ring.observe(
            telemetry_snapshot(roll_peaks=False), ts=now
        )

    def _slo_rings(self) -> dict[Any, Any]:
        return {**self._monitor.node_series(), "coord": self._self_ring}

    def _audit_pass(self) -> None:
        """One audit-plane pass: drain this process's own event spool
        (when armed) into the auditor as the "coord" stream, then run
        the watermark flush so unpaired facts past their window become
        violations. Rides the sweep and every audit/telemetry query:
        violations must fire with no viewer attached."""
        sp = flightrec.audit_spool()
        if sp is not None:
            batches = sp.drain(max_batches=16)
            if batches:
                self._auditor.ingest("coord", batches, role="coordinator")
                sp.ack()  # no wire between drain and ingest: always lands
        self._auditor.flush()

    def _sweep_once(self) -> None:
        self._drain_ingest(wait=True)  # a queued beat must not read dead
        # SLO pass rides the sweep cadence: alerts must fire (and land in
        # the flight recorder) even when nobody is watching `cli top`.
        # Audit first: a violation bumped now is in the snapshot the
        # self-ring roll below hands the burn-rate engine.
        self._audit_pass()
        self._observe_self()
        self._slo.evaluate(self._slo_rings())
        for nid in self._monitor.dead():
            with self._cv:
                info = dict(self._nodes.get(nid, {}))
            if info.get("role") != "worker" or "rank" not in info:
                continue  # dead servers are the scheduler's call (grace /
                # checkpoint-restart policy lives there, not here)
            rank = int(info["rank"])
            with self._cv:
                finished = f"worker_done/{rank}" in self._kv
            if finished:
                # clean completion: drop the corpse so dead() stays the
                # actionable list
                self._monitor.forget(nid)
                continue
            # no handled-before guard: forget(nid) below keeps a handled
            # death out of dead(), and a forgotten node only reappears
            # through a fresh beat, i.e. it was alive again and may hold
            # fresh workloads, so its next death must be recovered too
            requeued = self._pool.reassign_worker(rank) if self._pool else []
            if self._clock is not None:
                self._clock.retire(rank)
            with self._cv:
                self._recovered[rank] = {"node_id": nid, "requeued": requeued}
                self._cv.notify_all()
            self._monitor.forget(nid)
            wire_counters.inc("workers_recovered")
            flightrec.record(
                "coord.dead_worker", rank=rank, node=nid,
                requeued=len(requeued),
            )

    # -- dispatch --------------------------------------------------------

    def _handle(
        self, header: dict[str, Any], arrays: Arrays
    ) -> tuple[dict[str, Any], Arrays]:
        cmd = header.pop("cmd")
        fn = getattr(self, f"_cmd_{cmd}", None)
        if fn is None:
            raise ValueError(f"unknown control command {cmd!r}")
        return fn(header, arrays)

    def _cmd_register(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        with self._cv:
            node_id = self._next_id
            self._next_id += 1
            self._nodes[node_id] = {"role": h.get("role", "?"), **h}
            self._cv.notify_all()
        return {"ok": True, "node_id": node_id}, {}

    def _cmd_nodes(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        with self._cv:
            # copy: serialization happens after the lock is released
            return {"ok": True, "nodes": dict(self._nodes)}, {}

    def _cmd_barrier(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        """Block until ``count`` callers reach barrier ``name`` (ref:
        Postoffice::Barrier over node groups)."""
        name, count = h["name"], int(h["count"])
        with self._cv:
            st = self._barriers.setdefault(name, [0, 0])
            st[0] += 1
            if st[0] >= count:
                st[0] = 0
                st[1] += 1
                self._cv.notify_all()
                return {"ok": True}, {}
            gen = st[1]
            ok = self._cv.wait_for(
                lambda: self._barriers[name][1] > gen, timeout=h.get("timeout")
            )
            if not ok and self._barriers[name][1] == gen:
                st[0] -= 1  # withdraw our arrival: a later generation must
                # not release early on a participant that already gave up
        return {"ok": ok, "error": "barrier timeout" if not ok else None}, {}

    def _cmd_kv_set(self, h: dict, arrays: Arrays) -> tuple[dict, Arrays]:
        with self._cv:
            self._kv[h["key"]] = ({"fields": h.get("fields", {})}, arrays)
            self._cv.notify_all()
        return {"ok": True}, {}

    def _cmd_kv_get(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        key = h["key"]
        with self._cv:
            if h.get("block"):
                if not self._cv.wait_for(
                    lambda: key in self._kv, timeout=h.get("timeout")
                ):
                    return {"ok": False, "error": f"kv_get timeout on {key!r}"}, {}
            if key not in self._kv:
                return {"ok": True, "found": False}, {}
            meta, arrays = self._kv[key]
            return {"ok": True, "found": True, **meta}, arrays

    def _cmd_workload_init(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        with self._cv:
            if self._pool is None:
                self._pool = WorkloadPool(h["items"])
        return {"ok": True}, {}

    def _pool_or_raise(self) -> WorkloadPool:
        # explicit raise, not assert: must hold under ``python -O``
        if self._pool is None:
            raise RuntimeError("workload_init must be called first")
        return self._pool

    def _clock_or_raise(self) -> SSPClock:
        if self._clock is None:
            raise RuntimeError("ssp_init must be called first")
        return self._clock

    def _cmd_workload_fetch(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        pool = self._pool_or_raise()
        return {"ok": True, "workload": pool.fetch(int(h["worker"]))}, {}

    def _cmd_workload_finish(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        self._pool_or_raise().finish(h["workload"])
        return {"ok": True}, {}

    def _cmd_workload_stats(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        pool = self._pool_or_raise()
        return {"ok": True, "stats": pool.stats(), "all_done": pool.all_done}, {}

    def _cmd_workload_reassign(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        """Requeue workloads of a dead worker and/or stragglers by age."""
        pool = self._pool_or_raise()
        requeued: list[str] = []
        if h.get("worker") is not None:
            requeued += pool.reassign_worker(int(h["worker"]))
        if h.get("older_than") is not None:
            requeued += pool.reassign_stragglers(float(h["older_than"]))
        return {"ok": True, "requeued": requeued}, {}

    def _cmd_progress(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        self._ingest.append(("progress", int(h["worker"]), h["record"]))
        self._drain_ingest()
        return {"ok": True}, {}

    def _cmd_progress_merged(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        self._drain_ingest(wait=True)  # every acked progress is merged
        with self._cv:
            reports = [dict(r) for r in self._progress.values()]
        return {"ok": True, "merged": merge_progress(reports)}, {}

    def _cmd_beat(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        self._ingest.append(("beat", int(h["node_id"]), h.get("stats")))
        self._drain_ingest()
        return {"ok": True}, {}

    def _drain_ingest(self, wait: bool = False) -> None:
        """Apply every queued beat/progress frame in batches: progress
        records under ONE ``_cv`` acquire, beats under ONE monitor lock
        (``beat_many``). Ingest callers pass ``wait=False``: if another
        thread owns the drain, this frame rides that thread's loop.
        Readers pass ``wait=True`` so they observe every frame whose reply
        has been (or is being) sent before they read."""
        if not self._ingest_lock.acquire(blocking=wait):
            return
        try:
            while True:
                batch: list[tuple[str, int, Any]] = []
                while True:
                    try:
                        batch.append(self._ingest.popleft())
                    except IndexError:
                        break
                if not batch:
                    return
                beats = [(k, v) for t, k, v in batch if t == "beat"]
                prog = [(k, v) for t, k, v in batch if t == "progress"]
                if prog:
                    with self._cv:
                        for worker, record in prog:
                            self._progress[worker] = record
                        self._cv.notify_all()
                # audit plane: peel each beat's piggybacked event batches
                # before the monitor retains the stats (latest_stats is a
                # telemetry view, not an event bus), then feed them after
                # the monitor lock is released — the auditor locks itself
                audit_feed: list[tuple[int, list]] = []
                for node_id, stats in beats:
                    if isinstance(stats, dict):
                        batches = stats.pop("audit", None)
                        if batches:
                            audit_feed.append((node_id, batches))
                if beats:
                    self._monitor.beat_many(beats)
                if audit_feed:
                    # role hints tighten hole-suppression targeting (a
                    # holed worker stream cannot hide a missing commit)
                    with self._cv:
                        roles = {
                            nid: self._nodes.get(nid, {}).get("role")
                            for nid, _ in audit_feed
                        }
                    for node_id, batches in audit_feed:
                        self._auditor.ingest(
                            node_id, batches, role=roles.get(node_id)
                        )
                if len(batch) > 1:
                    wire_counters.inc("coord_ingest_coalesced", len(batch) - 1)
                # loop: frames appended while we applied are ours too
        finally:
            self._ingest_lock.release()

    def _cmd_telemetry(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        """Cluster telemetry: every node's last heartbeat piggybacked a
        counters+histograms snapshot; this merges them, plus the
        coordinator's own process, into one cluster view, and returns the
        per-node detail, each node's windowed ``series`` summary, the SLO
        engine's verdict and the audit plane's summary."""
        self._drain_ingest(wait=True)  # acked beats are in latest_stats
        with self._cv:
            registry = {int(k): dict(v) for k, v in self._nodes.items()}
        per_node: dict[str, dict[str, Any]] = {}
        node_snaps: list[dict[str, Any]] = []
        for nid, stats in self._monitor.latest_stats().items():
            stats = dict(stats)
            tel = stats.pop("telemetry", None)
            info = registry.get(nid, {})
            per_node[str(nid)] = {
                "role": info.get("role", "?"),
                "rank": info.get("rank"),
                "stats": stats,
                "telemetry": tel,
            }
            if tel:
                node_snaps.append(tel)
        local = telemetry_snapshot()  # the coordinator's own process
        # the live-ops view: per-node windowed rates/p50/p99 from the
        # retained beat history + the SLO engine's verdict ("coord" is
        # the scheduler process itself: SSP blocked time and
        # control-plane counters live only there)
        self._observe_self()
        window_s = float(h.get("window_s") or self._series_window_s)
        rings = self._slo_rings()
        series = {
            str(nid): ring.summary(window_s)
            for nid, ring in rings.items()
        }
        self._audit_pass()
        return {
            "ok": True,
            "nodes": per_node,
            "coordinator": local,
            "merged": merge_telemetry(node_snaps + [local]),
            "series": series,
            "slo": self._slo.evaluate(rings),
            "audit": self._auditor.summary(),
        }, {}

    def _cmd_audit(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        """The audit plane's read endpoint (``cli audit``): violation
        totals/panel + per-node stream accounting, after draining any
        queued beats (an acked batch is visible) and a watermark pass."""
        self._drain_ingest(wait=True)
        self._audit_pass()
        return {
            "ok": True,
            "audit": self._auditor.summary(
                recent=int(h.get("recent") or 20)
            ),
        }, {}

    def _cmd_dead(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        self._drain_ingest(wait=True)  # an acked beat must never read dead
        return {
            "ok": True, "dead": self._monitor.dead(), "alive": self._monitor.alive(),
        }, {}

    def _cmd_recovered(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        """Worker ranks the recovery sweep has already handled (requeued +
        clock-retired); the scheduler merges these instead of running its
        own dead-worker logic."""
        with self._cv:
            return {
                "ok": True,
                "recovered": {str(r): dict(v) for r, v in self._recovered.items()},
            }, {}

    def _cmd_ssp_init(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        with self._cv:
            if self._clock is None:
                self._clock = SSPClock(int(h["num_workers"]), int(h["max_delay"]))
                # a wedged clock (workers parked, nothing finishing) is
                # one of the stalls the watchdog exists to catch
                watchdog.register(
                    f"ssp-clock:{id(self._clock)}",
                    self._clock.stall_probe,
                )
                # the audit plane's SSP monitor checks granted gate
                # passes against exactly this bound (dormant until told)
                self._auditor.set_ssp(
                    int(h["num_workers"]), int(h["max_delay"])
                )
        return {"ok": True}, {}

    def _cmd_ssp_wait(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        clock = self._clock_or_raise()
        ok = clock.wait(int(h["worker"]), int(h["step"]), h.get("timeout"))
        return {"ok": True, "granted": ok}, {}

    def _cmd_ssp_finish(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        self._clock_or_raise().finish(int(h["worker"]), int(h["step"]))
        return {"ok": True}, {}

    def _cmd_ssp_retire(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        self._clock_or_raise().retire(int(h["worker"]))
        return {"ok": True}, {}

    def _cmd_ssp_progress(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        return {"ok": True, **self._clock_or_raise().progress()}, {}

    def _cmd_shutdown(self, h: dict, _: Arrays) -> tuple[dict, Arrays]:
        raise RpcServer.Shutdown

    def stop(self) -> None:
        self._sweep_stop.set()
        if self._sweep_thread is not None:
            self._sweep_thread.join(timeout=5)
            self._sweep_thread = None
        with self._cv:
            if self._clock is not None:
                watchdog.unregister(f"ssp-clock:{id(self._clock)}")
        self.server.stop()


class ControlClient(RpcClient):
    """Typed convenience wrapper over the coordinator's commands."""

    def register(self, role: str, **fields: Any) -> int:
        rep, _ = self.call("register", role=role, **fields)
        return int(rep["node_id"])

    def barrier(self, name: str, count: int, timeout: float | None = None) -> None:
        rep, _ = self.call("barrier", name=name, count=count, timeout=timeout)
        if not rep["ok"]:
            raise TimeoutError(f"barrier {name!r} timed out")

    def kv_set(self, key: str, arrays: Arrays | None = None, **fields: Any) -> None:
        self.call("kv_set", arrays=arrays, key=key, fields=fields)

    def kv_get(
        self, key: str, block: bool = False, timeout: float | None = None
    ) -> tuple[dict[str, Any], Arrays] | None:
        rep, arrays = self.call("kv_get", key=key, block=block, timeout=timeout)
        if not rep.get("found"):
            return None
        return rep.get("fields", {}), arrays

    def workload_init(self, items: list[str]) -> None:
        self.call("workload_init", items=items)

    def workload_fetch(self, worker: int) -> str | None:
        rep, _ = self.call("workload_fetch", worker=worker)
        return rep["workload"]

    def workload_finish(self, workload: str) -> None:
        self.call("workload_finish", workload=workload)

    def workload_all_done(self) -> bool:
        rep, _ = self.call("workload_stats")
        return bool(rep["all_done"])

    def workload_stats(self) -> dict[str, int]:
        rep, _ = self.call("workload_stats")
        return rep["stats"]

    def workload_reassign(
        self, worker: int | None = None, older_than: float | None = None
    ) -> list[str]:
        rep, _ = self.call(
            "workload_reassign", worker=worker, older_than=older_than
        )
        return rep["requeued"]

    def nodes(self) -> dict[str, dict[str, Any]]:
        """Registry snapshot; keys are node-id strings (JSON wire)."""
        rep, _ = self.call("nodes")
        return rep["nodes"]

    def dead_nodes(self) -> tuple[list[int], list[int]]:
        rep, _ = self.call("dead")
        return rep["dead"], rep["alive"]

    def recovered_workers(self) -> dict[int, dict[str, Any]]:
        """Worker ranks the coordinator's recovery sweep has handled."""
        rep, _ = self.call("recovered")
        return {int(r): v for r, v in rep["recovered"].items()}

    def progress(self, worker: int, record: dict[str, Any]) -> None:
        self.call("progress", worker=worker, record=record)

    def progress_merged(self) -> dict[str, Any]:
        rep, _ = self.call("progress_merged")
        return rep["merged"]

    def beat(self, node_id: int, stats: dict | None = None) -> None:
        self.call("beat", node_id=node_id, stats=stats)

    def telemetry(self, window_s: float | None = None) -> dict[str, Any]:
        """Cluster telemetry: per-node snapshots + the merged view
        (counters summed, latency histograms merged bucket-wise), plus
        the live-ops blocks — per-node windowed ``series`` summaries
        over ``window_s`` (the coordinator's default when None), the
        ``slo`` engine's health/alert verdict and the ``audit`` summary."""
        rep, _ = self.call("telemetry", window_s=window_s)
        return {
            k: rep[k]
            for k in (
                "nodes", "coordinator", "merged", "series", "slo", "audit",
            )
            if k in rep
        }

    def audit(self, recent: int = 20) -> dict[str, Any]:
        """The audit plane's summary: violation totals, recent panel,
        per-node stream accounting (``cli audit``'s feed)."""
        rep, _ = self.call("audit", recent=recent)
        return rep["audit"]

    def ssp_init(self, num_workers: int, max_delay: int) -> None:
        self.call("ssp_init", num_workers=num_workers, max_delay=max_delay)

    def ssp_wait(self, worker: int, step: int, timeout: float | None = None) -> bool:
        rep, _ = self.call("ssp_wait", worker=worker, step=step, timeout=timeout)
        return bool(rep["granted"])

    def ssp_finish(self, worker: int, step: int) -> None:
        self.call("ssp_finish", worker=worker, step=step)

    def ssp_retire(self, worker: int) -> None:
        self.call("ssp_retire", worker=worker)

    def shutdown_server(self) -> None:
        """Ask the remote RpcServer to stop (after acking)."""
        self.call("shutdown")
