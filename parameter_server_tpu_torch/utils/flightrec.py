"""Black-box flight recorder + stall watchdog + crash dumps.

A copy of the JAX package's ``utils/flightrec.py``: the same event types
and fields at the same call sites, the same ``psbb/1`` dump, so the JAX
package's ``cli postmortem <dir>`` merges a port cluster's dumps. Every
process keeps an always-on, lock-light, bounded ring of the last few
thousand structured events (RPC frames in/out with cid/seq/cmd,
apply-batch begin/commit with the published version, publishes,
reconnect/heal transitions, SSP clock movements, shed decisions,
heartbeats), and when something goes wrong — a stalled apply thread, a
wedged SSP clock, an unhandled thread exception, a fatal signal — the
whole box (ring + telemetry snapshot + every thread's stack) lands as one
atomic JSON dump in ``PS_BLACKBOX_DIR``.

Design constraints, in order (the tracer's contract, restated):

1. **Disabled is free.** The module-level ``record`` is an
   identity-pinned no-op function while the recorder is disarmed —
   no event tuple, no buffer append (tests assert
   ``record is _noop_record``).
2. **Armed is lock-light.** The ring is a ``deque(maxlen=capacity)``;
   ``append`` is GIL-atomic, so recording takes no lock.
3. **Survives the crash.** A background flusher re-dumps the box every
   ``flush_interval_s`` while armed, so even a SIGKILL'd process leaves
   an at-most-one-interval-stale box behind. Trigger dumps (watchdog,
   excepthook, SIGTERM, atexit) are immediate; ``faulthandler`` covers
   the fatal signals with a ``.crash.txt`` sidecar.

Event schema: each ring entry is ``[wall_ts_seconds, thread_ident, etype,
fields]`` with ``fields`` a small JSON-safe dict (the dump's thread table
maps idents to names/native ids). The dump document::

    {"schema": "psbb/1", "process": name, "pid": ..., "reason": ...,
     "trigger_reasons": [...], "wall_time": ..., "events": [...],
     "telemetry": telemetry_snapshot(), "threads": [{name, ident,
     native_id, daemon, stack}], "stall": {...} | null}

Arming: the ``PS_BLACKBOX_DIR`` env var arms the import-time recorder so
spawned nodes inherit it; ``configure()`` re-arms explicitly (the
``[blackbox]`` config section / launch_local's ``blackbox_dir=``).

The **stall watchdog** rides along: layers register ``(busy, progress)``
probes (``watchdog.register``) — the apply engine, the SSP clock, a
handle's pipelined reader, the heartbeat thread — and one daemon thread
per armed process samples them: a source that stays busy without its
progress counter advancing for ``stall_timeout_s`` fires once per stall
episode, recording the event, bumping ``watchdog_stalls`` and dumping
the box with the stalled source and thread named.

The **audit event spool** is the live half of the same stream: while
armed (``configure_spool``), every recorded event whose etype is
audit-relevant (:data:`AUDIT_EVENTS`) also lands in a bounded
:class:`EventSpool`, drained into sequence-numbered batches with explicit
saturation accounting (a full spool drops new events and counts them).
The heartbeat reporter ships the batches on each beat and acks them after
delivery, and the coordinator's streaming auditor (``utils/auditor.py``)
consumes them.
"""

from __future__ import annotations

import atexit
import json
import os
import signal
import sys
import threading
import time
import traceback
from collections import deque
from typing import Any, Callable

BLACKBOX_DIR_ENV = "PS_BLACKBOX_DIR"

#: ring default: ~4k events x ~100 B ~= a few hundred KB per dump
DEFAULT_CAPACITY = 4096


# -- the recorder -----------------------------------------------------------

_dir: str | None = None
_buf: deque | None = None
_name: str = ""
_reasons: list[str] = []  # trigger reasons, in firing order
_stall_log: list[dict[str, Any]] = []  # every watchdog firing this life
_dump_lock = threading.Lock()  # one dump writer at a time
_flush_stop: threading.Event | None = None
_crash_file = None  # faulthandler sidecar handle (kept alive on purpose)


def _noop_record(etype: str, **fields: Any) -> None:
    """The disarmed path: identity-pinned (tests assert ``record is
    _noop_record``) and allocation-free beyond the caller's kwargs."""


def _live_record(etype: str, **fields: Any) -> None:
    # ONE event tuple serves both sinks (ring + audit spool).
    # get_ident, NOT get_native_id: the ident is a userspace read
    # (~0.1 us) where the native id is a gettid syscall that costs
    # ~100x on un-vDSO'd kernels — on a per-frame hot path that
    # difference IS the recorder's overhead budget. Dumps map ident
    # -> name/native_id through their thread table.
    ev = (time.time(), threading.get_ident(), etype, fields)
    buf = _buf
    if buf is not None:
        buf.append(ev)
    sp = _spool
    if sp is not None and etype in AUDIT_EVENTS:
        sp.offer(etype, ev)


#: the module-level recording entry point every instrumented layer calls
#: (``flightrec.record(...)``): rebound between the no-op and the live
#: path whenever the ring (configure) or the audit spool
#: (configure_spool) arms/disarms, so the disabled cost is one attribute
#: load + one call that does nothing
record = _noop_record


def _rebind_record() -> None:
    """record is live iff ANY sink (ring, audit spool) is armed; with
    both off it is the identity-pinned no-op the overhead tests assert."""
    global record
    record = _noop_record if (_buf is None and _spool is None) else _live_record


def enabled() -> bool:
    return _dir is not None


def blackbox_dir() -> str | None:
    return _dir


def events() -> list[tuple]:
    """Snapshot of the ring (newest last); empty when disarmed."""
    buf = _buf
    return list(buf) if buf is not None else []


# -- audit event spool -----------------------------------------------------

#: the audit-relevant slice of the event stream: exactly the etypes the
#: JAX package's streaming monitors consume. Everything else
#: (rpc.in frame noise, trace/step context) stays ring-only — the spool
#: rides heartbeats and must stay beat-sized.
AUDIT_EVENTS = frozenset({
    "rpc.issue", "rpc.reply",           # client push issue/ack (push-only)
    "apply.commit", "apply.replay",     # server exactly-once ledger proof
    "rcu.publish",                      # snapshot version stream
    "ssp.wait", "ssp.finish", "ssp.retire",  # clock movements
    "rpc.conn_died",                    # heal-chain context
    "rpc.heal.begin", "rpc.healed", "rpc.heal.failed",
    "serve.shed",                       # admission-control firings
})

#: rpc.* issue/ack traffic is per-CALL volume; only push carries the
#: exactly-once invariant the auditor checks, so pulls/control calls
#: stay out of the spool entirely (they would saturate it for nothing)
_AUDIT_RPC_CMDS = frozenset({"push"})


class EventSpool:
    """Bounded spool of audit events, drained as sequence-numbered
    batches by the heartbeat thread.

    Producers (``record`` on any thread) ``offer`` events lock-free:
    a deque append is GIL-atomic, and the capacity check is a cheap
    ``len`` — the bound is therefore soft by at most the number of
    concurrently appending threads, which is fine for a memory guard.
    A full spool drops the NEW event and counts it (saturation
    accounting): the drop watermark rides every batch, so the consumer
    KNOWS the stream has holes — the difference between "no anomaly"
    and "no evidence".

    The drain side is single-consumer (the process's heartbeat thread,
    or the coordinator draining its own spool inline): ``drain()``
    returns the still-unacked in-flight batches plus newly cut ones,
    ``ack()`` discards the in-flight set once the carrying beat
    succeeded. A beat that dies on the wire simply leaves the batches
    in flight — the next beat re-ships them under the SAME seq numbers
    and the auditor's per-node seq dedup drops the duplicates."""

    def __init__(self, capacity: int = 4096, batch_events: int = 512):
        self.capacity = max(int(capacity), 16)
        self.batch_events = max(int(batch_events), 1)
        self._buf: deque = deque()
        self._next_seq = 0
        self._inflight: list[dict[str, Any]] = []
        self._lock = threading.Lock()  # drain/ack only — never offer

    def offer(self, etype: str, ev: tuple) -> None:
        """Hot-path admission (called from ``record``): lock-free."""
        if etype in ("rpc.issue", "rpc.reply"):
            if ev[3].get("cmd") not in _AUDIT_RPC_CMDS:
                return
        if len(self._buf) >= self.capacity:
            # saturation: drop NEW (the retained prefix stays causally
            # contiguous; a drop-oldest spool would silently shear the
            # pairing windows the monitors reason over)
            from parameter_server_tpu_torch.utils.metrics import wire_counters

            wire_counters.inc("audit_spool_dropped")
            return
        self._buf.append(ev)

    def __len__(self) -> int:
        return len(self._buf)

    @property
    def dropped(self) -> int:
        """Cumulative saturation drops (the batch watermark)."""
        from parameter_server_tpu_torch.utils.metrics import wire_counters

        return wire_counters.get("audit_spool_dropped")

    def drain(self, max_batches: int = 4) -> list[dict[str, Any]]:
        """Cut up to ``max_batches`` total batches (unacked in-flight
        ones first, re-shipped verbatim) for one beat's piggyback."""
        with self._lock:
            out = list(self._inflight)
            dropped = self.dropped
            while len(out) < max_batches:
                evs: list[list] = []
                while len(evs) < self.batch_events:
                    try:
                        ev = self._buf.popleft()
                    except IndexError:
                        break
                    evs.append([ev[0], ev[1], ev[2], ev[3]])
                if not evs:
                    break
                batch = {
                    "seq": self._next_seq,
                    "events": evs,
                    # cumulative drop watermark at cut time: the auditor
                    # diffs consecutive watermarks to find stream holes
                    "dropped": dropped,
                }
                self._next_seq += 1
                self._inflight.append(batch)
                out.append(batch)
            return out

    def ack(self) -> None:
        """The beat carrying the last ``drain()``'s batches landed."""
        with self._lock:
            self._inflight = []


_spool: EventSpool | None = None


def audit_spool() -> EventSpool | None:
    """The armed spool (None when the audit plane is off)."""
    return _spool


def configure_spool(
    capacity: int | None = 4096, batch_events: int = 512
) -> EventSpool | None:
    """Arm (capacity > 0) or disarm (``None``/``0``) the audit event
    spool, rebinding ``record`` so the disarmed-everything path stays
    the identity-pinned no-op. Re-arming swaps in a fresh spool."""
    global _spool
    _spool = (
        EventSpool(capacity, batch_events) if capacity else None
    )
    _rebind_record()
    return _spool


def dump(reason: str, extra: dict[str, Any] | None = None) -> str | None:
    """Atomically write this process's box (ring + telemetry + thread
    stacks) into the armed dir; returns the path (None when disarmed).
    One file per process — later dumps overwrite earlier ones, and
    ``trigger_reasons`` keeps the firing history. Never raises: a dump
    is last-ditch diagnostics and must not mask the original failure."""
    d, buf = _dir, _buf
    if d is None or buf is None:
        return None
    try:
        if reason != "periodic" and len(_reasons) < 32:
            # the flusher's cadence is not a trigger; real triggers keep
            # a bounded firing history across overwrites
            _reasons.append(reason)
        threads = []
        frames = sys._current_frames()
        for t in threading.enumerate():
            fr = frames.get(t.ident)
            threads.append({
                "name": t.name,
                "ident": t.ident,
                "native_id": getattr(t, "native_id", None),
                "daemon": t.daemon,
                "stack": traceback.format_stack(fr) if fr is not None else [],
            })
        from parameter_server_tpu_torch.utils.metrics import (
            telemetry_snapshot,
            wire_counters,
        )

        wire_counters.inc("blackbox_dumps")
        doc = {
            "schema": "psbb/1",
            "process": _name,
            "pid": os.getpid(),
            "reason": reason,
            "trigger_reasons": list(_reasons),
            "wall_time": time.time(),
            "events": [list(e) for e in buf],
            # observe-only: rolling here would consume the peak windows
            # the heartbeat plane reports (the flusher dumps every second)
            "telemetry": telemetry_snapshot(roll_peaks=False),
            "threads": threads,
            "stall": extra,
            # the full watchdog firing history (dumps overwrite each
            # other, so the triggering stall alone would lose earlier
            # ones — e.g. the apply engine AND a handle reader both
            # wedging on one fault)
            "stalls": list(_stall_log),
        }
        path = os.path.join(d, f"blackbox-{_name}-{os.getpid()}.json")
        tmp = path + f".tmp.{threading.get_native_id()}"
        with _dump_lock:
            if _dir != d:
                return None  # disarmed or re-armed while the box was built
            with open(tmp, "w") as f:
                json.dump(doc, f, default=str)
            os.replace(tmp, path)
        return path
    except Exception:  # noqa: BLE001 — diagnostics must never mask the crash
        return None


def _flush_loop(stop: threading.Event, interval_s: float) -> None:
    """Periodic persistence: the half of the black box that survives
    SIGKILL. Re-dumps only when the ring moved since the last flush."""
    last_tail: tuple | None = None
    while not stop.wait(interval_s):
        buf = _buf
        if buf is None:
            return
        tail = buf[-1] if buf else None
        if tail is not last_tail:
            last_tail = tail
            dump("periodic")


# -- crash hooks ------------------------------------------------------------

_prev_threading_hook = None
_hooks_installed = False


def _thread_excepthook(args) -> None:  # pragma: no cover - exercised via tests
    tname = args.thread.name if args.thread is not None else "?"
    record(
        "thread.exception", thread=tname,
        exc=repr(args.exc_value),
    )
    dump(f"thread-exception:{tname}")
    if _prev_threading_hook is not None:
        _prev_threading_hook(args)


def _sigterm_handler(signum, frame) -> None:  # pragma: no cover - signal path
    record("signal", sig=int(signum))
    # dump() takes the counter/telemetry/_dump locks; the handler runs on
    # whichever thread the signal interrupted, and if THAT frame holds one
    # of them an inline dump deadlocks and the process never dies. A
    # helper thread + bounded join always reaches the re-kill — worst
    # case the box is the flusher's, at most one interval stale.
    t = threading.Thread(
        target=dump, args=(f"signal:{signum}",), daemon=True,
        name="ps-blackbox-sig",
    )
    t.start()
    t.join(timeout=2.0)
    signal.signal(signum, signal.SIG_DFL)
    os.kill(os.getpid(), signum)


def _atexit_dump() -> None:  # pragma: no cover - interpreter teardown
    try:
        dump("exit")
    except Exception:  # noqa: BLE001
        pass


def _install_hooks() -> None:
    """Unhandled-thread-exception, SIGTERM and fatal-signal coverage.
    Installed once per process, first arm; the hooks themselves check
    the live armed state, so a later disarm makes them no-ops."""
    global _prev_threading_hook, _hooks_installed, _crash_file
    if _hooks_installed:
        return
    _hooks_installed = True
    _prev_threading_hook = threading.excepthook
    threading.excepthook = _thread_excepthook
    atexit.register(_atexit_dump)
    try:
        # SIGTERM: dump, then die with the default disposition. Only the
        # main thread may install handlers; non-main arming skips it.
        signal.signal(signal.SIGTERM, _sigterm_handler)
    except (ValueError, OSError):
        pass
    try:
        # truly fatal signals (SEGV/FPE/ABRT/BUS): python code cannot
        # run, but faulthandler's C dumper can — sidecar text file
        import faulthandler

        _crash_file = open(
            os.path.join(_dir, f"blackbox-{_name}-{os.getpid()}.crash.txt"),
            "w",
        )
        faulthandler.enable(file=_crash_file)
    except Exception:  # noqa: BLE001 — best-effort coverage
        pass


# -- stall watchdog ---------------------------------------------------------


class _Source:
    __slots__ = ("probe", "thread_name", "last", "mark", "fired")

    def __init__(self, probe: Callable, thread_name: str):
        self.probe = probe
        self.thread_name = thread_name
        self.last: Any = None
        self.mark = time.monotonic()
        self.fired = False


class Watchdog:
    """Per-process stall detector over registered progress probes.

    A probe is ``() -> (busy, progress)``: ``busy`` means the source
    currently has work it should be making progress on (a non-empty
    apply queue, workers parked on the SSP gate, requests in a client's
    pipeline window, a running heartbeat thread); ``progress`` is any
    value that changes whenever real progress happens. A source that
    stays busy with unchanged progress for ``stall_timeout_s`` fires
    ONCE per stall episode (re-armed the moment progress resumes):
    ``watchdog.stall`` event + ``watchdog_stalls`` counter + a blackbox
    dump whose ``stall`` section names the source and its thread.

    ``register``/``unregister`` are always cheap and safe to call —
    probes only run while an armed recorder's watchdog thread (or a
    test's explicit :meth:`poll`) drives them."""

    def __init__(self) -> None:
        self._lock = threading.Lock()
        self._sources: dict[str, _Source] = {}
        self._thread: threading.Thread | None = None
        self._stop: threading.Event | None = None
        self.interval_s = 1.0
        self.stall_timeout_s = 30.0

    def register(
        self, name: str, probe: Callable, thread_name: str = ""
    ) -> None:
        with self._lock:
            self._sources[name] = _Source(probe, thread_name)

    def unregister(self, name: str) -> None:
        with self._lock:
            self._sources.pop(name, None)

    def sources(self) -> list[str]:
        with self._lock:
            return sorted(self._sources)

    def poll(self, now: float | None = None) -> list[str]:
        """One sampling pass; returns the sources that fired (tests
        drive this directly for determinism)."""
        if now is None:
            now = time.monotonic()
        with self._lock:
            items = list(self._sources.items())
        fired: list[str] = []
        for name, s in items:
            try:
                busy, prog = s.probe()
            except Exception:  # noqa: BLE001 — a dying probe is not a stall
                continue
            if not busy or prog != s.last:
                s.last = prog
                s.mark = now
                s.fired = False
                continue
            if not s.fired and now - s.mark >= self.stall_timeout_s:
                s.fired = True
                fired.append(name)
                self._fire(name, s, now - s.mark)
        return fired

    def _fire(self, name: str, s: _Source, stalled_s: float) -> None:
        from parameter_server_tpu_torch.utils.metrics import wire_counters

        wire_counters.inc("watchdog_stalls")
        record(
            "watchdog.stall", source=name, thread=s.thread_name,
            stalled_s=round(stalled_s, 3),
        )
        extra = {
            "source": name,
            "thread": s.thread_name,
            "stalled_s": round(stalled_s, 3),
        }
        if len(_stall_log) < 32:
            _stall_log.append(extra)
        dump(f"stall:{name}", extra=extra)

    def start(self, interval_s: float, stall_timeout_s: float) -> None:
        self.interval_s = interval_s
        self.stall_timeout_s = stall_timeout_s
        if self._thread is not None:
            return
        self._stop = threading.Event()

        def loop(stop: threading.Event) -> None:
            while not stop.wait(self.interval_s):
                self.poll()

        self._thread = threading.Thread(
            target=loop, args=(self._stop,), daemon=True, name="ps-watchdog"
        )
        self._thread.start()

    def stop(self) -> None:
        if self._stop is not None:
            self._stop.set()
        self._thread = None
        self._stop = None


#: process-global watchdog; layers register probes unconditionally (a
#: dict entry), the sampling thread only runs while the box is armed
watchdog = Watchdog()


# -- arming -----------------------------------------------------------------


def configure(
    blackbox_dir: str | None,
    capacity: int = DEFAULT_CAPACITY,
    process_name: str = "",
    flush_interval_s: float = 1.0,
    watchdog_interval_s: float = 1.0,
    stall_timeout_s: float = 30.0,
) -> None:
    """Arm (with a dir) or disarm (``""``/``None``) the recorder,
    rebinding the module-level ``record`` between the live and the
    identity-pinned no-op paths. Arming starts the periodic flusher and
    the watchdog thread and installs the crash hooks; re-arming swaps
    the ring (configure at process start, like the tracer)."""
    global _dir, _buf, _name, _reasons, _stall_log, _flush_stop
    # stop the previous incarnation's threads first (idempotent)
    if _flush_stop is not None:
        _flush_stop.set()
        _flush_stop = None
    watchdog.stop()
    if not blackbox_dir:
        _dir = None
        _buf = None
        _rebind_record()
        # a dump already writing finishes before disarm returns, and one
        # still building its box finds _dir moved and writes nothing: the
        # caller may delete the dir once this returns
        with _dump_lock:
            pass
        return
    os.makedirs(blackbox_dir, exist_ok=True)
    _dir = blackbox_dir
    _name = process_name or f"proc-{os.getpid()}"
    _reasons = []
    _stall_log = []
    _buf = deque(maxlen=max(int(capacity), 1))
    _rebind_record()
    _install_hooks()
    if flush_interval_s > 0:
        _flush_stop = threading.Event()
        threading.Thread(
            target=_flush_loop, args=(_flush_stop, flush_interval_s),
            daemon=True, name="ps-blackbox-flush",
        ).start()
    watchdog.start(watchdog_interval_s, stall_timeout_s)


# env-armed at import so spawned children need no plumbing (the
# PS_FAULT_PLAN pattern); run_node re-configures with a role-rank name
if os.environ.get(BLACKBOX_DIR_ENV):
    configure(os.environ[BLACKBOX_DIR_ENV])
