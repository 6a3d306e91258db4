"""Distributed tracing: spans across every process of a run.

A copy of the JAX package's ``utils/trace.py``: the same spans, event
schema, wire context (the ``_trace`` header field) and file layout, so a
port process joins a JAX process's trace and the reverse, and either
package's tools read the other's capture dirs. A low-overhead
:class:`Tracer` records spans that export as Chrome trace-event JSON (load
the file, or the merged file from :func:`merge_trace_dir`, in Perfetto),
with trace-id/parent-span propagation carried in the RPC header so one
logical ``push`` renders as client span -> server dispatch span ->
updater span across processes.

Design constraints, in order:

1. **Disabled is free.** The default tracer is disabled; ``span()`` then
   returns one process-global no-op singleton — no Span object, no dict,
   no buffer append (tests assert the identity).
2. **Bounded.** Armed tracing records into a ring buffer
   (``deque(maxlen=capacity)``).
3. **Cross-process by construction.** ``ts`` is wall-clock microseconds
   (the only clock two processes share), ``pid``/``tid`` are real OS ids,
   and every span carries ``trace_id``/``span_id``/``parent_id`` in its
   ``args`` so the RPC layer can stitch client and server timelines.

Arming: the ``PS_TRACE_DIR`` env var arms the import-time global tracer —
spawned nodes inherit it; ``configure()`` re-arms explicitly (CLI
``--trace_dir`` / config ``[trace] trace_dir``). Each armed process writes
``trace-<name>-<pid>.json`` into the directory at exit (atexit backstop)
or on ``tracer.flush()``.

**Tail-biased capture** (:class:`TailCapture`): head sampling
(``sample=1/N``) keeps 1/N of traces by trace-id hash, which drops the
slow traces worth keeping as often as any. With tail capture armed, a
head-dropped trace's spans are buffered per trace until the trace
completes, and the completed trace is promoted to the export ring when it
(a) lands in the slowest-K per root-span name for the current window,
(b) carries anomaly events (rpc.retry / rpc.reconnect / an errored span),
or (c) breaches the live windowed p99 of its root name (log2 histograms,
``utils/metrics.py``). Unpromoted traces fall into a bounded limbo ring
exported as a ``tracetail-*.json`` sidecar, so a trace another process
promoted can be rescued at merge time (``merge_trace_dir`` pulls sidecar
events whose trace id appears in any main file).

API sketch::

    from parameter_server_tpu_torch.utils import trace

    with trace.span("step.pull", cat="step", bytes=n):   # context manager
        ...
    @trace.traced("load_shard")                          # decorator
    def load_shard(...): ...
    trace.instant("rpc.retry", addr=addr)                # point event

    header["_trace"] = trace.wire_context()              # client side
    with trace.activate(header.pop("_trace", None)):     # server side
        ...spans here join the caller's trace...
"""

from __future__ import annotations

import atexit
import functools
import json
import os
import random
import threading
import time
from collections import OrderedDict, deque
from typing import Any, Callable

TRACE_DIR_ENV = "PS_TRACE_DIR"
TRACE_SAMPLE_ENV = "PS_TRACE_SAMPLE"
TRACE_TAIL_ENV = "PS_TRACE_TAIL"

#: ring-buffer default: ~64k spans x ~200 B/event ~= 13 MB ceiling per process
DEFAULT_CAPACITY = 65536

#: tail-capture defaults (see TailCapture): slowest-K per root name kept
#: per window, limbo sidecar ring bound, pending-trace bounds
DEFAULT_TAIL_K = 4
DEFAULT_TAIL_LIMBO = 8192

#: instant-event names whose presence promotes the enclosing trace (the
#: "anomaly-bearing" leg of the tail-promotion policy); errored spans
#: (an ``error`` arg) promote through the same gate
TAIL_ANOMALY_EVENTS = frozenset({"rpc.retry", "rpc.reconnect"})


def _env_sample() -> int:
    try:
        return max(1, int(os.environ.get(TRACE_SAMPLE_ENV, "1") or 1))
    except ValueError:
        return 1


def _env_tail_k() -> int:
    """PS_TRACE_TAIL: the slowest-K bound for env-armed processes
    (spawned children). Unset/empty/"1" = the default K armed; "0"
    disarms tail capture; any other int = that K."""
    raw = os.environ.get(TRACE_TAIL_ENV, "")
    if raw in ("", "1"):
        return DEFAULT_TAIL_K
    try:
        return max(0, int(raw))
    except ValueError:
        return DEFAULT_TAIL_K

_current = threading.local()  # .span: innermost live span (or remote parent)


def _now_us() -> float:
    """Wall-clock microseconds: the only timebase two processes share, so
    Perfetto lines up client and server spans on one axis."""
    return time.time() * 1e6


#: id generator: urandom-seeded Mersenne stream, NOT uuid4 — uuid4 hits
#: posix.urandom per call (~12 us), which at two ids per span was the
#: single largest cost of armed tracing on the push hot path. One C
#: getrandbits call under the GIL is atomic enough for id draws.
_id_rng = random.Random()


def _new_id() -> str:
    return f"{_id_rng.getrandbits(64):016x}"


#: cached OS identities for the per-event stamps: on para-virtualized
#: kernels getpid/gettid can be full-priced syscalls, and every recorded
#: event stamps both. The pid refreshes on
#: fork; the native thread id is cached per thread in the existing
#: thread-local.
_pid = os.getpid()


def _refresh_pid() -> None:  # pragma: no cover - fork path
    global _pid
    _pid = os.getpid()


if hasattr(os, "register_at_fork"):
    os.register_at_fork(after_in_child=_refresh_pid)


def _tid() -> int:
    t = getattr(_current, "tid", None)
    if t is None:
        t = _current.tid = threading.get_native_id()
    return t


class _NoopSpan:
    """The disabled-path singleton: enter/exit/set are all no-ops and no
    instance is ever allocated per call — ``Tracer.span`` returns THIS
    object every time when tracing is off (the "tracing disabled is
    free" contract, asserted by tests)."""

    __slots__ = ()
    trace_id = None
    span_id = None

    def __enter__(self) -> "_NoopSpan":
        return self

    def __exit__(self, *exc: Any) -> bool:
        return False

    def set(self, **args: Any) -> None:
        pass


_NOOP = _NoopSpan()


class _DroppedSpan:
    """A span inside a head-DROPPED trace (``sample=1/N``): it keeps the
    thread-local nesting and a real wire identity — descendants, instants
    and remote callees all see the shared trace id and make the SAME drop
    decision, so sampling keeps whole traces or none of one — but records
    nothing into the buffer."""

    __slots__ = ("trace_id", "span_id", "_prev")

    def __init__(self, trace_id: str):
        self.trace_id = trace_id
        self.span_id = _new_id()

    def set(self, **args: Any) -> None:
        pass

    def __enter__(self) -> "_DroppedSpan":
        self._prev = getattr(_current, "span", None)
        _current.span = self
        return self

    def __exit__(self, *exc: Any) -> bool:
        _current.span = self._prev
        return False


class Span:
    """One live span (context manager). Recorded as a Chrome ``"X"``
    (complete) event on exit; nesting via a thread-local stack gives
    parent ids without any caller plumbing."""

    __slots__ = (
        "_tracer", "name", "cat", "trace_id", "span_id", "parent_id",
        "args", "_t0_us", "_t0", "_prev", "_tail_seal",
    )

    def __init__(
        self, tracer: "Tracer", name: str, cat: str,
        trace_id: str, parent_id: str | None, args: dict[str, Any],
    ):
        self._tracer = tracer
        self.name = name
        self.cat = cat
        self.trace_id = trace_id
        self.span_id = _new_id()
        self.parent_id = parent_id
        self.args = args
        # set by Tracer.span for the LOCAL ROOT span of a head-dropped
        # trace under tail capture: its exit seals the trace (promotion
        # decision) — flag-driven, so a single-span trace (the RPC hot
        # path's common case) never touches the pending table at all
        self._tail_seal = False

    def set(self, **args: Any) -> None:
        """Attach/override args after entry (e.g. reply byte counts)."""
        self.args.update(args)

    def __enter__(self) -> "Span":
        self._t0_us = _now_us()
        self._t0 = time.perf_counter()
        self._prev = getattr(_current, "span", None)
        _current.span = self
        return self

    def __exit__(self, et, ev, tb) -> bool:
        # duration from the monotonic clock (wall time can step); start
        # from the wall clock (cross-process alignment)
        dur_us = (time.perf_counter() - self._t0) * 1e6
        _current.span = self._prev
        if et is not None:
            self.args.setdefault("error", repr(ev))
        args = {
            "trace_id": self.trace_id,
            "span_id": self.span_id,
            **({"parent_id": self.parent_id} if self.parent_id else {}),
            **self.args,
        }
        self._tracer._record(
            {
                "name": self.name,
                "cat": self.cat or "default",
                "ph": "X",
                "ts": self._t0_us,
                "dur": dur_us,
                "pid": _pid,
                "tid": _tid(),
                "args": args,
            },
            tail_seal=self._tail_seal,
        )
        return False


class _RemoteParent:
    """Wire-borne span context installed by ``activate()``: spans opened
    under it join the remote caller's trace instead of starting one."""

    __slots__ = ("trace_id", "span_id")

    def __init__(self, trace_id: str, span_id: str):
        self.trace_id = trace_id
        self.span_id = span_id


class _Activation:
    __slots__ = ("_parent", "_prev")

    def __init__(self, parent: _RemoteParent):
        self._parent = parent

    def __enter__(self) -> "_Activation":
        self._prev = getattr(_current, "span", None)
        _current.span = self._parent
        return self

    def __exit__(self, *exc: Any) -> bool:
        _current.span = self._prev
        return False


class _PendingTrace:
    """One head-dropped trace buffered until completion (tail capture).
    Created LAZILY by the first non-root event — a single-span trace
    (the RPC hot path's common case) seals straight from its root exit
    and never allocates one."""

    __slots__ = ("events", "anomaly", "truncated")

    def __init__(self) -> None:
        self.events: list[dict[str, Any]] = []
        self.anomaly = False
        self.truncated = 0


class TailCapture:
    """The tail-retention layer: completion-time promotion of
    head-dropped traces.

    Head sampling decides keep/drop at trace START, so the slowest
    traces — the ones worth keeping — die before anyone knows they are
    slow. With this layer armed, a dropped trace's events buffer in a
    per-trace pending list; when its (locally) root span exits, the
    whole trace is judged at once:

    - **slowest-K**: the root duration ranks in the top ``k`` for its
      root-span name within the current window;
    - **anomaly-bearing**: the trace carries a
      :data:`TAIL_ANOMALY_EVENTS` instant or an errored span;
    - **p99 breach**: the root duration exceeds the live windowed p99
      of its name (per-name log2 histograms, windowed by snapshot
      deltas — the same discipline the time-series plane uses).

    Promoted traces move into the tracer's export ring (overriding the
    head-sampling drop) and fire a ``trace.promote`` flight-recorder
    event; unpromoted ones land in a bounded **limbo** ring exported as
    a ``tracetail-*.json`` sidecar so a cross-process trace promoted by
    ANOTHER process (the client saw the tail latency; this server's
    segment looked fast locally) is rescued at merge/analysis time.

    Every structure is bounded: at most ``max_pending`` open traces
    (the oldest is sealed unpromoted on overflow), ``max_events`` per
    trace (extra events are counted, not kept), ``limbo_events`` limbo
    entries, and K + one ~40-int histogram per distinct root name."""

    _RECENT = 512  # sealed-verdict memory: late events still route right

    def __init__(
        self,
        k: int = DEFAULT_TAIL_K,
        limbo_events: int = DEFAULT_TAIL_LIMBO,
        max_pending: int = 256,
        max_events: int = 256,
        window_s: float = 30.0,
        min_window_count: int = 32,
    ):
        self.k = max(0, int(k))
        self.window_s = float(window_s)
        self.min_window_count = int(min_window_count)
        self.max_pending = max(1, int(max_pending))
        self.max_events = max(8, int(max_events))
        self._pending: "OrderedDict[str, _PendingTrace]" = OrderedDict()
        self._recent: "OrderedDict[str, bool]" = OrderedDict()
        self._limbo: deque[dict[str, Any]] = deque(
            maxlen=max(int(limbo_events), 64)
        )
        # per-root-name windowed stats: top-K durations + a log2
        # histogram (utils/metrics.py machinery) with a baseline
        # snapshot stashed at each window roll, so the p99 read is the
        # DELTA percentile — the live windowed p99, not since-boot
        self._top: dict[str, list[float]] = {}
        self._hists: dict[str, Any] = {}
        self._base: dict[str, dict[str, Any]] = {}
        # per-name p99 read cache: the delta-percentile read (snapshot
        # + bucket walk) is the seal path's priciest step; at hot-path
        # seal rates it is refreshed at most every _P99_TTL_S per name
        # (a slightly stale threshold only shifts WHICH borderline
        # trace promotes — the slowest-K gate is exact regardless)
        self._p99_cache: dict[str, tuple[float, float | None]] = {}
        self._window_start = time.monotonic()
        self._lock = threading.Lock()

    _P99_TTL_S = 0.25

    # -- stats -------------------------------------------------------------

    def _roll_window_locked(self) -> None:
        now = time.monotonic()
        if now - self._window_start < self.window_s:
            return
        self._window_start = now
        self._top.clear()
        self._p99_cache.clear()
        self._base = {k: h.snapshot() for k, h in self._hists.items()}

    def _windowed_p99_locked(self, name: str) -> float | None:
        from parameter_server_tpu_torch.utils.metrics import hist_percentile

        h = self._hists.get(name)
        if h is None:
            return None
        snap = h.snapshot()
        base = self._base.get(name)
        if base:
            snap = {
                "count": snap["count"] - base.get("count", 0),
                "buckets": {
                    k: c - base.get("buckets", {}).get(k, 0)
                    for k, c in snap.get("buckets", {}).items()
                },
            }
        if snap.get("count", 0) < self.min_window_count:
            return None
        return hist_percentile(snap, 0.99)

    def _p99_cached_locked(self, name: str) -> float | None:
        now = time.monotonic()
        hit = self._p99_cache.get(name)
        if hit is not None and hit[0] > now:
            return hit[1]
        p99 = self._windowed_p99_locked(name)
        self._p99_cache[name] = (now + self._P99_TTL_S, p99)
        return p99

    def observe_root(self, name: str, dur_s: float) -> None:
        """Feed one completed root span into the windowed stats (kept
        and dropped traces alike — the promotion thresholds must see
        the whole population, not just the sampled-out slice)."""
        with self._lock:
            self._observe_root_locked(name, dur_s)

    def _observe_root_locked(self, name: str, dur_s: float) -> None:
        from parameter_server_tpu_torch.utils.metrics import Histogram

        self._roll_window_locked()
        h = self._hists.get(name)
        if h is None:
            h = self._hists[name] = Histogram()
        top = self._top.setdefault(name, [])
        top.append(dur_s)
        top.sort(reverse=True)
        del top[self.k:]
        h.observe(dur_s)  # Histogram's own lock is a leaf under ours

    # -- pending-trace lifecycle ------------------------------------------

    def _remember_locked(self, trace_id: str, promoted: bool) -> None:
        self._recent[trace_id] = promoted
        while len(self._recent) > self._RECENT:
            self._recent.popitem(last=False)

    def _open_locked(self, trace_id: str) -> _PendingTrace:
        while len(self._pending) >= self.max_pending:
            # overflow: the oldest pending trace seals unpromoted (its
            # root span leaked or is very long-lived)
            _t, old = self._pending.popitem(last=False)
            self._limbo.extend(old.events)
            self._remember_locked(_t, False)
        pend = self._pending[trace_id] = _PendingTrace()
        return pend

    def route(self, trace_id: str, ev: dict[str, Any], tracer: "Tracer") -> bool:
        """Destination decision for one recorded NON-sealing event of
        ``trace_id``; True = consumed here (pending buffer or limbo),
        False = the caller records it into the main ring. Root-span
        exits of KEPT traces pass through but feed the windowed stats;
        a head-dropped trace's first buffered event creates its pending
        entry lazily (local-root exits go through :meth:`seal_event`
        instead — flag-driven by the span layer).

        Everything runs under ONE lock acquisition: events for one
        trace arrive from several threads (the serve thread's dispatch
        exit vs the apply thread's updater marker), and a buffer append
        racing the seal would strand the event in an already-flushed
        list, silently losing it from both ring and sidecar."""
        args = ev.get("args") or {}
        with self._lock:
            pend = self._pending.get(trace_id)
            if pend is None:
                verdict = self._recent.get(trace_id)
                if verdict is not None:
                    if verdict:
                        return False  # promoted: late events join the ring
                    self._limbo.append(ev)
                    return True
                if tracer._keep(trace_id):
                    # a head-KEPT trace — record normally, observing
                    # parentless root completions into the stats
                    if ev.get("ph") == "X" and "parent_id" not in args:
                        self._observe_root_locked(
                            ev["name"], ev.get("dur", 0.0) / 1e6
                        )
                    return False
                pend = self._open_locked(trace_id)
            if (
                ev.get("ph") == "i" and ev["name"] in TAIL_ANOMALY_EVENTS
            ) or "error" in args:
                pend.anomaly = True
            if len(pend.events) >= self.max_events:
                pend.truncated += 1
            else:
                pend.events.append(ev)
            return True

    def seal_event(
        self, trace_id: str, root_ev: dict[str, Any], tracer: "Tracer"
    ) -> bool:
        """A head-dropped trace's LOCAL ROOT span exited (the span layer
        flags it): judge the whole trace — buffered children plus this
        root event, which ALWAYS keeps its slot (a promoted trace
        exported without its root would be unstitchable by the
        critical-path engine). True = consumed (promoted to the ring as
        a batch, or limbo'd); False = late root of an already-promoted
        trace, caller records it into the ring."""
        args = root_ev.get("args") or {}
        name = root_ev["name"]
        dur_s = root_ev.get("dur", 0.0) / 1e6
        why = None
        promoted_events: list[dict[str, Any]] | None = None
        with self._lock:
            verdict = self._recent.get(trace_id)
            if verdict is not None:
                # a second local root (e.g. the apply thread's updater
                # marker after the dispatch span sealed): late event
                if verdict:
                    return False
                self._limbo.append(root_ev)
                return True
            pend = self._pending.pop(trace_id, None)
            events = pend.events if pend is not None else []
            events.append(root_ev)
            anomaly = (
                pend.anomaly if pend is not None else False
            ) or "error" in args
            self._roll_window_locked()
            if anomaly:
                why = "anomaly"
            else:
                top = self._top.get(name) or []
                if self.k > 0 and (len(top) < self.k or dur_s > top[-1]):
                    why = "slowk"
                else:
                    p99 = self._p99_cached_locked(name)
                    if p99 is not None and dur_s > p99:
                        why = "p99"
            self._observe_root_locked(name, dur_s)
            self._remember_locked(trace_id, why is not None)
            if why is None:
                self._limbo.extend(events)
            else:
                promoted_events = events
        # counters / ring append / flightrec OUTSIDE the tail lock
        from parameter_server_tpu_torch.utils.metrics import wire_counters

        if promoted_events is None:
            wire_counters.inc("trace_tail_dropped")
            return True
        tracer._append_events(promoted_events)
        wire_counters.inc("trace_tail_promoted")
        from parameter_server_tpu_torch.utils import flightrec

        flightrec.record(
            "trace.promote", cmd=name, tid=trace_id, why=why,
            dur_ms=round(dur_s * 1e3, 3),
        )
        return True

    def limbo_events(self) -> list[dict[str, Any]]:
        """Snapshot of the unpromoted-trace ring (the sidecar's body)."""
        with self._lock:
            return list(self._limbo)


class Tracer:
    """Span recorder with a Chrome trace-event exporter. One module-global
    instance (``trace.tracer``) serves the process; the module-level
    ``span``/``instant``/... helpers delegate to whatever the global
    currently is, so ``configure()`` can re-arm mid-process."""

    def __init__(
        self,
        trace_dir: str | None = None,
        capacity: int = DEFAULT_CAPACITY,
        process_name: str = "",
        sample: int = 1,
        tail: TailCapture | None = None,
    ):
        self._dir = trace_dir or None
        self._buf: deque[dict[str, Any]] = deque(maxlen=max(capacity, 1))
        self._lock = threading.Lock()
        self.process_name = process_name or f"proc-{os.getpid()}"
        # head-based sampling: record 1 in ``sample`` TRACES, decided
        # once per trace id — every process keyed the same way keeps the
        # same traces, so always-on tracing at production step rates
        # yields whole cross-process traces, never fragments
        self._sample = max(1, int(sample))
        # tail-biased retention: with this armed, the head
        # sampler's drop verdict becomes provisional — see TailCapture
        self._tail = tail if self._dir is not None else None

    @property
    def enabled(self) -> bool:
        return self._dir is not None

    @property
    def sample(self) -> int:
        return self._sample

    def _keep(self, trace_id: str) -> bool:
        """The head-sampling decision, a pure function of the trace id
        (hex): consistent for every span of one trace in every process."""
        if self._sample <= 1:
            return True
        try:
            # psl: ignore[idtype]: head-sampling hashes the id's hex prefix by design — the one sanctioned place a trace id acts numeric
            return int(trace_id[:8], 16) % self._sample == 0
        except (ValueError, TypeError):
            return True

    @property
    def trace_dir(self) -> str | None:
        return self._dir

    @property
    def tail(self) -> TailCapture | None:
        """The armed tail-capture layer (None when off)."""
        return self._tail

    # -- recording --------------------------------------------------------

    def span(self, name: str, cat: str = "", **args: Any):
        """Context manager for one span. Disabled path: returns the
        process-global no-op singleton (no allocation). A trace the head
        sampler drops gets a :class:`_DroppedSpan` instead — nesting and
        propagation intact, nothing recorded — UNLESS tail capture is
        armed, in which case the span records into the trace's pending
        buffer and the keep/drop verdict waits for trace completion
        (TailCapture: promotion overrides the head drop)."""
        if self._dir is None:
            return _NOOP
        cur = getattr(_current, "span", None)
        if cur is not None and cur.trace_id is not None:
            trace_id, parent = cur.trace_id, cur.span_id
        else:
            trace_id, parent = _new_id(), None
        if not self._keep(trace_id):
            tail = self._tail
            if tail is None:
                return _DroppedSpan(trace_id)
            sp = Span(self, name, cat, trace_id, parent, args)
            # the LOCAL root (trace started here, or entered via a
            # remote activation) seals the trace at exit; nested local
            # spans just buffer
            sp._tail_seal = cur is None or isinstance(cur, _RemoteParent)
            return sp
        return Span(self, name, cat, trace_id, parent, args)

    def instant(
        self, name: str, cat: str = "",
        ctx: dict[str, str] | None = None, **args: Any,
    ) -> None:
        """Point-in-time annotation (retry fired, reconnect started);
        rides the current span's trace when one is live. ``ctx`` binds
        an EXPLICIT wire context instead — for emitters on threads with
        no live span acting on another trace's behalf (the heal marks
        every stranded pending call's trace, so the tail-capture
        anomaly gate sees the reconnect the trace actually absorbed)."""
        if self._dir is None:
            return
        if ctx:
            if not self._keep(ctx["tid"]) and self._tail is None:
                return  # head-dropped trace, no tail layer to buffer it
            args = {"trace_id": ctx["tid"], "parent_id": ctx["sid"], **args}
        elif (cur := getattr(_current, "span", None)) is not None and (
            cur.trace_id is not None
        ):
            if not self._keep(cur.trace_id) and self._tail is None:
                return  # head-dropped trace, no tail layer to buffer it
            args = {"trace_id": cur.trace_id, "parent_id": cur.span_id, **args}
        self._record({
            "name": name,
            "cat": cat or "default",
            "ph": "i",
            "ts": _now_us(),
            "s": "t",  # thread-scoped instant
            "pid": _pid,
            "tid": _tid(),
            "args": args,
        })

    def counter(self, name: str, value: float, cat: str = "") -> None:
        """Perfetto counter-track sample (Chrome ``"C"`` event): numeric
        series rendered as a stepped counter track next to the spans —
        the histogram-export-as-counter-track form. Used for queue depth and apply-batch size; free when
        tracing is disabled (same contract as ``span``)."""
        if self._dir is None:
            return
        self._record({
            "name": name,
            "cat": cat or "default",
            "ph": "C",
            "ts": _now_us(),
            "pid": _pid,
            "tid": _tid(),
            "args": {"value": float(value)},
        })

    def flow_start(
        self, name: str, cat: str = "", flow_id: str | None = None,
        **args: Any,
    ) -> str | None:
        """Open a flow arrow (Chrome ``"s"`` event): the span-link
        primitive for in-flight futures — a later :meth:`flow_end` with
        the same id (on any thread or span) draws the arrow from this
        point to that one in Perfetto, linking a push's issue span to its
        completion. Returns the flow id (None when disabled — callers
        pass it straight back to ``flow_end``, which then no-ops)."""
        if self._dir is None:
            return None
        cur = getattr(_current, "span", None)
        if (
            cur is not None
            and cur.trace_id is not None
            and not self._keep(cur.trace_id)
            and self._tail is None
        ):
            return None  # head-dropped trace: flow_end no-ops on None
        fid = flow_id or _new_id()
        self._record_flow(name, cat, "s", fid, args)
        return fid

    def flow_end(
        self, name: str, cat: str = "", flow_id: str | None = None,
        **args: Any,
    ) -> None:
        """Close a flow arrow opened by ``flow_start`` (Chrome ``"f"``
        event, next-slice binding). No-op when disabled or fed the None
        id a disabled ``flow_start`` returned."""
        if self._dir is None or flow_id is None:
            return
        self._record_flow(name, cat, "f", flow_id, args)

    def _record_flow(
        self, name: str, cat: str, ph: str, fid: str, args: dict[str, Any]
    ) -> None:
        cur = getattr(_current, "span", None)
        if cur is not None and cur.trace_id is not None:
            args = {"trace_id": cur.trace_id, "parent_id": cur.span_id, **args}
        ev: dict[str, Any] = {
            "name": name,
            "cat": cat or "default",
            "ph": ph,
            "id": fid,
            "ts": _now_us(),
            "pid": _pid,
            "tid": _tid(),
            "args": args,
        }
        if ph == "f":
            ev["bp"] = "e"  # bind to the enclosing slice at the arrowhead
        self._record(ev)

    def wire_context(self) -> dict[str, str] | None:
        """The current span's identity for an RPC header (``None`` when
        disabled or outside any span — callers skip the header field)."""
        if self._dir is None:
            return None
        cur = getattr(_current, "span", None)
        if cur is None or cur.trace_id is None:
            return None
        return {"tid": cur.trace_id, "sid": cur.span_id}

    def activate(self, ctx: dict[str, str] | None):
        """Server side of propagation: bind a wire context as this
        thread's parent so dispatch spans join the caller's trace."""
        if self._dir is None or not ctx:
            return _NOOP
        return _Activation(_RemoteParent(ctx["tid"], ctx["sid"]))

    def _record(self, ev: dict[str, Any], tail_seal: bool = False) -> None:
        tail = self._tail
        if tail is not None:
            tid = (ev.get("args") or {}).get("trace_id")
            # tail routing happens BEFORE the ring lock (TailCapture
            # takes its own lock and may call _append_events, which
            # takes the ring lock — one consistent order: tail -> ring)
            if tid is not None:
                if tail_seal:
                    if tail.seal_event(tid, ev, self):
                        return
                elif tail.route(tid, ev, self):
                    return
        with self._lock:
            self._buf.append(ev)

    def _append_events(self, evs: list[dict[str, Any]]) -> None:
        """Bulk ring append (the tail layer's promotion path)."""
        with self._lock:
            self._buf.extend(evs)

    # -- inspection / export ----------------------------------------------

    def events(self) -> list[dict[str, Any]]:
        with self._lock:
            return list(self._buf)

    def export(self, path: str) -> str:
        """Write the buffered events as one strict Chrome trace-event JSON
        object (``ts``-sorted, with process/thread ``M`` metadata), the
        format Perfetto's legacy-JSON importer accepts."""
        return write_chrome_trace(
            self.events(), path,
            process_names={os.getpid(): self.process_name},
        )

    def flush(self) -> str | None:
        """Export into the armed trace dir (no-op when disabled or no
        spans were recorded); returns the written path. With tail
        capture armed, the limbo ring (completed-but-unpromoted traces)
        also lands as a ``tracetail-*.json`` sidecar — the raw material
        ``merge_trace_dir`` / the critical-path engine rescue when some
        OTHER process promoted one of those traces."""
        if self._dir is None:
            return None
        tail = self._tail
        if tail is not None:
            limbo = tail.limbo_events()
            if limbo:
                write_chrome_trace(
                    limbo,
                    os.path.join(
                        self._dir,
                        f"tracetail-{self.process_name}-{os.getpid()}.json",
                    ),
                    process_names={os.getpid(): self.process_name},
                )
        if not self.events():
            return None
        name = f"trace-{self.process_name}-{os.getpid()}.json"
        return self.export(os.path.join(self._dir, name))


#: the process's tracer; armed at import when PS_TRACE_DIR is set so
#: spawned children need no plumbing (the PS_FAULT_PLAN pattern);
#: PS_TRACE_SAMPLE rides along for head sampling and PS_TRACE_TAIL for
#: tail capture (on by default for env-armed processes: always-on
#: tail-biased retention is the point of arming a production run)
tracer = Tracer(
    os.environ.get(TRACE_DIR_ENV) or None,
    sample=_env_sample(),
    # tail capture only matters when head sampling can DROP something:
    # at sample=1 every trace is kept and promotion is unreachable, so
    # arming the layer would add per-event routing for zero benefit
    tail=(
        TailCapture(k=_env_tail_k())
        if _env_tail_k() > 0 and _env_sample() > 1
        else None
    ),
)

_atexit_armed = False


def _flush_at_exit() -> None:  # pragma: no cover - interpreter teardown
    try:
        tracer.flush()
    except Exception:
        pass


def _arm_atexit() -> None:
    global _atexit_armed
    if not _atexit_armed:
        atexit.register(_flush_at_exit)
        _atexit_armed = True


if tracer.enabled:  # env-armed at import
    _arm_atexit()


def configure(
    trace_dir: str | None,
    capacity: int = DEFAULT_CAPACITY,
    process_name: str = "",
    sample: int = 1,
    tail: bool = False,
    tail_k: int = DEFAULT_TAIL_K,
    tail_limbo: int = DEFAULT_TAIL_LIMBO,
) -> Tracer:
    """Replace the global tracer (arm with a dir, disarm with ``""``/
    ``None``; ``sample=N`` records 1/N of traces, keyed off the trace
    id; ``tail=True`` arms tail-biased retention — head-dropped traces
    buffer until completion and promote on slowest-K / anomaly / p99
    breach instead of dying at the sampler; a no-op at ``sample=1``,
    where nothing is ever head-dropped and the layer would only add
    per-event routing cost). The previous buffer is dropped — configure
    at process start, before instrumented code runs."""
    global tracer
    tracer = Tracer(
        trace_dir or None, capacity, process_name, sample=sample,
        tail=(
            TailCapture(k=tail_k, limbo_events=tail_limbo)
            if tail and tail_k > 0 and sample > 1
            else None
        ),
    )
    if tracer.enabled:
        _arm_atexit()
    return tracer


# -- module-level delegates (resolve the CURRENT global at call time, so
# instrumented modules can `from ... import trace` once and still follow
# configure()'s swaps) ------------------------------------------------------


def span(name: str, cat: str = "", **args: Any):
    return tracer.span(name, cat, **args)


def instant(
    name: str, cat: str = "", ctx: dict[str, str] | None = None,
    **args: Any,
) -> None:
    tracer.instant(name, cat, ctx=ctx, **args)


def counter(name: str, value: float, cat: str = "") -> None:
    tracer.counter(name, value, cat)


def flow_start(
    name: str, cat: str = "", flow_id: str | None = None, **args: Any
) -> str | None:
    return tracer.flow_start(name, cat, flow_id, **args)


def flow_end(
    name: str, cat: str = "", flow_id: str | None = None, **args: Any
) -> None:
    tracer.flow_end(name, cat, flow_id, **args)


def wire_context() -> dict[str, str] | None:
    return tracer.wire_context()


def activate(ctx: dict[str, str] | None):
    return tracer.activate(ctx)


def enabled() -> bool:
    return tracer.enabled


def traced(name: str | None = None, cat: str = "") -> Callable:
    """Decorator form of ``span`` (checks the live global per call, so a
    decorated function is free when tracing is off)."""

    def deco(fn: Callable) -> Callable:
        label = name or fn.__qualname__

        @functools.wraps(fn)
        def wrapper(*a: Any, **kw: Any):
            if not tracer.enabled:
                return fn(*a, **kw)
            with tracer.span(label, cat=cat):
                return fn(*a, **kw)

        return wrapper

    return deco


def write_chrome_trace(
    events: list[dict[str, Any]],
    path: str,
    process_names: dict[int, str] | None = None,
    thread_names: dict[tuple[int, int], str] | None = None,
) -> str:
    """The exporter's file-writing core (the JAX package's postmortem
    renders merged blackbox timelines through its copy): ``ts``-sort the events, prepend process/thread ``M`` metadata,
    atomically write one strict Chrome trace-event JSON object — the
    format Perfetto's legacy-JSON importer accepts."""
    events = sorted(events, key=lambda e: e.get("ts", 0))
    meta: list[dict[str, Any]] = []
    for pid, name in sorted((process_names or {}).items()):
        meta.append({
            "name": "process_name", "ph": "M", "pid": pid, "tid": 0,
            "args": {"name": name},
        })
    thread_names = thread_names or {}
    for pid, tid in sorted(
        {(e["pid"], e["tid"]) for e in events if "tid" in e}
    ):
        meta.append({
            "name": "thread_name", "ph": "M", "pid": pid, "tid": tid,
            "args": {"name": thread_names.get((pid, tid), f"thread-{tid}")},
        })
    doc = {"traceEvents": meta + events, "displayTimeUnit": "ms"}
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    tmp = path + ".tmp"
    with open(tmp, "w") as f:
        json.dump(doc, f)
    os.replace(tmp, path)
    return path


def read_trace_dir(
    trace_dir: str, out_name: str = "trace-merged.json"
) -> tuple[list[dict[str, Any]], list[dict[str, Any]]]:
    """The capture-dir reader shared by :func:`merge_trace_dir` and the
    critical-path engine: ``(main_events, sidecar_events)`` from the
    ``trace-*.json`` main files and ``tracetail-*.json`` tail-capture
    sidecars (the merged file and torn/foreign files are skipped — a
    postmortem works with whatever survived)."""
    main: list[dict[str, Any]] = []
    side: list[dict[str, Any]] = []
    for fn in sorted(os.listdir(trace_dir)):
        if not fn.endswith(".json") or fn == out_name:
            continue
        if fn.startswith("trace-"):
            bucket = main
        elif fn.startswith("tracetail-"):
            bucket = side
        else:
            continue
        try:
            with open(os.path.join(trace_dir, fn)) as f:
                doc = json.load(f)
        except (OSError, ValueError):
            continue
        bucket.extend(doc.get("traceEvents", []))
    return main, side


def rescue_sidecar_events(
    main: list[dict[str, Any]], side: list[dict[str, Any]]
) -> list[dict[str, Any]]:
    """The cross-process rescue rule, in ONE place: sidecar (limbo)
    events join the capture iff some main file retained their trace id
    — the process that saw the tail latency promoted the trace; the
    processes whose segments looked fast locally only limbo'd theirs.
    ``M`` metadata rides along unconditionally (harmless duplicates)."""
    if not side:
        return []
    promoted = {
        (e.get("args") or {}).get("trace_id") for e in main
    } - {None}
    return [
        e for e in side
        if e.get("ph") == "M"
        or (e.get("args") or {}).get("trace_id") in promoted
    ]


def merge_trace_dir(trace_dir: str, out_name: str = "trace-merged.json") -> str:
    """Combine every per-process ``trace-*.json`` in ``trace_dir`` into one
    Perfetto-loadable file (distinct pids keep processes as separate
    tracks), with ``tracetail-*.json`` sidecar events rescued per
    :func:`rescue_sidecar_events`. Returns the merged file's path."""
    events, sidecar = read_trace_dir(trace_dir, out_name)
    events.extend(rescue_sidecar_events(events, sidecar))
    # stable cross-process ordering: metadata first, then by timestamp
    events.sort(key=lambda e: (e.get("ph") != "M", e.get("ts", 0)))
    out = os.path.join(trace_dir, out_name)
    tmp = out + ".tmp"
    with open(tmp, "w") as f:
        json.dump({"traceEvents": events, "displayTimeUnit": "ms"}, f)
    os.replace(tmp, out)
    return out
