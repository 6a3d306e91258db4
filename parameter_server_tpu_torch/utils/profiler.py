"""Continuous sampling profiler: folded stacks from ``sys._current_frames``.

Reference analog: none — the reference profiled with gperftools offline.
This is the live half: one daemon thread per armed process
samples every thread's Python stack at ``hz`` (wall-clock profiling:
blocked threads show their blocking frames, which is exactly what a
"where is the apply thread stuck" question needs), folds each stack into
a ``frame;frame;frame`` string and aggregates counts — the flamegraph
input format. Two export paths:

- ``dump()`` writes ``prof-<name>-<pid>.collapsed`` (one ``stack count``
  line per folded stack — flamegraph.pl / speedscope / inferno input)
  and a Perfetto-loadable ``.trace.json`` built by replaying the bounded
  sample ring into per-thread flame-chart spans (consecutive samples
  sharing a frame prefix keep that frame's span open) through the shared
  ``trace.write_chrome_trace`` exporter;
- the **top-N hot stacks** ride the heartbeat telemetry piggyback
  (``metrics.telemetry_snapshot`` resolves this module through
  ``sys.modules``, so an unarmed process
  never imports or pays for the profiler).

Disarmed discipline (the flightrec contract, restated): the module-level
``top_stacks`` is an **identity-pinned no-op** while disarmed (tests
assert ``top_stacks is _noop_top_stacks``), no sampler thread exists,
and arming is ``PS_PROFILE=<hz>`` env at import (spawned children
inherit it for free — the PS_FAULT_PLAN pattern) or ``[profile]``
config via ``configure()``.

Frame identity uses ``co_firstlineno`` (the def line), not the executing
line — otherwise every bytecode position would be its own stack and the
fold would never aggregate.
"""

from __future__ import annotations

import atexit
import os
import sys
import threading
import time
from collections import deque
from typing import Any

from parameter_server_tpu_torch.utils import flightrec
from parameter_server_tpu_torch.utils.metrics import wire_counters

PROFILE_ENV = "PS_PROFILE"
PROFILE_DIR_ENV = "PS_PROFILE_DIR"

DEFAULT_HZ = 29.0  # offset from round frequencies: never beats against
#                    a 10/100 Hz periodic workload and aliases nothing
#: folded-stack table bound: a pathological workload (generated code)
#: cannot grow the fold without bound — past this, new stacks collapse
#: into one "<other>" bucket (the KeyHeatSketch saturation discipline)
MAX_STACKS = 4096
#: bounded sample ring for the Perfetto flame-chart export (~2 minutes
#: of 29 Hz samples across a handful of threads)
MAX_SAMPLES = 8192


def _frame_label(frame) -> str:
    code = frame.f_code
    fn = code.co_filename
    short = "/".join(fn.replace("\\", "/").split("/")[-2:])
    return f"{code.co_name} ({short}:{code.co_firstlineno})"


class SamplingProfiler:
    """The sampler thread + folded aggregation (see module docstring)."""

    def __init__(
        self,
        hz: float = DEFAULT_HZ,
        top_n: int = 5,
        max_depth: int = 24,
        dump_dir: str = "",
        process_name: str = "",
    ):
        self.hz = float(hz) if hz > 0 else DEFAULT_HZ
        self.top_n = int(top_n)
        self.max_depth = int(max_depth)
        self.dump_dir = dump_dir
        self.process_name = process_name or f"proc-{os.getpid()}"
        self._folded: dict[str, int] = {}
        self._samples: deque[tuple[float, int, tuple[str, ...]]] = deque(
            maxlen=MAX_SAMPLES
        )
        self._lock = threading.Lock()
        self._stop = threading.Event()
        self._thread: threading.Thread | None = None
        self.samples = 0  # completed sampling passes (watchdog-style probe)

    # -- sampling ---------------------------------------------------------

    def start(self) -> "SamplingProfiler":
        if self._thread is None:
            self._thread = threading.Thread(
                target=self._run, daemon=True, name="ps-profiler"
            )
            self._thread.start()
        return self

    def _run(self) -> None:
        interval = 1.0 / self.hz
        me = threading.get_ident()
        while not self._stop.wait(interval):
            self.sample_once(exclude_ident=me)

    def sample_once(self, exclude_ident: int | None = None) -> int:
        """One sampling pass over every thread's current frame (tests
        drive this directly for determinism); returns stacks folded."""
        ts = time.time()
        frames = sys._current_frames()
        folded: list[tuple[int, tuple[str, ...]]] = []
        for ident, frame in frames.items():
            if ident == exclude_ident:
                continue  # the sampler observing itself is pure noise
            stack: list[str] = []
            f = frame
            while f is not None and len(stack) < self.max_depth:
                stack.append(_frame_label(f))
                f = f.f_back
            stack.reverse()  # root-first: the folded/flamegraph order
            folded.append((ident, tuple(stack)))
        with self._lock:
            for ident, stack in folded:
                key = ";".join(stack)
                if key not in self._folded and len(self._folded) >= MAX_STACKS:
                    key = "<other>"
                self._folded[key] = self._folded.get(key, 0) + 1
                self._samples.append((ts, ident, stack))
            self.samples += 1
        wire_counters.inc("prof_samples", len(folded))
        return len(folded)

    def stop(self) -> None:
        self._stop.set()
        if self._thread is not None:
            self._thread.join(timeout=2.0)
            self._thread = None

    # -- reads ------------------------------------------------------------

    def top_stacks(self, n: int | None = None) -> list[dict[str, Any]]:
        """The hottest folded stacks, heaviest first — the heartbeat
        piggyback block (``[{"s": folded, "n": count}, ...]``)."""
        with self._lock:
            items = sorted(self._folded.items(), key=lambda kv: -kv[1])
        return [
            {"s": s, "n": c} for s, c in items[: (n or self.top_n)]
        ]

    def folded(self) -> dict[str, int]:
        with self._lock:
            return dict(self._folded)

    # -- export -----------------------------------------------------------

    def to_chrome_events(self) -> list[dict[str, Any]]:
        """Replay the sample ring into per-thread flame-chart spans:
        a frame's span stays open while consecutive samples keep it at
        the same depth (standard sampled-profile reconstruction); gaps
        longer than ~2 sample intervals close everything."""
        with self._lock:
            samples = list(self._samples)
        # "thread", not "tid": in this package tid means TRACE id — the
        # OS thread id only surfaces in the Chrome-format "tid" field
        by_thread: dict[int, list[tuple[float, tuple[str, ...]]]] = {}
        for ts, thread, stack in samples:
            by_thread.setdefault(thread, []).append((ts, stack))
        pid = os.getpid()
        dt = 1.0 / self.hz
        events: list[dict[str, Any]] = []

        for thread, thread_samples in by_thread.items():
            thread_samples.sort(key=lambda x: x[0])
            open_frames: list[tuple[str, float]] = []  # (label, start_ts)

            def close_from(depth: int, end_ts: float, thread=thread) -> None:
                while len(open_frames) > depth:
                    label, t0 = open_frames.pop()
                    events.append({
                        "name": label,
                        "cat": "prof",
                        "ph": "X",
                        "ts": t0 * 1e6,
                        "dur": max((end_ts - t0) * 1e6, 1.0),
                        "pid": pid,
                        "tid": thread,
                    })

            prev_ts: float | None = None
            for ts, stack in thread_samples:
                if prev_ts is not None and ts - prev_ts > 2.5 * dt:
                    close_from(0, prev_ts + dt)  # sampling gap: restart
                common = 0
                for (label, _), cur in zip(open_frames, stack):
                    if label != cur:
                        break
                    common += 1
                close_from(common, ts)
                for label in stack[common:]:
                    open_frames.append((label, ts))
                prev_ts = ts
            if prev_ts is not None:
                close_from(0, prev_ts + dt)
        return events

    def dump(self, out_dir: str | None = None) -> dict[str, str] | None:
        """Write the collapsed + Perfetto exports; returns their paths
        (None when nothing was sampled or no dir is configured)."""
        d = out_dir or self.dump_dir
        if not d or not self.folded():
            return None
        os.makedirs(d, exist_ok=True)
        base = os.path.join(
            d, f"prof-{self.process_name}-{os.getpid()}"
        )
        collapsed = base + ".collapsed"
        tmp = collapsed + ".tmp"
        with open(tmp, "w") as f:
            for stack, count in sorted(self.folded().items()):
                f.write(f"{stack} {count}\n")
        os.replace(tmp, collapsed)
        from parameter_server_tpu_torch.utils.trace import write_chrome_trace

        trace_path = write_chrome_trace(
            self.to_chrome_events(), base + ".trace.json",
            process_names={os.getpid(): f"prof:{self.process_name}"},
        )
        wire_counters.inc("prof_dumps")
        flightrec.record(
            "prof.dump", stacks=len(self.folded()), samples=self.samples,
        )
        return {"collapsed": collapsed, "trace": trace_path}


# -- module-level arming (the flightrec discipline) -------------------------

_profiler: SamplingProfiler | None = None


def _noop_top_stacks(n: int | None = None) -> None:
    """Disarmed path: identity-pinned (tests assert ``top_stacks is
    _noop_top_stacks``) — the telemetry piggyback hook costs one call
    returning None on every unprofiled process."""
    return None


def _live_top_stacks(n: int | None = None) -> list[dict[str, Any]] | None:
    p = _profiler
    return p.top_stacks(n) if p is not None else None


#: the piggyback entry point ``metrics.telemetry_snapshot`` resolves via
#: sys.modules; rebound by configure() between the no-op and live paths
top_stacks = _noop_top_stacks


def enabled() -> bool:
    return _profiler is not None


def current() -> SamplingProfiler | None:
    return _profiler


def _atexit_dump() -> None:  # pragma: no cover - interpreter teardown
    try:
        p = _profiler
        if p is not None:
            p.stop()
            p.dump()
    except Exception:  # noqa: BLE001 — teardown must not mask exit
        pass


_atexit_armed = False


def configure(
    hz: float,
    top_n: int = 5,
    max_depth: int = 24,
    dump_dir: str = "",
    process_name: str = "",
) -> SamplingProfiler | None:
    """Arm (hz > 0) or disarm (hz <= 0) the process profiler, rebinding
    the module-level ``top_stacks`` between the live and the
    identity-pinned no-op paths. Re-arming stops the previous sampler
    and starts fresh (configure at process start, like the tracer)."""
    global _profiler, top_stacks, _atexit_armed
    if _profiler is not None:
        _profiler.stop()
        if _profiler.dump_dir:
            _profiler.dump()
        _profiler = None
        top_stacks = _noop_top_stacks
    if hz is None or hz <= 0:
        return None
    _profiler = SamplingProfiler(
        hz=hz, top_n=top_n, max_depth=max_depth,
        dump_dir=dump_dir, process_name=process_name,
    ).start()
    top_stacks = _live_top_stacks
    if not _atexit_armed:
        atexit.register(_atexit_dump)
        _atexit_armed = True
    return _profiler


def env_hz(value: str | None = None) -> float:
    """Parse the ``PS_PROFILE`` arming value: off for ``""``/``0``/
    ``off``/``false``, the default rate for ``1``/``true``/``on``, a
    number for an explicit Hz."""
    if value is None:
        value = os.environ.get(PROFILE_ENV, "")
    v = (value or "").strip().lower()
    if v in ("", "0", "off", "false", "no"):
        return 0.0
    if v in ("1", "on", "true", "yes"):
        return DEFAULT_HZ
    try:
        hz = float(v)
    except ValueError:
        return DEFAULT_HZ
    return hz if hz > 0 else 0.0


# env-armed at import so spawned children need no plumbing (the
# PS_FAULT_PLAN pattern); run_node re-configures with a role-rank name
if env_hz() > 0:
    configure(
        env_hz(), dump_dir=os.environ.get(PROFILE_DIR_ENV, "")
    )
