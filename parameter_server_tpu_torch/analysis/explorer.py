"""Seeded interleaving explorer (the scheduling complement of the
lock-order witness).

The witness catches *ordering* bugs; it cannot make an unlikely
interleaving HAPPEN. This module can, two ways, both driven by one seed
so a failure is a replayable artifact instead of a flake:

**Strict mode** (:class:`StrictSched`) is a PCT-style cooperative
scheduler for crafted concurrency scenarios: every managed thread owns
the single run token between *scheduling points* (lock acquire/release,
explicit ``point()`` boundaries), priorities are drawn from the seeded
RNG and reshuffled at seeded change points, and the highest-priority
runnable thread is always the one scheduled — so execution is a
deterministic serialization chosen adversarially by the seed. Same seed
=> same schedule trace => same failure, every run; a failing seed
printed once reproduces forever.

**Perturb mode** (``install(seed)`` / ``PS_SCHED=<seed>``) arms the
whole package the way the witness does: ``threading.Lock``/``RLock``/
``Condition`` and ``queue.Queue`` CONSTRUCTION in package modules is
wrapped so every acquire/release/put/get is a boundary, and the
``ShardServer`` publish (``_publish``, which bumps the version of the
in-place tables under the publish lock) gets its own boundary. At each boundary a per-site RNG stream derived from the seed
decides whether to yield the OS slice or inject a sub-millisecond stall
— forcing the adversarial interleavings (reader between publish and
ack, push racing a pull's cache fill) that free-running CI almost never
takes. Per-site decision streams depend only on (seed, site), so a
given boundary makes the same decision sequence in every run with that
seed. Armed tests print the seed on failure; re-arming with it replays
the same per-site schedule pressure.

Scope mirrors the witness: only package-constructed primitives are
instrumented, analysis/ itself is exempt, and stdlib internals keep raw
locks.

A copy of the JAX package's ``analysis/explorer.py``, aimed at the port:
its package marker is the port's, so with both packages loaded each
explorer wraps only its own package's primitives; a site's decision
stream is ``random.Random(f"{seed}:{site}")`` as in JAX, so a (seed,
site) pair decides the same in either; and the publish boundary wraps
``ShardServer._publish`` (the port has no ``state`` property setter).
``cli explore`` records into ``tests/torch_sched_corpus.json``.
"""

from __future__ import annotations

import os
import random
import sys
import threading
import time

from parameter_server_tpu_torch.analysis.witness import skip_tool_frames

ENV_VAR = "PS_SCHED"

_PKG_MARKER = os.sep + "parameter_server_tpu_torch" + os.sep

#: perturb-mode tuning: P(yield) + P(stall) per boundary, stall bound.
#: Small enough to keep an armed tier-1 test inside its budget, large
#: enough that a few thousand boundaries take many adversarial breaks.
_P_YIELD = 0.15
_P_STALL = 0.05
_STALL_MAX_S = 0.002


class SchedulerStall(RuntimeError):
    """Strict mode wedged: every managed thread is blocked (a real
    deadlock the schedule drove into, or an uninstrumented wait)."""


# ---------------------------------------------------------------------------
# perturb mode: package-wide seeded boundary perturbation
# ---------------------------------------------------------------------------


class _Perturb:
    """Per-site seeded decision streams + the armed-run decision log."""

    def __init__(self, seed: int):
        self.seed = seed
        self._lock = threading.Lock()  # guards the rng/decision maps
        self._rngs: dict[str, random.Random] = {}
        #: site -> list of decision codes (0 run on, 1 yield, 2 stall) —
        #: the replayable "schedule" an armed run took at each boundary
        self.decisions: dict[str, list[int]] = {}

    def point(self, site: str) -> None:
        with self._lock:
            rng = self._rngs.get(site)
            if rng is None:
                # stream identity is (seed, site): a site's decision
                # sequence is the same in every run with this seed,
                # independent of which threads hit it in what order
                rng = self._rngs[site] = random.Random(f"{self.seed}:{site}")
            r = rng.random()
            stall = rng.random() * _STALL_MAX_S  # drawn either way: the
            # stream must advance identically whatever r said
            code = 2 if r < _P_STALL else (1 if r < _P_STALL + _P_YIELD else 0)
            log = self.decisions.setdefault(site, [])
            if len(log) < 10000:  # bound the log, not the decisions
                log.append(code)
        if code == 2:
            time.sleep(stall)
        elif code == 1:
            time.sleep(0)  # release the GIL/OS slice


_perturb: _Perturb | None = None
_orig: dict[str, object] = {}
_installs = 0


def _caller_site(depth: int = 2) -> str | None:
    # armed together, each runtime tool's constructor calls the one armed
    # before it: the caller is the first frame above all of them
    f = skip_tool_frames(sys._getframe(depth))
    if f is None:
        return None
    fn = f.f_code.co_filename
    i = fn.rfind(_PKG_MARKER)
    if i < 0:
        return None
    rel = fn[i + len(_PKG_MARKER):].replace(os.sep, "/")
    if rel.startswith("analysis/"):
        return None  # the explorer must not instrument itself
    return f"{rel}:{f.f_lineno}"


class BoundaryLock:
    """Boundary-injecting proxy around whatever lock the current
    ``threading.Lock`` factory produces (the raw lock, or the witness's
    ``WitnessLock`` when both tools are armed — the explorer composes on
    top, so forced interleavings still get order-checked)."""

    def __init__(self, inner, site: str):
        self._psx_inner = inner
        self._psx_site = site

    def acquire(self, blocking: bool = True, timeout: float = -1):
        p = _perturb
        if p is not None:
            p.point("lock:" + self._psx_site)
        return self._psx_inner.acquire(blocking, timeout)

    def release(self) -> None:
        self._psx_inner.release()
        p = _perturb
        if p is not None:
            p.point("unlock:" + self._psx_site)

    def __enter__(self) -> "BoundaryLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self):
        return self._psx_inner.locked()

    def __getattr__(self, name: str):
        return getattr(self._psx_inner, name)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<BoundaryLock {self._psx_site} of {self._psx_inner!r}>"


def _lock_factory():
    site = _caller_site()
    inner = _orig["Lock"]()
    return BoundaryLock(inner, site) if site else inner


def _rlock_factory():
    site = _caller_site()
    inner = _orig["RLock"]()
    return BoundaryLock(inner, site) if site else inner


def _cond_factory(lock=None):
    if lock is None:
        site = _caller_site()
        if site is not None:
            lock = BoundaryLock(_orig["RLock"](), site)
    if lock is not None:
        return _orig["Condition"](lock)
    return _orig["Condition"]()


def _queue_factory(maxsize: int = 0):
    """Package-constructed queues get put/get boundaries (the apply
    queue is where push batches form — exactly the interleaving the
    batched-apply chaos tests need pressure on)."""
    site = _caller_site()
    q = _orig["Queue"](maxsize)
    if site is None:
        return q
    orig_put, orig_get = q.put, q.get

    def put(item, block=True, timeout=None):
        p = _perturb
        if p is not None:
            p.point(f"queue.put:{site}")
        return orig_put(item, block, timeout)

    def get(block=True, timeout=None):
        p = _perturb
        if p is not None:
            p.point(f"queue.get:{site}")
        return orig_get(block, timeout)

    q.put, q.get = put, get
    return q


def _wrap_rcu_publish() -> None:
    """Give the ShardServer publish its own boundary: ``_publish`` bumps
    the version of the tables an apply just changed in place, under the
    publish lock, so a perturbed pause around it stretches the hold that
    every gather and revalidation contends for."""
    ms = sys.modules.get("parameter_server_tpu_torch.parallel.multislice")
    if ms is None:
        try:  # arm-time import is fine: PS_SCHED runs are explicit
            import parameter_server_tpu_torch.parallel.multislice as ms  # type: ignore
        except Exception:  # pragma: no cover - torn env
            return
    cls = getattr(ms, "ShardServer", None)
    orig = cls.__dict__.get("_publish") if cls is not None else None
    if orig is None or not callable(orig):
        return  # pragma: no cover - refactored away; boundary just absent
    _orig["ShardServer._publish"] = (cls, orig)

    def publish(self) -> None:
        p = _perturb
        if p is not None:
            p.point("rcu-publish:ShardServer._publish")
        orig(self)
        if p is not None:
            p.point("rcu-published:ShardServer._publish")

    setattr(cls, "_publish", publish)


def install(seed: int = 0) -> None:
    """Arm perturb mode process-wide (idempotent, reference-counted,
    composes over an armed witness — the explorer wraps whatever lock
    factory is current)."""
    global _perturb, _installs
    _installs += 1
    if _installs > 1:
        return
    import queue as queue_mod

    _perturb = _Perturb(int(seed))
    _orig["Lock"] = threading.Lock
    _orig["RLock"] = threading.RLock
    _orig["Condition"] = threading.Condition
    _orig["Queue"] = queue_mod.Queue
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _cond_factory
    queue_mod.Queue = _queue_factory
    _wrap_rcu_publish()


def uninstall() -> None:
    global _perturb, _installs
    if _installs == 0:
        return
    _installs -= 1
    if _installs > 0:
        return
    import queue as queue_mod

    threading.Lock = _orig["Lock"]
    threading.RLock = _orig["RLock"]
    threading.Condition = _orig["Condition"]
    queue_mod.Queue = _orig["Queue"]
    wrapped = _orig.pop("ShardServer._publish", None)
    if wrapped is not None:
        cls, orig = wrapped
        setattr(cls, "_publish", orig)
    _perturb = None


def installed() -> bool:
    return _installs > 0


def current_seed() -> int | None:
    return _perturb.seed if _perturb is not None else None


def decisions() -> dict[str, list[int]]:
    """The armed run's per-site decision log (replayable: same seed =>
    same per-site sequences)."""
    return (
        {k: list(v) for k, v in _perturb.decisions.items()}
        if _perturb is not None
        else {}
    )


def replay_hint() -> str:
    return f"replay this interleaving with {ENV_VAR}={current_seed()}"


def maybe_install_from_env() -> bool:
    """Chaos-style opt-in: ``PS_SCHED=<seed>`` arms perturb mode."""
    v = os.environ.get(ENV_VAR, "")
    if v not in ("", "0"):
        try:
            seed = int(v)
        except ValueError:
            seed = 1
        install(seed)
        return True
    return False


# ---------------------------------------------------------------------------
# seed corpus + budgeted search (``cli explore``)
# ---------------------------------------------------------------------------

#: committed corpus of schedule seeds that once FAILED a test: the
#: explorer-armed tier-1 run replays them forever (a fixed bug's
#: breaking interleaving becomes its regression test), and ``cli
#: explore`` appends new ones
CORPUS_SCHEMA = "pssched/1"


def load_corpus(path: str) -> dict[str, list[int]]:
    """test node id -> failing seeds. Missing/foreign files read as
    empty — exploration must bootstrap from nothing."""
    import json

    try:
        with open(path) as f:
            doc = json.load(f)
    except (OSError, ValueError):
        return {}
    if doc.get("schema") != CORPUS_SCHEMA:
        return {}
    return {
        str(t): sorted({int(s) for s in seeds})
        for t, seeds in (doc.get("tests") or {}).items()
    }


def corpus_seeds(path: str, test: str) -> list[int]:
    """The committed failing seeds for one test node id (the set the
    explorer-armed tier-1 run replays on top of its fixed seed)."""
    return load_corpus(path).get(test, [])


def record_failing_seeds(
    path: str, test: str, seeds: list[int]
) -> dict[str, list[int]]:
    """Merge newly found failing seeds into the corpus file (created if
    missing; seeds dedup'd and sorted so the diff is reviewable). A file
    that EXISTS but doesn't parse as this schema (torn merge, future
    build) refuses the write — load_corpus reads such files as empty,
    and silently rewriting would destroy every committed seed."""
    import json

    corpus = load_corpus(path)
    if not corpus and os.path.exists(path) and os.path.getsize(path):
        try:
            with open(path) as f:
                ours = json.load(f).get("schema") == CORPUS_SCHEMA
        except (OSError, ValueError):
            ours = False
        if not ours:
            raise RuntimeError(
                f"corpus {path} exists but is not a {CORPUS_SCHEMA} "
                "file (torn write? newer schema?) — refusing to "
                "overwrite it; fix or remove the file first"
            )
    corpus[test] = sorted(set(corpus.get(test, [])) | set(seeds))
    # atomic tmp+rename (the flightrec dump idiom): a write interrupted
    # mid-dump must never leave a torn corpus the tier-1 replay would
    # read as empty
    tmp = f"{path}.tmp.{os.getpid()}"
    with open(tmp, "w") as f:
        json.dump({
            "schema": CORPUS_SCHEMA,
            "comment": (
                "schedule seeds that once failed a test under the "
                "PS_SCHED interleaving explorer; cli explore appends, "
                "the explorer-armed tier-1 run replays. Replay one by "
                "hand: PS_SCHED=<seed> python -m pytest <test>"
            ),
            "tests": {t: corpus[t] for t in sorted(corpus)},
        }, f, indent=1, sort_keys=False)
        f.write("\n")
    os.replace(tmp, path)
    return corpus


class SearchError(RuntimeError):
    """The search INFRASTRUCTURE broke mid-budget (pytest could not
    run — collection/usage/internal error), as opposed to a seed
    failing the test. Carries the failing seeds found before the break
    so the caller can still record/report a long search's finds."""

    def __init__(self, seed: int, failing: list[int], cause: Exception):
        super().__init__(f"seed {seed}: {cause}")
        self.seed = seed
        self.failing = list(failing)


def search_seeds(
    test: str,
    budget: int,
    start_seed: int = 1,
    runner=None,
    on_result=None,
    timeout_s: float = 120.0,
) -> list[int]:
    """Budgeted schedule-seed search: run ``test`` under
    ``PS_SCHED=<seed>`` for seeds ``start_seed .. start_seed+budget-1``
    and return the seeds that FAILED it (the interleavings worth
    keeping). ``runner(seed) -> bool`` (True = test passed) defaults to
    a pytest subprocess per seed — a fresh interpreter per seed is what
    makes the arming honest (the explorer wraps construction, so it
    must be armed before the package imports). A seed that WEDGES the
    test past ``timeout_s`` counts as failing: a deadlock interleaving
    is the search's most valuable find, not a reason to hang it. A
    runner that RAISES aborts the search with :class:`SearchError`
    carrying the finds so far — an hours-long budget must not lose its
    results to one transient infra hiccup."""
    if runner is None:
        runner = _pytest_runner(test, timeout_s=timeout_s)
    failing: list[int] = []
    for seed in range(start_seed, start_seed + budget):
        try:
            passed = bool(runner(seed))
        except Exception as e:
            raise SearchError(seed, failing, e) from e
        if not passed:
            failing.append(seed)
        if on_result is not None:
            on_result(seed, passed)
    return failing


def _pytest_runner(test: str, timeout_s: float = 120.0):
    import signal
    import subprocess
    import sys as _sys

    # a relative node id ("tests/test_x.py::T::t") only collects from
    # the repo root — anchor the subprocess there when the file part
    # isn't visible from the caller's cwd, so `cli explore` works from
    # any directory instead of recording collection errors as "finds"
    cwd = None
    file_part = test.split("::", 1)[0]
    if not os.path.exists(file_part):
        repo_root = os.path.dirname(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))))
        if os.path.exists(os.path.join(repo_root, file_part)):
            cwd = repo_root

    def run(seed: int) -> bool:
        env = dict(os.environ, **{ENV_VAR: str(seed)})
        # own session so a timed-out child's whole process GROUP dies —
        # the test may have launch_local'd server processes a bare
        # kill() of pytest would orphan
        proc = subprocess.Popen(
            [_sys.executable, "-m", "pytest", test, "-x", "-q",
             "--no-header", "-p", "no:cacheprovider"],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            text=True, start_new_session=True, cwd=cwd,
        )
        try:
            out, err = proc.communicate(timeout=timeout_s)
        except subprocess.TimeoutExpired:
            try:
                os.killpg(proc.pid, signal.SIGKILL)
            except (ProcessLookupError, PermissionError):
                proc.kill()
            proc.communicate()
            return False  # a wedged interleaving IS a failing seed
        # pytest: 0 = passed, 1 = tests ran and failed. Anything else
        # (collection/usage/internal error, no tests collected) means
        # the SEARCH is broken, not the interleaving — recording such a
        # seed would poison the corpus tier-1 replays
        if proc.returncode not in (0, 1):
            tail = "\n".join((out + err).strip().splitlines()[-5:])
            raise RuntimeError(
                f"explore: pytest could not run {test!r} "
                f"(exit {proc.returncode}):\n{tail}"
            )
        return proc.returncode == 0

    return run


# ---------------------------------------------------------------------------
# strict mode: deterministic PCT scheduling of crafted scenarios
# ---------------------------------------------------------------------------


class _MThread:
    __slots__ = ("name", "order", "prio", "event", "state", "thread",
                 "blocked_on")

    def __init__(self, name: str, order: int, prio: float):
        self.name = name
        self.order = order  # registration order: the deterministic tiebreak
        self.prio = prio
        self.event = threading.Event()
        self.state = "new"  # new | ready | running | blocked | done
        self.thread: threading.Thread | None = None
        self.blocked_on: object = None


class StrictLock:
    """A lock whose contention is scheduled, not raced: managed threads
    try-acquire and, on failure, hand the token back to the scheduler
    instead of parking in the OS — so who wins a contended lock is the
    seed's choice, deterministically."""

    def __init__(self, sched: "StrictSched", name: str):
        self._sched = sched
        self._name = name
        self._inner = threading.Lock()

    def acquire(self) -> bool:
        self._sched.point(f"acquire:{self._name}")
        while not self._inner.acquire(False):
            self._sched._block_on(self)
        return True

    def release(self) -> None:
        self._inner.release()
        self._sched._unblock(self)
        self._sched.point(f"release:{self._name}")

    def __enter__(self) -> "StrictLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()


class StrictSched:
    """Deterministic PCT scheduler. Usage::

        sched = StrictSched(seed)
        lock = sched.lock("l")
        sched.spawn(worker_a, "a")
        sched.spawn(worker_b, "b")
        sched.run()            # raises nothing; failures collected
        sched.trace            # [(thread, site)...] — THE schedule
        sched.failures         # [(thread, exc)...], seed printed on any

    Managed threads run one at a time; the token moves only at
    scheduling points (``point()``, StrictLock operations, spawn/exit).
    Priorities come from the seeded RNG and are reassigned at seeded
    change points — the PCT idea: a random prioritization explores
    ordering bugs of depth d with known probability, and the SEED is the
    whole schedule."""

    #: a token wait longer than this means the holder parked in an
    #: uninstrumented wait — steal the token rather than hang the suite
    _STEAL_S = 2.0

    def __init__(self, seed: int, change_p: float = 0.3):
        self.seed = int(seed)
        self._rng = random.Random(self.seed)
        #: per-point probability the running thread's priority is
        #: redrawn (the PCT change points — this is what creates
        #: mid-critical-window preemptions; 0 degenerates to a single
        #: random serialization)
        self._change_p = float(change_p)
        self._lock = threading.Lock()  # guards scheduler state
        self._threads: dict[str, _MThread] = {}
        self._started = False
        self._step = 0
        self.trace: list[tuple[str, str]] = []
        self.failures: list[tuple[str, BaseException]] = []
        self._tls = threading.local()

    # -- construction ------------------------------------------------------

    def lock(self, name: str) -> StrictLock:
        return StrictLock(self, name)

    def spawn(self, target, name: str) -> None:
        """Register + start one managed thread (it parks at its entry
        point until the scheduler picks it). Call in a deterministic
        order — registration order is the priority tiebreak."""
        with self._lock:
            if self._started:
                raise RuntimeError("spawn() after run()")
            m = _MThread(name, len(self._threads), self._rng.random())
            self._threads[name] = m

        def body() -> None:
            self._tls_name(name)
            self._wait_for_token(m)
            try:
                target()
            except BaseException as e:  # noqa: BLE001 — recorded + replayable
                with self._lock:
                    self.failures.append((name, e))
                print(
                    f"[explorer] managed thread {name!r} failed under "
                    f"seed {self.seed}: {e!r} — {replay_strict_hint(self.seed)}",
                    file=sys.stderr,
                )
            finally:
                self._exit(m)

        m.thread = threading.Thread(target=body, name=name, daemon=True)
        m.state = "ready"
        m.thread.start()

    def _tls_name(self, name: str) -> None:
        self._tls.name = name

    def _me(self) -> _MThread | None:
        return self._threads.get(getattr(self._tls, "name", ""))

    # -- the token ---------------------------------------------------------

    def run(self, timeout: float = 30.0) -> None:
        """Schedule until every managed thread exits."""
        with self._lock:
            self._started = True
            self._dispatch_locked()
        deadline = time.monotonic() + timeout
        for m in self._threads.values():
            t = m.thread
            if t is not None:
                t.join(max(0.0, deadline - time.monotonic()))
        alive = [m.name for m in self._threads.values()
                 if m.thread is not None and m.thread.is_alive()]
        if alive:
            raise SchedulerStall(
                f"managed threads still alive after {timeout}s under "
                f"seed {self.seed}: {alive}"
            )

    def point(self, site: str) -> None:
        """One scheduling point: log, maybe reshuffle this thread's
        priority, hand the token to the highest-priority ready thread
        (possibly this one)."""
        m = self._me()
        if m is None:
            return  # unmanaged thread (the test's main thread): no-op
        with self._lock:
            self._step += 1
            self.trace.append((m.name, site))
            if self._rng.random() < self._change_p:
                m.prio = self._rng.random()
            m.state = "ready"
            self._dispatch_locked()
        self._wait_for_token(m)

    def _block_on(self, lock: StrictLock) -> None:
        m = self._me()
        if m is None:  # unmanaged: really park (strict locks are raw)
            lock._inner.acquire()
            lock._inner.release()
            return
        with self._lock:
            self.trace.append((m.name, f"blocked:{lock._name}"))
            m.state = "blocked"
            m.blocked_on = lock
            self._dispatch_locked()
        self._wait_for_token(m)

    def _unblock(self, lock: StrictLock) -> None:
        with self._lock:
            for m in self._threads.values():
                if m.state == "blocked" and m.blocked_on is lock:
                    m.state = "ready"
                    m.blocked_on = None

    def _exit(self, m: _MThread) -> None:
        with self._lock:
            self.trace.append((m.name, "exit"))
            m.state = "done"
            self._dispatch_locked()

    def _dispatch_locked(self) -> None:
        """Pick the highest-priority ready thread and wake it (caller
        holds ``self._lock``)."""
        ready = [
            t for t in self._threads.values() if t.state == "ready"
        ]
        if not ready:
            return
        nxt = max(ready, key=lambda t: (t.prio, -t.order))
        nxt.state = "running"
        nxt.event.set()

    def _wait_for_token(self, m: _MThread) -> None:
        while True:
            if m.event.wait(self._STEAL_S):
                m.event.clear()
                return
            with self._lock:
                # the holder is parked in an uninstrumented wait (or
                # exited without dispatch finding us ready): if nothing
                # is running, steal the token so the suite doesn't hang
                if not any(
                    t.state == "running" for t in self._threads.values()
                ):
                    if m.state == "ready":
                        m.state = "running"
                        self.trace.append((m.name, "steal"))
                        return


def replay_strict_hint(seed: int) -> str:
    return f"StrictSched(seed={seed}) replays the identical schedule"
