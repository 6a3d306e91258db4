"""Runtime lock-order witness (the dynamic complement of ``lock-order``).

Armed chaos-style — opt-in via ``PS_LOCK_WITNESS=1`` (or an explicit
``install()`` from the test harness) — the witness wraps
``threading.Lock`` / ``RLock`` / ``Condition`` CONSTRUCTION so that every
lock created by package code carries its construction site as its
identity (``parallel/control.py:1130``), then records the actual
acquisition order each thread takes. Acquiring lock B while holding lock
A adds the edge A -> B to a process-global order graph, seeded with the
edges the static analyzer derived (analysis/lockgraph.py, translated to
construction sites); an acquisition that would close a cycle — i.e. an
inversion of an order the process (or the static analysis) has already
witnessed — raises :class:`LockOrderViolation` BEFORE blocking, naming
the cycle. That converts a probabilistic deadlock hang into a
deterministic stack trace at the first inverted acquisition, which is
the FreeBSD WITNESS idea rebuilt for this codebase.

Scope: only locks constructed from ``parameter_server_tpu_torch`` source
files are instrumented (stdlib internals — queue, concurrent.futures,
threading.Event — keep raw locks), and same-site pairs are exempt (two
instances of one class are peers, not an ordering).

A copy of the JAX package's ``analysis/witness.py``, aimed at the port:
its sites are the port's files, and its static seed is the port's lock
graph. It stacks with another witness over the same constructors (the
JAX package's, which its test harness arms for a whole session): install
wraps whatever constructor is current, a second install only counts, and
uninstall restores only from the top of the stack (in LIFO order; out of
order it raises and changes nothing). The port's site lookup steps over
the constructor frames of another witness, of the explorer and of the race
witness (``skip_tool_frames``, which those two use too), so port locks are
instrumented whichever tool was armed last; the JAX witness looks exactly two
frames up, so a JAX lock constructed while this one sits above it stays
raw.
"""

from __future__ import annotations

import os
import sys
import threading
import time

ENV_VAR = "PS_LOCK_WITNESS"

_PKG_MARKER = os.sep + "parameter_server_tpu_torch" + os.sep
#: the constructor wrappers of this module (and of any witness, explorer
#: or race witness module built the same way, of either package), stepped
#: over when looking for the caller: armed together, each tool's factory
#: calls the one armed before it
_FACTORY_NAMES = frozenset({"_lock_factory", "_rlock_factory", "_cond_factory"})
_FACTORY_FILES = tuple(
    os.sep + n for n in ("witness.py", "explorer.py", "racewitness.py")
)


def skip_tool_frames(f):
    """``f``, or the first frame above it that is no constructor wrapper
    of the runtime tools (see ``_FACTORY_NAMES``); None past the top."""
    while f is not None and f.f_code.co_name in _FACTORY_NAMES and (
        f.f_code.co_filename.endswith(_FACTORY_FILES)
    ):
        f = f.f_back
    return f


class LockOrderViolation(RuntimeError):
    """An acquisition inverted an already-witnessed lock order."""


class _Graph:
    """Process-global acquisition-order graph (site-name nodes)."""

    def __init__(self, raw_lock_cls):
        self._lock = raw_lock_cls()
        self._adj: dict[str, set[str]] = {}
        #: the static seed, the edges live acquisitions took, and the
        #: inversions raised (counted even where a caller swallows them)
        self.seeded: set[tuple[str, str]] = set()
        self.witnessed: set[tuple[str, str]] = set()
        self.violations = 0
        self.seed_s = 0.0

    def seed(self, edges) -> None:
        """Seed statically-derived edges THROUGH the cycle check (in
        deterministic order): if the static graph itself contains a
        cycle — e.g. one a maintainer pragma-suppressed past the
        lock-order checker — only the first direction seeds, so the
        graph stays acyclic and a runtime acquisition taking the other
        direction still raises instead of hitting the already-witnessed
        fast path."""
        for a, b in sorted(edges):
            if a != b:
                self.seeded.add((a, b))
                self.check_and_add(a, b)  # a returned cycle: edge skipped

    def edges(self) -> set[tuple[str, str]]:
        with self._lock:
            return {(a, b) for a, bs in self._adj.items() for b in bs}

    def clear(self) -> None:
        with self._lock:
            self._adj.clear()

    def check_and_add(self, held: str, acquiring: str) -> list[str] | None:
        """Record ``held -> acquiring``; returns a cycle path when the
        reverse direction is already reachable (the inversion)."""
        with self._lock:
            if acquiring in self._adj.get(held, ()):
                return None  # edge already witnessed (and cycle-checked)
            # BFS: acquiring ~> held already known?
            if acquiring in self._adj:
                parents: dict[str, str] = {}
                frontier = [acquiring]
                seen = {acquiring}
                found = False
                while frontier and not found:
                    nxt: list[str] = []
                    for n in frontier:
                        for m in self._adj.get(n, ()):  # noqa: B007
                            if m in seen:
                                continue
                            parents[m] = n
                            if m == held:
                                found = True
                                break
                            seen.add(m)
                            nxt.append(m)
                        if found:
                            break
                    frontier = nxt
                if found:
                    path = [held]
                    while path[-1] != acquiring:
                        path.append(parents.get(path[-1], acquiring))
                    return path[::-1] + [acquiring]
            self._adj.setdefault(held, set()).add(acquiring)
            return None


class _ThreadState(threading.local):
    def __init__(self) -> None:
        self.counts: dict[int, int] = {}  # id(wrapper) -> recursion depth
        self.stack: list["WitnessLock"] = []  # first-acquisition order


_tls = _ThreadState()
_graph: _Graph | None = None
_orig: dict[str, object] = {}
_installs = 0


class WitnessLock:
    """Order-witnessing proxy around a raw Lock/RLock. Duck-compatible
    with the lock API (``with``, acquire/release, Condition's
    ``_is_owned``/``_release_save`` forwarding via ``__getattr__``)."""

    def __init__(self, inner, name: str):
        self._psl_inner = inner
        self._psl_name = name

    def _psl_check(self) -> None:
        g = _graph
        if g is None:
            return
        name = self._psl_name
        for h in _tls.stack:
            if h._psl_name == name:
                continue  # peers of one site: not an ordering
            cycle = g.check_and_add(h._psl_name, name)
            g.witnessed.add((h._psl_name, name))
            if cycle is not None:
                g.violations += 1
                raise LockOrderViolation(
                    f"lock order inversion: thread "
                    f"{threading.current_thread().name} acquires "
                    f"{name} while holding {h._psl_name}, but the "
                    "witnessed order is " + " -> ".join(cycle)
                )

    def acquire(self, blocking: bool = True, timeout: float = -1):
        first = _tls.counts.get(id(self), 0) == 0
        if first:
            # check (and record) BEFORE blocking: an inversion raises
            # with a stack trace instead of deadlocking probabilistically
            self._psl_check()
        got = self._psl_inner.acquire(blocking, timeout)
        if got:
            _tls.counts[id(self)] = _tls.counts.get(id(self), 0) + 1
            if first:
                _tls.stack.append(self)
        return got

    def release(self) -> None:
        self._psl_inner.release()
        c = _tls.counts.get(id(self), 0)
        if c <= 1:
            _tls.counts.pop(id(self), None)
            try:
                _tls.stack.remove(self)
            except ValueError:  # released by a thread that never acquired
                pass
        else:
            _tls.counts[id(self)] = c - 1

    def __enter__(self) -> "WitnessLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self):
        return self._psl_inner.locked()

    def __getattr__(self, name: str):
        return getattr(self._psl_inner, name)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<WitnessLock {self._psl_name} of {self._psl_inner!r}>"


def wrap(inner, name: str) -> WitnessLock:
    """Explicitly wrap a raw lock (tests; ad-hoc instrumentation)."""
    return WitnessLock(inner, name)


def _caller_site() -> str | None:
    # factory -> patched ctor -> caller, past other tools' constructors
    f = skip_tool_frames(sys._getframe(2))
    if f is None:
        return None
    fn = f.f_code.co_filename
    i = fn.rfind(_PKG_MARKER)
    if i < 0:
        return None
    rel = fn[i + len(_PKG_MARKER):].replace(os.sep, "/")
    if rel.startswith("analysis/"):
        return None  # the witness must not instrument itself
    return f"{rel}:{f.f_lineno}"


def _lock_factory():
    site = _caller_site() if _graph is not None else None
    inner = _orig["Lock"]()
    return WitnessLock(inner, site) if site else inner


def _rlock_factory():
    site = _caller_site() if _graph is not None else None
    inner = _orig["RLock"]()
    return WitnessLock(inner, site) if site else inner


def _cond_factory(lock=None):
    # instrument the default lock of package-constructed Conditions: the
    # Condition delegates acquire/release to it, so `with cv:` records
    # through the wrapper while cv.wait()'s internal release/re-acquire
    # (which never changes what the thread holds overall) stays raw
    if lock is None and _graph is not None:
        site = _caller_site()
        if site is not None:
            lock = WitnessLock(_orig["RLock"](), site)
    return _orig["Condition"](lock) if lock is not None else _orig["Condition"]()


def _static_site_edges() -> set[tuple[str, str]]:
    """The statically-derived order, translated from lock KEYS
    (``RpcClient._cv``) to construction sites (``parallel/control.py:N``)
    so runtime identities match."""
    from parameter_server_tpu_torch.analysis import build_lock_graph, load_package

    lg = build_lock_graph(load_package())
    out: set[tuple[str, str]] = set()
    for (a, b) in lg.edges:
        for ap, al in lg.sites.get(a, ()):  # noqa: B007
            for bp, bl in lg.sites.get(b, ()):
                out.add((f"{ap}:{al}", f"{bp}:{bl}"))
    return out


def _on_top() -> bool:
    return (
        threading.Lock is _lock_factory
        and threading.RLock is _rlock_factory
        and threading.Condition is _cond_factory
    )


def install(static: bool = True) -> None:
    """Arm the witness: wrap the threading lock constructors as they
    stand (another witness's included) and seed the order graph with the
    static analyzer's edges. Idempotent; nested installs are
    reference-counted and never wrap twice."""
    global _graph, _installs
    _installs += 1
    if _installs > 1:
        return
    if not _on_top():
        _orig["Lock"] = threading.Lock
        _orig["RLock"] = threading.RLock
        _orig["Condition"] = threading.Condition
    graph = _Graph(_orig["Lock"])
    if static:
        t0 = time.perf_counter()
        try:
            graph.seed(_static_site_edges())
        except Exception:  # pragma: no cover - analyzer must never arm-fail
            pass
        graph.seed_s = time.perf_counter() - t0
    _graph = graph
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _cond_factory


def uninstall() -> None:
    """Disarm: restore the constructors this witness wrapped. Locks
    already wrapped keep working (the wrapper simply stops finding a
    graph to record into). The last uninstall must find this witness's
    constructors on top (LIFO against any witness armed after it);
    otherwise it raises and changes nothing."""
    global _graph, _installs
    if _installs == 0:
        return
    if _installs == 1 and not _on_top():
        raise RuntimeError(
            "lock-order witness uninstalled out of LIFO order: another "
            "wrapper was installed over threading.Lock/RLock/Condition "
            "after this one; uninstall that one first"
        )
    _installs -= 1
    if _installs > 0:
        return
    threading.Lock = _orig["Lock"]
    threading.RLock = _orig["RLock"]
    threading.Condition = _orig["Condition"]
    _graph = None


def installed() -> bool:
    return _installs > 0


def observed_edges() -> set[tuple[str, str]]:
    """The current order graph (static seed + runtime observations)."""
    return _graph.edges() if _graph is not None else set()


def report() -> dict:
    """What this process's armed witness saw: the edges live acquisitions
    took (``held -> acquired`` site pairs), those of them the static lock
    graph lacks, the inversions it raised, the size of the static seed
    and the seconds seeding took. Empty when disarmed."""
    g = _graph
    if g is None:
        return {}
    seen = set(g.witnessed)
    beyond = sorted(seen - g.seeded)
    return {
        "edges": len(seen),
        "not_static": len(beyond),
        "not_static_edges": [list(e) for e in beyond],
        "violations": g.violations,
        "static_edges": len(g.seeded),
        "seed_s": g.seed_s,
    }


def maybe_install_from_env() -> bool:
    """The chaos-style opt-in: arm iff ``PS_LOCK_WITNESS`` is truthy."""
    if os.environ.get(ENV_VAR, "") not in ("", "0"):
        install()
        return True
    return False
