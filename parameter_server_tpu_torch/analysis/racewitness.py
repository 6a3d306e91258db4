"""Eraser-style lockset race witness (``PS_RACE_WITNESS=1``) — the
data-race complement of the lock-order witness (analysis/witness.py) and
the seeded interleaving explorer (analysis/explorer.py).

The witness catches wrong lock ORDERS; the explorer MAKES unlikely
schedules happen; neither notices a shared field that is simply
accessed with no lock at all — the bug class Eraser's lockset
discipline catches without needing the racy schedule to fire. Armed,
this module:

1. wraps ``threading.Lock``/``RLock``/``Condition`` CONSTRUCTION in
   package modules (composing over whatever factory is current — an
   armed witness or explorer keeps working underneath) so each thread's
   currently-held lock set is tracked;
2. instruments REGISTERED shared objects (``track(obj, fields)`` —
   no-op unless armed): the named fields become observed attributes,
   and every read/write records the accessing thread and its held
   locks;
3. runs the lockset state machine per (object, field): first thread
   owns the field exclusively; once a second thread touches it, the
   candidate lockset is the intersection of locks held at every
   access — when the intersection goes EMPTY on a write/write or
   write/read pair from different threads, that pair is reported with
   BOTH stacks (the current access's and the remembered conflicting
   one).

Reports collect in ``reports()`` (and print once to stderr); they are
diagnoses, not exceptions — an armed chaos run finishes and THEN
asserts ``reports() == []``, the acceptance form the serving
chaos-coherence test runs under.

Registered objects (the registration hooks live in the owning
constructors, zero-cost disarmed): the quantized-push residual
accumulator (``ServerHandle._residual``/``_res_map``/``_res_vdim``
under ``_res_lock``), the server's single-flight encode-cache byte
budget (``ShardServer._enc_bytes`` under ``_enc_lock``), the durable
push ledger (``ShardServer._applied_push``: read and recorded under
``_lock`` in ``_apply_batch`` and the serial push path, replaced under
``_lock`` and ``_pub_lock`` by ``load_state``), the mesh backend's
residual (``MeshBackend._residual`` under its ``_res_lock``), the per-key
heat sketch (``KeyHeatSketch._t``/``_n``/``_hot`` under its lock), the
client key cache's invalidation generation (``ClientKeyCache._gen``
under its ``_lock``) and the pipelined client's in-flight window
(``RpcClient._pending``/``_eff_window`` under ``_cv``).

Scope mirrors the sibling witnesses: only package-constructed locks are
instrumented, ``analysis/`` itself is exempt, and only instances
explicitly registered while armed are observed (an instance built
before arming keeps raw attributes — its locks would be raw too, and
observing it would report phantom races).

A copy of the JAX package's ``analysis/racewitness.py`` with the port's
package marker: with both packages loaded, each witness wraps only its
own package's locks. ``utils/metrics.race_track`` resolves this module
through ``sys.modules``, and ``launch_local`` exports ``PS_RACE_WITNESS``
to every node it spawns while armed.
"""

from __future__ import annotations

import os
import sys
import threading
import traceback
from dataclasses import dataclass, field

from parameter_server_tpu_torch.analysis.witness import skip_tool_frames

ENV_VAR = "PS_RACE_WITNESS"

_PKG_MARKER = os.sep + "parameter_server_tpu_torch" + os.sep

_MARKER = "_psr_tracked_name"  # instance-dict opt-in marker

_installs = 0
_orig: dict[str, object] = {}
_lock = threading.Lock()  # guards _fields/_reports/_instrumented
_reports: list["RaceReport"] = []
#: class -> fields instrumented (descriptors installed)
_instrumented: dict[type, set[str]] = {}
#: (id(obj), field) -> _FieldState
_fields: dict[tuple[int, str], "_FieldState"] = {}


class _Tls(threading.local):
    def __init__(self) -> None:
        self.held: list[int] = []  # id() of each held LocksetLock


_tls = _Tls()


@dataclass
class RaceReport:
    obj: str
    attr: str
    kind: str  # write/write | read/write
    thread_a: str
    stack_a: list[str]
    thread_b: str
    stack_b: list[str]

    def render(self) -> str:
        a = "".join(self.stack_a).rstrip()
        b = "".join(self.stack_b).rstrip()
        return (
            f"RACE {self.kind} on {self.obj}.{self.attr}: no common "
            f"lock across threads\n"
            f"--- {self.thread_a} ---\n{a}\n"
            f"--- {self.thread_b} ---\n{b}"
        )


@dataclass
class _Access:
    thread: str
    ident: int
    write: bool
    stack: list[str] = field(default_factory=list)


@dataclass
class _FieldState:
    name: str  # "<ClassName#1a2b>" registration name
    first_thread: int | None = None
    shared: bool = False
    lockset: frozenset[int] | None = None  # candidate set once shared
    last_write: _Access | None = None
    last_read: _Access | None = None
    reported: bool = False


def _stack() -> list[str]:
    # the witness's own frames (this helper, the recorder and the
    # descriptor __get__/__set__) are noise — the access site is last
    return traceback.format_stack(limit=10)[:-3]


def _record(obj, attr: str, write: bool) -> None:
    key = (id(obj), attr)
    # peek (GIL-atomic dict read) and format the stack OUTSIDE the
    # global lock: formatting is the expensive part of every tracked
    # access and must not serialize all threads; once a field has
    # reported, further bookkeeping on it buys nothing
    st0 = _fields.get(key)
    if st0 is None or st0.reported:
        return
    me = threading.get_ident()
    held = frozenset(_tls.held)
    stack = _stack()
    with _lock:
        st = _fields.get(key)
        if st is None or st.reported:
            return  # untracked instance (marker raced an uninstall)
        if st.first_thread is None:
            st.first_thread = me
        if not st.shared:
            if st.first_thread == me:
                # exclusive phase: remember accesses for later pairing,
                # but no lockset judgment yet (init writes are benign)
                acc = _Access(
                    threading.current_thread().name, me, write, stack
                )
                if write:
                    st.last_write = acc
                else:
                    st.last_read = acc
                return
            st.shared = True
            st.lockset = held
        else:
            st.lockset = (
                held if st.lockset is None else st.lockset & held
            )
        acc = _Access(threading.current_thread().name, me, write, stack)
        # the remembered half of a report must be a CONFLICTING access
        # from a DIFFERENT thread — pairing with this thread's own
        # earlier access would render one thread on both sides and send
        # the reader to a non-racing site. Prefer the write (write/write
        # beats read/write when both are available).
        others = [
            a for a in (st.last_write, st.last_read)
            if a is not None and a.ident != me and (write or a.write)
        ]
        if not st.lockset and others:
            other = others[0]
            kind = "write/write" if write and other.write else "read/write"
            st.reported = True
            rep = RaceReport(
                st.name, attr, kind,
                acc.thread, acc.stack,
                other.thread, other.stack,
            )
            _reports.append(rep)
            print(
                f"[racewitness] {rep.render()}", file=sys.stderr
            )
        if write:
            st.last_write = acc
        else:
            st.last_read = acc


class _RaceField:
    """Data descriptor observing one tracked attribute. Values live in
    the instance dict under the REAL attribute name, so uninstalling
    (deleting the descriptor) leaves every instance's state intact."""

    def __init__(self, name: str, prev: object | None):
        self._name = name
        self._prev = prev  # shadowed class attribute (restored on uninstall)

    def __get__(self, obj, objtype=None):
        if obj is None:
            return self
        try:
            v = obj.__dict__[self._name]
        except KeyError:
            if self._prev is not None:
                return self._prev
            raise AttributeError(self._name) from None
        if obj.__dict__.get(_MARKER) is not None:
            _record(obj, self._name, write=False)
        return v

    def __set__(self, obj, value) -> None:
        if obj.__dict__.get(_MARKER) is not None:
            _record(obj, self._name, write=True)
        obj.__dict__[self._name] = value

    def __delete__(self, obj) -> None:
        obj.__dict__.pop(self._name, None)


# -- lock construction wrapping (held-set tracking) --------------------------


class LocksetLock:
    """Held-set-tracking proxy around whatever lock the current factory
    produces (raw, witness-wrapped, explorer-wrapped — composes)."""

    def __init__(self, inner):
        self._psr_inner = inner

    def acquire(self, blocking: bool = True, timeout: float = -1):
        got = self._psr_inner.acquire(blocking, timeout)
        if got:
            _tls.held.append(id(self))
        return got

    def release(self) -> None:
        self._psr_inner.release()
        try:
            _tls.held.remove(id(self))
        except ValueError:
            pass

    def __enter__(self) -> "LocksetLock":
        self.acquire()
        return self

    def __exit__(self, *exc) -> None:
        self.release()

    def locked(self):
        return self._psr_inner.locked()

    def __getattr__(self, name: str):
        return getattr(self._psr_inner, name)

    def __repr__(self) -> str:  # pragma: no cover - debugging aid
        return f"<LocksetLock of {self._psr_inner!r}>"


def _package_site() -> bool:
    # armed together, each runtime tool's constructor calls the one armed
    # before it: the caller is the first frame above all of them
    f = skip_tool_frames(sys._getframe(2))
    if f is None:
        return False
    fn = f.f_code.co_filename
    i = fn.rfind(_PKG_MARKER)
    if i < 0:
        return False
    rel = fn[i + len(_PKG_MARKER):].replace(os.sep, "/")
    return not rel.startswith("analysis/")


def _lock_factory():
    inner = _orig["Lock"]()
    return LocksetLock(inner) if _package_site() else inner


def _rlock_factory():
    inner = _orig["RLock"]()
    return LocksetLock(inner) if _package_site() else inner


def _cond_factory(lock=None):
    if lock is None and _package_site():
        lock = LocksetLock(_orig["RLock"]())
    if lock is not None:
        return _orig["Condition"](lock)
    return _orig["Condition"]()


# -- public surface ----------------------------------------------------------


def wrap(inner) -> LocksetLock:
    """Explicitly wrap a raw lock (tests; ad-hoc instrumentation of a
    lock constructed outside package modules)."""
    return LocksetLock(inner)


def install() -> None:
    """Arm process-wide (idempotent, reference-counted, composes over
    the witness/explorer factories). Arm BEFORE constructing the
    objects to observe — their locks must be wrapped and their
    registration hooks must see the armed state."""
    global _installs
    _installs += 1
    if _installs > 1:
        return
    _orig["Lock"] = threading.Lock
    _orig["RLock"] = threading.RLock
    _orig["Condition"] = threading.Condition
    threading.Lock = _lock_factory
    threading.RLock = _rlock_factory
    threading.Condition = _cond_factory


def uninstall() -> None:
    global _installs
    if _installs == 0:
        return
    _installs -= 1
    if _installs > 0:
        return
    threading.Lock = _orig["Lock"]
    threading.RLock = _orig["RLock"]
    threading.Condition = _orig["Condition"]
    with _lock:
        for cls, fields_ in _instrumented.items():
            for fname in fields_:
                desc = cls.__dict__.get(fname)
                if isinstance(desc, _RaceField):
                    if desc._prev is not None:
                        setattr(cls, fname, desc._prev)
                    else:
                        delattr(cls, fname)
        _instrumented.clear()
        _fields.clear()


def installed() -> bool:
    return _installs > 0


def track(obj, fields_: tuple[str, ...], name: str = "") -> None:
    """Register one shared object's fields for lockset checking. No-op
    while disarmed — the registration hooks in the owning constructors
    stay free in production."""
    if _installs == 0:
        return
    cls = type(obj)
    label = name or f"{cls.__name__}#{id(obj) & 0xFFFF:04x}"
    with _lock:
        done = _instrumented.setdefault(cls, set())
        for fname in fields_:
            if fname not in done:
                prev = cls.__dict__.get(fname)
                # migrate any value assigned before instrumentation
                # into the instance dict the descriptor reads
                setattr(cls, fname, _RaceField(fname, prev))
                done.add(fname)
            _fields[(id(obj), fname)] = _FieldState(name=label)
        obj.__dict__[_MARKER] = label


def reports() -> list[RaceReport]:
    with _lock:
        return list(_reports)


def report() -> dict:
    """What this process's armed race witness saw: how many (object,
    field) pairs were registered, the classes they belong to, and how many
    races it reported. Empty when disarmed (a cluster node attaches it to
    its report, as it does the lock-order witness's)."""
    if _installs == 0:
        return {}
    with _lock:
        classes = sorted({
            st.name.split(":")[0].split("#")[0] for st in _fields.values()
        })
        return {"tracked": len(_fields), "classes": classes,
                "races": len(_reports)}


def clear() -> None:
    with _lock:
        _reports.clear()
        _fields.clear()


def assert_no_races() -> None:
    """The acceptance form: raise (rendering every report) if the armed
    run witnessed any unlocked conflicting pair."""
    reps = reports()
    if reps:
        raise AssertionError(
            f"{len(reps)} data race(s) witnessed:\n\n"
            + "\n\n".join(r.render() for r in reps)
        )


def maybe_install_from_env() -> bool:
    """Chaos-style opt-in: ``PS_RACE_WITNESS=1`` arms at package import
    (parallel/__init__), like the lock witness and the explorer."""
    if os.environ.get(ENV_VAR, "") not in ("", "0"):
        install()
        return True
    return False
