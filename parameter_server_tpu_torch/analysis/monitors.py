"""Streaming protocol monitors: ONE detection automaton per invariant,
shared by the live audit plane and the postmortem plane.

A copy of the JAX package's ``analysis/monitors.py``. ``cli postmortem``
flags protocol violations in the wreckage after the fact; this module
holds the exactly-once / RCU / SSP invariants as **incremental automata**
over a stream of flight-recorder events, cheap enough to run while the
cluster serves. Two feeders, one truth:

- **online** — ``utils/auditor.py`` at the coordinator feeds each
  node's heartbeat-piggybacked event batches as they arrive, with a
  watermark clock (``at`` = arrival time) deciding when an unpaired
  fact becomes a violation;
- **offline** — ``utils/postmortem.py`` feeds the merged black-box
  timeline (``at`` = event time) and calls :meth:`StreamMonitor.finish`
  at end-of-stream, so the postmortem's anomaly detectors ARE these
  monitors and the two planes cannot drift.

Event form (the postmortem timeline's normal form, plus feeder fields):
``{"ts": float, "life": hashable, "etype": str, "args": dict,
"at": float}``. ``life`` identifies one process life — ``(proc, pid)``
offline, the coordinator node id online; per-life invariants (RCU
monotonicity, heal convergence) key on it.

Every monitor declares:

- ``EVENTS`` — the etypes it consumes (a literal frozenset: the pslint
  ``flightrec-contract`` checker reads these statically, so a monitor's
  events count as "known to the diagnostic plane" package-wide);
- ``BUGS`` — seeded violation drills (the psmc ``BUGS`` pattern): each
  is a zero-arg callable returning ``(monitor, events, expected_kind)``
  such that feeding the events MUST produce a violation of that kind.
  The tier-1 mutation-coverage contract test fails if a registered
  monitor has none — a monitor that never demonstrated it can catch
  its own bug class is assumed blind.

This module is a dependency LEAF (stdlib only): the production auditor
and postmortem import it without dragging in the analyzer machinery.
"""

from __future__ import annotations

from collections import OrderedDict, deque
from typing import Any, Callable

Violation = dict[str, Any]
Event = dict[str, Any]

#: end-of-stream sentinel for finish() (every watermark expires)
_END = float("inf")


def _ev(
    at: float, life: Any, etype: str, args: dict[str, Any]
) -> Event:
    """Build a normalized event (drills + feeders)."""
    return {"ts": at, "life": life, "etype": etype, "args": args, "at": at}


class StreamMonitor:
    """Base automaton: feed events, collect violations.

    ``feed`` consumes one normalized event (the feeder pre-filters on
    ``EVENTS``) and returns violations detectable immediately;
    ``flush(now)`` returns violations whose watermark expired (online
    cadence: the coordinator sweep); ``finish()`` is offline
    end-of-stream — everything still unpaired is judged."""

    name = "monitor"
    EVENTS: frozenset[str] = frozenset()
    BUGS: dict[str, Callable[[], tuple["StreamMonitor", list[Event], str]]] = {}

    def feed(self, ev: Event) -> list[Violation]:
        raise NotImplementedError

    def flush(self, now: float) -> list[Violation]:
        return []

    def finish(self) -> list[Violation]:
        return self.flush(_END)

    def _v(self, kind: str, **fields: Any) -> Violation:
        return {"kind": kind, "monitor": self.name, **fields}


def _pair_keys(args: dict[str, Any]) -> list[tuple[str, str]]:
    """Every (cid, seq) identity an apply event witnesses: the batch
    ``pairs`` list plus the serial path's direct cid/seq fields."""
    out: list[tuple[str, str]] = []
    for pair in args.get("pairs", ()):
        try:
            cid, seq = pair
        except (TypeError, ValueError):
            continue
        if cid is not None:
            out.append((str(cid), str(seq)))
    cid, seq = args.get("cid"), args.get("seq")
    if cid is not None and seq is not None:
        out.append((str(cid), str(seq)))
    return out


class AckAppliedMonitor(StreamMonitor):
    """ack => applied-exactly-once, within a watermark window.

    The wire's contract (psmc ``exactly_once`` spec, live): a client
    holding an ok push reply must have its (cid, seq) in some server's
    apply ledger (``apply.commit`` pairs / ``apply.replay`` dedup
    hits), and a (cid, seq) must never be COMMITTED twice. Pairing is
    order-free — ack-then-commit and commit-then-ack both resolve —
    and resolved identities are GC'd into a bounded recently-done LRU
    (so duplicate acks from wire chaos still match), which is what
    keeps the automaton's memory bounded on an infinite stream."""

    name = "ack-applied"
    EVENTS = frozenset({"rpc.reply", "apply.commit", "apply.replay"})

    #: resolved identities retained for duplicate-ack matching
    DONE_CAP = 8192

    def __init__(self, watermark_s: float = 15.0):
        self.watermark_s = float(watermark_s)
        self._applied: dict[tuple[str, str], float] = {}  # key -> at
        self._pending: dict[tuple[str, str], Event] = {}  # acked, unproven
        # resolved identities -> True if a COMMIT was witnessed, False
        # if resolved without one (flush-expired ack, GC'd): the
        # provenance decides whether a later commit is a double apply
        # or merely late
        self._done: OrderedDict[tuple[str, str], bool] = OrderedDict()

    def _resolve(self, key: tuple[str, str], committed: bool) -> None:
        self._done[key] = committed or self._done.get(key, False)
        self._done.move_to_end(key)
        while len(self._done) > self.DONE_CAP:
            self._done.popitem(last=False)

    def feed(self, ev: Event) -> list[Violation]:
        out: list[Violation] = []
        et = ev["etype"]
        if et in ("apply.commit", "apply.replay"):
            for key in _pair_keys(ev["args"]):
                committed_before = (
                    key in self._applied or self._done.get(key, False)
                )
                if et == "apply.commit" and committed_before:
                    # a replay is the dedup path doing its job; a SECOND
                    # commit of an already-committed identity — whether
                    # or not the ack pairing resolved it in between —
                    # is the exactly-once violation
                    out.append(self._v(
                        "double-applied", cid=key[0], seq=key[1],
                        life=ev["life"], ts=ev["ts"],
                    ))
                if key in self._pending:
                    del self._pending[key]
                    self._resolve(key, committed=True)
                elif committed_before or key in self._done:
                    self._resolve(key, committed=True)
                    self._applied.pop(key, None)
                else:
                    self._applied[key] = ev["at"]
        elif et == "rpc.reply":
            a = ev["args"]
            if a.get("cmd") != "push" or not a.get("ok", True):
                return out
            cid, seq = a.get("cid"), a.get("seq")
            if cid is None or seq is None:
                return out
            key = (str(cid), str(seq))
            if key in self._applied:
                del self._applied[key]
                self._resolve(key, committed=True)
            elif key not in self._done:
                self._pending[key] = ev
        return out

    def flush(self, now: float) -> list[Violation]:
        out: list[Violation] = []
        for key in [
            k for k, e in self._pending.items()
            if now - e["at"] > self.watermark_s
        ]:
            e = self._pending.pop(key)
            out.append(self._v(
                "acked-but-unapplied", cid=key[0], seq=key[1],
                ack_ts=e["ts"], life=e["life"],
            ))
            # judged once; a LATE commit won't re-flag the ack — but
            # committed=False keeps the provenance honest, so it won't
            # read as a double apply either
            self._resolve(key, committed=False)
        # commits whose acks never came (client died / ack spool hole):
        # GC after a generous multiple of the pairing window
        horizon = 4 * self.watermark_s
        for key in [
            k for k, at in self._applied.items() if now - at > horizon
        ]:
            del self._applied[key]
            self._resolve(key, committed=True)
        return out


def _bug_ack_without_apply():
    m = AckAppliedMonitor(watermark_s=5.0)
    evs = [_ev(0.0, "worker-0", "rpc.reply",
               {"cmd": "push", "cid": "c1", "seq": "k0", "ok": True})]
    return m, evs, "acked-but-unapplied"


def _bug_double_apply():
    m = AckAppliedMonitor(watermark_s=5.0)
    evs = [
        _ev(0.0, "server-0", "apply.commit",
            {"ver": 2, "pairs": [["c1", "k0"]]}),
        _ev(0.1, "server-0", "apply.commit",
            {"ver": 3, "pairs": [["c1", "k0"]]}),
    ]
    return m, evs, "double-applied"


def _bug_double_apply_after_ack():
    # the COMMON live ordering: the identity is already ack-resolved
    # when the second commit lands — provenance in the done-LRU must
    # still convict it
    m = AckAppliedMonitor(watermark_s=5.0)
    evs = [
        _ev(0.0, "server-0", "apply.commit",
            {"ver": 2, "pairs": [["c1", "k0"]]}),
        _ev(0.1, "worker-0", "rpc.reply",
            {"cmd": "push", "cid": "c1", "seq": "k0", "ok": True}),
        _ev(0.2, "server-0", "apply.commit",
            {"ver": 3, "pairs": [["c1", "k0"]]}),
    ]
    return m, evs, "double-applied"


AckAppliedMonitor.BUGS = {
    "ack-without-apply": _bug_ack_without_apply,
    "double-apply": _bug_double_apply,
    "double-apply-after-ack": _bug_double_apply_after_ack,
}


class RcuMonitor(StreamMonitor):
    """Per-life RCU snapshot-version monotonicity.

    Every ``rcu.publish`` bumps an opaque version whose high 40+ bits
    are a per-server-life nonce (ShardServer's 23-nonce/40-counter
    layout); within one (life, nonce) stream the version is strictly
    increasing — a decrease is a rollback or a torn publish, the
    failure class the psmc ``rcu`` spec models. Keying on the nonce as
    well as the life means two server instances sharing one process
    (or one node id) can never false-positive against each other."""

    name = "rcu-version"
    EVENTS = frozenset({"rcu.publish"})

    #: the version layout's counter width (multislice.ShardServer)
    NONCE_SHIFT = 40

    def __init__(self) -> None:
        self._last: dict[tuple[Any, int], int] = {}

    def feed(self, ev: Event) -> list[Violation]:
        ver = ev["args"].get("ver")
        if ver is None:
            return []
        v = int(ver)
        key = (ev["life"], v >> self.NONCE_SHIFT)
        prev = self._last.get(key)
        self._last[key] = v
        if prev is not None and v < prev:
            return [self._v(
                "version-regression", life=ev["life"],
                **{"from": prev, "to": v}, ts=ev["ts"],
            )]
        return []


def _bug_rcu_rollback():
    m = RcuMonitor()
    evs = [
        _ev(0.0, "server-0", "rcu.publish", {"ver": 101}),
        _ev(0.1, "server-0", "rcu.publish", {"ver": 99}),
    ]
    return m, evs, "version-regression"


RcuMonitor.BUGS = {"rcu-rollback": _bug_rcu_rollback}


class SspMonitor(StreamMonitor):
    """SSP bounded-staleness: a granted gate pass must respect tau.

    Mirrors SSPClock's gate (``wait(w, step)`` grants only when every
    non-retired worker has finished ``step - max_delay - 1``): replays
    ``ssp.finish`` / ``ssp.retire`` into a per-worker finished table
    and checks every GRANTED ``ssp.wait`` against it. A grant that
    outruns the bound is parked as a suspect first — the clock records
    its events outside its lock, so the enabling finish can land in
    the stream a moment late — and becomes a violation only when no
    justifying finish arrives within the grace window. Without a known
    ``max_delay`` (offline dumps don't carry it) the monitor is
    dormant; the coordinator learns the bound from ``ssp_init``."""

    name = "ssp-staleness"
    EVENTS = frozenset({"ssp.wait", "ssp.finish", "ssp.retire"})

    RETIRED = 1 << 60

    def __init__(
        self,
        max_delay: int | None = None,
        num_workers: int | None = None,
        grace_s: float = 5.0,
    ):
        self.max_delay = max_delay
        self.grace_s = float(grace_s)
        self._finished: dict[int, int] = {}
        if num_workers:
            self._finished = {w: -1 for w in range(int(num_workers))}
        self._suspects: list[dict[str, Any]] = []

    def set_bounds(self, max_delay: int, num_workers: int) -> None:
        self.max_delay = int(max_delay)
        for w in range(int(num_workers)):
            self._finished.setdefault(w, -1)

    def _min_finished(self) -> int:
        return min(self._finished.values()) if self._finished else -1

    def _recheck(self) -> None:
        mf = self._min_finished()
        self._suspects = [s for s in self._suspects if s["target"] > mf]

    def feed(self, ev: Event) -> list[Violation]:
        a = ev["args"]
        et = ev["etype"]
        if et == "ssp.finish":
            w, s = int(a["worker"]), int(a["step"])
            if s > self._finished.get(w, -1):
                self._finished[w] = s
                self._recheck()
        elif et == "ssp.retire":
            self._finished[int(a["worker"])] = self.RETIRED
            self._recheck()
        elif et == "ssp.wait":
            if self.max_delay is None or self.max_delay < 0:
                return []
            if not a.get("granted", True):
                return []
            w, step = int(a["worker"]), int(a["step"])
            self._finished.setdefault(w, -1)
            target = step - self.max_delay - 1
            if self._min_finished() < target:
                self._suspects.append({
                    "worker": w, "step": step, "target": target,
                    "at": ev["at"], "ts": ev["ts"], "life": ev["life"],
                })
        return []

    def flush(self, now: float) -> list[Violation]:
        out: list[Violation] = []
        keep: list[dict[str, Any]] = []
        mf = self._min_finished()
        for s in self._suspects:
            if s["target"] <= mf:
                continue  # justified since parking
            if now - s["at"] > self.grace_s:
                out.append(self._v(
                    "ssp-staleness", worker=s["worker"], step=s["step"],
                    min_finished=mf, max_delay=self.max_delay,
                    life=s["life"], ts=s["ts"],
                ))
            else:
                keep.append(s)
        self._suspects = keep
        return out


def _bug_ssp_overrun():
    m = SspMonitor(max_delay=1, num_workers=2, grace_s=1.0)
    evs = [
        _ev(0.0, "coord", "ssp.finish", {"worker": 0, "step": 9}),
        # worker 1 never finished anything, yet worker 0's step-9 grant
        # needs min_finished >= 7 — the clock should have parked it
        _ev(0.1, "coord", "ssp.wait",
            {"worker": 0, "step": 9, "granted": True}),
    ]
    return m, evs, "ssp-staleness"


SspMonitor.BUGS = {"staleness-overrun": _bug_ssp_overrun}


class HealMonitor(StreamMonitor):
    """Reconnect-without-heal, per life.

    A ``rpc.heal.begin`` that neither lands (``rpc.healed``) nor is
    outnumbered by later heals within the timeout means a peer died
    (or a partition held) and the client's window is parked — the
    postmortem's reconnect-without-heal flag, evaluated live. One
    violation per un-healed episode: the flag re-arms only after heals
    catch back up with begins."""

    name = "heal-convergence"
    EVENTS = frozenset({"rpc.heal.begin", "rpc.healed", "rpc.heal.failed"})

    def __init__(self, heal_timeout_s: float = 30.0):
        self.heal_timeout_s = float(heal_timeout_s)
        self._lives: dict[Any, dict[str, Any]] = {}

    def _life(self, life: Any) -> dict[str, Any]:
        st = self._lives.get(life)
        if st is None:
            st = self._lives[life] = {
                "begun": 0, "healed": 0, "failed": 0,
                "pending": deque(), "reported": False,
            }
        return st

    def feed(self, ev: Event) -> list[Violation]:
        st = self._life(ev["life"])
        et = ev["etype"]
        if et == "rpc.heal.begin":
            st["begun"] += 1
            st["pending"].append(ev["at"])
        elif et == "rpc.healed":
            st["healed"] += 1
            if st["pending"]:
                st["pending"].popleft()
            if not st["pending"]:
                st["reported"] = False  # converged: re-arm the episode
        elif et == "rpc.heal.failed":
            st["failed"] += 1
        return []

    def flush(self, now: float) -> list[Violation]:
        out: list[Violation] = []
        for life, st in self._lives.items():
            if st["reported"] or not st["pending"]:
                continue
            if now - st["pending"][0] > self.heal_timeout_s:
                st["reported"] = True
                out.append(self._v(
                    "reconnect-without-heal", life=life,
                    begun=st["begun"], healed=st["healed"],
                    failed=st["failed"],
                ))
        return out


def _bug_unhealed_reconnect():
    m = HealMonitor(heal_timeout_s=1.0)
    evs = [
        _ev(0.0, "worker-0", "rpc.heal.begin", {"addr": "a", "cid": "c1"}),
        _ev(0.5, "worker-0", "rpc.heal.failed", {"addr": "a", "cid": "c1"}),
    ]
    return m, evs, "reconnect-without-heal"


HealMonitor.BUGS = {"unhealed-reconnect": _bug_unhealed_reconnect}


class ShedStormMonitor(StreamMonitor):
    """Shed storms: admission control firing in bursts.

    ``serve.shed`` is healthy back-pressure one at a time and an
    overload incident in bursts — >= ``n`` sheds inside ``window_s``
    (event time, cluster-wide) fires once per storm; a quiet gap
    longer than the window re-arms it. The window is ORDER-TOLERANT:
    the live feeder delivers per-node streams in arrival order, so
    beat skew can interleave one node's older event timestamps after
    another's newer ones — entries are kept sorted (bisect) and the
    verdict is "some window_s span held >= n sheds", whatever order
    the evidence arrived in."""

    name = "shed-storm"
    EVENTS = frozenset({"serve.shed"})

    def __init__(self, n: int = 10, window_s: float = 1.0):
        self.n = max(int(n), 1)
        self.window_s = float(window_s)
        self._ts: list[float] = []  # sorted event times
        self._in_storm = False

    def feed(self, ev: Event) -> list[Violation]:
        import bisect

        ts = ev["ts"]
        newest = self._ts[-1] if self._ts else None
        if newest is not None and ts - newest > self.window_s:
            # a quiet gap longer than the window: the storm (if any)
            # ended — re-arm
            self._ts.clear()
            self._in_storm = False
        bisect.insort(self._ts, ts)
        newest = self._ts[-1]
        # trim everything that can no longer participate in ANY window
        # reaching the newest evidence
        lo = bisect.bisect_left(self._ts, newest - self.window_s)
        del self._ts[:lo]
        if len(self._ts) >= self.n and not self._in_storm:
            self._in_storm = True
            return [self._v(
                "shed-storm", count=len(self._ts),
                window_s=self.window_s, ts=self._ts[0],
                life=ev["life"],  # the shed that tipped the window
            )]
        return []


def _bug_shed_storm():
    m = ShedStormMonitor(n=10, window_s=1.0)
    evs = [
        _ev(1.0 + i * 0.01, "server-0", "serve.shed", {"sig": "s"})
        for i in range(12)
    ]
    return m, evs, "shed-storm"


ShedStormMonitor.BUGS = {"shed-storm": _bug_shed_storm}


# -- registry ---------------------------------------------------------------

#: every registered streaming monitor — the auditor instantiates all of
#: them, the postmortem feeds them offline, the mutation-coverage
#: contract test requires each to carry >= 1 seeded BUGS drill, and the
#: pslint flightrec-contract checker reads their EVENTS sets statically
MONITORS: dict[str, type[StreamMonitor]] = {
    AckAppliedMonitor.name: AckAppliedMonitor,
    RcuMonitor.name: RcuMonitor,
    SspMonitor.name: SspMonitor,
    HealMonitor.name: HealMonitor,
    ShedStormMonitor.name: ShedStormMonitor,
}


def monitor_events() -> frozenset[str]:
    """Union of every registered monitor's consumed etypes."""
    out: set[str] = set()
    for cls in MONITORS.values():
        out |= cls.EVENTS
    return frozenset(out)


def make_monitors(
    watermark_s: float = 15.0,
    heal_timeout_s: float = 30.0,
    shed_storm_n: int = 10,
    shed_storm_window_s: float = 1.0,
    ssp_max_delay: int | None = None,
    ssp_num_workers: int | None = None,
) -> list[StreamMonitor]:
    """One live instance of every registered monitor, bounds applied."""
    return [
        AckAppliedMonitor(watermark_s=watermark_s),
        RcuMonitor(),
        SspMonitor(max_delay=ssp_max_delay, num_workers=ssp_num_workers),
        HealMonitor(heal_timeout_s=heal_timeout_s),
        ShedStormMonitor(n=shed_storm_n, window_s=shed_storm_window_s),
    ]


def run_bug(
    cls: type[StreamMonitor], bug: str
) -> tuple[list[Violation], str]:
    """Run one seeded drill: returns (violations, expected_kind). The
    mutation-coverage contract asserts a violation of the expected kind
    is among them — a drill a monitor cannot catch fails the build."""
    monitor, events, expected = cls.BUGS[bug]()
    out: list[Violation] = []
    for ev in events:
        if ev["etype"] in cls.EVENTS:
            out += monitor.feed(ev)
    out += monitor.finish()
    return out, expected
