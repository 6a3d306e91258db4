"""Spec: exactly-once pushes over a lossy, duplicating wire with server
crash/restart — the composition of seq-numbered reconnect-resend,
the per-client reply cache and the durable applied-push ledger, as an
executable model. A copy of the JAX package's spec: the port's wire and
ledger are the JAX ones, so the model (states, transitions, seeded bugs)
is unchanged; conformance derives its facts from the port's
``ShardServer``, whose publish is the ``_apply`` call in
``_apply_batch``, not a store to a snapshot.

One client pipelines ``pushes`` logical pushes through a window of
``window`` unacked calls. The network may drop or duplicate any
in-flight frame (``dups`` duplication budget per push — bounded message
counts). The server applies a push, records it in the DURABLE ledger
and the VOLATILE reply cache, and emits an ack; ``crashes`` restarts
wipe the reply cache and every in-flight frame (the connection dies
with the process) but not the ledger. The client resends any unacked
push forever (reconnect-resend), so the same logical push can reach the
server arbitrarily many times — dedup is the server's job.

Invariant (checked at every state): an acked push has been applied
EXACTLY once, and no push is ever applied twice. Liveness (at
quiescence, under fairness): every push ends acked and applied.

Seeded bugs the checker must catch (``BUGS``):

    volatile-dedup   dedup consults only the reply cache — a crash
                     between apply and ack forgets the apply, and the
                     client's resend applies it again
    no-dedup         dedup dropped entirely — a duplicated frame
                     applies twice even without a crash
    ack-early        the ack is emitted BEFORE the ledger record — a
                     crash in between acks a push the restarted server
                     will re-apply on resend... and the reply-cache
                     model can't save it (minimal trace shows why)

ASSUMPTIONS (diffed against the code by analysis/conformance.py):
the push-serving server exempts exactly {pull, dump, stats} from the
reply cache (push replies must ride it), owns a durable ledger whose
record call always runs under the apply lock, and consults that ledger
before applying (``_applied_push`` read reaches every apply path).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Hashable

from parameter_server_tpu_torch.analysis.model import Spec

BUGS = ("volatile-dedup", "no-dedup", "ack-early")

#: the facts about parallel/multislice.py this model encodes;
#: analysis/conformance.py derives the code-side table and diffs
ASSUMPTIONS = {
    "idempotent_cmds": frozenset({"pull", "dump", "stats"}),
    "push_rides_reply_cache": True,
    "ledger_record_under_apply_lock": True,
    "ledger_checked_before_apply": True,
}


@dataclass(frozen=True)
class _S:
    """One global state. Per-push tuples are indexed by seq."""

    acked: tuple[bool, ...]
    applied: tuple[int, ...]  # apply count per seq (the invariant's fact)
    ledger: tuple[bool, ...]  # durable: survives restart
    rcache: tuple[bool, ...]  # volatile: dies with the process
    in_push: tuple[int, ...]  # in-flight request frames per seq
    in_ack: tuple[int, ...]  # in-flight ack frames per seq
    sent: int  # pushes issued so far (window head)
    crashes: int  # restart budget left
    dups: tuple[int, ...]  # duplication budget left per seq

    def bump(self, f: str, i: int, d: int = 1) -> "_S":
        t = getattr(self, f)
        return replace(self, **{f: t[:i] + (t[i] + d,) + t[i + 1:]})

    def set(self, f: str, i: int, v) -> "_S":
        t = getattr(self, f)
        return replace(self, **{f: t[:i] + (v,) + t[i + 1:]})


class ExactlyOnce(Spec):
    name = "exactly-once"

    def __init__(
        self,
        pushes: int = 3,
        window: int = 2,
        crashes: int = 1,
        dups: int = 1,
        bug: str | None = None,
    ):
        if bug is not None and bug not in BUGS:
            raise ValueError(f"unknown bug {bug!r}; known: {BUGS}")
        self.pushes = pushes
        self.window = window
        self.crashes = crashes
        self.dups = dups
        self.bug = bug

    def init_states(self) -> list[Hashable]:
        n = self.pushes
        z = (0,) * n
        f = (False,) * n
        return [_S(f, z, f, f, z, z, 0, self.crashes, (self.dups,) * n)]

    # -- transitions -------------------------------------------------------

    def actions(self, s: _S) -> list[tuple[str, Hashable]]:
        out: list[tuple[str, Hashable]] = []
        n = self.pushes
        # client: issue the next push while the unacked window has room
        unacked = sum(
            1 for i in range(s.sent) if not s.acked[i]
        )
        if s.sent < n and unacked < self.window:
            out.append((
                f"client: send push #{s.sent}",
                replace(s.bump("in_push", s.sent), sent=s.sent + 1),
            ))
        for i in range(s.sent):
            # client: resend an unacked push with nothing of it in
            # flight either way (reconnect-resend after a timeout long
            # enough that an in-flight ack would have landed or died —
            # the abstraction that keeps the frame multiset bounded)
            if not s.acked[i] and s.in_push[i] == 0 and s.in_ack[i] == 0:
                out.append((
                    f"client: resend push #{i}", s.bump("in_push", i),
                ))
            if s.in_push[i] > 0:
                # network: duplicate (bounded) or drop a request frame
                if s.dups[i] > 0:
                    out.append((
                        f"net: duplicate push #{i}",
                        s.bump("in_push", i).bump("dups", i, -1),
                    ))
                out.append((
                    f"net: drop push #{i}", s.bump("in_push", i, -1),
                ))
                # server: receive one frame
                out.append((
                    f"server: recv push #{i}", self._serve(s, i),
                ))
            if s.in_ack[i] > 0:
                out.append((
                    f"net: drop ack #{i}", s.bump("in_ack", i, -1),
                ))
                out.append((
                    f"client: recv ack #{i}",
                    s.bump("in_ack", i, -1).set("acked", i, True),
                ))
        for i in range(s.sent):
            # ack-early residue: a push acked + reply-cached but not yet
            # ledgered (only the ack-early bug creates this state — the
            # correct protocol records the ledger in the same atomic
            # apply step). The commit can still land... unless the
            # crash beats it, which is the whole bug.
            if s.rcache[i] and not s.ledger[i]:
                out.append((
                    f"server: ledger-commit push #{i} (late)",
                    s.set("ledger", i, True),
                ))
        if s.crashes > 0:
            # server restart: reply cache and every in-flight frame die
            # with the process; the ledger is durable
            out.append((
                "server: crash + restart",
                replace(
                    s,
                    rcache=(False,) * n,
                    in_push=(0,) * n,
                    in_ack=(0,) * n,
                    crashes=s.crashes - 1,
                ),
            ))
        return out

    def _serve(self, s: _S, i: int) -> _S:
        """Server processes one frame of push i: dedup, apply, ledger,
        reply-cache, ack — with the configured bug knob applied."""
        s = s.bump("in_push", i, -1)
        if self.bug == "no-dedup":
            seen = False
        elif self.bug == "volatile-dedup":
            seen = s.rcache[i]
        elif self.bug == "ack-early":
            # dedup machinery intact (ledger AND reply cache consulted)
            # — the bug is purely the ack/ledger ORDER, so plain
            # duplicates are still deduped and only the crash window
            # between ack and ledger-commit exposes it
            seen = s.ledger[i] or s.rcache[i]
        else:
            seen = s.ledger[i]  # the durable dedup (correct protocol)
        if seen:
            # replay: answer from the dedup machinery without re-applying
            return s.bump("in_ack", i)
        if self.bug == "ack-early":
            # ack + apply + reply-cache now; the DURABLE ledger record
            # is a separate later transition (the 'ledger-commit (late)'
            # action) — a crash in between forgets the apply and the
            # client's resend applies it again
            s = s.bump("in_ack", i)
            s = s.bump("applied", i)
            return s.set("rcache", i, True)
        s = s.bump("applied", i)
        s = s.set("ledger", i, True).set("rcache", i, True)
        return s.bump("in_ack", i)

    # -- properties --------------------------------------------------------

    def invariant(self, s: _S) -> str | None:
        for i in range(self.pushes):
            if s.applied[i] > 1:
                return (
                    f"push #{i} applied {s.applied[i]} times — "
                    "exactly-once broken (duplicate delivery or a "
                    "restart forgot the apply)"
                )
            if s.acked[i] and s.applied[i] != 1:
                return (
                    f"push #{i} acked but applied {s.applied[i]} "
                    "times — 'acked => applied exactly once' broken"
                )
        return None

    def liveness(self, s: _S) -> str | None:
        bad = [
            i
            for i in range(self.pushes)
            if not (s.acked[i] and s.applied[i] == 1)
        ]
        if bad:
            return (
                f"quiescent with push(es) {bad} not acked+applied — "
                "the resend/dedup loop cannot finish the window"
            )
        return None


def make(bug: str | None = None, **bounds) -> ExactlyOnce:
    return ExactlyOnce(bug=bug, **bounds)


def tier1() -> ExactlyOnce:
    """The CI-bounded instance: small enough to exhaust in well under a
    second, big enough that every protocol ingredient (window, resend,
    duplicate, crash) is exercised."""
    return ExactlyOnce(pushes=3, window=2, crashes=1, dups=1)
