"""Spec: chain-replication failover, stated as checked transitions
BEFORE any production code exists (live replication of the apply stream
to a chain successor, failover that promotes the successor and
re-points clients mid-window). A copy of the JAX package's spec,
unchanged: the protocol is the same for either package.

The model is the protocol a replicated server must implement:

- a PRIMARY applies client pushes exactly as today (durable ledger,
  cid/seq dedup — the machinery the model reuses), and
  REPLICATES each applied (seq, delta) to its SUCCESSOR as an ordered
  apply stream;
- the ack to the client is emitted only once the successor acked the
  stream entry (chain discipline: an acked push is on every chain
  member), unless the ``ack-before-replicate`` bug says otherwise;
- the successor applies stream entries in order, dedup'd by the same
  (cid, seq) identity — replay-idempotence is what makes promotion
  safe;
- the primary may CRASH mid-window; the coordinator PROMOTES the
  successor (its replayed apply stream is the new authoritative
  state) and RE-POINTS the client, whose reconnect-resend machinery
  resends every unacked push to the new head — where the
  replicated ledger dedups anything that already rode the stream.

Invariant (every state): no node ever applies one push twice, and an
acked push is applied exactly once on the CURRENT head (acks never
outrun the chain). Liveness (quiescence): every push ends acked and
applied exactly once on the serving head — zero-loss failover.

Seeded bugs (``BUGS``):

    ack-before-replicate  the primary acks on local apply and
                          replicates asynchronously — a crash between
                          ack and stream delivery promotes a successor
                          that never saw the push: the ack outruns the
                          chain and the push is LOST (invariant names
                          the acked-but-unapplied seq at promotion)
    promote-no-dedup      the promoted successor forgets the stream's
                          (cid, seq) identities — the client's
                          re-pointed resend of an unacked-but-
                          replicated push applies TWICE on the new head
    replicate-unordered   the stream applies out of order — the
                          successor's state diverges from the order the
                          primary ledgered (flagged as a stream-order
                          violation; chain replication requires the
                          successor replay the head's serialization)

ASSUMPTIONS (diffed by analysis/conformance.py): the dedup identity
and the durable ledger this model leans on exist in the code exactly
as the exactly-once spec pins them (same derived table — the failover
model composes on those invariants, it does not restate them).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Hashable

from parameter_server_tpu_torch.analysis.model import Spec

BUGS = ("ack-before-replicate", "promote-no-dedup", "replicate-unordered")

#: failover composes on the exactly-once machinery; its conformance
#: table is the same ledger/dedup derivation (see exactly_once)
ASSUMPTIONS = {
    "ledger_record_under_apply_lock": True,
    "ledger_checked_before_apply": True,
}


@dataclass(frozen=True)
class _S:
    acked: tuple[bool, ...]
    p_applied: tuple[int, ...]  # primary apply count per seq
    s_applied: tuple[int, ...]  # successor apply count per seq
    p_ledger: tuple[bool, ...]
    s_ledger: tuple[bool, ...]  # successor's replicated dedup identity
    in_req: tuple[int, ...]  # client frames in flight to current head
    in_ack: tuple[int, ...]
    stream: tuple[int, ...]  # replication stream in flight (seqs, FIFO)
    stream_acked: tuple[bool, ...]  # successor acked this seq's entry
    sent: int
    promoted: bool  # successor is the head; primary is gone
    crashed: bool
    order_broke: bool  # stream applied out of order (bug variant)


class FailoverSpec(Spec):
    name = "failover"

    def __init__(
        self,
        pushes: int = 2,
        window: int = 2,
        bug: str | None = None,
    ):
        if bug is not None and bug not in BUGS:
            raise ValueError(f"unknown bug {bug!r}; known: {BUGS}")
        self.pushes = pushes
        self.window = window
        self.bug = bug

    def init_states(self) -> list[Hashable]:
        n = self.pushes
        z, f = (0,) * n, (False,) * n
        return [_S(f, z, z, f, f, z, z, (), f, 0, False, False, False)]

    def _t(self, t: tuple, i: int, v) -> tuple:
        return t[:i] + (v,) + t[i + 1:]

    def actions(self, s: _S) -> list[tuple[str, Hashable]]:
        out: list[tuple[str, Hashable]] = []
        n = self.pushes
        unacked = sum(1 for i in range(s.sent) if not s.acked[i])
        if s.sent < n and unacked < self.window:
            out.append((
                f"client: send push #{s.sent}",
                replace(s, in_req=self._t(s.in_req, s.sent, 1),
                        sent=s.sent + 1),
            ))
        for i in range(s.sent):
            if (
                not s.acked[i]
                and s.in_req[i] == 0
                and s.in_ack[i] == 0
                and i not in s.stream
            ):
                # reconnect-resend (to whichever node is the head now)
                out.append((
                    f"client: resend push #{i} to the head",
                    replace(s, in_req=self._t(s.in_req, i, 1)),
                ))
            if s.in_req[i] > 0:
                out.append((
                    f"net: drop push #{i}",
                    replace(s, in_req=self._t(s.in_req, i, 0)),
                ))
                # a frame only REACHES a live head: between the crash
                # and the promotion there is no head — frames to the
                # dead primary can only die (drop above), exactly what
                # a dead connection does to them
                if not s.crashed or s.promoted:
                    out.append((
                        f"head: recv push #{i}", self._serve(s, i),
                    ))
            if s.in_ack[i] > 0:
                out.append((
                    f"net: drop ack #{i}",
                    replace(s, in_ack=self._t(s.in_ack, i, 0)),
                ))
                out.append((
                    f"client: recv ack #{i}",
                    replace(s, in_ack=self._t(s.in_ack, i, 0),
                            acked=self._t(s.acked, i, True)),
                ))
        if s.stream and not s.promoted:
            # successor consumes the replication stream. In order —
            # unless the replicate-unordered bug lets a later entry
            # overtake the head of the stream.
            idxs = (
                range(len(s.stream))
                if self.bug == "replicate-unordered"
                else range(1)
            )
            for j in idxs:
                out.append((
                    f"successor: apply stream entry seq #{s.stream[j]}",
                    self._stream_apply(s, j),
                ))
        if not s.crashed and not s.promoted:
            # the crash wipes the primary AND every frame in flight to
            # it (connection death); the replication stream dies too —
            # only entries the successor already applied survive
            out.append((
                "chaos: primary crashes mid-window",
                replace(s, crashed=True, in_req=(0,) * n,
                        in_ack=(0,) * n, stream=()),
            ))
        if s.crashed and not s.promoted:
            ns = s
            if self.bug == "promote-no-dedup":
                ns = replace(ns, s_ledger=(False,) * n)
            # promotion also buries whatever replication stream the dead
            # primary still had in flight: entries the successor never
            # applied are gone (the crash transition wipes it too —
            # belt and braces so the new head can never consume a dead
            # node's stream)
            out.append((
                "coordinator: promote successor, re-point client",
                replace(ns, promoted=True, stream=()),
            ))
        return out

    def _serve(self, s: _S, i: int) -> _S:
        """The current head processes one frame of push i."""
        s = replace(s, in_req=self._t(s.in_req, i, 0))
        if not s.promoted:
            if s.p_ledger[i]:
                # dedup replay: ack only if the chain discipline is
                # satisfied for this seq (the stream entry was acked) —
                # otherwise the reply stays withheld like the original
                if s.stream_acked[i] or self.bug == "ack-before-replicate":
                    return replace(s, in_ack=self._t(s.in_ack, i, 1))
                return s
            s = replace(
                s,
                p_applied=self._t(s.p_applied, i, s.p_applied[i] + 1),
                p_ledger=self._t(s.p_ledger, i, True),
                stream=s.stream + (i,),
            )
            if self.bug == "ack-before-replicate":
                s = replace(s, in_ack=self._t(s.in_ack, i, 1))
            return s
        # promoted successor is the head: same protocol, its ledger
        if s.s_ledger[i]:
            return replace(s, in_ack=self._t(s.in_ack, i, 1))
        return replace(
            s,
            s_applied=self._t(s.s_applied, i, s.s_applied[i] + 1),
            s_ledger=self._t(s.s_ledger, i, True),
            in_ack=self._t(s.in_ack, i, 1),
        )

    def _stream_apply(self, s: _S, j: int) -> _S:
        i = s.stream[j]
        order_broke = s.order_broke or j != 0
        ns = replace(
            s, stream=s.stream[:j] + s.stream[j + 1:],
            order_broke=order_broke,
        )
        if ns.s_ledger[i]:
            return replace(
                ns, stream_acked=self._t(ns.stream_acked, i, True),
            )
        return replace(
            ns,
            s_applied=self._t(ns.s_applied, i, ns.s_applied[i] + 1),
            s_ledger=self._t(ns.s_ledger, i, True),
            stream_acked=self._t(ns.stream_acked, i, True),
        )

    # -- properties --------------------------------------------------------

    def invariant(self, s: _S) -> str | None:
        for i in range(self.pushes):
            if s.p_applied[i] > 1 or s.s_applied[i] > 1:
                node = "primary" if s.p_applied[i] > 1 else "successor"
                return (
                    f"push #{i} applied {max(s.p_applied[i], s.s_applied[i])} "
                    f"times on the {node} — replay dedup broken on the "
                    "chain (promotion forgot the stream's identities?)"
                )
            if s.promoted and s.acked[i] and s.s_applied[i] == 0:
                return (
                    f"push #{i} was acked but the promoted successor "
                    "never applied it — the ack outran the replication "
                    "stream and the push is lost (chain discipline: "
                    "ack only after the successor holds the entry)"
                )
        if s.order_broke:
            return (
                "the successor applied the replication stream out of "
                "order — its state diverges from the serialization the "
                "primary ledgered"
            )
        return None

    def liveness(self, s: _S) -> str | None:
        head_applied = s.s_applied if s.promoted else s.p_applied
        bad = [
            i for i in range(self.pushes)
            if not (s.acked[i] and head_applied[i] == 1)
        ]
        if bad:
            return (
                f"quiescent with push(es) {bad} not acked+applied on "
                "the serving head — failover lost or wedged them"
            )
        return None


def make(bug: str | None = None, **bounds) -> FailoverSpec:
    return FailoverSpec(bug=bug, **bounds)


def tier1() -> FailoverSpec:
    return FailoverSpec(pushes=2, window=2)
