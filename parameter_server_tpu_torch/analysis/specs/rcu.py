"""Spec: the port's in-place publish/read protocol of ``ShardServer``.

The JAX server publishes by swapping one immutable ``(state, version)``
tuple; the port has no such tuple. Its tables (``self.state``) change in
place under the publish lock ``_pub_lock``: an apply (``_apply``) runs
the kernel on the rows and calls ``_publish()``, which bumps
``self._version``, in the same hold; a pull (``_gather_weights``) issues
its gather and reads the version in one hold; a restore
(``load_state``) replaces the tables, draws a fresh per-life nonce for
the version and publishes, under the apply lock and the publish lock.

The model's ground truth for "which rows" is the identity ``(life,
applies)`` of the table's content: a restore brings back the
checkpointed table's identity, and each apply after it makes a new one
(re-sent pushes coalesce into other batches than before the crash, so
the rows differ from the pre-crash table at the same apply count). A
reader may capture rows with a version, cache them, and later
revalidate: version equality serves the CACHED rows (the serving
plane's ``not_modified`` path).

Invariants (the JAX spec's): (a) every publish strictly increases the
version within its life; (b) a version-equality revalidation serves
rows identical to the server's current table.

Seeded bugs (``BUGS``):

    torn-publish   the rows are written in one hold and the version
                   bumped in another — between them a revalidation of
                   the old version matches and serves rows the table
                   no longer holds
    split-read     the pull gathers its rows in one hold and reads the
                   version in another — an apply between them pairs
                   the OLD rows with the NEW version, and a later
                   revalidation of that version serves them
    no-nonce       a restore restarts the version counter without a
                   fresh nonce — a version cached before the crash
                   names rows the restored life re-applied differently
    no-bump        an apply skips the bump — two different tables
                   share a version (monotonicity)

ASSUMPTIONS (diffed by analysis/conformance.py against the in-place
publisher it derives from the code): the setter is ``_publish``, every
call of it holds ``_pub_lock`` and it bumps ``_version`` by one; the
only methods that store ``_version`` outside ``__init__`` are the
setter and ``load_state``, which stores a fresh draw (the nonce); every
in-place write of the tables calls the setter in its hold; and every
gather that reads the version reads it in the gather's hold.
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Hashable

from parameter_server_tpu_torch.analysis.model import Spec

BUGS = ("torn-publish", "split-read", "no-nonce", "no-bump")

ASSUMPTIONS = {
    "inplace_setter": "_publish",
    "inplace_publish_lock": "_pub_lock",
    "setter_calls_hold_publish_lock": True,
    "setter_bumps_version": True,
    "version_store_sites": frozenset({"_publish", "load_state"}),
    "restore_takes_fresh_nonce": True,
    "writes_publish_in_same_hold": True,
    "pull_reads_version_in_gather_hold": True,
}

#: the JAX package's design, a tuple swap: ``self._pub`` is stored only by
#: the ``state`` property setter, which derives the new version from
#: ``_pub[1] + 1``. The model stands for it too (its swap is a publish in
#: one hold, its one-load capture a read in one hold); conformance judges
#: these keys only in a tree that has such a publisher (the JAX package's),
#: as the JAX analyzer does, and ASSUMPTIONS' in a tree with an in-place
#: one (the port's)
TUPLE_SWAP_ASSUMPTIONS = {
    "publish_sites": frozenset({"state"}),
    "publish_bumps_version": True,
}

Rows = tuple[int, int]  # (life, applies): the content identity
Ver = tuple[int, int]  # (nonce, counter); nonce 0 under no-nonce


@dataclass(frozen=True)
class _S:
    life: int
    counter: int  # per-life publish counter (the version's low bits)
    applies: int  # applies folded into the table's content
    rows: Rows  # the table's content, changed in place
    ver: Ver  # the version stamp
    torn: bool  # torn-publish: rows written, the bump still to come
    applies_left: int
    restarts_left: int
    reads_left: int  # bounded captures: quiescence must be reachable
    ckpt: Rows | None  # the checkpointed table (the version is not saved)
    gather: Rows | None  # split-read: rows gathered, version not yet read
    cache: tuple[Ver, Rows] | None  # reader's cached (version, rows)
    stale_served: bool  # a matching revalidation served foreign rows
    nonmono: bool  # a publish failed to increase within its life


class RcuSpec(Spec):
    name = "rcu"

    def __init__(
        self,
        applies: int = 3,
        restarts: int = 1,
        reads: int = 3,
        bug: str | None = None,
    ):
        if bug is not None and bug not in BUGS:
            raise ValueError(f"unknown bug {bug!r}; known: {BUGS}")
        self.applies = applies
        self.restarts = restarts
        # reader capture budget: without one a reader action is enabled
        # in EVERY state, no quiescent state ever exists, and the
        # liveness hook is vacuously unreachable
        self.reads = reads
        self.bug = bug

    def _ver(self, life: int, counter: int) -> Ver:
        # the per-life nonce: real versions put a fresh random 23-bit
        # nonce above a 40-bit counter; the model uses the life id
        # itself. The no-nonce bug drops the namespace.
        return (0, counter) if self.bug == "no-nonce" else (life, counter)

    def init_states(self) -> list[Hashable]:
        return [_S(
            life=1, counter=1, applies=0, rows=(1, 0), ver=self._ver(1, 1),
            torn=False, applies_left=self.applies,
            restarts_left=self.restarts, reads_left=self.reads, ckpt=None,
            gather=None, cache=None, stale_served=False, nonmono=False,
        )]

    def actions(self, s: _S) -> list[tuple[str, Hashable]]:
        out: list[tuple[str, Hashable]] = []
        if s.torn:
            out.append((
                "writer: _publish() in a second hold (bump the version)",
                replace(s, torn=False, counter=s.counter + 1,
                        ver=self._ver(s.life, s.counter + 1)),
            ))
        elif s.applies_left > 0:
            na = s.applies + 1
            base = replace(
                s, applies_left=s.applies_left - 1, applies=na,
                rows=(s.life, na),
            )
            if self.bug == "torn-publish":
                out.append((
                    "writer: apply in place under _pub_lock, release "
                    "(version not bumped yet)",
                    replace(base, torn=True),
                ))
            else:
                nc = s.counter if self.bug == "no-bump" else s.counter + 1
                out.append((
                    "writer: apply in place + _publish() in one "
                    "_pub_lock hold",
                    replace(base, counter=nc, ver=self._ver(s.life, nc),
                            nonmono=s.nonmono or nc <= s.counter),
                ))
        if s.ckpt is None and not s.torn and s.restarts_left > 0:
            out.append((
                "server: checkpoint (the tables + ledger, not the "
                "version)",
                replace(s, ckpt=s.rows),
            ))
        if s.gather is not None:
            out.append((
                "reader: read the version in a second hold + cache",
                replace(s, gather=None, cache=(s.ver, s.gather)),
            ))
        elif s.cache is None:
            if s.reads_left > 0:
                if self.bug == "split-read":
                    out.append((
                        "reader: gather rows under _pub_lock, release",
                        replace(s, gather=s.rows,
                                reads_left=s.reads_left - 1),
                    ))
                else:
                    out.append((
                        "reader: gather rows + read the version in one "
                        "_pub_lock hold + cache",
                        replace(s, cache=(s.ver, s.rows),
                                reads_left=s.reads_left - 1),
                    ))
        else:
            ver, rows = s.cache
            if ver == s.ver:
                out.append((
                    "reader: revalidate if_newer -> not_modified "
                    "(serve cached rows)",
                    replace(s, cache=None,
                            stale_served=s.stale_served or rows != s.rows),
                ))
            else:
                out.append((
                    "reader: revalidate if_newer -> version moved, "
                    "refresh rows",
                    replace(s, cache=None),
                ))
        if (
            s.restarts_left > 0 and s.ckpt is not None and not s.torn
            and s.gather is None
        ):
            nl = s.life + 1
            ck_applies = s.ckpt[1]
            # load_state: the checkpointed tables, a fresh nonce, one
            # publish (counter 1 of the new life)
            out.append((
                "server: crash + load_state from checkpoint (tail applies "
                "rolled back; clients will resend them)",
                replace(
                    s, life=nl, counter=1, applies=ck_applies, rows=s.ckpt,
                    ver=self._ver(nl, 1),
                    restarts_left=s.restarts_left - 1, ckpt=None,
                    applies_left=s.applies_left + s.applies - ck_applies,
                ),
            ))
        return out

    def invariant(self, s: _S) -> str | None:
        if s.stale_served:
            return (
                "a version-equality revalidation served rows that are "
                "not the current table — a cached version falsely "
                "validated (rows and version moved in different holds, "
                "or a restore re-used a version without a life nonce)"
            )
        if s.nonmono:
            return (
                "a publish did not increase the version within its "
                "life — two different tables share a version"
            )
        return None

    def liveness(self, s: _S) -> str | None:
        if s.applies_left > 0 or s.torn:
            return "writer wedged with applies outstanding"
        return None


def make(bug: str | None = None, **bounds) -> RcuSpec:
    return RcuSpec(bug=bug, **bounds)


def tier1() -> RcuSpec:
    return RcuSpec(applies=3, restarts=1, reads=3)
