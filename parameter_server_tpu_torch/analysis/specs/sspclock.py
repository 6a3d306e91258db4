"""Spec: the SSP clock's bounded-staleness contract under worker
death, coordinator retirement and workload reassignment
(``parallel/ssp.py`` + the coordinator's recovery sweep). A copy of
the JAX package's spec: the port's ``SSPClock`` is the JAX one.

``workers`` logical workers each run ``steps`` steps. A worker may
issue step t only when ``min(finished)`` over every clock entry is at
least ``t - max_delay - 1`` (``SSPClock.wait``'s gate: with tau=0 a
worker is at most one step ahead of the slowest). Finishing advances
its entry. A worker may die mid-run (``deaths`` budget); the
coordinator's sweep RETIRES the dead worker's clock entry by finishing
it at the RETIRED sentinel (so it stops binding the min) and REASSIGNS
its remaining steps to the laggiest live worker (the workload-pool
half of the sweep).

Invariant (every state): no issued step ever ran more than
``max_delay + 1`` ahead of the slowest clock entry at issue time — the
paper's bounded-delay consistency, stated on the model. Liveness
(quiescent states): every live worker finishes its (original plus
reassigned) steps and every dead worker is swept — the gate can never
wedge live workers forever.

Seeded bugs (``BUGS``):

    no-retire       the sweep reassigns work but never retires the dead
                    worker's clock entry — the frozen entry stays in
                    the min and every live worker parks on the gate
                    within max_delay+1 steps: a quiescent state with
                    work outstanding (the deadlock retire prevents)
    retire-as-zero  retirement writes 0 instead of the RETIRED
                    sentinel — the entry re-enters the min at zero and
                    pins it there; everyone wedges at step max_delay+1
    gate-own-clock  the gate consults the worker's OWN entry instead of
                    the cluster min — it never blocks, and the
                    staleness invariant fires as soon as it outruns the
                    slowest worker by more than the bound

ASSUMPTIONS (diffed by analysis/conformance.py): ``SSPClock.retire``
delegates to ``finish`` with the RETIRED sentinel (retirement rides the
same notify path as progress), and ``wait`` recomputes the min inside
its gate predicate (no cached min).
"""

from __future__ import annotations

from dataclasses import dataclass, replace
from typing import Hashable

from parameter_server_tpu_torch.analysis.model import Spec

BUGS = ("no-retire", "retire-as-zero", "gate-own-clock")

ASSUMPTIONS = {
    "retire_delegates_to_finish": True,
}

_RETIRED = 1 << 10  # model-scale sentinel (the code uses 1 << 60)


@dataclass(frozen=True)
class _S:
    finished: tuple[int, ...]  # per-worker highest finished step
    alive: tuple[bool, ...]
    swept: tuple[bool, ...]  # coordinator sweep ran for this worker
    todo: tuple[int, ...]  # steps this worker still owes
    deaths_left: int
    overrun: bool  # a step issued beyond the staleness bound


class SspSpec(Spec):
    name = "ssp"

    def __init__(
        self,
        workers: int = 2,
        steps: int = 3,
        max_delay: int = 1,
        deaths: int = 1,
        bug: str | None = None,
    ):
        if bug is not None and bug not in BUGS:
            raise ValueError(f"unknown bug {bug!r}; known: {BUGS}")
        self.workers = workers
        self.steps = steps
        self.max_delay = max_delay
        self.deaths = deaths
        self.bug = bug

    def init_states(self) -> list[Hashable]:
        n = self.workers
        return [_S(
            finished=(-1,) * n, alive=(True,) * n, swept=(False,) * n,
            todo=(self.steps,) * n, deaths_left=self.deaths,
            overrun=False,
        )]

    def actions(self, s: _S) -> list[tuple[str, Hashable]]:
        out: list[tuple[str, Hashable]] = []
        # the code's min: over EVERY entry — retirement works by writing
        # a sentinel too large to bind, not by exclusion
        true_min = min(s.finished)
        for w in range(self.workers):
            if not s.alive[w] or s.todo[w] <= 0:
                continue
            t = s.finished[w] + 1
            gate_min = (
                s.finished[w] if self.bug == "gate-own-clock" else true_min
            )
            if gate_min >= t - self.max_delay - 1:
                # issue + run + finish as one transition: the gate is
                # the only synchronization the clock contract speaks to
                overrun = s.overrun or (
                    t - true_min > self.max_delay + 1
                )
                nf = s.finished[:w] + (t,) + s.finished[w + 1:]
                nt = s.todo[:w] + (s.todo[w] - 1,) + s.todo[w + 1:]
                out.append((
                    f"worker {w}: step {t} (gate min={gate_min})",
                    replace(s, finished=nf, todo=nt, overrun=overrun),
                ))
        if s.deaths_left > 0:
            for w in range(self.workers):
                if s.alive[w] and s.todo[w] > 0:
                    na = s.alive[:w] + (False,) + s.alive[w + 1:]
                    out.append((
                        f"chaos: worker {w} dies mid-window",
                        replace(s, alive=na,
                                deaths_left=s.deaths_left - 1),
                    ))
        for w in range(self.workers):
            if s.alive[w] or s.swept[w]:
                continue
            # coordinator sweep (one-shot per death): retire the clock
            # entry + reassign the remaining steps to the laggiest heir
            if self.bug == "no-retire":
                nf = s.finished  # the frozen entry keeps binding
            elif self.bug == "retire-as-zero":
                nf = s.finished[:w] + (0,) + s.finished[w + 1:]
            else:
                nf = s.finished[:w] + (_RETIRED,) + s.finished[w + 1:]
            nsw = s.swept[:w] + (True,) + s.swept[w + 1:]
            nt = list(s.todo)
            moved = nt[w]
            nt[w] = 0
            heirs = [
                x for x in range(self.workers)
                if x != w and s.alive[x]
            ]
            label = f"coordinator: retire worker {w}"
            if heirs and moved > 0:
                heir = min(heirs, key=lambda x: (s.finished[x], x))
                nt[heir] += moved
                label += f" + reassign {moved} step(s) to worker {heir}"
            out.append((
                label,
                replace(s, finished=nf, swept=nsw, todo=tuple(nt)),
            ))
        return out

    def invariant(self, s: _S) -> str | None:
        if s.overrun:
            return (
                "a worker issued a step more than max_delay+1 ahead of "
                "the slowest clock entry — bounded staleness broken "
                "(the gate consulted the wrong clock)"
            )
        return None

    def liveness(self, s: _S) -> str | None:
        stuck = [
            w for w in range(self.workers)
            if s.alive[w] and s.todo[w] > 0
        ]
        if stuck:
            return (
                f"live worker(s) {stuck} parked on the SSP gate forever "
                "with steps outstanding — a dead worker's clock entry "
                "still binds the min (retire/reassign failed)"
            )
        unswept = [
            w for w in range(self.workers)
            if not s.alive[w] and not s.swept[w]
        ]
        if unswept and any(t > 0 for t in s.todo):
            return (
                f"dead worker(s) {unswept} never swept — their steps "
                "are lost"
            )
        return None


def make(bug: str | None = None, **bounds) -> SspSpec:
    return SspSpec(bug=bug, **bounds)


def tier1() -> SspSpec:
    return SspSpec(workers=2, steps=3, max_delay=1, deaths=1)
