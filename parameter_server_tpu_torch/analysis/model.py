"""psmc — explicit-state model checker for the port's core protocols.

A copy of the JAX package's ``analysis/model.py`` (pure Python: the
engine, its counterexamples and their rendering are the JAX engine's, so
the same spec gives the same states, transitions, depth and shortest
trace under either). pslint proves properties of the CODE: lock orders,
the in-place publish discipline, wire-table lockstep. What it cannot
prove is that the PROTOCOLS those mechanisms implement are correct —
that the cid/seq dedup + durable ledger + reply cache composition really
yields exactly-once pushes across crash/restart, that the in-place
publish under the publish lock really never shows rows and a version of
two different tables, that the SSP clock's retire/reassign really cannot
wedge live workers, and that chain-replication failover really loses
nothing mid-window. Those are *state-space* properties: the bugs live in
interleavings of sends, drops, duplicates, crashes and promotions that
no single test run walks.

This module is the smallest checker that walks ALL of them, bounded:

- **Explicit-state BFS** with state hashing: every spec state is a
  hashable value (``freeze`` canonicalizes dicts/sets); the frontier
  expands breadth-first, so any counterexample found is a SHORTEST one.
- **Bounded**: specs bound their process/message/crash counts in a
  ``Bounds``-style dataclass; the engine additionally caps explored
  states (``max_states``) and reports whether exploration was
  exhaustive (``complete``) — "verified" claims are only made on
  complete runs.
- **Invariant checks** at every reached state; **fairness-bounded
  liveness** at every *quiescent* state (no enabled actions): under the
  fairness assumption that enabled actions eventually fire, a liveness
  property reduces to "every state where nothing is enabled satisfies
  the goal" — a deadlocked gate or a lost acked push shows up as a
  quiescent state that fails it.
- **Counterexample traces as replayable step lists**: the action labels
  from an initial state to the violating state, exactly the argument
  the next engineer needs to replay the failure by hand against the
  spec (and against the code it models).
- **Seeded deep probe**: when BFS hits the state cap, ``probe_seeds``
  seeded random walks continue past the frontier — not a proof, but a
  deterministic (same seed => same walks) bug-finder for bounds too big
  to exhaust.

Specs live in ``analysis/specs/`` (one module per protocol, registered
in ``specs.SPECS``); each declares the ASSUMPTIONS it makes about the
real code, which ``analysis/conformance.py`` diffs against tables
derived from the AST — the model and the code cannot drift apart
silently. ``cli check`` runs the whole suite at tier-1 bounds.
"""

from __future__ import annotations

import random
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Hashable


def freeze(v: Any) -> Hashable:
    """Canonical hashable form of a spec state fragment: dicts become
    sorted (key, value) tuples, sets become sorted tuples, lists become
    tuples — recursively, so specs can build states from plain Python
    and the engine can hash them."""
    if isinstance(v, dict):
        return tuple(sorted((k, freeze(x)) for k, x in v.items()))
    if isinstance(v, (set, frozenset)):
        return tuple(sorted(freeze(x) for x in v))
    if isinstance(v, (list, tuple)):
        return tuple(freeze(x) for x in v)
    return v


class Spec:
    """One protocol model. Subclasses implement the four hooks; states
    must be hashable (use :func:`freeze`) and actions must enumerate in
    a deterministic order — BFS determinism (same bounds => same state
    count, same counterexample) is the property the tests pin."""

    name: str = "spec"

    def init_states(self) -> list[Hashable]:
        raise NotImplementedError

    def actions(self, state: Hashable) -> list[tuple[str, Hashable]]:
        """Enabled transitions as (label, successor) pairs."""
        raise NotImplementedError

    def invariant(self, state: Hashable) -> str | None:
        """Violation message, or None. Checked at EVERY reached state."""
        return None

    def liveness(self, state: Hashable) -> str | None:
        """Violation message, or None. Checked at QUIESCENT states only
        (no enabled actions): under fairness, 'eventually P' reduces to
        'P holds wherever the system can no longer move' — a deadlock
        is a quiescent state that fails the goal."""
        return None


@dataclass
class Violation:
    kind: str  # invariant | liveness
    message: str
    trace: list[str]  # action labels, init -> violating state
    state: Hashable

    def render(self) -> str:
        steps = "\n".join(
            f"  {i + 1:>3}. {a}" for i, a in enumerate(self.trace)
        ) or "  (initial state)"
        return (
            f"{self.kind} violation: {self.message}\n"
            f"replayable steps ({len(self.trace)}):\n{steps}"
        )


@dataclass
class CheckResult:
    spec: str
    states: int = 0
    transitions: int = 0
    depth: int = 0
    complete: bool = True  # exhausted the bounded space (no cap hit)
    violation: Violation | None = None

    @property
    def ok(self) -> bool:
        return self.violation is None

    def summary(self) -> dict:
        return {
            "spec": self.spec,
            "states": self.states,
            "transitions": self.transitions,
            "depth": self.depth,
            "complete": self.complete,
            "ok": self.ok,
            "violation": (
                None
                if self.violation is None
                else {
                    "kind": self.violation.kind,
                    "message": self.violation.message,
                    "trace": list(self.violation.trace),
                }
            ),
        }


@dataclass
class _Node:
    parent: Hashable | None
    label: str | None
    depth: int = 0


def _trace(nodes: dict[Hashable, _Node], state: Hashable) -> list[str]:
    out: list[str] = []
    cur: Hashable | None = state
    while cur is not None:
        n = nodes[cur]
        if n.label is not None:
            out.append(n.label)
        cur = n.parent
    return out[::-1]


def check(
    spec: Spec,
    max_states: int = 200_000,
    max_depth: int = 0,
    probe_seeds: int = 0,
    probe_len: int = 256,
    seed: int = 0,
) -> CheckResult:
    """Exhaustive bounded BFS over ``spec``'s state space. Deterministic:
    same spec + bounds => same state count, same (shortest)
    counterexample. ``probe_seeds`` > 0 adds seeded random walks past
    the BFS cap when the cap was hit (bug probing, not verification —
    ``complete`` stays False)."""
    res = CheckResult(spec=spec.name)
    nodes: dict[Hashable, _Node] = {}
    q: deque[Hashable] = deque()
    for s in spec.init_states():
        if s in nodes:
            continue
        nodes[s] = _Node(None, None, 0)
        msg = spec.invariant(s)
        if msg is not None:
            res.states = len(nodes)
            res.violation = Violation("invariant", msg, [], s)
            return res
        q.append(s)
    while q:
        if len(nodes) >= max_states:
            res.complete = False
            break
        s = q.popleft()
        depth = nodes[s].depth
        res.depth = max(res.depth, depth)
        acts = spec.actions(s)
        if not acts:
            msg = spec.liveness(s)
            if msg is not None:
                res.states = len(nodes)
                res.violation = Violation(
                    "liveness", msg, _trace(nodes, s), s
                )
                return res
            continue
        if max_depth and depth >= max_depth:
            res.complete = False
            continue
        for label, nxt in acts:
            res.transitions += 1
            if nxt in nodes:
                continue
            nodes[nxt] = _Node(s, label, depth + 1)
            msg = spec.invariant(nxt)
            if msg is not None:
                res.states = len(nodes)
                res.violation = Violation(
                    "invariant", msg, _trace(nodes, nxt), nxt
                )
                return res
            q.append(nxt)
    res.states = len(nodes)
    if not res.complete and probe_seeds > 0 and res.violation is None:
        v = _probe(spec, probe_seeds, probe_len, seed)
        if v is not None:
            res.violation = v
    return res


def _probe(
    spec: Spec, walks: int, length: int, seed: int
) -> Violation | None:
    """Seeded random walks (deterministic per seed): a cheap deep probe
    for state spaces the BFS cap cut short. Invariants checked per step,
    liveness at any quiescent endpoint."""
    for w in range(walks):
        rng = random.Random(f"{seed}:{w}")
        inits = spec.init_states()
        s = inits[rng.randrange(len(inits))]
        trace: list[str] = []
        for _ in range(length):
            msg = spec.invariant(s)
            if msg is not None:
                return Violation("invariant", msg, trace, s)
            acts = spec.actions(s)
            if not acts:
                msg = spec.liveness(s)
                if msg is not None:
                    return Violation("liveness", msg, trace, s)
                break
            label, s2 = acts[rng.randrange(len(acts))]
            trace.append(label)
            s = s2
        # the loop checks invariants at the TOP of each iteration, so a
        # walk whose final transition lands on a violating state would
        # otherwise slip out unchecked
        msg = spec.invariant(s)
        if msg is not None:
            return Violation("invariant", msg, trace, s)
    return None
