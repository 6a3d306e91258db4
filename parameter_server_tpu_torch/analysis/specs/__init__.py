"""Spec inventory for psmc (analysis/model.py): small executable models
of the port's core protocols, each with (a) a correct configuration the
checker must verify clean at tier-1 bounds, (b) seeded-bug knobs the
checker must CATCH (mutation coverage for the checker itself), and
(c) ``ASSUMPTIONS`` — the facts about the real code the model's
correctness rests on, diffed against AST-derived tables by
``analysis/conformance.py`` so spec and code cannot drift silently.

    exactly-once   pipelined client window x reconnect-resend x reply
                   cache x durable ledger x server restart; invariant:
                   acked => applied exactly once
    rcu            the port's in-place publish: an apply writes the
                   rows and bumps the version in one publish-lock
                   hold, a pull reads rows and version in one hold,
                   a restore takes a fresh per-life nonce; per-life
                   monotonic versions, and a version-equal
                   revalidation never serves rows the table no longer
                   holds
    ssp            SSP clock bounded staleness under worker death,
                   retire and reassignment; liveness: the gate never
                   wedges live workers
    failover       chain-replication failover, stated as checked
                   transitions BEFORE any production code:
                   primary dies mid-window, successor promotes from the
                   replayed apply stream, clients re-point and resend

Each module exports ``make(bug=None, **bounds) -> Spec``, ``BUGS``
(the seeded-bug knob names) and ``ASSUMPTIONS``; ``tier1()`` returns
the bounded instance ``cli check`` verifies in CI. ``exactly-once``,
``ssp`` and ``failover`` are the JAX package's models, copied; ``rcu``
is written for the port's design (the JAX one models a tuple swap the
port does not have).
"""

from __future__ import annotations

from parameter_server_tpu_torch.analysis.specs import (
    exactly_once,
    failover,
    rcu,
    sspclock,
)

#: name -> spec module (make/tier1/BUGS/ASSUMPTIONS); the registry
#: cli check, the model-invariants checker and the tests all iterate
SPECS = {
    "exactly-once": exactly_once,
    "rcu": rcu,
    "ssp": sspclock,
    "failover": failover,
}
