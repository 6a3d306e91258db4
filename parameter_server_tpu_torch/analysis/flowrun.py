"""One shared dataflow fixpoint per PackageIndex.

The package-wide summary fixpoint in :class:`DataflowAnalysis` is the
expensive half of every dataflow-backed checker (~2.5s over the real
package). rcu and wireproto each ran their own fixpoint once, and
units / clockdomain / idtype add three more: five independent
fixpoints would blow the "full lint must not regress >1.5x" budget —
so this module gives them ONE:

- checker modules call :func:`register_flow_policy` at import time with
  a factory ``(PackageIndex) -> FlowPolicy | None`` (None: the policy
  has nothing to look for in this index, e.g. no RCU publishers);
- the first checker to call :func:`flow_policy` triggers a single
  :class:`DataflowAnalysis` run over a :class:`CompositePolicy` of
  every registered policy (disjoint tag namespaces via
  ``FlowPolicy.owns``), cached per index in a WeakKeyDictionary —
  the same pattern ``callgraph.shared_callgraph`` uses;
- every later checker on the same index gets its (already-populated)
  policy back for free and just converts its findings.

Factories register at import time instead of being imported here so the
dependency arrow stays acyclic: flowrun knows no checker module, every
checker module knows flowrun.
"""

from __future__ import annotations

import weakref
from typing import Callable

from parameter_server_tpu_torch.analysis.callgraph import shared_callgraph
from parameter_server_tpu_torch.analysis.core import PackageIndex
from parameter_server_tpu_torch.analysis.dataflow import (
    CompositePolicy,
    DataflowAnalysis,
    FlowPolicy,
)

PolicyFactory = Callable[[PackageIndex], "FlowPolicy | None"]

_FACTORIES: dict[str, PolicyFactory] = {}
_RUNS: "weakref.WeakKeyDictionary[PackageIndex, dict[str, FlowPolicy]]" = (
    weakref.WeakKeyDictionary()
)


def register_flow_policy(name: str, factory: PolicyFactory) -> None:
    """Idempotent (module re-imports just overwrite with the same fn)."""
    _FACTORIES[name] = factory


def flow_policy(index: PackageIndex, name: str) -> FlowPolicy | None:
    """The named policy, its findings already populated by the shared
    run over ``index`` (None if its factory declined this index)."""
    run = _RUNS.get(index)
    if run is None:
        run = _compute(index)
        _RUNS[index] = run
    return run.get(name)


def _compute(index: PackageIndex) -> dict[str, FlowPolicy]:
    graph = shared_callgraph(index)
    policies: dict[str, FlowPolicy] = {}
    # deterministic composition order (registration order is import
    # order, which varies with entry point)
    for name in sorted(_FACTORIES):
        p = _FACTORIES[name](index)
        if p is not None:
            policies[name] = p
    if policies:
        DataflowAnalysis(
            index, CompositePolicy(list(policies.values())), graph
        ).run()
    return policies
