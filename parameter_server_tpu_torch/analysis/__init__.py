"""pslint — the project's static analyzer, aimed at the port's own source.

A copy of the JAX package's ``analysis/`` pslint, retargeted: by default
it walks ``parameter_server_tpu_torch/`` (``--root`` names any other tree,
the JAX package's included: the package name the checkers resolve imports
against is the analysed directory's own name). ``python -m
parameter_server_tpu_torch.analysis`` (or ``cli lint``) fails on
violations of the concurrency and contract invariants:

    lock-order           static lock-acquisition graph must be acyclic
    blocking-under-lock  no socket/send/recv, sleep, Future.result,
                         RPC call, device sync or host copy, or kernel
                         library load/build while holding a lock
                         (analysis/blocking.py lists the torch names)
    settle-exactly-once  every DeferredReply is returned and settled on
                         all exit paths, exception edges included
    counter-contract     every bumped counter renders in cli stats
    config-contract      every cfg.<section>.<key> read has a default
    replycache-contract  reply-cache exemption sets (idempotent/blocking/
                         prio cmds) name only served commands, and every
                         served command has a binary cmd id
    trace-hygiene        spans only via `with trace.span(...)` / @traced
    pragma-hygiene       every suppression carries a justification
    rcu                  published (state, version) snapshots are never
                         mutated; raw publish-attr access stays under
                         the apply lock or the snapshot property; and,
                         for the port's in-place publisher, every
                         in-place write to the tables and every read of
                         their rows or of the version stamp happens
                         under the publish lock (analysis/rcu.py)
    wireproto            binary-header slot tables encode<->decode in
                         lockstep with v2 version gating, _CMD_IDS stays
                         collision-free, feature adverts have both
                         sides, every queued reply flows through
                         decorated() (dataflow-backed)
    stale-pragma         a justified pragma that suppresses nothing is
                         itself a finding
    spec-conformance     the psmc protocol models' declared ASSUMPTIONS
                         (analysis/specs/) match the tables derived from
                         the code — for the port's RCU spec, those of
                         its in-place publisher (analysis/conformance.py)
    model-invariants     the tier-1-bounded model suite itself verifies
                         clean (exactly-once / rcu / ssp / failover)
    flightrec-contract   every flightrec.record() event is known to the
                         postmortem plane, and every stitched/flagged
                         event name is actually emitted
    units                dimension lattice (us/ms/s/bytes/count/clocks)
                         inferred from name suffixes + literal factor
                         conversions (dataflow-backed: analysis/quantity.py)
    clockdomain          timestamps tagged by source clock (wall/mono/
                         perf_counter/peer-echoed foreign-wall); mixing
                         domains outside a declared skew clamp is a finding
    idtype               opaque identities (cid/seq/rank/ver/key/trace)
                         are their own types (ver equality-only outside
                         the publisher's setter)

Every id of the JAX registry is here, in its order.

Suppressions: ``# psl: ignore[<checker>]: <why>`` at the flagged line;
tree policy in pyproject.toml ``[tool.pslint]`` (read, as the JAX
analyzer reads it). The runtime complements: analysis/witness.py
(``PS_LOCK_WITNESS=1``) enforces lock order on the orders a live process
actually takes, seeded from this analyzer's lock graph;
analysis/explorer.py (``PS_SCHED=<seed>``) forces seeded adversarial
interleavings at lock/queue/publish boundaries and replays them from the
seed; analysis/racewitness.py (``PS_RACE_WITNESS=1``) checks registered
shared fields for accesses under no common lock. ``cli check`` runs the
protocol models (analysis/model.py over analysis/specs/) with the
conformance diff; ``cli verify`` chains lint, check and, optionally, the
audit and whylate gates into one tiered exit code.
"""

from __future__ import annotations

from pathlib import Path

from parameter_server_tpu_torch.analysis.blocking import check_blocking_under_lock
from parameter_server_tpu_torch.analysis.conformance import (
    check_model_invariants,
    check_spec_conformance,
)
from parameter_server_tpu_torch.analysis.contracts import (
    check_config_contract,
    check_counter_contract,
    config_key_usage,
    counter_inventory,
)
from parameter_server_tpu_torch.analysis.core import (
    PACKAGE_ROOT,
    Checker,
    Finding,
    PackageIndex,
    PslintConfig,
    check_pragma_hygiene,
    check_stale_pragma,
    load_package,
    run_checkers,
)
from parameter_server_tpu_torch.analysis.flightreccontract import (
    check_flightrec_contract,
)
from parameter_server_tpu_torch.analysis.lockgraph import (
    build_lock_graph,
    check_lock_order,
)
from parameter_server_tpu_torch.analysis.quantity import (
    check_clockdomain,
    check_idtype,
    check_units,
)
from parameter_server_tpu_torch.analysis.rcu import check_rcu
from parameter_server_tpu_torch.analysis.replycache import check_replycache_contract
from parameter_server_tpu_torch.analysis.settle import check_settle_exactly_once
from parameter_server_tpu_torch.analysis.tracehygiene import check_trace_hygiene
from parameter_server_tpu_torch.analysis.wireproto import check_wireproto

__all__ = [
    "CHECKERS",
    "Checker",
    "Finding",
    "PackageIndex",
    "PslintConfig",
    "SEVERITY_WARN_DEFAULT",
    "analyze_package",
    "analyze_sources",
    "build_lock_graph",
    "config_key_usage",
    "counter_inventory",
    "load_package",
    "severity_of",
]

#: name -> checker, in the JAX registry's order
CHECKERS: dict[str, Checker] = {
    "lock-order": check_lock_order,
    "blocking-under-lock": check_blocking_under_lock,
    "settle-exactly-once": check_settle_exactly_once,
    "counter-contract": check_counter_contract,
    "config-contract": check_config_contract,
    "replycache-contract": check_replycache_contract,
    "trace-hygiene": check_trace_hygiene,
    "pragma-hygiene": check_pragma_hygiene,
    "rcu": check_rcu,
    "wireproto": check_wireproto,
    # special-cased by run_checkers: audits suppression USAGE, so it
    # runs off the other enabled checkers' raw findings
    "stale-pragma": check_stale_pragma,
    # psmc: spec<->code conformance and the bounded model suite
    "spec-conformance": check_spec_conformance,
    "model-invariants": check_model_invariants,
    "flightrec-contract": check_flightrec_contract,
    # the quantity-flow triple over the shared dataflow fixpoint
    # (analysis/flowrun.py)
    "units": check_units,
    "clockdomain": check_clockdomain,
    "idtype": check_idtype,
}

#: checkers whose findings default to "warn" severity (exit 2, not 1)
#: when nothing in ``[tool.pslint] warn`` says otherwise; everything
#: else is "error"
SEVERITY_WARN_DEFAULT: frozenset[str] = frozenset()


def severity_of(checker: str, config: PslintConfig | None = None) -> str:
    """"error" or "warn" for one checker, honoring ``[tool.pslint]
    warn`` (the config list EXTENDS the built-in default set)."""
    warn = set(SEVERITY_WARN_DEFAULT)
    if config is not None:
        warn |= set(config.warn)
    return "warn" if checker in warn else "error"


def _default_config(root: Path) -> PslintConfig:
    # [tool.pslint] lives in the repo's pyproject.toml, one level above
    # the package dir
    return PslintConfig.load(root.parent / "pyproject.toml")


def analyze_package(
    root: Path | str = PACKAGE_ROOT,
    checkers: dict[str, Checker] | None = None,
    config: PslintConfig | None = None,
) -> list[Finding]:
    """Run the full analyzer over a package tree (default: the port);
    empty == clean."""
    root = Path(root)
    config = config if config is not None else _default_config(root)
    index = load_package(root, config)
    return run_checkers(index, checkers or CHECKERS, config)


def analyze_sources(
    sources: dict[str, str],
    checkers: dict[str, Checker] | None = None,
    root: Path | str | None = None,
) -> list[Finding]:
    """Run checkers over in-memory sources (tests: crafted snippets).
    ``root`` names the tree they stand for: its directory name is the
    package their absolute imports resolve against (default: the port)."""
    index = PackageIndex.from_sources(
        sources, root=Path(root) if root is not None else None
    )
    return run_checkers(index, checkers or CHECKERS, PslintConfig())
