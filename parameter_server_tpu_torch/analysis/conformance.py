"""Spec <-> code conformance: the psmc models (analysis/specs/) declare
the ASSUMPTIONS they make about the real package; this module DERIVES
the matching facts from the AST — through the same call-graph/held-lock
machinery pslint's checkers use — and diffs the two, so the model and
``parallel/multislice.py``/``control.py``/``ssp.py`` cannot drift apart
silently. A protocol refactor that invalidates a model assumption fails
``cli lint`` (and ``cli check``) at the drifted site, with the spec
named; the fix is to change the model WITH the code, reviewed together.

A copy of the JAX package's ``analysis/conformance.py``. Each tree
derives the keys of its own design: the JAX package's tuple-swap tables
stay (so this analyzer over the JAX tree gives the JAX analyzer's
findings), and the port's in-place publisher gets tables of its own.

Derived tables (``derive_code_tables``):

- ``idempotent_cmds``: the reply-cache exemption set at the
  ledger-owning server's ``RpcServer(...)`` construction (reuses the
  replycache checker's extraction);
- ``push_rides_reply_cache``: "push" is served and NOT exempt — its
  replies must ride the exactly-once reply cache;
- ``ledger_record_under_apply_lock``: every ``self._record_push(...)``
  call site runs while holding a lock attribute of the owning class
  (the ledger record and the state mutation it witnesses are one
  atomic unit);
- ``ledger_checked_before_apply``: every method that both records
  pushes and publishes reads ``self._applied_push`` (the dedup check)
  before the publish: a store to ``self.state``/``self._pub`` (the
  tuple swap), or a call of the in-place publisher's setter or of a
  method that calls it (the port's ``self._apply(...)``);
- tuple swap (JAX): ``publish_sites``, the methods that store
  ``self._pub`` outside ``__init__``; ``publish_bumps_version``, the
  new version derives from ``_pub[1] + 1``;
- in place (the port, ``analysis/rcu.py``'s discovery):
  ``inplace_setter`` and ``inplace_publish_lock``;
  ``setter_calls_hold_publish_lock``, every call of the setter holds
  that lock; ``setter_bumps_version``, the setter moves ``_version``
  by ``+= 1``; ``version_store_sites``, the methods that store
  ``_version`` outside ``__init__``; ``restore_takes_fresh_nonce``,
  each such store outside the setter assigns a fresh draw (a call that
  does not read the old version) and calls the setter in the same
  publish-lock hold; ``writes_publish_in_same_hold``, every in-place
  write of the tables calls the setter in its hold;
  ``pull_reads_version_in_gather_hold``, every read of the version in
  a method that gathers rows lies in a publish-lock hold that gathers;
- ``retire_delegates_to_finish``: ``SSPClock.retire`` rides
  ``finish(worker, RETIRED)`` — retirement takes the same notify path
  as progress.

Each table is derived only when its subsystem exists in the analyzed
tree (snippet indexes exercise single tables), and the checker
``spec-conformance`` emits one finding per drifted assumption. The
sibling checker ``model-invariants`` runs the tier-1-bounded model
suite itself inside lint, so a spec edit that breaks a protocol model
fails the same gate.
"""

from __future__ import annotations

import ast
from typing import Any

from parameter_server_tpu_torch.analysis.callgraph import shared_callgraph
from parameter_server_tpu_torch.analysis.core import (
    Finding,
    HeldLockWalker,
    PackageIndex,
)
from parameter_server_tpu_torch.analysis.rcu import (
    InPlacePublisher,
    _discover_one,
    _inplace_write,
    _lock_attrs,
    _metadata_load,
    _methods,
    _self_call,
    _self_stores,
    _table_aliases,
    _walk_held,
)
from parameter_server_tpu_torch.analysis.replycache import (
    declared_sets,
    served_cmds,
)

#: assumption key -> the spec facts are derived FOR (reported on drift)
_LEDGER_KEYS = (
    "idempotent_cmds",
    "push_rides_reply_cache",
    "ledger_record_under_apply_lock",
    "ledger_checked_before_apply",
)
_RCU_KEYS = ("publish_sites", "publish_bumps_version")
_INPLACE_KEYS = (
    "inplace_setter",
    "inplace_publish_lock",
    "setter_calls_hold_publish_lock",
    "setter_bumps_version",
    "version_store_sites",
    "restore_takes_fresh_nonce",
    "writes_publish_in_same_hold",
    "pull_reads_version_in_gather_hold",
)
#: the in-place publisher's version stamp
_VERSION = "_version"
_SSP_KEYS = ("retire_delegates_to_finish",)


def _is_self_attr(node: ast.AST, attr: str | None = None) -> bool:
    return (
        isinstance(node, ast.Attribute)
        and isinstance(node.value, ast.Name)
        and node.value.id == "self"
        and (attr is None or node.attr == attr)
    )


def _find_class(
    index: PackageIndex, predicate
) -> tuple[str, ast.ClassDef] | None:
    for f in index.files:
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ClassDef) and predicate(node):
                return f.relpath, node
    return None


def _defines_method(cls: ast.ClassDef, name: str) -> bool:
    return any(
        isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))
        and n.name == name
        for n in cls.body
    )


class _LockedCallScan(HeldLockWalker):
    """Collects whether every ``self.<method>(...)`` call of interest
    inside one function runs with at least one held lock."""

    def __init__(self, is_lock_expr, method: str):
        super().__init__(is_lock_expr)
        self._method = method
        self.calls: list[bool] = []  # held? per call site

    def on_call(self, node: ast.Call, held) -> None:
        if _is_self_attr(node.func, self._method):
            self.calls.append(bool(held))


def _ledger_tables(
    index: PackageIndex, relpath: str, cls: ast.ClassDef,
    publish_calls: frozenset[str] = frozenset(),
) -> dict[str, Any]:
    """``publish_calls``: the methods of ``cls`` whose call publishes
    (an in-place publisher's setter and the methods calling it)."""
    graph = shared_callgraph(index)
    out: dict[str, Any] = {}
    # reply-cache exemptions at this class's RpcServer(...) site
    idem: set[str] = set()
    for kw, names, _line in declared_sets(cls):
        if kw == "idempotent_cmds":
            idem |= names
    served = served_cmds(cls)
    out["idempotent_cmds"] = frozenset(idem)
    out["push_rides_reply_cache"] = (
        "push" in served and "push" not in idem
    )

    def is_lock(expr: ast.AST) -> str | None:
        if _is_self_attr(expr):
            return graph.lock_attr_key(cls.name, expr.attr)
        return None

    held_flags: list[bool] = []
    before_publish = True
    for node in cls.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        scan = _LockedCallScan(is_lock, "_record_push")
        scan.walk_function(node)
        held_flags.extend(scan.calls)
        # dedup-before-publish: a method that records AND publishes must
        # read self._applied_push before its first publish store
        if not scan.calls:
            continue
        publish_line = None
        check_line = None
        for sub in ast.walk(node):
            if isinstance(sub, ast.Assign):
                for t in sub.targets:
                    if _is_self_attr(t, "state") or _is_self_attr(t, "_pub"):
                        publish_line = min(
                            publish_line or sub.lineno, sub.lineno
                        )
            if _self_call(sub) in publish_calls:
                publish_line = min(publish_line or sub.lineno, sub.lineno)
            if (
                isinstance(sub, ast.Attribute)
                and sub.attr == "_applied_push"
                and isinstance(sub.ctx, ast.Load)
            ):
                check_line = min(check_line or sub.lineno, sub.lineno)
        if publish_line is not None and (
            check_line is None or check_line > publish_line
        ):
            before_publish = False
    out["ledger_record_under_apply_lock"] = (
        bool(held_flags) and all(held_flags)
    )
    out["ledger_checked_before_apply"] = before_publish and bool(held_flags)
    return out


def _rcu_tables(cls: ast.ClassDef) -> dict[str, Any]:
    sites: set[str] = set()
    bump = False
    for node in cls.body:
        if not isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            continue
        stores_pub = any(
            isinstance(sub, ast.Assign)
            and any(_is_self_attr(t, "_pub") for t in sub.targets)
            for sub in ast.walk(node)
        )
        if not stores_pub:
            continue
        if node.name != "__init__":
            sites.add(node.name)
            # version bump: the new tuple derives from _pub[1] + 1
            for sub in ast.walk(node):
                if (
                    isinstance(sub, ast.BinOp)
                    and isinstance(sub.op, ast.Add)
                    and isinstance(sub.right, ast.Constant)
                    and sub.right.value == 1
                    and any(
                        isinstance(x, ast.Attribute) and x.attr == "_pub"
                        for x in ast.walk(sub.left)
                    )
                ):
                    bump = True
    return {
        "publish_sites": frozenset(sites),
        "publish_bumps_version": bump,
    }


def _publish_calls(cls: ast.ClassDef, pub: InPlacePublisher) -> frozenset[str]:
    """The setter and the methods of ``cls`` that call it: a call of
    any of them publishes."""
    return frozenset({pub.setter} | {
        name for name, fn in _methods(cls).items()
        if name != pub.setter
        and any(_self_call(sub) == pub.setter for sub in ast.walk(fn))
    })


def _reads_rows(node: ast.AST, parents: dict, row_methods: set[str]) -> bool:
    """A gather: a non-metadata load of ``self.state``, or a call of a
    method that reads the rows."""
    if _is_self_attr(node, "state") and isinstance(node.ctx, ast.Load):
        return not _metadata_load(node, parents)
    return _self_call(node) in row_methods


def _inplace_tables(cls: ast.ClassDef, pub: InPlacePublisher) -> dict[str, Any]:
    methods = _methods(cls)
    locks = _lock_attrs(cls)
    lock = pub.pub_lock
    setter = methods[pub.setter]
    # the setter's bump: self._version += 1
    bump = any(
        isinstance(sub, ast.AugAssign)
        and _is_self_attr(sub.target, _VERSION)
        and isinstance(sub.op, ast.Add)
        and isinstance(sub.value, ast.Constant) and sub.value.value == 1
        for sub in ast.walk(setter)
    )
    # methods that read the rows directly (for a gather through a
    # helper, e.g. _table_weights)
    row_methods: set[str] = set()
    for name, fn in methods.items():
        parents = {c: p for p in ast.walk(fn) for c in ast.iter_child_nodes(p)}
        if name != "__init__" and any(
            _reads_rows(sub, parents, set()) for sub in ast.walk(fn)
        ):
            row_methods.add(name)
    sites: set[str] = set()
    fresh = True
    locked_calls: list[bool] = []
    writes_ok = True
    reads_ok = True
    for name, fn in methods.items():
        aliases = _table_aliases(fn)
        parents = {c: p for p in ast.walk(fn) for c in ast.iter_child_nodes(p)}
        stores = [st for a, st in _self_stores(fn) if a == _VERSION]
        if stores and name != "__init__":
            sites.add(name)
        # per publish-lock hold (its with-statement): does it call the
        # setter, gather rows, read the version, write the tables?
        holds: dict[int, dict[str, bool]] = {}
        outside: dict[str, bool] = {"version": False, "write": False}

        def visit(sub: ast.AST, held, name=name) -> None:
            w = next((w for a, w in reversed(held) if a == lock), None)
            if _self_call(sub) == pub.setter:
                locked_calls.append(w is not None)
            rec = holds.setdefault(id(w), {}) if w is not None else outside
            if _self_call(sub) == pub.setter:
                rec["publish"] = True
            if _reads_rows(sub, parents, row_methods - {name}):
                rec["gather"] = True
            if (
                _is_self_attr(sub, _VERSION)
                and isinstance(sub.ctx, ast.Load)
            ):
                rec["version"] = True
            if _inplace_write(sub, aliases) is not None:
                rec["write"] = True
            if (
                isinstance(sub, ast.Assign)
                and any(_is_self_attr(t, _VERSION) for t in sub.targets)
                and name not in ("__init__", pub.setter)
            ):
                rec["restore"] = True
                rec["fresh"] = isinstance(sub.value, ast.Call) and not any(
                    _is_self_attr(x, _VERSION) for x in ast.walk(sub.value)
                )

        _walk_held(fn.body, locks, visit)
        if name in ("__init__", pub.setter):
            continue
        for rec in holds.values():
            if rec.get("write") and not rec.get("publish"):
                writes_ok = False
            if rec.get("restore") and not (
                rec.get("fresh") and rec.get("publish")
            ):
                fresh = False
            if (
                rec.get("version") and name in row_methods
                and not rec.get("gather")
            ):
                reads_ok = False
        if outside.get("write") and name not in pub.caller_held:
            writes_ok = False
        if outside.get("restore"):
            fresh = False
        if (
            outside.get("version") and name in row_methods
            and name not in pub.caller_held
        ):
            reads_ok = False
    return {
        "inplace_setter": pub.setter,
        "inplace_publish_lock": lock,
        "setter_calls_hold_publish_lock": (
            lock is not None and bool(locked_calls) and all(locked_calls)
        ),
        "setter_bumps_version": bump,
        "version_store_sites": frozenset(sites),
        "restore_takes_fresh_nonce": fresh,
        "writes_publish_in_same_hold": writes_ok,
        "pull_reads_version_in_gather_hold": reads_ok,
    }


def _ssp_tables(cls: ast.ClassDef) -> dict[str, Any]:
    delegates = False
    for node in cls.body:
        if (
            isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef))
            and node.name == "retire"
        ):
            for sub in ast.walk(node):
                if (
                    isinstance(sub, ast.Call)
                    and _is_self_attr(sub.func, "finish")
                    and any(
                        isinstance(a, ast.Attribute) and a.attr == "RETIRED"
                        for a in sub.args
                    )
                ):
                    delegates = True
    return {"retire_delegates_to_finish": delegates}


def derive_code_tables(index: PackageIndex) -> dict[str, Any]:
    """The code-side facts, derived per subsystem PRESENT in the tree
    (absent subsystems contribute no keys — snippet indexes exercise
    one table at a time; the real package derives all of them)."""
    out: dict[str, Any] = {}
    inplace = _find_class(
        index, lambda c: _discover_one("", c) is not None
    )
    pub = None
    if inplace is not None:
        relpath, cls = inplace
        pub = _discover_one(relpath, cls)
        out["__inplace_site__"] = (relpath, cls.lineno, cls.name)
        out.update(_inplace_tables(cls, pub))
    ledger = _find_class(
        index, lambda c: _defines_method(c, "_record_push")
    )
    if ledger is not None:
        relpath, cls = ledger
        calls = (
            _publish_calls(cls, pub)
            if pub is not None and pub.cls == cls.name else frozenset()
        )
        out["__ledger_site__"] = (relpath, cls.lineno, cls.name)
        out.update(_ledger_tables(index, relpath, cls, calls))
    rcu_cls = _find_class(
        index,
        lambda c: any(
            isinstance(sub, ast.Assign)
            and any(_is_self_attr(t, "_pub") for t in sub.targets)
            for sub in ast.walk(c)
        ),
    )
    if rcu_cls is not None:
        relpath, cls = rcu_cls
        out["__rcu_site__"] = (relpath, cls.lineno, cls.name)
        out.update(_rcu_tables(cls))
    clock = _find_class(
        index,
        lambda c: _defines_method(c, "retire")
        and _defines_method(c, "finish"),
    )
    if clock is not None:
        relpath, cls = clock
        out["__ssp_site__"] = (relpath, cls.lineno, cls.name)
        out.update(_ssp_tables(cls))
    return out


def _site_for(key: str, tables: dict[str, Any]) -> tuple[str, int, str]:
    if key in _RCU_KEYS:
        return tables["__rcu_site__"]
    if key in _INPLACE_KEYS:
        return tables["__inplace_site__"]
    if key in _SSP_KEYS:
        return tables["__ssp_site__"]
    return tables["__ledger_site__"]


def conformance_diff(index: PackageIndex) -> list[Finding]:
    """One finding per spec assumption the derived code tables
    contradict. Empty on the real package — the acceptance bar."""
    from parameter_server_tpu_torch.analysis.specs import SPECS

    tables = derive_code_tables(index)
    out: list[Finding] = []
    for spec_name, mod in SPECS.items():
        # a spec may state its assumptions for the JAX package's design
        # beside the port's: each tree derives only its own design's keys
        wants = {**mod.ASSUMPTIONS, **getattr(mod, "TUPLE_SWAP_ASSUMPTIONS", {})}
        for key, want in wants.items():
            if key not in tables:
                continue  # subsystem absent from this tree: not judged
            got = tables[key]
            if got == want:
                continue
            relpath, line, cls_name = _site_for(key, tables)
            want_s = (
                "{" + ", ".join(sorted(want)) + "}"
                if isinstance(want, frozenset) else repr(want)
            )
            got_s = (
                "{" + ", ".join(sorted(got)) + "}"
                if isinstance(got, frozenset) else repr(got)
            )
            out.append(Finding(
                "spec-conformance", relpath, line,
                f"spec {spec_name!r} assumes {key} = {want_s} but "
                f"{cls_name} derives {got_s} — the model and the code "
                "have drifted; change analysis/specs/ WITH this code "
                "(reviewed together) or the checked protocol no longer "
                "describes what ships",
            ))
    return out


def check_spec_conformance(index: PackageIndex) -> list[Finding]:
    return conformance_diff(index)


def check_model_invariants(index: PackageIndex) -> list[Finding]:
    """Run the tier-1-bounded model suite inside lint: a spec edit (or
    bound change) that makes a protocol model violate its invariants —
    or stop exhausting its bounded space — fails the same gate the
    code-side checkers do. Skipped for snippet indexes (the models are
    package facts, not snippet facts)."""
    if index.get("parallel/multislice.py") is None:
        return []
    from parameter_server_tpu_torch.analysis.model import check
    from parameter_server_tpu_torch.analysis.specs import SPECS

    out: list[Finding] = []
    for name, mod in sorted(SPECS.items()):
        res = check(mod.tier1(), max_states=120_000)
        rel = f"analysis/specs/{mod.__name__.rsplit('.', 1)[-1]}.py"
        if res.violation is not None:
            out.append(Finding(
                "model-invariants", rel, 1,
                f"spec {name!r} violates its own "
                f"{res.violation.kind} at tier-1 bounds: "
                f"{res.violation.message} (trace: "
                + " -> ".join(res.violation.trace[-6:]) + ")",
            ))
        elif not res.complete:
            out.append(Finding(
                "model-invariants", rel, 1,
                f"spec {name!r} no longer exhausts its tier-1 bounds "
                f"({res.states} states explored, cap hit) — 'verified' "
                "claims need a complete run; shrink the bounds or raise "
                "the cap",
            ))
    return out
