"""Checker ``rcu``: the published ``(state, version)`` snapshot is
immutable, and the raw publish attribute is only touched under the lock.

The batched apply engine's whole reader-side contract is
RCU: writers build a NEW state table and publish it with one reference
swap through the snapshot property, so lock-free readers (pull, dump,
the encode cache) see the pre- or post-batch table and never a torn
mix. Nothing enforced that. A single ``state[k] = ...`` on a captured
snapshot — easy to write in a replication or failover path that
"just fixes up one row" — silently breaks every concurrent reader AND
the version stamp (rows from a mutated table no longer match the ``ver``
they were served under), and no test catches it unless the exact
interleaving happens.

This checker makes the discipline static, on dataflow facts
(analysis/dataflow.py) rather than syntax:

- **publish pattern discovery**: a class with a property returning
  ``self.<attr>[0]`` and a setter swapping ``self.<attr> = (...)`` is an
  RCU publisher; the property is the *snapshot property*, ``<attr>``
  the *raw publish attribute* (``ShardServer.state`` / ``_pub``).
- **snapshot immutability**: any value aliasing a published snapshot —
  through assignment, tuple unpacking, subscript reads, helper returns —
  must never be mutated: subscript-store, ``del``, augmented assign,
  or a mutating method (``.update``/``.pop``/...) on it is a finding,
  as is passing it to a callee whose summary mutates that parameter.
- **raw-attribute discipline**: loads of the raw publish attribute
  outside the publisher's own property methods (and ``__init__``) must
  happen under a held lock — everyone else goes through the snapshot
  property, so the one deliberate lock-free tuple capture in the pull
  path is a pragma-documented exception, not an idiom that spreads.
  Stores to the raw attribute outside the setter/``__init__`` are
  flagged unconditionally: every publish must bump the version.

A copy of the JAX package's ``analysis/rcu.py``, which keeps the tuple-swap
publisher above whole (the JAX package's snippets give the same findings
here). The port's own server does not swap snapshots: its tables change in
place under one publish lock, and the version and its publish timestamp
move in the same hold. This module adds that **in-place publisher**:

- **discovery**: a class with a method (not ``__init__``) that moves
  ``self._version`` by an augmented assignment is an in-place publisher;
  that method is its *setter* (``ShardServer._publish``), the attributes
  it assigns are the *stamps* (``_version``, ``_pts``), and the lock held
  at every call site of the setter is the *publish lock* (``_pub_lock``).
  The lock held at every call site of the methods that write the tables
  in place is the *apply lock* (``_lock``). The tables are ``self.state``.
- **writes**: every in-place write to a ``self.state`` table (a
  trailing-underscore method on a table, ``*push(..., self.state, ...)``,
  or a subscript store), happens under the publish lock, with the setter
  called in the same hold: rows and version move together.
- **reads**: every read of the tables' rows, and of a stamp, happens
  under the publish lock. Metadata (the table names, ``.shape``,
  ``.dtype``) never changes in place and may be read anywhere.
- **restores**: a store to ``self.state`` or to a stamp outside
  ``__init__`` and the setter holds the publish lock and the apply lock,
  and calls the setter in that hold.

A method whose every call site in its class holds the publish lock (or
lies in another such method) runs under it: ``_publish`` itself, and
helpers like ``_table_weights``. The idtype checker exempts the setter's
arithmetic on the version (analysis/quantity.py).
"""

from __future__ import annotations

import ast
from dataclasses import dataclass
from typing import Callable

from parameter_server_tpu_torch.analysis.callgraph import CallGraph, shared_callgraph
from parameter_server_tpu_torch.analysis.core import Finding, PackageIndex, unparse
from parameter_server_tpu_torch.analysis.dataflow import (
    EMPTY,
    FlowPolicy,
    Tags,
    is_param_tag,
)
from parameter_server_tpu_torch.analysis.flowrun import (
    flow_policy,
    register_flow_policy,
)

#: tag carried by the raw publish tuple; element 0 of it is TAG_SNAP
TAG_PUB = "rcu-pub"
#: tag carried by the published state table (and rows read out of it)
TAG_SNAP = "rcu"


@dataclass(frozen=True)
class Publisher:
    """One discovered RCU-publishing class."""

    cls: str
    relpath: str
    raw_attr: str  # e.g. "_pub"
    snap_prop: str  # property returning <raw_attr>[0], e.g. "state"
    #: every property method (getter/setter names) allowed to touch the
    #: raw attribute without a lock
    prop_methods: frozenset[str]


def _self_attr(expr: ast.AST) -> str | None:
    if (
        isinstance(expr, ast.Attribute)
        and isinstance(expr.value, ast.Name)
        and expr.value.id == "self"
    ):
        return expr.attr
    return None


def _returns_self_sub(fndef: ast.FunctionDef) -> tuple[str, int] | None:
    """``return self.<attr>[<int>]`` -> (attr, int)."""
    for stmt in fndef.body:
        if isinstance(stmt, ast.Return) and isinstance(
            stmt.value, ast.Subscript
        ):
            attr = _self_attr(stmt.value.value)
            s = stmt.value.slice
            if attr and isinstance(s, ast.Constant) and isinstance(
                s.value, int
            ):
                return attr, s.value
    return None


def _is_property(fndef: ast.FunctionDef) -> bool:
    return any(
        isinstance(d, ast.Name) and d.id == "property"
        for d in fndef.decorator_list
    )


def _is_setter(fndef: ast.FunctionDef) -> str | None:
    """``@<prop>.setter`` -> prop name."""
    for d in fndef.decorator_list:
        if isinstance(d, ast.Attribute) and d.attr == "setter" and isinstance(
            d.value, ast.Name
        ):
            return d.value.id
    return None


def discover_publishers(index: PackageIndex) -> list[Publisher]:
    out: list[Publisher] = []
    for f in index.files:
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            # attr -> {prop reading it}, prop -> element index
            getters: dict[str, list[tuple[str, int]]] = {}
            setter_attrs: dict[str, set[str]] = {}
            prop_methods: set[str] = set()
            for item in node.body:
                if not isinstance(item, ast.FunctionDef):
                    continue
                if _is_property(item):
                    r = _returns_self_sub(item)
                    if r is not None:
                        getters.setdefault(r[0], []).append(
                            (item.name, r[1])
                        )
                        prop_methods.add(item.name)
                prop = _is_setter(item)
                if prop is not None:
                    for sub in ast.walk(item):
                        if isinstance(sub, ast.Assign) and isinstance(
                            sub.value, ast.Tuple
                        ):
                            for t in sub.targets:
                                a = _self_attr(t)
                                if a:
                                    setter_attrs.setdefault(a, set()).add(
                                        prop
                                    )
                                    prop_methods.add(item.name)
            for attr, props in getters.items():
                snap = [p for p, i in props if i == 0]
                if snap and attr in setter_attrs:
                    out.append(Publisher(
                        cls=node.name,
                        relpath=f.relpath,
                        raw_attr=attr,
                        snap_prop=snap[0],
                        prop_methods=frozenset(prop_methods),
                    ))
    return out


class _RcuPolicy(FlowPolicy):
    def __init__(self, pubs: list[Publisher], graph: CallGraph):
        self._graph = graph
        self.pubs = pubs
        self._by_cls = {p.cls: p for p in pubs}
        self._snap_props = {p.snap_prop for p in pubs}
        self._raw_attrs = {p.raw_attr for p in pubs}
        self.findings: list[tuple[int, str, str]] = []  # (line, relpath, msg)
        self._relpath = ""
        self._seen: set[tuple[str, int, str]] = set()

    # -- helpers -----------------------------------------------------------

    def _publisher_for(
        self, expr: ast.Attribute, cls_name: str | None
    ) -> Publisher | None:
        """The Publisher whose snapshot property / raw attr ``expr``
        reads, resolving the receiver like the call graph does: ``self``
        through the MRO, ``self.<attr>`` through attr_types, module
        singletons through global_instances."""
        recv = expr.value
        g = self._graph
        cls: str | None = None
        if isinstance(recv, ast.Name):
            if recv.id == "self" and cls_name is not None:
                for info in g.mro(cls_name):
                    if info.name in self._by_cls:
                        cls = info.name
                        break
            elif recv.id in g.global_instances:
                cls = g.global_instances[recv.id]
        elif (
            isinstance(recv, ast.Attribute)
            and isinstance(recv.value, ast.Name)
            and recv.value.id == "self"
            and cls_name is not None
        ):
            for info in g.mro(cls_name):
                t = info.attr_types.get(recv.attr)
                if t is not None:
                    cls = t
                    break
        return self._by_cls.get(cls) if cls else None

    def _add(self, line: int, msg: str) -> None:
        key = (self._relpath, line, msg)
        if key not in self._seen:
            self._seen.add(key)
            self.findings.append((line, self._relpath, msg))

    # -- FlowPolicy hooks --------------------------------------------------

    def owns(self, tag: str) -> bool:
        return tag in (TAG_SNAP, TAG_PUB)

    def begin_function(
        self, relpath: str, cls_name: str | None, fn_name: str
    ) -> None:
        self._relpath = relpath

    def seed(
        self, expr: ast.expr, cls_name: str | None, relpath: str
    ) -> Tags:
        if not isinstance(expr, ast.Attribute):
            return EMPTY
        pub = self._publisher_for(expr, cls_name)
        if pub is None:
            return EMPTY
        if expr.attr == pub.snap_prop:
            return frozenset({TAG_SNAP})
        if expr.attr == pub.raw_attr:
            return frozenset({TAG_PUB})
        return EMPTY

    def element(self, tags: Tags, index: object) -> Tags:
        out = set()
        for t in tags:
            if t == TAG_PUB:
                # element 0 of the publish tuple is the state table;
                # element 1 is the (immutable int) version
                if index == 0 or index is None or index == "iter":
                    out.add(TAG_SNAP)
            elif not is_param_tag(t):
                out.add(t)
        return frozenset(out)

    def on_mutation(
        self, node: ast.AST, kind: str, tags: Tags, held, desc: str
    ) -> None:
        if TAG_SNAP not in tags and TAG_PUB not in tags:
            return
        via = {
            "setitem": "subscript-store into",
            "setattr": "attribute-store into",
            "del": "del on",
            "augassign": "augmented assignment on",
            "call": "mutating method call on",
            "callee": "passing to a callee that mutates",
        }.get(kind, kind)
        self._add(
            getattr(node, "lineno", 0),
            f"{via} {desc}: this value aliases a PUBLISHED RCU snapshot "
            "(immutable after the reference-swap publish) — lock-free "
            "readers and the version stamp both break; build a new "
            "table and publish it through the snapshot property",
        )

    def on_load(
        self, expr: ast.expr, cls_name: str | None, held, fn_name: str
    ) -> None:
        if not isinstance(expr, ast.Attribute):
            return
        if expr.attr not in self._raw_attrs:
            return
        pub = self._publisher_for(expr, cls_name)
        if pub is None or expr.attr != pub.raw_attr:
            return
        if cls_name == pub.cls and (
            fn_name in pub.prop_methods or fn_name == "__init__"
        ):
            return
        if held:
            return  # under a lock: the sanctioned raw access
        self._add(
            expr.lineno,
            f"raw read of RCU publish attribute {pub.cls}.{pub.raw_attr} "
            "outside the apply lock — go through the snapshot property "
            f"({pub.snap_prop}) so readers always capture one published "
            "tuple",
        )


def _check_raw_stores(
    index: PackageIndex, pubs: list[Publisher], out: list[Finding]
) -> None:
    """Stores to the raw publish attribute outside the setter/__init__:
    a publish that bypasses the property setter skips the version bump,
    so a cached ``ver`` would keep validating against changed rows."""
    from parameter_server_tpu_torch.analysis.core import iter_functions

    by_cls = {p.cls: p for p in pubs}
    for f in index.files:
        for cls_name, fndef in iter_functions(f.tree):
            pub = by_cls.get(cls_name or "")
            if pub is None:
                continue
            if fndef.name in pub.prop_methods or fndef.name == "__init__":
                continue
            for sub in ast.walk(fndef):
                targets: list[ast.expr] = []
                if isinstance(sub, ast.Assign):
                    targets = sub.targets
                elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
                    targets = [sub.target]
                for t in targets:
                    if _self_attr(t) == pub.raw_attr:
                        out.append(Finding(
                            "rcu", f.relpath, sub.lineno,
                            f"direct store to {pub.cls}.{pub.raw_attr} "
                            "bypasses the snapshot property setter (no "
                            "version bump): publish through "
                            f"self.{pub.snap_prop} = ...",
                        ))


def _policy_factory(index: PackageIndex) -> _RcuPolicy | None:
    pubs = discover_publishers(index)
    if not pubs:
        return None
    return _RcuPolicy(pubs, shared_callgraph(index))


register_flow_policy("rcu", _policy_factory)


def check_rcu(index: PackageIndex) -> list[Finding]:
    out: list[Finding] = []
    _check_inplace(index, discover_inplace_publishers(index), out)
    policy = flow_policy(index, "rcu")
    if policy is None:  # no tuple-swap RCU publishers in this index
        return out
    assert isinstance(policy, _RcuPolicy)
    out.extend(
        Finding("rcu", rel, line, msg)
        for line, rel, msg in policy.findings
    )
    _check_raw_stores(index, policy.pubs, out)
    return out


# ---------------------------------------------------------------------------
# the port's in-place publisher
# ---------------------------------------------------------------------------

#: the attribute the in-place publisher's setter moves
_VERSION_ATTR = "_version"
#: the attribute holding the publisher's tables (name -> tensor)
_STATE_ATTR = "state"
#: table attributes that never change in place (metadata)
_META_ATTRS = frozenset({"shape", "dtype", "device", "ndim", "is_cuda"})
_META_METHODS = frozenset({"size", "dim", "keys"})
#: builtins that read only a table dict's names
_KEY_BUILTINS = frozenset({"set", "len", "sorted", "list", "tuple"})


@dataclass(frozen=True)
class InPlacePublisher:
    """One discovered in-place publishing class."""

    cls: str
    relpath: str
    setter: str  # e.g. "_publish"
    pub_lock: str | None  # e.g. "_pub_lock"; None: no common lock
    apply_locks: frozenset[str]  # e.g. {"_lock"}
    stamps: frozenset[str]  # e.g. {"_version", "_pts"}
    #: methods that run under the publish lock by their callers' holds
    caller_held: frozenset[str]


def _methods(cls: ast.ClassDef) -> dict[str, ast.FunctionDef]:
    return {
        item.name: item
        for item in cls.body
        if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef))
    }


def _self_stores(fndef: ast.AST) -> list[tuple[str, ast.stmt]]:
    out = []
    for sub in ast.walk(fndef):
        targets: list[ast.expr] = []
        if isinstance(sub, ast.Assign):
            targets = sub.targets
        elif isinstance(sub, (ast.AugAssign, ast.AnnAssign)):
            targets = [sub.target]
        for t in targets:
            for e in t.elts if isinstance(t, ast.Tuple) else [t]:
                a = _self_attr(e)
                if a:
                    out.append((a, sub))
    return out


def _walk_held(
    body: list[ast.stmt],
    locks: set[str],
    visit: Callable[[ast.AST, tuple], None],
    held: tuple[tuple[str, ast.AST], ...] = (),
) -> None:
    """Statement-order walk calling ``visit(node, held)`` for every node,
    ``held`` the ``(lock attr, with-statement)`` pairs of ``self.<lock>``
    holds around it. Nested functions run later: their bodies walk with
    nothing held."""
    for stmt in body:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            _walk_held(stmt.body, locks, visit, ())
            continue
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            inner = held
            for item in stmt.items:
                for sub in ast.walk(item.context_expr):
                    visit(sub, inner)
                a = _self_attr(item.context_expr)
                if a in locks:
                    inner = inner + ((a, stmt),)
            _walk_held(stmt.body, locks, visit, inner)
            continue
        children: list[list[ast.stmt]] = []
        heads: list[ast.AST] = []
        if isinstance(stmt, ast.Try):
            children = [stmt.body, *[h.body for h in stmt.handlers],
                        stmt.orelse, stmt.finalbody]
        elif isinstance(stmt, (ast.If, ast.While)):
            heads, children = [stmt.test], [stmt.body, stmt.orelse]
        elif isinstance(stmt, (ast.For, ast.AsyncFor)):
            heads = [stmt.target, stmt.iter]
            children = [stmt.body, stmt.orelse]
        else:
            heads = [stmt]
        for h in heads:
            for sub in ast.walk(h):
                visit(sub, held)
        for c in children:
            _walk_held(c, locks, visit, held)


def _self_call(node: ast.AST) -> str | None:
    """``self.<m>(...)`` -> m."""
    if isinstance(node, ast.Call):
        return _self_attr(node.func)
    return None


def discover_inplace_publishers(index: PackageIndex) -> list[InPlacePublisher]:
    out: list[InPlacePublisher] = []
    for f in index.files:
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ClassDef):
                pub = _discover_one(f.relpath, node)
                if pub is not None:
                    out.append(pub)
    return out


def _lock_attrs(cls: ast.ClassDef) -> set[str]:
    from parameter_server_tpu_torch.analysis.core import lock_ctor_name

    return {
        a for fn in _methods(cls).values() for a, st in _self_stores(fn)
        if isinstance(st, ast.Assign) and lock_ctor_name(st.value)
    }


def _discover_one(relpath: str, cls: ast.ClassDef) -> InPlacePublisher | None:
    methods = _methods(cls)
    setter = next((
        name for name, fn in methods.items()
        if name != "__init__" and any(
            a == _VERSION_ATTR and isinstance(st, ast.AugAssign)
            for a, st in _self_stores(fn)
        )
    ), None)
    if setter is None:
        return None
    stamps = frozenset(a for a, _ in _self_stores(methods[setter]))
    locks = _lock_attrs(cls)
    # every self.<m>() call site: (caller, callee, held lock attrs,
    # outermost first)
    sites: list[tuple[str, str, tuple[str, ...]]] = []
    writers: set[str] = set()
    for name, fn in methods.items():
        aliases = _table_aliases(fn)

        def visit(sub: ast.AST, held, name=name, aliases=aliases) -> None:
            m = _self_call(sub)
            if m in methods:
                sites.append((name, m, tuple(a for a, _ in held)))
            if _inplace_write(sub, aliases) is not None:
                writers.add(name)

        _walk_held(fn.body, locks, visit)
    at_setter = [h for _, m, h in sites if m == setter]
    common = (
        frozenset.intersection(*map(frozenset, at_setter))
        if at_setter else frozenset()
    )
    # of the locks every call holds, the innermost one at the first call
    pub_lock = next(
        (a for a in reversed(at_setter[0]) if a in common), None
    ) if common else None
    held_by: dict[str, list[tuple[str, frozenset[str]]]] = {}
    for caller, m, h in sites:
        held_by.setdefault(m, []).append((caller, frozenset(h)))
    caller_held = {m for m in held_by if m != "__init__"}
    changed = True
    while changed:  # drop methods with a call site outside the lock
        changed = False
        for m in sorted(caller_held):
            if any(
                pub_lock not in h and c not in caller_held
                for c, h in held_by[m]
            ):
                caller_held.discard(m)
                changed = True
    writer_sites = [
        h - {pub_lock} for m in writers - {setter, "__init__"}
        for _, h in held_by.get(m, [])
    ]
    apply_locks = (
        frozenset.intersection(*writer_sites) if writer_sites else frozenset()
    )
    return InPlacePublisher(
        cls=cls.name, relpath=relpath, setter=setter, pub_lock=pub_lock,
        apply_locks=apply_locks, stamps=stamps,
        caller_held=frozenset(caller_held),
    )


def _is_state(expr: ast.AST) -> bool:
    return _self_attr(expr) == _STATE_ATTR


def _table_aliases(fndef: ast.AST) -> set[str]:
    """Local names bound to one of ``self.state``'s tables: ``for k, v in
    self.state.items()``, ``for v in self.state.values()``, ``v =
    self.state[k]`` / ``self.state.get(k)``."""
    out: set[str] = set()
    for sub in ast.walk(fndef):
        if isinstance(sub, (ast.For, ast.comprehension)):
            it = sub.iter
            if (
                isinstance(it, ast.Call)
                and isinstance(it.func, ast.Attribute)
                and _is_state(it.func.value)
            ):
                t = sub.target
                if it.func.attr == "items" and isinstance(t, ast.Tuple) and (
                    len(t.elts) == 2 and isinstance(t.elts[1], ast.Name)
                ):
                    out.add(t.elts[1].id)
                elif it.func.attr == "values" and isinstance(t, ast.Name):
                    out.add(t.id)
        elif isinstance(sub, ast.Assign) and len(sub.targets) == 1 and (
            isinstance(sub.targets[0], ast.Name)
        ):
            v = sub.value
            if (isinstance(v, ast.Subscript) and _is_state(v.value)) or (
                isinstance(v, ast.Call)
                and isinstance(v.func, ast.Attribute)
                and v.func.attr == "get"
                and _is_state(v.func.value)
            ):
                out.add(sub.targets[0].id)
    return out


def _is_table(expr: ast.AST, aliases: set[str]) -> bool:
    """A table of ``self.state`` (``self.state[k]``, an alias), or a view
    of one (``table[idx]``)."""
    while isinstance(expr, ast.Subscript):
        if _is_state(expr.value):
            return True
        expr = expr.value
    return isinstance(expr, ast.Name) and expr.id in aliases


def _call_name(call: ast.Call) -> str:
    fn = call.func
    if isinstance(fn, ast.Attribute):
        return fn.attr
    return fn.id if isinstance(fn, ast.Name) else ""


def _inplace_write(node: ast.AST, aliases: set[str]) -> str | None:
    """A description of an in-place write to the tables at ``node``."""
    if isinstance(node, ast.Call):
        fn = node.func
        if (
            isinstance(fn, ast.Attribute)
            and fn.attr.endswith("_")
            and not fn.attr.startswith("_")
            and _is_table(fn.value, aliases)
        ):
            return f"in-place {unparse(fn)}(...)"
        name = _call_name(node)
        if (name == "push" or name.endswith("_push")) and any(
            _is_state(a) for a in [*node.args, *(k.value for k in node.keywords)]
        ):
            return f"in-place {unparse(fn)}(..., self.{_STATE_ATTR}, ...)"
    if isinstance(node, (ast.Assign, ast.AugAssign)):
        targets = node.targets if isinstance(node, ast.Assign) else [node.target]
        for t in targets:
            if isinstance(t, ast.Subscript) and (
                _is_state(t.value) or _is_table(t.value, aliases)
            ):
                return f"subscript store {unparse(t)} = ..."
    return None


def _metadata_load(node: ast.AST, parents: dict[ast.AST, ast.AST]) -> bool:
    """Whether this ``self.state`` load reads only metadata: the table
    names (``set(self.state)``, ``k in self.state``, ``.keys()``) or a
    table's shape/dtype (``self.state[k].shape``)."""
    p = parents.get(node)
    if isinstance(p, ast.Call) and isinstance(p.func, ast.Name) and (
        p.func.id in _KEY_BUILTINS and p.args == [node]
    ):
        return True
    if isinstance(p, ast.Compare) and node in p.comparators and all(
        isinstance(o, (ast.In, ast.NotIn)) for o in p.ops
    ):
        return True
    if isinstance(p, ast.Attribute) and p.attr in _META_METHODS:
        return True
    if isinstance(p, ast.Subscript) and p.value is node:
        q = parents.get(p)
        return isinstance(q, ast.Attribute) and (
            q.attr in _META_ATTRS or q.attr in _META_METHODS
        )
    return False


def _check_inplace(
    index: PackageIndex, pubs: list[InPlacePublisher], out: list[Finding]
) -> None:
    by_cls = {p.cls: p for p in pubs}
    for f in index.files:
        for node in ast.walk(f.tree):
            if isinstance(node, ast.ClassDef) and node.name in by_cls:
                pub = by_cls[node.name]
                if pub.relpath == f.relpath:
                    _check_class(f.relpath, node, pub, out)


def _check_class(
    relpath: str, cls: ast.ClassDef, pub: InPlacePublisher,
    out: list[Finding],
) -> None:
    seen: set[tuple[int, str]] = set()
    lock = pub.pub_lock
    locks = _lock_attrs(cls)

    def add(line: int, msg: str) -> None:
        if (line, msg) not in seen:
            seen.add((line, msg))
            out.append(Finding("rcu", relpath, line, msg))

    if lock is None:
        add(cls.lineno, (
            f"in-place publisher {pub.cls}: its setter {pub.setter}() is "
            "called under no common lock, so no lock publishes the "
            "version with the rows"
        ))
        return
    for name, fn in _methods(cls).items():
        if name == "__init__":
            continue
        aliases = _table_aliases(fn)
        parents = {
            c: p for p in ast.walk(fn) for c in ast.iter_child_nodes(p)
        }
        runs_held = name in pub.caller_held
        # the publish-lock hold (with-statement) around each setter call
        published: set[int] = set()
        stores: set[int] = set()

        def collect(sub: ast.AST, held) -> None:
            if _self_call(sub) == pub.setter:
                for a, w in held:
                    if a == lock:
                        published.add(id(w))
            if isinstance(sub, (ast.Assign, ast.AugAssign, ast.AnnAssign)):
                for t in (
                    sub.targets if isinstance(sub, ast.Assign) else [sub.target]
                ):
                    for e in t.elts if isinstance(t, ast.Tuple) else [t]:
                        stores.add(id(e))

        _walk_held(fn.body, locks, collect)

        def hold_of(held) -> ast.With | None:
            return next((w for a, w in reversed(held) if a == lock), None)

        def check(sub: ast.AST, held) -> None:
            names = {a for a, _ in held}
            under = lock in names or runs_held
            w = hold_of(held)
            same_hold = (w is not None and id(w) in published) or (
                w is None and runs_held and name == pub.setter
            )
            what = _inplace_write(sub, aliases)
            if what is not None:
                if not under:
                    add(sub.lineno, (
                        f"{what} on {pub.cls}.{_STATE_ATTR} outside the "
                        f"publish lock {pub.cls}.{lock}: a gather issued "
                        "meanwhile reads a torn table"
                    ))
                elif not same_hold and not (runs_held and _calls(fn, pub.setter)):
                    add(sub.lineno, (
                        f"{what} on {pub.cls}.{_STATE_ATTR} without "
                        f"{pub.setter}() in the same {lock} hold: the rows "
                        "change and the version does not, so a client's "
                        "cached version validates against changed rows"
                    ))
                return
            a = _self_attr(sub)
            if a is None or not isinstance(sub, ast.Attribute):
                return
            if id(sub) in stores and (a == _STATE_ATTR or a in pub.stamps):
                if name == pub.setter and a in pub.stamps:
                    return
                need = {lock} | set(pub.apply_locks)
                if not need <= names or not same_hold:
                    add(sub.lineno, (
                        f"restore of {pub.cls}.{a} must hold "
                        + " and ".join(f"{pub.cls}.{x}" for x in sorted(need))
                        + f" and call {pub.setter}() in that hold: the "
                        "apply path and the readers would see a table "
                        "and a version from two lives"
                    ))
                return
            if under or (name == pub.setter):
                return
            if a == _STATE_ATTR and not _metadata_load(sub, parents):
                add(sub.lineno, (
                    f"read of {pub.cls}.{_STATE_ATTR} rows outside the "
                    f"publish lock {pub.cls}.{lock}: an in-place apply "
                    "may be under way (issue the gather in the hold; copy "
                    "to the host after it)"
                ))
            elif a in pub.stamps:
                add(sub.lineno, (
                    f"read of {pub.cls}.{a} outside the publish lock "
                    f"{pub.cls}.{lock}: the stamp must be read in the hold "
                    "that gathers the rows it names"
                ))

        _walk_held(fn.body, locks, check)


def _calls(fndef: ast.AST, method: str) -> bool:
    return any(_self_call(sub) == method for sub in ast.walk(fndef))
