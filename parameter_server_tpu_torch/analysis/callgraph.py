"""Lightweight package call graph for the concurrency checkers.

A copy of the JAX package's ``analysis/callgraph.py``; the package name
imports resolve against is the analysed tree's (``PackageIndex.package``).

The lock-order and blocking-under-lock checkers both need the same two
facts about a call made while a lock is held: *which function does this
resolve to* and *what does that function do transitively*. This module
builds the resolution tables once per analysis run:

- every class (methods, base names, ``self.X = threading.Lock()`` lock
  attributes with construction sites, ``self.Y = SomeClass(...)``
  attribute types),
- every module-level function,
- module-level instances (``wire_counters = CounterSet()``) and
  module-level locks, visible across files through import aliasing,

and offers ``callees()`` (syntactic call -> owner keys) plus a generic
``summarize()`` fixpoint so a checker can fold any per-function fact
(locks acquired, may-block) transitively through self-calls, attribute
calls, known-instance calls and constructors. Deliberately
intraprocedural-plus-one-table: no type inference, no dynamic dispatch —
precise enough for this package's idioms, simple enough to audit.
"""

from __future__ import annotations

import ast
import weakref
from dataclasses import dataclass, field
from typing import Any, Callable

from parameter_server_tpu_torch.analysis.core import PackageIndex, lock_ctor_name

#: owner key of a function body: ("m", class_name, method_name) or
#: ("f", relpath, func_name)
OwnerKey = tuple[str, str, str]

_shared: "weakref.WeakKeyDictionary[PackageIndex, CallGraph]" = (
    weakref.WeakKeyDictionary()
)


def shared_callgraph(index: PackageIndex) -> "CallGraph":
    """One CallGraph per index, shared by every checker in a run: the
    tables are build-once read-only, and with three dataflow-backed
    checkers plus the lock pair all resolving calls, rebuilding per
    checker would walk the whole package's ASTs five times per lint."""
    g = _shared.get(index)
    if g is None:
        g = _shared[index] = CallGraph(index)
    return g


@dataclass
class ClassInfo:
    name: str
    relpath: str
    bases: list[str] = field(default_factory=list)
    methods: dict[str, ast.FunctionDef] = field(default_factory=dict)
    #: lock attr -> [(relpath, ctor line)] (several on rebind)
    lock_attrs: dict[str, list[tuple[str, int]]] = field(default_factory=dict)
    #: attr -> package class name it is assigned an instance of
    attr_types: dict[str, str] = field(default_factory=dict)


class CallGraph:
    def __init__(self, index: PackageIndex):
        self.index = index
        self.classes: dict[str, ClassInfo] = {}
        self.mod_funcs: dict[tuple[str, str], ast.FunctionDef] = {}
        self._funcs_by_name: dict[str, list[tuple[str, ast.FunctionDef]]] = {}
        #: instance name -> class name (module-level singletons)
        self.global_instances: dict[str, str] = {}
        #: module-level lock name -> lock key
        self.module_locks: dict[str, str] = {}
        self.module_lock_sites: dict[str, list[tuple[str, int]]] = {}
        #: relpath -> {local name -> module relpath} (module aliases)
        self.module_aliases: dict[str, dict[str, str]] = {}
        self._collect()

    # -- pass 1: tables ---------------------------------------------------

    def _collect(self) -> None:
        for f in self.index.files:
            self.module_aliases[f.relpath] = {}
            for node in f.tree.body:
                self._collect_top(f.relpath, node)
        # second sweep: module instances may refer to classes defined in
        # other files (imported names) — resolve after all classes known
        for f in self.index.files:
            for node in f.tree.body:
                if isinstance(node, ast.Assign) and isinstance(
                    node.value, ast.Call
                ):
                    fn = node.value.func
                    cls = (
                        fn.id
                        if isinstance(fn, ast.Name) and fn.id in self.classes
                        else None
                    )
                    if cls:
                        for t in node.targets:
                            if isinstance(t, ast.Name):
                                self.global_instances[t.id] = cls

    def _collect_top(self, relpath: str, node: ast.stmt) -> None:
        if isinstance(node, ast.ClassDef):
            self._collect_class(relpath, node)
        elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            self.mod_funcs[(relpath, node.name)] = node
            self._funcs_by_name.setdefault(node.name, []).append(
                (relpath, node)
            )
        elif isinstance(node, ast.Assign):
            kind = lock_ctor_name(node.value)
            for t in node.targets:
                if not isinstance(t, ast.Name):
                    continue
                if kind is not None:
                    key = f"{relpath}:{t.id}"
                    self.module_locks[t.id] = key
                    self.module_lock_sites.setdefault(key, []).append(
                        (relpath, node.value.lineno)
                    )
        elif isinstance(node, (ast.Import, ast.ImportFrom)):
            self._collect_import(relpath, node)

    def _collect_import(self, relpath: str, node: ast.stmt) -> None:
        # map "from <pkg>.kv import store as kv_store" and
        # "from <pkg>.utils import trace" to module relpaths so
        # `kv_store.push(...)` resolves to a function body; <pkg> is the
        # analysed tree's own name, so either package's tree resolves
        pkg = self.index.package
        if isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                dotted = f"{node.module}.{a.name}"
                rel = self._module_rel(dotted, pkg)
                if rel is not None:
                    self.module_aliases[relpath][a.asname or a.name] = rel
        elif isinstance(node, ast.Import):
            for a in node.names:
                rel = self._module_rel(a.name, pkg)
                if rel is not None:
                    self.module_aliases[relpath][
                        a.asname or a.name.split(".")[-1]
                    ] = rel

    def _module_rel(self, dotted: str, pkg: str) -> str | None:
        if not dotted.startswith(pkg + "."):
            return None
        rel = dotted[len(pkg) + 1 :].replace(".", "/") + ".py"
        return rel if self.index.get(rel) is not None else None

    def _collect_class(self, relpath: str, node: ast.ClassDef) -> None:
        info = ClassInfo(
            name=node.name,
            relpath=relpath,
            bases=[b.id for b in node.bases if isinstance(b, ast.Name)],
        )
        for item in node.body:
            if isinstance(item, (ast.FunctionDef, ast.AsyncFunctionDef)):
                info.methods[item.name] = item
        # self.X = threading.Lock() / self.Y = SomeClass(...) anywhere in
        # the class body (constructed outside __init__ too)
        for sub in ast.walk(node):
            if not isinstance(sub, ast.Assign):
                continue
            for t in sub.targets:
                if not (
                    isinstance(t, ast.Attribute)
                    and isinstance(t.value, ast.Name)
                    and t.value.id == "self"
                ):
                    continue
                if lock_ctor_name(sub.value) is not None:
                    info.lock_attrs.setdefault(t.attr, []).append(
                        (relpath, sub.value.lineno)
                    )
                elif isinstance(sub.value, ast.Call) and isinstance(
                    sub.value.func, ast.Name
                ):
                    info.attr_types[t.attr] = sub.value.func.id
        self.classes[node.name] = info

    # -- resolution -------------------------------------------------------

    def mro(self, cls_name: str) -> list[ClassInfo]:
        out: list[ClassInfo] = []
        seen: set[str] = set()
        stack = [cls_name]
        while stack:
            n = stack.pop(0)
            if n in seen or n not in self.classes:
                continue
            seen.add(n)
            info = self.classes[n]
            out.append(info)
            stack.extend(info.bases)
        return out

    def resolve_method(self, cls_name: str, mname: str) -> OwnerKey | None:
        for info in self.mro(cls_name):
            if mname in info.methods:
                return ("m", info.name, mname)
        return None

    def lock_attr_key(self, cls_name: str, attr: str) -> str | None:
        """``self.<attr>`` in class ``cls_name`` -> defining-class lock
        key ("RpcClient._cv") or None."""
        for info in self.mro(cls_name):
            if attr in info.lock_attrs:
                return f"{info.name}.{attr}"
        return None

    def lock_sites(self, key: str) -> list[tuple[str, int]]:
        if ":" in key:
            return self.module_lock_sites.get(key, [])
        cls, attr = key.split(".", 1)
        info = self.classes.get(cls)
        return info.lock_attrs.get(attr, []) if info else []

    def all_lock_keys(self) -> dict[str, list[tuple[str, int]]]:
        out = dict(self.module_lock_sites)
        for info in self.classes.values():
            for attr, sites in info.lock_attrs.items():
                out[f"{info.name}.{attr}"] = list(sites)
        return out

    def callees(
        self, relpath: str, cls_name: str | None, call: ast.Call
    ) -> list[OwnerKey]:
        fn = call.func
        aliases = self.module_aliases.get(relpath, {})
        if isinstance(fn, ast.Name):
            if fn.id in self.classes:
                r = self.resolve_method(fn.id, "__init__")
                return [r] if r else []
            if (relpath, fn.id) in self.mod_funcs:
                return [("f", relpath, fn.id)]
            cands = self._funcs_by_name.get(fn.id, [])
            if len(cands) == 1:  # imported plain function, unique name
                return [("f", cands[0][0], fn.id)]
            return []
        if not isinstance(fn, ast.Attribute):
            return []
        recv = fn.value
        if isinstance(recv, ast.Name):
            if recv.id == "self" and cls_name is not None:
                r = self.resolve_method(cls_name, fn.attr)
                return [r] if r else []
            if recv.id in self.global_instances:
                r = self.resolve_method(self.global_instances[recv.id], fn.attr)
                return [r] if r else []
            if recv.id in aliases:  # module alias: kv_store.push(...)
                mod = aliases[recv.id]
                if (mod, fn.attr) in self.mod_funcs:
                    return [("f", mod, fn.attr)]
            return []
        if (
            isinstance(recv, ast.Attribute)
            and isinstance(recv.value, ast.Name)
            and recv.value.id == "self"
            and cls_name is not None
        ):
            # self.attr.m(): look the attr's class up in the MRO
            for info in self.mro(cls_name):
                t = info.attr_types.get(recv.attr)
                if t is not None and t in self.classes:
                    r = self.resolve_method(t, fn.attr)
                    return [r] if r else []
        return []

    # -- pass 2: transitive summaries ------------------------------------

    def summarize(
        self,
        direct: Callable[[OwnerKey, str, str | None, ast.AST], Any],
        merge: Callable[[Any, Any], Any],
        bottom: Callable[[], Any],
    ) -> dict[OwnerKey, Any]:
        """Fixpoint of per-function facts folded through the call graph.
        ``direct(owner, relpath, cls_name, fndef)`` seeds each function;
        callee facts merge in until stable."""
        bodies: dict[OwnerKey, tuple[str, str | None, ast.AST]] = {}
        for (relpath, fname), fndef in self.mod_funcs.items():
            bodies[("f", relpath, fname)] = (relpath, None, fndef)
        for info in self.classes.values():
            for mname, fndef in info.methods.items():
                bodies[("m", info.name, mname)] = (
                    info.relpath, info.name, fndef,
                )
        facts = {
            k: direct(k, rp, cn, fd) for k, (rp, cn, fd) in bodies.items()
        }
        call_edges: dict[OwnerKey, list[OwnerKey]] = {}
        for k, (rp, cn, fd) in bodies.items():
            edges = []
            for sub in ast.walk(fd):
                if isinstance(sub, ast.Call):
                    edges.extend(self.callees(rp, cn, sub))
            call_edges[k] = edges
        changed = True
        while changed:
            changed = False
            for k, edges in call_edges.items():
                cur = facts[k]
                for e in edges:
                    if e in facts:
                        nxt = merge(cur, facts[e])
                        if nxt != cur:
                            cur = nxt
                if cur != facts[k]:
                    facts[k] = cur
                    changed = True
        return facts
