"""Checker ``lock-order``: static lock-acquisition graph, cycles rejected.

Every ``with <lock>`` nest (directly, or through a call to a method /
known singleton / constructor whose transitive summary acquires a lock)
contributes a directed edge *held -> acquired*. A cycle in that graph is
a potential deadlock — two threads walking the cycle from different
entry points park on each other forever — and fails the build.

Lock identity is the DEFINING class attribute (``RpcClient._cv``,
``ShardServer._lock``) or ``<relpath>:<name>`` for module-level locks,
so the same discipline is enforced across files. The derived graph (and
each lock's construction sites) also feeds the runtime witness
(analysis/witness.py): an execution that acquires locks against a
statically-known edge raises immediately, with the offending pair named.
"""

from __future__ import annotations

import ast
from dataclasses import dataclass, field

from parameter_server_tpu_torch.analysis.callgraph import (
    CallGraph,
    OwnerKey,
    shared_callgraph,
)
from parameter_server_tpu_torch.analysis.core import (
    Finding,
    HeldLockWalker,
    PackageIndex,
    iter_functions,
)


@dataclass
class LockGraph:
    #: (held_key, acquired_key) -> first site witnessing the edge
    edges: dict[tuple[str, str], tuple[str, int]] = field(default_factory=dict)
    #: lock key -> [(relpath, construction line)]
    sites: dict[str, list[tuple[str, int]]] = field(default_factory=dict)

    def add(self, a: str, b: str, site: tuple[str, int]) -> None:
        if a != b:  # same-key nesting is re-entrancy, not ordering
            self.edges.setdefault((a, b), site)

    def cycles(self) -> list[tuple[list[str], tuple[str, int]]]:
        """Every distinct cycle (as a key path a -> ... -> a), with the
        site of the edge closing it."""
        adj: dict[str, list[str]] = {}
        for a, b in self.edges:
            adj.setdefault(a, []).append(b)
        out: list[tuple[list[str], tuple[str, int]]] = []
        seen_cycles: set[frozenset[str]] = set()

        def dfs(start: str, node: str, path: list[str], on_path: set[str]) -> None:
            for nxt in adj.get(node, ()):  # noqa: B007
                if nxt == start:
                    key = frozenset(path)
                    if key not in seen_cycles:
                        seen_cycles.add(key)
                        out.append(
                            (path + [start], self.edges[(node, start)])
                        )
                elif nxt not in on_path and nxt > start:
                    # only walk keys ordered after the start: each cycle
                    # is found once, from its smallest key
                    dfs(start, nxt, path + [nxt], on_path | {nxt})

        for start in sorted(adj):
            dfs(start, start, [start], {start})
        return out


class _EdgeWalker(HeldLockWalker):
    def __init__(
        self,
        graph: CallGraph,
        out: LockGraph,
        relpath: str,
        cls_name: str | None,
        summaries: dict[OwnerKey, frozenset[str]],
    ):
        super().__init__(self._lock_key)
        self._graph = graph
        self._out = out
        self._relpath = relpath
        self._cls = cls_name
        self._summaries = summaries

    def _lock_key(self, expr: ast.AST) -> str | None:
        g = self._graph
        if (
            isinstance(expr, ast.Attribute)
            and isinstance(expr.value, ast.Name)
            and expr.value.id == "self"
            and self._cls is not None
        ):
            return g.lock_attr_key(self._cls, expr.attr)
        if isinstance(expr, ast.Name):
            return g.module_locks.get(expr.id)
        return None

    def on_acquire(self, key: str, held: list, line: int) -> None:
        for h, _, _ in held:
            self._out.add(h, key, (self._relpath, line))

    def on_call(self, node: ast.Call, held: list) -> None:
        if not held:
            return
        acquired: set[str] = set()
        for callee in self._graph.callees(self._relpath, self._cls, node):
            acquired |= self._summaries.get(callee, frozenset())
        for key in acquired:
            for h, _, _ in held:
                self._out.add(h, key, (self._relpath, node.lineno))


def _direct_locks(
    graph: CallGraph,
) -> "dict[OwnerKey, frozenset[str]]":
    """Transitive may-acquire summary per function."""

    def direct(owner: OwnerKey, relpath: str, cls_name, fndef) -> frozenset[str]:
        keys: set[str] = set()

        class _Collect(HeldLockWalker):
            def __init__(self) -> None:
                super().__init__(self._lock_key)

            def _lock_key(self, expr: ast.AST) -> str | None:
                if (
                    isinstance(expr, ast.Attribute)
                    and isinstance(expr.value, ast.Name)
                    and expr.value.id == "self"
                    and cls_name is not None
                ):
                    return graph.lock_attr_key(cls_name, expr.attr)
                if isinstance(expr, ast.Name):
                    return graph.module_locks.get(expr.id)
                return None

            def on_acquire(self, key: str, held: list, line: int) -> None:
                keys.add(key)

            def on_call(self, node: ast.Call, held: list) -> None:
                pass

        _Collect().walk_function(fndef)
        return frozenset(keys)

    return graph.summarize(
        direct=direct,
        merge=lambda a, b: a | b,
        bottom=frozenset,
    )


def build_lock_graph(
    index: PackageIndex, graph: CallGraph | None = None
) -> LockGraph:
    graph = graph or shared_callgraph(index)
    out = LockGraph(sites=graph.all_lock_keys())
    summaries = _direct_locks(graph)
    for f in index.files:
        for cls_name, fndef in iter_functions(f.tree):
            _EdgeWalker(graph, out, f.relpath, cls_name, summaries).walk_function(
                fndef
            )
    return out


def check_lock_order(index: PackageIndex) -> list[Finding]:
    lg = build_lock_graph(index)
    out: list[Finding] = []
    for path, site in lg.cycles():
        rel, line = site
        out.append(Finding(
            "lock-order", rel, line,
            "lock acquisition cycle: " + " -> ".join(path)
            + " (two threads entering this cycle at different points "
            "deadlock); break the cycle or invert one nesting",
        ))
    return out
