"""Checker ``settle-exactly-once``: DeferredReply settlement on all paths.

The batched apply engine's contract is that 'reply sent' means 'side
effect durable': a handler returns ``DeferredReply(future)`` and the
serving loop parks the reply until the apply thread resolves the future.
That contract has two static obligations this checker enforces:

1. **Creation**: a ``DeferredReply(...)`` must be RETURNED to the RPC
   layer (directly, or via a name that reaches a ``return``). A deferred
   reply constructed and dropped is a client parked forever — no one
   else holds the future's consumer side.

2. **Settlement**: a function that accumulates deferred replies (a local
   list whose name contains ``deferred``, paired with a local helper
   whose name contains ``settle``) must settle on EVERY exit path,
   exception edges included. Concretely: either the function drains the
   deferred list in a ``finally`` (covering every edge at once), or
   every ``return`` after the first accumulation is preceded, in its own
   block, by a call to the settle helper. A bare ``return`` inside an
   ``except`` handler is exactly the edge that silently strands a parked
   apply — the bug class this checker exists for.
"""

from __future__ import annotations

import ast

from parameter_server_tpu_torch.analysis.core import (
    Finding,
    PackageIndex,
    iter_functions,
)


def _contains_call_to(node: ast.AST, names: set[str]) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Call):
            fn = sub.func
            if isinstance(fn, ast.Name) and fn.id in names:
                return True
            if isinstance(fn, ast.Attribute) and fn.attr in names:
                return True
    return False


def _mentions_name(node: ast.AST, names: set[str]) -> bool:
    for sub in ast.walk(node):
        if isinstance(sub, ast.Name) and sub.id in names:
            return True
    return False


def _check_creation(
    relpath: str, fndef: ast.FunctionDef, out: list[Finding]
) -> None:
    returned_names: set[str] = set()
    returned_calls: set[int] = set()
    for sub in ast.walk(fndef):
        if isinstance(sub, ast.Return) and sub.value is not None:
            for x in ast.walk(sub.value):
                if isinstance(x, ast.Name):
                    returned_names.add(x.id)
                if isinstance(x, ast.Call):
                    returned_calls.add(id(x))
    for sub in ast.walk(fndef):
        if not (
            isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Name)
            and sub.func.id == "DeferredReply"
        ):
            continue
        if id(sub) in returned_calls:
            continue
        # assigned to a name that some return mentions?
        assigned_ok = False
        for st in ast.walk(fndef):
            if isinstance(st, ast.Assign) and any(
                id(c) == id(sub) for c in ast.walk(st.value)
            ):
                for t in st.targets:
                    if isinstance(t, ast.Name) and t.id in returned_names:
                        assigned_ok = True
        if not assigned_ok:
            out.append(Finding(
                "settle-exactly-once", relpath, sub.lineno,
                "DeferredReply constructed but never returned to the RPC "
                "layer: its future has no consumer and the caller parks "
                "forever",
            ))


def _settle_returns(
    relpath: str, fndef: ast.FunctionDef, out: list[Finding]
) -> None:
    # local deferred-accumulator lists + local settle helpers
    deferred_names = set()
    for sub in ast.walk(fndef):
        targets: list[ast.expr] = []
        if isinstance(sub, ast.Assign) and isinstance(
            sub.value, (ast.List, ast.ListComp)
        ):
            targets = sub.targets
        elif isinstance(sub, ast.AnnAssign) and isinstance(
            sub.value, (ast.List, ast.ListComp)
        ):
            targets = [sub.target]
        for t in targets:
            if isinstance(t, ast.Name) and "deferred" in t.id:
                deferred_names.add(t.id)
    settle_names = {
        sub.name
        for sub in ast.walk(fndef)
        if isinstance(sub, ast.FunctionDef) and "settle" in sub.name
    }
    if not deferred_names or not settle_names:
        return
    first_append = min(
        (
            sub.lineno
            for sub in ast.walk(fndef)
            if isinstance(sub, ast.Call)
            and isinstance(sub.func, ast.Attribute)
            and sub.func.attr == "append"
            and isinstance(sub.func.value, ast.Name)
            and sub.func.value.id in deferred_names
        ),
        default=None,
    )
    if first_append is None:
        return
    # finally-coverage: a finally that settles (or drains the list)
    # covers every exit edge at once
    for sub in ast.walk(fndef):
        if isinstance(sub, ast.Try) and sub.finalbody:
            fin = ast.Module(body=sub.finalbody, type_ignores=[])
            if _contains_call_to(fin, settle_names) or _mentions_name(
                fin, deferred_names
            ):
                return
    # no blanket coverage: every return past the first accumulation must
    # be locally preceded by a settle call

    def scan_block(body: list[ast.stmt]) -> None:
        for i, stmt in enumerate(body):
            if isinstance(stmt, ast.FunctionDef):
                continue  # helpers check their own bodies
            if (
                isinstance(stmt, ast.Return)
                and stmt.lineno > first_append
            ):
                prefix = ast.Module(body=body[:i], type_ignores=[])
                if not _contains_call_to(prefix, settle_names):
                    out.append(Finding(
                        "settle-exactly-once", relpath, stmt.lineno,
                        "exit path returns without settling deferred "
                        "replies (no settle call on this edge and no "
                        "finally drains the list): a parked apply's "
                        "reply — or its error — is silently dropped",
                    ))
                continue
            # recurse into nested statement blocks
            for attr in ("body", "orelse", "finalbody"):
                sub_body = getattr(stmt, attr, None)
                if isinstance(sub_body, list) and sub_body and isinstance(
                    sub_body[0], ast.stmt
                ):
                    scan_block(sub_body)
            for h in getattr(stmt, "handlers", []):
                scan_block(h.body)

    scan_block(fndef.body)


def check_settle_exactly_once(index: PackageIndex) -> list[Finding]:
    out: list[Finding] = []
    for f in index.files:
        if f.relpath.startswith("analysis/"):
            continue
        for _cls, fndef in iter_functions(f.tree):
            _check_creation(f.relpath, fndef, out)
            _settle_returns(f.relpath, fndef, out)
    return out
