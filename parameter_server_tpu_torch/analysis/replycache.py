"""Checker ``replycache-contract``: the reply-cache exemption sets stay
consistent with the commands each server actually serves.

``RpcServer``'s exactly-once machinery is driven by per-construction-site
command inventories: ``idempotent_cmds`` (resends BYPASS the reply cache —
re-apply beats pinning a model-sized reply), ``blocking_cmds`` (coalesced
replies must flush before dispatch parks the thread) and ``prio_cmds``
(reply lane routing). Those sets are string literals, and the commands a
handler serves are another inventory entirely (``_cmd_<name>`` methods on
the coordinator, ``cmd == "<name>"`` dispatch in the shard server) — so a
renamed or removed command silently leaves a STALE exemption behind, and
the failure is behavioral, not syntactic: a command that used to bypass
the reply cache starts getting its (possibly multi-MiB) replies pinned,
or a blocking command stops flushing withheld replies before parking.

This checker derives both inventories from the AST and flags the drift,
in both directions:

- every command named in an ``idempotent_cmds`` / ``blocking_cmds`` /
  ``prio_cmds`` literal at an ``RpcServer(...)`` construction site must
  be a command the constructing class's handler actually serves;
- every served command must carry a compact id in the wire's append-only
  ``_CMD_IDS`` table (else the binary header codec silently degrades
  that command to string-cmd framing forever — a new command must be
  registered, ids are wire contract).

Like the counter/config contracts, the inventories are DERIVED — there
is no hand-maintained list for this checker to drift from.
"""

from __future__ import annotations

import ast

from parameter_server_tpu_torch.analysis.core import Finding, PackageIndex

Sites = list[tuple[str, int]]

#: RpcServer keywords holding command-name inventories
_SET_KEYWORDS = ("idempotent_cmds", "blocking_cmds", "prio_cmds")


def _strings_in(node: ast.AST) -> set[str]:
    return {
        sub.value
        for sub in ast.walk(node)
        if isinstance(sub, ast.Constant) and isinstance(sub.value, str)
    }


def _is_cmd_expr(expr: ast.AST) -> bool:
    """Does ``expr`` read the dispatched command? Matches the package's
    dispatch idioms: a ``cmd`` local, ``h["cmd"]`` / ``header["cmd"]``
    subscripts, and ``.cmd`` attributes."""
    if isinstance(expr, ast.Name):
        return expr.id == "cmd" or expr.id.endswith("_cmd")
    if isinstance(expr, ast.Subscript):
        s = expr.slice
        return isinstance(s, ast.Constant) and s.value == "cmd"
    if isinstance(expr, ast.Attribute):
        return expr.attr == "cmd"
    return False


def served_cmds(cls: ast.ClassDef) -> set[str]:
    """Commands a handler class serves: ``_cmd_<name>`` methods plus
    string literals equality-compared against the dispatched command."""
    out: set[str] = set()
    for node in cls.body:
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
            if node.name.startswith("_cmd_"):
                out.add(node.name[len("_cmd_"):])
    for sub in ast.walk(cls):
        if not isinstance(sub, ast.Compare) or len(sub.ops) != 1:
            continue
        if not isinstance(sub.ops[0], ast.Eq):
            continue
        left, right = sub.left, sub.comparators[0]
        lit = None
        if isinstance(right, ast.Constant) and isinstance(right.value, str):
            if _is_cmd_expr(left):
                lit = right.value
        elif isinstance(left, ast.Constant) and isinstance(left.value, str):
            if _is_cmd_expr(right):
                lit = left.value
        if lit is not None:
            out.add(lit)
    return out


def declared_sets(
    cls: ast.ClassDef,
) -> list[tuple[str, set[str], int]]:
    """``(keyword, names, line)`` for every command inventory passed to
    an ``RpcServer(...)`` construction inside ``cls``."""
    out: list[tuple[str, set[str], int]] = []
    for sub in ast.walk(cls):
        if not isinstance(sub, ast.Call):
            continue
        fn = sub.func
        name = fn.id if isinstance(fn, ast.Name) else (
            fn.attr if isinstance(fn, ast.Attribute) else ""
        )
        if not name.endswith("RpcServer"):
            continue
        for kw in sub.keywords:
            if kw.arg in _SET_KEYWORDS:
                out.append((kw.arg, _strings_in(kw.value), sub.lineno))
    return out


def cmd_id_inventory(index: PackageIndex) -> set[str] | None:
    """Every command name registered in a ``_CMD_IDS`` assignment in the
    analyzed tree (None when the tree defines no such table — snippet
    indexes without a wire module skip the id check)."""
    found = None
    for f in index.files:
        for node in ast.walk(f.tree):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            if node.value is None:
                continue
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "_CMD_IDS":
                    found = (found or set()) | _strings_in(node.value)
    return found


def check_replycache_contract(index: PackageIndex) -> list[Finding]:
    cmd_ids = cmd_id_inventory(index)
    out: list[Finding] = []
    for f in index.files:
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.ClassDef):
                continue
            decls = declared_sets(node)
            if not decls:
                continue  # not a server-owning class
            served = served_cmds(node)
            if not served:
                continue  # handler lives elsewhere (generic RpcServer use)
            for kw, names, line in decls:
                for name in sorted(names - served):
                    out.append(Finding(
                        "replycache-contract", f.relpath, line,
                        f"{kw} names {name!r} but {node.name}'s handler "
                        "serves no such command — a stale entry here "
                        "silently changes reply-cache/flush behavior "
                        "for a command that no longer exists",
                    ))
            if cmd_ids is not None:
                for name in sorted(served - cmd_ids):
                    out.append(Finding(
                        "replycache-contract", f.relpath, node.lineno,
                        f"{node.name} serves {name!r} but _CMD_IDS has "
                        "no compact id for it — the binary header codec "
                        "degrades this command to string-cmd framing; "
                        "register it (ids are append-only wire contract)",
                    ))
    return out
