"""Checker ``flightrec-contract``: the flight-recorder event inventory
and the postmortem plane's event tables stay in lockstep.

A copy of the JAX package's ``analysis/flightreccontract.py``; the
recorder module is the analysed package's own ``utils.flightrec``.

``flightrec.record("<etype>", ...)`` call sites are scattered across
the wire, apply, clock, serving and heartbeat layers, and
``utils/postmortem.py`` interprets the dump stream with LITERAL etype
tables — the (cid, seq) stitcher, the anomaly detectors
(``apply.commit``, ``rcu.publish``, ``rpc.heal.*``, ``serve.shed``)
and the declared pass-through inventory ``_CONTEXT_EVENTS``. Both
sides are string literals, so a renamed event silently becomes an
anomaly detector that never fires again (a version-regression stream
the postmortem no longer reads is the expensive failure: the tooling
looks armed and is blind), and a new ``record()`` call the postmortem
plane never heard of is wreckage nobody will interpret.

Derived inventories, diffed both ways:

- **emitted**: every string the first argument of a
  ``flightrec.record(...)`` call (module alias or ``from ... import
  record``) can evaluate to — IfExp/BoolOp branches included;
- **known**: every etype literal ``utils/postmortem.py`` compares or
  membership-tests against an ``[\"etype\"]`` subscript, plus the
  ``_CONTEXT_EVENTS`` pass-through inventory, plus every
  ``EVENTS`` frozenset a streaming monitor declares in
  ``analysis/monitors.py`` — the postmortem's protocol detectors ARE
  those monitors now, so the registry's consumed-event sets are the
  detector tables.

An emitted event the postmortem doesn't know is a finding at the
``record`` call site (add it to a detector or to ``_CONTEXT_EVENTS`` —
deliberately, in review); a known/stitched name nobody emits is a
finding at the postmortem table (the rename drift). Skipped entirely
for trees without ``utils/postmortem.py`` (snippet indexes opt in by
providing one).
"""

from __future__ import annotations

import ast

from parameter_server_tpu_torch.analysis.core import Finding, PackageIndex

#: the recorder module, relative to the analysed package (whose dotted
#: name is the index's own: ``<package>.utils.flightrec``)
_FLIGHTREC_SUBMOD = "utils.flightrec"
_POSTMORTEM_REL = "utils/postmortem.py"


def _str_consts(expr: ast.AST) -> set[str]:
    return {
        n.value
        for n in ast.walk(expr)
        if isinstance(n, ast.Constant) and isinstance(n.value, str)
    }


def _record_aliases(
    tree: ast.Module, flightrec_mod: str
) -> tuple[set[str], set[str]]:
    """(module aliases of utils.flightrec, local names bound to its
    ``record``) for one file; ``flightrec_mod`` is the recorder's dotted
    name in the analysed package."""
    mods: set[str] = set()
    funcs: set[str] = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.ImportFrom) and node.module:
            for a in node.names:
                dotted = f"{node.module}.{a.name}"
                if dotted == flightrec_mod:
                    mods.add(a.asname or a.name)
                elif node.module == flightrec_mod and a.name == "record":
                    funcs.add(a.asname or a.name)
        elif isinstance(node, ast.Import):
            for a in node.names:
                if a.name == flightrec_mod:
                    # `import pkg.utils.flightrec as fr` binds fr;
                    # the PLAIN form binds only the top-level package,
                    # so calls arrive as the full dotted chain
                    mods.add(a.asname if a.asname else a.name)
    return mods, funcs


def _dotted_name(expr: ast.AST) -> str | None:
    """Flatten ``a.b.c`` attribute chains to ``"a.b.c"`` (None when the
    chain roots in anything but a bare name)."""
    parts: list[str] = []
    while isinstance(expr, ast.Attribute):
        parts.append(expr.attr)
        expr = expr.value
    if isinstance(expr, ast.Name):
        parts.append(expr.id)
        return ".".join(reversed(parts))
    return None


def emitted_events(index: PackageIndex) -> dict[str, list[tuple[str, int]]]:
    """etype -> [(relpath, line)] over every ``record`` call site in
    the tree (inside flightrec.py itself, bare ``record(...)`` calls
    count — the module calls its own entry point from the crash
    hooks)."""
    out: dict[str, list[tuple[str, int]]] = {}
    flightrec_mod = f"{index.package}.{_FLIGHTREC_SUBMOD}"
    for f in index.files:
        mods, funcs = _record_aliases(f.tree, flightrec_mod)
        if f.relpath == _POSTMORTEM_REL:
            continue  # the consumer: reads events, never emits
        if f.relpath == _FLIGHTREC_REL:
            funcs = funcs | {"record"}
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call) or not node.args:
                continue
            fn = node.func
            hit = (
                isinstance(fn, ast.Attribute)
                and fn.attr == "record"
                and _dotted_name(fn.value) in mods
            ) or (isinstance(fn, ast.Name) and fn.id in funcs)
            if not hit:
                continue
            for name in _str_consts(node.args[0]):
                out.setdefault(name, []).append((f.relpath, node.lineno))
    return out


_FLIGHTREC_REL = "utils/flightrec.py"


def _is_etype_expr(expr: ast.AST) -> bool:
    """``ev["etype"]`` / ``e["etype"]``-shaped subscripts (the
    postmortem's normalized event dicts)."""
    return (
        isinstance(expr, ast.Subscript)
        and isinstance(expr.slice, ast.Constant)
        and expr.slice.value == "etype"
    )


_MONITORS_REL = "analysis/monitors.py"


def _monitor_declared_events(
    index: PackageIndex,
) -> dict[str, list[tuple[str, int]]]:
    """etype -> sites for every ``EVENTS = frozenset({...})`` a
    streaming monitor declares: the monitors are the
    postmortem's detectors, so their consumed sets count as known."""
    mf = index.get(_MONITORS_REL)
    out: dict[str, list[tuple[str, int]]] = {}
    if mf is None:
        return out
    for node in ast.walk(mf.tree):
        if not isinstance(node, (ast.Assign, ast.AnnAssign)):
            continue
        targets = (
            node.targets if isinstance(node, ast.Assign) else [node.target]
        )
        if node.value is None:
            continue
        for t in targets:
            if isinstance(t, ast.Name) and t.id == "EVENTS":
                for name in _str_consts(node.value):
                    out.setdefault(name, []).append(
                        (_MONITORS_REL, node.lineno)
                    )
    return out


def known_events(index: PackageIndex) -> dict[str, list[tuple[str, int]]]:
    """etype -> [(relpath, line)] the diagnostic plane handles: every
    literal compared/membership-tested against an etype subscript in
    the postmortem, the ``_CONTEXT_EVENTS`` inventory, and the
    streaming monitors' declared ``EVENTS`` sets."""
    pm = index.get(_POSTMORTEM_REL)
    out: dict[str, list[tuple[str, int]]] = _monitor_declared_events(index)
    if pm is None:
        return out
    for node in ast.walk(pm.tree):
        if isinstance(node, ast.Compare) and len(node.comparators) == 1:
            left, right = node.left, node.comparators[0]
            if isinstance(node.ops[0], (ast.Eq, ast.NotEq)):
                pair = (
                    (left, right) if _is_etype_expr(left)
                    else (right, left) if _is_etype_expr(right)
                    else None
                )
                if pair is not None:
                    for name in _str_consts(pair[1]):
                        out.setdefault(name, []).append(
                            (_POSTMORTEM_REL, node.lineno)
                        )
            elif isinstance(node.ops[0], (ast.In, ast.NotIn)):
                if _is_etype_expr(left):
                    for name in _str_consts(right):
                        out.setdefault(name, []).append(
                            (_POSTMORTEM_REL, node.lineno)
                        )
        elif isinstance(node, (ast.Assign, ast.AnnAssign)):
            targets = (
                node.targets if isinstance(node, ast.Assign)
                else [node.target]
            )
            if node.value is None:
                continue
            for t in targets:
                if isinstance(t, ast.Name) and t.id == "_CONTEXT_EVENTS":
                    for name in _str_consts(node.value):
                        out.setdefault(name, []).append(
                            (_POSTMORTEM_REL, node.lineno)
                        )
    return out


def check_flightrec_contract(index: PackageIndex) -> list[Finding]:
    if index.get(_POSTMORTEM_REL) is None:
        return []  # no postmortem plane in this tree (snippet index)
    emitted = emitted_events(index)
    known = known_events(index)
    out: list[Finding] = []
    for name in sorted(set(emitted) - set(known)):
        relpath, line = emitted[name][0]
        out.append(Finding(
            "flightrec-contract", relpath, line,
            f"flight-recorder event {name!r} is emitted but the "
            "postmortem plane has never heard of it — wire it into an "
            "anomaly detector/stitch table or declare it in "
            "utils/postmortem.py _CONTEXT_EVENTS (deliberately, in "
            "review), or the wreckage it records will never be "
            "interpreted",
        ))
    for name in sorted(set(known) - set(emitted)):
        relpath, line = known[name][0]
        out.append(Finding(
            "flightrec-contract", relpath, line,
            f"the postmortem plane stitches/flags event {name!r} but "
            "no record() call emits it — the detector can never fire "
            "again (renamed or deleted event?); this is the silent "
            "failure mode of the whole diagnostic plane",
        ))
    return out
