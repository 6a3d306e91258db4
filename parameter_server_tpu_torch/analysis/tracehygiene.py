"""Checker ``trace-hygiene``: spans only via their context manager.

The tracer's invariant is that every span that begins also ends — the
ring buffer and the Perfetto export assume balanced B/E events, and an
unclosed span corrupts every enclosing span's nesting for its thread. In
this codebase that invariant is carried entirely by ``with
trace.span(...)``: there is deliberately NO public begin/end API. The
checker enforces the idiom: any ``*.span(...)`` call that is not a
``with`` context item (and any direct ``Span(...)``
construction outside utils/trace.py itself) is a bare begin whose end
depends on control flow the tracer can't see.
"""

from __future__ import annotations

import ast

from parameter_server_tpu_torch.analysis.core import Finding, PackageIndex

#: the implementation itself builds spans by hand
_IMPL = "utils/trace.py"


def check_trace_hygiene(index: PackageIndex) -> list[Finding]:
    out: list[Finding] = []
    for f in index.files:
        if f.relpath == _IMPL or f.relpath.startswith("analysis/"):
            continue
        with_items: set[int] = set()
        decorated: set[int] = set()
        for node in ast.walk(f.tree):
            if isinstance(node, (ast.With, ast.AsyncWith)):
                for item in node.items:
                    for sub in ast.walk(item.context_expr):
                        if isinstance(sub, ast.Call):
                            with_items.add(id(sub))
            elif isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                for dec in node.decorator_list:
                    for sub in ast.walk(dec):
                        if isinstance(sub, ast.Call):
                            decorated.add(id(sub))
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if (
                isinstance(fn, ast.Attribute)
                and fn.attr == "span"
                and id(node) not in with_items
                and id(node) not in decorated
            ):
                out.append(Finding(
                    "trace-hygiene", f.relpath, node.lineno,
                    "bare span(...) call outside a with statement: a span "
                    "opened without its context manager has no guaranteed "
                    "end event (use `with trace.span(...)`)",
                ))
            elif (
                isinstance(fn, ast.Name)
                and fn.id == "Span"
            ):
                out.append(Finding(
                    "trace-hygiene", f.relpath, node.lineno,
                    "direct Span construction outside utils/trace.py: "
                    "spans must come from trace.span() so "
                    "begin/end stay paired",
                ))
    return out
