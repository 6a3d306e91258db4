"""pslint core: package loading, findings, suppressions, the runner.

A copy of the JAX package's ``analysis/core.py``; the analysed root
defaults to this package, and an index knows the dotted package name its
tree is imported under (``PackageIndex.package``), so the same analyzer
reads either package's tree.

The analyzer is project-native: checkers encode THIS codebase's
concurrency and contract invariants (lock ordering, no blocking calls
under a lock, DeferredReply settlement, counter/config inventories,
trace span hygiene) instead of generic style rules. Each checker is a
function ``(PackageIndex) -> list[Finding]`` registered in
``analysis/__init__.py``; adding a checker to a later PR is one module
plus one registry line.

Suppressions are explicit and audited:

- file:line pragma — ``# psl: ignore[<checker>]: <justification>`` on
  the flagged line (or a standalone comment on the line directly
  above). The justification string is REQUIRED; a bare pragma is itself
  a finding (``pragma-hygiene``), so every silenced warning carries its
  reason in the diff forever.
- ``[tool.pslint]`` in pyproject.toml — ``exclude`` path globs and
  ``disable`` checker names for whole-tree policy.
"""

from __future__ import annotations

import ast
import fnmatch
import re
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any, Callable

#: package root of the code under analysis (the installed package dir)
PACKAGE_ROOT = Path(__file__).resolve().parent.parent


def package_name(root: Path) -> str:
    """The dotted name an analysed tree is imported under: its directory's
    name, or this package's own for an index with no named root (crafted
    in-memory sources)."""
    name = root.name
    return name if name.isidentifier() else PACKAGE_ROOT.name

_PRAGMA_RE = re.compile(
    r"#\s*psl:\s*ignore\[([a-z0-9_*,\s-]+)\]\s*(?::\s*(.*\S))?\s*$"
)


@dataclass(frozen=True)
class Finding:
    """One analyzer violation, pointing at a repo file:line."""

    checker: str
    path: str  # relative to the analyzed root
    line: int
    message: str

    def render(self) -> str:
        return f"{self.path}:{self.line}: [{self.checker}] {self.message}"


@dataclass
class Pragma:
    line: int  # the line the pragma SUPPRESSES (not where it sits)
    checkers: frozenset[str]  # {"*"} suppresses every checker
    justification: str
    pragma_line: int  # where the comment physically lives


@dataclass
class SourceFile:
    """One parsed module: AST + raw text + its suppression pragmas."""

    path: Path
    relpath: str
    text: str
    tree: ast.Module
    pragmas: dict[int, Pragma] = field(default_factory=dict)

    def line(self, lineno: int) -> str:
        lines = self.text.splitlines()
        return lines[lineno - 1] if 0 < lineno <= len(lines) else ""


@dataclass
class PslintConfig:
    """``[tool.pslint]`` policy (pyproject.toml)."""

    exclude: list[str] = field(default_factory=list)  # relpath globs
    disable: list[str] = field(default_factory=list)  # checker names
    #: checkers demoted to "warn" severity (tiered exit codes: errors
    #: exit 1, warn-only runs exit 2) — how a new analysis phases in
    #: without invalidating an error-gating CI baseline workflow
    warn: list[str] = field(default_factory=list)
    #: quantity-checker whitelists. Grammar (each entry one
    #: string, whitespace-tolerant):
    #:   unit-conversions:  "<fn_name> -> <unit>"  — a call to this
    #:       function returns a value of <unit> (us|ms|s|bytes|count|
    #:       clocks) whatever its arguments carry; this is how a
    #:       blessed conversion crosses the dimension lattice without a
    #:       finding (name-suffix inference covers helpers like
    #:       ``now_wall_us`` already — list only the exceptions).
    unit_conversions: list[str] = field(default_factory=list)
    #:   clock-clamps: "<fn_name>" — a declared skew boundary: clock-
    #:       domain mixing inside this function's body or anywhere in
    #:       its call arguments is sanctioned (extends the built-in
    #:       convention that any function whose name contains "clamp"
    #:       is a skew boundary).
    clock_clamps: list[str] = field(default_factory=list)
    #:   clock-foreign-keys: "<header_key>" — a wire/header field whose
    #:       value is a PEER's wall-clock timestamp (foreign-wall
    #:       domain; extends the built-in {"pts"}).
    clock_foreign_keys: list[str] = field(default_factory=list)

    @classmethod
    def load(cls, pyproject: Path | None) -> "PslintConfig":
        if pyproject is None or not pyproject.exists():
            return cls()
        from parameter_server_tpu_torch.utils.config import toml_module

        data = toml_module().loads(pyproject.read_text())
        sec = data.get("tool", {}).get("pslint", {})
        return cls(
            exclude=list(sec.get("exclude", [])),
            disable=list(sec.get("disable", [])),
            warn=list(sec.get("warn", [])),
            unit_conversions=list(sec.get("unit-conversions", [])),
            clock_clamps=list(sec.get("clock-clamps", [])),
            clock_foreign_keys=list(sec.get("clock-foreign-keys", [])),
        )


def _parse_pragmas(text: str) -> dict[int, Pragma]:
    """Map suppressed-line -> Pragma. A pragma trailing code suppresses
    its own line; a pragma on a comment-only line suppresses the NEXT
    line (for statements too long to share a line with their reason).

    Parsed from COMMENT tokens, not raw lines: a pragma-shaped string
    inside a docstring (this package documents its own grammar) is
    prose, not a suppression — the line-regex form silently treated it
    as one, which both confused the stale-pragma audit and could have
    let a docstring suppress a real finding on its own line."""
    import io
    import tokenize

    out: dict[int, Pragma] = {}
    lines = text.splitlines()
    try:
        tokens = list(tokenize.generate_tokens(io.StringIO(text).readline))
    except (tokenize.TokenError, IndentationError):  # pragma: no cover
        tokens = []
    for tok in tokens:
        if tok.type != tokenize.COMMENT:
            continue
        m = _PRAGMA_RE.search(tok.string)
        if m is None:
            continue
        i = tok.start[0]
        checkers = frozenset(
            c.strip() for c in m.group(1).split(",") if c.strip()
        )
        raw = lines[i - 1] if 0 < i <= len(lines) else ""
        target = i + 1 if raw.lstrip().startswith("#") else i
        out[target] = Pragma(
            line=target,
            checkers=checkers,
            justification=(m.group(2) or "").strip(),
            pragma_line=i,
        )
    return out


class PackageIndex:
    """Parsed view of every analyzed module, shared by all checkers.

    Every file is read and ``ast.parse``d exactly once, here — checkers
    only ever walk the trees this index already holds. The index also
    carries the :class:`PslintConfig` it was loaded under, because
    checkers receive nothing but the index and the quantity checkers
    (units/clockdomain/idtype) need the whitelist grammar from
    ``[tool.pslint]``.
    """

    def __init__(
        self,
        files: list[SourceFile],
        root: Path,
        config: PslintConfig | None = None,
    ):
        self.files = files
        self.root = root
        self.config = config or PslintConfig()
        #: the package name absolute imports in these files resolve against
        self.package = package_name(root)
        self._by_rel = {f.relpath: f for f in files}

    def get(self, relpath: str) -> SourceFile | None:
        return self._by_rel.get(relpath)

    @classmethod
    def from_sources(
        cls,
        sources: dict[str, str],
        root: Path | None = None,
        config: PslintConfig | None = None,
    ) -> "PackageIndex":
        """In-memory index (tests: crafted positive/negative snippets)."""
        files = [
            SourceFile(
                path=Path(rel),
                relpath=rel,
                text=src,
                tree=ast.parse(src, filename=rel),
                pragmas=_parse_pragmas(src),
            )
            for rel, src in sources.items()
        ]
        return cls(files, root or Path("."), config)


def load_package(
    root: Path | str = PACKAGE_ROOT, config: PslintConfig | None = None
) -> PackageIndex:
    root = Path(root)
    config = config or PslintConfig()
    files: list[SourceFile] = []
    for p in sorted(root.rglob("*.py")):
        rel = p.relative_to(root).as_posix()
        if any(fnmatch.fnmatch(rel, g) for g in config.exclude):
            continue
        text = p.read_text()
        files.append(
            SourceFile(
                path=p,
                relpath=rel,
                text=text,
                tree=ast.parse(text, filename=str(p)),
                pragmas=_parse_pragmas(text),
            )
        )
    return PackageIndex(files, root, config)


Checker = Callable[[PackageIndex], list[Finding]]


def check_pragma_hygiene(index: PackageIndex) -> list[Finding]:
    """A suppression without a justification is a violation: the pragma
    grammar REQUIRES ``# psl: ignore[checker]: why`` so silenced
    findings stay auditable in the diff."""
    out: list[Finding] = []
    for f in index.files:
        for pr in f.pragmas.values():
            if not pr.justification:
                out.append(Finding(
                    "pragma-hygiene", f.relpath, pr.pragma_line,
                    "pslint pragma without a justification string "
                    "(required form: # psl: ignore[<checker>]: <why>)",
                ))
            if not pr.checkers:
                out.append(Finding(
                    "pragma-hygiene", f.relpath, pr.pragma_line,
                    "pslint pragma names no checker",
                ))
    return out


def apply_suppressions(
    index: PackageIndex,
    findings: list[Finding],
    used: set[tuple[str, int]] | None = None,
) -> list[Finding]:
    """Drop pragma-suppressed findings. ``used`` (when given) collects
    the ``(relpath, pragma_line)`` of every pragma that actually
    suppressed something — the stale-pragma audit's input."""
    out = []
    for fi in findings:
        sf = index.get(fi.path)
        if sf is not None and fi.checker != "pragma-hygiene":
            pr = sf.pragmas.get(fi.line)
            if pr is not None and pr.justification and (
                "*" in pr.checkers or fi.checker in pr.checkers
            ):
                if used is not None:
                    used.add((fi.path, pr.pragma_line))
                continue
        out.append(fi)
    return out


def check_stale_pragma(index: PackageIndex) -> list[Finding]:
    """Registry placeholder: the audit needs every OTHER enabled
    checker's raw findings, so :func:`run_checkers` drives it (see
    ``stale_pragma_findings``). Running it standalone is vacuous."""
    return []


def stale_pragma_findings(
    index: PackageIndex,
    used: set[tuple[str, int]],
    enabled: set[str],
    full_registry: set[str],
) -> list[Finding]:
    """A justified pragma that no longer suppresses any finding is
    itself a finding: the code it excused was fixed or deleted, and a
    suppression that outlives its reason is a hole the next real
    violation walks through unnoticed. Audited conservatively: a pragma
    is only judged when every checker it names actually ran (``*``
    pragmas only under the full registry), so ``--checker`` subset runs
    can never flag a pragma whose checker they skipped. A checker name
    outside the registry is flagged unconditionally — a typo'd pragma
    never suppressed anything to begin with."""
    out: list[Finding] = []
    for f in index.files:
        for pr in f.pragmas.values():
            if not pr.justification or not pr.checkers:
                continue  # pragma-hygiene's findings, not stale ones
            if (f.relpath, pr.pragma_line) in used:
                continue
            unknown = sorted(
                c for c in pr.checkers
                if c != "*" and c not in full_registry
            )
            if unknown:
                out.append(Finding(
                    "stale-pragma", f.relpath, pr.pragma_line,
                    f"pragma names unknown checker(s) {unknown} — it "
                    "has never suppressed anything (typo?); known: "
                    + ", ".join(sorted(full_registry)),
                ))
                continue
            names = (
                full_registry if "*" in pr.checkers else set(pr.checkers)
            )
            if not names <= enabled:
                continue  # a named checker didn't run: can't judge
            out.append(Finding(
                "stale-pragma", f.relpath, pr.pragma_line,
                "stale pragma: # psl: ignore["
                + ",".join(sorted(pr.checkers))
                + "] suppresses no finding on its line — the code it "
                "excused is gone; delete the pragma so the suppression "
                "can't outlive its reason",
            ))
    return out


def run_checkers(
    index: PackageIndex,
    checkers: dict[str, Checker],
    config: PslintConfig | None = None,
) -> list[Finding]:
    """Run every enabled checker and apply pragma suppressions; the
    returned list is what gates CI (empty == clean). The stale-pragma
    audit runs last, over the suppression usage this run observed."""
    config = config or PslintConfig()
    findings: list[Finding] = []
    enabled: set[str] = set()
    for name, fn in checkers.items():
        if name in config.disable:
            continue
        enabled.add(name)
        if name == "stale-pragma":
            continue  # driven below, off the other checkers' output
        findings.extend(fn(index))
    used: set[tuple[str, int]] = set()
    findings = apply_suppressions(index, findings, used)
    if "stale-pragma" in enabled:
        from parameter_server_tpu_torch.analysis import CHECKERS

        stale = stale_pragma_findings(
            index, used, enabled, set(CHECKERS)
        )
        # stale findings are suppressible, but ONLY by a pragma naming
        # stale-pragma EXPLICITLY (a pragma kept deliberately for a
        # flapping platform-dependent finding says why with its own
        # justification). A wildcard must not count: an unused
        # `ignore[*]` would otherwise suppress its own staleness — the
        # broadest suppression becoming the one the audit can't retire.
        for fi in stale:
            sf = index.get(fi.path)
            pr = sf.pragmas.get(fi.line) if sf is not None else None
            if (
                pr is not None
                and pr.justification
                and "stale-pragma" in pr.checkers
            ):
                continue
            findings.append(fi)
    findings.sort(key=lambda fi: (fi.path, fi.line, fi.checker))
    return findings


# ---------------------------------------------------------------------------
# shared AST utilities used by the concurrency checkers
# ---------------------------------------------------------------------------


def unparse(node: ast.AST) -> str:
    try:
        return ast.unparse(node)
    except Exception:  # pragma: no cover - exotic nodes
        return "<expr>"


_LOCK_CTORS = {"Lock", "RLock", "Condition"}


def lock_ctor_name(call: ast.AST) -> str | None:
    """``threading.Lock()`` / ``Lock()`` -> "Lock" (None otherwise)."""
    if not isinstance(call, ast.Call):
        return None
    fn = call.func
    if isinstance(fn, ast.Attribute) and fn.attr in _LOCK_CTORS:
        if isinstance(fn.value, ast.Name) and fn.value.id == "threading":
            return fn.attr
    if isinstance(fn, ast.Name) and fn.id in _LOCK_CTORS:
        return fn.id
    return None


def iter_functions(
    tree: ast.Module,
) -> list[tuple[str | None, ast.FunctionDef | ast.AsyncFunctionDef]]:
    """Every (owning class name or None, function) in a module. Nested
    functions are yielded under their enclosing class (closures over
    ``self`` — the server loop's helpers — analyze with class context)."""
    out: list[tuple[str | None, Any]] = []

    def walk(node: ast.AST, cls: str | None) -> None:
        for child in ast.iter_child_nodes(node):
            if isinstance(child, ast.ClassDef):
                walk(child, child.name)
            elif isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                out.append((cls, child))
                walk(child, cls)
            else:
                walk(child, cls)

    walk(tree, None)
    return out


class HeldLockWalker:
    """Statement-order walk of one function body tracking which lock
    expressions are held (``with`` statements over lock-typed
    expressions). Subclasses get ``on_call(node, held)`` for every Call
    observed with the current held stack (list of (lock_key, expr_str,
    with_line))."""

    def __init__(self, is_lock_expr: Callable[[ast.AST], str | None]):
        # is_lock_expr: context expr -> lock key (None: not a lock)
        self._is_lock = is_lock_expr

    def on_call(
        self, node: ast.Call, held: list[tuple[str, str, int]]
    ) -> None:  # pragma: no cover - overridden
        raise NotImplementedError

    def on_acquire(
        self, key: str, held: list[tuple[str, str, int]], line: int
    ) -> None:
        """Called when a ``with <lock>`` is entered, BEFORE the lock is
        pushed onto ``held`` (the lock-order checker's edge source)."""

    def walk_function(self, fn: ast.FunctionDef | ast.AsyncFunctionDef) -> None:
        self._walk_body(fn.body, [])

    def _walk_body(self, body: list, held: list[tuple[str, str, int]]) -> None:
        for stmt in body:
            self._walk_stmt(stmt, held)

    def _walk_stmt(self, stmt: ast.stmt, held: list) -> None:
        if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef)):
            return  # nested defs run later, not while these locks are held
        if isinstance(stmt, (ast.With, ast.AsyncWith)):
            pushed = 0
            for item in stmt.items:
                self._visit_expr(item.context_expr, held)
                key = self._is_lock(item.context_expr)
                if key is not None:
                    self.on_acquire(key, held, stmt.lineno)
                    held.append(
                        (key, unparse(item.context_expr), stmt.lineno)
                    )
                    pushed += 1
            self._walk_body(stmt.body, held)
            for _ in range(pushed):
                held.pop()
            return
        if isinstance(stmt, ast.Try):
            self._walk_body(stmt.body, held)
            for h in stmt.handlers:
                self._walk_body(h.body, held)
            self._walk_body(stmt.orelse, held)
            self._walk_body(stmt.finalbody, held)
            return
        if isinstance(stmt, (ast.If, ast.While)):
            self._visit_expr(stmt.test, held)
            self._walk_body(stmt.body, held)
            self._walk_body(stmt.orelse, held)
            return
        if isinstance(stmt, (ast.For, ast.AsyncFor)):
            self._visit_expr(stmt.iter, held)
            self._walk_body(stmt.body, held)
            self._walk_body(stmt.orelse, held)
            return
        # expression-bearing simple statements
        for sub in ast.walk(stmt):
            if isinstance(sub, ast.Call):
                self.on_call(sub, held)

    def _visit_expr(self, expr: ast.AST, held: list) -> None:
        for sub in ast.walk(expr):
            if isinstance(sub, ast.Call):
                self.on_call(sub, held)
