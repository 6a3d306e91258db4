"""Checkers ``counter-contract`` and ``config-contract``: derived
inventories instead of hand-maintained lists.

The JAX package's ``tests/test_contracts.py`` once asserted "every counter is visible in
the dashboard" and "every config key read has a default" against
regex-scanned inventories maintained inside the test. These checkers
derive the same inventories from the AST — one source of truth the tests
now import (``counter_inventory`` / ``config_key_usage``), so the lists
can never drift from the code again:

- every literal counter name bumped through ``wire_counters.inc`` /
  ``observe_max`` / ``inc_many`` must appear in the rendered
  ``format_cluster_stats`` dashboard (a renamed or filtered counter
  fails the build, not the on-call engineer reading a blank column);
- every ``cfg.<section>.<key>`` attribute read (aliases like
  ``scfg = server_cfg or ServerConfig()`` included) must be a declared
  dataclass field WITH a default in ``utils/config.py`` — a knob read
  by code but absent from the config schema crashes only at runtime,
  on the one cluster that sets it.
"""

from __future__ import annotations

import ast
import dataclasses

from parameter_server_tpu_torch.analysis.core import Finding, PackageIndex

Sites = list[tuple[str, int]]


def counter_inventory(index: PackageIndex) -> dict[str, Sites]:
    """Every literal counter name bumped via ``wire_counters`` and the
    sites bumping it (the dashboard-visibility contract's left side)."""
    out: dict[str, Sites] = {}

    def add(name: str, relpath: str, line: int) -> None:
        out.setdefault(name, []).append((relpath, line))

    for f in index.files:
        for node in ast.walk(f.tree):
            if not isinstance(node, ast.Call):
                continue
            fn = node.func
            if not (
                isinstance(fn, ast.Attribute)
                and isinstance(fn.value, ast.Name)
                and fn.value.id == "wire_counters"
            ):
                continue
            if fn.attr in ("inc", "observe_max") and node.args:
                a0 = node.args[0]
                if isinstance(a0, ast.Constant) and isinstance(a0.value, str):
                    add(a0.value, f.relpath, node.lineno)
            elif fn.attr == "inc_many" and node.args:
                a0 = node.args[0]
                if isinstance(a0, ast.Dict):
                    for k in a0.keys:
                        if isinstance(k, ast.Constant) and isinstance(
                            k.value, str
                        ):
                            add(k.value, f.relpath, node.lineno)
    return out


def check_counter_contract(index: PackageIndex) -> list[Finding]:
    from parameter_server_tpu_torch.utils.metrics import format_cluster_stats

    inv = counter_inventory(index)
    if not inv:
        return []
    rendered = format_cluster_stats({
        "nodes": {},
        "merged": {
            "counters": {n: 1 for n in inv}, "hists": {}, "timers": {},
        },
    })
    out: list[Finding] = []
    for name in sorted(inv):
        if name not in rendered:
            rel, line = inv[name][0]
            out.append(Finding(
                "counter-contract", rel, line,
                f"counter {name!r} is bumped here but invisible to "
                "format_cluster_stats — the dashboard would silently "
                "hide it; render it (or drop the counter)",
            ))
    return out


def _config_sections() -> dict[str, type]:
    from parameter_server_tpu_torch.utils import config as config_mod

    return dict(config_mod._NESTED)


def config_key_usage(index: PackageIndex) -> dict[str, dict[str, Sites]]:
    """Every ``cfg.<section>.<key>`` read in the package (plus aliased
    reads: ``x = cfg.<section>`` / ``x = <SectionCfg>()`` /
    ``x = param or <SectionCfg>()``), keyed section -> key -> sites."""
    sections = _config_sections()
    class_to_section = {cls.__name__: s for s, cls in sections.items()}
    out: dict[str, dict[str, Sites]] = {}

    def add(section: str, key: str, relpath: str, line: int) -> None:
        out.setdefault(section, {}).setdefault(key, []).append(
            (relpath, line)
        )

    def is_cfg_base(expr: ast.AST) -> bool:
        return (isinstance(expr, ast.Name) and expr.id in ("cfg", "config")) or (
            isinstance(expr, ast.Attribute) and expr.attr in ("cfg", "_cfg")
        )

    def collect_aliases(scope: ast.AST) -> dict[str, str]:
        aliases: dict[str, str] = {}
        for node in ast.walk(scope):
            if not isinstance(node, (ast.Assign, ast.AnnAssign)):
                continue
            targets = (
                node.targets if isinstance(node, ast.Assign) else [node.target]
            )
            value = node.value
            if value is None:
                continue
            section = None
            if isinstance(value, ast.Attribute) and is_cfg_base(value.value):
                if value.attr in sections:
                    section = value.attr
            else:
                for sub in ast.walk(value):
                    if (
                        isinstance(sub, ast.Call)
                        and isinstance(sub.func, ast.Name)
                        and sub.func.id in class_to_section
                    ):
                        section = class_to_section[sub.func.id]
            if section is not None:
                for t in targets:
                    if isinstance(t, ast.Name):
                        aliases[t.id] = section
        return aliases

    def scan(scope: ast.AST, relpath: str) -> None:
        # aliases stay scoped to the function that binds them (a module-
        # wide map would let one function's `m = cfg.mf` relabel another
        # function's unrelated `m.foo` as a config read)
        aliases = collect_aliases(scope)
        for node in ast.walk(scope):
            if not isinstance(node, ast.Attribute):
                continue
            v = node.value
            # cfg.<section>.<key>
            if (
                isinstance(v, ast.Attribute)
                and v.attr in sections
                and is_cfg_base(v.value)
            ):
                add(v.attr, node.attr, relpath, node.lineno)
            # <alias>.<key>
            elif isinstance(v, ast.Name) and v.id in aliases:
                add(aliases[v.id], node.attr, relpath, node.lineno)

    from parameter_server_tpu_torch.analysis.core import iter_functions

    for f in index.files:
        for _cls, fndef in iter_functions(f.tree):
            scan(fndef, f.relpath)
        # module-level statements (outside any function)
        mod_only = ast.Module(
            body=[
                s
                for s in f.tree.body
                if not isinstance(
                    s, (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
                )
            ],
            type_ignores=[],
        )
        scan(mod_only, f.relpath)
    return out


def check_config_contract(index: PackageIndex) -> list[Finding]:
    sections = _config_sections()
    usage = config_key_usage(index)
    out: list[Finding] = []
    for section, keys in sorted(usage.items()):
        cls = sections[section]
        fields = {fld.name: fld for fld in dataclasses.fields(cls)}
        for key, sites in sorted(keys.items()):
            rel, line = sites[0]
            fld = fields.get(key)
            if fld is None:
                out.append(Finding(
                    "config-contract", rel, line,
                    f"[{section}] key {key!r} is read here but "
                    f"{cls.__name__} declares no such field — this "
                    "crashes at runtime on any config that reaches it",
                ))
            elif (
                fld.default is dataclasses.MISSING
                and fld.default_factory is dataclasses.MISSING
            ):
                out.append(Finding(
                    "config-contract", rel, line,
                    f"[{section}] key {key!r} has no default in "
                    f"{cls.__name__}: every config file would be forced "
                    "to set it",
                ))
    return out
