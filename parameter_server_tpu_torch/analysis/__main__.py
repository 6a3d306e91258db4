"""``python -m parameter_server_tpu_torch.analysis`` — run pslint over the
port's source, exit 1 on findings. The same entry backs ``python -m
parameter_server_tpu_torch.cli lint`` and the clean-tree test, so the CLI
and the tests can never disagree about what clean means. A copy of the
JAX package's ``analysis/__main__.py``: ``main`` and ``check_main`` (``cli
check``: the protocol models and the spec<->code conformance diff), their
options and exit codes unchanged.

CI integration: ``--json`` emits machine-readable findings
(checker, file, line, message, plus ``id`` — the checker name a
``# psl: ignore[<id>]: <why>`` pragma takes); ``--baseline FILE`` gates
on *no NEW findings* against a recorded baseline instead of absolute
cleanliness, so a refactor-heavy PR (direction #1's replication churn)
can land with pre-existing debt visible but frozen. Baseline entries
match on (checker, file, message) — deliberately line-insensitive, so
edits above a finding don't churn the gate — and are counted as a
multiset, so introducing a SECOND instance of an already-baselined
finding still fails. ``--update-baseline`` rewrites the file from the
current findings (the reviewed way to accept or retire debt).

``--changed-only REF`` narrows the REPORT to files that
differ from the git ref (diff + untracked): the ANALYSIS still runs
over the whole package — interprocedural summaries and the shared
dataflow fixpoint need every file — so a change whose finding
surfaces in an unchanged file is the one case the filter can hide,
and the full run stays the gate of record. When git is unavailable
the filter fails OPEN (everything reports): a silently empty lint
must never read as clean."""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
from collections import Counter
from pathlib import Path

from parameter_server_tpu_torch.analysis import (
    CHECKERS,
    PACKAGE_ROOT,
    _default_config,
    analyze_package,
    severity_of,
)
from parameter_server_tpu_torch.analysis.core import Finding, PslintConfig


def finding_json(f: Finding, config: PslintConfig | None = None) -> dict:
    return {
        "checker": f.checker,
        "file": f.path,
        "line": f.line,
        "message": f.message,
        # the pragma-able id: # psl: ignore[<id>]: <why> on f.line
        "id": f.checker,
        # error | warn — tiered exit codes: any error gates exit 1,
        # warn-only runs exit 2, clean exits 0 ([tool.pslint] warn
        # extends the built-in warn set)
        "severity": severity_of(f.checker, config),
    }


def _baseline_key(d: dict) -> tuple:
    return (d.get("checker"), d.get("file"), d.get("message"))


def load_baseline(path: Path) -> Counter:
    data = json.loads(path.read_text())
    entries = data["findings"] if isinstance(data, dict) else data
    return Counter(_baseline_key(d) for d in entries)


def new_vs_baseline(
    findings: list[Finding], baseline: Counter
) -> list[Finding]:
    """Findings beyond the baseline's multiset (oldest-seen instances of
    a repeated key are forgiven first — which instance of N identical
    findings is 'new' is unknowable without line anchoring)."""
    budget = Counter(baseline)
    out: list[Finding] = []
    for f in findings:
        k = (f.checker, f.path, f.message)
        if budget[k] > 0:
            budget[k] -= 1
        else:
            out.append(f)
    return out


def changed_files(ref: str, root: Path) -> set[str] | None:
    """Package-relative paths of files changed vs ``ref`` (worktree
    diff, staged included, plus untracked); None when git can't answer
    — the caller must then skip filtering (fail open)."""
    root = root.resolve()

    def _git(*args: str) -> str:
        return subprocess.run(
            ["git", "-C", str(root), *args],
            capture_output=True, text=True, check=True, timeout=30,
        ).stdout

    try:
        top = Path(_git("rev-parse", "--show-toplevel").strip())
        listed = (
            _git("diff", "--name-only", ref, "--")
            # --full-name: toplevel-relative, like diff --name-only
            + _git("ls-files", "--others", "--exclude-standard",
                   "--full-name")
        )
    except (OSError, subprocess.SubprocessError):
        return None
    out: set[str] = set()
    for line in listed.splitlines():
        if not line.strip():
            continue
        try:
            out.add((top / line).resolve().relative_to(root).as_posix())
        except ValueError:
            continue  # changed, but outside the analyzed package
    return out


def main(argv: list[str] | None = None) -> int:
    p = argparse.ArgumentParser(prog="pslint")
    p.add_argument(
        "--root", default=str(PACKAGE_ROOT),
        help="package directory to analyze (default: the installed "
        "parameter_server_tpu_torch package)",
    )
    p.add_argument(
        "--checker", action="append", default=None,
        help="run only this checker (repeatable); default: all "
        f"({', '.join(CHECKERS)})",
    )
    p.add_argument(
        "--json", action="store_true", help="machine-readable output"
    )
    p.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="gate on no NEW findings vs this JSON baseline (missing "
        "file = empty baseline); matching is LINE-INSENSITIVE — "
        "entries match on (checker, file, message) as a multiset, so "
        "edits above a finding never churn the gate but a second "
        "instance of a baselined finding still fails; combine with "
        "--update-baseline to (re)record it",
    )
    p.add_argument(
        "--update-baseline", action="store_true",
        help="write the current findings to --baseline and exit 0",
    )
    p.add_argument(
        "--changed-only", default=None, metavar="REF",
        help="report only findings in files changed vs this git ref "
        "(diff + untracked); the analysis itself still covers the "
        "whole package, so interprocedural summaries stay exact — "
        "this narrows the REPORT for fast pre-push iteration, it is "
        "not the gate of record. Fails open (reports everything) "
        "when git can't answer",
    )
    args = p.parse_args(argv)
    if args.update_baseline and not args.baseline:
        p.error("--update-baseline requires --baseline FILE")
    if args.update_baseline and args.changed_only:
        p.error(
            "--update-baseline records the FULL package's findings; "
            "drop --changed-only"
        )
    checkers = CHECKERS
    if args.checker:
        unknown = sorted(set(args.checker) - set(CHECKERS))
        if unknown:
            p.error(f"unknown checker(s) {unknown}; known: {sorted(CHECKERS)}")
        checkers = {n: CHECKERS[n] for n in args.checker}
    config = _default_config(Path(args.root))
    findings = analyze_package(args.root, checkers=checkers, config=config)
    scope = ""
    if args.changed_only:
        changed = changed_files(args.changed_only, Path(args.root))
        if changed is None:
            print(
                f"pslint: --changed-only {args.changed_only}: git "
                "unavailable — reporting ALL findings",
                file=sys.stderr,
            )
        else:
            findings = [f for f in findings if f.path in changed]
            scope = (
                f" [changed-only vs {args.changed_only}: "
                f"{len(changed)} file(s)]"
            )
    if args.baseline and args.update_baseline:
        Path(args.baseline).write_text(json.dumps(
            {"findings": [finding_json(f, config) for f in findings]},
            indent=1,
        ))
        print(
            f"pslint: baseline {args.baseline} updated "
            f"({len(findings)} finding(s))"
        )
        return 0
    gated = findings
    if args.baseline:
        bp = Path(args.baseline)
        baseline = load_baseline(bp) if bp.exists() else Counter()
        gated = new_vs_baseline(findings, baseline)
    errors = [
        f for f in gated if severity_of(f.checker, config) == "error"
    ]
    if args.json:
        print(json.dumps([finding_json(f, config) for f in gated]))
    else:
        for f in gated:
            sev = severity_of(f.checker, config)
            print(f"{f.render()} [{sev}]" if sev == "warn" else f.render())
        suffix = (
            f" ({len(gated)} NEW vs baseline {args.baseline})"
            if args.baseline else ""
        )
        print(
            f"pslint: {len(findings)} finding(s) "
            f"({len(errors)} error(s), {len(gated) - len(errors)} "
            f"warning(s) gating){suffix}, "
            f"{len(checkers)} checker(s) over {args.root}{scope}"
        )
    # tiered exit codes: errors are a hard 1, a warn-only run exits 2
    # (CI can gate on 1 while new analyses phase in), clean is 0
    return 1 if errors else (2 if gated else 0)


def check_main(argv: list[str] | None = None) -> int:
    """``cli check`` — psmc, the explicit-state protocol model checker
    (analysis/model.py over analysis/specs/), plus the spec<->code
    conformance diff. Exit 0 only when every selected spec model
    EXHAUSTS its bounded state space with zero invariant/liveness
    violations AND no model assumption has drifted from the
    AST-derived code tables; a violation prints its shortest
    counterexample as a replayable step list."""
    from parameter_server_tpu_torch.analysis import load_package
    from parameter_server_tpu_torch.analysis.conformance import conformance_diff
    from parameter_server_tpu_torch.analysis.model import check
    from parameter_server_tpu_torch.analysis.specs import SPECS

    p = argparse.ArgumentParser(prog="psmc")
    p.add_argument(
        "--spec", action="append", default=None,
        help="check only this protocol model (repeatable); default: "
        f"all ({', '.join(SPECS)})",
    )
    p.add_argument(
        "--max-states", type=int, default=200_000,
        help="BFS state cap; a capped run is reported incomplete and "
        "fails (verification demands exhaustion of the bounded space)",
    )
    p.add_argument(
        "--probe-seeds", type=int, default=0,
        help="when the cap is hit, continue with this many seeded "
        "random walks past the frontier (deterministic bug probing, "
        "not verification)",
    )
    p.add_argument(
        "--bug", default=None, metavar="KNOB",
        help="check the named seeded-bug VARIANT instead (requires "
        "exactly one --spec); exit 0 iff the checker produces a "
        "counterexample — how the suite's mutation coverage is "
        "demonstrated by hand",
    )
    p.add_argument(
        "--root", default=str(PACKAGE_ROOT),
        help="package directory the conformance diff derives code "
        "tables from",
    )
    p.add_argument(
        "--no-conformance", action="store_true",
        help="skip the spec<->code conformance diff (models only)",
    )
    p.add_argument("--json", action="store_true")
    args = p.parse_args(argv)

    names = list(SPECS)
    if args.spec:
        unknown = sorted(set(args.spec) - set(SPECS))
        if unknown:
            p.error(f"unknown spec(s) {unknown}; known: {sorted(SPECS)}")
        names = list(args.spec)
    if args.bug is not None and len(names) != 1:
        p.error("--bug requires exactly one --spec")

    results = []
    for name in names:
        mod = SPECS[name]
        if args.bug is not None:
            if args.bug not in mod.BUGS:
                p.error(
                    f"spec {name!r} has no bug knob {args.bug!r}; "
                    f"known: {list(mod.BUGS)}"
                )
            spec = mod.make(bug=args.bug)
        else:
            spec = mod.tier1()
        results.append(check(
            spec, max_states=args.max_states,
            probe_seeds=args.probe_seeds,
        ))

    drift = []
    config = _default_config(Path(args.root))
    if args.bug is None and not args.no_conformance:
        drift = conformance_diff(load_package(Path(args.root)))

    if args.bug is not None:
        # mutation-coverage mode: the bug MUST be caught
        r = results[0]
        ok = r.violation is not None
        if args.json:
            print(json.dumps({"bug": args.bug, "caught": ok,
                              "result": r.summary()}))
        elif ok:
            print(f"psmc: seeded bug {args.bug!r} caught:\n"
                  + r.violation.render())
        else:
            print(f"psmc: seeded bug {args.bug!r} NOT caught "
                  f"({r.states} states) — the model lost its teeth")
        return 0 if ok else 1

    ok = all(r.ok and r.complete for r in results) and not drift
    if args.json:
        print(json.dumps({
            "ok": ok,
            "specs": [r.summary() for r in results],
            "conformance": [finding_json(f, config) for f in drift],
        }))
    else:
        for r in results:
            status = (
                "verified" if r.ok and r.complete
                else "INCOMPLETE (state cap hit)" if r.ok
                else "VIOLATION"
            )
            print(
                f"psmc: {r.spec:<14} {r.states:>7} states "
                f"{r.transitions:>8} transitions depth {r.depth:>3}  "
                f"{status}"
            )
            if r.violation is not None:
                print(r.violation.render())
        for f in drift:
            print(f.render())
        verdict = "all protocols verified at these bounds" if ok else (
            "NOT verified — fix the model or the code, together"
        )
        print(
            f"psmc: {len(results)} spec(s), {len(drift)} conformance "
            f"drift finding(s): {verdict}"
        )
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
