"""``cli verify`` in the port: lint, then check, then optionally ``audit
--once`` (``--scheduler``) and ``whylate --baseline`` (``--whylate``),
folded into one tiered exit (1 hard, 2 soft, 0 clean), mirroring the
verify cases of the JAX package's ``tests/test_freshness.py`` and held to
the JAX CLI's verdicts stage for stage; and one real run over the port's
tree, which must be clean."""

from __future__ import annotations

import json

import pytest

import parameter_server_tpu.analysis.__main__ as j_an
import parameter_server_tpu.cli as j_cli
import parameter_server_tpu_torch.analysis.__main__ as an
import parameter_server_tpu_torch.cli as cli


def _run(monkeypatch, capsys, pair=(cli, an), lint=0, check=0, whylate=None, audit=None):
    cli_mod, an_mod = pair
    monkeypatch.setattr(an_mod, "main", lambda argv=None: lint)
    monkeypatch.setattr(an_mod, "check_main", lambda argv=None: check)
    argv = ["verify", "--json"]
    if whylate is not None:
        monkeypatch.setattr(cli_mod, "run_whylate", lambda a: whylate)
        argv += ["--whylate", "/tmp/nowhere"]
    if audit is not None:
        monkeypatch.setattr(cli_mod, "run_audit", lambda a: audit)
        argv += ["--scheduler", "127.0.0.1:1"]
    rc = cli_mod.main(argv)
    doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return rc, doc


class TestVerifyTiering:
    def test_all_clean_exits_zero(self, monkeypatch, capsys):
        rc, doc = _run(monkeypatch, capsys)
        assert rc == 0 and doc["exit"] == 0
        assert [s["stage"] for s in doc["stages"]] == ["lint", "check"]
        assert doc["hard"] == [] and doc["soft"] == []

    def test_soft_budget_stage_exits_two(self, monkeypatch, capsys):
        rc, doc = _run(monkeypatch, capsys, whylate=2)
        assert rc == 2
        assert doc["soft"] == ["whylate"] and doc["hard"] == []

    def test_hard_failure_beats_soft(self, monkeypatch, capsys):
        rc, doc = _run(monkeypatch, capsys, lint=1, whylate=2, audit=0)
        assert rc == 1
        assert doc["hard"] == ["lint"] and doc["soft"] == ["whylate"]
        assert [s["stage"] for s in doc["stages"]] == ["lint", "check", "audit", "whylate"]

    def test_a_crashed_stage_is_hard_and_the_rest_still_run(self, monkeypatch, capsys):
        def _boom(argv=None):
            raise RuntimeError("checker exploded")

        monkeypatch.setattr(an, "main", _boom)
        monkeypatch.setattr(an, "check_main", lambda argv=None: 0)
        rc = cli.main(["verify", "--json"])
        doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert rc == 1 and doc["hard"] == ["lint"]
        assert {"stage": "check", "exit": 0} in doc["stages"]

    @pytest.mark.parametrize("stages", [
        dict(), dict(lint=2), dict(check=1), dict(whylate=2, audit=0),
        dict(lint=1, check=1, whylate=1, audit=2),
    ])
    def test_verdicts_are_the_jax_clis(self, monkeypatch, capsys, stages):
        """Stage exits in, verdict out: the port's and the JAX CLI's
        agree on the exit code and the whole JSON summary."""
        got = _run(monkeypatch, capsys, **stages)
        want = _run(monkeypatch, capsys, pair=(j_cli, j_an), **stages)
        assert got == want

    def test_lint_options_reach_the_lint_stage(self, monkeypatch, capsys):
        seen = {}
        monkeypatch.setattr(an, "main", lambda argv=None: seen.setdefault("lint", argv) and 0)
        monkeypatch.setattr(an, "check_main", lambda argv=None: seen.setdefault("check", argv)
                            and 0)
        assert cli.main(["verify", "--lint-baseline", "b.json", "--lint-changed-only", "HEAD",
                         "--max-states", "1234"]) == 0
        assert seen == {"lint": ["--baseline", "b.json", "--changed-only", "HEAD"],
                        "check": ["--max-states", "1234"]}
        assert "verdict: all stages clean" in capsys.readouterr().out


def test_verify_over_the_port_is_clean(capsys):
    """The real thing: pslint's 17 checkers and psmc's four specs with the
    conformance diff, over the port's tree — one clean exit."""
    assert cli.main(["verify", "--json"]) == 0
    out = capsys.readouterr().out
    doc = json.loads(out.strip().splitlines()[-1])
    assert doc == {"stages": [{"stage": "lint", "exit": 0}, {"stage": "check", "exit": 0}],
                   "hard": [], "soft": [], "exit": 0}
    assert "17 checker(s)" in out and "0 conformance drift" in out
