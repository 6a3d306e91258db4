"""``cli lint`` in the port: the JAX CLI's parser and dispatch onto the
port's analyzer, and the refusal, pinned word for word, of the analysis
commands the port does not carry yet (``check``, ``verify``,
``explore``)."""

from __future__ import annotations

import json

import pytest

from parameter_server_tpu_torch import cli


@pytest.mark.parametrize("cmd", ["check", "verify", "explore"])
def test_unported_analysis_commands_are_refused(cmd):
    assert cmd in cli.NOT_PORTED_CMDS
    with pytest.raises(SystemExit) as ei:
        cli.main([cmd, "--json"])
    assert str(ei.value) == (
        f"the {cmd!r} subcommand is not ported yet to parameter_server_tpu_torch")


def test_lint_is_ported():
    assert cli.NOT_PORTED_CMDS == ("check", "verify", "explore")


def test_lint_dispatches_to_the_ports_analyzer(capsys):
    """``cli lint`` passes its options through to the analyzer's main: a
    clean JSON run over the port's tree, one checker at a time."""
    assert cli.main(["lint", "--json", "--checker", "lock-order",
                     "--checker", "trace-hygiene"]) == 0
    assert json.loads(capsys.readouterr().out) == []


def test_lint_baseline_options_reach_the_analyzer(tmp_path, capsys):
    base = tmp_path / "base.json"
    assert cli.main(["lint", "--checker", "settle-exactly-once", "--baseline",
                     str(base), "--update-baseline"]) == 0
    assert json.loads(base.read_text()) == {"findings": []}
    assert "baseline" in capsys.readouterr().out
    with pytest.raises(SystemExit):  # the analyzer's own refusal
        cli.main(["lint", "--update-baseline"])


def test_lint_rejects_an_unknown_checker(capsys):
    with pytest.raises(SystemExit):
        cli.main(["lint", "--checker", "spec-conformance"])
    assert "unknown checker" in capsys.readouterr().err
