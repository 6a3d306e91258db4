"""``cli lint`` in the port: the JAX CLI's parser and dispatch onto the
port's analyzer. (``check``, ``verify`` and ``explore``: tests/
test_torch_psmc.py, test_torch_verify.py and test_torch_explorer.py.)"""

from __future__ import annotations

import json

import pytest

from parameter_server_tpu_torch import cli


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
        cli.main(["lint", "--checker", "no-such-checker"])
    assert "unknown checker" in capsys.readouterr().err
