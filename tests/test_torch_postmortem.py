"""The port's postmortem (``utils/postmortem.py``, ``cli postmortem``)
against the JAX package's: both on black boxes left by a port client and
a JAX server of one run (and by each package alone), both on dumps built
from fixed timestamps that hold each anomaly class, and the command's
exit codes."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from parameter_server_tpu import cli as JC
from parameter_server_tpu.kv import updaters as JU
from parameter_server_tpu.parallel import multislice as JMS
from parameter_server_tpu.utils import flightrec as JF
from parameter_server_tpu.utils import keyrange as JK
from parameter_server_tpu.utils import postmortem as JPM
from parameter_server_tpu_torch import cli as TC
from parameter_server_tpu_torch.parallel import multislice as TMS
from parameter_server_tpu_torch.utils import config as TCFG
from parameter_server_tpu_torch.utils import flightrec as TF
from parameter_server_tpu_torch.utils import metrics as TMET
from parameter_server_tpu_torch.utils import postmortem as TPM

torch.set_num_threads(1)


def _arm(mod, d: Path, name: str) -> None:
    mod.configure(str(d), process_name=name, flush_interval_s=0, watchdog_interval_s=3600)


@pytest.fixture
def mixed_run(tmp_path):
    """A port ServerHandle pushing and pulling through a JAX ShardServer,
    the port's recorder armed as worker-0 and the JAX one as server-0,
    both dumping into one dir (and each also alone)."""
    both = tmp_path / "both"
    _arm(TF, both, "worker-0")
    _arm(JF, both, "server-0")
    try:
        srv = JMS.ShardServer(JU.Sgd(eta=0.1), JK.KeyRange(0, 512),
                              ).start()
        h = TMS.ServerHandle(srv.address, 0, 0, TCFG.PSConfig(), range_size=512,
                             device="cpu")
        keys = np.arange(1, 33, dtype=np.int64)
        for i in range(5):
            h.push(keys, np.full(32, 0.1 * (i + 1), np.float32))
            h.pull(keys)
        h.shutdown()
        h.close()
        TF.dump("exit")
        JF.dump("exit")
    finally:
        TF.configure(None)
        JF.configure(None)
    return both


class TestRealBoxes:
    def test_both_postmortems_agree_on_a_mixed_run(self, mixed_run):
        t, j = TPM.postmortem(str(mixed_run)), JPM.postmortem(str(mixed_run))
        assert t == j
        assert t["processes"] == 2 and t["anomalies"] == []
        assert t["cross_process_calls"] >= 10  # the pushes and pulls, stitched
        assert t["unknown_events"] == {}

    @pytest.mark.parametrize("proc", ["worker-0", "server-0"])
    def test_each_packages_box_alone(self, mixed_run, tmp_path, proc):
        d = tmp_path / proc
        d.mkdir()
        for p in mixed_run.glob(f"blackbox-{proc}-*.json"):
            (d / p.name).write_text(p.read_text())
        dumps = TPM.load_dumps(str(d))
        assert len(dumps) == 1
        tl = TPM.merge_timeline(dumps)
        assert tl == JPM.merge_timeline(JPM.load_dumps(str(d)))
        assert TPM.find_anomalies(dumps, tl) == JPM.find_anomalies(dumps, tl) == []
        assert TPM.stitch_calls(tl) == JPM.stitch_calls(tl)

    @pytest.mark.parametrize("cli", [TC, JC], ids=["torch", "jax"])
    def test_cli_exits_0_on_a_clean_run(self, mixed_run, cli, capsys, tmp_path):
        out = tmp_path / "pm.trace.json"
        assert cli.main(["postmortem", str(mixed_run), "--trace_out", str(out)]) == 0
        lines = capsys.readouterr().out.strip().splitlines()
        doc = json.loads(lines[-1])
        assert doc["anomalies"] == [] and doc["processes"] == 2
        assert json.loads(out.read_text())["traceEvents"]


def _row(ts, etype, fields, tid=11):
    return [ts, tid, etype, fields]


def _dump(proc, pid, rows, reason="exit", stall=None, telemetry=None):
    return {"schema": "psbb/1", "process": proc, "pid": pid, "reason": reason,
            "trigger_reasons": [reason], "wall_time": 100.0, "events": rows,
            "telemetry": telemetry or {}, "threads": [], "stall": stall}


def _anomalous_dumps():
    """Fixed-timestamp wreckage holding every anomaly class: a stall, an
    acked push no server applied, a version regression, a reconnect that
    never healed, a shed storm, an SLO alert and a live audit verdict."""
    worker = [
        _row(1.0, "rpc.issue", {"cmd": "push", "cid": "c1", "seq": "k0"}),
        _row(1.2, "rpc.reply", {"cmd": "push", "cid": "c1", "seq": "k0", "ok": True}),
        _row(2.0, "rpc.heal.begin", {"addr": "a", "cid": "c1"}),
        _row(2.5, "rpc.heal.failed", {"addr": "a", "cid": "c1"}),
    ]
    server = [
        _row(1.1, "rpc.in", {"cmd": "push", "cid": "c1", "seq": "k0"}),
        _row(3.0, "rcu.publish", {"ver": 101}),
        _row(3.1, "rcu.publish", {"ver": 99}),
    ] + [_row(4.0 + i * 0.01, "serve.shed", {"sig": "s"}) for i in range(12)]
    sched = [
        _row(5.0, "slo.alert", {"rule": "push_p99_ms", "node": "1", "burn_short": 12.0,
                                "burn_long": 11.0}),
        _row(5.5, "audit.violation", {"kind": "acked-but-unapplied",
                                      "monitor": "ack-applied", "node": "1",
                                      "cid": "c1", "seq": "k0"}),
    ]
    sketch = TMET.KeyHeatSketch()
    sketch.add(np.full(9, 300, np.int64))  # one hot key, nine accesses
    heat = {"key_heat": sketch.snapshot()}
    return [
        _dump("worker-0", 1, worker, telemetry=heat),
        _dump("server-0", 2, server, reason="watchdog",
              stall={"source": "apply", "thread": "ps-apply", "stalled_s": 31.0}),
        _dump("scheduler-0", 3, sched),
    ]


class TestSyntheticWreckage:
    def test_same_anomalies_timeline_and_report(self):
        dumps = _anomalous_dumps()
        tl = TPM.merge_timeline(dumps)
        assert tl == JPM.merge_timeline(dumps)
        an = TPM.find_anomalies(dumps, tl)
        assert an == JPM.find_anomalies(dumps, tl)
        kinds = {a["kind"] for a in an}
        assert {"acked-but-unapplied", "version-regression", "reconnect-without-heal",
                "shed-storm", "audit-violation"} <= kinds
        assert TPM.render_report(dumps, tl, an) == JPM.render_report(dumps, tl, an)
        assert TPM.merged_heat(dumps) == JPM.merged_heat(dumps)
        assert TPM.to_trace_events(tl) == JPM.to_trace_events(tl)

    @pytest.mark.parametrize("cli", [TC, JC], ids=["torch", "jax"])
    def test_cli_exits_1_on_anomalies_from_either_package(self, tmp_path, cli, capsys):
        for d in _anomalous_dumps():
            (tmp_path / f"blackbox-{d['process']}-{d['pid']}.json").write_text(json.dumps(d))
        assert cli.main(["postmortem", str(tmp_path)]) == 1
        doc = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
        assert doc["anomalies"] and doc["processes"] == 3
        assert doc["heat_top"] == [[300, 9]]

    def test_empty_dir_is_clean(self, tmp_path, capsys):
        assert TC.main(["postmortem", str(tmp_path)]) == 0
        assert json.loads(capsys.readouterr().out.strip().splitlines()[-1])["processes"] == 0
