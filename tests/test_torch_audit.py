"""The port's audit plane against the JAX package's on the same event
streams: the streaming protocol monitors (``analysis/monitors.py``), the
coordinator-side ``Auditor`` (seq dedup, hole suppression, the flight
recorder hook), offline/online parity with the postmortem, the
coordinator's ``audit`` command, ``cli audit``'s exit codes, and a live
drill: a port child node injects an acked-but-unapplied push and a
version rollback, and the coordinator flags both within a beat window."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest
import torch

from parameter_server_tpu import cli as JC
from parameter_server_tpu.analysis import monitors as JMON
from parameter_server_tpu.utils import auditor as JA
from parameter_server_tpu.utils import config as JCFG
from parameter_server_tpu.utils import flightrec as JF
from parameter_server_tpu.utils import postmortem as JPM
from parameter_server_tpu_torch import cli as TC
from parameter_server_tpu_torch.analysis import monitors as TMON
from parameter_server_tpu_torch.parallel.control import ControlClient, Coordinator
from parameter_server_tpu_torch.utils import auditor as TA
from parameter_server_tpu_torch.utils import config as TCFG
from parameter_server_tpu_torch.utils import flightrec as TF
from parameter_server_tpu_torch.utils import postmortem as TPM
from parameter_server_tpu_torch.utils.metrics import wire_counters

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent


def _row(ts, etype, fields, tid=11):
    return [ts, tid, etype, fields]


def _batch(seq, rows, dropped=0):
    return {"seq": seq, "events": rows, "dropped": dropped}


def _push_ack(ts, cid, seq):
    return _row(ts, "rpc.reply", {"cmd": "push", "cid": cid, "seq": seq, "ok": True})


def _feed_both(make, events):
    """Feed one (ts, node, etype, fields) stream to a JAX and a port
    monitor built by ``make(module)``; both verdict lists."""
    outs = []
    for mod in (JMON, TMON):
        m = make(mod)
        out = []
        for ts, node, etype, fields in events:
            out += m.feed(mod._ev(ts, node, etype, dict(fields)))
        out += m.finish()
        outs.append(out)
    return outs


class TestMonitorContract:
    def test_registry_equals_jax(self):
        assert sorted(TMON.MONITORS) == sorted(JMON.MONITORS)
        assert TMON.monitor_events() == JMON.monitor_events()
        assert TMON.monitor_events() <= TF.AUDIT_EVENTS
        assert TF.AUDIT_EVENTS == JF.AUDIT_EVENTS

    @pytest.mark.parametrize("name", sorted(JMON.MONITORS))
    def test_every_seeded_drill_is_caught_as_in_jax(self, name):
        cls, jcls = TMON.MONITORS[name], JMON.MONITORS[name]
        assert sorted(cls.BUGS) == sorted(jcls.BUGS) and cls.name == name
        for bug in cls.BUGS:
            out, expected = TMON.run_bug(cls, bug)
            jout, jexpected = JMON.run_bug(jcls, bug)
            assert expected == jexpected and out == jout
            assert expected in [v["kind"] for v in out]


class TestMonitorNegatives:
    """The JAX suite's negatives, each stream fed to both packages'
    monitors: same verdicts (none)."""

    @pytest.mark.parametrize("order", [(0, 1), (1, 0)])
    def test_ack_and_commit_in_either_order_clean(self, order):
        evs = [(0.1, "w", "rpc.reply", {"cmd": "push", "cid": "c", "seq": "k0", "ok": True}),
               (0.2, "s", "apply.commit", {"ver": 2, "pairs": [["c", "k0"]]})]
        j, t = _feed_both(lambda m: m.AckAppliedMonitor(watermark_s=5.0),
                          [evs[i] for i in order])
        assert j == t == []

    def test_replay_dedup_is_not_a_double_apply(self):
        evs = [(0.1, "s", "apply.commit", {"ver": 2, "pairs": [["c", "k0"]]}),
               (0.2, "s", "apply.replay", {"cid": "c", "seq": "k0"}),
               (0.3, "w", "rpc.reply", {"cmd": "push", "cid": "c", "seq": "k0", "ok": True}),
               (0.4, "w", "rpc.reply", {"cmd": "push", "cid": "c", "seq": "k0", "ok": True})]
        j, t = _feed_both(lambda m: m.AckAppliedMonitor(watermark_s=5.0), evs)
        assert j == t == []

    def test_rcu_new_life_nonce_is_not_a_regression(self):
        hi = TMON.RcuMonitor.NONCE_SHIFT
        evs = [(0.1, "s", "rcu.publish", {"ver": (9 << hi) + 100}),
               (0.2, "s", "rcu.publish", {"ver": (3 << hi) + 1})]
        j, t = _feed_both(lambda m: m.RcuMonitor(), evs)
        assert j == t == []

    def test_ssp_within_bound_and_late_justifying_finish_clean(self):
        evs = [(0.0, "c", "ssp.finish", {"worker": 0, "step": 9}),
               (0.1, "c", "ssp.wait", {"worker": 0, "step": 9, "granted": True}),
               (0.2, "c", "ssp.finish", {"worker": 1, "step": 8})]
        j, t = _feed_both(
            lambda m: m.SspMonitor(max_delay=1, num_workers=2, grace_s=5.0), evs)
        assert j == t == []

    def test_heal_that_lands_is_clean(self):
        evs = [(0.1, "w", "rpc.heal.begin", {"cid": "c"}),
               (0.3, "w", "rpc.healed", {"cid": "c", "resent": 2})]
        j, t = _feed_both(lambda m: m.HealMonitor(heal_timeout_s=1.0), evs)
        assert j == t == []

    def test_shed_trickle_and_skewed_bursts_are_not_storms(self):
        trickle = [(1.0 + i * 0.5, "s", "serve.shed", {"sig": "x"}) for i in range(12)]
        skew = ([(11.5 + i * 0.01, "B", "serve.shed", {"sig": "x"}) for i in range(5)]
                + [(10.0 + i * 0.01, "A", "serve.shed", {"sig": "x"}) for i in range(5)])
        for evs in (trickle, skew):
            j, t = _feed_both(lambda m: m.ShedStormMonitor(n=10, window_s=1.0), evs)
            assert j == t == []

    def test_large_batch_commit_pairs_all_pair(self):
        evs = [(0.1, "s", "apply.commit",
                {"ver": 2, "pairs": [[f"c{i}", "k0"] for i in range(100)]})]
        evs += [(0.2, "w", "rpc.reply", {"cmd": "push", "cid": f"c{i}", "seq": "k0",
                                         "ok": True}) for i in range(100)]
        j, t = _feed_both(lambda m: m.AckAppliedMonitor(watermark_s=1.0), evs)
        assert j == t == []

    def test_violations_equal_when_they_fire(self):
        evs = [(1.0, "w", "rpc.reply", {"cmd": "push", "cid": "cA", "seq": "k0", "ok": True}),
               (1.1, "s", "apply.commit", {"ver": 2, "pairs": [["cB", "k1"]]}),
               (1.2, "s", "apply.commit", {"ver": 3, "pairs": [["cB", "k1"]]})]
        j, t = _feed_both(lambda m: m.AckAppliedMonitor(watermark_s=1.0), evs)
        assert j == t and {v["kind"] for v in t} == {"acked-but-unapplied",
                                                     "double-applied"}


def _all_kinds_rows():
    return [
        _push_ack(1.0, "cA", "k0"),
        _row(1.1, "apply.commit", {"ver": 2, "pairs": [["cB", "k1"]]}),
        _row(1.2, "apply.commit", {"ver": 3, "pairs": [["cB", "k1"]]}),
        _row(1.3, "rcu.publish", {"ver": 101}),
        _row(1.4, "rcu.publish", {"ver": 99}),
        _row(1.5, "ssp.finish", {"worker": 0, "step": 9}),
        _row(1.6, "ssp.wait", {"worker": 0, "step": 9, "granted": True}),
        _row(1.7, "rpc.heal.begin", {"cid": "cA"}),
    ] + [_row(2.0 + i * 0.01, "serve.shed", {"sig": "x"}) for i in range(12)]


def _auditors(**kw):
    return JA.Auditor(JCFG.AuditConfig(**kw)), TA.Auditor(TCFG.AuditConfig(**kw))


class TestAuditorParity:
    def test_all_monitor_kinds_through_one_auditor(self):
        reps = []
        v0 = wire_counters.get("audit_violations")
        for a in _auditors(watermark_s=1.0, heal_timeout_s=1.0, shed_storm_n=10,
                           shed_storm_window_s=1.0):
            a.set_ssp(num_workers=2, max_delay=1)
            a.ingest("n1", [_batch(0, _all_kinds_rows())], now=100.0)
            a.finish(now=200.0)
            reps.append(a.summary(recent=50))
        assert reps[0] == reps[1]
        assert set(reps[1]["by_kind"]) == {
            "acked-but-unapplied", "double-applied", "version-regression",
            "ssp-staleness", "reconnect-without-heal", "shed-storm"}
        assert reps[1]["total"] == 6
        assert wire_counters.get("audit_violations") == v0 + 6

    def test_seq_dedup_and_holes(self):
        reps = []
        ack = _push_ack(1.0, "c", "k0")
        for a in _auditors(watermark_s=1.0):
            a.ingest(3, [_batch(0, [ack])], now=10.0, role="worker")
            a.ingest(3, [_batch(0, [ack])], now=10.1, role="worker")  # re-shipped
            a.ingest(4, [_batch(0, [_row(2.0, "rcu.publish", {"ver": 9})])],
                     now=10.2, role="server")
            a.ingest(4, [_batch(4, [_row(2.1, "rcu.publish", {"ver": 10})])],
                     now=10.5, role="server")  # a seq gap: the server stream is holed
            a.flush(now=12.0)
            reps.append(a.summary())
        assert reps[0] == reps[1]
        assert reps[1]["total"] == 0 and reps[1]["suppressed"] == 1
        assert reps[1]["nodes"]["3"]["batches"] == 1
        assert reps[1]["nodes"]["4"]["gaps"] == 1

    def test_holed_worker_stream_does_not_blind_the_cluster(self):
        reps = []
        for a in _auditors(watermark_s=1.0):
            a.ingest(3, [_batch(0, [_push_ack(1.0, "c", "k0")], dropped=50)], now=10.0,
                     role="worker")
            a.ingest(4, [_batch(0, [_row(2.0, "rcu.publish", {"ver": 9})])], now=10.0,
                     role="server")
            a.flush(now=11.5)
            reps.append(a.summary())
        assert reps[0] == reps[1]
        assert reps[1]["by_kind"] == {"acked-but-unapplied": 1}
        assert reps[1]["holed"] == ["3"]

    def test_violations_reach_the_port_flight_recorder(self, tmp_path):
        TF.configure(str(tmp_path), process_name="aud-0", flush_interval_s=0,
                     watchdog_interval_s=3600)
        try:
            a = TA.Auditor(TCFG.AuditConfig())
            a.ingest("n1", [_batch(0, [_row(1.0, "rcu.publish", {"ver": 101}),
                                       _row(1.1, "rcu.publish", {"ver": 99})])], now=10.0)
            evs = [e for e in TF.events() if e[2] == "audit.violation"]
            assert len(evs) == 1 and evs[0][3]["kind"] == "version-regression"
            assert evs[0][3]["node"] == "n1"
        finally:
            TF.configure(None)


def _parity_stream():
    client = [
        _push_ack(1.2, "c1", "k0"),
        _row(2.0, "rpc.heal.begin", {"addr": "a", "cid": "c1"}),
        _row(2.5, "rpc.heal.failed", {"addr": "a", "cid": "c1"}),
    ]
    server = [
        _row(1.1, "rpc.in", {"cmd": "push", "cid": "c1", "seq": "k0"}),
        _row(3.0, "rcu.publish", {"ver": 101}),
        _row(3.1, "rcu.publish", {"ver": 99}),
    ] + [_row(4.0 + i * 0.01, "serve.shed", {"sig": "s"}) for i in range(12)]
    return client, server


def _dump(proc, pid, rows):
    return {"schema": "psbb/1", "process": proc, "pid": pid, "reason": "exit",
            "trigger_reasons": ["exit"], "wall_time": 0.0, "events": rows,
            "telemetry": {}, "threads": [], "stall": None}


class TestOfflineOnlineParity:
    KINDS = {"acked-but-unapplied", "version-regression", "reconnect-without-heal",
             "shed-storm"}

    def test_both_postmortems_and_both_auditors_flag_the_same_set(self):
        client, server = _parity_stream()
        dumps = [_dump("worker-0", 1, client), _dump("server-0", 2, server)]
        offline = []
        for pm in (JPM, TPM):
            tl = pm.merge_timeline(dumps)
            offline.append(pm.find_anomalies(dumps, tl))
        assert offline[0] == offline[1]
        assert {a["kind"] for a in offline[1]} == self.KINDS
        online = []
        for a in _auditors(watermark_s=1.0, heal_timeout_s=1.0):
            a.ingest(1, [_batch(0, client)], now=10.0)
            a.ingest(2, [_batch(0, [r for r in server if r[2] != "rpc.in"])], now=10.0)
            a.finish(now=100.0)
            online.append(a.summary(recent=50))
        assert online[0] == online[1]
        assert set(online[1]["by_kind"]) == self.KINDS

    def test_postmortem_renders_live_auditor_verdicts(self):
        coord = _dump("scheduler-0", 9, [_row(5.0, "audit.violation", {
            "kind": "acked-but-unapplied", "monitor": "ack-applied",
            "node": "3", "cid": "c1", "seq": "k0"})])
        an = TPM.find_anomalies([coord], TPM.merge_timeline([coord]))
        hits = [a for a in an if a["kind"] == "audit-violation"]
        assert hits and hits[0]["violation"] == "acked-but-unapplied"
        assert an == JPM.find_anomalies([coord], JPM.merge_timeline([coord]))


class TestCoordinatorAudit:
    def test_beat_batches_reach_the_auditor_and_dedup(self):
        coord = Coordinator(audit_cfg=TCFG.AuditConfig(watermark_s=0.2))
        ctl = ControlClient(coord.address)
        try:
            nid = ctl.register("server", rank=0)
            rows = [_row(1.0, "rcu.publish", {"ver": 101}),
                    _row(1.1, "rcu.publish", {"ver": 99})]
            ctl.beat(nid, {"audit": [_batch(0, rows)]})
            ctl.beat(nid, {"audit": [_batch(0, rows)]})  # re-shipped: a dup
            rep = ctl.audit()
            assert rep["total"] == 1 and rep["by_kind"] == {"version-regression": 1}
            st = rep["nodes"][str(nid)]
            assert st["batches"] == 1 and st["violations"] == 1
            assert ctl.telemetry()["audit"]["total"] == 1
            assert "audit" not in coord._monitor.latest_stats()[nid]
        finally:
            ctl.close()
            coord.stop()

    def test_ssp_init_teaches_the_monitor_its_bound(self):
        coord = Coordinator(audit_cfg=TCFG.AuditConfig(watermark_s=0.2))
        ctl = ControlClient(coord.address)
        try:
            nid = ctl.register("worker", rank=0)
            ctl.ssp_init(num_workers=2, max_delay=1)
            ctl.beat(nid, {"audit": [_batch(0, [
                _row(1.0, "ssp.finish", {"worker": 0, "step": 9}),
                _row(1.1, "ssp.wait", {"worker": 0, "step": 9, "granted": True})])]})
            deadline = time.monotonic() + 10.0
            rep = ctl.audit()
            while not rep["total"] and time.monotonic() < deadline:
                time.sleep(0.2)
                rep = ctl.audit()
            assert rep["by_kind"].get("ssp-staleness") == 1, rep
        finally:
            ctl.close()
            coord.stop()

    def test_heartbeat_reporter_ships_the_spool_and_acks(self):
        """The port reporter drains the spool into the beat and acks only
        a delivered beat: a failed send re-ships the same seqs."""
        from parameter_server_tpu_torch.utils.heartbeat import HeartbeatReporter

        class Sink:
            def __init__(self):
                self.ok, self.got = False, []

            def beat(self, node_id, stats=None):
                self.got.append([b["seq"] for b in stats.get("audit", [])])
                return self.ok

        TF.configure_spool(64, 2)
        try:
            for i in range(3):
                TF.record("rcu.publish", ver=100 + i)
            sink = Sink()
            rep = HeartbeatReporter(sink, 5, 3600.0, stats_fn=dict)
            rep._beat_once()  # delivery fails: nothing acked
            sink.ok = True
            rep._beat_once()  # the same seqs again, now acked
            rep._beat_once()
            assert sink.got[0] == sink.got[1] and sink.got[0] and sink.got[2] == []
        finally:
            TF.configure_spool(None)


@pytest.mark.parametrize("cli", [TC, JC], ids=["torch", "jax"])
@pytest.mark.parametrize("clean", [True, False])
def test_cli_audit_exit_codes(cli, clean, capsys):
    """0 on a clean cluster, 1 once a violation exists, for --json and
    --once, from either package's CLI against a port coordinator."""
    coord = Coordinator(audit_cfg=TCFG.AuditConfig())
    ctl = ControlClient(coord.address)
    try:
        nid = ctl.register("server", rank=0)
        vers = (101, 102) if clean else (101, 99)
        ctl.beat(nid, {"audit": [_batch(0, [_row(1.0, "rcu.publish", {"ver": vers[0]}),
                                            _row(1.1, "rcu.publish", {"ver": vers[1]})])]})
        want = 0 if clean else 1
        assert cli.main(["audit", "--scheduler", coord.address, "--json"]) == want
        doc = json.loads(capsys.readouterr().out)
        assert doc["total"] == want
        assert str(nid) in doc["nodes"] and doc["monitors"]
        assert cli.main(["audit", "--scheduler", coord.address, "--once"]) == want
        out = capsys.readouterr().out
        assert "ps audit" in out
        assert ("version-regression" in out) == (not clean)
    finally:
        ctl.close()
        coord.stop()


def test_live_drill_flags_an_acked_unapplied_push_within_a_beat_window(capsys):
    """A port child with the spool armed injects an acked push no apply
    commits and a same-life version rollback; the port coordinator's
    auditor flags both within a beat window (watermark 1 s, beats every
    0.1 s), and `cli audit` / `cli top` surface them."""
    coord = Coordinator(audit_cfg=TCFG.AuditConfig(watermark_s=1.0))
    env = {**os.environ,
           "PYTHONPATH": str(HERE.parent) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    child = subprocess.Popen(
        [sys.executable, str(HERE / "_torch_liveops_child.py"), coord.address, "audit"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )
    try:
        line = child.stdout.readline()
        assert line.startswith("READY"), (line, child.stderr.read()[-800:]
                                          if child.poll() is not None else "")
        deadline = time.monotonic() + 30.0
        rep = None
        while time.monotonic() < deadline:
            rep = coord._auditor.summary(recent=10)
            if rep["total"] >= 2:
                break
            coord._audit_pass()
            time.sleep(0.1)
        assert rep and set(rep["by_kind"]) == {"acked-but-unapplied",
                                               "version-regression"}, rep
        kinds = {v["kind"]: v for v in rep["recent"]}
        assert kinds["acked-but-unapplied"]["cid"] == "cX"
        assert kinds["version-regression"]["to"] == (7 << 40) + 99
        assert TC.main(["audit", "--scheduler", coord.address, "--once"]) == 1
        out = capsys.readouterr().out
        assert "acked-but-unapplied" in out and "version-regression" in out
        assert TC.main(["top", "--scheduler", coord.address, "--once"]) == 0
        out = capsys.readouterr().out
        assert "AUDIT VIOLATIONS" in out
        assert next(ln for ln in out.splitlines() if " worker " in ln).split()[10] == "2"
    finally:
        child.kill()
        child.wait(timeout=10)
        child.stdout.close()
        child.stderr.close()
        coord.stop()
