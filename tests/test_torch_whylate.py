"""The port's latency forensics (``analysis/critpath.py``, ``cli whylate``)
against the JAX package's: both engines on one synthetic capture built
from fixed timestamps, the port engine on a JAX capture and the JAX
engine on a port capture, the live mode against a port coordinator, and
the baseline gate's tiered exit codes. No test here gates on a measured
latency: every capture a gate reads is built from fixed timestamps."""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from parameter_server_tpu import cli as JC
from parameter_server_tpu.analysis import critpath as JCP
from parameter_server_tpu.kv import updaters as JU
from parameter_server_tpu.parallel import multislice as JMS
from parameter_server_tpu.utils import config as JCFG
from parameter_server_tpu.utils import keyrange as JK
from parameter_server_tpu.utils import trace as JTR
from parameter_server_tpu_torch import cli as TC
from parameter_server_tpu_torch.analysis import critpath as TCP
from parameter_server_tpu_torch.kv import updaters as TU
from parameter_server_tpu_torch.parallel import multislice as TMS
from parameter_server_tpu_torch.parallel.control import ControlClient, Coordinator
from parameter_server_tpu_torch.utils import config as TCFG
from parameter_server_tpu_torch.utils import keyrange as TK
from parameter_server_tpu_torch.utils import metrics as TM
from parameter_server_tpu_torch.utils import slo as TS
from parameter_server_tpu_torch.utils import trace as TTR

torch.set_num_threads(1)

REPO = Path(__file__).resolve().parent.parent


def _tev(name, ph, ts, dur=None, pid=100, tid=None, span=None, parent=None, **args):
    a = dict(args)
    if tid is not None:
        a["trace_id"] = tid
    if span is not None:
        a["span_id"] = span
    if parent is not None:
        a["parent_id"] = parent
    e = {"name": name, "cat": "t", "ph": ph, "ts": ts, "pid": pid, "tid": 1, "args": a}
    if dur is not None:
        e["dur"] = dur
    if ph == "f":
        e["id"] = "f-" + (tid or "x")
        e["bp"] = "e"
    return e


def _push_chain(tid, t0=0.0, wire_us=7000.0, skew_us=0.0, cmd="push"):
    """One cross-process push from fixed timestamps: 10 ms in all,
    ``wire_us`` on the forward wire, a batched apply, a withheld reply."""
    sk = -skew_us
    return [
        _tev(f"ps.{cmd}", "X", t0, dur=300, tid=tid, span="root"),
        _tev(f"rpc.{cmd}", "X", t0 + 50, dur=150, tid=tid, span="rpc", parent="root"),
        _tev(f"rpc.serve.{cmd}", "X", t0 + 200 + wire_us + sk, dur=400, pid=200, tid=tid,
             span="srv", parent="rpc"),
        _tev("server.updater", "X", t0 + 1100 + wire_us + sk, dur=200, pid=200, tid=tid,
             span="upd"),
        _tev(f"ps.{cmd}.inflight", "f", t0 + 10000, tid=tid, parent="root"),
    ]


def _capture(tmp_path: Path, n: int = 12, wire_us=(2000.0, 9000.0)) -> str:
    """A trace dir of ``n`` pushes, client and server files apart, wire
    times spread over ``wire_us`` (fixed, not measured)."""
    d = tmp_path / "cap"
    d.mkdir()
    evs = []
    for i, w in enumerate(np.linspace(*wire_us, n)):
        evs += _push_chain(f"t{i:03d}", t0=i * 20_000.0, wire_us=float(w))
    (d / "trace-worker-0-100.json").write_text(
        json.dumps({"traceEvents": [e for e in evs if e["pid"] == 100]}))
    (d / "trace-server-0-200.json").write_text(
        json.dumps({"traceEvents": [e for e in evs if e["pid"] == 200]}))
    return str(d)


class TestCritpathParity:
    @pytest.mark.parametrize("skew_us", [0.0, 50_000.0])
    def test_trace_ops_equal(self, skew_us):
        evs = _push_chain("t1", skew_us=skew_us)
        ops = TCP.ops_from_trace(evs)
        assert ops == JCP.ops_from_trace(evs) and len(ops) == 1
        assert ops[0]["skewed"] == (skew_us > 0)
        assert all(v >= 0 for v in ops[0]["segments"].values())
        assert TCP.aggregate(ops) == JCP.aggregate(ops)

    def test_step_op_and_retry_equal(self):
        step = [
            _tev("step", "X", 0, dur=10_000, tid="s", span="stp"),
            _tev("step.ssp_wait", "X", 100, dur=6_000, tid="s", span="w", parent="stp"),
            _tev("step.pull", "X", 6_200, dur=2_000, tid="s", span="p", parent="stp"),
        ]
        retry = _push_chain("r") + [
            _tev("rpc.retry", "i", 300, tid="r", parent="rpc"),
            _tev("rpc.serve.push", "X", 8200, dur=300, pid=200, tid="r", span="srv2",
                 parent="rpc")]
        for evs in (step, retry):
            assert TCP.ops_from_trace(evs) == JCP.ops_from_trace(evs)
        assert TCP.ops_from_trace(step)[0]["segments"]["ssp_wait"] == pytest.approx(6.0)

    @pytest.mark.parametrize("skew_s", [0.0, 0.05])
    def test_blackbox_ops_equal(self, skew_s):
        def ev(ts, proc, pid, etype, **args):
            return {"ts": ts, "proc": proc, "pid": pid, "tid": 1, "etype": etype,
                    "args": args}

        chain = [
            ev(10.000, "worker-0", 1, "rpc.issue", cmd="push", cid="c1", seq=1),
            ev(10.004 - skew_s, "server-0", 2, "rpc.in", cmd="push", cid="c1", seq=1, n=64),
            ev(10.006 - skew_s, "server-0", 2, "apply.commit", ver=2, pushes=1,
               pairs=[["c1", 1]]),
            ev(10.010, "worker-0", 1, "rpc.reply", cmd="push", cid="c1", seq=1, ok=True),
        ]
        ops = TCP.ops_from_blackbox(chain)
        assert ops == JCP.ops_from_blackbox(chain) and len(ops) == 1
        assert ops[0]["skewed"] == (skew_s > 0)

    def test_analyze_dir_and_report_equal(self, tmp_path):
        cap = _capture(tmp_path)
        s = TCP.analyze_dir(cap, top=3)
        assert s == JCP.analyze_dir(cap, top=3)
        assert s["mode"] == "trace" and s["ops"] == 12
        assert set(s["cmds"]["push"]["slowest"][0]["segments"]) <= set(TCP.SEGMENTS)
        assert TCP.render_report(s, top=3) == JCP.render_report(s, top=3)
        assert TCP.SEGMENTS == JCP.SEGMENTS


def _traced_run(tmp_path: Path, pkg: str) -> str:
    """A real in-process capture: 6 pushes and pulls through one
    package's ShardServer and ServerHandle with its tracer armed."""
    d = tmp_path / f"cap-{pkg}"
    d.mkdir()
    keys = np.arange(1, 17, dtype=np.int64)
    g = np.ones(16, dtype=np.float32)
    if pkg == "jax":
        tr = JTR
        t = tr.configure(str(d), process_name="gate")
        srv = JMS.ShardServer(JU.Sgd(eta=0.1), JK.KeyRange(0, 1024)).start()
        h = JMS.ServerHandle(srv.address, 0, 0, JCFG.PSConfig(), range_size=1024)
    else:
        tr = TTR
        t = tr.configure(str(d), process_name="gate")
        srv = TMS.ShardServer(TU.Sgd(eta=0.1), TK.KeyRange(0, 1024), device="cpu").start()
        h = TMS.ServerHandle(srv.address, 0, 0, TCFG.PSConfig(), range_size=1024,
                             device="cpu")
    try:
        for _ in range(6):
            h.push(keys, g)
            h.pull(keys)
        h.shutdown()
        h.close()
        t.flush()
    finally:
        tr.configure(None)
    return str(d)


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_each_engine_reads_the_other_packages_capture(tmp_path, pkg):
    """The port engine on a JAX capture and the JAX engine on a port
    capture: the same ops and the same segment times."""
    cap = _traced_run(tmp_path, pkg)
    s = TCP.analyze_dir(cap)
    assert s == JCP.analyze_dir(cap)
    assert s["cmds"]["push"]["n"] == 6 and s["cmds"]["pull"]["n"] == 6
    ops = TCP.ops_from_trace(TCP.load_trace_dir(cap))
    assert ops == JCP.ops_from_trace(JCP.load_trace_dir(cap))
    for op in ops:
        assert set(op["segments"]) <= set(TCP.SEGMENTS)
        assert "server" in op["segments"] and all(v >= 0 for v in op["segments"].values())


class TestBaselineGate:
    @pytest.mark.parametrize("budget_ms,want", [(1000.0, 0), (6.0, 2), (0.5, 1)])
    def test_tiered_exit_codes(self, tmp_path, capsys, budget_ms, want):
        """Wire p99 of the fixed capture is 9 ms: within 1000 ms passes,
        past 6 ms but within 4 x 6 ms is soft (2), past 4 x 0.5 ms hard (1)."""
        cap = _capture(tmp_path)
        bl = tmp_path / "bl.json"
        bl.write_text(json.dumps({"version": 1, "hard_factor": 4.0,
                                  "budgets_ms": {"push": {"wire": budget_ms}}}))
        rcs = []
        for cli in (TC, JC):
            rcs.append(cli.main(["whylate", cap, "--baseline", str(bl), "--json"]))
            doc = json.loads(capsys.readouterr().out)
            if want:
                f = doc["baseline_findings"][0]
                assert (f["cmd"], f["segment"]) == ("push", "wire")
        assert rcs == [want, want]

    def test_update_baseline_writes_the_jax_format(self, tmp_path, capsys):
        cap = _capture(tmp_path)
        out = {}
        for name, cli in (("torch", TC), ("jax", JC)):
            bl = tmp_path / f"{name}.json"
            assert cli.main(["whylate", cap, "--baseline", str(bl),
                             "--update-baseline"]) == 0
            out[name] = json.loads(bl.read_text())
        capsys.readouterr()
        assert out["torch"] == out["jax"]
        assert out["torch"]["budgets_ms"]["push"]
        # either engine loads it, and the capture that wrote it passes it
        assert JCP.load_baseline(str(tmp_path / "torch.json")) == TCP.load_baseline(
            str(tmp_path / "torch.json"))
        assert TC.main(["whylate", cap, "--baseline", str(tmp_path / "torch.json")]) == 0
        capsys.readouterr()

    def test_the_committed_baseline_loads(self):
        path = str(REPO / "whylate_baseline.json")
        assert TCP.load_baseline(path) == JCP.load_baseline(path)

    def test_refusals(self, tmp_path):
        empty = tmp_path / "empty"
        empty.mkdir()
        for argv in (["whylate", str(empty), "--baseline",
                      str(REPO / "whylate_baseline.json")],
                     ["whylate", str(tmp_path), "--update-baseline"],
                     ["whylate", "--scheduler", "127.0.0.1:1", "--baseline", "b.json"],
                     ["whylate"]):
            with pytest.raises(SystemExit):
                TC.main(argv)


class TestLiveWhylate:
    def test_scheduler_mode_and_top_line(self, capsys):
        TM.slow_ops.reset()
        coord = Coordinator()
        ctl = ControlClient(coord.address)
        try:
            nid = ctl.register("worker", rank=0)
            ctl.beat(nid, {"telemetry": {
                "counters": {}, "hists": {}, "timers": {},
                "slow": {"push": [{
                    "cmd": "push", "dur_ms": 42.0, "ts": 4e9, "tid": "feedface00000000",
                    "seg": {"wire": 39.0, "server": 2.0, "apply_wait": 0.6,
                            "apply": 0.4}}]},
            }})
            rep = ctl.telemetry()
            assert rep["merged"]["slow"]["push"][0]["dur_ms"] == 42.0
            frame = TS.format_top(rep, 30.0)
            assert "slowest push: 42.0ms" in frame and "tid=feedface00000000" in frame
            assert TCP.analyze_live(rep) == JCP.analyze_live(rep)
            for cli in (TC, JC):
                assert cli.main(["whylate", "--scheduler", coord.address, "--json"]) == 0
                doc = json.loads(capsys.readouterr().out)
                assert doc["mode"] == "live"
                push = doc["cmds"]["push"]
                assert push["slowest"][0]["dur_ms"] == 42.0
                att = push["attribution_pct"]
                assert max(att, key=att.get) == "wire"
        finally:
            ctl.close()
            coord.stop()


def test_client_histogram_carries_the_trace_exemplar(tmp_path):
    """A traced port RPC's trace id is the ``client.push`` exemplar."""
    TM.latency_histograms.snapshot(roll_exemplars=True)
    TTR.configure(str(tmp_path), process_name="ex-test")
    try:
        srv = TMS.ShardServer(TU.Sgd(eta=0.1), TK.KeyRange(0, 1024), device="cpu").start()
        h = TMS.ServerHandle(srv.address, 0, 0, TCFG.PSConfig(), range_size=1024,
                             device="cpu")
        h.push(np.arange(1, 9, dtype=np.int64), np.ones(8, np.float32))
        h.shutdown()
        h.close()
        ex = TM.latency_histograms.snapshot()["client.push"].get("ex")
        assert ex and any(e["args"].get("trace_id") == ex["tid"]
                          for e in TTR.tracer.events())
    finally:
        TTR.configure(None)
