"""The port's live operations plane against the JAX package's on the same
inputs: the time-series ring's deltas and windowed summaries, the
OpenMetrics exposition, the SLO engine's verdicts, the beat payload caps,
the sampling profiler (disarmed identity, armed stacks reaching the
telemetry snapshot), the metrics endpoint, and ``cli top`` against a port
coordinator fed by one heartbeating port child."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
import time
import urllib.request
from pathlib import Path

import numpy as np
import pytest
import torch

from parameter_server_tpu import cli as JC
from parameter_server_tpu.utils import metrics as JM
from parameter_server_tpu.utils import profiler as JP
from parameter_server_tpu.utils import slo as JS
from parameter_server_tpu.utils import timeseries as JT
from parameter_server_tpu.utils.heartbeat import HeartbeatMonitor as JMon
from parameter_server_tpu_torch import cli as TC
from parameter_server_tpu_torch.parallel.control import ControlClient, Coordinator
from parameter_server_tpu_torch.utils import metrics as TM
from parameter_server_tpu_torch.utils import profiler as TP
from parameter_server_tpu_torch.utils import slo as TS
from parameter_server_tpu_torch.utils import timeseries as TT
from parameter_server_tpu_torch.utils.config import PSConfig
from parameter_server_tpu_torch.utils.heartbeat import HeartbeatMonitor as TMon
from test_liveops import validate_openmetrics

torch.set_num_threads(1)

HERE = Path(__file__).resolve().parent
PKG_LABEL = 'package="parameter_server_tpu_torch",'


def _snap(counters=None, hists=None, **extra):
    return {"counters": dict(counters or {}), "hists": dict(hists or {}),
            "timers": {}, **extra}


def _cum_snaps(seed: int, n: int = 12) -> list[dict]:
    """A cumulative snapshot sequence as one node's beats would carry it:
    counters that grow, peaks, latency and count-valued histograms."""
    rng = np.random.default_rng(seed)
    ctr = {"wire_bytes_out": 0, "serve_shed": 0, "pushes": 0}
    hists: dict[str, dict] = {}
    out = []
    for i in range(n):
        for k in ctr:
            ctr[k] += int(rng.integers(0, 500))
        if seed % 2 and i == n // 2:
            ctr["pushes"] = 3  # a restart: the ring re-baselines
        for name in ("server.push", "client.pull", "server.apply_queue.n"):
            h = hists.setdefault(name, {"count": 0, "sum_s": 0.0, "buckets": {}})
            for b in rng.integers(0, 20, int(rng.integers(0, 6))).tolist():
                h["buckets"][str(b)] = h["buckets"].get(str(b), 0) + 1
                h["count"] += 1
                h["sum_s"] += (1 << b) / 1e6
        snap = _snap({**ctr, "rpc_inflight_peak": int(rng.integers(0, 9))},
                     json.loads(json.dumps(hists)))
        out.append(snap)
    return out


class TestTimeSeriesRingParity:
    @pytest.mark.parametrize("seed", [0, 1, 2, 3])
    def test_same_beats_same_summaries(self, seed):
        rings = [JT.TimeSeriesRing(8), TT.TimeSeriesRing(8)]
        for i, s in enumerate(_cum_snaps(seed)):
            got = [r.observe(json.loads(json.dumps(s)), ts=100.0 + i * 0.5)
                   for r in rings]
            assert got[0] == got[1]
        now = 100.0 + 11 * 0.5
        j, t = rings
        assert j.entries() == t.entries()
        for w in (1.0, 2.5, 60.0):
            assert j.window(w, now=now) == t.window(w, now=now)
            assert j.summary(w, now=now) == t.summary(w, now=now)
            assert j.rate("pushes", w, now=now) == t.rate("pushes", w, now=now)
            assert (j.percentile("server.push", 0.99, w, now=now)
                    == t.percentile("server.push", 0.99, w, now=now))

    def test_out_of_order_observe_is_discarded(self):
        for m in (JT, TT):
            r = m.TimeSeriesRing()
            r.observe(_snap({"a": 0}), ts=10.0)
            r.observe(_snap({"a": 5}), ts=11.0)
            assert r.observe(_snap({"a": 9}), ts=10.5) is None
            assert len(r.entries()) == 1

    def test_heartbeat_monitor_retains_the_same_series(self):
        mons = [JMon(timeout_s=30.0, series_capacity=8),
                TMon(timeout_s=30.0, series_capacity=8)]
        for i in range(5):
            for m in mons:
                m.beat(3, {"telemetry": _snap({"pushes": i * 10})})
        rings = [m.node_series() for m in mons]
        assert list(rings[0]) == list(rings[1]) == [3]
        assert len(rings[1][3].entries()) == 4  # 5 beats -> 4 deltas
        assert mons[1].latest_stats()[3]["telemetry"]["counters"]["pushes"] == 40
        mons[1].forget(3)
        assert mons[1].node_series() == {}


class TestOpenMetricsParity:
    @pytest.mark.parametrize("proc", ["server-1", "worker-0", "train", ""])
    def test_text_equal_apart_from_the_package_label(self, proc):
        snap = _cum_snaps(5)[-1]
        snap["counters"].update({"range.0-100.push": 7, "range.100-200.pull": 3})
        snap["hists"]["range.0-100.apply"] = {"count": 2, "sum_s": 0.002,
                                              "buckets": {"10": 2}}
        snap["hists"]["client.push"] = {
            "count": 3, "sum_s": 0.01, "buckets": {"13": 3},
            "ex": {"v": 0.008, "tid": "feedfacecafef00d", "ts": 1.0}}
        jt = JT.render_openmetrics(snap, proc=proc)
        tt = TT.render_openmetrics(snap, proc=proc)
        assert PKG_LABEL in tt and PKG_LABEL not in jt
        assert tt.replace(PKG_LABEL, "") == jt
        types = validate_openmetrics(tt)
        assert types["ps_build_info"] == "gauge"

    def test_virgin_snapshot_carries_the_always_present_series(self):
        text = TT.render_openmetrics({"counters": {}, "hists": {}, "timers": {}},
                                     proc="server-1")
        validate_openmetrics(text)
        assert 'role="server"' in text and 'rank="1"' in text
        assert 'ps_audit_violations_total{proc="server-1"} 0' in text

    def test_build_info_names_the_port(self):
        info = TT.build_info("worker-3")
        assert info == {"package": "parameter_server_tpu_torch", "role": "worker",
                        "rank": "3", "version": JT.build_info("worker-3")["version"]}


class TestSloEngineParity:
    @staticmethod
    def _rings(m, kind: str):
        ring = m.TimeSeriesRing()
        if kind == "storm":
            ring.observe(_snap({"serve_shed": 0}), ts=1000.0)
            for i in range(1, 9):
                ring.observe(_snap({"serve_shed": i * 100}), ts=1000.0 + i)
        elif kind == "blip":
            for i in range(19):
                ring.observe(_snap({"serve_shed": 0}), ts=float(i))
            ring.observe(_snap({"serve_shed": 100}), ts=19.0)
        else:  # slow pushes
            for i in range(1, 9):
                ring.observe(_snap(hists={"server.push": {
                    "count": 4 * i, "sum_s": 0.2 * i, "buckets": {"19": 4 * i}}}),
                    ts=100.0 + i)
        return ring

    @pytest.mark.parametrize("kind,now", [("storm", 1008.0), ("blip", 19.0),
                                          ("slow", 108.0)])
    def test_same_rings_same_verdicts(self, kind, now):
        rules = PSConfig().slo.rules + ["shed rate:serve_shed <= 2 target 0.9 burn 2"]
        reps = []
        for m, s in ((JT, JS), (TT, TS)):
            eng = s.SloEngine(s.parse_rules(rules), short_window_s=3, long_window_s=6)
            ring = self._rings(m, kind)
            reps.append([eng.evaluate({7: ring, "coord": m.TimeSeriesRing()}, now=now)
                         for _ in range(3)] + [eng.episodes])
        assert reps[0] == reps[1]
        # each burning rule fires once per episode however often evaluated:
        # the storm burns both shed rules, the blip only the default one
        # (its 10x burn over short windows), the slow pushes push_p99_ms
        assert reps[1][-1] == {"storm": 2, "blip": 1, "slow": 1}[kind]

    @pytest.mark.parametrize("spec", [
        "shed rate:serve_shed <= 2 target 0.9 burn 3", "q p99:server.push <= 250",
        "noop", "x rate:serve_shed >= 2", "x blah:serve_shed <= 2",
        "x rate:serve_shed <= 2 target", "x rate:serve_shed <= 2 frobnicate 2",
    ])
    def test_rule_grammar(self, spec):
        try:
            want = JS.parse_rule(spec)
        except ValueError:
            with pytest.raises(ValueError):
                TS.parse_rule(spec)
            return
        got = TS.parse_rule(spec)
        assert (got.name, got.kind, got.series, got.threshold, got.target, got.burn) == (
            want.name, want.kind, want.series, want.threshold, want.target, want.burn)


class TestBeatPayloadCaps:
    def test_caps_equal_jax(self):
        for name in ("BEAT_MAX_HISTS", "BEAT_MAX_PROF", "BEAT_MAX_STACK_CHARS",
                     "BEAT_MAX_RANGES", "OM_MAX_RANGE_LABELS"):
            assert getattr(TT, name) == getattr(JT, name), name

    def test_long_run_payload_equal_and_bounded(self):
        hists = {f"server.cmd{i:04d}": {"count": i + 1, "sum_s": (i + 1) * 1e-3,
                                        "buckets": {"12": i + 1}} for i in range(400)}
        counters = {f"range.{i * 10}-{i * 10 + 10}.push": i for i in range(100)}
        outs = []
        for m in (JT, TT):
            snap = _snap({"wire_bytes_out": 1, **counters}, hists)
            snap["prof"] = [{"s": "frame;" * 2000, "n": 5} for _ in range(50)]
            ring0 = m.reset_local_ring()
            outs.append(m.beat_telemetry(snap))
            assert m.local_ring() is ring0
        assert outs[0] == outs[1]
        out = outs[1]
        assert len(out["hists"]) == TT.BEAT_MAX_HISTS + 1
        assert len(out["prof"]) == TT.BEAT_MAX_PROF
        assert len(json.dumps(out)) < 64_000


class TestProfiler:
    def test_disarmed_is_identity_pinned_noop(self):
        assert TP.top_stacks is TP._noop_top_stacks
        assert not TP.enabled()
        assert "prof" not in TM.telemetry_snapshot(roll_peaks=False)

    def test_armed_stacks_reach_the_port_snapshot(self):
        """The snapshot finds the port's profiler (not the JAX package's,
        which stays disarmed) through ``sys.modules``."""
        def _torch_busy_loop(stop):
            while not stop.is_set():
                sum(i * i for i in range(200))

        stop = threading.Event()
        t = threading.Thread(target=_torch_busy_loop, args=(stop,), name="busy")
        t.start()
        p = TP.configure(500, top_n=10, process_name="prof-test")
        try:
            deadline = time.monotonic() + 5.0
            while p.samples < 30 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert p.samples >= 30 and not JP.enabled()
            prof = TM.telemetry_snapshot(roll_peaks=False)["prof"]
            assert any("_torch_busy_loop" in s["s"] for s in prof)
            assert "prof" not in JM.telemetry_snapshot(roll_peaks=False)
            assert TM.wire_counters.get("prof_samples") > 0
        finally:
            stop.set()
            t.join()
            TP.configure(0)
        assert TP.top_stacks is TP._noop_top_stacks

    def test_dump_writes_collapsed_and_perfetto_exports(self, tmp_path):
        p = TP.SamplingProfiler(hz=100, process_name="dump-test")
        for _ in range(20):
            p.sample_once()
        out = p.dump(str(tmp_path))
        lines = Path(out["collapsed"]).read_text().splitlines()
        assert lines and all(ln.rsplit(" ", 1)[1].isdigit() for ln in lines)
        doc = json.loads(Path(out["trace"]).read_text())
        assert [e for e in doc["traceEvents"] if e.get("ph") == "X"]

    @pytest.mark.parametrize("value", ["", "off", "0", "1", "true", "97", "not-a-rate"])
    def test_env_hz_grammar(self, value):
        assert TP.env_hz(value) == JP.env_hz(value)


class TestMetricsEndpoint:
    def test_live_scrape_and_healthz(self):
        TM.wire_counters.inc("pushes", 2)
        srv = TT.start_metrics_server(0, process_name="server-0")
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/metrics",
                                        timeout=10) as resp:
                assert "openmetrics-text" in resp.headers["Content-Type"]
                text = resp.read().decode()
            validate_openmetrics(text)
            assert 'ps_build_info{proc="server-0",package="parameter_server_tpu_torch"' in text
            assert "ps_pushes_total" in text
            with urllib.request.urlopen(f"http://127.0.0.1:{srv.port}/healthz",
                                        timeout=10) as resp:
                doc = json.loads(resp.read().decode())
            assert doc["ok"] is True and doc["proc"] == "server-0"
        finally:
            srv.close()

    def test_collision_walks_to_the_next_offset(self):
        import socket

        with socket.socket() as s:
            s.bind(("127.0.0.1", 0))
            base = s.getsockname()[1]
        s1 = TT.start_metrics_server(base, process_name="a-0")
        s2 = None
        try:
            s2 = TT.start_metrics_server(base, process_name="b-0")
            assert (s1.port, s2.port, s2.requested_port) == (base, base + 1, base)
        finally:
            s1.close()
            if s2 is not None:
                s2.close()

    def test_close_paths_are_idempotent(self):
        srv = TT.start_metrics_server(0, process_name="x-0")
        roller = TT.Roller(999.0)
        TP.configure(100, process_name="x-0")
        names = {t.name for t in threading.enumerate()}
        assert {"ps-metrics", "ps-ts-roller", "ps-profiler"} <= names
        for _ in range(2):
            srv.close()
            roller.close()
            TP.configure(0)
        assert TP.current() is None


@pytest.fixture(scope="module")
def live():
    """A port coordinator and one heartbeating port child (the file's one
    spawned process)."""
    coord = Coordinator()
    env = {**os.environ,
           "PYTHONPATH": str(HERE.parent) + os.pathsep + os.environ.get("PYTHONPATH", "")}
    child = subprocess.Popen(
        [sys.executable, str(HERE / "_torch_liveops_child.py"), coord.address, "top"],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
    )
    try:
        line = child.stdout.readline()
        assert line.startswith("READY"), (line, child.stderr.read()[-800:]
                                          if child.poll() is not None else "")
        deadline = time.monotonic() + 30.0
        while time.monotonic() < deadline:
            rings = coord._monitor.node_series()
            if rings and len(next(iter(rings.values())).entries()) >= 3:
                break
            time.sleep(0.05)
        else:
            pytest.fail("the child's beats never reached the coordinator")
        yield coord
    finally:
        child.kill()
        child.wait(timeout=10)
        child.stdout.close()
        child.stderr.close()
        coord.stop()


class TestLiveCluster:
    @pytest.mark.parametrize("cli", [TC, JC], ids=["torch", "jax"])
    def test_cli_top_once_renders_the_port_cluster(self, live, cli, capsys):
        assert cli.main(["top", "--scheduler", live.address, "--once",
                         "--window", "30"]) == 0
        out = capsys.readouterr().out
        assert "ps top" in out and "no active SLO alerts" in out
        cols = next(ln for ln in out.splitlines() if " worker " in ln).split()
        assert float(cols[3]) > 0 and float(cols[6]) > 0  # push rate, p99
        assert cols[9] == "100"  # health

    def test_cli_top_json_schema(self, live, capsys):
        assert TC.main(["top", "--scheduler", live.address, "--json",
                        "--window", "30"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert set(doc) == {"window_s", "nodes", "series", "health", "alerts", "audit"}
        (nid,) = [k for k, v in doc["nodes"].items() if v["role"] == "worker"]
        s = doc["series"][nid]
        assert {"rates", "p50", "p99", "hist_rates"} <= set(s)
        assert s["rates"]["wire_bytes_out"] > 0
        assert doc["health"][nid]["score"] == 100 and doc["alerts"] == []
        assert doc["audit"]["total"] == 0 and doc["audit"]["monitors"]

    def test_jax_format_top_renders_the_port_reply(self, live, monkeypatch):
        monkeypatch.setattr(time, "strftime", lambda fmt: "12:00:00")  # the frame's clock
        c = ControlClient(live.address)
        try:
            rep = c.telemetry(window_s=30)
        finally:
            c.close()
        assert {"series", "slo", "audit"} <= set(rep)
        assert JS.format_top(rep, 30.0) == TS.format_top(rep, 30.0)
        assert JS.ranges_view(rep, 30.0) == TS.ranges_view(rep, 30.0)
