"""Port parity for the black box (``parameter_server_tpu_torch/utils/
flightrec.py``, a copy of the JAX package's).

Mirrors the JAX package's ``tests/test_blackbox.py``: the disarmed
recorder is an identity-pinned no-op, the armed ring is bounded and dumps
atomically with thread stacks and telemetry, the periodic flusher, the
thread-exception hook, the watchdog's busy-without-progress policy, an
induced apply-thread stall named by the postmortem, and a SIGKILL'd server
process under frame chaos whose box stitches with its client's. The
postmortem that reads the port's dumps is the JAX package's
(``parameter_server_tpu.utils.postmortem``, its ``cli postmortem`` too):
the ``psbb/1`` schema and the event types are one contract. Then a
SIGTERM'd server's dump, the audit spool's buffer against the JAX one, and
a port cluster's dump dir."""

from __future__ import annotations

import json
import os
import signal
import subprocess
import sys
import threading
import time
from pathlib import Path

import numpy as np
import pytest

from parameter_server_tpu.utils import flightrec as jflightrec
from parameter_server_tpu.utils import postmortem as pm
from parameter_server_tpu_torch.utils import flightrec
from parameter_server_tpu_torch.utils.metrics import (
    merge_telemetry,
    telemetry_snapshot,
    wire_counters,
)

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(autouse=True)
def _disarm_after():
    """Every test leaves the recorder disarmed, with the identity-pinned
    no-op re-bound."""
    yield
    flightrec.configure(None)
    flightrec.configure_spool(None)


def _wait_for(pred, what: str, timeout: float = 10.0):
    deadline = time.monotonic() + timeout
    while time.monotonic() < deadline:
        v = pred()
        if v:
            return v
        time.sleep(0.02)
    raise AssertionError(f"timed out waiting for {what}")


class TestRecorder:
    def test_disabled_is_identity_pinned_noop(self):
        flightrec.configure(None)
        assert flightrec.record is flightrec._noop_record
        assert flightrec._buf is None
        flightrec.record("rpc.in", cmd="push", cid="c", seq=1)
        assert flightrec.events() == []
        assert not flightrec.enabled()

    def test_armed_ring_is_bounded_and_swaps_record(self, tmp_path):
        flightrec.configure(str(tmp_path), capacity=16, process_name="t-0",
                            flush_interval_s=0, watchdog_interval_s=60)
        assert flightrec.record is flightrec._live_record
        for i in range(100):
            flightrec.record("x", i=i)
        evs = flightrec.events()
        assert len(evs) == 16 and evs[-1][3] == {"i": 99}
        flightrec.configure(None)
        assert flightrec.record is flightrec._noop_record

    def test_dump_schema_threads_and_telemetry(self, tmp_path):
        flightrec.configure(str(tmp_path), process_name="t-0",
                            flush_interval_s=0, watchdog_interval_s=60)
        flightrec.record("rpc.in", cmd="push", cid="c1", seq="k0")
        path = flightrec.dump("unit-test")
        doc = json.loads(Path(path).read_text())
        assert doc["schema"] == "psbb/1"
        assert doc["process"] == "t-0" and doc["pid"] == os.getpid()
        assert doc["reason"] == "unit-test" and "unit-test" in doc["trigger_reasons"]
        assert [e[2] for e in doc["events"]] == ["rpc.in"]
        assert doc["events"][0][3] == {"cmd": "push", "cid": "c1", "seq": "k0"}
        main = next(t for t in doc["threads"] if t["name"] == "MainThread")
        assert main["stack"] and "dump" in "".join(main["stack"])
        # the telemetry section carries the JAX snapshot's keys
        assert {"counters", "hists", "timers"} <= set(doc["telemetry"])
        # the JAX postmortem loads it like one of its own
        assert pm.load_dumps(str(tmp_path))[0]["process"] == "t-0"

    def test_disarm_stops_a_dump_under_way(self, tmp_path, monkeypatch):
        """A dump that began before ``configure(None)`` writes nothing once
        it returns, so the caller may delete the dir at once."""
        from parameter_server_tpu_torch.utils import metrics

        flightrec.configure(str(tmp_path), process_name="t-0",
                            flush_interval_s=0, watchdog_interval_s=60)
        flightrec.record("x", i=1)
        building, release = threading.Event(), threading.Event()
        snap = metrics.telemetry_snapshot

        def slow_snapshot(**kw):
            building.set()
            release.wait(10)
            return snap(**kw)

        monkeypatch.setattr(metrics, "telemetry_snapshot", slow_snapshot)
        out = []
        t = threading.Thread(target=lambda: out.append(flightrec.dump("late")))
        t.start()
        assert building.wait(10)
        flightrec.configure(None)
        release.set()
        t.join(10)
        assert out == [None] and list(tmp_path.iterdir()) == []

    def test_periodic_flusher_persists_without_triggers(self, tmp_path):
        flightrec.configure(str(tmp_path), process_name="t-0",
                            flush_interval_s=0.05, watchdog_interval_s=60)
        flightrec.record("x", i=1)
        path = tmp_path / f"blackbox-t-0-{os.getpid()}.json"
        _wait_for(path.exists, "periodic flush", timeout=5)
        doc = json.loads(path.read_text())
        assert doc["reason"] == "periodic" and "periodic" not in doc["trigger_reasons"]

    @pytest.mark.filterwarnings("ignore::pytest.PytestUnhandledThreadExceptionWarning")
    def test_thread_exception_dumps(self, tmp_path):
        flightrec.configure(str(tmp_path), process_name="t-0",
                            flush_interval_s=0, watchdog_interval_s=60)

        def boom():
            raise RuntimeError("induced")

        t = threading.Thread(target=boom, name="ps-test-boom")
        t.start()
        t.join()
        path = tmp_path / f"blackbox-t-0-{os.getpid()}.json"
        _wait_for(path.exists, "excepthook dump", timeout=5)
        doc = json.loads(path.read_text())
        assert any(r.startswith("thread-exception:ps-test-boom")
                   for r in doc["trigger_reasons"]), doc["trigger_reasons"]
        assert any(e[2] == "thread.exception" for e in doc["events"])


class TestWatchdog:
    def test_busy_without_progress_fires_once_then_rearms(self):
        wd = flightrec.Watchdog()
        wd.stall_timeout_s = 10.0
        state = {"busy": True, "prog": 0}
        wd.register("src", lambda: (state["busy"], state["prog"]))
        try:
            assert wd.poll(now=0.0) == []
            assert wd.poll(now=5.0) == []
            before = wire_counters.get("watchdog_stalls")
            assert wd.poll(now=11.0) == ["src"]
            assert wire_counters.get("watchdog_stalls") == before + 1
            assert wd.poll(now=20.0) == []  # once per episode
            state["prog"] = 1
            assert wd.poll(now=21.0) == []
            assert wd.poll(now=40.0) == ["src"]  # a new stall fires again
        finally:
            wd.unregister("src")
        assert wd.sources() == []

    def test_idle_and_advancing_sources_never_fire(self):
        wd = flightrec.Watchdog()
        wd.stall_timeout_s = 1.0
        state = {"busy": False, "prog": 0}
        wd.register("src", lambda: (state["busy"], state["prog"]))
        try:
            assert wd.poll(now=0.0) == [] and wd.poll(now=100.0) == []
            state["busy"] = True
            for i, now in enumerate((101.0, 105.0, 109.0)):
                state["prog"] = i + 1
                assert wd.poll(now=now) == []
        finally:
            wd.unregister("src")

    def test_dying_probe_is_skipped_not_fatal(self):
        wd = flightrec.Watchdog()

        def bad():
            raise ValueError("probe died")

        wd.register("bad", bad)
        try:
            assert wd.poll(now=0.0) == []
        finally:
            wd.unregister("bad")


class TestInducedStall:
    """A wedged port apply thread produces a dump, and the JAX postmortem
    names the stalled source and its thread."""

    def test_stuck_apply_thread_dumped_and_named(self, tmp_path):
        from parameter_server_tpu_torch.kv.updaters import Sgd
        from parameter_server_tpu_torch.parallel.multislice import ServerHandle, ShardServer
        from parameter_server_tpu_torch.utils.config import PSConfig
        from parameter_server_tpu_torch.utils.keyrange import KeyRange

        flightrec.configure(str(tmp_path), process_name="server-0", flush_interval_s=0,
                            watchdog_interval_s=0.05, stall_timeout_s=0.25)
        srv = ShardServer(Sgd(eta=0.1), KeyRange(0, 256), device="cpu")
        release = threading.Event()
        real_apply = srv._apply_batch

        def wedged(batch):
            release.wait(timeout=30)  # the induced stall
            real_apply(batch)

        srv._apply_batch = wedged
        srv.start()
        handle = ServerHandle(srv.address, 0, 0, PSConfig(), range_size=256, device="cpu")
        path = tmp_path / f"blackbox-server-0-{os.getpid()}.json"
        try:
            assert any(s.startswith("apply:") for s in flightrec.watchdog.sources())
            keys = np.arange(1, 9, dtype=np.int64)
            fut = handle.push_async(keys, np.ones(len(keys), np.float32))
            _wait_for(lambda: path.exists() and any(
                r.startswith("stall:apply:")
                for r in json.loads(path.read_text())["trigger_reasons"]),
                "apply stall dump", timeout=15)
            release.set()
            fut.result(timeout=30)  # released: the push still lands
            handle.shutdown()
        finally:
            release.set()
            handle.close()
            srv.join(timeout=10)
        out = pm.postmortem(str(tmp_path))
        stalls = [a for a in out["anomalies"] if a["kind"] == "stall"]
        assert any(a["source"].startswith("apply:0-256") and a["thread"] == "ps-apply"
                   for a in stalls), out["anomalies"]
        assert "ps-apply" in out["report"]
        doc = json.loads(path.read_text())
        apply_t = [t for t in doc["threads"] if t["name"] == "ps-apply"]
        assert any("wedged" in "".join(t["stack"]) for t in apply_t)
        assert not any(s.startswith("apply:0-256") for s in flightrec.watchdog.sources())


def _child_server(box: Path, **env_extra) -> tuple[subprocess.Popen, str]:
    env = dict(os.environ)
    env["PYTHONPATH"] = str(REPO) + os.pathsep + env.get("PYTHONPATH", "")
    env[flightrec.BLACKBOX_DIR_ENV] = str(box)
    env.update(env_extra)
    child = subprocess.Popen([sys.executable, str(REPO / "tests" / "_torch_blackbox_child.py")],
                             stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
                             env=env)
    line = child.stdout.readline()
    assert line.startswith("ADDR "), (line, child.stderr.read()[-800:]
                                      if child.poll() is not None else "")
    return child, line.split()[1]


def _close_child(child: subprocess.Popen) -> None:
    if child.poll() is None:
        child.kill()
        child.wait()
    child.stdout.close()
    child.stderr.close()


class TestCrashPostmortem:
    """SIGKILL a port server process mid-window under frame chaos: its box
    and its client's merge, in the JAX postmortem, into one timeline that
    stitches the same (cid, seq) across both and flags the lost heal."""

    def test_killed_server_boxes_stitch_and_flag(self, tmp_path):
        from parameter_server_tpu_torch.parallel.multislice import ServerHandle
        from parameter_server_tpu_torch.utils.config import PSConfig

        box = tmp_path / "bb"
        box.mkdir()
        child, addr = _child_server(
            box, PS_FAULT_PLAN="delay,prob=0.2,delay_s=0.002;duplicate,every=7",
            PS_FAULT_SEED="99")
        handle = None
        try:
            flightrec.configure(str(box), process_name="worker-0", flush_interval_s=0,
                                watchdog_interval_s=60)
            handle = ServerHandle(addr, 0, 0, PSConfig(), range_size=4096,
                                  reconnect_timeout_s=2.0, device="cpu")
            keys = np.arange(1, 65, dtype=np.int64)
            g = np.full(len(keys), 0.5, dtype=np.float32)
            for f in [handle.push_async(keys, g) for _ in range(8)]:
                f.result(timeout=30)
            handle.pull(keys)
            time.sleep(0.3)  # the child's flusher persists the window
            child.send_signal(signal.SIGKILL)
            child.wait(timeout=30)
            with pytest.raises((ConnectionError, OSError)):
                handle.push(keys, g)
            flightrec.dump("test-exit")
        finally:
            if handle is not None:
                handle.close()
            _close_child(child)
        out = pm.postmortem(str(box))
        assert out["processes"] == 2 and out["cross_process_calls"] >= 1, out
        assert out["unknown_events"] == {}, out["unknown_events"]
        timeline = pm.merge_timeline(pm.load_dumps(str(box)))
        calls = pm.stitch_calls(timeline)
        cid = handle.client._cid
        stitched = [(k, {e["proc"] for e in evs}) for k, evs in calls.items()
                    if k[0] == cid and len({e["proc"] for e in evs}) >= 2]
        assert stitched, sorted(calls)
        assert set.union(*(s for _, s in stitched)) == {"worker-0", "server-0"}
        k, _ = stitched[0]
        assert {"rpc.issue", "rpc.in"} <= {e["etype"] for e in calls[k]}
        assert any(e["etype"] == "apply.commit"
                   and [k[0], k[1]] in [list(map(str, p)) for p in e["args"].get("pairs", [])]
                   for e in timeline), "no apply.commit ledger for a stitched push"
        kinds = {a["kind"]: a for a in out["anomalies"]}
        assert kinds["reconnect-without-heal"]["proc"] == "worker-0", out["anomalies"]
        assert "reconnect-without-heal" in out["report"]

    def test_sigterm_leaves_a_dump_with_the_frame_and_apply_events(self, tmp_path):
        """A port server sent SIGTERM dumps its box (``signal:15``) with the
        frames it received and its apply batches, then dies of the signal."""
        from parameter_server_tpu_torch.parallel.multislice import ServerHandle
        from parameter_server_tpu_torch.utils.config import PSConfig

        box = tmp_path / "bb"
        box.mkdir()
        child, addr = _child_server(box)
        handle = ServerHandle(addr, 0, 0, PSConfig(), range_size=4096, device="cpu")
        try:
            keys = np.arange(1, 33, dtype=np.int64)
            handle.push(keys, np.ones(32, np.float32))
            child.send_signal(signal.SIGTERM)
            assert child.wait(timeout=30) == -signal.SIGTERM
        finally:
            handle.close()
            _close_child(child)
        (dump,) = [p for p in box.glob("blackbox-server-0-*.json")]
        doc = json.loads(dump.read_text())
        assert doc["schema"] == "psbb/1" and f"signal:{int(signal.SIGTERM)}" in doc[
            "trigger_reasons"]
        etypes = [e[2] for e in doc["events"]]
        assert {"rpc.in", "apply.begin", "apply.commit", "rcu.publish", "signal"} <= set(etypes)
        assert etypes.index("apply.begin") < etypes.index("apply.commit")
        out = pm.postmortem(str(box))
        assert out["processes"] == 1 and out["unknown_events"] == {}


class TestPostmortemRendering:
    def test_trace_export_of_port_dumps_is_perfetto_loadable(self, tmp_path):
        """The JAX postmortem's Perfetto export of a port box: process and
        thread names recovered from the dump, instants in ts order."""
        flightrec.configure(str(tmp_path), process_name="server-0", flush_interval_s=0,
                            watchdog_interval_s=60)
        flightrec.record("rpc.in", cmd="push", cid="c", seq=1)
        flightrec.record("rpc.out", rseq=1, ok=True, n=10)
        flightrec.dump("exit")
        dumps = pm.load_dumps(str(tmp_path))
        path = pm.export_trace(dumps, pm.merge_timeline(dumps), str(tmp_path / "bb.json"))
        evs = json.loads(Path(path).read_text())["traceEvents"]
        metas = [e for e in evs if e["ph"] == "M"]
        assert "server-0" in {m["args"]["name"] for m in metas if m["name"] == "process_name"}
        assert any(m["name"] == "thread_name" and m["args"]["name"] == "MainThread"
                   for m in metas)
        insts = [e for e in evs if e["ph"] == "i"]
        assert len(insts) == 2 and [e["ts"] for e in insts] == sorted(e["ts"] for e in insts)

    def test_jax_cli_postmortem_reads_a_port_dump(self, tmp_path, capsys):
        from parameter_server_tpu.cli import main as jax_cli_main

        flightrec.configure(str(tmp_path), process_name="t-0", flush_interval_s=0,
                            watchdog_interval_s=60)
        flightrec.record("rpc.in", cmd="push", cid="c", seq=1)
        flightrec.dump("exit")
        flightrec.configure(None)
        assert jax_cli_main(["postmortem", str(tmp_path)]) == 0  # no anomalies
        got = capsys.readouterr().out
        assert "postmortem over 1 process box(es)" in got
        summary = json.loads(got.strip().splitlines()[-1])
        assert summary["processes"] == 1 and summary["anomalies"] == []


def test_audit_spool_buffer_matches_jax():
    """The spool's buffer: the same admission (audit etypes, pushes only
    among rpc.* traffic), batches, seq numbers, re-shipping until acked
    and saturation counting as the JAX EventSpool on one sequence."""
    evs = [(1.0 + i, 7, et, {"cmd": cmd, "seq": i})
           for i, (et, cmd) in enumerate(
               [("rpc.issue", "push"), ("rpc.issue", "pull"), ("apply.commit", None),
                ("rpc.in", "push"), ("ssp.wait", None), ("rpc.reply", "push")] * 6)]
    got = []
    for mod in (flightrec, jflightrec):
        sp = mod.EventSpool(capacity=16, batch_events=5)
        for ev in evs:
            sp.offer(ev[2], ev)
        first = sp.drain(max_batches=2)
        again = sp.drain(max_batches=3)  # unacked: re-shipped, then new
        sp.ack()
        rest = sp.drain(max_batches=10)
        got.append(([b["seq"] for b in first], [b["seq"] for b in again],
                    [b["events"] for b in first + again + rest], len(sp)))
    assert got[0] == got[1]
    assert flightrec.AUDIT_EVENTS == jflightrec.AUDIT_EVENTS
    # arming the spool alone makes record live; disarming both pins the no-op
    flightrec.configure_spool(64)
    assert flightrec.record is flightrec._live_record
    flightrec.configure_spool(None)
    assert flightrec.record is flightrec._noop_record


class TestPeakGaugeRoll:
    def test_telemetry_snapshot_rolls_and_dumps_only_observe(self, tmp_path):
        """Peaks decay per telemetry snapshot, while a dump observes without
        consuming the window (roll_peaks=False), as in JAX."""
        name = "torch_blackbox_test_peak"
        wire_counters.observe_max(name, 555)
        flightrec.configure(str(tmp_path), process_name="t-0", flush_interval_s=0,
                            watchdog_interval_s=60)
        doc = json.loads(Path(flightrec.dump("x")).read_text())
        assert doc["telemetry"]["counters"][name] == 555
        assert telemetry_snapshot()["counters"][name] == 555
        assert telemetry_snapshot()["counters"][name] == 0
        m = merge_telemetry([{"counters": {name: 9, "x": 1}}, {"counters": {name: 40, "x": 2}}])
        assert m["counters"][name] == 40 and m["counters"]["x"] == 3


def test_port_cluster_dump_dir_reads_in_the_jax_postmortem(tmp_path):
    """``launch_local(blackbox_dir=...)``: every node of a port cluster
    (scheduler, server, worker) leaves a box, and the JAX postmortem merges
    them: pushes stitched across the worker's and the server's boxes, every
    event type known to it, no anomaly on a healthy run."""
    from parameter_server_tpu.data.synthetic import make_sparse_logistic, write_libsvm
    from parameter_server_tpu_torch.parallel import multislice as TM

    labels, keys, vals, _ = make_sparse_logistic(400, 300, nnz_per_example=5, seed=29)
    files = []
    for i in range(2):
        files.append(str(tmp_path / f"part-{i}.svm"))
        write_libsvm(files[-1], labels[i::2], keys[i::2], vals[i::2])
    app = tmp_path / "app.json"
    app.write_text(json.dumps({
        "app": "linear_method", "data": {"files": files, "num_keys": 1024},
        "solver": {"minibatch": 100, "epochs": 1, "max_delay": 1},
        "fault": {"heartbeat_interval_s": 0.2}}))
    box = tmp_path / "bb"
    out = TM.launch_local(str(app), 1, 1, device="cpu", blackbox_dir=str(box), timeout=120,
                          log_dir=str(tmp_path / "logs"))
    assert out["workloads"]["done"] == 2
    names = sorted(p.name.rsplit("-", 1)[0] for p in box.glob("blackbox-*-*.json"))
    assert names == ["blackbox-scheduler-0", "blackbox-server-0", "blackbox-worker-0"]
    res = pm.postmortem(str(box))
    assert res["processes"] == 3 and res["cross_process_calls"] >= 1
    assert res["anomalies"] == [] and res["unknown_events"] == {}
    etypes = {e["etype"] for e in pm.merge_timeline(pm.load_dumps(str(box)))}
    assert {"rpc.issue", "rpc.in", "rpc.out", "rpc.reply", "apply.begin", "apply.commit",
            "rcu.publish", "heartbeat.beat", "ssp.finish"} <= etypes
