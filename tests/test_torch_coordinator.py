"""The port's control plane held to the JAX package's: the coordinator's
commands over the wire (``tests/test_multislice.py::TestCoordinator``'s
five cases and one case that drives every other command), each run with a
port client against a port coordinator, a JAX client against a port
coordinator and a port client against a JAX coordinator; the copies the
coordinator stands on (``WorkloadPool``'s reassignment, ``PushWindow``,
``merge_progress`` / ``merge_telemetry``, ``HeartbeatMonitor``) against
the originals on the same sequences; and the repaired ``RpcServer``
flush: a pipelined reply is not held behind a parked blocking command.
Every coordinator is stopped and every client closed in a ``finally``;
every wait has its own bound (the calls' timeouts, the threads' joins)."""

from __future__ import annotations

import socket
import threading
import time
from concurrent.futures import Future

import numpy as np
import pytest

from parameter_server_tpu.parallel import control as JC
from parameter_server_tpu.parallel import ssp as JS
from parameter_server_tpu.parallel import workload as JW
from parameter_server_tpu.utils import heartbeat as JH
from parameter_server_tpu.utils import metrics as JMET
from parameter_server_tpu_torch.parallel import control as TC
from parameter_server_tpu_torch.parallel import ssp as TS
from parameter_server_tpu_torch.parallel import workload as TW
from parameter_server_tpu_torch.utils import heartbeat as TH
from parameter_server_tpu_torch.utils import metrics as TMET

#: (client package, coordinator package)
PAIRS = [("torch", "torch"), ("jax", "torch"), ("torch", "jax")]


@pytest.fixture(params=PAIRS, ids=["-".join(p) for p in PAIRS])
def pair(request):
    """(the coordinator, a factory of connected clients); every client the
    factory made is closed and the coordinator stopped afterwards."""
    client_pkg, coord_pkg = request.param
    coord = (TC if coord_pkg == "torch" else JC).Coordinator()
    client_cls = (TC if client_pkg == "torch" else JC).ControlClient
    made = []

    def client():
        made.append(client_cls(coord.address))
        return made[-1]

    try:
        yield coord, client, request.param
    finally:
        for c in made:
            c.close()
        coord.stop()


def test_register_and_kv(pair):
    coord, client, _ = pair
    c1, c2 = client(), client()
    assert {c1.register("worker"), c2.register("server")} == {0, 1}
    c1.kv_set("addr/0", arrays={"x": np.arange(4)}, port=99)
    fields, arrays = c2.kv_get("addr/0", block=True, timeout=5)
    assert fields["port"] == 99
    np.testing.assert_array_equal(arrays["x"], np.arange(4))
    assert c2.kv_get("missing") is None


def test_barrier_blocks_until_count(pair):
    coord, client, _ = pair
    results = []
    clients = [client() for _ in range(3)]

    def arrive(c):
        c.barrier("b1", count=3, timeout=30)
        results.append(1)

    threads = [threading.Thread(target=arrive, args=(c,)) for c in clients]
    threads[0].start()
    threads[1].start()
    time.sleep(0.2)
    assert len(results) == 0  # two arrivals: still parked
    threads[2].start()
    for t in threads:
        t.join(timeout=30)
    assert len(results) == 3


def test_workload_pool_over_wire(pair):
    coord, client, _ = pair
    c = client()
    c.workload_init(["a", "b"])
    assert c.workload_fetch(0) == "a"
    assert c.workload_fetch(1) == "b"
    assert c.workload_fetch(0) is None
    assert not c.workload_all_done()
    c.workload_finish("a")
    c.workload_finish("b")
    assert c.workload_all_done()


def test_ssp_gate_and_retire(pair):
    coord, client, _ = pair
    c = client()
    c.ssp_init(num_workers=2, max_delay=0)
    # worker 0 may start step 0 (gate: min_finished >= -1)
    assert c.ssp_wait(0, 0, timeout=1)
    # but not step 1 until worker 1 finishes step 0
    assert not c.ssp_wait(0, 1, timeout=0.2)
    c.ssp_finish(0, 0)
    c.ssp_finish(1, 0)
    assert c.ssp_wait(0, 1, timeout=5)
    # a retired worker stops gating
    c.ssp_retire(1)
    c.ssp_finish(0, 1)
    assert c.ssp_wait(0, 5, timeout=0.5) is False  # own counter still gates
    c.ssp_finish(0, 4)
    assert c.ssp_wait(0, 5, timeout=5)


def test_progress_merge_and_heartbeats(pair):
    coord, client, _ = pair
    c = client()
    c.progress(0, {"examples": 100, "objv": 0.5, "ex_per_sec": 10.0})
    c.progress(1, {"examples": 300, "objv": 0.3, "ex_per_sec": 30.0})
    m = c.progress_merged()
    assert m["examples"] == 400
    assert m["objv"] == pytest.approx(0.35)  # example-weighted
    assert m["ex_per_sec"] == pytest.approx(40.0)
    c.beat(0, {"max_rss_mb": 1.0})
    rep, _ = c.call("dead")
    assert rep["alive"] == [0]


def test_every_other_command(pair):
    """nodes, workload_stats / reassign (a dead worker's and stragglers'),
    recovered and the recovery sweep, ssp_progress, telemetry, the
    timeouts of barrier and blocking kv_get, audit and shutdown."""
    coord, client, (client_pkg, coord_pkg) = pair
    c, w = client(), client()
    sid = c.register("server", rank=0)
    wid = w.register("worker", rank=1)
    assert {k: v["role"] for k, v in c.nodes().items()} == {
        str(sid): "server", str(wid): "worker"}
    assert c.nodes()[str(wid)]["rank"] == 1
    c.workload_init([f"0:f{i}" for i in range(4)])
    assert [c.workload_fetch(r) for r in (0, 1, 1)] == ["0:f0", "0:f1", "0:f2"]
    assert c.workload_stats() == {
        "pending": 1, "active": 3, "done": 0, "attempts": 3, "reassigned": 0}
    assert c.workload_reassign(worker=1) == ["0:f1", "0:f2"]
    assert c.workload_fetch(0) == "0:f1"  # requeued work goes first
    time.sleep(0.05)
    assert c.workload_reassign(older_than=0.01) == ["0:f0", "0:f1"]
    assert c.workload_stats() == {
        "pending": 4, "active": 0, "done": 0, "attempts": 4, "reassigned": 4}
    c.ssp_init(num_workers=2, max_delay=1)
    c.ssp_finish(0, 2)
    rep, _ = c.call("ssp_progress")
    assert (rep["min_finished"], rep["max_finished"], rep["retired"]) == (-1, 2, [])
    # a worker that beat once and went silent: the sweep requeues its
    # workload and retires its clock
    coord._monitor.timeout_s = 0.3
    assert c.workload_fetch(1) == "0:f0"
    w.beat(wid, {"pid": 1})
    c.beat(sid, {"pid": 2, "telemetry": {"counters": {"x": 2, "q_peak": 5}}})
    assert c.dead_nodes() == ([], sorted([sid, wid]))
    time.sleep(0.4)
    assert c.dead_nodes()[0] == sorted([sid, wid])
    coord.start_recovery(0.05)
    deadline = time.monotonic() + 10
    while 1 not in c.recovered_workers() and time.monotonic() < deadline:
        time.sleep(0.05)
    got = c.recovered_workers()
    assert got == {1: {"node_id": wid, "requeued": ["0:f0"]}}
    rep, _ = c.call("ssp_progress")
    assert rep["retired"] == [1]
    tel = c.telemetry()
    assert tel["nodes"][str(sid)]["role"] == "server"
    assert tel["nodes"][str(sid)]["telemetry"]["counters"]["x"] == 2
    merged = tel["merged"]["counters"]
    assert merged["x"] == 2 + tel["coordinator"]["counters"].get("x", 0)
    assert merged["q_peak"] == max(5, tel["coordinator"]["counters"].get("q_peak", 0))
    assert {"nodes", "coordinator", "merged"} <= set(tel)
    if coord_pkg == "torch":
        assert not {"series", "slo", "audit"} & set(tel)
        with pytest.raises(RuntimeError, match="not ported yet"):
            c.audit()
    else:
        assert isinstance(c.audit(), dict)
    # a timed-out barrier or blocking kv_get is an error reply, which the
    # client raises
    with pytest.raises(RuntimeError, match="barrier timeout"):
        c.barrier("lonely", count=2, timeout=0.1)
    with pytest.raises(RuntimeError, match="kv_get timeout"):
        c.kv_get("never", block=True, timeout=0.1)
    c.shutdown_server()
    assert coord.server._stop.wait(5)


def test_workload_pool_reassignment_matches_jax():
    """Fetches, a dead worker's requeue, stragglers by age, a finish of a
    requeued workload, owners and attempts: the same sequence through
    both pools, side by side."""
    names = [f"s{i}" for i in range(6)]
    pools = {"torch": TW.WorkloadPool(names), "jax": JW.WorkloadPool(names)}
    logs = {k: [] for k in pools}

    def each(fn):
        for k, pool in pools.items():
            logs[k].append(fn(pool))

    for w in (0, 1, 1, 2):
        each(lambda p, w=w: p.fetch(w))
    time.sleep(0.3)
    each(lambda p: p.fetch(0))
    each(lambda p: (p.owner_of("s1"), p.owner_of("s9")))
    each(lambda p: (p.reassign_worker(1), p.stats(), p.reassigned_total))
    each(lambda p: (p.fetch(3), p.owner_of("s1"), p.attempts("s1")))
    each(lambda p: (p.reassign_stragglers(0.2), p.stats()))
    each(lambda p: p.finish("s0"))  # requeued, then finished by its slow owner
    each(lambda p: (p.stats(), p.attempts("s0"), p.all_done))

    def drain(p):
        got = []
        while (x := p.fetch(4)) is not None:
            got.append(x)
            p.finish(x)
        return got, p.all_done  # s4 and s1 are still active

    each(drain)
    each(lambda p: (p.finish("s4"), p.finish("s1")))
    each(lambda p: (p.stats(), p.all_done, p.reassigned_total))
    assert logs["torch"] == logs["jax"]
    st = logs["torch"][-1][0]
    # s0 was requeued, then finished while queued: never handed out again
    assert st == {"pending": 0, "active": 0, "done": 6, "attempts": 9, "reassigned": 4}


class _Fut:
    """A fake push future that completes when told to."""

    def __init__(self, log, name):
        self._done = False
        self._log, self._name = log, name

    def done(self):
        return self._done

    def result(self):
        self._log.append(f"result {self._name}")
        self._done = True


@pytest.mark.parametrize("max_inflight", [0, 1, 3])
def test_push_window_matches_jax(max_inflight):
    """Retire order and count, blocking over the bound, done heads
    retired early, and the peak depth, through both windows."""
    logs = {}
    for pkg, mod in (("torch", TS), ("jax", JS)):
        log: list = []
        win = mod.PushWindow(max_inflight, retire=lambda s: log.append(f"retire {s}"))
        futs = {}
        for step in range(6):
            win.gate()
            log.append(f"gate {step} depth {len(win)}")
            futs[step] = [_Fut(log, f"{step}.{i}") for i in range(2)]
            if step == 2:  # step 1's pushes land early: gate retires it
                for f in futs.get(1, []):
                    f._done = True
            win.add(step, futs[step])
        win.wait_all()
        log += [len(win), win.max_inflight_seen]
        logs[pkg] = log
    assert logs["torch"] == logs["jax"]
    assert sum(e.startswith("retire") for e in logs["torch"][:-2]) == 6


def test_merge_progress_and_telemetry_match_jax():
    rng = np.random.default_rng(3)
    keys = ["examples", "objv", "auc", "logloss", "ex_per_sec", "wire_bytes_out",
            "rpc_retries", "rpc_dedup_hits", "examples_total"]
    for trial in range(20):
        reports = []
        for _ in range(int(rng.integers(0, 5))):
            r = {k: float(rng.random()) for k in keys if rng.random() < 0.7}
            if "examples" in r:
                r["examples"] = int(rng.integers(0, 1000) * (trial % 3 != 0))
            reports.append(r)
        assert TMET.merge_progress(reports) == JMET.merge_progress(reports)
        snaps = [{"counters": {f"c{j}" + ("_peak" if j % 2 else ""): int(rng.integers(0, 99))
                               for j in range(4) if rng.random() < 0.6}} for _ in range(3)]
        got = TMET.merge_telemetry(snaps)
        assert got["counters"] == JMET.merge_telemetry(snaps)["counters"]
        assert got["hists"] == {} and got["timers"] == {}
    snap = TMET.telemetry_snapshot(roll_peaks=False)
    assert set(snap) == {"counters", "hists", "timers"}


def test_heartbeat_monitor_matches_jax():
    mons = {"torch": TH.HeartbeatMonitor(timeout_s=0.3),
            "jax": JH.HeartbeatMonitor(timeout_s=0.3)}
    logs = {k: [] for k in mons}

    def each(fn):
        for k, mon in mons.items():
            logs[k].append(fn(mon))

    each(lambda m: (m.beat(0, {"a": 1}), m.beat_many([(1, None), (2, {"b": 2})])))
    time.sleep(0.2)
    each(lambda m: m.beat(1, {"c": 3}))
    each(lambda m: (m.dead(), m.alive()))
    time.sleep(0.2)
    each(lambda m: (m.dead(), m.alive(), m.latest_stats()))
    each(lambda m: m.forget(0))
    each(lambda m: (m.dead(), m.alive()))
    each(lambda m: m.beat(0))
    each(lambda m: (m.dead(), m.alive(), sorted(m.latest_stats())))
    assert logs["torch"] == logs["jax"]
    assert logs["torch"][3][:2] == ([0, 2], [1])
    stats = TH.host_stats()
    assert set(stats) >= {"pid", "time", "max_rss_mb"}


def test_heartbeat_reporter_beats_and_stops():
    mon = TH.HeartbeatMonitor(timeout_s=5.0)
    rep = TH.HeartbeatReporter(mon, 7, interval_s=0.02).start()
    try:
        deadline = time.monotonic() + 5
        while rep.beats < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
    finally:
        rep.stop()
    assert rep.beats >= 3 and mon.alive() == [7]
    assert mon.latest_stats()[7]["pid"] > 0


@pytest.mark.parametrize("pkg", ["torch", "jax"])
def test_blocking_command_flushes_pipelined_replies(pkg):
    """Two requests in one write: ``nodes``, then an ``ssp_wait`` that
    parks for 3 s. The ``nodes`` reply must arrive before the wait ends:
    the server flushes the replies it holds before dispatching a blocking
    command."""
    mod = TC if pkg == "torch" else JC
    coord = mod.Coordinator()
    ctl = mod.ControlClient(coord.address)
    sock = None
    try:
        ctl.ssp_init(num_workers=2, max_delay=0)
        host, port = coord.address.rsplit(":", 1)
        sock = socket.create_connection((host, int(port)), timeout=10)
        frames = [TC.build_frame({"cmd": "nodes"}, None)[0],
                  TC.build_frame({"cmd": "ssp_wait", "worker": 0, "step": 1,
                                  "timeout": 3.0}, None)[0]]
        t0 = time.perf_counter()
        sock.sendall(b"".join(bytes(b) for fb in frames for b in fb))
        h1, _ = TC.recv_frame(sock)
        t1 = time.perf_counter() - t0
        h2, _ = TC.recv_frame(sock)
        t2 = time.perf_counter() - t0
        assert "nodes" in h1 and h1["ok"]
        assert h2["ok"] and h2["granted"] is False
        assert t1 < 1.5 < t2, (t1, t2)
    finally:
        if sock is not None:
            sock.close()
        ctl.close()
        coord.stop()


def test_fake_futures_are_futures_enough():
    """``PushWindow`` only calls ``done()`` and ``result()``: a real
    Future retires the same way as the fakes above."""
    log = []
    win = TS.PushWindow(0, retire=log.append)
    f = Future()
    f.set_result(None)
    win.add(0, [f])
    win.gate()
    assert log == [0] and len(win) == 0
