"""The port's cluster (``parallel/multislice.py`` node entry points, ``cli
launch`` / ``cli node``) on the CPU, as real processes over TCP, held to
the JAX package's: one worker and two servers at ``max_delay`` 0 build the
JAX cluster's model on the same files (weights rtol 1e-5 / atol 1e-6,
merged objective rtol 1e-5); the asserts of ``tests/test_multislice.py``'s
``TestLaunchLocal`` and ``TestServerRecovery`` at their sizes (3000 x 800
features in 4 files, minibatch 256); server checkpoints that either
package's server loads; the CLI's arguments and its refusals; and the
default device, ``cuda``, which raises here. Every launch has its own
``timeout``; in-process servers are shut down in a ``finally``."""

from __future__ import annotations

import json
import os
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import pytest
import torch

from parameter_server_tpu.data.synthetic import make_sparse_logistic, write_libsvm
from parameter_server_tpu.kv import updaters as JU
from parameter_server_tpu.parallel import multislice as JM
from parameter_server_tpu.utils import config as JCFG
from parameter_server_tpu.utils import keyrange as JK
from parameter_server_tpu_torch import cli
from parameter_server_tpu_torch.kv import updaters as TU
from parameter_server_tpu_torch.parallel import multislice as TM
from parameter_server_tpu_torch.utils import config as TCFG
from parameter_server_tpu_torch.utils import keyrange as TK
from parameter_server_tpu_torch.utils.checkpoint import load_weights_text

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent
NUM_KEYS = 1 << 15
LAUNCH_TIMEOUT = 240
#: the port's worker steps in ~5 ms on the CPU, so the fault tests run
#: enough epochs that a kill 1 s after the victim registers lands mid-run
FAULT_EPOCHS = 60


@pytest.fixture(autouse=True)
def _child_env(monkeypatch):
    """Spawned nodes find both packages and run one thread each."""
    monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
        p for p in (str(ROOT), os.environ.get("PYTHONPATH", "")) if p))
    monkeypatch.setenv("OMP_NUM_THREADS", "1")


def _app(tmp_path: Path, seed: int, solver: dict, **sections) -> Path:
    """JAX ``TestLaunchLocal``'s data and config: 4 libsvm files of 700
    rows and a validation file of 200, FTRL."""
    labels, keys, vals, _ = make_sparse_logistic(
        3000, 800, nnz_per_example=10, noise=0.3, seed=seed)
    files = []
    for i in range(4):
        sl = slice(i * 700, (i + 1) * 700)
        f = tmp_path / f"part-{i}.libsvm"
        write_libsvm(f, labels[sl], keys[sl], vals[sl])
        files.append(str(f))
    val = tmp_path / "val.libsvm"
    write_libsvm(val, labels[2800:], keys[2800:], vals[2800:])
    cfg = {
        "app": "linear_method",
        "data": {"files": files, "format": "libsvm", "num_keys": NUM_KEYS,
                 "val_files": [str(val)], "max_nnz_per_example": 64},
        "solver": {"algo": "ftrl", "minibatch": 256, **solver},
        "lr": {"alpha": 0.3, "beta": 1.0},
        "penalty": {"lambda_l1": 0.005},
        **sections,
    }
    app_file = tmp_path / "app.json"
    app_file.write_text(json.dumps(cfg))
    return app_file


def test_one_worker_cluster_matches_jax(tmp_path):
    """2 servers, 1 worker, max_delay 0: every push applied before the
    next pull, so both clusters run the same sequence of steps."""
    app = _app(tmp_path, 11, {"max_delay": 0, "epochs": 1},
               filter={"key_caching": True, "compressing": True})
    mt, mj = tmp_path / "port.txt", tmp_path / "jax.txt"
    with ThreadPoolExecutor(2) as ex:
        fj = ex.submit(JM.launch_local, str(app), num_servers=2, num_workers=1,
                       model_out=str(mj), timeout=LAUNCH_TIMEOUT, devices="cpu")
        ft = ex.submit(TM.launch_local, str(app), num_servers=2, num_workers=1,
                       model_out=str(mt), timeout=LAUNCH_TIMEOUT, device="cpu")
        rj, rt = fj.result(), ft.result()
    wt, wj = load_weights_text(mt, NUM_KEYS), load_weights_text(mj, NUM_KEYS)
    assert np.count_nonzero(wj) > 0
    np.testing.assert_allclose(wt, wj, rtol=1e-5, atol=1e-6)
    assert rt["merged"]["objv"] == pytest.approx(rj["merged"]["objv"], rel=1e-5)
    assert rt["merged"]["examples"] == rj["merged"]["examples"] == 2800
    assert rt["val_auc"] == pytest.approx(rj["val_auc"], abs=1e-4)
    assert rt["workloads"] == rj["workloads"] == {
        "pending": 0, "active": 0, "done": 4, "attempts": 4, "reassigned": 0}
    assert rt["nnz_w"] == rj["nnz_w"]
    for key in ("pushes", "pulls"):
        assert [s[key] for s in rt["server_stats"]] == [s[key] for s in rj["server_stats"]]
    # each node printed its report; on the CPU no kernel launches
    nodes = rt["nodes"]
    assert set(nodes) == {"scheduler-0", "server-0", "server-1", "worker-0"}
    for tag in ("server-0", "server-1", "worker-0"):
        assert nodes[tag]["node"] == tag and nodes[tag]["device"] == "cpu"
        assert set(nodes[tag]["launches"].values()) == {0}
        assert nodes[tag]["t_register"] > nodes[tag]["spawn_time"]
    assert nodes["worker-0"]["max_inflight_seen"] == 1  # max_delay 0: one step in flight
    for s, st in zip(("server-0", "server-1"), rt["server_stats"]):
        assert nodes[s]["counters"]["apply_batches"] == st["apply_batches"]


def test_cli_launch_end_to_end(tmp_path):
    """``cli launch --device cpu``: JAX ``TestLaunchLocal.test_end_to_end``'s
    run (2 servers, 2 workers, max_delay 1, 3 epochs) and its asserts."""
    app = _app(tmp_path, 11, {"max_delay": 1, "epochs": 3},
               filter={"key_caching": True, "compressing": True})
    model_out = tmp_path / "model.txt"
    proc = subprocess.run(
        [sys.executable, "-m", "parameter_server_tpu_torch.cli", "launch",
         "--app_file", str(app), "--num_servers", "2", "--num_workers", "2",
         "--model_out", str(model_out), "--device", "cpu"],
        cwd=tmp_path, capture_output=True, text=True, timeout=LAUNCH_TIMEOUT,
    )
    assert proc.returncode == 0, proc.stderr[-3000:]
    out = json.loads(proc.stdout.strip().splitlines()[-1])
    assert out["val_auc"] > 0.85, out
    assert out["nnz_w"] > 0
    assert model_out.exists()
    assert out["merged"]["examples"] > 0
    for st in out["server_stats"]:  # both servers did real work
        assert st["pushes"] > 0 and st["pulls"] > 0
    assert out["workloads"] == {
        "pending": 0, "active": 0, "done": 12, "attempts": 12, "reassigned": 0}
    assert out["dead_workers"] == []
    # the merged telemetry of the JAX run result: counters, the latency
    # histograms (here at least the scheduler's own: every node's
    # registration it served, the servers' stats it read), named timers,
    # and the optional heat / slow-op / profiler blocks
    tel = out["telemetry"]
    assert {"counters", "hists", "timers"} <= set(tel) <= {
        "counters", "hists", "timers", "key_heat", "slow", "prof"}
    assert tel["counters"]["wire_bytes_out"] > 0
    assert tel["hists"]["server.register"]["count"] >= 4
    assert tel["hists"]["client.stats"]["count"] >= 2
    assert sum(out["nodes"][f"worker-{r}"]["steps"] for r in (0, 1)) == 36


def test_worker_killed_mid_run_recovers(tmp_path):
    """JAX ``test_worker_killed_mid_run_recovers``: SIGKILL a worker
    mid-run; the dead-node sweep requeues its shards and retires its SSP
    clock, and the survivor finishes every workload."""
    app = _app(tmp_path, 13, {"max_delay": 1, "epochs": FAULT_EPOCHS},
               fault={"heartbeat_interval_s": 0.5, "heartbeat_timeout_s": 2.5})
    out = TM.launch_local(str(app), num_servers=2, num_workers=2, timeout=LAUNCH_TIMEOUT,
                          device="cpu", fault_kill="worker:1@1.0")
    assert out["dead_workers"] == [1], out
    wl = out["workloads"]
    assert (wl["pending"], wl["active"], wl["done"]) == (0, 0, 4 * FAULT_EPOCHS), out
    assert wl["attempts"] == wl["done"] + wl["reassigned"], out
    assert wl["reassigned"] >= 1, out  # the kill landed mid-run
    assert out["val_auc"] > 0.85, out
    assert out["nodes"]["worker-1"]["rc"] != 0  # the victim


def test_server_killed_and_restarted_completes(tmp_path):
    """JAX ``TestServerRecovery``: SIGKILL a shard server mid-run; its
    replacement resumes from the periodic range dump, re-registers under
    the same rank, the workers reconnect, and training completes."""
    app = _app(tmp_path, 17, {"max_delay": 1, "epochs": FAULT_EPOCHS}, fault={
        "heartbeat_interval_s": 0.5, "heartbeat_timeout_s": 2.5,
        "server_ckpt_interval_s": 0.5, "server_restart_grace_s": 60.0,
        "reconnect_timeout_s": 60.0})
    ckpt = tmp_path / "sckpt"
    out = TM.launch_local(str(app), num_servers=2, num_workers=2, timeout=LAUNCH_TIMEOUT,
                          device="cpu", fault_kill="server:1@1.0",
                          fault_restart_after=0.5, ckpt_dir=str(ckpt))
    assert out["dead_workers"] == [], out
    assert out["workloads"] == {
        "pending": 0, "active": 0, "done": 4 * FAULT_EPOCHS,
        "attempts": 4 * FAULT_EPOCHS, "reassigned": 0}, out
    assert out["val_auc"] > 0.83, out
    assert out["nnz_w"] > 0
    assert out["nodes"]["server-1-r1"]["resumed"] is True  # from the dump
    assert sorted(p.name for p in ckpt.glob("*.npz")) == [
        f"server-0-{NUM_KEYS // 2}.npz", f"server-{NUM_KEYS // 2}-{NUM_KEYS}.npz"]


RANGE = 512


@pytest.mark.parametrize("algo,vdim", [("ftrl", 1), ("adagrad", 4)])
def test_checkpoints_load_across_packages(tmp_path, algo, vdim):
    """A port server's ``save_state`` and ``load_state`` round trip (tables
    and ledger), and the JAX server's dump of the same pushes loads into a
    port server (and the port's into a JAX server), each answering the
    same pulls. A layout mismatch is refused."""
    hyper = ({"alpha": 0.5, "beta": 1.0, "lambda_l1": 1e-3, "lambda_l2": 0.01}
             if algo == "ftrl" else {"eta": 0.1})
    mk = {"ftrl": "Ftrl", "adagrad": "Adagrad"}[algo]
    rng = np.random.default_rng(5)
    pushes = []
    for i in range(6):
        k = np.unique(rng.integers(0, RANGE, 64)).astype(np.int64)
        pushes.append((k, rng.normal(size=(len(k), vdim)).astype(np.float32)))
    probe = np.arange(RANGE, dtype=np.int64)

    def port_server():
        return TM.ShardServer(getattr(TU, mk)(**hyper), TK.KeyRange(RANGE, 2 * RANGE),
                              vdim=vdim, device="cpu")

    def jax_server():
        return JM.ShardServer(getattr(JU, mk)(**hyper), JK.KeyRange(RANGE, 2 * RANGE),
                              vdim=vdim)

    def handle(srv, pkg):
        if pkg == "jax":
            return JM.ServerHandle(srv.address, 0, 0, JCFG.PSConfig(), range_size=RANGE)
        return TM.ServerHandle(srv.address, 0, 0, TCFG.PSConfig(), range_size=RANGE,
                               device="cpu")

    def drive(srv, pkg, ckpt=None, push=True):
        """Start, optionally push, pull everything, optionally save, stop."""
        srv.start()
        h = handle(srv, pkg)
        try:
            if push:
                for k, g in pushes:
                    h.push(k, g)
            pulled = np.asarray(h.pull(probe)).reshape(RANGE, vdim)
            if ckpt is not None:
                srv.save_state(str(ckpt))
            ledger = {c: list(p) for c, p in srv._applied_push.items()}
            h.shutdown()
        finally:
            h.close()
            srv.server.stop()
        return pulled, ledger

    d_port, d_jax = tmp_path / "port", tmp_path / "jax"
    want, ledger = drive(port_server(), "torch", ckpt=d_port)
    assert len(next(iter(ledger.values()))) == len(pushes)
    jax_pulled, _ = drive(jax_server(), "jax", ckpt=d_jax)
    np.testing.assert_allclose(want, jax_pulled, rtol=1e-5, atol=1e-6)
    assert sorted(p.name for p in d_port.iterdir()) == sorted(p.name for p in d_jax.iterdir())
    # the port's dump, into a port server and into a JAX server
    srv = port_server()
    assert srv.load_state(str(d_port))
    got, got_ledger = drive(srv, "torch", push=False)
    np.testing.assert_array_equal(got, want)
    assert got_ledger == ledger
    srv = jax_server()
    assert srv.load_state(str(d_port))
    got, got_ledger = drive(srv, "jax", push=False)
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-7)
    assert got_ledger == ledger
    # the JAX server's dump into a port server
    srv = port_server()
    assert srv.load_state(str(d_jax))
    got, _ = drive(srv, "torch", push=False)
    np.testing.assert_allclose(got, jax_pulled, rtol=1e-6, atol=1e-7)
    # no dump: False; another layout: refused
    srv = port_server()
    other = TM.ShardServer(getattr(TU, mk)(**hyper), TK.KeyRange(RANGE, 2 * RANGE),
                           vdim=vdim + 1, device="cpu")
    try:
        assert not srv.load_state(str(tmp_path / "none"))
        with pytest.raises(ValueError, match="does not match"):
            other.load_state(str(d_port))
    finally:
        srv.server.stop()
        other.server.stop()


def test_resent_push_after_restore_applies_once(tmp_path):
    """The ledger travels with the dump: a push the dump holds, resent to
    the restored server under its identity, is acked, not applied."""
    srv = TM.ShardServer(TU.Sgd(eta=1.0), TK.KeyRange(0, 64), device="cpu")
    srv._handle({"cmd": "push", "worker": 0, "sig": "s", "_cid": "c1", "_seq": 7},
                {"keys": np.array([3, 5], np.uint32), "g": np.ones(2, np.float32)})
    srv.save_state(str(tmp_path))
    back = TM.ShardServer(TU.Sgd(eta=1.0), TK.KeyRange(0, 64), device="cpu")
    assert back.load_state(str(tmp_path))
    rep, _ = back._handle({"cmd": "push", "worker": 0, "sig": "s", "_cid": "c1", "_seq": 7},
                          {"keys": np.array([3, 5], np.uint32),
                           "g": np.ones(2, np.float32)})
    assert rep["ok"] and back.counters["push_replays"] == 1
    np.testing.assert_array_equal(back.weights()[[3, 5], 0], [-1.0, -1.0])
    back.server.stop()
    srv.server.stop()


def test_cli_node_and_launch_arguments(tmp_path, monkeypatch):
    """The flags of the JAX CLI's ``node`` and ``launch``, plus ``--device``;
    a chaos spec (``--fault_plan``, ``[fault] fault_plan``) is parsed
    before anything starts, so a bad one fails fast; the tracing and
    black-box options arm those planes (``launch`` hands them to every
    node's environment, ``node`` and ``run_node`` arm from the flag or
    the config), and so do the profiler and the metrics endpoint; other
    apps than ``linear_method`` are refused, as the JAX cluster runs
    only that one."""
    from parameter_server_tpu_torch.utils import flightrec, trace

    app = _app(tmp_path, 11, {"max_delay": 0, "epochs": 1})
    node = ["node", "--role", "server", "--rank", "0", "--scheduler", "127.0.0.1:1",
            "--num_servers", "1", "--num_workers", "1", "--app_file", str(app),
            "--device", "cpu"]
    args = cli._build_parser().parse_args(node + ["--ckpt_dir", "d", "--bind_host", "0.0.0.0",
                                                  "--advertise_host", "h"])
    assert (args.role, args.ckpt_dir, args.bind_host, args.advertise_host, args.device) == (
        "server", "d", "0.0.0.0", "h", "cpu")
    args = cli._build_parser().parse_args(["launch", "--app_file", str(app)])
    assert (args.num_servers, args.num_workers, args.device) == (1, 1, "cuda")
    with pytest.raises(SystemExit):  # --scheduler is required
        cli._build_parser().parse_args(["node", "--role", "server", "--num_servers", "1",
                                        "--num_workers", "1", "--app_file", str(app)])
    with pytest.raises(SystemExit):
        cli._build_parser().parse_args(node[:2] + ["boss"] + node[3:])
    launch = ["launch", "--app_file", str(app), "--device", "cpu"]
    seen = {}

    def fake_launch(*a, **kw):
        seen["launch"] = kw
        return {"ok": True}

    def fake_node(cfg, *a, **kw):
        seen["node"] = cfg
        return {"ok": True}

    with monkeypatch.context() as m:
        m.setattr(TM, "launch_local", fake_launch)
        m.setattr(TM, "run_node", fake_node)
        cli.main(launch + ["--trace_dir", "tx", "--blackbox_dir", "bx"])
        assert (seen["launch"]["trace_dir"], seen["launch"]["blackbox_dir"]) == ("tx", "bx")
        cli.main(node + ["--trace_dir", "tn"])
        assert seen["node"].trace.trace_dir == "tn"
    for argv in (launch, node):  # the spec is armed, so a typo raises
        with pytest.raises(ValueError, match="unknown fault action 'x'"):
            cli.main(argv + ["--fault_plan", "x"])
    args = cli._build_parser().parse_args(launch + ["--fault_plan", "drop,every=3",
                                                    "--fault_seed", "4"])
    assert (args.fault_plan, args.fault_seed) == ("drop,every=3", 4)
    cfg = json.loads(app.read_text())
    for section, value in (("profile", {"hz": 10}),
                           ("timeseries", {"metrics_port": 9000})):
        armed = tmp_path / f"armed-{section}.json"
        armed.write_text(json.dumps({**cfg, section: value}))
        with monkeypatch.context() as m:
            m.setattr(TM, "run_node", fake_node)
            assert cli.main(["node", *node[1:-4], "--app_file", str(armed),
                             "--device", "cpu"]) == 0
        (field, want), = value.items()
        assert getattr(getattr(seen["node"], section), field) == want
    mf = tmp_path / "mf.json"
    mf.write_text(json.dumps({**cfg, "app": "matrix_fac"}))
    with pytest.raises(SystemExit, match="not ported yet"):
        cli.main(["launch", "--app_file", str(mf), "--device", "cpu"])
    # run_node arms [trace] and [blackbox] before it builds its node (the
    # typo'd chaos spec then stops the node before it connects anywhere)
    pc = TCFG.PSConfig()
    pc.trace.trace_dir = str(tmp_path / "tr")
    pc.blackbox.dir = str(tmp_path / "bb")
    pc.fault.fault_plan = "drop=0.1"
    try:
        with pytest.raises(ValueError, match="unknown fault action"):
            TM.run_node(pc, "server", 0, "127.0.0.1:1", 1, 1, device="cpu")
        assert trace.tracer.trace_dir == pc.trace.trace_dir
        assert trace.tracer.process_name == "server-0"
        assert flightrec.blackbox_dir() == pc.blackbox.dir
        assert flightrec.record is flightrec._live_record
    finally:
        trace.configure(None)
        flightrec.configure(None)
    assert flightrec.record is flightrec._noop_record
    pc = TCFG.PSConfig()
    pc.fault.fault_plan = "drop=0.1"
    with pytest.raises(ValueError, match="unknown fault action"):
        TM.run_node(pc, "server", 0, "127.0.0.1:1", 1, 1, device="cpu")
    with pytest.raises(ValueError, match="unknown role"):
        TM.run_node(TCFG.PSConfig(), "boss", 0, "127.0.0.1:1", 1, 1, device="cpu")
    # launch_local hands the planes to every node it spawns through the
    # environment (the first spawn is stopped here to read it)
    class _Spawned(Exception):
        pass

    def fake_popen(cmd, env=None, **kw):
        raise _Spawned(env)

    with monkeypatch.context() as m:
        m.setattr(subprocess, "Popen", fake_popen)
        with pytest.raises(_Spawned) as got:
            TM.launch_local(str(app), 1, 1, device="cpu", trace_dir=str(tmp_path / "t"),
                            trace_sample=2, blackbox_dir=str(tmp_path / "b"),
                            log_dir=str(tmp_path / "logs"))
    env = got.value.args[0]
    assert env[trace.TRACE_DIR_ENV] == str(tmp_path / "t")
    assert env[trace.TRACE_SAMPLE_ENV] == "2"
    assert env[flightrec.BLACKBOX_DIR_ENV] == str(tmp_path / "b")
    assert (tmp_path / "t").is_dir() and (tmp_path / "b").is_dir()
    with pytest.raises(ValueError, match="unknown fault action"):
        TM.launch_local(str(app), 1, 1, device="cpu", fault_plan="drop=0.1")
    assert not any(tmp_path.glob("pslaunch_*"))


def test_cluster_entry_points_default_to_cuda(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    app = _app(tmp_path, 11, {"max_delay": 0, "epochs": 1})
    log_dir = tmp_path / "logs"
    with pytest.raises(RuntimeError, match="cuda"):
        TM.launch_local(str(app), 1, 1, log_dir=str(log_dir))
    assert not log_dir.exists()  # nothing was spawned
    with pytest.raises(RuntimeError, match="cuda"):
        TM.run_node(TCFG.PSConfig(), "server", 0, "127.0.0.1:1", 1, 1)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["launch", "--app_file", str(app)])
    with pytest.raises(RuntimeError, match="cuda"):
        TM.ShardServer(TU.Sgd(eta=1.0), TK.KeyRange(0, 8))


@pytest.mark.parametrize("app", ["matrix_fac", "wide_deep", "word2vec", "sketch"])
@pytest.mark.parametrize("cmd", ["launch", "node"])
def test_cluster_path_refuses_other_apps(tmp_path, app, cmd):
    """The JAX cluster path reads no ``cfg.app``: it runs ``linear_method``
    whatever the config says. The port refuses the other apps, by name."""
    app_file = _app(tmp_path, 3, {"epochs": 1})
    cfg = json.loads(app_file.read_text())
    app_file.write_text(json.dumps({**cfg, "app": app}))
    argv = {"launch": ["launch"],
            "node": ["node", "--role", "server", "--rank", "0", "--scheduler",
                     "127.0.0.1:1", "--num_servers", "1", "--num_workers", "1"]}[cmd]
    with pytest.raises(SystemExit) as exc:
        cli.main(argv + ["--app_file", str(app_file), "--device", "cpu"])
    assert str(exc.value) == (
        f"the cluster path for app {app!r} is not ported yet to parameter_server_tpu_torch")
