"""Chaos on the port's wire tier (``parallel/chaos.py`` and the hooks in
``parallel/control.py`` / ``multislice.py``), mirroring the JAX package's
``tests/test_chaos.py``: the port's ``FaultPlan`` decides exactly as the
JAX one for the same spec and seed; a port ``RpcServer`` under a plan
heals and applies every command once, against a port client and across
packages (a JAX client against a port server and the reverse); the port
``Coordinator`` keeps workload fetches, SSP finishes and barrier arrivals
exactly once; a port ``ShardServer`` under a plan ends equal to a clean
JAX server fed the same pushes (rtol 1e-5, atol 1e-6), FTRL and AdaGrad;
and a small port cluster under a plan builds the clean JAX cluster's
model. Every server and client is stopped in a ``finally``."""

from __future__ import annotations

import json
import os
import threading
import time
from pathlib import Path

import numpy as np
import pytest
import torch

from parameter_server_tpu.kv import updaters as JU
from parameter_server_tpu.parallel import chaos as JCH
from parameter_server_tpu.parallel import control as JC
from parameter_server_tpu.parallel import multislice as JM
from parameter_server_tpu.utils import config as JCFG
from parameter_server_tpu.utils import keyrange as JK
from parameter_server_tpu.utils.metrics import wire_counters as j_counters
from parameter_server_tpu_torch.kv import updaters as TU
from parameter_server_tpu_torch.parallel import chaos as TCH
from parameter_server_tpu_torch.parallel import control as TC
from parameter_server_tpu_torch.parallel import multislice as TM
from parameter_server_tpu_torch.utils import config as TCFG
from parameter_server_tpu_torch.utils import keyrange as TK
from parameter_server_tpu_torch.utils.metrics import wire_counters as t_counters

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
ROOT = Path(__file__).resolve().parent.parent
PKGS = {"torch": (TCH, TC), "jax": (JCH, JC)}
COUNTERS = {"torch": t_counters, "jax": j_counters}


@pytest.fixture(autouse=True)
def _fresh_counters():
    """Both packages' process-global wire counters start each test at 0."""
    t_counters.reset()
    j_counters.reset()
    yield
    t_counters.reset()
    j_counters.reset()


# ---------------------------------------------------------------------------
# the plan language
# ---------------------------------------------------------------------------

SPECS = [
    "drop,prob=0.05;disconnect,cmd=push,every=5;duplicate,prob=0.05;"
    "delay,prob=0.1,delay_s=0.002",
    "drop,prob=0.25;delay,cmd=push,every=3,delay_s=0.5,max=2",
    '[{"action": "disconnect", "cmd": "workload_fetch", "every": 2}, '
    '{"action": "drop", "prob": 0.3, "max": 50}]',
    "duplicate,every=1,max=7;drop,prob=1.0,cmd=pull",
    "delay,prob=0.5,delay_s=0.0;drop,prob=0.5",
]
CMDS = ["push", "pull", "stats", "shutdown", "workload_fetch", "barrier", "ssp_finish"]


class TestFaultPlanSpec:
    @pytest.mark.parametrize("spec", SPECS)
    @pytest.mark.parametrize("seed", [0, 7, 1234])
    def test_same_decisions_as_jax(self, spec, seed):
        """10k commands: identical decisions, delays and stats."""
        cmds = np.random.default_rng(seed).choice(CMDS, 10_000).tolist()
        seen = {}
        for name, (chaos, _) in PKGS.items():
            plan = chaos.FaultPlan.parse(spec, seed=seed)
            out = []
            for c in cmds:
                d = plan.decide(c)
                out.append(None if d is None else (d.action, d.delay_s))
            seen[name] = (out, plan.stats())
        assert seen["torch"] == seen["jax"]
        assert any(d is not None for d in seen["torch"][0])
        fired = {k: v for k, v in seen["torch"][1].items() if k != "frames"}
        assert t_counters.snapshot() == {f"fault_{k}": v for k, v in fired.items() if v}

    @pytest.mark.parametrize("spec", ["", "explode,prob=0.1", "drop,prob=1.5", "drop,wat=1",
                                      "drop,prob", '[{"action": "drop", "every": "x"}]'])
    def test_bad_specs_raise_in_both(self, spec):
        for chaos, _ in PKGS.values():
            with pytest.raises(ValueError):
                chaos.FaultPlan.parse(spec)

    def test_parse_dsl_and_json(self):
        plan = TCH.FaultPlan.parse(
            "drop,prob=0.25;delay,cmd=push,every=3,delay_s=0.5,max=2", seed=7)
        r0, r1 = plan._rules
        assert (r0.action, r0.cmd, r0.prob) == ("drop", "*", 0.25)
        assert (r1.action, r1.cmd, r1.every, r1.delay_s, r1.max_fires) == (
            "delay", "push", 3, 0.5, 2)
        plan = TCH.FaultPlan.parse('[{"action": "drop", "max": 1}]')
        assert plan._rules[0].max_fires == 1

    def test_every_cadence_budget_and_filters(self):
        plan = TCH.FaultPlan.parse("drop,cmd=push,every=3,max=2")
        fired = [plan.decide("push") is not None for _ in range(12)]
        assert fired == [False, False, True, False, False, True] + [False] * 6
        assert plan.stats() == {"frames": 12, "drop": 2}
        assert plan.decide("pull") is None
        plan = TCH.FaultPlan.parse("drop,prob=1.0")
        assert plan.decide("shutdown") is None and plan.decide("x") is not None

    def test_from_env(self):
        plan = TCH.FaultPlan.from_env({TCH.PLAN_ENV: "delay,every=1,delay_s=0.0",
                                       TCH.SEED_ENV: "5"})
        assert plan is not None and plan.seed == 5
        assert TCH.FaultPlan.from_env({}) is None


# ---------------------------------------------------------------------------
# the self-healing RPC layer under a plan
# ---------------------------------------------------------------------------


class _CountingEcho:
    """A handler whose side effect (the apply count) shows: a double-applied
    frame skips a value in the replies."""

    def __init__(self):
        self.applies = 0
        self.lock = threading.Lock()

    def __call__(self, header, arrays):
        with self.lock:
            self.applies += 1
            return {"ok": True, "n": self.applies}, {}


def _serve(pkg: str, spec: str | None, seed: int = 0):
    chaos, control = PKGS[pkg]
    handler = _CountingEcho()
    plan = chaos.FaultPlan.parse(spec, seed=seed) if spec else None
    return control.RpcServer(handler, fault_plan=plan).start(), handler


# (server package, client package): the port on at least one side
PAIRS = [("torch", "torch"), ("torch", "jax"), ("jax", "torch")]


class TestSelfHealingRpc:
    @pytest.mark.parametrize("srv_pkg,cli_pkg", PAIRS)
    def test_drop_is_retried_and_applied_once(self, srv_pkg, cli_pkg):
        srv, handler = _serve(srv_pkg, "drop,every=2")
        cli = PKGS[cli_pkg][1].RpcClient(srv.address, reconnect_timeout_s=20.0)
        try:
            assert [cli.call("echo")[0]["n"] for _ in range(6)] == [1, 2, 3, 4, 5, 6]
            assert handler.applies == 6 and srv.fault_stats()["drop"] >= 1
            # a dropped request never reached the handler: the resend is a
            # first delivery, so retries fire and the reply cache does not
            assert COUNTERS[cli_pkg].get("rpc_retries") >= 1
        finally:
            cli.close()
            srv.stop()

    @pytest.mark.parametrize("srv_pkg,cli_pkg", PAIRS)
    def test_disconnect_reply_replayed_not_reapplied(self, srv_pkg, cli_pkg):
        srv, handler = _serve(srv_pkg, "disconnect,every=2")
        cli = PKGS[cli_pkg][1].RpcClient(srv.address, reconnect_timeout_s=20.0)
        try:
            assert [cli.call("echo")[0]["n"] for _ in range(6)] == [1, 2, 3, 4, 5, 6]
            assert handler.applies == 6
            assert COUNTERS[srv_pkg].get("rpc_dedup_hits") == srv.fault_stats()[
                "disconnect"] >= 1
            assert COUNTERS[cli_pkg].get("rpc_reconnects") >= 1
        finally:
            cli.close()
            srv.stop()

    @pytest.mark.parametrize("srv_pkg,cli_pkg", PAIRS)
    def test_duplicate_frame_deduped(self, srv_pkg, cli_pkg):
        srv, handler = _serve(srv_pkg, "duplicate,every=1")
        cli = PKGS[cli_pkg][1].RpcClient(srv.address)
        try:
            assert [cli.call("echo")[0]["n"] for _ in range(5)] == [1, 2, 3, 4, 5]
            assert handler.applies == 5
            assert COUNTERS[srv_pkg].get("rpc_dedup_hits") == 5
        finally:
            cli.close()
            srv.stop()

    def test_delay_slows_but_preserves(self):
        srv, handler = _serve("torch", "delay,every=1,delay_s=0.01")
        cli = TC.RpcClient(srv.address)
        try:
            t0 = time.monotonic()
            for _ in range(3):
                cli.call("echo")
            assert time.monotonic() - t0 >= 0.03 and handler.applies == 3
            assert srv.fault_stats() == {"frames": 3, "delay": 3}
        finally:
            cli.close()
            srv.stop()

    def test_pipelined_window_under_mixed_plan(self):
        """A full window of async calls under every action at once: each
        applies once and every future completes."""
        srv, handler = _serve("torch", "drop,every=7;disconnect,every=5;duplicate,every=3;"
                                       "delay,every=4,delay_s=0.001", seed=3)
        cli = TC.RpcClient(srv.address, window=6, reconnect_timeout_s=20.0)
        try:
            futs = [cli.call_async("echo") for _ in range(40)]
            got = sorted(f.result(timeout=30)[0]["n"] for f in futs)
            assert got == list(range(1, 41)) and handler.applies == 40
            assert all(srv.fault_stats()[a] >= 1 for a in TCH.ACTIONS)
        finally:
            cli.close()
            srv.stop()

    def test_no_retry_call_fails_fast_on_a_lost_connection(self):
        """``_retry=False`` restores the no-retry path: the call dies with
        its connection (the heal resends nothing for it), while a retrying
        call on the same client still completes."""
        srv, handler = _serve("torch", "drop,cmd=once,every=1")
        cli = TC.RpcClient(srv.address, reconnect_timeout_s=20.0)
        try:
            with pytest.raises(ConnectionError, match="lost"):
                cli.call("once", _retry=False)
            assert handler.applies == 0
            assert cli.call("echo")[0]["n"] == 1
            srv.stop()
            time.sleep(0.05)
            with pytest.raises(ConnectionError):
                cli.call("echo", _retry=False)
        finally:
            cli.close()
            srv.stop()

    def test_heal_retries_when_replacement_dies_under_resend(self, monkeypatch):
        """The replacement connection dies under the heal's own resend:
        the heal notices the swap and retries, so the call completes."""
        from parameter_server_tpu_torch.parallel import control as control_mod

        srv, handler = _serve("torch", "disconnect,cmd=echo,every=1,max=1")
        cli = TC.RpcClient(srv.address, reconnect_timeout_s=20.0)
        real = control_mod._send_gather
        fired = []

        def racy_send(sock, bufs):
            real(sock, bufs)
            if (not fired and cli._healing
                    and threading.current_thread().name == "ps-rpc-reader"):
                fired.append(1)
                cli._conn_died(sock, cli._gen)

        monkeypatch.setattr(control_mod, "_send_gather", racy_send)
        try:
            assert cli.call("echo")[0]["n"] == 1
            assert handler.applies == 1 and fired
            deadline = time.monotonic() + 10.0
            while t_counters.get("rpc_reconnects") < 2 and time.monotonic() < deadline:
                time.sleep(0.02)
            assert t_counters.get("rpc_reconnects") >= 2
        finally:
            cli.close()
            srv.stop()

    def test_server_restart_transparent_resend(self):
        class Dying:
            def __init__(self):
                self.applies = 0

            def __call__(self, header, arrays):
                if header.get("die"):
                    raise TC.RpcServer.Shutdown
                self.applies += 1
                return {"ok": True, "n": self.applies}, {}

        srv1 = TC.RpcServer(Dying()).start()
        host, port = srv1.address.rsplit(":", 1)
        cli = TC.RpcClient(srv1.address, reconnect_timeout_s=20.0)
        try:
            assert cli.call("echo")[0]["n"] == 1
            cli.call("echo", die=True)
            h2 = Dying()
            deadline = time.monotonic() + 10
            while True:
                try:
                    srv2 = TC.RpcServer(h2, host=host, port=int(port))
                    break
                except OSError:
                    if time.monotonic() > deadline:
                        raise
                    time.sleep(0.05)
            srv2.start()
            try:
                assert cli.call("echo")[0]["n"] == 1 and h2.applies == 1
                assert t_counters.get("rpc_reconnects") >= 1
            finally:
                srv2.stop()
        finally:
            cli.close()
            srv1.stop()


# ---------------------------------------------------------------------------
# the coordinator under a plan
# ---------------------------------------------------------------------------


class TestCoordinatorUnderChaos:
    def test_workload_fetch_exactly_once_under_disconnect(self):
        coord = TC.Coordinator(fault_plan=TCH.FaultPlan.parse(
            "disconnect,cmd=workload_fetch,every=2"))
        ctl = TC.ControlClient(coord.address, reconnect_timeout_s=20.0)
        try:
            items = [f"it-{i}" for i in range(8)]
            ctl.workload_init(items)
            got = [ctl.workload_fetch(worker=0) for _ in range(8)]
            assert sorted(got) == sorted(items)
            st = ctl.workload_stats()
            assert st["attempts"] == 8 and st["reassigned"] == 0
            assert ctl.workload_fetch(worker=0) is None
            assert t_counters.get("rpc_dedup_hits") >= 1
        finally:
            ctl.close()
            coord.stop()

    def test_ssp_finish_duplicated_not_reapplied(self):
        coord = TC.Coordinator(fault_plan=TCH.FaultPlan.parse(
            "duplicate,cmd=ssp_finish,every=1"))
        ctl = TC.ControlClient(coord.address)
        try:
            ctl.ssp_init(num_workers=1, max_delay=0)
            for step in range(4):
                assert ctl.ssp_wait(0, step)
                ctl.ssp_finish(0, step)
            rep, _ = ctl.call("ssp_progress")
            assert rep["min_finished"] == 3 and rep["retired"] == []
            assert t_counters.get("rpc_dedup_hits") == 4
        finally:
            ctl.close()
            coord.stop()

    def test_barrier_arrival_not_double_counted(self):
        coord = TC.Coordinator(fault_plan=TCH.FaultPlan.parse(
            "disconnect,cmd=barrier,every=1,max=1"))
        c1 = TC.ControlClient(coord.address, reconnect_timeout_s=20.0)
        c2 = TC.ControlClient(coord.address, reconnect_timeout_s=20.0)
        try:
            t = threading.Thread(target=c1.barrier, args=("b", 2))
            t.start()
            c2.barrier("b", 2)
            t.join(timeout=30)
            assert not t.is_alive()
            assert t_counters.get("rpc_dedup_hits") >= 1
            with pytest.raises(RuntimeError, match="barrier timeout"):
                c2.call("barrier", name="b", count=2, timeout=0.3)
        finally:
            c1.close()
            c2.close()
            coord.stop()

    @pytest.mark.parametrize("client_pkg", ["torch", "jax"])
    def test_mixed_plan_control_plane_converges(self, client_pkg):
        """The JAX ``TestChaosSmoke`` drive against a port coordinator,
        from either package's ControlClient."""
        coord = TC.Coordinator(fault_plan=TCH.FaultPlan.parse(
            "drop,prob=0.05;disconnect,prob=0.05;duplicate,prob=0.05;"
            "delay,prob=0.05,delay_s=0.002", seed=1234))
        ctl = PKGS[client_pkg][1].ControlClient(coord.address, reconnect_timeout_s=30.0)
        arr = np.arange(32, dtype=np.float32)
        try:
            ctl.register("worker", rank=0)
            ctl.ssp_init(num_workers=1, max_delay=1)
            items = [f"e{e}:f{f}" for e in range(4) for f in range(4)]
            ctl.workload_init(items)
            seen, step = [], 0
            while (w := ctl.workload_fetch(worker=0)) is not None:
                seen.append(w)
                assert ctl.ssp_wait(0, step, timeout=30)
                ctl.kv_set(f"blob/{w}", arrays={"x": arr})
                np.testing.assert_array_equal(ctl.kv_get(f"blob/{w}")[1]["x"], arr)
                ctl.ssp_finish(0, step)
                step += 1
                ctl.workload_finish(w)
            assert sorted(seen) == sorted(items)
            assert ctl.workload_stats() == {"pending": 0, "active": 0, "done": 16,
                                            "attempts": 16, "reassigned": 0}
            stats = coord.server.fault_stats()
            assert stats["frames"] > 50
            assert sum(v for k, v in stats.items() if k != "frames") >= 5
        finally:
            ctl.close()
            coord.stop()


# ---------------------------------------------------------------------------
# exactly-once at the shard server
# ---------------------------------------------------------------------------

RANGE = 1024
PLAN = ("drop,prob=0.05;disconnect,cmd=push,every=5;duplicate,prob=0.05;"
        "delay,prob=0.1,delay_s=0.002")
UPDATERS = {
    "ftrl": ({"alpha": 0.5, "beta": 1.0, "lambda_l1": 1e-3, "lambda_l2": 0.01}, 1),
    "adagrad": ({"eta": 0.1, "eps": 1e-8, "lambda_l2": 0.0}, 4),
}


def _pushes(vdim: int, n: int = 24, seed: int = 0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        keys = np.unique(rng.integers(0, RANGE, 200))
        out.append((keys, rng.normal(size=(len(keys), vdim)).astype(np.float32)))
    return out


@pytest.mark.parametrize("algo", sorted(UPDATERS))
@pytest.mark.parametrize("pipelined", [False, True], ids=["sync", "async"])
def test_shard_server_under_a_plan_equals_clean_jax_server(algo, pipelined):
    """The port server under every action, pushes one at a time (through
    the sync or the async path), ends equal to a clean JAX server fed the
    same pushes; its ledger holds each push once and the plan fired."""
    hyper, vdim = UPDATERS[algo]
    cls = {"ftrl": "Ftrl", "adagrad": "Adagrad"}[algo]
    srv = TM.ShardServer(getattr(TU, cls)(**hyper), TK.KeyRange(RANGE, 2 * RANGE), vdim=vdim,
                         fault_plan=TCH.FaultPlan.parse(PLAN, seed=7), device="cpu").start()
    cfg = TCFG.PSConfig()
    cfg.fault.reconnect_timeout_s = 30.0
    h = TM.ServerHandle(srv.address, 0, 0, cfg, range_size=RANGE, device="cpu")
    jsrv = JM.ShardServer(getattr(JU, cls)(**hyper), JK.KeyRange(RANGE, 2 * RANGE),
                          vdim=vdim).start()
    jh = JM.ServerHandle(jsrv.address, 0, 0, JCFG.PSConfig(), range_size=RANGE)
    pushes = _pushes(vdim, seed=1 if pipelined else 0)
    try:
        if pipelined:
            # the async path, each push acked before the next is issued:
            # the updaters are nonlinear, so the order must be the JAX one
            for k, g in pushes:
                h.push_async(k, g).result(timeout=60)
        else:
            for k, g in pushes:
                h.push(k, g)
        for k, g in pushes:
            jh.push(k, g)
        keys = np.arange(RANGE)
        np.testing.assert_allclose(h.pull(keys), jh.pull(keys), rtol=RTOL, atol=ATOL)
        assert srv.counters["pushes"] == len(pushes)
        ledger = srv._applied_push[h.client.identity[0]]
        assert sorted(ledger) == sorted(f"k{i}" for i in range(len(pushes)))
        faults = h.stats()["faults"]
        assert faults["frames"] > len(pushes) and faults["disconnect"] >= 1
    finally:
        h.shutdown()
        h.close()
        jh.shutdown()
        jh.close()
        srv.server.stop()


# ---------------------------------------------------------------------------
# a small cluster under a plan
# ---------------------------------------------------------------------------


class TestChaosSmoke:
    def test_cluster_under_a_plan_builds_the_clean_jax_model(self, tmp_path, monkeypatch):
        """``launch_local(fault_plan=...)`` arms every node (the coordinator
        and both servers): 1 worker at max_delay 0 builds the clean JAX
        cluster's model, each workload done once."""
        from parameter_server_tpu.data.synthetic import make_sparse_logistic, write_libsvm
        from parameter_server_tpu_torch.utils.checkpoint import load_weights_text

        monkeypatch.setenv("PYTHONPATH", os.pathsep.join(
            p for p in (str(ROOT), os.environ.get("PYTHONPATH", "")) if p))
        monkeypatch.setenv("OMP_NUM_THREADS", "1")
        num_keys = 1 << 12
        labels, keys, vals, _ = make_sparse_logistic(1200, 400, nnz_per_example=8,
                                                     noise=0.3, seed=5)
        files = []
        for i in range(3):
            f = tmp_path / f"part-{i}.libsvm"
            write_libsvm(f, labels[i * 400:(i + 1) * 400], keys[i * 400:(i + 1) * 400],
                         vals[i * 400:(i + 1) * 400])
            files.append(str(f))
        cfg = {"app": "linear_method",
               "data": {"files": files, "format": "libsvm", "num_keys": num_keys,
                        "max_nnz_per_example": 32},
               "solver": {"algo": "ftrl", "minibatch": 128, "max_delay": 0, "epochs": 1},
               "lr": {"alpha": 0.3, "beta": 1.0}, "penalty": {"lambda_l1": 0.005},
               "fault": {"reconnect_timeout_s": 30.0}}
        app = tmp_path / "app.json"
        app.write_text(json.dumps(cfg))
        mt, mj = tmp_path / "port.txt", tmp_path / "jax.txt"
        # one cluster at a time: the suite's latency-gated tests share the
        # host (tests/test_whylate.py)
        rj = JM.launch_local(str(app), num_servers=2, num_workers=1, model_out=str(mj),
                             timeout=240, devices="cpu")
        rt = TM.launch_local(str(app), num_servers=2, num_workers=1, model_out=str(mt),
                             timeout=240, device="cpu",
                             fault_plan="drop,prob=0.02;disconnect,cmd=push,every=5;"
                                        "duplicate,prob=0.05;delay,prob=0.05,delay_s=0.002",
                             fault_seed=7)
        np.testing.assert_allclose(load_weights_text(mt, num_keys),
                                   load_weights_text(mj, num_keys), rtol=RTOL, atol=ATOL)
        assert rt["workloads"] == rj["workloads"] == {
            "pending": 0, "active": 0, "done": 3, "attempts": 3, "reassigned": 0}
        assert [s["pushes"] for s in rt["server_stats"]] == [
            s["pushes"] for s in rj["server_stats"]]
        faults = [s["faults"] for s in rt["server_stats"]]
        assert sum(f["disconnect"] for f in faults) >= 1
