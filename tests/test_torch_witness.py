"""The port's runtime lock-order witness (``analysis/witness.py``), as
``tests/test_pslint.py``'s ``TestWitness`` holds the JAX one, on the port's
locks: an inversion raises with its cycle, a consistent order and an
RLock's re-entrancy never do, a statically cyclic pair seeds one way, and
the static seed names locks as the runtime does. Then what the port adds:
it stacks with the JAX witness that the test harness arms for the whole
session (it wraps the constructor as it stands, never twice, and uninstalls
in LIFO order), it arms from ``PS_LOCK_WITNESS`` when ``parallel`` is
imported, ``launch_local`` exports it to its nodes, and an armed port
``RpcServer``/``RpcClient`` and ``ShardServer`` under concurrent applies
and pulls raise nothing. Last, the shard server on the CPU never loads the
kernel library (a card server loads it at start, outside every lock)."""

from __future__ import annotations

import json
import os
import subprocess
import sys
import threading
from pathlib import Path

import numpy as np
import pytest
import torch

from parameter_server_tpu.analysis import witness as jax_witness
from parameter_server_tpu_torch.analysis import witness

torch.set_num_threads(1)

ROOT = Path(__file__).resolve().parent.parent


@pytest.fixture
def armed():
    """The port's witness over whatever the session armed (the JAX one)."""
    witness.install()
    try:
        yield witness
    finally:
        witness.uninstall()


def test_inversion_raises_with_cycle_path():
    witness.install(static=False)
    try:
        a = witness.wrap(threading.Lock(), "lock:a")
        b = witness.wrap(threading.Lock(), "lock:b")
        with a:
            with b:
                pass
        with pytest.raises(witness.LockOrderViolation) as ei:
            with b:
                with a:
                    pass
        assert "lock:a" in str(ei.value) and "lock:b" in str(ei.value)
    finally:
        witness.uninstall()


def test_consistent_order_never_raises():
    witness.install(static=False)
    try:
        a = witness.wrap(threading.Lock(), "lock:a")
        b = witness.wrap(threading.Lock(), "lock:b")
        for _ in range(3):
            with a:
                with b:
                    pass
        assert ("lock:a", "lock:b") in witness.observed_edges()
        assert witness.report()["edges"] == 1
    finally:
        witness.uninstall()


def test_reentrant_rlock_is_not_an_inversion():
    witness.install(static=False)
    try:
        r = witness.wrap(threading.RLock(), "lock:r")
        with r:
            with r:
                pass
    finally:
        witness.uninstall()


def test_cyclic_static_seed_does_not_blind_the_witness():
    witness.install(static=False)
    try:
        witness._graph.seed({("seed:a", "seed:b"), ("seed:b", "seed:a")})
        a = witness.wrap(threading.Lock(), "seed:a")
        b = witness.wrap(threading.Lock(), "seed:b")
        with a:  # the deterministically-kept direction (sorted)
            with b:
                pass
        with pytest.raises(witness.LockOrderViolation):
            with b:
                with a:
                    pass
    finally:
        witness.uninstall()


def test_static_seed_matches_runtime_naming(armed):
    """The static edges are the port's lock construction sites, and a lock
    constructed while armed carries exactly such a site."""
    from parameter_server_tpu_torch.kv import updaters as TU
    from parameter_server_tpu_torch.parallel import multislice as TM
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    edges = witness._static_site_edges()
    assert any(a.startswith("parallel/multislice.py:")
               and b.startswith("parallel/multislice.py:") for a, b in edges), edges
    srv = TM.ShardServer(TU.Sgd(eta=1.0), KeyRange(0, 64), device="cpu")
    try:
        names = {srv._lock._psl_name, srv._pub_lock._psl_name}
        assert (srv._lock._psl_name, srv._pub_lock._psl_name) in edges
        assert all(n.startswith("parallel/multislice.py:") for n in names)
        assert witness.report()["static_edges"] == len(edges)
    finally:
        srv.server.stop()


def test_stacks_over_the_session_witness_in_lifo_order():
    assert jax_witness.installed()  # the session fixture armed it
    below = threading.Lock
    witness.install(static=False)
    try:
        witness.install(static=False)  # counted, never wrapped twice
        assert threading.Lock is witness._lock_factory
        assert witness._orig["Lock"] is below
        witness.uninstall()
        assert threading.Lock is witness._lock_factory
        # a port lock is the port's wrapper, over the layer below
        assert type(_port_lock()) is witness.WitnessLock
    finally:
        witness.uninstall()
    assert threading.Lock is below
    assert not witness.installed()


def _port_lock():
    """A lock constructed by port source (a fresh KeyHeatSketch's)."""
    from parameter_server_tpu_torch.utils.metrics import KeyHeatSketch

    return KeyHeatSketch()._lock


def test_uninstall_out_of_lifo_order_raises_and_changes_nothing():
    below = threading.Lock
    witness.install(static=False)
    top = threading.Lock

    def other_wrapper():
        return top()

    threading.Lock = other_wrapper
    try:
        with pytest.raises(RuntimeError, match="LIFO"):
            witness.uninstall()
        assert witness.installed() and threading.Lock is other_wrapper
    finally:
        threading.Lock = top
    witness.uninstall()
    assert threading.Lock is below and not witness.installed()


def test_disarmed_witness_passes_locks_through():
    assert not witness.installed()
    assert type(_port_lock()).__name__ != "WitnessLock"


def test_armed_for_multithreaded_rpc_without_raising(armed):
    from parameter_server_tpu_torch.parallel.control import RpcClient, RpcServer

    def handler(h, arrays):
        return {"ok": True, "echo": h.get("x")}, {}

    srv = RpcServer(handler).start()
    cli = RpcClient(srv.address, window=4)
    assert type(cli._send_lock) is witness.WitnessLock
    assert type(srv._counter_lock) is witness.WitnessLock
    errs: list[BaseException] = []

    def pound(lo: int) -> None:
        try:
            futs = [cli.call_async("echo", x=i) for i in range(lo, lo + 24)]
            got = sorted(f.result()[0]["echo"] for f in futs)
            assert got == list(range(lo, lo + 24))
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    ts = [threading.Thread(target=pound, args=(k * 100,), daemon=True) for k in range(3)]
    for t in ts:
        t.start()
    for t in ts:
        t.join(timeout=30)
    cli.close()
    srv.stop()
    assert not errs, errs
    assert witness.report()["violations"] == 0


def test_armed_shard_server_apply_and_pull_without_raising(armed):
    """Concurrent pushes through the apply engine (apply lock, then the
    publish lock) beside concurrent pulls (the publish lock alone) and
    stats, on an armed port server and handles: no inversion, and every
    witnessed edge between the server's own locks is one the static graph
    has."""
    from parameter_server_tpu_torch.kv import updaters as TU
    from parameter_server_tpu_torch.parallel import multislice as TM
    from parameter_server_tpu_torch.utils import config as TC
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    n = 256
    srv = TM.ShardServer(TU.Ftrl(alpha=0.5, beta=1.0, lambda_l1=1e-3, lambda_l2=0.01),
                         KeyRange(0, n), device="cpu").start()
    assert type(srv._pub_lock) is witness.WitnessLock
    handles = [TM.ServerHandle(srv.address, 0, w, TC.PSConfig(), range_size=n,
                               device="cpu") for w in range(3)]
    errs: list[BaseException] = []

    def worker(h, seed: int) -> None:
        rng = np.random.default_rng(seed)
        try:
            for _ in range(12):
                keys = np.unique(rng.integers(0, n, 40))
                h.push(keys, rng.normal(size=len(keys)).astype(np.float32))
                assert h.pull(keys).shape[0] == len(keys)
            h.stats()
        except BaseException as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    ts = [threading.Thread(target=worker, args=(h, i), daemon=True)
          for i, h in enumerate(handles)]
    try:
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=60)
    finally:
        handles[0].shutdown()
        for h in handles:
            h.close()
        srv.server.stop()
        srv.join(timeout=5)
    assert not errs, errs
    assert srv.counters["pushes"] == 36
    rep = witness.report()
    ms = "parallel/multislice.py:"
    own = [e for e in rep["not_static_edges"] if e[0].startswith(ms) and e[1].startswith(ms)]
    assert own == []


def test_export_witness_env_follows_the_port_witness(armed, monkeypatch):
    from parameter_server_tpu_torch.parallel.multislice import _export_witness_env

    env: dict = {}
    _export_witness_env(env)
    assert env.get(witness.ENV_VAR) == "1"
    monkeypatch.setattr(witness, "installed", lambda: False)
    env = {}
    _export_witness_env(env)
    assert witness.ENV_VAR not in env


def test_parallel_import_arms_from_the_env():
    """``PS_LOCK_WITNESS=1`` arms the port's witness when ``parallel`` is
    imported, before its submodules construct their locks, with JAX absent."""
    probe = (
        "import json, sys\n"
        "sys.modules['jax'] = None\n"
        "import parameter_server_tpu_torch.parallel\n"
        "from parameter_server_tpu_torch.analysis import witness\n"
        "from parameter_server_tpu_torch.utils.metrics import KeyHeatSketch\n"
        "print(json.dumps({'armed': witness.installed(),\n"
        "    'lock': type(KeyHeatSketch()._lock).__name__,\n"
        "    'seed': witness.report()['static_edges'],\n"
        "    'jax': [m for m in sys.modules if m.startswith('parameter_server_tpu.')]}))\n"
    )
    env = {**os.environ, "PYTHONPATH": str(ROOT), "PS_LOCK_WITNESS": "1"}
    out = subprocess.run([sys.executable, "-c", probe], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120, check=True)
    got = json.loads(out.stdout.strip().splitlines()[-1])
    assert got["armed"] and got["lock"] == "WitnessLock" and got["seed"] > 0
    assert got["jax"] == []


def test_cpu_server_never_loads_the_kernel_library(monkeypatch):
    """The kernel library loads at a card server's start; a server on the
    CPU never loads it, through start, pushes, pulls and a dump."""
    from parameter_server_tpu_torch.kv import updaters as TU
    from parameter_server_tpu_torch.ops import cuda_build
    from parameter_server_tpu_torch.parallel import multislice as TM
    from parameter_server_tpu_torch.utils import config as TC
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    loads: list[int] = []
    monkeypatch.setattr(cuda_build, "load", lambda: loads.append(1))
    monkeypatch.setattr(cuda_build, "build", lambda: loads.append(1))
    for upd in (TU.Ftrl(alpha=0.5, beta=1.0, lambda_l1=1e-3, lambda_l2=0.01),
                TU.Adagrad(eta=0.1, eps=1e-8, lambda_l2=0.0)):
        srv = TM.ShardServer(upd, KeyRange(0, 64), device="cpu").start()
        h = TM.ServerHandle(srv.address, 0, 0, TC.PSConfig(), range_size=64, device="cpu")
        try:
            keys = np.arange(0, 64, 3)
            h.push(keys, np.ones(len(keys), np.float32))
            assert np.abs(h.pull(keys)).max() > 0
            h.dump()
        finally:
            h.shutdown()
            h.close()
            srv.server.stop()
            srv.join(timeout=5)
        assert srv.kernel_load_s is None and srv.first_apply_s is not None
    assert loads == []
