"""The port's seeded interleaving explorer (``analysis/explorer.py``),
mirroring the JAX package's ``tests/test_explorer.py`` and held to it:
strict-mode PCT determinism (same seed => same schedule => same failure,
and the JAX scheduler's schedule), perturb mode's per-site decision
streams (a pure function of seed and site, equal to the JAX explorer's for
the same pair), the port server's publish boundary
(``ShardServer._publish``), one explorer-armed run of the port's serving
chaos-coherence test for seed 8 and every seed of
``tests/torch_sched_corpus.json``, and ``cli explore``'s exit codes beside
the JAX CLI's. Every armed test uninstalls in a ``finally``."""

from __future__ import annotations

import json
import os
import threading

import numpy as np
import pytest

from parameter_server_tpu.analysis import explorer as j_explorer
from parameter_server_tpu_torch.analysis import explorer

#: the node id the port's corpus keys the serving coherence test under
COHERENCE_NODE = (
    "tests/test_torch_serving.py::TestServingChaosCoherence::"
    "test_read_your_writes_and_exactly_once_under_chaos[torch-torch]"
)


def _racy(mod, seed: int):
    """Two threads doing an unprotected read-modify-write with a
    scheduling point inside the race window."""
    sched = mod.StrictSched(seed)
    shared = {"x": 0}

    def worker():
        for _ in range(3):
            v = shared["x"]
            sched.point("window")
            shared["x"] = v + 1

    sched.spawn(worker, "a")
    sched.spawn(worker, "b")
    sched.run()
    return shared["x"], tuple(sched.trace)


class TestStrictDeterminism:
    def test_same_seed_same_schedule_same_outcome(self):
        racy_seed = None
        for seed in range(32):
            x1, t1 = _racy(explorer, seed)
            x2, t2 = _racy(explorer, seed)
            assert t1 == t2, f"seed {seed}: schedule not reproducible"
            assert x1 == x2, f"seed {seed}: outcome not reproducible"
            if x1 < 6 and racy_seed is None:
                racy_seed = seed
        assert racy_seed is not None, "no seed exposed the race"

    def test_different_seeds_explore_different_schedules(self):
        traces = {_racy(explorer, seed)[1] for seed in range(16)}
        assert len(traces) > 1

    def test_schedules_are_the_jax_schedulers(self):
        """A seed is the whole schedule, in either package."""
        for seed in range(8):
            assert _racy(explorer, seed) == _racy(j_explorer, seed), seed

    def test_strict_lock_serializes_the_window(self):
        for seed in range(8):
            sched = explorer.StrictSched(seed)
            shared = {"x": 0}
            lk = sched.lock("l")

            def worker():
                for _ in range(3):
                    with lk:
                        v = shared["x"]
                        sched.point("window")
                        shared["x"] = v + 1

            sched.spawn(worker, "a")
            sched.spawn(worker, "b")
            sched.run()
            assert shared["x"] == 6, f"seed {seed}"

    def test_failure_is_replayable_and_prints_the_seed(self, capsys):
        def run(seed: int):
            sched = explorer.StrictSched(seed)
            shared = {"x": 0}

            def worker():
                for _ in range(3):
                    v = shared["x"]
                    sched.point("window")
                    assert shared["x"] == v, "raced inside the window"
                    shared["x"] = v + 1

            sched.spawn(worker, "a")
            sched.spawn(worker, "b")
            sched.run()
            return sched

        failing_seed = None
        for seed in range(32):
            if run(seed).failures:
                failing_seed = seed
                break
        assert failing_seed is not None, "no seed exposed the assertion"
        s1, s2 = run(failing_seed), run(failing_seed)
        assert [n for n, _ in s1.failures] == [n for n, _ in s2.failures]
        assert s1.trace == s2.trace
        assert f"seed {failing_seed}" in capsys.readouterr().err


class TestPerturbMode:
    def test_install_uninstall_restores_factories(self):
        import queue

        from parameter_server_tpu_torch.parallel.multislice import ShardServer

        lock_before, queue_before = threading.Lock, queue.Queue
        publish_before = ShardServer.__dict__["_publish"]
        explorer.install(seed=5)
        try:
            assert explorer.installed()
            assert threading.Lock is not lock_before
            assert ShardServer.__dict__["_publish"] is not publish_before
        finally:
            explorer.uninstall()
        assert threading.Lock is lock_before
        assert queue.Queue is queue_before
        assert ShardServer.__dict__["_publish"] is publish_before
        assert not explorer.installed()

    @pytest.mark.parametrize("seed", [0, 8, 42])
    def test_site_streams_are_the_jax_explorers(self, seed):
        """The decision a site makes on its n-th visit depends on (seed,
        site, n) alone, and is the JAX explorer's for the same triple."""
        sites = ["lock:parallel/multislice.py:297", "queue.put:parallel/multislice.py:331",
                 "rcu-publish:ShardServer._publish", "unlock:utils/metrics.py:149"]
        mods = {}
        for name, mod in (("port", explorer), ("jax", j_explorer)):
            p = mod._Perturb(seed)
            for _ in range(40):
                for site in sites:
                    p.point(site)
            mods[name] = p.decisions
        assert mods["port"] == mods["jax"]
        assert any(code for codes in mods["port"].values() for code in codes)

    def test_per_site_decision_streams_are_seed_deterministic(self):
        """Two armed runs with one seed make the SAME decision sequence at
        every boundary site (the prefix each run consumed), the port
        server's publish boundary among them."""

        def traffic():
            from parameter_server_tpu_torch.kv.updaters import Sgd
            from parameter_server_tpu_torch.parallel.multislice import (
                ServerHandle,
                ShardServer,
            )
            from parameter_server_tpu_torch.utils.config import PSConfig
            from parameter_server_tpu_torch.utils.keyrange import KeyRange

            srv = ShardServer(Sgd(eta=1.0), KeyRange(0, 64), device="cpu").start()
            h = ServerHandle(srv.address, 0, 0, PSConfig(), range_size=64, device="cpu")
            keys = np.arange(8)
            try:
                h.push(keys, np.ones(8, np.float32))
                return h.pull(keys)
            finally:
                h.shutdown()
                h.close()

        logs = []
        for _ in range(2):
            explorer.install(seed=42)
            try:
                np.testing.assert_allclose(traffic(), -np.ones(8, np.float32))
                logs.append(explorer.decisions())
            finally:
                explorer.uninstall()
        d1, d2 = logs
        common = set(d1) & set(d2)
        assert common, "no shared boundary sites across runs"
        for site in common:
            n = min(len(d1[site]), len(d2[site]))
            assert d1[site][:n] == d2[site][:n], site
        assert "rcu-publish:ShardServer._publish" in common
        assert "rcu-published:ShardServer._publish" in common
        assert any(s.startswith("lock:") for s in common)

    def test_replay_hint_names_env_and_seed(self):
        explorer.install(seed=77)
        try:
            assert "PS_SCHED=77" in explorer.replay_hint()
            assert explorer.current_seed() == 77
        finally:
            explorer.uninstall()

    def test_env_arms_at_package_import(self):
        """``PS_SCHED=<seed>`` arms the explorer when the port's
        ``parallel`` package is imported (a fresh interpreter)."""
        import subprocess
        import sys
        from pathlib import Path

        root = Path(__file__).resolve().parent.parent
        probe = (
            "import json, sys; sys.modules['jax'] = None\n"
            "import parameter_server_tpu_torch.parallel\n"
            "from parameter_server_tpu_torch.analysis import explorer, racewitness\n"
            "print(json.dumps([explorer.current_seed(), racewitness.installed()]))\n"
        )
        env = {**os.environ, "PYTHONPATH": str(root), "PS_SCHED": "13",
               "PS_RACE_WITNESS": "1"}
        out = subprocess.run([sys.executable, "-c", probe], env=env, cwd=root,
                             capture_output=True, text=True, timeout=120, check=True)
        assert json.loads(out.stdout.strip().splitlines()[-1]) == [13, True]


class TestExplorerArmedServing:
    def test_serving_chaos_coherence_survives_forced_interleavings(self):
        """The armed acceptance run: the port's serving chaos-coherence
        test (read-your-writes + exactly-once under drop/disconnect/
        duplicate, caching ON, port server and port handle) re-runs with
        every port lock/queue/publish boundary perturbed from seed 8 —
        plus every seed tests/torch_sched_corpus.json (fed by ``cli
        explore``) records as failing. The coherence asserts inside the
        test body are the invariant; the decision log proves the schedule
        pressure was real."""
        from test_torch_serving import TestServingChaosCoherence

        corpus = os.path.join(os.path.dirname(__file__), "torch_sched_corpus.json")
        seeds = [8] + [s for s in explorer.corpus_seeds(corpus, COHERENCE_NODE) if s != 8]
        for seed in seeds:
            explorer.install(seed=seed)
            try:
                TestServingChaosCoherence().test_read_your_writes_and_exactly_once_under_chaos(
                    "torch", "torch")
                d = explorer.decisions()
                assert sum(len(v) for v in d.values()) > 50, seed
                assert any(s.startswith("rcu-publish:") for s in d), seed
                assert any(s.startswith("queue.") for s in d), seed
            finally:
                explorer.uninstall()


class TestExploreCli:
    """``cli explore``: the JAX CLI's exit codes and corpus writes, with a
    stub runner in place of the pytest subprocess a seed."""

    @staticmethod
    def _run(cli_mod, mod, monkeypatch, argv, runner):
        monkeypatch.setattr(mod, "_pytest_runner", lambda test, timeout_s=120.0: runner)
        return cli_mod.main(argv)

    def test_failing_seeds_are_recorded_and_exit_zero(self, monkeypatch, tmp_path, capsys):
        from parameter_server_tpu import cli as j_cli
        from parameter_server_tpu_torch import cli

        got = {}
        for name, cli_mod, mod in (("port", cli, explorer), ("jax", j_cli, j_explorer)):
            corpus = tmp_path / "c.json"
            rc = self._run(cli_mod, mod, monkeypatch,
                           ["explore", "t::x", "--budget", "5", "--corpus", str(corpus)],
                           lambda seed: seed != 3)
            got[name] = (rc, json.loads(corpus.read_text())["tests"],
                         capsys.readouterr().out)
            corpus.unlink()
        assert got["port"] == got["jax"]
        assert got["port"][:2] == (0, {"t::x": [3]})
        assert "PS_SCHED=3" in got["port"][2]

    def test_an_infra_break_exits_one_and_keeps_the_finds(self, monkeypatch, tmp_path, capsys):
        from parameter_server_tpu_torch import cli

        def runner(seed):
            if seed == 3:
                raise RuntimeError("pytest could not run")
            return seed != 2

        corpus = tmp_path / "c.json"
        assert self._run(cli, explorer, monkeypatch,
                         ["explore", "t::x", "--budget", "5", "--corpus", str(corpus)],
                         runner) == 1
        assert explorer.corpus_seeds(str(corpus), "t::x") == [2]
        assert "search aborted" in capsys.readouterr().out

    def test_no_record_leaves_the_corpus_alone(self, monkeypatch, tmp_path):
        from parameter_server_tpu_torch import cli

        corpus = tmp_path / "c.json"
        assert self._run(cli, explorer, monkeypatch,
                         ["explore", "t::x", "--budget", "2", "--no-record",
                          "--corpus", str(corpus)], lambda seed: False) == 0
        assert not corpus.exists()

    def test_default_corpus_is_the_ports(self, monkeypatch):
        """Without --corpus, finds go to tests/torch_sched_corpus.json (a
        stub recorder keeps the committed file untouched)."""
        from parameter_server_tpu_torch import cli

        seen = []
        monkeypatch.setattr(explorer, "record_failing_seeds",
                            lambda path, test, seeds: seen.append((path, test, seeds)))
        assert self._run(cli, explorer, monkeypatch, ["explore", "t::x", "--budget", "1"],
                         lambda seed: False) == 0
        ((path, test, seeds),) = seen
        assert path.endswith(os.path.join("tests", "torch_sched_corpus.json"))
        assert (test, seeds) == ("t::x", [1])
