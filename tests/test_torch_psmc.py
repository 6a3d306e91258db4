"""psmc in the port (``analysis/model.py``, ``analysis/specs/``,
``analysis/conformance.py``), the lockset race witness
(``analysis/racewitness.py``), ``cli check`` and the seed corpus, mirroring
the JAX package's ``tests/test_psmc.py`` and held to it:

- the port's engine is the JAX engine: on the specs the two packages share
  (exactly-once, ssp, failover) it gives the same states, transitions and
  depth, and for every seeded bug the same shortest counterexample,
  rendered the same;
- every port spec verifies clean and complete at ``tier1()``, and each of
  its seeded bugs is caught — the port's RCU spec (the in-place publish
  under ``_pub_lock``) with ``torn-publish`` and ``split-read`` among
  them;
- conformance on the port tree is ``[]`` with every ``ASSUMPTIONS`` key
  derived, none skipped; over the JAX tree it derives the JAX analyzer's
  tables; and seeded drift (a renamed cmd, push exempted from the reply
  cache, an unlocked ledger record, ``_publish`` outside ``_pub_lock``, a
  pull reading the version outside its gather's hold, a torn publish, a
  nonce-less restore, the dedup read after the apply) is each caught;
- the race witness reports a crafted unlocked pair and stays silent on
  the locked twin, and the port's serving chaos-coherence run under it
  reports nothing;
- ``cli check`` exits as the JAX one does.

Every armed test uninstalls in a ``finally``: test files share a worker
process under ``--dist loadfile``."""

from __future__ import annotations

import json
import threading
from pathlib import Path

import pytest

from parameter_server_tpu.analysis import load_package as j_load_package
from parameter_server_tpu.analysis.conformance import derive_code_tables as j_derive
from parameter_server_tpu.analysis.core import PackageIndex as JIndex
from parameter_server_tpu.analysis.model import check as j_check
from parameter_server_tpu.analysis.specs import SPECS as J_SPECS
from parameter_server_tpu_torch import cli
from parameter_server_tpu_torch.analysis import explorer, load_package, racewitness
from parameter_server_tpu_torch.analysis.conformance import (
    conformance_diff,
    derive_code_tables,
)
from parameter_server_tpu_torch.analysis.core import PackageIndex
from parameter_server_tpu_torch.analysis.model import Spec, check, freeze
from parameter_server_tpu_torch.analysis.specs import SPECS

ROOT = Path(__file__).resolve().parent.parent
#: the models the two packages share (the port's RCU spec is its own)
SHARED = ("exactly-once", "ssp", "failover")
#: the serving coherence test the port's corpus keys on
COHERENCE_NODE = (
    "tests/test_torch_serving.py::TestServingChaosCoherence::"
    "test_read_your_writes_and_exactly_once_under_chaos[torch-torch]"
)


# ---------------------------------------------------------------------------
# engine
# ---------------------------------------------------------------------------


class _Counter(Spec):
    """Tiny crafted spec: a counter stepping 0..limit by +1 or +2; the
    invariant bans reaching ``bad``. BFS must find the SHORTEST route."""

    name = "counter"

    def __init__(self, limit: int = 8, bad: int | None = None):
        self.limit = limit
        self.bad = bad

    def init_states(self):
        return [0]

    def actions(self, s):
        return [(f"+{d}", s + d) for d in (1, 2) if s + d <= self.limit]

    def invariant(self, s):
        if self.bad is not None and s == self.bad:
            return f"reached {s}"
        return None

    def liveness(self, s):
        return None if s == self.limit else f"stuck at {s}"


class TestEngine:
    def test_freeze_canonicalizes_into_hashables(self):
        a = freeze({"b": [1, 2], "a": {3, 1}})
        b = freeze({"a": {1, 3}, "b": (1, 2)})
        assert a == b
        assert hash(a) == hash(b)
        assert freeze({"a": 1}) != freeze({"a": 2})

    def test_bfs_counterexample_is_shortest(self):
        r = check(_Counter(limit=8, bad=6))
        assert r.violation is not None
        assert r.violation.trace == ["+2", "+2", "+2"]

    def test_clean_spec_verifies_complete(self):
        r = check(_Counter(limit=8))
        assert r.ok and r.complete
        assert r.states == 9  # 0..8

    def test_state_cap_reports_incomplete(self):
        r = check(_Counter(limit=100), max_states=10)
        assert not r.complete

    def test_probe_walks_find_bugs_past_the_cap_deterministically(self):
        kw = dict(max_states=10, probe_seeds=4, probe_len=6000, seed=7)
        a = check(_Counter(limit=5000, bad=4999), **kw)
        b = check(_Counter(limit=5000, bad=4999), **kw)
        assert a.violation is not None and not a.complete
        assert b.violation is not None
        assert a.violation.trace == b.violation.trace
        # the probe's seeded walks are the JAX engine's
        j = j_check(_Counter(limit=5000, bad=4999), **kw)
        assert j.violation.trace == a.violation.trace


# ---------------------------------------------------------------------------
# the port's engine and shared specs against the JAX package's
# ---------------------------------------------------------------------------


class TestParityWithJax:
    @pytest.mark.parametrize("name", SHARED)
    def test_shared_specs_explore_the_same_space(self, name):
        j = j_check(J_SPECS[name].tier1()).summary()
        # the port's engine on the JAX spec, and on the port's copy of it
        assert check(J_SPECS[name].tier1()).summary() == j
        assert check(SPECS[name].tier1()).summary() == j
        assert SPECS[name].BUGS == J_SPECS[name].BUGS
        assert SPECS[name].ASSUMPTIONS == J_SPECS[name].ASSUMPTIONS

    @pytest.mark.parametrize(
        "name,bug", [(n, b) for n in SHARED for b in J_SPECS[n].BUGS])
    def test_shared_bugs_give_the_same_counterexample(self, name, bug):
        jv = j_check(J_SPECS[name].make(bug=bug))
        for pv in (check(J_SPECS[name].make(bug=bug)), check(SPECS[name].make(bug=bug))):
            assert pv.summary() == jv.summary()
            assert pv.violation.render() == jv.violation.render()

    @pytest.mark.parametrize("name", SHARED)
    def test_check_json_is_the_jax_ones(self, name, capsys):
        from parameter_server_tpu.analysis.__main__ import check_main as j_main
        from parameter_server_tpu_torch.analysis.__main__ import check_main as p_main

        argv = ["--json", "--no-conformance", "--spec", name]
        assert j_main(argv) == 0
        j_out = capsys.readouterr().out
        assert p_main(argv) == 0
        assert capsys.readouterr().out == j_out


# ---------------------------------------------------------------------------
# the spec suite: verification + mutation coverage + determinism
# ---------------------------------------------------------------------------


class TestSpecSuite:
    @pytest.mark.parametrize("name", sorted(SPECS))
    def test_tier1_bounds_verify_clean_and_complete(self, name):
        r = check(SPECS[name].tier1())
        assert r.ok, r.violation.render()
        assert r.complete, f"{name}: state cap hit at tier-1 bounds"
        assert r.states > 10

    @pytest.mark.parametrize(
        "name,bug", [(n, b) for n in sorted(SPECS) for b in SPECS[n].BUGS])
    def test_every_seeded_bug_is_caught(self, name, bug):
        r = check(SPECS[name].make(bug=bug))
        assert r.violation is not None, f"{name}/{bug}: the checker lost its teeth"
        assert r.violation.trace, "counterexample must be replayable"
        assert r.violation.kind in ("invariant", "liveness")

    def test_dropped_dedup_fires_exactly_once_with_minimal_trace(self):
        v = check(SPECS["exactly-once"].make(bug="no-dedup")).violation
        assert v.kind == "invariant"
        assert "applied 2 times" in v.message
        assert len(v.trace) == 4, v.render()

    def test_ack_early_needs_the_crash_window(self):
        v = check(SPECS["exactly-once"].make(bug="ack-early")).violation
        assert any("crash" in step for step in v.trace), v.render()

    def test_rcu_spec_models_the_inplace_publish(self):
        """The port's RCU spec: its seeded bugs include a torn publish and
        a split read, each caught by a revalidation serving rows the table
        no longer holds, through the hold the bug splits."""
        rcu = SPECS["rcu"]
        assert {"torn-publish", "split-read", "no-nonce", "no-bump"} <= set(rcu.BUGS)
        torn = check(rcu.make(bug="torn-publish")).violation
        assert "falsely validated" in torn.message
        assert any("version not bumped yet" in s for s in torn.trace)
        split = check(rcu.make(bug="split-read")).violation
        assert "falsely validated" in split.message
        assert any("second hold" in s for s in split.trace)
        nonce = check(rcu.make(bug="no-nonce")).violation
        assert any("load_state" in s for s in nonce.trace)
        assert "did not increase" in check(rcu.make(bug="no-bump")).violation.message
        # the clean model: every apply publishes in its own hold
        labels = {label for _, (label, _) in enumerate(
            rcu.tier1().actions(rcu.tier1().init_states()[0]))}
        assert "writer: apply in place + _publish() in one _pub_lock hold" in labels

    @pytest.mark.parametrize("name", sorted(SPECS))
    def test_checking_is_deterministic(self, name):
        a = check(SPECS[name].tier1())
        b = check(SPECS[name].tier1())
        assert a.summary() == b.summary()
        bug = SPECS[name].BUGS[0]
        va = check(SPECS[name].make(bug=bug)).violation
        vb = check(SPECS[name].make(bug=bug)).violation
        assert va.trace == vb.trace
        assert va.message == vb.message

    def test_unknown_bug_knob_rejected(self):
        with pytest.raises(ValueError, match="unknown bug"):
            SPECS["exactly-once"].make(bug="nope")
        with pytest.raises(ValueError, match="unknown bug"):
            SPECS["rcu"].make(bug="nope")

    def test_violation_renders_replayable_steps(self):
        text = check(SPECS["rcu"].make(bug="no-bump")).violation.render()
        assert "replayable steps" in text
        assert "  1." in text


# ---------------------------------------------------------------------------
# spec <-> code conformance
# ---------------------------------------------------------------------------

#: tests/test_psmc.py's ledger snippet (the JAX shape: no publisher)
_LEDGER_SNIPPET = """
import threading

class Shard:
    def __init__(self):
        self._lock = threading.Lock()
        self._applied_push = {}
        self.server = RpcServer(
            self._handle,
            idempotent_cmds=frozenset({"pull", "dump", "stats"}),
        )

    def _record_push(self, cid, seq):
        self._applied_push.setdefault(cid, set()).add(seq)

    def _handle(self, h, arrays):
        cmd = h["cmd"]
        if cmd == "push":
            with self._lock:
                seen = h["seq"] in self._applied_push.get(h["cid"], ())
                if not seen:
                    self._record_push(h["cid"], h["seq"])
            return {}, {}
        if cmd == "pull":
            return {}, {}
        raise ValueError(cmd)
"""

#: the port's shape: the ledger beside an in-place publisher
_INPLACE_SNIPPET = """
import threading

class Shard:
    def __init__(self):
        self._lock = threading.Lock()
        self._pub_lock = threading.Lock()
        self.state = {"w": make()}
        self._version = fresh_nonce() + 1
        self._applied_push = {}
        self.server = RpcServer(
            self._handle,
            idempotent_cmds=frozenset({"pull", "dump", "stats"}),
        )

    def _record_push(self, cid, seq):
        self._applied_push.setdefault(cid, set()).add(seq)

    def _publish(self):
        self._version += 1

    def _apply(self, idx, g):
        with self._pub_lock:
            for k, v in self.state.items():
                v.index_add_(0, idx, g)
            self._publish()
            ver = self._version
        return ver

    def _gather(self, idx):
        with self._pub_lock:
            ver = self._version
            rows = {k: v.index_select(0, idx) for k, v in self.state.items()}
        return rows, ver

    def load_state(self, new):
        with self._lock, self._pub_lock:
            self.state = new
            self._version = fresh_nonce()
            self._publish()

    def _handle(self, h, arrays):
        cmd = h["cmd"]
        if cmd == "push":
            with self._lock:
                seen = h["seq"] in self._applied_push.get(h["cid"], ())
                if not seen:
                    self._apply(arrays["keys"], arrays["g"])
                    self._record_push(h["cid"], h["seq"])
            return {}, {}
        if cmd == "pull":
            rows, ver = self._gather(arrays["keys"])
            return {"ver": ver}, rows
        raise ValueError(cmd)
"""

_LOCKED_RECORD = (
    "            with self._lock:\n"
    "                seen = h[\"seq\"] in self._applied_push.get(h[\"cid\"], ())\n"
    "                if not seen:\n"
    "                    self._record_push(h[\"cid\"], h[\"seq\"])"
)
_UNLOCKED_RECORD = (
    "            seen = h[\"seq\"] in self._applied_push.get(h[\"cid\"], ())\n"
    "            if not seen:\n"
    "                self._record_push(h[\"cid\"], h[\"seq\"])"
)

#: an edit of the in-place snippet -> the assumption keys it drifts
DRIFTS = {
    "renamed_cmd": (('"stats"', '"statsx"'), {"idempotent_cmds"}),
    "push_exempted": (
        ('{"pull", "dump", "stats"}', '{"pull", "dump", "stats", "push"}'),
        {"idempotent_cmds", "push_rides_reply_cache"}),
    "unlocked_ledger_record": (
        ("                    self._apply(arrays[\"keys\"], arrays[\"g\"])\n"
         "                    self._record_push(h[\"cid\"], h[\"seq\"])",
         "                    self._apply(arrays[\"keys\"], arrays[\"g\"])\n"
         "            self._record_push(h[\"cid\"], h[\"seq\"])"),
        {"ledger_record_under_apply_lock"}),
    "publish_outside_pub_lock": (
        ("            self._publish()\n            ver = self._version\n        return ver",
         "        self._publish()\n        ver = self._version\n        return ver"),
        # no lock is common to the setter's calls, so no hold is the
        # publish lock's: the reads and the restore lose theirs too
        {"inplace_publish_lock", "setter_calls_hold_publish_lock",
         "writes_publish_in_same_hold", "pull_reads_version_in_gather_hold",
         "restore_takes_fresh_nonce"}),
    "torn_publish": (
        ("            self._publish()\n            ver = self._version\n        return ver",
         "        with self._pub_lock:\n            self._publish()\n"
         "            ver = self._version\n        return ver"),
        # the apply's version read now lies in a hold without its rows
        {"writes_publish_in_same_hold", "pull_reads_version_in_gather_hold"}),
    "split_read": (
        ("            ver = self._version\n            rows = {k: v.index_select(0, idx) "
         "for k, v in self.state.items()}",
         "            rows = {k: v.index_select(0, idx) for k, v in self.state.items()}\n"
         "        with self._pub_lock:\n            ver = self._version"),
        {"pull_reads_version_in_gather_hold"}),
    "restore_without_nonce": (
        ("            self._version = fresh_nonce()\n", "            self._version = 0\n"),
        {"restore_takes_fresh_nonce"}),
    "no_bump": (("        self._version += 1\n", "        self._version += 2\n"),
                {"setter_bumps_version"}),
    "second_version_store": (
        ("    def load_state(self, new):",
         "    def reset(self):\n        with self._lock, self._pub_lock:\n"
         "            self._version = fresh_nonce()\n            self._publish()\n\n"
         "    def load_state(self, new):"),
        {"version_store_sites"}),
    "dedup_after_apply": (
        ("                seen = h[\"seq\"] in self._applied_push.get(h[\"cid\"], ())\n"
         "                if not seen:\n"
         "                    self._apply(arrays[\"keys\"], arrays[\"g\"])\n",
         "                self._apply(arrays[\"keys\"], arrays[\"g\"])\n"
         "                seen = h[\"seq\"] in self._applied_push.get(h[\"cid\"], ())\n"
         "                if not seen:\n"),
        {"ledger_checked_before_apply"}),
}


def _drifted_keys(src: str) -> set[str]:
    keys = set()
    for f in conformance_diff(PackageIndex.from_sources({"shard.py": src})):
        assert f.checker == "spec-conformance" and "drifted" in f.message
        keys.add(f.message.split(" assumes ", 1)[1].split(" = ", 1)[0])
    return keys


@pytest.fixture(scope="module")
def port_index():
    return load_package()


class TestConformance:
    def test_real_package_diff_is_empty(self, port_index):
        fs = conformance_diff(port_index)
        assert fs == [], "\n".join(f.render() for f in fs)

    def test_every_assumption_is_derived_on_the_port_tree(self, port_index):
        """Nothing passes vacuously: every key of every spec's
        ASSUMPTIONS is derived from the port's code, the in-place
        publisher's included, and equals the assumption."""
        tables = derive_code_tables(port_index)
        for name, mod in SPECS.items():
            for key, want in mod.ASSUMPTIONS.items():
                assert key in tables, f"{name}: {key} not derived (skipped)"
                assert tables[key] == want, (name, key, tables[key])
        assert tables["__inplace_site__"][2] == "ShardServer"
        assert tables["__ledger_site__"][2] == "ShardServer"
        assert tables["__ssp_site__"][2] == "SSPClock"
        # the JAX design's keys are the JAX tree's alone
        assert "publish_sites" not in tables

    def test_jax_tree_derives_the_jax_analyzers_tables(self):
        jroot = ROOT / "parameter_server_tpu"
        got = derive_code_tables(load_package(jroot))
        want = j_derive(j_load_package(jroot))
        assert got == want
        assert not any(k in got for k in SPECS["rcu"].ASSUMPTIONS)

    def test_snippet_tables_derive_per_present_subsystem(self):
        index = PackageIndex.from_sources({"shard.py": _LEDGER_SNIPPET})
        tables = derive_code_tables(index)
        assert tables == j_derive(JIndex.from_sources({"shard.py": _LEDGER_SNIPPET}))
        assert tables["idempotent_cmds"] == frozenset({"pull", "dump", "stats"})
        assert tables["push_rides_reply_cache"] is True
        assert tables["ledger_record_under_apply_lock"] is True
        assert "publish_sites" not in tables
        assert "inplace_setter" not in tables
        assert "retire_delegates_to_finish" not in tables

    def test_inplace_snippet_is_conformant(self):
        assert _drifted_keys(_INPLACE_SNIPPET) == set()
        tables = derive_code_tables(PackageIndex.from_sources({"shard.py": _INPLACE_SNIPPET}))
        assert {k for k in SPECS["rcu"].ASSUMPTIONS} <= set(tables)

    @pytest.mark.parametrize("name", sorted(DRIFTS))
    def test_seeded_drift_is_a_finding(self, name):
        (old, new), keys = DRIFTS[name]
        assert _INPLACE_SNIPPET.count(old) == 1, name
        assert _drifted_keys(_INPLACE_SNIPPET.replace(old, new)) == keys

    def test_drift_names_the_spec(self):
        (old, new), _ = DRIFTS["split_read"]
        (f,) = conformance_diff(PackageIndex.from_sources(
            {"shard.py": _INPLACE_SNIPPET.replace(old, new)}))
        assert "spec 'rcu'" in f.message and "Shard derives False" in f.message

    def test_unlocked_ledger_record_on_the_jax_snippet(self):
        src = _LEDGER_SNIPPET.replace(_LOCKED_RECORD, _UNLOCKED_RECORD)
        assert "with self._lock" not in src
        assert _drifted_keys(src) == {"ledger_record_under_apply_lock"}


# ---------------------------------------------------------------------------
# lockset race witness
# ---------------------------------------------------------------------------


class _SharedBox:
    def __init__(self):
        self.x = 0


class TestRaceWitness:
    def _hammer(self, obj, lock=None, threads=2, n=200):
        def work():
            for _ in range(n):
                if lock is not None:
                    with lock:
                        obj.x += 1
                else:
                    obj.x += 1

        ts = [threading.Thread(target=work) for _ in range(threads)]
        for t in ts:
            t.start()
        for t in ts:
            t.join()

    def test_true_positive_unlocked_write_pair(self):
        racewitness.install()
        try:
            box = _SharedBox()
            racewitness.track(box, ("x",), "box")
            self._hammer(box)
            reps = racewitness.reports()
            assert len(reps) == 1  # deduped per (object, field)
            assert reps[0].kind in ("write/write", "read/write")
            assert reps[0].attr == "x"
            assert any("work" in line for line in reps[0].stack_a)
            assert any("work" in line for line in reps[0].stack_b)
            with pytest.raises(AssertionError, match="data race"):
                racewitness.assert_no_races()
        finally:
            racewitness.clear()
            racewitness.uninstall()

    def test_true_negative_locked_twin(self):
        racewitness.install()
        try:
            box = _SharedBox()
            lock = racewitness.wrap(threading.Lock())
            racewitness.track(box, ("x",), "box")
            self._hammer(box, lock=lock)
            assert racewitness.reports() == []
            racewitness.assert_no_races()
        finally:
            racewitness.clear()
            racewitness.uninstall()

    def test_untracked_instances_stay_silent(self):
        racewitness.install()
        try:
            tracked = _SharedBox()
            racewitness.track(tracked, ("x",), "tracked")
            free = _SharedBox()
            self._hammer(free)
            assert racewitness.reports() == []
        finally:
            racewitness.clear()
            racewitness.uninstall()

    def test_track_is_noop_while_disarmed(self):
        box = _SharedBox()
        racewitness.track(box, ("x",), "box")
        self._hammer(box)
        assert racewitness.reports() == []
        assert not racewitness.installed()

    def test_uninstall_restores_factories_and_attributes(self):
        raw = threading.Lock
        racewitness.install()
        box = _SharedBox()
        racewitness.track(box, ("x",), "box")
        box.x = 41
        racewitness.uninstall()
        assert threading.Lock is raw
        assert box.x == 41
        box.x += 1
        assert box.x == 42

    def test_package_locks_are_tracked_and_others_raw(self):
        """Only the port's own modules get held-set-tracking locks: a
        lock built here (a test module) stays raw, one the port builds is
        a LocksetLock, and race_track registers through sys.modules."""
        from parameter_server_tpu_torch.filters.keycache import ClientKeyCache

        racewitness.install()
        try:
            assert not isinstance(threading.Lock(), racewitness.LocksetLock)
            kc = ClientKeyCache()
            assert isinstance(kc._lock, racewitness.LocksetLock)
            assert kc.__dict__.get(racewitness._MARKER) == "ClientKeyCache"
        finally:
            racewitness.clear()
            racewitness.uninstall()

    def test_composes_with_the_explorer_both_ways(self):
        """Armed together, each tool wraps a port lock whichever was armed
        first: the explorer's boundary proxy over the race witness's
        held-set proxy, or the other way round."""
        from parameter_server_tpu_torch.filters.keycache import ClientKeyCache

        for first, second in ((racewitness, explorer), (explorer, racewitness)):
            first.install()
            second.install()
            try:
                lk = ClientKeyCache()._lock
                outer = explorer.BoundaryLock if second is explorer else racewitness.LocksetLock
                inner = racewitness.LocksetLock if second is explorer else explorer.BoundaryLock
                assert isinstance(lk, outer)
                inner_lock = lk._psx_inner if second is explorer else lk._psr_inner
                assert isinstance(inner_lock, inner)
            finally:
                second.uninstall()
                first.uninstall()
                racewitness.clear()

    def test_armed_serving_chaos_coherence_reports_zero_races(self):
        """The acceptance run: the port's serving chaos-coherence test
        (read-your-writes + exactly-once under drop/disconnect/duplicate
        with caching ON, port server and port handle) under an armed race
        witness — the server's encode budget and ledger, the handle's
        residual, the client's window and the key cache's generation are
        lockset-checked at every access — witnessing ZERO races."""
        from test_torch_serving import TestServingChaosCoherence

        racewitness.install()
        try:
            TestServingChaosCoherence().test_read_your_writes_and_exactly_once_under_chaos(
                "torch", "torch")
            tracked = {st.name.split(":")[0] for st in racewitness._fields.values()}
            assert {"ShardServer", "ServerHandle", "RpcClient", "ClientKeyCache"} <= tracked
            racewitness.assert_no_races()
        finally:
            racewitness.clear()
            racewitness.uninstall()


def test_race_armed_cluster_reports_zero_races(tmp_path):
    """An armed parent exports ``PS_RACE_WITNESS`` to every node
    ``launch_local`` spawns: each node runs armed (its report carries the
    race witness's), the server and the worker track their shared objects,
    and no node reports a race (no ``[racewitness]`` line in any log)."""
    from parameter_server_tpu.data.synthetic import make_sparse_logistic, write_libsvm
    from parameter_server_tpu_torch.parallel import multislice as TM

    env: dict = {}
    TM._export_witness_env(env)
    assert racewitness.ENV_VAR not in env
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
    logs = tmp_path / "logs"
    racewitness.install()
    try:
        TM._export_witness_env(env)
        assert env[racewitness.ENV_VAR] == "1"
        out = TM.launch_local(str(app), 1, 1, device="cpu", timeout=120, log_dir=str(logs))
    finally:
        racewitness.clear()
        racewitness.uninstall()
    assert out["workloads"]["done"] == 2
    reps = {tag: n.get("race_witness") for tag, n in out["nodes"].items()}
    reps["scheduler-0"] = out.get("race_witness")
    assert all(r is not None and r["races"] == 0 for r in reps.values()), reps
    assert {"ShardServer", "RpcClient"} <= set(reps["server-0"]["classes"]) | set(
        reps["worker-0"]["classes"])
    assert "ServerHandle" in reps["worker-0"]["classes"]
    hits = [p.name for p in logs.iterdir() if "[racewitness]" in p.read_text()]
    assert hits == []


# ---------------------------------------------------------------------------
# cli check + the seed corpus (cli explore's storage)
# ---------------------------------------------------------------------------


class TestCheckCli:
    def _main(self, argv):
        from parameter_server_tpu_torch.analysis.__main__ import check_main

        return check_main(argv)

    def test_tier1_bounded_run_verifies_everything(self, capsys):
        assert self._main([]) == 0
        out = capsys.readouterr().out
        for name in SPECS:
            assert name in out
        assert "verified" in out
        assert "0 conformance drift" in out

    def test_json_summary_shape(self, capsys):
        assert cli.main(["check", "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["ok"] is True and doc["conformance"] == []
        assert {r["spec"] for r in doc["specs"]} == set(SPECS)
        assert all(r["complete"] and r["ok"] for r in doc["specs"])

    def test_state_cap_fails_verification(self, capsys):
        assert cli.main(["check", "--spec", "exactly-once", "--max-states", "50",
                         "--no-conformance"]) == 1
        assert "INCOMPLETE" in capsys.readouterr().out

    @pytest.mark.parametrize(
        "name,bug", [(n, b) for n in sorted(SPECS) for b in SPECS[n].BUGS])
    def test_bug_mode_demands_a_counterexample(self, name, bug, capsys):
        assert cli.main(["check", "--spec", name, "--bug", bug, "--json"]) == 0
        doc = json.loads(capsys.readouterr().out)
        assert doc["caught"] is True and doc["bug"] == bug

    def test_bug_mode_requires_exactly_one_spec(self):
        with pytest.raises(SystemExit):
            self._main(["--bug", "no-dedup"])
        with pytest.raises(SystemExit):
            cli.main(["check", "--spec", "rcu", "--bug", "no-dedup"])


class TestSeedCorpus:
    def test_record_and_load_roundtrip(self, tmp_path):
        p = str(tmp_path / "corpus.json")
        assert explorer.load_corpus(p) == {}
        explorer.record_failing_seeds(p, "t::a", [5, 3])
        explorer.record_failing_seeds(p, "t::a", [5, 9])
        explorer.record_failing_seeds(p, "t::b", [1])
        assert explorer.corpus_seeds(p, "t::a") == [3, 5, 9]
        assert explorer.corpus_seeds(p, "t::b") == [1]
        assert explorer.corpus_seeds(p, "t::missing") == []

    def test_foreign_or_torn_corpus_reads_empty(self, tmp_path):
        p = tmp_path / "corpus.json"
        p.write_text("{not json")
        assert explorer.load_corpus(str(p)) == {}
        p.write_text('{"schema": "other/1", "tests": {"t": [1]}}')
        assert explorer.load_corpus(str(p)) == {}

    def test_record_refuses_to_clobber_a_foreign_or_torn_corpus(self, tmp_path):
        for body in ("{not json", '{"schema": "pssched/2", "tests": {"t::x": [7]}}'):
            p = tmp_path / "corpus.json"
            p.write_text(body)
            with pytest.raises(RuntimeError, match="refusing"):
                explorer.record_failing_seeds(str(p), "t::a", [1])
            assert p.read_text() == body
        p.write_text('{"schema": "pssched/1", "tests": {}}')
        explorer.record_failing_seeds(str(p), "t::a", [1])
        assert explorer.corpus_seeds(str(p), "t::a") == [1]

    def test_search_seeds_budget_and_failures(self):
        results = []
        failing = explorer.search_seeds(
            "t::x", budget=6, start_seed=1, runner=lambda seed: seed not in (3, 5),
            on_result=lambda s, ok: results.append((s, ok)),
        )
        assert failing == [3, 5]
        assert results == [(1, True), (2, True), (3, False), (4, True), (5, False), (6, True)]

    def test_infra_break_preserves_finds_so_far(self):
        def runner(seed):
            if seed == 4:
                raise RuntimeError("pytest could not run")
            return seed != 2

        with pytest.raises(explorer.SearchError) as ei:
            explorer.search_seeds("t::x", budget=10, runner=runner)
        assert ei.value.seed == 4
        assert ei.value.failing == [2]

    def test_committed_corpus_parses_and_names_the_coherence_test(self):
        corpus = explorer.load_corpus(str(ROOT / "tests" / "torch_sched_corpus.json"))
        assert COHERENCE_NODE in corpus
