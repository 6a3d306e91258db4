"""The port's telemetry plane (``parameter_server_tpu_torch/utils/metrics.py``)
against the JAX package's on the same inputs: histograms and their
exemplars, the cluster merges, slowest-op records, named timers, the
per-range series, the per-key heat sketch, the snapshot's shape, the
dashboard text, and ``cli stats`` against a port coordinator."""

import json
import threading
import time

import numpy as np
import pytest
import torch

from parameter_server_tpu import cli as JC
from parameter_server_tpu.parallel import control as JCTL
from parameter_server_tpu.parallel import ssp as JSSP
from parameter_server_tpu.utils import metrics as JM
from parameter_server_tpu_torch import cli as TC
from parameter_server_tpu_torch.parallel import control as TCTL
from parameter_server_tpu_torch.parallel import ssp as TSSP
from parameter_server_tpu_torch.utils import metrics as TM

torch.set_num_threads(1)

BOTH = (JM, TM)


@pytest.fixture
def clean():
    """Both packages' process-global registries, emptied before and after
    (other tests in this process feed them too)."""
    def reset():
        for m in BOTH:
            m.wire_counters.reset()
            m.latency_histograms.reset()
            m.timers.reset()
            m.slow_ops.reset()
            m.key_heat.reset()
    reset()
    yield
    reset()


def _durations(seed: int, n: int = 200) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.exp(rng.uniform(np.log(1e-7), np.log(30.0), n))


class TestHistogramParity:
    @pytest.mark.parametrize("seed", [0, 1, 2])
    def test_same_observations_same_snapshot(self, seed):
        hs = [m.Histogram() for m in BOTH]
        for i, v in enumerate(_durations(seed)):
            for h in hs:
                h.observe(float(v), exemplar=f"t{i}" if i % 7 == 0 else None)
        j, t = (h.snapshot() for h in hs)
        ts_j, ts_t = j["ex"].pop("ts"), t["ex"].pop("ts")
        assert j == t and abs(ts_j - ts_t) < 5.0
        for p in (0.0, 0.5, 0.9, 0.99, 1.0):
            assert JM.hist_percentile(j, p) == TM.hist_percentile(t, p)
            assert hs[0].percentile(p) == hs[1].percentile(p)

    def test_roll_exemplar_consumes_the_window(self):
        for m in BOTH:
            h = m.Histogram()
            h.observe(0.5, exemplar="slow")
            h.observe(0.1, exemplar="fast")
            assert h.snapshot()["ex"]["tid"] == "slow"  # observe-only read
            assert h.snapshot(roll_exemplar=True)["ex"]["tid"] == "slow"
            assert "ex" not in h.snapshot()

    def test_empty_and_zero(self):
        for m in BOTH:
            h = m.Histogram()
            assert h.snapshot() == {"count": 0, "sum_s": 0.0, "buckets": {}}
            h.observe(0.0)
            h.observe(-1.0)
        assert JM.Histogram().snapshot() == TM.Histogram().snapshot()

    @pytest.mark.parametrize("seed", [3, 4])
    def test_merge_is_bucketwise_exact_and_equal(self, seed):
        snaps = {}
        for m in BOTH:
            parts = []
            for k, v in enumerate(np.array_split(_durations(seed, 120), 3)):
                h = m.Histogram()
                for i, x in enumerate(v):
                    h.observe(float(x), exemplar=f"n{k}-{i}")
                parts.append(h.snapshot())
            snaps[m] = m.merge_hist_snapshots(parts)
        j, t = snaps[JM], snaps[TM]
        j["ex"].pop("ts"), t["ex"].pop("ts")
        assert j == t and j["count"] == 120
        # the merge of the port's parts is the JAX merge of the same parts
        assert JM.merge_hist_snapshots([t]) == TM.merge_hist_snapshots([t])

    def test_histogram_set_named_and_observe_scalar(self, clean):
        for m in BOTH:
            m.latency_histograms.observe("client.push", 0.002, exemplar="a")
            m.latency_histograms.observe("server.push", 0.0001)
            m.observe_scalar("server.apply_batch.n", 17)
        j = JM.latency_histograms.snapshot(roll_exemplars=True)
        t = TM.latency_histograms.snapshot(roll_exemplars=True)
        j["client.push"]["ex"].pop("ts"), t["client.push"]["ex"].pop("ts")
        assert j == t
        assert TM.hist_percentile(t["server.apply_batch.n"], 0.5) * 1e6 >= 17
        assert "ex" not in TM.latency_histograms.snapshot()["client.push"]

    def test_concurrent_observe(self):
        h = TM.Histogram()

        def feed():
            for _ in range(500):
                h.observe(0.001)

        ths = [threading.Thread(target=feed) for _ in range(4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        assert h.snapshot()["count"] == 2000


class TestSlowOpsParity:
    def test_same_completions_same_records(self, monkeypatch):
        monkeypatch.setattr(time, "time", lambda: 1000.0)
        ops = [m.SlowOps(k=3, window_s=60.0) for m in BOTH]
        rng = np.random.default_rng(5)
        for i in range(20):
            dur = float(rng.uniform(0.001, 0.05))
            kw = dict(svc_us=dur * 4e5, apw_us=dur * 1e5, apl_us=dur * 5e4,
                      tid=f"t{i}") if i % 2 else {}
            for o in ops:
                o.observe("push" if i % 3 else "pull", dur, **kw)
        j, t = (o.snapshot() for o in ops)
        assert j == t and len(t["push"]) == 3
        assert JM.merge_slow_ops([j, t], k=4) == TM.merge_slow_ops([j, t], k=4)

    def test_expiry_and_stale_giants(self, monkeypatch):
        now = [100.0]
        monkeypatch.setattr(time, "time", lambda: now[0])
        for m in BOTH:
            o = m.SlowOps(k=2, window_s=10.0)
            o.observe("push", 5.0)
            o.observe("push", 4.0)
            now[0] = 200.0
            o.observe("push", 0.001)  # the giants expired: a live record fits
            assert [r["dur_ms"] for r in o.snapshot()["push"]] == [1.0]
            now[0] = 100.0

    def test_rpc_completion_feeds_the_global_records(self, clean):
        """A port client's completion books ``client.<cmd>`` and a slow-op
        record split by the server's echo, as the JAX client does."""
        coord = TCTL.Coordinator()
        try:
            c = TCTL.ControlClient(coord.address)
            c.register("worker", rank=0)
            c.nodes()
            c.close()
        finally:
            coord.stop()
        hists = TM.latency_histograms.snapshot()
        assert hists["client.register"]["count"] == 1
        assert hists["server.register"]["count"] == 1
        rec = TM.slow_ops.snapshot()["register"][0]
        assert set(rec["seg"]) == {"wire", "server"}


class TestTimersParity:
    def test_timer_totals_equal_under_injected_clock(self, monkeypatch, clean):
        ticks = iter(np.arange(0.0, 100.0, 0.25).tolist())
        monkeypatch.setattr(time, "perf_counter", lambda: next(ticks))
        for m in BOTH:
            for name in ("trainer.fetch", "trainer.dispatch", "trainer.fetch"):
                with m.timers.timer(name):
                    pass
        assert JM.timers.snapshot() == TM.timers.snapshot() == {
            "trainer.fetch": {"total_s": 0.5, "count": 2},
            "trainer.dispatch": {"total_s": 0.25, "count": 1},
        }

    def test_tic_toc_from_many_threads(self):
        t = TM.Timer()

        def work():
            for _ in range(50):
                t.tic()
                t.toc()

        ths = [threading.Thread(target=work) for _ in range(4)]
        for th in ths:
            th.start()
        for th in ths:
            th.join()
        assert t.snapshot()["count"] == 200

    def test_toc_without_tic_still_asserts(self):
        with pytest.raises(AssertionError):
            TM.Timer().toc()


class TestRangeScopeParity:
    def test_same_bookings_same_series(self, clean):
        for m in BOTH:
            for b, e in ((0, 100), (100, 250)):
                rs = m.RangeScope(b, e)
                rs.push(3, 1200)
                rs.pull(64)
                rs.pull(0)
                rs.apply(0.0021)
                rs.age(0.5)
                rs.age(-1.0)  # clamped to 0
        assert JM.wire_counters.snapshot() == TM.wire_counters.snapshot()
        assert JM.latency_histograms.snapshot() == TM.latency_histograms.snapshot()
        tel = TM.telemetry_snapshot()
        assert TM.known_ranges(tel) == JM.known_ranges(tel) == [(0, 100), (100, 250)]
        assert TM.owning_range(120, [(0, 100), (100, 250)]) == (1, (100, 250))
        assert TM.owning_range(300, [(0, 100)]) is None

    @pytest.mark.parametrize("name", [
        "range.0-10.push", "range.other.age", "range.0-10", "wire_bytes_out",
        "range..x",
    ])
    def test_split_range_series(self, name):
        assert TM.split_range_series(name) == JM.split_range_series(name)


class TestKeyHeatParity:
    @pytest.mark.parametrize("seed,n", [(0, 500), (1, 5000), (2, 40000)])
    def test_same_keys_same_sketch(self, seed, n):
        rng = np.random.default_rng(seed)
        keys = rng.zipf(1.3, n).astype(np.int64) % 100_000
        sks = [m.KeyHeatSketch() for m in BOTH]
        for chunk in np.array_split(keys, 7):
            for s in sks:
                s.add(chunk)
        j, t = (s.snapshot() for s in sks)
        assert j == t
        probe = np.unique(keys)[:50]
        np.testing.assert_array_equal(sks[0].count(probe), sks[1].count(probe))
        assert JM.heat_top(j, 10) == TM.heat_top(t, 10)
        assert JM.merge_heat_snapshots([j, t]) == TM.merge_heat_snapshots([j, t])

    @pytest.mark.parametrize("seed", range(16))
    def test_candidate_list_equals_jax_in_order(self, seed):
        """The hot-candidate list after any history of adds is the JAX
        sketch's, entry for entry and in order: batches past the cap (a
        server push's ~16k uniform keys), tied estimates, repeated keys,
        sorted and unsorted batches, and small ones."""
        rng = np.random.default_rng(seed)
        kw = dict(width=int(rng.choice([4, 16, 64, 1024])), depth=int(rng.integers(1, 3)),
                  hot_min=int(rng.integers(1, 10)), hot_cap=int(rng.choice([1, 2, 8, 64])))
        sks = [m.KeyHeatSketch(**kw) for m in BOTH]
        for _ in range(10):
            n = int(rng.choice([1, 2, 5, 100, 3000, 16500]))
            keys = [rng.integers(0, 1 << 26, n), rng.zipf(1.3, n) % 5000,
                    rng.integers(0, 50, n), np.repeat(rng.integers(0, 300, max(n // 3, 1)), 3),
                    ][int(rng.integers(0, 4))].astype(np.int64)
            r = rng.random()
            if r < 0.4:
                keys = np.unique(keys)
            elif r < 0.6:
                keys = np.sort(keys)
            for s in sks:
                s.add(keys)
            assert list(sks[1]._hot.items()) == list(sks[0]._hot.items())
        assert sks[1].snapshot() == sks[0].snapshot()

    def test_never_under_counts(self):
        sk = TM.KeyHeatSketch(width=64, depth=2)
        keys = np.arange(1000, dtype=np.int64)
        sk.add(keys)
        sk.add(keys[:10])
        assert (sk.count(keys[:10]) >= 2).all()


class TestSnapshotAndMerge:
    def test_snapshot_keys_equal_jax(self, clean):
        for m in BOTH:
            m.wire_counters.inc("pushes", 3)
            m.latency_histograms.observe("client.push", 0.001)
            with m.timers.timer("trainer.fetch"):
                pass
            m.key_heat.add(np.arange(10, dtype=np.int64))
            m.slow_ops.observe("push", 0.01, svc_us=5000)
        j, t = JM.telemetry_snapshot(), TM.telemetry_snapshot()
        assert set(j) == set(t) == {"counters", "hists", "timers", "key_heat", "slow"}
        assert j["counters"] == t["counters"] and j["key_heat"] == t["key_heat"]
        assert set(j["hists"]) == set(t["hists"])
        json.dumps(t)

    def test_merge_telemetry_equal(self):
        a = {
            "counters": {"x": 1, "y": 2, "rpc_inflight_peak": 8},
            "hists": {"client.push": {"count": 2, "sum_s": 0.2, "buckets": {"10": 2}}},
            "timers": {"t": {"total_s": 1.0, "count": 3}},
            "key_heat": {"w": 4, "d": 1, "n": 2, "hot": {"5": 2}, "rows": [{"1": 2}]},
            "slow": {"push": [{"cmd": "push", "dur_ms": 3.0, "ts": 1.0}]},
            "prof": [{"s": "a;b", "n": 3}],
        }
        b = {
            "counters": {"x": 5, "rpc_inflight_peak": 3},
            "hists": {"client.push": {"count": 1, "sum_s": 0.1, "buckets": {"12": 1}},
                      "server.pull": {"count": 1, "sum_s": 0.0, "buckets": {"3": 1}}},
            "timers": {"t": {"total_s": 0.5, "count": 1}},
            "prof": [{"s": "a;b", "n": 1}, {"s": "c", "n": 9}],
        }
        m = TM.merge_telemetry([a, b])
        assert m == JM.merge_telemetry([a, b])
        assert m["counters"] == {"x": 6, "y": 2, "rpc_inflight_peak": 8}
        assert m["timers"]["t"] == {"total_s": 1.5, "count": 4}
        assert m["prof"] == [{"s": "c", "n": 9}, {"s": "a;b", "n": 4}]

    def test_format_texts_equal(self):
        hists = {"client.push": {"count": 4, "sum_s": 0.004, "buckets": {"10": 4}},
                 "server.push": {"count": 2, "sum_s": 0.0001, "buckets": {"7": 2}}}
        rep = {
            "nodes": {
                "1": {"role": "worker", "rank": 0, "stats": {"max_rss_mb": 12.0},
                      "telemetry": {"counters": {"wire_bytes_out": 7}}},
                "2": {"role": "server", "rank": 1, "stats": {},
                      "telemetry": {"counters": {"rpc_retries": 2}}},
            },
            "merged": {
                "counters": {"wire_bytes_out": 7, "range.0-50.push": 3},
                "hists": hists,
                "key_heat": {"w": 8, "d": 1, "n": 9, "hot": {"12": 9},
                             "rows": [{"4": 9}]},
            },
        }
        assert TM.format_latency_table(hists) == JM.format_latency_table(hists)
        out = TM.format_cluster_stats(rep)
        assert out == JM.format_cluster_stats(rep)
        assert "range 0-50 @ server 0" in out and "client.push" in out


class TestSspLiveSignals:
    def test_open_gate_lag_series_equal(self, clean):
        for ssp in (JSSP, TSSP):
            clock = ssp.SSPClock(num_workers=2, max_delay=2)
            for w in (0, 1):
                clock.finish(w, 0)
            for step in (1, 2, 3):
                assert clock.wait(0, step, timeout=1.0)
        j = JM.latency_histograms.snapshot()["ssp.lag_clocks.n"]
        t = TM.latency_histograms.snapshot()["ssp.lag_clocks.n"]
        assert j == t and t["count"] == 3

    def test_blocked_time_books_the_counter(self, clean):
        clock = TSSP.SSPClock(num_workers=2, max_delay=0)
        clock.finish(0, 0)
        t = threading.Timer(0.05, lambda: clock.finish(1, 0))
        t.start()
        assert clock.wait(0, 1, timeout=5.0)
        t.join()
        assert TM.wire_counters.get("ssp_blocked_ms") >= 30
        assert clock.progress()["blocked_n"] == [1, 0]


class TestCoordinatorTelemetry:
    def test_beats_piggyback_and_merge(self, clean):
        coord = TCTL.Coordinator()
        try:
            c = TCTL.ControlClient(coord.address)
            nid = c.register("worker", rank=0)
            c.beat(nid, {
                "max_rss_mb": 5.0,
                "telemetry": {
                    "counters": {"pulls": 11, "wire_bytes_out": 100},
                    "hists": {"client.pull": {"count": 3, "sum_s": 0.3,
                                              "buckets": {"17": 3}}},
                    "timers": {},
                },
            })
            rep = c.telemetry()
            node = rep["nodes"][str(nid)]
            assert node["role"] == "worker" and node["stats"]["max_rss_mb"] == 5.0
            merged = rep["merged"]
            assert merged["counters"]["pulls"] == 11
            assert merged["hists"]["client.pull"]["count"] >= 3
            assert merged["counters"]["wire_bytes_out"] > 100  # node + local
            c.close()
        finally:
            coord.stop()


@pytest.mark.parametrize("cli_pkg", ["torch", "jax"])
def test_cli_stats_against_a_port_coordinator(cli_pkg, capsys, clean):
    """Either package's ``cli stats`` prints the same dashboard for a port
    coordinator's reply."""
    coord = TCTL.Coordinator()
    try:
        c = TCTL.ControlClient(coord.address)
        nid = c.register("server", rank=1)
        c.beat(nid, {
            "max_rss_mb": 3.0,
            "telemetry": {
                "counters": {"pushes": 4},
                "hists": {"server.push": {"count": 4, "sum_s": 0.004,
                                          "buckets": {"10": 4}}},
                "timers": {},
            },
        })
        cli = TC if cli_pkg == "torch" else JC
        assert cli.main(["stats", "--scheduler", coord.address]) == 0
        out = capsys.readouterr().out
        assert "per-command latency" in out and "server.push" in out
        last = json.loads(out.strip().splitlines()[-1])
        assert last["nodes"] == 1 and last["counters"]["pushes"] == 4
        assert last["latency_ms"]["server.push"]["count"] >= 4
        rep = c.telemetry()
        assert TM.format_cluster_stats(rep) == JM.format_cluster_stats(rep)
        # the JAX client reads the same reply blocks from the port coordinator
        jc = JCTL.ControlClient(coord.address)
        assert set(jc.telemetry()) == set(rep)
        jc.close()
        c.close()
    finally:
        coord.stop()
