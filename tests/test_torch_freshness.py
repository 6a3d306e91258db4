"""The port's freshness plane against the JAX package's: a server's
per-range traffic matrix (``RangeScope``) and key heat on the same
traffic, the serve-age histograms a serving handle books (wire pull,
cache hit, revalidation, shed-stale fallback), ``skew_clamped_age_s``,
the bounded range series on the beat and the scrape, and ``ranges_view``
/ ``format_ranges`` / ``format_top`` on the same reply."""

from __future__ import annotations

import time

import numpy as np
import pytest
import torch

from parameter_server_tpu.kv import updaters as JU
from parameter_server_tpu.parallel import multislice as JMS
from parameter_server_tpu.utils import clock as JCLK
from parameter_server_tpu.utils import config as JCFG
from parameter_server_tpu.utils import keyrange as JK
from parameter_server_tpu.utils import metrics as JM
from parameter_server_tpu.utils import slo as JS
from parameter_server_tpu.utils import timeseries as JT
from parameter_server_tpu_torch.kv import updaters as TU
from parameter_server_tpu_torch.parallel import multislice as TMS
from parameter_server_tpu_torch.utils import clock as TCLK
from parameter_server_tpu_torch.utils import config as TCFG
from parameter_server_tpu_torch.utils import flightrec as TF
from parameter_server_tpu_torch.utils import keyrange as TK
from parameter_server_tpu_torch.utils import metrics as TM
from parameter_server_tpu_torch.utils import slo as TS
from parameter_server_tpu_torch.utils import timeseries as TT

torch.set_num_threads(1)

KEYS = np.arange(1, 9, dtype=np.int64)


@pytest.fixture(autouse=True)
def _fresh_metrics():
    def reset():
        for m in (JM, TM):
            m.wire_counters.reset()
            m.latency_histograms.reset()
            m.key_heat.reset()
    reset()
    yield
    reset()


def _serve_cfg(mod, **kw):
    base = dict(cache=True, ttl_ms=10_000, max_stale_ms=60_000,
                hot_min_pulls=1, encode_cache_entries=64)
    base.update(kw)
    return mod.ServeConfig(**base)


def _port_server(begin=0, end=256, **serve):
    return TMS.ShardServer(TU.Sgd(eta=1.0), TK.KeyRange(begin, end),
                           serve_cfg=_serve_cfg(TCFG, **serve), device="cpu").start()


def _port_handle(srv, serving=True, worker=0, **serve):
    cfg = TCFG.PSConfig()
    cfg.serve = _serve_cfg(TCFG, **serve)
    return TMS.ServerHandle(srv.address, 0, worker, cfg, range_size=srv.range.size,
                            serving=serving, device="cpu",
                            key_range=srv.range if serving else None)


class TestClock:
    @pytest.mark.parametrize("pts_offset_us", [-5e6, -1.0, 0.0, 2.5e5, 7e6])
    def test_skew_clamped_age_equals_jax(self, pts_offset_us, monkeypatch):
        monkeypatch.setattr(time, "time", lambda: 1_700_000_000.25)
        pts = 1_700_000_000.25e6 + pts_offset_us
        assert TCLK.skew_clamped_age_s(pts) == JCLK.skew_clamped_age_s(pts)
        assert TCLK.skew_clamped_age_s(pts) >= 0.0
        assert TCLK.now_wall_us() == JCLK.now_wall_us()


class TestServerRangeMatrix:
    def test_same_traffic_same_range_series_and_heat(self):
        """A port server and a JAX server of one range take the same pushes
        and pulls: the same range counters, the same key heat and the
        same apply/age series names."""
        rng = np.random.default_rng(4)
        rounds = [(np.unique(rng.integers(0, 200, 12)).astype(np.int64),) for _ in range(6)]
        servers = [
            JMS.ShardServer(JU.Sgd(eta=0.5), JK.KeyRange(100, 300)).start(),
            TMS.ShardServer(TU.Sgd(eta=0.5), TK.KeyRange(100, 300), device="cpu").start(),
        ]
        handles = [
            JMS.ServerHandle(servers[0].address, 0, 0, JCFG.PSConfig(), range_size=200),
            TMS.ServerHandle(servers[1].address, 0, 0, TCFG.PSConfig(), range_size=200,
                             device="cpu"),
        ]
        try:
            for (keys,) in rounds:
                g = np.linspace(-1, 1, len(keys)).astype(np.float32)
                for h in handles:
                    h.pull(keys)
                    h.push(keys, g)
            pulled = [h.pull(rounds[0][0]) for h in handles]
        finally:
            for h in handles:
                h.shutdown()
            servers[1].join(timeout=30)  # the port's apply thread books the heat
        np.testing.assert_allclose(pulled[1].ravel(), pulled[0].ravel(), rtol=1e-6)
        jc, tc = JM.wire_counters.snapshot(), TM.wire_counters.snapshot()
        rng_keys = sorted(k for k in tc if k.startswith("range."))
        assert rng_keys == sorted(k for k in jc if k.startswith("range."))
        assert rng_keys == ["range.100-300.pull", "range.100-300.pull_bytes",
                            "range.100-300.push", "range.100-300.push_bytes"]
        for k in rng_keys:
            assert tc[k] == jc[k], k
        assert TM.key_heat.snapshot() == JM.key_heat.snapshot()
        th, jh = TM.latency_histograms.snapshot(), JM.latency_histograms.snapshot()
        for name in ("range.100-300.apply", "range.100-300.age", "server.apply_batch.n",
                     "server.apply_queue.n"):
            assert th[name]["count"] == jh[name]["count"], name
        assert th["range.100-300.apply"]["sum_s"] > 0  # host time of the apply

    def test_serial_path_books_the_push(self):
        srv = TMS.ShardServer(TU.Sgd(eta=1.0), TK.KeyRange(0, 64), device="cpu",
                              server_cfg=TCFG.ServerConfig(apply_queue=0)).start()
        h = TMS.ServerHandle(srv.address, 0, 0, TCFG.PSConfig(), range_size=64,
                             device="cpu")
        try:
            h.push(KEYS, np.ones(8, np.float32))
        finally:
            h.shutdown()
        c = TM.wire_counters.snapshot()
        assert c["range.0-64.push"] == 1 and c["range.0-64.push_bytes"] == 32


class TestServeAge:
    def test_pull_books_the_global_and_range_age(self):
        srv = _port_server()
        h = _port_handle(srv)
        try:
            time.sleep(0.06)  # let the seed publish age
            h.pull(KEYS)
            snap = TM.latency_histograms.snapshot()
            assert snap["serve.age_s"]["count"] >= 1
            assert snap["range.0-256.age"]["count"] >= 1
            assert 0.02 <= TM.hist_percentile(snap["serve.age_s"], 1.0) <= 5.0
        finally:
            h.shutdown()

    def test_cached_and_revalidated_serves_book_growing_age(self):
        # the cache hit under a TTL far above any scheduling stall
        srv = _port_server(ttl_ms=60_000)
        h = _port_handle(srv, ttl_ms=60_000)
        try:
            h.pull(KEYS)  # wire fill
            h.pull(KEYS)  # a cache hit: a local serve, still aged
            assert TM.wire_counters.get("serve_cache_hits") == 1
            c0 = TM.latency_histograms.snapshot()["serve.age_s"]["count"]
            assert c0 >= 2
        finally:
            h.shutdown()
        # the revalidation wants an expired entry: a short TTL
        srv = _port_server(ttl_ms=40)
        h = _port_handle(srv, ttl_ms=40)
        try:
            h.pull(KEYS)  # wire fill
            time.sleep(0.06)  # past the TTL: the next pull revalidates
            h.pull(KEYS)
            assert TM.wire_counters.get("serve_cache_validates") >= 1
            assert TM.latency_histograms.snapshot()["serve.age_s"]["count"] >= c0 + 2
        finally:
            h.shutdown()

    def test_shed_stale_serve_books_its_realized_age(self, tmp_path):
        TF.configure(str(tmp_path / "box"), process_name="worker-0",
                     flush_interval_s=0, watchdog_interval_s=3600)
        srv = _port_server(ttl_ms=5, max_stale_ms=10_000)
        h = _port_handle(srv, ttl_ms=5, max_stale_ms=10_000)
        writer = _port_handle(srv, serving=False, worker=1)
        try:
            h.pull(KEYS)
            writer.push(KEYS, -np.ones(8, np.float32))  # the version moves
            srv.overloaded = lambda: True
            time.sleep(0.02)  # past the TTL, inside max_stale
            h.pull(KEYS)  # the server sheds; the cached rows serve
            assert TM.wire_counters.get("serve_shed_served") >= 1
            assert TM.latency_histograms.snapshot()["serve.age_s"]["count"] >= 2
            srcs = {e[3].get("src") for e in TF.events() if e[2] == "freshness.serve"}
            assert {"shed", "pull"} <= srcs
        finally:
            h.shutdown()
            writer.close()
            TF.configure(None)


class TestRangeSeriesBounds:
    @pytest.mark.parametrize("n_ranges", [3, 40, 10_000])
    def test_beat_fold_equal_jax(self, n_ranges):
        counters = {f"range.{i * 8}-{i * 8 + 8}.pull": i + 1 for i in range(n_ranges)}
        hists = {f"range.{i * 8}-{i * 8 + 8}.age": {"count": 1, "sum_s": 1e-3,
                                                    "buckets": {"10": 1}}
                 for i in range(n_ranges)}
        beats = []
        for m in (JT, TT):
            m.reset_local_ring()
            beats.append(m.beat_telemetry({"counters": dict(counters),
                                           "hists": dict(hists), "timers": {}}))
        assert beats[0] == beats[1]
        folded = max(n_ranges - TT.BEAT_MAX_RANGES, 0)
        assert beats[1].get("ranges_saturated", 0) == folded
        assert TM.wire_counters.get("range_label_saturated") == folded

    @pytest.mark.parametrize("n_ranges", [3, 40])
    def test_scrape_labels_equal_jax(self, n_ranges):
        snap = {"counters": {f"range.{i * 8}-{i * 8 + 8}.pull": 100 - i
                             for i in range(n_ranges)},
                "hists": {f"range.{i * 8}-{i * 8 + 8}.age": {
                    "count": 2, "sum_s": 0.01, "buckets": {"14": 2}}
                    for i in range(n_ranges)},
                "timers": {}}
        tt = TT.render_openmetrics(snap, proc="server-0")
        assert tt.replace('package="parameter_server_tpu_torch",', "") == \
            JT.render_openmetrics(snap, proc="server-0")
        assert ('range="other"' in tt) == (n_ranges > TT.OM_MAX_RANGE_LABELS)


def _rep():
    return {
        "nodes": {"1": {"role": "server", "rank": 0}, "2": {"role": "server", "rank": 1},
                  "3": {"role": "worker", "rank": 0}},
        "series": {
            "1": {"window_s": 5.0,
                  "rates": {"range.0-256.pull": 40.0, "range.0-256.pull_bytes": 4096.0,
                            "range.0-256.push": 12.0, "range.0-256.push_bytes": 960.0},
                  "hist_rates": {"server.pull": 40.0, "server.push": 12.0},
                  "p50": {"range.0-256.age": 12.0, "server.push": 0.4},
                  "p99": {"serve.age": 88.0, "range.0-256.age": 96.0,
                          "range.0-256.apply": 1.5, "server.push": 2.0}},
            "2": {"window_s": 5.0,
                  "rates": {"range.256-512.push": 7.0, "range.0-256.pull": 10.0},
                  "p99": {"range.256-512.apply": 0.7, "range.0-256.age": 200.0}},
            "3": {"window_s": 5.0, "rates": {"wire_bytes_out": 5e5},
                  "hist_rates": {"client.push": 19.0}, "p99": {"client.push": 3.1}},
        },
        "merged": {"counters": {}, "hists": {},
                   "key_heat": {"w": 8, "d": 1, "n": 9, "hot": {"300": 9},
                                "rows": [{"4": 9}]}},
        "slo": {"health": {"1": {"score": 100, "burning": []},
                           "2": {"score": 60, "burning": ["push_p99_ms"]}},
                "alerts": [{"rule": "push_p99_ms", "node": "2", "burn_short": 12.0,
                            "burn_long": 11.0, "value": 300.0, "threshold": 250.0}]},
        "audit": {"total": 0, "nodes": {}, "recent": [], "by_kind": {}},
    }


class TestFormatSurfaces:
    def test_ranges_view_equal_and_aggregated(self):
        view = TS.ranges_view(_rep(), 5.0)
        assert view == JS.ranges_view(_rep(), 5.0)
        d = view["ranges"]["0-256"]
        assert d["pull_rate"] == 50.0 and d["age_p99_ms"] == 200.0
        assert d["age_p50_ms"] == 12.0 and d["pull_bytes_rate"] == 4096.0
        assert set(view["ranges"]) >= {"0-256", "256-512"}

    @pytest.mark.parametrize("window", [5.0, 60.0])
    def test_texts_equal(self, window, monkeypatch):
        monkeypatch.setattr(time, "strftime", lambda fmt: "12:00:00")  # the frame's clock
        for fn in ("format_ranges", "format_top"):
            assert getattr(TS, fn)(_rep(), window) == getattr(JS, fn)(_rep(), window), fn
        assert "stalest serve" in TS.format_top(_rep(), window)

    def test_empty_window_renders_the_idle_line(self):
        assert "freshness plane idle" in TS.format_ranges({"series": {}}, 5.0)

    def test_legacy_age_series_still_lights_the_rule(self):
        rule = TS.parse_rule("pull_age_ms p99:serve.age <= 1000 target 0.9 burn 2")
        assert rule.series == "serve.age_s"
        reps = []
        for m, s in ((JT, JS), (TT, TS)):
            ring = m.TimeSeriesRing()
            for i in range(9):
                ring.observe({"counters": {}, "timers": {}, "hists": {"serve.age": {
                    "count": i * 5, "sum_s": i * 20.0, "buckets": {"22": i * 5}}}},
                    ts=float(i))
            eng = s.SloEngine([s.parse_rule(
                "pull_age_ms p99:serve.age <= 1000 target 0.9 burn 2")],
                short_window_s=4, long_window_s=8)
            reps.append(eng.evaluate({0: ring}, now=8.0))
        assert reps[0] == reps[1]
        assert [a["rule"] for a in reps[1]["alerts"]] == ["pull_age_ms"]
