"""The port's serving plane (``filters/keycache.py``, the versioned pull
path of ``parallel/multislice.py``) mirroring the JAX package's
``tests/test_serving.py``: the client key cache against the JAX one, the
server's versioned pulls (compared by equality only: versions are opaque),
the serving handle (fresh hits, exact self-invalidation, revalidation,
shared and rank-scoped caches, the training tier's bypass), the
single-flight encode cache, load shedding and coherence under a fault
plan. Interop: a JAX serving handle against a port server and a port
handle against a JAX server return the same rows and move the same
server counters (``not_modified``, ``shed``, ``pull_encodes``,
``encode_reuse``) as the JAX pair. F6: a version cached before a port
server restarts from its checkpoint does not validate after it. Every
server is shut down in a ``finally``."""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from parameter_server_tpu.filters.keycache import ClientKeyCache as JKC
from parameter_server_tpu.kv import updaters as JU
from parameter_server_tpu.parallel import chaos as JCH
from parameter_server_tpu.parallel import multislice as JM
from parameter_server_tpu.utils import config as JCFG
from parameter_server_tpu.utils import keyrange as JK
from parameter_server_tpu.utils.metrics import wire_counters as j_counters
from parameter_server_tpu_torch.filters.keycache import ClientKeyCache as TKC
from parameter_server_tpu_torch.kv import updaters as TU
from parameter_server_tpu_torch.parallel import chaos as TCH
from parameter_server_tpu_torch.parallel import multislice as TM
from parameter_server_tpu_torch.parallel.control import _encode_bin_header
from parameter_server_tpu_torch.utils import config as TCFG
from parameter_server_tpu_torch.utils import keyrange as TK
from parameter_server_tpu_torch.utils.metrics import wire_counters as t_counters

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
KEYS = np.arange(1, 9, dtype=np.int64)
OTHER = np.arange(20, 28, dtype=np.int64)
MODS = {"torch": (TM, TCFG, TK, TU, TCH), "jax": (JM, JCFG, JK, JU, JCH)}
COUNTERS = {"torch": t_counters, "jax": j_counters}
#: (server package, handle package): the port on at least one side
PAIRS = [("torch", "torch"), ("torch", "jax"), ("jax", "torch")]
SERVING_COUNTERS = ("pulls", "not_modified", "shed", "pull_encodes", "encode_reuse")


@pytest.fixture(autouse=True)
def _fresh_counters():
    t_counters.reset()
    j_counters.reset()
    yield
    t_counters.reset()
    j_counters.reset()


def _serve_kw(**kw) -> dict:
    return {"cache": True, "ttl_ms": 10_000, "max_stale_ms": 60_000,
            "hot_min_pulls": 1, "encode_cache_entries": 64, **kw}


def _server(pkg: str, begin: int = 0, size: int = 256, fault_plan=None, updater=None,
            **serve_kw):
    ms, cfgm, keyr, upd, chaos = MODS[pkg]
    kw = {"device": "cpu"} if pkg == "torch" else {}
    plan = chaos.FaultPlan.parse(*fault_plan) if fault_plan else None
    return ms.ShardServer(updater or upd.Sgd(eta=1.0), keyr.KeyRange(begin, begin + size),
                          serve_cfg=cfgm.ServeConfig(**_serve_kw(**serve_kw)),
                          fault_plan=plan, **kw).start()


def _handle(pkg: str, srv, worker: int = 0, serving: bool = True, rank: int = 0,
            key_cache=None, reconnect_timeout_s=None, **serve_kw):
    ms, cfgm = MODS[pkg][:2]
    cfg = cfgm.PSConfig()
    cfg.serve = cfgm.ServeConfig(**_serve_kw(**serve_kw))
    kw = {"device": "cpu"} if pkg == "torch" else {}
    return ms.ServerHandle(srv.address, rank, worker, cfg, range_size=srv.range.size,
                           serving=serving, key_cache=key_cache,
                           reconnect_timeout_s=reconnect_timeout_s, **kw)


@contextlib.contextmanager
def _served(srv, *handles):
    try:
        yield
    finally:
        try:
            handles[0].shutdown()
        finally:
            for h in handles:
                h.close()
            srv.server.stop()


# ---------------------------------------------------------------------------
# the client key cache
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("cls", [TKC, JKC], ids=["torch", "jax"])
class TestClientKeyCache:
    def test_ttl_and_revalidation_clocks(self, cls):
        kc = cls(cap=8, ttl_s=0.05, max_stale_s=0.2)
        kc.put("s", KEYS, np.ones((8, 1), np.float32), 7, now=100.0)
        ent = kc.lookup("s")
        assert kc.fresh(ent, now=100.04) and not kc.fresh(ent, now=100.06)
        assert kc.can_shed(ent, now=100.15) and not kc.can_shed(ent, now=100.25)
        kc.revalidated("s", 7, now=100.3)
        assert kc.fresh(ent, now=100.34) and kc.can_shed(ent, now=100.45)

    def test_exact_invalidation_lru_and_rank_scope(self, cls):
        kc = cls(cap=3, ttl_s=10.0, max_stale_s=10.0)
        kc.put((0, "a"), KEYS, np.ones((8, 1), np.float32), 1, rank=0)
        kc.put((0, "b"), OTHER, np.ones((8, 1), np.float32), 1, rank=0)
        kc.put((1, "a"), KEYS, np.ones((8, 1), np.float32), 1, rank=1)
        assert kc.invalidate_keys(np.array([5, 99]), rank=0) == 1
        assert kc.lookup((0, "a")) is None and kc.lookup((1, "a")) is not None
        assert kc.invalidate_keys(np.array([1000])) == 0
        for i in range(4):
            kc.put((2, f"c{i}"), KEYS + 100 * i, np.zeros((8, 1), np.float32), 1)
        assert len(kc) == 3 and kc.invalidate_keys(OTHER, rank=0) == 0
        with pytest.raises(ValueError, match="composite sig"):
            kc.put((0, "x"), KEYS, np.zeros((8, 1), np.float32), 1, rank=1)

    def test_put_loses_to_concurrent_invalidation_and_owns_buffers(self, cls):
        kc = cls(cap=8, ttl_s=10.0, max_stale_s=10.0)
        gen = kc.gen
        kc.invalidate_keys(KEYS)  # drops nothing, still bumps the generation
        assert kc.put("s", KEYS, np.ones((8, 1), np.float32), 1, as_of=gen) is None
        vals = np.ones((8, 1), np.float32)
        assert kc.put("s", KEYS, vals, 1, as_of=kc.gen) is not None
        vals[:] = 9.0
        assert float(kc.lookup("s").values[0, 0]) == 1.0
        assert kc.begin_refresh("s") and not kc.begin_refresh("s")
        kc.end_refresh("s")
        kc.end_refresh("s")
        assert kc.begin_refresh("s")
        kc.shed_backoff("s", retry_after_s=60.0)
        ent = kc.lookup("s")
        assert ent.expires_at <= ent.filled_at + 10.0


# ---------------------------------------------------------------------------
# the server's versioned pulls
# ---------------------------------------------------------------------------


def _raw(h, **fields):
    return h.client.call("pull", arrays={"keys": KEYS.astype(np.uint32)}, worker=h.worker,
                         sig=TM._sig(KEYS), zip=False, **fields)


class TestVersionedPull:
    @pytest.mark.parametrize("cli_pkg", ["torch", "jax"])
    def test_pull_reply_carries_version_and_push_moves_it(self, cli_pkg):
        srv = _server("torch")
        h = _handle(cli_pkg, srv, serving=False)
        with _served(srv, h):
            rep, _ = _raw(h, sv=1)
            v0 = rep["ver"]
            assert v0 == srv.version and rep["pts"] > 0 and rep["_age_us"] >= 0
            h.push(KEYS, np.ones(8, np.float32))
            assert _raw(h, sv=1)[0]["ver"] != v0
            # a pull without the sv signal gets the reply shape without it
            assert "ver" not in _raw(h)[0]

    def test_version_fits_the_binary_slot(self):
        """The per-life nonce is masked so every version fits the binary
        header's unsigned fixed slot (version 2 of the header)."""
        for _ in range(8):
            srv = TM.ShardServer(TU.Sgd(eta=1.0), TK.KeyRange(0, 4), device="cpu")
            assert 0 < srv.version < (1 << 63)
            b = _encode_bin_header({"ok": True, "ver": srv.version}, [])
            assert b is not None and b[1] == 2
            srv.server.stop()

    def test_versions_differ_across_lives(self):
        lives = [TM.ShardServer(TU.Sgd(), TK.KeyRange(0, 4), device="cpu") for _ in range(4)]
        assert len({s.version for s in lives}) == 4
        for s in lives:
            s.server.stop()

    @pytest.mark.parametrize("srv_pkg,cli_pkg", PAIRS)
    def test_if_newer_equality_semantics(self, srv_pkg, cli_pkg):
        srv = _server(srv_pkg)
        h = _handle(cli_pkg, srv, serving=False)
        with _served(srv, h):
            ver = _raw(h, sv=1)[0]["ver"]
            rep, out = _raw(h, if_newer=ver)
            assert rep.get("not_modified") and not out and rep["ver"] == ver
            assert srv.counters["not_modified"] == 1
            # a version of another life (equality, not ordering) gets rows
            rep, out = _raw(h, if_newer=ver + (1 << 50))
            assert "not_modified" not in rep and "w" in out


# ---------------------------------------------------------------------------
# the serving handle, and interop with the JAX package
# ---------------------------------------------------------------------------


def _scripted(srv_pkg: str, h_pkg: str) -> list:
    """One scripted serving session: rows and the server's serving
    counters after every step."""
    srv = _server(srv_pkg)
    h = _handle(h_pkg, srv, ttl_ms=30)
    writer = _handle(h_pkg, srv, worker=1, serving=False)
    log = []

    def snap(rows):
        log.append((np.asarray(rows, np.float32).ravel().tolist(),
                    [srv.counters[c] for c in SERVING_COUNTERS]))

    with _served(srv, h, writer):
        snap(h.pull(KEYS))                      # miss: a versioned pull
        snap(h.pull(KEYS))                      # fresh hit: no wire
        snap(writer.pull(KEYS))                 # the training tier: wire
        snap(writer.pull(KEYS))                 # hot: the encode is reused
        h.push(KEYS, -np.ones(8, np.float32))   # own push: invalidates
        snap(h.pull(KEYS))                      # a fresh fill
        time.sleep(0.05)                        # TTL lapses
        snap(h.pull(KEYS))                      # revalidated: not_modified
        writer.push(KEYS, -np.ones(8, np.float32))
        time.sleep(0.05)
        snap(h.pull(KEYS))                      # version moved: real rows
        snap(h.pull_async(KEYS).result(timeout=30))   # fresh hit again
        snap(h.pull(OTHER))
    return log


class TestServingHandle:
    @pytest.mark.parametrize("srv_pkg,h_pkg", PAIRS)
    def test_interop_same_rows_and_counter_sequence_as_jax(self, srv_pkg, h_pkg):
        want = _scripted("jax", "jax")
        got = _scripted(srv_pkg, h_pkg)
        assert len(got) == len(want)
        for (gr, gc), (wr, wc) in zip(got, want):
            np.testing.assert_allclose(gr, wr, rtol=RTOL, atol=ATOL)
            assert gc == wc
        assert got[-2][0] == [2.0] * 8 and got[-3][1][1] == 1  # one not_modified

    @pytest.mark.parametrize("srv_pkg,h_pkg", PAIRS)
    def test_async_push_ack_invalidates_racing_cache_fill(self, srv_pkg, h_pkg):
        srv = _server(srv_pkg)
        h = _handle(h_pkg, srv)
        with _served(srv, h):
            h.pull(KEYS)
            f = h.push_async(KEYS, -np.ones(8, np.float32))
            h.pull(KEYS)  # may race the deferred apply and re-cache
            f.result(timeout=30)
            np.testing.assert_allclose(h.pull(KEYS), np.ones(8, np.float32))

    def test_shared_cache_across_shards_is_rank_scoped(self):
        sa, sb = _server("torch", 0), _server("torch", 256)
        shared = TKC(cap=64, ttl_s=10.0, max_stale_s=60.0)
        ha = _handle("torch", sa, rank=0, key_cache=shared)
        hb = _handle("torch", sb, rank=1, key_cache=shared)
        try:
            assert ha._kcache is shared and hb._kcache is shared
            hb.push(KEYS, -np.ones(8, np.float32))
            np.testing.assert_allclose(ha.pull(KEYS), np.zeros(8, np.float32))
            np.testing.assert_allclose(hb.pull(KEYS), np.ones(8, np.float32))
            assert len(shared) == 2
            ha.push(KEYS, -np.ones(8, np.float32))
            pulls_b = sb.counters["pulls"]
            np.testing.assert_allclose(hb.pull(KEYS), np.ones(8, np.float32))
            assert sb.counters["pulls"] == pulls_b  # still a local hit
            np.testing.assert_allclose(ha.pull(KEYS), np.ones(8, np.float32))
        finally:
            for h, s in ((ha, sa), (hb, sb)):
                h.shutdown()
                h.close()
                s.server.stop()

    def test_training_tier_bypasses_cache(self):
        srv = _server("torch")
        h = _handle("torch", srv, serving=False)
        with _served(srv, h):
            assert h._kcache is None
            h.pull(KEYS)
            h.pull(KEYS)
            assert srv.counters["pulls"] == 2


# ---------------------------------------------------------------------------
# single-flight encodes
# ---------------------------------------------------------------------------


class TestSingleFlightCoalescing:
    @pytest.mark.parametrize("srv_pkg,h_pkg", PAIRS)
    def test_repeated_pulls_share_one_encode_until_a_push(self, srv_pkg, h_pkg):
        srv = _server(srv_pkg)
        h = _handle(h_pkg, srv, serving=False)
        with _served(srv, h):
            np.testing.assert_array_equal(h.pull(KEYS), h.pull(KEYS))
            assert (srv.counters["encode_reuse"], srv.counters["pull_encodes"]) == (1, 1)
            h.push(KEYS, -np.ones(8, np.float32))
            np.testing.assert_allclose(h.pull(KEYS), np.ones(8, np.float32))
            assert srv.counters["pull_encodes"] == 2

    def test_concurrent_pulls_coalesce(self):
        srv = _server("torch", size=1 << 14)
        keys = np.arange(1, 2049, dtype=np.int64)
        handles = [_handle("torch", srv, worker=i, serving=False) for i in range(4)]
        try:
            handles[0].pull(keys)
            outs = [None] * 4

            def pull(i):
                outs[i] = handles[i].pull(keys)

            ths = [threading.Thread(target=pull, args=(i,)) for i in range(4)]
            for t in ths:
                t.start()
            for t in ths:
                t.join()
            for o in outs:
                np.testing.assert_array_equal(o, outs[0])
            assert srv.counters["pull_encodes"] == 1 and srv.counters["encode_reuse"] == 4
        finally:
            handles[0].shutdown()
            for h in handles:
                h.close()
            srv.server.stop()

    def test_encode_cache_byte_budget_and_hot_threshold(self):
        srv = _server("torch", size=1 << 16, encode_cache_mb=1)
        h = _handle("torch", srv, serving=False)
        with _served(srv, h):
            for i in range(12):  # 12 x 128 KiB of f32 rows = 1.5 MiB
                h.pull(np.arange(1 + i, 1 + i + (1 << 15), dtype=np.int64))
            assert srv._enc_bytes <= 1 << 20 and len(srv._enc_cache) < 12
        srv = _server("torch", hot_min_pulls=3)
        h = _handle("torch", srv, serving=False)
        with _served(srv, h):
            h.pull(KEYS)
            h.pull(KEYS)
            assert srv.counters["encode_reuse"] == 0
            h.pull(KEYS)
            h.pull(KEYS)
            assert srv.counters["encode_reuse"] == 1

    def test_host_snapshot_serves_hot_conditional_pulls_at_its_version(self):
        """A hot revalidation of a range within ``snapshot_keys_max`` takes
        the host copy of the whole table once a version; it is a copy, so
        a later apply leaves it as it was."""
        srv = _server("torch", updater=TU.Adagrad(eta=0.1), ttl_ms=0)
        h = _handle("torch", srv, ttl_ms=0, max_stale_ms=0)
        w = _handle("torch", srv, worker=1, serving=False)
        with _served(srv, h, w):
            w.push(KEYS, np.ones(8, np.float32))
            h.pull(KEYS)
            w.push(OTHER, np.ones(8, np.float32))
            rows = h.pull(KEYS)  # ttl 0: revalidates, version moved: rows
            ver, host = srv._host_w
            assert ver == srv.version and host.shape == (256, 1)
            np.testing.assert_array_equal(host[KEYS, 0], rows)
            before = host.copy()
            w.push(KEYS, np.ones(8, np.float32))
            np.testing.assert_array_equal(host, before)
            assert srv._host_w[0] != srv.version


# ---------------------------------------------------------------------------
# load shedding
# ---------------------------------------------------------------------------


class TestLoadShedding:
    @pytest.mark.parametrize("srv_pkg,h_pkg", PAIRS)
    def test_shed_serves_cached_within_bound(self, srv_pkg, h_pkg):
        srv = _server(srv_pkg, ttl_ms=5, max_stale_ms=10_000)
        h = _handle(h_pkg, srv, ttl_ms=5, max_stale_ms=10_000)
        writer = _handle(h_pkg, srv, worker=1, serving=False)
        with _served(srv, h, writer):
            w0 = h.pull(KEYS)
            writer.push(KEYS, -np.ones(8, np.float32))
            srv.overloaded = lambda: True
            time.sleep(0.02)
            np.testing.assert_array_equal(h.pull(KEYS), w0)  # bounded-stale serve
            assert srv.counters["shed"] == 1
            assert COUNTERS[h_pkg].get("serve_shed_served") == 1
            srv.overloaded = lambda: False
            time.sleep(0.05)
            np.testing.assert_allclose(h.pull(KEYS), np.ones(8, np.float32))

    def test_past_max_stale_and_training_pulls_are_never_shed(self):
        srv = _server("torch", ttl_ms=5, max_stale_ms=10_000)
        h = _handle("torch", srv, ttl_ms=5, max_stale_ms=10_000)
        writer = _handle("torch", srv, worker=1, serving=False)
        with _served(srv, h, writer):
            h.pull(KEYS)
            writer.push(KEYS, -np.ones(8, np.float32))
            srv.overloaded = lambda: True
            h._kcache.max_stale_s = 0.0
            time.sleep(0.02)
            np.testing.assert_allclose(h.pull(KEYS), np.ones(8, np.float32))
            assert len(writer.pull(KEYS)) == 8
            assert srv.counters["shed"] == 0

    def test_overloaded_signal_thresholds(self):
        srv = _server("torch", shed_queue_depth=0, shed_withheld_mb=0)
        try:
            assert srv.overloaded() is False
            srv._serve_cfg.shed_queue_depth = 1
            assert srv.overloaded() is False and srv.server.withheld_bytes() == 0
            srv._serve_cfg.shed_withheld_mb = 1
            srv.server._withheld_now = 1 << 20  # the live gauge the lanes feed
            assert srv.overloaded() is True
            srv.server._withheld_now = 0
        finally:
            srv.server.stop()


# ---------------------------------------------------------------------------
# coherence under a fault plan; F6
# ---------------------------------------------------------------------------


class TestServingChaosCoherence:
    PLAN = "drop,cmd=pull,every=7;disconnect,cmd=push,every=5;duplicate,every=6"

    @pytest.mark.parametrize("srv_pkg,h_pkg", PAIRS)
    def test_read_your_writes_and_exactly_once_under_chaos(self, srv_pkg, h_pkg):
        srv = _server(srv_pkg, fault_plan=(self.PLAN, 3))
        h = _handle(h_pkg, srv, reconnect_timeout_s=30.0)
        with _served(srv, h):
            for i in range(12):
                h.push(KEYS, -np.ones(8, np.float32))
                np.testing.assert_allclose(h.pull(KEYS), np.full(8, float(i + 1), np.float32),
                                           err_msg=f"after push {i + 1}")
            assert srv.counters["pushes"] == 12
            assert srv.server.fault_stats()["frames"] > 0

    def test_zero_ttl_never_serves_stale_under_chaos(self):
        srv = _server("torch", fault_plan=("duplicate,every=4", 9))
        h = _handle("torch", srv, ttl_ms=0, max_stale_ms=0)
        writer = _handle("torch", srv, worker=1, serving=False)
        with _served(srv, h, writer):
            for i in range(8):
                writer.push(KEYS, -np.ones(8, np.float32))
                np.testing.assert_allclose(h.pull(KEYS), np.full(8, float(i + 1), np.float32))


def test_f6_cached_version_does_not_validate_after_a_checkpoint_restart(tmp_path):
    """A restarted server (a new life, its table restored from a
    checkpoint taken before the client's last read) must answer the
    client's cached version with rows, never ``not_modified``: the old
    counting scheme gave the restored life the same version numbers."""
    srv = _server("torch", ttl_ms=0)
    h = _handle("torch", srv, ttl_ms=0, max_stale_ms=0)
    writer = _handle("torch", srv, worker=1, serving=False)
    writer.push(KEYS, -np.ones(8, np.float32))   # A
    srv.save_state(str(tmp_path))                # the dump holds A
    writer.push(KEYS, -np.ones(8, np.float32))   # B, lost with the restart
    np.testing.assert_allclose(h.pull(KEYS), np.full(8, 2.0, np.float32))
    cached_ver = srv.version
    writer.close()
    h.close()
    srv.server.stop()
    srv2 = _server("torch", ttl_ms=0)
    assert srv2.load_state(str(tmp_path))
    w2 = _handle("torch", srv2, worker=1, serving=False)
    w2.push(KEYS, np.full(8, -5.0, np.float32))  # C: A then C = 6.0
    assert srv2.version != cached_ver
    with _served(srv2, w2):
        rep, out = _raw(w2, if_newer=cached_ver)
        assert "not_modified" not in rep
        np.testing.assert_allclose(out["w"], np.full(8, 6.0, np.float32))
        assert srv2.counters["not_modified"] == 0


def test_training_tier_connects_plain_handles_with_serve_cache_on():
    """The cluster's worker (``_connect_servers``) never builds a serving
    handle: with ``[serve] cache`` on, its handles keep no key cache and
    each pull reaches the server, as ``launch_local``'s training tier
    must."""
    from parameter_server_tpu_torch.parallel.control import ControlClient, Coordinator

    srv = _server("torch", size=1 << 10)
    coord = Coordinator()
    ctl = ControlClient(coord.address)
    cfg = TCFG.PSConfig()
    cfg.data.num_keys = 1 << 10
    cfg.serve.cache = True
    handles = []
    try:
        ctl.kv_set("server_addr/0", addr=srv.address)
        handles = TM._connect_servers(ctl, 0, 1, cfg, device="cpu")
        assert [h._kcache for h in handles] == [None]
        handles[0].pull(KEYS)
        handles[0].pull(KEYS)
        assert srv.counters["pulls"] == 2
    finally:
        for h in handles:
            h.close()
        srv.server.stop()
        ctl.close()
        coord.stop()
