"""The port's shard server and handle (``parallel/multislice.py``) held to
the JAX package's over the wire: a JAX handle against a port server and a
port handle against a JAX server build the same tables as the JAX pair
(rtol 1e-5, atol 1e-6); the int8 wire codec decodes to the same gradient
on both servers and the port handle encodes it byte for byte as the JAX
handle does; the fixed-point codec (which draws from another random
stream than the JAX handle's) is held by its statistics. Then the apply
engine's contracts, as ``tests/test_batched_apply.py`` holds the JAX
server to them: the need_keys bounce, concurrent pushes applied exactly
once and coalesced, a pull mid-batch never torn, the serial
``apply_queue = 0`` path, a resent push applied once, and the refusal of
the serving plane's fields. Every server and handle is shut down and
closed in a ``finally``."""

from __future__ import annotations

import contextlib
import threading
import time

import numpy as np
import pytest
import torch

from parameter_server_tpu.kv import updaters as JU
from parameter_server_tpu.parallel import multislice as JM
from parameter_server_tpu.utils import config as JC
from parameter_server_tpu.utils import keyrange as JK
from parameter_server_tpu.utils.metrics import wire_counters as j_counters
from parameter_server_tpu_torch.kv import updaters as TU
from parameter_server_tpu_torch.parallel import multislice as TM
from parameter_server_tpu_torch.parallel.control import RpcClient
from parameter_server_tpu_torch.utils import config as TC
from parameter_server_tpu_torch.utils import keyrange as TK
from parameter_server_tpu_torch.utils.metrics import wire_counters as t_counters

torch.set_num_threads(1)

RTOL, ATOL = 1e-5, 1e-6
RANGE = 1024

FTRL = {"alpha": 0.5, "beta": 1.0, "lambda_l1": 1e-3, "lambda_l2": 0.01}
ADAGRAD = {"eta": 0.1, "eps": 1e-8, "lambda_l2": 0.0}


@pytest.fixture(autouse=True)
def _fresh_counters():
    t_counters.reset()
    j_counters.reset()
    yield
    t_counters.reset()
    j_counters.reset()


def _updater(pkg: str, algo: str, **kw):
    mod = JU if pkg == "jax" else TU
    hyper = {"ftrl": FTRL, "adagrad": ADAGRAD, "sgd": {"eta": 1.0}}[algo]
    return {"ftrl": mod.Ftrl, "adagrad": mod.Adagrad, "sgd": mod.Sgd}[algo](**{**hyper, **kw})


def _server(pkg: str, updater, begin: int = 0, vdim: int = 1, **kw):
    if pkg == "jax":
        return JM.ShardServer(updater, JK.KeyRange(begin, begin + RANGE), vdim=vdim,
                              **kw).start()
    return TM.ShardServer(updater, TK.KeyRange(begin, begin + RANGE), vdim=vdim,
                          device="cpu", **kw).start()


def _handle(pkg: str, srv, worker: int = 0, cfg=None):
    if pkg == "jax":
        return JM.ServerHandle(srv.address, 0, worker, cfg or JC.PSConfig(),
                               range_size=RANGE)
    return TM.ServerHandle(srv.address, 0, worker, cfg or TC.PSConfig(),
                           range_size=RANGE, device="cpu")


@contextlib.contextmanager
def _served(srv, *handles):
    """Shut the server down through the first handle and close every
    handle, whatever the test did."""
    try:
        yield
    finally:
        try:
            handles[0].shutdown()
        finally:
            for h in handles:
                h.close()
            srv.server.stop()  # the apply thread (a daemon) exits behind it


def _pushes(vdim: int, seed: int = 0, rounds: int = 5):
    """Sorted unique local key sets (local row 0 included: on a range that
    begins above 0 it is a real key) with their gradients."""
    rng = np.random.default_rng(seed)
    out = []
    for r in range(rounds):
        keys = np.unique(rng.integers(0, RANGE, 300))
        if r % 2 == 0:
            keys = np.union1d(keys, [0])
        out.append((keys, rng.normal(size=(len(keys), vdim)).astype(np.float32)))
    return out


def _run_sequence(server_pkg, handle_pkg, algo, vdim, begin):
    """The pushes one at a time (each acked before the next, so every
    apply batch holds one push), then a pull of every key."""
    srv = _server(server_pkg, _updater(server_pkg, algo), begin=begin, vdim=vdim)
    h = _handle(handle_pkg, srv)
    with _served(srv, h):
        pushes = _pushes(vdim)
        for i, (keys, g) in enumerate(pushes):
            if i % 2:
                h.push_async(keys, g).result(timeout=30)
            else:
                h.push(keys, g)
        allk = np.arange(RANGE)
        return h.pull(allk).reshape(RANGE, vdim), h.pull_async(allk).result(30)


_JAX_PAIR: dict = {}


def _jax_pair(algo, vdim, begin):
    """The JAX pair's tables, run once per case for both directions."""
    key = (algo, vdim, begin)
    if key not in _JAX_PAIR:
        _JAX_PAIR[key] = _run_sequence("jax", "jax", algo, vdim, begin)[0]
    return _JAX_PAIR[key]


@pytest.mark.parametrize("begin", [0, 5 * RANGE])
@pytest.mark.parametrize("algo,vdim", [("ftrl", 1), ("adagrad", 4)])
@pytest.mark.parametrize("pair", ["jax_handle_torch_server", "torch_handle_jax_server"])
def test_interop_builds_the_jax_pairs_tables(pair, algo, vdim, begin):
    server_pkg, handle_pkg = (("torch", "jax") if pair == "jax_handle_torch_server"
                              else ("jax", "torch"))
    want = _jax_pair(algo, vdim, begin)
    got, got_async = _run_sequence(server_pkg, handle_pkg, algo, vdim, begin)
    assert np.abs(want).max() > 0
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(got_async.reshape(RANGE, vdim), got)


@pytest.mark.parametrize("algo,vdim", [("ftrl", 1), ("adagrad", 4)])
def test_port_pair_matches_a_plain_replay(algo, vdim):
    """The port pair's table against the port's own store replayed push by
    push on the CPU, at a range that begins above 0."""
    from parameter_server_tpu_torch.kv.store import KVStore

    got, _ = _run_sequence("torch", "torch", algo, vdim, begin=3 * RANGE)
    store = KVStore(_updater("torch", algo), RANGE, vdim=vdim, device="cpu")
    for keys, g in _pushes(vdim):
        store.push(keys, g)
    np.testing.assert_allclose(got, store.weights().numpy(), rtol=RTOL, atol=ATOL)


# ---------------------------------------------------------------------------
# the wire codecs
# ---------------------------------------------------------------------------


def _quant_cfg(pkg: str, **filt):
    cfg = (JC if pkg == "jax" else TC).PSConfig()
    cfg.wire.quant = "int8"
    cfg.wire.quant_seg = 64
    for k, v in filt.items():
        setattr(cfg.filter, k, v)
    return cfg


def test_jax_int8_push_decodes_the_same_on_both_servers():
    from parameter_server_tpu.filters.quant import SegmentQuantizer

    rng = np.random.default_rng(3)
    g = rng.normal(size=(300, 2)).astype(np.float32)
    q, qs = SegmentQuantizer(1, 64).encode(11, g)
    h = {"codec": 1, "qseg": 64}
    jsrv = JM.ShardServer(JU.Sgd(), JK.KeyRange(0, 8))
    tsrv = TM.ShardServer(TU.Sgd(), TK.KeyRange(0, 8), device="cpu")
    try:
        want = jsrv._decode_grad(h, {"q": q, "qs": qs})
        np.testing.assert_array_equal(tsrv._decode_grad(h, {"q": q, "qs": qs}), want)
    finally:
        jsrv.server.stop()
        tsrv.server.stop()
    # and over the wire: a JAX int8 handle's SGD pushes leave the same table
    tables = []
    for server_pkg in ("jax", "torch"):
        srv = _server(server_pkg, _updater(server_pkg, "sgd"))
        hd = _handle("jax", srv, cfg=_quant_cfg("jax"))
        with _served(srv, hd):
            keys = np.arange(1, 301)
            for i in range(4):
                hd.push(keys, rng.normal(size=300).astype(np.float32) if i else g[:, 0])
            tables.append(hd.pull(keys))
            assert hd.residual_norm() > 0  # the int8 codec really ran
        rng = np.random.default_rng(3)
        g = rng.normal(size=(300, 2)).astype(np.float32)
    np.testing.assert_array_equal(tables[1], tables[0])


def test_port_int8_encode_is_the_jax_handles_byte_for_byte():
    """Both handles' per-segment codec is the numpy encode with a seed
    counter: after negotiating "qwire" the same pushes give the same
    payloads, and the same residuals."""
    srv = _server("torch", _updater("torch", "sgd"))
    jh = _handle("jax", srv, worker=0, cfg=_quant_cfg("jax"))
    th = _handle("torch", srv, worker=1, cfg=_quant_cfg("torch"))
    rng = np.random.default_rng(5)
    keys = np.arange(2, 202)
    with _served(srv, th, jh):
        for h in (jh, th):
            h.push(keys, np.zeros(200, np.float32))  # negotiates qwire
            assert "qwire" in h.client.peer_features
        for _ in range(3):
            g = rng.normal(size=(200, 1)).astype(np.float32)
            jf, ja = jh._encode_push(keys, g)
            tf, ta = th._encode_push(keys, g)
            assert jf == tf and set(ja) == set(ta) == {"q", "qs"}
            for k in ja:
                np.testing.assert_array_equal(ta[k], ja[k])
        np.testing.assert_array_equal(th.residual_rows(keys), jh.residual_rows(keys))


def test_port_int8_push_is_unbiased_and_within_one_step():
    from parameter_server_tpu_torch.filters.quant import SegmentQuantizer

    srv = _server("torch", _updater("torch", "sgd"))
    th = _handle("torch", srv, cfg=_quant_cfg("torch"))
    keys = np.arange(1, 65)
    x = np.linspace(-1.0, 1.0, 64, dtype=np.float32)
    with _served(srv, th):
        th.push(keys, np.zeros(64, np.float32))  # negotiates qwire
        qz = SegmentQuantizer(1, 64)
        decs = []
        for _ in range(400):
            with th._res_lock:
                th._residual = None  # each encode on its own, no feedback
            _, arrays = th._encode_push(keys, x)
            decs.append(qz.decode(arrays["q"], arrays["qs"]))
    decs = np.stack(decs)
    step = np.abs(x).max() / 127
    assert np.all(np.abs(decs - x) <= step * (1 + 1e-6))
    # unbiased: the mean of 400 draws within 4 sigma of each element
    sigma = step * 0.5 / np.sqrt(len(decs))
    assert np.all(np.abs(decs.mean(0) - x) <= 4 * sigma + 1e-7)


def test_fixed_point_push_is_unbiased_within_one_step_and_decoded_by_both_servers():
    """``[filter] fixing_float_bytes``: the port handle encodes through the
    port's FixedPointCodec (plain K4 on the CPU, Philox), the JAX handle
    through threefry, so the payloads differ; each decodes within one
    quantization step (+ 8 ulps) of the gradient and unbiased, and a JAX
    server and a port server decode the port handle's payload alike."""
    cfg = TC.PSConfig()
    cfg.filter.fixing_float_bytes = 1
    srv = _server("torch", _updater("torch", "sgd"))
    jsrv = JM.ShardServer(JU.Sgd(), JK.KeyRange(0, 8))
    th = _handle("torch", srv, cfg=cfg)
    keys = np.arange(1, 257)
    x = np.random.default_rng(9).normal(size=256).astype(np.float32)
    step = (x.max() - x.min()) / 255
    try:
        with _served(srv, th):
            decs = []
            for _ in range(200):
                fields, arrays = th._encode_push(keys, x)
                assert fields == {"codec": 1} and arrays["q"].dtype == np.int8
                d = srv._decode_grad({"codec": 1}, arrays)
                np.testing.assert_allclose(
                    jsrv._decode_grad({"codec": 1}, arrays), d, rtol=0, atol=8 * 2**-24 * 4)
                decs.append(d)
            th.push(keys, x)  # and over the wire
            assert srv.counters["pushes"] == 1
    finally:
        jsrv.server.stop()
    decs = np.stack(decs)
    ulps = 8 * np.abs(x).max() * 2**-24
    assert np.all(np.abs(decs - x) <= step + ulps)
    # unbiased but at the maximum, which both packages saturate one step
    # low (q - levels // 2 = 128 does not fit int8; ROADMAP F1)
    sigma = step * 0.5 / np.sqrt(len(decs))
    rest = np.arange(len(x)) != np.argmax(x)
    assert np.all(np.abs(decs.mean(0) - x)[rest] <= 4 * sigma + ulps)


# ---------------------------------------------------------------------------
# the apply engine's contracts
# ---------------------------------------------------------------------------


class _SlowDelta:
    """An SGD updater whose ``delta`` stalls: it holds the apply thread in
    its first batch so a concurrent burst demonstrably queues up and
    coalesces into the next (the port's store runs ``delta`` for any
    updater but FTRL and AdaGrad)."""

    name = "sgd"

    def __init__(self, sleep_s: float):
        self._inner = TU.Sgd(eta=1.0)
        self._sleep = sleep_s

    def init(self, *a, **kw):
        return self._inner.init(*a, **kw)

    def weights(self, rows):
        return self._inner.weights(rows)

    def delta(self, rows, grad):
        time.sleep(self._sleep)
        return self._inner.delta(rows, grad)


def test_need_keys_bounce_applies_once():
    srv = _server("torch", _updater("torch", "sgd"))
    h = _handle("torch", srv)
    keys = np.arange(1, 33)
    with _served(srv, h):
        h.push(keys, np.ones(32, np.float32))
        h.push(keys, np.ones(32, np.float32))  # rides the cached signature
        assert srv.counters["cache_hits"] == 1
        srv._key_cache = TM._LruSigs()  # as a restarted server forgets
        h.push(keys, np.ones(32, np.float32))  # bounced, then re-sent keyed
        h.push_async(keys, np.ones(32, np.float32)).result(timeout=30)
        srv._key_cache = TM._LruSigs()
        np.testing.assert_allclose(h.pull(keys), -4.0)  # a pull bounces too
        assert srv.counters["need_keys"] == 2
        assert srv.counters["pushes"] == 4


def test_concurrent_pushes_land_exactly_once_and_coalesce():
    srv = _server("torch", _SlowDelta(0.05))
    handles = [_handle("torch", srv, worker=w) for w in range(3)]
    keys = np.arange(1, 65)
    with _served(srv, *handles):
        futs = [h.push_async(keys, np.ones(64, np.float32))
                for _ in range(6) for h in handles]
        for f in futs:
            f.result(timeout=60)
        np.testing.assert_allclose(handles[0].pull(keys), -18.0)
        assert srv.counters["pushes"] == 18
        assert srv.counters["push_coalesced"] >= 1
        assert srv.counters["apply_batches"] < 18
        assert t_counters.get("push_coalesced") >= 1


@pytest.mark.parametrize("algo", ["sgd", "ftrl"])
def test_pull_mid_batch_is_never_torn(algo):
    """Every push moves keys 1..64 alike, so every whole state has all 64
    values equal: a pull that saw part of an apply shows a mix."""
    srv = _server("torch", _updater("torch", algo))
    pusher, puller = _handle("torch", srv, 0), _handle("torch", srv, 1)
    keys = np.arange(1, 65)
    g = np.ones(64, np.float32)
    stop = threading.Event()
    torn: list = []
    pulls = [0]

    def pull_loop() -> None:
        while not stop.is_set():
            w = puller.pull(keys)
            pulls[0] += 1
            if not np.all(w == w[0]):
                torn.append(w.copy())
                return

    t = threading.Thread(target=pull_loop)
    with _served(srv, pusher, puller):
        pusher.push(keys, g)
        t.start()
        try:
            for _ in range(10):
                for f in [pusher.push_async(keys, g) for _ in range(8)]:
                    f.result(timeout=60)
        finally:
            stop.set()
            t.join(timeout=30)
        assert not torn, f"torn pull observed: {torn[0]}"
        assert pulls[0] > 0
        assert srv.counters["pushes"] == 81
        if algo == "sgd":
            np.testing.assert_allclose(puller.pull(keys), -81.0)


def test_serial_fallback_apply_queue_zero():
    srv = _server("torch", _updater("torch", "sgd"),
                  server_cfg=TC.ServerConfig(apply_queue=0))
    h = _handle("torch", srv)
    keys = np.arange(1, 17)
    with _served(srv, h):
        for f in [h.push_async(keys, np.ones(16, np.float32)) for _ in range(8)]:
            f.result(timeout=60)
        np.testing.assert_allclose(h.pull(keys), -8.0)
        assert srv.counters["pushes"] == 8
        assert srv.counters["apply_batches"] == 0  # the engine never ran
        assert srv._apply_q is None


def test_resent_push_applies_once_on_the_wire_and_in_the_engine():
    srv = _server("torch", _updater("torch", "sgd"))
    cli = RpcClient(srv.address)
    keys = np.arange(1, 9, dtype=np.uint32)
    g = np.ones(8, np.float32)
    try:
        for _ in range(2):  # the reply cache answers the resend
            cli.call("push", {"keys": keys, "g": g}, worker=0, sig="s", codec=0, _seq="k0")
        assert srv.counters["pushes"] == 1
        assert t_counters.get("rpc_dedup_hits") == 1
        # the engine's ledger drops a push that reaches it twice (a
        # duplicate within one batch, or a resend past the reply cache)
        a = TM._QueuedPush(keys.astype(np.int64), g.reshape(-1, 1), "cid", "k9")
        b = TM._QueuedPush(keys.astype(np.int64), g.reshape(-1, 1), "cid", "k9")
        srv._apply_batch([a, b])
        c = TM._QueuedPush(keys.astype(np.int64), g.reshape(-1, 1), "cid", "k9")
        srv._apply_batch([c])
        for p in (a, b, c):
            assert p.future.result(timeout=5)[0]["ok"]
        assert srv.counters["pushes"] == 2
        assert srv.counters["push_replays"] == 2
        np.testing.assert_allclose(srv.weights()[1:9], -2.0)
    finally:
        cli.call("shutdown")
        cli.close()


def test_bad_push_in_batch_does_not_fail_neighbours():
    srv = _server("torch", _SlowDelta(0.05))
    h = _handle("torch", srv)
    keys = np.arange(1, 5)
    with _served(srv, h):
        h.push(keys, np.zeros(4, np.float32))
        stall = [h.push_async(keys, np.ones(4, np.float32)) for _ in range(2)]
        good = TM._QueuedPush(keys, np.ones((4, 1), np.float32), "cg", "g0")
        bad = TM._QueuedPush(keys, np.ones((4, 2), np.float32), "cb", "b0")
        srv._enqueue_push(good)
        srv._enqueue_push(bad)
        good.future.result(timeout=30)
        with pytest.raises(Exception):
            bad.future.result(timeout=30)
        for f in stall:
            f.result(timeout=30)
        np.testing.assert_allclose(h.pull(keys), -3.0)


def test_shutdown_never_overtakes_queued_pushes():
    srv = _server("torch", _SlowDelta(0.03))
    h = _handle("torch", srv)
    keys = np.arange(1, 17)
    try:
        h.push(keys, np.zeros(16, np.float32))
        futs = [h.push_async(keys, np.ones(16, np.float32)) for _ in range(4)]
        h.shutdown()  # same client: stays behind the pushes
        for f in futs:
            f.result(timeout=60)
        assert srv.counters["pushes"] == 5
    finally:
        h.close()


def test_repeated_keys_in_one_push_add_one_delta_each():
    """A single push whose keys repeat never reaches K1 or K3: it takes
    the JAX ``.at[].add`` way (a delta per occurrence from the same row)."""
    srv = _server("torch", _updater("torch", "ftrl"))
    jsrv = _server("jax", _updater("jax", "ftrl"))
    keys = np.array([3, 7, 3, 9])
    g = np.array([0.5, -1.0, 2.0, 0.25], np.float32)
    hs = [_handle("torch", srv), _handle("jax", jsrv)]
    with _served(srv, hs[0]), _served(jsrv, hs[1]):
        for h in hs:
            h.push(keys, g)
        np.testing.assert_allclose(hs[0].pull(np.arange(12)), hs[1].pull(np.arange(12)),
                                   rtol=RTOL, atol=ATOL)


def test_stats_and_dump():
    srv = _server("torch", _updater("torch", "adagrad"), begin=RANGE, vdim=2)
    h = _handle("torch", srv)
    with _served(srv, h):
        v0 = srv.version  # an opaque per-life id; within a life it counts
        h.push(np.array([0, 5]), np.ones((2, 2), np.float32))
        st = h.stats()
        assert st["pushes"] == 1 and st["state_ver"] == v0 + 1 == srv.version
        assert {"bytes_in", "bytes_out", "frames_in", "cached_sigs",
                "rpc_dedup_hits", "apply_batches"} <= set(st)
        begin, w = h.dump()
        assert begin == RANGE and w.shape == (RANGE, 2)
        assert np.count_nonzero(w) == 4


def test_serving_fields_get_an_error_reply_and_serving_handles_raise():
    """The serving plane's pull fields are served, not refused: ``sv``
    stamps the reply's version, ``if_newer`` at the current version is
    answered ``not_modified`` with no rows, ``shed_ok`` on a server that
    is not overloaded gets the rows; and a serving handle arms its key
    cache."""
    srv = _server("torch", _updater("torch", "sgd"))
    cli = RpcClient(srv.address)
    keys = {"keys": np.arange(4, dtype=np.uint32)}
    try:
        rep, out = cli.call("pull", keys, worker=0, sig="s", sv=1)
        assert rep["ver"] == srv.version and "w" in out and rep["_age_us"] >= 0
        rep, out = cli.call("pull", keys, worker=0, sig="s", if_newer=srv.version)
        assert rep["not_modified"] and not out
        rep, out = cli.call("pull", keys, worker=0, sig="s", if_newer=1, shed_ok=1)
        assert "not_modified" not in rep and len(out["w"]) == 4
        assert (srv.counters["not_modified"], srv.counters["shed"]) == (1, 0)
        cfg = TC.PSConfig()
        cfg.serve.cache = True
        h = TM.ServerHandle(srv.address, 0, 0, cfg, serving=True, device="cpu")
        assert h._kcache is not None and h._kcache.ttl_s == cfg.serve.ttl_ms / 1e3
        h.close()
    finally:
        cli.call("shutdown")
        cli.close()


def test_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        TM.ShardServer(TU.Sgd(), TK.KeyRange(0, 8))
    with pytest.raises(RuntimeError, match="cuda"):
        TM.ServerHandle("127.0.0.1:1", 0, 0, TC.PSConfig())


def test_unported_options_are_refused_not_ignored():
    """``[server] adaptive_batch`` and ``[wire] adaptive_window`` are armed,
    not ignored: the apply thread starts its ramp at 4, the handle's
    client shapes its window."""
    srv = TM.ShardServer(TU.Sgd(), TK.KeyRange(0, 8), device="cpu",
                         server_cfg=TC.ServerConfig(adaptive_batch=True))
    try:
        assert srv._adaptive_batch and srv._eff_batch == 4
    finally:
        srv.server.stop()
    srv = _server("torch", _updater("torch", "sgd"))
    cfg = TC.PSConfig()
    cfg.wire.adaptive_window = True
    cfg.wire.hdr_codec = "json"
    h = _handle("torch", srv, cfg=cfg)
    with _served(srv, h):
        assert h.client._adaptive is True and h.client._hdr_bin is False


@pytest.mark.parametrize("max_batch", [64, 8])
def test_adaptive_batch_policy_matches_jax(max_batch):
    """The drain ceiling's policy against the JAX server's on one drive
    (the drive of ``tests/test_batched_apply.py``'s ``TestAdaptiveBatch``,
    then a floor run): the same ceilings, the same adapt counts."""
    drive = [(4, 3), (8, 1), (16, 9), (32, 2), (64, 5), (3, 0), (40, 0)] + [(1, 0)] * 10
    seen = {}
    for pkg, counters in (("torch", t_counters), ("jax", j_counters)):
        kw = {} if pkg == "jax" else {"device": "cpu"}
        mod, cfgm, keyr, upd = ((JM, JC, JK, JU) if pkg == "jax" else (TM, TC, TK, TU))
        srv = mod.ShardServer(upd.Sgd(eta=1.0), keyr.KeyRange(0, 64),
                              server_cfg=cfgm.ServerConfig(adaptive_batch=True,
                                                           max_batch=max_batch), **kw)
        try:
            log = [srv._eff_batch]
            for got, backlog in drive:
                srv._adapt_batch(got=got, backlog=backlog)
                log.append(srv._eff_batch)
            seen[pkg] = (log, counters.get("server_batch_adapts"))
        finally:
            srv.server.stop()
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][0][-1] == 1


@pytest.mark.parametrize("max_batch", [32, 4])
def test_adaptive_engine_still_exactly_once(max_batch):
    """A pipelined burst through an adaptive engine applies every push
    exactly once: the SGD table (a sum, whatever the batching) equals the
    JAX server's fed the same pushes one at a time (rtol 1e-5, atol
    1e-6)."""
    keys = np.arange(1, 65)
    grads = [np.random.default_rng(i).normal(size=64).astype(np.float32) for i in range(30)]
    srv = _server("torch", _updater("torch", "sgd"),
                  server_cfg=TC.ServerConfig(adaptive_batch=True, max_batch=max_batch))
    h = _handle("torch", srv)
    jsrv = _server("jax", _updater("jax", "sgd"))
    jh = _handle("jax", jsrv)
    with _served(srv, h), _served(jsrv, jh):
        for f in [h.push_async(keys, g) for g in grads]:
            f.result(timeout=30)
        for g in grads:
            jh.push(keys, g)
        assert srv.counters["pushes"] == 30
        np.testing.assert_allclose(h.pull(keys), jh.pull(keys), rtol=RTOL, atol=ATOL)


def test_handle_follows_a_relaunched_server_through_its_resolver():
    """The server moves (a new process on another port): the handle's
    keyed call fails its in-place heal, asks the resolver, rebuilds its
    client under the same identity and lands the push on the new server."""
    srv = _server("torch", _updater("torch", "sgd"))
    where = [srv.address]
    h = TM.ServerHandle(srv.address, 0, 0, TC.PSConfig(), range_size=RANGE,
                        resolve_addr=lambda: where[0], reconnect_timeout_s=1.0,
                        device="cpu")
    keys = np.arange(1, 9)
    try:
        h.push(keys, np.ones(8, np.float32))
        cid = h.client.identity[0]
        h.shutdown()
        srv2 = _server("torch", _updater("torch", "sgd"))
        where[0] = srv2.address
        h.push(keys, np.ones(8, np.float32))
        assert h.client.identity[0] == cid and h.client._address == srv2.address
        np.testing.assert_allclose(h.pull_async(keys).result(30), -1.0)
        assert srv2.counters["pushes"] == 1
    finally:
        h.shutdown()
        h.close()
