"""The port's frame protocol and RPC layer (``parallel/control.py``) held to
the JAX package's on the wire itself: the binary header codec gives the
same bytes for the same header, each package decodes the other's frames,
the compression decisions agree, a client of either package talks to a
server of the other, and the port's pipelined client and reply cache keep
their exactly-once contract. Exact equality throughout: these are copies
of host code (no floating point in the codec)."""

from __future__ import annotations

import socket
import threading

import numpy as np
import pytest
import torch

from parameter_server_tpu.parallel import control as J
from parameter_server_tpu.utils.metrics import wire_counters as j_counters
from parameter_server_tpu_torch.parallel import control as T
from parameter_server_tpu_torch.utils.metrics import wire_counters as t_counters

torch.set_num_threads(1)


@pytest.fixture(autouse=True)
def _fresh_counters():
    t_counters.reset()
    j_counters.reset()
    yield
    t_counters.reset()
    j_counters.reset()


# ---------------------------------------------------------------------------
# the binary header codec
# ---------------------------------------------------------------------------

_METAS = [["keys", "<u4", [1024], 0], ["g", "<f4", [1024, 2], 512],
          ["q", "|i1", [7, 0, 3], 0], ["s", "<f8", [], 0]]

# every flag and slot of versions 1-3, int and string seqs, the JSON tail
_HEADERS = [
    {"cmd": "push", "_cid": "abcdef0123456789", "_seq": "k42", "worker": 3,
     "sig": "00112233", "codec": 0, "zip": True},
    {"cmd": "pull", "_seq": 7},
    {"cmd": "pull", "_seq": -5, "worker": -1},
    {"cmd": "pull", "_seq": (1 << 63) - 1, "worker": (1 << 31) - 1},
    {"cmd": "pull", "_seq": 1 << 63, "worker": 1 << 40},  # slot-unfit: the tail
    {"ok": True, "_rseq": 12},
    {"ok": True, "_rseq": "k12", "_svc_us": 40, "_apw_us": 3, "_apl_us": 9},
    {"ok": False, "error": "RuntimeError('nope')", "_rseq": 3},
    {"ok": True, "need_keys": True, "_transient": True},
    {"zip": False, "cmd": "push"},
    {"cmd": "push", "codec": 2, "qseg": 256},
    {"cmd": "push", "codec": 300},  # past the u8 slot: the tail
    {"cmd": "totally_new_cmd"},
    {"cmd": "push", "_cid": "x" * 300},
    {"cmd": "progress", "worker": 1, "record": {"examples": 10, "auc": 0.9},
     "_trace": {"tid": "a" * 16, "sid": "b" * 16}, "_bh": 1, "_feat": ["qwire"]},
    {"cmd": "pull", "_seq": 3, "worker": 0, "sig": "s" * 16,
     "if_newer": (73 << 40) + 12, "shed_ok": 1, "sv": 1},
    {"ok": True, "_rseq": 3, "ver": (73 << 40) + 13},
    {"ok": True, "not_modified": True, "ver": 5, "shed": True, "retry_after_ms": 20},
    {"cmd": "pull", "if_newer": -3},
    {"ok": True, "ver": 9, "pts": 1_700_000_000_000_000, "_age_us": 12},
    {"ok": True, "pts": 5},
    {"ok": True, "_age_us": -1},
    {"ok": True, "state_ver": 4, "pulls": 2, "faults": {"drop": 1}},
    {},
]


def _as_decoded(h: dict) -> dict:
    return {k: v for k, v in h.items() if not (k == "zip" and v is False)}


@pytest.mark.parametrize("cmd", sorted(J._CMD_IDS, key=J._CMD_IDS.get))
def test_every_command_id_encodes_the_same_bytes(cmd):
    assert T._CMD_IDS == J._CMD_IDS
    h = {"cmd": cmd, "_cid": "c" * 16, "_seq": 9, "worker": 2}
    jb = J._encode_bin_header(dict(h), [])
    tb = T._encode_bin_header(dict(h), [])
    assert tb == jb and jb[4] == J._CMD_IDS[cmd]


@pytest.mark.parametrize("i", range(len(_HEADERS)))
@pytest.mark.parametrize("metas", [[], _METAS], ids=["no_arrays", "arrays"])
def test_binary_header_bytes_match_and_cross_decode(i, metas):
    h = _HEADERS[i]
    jb = J._encode_bin_header(dict(h), [list(m) for m in metas])
    tb = T._encode_bin_header(dict(h), [list(m) for m in metas])
    assert tb == jb
    assert tb[0] == T._BMAGIC and tb[1] in (1, 2, 3)
    # each decodes the other's bytes back to the same header (the codec
    # drops a false zip flag: absent means off)
    for dec in (J._decode_bin_header, T._decode_bin_header):
        out = dec(memoryview(tb))
        assert out.pop("arrays") == [list(m) for m in metas]
        assert out == _as_decoded(h)


def test_unencodable_headers_fall_back_in_both():
    for h in ({"cmd": "push", "bad": object()},
              {"cmd": 5},
              {"cmd": "é" * 200}):  # a command name over 255 bytes
        assert J._encode_bin_header(dict(h), []) is None
        assert T._encode_bin_header(dict(h), []) is None
    assert T._encode_bin_header({"cmd": "x"}, [["a", "<f4", [1 << 32], 0]]) is None
    with pytest.raises(ValueError, match="version"):
        T._decode_bin_header(memoryview(bytes([T._BMAGIC, 4, 0, 0, 0, 0, 0])))


def test_version_byte_is_lowest_layout_used():
    for h, want in (({"cmd": "push", "_cid": "c" * 16, "_seq": "k1"}, 1),
                    ({"cmd": "pull", "if_newer": 7}, 2),
                    ({"ok": True, "pts": 3}, 3)):
        assert T._encode_bin_header(h, [])[1] == want
    assert t_counters.get("hdr_frames_bin") == 3


# ---------------------------------------------------------------------------
# frames and compression
# ---------------------------------------------------------------------------


def _arrays(rng):
    return {
        "keys": np.arange(100, dtype=np.uint32),
        "g": rng.normal(size=2048).astype(np.float32),  # incompressible
        "flat": np.full(4096, 0.5, np.float32),  # compresses
        "small": np.ones(8, np.float32),  # under the floor
        "q": rng.integers(-127, 128, 3000).astype(np.int8),
        "m": rng.normal(size=(3, 5)),
    }


@pytest.mark.parametrize("zip_", [False, True])
@pytest.mark.parametrize("bin_hdr", [False, True])
@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_each_package_decodes_the_others_frames(direction, bin_hdr, zip_):
    rng = np.random.default_rng(0)
    arrays = _arrays(rng)
    src, dst = (J, T) if direction == "jax_to_torch" else (T, J)
    header = {"cmd": "push", "_cid": "c" * 16, "_seq": "k3", "zip": zip_, "worker": 1}
    jbufs, jn = J.build_frame(dict(header), arrays, bin_hdr=bin_hdr)
    tbufs, tn = T.build_frame(dict(header), arrays, bin_hdr=bin_hdr)
    assert jn == tn
    assert b"".join(bytes(c) for c in jbufs) == b"".join(bytes(c) for c in tbufs)
    a, b = socket.socketpair()
    try:
        bufs, _ = src.build_frame(dict(header), arrays, bin_hdr=bin_hdr)
        a.sendall(b"".join(bytes(c) for c in bufs))
        h, out, nbytes, was_bin = dst.recv_frame_ex(b)
    finally:
        a.close()
        b.close()
    assert was_bin == bin_hdr and nbytes == jn
    assert h == (_as_decoded(header) if bin_hdr else header)
    assert set(out) == set(arrays)
    for k, v in arrays.items():
        assert out[k].dtype == v.dtype and out[k].shape == v.shape
        np.testing.assert_array_equal(out[k], v)


def test_send_and_recv_frame_helpers_interoperate():
    """``send_frame`` returns the bytes it put on the wire; the other
    package's ``recv_frame`` / ``recv_frame_sized`` read the same frame."""
    arrays = {"keys": np.arange(5, dtype=np.uint32), "g": np.ones((5, 2), np.float32)}
    for src, dst in ((T, J), (J, T)):
        a, b = socket.socketpair()
        try:
            n = src.send_frame(a, {"cmd": "pull", "_seq": 4}, arrays)
            h, out = dst.recv_frame(b)
            assert h == {"cmd": "pull", "_seq": 4}
            np.testing.assert_array_equal(out["g"], arrays["g"])
            assert dst.send_frame(b, {"ok": True}) == src.recv_frame_sized(a)[2]
            assert n > 0
        finally:
            a.close()
            b.close()


def test_compression_decisions_match():
    rng = np.random.default_rng(1)
    cases = [
        rng.normal(size=4096).astype(np.float32),
        np.full(4096, 0.25, np.float32),
        np.zeros(300, np.float32),  # 1200 bytes: over the floor, compresses
        np.ones(200, np.float32),  # 800 bytes: under the floor
        np.arange(4096, dtype=np.int64),
        rng.integers(-127, 128, 4096).astype(np.int8),
        np.full(4096, 1.5, np.float16),
        np.repeat(rng.normal(size=64), 64),  # f64, compresses
        np.concatenate([rng.normal(size=512), np.zeros(1 << 14)]).astype(np.float32),
    ]
    for a in cases:
        assert T._compressible(a) == J._compressible(a)
        view = memoryview(a).cast("B")
        assert T._try_compress(view) == J._try_compress(view)
    assert t_counters.get("wire_comp_skipped") == j_counters.get("wire_comp_skipped")


# ---------------------------------------------------------------------------
# the RPC layer
# ---------------------------------------------------------------------------


class _Counting:
    """A handler that counts each command's applies and can hold them."""

    def __init__(self, gate: threading.Event | None = None):
        self.applied: list = []
        self._gate = gate
        self._lock = threading.Lock()

    def __call__(self, h, a):
        if h["cmd"] == "shutdown":
            raise T.RpcServer.Shutdown
        if self._gate is not None:
            self._gate.wait(10)
        with self._lock:
            self.applied.append(h.get("i"))
        return {"ok": True, "i": h.get("i")}, {"w": a.get("g", np.zeros(1)) * 2}


def test_client_pipelines_a_window_of_8():
    gate = threading.Event()
    handler = _Counting(gate)
    srv = T.RpcServer(handler).start()
    cli = T.RpcClient(srv.address, window=8)
    try:
        futs = [cli.call_async("push", {"g": np.full(4, i, np.float32)}, i=i)
                for i in range(8)]
        # all 8 are in flight at once while the handler is held
        assert t_counters.get("rpc_inflight_peak") == 8
        gate.set()
        for i, f in enumerate(futs):
            rep, out = f.result(timeout=30)
            assert rep["i"] == i
            np.testing.assert_array_equal(out["w"], np.full(4, 2 * i, np.float32))
        assert sorted(handler.applied) == list(range(8))
        assert cli._bin_gen_ok  # the first reply negotiated binary headers
    finally:
        cli.close()
        srv.stop()


def test_resent_push_is_replayed_from_the_reply_cache():
    handler = _Counting()
    srv = T.RpcServer(handler).start()
    cli = T.RpcClient(srv.address)
    try:
        first, _ = cli.call("push", _seq="k1", i=1)
        again, _ = cli.call("push", _seq="k1", i=1)  # the same identity
        assert first["i"] == again["i"] == 1
        assert handler.applied == [1]
        assert t_counters.get("rpc_dedup_hits") == 1
        cli.call("push", _seq="k2", i=2)
        assert handler.applied == [1, 2]
    finally:
        cli.close()
        srv.stop()


def test_heal_resends_the_window_exactly_once():
    gate = threading.Event()
    handler = _Counting(gate)
    srv = T.RpcServer(handler).start()
    cli = T.RpcClient(srv.address, window=8, reconnect_timeout_s=30.0)
    try:
        futs = [cli.call_async("push", i=i) for i in range(8)]
        # the connection dies with the whole window in flight
        cli._sock.shutdown(socket.SHUT_RDWR)
        gate.set()
        assert [f.result(timeout=30)[0]["i"] for f in futs] == list(range(8))
        assert sorted(handler.applied) == list(range(8))  # exactly once
        assert t_counters.get("rpc_reconnects") >= 1
    finally:
        cli.close()
        srv.stop()


@pytest.mark.parametrize("pair", ["jax_client_torch_server", "torch_client_jax_server"])
@pytest.mark.parametrize("codec", ["bin", "json"])
def test_clients_and_servers_of_both_packages_interoperate(pair, codec):
    cli_mod, srv_mod = (J, T) if pair == "jax_client_torch_server" else (T, J)
    applied = []

    def handler(h, a):
        applied.append(h.get("i"))
        return {"ok": True, "i": h.get("i")}, {"w": a["g"] + 1}

    srv = srv_mod.RpcServer(handler).start()
    cli = cli_mod.RpcClient(srv.address, window=4, hdr_codec=codec)
    try:
        futs = [cli.call_async("push", {"g": np.full(3, i, np.float32)}, i=i)
                for i in range(12)]
        for i, f in enumerate(futs):
            rep, out = f.result(timeout=30)
            assert rep["i"] == i
            np.testing.assert_array_equal(out["w"], np.full(3, i + 1, np.float32))
        rep, _ = cli.call("push", {"g": np.zeros(1, np.float32)}, _seq="k0", i=99)
        cli.call("push", {"g": np.zeros(1, np.float32)}, _seq="k0", i=99)
        assert sorted(applied) == [*range(12), 99]
        assert cli._bin_gen_ok == (codec == "bin")
    finally:
        cli.close()
        srv.stop()


def test_fault_plans_are_refused_not_ignored(monkeypatch):
    """A fault plan is armed, never ignored: passed in, or read from
    ``PS_FAULT_PLAN`` / ``PS_FAULT_SEED`` when a server is built, and it
    acts on the frames (a dropped echo is resent and applied once)."""
    from parameter_server_tpu_torch.parallel.chaos import PLAN_ENV, SEED_ENV, FaultPlan

    applies = []

    def handler(h, a):
        applies.append(h["cmd"])
        return {"ok": True, "n": len(applies)}, {}

    srv = T.RpcServer(handler, fault_plan=FaultPlan.parse("drop,every=2")).start()
    cli = T.RpcClient(srv.address, reconnect_timeout_s=20.0)
    try:
        assert [cli.call("echo")[0]["n"] for _ in range(4)] == [1, 2, 3, 4]
        assert srv.fault_stats()["drop"] >= 1 and t_counters.get("rpc_retries") >= 1
    finally:
        cli.close()
        srv.stop()
    monkeypatch.setenv(PLAN_ENV, "drop,cmd=push,every=4")
    monkeypatch.setenv(SEED_ENV, "5")
    srv = T.RpcServer(lambda h, a: ({"ok": True}, {}))
    try:
        assert srv.fault_plan is not None and srv.fault_plan.seed == 5
        assert srv.fault_stats() == {"frames": 0, "drop": 0}
    finally:
        srv.stop()
    monkeypatch.delenv(PLAN_ENV)
    srv = T.RpcServer(lambda h, a: ({"ok": True}, {}))
    assert srv.fault_stats() is None
    srv.stop()


def _echo_server():
    return T.RpcServer(lambda h, a: ({"ok": True, "i": h.get("i")}, {})).start()


def test_adaptive_window_off_by_default():
    srv = _echo_server()
    cli = T.RpcClient(srv.address, window=6)
    try:
        for _ in range(5):
            cli.call("echo")
        assert cli.effective_window == 6
    finally:
        cli.close()
        srv.stop()


def test_adaptive_window_shrinks_and_grows_as_jax():
    """The same latency drive as the JAX package's
    ``TestAdaptiveWindow``, fed to both clients: the same effective
    windows after each adaptation, the same counters."""
    seen = {}
    for name, mod, counters in (("torch", T, t_counters), ("jax", J, j_counters)):
        srv = mod.RpcServer(lambda h, a: ({"ok": True}, {})).start()
        cli = mod.RpcClient(srv.address, window=8, adaptive_window=True)
        log = []
        try:
            for lat, saturate in ((0.001, False), (0.001, False), (0.5, False),
                                  (0.001, True), (0.001, True), (0.2, False)):
                for _ in range(64):
                    cli._lat_hist.observe(lat)
                if saturate:
                    with cli._cv:
                        cli._adapt_peak = cli.effective_window
                cli._maybe_adapt()
                log.append(cli.effective_window)
            log.append((counters.get("wire_window_shrinks"), counters.get("wire_window_grows")))
        finally:
            cli.close()
            srv.stop()
        seen[name] = log
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][:5] == [8, 8, 4, 5, 6]


def test_adaptive_client_still_correct_end_to_end():
    applies = []

    def handler(header, arrays):
        applies.append(header.get("i"))
        return {"ok": True, "i": header.get("i")}, {}

    srv = T.RpcServer(handler).start()
    cli = T.RpcClient(srv.address, window=4, adaptive_window=True)
    try:
        futs = [cli.call_async("echo", i=i) for i in range(200)]
        assert [f.result(timeout=30)[0]["i"] for f in futs] == list(range(200))
        assert sorted(applies) == list(range(200))
        assert 1 <= cli.effective_window <= 4
    finally:
        cli.close()
        srv.stop()


def test_handler_errors_and_shutdown_reach_the_client():
    def handler(h, a):
        if h["cmd"] == "shutdown":
            raise T.RpcServer.Shutdown
        raise ValueError("boom")

    srv = T.RpcServer(handler).start()
    cli = T.RpcClient(srv.address)
    try:
        with pytest.raises(RuntimeError, match="boom"):
            cli.call("push")
        assert cli.call("shutdown")[0]["ok"]
        assert srv._stop.wait(10)  # the server stops right after its reply
    finally:
        cli.close()
        srv.stop()
