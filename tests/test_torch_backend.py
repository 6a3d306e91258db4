"""The port's KV backends (``parallel/backend.py``, ``parallel/meshbackend.py``)
held to each other and to the JAX package, as ``tests/test_backend.py``
holds the JAX backends: ``train_linear`` is the same client code on both
transports, so the f32 socket and mesh arms agree exactly (same updater
math, same apply order, no stochastic part); the int8 mesh arm keeps its
AUC within 0.002 of the f32 arm's; the error feedback telescopes exactly;
a table that does not divide the kv ranks pads up (on a kv=2 gloo world of
rank processes); and the port's socket backend gives the JAX package's
probabilities within 1e-4 (float32 tables, float64 host math: they agree
to ~1e-9 here). ``cli backend --device cpu`` runs both transports."""

from __future__ import annotations

import json
from concurrent.futures import Future

import numpy as np
import pytest
import torch
from _torch_world import rank_argvs, run_world

from parameter_server_tpu.kv import updaters as JU
from parameter_server_tpu.parallel import backend as JB
from parameter_server_tpu_torch.kv.updaters import Ftrl, Sgd
from parameter_server_tpu_torch.parallel.backend import (
    SocketBackend,
    local_socket_backend,
    make_backend,
    train_linear,
)
from parameter_server_tpu_torch.parallel.meshbackend import MeshBackend
from parameter_server_tpu_torch.utils.config import PSConfig
from parameter_server_tpu_torch.utils.keyrange import KeyRange

torch.set_num_threads(1)

NUM_KEYS = 1 << 12
FTRL = {"alpha": 1.0, "beta": 1.0, "lambda_l1": 1e-4}


def _updater() -> Ftrl:
    # alpha/l1 sized for per-example-MEAN gradients (the train_linear
    # normalization); the default l1=1 would pin every weight at zero
    return Ftrl(**FTRL)


def _workload(seed: int = 3, nnz: int = 16, bsz: int = 256, nb: int = 8):
    rng = np.random.default_rng(seed)
    w_true = rng.normal(size=NUM_KEYS - 1) * 1.2
    kb = rng.integers(0, NUM_KEYS - 1, size=(bsz * nb, nnz))
    logits = w_true[kb].sum(axis=1) / np.sqrt(nnz)
    y = (rng.random(bsz * nb) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    return kb, y, bsz


def _socket_run(kb, y, bsz, num_servers=2):
    sb = local_socket_backend(_updater, NUM_KEYS, num_servers, device="cpu")
    try:
        return train_linear(sb, kb, y, bsz), sb.weights()
    finally:
        sb.close()


def _mesh_run(kb, y, bsz, quant="off"):
    mb = MeshBackend(_updater(), NUM_KEYS, quant=quant, device="cpu")
    try:
        return train_linear(mb, kb, y, bsz), mb.weights()
    finally:
        mb.close()


@pytest.fixture(scope="module")
def runs():
    kb, y, bsz = _workload()
    return {"data": (kb, y, bsz), "socket": _socket_run(kb, y, bsz),
            "mesh": _mesh_run(kb, y, bsz), "mesh_int8": _mesh_run(kb, y, bsz, "int8")}


class TestBackendParity:
    def test_f32_socket_and_mesh_agree_exactly(self, runs):
        (out_s, w_s), (out_m, w_m) = runs["socket"], runs["mesh"]
        np.testing.assert_array_equal(out_m["probs"], out_s["probs"])
        np.testing.assert_array_equal(w_m, w_s)
        assert out_m["auc"] == out_s["auc"]
        assert np.count_nonzero(w_s) > 0

    def test_int8_collective_holds_auc_within_the_bound(self, runs):
        auc_f32 = runs["mesh"][0]["auc"]
        auc_int8 = runs["mesh_int8"][0]["auc"]
        assert abs(auc_int8 - auc_f32) <= 0.002, (auc_int8, auc_f32)
        assert auc_int8 > 0.55  # the quantized arm genuinely learned

    def test_socket_backend_matches_the_jax_package(self):
        kb, y, bsz = _workload(nb=4)
        jb = JB.local_socket_backend(lambda: JU.Ftrl(**FTRL), NUM_KEYS, 2)
        try:
            out_j = JB.train_linear(jb, kb, y, bsz, progress_from=0.0)
        finally:
            jb.close()
        sb = local_socket_backend(_updater, NUM_KEYS, 2, device="cpu")
        try:
            out_t = train_linear(sb, kb, y, bsz, progress_from=0.0)
        finally:
            sb.close()
        np.testing.assert_allclose(out_t["probs"], out_j["probs"], rtol=0, atol=1e-4)
        assert abs(out_t["auc"] - out_j["auc"]) <= 1e-4


class TestMeshBackend:
    def test_error_feedback_telescopes_exactly(self):
        """With SGD(eta=1) the table weight is -sum(decoded pushes), and
        error feedback telescopes: sum(decoded) = sum(true grads) - final
        residual, iff every logical push folded and applied exactly once."""
        rng = np.random.default_rng(7)
        mb = MeshBackend(Sgd(eta=1.0), 256, quant="int8", quant_seg=32, device="cpu")
        try:
            keys = np.arange(1, 129, dtype=np.int64)
            total = np.zeros((128, 1), np.float32)
            for _ in range(6):
                g = (rng.normal(size=(128, 1)) * 0.1).astype(np.float32)
                total += g
                mb.push(keys, g)
            mb.flush()
            w = mb.weights()[keys]
            res = mb.residual_rows(keys)
            np.testing.assert_allclose(w, -(total - res), atol=1e-5)
            assert mb.residual_norm() > 0.0  # int8 really quantized
        finally:
            mb.close()

    def test_int8_payload_is_the_jax_backends_encode(self):
        """The quantized push encodes the JAX backend's layout with its
        numpy codec and seed counter: the same residuals after the same
        pushes, to the float32 rounding of the fold."""
        from parameter_server_tpu.parallel.meshbackend import MeshBackend as JMesh

        rng = np.random.default_rng(2)
        keys = np.unique(rng.integers(1, 200, 90)).astype(np.int64)
        jm = JMesh(JU.Sgd(eta=1.0), 256, kv_shards=1, quant="int8", quant_seg=32)
        tm = MeshBackend(Sgd(eta=1.0), 256, quant="int8", quant_seg=32, device="cpu")
        try:
            for _ in range(4):
                g = rng.normal(size=len(keys)).astype(np.float32)
                jm.push(keys, g)
                tm.push(keys, g)
            np.testing.assert_array_equal(tm.residual_rows(keys), jm.residual_rows(keys))
            np.testing.assert_allclose(tm.weights(), jm.weights(), rtol=1e-6, atol=1e-7)
        finally:
            tm.close()

    def test_empty_and_async_paths(self):
        mb = MeshBackend(Sgd(eta=1.0), 64, device="cpu")
        try:
            assert mb.pull(np.zeros(0, np.int64)).shape == (0, 1)
            assert mb.pull_async(np.zeros(0, np.int64)).result().shape == (0, 1)
            mb.push(np.zeros(0, np.int64), np.zeros((0, 1), np.float32))
            keys = np.array([3, 9], dtype=np.int64)
            assert mb.push_async(keys, np.ones(2, np.float32)).result() is None
            np.testing.assert_allclose(mb.pull_async(keys).result().ravel(), -1.0)
            bad = mb.push_async(keys, np.ones(3, np.float32))  # wrong length
            with pytest.raises(ValueError):
                bad.result()
        finally:
            mb.close()

    def test_validation(self):
        with pytest.raises(ValueError, match="quant"):
            MeshBackend(Sgd(), 64, quant="int4", device="cpu")
        with pytest.raises(ValueError, match="kv_shards"):
            MeshBackend(Sgd(), 64, kv_shards=4, device="cpu")
        cfg = PSConfig()
        cfg.mesh.backend = "bogus"
        with pytest.raises(ValueError, match="backend"):
            make_backend(cfg, device="cpu")
        cfg.mesh.backend = "socket"
        with pytest.raises(ValueError, match="socket"):
            make_backend(cfg, device="cpu")  # needs handles + ranges

    def test_make_backend_mesh_from_config(self):
        cfg = PSConfig()
        cfg.app = "linear_method"
        cfg.data.num_keys = 128
        cfg.mesh.backend = "mesh"
        cfg.mesh.quant = "int8"
        be = make_backend(cfg, device="cpu")
        try:
            assert isinstance(be, MeshBackend)
            assert be.mesh.kv == 1 and be._quant_bytes == 1
            assert be.stats()["table_rows"] == 128
        finally:
            be.close()

    def test_entry_points_raise_without_a_card(self):
        if torch.cuda.is_available():
            pytest.skip("a card is present: the default device is usable here")
        with pytest.raises(RuntimeError, match="cuda"):
            MeshBackend(Sgd(), 64)
        with pytest.raises(RuntimeError, match="cuda"):
            local_socket_backend(Sgd, 64)


def test_kv2_world_pads_an_odd_table_and_matches_the_socket_backend(runs, tmp_path):
    """A kv=2 gloo world of rank processes: 1001 keys pad to 1002 rows (the
    pad row invisible), and train_linear's probabilities and weights are
    the socket backend's, exactly; int8 keeps its AUC bound and the
    error feedback telescopes."""
    kb, y, bsz = runs["data"]
    rng = np.random.default_rng(7)
    tele = [(rng.normal(size=(128, 1)) * 0.1).astype(np.float32) for _ in range(6)]
    np.savez(tmp_path / "in.npz", kb=kb, y=y, **{f"tele{i}": t for i, t in enumerate(tele)})
    plan = tmp_path / "plan.json"
    plan.write_text(json.dumps({
        "mesh": [1, 2], "inputs": str(tmp_path / "in.npz"), "out": str(tmp_path),
        "odd_keys": 1001, "odd_push": [1, 500, 501, 999, 1000], "num_keys": NUM_KEYS,
        "ftrl": FTRL, "batch": bsz,
    }))
    run_world(rank_argvs("backend", plan, 2))
    ranks = [dict(np.load(tmp_path / f"rank{r}.npz")) for r in range(2)]
    for r in ranks:
        np.testing.assert_array_equal(r["odd/rows"], [1002, 501])
        w = r["odd/weights"]
        assert w.shape == (1001, 1) and np.count_nonzero(w) == 5
        np.testing.assert_allclose(w[[1, 500, 501, 999, 1000], 0], -0.5)
        np.testing.assert_allclose(r["odd/pull"].ravel(), -0.5)
        np.testing.assert_array_equal(r["odd/pull_async"], r["odd/pull"])
        (out_s, w_s) = runs["socket"]
        np.testing.assert_array_equal(r["train_off/probs"], out_s["probs"])
        np.testing.assert_array_equal(r["train_off/weights"], w_s)
        assert abs(float(r["train_int8/auc"]) - out_s["auc"]) <= 0.002
        total = np.sum(tele, axis=0)
        np.testing.assert_allclose(r["tele/weights"], -(total - r["tele/residual"]), atol=1e-5)
    for k in ranks[0]:
        np.testing.assert_array_equal(ranks[1][k], ranks[0][k])  # ranks agree


class TestSocketBackendFanout:
    def test_flush_raises_fire_and_forget_push_failure(self):
        class _BoomHandle:
            def push_async(self, seg, g):
                f: Future = Future()
                f.set_exception(RuntimeError("shard died"))
                return f

        sb = SocketBackend([_BoomHandle()], KeyRange(0, 64).even_divide(1), 64,
                           own_handles=False)
        sb.push_async(np.array([3], dtype=np.int64), np.ones(1, np.float32))
        with pytest.raises(RuntimeError, match="shard died"):
            sb.flush()
        sb.flush()  # the failure was consumed; the barrier is clean again

    def test_range_fanout_matches_direct_handles(self):
        sb = local_socket_backend(_updater, NUM_KEYS, 2, device="cpu")
        try:
            keys = np.array([1, 7, NUM_KEYS // 2 - 1, NUM_KEYS // 2, NUM_KEYS - 1],
                            dtype=np.int64)
            sb.push(keys, np.arange(1, 6, dtype=np.float32))
            sb.flush()
            via_backend = sb.pull(keys).ravel()
            lo = keys[keys < NUM_KEYS // 2]
            hi = keys[keys >= NUM_KEYS // 2] - NUM_KEYS // 2
            direct = np.concatenate([sb.handles[0].pull(lo), sb.handles[1].pull(hi)])
            np.testing.assert_array_equal(via_backend, direct)
            np.testing.assert_array_equal(sb.pull_async(keys).result(30).ravel(), direct)
            w = sb.weights()
            assert w.shape == (NUM_KEYS, 1) and np.count_nonzero(w) == len(keys)
            assert [s["pushes"] for s in sb.stats()["shards"]] == [1, 1]
        finally:
            sb.close()


@pytest.mark.parametrize("transport", ["socket", "mesh"])
def test_cli_backend_on_the_cpu(transport, tmp_path, capsys):
    from parameter_server_tpu_torch import cli

    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"data": {"num_keys": 4096}, "mesh": {"backend": transport},
                               "lr": {"alpha": 1.0}, "penalty": {"lambda_l1": 1e-4}}))
    assert cli.main(["backend", "--app_file", str(cfg), "--device", "cpu",
                     "--examples", "2048", "--batch", "512"]) == 0
    res = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert set(res) == {"backend", "auc", "examples", "ex_per_sec", "push_payload_mb",
                        "stats"}
    assert res["backend"] == transport and res["examples"] == 2048
    assert res["push_payload_mb"] > 0 and 0.0 < res["auc"] < 1.0
    assert res["stats"]["backend"] == transport
