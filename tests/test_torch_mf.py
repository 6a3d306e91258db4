"""Port parity for matrix factorization (single-device), on the CPU.

The same ratings (numpy, seeded) go through the JAX ``MatrixFactorization``
and the port's. The initial tables are equal bit for bit (the same float64
draws, cast once). Steps from a shared state agree within rtol 1e-5 /
atol 1e-6: XLA's segment sums and torch's ``index_add_`` add in different
orders. Epoch RMSEs agree within rtol 1e-4, where those differences have
compounded over an epoch. The JAX app test cases of tests/test_apps.py run
here against the port."""

import json

import numpy as np
import pytest
import torch

from parameter_server_tpu import cli as JC
from parameter_server_tpu.models import matrix_fac as JM
from parameter_server_tpu.parallel.ssp import DispatchWindow as JWindow
from parameter_server_tpu.utils.metrics import ProgressReporter as JR
from parameter_server_tpu_torch import cli as TC
from parameter_server_tpu_torch.models import matrix_fac as TM
from parameter_server_tpu_torch.ops import adagrad_kernels as ak
from parameter_server_tpu_torch.parallel.ssp import DispatchWindow as TWindow
from parameter_server_tpu_torch.utils.metrics import ProgressReporter as TR

torch.set_num_threads(1)

STEP_TOL = {"rtol": 1e-5, "atol": 1e-6}


def quiet():
    return TR(print_fn=lambda *a: None)


def _apps(nu=95, ni=63, rank=8, **kw):
    j = JM.MatrixFactorization(nu, ni, rank=rank, reporter=JR(print_fn=lambda *a: None), **kw)
    t = TM.MatrixFactorization(nu, ni, rank=rank, reporter=quiet(), device="cpu", **kw)
    return j, t


def make_ratings(n_users=200, n_items=100, rank=4, n_obs=8000, noise=0.05, seed=0):
    """tests/test_apps.py's low-rank ratings."""
    rng = np.random.default_rng(seed)
    U = rng.normal(scale=1.0 / np.sqrt(rank), size=(n_users, rank))
    V = rng.normal(scale=1.0 / np.sqrt(rank), size=(n_items, rank))
    users = rng.integers(0, n_users, n_obs)
    items = rng.integers(0, n_items, n_obs)
    r = np.sum(U[users] * V[items], axis=1) + noise * rng.normal(size=n_obs)
    return users, items, r.astype(np.float32)


@pytest.mark.parametrize("seed,rank", [(0, 8), (3, 64)])
def test_initial_tables_equal_jax_bit_for_bit(seed, rank):
    j, t = _apps(rank=rank, seed=seed)
    for jst, tst in ((j.user_state, t.user_state), (j.item_state, t.item_state)):
        assert set(jst) == set(tst) == {"w", "n"}
        for k in jst:
            np.testing.assert_array_equal(tst[k].numpy(), np.asarray(jst[k]))
    assert not t.user_state["w"][0].any() and not t.item_state["w"][0].any()


@pytest.mark.parametrize("algo", ["adagrad", "sgd"])
def test_train_steps_match_jax_from_shared_state(algo):
    users, items, r = make_ratings(94, 62, n_obs=4000, seed=1)
    j, t = _apps(eta=0.1, l2=0.01, algo=algo, seed=2)
    j.train_epoch(users[:2000], items[:2000], r[:2000], batch_size=256)
    t.load_state({k: np.asarray(v) for k, v in j.user_state.items()},
                 {k: np.asarray(v) for k, v in j.item_state.items()})
    builder = JM.MFBatchBuilder(256)
    ak.reset_launches()
    for s in range(2000, 2000 + 3 * 256, 256):
        b = builder.build(users[s:s + 256], items[s:s + 256], r[s:s + 256])
        j.user_state, j.item_state, jloss = JM.mf_train_step(
            j.user_up, j.item_up, j.user_state, j.item_state,
            JM.batch_to_device(b), j.l2,
        )
        _, _, tloss = TM.mf_train_step(
            t.user_up, t.item_up, t.user_state, t.item_state,
            TM.batch_to_device(b, "cpu"), t.l2,
        )
        np.testing.assert_allclose(float(tloss), float(jloss), **STEP_TOL)
        st = t.state_dict()
        for name, jst in (("user", j.user_state), ("item", j.item_state)):
            for k in jst:
                np.testing.assert_allclose(st[name][k], np.asarray(jst[k]), **STEP_TOL)
    assert ak.LAUNCHES == {"adagrad_push": 0}  # CPU: the plain path


@pytest.mark.parametrize("steps_per_call", [1, 3])
def test_train_epoch_rmse_matches_jax(steps_per_call):
    users, items, r = make_ratings(94, 62, n_obs=3000, seed=4)
    j, t = _apps(eta=0.1, l2=0.01, steps_per_call=steps_per_call, max_delay=1)
    for ep in range(3):
        a = j.train_epoch(users, items, r, batch_size=256, seed=ep)
        b = t.train_epoch(users, items, r, batch_size=256, seed=ep)
        np.testing.assert_allclose(b, a, rtol=1e-4)
    assert t.reporter.history[-1]["examples"] == j.reporter.history[-1]["examples"] == 3000
    np.testing.assert_allclose(t.rmse(users, items, r), j.rmse(users, items, r), rtol=1e-4)
    np.testing.assert_allclose(t.predict(users[:50], items[:50]),
                               j.predict(users[:50], items[:50]), rtol=1e-4, atol=1e-5)


def test_state_dict_round_trip_and_checks():
    j, t = _apps(seed=5)
    st = t.state_dict()
    st["user"]["w"][3] = 7.0
    t.load_state(st["user"], st["item"])
    assert float(t.user_state["w"][3, 0]) == 7.0
    with pytest.raises(ValueError, match="does not match"):
        t.load_state({"w": st["user"]["w"]}, st["item"])
    with pytest.raises(ValueError, match="does not match"):
        t.load_state(st["user"], {"w": st["item"]["w"][:5], "n": st["item"]["n"]})
    with pytest.raises(IndexError, match="user id"):
        t.predict(np.array([95]), np.array([0]))
    with pytest.raises(IndexError, match="item id"):
        t.train_epoch(np.array([0]), np.array([-1]), np.ones(1, np.float32))


@pytest.mark.parametrize("kw,match", [
    ({"mesh": object(), "push_mode": "quantized"}, "push_mode"),
    ({"steps_per_call": 0}, "steps_per_call"),
])
def test_unported_and_bad_options_raise(kw, match):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        TM.MatrixFactorization(4, 4, device="cpu", **kw)


@pytest.mark.parametrize("push_mode", ["aggregate", "quantized"])
def test_push_mode_is_ignored_on_one_device_like_jax(push_mode):
    """One device: the JAX app stores push_mode and never reads it; the
    port accepts it too, and trains as with per_worker (RMSE rtol 1e-4,
    as test_train_epoch_rmse_matches_jax)."""
    users, items, r = make_ratings(94, 62, n_obs=2000, seed=6)
    j, t = _apps(eta=0.1, l2=0.01, push_mode=push_mode)
    _, ref = _apps(eta=0.1, l2=0.01)
    for ep in range(2):
        a = j.train_epoch(users, items, r, batch_size=256, seed=ep)
        b = t.train_epoch(users, items, r, batch_size=256, seed=ep)
        np.testing.assert_allclose(b, a, rtol=1e-4)
        assert ref.train_epoch(users, items, r, batch_size=256, seed=ep) == b


@pytest.mark.parametrize("max_delay", [0, 2])
def test_dispatch_window_matches_jax(max_delay):
    log = {"jax": [], "torch": []}
    windows = {
        "jax": JWindow(max_delay, lambda s, e: log["jax"].append((s, e))),
        "torch": TWindow(max_delay, lambda s, e: log["torch"].append((s, e))),
    }
    for name, w in windows.items():
        for t in range(6):
            w.gate(t)
            log[name].append(("in flight", len(w)))
            w.add(t, t * 10)
        w.drain()
    assert log["torch"] == log["jax"]
    assert windows["torch"].max_inflight == windows["jax"].max_inflight == max_delay + 1


# --- tests/test_apps.py's MF cases, single-device, on the port -------------


def test_recovers_low_rank_structure():
    users, items, r = make_ratings()
    n_tr = 7000
    mf = TM.MatrixFactorization(200, 100, rank=8, eta=0.1, l2=0.002,
                                reporter=quiet(), seed=1, device="cpu")
    rmse0 = mf.rmse(users[n_tr:], items[n_tr:], r[n_tr:])
    for ep in range(30):
        mf.train_epoch(users[:n_tr], items[:n_tr], r[:n_tr], seed=ep)
    rmse = mf.rmse(users[n_tr:], items[n_tr:], r[n_tr:])
    assert rmse < rmse0 * 0.5, (rmse0, rmse)
    assert rmse < 0.25, rmse  # close to the noise floor


def test_duplicate_pairs_in_batch():
    mf = TM.MatrixFactorization(4, 4, rank=2, reporter=quiet(), device="cpu")
    users = np.array([1, 1, 1, 2])
    items = np.array([0, 0, 1, 1])
    r = np.ones(4, dtype=np.float32)
    for _ in range(5):
        mf.train_epoch(users, items, r, batch_size=4)
    assert np.isfinite(mf.predict(users, items)).all()


def test_builder_capacity():
    b = TM.MFBatchBuilder(batch_size=2)
    with pytest.raises(ValueError, match="pairs"):
        b.build(np.arange(3), np.arange(3), np.ones(3, dtype=np.float32))


def test_bad_algo():
    with pytest.raises(ValueError, match="mf algo"):
        TM.MatrixFactorization(4, 4, algo="ftrl", device="cpu")


def _write_ratings(tmp_path, n=6000, n_u=96, n_i=64, seed=0):
    us, it, r = make_ratings(n_users=n_u - 1, n_items=n_i - 1, rank=4, n_obs=n, seed=seed)
    paths = []
    for i in range(3):
        p = tmp_path / f"ratings-{i}.txt"
        sl = slice(i * n // 3, (i + 1) * n // 3)
        with open(p, "w") as f:
            for u, v, x in zip(us[sl], it[sl], r[sl]):
                f.write(f"{u} {v} {x:.5f}\n")
        paths.append(str(p))
    return paths, (us, it, r)


def test_blocks_roundtrip_matches_jax(tmp_path):
    paths, (us, it, r) = _write_ratings(tmp_path, n=600)
    got = list(TM.iter_rating_blocks(paths, block_lines=100))
    want = list(JM.iter_rating_blocks(paths, block_lines=100))
    assert len(got) == len(want) and all(len(b[0]) <= 100 for b in got)
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate([b[0] for b in got]), us[:600])
    np.testing.assert_allclose(np.concatenate([b[2] for b in got]), r[:600], atol=1e-4)


def test_trains_from_files_and_matches_jax(tmp_path):
    paths, _ = _write_ratings(tmp_path)
    j, t = _apps(rank=8, eta=0.1, l2=0.002)
    first = t.train_files(paths, batch_size=500, block_lines=1500, seed=0)
    np.testing.assert_allclose(
        first, j.train_files(paths, batch_size=500, block_lines=1500, seed=0), rtol=1e-4
    )
    last = first
    for ep in range(1, 10):
        last = t.train_files(paths, batch_size=500, block_lines=1500, seed=ep)
    assert last < first * 0.7, (first, last)


def test_unparseable_files_raise(tmp_path):
    p = tmp_path / "ratings.csv"
    p.write_text("1,2,3.5\n4,5,2.0\n")  # comma-separated: wrong format
    mf = TM.MatrixFactorization(95, 63, rank=4, reporter=quiet(), device="cpu")
    with pytest.raises(ValueError, match="no rating triples"):
        mf.train_files([str(p)])


# --- the CLI ------------------------------------------------------------------


def _cli_data(tmp_path):
    """tests/test_checkpoint_cli.py's matrix_fac data and config, without
    the mesh."""
    rng = np.random.default_rng(0)
    n, n_u, n_i = 4000, 96, 64
    U = rng.normal(size=(n_u, 4)) / 2
    V = rng.normal(size=(n_i, 4)) / 2
    us = rng.integers(0, n_u - 1, n)
    it = rng.integers(0, n_i - 1, n)
    r = (np.sum(U[us] * V[it], 1)).astype(np.float32)
    tr_p, val_p = tmp_path / "tr.txt", tmp_path / "val.txt"
    for p, sl in ((tr_p, slice(0, 3500)), (val_p, slice(3500, None))):
        with open(p, "w") as f:
            for u, v, x in zip(us[sl], it[sl], r[sl]):
                f.write(f"{u} {v} {x:.5f}\n")
    cfg = {
        "app": "matrix_fac",
        "data": {"files": [str(tr_p)], "val_files": [str(val_p)]},
        "mf": {"num_users": n_u - 1, "num_items": n_i - 1, "rank": 8,
               "eta": 0.1, "l2": 0.002, "batch_size": 500},
        "solver": {"epochs": 12, "steps_per_call": 3},
    }
    p = tmp_path / "mf.json"
    p.write_text(json.dumps(cfg))
    return p, n_u


def test_cli_train_matrix_fac_matches_jax(tmp_path, capsys):
    app_file, n_u = _cli_data(tmp_path)
    jm, tm = tmp_path / "jax.npz", tmp_path / "torch.npz"
    assert JC.main(["train", "--app_file", str(app_file), "--model_out", str(jm)]) == 0
    jout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert TC.main(["train", "--app_file", str(app_file), "--model_out", str(tm),
                    "--device", "cpu"]) == 0
    tout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tout["val_rmse"] < 0.45, tout
    np.testing.assert_allclose(tout["val_rmse"], jout["val_rmse"], rtol=1e-4)
    np.testing.assert_allclose(tout["train_rmse"], jout["train_rmse"], rtol=1e-4)
    assert tout["val_examples"] == jout["val_examples"] == 500
    assert tout["rank"] == jout["rank"] == 8
    jz, tz = np.load(jm), np.load(tm)
    for k in ("user_factors", "item_factors"):
        assert tz[k].shape == jz[k].shape and tz[k].dtype == jz[k].dtype
    assert tz["user_factors"].shape == (n_u, 8)


def test_cli_train_matrix_fac_aggregate_on_one_device_matches_jax(tmp_path, capsys):
    """parallel.push_mode = "aggregate" on one device: the JAX CLI runs it
    (the app ignores the setting), and so does the port's, with the same
    RMSEs (rtol 1e-4, as test_cli_train_matrix_fac_matches_jax)."""
    app_file, _ = _cli_data(tmp_path)
    cfg = json.loads(app_file.read_text())
    cfg["parallel"] = {"push_mode": "aggregate"}
    cfg["solver"]["epochs"] = 4
    app_file.write_text(json.dumps(cfg))
    assert JC.main(["train", "--app_file", str(app_file)]) == 0
    jout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert TC.main(["train", "--app_file", str(app_file), "--device", "cpu"]) == 0
    tout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    for k in ("train_rmse", "val_rmse"):
        np.testing.assert_allclose(tout[k], jout[k], rtol=1e-4)
    assert tout["val_examples"] == jout["val_examples"] == 500


@pytest.mark.parametrize("argv,section", [
    (["train", "--ckpt_dir", "ck"], {}),
    (["train", "--ckpt_dir", "ck"], {"parallel": {"data_shards": 2, "kv_shards": 4}}),
    (["evaluate", "--model", "m.npz"], {}),
])
def test_cli_matrix_fac_refuses_unsupported(tmp_path, argv, section):
    app_file = tmp_path / "cfg.json"
    app_file.write_text(json.dumps({"app": "matrix_fac", "data": {"files": ["x"]},
                                    **section}))
    with pytest.raises(SystemExit, match="matrix_fac|not ported yet"):
        TC.main([*argv, "--app_file", str(app_file), "--device", "cpu"])

