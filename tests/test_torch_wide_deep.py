"""Port parity for the Wide&Deep app (single-device), on the CPU.

The same batches (numpy, seeded) go through the JAX ``WideDeep`` and the
port's. The initial tables and MLP are equal bit for bit (the same float64
draws, cast once; the port draws the embedding table in row chunks). One
step from a shared table state agrees within rtol 1e-5 / atol 1e-6: XLA's
segment sums and torch's ``index_add_`` add in different orders, and
``torch.optim.Adam`` rounds its bias correction differently from optax
(about 1e-7 relative a step). Runs of several steps agree within rtol
1e-4, where those differences have compounded. tests/test_apps.py's and
tests/test_checkpoint_cli.py's W&D cases run here against the port, on one
device."""

import copy
import json

import numpy as np
import pytest
import torch

from parameter_server_tpu import cli as JC
from parameter_server_tpu.data.batch import BatchBuilder as JBB
from parameter_server_tpu.data.synthetic import make_sparse_logistic
from parameter_server_tpu.models import wide_deep as JW
from parameter_server_tpu.models.linear import batch_to_device as jax_batch
from parameter_server_tpu.utils.metrics import ProgressReporter as JR
from parameter_server_tpu_torch import cli as TC
from parameter_server_tpu_torch.data.batch import BatchBuilder, CSRBatch
from parameter_server_tpu_torch.data.synthetic import write_libsvm
from parameter_server_tpu_torch.kv.store import state_from_numpy
from parameter_server_tpu_torch.models import wide_deep as TW
from parameter_server_tpu_torch.models.linear import batch_to_device
from parameter_server_tpu_torch.ops import adagrad_kernels as ak
from parameter_server_tpu_torch.ops import ftrl_kernels as fk
from parameter_server_tpu_torch.parallel.mesh import Mesh
from parameter_server_tpu_torch.utils.metrics import ProgressReporter as TR

torch.set_num_threads(1)

STEP_TOL = {"rtol": 1e-5, "atol": 1e-6}
RUN_TOL = {"rtol": 1e-4, "atol": 1e-5}
KW = {"emb_dim": 8, "hidden": [16, 8], "emb_eta": 0.05, "mlp_lr": 1e-2}


def quiet(cls=TR):
    return cls(print_fn=lambda *a: None)


def _apps(num_keys=4096, seed=1, **kw):
    j = JW.WideDeep(num_keys, reporter=quiet(JR), seed=seed, **{**KW, **kw})
    t = TW.WideDeep(num_keys, reporter=quiet(), seed=seed, device="cpu", **{**KW, **kw})
    return j, t


def _batches(n_batches=4, bs=256, seed=3, num_keys=4096):
    labels, keys, vals, _ = make_sparse_logistic(n_batches * bs, 3000, nnz_per_example=10,
                                                 seed=seed)
    b = JBB(num_keys=num_keys, batch_size=bs, max_nnz_per_example=40)
    return [b.build(labels[i:i + bs], keys[i:i + bs], vals[i:i + bs])
            for i in range(0, n_batches * bs, bs)]


def _assert_state(t, j, tol):
    st = t.state_dict()
    for name, jst in (("wide", j.wide_state), ("emb", j.emb_state)):
        assert set(st[name]) == set(jst)
        for k in jst:
            np.testing.assert_allclose(st[name][k], np.asarray(jst[k]), **tol,
                                       err_msg=f"{name}[{k}]")
    assert len(st["mlp"]) == len(j.mlp_params)
    for mine, theirs in zip(st["mlp"], j.mlp_params):
        for k in ("W", "b"):
            np.testing.assert_allclose(mine[k], np.asarray(theirs[k]), **tol)


@pytest.mark.parametrize("seed,chunk_rows", [(0, 7), (1, 300), (2, 693), (3, 1 << 20)])
def test_init_equals_jax_bit_for_bit(monkeypatch, seed, chunk_rows):
    """The embedding table drawn in chunks of ``chunk_rows`` rows (one
    chunk at 2^20) equals the JAX package's one-shot draw, and so do the
    MLP, the zero FTRL tables and AdaGrad's zero accumulator."""
    monkeypatch.setattr(TW, "INIT_CHUNK_ROWS", chunk_rows)
    j, t = _apps(num_keys=1000, seed=seed, emb_dim=16, hidden=[32, 16])
    st = t.state_dict()
    for name, jst in (("wide", j.wide_state), ("emb", j.emb_state)):
        for k in jst:
            np.testing.assert_array_equal(st[name][k], np.asarray(jst[k]))
    assert not st["emb"]["w"][0].any() and st["emb"]["w"][1:].any()
    assert [layer["W"].shape for layer in st["mlp"]] == [(16, 32), (32, 16), (16, 1)]
    for mine, theirs in zip(st["mlp"], j.mlp_params):
        for k in ("W", "b"):
            assert mine[k].dtype == np.float32
            np.testing.assert_array_equal(mine[k], np.asarray(theirs[k]))


def test_steps_match_jax_from_shared_tables():
    """4 steps of ``wd_train_step`` against the JAX step: before each step
    the port's tables are set to the JAX tables (the MLP and Adam carry
    on), then loss, probabilities, the touched z, n, w, n and the MLP agree
    at STEP_TOL. Pad slots move no row 0."""
    batches = _batches()
    j, t = _apps()
    fk.reset_launches()
    ak.reset_launches()
    for b in batches:
        t.wide_state = state_from_numpy({k: np.asarray(v) for k, v in j.wide_state.items()},
                                        "cpu")
        t.emb_state = state_from_numpy({k: np.asarray(v) for k, v in j.emb_state.items()},
                                       "cpu")
        (j.wide_state, j.emb_state, j.mlp_params, j.opt_state, jloss,
         jprobs) = JW.wd_train_step(j.wide_up, j.emb_up, j.opt, j.wide_state, j.emb_state,
                                    j.mlp_params, j.opt_state, jax_batch(b))
        tloss, tprobs = TW.wd_train_step(t.wide_up, t.emb_up, t.wide_state, t.emb_state,
                                         t.mlp, t.opt, batch_to_device(b, "cpu"),
                                         b.num_examples, b.num_unique)
        np.testing.assert_allclose(float(tloss), float(jloss), **STEP_TOL)
        np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), **STEP_TOL)
        _assert_state(t, j, STEP_TOL)
        assert not t.wide_state["z"][0].any() and not t.emb_state["w"][0].any()
    assert fk.LAUNCHES["ftrl_push"] == ak.LAUNCHES["adagrad_push"] == 0  # CPU: plain


@pytest.mark.parametrize("bs,nnz,capacity", [(40, 6, 1025), (128, 8, 4097)])
def test_step_pushes_only_the_real_prefix(monkeypatch, bs, nnz, capacity):
    """A batch whose unique capacity is far above its real count (over 90%
    pad slots): the step matches the JAX step, which pushes every slot, at
    STEP_TOL from shared tables; both pushes carry exactly ``num_unique``
    slots; row 0 and every untouched row keep their bits."""
    import parameter_server_tpu_torch.kv.store as store

    labels, keys, vals, _ = make_sparse_logistic(bs, 3000, nnz_per_example=nnz, seed=12)
    b = JBB(num_keys=4096, batch_size=bs, max_nnz_per_example=4 * nnz,
            unique_capacity=capacity).build(labels, keys, vals)
    assert b.unique_keys.shape == (capacity,) and b.num_unique < capacity // 10
    slots = []

    def counting(kernel):
        def run(a, b_, idx, g, **kw):
            slots.append(idx.shape[0])
            return kernel(a, b_, idx, g, **kw)
        return run

    for name in ("ftrl_push", "adagrad_push"):
        monkeypatch.setattr(store, name, counting(getattr(store, name)))
    j, t = _apps()
    t.wide_state = state_from_numpy({k: np.asarray(v) for k, v in j.wide_state.items()}, "cpu")
    t.emb_state = state_from_numpy({k: np.asarray(v) for k, v in j.emb_state.items()}, "cpu")
    before = t.state_dict()
    (j.wide_state, j.emb_state, j.mlp_params, j.opt_state, jloss,
     jprobs) = JW.wd_train_step(j.wide_up, j.emb_up, j.opt, j.wide_state, j.emb_state,
                                j.mlp_params, j.opt_state, jax_batch(b))
    tloss, tprobs = TW.wd_train_step(t.wide_up, t.emb_up, t.wide_state, t.emb_state, t.mlp,
                                     t.opt, batch_to_device(b, "cpu"), b.num_examples,
                                     b.num_unique)
    assert slots == [b.num_unique, b.num_unique]
    np.testing.assert_allclose(float(tloss), float(jloss), **STEP_TOL)
    np.testing.assert_allclose(tprobs.numpy(), np.asarray(jprobs), **STEP_TOL)
    _assert_state(t, j, STEP_TOL)
    untouched = np.ones(4096, dtype=bool)
    untouched[b.unique_keys[1:b.num_unique]] = False
    assert untouched[0] and untouched.sum() == 4096 - (b.num_unique - 1)
    after = t.state_dict()
    for name in ("wide", "emb"):
        for k in before[name]:
            np.testing.assert_array_equal(after[name][k][untouched].view(np.int32),
                                          before[name][k][untouched].view(np.int32))


@pytest.mark.parametrize("steps_per_call,max_delay", [(3, 1), (1, 0)])
def test_train_matches_jax(steps_per_call, max_delay):
    """7 batches through ``WideDeep.train``: with 3 steps a call the last
    group is partial (JAX pads it with inert batches, the port skips
    them). The progress rows and the final state agree at RUN_TOL."""
    batches = _batches(n_batches=7, seed=5)
    j, t = _apps(steps_per_call=steps_per_call, max_delay=max_delay)
    jr = j.train(batches, report_every=2)
    tr = t.train(batches, report_every=2)
    assert len(t.reporter.history) == len(j.reporter.history) == (2 if steps_per_call == 3 else 4)
    for a, b in zip(t.reporter.history, j.reporter.history):
        assert a["examples"] == b["examples"]
        np.testing.assert_allclose(a["objv"], b["objv"], **RUN_TOL)
        np.testing.assert_allclose(a["auc"], b["auc"], **RUN_TOL)
    assert tr["examples"] == jr["examples"] == t.examples_seen == 7 * 256
    _assert_state(t, j, RUN_TOL)
    ty, tp = t.predict(batches[:2])
    jy, jp = j.predict(batches[:2])
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_allclose(tp, jp, **RUN_TOL)


def _inert(b: CSRBatch) -> CSRBatch:
    """The JAX package's ``_inert_like``: b's shapes, every field zero."""
    return CSRBatch(**{f: np.zeros_like(getattr(b, f)) for f in
                       ("unique_keys", "local_ids", "row_ids", "values", "labels",
                        "example_mask", "row_splits")},
                    num_examples=0, num_unique=1, num_entries=0)


def test_inert_batch_is_a_no_op():
    """After a real step (Adam has moments), a batch with no examples
    leaves the tables, the MLP and Adam's state exactly as they were, as
    the JAX step does. Without the gate it would not: a zero-gradient Adam
    step still moves the MLP."""
    b = _batches(n_batches=1)[0]
    j, t = _apps()
    TW.wd_train_step(t.wide_up, t.emb_up, t.wide_state, t.emb_state, t.mlp, t.opt,
                     batch_to_device(b, "cpu"), b.num_examples, b.num_unique)
    before = copy.deepcopy(t.state_dict())
    opt_before = copy.deepcopy(t.opt.state_dict())
    inert = _inert(b)
    loss, _ = TW.wd_train_step(t.wide_up, t.emb_up, t.wide_state, t.emb_state, t.mlp, t.opt,
                               batch_to_device(inert, "cpu"), inert.num_examples,
                               inert.num_unique)
    assert float(loss) == 0.0
    after = t.state_dict()
    for name in ("wide", "emb"):
        for k in before[name]:
            np.testing.assert_array_equal(after[name][k], before[name][k])
    for x, y in zip(after["mlp"], before["mlp"]):
        for k in ("W", "b"):
            np.testing.assert_array_equal(x[k], y[k])
    opt_after = t.opt.state_dict()
    for i, st in opt_before["state"].items():
        for k, v in st.items():
            assert torch.equal(opt_after["state"][i][k], v), (i, k)
    # the JAX step on the same inert batch leaves its MLP unchanged too
    jm = [{k: np.asarray(v) for k, v in layer.items()} for layer in j.mlp_params]
    _, _, jmlp, _, jloss, _ = JW.wd_train_step(j.wide_up, j.emb_up, j.opt, j.wide_state,
                                               j.emb_state, j.mlp_params, j.opt_state,
                                               jax_batch(inert))
    assert float(jloss) == 0.0
    for x, y in zip(jmlp, jm):
        for k in ("W", "b"):
            np.testing.assert_array_equal(np.asarray(x[k]), y[k])
    # the gate matters: Adam on the zero gradient moves the MLP
    for p in t.mlp.parameters():
        p.grad = torch.zeros_like(p)
    t.opt.step()
    assert any(not np.array_equal(x["W"], y["W"])
               for x, y in zip(t.state_dict()["mlp"], before["mlp"]))


def _xor_data(n=6000, seed=0):
    """y = XOR of two categorical groups: invisible to a linear model."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 2, n)
    b = rng.integers(0, 2, n)
    y = (a ^ b).astype(np.float32)
    keys = [np.array([ai, 2 + bi], dtype=np.uint64) for ai, bi in zip(a, b)]
    vals = [np.ones(2, dtype=np.float32) for _ in range(n)]
    return y, keys, vals


def _xor_batches(y, keys, vals, bs=512):
    builder = BatchBuilder(num_keys=64, batch_size=bs, max_nnz_per_example=4,
                           key_mode="identity")
    return [builder.build(y[i:i + bs], keys[i:i + bs], vals[i:i + bs])
            for i in range(0, len(y), bs)]


def test_captures_interactions_linear_cannot():
    """tests/test_apps.py's XOR case on the port."""
    y, keys, vals = _xor_data()
    train = _xor_batches(y[:5000], keys[:5000], vals[:5000])
    test = _xor_batches(y[5000:], keys[5000:], vals[5000:])
    wd = TW.WideDeep(num_keys=64, emb_dim=8, hidden=[16], mlp_lr=5e-3, reporter=quiet(),
                     device="cpu")
    for _ in range(30):
        wd.train(train, report_every=1000)
    ev = wd.evaluate(test)
    assert ev["auc"] > 0.9, ev  # linear AUC on XOR is ~0.5
    assert ev["examples"] == 1000


def test_dumps_interchange_between_packages(tmp_path):
    """The port trains; the JAX app takes its weights. Each package's npz
    dump, read by the other's ``evaluate_dump``, gives the AUC and logloss
    of the writer's own ``evaluate`` (AUC within 1e-5)."""
    import jax.numpy as jnp

    y, keys, vals = _xor_data(n=2000, seed=4)
    p = tmp_path / "val.svm"
    write_libsvm(p, y, keys, vals)
    j, t = _apps(num_keys=64, emb_dim=8, hidden=[16], mlp_lr=5e-3)
    for _ in range(3):
        t.train(_xor_batches(y, keys, vals), report_every=1000)
    st = t.state_dict()
    j.wide_state = {k: jnp.asarray(v) for k, v in st["wide"].items()}
    j.emb_state = {k: jnp.asarray(v) for k, v in st["emb"].items()}
    j.mlp_params = [{k: jnp.asarray(v) for k, v in layer.items()} for layer in st["mlp"]]
    mk = {"num_keys": 64, "batch_size": 512, "max_nnz_per_example": 4, "key_mode": "identity"}
    paths = {"torch": str(tmp_path / "torch.npz"), "jax": str(tmp_path / "jax.npz")}
    t.dump_model(paths["torch"])
    j.dump_model(paths["jax"])
    own = {"torch": t.evaluate_files([str(p)], "libsvm", BatchBuilder(**mk)),
           "jax": j.evaluate_files([str(p)], "libsvm", JBB(**mk))}
    other = {"torch": JW.evaluate_dump(paths["torch"], [str(p)], "libsvm", JBB(**mk)),
             "jax": TW.evaluate_dump(paths["jax"], [str(p)], "libsvm", BatchBuilder(**mk),
                                     device="cpu")}
    assert own["torch"]["auc"] > 0.9
    for writer in paths:
        assert other[writer]["examples"] == own[writer]["examples"] == 2000
        assert other[writer]["auc"] == pytest.approx(own[writer]["auc"], abs=1e-5)
        assert other[writer]["logloss"] == pytest.approx(own[writer]["logloss"], rel=1e-5)
    tz, jz = np.load(paths["torch"]), np.load(paths["jax"])
    assert sorted(tz.files) == sorted(jz.files)
    for k in jz.files:
        assert tz[k].shape == jz[k].shape and tz[k].dtype == jz[k].dtype, k
        np.testing.assert_allclose(tz[k], jz[k], rtol=1e-6, atol=1e-7)


def test_state_dict_round_trip_and_checks():
    j, t = _apps(num_keys=256)
    st = t.state_dict()
    st["emb"]["w"][3] = 7.0
    st["mlp"][0]["b"][:] = 0.5
    t.load_state(st["wide"], st["emb"], st["mlp"])
    assert float(t.emb_state["w"][3, 0]) == 7.0
    assert t.state_dict()["mlp"][0]["b"][0] == 0.5
    assert t.opt.state_dict()["state"] == {}  # Adam starts fresh
    # the JAX app's state carries across as numpy
    t.load_state({k: np.asarray(v) for k, v in j.wide_state.items()},
                 {k: np.asarray(v) for k, v in j.emb_state.items()},
                 [{k: np.asarray(v) for k, v in layer.items()} for layer in j.mlp_params])
    _assert_state(t, j, {"rtol": 0, "atol": 0})
    with pytest.raises(ValueError, match="does not match"):
        t.load_state({"z": st["wide"]["z"]}, st["emb"], st["mlp"])
    with pytest.raises(ValueError, match="mlp layers"):
        t.load_state(st["wide"], st["emb"], st["mlp"][:1])


@pytest.mark.parametrize("kw,match", [
    # a mesh cell without process groups: the refusal comes first
    ({"mesh": Mesh(data=1, kv=1, d=0, k=0, device=torch.device("cpu")),
      "push_mode": "bogus"}, "unknown push_mode"),
    ({"steps_per_call": 0}, "steps_per_call"),
])
def test_unported_and_bad_options_raise(kw, match):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        TW.WideDeep(16, device="cpu", **kw)


# --- the CLI ------------------------------------------------------------------


def _cli_config(tmp_path):
    """tests/test_checkpoint_cli.py's wide_deep data and config, on one
    device."""
    rng = np.random.default_rng(3)
    n = 6000
    a = rng.integers(0, 2, n)
    b = rng.integers(0, 2, n)
    y = (a ^ b).astype(np.float32)
    keys = [np.array([ai, 2 + bi], dtype=np.uint64) for ai, bi in zip(a, b)]
    vals = [np.ones(2, dtype=np.float32) for _ in range(n)]
    tr_p, val_p = tmp_path / "tr.svm", tmp_path / "val.svm"
    write_libsvm(tr_p, y[:5000], keys[:5000], vals[:5000])
    write_libsvm(val_p, y[5000:], keys[5000:], vals[5000:])
    cfg = {
        "app": "wide_deep",
        "data": {"files": [str(tr_p)], "val_files": [str(val_p)],
                 "num_keys": 1024, "max_nnz_per_example": 8},
        "wd": {"emb_dim": 8, "hidden": [16], "mlp_lr": 5e-3},
        "penalty": {"lambda_l1": 0.5},
        "solver": {"epochs": 30, "minibatch": 512, "steps_per_call": 2},
    }
    p = tmp_path / "wd.json"
    p.write_text(json.dumps(cfg))
    return p


def test_cli_train_and_evaluate_wide_deep(tmp_path, capsys):
    """cli train -> npz dump -> cli evaluate on the CPU; the same config
    through the JAX CLI gives the same validation AUC."""
    app_file = _cli_config(tmp_path)
    model = tmp_path / "wd_model.npz"
    assert TC.main(["train", "--app_file", str(app_file), "--model_out", str(model),
                    "--device", "cpu", "--report_interval", "1000"]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert out["val_auc"] > 0.9, out  # linear AUC on XOR is ~0.5
    assert out["emb_dim"] == 8 and out["hidden"] == [16] and out["val_examples"] == 1000
    assert model.exists()
    assert TC.main(["evaluate", "--app_file", str(app_file), "--model", str(model),
                    "--device", "cpu"]) == 0
    ev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert ev["auc"] == pytest.approx(out["val_auc"], abs=1e-5)
    assert JC.main(["train", "--app_file", str(app_file), "--report_interval", "1000"]) == 0
    jout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(out["val_auc"], jout["val_auc"], rtol=1e-4)
    np.testing.assert_allclose(out["val_logloss"], jout["val_logloss"], rtol=1e-3)


@pytest.mark.parametrize("argv,section", [
    (["train", "--ckpt_dir", "ck"], {}),
    # the JAX app's refusal on a mesh, made before the rank joins a world
    (["train"], {"parallel": {"data_shards": 2, "kv_shards": 2, "push_mode": "bogus"}}),
])
def test_cli_wide_deep_refuses_unsupported(tmp_path, argv, section):
    app_file = tmp_path / "cfg.json"
    app_file.write_text(json.dumps({"app": "wide_deep", "data": {"files": ["x"]},
                                    **section}))
    with pytest.raises((SystemExit, ValueError), match="wide_deep|unknown push_mode"):
        TC.main([*argv, "--app_file", str(app_file), "--device", "cpu"])
