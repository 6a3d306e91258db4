"""Port parity for matrix factorization's mesh path.

The port runs as a gloo world of CPU rank processes (``tests/_torch_rank.py``,
a time limit each), the JAX package's ``MatrixFactorization(mesh=...)`` on a
mesh of the same shape of the 8-device CPU mesh here. Both start from the
same tables (the JAX app's seeded draws). Steps from a shared state agree
within rtol 1e-5 / atol 1e-6 and epochs within rtol 1e-4, the tolerances of
tests/test_torch_mf.py: XLA's segment sums and torch's ``index_add_`` add in
different orders."""

import json

import numpy as np
import pytest
import torch
from _torch_world import rank_argvs, run_world

from parameter_server_tpu.models.matrix_fac import MFBatchBuilder
from parameter_server_tpu.models.matrix_fac import MatrixFactorization as JMF
from parameter_server_tpu.models.matrix_fac import stack_mf_batches
from parameter_server_tpu.parallel import make_mesh as j_make_mesh
from parameter_server_tpu.utils.metrics import ProgressReporter as JReporter

torch.set_num_threads(1)

STEP_TOL = {"rtol": 1e-5, "atol": 1e-6}
EPOCH_TOL = {"rtol": 1e-4, "atol": 1e-5}
N_USERS, N_ITEMS, RANK, BATCH, STEPS = 63, 47, 8, 128, 3  # 64 and 48 table rows
MF_FIELDS = ("user_keys", "item_keys", "user_ids", "item_ids", "ratings", "mask")
COMMON = {"num_users": N_USERS, "num_items": N_ITEMS, "rank": RANK, "eta": 0.05,
          "l2": 0.01, "seed": 0, "steps": STEPS, "batch_size": BATCH}
CASES = [
    {"name": "adagrad_pw", "algo": "adagrad", "push_mode": "per_worker"},
    {"name": "adagrad_agg", "algo": "adagrad", "push_mode": "aggregate"},
    {"name": "sgd_pw", "algo": "sgd", "push_mode": "per_worker"},
    {"name": "sgd_agg", "algo": "sgd", "push_mode": "aggregate"},
    {"name": "epoch_pw", "algo": "adagrad", "push_mode": "per_worker", "epoch": True},
    {"name": "epoch_agg", "algo": "adagrad", "push_mode": "aggregate", "epoch": True},
]
for _c in CASES:
    for _k, _v in COMMON.items():
        _c.setdefault(_k, _v)
BY_NAME = {c["name"]: c for c in CASES}
MESHES = [(2, 2), (1, 2)]


def _ratings(n: int, seed: int):
    rng = np.random.default_rng(seed)
    U = rng.normal(size=(N_USERS, 4)) / 2
    V = rng.normal(size=(N_ITEMS, 4)) / 2
    users = rng.integers(0, N_USERS, n)
    items = rng.integers(0, N_ITEMS, n)
    r = (np.sum(U[users] * V[items], axis=1) + rng.normal(size=n) * 0.1).astype(np.float32)
    return users.astype(np.int64), items.astype(np.int64), r


def _step_batches(d: int):
    builder = MFBatchBuilder(BATCH)
    users, items, r = _ratings(STEPS * d * BATCH, seed=1)
    return [[builder.build(*(a[(s * d + i) * BATCH:(s * d + i + 1) * BATCH]
                             for a in (users, items, r))) for i in range(d)]
            for s in range(STEPS)]


def _jax_app(case, mesh):
    return JMF(N_USERS, N_ITEMS, rank=RANK, eta=case["eta"], l2=case["l2"], algo=case["algo"],
               seed=case["seed"], mesh=mesh, push_mode=case["push_mode"],
               reporter=JReporter(print_fn=lambda *_: None))


def _jax_case(case, mesh, steps, epoch_data):
    app = _jax_app(case, mesh)
    out = {}
    if case.get("epoch"):
        out["rmse"] = app.train_epoch(*epoch_data, batch_size=BATCH, seed=case["seed"])
    else:
        losses = []
        for group in steps:
            app.user_state, app.item_state, loss = app._spmd_step(
                app.user_state, app.item_state, stack_mf_batches(group, mesh))
            losses.append(float(loss))
        out["loss"] = np.array(losses)
    for table in ("user", "item"):
        for k, v in getattr(app, f"{table}_state").items():
            out[f"{table}/{k}"] = np.asarray(v)
    return out


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def world(request, tmp_path_factory):
    d, kv = request.param
    tmp = tmp_path_factory.mktemp(f"mf{d}x{kv}")
    steps = _step_batches(d)
    # 2.3 global steps: the last one's slice of shard 1 (on 2x2) is empty
    epoch_data = _ratings(int(2.3 * d * BATCH), seed=2)
    arrays = {f"s{s}_d{i}_{f}": getattr(b, f) for s, group in enumerate(steps)
              for i, b in enumerate(group) for f in MF_FIELDS}
    arrays.update(dict(zip(("users", "items", "ratings"), epoch_data)))
    np.savez(tmp / "inputs.npz", **arrays)
    plan = tmp / "plan.json"
    plan.write_text(json.dumps({"mesh": [d, kv], "inputs": str(tmp / "inputs.npz"),
                                "cases": CASES, "out": str(tmp)}))
    run_world(rank_argvs("mf", plan, d * kv))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(d * kv)]
    mesh = j_make_mesh(d, kv)
    return ranks, {c["name"]: _jax_case(c, mesh, steps, epoch_data) for c in CASES}


def _tables(case):
    return [f"{t}/{k}" for t in ("user", "item")
            for k in (("w", "n") if case["algo"] == "adagrad" else ("w",))]


@pytest.mark.parametrize("name", [c["name"] for c in CASES if not c.get("epoch")])
def test_mf_mesh_steps_match_jax(world, name):
    """3 steps: both tables (w and n) on every rank and the data group's
    SSE of each step."""
    ranks, jax_out = world
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{name}/loss"], jax_out[name]["loss"], **STEP_TOL)
        for t in _tables(BY_NAME[name]):
            np.testing.assert_allclose(res[f"{name}/{t}"], jax_out[name][t], **STEP_TOL,
                                       err_msg=f"rank {r} {t}")


@pytest.mark.parametrize("name", [c["name"] for c in CASES if c.get("epoch")])
def test_mf_mesh_epoch_matches_jax(world, name):
    """train_epoch: every rank builds only its data shard's slice of each
    global step, an inert batch where the slice is empty."""
    ranks, jax_out = world
    for res in ranks:
        np.testing.assert_allclose(res[f"{name}/rmse"], jax_out[name]["rmse"], rtol=1e-4)
        for t in _tables(BY_NAME[name]):
            np.testing.assert_allclose(res[f"{name}/{t}"], jax_out[name][t], **EPOCH_TOL)


def test_mf_sgd_aggregate_equals_per_worker(world):
    ranks, _ = world
    for res in ranks:
        for t in ("user/w", "item/w"):
            np.testing.assert_allclose(res[f"sgd_agg/{t}"], res[f"sgd_pw/{t}"], rtol=0,
                                       atol=1e-6)


def test_mf_pad_row_stays_zero(world):
    ranks, _ = world
    for res in ranks:
        for name, case in BY_NAME.items():
            for t in _tables(case):
                assert not res[f"{name}/{t}"][0].any(), (name, t)


@pytest.mark.parametrize("table,bad", [
    ("user", "fewer_rows"), ("user", "more_rows"), ("item", "more_rows"),
    ("item", "other_rank"), ("user", "missing_n"),
])
def test_mf_mesh_load_state_refuses_other_shapes(table, bad):
    """On a mesh, load_state holds the full tables to the model's rows and
    rank before each rank takes its slice (a world of one in this
    process); its own state_dict loads back unchanged."""
    from parameter_server_tpu_torch.models.matrix_fac import MatrixFactorization
    from parameter_server_tpu_torch.parallel import runtime
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    rt = runtime.init(None, kv_shards=1, data_shards=1, device="cpu")
    try:
        app = MatrixFactorization(N_USERS, N_ITEMS, rank=RANK, mesh=rt.mesh,
                                  reporter=ProgressReporter(print_fn=lambda *_: None))
        st = app.state_dict()
        app.load_state(st["user"], st["item"])
        again = app.state_dict()
        for t in ("user", "item"):
            for k in st[t]:
                np.testing.assert_array_equal(again[t][k], st[t][k])
        w = st[table]["w"]
        st[table] = {
            "fewer_rows": lambda: {k: v[:-1] for k, v in st[table].items()},
            "more_rows": lambda: {k: np.concatenate([v, v[:1]]) for k, v in st[table].items()},
            "other_rank": lambda: {k: v[:, :-1] for k, v in st[table].items()},
            "missing_n": lambda: {"w": w},
        }[bad]()
        with pytest.raises(ValueError, match=f"{table} state"):
            app.load_state(st["user"], st["item"])
    finally:
        rt.shutdown()
    assert not torch.distributed.is_initialized()
