"""Port parity for the darlin batch solver, on the CPU.

Mirrors tests/test_darlin.py. The same batches (numpy, seeded) go through
the JAX ``Darlin`` (jitted, as the package runs it) and the port's, on one
device and on the SPMD tier: the port's mesh is a gloo world of CPU rank
processes (``tests/_torch_rank.py``, one a mesh cell), the JAX package's a
mesh of the 8-device CPU mesh here.

Tolerances. The port's segment sums are ``index_add_``, XLA's add in
another order, and the line search takes the argmin of 8 objective sums
over every example, where a reordered sum can flip a near tie. So:
- the block math function by function: rtol 1e-5 / atol 1e-6 (MATH_TOL);
  the line search's step and the skip pattern exactly;
- objective histories: the first 5 passes within rtol 1e-5 (EARLY_TOL),
  every pass within rtol 2e-4 — the JAX package's own mesh-vs-single
  contract (tests/test_darlin.py:167-169) — port vs JAX and mesh vs single;
- streamed vs resident on one mesh: rtol 1e-5, the JAX contract
  (tests/test_darlin.py:300-302, :330-332);
- a world of one vs one device: rtol 1e-6 (the same sums in the same
  order but for the mask's factor 1);
- against liblinear's optimum, the JAX tests' bounds (1%, 2%).
"""

import json
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from _torch_world import RANK_SCRIPT, rank_argvs, run_world

from parameter_server_tpu import cli as JC
from parameter_server_tpu.data.batch import BatchBuilder as JBB
from parameter_server_tpu.data.synthetic import make_sparse_logistic
from parameter_server_tpu.models import darlin as JD
from parameter_server_tpu.parallel import make_mesh as j_make_mesh
from parameter_server_tpu.utils import checkpoint as JCK
from parameter_server_tpu.utils.config import PSConfig as JCfg
from parameter_server_tpu.utils.metrics import ProgressReporter as JR
from parameter_server_tpu_torch import cli as TC
from parameter_server_tpu_torch.data.blockcache import ColumnBlocks
from parameter_server_tpu_torch.data.synthetic import write_libsvm
from parameter_server_tpu_torch.models import darlin as TD
from parameter_server_tpu_torch.models import metrics as M
from parameter_server_tpu_torch.parallel import runtime
from parameter_server_tpu_torch.utils import checkpoint as TCK
from parameter_server_tpu_torch.utils.config import PSConfig as TCfg
from parameter_server_tpu_torch.utils.metrics import ProgressReporter as TR

torch.set_num_threads(1)

NUM_KEYS = 256
N = 2000
MATH_TOL = {"rtol": 1e-5, "atol": 1e-6}
EARLY_TOL = 1e-5
HIST_RTOL = 2e-4
STREAM_RTOL = 1e-5
CSR_FIELDS = ("unique_keys", "local_ids", "row_ids", "values", "labels", "example_mask",
              "row_splits")


def _batches(n=N, num_keys=NUM_KEYS, bs=500, seed=5):
    labels, keys, vals, _ = make_sparse_logistic(
        n, num_keys - 2, nnz_per_example=12, noise=0.3, seed=seed
    )
    builder = JBB(num_keys=num_keys, batch_size=bs, key_mode="identity")
    batches = [builder.build(labels[i:i + bs], keys[i:i + bs], vals[i:i + bs])
               for i in range(0, n, bs)]
    return batches, labels, keys, vals


@pytest.fixture(scope="module")
def data():
    return _batches()


def make_cfg(cls=TCfg, **kw):
    cfg = cls()
    cfg.data.num_keys = kw.pop("num_keys", NUM_KEYS)
    cfg.solver.algo = "darlin"
    cfg.solver.feature_blocks = kw.pop("blocks", 8)
    cfg.solver.block_iters = kw.pop("iters", 30)
    cfg.solver.epsilon = kw.pop("epsilon", 1e-5)
    cfg.solver.max_delay = kw.pop("max_delay", 0)
    cfg.solver.kkt_filter_threshold = kw.pop("kkt", 0.0)
    cfg.solver.block_chunk = kw.pop("chunk", 0)
    cfg.penalty.lambda_l1 = kw.pop("lambda_l1", 1.0)
    cfg.lr.eta = kw.pop("eta", 1.0)
    assert not kw
    return cfg


def _port(**kw):
    return TD.Darlin(make_cfg(**kw), reporter=TR(print_fn=lambda *_: None), device="cpu")


def _jax(mesh=None, **kw):
    return JD.Darlin(make_cfg(JCfg, **kw), reporter=JR(print_fn=lambda *_: None), mesh=mesh)


def _same_history(got, want, rtol=HIST_RTOL):
    got, want = np.asarray(got), np.asarray(want)
    assert len(got) == len(want), (len(got), len(want))
    np.testing.assert_allclose(got[:5], want[:5], rtol=min(rtol, EARLY_TOL))
    np.testing.assert_allclose(got, want, rtol=rtol)


# --- column blocks ------------------------------------------------------------


class TestColumnBlocks:
    def test_layout_equals_jax_and_roundtrips(self, data):
        batches, labels, keys, vals = data
        cb = ColumnBlocks.from_batches(batches, NUM_KEYS, 8)
        jcb = JD.ColumnBlocks.from_batches(batches, NUM_KEYS, 8)
        for f in ("feat_local", "rows", "values", "labels"):
            np.testing.assert_array_equal(getattr(cb, f), getattr(jcb, f))
            assert getattr(cb, f).dtype == getattr(jcb, f).dtype
        assert (cb.num_examples, cb.n_blocks, cb.block_size) == (N, 8, NUM_KEYS // 8)
        assert (cb.values != 0).sum() <= sum(b.num_entries for b in batches)
        rowsum = np.zeros(N)
        for i in range(cb.n_blocks):
            np.add.at(rowsum, cb.rows[i], cb.values[i])
        direct = np.array([v.sum() for v in vals])
        np.testing.assert_allclose(rowsum, direct, rtol=1e-4)

    def test_divisibility(self, data):
        with pytest.raises(ValueError, match="n_blocks"):
            ColumnBlocks.from_batches(data[0], NUM_KEYS, 7)


# --- the block math, function by function -------------------------------------


def _block_inputs(seed=0, n=300, bs=32):
    rng = np.random.default_rng(seed)
    w_b = rng.normal(size=bs).astype(np.float32) * (rng.random(bs) < 0.5)
    return {
        "w_b": w_b.astype(np.float32),
        "g": rng.normal(size=bs).astype(np.float32) * 2,
        "h": rng.random(bs).astype(np.float32),
        "skip": rng.random(bs) < 0.3,
        "pred": rng.normal(size=n).astype(np.float32) * 3,
        "Xd": rng.normal(size=n).astype(np.float32),
        "y": (rng.random(n) < 0.5).astype(np.float32),
        "mask": (np.arange(n) < n - 17).astype(np.float32),
        "d": rng.normal(size=bs).astype(np.float32) * 0.1,
    }


def _t(x):
    return torch.from_numpy(np.asarray(x))


@pytest.mark.parametrize("l1,l2,eta", [(1.0, 0.0, 1.0), (0.3, 0.5, 0.7)])
def test_kkt_viol_and_prox_direction_match_jax(l1, l2, eta):
    x = _block_inputs(seed=1)
    np.testing.assert_allclose(
        TD._kkt_viol(_t(x["w_b"]), _t(x["g"]), l1).numpy(),
        np.asarray(JD._kkt_viol(x["w_b"], x["g"], l1)), **MATH_TOL)
    got = TD._prox_newton_direction(_t(x["w_b"]), _t(x["g"]), _t(x["h"]), _t(x["skip"]),
                                    l1, l2, eta).numpy()
    want = np.asarray(JD._prox_newton_direction(x["w_b"], x["g"], x["h"], x["skip"],
                                                l1, l2, eta))
    np.testing.assert_allclose(got, want, **MATH_TOL)
    np.testing.assert_array_equal(got == 0, want == 0)


@pytest.mark.parametrize("seed", [0, 2, 3])
@pytest.mark.parametrize("masked", [False, True])
def test_line_search_alpha_matches_jax(seed, masked):
    """The step scale is one of 8 powers of two or 0: equal exactly."""
    x = _block_inputs(seed=seed)
    for scale in (1.0, 30.0, 0.01):  # far past softplus's range, and near 0
        kw_t, kw_j = {}, {}
        if masked:
            kw_t["mask"], kw_j["mask"] = _t(x["mask"]), x["mask"]
        d = x["d"] * scale
        got = TD._line_search_alpha(_t(x["pred"]), _t(x["Xd"] * scale), _t(x["y"]),
                                    _t(x["w_b"]), _t(d), 0.5, 0.1, **kw_t)
        want = JD._line_search_alpha(x["pred"], x["Xd"] * scale, x["y"], x["w_b"], d,
                                     0.5, 0.1, **kw_j)
        assert float(got) == float(want), (scale, float(got), float(want))
        assert float(got) in (0.0, *TD.ALPHAS)


def test_softplus_is_logaddexp():
    """rtol 1e-6; atol 1e-37 because XLA on the CPU flushes the subnormal
    log1p(e^-90) to 0, where torch keeps it."""
    x = np.array([-90.0, -20.0, -1.0, 0.0, 1e-3, 19.0, 20.5, 35.0, 90.0], np.float32)
    np.testing.assert_allclose(TD._softplus(_t(x)).numpy(),
                               np.asarray(JD.jax.nn.softplus(x)), rtol=1e-6, atol=1e-37)


@pytest.mark.parametrize("delay", [0, 2])
@pytest.mark.parametrize("start", ["zeros", "mid"])
def test_darlin_pass_matches_jax(data, delay, start):
    """One pass in a shuffled block order, from zeros and from the state
    after 3 JAX passes: w, pred and the violation maximum."""
    cb = ColumnBlocks.from_batches(data[0], NUM_KEYS, 8)
    w = np.zeros(NUM_KEYS, np.float32)
    pred = np.zeros(N, np.float32)
    active = np.ones(NUM_KEYS, bool)
    if start == "mid":
        j = _jax(iters=3, kkt=0.1)
        j.fit(data[0], shuffle_blocks=False)
        w, pred = j.w, j.pred
        active = np.asarray(j.w != 0) | (np.arange(NUM_KEYS) % 3 == 0)
    order = np.random.default_rng(4).permutation(cb.n_blocks)
    blocks = {"feat_local": cb.feat_local[order], "rows": cb.rows[order],
              "values": cb.values[order], "block_idx": order.astype(np.int32)}
    jw, jp, _, jv = JD.darlin_pass(w, pred, active, blocks, cb.labels, 1.0, 0.0, 1.0, 0.0,
                                   block_size=cb.block_size, num_examples=N, delay=delay)
    resident = {k: _t(getattr(cb, k)) for k in ("feat_local", "rows", "values")}
    tw, tp, ta, tv = TD.darlin_pass(_t(w.copy()), _t(pred.copy()), _t(active), resident,
                                    order, _t(cb.labels), 1.0, 0.0, 1.0,
                                    block_size=cb.block_size, delay=delay)
    np.testing.assert_allclose(tw.numpy(), np.asarray(jw), **MATH_TOL)
    np.testing.assert_allclose(tp.numpy(), np.asarray(jp), **MATH_TOL)
    np.testing.assert_allclose(float(tv), float(jv), **MATH_TOL)
    np.testing.assert_array_equal(ta.numpy(), active)
    np.testing.assert_array_equal(tw.numpy() == 0, np.asarray(jw) == 0)
    np.testing.assert_allclose(
        float(TD._objective(tw, tp, _t(cb.labels), 1.0, 0.0)),
        float(JD._objective(jw, jp, cb.labels, 1.0, 0.0)), **MATH_TOL)


def test_block_extents_leave_the_pass_unchanged(data):
    """The pass over each block's entries up to its last nonzero value (the
    solver's) equals the pass over the padded width, exactly: the pads
    only add zeros."""
    cb = ColumnBlocks.from_batches(data[0], NUM_KEYS, 8)
    ext = TD.block_extents(cb.values)
    assert ext == [int(np.flatnonzero(v).max()) + 1 for v in cb.values]
    assert max(ext) == cb.values.shape[1] and min(ext) < max(ext)
    assert TD.block_extents(np.zeros((2, 5), np.float32)) == [0, 0]
    order = np.random.default_rng(2).permutation(cb.n_blocks)
    blocks = {k: _t(getattr(cb, k)) for k in ("feat_local", "rows", "values")}
    outs = []
    for extent in (None, ext):
        b = dict(blocks, extent=extent) if extent else blocks
        outs.append(TD.darlin_pass(torch.zeros(NUM_KEYS), torch.zeros(N),
                                   torch.ones(NUM_KEYS, dtype=torch.bool), b, order,
                                   _t(cb.labels), 1.0, 0.0, 1.0, block_size=cb.block_size))
    for a, b in zip(*outs):
        np.testing.assert_array_equal(a.numpy(), b.numpy())


@pytest.mark.parametrize("n,partials", [(64, 1 << 22), (64, 64 * 5), (3000, 3000)])
def test_lane_segment_sum(n, partials, monkeypatch):
    """The card's segment sum (lanes over a hot id, then one fixed
    reduction), run here on CPU tensors: the float64 sums within rtol 1e-5
    / atol 1e-5 (float32 over ~40k entries), the same bits on a second
    call, and trailing zero entries leave every sum exactly as it was.
    ``partials`` below n x SEGMENT_LANES takes fewer lanes (5, then 1:
    ``index_put_`` alone)."""
    monkeypatch.setattr(TD, "SEGMENT_PARTIALS", partials)
    rng = np.random.default_rng(6)
    ids = rng.integers(0, n, 40_000)
    ids[rng.random(40_000) < 0.5] = 7  # one hot id, as darlin's hashed blocks have
    x = rng.normal(size=40_000).astype(np.float32)
    got = TD._lane_segment_sum(_t(x), _t(ids.astype(np.int32)), n)
    want = np.zeros(n)
    np.add.at(want, ids, x.astype(np.float64))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
    again = TD._lane_segment_sum(_t(x), _t(ids.astype(np.int32)), n)
    np.testing.assert_array_equal(again.numpy(), got.numpy())
    padded = TD._lane_segment_sum(_t(np.append(x, np.zeros(5000, np.float32))),
                                  _t(np.append(ids, np.zeros(5000, int)).astype(np.int32)), n)
    np.testing.assert_array_equal(padded.numpy(), got.numpy())


# --- convergence: the port against the JAX solver and liblinear ----------------


@pytest.fixture(scope="module")
def sklearn_ref(data):
    """liblinear on the same objective (tests/test_darlin.py's fixture)."""
    from scipy.sparse import csr_matrix
    from sklearn.linear_model import LogisticRegression

    batches, labels, keys, vals = data
    rows = np.repeat(np.arange(N), [len(k) for k in keys])
    cols = np.concatenate(keys).astype(int) + 1  # identity mode offset
    X = csr_matrix((np.concatenate(vals), (rows, cols)), shape=(N, NUM_KEYS))
    clf = LogisticRegression(penalty="l1", C=1.0, solver="liblinear", max_iter=500,
                             tol=1e-8, fit_intercept=False)
    clf.fit(X, labels)
    w = np.zeros(NUM_KEYS)
    w[: clf.coef_.shape[1]] = clf.coef_[0]
    z = X @ w
    obj = float(np.sum(np.logaddexp(0, z) - labels * z) + np.abs(w).sum())
    return {"obj": obj, "auc": M.auc(labels, 1 / (1 + np.exp(-z)))}


CONVERGENCE = {
    "plain": {"iters": 60},
    "delay": {"iters": 60, "max_delay": 2},
    "kkt": {"iters": 60, "kkt": 0.1},
}


@pytest.fixture(scope="module")
def single_runs(data):
    """Each case, port and JAX, one device, blocks in order."""
    out = {}
    for name, kw in CONVERGENCE.items():
        out[name] = (_port(**kw).fit(data[0], shuffle_blocks=False),
                     _jax(**kw).fit(data[0], shuffle_blocks=False))
    return out


@pytest.mark.parametrize("name", list(CONVERGENCE))
def test_objective_history_matches_jax(single_runs, name):
    t, j = single_runs[name]
    _same_history(t["history"], j["history"])
    assert abs(t["nnz_w"] - j["nnz_w"]) <= 2, (t["nnz_w"], j["nnz_w"])
    np.testing.assert_allclose(t["train_auc"], j["train_auc"], atol=1e-3)


@pytest.mark.parametrize("name,bound", [("plain", 1.01), ("delay", 1.02), ("kkt", 1.02)])
def test_converges_to_liblinear(single_runs, sklearn_ref, name, bound):
    """tests/test_darlin.py's bounds: within 1% of liblinear's optimum
    (2% with bounded delay or the KKT filter), AUC within 0.01."""
    res = single_runs[name][0]
    assert res["history"][-1] < sklearn_ref["obj"] * bound, (res["history"][-1],
                                                             sklearn_ref["obj"])
    if name == "plain":
        assert res["train_auc"] > sklearn_ref["auc"] - 0.01


def test_shuffled_history_matches_jax(data):
    """Shuffled blocks: the same seed draws the same order in both."""
    _same_history(_port(iters=8).fit(data[0])["history"],
                  _jax(iters=8).fit(data[0])["history"])


def test_objective_decreases(data):
    h = _port(iters=10).fit(data[0], shuffle_blocks=False)["history"]
    assert all(b <= a * 1.001 for a, b in zip(h, h[1:])), h


def test_l1_sparsifies(data):
    small = _port(lambda_l1=0.1, iters=15).fit(data[0])
    big = _port(lambda_l1=10.0, iters=15).fit(data[0])
    assert big["nnz_w"] < small["nnz_w"]


def test_early_stop_epsilon(data):
    t = _port(iters=200, epsilon=1e-3).fit(data[0])
    j = _jax(iters=200, epsilon=1e-3).fit(data[0])
    assert t["iters"] < 200 and t["iters"] == j["iters"]


def test_predict_matches_jax(data):
    batches, labels, _, _ = data
    app = _port(iters=20)
    app.fit(batches)
    p = app.predict(batches)
    assert p.shape == (N,) and M.auc(labels, p) > 0.85
    # the same weights through the JAX predict
    j = _jax(iters=1)
    j.w = app.w
    np.testing.assert_allclose(p, j.predict(batches), rtol=1e-6, atol=1e-7)


def test_entry_point_runs_on_the_card_by_default():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        TD.Darlin(make_cfg())


# --- the SPMD tier ------------------------------------------------------------


class TestShardBlocksPacking:
    """The vectorized (block, shard) entry packer behind the mesh solver."""

    def _naive_pack(self, cb, D):
        per = -(-cb.num_examples // D)
        counts = np.zeros((cb.n_blocks, D), dtype=np.int64)
        shard_ids = []
        for i in range(cb.n_blocks):
            s = np.asarray(cb.rows[i]) // per
            shard_ids.append(s)
            counts[i] = np.bincount(s, minlength=D)
        E = max(1, int(counts.max()))
        feat = np.zeros((cb.n_blocks, D, E), dtype=cb.feat_local.dtype)
        rows = np.zeros((cb.n_blocks, D, E), dtype=cb.rows.dtype)
        vals = np.zeros((cb.n_blocks, D, E), dtype=cb.values.dtype)
        for i in range(cb.n_blocks):
            s = shard_ids[i]
            for d in range(D):
                m = s == d
                k = int(m.sum())
                feat[i, d, :k] = cb.feat_local[i][m]
                rows[i, d, :k] = cb.rows[i][m] - d * per
                vals[i, d, :k] = cb.values[i][m]
        return feat, rows, vals

    @pytest.mark.parametrize("D", [2, 4])
    def test_matches_naive_pack_and_jax(self, data, D):
        cb = ColumnBlocks.from_batches(data[0], NUM_KEYS, 8)
        ref = self._naive_pack(cb, D)
        out = TD.shard_blocks_for_mesh(cb, D)
        jout = JD.shard_blocks_for_mesh(cb, D)
        for k, want in zip(("feat_local", "rows", "values"), ref):
            np.testing.assert_array_equal(out[k], want)
            np.testing.assert_array_equal(out[k], jout[k])
        np.testing.assert_array_equal(out["block_idx"], np.arange(cb.n_blocks))
        ex, jex = TD.shard_examples_for_mesh(cb, D), JD.shard_examples_for_mesh(cb, D)
        for k in ("labels", "mask"):
            np.testing.assert_array_equal(ex[k], jex[k])
        assert ex["per_shard_examples"] == jex["per_shard_examples"]

    def test_subset_and_pow2(self, data):
        cb = ColumnBlocks.from_batches(data[0], NUM_KEYS, 8)
        full = TD.shard_blocks_for_mesh(cb, 2)
        sel = np.array([5, 1, 6])
        out = TD.shard_blocks_for_mesh(cb, 2, blocks=sel, pad_pow2=True)
        E = out["feat_local"].shape[2]
        assert E & (E - 1) == 0
        np.testing.assert_array_equal(out["block_idx"], sel)
        jout = JD.shard_blocks_for_mesh(cb, 2, blocks=sel, pad_pow2=True)
        for k in ("feat_local", "rows", "values", "counts"):
            np.testing.assert_array_equal(out[k], jout[k])
        for j, b in enumerate(sel):
            c = out["counts"][j]
            np.testing.assert_array_equal(c, full["counts"][b])
            for d in range(2):
                k = int(c[d])
                np.testing.assert_array_equal(out["values"][j, d, :k],
                                              full["values"][b, d, :k])
                assert not out["values"][j, d, k:].any()


@pytest.mark.parametrize("num_keys,block_size,match", [
    (NUM_KEYS, 48, "aligned"), (250, 25, "divisible"),
])
def test_mesh_layout_errors(num_keys, block_size, match):
    """make_darlin_spmd_fns's two refusals, as the JAX function raises them."""
    mesh = SimpleNamespace(shape={"data": 2, "kv": 4}, device=torch.device("cpu"), d=0, k=0)
    kw = dict(num_keys=num_keys, block_size=block_size, per_shard_examples=100,
              lambda_l1=1.0, lambda_l2=0.0, learning_rate=1.0, delay=0)
    with pytest.raises(ValueError, match=match):
        TD.make_darlin_spmd_fns(mesh, **kw)
    with pytest.raises(ValueError, match=match):
        JD.make_darlin_spmd_fns(j_make_mesh(2, 4), **kw)


@pytest.mark.parametrize("chunk", [0, 3])
def test_world_of_one_matches_single_device(data, chunk):
    """A 1x1 gloo world in this process, resident and streamed: the single
    device's sums in the single device's order (rtol 1e-6)."""
    ref = _port(iters=6, kkt=0.1).fit(data[0])
    rt = runtime.init(None, kv_shards=1, data_shards=1, device="cpu")
    try:
        app = TD.Darlin(make_cfg(iters=6, kkt=0.1, chunk=chunk),
                        reporter=TR(print_fn=lambda *_: None), mesh=rt.mesh)
        res = app.fit(data[0])
    finally:
        rt.shutdown()
    np.testing.assert_allclose(res["history"], ref["history"], rtol=1e-6)
    assert res["nnz_w"] == ref["nnz_w"] and app.w.shape == (NUM_KEYS,)


# the 2x2 world's cases: (name, stream, shuffle, cfg kwargs)
WORLD_CASES = [
    ("traj", "base", False, {"iters": 12}),
    ("shuffled", "base", True, {"iters": 8}),
    ("kkt", "base", False, {"iters": 60, "kkt": 0.1}),
    ("delay", "base", False, {"iters": 60, "max_delay": 2}),
    ("resident", "base", True, {"iters": 8, "kkt": 0.1}),
    ("chunk3", "base", True, {"iters": 8, "kkt": 0.1, "chunk": 3}),
    ("chunk8", "base", True, {"iters": 8, "kkt": 0.1, "chunk": 8}),
    # >= 10x the base fixture (tests/test_darlin.py's streaming scale case)
    ("big_resident", "big", True, {"iters": 4, "blocks": 16, "num_keys": 2560}),
    ("big_chunk4", "big", True, {"iters": 4, "blocks": 16, "num_keys": 2560, "chunk": 4}),
]
BIG = {"n": 20000, "num_keys": 2560, "bs": 2000, "seed": 9}


def _case_cfg(kw: dict) -> dict:
    c = make_cfg(**kw)
    return {"num_keys": c.data.num_keys, "cfg": {
        "solver": {k: getattr(c.solver, k) for k in (
            "feature_blocks", "block_iters", "epsilon", "max_delay",
            "kkt_filter_threshold", "block_chunk")},
        "penalty": {"lambda_l1": c.penalty.lambda_l1}, "lr": {"eta": c.lr.eta}}}


def _pack(stream: list, key: str) -> dict:
    out = {}
    for i, b in enumerate(stream):
        for f in (*CSR_FIELDS, "num_examples", "num_unique", "num_entries"):
            out[f"{key}/b{i}/{f}"] = np.asarray(getattr(b, f))
    return out


@pytest.fixture(scope="module")
def world(data, tmp_path_factory):
    """The port's 2x2 world (its 4 rank processes run alone), every case in
    one run; rank 0's results (every rank holds the same w and pred)."""
    tmp = tmp_path_factory.mktemp("darlin2x2")
    big = _batches(**BIG)[0]
    np.savez(tmp / "inputs.npz", **_pack(data[0], "base"), **_pack(big, "big"))
    cases = [{"name": n, "stream": s, "shuffle": sh, **_case_cfg(kw)}
             for n, s, sh, kw in WORLD_CASES]
    plan = tmp / "plan.json"
    plan.write_text(json.dumps({"mesh": [2, 2], "inputs": str(tmp / "inputs.npz"),
                                "darlin_cases": cases, "out": str(tmp)}))
    run_world(rank_argvs("darlin", plan, 4))
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(4)]
    for r in ranks[1:]:
        for k, v in ranks[0].items():
            np.testing.assert_array_equal(r[k], v, err_msg=k)
    return {"res": ranks[0], "big": big}


def _hist(world, name):
    return world["res"][f"{name}/history"]


def test_mesh_matches_single_device_trajectory(world, data):
    """Same math, other layout: the 2x2 world's history against the port's
    and the JAX package's single-device solver; full w and pred."""
    cfg_kw = dict(WORLD_CASES[0][3])
    _same_history(_hist(world, "traj"),
                  _port(**cfg_kw).fit(data[0], shuffle_blocks=False)["history"])
    _same_history(_hist(world, "traj"),
                  _jax(**cfg_kw).fit(data[0], shuffle_blocks=False)["history"])
    assert world["res"]["traj/w"].shape == (NUM_KEYS,)
    assert world["res"]["traj/pred"].shape == (N,)


def test_mesh_shuffled_blocks_match_single_device(world, data):
    _same_history(_hist(world, "shuffled"), _port(iters=8).fit(data[0])["history"])


@pytest.mark.parametrize("name", ["kkt", "delay"])
def test_mesh_kkt_filter_and_bounded_delay_converge(world, sklearn_ref, name):
    """The KKT filter on the device and bounded delay on the mesh reach
    liblinear's optimum within 2%, as tests/test_darlin.py holds the JAX
    mesh (its bounded-delay case runs on a 4x2 mesh)."""
    assert _hist(world, name)[-1] < sklearn_ref["obj"] * 1.02


@pytest.mark.parametrize("name", ["chunk3", "chunk8"])
def test_mesh_streamed_matches_resident(world, name):
    np.testing.assert_allclose(_hist(world, name), _hist(world, "resident"),
                               rtol=STREAM_RTOL)


def test_mesh_streamed_and_resident_match_jax_mesh(world, data):
    """The same cases on a JAX 2x2 mesh: resident and chunk 3."""
    for name, chunk in (("resident", 0), ("chunk3", 3)):
        j = _jax(mesh=j_make_mesh(2, 2), iters=8, kkt=0.1, chunk=chunk).fit(data[0])
        _same_history(_hist(world, name), j["history"])


def test_mesh_streaming_at_10x_scale_matches_resident(world):
    """>= 10x the base fixture: streamed (4 blocks a chunk) vs resident."""
    np.testing.assert_allclose(_hist(world, "big_chunk4"), _hist(world, "big_resident"),
                               rtol=STREAM_RTOL)
    single = _port(iters=4, blocks=16, num_keys=2560).fit(world["big"])
    _same_history(_hist(world, "big_resident"), single["history"])


# --- the CLI: one device, and a 2x1 world ---------------------------------------


def _cli_files(tmp_path, n=1500):
    labels, keys, vals, _ = make_sparse_logistic(n, 400, nnz_per_example=10, noise=0.3,
                                                 seed=11)
    write_libsvm(tmp_path / "tr0.svm", labels[:700], keys[:700], vals[:700])
    write_libsvm(tmp_path / "tr1.svm", labels[700:1200], keys[700:1200], vals[700:1200])
    write_libsvm(tmp_path / "val.svm", labels[1200:], keys[1200:], vals[1200:])
    return {"app": "linear_method",
            "data": {"files": [str(tmp_path / "tr0.svm"), str(tmp_path / "tr1.svm")],
                     "val_files": [str(tmp_path / "val.svm")], "num_keys": 1024,
                     "max_nnz_per_example": 32},
            "solver": {"algo": "darlin", "feature_blocks": 8, "block_iters": 10,
                       "kkt_filter_threshold": 0.1, "minibatch": 256},
            "penalty": {"lambda_l1": 0.5}}


def _last_json(capsys) -> dict:
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_cli_train_darlin_matches_jax(tmp_path, capsys):
    """One device: the result, the text model and the checkpoint against
    the JAX CLI's, and each package's checkpoint read by the other."""
    cfg = _cli_files(tmp_path)
    app_file = tmp_path / "d.json"
    app_file.write_text(json.dumps(cfg))
    runs = {}
    for name, main, extra in (("jax", JC.main, []), ("port", TC.main, ["--device", "cpu"])):
        model, ckpt = tmp_path / f"{name}.txt", tmp_path / f"{name}_ck"
        assert main(["train", "--app_file", str(app_file), "--model_out", str(model),
                     "--ckpt_dir", str(ckpt), *extra]) == 0
        runs[name] = (_last_json(capsys), model, ckpt)
    (jout, jmodel, jck), (tout, tmodel, tck) = runs["jax"], runs["port"]
    assert set(tout) == set(jout) == {"objv", "iters", "nnz_w", "train_auc", "val_auc",
                                      "val_logloss"}
    assert tout["iters"] == jout["iters"]
    for k in ("objv", "train_auc", "val_auc", "val_logloss"):
        np.testing.assert_allclose(tout[k], jout[k], rtol=HIST_RTOL, err_msg=k)
    assert abs(tout["nnz_w"] - jout["nnz_w"]) <= 2
    wt = TCK.load_weights_text(tmodel, 1024)
    wj = TCK.load_weights_text(jmodel, 1024)
    np.testing.assert_allclose(wt, wj, rtol=1e-3, atol=1e-4)
    # a checkpoint of either package loads in the other
    (st, mt), (sj, mj) = JCK.load_checkpoint(tck), TCK.load_checkpoint(jck)
    assert mt == mj == {"algo": "darlin", "num_keys": 1024}
    np.testing.assert_array_equal(st["w"], wt)
    np.testing.assert_array_equal(sj["w"], wj)
    assert st["w"].dtype == sj["w"].dtype == np.float32


def test_cli_darlin_refuses_resume(tmp_path):
    cfg = _cli_files(tmp_path, n=1300)
    app_file = tmp_path / "d.json"
    app_file.write_text(json.dumps(cfg))
    with pytest.raises(SystemExit, match="resume"):
        TC.main(["train", "--app_file", str(app_file), "--resume", "--ckpt_dir",
                 str(tmp_path), "--device", "cpu"])


def test_cli_train_darlin_on_a_2x1_world_matches_jax_mesh(tmp_path, capsys):
    """``cli train`` darlin on a 2x1 world of gloo ranks with a block cache
    (rank 0 writes it, rank 1 waits and reads it) against the JAX CLI on a
    2x1 mesh of the same config: rank 0's result, its model and its
    checkpoint."""
    cfg = _cli_files(tmp_path)
    cfg["parallel"] = {"data_shards": 2, "kv_shards": 1}
    cfg["data"]["cache_dir"] = str(tmp_path / "cache")
    app_file = tmp_path / "mesh.json"
    app_file.write_text(json.dumps(cfg))
    model, ckpt = tmp_path / "port.txt", tmp_path / "port_ck"

    def argvs(port):
        return [[str(RANK_SCRIPT), "cli", "train", "--app_file", str(app_file),
                 "--device", "cpu", "--model_out", str(model), "--ckpt_dir", str(ckpt),
                 "--coordinator", f"127.0.0.1:{port}", "--num_processes", "2",
                 "--process_id", str(r)] for r in range(2)]

    results = [json.loads(o.strip().splitlines()[-1]) for o in run_world(argvs)]
    assert [r["mesh"] for r in results] == [{"data": 2, "kv": 1}] * 2
    assert (tmp_path / "cache" / "meta.json").exists()
    jcfg = dict(cfg, data=dict(cfg["data"], cache_dir=""))
    jfile = tmp_path / "jmesh.json"
    jfile.write_text(json.dumps(jcfg))
    jmodel = tmp_path / "jax.txt"
    capsys.readouterr()
    assert JC.main(["train", "--app_file", str(jfile), "--model_out", str(jmodel)]) == 0
    jout = _last_json(capsys)
    got = results[0]
    for k in ("objv", "train_auc", "val_auc", "val_logloss"):
        np.testing.assert_allclose(got[k], jout[k], rtol=HIST_RTOL, err_msg=k)
        assert results[1][k] == got[k]
    assert got["iters"] == jout["iters"]
    np.testing.assert_allclose(TCK.load_weights_text(model, 1024),
                               TCK.load_weights_text(jmodel, 1024), rtol=1e-3, atol=1e-4)
    st, meta = JCK.load_checkpoint(ckpt)
    assert meta["algo"] == "darlin" and st["w"].shape == (1024,)


def test_world_results_are_rank_independent(world):
    """Every case ran to its reported pass count on every rank."""
    for name, _, _, kw in WORLD_CASES:
        assert 1 <= world["res"][f"{name}/iters"] <= kw["iters"]
        assert len(_hist(world, name)) == world["res"][f"{name}/iters"]
