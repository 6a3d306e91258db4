"""Port parity: the torch KV store against the JAX store, on the CPU.

Same tables, keys and gradients (numpy, seeded) through both stores.
Tolerance rtol/atol 1e-6: the updaters round the same op order; the port
scatter-adds with index_add_ where JAX uses .at[].add, which adds the same
single delta per row."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.kv import store as JS
from parameter_server_tpu.kv import updaters as JU
from parameter_server_tpu_torch.kv import store as TS
from parameter_server_tpu_torch.kv import updaters as TU

torch.set_num_threads(1)

TOL = {"rtol": 1e-6, "atol": 1e-6}
UPDATERS = [
    ("sgd", {"eta": 0.3, "lambda_l2": 0.1}),
    ("adagrad", {"eta": 0.2, "lambda_l2": 0.05}),
    ("ftrl", {"alpha": 0.1, "beta": 1.0, "lambda_l1": 1.0, "lambda_l2": 0.0}),
    ("ftrl", {"alpha": 0.3, "beta": 1.0, "lambda_l1": 0.5, "lambda_l2": 0.1}),
]


def _state(algo, K, vdim, seed):
    """A random state in the updater's layout; the pad row 0 is zero."""
    rng = np.random.default_rng(seed)
    keys = JU.make_updater(algo).init(2, 1).keys()
    st = {k: (rng.normal(size=(K, vdim)) * 2).astype(np.float32) for k in keys}
    if "n" in st:
        st["n"] = np.abs(st["n"])
    for v in st.values():
        v[0] = 0.0
    return st


def _push_args(K, vdim, u, seed, pads=3):
    rng = np.random.default_rng(seed)
    uniq = np.unique(rng.integers(1, K, u))
    idx = np.concatenate([uniq, np.zeros(pads, np.int64)]).astype(np.int32)
    g = rng.normal(size=(len(idx), vdim)).astype(np.float32)
    g[len(uniq):] = 0.0
    return idx, g


def _close(t_state, j_state):
    assert set(t_state) == set(j_state)
    for k in j_state:
        np.testing.assert_allclose(t_state[k].numpy(), np.asarray(j_state[k]), **TOL)


@pytest.mark.parametrize("algo,kw", UPDATERS)
@pytest.mark.parametrize("vdim", [1, 4])
def test_push_pull_match_jax(algo, kw, vdim):
    K = 1024
    st = _state(algo, K, vdim, 1)
    ju, tu = JU.make_updater(algo, **kw), TU.make_updater(algo, **kw)
    jst = {k: jnp.asarray(v) for k, v in st.items()}
    tst = TS.state_from_numpy(st, "cpu")
    for step in range(3):
        idx, g = _push_args(K, vdim, 200, 10 + step)
        jst = JS.push(ju, jst, jnp.asarray(idx), jnp.asarray(g))
        out = TS.push(tu, tst, idx, g)
        assert out is tst  # in place
        _close(tst, jst)
    q = np.array([0, 1, 5, 700, 1023], dtype=np.int32)
    np.testing.assert_allclose(
        TS.pull(tu, tst, q).numpy(), np.asarray(JS.pull(ju, jst, jnp.asarray(q))), **TOL
    )
    np.testing.assert_allclose(
        TS.materialize_weights(tu, tst).numpy(),
        np.asarray(JS.materialize_weights(ju, jst)), **TOL,
    )


@pytest.mark.parametrize("kw", [UPDATERS[2][1], UPDATERS[3][1]], ids=["l2=0", "l2>0"])
def test_coalesce_and_push_multi_match_jax(kw):
    rng = np.random.default_rng(3)
    K, vdim = 2048, 2
    idx_list = [np.unique(rng.integers(1, K, n)) for n in (300, 50, 400)]
    idx_list.append(idx_list[0][:40])  # overlapping keys across pushes
    grad_list = [rng.normal(size=(len(i), vdim)).astype(np.float32) for i in idx_list]
    ju, ui = JS.coalesce_pushes(idx_list, grad_list)
    tu_, tg = TS.coalesce_pushes(idx_list, grad_list)
    np.testing.assert_array_equal(tu_, ju)
    np.testing.assert_array_equal(tg, ui)
    st = _state("ftrl", K, vdim, 4)
    jst = JS.push_multi(JU.Ftrl(**kw), {k: jnp.asarray(v) for k, v in st.items()},
                        idx_list, grad_list)
    tst = TS.push_multi(TU.Ftrl(**kw), TS.state_from_numpy(st, "cpu"),
                        idx_list, grad_list)
    _close(tst, jst)


def test_kvstore_matches_jax_kvstore():
    kw = UPDATERS[3][1]
    K = 4096
    js = JS.KVStore(JU.Ftrl(**kw), K)
    ts = TS.KVStore(TU.Ftrl(**kw), K, device="cpu")
    assert ts.device == torch.device("cpu") and ts.nnz() == 0
    rng = np.random.default_rng(5)
    for _ in range(3):
        idx_list = [np.unique(rng.integers(1, K, 300)) for _ in range(4)]
        grad_list = [rng.normal(size=len(i)).astype(np.float32) for i in idx_list]
        js.push_multi(idx_list, grad_list)
        ts.push_multi(idx_list, grad_list)
    idx, g = _push_args(K, 1, 100, 6)
    js.push(jnp.asarray(idx), jnp.asarray(g))
    ts.push(torch.from_numpy(idx), torch.from_numpy(g))
    _close(ts.state, js.state)
    np.testing.assert_allclose(
        ts.pull(idx).numpy(), np.asarray(js.pull(jnp.asarray(idx))), **TOL
    )
    np.testing.assert_allclose(ts.weights().numpy(), np.asarray(js.weights()), **TOL)
    assert ts.nnz() == js.nnz() > 0
    assert ts.nnz(tol=0.05) == js.nnz(tol=0.05)


def test_state_numpy_round_trip():
    jst = JU.Ftrl().init(64, 3)
    st = {k: np.asarray(v) for k, v in jst.items()}
    st["z"] = np.arange(64 * 3, dtype=np.float32).reshape(64, 3)
    t = TS.state_from_numpy(st, "cpu")
    assert all(v.dtype == torch.float32 and v.is_contiguous() for v in t.values())
    back = TS.state_to_numpy(t)
    for k in st:
        assert back[k].dtype == st[k].dtype and back[k].shape == st[k].shape
        np.testing.assert_array_equal(back[k], st[k])
    # copies both ways: later in-place pushes touch neither side's arrays
    t["z"].add_(1.0)
    np.testing.assert_array_equal(back["z"], st["z"])


def test_pad_state_rows_matches_jax():
    st = _state("adagrad", 10, 2, 7)
    jp = JS.pad_state_rows({k: jnp.asarray(v) for k, v in st.items()}, 16)
    tp = TS.pad_state_rows(TS.state_from_numpy(st, "cpu"), 16)
    _close(tp, jp)
    with pytest.raises(ValueError):
        TS.pad_state_rows(tp, 8)


def test_push_rejects_out_of_range_keys():
    ts = TS.KVStore(TU.Ftrl(), 100, device="cpu")
    with pytest.raises(IndexError):
        ts.push(np.array([1, 100]), np.ones((2, 1), np.float32))
    with pytest.raises(IndexError):
        ts.pull(np.array([-1]))


ALGOS = {"sgd": UPDATERS[0][1], "adagrad": UPDATERS[1][1], "ftrl": UPDATERS[3][1]}


@pytest.mark.parametrize("algo", list(ALGOS))
def test_push_skips_index_tensor_slots_outside_the_table(algo):
    """A device-tensor index (no host bounds check): slots on rows -1 and
    K among the real rows leave every table bit for bit as a push of the
    real rows alone, for every updater (FTRL and AdaGrad through their
    fused pushes' plain versions, SGD through the store's masked route)."""
    K, vdim = 512, 4
    up = TU.make_updater(algo, **ALGOS[algo])
    host = _state(algo, K, vdim, 5)
    idx, g = _push_args(K, vdim, 60, 6, pads=0)
    rng = np.random.default_rng(7)
    order = rng.permutation(len(idx) + 4)
    all_idx = np.concatenate([idx, np.array([-1, K, -1, K], np.int32)])[order]
    all_g = np.concatenate([g, rng.normal(size=(4, vdim)).astype(np.float32)])[order]
    want = TS.push(up, TS.state_from_numpy(host, "cpu"), torch.from_numpy(idx),
                   torch.from_numpy(g))
    got = TS.push(up, TS.state_from_numpy(host, "cpu"), torch.from_numpy(all_idx),
                  torch.from_numpy(all_g))
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("algo", list(ALGOS))
def test_push_repeated_adds_a_delta_an_occurrence(algo):
    """``push_repeated``: every occurrence's delta from the same pre-push
    row, ``index_add_``ed, bit for bit (the JAX ``.at[].add``); slots on
    rows -1 and K are skipped as ``push`` skips them."""
    K, vdim = 256, 4
    up = TU.make_updater(algo, **ALGOS[algo])
    host = _state(algo, K, vdim, 8)
    rng = np.random.default_rng(9)
    real = rng.integers(1, 40, 300).astype(np.int32)  # hot ids repeat
    assert len(np.unique(real)) < len(real)
    idx = np.concatenate([real[:150], np.array([-1, K], np.int32), real[150:]])
    g = rng.normal(size=(len(idx), vdim)).astype(np.float32)
    g_real = np.concatenate([g[:150], g[152:]])
    got = TS.push_repeated(up, TS.state_from_numpy(host, "cpu"), torch.from_numpy(idx),
                           torch.from_numpy(g))
    want = TS.state_from_numpy(host, "cpu")
    rows = torch.from_numpy(real).long()
    deltas = up.delta({k: v.index_select(0, rows) for k, v in want.items()},
                      torch.from_numpy(g_real))
    for k, v in want.items():
        v.index_add_(0, rows, deltas[k])
    for k in want:
        assert torch.equal(got[k], want[k]), k


@pytest.mark.parametrize("algo", list(ALGOS))
def test_push_repeated_reuses_the_rows_it_is_handed(algo):
    """``push_repeated`` handed the caller's ``pull_rows`` gives the bits
    of its own gather, and ``pull`` is the updater's weights of those
    rows (word2vec's step pulls once and pushes with its rows)."""
    K, vdim = 256, 4
    up = TU.make_updater(algo, **ALGOS[algo])
    host = _state(algo, K, vdim, 10)
    rng = np.random.default_rng(11)
    idx = torch.from_numpy(rng.integers(0, 40, 300).astype(np.int32))  # hot ids repeat
    g = torch.from_numpy(rng.normal(size=(300, vdim)).astype(np.float32))
    handed = TS.state_from_numpy(host, "cpu")
    rows = TS.pull_rows(handed, idx)
    assert torch.equal(TS.pull(up, handed, idx), up.weights(rows))
    TS.push_repeated(up, handed, idx, g, rows=rows)
    want = TS.push_repeated(up, TS.state_from_numpy(host, "cpu"), idx, g)
    for k in want:
        assert torch.equal(handed[k], want[k]), k


def test_kvstore_defaults_to_cuda():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device works")
    with pytest.raises(RuntimeError, match="cuda"):
        TS.KVStore(TU.Ftrl(), 16)
