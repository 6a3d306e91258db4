"""Port parity: the torch updaters against the JAX package's, on the CPU.

The same rows and gradients (numpy, seeded) go through both; delta and
weights agree to a few float32 ULPs (rtol/atol 1e-6: the two frameworks
round the same op order, so only contraction differences remain), and
FTRL's lazy weight is exactly 0 wherever |z| <= lambda_l1."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.kv import updaters as J
from parameter_server_tpu_torch.kv import updaters as T

torch.set_num_threads(1)

CASES = [
    ("sgd", {"eta": 0.3, "lambda_l2": 0.1}, ("w",)),
    ("adagrad", {"eta": 0.2, "eps": 1e-8, "lambda_l2": 0.05}, ("w", "n")),
    ("ftrl", {"alpha": 0.3, "beta": 1.0, "lambda_l1": 0.5, "lambda_l2": 0.1}, ("z", "n")),
    ("ftrl", {"alpha": 0.1, "beta": 1.0, "lambda_l1": 1.0, "lambda_l2": 0.0}, ("z", "n")),
]
TOL = {"rtol": 1e-6, "atol": 1e-6}


def _rows(seed, shape, keys):
    rng = np.random.default_rng(seed)
    rows = {k: (rng.normal(size=shape) * 2).astype(np.float32) for k in keys}
    if "n" in rows:
        rows["n"] = np.abs(rows["n"])
    g = rng.normal(size=shape).astype(np.float32)
    return rows, g


@pytest.mark.parametrize("algo,kw,keys", CASES)
@pytest.mark.parametrize("shape", [(300, 1), (77, 8)])
def test_delta_and_weights_match_jax(algo, kw, keys, shape):
    rows, g = _rows(1, shape, keys)
    ju, tu = J.make_updater(algo, **kw), T.make_updater(algo, **kw)
    jrows = {k: jnp.asarray(v) for k, v in rows.items()}
    trows = {k: torch.from_numpy(v.copy()) for k, v in rows.items()}
    jd = ju.delta(jrows, jnp.asarray(g))
    td = tu.delta(trows, torch.from_numpy(g))
    assert set(td) == set(jd) == set(keys)
    for k in keys:
        np.testing.assert_allclose(td[k].numpy(), np.asarray(jd[k]), **TOL)
    np.testing.assert_allclose(
        tu.weights(trows).numpy(), np.asarray(ju.weights(jrows)), **TOL
    )
    ja = J.apply_update(ju, jrows, jnp.asarray(g))
    ta = T.apply_update(tu, trows, torch.from_numpy(g))
    for k in keys:
        np.testing.assert_allclose(ta[k].numpy(), np.asarray(ja[k]), **TOL)


@pytest.mark.parametrize("l1", [0.5, 1.0, 2.5])
def test_ftrl_weight_exactly_zero_inside_l1(l1):
    rows, _ = _rows(2, (500, 2), ("z", "n"))
    up = T.Ftrl(alpha=0.1, beta=1.0, lambda_l1=l1, lambda_l2=0.01)
    w = up.weights({k: torch.from_numpy(v) for k, v in rows.items()}).numpy()
    inside = np.abs(rows["z"]) <= l1
    assert inside.any() and (~inside).any()
    assert np.all(w[inside] == 0.0)
    assert np.all(w[~inside] != 0.0)
    jw = np.asarray(J.Ftrl(alpha=0.1, beta=1.0, lambda_l1=l1, lambda_l2=0.01)
                    .weights({k: jnp.asarray(v) for k, v in rows.items()}))
    assert np.all(jw[inside] == 0.0)


@pytest.mark.parametrize("algo,keys", [("sgd", ("w",)), ("adagrad", ("w", "n")),
                                       ("ftrl", ("z", "n"))])
def test_init_matches_jax_layout(algo, keys):
    j = J.make_updater(algo).init(10, 3)
    t = T.make_updater(algo).init(10, 3, device="cpu")
    assert set(t) == set(j) == set(keys)
    for k in keys:
        assert tuple(t[k].shape) == j[k].shape and t[k].dtype == torch.float32
        assert not t[k].any()
    # distinct buffers: an in-place push must not alias two tables
    assert len({v.data_ptr() for v in t.values()}) == len(keys)


def test_make_updater_rejects_unknown():
    with pytest.raises(ValueError, match="unknown updater"):
        T.make_updater("adam")
    with pytest.raises(ValueError, match="hyperparameter"):
        T.make_updater("sgd", alpha=1.0)
    # the JAX package's kernel switch has no counterpart: the device decides
    with pytest.raises(ValueError, match="use_pallas"):
        T.make_updater("ftrl", use_pallas=True)
