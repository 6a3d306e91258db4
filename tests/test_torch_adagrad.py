"""Port parity for the AdaGrad push (K3): its plain version and its wrapper.

On the CPU the wrapper runs the plain PyTorch version; both are held
against the JAX package's ``adagrad_push_pallas`` in interpret mode (as
tests/test_pallas.py runs it) and against the JAX ``kv.store.push`` with
an ``Adagrad`` updater, at tests/test_pallas.py's cases: embedding-shaped
vdims, l2 0 and 0.01, duplicate pad slots (row 0 zero where l2 > 0). The
CUDA kernel runs only on the card: tests/test_torch_cuda.py and
``chip_smoke.py`` compare it with its plain version there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.kv import store as JS
from parameter_server_tpu.kv import updaters as JU
from parameter_server_tpu.ops.pallas_kernels import adagrad_push_pallas
from parameter_server_tpu_torch.kv import store as TS
from parameter_server_tpu_torch.kv import updaters as TU
from parameter_server_tpu_torch.ops import adagrad_kernels as ak

torch.set_num_threads(1)

TOL = {"rtol": 1e-6, "atol": 1e-6}
ETA, EPS = 0.1, 1e-8
# (vdim, draws, l2), the cases of tests/test_pallas.py
CASES = [(16, 300, 0.01), (64, 40, 0.01), (16, 120, 0.0)]


@pytest.fixture()
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("this jax's pallas has no force_tpu_interpret_mode")
    with pltpu.force_tpu_interpret_mode():
        yield


def _case(vdim, u, l2, K=1024, seed=0):
    """Random w, n (row 0 zero where l2 > 0, the pad-row invariant; random
    where l2 == 0, to show a zero gradient is inert for any state there)
    and a unique key set with two duplicate pad slots."""
    rng = np.random.default_rng(seed)
    w = rng.normal(size=(K, vdim)).astype(np.float32)
    n = np.abs(rng.normal(size=(K, vdim))).astype(np.float32)
    if l2 > 0.0:
        w[0] = 0.0
        n[0] = 0.0
    uniq = np.unique(rng.integers(1, K, u))
    idx = np.concatenate([uniq, [0, 0]]).astype(np.int32)
    g = rng.normal(size=(len(idx), vdim)).astype(np.float32)
    g[len(uniq):] = 0.0
    return w, n, uniq, idx, g


@pytest.mark.parametrize("vdim,u,l2", CASES)
def test_push_matches_pallas_and_jax_store(interpret_mode, vdim, u, l2):
    w, n, uniq, idx, g = _case(vdim, u, l2)
    pallas = adagrad_push_pallas(  # donates its state: fresh arrays each
        {"w": jnp.asarray(w), "n": jnp.asarray(n)}, jnp.asarray(idx),
        jnp.asarray(g), eta=ETA, eps=EPS, l2=l2,
    )
    composite = JS.push(JU.Adagrad(eta=ETA, eps=EPS, lambda_l2=l2),
                        {"w": jnp.asarray(w), "n": jnp.asarray(n)},
                        jnp.asarray(idx), jnp.asarray(g))
    for f in (ak.adagrad_push_plain, ak.adagrad_push):
        tw, tn = torch.from_numpy(w.copy()), torch.from_numpy(n.copy())
        out = f(tw, tn, torch.from_numpy(idx), torch.from_numpy(g), eta=ETA,
                eps=EPS, l2=l2)
        assert out[0] is tw and out[1] is tn  # in place
        for ref in (pallas, composite):
            np.testing.assert_allclose(tw.numpy(), np.asarray(ref["w"]), **TOL)
            np.testing.assert_allclose(tn.numpy(), np.asarray(ref["n"]), **TOL)
        untouched = np.setdiff1d(np.arange(len(w)), uniq)  # row 0 included
        np.testing.assert_array_equal(tw.numpy()[untouched], w[untouched])
        np.testing.assert_array_equal(tn.numpy()[untouched], n[untouched])


@pytest.mark.parametrize("vdim,l2", [(16, 0.01), (64, 0.0)])
def test_store_push_and_push_multi_match_jax(vdim, l2):
    K = 2048
    w, n, _, _, _ = _case(vdim, 10, 0.01, K=K, seed=1)  # row 0 zero
    ju = JU.Adagrad(eta=0.2, eps=EPS, lambda_l2=l2)
    tu = TU.Adagrad(eta=0.2, eps=EPS, lambda_l2=l2)
    jst = {"w": jnp.asarray(w), "n": jnp.asarray(n)}
    tst = TS.state_from_numpy({"w": w, "n": n}, "cpu")
    ak.reset_launches()
    for step in range(3):
        _, _, _, idx, g = _case(vdim, 200, 0.01, K=K, seed=10 + step)
        jst = JS.push(ju, jst, jnp.asarray(idx), jnp.asarray(g))
        assert TS.push(tu, tst, idx, g) is tst
    rng = np.random.default_rng(2)
    idx_list = [np.unique(rng.integers(1, K, c)) for c in (300, 50, 400)]
    idx_list.append(idx_list[0][:40])  # keys shared across pushes
    grad_list = [rng.normal(size=(len(i), vdim)).astype(np.float32) for i in idx_list]
    jst = JS.push_multi(ju, jst, idx_list, grad_list)
    TS.push_multi(tu, tst, idx_list, grad_list)
    for k in ("w", "n"):
        np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), **TOL)
    assert ak.LAUNCHES == {"adagrad_push": 0}  # CPU: the plain path


def test_wrapper_takes_plain_path_on_cpu():
    w, n, _, idx, g = _case(16, 50, 0.01)
    args = (torch.from_numpy(idx), torch.from_numpy(g))
    ak.reset_launches()
    kw, kn = torch.from_numpy(w.copy()), torch.from_numpy(n.copy())
    ak.adagrad_push(kw, kn, *args, eta=ETA, eps=EPS, l2=0.01)
    pw, pn = torch.from_numpy(w.copy()), torch.from_numpy(n.copy())
    ak.adagrad_push_plain(pw, pn, *args, eta=ETA, eps=EPS, l2=0.01)
    assert torch.equal(kw, pw) and torch.equal(kn, pn)
    assert ak.LAUNCHES == {"adagrad_push": 0}


@pytest.mark.parametrize("bad,exc,match", [
    ("idx_int64", TypeError, "int32"),
    ("w_strided", ValueError, "contiguous"),
    ("grad_strided", ValueError, "contiguous"),
    ("grad_width", ValueError, "grad"),
    ("w_float64", TypeError, "float32"),
    ("n_shape", ValueError, "equal"),
    ("idx_2d", ValueError, "idx"),
    ("w_meta", ValueError, "device"),
])
def test_wrapper_raises_on_bad_input(bad, exc, match):
    a = {
        "w": torch.zeros(16, 4), "n": torch.zeros(16, 4),
        "idx": torch.tensor([1, 2, 3], dtype=torch.int32), "grad": torch.ones(3, 4),
    }
    a.update({
        "idx_int64": {"idx": a["idx"].long()},
        "w_strided": {"w": torch.zeros(4, 16).t()},
        "grad_strided": {"grad": torch.ones(4, 3).t()},
        "grad_width": {"grad": torch.ones(3, 2)},
        "w_float64": {"w": a["w"].double()},
        "n_shape": {"n": torch.zeros(8, 4)},
        "idx_2d": {"idx": a["idx"][None]},
        "w_meta": {"w": torch.empty(16, 4, device="meta")},
    }[bad])
    with pytest.raises(exc, match=match):
        ak.adagrad_push(a["w"], a["n"], a["idx"], a["grad"], eta=ETA, eps=EPS, l2=0.0)
