"""Port parity for the FTRL kernels' plain versions and their wrappers.

On the CPU the wrappers run the plain PyTorch versions; these are held
against the JAX package's Pallas kernels run in interpret mode (as
tests/test_pallas.py runs them). The CUDA kernels themselves run only on
the card: tests/test_torch_cuda.py and ``chip_smoke.py`` compare them with
their plain versions there."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.ops.pallas_kernels import ftrl_delta_pallas, ftrl_push_pallas
from parameter_server_tpu_torch.ops import ftrl_kernels as fk

torch.set_num_threads(1)

HYPERS = [
    {"alpha": 0.3, "beta": 1.0, "l1": 0.5, "l2": 0.1},
    {"alpha": 0.1, "beta": 1.0, "l1": 1.0, "l2": 0.0},
]
TOL = {"rtol": 1e-6, "atol": 1e-6}


@pytest.fixture()
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("this jax's pallas has no force_tpu_interpret_mode")
    with pltpu.force_tpu_interpret_mode():
        yield


def _znG(seed, shape):
    rng = np.random.default_rng(seed)
    z = (rng.normal(size=shape) * 2).astype(np.float32)
    n = np.abs(rng.normal(size=shape) * 2).astype(np.float32)
    g = rng.normal(size=shape).astype(np.float32)
    return z, n, g


@pytest.mark.parametrize("hyper", HYPERS)
@pytest.mark.parametrize("shape", [(300, 2), (1000, 1), (64, 8)])
def test_delta_plain_matches_pallas(interpret_mode, hyper, shape):
    z, n, g = _znG(3, shape)
    jdz, jdn = ftrl_delta_pallas(jnp.asarray(z), jnp.asarray(n), jnp.asarray(g), **hyper)
    args = [torch.from_numpy(a) for a in (z, n, g)]
    for f in (fk.ftrl_delta_plain, fk.ftrl_delta):
        dz, dn = f(*args, **hyper)
        np.testing.assert_allclose(dz.numpy(), np.asarray(jdz), **TOL)
        np.testing.assert_allclose(dn.numpy(), np.asarray(jdn), **TOL)
    # w == 0 exactly where |z| <= l1, so dz is exactly g there
    inside = np.abs(z) <= hyper["l1"]
    assert inside.any()
    np.testing.assert_array_equal(dz.numpy()[inside], g[inside])


@pytest.mark.parametrize("vdim,u", [(1, 300), (1, 256), (8, 77), (16, 5)])
def test_push_plain_matches_pallas(interpret_mode, vdim, u):
    hyper = HYPERS[1]
    rng = np.random.default_rng(4)
    K = 2048
    z = rng.normal(size=(K, vdim)).astype(np.float32)
    n = np.abs(rng.normal(size=(K, vdim))).astype(np.float32)
    uniq = np.unique(rng.integers(1, K, u))
    idx = np.concatenate([uniq, [0, 0]]).astype(np.int32)  # duplicate pads
    g = rng.normal(size=(len(idx), vdim)).astype(np.float32)
    g[len(uniq):] = 0.0
    ref = ftrl_push_pallas(
        {"z": jnp.asarray(z), "n": jnp.asarray(n)}, jnp.asarray(idx),
        jnp.asarray(g), **hyper,
    )
    for f in (fk.ftrl_push_plain, fk.ftrl_push):
        tz, tn = torch.from_numpy(z.copy()), torch.from_numpy(n.copy())
        out = f(tz, tn, torch.from_numpy(idx), torch.from_numpy(g), **hyper)
        assert out[0] is tz and out[1] is tn  # in place
        np.testing.assert_allclose(tz.numpy(), np.asarray(ref["z"]), **TOL)
        np.testing.assert_allclose(tn.numpy(), np.asarray(ref["n"]), **TOL)
        untouched = np.setdiff1d(np.arange(K), uniq)  # row 0 included
        np.testing.assert_array_equal(tz.numpy()[untouched], z[untouched])
        np.testing.assert_array_equal(tn.numpy()[untouched], n[untouched])


def test_wrappers_take_plain_path_on_cpu():
    fk.reset_launches()
    z, n, g = (torch.from_numpy(a) for a in _znG(5, (40, 1)))
    dz, dn = fk.ftrl_delta(z, n, g, **HYPERS[0])
    pz, pn = fk.ftrl_delta_plain(z, n, g, **HYPERS[0])
    assert torch.equal(dz, pz) and torch.equal(dn, pn)
    idx = torch.tensor([3, 7, 0, 0], dtype=torch.int32)
    zz, nn = z.clone(), n.clone()
    fk.ftrl_push(zz, nn, idx, torch.ones(4, 1), **HYPERS[0])
    fk.ftrl_push_plain(z, n, idx, torch.ones(4, 1), **HYPERS[0])
    assert torch.equal(zz, z) and torch.equal(nn, n)
    assert fk.LAUNCHES == {"ftrl_delta": 0, "ftrl_push": 0}


def test_wrappers_raise_on_bad_input():
    z = torch.zeros(16, 2)
    n = torch.zeros(16, 2)
    g = torch.ones(3, 2)
    idx = torch.tensor([1, 2, 3], dtype=torch.int32)
    h = HYPERS[1]
    with pytest.raises(TypeError, match="int32"):
        fk.ftrl_push(z, n, idx.long(), g, **h)
    with pytest.raises(ValueError, match="contiguous"):
        fk.ftrl_push(z.t().contiguous().t(), n, idx, g, **h)
    with pytest.raises(ValueError, match="contiguous"):
        fk.ftrl_push(z, n, idx, torch.ones(2, 3).t(), **h)
    with pytest.raises(ValueError, match="grad"):
        fk.ftrl_push(z, n, idx, torch.ones(3, 1), **h)
    with pytest.raises(TypeError, match="float32"):
        fk.ftrl_push(z.double(), n, idx, g, **h)
    with pytest.raises(ValueError, match="contiguous"):
        fk.ftrl_delta(z[:, :1], n[:, :1], torch.ones(16, 1), **h)
    with pytest.raises(ValueError, match="shapes differ"):
        fk.ftrl_delta(z, n, g, **h)
    with pytest.raises(TypeError, match="float32"):
        fk.ftrl_delta(z.half(), n.half(), torch.ones(16, 2).half(), **h)
    meta = torch.empty(16, 2, device="meta")
    with pytest.raises(ValueError, match="device"):
        fk.ftrl_delta(meta, meta, meta, **h)

