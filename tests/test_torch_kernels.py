"""Port parity for the FTRL kernels' plain versions and their wrappers.

On the CPU the wrappers run the plain PyTorch versions; these are held
against the JAX package's Pallas kernels run in interpret mode (as
tests/test_pallas.py runs them). The CUDA kernels themselves run only on
the card: tests/test_torch_cuda.py and ``chip_smoke.py`` compare them with
their plain versions there."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.ops.pallas_kernels import ftrl_delta_pallas, ftrl_push_pallas
from parameter_server_tpu_torch.ops import adagrad_kernels as ak
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
@pytest.mark.parametrize(
    "shape", [(300, 2), (1000, 1), (64, 8), (9, 1), (6, 3), (4099, 1)])
def test_delta_plain_matches_pallas(interpret_mode, hyper, shape):
    """Also at counts whose last 1, 2 or 3 elements the CUDA kernel takes
    in scalar code after its float4 body."""
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


_PLAIN_PUSHES = {
    "ftrl": (fk.ftrl_push_plain, HYPERS[0]),
    "adagrad": (ak.adagrad_push_plain, {"eta": 0.05, "eps": 1e-8, "l2": 0.01}),
}


@pytest.mark.parametrize("begin", [0, 64])
@pytest.mark.parametrize("which", sorted(_PLAIN_PUSHES))
def test_plain_push_skips_rows_outside_the_table(which, begin):
    """As the kernels do: slots -1 and K (and, on a shard view given
    ``idx - begin``, every key of another shard) are skipped, not an
    IndexError, and their rows keep their bits."""
    plain, hyper = _PLAIN_PUSHES[which]
    rng = np.random.default_rng(11)
    K, vdim = 64, 4
    full_a = rng.normal(size=(3 * K, vdim)).astype(np.float32)
    full_b = np.abs(rng.normal(size=(3 * K, vdim))).astype(np.float32)
    full_a[begin] = full_b[begin] = 0.0  # the pad row the l2 pad slots rely on
    keys = rng.choice(np.arange(1, 3 * K), 40, replace=False)
    idx = np.concatenate([keys - begin, [0, 0], [-1, K]]).astype(np.int32)
    g = rng.normal(size=(len(idx), vdim)).astype(np.float32)
    g[-4:-2] = 0.0
    a, b = torch.from_numpy(full_a.copy()), torch.from_numpy(full_b.copy())
    plain(a[begin:begin + K], b[begin:begin + K], torch.from_numpy(idx),
          torch.from_numpy(g), **hyper)
    inside = (idx >= 0) & (idx < K)
    ea, eb = torch.from_numpy(full_a.copy()), torch.from_numpy(full_b.copy())
    plain(ea[begin:begin + K], eb[begin:begin + K], torch.from_numpy(idx[inside]),
          torch.from_numpy(g[inside]), **hyper)
    assert torch.equal(a, ea) and torch.equal(b, eb)
    touched = np.unique(idx[inside]) + begin
    outside = np.setdiff1d(np.arange(3 * K), touched)
    np.testing.assert_array_equal(a.numpy()[outside], full_a[outside])
    np.testing.assert_array_equal(b.numpy()[outside], full_b[outside])
    assert (~inside).sum() >= 2


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



def test_library_key_covers_every_source_and_flag(tmp_path, monkeypatch):
    """One library holds every csrc/*.cu: an edit to any of them, or to the
    flags, must name a new library, never reload a stale one."""
    from parameter_server_tpu_torch.ops import cuda_build

    assert {s.name for s in cuda_build.sources()} >= {"ftrl.cu", "adagrad.cu"}
    monkeypatch.setattr(cuda_build, "CSRC", tmp_path)
    monkeypatch.setattr(cuda_build, "BUILD_DIR", tmp_path / "_build")
    (tmp_path / "a.cu").write_text("// a\n")
    (tmp_path / "b.cu").write_text("// b\n")
    seen = {cuda_build.library_path()}
    (tmp_path / "b.cu").write_text("// b, edited\n")
    seen.add(cuda_build.library_path())
    (tmp_path / "c.cu").write_text("")
    seen.add(cuda_build.library_path())
    monkeypatch.setattr(cuda_build, "NVCC_FLAGS", (*cuda_build.NVCC_FLAGS, "-lineinfo"))
    seen.add(cuda_build.library_path())
    assert len(seen) == 4
    assert all(p.parent == tmp_path / "_build" for p in seen)
    monkeypatch.setenv("PATH", str(tmp_path))
    monkeypatch.delenv("CUDA_HOME", raising=False)
    monkeypatch.delenv("CUDA_PATH", raising=False)
    if not os.path.exists("/usr/local/cuda/bin/nvcc"):
        with pytest.raises(RuntimeError, match="nvcc not found"):
            cuda_build.build()
