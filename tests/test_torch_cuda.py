"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so every test here is marked ``cuda`` and
skips where there is no card. The file imports nothing of JAX, so it also
runs where JAX is not installed, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` makes the same comparisons at full size."""

import numpy as np
import pytest
import torch

from parameter_server_tpu_torch.ops import ftrl_kernels as fk

HYPER = {"alpha": 0.1, "beta": 1.0, "l1": 1.0, "l2": 0.0}
# a second set with l2 > 0 and other alpha, l1, so every term of the kernels'
# weight is held against the plain version on the card
HYPERS = [HYPER, {"alpha": 0.3, "beta": 1.0, "l1": 0.5, "l2": 0.1}]
TOL = {"rtol": 1e-5, "atol": 1e-6}  # nvcc contracts multiply-adds into FMAs


@pytest.fixture()
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA card (CUDA kernels have no CPU mode)")
    return torch.device("cuda")


def _rand(gen, shape, dev):
    z = torch.randn(shape, generator=gen, device=dev) * 2
    n = torch.rand(shape, generator=gen, device=dev) * 4
    g = torch.randn(shape, generator=gen, device=dev)
    return z, n, g


@pytest.mark.cuda
@pytest.mark.parametrize("hyper", HYPERS)
@pytest.mark.parametrize("shape", [(4097, 1), (1000, 8), (3,)])
def test_delta_kernel_matches_plain(dev, shape, hyper):
    gen = torch.Generator(device=dev).manual_seed(1)
    z, n, g = _rand(gen, shape, dev)
    before = fk.LAUNCHES["ftrl_delta"]
    dz, dn = fk.ftrl_delta(z, n, g, **hyper)
    assert fk.LAUNCHES["ftrl_delta"] == before + 1
    pz, pn = fk.ftrl_delta_plain(z, n, g, **hyper)
    torch.testing.assert_close(dz, pz, **TOL)
    torch.testing.assert_close(dn, pn, **TOL)
    inside = z.abs() <= hyper["l1"]
    assert torch.equal(dz[inside], g[inside])  # w exactly 0 inside l1


@pytest.mark.cuda
@pytest.mark.parametrize("hyper", HYPERS)
@pytest.mark.parametrize("vdim", [1, 8, 16])
def test_push_kernel_matches_plain(dev, vdim, hyper):
    gen = torch.Generator(device=dev).manual_seed(2)
    K = 1 << 16
    z, n, _ = _rand(gen, (K, vdim), dev)
    uniq = np.unique(np.random.default_rng(3).integers(1, K, 5000))
    idx = torch.from_numpy(np.concatenate([uniq, [0, 0, 0]]).astype(np.int32)).to(dev)
    g = torch.randn((idx.shape[0], vdim), generator=gen, device=dev)
    g[-3:] = 0
    zk, nk = z.clone(), n.clone()
    before = fk.LAUNCHES["ftrl_push"]
    fk.ftrl_push(zk, nk, idx, g, **hyper)
    assert fk.LAUNCHES["ftrl_push"] == before + 1
    untouched = torch.ones(K, dtype=torch.bool, device=dev)
    untouched[idx[:-3].long()] = False  # row 0 (the pad row) stays in
    assert torch.equal(zk[untouched].view(torch.int32), z[untouched].view(torch.int32))
    assert torch.equal(nk[untouched].view(torch.int32), n[untouched].view(torch.int32))
    fk.ftrl_push_plain(z, n, idx, g, **hyper)
    torch.testing.assert_close(zk, z, **TOL)
    torch.testing.assert_close(nk, n, **TOL)


@pytest.mark.cuda
def test_wrappers_raise_on_cuda(dev):
    z = torch.zeros(8, 1, device=dev)
    with pytest.raises(TypeError, match="int32"):
        fk.ftrl_push(z, z.clone(), torch.tensor([1], device=dev), torch.ones(1, 1, device=dev),
                     **HYPER)
    with pytest.raises(ValueError, match="different devices"):
        fk.ftrl_delta(z, z, torch.zeros(8, 1), **HYPER)


@pytest.mark.cuda
def test_linear_method_on_card_matches_cpu(dev):
    from parameter_server_tpu_torch.data.batch import BatchBuilder
    from parameter_server_tpu_torch.data.synthetic import make_sparse_logistic
    from parameter_server_tpu_torch.models.linear import LinearMethod
    from parameter_server_tpu_torch.utils.config import PSConfig
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    labels, keys, vals, _ = make_sparse_logistic(1024, 2000, nnz_per_example=12, seed=4)
    builder = BatchBuilder(num_keys=1 << 14, batch_size=256, max_nnz_per_example=48)
    batches = [builder.build(labels[i:i + 256], keys[i:i + 256], vals[i:i + 256])
               for i in range(0, 1024, 256)]
    cfg = PSConfig()
    cfg.data.num_keys = 1 << 14
    hist = {}
    for device in ("cuda", "cpu"):
        rep = ProgressReporter(print_fn=lambda s: None)
        fk.reset_launches()
        LinearMethod(cfg, reporter=rep, device=device).train(batches, report_every=1)
        hist[device] = rep.history
        assert fk.LAUNCHES["ftrl_delta"] == (4 if device == "cuda" else 0)
    for a, b in zip(hist["cuda"], hist["cpu"]):
        np.testing.assert_allclose(a["objv"], b["objv"], rtol=1e-4)
