"""Port parity: the CSR segment sums and the logistic loss, on the CPU.

Tolerance rtol 1e-5 / atol 1e-6: XLA's segment_sum and torch's index_add_
add a row's entries in different orders."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.ops import sparse as J
from parameter_server_tpu_torch.ops import sparse as T

torch.set_num_threads(1)

TOL = {"rtol": 1e-5, "atol": 1e-6}


def _csr(seed, B=64, nnz=500, U=100):
    rng = np.random.default_rng(seed)
    values = rng.normal(size=nnz).astype(np.float32)
    local_ids = rng.integers(0, U, nnz).astype(np.int32)
    row_ids = np.sort(rng.integers(0, B, nnz)).astype(np.int32)
    values[-20:] = 0.0  # padded entries: value 0 -> slot 0, row 0
    local_ids[-20:] = 0
    row_ids[-20:] = 0
    return values, local_ids, row_ids, B, U, rng


@pytest.mark.parametrize("w_shape", ["flat", "column"])
def test_csr_logits_match_jax(w_shape):
    values, lid, rid, B, U, rng = _csr(1)
    w = rng.normal(size=(U, 1) if w_shape == "column" else U).astype(np.float32)
    j = J.csr_logits(jnp.asarray(w), jnp.asarray(values), jnp.asarray(lid),
                     jnp.asarray(rid), num_rows=B)
    t = T.csr_logits(torch.from_numpy(w), torch.from_numpy(values),
                     torch.from_numpy(lid), torch.from_numpy(rid), num_rows=B)
    assert tuple(t.shape) == (B,)
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_csr_grad_matches_jax():
    values, lid, rid, B, U, rng = _csr(2)
    err = rng.normal(size=B).astype(np.float32)
    j = J.csr_grad(jnp.asarray(err), jnp.asarray(values), jnp.asarray(lid),
                   jnp.asarray(rid), num_unique=U)
    t = T.csr_grad(torch.from_numpy(err), torch.from_numpy(values),
                   torch.from_numpy(lid), torch.from_numpy(rid), num_unique=U)
    assert tuple(t.shape) == (U, 1) and t.is_contiguous()
    np.testing.assert_allclose(t.numpy(), np.asarray(j), **TOL)


def test_logistic_loss_matches_jax_beyond_softplus_threshold():
    rng = np.random.default_rng(3)
    logits = np.concatenate([
        rng.normal(size=40) * 5,
        [-100.0, -30.0, -20.5, 20.5, 25.0, 30.0, 60.0, 100.0, 0.0],
    ]).astype(np.float32)
    labels = (rng.random(len(logits)) < 0.5).astype(np.float32)
    mask = np.ones(len(logits), bool)
    mask[-3:] = False
    jl, je = J.logistic_loss(jnp.asarray(logits), jnp.asarray(labels), jnp.asarray(mask))
    tl, te = T.logistic_loss(torch.from_numpy(logits), torch.from_numpy(labels),
                             torch.from_numpy(mask))
    np.testing.assert_allclose(float(tl), float(jl), rtol=1e-6)
    np.testing.assert_allclose(te.numpy(), np.asarray(je), **TOL)
    # far below zero softplus is e^x, not 0: a label-0 logit of -30 costs
    # log1p(e^-30) ~ 9.4e-14
    one = T.logistic_loss(torch.tensor([-30.0]), torch.tensor([0.0]),
                          torch.tensor([True]))[0]
    np.testing.assert_allclose(float(one), np.log1p(np.exp(-30.0)), rtol=1e-6)
