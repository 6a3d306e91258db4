"""Port parity for the gradient codecs and the stochastic quantizer (K4).

On the CPU the quantizer's wrapper runs its plain PyTorch version. The
TPU kernel's random stream cannot be reproduced (the port uses Philox), so
the port is held to the JAX package in two ways:

- the deterministic part from ``quantize_stochastic_pallas`` in interpret
  mode (as tests/test_pallas.py runs it): lo, scale and the admissible set
  {floor t, floor t + 1} of every element, and the saturated maximum (F1);
- the statistics from the JAX package's threefry ``FixedPointCodec.encode``
  and from first principles: unbiased means, round-up rates, independent
  streams for neighbouring seeds. Interpret mode rounds up every element
  whatever the seed (ROADMAP F2), so no statistic is taken from it.

The CUDA kernel runs only on the card: tests/test_torch_cuda.py and
``chip_smoke.py`` hold it to its plain version there, bit for bit."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.filters import fixed_point as JF
from parameter_server_tpu.filters import quant as JQ
from parameter_server_tpu.kv import store as JS
from parameter_server_tpu.kv import updaters as JU
from parameter_server_tpu.ops.pallas_kernels import quantize_stochastic_pallas
from parameter_server_tpu_torch.filters import fixed_point as TF
from parameter_server_tpu_torch.filters import quant as TQ
from parameter_server_tpu_torch.kv import store as TS
from parameter_server_tpu_torch.kv import updaters as TU
from parameter_server_tpu_torch.ops import quantize_kernels as qk

torch.set_num_threads(1)

QDTYPE = {1: (torch.int8, np.int8), 2: (torch.int16, np.int16)}
#: the decode error bound: one quantization step, plus the float32 roundings
#: of t = (x - lo)/scale and of the decode itself, a few units of 2^-24 of
#: the array's magnitude (the decode's product alone rounds by up to 2^-24
#: of the span, 65535 * 2^-24 = 0.4% of an int16 step)
ROUNDING_ULPS = 8


@pytest.fixture()
def interpret_mode():
    from jax.experimental.pallas import tpu as pltpu

    if not hasattr(pltpu, "force_tpu_interpret_mode"):
        pytest.skip("this jax's pallas has no force_tpu_interpret_mode")
    with pltpu.force_tpu_interpret_mode():
        yield


def _half(num_bytes):
    return ((1 << (8 * num_bytes)) - 1) // 2


def _encode(pkg, num_bytes, seed, x):
    """(q, lo, scale) as numpy of one package's ``FixedPointCodec.encode``."""
    if pkg == "jax":
        e = JF.FixedPointCodec(num_bytes).encode(jax.random.key(seed), jnp.asarray(x))
    else:
        e = TF.FixedPointCodec(num_bytes).encode(seed, torch.from_numpy(x))
    return np.asarray(e.q), np.float32(e.lo), np.float32(e.scale)


def _t(x, lo, scale):
    return (x - np.float32(lo)) / np.float32(scale)


def _round_ups(num_bytes, x, q, lo, scale):
    """(up, frac) over the elements that no clamp touches: up = 1 where the
    element was rounded up, frac = t - floor t its probability."""
    t = _t(x, lo, scale)
    fl = np.floor(t)
    keep = t < 2 * _half(num_bytes) - 1
    up = q[keep].astype(np.float64) + _half(num_bytes) - fl[keep]
    assert set(np.unique(up)) <= {0.0, 1.0}
    return up, (t - fl)[keep].astype(np.float64)


# ---------------------------------------------------------------------------
# Philox4x32-10
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("ctr,key,want", [
    ((0, 0, 0, 0), (0, 0), (0x6627E8D5, 0xE169C58D, 0xBC57AC4C, 0x9B00DBD8)),
    ((0xFFFFFFFF,) * 4, (0xFFFFFFFF,) * 2, (0x408F276D, 0x41C83B0E, 0xA20BC7C6, 0x6D5451FD)),
    ((0x243F6A88, 0x85A308D3, 0x13198A2E, 0x03707344), (0xA4093822, 0x299F31D0),
     (0xD16CFE09, 0x94FDCCEB, 0x5001E420, 0x24126EA1)),
])
def test_philox_known_answers(ctr, key, want):
    got = qk.philox4x32_10(torch.tensor([ctr], dtype=torch.int64), key)
    assert tuple(int(v) for v in got[0]) == want


def test_seed_key_and_stream_layout():
    assert qk.seed_key(5) == (5, 0)
    assert qk.seed_key((1 << 32) + 5) == (5, 1)
    assert qk.seed_key(-1) == (0xFFFFFFFF, 0xFFFFFFFF)
    bits = qk.philox_bits(11, 4 * 9 + 3, torch.device("cpu"))
    assert bits.shape == (39,) and bits.dtype == torch.int64
    for g in (0, 1, 9):  # element i: word i % 4 of the call with counter i / 4
        want = qk.philox4x32_10(torch.tensor([[g, 0, 0, 0]]), qk.seed_key(11))[0]
        n = min(4, 39 - 4 * g)
        assert torch.equal(bits[4 * g:4 * g + n], want[:n])


# ---------------------------------------------------------------------------
# the quantizer against the JAX kernel (deterministic part) and the codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_bytes", [1, 2])
@pytest.mark.parametrize("shape", [(700,), (33, 21)])
def test_quantizer_matches_pallas_kernel(interpret_mode, rng, num_bytes, shape):
    x = (rng.normal(size=shape) * 4).astype(np.float32)
    jq, jlo, jscale = quantize_stochastic_pallas(0, jnp.asarray(x), num_bytes=num_bytes)
    tq, tlo, tscale = qk.quantize_stochastic(0, torch.from_numpy(x), num_bytes)
    assert tq.dtype == QDTYPE[num_bytes][0] and np.asarray(jq).dtype == QDTYPE[num_bytes][1]
    assert tq.shape == x.shape and tlo.shape == tscale.shape == ()
    assert float(tlo) == float(jlo)
    np.testing.assert_allclose(float(tscale), float(jscale), rtol=1e-6)
    # every element rounds to floor t or floor t + 1 of its own t, clamped
    info = np.iinfo(QDTYPE[num_bytes][1])
    fl = np.floor(_t(x, tlo, tscale)) - _half(num_bytes)
    q = tq.numpy()
    ok = (q == np.clip(fl, info.min, info.max)) | (q == np.clip(fl + 1, info.min, info.max))
    assert ok.all()
    # F1: the maximum saturates to the type's top in both packages
    top = np.unravel_index(np.argmax(x), shape)
    assert q[top] == info.max and np.asarray(jq)[top] == info.max


@pytest.mark.parametrize("num_bytes", [1, 2])
def test_decode_matches_jax(rng, num_bytes):
    x = (rng.normal(size=3000) * 3 + 1).astype(np.float32)
    jc, tc = JF.FixedPointCodec(num_bytes), TF.FixedPointCodec(num_bytes)
    je = jc.encode(jax.random.key(1), jnp.asarray(x))
    te = tc.encode(1, torch.from_numpy(x))
    # each package's decode of the same arrays, both ways round
    for q, lo, scale in ((je.q, je.lo, je.scale), (te.q, te.lo, te.scale)):
        q, lo, scale = np.array(q), np.float32(lo), np.float32(scale)
        jd = jc.decode(JF.Encoded(jnp.asarray(q), jnp.asarray(lo), jnp.asarray(scale)))
        td = tc.decode(TF.Encoded(torch.from_numpy(q), torch.tensor(lo), torch.tensor(scale)))
        assert td.dtype == torch.float32 and td.shape == x.shape
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    # one step plus float32 roundings (ROUNDING_ULPS)
    tol = float(te.scale) + ROUNDING_ULPS * 2.0**-24 * (abs(x.min()) + abs(x.max()))
    assert np.abs(tc.decode(te).numpy() - x).max() <= tol


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_stochastic_rounding_unbiased(pkg):
    """tests/test_filters.py's check, for both packages: 0.3 lies between
    two levels of [0, 1], and the mean decode over 50 seeds finds it."""
    x = np.concatenate([np.full(2000, 0.3), [0.0, 1.0]]).astype(np.float32)
    decs = []
    for seed in range(50):
        q, lo, scale = _encode(pkg, 1, seed, x)
        decs.append(((q[:2000].astype(np.float32) + 127) * scale + lo).mean())
    assert abs(np.mean(decs) - 0.3) < 2e-3, np.mean(decs)


@pytest.mark.parametrize("num_bytes", [1, 2])
@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_round_up_rate_is_mean_frac(rng, pkg, num_bytes):
    """Each element rounds up with probability frac(t): over 2^16 elements
    the rate is within 4 sigma of the mean frac."""
    x = rng.normal(size=1 << 16).astype(np.float32)
    q, lo, scale = _encode(pkg, num_bytes, 3, x)
    up, frac = _round_ups(num_bytes, x, q, lo, scale)
    sigma = np.sqrt(np.sum(frac * (1 - frac))) / len(frac)
    assert abs(up.mean() - frac.mean()) < 4 * sigma


@pytest.mark.parametrize("pkg", ["jax", "torch"])
def test_neighbouring_seeds_are_uncorrelated(rng, pkg):
    """The rounding residuals (up - frac) of seeds s and s + 1 are
    uncorrelated: |rho| < 0.03 at 2^16 elements (about 8 sigma)."""
    x = rng.normal(size=1 << 16).astype(np.float32)
    res = []
    for seed in (7, 8):
        up, frac = _round_ups(1, x, *_encode(pkg, 1, seed, x))
        res.append(up - frac)
    assert abs(np.corrcoef(res[0], res[1])[0, 1]) < 0.03


def test_constant_array_and_payload():
    x = np.full(16, 3.5, np.float32)
    for pkg in ("jax", "torch"):
        q, lo, scale = _encode(pkg, 1, 0, x)
        np.testing.assert_allclose((q.astype(np.float32) + 127) * scale + lo, 3.5, atol=1e-6)
    tc = TF.FixedPointCodec(2)
    e = tc.encode_fast(0, torch.arange(8.0))
    assert e.q.dtype == torch.int16
    assert tc.bytes_saved(torch.arange(8.0)) == JF.FixedPointCodec(2).bytes_saved(
        jnp.arange(8.0)) == 0.5
    with pytest.raises(ValueError):
        TF.FixedPointCodec(num_bytes=4)


def test_encode_fast_is_encode_and_takes_plain_path_on_cpu(rng):
    x = torch.from_numpy(rng.normal(size=(40, 3)).astype(np.float32))
    qk.reset_launches()
    tc = TF.FixedPointCodec(1)
    a, b = tc.encode(5, x), tc.encode_fast(5, x)
    p = qk.quantize_stochastic_plain(5, x, 1)
    for e in (a, b):
        assert torch.equal(e.q, p[0]) and torch.equal(e.lo, p[1]) and torch.equal(e.scale, p[2])
    assert not torch.equal(tc.encode(6, x).q, a.q)
    assert qk.LAUNCHES == {"quantize_stochastic": 0}


@pytest.mark.parametrize("bad,exc,match", [
    ("x_float64", TypeError, "float32"),
    ("x_strided", ValueError, "contiguous"),
    ("x_empty", ValueError, "empty"),
    ("num_bytes", ValueError, "num_bytes"),
    ("params_shape", ValueError, "params"),
    ("x_meta", ValueError, "device"),
])
def test_quantizer_raises_on_bad_input(bad, exc, match):
    a = {"x": torch.ones(6, 4), "params": torch.tensor([0.0, 1.0]), "num_bytes": 1}
    a.update({
        "x_float64": {"x": torch.ones(6, 4, dtype=torch.float64)},
        "x_strided": {"x": torch.ones(4, 6).t()},
        "x_empty": {"x": torch.ones(0)},
        "num_bytes": {"num_bytes": 3},
        "params_shape": {"params": torch.tensor([0.0, 1.0, 2.0])},
        "x_meta": {"x": torch.empty(6, 4, device="meta"),
                   "params": torch.empty(2, device="meta")},
    }[bad])
    with pytest.raises(exc, match=match):
        qk.stochastic_round(0, a["x"], a["params"], a["num_bytes"])
    if bad != "params_shape":
        with pytest.raises(exc, match=match):
            qk.quantize_stochastic(0, a["x"], a["num_bytes"])


# ---------------------------------------------------------------------------
# the per-segment codec
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("num_bytes", [1, 2])
def test_segment_quantizer_is_the_original(rng, num_bytes):
    assert inspect.getsource(TQ.SegmentQuantizer) == inspect.getsource(JQ.SegmentQuantizer)
    assert inspect.getsource(TQ._qmax) == inspect.getsource(JQ._qmax)
    assert TQ._TINY == JQ._TINY
    x = (rng.normal(size=1000) * 0.1).astype(np.float32)
    x[:300] = 0.0  # one all-zero segment
    tq, jq = TQ.SegmentQuantizer(num_bytes, 256), JQ.SegmentQuantizer(num_bytes, 256)
    for a, b in ((tq.encode(3, x), jq.encode(3, x)), (tq.encode_nearest(x), jq.encode_nearest(x))):
        for u, v in zip(a, b):
            assert u.dtype == v.dtype
            np.testing.assert_array_equal(u, v)
    q, s = jq.encode(4, x)
    np.testing.assert_array_equal(tq.decode(q, s), jq.decode(q, s))
    assert tq.wire_bytes(1000) == jq.wire_bytes(1000)
    with pytest.raises(ValueError):
        TQ.SegmentQuantizer(3)


@pytest.mark.parametrize("num_bytes", [1, 2])
def test_segment_twins_match_jax(rng, num_bytes):
    seg = 256
    x = (rng.normal(size=6 * seg) * 0.1).astype(np.float32)
    x[seg:2 * seg] = 0.0  # a zero segment: scale _TINY, decodes to exact 0
    x[3 * seg] = 50.0  # an outlier coarsens only its segment
    qj, sj = JQ.quantize_segments(jax.random.key(0), x, num_bytes, seg)
    gen = torch.Generator().manual_seed(0)
    qt, st = TQ.quantize_segments(gen, torch.from_numpy(x), num_bytes, seg)
    np.testing.assert_array_equal(st.numpy(), np.asarray(sj))  # scales exact
    assert qt.dtype == QDTYPE[num_bytes][0] and qt.shape == x.shape
    qmax = JQ._qmax(num_bytes)
    assert int(qt.abs().max()) <= qmax  # the clip range
    fl = np.floor(x.reshape(-1, seg) / st.numpy()[:, None]).reshape(-1)
    q = qt.numpy()
    assert ((q == np.clip(fl, -qmax, qmax)) | (q == np.clip(fl + 1, -qmax, qmax))).all()
    for q_, s_ in ((qt.numpy(), st.numpy()), (np.array(qj), np.array(sj))):
        td = TQ.dequantize_segments(torch.from_numpy(q_), torch.from_numpy(s_), num_bytes, seg)
        jd = JQ.dequantize_segments(jnp.asarray(q_), jnp.asarray(s_), num_bytes, seg)
        np.testing.assert_allclose(td.numpy(), np.asarray(jd), rtol=1e-6, atol=1e-6)
    dec = TQ.dequantize_segments(qt, st, num_bytes, seg).numpy()
    assert not dec[seg:2 * seg].any()
    assert np.abs(dec - x).reshape(-1, seg).max(1).max() <= st.numpy().max() + 1e-12


def test_dequantize_flat_trims_a_ragged_payload(rng):
    x = (rng.normal(size=1000) * 0.3).astype(np.float32)
    q, s = JQ.SegmentQuantizer(1, 128).encode(2, x)
    td = TQ.dequantize_flat(torch.from_numpy(q), torch.from_numpy(s), 128)
    assert td.shape == (1000,)
    np.testing.assert_allclose(td.numpy(), np.asarray(JQ.dequantize_flat(
        jnp.asarray(q), jnp.asarray(s), 128)), rtol=1e-6, atol=1e-6)
    np.testing.assert_array_equal(td.numpy(), JQ.SegmentQuantizer(1, 128).decode(q, s))


def test_segment_twins_keep_the_pad_row_invariant():
    """0.0 -> q 0 -> 0.0 exactly: pad slots' zero gradient stays inert."""
    gen = torch.Generator().manual_seed(9)
    q, s = TQ.quantize_segments(gen, torch.zeros(512), 1, 128)
    assert not q.any() and not TQ.dequantize_segments(q, s, 1, 128).any()
    x = torch.zeros(256)
    x[7] = 1.0
    q, s = TQ.quantize_segments(gen, x, 2, 256)
    dec = TQ.dequantize_flat(q[:200], s, 256)
    assert dec[7] == 1.0 and not dec[8:].any() and not dec[:7].any()


# ---------------------------------------------------------------------------
# the filter round trip: worker encode -> server decode -> coalesce -> push
# ---------------------------------------------------------------------------


def test_filter_round_trip_matches_jax():
    K, vdim, eta, eps = 512, 8, 0.05, 1e-8
    rng = np.random.default_rng(4)
    tc, jc = TF.FixedPointCodec(1), JF.FixedPointCodec(1)
    store = TS.KVStore(TU.Adagrad(eta=eta, eps=eps), K, vdim=vdim, device="cpu")
    ju = JU.Adagrad(eta=eta, eps=eps)
    jst = {"w": jnp.zeros((K, vdim)), "n": jnp.zeros((K, vdim))}
    qk.reset_launches()
    seed = 100
    for _ in range(2):  # rounds of 3 workers with shared keys
        idx_list = [np.unique(rng.integers(1, K, 120)) for _ in range(3)]
        t_dec, j_dec = [], []
        for keys in idx_list:
            g = rng.normal(size=(len(keys), vdim)).astype(np.float32)
            e = tc.encode(seed, torch.from_numpy(g))
            seed += 1
            t_dec.append(tc.decode(e).numpy())
            j_dec.append(np.asarray(jc.decode(JF.Encoded(
                jnp.asarray(e.q.numpy()), jnp.asarray(float(e.lo)), jnp.asarray(float(e.scale))))))
            tol = float(e.scale) + ROUNDING_ULPS * 2.0**-24 * 2 * float(np.abs(g).max())
            assert np.abs(t_dec[-1] - g).max() <= tol
        uniq, summed = TS.coalesce_pushes(idx_list, t_dec)
        store.push(uniq, summed)
        ju_idx, ju_g = JS.coalesce_pushes(idx_list, j_dec)
        jst = JS.push(ju, jst, jnp.asarray(ju_idx), jnp.asarray(ju_g))
    for k in ("w", "n"):
        np.testing.assert_allclose(store.state[k].numpy(), np.asarray(jst[k]),
                                   rtol=1e-5, atol=1e-7)
    assert qk.LAUNCHES == {"quantize_stochastic": 0}  # CPU: the plain path
