"""The port's CUDA kernels against their plain versions, on the card.

CUDA kernels have no CPU mode, so every test here is marked ``cuda`` and
skips where there is no card. The file imports nothing of JAX, so it also
runs where JAX is not installed, without the suite's conftest:

    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py

``chip_smoke.py`` makes the same comparisons at full size."""

import numpy as np
import pytest
import torch

from parameter_server_tpu_torch.filters.fixed_point import FixedPointCodec
from parameter_server_tpu_torch.ops import adagrad_kernels as ak
from parameter_server_tpu_torch.ops import ftrl_kernels as fk
from parameter_server_tpu_torch.ops import quantize_kernels as qk

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


def _offset_rand(gen, shape, dev, offset):
    """``_rand``'s arrays as views ``offset`` elements into their storage."""
    numel = int(np.prod(shape))
    z, n, g = _rand(gen, (numel + offset,), dev)
    return (t[offset:].view(shape) for t in (z, n, g))


@pytest.mark.cuda
@pytest.mark.parametrize("hyper", HYPERS)
@pytest.mark.parametrize("offset", ["none", "all", "z"])
@pytest.mark.parametrize(
    "shape", [(1,), (3,), (5,), (4097, 1), (1000, 8), ((1 << 20) + 1, 1)])
def test_delta_kernel_matches_plain(dev, shape, offset, hyper):
    """Every count % 4, more than one resident wave, and inputs that start
    past a 16-byte boundary (all three, or z alone), which take the scalar
    code for every element."""
    gen = torch.Generator(device=dev).manual_seed(1)
    if offset == "none":
        z, n, g = _rand(gen, shape, dev)
    else:
        z, n, g = _offset_rand(gen, shape, dev, 1)
        if offset == "z":
            n, g = n.clone(), g.clone()
        assert z.data_ptr() % 16 != 0
    before = fk.LAUNCHES["ftrl_delta"]
    dz, dn = fk.ftrl_delta(z, n, g, **hyper)
    assert fk.LAUNCHES["ftrl_delta"] == before + 1
    pz, pn = fk.ftrl_delta_plain(z, n, g, **hyper)
    torch.testing.assert_close(dz, pz, **TOL)
    torch.testing.assert_close(dn, pn, **TOL)
    inside = z.abs() <= hyper["l1"]
    assert torch.equal(dz[inside], g[inside])  # w exactly 0 inside l1


# (vdim, K, real keys): U = keys + 3 pad slots + 2 slots out of range; a
# negative K is a kv shard's view: the |K| rows from |K| on of a 3|K|-row
# table, given idx - |K|, so the keys of the shards before and after it
# fall below 0 and at or above |K|
PUSH_CASES = [
    (1, 1 << 16, 5000),
    (1, -(1 << 16), 5000),
    (1, 1 << 10, 20),  # U below one warp
    (1, 1 << 16, 4094),  # U = 4099, not a multiple of a block's 256 slots
    (1, 1 << 20, 300_000),  # U above the threads the card holds at once
    (8, 1 << 16, 5000),
    (16, 1 << 16, 5000),
]


@pytest.mark.cuda
@pytest.mark.parametrize("hyper", HYPERS)
@pytest.mark.parametrize("vdim,K,keys", PUSH_CASES)
def test_push_kernel_matches_plain(dev, vdim, K, keys, hyper):
    """Against the plain version on the touched rows; repeated pad slots
    (idx 0, grad 0) keep row 0's bits; slots with idx -1 and K are skipped:
    the guard rows just outside the (K, vdim) view keep their bits, and so
    does every untouched row."""
    gen = torch.Generator(device=dev).manual_seed(2)
    shard = K < 0
    K = abs(K)
    # the table is rows [lo, lo + K) of the array: one guard row before and
    # after it, or, for a shard, the shards before and after it
    lo, rows = (K, 3 * K) if shard else (1, K + 2)
    zg, ng, _ = _rand(gen, (rows, vdim), dev)
    z, n = zg[lo:lo + K], ng[lo:lo + K]
    rng = np.random.default_rng(3)
    if shard:  # keys of all three shards; pads on the table's own row 0, no key
        uniq = np.sort(rng.choice(np.setdiff1d(np.arange(1, rows), [lo]), keys,
                                  replace=False)) - lo
    else:
        uniq = np.sort(rng.choice(np.arange(1, K), keys, replace=False))
    idx_np = np.concatenate([uniq, [0, 0, 0], [-1, K]]).astype(np.int32)
    idx = torch.from_numpy(idx_np).to(dev)
    g = torch.randn((idx.shape[0], vdim), generator=gen, device=dev)
    g[-5:-2] = 0
    zk, nk = zg.clone(), ng.clone()
    before = fk.LAUNCHES["ftrl_push"]
    fk.ftrl_push(zk[lo:lo + K], nk[lo:lo + K], idx, g, **hyper)
    assert fk.LAUNCHES["ftrl_push"] == before + 1
    inside = uniq[(uniq >= 0) & (uniq < K)]
    untouched = torch.ones(rows, dtype=torch.bool, device=dev)
    untouched[torch.from_numpy(inside + lo).to(dev)] = False  # pad row 0, guards stay in
    assert torch.equal(zk[untouched].view(torch.int32), zg[untouched].view(torch.int32))
    assert torch.equal(nk[untouched].view(torch.int32), ng[untouched].view(torch.int32))
    fk.ftrl_push_plain(z, n, idx, g, **hyper)  # the whole idx: it skips what the kernel skips
    torch.testing.assert_close(zk, zg, **TOL)
    torch.testing.assert_close(nk, ng, **TOL)


def _offset_copy(t, offset):
    """A copy of ``t`` that starts ``offset`` elements into its storage."""
    return torch.empty(t.numel() + offset, device=t.device)[offset:].view_as(t).copy_(t)


# (vdim, offset): vdim % 4 == 0 takes the float4 body; vdim 7, or tables
# one element into their storage (no 16-byte-aligned base), the scalar body.
# A row wider than 32 lanes makes a lane loop over columns: (64, 1), 64
# floats, and (160, 0), 40 float4s
# "shard" is a kv shard's view: the K rows from K on of a 3K-row table,
# given idx - K, so the keys of the shards before and after it fall below 0
# and at or above K
ADAGRAD_CASES = [(4, 0), (16, 0), (32, 0), (64, 0), (7, 0), (16, 1), (64, 1), (160, 0),
                 (64, "shard")]


@pytest.mark.cuda
@pytest.mark.parametrize("pads", [3, "wd"])
@pytest.mark.parametrize("l2", [0.0, 0.01])
@pytest.mark.parametrize("vdim,offset", ADAGRAD_CASES)
def test_adagrad_push_kernel_matches_plain(dev, vdim, offset, l2, pads):
    """Against the plain version; the table is the rows w[1:-1] of a (K + 2,
    vdim) array, so slots with idx -1 and K would land on the guard rows,
    which keep their bits as every untouched row does. ``pads`` "wd" is
    the Wide&Deep batch's ratio: 90% of the slots are pads (idx 0, zero
    gradient) on a zero row 0."""
    gen = torch.Generator(device=dev).manual_seed(5)
    K = 1 << 16
    shard = offset == "shard"
    offset = 0 if shard else offset
    lo, rows = (K, 3 * K) if shard else (1, K + 2)
    wg = _offset_copy(torch.randn((rows, vdim), generator=gen, device=dev), offset)
    ng = _offset_copy(torch.rand((rows, vdim), generator=gen, device=dev) * 4, offset)
    w, n = wg[lo:lo + K], ng[lo:lo + K]
    if vdim % 4 == 0:
        assert (w.data_ptr() % 16 == 0) == (offset == 0)
    if l2 > 0 or pads == "wd":
        w[0] = 0.0  # the pad-row invariant the repeated pad slots rely on
        n[0] = 0.0
    draws = np.random.default_rng(6).integers(1, rows if shard else K, 5000)
    uniq = np.setdiff1d(draws, [lo] if shard else []) - (lo if shard else 0)  # row 0: pads
    n_pads = 9 * len(uniq) if pads == "wd" else pads
    idx_np = np.concatenate([[0], uniq, np.zeros(n_pads - 1), [-1, K]]).astype(np.int32)
    idx = torch.from_numpy(idx_np).to(dev)
    g = torch.randn((idx.shape[0], vdim), generator=gen, device=dev)
    g[idx == 0] = 0
    wk, nk = _offset_copy(wg, offset), _offset_copy(ng, offset)
    before = ak.LAUNCHES["adagrad_push"]
    ak.adagrad_push(wk[lo:lo + K], nk[lo:lo + K], idx, g, eta=0.05, eps=1e-8, l2=l2)
    assert ak.LAUNCHES["adagrad_push"] == before + 1
    inside = uniq[(uniq >= 0) & (uniq < K)]
    untouched = torch.ones(rows, dtype=torch.bool, device=dev)
    untouched[torch.from_numpy(inside + lo).to(dev)] = False  # pad row 0, guards stay in
    assert torch.equal(wk[untouched].view(torch.int32), wg[untouched].view(torch.int32))
    assert torch.equal(nk[untouched].view(torch.int32), ng[untouched].view(torch.int32))
    # the whole idx: the plain version skips what the kernel skips
    ak.adagrad_push_plain(w, n, idx, g, eta=0.05, eps=1e-8, l2=l2)
    torch.testing.assert_close(wk, wg, **TOL)
    torch.testing.assert_close(nk, ng, **TOL)


@pytest.mark.cuda
@pytest.mark.parametrize("num_bytes", [1, 2])
@pytest.mark.parametrize("n", [1, 3, 4097, (1 << 20) + 7])
def test_quantize_kernel_matches_plain(dev, n, num_bytes):
    """Exactly: the kernel and the plain version draw the same Philox
    stream and do the same IEEE arithmetic. The offset view starts 4 bytes
    past an aligned address, so it takes the kernel's scalar path."""
    gen = torch.Generator(device=dev).manual_seed(8)
    base = torch.randn(n + 1, generator=gen, device=dev) * 3 + 1
    for x in (base[:n], base[1:]):
        for seed in (0, 1, (1 << 40) + 3):
            before = qk.LAUNCHES["quantize_stochastic"]
            q, lo, scale = qk.quantize_stochastic(seed, x, num_bytes)
            assert qk.LAUNCHES["quantize_stochastic"] == before + 1
            pq, plo, pscale = qk.quantize_stochastic_plain(seed, x, num_bytes)
            assert q.dtype == (torch.int8 if num_bytes == 1 else torch.int16)
            assert q.shape == x.shape
            assert torch.equal(q, pq) and torch.equal(lo, plo) and torch.equal(scale, pscale)
    if n > 1:  # one element is a constant array: it encodes to the bottom
        info = torch.iinfo(q.dtype)
        assert q[x.argmax()] == info.max  # F1: the maximum saturates, never wraps


@pytest.mark.cuda
def test_int8_push_scale_on_card_equals_cpu_product(dev):
    """The quantized push's scale is max|g| * float32(1/127) + 1e-30, the
    product the jitted reference computes, rounded once on the card as on
    the CPU, bit for bit, over 4096 maxima (the quotient max|g| / 127 is
    one ulp away for some of them)."""
    from parameter_server_tpu_torch.parallel.spmd import int8_scale

    rng = np.random.default_rng(5)
    tops = (rng.random(4096) * 1e3).astype(np.float32)
    want = tops * np.float32(1 / 127) + np.float32(1e-30)
    got = [int8_scale(torch.tensor([[-t], [t / 2]], device=dev)).item() for t in tops]
    assert np.array_equal(np.asarray(got, dtype=np.float32), want)


@pytest.mark.cuda
def test_quantize_keeps_lo_and_scale_on_the_card(dev):
    codec = FixedPointCodec(1)
    x = torch.randn(1 << 16, device=dev)
    codec.decode(codec.encode(0, x))  # load the library first
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")  # a host sync now raises
    try:
        e = codec.encode(1, x)
        dec = codec.decode(e)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert e.lo.device == e.scale.device == e.q.device == dec.device == x.device


@pytest.mark.cuda
def test_wrappers_raise_on_cuda(dev):
    z = torch.zeros(8, 1, device=dev)
    with pytest.raises(TypeError, match="int32"):
        fk.ftrl_push(z, z.clone(), torch.tensor([1], device=dev), torch.ones(1, 1, device=dev),
                     **HYPER)
    with pytest.raises(ValueError, match="different devices"):
        fk.ftrl_delta(z, z, torch.zeros(8, 1), **HYPER)
    with pytest.raises(ValueError, match="different devices"):
        ak.adagrad_push(z, z.clone(), torch.tensor([1], dtype=torch.int32),
                        torch.ones(1, 1, device=dev), eta=0.1, eps=1e-8, l2=0.0)
    with pytest.raises(TypeError, match="float32"):
        qk.quantize_stochastic(0, torch.ones(8, dtype=torch.float64, device=dev))
    with pytest.raises(ValueError, match="contiguous"):
        qk.quantize_stochastic(0, torch.ones(4, 6, device=dev).t())
    with pytest.raises(ValueError, match="different devices"):
        qk.stochastic_round(0, torch.ones(8, device=dev), torch.tensor([0.0, 1.0]))


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


@pytest.mark.cuda
def test_matrix_fac_on_card_matches_cpu(dev):
    from parameter_server_tpu_torch.models.matrix_fac import MatrixFactorization
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    rng = np.random.default_rng(7)
    users, items = rng.integers(0, 500, 4096), rng.integers(0, 300, 4096)
    ratings = rng.uniform(0.5, 5.0, 4096).astype(np.float32)
    rmse = {}
    for device in ("cuda", "cpu"):
        ak.reset_launches()
        mf = MatrixFactorization(500, 300, rank=32, seed=1, device=device,
                                 reporter=ProgressReporter(print_fn=lambda s: None))
        rmse[device] = [mf.train_epoch(users, items, ratings, batch_size=512, seed=e)
                        for e in range(2)]
        # 8 steps an epoch, each pushing both tables
        assert ak.LAUNCHES["adagrad_push"] == (32 if device == "cuda" else 0)
    np.testing.assert_allclose(rmse["cuda"], rmse["cpu"], rtol=1e-4)


@pytest.mark.cuda
def test_wide_deep_on_card_matches_cpu(dev):
    """4 W&D steps on the card (K1 for the wide push, K3 for the embedding
    push, one launch each a step) against the same steps on the CPU."""
    from parameter_server_tpu_torch.data.batch import BatchBuilder
    from parameter_server_tpu_torch.data.synthetic import make_sparse_logistic
    from parameter_server_tpu_torch.models.wide_deep import WideDeep
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    torch.backends.cuda.matmul.allow_tf32 = False
    labels, keys, vals, _ = make_sparse_logistic(1024, 3000, nnz_per_example=10, seed=3)
    builder = BatchBuilder(num_keys=4096, batch_size=256, max_nnz_per_example=40)
    batches = [builder.build(labels[i:i + 256], keys[i:i + 256], vals[i:i + 256])
               for i in range(0, 1024, 256)]
    apps = {}
    for device in ("cuda", "cpu"):
        fk.reset_launches()
        ak.reset_launches()
        apps[device] = WideDeep(4096, emb_dim=8, hidden=[16, 8], seed=1, steps_per_call=2,
                                max_delay=1, device=device,
                                reporter=ProgressReporter(print_fn=lambda s: None))
        apps[device].train(batches, report_every=1)
        want = 4 if device == "cuda" else 0
        assert fk.LAUNCHES["ftrl_push"] == ak.LAUNCHES["adagrad_push"] == want
        assert fk.LAUNCHES["ftrl_delta"] == 0
    for a, b in zip(apps["cuda"].reporter.history, apps["cpu"].reporter.history):
        np.testing.assert_allclose(a["objv"], b["objv"], rtol=1e-4)
    got, want = apps["cuda"].state_dict(), apps["cpu"].state_dict()
    for name in ("wide", "emb"):
        for k in want[name]:
            np.testing.assert_allclose(got[name][k], want[name][k], rtol=1e-4, atol=1e-5)
    for x, y in zip(got["mlp"], want["mlp"]):
        for k in ("W", "b"):
            np.testing.assert_allclose(x[k], y[k], rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_word2vec_on_card_matches_cpu(dev):
    """SGNS epochs on the card (plain PyTorch: duplicate ids scatter-add one
    delta per occurrence, no kernel launches) against the CPU."""
    from parameter_server_tpu_torch.models.word2vec import Word2Vec
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    torch.backends.cuda.matmul.allow_tf32 = False
    corpus = np.minimum(np.random.default_rng(1).zipf(1.3, 6000) - 1, 199)
    losses, emb = {}, {}
    for device in ("cuda", "cpu"):
        fk.reset_launches()
        ak.reset_launches()
        w2v = Word2Vec(200, dim=16, eta=0.05, num_negatives=4, steps_per_call=3, max_delay=2,
                       device=device, reporter=ProgressReporter(print_fn=lambda s: None))
        losses[device] = [w2v.train_epoch(corpus, batch_size=256, seed=ep) for ep in range(2)]
        emb[device] = w2v.embeddings()
        assert sum(fk.LAUNCHES.values()) + sum(ak.LAUNCHES.values()) == 0
    np.testing.assert_allclose(losses["cuda"], losses["cpu"], rtol=1e-4)
    np.testing.assert_allclose(emb["cuda"], emb["cpu"], rtol=1e-4, atol=1e-5)


def _repeated_push_reference(kind, state, all_idx, all_grad, begin, s, hyper):
    """The plain scatter-add push, on its own: for each data shard in
    order, gather the shard's rows at every occurrence, one delta an
    occurrence from the same gathered row, ``index_add_`` the deltas.
    Returns the tables and, per element, the sum of the |deltas| added to
    it (a hot row sums hundreds of deltas, whose order the card's atomic
    adds change: the sum's rounding scales with it)."""
    out = {k: v.clone() for k, v in state.items()}
    mass = {k: torch.zeros_like(v) for k, v in state.items()}
    for idx, g in zip(all_idx, all_grad):
        local = idx.long() - begin
        keep = (local >= 0) & (local < s)
        local, g = local[keep], g[keep]
        if kind == "adagrad":
            n = out["n"].index_select(0, local)
            deltas = {"w": -hyper["eta"] * g / (torch.sqrt(n + g * g) + 1e-8), "n": g * g}
        else:
            dz, dn = fk.ftrl_delta_plain(out["z"].index_select(0, local),
                                         out["n"].index_select(0, local), g, **hyper)
            deltas = {"z": dz, "n": dn}
        for k, d in deltas.items():
            out[k].index_add_(0, local, d)
            mass[k].index_add_(0, local, d.abs())
    return out, mass


@pytest.mark.cuda
@pytest.mark.parametrize("kind,vdim", [("adagrad", 16), ("adagrad", 64), ("ftrl", 1)])
@pytest.mark.parametrize("kv,k", [(1, 0), (3, 1)])
def test_local_push_repeated_ids_takes_no_fused_push(dev, kind, vdim, kv, k):
    """word2vec's mesh push: ``_local_push(..., unique=False)`` on kv shard
    k of ``kv`` with ids repeated inside each data shard's push and across
    the D = 2 pushes, the ids of other shards among them, matches the plain
    scatter-add computed on its own, and launches neither K3 nor K1 (whose
    one-key-a-slot contract repeated ids break). Each element is held to
    TOL of itself plus the summed |deltas| it took."""
    from parameter_server_tpu_torch.kv.updaters import Adagrad, Ftrl
    from parameter_server_tpu_torch.parallel.spmd import _local_push

    gen = torch.Generator(device=dev).manual_seed(11)
    rows = 3001
    s = -(-rows // kv)
    begin = k * s
    hyper = ({"eta": 0.05} if kind == "adagrad"
             else {"alpha": 0.1, "beta": 1.0, "l1": 0.5, "l2": 0.0})
    up = (Adagrad(eta=0.05) if kind == "adagrad"
          else Ftrl(alpha=0.1, beta=1.0, lambda_l1=0.5, lambda_l2=0.0))
    names = ("w", "n") if kind == "adagrad" else ("z", "n")
    state = {names[0]: torch.randn((s, vdim), generator=gen, device=dev),
             names[1]: torch.rand((s, vdim), generator=gen, device=dev)}
    # ids over the whole table, and 20 hot ids of this shard, shuffled
    spread = torch.randint(0, rows, (2, 4096), generator=gen, device=dev)
    hot = begin + torch.randint(0, 20, (2, 4096), generator=gen, device=dev)
    both = torch.cat([spread, hot], 1)
    all_idx = both.gather(1, torch.argsort(torch.rand(both.shape, generator=gen,
                                                      device=dev), 1)).to(torch.int32)
    local = all_idx.long() - begin
    mine = (local >= 0) & (local < s)
    assert kv == 1 or (~mine).any()
    assert torch.bincount(local[mine]).max() > 100
    all_grad = torch.randn((2, 8192, vdim), generator=gen, device=dev)
    want, mass = _repeated_push_reference(kind, state, all_idx, all_grad, begin, s,
                                          hyper if kind == "ftrl" else {"eta": 0.05})
    got = {n: v.clone() for n, v in state.items()}
    ak.reset_launches()
    fk.reset_launches()
    _local_push(up, got, all_idx, all_grad, begin, s, unique=False)
    torch.cuda.synchronize()
    assert ak.LAUNCHES["adagrad_push"] == 0 and fk.LAUNCHES["ftrl_push"] == 0
    for n in names:
        err = (got[n] - want[n]).abs()
        bound = TOL["rtol"] * (want[n].abs() + mass[n]) + TOL["atol"]
        assert bool((err <= bound).all()), (n, err.max().item())
    # the unique route on the same shard launches the fused push once a
    # data shard (on deduplicated ids)
    uniq = [torch.unique(all_idx[j]) for j in range(2)]
    m = min(len(x) for x in uniq)
    _local_push(up, got, torch.stack([x[:m] for x in uniq]).to(torch.int32),
                all_grad[:, :m], begin, s)
    torch.cuda.synchronize()
    assert (ak.LAUNCHES["adagrad_push"] if kind == "adagrad" else fk.LAUNCHES["ftrl_push"]) == 2


# ---------------------------------------------------------------------------
# the wire tier: shard servers and backends on the card
# ---------------------------------------------------------------------------


def _wire_pushes(rng, size: int, vdim: int, rounds: int = 4):
    """Sorted unique local key sets, local row 0 in every other one."""
    out = []
    for r in range(rounds):
        keys = np.unique(rng.integers(0, size, 700))
        if r % 2 == 0:
            keys = np.union1d(keys, [0])
        out.append((keys, rng.normal(size=(len(keys), vdim)).astype(np.float32)))
    return out


def _unique_index_guard(monkeypatch, counts: dict):
    """Wrap the store's K1 and K3 wrappers: every launch's index must hold
    each row once (the kernels store without atomics)."""
    from parameter_server_tpu_torch.kv import store as kv_store

    def guard(name, fn):
        def wrapped(a, b, idx, grad, **kw):
            assert torch.unique(idx).numel() == idx.numel(), f"{name}: repeated row"
            counts[name] = counts.get(name, 0) + 1
            return fn(a, b, idx, grad, **kw)
        return wrapped

    monkeypatch.setattr(kv_store, "ftrl_push", guard("ftrl_push", kv_store.ftrl_push))
    monkeypatch.setattr(kv_store, "adagrad_push", guard("adagrad_push", kv_store.adagrad_push))


@pytest.mark.cuda
@pytest.mark.parametrize("begin", [0, 3 << 12])
@pytest.mark.parametrize("algo,vdim", [("ftrl", 1), ("adagrad", 16)])
def test_shard_server_on_card_launches_its_kernel_and_matches_plain(
        dev, algo, vdim, begin, monkeypatch):
    """A card ShardServer applies each push through K1 (FTRL) or K3
    (AdaGrad), once an apply batch, with no repeated row; its table matches
    the plain store replayed on the CPU (TOL). Local row 0 is pushed in
    every other round: on a range that begins above 0 it is a real key."""
    from parameter_server_tpu_torch.kv.store import KVStore
    from parameter_server_tpu_torch.kv.updaters import Adagrad, Ftrl
    from parameter_server_tpu_torch.parallel.multislice import ServerHandle, ShardServer
    from parameter_server_tpu_torch.utils.config import PSConfig
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    size = 1 << 12

    def make():
        return (Ftrl(alpha=0.3, beta=1.0, lambda_l1=0.5, lambda_l2=0.1) if algo == "ftrl"
                else Adagrad(eta=0.05))

    counts: dict = {}
    _unique_index_guard(monkeypatch, counts)
    pushes = _wire_pushes(np.random.default_rng(11), size, vdim)
    srv = ShardServer(make(), KeyRange(begin, begin + size), vdim=vdim, device="cuda").start()
    h = ServerHandle(srv.address, 0, 0, PSConfig(), range_size=size, device="cuda")
    kernel = "ftrl_push" if algo == "ftrl" else "adagrad_push"
    launches = fk.LAUNCHES if algo == "ftrl" else ak.LAUNCHES
    try:
        before = launches[kernel]
        for keys, g in pushes:
            h.push(keys, g)
        got = h.pull(np.arange(size)).reshape(size, vdim)
        assert launches[kernel] - before == srv.counters["apply_batches"] == len(pushes)
        assert counts[kernel] == len(pushes)
    finally:
        h.shutdown()
        h.close()
    store = KVStore(make(), size, vdim=vdim, device="cpu")
    for keys, g in pushes:
        store.push(keys, g)
    want = store.weights().numpy()
    np.testing.assert_allclose(got, want, **TOL)
    assert np.abs(got[0]).max() > 0  # row 0 moved, as its key was pushed


@pytest.mark.cuda
def test_card_server_concurrent_pushes_coalesce_through_k1(dev, monkeypatch):
    """8 pipelined pushers against a card FTRL server: every push acked,
    one K1 launch an apply batch, no launch with a repeated row."""
    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.parallel.multislice import ServerHandle, ShardServer
    from parameter_server_tpu_torch.utils.config import PSConfig
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    counts: dict = {}
    _unique_index_guard(monkeypatch, counts)
    size = 1 << 14
    srv = ShardServer(Ftrl(), KeyRange(size, 2 * size), device="cuda").start()
    hs = [ServerHandle(srv.address, 0, w, PSConfig(), range_size=size, device="cuda")
          for w in range(8)]
    rng = np.random.default_rng(5)
    try:
        before = fk.LAUNCHES["ftrl_push"]
        futs = []
        for _ in range(6):
            for h in hs:
                keys = np.unique(rng.integers(0, size, 2000))
                futs.append(h.push_async(keys, rng.normal(size=len(keys)).astype(np.float32)))
        for f in futs:
            f.result(timeout=60)
        assert srv.counters["pushes"] == 48
        assert fk.LAUNCHES["ftrl_push"] - before == srv.counters["apply_batches"]
        assert counts["ftrl_push"] == srv.counters["apply_batches"]
    finally:
        hs[0].shutdown()
        for h in hs:
            h.close()


@pytest.mark.cuda
def test_backends_on_card_agree_and_launch_k1(dev):
    """train_linear through the socket backend (2 card servers) and the mesh
    backend (a world of one on NCCL): the same probabilities, K1 on both."""
    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.parallel.backend import local_socket_backend, train_linear
    from parameter_server_tpu_torch.parallel.meshbackend import MeshBackend

    num_keys = 1 << 12
    rng = np.random.default_rng(3)
    kb = rng.integers(0, num_keys - 1, size=(2048, 16))
    y = (rng.random(2048) < 0.5).astype(np.float64)
    probs = {}
    for kind in ("socket", "mesh"):
        before = fk.LAUNCHES["ftrl_push"]
        be = (local_socket_backend(lambda: Ftrl(alpha=1.0, lambda_l1=1e-4), num_keys, 2,
                                   device="cuda") if kind == "socket"
              else MeshBackend(Ftrl(alpha=1.0, lambda_l1=1e-4), num_keys, device="cuda"))
        try:
            probs[kind] = train_linear(be, kb, y, 256)["probs"]
        finally:
            be.close()
        assert fk.LAUNCHES["ftrl_push"] - before >= 8
    np.testing.assert_allclose(probs["mesh"], probs["socket"], rtol=0, atol=1e-6)


def test_wire_entry_points_raise_without_a_card():
    """No CPU fallback: without a card the wire tier's entry points raise
    at their default device (this test runs where there is none)."""
    from parameter_server_tpu_torch.kv.updaters import Sgd
    from parameter_server_tpu_torch.parallel.backend import local_socket_backend
    from parameter_server_tpu_torch.parallel.meshbackend import MeshBackend
    from parameter_server_tpu_torch.parallel.multislice import ShardServer
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    if torch.cuda.is_available():
        pytest.skip("a card is present: the default device is usable here")
    with pytest.raises(RuntimeError, match="cuda"):
        ShardServer(Sgd(), KeyRange(0, 8))
    with pytest.raises(RuntimeError, match="cuda"):
        local_socket_backend(Sgd, 64)
    with pytest.raises(RuntimeError, match="cuda"):
        MeshBackend(Sgd(), 64)


@pytest.mark.cuda
def test_card_save_state_under_pushes_holds_its_ledger(dev, tmp_path):
    """``save_state`` on a card server, taken again and again while 8
    pipelined pushers' pushes are being applied: each dump's table is
    exactly the pushes its ledger lists (SGD, eta 1, integer gradients:
    every sum is exact), so no apply issued after the copy's locks were
    released is in it, and none the ledger lists is missing."""
    import threading

    from parameter_server_tpu_torch.kv.updaters import Sgd
    from parameter_server_tpu_torch.parallel.multislice import ServerHandle, ShardServer
    from parameter_server_tpu_torch.utils.config import PSConfig
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    size, per = 1 << 14, 40  # per handle: within the ledger's 64 seqs a client
    srv = ShardServer(Sgd(eta=1.0), KeyRange(0, size), device="cuda").start()
    hs = [ServerHandle(srv.address, 0, w, PSConfig(), range_size=size, device="cuda")
          for w in range(8)]
    rng = np.random.default_rng(9)
    pushes = {}  # (cid, "k<i>") -> (keys, grad)
    for h in hs:
        cid = h.client.identity[0]
        for i in range(per):
            keys = np.unique(rng.integers(0, size, 2000))
            pushes[(cid, f"k{i}")] = (keys, rng.integers(-3, 4, len(keys)).astype(np.float32))
    stop = threading.Event()
    dumps = []

    def snapshot():
        while not stop.is_set():
            d = tmp_path / f"d{len(dumps)}"
            srv.save_state(str(d))
            dumps.append(d)

    t = threading.Thread(target=snapshot)
    try:
        t.start()
        futs = [h.push_async(*pushes[(h.client.identity[0], f"k{i}")])
                for i in range(per) for h in hs]
        for f in futs:
            f.result(timeout=120)
    finally:
        stop.set()
        t.join(timeout=60)
        hs[0].shutdown()
        for h in hs:
            h.close()
    import json

    sizes = []
    for d in dumps:
        with np.load(d / f"server-0-{size}.npz") as z:
            w = z["w"].ravel()
            ledger = json.loads(z["__push_ledger__"].tobytes().decode())
        want = np.zeros(size, np.float32)
        n = 0
        for cid, seqs in ledger.items():
            for seq in seqs:
                keys, g = pushes[(cid, seq)]
                want[keys] -= g
                n += 1
        np.testing.assert_array_equal(w, want)
        sizes.append(n)
    assert sizes and max(sizes) <= len(pushes)
    assert any(0 < n < len(pushes) for n in sizes), sizes  # taken mid-run


@pytest.mark.cuda
def test_launch_local_on_card_matches_cpu(dev, tmp_path):
    """A one-worker cluster (2 card servers, max_delay 0) against the same
    cluster on the CPU: the weights within 1e-4 of themselves plus 1e-4 of
    the table's largest (the card's segment sums add in another order);
    each server launched K1 once an apply batch, the worker none."""
    import json

    from parameter_server_tpu_torch.data.synthetic import make_sparse_logistic, write_libsvm
    from parameter_server_tpu_torch.parallel.multislice import launch_local
    from parameter_server_tpu_torch.utils.checkpoint import load_weights_text

    labels, keys, vals, _ = make_sparse_logistic(3000, 800, nnz_per_example=10,
                                                 noise=0.3, seed=11)
    files = []
    for i in range(4):
        sl = slice(i * 700, (i + 1) * 700)
        files.append(str(tmp_path / f"part-{i}.libsvm"))
        write_libsvm(files[-1], labels[sl], keys[sl], vals[sl])
    write_libsvm(tmp_path / "val.libsvm", labels[2800:], keys[2800:], vals[2800:])
    app = tmp_path / "app.json"
    app.write_text(json.dumps({
        "app": "linear_method",
        "data": {"files": files, "format": "libsvm", "num_keys": 1 << 15,
                 "val_files": [str(tmp_path / "val.libsvm")], "max_nnz_per_example": 64},
        "solver": {"algo": "ftrl", "minibatch": 256, "max_delay": 0, "epochs": 1},
        "lr": {"alpha": 0.3, "beta": 1.0}, "penalty": {"lambda_l1": 0.005},
        "filter": {"key_caching": True, "compressing": True}}))
    out, w = {}, {}
    for device in ("cuda", "cpu"):
        model = tmp_path / f"{device}.txt"
        out[device] = launch_local(str(app), 2, 1, model_out=str(model), timeout=300,
                                   device=device)
        w[device] = load_weights_text(model, 1 << 15)
    assert np.count_nonzero(w["cpu"]) > 0
    bound = 1e-4 * np.abs(w["cpu"]) + 1e-4 * np.abs(w["cpu"]).max()
    assert np.all(np.abs(w["cuda"] - w["cpu"]) <= bound)
    assert out["cuda"]["workloads"] == out["cpu"]["workloads"]
    nodes = out["cuda"]["nodes"]
    for s, st in zip(("server-0", "server-1"), out["cuda"]["server_stats"]):
        assert nodes[s]["device"] == "cuda:0" or nodes[s]["device"].startswith("cuda")
        assert nodes[s]["launches"]["ftrl_push"] == st["apply_batches"] > 0
    assert set(nodes["worker-0"]["launches"].values()) == {0}


@pytest.mark.cuda
@pytest.mark.parametrize("algo,vdim", [("ftrl", 1), ("adagrad", 16)])
def test_card_server_under_a_plan_equals_its_plain_replay(dev, algo, vdim, monkeypatch):
    """A card server under every fault action applies each push exactly
    once through its kernel: one launch an apply batch, no repeated row,
    the push ledger holding each push once, and a table equal to the plain
    store replayed on the CPU (TOL)."""
    from parameter_server_tpu_torch.kv.store import KVStore
    from parameter_server_tpu_torch.kv.updaters import Adagrad, Ftrl
    from parameter_server_tpu_torch.parallel.chaos import FaultPlan
    from parameter_server_tpu_torch.parallel.multislice import ServerHandle, ShardServer
    from parameter_server_tpu_torch.utils.config import PSConfig
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    size = 1 << 12

    def make():
        return (Ftrl(alpha=0.3, beta=1.0, lambda_l1=0.5, lambda_l2=0.1) if algo == "ftrl"
                else Adagrad(eta=0.05))

    counts: dict = {}
    _unique_index_guard(monkeypatch, counts)
    pushes = _wire_pushes(np.random.default_rng(13), size, vdim, rounds=12)
    plan = FaultPlan.parse("drop,prob=0.05;disconnect,cmd=push,every=3;duplicate,prob=0.2;"
                           "delay,prob=0.1,delay_s=0.002", seed=7)
    srv = ShardServer(make(), KeyRange(size, 2 * size), vdim=vdim, fault_plan=plan,
                      device="cuda").start()
    cfg = PSConfig()
    cfg.fault.reconnect_timeout_s = 30.0
    h = ServerHandle(srv.address, 0, 0, cfg, range_size=size, device="cuda")
    kernel = "ftrl_push" if algo == "ftrl" else "adagrad_push"
    launches = fk.LAUNCHES if algo == "ftrl" else ak.LAUNCHES
    try:
        before = launches[kernel]
        for keys, g in pushes:
            h.push(keys, g)
        got = h.pull(np.arange(size)).reshape(size, vdim)
        assert launches[kernel] - before == srv.counters["apply_batches"] == len(pushes)
        assert counts[kernel] == len(pushes) == srv.counters["pushes"]
        assert len(srv._applied_push[h.client.identity[0]]) == len(pushes)
        assert srv.server.fault_stats()["disconnect"] >= 1
    finally:
        h.shutdown()
        h.close()
    store = KVStore(make(), size, vdim=vdim, device="cpu")
    for keys, g in pushes:
        store.push(keys, g)
    np.testing.assert_allclose(got, store.weights().numpy(), **TOL)


@pytest.mark.cuda
def test_serving_pulls_from_a_card_server_equal_the_table_at_their_version(dev):
    """Serving pulls against a card FTRL server while a writer pushes
    through K1: every version-stamped reply equals a gather of the table
    as it stood at the reply's ``ver`` (kept by replaying the pushes on
    the CPU, one table a version), and a revalidation at the current
    version moves no rows."""
    from parameter_server_tpu_torch.kv.store import KVStore
    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.parallel.multislice import ServerHandle, ShardServer, _sig
    from parameter_server_tpu_torch.utils.config import PSConfig, ServeConfig
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    size = 1 << 12
    svc = ServeConfig(cache=True, hot_min_pulls=1)
    srv = ShardServer(Ftrl(), KeyRange(0, size), serve_cfg=svc, device="cuda").start()
    writer = ServerHandle(srv.address, 0, 1, PSConfig(), range_size=size, device="cuda")
    rng = np.random.default_rng(4)
    keys = np.arange(1, 257)
    store = KVStore(Ftrl(), size, device="cpu")
    tables = {srv.version: store.weights().numpy().copy()}
    try:
        for i in range(10):
            k = np.unique(rng.integers(0, size, 300))
            g = rng.normal(size=len(k)).astype(np.float32)
            writer.push(k, g)
            store.push(k, g)
            tables[srv.version] = store.weights().numpy().copy()
            for _ in range(2):  # the second pull rides the encode cache
                rep, out = writer.client.call(
                    "pull", arrays={"keys": keys.astype(np.uint32)}, worker=1,
                    sig=_sig(keys), zip=False, sv=1)
                np.testing.assert_allclose(out["w"], tables[rep["ver"]][keys, 0], **TOL)
            rep, out = writer.client.call(
                "pull", arrays={"keys": keys.astype(np.uint32)}, worker=1,
                sig=_sig(keys), zip=False, if_newer=rep["ver"])
            assert rep["not_modified"] and not out
        assert srv.counters["encode_reuse"] >= 10
    finally:
        writer.shutdown()
        writer.close()


@pytest.mark.cuda
@pytest.mark.parametrize("algo", ["ftrl", "adagrad"])
def test_host_weights_is_a_clone_a_later_apply_leaves(dev, algo):
    """The host snapshot of a version is a copy of the table's weights
    issued under the publish lock (a clone where the weights are the table
    itself, as AdaGrad's): an apply after it leaves it as it was."""
    from parameter_server_tpu_torch.kv.updaters import Adagrad, Ftrl
    from parameter_server_tpu_torch.parallel.multislice import ShardServer
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    size = 1 << 12
    srv = ShardServer(Ftrl() if algo == "ftrl" else Adagrad(eta=0.1), KeyRange(0, size),
                      device="cuda")
    try:
        keys = np.arange(1, 101)
        srv._apply(keys, np.ones(100, np.float32))
        w, ver, _ = srv._gather_weights(keys, snap=True)
        snap_ver, host = srv._host_w
        assert snap_ver == ver and host.shape == (size, 1)
        before = host.copy()
        srv._apply(keys, np.ones(100, np.float32))
        torch.cuda.synchronize()
        np.testing.assert_array_equal(host, before)
        np.testing.assert_array_equal(w, before[keys])
        assert srv.weights()[1, 0] != before[1, 0]
    finally:
        srv.server.stop()


# --- darlin, graph_partition and sketch: no kernel, plain ops on the card -----


def _darlin_batches(n=4096, num_keys=1 << 12, bs=1024):
    from parameter_server_tpu_torch.data.batch import BatchBuilder
    from parameter_server_tpu_torch.data.synthetic import make_sparse_logistic

    labels, keys, vals, _ = make_sparse_logistic(n, 3000, nnz_per_example=20, seed=5)
    builder = BatchBuilder(num_keys=num_keys, batch_size=bs, max_nnz_per_example=64)
    return [builder.build(labels[i:i + bs], keys[i:i + bs], vals[i:i + bs])
            for i in range(0, n, bs)]


def _darlin_cfg(**kw):
    from parameter_server_tpu_torch.utils.config import PSConfig

    cfg = PSConfig()
    cfg.data.num_keys = 1 << 12
    cfg.solver.algo = "darlin"
    cfg.solver.feature_blocks = 8
    cfg.solver.block_iters = kw.get("iters", 6)
    cfg.solver.kkt_filter_threshold = kw.get("kkt", 0.1)
    cfg.solver.max_delay = kw.get("max_delay", 0)
    cfg.solver.block_chunk = kw.get("chunk", 0)
    cfg.penalty.lambda_l1 = 1.0
    return cfg


@pytest.mark.cuda
@pytest.mark.parametrize("max_delay", [0, 2])
def test_darlin_on_card_matches_cpu(dev, max_delay):
    """The darlin solve on the card vs the CPU (objective history rtol
    1e-4: the card's index_add_ sums a hot key's entries in another order),
    and one pass's w, pred and violation maximum (rtol 1e-4 / atol 1e-5:
    a reordered sum of a hot key's ~4k terms, divided by its Hessian, moves
    a small weight by a few 1e-6); no kernel launches (darlin reaches no
    TPU kernel)."""
    from parameter_server_tpu_torch.data.blockcache import ColumnBlocks
    from parameter_server_tpu_torch.models import darlin as D
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    batches = _darlin_batches()
    fk.reset_launches()
    ak.reset_launches()
    res = {device: D.Darlin(_darlin_cfg(max_delay=max_delay),
                            reporter=ProgressReporter(print_fn=lambda s: None),
                            device=device).fit(batches)
           for device in ("cuda", "cpu")}
    assert not any({**fk.LAUNCHES, **ak.LAUNCHES}.values())
    np.testing.assert_allclose(res["cuda"]["history"], res["cpu"]["history"], rtol=1e-4)
    assert res["cuda"]["history"][-1] < res["cuda"]["history"][0]
    cb = ColumnBlocks.from_batches(batches, 1 << 12, 8)
    order = np.random.default_rng(0).permutation(8)
    out = {}
    for device in ("cuda", "cpu"):
        blocks = {k: torch.tensor(getattr(cb, k), device=device)
                  for k in ("feat_local", "rows", "values")}
        w = torch.zeros(1 << 12, device=device)
        out[device] = D.darlin_pass(
            w, torch.zeros(cb.num_examples, device=device),
            torch.ones(1 << 12, dtype=torch.bool, device=device), blocks, order,
            torch.tensor(cb.labels, device=device), 1.0, 0.0, 1.0,
            block_size=cb.block_size, delay=max_delay)
    for a, b in zip(out["cuda"], out["cpu"]):
        np.testing.assert_allclose(a.cpu().numpy(), b.numpy(), rtol=1e-4, atol=1e-5)


@pytest.mark.cuda
def test_darlin_world_of_one_on_nccl_matches_single(dev):
    """A world of one on NCCL, resident and streamed, against the single
    device on the card (rtol 1e-4: the card's sums reorder run to run)."""
    from parameter_server_tpu_torch.models.darlin import Darlin
    from parameter_server_tpu_torch.parallel import runtime
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    batches = _darlin_batches()
    quiet = ProgressReporter(print_fn=lambda s: None)
    ref = Darlin(_darlin_cfg(), reporter=quiet, device="cuda").fit(batches)
    rt = runtime.init(None, kv_shards=1, data_shards=1, device="cuda")
    try:
        for chunk in (0, 4):
            res = Darlin(_darlin_cfg(chunk=chunk), reporter=quiet, mesh=rt.mesh).fit(batches)
            np.testing.assert_allclose(res["history"], ref["history"], rtol=1e-4)
    finally:
        rt.shutdown()


@pytest.mark.cuda
def test_graph_partition_on_card_equals_cpu_bit_for_bit(dev):
    """Counts in float32 below 2^24: every sum is exact in any order, so
    the card's presence, sizes and assignments equal the CPU's."""
    from parameter_server_tpu_torch.models.graph_partition import GraphPartition
    from parameter_server_tpu_torch.utils.config import PSConfig

    cfg = PSConfig()
    cfg.data.num_keys = 1 << 12
    cfg.graph.num_partitions = 8
    batches = _darlin_batches()
    apps = {d: GraphPartition(cfg, device=d) for d in ("cuda", "cpu")}
    outs = {d: a.partition(batches) for d, a in apps.items()}
    assert outs["cuda"] == outs["cpu"]
    np.testing.assert_array_equal(apps["cuda"].assignments, apps["cpu"].assignments)
    for k in ("presence", "sizes"):
        np.testing.assert_array_equal(apps["cuda"].state_dict()[k],
                                      apps["cpu"].state_dict()[k])


@pytest.mark.cuda
@pytest.mark.parametrize("app", ["darlin", "graph_partition", "sketch"])
def test_cli_train_new_paths_on_card(dev, app, tmp_path, capsys):
    """``cli train --device cuda`` of each new path against ``--device
    cpu``: darlin's result at rtol 1e-4, graph_partition's and sketch's
    results and dumps equal."""
    import json

    from parameter_server_tpu_torch import cli
    from parameter_server_tpu_torch.data.synthetic import make_sparse_logistic, write_libsvm

    labels, keys, vals, _ = make_sparse_logistic(3000, 2000, nnz_per_example=15, seed=2)
    write_libsvm(tmp_path / "a.svm", labels, keys, vals)
    cfg = {"app": "linear_method" if app == "darlin" else app,
           "data": {"files": [str(tmp_path / "a.svm")], "num_keys": 1 << 12,
                    "max_nnz_per_example": 64},
           "solver": {"algo": "darlin", "feature_blocks": 8, "block_iters": 6,
                      "minibatch": 512},
           "graph": {"num_partitions": 4}, "sketch": {"width": 4096, "min_count": 5}}
    (tmp_path / "c.json").write_text(json.dumps(cfg))
    outs = {}
    for device in ("cuda", "cpu"):
        model = tmp_path / f"{device}.txt"
        capsys.readouterr()
        assert cli.main(["train", "--app_file", str(tmp_path / "c.json"), "--model_out",
                         str(model), "--device", device]) == 0
        outs[device] = (json.loads(capsys.readouterr().out.strip().splitlines()[-1]),
                        model.read_text())
    if app == "darlin":
        for k in ("objv", "train_auc"):
            np.testing.assert_allclose(outs["cuda"][0][k], outs["cpu"][0][k], rtol=1e-4)
        assert outs["cuda"][0]["iters"] == outs["cpu"][0]["iters"]
    else:
        assert outs["cuda"] == outs["cpu"]


@pytest.mark.cuda
def test_native_fed_worker_steps_on_card_like_the_python_fed(dev, tmp_path):
    """``LinearMethod`` on the card fed by ``MinibatchReader(backend=
    "native")`` (the C++ parser and localizer) takes the steps the
    Python-fed run takes: the same losses at 1e-5, K2 once a step."""
    from parameter_server_tpu_torch.data import native
    from parameter_server_tpu_torch.data.reader import MinibatchReader
    from parameter_server_tpu_torch.data.synthetic import make_sparse_logistic, write_libsvm
    from parameter_server_tpu_torch.models.linear import LinearMethod
    from parameter_server_tpu_torch.utils.config import PSConfig
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    assert native.native_available(), native.build_log()
    labels, keys, vals, _ = make_sparse_logistic(2048, 5000, nnz_per_example=12, seed=3)
    path = tmp_path / "a.svm"
    write_libsvm(path, labels, keys, vals)
    cfg = PSConfig()
    cfg.data.num_keys = 1 << 16
    cfg.solver.minibatch = 256
    losses = {}
    for backend in ("native", "python"):
        rep = ProgressReporter(print_fn=lambda *_: None)
        app = LinearMethod(cfg, reporter=rep, device="cuda")
        before = fk.LAUNCHES["ftrl_delta"]
        app.train(MinibatchReader([path], "libsvm", app.make_builder(), backend=backend),
                  report_every=1)
        assert fk.LAUNCHES["ftrl_delta"] - before == len(rep.history) == 8
        losses[backend] = [r["objv"] for r in rep.history]
    np.testing.assert_allclose(losses["native"], losses["python"], **TOL)


@pytest.mark.cuda
def test_traced_card_server_push_launches_k1_and_exports_its_spans(dev, tmp_path):
    """A traced push into a card ``ShardServer``: K1 applies it, and the
    export holds the client's ``rpc.push`` and the server's
    ``rpc.serve.push`` / ``server.updater`` spans under one trace id."""
    import json

    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.parallel.multislice import ServerHandle, ShardServer
    from parameter_server_tpu_torch.utils import trace
    from parameter_server_tpu_torch.utils.config import PSConfig
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    trace.configure(str(tmp_path), process_name="card")
    try:
        srv = ShardServer(Ftrl(), KeyRange(0, 1 << 16), device="cuda").start()
        h = ServerHandle(srv.address, 0, 0, PSConfig(), range_size=1 << 16, device="cuda")
        before = fk.LAUNCHES["ftrl_push"]
        keys = np.arange(1, 4097, dtype=np.int64)
        h.push(keys, np.ones(len(keys), np.float32))
        h.pull(keys)
        h.shutdown()
        h.close()
        srv.join(timeout=30)
        assert fk.LAUNCHES["ftrl_push"] - before == srv.counters["apply_batches"] == 1
        path = trace.tracer.flush()
    finally:
        trace.configure(None)
    evs = json.loads(open(path).read())["traceEvents"]
    spans = {e["name"]: e["args"]["trace_id"] for e in evs if e["ph"] == "X"}
    push_tid = spans["ps.push"]
    assert spans["rpc.push"] == spans["rpc.serve.push"] == spans["server.updater"] == push_tid


@pytest.mark.cuda
def test_card_server_books_its_range_apply_cost_without_a_device_read(dev):
    """A card FTRL server's ``RangeScope``: every applied push and its
    payload bytes land in the range's counters and each apply batch's
    host time in its ``apply`` histogram, one observation a K1 launch."""
    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.parallel.multislice import ServerHandle, ShardServer
    from parameter_server_tpu_torch.utils import metrics
    from parameter_server_tpu_torch.utils.config import PSConfig
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    size = 1 << 16
    metrics.wire_counters.reset()
    metrics.latency_histograms.reset()
    srv = ShardServer(Ftrl(), KeyRange(size, 2 * size), device="cuda").start()
    h = ServerHandle(srv.address, 0, 0, PSConfig(), range_size=size, device="cuda")
    rng = np.random.default_rng(2)
    try:
        before = fk.LAUNCHES["ftrl_push"]
        nbytes = 0
        for _ in range(5):
            keys = np.unique(rng.integers(0, size, 3000))
            nbytes += 4 * len(keys)
            h.push(keys, rng.normal(size=len(keys)).astype(np.float32))
        launches = fk.LAUNCHES["ftrl_push"] - before
    finally:
        h.shutdown()
        h.close()
    rid = f"range.{size}-{2 * size}"
    c = metrics.wire_counters.snapshot()
    assert c[f"{rid}.push"] == 5 and c[f"{rid}.push_bytes"] == nbytes
    apply = metrics.latency_histograms.snapshot()[f"{rid}.apply"]
    assert apply["count"] == srv.counters["apply_batches"] == launches
    assert apply["sum_s"] > 0


@pytest.mark.cuda
def test_card_server_telemetry_snapshot_after_k1_pushes(dev):
    """After K1 pushes into a card server, the process's telemetry
    snapshot has the JAX package's blocks: the server and client push
    histograms, the range series, the apply-batch sizes and key heat."""
    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.parallel.multislice import ServerHandle, ShardServer
    from parameter_server_tpu_torch.utils import metrics
    from parameter_server_tpu_torch.utils.config import PSConfig
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    for reg in (metrics.wire_counters, metrics.latency_histograms, metrics.key_heat):
        reg.reset()
    srv = ShardServer(Ftrl(), KeyRange(0, 1 << 16), device="cuda").start()
    h = ServerHandle(srv.address, 0, 0, PSConfig(), range_size=1 << 16, device="cuda")
    try:
        before = fk.LAUNCHES["ftrl_push"]
        keys = np.arange(1, 4097, dtype=np.int64)
        for _ in range(3):
            h.push(keys, np.ones(len(keys), np.float32))
        h.pull(keys)
        assert fk.LAUNCHES["ftrl_push"] - before == srv.counters["apply_batches"]
    finally:
        h.shutdown()
        h.close()
    srv.join(timeout=30)  # the apply thread books a batch's heat after its replies
    snap = metrics.telemetry_snapshot()
    assert {"counters", "hists", "timers", "key_heat"} <= set(snap)
    hists = snap["hists"]
    assert hists["server.push"]["count"] == 3 and hists["client.push"]["count"] == 3
    assert hists["server.apply_batch.n"]["count"] == srv.counters["apply_batches"]
    assert snap["counters"]["range.0-65536.pull"] == 1
    assert snap["key_heat"]["n"] == 4 * 4096


@pytest.mark.cuda
def test_darlin_segment_sum_repeats_on_card(dev):
    """Darlin's segment sum on the card: one hot id of 600k entries, the
    same bits in every call (``index_add_``'s atomics need not give them)
    and the float64 sums within rtol 1e-5 / atol 1e-3 (float32 over 1.2M
    entries)."""
    from parameter_server_tpu_torch.models import darlin

    gen = torch.Generator(device=dev).manual_seed(3)
    ids = torch.randint(0, 4096, (1_200_000,), device=dev, generator=gen, dtype=torch.int32)
    ids[:600_000] = 7
    ids = ids[torch.randperm(ids.numel(), device=dev, generator=gen)]
    x = torch.randn(ids.numel(), device=dev, generator=gen)
    sums = [darlin._segment_sum(x, ids, 4096) for _ in range(4)]
    for s in sums[1:]:
        assert torch.equal(s, sums[0])
    want = torch.zeros(4096, dtype=torch.float64).index_add_(0, ids.long().cpu(),
                                                             x.double().cpu())
    np.testing.assert_allclose(sums[0].cpu().numpy(), want.numpy(), rtol=1e-5, atol=1e-3)


@pytest.mark.cuda
def test_explorer_armed_card_server_applies_through_k1(dev):
    """A card FTRL ``ShardServer`` built under the schedule explorer
    (seed 8) and the serving chaos plan, caching on: every push applies
    through K1 with the publish boundary firing around each apply, each
    pull reads its own writes, and the table equals the plain store's
    replay on the CPU (TOL)."""
    from parameter_server_tpu_torch.analysis import explorer
    from parameter_server_tpu_torch.kv.store import KVStore
    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.parallel.chaos import FaultPlan
    from parameter_server_tpu_torch.parallel.multislice import ServerHandle, ShardServer
    from parameter_server_tpu_torch.utils.config import PSConfig, ServeConfig
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    size = 1 << 12
    rng = np.random.default_rng(8)
    keys = np.sort(rng.choice(size, 64, replace=False)).astype(np.int64)
    grads = [rng.normal(0.0, 3.0, 64).astype(np.float32) for _ in range(12)]

    def make():
        return Ftrl(alpha=0.1, beta=1.0, lambda_l1=1.0, lambda_l2=0.0)

    plan = FaultPlan.parse(
        "drop,cmd=pull,every=7;disconnect,cmd=push,every=5;duplicate,every=6", seed=3)
    svc = ServeConfig(cache=True, ttl_ms=10_000, max_stale_ms=60_000, hot_min_pulls=1,
                      encode_cache_entries=64)
    store = KVStore(make(), size, device="cpu")
    explorer.install(seed=8)
    try:
        srv = ShardServer(make(), KeyRange(0, size), serve_cfg=svc, fault_plan=plan,
                          device="cuda").start()
        cfg = PSConfig()
        cfg.serve = svc
        h = ServerHandle(srv.address, 0, 0, cfg, range_size=size, serving=True,
                         reconnect_timeout_s=30.0, device="cuda")
        before = fk.LAUNCHES["ftrl_push"]
        try:
            for g in grads:
                h.push(keys, g)
                store.push(keys, g)
                np.testing.assert_allclose(h.pull(keys), store.pull(keys).numpy().ravel(),
                                           **TOL)
            assert srv.counters["pushes"] == 12
            launched = fk.LAUNCHES["ftrl_push"] - before
            assert launched == srv.counters["apply_batches"] >= 1
            got = srv.weights().reshape(-1)
        finally:
            h.shutdown()
            h.close()
        d = explorer.decisions()
    finally:
        explorer.uninstall()
    assert len(d.get("rcu-publish:ShardServer._publish", [])) >= launched
    assert any(s.startswith("queue.") for s in d)
    np.testing.assert_allclose(got, store.weights().numpy().reshape(-1), **TOL)
