"""Port parity for the copied jax-free modules: config, hashing, batches,
parsers, reader (and its flat row stream), frequency filter, metrics,
checkpoints, the workload pool, the prefetch pipeline and the column-block
cache. These are copies, so the port must give exactly
the JAX package's results."""

import dataclasses
import json
import threading

import numpy as np
import pytest
import torch

from parameter_server_tpu.data import batch as JB
from parameter_server_tpu.data import blockcache as JBC
from parameter_server_tpu.data import pipeline as JP
from parameter_server_tpu.data import reader as JR
from parameter_server_tpu.data import synthetic as JS
from parameter_server_tpu.filters.frequency import CountMinSketch as JCMS
from parameter_server_tpu.models import metrics as JM
from parameter_server_tpu.parallel import workload as JW
from parameter_server_tpu.utils import checkpoint as JCK
from parameter_server_tpu.utils import config as JCFG
from parameter_server_tpu.utils import hashing as JH
from parameter_server_tpu_torch.data import batch as TB
from parameter_server_tpu_torch.data import blockcache as TBC
from parameter_server_tpu_torch.data import pipeline as TP
from parameter_server_tpu_torch.data import reader as TR
from parameter_server_tpu_torch.data import synthetic as TS
from parameter_server_tpu_torch.filters.frequency import CountMinSketch as TCMS
from parameter_server_tpu_torch.models import metrics as TM
from parameter_server_tpu_torch.parallel import workload as TW
from parameter_server_tpu_torch.utils import checkpoint as TCK
from parameter_server_tpu_torch.utils import config as TCFG
from parameter_server_tpu_torch.utils import hashing as TH

BATCH_FIELDS = [f.name for f in dataclasses.fields(JB.CSRBatch)]


def _same_batch(a, b):
    for f in BATCH_FIELDS:
        x, y = getattr(a, f), getattr(b, f)
        if isinstance(x, np.ndarray):
            assert x.dtype == y.dtype, f
            np.testing.assert_array_equal(x, y, err_msg=f)
        else:
            assert x == y, f


def test_config_tree_is_the_jax_tree(tmp_path):
    assert dataclasses.asdict(TCFG.PSConfig()) == dataclasses.asdict(JCFG.PSConfig())
    assert set(TCFG._NESTED) == set(JCFG._NESTED)
    for name, cls in JCFG._NESTED.items():
        assert [f.name for f in dataclasses.fields(TCFG._NESTED[name])] == [
            f.name for f in dataclasses.fields(cls)
        ]
    toml = tmp_path / "c.toml"
    toml.write_text('[data]\nnum_keys = 512\n[solver]\nminibatch = 7\n')
    assert TCFG.config_to_dict(TCFG.load_config(toml)) == JCFG.config_to_dict(
        JCFG.load_config(toml)
    )
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"solver": {"minibatchh": 3}}))
    with pytest.raises(ValueError, match="unknown SolverConfig"):
        TCFG.load_config(bad)


def test_hashing_and_sketch_match_jax():
    raw = np.random.default_rng(0).integers(0, 2**63, 5000, dtype=np.int64).astype(np.uint64)
    np.testing.assert_array_equal(TH.splitmix64(raw), JH.splitmix64(raw))
    for slots in (0, np.arange(5000) % 7):
        np.testing.assert_array_equal(
            TH.hash_keys(raw, 1 << 20, slots), JH.hash_keys(raw, 1 << 20, slots)
        )
    t, j = TCMS(1 << 10, 3), JCMS(1 << 10, 3)
    t.add(raw[:3000])
    j.add(raw[:3000])
    np.testing.assert_array_equal(t.count(raw), j.count(raw))
    np.testing.assert_array_equal(t.admit(raw, 2), j.admit(raw, 2))


BUILDER_KWS = [
    {"key_mode": "hash"},
    {"key_mode": "identity"},
    {"key_mode": "hash", "bucket_nnz": True},
    {"key_mode": "hash", "freq_min_count": 2},
]


@pytest.mark.parametrize("kw", BUILDER_KWS)
def test_batch_builder_matches_jax(kw):
    labels, keys, vals, _ = JS.make_sparse_logistic(300, 900, nnz_per_example=9, seed=2)
    jb = JB.BatchBuilder(num_keys=4096, batch_size=100, max_nnz_per_example=40, **kw)
    tb = TB.BatchBuilder(num_keys=4096, batch_size=100, max_nnz_per_example=40, **kw)
    for i in range(0, 300, 100):
        _same_batch(
            tb.build(labels[i:i + 100], keys[i:i + 100], vals[i:i + 100]),
            jb.build(labels[i:i + 100], keys[i:i + 100], vals[i:i + 100]),
        )


def _criteo_shaped_batch(builder, size=256, fields=39, seed=5):
    """``size`` rows of ``fields`` power-law ids each, salted by field."""
    rng = np.random.default_rng(seed)
    keys = (rng.zipf(1.3, (size, fields)) % (1 << 20)).astype(np.uint64).ravel()
    slots = np.tile(np.arange(fields, dtype=np.int64), size)
    splits = np.arange(0, size * fields + 1, fields, dtype=np.int64)
    labels = (rng.random(size) < 0.27).astype(np.float32)
    return builder.build_flat(labels, splits, keys, np.ones(size * fields, np.float32), slots)


def _trim_cases(device=None):
    bucketed = TB.BatchBuilder(num_keys=1 << 22, batch_size=256, max_nnz_per_example=64,
                               bucket_nnz=True, device=device)
    labels, keys, vals, _ = TS.make_sparse_logistic(100, 600, nnz_per_example=9, seed=3)
    filtered = TB.BatchBuilder(num_keys=4096, batch_size=100, max_nnz_per_example=40,
                               freq_min_count=2, device=device)
    empty = TB.BatchBuilder(num_keys=4096, batch_size=16, max_nnz_per_example=8,
                            bucket_nnz=True, device=device)
    kept = filtered.build(labels, keys, vals)
    # the keys seen once in the batch were dropped before localization
    assert 0 < kept.num_entries < sum(map(len, keys))
    return {
        "bucketed_criteo": _criteo_shaped_batch(bucketed),
        "filtered": kept,
        "no_entries": empty.build(np.ones(10, np.float32), [np.zeros(0, np.uint64)] * 10,
                                  [np.zeros(0, np.float32)] * 10),
    }


@pytest.mark.parametrize("case", ["bucketed_criteo", "filtered", "no_entries"])
def test_trim_batch_is_pad_batch_inverse(case):
    b = _trim_cases()[case]
    t = TB.trim_batch(b)
    assert len(t.unique_keys) == b.num_unique < len(b.unique_keys)
    for f in ("local_ids", "row_ids", "values"):
        assert len(getattr(t, f)) == b.num_entries < len(getattr(b, f)), f
    for f in ("unique_keys", "local_ids", "row_ids", "values"):
        x, y = getattr(t, f), getattr(b, f)
        # a zero-length view shares no bytes; it still starts where its array does
        assert np.shares_memory(x, y) or (x.size == 0 and x.ctypes.data == y.ctypes.data), f
    for f in ("labels", "example_mask", "row_splits"):
        assert getattr(t, f) is getattr(b, f), f
    assert (t.num_examples, t.num_unique, t.num_entries) == (
        b.num_examples, b.num_unique, b.num_entries)
    _same_batch(TB.pad_batch(t, len(b.values), len(b.unique_keys)), b)


@pytest.fixture
def stand_in_block(monkeypatch):
    """A plain uint8 tensor in place of the page-locked block, which a
    CPU-only torch cannot allocate; returns the sizes asked for."""
    asked = []

    def block(nbytes):
        asked.append(nbytes)
        return torch.empty(nbytes, dtype=torch.uint8)

    monkeypatch.setattr(TB, "_pinned_block", block)
    return asked


@pytest.mark.parametrize("device", [None, "cpu", torch.device("cpu"), "cuda"])
@pytest.mark.parametrize("kw", BUILDER_KWS)
def test_batch_builder_on_any_device_builds_the_jax_arrays(kw, device, stand_in_block):
    """A builder builds the JAX builder's arrays bit for bit on any device.
    With no device or the CPU it asks for no page-locked block and its
    batches carry none; on a CUDA device each batch is one block, and its
    arrays are views of it, in block order, each on a 16-byte boundary."""
    labels, keys, vals, _ = JS.make_sparse_logistic(300, 900, nnz_per_example=9, seed=2)
    jb = JB.BatchBuilder(num_keys=4096, batch_size=100, max_nnz_per_example=40, **kw)
    tb = TB.BatchBuilder(num_keys=4096, batch_size=100, max_nnz_per_example=40,
                         device=device, **kw)
    assert tb.page_locked == (device == "cuda")
    for i in range(0, 300, 100):
        t = tb.build(labels[i:i + 100], keys[i:i + 100], vals[i:i + 100])
        _same_batch(t, jb.build(labels[i:i + 100], keys[i:i + 100], vals[i:i + 100]))
        if device != "cuda":
            assert t.pinned is None
            continue
        base, size = t.pinned.data_ptr(), t.pinned.numel()
        offsets = [getattr(t, f).ctypes.data - base for f in TB._ARRAY_FIELDS]
        assert offsets == sorted(offsets) and all(o % 16 == 0 for o in offsets)
        for f, o in zip(TB._ARRAY_FIELDS, offsets):
            assert 0 <= o and o + getattr(t, f).nbytes <= size, f
    assert len(stand_in_block) == (3 if device == "cuda" else 0)


@pytest.mark.parametrize("case", ["bucketed_criteo", "filtered", "no_entries"])
def test_trim_keeps_the_page_locked_block_and_a_padding_copy_drops_it(case, stand_in_block):
    b = _trim_cases(device="cuda")[case]
    t = TB.trim_batch(b)
    assert b.pinned is not None and t.pinned is b.pinned
    assert TB.pad_batch(b, len(b.values), len(b.unique_keys)) is b
    padded = TB.pad_batch(t, len(b.values), len(b.unique_keys))
    assert padded.pinned is None
    _same_batch(padded, b)
    assert [g.pinned is None for g in TB.pad_group([t, b])] == [True, False]


@pytest.mark.parametrize("device", [None, "cuda"])
@pytest.mark.parametrize("case", ["bucketed_criteo", "filtered", "no_entries"])
def test_batch_to_device_on_cpu_gives_the_host_arrays(case, device, stand_in_block):
    """On the CPU, ``batch_to_device`` of a trimmed batch gives tensors
    over the batch's own host arrays, with or without a page-locked block."""
    b = TB.trim_batch(_trim_cases(device=device)[case])
    got = TB.batch_to_device(b, "cpu")
    assert list(got) == list(TB._BATCH_FIELDS)
    for f, t in got.items():
        a = getattr(b, f)
        want = torch.from_numpy(a)
        assert t.device.type == "cpu" and t.dtype == want.dtype, f
        assert torch.equal(t, want), f
        assert t.numel() == 0 or t.data_ptr() == a.ctypes.data, f


def test_batch_to_device_refuses_an_array_outside_the_block(stand_in_block):
    b = _trim_cases(device="cuda")["bucketed_criteo"]
    moved = dataclasses.replace(b, values=b.values.copy())
    with pytest.raises(ValueError, match="outside the batch's page-locked block"):
        TB.batch_to_device(moved, "cpu")


def test_synthetic_data_matches_jax():
    a = TS.make_sparse_logistic(50, 300, nnz_per_example=6, seed=4)
    b = JS.make_sparse_logistic(50, 300, nnz_per_example=6, seed=4)
    np.testing.assert_array_equal(a[0], b[0])
    np.testing.assert_array_equal(a[3], b[3])
    for x, y in zip(a[1] + a[2], b[1] + b[2]):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("fmt", ["libsvm", "libsvm.gz"])
def test_reader_matches_jax_python_backend(tmp_path, fmt):
    labels, keys, vals, _ = TS.make_sparse_logistic(230, 500, nnz_per_example=7, seed=5)
    path = tmp_path / "a.libsvm"
    TS.write_libsvm(path, labels, keys, vals)
    if fmt.endswith(".gz"):
        import gzip

        gz = tmp_path / "a.libsvm.gz"
        gz.write_bytes(gzip.compress(path.read_bytes()))
        path = gz
    mk = dict(num_keys=2048, batch_size=64, max_nnz_per_example=30)
    tb = list(TR.MinibatchReader([path], "libsvm", TB.BatchBuilder(**mk), epochs=2))
    jb = list(JR.MinibatchReader([path], "libsvm", JB.BatchBuilder(**mk), epochs=2,
                                 backend="python"))
    assert len(tb) == len(jb) == 8
    for a, b in zip(tb, jb):
        _same_batch(a, b)


def test_reader_refuses_native_and_joins_its_thread(tmp_path):
    """The native backend, which the port once refused, reads the JAX
    Python reader's batches; and the prefetch thread joins when the
    consumer breaks out early."""
    path = tmp_path / "a.libsvm"
    TS.write_libsvm(path, *TS.make_sparse_logistic(500, 100, nnz_per_example=3, seed=6)[:3])
    builder = TB.BatchBuilder(num_keys=1024, batch_size=10, max_nnz_per_example=20)
    got = list(TR.MinibatchReader([path], "libsvm", builder, backend="native"))
    want = list(JR.MinibatchReader([path], "libsvm", JB.BatchBuilder(
        num_keys=1024, batch_size=10, max_nnz_per_example=20), backend="python"))
    assert len(got) == len(want) == 50
    for a, b in zip(got, want):
        _same_batch(a, b)
    before = set(threading.enumerate())
    it = iter(TR.MinibatchReader([path], "libsvm", builder, prefetch=2))
    next(it)
    assert any(t.name == "minibatch-reader" for t in threading.enumerate())
    it.close()  # the consumer breaks out early
    assert not any(t.name == "minibatch-reader" for t in threading.enumerate())
    # no thread the reader started survives it (a thread of an earlier
    # test that ends meanwhile is no leak of this one)
    assert set(threading.enumerate()) <= before


def test_metrics_match_jax():
    rng = np.random.default_rng(7)
    y = (rng.random(400) < 0.4).astype(np.float32)
    p = np.round(rng.random(400), 2)  # ties
    assert TM.auc(y, p) == JM.auc(y, p)
    assert TM.logloss(y, p) == JM.logloss(y, p)
    assert np.isnan(TM.auc(np.ones(3), p[:3]))


def test_checkpoint_files_interchange(tmp_path):
    st = {"kv": {"z": np.arange(12, dtype=np.float32).reshape(6, 2),
                 "n": np.ones((6, 2), np.float32)}}
    TCK.save_checkpoint(tmp_path / "t", st, meta={"a": 1})
    state, meta = JCK.load_checkpoint(tmp_path / "t")
    np.testing.assert_array_equal(state["kv"]["z"], st["kv"]["z"])
    assert meta == {"a": 1}
    JCK.save_checkpoint(tmp_path / "j", st, meta={"b": 2})
    state, meta = TCK.load_checkpoint(tmp_path / "j")
    np.testing.assert_array_equal(state["kv"]["n"], st["kv"]["n"])
    assert meta == {"b": 2}
    w = np.array([0.0, 1.5, 0.0, -2.25e-7], np.float32)
    assert TCK.dump_weights_text(w, tmp_path / "w.txt") == 2
    np.testing.assert_array_equal(JCK.load_weights_text(tmp_path / "w.txt", 4), w)
    np.testing.assert_array_equal(TCK.load_weights_text(tmp_path / "w.txt", 4), w)
    with pytest.raises(ValueError, match="outside"):
        TCK.load_weights_text(tmp_path / "w.txt", 2)


def test_workload_pool_matches_jax():
    """The trimmed WorkloadPool copy against the original on one sequence
    of fetches and finishes (a pending workload finished early, a finish
    repeated, an unknown one refused)."""
    names = [f"shard-{i}" for i in range(5)]
    pools = {"torch": TW.WorkloadPool(names), "jax": JW.WorkloadPool(names)}
    seen = {}
    for name, pool in pools.items():
        log = [pool.fetch(0), pool.fetch(1), pool.all_done]
        pool.finish("shard-0")
        pool.finish("shard-4")  # still pending: dropped from the queue
        pool.finish("shard-0")  # already done: a no-op
        log += [pool.fetch(2), pool.fetch(0), pool.fetch(1), pool.all_done]
        for w in ("shard-1", "shard-2", "shard-3"):
            pool.finish(w)
        with pytest.raises(KeyError, match="unknown workload"):
            pool.finish("shard-9")
        stats = pool.stats()
        log += [pool.all_done, {k: stats[k] for k in ("pending", "active", "done", "attempts")}]
        seen[name] = log
    assert seen["torch"] == seen["jax"]
    assert seen["torch"][-1] == {"pending": 0, "active": 0, "done": 5, "attempts": 4}


class _Counter:
    """A stream of numbered batches; optionally fails at batch ``fail_at``."""

    def __init__(self, start: int, n: int, fail_at: int = -1):
        self.next_i, self.end, self.fail_at = start, start + n, fail_at

    def next_batch(self):
        if self.next_i == self.fail_at:
            raise RuntimeError(f"builder failed at {self.fail_at}")
        if self.next_i >= self.end:
            return None
        self.next_i += 1
        return self.next_i - 1

    def _empty(self):
        return -1


def _drain(mod, streams, group_size):
    pipe = mod.PrefetchPipeline(streams, lambda bs: tuple(bs), depth=2,
                                group_size=group_size,
                                assemble=(lambda items: list(items)) if group_size > 1 else None)
    with pipe:
        items = []
        while (it := pipe.get()) is not None:
            items.append(it)
        assert pipe.get() is None  # and forever after
    return items


@pytest.mark.parametrize("group_size", [1, 3])
def test_prefetch_pipeline_matches_jax(group_size):
    """Streams of unequal length: the shorter one is padded with its empty
    batch, a partial final group with prepared empties; the same items as
    the original, and every thread joined."""
    before = threading.active_count()
    got = _drain(TP, [_Counter(0, 7), _Counter(100, 4)], group_size)
    want = _drain(JP, [_Counter(0, 7), _Counter(100, 4)], group_size)
    assert got == want
    assert len(got) == (7 if group_size == 1 else 3)
    assert threading.active_count() == before
    with pytest.raises(ValueError, match="depth"):
        TP.PrefetchPipeline([], lambda bs: bs, depth=0)
    with pytest.raises(ValueError, match="assemble"):
        TP.PrefetchPipeline([], lambda bs: bs, group_size=2)


def test_prefetch_pipeline_raises_a_builder_error():
    before = threading.active_count()
    with TP.PrefetchPipeline([_Counter(0, 9, fail_at=3)], lambda bs: bs[0]) as pipe:
        with pytest.raises(RuntimeError, match="failed at 3"):
            while pipe.get() is not None:
                pass
    assert threading.active_count() == before


@pytest.mark.parametrize("begin,end,n", [(0, 1 << 12, 2), (7, 1001, 3), (5, 5, 4), (0, 3, 5)])
def test_key_range_matches_jax(begin, end, n):
    from parameter_server_tpu.utils.keyrange import KeyRange as JKR
    from parameter_server_tpu_torch.utils.keyrange import KeyRange as TKR

    t, j = TKR(begin, end), JKR(begin, end)
    assert [(r.begin, r.end) for r in t.even_divide(n)] == [
        (r.begin, r.end) for r in j.even_divide(n)]
    assert t.size == j.size
    for key in range(begin, end, max(1, (end - begin) // 37)):
        assert t.contains(key) and t.shard_of(key, n) == j.shard_of(key, n)
    o = (begin + 2, end + 9)
    assert (t.intersect(TKR(*o)).begin, t.intersect(TKR(*o)).end) == (
        j.intersect(JKR(*o)).begin, j.intersect(JKR(*o)).end)
    with pytest.raises(ValueError):
        TKR(end + 1, end)
    with pytest.raises(ValueError):
        t.even_divide(0)


def test_wire_counters_match_jax():
    from parameter_server_tpu.utils import metrics as JMT
    from parameter_server_tpu_torch.utils import metrics as TMT

    for mod in (JMT, TMT):
        c = mod.CounterSet()
        c.inc("a")
        c.inc_many({"a": 2, "b": 5})
        c.observe_max("p", 3)
        c.observe_max("p", 2)
        assert c.snapshot() == {"a": 3, "b": 5, "p": 3}
        assert c.snapshot(roll_peaks=True)["p"] == 3 and c.snapshot(roll_peaks=True)["p"] == 0
        c.reset()
        assert c.get("a") == 0


def test_chaos_copy_matches_jax():
    """``parallel/chaos.py`` is a copy: its constants are the original's,
    and one spec and seed decide the same actions over one command
    sequence, with the same fire counts."""
    from parameter_server_tpu.parallel import chaos as JCH
    from parameter_server_tpu_torch.parallel import chaos as TCH

    assert (TCH.ACTIONS, TCH._EXEMPT_CMDS, TCH.PLAN_ENV, TCH.SEED_ENV) == (
        JCH.ACTIONS, JCH._EXEMPT_CMDS, JCH.PLAN_ENV, JCH.SEED_ENV)
    spec = ("drop,prob=0.05;disconnect,cmd=push,every=5;duplicate,prob=0.05;"
            "delay,prob=0.1,delay_s=0.002,max=40")
    cmds = (["push", "pull", "stats", "shutdown", "workload_fetch"] * 400)
    seen = {}
    for mod in (JCH, TCH):
        plan = mod.FaultPlan.parse(spec, seed=7)
        seen[mod.__name__] = ([getattr(plan.decide(c), "action", None) for c in cmds],
                              plan.stats())
    assert seen[JCH.__name__] == seen[TCH.__name__]


def test_keycache_copy_matches_jax():
    """``filters/keycache.py`` is a copy: one sequence of puts, lookups,
    revalidations, shed back-offs, refresh claims and invalidations, on
    explicit clocks, gives the same entries and answers in both."""
    from parameter_server_tpu.filters.keycache import ClientKeyCache as JKC
    from parameter_server_tpu_torch.filters.keycache import ClientKeyCache as TKC

    rng = np.random.default_rng(11)
    key_sets = [np.unique(rng.integers(0, 40, 5)) for _ in range(60)]
    seen = {}
    for cls in (JKC, TKC):
        kc = cls(cap=6, ttl_s=0.05, max_stale_s=0.2)
        log = []
        for i, keys in enumerate(key_sets):
            rank, sig = i % 3, f"s{i % 9}"
            vals = np.full((len(keys), 1), i, np.float32)
            now = 100.0 + 0.01 * i
            gen = kc.gen
            if i % 7 == 3:
                log.append(kc.invalidate_keys(keys[:2], rank=rank))
            ent = kc.put((rank, sig), keys, vals, i, now=now, as_of=gen)
            log.append(None if ent is None else ent.version)
            e = kc.lookup((rank, f"s{(i * 5) % 9}"))
            if e is not None:
                log.append((e.version, kc.fresh(e, now=now + 0.03),
                            kc.can_shed(e, now=now + 0.15), float(e.values[0, 0])))
                if i % 4 == 0:
                    kc.revalidated((rank, f"s{(i * 5) % 9}"), e.version + 1, now=now,
                                   age_us=10.0 * i)
                    log.append((e.version, e.expires_at, e.age0_us))
                if i % 5 == 0:
                    claim = kc.begin_refresh((rank, sig))
                    log.append((claim, kc.begin_refresh((rank, sig))))
                    kc.end_refresh((rank, sig))
            log.append(len(kc))
        seen[cls.__module__] = log
    assert seen[JKC.__module__] == seen[TKC.__module__]


def test_histogram_copy_matches_jax():
    """The adaptive window's ``Histogram`` and ``hist_percentile`` give the
    original's buckets and quantiles."""
    from parameter_server_tpu.utils import metrics as JMT
    from parameter_server_tpu_torch.utils import metrics as TMT

    lat = np.random.default_rng(2).lognormal(-7, 1.5, 500)
    snaps = []
    for mod in (JMT, TMT):
        h = mod.Histogram()
        for v in lat:
            h.observe(float(v))
        snap = h.snapshot()
        snaps.append(({k: snap[k] for k in ("count", "buckets")},
                      [mod.hist_percentile(snap, p) for p in (0.0, 0.5, 0.9, 0.99, 1.0)]))
    assert snaps[0] == snaps[1]


def test_blockcache_copy_matches_jax(tmp_path):
    """Layout, fingerprint and files: the port's from_batches equals the
    JAX one, either package's save loads in the other (mmap), and the
    fingerprints of the same sources and parameters are equal."""
    labels, keys, vals, _ = TS.make_sparse_logistic(300, 200, nnz_per_example=6, seed=8)
    builder = JB.BatchBuilder(num_keys=256, batch_size=64)
    batches = [builder.build(labels[i:i + 64], keys[i:i + 64], vals[i:i + 64])
               for i in range(0, 300, 64)]
    tcb = TBC.ColumnBlocks.from_batches(batches, 256, 4)
    jcb = JBC.ColumnBlocks.from_batches(batches, 256, 4)
    fields = ("feat_local", "rows", "values", "labels")
    for f in fields:
        np.testing.assert_array_equal(getattr(tcb, f), getattr(jcb, f))
    assert (tcb.num_keys, tcb.block_size, tcb.num_examples) == (
        jcb.num_keys, jcb.block_size, jcb.num_examples)
    src = tmp_path / "a.svm"
    TS.write_libsvm(src, labels, keys, vals)
    fp = TBC.source_fingerprint([str(src)], "libsvm", 256, 4, 512)
    assert fp == JBC.source_fingerprint([str(src)], "libsvm", 256, 4, 512)
    TBC.save_column_blocks(tmp_path / "t", tcb, fp)
    JBC.save_column_blocks(tmp_path / "j", jcb, fp)
    assert (tmp_path / "t" / "meta.json").read_text() == (tmp_path / "j" / "meta.json").read_text()
    for load, d in ((JBC.load_column_blocks, "t"), (TBC.load_column_blocks, "j")):
        got = load(tmp_path / d, fp)
        for f in fields:
            np.testing.assert_array_equal(np.asarray(getattr(got, f)), getattr(tcb, f))


@pytest.mark.parametrize("fmt", ["libsvm", "adfea"])
def test_iter_flat_rows_matches_jax_python_backend(tmp_path, fmt, monkeypatch):
    from parameter_server_tpu.data import native as JN

    monkeypatch.setattr(JN, "native_available", lambda: False)
    labels, keys, vals, _ = TS.make_sparse_logistic(80, 300, nnz_per_example=5, seed=9)
    path = tmp_path / "a.txt"
    if fmt == "libsvm":
        TS.write_libsvm(path, labels, keys, vals)
    else:  # adfea: "line_id clicked fid:slot ..."
        with open(path, "w") as f:
            for i, (y, k) in enumerate(zip(labels, keys)):
                f.write(f"{i} {int(y)} " + " ".join(f"{int(x)}:{int(x) % 7}" for x in k) + "\n")
    got = list(TR.iter_flat_rows([path], fmt))
    want = list(JR.iter_flat_rows([path], fmt))
    assert len(got) == len(want) == 1
    for a, b in zip(got[0], want[0]):
        if b is None:
            assert a is None
        else:
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
    assert (got[0][4] is None) == (fmt == "libsvm")
