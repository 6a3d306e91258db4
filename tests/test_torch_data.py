"""Port parity for the copied jax-free modules: config, hashing, batches,
parsers, reader, frequency filter, metrics, checkpoints. These are copies,
so the port must give exactly the JAX package's results."""

import dataclasses
import json
import threading

import numpy as np
import pytest

from parameter_server_tpu.data import batch as JB
from parameter_server_tpu.data import reader as JR
from parameter_server_tpu.data import synthetic as JS
from parameter_server_tpu.filters.frequency import CountMinSketch as JCMS
from parameter_server_tpu.models import metrics as JM
from parameter_server_tpu.utils import checkpoint as JCK
from parameter_server_tpu.utils import config as JCFG
from parameter_server_tpu.utils import hashing as JH
from parameter_server_tpu_torch.data import batch as TB
from parameter_server_tpu_torch.data import reader as TR
from parameter_server_tpu_torch.data import synthetic as TS
from parameter_server_tpu_torch.filters.frequency import CountMinSketch as TCMS
from parameter_server_tpu_torch.models import metrics as TM
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


@pytest.mark.parametrize("kw", [
    {"key_mode": "hash"},
    {"key_mode": "identity"},
    {"key_mode": "hash", "bucket_nnz": True},
    {"key_mode": "hash", "freq_min_count": 2},
])
def test_batch_builder_matches_jax(kw):
    labels, keys, vals, _ = JS.make_sparse_logistic(300, 900, nnz_per_example=9, seed=2)
    jb = JB.BatchBuilder(num_keys=4096, batch_size=100, max_nnz_per_example=40, **kw)
    tb = TB.BatchBuilder(num_keys=4096, batch_size=100, max_nnz_per_example=40, **kw)
    for i in range(0, 300, 100):
        _same_batch(
            tb.build(labels[i:i + 100], keys[i:i + 100], vals[i:i + 100]),
            jb.build(labels[i:i + 100], keys[i:i + 100], vals[i:i + 100]),
        )


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
    path = tmp_path / "a.libsvm"
    TS.write_libsvm(path, *TS.make_sparse_logistic(500, 100, nnz_per_example=3, seed=6)[:3])
    builder = TB.BatchBuilder(num_keys=1024, batch_size=10, max_nnz_per_example=20)
    with pytest.raises(NotImplementedError, match="not ported"):
        TR.MinibatchReader([path], "libsvm", builder, backend="native")
    before = threading.active_count()
    it = iter(TR.MinibatchReader([path], "libsvm", builder, prefetch=2))
    next(it)
    assert any(t.name == "minibatch-reader" for t in threading.enumerate())
    it.close()  # the consumer breaks out early
    assert not any(t.name == "minibatch-reader" for t in threading.enumerate())
    assert threading.active_count() == before


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
