"""Port parity for the graph_partition and sketch apps, on the CPU. Mirrors
tests/test_graph_sketch.py.

graph_partition: every presence, affinity and size value is a count held
in float32 below 2^24, so every sum is exact in any order: the port's
state (presence, sizes), assignments, metrics and dump equal the JAX
package's (jitted) exactly. sketch is numpy host code in both packages on
copies of the same count-min sketch: its results and dumps are equal."""

import json

import numpy as np
import pytest

from parameter_server_tpu import cli as JC
from parameter_server_tpu.data.batch import BatchBuilder as JBB
from parameter_server_tpu.models import graph_partition as JG
from parameter_server_tpu.models import sketch as JS
from parameter_server_tpu.utils.config import PSConfig as JCfg
from parameter_server_tpu_torch import cli as TC
from parameter_server_tpu_torch.data import reader as TR
from parameter_server_tpu_torch.data.batch import BatchBuilder
from parameter_server_tpu_torch.data.synthetic import make_sparse_logistic, write_libsvm
from parameter_server_tpu_torch.models import graph_partition as TG
from parameter_server_tpu_torch.models import sketch as TS
from parameter_server_tpu_torch.models.linear import batch_to_device
from parameter_server_tpu_torch.utils.config import PSConfig


def _community_batches(builder, n_examples=512, feats_per=6, seed=0):
    """Two communities: examples draw features from disjoint pools."""
    rng = np.random.default_rng(seed)
    labels = np.zeros(n_examples, dtype=np.float32)
    keys, vals = [], []
    for i in range(n_examples):
        pool = rng.integers(0, 500, feats_per) + (0 if i % 2 == 0 else 1000)
        keys.append(np.unique(pool.astype(np.uint64)))
        vals.append(np.ones(len(keys[-1]), dtype=np.float32))
    bs = builder.batch_size
    return [builder.build(labels[i:i + bs], keys[i:i + bs], vals[i:i + bs])
            for i in range(0, n_examples, bs)]


def _cfg(cls=PSConfig, **kw):
    cfg = cls()
    cfg.app = "graph_partition"
    cfg.data.num_keys = 1 << 13
    cfg.solver.minibatch = 64
    cfg.data.max_nnz_per_example = 32
    for k, v in kw.items():
        obj, attr = cfg, k
        while "." in attr:
            head, attr = attr.split(".", 1)
            obj = getattr(obj, head)
        setattr(obj, attr, v)
    return cfg


def _builder(cfg, **kw):
    return BatchBuilder(num_keys=cfg.data.num_keys, batch_size=cfg.solver.minibatch,
                        max_nnz_per_example=cfg.data.max_nnz_per_example, **kw)


def _both(batches, **kw):
    """The port's and the JAX app on the same batches."""
    t = TG.GraphPartition(_cfg(**kw), device="cpu")
    j = JG.GraphPartition(_cfg(JCfg, **kw))
    return t, t.partition(batches), j, j.partition(batches)


def _zipf_batches(seed=4, n=600, bs=64, num_keys=1 << 12):
    labels, keys, vals, _ = make_sparse_logistic(n, 800, nnz_per_example=9, seed=seed)
    b = BatchBuilder(num_keys=num_keys, batch_size=bs, max_nnz_per_example=32)
    return [b.build(labels[i:i + bs], keys[i:i + bs], vals[i:i + bs])
            for i in range(0, n, bs)]


def _equal_to_jax(t, tout, j, jout):
    assert tout == jout
    np.testing.assert_array_equal(t.assignments, j.assignments)
    st = t.state_dict()
    for k in ("presence", "sizes"):
        assert st[k].dtype == np.float32
        np.testing.assert_array_equal(st[k], np.asarray(j.state[k]), err_msg=k)
    np.testing.assert_array_equal(t.feature_partition(), j.feature_partition())


class TestGraphPartition:
    @pytest.mark.parametrize("k,penalty", [(2, 1.0), (4, 1.0), (3, 0.5), (8, 10.0)])
    def test_state_and_assignments_equal_jax(self, k, penalty):
        cfg = _cfg(**{"graph.num_partitions": k})
        batches = _community_batches(_builder(cfg), seed=k)
        _equal_to_jax(*_both(batches, **{"graph.num_partitions": k,
                                         "graph.balance_penalty": penalty}))

    def test_zipf_hashed_batches_equal_jax(self):
        """Hot keys shared by most examples, hashed keys, pads in every
        batch: state and assignments still equal."""
        kw = {"graph.num_partitions": 4, "data.num_keys": 1 << 12}
        _equal_to_jax(*_both(_zipf_batches(), **kw))

    @pytest.mark.parametrize("refine", [0, 1, 3])
    def test_partition_step_equals_jax(self, refine):
        cfg = _cfg(**{"graph.num_partitions": 4})
        batches = _community_batches(_builder(cfg), seed=7)
        ts = TG.init_state(cfg.data.num_keys, 4, "cpu")
        js = JG.init_state(cfg.data.num_keys, 4)
        for b in batches:
            ts, ta = TG.partition_step(ts, batch_to_device(b, "cpu"), 4, 1.0,
                                       refine_passes=refine)
            js, ja = JG.partition_step(js, JG.batch_to_device(b), 4, 1.0, refine)
            np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        for k in ("presence", "sizes"):
            np.testing.assert_array_equal(ts[k].numpy(), np.asarray(js[k]))
        assert TG.partition_metrics(ts) == JG.partition_metrics(js)

    def test_jax_state_continues_in_the_port(self):
        """A JAX partition state, as numpy arrays, continues in the port
        (``load_state``) with the JAX app's results."""
        kw = {"graph.num_partitions": 4}
        cfg = _cfg(**kw)
        batches = _community_batches(_builder(cfg), seed=9)
        j = JG.GraphPartition(_cfg(JCfg, **kw))
        j.partition(batches[:4])
        t = TG.GraphPartition(cfg, device="cpu")
        t.load_state({k: np.asarray(v) for k, v in j.state.items()})
        t.examples = j.examples
        _equal_to_jax(t, t.partition(batches[4:]), j, j.partition(batches[4:]))
        with pytest.raises(ValueError, match="shape"):
            t.load_state({"presence": np.zeros((3, 4), np.float32),
                          "sizes": np.zeros(4, np.float32)})

    def test_communities_get_low_replication(self):
        cfg = _cfg(**{"graph.num_partitions": 2})
        out = TG.GraphPartition(cfg, device="cpu").partition(
            _community_batches(_builder(cfg)))
        assert out["replication"] < 1.2 and out["balance"] < 1.5, out
        assert out["examples"] == 512

    def test_beats_random_assignment(self):
        cfg = _cfg(**{"graph.num_partitions": 4})
        batches = _community_batches(_builder(cfg), seed=3)
        out = TG.GraphPartition(cfg, device="cpu").partition(batches)
        rng = np.random.default_rng(0)
        presence = np.zeros((cfg.data.num_keys, 4), np.float32)
        for b in batches:
            assign = rng.integers(0, 4, len(b.labels))
            onehot = np.eye(4, dtype=np.float32)[assign] * b.example_mask[:, None]
            votes = (b.values != 0).astype(np.float32)[:, None] * onehot[b.row_ids]
            np.add.at(presence, b.unique_keys[b.local_ids], votes)
        touched = presence.sum(axis=1) > 0
        random_rep = float((presence[touched] > 0).sum(axis=1).mean())
        assert out["replication"] < random_rep * 0.75, (out, random_rep)

    def test_balance_penalty_evens_sizes(self):
        cfg = _cfg(**{"graph.num_partitions": 4, "graph.balance_penalty": 10.0})
        builder = BatchBuilder(num_keys=cfg.data.num_keys, batch_size=16,
                               max_nnz_per_example=8)
        labels = np.zeros(64, np.float32)
        keys = [np.array([5, 6, 7], np.uint64)] * 64
        vals = [np.ones(3, np.float32)] * 64
        batches = [builder.build(labels[i:i + 16], keys[i:i + 16], vals[i:i + 16])
                   for i in range(0, 64, 16)]
        t, _, j, _ = _both(batches, **{"graph.num_partitions": 4,
                                       "graph.balance_penalty": 10.0})
        sizes = t.state_dict()["sizes"]
        assert sizes.max() - sizes.min() <= 17, sizes
        np.testing.assert_array_equal(sizes, np.asarray(j.state["sizes"]))

    def test_dump_and_feature_partition(self, tmp_path):
        cfg = _cfg(**{"graph.num_partitions": 2})
        batches = _community_batches(_builder(cfg), n_examples=128)
        t, _, j, _ = _both(batches, **{"graph.num_partitions": 2})
        home = t.feature_partition()
        assert home.shape == (cfg.data.num_keys,)
        assert (home >= -1).all() and (home < 2).all()
        n = t.dump_partition(str(tmp_path / "t.txt"))
        assert n == (home >= 0).sum() == j.dump_partition(str(tmp_path / "j.txt"))
        assert (tmp_path / "t.txt").read_text() == (tmp_path / "j.txt").read_text()

    def test_empty_state_metrics(self):
        st = TG.init_state(16, 3, "cpu")
        assert TG.partition_metrics(st) == JG.partition_metrics(JG.init_state(16, 3))


def _svm(tmp_path, name, n=200, features=300, nnz=6, seed=0, zipf_a=1.3):
    labels, keys, vals, _ = make_sparse_logistic(n, features, nnz_per_example=nnz,
                                                 seed=seed, zipf_a=zipf_a)
    f = tmp_path / name
    write_libsvm(f, labels, keys, vals)
    return f


def _run_both(tmp_path, cfg: dict, capsys, tag: str):
    """The JAX CLI and the port's on one config: their results and dumps."""
    p = tmp_path / f"{tag}.json"
    p.write_text(json.dumps(cfg))
    outs = {}
    for name, main, extra in (("jax", JC.main, []), ("port", TC.main, ["--device", "cpu"])):
        dump = tmp_path / f"{tag}_{name}.txt"
        capsys.readouterr()
        assert main(["train", "--app_file", str(p), "--model_out", str(dump), *extra]) == 0
        outs[name] = (json.loads(capsys.readouterr().out.strip().splitlines()[-1]),
                      dump.read_text())
    return outs


def test_cli_graph_partition_equals_jax(tmp_path, capsys):
    files = [str(_svm(tmp_path, "g0.svm")), str(_svm(tmp_path, "g1.svm", seed=1))]
    cfg = {"app": "graph_partition",
           "data": {"files": files, "num_keys": 8192, "max_nnz_per_example": 32},
           "solver": {"minibatch": 64}, "graph": {"num_partitions": 4},
           "parallel": {"data_shards": 2, "kv_shards": 2}}  # unread, as in JAX
    outs = _run_both(tmp_path, cfg, capsys, "g")
    assert outs["port"] == outs["jax"]
    assert outs["port"][0]["examples"] == 400 and outs["port"][1].strip()


def test_cli_sketch_equals_jax(tmp_path, capsys):
    files = [str(_svm(tmp_path, "s0.svm", n=300, features=200, nnz=8, zipf_a=1.2)),
             str(_svm(tmp_path, "s1.svm", n=250, features=200, nnz=8, seed=2))]
    cfg = {"app": "sketch", "data": {"files": files, "num_keys": 8192},
           "sketch": {"width": 4096, "min_count": 5}}
    outs = _run_both(tmp_path, cfg, capsys, "s")
    assert outs["port"] == outs["jax"]
    lines = outs["port"][1].strip().splitlines()
    counts = [int(line.split("\t")[1]) for line in lines]
    assert counts == sorted(counts, reverse=True) and min(counts) >= 5
    assert 0 in {int(line.split("\t")[0]) for line in lines}


class TestSketchApp:
    def _cfg(self, cls=PSConfig, **kw):
        cfg = cls()
        cfg.app = "sketch"
        cfg.sketch.width = 1 << 12
        cfg.sketch.min_count = 3
        for k, v in kw.items():
            setattr(cfg.sketch, k, v)
        return cfg

    def test_heavy_hitters_equal_jax(self, rng):
        t, j = TS.SketchApp(self._cfg()), JS.SketchApp(self._cfg(JCfg))
        hot = np.array([7, 7, 7, 7, 9, 9, 9], dtype=np.uint64)
        cold = rng.integers(100, 4000, 50).astype(np.uint64)
        for app in (t, j):
            app.add(np.concatenate([hot, cold]))
        keys, counts = t.heavy_hitters()
        d = dict(zip(keys.tolist(), counts.tolist()))
        assert d[7] == 4 and d[9] == 3
        for a, b in zip(t.heavy_hitters(), j.heavy_hitters()):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        assert t.result() == j.result()

    def test_merge_matches_single_sketch_and_jax(self, rng):
        streams = [rng.integers(0, 500, 400).astype(np.uint64) for _ in range(3)]
        apps = [TS.SketchApp(self._cfg()) for _ in streams]
        japps = [JS.SketchApp(self._cfg(JCfg)) for _ in streams]
        for a, ja, s in zip(apps, japps, streams):
            a.add(s)
            ja.add(s)
        merged = TS.merge_sketches([a.sketch for a in apps])
        whole = TS.SketchApp(self._cfg())
        whole.add(np.concatenate(streams))
        np.testing.assert_array_equal(merged.table, whole.sketch.table)
        np.testing.assert_array_equal(merged.table,
                                      JS.merge_sketches([a.sketch for a in japps]).table)
        assert merged.table.dtype == whole.sketch.table.dtype

    def test_merge_refusals(self):
        a = TS.SketchApp(self._cfg()).sketch
        b = TS.SketchApp(self._cfg(width=1 << 10)).sketch
        with pytest.raises(ValueError, match="differ"):
            TS.merge_sketches([a, b])
        with pytest.raises(ValueError, match="nothing"):
            TS.merge_sketches([])

    def test_sketch_has_the_methods_the_app_uses(self):
        s = TS.SketchApp(self._cfg(depth=3)).sketch
        for name in ("add", "admit", "count"):
            assert callable(getattr(s, name))
        assert (s.width, s.depth, s.table.shape) == (1 << 12, 3, (3, 1 << 12))


@pytest.mark.parametrize("fmt,slotless", [("libsvm", True), ("criteo", False)])
def test_iter_flat_rows_matches_jax_python_parser(tmp_path, fmt, slotless, monkeypatch):
    """The port's iter_flat_rows against the JAX function's Python-parser
    branch (its native parser switched off), chunk for chunk; ``slots`` is
    None for slotless formats."""
    from parameter_server_tpu.data import native as JN
    from parameter_server_tpu.data import reader as JR

    monkeypatch.setattr(JN, "native_available", lambda: False)
    if fmt == "libsvm":
        files = [str(_svm(tmp_path, "b.svm", n=90, seed=1)),
                 str(_svm(tmp_path, "a.svm", n=70, seed=2))]
    else:
        rng = np.random.default_rng(3)
        files = []
        for i in range(2):
            p = tmp_path / f"c{i}.txt"
            with open(p, "w") as f:
                for _ in range(40):
                    ints = "\t".join(str(x) for x in rng.integers(0, 50, 13))
                    cats = "\t".join(f"{x:08x}" for x in rng.integers(0, 2**31, 26))
                    f.write(f"{rng.integers(0, 2)}\t{ints}\t{cats}\n")
            files.append(str(p))
    assert TR.SLOTLESS_FORMATS == JN.SLOTLESS_FORMATS
    got, want = list(TR.iter_flat_rows(files, fmt)), list(JR.iter_flat_rows(files, fmt))
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        for a, b in zip(g, w):
            if b is None:
                assert a is None and slotless
            else:
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
        assert (g[4] is None) == slotless
