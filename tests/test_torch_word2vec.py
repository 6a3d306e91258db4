"""Port parity for the word2vec app (single-device), on the CPU.

The data side (negative sampler, window pairs, token blocks, vocabulary
counts, the streaming ``PairStream``) is host numpy copied from the JAX
package, so it must draw exactly the JAX package's batches. The SGNS step
scatter-adds one AdaGrad delta per occurrence of an id, as the JAX step
does; from a shared state one step (or one K-step group) agrees within
rtol 1e-5 / atol 1e-6 (the two add duplicates in different orders), and
an epoch's mean loss within rtol 1e-4. tests/test_apps.py's and
tests/test_checkpoint_cli.py's word2vec cases run here against the port,
on one device."""

import json
import threading

import numpy as np
import pytest
import torch

from parameter_server_tpu import cli as JC
from parameter_server_tpu.models import word2vec as JV
from parameter_server_tpu.parallel.workload import WorkloadPool as JPool
from parameter_server_tpu.utils.metrics import ProgressReporter as JR
from parameter_server_tpu_torch import cli as TC
from parameter_server_tpu_torch.models import word2vec as TV
from parameter_server_tpu_torch.ops import adagrad_kernels as ak
from parameter_server_tpu_torch.ops import ftrl_kernels as fk
from parameter_server_tpu_torch.parallel.mesh import Mesh
from parameter_server_tpu_torch.parallel.workload import WorkloadPool as TPool
from parameter_server_tpu_torch.utils.metrics import ProgressReporter as TR

torch.set_num_threads(1)

STEP_TOL = {"rtol": 1e-5, "atol": 1e-6}


def quiet(cls=TR):
    return cls(print_fn=lambda *a: None)


def _apps(vocab=50, **kw):
    kw = {"dim": 8, "num_negatives": 3, "eta": 0.3, **kw}
    return (JV.Word2Vec(vocab, reporter=quiet(JR), **kw),
            TV.Word2Vec(vocab, reporter=quiet(), device="cpu", **kw))


def _topic_corpus(n_chunks=600, seed=0):
    """tests/test_apps.py's two-topic corpus: words 0-4 co-occur, 5-9 co-occur."""
    rng = np.random.default_rng(seed)
    chunks = []
    for _ in range(n_chunks):
        topic = rng.integers(0, 2)
        chunks.append(rng.integers(0, 5, size=8) + 5 * topic)
    return np.concatenate(chunks)


def _zipf_corpus(n=6000, vocab=200, seed=0):
    """Zipf-distributed ids: hot ids repeat within a batch, yet over a
    vocabulary wide enough that SGNS stays stable at eta 0.05 and batch
    256. On the two-topic corpus every batch holds each of its 10 words
    dozens of times, the summed per-occurrence steps overshoot, and runs
    of the two packages drift apart chaotically."""
    return np.minimum(np.random.default_rng(seed).zipf(1.3, n) - 1, vocab - 1)


STABLE = {"vocab": 200, "dim": 16, "num_negatives": 4, "eta": 0.05}


def _same_dict(a: dict, b: dict):
    assert set(a) == set(b)
    for k in b:
        assert a[k].dtype == b[k].dtype, k
        np.testing.assert_array_equal(a[k], b[k], err_msg=k)


def _assert_tables(t, j, tol):
    st = t.state_dict()
    for name, jst in (("in", j.in_state), ("out", j.out_state)):
        assert set(st[name]) == set(jst) == {"w", "n"}
        for k in jst:
            np.testing.assert_allclose(st[name][k], np.asarray(jst[k]), **tol,
                                       err_msg=f"{name}[{k}]")


# --- the data side: exactly the JAX package's ----------------------------------


def test_sampler_and_pairs_equal_jax():
    counts = np.array([100, 10, 1, 0, 7, 7])
    for seed in (0, 3):
        t, j = TV.NegativeSampler(counts, seed=seed), JV.NegativeSampler(counts, seed=seed)
        np.testing.assert_array_equal(t.p, j.p)
        for shape in ((5,), (64, 5), (1000,)):
            np.testing.assert_array_equal(t.sample(shape), j.sample(shape))
    assert np.bincount(t.sample(20000), minlength=6)[3] == 0  # a zero count is never drawn
    corpus = np.random.default_rng(1).integers(0, 50, 500)
    for window in (1, 2, 3):
        for skip in (0, 2, 5):
            for a, b in zip(TV._window_pairs(corpus, window, skip),
                            JV._window_pairs(corpus, window, skip)):
                np.testing.assert_array_equal(a, b)
        j, t = _apps(window=window)
        for a, b in zip(t.make_pairs(corpus), j.make_pairs(corpus)):
            np.testing.assert_array_equal(a, b)
        ref = sorted(zip(*(x.tolist() for x in t.make_pairs(corpus))))
        assert sorted(zip(*(x.tolist() for x in TV._window_pairs(corpus, window)))) == ref
    for a, b in zip(TV._window_pairs(corpus[:1], 2), JV._window_pairs(corpus[:1], 2)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("suffix", [".txt", ".npy"])
def test_token_blocks_and_counts_equal_jax(tmp_path, suffix):
    corpus = np.random.default_rng(2).integers(0, 300, 12345)
    path = tmp_path / f"corpus{suffix}"
    if suffix == ".npy":
        np.save(path, corpus)
    else:
        # mixed separators and a trailing token with no newline
        path.write_text("\n".join(" ".join(map(str, corpus[i:i + 97]))
                                  for i in range(0, len(corpus), 97)).replace(" 1", "\t1"))
    for block in (100, 4096, 1 << 20):
        got = list(TV.iter_token_blocks(str(path), block))
        want = list(JV.iter_token_blocks(str(path), block))
        assert len(got) == len(want)
        for a, b in zip(got, want):
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(np.concatenate(got), corpus)
    np.testing.assert_array_equal(TV.count_vocab([str(path)], 300, 1000),
                                  JV.count_vocab([str(path)], 300, 1000))
    for mod in (TV, JV):
        with pytest.raises(ValueError, match="outside"):
            mod.count_vocab([str(path)], 299, 1000)


def _streamed(mod, pool, corpus, path, **kw):
    s = mod.PairStream(0, pool, window=3, batch_size=64, num_negatives=2,
                       sampler=mod.NegativeSampler(np.bincount(corpus, minlength=30), seed=0),
                       block_tokens=100, seed=4, **kw)
    out = []
    while (b := s.next_batch()) is not None:
        out.append(b)
    return out, s


def test_pair_stream_and_pool_equal_jax(tmp_path):
    """PairStream over the port's WorkloadPool yields JAX's batches exactly
    (file-spanning blocks, the carry, the block shuffle), covers every
    window pair once, and leaves the pool in JAX's state."""
    rng = np.random.default_rng(3)
    corpus = rng.integers(0, 30, 997)  # deliberately not block-aligned
    paths = []
    for i, part in enumerate((corpus[:400], corpus[400:])):
        p = tmp_path / f"part{i}.txt"
        p.write_text(" ".join(map(str, part)))
        paths.append(str(p))
    tpool, jpool = TPool(paths), JPool(paths)
    got, ts = _streamed(TV, tpool, corpus, paths)
    want, js = _streamed(JV, jpool, corpus, paths)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        _same_dict(a, b)
    assert ts.max_buffered == js.max_buffered
    _same_dict(ts._empty(), js._empty())
    pairs = sorted(p for b in got for p in zip(b["center"][b["mask"] > 0].tolist(),
                                                b["context"][b["mask"] > 0].tolist()))
    ref = []
    for part in (corpus[:400], corpus[400:]):  # windows never span files
        ref += list(zip(*(x.tolist() for x in JV._window_pairs(part, 3))))
    assert pairs == sorted(ref)
    assert tpool.all_done and jpool.all_done
    js_stats = jpool.stats()
    assert tpool.stats() == js_stats


def test_group_microbatches_equal_jax():
    rng = np.random.default_rng(5)
    items = [{"center": rng.integers(0, 9, 6).astype(np.int32),
              "context": rng.integers(0, 9, 6).astype(np.int32),
              "negatives": rng.integers(0, 9, (6, 2)).astype(np.int32)} for _ in range(2)]
    masked = [dict(b, mask=rng.random(6).astype(np.float32)) for b in items]
    for group in (items, masked):
        for k_steps in (2, 4):
            _same_dict(TV._group_microbatches(group, k_steps),
                       JV._group_microbatches(group, k_steps, 0))


# --- the step --------------------------------------------------------------------


def _step_batches(rng, vocab, bs, k_neg, n):
    """Zipf ids over a small vocabulary: many duplicates in a batch, hot ids
    as center, context and negative at once; a mask with zeros."""
    out = []
    for _ in range(n):
        b = {"center": np.minimum(rng.zipf(1.3, bs) - 1, vocab - 1).astype(np.int32),
             "context": np.minimum(rng.zipf(1.3, bs) - 1, vocab - 1).astype(np.int32),
             "negatives": rng.integers(0, vocab, (bs, k_neg)).astype(np.int32),
             "mask": (rng.random(bs) < 0.8).astype(np.float32)}
        out.append(b)
    return out


def _load_jax_tables(t, j):
    t.load_state({k: np.asarray(v) for k, v in j.in_state.items()},
                 {k: np.asarray(v) for k, v in j.out_state.items()})


def test_step_and_group_match_jax_with_duplicates():
    """From a shared state: single steps against ``sgns_train_step`` and a
    3-step group against ``sgns_train_multistep``, on batches whose ids
    repeat (each occurrence pushes its own delta) and whose mask has
    zeros. No kernel launches on the CPU."""
    rng = np.random.default_rng(6)
    j, t = _apps(vocab=40, seed=2)
    j.train_epoch(rng.integers(0, 40, 2000), batch_size=256)  # nonzero out table
    batches = _step_batches(rng, 40, 128, 3, 5)
    assert len(np.unique(batches[0]["center"])) < 64  # duplicates
    fk.reset_launches()
    ak.reset_launches()
    for b in batches[:2]:
        _load_jax_tables(t, j)
        j.in_state, j.out_state, jloss = JV.sgns_train_step(
            j.in_up, j.out_up, j.in_state, j.out_state, {k: np.asarray(v) for k, v in b.items()})
        tloss = TV.sgns_train_step(t.in_up, t.out_up, t.in_state, t.out_state,
                                   {k: torch.from_numpy(v) for k, v in b.items()})
        np.testing.assert_allclose(float(tloss), float(jloss), **STEP_TOL)
        _assert_tables(t, j, STEP_TOL)
    _load_jax_tables(t, j)
    grouped = JV._group_microbatches(batches[2:], 4, 0)  # 3 steps + 1 inert pad
    j.in_state, j.out_state, jloss = JV.sgns_train_multistep(
        j.in_up, j.out_up, j.in_state, j.out_state, grouped)
    tloss = t._dispatch_prepared(TV._group_microbatches(batches[2:], 4), 4)
    np.testing.assert_allclose(float(tloss), float(jloss), **STEP_TOL)
    _assert_tables(t, j, STEP_TOL)
    assert fk.LAUNCHES == {"ftrl_delta": 0, "ftrl_push": 0}
    assert ak.LAUNCHES == {"adagrad_push": 0}


@pytest.mark.parametrize("steps_per_call,max_delay", [(1, 0), (3, 2)])
def test_train_epoch_matches_jax(steps_per_call, max_delay):
    corpus = _zipf_corpus(seed=1)
    j, t = _apps(**STABLE, steps_per_call=steps_per_call, max_delay=max_delay)
    for ep in range(2):
        np.testing.assert_allclose(t.train_epoch(corpus, batch_size=256, seed=ep),
                                   j.train_epoch(corpus, batch_size=256, seed=ep), rtol=1e-4)
    assert t.reporter.history[-1]["examples"] == j.reporter.history[-1]["examples"]
    np.testing.assert_allclose(t.embeddings(), j.embeddings(), rtol=1e-4, atol=1e-5)
    assert t.similarity(0, 1) == pytest.approx(j.similarity(0, 1), rel=1e-4, abs=1e-5)


def test_learns_cooccurrence_structure():
    """tests/test_apps.py's topic-structure case on the port."""
    corpus = _topic_corpus()
    w2v = TV.Word2Vec(vocab_size=10, dim=16, eta=0.5, num_negatives=4, window=2,
                      reporter=quiet(), device="cpu")
    losses = [w2v.train_epoch(corpus, batch_size=2048, seed=ep) for ep in range(8)]
    assert losses[-1] < losses[0]
    within = np.mean([w2v.similarity(0, i) for i in range(1, 5)])
    across = np.mean([w2v.similarity(0, i) for i in range(5, 10)])
    assert within > across + 0.3, (within, across)


@pytest.mark.parametrize("steps_per_call", [1, 3])
def test_train_files_matches_jax(tmp_path, steps_per_call):
    """Streaming from token files: pipeline_depth 0 against the JAX app's
    pipeline_depth 0; the port's pipeline (depth 2: builder and stacker
    threads) gives the same loss as its serial path and joins its threads."""
    corpus = _zipf_corpus(seed=2)
    paths = []
    for i, part in enumerate(np.array_split(corpus, 2)):
        p = tmp_path / f"part{i}.txt"
        p.write_text(" ".join(map(str, part)))
        paths.append(str(p))
    kw = {**STABLE, "steps_per_call": steps_per_call, "max_delay": 1}
    j, t = _apps(**kw)
    fkw = {"batch_size": 256, "epochs": 2, "block_tokens": 1000, "seed": 3}
    want = j.train_files(paths, pipeline_depth=0, **fkw)
    got = t.train_files(paths, pipeline_depth=0, **fkw)
    np.testing.assert_allclose(got, want, rtol=1e-4)
    n_pairs = 2 * sum(2 * (2 * len(part) - 3) for part in np.array_split(corpus, 2))
    assert t.reporter.history[-1]["examples"] == j.reporter.history[-1]["examples"] == n_pairs
    _assert_tables(t, j, {"rtol": 1e-4, "atol": 1e-5})
    before = threading.active_count()
    _, piped = _apps(**kw)
    np.testing.assert_allclose(piped.train_files(paths, pipeline_depth=2, **fkw), got,
                               rtol=1e-6)
    assert piped.reporter.history[-1]["examples"] == n_pairs
    assert threading.active_count() == before


def test_pipeline_surfaces_a_builder_error(tmp_path):
    p = tmp_path / "bad.txt"
    p.write_text("1 2 3 x 4\n")
    w2v = TV.Word2Vec(10, dim=4, reporter=quiet(), device="cpu")
    before = threading.active_count()
    with pytest.raises(ValueError):
        w2v.train_files([str(p)], counts=np.ones(10), pipeline_depth=2)
    assert threading.active_count() == before


def test_state_dict_round_trip_and_checks():
    j, t = _apps(vocab=20, seed=4)
    for name, jst in (("in", j.in_state), ("out", j.out_state)):
        for k in jst:  # the initial tables, bit for bit
            np.testing.assert_array_equal(t.state_dict()[name][k], np.asarray(jst[k]))
    st = t.state_dict()
    st["out"]["w"][2] = 5.0
    t.load_state(st["in"], st["out"])
    assert t.out_state["w"][2, 0].item() == 5.0
    with pytest.raises(ValueError, match="does not match"):
        t.load_state({"w": st["in"]["w"]}, st["out"])
    with pytest.raises(ValueError, match="does not match"):
        t.load_state(st["in"], {"w": st["out"]["w"][:3], "n": st["out"]["n"]})


@pytest.mark.parametrize("kw,match", [
    # the JAX app refuses a quantized push on a mesh (a mesh cell without
    # process groups: the refusal comes first)
    ({"mesh": Mesh(data=1, kv=1, d=0, k=0, device=torch.device("cpu")),
      "push_mode": "quantized"}, "unknown push_mode"),
    ({"steps_per_call": 0}, "steps_per_call"),
])
def test_unported_and_bad_options_raise(kw, match):
    with pytest.raises((NotImplementedError, ValueError), match=match):
        TV.Word2Vec(16, device="cpu", **kw)


# --- the CLI ------------------------------------------------------------------


def _cli_run(tmp_path, capsys, main, name, w2v, corpus, extra=()):
    cp = tmp_path / "corpus.txt"
    cp.write_text(" ".join(map(str, corpus)))
    cfg = {"app": "word2vec", "data": {"files": [str(cp)]}, "w2v": w2v,
           "solver": {"epochs": 6, "max_delay": 1, "steps_per_call": 2}}
    p = tmp_path / f"{name}.json"
    p.write_text(json.dumps(cfg))
    emb = tmp_path / f"{name}.npy"
    assert main(["train", "--app_file", str(p), "--model_out", str(emb), *extra]) == 0
    out = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    return out, np.load(emb)


def test_cli_train_word2vec(tmp_path, capsys):
    """tests/test_checkpoint_cli.py's word2vec case on one device: topic
    structure in the dumped embeddings."""
    w2v = {"vocab_size": 16, "dim": 16, "window": 2, "negatives": 4, "eta": 0.5,
           "batch_size": 1024, "block_tokens": 2048}
    out, E = _cli_run(tmp_path, capsys, TC.main, "topics", w2v, _topic_corpus(n_chunks=500),
                      ["--device", "cpu"])
    assert np.isfinite(out["mean_loss"]) and out["vocab_size"] == 16 and out["dim"] == 16
    assert E.shape == (16, 16)

    def sim(a, b):
        return E[a] @ E[b] / (np.linalg.norm(E[a]) * np.linalg.norm(E[b]))

    within = np.mean([sim(0, i) for i in range(1, 5)])
    across = np.mean([sim(0, i) for i in range(5, 10)])
    assert within > across, (within, across)


def test_cli_train_word2vec_matches_jax(tmp_path, capsys):
    w2v = {"vocab_size": 200, "dim": 16, "window": 2, "negatives": 4, "eta": 0.05,
           "batch_size": 256, "block_tokens": 2048}
    corpus = _zipf_corpus(seed=3)
    out, E = _cli_run(tmp_path, capsys, TC.main, "torch", w2v, corpus, ["--device", "cpu"])
    jout, jE = _cli_run(tmp_path, capsys, JC.main, "jax", w2v, corpus)
    np.testing.assert_allclose(out["mean_loss"], jout["mean_loss"], rtol=1e-4)
    np.testing.assert_allclose(E, jE, rtol=1e-4, atol=1e-5)


def test_cli_word2vec_refuses_a_mesh(tmp_path):
    """A quantized push on a mesh, which the JAX app refuses; the port's
    rank refuses it before it joins a world."""
    app_file = tmp_path / "cfg.json"
    app_file.write_text(json.dumps({"app": "word2vec", "data": {"files": ["x"]},
                                    "parallel": {"data_shards": 2, "kv_shards": 2,
                                                 "push_mode": "quantized"}}))
    with pytest.raises(ValueError, match="unknown push_mode 'quantized'"):
        TC.main(["train", "--app_file", str(app_file), "--device", "cpu"])
