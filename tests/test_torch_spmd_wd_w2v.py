"""Port parity for the Wide&Deep and word2vec mesh paths.

The port runs as a gloo world of CPU rank processes (``tests/_torch_rank.py``,
one a mesh cell, a time limit each), the JAX package's ``WideDeep(mesh=...)``
and ``Word2Vec(mesh=...)`` on a mesh of the same shape of the 8-device CPU
mesh here. Both start from the same tables (the JAX apps' seeded draws) and
read the same batch streams. Runs agree within rtol 1e-4 (RUN_TOL): XLA's
segment sums and torch's ``index_add_`` add in different orders, and
``torch.optim.Adam`` rounds its bias correction differently from optax
(tests/test_torch_wide_deep.py). The quantized push cannot reproduce
``jax.random``'s uniforms, so it is held by statistics and the rounding
audit, as tests/test_spmd_apps.py holds the JAX push. word2vec runs at
eta 0.05 (tests/test_torch_word2vec.py says why)."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch
from _torch_world import RANK_SCRIPT, rank_argvs, run_world

from parameter_server_tpu import cli as JC
from parameter_server_tpu.data.batch import BatchBuilder as JBB
from parameter_server_tpu.data.synthetic import make_sparse_logistic
from parameter_server_tpu.models import wide_deep as JW
from parameter_server_tpu.models import word2vec as JV
from parameter_server_tpu.parallel import make_mesh as j_make_mesh
from parameter_server_tpu.utils.metrics import ProgressReporter as JR
from parameter_server_tpu_torch.data.synthetic import write_libsvm
from parameter_server_tpu_torch.models import metrics as M
from parameter_server_tpu_torch.models import wide_deep as TW
from parameter_server_tpu_torch.models import word2vec as TV
from parameter_server_tpu_torch.parallel.mesh import Mesh
from parameter_server_tpu_torch.utils.metrics import ProgressReporter as TR

torch.set_num_threads(1)

RUN_TOL = {"rtol": 1e-4, "atol": 1e-5}
MESHES = [(2, 2), (1, 2), (2, 1)]
CSR_FIELDS = ("unique_keys", "local_ids", "row_ids", "values", "labels", "example_mask",
              "row_splits")
WD_KW = {"emb_dim": 8, "hidden": [16, 8], "emb_eta": 0.05, "mlp_lr": 1e-2, "seed": 1}
XOR_KW = {"emb_dim": 8, "hidden": [16], "mlp_lr": 5e-3, "seed": 0}
W2V_KW = {"dim": 8, "num_negatives": 3, "eta": 0.05, "window": 2, "seed": 0}
W2V_VOCAB, W2V_BATCH = 64, 32


def _quiet(cls=JR):
    return cls(print_fn=lambda *_: None)


def _wd_stream(n: int, bs: int, seed: int, num_keys: int = 1024, **kw) -> list:
    labels, keys, vals, _ = make_sparse_logistic(n * bs, 3000, nnz_per_example=10, seed=seed)
    b = JBB(num_keys=num_keys, batch_size=bs, max_nnz_per_example=40, **kw)
    return [b.build(labels[i:i + bs], keys[i:i + bs], vals[i:i + bs])
            for i in range(0, n * bs, bs)]


def _xor_stream(n=2048, bs=256, seed=0) -> list:
    """tests/test_spmd_apps.py's XOR batches: invisible to a linear model
    (here with 4 entry slots an example, not 256: the pads are inert)."""
    rng = np.random.default_rng(seed)
    a, b = rng.integers(0, 2, n), rng.integers(0, 2, n)
    y = (a ^ b).astype(np.float32)
    keys = [np.array([ai, 2 + bi], dtype=np.uint64) for ai, bi in zip(a, b)]
    vals = [np.ones(2, dtype=np.float32)] * n
    builder = JBB(num_keys=64, batch_size=bs, max_nnz_per_example=4, key_mode="identity")
    return [builder.build(y[i:i + bs], keys[i:i + bs], vals[i:i + bs])
            for i in range(0, n, bs)]


STREAMS = {
    "s8": lambda: _wd_stream(8, 128, seed=3),
    "s7": lambda: _wd_stream(7, 128, seed=5),
    "xor": _xor_stream,
}
WD_CASES = [
    {"name": "pw", "push_mode": "per_worker", "stream": "s8", "num_keys": 1024, "kw": WD_KW,
     "dump": True},
    {"name": "agg", "push_mode": "aggregate", "stream": "s8", "num_keys": 1024, "kw": WD_KW},
    # 7 batches, 3 steps a call: the last call's first microstep is real
    # on shard 0 only (on 2 data shards), its other two inert everywhere
    {"name": "ms", "push_mode": "per_worker", "stream": "s7", "num_keys": 1024,
     "kw": {**WD_KW, "steps_per_call": 3, "max_delay": 1}, "only": (2, 2)},
    # tests/test_spmd_apps.py's quantized criterion: 40 epochs of XOR, 2
    # steps a call, beside per_worker (2x2, as the JAX test), port only
    {"name": "xor_pw", "push_mode": "per_worker", "stream": "xor", "num_keys": 64,
     "kw": {**XOR_KW, "steps_per_call": 2}, "epochs": 40, "report_every": 10**6,
     "predict": 8, "only": (2, 2), "jax": False},
    {"name": "xor_q", "push_mode": "quantized", "stream": "xor", "num_keys": 64,
     "kw": {**XOR_KW, "steps_per_call": 2}, "epochs": 40, "report_every": 10**6,
     "predict": 8, "only": (2, 2), "jax": False},
]
for _c in WD_CASES:
    _c["kw"] = {**_c["kw"], "push_mode": _c["push_mode"]}
WD_COMPARED = [c["name"] for c in WD_CASES if c.get("jax", True)]


def _zipf_ids(n: int, seed: int) -> np.ndarray:
    """Zipf ids over W2V_VOCAB words: hot ids repeat inside a batch and
    across data shards."""
    return np.minimum(np.random.default_rng(seed).zipf(1.3, n) - 1, W2V_VOCAB - 1)


W2V_CASES = [
    {"name": "pw", "push_mode": "per_worker", "epochs": 2},
    {"name": "agg", "push_mode": "aggregate", "epochs": 2},
    # 3 steps a call: the epoch's last call is partial
    {"name": "ms", "push_mode": "per_worker", "epochs": 1, "steps_per_call": 3,
     "only": ((2, 2),)},
    # train_files on unequal files, one a data shard: the shorter shard
    # drains first and feeds inert batches
    {"name": "files", "push_mode": "per_worker", "files": True, "only": ((2, 2), (2, 1))},
]
W2V_BLOCK = 64
W2V_FILE_TOKENS = (400, 150)  # ~50 and ~18 batches of pairs


def _w2v_kw(case) -> dict:
    return {**W2V_KW, "push_mode": case["push_mode"],
            "steps_per_call": case.get("steps_per_call", 1), "max_delay": 1}


def _pack(stream: list, key: str) -> dict:
    out = {}
    for i, b in enumerate(stream):
        for f in (*CSR_FIELDS, "num_examples", "num_unique", "num_entries"):
            out[f"{key}/b{i}/{f}"] = np.asarray(getattr(b, f))
    return out


def _jax_wd(case, mesh, stream) -> dict:
    app = JW.WideDeep(case["num_keys"], mesh=mesh, reporter=_quiet(), **case["kw"])
    app.train(stream, report_every=1)
    y, p = app.predict(stream[:2])
    return {"hist": app.reporter.history, "y": y, "p": p, "push_calls": app._push_calls,
            "wide": {k: np.asarray(v) for k, v in app.wide_state.items()},
            "emb": {k: np.asarray(v) for k, v in app.emb_state.items()},
            "mlp": [{k: np.asarray(v) for k, v in layer.items()} for layer in app.mlp_params],
            "app": app}


def _jax_w2v(case, mesh, corpus, files) -> dict:
    app = JV.Word2Vec(W2V_VOCAB, mesh=mesh, reporter=_quiet(), **_w2v_kw(case))
    if case.get("files"):
        losses = [app.train_files(files, batch_size=W2V_BATCH, block_tokens=W2V_BLOCK,
                                  seed=0, pipeline_depth=0)]
    else:
        losses = [app.train_epoch(corpus, batch_size=W2V_BATCH, seed=ep)
                  for ep in range(case["epochs"])]
    return {"loss": np.array(losses),
            "in": {k: np.asarray(v)[:W2V_VOCAB] for k, v in app.in_state.items()},
            "out": {k: np.asarray(v)[:W2V_VOCAB] for k, v in app.out_state.items()},
            "pairs": app.reporter.history[-1]["examples"], "emb": app.embeddings()}


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    """The batch streams, the corpus and the corpus files of every case."""
    tmp = tmp_path_factory.mktemp("wdw2v")
    streams = {k: make() for k, make in STREAMS.items()}
    corpus = _zipf_ids(400, seed=1)
    files = []
    for i, n in enumerate(W2V_FILE_TOKENS):
        files.append(str(tmp / f"corpus{i}.txt"))
        (tmp / f"corpus{i}.txt").write_text(" ".join(map(str, _zipf_ids(n, seed=10 + i))))
    arrays = {"corpus": corpus}
    for key, stream in streams.items():
        arrays.update(_pack(stream, key))
    np.savez(tmp / "inputs.npz", **arrays)
    return {"tmp": tmp, "streams": streams, "corpus": corpus, "files": files}


def _port_world(data, shape) -> Path:
    """The port's world of one mesh shape (its rank processes run alone:
    the suite's latency-gated tests share the machine); returns the
    directory of its ranks' results."""
    d, kv = shape
    tmp = data["tmp"] / f"{d}x{kv}"
    tmp.mkdir()
    wd_cases = [c for c in WD_CASES if c.get("only", shape) == shape]
    w2v_cases = [{"name": c["name"], "vocab": W2V_VOCAB, "kw": _w2v_kw(c),
                  "corpus": "corpus", "batch_size": W2V_BATCH, "seed": 0,
                  "epochs": c.get("epochs", 1), "block_tokens": W2V_BLOCK,
                  **({"files": data["files"]} if c.get("files") else {})}
                 for c in W2V_CASES if shape in c.get("only", (shape,))]
    plan = tmp / "plan.json"
    plan.write_text(json.dumps({"mesh": [d, kv], "inputs": str(data["tmp"] / "inputs.npz"),
                                "wd_cases": wd_cases, "w2v_cases": w2v_cases,
                                "out": str(tmp)}))
    run_world(rank_argvs("wd+w2v", plan, d * kv))
    return tmp


@pytest.fixture(scope="module", params=MESHES, ids=lambda m: f"{m[0]}x{m[1]}")
def world(request, data):
    d, kv = shape = request.param
    tmp = _port_world(data, shape)
    mesh = j_make_mesh(d, kv)
    jax_wd = {c["name"]: _jax_wd(c, mesh, data["streams"][c["stream"]]) for c in WD_CASES
              if c["name"] in WD_COMPARED and c.get("only", shape) == shape}
    jax_w2v = {c["name"]: _jax_w2v(c, mesh, data["corpus"], data["files"]) for c in W2V_CASES
               if shape in c.get("only", (shape,))}
    ranks = [dict(np.load(tmp / f"rank{r}.npz")) for r in range(d * kv)]
    return {"shape": shape, "tmp": tmp, "ranks": ranks, "wd": jax_wd, "w2v": jax_w2v,
            "streams": data["streams"]}


def _ran(world, name: str) -> None:
    if f"{name}/hist_objv" not in world["ranks"][0]:
        pytest.skip(f"case {name} runs on the 2x2 mesh")


# --- Wide&Deep ----------------------------------------------------------------


@pytest.mark.parametrize("name", WD_COMPARED)
def test_wd_mesh_matches_jax(world, name):
    """Every progress row (examples, objv, AUC over every data shard), the
    final z, n, w, n and MLP on every rank, and the probabilities of a
    predict pulled through the kv group, at RUN_TOL."""
    _ran(world, name)
    j = world["wd"][name]
    for r, res in enumerate(world["ranks"]):
        assert len(res[f"{name}/hist_objv"]) == len(j["hist"])
        np.testing.assert_array_equal(res[f"{name}/hist_examples"],
                                      [row["examples"] for row in j["hist"]])
        for col in ("objv", "auc"):
            np.testing.assert_allclose(res[f"{name}/hist_{col}"],
                                       [row[col] for row in j["hist"]], **RUN_TOL,
                                       err_msg=f"rank {r} {col}")
        for table in ("wide", "emb"):
            for k, v in j[table].items():
                np.testing.assert_allclose(res[f"{name}/{table}/{k}"], v, **RUN_TOL,
                                           err_msg=f"rank {r} {table}[{k}]")
        for i, layer in enumerate(j["mlp"]):
            for k, v in layer.items():
                np.testing.assert_allclose(res[f"{name}/mlp{i}/{k}"], v, **RUN_TOL)
        np.testing.assert_array_equal(res[f"{name}/predict_y"], j["y"])
        np.testing.assert_allclose(res[f"{name}/predict_p"], j["p"], **RUN_TOL)
        assert res[f"{name}/push_calls"] == j["push_calls"]


@pytest.mark.parametrize("name", [c["name"] for c in WD_CASES])
def test_wd_mlp_replicas_bitwise_equal(world, name):
    """The MLP and Adam's state of every rank, bit for bit: every replica
    takes the same summed gradient."""
    _ran(world, name)
    ranks = world["ranks"]
    keys = [k for k in ranks[0] if k.startswith((f"{name}/mlp", f"{name}/adam"))]
    assert any("/adam" in k for k in keys) and any("/mlp" in k for k in keys)
    for res in ranks[1:]:
        for k in keys:
            np.testing.assert_array_equal(res[k], ranks[0][k], err_msg=k)


def test_wd_mesh_pushes_the_real_prefix(world):
    """Every per-worker push (K1 for the wide table, K3 for the
    embeddings; here their plain versions) carries the microstep's
    largest ``num_unique`` slots, D pushes a step on every kv rank; the
    JAX step pushes every slot of the unique-key array, and the tables
    match it (test_wd_mesh_matches_jax[pw])."""
    d, _ = world["shape"]
    stream = world["streams"]["s8"]
    want = [max(b.num_unique for b in stream[s:s + d]) for s in range(0, len(stream), d)]
    assert max(want) < min(len(b.unique_keys) for b in stream)
    for res in world["ranks"]:
        for k in ("ftrl_push", "adagrad_push"):
            np.testing.assert_array_equal(res[f"pw/slots_{k}"], np.repeat(want, d))


def test_wd_multistep_partial_group(world):
    """7 batches, 3 steps a call: on 2 data shards the second call holds
    one real batch and 5 inert ones; the seed base still advances a call."""
    _ran(world, "ms")
    d, _ = world["shape"]
    for res in world["ranks"]:
        assert res["ms/push_calls"] == -(-7 // (3 * d))
        assert res["ms/hist_examples"][-1] == 7 * 128
        # inert microsteps push nothing; real ones push D times a table
        assert len(res["ms/slots_ftrl_push"]) == d * -(-7 // d)


def test_wd_quantized_tracks_per_worker_on_xor(world):
    """tests/test_spmd_apps.py's criterion on the port: the int8 push on
    both tables reaches XOR's solution (AUC > 0.9, within 0.05 of
    per_worker's); each call advances the seed base; every rank's audit
    holds every push (2 tables x D = 2 a microstep) to the rounding
    bounds."""
    _ran(world, "xor_q")
    for res in world["ranks"]:
        aucs = {n: M.auc(res[f"{n}/predict_y"], res[f"{n}/predict_p"])
                for n in ("xor_pw", "xor_q")}
        assert aucs["xor_q"] > 0.9, aucs
        assert abs(aucs["xor_q"] - aucs["xor_pw"]) < 0.05, aucs
        assert res["xor_q/push_calls"] == 40 * 8 // (2 * 2)
        pushes, off_grid, mismatch = res["xor_q/audit"]
        assert pushes == 40 * 4 * 2 and off_grid == 0 and mismatch == 0


def test_wd_mesh_dump_evaluates_in_both_packages(world, tmp_path):
    """Rank 0's npz dump, read by both packages' ``evaluate_dump``, gives
    the JAX app's own dump's AUC and logloss."""
    path = world["tmp"] / "pw.npz"
    data = tmp_path / "val.svm"
    labels, keys, vals, _ = make_sparse_logistic(512, 3000, nnz_per_example=10, seed=9)
    write_libsvm(data, labels, keys, vals)
    mk = {"num_keys": 1024, "batch_size": 128, "max_nnz_per_example": 40}
    from parameter_server_tpu_torch.data.batch import BatchBuilder

    jpath = tmp_path / "jax.npz"
    world["wd"]["pw"]["app"].dump_model(str(jpath))
    own = JW.evaluate_dump(str(jpath), [str(data)], "libsvm", JBB(**mk))
    got = {"jax": JW.evaluate_dump(str(path), [str(data)], "libsvm", JBB(**mk)),
           "torch": TW.evaluate_dump(str(path), [str(data)], "libsvm", BatchBuilder(**mk),
                                     device="cpu")}
    for ev in got.values():
        assert ev["examples"] == own["examples"] == 512
        np.testing.assert_allclose(ev["auc"], own["auc"], rtol=1e-4)
        np.testing.assert_allclose(ev["logloss"], own["logloss"], rtol=1e-4)
    with np.load(path) as t, np.load(jpath) as j:
        assert sorted(t.files) == sorted(j.files)
        for k in j.files:
            np.testing.assert_allclose(t[k], j[k], **RUN_TOL, err_msg=k)


# --- word2vec -----------------------------------------------------------------


@pytest.mark.parametrize("name", [c["name"] for c in W2V_CASES])
def test_w2v_mesh_matches_jax(world, name):
    """The epochs' (or the streamed run's) mean losses and both tables on
    every rank, at RUN_TOL; ``embeddings()`` is the JAX app's kv-padded
    table."""
    if name not in world["w2v"]:
        pytest.skip(f"case {name} runs on another mesh")
    j = world["w2v"][name]
    for r, res in enumerate(world["ranks"]):
        np.testing.assert_allclose(res[f"{name}/loss"], j["loss"], **RUN_TOL)
        for table in ("in", "out"):
            for k, v in j[table].items():
                np.testing.assert_allclose(res[f"{name}/{table}/{k}"], v, **RUN_TOL,
                                           err_msg=f"rank {r} {table}[{k}]")
        np.testing.assert_allclose(res[f"{name}/embeddings"], j["emb"], **RUN_TOL)
        if name == "files":
            assert res["files/pairs"] == j["pairs"]


def test_w2v_mesh_takes_the_repeated_ids_route(world):
    """Batches repeat ids inside a shard and across shards; the per-worker
    push goes gather -> delta -> ``index_add_`` (``unique=False``) and no
    fused push (K1, K3) runs in any word2vec case."""
    corpus = _zipf_ids(400, seed=1)
    assert np.bincount(corpus[:W2V_BATCH]).max() > 2
    for res in world["ranks"]:
        assert res["w2v_fused_pushes"] == 0


def test_w2v_files_drain_unequal_shards(world):
    """The streamed run counts every pair of both files, once."""
    if "files" not in world["w2v"]:
        pytest.skip("the drained contract needs two data shards")
    corpus = [_zipf_ids(n, seed=10 + i) for i, n in enumerate(W2V_FILE_TOKENS)]
    want = sum(4 * len(c) - 2 * (1 + 2) for c in corpus)  # window 2, per file
    for res in world["ranks"]:
        assert res["files/pairs"] == want


@pytest.mark.parametrize("shards,shape", [(2, (32, 3)), (3, (5,)), (1, (4, 4))])
def test_w2v_one_draw_for_all_shards(shards, shape):
    """One ``random((D, *shape))`` draw equals D draws of ``shape`` in
    order: ``sample_shard`` keeps the sampler on the JAX loop's stream."""
    counts = np.arange(1, 41)
    one = [TV.NegativeSampler(counts, seed=7) for _ in range(shards)]
    jax = JV.NegativeSampler(counts, seed=7)
    want = [jax.sample(shape) for _ in range(shards)]
    for d in range(shards):
        np.testing.assert_array_equal(one[d].sample_shard(shape, shards, d), want[d])
    # the samplers stay in step with the JAX one after the draw
    np.testing.assert_array_equal(one[0].sample(shape), jax.sample(shape))


# --- refusals the JAX apps make -----------------------------------------------


def _fake_mesh() -> Mesh:
    """A mesh cell without process groups: for refusals made before any
    collective."""
    return Mesh(data=1, kv=1, d=0, k=0, device=torch.device("cpu"))


def test_wd_quantized_step_needs_a_push_seed():
    """As the JAX step (wide_deep.py:300-308): a defaulted seed would reuse
    one stream of uniforms every step."""
    app = TW.WideDeep(16, emb_dim=4, hidden=[4], device="cpu")
    step = TW.make_wd_spmd_train_step(app.wide_up, app.emb_up, _fake_mesh(), 16, "quantized")
    with pytest.raises(ValueError, match="push_seed"):
        step(app.wide_state, app.emb_state, app.mlp, app.opt, {}, 1, True)


@pytest.mark.parametrize("make", [
    lambda m: TW.make_wd_spmd_train_multistep(None, None, m, 16, "bogus"),
    lambda m: TV.make_w2v_spmd_train_step(None, None, m, 16, "quantized"),
    lambda m: TV.make_w2v_spmd_train_multistep(None, None, m, 16, "bogus"),
])
def test_mesh_step_makers_refuse_unknown_push_modes(make):
    with pytest.raises(ValueError, match="unknown push_mode"):
        make(_fake_mesh())


def test_wd_mesh_load_state_refuses_other_shapes():
    """On a mesh load_state holds the full tables to num_keys rows before
    each rank takes its slice (a world of one in this process); its own
    state_dict loads back unchanged."""
    from parameter_server_tpu_torch.parallel import runtime

    rt = runtime.init(None, kv_shards=1, data_shards=1, device="cpu")
    try:
        app = TW.WideDeep(64, emb_dim=4, hidden=[4], mesh=rt.mesh, reporter=_quiet(TR))
        st = app.state_dict()
        st["emb"]["w"][5] = 3.0
        app.load_state(st["wide"], st["emb"], st["mlp"])
        again = app.state_dict()
        np.testing.assert_array_equal(again["emb"]["w"], st["emb"]["w"])
        for wide, emb in (({k: v[:-1] for k, v in st["wide"].items()}, st["emb"]),
                          (st["wide"], {"w": st["emb"]["w"]}),
                          (st["wide"], {k: v[:, :-1] for k, v in st["emb"].items()})):
            with pytest.raises(ValueError, match="does not match"):
                app.load_state(wide, emb, st["mlp"])
        w2v = TV.Word2Vec(64, dim=4, mesh=rt.mesh, reporter=_quiet(TR))
        sw = w2v.state_dict()
        w2v.load_state(sw["in"], sw["out"])
        with pytest.raises(ValueError, match="does not match"):
            w2v.load_state(sw["in"], {k: v[:-1] for k, v in sw["out"].items()})
    finally:
        rt.shutdown()
    assert not torch.distributed.is_initialized()


def test_wd_shard_init_equals_the_full_draw(monkeypatch):
    """Each kv shard's rows of the embedding draw, made in row chunks
    without the rows past the shard, equal the JAX app's one-shot draw's
    rows (the last shard's pad rows zero)."""
    monkeypatch.setattr(TW, "INIT_CHUNK_ROWS", 7)
    full = np.random.default_rng(3).normal(scale=0.05, size=(50, 4)).astype(np.float32)
    for kv in (1, 3, 4):
        s = -(-50 // kv)
        for k in range(kv):
            got = TW.normal_table(np.random.default_rng(3), 50, 4, 0.05, "cpu", k * s,
                                  (k + 1) * s).numpy()
            want = np.zeros((s, 4), np.float32)
            piece = full[k * s:(k + 1) * s]
            want[:len(piece)] = piece
            np.testing.assert_array_equal(got, want)


# --- the CLI on a 2x2 world ---------------------------------------------------


# the progress row's clock readings and the dump's path differ run to run
CLOCKED = ("sec", "ex_per_sec", "model_out")


def _cli_world(tmp_path, cfg: dict, name: str) -> tuple[dict, str]:
    """``cli train`` as a 2x2 world of 4 gloo CPU ranks; returns rank 0's
    result and the model path (rank 0 wrote it)."""
    p = tmp_path / f"{name}.json"
    p.write_text(json.dumps(cfg))
    model = str(tmp_path / f"{name}.{'npz' if cfg['app'] == 'wide_deep' else 'npy'}")

    def argvs(port):
        return [[str(RANK_SCRIPT), "cli", "train", "--app_file", str(p), "--device", "cpu",
                 "--model_out", model, "--report_interval", "1000",
                 "--coordinator", f"127.0.0.1:{port}", "--num_processes", "4",
                 "--process_id", str(r)] for r in range(4)]

    outs = run_world(argvs)
    results = [json.loads(o.strip().splitlines()[-1]) for o in outs]
    assert [r["process_index"] for r in results] == [0, 1, 2, 3]
    assert all(r["mesh"] == {"data": 2, "kv": 2} for r in results)
    return results, model


def _jax_cli(tmp_path, cfg: dict, name: str, capsys) -> tuple[dict, str]:
    p = tmp_path / f"j{name}.json"
    p.write_text(json.dumps(cfg))
    model = str(tmp_path / f"j{name}.{'npz' if cfg['app'] == 'wide_deep' else 'npy'}")
    capsys.readouterr()
    assert JC.main(["train", "--app_file", str(p), "--model_out", model,
                    "--report_interval", "1000"]) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1]), model


def test_cli_train_on_a_2x2_world_matches_jax(tmp_path, capsys):
    """``cli train`` for wide_deep (per_worker, 2 steps a call) and
    word2vec (aggregate, 2 steps a call) on a 2x2 world of gloo ranks,
    against the JAX CLI on a 2x2 mesh of the same config: rank 0's final
    JSON (progress row, validation AUC and logloss; the mean loss) and the
    model dumps, at RUN_TOL."""
    rng = np.random.default_rng(3)
    n = 3000
    a, b = rng.integers(0, 2, n), rng.integers(0, 2, n)
    y = (a ^ b).astype(np.float32)
    keys = [np.array([ai, 2 + bi], dtype=np.uint64) for ai, bi in zip(a, b)]
    vals = [np.ones(2, dtype=np.float32) for _ in range(n)]
    for i, sl in enumerate((slice(0, 1300), slice(1300, 2500))):
        write_libsvm(tmp_path / f"tr{i}.svm", y[sl], keys[sl], vals[sl])
    write_libsvm(tmp_path / "val.svm", y[2500:], keys[2500:], vals[2500:])
    par = {"data_shards": 2, "kv_shards": 2}
    wd = {"app": "wide_deep",
          "data": {"files": [str(tmp_path / "tr0.svm"), str(tmp_path / "tr1.svm")],
                   "val_files": [str(tmp_path / "val.svm")], "num_keys": 1024,
                   "max_nnz_per_example": 8},
          "wd": {"emb_dim": 8, "hidden": [16], "mlp_lr": 5e-3},
          "penalty": {"lambda_l1": 0.5},
          "solver": {"epochs": 3, "minibatch": 256, "steps_per_call": 2},
          "parallel": {**par, "push_mode": "per_worker"}}
    files = []
    for i, count in enumerate((1500, 1100)):
        files.append(str(tmp_path / f"c{i}.txt"))
        (tmp_path / f"c{i}.txt").write_text(" ".join(map(str, _zipf_ids(count, 20 + i))))
    w2v = {"app": "word2vec", "data": {"files": files},
           "w2v": {"vocab_size": W2V_VOCAB, "dim": 8, "window": 2, "negatives": 3,
                   "eta": 0.05, "batch_size": 64, "block_tokens": 256},
           "solver": {"epochs": 1, "steps_per_call": 2, "max_delay": 1},
           "parallel": {**par, "push_mode": "aggregate"}}
    for name, cfg in (("wd", wd), ("w2v", w2v)):
        results, model = _cli_world(tmp_path, cfg, name)
        jout, jmodel = _jax_cli(tmp_path, cfg, name, capsys)
        got = results[0]
        for k, v in jout.items():
            if k in CLOCKED:
                continue
            if isinstance(v, float):
                np.testing.assert_allclose(got[k], v, **RUN_TOL, err_msg=f"{name} {k}")
            elif k != "model_out":
                assert got[k] == v, (name, k)
        if name == "wd":
            assert got["val_auc"] > 0.9 and got["val_examples"] == 500
            with np.load(model) as t, np.load(jmodel) as j:
                for k in j.files:
                    np.testing.assert_allclose(t[k], j[k], **RUN_TOL, err_msg=k)
        else:
            np.testing.assert_allclose(np.load(model), np.load(jmodel), **RUN_TOL)
        # every rank reports the same pod-wide result
        for r in results[1:]:
            for k, v in got.items():
                if k not in ("process_index", "launches", "payload_bytes", *CLOCKED):
                    assert r[k] == v, (name, k)
