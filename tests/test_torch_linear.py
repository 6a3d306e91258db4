"""Port parity for linear_method: train steps, checkpoints, the CLI.

The same CSRBatch stream (built once, numpy) goes through the JAX
``train_step`` and the port's. Per step: loss_sum, probs, z and n within
rtol 1e-4 / atol 1e-5 (XLA's segment sums and torch's index_add_ add in
different orders, and the difference compounds over steps); final AUC
within 1e-3."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from parameter_server_tpu import cli as JC
from parameter_server_tpu.data.batch import BatchBuilder as JBatchBuilder
from parameter_server_tpu.data.synthetic import make_sparse_logistic, write_libsvm
from parameter_server_tpu.models import linear as JL
from parameter_server_tpu.models import metrics as JM
from parameter_server_tpu.utils.config import PSConfig as JConfig
from parameter_server_tpu_torch import cli as TC
from parameter_server_tpu_torch.models import linear as TL
from parameter_server_tpu_torch.ops import ftrl_kernels as fk
from parameter_server_tpu_torch.utils.config import PSConfig as TConfig

torch.set_num_threads(1)

K = 4096
B = 128
TOL = {"rtol": 1e-4, "atol": 1e-5}


def _batches(n_batches=6, seed=11, num_keys=K):
    labels, keys, vals, _ = make_sparse_logistic(
        B * n_batches, 1500, nnz_per_example=12, noise=0.3, seed=seed
    )
    builder = JBatchBuilder(num_keys=num_keys, batch_size=B, max_nnz_per_example=48)
    return [
        builder.build(labels[i:i + B], keys[i:i + B], vals[i:i + B])
        for i in range(0, B * n_batches, B)
    ]


def _cfgs(algo="ftrl"):
    out = []
    for cfg in (JConfig(), TConfig()):
        cfg.data.num_keys = K
        cfg.solver.minibatch = B
        cfg.solver.algo = algo
        cfg.data.max_nnz_per_example = 48
        cfg.lr.alpha, cfg.penalty.lambda_l1 = 0.2, 0.5
        out.append(cfg)
    return out


@pytest.mark.parametrize("algo", ["ftrl", "adagrad", "sgd"])
def test_train_steps_match_jax(algo):
    jcfg, tcfg = _cfgs(algo)
    ju, tu = JL.updater_from_config(jcfg), TL.updater_from_config(tcfg)
    jst = ju.init(K, 1)
    tst = tu.init(K, 1, device="cpu")
    fk.reset_launches()
    ys, jp, tp = [], [], []
    for b in _batches():
        jst, jout = JL.train_step(ju, jst, JL.batch_to_device(b))
        _, tout = TL.train_step(tu, tst, TL.batch_to_device(b, "cpu"))
        np.testing.assert_allclose(float(tout["loss_sum"]), float(jout["loss_sum"]), **TOL)
        np.testing.assert_allclose(tout["probs"].numpy(), np.asarray(jout["probs"]), **TOL)
        for k in jst:
            np.testing.assert_allclose(tst[k].numpy(), np.asarray(jst[k]), **TOL)
        ys.append(b.labels[: b.num_examples])
        jp.append(np.asarray(jout["probs"])[: b.num_examples])
        tp.append(tout["probs"][: b.num_examples].numpy())
    y = np.concatenate(ys)
    assert abs(JM.auc(y, np.concatenate(jp)) - JM.auc(y, np.concatenate(tp))) <= 1e-3
    assert fk.LAUNCHES == {"ftrl_delta": 0, "ftrl_push": 0}  # CPU: plain path


@pytest.mark.parametrize("algo", ["ftrl", "adagrad", "sgd"])
def test_train_step_on_the_real_prefix_equals_the_padded_step(algo):
    """A pad adds an exact zero after the real adds, so the step on a batch's
    real prefix (``trim_batch``) gives the padded step's bits."""
    from parameter_server_tpu_torch.data.batch import trim_batch

    _, tcfg = _cfgs(algo)
    tu = TL.updater_from_config(tcfg)
    padded, real = tu.init(K, 1, device="cpu"), tu.init(K, 1, device="cpu")
    for b in _batches(seed=21):
        assert b.num_entries < len(b.values) and b.num_unique < len(b.unique_keys)
        _, want = TL.train_step(tu, padded, TL.batch_to_device(b, "cpu"))
        _, got = TL.train_step(tu, real, TL.batch_to_device(trim_batch(b), "cpu"))
        for k in ("loss_sum", "logits", "probs"):
            assert torch.equal(got[k], want[k]), k
        for k in padded:
            assert torch.equal(real[k], padded[k]), k


@pytest.mark.parametrize("algo", ["ftrl", "adagrad", "sgd"])
def test_predict_on_the_real_prefix_equals_the_padded_predict(algo):
    """``LinearMethod.predict`` steps on each batch's real prefix and gives
    ``predict_step``'s bits on the padded batch, after training."""
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter as TR

    _, tcfg = _cfgs(algo)
    app = TL.LinearMethod(tcfg, TR(print_fn=lambda s: None), device="cpu")
    batches = _batches(seed=22)
    app.train(batches[:3], report_every=3)
    ys, ps = app.predict(batches)
    want = [TL.predict_step(app.updater, app.store.state, TL.batch_to_device(b, "cpu"))
            [: b.num_examples].numpy() for b in batches]
    assert np.array_equal(ps, np.concatenate(want))
    assert np.array_equal(ys, np.concatenate([b.labels[: b.num_examples] for b in batches]))


def test_evaluate_model_on_the_unbucketed_builder_equals_the_padded_computation(tmp_path):
    """``evaluate_model`` builds without ``bucket_nnz`` (every batch padded
    to batch_size x max_nnz entries) and predicts on each batch's real
    prefix: its AUC and logloss, and ``linear_predict``'s probabilities,
    are the padded computation's, done by hand, bit for bit."""
    from parameter_server_tpu_torch.data.batch import BatchBuilder, batch_to_device
    from parameter_server_tpu_torch.data.reader import MinibatchReader
    from parameter_server_tpu_torch.models import evaluation as E
    from parameter_server_tpu_torch.models import metrics as M
    from parameter_server_tpu_torch.ops.sparse import csr_logits

    labels, keys, vals, _ = make_sparse_logistic(3 * B + 40, 1500, nnz_per_example=12,
                                                 noise=0.3, seed=31)
    path = str(tmp_path / "val.svm")
    write_libsvm(path, labels, keys, vals)
    w = np.random.default_rng(32).normal(size=K).astype(np.float32)
    wt = torch.from_numpy(w.reshape(-1, 1))
    builder = BatchBuilder(num_keys=K, batch_size=B, max_nnz_per_example=48)
    ys, ps = [], []
    for b in MinibatchReader([path], "libsvm", builder):
        assert b.num_entries < len(b.values)
        d = batch_to_device(b, "cpu")
        logits = csr_logits(wt.index_select(0, d["unique_keys"]), d["values"],
                            d["local_ids"], d["row_ids"], num_rows=len(b.labels))
        ps.append(torch.sigmoid(logits)[: b.num_examples].numpy())
        ys.append(b.labels[: b.num_examples])
    y, p = np.concatenate(ys), np.concatenate(ps)
    got = E.evaluate_model(w, [path], "libsvm", K, batch_size=B, max_nnz_per_example=48,
                           device="cpu")
    assert (got["auc"], got["logloss"], got["examples"]) == (M.auc(y, p), M.logloss(y, p),
                                                             len(y))
    got_y, got_p = E.linear_predict(MinibatchReader([path], "libsvm", builder), "cpu",
                                    lambda u: wt.index_select(0, u))
    assert np.array_equal(got_y, y) and np.array_equal(got_p, p)


def test_linear_method_train_matches_jax():
    jcfg, tcfg = _cfgs()
    batches = _batches(8, seed=12)
    quiet = {"print_fn": lambda s: None}
    from parameter_server_tpu.utils.metrics import ProgressReporter as JR
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter as TR

    japp = JL.LinearMethod(jcfg, JR(**quiet))
    tapp = TL.LinearMethod(tcfg, TR(**quiet), device="cpu")
    jrec = japp.train(batches, report_every=3)
    trec = tapp.train(batches, report_every=3)
    assert len(japp.reporter.history) == len(tapp.reporter.history) == 3
    for a, b in zip(japp.reporter.history, tapp.reporter.history):
        assert a["examples"] == b["examples"]
        np.testing.assert_allclose(b["objv"], a["objv"], rtol=1e-4)
        assert abs(a["auc"] - b["auc"]) <= 1e-3
    assert trec["auc"] > 0.5 and tapp.examples_seen == japp.examples_seen
    assert tapp.store.nnz() == japp.store.nnz()
    jev, tev = japp.evaluate(batches[:2]), tapp.evaluate(batches[:2])
    assert jev["examples"] == tev["examples"]
    assert abs(jev["auc"] - tev["auc"]) <= 1e-3
    np.testing.assert_allclose(tev["logloss"], jev["logloss"], rtol=1e-4)
    del jrec


def _inside(child: dict, parent: dict) -> bool:
    return (parent["ts"] <= child["ts"]
            and child["ts"] + child["dur"] <= parent["ts"] + parent["dur"])


@pytest.mark.parametrize("report_every", [3, 4, 8])
def test_train_names_its_loop_under_the_profiler(report_every, tmp_path):
    """Under ``torch.profiler``, ``train`` opens one ``linear.step`` a batch
    (its copies, its launch and the next fetch inside), one
    ``linear.report`` a report (the readback and the AUC inside, no step
    around it), and counts the slots and pad slots each step carries;
    untraced, it records nothing."""
    from torch.profiler import ProfilerActivity, profile

    from parameter_server_tpu_torch.utils import trace
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter as TR

    _, tcfg = _cfgs()
    batches = _batches(8, seed=13)
    app = TL.LinearMethod(tcfg, TR(print_fn=lambda s: None), device="cpu")
    trace.configure(None)
    try:
        app.train(batches[:2], report_every=report_every)
        assert trace.tracer.events() == []
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            app.train(iter(batches), report_every=report_every)
        ring = trace.tracer.events()
    finally:
        trace.configure(None)
    path = tmp_path / "profile.json"
    prof.export_chrome_trace(str(path))
    ann = [e for e in json.loads(path.read_text())["traceEvents"]
           if e.get("cat") == "user_annotation" and e["name"].startswith("linear.")]
    reports = -(-len(batches) // report_every)
    for events in (ann, [e for e in ring if e["ph"] == "X"]):
        names = [e["name"] for e in events]
        assert names.count("linear.step") == len(batches)
        assert names.count("linear.h2d") == names.count("linear.launch") == len(batches)
        assert names.count("linear.fetch") == len(batches) + 1
        for n in ("linear.report", "linear.report.readback", "linear.report.auc"):
            assert names.count(n) == reports, n
    spans = {n: [e for e in ann if e["name"] == n] for n in {e["name"] for e in ann}}
    for child, parent in (("linear.h2d", "linear.step"), ("linear.launch", "linear.step"),
                          ("linear.report.readback", "linear.report"),
                          ("linear.report.auc", "linear.report")):
        for c in spans[child]:
            assert any(_inside(c, p) for p in spans[parent]), (child, c)
    for r in spans["linear.report"]:
        assert not any(_inside(r, s) for s in spans["linear.step"])
    ids = {e["args"]["span_id"]: e["name"] for e in ring if e["ph"] == "X"}
    for e in ring:
        if e["ph"] == "X" and e["name"] in ("linear.h2d", "linear.launch"):
            assert ids[e["args"]["parent_id"]] == "linear.step"
        if e["name"] in ("linear.step", "linear.report"):
            assert "parent_id" not in e["args"]
    counters = {n: [e["args"]["value"] for e in ring if e["ph"] == "C" and e["name"] == n]
                for n in ("linear.slots", "linear.pad_slots")}
    # the step carries each batch's real prefix: its slots, no pads
    assert counters["linear.slots"] == [b.num_unique for b in batches]
    assert counters["linear.pad_slots"] == [0] * len(batches)


@pytest.mark.parametrize("builder", ["make_builder", "cuda_builder"])
def test_train_on_a_builders_batches_trains_the_plain_state(builder, monkeypatch):
    """``LinearMethod(device="cpu").make_builder()`` asks for no page-locked
    memory. A builder on a CUDA device (its block a plain tensor here: a
    CPU-only torch cannot page-lock) asks for one block a batch, and its
    batches reach the store through the block. Either trains the state
    that plain numpy batches train, bit for bit."""
    from parameter_server_tpu_torch.data import batch as TB
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter as TR

    asked = []

    def block(nbytes):
        asked.append(nbytes)
        return torch.empty(nbytes, dtype=torch.uint8)

    monkeypatch.setattr(TB, "_pinned_block", block)
    _, tcfg = _cfgs()
    labels, keys, vals, _ = make_sparse_logistic(4 * B, 1500, nnz_per_example=12, noise=0.3,
                                                 seed=14)
    states = {}
    for kind in ("plain", builder):
        app = TL.LinearMethod(tcfg, TR(print_fn=lambda s: None), device="cpu")
        build = {"plain": TB.training_builder(tcfg), "make_builder": app.make_builder(),
                 "cuda_builder": TB.training_builder(tcfg, device="cuda")}[kind]
        batches = [build.build(labels[i:i + B], keys[i:i + B], vals[i:i + B])
                   for i in range(0, 4 * B, B)]
        assert all((b.pinned is not None) == (kind == "cuda_builder") for b in batches)
        app.train(batches, report_every=2)
        states[kind] = app.store.state
    assert len(asked) == (len(batches) if builder == "cuda_builder" else 0)
    for k, v in states["plain"].items():
        assert torch.equal(states[builder][k], v), k


def test_train_files_builds_plain_batches_where_make_builder_builds_page_locked(monkeypatch):
    """For a store on a CUDA device, ``make_builder`` builds page-locked
    batches, while ``train_files`` hands its reader a builder of plain
    numpy batches: there the reader's prefetch thread sets the pace."""
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter as TR

    handed = []

    class Reader:
        def __init__(self, files, fmt, builder, epochs=1):
            handed.append(builder)

        def __iter__(self):
            return iter(())

    monkeypatch.setattr(TL, "MinibatchReader", Reader)
    _, tcfg = _cfgs()
    app = TL.LinearMethod(tcfg, TR(print_fn=lambda s: None), device="cpu")
    app.device = torch.device("cuda")  # what the builders see of a card store
    assert app.make_builder().page_locked
    assert app.train_files(["rows.libsvm"]) == {}
    assert [b.page_locked for b in handed] == [False]


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_carries_across(tmp_path, direction):
    jcfg, tcfg = _cfgs()
    batches = _batches(4, seed=13)
    quiet = lambda s: None  # noqa: E731
    from parameter_server_tpu.utils.metrics import ProgressReporter as JR
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter as TR

    japp = JL.LinearMethod(jcfg, JR(print_fn=quiet))
    tapp = TL.LinearMethod(tcfg, TR(print_fn=quiet), device="cpu")
    if direction == "jax_to_torch":
        japp.train(batches[:3], report_every=10)
        japp.save(str(tmp_path))
        tapp.load(str(tmp_path))
    else:
        tapp.train(batches[:3], report_every=10)
        tapp.save(str(tmp_path))
        japp.load(str(tmp_path))
    assert tapp.examples_seen == japp.examples_seen == 3 * B
    for k in japp.store.state:
        np.testing.assert_array_equal(
            tapp.store.state[k].numpy(), np.asarray(japp.store.state[k])
        )
    jy, jp = japp.predict(batches[3:])
    ty, tp = tapp.predict(batches[3:])
    np.testing.assert_array_equal(ty, jy)
    np.testing.assert_allclose(tp, jp, rtol=0, atol=1e-6)
    tcfg.solver.algo = "sgd"
    with pytest.raises(ValueError, match="algo"):
        TL.LinearMethod(tcfg, device="cpu").load(str(tmp_path))


def test_cli_train_and_evaluate_match_jax(tmp_path, capsys):
    labels, keys, vals, _ = make_sparse_logistic(600, 800, nnz_per_example=10, seed=14)
    data = tmp_path / "train.libsvm"
    write_libsvm(data, labels, keys, vals)
    cfg = {
        "data": {"files": [str(data)], "format": "libsvm", "num_keys": K,
                 "max_nnz_per_example": 64},
        "solver": {"algo": "ftrl", "minibatch": 100},
        "lr": {"alpha": 0.2},
        "penalty": {"lambda_l1": 0.3},
    }
    app_file = tmp_path / "cfg.json"
    app_file.write_text(json.dumps(cfg))
    jm, tm = tmp_path / "jax.txt", tmp_path / "torch.txt"
    assert JC.main(["train", "--app_file", str(app_file), "--model_out", str(jm)]) == 0
    jout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert TC.main(["train", "--app_file", str(app_file), "--model_out", str(tm),
                    "--device", "cpu"]) == 0
    tout = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tout["examples"] == jout["examples"] == 600
    from parameter_server_tpu.utils.checkpoint import load_weights_text

    jw, tw = load_weights_text(jm, K), load_weights_text(tm, K)
    assert (jw != 0).sum() > 0
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-5)
    TC.main(["evaluate", "--app_file", str(app_file), "--model", str(tm),
             "--device", "cpu"])
    tev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    JC.main(["evaluate", "--app_file", str(app_file), "--model", str(jm)])
    jev = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert tev["examples"] == jev["examples"] and tev["nnz_w"] == jev["nnz_w"]
    assert abs(tev["auc"] - jev["auc"]) <= 1e-3


@pytest.mark.parametrize("argv,match", [
    # the paths the port still refuses (every CLI command is ported):
    # evaluate and the cluster path for an app they do not run
    (["evaluate", "--app_file", "CFG_SKETCH", "--model", "m", "--device", "cpu"],
     "not ported yet"),
    (["launch", "--app_file", "CFG_SKETCH", "--device", "cpu"], "not ported yet"),
    # the JAX CLI's own refusal: the pool needs the pod path
    (["train", "--app_file", "CFG", "--pool_coordinator", "h:1", "--device", "cpu"],
     "requires the pod training path"),
])
def test_cli_refuses_unported_paths(tmp_path, argv, match):
    cfgs = {"CFG": {"data": {"files": ["x"]}},
            "CFG_SKETCH": {"app": "sketch", "data": {"files": ["x"]}}}
    for name, conf in cfgs.items():
        (tmp_path / f"{name}.json").write_text(json.dumps(conf))
    argv = [str(tmp_path / f"{a}.json") if a in cfgs else a for a in argv]
    with pytest.raises(SystemExit, match=match):
        TC.main(argv)


@pytest.mark.parametrize("section", [
    {"profile": {"hz": 10}}, {"timeseries": {"metrics_port": 9100}},
    {"app": "sketch", "trace": {"trace_dir": "t"}}, {"trace": {"trace_dir": "t"}},
])
def test_cli_refuses_unported_config(tmp_path, section, capsys):
    """[profile] and [timeseries] arm the profiler and the metrics
    endpoint for the run and tear them down after it, as the JAX CLI
    does; a [trace] section arms tracing for the run: the linear app's
    ``linear.*`` spans land in the dir, the sketch app records none, and
    a span recorded after the run lands there too."""
    from parameter_server_tpu_torch.utils import profiler, timeseries, trace

    data = tmp_path / "a.svm"
    write_libsvm(data, *make_sparse_logistic(64, 50, nnz_per_example=3, seed=2)[:3])
    if "trace" in section:
        section = {**section, "trace": {"trace_dir": str(tmp_path / "t")}}
    app_file = tmp_path / "cfg.json"
    app_file.write_text(json.dumps({"data": {"files": [str(data)], "num_keys": 256},
                                    **section}))
    argv = ["train", "--app_file", str(app_file), "--device", "cpu"]
    if "trace" not in section:
        armed = {}
        real_configure, real_start = profiler.configure, timeseries.start_metrics_server

        def configure(hz, **kw):
            armed.setdefault("hz", hz)
            return real_configure(hz, **kw)

        def start(port, **kw):
            # the configured port, bound through the fallback to a free one
            srv = real_start(0, **kw)
            armed["port"] = port
            return srv

        with pytest.MonkeyPatch.context() as m:
            m.setattr(profiler, "configure", configure)
            m.setattr(timeseries, "start_metrics_server", start)
            assert TC.main(argv) == 0
        want = {"hz": 10} if "profile" in section else {"port": 9100}
        assert armed == want
        assert not profiler.enabled()
        assert not [t.name for t in threading.enumerate()
                    if t.name.startswith(("ps-ts-roller", "ps-metrics", "ps-profiler"))]
        capsys.readouterr()
        return
    try:
        assert TC.main(argv) == 0
        assert trace.enabled() and trace.tracer.trace_dir == str(tmp_path / "t")
        assert trace.tracer.process_name == "train"
        with trace.span("after.run"):
            pass
        path = trace.tracer.flush()
    finally:
        trace.configure(None)
    doc = json.loads(open(path).read())
    assert os.path.dirname(path) == str(tmp_path / "t")
    names = [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"]
    assert [n for n in names if not n.startswith("linear.")] == ["after.run"]
    assert ("linear.step" in names) == ("app" not in section)
    capsys.readouterr()

