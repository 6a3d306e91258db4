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
    does; a [trace] section arms tracing for the run (the one-process
    apps record no spans of their own, in either package, so a span
    recorded after the run is what lands in the dir)."""
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
    assert [e["name"] for e in doc["traceEvents"] if e["ph"] == "X"] == ["after.run"]
    capsys.readouterr()

