"""Port parity for ``PodTrainer`` and the sharded ``cli train``.

The port trains ``linear_method`` as 4 ``cli train --device cpu`` rank
processes on a 2x2 gloo world, one libsvm file per data shard, the files of
unequal length (one shard drains first); the JAX package trains the same
config with its ``PodTrainer`` on a 2x2 mesh of the 8-device CPU mesh here.
Every rank process has a time limit of its own (``tests/_torch_world.py``)
and fails if it loaded JAX (``tests/_torch_rank.py``)."""

import json

import numpy as np
import pytest
import torch
from _torch_world import RANK_SCRIPT, rank_argvs, run_world

from parameter_server_tpu.data.batch import BatchBuilder as JBatchBuilder
from parameter_server_tpu.data.synthetic import make_sparse_logistic, write_libsvm
from parameter_server_tpu.parallel import make_mesh as j_make_mesh
from parameter_server_tpu.parallel.spmd import stack_batches as j_stack_batches
from parameter_server_tpu.parallel.trainer import PodTrainer as JPodTrainer
from parameter_server_tpu.utils.checkpoint import load_checkpoint, load_weights_text
from parameter_server_tpu.utils.config import load_config as j_load_config
from parameter_server_tpu.utils.metrics import ProgressReporter as JReporter
from parameter_server_tpu_torch.parallel import runtime as TR
from parameter_server_tpu_torch.parallel.mesh import Mesh
from parameter_server_tpu_torch.parallel.spmd import CSR_FULL_FIELDS
from parameter_server_tpu_torch.parallel.trainer import PodTrainer
from parameter_server_tpu_torch.utils.config import load_config
from parameter_server_tpu_torch.utils.metrics import ProgressReporter

torch.set_num_threads(1)

TOL = {"rtol": 1e-5, "atol": 1e-6}
NUM_KEYS = 4096
SIZES = (700, 400)  # examples of data shard 0's and 1's file


def _cfg(files, val, **parallel):
    return {
        "data": {"files": files, "val_files": [val], "num_keys": NUM_KEYS},
        "solver": {"minibatch": 128, "epochs": 2, "max_delay": 1},
        "penalty": {"lambda_l1": 0.05},
        "parallel": {"data_shards": 2, "kv_shards": 2, **parallel},
    }


def _cli_argvs(app_file, world, extra=()):
    return lambda port: [
        [str(RANK_SCRIPT), "cli", "train", "--app_file", str(app_file), "--device", "cpu",
         "--coordinator", f"127.0.0.1:{port}", "--num_processes", str(world),
         "--process_id", str(r), "--report_interval", "3", *extra] for r in range(world)]


@pytest.fixture(scope="module")
def pod(tmp_path_factory):
    """The port's 4-rank CLI run and JAX's PodTrainer on the same config."""
    tmp = tmp_path_factory.mktemp("pod")
    labels, keys, vals, _ = make_sparse_logistic(1500, 800, nnz_per_example=10, noise=0.3,
                                                 seed=13)
    files, lo = [], 0
    for i, n in enumerate(SIZES):
        files.append(str(tmp / f"part-{i}.svm"))
        write_libsvm(files[-1], labels[lo:lo + n], keys[lo:lo + n], vals[lo:lo + n])
        lo += n
    val = str(tmp / "val.svm")
    write_libsvm(val, labels[lo:], keys[lo:], vals[lo:])
    app_file = tmp / "cfg.json"
    app_file.write_text(json.dumps(_cfg(files, val)))
    outs = run_world(_cli_argvs(app_file, 4, ["--model_out", str(tmp / "m.txt"),
                                             "--ckpt_dir", str(tmp / "ck")]))
    port_out = [json.loads(o.strip().splitlines()[-1]) for o in outs]

    jcfg = j_load_config(app_file)
    jcfg.data.pipeline_depth = 0  # serial: stream d takes file d, as the port's row d
    jt = JPodTrainer(jcfg, mesh=j_make_mesh(2, 2), reporter=JReporter(print_fn=lambda *_: None))
    jlast = jt.train_files(files, report_every=3)
    jt.save(tmp / "jax_ck")
    return {"tmp": tmp, "files": files, "val": val, "app_file": app_file, "outs": outs,
            "port": port_out, "jax": jt, "jax_last": jlast}


def test_full_weights_match_jax(pod):
    got = load_weights_text(pod["tmp"] / "m.txt", NUM_KEYS)
    want = pod["jax"].full_weights().ravel()
    assert np.count_nonzero(want) > 50
    np.testing.assert_allclose(got, want, **TOL)


def test_checkpoint_tables_match_jax(pod):
    state, meta = load_checkpoint(pod["tmp"] / "ck")
    want = pod["jax"].runtime.state_to_host(pod["jax"].state)
    for k in ("z", "n"):
        np.testing.assert_allclose(state[k], want[k], **TOL, err_msg=k)
    assert meta["examples_seen"] == pod["jax"].examples_seen == 2 * sum(SIZES)


@pytest.mark.parametrize("key", ["objv", "auc", "examples"])
def test_last_progress_row_matches_jax(pod, key):
    for out in pod["port"]:
        np.testing.assert_allclose(out[key], pod["jax_last"][key], **TOL)


def test_every_rank_reports_its_place_and_launch_counts(pod):
    outs = pod["port"]
    assert [o["process_index"] for o in outs] == [0, 1, 2, 3]
    assert all(o["mesh"] == {"data": 2, "kv": 2} for o in outs)
    # on the CPU the wrappers run their plain versions: nothing launched
    assert all(o["launches"] == {"ftrl_delta": 0, "ftrl_push": 0, "adagrad_push": 0}
               for o in outs)
    for key in ("val_auc", "val_logloss", "val_examples", "objv"):
        assert len({o[key] for o in outs}) == 1, key
    # the progress table prints on rank 0 only; every rank prints its result
    assert "ex_per_sec" in pod["outs"][0].strip().splitlines()[0]
    assert all(len(o.strip().splitlines()) == 1 for o in pod["outs"][1:])


def test_validation_matches_jax(pod):
    ev = pod["jax"].evaluate_files([pod["val"]])
    out = pod["port"][0]
    assert out["val_examples"] == ev["examples"]
    np.testing.assert_allclose(out["val_logloss"], ev["logloss"], rtol=1e-5)
    np.testing.assert_allclose(out["val_auc"], ev["auc"], atol=1e-4)


@pytest.fixture(scope="module")
def reloaded(pod):
    """A second 2x2 world loads the port's checkpoint and the JAX
    package's, evaluates the validation file and predicts each shard's
    batch."""
    tmp = pod["tmp"]
    builder = JBatchBuilder(num_keys=NUM_KEYS, batch_size=128, max_nnz_per_example=512)
    labels, keys, vals, _ = make_sparse_logistic(256, 800, nnz_per_example=10, seed=21)
    group = [builder.build(labels[i * 128:(i + 1) * 128], keys[i * 128:(i + 1) * 128],
                           vals[i * 128:(i + 1) * 128]) for i in range(2)]
    np.savez(tmp / "predict.npz", **{f"d{d}_{f}": getattr(b, f) for d, b in enumerate(group)
                                     for f in CSR_FULL_FIELDS})
    out_dir = tmp / "reloaded"
    out_dir.mkdir()
    plan = tmp / "pod_plan.json"
    plan.write_text(json.dumps({
        "mesh": [2, 2], "cfg": str(pod["app_file"]), "inputs": str(tmp / "predict.npz"),
        "ckpts": [str(tmp / "ck"), str(tmp / "jax_ck")], "val": [pod["val"]],
        "out": str(out_dir)}))
    run_world(rank_argvs("pod", plan, 4))
    jt = pod["jax"]
    probs = np.asarray(jt.predict_fn(jt.state, j_stack_batches(group, jt.mesh)))
    return [dict(np.load(out_dir / f"rank{r}.npz")) for r in range(4)], probs


@pytest.mark.parametrize("ckpt", [0, 1], ids=["port_ckpt", "jax_ckpt"])
def test_checkpoint_loads_and_predicts_like_jax(pod, reloaded, ckpt):
    """save -> load -> evaluate_files: the port's own checkpoint gives back
    the weights and validation metrics of the run that wrote it; a JAX pod
    checkpoint loads (Runtime.state_from_host) and predicts the JAX
    trainer's probabilities."""
    ranks, jax_probs = reloaded
    want_w = pod["jax"].full_weights()
    for r, res in enumerate(ranks):
        np.testing.assert_allclose(res[f"{ckpt}/weights"], want_w, **TOL)
        np.testing.assert_allclose(res[f"{ckpt}/probs"], jax_probs[r // 2], **TOL)
        assert res[f"{ckpt}/examples_seen"] == 2 * sum(SIZES)
        np.testing.assert_allclose(res[f"{ckpt}/logloss"], pod["port"][0]["val_logloss"],
                                   rtol=1e-5)
    if ckpt == 0:  # the same weights, bit for bit
        np.testing.assert_array_equal(ranks[0]["0/weights"].ravel(),
                                      load_weights_text(pod["tmp"] / "m.txt", NUM_KEYS))


def test_world_that_disagrees_with_the_config_raises(pod, tmp_path):
    """A 2x2 config on a world of 2 ranks: every rank refuses."""
    with pytest.raises(AssertionError, match="mesh 2x2 needs 4 ranks, the world has 2"):
        run_world(_cli_argvs(pod["app_file"], 2))


def test_trainer_refuses_a_runtime_of_another_shape(tmp_path):
    app_file = tmp_path / "cfg.json"
    app_file.write_text(json.dumps(_cfg(["x"], "v", data_shards=2, kv_shards=2)))
    mesh = Mesh(data=4, kv=1, d=0, k=0, device=torch.device("cpu"))
    rt = TR.Runtime(mesh=mesh, process_index=0, process_count=4, data_shards=4, kv_shards=1)
    with pytest.raises(ValueError, match="runtime is"):
        PodTrainer(load_config(app_file), runtime=rt)


@pytest.mark.parametrize("kw,match", [
    ({"kv_shards": 2, "cfg": "CFG"}, "not both"),
    ({"coordinator_addr": None, "num_processes": 2}, "requires a coordinator"),
    ({"coordinator_addr": "127.0.0.1:1", "num_processes": 1}, "num_processes >= 2"),
    ({"device": "cpu", "backend": "nccl"}, "nccl"),
])
def test_runtime_init_guards(tmp_path, kw, match):
    app_file = tmp_path / "cfg.json"
    app_file.write_text(json.dumps(_cfg(["x"], "v")))
    kw = {k: load_config(app_file) if v == "CFG" else v for k, v in kw.items()}
    with pytest.raises(ValueError, match=match):
        TR.init(**kw)
    assert not torch.distributed.is_initialized()


def test_world_of_one_trains_and_evaluates_like_jax(pod):
    """runtime.init with no coordinator: a gloo world of one in this
    process, a 1x1 mesh; PodTrainer trains, evaluates through the predict
    step and saves, as the JAX PodTrainer on a 1x1 mesh does."""
    cfg_d = _cfg(pod["files"][:1], pod["val"], data_shards=1, kv_shards=1)
    app_file = pod["tmp"] / "one.json"
    app_file.write_text(json.dumps(cfg_d))
    rt = TR.init(None, cfg=load_config(app_file), device="cpu")
    try:
        assert rt.process_count == 1 and rt.mesh.shape == {"data": 1, "kv": 1}
        t = PodTrainer(load_config(app_file), runtime=rt,
                       reporter=ProgressReporter(print_fn=lambda *_: None))
        last = t.train_files(pod["files"][:1], report_every=3)
        ev = t.evaluate_files([pod["val"]])
        got_w = t.full_weights()
    finally:
        rt.shutdown()
    assert not torch.distributed.is_initialized()
    jcfg = j_load_config(app_file)
    jt = JPodTrainer(jcfg, mesh=j_make_mesh(1, 1), reporter=JReporter(print_fn=lambda *_: None))
    jlast = jt.train_files(pod["files"][:1], report_every=3)
    jev = jt.evaluate_files([pod["val"]])
    np.testing.assert_allclose(got_w, jt.full_weights(), **TOL)
    np.testing.assert_allclose(last["objv"], jlast["objv"], **TOL)
    np.testing.assert_allclose(ev["logloss"], jev["logloss"], rtol=1e-5)
    assert ev["examples"] == jev["examples"]


@pytest.mark.parametrize("depth", [0, 2])
def test_world_of_one_multistep_equals_single_steps(pod, depth):
    """steps_per_call 2 (one (K, ...) batch group a call, the partial last
    group padded with inert steps) trains the same weights and reports the
    same epoch rows as one step a call, with and without the prefetch
    pipeline."""
    rt = TR.init(None, kv_shards=1, data_shards=1, device="cpu")
    try:
        got = []
        for k in (1, 2):
            cfg_d = _cfg(pod["files"][:1], pod["val"], data_shards=1, kv_shards=1)
            cfg_d["solver"]["steps_per_call"] = k
            cfg_d["data"]["pipeline_depth"] = depth
            app_file = pod["tmp"] / f"multi{k}_{depth}.json"
            app_file.write_text(json.dumps(cfg_d))
            t = PodTrainer(load_config(app_file), runtime=rt,
                           reporter=ProgressReporter(print_fn=lambda *_: None))
            # one row an epoch: report_every counts calls, not steps
            last = t.train_files(pod["files"][:1], report_every=10**6)
            got.append((t.full_weights(), last, t.examples_seen))
    finally:
        rt.shutdown()
    (w1, last1, n1), (w2, last2, n2) = got
    np.testing.assert_array_equal(w2, w1)
    assert n1 == n2 == 2 * SIZES[0]
    for key in ("objv", "auc", "examples"):
        assert last2[key] == last1[key], key


def test_cli_quantized_ranks_audit_their_rounding(pod):
    """cli train --audit_quantized: each rank of a quantized 2x2 run holds
    every push's gathered gradient to the rounding bounds and reports the
    counts in its result line."""
    cfg_d = _cfg(pod["files"], pod["val"], push_mode="quantized")
    cfg_d["solver"]["epochs"] = 1
    app_file = pod["tmp"] / "quantized.json"
    app_file.write_text(json.dumps(cfg_d))
    outs = run_world(_cli_argvs(app_file, 4, ["--audit_quantized"]))
    steps = -(-SIZES[0] // 128)  # the longer shard's batches
    for o in outs:
        audit = json.loads(o.strip().splitlines()[-1])["quant_audit"]
        assert audit["pushes"] >= steps and audit["off_grid"] == 0, audit
        assert audit["scale_mismatch"] == 0, audit
