"""Port parity for the pod trainer's dynamic workload pool:
``PodTrainer.train_files_dynamic`` and ``cli train --pool_coordinator /
--pool_serve``.

One data row takes the pool's items in the static order, so there the
dynamic run equals the port's ``train_files`` and the JAX package's
``train_files`` on a 1x2 CPU mesh. Two data rows share the pool by
demand, under a seeded fault plan on the pool Coordinator: every workload
is done exactly once, and both ranks end with the same replica. Each
world has at most 2 gloo rank processes (``tests/_torch_world.py``), and
each rank fails if it loaded JAX."""

import json
import socket

import numpy as np
import pytest
import torch
from _torch_world import RANK_SCRIPT, rank_argvs, run_world

from parameter_server_tpu import cli as JC
from parameter_server_tpu.data.synthetic import make_sparse_logistic, write_libsvm
from parameter_server_tpu.parallel import make_mesh as j_make_mesh
from parameter_server_tpu.parallel.trainer import PodTrainer as JPodTrainer
from parameter_server_tpu.utils.checkpoint import load_weights_text
from parameter_server_tpu.utils.config import load_config as j_load_config
from parameter_server_tpu.utils.metrics import ProgressReporter as JReporter
from parameter_server_tpu_torch import cli as TC
from parameter_server_tpu_torch.parallel import runtime as TR
from parameter_server_tpu_torch.parallel.control import Coordinator
from parameter_server_tpu_torch.parallel.trainer import PodTrainer
from parameter_server_tpu_torch.utils.config import load_config
from parameter_server_tpu_torch.utils.metrics import ProgressReporter

torch.set_num_threads(1)

TOL = {"rtol": 1e-5, "atol": 1e-6}
NUM_KEYS = 2048
ROWS = 256  # a file: 2 steps of 128
FILES = 3
PLAN = "disconnect,prob=0.04;duplicate,prob=0.04;delay,prob=0.05,delay_s=0.005"


def _free_addr() -> str:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return f"127.0.0.1:{s.getsockname()[1]}"


@pytest.fixture(scope="module")
def data(tmp_path_factory):
    tmp = tmp_path_factory.mktemp("pool")
    labels, keys, vals, _ = make_sparse_logistic(FILES * ROWS + 300, 700, nnz_per_example=8,
                                                 noise=0.3, seed=41)
    files = []
    for i in range(FILES):
        files.append(str(tmp / f"part-{i}.svm"))
        sl = slice(i * ROWS, (i + 1) * ROWS)
        write_libsvm(files[-1], labels[sl], keys[sl], vals[sl])
    val = str(tmp / "val.svm")
    write_libsvm(val, labels[FILES * ROWS:], keys[FILES * ROWS:], vals[FILES * ROWS:])
    return tmp, sorted(files), val


def _app(tmp, files, val, name, data_shards, kv_shards):
    app = tmp / name
    app.write_text(json.dumps({
        "data": {"files": files, "val_files": [val], "num_keys": NUM_KEYS,
                 "pipeline_depth": 0},
        "solver": {"minibatch": 128, "epochs": 2, "max_delay": 1},
        "penalty": {"lambda_l1": 0.05},
        "parallel": {"data_shards": data_shards, "kv_shards": kv_shards},
    }))
    return app


def _cli(app, world, extra):
    return lambda port: [
        [str(RANK_SCRIPT), "cli", "train", "--app_file", str(app), "--device", "cpu",
         "--coordinator", f"127.0.0.1:{port}", "--num_processes", str(world),
         "--process_id", str(r), "--report_interval", str(FILES * 2), *extra]
        for r in range(world)]


def _last(outs):
    return [json.loads(o.strip().splitlines()[-1]) for o in outs]


def test_one_data_row_dynamic_equals_static_and_jax(data):
    """A 1x2 world: ``cli train --pool_coordinator --pool_serve`` (rank 0
    hosts the pool) trains the weights and reports the epoch rows of the
    static ``cli train`` world and of the JAX PodTrainer's ``train_files``
    on a 1x2 mesh."""
    tmp, files, val = data
    app = _app(tmp, files, val, "one_row.json", 1, 2)
    dyn = _last(run_world(_cli(app, 2, ["--pool_coordinator", _free_addr(), "--pool_serve",
                                        "--model_out", str(tmp / "dyn.txt")])))
    static = _last(run_world(_cli(app, 2, ["--model_out", str(tmp / "static.txt")])))
    jt = JPodTrainer(j_load_config(app), mesh=j_make_mesh(1, 2),
                     reporter=JReporter(print_fn=lambda *_: None))
    jlast = jt.train_files(files, report_every=FILES * 2)
    w_dyn = load_weights_text(tmp / "dyn.txt", NUM_KEYS)
    np.testing.assert_array_equal(w_dyn, load_weights_text(tmp / "static.txt", NUM_KEYS))
    assert np.count_nonzero(w_dyn) > 50
    np.testing.assert_allclose(w_dyn, jt.full_weights().ravel(), **TOL)
    for out in dyn:
        assert out["mesh"] == {"data": 1, "kv": 2}
        assert out["examples"] == jlast["examples"] == 2 * FILES * ROWS
        assert out["rpc_retries"] == 0 and out["rpc_reconnects"] == 0
        for key in ("objv", "auc"):
            np.testing.assert_allclose(out[key], jlast[key], **TOL)
            assert out[key] == static[0][key]
        assert out["val_logloss"] == static[0]["val_logloss"]


def test_two_data_rows_under_a_fault_plan_do_every_workload_once(data):
    """A 2x1 world drains the pool by demand while the pool Coordinator
    drops, duplicates and delays frames (a seeded plan): every workload is
    done once (the pool's ledger: no attempt beyond the items), every rank
    counted every example once, and the two replicas are the same table."""
    tmp, files, val = data
    app = _app(tmp, files, val, "two_rows.json", 2, 1)
    out_dir = tmp / "pool_out"
    out_dir.mkdir()
    plan = tmp / "pool_plan.json"
    plan.write_text(json.dumps({
        "mesh": [2, 1], "cfg": str(app), "files": files, "pool": _free_addr(),
        "fault_plan": PLAN, "fault_seed": 97, "out": str(out_dir)}))
    run_world(rank_argvs("pool", plan, 2))
    r0, r1 = (dict(np.load(out_dir / f"rank{r}.npz")) for r in range(2))
    pending, active, done, attempts = r0["pool"]
    assert (pending, active, done, attempts) == (0, 0, 2 * FILES, 2 * FILES)
    assert r0["faults_fired"] > 0
    np.testing.assert_array_equal(r0["weights"], r1["weights"])
    assert r0["examples_seen"] == r1["examples_seen"] == 2 * FILES * ROWS
    assert np.count_nonzero(r0["weights"]) > 50


def test_cli_pool_with_an_external_coordinator(data):
    """``--pool_coordinator`` without ``--pool_serve``: the ranks of a 2x1
    world take their files from a Coordinator another process hosts (here
    the test's, under the seeded plan), which ends with every workload done
    once; both ranks evaluate the same weights."""
    from parameter_server_tpu_torch.parallel.chaos import FaultPlan

    tmp, files, val = data
    app = _app(tmp, files, val, "ext.json", 2, 1)
    addr = _free_addr()
    host, port = addr.rsplit(":", 1)
    coord = Coordinator(host, int(port), fault_plan=FaultPlan.parse(PLAN, seed=5))
    try:
        outs = _last(run_world(_cli(app, 2, ["--pool_coordinator", addr])))
        st = coord._pool.stats()
    finally:
        coord.stop()
    assert (st["pending"], st["active"], st["done"], st["attempts"]) == (
        0, 0, 2 * FILES, 2 * FILES)
    assert [o["process_index"] for o in outs] == [0, 1]
    assert outs[0]["examples"] == outs[1]["examples"] == 2 * FILES * ROWS
    assert outs[0]["val_logloss"] == outs[1]["val_logloss"]
    assert outs[0]["val_auc"] > 0.6


def test_world_of_one_dynamic_equals_static(data):
    """In-process, a gloo world of one: ``train_files_dynamic`` against a
    Coordinator in a thread trains what ``train_files`` trains, and a
    second run against the same (no longer fresh) pool raises."""
    tmp, files, val = data
    app = _app(tmp, files, val, "one.json", 1, 1)
    rt = TR.init(None, cfg=load_config(app), device="cpu")
    addr = _free_addr()
    host, port = addr.rsplit(":", 1)
    coord = Coordinator(host, int(port))
    try:
        quiet = ProgressReporter(print_fn=lambda *_: None)
        t = PodTrainer(load_config(app), runtime=rt, reporter=quiet)
        dyn = t.train_files_dynamic(files, addr, report_every=FILES * 2)
        w_dyn = t.full_weights()
        s = PodTrainer(load_config(app), runtime=rt,
                       reporter=ProgressReporter(print_fn=lambda *_: None))
        static = s.train_files(files, report_every=FILES * 2)
        w_static = s.full_weights()
        with pytest.raises(RuntimeError, match="fresh Coordinator"):
            PodTrainer(load_config(app), runtime=rt, reporter=quiet).train_files_dynamic(
                files, addr)
    finally:
        coord.stop()
        rt.shutdown()
    np.testing.assert_array_equal(w_dyn, w_static)
    assert np.count_nonzero(w_dyn) > 50
    for key in ("objv", "auc", "examples"):
        assert dyn[key] == static[key], key
    assert t.examples_seen == s.examples_seen == 2 * FILES * ROWS


@pytest.mark.parametrize("extra", [["--pool_serve"], []])
def test_pool_coordinator_refused_off_the_pod_path_like_jax(data, extra):
    """A 1x1 config has no pod: both CLIs refuse the flag with JAX's
    message (a silently ignored flag would park other pod ranks)."""
    tmp, files, val = data
    app = _app(tmp, files, val, "flat.json", 1, 1)
    argv = ["train", "--app_file", str(app), "--pool_coordinator", "127.0.0.1:1", *extra]
    with pytest.raises(SystemExit) as port_exit:
        TC.main(argv + ["--device", "cpu"])
    with pytest.raises(SystemExit) as jax_exit:
        JC.main(argv)
    assert "requires the pod training path" in str(port_exit.value)
    assert str(port_exit.value) == str(jax_exit.value)
