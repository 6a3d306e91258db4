"""One rank of a port world, for the tests of the SPMD tier.

    python tests/_torch_rank.py <mode> <plan.json> <rank> <world> <port>
    python tests/_torch_rank.py cli <arguments of the port's cli>

Joins a gloo world of ``world`` CPU ranks at 127.0.0.1:<port>, runs the
plan's cases and writes its results to ``<plan out>/rank<r>.npz``. Modes:

- ``spmd``: ``make_spmd_train_step`` / ``_multistep`` / ``predict`` on the
  plan's CSR batches (``s<step>_d<shard>_<field>`` arrays), the quantized
  pushes audited (``spmd.audit_rounding``);
- ``mf``: the MF mesh step on the plan's MF batches, and ``train_epoch``
  on its ratings;
- ``cli``: the port's command line, as its own rank of a world;
- ``pod``: ``PodTrainer`` loads each of the plan's checkpoints, evaluates
  files and predicts its data shard's batch (``d<shard>_<field>``);
- ``wd``: ``WideDeep(mesh=...)`` trains on the plan's CSR batch stream
  (``<stream>/b<i>/<field>``), predicts, dumps; the slots of every fused
  push are recorded;
- ``w2v``: ``Word2Vec(mesh=...)`` runs ``train_epoch`` on the plan's
  corpus or ``train_files`` on its files;
- ``darlin``: ``Darlin(mesh=...)`` fits the plan's cases, each on the
  column blocks of one of its CSR batch streams (``<stream>/b<i>/<field>``);
- ``backend``: ``MeshBackend`` on the world's mesh: pushes into a table of
  the plan's awkward size, ``train_linear`` on the plan's workload (f32
  and int8), and the int8 error feedback's telescoping pushes;
- ``pool``: ``PodTrainer.train_files_dynamic`` on the plan's files against
  a ``Coordinator`` that rank 0 hosts at the plan's ``pool`` address,
  under the plan's seeded fault plan; every rank writes its full weights,
  rank 0 the pool's final stats and the plan's firings.

``<mode>`` may name several modes, joined by "+", run in one world.

Imports no JAX: the rank asserts it never loaded.
"""

import json
import sys
from pathlib import Path
from types import SimpleNamespace

import numpy as np
import torch

from parameter_server_tpu_torch.parallel import runtime
from parameter_server_tpu_torch.parallel.spmd import (
    CSR_COMPACT_FIELDS,
    CSR_FULL_FIELDS,
    make_spmd_predict_step,
    make_spmd_train_multistep,
    make_spmd_train_step,
    padded_num_keys,
)


def _spmd(rt, plan: dict, inputs) -> dict:
    from parameter_server_tpu_torch.kv.updaters import make_updater

    mesh = rt.mesh
    out = {}
    for case in plan["cases"]:
        name, steps = case["name"], case["steps"]
        up = make_updater(case["algo"], **case["hyper"])
        num_keys = case["num_keys"]
        state = rt.init_state(up, padded_num_keys(num_keys, mesh.kv))
        mesh.quant_audit = {} if case["push_mode"] == "quantized" else None
        fields = CSR_COMPACT_FIELDS if case.get("compact") else CSR_FULL_FIELDS

        def batch(s):
            return {f: torch.from_numpy(inputs[f"{case['prefix']}s{s}_d{mesh.d}_{f}"])
                    for f in fields}

        if case.get("multistep"):
            step = make_spmd_train_multistep(up, mesh, num_keys, case["push_mode"])
            group = {f: torch.stack([batch(s)[f] for s in range(steps)]) for f in fields}
            state, res = step(state, group, 0)
            outs = [{k: v[s] for k, v in res.items()} for s in range(steps)]
        else:
            step = make_spmd_train_step(up, mesh, num_keys, case["push_mode"])
            outs = []
            for s in range(steps):
                state, res = step(state, batch(s), s)
                outs.append(res)
        for key in ("loss_sum", "examples", "probs"):
            out[f"{name}/{key}"] = torch.stack([o[key] for o in outs]).numpy()
        if case.get("predict"):
            predict = make_spmd_predict_step(up, mesh, num_keys)
            out[f"{name}/predict"] = predict(state, batch(steps - 1)).numpy()
        for table, v in rt.state_to_host(state).items():
            out[f"{name}/{table}"] = v
        if mesh.quant_audit is not None:
            out[f"{name}/audit"] = np.array([int(mesh.quant_audit[k]) for k in (
                "pushes", "off_grid", "scale_mismatch")])
    return out


def _mf(rt, plan: dict, inputs) -> dict:
    from parameter_server_tpu_torch.models.matrix_fac import (
        MatrixFactorization,
        batch_to_device,
    )
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    fields = ("user_keys", "item_keys", "user_ids", "item_ids", "ratings", "mask")
    out = {}
    for case in plan["cases"]:
        name = case["name"]
        app = MatrixFactorization(
            case["num_users"], case["num_items"], rank=case["rank"], eta=case["eta"],
            l2=case["l2"], algo=case["algo"], seed=case["seed"], mesh=rt.mesh,
            push_mode=case["push_mode"], reporter=ProgressReporter(print_fn=lambda *_: None),
        )
        if case.get("epoch"):
            out[f"{name}/rmse"] = np.float64(app.train_epoch(
                inputs["users"], inputs["items"], inputs["ratings"],
                batch_size=case["batch_size"], seed=case["seed"]))
        else:
            losses = []
            for s in range(case["steps"]):
                arrs = {f: inputs[f"s{s}_d{rt.mesh.d}_{f}"] for f in fields}
                b = batch_to_device(SimpleNamespace(**arrs), rt.mesh.device)
                losses.append(float(app._spmd_step(app.user_state, app.item_state, b)[2]))
            out[f"{name}/loss"] = np.array(losses)
        for table, st in app.state_dict().items():
            for k, v in st.items():
                out[f"{name}/{table}/{k}"] = v
    return out


def _pod(rt, plan: dict, inputs) -> dict:
    from parameter_server_tpu_torch.parallel.trainer import PodTrainer
    from parameter_server_tpu_torch.utils.config import load_config
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    cfg = load_config(plan["cfg"])
    t = PodTrainer(cfg, runtime=rt, reporter=ProgressReporter(print_fn=lambda *_: None))
    b = {f: torch.from_numpy(inputs[f"d{rt.mesh.d}_{f}"]) for f in CSR_FULL_FIELDS}
    out = {}
    for i, ckpt in enumerate(plan["ckpts"]):
        meta = t.load(ckpt)
        ev = t.evaluate_files(plan["val"])
        out.update({
            f"{i}/examples_seen": np.int64(meta.get("examples_seen", -1)),
            f"{i}/auc": np.float64(ev["auc"]), f"{i}/logloss": np.float64(ev["logloss"]),
            f"{i}/examples": np.int64(ev["examples"]),
            f"{i}/probs": t.predict_fn(t.state, b).numpy(),
            f"{i}/weights": t.full_weights(),
        })
    return out


def _quiet():
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    return ProgressReporter(print_fn=lambda *_: None)


_SLOTS: dict = {}


def _count_pushes() -> dict:
    """Record the slot count of every fused push the SPMD tier makes (on
    the CPU, the kernels' plain versions under the same names), from now
    on; the lists start empty."""
    from parameter_server_tpu_torch.parallel import spmd

    if _SLOTS:
        for v in _SLOTS.values():
            v.clear()
        return _SLOTS
    slots = _SLOTS
    slots.update({"ftrl_push": [], "adagrad_push": []})

    def counting(name, fn):
        def run(a, b, idx, g, **kw):
            slots[name].append(int(idx.shape[0]))
            return fn(a, b, idx, g, **kw)
        return run

    for name in slots:
        setattr(spmd, name, counting(name, getattr(spmd, name)))
    return slots


def _csr_stream(inputs, key: str) -> list:
    from parameter_server_tpu_torch.data.batch import CSRBatch

    out = []
    while f"{key}/b{len(out)}/values" in inputs:
        pre = f"{key}/b{len(out)}/"
        out.append(CSRBatch(
            **{f: inputs[pre + f] for f in ("unique_keys", "local_ids", "row_ids", "values",
                                             "labels", "example_mask", "row_splits")},
            **{f: int(inputs[pre + f]) for f in ("num_examples", "num_unique",
                                                  "num_entries")}))
    return out


def _wd(rt, plan: dict, inputs) -> dict:
    from parameter_server_tpu_torch.models.wide_deep import WideDeep

    slots = _count_pushes()
    out = {}
    for case in plan["wd_cases"]:
        name = case["name"]
        rt.mesh.quant_audit = {} if case["push_mode"] == "quantized" else None
        app = WideDeep(case["num_keys"], mesh=rt.mesh, reporter=_quiet(), **case["kw"])
        batches = _csr_stream(inputs, case["stream"])
        for k in slots:
            slots[k].clear()
        for _ in range(case.get("epochs", 1)):
            app.train(batches, report_every=case.get("report_every", 1))
        for k, v in slots.items():
            out[f"{name}/slots_{k}"] = np.array(v, dtype=np.int64)
        hist = app.reporter.history
        for col in ("examples", "objv", "auc"):
            out[f"{name}/hist_{col}"] = np.array([r[col] for r in hist], dtype=np.float64)
        out[f"{name}/push_calls"] = np.int64(app._push_calls)
        y, p = app.predict(batches[:case.get("predict", 2)])
        out[f"{name}/predict_y"], out[f"{name}/predict_p"] = y, p
        st = app.state_dict()
        for table in ("wide", "emb"):
            for k, v in st[table].items():
                out[f"{name}/{table}/{k}"] = v
        for i, layer in enumerate(st["mlp"]):
            for k, v in layer.items():
                out[f"{name}/mlp{i}/{k}"] = v
        for i, (param, st_) in enumerate(app.opt.state_dict()["state"].items()):
            for k, v in st_.items():
                out[f"{name}/adam{i}/{k}"] = v.numpy()
        if case.get("dump"):
            app.dump_model(str(Path(plan["out"]) / f"{name}.npz"))
        if rt.mesh.quant_audit is not None:
            out[f"{name}/audit"] = np.array([int(rt.mesh.quant_audit[k]) for k in (
                "pushes", "off_grid", "scale_mismatch")])
    return out


def _w2v(rt, plan: dict, inputs) -> dict:
    from parameter_server_tpu_torch.models.word2vec import Word2Vec

    slots = _count_pushes()
    out = {}
    for case in plan["w2v_cases"]:
        name = case["name"]
        app = Word2Vec(case["vocab"], mesh=rt.mesh, reporter=_quiet(), **case["kw"])
        if case.get("files"):
            losses = [app.train_files(case["files"], batch_size=case["batch_size"],
                                      block_tokens=case["block_tokens"], seed=case["seed"],
                                      pipeline_depth=0)]
            out[f"{name}/pairs"] = np.int64(app.reporter.history[-1]["examples"])
        else:
            losses = [app.train_epoch(inputs[case["corpus"]], batch_size=case["batch_size"],
                                      seed=ep) for ep in range(case.get("epochs", 1))]
        out[f"{name}/loss"] = np.array(losses)
        for table, st in app.state_dict().items():
            for k, v in st.items():
                out[f"{name}/{table}/{k}"] = v
        out[f"{name}/embeddings"] = app.embeddings()
    # the repeated-ids route: no fused push, on every case
    out["w2v_fused_pushes"] = np.int64(sum(len(v) for v in slots.values()))
    return out


def _darlin(rt, plan: dict, inputs) -> dict:
    from parameter_server_tpu_torch.models.darlin import Darlin
    from parameter_server_tpu_torch.utils.config import PSConfig

    out = {}
    for case in plan["darlin_cases"]:
        name = case["name"]
        cfg = PSConfig()
        cfg.data.num_keys = case["num_keys"]
        cfg.solver.algo = "darlin"
        for section, fields in case["cfg"].items():
            for k, v in fields.items():
                setattr(getattr(cfg, section), k, v)
        app = Darlin(cfg, reporter=_quiet(), mesh=rt.mesh)
        res = app.fit(_csr_stream(inputs, case["stream"]), shuffle_blocks=case["shuffle"])
        out[f"{name}/history"] = np.array(res["history"])
        for k in ("objv", "nnz_w", "train_auc", "iters"):
            out[f"{name}/{k}"] = np.float64(res[k])
        out[f"{name}/w"], out[f"{name}/pred"] = app.w, app.pred
    return out


def _backend(rt, plan: dict, inputs) -> dict:
    from parameter_server_tpu_torch.kv.updaters import Ftrl, Sgd
    from parameter_server_tpu_torch.parallel.backend import train_linear
    from parameter_server_tpu_torch.parallel.meshbackend import MeshBackend

    out = {}
    mb = MeshBackend(Sgd(eta=0.5), plan["odd_keys"], mesh=rt.mesh)
    keys = np.asarray(plan["odd_push"], dtype=np.int64)
    mb.push(keys, np.ones(len(keys), np.float32))
    out["odd/rows"] = np.array([mb._rows, mb._shard])
    out["odd/weights"] = mb.weights()
    out["odd/pull"] = mb.pull(keys)
    out["odd/pull_async"] = mb.pull_async(keys).result(30)
    mb.close()
    for quant in ("off", "int8"):
        mb = MeshBackend(Ftrl(**plan["ftrl"]), plan["num_keys"], mesh=rt.mesh, quant=quant)
        res = train_linear(mb, inputs["kb"], inputs["y"], plan["batch"])
        out[f"train_{quant}/probs"] = res["probs"]
        out[f"train_{quant}/auc"] = np.array(res["auc"])
        out[f"train_{quant}/weights"] = mb.weights()
        mb.close()
    mb = MeshBackend(Sgd(eta=1.0), 256, mesh=rt.mesh, quant="int8", quant_seg=32)
    tkeys = np.arange(1, 129, dtype=np.int64)
    for i in range(6):
        mb.push(tkeys, inputs[f"tele{i}"])
    mb.flush()
    out["tele/weights"] = mb.weights()[tkeys]
    out["tele/residual"] = mb.residual_rows(tkeys)
    mb.close()
    return out


def _pool(rt, plan: dict, inputs) -> dict:
    from parameter_server_tpu_torch.parallel.chaos import FaultPlan
    from parameter_server_tpu_torch.parallel.control import Coordinator
    from parameter_server_tpu_torch.parallel.trainer import PodTrainer
    from parameter_server_tpu_torch.utils.config import load_config

    coord = None
    if rt.process_index == 0:
        host, port = plan["pool"].rsplit(":", 1)
        coord = Coordinator(host, int(port), fault_plan=FaultPlan.parse(
            plan["fault_plan"], seed=plan["fault_seed"]))
    try:
        t = PodTrainer(load_config(plan["cfg"]), runtime=rt, reporter=_quiet())
        last = t.train_files_dynamic(plan["files"], plan["pool"], report_every=10**6)
        out = {"weights": t.full_weights(), "examples_seen": np.int64(t.examples_seen),
               "objv": np.float64(last["objv"])}
        rt.barrier()  # every rank finished with the pool
        if coord is not None:
            st = coord._pool.stats()
            out["pool"] = np.array([st[k] for k in ("pending", "active", "done", "attempts")])
            out["faults_fired"] = np.int64(sum(
                v for k, v in (coord.server.fault_stats() or {}).items()
                if k != "frames"))
    finally:
        if coord is not None:
            coord.stop()
    return out


def main(argv: list[str]) -> int:
    if argv[0] == "cli":  # python tests/_torch_rank.py cli <cli train arguments>
        from parameter_server_tpu_torch import cli

        code = cli.main(argv[1:])
        if "jax" in sys.modules:
            raise SystemExit("a rank of the port loaded jax")
        return code
    mode, plan_path, rank, world, port = argv
    torch.set_num_threads(1)
    plan = json.loads(Path(plan_path).read_text())
    inputs = dict(np.load(plan["inputs"])) if plan.get("inputs") else {}
    d, kv = plan["mesh"]
    if plan.get("cfg"):
        from parameter_server_tpu_torch.utils.config import load_config

        rt = runtime.init(f"127.0.0.1:{port}", int(world), int(rank),
                          cfg=load_config(plan["cfg"]), device="cpu")
    else:
        rt = runtime.init(f"127.0.0.1:{port}", int(world), int(rank), kv_shards=kv,
                          data_shards=d, device="cpu")
    try:
        modes = {"spmd": _spmd, "mf": _mf, "pod": _pod, "wd": _wd, "w2v": _w2v,
                 "darlin": _darlin, "backend": _backend, "pool": _pool}
        out = {}
        for m in mode.split("+"):
            out.update(modes[m](rt, plan, inputs))
    finally:
        rt.shutdown()
    if "jax" in sys.modules:
        raise SystemExit("a rank of the port loaded jax")
    np.savez(Path(plan["out"]) / f"rank{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
