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
  files and predicts its data shard's batch (``d<shard>_<field>``).

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
        out = {"spmd": _spmd, "mf": _mf, "pod": _pod}[mode](rt, plan, inputs)
    finally:
        rt.shutdown()
    if "jax" in sys.modules:
        raise SystemExit("a rank of the port loaded jax")
    np.savez(Path(plan["out"]) / f"rank{rank}.npz", **out)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
