"""Command-line entry point of the port.

The six apps: ``linear_method`` (its streaming solvers and the ``darlin``
batch solver), ``matrix_fac``, ``wide_deep``, ``word2vec``,
``graph_partition`` and ``sketch``. A config file picks the app and its
solver, flags pick the run mode, ``--device`` the device (``cuda`` unless
``cpu`` is asked for; ``sketch`` is host code and ignores it). Config files
and flags are those of the JAX package's CLI; every other option and
subcommand exits with "not ported yet".

A mesh larger than 1x1 (``parallel.data_shards`` x ``parallel.kv_shards``)
runs ``linear_method`` through ``PodTrainer`` (or, with ``solver.algo =
"darlin"``, the distributed darlin solver) and MF, W&D and word2vec
through their mesh paths, one process per mesh cell: start D x KV
processes with the same ``--coordinator host:port``, ``--num_processes``
D x KV and each its own ``--process_id``. ``--dist_backend`` picks the
collectives (``nccl`` on the card, ``gloo`` on the CPU by default; ranks
that share one card need ``gloo``). Rank 0 writes ``--model_out`` and
``--ckpt_dir``. (The JAX package runs mesh darlin on one process's device
mesh and refuses ``--coordinator``; a mesh here is a world of ranks.)

``convert`` parses the config's files once into the columnar block cache
(``data/blockcache.py``) that darlin reads instead of the text when
``data.cache_dir`` names it; either package's cache loads in the other.

Usage:
  python -m parameter_server_tpu_torch.cli train  --app_file cfg.json [--model_out m.txt|m.npz|m.npy] [--device cpu]
      [--coordinator 127.0.0.1:29500 --num_processes 4 --process_id 0 [--dist_backend gloo]]
  python -m parameter_server_tpu_torch.cli convert --app_file cfg.json [--cache_dir d]
  python -m parameter_server_tpu_torch.cli evaluate --app_file cfg.json --model m.txt|m.npz [--device cpu]
  python -m parameter_server_tpu_torch.cli backend --app_file cfg.json [--examples N --batch B --nnz K --servers S] [--device cpu]
  python -m parameter_server_tpu_torch.cli launch --app_file cfg.json --num_servers 2 --num_workers 2 [--model_out m.txt] [--device cpu]
  python -m parameter_server_tpu_torch.cli node --role scheduler|server|worker --rank R --scheduler host:port
      --num_servers S --num_workers W --app_file cfg.json [--model_out m.txt] [--ckpt_dir d] [--device cpu]

``backend`` drives the canonical linear trainer loop (``parallel/backend.py``
``train_linear``) through the transport the ``[mesh] backend`` setting names:
``socket`` starts ``--servers`` loopback shard servers in this process,
``mesh`` joins a world of one (NCCL on the card) and holds the table on it.
It prints one JSON object (AUC, ex/s, push payload MB, the backend's stats).

``launch`` runs the ``linear_method`` cluster on this host (ref:
script/local.sh): a scheduler, ``--num_servers`` shard servers and
``--num_workers`` workers, each a ``node`` process, all on ``--device``.
It prints the scheduler's result (merged progress, the servers' stats,
the workload ledger, dead workers, validation AUC) with each node's
report. ``node`` runs one of them; a server or a worker prints its report
(its kernel launches) at exit.
"""

from __future__ import annotations

import argparse
import json
import sys

from parameter_server_tpu_torch.utils.config import PSConfig, load_config

#: subcommands of the JAX package's CLI that the port does not have yet
NOT_PORTED_CMDS = (
    "stats", "top", "ranges", "audit",
    "whylate", "postmortem", "lint", "check", "verify", "explore",
)

_KNOWN_APPS = (
    "linear_method", "graph_partition", "sketch", "matrix_fac", "word2vec",
    "wide_deep",
)


def _not_ported(what: str) -> SystemExit:
    return SystemExit(f"{what} is not ported yet to parameter_server_tpu_torch")


def _build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="parameter_server_tpu_torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    tr = sub.add_parser("train", help="train the configured app")
    tr.add_argument("--app_file", required=True, help="JSON/TOML PSConfig")
    tr.add_argument("--model_out", default="", help="text model dump path")
    tr.add_argument("--ckpt_dir", default="", help="checkpoint directory")
    tr.add_argument("--resume", action="store_true", help="resume from ckpt_dir")
    tr.add_argument(
        "--report_interval", type=int, default=50, help="steps between reports"
    )
    tr.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    # a sharded run: one process per mesh cell
    tr.add_argument("--coordinator", default="", help="host:port of rank 0's store")
    tr.add_argument("--num_processes", type=int, default=1, help="D x KV")
    tr.add_argument("--process_id", type=int, default=0, help="this rank")
    tr.add_argument(
        "--dist_backend", default="", choices=("", "nccl", "gloo"),
        help="collectives: nccl on cuda, gloo on cpu by default",
    )
    tr.add_argument(
        "--audit_quantized", action="store_true",
        help="hold every quantized push to its rounding bounds; counts in the result",
    )
    # options of the JAX CLI's pool and tracing paths: accepted so command
    # lines stay interchangeable, refused when set
    tr.add_argument("--pool_coordinator", default="")
    tr.add_argument("--pool_serve", action="store_true")
    tr.add_argument("--trace_dir", default="")

    cv = sub.add_parser(
        "convert",
        help="offline text -> columnar block cache conversion "
        "(ref: data/text2proto + SlotReader's parse-once cache)",
    )
    cv.add_argument("--app_file", required=True, help="JSON/TOML PSConfig")
    cv.add_argument(
        "--cache_dir", default="",
        help="output cache dir (defaults to the config's data.cache_dir; "
        "if you override it here, set data.cache_dir to the same path in "
        "the TRAINING config or the cache will never be read)",
    )

    ev = sub.add_parser("evaluate", help="evaluate a dumped model")
    ev.add_argument("--app_file", required=True)
    ev.add_argument("--model", required=True, help="model dump (text; npz for wide_deep)")
    ev.add_argument("--data", nargs="*", default=None, help="override val files")
    ev.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    bk = sub.add_parser(
        "backend",
        help="drive the canonical linear trainer loop through the "
        "configured KV backend ([mesh] section, parallel/backend.py): "
        "'mesh' holds the table on a world of one, 'socket' spins loopback "
        "ShardServers — one synthetic workload, JSON metrics (AUC, ex/s, "
        "payload bytes) on stdout",
    )
    bk.add_argument("--app_file", required=True, help="JSON/TOML PSConfig")
    bk.add_argument(
        "--examples", type=int, default=1 << 14,
        help="synthetic examples to stream through the loop",
    )
    bk.add_argument("--batch", type=int, default=2048)
    bk.add_argument("--nnz", type=int, default=16, help="features/example")
    bk.add_argument(
        "--servers", type=int, default=2,
        help="socket backend only: in-process loopback shard servers",
    )
    bk.add_argument("--device", default="cuda", help="cuda (default) or cpu")

    # the multi-process tier (ref: main.cc role flags + script/local.sh)
    nd = sub.add_parser("node", help="run one scheduler/server/worker process")
    nd.add_argument("--role", required=True, choices=("scheduler", "server", "worker"))
    nd.add_argument("--rank", type=int, default=0, help="ref: -my_node id")
    nd.add_argument("--scheduler", required=True, help="host:port (ref: -scheduler)")
    nd.add_argument("--num_servers", type=int, required=True)
    nd.add_argument("--num_workers", type=int, required=True)
    nd.add_argument("--app_file", required=True)
    nd.add_argument("--model_out", default="")
    nd.add_argument(
        "--bind_host", default="127.0.0.1",
        help="server bind address (0.0.0.0 to accept remote workers)",
    )
    nd.add_argument(
        "--advertise_host", default="",
        help="routable hostname published to the coordinator (defaults to bind_host)",
    )
    nd.add_argument(
        "--ckpt_dir", default="",
        help="server recovery dir: resume this range's dump if present; "
        "periodic dumps per [fault] server_ckpt_interval_s",
    )
    nd.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    nd.add_argument(
        "--fault_plan", default="",
        help="chaos spec (parallel/chaos.py) armed on this node's RpcServers; "
        "wins over [fault] fault_plan and PS_FAULT_PLAN",
    )
    nd.add_argument("--fault_seed", type=int, default=0)
    # the JAX CLI's tracing option: accepted so command lines stay
    # interchangeable, refused when set
    nd.add_argument("--trace_dir", default="")

    la = sub.add_parser("launch", help="spawn a local multi-process run (ref: script/local.sh)")
    la.add_argument("--app_file", required=True)
    la.add_argument("--num_servers", type=int, default=1)
    la.add_argument("--num_workers", type=int, default=1)
    la.add_argument("--model_out", default="")
    la.add_argument("--device", default="cuda", help="cuda (default) or cpu, for every node")
    la.add_argument(
        "--fault_plan", default="",
        help="chaos spec armed on every spawned node (PS_FAULT_PLAN)",
    )
    la.add_argument("--fault_seed", type=int, default=0)
    la.add_argument("--trace_dir", default="")
    la.add_argument("--blackbox_dir", default="")
    return p


def _check_ported(cfg: PSConfig) -> None:
    """Refuse the config settings of paths the port does not have yet."""
    if cfg.app not in _KNOWN_APPS:
        raise SystemExit(f"unknown app {cfg.app!r}; known: {sorted(_KNOWN_APPS)}")
    if cfg.trace.trace_dir or cfg.profile.hz > 0 or cfg.timeseries.metrics_port:
        raise _not_ported("tracing, profiling and the metrics endpoint")


def run_train(cfg: PSConfig, args: argparse.Namespace) -> dict:
    _check_ported(cfg)
    if args.pool_coordinator or args.pool_serve:
        raise _not_ported("the dynamic workload pool (--pool_*)")
    if args.trace_dir:
        raise _not_ported("--trace_dir")
    if not cfg.data.files:
        raise SystemExit("config data.files is empty")
    # graph_partition and sketch: one process, as the JAX package runs
    # them (mesh settings and flags unread)
    if cfg.app == "graph_partition":
        return _run_train_graph(cfg, args)
    if cfg.app == "sketch":
        return _run_train_sketch(cfg, args)
    darlin = cfg.app == "linear_method" and cfg.solver.algo == "darlin"
    if darlin and args.resume:
        raise SystemExit(
            "--resume is not supported for the darlin batch solver "
            "(it restarts from its cached column blocks)"
        )
    sharded = bool(args.coordinator) or cfg.parallel.data_shards * cfg.parallel.kv_shards > 1
    if sharded and not darlin:
        from parameter_server_tpu_torch.parallel.spmd import PUSH_MODES

        # the apps' own refusal (the JAX apps raise it building the mesh
        # step), made before this rank joins the world
        modes = {"word2vec": ("per_worker", "aggregate"),
                 "matrix_fac": ("per_worker", "aggregate")}.get(cfg.app, PUSH_MODES)
        if cfg.parallel.push_mode not in modes:
            raise ValueError(f"unknown push_mode {cfg.parallel.push_mode!r}")
    if not sharded and (args.num_processes != 1 or args.process_id or args.dist_backend
                        or args.audit_quantized):
        raise SystemExit("--num_processes/--process_id/--dist_backend/--audit_quantized "
                         "need a mesh (parallel.data_shards x kv_shards > 1) or --coordinator")
    if cfg.app in _APP_RUNNERS:
        if args.ckpt_dir or args.resume:
            raise SystemExit(f"the {cfg.app} app takes no --ckpt_dir/--resume")
        if sharded:
            return _run_sharded(cfg, args, _APP_RUNNERS[cfg.app])
        return _APP_RUNNERS[cfg.app](cfg, args)
    if darlin and sharded:
        return _run_sharded(cfg, args, _run_train_darlin)
    if darlin:
        return _run_train_darlin(cfg, args)
    if sharded:
        return _run_sharded(cfg, args, _run_train_pod)

    from parameter_server_tpu_torch.models.linear import LinearMethod

    app = LinearMethod(cfg, device=args.device)
    if args.resume:
        if not args.ckpt_dir:
            raise SystemExit("--resume requires --ckpt_dir")
        app.load(args.ckpt_dir)
    last = (
        app.train_files(cfg.data.files, report_every=args.report_interval) or {}
    )  # reader applies cfg epochs
    if args.ckpt_dir:
        app.save(args.ckpt_dir)
    if args.model_out:
        app.dump_model(args.model_out)
    if cfg.data.val_files:
        from parameter_server_tpu_torch.data.batch import eval_builder
        from parameter_server_tpu_torch.data.reader import MinibatchReader

        ev = app.evaluate(
            MinibatchReader(cfg.data.val_files, cfg.data.format, eval_builder(cfg))
        )
        last = {**last, **{f"val_{k}": v for k, v in ev.items()}}
    return last


def _run_sharded(cfg: PSConfig, args: argparse.Namespace, run) -> dict:
    """Join the world (``parallel.runtime.init``), run ``run(cfg, args, rt)``
    on this rank's mesh cell, and tear the world down, on errors too, so a
    failed rank exits instead of leaving its peers in a collective."""
    from parameter_server_tpu_torch.ops import adagrad_kernels, ftrl_kernels
    from parameter_server_tpu_torch.parallel import runtime as runtime_mod

    rt = runtime_mod.init(
        args.coordinator or None, args.num_processes, args.process_id, cfg=cfg,
        device=args.device, backend=args.dist_backend or None,
    )
    if args.audit_quantized:
        rt.mesh.quant_audit = {}
    try:
        out = dict(run(cfg, args, rt))
        out["process_index"] = rt.process_index
        out["mesh"] = {"data": rt.data_shards, "kv": rt.kv_shards}
        # this rank's kernel launches (the counts start at 0 in the process)
        # and the bytes it handed to collectives
        out["launches"] = {**ftrl_kernels.LAUNCHES, **adagrad_kernels.LAUNCHES}
        out["payload_bytes"] = dict(rt.mesh.payload_bytes)
        if args.audit_quantized:
            # the quantized pushes and their rounding faults (spmd.audit_rounding)
            out["quant_audit"] = {k: int(v) for k, v in rt.mesh.quant_audit.items()}
        return out
    finally:
        rt.shutdown()


def _run_train_pod(cfg: PSConfig, args: argparse.Namespace, rt) -> dict:
    """linear_method on a mesh: PodTrainer over this rank's cell. Every rank
    gathers the weights for ``--model_out``; rank 0 writes them."""
    from parameter_server_tpu_torch.parallel.trainer import PodTrainer
    from parameter_server_tpu_torch.utils.checkpoint import dump_weights_text

    trainer = PodTrainer(cfg, runtime=rt)
    if args.resume:
        if not args.ckpt_dir:
            raise SystemExit("--resume requires --ckpt_dir")
        trainer.load(args.ckpt_dir)
    out = dict(trainer.train_files(cfg.data.files, report_every=args.report_interval) or {})
    if args.ckpt_dir:
        trainer.save(args.ckpt_dir)
    if args.model_out:
        w = trainer.full_weights()
        if rt.process_index == 0:
            dump_weights_text(w.ravel(), args.model_out)
    if cfg.data.val_files:
        ev = trainer.evaluate_files(cfg.data.val_files)
        out.update({f"val_{k}": v for k, v in ev.items()})
    return out


def _run_train_graph(cfg: PSConfig, args: argparse.Namespace) -> dict:
    """The graph_partition app on ``--device``; --model_out is the
    ``feature\tpartition`` text dump."""
    from parameter_server_tpu_torch.models.graph_partition import GraphPartition

    app = GraphPartition(cfg, device=args.device)
    out = app.partition_files(cfg.data.files)
    if args.model_out:
        out["features_dumped"] = app.dump_partition(args.model_out)
    return out


def _run_train_sketch(cfg: PSConfig, args: argparse.Namespace) -> dict:
    """The sketch app (host code); --model_out is the heavy-hitter dump."""
    from parameter_server_tpu_torch.models.sketch import SketchApp

    app = SketchApp(cfg)
    app.add_files(cfg.data.files)
    out = app.result()
    if args.model_out:
        out["dumped"] = app.dump_heavy_hitters(args.model_out)
    return out


def _run_train_darlin(cfg: PSConfig, args: argparse.Namespace, runtime=None) -> dict:
    """The darlin batch solver on one device or, with ``runtime``, on this
    rank's mesh cell. With ``data.cache_dir`` set the first run parses the
    text and writes the columnar block cache and later runs map it (on a
    mesh rank 0 writes it and the other ranks wait, then read it). Rank 0
    writes the checkpoint (``{"w"}``, the JAX layout) and the text model."""
    import numpy as np

    from parameter_server_tpu_torch.data.batch import BatchBuilder
    from parameter_server_tpu_torch.data.blockcache import cached_column_blocks
    from parameter_server_tpu_torch.data.reader import MinibatchReader
    from parameter_server_tpu_torch.models import metrics as M
    from parameter_server_tpu_torch.models.darlin import Darlin
    from parameter_server_tpu_torch.utils.checkpoint import dump_weights_text, save_checkpoint

    lead = runtime is None or runtime.process_index == 0
    if runtime is not None and cfg.data.cache_dir:
        if lead:
            cb = cached_column_blocks(cfg)
        runtime.barrier()
        if not lead:
            cb = cached_column_blocks(cfg)
    else:
        cb = cached_column_blocks(cfg)
    app = Darlin(cfg, mesh=runtime.mesh if runtime is not None else None,
                 device=args.device)
    res = app.fit_blocks(cb)
    if lead and args.ckpt_dir:
        save_checkpoint(args.ckpt_dir, {"w": app.w},
                        meta={"algo": "darlin", "num_keys": cfg.data.num_keys})
    if lead and args.model_out:
        dump_weights_text(app.w, args.model_out)
    out = {k: res[k] for k in ("objv", "iters", "nnz_w", "train_auc")}
    if cfg.data.val_files:
        builder = BatchBuilder(
            num_keys=cfg.data.num_keys,
            batch_size=cfg.solver.minibatch,
            max_nnz_per_example=cfg.data.max_nnz_per_example,
        )
        val = list(MinibatchReader(cfg.data.val_files, cfg.data.format, builder))
        p = app.predict(val)
        y = np.concatenate([b.labels[: b.num_examples] for b in val])
        out["val_auc"] = M.auc(y, p)
        out["val_logloss"] = M.logloss(y, p)
    return out


def _run_train_mf(cfg: PSConfig, args: argparse.Namespace, runtime=None) -> dict:
    """The matrix_fac app: train on ``user item rating`` files, report the
    validation RMSE, dump the factors as an npz (on a mesh: ``runtime``'s,
    and rank 0 writes the dump)."""
    import numpy as np

    from parameter_server_tpu_torch.models.matrix_fac import (
        MatrixFactorization,
        iter_rating_blocks,
    )

    m = cfg.mf
    app = MatrixFactorization(
        m.num_users, m.num_items, rank=m.rank, eta=m.eta, l2=m.l2,
        algo=m.algo, seed=cfg.seed, push_mode=cfg.parallel.push_mode,
        max_delay=max(cfg.solver.max_delay, 0),
        steps_per_call=cfg.solver.steps_per_call, device=args.device,
        mesh=runtime.mesh if runtime is not None else None,
    )
    rmse = app.train_files(
        cfg.data.files, batch_size=m.batch_size,
        epochs=max(1, cfg.solver.epochs), block_lines=m.block_lines,
        seed=cfg.seed,
    )
    out: dict = {"train_rmse": rmse, "rank": m.rank}
    if cfg.data.val_files:
        sse, n = 0.0, 0
        for us, it, rt in iter_rating_blocks(cfg.data.val_files, m.block_lines):
            p = app.predict(us, it)
            sse += float(((p - rt) ** 2).sum())
            n += len(rt)
        if n == 0:
            raise SystemExit(
                f"no rating triples parsed from val_files "
                f"{cfg.data.val_files}: expected 'user item rating' lines"
            )
        out["val_rmse"] = float(np.sqrt(sse / n))
        out["val_examples"] = n
    if args.model_out:
        st = app.state_dict()
        if runtime is None or runtime.process_index == 0:
            np.savez(args.model_out, user_factors=st["user"]["w"],
                     item_factors=st["item"]["w"])
        out["model_out"] = args.model_out
    return out


def _run_train_w2v(cfg: PSConfig, args: argparse.Namespace, runtime=None) -> dict:
    """The word2vec app: stream the token files (``.npy`` or whitespace-
    separated ids), report the mean loss, save the input embeddings as a
    ``.npy`` (on a mesh: ``runtime``'s, and rank 0 writes the dump)."""
    import numpy as np

    from parameter_server_tpu_torch.models.word2vec import Word2Vec

    w = cfg.w2v
    app = Word2Vec(
        vocab_size=w.vocab_size, dim=w.dim, eta=w.eta,
        num_negatives=w.negatives, window=w.window, seed=cfg.seed,
        max_delay=max(cfg.solver.max_delay, 0), push_mode=cfg.parallel.push_mode,
        steps_per_call=cfg.solver.steps_per_call, device=args.device,
        mesh=runtime.mesh if runtime is not None else None,
    )
    # one call: train_files runs its epoch loop and counts the vocabulary once
    mean = app.train_files(
        cfg.data.files, batch_size=w.batch_size, epochs=max(1, cfg.solver.epochs),
        block_tokens=w.block_tokens, seed=cfg.seed,
    )
    out: dict = {"mean_loss": mean, "vocab_size": w.vocab_size, "dim": w.dim}
    if args.model_out:
        emb = app.embeddings()
        if runtime is None or runtime.process_index == 0:
            np.save(args.model_out, emb)
        out["model_out"] = args.model_out
    return out


def _run_train_wd(cfg: PSConfig, args: argparse.Namespace, runtime=None) -> dict:
    """The wide_deep app: streaming file-driven training over the
    linear_method text formats, validation AUC, an npz dump (on a mesh:
    ``runtime``'s; every rank parses every file, evaluates the validation
    files, and rank 0 writes the dump)."""
    from parameter_server_tpu_torch.data.batch import eval_builder, training_builder
    from parameter_server_tpu_torch.models.wide_deep import WideDeep

    app = WideDeep.from_config(cfg, device=args.device,
                               mesh=runtime.mesh if runtime is not None else None)
    out = dict(app.train_files(
        cfg.data.files, cfg.data.format, training_builder(cfg),
        epochs=max(1, cfg.solver.epochs), report_every=args.report_interval,
    ) or {})
    out.update({"emb_dim": cfg.wd.emb_dim, "hidden": list(cfg.wd.hidden)})
    if cfg.data.val_files:
        ev = app.evaluate_files(cfg.data.val_files, cfg.data.format, eval_builder(cfg))
        out.update({f"val_{k}": v for k, v in ev.items()})
    if args.model_out:
        out["model_out"] = app.dump_model(args.model_out)
    return out


_APP_RUNNERS = {
    "matrix_fac": _run_train_mf, "word2vec": _run_train_w2v, "wide_deep": _run_train_wd,
}


def run_convert(cfg: PSConfig, args: argparse.Namespace) -> dict:
    """Offline conversion (ref: the text2proto tool + SlotReader's
    parse-once cache): parse the config's text files once and populate the
    columnar block cache; later solver runs map it instead of re-parsing."""
    from pathlib import Path

    from parameter_server_tpu_torch.data.blockcache import cached_column_blocks

    override_note = ""
    if args.cache_dir:
        if cfg.data.cache_dir != args.cache_dir:
            # a cache the training config doesn't point at is never read
            override_note = (
                "config data.cache_dir is "
                f"{cfg.data.cache_dir!r}; training will only use this "
                "cache if you point data.cache_dir at it"
            )
        cfg.data.cache_dir = args.cache_dir
    if not cfg.data.cache_dir:
        raise SystemExit("convert needs --cache_dir or config data.cache_dir")
    if not cfg.data.files:
        raise SystemExit("config data.files is empty")
    cb = cached_column_blocks(cfg)
    # the entry count comes from the cache sidecar: recomputing it would
    # page the whole (mapped) values array in just to rederive a stored stat
    meta = json.loads((Path(cfg.data.cache_dir) / "meta.json").read_text())
    out = {
        "cache_dir": cfg.data.cache_dir,
        "num_examples": cb.num_examples,
        "n_blocks": cb.n_blocks,
        "block_size": cb.block_size,
        "entries": meta["nnz"],
    }
    if override_note:
        out["warning"] = override_note
    return out


def run_evaluate(cfg: PSConfig, args: argparse.Namespace) -> dict:
    from parameter_server_tpu_torch.models.evaluation import evaluate_model

    _check_ported(cfg)
    if cfg.app not in ("linear_method", "wide_deep"):
        raise _not_ported(f"evaluate for app {cfg.app!r}")
    files = args.data if args.data else (cfg.data.val_files or cfg.data.files)
    if not files:
        raise SystemExit("no evaluation files (config val_files/files or --data)")
    if cfg.app == "wide_deep":
        # the W&D dump is an npz (wide + embedding + MLP), not a text vector
        from parameter_server_tpu_torch.data.batch import eval_builder
        from parameter_server_tpu_torch.models.wide_deep import evaluate_dump

        return evaluate_dump(args.model, files, cfg.data.format, eval_builder(cfg),
                             device=args.device)
    return evaluate_model(
        args.model,
        files,
        cfg.data.format,
        cfg.data.num_keys,
        batch_size=cfg.solver.minibatch,
        max_nnz_per_example=cfg.data.max_nnz_per_example,
        device=args.device,
    )


def run_backend(cfg: PSConfig, args: argparse.Namespace) -> dict:
    """One synthetic linear workload through the configured PSBackend
    (the ``[mesh]`` section picks the transport): the canonical
    ``train_linear`` loop that the backend-parity tests also drive. The
    same workload, keys and JSON keys as the JAX package's ``cli
    backend``."""
    import time

    import numpy as np

    from parameter_server_tpu_torch.models.linear import updater_from_config
    from parameter_server_tpu_torch.parallel.backend import (
        local_socket_backend,
        make_backend,
        train_linear,
    )
    from parameter_server_tpu_torch.utils.metrics import wire_counters

    num_keys = cfg.data.num_keys
    n = max(args.examples // args.batch, 1) * args.batch
    rng = np.random.default_rng(cfg.seed or 7)
    w_true = rng.normal(size=num_keys - 1)
    kb = rng.integers(0, num_keys - 1, size=(n, args.nnz))
    logits = w_true[kb].sum(axis=1) / np.sqrt(args.nnz)
    y = (rng.random(n) < 1 / (1 + np.exp(-logits))).astype(np.float64)

    if cfg.mesh.backend == "socket":
        backend = local_socket_backend(
            lambda: updater_from_config(cfg), num_keys,
            num_servers=args.servers, cfg=cfg, device=args.device,
        )
    else:
        backend = make_backend(cfg, device=args.device)
    pay0 = wire_counters.get("mesh_push_payload_bytes") + wire_counters.get(
        "wire_push_payload_bytes"
    )
    try:
        t0 = time.perf_counter()
        out = train_linear(backend, kb, y, args.batch)
        dt = time.perf_counter() - t0
        payload = (
            wire_counters.get("mesh_push_payload_bytes")
            + wire_counters.get("wire_push_payload_bytes")
            - pay0
        )
        return {
            "backend": cfg.mesh.backend,
            "auc": round(out["auc"], 4),
            "examples": out["examples"],
            "ex_per_sec": round(out["examples"] / dt, 1),
            "push_payload_mb": round(payload / 1e6, 3),
            "stats": backend.stats(),
        }
    finally:
        backend.close()  # owned loopback servers shut down with it


def _check_cluster(cfg: PSConfig, args: argparse.Namespace) -> None:
    """Refuse what the cluster path (``node``, ``launch``) has not ported:
    other apps, tracing and the black box."""
    _check_ported(cfg)
    if cfg.app != "linear_method":
        raise _not_ported(f"the cluster path for app {cfg.app!r}")
    if args.trace_dir:
        raise _not_ported("--trace_dir")
    if getattr(args, "blackbox_dir", ""):
        raise _not_ported("--blackbox_dir")


def run_node_cmd(cfg: PSConfig, args: argparse.Namespace) -> dict:
    """One node of the cluster; the scheduler prints the run's result, a
    server or a worker its report."""
    from parameter_server_tpu_torch.parallel.multislice import run_node

    _check_cluster(cfg, args)
    if args.fault_plan:
        # the flag wins over the ambient env and the config file; the cfg
        # field carries it into every RpcServer this node builds
        cfg.fault.fault_plan = args.fault_plan
        cfg.fault.fault_seed = args.fault_seed
    return run_node(
        cfg, args.role, args.rank, args.scheduler, args.num_servers,
        args.num_workers, args.model_out, bind_host=args.bind_host,
        advertise_host=args.advertise_host, ckpt_dir=args.ckpt_dir,
        device=args.device,
    )


def run_launch(cfg: PSConfig, args: argparse.Namespace) -> dict:
    from parameter_server_tpu_torch.parallel.multislice import launch_local

    _check_cluster(cfg, args)
    return launch_local(
        args.app_file, args.num_servers, args.num_workers, args.model_out,
        device=args.device, fault_plan=args.fault_plan, fault_seed=args.fault_seed,
    )


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in NOT_PORTED_CMDS:
        raise _not_ported(f"the {argv[0]!r} subcommand")
    args = _build_parser().parse_args(argv)
    cfg = load_config(args.app_file)
    run = {"train": run_train, "convert": run_convert, "evaluate": run_evaluate,
           "backend": run_backend, "node": run_node_cmd, "launch": run_launch}[args.cmd]
    out = run(cfg, args)
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
