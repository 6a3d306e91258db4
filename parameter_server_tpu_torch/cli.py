"""Command-line entry point of the port.

The single-host ``linear_method`` app: a config file picks the solver, flags
pick the run mode, ``--device`` the device (``cuda`` unless ``cpu`` is
asked for). Config files and flags are those of the JAX package's CLI;
every other app, mesh or multi-host option and subcommand exits with
"not ported yet".

Usage:
  python -m parameter_server_tpu_torch.cli train  --app_file cfg.json [--model_out m.txt] [--device cpu]
  python -m parameter_server_tpu_torch.cli evaluate --app_file cfg.json --model m.txt [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import sys

from parameter_server_tpu_torch.utils.config import PSConfig, load_config

#: subcommands of the JAX package's CLI that the port does not have yet
NOT_PORTED_CMDS = (
    "node", "convert", "launch", "stats", "top", "ranges", "audit",
    "whylate", "postmortem", "lint", "check", "verify", "backend", "explore",
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
    # options of the JAX CLI's multi-host, pool and tracing paths: accepted
    # so command lines stay interchangeable, refused when set
    tr.add_argument("--coordinator", default="")
    tr.add_argument("--num_processes", type=int, default=1)
    tr.add_argument("--process_id", type=int, default=0)
    tr.add_argument("--pool_coordinator", default="")
    tr.add_argument("--pool_serve", action="store_true")
    tr.add_argument("--trace_dir", default="")

    ev = sub.add_parser("evaluate", help="evaluate a dumped model")
    ev.add_argument("--app_file", required=True)
    ev.add_argument("--model", required=True, help="text model dump")
    ev.add_argument("--data", nargs="*", default=None, help="override val files")
    ev.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p


def _check_ported(cfg: PSConfig) -> None:
    """Refuse the config settings of paths the port does not have yet."""
    if cfg.app not in _KNOWN_APPS:
        raise SystemExit(f"unknown app {cfg.app!r}; known: {sorted(_KNOWN_APPS)}")
    if cfg.app != "linear_method":
        raise _not_ported(f"app {cfg.app!r}")
    if cfg.solver.algo == "darlin":
        raise _not_ported("the darlin batch solver")
    if cfg.parallel.data_shards * cfg.parallel.kv_shards > 1:
        raise _not_ported("the SPMD mesh path (parallel.data_shards/kv_shards)")
    if cfg.trace.trace_dir or cfg.profile.hz > 0 or cfg.timeseries.metrics_port:
        raise _not_ported("tracing, profiling and the metrics endpoint")


def run_train(cfg: PSConfig, args: argparse.Namespace) -> dict:
    _check_ported(cfg)
    if (
        args.coordinator or args.num_processes != 1 or args.process_id
        or args.pool_coordinator or args.pool_serve
    ):
        raise _not_ported("multi-host training (--coordinator/--pool_*)")
    if args.trace_dir:
        raise _not_ported("--trace_dir")
    if not cfg.data.files:
        raise SystemExit("config data.files is empty")

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


def run_evaluate(cfg: PSConfig, args: argparse.Namespace) -> dict:
    from parameter_server_tpu_torch.models.evaluation import evaluate_model

    _check_ported(cfg)
    files = args.data if args.data else (cfg.data.val_files or cfg.data.files)
    if not files:
        raise SystemExit("no evaluation files (config val_files/files or --data)")
    return evaluate_model(
        args.model,
        files,
        cfg.data.format,
        cfg.data.num_keys,
        batch_size=cfg.solver.minibatch,
        max_nnz_per_example=cfg.data.max_nnz_per_example,
        device=args.device,
    )


def main(argv: list[str] | None = None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    if argv and argv[0] in NOT_PORTED_CMDS:
        raise _not_ported(f"the {argv[0]!r} subcommand")
    args = _build_parser().parse_args(argv)
    cfg = load_config(args.app_file)
    out = run_train(cfg, args) if args.cmd == "train" else run_evaluate(cfg, args)
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
