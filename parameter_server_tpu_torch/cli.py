"""Command-line entry point of the port.

The six apps: ``linear_method`` (its streaming solvers and the ``darlin``
batch solver), ``matrix_fac``, ``wide_deep``, ``word2vec``,
``graph_partition`` and ``sketch``. A config file picks the app and its
solver, flags pick the run mode, ``--device`` the device (``cuda`` unless
``cpu`` is asked for; ``sketch`` is host code and ignores it). Config files
and flags are those of the JAX package's CLI. ``lint`` runs pslint over
the port's own source (``analysis/``), ``check`` the protocol models and
their conformance to it, ``verify`` both (and, optionally, ``audit
--once`` and ``whylate --baseline``) with one tiered exit code, and
``explore`` a budgeted search of ``PS_SCHED`` schedule seeds against one
test, recording failing seeds in ``tests/torch_sched_corpus.json``.

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

``--pool_coordinator host:port`` (a mesh run only) takes the files from
the wire tier's dynamic workload pool instead of the static split;
``--pool_serve`` has rank 0 host that Coordinator. ``--trace_dir`` (or
``[trace] trace_dir``) arms tracing and ``[blackbox] dir`` the flight
recorder in ``train``; ``node`` arms both from the config or the
inherited ``PS_TRACE_DIR`` / ``PS_BLACKBOX_DIR``, which ``launch
--trace_dir/--blackbox_dir`` set for every node it spawns. ``train`` and
every node also arm the sampling profiler from ``[profile] hz`` (or
``PS_PROFILE``) and the OpenMetrics endpoint from ``[timeseries]
metrics_port`` (or ``PS_METRICS_PORT``).

The operations commands read a live cluster or what it left behind, with
no config file, as the JAX CLI's do: ``stats`` (the telemetry table),
``top`` (windowed per-node rates, SLO health and alerts), ``ranges`` (the
per-key-range traffic and data-age matrix) and ``audit`` (the streaming
protocol monitors' verdicts; exit 1 on a violation) against
``--scheduler host:port``; ``whylate`` (critical-path segments of the
slowest pushes and pulls) over a trace or black-box dir or a live
``--scheduler``, with ``--baseline`` budgets; ``postmortem`` over a
black-box dir (exit 1 on an anomaly).

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
  python -m parameter_server_tpu_torch.cli stats|top|ranges|audit --scheduler host:port [--once] [--json]
  python -m parameter_server_tpu_torch.cli whylate DIR | --scheduler host:port [--baseline f.json [--update-baseline]]
  python -m parameter_server_tpu_torch.cli postmortem DIR [--trace_out t.json]

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
    # tier composition: dynamic file assignment from the wire tier's
    # Coordinator instead of the static per-row split
    tr.add_argument(
        "--pool_coordinator", default="",
        help="host:port of a wire-tier Coordinator assigning files "
        "dynamically across the pod's data rows (PodTrainer.train_files_dynamic)",
    )
    tr.add_argument(
        "--pool_serve", action="store_true",
        help="rank 0 hosts the pool Coordinator at --pool_coordinator itself",
    )
    tr.add_argument(
        "--trace_dir", default="",
        help="arm distributed tracing (utils/trace.py): spans exported as "
        "Chrome trace-event JSON into this dir; overrides config [trace] "
        "trace_dir and PS_TRACE_DIR",
    )

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
    nd.add_argument(
        "--trace_dir", default="",
        help="arm distributed tracing on this node (overrides config "
        "[trace] trace_dir and PS_TRACE_DIR)",
    )

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
    la.add_argument(
        "--trace_dir", default="",
        help="arm distributed tracing on every spawned node (PS_TRACE_DIR): "
        "each exports a Chrome trace-event JSON into this dir; merge with "
        "utils/trace.py merge_trace_dir",
    )
    la.add_argument(
        "--blackbox_dir", default="",
        help="arm the flight recorder + stall watchdog on every spawned node "
        "(PS_BLACKBOX_DIR): each leaves a psbb/1 dump for the JAX package's "
        "`cli postmortem` to merge",
    )

    st = sub.add_parser(
        "stats",
        help="print the cluster telemetry table from a live coordinator "
        "(the reference scheduler's dashboard): per-node counters + "
        "merged per-command latency histograms (count/p50/p99)",
    )
    st.add_argument(
        "--scheduler", required=True, help="coordinator host:port"
    )

    tp = sub.add_parser(
        "top",
        help="live cluster dashboard (the operations plane's `top`): "
        "auto-refreshing per-node windowed rates + p99 latencies from "
        "the coordinator's retained heartbeat time series, SLO "
        "burn-rate health per node, active alerts and hot keys",
    )
    tp.add_argument("--scheduler", required=True, help="coordinator host:port")
    tp.add_argument(
        "--interval", type=float, default=2.0,
        help="refresh cadence in seconds",
    )
    tp.add_argument(
        "--window", type=float, default=0.0,
        help="rate/percentile window in seconds (0 = the coordinator's "
        "[timeseries] window_s default)",
    )
    tp.add_argument(
        "--once", action="store_true",
        help="print one frame and exit (scripts / tests)",
    )
    tp.add_argument(
        "--json", action="store_true",
        help="one-shot machine-readable output (implies --once): the "
        "same blocks the dashboard renders — nodes, windowed series, "
        "health, active alerts, audit — as one JSON document for CI "
        "and scripts",
    )

    rg = sub.add_parser(
        "ranges",
        help="the freshness plane's dashboard (`top` over key ranges): "
        "per-range push/pull rates, bytes moved, apply cost and the "
        "REALIZED data-age distribution of serves (server-measured "
        "publish-to-serve age + cache dwell), aggregated cluster-wide "
        "from the coordinator's retained heartbeat time series, with "
        "hot-key heat folded onto the owning range",
    )
    rg.add_argument("--scheduler", required=True, help="coordinator host:port")
    rg.add_argument(
        "--interval", type=float, default=2.0,
        help="refresh cadence in seconds",
    )
    rg.add_argument(
        "--window", type=float, default=0.0,
        help="rate/percentile window in seconds (0 = the coordinator's "
        "[timeseries] window_s default)",
    )
    rg.add_argument(
        "--once", action="store_true",
        help="print one frame and exit (scripts / tests)",
    )
    rg.add_argument(
        "--json", action="store_true",
        help="one-shot machine-readable per-range matrix (implies "
        "--once)",
    )

    au = sub.add_parser(
        "audit",
        help="the live audit plane (streaming protocol sentinel): "
        "violations of the wire protocol's invariants — "
        "acked-but-unapplied pushes, double applies, RCU version "
        "regressions, SSP staleness overruns, reconnects without "
        "heals, shed storms — detected by the coordinator's streaming "
        "monitors over the heartbeat event bus; one-shot summary or "
        "live follow",
    )
    au.add_argument("--scheduler", required=True, help="coordinator host:port")
    au.add_argument(
        "--interval", type=float, default=2.0,
        help="follow-mode poll cadence in seconds",
    )
    au.add_argument(
        "--once", action="store_true",
        help="print one summary and exit (nonzero when violations "
        "exist — CI drills gate on it)",
    )
    au.add_argument("--json", action="store_true")
    au.add_argument(
        "--recent", type=int, default=20,
        help="recent violations to include in the panel",
    )

    wl = sub.add_parser(
        "whylate",
        help="tail-latency forensics (analysis/critpath.py): stitch "
        "logical push/pull ops across processes and attribute their "
        "wall time to named pipeline segments (client_queue, wire, "
        "server, apply_wait, apply, reply_lane, ssp_wait). Feed it a "
        "PS_TRACE_DIR capture (tail-capture sidecars rescued), a "
        "PS_BLACKBOX_DIR postmortem, or a live cluster via "
        "--scheduler; --baseline gates per-segment p99 budgets with "
        "tiered exit codes (1 = hard regression, 2 = over budget)",
    )
    wl.add_argument(
        "dir", nargs="?", default="",
        help="trace or blackbox capture dir (omit with --scheduler)",
    )
    wl.add_argument(
        "--scheduler", default="",
        help="live mode: read the heartbeat-piggybacked slowest-op "
        "records from this coordinator instead of a capture dir",
    )
    wl.add_argument(
        "--top", type=int, default=5,
        help="slowest ops to list per command",
    )
    wl.add_argument("--json", action="store_true")
    wl.add_argument(
        "--baseline", default="", metavar="FILE",
        help="per-segment latency budgets (JSON: budgets_ms[cmd][seg] "
        "+ hard_factor); exit 1 when a segment p99 exceeds "
        "hard_factor x budget, 2 when it merely exceeds budget",
    )
    wl.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite --baseline from this capture's per-segment p99s "
        "(x2 slack)",
    )

    pm = sub.add_parser(
        "postmortem",
        help="merge the black-box dumps of a crashed/stalled cluster "
        "(PS_BLACKBOX_DIR, utils/flightrec.py) into one causal "
        "timeline: cross-process (cid, seq) stitching, anomaly flags "
        "(stalls, acked-but-unapplied pushes, version regressions, "
        "reconnects without heals, shed storms), per-key heat, and an "
        "optional Perfetto-loadable rendering",
    )
    pm.add_argument("dir", help="the blackbox dump directory")
    pm.add_argument(
        "--trace_out", default="",
        help="also write the merged timeline as Chrome trace-event JSON "
        "(open in Perfetto next to a PS_TRACE_DIR trace of the run)",
    )
    pm.add_argument(
        "--tail", type=int, default=40,
        help="merged-timeline events to print in the human report",
    )

    li = sub.add_parser(
        "lint",
        help="run pslint — the project-native static analyzer "
        "(python -m parameter_server_tpu_torch.analysis) over the port's "
        "source: lock-order, blocking-under-lock, settle-exactly-once, "
        "counter/config contracts, trace hygiene, rcu (the in-place "
        "publish lock included), and the quantity-flow triple (units / "
        "clockdomain / idtype); exits nonzero on findings",
    )
    li.add_argument(
        "--checker", action="append", default=None,
        help="run only this checker (repeatable)",
    )
    li.add_argument("--json", action="store_true")
    li.add_argument(
        "--baseline", default=None, metavar="FILE",
        help="gate on no NEW findings vs this JSON baseline (CI mode: "
        "pre-existing debt stays visible but frozen). Matching is "
        "LINE-INSENSITIVE — entries match on (checker, file, message) "
        "as a multiset, so edits above a finding never churn the gate "
        "but a second instance of a baselined finding still fails",
    )
    li.add_argument(
        "--update-baseline", action="store_true",
        help="rewrite --baseline from the current findings",
    )
    li.add_argument(
        "--changed-only", default=None, metavar="REF",
        help="report only findings in files changed vs this git ref "
        "(the analysis still covers the whole package — fast pre-push "
        "iteration, not the gate of record)",
    )

    ck = sub.add_parser(
        "check",
        help="run psmc — the explicit-state protocol model checker "
        "(analysis/model.py over analysis/specs/: exactly-once pushes, "
        "RCU publish/read, SSP clock, chain-replication failover) plus "
        "the spec<->code conformance diff; exits nonzero unless every "
        "model exhausts its bounded state space violation-free AND no "
        "spec assumption has drifted from the code",
    )
    ck.add_argument(
        "--spec", action="append", default=None,
        help="check only this protocol model (repeatable)",
    )
    ck.add_argument(
        "--max-states", type=int, default=200_000,
        help="BFS state cap (capped runs fail: verification demands "
        "exhausting the bounded space)",
    )
    ck.add_argument(
        "--probe-seeds", type=int, default=0,
        help="seeded random walks past a hit cap (bug probing, not "
        "verification)",
    )
    ck.add_argument(
        "--bug", default=None, metavar="KNOB",
        help="check the named seeded-bug variant of one --spec; exit 0 "
        "iff the checker catches it with a counterexample",
    )
    ck.add_argument(
        "--no-conformance", action="store_true",
        help="skip the spec<->code conformance diff (models only)",
    )
    ck.add_argument("--json", action="store_true")

    vf = sub.add_parser(
        "verify",
        help="the one-shot verification meta-command: chain pslint "
        "(--baseline gating), psmc protocol checking, optionally a "
        "live `audit --once` and an offline `whylate --baseline` "
        "budget gate, and fold their verdicts into ONE tiered exit "
        "code (0 clean, 2 soft/over-budget only, 1 any hard failure) "
        "— the single command CI and the bench workflow call",
    )
    vf.add_argument(
        "--lint-baseline", default="", metavar="FILE",
        help="pass through to `lint --baseline` (omit for a plain "
        "zero-findings lint)",
    )
    vf.add_argument(
        "--lint-changed-only", default="", metavar="REF",
        help="pass through to `lint --changed-only REF` (report only "
        "findings in files changed vs the ref; the analysis still "
        "covers the whole package)",
    )
    vf.add_argument(
        "--max-states", type=int, default=200_000,
        help="psmc BFS state cap (see `check --max-states`)",
    )
    vf.add_argument(
        "--scheduler", default="",
        help="also run `audit --once` against this live coordinator "
        "(omitted: the audit stage is skipped)",
    )
    vf.add_argument(
        "--whylate", dest="whylate_dir", default="", metavar="DIR",
        help="also run `whylate` over this trace/blackbox capture dir "
        "(omitted: the whylate stage is skipped)",
    )
    vf.add_argument(
        "--whylate-baseline", default="", metavar="FILE",
        help="per-segment latency budgets for the whylate stage (see "
        "`whylate --baseline`)",
    )
    vf.add_argument("--json", action="store_true")

    ex = sub.add_parser(
        "explore",
        help="budgeted schedule-seed search (analysis/explorer.py): run "
        "a test under PS_SCHED=<seed> for N seeds, persist failing "
        "seeds to the committed corpus, and print the exact replay "
        "line — how an interleaving bug becomes a regression test",
    )
    ex.add_argument(
        "test",
        help="pytest node id to explore (e.g. tests/test_torch_serving.py::"
        "TestServingChaosCoherence::"
        "test_read_your_writes_and_exactly_once_under_chaos[torch-torch])",
    )
    ex.add_argument(
        "--budget", type=int, default=20,
        help="seeds to try (one fresh pytest process per seed)",
    )
    ex.add_argument(
        "--start-seed", type=int, default=1,
        help="first seed of the contiguous budget window",
    )
    ex.add_argument(
        "--corpus", default=None, metavar="FILE",
        help="corpus file failing seeds are merged into (the "
        "explorer-armed tier-1 run replays every seed recorded here); "
        "default: the repo's committed tests/torch_sched_corpus.json, "
        "resolved next to the package so any CWD records to the file "
        "tier-1 actually replays",
    )
    ex.add_argument(
        "--timeout", type=float, default=120.0, metavar="S",
        help="per-seed budget: a seed that wedges the test past this "
        "counts as FAILING (a deadlock interleaving is the find, not "
        "a reason to hang the search)",
    )
    ex.add_argument(
        "--no-record", action="store_true",
        help="print failing seeds without touching the corpus file",
    )
    return p


def _check_ported(cfg: PSConfig) -> None:
    """Refuse an app the port does not know."""
    if cfg.app not in _KNOWN_APPS:
        raise SystemExit(f"unknown app {cfg.app!r}; known: {sorted(_KNOWN_APPS)}")


def _arm_train(cfg: PSConfig) -> None:
    """Arm this ``cli train`` process's planes: tracing from ``[trace]``
    (``--trace_dir`` already folded in) as the JAX CLI arms it, and the
    black box from ``[blackbox] dir``. A pod run's ranks share the dirs:
    each file carries its pid."""
    if cfg.trace.trace_dir:
        from parameter_server_tpu_torch.utils import trace

        trace.configure(
            cfg.trace.trace_dir, capacity=cfg.trace.capacity,
            process_name="train", sample=cfg.trace.sample,
            tail=cfg.trace.tail, tail_k=cfg.trace.tail_k,
            tail_limbo=cfg.trace.tail_limbo,
        )
    if cfg.blackbox.dir:
        from parameter_server_tpu_torch.utils import flightrec

        flightrec.configure(
            cfg.blackbox.dir, capacity=cfg.blackbox.capacity,
            process_name="train",
            flush_interval_s=cfg.blackbox.flush_interval_s,
            watchdog_interval_s=cfg.blackbox.watchdog_interval_s,
            stall_timeout_s=cfg.blackbox.stall_timeout_s,
        )


def run_train(cfg: PSConfig, args: argparse.Namespace) -> dict:
    _check_ported(cfg)
    if not cfg.data.files:
        raise SystemExit("config data.files is empty")
    if args.pool_coordinator and not (
        cfg.app == "linear_method"
        and cfg.solver.algo != "darlin"
        and (args.coordinator or cfg.parallel.data_shards * cfg.parallel.kv_shards > 1)
    ):
        # silently ignoring the flag would leave other pod ranks parked on
        # a coordinator this process never starts or contacts
        raise SystemExit(
            "--pool_coordinator requires the pod training path "
            "(linear_method with a >1x1 parallel mesh or --coordinator)"
        )
    _arm_train(cfg)
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
    gathers the weights for ``--model_out``; rank 0 writes them. With
    ``--pool_coordinator`` the files come from the wire tier's dynamic
    pool (``--pool_serve``: rank 0 hosts its Coordinator)."""
    from parameter_server_tpu_torch.parallel.trainer import PodTrainer
    from parameter_server_tpu_torch.utils.checkpoint import dump_weights_text

    trainer = PodTrainer(cfg, runtime=rt)
    if args.resume:
        if not args.ckpt_dir:
            raise SystemExit("--resume requires --ckpt_dir")
        trainer.load(args.ckpt_dir)
    if args.pool_coordinator:
        pool_coord = None
        try:
            if args.pool_serve and rt.process_index == 0:
                from parameter_server_tpu_torch.parallel.control import Coordinator

                host, port = args.pool_coordinator.rsplit(":", 1)
                pool_coord = Coordinator(host, int(port))
            out = dict(trainer.train_files_dynamic(
                cfg.data.files, args.pool_coordinator,
                report_every=args.report_interval,
            ) or {})
        finally:
            # reached on errors too: a rank that skipped the barrier would
            # park every other rank in it, and an unstopped Coordinator
            # would leak its thread (a failing rank's world teardown in
            # _run_sharded releases the others)
            rt.barrier()  # pool_shutdown: every rank finished fetching
            if pool_coord is not None:
                pool_coord.stop()
    else:
        out = dict(trainer.train_files(cfg.data.files, report_every=args.report_interval)
                   or {})
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
    """Refuse the apps the cluster path (``node``, ``launch``) does not
    run: as in the JAX package, it runs ``linear_method`` only."""
    _check_ported(cfg)
    if cfg.app != "linear_method":
        raise _not_ported(f"the cluster path for app {cfg.app!r}")


def run_stats(args: argparse.Namespace) -> dict:
    """The cluster dashboard (ref: the reference scheduler's printed
    table): query a live coordinator's ``telemetry`` command and print
    per-node rows + the merged per-command latency histograms."""
    from parameter_server_tpu_torch.parallel.control import ControlClient
    from parameter_server_tpu_torch.utils.metrics import (
        format_cluster_stats,
        hist_percentile,
    )

    ctl = ControlClient(args.scheduler, retries=5, reconnect_timeout_s=5.0)
    try:
        rep = ctl.telemetry()
    finally:
        ctl.close()
    print(format_cluster_stats(rep))
    merged = rep["merged"]
    return {
        "nodes": len(rep["nodes"]),
        "counters": merged["counters"],
        "latency_ms": {
            name: {
                "count": s.get("count", 0),
                "p50": round(hist_percentile(s, 0.5) * 1e3, 3),
                "p99": round(hist_percentile(s, 0.99) * 1e3, 3),
            }
            for name, s in merged["hists"].items()
        },
    }


def run_top(args: argparse.Namespace) -> int:
    """The auto-refreshing live dashboard (``cli top``): query the
    coordinator's ``telemetry`` command (windowed per-node series + SLO
    verdict) and render a frame every ``--interval``; ``--once`` prints
    a single frame for scripts and tests."""
    import time as time_mod

    from parameter_server_tpu_torch.parallel.control import ControlClient
    from parameter_server_tpu_torch.utils.slo import format_top

    ctl = ControlClient(args.scheduler, retries=5, reconnect_timeout_s=5.0)
    window = args.window or None
    try:
        while True:
            rep = ctl.telemetry(window_s=window)
            shown_window = (
                args.window
                or next(iter(rep.get("series", {}).values()), {}).get(
                    "window_s", 0.0
                )
            )
            if getattr(args, "json", False):
                # one-shot machine-readable frame: the same blocks the
                # dashboard renders, schema contract-tested in tier-1
                slo_rep = rep.get("slo") or {}
                print(json.dumps({
                    "window_s": float(shown_window or 0.0),
                    "nodes": rep.get("nodes") or {},
                    "series": rep.get("series") or {},
                    "health": slo_rep.get("health") or {},
                    "alerts": slo_rep.get("alerts") or [],
                    "audit": rep.get("audit") or {},
                }, default=float))
                return 0
            frame = format_top(rep, float(shown_window or 0.0))
            if args.once:
                print(frame)
                return 0
            # ANSI home+clear: the `top` idiom — repaint in place
            print("\x1b[2J\x1b[H" + frame, flush=True)
            time_mod.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        ctl.close()


def run_audit(args: argparse.Namespace) -> int:
    """The live audit plane's viewer (``cli audit``): one-shot summary
    (exit 1 when violations exist, so drills and CI gate on it) or a
    follow loop printing each NEW violation as the coordinator's
    streaming monitors raise it."""
    import time as time_mod

    from parameter_server_tpu_torch.parallel.control import ControlClient
    from parameter_server_tpu_torch.utils.slo import format_audit, format_violation

    ctl = ControlClient(args.scheduler, retries=5, reconnect_timeout_s=5.0)
    try:
        rep = ctl.audit(recent=args.recent)
        if args.json:
            print(json.dumps(rep, default=float))
            return 1 if rep.get("total") else 0
        if args.once:
            print(format_audit(rep))
            return 1 if rep.get("total") else 0
        # follow mode: poll, print only what is new since the last frame
        print(format_audit(rep))
        seen = int(rep.get("total") or 0)
        while True:
            time_mod.sleep(args.interval)
            rep = ctl.audit(recent=args.recent)
            total = int(rep.get("total") or 0)
            if total > seen:
                fresh = (rep.get("recent") or [])[-(total - seen):]
                for v in fresh:
                    print(format_violation(v).strip(), flush=True)
                seen = total
    except KeyboardInterrupt:
        return 0
    finally:
        ctl.close()


def run_whylate(args: argparse.Namespace) -> int:
    """Tail-latency forensics (``cli whylate``): critical-path
    attribution over a trace/blackbox capture dir or a live cluster,
    with optional per-segment budget gating (tiered exits: 0 within
    budget, 2 over budget, 1 past the hard factor, so CI fails on
    which segment regressed)."""
    from parameter_server_tpu_torch.analysis import critpath

    if bool(args.dir) == bool(args.scheduler):
        raise SystemExit(
            "whylate needs exactly one input: a capture dir or "
            "--scheduler host:port"
        )
    if args.scheduler and (args.baseline or args.update_baseline):
        # live records carry only the slowest-K segment splits, not the
        # per-segment p99 population a budget gates on: silently passing
        # every budget (or rewriting the committed baseline to empty)
        # would be a CI gate that never fires
        raise SystemExit(
            "whylate --baseline/--update-baseline gate offline captures; "
            "point them at a trace/blackbox dir, not --scheduler"
        )
    if args.update_baseline and not args.baseline:
        raise SystemExit(
            "whylate --update-baseline needs --baseline FILE (the file "
            "to rewrite) — without it nothing would be written"
        )
    if args.scheduler:
        from parameter_server_tpu_torch.parallel.control import ControlClient

        ctl = ControlClient(
            args.scheduler, retries=5, reconnect_timeout_s=5.0
        )
        try:
            summary = critpath.analyze_live(ctl.telemetry(), top=args.top)
        finally:
            ctl.close()
    else:
        summary = critpath.analyze_dir(args.dir, top=args.top)
    findings: list[dict] = []
    rc = 0
    if args.baseline and args.update_baseline:
        critpath.update_baseline(summary, args.baseline)
    elif args.baseline:
        if not summary.get("ops"):
            # an empty capture cannot PASS a budget gate: zero stitched
            # ops means the export (or the dir argument) broke, and
            # exiting 0 here would silently disarm the CI contract
            raise SystemExit(
                f"whylate --baseline: no stitchable ops found in "
                f"{args.dir!r} — cannot gate an empty capture"
            )
        findings = critpath.check_baseline(
            summary, critpath.load_baseline(args.baseline)
        )
        rc = critpath.baseline_exit_code(findings)
    if args.json:
        print(json.dumps(
            {**summary, "baseline_findings": findings}, default=float
        ))
        return rc
    print(critpath.render_report(summary, top=args.top))
    for f in findings:
        print(
            f"BUDGET {f['tier'].upper()}: {f['cmd']}.{f['segment']} "
            f"p99 {f['p99_ms']}ms > budget {f['budget_ms']}ms"
        )
    if args.baseline and not args.update_baseline and not findings:
        print("all segment budgets met")
    return rc


def run_ranges(args: argparse.Namespace) -> int:
    """The freshness dashboard (``cli ranges``): per-range traffic and
    realized data-age matrix from the coordinator's ``telemetry``
    command, auto-refreshing like ``cli top``; ``--once``/``--json``
    print a single frame for scripts and tests."""
    import time as time_mod

    from parameter_server_tpu_torch.parallel.control import ControlClient
    from parameter_server_tpu_torch.utils.slo import format_ranges, ranges_view

    ctl = ControlClient(args.scheduler, retries=5, reconnect_timeout_s=5.0)
    window = args.window or None
    try:
        while True:
            rep = ctl.telemetry(window_s=window)
            shown_window = (
                args.window
                or next(iter(rep.get("series", {}).values()), {}).get(
                    "window_s", 0.0
                )
            )
            if args.json:
                print(json.dumps(
                    ranges_view(rep, float(shown_window or 0.0)),
                    default=float,
                ))
                return 0
            frame = format_ranges(rep, float(shown_window or 0.0))
            if args.once:
                print(frame)
                return 0
            print("\x1b[2J\x1b[H" + frame, flush=True)
            time_mod.sleep(args.interval)
    except KeyboardInterrupt:
        return 0
    finally:
        ctl.close()


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
        trace_dir=args.trace_dir, blackbox_dir=args.blackbox_dir,
    )


def run_verify(args: argparse.Namespace) -> int:
    """The verification meta-command (``cli verify``): run every armed
    analysis stage and fold their exit codes into one tiered verdict —
    1 when ANY stage failed hard (lint findings, model-checker
    violation, audit violations, whylate hard regression), else 2 when
    any stage was merely over budget (the whylate/pslint soft tier),
    else 0. One command, one exit code: what CI and the bench README
    workflow gate on."""
    from parameter_server_tpu_torch.analysis.__main__ import (
        check_main,
        main as lint_main,
    )

    stages: list[dict] = []

    def _stage(name: str, fn) -> None:
        print(f"[verify] {name} ...", flush=True)
        try:
            rc = int(fn() or 0)
        except SystemExit as e:  # argparse/guard exits inside a stage
            rc = e.code if isinstance(e.code, int) else 1
        except Exception as e:  # a crashed stage is a hard failure,
            # not a crashed verify: the remaining stages still run
            print(f"[verify] {name} crashed: {e}", flush=True)
            rc = 1
        stages.append({"stage": name, "exit": rc})
        print(
            f"[verify] {name}: " + ("ok" if rc == 0 else f"exit {rc}"),
            flush=True,
        )

    lint_argv: list[str] = []
    if args.lint_baseline:
        lint_argv += ["--baseline", args.lint_baseline]
    if args.lint_changed_only:
        lint_argv += ["--changed-only", args.lint_changed_only]
    _stage("lint", lambda: lint_main(lint_argv))
    _stage(
        "check",
        lambda: check_main(["--max-states", str(args.max_states)]),
    )
    if args.scheduler:
        au = argparse.Namespace(
            scheduler=args.scheduler, interval=2.0, once=True,
            json=False, recent=20,
        )
        _stage("audit", lambda: run_audit(au))
    if args.whylate_dir:
        wl = argparse.Namespace(
            dir=args.whylate_dir, scheduler="", top=5, json=False,
            baseline=args.whylate_baseline, update_baseline=False,
        )
        _stage("whylate", lambda: run_whylate(wl))
    hard = [s["stage"] for s in stages if s["exit"] not in (0, 2)]
    soft = [s["stage"] for s in stages if s["exit"] == 2]
    rc = 1 if hard else (2 if soft else 0)
    verdict = (
        f"FAILED ({', '.join(hard)})" if hard
        else f"over budget ({', '.join(soft)})" if soft
        else "all stages clean"
    )
    if args.json:
        print(json.dumps({
            "stages": stages, "hard": hard, "soft": soft, "exit": rc,
        }))
    else:
        print(f"[verify] verdict: {verdict} — exit {rc}")
    return rc


def main(argv: list[str] | None = None) -> int:
    args = _build_parser().parse_args(argv)
    if args.cmd == "lint":
        # no config file: lint analyzes the installed package source
        from parameter_server_tpu_torch.analysis.__main__ import main as lint_main

        lint_argv: list[str] = []
        for c in args.checker or ():
            lint_argv += ["--checker", c]
        if args.json:
            lint_argv.append("--json")
        if args.baseline:
            lint_argv += ["--baseline", args.baseline]
        if args.update_baseline:
            lint_argv.append("--update-baseline")
        if args.changed_only:
            lint_argv += ["--changed-only", args.changed_only]
        return lint_main(lint_argv)
    if args.cmd == "check":
        # no config file: the model checker verifies protocol SPECS and
        # their conformance to the installed package source
        from parameter_server_tpu_torch.analysis.__main__ import check_main

        check_argv: list[str] = []
        for s in args.spec or ():
            check_argv += ["--spec", s]
        check_argv += ["--max-states", str(args.max_states)]
        if args.probe_seeds:
            check_argv += ["--probe-seeds", str(args.probe_seeds)]
        if args.bug:
            check_argv += ["--bug", args.bug]
        if args.no_conformance:
            check_argv.append("--no-conformance")
        if args.json:
            check_argv.append("--json")
        return check_main(check_argv)
    if args.cmd == "explore":
        from pathlib import Path

        from parameter_server_tpu_torch.analysis import explorer

        repo_root = Path(__file__).resolve().parent.parent
        corpus = args.corpus or str(
            repo_root / "tests" / "torch_sched_corpus.json"
        )
        # the corpus keys on the node id STRING and the explorer-armed
        # tier-1 run looks seeds up by the canonical repo-relative
        # spelling — normalize absolute/cwd-relative paths to it, or a
        # recorded seed would never be replayed
        file_part, sep, rest = args.test.partition("::")
        fp = Path(file_part)
        if fp.exists():
            try:
                canon = fp.resolve().relative_to(repo_root).as_posix()
            except ValueError:
                canon = file_part  # outside the repo: keep as typed
            if canon != file_part:
                args.test = canon + sep + rest
                print(f"explore: node id normalized to {args.test}")

        def _note(seed: int, passed: bool) -> None:
            print(
                f"explore: seed {seed} "
                + ("passed" if passed else "FAILED — replayable")
            )

        search_err: Exception | None = None
        try:
            failing = explorer.search_seeds(
                args.test, budget=args.budget,
                start_seed=args.start_seed,
                on_result=_note, timeout_s=args.timeout,
            )
        except explorer.SearchError as e:
            # record/report what the budget found BEFORE surfacing the
            # infra break — a long search must not lose its finds
            failing, search_err = e.failing, e
        if failing and not args.no_record:
            explorer.record_failing_seeds(corpus, args.test, failing)
            print(f"explore: {len(failing)} failing seed(s) recorded "
                  f"in {corpus}")
        for seed in failing:
            print(f"  replay: PS_SCHED={seed} python -m pytest "
                  f"{args.test}")
        print(
            f"explore: {len(failing)}/{args.budget} seed(s) broke "
            f"{args.test}"
        )
        if search_err is not None:
            print(f"explore: search aborted — {search_err}")
            return 1
        # always 0: finding a failing seed is the SUCCESSFUL outcome of
        # an exploration budget, and the recorded corpus (replayed by
        # the explorer-armed tier-1 run) is the durable gate — CI gates
        # on that replay, not on this search's exit code
        return 0
    if args.cmd == "verify":
        # no config file: every chained stage is itself config-free
        return run_verify(args)
    if args.cmd == "stats":
        # no config file: stats only needs a live coordinator address
        print(json.dumps(run_stats(args), default=float))
        return 0
    if args.cmd == "top":
        # no config file: the dashboard reads the live coordinator
        return run_top(args)
    if args.cmd == "ranges":
        # no config file: the freshness dashboard reads the live
        # coordinator (range boundaries ride the series names)
        return run_ranges(args)
    if args.cmd == "audit":
        # no config file: the sentinel reads the live coordinator
        return run_audit(args)
    if args.cmd == "whylate":
        # no config file: forensics read a capture dir or the live
        # coordinator's piggybacked slow-op records
        return run_whylate(args)
    if args.cmd == "postmortem":
        # no config file: a postmortem works from the dumps alone
        from parameter_server_tpu_torch.utils.postmortem import postmortem

        out = postmortem(args.dir, trace_out=args.trace_out, tail=args.tail)
        print(out.pop("report"))
        print(json.dumps(out, default=float))
        # anomalies => nonzero, so a soak harness can gate on the exit
        return 1 if out["anomalies"] else 0
    cfg = load_config(args.app_file)
    if getattr(args, "trace_dir", ""):
        # the flag wins over the config and the ambient env; run_node and
        # cli train arm from cfg (launch passes it to every node's env)
        cfg.trace.trace_dir = args.trace_dir
    run = {"train": run_train, "convert": run_convert, "evaluate": run_evaluate,
           "backend": run_backend, "node": run_node_cmd, "launch": run_launch}[args.cmd]
    msrv = roller = None
    armed_prof = False
    if args.cmd == "train":
        # live-ops arming for the train path (spawned node roles arm in
        # run_node with role-rank names): the continuous profiler from
        # [profile] / PS_PROFILE; the OpenMetrics endpoint from
        # [timeseries] / PS_METRICS_PORT, with a Roller thread feeding
        # the local ring at heartbeat cadence (no beats feed it here) so
        # /healthz serves a live windowed summary
        import os

        from parameter_server_tpu_torch.utils import profiler, timeseries

        hz = cfg.profile.hz if cfg.profile.hz > 0 else profiler.env_hz()
        if hz > 0:
            profiler.configure(
                hz, top_n=cfg.profile.top_n,
                max_depth=cfg.profile.max_depth,
                dump_dir=cfg.profile.dump_dir, process_name="train",
            )
            armed_prof = True
        mport = cfg.timeseries.metrics_port or int(
            os.environ.get(timeseries.METRICS_PORT_ENV, "0") or 0
        )
        if mport > 0:
            timeseries.reset_local_ring(cfg.timeseries.capacity)
            msrv = timeseries.start_metrics_server(
                mport, process_name="train",
                host=cfg.timeseries.metrics_host,
                window_s=cfg.timeseries.window_s,
            )
            roller = timeseries.Roller(cfg.fault.heartbeat_interval_s)
    try:
        out = run(cfg, args)
    finally:
        # an in-process caller (tests) must not leak the HTTP server, the
        # roll thread or a still-sampling profiler past main() (disarming
        # the profiler also writes its configured dumps)
        if roller is not None:
            roller.close()
        if msrv is not None:
            msrv.close()
        if armed_prof:
            from parameter_server_tpu_torch.utils import profiler

            profiler.configure(0)
    print(json.dumps(out, default=float))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
