"""PodTrainer: the multi-worker trainer of ``linear_method``.

The port of the JAX package's ``parallel/trainer.py``: D data shards stream
minibatches from their file shards and push/pull against KV server shards
through the SPMD step (``parallel/spmd.py``), under the SSP dispatch bound.
Each rank of the world runs one trainer on its own mesh cell: it feeds its
data row's files, holds its kv slice of the tables, and runs the same
collectives as every other rank, step for step.

SSP, as in the JAX trainer: within a step every worker's gradient is taken
against step-start weights and the pushes land one after another; across
steps the host queues up to ``max_delay + 1`` steps before it blocks on
the oldest one's results (``DispatchWindow``).

Termination (the drained contract): a rank whose files run out keeps
issuing inert all-padding steps, and every rank stops after retiring the
first step whose pod-wide example count is 0. The retirement schedule is
the same on every rank, so all stop at the same step.

The dynamic workload pool (``train_files_dynamic``): the wire tier's
``Coordinator`` hands files to data rows as they ask for them, instead of
the static split. Tracing (``step.fetch``/``step.dispatch``/``step.retire``
spans), the named timers of the same names (``trainer.fetch`` and so on,
riding the telemetry snapshot) and the flight recorder
(``step.dispatch``/``step.retire`` events) are the JAX trainer's. Not ported here: ``profile_dir``.
"""

from __future__ import annotations

import time
from collections.abc import Iterator

import numpy as np

from parameter_server_tpu_torch.data.batch import BatchBuilder, CSRBatch
from parameter_server_tpu_torch.data.pipeline import PrefetchPipeline
from parameter_server_tpu_torch.data.reader import MinibatchReader
from parameter_server_tpu_torch.models import metrics as M
from parameter_server_tpu_torch.models.linear import updater_from_config
from parameter_server_tpu_torch.parallel.runtime import Runtime
from parameter_server_tpu_torch.parallel.spmd import (
    batch_arrays,
    make_spmd_predict_step,
    make_spmd_train_multistep,
    make_spmd_train_step,
    padded_num_keys,
    stack_step_groups,
)
from parameter_server_tpu_torch.parallel.ssp import DispatchWindow, SSPClock
from parameter_server_tpu_torch.parallel.traffic import linear_step_traffic
from parameter_server_tpu_torch.parallel.workload import WorkloadPool
from parameter_server_tpu_torch.utils import flightrec, trace
from parameter_server_tpu_torch.utils.config import PSConfig
from parameter_server_tpu_torch.utils.metrics import ProgressReporter, timers


class _WorkerStream:
    """This rank's data shard's batch source: drains workloads (files)
    from the pool, reading each through a MinibatchReader."""

    def __init__(self, worker_id: int, pool: WorkloadPool, fmt: str, builder: BatchBuilder):
        self.worker_id = worker_id
        self.pool = pool
        self.fmt = fmt
        self.builder = builder
        self._iter: Iterator[CSRBatch] | None = None
        self._current: str | None = None

    def next_batch(self) -> CSRBatch | None:
        while True:
            if self._iter is not None:
                b = next(self._iter, None)
                if b is not None:
                    return b
                if self._current is not None:
                    self.pool.finish(self._current)
                self._iter = None
                self._current = None
            w = self.pool.fetch(self.worker_id)
            if w is None:
                return None
            self._current = w
            self._iter = iter(
                MinibatchReader([self._reader_path(w)], self.fmt, self.builder)
            )

    def _reader_path(self, workload: str) -> str:
        """The file a pool item names (the item itself here; the dynamic
        pool's items carry an epoch prefix)."""
        return workload

    def _empty(self) -> CSRBatch:
        """Inert batch (all padding) for a drained worker: no loss, no
        gradient."""
        return _pad_like(self.builder)


class _RemotePool:
    """WorkloadPool facade over the wire tier's Coordinator: it hands
    files to the pod's data rows as they ask (tier composition).

    One process a mesh cell: every rank of a data row must feed the same
    batches, so only the rank of kv column 0 talks to the pool, and it
    relays each item it fetched to the row's other ranks through the
    Coordinator's blob KV (``pod_row/<d>/<n>``, the n-th fetch of data
    row d; an empty value is "drained"). The others wait on that key.
    Finishing is column 0's alone."""

    def __init__(self, ctl, mesh, timeout_s: float = 120.0):
        self._ctl = ctl
        self._mesh = mesh
        self._n = 0  # fetches this rank made (same sequence across the row)
        self._timeout_s = timeout_s

    def fetch(self, worker: int) -> str | None:
        key = f"pod_row/{self._mesh.d}/{self._n}"
        self._n += 1
        if self._mesh.k == 0:
            w = self._ctl.workload_fetch(worker)
            if self._mesh.kv > 1:
                self._ctl.kv_set(key, item=w or "")
            return w
        got = self._ctl.kv_get(key, block=True, timeout=self._timeout_s)
        if got is None:
            raise TimeoutError(
                f"data row {self._mesh.d}: no pool item {key!r} from kv "
                f"column 0 within {self._timeout_s}s"
            )
        return got[0]["item"] or None

    def finish(self, workload: str) -> None:
        if self._mesh.k == 0:
            self._ctl.workload_finish(workload)


class _EpochStream(_WorkerStream):
    """_WorkerStream whose pool items are ``"<epoch>:<path>"`` (epochs
    ride the dynamic pool as distinct workloads)."""

    def _reader_path(self, workload: str) -> str:
        return workload.split(":", 1)[1]


class PodTrainer:
    """Train the flagship sparse-LR app on this rank's cell of the
    (data, kv) mesh. ``runtime`` comes from ``parallel.runtime.init``; its
    mesh must have the shape ``cfg.parallel`` gives."""

    def __init__(
        self,
        cfg: PSConfig,
        runtime: Runtime,
        reporter: ProgressReporter | None = None,
    ):
        self.cfg = cfg
        if cfg.trace.trace_dir and not trace.tracer.enabled:
            # config-armed tracing for the in-process pod path (spawned
            # nodes arm through run_node / PS_TRACE_DIR instead)
            trace.configure(
                cfg.trace.trace_dir, capacity=cfg.trace.capacity,
                process_name="pod-trainer",
            )
        self.runtime = runtime
        self.mesh = runtime.mesh
        # one source of truth: a cfg whose parallel section disagrees with
        # the world it runs on must fail loudly, not train under another
        # sharding
        got = (self.mesh.data, self.mesh.kv)
        want = (cfg.parallel.data_shards, cfg.parallel.kv_shards)
        if got != want:
            raise ValueError(
                f"cfg.parallel says (data_shards, kv_shards)={want} but the "
                f"provided runtime is {got}; update cfg.parallel (or build the "
                "runtime with runtime.init(..., cfg=cfg)) so both agree"
            )
        # bucketed batches differ in shape between data shards, and the
        # gathers need one shape: every step agrees on the pod's max first
        self._bucket_sync = cfg.data.bucket_nnz and runtime.process_count > 1
        self.data_shards = self.mesh.data
        self.updater = updater_from_config(cfg)
        if cfg.solver.steps_per_call < 1:
            raise ValueError(
                f"solver.steps_per_call must be >= 1, got {cfg.solver.steps_per_call}"
            )
        self.steps_per_call = cfg.solver.steps_per_call
        if cfg.data.wire_values not in ("f32", "f16"):
            raise ValueError(
                f"data.wire_values must be 'f32' or 'f16', got {cfg.data.wire_values!r}"
            )
        maker = make_spmd_train_multistep if self.steps_per_call > 1 else make_spmd_train_step
        self.step_fn = maker(
            self.updater, self.mesh, cfg.data.num_keys, push_mode=cfg.parallel.push_mode
        )
        self.predict_fn = make_spmd_predict_step(self.updater, self.mesh, cfg.data.num_keys)
        # num_keys rounded up to the kv multiple; the pad rows stay zero
        self._table_rows = padded_num_keys(cfg.data.num_keys, self.mesh.kv)
        self.state = runtime.init_state(self.updater, self._table_rows, 1)
        # the progress table prints on rank 0; every rank keeps its history
        self.reporter = reporter or ProgressReporter(
            print_fn=print if runtime.process_index == 0 else (lambda *_: None)
        )
        self.clock = SSPClock(num_workers=1, max_delay=max(cfg.solver.max_delay, 0))
        self.examples_seen = 0  # pod-wide, counted as steps retire
        cap = min(cfg.solver.minibatch * cfg.data.max_nnz_per_example + 1, cfg.data.num_keys)
        self.est_step_traffic = linear_step_traffic(
            unique_capacity=cap, vdim=1, data_shards=self.data_shards,
            kv_shards=self.mesh.kv, push_mode=cfg.parallel.push_mode,
            num_keys=cfg.data.num_keys,
        )

    def _builder(self, key_mode: str) -> BatchBuilder:
        from parameter_server_tpu_torch.data.batch import training_builder

        return training_builder(self.cfg, key_mode)

    def train_files(self, files: list[str], key_mode: str = "hash", report_every: int = 20) -> dict:
        """Run all epochs over ``files``, sharded across data rows.
        Collective: every rank calls it with the same FULL file list."""
        last: dict = {}
        for _ in range(max(1, self.cfg.solver.epochs)):
            pool = WorkloadPool(self.runtime.shard_files(files))
            stream = _WorkerStream(self.mesh.d, pool, self.cfg.data.format,
                                   self._builder(key_mode))
            last = self._train_epoch(stream, report_every) or last
        return last

    def train_files_dynamic(
        self,
        files: list[str],
        coordinator: str,
        key_mode: str = "hash",
        report_every: int = 20,
    ) -> dict:
        """Compose the two multi-process tiers: the wire tier's Coordinator
        at ``coordinator`` hands files to the pod's data rows as they ask
        for them (the reference scheduler's WorkloadPool) instead of the
        static split, while the data plane stays the mesh collectives.
        Epochs ride the pool as distinct ``"<epoch>:<path>"`` items.

        Collective: EVERY rank calls it with the same file list. Rank 0
        initializes the pool (a pool someone else already initialized
        raises) and sets ``pod_pool_ready``, which the other ranks wait
        on. The JAX trainer runs one stream a local data shard, each
        fetching under its global data index; here a rank is one mesh
        cell, so the worker id is the rank's data row ``mesh.d`` and only
        the rank of kv column 0 fetches, relaying each item to the rest
        of its row (``_RemotePool``), so every rank of a row consumes the
        same workloads. The JAX termination contract holds unchanged: a
        drained rank feeds inert steps until a retired step counts 0
        examples pod-wide. With one data row the items come in the static
        order, and the run equals ``train_files``."""
        from parameter_server_tpu_torch.parallel.control import ControlClient
        from parameter_server_tpu_torch.utils.metrics import wire_counters

        cfg = self.cfg
        # self-healing client: a coordinator restart or an injected
        # control-plane fault mid-run is absorbed by reconnect + resend
        # (the server's reply cache keeps workload_fetch exactly-once)
        ctl = ControlClient(coordinator, reconnect_timeout_s=cfg.fault.reconnect_timeout_s)
        try:
            items = [f"{e}:{f}" for e in range(max(1, cfg.solver.epochs))
                     for f in sorted(files)]
            if self.runtime.process_index == 0:
                ctl.workload_init(items)
                # workload_init is first-wins on the Coordinator: a pool
                # someone else already initialized would be silently
                # reused and this pod would train on nothing — fail loudly
                st = ctl.workload_stats()
                total = st["pending"] + st["active"] + st["done"]
                if total != len(items) or st["done"] or st["active"]:
                    raise RuntimeError(
                        f"coordinator at {coordinator} already holds a "
                        f"workload pool ({st}); train_files_dynamic needs "
                        "a fresh Coordinator per run"
                    )
                ctl.kv_set("pod_pool_ready")
            else:
                ctl.kv_get("pod_pool_ready", block=True, timeout=120)
            stream = _EpochStream(self.mesh.d, _RemotePool(ctl, self.mesh),
                                  cfg.data.format, self._builder(key_mode))
            out = dict(self._train_epoch(stream, report_every) or {})
            # recovery observability for the pod path (cumulative for this
            # process; mostly zero on a healthy wire)
            out["rpc_retries"] = wire_counters.get("rpc_retries")
            out["rpc_reconnects"] = wire_counters.get("rpc_reconnects")
            return out
        finally:
            ctl.close()

    @staticmethod
    def _assemble_group(items: list[tuple]) -> tuple:
        """K prepared step items as one multistep dispatch item: the
        (K, ...) wire arrays and each step's labels."""
        return stack_step_groups([a for a, _ in items]), [y for _, y in items]

    def _prepare(self, b: CSRBatch) -> tuple:
        """Per-step host work: the batch's wire arrays and its real
        examples' labels."""
        arrays = batch_arrays(
            b, compact=self.cfg.data.compact_wire,
            values_f16=self.cfg.data.wire_values == "f16",
        )
        return arrays, b.labels[: b.num_examples]

    def _agree_bucket(self, stacked: dict) -> dict:
        """Zero-pad this rank's (nnz, unique) shape up to the pod's max,
        agreed on the host-side group. Collective, every step."""
        from parameter_server_tpu_torch.data.batch import zero_extend

        local = (stacked["values"].shape[-1], stacked["unique_keys"].shape[-1])
        nnz_t, u_t = self.runtime.cp_allmax(local)
        out = {
            **stacked,
            "unique_keys": zero_extend(stacked["unique_keys"], u_t, axis=-1),
            "local_ids": zero_extend(stacked["local_ids"], nnz_t, axis=-1),
            "values": zero_extend(stacked["values"], nnz_t, axis=-1),
        }
        if "row_ids" in stacked:  # absent in the compact wire format
            out["row_ids"] = zero_extend(stacked["row_ids"], nnz_t, axis=-1)
        return out

    def _train_epoch(self, stream: _WorkerStream, report_every: int) -> dict:
        window: list = []
        n_since = 0  # pod-wide examples retired since the last report
        t0 = time.perf_counter()
        step_idx = 0
        last: dict = {}
        drained = False  # a retired step reported 0 pod-wide examples

        def _retire(step: int, entry) -> None:
            nonlocal drained, n_since
            loss_arr, examples_arr, probs, labels = entry
            # reading the results waits for the step: the SSP bound
            with trace.span("step.retire", cat="step", step=step), \
                    timers.timer("trainer.retire"):
                losses = np.atleast_1d(loss_arr.cpu().numpy())
                exs = np.atleast_1d(examples_arr.cpu().numpy())
            # flight recorder: the trainer's dispatch/retire cadence —
            # "which step was in flight when the pod wedged" (this rank's
            # real examples, as the JAX host's)
            flightrec.record(
                "step.retire", step=step, examples=sum(len(y) for y in labels)
            )
            self.clock.finish(0, step)
            n = int(exs.sum())
            self.examples_seen += n
            n_since += n
            # empties only trail real batches within a group, so the last
            # microstep's count is the drained signal
            if float(exs[-1]) == 0.0:
                drained = True
            probs_l = probs.cpu().numpy().reshape(len(labels), -1)  # ([K,] B)
            for k, y in enumerate(labels):
                window.append((float(losses[k]), probs_l[k], y))

        gate = DispatchWindow(self.clock.max_delay, _retire)
        K = self.steps_per_call
        depth = self.cfg.data.pipeline_depth
        pipeline = (
            PrefetchPipeline(
                [stream], lambda bs: self._prepare(bs[0]), depth=depth, group_size=K,
                assemble=self._assemble_group if K > 1 else None,
            )
            if depth > 0
            else None
        )
        empty_item = None  # the inert step item of a drained rank
        empty_group = None  # its K-group form

        def _serial_item():
            b = stream.next_batch()
            return None if b is None else self._prepare(b)

        def _empty_single():
            nonlocal empty_item
            if empty_item is None:
                empty_item = self._prepare(stream._empty())
            return empty_item

        def _empty_dispatch():
            nonlocal empty_group
            if K == 1:
                return _empty_single()
            if empty_group is None:
                empty_group = self._assemble_group([_empty_single()] * K)
            return empty_group

        def _next_item():
            """The next prepared step (K == 1) or K-group; never None: a
            drained rank keeps issuing inert items."""
            if pipeline is not None:
                item = pipeline.get()
                return item if item is not None else _empty_dispatch()
            if K == 1:
                return _serial_item() or _empty_single()
            singles = [_serial_item() for _ in range(K)]
            if all(s is None for s in singles):
                return _empty_dispatch()
            return self._assemble_group([s if s is not None else _empty_single()
                                         for s in singles])

        try:
            while True:
                gate.gate(step_idx)
                if drained:
                    break
                # step anatomy: fetch (host pipeline pop) vs dispatch
                # (bucket agreement, H2D copies, device work issued);
                # named timers feed the telemetry snapshot, spans the
                # timeline
                with trace.span("step.fetch", cat="step", step=step_idx), \
                        timers.timer("trainer.fetch"):
                    stacked_np, labels = _next_item()
                if K == 1:
                    labels = [labels]
                with trace.span("step.dispatch", cat="step", step=step_idx), \
                        timers.timer("trainer.dispatch"):
                    if self._bucket_sync:
                        stacked_np = self._agree_bucket(stacked_np)
                    stacked = self.runtime.globalize_batch(stacked_np)
                    # push_seed varies per microstep (the quantized push
                    # never reuses its uniforms); step_idx * K is this
                    # call's first
                    self.state, out = self.step_fn(self.state, stacked, step_idx * K)
                flightrec.record(
                    "step.dispatch", step=step_idx,
                    examples=sum(len(y) for y in labels),
                )
                gate.add(step_idx, (out["loss_sum"], out["examples"], out["probs"], labels))
                step_idx += 1
                if step_idx % report_every == 0:
                    gate.drain()
                    last = self._flush(window, n_since, t0)
                    window, n_since, t0 = [], 0, time.perf_counter()
            gate.drain()  # epoch sync point: every dispatched step retired
        finally:
            if pipeline is not None:
                pipeline.close()
        if n_since:
            last = self._flush(window, n_since, t0)
        return last

    def _flush(self, window, n_since: int, t0: float) -> dict:
        """One progress row. The AUC covers every data shard: the ranks of
        kv column 0 contribute their shards' labels and probabilities, and
        every rank computes the same value. Collective."""
        losses = sum(w[0] for w in window)
        ys, ps = [], []
        for _, probs, labels in window:
            ps.append(probs[: len(labels)])
            ys.append(labels)
        mine = None
        if self.mesh.k == 0:
            mine = (np.concatenate(ys) if ys else np.zeros(0),
                    np.concatenate(ps) if ps else np.zeros(0))
        parts = [p for p in self.runtime.all_gather_object(mine) if p is not None]
        y = np.concatenate([p[0] for p in parts])
        p = np.concatenate([p[1] for p in parts])
        return self.reporter.report(
            examples=self.examples_seen,
            objv=losses / max(n_since, 1),
            auc=M.auc(y, p) if len(y) else float("nan"),
            ex_per_sec=n_since / max(time.perf_counter() - t0, 1e-9),
            ssp=self.clock.progress(),
            # static per-device collective estimate for this window
            est_collective_bytes=self.est_step_traffic.total_bytes * len(window),
        )

    def full_weights(self) -> np.ndarray:
        """The (num_keys, 1) weight vector on this rank, from the tables
        gathered over its kv group. Collective: every rank calls it."""
        import torch

        host = self.runtime.state_to_host(self.state)
        w = self.updater.weights({k: torch.from_numpy(v) for k, v in host.items()})
        return w.numpy()[: self.cfg.data.num_keys]

    def save(self, ckpt_dir, meta: dict | None = None) -> None:
        """Pod checkpoint (rank 0 writes the full tables, then a barrier).
        Collective: every rank calls it with the same decision to save."""
        self.runtime.save_checkpoint(
            ckpt_dir, self.state, meta={"examples_seen": self.examples_seen, **(meta or {})}
        )

    def load(self, ckpt_dir) -> dict:
        """Load a pod checkpoint of either package, written on any mesh:
        its first num_keys rows, re-padded to this mesh's table rows."""
        self.state, meta = self.runtime.load_checkpoint(
            ckpt_dir, self.cfg.data.num_keys, self._table_rows
        )
        self.examples_seen = int(meta.get("examples_seen", 0))
        return meta

    def evaluate_files(self, files: list[str], key_mode: str = "hash") -> dict:
        """AUC / logloss over ``files``. On a world of one, through the
        predict step; otherwise every rank evaluates the full weight vector
        locally (as the JAX trainer does across hosts), so ranks may
        evaluate different files. Collective either way."""
        if self.runtime.process_count > 1:
            from parameter_server_tpu_torch.models.evaluation import evaluate_model

            return evaluate_model(
                self.full_weights().ravel(), files, self.cfg.data.format,
                self.cfg.data.num_keys, batch_size=self.cfg.solver.minibatch,
                max_nnz_per_example=self.cfg.data.max_nnz_per_example,
                key_mode=key_mode, device=self.mesh.device,
            )
        from parameter_server_tpu_torch.data.batch import eval_builder

        builder = eval_builder(self.cfg, key_mode)
        ys: list[np.ndarray] = []
        ps: list[np.ndarray] = []
        for b in MinibatchReader(files, self.cfg.data.format, builder):
            arrays = batch_arrays(
                b, compact=self.cfg.data.compact_wire,
                values_f16=self.cfg.data.wire_values == "f16",
            )
            probs = self.predict_fn(self.state, self.runtime.globalize_batch(arrays))
            ps.append(probs[: b.num_examples].cpu().numpy())
            ys.append(b.labels[: b.num_examples])
        y = np.concatenate(ys)
        p = np.concatenate(ps)
        return {"auc": M.auc(y, p), "logloss": M.logloss(y, p), "examples": len(y)}


def _pad_like(builder: BatchBuilder) -> CSRBatch:
    return builder.build(np.zeros(0, dtype=np.float32), [], [])
