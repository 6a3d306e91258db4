"""linear_method: sparse logistic regression over the KV store.

The flagship app: stream minibatch -> localize -> pull weights -> CSR
gradient -> push, with the server updater (FTRL/AdaGrad/SGD) applied to the
touched rows. One ``train_step`` per minibatch: it pulls the batch's
weights through ``kv.store.pull``, computes logits, loss and gradient, and
pushes the gradient through ``kv.store.push``, in place: on CUDA, FTRL's
push is the hand-written fused kernel K1 (``ftrl_push``), AdaGrad's K3,
as on every other path that updates a table.

``LinearMethod.train`` and ``predict`` step on each batch's real prefix
(``trim_batch``): its entries and unique slots without the bucket's
padding, which stays on the host. A pad only adds an exact zero onto slot
0, row 0 or example row 0, so the results are the padded step's without
those adds, which the card serialises on their one address. The padded shapes stay for the paths
whose ranks must agree on them (``parallel/``); one device has none to
agree with.

``LinearMethod.train`` names its loop with ``utils/trace.py`` spans (cat
``step``): ``linear.step`` around ``linear.h2d`` (the batch's copies to the
device), ``linear.launch`` (the queued step and its bookkeeping) and
``linear.fetch`` (the wait for the next batch); ``linear.report`` around
``linear.report.auc`` (the window's exact AUC, queued on the device
behind the steps it reports on) and ``linear.report.readback`` (the
report's one read, which waits for them). Counters ``linear.slots`` and
``linear.pad_slots`` give the slots each step scatters and the pad slots
among them, from the host fields of the batch the step carries (after the
trim: ``num_unique`` and 0); ``linear.report.ranked`` the examples a
report ranked. All of it records only while a trace dir is armed or a
``torch.profiler`` collects.
"""

from __future__ import annotations

import time
from collections.abc import Iterable
from typing import Any

import numpy as np
import torch

from parameter_server_tpu_torch.data.batch import (
    BatchBuilder,
    CSRBatch,
    batch_to_device,
    trim_batch,
)
from parameter_server_tpu_torch.data.reader import MinibatchReader
from parameter_server_tpu_torch.kv.store import (
    KVStore,
    State,
    pull,
    push,
    state_from_numpy,
    state_to_numpy,
)
from parameter_server_tpu_torch.kv.updaters import Updater, make_updater
from parameter_server_tpu_torch.models import metrics as M
from parameter_server_tpu_torch.models.evaluation import linear_predict
from parameter_server_tpu_torch.ops.sparse import csr_grad, csr_logits, logistic_loss
from parameter_server_tpu_torch.utils import trace
from parameter_server_tpu_torch.utils.config import PSConfig
from parameter_server_tpu_torch.utils.metrics import ProgressReporter


def updater_from_config(cfg: PSConfig) -> Updater:
    algo = cfg.solver.algo
    if algo == "ftrl":
        return make_updater(
            "ftrl",
            alpha=cfg.lr.alpha,
            beta=cfg.lr.beta,
            lambda_l1=cfg.penalty.lambda_l1,
            lambda_l2=cfg.penalty.lambda_l2,
        )
    if algo == "adagrad":
        return make_updater("adagrad", eta=cfg.lr.eta, lambda_l2=cfg.penalty.lambda_l2)
    if algo == "sgd":
        return make_updater("sgd", eta=cfg.lr.eta, lambda_l2=cfg.penalty.lambda_l2)
    raise ValueError(f"linear_method solver '{algo}' is not a streaming updater")


def _forward(
    updater: Updater, state: State, batch: dict[str, torch.Tensor]
) -> tuple[torch.Tensor, torch.Tensor]:
    """Pull the batch's weights and compute its logits from them."""
    w_u = pull(updater, state, batch["unique_keys"])
    logits = csr_logits(
        w_u, batch["values"], batch["local_ids"], batch["row_ids"],
        num_rows=batch["labels"].shape[0],
    )
    return w_u, logits


def train_step(
    updater: Updater, state: State, batch: dict[str, torch.Tensor]
) -> tuple[State, dict[str, torch.Tensor]]:
    """One pull -> grad -> push step, updating ``state`` IN PLACE (the JAX
    package donates the state instead). ``batch`` holds the device tensors
    of a CSRBatch (see ``batch_to_device``)."""
    idx = batch["unique_keys"]
    _, logits = _forward(updater, state, batch)
    loss, err = logistic_loss(logits, batch["labels"], batch["example_mask"])
    g = csr_grad(
        err, batch["values"], batch["local_ids"], batch["row_ids"],
        num_unique=idx.shape[0],
    )
    push(updater, state, idx, g)
    out = {
        "loss_sum": loss,
        "probs": torch.sigmoid(logits),
        "logits": logits,
    }
    return state, out


def predict_step(
    updater: Updater, state: State, batch: dict[str, torch.Tensor]
) -> torch.Tensor:
    _, logits = _forward(updater, state, batch)
    return torch.sigmoid(logits)


class LinearMethod:
    """The app object: owns the KVStore on one device (``cuda`` unless the
    caller passes ``device="cpu"``), streams batches, reports progress."""

    def __init__(
        self,
        cfg: PSConfig,
        reporter: ProgressReporter | None = None,
        device: Any = "cuda",
    ):
        self.cfg = cfg
        self.updater = updater_from_config(cfg)
        self.store = KVStore(self.updater, cfg.data.num_keys, device=device)
        self.device = self.store.device
        self.reporter = reporter or ProgressReporter()
        self.examples_seen = 0

    def make_builder(self, key_mode: str = "hash") -> BatchBuilder:
        """The training builder for batches built ahead of their steps (in
        memory, cached): on a CUDA device they are page-locked and reach
        the device without blocking the host."""
        from parameter_server_tpu_torch.data.batch import training_builder

        return training_builder(self.cfg, key_mode, device=self.device)

    def train(
        self,
        batches: Iterable[CSRBatch],
        report_every: int = 50,
    ) -> dict[str, Any]:
        """Run the streaming solver over ``batches``; returns final metrics."""
        t0 = time.perf_counter()
        # device results accumulate un-synced so host work overlaps device
        # compute; the report's AUC is queued behind them on the device, and
        # all of it is read back at once
        window_loss: list[torch.Tensor] = []
        window_probs: list[torch.Tensor] = []
        window_labels: list[torch.Tensor] = []
        n_since = 0
        last: dict[str, Any] = {}

        def _flush() -> dict[str, Any]:
            nonlocal window_loss, window_probs, window_labels, n_since, t0
            with trace.span("linear.report", cat="step"):
                with trace.span("linear.report.auc", cat="step"):
                    auc_t = M.auc_tensor(torch.cat(window_labels), torch.cat(window_probs))
                    trace.counter("linear.report.ranked", n_since, cat="step")
                with trace.span("linear.report.readback", cat="step"):
                    *losses, auc = torch.cat(
                        [torch.stack(window_loss).double(), auc_t.reshape(1)]).tolist()
                loss_sum = float(sum(losses))
                rec = self.reporter.report(
                    examples=self.examples_seen,
                    objv=loss_sum / max(n_since, 1),
                    auc=auc,
                    ex_per_sec=n_since / max(time.perf_counter() - t0, 1e-9),
                )
                window_loss, window_probs, window_labels = [], [], []
                n_since = 0
                t0 = time.perf_counter()
            return rec

        # a step ends once the next batch is in hand, so the fetch that
        # ends the stream falls inside the last step and opens none
        it = iter(batches)
        with trace.span("linear.fetch", cat="step"):
            b = next(it, None)
        step_i = 0
        while b is not None:
            with trace.span("linear.step", cat="step"):
                with trace.span("linear.h2d", cat="step"):
                    b = trim_batch(b)
                    dev = batch_to_device(b, self.device)
                with trace.span("linear.launch", cat="step"):
                    _, out = train_step(self.updater, self.store.state, dev)
                    slots = len(b.unique_keys)
                    trace.counter("linear.slots", slots, cat="step")
                    trace.counter("linear.pad_slots", slots - b.num_unique, cat="step")
                    self.examples_seen += b.num_examples
                    n_since += b.num_examples
                    window_loss.append(out["loss_sum"])
                    window_probs.append(out["probs"][: b.num_examples])
                    window_labels.append(dev["labels"][: b.num_examples])
                with trace.span("linear.fetch", cat="step"):
                    b = next(it, None)
            step_i += 1
            if step_i % report_every == 0:
                last = _flush()
        if n_since:
            last = _flush()
        return last

    def train_files(
        self, files: list[str], key_mode: str = "hash", report_every: int = 50
    ) -> dict[str, Any]:
        from parameter_server_tpu_torch.data.batch import training_builder

        # plain numpy batches: the reader's prefetch thread, not the step,
        # sets the pace here (a batch's parse and build take tens of ms),
        # and building in page-locked memory costs that thread more than
        # the non-blocking copy saves the step
        reader = MinibatchReader(
            files,
            self.cfg.data.format,
            training_builder(self.cfg, key_mode),
            epochs=self.cfg.solver.epochs,
        )
        return self.train(reader, report_every=report_every)

    def predict(self, batches: Iterable[CSRBatch]) -> tuple[np.ndarray, np.ndarray]:
        """Returns (labels, probs) over the stream."""
        return linear_predict(batches, self.device, self.store.pull)

    def evaluate(self, batches: Iterable[CSRBatch]) -> dict[str, float]:
        """Batch evaluation: AUC and logloss over the stream."""
        y, p = self.predict(batches)
        return {"auc": M.auc(y, p), "logloss": M.logloss(y, p), "examples": len(y)}

    def save(self, ckpt_dir: str) -> None:
        """Checkpoint of the KV state + training cursor, in the JAX
        package's format (either package loads the other's)."""
        from parameter_server_tpu_torch.utils.checkpoint import save_checkpoint

        save_checkpoint(
            ckpt_dir,
            {"kv": state_to_numpy(self.store.state)},
            meta={
                "examples_seen": self.examples_seen,
                "algo": self.cfg.solver.algo,
                "num_keys": self.cfg.data.num_keys,
            },
        )

    def load(self, ckpt_dir: str) -> None:
        from parameter_server_tpu_torch.utils.checkpoint import load_checkpoint

        state, meta = load_checkpoint(ckpt_dir)
        if meta.get("num_keys") != self.cfg.data.num_keys:
            raise ValueError(
                f"checkpoint num_keys {meta.get('num_keys')} != config "
                f"{self.cfg.data.num_keys}"
            )
        if meta.get("algo") != self.cfg.solver.algo:
            raise ValueError(
                f"checkpoint algo {meta.get('algo')!r} != config "
                f"{self.cfg.solver.algo!r}: updater state is not transferable"
            )
        self.store.state = state_from_numpy(state["kv"], self.device)
        self.examples_seen = int(meta.get("examples_seen", 0))

    def dump_model(self, path: str) -> int:
        """Text dump of nonzero weights (key\\tweight)."""
        from parameter_server_tpu_torch.utils.checkpoint import dump_weights_text

        return dump_weights_text(self.store.weights()[:, 0].cpu().numpy(), path)
