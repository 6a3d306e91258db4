"""linear_method: sparse logistic regression over the KV store.

The flagship app: stream minibatch -> localize -> pull weights -> CSR
gradient -> push, with the server updater (FTRL/AdaGrad/SGD) applied to the
touched rows. One ``train_step`` per minibatch: it gathers the touched rows
once, derives the weights from them (the pull), computes logits, loss and
gradient, asks the updater for the delta (on CUDA, FTRL's delta is the
hand-written ``ftrl_delta`` kernel) and scatter-adds it into the tables in
place. The fused push kernel is not used here: the step's rows are already
gathered for the pull, so its scatter-add costs the same one round trip per
row that the fused push would.
"""

from __future__ import annotations

import time
from collections.abc import Iterable
from typing import Any

import numpy as np
import torch

from parameter_server_tpu_torch.data.batch import BatchBuilder, CSRBatch
from parameter_server_tpu_torch.data.reader import MinibatchReader
from parameter_server_tpu_torch.kv.store import (
    KVStore,
    State,
    state_from_numpy,
    state_to_numpy,
)
from parameter_server_tpu_torch.kv.updaters import Updater, make_updater
from parameter_server_tpu_torch.models import metrics as M
from parameter_server_tpu_torch.ops.sparse import csr_grad, csr_logits, logistic_loss
from parameter_server_tpu_torch.utils.config import PSConfig
from parameter_server_tpu_torch.utils.metrics import ProgressReporter

_BATCH_FIELDS = (
    "unique_keys", "local_ids", "row_ids", "values", "labels", "example_mask",
)


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
) -> tuple[dict[str, torch.Tensor], torch.Tensor]:
    """Gather the batch's rows once and compute its logits from them."""
    idx = batch["unique_keys"]
    rows = {k: v.index_select(0, idx) for k, v in state.items()}
    w_u = updater.weights(rows)  # pull
    logits = csr_logits(
        w_u, batch["values"], batch["local_ids"], batch["row_ids"],
        num_rows=batch["labels"].shape[0],
    )
    return rows, logits


def train_step(
    updater: Updater, state: State, batch: dict[str, torch.Tensor]
) -> tuple[State, dict[str, torch.Tensor]]:
    """One pull -> grad -> push step, updating ``state`` IN PLACE (the JAX
    package donates the state instead). ``batch`` holds the device tensors
    of a CSRBatch (see ``batch_to_device``)."""
    idx = batch["unique_keys"]
    rows, logits = _forward(updater, state, batch)
    loss, err = logistic_loss(logits, batch["labels"], batch["example_mask"])
    g = csr_grad(
        err, batch["values"], batch["local_ids"], batch["row_ids"],
        num_unique=idx.shape[0],
    )
    deltas = updater.delta(rows, g)  # push: server-side updater ...
    for k, v in state.items():
        v.index_add_(0, idx, deltas[k])  # ... scatter-add
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


def batch_to_device(b: CSRBatch, device: Any) -> dict[str, torch.Tensor]:
    """The CSRBatch arrays as tensors on ``device``."""
    return {f: torch.from_numpy(getattr(b, f)).to(device) for f in _BATCH_FIELDS}


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
        from parameter_server_tpu_torch.data.batch import training_builder

        return training_builder(self.cfg, key_mode)

    def train(
        self,
        batches: Iterable[CSRBatch],
        report_every: int = 50,
    ) -> dict[str, Any]:
        """Run the streaming solver over ``batches``; returns final metrics."""
        t0 = time.perf_counter()
        # device results accumulate un-synced so host work overlaps device
        # compute; they are read back only at report time
        window_loss: list[torch.Tensor] = []
        window_probs: list[tuple[torch.Tensor, int]] = []
        window_labels: list[np.ndarray] = []
        n_since = 0
        last: dict[str, Any] = {}

        def _flush() -> dict[str, Any]:
            nonlocal window_loss, window_probs, window_labels, n_since, t0
            loss_sum = float(sum(torch.stack(window_loss).tolist()))
            p = torch.cat([pr[:n] for pr, n in window_probs]).cpu().numpy()
            y = np.concatenate(window_labels)
            rec = self.reporter.report(
                examples=self.examples_seen,
                objv=loss_sum / max(n_since, 1),
                auc=M.auc(y, p),
                ex_per_sec=n_since / max(time.perf_counter() - t0, 1e-9),
            )
            window_loss, window_probs, window_labels = [], [], []
            n_since = 0
            t0 = time.perf_counter()
            return rec

        for step_i, b in enumerate(batches):
            dev = batch_to_device(b, self.device)
            _, out = train_step(self.updater, self.store.state, dev)
            self.examples_seen += b.num_examples
            n_since += b.num_examples
            window_loss.append(out["loss_sum"])
            window_probs.append((out["probs"], b.num_examples))
            window_labels.append(b.labels[: b.num_examples])
            if (step_i + 1) % report_every == 0:
                last = _flush()
        if n_since:
            last = _flush()
        return last

    def train_files(
        self, files: list[str], key_mode: str = "hash", report_every: int = 50
    ) -> dict[str, Any]:
        reader = MinibatchReader(
            files,
            self.cfg.data.format,
            self.make_builder(key_mode),
            epochs=self.cfg.solver.epochs,
        )
        return self.train(reader, report_every=report_every)

    def predict(self, batches: Iterable[CSRBatch]) -> tuple[np.ndarray, np.ndarray]:
        """Returns (labels, probs) over the stream."""
        ys, ps = [], []
        for b in batches:
            probs = predict_step(
                self.updater, self.store.state, batch_to_device(b, self.device)
            )
            ps.append(probs[: b.num_examples].cpu().numpy())
            ys.append(b.labels[: b.num_examples])
        return np.concatenate(ys), np.concatenate(ps)

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
