"""The training progress table (the JAX package's ``ProgressReporter``)."""

from __future__ import annotations

import json
import time
from pathlib import Path
from typing import Any


class ProgressReporter:
    """Merge progress dicts; print a step table; append JSONL.

    Columns follow the reference's printed progress: objective, relative
    objective, AUC, nnz(w), examples/sec, plus the wire tier's recovery
    counters (empty on the single-host path)."""

    _COLS = (
        "sec", "examples", "objv", "rel_objv", "auc", "nnz_w", "ex_per_sec",
        "rpc_retries", "rpc_reconnects", "rpc_dedup_hits",
    )
    #: re-print the header periodically so long runs stay readable
    _HEADER_EVERY = 25

    def __init__(self, jsonl_path: str | Path | None = None, print_fn=print):
        self._path = Path(jsonl_path) if jsonl_path else None
        self._print = print_fn
        self._start = time.perf_counter()
        self._last_objv: float | None = None
        self._rows_since_header = self._HEADER_EVERY  # first row prints it
        self.history: list[dict[str, Any]] = []

    def report(self, **fields: Any) -> dict[str, Any]:
        now = time.perf_counter() - self._start
        rec: dict[str, Any] = {"sec": round(now, 3), **fields}
        objv = fields.get("objv")
        if objv is not None and self._last_objv not in (None, 0.0):
            rec["rel_objv"] = (self._last_objv - objv) / abs(self._last_objv)
        if objv is not None:
            self._last_objv = float(objv)
        self.history.append(rec)
        if self._path is not None:
            with self._path.open("a") as f:
                f.write(json.dumps(rec) + "\n")
        self._print_row(rec)
        return rec

    def _print_row(self, rec: dict[str, Any]) -> None:
        if self._rows_since_header >= self._HEADER_EVERY:
            self._print("  ".join(f"{c:>12}" for c in self._COLS))
            self._rows_since_header = 0
        self._rows_since_header += 1
        cells = []
        for c in self._COLS:
            v = rec.get(c, "")
            if isinstance(v, float):
                cells.append(f"{v:>12.5g}")
            else:
                cells.append(f"{v!s:>12}")
        self._print("  ".join(cells))
