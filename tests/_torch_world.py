"""Start a world of rank processes of the port and wait for it, with a
time limit of its own: a hung collective fails the test that started the
world instead of stalling the suite. On timeout, or as soon as any rank
fails, every rank of the world is killed."""

import os
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
RANK_SCRIPT = Path(__file__).resolve().parent / "_torch_rank.py"
RANK_TIMEOUT_S = 60


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_world(make_argvs, timeout: float = RANK_TIMEOUT_S) -> list[str]:
    """Run one process per argv of ``make_argvs(port)`` (``python <argv>``,
    ``port`` a free port for rank 0's store) with the repo on the path and
    one thread each; returns their stdouts in rank order. Raises
    AssertionError if any exits nonzero or the world outlasts ``timeout``
    seconds (at most ``RANK_TIMEOUT_S``). A world whose port was taken
    between its choice and rank 0's bind starts again on another port."""
    for attempt in range(3):
        try:
            return _run_once(make_argvs(free_port()), min(timeout, RANK_TIMEOUT_S))
        except AssertionError as e:
            if "address already in use" not in str(e).lower() or attempt == 2:
                raise


def _run_once(argvs: list[list[str]], timeout: float) -> list[str]:
    env = {**os.environ, "PYTHONPATH": str(ROOT), "OMP_NUM_THREADS": "1"}
    with tempfile.TemporaryDirectory() as logs:
        files = [(open(Path(logs) / f"{i}.out", "w+"), open(Path(logs) / f"{i}.err", "w+"))
                 for i in range(len(argvs))]
        try:
            procs = [
                subprocess.Popen([sys.executable, *argv], cwd=ROOT, env=env,
                                 stdout=out, stderr=err, text=True)
                for argv, (out, err) in zip(argvs, files)
            ]
            deadline = time.monotonic() + timeout
            failed = None
            try:
                while failed is None:
                    codes = [p.poll() for p in procs]
                    bad = [i for i, c in enumerate(codes) if c not in (None, 0)]
                    if bad:
                        failed = f"rank {bad[0]} exited {codes[bad[0]]}"
                    elif all(c == 0 for c in codes):
                        break
                    elif time.monotonic() > deadline:
                        failed = f"the world outlasted its {timeout} s limit"
                    else:
                        time.sleep(0.05)
            finally:
                for p in procs:
                    if p.poll() is None:
                        p.kill()
                for p in procs:
                    p.wait()
            texts = []
            for out, err in files:
                out.seek(0)
                err.seek(0)
                texts.append((out.read(), err.read()))
        finally:
            for out, err in files:
                out.close()
                err.close()
    if failed:
        detail = "\n".join(f"--- rank {i} stdout:\n{o[-3000:]}\n--- rank {i} stderr:\n"
                           f"{e[-3000:]}" for i, (o, e) in enumerate(texts))
        raise AssertionError(f"{failed}\n{detail}")
    return [o for o, _ in texts]


def rank_argvs(mode: str, plan: Path, world: int):
    """``make_argvs`` of ``_torch_rank.py`` for every rank of a
    ``world``-rank world."""
    return lambda port: [[str(RANK_SCRIPT), mode, str(plan), str(r), str(world), str(port)]
                         for r in range(world)]
