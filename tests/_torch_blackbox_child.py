"""Child process for tests/test_torch_blackbox.py: one port shard server
on the CPU with the flight recorder armed through the PS_BLACKBOX_DIR env
var (the path launch_local uses) and a fast periodic flush, so the box it
leaves behind is at most ~100 ms stale when the parent SIGKILLs it. A
PS_FAULT_PLAN in the env arms frame chaos on its RpcServer. Imports no
JAX.

Usage: python tests/_torch_blackbox_child.py
"""

from __future__ import annotations


def main() -> None:
    import os
    import sys
    import time

    sys.modules["jax"] = None  # a port process: any JAX import fails

    from parameter_server_tpu_torch.kv.updaters import Sgd
    from parameter_server_tpu_torch.parallel.multislice import ShardServer
    from parameter_server_tpu_torch.utils import flightrec
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    # env-armed at import already; re-configure for a readable dump name
    # and a flush cadence tight enough that a SIGKILL loses <~100 ms
    flightrec.configure(
        os.environ[flightrec.BLACKBOX_DIR_ENV], process_name="server-0",
        flush_interval_s=0.05,
        watchdog_interval_s=60,  # the test induces a crash, not a stall
    )
    srv = ShardServer(Sgd(eta=0.1), KeyRange(0, 4096), device="cpu")
    srv.start()
    print("ADDR", srv.address, flush=True)
    while True:  # serve until killed; the flusher makes the box survive
        time.sleep(1)


if __name__ == "__main__":
    main()
