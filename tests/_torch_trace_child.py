"""Child process for tests/test_torch_trace.py: one port shard server on
the CPU with tracing armed through the PS_TRACE_DIR env var (the path
spawned nodes use). Prints its RPC address, serves until a client's
shutdown frame, then exports its trace file. Imports no JAX.

Usage: python tests/_torch_trace_child.py
"""

from __future__ import annotations


def main() -> None:
    import os
    import sys

    sys.modules["jax"] = None  # a port process: any JAX import fails

    from parameter_server_tpu_torch.kv.updaters import Sgd
    from parameter_server_tpu_torch.parallel.multislice import ShardServer
    from parameter_server_tpu_torch.utils import trace
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    # env-armed at import already; re-configure for a readable export name
    trace.configure(os.environ[trace.TRACE_DIR_ENV], process_name="server-0")
    srv = ShardServer(Sgd(eta=0.1), KeyRange(0, 4096), device="cpu")
    print("ADDR", srv.address, flush=True)
    srv.serve_forever()  # until the client's shutdown frame
    trace.tracer.flush()
    assert not any(m == "parameter_server_tpu" or m.startswith("parameter_server_tpu.")
                   for m in sys.modules)


if __name__ == "__main__":
    main()
