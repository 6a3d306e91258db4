"""Child process for the port's live-ops and audit tests: one "worker" node
of ``parameter_server_tpu_torch`` that registers with the parent's
coordinator and heartbeats through the port's ``HeartbeatReporter``.

Modes:
  top    heartbeats real telemetry (per-beat latency observations and
         counter bumps through the bounded ``beat_telemetry()`` payload);
  audit  also arms the audit spool and injects an acked push that no
         apply ever commits and a same-life version rollback, so the
         coordinator's streaming auditor must flag both.

Usage: python _torch_liveops_child.py <coordinator host:port> top|audit
"""

from __future__ import annotations


def main() -> None:
    import sys
    import time

    from parameter_server_tpu_torch.parallel.control import ControlClient
    from parameter_server_tpu_torch.utils import flightrec
    from parameter_server_tpu_torch.utils.heartbeat import HeartbeatReporter, host_stats
    from parameter_server_tpu_torch.utils.metrics import latency_histograms, wire_counters
    from parameter_server_tpu_torch.utils.timeseries import beat_telemetry

    addr, mode = sys.argv[1], sys.argv[2]
    ctl = ControlClient(addr, reconnect_timeout_s=5.0)
    nid = ctl.register("worker", rank=0)
    if mode == "audit":
        flightrec.configure_spool(4096)
        flightrec.record("rpc.reply", cmd="push", cid="cX", seq="k9", ok=True)
        flightrec.record("rcu.publish", ver=(7 << 40) + 101)
        flightrec.record("rcu.publish", ver=(7 << 40) + 99)

    class _Sink:
        """ctl.beat as a reporter sink, with the delivery verdict the
        spool's ack path reads."""

        def beat(self, node_id: int, stats: dict | None = None) -> bool:
            try:
                ctl.beat(node_id, stats)
                return True
            except Exception:  # noqa: BLE001 — the next beat retries
                return False

    def stats() -> dict:
        # a steady synthetic load, so windowed rates and p99s are nonzero
        for _ in range(5):
            latency_histograms.observe("client.push", 0.004)
            latency_histograms.observe("client.pull", 0.002)
        wire_counters.inc("wire_bytes_out", 1000)
        return {**host_stats(), "telemetry": beat_telemetry()}

    rep = HeartbeatReporter(_Sink(), nid, 0.1, stats_fn=stats)
    rep.start()
    print("READY", nid, flush=True)
    while True:
        time.sleep(1.0)


if __name__ == "__main__":
    main()
