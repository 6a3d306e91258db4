"""Static collective-traffic accounting.

A copy of the JAX package's ``parallel/traffic.py``. Per-step collective
sizes are computable from the shapes; ``PodTrainer`` reports this estimate
beside its progress rows, and the SPMD tier's measured collective bytes
are held against it."""

from __future__ import annotations

from dataclasses import dataclass


@dataclass(frozen=True)
class StepTraffic:
    """Estimated bytes moved by ONE SPMD train step (per device)."""

    pull_bytes: int  # psum over kv of pulled rows
    push_bytes: int  # all_gather of (idx, grads) over data
    total_bytes: int


def linear_step_traffic(
    unique_capacity: int,
    vdim: int,
    data_shards: int,
    kv_shards: int,
    value_bytes: int = 4,
    index_bytes: int = 4,
    push_mode: str = "per_worker",
    num_keys: int = 0,
) -> StepTraffic:
    """Traffic of the sparse-LR SPMD step (parallel.spmd).

    pull: psum over 'kv' of a (U, vdim) float array — ring all-reduce moves
    ~2 * (S-1)/S of the array per device.
    push, per_worker mode: all_gather over 'data' of (U,) indices +
    (U, vdim) grads — ring gather moves (D-1)/D of the full gathered size
    per device.
    push, aggregate mode: psum over 'data' of the dense
    (num_keys/kv_shards, vdim) range slice (+ the touched-count column) —
    ~2 * (D-1)/D of the slice per device, independent of D·U. Crossover:
    aggregate wins when 2·(S+...)·slice < D·U rows, i.e. for dense-enough
    batches or large worker counts."""
    u = unique_capacity
    pull = 0
    if kv_shards > 1:
        pull = int(2 * (kv_shards - 1) / kv_shards * u * vdim * value_bytes)
    push = 0
    if data_shards > 1:
        if push_mode == "aggregate":
            if num_keys <= 0:
                raise ValueError("aggregate mode needs num_keys")
            slice_rows = num_keys // kv_shards
            full = slice_rows * (vdim + 1) * value_bytes  # grads + touched col
            push = int(2 * (data_shards - 1) / data_shards * full)
        elif push_mode == "quantized":
            # int8 payload + one f32 scale per worker (fixing_float as a
            # quantized collective); indices unchanged
            full = data_shards * (u * (index_bytes + vdim) + value_bytes)
            push = int((data_shards - 1) / data_shards * full)
        else:
            full = data_shards * u * (index_bytes + vdim * value_bytes)
            push = int((data_shards - 1) / data_shards * full)
    return StepTraffic(pull, push, pull + push)


@dataclass(frozen=True)
class WireTraffic:
    """Estimated bytes for ONE pull+push round against one shard server
    over the TCP wire tier (payloads only; each of the 4 frames adds
    ~8 B length prefix + a small JSON header on top)."""

    out_bytes: int  # worker -> server: pull request + push request
    in_bytes: int  # server -> worker: pull reply (+ push ack header)


def wire_step_traffic(
    num_unique: int,
    vdim: int = 1,
    key_bytes: int = 4,
    value_bytes: int = 4,
    send_keys: bool = True,
) -> WireTraffic:
    """Payload traffic of one wire-tier worker step (multislice tier):
    the batch's key list rides the wire ONCE per step — the pull sends it
    and primes the key-caching signature, so the same step's push is
    sig-only; the pull reply carries U weights and the push carries U
    gradients. send_keys=False models a fully warm cache (repeated key
    set): both calls are sig-only. Reconciled against the MEASURED
    RpcClient byte counters in tests/test_multislice.py — the reference's
    Postoffice counters report exactly this quantity per filter stage."""
    u = num_unique
    keys = u * key_bytes if send_keys else 0
    return WireTraffic(
        out_bytes=keys + u * vdim * value_bytes,
        in_bytes=u * vdim * value_bytes,
    )


def quantization_savings(num_bytes: int, value_bytes: int = 4) -> float:
    """Fraction of push payload saved by the fixed-point codec on DCN
    (ref: the filter savings report)."""
    return 1.0 - num_bytes / value_bytes
