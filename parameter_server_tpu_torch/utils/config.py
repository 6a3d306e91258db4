"""Typed configuration, loadable from JSON or TOML.

A copy of the JAX package's config tree: the same sections, fields and
defaults, so one config file drives either package, and an unknown field
still raises. The port reads the sections the JAX runtime reads; its CLI
refuses an unknown app, and on the cluster path (``node``, ``launch``)
every app but ``linear_method``, as the JAX cluster runs only that one.
Field meanings are documented on the JAX package's dataclasses.
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path
from typing import Any


@dataclass
class DataConfig:
    files: list[str] = field(default_factory=list)
    format: str = "libsvm"  # libsvm | criteo | adfea | cache
    num_keys: int = 1 << 22  # dense hashed key-space size (incl. pad row 0)
    val_files: list[str] = field(default_factory=list)
    max_nnz_per_example: int = 512
    cache_dir: str = ""
    freq_min_count: int = 0  # frequency-filter admission; 0 disables
    pipeline_depth: int = 2
    bucket_nnz: bool = True  # pad batches to power-of-two entry buckets
    compact_wire: bool = True
    wire_values: str = "f32"


@dataclass
class LearningRateConfig:
    alpha: float = 0.1
    beta: float = 1.0
    eta: float = 0.1
    decay: float = 0.0


@dataclass
class PenaltyConfig:
    lambda_l1: float = 1.0
    lambda_l2: float = 0.0


@dataclass
class SolverConfig:
    algo: str = "ftrl"  # ftrl | adagrad | sgd | darlin
    minibatch: int = 4096
    max_delay: int = 0
    steps_per_call: int = 1
    epochs: int = 1
    block_iters: int = 20
    feature_blocks: int = 16
    block_chunk: int = 0
    kkt_filter_threshold: float = 0.0
    epsilon: float = 1e-4


@dataclass
class GraphConfig:
    num_partitions: int = 8
    balance_penalty: float = 1.0


@dataclass
class MFConfig:
    num_users: int = 1000
    num_items: int = 1000
    rank: int = 64
    eta: float = 0.05
    l2: float = 0.01
    algo: str = "adagrad"
    batch_size: int = 4096
    block_lines: int = 1 << 20


@dataclass
class W2VConfig:
    vocab_size: int = 1 << 16
    dim: int = 64
    window: int = 2
    negatives: int = 5
    eta: float = 0.3
    batch_size: int = 8192
    block_tokens: int = 1 << 20


@dataclass
class WDConfig:
    emb_dim: int = 16
    hidden: list[int] = field(default_factory=lambda: [32, 16])
    emb_eta: float = 0.05
    mlp_lr: float = 1e-3


@dataclass
class SketchConfig:
    width: int = 1 << 20
    depth: int = 4
    min_count: int = 2


@dataclass
class FilterConfig:
    key_caching: bool = True
    compressing: bool = False
    fixing_float_bytes: int = 0


@dataclass
class WireConfig:
    window: int = 8
    max_inflight_pushes: int = 0
    adaptive_window: bool = False
    hdr_codec: str = "bin"
    quant: str = "off"
    quant_seg: int = 256
    quant_pull: bool = False


@dataclass
class ServerConfig:
    apply_queue: int = 256
    max_batch: int = 64
    adaptive_batch: bool = False
    lane_hi: int = 4
    lane_lo: int = 16
    withheld_max_mb: int = 8


@dataclass
class ServeConfig:
    cache: bool = False
    ttl_ms: int = 50
    max_stale_ms: int = 500
    cache_entries: int = 1024
    hot_min_pulls: int = 2
    encode_cache_entries: int = 256
    encode_cache_mb: int = 64
    snapshot_keys_max: int = 1 << 22
    shed_queue_depth: int = 0
    shed_withheld_mb: int = 0
    retry_after_ms: int = 20


@dataclass
class ParallelConfig:
    kv_shards: int = 1
    data_shards: int = 1
    push_mode: str = "per_worker"


@dataclass
class MeshConfig:
    backend: str = "socket"
    kv_shards: int = 0
    quant: str = "off"
    quant_seg: int = 256


@dataclass
class FaultConfig:
    heartbeat_interval_s: float = 2.0
    heartbeat_timeout_s: float = 10.0
    straggler_reassign_s: float = 0.0
    startup_grace_s: float = 60.0
    server_ckpt_interval_s: float = 0.0
    server_restart_grace_s: float = 0.0
    reconnect_timeout_s: float = 60.0
    recovery_sweep_interval_s: float = 0.5
    fault_plan: str = ""
    fault_seed: int = 0


@dataclass
class TraceConfig:
    trace_dir: str = ""
    capacity: int = 65536
    sample: int = 1
    tail: bool = True
    tail_k: int = 4
    tail_limbo: int = 8192


@dataclass
class BlackboxConfig:
    dir: str = ""
    capacity: int = 4096
    flush_interval_s: float = 1.0
    watchdog_interval_s: float = 1.0
    stall_timeout_s: float = 30.0


@dataclass
class TimeseriesConfig:
    capacity: int = 360
    window_s: float = 60.0
    metrics_port: int = 0
    metrics_host: str = "127.0.0.1"


@dataclass
class ProfileConfig:
    hz: float = 0.0
    top_n: int = 5
    max_depth: int = 24
    dump_dir: str = ""


@dataclass
class AuditConfig:
    enabled: bool = True
    spool_capacity: int = 4096
    batch_events: int = 512
    watermark_s: float = 15.0
    heal_timeout_s: float = 30.0
    shed_storm_n: int = 10
    shed_storm_window_s: float = 1.0
    recent: int = 256


@dataclass
class SloConfig:
    rules: list[str] = field(default_factory=lambda: [
        "push_p99_ms p99:server.push <= 250",
        "shed_rate rate:serve_shed <= 10",
        "stall_count rate:watchdog_stalls <= 0",
        "ssp_blocked_ms rate:ssp_blocked_ms <= 500",
        "apply_queue_depth p99:server.apply_queue.n <= 192",
        "replication_lag_s p99:replication_lag_s <= 1",
        "pull_age_ms p99:serve.age_s <= 1000",
        "ssp_lag_clocks p99:ssp.lag_clocks.n <= 8",
        "audit_violations rate:audit_violations <= 0 target 0.9 burn 1",
    ])
    short_window_s: float = 60.0
    long_window_s: float = 300.0


@dataclass
class PSConfig:
    """Top-level app config."""

    app: str = "linear_method"
    data: DataConfig = field(default_factory=DataConfig)
    lr: LearningRateConfig = field(default_factory=LearningRateConfig)
    penalty: PenaltyConfig = field(default_factory=PenaltyConfig)
    solver: SolverConfig = field(default_factory=SolverConfig)
    filter: FilterConfig = field(default_factory=FilterConfig)
    graph: GraphConfig = field(default_factory=GraphConfig)
    sketch: SketchConfig = field(default_factory=SketchConfig)
    mf: MFConfig = field(default_factory=MFConfig)
    w2v: W2VConfig = field(default_factory=W2VConfig)
    wd: WDConfig = field(default_factory=WDConfig)
    parallel: ParallelConfig = field(default_factory=ParallelConfig)
    mesh: MeshConfig = field(default_factory=MeshConfig)
    wire: WireConfig = field(default_factory=WireConfig)
    server: ServerConfig = field(default_factory=ServerConfig)
    serve: ServeConfig = field(default_factory=ServeConfig)
    fault: FaultConfig = field(default_factory=FaultConfig)
    trace: TraceConfig = field(default_factory=TraceConfig)
    blackbox: BlackboxConfig = field(default_factory=BlackboxConfig)
    timeseries: TimeseriesConfig = field(default_factory=TimeseriesConfig)
    profile: ProfileConfig = field(default_factory=ProfileConfig)
    slo: SloConfig = field(default_factory=SloConfig)
    audit: AuditConfig = field(default_factory=AuditConfig)
    model_output: str = ""
    report_interval: int = 1
    seed: int = 0


def _from_dict(cls: type, d: dict[str, Any]) -> Any:
    known = {f.name for f in dataclasses.fields(cls)}
    unknown = set(d) - known
    if unknown:
        raise ValueError(
            f"unknown {cls.__name__} field(s) {sorted(unknown)}; known: {sorted(known)}"
        )
    kwargs = {}
    for f in dataclasses.fields(cls):
        if f.name not in d:
            continue
        v = d[f.name]
        if f.name in _NESTED:
            if not isinstance(v, dict):
                raise TypeError(
                    f"config section '{f.name}' must be a table/object, got {type(v).__name__}"
                )
            kwargs[f.name] = _from_dict(_NESTED[f.name], v)
        else:
            kwargs[f.name] = v
    return cls(**kwargs)


_NESTED = {
    "data": DataConfig,
    "lr": LearningRateConfig,
    "penalty": PenaltyConfig,
    "solver": SolverConfig,
    "filter": FilterConfig,
    "graph": GraphConfig,
    "sketch": SketchConfig,
    "mf": MFConfig,
    "w2v": W2VConfig,
    "wd": WDConfig,
    "parallel": ParallelConfig,
    "mesh": MeshConfig,
    "wire": WireConfig,
    "server": ServerConfig,
    "serve": ServeConfig,
    "fault": FaultConfig,
    "trace": TraceConfig,
    "blackbox": BlackboxConfig,
    "timeseries": TimeseriesConfig,
    "profile": ProfileConfig,
    "slo": SloConfig,
    "audit": AuditConfig,
}


def toml_module():
    """stdlib tomllib (python >= 3.11), else its upstream tomli, else
    pip's vendored copy."""
    try:
        import tomllib
    except ModuleNotFoundError:
        try:
            import tomli as tomllib
        except ModuleNotFoundError:
            from pip._vendor import tomli as tomllib
    return tomllib


def load_config(path: str | Path) -> PSConfig:
    """Load a PSConfig from a .json or .toml file."""
    p = Path(path)
    if p.suffix == ".toml":
        d = toml_module().loads(p.read_text())
    else:
        d = json.loads(p.read_text())
    return _from_dict(PSConfig, d)


def config_to_dict(cfg: PSConfig) -> dict[str, Any]:
    return dataclasses.asdict(cfg)
