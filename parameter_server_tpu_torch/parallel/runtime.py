"""Process bootstrap of a sharded run.

The JAX package's ``runtime.init`` starts ``jax.distributed`` and builds
the global (data, kv) mesh from every process's devices, kv within each
process and data across processes. The port starts one process per mesh
cell instead (``parallel/mesh.py``), so this is JAX's multi-host contract
with one data row per process:

    rt = runtime.init(coordinator_addr, num_processes, process_id, cfg=cfg)
    trainer = PodTrainer(cfg, runtime=rt)
    trainer.train_files(all_files)  # the trainer shards the list per data row
    rt.shutdown()

``num_processes`` is D x KV, and every rank of a data row reads the same
files and builds the same batches. Each rank holds its own kv slice of
every table; ``state_to_host`` gathers the full table on every rank of a
data row, as every JAX host holds a replica.

Backends: ``gloo`` for CPU tensors; ``nccl`` for one rank a GPU, world size
1 included. Ranks that share one card ask for ``gloo`` on CUDA tensors
explicitly (``backend="gloo"``); nothing switches backend or device on its
own. A second ``gloo`` group over the world carries the host-side control
plane (bucket agreement, barriers, the progress AUC), so those never wait
on the device stream.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Any

import numpy as np
import torch
import torch.distributed as dist

from parameter_server_tpu_torch.device import resolve_device
from parameter_server_tpu_torch.parallel.mesh import Mesh, make_mesh
from parameter_server_tpu_torch.parallel.spmd import unshard_state


@dataclass(frozen=True)
class Runtime:
    """Handle on the initialized world and this rank's place in the mesh."""

    mesh: Mesh
    process_index: int  # this rank
    process_count: int  # D x KV
    data_shards: int
    kv_shards: int
    cp_group: Any = None  # the host-side (gloo, CPU) group over the world

    # -- input sharding ---------------------------------------------------

    def shard_files(self, files: list[str]) -> list[str]:
        """This data row's input file shard (every rank of the row reads
        the same files)."""
        return list(files)[self.mesh.d :: self.data_shards]

    def globalize_batch(self, arrays: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """This rank's host batch arrays (its one data shard's) as tensors
        on its device."""
        return {
            k: torch.from_numpy(np.ascontiguousarray(v)).to(self.mesh.device)
            for k, v in arrays.items()
        }

    # -- state --------------------------------------------------------------

    def init_state(self, updater, rows: int, vdim: int = 1) -> dict[str, torch.Tensor]:
        """This rank's kv slice of ``updater``'s tables of ``rows`` rows (a
        multiple of KV), made on the device: no full host copy."""
        if rows % self.kv_shards:
            raise ValueError(f"{rows} table rows not divisible by {self.kv_shards} kv shards")
        return updater.init(rows // self.kv_shards, vdim, device=self.mesh.device)

    def state_to_host(self, state: dict[str, torch.Tensor]) -> dict[str, np.ndarray]:
        """The FULL tables on every rank of this data row, gathered over
        its kv group. Collective: every rank calls it."""
        return unshard_state(state, self.mesh)

    def state_from_host(self, host_state: dict[str, np.ndarray]) -> dict[str, torch.Tensor]:
        """Inverse of ``state_to_host``: this rank takes its kv slice of
        full host tables."""
        out = {}
        for name, v in host_state.items():
            rows = v.shape[0]
            if rows % self.kv_shards:
                raise ValueError(
                    f"{name}: {rows} rows not divisible by {self.kv_shards} kv shards")
            s = rows // self.kv_shards
            out[name] = torch.from_numpy(
                np.ascontiguousarray(v[self.mesh.k * s : (self.mesh.k + 1) * s])
            ).to(self.mesh.device)
        return out

    # -- checkpoint -------------------------------------------------------

    def save_checkpoint(self, ckpt_dir, state: dict, meta: dict | None = None) -> None:
        """Rank 0 writes the full tables (one shard, the JAX package's
        format), then every rank waits at a barrier. Collective."""
        from parameter_server_tpu_torch.utils.checkpoint import save_checkpoint

        host = self.state_to_host(state)
        if self.process_index == 0:
            save_checkpoint(ckpt_dir, host, meta=meta)
        self.barrier()

    def load_checkpoint(self, ckpt_dir, num_keys: int, rows: int) -> tuple[dict, dict]:
        """Every rank reads all shards (contiguous key ranges, any count:
        either package's pod checkpoint), keeps the first ``num_keys`` rows,
        zero-pads them to this mesh's ``rows`` and takes its kv slice."""
        from parameter_server_tpu_torch.utils.checkpoint import load_checkpoint

        host, meta = load_checkpoint(ckpt_dir)
        padded = {}
        for name, v in host.items():
            v = np.asarray(v)[:num_keys]
            padded[name] = np.concatenate(
                [v, np.zeros((rows - v.shape[0], *v.shape[1:]), v.dtype)]
            )
        return self.state_from_host(padded), meta

    # -- control plane ------------------------------------------------------

    def cp_allmax(self, values: tuple[int, ...]) -> tuple[int, ...]:
        """Elementwise max of ``values`` over every rank, on the host-side
        group (no device sync). Collective."""
        t = torch.tensor([int(v) for v in values], dtype=torch.int64)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.cp_group)
        return tuple(int(v) for v in t.tolist())

    def all_gather_object(self, obj: Any) -> list:
        """``obj`` from every rank, in rank order, on the host-side group.
        Collective."""
        return self.mesh.all_gather_object(obj)

    def barrier(self) -> None:
        dist.barrier(group=self.cp_group)

    def shutdown(self) -> None:
        """Tear down the groups and the world (idempotent)."""
        if dist.is_initialized():
            dist.destroy_process_group()


def init(
    coordinator_addr: str | None = None,
    num_processes: int | None = None,
    process_id: int | None = None,
    kv_shards: int = 1,
    data_shards: int | None = None,
    cfg=None,
    device: str | torch.device = "cuda",
    backend: str | None = None,
) -> Runtime:
    """Join this process to the world and build its mesh view.

    Without a coordinator it forms a world of one over a local store. With
    one (``host:port``), every one of the ``num_processes`` = D x KV
    processes calls it with the same address and its own ``process_id``.
    ``cfg``: a PSConfig whose ``parallel`` section gives the mesh shape;
    the explicit ``kv_shards``/``data_shards`` may not be given with it.
    ``device``: ``cuda`` (rank r takes card r % count) or ``cpu``;
    ``backend``: ``nccl`` or ``gloo``, by default ``nccl`` on the card and
    ``gloo`` on the CPU."""
    if cfg is not None:
        if kv_shards != 1 or data_shards is not None:
            raise ValueError(
                "pass EITHER cfg (mesh shape from cfg.parallel) OR explicit "
                "kv_shards/data_shards — not both"
            )
        kv_shards = cfg.parallel.kv_shards
        data_shards = cfg.parallel.data_shards
    if coordinator_addr is None and (num_processes or 1) > 1:
        # N processes without a coordinator would each run the whole workload
        raise ValueError(f"num_processes={num_processes} requires a coordinator address")
    if coordinator_addr is not None and (num_processes is None or num_processes < 2):
        # a forgotten --num_processes would yield N independent runs
        raise ValueError(
            f"a coordinator address requires num_processes >= 2 (got {num_processes!r})"
        )
    if dist.is_initialized():
        raise RuntimeError("torch.distributed is already initialized in this process")
    rank = process_id or 0
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", rank % torch.cuda.device_count())
    backend = backend or ("nccl" if dev.type == "cuda" else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"unknown backend {backend!r} (nccl or gloo)")
    if backend == "nccl":
        if dev.type != "cuda":
            raise ValueError("the nccl backend needs device cuda")
        torch.cuda.set_device(dev)
    if coordinator_addr is None:
        dist.init_process_group(backend, store=dist.HashStore(), rank=0, world_size=1)
    else:
        dist.init_process_group(
            backend, init_method=f"tcp://{coordinator_addr}", rank=rank,
            world_size=num_processes,
        )
    try:
        world = dist.get_world_size()
        data = data_shards if data_shards is not None else world // kv_shards
        cp_group = dist.new_group(backend="gloo")
        mesh = make_mesh(data, kv_shards, device=dev, cp_group=cp_group)
    except BaseException:
        dist.destroy_process_group()
        raise
    return Runtime(
        mesh=mesh, process_index=dist.get_rank(), process_count=world,
        data_shards=data, kv_shards=kv_shards, cp_group=cp_group,
    )
