"""The (data, kv) mesh over a ``torch.distributed`` world.

The JAX package's mesh is a grid of D x KV devices inside one program
(``jax.sharding.Mesh`` with axes "data" and "kv"). The port runs one
process per mesh cell instead, PyTorch's one-rank-per-device idiom: a
world of exactly D x KV ranks, rank r at ``(d, k) = divmod(r, KV)``.

- the **kv group** of data row d holds its KV ranks; JAX's
  ``psum(x, "kv")`` is an ``all_reduce`` on it;
- the **data group** of kv column k holds its D ranks; ``psum(x, "data")``
  is an ``all_reduce`` on it and ``all_gather(x, "data")`` an
  ``all_gather``.

Every rank creates every group, in the same order, even the groups it is
not in: a rank that skips one ``new_group`` call hangs the whole world.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any

import torch
import torch.distributed as dist


@dataclass(eq=False)
class Mesh:
    """This rank's place in the (data, kv) mesh: the mesh's shape, its own
    coordinates, the groups of its data row and kv column, and the device
    its tables and batches live on. ``payload_bytes`` counts the bytes this
    rank hands to each kind of collective (the tensors' sizes, not the
    wire traffic of the algorithm that moves them); ``quant_audit``, when
    set, counts the quantized pushes' rounding faults."""

    data: int
    kv: int
    d: int
    k: int
    device: torch.device
    data_group: Any = None
    kv_group: Any = None
    payload_bytes: dict = field(
        default_factory=lambda: {"all_reduce": 0, "all_gather": 0}
    )
    # a dict to hold every quantized push to its rounding bounds
    # (spmd.audit_rounding); None: no audit
    quant_audit: dict | None = None
    # the host-side (gloo, CPU) group over the world: the apps' progress
    # AUC gathers their data shards' labels and probabilities over it
    cp_group: Any = None

    @property
    def shape(self) -> dict[str, int]:
        return {"data": self.data, "kv": self.kv}

    @property
    def rank(self) -> int:
        return self.d * self.kv + self.k

    def _group(self, axis: str) -> tuple[Any, int]:
        if axis == "data":
            return self.data_group, self.data
        if axis == "kv":
            return self.kv_group, self.kv
        raise ValueError(f"unknown mesh axis {axis!r} (data or kv)")

    def psum_(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """In-place sum of ``t`` over the ranks of ``axis`` (JAX's
        ``lax.psum``); returns ``t``."""
        group, _ = self._group(axis)
        self.payload_bytes["all_reduce"] += t.numel() * t.element_size()
        dist.all_reduce(t, group=group)
        return t

    def all_gather(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """``t`` from every rank of ``axis``, stacked in axis order:
        (n, *t.shape) (JAX's ``lax.all_gather``)."""
        group, n = self._group(axis)
        t = t.contiguous()
        out = torch.empty((n, *t.shape), dtype=t.dtype, device=t.device)
        self.payload_bytes["all_gather"] += t.numel() * t.element_size()
        dist.all_gather(list(out.unbind(0)), t, group=group)
        return out

    def all_gather_object(self, obj: Any) -> list:
        """``obj`` from every rank of the world, in rank order, on the
        host-side group (no device sync). Collective."""
        out: list = [None] * (self.data * self.kv)
        dist.all_gather_object(out, obj, group=self.cp_group)
        return out


def make_mesh(
    data_shards: int, kv_shards: int, device: torch.device | str | None = None,
    cp_group: Any = None,
) -> Mesh:
    """This rank's view of a ``data_shards`` x ``kv_shards`` mesh over the
    initialized world (see ``runtime.init``), which must hold exactly
    D x KV ranks. ``device`` defaults to the CPU on gloo and to the current
    CUDA device on nccl; ``cp_group`` is the world's host-side group, if
    any. Collective: every rank of the world calls it."""
    if not dist.is_initialized():
        raise RuntimeError(
            "make_mesh needs an initialized torch.distributed world: call "
            "parallel.runtime.init first"
        )
    need = data_shards * kv_shards
    world = dist.get_world_size()
    if data_shards < 1 or kv_shards < 1 or world != need:
        raise ValueError(
            f"mesh {data_shards}x{kv_shards} needs {need} ranks, the world "
            f"has {world}"
        )
    if device is None:
        device = (
            torch.device("cuda", torch.cuda.current_device())
            if dist.get_backend() == "nccl"
            else torch.device("cpu")
        )
    d, k = divmod(dist.get_rank(), kv_shards)
    data_groups = [
        dist.new_group([r * kv_shards + c for r in range(data_shards)])
        for c in range(kv_shards)
    ]
    kv_groups = [
        dist.new_group([r * kv_shards + c for c in range(kv_shards)])
        for r in range(data_shards)
    ]
    return Mesh(
        data=data_shards, kv=kv_shards, d=d, k=k, device=torch.device(device),
        data_group=data_groups[k], kv_group=kv_groups[d], cp_group=cp_group,
    )
