"""Pod runtime: the (data, kv) mesh over torch.distributed, SPMD pull/push,
the SSP dispatch window and clock, the workload pool.

The design mapping from the JAX package (``parameter_server_tpu/parallel``):

- **One process per mesh cell.** JAX runs a D x KV device mesh inside one
  program, and across hosts with kv within each process and data across
  processes. The port runs a ``torch.distributed`` world of exactly
  D x KV ranks: rank r sits at ``(d, k) = divmod(r, KV)``. The kv group of
  data row d (its KV ranks) carries JAX's ``psum(..., "kv")`` as an
  ``all_reduce``; the data group of kv column k (its D ranks) carries
  ``psum(..., "data")`` and ``all_gather(..., "data")``. Each rank holds
  its own kv slice of every table, rows ``[k*S, (k+1)*S)`` with
  ``S = padded_num_keys(K, KV) // KV``, and feeds its own data shard's
  batch; the KV ranks of one data row build the same batch. This is JAX's
  multi-host contract with one data row per process, so
  ``Runtime.shard_files`` is ``files[d::D]``. Every rank creates every
  group, in the same order, even the groups it is not in.
- **Backends.** ``gloo`` on the CPU; ``nccl`` on the card, one rank a
  GPU, world size 1 included. Ranks that share one card run ``gloo`` on
  CUDA tensors and must ask for it (``cli train --dist_backend gloo``).
  Nothing switches backend or device on its own. A second gloo group over
  the world carries the host-side control plane (bucket agreement,
  barriers, the progress AUC).
- **The order of operations is kept.** Per-worker pushes land on each kv
  shard one after another in data-index order (the JAX ``lax.scan``), K
  microsteps run one after another per call, and every rank runs the same
  collectives step for step until a retired step counts 0 pod-wide
  examples (the drained contract).
- **The apps on the tier.** ``linear_method`` runs through ``PodTrainer``;
  matrix factorization, Wide&Deep and word2vec take ``mesh=`` and run the
  JAX apps' mesh steps on the same pulls and pushes. Wide&Deep's MLP and
  Adam are replicated, their gradients summed over the data group.
  ``_local_push`` is told whether a worker's ids are unique: unique keys
  (linear, MF, W&D) push through the fused kernels, repeated ids
  (word2vec) through gather, one delta an occurrence and ``index_add_``.

- **The wire tier's data plane** (``control.py``, ``multislice.py``): the
  JAX package's frames, byte for byte, over TCP; ``ShardServer`` applies
  coalesced pushes in place through K1/K3 under a publish lock that pulls
  also take, so no pull sees part of an apply. ``backend.py`` puts the
  socket tier (``SocketBackend``) and the kv ranks of a world
  (``MeshBackend``) behind one ``PSBackend`` interface.
- **The control plane and the cluster** (``control.py`` ``Coordinator``,
  ``ControlClient``; ``multislice.py`` ``run_scheduler``, ``run_server``,
  ``run_worker``, ``launch_local``, ``run_node``): one process a node, as
  ``cli launch`` / ``cli node`` start them; servers hold their tables on
  the card and checkpoint them (``save_state`` / ``load_state``).
- **Chaos** (``chaos.py``): a seeded ``FaultPlan`` armed on any
  ``RpcServer`` (and so any ``ShardServer`` or ``Coordinator``, or every
  node of ``launch_local`` through ``PS_FAULT_PLAN``) drops, delays,
  duplicates and disconnects frames; the clients heal and the servers'
  reply cache and push ledger keep every push applied once.
- **The serving plane** (``multislice.py``, ``filters/keycache.py``):
  versioned pulls (``if_newer`` / ``not_modified``), a client key cache,
  a single-flight encode cache and load shedding. A version names the
  in-place table a reply's rows were gathered from: it moves in the same
  publish-lock hold as the apply.
"""

from parameter_server_tpu_torch.parallel import runtime  # noqa: F401
from parameter_server_tpu_torch.parallel.mesh import Mesh, make_mesh  # noqa: F401
from parameter_server_tpu_torch.parallel.runtime import Runtime  # noqa: F401
from parameter_server_tpu_torch.parallel.spmd import (  # noqa: F401
    batch_arrays,
    make_spmd_predict_step,
    make_spmd_train_multistep,
    make_spmd_train_step,
    shard_state,
    stack_step_groups,
)
from parameter_server_tpu_torch.parallel.ssp import DispatchWindow, SSPClock  # noqa: F401
from parameter_server_tpu_torch.parallel.workload import WorkloadPool  # noqa: F401
