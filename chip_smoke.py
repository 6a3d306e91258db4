#!/usr/bin/env python3
"""Chip smoke run of parameter_server_tpu_torch on one NVIDIA card.

    python3 chip_smoke.py

Run from the root of a checkout. Phases, in order; any failure raises and
the script exits nonzero without printing a result:

1. probe   — require a CUDA card; print its name and power limit.
2. build   — compile the port's CUDA kernels (csrc/*.cu: one nvcc per
             source, all started together, linked into one library).
3. kernels — hold each kernel against its plain PyTorch version on the card
             (rtol 1e-5, atol 1e-6; untouched table rows bit-identical;
             hyperparameter sets with and without l2; K2 also on inputs
             that start past a 16-byte boundary) and time both with CUDA
             events beside the kernel's bound, cycling input sets that
             together exceed the L2 cache so each call finds its rows cold.
             K2 (FTRL delta) is also timed warm, one input set repeated as
             the worker step finds its rows in L2. K1 (FTRL push) is timed
             at the server's push (~131k rows) and at 4x it (~523k rows),
             each beside its access pattern's floor: PyTorch's gather of z
             and n at the same keys (index_select), which moves the read
             half of K1's sectors with none of its arithmetic. K3 (AdaGrad
             push) is also timed against torch.optim.Adagrad's step on a
             sparse gradient of the same rows, the yardstick.
4. worker  — LinearMethod trains 12 minibatches (8192 examples, 32 nnz per
             example, 2^18 features) against a 2^24-key FTRL table; the
             first 3 steps' loss matches a CPU run of the port (rtol 1e-4).
5. server  — a 2^27-key FTRL KVStore answers coalesced pushes from 8
             simulated workers and pulls of their keys; the pulled weights
             match a CPU plain update of the touched rows.
6. mf      — MatrixFactorization at MovieLens-20M's shape (138,493 users,
             26,744 items, rank 64, AdaGrad) trains two epochs over 2^20
             synthetic ratings; epoch 2's RMSE is below epoch 1's, and the
             first 3 steps' SSE and the w, n tables after them match a CPU
             run of the port (rtol 1e-4); K3's device time a launch in a
             profile of one window entry, beside its bound; K3, its plain
             version and torch.optim.Adagrad at a step's users, by events.
7. embedding server — a 2^22-key, vdim-64 AdaGrad KVStore answers
             coalesced pushes from 8 simulated workers; a pull of the last
             round's keys matches a CPU plain update of the touched rows.
8. codec   — the stochastic quantizer (K4) against its plain version on
             the card, bit for bit (q, lo, scale; 3, 2^20 + 7 and 2^24
             elements, int8 and int16, several seeds), every decode within
             one step of its input, the maximum saturated (never wrapped);
             its statistics (unbiased mean, round-up rate, independent
             streams for seeds s and s + 1); its times at 2^24 float32 and
             at one embedding-server push. Then the fixed-point filter's
             round trip: phase 7's 3 rounds x 8 workers, each gradient
             encoded on the card (K4), decoded as the server decodes it,
             coalesced and pushed (K3) into a 2^22 x 64 AdaGrad KVStore;
             every payload and the pull of every touched key match the same
             sequence on the CPU (plain K4 with the same seeds).

9. wide_deep — K1 and K3 against their plain versions at the W&D push's
             shapes (10^8-row tables, vdim 1 and 16); K3 timed at the
             step's push (each batch's real prefix of unique keys) and at
             the whole unique-key array (~240k pad slots on row 0), and at
             the prefix beside its plain version and torch.optim.Adagrad;
             then WideDeep at BASELINE's 100M-row embedding table (emb_dim
             16, MLP [32, 16], AdaGrad eta 0.05, Adam 1e-3, FTRL alpha 0.1,
             beta 1, l1 0.5)
             on 32 synthetic CTR minibatches of 8192 rows with Criteo's 39
             fields (Zipf keys over 2^24 features, hashed), 4 steps a
             window entry, max_delay 4: one ftrl_push and one adagrad_push
             a step; progressive AUC > 0.5; the first 3 steps' loss, the
             touched rows of the four tables and the MLP match a CPU run
             that holds only those rows (E2E_RTOL); the host's init time of
             the 10^8 x 16 draw; a profile of one window entry with K1's and
             K3's device times at this shape.
10. word2vec — SGNS at a 2^20-word vocabulary (dim 64, window 2, 5
             negatives, AdaGrad eta 0.3, batch 8192, 8 steps a window entry,
             max_delay 8) on 2^20 Zipf-distributed tokens: the first 2
             steps' losses and the touched rows after step 1 match a CPU
             run (E2E_RTOL; W2V_E2E_STEPS says why not 3), and the drift
             after 3 steps is logged beside a reordered CPU run's; two
             epochs (epoch 2's mean loss below epoch 1's) and train_files
             on the same corpus as a .npy (pipeline_depth 2) counting every
             pair, with no kernel launched; a profile of one window entry.

11. pod — the SPMD tier (parallel/). K1 and K3 against their plain
             versions on kv-shard views given keys - begin, the keys of
             other shards on both sides (K1: a 2^24-row table in 4 shards
             at a worker batch's keys; K3: MF's user table in 4 shards at a
             batch's users), the rows they skip bit-identical; the quantized
             push's int8 rounding at the worker step's gradient (the JAX
             push's scale, floor(t) or floor(t) + 1, unbiased over 64
             seeds, independent neighbouring seeds).
             (a) A world of one on NCCL in this process, the worker's full
             width (phase 4's table and batches): PodTrainer's step on the
             1x1 mesh in per_worker mode (K1 a step) and in aggregate mode
             (K2 over the whole 2^24-row shard a step); the first 3 steps'
             loss and the touched rows match the single-device LinearMethod
             on the card (E2E_RTOL); 4 steps timed and 4 profiled (idle
             share, the collectives' device time, K1's or K2's time a
             launch, the payload handed to the collectives a step), and
             the single-device worker's steps fed, timed and profiled the
             same way over the same batches beside them. Then Wide&Deep at
             phase 9's width (10^8 keys, from phase 9's initial tables)
             and word2vec at phase 10's (a 2^20-word vocabulary, dim 64),
             WideDeep(mesh=...) and Word2Vec(mesh=...) on the 1x1 mesh,
             per_worker and aggregate, one step a window entry: the first
             3 steps' losses, the touched rows and W&D's MLP match the
             single-device app on the card (E2E_RTOL; word2vec over
             W2V_E2E_STEPS, its rows after step 1; word2vec aggregate,
             whose one step over summed repeated ids is another function,
             step 1's loss and its rows against a CPU aggregate step); W&D
             launches K1 and K3 a step (per_worker) or K2 over the whole
             10^8-row shard (aggregate), word2vec no kernel (its ids
             repeat: the push's repeated-ids route, never K3); 4 steps
             timed and 4 profiled beside the single-device app's (W&D
             aggregate alone, with its peak device memory: its dense shard
             buffers and AdaGrad temporaries leave no room for a second
             app).
             (b) 2x2 meshes of 4 gloo ranks sharing the card, each a
             `python -m parameter_server_tpu_torch.cli train --device cuda
             --dist_backend gloo --coordinator ...` process, each world
             beside the same 2x2 world on the CPU, in two waves of 9
             worlds, each wave's at once (36 processes; every rank 0
             first, the other ranks once every store listens):
             linear_method on the
             2^24-key table from 6 libsvm files of 8192 phase-4 rows (3 a
             data shard: cut to 3 steps), per_worker, aggregate and
             quantized; MF at MovieLens-20M's shape from 16,384 synthetic
             ratings (one global step an epoch, 3 epochs: cut to 3 steps;
             the item table's 26,745 rows are padded to 26,746 for 2 kv
             shards), per_worker and aggregate; Wide&Deep at 2^20 keys
             (POD_WD_KEYS) from 6 libsvm files of 8192 phase-9 rows (3
             steps), per_worker, aggregate and quantized; word2vec from 2
             corpus files of POD_W2V_TOKENS Zipf ids (3 steps a data shard)
             at eta POD_W2V_ETA, per_worker and aggregate. The first 3
             steps' progress rows and the final state (z, n on the touched
             rows; MF's factors; W&D's dump; word2vec's mean loss and
             embeddings) match the CPU world's (E2E_RTOL; the rows' 5
             printed digits add PRINT_RTOL); the linear quantized run's
             loss falls, W&D's tracks its per_worker run (POD_QUANT_RTOL),
             and their ranks (--audit_quantized) held every push's
             gathered gradient to the rounding bounds above; every card
             rank launched K1 (per_worker, quantized), K2 (aggregate) or
             K3 (MF per_worker; W&D per_worker and quantized beside K1),
             and word2vec's ranks none. Any rank's nonzero exit, or a
             world outlasting POD_TIMEOUT_S, kills every rank of every
             world and fails.
12. wire  — the wire tier (parallel/control.py, multislice.py, backend.py,
             meshbackend.py) over loopback TCP. (a) Phase 5's FTRL table
             (2^27 keys) split over 2 card ShardServers by even_divide, one
             ServerHandle a server behind a SocketBackend: phase 5's 24
             pushes one at a time (the first round under the profiler: the
             device's idle share), K1 once an apply batch, launches = the
             servers' apply_batches, every launch's index checked unique on
             the card, the pull of every touched key against a CPU replay
             (rtol 1e-5, atol 1e-6); then 8 handles in threads push 12
             pipelined pushes each into an SGD table ([wire] window 8,
             [server] defaults): every push acked, some coalesced, the table
             -eta x the sum of every gradient (rtol 1e-5 of itself plus of
             the table's largest element). (b) Phase 7's AdaGrad table (2^22
             x 64) the same way, K3 once an apply batch; then with [filter]
             fixing_float_bytes 1: each handle encodes on the card (K4),
             every decoded payload within one step (+ ROUNDING_ULPS) of its
             gradient, the table against a CPU replay of what the servers
             decoded. (c) train_linear at the worker's width (2^24 keys, 12
             batches of 8192 examples, 32 hashed Zipf ids each) through the socket
             backend (2 card servers), the mesh backend on a world of one
             over NCCL (quant off and int8) and the socket backend on the
             CPU: socket and mesh probabilities equal (within 1e-6), both
             within E2E_RTOL of the CPU run, the int8 AUC within 0.002 of
             f32; ex/s and push payload bytes per arm; each arm launched K1.
13. cluster — the cluster as processes (parallel/multislice.py
             launch_local, cli launch): a scheduler, 2 shard servers and the
             workers, each a `python -m parameter_server_tpu_torch.cli node`
             process on the card, over phase 12 (c)'s rows written as 8
             libsvm files of 8192 rows (one step each) and a validation
             file of 8192, a 2^24-key table, phase 4's FTRL, key caching
             and compression on. (a) 1 worker, max_delay 0, one
             epoch: the model_out weights match the same launch on the CPU
             (E2E_RTOL), so does the merged objv; each card server launched
             K1 once an apply batch and nothing else, the worker nothing.
             (d) The same with AdaGrad: K3 once an apply batch, the weights
             against the CPU launch's as phase 11 (b)'s AdaGrad tables.
             (a) and (d), card and CPU, run at once. (b) `cli launch` with
             2 workers, max_delay 1: every workload done once, no dead
             worker, both servers pushed and pulled, the validation AUC
             within CLUSTER_AUC_BOUND of (a)'s, K1 in both servers; the
             wall time from spawn to result, each node's start-up, the
             merged ex/s and the servers' pushes/s. (c) 2 epochs, a worker
             SIGKILLed after the workers' first step (timed from (b)): it
             is declared dead and the workload ledger balances; beside it a
             server killed and restarted from its 0.5 s checkpoints: no
             dead worker, every workload done once, the replacement resumed
             and launched K1 once an apply batch, the validation AUC within
             CLUSTER_RESTART_AUC_BOUND of (a)'s. (e) (a)'s launch on the
             card with every node under CHAOS_PLAN (launch_local(
             fault_plan=...), through PS_FAULT_PLAN): the model matches the
             clean card model (E2E_RTOL), every workload done once, K1 once
             an apply batch, each server's plan fired. (a), (d) and (e) run
             at once. Any node's nonzero exit or a launch past
             CLUSTER_TIMEOUT_S fails the phase.
14. chaos and serving — (a) phase 12 (a)'s FTRL servers and 24 pushes,
             each server under CHAOS_PLAN (drop, disconnect every 5th push,
             duplicate, delay): the pull of every touched key against the
             CPU replay of each push applied once (rtol 1e-5, atol 1e-6),
             K1 once an apply batch with every index unique, each server's
             push ledger holding each push once, every action fired;
             pushes/s and p50/p99 beside phase 12 (a)'s clean figures, the
             idle share of the first 8 pushes. (b) The same on phase 12
             (b)'s 2^22 x 64 AdaGrad servers through K3. (c) The serving
             plane: 2^24 FTRL keys over 4 card servers of 2^22 rows (each
             range [serve] snapshot_keys_max, so the host snapshot runs);
             8 frontend threads, each multiplexing 32 clients on their own
             Zipf(1.1) streams over 512 key sets of 32 keys, through serving
             handles sharing one ClientKeyCache (TTL 1 s, staleness ceiling
             4 s), while a writer pushes a key set every 20 ms through K1:
             every row a serving handle installed equals a CPU replay of
             its server's table at the reply's version (rtol 1e-5, atol
             1e-6), the writer reads its own writes, no served row is
             older than max(TTL, ceiling), uncached pulls move the servers'
             pulls counter each time; pulls/s, p50/p99 by path (local or
             wire), hits, not_modified, encodes and reuses; the host
             snapshot's time at 2^22 rows; a profiled second of the
             traffic. Then a shed arm: two writers flood async pushes, one
             queued push marks a server overloaded, and revalidations are
             shed and served from the cache.
15. darlin, graph_partition, sketch — (a) darlin at RCV1's shape
             (677,399 rows drawn on the card with make_sparse_logistic's
             law, ~74 distinct of 47,236 features a row, hashed into 2^16
             keys, 16 column blocks; bench.py's settings), twice: the
             first 2 passes against the port's CPU run, the objective
             falling, block passes/s, example-blocks/s, objv, nnz_w, train
             AUC, peak memory; a profiled pass; each block's g sum by
             events over its real entries and its padded width; max_delay
             2. (b) A world of one on NCCL, resident and streamed (4
             blocks a chunk). (d) The first 2^16 rows as libsvm files:
             `cli convert`, `cli train` from the cache (no parse) against
             one that parses. (c) A 2x2 world of `cli train` gloo ranks
             sharing the card on that cache, beside the same world on the
             CPU. (e) graph_partition through `cli train` over phase 4's
             rows, a 2^24 x 8 presence table: presence, sizes,
             assignments, dump and result equal to the CPU run's; the step
             alone timed. (f) sketch (host code) through `cli train` on
             phase 13's files, equal to the CPU run. DARLIN_END_RTOL says
             which passes of two solves are held to what.
16. native parser, dynamic pool, tracing and the black box — (a) the
             native parser (data/native.py: g++ builds native/parser.cpp
             into _build/; the phase fails, printing g++'s log, if it does
             not load) over phase 13's 8 libsvm files and one Criteo-format
             file of the same rows: keys, slots and splits equal to the
             port's Python parsers bit for bit, values within NATIVE_RTOL;
             MB/s of each parser; hash_localize of a file's 8192 x 32 keys
             into 2^24 equal to the numpy localizer, both timed; then
             LinearMethod at phase 4's width fed by MinibatchReader(backend=
             "native") and "python" over the 8 files: the first 3 losses
             within E2E_RTOL, K2 once a step, each run's time parse
             included. (b) PodTrainer.train_files_dynamic on a world of one
             on NCCL against a Coordinator in a thread, per_worker, 2 epochs
             over the 8 files: every item done once, the weights and epoch
             rows equal train_files' on the same files (E2E_RTOL), K1 once a
             step; then a 2x1 world of `cli train --device cuda
             --dist_backend gloo --pool_coordinator ... --pool_serve` ranks
             sharing the card, its pool Coordinator under POOL_PLAN: every
             workload done once pod-wide (each rank counts 2 x 8 x 8192
             examples), both replicas evaluate alike, the loss falls, both
             ranks launched K1. (c) Phase 13 (a)'s launch with trace_dir and
             blackbox_dir: trace and psbb/1 files from all 4 nodes, spans
             from each, a push's trace id from the worker's rpc.push into a
             server's rpc.serve.push, the model equal to phase 13 (a)'s
             untraced card model (E2E_RTOL), K1 once an apply batch; a
             server process with the recorder armed takes TERM_PUSHES
             pushes and SIGTERM: its psbb/1 dump names the signal and holds
             rpc.in, apply.begin and apply.commit events; phase 12 (a)'s 24
             pushes unarmed and with tracing and the recorder armed in this
             process, pushes/s and p50/p99 of each logged, not gated.
17. live ops, audit, forensics — (a) phase 13 (a)'s cluster (2 card
             servers, 1 worker, max_delay 0, phase 13's files) for
             LIVE_EPOCHS epochs, each node a `cli node` process spawned
             against a scheduler address this script picks, with every
             plane armed: [timeseries] metrics_port (each node's
             OpenMetrics endpoint), [profile] hz 29, [audit], the default
             [slo] rules, tracing, the black box, beats every 0.2 s; the
             same launch unarmed (launch_local) at once beside it. Once
             each node's ring holds 3 beats and its pushes, against the
             live scheduler: `cli stats` (3 heartbeating nodes, the merged
             client and server push histograms counted), `cli top --json`
             (each server and the worker pushing, health 100, no alert),
             `cli ranges --json` (the servers' ranges tile [0, 2^24), each
             pushed with an apply p99 > 0), `cli audit --once --json` (exit
             0, no violation, audit batches from every node), `cli whylate
             --scheduler` (push records with their segments), a scrape of
             server 0's /metrics (ps_build_info naming the port's package,
             its range push counter); each server's top profiler stacks
             logged. (b) After the run: `cli whylate` over the trace dir
             (every traced worker push reaches a server's rpc.serve.push;
             the step ops' segments are JAX's SEGMENTS) and over the boxes
             (push ops from the cid/seq chains), `cli postmortem` over the
             boxes exits 0 with no anomaly, the model equals the unarmed
             launch's (E2E_RTOL), each card server launched K1 once an
             apply batch. (c) Phase 12 (a)'s pushes (LIVE_ARM_PUSHES an
             arm) through 2 card servers in this process, unarmed and with
             the metrics endpoint, profiler, audit spool, tracing and the
             recorder armed, in turn LIVE_ARM_REPEATS times: pushes/s and
             p50/p99 logged with the card's name and power limit, not
             gated.
18. the analysis plane — (a) lint runs inside phase 19 (a)'s `cli
             verify`, started here beside (b) and (c). (b) Phase 13 (a)'s
             launch (2 card servers, 1 worker, `cli node` processes,
             phase 13's files) with the runtime lock-order witness and
             the lockset race witness armed in this process, which
             launch_local exports to every node (PS_LOCK_WITNESS,
             PS_RACE_WITNESS), then the same launch unarmed: no inversion
             and no race in any node (each node's witness and race
             witness reports, no LockOrderViolation or [racewitness] line
             in any log; the servers and the worker tracked fields), the
             armed model equal to phase 13 (a)'s (E2E_RTOL), K1 once an
             apply batch on each card server; each node's witnessed edges
             and how many the static graph lacks, its tracked fields,
             each node's start-up and each server's kernel library load
             (at start, outside every lock) and first apply, armed and
             unarmed, logged. (c) Phase 12 (a)'s pushes (LIVE_ARM_PUSHES
             an arm) through 2 card servers in this process, unarmed and
             with the witness armed, in turn LIVE_ARM_REPEATS times:
             pushes/s and p50/p99 logged, not gated.
19. psmc, the explorer and the race witness — (a) `cli verify --json`
             (pslint's 17 checkers, then psmc's four specs with the
             spec<->code conformance diff) and `cli check --json` over
             the checkout, each in its own process beside phases 18 (b),
             (c) and 19 (b): verify exits 0 with lint 0 and check 0,
             every spec complete and ok, conformance []; their wall
             times logged. (b) A card FTRL ShardServer of 2^24 rows and a
             serving handle under the serving chaos-coherence test's
             plan (PSMC_PLAN, seed 3, caching on), 12 push/pull rounds of
             4096 keys, for explorer seed 8 and every seed
             tests/torch_sched_corpus.json records, the explorer armed
             before the server is built: each pull equal to its round's
             CPU replay (read-your-writes, PSMC_TOL), 12 pushes, K1 once
             an apply batch, more than 50 decisions with the publish
             boundary (rcu-publish:) and queue sites among them, the
             table equal to the CPU replay's; then the same under the
             race witness: fields tracked, no report. (c) Phase 13 (a)'s
             launch with PS_RACE_WITNESS on every node is phase 18 (b)'s
             armed launch.

Launch counters are reset just before each of phases 4-7, the round trip
of phase 8, the training runs of phases 9 and 10, each mode of phase
11 (a), each arm of phases 12 and 14, phase 15, phase 16's worker runs,
pool runs and wire arms, phase 17's and 18's arms and each of phase 19
(b)'s runs, and read just after; phase 11 (b)'s, 13's, 15 (c)'s, 16's, 17's and 18's ranks and nodes
start from 0 in their own processes and print their counts: each must
have launched its kernels (phases 10 and 15: none). The line before the
last is the kernels' JSON summary;
the last line is {"ok": true, "device": {...}}. Imports nothing of JAX.
"""

from __future__ import annotations

import contextlib
import dataclasses
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch

# published peaks of one H100 SXM (NVIDIA data sheet): device-memory rate
# and float32 rate outside the tensor cores; INT32 has 64 lanes an SM, half
# the FP32 lanes, and the float32 rate counts a multiply-add as two
# operations, so integer operations run at a quarter of that figure
HBM_BYTES_PER_S = 3.35e12
F32_FLOPS_PER_S = 67e12
INT32_OPS_PER_S = F32_FLOPS_PER_S / 4
# flops of one element update (sqrt and division counted as one operation
# each): FTRL weight, sigma and both deltas; AdaGrad g + l2*w, g^2, n + g^2,
# sqrt, + eps, eta*g, division, w + delta
FTRL_FLOPS = 18
ADAGRAD_FLOPS = 8
# K4 per element: Philox4x32-10 is 10 rounds of two 32x32->64 multiplies
# and four xors plus 9 two-word key bumps for 4 elements, and the shift of
# the word to 24 bits; float: x - lo, division, floor, frac, the word to
# float and its scaling, compare, add, - levels/2, two clamps
QUANT_INT_OPS = (10 * 6 + 9 * 2) / 4 + 1
QUANT_FLOPS = 11
RTOL, ATOL = 1e-5, 1e-6
HYPER = {"alpha": 0.1, "beta": 1.0, "l1": 1.0, "l2": 0.0}
# checked only: every term of the kernels' weight, l2 included
HYPER_L2 = {"alpha": 0.3, "beta": 1.0, "l1": 0.5, "l2": 0.1}
ADAGRAD = {"eta": 0.05, "eps": 1e-8}

WORKER_KEYS = 1 << 24
SERVER_KEYS = 1 << 27
BATCH, NNZ_PER, FEATURES, STEPS = 8192, 32, 1 << 18, 12
SERVER_WORKERS, SERVER_DRAWS, SERVER_ROUNDS = 8, 1 << 14, 3
SEED = 7
# K1 timing: each set is the unique keys of 2^17 uniform draws into the
# server table (bench.py's fused-push cell); 16 sets touch ~150 MB of
# 32-byte sectors, three times the H100's 50 MB L2. The large push is 4x
# that (2^19 draws, ~523k rows), more slots than the ~270k threads an
# H100 holds resident at once
PUSH_SETS, PUSH_DRAWS, LARGE_PUSH_DRAWS = 16, 1 << 17, 1 << 19
# K2 timing: cold cycles this many input sets (~160 MB at the worker's
# shape); warm repeats one set, ~20 MB that stay in L2 as in the step
DELTA_SETS = 8
# the embedding table: bench.py's fused_push_adagrad_v64 cell (vdim 64,
# unique keys of 2^15 draws a push) moved from 2^20 to 2^22 rows, so w + n
# are 2 GiB; K3 timing cycles 16 such key sets, ~25 MB of rows and
# gradient a set and ~400 MB in all, so each call finds its rows cold
EMB_KEYS, EMB_VDIM = 1 << 22, 64
EMB_SETS, EMB_DRAWS = 16, 1 << 15
EMB_WORKERS, EMB_WORKER_DRAWS, EMB_HOT, EMB_ROUNDS = 8, 1 << 12, 1024, 3
# matrix factorization at MovieLens-20M's shape with bench.py's MF cell
# hyperparameters; steps_per_call 4 (the cell's is 8) so one window entry
# is the profiled 4-step window
MF_USERS, MF_ITEMS, MF_RANK, MF_BATCH = 138_493, 26_744, 64, 8192
MF_RATINGS, MF_ETA, MF_L2, MF_MAX_DELAY, MF_STEPS_PER_CALL = 1 << 20, 0.05, 0.01, 4, 4
# the plain versions issue ~15 launches a call: few enough calls that all
# of them fit the launch queue behind the spin kernel (see cuda_ms)
PLAIN_ITERS = 40
# the codec: 2^24 float32 (64 MiB) is the payload encode_fast's docstring
# names; K4's plain version issues ~140 launches a call (its Philox in
# int64 tensors), the encode wrapper ~7 (aminmax, scale, the kernel)
CODEC_SIZES, CODEC_SEEDS = (3, (1 << 20) + 7, 1 << 24), (0, 1, (1 << 40) + 3)
CODEC_BIG, CODEC_MEAN_SEEDS, CODEC_FIRST_SEED = 1 << 24, 64, 1000
PLAIN_QUANT_ITERS, ENCODE_ITERS = 4, 100
# the decode error bound: one step, plus the float32 roundings of t and of
# the decode, a few units of 2^-24 of the array's magnitude (the decode's
# product alone rounds by up to 2^-24 of the span, 0.4% of an int16 step)
ROUNDING_ULPS = 8
# Wide&Deep at BASELINE's "100M-row embedding table" with the [wd] defaults
# and WideDeep's FTRL wide half; synthetic CTR rows of Criteo's 39 fields
# (13 integer + 26 categorical) drawn from make_sparse_logistic's Zipf keys
# over 2^24 features and hashed into the table; the CLI's batch builder
# (training_builder: power-of-two entry buckets)
WD_KEYS, WD_EMB_DIM, WD_HIDDEN, WD_EMB_ETA, WD_MLP_LR = 10**8, 16, [32, 16], 0.05, 1e-3
WD_FTRL = {"alpha": 0.1, "beta": 1.0, "lambda_l1": 0.5, "lambda_l2": 0.0}
WD_BATCH, WD_FIELDS, WD_FEATURES, WD_STEPS = 8192, 39, 1 << 24, 32
WD_STEPS_PER_CALL, WD_MAX_DELAY, WD_REPORT_EVERY = 4, 4, 2
# word2vec at the [w2v] defaults, a vocabulary near the One Billion Word
# benchmark's ~793k words, bench.py's 2^20-token corpus and dispatch shape;
# ids Zipf-distributed (word frequencies follow Zipf) over the vocabulary:
# truncated to it, since clipping numpy's zipf draws would pile the tail's
# ~24% of the mass onto the last id
W2V_VOCAB, W2V_DIM, W2V_WINDOW, W2V_NEG, W2V_ETA = 1 << 20, 64, 2, 5, 0.3
W2V_BATCH, W2V_STEPS_PER_CALL, W2V_MAX_DELAY = 8192, 8, 8
W2V_TOKENS, W2V_ZIPF = 1 << 20, 1.1
# the apps' first steps on the card against the CPU: losses within
# E2E_RTOL; state, each element within E2E_RTOL of itself plus E2E_RTOL of
# its table's (word2vec: its row's) largest element. The card sums the
# duplicate contributions of a segment sum (a hot key's gradient, a hot
# word's deltas) in another order, and a sum that nearly cancels keeps the
# absolute rounding error of its largest terms.
E2E_STEPS, E2E_RTOL = 3, 1e-4
# word2vec is held to its first step's state and first 2 steps' losses:
# from its second step on, AdaGrad's first touch of an input row
# (n = 0: a step of eta * sign(g), whatever |g|) turns the rounding noise
# of a near-zero gradient into a +-eta step, and by the third step the
# hot words' summed deltas diverge. A CPU run that sums the same deltas in
# another order (each batch's pairs permuted) shows how far: its drift
# after E2E_STEPS steps is logged beside the card's
W2V_E2E_STEPS = 2
# phase 11, the SPMD tier: (a) the worker's config on a 1x1 mesh, a world
# of one on NCCL: POD_E2E_STEPS steps held to the single-device worker,
# POD_TIMED_STEPS timed, POD_PROFILE_STEPS profiled, each mode on fresh
# tables (phase 4's 12 batches cover the 3 + 4 + 4 + ... steps cycled);
# (b) 2x2 meshes of POD_RANKS `cli train` ranks, cut to POD_E2E_STEPS steps:
# linear_method from POD_FILES_PER_SHARD libsvm files of one batch each a
# data shard, MF from 2 x MF_BATCH ratings, one global step an epoch
POD_E2E_STEPS, POD_TIMED_STEPS, POD_PROFILE_STEPS = 3, 4, 4
POD_RANKS, POD_FILES_PER_SHARD, POD_TIMEOUT_S, POD_QUANT_SEEDS = 4, 3, 300, 64
POD_RUNS = [("linear_method", "per_worker"), ("linear_method", "aggregate"),
            ("linear_method", "quantized"), ("matrix_fac", "per_worker"),
            ("matrix_fac", "aggregate"), ("wide_deep", "per_worker"),
            ("wide_deep", "aggregate"), ("wide_deep", "quantized"),
            ("word2vec", "per_worker"), ("word2vec", "aggregate")]
# the runs' worlds start in two waves, each wave's worlds at once: all 18
# at once put 72 processes on the machine's 8 cores and took as long as the
# two waves one after another (PERF.md §5), with twice the processes alive
POD_WAVES = (("linear_method", "matrix_fac"), ("wide_deep", "word2vec"))
# the kernels each run must launch on every rank (an aggregate AdaGrad push
# is one plain step over the shard: no kernel); word2vec's ranks must
# launch none (its ids repeat: never K1 or K3)
POD_KERNELS = {("linear_method", "per_worker"): ("ftrl_push",),
               ("linear_method", "aggregate"): ("ftrl_delta",),
               ("linear_method", "quantized"): ("ftrl_push",),
               ("matrix_fac", "per_worker"): ("adagrad_push",), ("matrix_fac", "aggregate"): (),
               ("wide_deep", "per_worker"): ("ftrl_push", "adagrad_push"),
               ("wide_deep", "aggregate"): ("ftrl_delta",),
               ("wide_deep", "quantized"): ("ftrl_push", "adagrad_push"),
               ("word2vec", "per_worker"): (), ("word2vec", "aggregate"): ()}
# phase 11 (b)'s cuts of Wide&Deep and word2vec: W&D at 2^20 keys (4 ranks x
# 2 worlds at 10^8 would hold ~27 GB on the card and as much on the host),
# from 2 x POD_E2E_STEPS libsvm files of WD_BATCH rows; word2vec from one
# corpus file a data shard, each POD_W2V_TOKENS tokens (POD_E2E_STEPS
# batches of pairs), at the CPU tests' eta (at W2V_ETA runs that sum the
# same deltas in another order part in their first steps)
POD_WD_KEYS, POD_W2V_TOKENS, POD_W2V_ETA = 1 << 20, 6100, 0.05
# word2vec's vocabulary there: 2^18, not phase 10's 2^20 (every rank of a
# word2vec world draws the whole input table on the host, and an aggregate
# rank sums two dense shard buffers over gloo every step)
POD_W2V_VOCAB = 1 << 18
# the AdaGrad tables of the W&D and word2vec dumps, card vs CPU: AdaGrad's
# first step on an element moves it by eta * g / (|g| + eps), less than eta
# either way, so a gradient that is a sum which nearly cancels (aggregate
# pushes sum every occurrence of an id) turns its rounding, summed in
# another order on the card, into a move that differs by up to 2 eta. Such
# elements are few (on an H100, word2vec aggregate: 159 of 251,968 moved;
# W&D: at most 6 of 1.27 M; PERF.md section 6): at most this share of the
# moved elements may miss E2E_RTOL, each within 2 eta; a fault moves many
POD_MOVED_OFF_SHARE = 1e-2
# W&D quantized tracks per_worker's progress rows: its first row equal (the
# first push comes after the first loss), the next within this of them (the
# int8 push's rounding moved the second row by 2.4% on an H100)
POD_QUANT_RTOL = 0.1
# the progress table prints 5 significant digits
PRINT_RTOL = 1e-4
# phase 12, the wire tier: phase 5's FTRL table and pushes over 2 loopback
# shard servers (an even key-range divide), one handle a server behind a
# SocketBackend; the concurrent arm's 8 handles push WIRE_CONC_PUSHES each,
# pipelined (cycling their phase-5 key sets, fresh gradients), into an SGD
# table, whose sum of deltas does not depend on how pushes coalesce
WIRE_SERVERS, WIRE_CONC_PUSHES, WIRE_SGD_ETA = 2, 12, 1.0
# (c) train_linear at the worker's width (WORKER_KEYS, STEPS batches of
# BATCH examples, NNZ_PER ids each over FEATURES), with the FTRL of the JAX
# backend tests (sized for per-example mean gradients) and the int8 arm's
# AUC bound
TL_FTRL = {"alpha": 1.0, "beta": 1.0, "lambda_l1": 1e-4, "lambda_l2": 0.0}
TL_AUC_BOUND = 0.002
# the ids' Zipf exponent: word frequencies' (W2V_ZIPF); at phase 4's 1.3 the
# tail carries too little signal for the AUC bound to test anything
TL_ZIPF = 1.1

# phase 13, the cluster: scheduler, CLUSTER_SERVERS card servers and the
# workers as processes (launch_local / cli launch) over phase 12 (c)'s rows
# in CLUSTER_FILES libsvm files of BATCH rows (one step each) and one
# validation file of BATCH rows, at phase 4's table width and FTRL
# hyperparameters, key caching and compression on; each launch must end
# within CLUSTER_TIMEOUT_S; the fault arms beat every 0.5 s and declare a
# node dead after 2.5 s of silence. The asynchronous runs' validation AUC
# is held to the deterministic run's within CLUSTER_AUC_BOUND (one epoch)
# and CLUSTER_RESTART_AUC_BOUND (the server restart's two epochs): over 8
# steps it depends on how the two workers' first steps interleave. Both
# steps from zero weights at once cost ~0.045: the JAX package's own
# cluster on these files (2^20 keys, CPU) gave 0.6891 deterministic and
# 0.6441-0.6476 asynchronous in 3 runs, the port's 0.6460-0.6891
CLUSTER_FILES, CLUSTER_SERVERS, CLUSTER_TIMEOUT_S = 8, 2, 300
CLUSTER_AUC_BOUND, CLUSTER_RESTART_AUC_BOUND = 0.05, 0.06
CLUSTER_FAULT = {"heartbeat_interval_s": 0.5, "heartbeat_timeout_s": 2.5}
CLUSTER_ADAGRAD_ETA = 0.1  # the [lr] eta default

# phase 14: chaos and the serving plane. (a), (b) phase 12 (a)'s FTRL and
# (b)'s embedding servers, the server of rank r armed with CHAOS_PLAN
# (every action of the wire's fault language) from seed CHAOS_SEED + r: two
# servers fed the same command sequence under one seed decide alike, and
# over an arm's ~30 frames seed 7's stream draws no drop where seed 8's
# does, so the arm fires every action; phase 13 (e) arms every node of
# (a)'s launch with the plan and CHAOS_SEED. (c) The serving plane at the worker's width:
# WORKER_KEYS FTRL keys over SERVE_SERVERS card servers, so each range is
# [serve] snapshot_keys_max rows; the traffic of the JAX bench.py serve
# cell: SERVE_THREADS frontend threads, each multiplexing SERVE_CLIENTS
# clients on their own Zipf(SERVE_ZIPF) streams over SERVE_SETS key sets of
# SERVE_SET_KEYS keys, one shared client cache (TTL SERVE_TTL_MS, staleness
# ceiling SERVE_MAX_STALE_MS), a writer pushing a key set every
# SERVE_WRITER_PERIOD_S through K1; then a shed arm under a flood of two
# writers' windows of 32 async pushes, where SHED_QUEUE_DEPTH queued pushes
# mark a server overloaded (1: any backlog; the card drains a queue of 4
# faster than revalidations arrive)
CHAOS_PLAN = ("drop,prob=0.05;disconnect,cmd=push,every=5;duplicate,prob=0.05;"
              "delay,prob=0.1,delay_s=0.002")
CHAOS_SEED = 7
SERVE_SERVERS, SERVE_SETS, SERVE_SET_KEYS, SERVE_ZIPF = 4, 512, 32, 1.1
SERVE_THREADS, SERVE_CLIENTS = 8, 32
SERVE_TTL_MS, SERVE_MAX_STALE_MS, SERVE_WRITER_PERIOD_S = 1000, 4000, 0.02
SERVE_SECONDS, SHED_SECONDS, SHED_QUEUE_DEPTH = 6.0, 3.0, 1
# phase 15: darlin at RCV1's shape (LIBSVM rcv1.binary as L1-LR solvers
# train it: 677,399 examples of 47,236 features, ~74 nonzeros an example),
# rows drawn with make_sparse_logistic's law (Zipf 1.3 ids made distinct in
# their row, values N(1, 0.3), labels from a sparse true model + noise 0.5):
# Poisson(RCV1_DRAWS) draws a row keep ~74 distinct ids at Zipf 1.3 over
# 47,236 features. Hashed into 2^16 keys (the CLI's training builder) in
# 16 blocks, with bench.py's darlin settings; the port's CPU run holds the
# first DARLIN_CPU_PASSES passes. (b) a world of one on NCCL, resident and
# streamed (DARLIN_CHUNK blocks a chunk, DARLIN_STREAM_PASSES passes); (c)
# a 2x2 world of `cli train` gloo ranks sharing the card and its CPU twin,
# on the first DARLIN_WORLD_EXAMPLES rows; (d) those rows as libsvm files:
# `cli convert`, then `cli train` from the cache and from the text
RCV1_EXAMPLES, RCV1_FEATURES, RCV1_DRAWS, RCV1_ZIPF = 677_399, 47_236, 198, 1.3
DARLIN_KEYS, DARLIN_BLOCKS, DARLIN_ITERS, DARLIN_BATCH = 1 << 16, 16, 20, 1 << 15
DARLIN = {"lambda_l1": 1.0, "kkt_filter_threshold": 0.1, "eta": 1.0, "epsilon": 1e-4}
DARLIN_CPU_PASSES, DARLIN_STREAM_PASSES, DARLIN_CHUNK = 2, 2, 4
DARLIN_WORLD_EXAMPLES, DARLIN_FILES = 1 << 16, 4
# darlin's tolerances. The first DARLIN_CPU_PASSES passes of two solves:
# DARLIN_RTOL for the card against the port's CPU run, the card's streamed
# against its resident solve, a parse against the cache and the 2x2 card
# world against its CPU twin (the card sums a hot key's entries in lanes,
# the CPU in one pass, the mesh over ranks); DARLIN_MESH_RTOL, the JAX
# package's mesh-vs-single contract, for a world against one device. Two
# solves on the card sum in one order and repeat. Past the first passes
# solves of different orders part: a reordered sum flips a coordinate
# across the KKT filter's threshold or the soft threshold, or the line
# search's argmin of 8 sums, and the trajectories continue from different
# points (two card solves of (a) that summed with atomics, in an order
# changing from run to run, were ~1% apart by pass 6 and 0.2-0.5% at pass
# 20 on an NVIDIA H100 80GB HBM3), so the last objectives of two solves
# are held within DARLIN_END_RTOL (2%:
# the JAX tests' bound for the solver's variants against the optimum).
# max_delay 2, given 3x the passes (the JAX tests give it 60), must end
# within DARLIN_DELAY_BOUND of max_delay 0 (the same 2%)
DARLIN_RTOL, DARLIN_MESH_RTOL, DARLIN_END_RTOL, DARLIN_DELAY_BOUND = 1e-4, 2e-4, 0.02, 1.02
# (e) graph_partition on phase 4's rows: a 2^24 x 8 presence table (512
# MiB); (f) the sketch app on phase 13's files, the [sketch] defaults with
# a heavy-hitter threshold of SKETCH_MIN_COUNT
GRAPH_KEYS, GRAPH_PARTITIONS, SKETCH_MIN_COUNT = 1 << 24, 8, 100
# phase 16: the native parser, the dynamic pool, tracing and the black box.
# (a) The native parser against the port's Python parsers over phase 13's 8
# files and one Criteo-format file of the same rows: keys, slots and splits
# bit for bit, values within NATIVE_RTOL (the JAX tests/test_native.py
# tolerance); then LinearMethod at phase 4's width fed by each. (b) The
# dynamic pool over the same files for POOL_EPOCHS epochs: a world of one on
# NCCL, then a 2x1 world of `cli train` gloo ranks sharing the card whose
# pool Coordinator runs under POOL_PLAN from POOL_SEED (the plan and seed
# JAX tests/test_multihost.py arms its pool Coordinator with), within
# POOL_TIMEOUT_S. (c) Phase 13 (a)'s launch with tracing and the black box
# armed on every node; a server process sent SIGTERM after
# TERM_PUSHES pushes; phase 12 (a)'s pushes with both planes armed in
# this process, beside the same pushes unarmed (logged, not gated)
NATIVE_RTOL = 1e-6
POOL_EPOCHS, POOL_SEED, POOL_TIMEOUT_S = 2, 97, 300
POOL_PLAN = "disconnect,prob=0.04;duplicate,prob=0.04;delay,prob=0.05,delay_s=0.005"
TERM_PUSHES = 3

# phase 17: the live operations plane, the audit plane and the forensics
# tools. (a) Phase 13 (a)'s cluster (CLUSTER_SERVERS card servers, one
# worker, max_delay 0) over phase 13's files for LIVE_EPOCHS epochs, so the
# run outlives the live checks, each node a `cli node` process this script
# spawns against a scheduler address it picks, every plane armed: the
# OpenMetrics endpoints from a base port, the profiler at LIVE_PROFILE_HZ,
# the audit spool, the default [slo] rules, tracing and the black box,
# beats every LIVE_BEAT_S; the checks start once each node's ring holds
# LIVE_MIN_BEATS beats and its pushes. The same launch unarmed runs beside
# it, for the model (a launch of one epoch, phase 13 (a)'s, ends before
# the checks could). (c) Phase 12 (a)'s pushes, LIVE_ARM_PUSHES an arm
# (its 24 twice), unarmed and armed in turn LIVE_ARM_REPEATS times
LIVE_EPOCHS, LIVE_BEAT_S, LIVE_PROFILE_HZ, LIVE_MIN_BEATS = 10, 0.2, 29.0, 3
LIVE_WAIT_S = 120
LIVE_ARM_PUSHES, LIVE_ARM_REPEATS = 48, 3

# phase 18: the analysis plane. (a) Lint runs inside phase 19 (a)'s `cli
# verify`, started at phase 18's start beside (b) and read at phase 19's
# end, within VERIFY_TIMEOUT_S. (b) Phase 13 (a)'s launch with the
# lock-order witness and the race witness armed on every node (phase 19
# (c)), then unarmed. (c) Phase 12 (a)'s pushes, LIVE_ARM_PUSHES an arm,
# unarmed and with the witness armed in this process, in turn
# LIVE_ARM_REPEATS times
VERIFY_TIMEOUT_S = 300

# phase 19: psmc, the explorer and the race witness. (b) A card FTRL
# ShardServer of WORKER_KEYS rows (phase 13's width) and a serving handle
# under the serving chaos-coherence test's plan (PSMC_PLAN, seed
# PSMC_PLAN_SEED, caching on): PSMC_ROUNDS push/pull rounds of PSMC_KEYS
# keys, for explorer seed PSMC_SEED and every seed the port's corpus
# records for PSMC_NODE, then once under the race witness; every pull and
# the table within PSMC_TOL (relative and absolute) of a CPU replay
PSMC_PLAN = "drop,cmd=pull,every=7;disconnect,cmd=push,every=5;duplicate,every=6"
PSMC_PLAN_SEED, PSMC_SEED, PSMC_ROUNDS, PSMC_KEYS, PSMC_TOL = 3, 8, 12, 4096, 1e-6
PSMC_NODE = ("tests/test_torch_serving.py::TestServingChaosCoherence::"
             "test_read_your_writes_and_exactly_once_under_chaos[torch-torch]")


def log(msg: str) -> None:
    print(f"[chip_smoke] {msg}", flush=True)


def bound(nbytes: float, flops: float, int_ops: float = 0.0) -> tuple[float, str]:
    """The least time of the work in ms, and what sets it: bytes at the
    memory rate, or operations at their type's rate (the INT32 and FP32
    lanes are separate units, so the slower of the two)."""
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = max(flops / F32_FLOPS_PER_S, int_ops / INT32_OPS_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def cuda_ms(fn, iters: int) -> tuple[float, float]:
    """(device ms, host-inclusive ms) of one call, by CUDA events around
    ``iters`` calls after one warm-up call.

    Host-inclusive: the events bracket the calls as the host issues them,
    so where a call's Python and launch overhead outlasts its kernels the
    device idles in between and the time is the host's. Device: the same
    calls are queued behind a spinning kernel (``torch.cuda._sleep``) long
    enough to cover their issue, so they run back to back and the events
    time the device work alone (unless a call waits for the device, as a
    host sync does: then both times are host-inclusive)."""
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)

    def run() -> float:
        start.record()
        for i in range(iters):
            fn(i)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / iters

    fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    host_ms = run()
    issue_s = time.perf_counter() - t0
    # spin for twice the measured issue time at up to 2 GHz
    torch.cuda._sleep(int(2 * issue_s * 2e9))
    return run(), host_ms


def profile(fn) -> tuple[float, float, list]:
    """(wall ms, device-busy ms, device rows) of ``fn`` under torch.profiler
    (CUPTI): the device's busy time is the sum of the self device times of
    everything it ran. Rows are (name, device ms, count), longest first."""
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as prof_ctx

    torch.cuda.synchronize()
    with prof_ctx(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    # device-side rows only (kernels, copies, fills): CPU-op rows repeat
    # the time of the kernels they launched, and so do the device ranges of
    # user annotations (Optimizer.step#Adam.step)
    rows = [
        (e.key, e.self_device_time_total / 1e3, e.count)
        for e in prof.key_averages()
        if str(e.device_type).endswith(("CUDA", "PrivateUse1"))
        and not getattr(e, "is_user_annotation", False)
    ]
    rows = sorted((r for r in rows if r[1] > 0), key=lambda r: -r[1])
    return wall_ms, sum(t for _, t, _ in rows), rows


def log_profile(what: str, fn) -> list:
    wall_ms, busy_ms, rows = profile(fn)
    top = [(k[:60], round(t, 4)) for k, t, _ in rows[:8]]
    log(f"{what}: wall {wall_ms:.3f} ms, device busy {busy_ms:.3f} ms (idle "
        f"share {1 - busy_ms / wall_ms:.3f}); top device time: {top}")
    return rows


def kernel_row(rows: list, kernel: str) -> tuple[float, int]:
    """(device ms per launch, launches) of ``kernel`` in a profile's rows."""
    hits = [(t, c) for k, t, c in rows if kernel in k]
    if not hits:
        raise AssertionError(f"the profile shows no {kernel} on the device")
    ms, count = sum(t for t, _ in hits), sum(c for _, c in hits)
    return ms / count, count


def check_close(name: str, got, want) -> float:
    err = (got - want).abs().max().item() if got.numel() else 0.0
    if not torch.allclose(got, want, rtol=RTOL, atol=ATOL):
        raise AssertionError(f"{name}: kernel disagrees with plain, max abs err {err}")
    return err


def bits_changed(a, b):
    """Per-row mask of rows whose bits differ anywhere."""
    return (a.view(torch.int32) != b.view(torch.int32)).reshape(a.shape[0], -1).any(1)


def check_delta(fk, dev, gen, rows: int, vdim: int, hyper: dict = HYPER,
                offset: bool = False) -> float:
    """K2 vs its plain version; w == 0 exactly (dz == g) where |z| <= l1.
    ``offset``: z, n, g are contiguous views one element into their
    storage, so no base address is 16-byte aligned."""
    def make(scale, draw):
        t = draw((rows * vdim + offset,), generator=gen, device=dev) * scale
        return t[int(offset):].view(rows, vdim)

    z, n, g = make(2, torch.randn), make(4, torch.rand), make(1, torch.randn)
    dz, dn = fk.ftrl_delta(z, n, g, **hyper)
    pz, pn = fk.ftrl_delta_plain(z, n, g, **hyper)
    torch.cuda.synchronize()
    what = f"ftrl_delta {rows}x{vdim}{' offset' if offset else ''}"
    err = max(check_close(f"{what} dz", dz, pz), check_close(f"{what} dn", dn, pn))
    inside = z.abs() <= hyper["l1"]
    if not inside.any() or not torch.equal(dz[inside], g[inside]):
        raise AssertionError("ftrl_delta: w must be exactly 0 where |z| <= l1")
    return err


def check_push(name, kernel, plain, dev, gen, idx_np, rows: int, vdim: int,
               hyper: dict, zero_pad_row: bool = False) -> float:
    """A fused push kernel vs its plain version on a ``rows``-row table
    pair with random state, plus repeated pad slots (idx 0, zero
    gradient, as the key set's own pad slots are made); rows the push does
    not touch (and the pad row) keep their bits. ``zero_pad_row`` zeroes
    row 0, the invariant AdaGrad's pad slots rely on when l2 > 0."""
    pads = 37
    idx = torch.from_numpy(
        np.concatenate([idx_np, np.zeros(pads, idx_np.dtype)]).astype(np.int32)
    ).to(dev)
    g = torch.randn((idx.shape[0], vdim), generator=gen, device=dev)
    g[idx == 0] = 0.0  # every pad slot: these and any the key set carries
    a0 = torch.randn((rows, vdim), generator=gen, device=dev) * 2
    b0 = torch.rand((rows, vdim), generator=gen, device=dev) * 4
    if zero_pad_row:
        a0[0] = 0.0
        b0[0] = 0.0
    ak_, bk = a0.clone(), b0.clone()
    kernel(ak_, bk, idx, g, **hyper)
    changed = bits_changed(ak_, a0) | bits_changed(bk, b0)
    touched = idx[:-pads].long()
    changed[touched] = False
    if changed.any():
        raise AssertionError(
            f"{name} vdim {vdim}: {int(changed.sum())} untouched rows changed"
        )
    del changed
    plain(a0, b0, idx, g, **hyper)  # in place
    torch.cuda.synchronize()
    return max(
        check_close(f"{name} table a vdim {vdim}", ak_[touched], a0[touched]),
        check_close(f"{name} table b vdim {vdim}", bk[touched], b0[touched]),
    )


def key_sets(rng, gen, dev, count: int, keys: int, draws: int, vdim: int):
    """``count`` (idx, grad) pairs on the card, each the unique keys of
    ``draws`` uniform draws into ``keys`` rows; and their mean size."""
    sets = []
    for _ in range(count):
        keys_np = np.unique(rng.integers(1, keys, draws)).astype(np.int32)
        sets.append((torch.from_numpy(keys_np).to(dev),
                     torch.randn((len(keys_np), vdim), generator=gen, device=dev)))
    return sets, sum(k.shape[0] for k, _ in sets) / count


def time_ftrl_push(fk, z, n, sets, u: float) -> dict:
    """Device times (cuda_ms) of K1 and its plain version on the (K, 1)
    tables ``z``, ``n``, cycling the touched sets so each call finds its
    rows cold, beside the bound and the access pattern's floor: PyTorch's
    gather of z and n at the same keys (``index_select``), which moves the
    read half of K1's sectors with none of its arithmetic. The port never
    calls it."""
    count = len(sets)
    k_ms, k_call = cuda_ms(lambda i: fk.ftrl_push(z, n, *sets[i % count], **HYPER), 200)
    p_ms, p_call = cuda_ms(
        lambda i: fk.ftrl_push_plain(z, n, *sets[i % count], **HYPER), PLAIN_ITERS)
    g_ms, _ = cuda_ms(lambda i: (z.index_select(0, sets[i % count][0]),
                                 n.index_select(0, sets[i % count][0])), 200)
    b_ms, b_by = bound(u * (4 + 4 + 16), FTRL_FLOPS * u)
    return {"rows": u, "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
            "gather_floor_ms": g_ms, "call_ms": k_call, "plain_call_ms": p_call}


def adagrad_bound(slots: float, rows: float, vdim: int) -> tuple[float, str]:
    """K3's bound for a push of ``slots`` slots over ``rows`` distinct rows:
    each slot's index and gradient read once, each distinct row's w and n
    read and written once (repeated pad slots all land on row 0)."""
    return bound(slots * (4 + 4 * vdim) + rows * 16 * vdim, ADAGRAD_FLOPS * rows * vdim)


def time_adagrad_push(ak, w, n, sets) -> dict:
    """Device and host-inclusive times (cuda_ms) of K3 on the tables ``w``,
    ``n`` (l2 = 0), cycling the (idx, grad) ``sets``."""
    count = len(sets)
    k_ms, k_call = cuda_ms(
        lambda i: ak.adagrad_push(w, n, *sets[i % count], **ADAGRAD, l2=0.0), 200)
    return {"ms": k_ms, "call_ms": k_call}


def time_adagrad_yardsticks(ak, w, n, sets) -> dict:
    """Device times (cuda_ms) of K3's plain version and of torch.optim.
    Adagrad's step on a sparse COO gradient of the same rows (l2 = 0: its
    weight decay refuses sparse gradients; the port never calls it), its
    accumulator seeded with ``n``, cycling ``sets`` of sorted unique keys;
    the library step is first held against the plain version on the first
    set's rows."""
    count = len(sets)
    p_ms, p_call = cuda_ms(
        lambda i: ak.adagrad_push_plain(w, n, *sets[i % count], **ADAGRAD, l2=0.0), PLAIN_ITERS)
    torch.sparse.check_sparse_tensor_invariants.disable()  # keys are unique, sorted
    grads = [torch.sparse_coo_tensor(k[None].long(), g, w.shape, is_coalesced=True)
             for k, g in sets]
    param = torch.nn.Parameter(w)
    opt = torch.optim.Adagrad([param], lr=ADAGRAD["eta"], eps=ADAGRAD["eps"], foreach=False)
    opt.state[param]["sum"].copy_(n)
    idx0, g0 = sets[0]
    rows0 = idx0.long()
    w_plain, n_plain = w[rows0], n[rows0]
    local = torch.arange(len(rows0), dtype=torch.int32, device=w.device)
    ak.adagrad_push_plain(w_plain, n_plain, local, g0, **ADAGRAD, l2=0.0)
    param.grad = grads[0]
    opt.step()
    err = max(check_close("torch.optim.Adagrad w", param.detach()[rows0], w_plain),
              check_close("torch.optim.Adagrad n", opt.state[param]["sum"][rows0], n_plain))

    def lib_step(i: int) -> None:
        param.grad = grads[i % count]
        opt.step()

    l_ms, l_call = cuda_ms(lib_step, PLAIN_ITERS)
    return {"plain_ms": p_ms, "library_ms": l_ms, "library_err": err,
            "plain_call_ms": p_call, "library_call_ms": l_call}


def simulated_pushes(rng, num_keys: int, workers: int, draws: int, hot: int,
                     vdim: int):
    """One round of pushes from ``workers`` simulated workers: each draws
    its keys uniformly (as bench.py's fused-push cells) plus a shared hot
    set, so coalescing has duplicate keys to sum."""
    hot_keys = np.arange(1, hot + 1)
    idx_list, grad_list = [], []
    for _ in range(workers):
        keys = np.unique(
            np.concatenate([rng.integers(1, num_keys, draws), hot_keys])
        )
        idx_list.append(keys)
        grad_list.append(rng.normal(size=(len(keys), vdim)).astype(np.float32))
    return idx_list, grad_list


def serve_rounds(store, rounds, dev, counter: dict, kernel: str):
    """Coalesced pushes of every round, then a pull of the last round's
    keys. Returns (pulled, pre-push state rows of those keys, their summed
    gradient, host seconds, launches of ``kernel``); the launch counter is
    reset just before and read just after."""
    from parameter_server_tpu_torch.kv.store import coalesce_pushes

    torch.cuda.synchronize()
    for k in counter:
        counter[k] = 0
    t0 = time.perf_counter()
    for r, (idx_list, grad_list) in enumerate(rounds):
        if r == len(rounds) - 1:
            uniq, summed = coalesce_pushes(idx_list, grad_list)
            sel = torch.from_numpy(uniq.astype(np.int64)).to(dev)
            pre = {k: v.index_select(0, sel).cpu() for k, v in store.state.items()}
        store.push_multi(idx_list, grad_list)
    pulled = store.pull(uniq).cpu()
    seconds = time.perf_counter() - t0
    if counter[kernel] < len(rounds):
        raise AssertionError(f"server launched {kernel} {counter[kernel]} times, "
                             f"want {len(rounds)}")
    if not torch.isfinite(pulled).all() or not (pulled != 0).any():
        raise AssertionError("server: pulled weights are not finite and nonzero")
    return pulled, pre, torch.from_numpy(summed), seconds, counter[kernel]


def decode_bound(scale, x) -> torch.Tensor:
    """|decode - x| may reach one step plus float32 roundings (ROUNDING_ULPS)."""
    lo, hi = torch.aminmax(x)
    return scale + ROUNDING_ULPS * 2.0**-24 * (lo.abs() + hi.abs())


def check_quantize(qk, codec, dev, gen, n: int, num_bytes: int) -> int:
    """K4 against its plain version on ``n`` elements, for each of
    CODEC_SEEDS: q, lo and scale equal bit for bit; every decode within
    ``decode_bound`` of its input; the maximum saturates to the integer
    type's top and decodes near hi (a wrapped cast would give lo - scale).
    Returns the largest |q - plain q| (0 when it passes)."""
    x = torch.randn(n, generator=gen, device=dev) * 3 + 1
    top = x.argmax()
    err = 0
    for seed in CODEC_SEEDS:
        e = codec.encode(seed, x)
        pq, plo, pscale = qk.quantize_stochastic_plain(seed, x, num_bytes)
        err = max(err, (e.q.int() - pq.int()).abs().max().item())
        what = f"quantize_stochastic n {n} int{8 * num_bytes} seed {seed}"
        if not (torch.equal(e.q, pq) and torch.equal(e.lo, plo) and torch.equal(e.scale, pscale)):
            raise AssertionError(f"{what}: {int((e.q != pq).sum())} of {n} q differ from the "
                                 f"plain version; lo {e.lo.item()} vs {plo.item()}, scale "
                                 f"{e.scale.item()} vs {pscale.item()}")
        dec = codec.decode(e)
        tol = decode_bound(e.scale, x)
        if not (dec - x).abs().max() <= tol:
            raise AssertionError(f"{what}: |decode - x| {(dec - x).abs().max().item()} > {tol.item()}")
        if e.q[top] != torch.iinfo(e.q.dtype).max or not (dec[top] - x[top]).abs() <= tol:
            raise AssertionError(f"{what}: the maximum encodes to {e.q[top].item()} and "
                                 f"decodes to {dec[top].item()}, hi is {x[top].item()}")
    return err


def round_ups(q, x, lo, scale, num_bytes: int):
    """(up, frac) of the elements no clamp touches: up = 1 where an element
    was rounded up, frac = t - floor t, the probability that it is."""
    half = ((1 << (8 * num_bytes)) - 1) // 2
    t = (x - lo) / scale
    floor = torch.floor(t)
    keep = t < 2 * half - 1
    up = (q.to(torch.float32) + half - floor)[keep].double()
    if not ((up == 0) | (up == 1)).all():
        raise AssertionError("an element rounded to neither floor t nor floor t + 1")
    return up, (t - floor)[keep].double()


def time_quantize(qk, dev, gen, shape, num_bytes: int, sets: int) -> dict:
    """Device times (cuda_ms) of K4's rounding pass, the encode wrapper
    (aminmax + scale + kernel), the aminmax alone and the plain versions,
    cycling ``sets`` inputs, beside the bounds."""
    xs = [torch.randn(shape, generator=gen, device=dev) for _ in range(sets)]
    ps = [qk.quantize_params(x, num_bytes) for x in xs]
    n = xs[0].numel()
    k_ms, k_call = cuda_ms(
        lambda i: qk.stochastic_round(i, xs[i % sets], ps[i % sets], num_bytes), 200)
    e_ms, e_call = cuda_ms(lambda i: qk.quantize_stochastic(i, xs[i % sets], num_bytes),
                           ENCODE_ITERS)
    a_ms, _ = cuda_ms(lambda i: torch.aminmax(xs[i % sets]), 200)
    p_ms, _ = cuda_ms(
        lambda i: qk.stochastic_round_plain(i, xs[i % sets], ps[i % sets], num_bytes),
        PLAIN_QUANT_ITERS)
    pe_ms, _ = cuda_ms(lambda i: qk.quantize_stochastic_plain(i, xs[i % sets], num_bytes),
                       PLAIN_QUANT_ITERS)
    b_ms, b_by = bound(n * (4 + num_bytes), QUANT_FLOPS * n, QUANT_INT_OPS * n)
    return {
        "shape": list(shape), "num_bytes": num_bytes, "sets": sets,
        "ms": k_ms, "plain_ms": p_ms, "bound_ms": b_ms, "bound_by": b_by,
        "encode_ms": e_ms, "plain_encode_ms": pe_ms, "aminmax_ms": a_ms,
        "aminmax_bound_ms": bound(4 * n, n)[0], "call_ms": k_call, "encode_call_ms": e_call,
    }


def codec_round_trip(store, rounds, device, remap=None):
    """The fixed-point filter's sequence on ``rounds`` of simulated pushes:
    each worker encodes its gradient on ``device`` (seeds CODEC_FIRST_SEED,
    +1, ...); the payload crosses to the server as host arrays; the server
    decodes it on its own device and brings it to the host, as the wire
    tier's ``_decode_grad`` does; each round is one coalesced push.
    ``remap`` maps keys into a compact table. Returns (payload bytes on
    the wire, the largest |decode - g| over its bound, the payloads q)."""
    from parameter_server_tpu_torch.filters.fixed_point import Encoded, FixedPointCodec

    codec = FixedPointCodec(1)
    seed, wire, worst, payloads = CODEC_FIRST_SEED, 0, 0.0, []
    for idx_list, grad_list in rounds:
        decoded = []
        for g in grad_list:
            g_dev = torch.from_numpy(g).to(device)
            e = codec.encode(seed, g_dev)
            seed += 1
            q, lo, scale = e.q.cpu(), e.lo.cpu(), e.scale.cpu()
            wire += q.numel() * q.element_size() + 8
            payloads.append(q)
            dec = codec.decode(Encoded(*(t.to(store.device) for t in (q, lo, scale))))
            worst = max(worst, ((dec.to(device) - g_dev).abs().max()
                                / decode_bound(e.scale, g_dev)).item())
            decoded.append(dec.cpu().numpy())
        keys = idx_list if remap is None else [remap(k) for k in idx_list]
        store.push_multi(keys, decoded)
    return wire, worst, payloads


def check_e2e(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """The card's state against the CPU run's (see E2E_RTOL); returns the
    largest |got - want| over the table's largest |want|."""
    got, want = got.double(), want.double()
    scale = want.abs().max().item() if want.numel() else 0.0
    err = (got - want).abs()
    if not bool((err <= E2E_RTOL * (want.abs() + scale)).all()):
        raise AssertionError(f"{name}: card vs CPU max abs err {err.max().item()} "
                             f"(table scale {scale})")
    return err.max().item() / scale if scale else 0.0


def check_moved(name: str, got: torch.Tensor, want: torch.Tensor, init: torch.Tensor,
                eta: float) -> str:
    """Phase 11 (b)'s AdaGrad tables (W&D's embeddings, word2vec's input
    table), card vs CPU, ``init`` the table before training: every element
    within E2E_RTOL (``check_e2e``) but at most POD_MOVED_OFF_SHARE of the
    elements training moved, each of those within 2 ``eta``. Returns what
    it found."""
    got, want = got.double(), want.double()
    scale = want.abs().max().item()
    err = (got - want).abs()
    off = int((err > E2E_RTOL * (want.abs() + scale)).sum())
    moved = int((want != init.double()).sum())
    worst = err.max().item()
    if off > POD_MOVED_OFF_SHARE * moved or worst > 2 * eta:
        raise AssertionError(f"{name}: card vs CPU, {off} of {moved} moved elements off by "
                             f"more than E2E_RTOL, max abs err {worst} (table scale {scale})")
    return (f"{off} of {moved} moved elements past E2E_RTOL, max abs err {worst:.3g} "
            f"({worst / scale:.3g} of scale)")


def check_rows(name: str, got: torch.Tensor, want: torch.Tensor) -> float:
    """Row by row: the largest |got - want| of a row within E2E_RTOL of the
    row's largest |want|. Returns the worst row's error over that scale."""
    err, scale = row_drift(got, want)
    bad = err > E2E_RTOL * scale
    if bool(bad.any()):
        r = int(bad.nonzero()[0, 0])
        raise AssertionError(f"{name}: {int(bad.sum())} rows off; row {r}: card vs CPU "
                             f"{err[r].item()} (row scale {scale[r].item()})")
    return (err / scale.clamp(min=1e-30)).max().item() if err.numel() else 0.0


def row_drift(got: torch.Tensor, want: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """(largest |got - want| of each row, largest |want| of each row)."""
    got, want = got.double(), want.double()
    return (got - want).abs().amax(1), want.abs().amax(1)


def zipf_ids(rng, a: float, vocab: int, n: int) -> np.ndarray:
    """``n`` ids with P(id = k) proportional to (k + 1)^-a, k < vocab."""
    cdf = np.cumsum(np.arange(1, vocab + 1, dtype=np.float64) ** -a)
    return np.minimum(np.searchsorted(cdf, rng.random(n) * cdf[-1], side="right"),
                      vocab - 1)


def with_pad_row(rows: torch.Tensor) -> torch.Tensor:
    return torch.cat([torch.zeros(1, rows.shape[1]), rows])


def synthetic_ratings(rng):
    """MF_RATINGS ratings of uniformly drawn (user, item) pairs: a rank-8
    truth around 3.5 plus noise, clipped to MovieLens' [0.5, 5] range."""
    ut = rng.normal(scale=0.5, size=(MF_USERS, 8)).astype(np.float32)
    vt = rng.normal(scale=0.5, size=(MF_ITEMS, 8)).astype(np.float32)
    users = rng.integers(0, MF_USERS, MF_RATINGS)
    items = rng.integers(0, MF_ITEMS, MF_RATINGS)
    r = 3.5 + np.sum(ut[users] * vt[items], axis=1) + rng.normal(scale=0.3, size=MF_RATINGS)
    return users, items, np.clip(r, 0.5, 5.0).astype(np.float32)


def make_wd_batches() -> list:
    """WD_STEPS synthetic CTR minibatches of WD_BATCH rows with Criteo's
    WD_FIELDS fields (Zipf keys over WD_FEATURES features, hashed into
    WD_KEYS), built by the CLI's builder (``training_builder``)."""
    from parameter_server_tpu_torch.data.batch import training_builder
    from parameter_server_tpu_torch.data.synthetic import make_sparse_logistic
    from parameter_server_tpu_torch.utils.config import PSConfig

    wd_cfg = PSConfig()
    wd_cfg.data.num_keys = WD_KEYS
    wd_cfg.solver.minibatch = WD_BATCH
    wd_cfg.data.max_nnz_per_example = 4 * WD_FIELDS
    wd_builder = training_builder(wd_cfg)
    labels, keys, vals, _ = make_sparse_logistic(
        WD_BATCH * WD_STEPS, WD_FEATURES, nnz_per_example=WD_FIELDS, noise=0.4, seed=SEED + 2)
    return [wd_builder.build(labels[i:i + WD_BATCH], keys[i:i + WD_BATCH], vals[i:i + WD_BATCH])
            for i in range(0, WD_BATCH * WD_STEPS, WD_BATCH)]


def wd_push_sets(batches, dev, gen) -> tuple[list, list]:
    """Each batch's embedding push on the card, (idx, grad) at vdim
    WD_EMB_DIM: its whole unique-key array (every pad slot, zero gradient)
    and its real prefix ``unique_keys[:num_unique]``, which the step
    pushes (the prefix's gradient is a view of the whole one's)."""
    full, prefix = [], []
    for b in batches:
        idx = torch.from_numpy(b.unique_keys.astype(np.int32)).to(dev)
        g = torch.randn((idx.shape[0], WD_EMB_DIM), generator=gen, device=dev)
        g[idx == 0] = 0.0
        full.append((idx, g))
        prefix.append((idx[:b.num_unique], g[:b.num_unique]))
    return full, prefix


def phase_wide_deep(dev, gen) -> tuple[dict, dict, float, float, list, torch.Tensor]:
    """Phase 9: K1 and K3 against their plain versions at the W&D push's
    shapes; K3 timed at the step's push (the real prefix of each batch's
    unique keys) and at the whole unique-key array, and at the prefix
    beside its plain version and torch.optim.Adagrad;
    the first steps against a CPU run; then the main path,
    ``WideDeep.train`` over WD_STEPS batches, with its launch counts, and a
    profile of one window entry. Returns (launches, the kernels' times at
    this shape, K1's and K3's max abs errors, the batches, and a copy of
    the initial embedding table on the card for phase 11)."""
    from parameter_server_tpu_torch.models import wide_deep as wdm
    from parameter_server_tpu_torch.models.linear import batch_to_device
    from parameter_server_tpu_torch.ops import adagrad_kernels as ak
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    t0 = time.perf_counter()
    wd_batches = make_wd_batches()
    slots = [b.unique_keys.shape[0] for b in wd_batches]
    uniq = [b.num_unique for b in wd_batches]
    log(f"wide_deep set-up data in {time.perf_counter() - t0:.2f} s: {WD_STEPS} batches "
        f"(B, NNZ, U) from {wd_batches[0].shape} to {wd_batches[-1].shape}; "
        f"{np.mean([b.num_entries for b in wd_batches]):.1f} entries and "
        f"{np.mean(uniq):.1f} distinct rows (pad row included; the slots a step pushes) a "
        f"batch of {np.mean(slots):.1f} unique-key slots; "
        f"CTR {np.mean([b.labels.mean() for b in wd_batches]):.4f}")
    # K1 and K3 against their plain versions at this path's shapes: the
    # first step's push (its real prefix) into 10^8-row tables; K3 also at
    # the whole unique-key array, ~240k pad slots on row 0
    wd_hyper = {"alpha": WD_FTRL["alpha"], "beta": WD_FTRL["beta"],
                "l1": WD_FTRL["lambda_l1"], "l2": WD_FTRL["lambda_l2"]}
    wd_ada = {"eta": WD_EMB_ETA, "eps": ADAGRAD["eps"], "l2": 0.0}
    idx0 = wd_batches[0].unique_keys
    prefix0 = idx0[:wd_batches[0].num_unique]
    err_wd_k1 = check_push("ftrl_push", fk.ftrl_push, fk.ftrl_push_plain, dev, gen, prefix0,
                           WD_KEYS, 1, wd_hyper)
    torch.cuda.empty_cache()
    err_wd_k3 = 0.0
    for keys in (prefix0, idx0):
        err_wd_k3 = max(err_wd_k3, check_push("adagrad_push", ak.adagrad_push,
                                              ak.adagrad_push_plain, dev, gen, keys, WD_KEYS,
                                              WD_EMB_DIM, wd_ada))
        torch.cuda.empty_cache()
    log(f"wide_deep pushes ok against the plain versions on {WD_KEYS} rows at "
        f"{len(prefix0)} slots: ftrl_push (vdim 1) max abs err {err_wd_k1:.3g}, adagrad_push "
        f"(vdim {WD_EMB_DIM}) {err_wd_k3:.3g}, also at all {len(idx0)} slots")
    # K3's times at this shape, cycling the WD_STEPS batches' pushes (~89 MB
    # of rows in all, so each call finds its rows cold)
    w = torch.zeros((WD_KEYS, WD_EMB_DIM), device=dev)
    n = torch.rand((WD_KEYS, WD_EMB_DIM), generator=gen, device=dev)
    full_sets, prefix_sets = wd_push_sets(wd_batches, dev, gen)
    k3_times = {}
    for what, sets, u in (("full", full_sets, float(np.mean(slots))),
                          ("prefix", prefix_sets, float(np.mean(uniq)))):
        t = time_adagrad_push(ak, w, n, sets)
        t["bound_ms"], t["bound_by"] = adagrad_bound(u, float(np.mean(uniq)), WD_EMB_DIM)
        t["slots"] = u
        k3_times[what] = t
    k3_times["prefix"].update(time_adagrad_yardsticks(ak, w, n, prefix_sets))
    del w, n, full_sets, prefix_sets
    torch.cuda.empty_cache()
    for what, t in k3_times.items():
        log(f"wide_deep adagrad_push at the {what} push ({t['slots']:.1f} slots, "
            f"{np.mean(uniq):.1f} distinct rows x {WD_EMB_DIM} of {WD_KEYS}, {WD_STEPS} sets "
            f"cycled): device {t['ms']:.5f} ms kernel, bound {t['bound_ms']:.5f} ms "
            f"({t['bound_by']})"
            + (f"; {t['plain_ms']:.5f} ms plain, {t['library_ms']:.5f} ms torch.optim.Adagrad "
               f"sparse step (agrees with plain to {t['library_err']:.3g})"
               if "library_ms" in t else ""))

    def make_wd(num_keys: int, device, reporter=None):
        return wdm.WideDeep(
            num_keys, emb_dim=WD_EMB_DIM, hidden=WD_HIDDEN, ftrl_kw=WD_FTRL,
            emb_eta=WD_EMB_ETA, mlp_lr=WD_MLP_LR, seed=SEED,
            reporter=reporter or ProgressReporter(print_fn=lambda s: None),
            steps_per_call=WD_STEPS_PER_CALL, max_delay=WD_MAX_DELAY, device=device,
        )

    wd_rep = ProgressReporter(print_fn=lambda s: log(f"wide_deep | {s}"))
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    wd = make_wd(WD_KEYS, dev, wd_rep)
    torch.cuda.synchronize()
    t_wd_init = time.perf_counter() - t0
    # phase 11's apps start from this draw (the host takes tens of seconds
    # to make it again)
    init_w = wd.emb_state["w"].clone()
    log(f"wide_deep init: the {WD_KEYS} x {WD_EMB_DIM} embedding draw (host float64 in "
        f"chunks of {wdm.INIT_CHUNK_ROWS} rows, cast, copied) and the tables in "
        f"{t_wd_init:.2f} s; device memory {torch.cuda.memory_allocated() / 2**30:.2f} GiB")
    # the first steps on the card against a CPU run that holds only the
    # rows those batches touch (a 10^8-row table on the host is 12.8 GB),
    # remapped into a compact table, from the card's initial rows
    first = wd_batches[:E2E_STEPS]
    union = np.unique(np.concatenate([b.unique_keys[1:b.num_unique] for b in first]))
    sel = torch.from_numpy(union.astype(np.int64)).to(dev)

    def rows_at(state):
        return {k: with_pad_row(v.index_select(0, sel).cpu()).numpy() for k, v in state.items()}

    wd_cpu = make_wd(len(union) + 1, "cpu")
    wd_cpu.load_state(rows_at(wd.wide_state), rows_at(wd.emb_state), wd.mlp.layers())

    def remap(b):
        uk = b.unique_keys.astype(np.int64)
        return dataclasses.replace(
            b, unique_keys=np.where(uk == 0, 0, np.searchsorted(union, uk) + 1).astype(np.int32))

    for step, b in enumerate(first):
        losses = [
            float(wdm.wd_train_step(a.wide_up, a.emb_up, a.wide_state, a.emb_state, a.mlp,
                                    a.opt, batch_to_device(ab, a.device), ab.num_examples,
                                    ab.num_unique)[0])
            for a, ab in ((wd, b), (wd_cpu, remap(b)))
        ]
        if not np.isclose(losses[0], losses[1], rtol=E2E_RTOL, atol=0.0):
            raise AssertionError(f"wide_deep step {step}: loss {losses[0]} on the card vs "
                                 f"{losses[1]} on the CPU")
    err_wd_state = 0.0
    for table in ("wide_state", "emb_state"):
        for k, v in getattr(wd, table).items():
            err_wd_state = max(err_wd_state, check_e2e(
                f"wide_deep {table}[{k!r}]", v.index_select(0, sel).cpu(),
                getattr(wd_cpu, table)[k][1:]))
    for i, (x, y) in enumerate(zip(wd.mlp.layers(), wd_cpu.mlp.layers())):
        for k in ("W", "b"):
            err_wd_state = max(err_wd_state, check_e2e(
                f"wide_deep mlp {k}{i}", torch.from_numpy(x[k]), torch.from_numpy(y[k])))
    del wd_cpu
    torch.cuda.synchronize()
    fk.reset_launches()
    ak.reset_launches()
    t0 = time.perf_counter()
    wd.train(wd_batches, report_every=WD_REPORT_EVERY)
    torch.cuda.synchronize()
    t_wd = time.perf_counter() - t0
    wd_launches = {**fk.LAUNCHES, **ak.LAUNCHES}
    if (wd_launches["ftrl_push"], wd_launches["adagrad_push"], wd_launches["ftrl_delta"]) != (
            WD_STEPS, WD_STEPS, 0):
        raise AssertionError(f"wide_deep phase launched {wd_launches} in {WD_STEPS} steps, "
                             "want one ftrl_push and one adagrad_push a step")
    hist = list(wd_rep.history)
    if not all(np.isfinite(r["objv"]) for r in hist) or not hist[-1]["auc"] > 0.5:
        raise AssertionError(f"wide_deep: bad progress {hist[-1]}")
    wd_ex_s = sorted(r["ex_per_sec"] for r in hist)
    log(f"wide_deep ok: {WD_STEPS} steps ({WD_STEPS_PER_CALL} a window entry, max_delay "
        f"{WD_MAX_DELAY}) in {t_wd:.3f} s; median {wd_ex_s[len(wd_ex_s) // 2]:.1f} ex/s over "
        f"{len(hist)} windows of {WD_REPORT_EVERY * WD_STEPS_PER_CALL} steps {wd_ex_s}; "
        f"progressive AUC {hist[-1]['auc']:.4f}; loss of steps 1-{E2E_STEPS}, the touched "
        f"rows of z, n, w, n and the MLP match the CPU run (largest error "
        f"{err_wd_state:.3g} of its table's scale); launches {wd_launches}")
    rows = log_profile(f"wide_deep profile, {WD_STEPS_PER_CALL} steps (one window entry)",
                       lambda: wd.train(wd_batches[:WD_STEPS_PER_CALL], report_every=1))
    # bounds at the pushes the profiled steps made: their real prefixes,
    # each slot a distinct row (K3's bound at vdim 1 is K1's in bytes)
    u_prof = float(np.mean(uniq[:WD_STEPS_PER_CALL]))
    wd_kernels = {}
    for name, kernel, vdim, flops in (("ftrl_push", "ftrl_push_kernel", 1, FTRL_FLOPS),
                                      ("adagrad_push", "adagrad_push_kernel", WD_EMB_DIM,
                                       ADAGRAD_FLOPS)):
        ms, count = kernel_row(rows, kernel)
        b_ms, b_by = bound(u_prof * (4 + 20 * vdim), flops * u_prof * vdim)
        wd_kernels[name] = {"ms": ms, "profiled_launches": count, "bound_ms": b_ms,
                            "bound_by": b_by, "slots": u_prof, "rows": u_prof, "vdim": vdim}
        log(f"wide_deep {name}: {ms:.5f} ms a launch on the device ({count} in the "
            f"profile), bound {b_ms:.5f} ms ({b_by}) at {u_prof:.1f} slots, each a distinct "
            f"row x {vdim} of {WD_KEYS}")
    wd_kernels["adagrad_push"]["timed"] = k3_times
    return wd_launches, wd_kernels, err_wd_k1, err_wd_k3, wd_batches, init_w


def phase_word2vec(dev) -> None:
    """Phase 10: SGNS at a 2^20-word vocabulary, plain PyTorch (duplicate
    ids push one delta each, which K3's one-key-a-slot contract excludes):
    the first steps against a CPU run, two epochs and a streaming epoch
    from a .npy corpus with no kernel launched, and a profile of one
    window entry."""
    from parameter_server_tpu_torch.models import word2vec as w2vm
    from parameter_server_tpu_torch.ops import adagrad_kernels as ak
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.ops import quantize_kernels as qk
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    t0 = time.perf_counter()
    corpus = zipf_ids(np.random.default_rng(SEED + 3), W2V_ZIPF, W2V_VOCAB, W2V_TOKENS)

    def make_w2v(device, reporter=None):
        return w2vm.Word2Vec(
            W2V_VOCAB, dim=W2V_DIM, eta=W2V_ETA, num_negatives=W2V_NEG, window=W2V_WINDOW,
            seed=SEED, reporter=reporter or ProgressReporter(print_fn=lambda s: None),
            max_delay=W2V_MAX_DELAY, steps_per_call=W2V_STEPS_PER_CALL, device=device,
        )

    w2v_rep = ProgressReporter(print_fn=lambda s: log(f"word2vec | {s}"))
    w2v, w2v_cpu, w2v_reordered = make_w2v(dev, w2v_rep), make_w2v("cpu"), make_w2v("cpu")
    # the first batches as train_epoch(seed=0) draws them
    sampler = w2vm.NegativeSampler(np.bincount(corpus, minlength=W2V_VOCAB), seed=0)
    centers, contexts = w2v.make_pairs(corpus)
    order = np.random.default_rng(0).permutation(len(centers))
    first = [w2v._make_batch(centers, contexts, sampler,
                             order[s * W2V_BATCH:(s + 1) * W2V_BATCH]) for s in range(E2E_STEPS)]
    log(f"word2vec set-up in {time.perf_counter() - t0:.2f} s: {W2V_TOKENS} tokens, "
        f"{len(np.unique(corpus))} distinct of {W2V_VOCAB}, the hottest "
        f"{np.bincount(corpus).max() / W2V_TOKENS:.4f} of the corpus; {len(centers)} pairs; "
        f"first batch: {len(np.unique(first[0]['center']))} distinct of {W2V_BATCH} centers")
    perm = np.random.default_rng(SEED).permutation(W2V_BATCH)
    runs = ((w2v, slice(None)), (w2v_cpu, slice(None)), (w2v_reordered, perm))

    def touched(batches):
        return (np.unique(np.concatenate([b["center"] for b in batches])),
                np.unique(np.concatenate([np.concatenate([b["context"][:, None], b["negatives"]],
                                                         1).ravel() for b in batches])))

    def rows(app, table, k, ids):
        return getattr(app, table)[k].index_select(0, torch.from_numpy(ids.astype(np.int64))
                                                   .to(getattr(app, table)[k].device)).cpu()

    step_losses, err_w2v_state = [], 0.0
    for step, b in enumerate(first):
        step_losses.append([
            float(w2vm.sgns_train_step(a.in_up, a.out_up, a.in_state, a.out_state,
                                       {k: torch.from_numpy(v[order]).to(a.device)
                                        for k, v in b.items()}))
            for a, order in runs
        ])
        if step == 0:
            for table, ids in zip(("in_state", "out_state"), touched(first[:1])):
                for k in ("w", "n"):
                    err_w2v_state = max(err_w2v_state, check_rows(
                        f"word2vec {table}[{k!r}] after step 1", rows(w2v, table, k, ids),
                        rows(w2v_cpu, table, k, ids)))
    for step, (card, cpu, _) in enumerate(step_losses[:W2V_E2E_STEPS]):
        if not np.isclose(card, cpu, rtol=E2E_RTOL, atol=0.0):
            raise AssertionError(f"word2vec step {step}: loss {card} on the card vs {cpu} "
                                 "on the CPU")
    drift = {}
    for table, ids in zip(("in_state", "out_state"), touched(first)):
        for k in ("w", "n"):
            want = rows(w2v_cpu, table, k, ids)
            drift[f"{table}[{k}]"] = [
                round((err / scale.clamp(min=1e-30)).max().item(), 6)
                for err, scale in (row_drift(rows(a, table, k, ids), want)
                                   for a in (w2v, w2v_reordered))]
    log(f"word2vec first steps: losses (card, CPU, CPU reordered) {step_losses}; after "
        f"step {E2E_STEPS}, the largest row drift from the CPU run over the row's scale "
        f"(card, CPU reordered): {drift}")
    del w2v_cpu, w2v_reordered
    torch.cuda.synchronize()
    fk.reset_launches()
    ak.reset_launches()
    qk.reset_launches()
    t0 = time.perf_counter()
    epoch_loss = [w2v.train_epoch(corpus, batch_size=W2V_BATCH, seed=ep) for ep in range(2)]
    torch.cuda.synchronize()
    t_w2v = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "corpus.npy")
        np.save(path, corpus)
        t0 = time.perf_counter()
        files_loss = w2v.train_files([path], batch_size=W2V_BATCH, epochs=1, seed=0,
                                     pipeline_depth=2)
        torch.cuda.synchronize()
        t_files = time.perf_counter() - t0
    w2v_launches = {**fk.LAUNCHES, **ak.LAUNCHES, **qk.LAUNCHES}
    if any(w2v_launches.values()):
        raise AssertionError(f"word2vec phase launched {w2v_launches}, want no kernel")
    if not np.isfinite(epoch_loss).all() or not epoch_loss[1] < epoch_loss[0]:
        raise AssertionError(f"word2vec: epoch mean loss {epoch_loss} must be finite and fall")
    files_rec = w2v_rep.history[-1]
    all_pairs = 2 * (2 * W2V_TOKENS - 3)  # window 2: every pair of the corpus once
    if files_rec["examples"] != all_pairs or not np.isfinite(files_loss):
        raise AssertionError(f"word2vec train_files: {files_rec['examples']} pairs (want "
                             f"{all_pairs}), mean loss {files_loss}")
    pairs_s = [r["ex_per_sec"] for r in w2v_rep.history]
    log(f"word2vec ok: 2 epochs of {len(centers) // W2V_BATCH} steps ({W2V_STEPS_PER_CALL} a "
        f"window entry, max_delay {W2V_MAX_DELAY}) in {t_w2v:.3f} s, {pairs_s[0]:.1f} / "
        f"{pairs_s[1]:.1f} pairs/s, mean loss {epoch_loss[0]:.6f} -> {epoch_loss[1]:.6f}; "
        f"train_files (.npy, pipeline_depth 2) {files_rec['examples']} pairs in "
        f"{t_files:.3f} s (vocabulary count included), {pairs_s[2]:.1f} pairs/s, mean loss "
        f"{files_loss:.6f}; loss of steps 1-{W2V_E2E_STEPS} and the touched rows after step 1 "
        f"match the CPU run (largest row error {err_w2v_state:.3g} of the row's scale); "
        f"launches "
        f"{w2v_launches}")
    micro = [w2v._make_batch(centers, contexts, sampler,
                             order[s * W2V_BATCH:(s + 1) * W2V_BATCH])
             for s in range(W2V_STEPS_PER_CALL)]
    log_profile(f"word2vec profile, {W2V_STEPS_PER_CALL} steps (one window entry)",
                lambda: float(w2v._dispatch(micro, W2V_STEPS_PER_CALL)))


def worker_cfg():
    """The linear worker's config: phase 4's table, batch and FTRL."""
    from parameter_server_tpu_torch.utils.config import PSConfig

    cfg = PSConfig()
    cfg.data.num_keys = WORKER_KEYS
    cfg.solver.minibatch = BATCH
    cfg.data.max_nnz_per_example = 4 * NNZ_PER
    cfg.lr.alpha, cfg.lr.beta = HYPER["alpha"], HYPER["beta"]
    cfg.penalty.lambda_l1, cfg.penalty.lambda_l2 = HYPER["l1"], HYPER["l2"]
    return cfg


def check_shard_push(name, kernel, plain, dev, gen, keys, rows: int, kv: int, vdim: int,
                     hyper: dict) -> float:
    """A fused push on kv shard 1 of ``kv`` (>= 3): the (S, vdim) rows
    [S, 2S) of a table pair of ``rows`` rows padded to the kv multiple,
    given ``keys - S`` as the SPMD push gives it, so the keys of shard 0
    fall below 0 and those of shards 2.. at or above S. The pad slots
    (global key 0) fall on -S. Kernel vs the plain version given the whole
    index; every row of the whole table the push does not touch keeps its
    bits."""
    s = -(-rows // kv)
    rows = s * kv
    idx = torch.from_numpy(np.concatenate([keys, np.zeros(37, keys.dtype)]).astype(np.int64)
                           - s).to(dev).to(torch.int32)
    g = torch.randn((idx.shape[0], vdim), generator=gen, device=dev)
    g[idx == -s] = 0.0
    a0 = torch.randn((rows, vdim), generator=gen, device=dev) * 2
    b0 = torch.rand((rows, vdim), generator=gen, device=dev) * 4
    ak_, bk = a0.clone(), b0.clone()
    kernel(ak_[s:2 * s], bk[s:2 * s], idx, g, **hyper)
    changed = bits_changed(ak_, a0) | bits_changed(bk, b0)
    inside = idx[(idx >= 0) & (idx < s)].long() + s
    changed[inside] = False
    if changed.any():
        raise AssertionError(f"{name} on a shard view: {int(changed.sum())} untouched rows "
                             "changed")
    if not ((idx < 0).any() and (idx >= s).any()):
        raise AssertionError(f"{name} on a shard view: no slot of another shard")
    plain(a0[s:2 * s], b0[s:2 * s], idx, g, **hyper)
    torch.cuda.synchronize()
    return max(check_close(f"{name} shard view table a", ak_[inside], a0[inside]),
               check_close(f"{name} shard view table b", bk[inside], b0[inside]))


def free_ports(count: int) -> list[int]:
    """``count`` distinct free ports (all bound at once while chosen)."""
    import contextlib
    import socket

    with contextlib.ExitStack() as stack:
        socks = [stack.enter_context(socket.socket()) for _ in range(count)]
        for sock in socks:
            sock.bind(("127.0.0.1", 0))
        return [sock.getsockname()[1] for sock in socks]


def free_port_block(count: int) -> int:
    """The first of ``count`` consecutive free ports (all bound at once
    while chosen): a cluster's metrics endpoints take base + offset, and a
    taken offset walks a node's endpoint up onto a neighbour's."""
    import socket

    for _ in range(64):
        base = free_ports(1)[0]
        with contextlib.ExitStack() as stack:
            try:
                for i in range(count):
                    stack.enter_context(socket.socket()).bind(("127.0.0.1", base + i))
            except OSError:
                continue
        return base
    raise AssertionError(f"no {count} consecutive free ports")


def start_rank(root: Path, logs: Path, tag: str, app_file: Path, device: str,
               extra: list[str], port: int, r: int) -> tuple:
    """Rank ``r`` of a 2x2 world of POD_RANKS ``cli train`` processes, rank
    0's store on ``port``; on the card the ranks share it over gloo. Returns
    (process, stdout path, stderr path)."""
    env = {**os.environ, "PYTHONPATH": str(root), "OMP_NUM_THREADS": "1"}
    out, err = logs / f"{tag}.{r}.out", logs / f"{tag}.{r}.err"
    argv = [sys.executable, "-m", "parameter_server_tpu_torch.cli", "train",
            "--app_file", str(app_file), "--device", device,
            "--coordinator", f"127.0.0.1:{port}", "--num_processes", str(POD_RANKS),
            "--process_id", str(r), "--report_interval", "1", *extra]
    if device == "cuda":
        argv += ["--dist_backend", "gloo"]
    with open(out, "w") as fo, open(err, "w") as fe:
        return subprocess.Popen(argv, cwd=root, env=env, stdout=fo, stderr=fe), out, err


def listens(pid: int, port: int) -> bool:
    """Whether process ``pid`` listens on ``port``: the listening sockets of
    /proc/net/tcp and tcp6 matched against its file descriptors, so no
    connection is made."""
    inodes = set()
    for table in ("/proc/net/tcp", "/proc/net/tcp6"):
        with open(table) as f:
            for line in f.readlines()[1:]:
                cells = line.split()
                if cells[3] == "0A" and int(cells[1].rsplit(":", 1)[1], 16) == port:
                    inodes.add(f"socket:[{cells[9]}]")
    fds = Path(f"/proc/{pid}/fd")
    for fd in os.listdir(fds) if inodes else ():
        try:
            if os.readlink(fds / fd) in inodes:
                return True
        except OSError:  # closed meanwhile
            pass
    return False


def start_worlds(root: Path, logs: Path, specs: dict, timeout: float) -> dict:
    """Start the worlds of ``specs`` (tag -> (app_file, device, extra)) at
    once: every world's rank 0 first, each on a port free when chosen, and
    the other ranks once every rank 0 listens. Until then no rank holds a
    connection, so no ephemeral port of one world can take another's store
    port, except rank 0's own connection to its store; a rank 0 that finds
    its port taken starts again on another (at most 3 times). Returns tag ->
    [(process, stdout path, stderr path)] a rank."""
    def first(tag: str, port: int) -> tuple:
        return port, start_rank(root, logs, tag, *specs[tag], port, 0)

    zeros = {tag: first(tag, port) for tag, port in zip(specs, free_ports(len(specs)))}
    t0, retries = time.perf_counter(), 0
    try:
        while True:
            waiting = False
            for tag, (port, (p, _, err)) in list(zeros.items()):
                if p.poll() is not None:
                    if "address already in use" not in err.read_text().lower() or retries == 3:
                        raise AssertionError(f"pod {tag} rank 0 exited {p.returncode} before "
                                             f"its world started: {err.read_text()[-1500:]}")
                    retries += 1
                    zeros[tag] = first(tag, free_ports(1)[0])
                    waiting = True
                elif not listens(p.pid, port):
                    waiting = True
            if not waiting:
                break
            if time.perf_counter() - t0 > timeout:
                raise AssertionError(f"pod: the worlds' stores did not listen within {timeout} s")
            time.sleep(0.05)
    except BaseException:
        for _, (p, _, _) in zeros.values():
            p.kill()
            p.wait()
        raise
    return {tag: [rank0] + [start_rank(root, logs, tag, *specs[tag], port, r)
                            for r in range(1, POD_RANKS)]
            for tag, (port, rank0) in zeros.items()}


def wait_worlds(worlds: dict, timeout: float) -> dict:
    """Wait for every world; any rank's nonzero exit, or the time limit, kills
    every rank of every world and fails. Returns each world's (rank 0's
    progress rows, every rank's result JSON, seconds until its last rank
    exited)."""
    t0 = time.perf_counter()
    failed = None
    done: dict = {}
    try:
        while failed is None:
            for tag, ranks in worlds.items():
                codes = [p.poll() for p, _, _ in ranks]
                if any(c not in (None, 0) for c in codes):
                    failed = "a rank exited nonzero"
                elif tag not in done and all(c == 0 for c in codes):
                    done[tag] = time.perf_counter() - t0
            if failed is None and len(done) == len(worlds):
                break
            if failed is None and time.perf_counter() - t0 > timeout:
                failed = f"the worlds outlasted {timeout} s"
            time.sleep(0.1)
    finally:
        for ranks in worlds.values():
            for p, _, _ in ranks:
                if p.poll() is None:
                    p.kill()
                p.wait()
    if failed:
        tails = [f"{tag} rank {r} (exit {p.returncode}): {err.read_text()[-1500:]}"
                 for tag, ranks in worlds.items() for r, (p, _, err) in enumerate(ranks)
                 if p.returncode]
        raise AssertionError(f"pod worlds: {failed}\n" + "\n".join(tails))
    res = {}
    for tag, ranks in worlds.items():
        outs = [out.read_text().rstrip().splitlines() for _, out, _ in ranks]
        res[tag] = {"rows": progress_rows(outs[0][:-1]),
                    "results": [json.loads(o[-1]) for o in outs], "seconds": done[tag]}
    return res


def progress_rows(lines: list[str]) -> list[dict]:
    """The rows of a printed progress table (ProgressReporter: cells 12
    wide, 2 apart) as {column: float}, empty cells left out."""
    cols, rows = None, []
    for line in lines:
        cells = [line[i:i + 12].strip() for i in range(0, len(line), 14)]
        if cells and cells[0] == "sec":
            cols = cells
        elif cols is not None and cells:
            rows.append({c: float(v) for c, v in zip(cols, cells) if v})
    return rows


def pod_timings(rt, steps, ref_steps, per_step: int, kernels: tuple) -> dict:
    """Phase 11 (a)'s times of one mode: POD_TIMED_STEPS steps of ``steps``
    (the mesh app) and of ``ref_steps`` (the single-device app, fed the
    same way; None: not timed here) timed back to back after the first
    POD_E2E_STEPS, then POD_PROFILE_STEPS of each profiled: idle share, the
    NCCL kernels' and device-to-device copies' time, each of ``kernels``'
    device time a launch, the payload handed to the collectives a step.
    ``steps(lo, hi)`` issues steps lo..hi-1; ``per_step`` examples a step."""
    def timed(fn) -> float:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn(POD_E2E_STEPS, POD_E2E_STEPS + POD_TIMED_STEPS)
        torch.cuda.synchronize()
        return POD_TIMED_STEPS * per_step / (time.perf_counter() - t0)

    lo, hi = POD_E2E_STEPS + POD_TIMED_STEPS, POD_E2E_STEPS + POD_TIMED_STEPS + POD_PROFILE_STEPS
    out = {"ex_per_s": timed(steps)}
    before = dict(rt.mesh.payload_bytes)
    wall_ms, busy_ms, rows = profile(lambda: steps(lo, hi))
    out.update(
        wall_ms=wall_ms, busy_ms=busy_ms, idle_share=1 - busy_ms / wall_ms,
        collectives_ms=sum(t for k, t, _ in rows if "nccl" in k.lower()),
        # NCCL on a world of one copies instead of launching kernels
        dtod_copies_ms=sum(t for k, t, _ in rows if "DtoD" in k),
        payload_bytes_a_step={k: (v - before[k]) / POD_PROFILE_STEPS
                              for k, v in rt.mesh.payload_bytes.items()},
        top=[(k[:50], round(t, 4)) for k, t, _ in rows[:6]])
    for kernel in kernels:
        out[f"{kernel}_ms"], out[f"{kernel}_launches"] = kernel_row(rows, f"{kernel}_kernel")
    if ref_steps is not None:
        out["worker_ex_per_s"] = timed(ref_steps)
        ref_wall, ref_busy, ref_rows = profile(lambda: ref_steps(lo, hi))
        out.update(worker_wall_ms=ref_wall, worker_busy_ms=ref_busy,
                   worker_idle_share=1 - ref_busy / ref_wall,
                   worker_top=[(k[:50], round(t, 4)) for k, t, _ in ref_rows[:4]])
    return out


def pod_timings_text(t: dict) -> str:
    kernels = {k[:-3]: (round(v, 5), t[k[:-3] + "_launches"]) for k, v in t.items()
               if k.endswith("_ms") and k[:-3] + "_launches" in t}
    text = (f"{t['ex_per_s']:.1f} ex/s over {POD_TIMED_STEPS} steps; profile of "
            f"{POD_PROFILE_STEPS} steps: wall {t['wall_ms']:.3f} ms, busy {t['busy_ms']:.3f} ms "
            f"(idle share {t['idle_share']:.3f}), NCCL kernels {t['collectives_ms']:.4f} ms, "
            f"device-to-device copies {t['dtod_copies_ms']:.4f} ms, payload handed to them a "
            f"step {t['payload_bytes_a_step']}, kernels (ms a launch, launches) {kernels}; "
            f"top {t['top']}")
    if "worker_ex_per_s" in t:
        text += (f"; the single-device app fed, timed and profiled the same way over the "
                 f"same steps: {t['worker_ex_per_s']:.1f} ex/s, wall {t['worker_wall_ms']:.3f} "
                 f"ms, busy {t['worker_busy_ms']:.3f} ms (idle share "
                 f"{t['worker_idle_share']:.3f}), top {t['worker_top']}")
    return text


@contextlib.contextmanager
def drawn_once(wdm, w: torch.Tensor):
    """``WideDeep``'s embedding draw replaced by ``w``, phase 9's initial
    table (the same seed's draw, which takes the host tens of seconds)."""
    draw = wdm.normal_table
    wdm.normal_table = lambda *args, **kw: w
    try:
        yield
    finally:
        wdm.normal_table = draw


def pod_wide_deep(rt, dev, wd_batches: list, init_w: torch.Tensor) -> dict:
    """Phase 11 (a) for Wide&Deep at phase 9's width: the single-device app
    and ``WideDeep(mesh=...)`` on the world of one, per_worker then
    aggregate, each from phase 9's initial tables, one step a window entry.
    The first POD_E2E_STEPS steps' losses, the touched rows of the four
    tables and the MLP match the single-device app's, which are kept on
    the host (the aggregate run's dense shard buffers and temporaries need
    the card's memory); K1 and K3 launch once a step in per_worker, K2 once
    a step in aggregate; the aggregate run's peak memory."""
    from parameter_server_tpu_torch.models import wide_deep as wdm
    from parameter_server_tpu_torch.ops import adagrad_kernels as ak
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    res = {"launches": {}, "times": {}}
    quiet = ProgressReporter(print_fn=lambda s: None)
    first = wd_batches[:POD_E2E_STEPS]
    union = np.unique(np.concatenate([b.unique_keys[1:b.num_unique] for b in first]))
    sel = torch.from_numpy(union.astype(np.int64)).to(dev)

    def make(mesh, mode: str, w: torch.Tensor):
        with drawn_once(wdm, w):
            return wdm.WideDeep(
                WD_KEYS, emb_dim=WD_EMB_DIM, hidden=WD_HIDDEN, ftrl_kw=WD_FTRL,
                emb_eta=WD_EMB_ETA, mlp_lr=WD_MLP_LR, seed=SEED, reporter=quiet, mesh=mesh,
                push_mode=mode, device=dev)

    def step_runner(app):
        def steps(lo: int, hi: int) -> list:
            return [app._dispatch([b])[0] for b in wd_batches[lo:hi]]
        return steps

    def touched(app) -> dict:
        rows = {f"{t}[{k!r}]": v.index_select(0, sel).cpu()
                for t in ("wide_state", "emb_state") for k, v in getattr(app, t).items()}
        for i, layer in enumerate(app.mlp.layers()):
            rows.update({f"mlp {k}{i}": torch.from_numpy(v) for k, v in layer.items()})
        return rows

    ref = make(None, "per_worker", init_w.clone())
    ref_steps = step_runner(ref)
    want_losses = [float(x) for x in ref_steps(0, POD_E2E_STEPS)]
    want = touched(ref)
    for mode, kernels in (("per_worker", ("ftrl_push", "adagrad_push")),
                          ("aggregate", ("ftrl_delta",))):
        if mode == "aggregate":
            # the dense shard buffers need the card: no single-device app beside
            del ref
            ref_steps = None
            torch.cuda.empty_cache()
            torch.cuda.reset_peak_memory_stats()
        app = make(rt.mesh, mode, init_w.clone() if mode == "per_worker" else init_w)
        steps = step_runner(app)
        torch.cuda.synchronize()
        fk.reset_launches()
        ak.reset_launches()
        losses = [float(x) for x in steps(0, POD_E2E_STEPS)]
        torch.cuda.synchronize()
        launches = {**fk.LAUNCHES, **ak.LAUNCHES}
        need = {k: POD_E2E_STEPS if k in kernels else 0
                for k in ("ftrl_push", "adagrad_push", "ftrl_delta")}
        if any(launches[k] != v for k, v in need.items()):
            raise AssertionError(f"pod 1x1 wide_deep {mode}: launches {launches} in "
                                 f"{POD_E2E_STEPS} steps, want {need}")
        res["launches"][f"pod_1x1_wd_{mode}"] = launches
        if not np.allclose(losses, want_losses, rtol=E2E_RTOL, atol=0.0):
            raise AssertionError(f"pod 1x1 wide_deep {mode}: losses {losses} vs the "
                                 f"single-device app's {want_losses}")
        got = touched(app)
        err = max(check_e2e(f"pod 1x1 wide_deep {mode} {k}", got[k], v) for k, v in want.items())
        t = pod_timings(rt, steps, ref_steps, WD_BATCH, kernels)
        if mode == "aggregate":
            t["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
            t["ftrl_delta_bound_ms"], t["ftrl_delta_bound_by"] = bound(
                20 * WD_KEYS, FTRL_FLOPS * WD_KEYS)
        res["times"][f"pod_1x1_wd_{mode}"] = t
        log(f"pod 1x1 wide_deep {mode} ok at {WD_KEYS} keys: losses of steps "
            f"1-{POD_E2E_STEPS}, the touched rows of z, n, w, n and the MLP match the "
            f"single-device app (worst {err:.3g} of scale); {pod_timings_text(t)}; launches "
            f"{launches}"
            + (f"; peak device memory {t['peak_memory_gib']:.2f} GiB; K2 over the whole "
               f"{WD_KEYS}-row shard {t['ftrl_delta_ms']:.5f} ms a launch, bound "
               f"{t['ftrl_delta_bound_ms']:.5f} ms ({t['ftrl_delta_bound_by']})"
               if mode == "aggregate" else ""))
        del app, steps
        torch.cuda.empty_cache()
    return res


def w2v_aggregate_step(app, b: dict) -> None:
    """One aggregate SGNS step of a single-device CPU app, IN PLACE: each
    table's gradients summed over the occurrences of an id, then one
    AdaGrad step on the rows the batch touched (the aggregate push on one
    data shard)."""
    from parameter_server_tpu_torch.models.word2vec import _sgns_weights_math

    center = torch.from_numpy(b["center"]).long()
    neg = torch.from_numpy(b["negatives"]).long()
    out_ids = torch.cat([torch.from_numpy(b["context"]).long()[:, None], neg], 1).reshape(-1)
    _, g_u, g_v = _sgns_weights_math(app.in_state["w"][center], app.out_state["w"][out_ids],
                                     *neg.shape)
    for up, st, ids, g in ((app.in_up, app.in_state, center, g_u),
                           (app.out_up, app.out_state, out_ids, g_v)):
        total = torch.zeros_like(st["w"]).index_add_(0, ids, g)
        hit = torch.unique(ids)
        d = up.delta({k: v[hit] for k, v in st.items()}, total[hit])
        for k, v in st.items():
            v[hit] += d[k]


def pod_word2vec(rt, dev) -> dict:
    """Phase 11 (a) for word2vec at phase 10's width: ``Word2Vec(mesh=...)``
    on the world of one beside the single-device app, per_worker then
    aggregate, each from fresh tables, one step a window entry, over the
    batches train_epoch(seed=0) draws. per_worker (ids repeat: the push's
    route for repeated ids, never K3) matches the single-device app: the
    first W2V_E2E_STEPS steps' losses and the touched rows after step 1.
    aggregate: step 1's loss, and its touched rows after step 1 match a
    CPU aggregate step (``w2v_aggregate_step``). No kernel launches."""
    from parameter_server_tpu_torch.models import word2vec as w2vm
    from parameter_server_tpu_torch.ops import adagrad_kernels as ak
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.ops import quantize_kernels as qk
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    res = {"launches": {}, "times": {}}
    quiet = ProgressReporter(print_fn=lambda s: None)
    corpus = zipf_ids(np.random.default_rng(SEED + 3), W2V_ZIPF, W2V_VOCAB, W2V_TOKENS)

    def make(mesh, mode: str, device):
        return w2vm.Word2Vec(W2V_VOCAB, dim=W2V_DIM, eta=W2V_ETA, num_negatives=W2V_NEG,
                             window=W2V_WINDOW, seed=SEED, reporter=quiet, mesh=mesh,
                             push_mode=mode, device=device)

    sampler = w2vm.NegativeSampler(np.bincount(corpus, minlength=W2V_VOCAB), seed=0)
    centers, contexts = w2vm._window_pairs(corpus, W2V_WINDOW)  # make_pairs' order
    order = np.random.default_rng(0).permutation(len(centers))
    n = POD_E2E_STEPS + POD_TIMED_STEPS + POD_PROFILE_STEPS
    # train_epoch's batches; on one data shard the mesh app's draw is the same
    feed = []
    for s in range(n):
        sel = order[s * W2V_BATCH:(s + 1) * W2V_BATCH]
        feed.append({"center": centers[sel].astype(np.int32),
                     "context": contexts[sel].astype(np.int32),
                     "negatives": sampler.sample((W2V_BATCH, W2V_NEG)).astype(np.int32)})
    ids = (np.unique(feed[0]["center"]),
           np.unique(np.concatenate([feed[0]["context"][:, None], feed[0]["negatives"]], 1)))

    def step_runner(app):
        def steps(lo: int, hi: int) -> list:
            out = [app._dispatch_prepared(b, 1) for b in feed[lo:hi]]
            return [x if x.dim() == 0 else x[0] for x in out]  # a mesh step's (loss, pairs)
        return steps

    def rows(app, table: str, k: str, which) -> torch.Tensor:
        t = getattr(app, table)[k]
        return t.index_select(0, torch.from_numpy(which.astype(np.int64)).to(t.device)).cpu()

    ref_losses = None  # the single-device app's, from the per_worker pass
    for mode in ("per_worker", "aggregate"):
        # the single-device app runs beside per_worker only: aggregate's
        # step 1 is held to a CPU aggregate step, its loss to the app's
        # (the pull and the loss come before the push)
        app = make(rt.mesh, mode, dev)
        ref = make(None, "per_worker", dev) if mode == "per_worker" else None
        steps, ref_steps = step_runner(app), (step_runner(ref) if ref is not None else None)
        torch.cuda.synchronize()
        fk.reset_launches()
        ak.reset_launches()
        qk.reset_launches()
        got = [float(x) for x in steps(0, 1)]
        if ref is not None:
            ref_losses = [float(x) for x in ref_steps(0, 1)]
            want = ref
        else:
            want = make(None, "per_worker", "cpu")
            w2v_aggregate_step(want, feed[0])
        err = max(check_rows(f"pod 1x1 word2vec {mode} {table}[{k!r}] after step 1",
                             rows(app, table, k, which), rows(want, table, k, which))
                  for table, which in zip(("in_state", "out_state"), ids) for k in ("w", "n"))
        del want
        got += [float(x) for x in steps(1, POD_E2E_STEPS)]
        if ref is not None:
            ref_losses += [float(x) for x in ref_steps(1, POD_E2E_STEPS)]
        torch.cuda.synchronize()
        launches = {**fk.LAUNCHES, **ak.LAUNCHES, **qk.LAUNCHES}
        if any(launches.values()):
            raise AssertionError(f"pod 1x1 word2vec {mode} launched {launches}, want none "
                                 "(repeated ids take no fused push)")
        res["launches"][f"pod_1x1_w2v_{mode}"] = launches
        held = W2V_E2E_STEPS if mode == "per_worker" else 1
        if not np.allclose(got[:held], ref_losses[:held], rtol=E2E_RTOL, atol=0.0):
            raise AssertionError(f"pod 1x1 word2vec {mode}: losses {got} vs the "
                                 f"single-device app's {ref_losses}")
        t = pod_timings(rt, steps, ref_steps, W2V_BATCH, ())
        res["times"][f"pod_1x1_w2v_{mode}"] = t
        log(f"pod 1x1 word2vec {mode} ok at a {W2V_VOCAB}-word vocabulary: loss of steps "
            f"1-{held} (of {got} vs the single-device app's {ref_losses}) and the touched rows "
            f"after step 1 match "
            + ("the single-device app" if mode == "per_worker" else "a CPU aggregate step")
            + f" (worst row {err:.3g} of its scale); {pod_timings_text(t)}; launches "
            f"{launches}")
        del ref, app, steps, ref_steps
        torch.cuda.empty_cache()
    return res


def phase_pod(dev, gen, batches, raw, ratings, wd_batches, wd_init) -> dict:
    """Phase 11: the SPMD tier. (a) a world of one on NCCL in this process
    at the worker's, W&D's and word2vec's full width (``pod_wide_deep``,
    ``pod_word2vec``); (b) 2x2 meshes of 4 gloo ranks sharing the card,
    each run beside the same 2x2 run on the CPU (``pod_worlds``). Returns
    the launches a kernel made on each path, the shard checks' errors and
    times."""
    from parameter_server_tpu_torch.models import matrix_fac as mfm
    from parameter_server_tpu_torch.models.linear import LinearMethod, batch_to_device, train_step
    from parameter_server_tpu_torch.ops import adagrad_kernels as ak
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.ops.sparse import csr_grad, logistic_loss
    from parameter_server_tpu_torch.parallel import runtime
    from parameter_server_tpu_torch.parallel.spmd import push_generator, quantize_int8
    from parameter_server_tpu_torch.parallel.trainer import PodTrainer
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    res = {"launches": {}, "err": {}, "times": {}}
    quiet = ProgressReporter(print_fn=lambda s: None)
    cfg = worker_cfg()
    t0 = time.perf_counter()
    rt = runtime.init(None, cfg=cfg, device="cuda")  # NCCL, a world of one
    log(f"pod: NCCL world of one up in {time.perf_counter() - t0:.2f} s on {rt.mesh.device}")
    try:
        # K1 and K3 on kv-shard views, given keys - begin (slots of other shards
        # on both sides): K1 at the worker's table and a batch's keys, K3 at
        # MF's user table and a batch's users, each in 4 shards
        b0 = batches[0]
        res["err"]["ftrl_push"] = max(
            check_shard_push("ftrl_push", fk.ftrl_push, fk.ftrl_push_plain, dev, gen,
                             b0.unique_keys[1:b0.num_unique], WORKER_KEYS, 4, 1, hyper)
            for hyper in (HYPER, HYPER_L2))
        mf_keys = np.unique(ratings[0][:MF_BATCH]) + 1
        mf_rows = MF_USERS + 1
        res["err"]["adagrad_push"] = max(
            check_shard_push("adagrad_push", ak.adagrad_push, ak.adagrad_push_plain, dev, gen,
                             mf_keys, mf_rows, 4, MF_RANK, {**ADAGRAD, "l2": l2})
            for l2 in (0.0, 0.01))
        torch.cuda.empty_cache()
        log(f"pod: K1 (a {WORKER_KEYS}-row table in 4 shards) and K3 ({mf_rows} x {MF_RANK} "
            f"in 4) on shard views given keys - begin match their plain versions (max abs "
            f"err {res['err']['ftrl_push']:.3g}, {res['err']['adagrad_push']:.3g}); the rows "
            "they skip keep their bits")

        # the quantized push's rounding at the worker step's gradient (batch
        # 0 at zero weights): the JAX scale, floor(t) or floor(t) + 1, an
        # unbiased mean over seeds, independent neighbouring seeds
        d0 = batch_to_device(b0, dev)
        _, err0 = logistic_loss(torch.zeros(BATCH, device=dev), d0["labels"],
                                d0["example_mask"])
        g = csr_grad(err0, d0["values"], d0["local_ids"], d0["row_ids"],
                     num_unique=b0.unique_keys.shape[0])
        # the jitted reference: max|g| * float32(1/127) + 1e-30 (F5)
        want_scale = g.cpu().abs().max() * torch.tensor(np.float32(1 / 127)) + 1e-30
        total = torch.zeros_like(g)
        resid = []
        for seed in range(POD_QUANT_SEEDS):
            q, scale = quantize_int8(g, push_generator(seed, 0, 0, dev))
            t = g / scale
            fl = torch.floor(t)
            if scale.cpu() != want_scale or not bool(((q == fl) | (q == fl + 1)).all()):
                raise AssertionError(f"pod quantized push, seed {seed}: scale {scale.item()} "
                                     f"vs {want_scale.item()}, or q outside floor(t) + {{0, 1}}")
            total += q.float() * scale
            if seed < 2:
                resid.append((q.float() - t).ravel())
        frac = (t - fl).ravel()
        live = frac > 0
        bias = (total / POD_QUANT_SEEDS - g).abs().max().item()
        rho = torch.corrcoef(torch.stack([r[live] for r in resid]))[0, 1].item()
        if not bias < 0.5 * want_scale.item() or not abs(rho) < 4 / np.sqrt(int(live.sum())):
            raise AssertionError(f"pod quantized push: mean decode off by {bias} "
                                 f"(scale {want_scale.item()}), seeds s, s+1 correlate {rho}")
        log(f"pod quantized push ok at ({b0.unique_keys.shape[0]}, 1): scale equals the JAX "
            f"push's, every q floor(t) or floor(t) + 1, mean of {POD_QUANT_SEEDS} seeds' "
            f"decodes within {bias:.3g} of g ({bias / want_scale.item():.3f} steps), seeds "
            f"0, 1 correlate {rho:.3g} over {int(live.sum())} rounded slots")
        del d0, err0, g, total, resid, q, t, fl, frac

        # (a) PodTrainer's step on the 1x1 mesh vs the single-device worker
        touched = torch.from_numpy(np.unique(np.concatenate(
            [b.unique_keys[:b.num_unique] for b in batches[:POD_E2E_STEPS]]))).to(dev).long()
        for mode, kernel in (("per_worker", "ftrl_push"), ("aggregate", "ftrl_delta")):
            cfg.parallel.push_mode = mode
            trainer = PodTrainer(cfg, runtime=rt, reporter=quiet)
            # the host stacks the trainer's pipeline prepares; each step
            # copies its batch to the card, as the trainer's dispatch does
            feed = [trainer._prepare(b)[0] for b in batches]

            def steps(lo: int, hi: int) -> list:
                outs = []
                for i in range(lo, hi):
                    trainer.state, o = trainer.step_fn(
                        trainer.state, rt.globalize_batch(feed[i]), i)
                    outs.append(o["loss_sum"])
                return outs

            torch.cuda.synchronize()
            fk.reset_launches()
            ak.reset_launches()
            losses = [float(x) for x in steps(0, POD_E2E_STEPS)]
            torch.cuda.synchronize()
            launches = {**fk.LAUNCHES, **ak.LAUNCHES}
            if launches[kernel] < POD_E2E_STEPS:
                raise AssertionError(f"pod 1x1 {mode}: {kernel} launched {launches[kernel]} "
                                     f"times in {POD_E2E_STEPS} steps")
            res["launches"][f"pod_1x1_{mode}"] = launches
            ref = LinearMethod(cfg, reporter=quiet, device="cuda")
            for i in range(POD_E2E_STEPS):
                _, r = train_step(ref.updater, ref.store.state, batch_to_device(batches[i], dev))
                if not np.isclose(losses[i], float(r["loss_sum"]), rtol=E2E_RTOL, atol=0.0):
                    raise AssertionError(f"pod 1x1 {mode} step {i}: loss_sum {losses[i]} vs "
                                         f"the single-device worker's {float(r['loss_sum'])}")
            err = max(check_e2e(f"pod 1x1 {mode} {k}", trainer.state[k][touched],
                                ref.store.state[k][touched]) for k in ("z", "n"))

            def ref_steps(lo: int, hi: int) -> None:
                """The single-device worker's steps, fed and timed as ``steps``."""
                for i in range(lo, hi):
                    train_step(ref.updater, ref.store.state, batch_to_device(batches[i], dev))

            t = pod_timings(rt, steps, ref_steps, BATCH, (kernel,))
            del ref
            if mode == "per_worker":
                # K1's bound at the step's push: every slot's index and
                # gradient read once, each distinct row's z, n read and
                # written once (~1 M pad slots share row 0)
                lo = POD_E2E_STEPS + POD_TIMED_STEPS
                prof = batches[lo:lo + POD_PROFILE_STEPS]
                slots = float(np.mean([b.unique_keys.shape[0] for b in prof]))
                distinct = float(np.mean([b.num_unique for b in prof]))
                t["k1_slots"], t["k1_rows"] = slots, distinct
                t["k1_bound_ms"], t["k1_bound_by"] = bound(8 * slots + 16 * distinct,
                                                           FTRL_FLOPS * slots)
            res["times"][f"pod_1x1_{mode}"] = t
            log(f"pod 1x1 {mode} ok: losses of steps 1-{POD_E2E_STEPS} and the touched rows "
                f"match the single-device worker (worst {err:.3g} of scale); "
                f"{pod_timings_text(t)} (traffic.py's wire estimate on a 1x1 mesh: "
                f"{trainer.est_step_traffic.total_bytes}); launches {launches}"
                + (f"; K1's bound at {t['k1_slots']:.0f} slots on {t['k1_rows']:.1f} rows "
                   f"{t['k1_bound_ms']:.5f} ms ({t['k1_bound_by']})"
                   if mode == "per_worker" else ""))
            del trainer, feed
            torch.cuda.empty_cache()
        k2_bound = bound(20 * WORKER_KEYS, FTRL_FLOPS * WORKER_KEYS)
        res["times"]["k2_shard"] = {"ms": res["times"]["pod_1x1_aggregate"]["ftrl_delta_ms"],
                                    "rows": WORKER_KEYS, "bound_ms": k2_bound[0],
                                    "bound_by": k2_bound[1]}
        log(f"pod: K2 over the whole {WORKER_KEYS}-row shard {res['times']['k2_shard']['ms']:.5f}"
            f" ms a launch, bound {k2_bound[0]:.5f} ms ({k2_bound[1]})")
        for part in (pod_wide_deep(rt, dev, wd_batches, wd_init), pod_word2vec(rt, dev)):
            for k in ("launches", "times"):
                res[k].update(part[k])
    finally:
        rt.shutdown()

    pod_worlds(raw, ratings, res)
    return res


def pod_worlds(raw, ratings, res: dict) -> None:
    """Phase 11 (b): 2x2 worlds of `cli train` ranks, on the card (gloo,
    sharing it) and on the CPU, side by side; adds each run's launches and
    times to ``res``."""
    from parameter_server_tpu_torch.data.synthetic import make_sparse_logistic, write_libsvm

    root = Path(__file__).resolve().parent
    labels, keys, vals = raw
    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = Path(tmp_s)
        t0 = time.perf_counter()
        files = []
        for i in range(2 * POD_FILES_PER_SHARD):  # files[d::2] feed data row d
            files.append(tmp / f"part-{i}.svm")
            sel = slice(i * BATCH, (i + 1) * BATCH)
            write_libsvm(files[-1], labels[sel], keys[sel], vals[sel])
        users, items, stars = (a[:2 * MF_BATCH] for a in ratings)
        (tmp / "ratings.txt").write_text("".join(
            f"{u} {v} {r:.6g}\n" for u, v, r in zip(users, items, stars)))
        # W&D: phase 9's kind of rows; word2vec: phase 10's Zipf ids
        wd_rows = make_sparse_logistic(2 * POD_E2E_STEPS * WD_BATCH, WD_FEATURES,
                                       nnz_per_example=WD_FIELDS, noise=0.4, seed=SEED + 2)[:3]
        for i in range(2 * POD_E2E_STEPS):
            sel = slice(i * WD_BATCH, (i + 1) * WD_BATCH)
            write_libsvm(tmp / f"wd-{i}.svm", *(a[sel] for a in wd_rows))
        tokens = zipf_ids(np.random.default_rng(SEED + 3), W2V_ZIPF, POD_W2V_VOCAB,
                          2 * POD_W2V_TOKENS)
        for d in range(2):
            (tmp / f"corpus-{d}.txt").write_text(
                " ".join(map(str, tokens[d * POD_W2V_TOKENS:(d + 1) * POD_W2V_TOKENS])))
        log(f"pod: wrote {len(files)} libsvm files of {BATCH} rows, {2 * MF_BATCH} ratings, "
            f"{2 * POD_E2E_STEPS} W&D libsvm files of {WD_BATCH} rows and 2 corpus files of "
            f"{POD_W2V_TOKENS} tokens in {time.perf_counter() - t0:.2f} s")
        # a wave's worlds at once: most of a world's time is its ranks'
        # start-up, which overlaps
        runs = [(app, mode, ("cuda",) if mode == "quantized" else ("cuda", "cpu"))
                for app, mode in POD_RUNS]
        specs = {}
        for app, mode, devices in runs:
            app_file = tmp / f"{app}-{mode}.json"
            app_file.write_text(json.dumps(pod_conf(app, mode, files, tmp)))
            for device in devices:
                out = tmp / f"{app}-{mode}-{device}"
                extra = (["--model_out", str(out) + (".npy" if app == "word2vec" else ".npz")]
                         if app != "linear_method"
                         else ["--ckpt_dir", str(out)] if mode != "quantized" else [])
                if mode == "quantized":
                    extra.append("--audit_quantized")
                specs[out.name] = (app_file, device, extra)
        got = {}
        for wave in POD_WAVES:
            part = {tag: spec for tag, spec in specs.items() if tag.split("-")[0] in wave}
            if not part:
                continue
            t0 = time.perf_counter()
            worlds = start_worlds(root, tmp, part, POD_TIMEOUT_S)
            t_up = time.perf_counter() - t0
            got.update(wait_worlds(worlds, POD_TIMEOUT_S))
            log(f"pod: {len(worlds)} worlds of {POD_RANKS} ranks ({', '.join(wave)}), run at "
                f"once, took {time.perf_counter() - t0:.1f} s ({t_up:.1f} s until every rank 0 "
                f"listened; each world's last rank exited after "
                f"{ {tag: round(got[tag]['seconds'], 1) for tag in worlds} } s more)")
        for app, mode, _ in runs:
            check_pod_run(app, mode, got, tmp, res)


def pod_conf(app: str, mode: str, files: list, tmp: Path) -> dict:
    """Phase 11 (b)'s config of one 2x2 run."""
    if app == "linear_method":
        conf = {"data": {"files": [str(f) for f in files], "num_keys": WORKER_KEYS,
                         "max_nnz_per_example": 4 * NNZ_PER},
                "solver": {"minibatch": BATCH},
                "lr": {"alpha": HYPER["alpha"], "beta": HYPER["beta"]},
                "penalty": {"lambda_l1": HYPER["l1"], "lambda_l2": HYPER["l2"]}}
    elif app == "matrix_fac":
        conf = {"app": "matrix_fac", "seed": SEED,
                "data": {"files": [str(tmp / "ratings.txt")]},
                "solver": {"epochs": POD_E2E_STEPS},
                "mf": {"num_users": MF_USERS, "num_items": MF_ITEMS, "rank": MF_RANK,
                       "eta": MF_ETA, "l2": MF_L2, "batch_size": MF_BATCH}}
    elif app == "wide_deep":
        conf = {"app": "wide_deep", "seed": SEED,
                "data": {"files": [str(tmp / f"wd-{i}.svm") for i in range(2 * POD_E2E_STEPS)],
                         "num_keys": POD_WD_KEYS, "max_nnz_per_example": 4 * WD_FIELDS},
                "solver": {"minibatch": WD_BATCH},
                "wd": {"emb_dim": WD_EMB_DIM, "hidden": WD_HIDDEN, "emb_eta": WD_EMB_ETA,
                       "mlp_lr": WD_MLP_LR},
                "lr": {"alpha": WD_FTRL["alpha"], "beta": WD_FTRL["beta"]},
                "penalty": {"lambda_l1": WD_FTRL["lambda_l1"],
                            "lambda_l2": WD_FTRL["lambda_l2"]}}
    else:
        conf = {"app": "word2vec", "seed": SEED,
                "data": {"files": [str(tmp / f"corpus-{d}.txt") for d in range(2)]},
                "w2v": {"vocab_size": POD_W2V_VOCAB, "dim": W2V_DIM, "window": W2V_WINDOW,
                        "negatives": W2V_NEG, "eta": POD_W2V_ETA, "batch_size": W2V_BATCH}}
    conf["parallel"] = {"data_shards": 2, "kv_shards": 2, "push_mode": mode}
    return conf


def check_pod_run(app: str, mode: str, got: dict, tmp: Path, res: dict) -> None:
    """Phase 11 (b)'s checks of one 2x2 run (its card world and, but for the
    quantized runs, its CPU world; ``got`` holds every world's result);
    adds its launches and times to ``res``."""
    from parameter_server_tpu_torch.models.wide_deep import normal_table

    tag = f"{app}-{mode}"
    card = got[f"{tag}-cuda"]
    counts = [r["launches"] for r in card["results"]]
    for kernel in POD_KERNELS[(app, mode)]:
        if not all(c[kernel] > 0 for c in counts):
            raise AssertionError(f"pod 2x2 {tag} on the card: {kernel} launches by rank "
                                 f"{[c[kernel] for c in counts]}")
    if app == "word2vec" and any(any(c.values()) for c in counts):
        raise AssertionError(f"pod 2x2 {tag} on the card: launches {counts}, want none")
    res["launches"][f"pod_2x2_{tag}"] = {
        k: sum(c[k] for c in counts) for k in counts[0]}
    objv = [r["objv"] for r in card["rows"]]
    if app != "word2vec" and len(objv) < POD_E2E_STEPS:
        raise AssertionError(f"pod 2x2 {tag}: {len(objv)} progress rows")
    msg = ""
    if mode == "quantized":
        # each rank held every push's gathered gradient to the rounding
        # bounds (cli train --audit_quantized)
        audits = [r["quant_audit"] for r in card["results"]]
        tables = 2 if app == "wide_deep" else 1
        if not all(a["pushes"] >= tables * POD_E2E_STEPS and a["off_grid"] == 0
                   and a["scale_mismatch"] == 0 for a in audits):
            raise AssertionError(f"pod 2x2 {tag}: rounding audits by rank {audits}")
        if app == "linear_method":
            if not objv[POD_E2E_STEPS - 1] < objv[0]:
                raise AssertionError(f"pod 2x2 {tag}: the loss did not fall: {objv}")
            msg = f"; the loss fell ({objv[0]} -> {objv[POD_E2E_STEPS - 1]})"
        else:
            pw = [r["objv"] for r in got[f"{app}-per_worker-cuda"]["rows"]]
            if not (np.isclose(objv[0], pw[0], rtol=E2E_RTOL + PRINT_RTOL, atol=0.0)
                    and np.allclose(objv[1:POD_E2E_STEPS], pw[1:POD_E2E_STEPS],
                                    rtol=POD_QUANT_RTOL, atol=0.0)
                    and objv[POD_E2E_STEPS - 1] < objv[0]):
                raise AssertionError(f"pod 2x2 {tag}: objv {objv} vs per_worker's {pw}, or "
                                     "the loss did not fall")
            msg = (f"; objv {objv[:POD_E2E_STEPS]} tracks per_worker's {pw[:POD_E2E_STEPS]}"
                   " and falls")
        msg += (f"; every rank's pushes kept the JAX scale and floor(t) + {{0, 1}} "
                f"({audits[0]['pushes']} pushes a rank)")
    else:
        cpu_world = got[f"{tag}-cpu"]
        if app == "word2vec":
            losses = [w["results"][0]["mean_loss"] for w in (card, cpu_world)]
            if not np.isclose(*losses, rtol=E2E_RTOL, atol=0.0):
                raise AssertionError(f"pod 2x2 {tag}: mean loss card vs CPU {losses}")
            msg = f"; mean loss {losses[0]} matches the CPU's {losses[1]}"
        else:
            cpu = [r["objv"] for r in cpu_world["rows"]]
            # the table prints 5 significant digits: a unit of the last
            # digit on top of the tolerance
            if not np.allclose(objv[:POD_E2E_STEPS], cpu[:POD_E2E_STEPS],
                               rtol=E2E_RTOL + PRINT_RTOL, atol=0.0):
                raise AssertionError(f"pod 2x2 {tag}: card objv {objv} vs CPU {cpu}")
            msg = f"; first {POD_E2E_STEPS} steps' objv {objv[:POD_E2E_STEPS]} match the CPU's"
        if app == "matrix_fac":
            a = np.load(tmp / f"{tag}-cuda.npz")
            c = np.load(tmp / f"{tag}-cpu.npz")
            worst = 0.0
            for k in ("user_factors", "item_factors"):
                err = np.abs(a[k] - c[k]).max()
                if not np.allclose(a[k], c[k], rtol=E2E_RTOL, atol=ATOL):
                    raise AssertionError(f"pod 2x2 {tag} {k}: card vs CPU {err}")
                worst = max(worst, float(err))
            msg += f", and so do the final factors (max abs err {worst:.3g})"
        elif app == "wide_deep":
            with np.load(tmp / f"{tag}-cuda.npz") as a, np.load(tmp / f"{tag}-cpu.npz") as c:
                worst = max(check_e2e(f"pod 2x2 {tag} {k}", torch.from_numpy(a[k]),
                                      torch.from_numpy(c[k])) for k in c.files if k != "emb_w")
                init = normal_table(np.random.default_rng(SEED), POD_WD_KEYS, WD_EMB_DIM,
                                    0.05, "cpu")
                init[0] = 0.0
                emb = check_moved(f"pod 2x2 {tag} emb_w", torch.from_numpy(a["emb_w"]),
                                  torch.from_numpy(c["emb_w"]), init, WD_EMB_ETA)
            msg += (f", and so does the dump (wide weights and MLP: worst {worst:.3g} of scale; "
                    f"embeddings: {emb})")
        elif app == "word2vec":
            init = torch.from_numpy(np.random.default_rng(SEED).uniform(
                -0.5 / W2V_DIM, 0.5 / W2V_DIM, size=(POD_W2V_VOCAB, W2V_DIM)).astype(np.float32))
            emb = check_moved(f"pod 2x2 {tag} embeddings",
                              torch.from_numpy(np.load(tmp / f"{tag}-cuda.npy")),
                              torch.from_numpy(np.load(tmp / f"{tag}-cpu.npy")), init,
                              POD_W2V_ETA)
            msg += f", and so do the embeddings ({emb})"
        else:
            from parameter_server_tpu_torch.utils.checkpoint import load_checkpoint

            a, _ = load_checkpoint(tmp / f"{tag}-cuda")
            c, _ = load_checkpoint(tmp / f"{tag}-cpu")
            rows_t = np.nonzero((a["z"] != 0) | (a["n"] != 0) | (c["z"] != 0)
                                | (c["n"] != 0))[0]
            worst = max(check_e2e(f"pod 2x2 {tag} {k}", torch.from_numpy(a[k][rows_t]),
                                  torch.from_numpy(c[k][rows_t])) for k in ("z", "n"))
            msg += (f", and so do the final z, n on the {len(rows_t)} touched rows "
                    f"(worst {worst:.3g} of scale)")
    rate = [r.get("ex_per_sec") for r in card["rows"][:POD_E2E_STEPS]]
    payload = card["results"][0]["payload_bytes"]
    est = card["results"][0].get("est_collective_bytes")  # the last (one-step) row
    res["times"][f"pod_2x2_{tag}"] = {"seconds": card["seconds"], "ex_per_sec": rate,
                                      "rank0_payload_bytes": payload,
                                      "est_collective_bytes_a_step": est}
    worlds = "4 gloo ranks on the card" + ("" if mode == "quantized" else ", 4 on the CPU")
    log(f"pod 2x2 {tag} ok: its worlds ({worlds}){msg}; card "
        f"ex/s by step {rate}; rank 0 handed its "
        f"collectives {payload} bytes in the run (traffic.py's estimate {est} a step); "
        f"launches by rank {counts}")


# ---------------------------------------------------------------------------
# phase 12: the wire tier (shard servers, handles, both backends)
# ---------------------------------------------------------------------------


def latency_ms(lat_s: list) -> dict:
    a = np.asarray(lat_s) * 1e3
    return {"p50_ms": float(np.percentile(a, 50)), "p99_ms": float(np.percentile(a, 99)),
            "n": len(a)}


class IndexAudit:
    """While armed, wraps the store's K1 and K3 wrappers (the names
    ``kv.store.push`` calls) to keep a device copy of each launch's index;
    ``check`` then holds every one to its contract: no row twice."""

    NAMES = ("ftrl_push", "adagrad_push")

    def __init__(self):
        self.idx = {n: [] for n in self.NAMES}

    @contextlib.contextmanager
    def armed(self):
        from parameter_server_tpu_torch.kv import store as kv_store

        saved = {n: getattr(kv_store, n) for n in self.NAMES}

        def wrap(name, fn):
            def run(a, b, idx, grad, **kw):
                self.idx[name].append(idx.clone())
                return fn(a, b, idx, grad, **kw)
            return run

        for n, fn in saved.items():
            setattr(kv_store, n, wrap(n, fn))
        try:
            yield self
        finally:
            for n, fn in saved.items():
                setattr(kv_store, n, fn)

    def check(self, name: str) -> int:
        """Applies seen since the last check, each with unique rows."""
        for i in self.idx[name]:
            if torch.unique(i).numel() != i.numel():
                raise AssertionError(f"a {name} launch of the server apply repeats a row")
        n = len(self.idx[name])
        self.idx[name].clear()
        return n


def cpu_replay(make_updater, pushes, vdim: int):
    """``pushes`` (global keys, grads) one after another on the CPU, into a
    table of their union (row 0 the pad row). Returns (union, its weights)."""
    from parameter_server_tpu_torch.kv.store import KVStore

    union = np.unique(np.concatenate([k for k, _ in pushes]))
    store = KVStore(make_updater(), len(union) + 1, vdim=vdim, device="cpu")
    for k, g in pushes:
        store.push(np.searchsorted(union, k) + 1, g)
    return union, store.pull(np.arange(1, len(union) + 1))


def server_counts(be, name: str) -> int:
    return sum(srv.counters[name] for srv in be._servers)


def wire_deterministic(name, be, pushes, make_updater, vdim: int, kernel: str, counter,
                       audit: IndexAudit, profile_first: int = 0) -> dict:
    """``pushes`` through ``be`` one at a time (each acked before the next,
    so each server applies it alone), the first ``profile_first`` under the
    profiler; then a pull of every touched key against the CPU replay."""
    torch.cuda.synchronize()
    for k in counter:
        counter[k] = 0
    out: dict = {}
    with audit.armed():
        if profile_first:
            def first():
                for k, g in pushes[:profile_first]:
                    be.push(k, g)
            wall_ms, busy_ms, rows = profile(first)
            out["profile"] = {"pushes": profile_first, "wall_ms": wall_ms,
                              "busy_ms": busy_ms, "idle_share": 1 - busy_ms / wall_ms,
                              "top": [(k[:60], t) for k, t, _ in rows[:6]]}
            log(f"wire {name}: profile of the first {profile_first} pushes: wall "
                f"{wall_ms:.3f} ms, device busy {busy_ms:.3f} ms (idle share "
                f"{1 - busy_ms / wall_ms:.3f}); top device time: {out['profile']['top']}")
        lat = []
        t0 = time.perf_counter()
        for k, g in pushes[profile_first:]:
            t1 = time.perf_counter()
            be.push(k, g)
            lat.append(time.perf_counter() - t1)
        dt = time.perf_counter() - t0
        be.flush()
    launches = counter[kernel]
    batches = server_counts(be, "apply_batches")
    audited = audit.check(kernel)
    if not (launches == batches == audited == WIRE_SERVERS * len(pushes)):
        raise AssertionError(f"wire {name}: {kernel} launched {launches} times, the servers "
                             f"applied {batches} batches ({audited} audited), want "
                             f"{WIRE_SERVERS} x {len(pushes)}")
    union, want = cpu_replay(make_updater, pushes, vdim)
    got = torch.from_numpy(be.pull(union))
    err = check_close(f"wire {name} pull", got, want)
    timed = pushes[profile_first:]
    out.update({
        "pushes": len(pushes), "timed_pushes": len(timed), "seconds": dt,
        "pushes_per_s": len(timed) / dt,
        "rows_per_s": sum(len(k) for k, _ in timed) / dt,
        "latency": latency_ms(lat), "launches": launches, "apply_batches": batches,
        "max_abs_err": err, "keys": len(union),
    })
    log(f"wire {name} ok: {len(pushes)} pushes one at a time through {WIRE_SERVERS} card "
        f"servers; {kernel} launched {launches} times = apply batches, every index unique; "
        f"pull of {len(union)} keys matches the CPU replay (max abs err {err:.3g}); "
        f"{out['pushes_per_s']:.1f} pushes/s, {out['rows_per_s']:.4g} rows/s, latency "
        f"p50 {out['latency']['p50_ms']:.3f} / p99 {out['latency']['p99_ms']:.3f} ms "
        f"over {len(timed)} pushes")
    return out


def wire_concurrent(be0, ranges, rounds, cfg) -> dict:
    """8 handles (one SocketBackend each, sharing be0's servers) push
    pipelined in threads; the SGD table must equal -eta times the sum of
    every gradient (float64 reference), every push acked, some coalesced."""
    import threading

    from parameter_server_tpu_torch.parallel.backend import SocketBackend
    from parameter_server_tpu_torch.parallel.multislice import ServerHandle

    workers = len(rounds[0][0])
    rng = np.random.default_rng(SEED + 12)
    plan = [[(rounds[j % len(rounds)][0][w],
              rng.normal(size=len(rounds[j % len(rounds)][0][w])).astype(np.float32))
             for j in range(WIRE_CONC_PUSHES)] for w in range(workers)]
    backends = [be0] + [
        SocketBackend([ServerHandle(s.address, i, w, cfg, range_size=r.size, device="cuda")
                       for i, (s, r) in enumerate(zip(be0._servers, ranges))],
                      ranges, SERVER_KEYS)
        for w in range(1, workers)]
    lat: list = []
    lat_lock = threading.Lock()
    errors: list = []

    def run(w: int) -> None:
        try:
            futs = []
            for k, g in plan[w]:
                t_issue = time.perf_counter()
                f = backends[w].push_async(k, g)

                def done(_f, t=t_issue):
                    with lat_lock:
                        lat.append(time.perf_counter() - t)
                f.add_done_callback(done)
                futs.append(f)
            for f in futs:
                f.result(timeout=120)
        except BaseException as e:  # noqa: BLE001 — reported by the main thread
            errors.append(e)

    try:
        threads = [threading.Thread(target=run, args=(w,)) for w in range(workers)]
        t0 = time.perf_counter()
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        be0.flush()
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    finally:
        for b in backends[1:]:
            b.close()
    if errors:
        raise errors[0]
    pushes = [p for w in plan for p in w]
    union = np.unique(np.concatenate([k for k, _ in pushes]))
    total = np.zeros(len(union))
    for k, g in pushes:
        total[np.searchsorted(union, k)] += g
    got = be0.pull(union).ravel().astype(np.float64)
    want = -WIRE_SGD_ETA * total
    err = np.abs(got - want)
    scale = np.abs(want).max()
    if not bool((err <= RTOL * (np.abs(want) + scale)).all()):
        raise AssertionError(f"wire concurrent: table vs -eta x sum of gradients max abs err "
                             f"{err.max()} (scale {scale})")
    acked = server_counts(be0, "pushes")
    coalesced = server_counts(be0, "push_coalesced")
    if len(lat) != len(pushes) or acked != WIRE_SERVERS * len(pushes) or not coalesced > 0:
        raise AssertionError(f"wire concurrent: {len(lat)} of {len(pushes)} pushes acked, "
                             f"servers applied {acked}, coalesced {coalesced}")
    out = {"pushes": len(pushes), "seconds": dt, "pushes_per_s": len(pushes) / dt,
           "rows_per_s": sum(len(k) for k, _ in pushes) / dt, "latency": latency_ms(lat),
           "apply_batches": server_counts(be0, "apply_batches"), "push_coalesced": coalesced,
           "max_abs_err": float(err.max())}
    log(f"wire concurrent ok: {workers} handles x {WIRE_CONC_PUSHES} pipelined pushes "
        f"(window {cfg.wire.window}) into an SGD table: all acked, {coalesced} coalesced into "
        f"{out['apply_batches']} apply batches; table = -eta x sum of gradients (max abs err "
        f"{err.max():.3g}); {out['pushes_per_s']:.1f} pushes/s, {out['rows_per_s']:.4g} rows/s, "
        f"latency p50 {out['latency']['p50_ms']:.3f} / p99 {out['latency']['p99_ms']:.3f} ms")
    return out


def wire_fixed_point(be, pushes, ranges, dev, qk, ak) -> dict:
    """The embedding server's pushes with ``[filter] fixing_float_bytes`` 1:
    each handle encodes its segment on the card (K4), each server decodes;
    every decoded payload within one step (+ ROUNDING_ULPS) of its
    gradient, and the table equal to a CPU replay of what the servers
    decoded."""
    from parameter_server_tpu_torch.kv.updaters import Adagrad

    decoded: list = [[] for _ in be._servers]
    for s, srv in enumerate(be._servers):
        orig = srv._decode_grad

        def record(h, arrays, s=s, orig=orig):
            g = orig(h, arrays)
            decoded[s].append(np.array(g, dtype=np.float32))
            return g
        srv._decode_grad = record
    lat = []
    torch.cuda.synchronize()
    qk.reset_launches()
    ak.reset_launches()
    t0 = time.perf_counter()
    for k, g in pushes:
        t1 = time.perf_counter()
        be.push(k, g)
        lat.append(time.perf_counter() - t1)
    dt = time.perf_counter() - t0
    torch.cuda.synchronize()
    launches = {**qk.LAUNCHES, **ak.LAUNCHES}
    want = {"quantize_stochastic": WIRE_SERVERS * len(pushes),
            "adagrad_push": WIRE_SERVERS * len(pushes)}
    if launches != want:
        raise AssertionError(f"wire fixed point launched {launches}, want {want}")
    worst = 0.0
    replay = []
    for s, r in enumerate(ranges):
        if len(decoded[s]) != len(pushes):
            raise AssertionError(f"wire fixed point: server {s} decoded {len(decoded[s])} "
                                 f"pushes of {len(pushes)}")
        for (k, g), dec in zip(pushes, decoded[s]):
            sel = (k >= r.begin) & (k < r.end)
            g_seg = torch.from_numpy(g[sel]).to(dev)
            lo, hi = torch.aminmax(g_seg)
            bound = decode_bound((hi - lo) / 255, g_seg)
            d = torch.from_numpy(dec.reshape(g_seg.shape)).to(dev)
            worst = max(worst, ((d - g_seg).abs().max() / bound).item())
            replay.append((k[sel], dec.reshape(g_seg.shape)))
    if not worst <= 1.0:
        raise AssertionError(f"wire fixed point: a decoded payload is {worst} times its "
                             f"bound off its gradient")
    union, want = cpu_replay(lambda: Adagrad(eta=ADAGRAD["eta"], eps=ADAGRAD["eps"]),
                             replay, EMB_VDIM)
    err = check_close("wire fixed point pull", torch.from_numpy(be.pull(union)), want)
    out = {"pushes": len(pushes), "seconds": dt, "pushes_per_s": len(pushes) / dt,
           "latency": latency_ms(lat), "worst_decode": worst, "max_abs_err": err,
           "launches": launches}
    log(f"wire fixed point ok: {len(pushes)} pushes encoded on the card by each handle (K4), "
        f"decoded by the servers, worst decode {worst:.4f} of its bound; pull of {len(union)} "
        f"keys matches a CPU replay of the decoded payloads (max abs err {err:.3g}); "
        f"{out['pushes_per_s']:.1f} pushes/s, latency p50 {out['latency']['p50_ms']:.3f} / "
        f"p99 {out['latency']['p99_ms']:.3f} ms")
    return out


def zipf_rows() -> tuple[np.ndarray, np.ndarray]:
    """Phase 12 (c)'s examples before hashing: STEPS x BATCH rows of
    NNZ_PER ids, Zipf (TL_ZIPF) over FEATURES, labels from a dense logistic
    model (the JAX ``cli backend`` workload's law on Zipf ids)."""
    rng = np.random.default_rng(SEED + 13)
    w_true = rng.normal(size=FEATURES)
    ids = np.minimum(rng.zipf(TL_ZIPF, size=(STEPS * BATCH, NNZ_PER)) - 1, FEATURES - 1)
    logits = w_true[ids].sum(axis=1) / np.sqrt(NNZ_PER)
    y = (rng.random(len(ids)) < 1 / (1 + np.exp(-logits))).astype(np.float64)
    return ids, y


def wire_workload():
    """(c)'s examples (``zipf_rows``), hashed into the table as the batch
    builder hashes them (spread over both servers' ranges)."""
    from parameter_server_tpu_torch.utils.hashing import hash_keys

    ids, y = zipf_rows()
    # train_linear adds 1 to each id (row 0 is the pad row): ids in [0, K - 2]
    kb = hash_keys(ids.astype(np.uint64).ravel(), WORKER_KEYS - 1).reshape(ids.shape)
    return kb.astype(np.int64) - 1, y


def wire_train_linear(fk) -> tuple[dict, dict]:
    """train_linear at the worker's width through the socket backend (2
    card servers), the mesh backend on a world of one over NCCL (quant off
    and int8), and the socket backend on the CPU (the reference)."""
    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.parallel.backend import local_socket_backend, train_linear
    from parameter_server_tpu_torch.parallel.meshbackend import MeshBackend
    from parameter_server_tpu_torch.utils.metrics import wire_counters

    kb, y = wire_workload()

    def make():
        return Ftrl(**TL_FTRL)

    arms, res, launches = {}, {}, {}
    for arm in ("socket_cpu", "socket", "mesh", "mesh_int8"):
        if arm.startswith("socket"):
            be = local_socket_backend(make, WORKER_KEYS, WIRE_SERVERS,
                                      device="cpu" if arm == "socket_cpu" else "cuda")
        else:
            be = MeshBackend(make(), WORKER_KEYS, quant="int8" if arm == "mesh_int8" else "off",
                             device="cuda")
        try:
            pay0 = (wire_counters.get("wire_push_payload_bytes")
                    + wire_counters.get("mesh_push_payload_bytes"))
            # warm-up: the connections, and the world's first collective,
            # which sets up its NCCL communicator
            be.pull(np.ones(1, np.int64))
            torch.cuda.synchronize()
            fk.reset_launches()
            t0 = time.perf_counter()
            out = train_linear(be, kb, y, BATCH)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches[arm] = fk.LAUNCHES["ftrl_push"]
            payload = (wire_counters.get("wire_push_payload_bytes")
                       + wire_counters.get("mesh_push_payload_bytes") - pay0)
        finally:
            be.close()
        res[arm] = out
        arms[arm] = {"ex_per_s": out["examples"] / dt, "seconds": dt, "auc": out["auc"],
                     "push_payload_bytes": payload, "launches": launches[arm]}
        log(f"wire train_linear {arm}: {out['examples']} examples in {dt:.3f} s "
            f"({arms[arm]['ex_per_s']:.1f} ex/s), AUC {out['auc']:.6f}, push payload "
            f"{payload} bytes, ftrl_push launches {launches[arm]}")
    for arm, want in (("socket", STEPS * WIRE_SERVERS), ("mesh", STEPS), ("mesh_int8", STEPS)):
        if launches[arm] != want:
            raise AssertionError(f"wire train_linear {arm}: ftrl_push launched "
                                 f"{launches[arm]} times, want {want}")
    p_sock, p_mesh = res["socket"]["probs"], res["mesh"]["probs"]
    diff = float(np.abs(p_sock - p_mesh).max())
    if diff > 1e-6:
        raise AssertionError(f"wire train_linear: socket vs mesh probabilities differ by {diff}")
    errs = {arm: check_e2e(f"wire train_linear {arm} vs the CPU socket run",
                           torch.from_numpy(res[arm]["probs"]),
                           torch.from_numpy(res["socket_cpu"]["probs"]))
            for arm in ("socket", "mesh")}
    d_auc = abs(res["mesh_int8"]["auc"] - res["mesh"]["auc"])
    if not d_auc <= TL_AUC_BOUND:
        raise AssertionError(f"wire train_linear: int8 AUC {res['mesh_int8']['auc']} vs f32 "
                             f"{res['mesh']['auc']}")
    log(f"wire train_linear ok: socket and mesh probabilities {'equal' if diff == 0 else diff}; "
        f"both match the CPU socket run (relative errs {errs}); int8 AUC within {d_auc:.3g} "
        f"of f32")
    return arms, {"socket_vs_mesh_max_diff": diff, "vs_cpu": errs, "int8_auc_delta": d_auc}


def phase_wire(dev, rounds, emb_rounds) -> dict:
    """Phase 12: (a) the FTRL server over the wire, deterministic and
    concurrent; (b) the embedding server over the wire, f32 and fixed
    point; (c) train_linear through both backends."""
    from parameter_server_tpu_torch.kv.updaters import Adagrad, Ftrl, Sgd
    from parameter_server_tpu_torch.ops import adagrad_kernels as ak
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.ops import quantize_kernels as qk
    from parameter_server_tpu_torch.parallel.backend import local_socket_backend
    from parameter_server_tpu_torch.utils.config import PSConfig

    t_phase = time.perf_counter()
    cfg = PSConfig()
    audit = IndexAudit()
    out: dict = {"launches": {}}

    # (a) FTRL at phase 5's width: 2 servers of 2^26 rows, one push at a time
    def ftrl():
        return Ftrl(alpha=HYPER["alpha"], beta=HYPER["beta"], lambda_l1=HYPER["l1"],
                    lambda_l2=HYPER["l2"])

    pushes = [(k, g) for idx_list, grad_list in rounds for k, g in zip(idx_list, grad_list)]
    be = local_socket_backend(ftrl, SERVER_KEYS, WIRE_SERVERS, cfg=cfg, device="cuda")
    try:
        out["ftrl"] = wire_deterministic("FTRL server", be, pushes, ftrl, 1, "ftrl_push",
                                         fk.LAUNCHES, audit, profile_first=SERVER_WORKERS)
    finally:
        be.close()
    out["launches"]["wire_ftrl_server"] = out["ftrl"]["launches"]
    del be
    torch.cuda.empty_cache()
    be = local_socket_backend(lambda: Sgd(eta=WIRE_SGD_ETA), SERVER_KEYS, WIRE_SERVERS,
                              cfg=cfg, device="cuda")
    try:
        out["concurrent"] = wire_concurrent(be, be.ranges, rounds, cfg)
    finally:
        be.close()
    del be
    torch.cuda.empty_cache()

    # (b) the embedding server: phase 7's table and pushes, f32 then fixed point
    def adagrad():
        return Adagrad(eta=ADAGRAD["eta"], eps=ADAGRAD["eps"])

    emb_pushes = [(k, g) for idx_list, grad_list in emb_rounds
                  for k, g in zip(idx_list, grad_list)]
    be = local_socket_backend(adagrad, EMB_KEYS, WIRE_SERVERS, cfg=cfg, vdim=EMB_VDIM,
                              device="cuda")
    try:
        out["embedding"] = wire_deterministic("embedding server", be, emb_pushes, adagrad,
                                              EMB_VDIM, "adagrad_push", ak.LAUNCHES, audit)
    finally:
        be.close()
    out["launches"]["wire_embedding_server"] = out["embedding"]["launches"]
    fcfg = PSConfig()
    fcfg.filter.fixing_float_bytes = 1
    be = local_socket_backend(adagrad, EMB_KEYS, WIRE_SERVERS, cfg=fcfg, vdim=EMB_VDIM,
                              device="cuda")
    try:
        out["fixed_point"] = wire_fixed_point(be, emb_pushes, be.ranges, dev, qk, ak)
    finally:
        be.close()
    fp = out["fixed_point"]["launches"]
    out["launches"]["wire_fixed_point_handles"] = fp["quantize_stochastic"]
    out["launches"]["wire_embedding_server_fixed_point"] = fp["adagrad_push"]
    del be
    torch.cuda.empty_cache()

    # (c) train_linear through both backends at the worker's width
    out["train_linear"], out["train_linear_checks"] = wire_train_linear(fk)
    for arm in ("socket", "mesh", "mesh_int8"):
        out["launches"][f"wire_train_linear_{arm}"] = out["train_linear"][arm]["launches"]
    out["seconds"] = time.perf_counter() - t_phase
    log(f"wire phase ok in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


def cluster_conf(files: list, val: Path, algo: str = "ftrl", max_delay: int = 0,
                 epochs: int = 1, fault: dict | None = None) -> dict:
    """Phase 13's config of one launch: phase 4's table width and FTRL
    hyperparameters (AdaGrad: the [lr] eta default), key caching and
    compression on (as JAX tests/test_multislice.py:416)."""
    conf = {"app": "linear_method",
            "data": {"files": [str(f) for f in files], "format": "libsvm",
                     "num_keys": WORKER_KEYS, "val_files": [str(val)],
                     "max_nnz_per_example": 4 * NNZ_PER},
            "solver": {"algo": algo, "minibatch": BATCH, "max_delay": max_delay,
                       "epochs": epochs},
            "lr": {"alpha": HYPER["alpha"], "beta": HYPER["beta"],
                   "eta": CLUSTER_ADAGRAD_ETA},
            "penalty": {"lambda_l1": HYPER["l1"], "lambda_l2": HYPER["l2"]},
            "filter": {"key_caching": True, "compressing": True}}
    if fault:
        conf["fault"] = fault
    return conf


def cluster_launches(name: str, out: dict, kernel: str, workers: int) -> int:
    """Each card server launched ``kernel`` once an apply batch and nothing
    else; every worker launched nothing. Returns the servers' launches."""
    total = 0
    for i, st in enumerate(out["server_stats"]):
        rep = out["nodes"][f"server-{i}"]
        got = rep["launches"]
        if not got[kernel] == st["apply_batches"] > 0:
            raise AssertionError(f"{name}: server {i} launched {got}, "
                                 f"{st['apply_batches']} apply batches")
        if any(v for k, v in got.items() if k != kernel):
            raise AssertionError(f"{name}: server {i} launched {got}")
        if not str(rep["device"]).startswith("cuda"):
            raise AssertionError(f"{name}: server {i} ran on {rep['device']}")
        total += got[kernel]
    for r in range(workers):
        rep = out["nodes"][f"worker-{r}"]
        if any(rep["launches"].values()):
            raise AssertionError(f"{name}: worker {r} launched {rep['launches']}")
    return total


def cluster_timing(out: dict, t_result: float) -> dict:
    """Wall time from the first spawn to the result, each node's start-up
    (register time minus spawn time), the workers' training window (first
    step to last push acked), the merged ex/s, the servers' pushes/s over
    that window."""
    nodes = out["nodes"]
    spawn0 = min(n["spawn_time"] for n in nodes.values())
    workers = [n for tag, n in nodes.items() if tag.startswith("worker")]
    window = max(w["t_done"] for w in workers) - min(w["t_first_step"] for w in workers)
    return {
        "wall_s": t_result - spawn0,
        "startup_s": {tag: n["t_register"] - n["spawn_time"] for tag, n in nodes.items()
                      if "t_register" in n},
        "train_window_s": window,
        "first_step_after_register_s": max(w["t_first_step"] - w["t_register"]
                                           for w in workers),
        "step_s": window / max(max(w["steps"] for w in workers), 1),
        "ex_per_s": out["merged"]["ex_per_sec"],
        "pushes_per_s": [st["pushes"] / window for st in out["server_stats"]],
    }


def zipf_row_files(tmp: Path, ids: np.ndarray, y: np.ndarray, with_val: bool) -> list:
    """Phase 13's libsvm files: CLUSTER_FILES of BATCH ``zipf_rows`` each
    (value 1), and with ``with_val`` a validation file of the next BATCH."""
    files = []
    for i in range(CLUSTER_FILES + int(with_val)):
        rows = slice(i * BATCH, (i + 1) * BATCH)
        path = tmp / (f"part-{i}.svm" if i < CLUSTER_FILES else "val.svm")
        path.write_text("".join(
            f"{int(lab)} " + " ".join(f"{k}:1" for k in row) + "\n"
            for lab, row in zip(y[rows], ids[rows].tolist())))
        files.append(path)
    return files


def phase_cluster() -> dict:
    """Phase 13: the cluster as processes (launch_local, cli launch) on
    the card, its servers applying through K1 (FTRL) or K3 (AdaGrad)."""
    from concurrent.futures import ThreadPoolExecutor

    from parameter_server_tpu_torch.parallel.multislice import launch_local
    from parameter_server_tpu_torch.utils.checkpoint import load_weights_text

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    out: dict = {"launches": {}}
    ids, y = zipf_rows()
    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = Path(tmp_s)
        t0 = time.perf_counter()
        files = zipf_row_files(tmp, ids, y, with_val=True)
        files, val = files[:-1], files[-1]

        def conf_file(tag: str, **kw) -> Path:
            path = tmp / f"{tag}.json"
            path.write_text(json.dumps(cluster_conf(files, val, **kw)))
            return path

        log(f"cluster: wrote {CLUSTER_FILES} libsvm files of {BATCH} rows and a validation "
            f"file of {BATCH} ({time.perf_counter() - t0:.2f} s)")

        # (a) deterministic FTRL and (d) AdaGrad: 2 servers, 1 worker,
        # max_delay 0, each on the card and on the CPU; (e) (a) on the card
        # with every node under CHAOS_PLAN; the five at once
        runs = {}
        with ThreadPoolExecutor(5) as ex:
            for algo, tags in (("ftrl", ("cuda", "cpu", "chaos")), ("adagrad", ("cuda", "cpu"))):
                app = conf_file(f"det-{algo}", algo=algo)
                for tag in tags:
                    chaos = {"fault_plan": CHAOS_PLAN, "fault_seed": CHAOS_SEED} if (
                        tag == "chaos") else {}
                    runs[algo, tag] = ex.submit(
                        launch_local, str(app), CLUSTER_SERVERS, 1,
                        model_out=str(tmp / f"{algo}-{tag}.txt"),
                        timeout=CLUSTER_TIMEOUT_S, device="cpu" if tag == "cpu" else "cuda",
                        **chaos)
            res = {k: f.result() for k, f in runs.items()}
        w = {k: torch.from_numpy(load_weights_text(tmp / f"{k[0]}-{k[1]}.txt", WORKER_KEYS))
             for k in res}
        a, a_cpu = res["ftrl", "cuda"], res["ftrl", "cpu"]
        err_a = check_e2e("cluster (a) FTRL model_out, card vs CPU", w["ftrl", "cuda"],
                          w["ftrl", "cpu"])
        objv, objv_cpu = a["merged"]["objv"], a_cpu["merged"]["objv"]
        if not abs(objv - objv_cpu) <= E2E_RTOL * abs(objv_cpu):
            raise AssertionError(f"cluster (a): merged objv {objv} on the card, {objv_cpu} "
                                 "on the CPU")
        want_wl = {"pending": 0, "active": 0, "done": CLUSTER_FILES,
                   "attempts": CLUSTER_FILES, "reassigned": 0}
        for k, r in res.items():
            if r["workloads"] != want_wl or r["dead_workers"] != []:
                raise AssertionError(f"cluster {k}: workloads {r['workloads']}, dead "
                                     f"{r['dead_workers']}")
        out["launches"]["cluster_a_ftrl_push"] = cluster_launches("cluster (a)", a,
                                                                  "ftrl_push", 1)
        out["model_a"] = w["ftrl", "cuda"]  # phase 16 (c) holds its traced launch to it
        d = res["adagrad", "cuda"]
        moved_d = check_moved("cluster (d) AdaGrad model_out, card vs CPU",
                              w["adagrad", "cuda"], w["adagrad", "cpu"],
                              torch.zeros(WORKER_KEYS), CLUSTER_ADAGRAD_ETA)
        out["launches"]["cluster_d_adagrad_push"] = cluster_launches("cluster (d)", d,
                                                                     "adagrad_push", 1)
        out["deterministic"] = {
            "max_abs_err_over_scale": err_a, "objv": objv, "objv_cpu": objv_cpu,
            "val_auc": a["val_auc"], "val_auc_cpu": a_cpu["val_auc"],
            "apply_batches": [st["apply_batches"] for st in a["server_stats"]],
            "adagrad": moved_d, "adagrad_val_auc": d["val_auc"],
            "adagrad_apply_batches": [st["apply_batches"] for st in d["server_stats"]]}
        log(f"cluster (a) ok: FTRL model card vs CPU within E2E_RTOL (max abs err "
            f"{err_a:.3g} of scale), objv {objv:.9g} vs {objv_cpu:.9g}, val AUC "
            f"{a['val_auc']:.6f} vs {a_cpu['val_auc']:.6f}; K1 launches = apply batches "
            f"{out['deterministic']['apply_batches']} on the card servers, none on the worker")
        log(f"cluster (d) ok: AdaGrad model card vs CPU: {moved_d}; K3 launches = apply "
            f"batches {out['deterministic']['adagrad_apply_batches']}; val AUC "
            f"{d['val_auc']:.6f}")
        # (e) the same launch under a fault plan on every node: exactly once
        e = res["ftrl", "chaos"]
        err_e = check_e2e("cluster (e) FTRL model_out under chaos vs the clean card model",
                          w["ftrl", "chaos"], w["ftrl", "cuda"])
        faults_e = [st.get("faults") for st in e["server_stats"]]
        if not all(f and f["disconnect"] >= 1 for f in faults_e):
            raise AssertionError(f"cluster (e): the servers' plans did not fire: {faults_e}")
        out["launches"]["cluster_e_ftrl_push"] = cluster_launches("cluster (e)", e,
                                                                  "ftrl_push", 1)
        out["chaos"] = {"max_abs_err_over_scale": err_e, "objv": e["merged"]["objv"],
                        "val_auc": e["val_auc"], "faults": faults_e,
                        "apply_batches": [st["apply_batches"] for st in e["server_stats"]],
                        "rpc_dedup_hits": [st["rpc_dedup_hits"] for st in e["server_stats"]]}
        log(f"cluster (e) ok: under {CHAOS_PLAN!r} on every node the model matches the clean "
            f"card launch's (max abs err {err_e:.3g} of scale), objv {e['merged']['objv']:.9g} "
            f"vs {objv:.9g}; every workload done once; K1 = apply batches "
            f"{out['chaos']['apply_batches']}; server faults {faults_e}")

        # (b) the real entry point: cli launch, 2 workers, max_delay 1
        app = conf_file("async", max_delay=1)
        env = {**os.environ, "PYTHONPATH": os.pathsep.join(
            p for p in (str(root), os.environ.get("PYTHONPATH", "")) if p)}
        proc = subprocess.run(
            [sys.executable, "-m", "parameter_server_tpu_torch.cli", "launch",
             "--app_file", str(app), "--num_servers", str(CLUSTER_SERVERS),
             "--num_workers", "2", "--device", "cuda"],
            cwd=tmp, env=env, capture_output=True, text=True,
            timeout=CLUSTER_TIMEOUT_S + 60)
        t_result = time.time()
        if proc.returncode != 0:
            raise AssertionError(f"cluster (b): cli launch exited {proc.returncode}:\n"
                                 f"{proc.stderr[-3000:]}")
        b = json.loads(proc.stdout.strip().splitlines()[-1])
        if b["workloads"] != want_wl or b["dead_workers"] != []:
            raise AssertionError(f"cluster (b): workloads {b['workloads']}, dead "
                                 f"{b['dead_workers']}")
        if not all(st["pushes"] > 0 and st["pulls"] > 0 for st in b["server_stats"]):
            raise AssertionError(f"cluster (b): server stats {b['server_stats']}")
        out["launches"]["cluster_b_ftrl_push"] = cluster_launches("cluster (b)", b,
                                                                  "ftrl_push", 2)
        tb = cluster_timing(b, t_result)
        out["async"] = {**tb, "val_auc": b["val_auc"], "objv": b["merged"]["objv"],
                        "apply_batches": [st["apply_batches"] for st in b["server_stats"]],
                        "pushes": [st["pushes"] for st in b["server_stats"]],
                        "push_coalesced": [st["push_coalesced"] for st in b["server_stats"]]}
        log(f"cluster (b): cli launch, 2 servers + 2 workers: {tb['wall_s']:.2f} s from "
            f"spawn to result; start-up (register - spawn) "
            f"{ {k: round(v, 2) for k, v in tb['startup_s'].items()} } s; training window "
            f"{tb['train_window_s']:.3f} s; merged {tb['ex_per_s']:.1f} ex/s; servers "
            f"{[round(x, 1) for x in tb['pushes_per_s']]} pushes/s; val AUC "
            f"{b['val_auc']:.6f} ((a) {a['val_auc']:.6f}); K1 = apply batches "
            f"{out['async']['apply_batches']}")
        if not abs(b["val_auc"] - a["val_auc"]) <= CLUSTER_AUC_BOUND:
            raise AssertionError(f"cluster (b): val AUC {b['val_auc']} vs (a)'s {a['val_auc']}")

        # (c) recovery on the card, 2 epochs: a worker killed, a server
        # killed and restarted from its checkpoint, the kills after the
        # workers' first step (timed from (b)), both launches at once
        delay = tb["first_step_after_register_s"] + 1.5 * tb["step_s"]
        fault = {**CLUSTER_FAULT, "server_ckpt_interval_s": 0.5,
                 "server_restart_grace_s": 60.0, "reconnect_timeout_s": 60.0}
        kill_app = conf_file("kill", max_delay=1, epochs=2, fault=CLUSTER_FAULT)
        restart_app = conf_file("restart", max_delay=1, epochs=2, fault=fault)
        with ThreadPoolExecutor(2) as ex:
            f_kill = ex.submit(launch_local, str(kill_app), CLUSTER_SERVERS, 2,
                               timeout=CLUSTER_TIMEOUT_S, device="cuda",
                               fault_kill=f"worker:1@{delay:.3f}")
            f_restart = ex.submit(launch_local, str(restart_app), CLUSTER_SERVERS, 2,
                                  timeout=CLUSTER_TIMEOUT_S, device="cuda",
                                  fault_kill=f"server:1@{delay:.3f}", fault_restart_after=0.5,
                                  ckpt_dir=str(tmp / "ckpt"))
            kill, restart = f_kill.result(), f_restart.result()
        wl = kill["workloads"]
        if kill["dead_workers"] != [1] or (wl["pending"], wl["active"], wl["done"]) != (
                0, 0, 2 * CLUSTER_FILES) or wl["attempts"] != wl["done"] + wl["reassigned"]:
            raise AssertionError(f"cluster (c) worker kill: dead {kill['dead_workers']}, "
                                 f"workloads {wl}")
        want2 = {"pending": 0, "active": 0, "done": 2 * CLUSTER_FILES,
                 "attempts": 2 * CLUSTER_FILES, "reassigned": 0}
        if restart["dead_workers"] != [] or restart["workloads"] != want2:
            raise AssertionError(f"cluster (c) server restart: dead "
                                 f"{restart['dead_workers']}, workloads {restart['workloads']}")
        r1 = restart["nodes"].get("server-1-r1", {})
        if not r1.get("resumed"):
            raise AssertionError("cluster (c): the restarted server did not resume from "
                                 f"its checkpoint: {r1}")
        # the replacement launched K1 once an apply batch of its own life
        if not r1["launches"]["ftrl_push"] == r1["counters"]["apply_batches"] > 0:
            raise AssertionError(f"cluster (c): the restarted server launched "
                                 f"{r1['launches']}, {r1['counters']['apply_batches']} batches")
        out["launches"]["cluster_c_ftrl_push"] = (
            sum(kill["nodes"][f"server-{i}"]["launches"]["ftrl_push"]
                for i in range(CLUSTER_SERVERS))
            + restart["nodes"]["server-0"]["launches"]["ftrl_push"]
            + r1["launches"]["ftrl_push"])
        out["recovery"] = {
            "kill_delay_s": delay, "worker_kill_workloads": wl,
            "worker_kill_val_auc": kill["val_auc"],
            "restart_val_auc": restart["val_auc"],
            "restart_startup_s": r1["t_register"] - r1["spawn_time"]}
        log(f"cluster (c): kills {delay:.2f} s after register; worker 1 killed: dead "
            f"{kill['dead_workers']}, workloads {wl}, val AUC {kill['val_auc']:.6f}; server "
            f"1 killed and restarted from its checkpoint (start-up "
            f"{out['recovery']['restart_startup_s']:.2f} s): no dead worker, every workload "
            f"done once, val AUC {restart['val_auc']:.6f} ((a) {a['val_auc']:.6f})")
        if not abs(restart["val_auc"] - a["val_auc"]) <= CLUSTER_RESTART_AUC_BOUND:
            raise AssertionError(f"cluster (c): val AUC {restart['val_auc']} after the "
                                 f"server restart vs (a)'s {a['val_auc']}")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"cluster phase ok in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 14: chaos on the wire, and the serving plane
# ---------------------------------------------------------------------------


def chaos_backend(make_updater, num_keys: int, vdim: int):
    """Phase 12's loopback SocketBackend, its card server of rank r armed
    with its own FaultPlan(CHAOS_PLAN, CHAOS_SEED + r)."""
    from parameter_server_tpu_torch.parallel.backend import SocketBackend
    from parameter_server_tpu_torch.parallel.chaos import FaultPlan
    from parameter_server_tpu_torch.parallel.multislice import ServerHandle, ShardServer
    from parameter_server_tpu_torch.utils.config import PSConfig
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    cfg = PSConfig()
    ranges = KeyRange(0, num_keys).even_divide(WIRE_SERVERS)
    servers = [ShardServer(make_updater(), r, vdim=vdim, device="cuda",
                           fault_plan=FaultPlan.parse(CHAOS_PLAN, seed=CHAOS_SEED + i)).start()
               for i, r in enumerate(ranges)]
    handles = [ServerHandle(s.address, i, 0, cfg, range_size=r.size, device="cuda")
               for i, (s, r) in enumerate(zip(servers, ranges))]
    return SocketBackend(handles, ranges, num_keys, vdim=vdim, own_servers=servers)


def chaos_arm(name, make_updater, num_keys: int, vdim: int, pushes, kernel: str, counter,
              audit, clean: dict) -> dict:
    """One chaos arm: ``pushes`` one at a time through servers under the
    plan (wire_deterministic's checks: one launch an apply batch, every
    index unique, the pull against the CPU replay of each push applied
    once), then each server's push ledger holds every push once and every
    action of the plan fired."""
    be = chaos_backend(make_updater, num_keys, vdim)
    try:
        out = wire_deterministic(name, be, pushes, make_updater, vdim, kernel, counter, audit,
                                 profile_first=SERVER_WORKERS)
        faults, ledgers = [], []
        for srv, h in zip(be._servers, be.handles):
            ledger = srv._applied_push.get(h.client.identity[0], {})
            ledgers.append(len(ledger))
            if not len(ledger) == srv.counters["pushes"] == len(pushes):
                raise AssertionError(f"{name}: server ledger holds {len(ledger)} pushes, "
                                     f"applied {srv.counters['pushes']}, want {len(pushes)}")
            faults.append(srv.server.fault_stats())
    finally:
        be.close()
    fired = {a: sum(f.get(a, 0) for f in faults) for a in ("drop", "disconnect", "duplicate",
                                                            "delay")}
    if not all(fired.values()):
        raise AssertionError(f"{name}: not every action of the plan fired: {faults}")
    out.update({"faults": faults, "ledger": ledgers,
                "clean_pushes_per_s": clean["pushes_per_s"], "clean_latency": clean["latency"]})
    log(f"{name} ok: every push applied once under {CHAOS_PLAN!r} (seeds {CHAOS_SEED} + "
        f"rank); "
        f"ledgers {ledgers}; faults {faults}; {out['pushes_per_s']:.1f} pushes/s, p50 "
        f"{out['latency']['p50_ms']:.3f} / p99 {out['latency']['p99_ms']:.3f} ms, beside "
        f"phase 12's clean {clean['pushes_per_s']:.1f} pushes/s, p50 "
        f"{clean['latency']['p50_ms']:.3f} / p99 {clean['latency']['p99_ms']:.3f} ms")
    return out


def recording_cache(**kw):
    """A ClientKeyCache that logs every install (rank, local keys, rows,
    version): each version-stamped reply a serving handle took from the
    wire, so every served row can be held to the table at its ``ver``.
    Cached serves hand out copies of these rows."""
    import threading

    from parameter_server_tpu_torch.filters.keycache import ClientKeyCache

    class Recording(ClientKeyCache):
        def __init__(self, **kw):
            super().__init__(**kw)
            self.log: list = []
            self._log_lock = threading.Lock()

        def put(self, sig, keys, values, version, **kw):
            with self._log_lock:
                self.log.append((sig[0], np.array(keys), np.array(values), int(version)))
            return super().put(sig, keys, values, version, **kw)

    return Recording(**kw)


def serving_stack(servers, ranges, svcfg, flood: bool):
    """The frontends (one SocketBackend of SERVE_SERVERS serving handles a
    thread, all sharing one recording cache) and the writers (plain
    handles: one at ~1/SERVE_WRITER_PERIOD_S pushes/s, or two flooding
    windows of 32 async pushes)."""
    from parameter_server_tpu_torch.parallel.backend import SocketBackend
    from parameter_server_tpu_torch.parallel.multislice import ServerHandle
    from parameter_server_tpu_torch.utils.config import PSConfig

    cfg = PSConfig()
    cfg.serve = svcfg
    cache = recording_cache(cap=svcfg.cache_entries, ttl_s=svcfg.ttl_ms / 1e3,
                            max_stale_s=svcfg.max_stale_ms / 1e3)

    def backend(worker: int, serving: bool, c=None, key_cache=None):
        hs = [ServerHandle(s.address, i, worker, c or cfg, range_size=r.size, serving=serving,
                           key_cache=key_cache, device="cuda")
              for i, (s, r) in enumerate(zip(servers, ranges))]
        return SocketBackend(hs, ranges, WORKER_KEYS)

    fronts = [backend(t, True, key_cache=cache) for t in range(SERVE_THREADS)]
    writers = [backend(100 + i, not flood, key_cache=None) for i in range(2 if flood else 1)]
    return cache, fronts, writers


def serving_arm(name: str, servers, ranges, svcfg, keysets, pz, seconds: float, flood: bool,
                union: np.ndarray | None = None, verify: bool = True) -> dict:
    """Drive one serving arm: SERVE_THREADS frontend threads, each
    multiplexing SERVE_CLIENTS clients on their own Zipf streams over the
    key sets, while the writers push. With ``verify``: a CPU replay of the
    writer's pushes keeps the table after each push, every row a serving
    handle installed equals its server's table at the reply's version, and
    the writer reads its own writes."""
    import threading

    from parameter_server_tpu_torch.filters.keycache import CacheEntry
    from parameter_server_tpu_torch.kv.store import KVStore
    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.parallel.multislice import ServerHandle, _sig
    from parameter_server_tpu_torch.utils.metrics import wire_counters

    cache, fronts, writers = serving_stack(servers, ranges, svcfg, flood)
    begins = np.array([r.begin for r in ranges])
    c0 = {k: sum(s.counters[k] for s in servers) for k in
          ("pulls", "not_modified", "shed", "pull_encodes", "encode_reuse", "apply_batches",
           "pushes")}
    wire_counters.reset()
    torch.cuda.synchronize()
    fk.reset_launches()
    stop = threading.Event()
    errors: list = []
    # the replay: tables[j] is the union's weights after the writer's j-th push
    replay = KVStore(Ftrl(alpha=HYPER["alpha"], beta=HYPER["beta"], lambda_l1=HYPER["l1"],
                          lambda_l2=HYPER["l2"]), len(union) + 1, device="cpu") if verify else None
    tables = [np.zeros(len(union), np.float32)] if verify else []
    v0 = [s.version for s in servers]
    vmap = [{v0[i]: 0} for i in range(len(servers))]
    counts = [0] * len(servers)
    ryw: list = []

    def write(wi: int) -> None:
        wr = np.random.default_rng(SEED + 11 + wi)
        be, futs, j = writers[wi], [], 0
        try:
            while not stop.is_set():
                ks = keysets[int(wr.integers(0, SERVE_SETS))]
                g = (wr.normal(size=SERVE_SET_KEYS) * 0.01).astype(np.float32)
                if flood:
                    futs.append(be.push_async(ks, g))
                    if len(futs) >= 32:
                        for f in futs:
                            f.result()
                        futs.clear()
                    continue
                be.push(ks, g)
                j += 1
                if verify:
                    replay.push(np.searchsorted(union, ks) + 1, g)
                    tables.append(replay.pull(np.arange(1, len(union) + 1)).numpy().ravel())
                    for s in np.unique(np.searchsorted(begins, ks, side="right") - 1):
                        counts[s] += 1
                        vmap[s][v0[s] + counts[s]] = j
                    if j % 5 == 0:  # read your own write: the push invalidated it
                        got = be.pull(ks).ravel()
                        want = tables[-1][np.searchsorted(union, ks)]
                        ryw.append(float(np.abs(got - want).max()))
                        if not np.allclose(got, want, rtol=RTOL, atol=ATOL):
                            raise AssertionError(f"{name}: the writer read {got} after its "
                                                 f"push {j}, want {want}")
                stop.wait(SERVE_WRITER_PERIOD_S)
            for f in futs:
                f.result()
        except BaseException as e:  # noqa: BLE001 — reported by the arm
            errors.append(e)

    lat = {"local": [], "wire": []}
    served = [0] * SERVE_THREADS
    handle_pulls = [0] * SERVE_THREADS

    def front(t: int) -> None:
        be = fronts[t]
        crngs = [np.random.default_rng(SEED + t * SERVE_CLIENTS + c)
                 for c in range(SERVE_CLIENTS)]
        picks = [r.choice(SERVE_SETS, size=64, p=pz) for r in crngs]
        idx = [0] * SERVE_CLIENTS
        mine = {"local": [], "wire": []}
        c = n = nh = 0
        try:
            while not stop.is_set():
                c = (c + 1) % SERVE_CLIENTS
                if idx[c] >= 64:
                    picks[c] = crngs[c].choice(SERVE_SETS, size=64, p=pz)
                    idx[c] = 0
                ks = keysets[int(picks[c][idx[c]])]
                idx[c] += 1
                segs, _ = be._segments(ks)
                nh += sum(1 for seg in segs if len(seg))
                # the path this pull takes: local when every shard's entry
                # is fresh when it is issued (an entry may lapse between the
                # look and the pull: rare at a 1 s TTL)
                local = all(
                    (e := cache.lookup((i, _sig(seg)))) is not None and cache.fresh(e)
                    for i, seg in enumerate(segs) if len(seg))
                t0 = time.perf_counter()
                be.pull(ks)
                mine["local" if local else "wire"].append(time.perf_counter() - t0)
                n += 1
        except BaseException as e:  # noqa: BLE001 — reported by the arm
            errors.append(e)
        served[t] = n
        handle_pulls[t] = nh
        for k in lat:
            lat[k].extend(mine[k])

    ths = ([threading.Thread(target=write, args=(i,), name=f"serve-writer-{i}")
            for i in range(len(writers))]
           + [threading.Thread(target=front, args=(t,), name=f"serve-front-{t}")
              for t in range(SERVE_THREADS)])
    # the realized age of every serve a handle hands out, as it books it
    # into its serve.age_s histogram (whose log2 buckets are too coarse
    # to hold the ceiling to)
    ages: list = [0.0]
    book = ServerHandle._book_serve_age

    def booked(h, age_us, src):
        ages.append(float(age_us))
        return book(h, age_us, src)

    # the staleness of every cached serve, read where the handle dates it:
    # the time since the rows' server last confirmed them, which is what
    # max(ttl, max_stale) bounds. The realized age a serve books adds the
    # rows' age on the server at that confirmation (since their publish),
    # which grows without bound on a table no one writes, and no setting
    # caps it
    stale: list = [0.0]
    dated = CacheEntry.age_us

    def dating(ent, now=None):
        now = time.monotonic() if now is None else now
        stale.append(max(now - ent.filled_at, 0.0) * 1e6)
        return dated(ent, now)

    ServerHandle._book_serve_age = booked
    CacheEntry.age_us = dating
    t0 = time.perf_counter()
    try:
        for th in ths:
            th.start()
        stop.wait(seconds)
        stop.set()
        for th in ths:
            th.join(timeout=120)
    finally:
        ServerHandle._book_serve_age = book
        CacheEntry.age_us = dated
    dt = time.perf_counter() - t0
    for be in writers:
        be.flush()
    if any(th.is_alive() for th in ths):
        raise AssertionError(f"{name}: a frontend or writer thread hung")
    if errors:
        raise errors[0]
    torch.cuda.synchronize()
    launches = fk.LAUNCHES["ftrl_push"]
    d = {k: sum(s.counters[k] for s in servers) - c0[k] for k in c0}
    if launches != d["apply_batches"] or d["pushes"] == 0:
        raise AssertionError(f"{name}: ftrl_push launched {launches} times, the servers "
                             f"applied {d['apply_batches']} batches of {d['pushes']} pushes")
    wc = wire_counters.snapshot()
    bound_us = max(svcfg.ttl_ms, svcfg.max_stale_ms) * 1e3
    age_peak, stale_peak = max(ages), max(stale)
    if not stale_peak <= bound_us:
        raise AssertionError(f"{name}: a row was served {stale_peak} us after its server "
                             f"last confirmed it, past max(ttl, max_stale) = {bound_us} us")
    checked = 0
    if verify:
        for rank, keys, values, ver in cache.log:
            j = vmap[rank].get(ver)
            if j is None:
                raise AssertionError(f"{name}: server {rank} replied version {ver}, which "
                                     "no writer push produced")
            want = tables[j][np.searchsorted(union, keys + begins[rank])]
            if not np.allclose(values.ravel(), want, rtol=RTOL, atol=ATOL):
                raise AssertionError(f"{name}: server {rank}'s rows at version {ver} (after "
                                     f"push {j}) are {values.ravel()}, want {want}")
            checked += 1
        for i, s in enumerate(servers):
            if s.version != v0[i] + counts[i]:
                raise AssertionError(f"{name}: server {i} at version {s.version}, want "
                                     f"{v0[i] + counts[i]} after {counts[i]} pushes")
    pulls = sum(served)
    hits = wc.get("serve_cache_hits", 0) + wc.get("serve_cache_stale_hits", 0)
    misses = wc.get("serve_cache_misses", 0)
    out = {
        "seconds": dt, "frontend_pulls": pulls, "pulls_per_s": pulls / dt,
        "latency": latency_ms([x for v in lat.values() for x in v]),
        "latency_local": latency_ms(lat["local"]) if lat["local"] else None,
        "latency_wire": latency_ms(lat["wire"]) if lat["wire"] else None,
        "handle_local_hits": hits, "handle_fresh_hits": wc.get("serve_cache_hits", 0),
        "handle_stale_hits": wc.get("serve_cache_stale_hits", 0), "handle_misses": misses,
        "handle_pulls": sum(handle_pulls),
        "handle_hit_rate": hits / max(sum(handle_pulls), 1),
        "server": d, "writer_launches": launches, "shed_served": wc.get("serve_shed_served", 0),
        "age_peak_us": age_peak, "stale_peak_us": stale_peak, "checked_installs": checked,
        "ryw_checks": len(ryw),
        "withheld_peak": wc.get("wire_withheld_bytes_peak", 0),
    }
    for be in fronts + writers:
        be.close()
    log(f"{name} ok: {pulls} frontend pulls in {dt:.2f} s ({out['pulls_per_s']:.1f}/s), "
        f"p50 {out['latency']['p50_ms']:.3f} / p99 {out['latency']['p99_ms']:.3f} ms; local "
        f"{out['latency_local']}, wire {out['latency_wire']}; handle-level local hits {hits} "
        f"(fresh {out['handle_fresh_hits']}, stale {out['handle_stale_hits']}), misses "
        f"{misses}; servers {d}; shed served {out['shed_served']}; writer K1 launches "
        f"{launches} = apply batches; oldest served row {age_peak / 1e3:.1f} ms; most stale "
        f"serve {stale_peak / 1e3:.1f} ms after its server's last confirmation (bound "
        f"{bound_us / 1e3:.0f} ms); {checked} installs held to the table at their version, "
        f"{len(ryw)} read-your-writes checks")
    return out


def phase_chaos_serving(rounds, emb_rounds, clean: dict) -> dict:
    """Phase 14: (a), (b) phase 12's servers under a fault plan; (c) the
    serving plane at the worker's width, then a shed arm."""
    from parameter_server_tpu_torch.kv.updaters import Adagrad, Ftrl
    from parameter_server_tpu_torch.ops import adagrad_kernels as ak
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.parallel.multislice import ServerHandle, ShardServer
    from parameter_server_tpu_torch.utils.config import PSConfig, ServeConfig
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    t_phase = time.perf_counter()
    out: dict = {"launches": {}}
    audit = IndexAudit()

    def ftrl():
        return Ftrl(alpha=HYPER["alpha"], beta=HYPER["beta"], lambda_l1=HYPER["l1"],
                    lambda_l2=HYPER["l2"])

    def adagrad():
        return Adagrad(eta=ADAGRAD["eta"], eps=ADAGRAD["eps"])

    pushes = [(k, g) for idx_list, grad_list in rounds for k, g in zip(idx_list, grad_list)]
    out["ftrl"] = chaos_arm("chaos FTRL server", ftrl, SERVER_KEYS, 1, pushes, "ftrl_push",
                            fk.LAUNCHES, audit, clean["ftrl"])
    out["launches"]["chaos_ftrl_server"] = out["ftrl"]["launches"]
    torch.cuda.empty_cache()
    emb_pushes = [(k, g) for idx_list, grad_list in emb_rounds
                  for k, g in zip(idx_list, grad_list)]
    out["embedding"] = chaos_arm("chaos embedding server", adagrad, EMB_KEYS, EMB_VDIM,
                                 emb_pushes, "adagrad_push", ak.LAUNCHES, audit,
                                 clean["embedding"])
    out["launches"]["chaos_embedding_server"] = out["embedding"]["launches"]
    torch.cuda.empty_cache()

    # (c) serving: WORKER_KEYS FTRL keys over SERVE_SERVERS card servers of
    # snapshot_keys_max rows each, so the host snapshot path runs
    rng = np.random.default_rng(SEED + 14)
    keysets = [np.sort(rng.choice(WORKER_KEYS, size=SERVE_SET_KEYS, replace=False))
               for _ in range(SERVE_SETS)]
    union = np.unique(np.concatenate(keysets))
    pz = np.arange(1, SERVE_SETS + 1, dtype=np.float64) ** -SERVE_ZIPF
    pz /= pz.sum()
    svcfg = ServeConfig(cache=True, ttl_ms=SERVE_TTL_MS, max_stale_ms=SERVE_MAX_STALE_MS,
                        hot_min_pulls=2, encode_cache_entries=256)
    ranges = KeyRange(0, WORKER_KEYS).even_divide(SERVE_SERVERS)
    if not all(r.size == svcfg.snapshot_keys_max for r in ranges):
        raise AssertionError(f"serving: ranges {[r.size for r in ranges]} are not "
                             f"snapshot_keys_max {svcfg.snapshot_keys_max}")
    switch = sys.getswitchinterval()
    sys.setswitchinterval(0.001)  # a frontend is bound by thread hand-offs
    try:
        for arm, flood in (("serving", False), ("serving shed", True)):
            cfg_arm = dataclasses.replace(svcfg, shed_queue_depth=SHED_QUEUE_DEPTH if flood
                                          else 0)
            servers = [ShardServer(ftrl(), r, serve_cfg=cfg_arm, device="cuda").start()
                       for r in ranges]
            try:
                res = serving_arm(arm, servers, ranges, cfg_arm, keysets, pz,
                                  SHED_SECONDS if flood else SERVE_SECONDS, flood,
                                  union=union, verify=not flood)
                if not flood:
                    # the training tier bypasses the cache: each plain pull
                    # moves every touched server's pulls counter
                    plain = [ServerHandle(s.address, i, 200, PSConfig(), range_size=r.size,
                                          device="cuda")
                             for i, (s, r) in enumerate(zip(servers, ranges))]
                    ks = keysets[0]
                    touched = np.unique(np.searchsorted([r.begin for r in ranges], ks,
                                                        side="right") - 1)
                    before = [s.counters["pulls"] for s in servers]
                    for _ in range(3):
                        for i in touched:
                            seg = ks[(ks >= ranges[i].begin) & (ks < ranges[i].end)]
                            plain[i].pull(seg - ranges[i].begin)
                    moved = [s.counters["pulls"] - b for s, b in zip(servers, before)]
                    if any(moved[i] != 3 for i in touched):
                        raise AssertionError(f"serving: 3 uncached pulls moved the servers' "
                                             f"pulls counters by {moved}")
                    for h in plain:
                        h.close()
                    # the host snapshot of a version at snapshot_keys_max rows:
                    # the weights of the table issued under the publish lock
                    # and copied to the host outside it
                    d2h = []
                    for _ in range(5):
                        servers[0]._host_w = None
                        torch.cuda.synchronize()
                        t0 = time.perf_counter()
                        servers[0]._gather_weights(np.arange(8), snap=True)
                        d2h.append((time.perf_counter() - t0) * 1e3)
                    res["host_weights_ms"] = d2h
                    res["host_weights_rows"] = ranges[0].size
                    log(f"serving: _host_weights at {ranges[0].size} rows (FTRL weights on the "
                        f"card, copy to the host): {[round(x, 3) for x in d2h]} ms; 3 uncached "
                        f"pulls moved the touched servers' pulls by {moved}")
                    # one profiled second of the serving traffic: the
                    # device's idle share
                    prof: dict = {}
                    wall_ms, busy_ms, rows = profile(
                        lambda: prof.update(serving_arm(
                            "serving (profiled)", servers, ranges, cfg_arm, keysets, pz,
                            1.0, False, union=union, verify=False)))
                    res["profile"] = {"wall_ms": wall_ms, "busy_ms": busy_ms,
                                      "writer_launches": prof["writer_launches"],
                                      "idle_share": 1 - busy_ms / wall_ms,
                                      "top": [(k[:60], t) for k, t, _ in rows[:6]]}
                    log(f"serving profile, 1 s of traffic: wall {wall_ms:.1f} ms, device busy "
                        f"{busy_ms:.3f} ms (idle share {1 - busy_ms / wall_ms:.4f}); top "
                        f"{res['profile']['top']}")
                elif res["server"]["shed"] == 0 or res["shed_served"] == 0:
                    raise AssertionError(f"serving shed: no revalidation was shed under the "
                                         f"flood: {res['server']}")
            finally:
                for s in servers:
                    s.server.stop()
                for s in servers:
                    s.join(timeout=10)
            out["shed" if flood else "serving"] = res
            del servers
            torch.cuda.empty_cache()
    finally:
        sys.setswitchinterval(switch)
    out["launches"]["serving_writer"] = (out["serving"]["writer_launches"]
                                         + out["serving"]["profile"]["writer_launches"]
                                         + out["shed"]["writer_launches"])
    out["seconds"] = time.perf_counter() - t_phase
    log(f"chaos and serving phase ok in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 15: the darlin batch solver, graph_partition and sketch (no kernel)
# ---------------------------------------------------------------------------


def rcv1_rows(dev) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """RCV1_EXAMPLES rows of make_sparse_logistic's law at RCV1's shape:
    labels, row splits, raw ids (uint64) and values. The ids are drawn on
    the device (its per-row loop would take tens of seconds): each draw an
    inverse-CDF lookup of the Zipf law capped at the last id as the
    function's minimum caps it, each row's draws made distinct (and sorted)
    by one unique over row * F + id; the labels are summed on the host."""
    from scipy.special import zeta

    rng = np.random.default_rng(SEED + 15)
    gen = torch.Generator(device=dev).manual_seed(SEED + 15)
    F, N = RCV1_FEATURES, RCV1_EXAMPLES
    true_w = (rng.normal(size=F) * (rng.random(F) < 0.2)).astype(np.float32)
    pmf = np.arange(1, F, dtype=np.float64) ** -RCV1_ZIPF / zeta(RCV1_ZIPF)
    cdf = torch.tensor(np.append(np.cumsum(pmf), 1.0), device=dev)
    draws = torch.poisson(torch.full((N,), float(RCV1_DRAWS), device=dev), generator=gen)
    draws = draws.clamp_min(1).long()
    keys, counts = [], []
    for lo in range(0, N, 1 << 17):
        d = draws[lo:lo + (1 << 17)]
        u = torch.rand(int(d.sum()), generator=gen, dtype=torch.float64, device=dev)
        ids = torch.searchsorted(cdf, u).clamp_max(F - 1)
        rows = torch.repeat_interleave(torch.arange(len(d), device=dev) * F, d)
        pairs = torch.unique(rows + ids)  # sorted
        keys.append((pairs % F).int().cpu())
        counts.append(torch.bincount(pairs // F, minlength=len(d)).cpu())
    keys = torch.cat(keys).numpy()
    splits = np.zeros(N + 1, np.int64)
    np.cumsum(torch.cat(counts).numpy(), out=splits[1:])
    vals = (torch.randn(len(keys), generator=gen, device=dev) * 0.3 + 1.0).cpu().numpy()
    rows = np.repeat(np.arange(N), np.diff(splits))
    margin = np.bincount(rows, weights=vals * true_w[keys], minlength=N)
    labels = (margin + 0.5 * rng.normal(size=N) > 0).astype(np.float32)
    return labels, splits, keys.astype(np.uint64), vals


def darlin_batches(rows: tuple, n: int) -> list:
    """The first ``n`` rows as CSR batches of the CLI's hashed keys."""
    from parameter_server_tpu_torch.data.batch import BatchBuilder

    labels, splits, keys, vals = rows
    builder = BatchBuilder(num_keys=DARLIN_KEYS, batch_size=DARLIN_BATCH,
                           max_nnz_per_example=256)
    out = []
    for lo in range(0, n, DARLIN_BATCH):
        hi = min(lo + DARLIN_BATCH, n)
        a, b = splits[lo], splits[hi]
        out.append(builder.build_flat(labels[lo:hi], splits[lo:hi + 1] - a, keys[a:b],
                                      vals[a:b]))
    return out


def darlin_conf(**kw) -> dict:
    """The solver's config (bench.py's darlin settings) as a config file's
    sections; ``kw`` overrides solver fields."""
    return {"app": "linear_method",
            "data": {"num_keys": DARLIN_KEYS, "max_nnz_per_example": 256},
            "solver": {"algo": "darlin", "feature_blocks": DARLIN_BLOCKS,
                       "block_iters": DARLIN_ITERS, "minibatch": DARLIN_BATCH,
                       "kkt_filter_threshold": DARLIN["kkt_filter_threshold"],
                       "epsilon": DARLIN["epsilon"], **kw},
            "lr": {"eta": DARLIN["eta"]}, "penalty": {"lambda_l1": DARLIN["lambda_l1"]}}


def cfg_of(conf: dict):
    """A PSConfig of a config file's sections."""
    from parameter_server_tpu_torch.utils.config import PSConfig

    cfg = PSConfig()
    for section, fields in conf.items():
        if isinstance(fields, dict):
            for k, v in fields.items():
                setattr(getattr(cfg, section), k, v)
        else:
            setattr(cfg, section, fields)
    return cfg


def darlin_cfg(**kw):
    return cfg_of(darlin_conf(**kw))


def check_history(name: str, got: list, want: list, rtol: float) -> tuple[float, float]:
    """Two solves' objective histories: the first DARLIN_CPU_PASSES passes
    within ``rtol``, and, where both ran more, their last objectives within
    DARLIN_END_RTOL (see there). Returns both relative differences."""
    n = min(len(got), len(want), DARLIN_CPU_PASSES)
    a, b = np.asarray(got[:n]), np.asarray(want[:n])
    err = float(np.max(np.abs(a - b) / np.abs(b))) if n else float("nan")
    longer = min(len(got), len(want)) > DARLIN_CPU_PASSES
    end = abs(got[-1] - want[-1]) / abs(want[-1]) if longer else 0.0
    if not (np.isfinite(got).all() and err <= rtol and end <= DARLIN_END_RTOL):
        raise AssertionError(f"{name}: history {list(got)} vs {list(want)} (rtol {rtol} over "
                             f"{DARLIN_CPU_PASSES} passes, the last within {DARLIN_END_RTOL})")
    return err, end


@contextlib.contextmanager
def recording(cls, name: str, seen: list):
    """Record (self, result) of every call of ``cls.name``."""
    orig = getattr(cls, name)

    def run(self, *a, **kw):
        res = orig(self, *a, **kw)
        seen.append((self, res))
        return res

    setattr(cls, name, run)
    try:
        yield seen
    finally:
        setattr(cls, name, orig)


def cli_quiet(argv: list[str]) -> dict:
    """The port's ``cli`` in this process, its printing kept off this
    script's stdout; returns its result JSON."""
    import io

    from parameter_server_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        if cli.main(argv) != 0:
            raise AssertionError(f"cli {argv[:1]} failed: {buf.getvalue()[-2000:]}")
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def errs(e: tuple) -> str:
    return f"{e[0]:.3g} over the first passes, {e[1]:.3g} at the last"


def darlin_single(dev, cb) -> dict:
    """Phase 15 (a): the solve at RCV1's shape on the card, twice (the
    second run's time and history beside the first's), its first passes
    against the CPU, a profiled pass, the g sum a block with and without
    its pads, and max_delay 2."""
    from parameter_server_tpu_torch.models import darlin as dm
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    quiet = ProgressReporter(print_fn=lambda s: None)
    out: dict = {}
    dm.Darlin(darlin_cfg(block_iters=1), reporter=quiet, device=dev).fit_blocks(cb)
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    runs = []
    for rep in (ProgressReporter(print_fn=lambda s: log(f"darlin | {s}")), quiet):
        t0 = time.perf_counter()
        runs.append((dm.Darlin(darlin_cfg(), reporter=rep, device=dev).fit_blocks(cb),
                     time.perf_counter() - t0))
    out["peak_memory_gib"] = torch.cuda.max_memory_allocated() / 2**30
    (res, t_solve), (again, t_again) = runs
    h, iters = res["history"], res["iters"]
    if not (np.isfinite(h).all() and h[-1] < h[0]):
        raise AssertionError(f"darlin (a): the objective must fall: {h}")
    out["err_repeat"] = check_history("darlin (a) a second card run", again["history"], h,
                                      DARLIN_RTOL)
    out.update(history=h, iters=iters, seconds=t_solve, objv=res["objv"], nnz_w=res["nnz_w"],
               train_auc=res["train_auc"], repeat_seconds=t_again,
               repeat_history=again["history"],
               block_passes_per_sec=[DARLIN_BLOCKS * r["iters"] / t for r, t in runs],
               example_blocks_per_sec=[cb.num_examples * DARLIN_BLOCKS * r["iters"] / t
                                       for r, t in runs])
    t0 = time.perf_counter()
    cpu = dm.Darlin(darlin_cfg(block_iters=DARLIN_CPU_PASSES), reporter=quiet,
                    device="cpu").fit_blocks(cb)
    out["cpu_seconds"] = time.perf_counter() - t0
    out["cpu_history"] = cpu["history"]
    out["err_cpu"] = check_history("darlin (a) card vs CPU", h, cpu["history"], DARLIN_RTOL)
    log(f"darlin (a) ok: {iters} / {again['iters']} passes in {t_solve:.3f} / {t_again:.3f} s "
        f"(upload included): {out['block_passes_per_sec']} block passes/s, "
        f"{out['example_blocks_per_sec']} example-blocks/s; objv {res['objv']:.6f} / "
        f"{again['objv']:.6f}, nnz_w {res['nnz_w']}, train_auc {res['train_auc']:.4f}; peak "
        f"device memory {out['peak_memory_gib']:.3f} GiB; the second run vs the first "
        f"{errs(out['err_repeat'])}; the first {DARLIN_CPU_PASSES} passes vs the CPU (its "
        f"{out['cpu_seconds']:.1f} s) {errs(out['err_cpu'])}")

    # one pass profiled, on the blocks already on the card
    l1, eta = DARLIN["lambda_l1"], DARLIN["eta"]
    blocks = {k: torch.tensor(np.asarray(getattr(cb, k)), device=dev)
              for k in ("feat_local", "rows", "values")}
    blocks["extent"] = dm.block_extents(cb.values)
    y = torch.tensor(np.asarray(cb.labels), device=dev)
    order = np.random.default_rng(SEED).permutation(cb.n_blocks)

    def one_pass():
        w = torch.zeros(cb.num_keys, device=dev)
        pred = torch.zeros(cb.num_examples, device=dev)
        act = torch.ones(cb.num_keys, dtype=torch.bool, device=dev)
        dm.darlin_pass(w, pred, act, blocks, order, y, l1, 0.0, eta, block_size=cb.block_size)

    one_pass()
    wall, busy, rows = profile(one_pass)
    out["pass_profile"] = {"wall_ms": wall, "busy_ms": busy, "idle_share": 1 - busy / wall,
                           "top": [(k[:60], round(t, 4), c) for k, t, c in rows[:8]]}
    log(f"darlin pass profile (zeros start, {cb.n_blocks} blocks): wall {wall:.3f} ms, "
        f"device busy {busy:.3f} ms (idle share {1 - busy / wall:.3f}); top device time "
        f"(name, ms, count): {out['pass_profile']['top']}")
    # the g sum of every block by events (a hot slot's atomic adds land on
    # one address): over its real entries (the solver's) and over the
    # padded width (value-0 pads at slot 0), beside its real entries and
    # its hottest slot's
    err = torch.rand(cb.num_examples, device=dev)
    per_block = []
    for b in range(cb.n_blocks):
        n = blocks["extent"][b]
        fl, r, v = (blocks[k][b] for k in ("feat_local", "rows", "values"))
        hot = int(torch.bincount(fl[:n], minlength=cb.block_size).max())
        ms = {name: cuda_ms(lambda i: dm._segment_sum(v[:m] * err.index_select(0, r[:m]),
                                                      fl[:m], cb.block_size), 20)[0]
              for name, m in (("real", n), ("padded", v.shape[0]))}
        per_block.append({"block": b, "entries": n, "hot": hot, **ms})
    out["g_sum"] = per_block
    cells = [(p["block"], p["entries"], p["hot"], round(p["real"], 4), round(p["padded"], 4))
             for p in per_block]
    log(f"darlin g sum a block (block, real entries, the hottest slot's entries, ms by "
        f"events over the real entries, ms over the padded width): {cells}")
    del blocks, y, err
    torch.cuda.empty_cache()

    t0 = time.perf_counter()
    dl = dm.Darlin(darlin_cfg(max_delay=2, block_iters=3 * DARLIN_ITERS), reporter=quiet,
                   device=dev).fit_blocks(cb)
    out["delay"] = {"seconds": time.perf_counter() - t0, "history": dl["history"],
                    "objv": dl["objv"], "nnz_w": dl["nnz_w"], "iters": dl["iters"]}
    hd = dl["history"]
    if not (np.isfinite(hd).all() and hd[-1] < hd[0] and hd[-1] <= DARLIN_DELAY_BOUND * h[-1]):
        raise AssertionError(f"darlin max_delay 2 did not converge: {hd} (delay 0 ends "
                             f"{h[-1]})")
    log(f"darlin max_delay 2 ok: {dl['iters']} passes in {out['delay']['seconds']:.3f} s, "
        f"objv {dl['objv']:.6f} (delay 0: {res['objv']:.6f}), nnz_w {dl['nnz_w']}")
    return out


def darlin_world_of_one(cb, single: dict) -> dict:
    """Phase 15 (b): a world of one on NCCL, resident against (a), streamed
    against resident."""
    from parameter_server_tpu_torch.models.darlin import Darlin
    from parameter_server_tpu_torch.parallel import runtime
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    quiet = ProgressReporter(print_fn=lambda s: None)
    out: dict = {}
    rt = runtime.init(None, kv_shards=1, data_shards=1, device="cuda")
    try:
        t0 = time.perf_counter()
        res = Darlin(darlin_cfg(), reporter=quiet, mesh=rt.mesh).fit_blocks(cb)
        out["resident"] = {"seconds": time.perf_counter() - t0, "iters": res["iters"],
                           "objv": res["objv"], "history": res["history"]}
        out["err_resident"] = check_history("darlin (b) world of one vs (a)", res["history"],
                                            single["history"], DARLIN_MESH_RTOL)
        t0 = time.perf_counter()
        st = Darlin(darlin_cfg(block_iters=DARLIN_STREAM_PASSES, block_chunk=DARLIN_CHUNK),
                    reporter=quiet, mesh=rt.mesh).fit_blocks(cb)
        out["streamed"] = {"seconds": time.perf_counter() - t0, "iters": st["iters"],
                           "history": st["history"]}
        out["err_streamed"] = check_history("darlin (b) streamed vs resident", st["history"],
                                            res["history"], DARLIN_RTOL)
    finally:
        rt.shutdown()
    r, s = out["resident"], out["streamed"]
    log(f"darlin (b) world of one on NCCL ok: resident {r['iters']} passes in "
        f"{r['seconds']:.3f} s ({DARLIN_BLOCKS * r['iters'] / r['seconds']:.2f} block "
        f"passes/s; (a) {single['block_passes_per_sec']}), objv {r['objv']:.6f}; vs (a) "
        f"{errs(out['err_resident'])}; streamed ({DARLIN_CHUNK} blocks a chunk) "
        f"{s['iters']} passes in {s['seconds']:.3f} s "
        f"({DARLIN_BLOCKS * s['iters'] / s['seconds']:.2f} block passes/s); vs resident "
        f"{errs(out['err_streamed'])}")
    return out


def darlin_files(tmp: Path, rows: tuple) -> list:
    """The first DARLIN_WORLD_EXAMPLES rows as DARLIN_FILES libsvm files."""
    from parameter_server_tpu_torch.data.synthetic import write_libsvm

    labels, splits, keys, vals = rows
    per = DARLIN_WORLD_EXAMPLES // DARLIN_FILES
    files = []
    for i in range(DARLIN_FILES):
        lo = i * per
        write_libsvm(tmp / f"rcv1-{i}.svm", labels[lo:lo + per],
                     [keys[splits[j]:splits[j + 1]] for j in range(lo, lo + per)],
                     [vals[splits[j]:splits[j + 1]] for j in range(lo, lo + per)])
        files.append(str(tmp / f"rcv1-{i}.svm"))
    return files


def darlin_cli(tmp: Path, rows: tuple) -> dict:
    """Phase 15 (d) `cli convert` then `cli train` from the cache (no parse)
    against a `cli train` that parses, and (c) a 2x2 world of `cli train`
    gloo ranks sharing the card beside its CPU twin, on the cache."""
    from parameter_server_tpu_torch.data import reader
    from parameter_server_tpu_torch.models import darlin as dm

    root = Path(__file__).resolve().parent
    out: dict = {}
    t0 = time.perf_counter()
    files = darlin_files(tmp, rows)
    out["write_seconds"] = time.perf_counter() - t0
    cache = tmp / "cache"

    def conf(tag: str, cached: bool, **par) -> Path:
        c = darlin_conf()
        c["data"].update(files=files, cache_dir=str(cache) if cached else "")
        if par:
            c["parallel"] = par
        path = tmp / f"{tag}.json"
        path.write_text(json.dumps(c))
        return path

    t0 = time.perf_counter()
    conv = cli_quiet(["convert", "--app_file", str(conf("convert", True))])
    out["convert"] = {**conv, "seconds": time.perf_counter() - t0}
    parses = []
    with recording(reader.MinibatchReader, "__iter__", parses), \
            recording(dm.Darlin, "fit_blocks", []) as fits:
        t0 = time.perf_counter()
        cached = cli_quiet(["train", "--app_file", str(conf("cached", True)),
                            "--device", "cuda"])
        t_cached = time.perf_counter() - t0
        if parses:
            raise AssertionError("darlin (d): cli train from the cache parsed the text")
        t0 = time.perf_counter()
        parsed = cli_quiet(["train", "--app_file", str(conf("parsed", False)),
                            "--device", "cuda"])
        t_parsed = time.perf_counter() - t0
    (_, r_cached), (_, r_parsed) = fits
    out["err_cache"] = check_history("darlin (d) train from the cache vs a parse",
                                     r_cached["history"], r_parsed["history"], DARLIN_RTOL)
    out.update(cached={**cached, "seconds": t_cached}, parsed={**parsed, "seconds": t_parsed})
    log(f"darlin (d) ok: {DARLIN_FILES} libsvm files of {DARLIN_WORLD_EXAMPLES} rows written "
        f"in {out['write_seconds']:.2f} s; cli convert {conv} in "
        f"{out['convert']['seconds']:.2f} s; cli train from the cache (no parse) "
        f"{t_cached:.2f} s, from the text {t_parsed:.2f} s; {cached['iters']} passes, objv "
        f"{cached['objv']:.6f} vs {parsed['objv']:.6f}; {errs(out['err_cache'])}")

    # (c): the same cache, a 2x2 world on the card and one on the CPU, at once
    logs = tmp / "logs"
    logs.mkdir()
    par = {"data_shards": 2, "kv_shards": 2}
    specs = {f"darlin-{d}": (conf(f"world-{d}", True, **par), d, []) for d in ("cuda", "cpu")}
    worlds = wait_worlds(start_worlds(root, logs, specs, POD_TIMEOUT_S), POD_TIMEOUT_S)
    card, cpu = worlds["darlin-cuda"], worlds["darlin-cpu"]
    for tag, wd in worlds.items():
        for r in wd["results"]:
            if any(r["launches"].values()):
                raise AssertionError(f"darlin (c) {tag} rank {r['process_index']} launched "
                                     f"{r['launches']}")
    hist = {t: [row["objv"] for row in worlds[t]["rows"]] for t in worlds}
    out["err_world_cpu"] = check_history("darlin (c) 2x2 card vs CPU world",
                                         hist["darlin-cuda"], hist["darlin-cpu"], DARLIN_RTOL)
    single = [v / DARLIN_WORLD_EXAMPLES for v in r_cached["history"]]
    out["err_world_single"] = check_history("darlin (c) 2x2 card world vs one device",
                                            hist["darlin-cuda"], single, DARLIN_MESH_RTOL)
    res0 = card["results"][0]
    out["world"] = {"seconds": card["seconds"], "cpu_seconds": cpu["seconds"],
                    **{k: res0[k] for k in ("objv", "iters", "nnz_w", "train_auc")},
                    "cpu_objv": cpu["results"][0]["objv"],
                    "payload_bytes": res0["payload_bytes"]}
    log(f"darlin (c) 2x2 ok: card world {card['seconds']:.1f} s, CPU world "
        f"{cpu['seconds']:.1f} s; {res0['iters']} passes, objv {res0['objv']:.6f} (CPU "
        f"{cpu['results'][0]['objv']:.6f}), nnz_w {res0['nnz_w']}; the printed history vs "
        f"the CPU world {errs(out['err_world_cpu'])}, vs one device "
        f"{errs(out['err_world_single'])}; rank 0's collective bytes {res0['payload_bytes']}")
    return out


def graph_partition_runs(tmp: Path, labels, keys, vals) -> dict:
    """Phase 15 (e): graph_partition through `cli train` on phase 4's rows,
    the card against the CPU bit for bit; then the partition step alone on
    the card."""
    from parameter_server_tpu_torch.data.batch import BatchBuilder
    from parameter_server_tpu_torch.data.synthetic import write_libsvm
    from parameter_server_tpu_torch.models import graph_partition as gpm

    t0 = time.perf_counter()
    files = []
    for i in range(STEPS):
        rows = slice(i * BATCH, (i + 1) * BATCH)
        write_libsvm(tmp / f"g-{i}.svm", labels[rows], keys[rows], vals[rows])
        files.append(str(tmp / f"g-{i}.svm"))
    conf = {"app": "graph_partition",
            "data": {"files": files, "num_keys": GRAPH_KEYS,
                     "max_nnz_per_example": 4 * NNZ_PER},
            "solver": {"minibatch": BATCH}, "graph": {"num_partitions": GRAPH_PARTITIONS}}
    app_file = tmp / "graph.json"
    app_file.write_text(json.dumps(conf))
    out: dict = {"write_seconds": time.perf_counter() - t0}
    res, apps = {}, []
    with recording(gpm.GraphPartition, "partition_files", apps):
        for device in ("cuda", "cpu"):
            t0 = time.perf_counter()
            res[device] = cli_quiet(["train", "--app_file", str(app_file), "--model_out",
                                     str(tmp / f"parts-{device}.txt"), "--device", device])
            res[device]["seconds"] = time.perf_counter() - t0
    (card, _), (cpu, _) = apps
    got, want = card.state_dict(), cpu.state_dict()
    same = {k: bool(np.array_equal(got[k], want[k])) for k in ("presence", "sizes")}
    same["assignments"] = bool(np.array_equal(card.assignments, cpu.assignments))
    same["dump"] = (tmp / "parts-cuda.txt").read_text() == (tmp / "parts-cpu.txt").read_text()
    same["result"] = {k: v for k, v in res["cuda"].items() if k != "seconds"} == {
        k: v for k, v in res["cpu"].items() if k != "seconds"}
    if not all(same.values()):
        raise AssertionError(f"graph_partition (e): the card differs from the CPU: {same}")
    del card, cpu, apps, got, want
    torch.cuda.empty_cache()
    # the partition step alone, on batches put on the card ahead
    builder = BatchBuilder(num_keys=GRAPH_KEYS, batch_size=BATCH,
                           max_nnz_per_example=4 * NNZ_PER)
    batches = [gpm.device_batch(builder.build(labels[i:i + BATCH], keys[i:i + BATCH],
                                              vals[i:i + BATCH]), "cuda")
               for i in range(0, BATCH * STEPS, BATCH)]
    state = gpm.init_state(GRAPH_KEYS, GRAPH_PARTITIONS, "cuda")
    penalty = cfg_of(conf).graph.balance_penalty
    gpm.partition_step(state, batches[0], GRAPH_PARTITIONS, penalty)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for b in batches:
        gpm.partition_step(state, b, GRAPH_PARTITIONS, penalty)
    torch.cuda.synchronize()
    t_steps = time.perf_counter() - t0
    del state, batches
    torch.cuda.empty_cache()
    r = res["cuda"]
    out.update(card=r, cpu_seconds=res["cpu"]["seconds"],
               step_examples_per_sec=BATCH * STEPS / t_steps)
    log(f"graph_partition (e) ok: {r['examples']} examples, {GRAPH_PARTITIONS} partitions of "
        f"a {GRAPH_KEYS}-key presence table; replication {r['replication']:.4f}, balance "
        f"{r['balance']:.4f}, {r['features']} features, {r['features_dumped']} dumped; "
        f"presence, sizes, assignments, dump and result equal to the CPU run's; cli train "
        f"{r['seconds']:.2f} s on the card ({r['examples'] / r['seconds']:.1f} examples/s, "
        f"parse included), {res['cpu']['seconds']:.2f} s on the CPU; the step alone "
        f"{out['step_examples_per_sec']:.1f} examples/s on the card")
    return out


def sketch_runs(tmp: Path) -> dict:
    """Phase 15 (f): the sketch app through `cli train` on phase 13's
    files, `--device cuda` against `--device cpu` (host code: the device is
    not used)."""
    ids, y = zipf_rows()
    files = [str(f) for f in zipf_row_files(tmp, ids, y, with_val=False)]
    conf = {"app": "sketch", "data": {"files": files, "num_keys": WORKER_KEYS},
            "sketch": {"min_count": SKETCH_MIN_COUNT}}
    app_file = tmp / "sketch.json"
    app_file.write_text(json.dumps(conf))
    res = {}
    for device in ("cuda", "cpu"):
        t0 = time.perf_counter()
        res[device] = cli_quiet(["train", "--app_file", str(app_file), "--model_out",
                                 str(tmp / f"hh-{device}.txt"), "--device", device])
        res[device]["seconds"] = time.perf_counter() - t0
    dumps = [(tmp / f"hh-{d}.txt").read_text() for d in ("cuda", "cpu")]
    strip = [{k: v for k, v in r.items() if k != "seconds"} for r in res.values()]
    if strip[0] != strip[1] or dumps[0] != dumps[1] or not strip[0]["dumped"]:
        raise AssertionError(f"sketch (f): card run {strip[0]} vs CPU run {strip[1]}, "
                             f"dumps equal: {dumps[0] == dumps[1]}")
    r = res["cuda"]
    log(f"sketch (f) ok (host code): {r['keys_seen']} keys of {CLUSTER_FILES} files, "
        f"{r['heavy_hitters']} heavy hitters (min_count {SKETCH_MIN_COUNT}), top count "
        f"{r['top_count']}; result and dump equal to the CPU run's; "
        f"{r['keys_seen'] / r['seconds']:.1f} keys/s (parse included)")
    return {"card": r, "cpu_seconds": res["cpu"]["seconds"]}


def phase_darlin_apps(dev, labels, keys, vals) -> dict:
    """Phase 15: darlin at RCV1's shape on the card (one device, a world of
    one, a 2x2 world, convert and the cache), graph_partition and sketch
    through `cli train`; none launches K1-K4."""
    from parameter_server_tpu_torch.data.blockcache import ColumnBlocks
    from parameter_server_tpu_torch.ops import adagrad_kernels as ak
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.ops import quantize_kernels as qk

    t_phase = time.perf_counter()
    torch.cuda.synchronize()
    for k in (fk, ak, qk):
        k.reset_launches()
    t0 = time.perf_counter()
    rows = rcv1_rows(dev)
    t_rows = time.perf_counter() - t0
    t0 = time.perf_counter()
    cb = ColumnBlocks.from_batches(darlin_batches(rows, RCV1_EXAMPLES), DARLIN_KEYS,
                                   DARLIN_BLOCKS)
    t_blocks = time.perf_counter() - t0
    real = int((cb.values != 0).sum())
    out: dict = {"set_up": {"rows_seconds": t_rows, "blocks_seconds": t_blocks,
                            "entries": real, "e_max": cb.feat_local.shape[1],
                            "e_mean": real / cb.n_blocks}}
    log(f"darlin set-up: {RCV1_EXAMPLES} rows, {len(rows[2])} entries "
        f"({len(rows[2]) / RCV1_EXAMPLES:.2f} an example) drawn in {t_rows:.2f} s; "
        f"column blocks {cb.feat_local.shape} ({real} real entries, E_max "
        f"{cb.feat_local.shape[1]} vs mean {real / cb.n_blocks:.0f} a block) in "
        f"{t_blocks:.2f} s")
    out["single"] = darlin_single(dev, cb)
    out["world_of_one"] = darlin_world_of_one(cb, out["single"])
    del cb
    torch.cuda.empty_cache()
    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = Path(tmp_s)
        out["cli"] = darlin_cli(tmp, rows)
        out["graph"] = graph_partition_runs(tmp, labels, keys, vals)
        out["sketch"] = sketch_runs(tmp)
    launches = {**fk.LAUNCHES, **ak.LAUNCHES, **qk.LAUNCHES}
    if any(launches.values()):
        raise AssertionError(f"phase 15 launched {launches}, want no kernel")
    out["seconds"] = time.perf_counter() - t_phase
    log(f"darlin, sketch and graph_partition phase ok in {out['seconds']:.1f} s; "
        f"launches {launches}")
    return out


# ---------------------------------------------------------------------------
# phase 16: the native parser, the dynamic pool, tracing and the black box
# ---------------------------------------------------------------------------


def sync(device: str) -> None:
    if device == "cuda":
        torch.cuda.synchronize()


def criteo_file(path: Path, ids: np.ndarray, y: np.ndarray) -> Path:
    """Phase 13's rows in the Criteo layout: a row's first 13 ids as the
    integer columns, the other 19 as hex categorical columns, 7 left
    empty."""
    with open(path, "w") as f:
        for lab, row in zip(y, ids.tolist()):
            cats = [format(k, "x") for k in row[13:]] + [""] * (39 - len(row))
            f.write("\t".join([str(int(lab))] + [str(k) for k in row[:13]] + cats) + "\n")
    return path


def python_flat(fmt: str, path) -> tuple:
    """One file's flat rows (labels, splits, keys, vals, slots) from the
    port's Python row parsers (data/libsvm.py), as the reader's Python path
    builds them."""
    from parameter_server_tpu_torch.data.libsvm import iter_format
    from parameter_server_tpu_torch.data.native import SLOTLESS_FORMATS

    labels, lens, keys, vals, slots = [], [], [], [], []
    for label, k, v, s in iter_format(fmt, path):
        labels.append(label)
        lens.append(len(k))
        keys.append(k)
        vals.append(v)
        slots.append(s)
    return (np.asarray(labels, np.float32),
            np.concatenate([[0], np.cumsum(lens)]).astype(np.int64),
            np.concatenate(keys).astype(np.uint64), np.concatenate(vals).astype(np.float32),
            None if fmt in SLOTLESS_FORMATS else np.concatenate(slots).astype(np.uint64))


def native_flat(native, fmt: str, path) -> tuple:
    """One file's native chunks joined into one flat tuple."""
    chunks = list(native.iter_chunks(path, fmt))
    splits, base = [np.zeros(1, np.int64)], 0
    for c in chunks:
        splits.append(c[1][1:] + base)
        base += int(c[1][-1])
    return (np.concatenate([c[0] for c in chunks]), np.concatenate(splits),
            np.concatenate([c[2] for c in chunks]), np.concatenate([c[3] for c in chunks]),
            None if chunks[0][4] is None else np.concatenate([c[4] for c in chunks]))


def check_flat(name: str, got: tuple, want: tuple) -> None:
    """Labels, splits, keys and slots bit for bit; values within NATIVE_RTOL."""
    for field, a, b in zip(("labels", "splits", "keys", "vals", "slots"), got, want):
        if b is None:
            if a is not None:
                raise AssertionError(f"{name}: native slots where the Python parser has none")
        elif a.dtype != b.dtype or a.shape != b.shape:
            raise AssertionError(f"{name} {field}: {a.dtype}{a.shape} vs {b.dtype}{b.shape}")
        elif field == "vals":
            if not np.allclose(a, b, rtol=NATIVE_RTOL, atol=0.0):
                raise AssertionError(f"{name} values differ beyond rtol {NATIVE_RTOL}")
        elif not np.array_equal(a, b):
            raise AssertionError(f"{name} {field} differ")


def phase_native(files: list, criteo: Path, device: str) -> dict:
    """Phase 16 (a): the native parser and localizer against the Python
    ones, their rates, and the linear worker fed by each."""
    from parameter_server_tpu_torch.data import native
    from parameter_server_tpu_torch.data.reader import MinibatchReader
    from parameter_server_tpu_torch.models.linear import LinearMethod
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.utils.hashing import hash_keys
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    t0 = time.perf_counter()
    if not native.native_available():
        raise AssertionError("native parser unavailable; g++ said:\n" + native.build_log())
    log(f"native parser built in {time.perf_counter() - t0:.2f} s: "
        f"{native.library_path().name} ({' '.join(native.CXX_FLAGS)})")
    out: dict = {"mb_per_s": {}}
    for fmt, paths in (("libsvm", files), ("criteo", [criteo])):
        nbytes = sum(p.stat().st_size for p in paths)
        t0 = time.perf_counter()
        nat = [native_flat(native, fmt, p) for p in paths]
        t_nat = time.perf_counter() - t0
        t0 = time.perf_counter()
        py = [python_flat(fmt, p) for p in paths]
        t_py = time.perf_counter() - t0
        for p, a, b in zip(paths, nat, py):
            check_flat(f"native {fmt} {p.name}", a, b)
        out["mb_per_s"][fmt] = {"native": nbytes / t_nat / 1e6, "python": nbytes / t_py / 1e6,
                                "bytes": nbytes, "rows": sum(len(a[0]) for a in nat),
                                "entries": sum(len(a[2]) for a in nat)}
        log(f"native parse {fmt}: {len(paths)} file(s), {nbytes} bytes, "
            f"{out['mb_per_s'][fmt]['rows']} rows, equal to the Python parser (values "
            f"within rtol {NATIVE_RTOL}); native {t_nat:.3f} s "
            f"({out['mb_per_s'][fmt]['native']:.1f} MB/s), Python {t_py:.3f} s "
            f"({out['mb_per_s'][fmt]['python']:.1f} MB/s)")
    # the localizer at the worker's width: one file's BATCH x NNZ_PER keys
    keys = native_flat(native, "libsvm", files[0])[2]
    t0 = time.perf_counter()
    got = native.hash_localize(keys, None, WORKER_KEYS)
    t_loc = time.perf_counter() - t0
    t0 = time.perf_counter()
    want = np.unique(hash_keys(keys, WORKER_KEYS, slot_ids=0), return_inverse=True)
    t_np = time.perf_counter() - t0
    if got is None or not (np.array_equal(got[0], want[0]) and np.array_equal(got[1], want[1])):
        raise AssertionError("native hash_localize differs from the numpy localizer")
    out["localize"] = {"entries": len(keys), "unique": len(got[0]), "native_s": t_loc,
                       "numpy_s": t_np}
    log(f"native hash_localize of {len(keys)} keys into {WORKER_KEYS}: {len(got[0])} unique, "
        f"equal to numpy's; {t_loc * 1e3:.2f} ms native, {t_np * 1e3:.2f} ms numpy")
    # the linear worker at phase 4's width, fed by each parser
    cfg = worker_cfg()
    hist, launches, secs = {}, {}, {}
    for backend in ("python", "native"):
        rep = ProgressReporter(print_fn=lambda s: None)
        app = LinearMethod(cfg, reporter=rep, device=device)
        reader = MinibatchReader([str(f) for f in files], "libsvm", app.make_builder(),
                                 backend=backend)
        sync(device)
        fk.reset_launches()
        t0 = time.perf_counter()
        app.train(reader, report_every=1)
        sync(device)
        secs[backend] = time.perf_counter() - t0
        launches[backend] = fk.LAUNCHES["ftrl_delta"]
        hist[backend] = rep.history
        del app
    steps = len(hist["native"])
    if steps != len(files) or len(hist["python"]) != steps:
        raise AssertionError(f"native-fed worker: {steps} steps, Python-fed "
                             f"{len(hist['python'])}, want {len(files)}")
    if launches["native"] != steps:
        raise AssertionError(f"native-fed worker launched ftrl_delta {launches['native']} "
                             f"times in {steps} steps")
    for step, (a, b) in enumerate(zip(hist["native"][:E2E_STEPS], hist["python"])):
        if not np.isclose(a["objv"], b["objv"], rtol=E2E_RTOL, atol=0.0):
            raise AssertionError(f"native-fed worker step {step}: loss {a['objv']} vs the "
                                 f"Python-fed {b['objv']}")
    out["worker"] = {b: {"seconds": secs[b], "step_s": secs[b] / steps,
                         "ex_per_s": steps * BATCH / secs[b], "launches": launches[b]}
                     for b in secs}
    out["launches"] = {"native_worker_ftrl_delta": launches["native"]}
    log(f"native-fed worker ok: {steps} steps of {BATCH} (parse included) in "
        f"{secs['native']:.3f} s native vs {secs['python']:.3f} s Python-fed; the first "
        f"{E2E_STEPS} losses agree within E2E_RTOL; ftrl_delta launched once a step")
    return out


def pool_cli_ranks(root: Path, tmp: Path, files: list, val: Path, device: str) -> list:
    """A 2x1 world of `cli train --pool_coordinator --pool_serve` ranks on
    ``device`` (gloo: the ranks share one card); rank 0 hosts the pool,
    under POOL_PLAN. Returns each rank's (progress rows, result)."""
    conf = cluster_conf(files, val, max_delay=1, epochs=POOL_EPOCHS)
    conf["parallel"] = {"data_shards": 2, "kv_shards": 1}
    app = tmp / "pool2x1.json"
    app.write_text(json.dumps(conf))
    store, pool = free_ports(2)
    env = {**os.environ, "PYTHONPATH": str(root), "OMP_NUM_THREADS": "1",
           "PS_FAULT_PLAN": POOL_PLAN, "PS_FAULT_SEED": str(POOL_SEED)}
    procs = []
    for r in range(2):
        argv = [sys.executable, "-m", "parameter_server_tpu_torch.cli", "train",
                "--app_file", str(app), "--device", device,
                "--coordinator", f"127.0.0.1:{store}", "--num_processes", "2",
                "--process_id", str(r), "--report_interval", "1",
                "--pool_coordinator", f"127.0.0.1:{pool}", "--pool_serve"]
        if device == "cuda":
            argv += ["--dist_backend", "gloo"]
        out, err = tmp / f"pool.{r}.out", tmp / f"pool.{r}.err"
        with open(out, "w") as fo, open(err, "w") as fe:
            procs.append((subprocess.Popen(argv, cwd=root, env=env, stdout=fo, stderr=fe),
                          out, err))
    deadline = time.perf_counter() + POOL_TIMEOUT_S
    try:
        while any(p.poll() is None for p, _, _ in procs):
            if any(p.poll() not in (None, 0) for p, _, _ in procs):
                break
            if time.perf_counter() > deadline:
                break
            time.sleep(0.1)
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                p.kill()
            p.wait()
    if any(p.returncode for p, _, _ in procs):
        raise AssertionError("pool 2x1 world failed:\n" + "\n".join(
            f"rank {r} (exit {p.returncode}): {err.read_text()[-1500:]}"
            for r, (p, _, err) in enumerate(procs)))
    res = []
    for p, out, _ in procs:
        lines = out.read_text().rstrip().splitlines()
        res.append((progress_rows(lines[:-1]), json.loads(lines[-1])))
    return res


def pool_rank_launches(results: list) -> int:
    """Every rank of the 2x1 pool world launched K1; returns their sum."""
    got = [r["launches"]["ftrl_push"] for _, r in results]
    if not all(n > 0 for n in got):
        raise AssertionError(f"pool 2x1 world: ftrl_push launches {got}")
    return sum(got)


def phase_pool(files: list, val: Path, tmp: Path, device: str) -> dict:
    """Phase 16 (b): PodTrainer.train_files_dynamic on a world of one
    against a Coordinator in a thread, beside train_files; then the 2x1
    `cli train` world under a plan on its pool Coordinator."""
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.parallel import runtime
    from parameter_server_tpu_torch.parallel.control import Coordinator
    from parameter_server_tpu_torch.parallel.trainer import PodTrainer
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    cfg = worker_cfg()
    cfg.solver.epochs = POOL_EPOCHS
    items = POOL_EPOCHS * len(files)
    paths = sorted(str(f) for f in files)
    out: dict = {"launches": {}}
    rt = runtime.init(None, cfg=cfg, device=device)  # NCCL on the card, a world of one
    port = free_ports(1)[0]
    coord = Coordinator("127.0.0.1", port)
    try:
        runs = {}
        for arm in ("dynamic", "static"):
            rep = ProgressReporter(print_fn=lambda s: None)
            t = PodTrainer(cfg, runtime=rt, reporter=rep)
            sync(device)
            fk.reset_launches()
            t0 = time.perf_counter()
            if arm == "dynamic":
                t.train_files_dynamic(paths, f"127.0.0.1:{port}", report_every=len(files))
            else:
                t.train_files(paths, report_every=len(files))
            sync(device)
            runs[arm] = {"seconds": time.perf_counter() - t0, "rows": rep.history,
                         "launches": fk.LAUNCHES["ftrl_push"],
                         "steps": t.clock.progress()["max_finished"] + 1,
                         "examples": t.examples_seen,
                         "weights": torch.from_numpy(t.full_weights().ravel())}
            del t
        st = coord._pool.stats()
    finally:
        coord.stop()
        rt.shutdown()
    dyn, static = runs["dynamic"], runs["static"]
    if (st["pending"], st["active"], st["done"], st["attempts"]) != (0, 0, items, items):
        raise AssertionError(f"pool world of one: pool stats {st}")
    if dyn["examples"] != items * BATCH:
        raise AssertionError(f"pool world of one: {dyn['examples']} examples, want "
                             f"{items * BATCH}")
    if dyn["launches"] != dyn["steps"] or dyn["steps"] < items:
        raise AssertionError(f"pool world of one: ftrl_push launched {dyn['launches']} "
                             f"times in {dyn['steps']} steps")
    err = check_e2e("pool world of one: dynamic vs static weights", dyn["weights"],
                    static["weights"])
    if len(dyn["rows"]) != len(static["rows"]):
        raise AssertionError(f"pool world of one: {len(dyn['rows'])} progress rows vs "
                             f"{len(static['rows'])}")
    for a, b in zip(dyn["rows"], static["rows"]):
        for key in ("objv", "auc"):
            if not np.isclose(a[key], b[key], rtol=E2E_RTOL, atol=0.0):
                raise AssertionError(f"pool world of one: {key} {a[key]} vs static {b[key]}")
    out["launches"]["pool_1x1_dynamic_ftrl_push"] = dyn["launches"]
    out["world_of_one"] = {
        "pool": st, "steps": dyn["steps"], "seconds": dyn["seconds"],
        "static_seconds": static["seconds"], "max_abs_err_over_scale": err,
        "objv": [r["objv"] for r in dyn["rows"]]}
    log(f"pool world of one ok: {items} items each done once ({st}); weights and epoch "
        f"rows equal train_files' within E2E_RTOL (max abs err {err:.3g} of scale); "
        f"ftrl_push once a step ({dyn['launches']} in {dyn['steps']} steps); "
        f"{dyn['seconds']:.3f} s dynamic vs {static['seconds']:.3f} s static")
    # the CLI world: 2 data rows share the pool by demand under the plan
    root = Path(__file__).resolve().parent
    t0 = time.perf_counter()
    ranks = pool_cli_ranks(root, tmp, files, val, device)
    t_world = time.perf_counter() - t0
    # rank 0's rows of real steps (a drained pod's inert steps print rows
    # that add no example)
    rows0 = [r for i, r in enumerate(ranks[0][0])
             if r["examples"] > (ranks[0][0][i - 1]["examples"] if i else 0)]
    for r, (_, res) in enumerate(ranks):
        if res["examples"] != items * BATCH or res["mesh"] != {"data": 2, "kv": 1}:
            raise AssertionError(f"pool 2x1 rank {r}: {res['examples']} examples on "
                                 f"{res['mesh']}, want {items * BATCH}")
    if ranks[0][1]["val_logloss"] != ranks[1][1]["val_logloss"]:
        raise AssertionError("pool 2x1: the ranks' replicas evaluate differently")
    if not rows0 or not rows0[-1]["objv"] < rows0[0]["objv"]:
        raise AssertionError(f"pool 2x1: loss did not fall: {[r.get('objv') for r in rows0]}")
    out["launches"]["pool_2x1_cli_ftrl_push"] = pool_rank_launches(ranks)
    out["cli_2x1"] = {"seconds": t_world, "objv_first": rows0[0]["objv"],
                      "objv_last": rows0[-1]["objv"], "val_auc": ranks[0][1]["val_auc"],
                      "rpc_retries": [res["rpc_retries"] for _, res in ranks],
                      "rpc_reconnects": [res["rpc_reconnects"] for _, res in ranks]}
    log(f"pool 2x1 cli world ok in {t_world:.1f} s: every workload done once pod-wide "
        f"({items * BATCH} examples on each rank), the replicas agree, loss "
        f"{rows0[0]['objv']:.6g} -> {rows0[-1]['objv']:.6g}, val AUC "
        f"{ranks[0][1]['val_auc']:.6f}; retries {out['cli_2x1']['rpc_retries']}, "
        f"reconnects {out['cli_2x1']['rpc_reconnects']}; ftrl_push on both ranks")
    return out


TERM_SERVER = """
import os, sys, time
sys.path.insert(0, sys.argv[1])
from parameter_server_tpu_torch.kv.updaters import Ftrl
from parameter_server_tpu_torch.parallel.multislice import ShardServer
from parameter_server_tpu_torch.utils import flightrec
from parameter_server_tpu_torch.utils.keyrange import KeyRange
flightrec.configure(os.environ[flightrec.BLACKBOX_DIR_ENV], process_name="server-term",
                    flush_interval_s=0.2)
srv = ShardServer(Ftrl(), KeyRange(0, int(sys.argv[2])), device=sys.argv[3]).start()
print("ADDR", srv.address, flush=True)
while True:
    time.sleep(1)
"""


def sigterm_server(root: Path, tmp: Path, device: str) -> dict:
    """A server process over the worker's key space, the flight recorder
    armed, takes TERM_PUSHES pushes of 4096 drawn keys and then SIGTERM:
    its dump is a psbb/1 box naming the signal, with the frames it received
    and its apply batches."""
    import signal

    from parameter_server_tpu_torch.parallel.multislice import ServerHandle
    from parameter_server_tpu_torch.utils.config import PSConfig

    rng = np.random.default_rng(SEED + 16)
    pushes = []
    for _ in range(TERM_PUSHES):
        k = np.unique(rng.integers(1, WORKER_KEYS, 4096))
        pushes.append((k, rng.normal(size=len(k)).astype(np.float32)))
    box = tmp / "bb-term"
    box.mkdir()
    env = {**os.environ, "PS_BLACKBOX_DIR": str(box)}
    p = subprocess.Popen([sys.executable, "-c", TERM_SERVER, str(root), str(WORKER_KEYS),
                          device], cwd=root, env=env, stdout=subprocess.PIPE,
                         stderr=subprocess.PIPE, text=True)
    try:
        line = p.stdout.readline()
        if not line.startswith("ADDR "):
            raise AssertionError(f"SIGTERM server did not start: {p.stderr.read()[-1500:]}")
        h = ServerHandle(line.split()[1], 0, 0, PSConfig(), range_size=WORKER_KEYS,
                         device=device)
        try:
            for k, g in pushes:
                h.push(k, g)
        finally:
            h.close()
        p.send_signal(signal.SIGTERM)
        code = p.wait(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.wait()
        p.stdout.close()
        p.stderr.close()
    if code != -signal.SIGTERM:
        raise AssertionError(f"SIGTERM server exited {code}")
    dumps = list(box.glob("blackbox-server-term-*.json"))
    if len(dumps) != 1:
        raise AssertionError(f"SIGTERM server left {dumps}")
    doc = json.loads(dumps[0].read_text())
    etypes = [e[2] for e in doc["events"]]
    need = {"rpc.in", "apply.begin", "apply.commit", "rcu.publish", "signal"}
    if doc["schema"] != "psbb/1" or f"signal:{int(signal.SIGTERM)}" not in doc[
            "trigger_reasons"] or not need <= set(etypes):
        raise AssertionError(f"SIGTERM dump: schema {doc['schema']}, reasons "
                             f"{doc['trigger_reasons']}, events {sorted(set(etypes))}")
    commits = etypes.count("apply.commit")
    if commits < len(pushes):
        raise AssertionError(f"SIGTERM dump: {commits} apply commits for {len(pushes)} pushes")
    log(f"SIGTERM server ok: {len(pushes)} pushes, then SIGTERM: a psbb/1 dump "
        f"({dumps[0].stat().st_size} bytes) naming signal {int(signal.SIGTERM)}, with "
        f"{etypes.count('rpc.in')} rpc.in, {etypes.count('apply.begin')} apply.begin and "
        f"{commits} apply.commit events")
    return {"events": len(etypes), "apply_commits": commits}


def phase_traced(files: list, val: Path, tmp: Path, rounds: list, model_a, device: str) -> dict:
    """Phase 16 (c): phase 13 (a)'s launch with tracing and the black box
    armed on every node; a SIGTERM'd server's box; phase 12 (a)'s pushes
    with both planes armed in this process beside the same unarmed."""
    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.parallel.backend import local_socket_backend
    from parameter_server_tpu_torch.parallel.multislice import launch_local
    from parameter_server_tpu_torch.utils import flightrec, trace
    from parameter_server_tpu_torch.utils.checkpoint import load_weights_text
    from parameter_server_tpu_torch.utils.config import PSConfig

    root = Path(__file__).resolve().parent
    out: dict = {"launches": {}}
    app = tmp / "traced.json"
    app.write_text(json.dumps(cluster_conf(files, val)))
    tdir, bdir = tmp / "trace", tmp / "bb"
    t0 = time.perf_counter()
    c = launch_local(str(app), CLUSTER_SERVERS, 1, model_out=str(tmp / "traced.txt"),
                     timeout=CLUSTER_TIMEOUT_S, device=device, trace_dir=str(tdir),
                     blackbox_dir=str(bdir))
    t_launch = time.perf_counter() - t0
    w = torch.from_numpy(load_weights_text(tmp / "traced.txt", WORKER_KEYS))
    err = check_e2e("traced cluster model vs phase 13 (a)'s untraced card model", w, model_a)
    out["launches"]["cluster_traced_ftrl_push"] = cluster_launches("traced cluster", c,
                                                                   "ftrl_push", 1)
    nodes = ["scheduler-0", "server-0", "server-1", "worker-0"]
    files_t = {n: list(tdir.glob(f"trace-{n}-*.json")) for n in nodes}
    boxes = {n: list(bdir.glob(f"blackbox-{n}-*.json")) for n in nodes}
    if not all(len(v) == 1 for v in (*files_t.values(), *boxes.values())):
        raise AssertionError(f"traced cluster: trace files {files_t}, boxes {boxes}")
    merged = json.loads(Path(trace.merge_trace_dir(str(tdir))).read_text())["traceEvents"]
    spans = [e for e in merged if e["ph"] == "X"]
    pids = {n: json.loads(files_t[n][0].read_text())["traceEvents"][0]["pid"] for n in nodes}
    by_pid = {pid: {e["name"] for e in spans if e["pid"] == pid} for pid in pids.values()}
    if not all(by_pid[pid] for pid in pids.values()):
        raise AssertionError(f"traced cluster: a node recorded no span: {by_pid}")
    client = {e["args"]["trace_id"]: e["args"]["span_id"] for e in spans
              if e["name"] == "rpc.push" and e["pid"] == pids["worker-0"]}
    joined = [e for e in spans if e["name"] == "rpc.serve.push"
              and e["pid"] in (pids["server-0"], pids["server-1"])
              and client.get(e["args"]["trace_id"]) == e["args"].get("parent_id")]
    if not joined:
        raise AssertionError("traced cluster: no server rpc.serve.push joined a worker "
                             "rpc.push's trace")
    for n in nodes:
        doc = json.loads(boxes[n][0].read_text())
        if doc["schema"] != "psbb/1" or not doc["events"]:
            raise AssertionError(f"traced cluster: {n}'s box {doc['schema']}, "
                                 f"{len(doc['events'])} events")
    out["cluster"] = {"seconds": t_launch, "max_abs_err_over_scale": err, "spans": len(spans),
                      "joined_pushes": len(joined), "span_names": sorted(
                          {e["name"] for e in spans}),
                      "apply_batches": [st["apply_batches"] for st in c["server_stats"]]}
    log(f"traced cluster ok in {t_launch:.1f} s: {len(spans)} spans from all 4 nodes; "
        f"{len(joined)} pushes carry one trace id from the worker's rpc.push into a "
        f"server's rpc.serve.push; 4 psbb/1 boxes; the model equals phase 13 (a)'s "
        f"untraced card model (max abs err {err:.3g} of scale); K1 = apply batches "
        f"{out['cluster']['apply_batches']}")
    out["sigterm"] = sigterm_server(root, tmp, device)
    pushes = [(k, g) for idx_list, grad_list in rounds for k, g in zip(idx_list, grad_list)]

    # phase 12 (a)'s pushes, unarmed and then with both planes armed here
    def ftrl():
        return Ftrl(alpha=HYPER["alpha"], beta=HYPER["beta"], lambda_l1=HYPER["l1"],
                    lambda_l2=HYPER["l2"])

    out["wire"] = {}
    for arm in ("unarmed", "armed"):
        if arm == "armed":
            trace.configure(str(tmp / "trace-wire"), process_name="wire")
            flightrec.configure(str(tmp / "bb-wire"), process_name="wire",
                                watchdog_interval_s=60)
        be = local_socket_backend(ftrl, SERVER_KEYS, WIRE_SERVERS, cfg=PSConfig(),
                                  device=device)
        try:
            res = wire_deterministic(f"FTRL server {arm}", be, pushes, ftrl, 1, "ftrl_push",
                                     fk.LAUNCHES, IndexAudit())
        finally:
            be.close()
            if arm == "armed":
                res["spans"] = len(trace.tracer.events())
                res["events"] = len(flightrec.events())
                trace.configure(None)
                flightrec.configure(None)
        out["wire"][arm] = res
        out["launches"][f"wire_{arm}_ftrl_push"] = res["launches"]
        del be
        if device == "cuda":
            torch.cuda.empty_cache()
    wu, wa = out["wire"]["unarmed"], out["wire"]["armed"]
    log(f"wire pushes, tracing and the recorder armed: {wa['pushes_per_s']:.1f} pushes/s "
        f"(p50 {wa['latency']['p50_ms']:.3f} / p99 {wa['latency']['p99_ms']:.3f} ms; "
        f"{wa['spans']} trace events, {wa['events']} recorder events) beside "
        f"{wu['pushes_per_s']:.1f} pushes/s unarmed (p50 {wu['latency']['p50_ms']:.3f} / "
        f"p99 {wu['latency']['p99_ms']:.3f} ms), {len(pushes)} pushes each (logged, not "
        f"gated)")
    return out


def phase_native_pool_traced(rounds: list, model_a, device: str = "cuda") -> dict:
    """Phase 16: (a) the native parser, (b) the dynamic pool, (c) tracing
    and the black box, over phase 13's files."""
    t_phase = time.perf_counter()
    ids, y = zipf_rows()
    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = Path(tmp_s)
        files = zipf_row_files(tmp, ids, y, with_val=True)
        files, val = files[:-1], files[-1]
        criteo = criteo_file(tmp / "rows.criteo", ids[:len(files) * BATCH],
                             y[:len(files) * BATCH])
        out = {"native": phase_native(files, criteo, device)}
        if device == "cuda":
            torch.cuda.empty_cache()
        out["pool"] = phase_pool(files, val, tmp, device)
        if device == "cuda":
            torch.cuda.empty_cache()
        out["traced"] = phase_traced(files, val, tmp, rounds, model_a, device)
    out["launches"] = {**out["native"]["launches"], **out["pool"]["launches"],
                       **out["traced"]["launches"]}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 16 ok in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


def spawn_node(root: Path, logs: Path, role: str, rank: int, sched: str, app: Path,
               servers: int, workers: int, model_out: str = "") -> subprocess.Popen:
    """One `cli node` process on the card, its output in ``logs``."""
    cmd = [sys.executable, "-m", "parameter_server_tpu_torch.cli", "node", "--role", role,
           "--rank", str(rank), "--scheduler", sched, "--num_servers", str(servers),
           "--num_workers", str(workers), "--app_file", str(app), "--device", "cuda"]
    if model_out:
        cmd += ["--model_out", model_out]
    env = {**os.environ, "PYTHONPATH": str(root)}
    out = open(logs / f"{role}-{rank}.out", "w")
    err = open(logs / f"{role}-{rank}.err", "w")
    p = subprocess.Popen(cmd, stdout=out, stderr=err, text=True, env=env, cwd=str(root))
    out.close()
    err.close()
    return p


def cli_run(argv: list[str]) -> tuple[int, str]:
    """One port CLI command in this process: its exit code and stdout."""
    import io

    from parameter_server_tpu_torch import cli

    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    return rc, buf.getvalue()


def live_checks(sched: str, mport: int, servers: int) -> dict:
    """Phase 17 (a)'s checks against the live scheduler, once every node's
    ring holds LIVE_MIN_BEATS beats and its pushes."""
    import urllib.request

    from parameter_server_tpu_torch.parallel.control import ControlClient

    ctl = ControlClient(sched, retries=60, retry_delay=0.5, reconnect_timeout_s=30.0)
    t0 = time.perf_counter()
    try:
        while True:
            rep = ctl.telemetry(window_s=60.0)
            nodes = rep.get("nodes") or {}
            ready = len(nodes) == servers + 1 and all(
                (rep["series"].get(nid) or {}).get("samples", 0) >= LIVE_MIN_BEATS
                and ((rep["series"][nid].get("hist_rates") or {}).get(
                    "server.push" if n["role"] == "server" else "client.push", 0) > 0)
                for nid, n in nodes.items())
            if ready:
                break
            if time.perf_counter() - t0 > LIVE_WAIT_S:
                raise AssertionError(f"live: nodes not ready after {LIVE_WAIT_S} s: "
                                     f"{ {k: v.get('samples') for k, v in rep['series'].items()} }")
            time.sleep(0.1)
        t_ready = time.perf_counter() - t0
        stacks = {n["rank"]: (n.get("telemetry") or {}).get("prof") or []
                  for n in nodes.values() if n["role"] == "server"}
    finally:
        ctl.close()
    out: dict = {"ready_s": t_ready}
    t1 = time.perf_counter()
    rc, text = cli_run(["stats", "--scheduler", sched])
    st = json.loads(text.strip().splitlines()[-1])
    lat = st["latency_ms"]
    if not (rc == 0 and st["nodes"] == servers + 1
            and lat.get("client.push", {}).get("count", 0) > 0
            and lat.get("server.push", {}).get("count", 0) > 0):
        raise AssertionError(f"live cli stats: rc {rc}, {st['nodes']} nodes, latency {lat}")
    out["stats"] = {"nodes": st["nodes"], "client_push": lat["client.push"],
                    "server_push": lat["server.push"]}
    rc, text = cli_run(["top", "--scheduler", sched, "--json"])
    top = json.loads(text)
    rows = {}
    for nid, n in top["nodes"].items():
        s = top["series"][nid]
        verb = "server.push" if n["role"] == "server" else "client.push"
        rows[f"{n['role']}-{n['rank']}"] = {
            "push_per_s": s["hist_rates"].get(verb, 0.0),
            "p99_push_ms": s["p99"].get(verb, 0.0),
            "health": top["health"][nid]["score"]}
    if not (rc == 0 and top["alerts"] == [] and len(rows) == servers + 1 and all(
            r["push_per_s"] > 0 and r["health"] == 100 for r in rows.values())):
        raise AssertionError(f"live cli top: rc {rc}, rows {rows}, alerts {top['alerts']}")
    out["top"] = rows
    rc, text = cli_run(["ranges", "--scheduler", sched, "--json"])
    rng = json.loads(text)["ranges"]
    tiles = sorted((int(b), int(e)) for b, e in (k.split("-") for k in rng if k != "other"))
    if not (rc == 0 and tiles[0][0] == 0 and tiles[-1][1] == WORKER_KEYS
            and len(tiles) == servers
            and all(a[1] == b[0] for a, b in zip(tiles, tiles[1:]))
            and all(rng[f"{b}-{e}"].get("push_rate", 0) > 0
                    and rng[f"{b}-{e}"].get("apply_p99_ms", 0) > 0 for b, e in tiles)):
        raise AssertionError(f"live cli ranges: rc {rc}, {rng}")
    out["ranges"] = rng
    rc, text = cli_run(["audit", "--scheduler", sched, "--once", "--json"])
    aud = json.loads(text)
    streams = {k: v.get("batches", 0) for k, v in aud["nodes"].items()}
    if not (rc == 0 and aud["total"] == 0 and all(
            streams.get(nid, 0) > 0 for nid in top["nodes"])):
        raise AssertionError(f"live cli audit: rc {rc}, total {aud['total']}, batches "
                             f"{streams}, nodes {sorted(top['nodes'])}")
    out["audit"] = {"total": aud["total"], "batches": streams}
    rc, text = cli_run(["whylate", "--scheduler", sched, "--json"])
    why = json.loads(text)
    slow = why["cmds"].get("push", {}).get("slowest") or []
    if not (rc == 0 and slow and all(op.get("segments") for op in slow)):
        raise AssertionError(f"live cli whylate: rc {rc}, push records {slow}")
    out["whylate"] = slow[0]
    # server 0's endpoint: base + 1 unless that port was taken, when it
    # walked up; its /healthz names the process and the port it bound
    for port in range(mport + 1, mport + 1 + 8):
        try:
            with urllib.request.urlopen(f"http://127.0.0.1:{port}/healthz", timeout=10) as r:
                if json.loads(r.read().decode()).get("proc") == "server-0":
                    break
        except OSError:
            pass
    else:
        raise AssertionError(f"live: no /healthz of server-0 at ports {mport + 1}..")
    with urllib.request.urlopen(f"http://127.0.0.1:{port}/metrics", timeout=10) as r:
        scrape = r.read().decode()
    info = 'ps_build_info{proc="server-0",package="parameter_server_tpu_torch"'
    pushes = [ln for ln in scrape.splitlines() if ln.startswith("ps_range_push_total{")]
    if info not in scrape or not pushes or float(pushes[0].rsplit(" ", 1)[1]) <= 0:
        raise AssertionError(f"live scrape of server-0: build info {info in scrape}, "
                             f"push counters {pushes}")
    out["scrape"] = {"bytes": len(scrape), "push_counter": pushes[0]}
    out["checks_s"] = time.perf_counter() - t1
    for rank, st_ in sorted(stacks.items()):
        log(f"live: server-{rank}'s top profiler stacks (not gated): "
            f"{[(p['n'], p['s'][-100:]) for p in st_[:3]]}")
    log(f"live checks ok {out['checks_s']:.2f} s after the nodes were ready "
        f"({t_ready:.1f} s): stats {servers + 1} nodes, client.push "
        f"{lat['client.push']}, server.push {lat['server.push']}; top {rows}; ranges tile "
        f"[0, {WORKER_KEYS}) in {tiles}; audit total 0, batches {streams}; whylate slowest "
        f"push {slow[0]['dur_ms']} ms {slow[0]['segments']}; scrape {pushes[0]}")
    return out


def live_cluster(root: Path, tmp: Path, files: list, val: Path) -> dict:
    """Phase 17 (a) and (b): the armed cluster, its live checks, and after
    it the offline tools and the model against the unarmed launch."""
    from concurrent.futures import ThreadPoolExecutor

    from parameter_server_tpu_torch.analysis.critpath import SEGMENTS, load_trace_dir
    from parameter_server_tpu_torch.parallel.multislice import launch_local
    from parameter_server_tpu_torch.utils.checkpoint import load_weights_text

    # the scheduler's endpoint at mport, server r's at mport + 1 + r, the
    # worker's after them
    mport = free_port_block(CLUSTER_SERVERS + 2)
    sched_port = next(p for p in iter(lambda: free_ports(1)[0], None)
                      if not mport <= p < mport + CLUSTER_SERVERS + 2)
    sched = f"127.0.0.1:{sched_port}"
    tdir, bdir, logs = tmp / "live-trace", tmp / "live-bb", tmp / "live-logs"
    logs.mkdir()
    conf = cluster_conf(files, val, epochs=LIVE_EPOCHS,
                        fault={"heartbeat_interval_s": LIVE_BEAT_S})
    plain = tmp / "live-unarmed.json"
    plain.write_text(json.dumps(conf))
    armed = tmp / "live-armed.json"
    armed.write_text(json.dumps({
        **conf, "timeseries": {"metrics_port": mport},
        "profile": {"hz": LIVE_PROFILE_HZ}, "audit": {"enabled": True},
        "trace": {"trace_dir": str(tdir)}, "blackbox": {"dir": str(bdir)}}))
    out: dict = {"launches": {}}
    t0 = time.perf_counter()
    pool = ThreadPoolExecutor(1)
    unarmed = pool.submit(launch_local, str(plain), CLUSTER_SERVERS, 1,
                          model_out=str(tmp / "live-unarmed.txt"),
                          timeout=CLUSTER_TIMEOUT_S, device="cuda")
    procs = {"scheduler-0": spawn_node(root, logs, "scheduler", 0, sched, armed,
                                       CLUSTER_SERVERS, 1, str(tmp / "live-armed.txt"))}
    for r in range(CLUSTER_SERVERS):
        procs[f"server-{r}"] = spawn_node(root, logs, "server", r, sched, armed,
                                          CLUSTER_SERVERS, 1)
    procs["worker-0"] = spawn_node(root, logs, "worker", 0, sched, armed, CLUSTER_SERVERS, 1)
    try:
        out["live"] = live_checks(sched, mport, CLUSTER_SERVERS)
        for tag, p in procs.items():
            rc = p.wait(timeout=max(CLUSTER_TIMEOUT_S - (time.perf_counter() - t0), 1))
            if rc != 0:
                raise AssertionError(f"live cluster: {tag} exited {rc}:\n"
                                     f"{(logs / (tag + '.err')).read_text()[-2000:]}")
        ref = unarmed.result(timeout=CLUSTER_TIMEOUT_S)
    finally:
        for p in procs.values():
            if p.poll() is None:
                p.kill()
                p.wait()
        pool.shutdown(wait=True)
    t_run = time.perf_counter() - t0
    reports = {tag: json.loads((logs / f"{tag}.out").read_text().strip().splitlines()[-1])
               for tag in procs}
    res = {**reports.pop("scheduler-0"), "nodes": reports}
    out["launches"]["live_cluster_ftrl_push"] = cluster_launches("live cluster", res,
                                                                 "ftrl_push", 1)
    out["launches"]["live_unarmed_ftrl_push"] = cluster_launches("live unarmed", ref,
                                                                 "ftrl_push", 1)
    w = torch.from_numpy(load_weights_text(tmp / "live-armed.txt", WORKER_KEYS))
    w_ref = torch.from_numpy(load_weights_text(tmp / "live-unarmed.txt", WORKER_KEYS))
    err = check_e2e("live armed cluster model vs the same launch unarmed", w, w_ref)
    # (b) after the run: whylate over the trace dir (a worker step is one
    # trace, its pull the op's root, its pushes inside it, as in the JAX
    # package) and over the boxes (one op a push, from the cid/seq chain),
    # postmortem over the boxes
    rc, text = cli_run(["whylate", str(tdir), "--json"])
    why = json.loads(text)
    steps = (why["cmds"].get("pull") or {}).get("slowest") or []
    evs = load_trace_dir(str(tdir))
    pid = {tag: json.loads(next(tdir.glob(f"trace-{tag}-*.json")).read_text())[
        "traceEvents"][0]["pid"] for tag in procs}
    server_pids = {pid[f"server-{r}"] for r in range(CLUSTER_SERVERS)}
    pushed = {e["args"]["trace_id"] for e in evs if e.get("ph") == "X"
              and e["name"] == "ps.push" and e["pid"] == pid["worker-0"]}
    stitched = {e["args"]["trace_id"] for e in evs if e.get("ph") == "X"
                and e["name"] == "rpc.serve.push" and e["pid"] in server_pids} & pushed
    if not (rc == 0 and why["mode"] == "trace" and steps and pushed and stitched == pushed
            and all("server" in op["segments"] and set(op["segments"]) <= set(SEGMENTS)
                    for op in steps)):
        raise AssertionError(f"live whylate {tdir}: rc {rc}, mode {why.get('mode')}, "
                             f"{len(stitched)} of {len(pushed)} pushing traces reach a "
                             f"server, step ops {steps}")
    rc, text = cli_run(["whylate", str(bdir), "--json"])
    whyb = json.loads(text)
    push = whyb["cmds"].get("push") or {}
    slow = push.get("slowest") or []
    if not (rc == 0 and whyb["mode"] == "blackbox" and slow
            and all(set(op["segments"]) <= set(SEGMENTS) and "server" in op["segments"]
                    for op in slow)):
        raise AssertionError(f"live whylate {bdir}: rc {rc}, mode {whyb.get('mode')}, "
                             f"push {push}")
    rc, text = cli_run(["postmortem", str(bdir)])
    pm = json.loads(text.strip().splitlines()[-1])
    if rc != 0 or pm["anomalies"] or pm["processes"] != CLUSTER_SERVERS + 2:
        raise AssertionError(f"live postmortem {bdir}: rc {rc}, {pm['processes']} boxes, "
                             f"anomalies {pm['anomalies']}")
    out["offline"] = {"whylate_traced_steps": why["cmds"]["pull"]["n"],
                      "whylate_stitched_push_traces": len(stitched),
                      "whylate_slowest_step": steps[0],
                      "whylate_pushes": push["n"], "whylate_attribution_pct":
                      push.get("attribution_pct"), "whylate_slowest": slow[0],
                      "postmortem_boxes": pm["processes"], "postmortem_events": pm["events"],
                      "cross_process_calls": pm["cross_process_calls"]}
    out["cluster"] = {"seconds": t_run, "max_abs_err_over_scale": err,
                      "apply_batches": [st["apply_batches"] for st in res["server_stats"]],
                      "unarmed_apply_batches": [st["apply_batches"]
                                                for st in ref["server_stats"]]}
    log(f"live cluster ok in {t_run:.1f} s ({LIVE_EPOCHS} epochs, armed and unarmed at "
        f"once): the model equals the unarmed launch's (max abs err {err:.3g} of scale); "
        f"K1 = apply batches {out['cluster']['apply_batches']} (unarmed "
        f"{out['cluster']['unarmed_apply_batches']}); whylate over the trace dir: "
        f"{len(stitched)} of {len(pushed)} traces with a worker push reach a server's "
        f"rpc.serve.push, slowest step {steps[0]['dur_ms']} ms {steps[0]['segments']}; "
        f"over the boxes {push['n']} pushes, slowest {slow[0]['dur_ms']} ms "
        f"{slow[0]['segments']}; postmortem of {pm['processes']} boxes ({pm['events']} "
        f"events, {pm['cross_process_calls']} cross-process calls): no anomaly")
    return out


def arming_cost(rounds: list, tmp: Path, smi: str) -> dict:
    """Phase 17 (c): phase 12 (a)'s pushes through 2 card servers in this
    process, unarmed and with every plane armed (the metrics endpoint, the
    profiler, the audit spool, tracing, the recorder), in turn."""
    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.parallel.backend import local_socket_backend
    from parameter_server_tpu_torch.utils import flightrec, profiler, timeseries, trace
    from parameter_server_tpu_torch.utils.config import AuditConfig, PSConfig

    def ftrl():
        return Ftrl(alpha=HYPER["alpha"], beta=HYPER["beta"], lambda_l1=HYPER["l1"],
                    lambda_l2=HYPER["l2"])

    pushes = [(k, g) for idx_list, grad_list in rounds for k, g in zip(idx_list, grad_list)]
    pushes = (pushes * -(-LIVE_ARM_PUSHES // len(pushes)))[:LIVE_ARM_PUSHES]
    acfg = AuditConfig()
    runs: dict = {"unarmed": [], "armed": []}
    launches = {"unarmed": 0, "armed": 0}
    for rep in range(LIVE_ARM_REPEATS):
        for arm in ("unarmed", "armed"):
            msrv = None
            if arm == "armed":
                trace.configure(str(tmp / f"arm-trace-{rep}"), process_name="wire")
                flightrec.configure(str(tmp / f"arm-bb-{rep}"), process_name="wire",
                                    watchdog_interval_s=60)
                flightrec.configure_spool(acfg.spool_capacity, acfg.batch_events)
                profiler.configure(LIVE_PROFILE_HZ, process_name="wire")
                msrv = timeseries.start_metrics_server(0, process_name="wire")
            be = local_socket_backend(ftrl, SERVER_KEYS, WIRE_SERVERS, cfg=PSConfig(),
                                      device="cuda")
            try:
                res = wire_deterministic(f"FTRL server {arm} ({rep + 1})", be, pushes, ftrl,
                                         1, "ftrl_push", fk.LAUNCHES, IndexAudit())
            finally:
                be.close()
                if arm == "armed":
                    msrv.close()
                    profiler.configure(0)
                    flightrec.configure_spool(None)
                    trace.configure(None)
                    flightrec.configure(None)
            runs[arm].append({"pushes_per_s": res["pushes_per_s"], **res["latency"]})
            launches[arm] += res["launches"]
            del be
            torch.cuda.empty_cache()
    for arm, rs in runs.items():
        log(f"arming cost ({smi}): {arm}: " + "; ".join(
            f"{r['pushes_per_s']:.1f} pushes/s, p50 {r['p50_ms']:.3f} / p99 "
            f"{r['p99_ms']:.3f} ms" for r in rs) + f" ({LIVE_ARM_PUSHES} pushes a run; "
            f"logged, not gated)")
    return {"runs": runs, "launches": {f"arming_{k}_ftrl_push": v
                                       for k, v in launches.items()}}


def phase_live(rounds: list, smi: str) -> dict:
    """Phase 17: the live operations plane, the audit plane and the
    forensics tools on a card cluster, and what arming them costs."""
    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    ids, y = zipf_rows()
    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = Path(tmp_s)
        files = zipf_row_files(tmp, ids, y, with_val=True)
        files, val = files[:-1], files[-1]
        out = live_cluster(root, tmp, files, val)
        torch.cuda.empty_cache()
        out["arming"] = arming_cost(rounds, tmp, smi)
    out["launches"].update(out["arming"].pop("launches"))
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 17 ok in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 18: the analysis plane (pslint, the runtime lock-order witness)
# ---------------------------------------------------------------------------


def witnessed_cluster(files: list, val: Path, tmp: Path, model_a, device: str) -> dict:
    """Phase 18 (b), with phase 19 (c): phase 13 (a)'s launch with the
    lock-order witness and the race witness armed in this process
    (launch_local exports both to every node it spawns), then the same
    launch unarmed. Gates: no inversion in any node (each node's witness
    report, and no LockOrderViolation in any log), no race in any node
    (each node's race witness report, and no [racewitness] line in any
    log; the servers and the worker tracked their shared objects), the
    armed model equal to phase 13 (a)'s (E2E_RTOL), K1 once an apply batch
    on each card server. Logged: each node's witnessed edges and how many
    the static graph lacks, each node's start-up and each server's kernel
    library load and first apply, armed and unarmed."""
    from parameter_server_tpu_torch.analysis import racewitness, witness
    from parameter_server_tpu_torch.parallel.multislice import launch_local
    from parameter_server_tpu_torch.utils.checkpoint import load_weights_text

    app = tmp / "witness.json"
    app.write_text(json.dumps(cluster_conf(files, val)))
    out: dict = {"launches": {}}
    for arm in ("armed", "unarmed"):
        logs = tmp / f"witness-logs-{arm}"
        if arm == "armed":
            witness.install()
            racewitness.install()
        t0 = time.perf_counter()
        try:
            c = launch_local(str(app), CLUSTER_SERVERS, 1, model_out=str(tmp / f"{arm}.txt"),
                             timeout=CLUSTER_TIMEOUT_S, device=device, log_dir=str(logs))
        finally:
            if arm == "armed":
                racewitness.uninstall()
                witness.uninstall()
        seconds = time.perf_counter() - t0
        w = torch.from_numpy(load_weights_text(tmp / f"{arm}.txt", WORKER_KEYS))
        err = check_e2e(f"witness cluster ({arm}) model vs phase 13 (a)'s card model", w,
                        model_a)
        out["launches"][f"witness_{arm}_ftrl_push"] = cluster_launches(
            f"witness cluster ({arm})", c, "ftrl_push", 1)
        reps = {tag: n.get("witness") for tag, n in c["nodes"].items() if tag != "scheduler-0"}
        reps["scheduler-0"] = c.get("witness")
        races = {tag: n.get("race_witness") for tag, n in c["nodes"].items()
                 if tag != "scheduler-0"}
        races["scheduler-0"] = c.get("race_witness")
        if arm == "armed":
            if not all(reps.values()) or not all(races.values()):
                raise AssertionError(f"witness cluster: a node ran unarmed: {reps} {races}")
            bad = {t: r["violations"] for t, r in reps.items() if r["violations"]}
            if bad:
                raise AssertionError(f"witness cluster: lock-order inversions {bad}")
            bad = {t: r for t, r in races.items()
                   if r["races"] or (t != "scheduler-0" and not r["tracked"])}
            if bad:
                raise AssertionError(f"witness cluster: races, or nothing tracked: {bad}")
        elif any(reps.values()) or any(races.values()):
            raise AssertionError(f"witness cluster: an unarmed node armed: {reps} {races}")
        hits = [f.name for f in logs.iterdir()
                if any(w in f.read_text() for w in ("LockOrderViolation", "[racewitness]"))]
        if hits:
            raise AssertionError(f"witness cluster ({arm}): an inversion or a race in {hits}")
        servers = {tag: n for tag, n in c["nodes"].items() if tag.startswith("server")}
        out[arm] = {
            "seconds": seconds, "max_abs_err_over_scale": err,
            "startup_s": {tag: n["t_register"] - n["spawn_time"]
                          for tag, n in c["nodes"].items() if "t_register" in n},
            "kernel_load_s": {tag: n["kernel_load_s"] for tag, n in servers.items()},
            "first_apply_s": {tag: n["first_apply_s"] for tag, n in servers.items()},
            "apply_batches": [st["apply_batches"] for st in c["server_stats"]],
            "witness": {t: r and {k: r[k] for k in ("edges", "not_static", "violations",
                                                    "static_edges", "seed_s",
                                                    "not_static_edges")}
                        for t, r in reps.items()},
            "race_witness": races}
        o = out[arm]
        log(f"witness cluster {arm} ok in {seconds:.1f} s: model equals phase 13 (a)'s "
            f"(max abs err {err:.3g} of scale); K1 = apply batches {o['apply_batches']}; "
            f"start-up {json.dumps({k: round(v, 3) for k, v in o['startup_s'].items()})} s; "
            f"servers' kernel library load {o['kernel_load_s']} s, first apply "
            f"{o['first_apply_s']} s")
        if arm == "armed":
            for t, r in sorted(reps.items()):
                log(f"witness {t}: {r['edges']} edges witnessed, {r['not_static']} not in "
                    f"the static graph {r['not_static_edges']}, {r['violations']} "
                    f"inversions; seeded {r['static_edges']} static edges in "
                    f"{r['seed_s']:.2f} s")
            for t, r in sorted(races.items()):
                log(f"race witness {t}: {r['tracked']} fields tracked on {r['classes']}, "
                    f"{r['races']} races")
    return out


def witness_arming_cost(rounds: list, smi: str, device: str) -> dict:
    """Phase 18 (c): phase 12 (a)'s pushes through 2 card servers in this
    process, unarmed and with the lock-order witness armed (the servers'
    locks constructed under it), in turn."""
    from parameter_server_tpu_torch.analysis import witness
    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.parallel.backend import local_socket_backend
    from parameter_server_tpu_torch.utils.config import PSConfig

    def ftrl():
        return Ftrl(alpha=HYPER["alpha"], beta=HYPER["beta"], lambda_l1=HYPER["l1"],
                    lambda_l2=HYPER["l2"])

    pushes = [(k, g) for idx_list, grad_list in rounds for k, g in zip(idx_list, grad_list)]
    pushes = (pushes * -(-LIVE_ARM_PUSHES // len(pushes)))[:LIVE_ARM_PUSHES]
    runs: dict = {"unarmed": [], "armed": []}
    launches = {"unarmed": 0, "armed": 0}
    for rep in range(LIVE_ARM_REPEATS):
        for arm in ("unarmed", "armed"):
            if arm == "armed":
                witness.install()
            try:
                be = local_socket_backend(ftrl, SERVER_KEYS, WIRE_SERVERS, cfg=PSConfig(),
                                          device=device)
                try:
                    res = wire_deterministic(f"FTRL server witness {arm} ({rep + 1})", be,
                                             pushes, ftrl, 1, "ftrl_push", fk.LAUNCHES,
                                             IndexAudit())
                finally:
                    be.close()
                if arm == "armed":
                    wr = witness.report()
                    if wr["violations"]:
                        raise AssertionError(f"witness arm: {wr['violations']} inversions")
                    res["witness_edges"] = wr["edges"]
            finally:
                if arm == "armed":
                    witness.uninstall()
            runs[arm].append({"pushes_per_s": res["pushes_per_s"], **res["latency"],
                              **({"witness_edges": res["witness_edges"]}
                                 if arm == "armed" else {})})
            launches[arm] += res["launches"]
            del be
            if device == "cuda":
                torch.cuda.empty_cache()
    for arm, rs in runs.items():
        log(f"witness arming cost ({smi}): {arm}: " + "; ".join(
            f"{r['pushes_per_s']:.1f} pushes/s, p50 {r['p50_ms']:.3f} / p99 "
            f"{r['p99_ms']:.3f} ms" for r in rs) + f" ({LIVE_ARM_PUSHES} pushes a run; "
            f"logged, not gated)")
    return {"runs": runs, "launches": {f"witness_arming_{k}_ftrl_push": v
                                       for k, v in launches.items()}}


def phase_analysis(rounds: list, model_a, smi: str, device: str = "cuda") -> dict:
    """Phase 18: (b) phase 13 (a)'s launch under the lock-order witness and
    the race witness beside it unarmed, (c) what arming the witness costs
    phase 12 (a)'s pushes; phase 19 (a)'s `cli verify` (lint, then check),
    started by the caller, runs beside them."""
    t_phase = time.perf_counter()
    ids, y = zipf_rows()
    with tempfile.TemporaryDirectory() as tmp_s:
        tmp = Path(tmp_s)
        files = zipf_row_files(tmp, ids, y, with_val=True)
        files, val = files[:-1], files[-1]
        out = {"cluster": witnessed_cluster(files, val, tmp, model_a, device)}
    if device == "cuda":
        torch.cuda.empty_cache()
    out["arming"] = witness_arming_cost(rounds, smi, device)
    out["launches"] = {**out["cluster"].pop("launches"), **out["arming"].pop("launches")}
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 18 ok in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


# ---------------------------------------------------------------------------
# phase 19: psmc (cli verify, cli check), the explorer and the race witness
# ---------------------------------------------------------------------------


def start_verify(root: Path) -> dict:
    """Phase 19 (a): `cli verify --json` (lint, then check) and `cli check
    --json` over the checkout, each in its own process (host work on one
    core each); a thread a process reads its output and notes when it
    ended."""
    import threading

    env = {**os.environ, "PYTHONPATH": str(root)}
    t0 = time.perf_counter()
    runs: dict = {}
    for cmd in ("verify", "check"):
        proc = subprocess.Popen(
            [sys.executable, "-m", "parameter_server_tpu_torch.cli", cmd, "--json"],
            cwd=root, env=env, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        run = runs[cmd] = {"proc": proc}

        def wait(run=run, proc=proc) -> None:
            run["stdout"], run["stderr"] = proc.communicate()
            run["seconds"] = time.perf_counter() - t0

        run["thread"] = threading.Thread(target=wait, daemon=True, name=f"cli-{cmd}")
        run["thread"].start()
    return runs


def finish_verify(runs: dict) -> dict:
    """Phase 19 (a)'s gates: `cli verify` exits 0 with lint 0 and check 0;
    `cli check`: every spec complete and ok, conformance []."""
    try:
        for run in runs.values():
            run["thread"].join(VERIFY_TIMEOUT_S)
    finally:
        for run in runs.values():
            if run["proc"].poll() is None:
                run["proc"].kill()
                run["proc"].wait()
    docs = {}
    for cmd, run in runs.items():
        lines = run.get("stdout", "").strip().splitlines()
        docs[cmd] = json.loads(lines[-1]) if lines and lines[-1].startswith("{") else {}
        if run["proc"].returncode != 0:
            raise AssertionError(f"cli {cmd} --json: exit {run['proc'].returncode}\n"
                                 f"{run.get('stdout', '')[-3000:]}\n"
                                 f"{run.get('stderr', '')[-2000:]}")
    v, c = docs["verify"], docs["check"]
    if v != {"stages": [{"stage": "lint", "exit": 0}, {"stage": "check", "exit": 0}],
             "hard": [], "soft": [], "exit": 0}:
        raise AssertionError(f"cli verify --json: {v}")
    specs = {r["spec"]: r for r in c.get("specs", [])}
    if not (c.get("ok") and c.get("conformance") == [] and set(specs) == {
            "exactly-once", "rcu", "ssp", "failover"} and all(
            r["complete"] and r["ok"] for r in specs.values())):
        raise AssertionError(f"cli check --json: {c}")
    out = {"verify_s": runs["verify"]["seconds"], "check_s": runs["check"]["seconds"],
           "specs": {n: {k: r[k] for k in ("states", "transitions", "depth")}
                     for n, r in specs.items()}}
    log(f"cli verify --json ok: lint 0, check 0, exit 0 in {out['verify_s']:.1f} s wall; "
        f"cli check --json ok in {out['check_s']:.1f} s: every spec complete and ok "
        f"{json.dumps(out['specs'])}, conformance [] (both beside phase 18 (b), (c) and 19 (b))")
    return out


def psmc_serving(arm: str, seed: int, keys: np.ndarray, grads: list, want_rows: list,
                 want_table: np.ndarray) -> dict:
    """One phase 19 (b) run: with the explorer (``arm`` "explorer", seeded
    ``seed``) or the race witness ("race") armed before they are built, a
    card FTRL ShardServer of WORKER_KEYS rows and a serving handle under
    PSMC_PLAN; PSMC_ROUNDS rounds of a push and a pull of ``keys``. Gates:
    each pull is its round's CPU replay (read-your-writes), 12 pushes, K1
    once an apply batch, the table equal to the CPU replay's (PSMC_TOL);
    the explorer's decisions > 50 with rcu-publish: and queue. sites among
    them; the race witness's tracked fields > 0 and no report."""
    from parameter_server_tpu_torch.analysis import explorer, racewitness
    from parameter_server_tpu_torch.kv.updaters import Ftrl
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.parallel.chaos import FaultPlan
    from parameter_server_tpu_torch.parallel.multislice import ServerHandle, ShardServer
    from parameter_server_tpu_torch.utils.config import PSConfig, ServeConfig
    from parameter_server_tpu_torch.utils.keyrange import KeyRange

    name = f"psmc {arm}" + (f" seed {seed}" if arm == "explorer" else "")
    svc = ServeConfig(cache=True, ttl_ms=10_000, max_stale_ms=60_000, hot_min_pulls=1,
                      encode_cache_entries=64)
    cfg = PSConfig()
    cfg.serve = svc
    if arm == "explorer":
        explorer.install(seed)
    else:
        racewitness.install()
    t0 = time.perf_counter()
    try:
        srv = ShardServer(
            Ftrl(alpha=HYPER["alpha"], beta=HYPER["beta"], lambda_l1=HYPER["l1"],
                 lambda_l2=HYPER["l2"]), KeyRange(0, WORKER_KEYS), serve_cfg=svc,
            fault_plan=FaultPlan.parse(PSMC_PLAN, seed=PSMC_PLAN_SEED), device="cuda").start()
        h = ServerHandle(srv.address, 0, 0, cfg, range_size=WORKER_KEYS, serving=True,
                         reconnect_timeout_s=30.0, device="cuda")
        fk.reset_launches()
        err = 0.0
        try:
            for i, g in enumerate(grads):
                h.push(keys, g)
                got = h.pull(keys)
                d = np.abs(got - want_rows[i])
                if not (d <= PSMC_TOL * (np.abs(want_rows[i]) + 1.0)).all():
                    raise AssertionError(f"{name}: the pull after push {i + 1} is {d.max()} "
                                         "off the CPU replay (read-your-writes)")
                err = max(err, float(d.max()))
            launches = fk.LAUNCHES["ftrl_push"]
            counters = dict(srv.counters)
            faults = srv.server.fault_stats()
            table = srv.weights().reshape(-1)
        finally:
            h.shutdown()
            h.close()
            srv.server.stop()
        seconds = time.perf_counter() - t0
        res = {"seconds": seconds, "launches": launches, "pushes": counters["pushes"],
               "apply_batches": counters["apply_batches"], "fault_frames": faults["frames"]}
        if arm == "explorer":
            dec = explorer.decisions()
            res["decisions"] = sum(len(v) for v in dec.values())
            res["sites"] = len(dec)
            res["publish_boundaries"] = len(dec.get("rcu-publish:ShardServer._publish", []))
            if not (res["decisions"] > 50 and res["publish_boundaries"] > 0
                    and any(k.startswith("queue.") for k in dec)):
                raise AssertionError(f"{name}: decisions {res['decisions']} at {sorted(dec)}")
        else:
            res.update(racewitness.report())
            if racewitness.reports() or not res["tracked"]:
                raise AssertionError(f"{name}: {res['tracked']} fields tracked, reports "
                                     f"{[r.render() for r in racewitness.reports()]}")
    finally:
        if arm == "explorer":
            explorer.uninstall()
        else:
            racewitness.clear()
            racewitness.uninstall()
    if res["pushes"] != PSMC_ROUNDS or not launches == res["apply_batches"] > 0:
        raise AssertionError(f"{name}: {res['pushes']} pushes, K1 {launches}, "
                             f"{res['apply_batches']} apply batches")
    d = np.abs(table - want_table)
    if not (d <= PSMC_TOL * (np.abs(want_table) + 1.0)).all():
        raise AssertionError(f"{name}: the table is {d.max()} off the CPU replay")
    res["max_abs_err"] = max(err, float(d.max()))
    return res


def phase_psmc(verify: dict, smi: str) -> dict:
    """Phase 19: (a) `cli verify` and `cli check` (started beside phase
    18), (b) the explorer-armed and race-armed card server; (c), phase 13
    (a)'s launch with the race witness on every node, is phase 18 (b)'s
    armed launch."""
    from parameter_server_tpu_torch.analysis import explorer
    from parameter_server_tpu_torch.kv.store import KVStore
    from parameter_server_tpu_torch.kv.updaters import Ftrl

    t_phase = time.perf_counter()
    root = Path(__file__).resolve().parent
    rng = np.random.default_rng(SEED)
    keys = np.sort(rng.choice(WORKER_KEYS, PSMC_KEYS, replace=False)).astype(np.int64)
    grads = [rng.normal(0.0, 3.0, PSMC_KEYS).astype(np.float32) for _ in range(PSMC_ROUNDS)]
    twin = KVStore(Ftrl(alpha=HYPER["alpha"], beta=HYPER["beta"], lambda_l1=HYPER["l1"],
                        lambda_l2=HYPER["l2"]), WORKER_KEYS, device="cpu")
    want_rows = []
    for g in grads:
        twin.push(keys, g)
        want_rows.append(twin.pull(keys).numpy().reshape(-1))
    want_table = twin.weights().numpy().reshape(-1)
    del twin
    corpus = explorer.corpus_seeds(str(root / "tests" / "torch_sched_corpus.json"), PSMC_NODE)
    seeds = [PSMC_SEED] + [s for s in corpus if s != PSMC_SEED]
    runs = {f"explorer_{s}": psmc_serving("explorer", s, keys, grads, want_rows, want_table)
            for s in seeds}
    runs["race"] = psmc_serving("race", 0, keys, grads, want_rows, want_table)
    for k, r in runs.items():
        log(f"psmc serving {k} ok in {r['seconds']:.2f} s ({smi}): read-your-writes over "
            f"{PSMC_ROUNDS} rounds of {PSMC_KEYS} keys on a 2^24-row card server under "
            f"{PSMC_PLAN!r}, {r['pushes']} pushes, K1 = apply batches {r['launches']}, "
            f"{r['fault_frames']} frames through the plan, table = CPU replay (max abs err "
            f"{r['max_abs_err']:.3g}); "
            + (f"{r['decisions']} decisions at {r['sites']} sites, {r['publish_boundaries']} "
               "publish boundaries" if k != "race" else
               f"{r['tracked']} fields tracked on {r['classes']}, {r['races']} races"))
    out = {"verify": finish_verify(verify), "serving": runs, "corpus_seeds": corpus,
           "launches": {"psmc_explored_server": sum(r["launches"] for k, r in runs.items()
                                                    if k != "race"),
                        "psmc_race_server": runs["race"]["launches"]}}
    torch.cuda.empty_cache()
    out["seconds"] = time.perf_counter() - t_phase
    log(f"phase 19 ok in {out['seconds']:.1f} s; launches {out['launches']}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this script "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    root = Path(__file__).resolve().parent
    if not (root / "parameter_server_tpu_torch" / "__init__.py").is_file():
        print("chip_smoke: parameter_server_tpu_torch not found beside this "
              "script; run it from a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, str(root))
    from parameter_server_tpu_torch.data.batch import BatchBuilder
    from parameter_server_tpu_torch.data.synthetic import make_sparse_logistic
    from parameter_server_tpu_torch.filters.fixed_point import FixedPointCodec
    from parameter_server_tpu_torch.kv.store import KVStore, coalesce_pushes
    from parameter_server_tpu_torch.kv.updaters import Adagrad, Ftrl
    from parameter_server_tpu_torch.models import matrix_fac as mfm
    from parameter_server_tpu_torch.models.linear import LinearMethod
    from parameter_server_tpu_torch.ops import adagrad_kernels as ak
    from parameter_server_tpu_torch.ops import cuda_build
    from parameter_server_tpu_torch.ops import ftrl_kernels as fk
    from parameter_server_tpu_torch.ops import quantize_kernels as qk
    from parameter_server_tpu_torch.utils.metrics import ProgressReporter

    t_start = time.perf_counter()
    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # 1. probe
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    ).stdout.strip()
    print(smi)
    kind = torch.cuda.get_device_name(0)
    log(f"device {kind}, count {torch.cuda.device_count()}, torch "
        f"{torch.__version__}, CUDA {torch.version.cuda}")

    # 2. build
    t0 = time.perf_counter()
    lib_path = cuda_build.build()
    cuda_build.load()
    log(f"built {lib_path.name} from {[s.name for s in cuda_build.sources()]} in "
        f"{time.perf_counter() - t0:.2f} s")
    for line in lib_path.with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line or "Compiling entry" in line:
            log(f"ptxas: {line.strip()}")

    # set-up: the worker's minibatches and the servers' pushes (host data,
    # made from the seed as bench.py's cells make them)
    t0 = time.perf_counter()
    labels, keys, vals, _ = make_sparse_logistic(
        BATCH * STEPS, FEATURES, nnz_per_example=NNZ_PER, noise=0.4, seed=SEED
    )
    builder = BatchBuilder(
        num_keys=WORKER_KEYS, batch_size=BATCH, max_nnz_per_example=4 * NNZ_PER
    )
    batches = [
        builder.build(labels[i:i + BATCH], keys[i:i + BATCH], vals[i:i + BATCH])
        for i in range(0, BATCH * STEPS, BATCH)
    ]
    rng = np.random.default_rng(SEED)
    rounds = [simulated_pushes(rng, SERVER_KEYS, SERVER_WORKERS, SERVER_DRAWS, 4096, 1)
              for _ in range(SERVER_ROUNDS)]
    emb_rounds = [simulated_pushes(rng, EMB_KEYS, EMB_WORKERS, EMB_WORKER_DRAWS,
                                   EMB_HOT, EMB_VDIM) for _ in range(EMB_ROUNDS)]
    mf_users, mf_items, mf_ratings = synthetic_ratings(np.random.default_rng(SEED + 1))
    u_worker = batches[0].unique_keys.shape[0]
    log(f"set-up data in {time.perf_counter() - t0:.2f} s: batch (B, NNZ, U) "
        f"= {batches[0].shape}; {MF_RATINGS} ratings, mean {mf_ratings.mean():.4f}")
    # the servers' host-side coalescing of one round, timed alone
    t0 = time.perf_counter()
    push_idx, _ = coalesce_pushes(*rounds[0])
    t1 = time.perf_counter()
    emb_idx, _ = coalesce_pushes(*emb_rounds[0])
    log(f"host coalesce of one round: FTRL server {len(push_idx)} unique rows x 1 "
        f"in {t1 - t0:.4f} s; embedding server {len(emb_idx)} unique rows x "
        f"{EMB_VDIM} in {time.perf_counter() - t1:.4f} s")

    # 3. kernel checks and times
    gen = torch.Generator(device=dev)
    gen.manual_seed(SEED)
    kernels = {}
    err_delta = max(
        check_delta(fk, dev, gen, 1 << 20, 1),
        check_delta(fk, dev, gen, 1 << 17, 8),
        check_delta(fk, dev, gen, u_worker, 1),
        check_delta(fk, dev, gen, 1 << 17, 8, HYPER_L2),
        check_delta(fk, dev, gen, u_worker, 1, offset=True),
        check_delta(fk, dev, gen, 4097, 1, HYPER_L2, offset=True),
    )
    # time at the worker step's shape (U, 1): cold, cycling input sets so
    # the 50 MB L2 cache cannot hold them between calls; warm, repeating
    # one set, as the step finds the rows index_select has just gathered
    sets = [
        (torch.randn((u_worker, 1), generator=gen, device=dev),
         torch.rand((u_worker, 1), generator=gen, device=dev),
         torch.randn((u_worker, 1), generator=gen, device=dev))
        for _ in range(DELTA_SETS)
    ]
    k_ms, k_call = cuda_ms(lambda i: fk.ftrl_delta(*sets[i % DELTA_SETS], **HYPER), 200)
    w_ms, _ = cuda_ms(lambda i: fk.ftrl_delta(*sets[0], **HYPER), 200)
    p_ms, p_call = cuda_ms(
        lambda i: fk.ftrl_delta_plain(*sets[i % DELTA_SETS], **HYPER), PLAIN_ITERS)
    b_ms, b_by = bound(20 * u_worker, FTRL_FLOPS * u_worker)
    kernels["ftrl_delta"] = {
        "name": "ftrl_delta", "route": "cuda",
        "source": "parameter_server_tpu_torch/csrc/ftrl.cu",
        "replaces": "parameter_server_tpu/ops/pallas_kernels.py:84",
        "shape": [u_worker, 1], "max_abs_err": err_delta,
        "ms": k_ms, "warm_ms": w_ms, "plain_ms": p_ms,
        "bound_ms": b_ms, "bound_by": b_by, "library_ms": None,
        "call_ms": k_call, "plain_call_ms": p_call,
    }
    del sets
    log(f"ftrl_delta ok: max abs err {err_delta:.3g} (offset views included); device "
        f"{k_ms:.5f} ms kernel cold ({DELTA_SETS} sets cycled), {w_ms:.5f} ms warm (one "
        f"set), {p_ms:.5f} ms plain, bound {b_ms:.5f} ms ({b_by}) at ({u_worker}, 1); "
        f"host-inclusive per call {k_call:.5f} ms kernel, {p_call:.5f} ms plain")

    err_push = []
    for vdim, hyper in ((1, HYPER), (8, HYPER), (1, HYPER_L2)):
        err_push.append(check_push("ftrl_push", fk.ftrl_push, fk.ftrl_push_plain, dev,
                                   gen, push_idx, SERVER_KEYS, vdim, hyper))
        torch.cuda.empty_cache()
        log(f"ftrl_push vdim {vdim} l2 {hyper['l2']} ok on {SERVER_KEYS} rows: "
            f"max abs err {err_push[-1]:.3g}; untouched rows bit-identical")
    # time at the server's shape (2^27, 1), cycling PUSH_SETS touched sets so
    # each call finds its rows cold, as a push to a large table does; at the
    # table's push and at 4x it
    z = torch.zeros((SERVER_KEYS, 1), device=dev)
    n = torch.zeros((SERVER_KEYS, 1), device=dev)
    push_times = [time_ftrl_push(fk, z, n, *key_sets(rng, gen, dev, PUSH_SETS, SERVER_KEYS,
                                                    draws, 1))
                  for draws in (PUSH_DRAWS, LARGE_PUSH_DRAWS)]
    t, large = push_times
    kernels["ftrl_push"] = {
        "name": "ftrl_push", "route": "cuda",
        "source": "parameter_server_tpu_torch/csrc/ftrl.cu",
        "replaces": "parameter_server_tpu/ops/pallas_kernels.py:335",
        "shape": [SERVER_KEYS, 1, t["rows"]], "max_abs_err": max(err_push),
        "ms": t["ms"], "plain_ms": t["plain_ms"],
        "bound_ms": t["bound_ms"], "bound_by": t["bound_by"], "library_ms": None,
        "call_ms": t["call_ms"], "plain_call_ms": t["plain_call_ms"],
        "gather_floor_ms": t["gather_floor_ms"], "large_push_ms": large["ms"], "large_push": large,
    }
    for t in push_times:
        log(f"ftrl_push: device {t['ms']:.5f} ms kernel, {t['plain_ms']:.5f} ms plain, "
            f"bound {t['bound_ms']:.5f} ms ({t['bound_by']}; {t['rows']:.1f} rows into "
            f"{SERVER_KEYS}, {PUSH_SETS} sets cycled); sector-granular traffic bound "
            f"{t['rows'] * 136 / HBM_BYTES_PER_S * 1e3:.5f} ms; access-pattern floor "
            f"(gather of z, n) {t['gather_floor_ms']:.5f} ms; host-inclusive per call "
            f"{t['call_ms']:.5f} ms kernel, "
            f"{t['plain_call_ms']:.5f} ms plain")
    del z, n, push_times, t, large
    torch.cuda.empty_cache()

    err_ada = []
    for vdim, l2 in ((16, 0.0), (16, 0.01), (EMB_VDIM, 0.0), (EMB_VDIM, 0.01)):
        err_ada.append(check_push("adagrad_push", ak.adagrad_push, ak.adagrad_push_plain,
                                  dev, gen, emb_idx, EMB_KEYS, vdim,
                                  {**ADAGRAD, "l2": l2}, zero_pad_row=l2 > 0))
        torch.cuda.empty_cache()
        log(f"adagrad_push vdim {vdim} l2 {l2} ok on {EMB_KEYS} rows: max abs err "
            f"{err_ada[-1]:.3g}; untouched rows bit-identical")
    # time at the embedding server's shape (2^22, 64), cold as K1
    sets, u = key_sets(rng, gen, dev, EMB_SETS, EMB_KEYS, EMB_DRAWS, EMB_VDIM)
    w = torch.zeros((EMB_KEYS, EMB_VDIM), device=dev)
    n = torch.rand((EMB_KEYS, EMB_VDIM), generator=gen, device=dev)
    t = {**time_adagrad_push(ak, w, n, sets),
         **time_adagrad_yardsticks(ak, w, n, sets)}
    b_ms, b_by = adagrad_bound(u, u, EMB_VDIM)
    kernels["adagrad_push"] = {
        "name": "adagrad_push", "route": "cuda",
        "source": "parameter_server_tpu_torch/csrc/adagrad.cu",
        "replaces": "parameter_server_tpu/ops/pallas_kernels.py:359",
        "shape": [EMB_KEYS, EMB_VDIM, u], "max_abs_err": max(err_ada),
        "bound_ms": b_ms, "bound_by": b_by, **t,
    }
    log(f"adagrad_push: device {t['ms']:.5f} ms kernel, {t['plain_ms']:.5f} ms plain, "
        f"{t['library_ms']:.5f} ms torch.optim.Adagrad sparse step (agrees with plain to "
        f"{t['library_err']:.3g}), "
        f"bound {b_ms:.5f} ms ({b_by}; {u:.1f} rows x {EMB_VDIM} into {EMB_KEYS}, {EMB_SETS} "
        f"sets cycled); host-inclusive per call {t['call_ms']:.5f} ms kernel, "
        f"{t['plain_call_ms']:.5f} ms plain, {t['library_call_ms']:.5f} ms library")
    del w, n, sets, t
    torch.cuda.empty_cache()

    # 4. worker: the linear_method trainer on the card
    cfg = worker_cfg()
    rep = ProgressReporter(print_fn=lambda s: log(f"train | {s}"))
    app = LinearMethod(cfg, reporter=rep, device="cuda")
    torch.cuda.synchronize()
    fk.reset_launches()
    t0 = time.perf_counter()
    app.train(batches, report_every=1)
    torch.cuda.synchronize()
    t_train = time.perf_counter() - t0
    worker_launches = dict(fk.LAUNCHES)
    if worker_launches["ftrl_delta"] < STEPS:
        raise AssertionError(f"worker phase launched ftrl_delta "
                             f"{worker_launches['ftrl_delta']} times, want {STEPS}")
    hist = rep.history
    if not all(np.isfinite(r["objv"]) for r in hist) or not hist[-1]["auc"] > 0.5:
        raise AssertionError(f"worker: bad progress {hist[-1]}")
    cpu_rep = ProgressReporter(print_fn=lambda s: None)
    LinearMethod(cfg, reporter=cpu_rep, device="cpu").train(batches[:3], report_every=1)
    for step, (a, b) in enumerate(zip(hist[:3], cpu_rep.history)):
        loss_gpu, loss_cpu = a["objv"] * BATCH, b["objv"] * BATCH
        if not np.isclose(loss_gpu, loss_cpu, rtol=1e-4, atol=0.0):
            raise AssertionError(
                f"worker step {step}: loss_sum {loss_gpu} on the card vs "
                f"{loss_cpu} on the CPU"
            )
    ex_s = sorted(r["ex_per_sec"] for r in hist[1:])
    log(f"worker ok: {STEPS} steps in {t_train:.3f} s; median {ex_s[len(ex_s) // 2]:.1f}"
        f" ex/s over steps 2-{STEPS}; progressive AUC {hist[-1]['auc']:.4f}; "
        f"loss_sum of steps 1-3 matches the CPU run; launches {worker_launches}")
    log_profile("worker profile, 4 steps",
                lambda: app.train(batches[:4], report_every=4))
    del app
    torch.cuda.empty_cache()

    # 5. server: FTRL pushes from simulated workers, then pulls
    store = KVStore(Ftrl(alpha=HYPER["alpha"], beta=HYPER["beta"],
                         lambda_l1=HYPER["l1"], lambda_l2=HYPER["l2"]),
                    num_keys=SERVER_KEYS, device="cuda")
    pulled, pre, summed, t_server, server_launches = serve_rounds(
        store, rounds, dev, fk.LAUNCHES, "ftrl_push")
    zc, nc = with_pad_row(pre["z"]), with_pad_row(pre["n"])
    local = torch.arange(1, len(pulled) + 1, dtype=torch.int32)
    fk.ftrl_push_plain(zc, nc, local, summed, **HYPER)
    want = store.updater.weights({"z": zc[1:], "n": nc[1:]})
    err_pull = check_close("server pull", pulled, want)
    log(f"server ok: {SERVER_ROUNDS} coalesced pushes of {SERVER_WORKERS} workers "
        f"and a pull of {len(pulled)} keys in {t_server:.3f} s; pulled weights "
        f"match the CPU plain update (max abs err {err_pull:.3g}); ftrl_push "
        f"launches {server_launches}; nnz {store.nnz()}")
    del store
    torch.cuda.empty_cache()

    # 6. mf: matrix factorization at MovieLens-20M's shape
    def make_mf(device: str, reporter=None):
        return mfm.MatrixFactorization(
            MF_USERS, MF_ITEMS, rank=MF_RANK, eta=MF_ETA, l2=MF_L2, algo="adagrad",
            seed=SEED, max_delay=MF_MAX_DELAY, steps_per_call=MF_STEPS_PER_CALL,
            reporter=reporter or ProgressReporter(print_fn=lambda s: None),
            device=device,
        )

    mf_rep = ProgressReporter(print_fn=lambda s: log(f"mf | {s}"))
    mf, mf_cpu = make_mf("cuda", mf_rep), make_mf("cpu")
    mf_builder = mfm.MFBatchBuilder(MF_BATCH)
    for step in range(3):
        sel = slice(step * MF_BATCH, (step + 1) * MF_BATCH)
        b = mf_builder.build(mf_users[sel], mf_items[sel], mf_ratings[sel])
        sse = [
            float(mfm.mf_train_step(a.user_up, a.item_up, a.user_state, a.item_state,
                                    mfm.batch_to_device(b, a.device), a.l2)[2])
            for a in (mf, mf_cpu)
        ]
        if not np.isclose(sse[0], sse[1], rtol=1e-4, atol=0.0):
            raise AssertionError(f"mf step {step}: SSE {sse[0]} on the card vs "
                                 f"{sse[1]} on the CPU")
    # K3 against the plain path at MF's own shapes: the tables after the 3
    # steps (K3 on the card, adagrad_push_plain on the CPU)
    err_mf_state = 0.0
    for table in ("user_state", "item_state"):
        for k in ("w", "n"):
            got, want = getattr(mf, table)[k].cpu(), getattr(mf_cpu, table)[k]
            err_mf_state = max(err_mf_state, (got - want).abs().max().item())
            if not torch.allclose(got, want, rtol=1e-4, atol=ATOL):
                raise AssertionError(
                    f"mf {table}[{k!r}] after 3 steps: card vs CPU max abs err "
                    f"{(got - want).abs().max().item()}")
    del mf_cpu
    torch.cuda.synchronize()
    ak.reset_launches()
    fk.reset_launches()
    t0 = time.perf_counter()
    rmse = [mf.train_epoch(mf_users, mf_items, mf_ratings, batch_size=MF_BATCH, seed=ep)
            for ep in range(2)]
    torch.cuda.synchronize()
    t_mf = time.perf_counter() - t0
    mf_launches = {**ak.LAUNCHES, **fk.LAUNCHES}
    mf_steps = 2 * -(-MF_RATINGS // MF_BATCH)
    if mf_launches["adagrad_push"] < 2 * mf_steps:
        raise AssertionError(f"mf phase launched adagrad_push "
                             f"{mf_launches['adagrad_push']} times in {mf_steps} steps, "
                             f"want 2 a step")
    if not np.isfinite(rmse).all() or not rmse[1] < rmse[0]:
        raise AssertionError(f"mf: train RMSE {rmse} must be finite and fall")
    pairs_s = [r["ex_per_sec"] for r in mf_rep.history]
    log(f"mf ok: 2 epochs of {MF_RATINGS} ratings ({mf_steps} steps) in {t_mf:.3f} s; "
        f"{pairs_s[0]:.1f} / {pairs_s[1]:.1f} pairs/s; train RMSE {rmse[0]:.6f} -> "
        f"{rmse[1]:.6f}; SSE of steps 1-3 matches the CPU run, and so do the w and "
        f"n tables after them (max abs err {err_mf_state:.3g}); launches {mf_launches}")
    rows = log_profile("mf profile, 4 steps (one window entry)",
                       lambda: mf.train_epoch(mf_users[:4 * MF_BATCH], mf_items[:4 * MF_BATCH],
                                              mf_ratings[:4 * MF_BATCH], batch_size=MF_BATCH))
    del mf
    torch.cuda.empty_cache()
    # K3 at MF's pushes: each profiled step pushes both tables, MF_BATCH + 1
    # slots each over the batch's distinct users (items) and the pad row,
    # the batches as train_epoch(seed=0) draws them. Each step gathers
    # those rows just before its push, and the item tables (~6.8 MB each)
    # fit in L2, so the kernel may beat this device-memory bound
    k3_mf_ms, k3_mf_count = kernel_row(rows, "adagrad_push_kernel")
    order = np.random.default_rng(0).permutation(4 * MF_BATCH)
    mf_rows = [len(np.unique(ids[order[s:s + MF_BATCH]])) + 1
               for s in range(0, 4 * MF_BATCH, MF_BATCH) for ids in (mf_users, mf_items)]
    k3_mf = {"ms": k3_mf_ms, "profiled_launches": k3_mf_count, "slots": MF_BATCH + 1,
             "rows": mf_rows, "vdim": MF_RANK,
             "bound_ms": float(np.mean([adagrad_bound(MF_BATCH + 1, r, MF_RANK)[0]
                                        for r in mf_rows])),
             "bound_by": adagrad_bound(MF_BATCH + 1, mf_rows[0], MF_RANK)[1]}
    log(f"mf adagrad_push: {k3_mf_ms:.5f} ms a launch on the device ({k3_mf_count} in the "
        f"profile), bound {k3_mf['bound_ms']:.5f} ms ({k3_mf['bound_by']}) at "
        f"{MF_BATCH + 1} slots over {mf_rows} distinct rows (users, items a step) x {MF_RANK}")
    # K3, its plain version and torch.optim.Adagrad's sparse step at MF's user
    # push: each set one profiled step's distinct users (sorted, without the
    # pad slots: the library's step needs coalesced keys), cycled over a
    # (users + 1) x rank table that L2 holds, as the step finds it
    mf_sets = []
    for s in range(0, 4 * MF_BATCH, MF_BATCH):
        keys_np = np.unique(mf_users[order[s:s + MF_BATCH]]).astype(np.int32) + 1
        mf_sets.append((torch.from_numpy(keys_np).to(dev),
                        torch.randn((len(keys_np), MF_RANK), generator=gen, device=dev)))
    w = torch.randn((MF_USERS + 1, MF_RANK), generator=gen, device=dev) * 0.1
    n = torch.rand((MF_USERS + 1, MF_RANK), generator=gen, device=dev)
    t = {**time_adagrad_push(ak, w, n, mf_sets), **time_adagrad_yardsticks(ak, w, n, mf_sets)}
    u_mf = sum(k.shape[0] for k, _ in mf_sets) / len(mf_sets)
    k3_mf.update({"users_ms": t["ms"], "users_plain_ms": t["plain_ms"],
                  "users_library_ms": t["library_ms"], "users_rows": u_mf,
                  "users_bound_ms": adagrad_bound(u_mf, u_mf, MF_RANK)[0]})
    log(f"mf adagrad_push at a step's {u_mf:.1f} distinct users x {MF_RANK} (no pad slots): "
        f"device {t['ms']:.5f} ms kernel, {t['plain_ms']:.5f} ms plain, {t['library_ms']:.5f}"
        f" ms torch.optim.Adagrad sparse step (agrees with plain to {t['library_err']:.3g}), "
        f"bound {k3_mf['users_bound_ms']:.5f} ms")
    del w, n, mf_sets, t

    # 7. embedding server: AdaGrad pushes from simulated workers, then a pull
    store = KVStore(Adagrad(eta=ADAGRAD["eta"], eps=ADAGRAD["eps"]), EMB_KEYS,
                    vdim=EMB_VDIM, device="cuda")
    pulled, pre, summed, t_emb, emb_launches = serve_rounds(
        store, emb_rounds, dev, ak.LAUNCHES, "adagrad_push")
    wc, nc = with_pad_row(pre["w"]), with_pad_row(pre["n"])
    local = torch.arange(1, len(pulled) + 1, dtype=torch.int32)
    ak.adagrad_push_plain(wc, nc, local, summed, **ADAGRAD, l2=0.0)
    err_emb = check_close("embedding server pull", pulled, wc[1:])
    log(f"embedding server ok: {EMB_ROUNDS} coalesced pushes of {EMB_WORKERS} "
        f"workers and a pull of {len(pulled)} keys x {EMB_VDIM} in {t_emb:.3f} s; "
        f"pulled rows match the CPU plain update (max abs err {err_emb:.3g}); "
        f"adagrad_push launches {emb_launches}")
    del store
    torch.cuda.empty_cache()

    # 8. codec: K4 checks, statistics and times, then the filter round trip
    t0 = time.perf_counter()
    err_quant = max(check_quantize(qk, FixedPointCodec(num_bytes), dev, gen, n, num_bytes)
                    for num_bytes in (1, 2) for n in CODEC_SIZES)
    log(f"quantize_stochastic ok: q, lo, scale equal to the plain version's bit for "
        f"bit at {CODEC_SIZES} elements, int8 and int16, seeds {CODEC_SEEDS}; every "
        f"decode within one step + {ROUNDING_ULPS} ulps; maxima saturated "
        f"({time.perf_counter() - t0:.2f} s)")
    codec8 = FixedPointCodec(1)
    xc = torch.full(((1 << 20) + 2,), 0.3, device=dev)  # between two levels of [0, 1]
    xc[-2:] = torch.tensor([0.0, 1.0])
    mean = torch.stack([codec8.decode(codec8.encode(s, xc))[:-2].mean()
                        for s in range(CODEC_MEAN_SEEDS)]).mean().item()
    if not abs(mean - 0.3) < 2e-3:
        raise AssertionError(f"codec: mean decode of 0.3 over {CODEC_MEAN_SEEDS} seeds is {mean}")
    x = torch.randn(CODEC_BIG, generator=gen, device=dev)
    res, rates = [], []
    for s in (CODEC_FIRST_SEED, CODEC_FIRST_SEED + 1):
        e = codec8.encode(s, x)
        up, frac = round_ups(e.q, x, e.lo, e.scale, 1)
        sigma = (frac * (1 - frac)).sum().sqrt().item() / len(frac)
        rates.append((up.mean().item(), frac.mean().item(), sigma))
        if not abs(rates[-1][0] - rates[-1][1]) < 4 * sigma:
            raise AssertionError(f"codec seed {s}: round-up rate {rates[-1][0]} vs mean frac "
                                 f"{rates[-1][1]} (sigma {sigma})")
        res.append((up - frac).float())
    rho = torch.corrcoef(torch.stack(res))[0, 1].item()
    if not abs(rho) < 0.01:
        raise AssertionError(f"codec: seeds s and s+1 round with correlation {rho}")
    del xc, x, res, up, frac, e
    log(f"codec statistics ok: mean decode of 0.3 over {CODEC_MEAN_SEEDS} seeds "
        f"{mean:.9f} (|err| {abs(mean - 0.3):.3g}); at {CODEC_BIG} elements round-up "
        f"rate vs mean frac {rates[0][0]:.6f} / {rates[0][1]:.6f} (sigma {rates[0][2]:.3g}); "
        f"residual correlation of seeds s, s+1 {rho:.3g}")
    q_times = [time_quantize(qk, dev, gen, (CODEC_BIG,), 1, 2),
               time_quantize(qk, dev, gen, (CODEC_BIG,), 2, 2),
               time_quantize(qk, dev, gen, emb_rounds[0][1][0].shape, 1, 8)]
    for t in q_times:
        log(f"quantize_stochastic int{8 * t['num_bytes']} at {t['shape']} ({t['sets']} sets "
            f"cycled): device {t['ms']:.5f} ms kernel pass (bound {t['bound_ms']:.5f} ms, "
            f"{t['bound_by']}), {t['plain_ms']:.5f} ms plain pass; aminmax {t['aminmax_ms']:.5f}"
            f" ms (bound {t['aminmax_bound_ms']:.5f}); whole encode {t['encode_ms']:.5f} ms, "
            f"plain {t['plain_encode_ms']:.5f} ms; host-inclusive per call "
            f"{t['call_ms']:.5f} ms kernel, {t['encode_call_ms']:.5f} ms encode")
    torch.cuda.empty_cache()
    # the filter round trip: K4 on the card, K3 into the embedding table
    store = KVStore(Adagrad(eta=ADAGRAD["eta"], eps=ADAGRAD["eps"]), EMB_KEYS,
                    vdim=EMB_VDIM, device="cuda")
    torch.cuda.synchronize()
    qk.reset_launches()
    ak.reset_launches()
    t0 = time.perf_counter()
    wire, worst, q_card = codec_round_trip(store, emb_rounds, dev)
    union = np.unique(np.concatenate([k for idx_list, _ in emb_rounds for k in idx_list]))
    pulled = store.pull(union).cpu()
    t_codec = time.perf_counter() - t0
    codec_launches = {**qk.LAUNCHES, **ak.LAUNCHES}
    pushes = sum(len(g) for _, g in emb_rounds)
    if codec_launches != {"quantize_stochastic": pushes, "adagrad_push": EMB_ROUNDS}:
        raise AssertionError(f"codec round trip launched {codec_launches}, want "
                             f"{pushes} quantize_stochastic and {EMB_ROUNDS} adagrad_push")
    if not worst <= 1.0:
        raise AssertionError(f"codec round trip: a decode is {worst} times its bound off")
    cpu_store = KVStore(Adagrad(eta=ADAGRAD["eta"], eps=ADAGRAD["eps"]), len(union) + 1,
                        vdim=EMB_VDIM, device="cpu")
    _, _, q_cpu = codec_round_trip(cpu_store, emb_rounds, torch.device("cpu"),
                                   remap=lambda k: np.searchsorted(union, k) + 1)
    if not all(torch.equal(a, b) for a, b in zip(q_card, q_cpu)):
        raise AssertionError("codec round trip: K4 on the card and its plain version on "
                             "the CPU encode a gradient differently with the same seed")
    err_codec = check_close("codec round trip pull", pulled,
                            cpu_store.pull(np.arange(1, len(union) + 1)))
    raw = sum(g.nbytes for _, grads in emb_rounds for g in grads)
    log(f"codec round trip ok: {EMB_ROUNDS} rounds x {EMB_WORKERS} workers encoded on the "
        f"card, decoded, coalesced and pushed, and a pull of {len(union)} keys x {EMB_VDIM} in "
        f"{t_codec:.3f} s; {wire} payload bytes for {raw} float32 bytes; worst decode "
        f"{worst:.4f} of its bound; pull matches the CPU run (plain K4, same seeds; max "
        f"abs err {err_codec:.3g}), every payload equal to the CPU's; launches {codec_launches}")
    del store, cpu_store
    torch.cuda.empty_cache()
    kernels["quantize_stochastic"] = {
        "name": "quantize_stochastic", "route": "cuda",
        "source": "parameter_server_tpu_torch/csrc/quantize.cu",
        "replaces": "parameter_server_tpu/ops/pallas_kernels.py:143",
        **q_times[0], "max_abs_err": err_quant, "library_ms": None,
        "launches": codec_launches["quantize_stochastic"], "times": q_times[1:],
    }

    # 9. wide_deep: K1 pushes the wide table, K3 the embedding table
    wd_launches, wd_kernels, err_wd_k1, err_wd_k3, wd_batches, wd_init = phase_wide_deep(
        dev, gen)
    torch.cuda.empty_cache()
    # 10. word2vec: plain PyTorch, no kernel
    phase_word2vec(dev)
    torch.cuda.empty_cache()
    # 11. pod: the SPMD tier, K1, K2 and K3 on every kv shard
    pod = phase_pod(dev, gen, batches, (labels, keys, vals),
                    (mf_users, mf_items, mf_ratings), wd_batches, wd_init)
    del wd_init
    torch.cuda.empty_cache()
    pl = pod["launches"]
    # 12. wire: shard servers and handles over loopback TCP, both backends
    wire = phase_wire(dev, rounds, emb_rounds)
    wl = wire["launches"]
    torch.cuda.empty_cache()
    # 13. cluster: scheduler, servers and workers as processes on the card
    cluster = phase_cluster()
    cl = cluster["launches"]
    torch.cuda.empty_cache()
    # 14. chaos on the wire and the serving plane
    chs = phase_chaos_serving(rounds, emb_rounds, wire)
    csl = chs["launches"]
    torch.cuda.empty_cache()
    # 15. darlin, graph_partition, sketch: plain ops, no kernel
    phase_darlin_apps(dev, labels, keys, vals)
    torch.cuda.empty_cache()
    # 16. the native parser, the dynamic pool, tracing and the black box
    model_a = cluster.pop("model_a")
    p16 = phase_native_pool_traced(rounds, model_a)
    p16l = p16["launches"]
    torch.cuda.empty_cache()
    # 17. live ops, the audit plane and the forensics tools on a cluster
    p17 = phase_live(rounds, smi)
    p17l = p17["launches"]
    torch.cuda.empty_cache()
    # 18. the analysis plane: the lock-order and race witnesses on a
    # cluster, with 19 (a)'s cli verify and cli check beside it
    verify = start_verify(root)
    p18 = phase_analysis(rounds, model_a, smi)
    p18l = p18["launches"]
    del model_a
    torch.cuda.empty_cache()
    # 19. psmc: cli verify and cli check, the explorer and the race witness
    # on a card server
    p19 = phase_psmc(verify, smi)
    p19l = p19["launches"]

    kernels["ftrl_push"]["max_abs_err"] = max(kernels["ftrl_push"]["max_abs_err"], err_wd_k1,
                                              pod["err"]["ftrl_push"])
    kernels["adagrad_push"]["max_abs_err"] = max(kernels["adagrad_push"]["max_abs_err"],
                                                 err_wd_k3, pod["err"]["adagrad_push"])
    kernels["ftrl_push"]["launches_by_path"] = {
        "server": server_launches, "wide_deep": wd_launches["ftrl_push"],
        "pod_1x1_per_worker": pl["pod_1x1_per_worker"]["ftrl_push"],
        "pod_2x2_per_worker": pl["pod_2x2_linear_method-per_worker"]["ftrl_push"],
        "pod_2x2_quantized": pl["pod_2x2_linear_method-quantized"]["ftrl_push"],
        "pod_1x1_wd_per_worker": pl["pod_1x1_wd_per_worker"]["ftrl_push"],
        "pod_2x2_wd_per_worker": pl["pod_2x2_wide_deep-per_worker"]["ftrl_push"],
        "pod_2x2_wd_quantized": pl["pod_2x2_wide_deep-quantized"]["ftrl_push"],
        "wire_ftrl_server": wl["wire_ftrl_server"],
        "wire_train_linear_socket": wl["wire_train_linear_socket"],
        "wire_train_linear_mesh": wl["wire_train_linear_mesh"],
        "wire_train_linear_mesh_int8": wl["wire_train_linear_mesh_int8"],
        "cluster_deterministic": cl["cluster_a_ftrl_push"],
        "cluster_async": cl["cluster_b_ftrl_push"],
        "cluster_recovery": cl["cluster_c_ftrl_push"],
        "cluster_chaos": cl["cluster_e_ftrl_push"],
        "chaos_ftrl_server": csl["chaos_ftrl_server"],
        "serving_writer": csl["serving_writer"],
        "pool_1x1_dynamic": p16l["pool_1x1_dynamic_ftrl_push"],
        "pool_2x1_cli": p16l["pool_2x1_cli_ftrl_push"],
        "cluster_traced": p16l["cluster_traced_ftrl_push"],
        "wire_unarmed": p16l["wire_unarmed_ftrl_push"],
        "wire_armed": p16l["wire_armed_ftrl_push"],
        "live_cluster": p17l["live_cluster_ftrl_push"],
        "live_unarmed": p17l["live_unarmed_ftrl_push"],
        "arming_unarmed": p17l["arming_unarmed_ftrl_push"],
        "arming_armed": p17l["arming_armed_ftrl_push"],
        "witness_cluster": p18l["witness_armed_ftrl_push"],
        "witness_unarmed": p18l["witness_unarmed_ftrl_push"],
        "witness_arming_unarmed": p18l["witness_arming_unarmed_ftrl_push"],
        "witness_arming_armed": p18l["witness_arming_armed_ftrl_push"],
        "psmc_explored_server": p19l["psmc_explored_server"],
        "psmc_race_server": p19l["psmc_race_server"]}
    kernels["ftrl_push"]["wire"] = {"server": wire["ftrl"], "concurrent_sgd": wire["concurrent"],
                                    "train_linear": wire["train_linear"],
                                    "train_linear_checks": wire["train_linear_checks"]}
    kernels["ftrl_push"]["pod_1x1"] = pod["times"]["pod_1x1_per_worker"]
    kernels["ftrl_push"]["pod_1x1_wd"] = pod["times"]["pod_1x1_wd_per_worker"]
    kernels["adagrad_push"]["pod_1x1_wd"] = pod["times"]["pod_1x1_wd_per_worker"]
    kernels["ftrl_push"]["launches"] = sum(kernels["ftrl_push"]["launches_by_path"].values())
    kernels["ftrl_push"]["wide_deep"] = wd_kernels["ftrl_push"]
    kernels["adagrad_push"]["wide_deep"] = wd_kernels["adagrad_push"]
    kernels["adagrad_push"]["mf"] = k3_mf
    kernels["ftrl_delta"]["launches_by_path"] = {
        "worker": worker_launches["ftrl_delta"],
        "pod_1x1_aggregate": pl["pod_1x1_aggregate"]["ftrl_delta"],
        "pod_2x2_aggregate": pl["pod_2x2_linear_method-aggregate"]["ftrl_delta"],
        "pod_1x1_wd_aggregate": pl["pod_1x1_wd_aggregate"]["ftrl_delta"],
        "pod_2x2_wd_aggregate": pl["pod_2x2_wide_deep-aggregate"]["ftrl_delta"],
        "native_worker": p16l["native_worker_ftrl_delta"]}
    kernels["ftrl_delta"]["launches"] = sum(kernels["ftrl_delta"]["launches_by_path"].values())
    kernels["ftrl_delta"]["shard"] = pod["times"]["k2_shard"]
    wd_agg = pod["times"]["pod_1x1_wd_aggregate"]
    kernels["ftrl_delta"]["wd_shard"] = {
        "ms": wd_agg["ftrl_delta_ms"], "rows": WD_KEYS, "bound_ms": wd_agg["ftrl_delta_bound_ms"],
        "bound_by": wd_agg["ftrl_delta_bound_by"], "peak_memory_gib": wd_agg["peak_memory_gib"]}
    kernels["adagrad_push"]["launches_by_path"] = {
        "mf": mf_launches["adagrad_push"], "embedding_server": emb_launches,
        "codec_round_trip": codec_launches["adagrad_push"],
        "wide_deep": wd_launches["adagrad_push"],
        "pod_2x2_mf_per_worker": pl["pod_2x2_matrix_fac-per_worker"]["adagrad_push"],
        "pod_1x1_wd_per_worker": pl["pod_1x1_wd_per_worker"]["adagrad_push"],
        "pod_2x2_wd_per_worker": pl["pod_2x2_wide_deep-per_worker"]["adagrad_push"],
        "pod_2x2_wd_quantized": pl["pod_2x2_wide_deep-quantized"]["adagrad_push"],
        "wire_embedding_server": wl["wire_embedding_server"],
        "wire_embedding_server_fixed_point": wl["wire_embedding_server_fixed_point"],
        "cluster_adagrad": cl["cluster_d_adagrad_push"],
        "chaos_embedding_server": csl["chaos_embedding_server"]}
    kernels["adagrad_push"]["wire"] = {"server": wire["embedding"],
                                       "fixed_point": wire["fixed_point"]}
    kernels["ftrl_push"]["cluster"] = {k: cluster[k] for k in
                                       ("deterministic", "async", "recovery", "chaos")}
    kernels["ftrl_push"]["chaos"] = chs["ftrl"]
    kernels["adagrad_push"]["chaos"] = chs["embedding"]
    kernels["ftrl_push"]["serving"] = {k: chs[k] for k in ("serving", "shed")}
    kernels["ftrl_push"]["live"] = {k: p17[k] for k in ("cluster", "live", "offline",
                                                       "arming")}
    kernels["ftrl_push"]["analysis"] = {k: p18[k] for k in ("cluster", "arming")}
    kernels["ftrl_push"]["psmc"] = {k: p19[k] for k in ("verify", "serving", "seconds")}
    kernels["quantize_stochastic"]["launches_by_path"] = {
        "codec_round_trip": codec_launches["quantize_stochastic"],
        "wire_fixed_point_handles": wl["wire_fixed_point_handles"]}
    kernels["quantize_stochastic"]["launches"] = sum(
        kernels["quantize_stochastic"]["launches_by_path"].values())
    kernels["quantize_stochastic"]["wire"] = wire["fixed_point"]
    kernels["adagrad_push"]["launches"] = sum(kernels["adagrad_push"]["launches_by_path"].values())
    log(f"peak device memory {torch.cuda.max_memory_allocated() / 2**30:.2f} GiB; "
        f"total {time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [kernels[k] for k in
                                  ("ftrl_push", "ftrl_delta", "adagrad_push",
                                   "quantize_stochastic")]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind, "count": torch.cuda.device_count(),
    }}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
