#!/usr/bin/env python3
"""Chip smoke for the PyTorch port: serve the GraphTransformer parent
scorer (BASELINE config #3) and the MLP scorer, also behind the
micro-batcher and through the model registry's gate and the
shadow/canary rollout, train the GraphTransformer in gather mode and in
blocks mode and serve the results, run ring mode in
a world of one, run Ulysses attention, train GraphSAGE (BASELINE config
#2) with on-device sampling, and train the MLP bandwidth predictor
(BASELINE config #1) and the piece-cost model and rank parents with them
through the scheduler's ``ml`` and ``cost`` evaluators, replay a
100 000-decision columnar corpus from ``.npc`` segments through the
rule, ``ml`` and ``cost`` evaluators in batch, record a profiled swarm
through the scheduler's announce-stream recorder and run the recorded
A/B (train, gate, rule vs ``ml`` vs ``cost``) on it, run the
trainer's ``Training`` orchestrator from CSV dataset segments to the
gated registry, let 16 daemons probe each other live and upload the
scheduler's datasets through the announcer to the trainer service, which
trains and registers them, run federated multi-cluster training (BASELINE
config #4) through the crash-safe coordinator to a gated global model,
and train configs #1-#3 and the orchestrator data-parallel over
``torch.distributed`` ranks, and fan a Llama-3-8B safetensors shard
through the P2P client and scheduler into device memory (BASELINE
config #5), and train config #3 in ring mode with its rows sharded over
ranks and run ring attention, the pipeline and the experts across
ranks, and train config #3 tensor-parallel on (data, model) grids of
ranks and place a safetensors tensor split across ranks, on one NVIDIA
H100 through ``dragonfly2_tpu_torch``, with the
hand-written CUDA kernels.

Run from the repository root on a machine with one CUDA card:

    python3 chip_smoke.py

Phases (any failure exits nonzero, before the final line):

1. the card: name and power limit from ``nvidia-smi``;
2. build every kernel from ``dragonfly2_tpu_torch/ops/csrc`` (nvcc, in
   parallel);
3. each kernel against its plain PyTorch version at the config #3 shapes
   (``table_gather`` bit-equal, also at every row width from 16 to 512
   bytes, ``graph_flash_attention`` (K1) within the
   stated tolerances with its lse, ``table_scatter_add`` on the trainer's
   inverse index and on its own derived transpose, bit-identical across
   launches — run after phase 5, when the trainer's index exists),
   timed with CUDA events beside the plain version, one PyTorch library
   call and the byte/operation bound, K1 with lse off (serving) and on
   (training); K1's forward and backward on every row layout they take,
   with ragged and all-padding rows, an id out of range and K up to 512;
   the scatter-add on random indices with many duplicates and rows that
   receive nothing; and the whole model on a small graph, card against
   CPU, in f32: embeddings in both kernel-carrying modes, and every
   parameter's gradient of the training loss in gather, blocks and ring
   mode, while K1 must refuse autograd without the inverse index;
4. the main path: config #3 (20k hosts, 500k probes, hidden 128, embed
   64, 2 layers, 4 heads, neighbor cap 64, chunk 1024, bf16 compute) with
   seeded random weights, written as a port artifact and loaded through
   ``_gat_scorer_from_artifact`` in gather mode and in blocks mode, both
   installed with a seeded MLP in an ``InferenceService`` that answers
   ModelInfer requests and refuses invalid ones with the right codes.
   Every kernel's launch count is set to 0 just before and read just
   after; each must have launched;
5. train: config #3 trained in gather mode (``GATTrainer.fit``, the body
   of ``train_gat``; 8 epochs, 60 s cap) with the launch counts set to 0
   just before and read just after — the gather and scatter-add kernels
   must have launched exactly once a layer a forward and a backward, no
   other kernel at all, the loss must be finite and fall — then the
   steady step time (CUDA events), samples/s, F1, accuracy, peak memory,
   and a profile of 3 steps (device time by kernel, the device's busy
   share); train_to_serve: the trained result as a port artifact, loaded
   through ``_gat_scorer_from_artifact`` and answering ModelInfer
   requests that must equal the trained model's own scores;
6. train_blocks: the same run in blocks mode, through K1's forward and
   backward (launch counts exactly as many as the path needs, F1 and
   accuracy within the parity tests' band of gather mode's), served the
   same way; then k1_backward: the K1 backward against its plain twin on
   the blocks trainer's graph and inverse index, bf16 and f32, row by
   row, bit-identical across two launches, and on the same graph with
   rows cut to one valid slot, whose dval must be exactly 0; timed pass
   by pass (with gathered-byte rates and the scratch's bytes) beside its
   plain twin, SDPA's backward over the dense mask and the bound
   (``tests/k1_planted_faults.py`` shows that the row check fails
   kernels with planted faults);
7. embedding-pass times and peak device memory;
8. K3 (``flash_attention``, forward and backward) at the long-context
   tier, T = 32k causal: [32768, 8, 8] in bf16 (the main path's shape,
   the "mma" route: the ``mma.sync`` ring forward with its exponentials
   split between the SFU and an FP32 polynomial, whose split the library
   must report as the plain twin has it, and the fused backward) and f32
   (the "fma" route), [32768, 4, 128] in bf16 (the "sm90" route: TMA +
   ``wgmma``, which it must take), [32768, 8, 32] in bf16 (the "mma"
   route at its widest), against the plain version
   (``chunked_attention``) run in f32 on the same values, row by row,
   bit-identical across two launches, timed beside the plain version,
   SDPA and the bound (bytes, products or exponentials), the backward
   also launch by launch (delta, dK/dV, dQ or the fused block); then
   every head_dim the kernels take, and 24 and 96 (zero-padded by the
   wrapper), at ragged and tiny T, causal and not, f32 and bf16, each
   case bit-identical across two launches
   (``tests/k3_planted_faults.py`` shows that the row check fails
   kernels with planted faults on both bf16 routes);
9. ulysses, the slice 3 path: ``ulysses_attention`` on an NCCL
   group of one rank at [32768, 8, 8] bf16 causal, chunk 2048, forward
   and backward, with every launch count set to 0 just before and read
   just after — both K3 counts must be above 0 and the plain scan never
   called — against the plain version, peak memory below one head's
   dense [T, T] f32 scores (4.29 GB), fwd and fwd+bwd times;
10. ring_one: ring mode in a world of one at small width — a ring
   trainer's launches of K1 exactly as its path needs, its embeddings
   equal to blocks mode's on the same weights, its result served;
11. GraphSAGE, the slice 7 path: gnn_small_model (a small GraphSAGE in
   f32, on-device sampling and the K2a gather on the card against the
   same on the CPU: logits and every parameter's gradient), then
   train_gnn: config #2 (the 2000-host cluster's 2M probes, hidden 128,
   embed 64, fanouts (10, 5), batch 8192, sampling on the device;
   ``GNNTrainer.fit``, the body of ``train_gnn``, GNN_EPOCHS epochs, 60 s
   cap) with every launch count set to 0 just before and read just after
   — K2a exactly once a forward, no other kernel — a finite, falling
   loss and F1 ≥ 0.9, the steady step time, samples/s, quality, peak
   memory and a profile of 3 steps (device time by kernel, the device's
   busy share, the host's launches, copies, waits and costliest ops a
   step, and its pace a small op); train_gnn_to_artifact: the result as
   a ``gnn`` artifact, loaded back, its logits equal to the trained
   model's; gnn_sampling: sampling on the card bit-equal to the CPU's
   for the trainer's tables; K2a at the GraphSAGE shape (the [2000, 8]
   f32 feature table, one step's 999 424 concatenated indices),
   bit-equal and timed, carried on the K2a row as ``at_graphsage``;
   gather_library_profile: ``index_select`` and advanced indexing at
   that shape, int32 and int64 indices, profiled kernel by kernel; and
   train_gnn_host: the same run sampling on the host (prefetch
   threads), with the same launch, loss and F1 checks;
12. the MLP and the evaluators, the slice 9 paths: mlp_small_model (a
   small MLP in f32: the loss and every parameter's gradient, card
   against CPU), then train_mlp: config #1 (the 2000-host cluster's
   300 000 pair examples, hidden (128, 128, 64), batch 16384;
   ``MLPTrainer.fit``, the body of ``train_mlp``, MLP_EPOCHS epochs) with
   every launch count set to 0 just before and read just after — no
   kernel may launch — a finite, falling loss, an eval MAE below
   predicting the train mean, the steady step time and a profile of 3
   steps; train_mlp_to_serve: the result as an ``mlp`` artifact through
   ``_scorer_from_artifact`` and ModelInfer, whose 15-candidate replies
   must equal the trained model's own predictions bit for bit, and their
   p50; score_corpus: the 300 000 rows, and again shuffled, and sampled
   rows in requests of 1 to 64 rows, bit-identical (rows/s);
   ml_evaluator: ``new_evaluator("ml")`` on 200 seeded decisions of 15
   candidates, its orders against an f32 CPU copy of the artifact (equal,
   or differing only between candidates under ML_ORDER_GAP apart), and a
   NaN- and a zero-weighted artifact, each giving the rule evaluator's
   order on every decision, a guard trip each and one quarantine;
   train_cost: the cost model on a stand-in columnar corpus (with the
   launch counts set to 0 and read as for train_mlp), its predictions'
   correlation with realized cost above COST_CORR_MIN; cost_evaluator:
   orders by ascending predicted cost, ``is_bad_node`` verdicts equal to
   a CPU copy's, a verdict's cache miss and hit in µs, and a NaN-weighted
   cost artifact giving the rule evaluator's orders and verdicts; then
   the replay engine, the slice 17 path: replay_store (a 100 000-decision
   synthetic corpus, K = 16, through ``ReplayStoreWriter`` into four
   ``.npc`` segments and back through ``open_dir``: every segment's
   ``check_corpus`` green, every column equal to the corpus in memory, a
   segment cut before its tail marker and one with its first byte
   flipped refused by ``open_corpus`` and reported invalid by
   ``check_corpus``) and replay_vectorized (that corpus through
   ``replay_decisions_vectorized`` for the rule, ``ml`` and ``cost``
   evaluators, the learned ones scoring on the card through
   ``score_corpus``, with every launch count set to 0 just before and
   read just after — no kernel may launch: equal digests at 1 and 2
   shards, the sequential harness's digest, orders, guard counters and
   ``score_run`` metrics on the first 2 000 decisions, scores there
   within the bf16 parity tolerance of an f32 CPU copy's, orders over
   the whole corpus equal to the f32 CPU copy's except between
   candidates closer than that tolerance, and a NaN-weighted ``ml``
   artifact replaying the rule evaluator's digest with a fallback a
   decision; decisions/s sequential, vectorized and sharded); then the
   replay plane's recording half, the slice 18 path: swarm_record (a
   profiled RECORD_PEERS-peer swarm through the port's
   ``SchedulerService`` with a ``ReplayRecorder`` into a rotating
   scheduler ``Storage``, read back from disk: no swarm error, every
   decision recorded, finalized and read back, at least
   ``MIN_CORPUS_DECISIONS``; packed into ``.npc`` segments whose columns
   equal the events', and replayed there for the rule, ``ml`` and
   ``cost`` evaluators on the card with the sequential harness's digest
   on the events, no kernel launched), replay_ab (``run_replay_ab`` on
   the card at bench.py's replay stage size, with every launch count set
   to 0 just before and read just after — no kernel may launch: no
   error, deterministic replays, both gates promoting, ``ml`` and
   ``cost`` regret within bound, no swarm error; the gate's validation,
   regret, rank agreement, bad-node counts, decision latency, the train
   errors and the seconds of record, train, gate and A/B), swarm_ladder
   (``run_swarm_ladder`` at 100, 1 000 and 5 000 peers: no swarm error;
   the p99 ratio's 4 x bound printed, not gated) and recorder_overhead
   (the guard's announce p99 with the recorder on against off; its
   1.05 x bound printed, not gated);
13. the serving plane, the slice 10 paths: after the main path's
   requests, microbatch_gat (config #3's pair scorer behind the
   micro-batcher: the 8- and 32-thread rungs, and the replies of 32
   threads' coalesced requests, which must equal the solo scores bit for
   bit) and lifecycle_gat (behind a serving gather-mode incumbent under
   ModelInfer load, a blocks-mode and a gather-mode version through the
   validation gate and a shadow load on the card, canaried and promoted:
   K1 and K2a must launch exactly 2 passes × 2 layers a version, with the
   launch counts set to 0 just before and read just after; each pass's
   build time and the incumbent's p99 while the shadow's pass runs),
   then manager_plane (the manager as a service, slice 20:
   ``python -m dragonfly2_tpu_torch.cmd.manager`` in a child process, a
   root JWT, 8 scheduler clusters with CIDR, IDC and location scopes, 64
   instances registered and kept alive, 1 000 daemon dynconfig answers
   each equal to the same ``Searcher``'s pick recomputed here; a
   scheduler linked through ``connect_manager``, its row active and a
   PATCHed cluster config applied; config #3 v1 (blocks) and v2
   (gather) gated on the card and v2 served, a JWT rollback over REST
   after which the watcher rebuilds v1 on the card and ModelInfer
   equals a direct load of v1 exactly; a planted ``model.weights``
   fault under the MLP's v2 tripping the scheduler's guard, escalated
   through the link, v1 restored; the link's trace upload replayed by
   the next MLP candidate's gate; the REST calls' p50/p99; K1 and K2a
   exactly 2 passes × 2 layers each);
   after the evaluators, microbatch (the trained MLP behind
   ``InferenceService(micro_batch=True)`` at its defaults: the ladder at
   1, 8, 32 and 128 threads of 16-row requests; controls: the service
   unbatched, with one lane and with two at 8 and 32 threads, 128 threads
   with a 5 ms shed, and a ModelInfer burst at queue depth 2 whose
   RESOURCE_EXHAUSTED aborts must equal the batcher's sheds; and 32
   threads' coalesced replies bit-identical to solo scores), debug_vars (``DebugMonitor``'s
   ``/debug/vars`` with the ``serving``, ``scheduler`` and
   ``inference_batcher_stats`` blocks), shed (``new_evaluator("ml",
   micro_batch=True)`` at queue depth 2 under 128 threads: sheds counted
   alike by the evaluator and ``ml_sheds``, each the rule order, every
   other decision the solo ML order, no timeout, every lane drained) and
   lifecycle (an MLP at config #1's widths distilled from the rule
   scores, a ``ManagerService`` with the gate on and an
   ``InferenceService`` watcher under continuous ModelInfer load: good
   v1 gated and installed, a NaN version quarantined by the gate, v2
   shadowed, canaried on mirrored live batches and promoted, v3 under a
   ``model.weights`` fault tripping the shadow guard and quarantined, v4
   under a ``model.artifact`` fault failing to load once and never
   retried, an explicit rollback; ``model_reload_failures`` equal to the
   artifact faults, the load thread's only failures the injected
   UNAVAILABLE ones, health NOT_SERVING in grace windows, and device
   memory after ``stop()`` within one model's footprint of the start);
14. training, the slice 11 path: the 2000-host cluster's seeded records
   (20 000 NetworkTopology, 2 000 Download, and the cost stand-in's
   decisions as ReplayDecision records) written by the port's CSV writer
   as two closed segments of each kind in a ``TrainerStorage``, plus one
   topology segment left open; ``Training.train`` with all four jobs at
   their published widths (config #2's GraphSAGE sampling on the device,
   config #3's GraphTransformer in blocks mode, config #1's MLP, the cost
   model) into a ``ManagerService`` whose gate builds candidates on the
   card, with every launch count set to 0 just before and read just
   after — K2a, K1 and K1's backward exactly as often as the steps, eval
   chunks and the gate's embedding pass need, no other kernel — no job
   error, F1 ≥ GNN_F1_MIN for both graph jobs, the MLP's eval MAE below
   the train mean, each model's gate verdict, every closed segment
   deleted and the open one kept, the host seconds of each stage and
   each job's samples/s; then training_to_serve: an ``InferenceService``
   whose ``reload_from_manager`` installs the gate-activated ``gat``
   version, and one ModelInfer with finite scores;
14b. probe_loop, the slice 19 path (the ML loop's collection half): 16
   port daemons on one in-process ``SchedulerService`` (a
   ``NetworkTopologyStore`` over its dataset storage, a
   ``ReplayRecorder`` on its scheduling core), each ``Prober`` TCP-
   pinging its candidates every 0.05 s for 5 s while every daemon
   downloads 4 files of 4 MiB from a local origin in waves (1, 3, 12);
   4 snapshots of the store → the topology, download and replay
   datasets → ``Announcer.train()`` (64 KiB chunks) → the port's
   ``TrainerService.Train`` → ``Training.train`` with the training
   phase's jobs at their published widths → the gating
   ``ManagerService`` → ``reload_from_manager`` → ModelInfer on every
   installed version, with every launch count set to 0 just before the
   upload and read after the last ModelInfer — exactly the training
   part's predicted launches on the loop's graph plus one K1 a layer for
   the reload — every prober reporting, no failed probe, no probe cycle
   raising, every host in the store, the accepted bytes the snapshot's,
   no dataset or segment left, no job error, every registry row with
   the announcer's host and scheduler id, the ``gat`` version active and
   its served scores within MODE_TOL of the plain twin's on the card;
15. federated training, the slice 12 path (BASELINE config #4), after a
   check that the profiler's kernel count sees K2a launches
   (profiler_check: of PROFILER_CHECK launches, how many it recorded):
   federated (``run_federated_bench(seed=SEED, include_kill=True)`` on
   the card at the JAX bench's settings — the clean fleet's rounds
   through ``FederationCoordinator``, registered through the gate and
   replayed against each solo model and the rule; the poisoned fleet's
   screens, escalation and quarantine; the child coordinator SIGKILLed
   mid-round and resumed from its journal without retraining —
   ``verdict_pass`` required) and federated_config4 (config #1's 300 000
   examples over three band clusters at (128, 128, 64), batch 16384,
   FedAvg over 3 rounds at quorum 3 with a gating registry: every round
   committed, a second fresh run and a run whose round 0 first fails
   quorum and resumes bit-identical to the first, the global's
   pooled-holdout MAE below the train mean, each round's seconds split
   into local fits, screening, aggregation, journal writes and the gate,
   and, when the gate activates the global, ``reload_from_manager`` and
   ModelInfer). On both, every launch count is set to 0 just before and
   read just after, and the profiler counts the port's kernels by name:
   no kernel may launch (the path is dense products);
16. data parallelism, the slice 13 path (the JAX mesh's ``data`` axis):
   dp_world_one (a child process joins a world of one over NCCL through
   ``init_multihost`` from the ``DF2_*`` environment and trains config
   #2 GraphSAGE for one epoch: its parameters must equal the no-group
   run's bit for bit), dp_train (DP_WORLD ranks spawned once on the one
   card over gloo, each checking all_reduce and broadcast on a CUDA
   tensor, then training config #2 with sampling on the device and on
   the host, config #1, config #3 in blocks and in gather mode cut to
   one epoch at WORLD_GAT_BATCH (29 steps), and ``Training.train`` on
   the training phase's records
   with ``group=`` the world: both ranks' parameter digests equal, gaps
   to the world-of-one runs within the CPU tests' limits, each rank's
   K1, K2a and K2b launches as predicted, rank 0 alone uploading; the
   step, the all-reduce's time and share, samples/s and each rank's
   peak memory, labelled "gloo, 2 ranks on one card") and
   dp_nccl_cards (the same over NCCL with a rank a card where there are
   several cards; logged as waiting on one);
17. BASELINE config #5, the slice 14 path (no kernel: the copies are
   host-to-device DMAs): hbm_sink_small (``HBMSink`` onto cuda:0 at test
   size: pieces in reversed order with the header last and the data at
   an odd offset, every safetensors dtype, the header and first tensor
   alone until that tensor lands, a write past the end, a timeout's
   progress message; every tensor bit-equal to its source after a copy
   back; the copies' event seconds) and hbm_fanout (Llama-3-8B's
   embedding and layers 0-8 at their published shapes in bf16, 4 976
   689 152 data bytes from per-tensor seeded streams, offsets padded to
   64 bytes, at an origin served by ``OriginServer`` → the port's
   in-process ``SchedulerService`` with a SUPER_SEED daemon and a peer
   that downloads the file first → a third daemon's ``download_to_hbm``
   onto cuda:0, with every launch count set to 0 just before and read
   just after (no kernel may launch): every tensor bf16 at its shape,
   its bytes copied back equal to the sha256 made when the file was
   written, a tensor on the card before the last piece; the JAX
   artifact's quantities — last piece, last tensor, the tail, the same
   copies again after the fact, overlap hidden, download and
   host-to-device rates — plus the pinned staging allocation, the
   sink's write share, peak memory, ``native.available()``, the piece
   size and count and a timeline; fewer layers only if the disk is
   short, and everything deleted after);
18. sequence, pipeline and expert parallelism, the slice 15 paths (each
   over a process group; no kernel may launch on them): first the world
   of one in this process over a one-rank NCCL group (config #3 in ring
   mode through K1 with the same seed, cut to one epoch; the layouts
   without an exchange), then PAR_WORLD gloo ranks spawned once on the
   one card: ring_gat_ranks (config #3 in ring mode, rows padded to
   20 480 and sharded 10 240 a rank, K/V blocks around the ring, the
   embeddings all-gathered for the pair head, one epoch of 29 steps at
   batch WORLD_GAT_BATCH:
   equal digests, the loss and F1 gaps to the world of one, the trained
   weights' embeddings against blocks mode's, rank 0's artifact served
   in a world of one through K1 and ``InferenceService``, every rank's
   hops, gathers and staged bytes as predicted, step time, a hop's time
   and peak memory), ring_attention ([8192, 8, 8] bf16 causal with the
   last 5 % of keys masked: both worlds' outputs and gradients against
   the f32 dense reference row by row, and the forward's peak memory
   above its inputs at world 2 at most RING_ATT_MEMORY_SHARE of world
   1's) and pipeline_moe (``pipeline_apply`` with 8 microbatches and
   ``moe_apply`` at capacity factors 8 and 1.25 at width 128 over 20 480
   rows: outputs and gradients against the sequential and dense
   references, the drops as the reference counts them); then
   parallel_nccl_cards (the same over NCCL with a rank a card where
   there are several cards; logged as waiting on one);
19. tensor parallelism, the slice 16 path (the JAX mesh's model axis):
   tp_world_one (config #3 in blocks and in gather mode on a one-rank
   NCCL group, one epoch, the reference runs), then tp_grid: gloo ranks
   spawned on the one card as a 1 x 2 and then a 2 x 2 ``(data,
   model)`` grid (``multihost_grid``), each training config #3 in blocks
   mode (K1 forward and backward on a rank's 2-head share, its query
   rows against every row's K/V) and in gather mode (K2a and K2b on
   256-byte [k|v] rows), cut to one epoch: the grid laid out as JAX's
   mesh, equal digests of the replicated parameters and of the gathered
   state, the loss gap to the world of one within TP_LOSS_TOL (F1
   logged), every rank's launches, exchanges and staged bytes as
   predicted, its parameter and optimizer bytes below the replicated
   ones, step time, samples/s and peak memory, and rank 0's artifact
   served in a world of one against the ranks' scores; tp_kernels (the
   four kernels at the path's new shapes — K1 with 10 240 query rows
   against 20 480 key rows at 2 heads of 32, K2a and K2b at 256-byte
   rows — against their plain twins, timed beside their library calls
   and bounds); tp_nccl_cards (the 2 x 2 grid over NCCL with a rank a
   card where there are 4 cards; logged as waiting with fewer); and
   hbm_sink_sharded (``HBMSink(shard_for=...)`` on a 2-way split: each
   rank's block bit-equal to the file's rows, its bytes alone on the
   card).

Prints a ``{"kernels": [...]}`` line, the ``nvidia-smi`` line, and last
``{"ok": true, "device": {...}}``. Imports nothing of JAX.
"""

from __future__ import annotations

import json
import os
import shutil
import subprocess
import sys
import time
import types

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))

# Published H100 SXM peaks (NVIDIA data sheet): HBM3 bytes/s, dense bf16.
PEAK_BYTES_PER_S = 3.35e12
PEAK_BF16_FLOPS = 989e12
PEAK_F32_FLOPS = 67e12                      # outside the tensor cores
# Exponentials: the special-function units do 16 a clock on each of the
# 132 SMs at the 1.98 GHz boost clock. Beside them the FP32 pipes (67e12
# flops = 33.5e12 instructions a second) can compute exp2 as a cubic
# polynomial, as FlashAttention-4 does: a round, a subtract and three
# FMAs, 5 FP32 instructions (the exponent's shift and add go to the
# integer pipe). The card's floor for exps counts both at once.
SFU_EXP_PER_S = 132 * 16 * 1.98e9
POLY_EXP2_FP32_INSTRUCTIONS = 5
PEAK_EXP_PER_S = SFU_EXP_PER_S + PEAK_F32_FLOPS / 2 / POLY_EXP2_FP32_INSTRUCTIONS

SEED = 0
N_HOSTS, N_EDGES = 20_000, 500_000          # artifacts/gat_bench.py
GAT_CFG = dict(hidden=128, embed=64, layers=2, heads=4, chunk=1024)
NEIGHBOR_CAP = 64

# Kernel vs plain version on identical inputs. bf16: the plain version
# rounds scores to bf16 and rescales p per 1024-column key block, the
# kernel keeps f32 scores and one exact max, so p rounds to bf16 against
# a different reference — a few bf16 ulps of |out| ≤ ~4. f32: the same
# algebra in another order; lse (f32, |lse| up to ~10) likewise, 1e-4.
FLASH_TOL = {"bf16": 5e-2, "f32": 2e-5, "lse": 1e-4}
# Gather vs blocks embeddings (and scores) of the same model: the
# tolerance tests/test_gat.py holds the JAX package's modes to.
MODE_TOL = 6e-2
# Whole model, card kernels against the CPU plain path, f32 compute.
SMALL_F32_TOL = 1e-4
# MLP bf16 on the card against the same weights in f32 on the CPU.
MLP_TOL = 6e-2
# Scatter-add kernel against its plain version: both sum each row's terms
# in f32 in ascending position order and round once, so they should agree
# bit for bit; the tolerance allows one bf16 ulp (2^-8) of the largest
# entry, for a summation order that differs.
SCATTER_ULP = 2.0 ** -8
# Gradients of the training loss, card against CPU, f32: each leaf's max
# |error| over its max |grad|, floored at 1e-3 of the largest leaf's (the
# key bias's true gradient is 0 and holds rounding noise on both sides).
GRAD_F32_TOL = 1e-4
# K3 against the plain version run in f32 on the same values
# (k3_reference), row by row: for each (position, head) row of out, dq,
# dk and dv, |got − ref| over |ref|, 2-norms over head_dim, and the worst
# row. (A limit on max |err| cannot see a fault in late causal rows,
# where |out| ~ 1/sqrt(row).) A row's |ref| is floored at LOCAL_FLOOR of
# the rms row norm of its ROW_TILE rows: where a row's few terms cancel,
# bf16 rounding of each term is large against their sum. And at
# ROW_FLOOR of the tensor's rms row norm (dq, dk and dv together): at
# T = 1 the true dq and dk are 0 and both sides hold rounding noise.
ROW_TILE = 64
LOCAL_FLOOR = 0.25
ROW_FLOOR = 1e-3
# Limits over the worst row this script measured over every K3 case on
# an H100 (PERF.md): bf16 out 1.4x, gradients 2.5x; f32 out 3.8x,
# gradients 4.7x. f32: the same algebra in another summation order.
# bf16: out, dq, dk and dv round once to bf16 (2^-8 of a row at most),
# and every product takes bf16 inputs (p before P·V, as K3 rounds it; p
# and ds in the backward). tests/k3_planted_faults.py shows that a key
# or query tile dropped far from the diagonal fails these limits.
K3_TOL = {"f32": {"out": 5e-5, "grad": 1e-4},
          "bf16": {"out": 3e-2, "grad": 6e-2}}
# K1's gradients against its plain twin run in f32 on the same values,
# row by row as K3's (k1_errors): dq, dk, dv and dval, K3's gradient
# limits. bf16: the kernel reads bf16 and sums in f32, then rounds dq, dk
# and dv once; f32: another summation order. tests/k1_planted_faults.py
# shows that a dropped slot, a dropped position, delta taken as 0, a
# one-head dval, a dK/dV pass that forms ds without r or that reads
# another row's (lse, r, delta) fails them.
K1_GRADS = ("dq", "dk", "dv", "dval")
K1_TOL = {name: tol["grad"] for name, tol in K3_TOL.items()}
# The long-context tier (tests/test_ulysses.py:106-131): T = 32k causal,
# 8 heads of 8, chunk 2048; and the TPU smoke's head width, 4 x 128.
LONG_T = 32_768
# head_dims that are not kernel widths: flash_attention zero-pads them.
PADDED_HEAD_DIMS = (24, 96)
# The memory class of that tier: below one head's dense [T, T] f32 scores.
DENSE_SCORES_BYTES = LONG_T * LONG_T * 4
# The train phase: artifacts/gat_bench.py:36-43 with a short run: 8
# epochs (472 steps). Where a run leaves the majority-class plateau, and
# then its second drop, move by tens of steps with rounding, so a short
# run gives the two modes different F1 (after 2 epochs 0 and 0.60, after
# 4 0.9994 and 0.70); after 6, 8 and 12 epochs, and at seeds 1 and 2,
# both measured the same F1 (PERF.md).
TRAIN_CFG = dict(hidden=128, embed=64, layers=2, heads=4, neighbor_cap=64,
                 edge_batch_size=8192, eval_fraction=0.02, epochs=8,
                 max_seconds=60)
# The worlds of ring_gat_ranks and tp_grid, and their world-of-one
# references, train config #3 for one epoch at twice this batch: 29
# steps instead of 59. Their step is a full-graph pass whatever the
# batch, so the spawned worlds' runs take about half as long.
WORLD_GAT_BATCH = 2 * TRAIN_CFG["edge_batch_size"]
# Blocks mode trains the same run (rows padded to the 1024-row chunks)
# and must land within the CPU parity tests' F1 and accuracy band
# (tests/test_torch_train.py) of gather mode's on the same split.
TRAIN_F1_ATOL, TRAIN_ACCURACY_ATOL = 0.1, 0.05
# Ring mode in a world of one, at small width: 300 hosts, rows padded to
# 64-row chunks.
RING_CFG = dict(hidden=32, embed=16, layers=2, heads=4, neighbor_cap=16,
                chunk=64, edge_batch_size=256, epochs=1, eval_fraction=0.1,
                attention="ring")
# GraphSAGE, BASELINE config #2 (bench.py:382-386, :409): the 2000-host
# cluster's 2M probes, hidden 128, embed 64, fanouts (10, 5), batch 8192,
# lr 5e-3, weight decay 1e-4, eval fraction 0.02; trained with sampling on
# the device (bench.py:409), then once with sampling on the host.
# GNN_EPOCHS is the fewest epochs after which seeds 0, 1 and 2 all reached
# GNN_F1_MIN (tests/gnn_epochs_quality.py on the card, PERF.md).
GNN_HOSTS, GNN_EDGES = 2000, 2_000_000
GNN_EPOCHS = 1
GNN_CFG = dict(hidden=128, embed=64, fanouts=(10, 5), batch_size=8192,
               learning_rate=5e-3, weight_decay=1e-4, eval_fraction=0.02,
               epochs=GNN_EPOCHS, max_seconds=60)
GNN_F1_MIN = 0.9
# The MLP bandwidth predictor, BASELINE config #1 (bench.py:441-446): the
# 2000-host cluster's 300 000 pair examples, hidden (128, 128, 64), batch
# 16384, lr 3e-3, weight decay 1e-4, warmup 100, eval fraction 0.1, bf16
# compute with f32 params; MLP_EPOCHS epochs (bench.py runs up to 100
# under a 25 s cap): the fewest after which the eval MAE was below
# predicting the train mean, and the loss below 0.8 (tests/test_train_mlp.py
# :38), at seeds 0, 1 and 2 (tests/mlp_epochs_quality.py, PERF.md).
MLP_HOSTS, MLP_ROWS = 2000, 300_000
MLP_EPOCHS = 1
MLP_CFG = dict(hidden=(128, 128, 64), batch_size=16384, learning_rate=3e-3,
               weight_decay=1e-4, warmup_steps=100, eval_fraction=0.1,
               epochs=MLP_EPOCHS, max_seconds=60)
# The cost model's stand-in corpus (``synth_replay_corpus``'s realized
# costs are noise uncorrelated with its features, so a cost model trained
# on it learns nothing): COST_ROWS of those pair rows as decisions of
# COST_SLOTS candidate slots, realized cost the seconds of a PIECE_MB
# piece at the pair's bandwidth, trained at CostTrainConfig's defaults. tests/test_replay.py:319-326
# bounds the correlation of predicted with realized cost at 0.9 on a
# recorded corpus whose best predictor reaches 1 (the port's model 0.999
# there, tests/test_torch_mlp_train.py). Here the label's congestion
# factor (lognormal, σ 0.35, unseen by the features) caps the best
# possible predictor at COST_CORR_CEILING (tests/cost_standin_ceiling.py),
# so the bound is 0.9 of that.
COST_ROWS, COST_SLOTS, PIECE_MB = 20_000, 16, 4.0
COST_CORR_CEILING = 0.8712
COST_CORR_MIN = 0.9 * COST_CORR_CEILING
# The evaluators: seeded decisions of 15 candidates (the scheduler's
# filterParentLimit). bf16 scores on the card may order candidates
# closer than the bf16 parity tolerance differently from an f32 copy.
ML_DECISIONS, ML_CANDIDATES = 200, 15
ML_ORDER_GAP = 6e-2
# The replay plane (slice 17): the throughput ladder's top rung
# (replaybench.LADDER_RUNGS) of synthetic decisions, K = 16 slots, written
# as REPLAY_SEGMENT-decision .npc segments; the sequential harness on the
# first REPLAY_SEQ_DECISIONS, the fan-out at REPLAY_SHARDS shards.
REPLAY_DECISIONS = 100_000
REPLAY_SEGMENT = 25_000
REPLAY_SEQ_DECISIONS = 2_000
REPLAY_SHARDS = 2
# The shards' prefetch workers. Two Python threads driving one card's
# 64-row forwards ran at 0.53-0.57 x one thread (GIL contention; the
# first proof run of this phase, PERF.md): one worker still takes the
# shard split, the prefetch and the in-order merge the digest covers.
REPLAY_WORKERS = 1
# The replay plane's recording half (slice 18): bench.py's replay stage
# (replaybench.run_replay_ab: 600 profiled peers, 4 announce workers),
# the recorded corpus packed into RECORD_SEGMENT-decision .npc segments,
# and the scheduler stage's ladder (loadbench.check_scheduler_regression's
# sizes, 8 workers).
RECORD_PEERS = 600
RECORD_WORKERS = 4
RECORD_SEGMENT = 200
SWARM_LADDER_SIZES = (100, 1000, 5000)
SWARM_LADDER_WORKERS = 8
# Request sizes held bit-identical to score_corpus: one row, the bucket
# edges of the JAX package's scorer (8 … 64) and a row past each.
SCORE_REQUEST_ROWS = (1, 8, 15, 16, 17, 32, 33, 64)
# The serving plane (slice 10): the micro-batcher ladder at the inference
# service's defaults (2 lanes, queue depth 32, adaptive window 0.5 ms,
# max_batch 64), REQUEST_ROWS-row requests, LADDER_S seconds a rung; bit
# identity of coalesced replies against solo scores from IDENTITY_THREADS
# threads; sheds under SHED_THREADS threads at queue depth 2; the model
# lifecycle with the watcher polling every LIFECYCLE_TICK_S, grace windows
# of LIFECYCLE_GRACE_S, and every LIFECYCLE_UNAVAILABLE_NTH-th ModelInfer
# aborted by the fault plan. Half a second a rung (hundreds of requests
# at one thread) keeps the whole script's time inside its budget; no
# check reads a rung's length.
REQUEST_ROWS = 16
LADDER_S = 0.5
MLP_LADDER_THREADS = (1, 8, 32, 128)
GAT_LADDER_THREADS = (8, 32)
IDENTITY_REQUESTS, IDENTITY_THREADS = 800, 32
SHED_THREADS, SHED_DECISIONS = 128, 1024
# The ladder's controls: unbatched and one-lane service rungs at these
# thread counts, the 128-thread rung with a SLOW_SHED_S fallback, and a
# SHED_BURST_S burst of ModelInfer at queue depth 2.
SERVICE_CONTROL_THREADS = (8, 32)
SLOW_SHED_S, SHED_BURST_S = 0.005, 1.0
LIFECYCLE_TICK_S, LIFECYCLE_GRACE_S = 0.25, 0.5
LIFECYCLE_UNAVAILABLE_NTH = 97
# The manager as a service (slice 20), at a fleet's size: 8 scheduler
# clusters of 8 instances (the 64 of a large Dragonfly deployment's
# scheduler tier), 1 000 daemons asking for their schedulers. The linked
# scheduler keeps alive and polls its dynconfig every MANAGER_TICK_S
# (JAX's default 5 s and 60 s, shortened for a run of seconds) under a
# pre-assigned id. A rollback rebuilds v1 on the card from the same
# artifact through the same kernels: its scores must equal a direct
# load's exactly.
MANAGER_CLUSTERS, MANAGER_SCHEDULERS, MANAGER_QUERIES = 8, 64, 1000
MANAGER_TICK_S = 0.1
MANAGER_START_TIMEOUT_S = 60.0
MANAGER_SCHEDULER_ID = 1000
MANAGER_WARM_DECISIONS = 8
MANAGER_ROLLBACK_TOL = 0.0
# The training orchestrator (slice 11): records of config #2's 2000-host
# cluster (bench.py:382-386) from one SyntheticCluster, topology first,
# written as CSV segments: TRAINING_TOPOLOGY NetworkTopology records
# (~3 probe edges each; config #2 has 2 M probes), TRAINING_DOWNLOADS
# Download records (~2.5 pair examples each; config #1 has 300 000), and
# the cost stand-in's decisions as ReplayDecision records, each kind in
# TRAINING_SEGMENTS closed segments, plus one topology segment left open.
# The models keep their published widths: config #2's GraphSAGE, config
# #3's GraphTransformer in blocks mode, config #1's MLP, CostTrainConfig().
# Each *_EPOCHS is the fewest after which seeds 0-2 reached GNN_F1_MIN
# (graph jobs), or an eval MAE below predicting the train mean and a last
# epoch's loss below 0.8 (the MLP, as MLP_EPOCHS), on this data
# (tests/training_epochs_quality.py: GraphSAGE and the MLP on the CPU and
# the card, the GraphTransformer on the card only, its CPU twins being
# too slow for a search). The GraphTransformer's also holds with its rows
# sharded over the dp_train phase's 2 ranks: where the run leaves the
# majority plateau is chaotic in bf16 (a world of one stays on a second
# plateau at seed 1 after 32 epochs, the 2 ranks at seed 0 after 16),
# and of 16, 24, 32, 40 and 48 epochs, 40 is the fewest after which
# seeds 0-2 left it in both (tests/gat_rows_epochs_quality.py, PERF.md).
# The data is small against the published batches: 6 GraphSAGE steps an
# epoch, 13 GraphTransformer steps, and one MLP step (its batch clamps to
# the ~4 500-row train split).
TRAINING_HOSTS, TRAINING_TOPOLOGY, TRAINING_DOWNLOADS = 2000, 20_000, 2_000
TRAINING_SEGMENTS = 2
TRAINING_GNN_EPOCHS = 16
TRAINING_GAT_EPOCHS = 40
TRAINING_MLP_EPOCHS = 4
TRAINING_GNN_CFG = dict(hidden=128, embed=64, fanouts=(10, 5),
                        batch_size=8192, device_sample=True,
                        epochs=TRAINING_GNN_EPOCHS)
TRAINING_GAT_CFG = dict(hidden=128, embed=64, layers=2, heads=4,
                        neighbor_cap=64, chunk=1024, attention="blocks",
                        epochs=TRAINING_GAT_EPOCHS)
TRAINING_MLP_CFG = dict(hidden=(128, 128, 64), batch_size=16384,
                        epochs=TRAINING_MLP_EPOCHS)
TRAINING_IP, TRAINING_HOSTNAME = "10.0.0.1", "scheduler-1"
TRAINING_HOST_ID, TRAINING_SCHEDULER_ID = "scheduler-host-1", 1
# The ML loop's collection half (slice 19), phase "probe_loop":
# PROBE_DAEMONS port daemons on one in-process SchedulerService whose
# topology store writes into its dataset storage and whose scheduling
# core records decisions, each daemon's prober ticking every
# PROBE_INTERVAL_S (TCP connects to the candidates' upload ports, at most
# PROBE_TIMEOUT_S each) for at least PROBE_SECONDS, PROBE_SNAPSHOTS
# snapshots of the store spread over that window; meanwhile each of
# PROBE_FILES files of PROBE_FILE_BYTES is downloaded from a local origin
# by every daemon in PROBE_WAVES (one back to source, then 3, then the
# other 12 from parents). The announcer uploads the three datasets in
# PROBE_UPLOAD_CHUNK chunks to the port's TrainerService, which trains
# training_config()'s jobs at their published widths and epochs: on this
# 16-host graph an epoch is one step of each graph job.
PROBE_DAEMONS = 16
PROBE_INTERVAL_S = 0.05
PROBE_TIMEOUT_S = 0.5
PROBE_SECONDS = 5.0
PROBE_SNAPSHOTS = 4
PROBE_FILES = 4
PROBE_FILE_BYTES = 4 << 20
PROBE_WAVES = (1, 3, 12)
PROBE_UPLOAD_CHUNK = 64 << 10
PROBE_DOWNLOAD_TIMEOUT_S = 120
PROBE_IP, PROBE_HOSTNAME, PROBE_PORT = "10.0.0.2", "scheduler-2", 8002
PROBE_HOST_ID, PROBE_SCHEDULER_ID = "scheduler-host-2", 2
# Federated training (slice 12, BASELINE config #4). Phase "federated"
# runs the port's fedbench at the JAX bench's own settings
# (run_federated_bench's defaults: 3 clusters x 300 decisions, a
# 400-decision eval corpus, 2 rounds, the kill rung's child on the card).
# Phase "federated_config4" runs config #4 at config #1's scale and
# widths: config #1's 300 000 examples (bench.py:441-446) split over
# three band clusters, FED4_DECISIONS decisions each (~6 candidates a
# decision, ~100 000 examples), locals at config #1's widths and batch
# with FED4_EPOCHS = TRAINING_MLP_EPOCHS (the training phase's MLP
# epochs; PERF.md §6 says why they stay), FedAvg over FED4_ROUNDS rounds
# at quorum 3 (tests/fed4_epochs_quality.py measures epochs and rounds).
FED4_CLUSTERS, FED4_DECISIONS, FED4_ROUNDS = 3, 16_667, 3
FED4_EPOCHS = TRAINING_MLP_EPOCHS
FED4_LOCAL_CFG = dict(hidden=(128, 128, 64), batch_size=16384,
                      learning_rate=3e-3, eval_fraction=0.1,
                      epochs=FED4_EPOCHS, seed=SEED)
FED_EVAL_DECISIONS = 400
# K2a launches the profiler is shown before the federated phases' zero
# counts are read from it (check_profiler_sees_kernels).
PROFILER_CHECK = 500
# Data parallelism (slice 13): DP_WORLD ranks on the one card over gloo
# (NCCL refuses two ranks on one card), each job as its own phase trains
# it but without a wall-clock cap, config #3 cut to DP_GAT_EPOCHS epoch
# (59 steps of 8192), and Training.train on the training phase's
# records. Gaps of rank 0's final loss, F1 and MAE to the world of one's
# on the card: the limits the CPU tests hold bf16 runs to
# (tests/test_torch_data_parallel.py against the JAX trainer: losses
# 1e-2 for GraphSAGE and the MLP, 5e-2 for the GraphTransformer, MAE 5e-2
# relative; F1 0.05 as tests/test_torch_graphsage.py, 0.1 as
# tests/test_torch_train.py). The all-reduce is timed over
# DP_ALLREDUCE_ITERS calls after each job.
DP_WORLD = 2
DP_GAT_EPOCHS = 1
DP_LOSS_TOL = {"gnn": 1e-2, "mlp": 1e-2, "gat": 5e-2}
DP_F1_TOL = {"gnn": 0.05, "gat": 0.1}
DP_MAE_RTOL = 5e-2
DP_ALLREDUCE_ITERS = 20
DP_TIMEOUT_S = 300
# BASELINE config #5 (slice 14): a safetensors file with Llama-3-8B's
# tensor names and shapes from its published config.json (hidden 4096,
# intermediate 14336, 32 heads, 8 KV heads of 128, vocab 128256, bf16),
# cut to the size of the model's published first shard: the embedding
# and layers 0-8 whole, 4 976 689 152 data bytes of 16.06 GB.
LLAMA3_8B = dict(hidden=4096, intermediate=14336, kv_width=8 * 128,
                 vocab=128256)
FANOUT_LAYERS = 9
FANOUT_DATA_BYTES = 4_976_689_152
# Data offsets padded to FANOUT_ALIGN bytes, as real files are; each
# tensor's bytes from its own seeded stream (np.random.default_rng((SEED,
# tensor index))), written in FANOUT_CHUNK-byte chunks.
FANOUT_ALIGN = 64
FANOUT_CHUNK = 64 << 20
# The origin and three daemon stores each hold the file; FANOUT_DISK_SLACK
# more must be free, or the phase takes fewer layers and says so.
FANOUT_COPIES = 4
FANOUT_DISK_SLACK = 1 << 30
FANOUT_TIMEOUT_S = 900
FANOUT_SAMPLE_S = 0.25
# Each row of the kernels line → the __global__ functions of its
# sources, read from the profiler's kernel names.
KERNEL_FUNCTIONS = {
    "table_gather": ("table_gather_kernel",),
    "table_scatter_add": ("table_scatter_add_kernel",),
    "graph_flash_attention": ("graph_flash_kernel",),
    "graph_flash_attention_backward": ("graph_flash_dq_kernel",
                                       "graph_flash_dkdv_kernel"),
    "flash_attention": ("fwd_kernel", "fwd_ring_kernel"),
    "flash_attention_backward": ("bwd_fused_kernel", "delta_kernel",
                                 "dkdv_kernel", "dq_kernel"),
}


T_IMPORT = time.perf_counter()


def log(phase: str, **fields) -> None:
    """One JSON line; ``at`` is the seconds since the script started, so
    consecutive lines give each phase's seconds."""
    print(json.dumps({"phase": phase, "at": time.perf_counter() - T_IMPORT,
                      **fields}), flush=True)


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call over ``iters`` back-to-back calls."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(n_bytes: float, n_flops: float,
             peak_flops: float = PEAK_BF16_FLOPS,
             n_exps: float = 0.0) -> tuple[float, str]:
    """The least time for the work: bytes over the memory rate, or the
    operations — products at ``peak_flops`` and exponentials at the
    special-function units' rate, which run beside each other, so the
    slower of the two — whichever is larger."""
    t_bytes = n_bytes / PEAK_BYTES_PER_S * 1e3
    t_ops = max(n_flops / peak_flops, n_exps / PEAK_EXP_PER_S) * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


class Counts:
    """Every kernel's launch count, by its row name in the kernels line;
    K3's forward and backward counts both live on ``flash_attention``,
    K1's on ``graph_flash_attention``."""

    def __init__(self):
        from dragonfly2_tpu_torch.ops.flash_attention import (
            flash_attention,
            graph_flash_attention,
        )
        from dragonfly2_tpu_torch.ops.table_gather import (
            table_gather,
            table_scatter_add,
        )

        self._where = {
            "table_gather": (table_gather, "launches"),
            "graph_flash_attention": (graph_flash_attention, "launches"),
            "table_scatter_add": (table_scatter_add, "launches"),
            "flash_attention": (flash_attention, "launches"),
            "flash_attention_backward": (flash_attention,
                                         "backward_launches"),
            "graph_flash_attention_backward": (graph_flash_attention,
                                               "backward_launches"),
        }

    def reset(self) -> None:
        for fn, attr in self._where.values():
            setattr(fn, attr, 0)

    def read(self) -> dict:
        return {name: getattr(fn, attr)
                for name, (fn, attr) in self._where.items()}


def check_table_gather(torch, table, idx) -> dict:
    from dragonfly2_tpu_torch.ops import table_gather as _tg
    from dragonfly2_tpu_torch.ops.table_gather import (
        table_gather,
        table_gather_plain,
    )

    out = table_gather(table, idx)
    ref = table_gather_plain(table, idx)
    torch.cuda.synchronize()
    if not torch.equal(out, ref):
        raise AssertionError("table_gather differs from table[idx]")
    err = float((out.float() - ref.float()).abs().max())
    # The kernel alone, and through the wrapper, whose index range check
    # waits for the device once a call.
    lib, stream = _tg._lib("table_gather"), torch.cuda.current_stream()
    ms = cuda_ms(torch, lambda: lib.df2_table_gather(
        table.data_ptr(), idx.data_ptr(), out.data_ptr(), idx.shape[0],
        table.shape[1] * table.element_size(), stream.cuda_stream))
    wrapper_ms = cuda_ms(torch, lambda: table_gather(table, idx))
    plain_ms = cuda_ms(torch, lambda: table_gather_plain(table, idx))
    library_ms = cuda_ms(torch, lambda: table.index_select(0, idx))
    b_ms, b_by = bound_ms(nbytes(table, idx, out), 0.0)
    row = dict(name="table_gather", route="cuda",
               source="dragonfly2_tpu_torch/ops/csrc/table_gather.cu",
               replaces="dragonfly2_tpu/ops/table_gather.py:66",
               max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=b_ms,
               bound_by=b_by, library_ms=library_ms, wrapper_ms=wrapper_ms)
    log("kernel", **row,
        shape={"table": list(table.shape), "idx": list(idx.shape)})
    return row


def check_table_gather_widths(torch) -> None:
    """K2a bit-equal to ``table_gather_plain`` at every row width from 16
    to 512 bytes (1 to 32 16-byte words, powers of two and not, f32 and
    bf16), for m = 1 and an m that no block's row count divides."""
    from dragonfly2_tpu_torch.ops.table_gather import (
        table_gather,
        table_gather_plain,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 7)
    cases = []
    for row_bytes in (16, 32, 48, 64, 128, 256, 512):
        for dtype in (torch.float32, torch.bfloat16):
            table = torch.randn(1000, row_bytes // (4 if dtype ==
                                                    torch.float32 else 2),
                                generator=gen, device="cuda").to(dtype)
            for m in (1, 12_345):
                idx = torch.randint(0, 1000, (m,), generator=gen,
                                    device="cuda", dtype=torch.int32)
                out = table_gather(table, idx)
                if not torch.equal(out, table_gather_plain(table, idx)):
                    raise AssertionError(f"table_gather differs from "
                                         f"table[idx] at {row_bytes}-byte "
                                         f"{dtype} rows, m = {m}")
                cases.append(f"{row_bytes}B/{str(dtype)[6:]}/m{m}")
    log("table_gather_widths", bit_equal=cases)


def gather_library_profile(torch, table, idx) -> dict:
    """What PyTorch's gathers spend at this shape: ``index_select`` and
    advanced indexing (the plain twin) with the int32 index and an int64
    copy, ``index_select`` on uniform random int32 indices of the same
    count, and K2a's wrapper beside them → {case: {"ms": CUDA-event ms a call, "wall_ms": host wall
    ms a call under the profiler, "kernels": [(kernel, launches the
    profiler recorded a call, device ms a recorded launch)],
    "launch_shapes": {kernel: [grid, block]}}}. The
    profiler may record fewer launches than were made, so a kernel's
    time is given a recorded launch."""
    from dragonfly2_tpu_torch.ops.table_gather import table_gather

    idx64 = idx.long()
    uniform = torch.randint(0, table.shape[0], tuple(idx.shape),
                            generator=torch.Generator().manual_seed(SEED),
                            dtype=torch.int32).to(idx.device)
    cases = {"index_select_int32": lambda: table.index_select(0, idx),
             "index_select_int64": lambda: table.index_select(0, idx64),
             "indexing_int32": lambda: table[idx],
             "indexing_int64": lambda: table[idx64],
             "index_select_uniform_int32":
                 lambda: table.index_select(0, uniform),
             "table_gather": lambda: table_gather(table, idx)}
    out = {}
    for name, fn in cases.items():
        ms = cuda_ms(torch, fn)
        averages, wall_ms, prof = profile_averages(torch, fn, 5)
        kernels = device_kernels(averages, 5)
        out[name] = dict(ms=ms, wall_ms=wall_ms,
                         kernels=[(k[0][:160], k[2], k[1] / k[2])
                                  for k in kernels[:4]],
                         launch_shapes=launch_shapes(prof))
    return out


def scatter_err(torch, out, ref) -> tuple[float, float]:
    """(max |out − ref|, its tolerance) for a scatter-add result against
    the plain version's (on the CPU)."""
    err = float((out.cpu().float() - ref.float()).abs().max())
    return err, SCATTER_ULP * max(float(ref.float().abs().max()), 1.0)


def check_table_scatter_add(torch, ct, idx, inv, n_rows) -> dict:
    """The scatter-add kernel at the trainer's shapes: on the inverse
    index and on the transpose the wrapper derives from idx, against the
    plain version on a CPU copy, twice for bit-identity, timed beside the
    plain version on the card and ``index_add_`` into f32 zeros."""
    from dragonfly2_tpu_torch.ops import table_gather as _tg
    from dragonfly2_tpu_torch.ops.table_gather import (
        inverse_index_csr,
        table_scatter_add,
        table_scatter_add_plain,
    )

    cpu = [t.cpu() for t in (ct, idx, inv)]
    errs = {}
    for name, use_inv in (("inv", inv), ("derived", None)):
        out = table_scatter_add(ct, idx, n_rows, use_inv)
        again = table_scatter_add(ct, idx, n_rows, use_inv)
        torch.cuda.synchronize()
        if not torch.equal(out, again):
            raise AssertionError(f"table_scatter_add ({name}) differs "
                                 "between two launches")
        ref = table_scatter_add_plain(cpu[0], cpu[1], n_rows,
                                      None if use_inv is None else cpu[2])
        errs[name], tol = scatter_err(torch, out, ref)
        if not errs[name] <= tol:
            raise AssertionError(f"table_scatter_add ({name}): max abs err "
                                 f"{errs[name]} > {tol}")
        errs[f"{name}_bit_equal"] = torch.equal(out.cpu(), ref)
    del cpu

    d = ct.shape[1]
    row_bytes = d * ct.element_size()
    lib, stream = _tg._lib("table_scatter_add"), torch.cuda.current_stream()
    out = torch.empty((n_rows, d), dtype=ct.dtype, device=ct.device)
    ms = cuda_ms(torch, lambda: lib.df2_table_scatter_add(
        1, ct.data_ptr(), inv.data_ptr(), None, inv.shape[1], out.data_ptr(),
        n_rows, row_bytes, stream.cuda_stream))
    wrapper_ms = cuda_ms(torch, lambda: table_scatter_add(ct, idx, n_rows,
                                                          inv))
    derive_ms = cuda_ms(torch, lambda: inverse_index_csr(idx, n_rows))
    derived_ms = cuda_ms(torch, lambda: table_scatter_add(ct, idx, n_rows))
    plain_ms = cuda_ms(torch, lambda: table_scatter_add_plain(
        ct, idx, n_rows, inv), iters=5, warmup=1)
    # Library yardstick: one index_add_ (atomics, run-to-run order) into
    # f32 zeros; the f32 copy of ct and the int64 indices are made before
    # the clock starts. Timed only; the port never calls it.
    acc = torch.zeros((n_rows, d), dtype=torch.float32, device=ct.device)
    ct32, idx64 = ct.float(), idx.long()
    library_ms = cuda_ms(torch, lambda: acc.zero_().index_add_(0, idx64, ct32))
    del ct32, idx64, acc

    n_valid = int((inv >= 0).sum())
    b_ms, b_by = bound_ms(n_valid * row_bytes + nbytes(inv, out),
                          n_valid * d, PEAK_F32_FLOPS)
    row = dict(name="table_scatter_add", route="cuda",
               source="dragonfly2_tpu_torch/ops/csrc/table_scatter_add.cu",
               replaces="dragonfly2_tpu/ops/table_gather.py:105",
               max_abs_err=max(errs["inv"], errs["derived"]), ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=library_ms)
    log("kernel", **row, errors=errs, wrapper_ms=wrapper_ms,
        derive_ms=derive_ms, derived_wrapper_ms=derived_ms,
        valid_rows=n_valid, shape={"ct": list(ct.shape),
                                   "inv": list(inv.shape)})
    return row


def check_scatter_cases(torch) -> None:
    """The scatter-add kernel on random neighbor lists with many duplicate
    targets, padding and rows that receive nothing, on both transposes,
    in bf16 and f32 and at row widths of one, a half and three vectors a
    lane, against the plain version on the CPU."""
    from dragonfly2_tpu_torch.models.graph_transformer import (
        PAD_ID,
        build_inverse_index,
    )
    from dragonfly2_tpu_torch.ops.table_gather import (
        table_scatter_add,
        table_scatter_add_plain,
    )

    rng = np.random.default_rng(SEED)
    n, kw = 1000, 48
    nbr = rng.integers(0, 300, (n, kw)).astype(np.int32)  # rows ≥ 300 get 0
    nbr[rng.random((n, kw)) < 0.4] = PAD_ID
    nbr[11] = PAD_ID                                       # lists nobody
    inv = torch.from_numpy(build_inverse_index(nbr))
    idx = torch.from_numpy(np.where(nbr >= n, 0, nbr).reshape(-1))
    errs = {}
    for dtype, width in ((torch.bfloat16, 256), (torch.float32, 64),
                         (torch.float32, 384)):
        ct = torch.from_numpy(rng.standard_normal(
            (n * kw, width)).astype(np.float32)).to(dtype)
        for name, use_inv in (("inv", inv), ("derived", None)):
            ref = table_scatter_add_plain(ct, idx, n, use_inv)
            out = table_scatter_add(
                ct.cuda(), idx.cuda(),
                n, None if use_inv is None else use_inv.cuda())
            key = f"{str(dtype)[6:]}x{width}_{name}"
            errs[key], tol = scatter_err(torch, out, ref)
            if not errs[key] <= tol or out[300:].abs().max() != 0:
                raise AssertionError(f"table_scatter_add {key}: max abs err "
                                     f"{errs[key]} or a nonzero empty row")
    log("scatter_cases", max_abs_err=errs, tol_ulp=SCATTER_ULP)


def check_graph_flash(torch, q, k, v, nbr, val, block) -> dict:
    """K1's forward at the serving path's shapes against its plain twin
    (bf16 and f32; lse too), timed with lse off (serving) and on
    (training) in turns, beside the plain twin and SDPA over the dense
    mask."""
    from dragonfly2_tpu_torch.ops.flash_attention import (
        graph_flash_attention,
        graph_flash_attention_plain,
        graph_flash_forward,
    )

    errs = {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        qd, kd, vd = (t.to(dtype) for t in (q, k, v))
        out = graph_flash_attention(qd, kd, vd, nbr, val)
        ref = graph_flash_attention_plain(qd, kd, vd, nbr, val, block)
        torch.cuda.synchronize()
        if not torch.isfinite(out).all():
            raise AssertionError(f"graph_flash_attention {name}: non-finite")
        errs[name] = float((out.float() - ref.float()).abs().max())
        if errs[name] > FLASH_TOL[name]:
            raise AssertionError(f"graph_flash_attention {name}: max abs err "
                                 f"{errs[name]} > {FLASH_TOL[name]}")
    out = graph_flash_attention(q, k, v, nbr, val)
    # Serving's forward (no lse) and training's (lse on), in turns.
    ms_by_lse = {"off": [], "on": []}
    for _ in range(2):
        for key, with_lse in (("off", False), ("on", True)):
            ms_by_lse[key].append(cuda_ms(torch, lambda w=with_lse: (
                graph_flash_forward(q, k, v, nbr, val, w))))
    ms, ms_lse = (min(ms_by_lse[key]) for key in ("off", "on"))
    # lse in f32, where the plain twin's scores are not rounded to bf16.
    f32 = [t.float() for t in (q, k, v)]
    _, lse = graph_flash_forward(*f32, nbr, val, True)
    _, ref_lse = graph_flash_attention_plain(*f32, nbr, val, block,
                                             return_lse=True)
    del f32
    lse_err = float((lse - ref_lse).abs().max())
    if not lse_err <= FLASH_TOL["lse"]:
        raise AssertionError(f"graph_flash_attention lse: max abs err "
                             f"{lse_err} > {FLASH_TOL['lse']}")
    plain_ms = cuda_ms(torch, lambda: graph_flash_attention_plain(
        q, k, v, nbr, val, block), iters=5, warmup=1)

    # Library yardstick: SDPA over a materialized [N, N] bias mask (−inf
    # off the neighbor lists). Timed only; the port never calls it.
    n, heads, d = q.shape
    valid = (nbr >= 0) & (nbr < k.shape[0])
    rows = torch.arange(n, device=q.device)[:, None].expand_as(nbr)
    mask = torch.full((n, k.shape[0]), float("-inf"), dtype=q.dtype,
                      device=q.device)
    mask[rows[valid], nbr[valid].long()] = val[valid].to(q.dtype)
    qh, kh, vh = (t.permute(1, 0, 2)[None] for t in (q, k, v))
    sdpa = torch.nn.functional.scaled_dot_product_attention
    library_ms = cuda_ms(torch, lambda: sdpa(qh, kh, vh, attn_mask=mask),
                         iters=5, warmup=1)
    sdpa_err = float((sdpa(qh, kh, vh, attn_mask=mask)[0].permute(1, 0, 2)
                      .float() - out.float()).abs().max())
    del mask

    n_valid = int(valid.sum())
    flops = n_valid * heads * 4 * d          # q·k and p·v per valid slot
    # f32 FMAs and one exp a (valid slot, head).
    b_ms, b_by = bound_ms(nbytes(q, k, v, nbr, val, out), flops,
                          PEAK_F32_FLOPS, n_valid * heads)
    row = dict(name="graph_flash_attention", route="cuda",
               source="dragonfly2_tpu_torch/ops/csrc/graph_flash_attention.cu",
               replaces="dragonfly2_tpu/ops/flash_attention.py:249",
               max_abs_err=errs["bf16"], ms=ms, plain_ms=plain_ms,
               bound_ms=b_ms, bound_by=b_by, library_ms=library_ms)
    log("kernel", **row, max_abs_err_f32=errs["f32"], lse_max_abs_err=lse_err,
        ms_with_lse=ms_lse, ms_by_lse=ms_by_lse,
        lse_cost=ms_lse / ms - 1.0, sdpa_max_abs_diff=sdpa_err,
        valid_slots=n_valid,
        shape={"q": list(q.shape), "nbr": list(nbr.shape)})
    return row


def check_flash_shapes(torch) -> None:
    """K1 forward and backward on every row layout they take (heads ×
    head_dim spread 1, 2, 4, 8 or 16 elements a lane), ragged neighbor
    counts, a row whose slots are all padding, an id out of range and K
    past one warp up to 512, in f32: the kernels through
    ``graph_flash_attention`` under autograd, with the inverse index,
    against the plain twins run on the card (with TF32 off; a host's
    BLAS may round f32 products more coarsely — one card machine's put
    the plain forward 5e-5 off)."""
    from dragonfly2_tpu_torch.models.graph_transformer import (
        PAD_ID,
        build_inverse_index,
    )
    from dragonfly2_tpu_torch.ops.flash_attention import (
        graph_flash_attention,
        graph_flash_attention_backward_plain,
        graph_flash_attention_plain,
    )

    gen = torch.Generator().manual_seed(SEED)
    errs, grad_errs = {}, {}
    for heads, d, kw in ((4, 8, 40), (2, 16, 40), (4, 16, 40), (4, 32, 40),
                         (8, 16, 40), (32, 4, 40), (8, 32, 40), (1, 64, 40),
                         (8, 64, 40), (16, 32, 40), (4, 32, 300),
                         (2, 16, 512)):
        n = max(300, kw + 88)
        q, k, v, dout = (torch.randn(n, heads, d, generator=gen)
                         for _ in range(4))
        # Distinct neighbors per row (the dedup invariant), self slot
        # first, a ragged tail of PAD_ID, row 7 all padding, and one id
        # past the rows in row 9.
        order = torch.rand(n, n, generator=gen)
        order.fill_diagonal_(-1.0)
        nbr = torch.argsort(order, dim=1)[:, :kw].to(torch.int32)
        deg = torch.randint(1, kw + 1, (n, 1), generator=gen)
        nbr[torch.arange(kw)[None, :] >= deg] = int(PAD_ID)
        nbr[7] = int(PAD_ID)
        nbr[9, -1] = n + 5
        val = -torch.rand(n, kw, generator=gen)
        inv = torch.from_numpy(build_inverse_index(nbr.numpy()))
        q, k, v, dout, nbr, val, inv = (t.cuda() for t in (q, k, v, dout, nbr,
                                                           val, inv))
        leaves = [t.clone().requires_grad_() for t in (q, k, v, val)]
        out = graph_flash_attention(*leaves[:3], nbr, leaves[3], inv=inv)
        got = [out.detach(), *torch.autograd.grad(out, leaves, dout)]
        ref, lse = graph_flash_attention_plain(q, k, v, nbr, val, 128,
                                               return_lse=True)
        ref = [ref, *graph_flash_attention_backward_plain(
            q, k, v, nbr, val, lse, dout, inv)]
        key = f"{heads}x{d}/K{kw}"
        errs[key] = float((got[0] - ref[0]).abs().max())
        grad_errs[key] = k1_errors(torch, got[1:], ref[1:])
        if (not errs[key] <= FLASH_TOL["f32"] or got[0][7].abs().max() != 0
                or not k1_within(grad_errs[key], K1_TOL["f32"])):
            raise AssertionError(f"graph_flash_attention {key}: max abs err "
                                 f"{errs[key]}, grads {grad_errs[key]} or a "
                                 f"nonzero padded row")
    log("flash_shapes", max_abs_err=errs, tol=FLASH_TOL["f32"],
        grad_row_errors={key: {n: e[n] for n in K1_GRADS}
                         for key, e in grad_errs.items()},
        grad_tol=K1_TOL["f32"])


def k1_errors(torch, got, ref) -> dict:
    """Row errors (see ROW_TILE) of K1's (dq, dk, dv, dval) against the
    reference's: dq, dk and dv per (row, head), floored at the rms row
    norm of the three together; dval per query row over its K slots; and
    max |got − ref| of each under "abs"."""
    unit = rms_row_norm(*ref[:3])
    errs = {n: row_err(torch, a, b, unit)
            for n, a, b in zip(K1_GRADS[:3], got[:3], ref[:3])}
    dval, ref_dval = got[3][:, None, :], ref[3][:, None, :]
    errs["dval"] = row_err(torch, dval, ref_dval, rms_row_norm(ref_dval))
    errs["abs"] = {n: float((a.float() - b.float()).abs().max())
                   for n, a, b in zip(K1_GRADS, got, ref)}
    return errs


def k1_within(errs, tol: float) -> bool:
    return max(errs[n] for n in K1_GRADS) <= tol


def k1_backward_case(torch, q, k, v, dout, nbr, val, inv):
    """(row errors, bit-identical, finite, (dq, dk, dv, dval)) of the K1
    backward at q's dtype for the kernel forward's lse, against its plain
    twin run in f32 on the same values (``k1_errors``), over two
    launches."""
    from dragonfly2_tpu_torch.ops.flash_attention import (
        graph_flash_attention_backward_plain,
        graph_flash_backward,
        graph_flash_forward,
    )

    _, lse = graph_flash_forward(q, k, v, nbr, val, True)
    got = graph_flash_backward(q, k, v, nbr, val, lse, dout, inv)
    again = graph_flash_backward(q, k, v, nbr, val, lse, dout, inv)
    torch.cuda.synchronize()
    same = all(torch.equal(a, b) for a, b in zip(got, again))
    finite = all(bool(torch.isfinite(g).all()) for g in got)
    ref = graph_flash_attention_backward_plain(
        *(t.float() for t in (q, k, v)), nbr, val, lse, dout.float(), inv)
    return k1_errors(torch, got, ref), same, finite, got


def one_slot_case(torch, nbr, n_k: int):
    """nbr with every fifth row cut to its first slot (build_neighbor_lists
    puts a row's valid slots first), its inverse index on the card, and
    the rows left with exactly one valid slot."""
    from dragonfly2_tpu_torch.models.graph_transformer import PAD_ID
    from dragonfly2_tpu_torch.ops.table_gather import build_inverse_index

    cut = nbr.clone()
    cut[::5, 1:] = int(PAD_ID)
    valid = ((cut >= 0) & (cut < n_k)).sum(1)
    rows = torch.nonzero(valid == 1)[:, 0]
    inv = torch.from_numpy(build_inverse_index(cut.cpu().numpy(), n_k))
    return cut, inv.to(nbr.device), rows


def check_k1_backward(torch, q, k, v, nbr, val, inv) -> dict:
    """The K1 backward at the training path's shapes (the trainer's nbr,
    val and inverse index; seeded random q, k, v, dO), bf16 and f32,
    against its plain twin run in f32 on the same values and on the
    kernel forward's lse, row by row (``k1_errors``), bit-identical
    across two launches; then the same graph with every fifth row cut to
    one valid slot, whose dval must be exactly 0 (its true gradient:
    dp − r is 0 at a row's only slot); timed as a whole and pass by pass
    (with each pass's gathered-byte rate) beside the plain twin and
    SDPA's backward over the dense [N, N] additive mask. Returns the
    kernels line's row."""
    from dragonfly2_tpu_torch.ops.flash_attention import (
        GBWD_DQ,
        GBWD_KV,
        graph_backward_scratch,
        graph_flash_attention_backward_plain,
        graph_flash_backward,
        graph_flash_forward,
        launch_graph_backward,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED + 5)
    dout = torch.randn(q.shape, generator=gen, device="cuda")
    cut, cut_inv, one_slot = one_slot_case(torch, nbr, k.shape[0])
    errs, one_slot_errs = {}, {}
    for name, dtype in (("bf16", torch.bfloat16), ("f32", torch.float32)):
        inputs = [t.to(dtype) for t in (q, k, v, dout)]
        for graph, out in (((nbr, val, inv), errs),
                           ((cut, val, cut_inv), one_slot_errs)):
            out[name], same, finite, got = k1_backward_case(
                torch, *inputs, *graph)
            if not (same and finite):
                raise AssertionError(
                    f"K1 backward {name}: two launches differ ({not same}) "
                    f"or non-finite ({not finite})")
            if not k1_within(out[name], K1_TOL[name]):
                raise AssertionError(f"K1 backward {name}: errors "
                                     f"{out[name]} over {K1_TOL[name]}")
        if len(one_slot) == 0 or bool(got[3][one_slot].any()):
            raise AssertionError(f"K1 backward {name}: dval of the "
                                 f"{len(one_slot)} one-slot rows is not 0")
    del cut, cut_inv
    # Times in bf16, the training dtype.
    _, lse = graph_flash_forward(q, k, v, nbr, val, True)
    dout = dout.to(q.dtype)
    grads = graph_flash_backward(q, k, v, nbr, val, lse, dout, inv)
    scratch = graph_backward_scratch(q)
    scratch_bytes = nbytes(*scratch.values())
    ms = cuda_ms(torch, lambda: launch_graph_backward(
        q, k, v, nbr, val, lse, dout, inv, *grads, scratch))
    parts_ms = {part: cuda_ms(torch, lambda p=bits: launch_graph_backward(
        q, k, v, nbr, val, lse, dout, inv, *grads, scratch, p))
        for part, bits in (("dq_dval", GBWD_DQ), ("dk_dv", GBWD_KV))}
    wrapper_ms = cuda_ms(torch, lambda: graph_flash_backward(
        q, k, v, nbr, val, lse, dout, inv))
    plain_ms = cuda_ms(torch, lambda: graph_flash_attention_backward_plain(
        q, k, v, nbr, val, lse, dout, inv), iters=3, warmup=1)
    del scratch

    # Library yardstick: SDPA's backward on a kept graph, over the
    # materialized [N, N] additive mask (−inf off the neighbor lists), in
    # its [1, h, N, d] layout, transposed before the clock. Timed only;
    # the port never calls it.
    n, heads, d = q.shape
    valid = (nbr >= 0) & (nbr < k.shape[0])
    rows = torch.arange(n, device=q.device)[:, None].expand_as(nbr)
    mask = torch.full((n, k.shape[0]), float("-inf"), dtype=q.dtype,
                      device=q.device)
    mask[rows[valid], nbr[valid].long()] = val[valid].to(q.dtype)
    leaves = [t.permute(1, 0, 2)[None].contiguous().requires_grad_()
              for t in (q, k, v)]
    doh = dout.permute(1, 0, 2)[None].contiguous()
    sdpa = torch.nn.functional.scaled_dot_product_attention
    s_out = sdpa(*leaves, attn_mask=mask)
    library_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        s_out, leaves, doh, retain_graph=True), iters=5, warmup=1)
    del s_out, leaves, doh, mask

    n_valid = int(valid.sum())
    # The gathers: a k and a v row a valid slot (dQ pass), a q and a dO
    # row a position of the inverse index, one a valid slot (dK/dV pass).
    gathered = 2 * n_valid * heads * d * q.element_size()
    # Bytes: each input and output once. Operations: f32 FMAs — s, dp and
    # dq (dQ pass), dk and dv (dK/dV pass), 2·d flops each a (valid slot,
    # head) — and one exp each.
    b_ms, b_by = bound_ms(
        nbytes(q, k, v, dout, lse, nbr, val, inv, *grads),
        n_valid * heads * 10 * d, PEAK_F32_FLOPS, n_valid * heads)
    row = dict(name="graph_flash_attention_backward", route="cuda",
               source="dragonfly2_tpu_torch/ops/csrc/graph_flash_attention.cu",
               replaces="dragonfly2_tpu/ops/flash_attention.py:383",
               max_abs_err=max(errs["bf16"]["abs"].values()), ms=ms,
               plain_ms=plain_ms, bound_ms=b_ms, bound_by=b_by,
               library_ms=library_ms)
    log("k1_backward", **row, row_errors={
        name: {n: e[n] for n in K1_GRADS} for name, e in errs.items()},
        abs_errors={name: e["abs"] for name, e in errs.items()}, tol=K1_TOL,
        bit_identical=True, parts_ms=parts_ms, wrapper_ms=wrapper_ms,
        gathered_bytes_per_s={part: gathered / (t * 1e-3)
                              for part, t in parts_ms.items()},
        scratch_bytes=scratch_bytes, one_slot_rows=len(one_slot),
        one_slot_row_errors={name: {n: e[n] for n in K1_GRADS}
                             for name, e in one_slot_errs.items()},
        library_is="SDPA backward, dense [N, N] additive mask",
        valid_slots=n_valid, shape={"q": list(q.shape),
                                    "nbr": list(nbr.shape),
                                    "inv": list(inv.shape)})
    return row


def k3_grads(torch, fn, q, k, v, causal, dout):
    """(out, dq, dk, dv) of ``fn(q, k, v, causal)`` with cotangent dout."""
    leaves = [t.detach().requires_grad_() for t in (q, k, v)]
    out = fn(*leaves, causal)
    grads = torch.autograd.grad(out, leaves, dout)
    return (out.detach(), *grads)


def k3_reference(torch, plain, q, k, v, causal, dout, got_out):
    """(out, dq, dk, dv) of ``plain`` run in f32 on q, k, v's values with
    cotangent dout, the gradients taken as K3's backward (FlashAttention-
    2's) defines them: with delta = rowsum(dO ∘ O) from the kernel's
    rounded out ``got_out``, not from the reference's own. With
    Δ = rowsum(dO ∘ (got_out − out)) that moves dq by −scale·Δ·(P k) and
    dk by −scale·Pᵀ(Δ·q); dv does not see delta."""
    q, k, v, dout = (x.float() for x in (q, k, v, dout))
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    out = plain(*leaves, causal)
    dq, dk, dv = torch.autograd.grad(out, leaves, dout, retain_graph=True)
    gap = (dout * (got_out.float() - out.detach())).sum(-1, keepdim=True)
    # Pᵀ(Δ·q) is v's gradient for the cotangent Δ·q; P k attends to k.
    ptq, = torch.autograd.grad(out, leaves[2], gap * q)
    with torch.no_grad():
        pk = plain(q, k, k, causal)
    scale = q.shape[-1] ** -0.5
    return out.detach(), dq - scale * gap * pk, dk - scale * ptq, dv


def rms_row_norm(*tensors) -> float:
    """The rms over all rows of all tensors of a row's 2-norm over the
    last axis."""
    square = sum(float(x.float().square().sum()) for x in tensors)
    return (square / sum(x[..., 0].numel() for x in tensors)) ** 0.5


def row_err(torch, got, ref, unit: float) -> float:
    """The worst row's |got − ref| over its floored |ref| (see
    ROW_TILE), norms over head_dim, for [T, h, d] tensors."""
    ref = ref.float()
    err = (got.float() - ref).norm(dim=-1)
    norm = ref.norm(dim=-1)                                     # [T, h]
    t, heads = norm.shape
    pad = norm.new_zeros(-t % ROW_TILE, heads)
    square = torch.cat([norm.square(), pad]).view(-1, ROW_TILE, heads)
    rows = torch.cat([torch.ones_like(norm), pad]).view(-1, ROW_TILE, heads)
    local = (square.sum(1) / rows.sum(1)).sqrt()
    local = local.repeat_interleave(ROW_TILE, 0)[:t]
    floor = torch.maximum(norm, LOCAL_FLOOR * local).clamp_min(ROW_FLOOR * unit)
    return float((err / floor).max())


def k3_errors(torch, got, ref) -> dict:
    """Row errors (see ROW_TILE) of K3's (out, dq, dk, dv) against the
    plain version's, and max |got − ref| of each under "abs"."""
    units = (rms_row_norm(ref[0]),) + (rms_row_norm(*ref[1:]),) * 3
    names = ("out", "dq", "dk", "dv")
    errs = {n: row_err(torch, a, b, u)
            for n, a, b, u in zip(names, got, ref, units)}
    errs["abs"] = {n: float((a.float() - b.float()).abs().max())
                   for n, a, b in zip(names, got, ref)}
    return errs


def k3_within(errs, tol) -> bool:
    return (errs["out"] <= tol["out"]
            and max(errs["dq"], errs["dk"], errs["dv"]) <= tol["grad"])


def check_k3(torch, t, heads, d, dtype) -> dict:
    """K3 forward and backward at [t, heads, d], causal (the long-context
    tier's mode), against the plain version (``chunked_attention`` with
    the JAX backward's 512-column blocks) run in f32 on the same values,
    row by row (``k3_errors``), bit-identical across two launches; timed
    beside the plain version and SDPA, the backward also launch by launch
    (delta, dK/dV, dQ; on the "mma" route dK/dV is the fused block that
    also gives dQ). Returns the forward and backward rows of the kernels
    line."""
    from dragonfly2_tpu_torch.ops.flash_attention import (
        BWD_DELTA,
        BWD_KV,
        BWD_Q,
        backward_scratch,
        chunked_attention,
        flash_attention,
        flash_backward,
        flash_forward,
        launch_backward,
    )

    causal = True
    gen = torch.Generator(device="cuda").manual_seed(SEED)
    q, k, v, dout = (torch.randn(t, heads, d, generator=gen, device="cuda")
                     .to(dtype) for _ in range(4))
    name = "bf16" if dtype == torch.bfloat16 else "f32"
    tol = K3_TOL[name]

    def plain(*a):
        return chunked_attention(*a, block=512)

    got = k3_grads(torch, flash_attention, q, k, v, causal, dout)
    ref = k3_reference(torch, plain, q, k, v, causal, dout, got[0])
    errs = k3_errors(torch, got, ref)
    del ref
    if not all(torch.isfinite(x).all() for x in got):
        raise AssertionError(f"K3 {name} {t}x{heads}x{d}: non-finite")
    if not k3_within(errs, tol):
        raise AssertionError(f"K3 {name} {t}x{heads}x{d}: errors {errs} "
                             f"over {tol}")
    out, lse = flash_forward(q, k, v, causal)
    again = flash_forward(q, k, v, causal)
    grads = flash_backward(q, k, v, out, dout, lse, causal)
    grads_again = flash_backward(q, k, v, out, dout, lse, causal)
    torch.cuda.synchronize()
    if not (torch.equal(out, again[0]) and torch.equal(lse, again[1])
            and all(torch.equal(a, b) for a, b in zip(grads, grads_again))):
        raise AssertionError(f"K3 {name} {t}x{heads}x{d}: two launches "
                             "differ")
    del again, grads_again

    ms = cuda_ms(torch, lambda: flash_forward(q, k, v, causal),
                 iters=10, warmup=2)
    bwd_ms = cuda_ms(torch, lambda: flash_backward(
        q, k, v, out, dout, lse, causal), iters=5, warmup=1)
    # The backward launch by launch, into scratch the full backward filled.
    scratch = backward_scratch(q)
    outs = [torch.empty_like(q) for _ in range(3)]
    route = launch_backward(q, k, v, out, dout, lse, causal, *outs, scratch)
    parts_ms = {part: cuda_ms(torch, lambda p=bits: launch_backward(
        q, k, v, out, dout, lse, causal, *outs, scratch, p), iters=5,
        warmup=1) for part, bits in (("delta", BWD_DELTA),
                                     ("dkdv", BWD_KV), ("dq", BWD_Q))}
    if route == "mma":
        parts_ms["fused_dkdv_dq"] = parts_ms.pop("dkdv")
        del parts_ms["dq"]                      # launches nothing there
    del scratch, outs
    with torch.no_grad():
        plain_ms = cuda_ms(torch, lambda: plain(q, k, v, causal),
                           iters=2, warmup=1)
    leaves = [x.detach().requires_grad_() for x in (q, k, v)]
    p_out = plain(*leaves, causal)
    plain_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        p_out, leaves, dout, retain_graph=True), iters=2, warmup=1)
    del p_out
    # Library yardstick: SDPA in its [1, h, T, d] layout, transposed
    # before the clock; forward alone, and its backward alone on a kept
    # graph. Timed only; the port never calls it.
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qh, kh, vh, doh = (x.permute(1, 0, 2)[None].contiguous()
                       for x in (q, k, v, dout))
    with torch.no_grad():
        lib_ms = cuda_ms(torch, lambda: sdpa(qh, kh, vh, is_causal=causal),
                         iters=10, warmup=2)
        sdpa_err = float((sdpa(qh, kh, vh, is_causal=causal)[0]
                          .permute(1, 0, 2).float() - out.float()).abs().max())
    leaves = [x.requires_grad_() for x in (qh, kh, vh)]
    s_out = sdpa(*leaves, is_causal=causal)
    lib_bwd_ms = cuda_ms(torch, lambda: torch.autograd.grad(
        s_out, leaves, doh, retain_graph=True), iters=5, warmup=1)
    del s_out, leaves, qh, kh, vh, doh

    # Work this run's inputs need: every visible (query, key) pair once.
    pairs = heads * t * (t + 1) // 2
    peak = PEAK_BF16_FLOPS if dtype == torch.bfloat16 else PEAK_F32_FLOPS
    fwd_b = bound_ms(nbytes(q, k, v, out, lse), 4 * d * pairs, peak, pairs)
    # Backward: S and dP recomputed, dV, dK and dQ — five products; one
    # exp a pair.
    bwd_b = bound_ms(nbytes(q, k, v, out, dout, lse, *grads),
                     10 * d * pairs, peak, pairs)
    src = ("dragonfly2_tpu_torch/ops/csrc/flash_attention_sm90.cu"
           if route == "sm90" else
           "dragonfly2_tpu_torch/ops/csrc/flash_attention.cu")
    shape = {"t": t, "heads": heads, "head_dim": d, "dtype": name,
             "causal": causal}
    fwd = dict(name="flash_attention", route="cuda", source=src,
               replaces="dragonfly2_tpu/ops/flash_attention.py:113",
               max_abs_err=errs["abs"]["out"], ms=ms, plain_ms=plain_ms,
               bound_ms=fwd_b[0], bound_by=fwd_b[1], library_ms=lib_ms)
    bwd = dict(name="flash_attention_backward", route="cuda", source=src,
               replaces="dragonfly2_tpu/ops/flash_attention.py:228",
               max_abs_err=max(errs["abs"][g] for g in ("dq", "dk", "dv")),
               ms=bwd_ms, plain_ms=plain_bwd_ms, bound_ms=bwd_b[0],
               bound_by=bwd_b[1], library_ms=lib_bwd_ms)
    exp_ms = {"sfu_and_fp32_poly": pairs / PEAK_EXP_PER_S * 1e3,
              "sfu_only": pairs / SFU_EXP_PER_S * 1e3}
    if route == "mma":
        fwd["exp_split"] = k3_exp_split(torch, d)
    log("kernel", **fwd, k3_route=route, shape=shape, errors=errs, tol=tol,
        exp_ms=exp_ms, product_ms=4 * d * pairs / peak * 1e3,
        sdpa_max_abs_diff=sdpa_err, bit_identical=True,
        backward_parts_ms=parts_ms)
    log("kernel", **bwd, k3_route=route, shape=shape, exp_ms=exp_ms,
        product_ms=10 * d * pairs / peak * 1e3,
        library_is="SDPA backward on a kept graph", bit_identical=True,
        backward_parts_ms=parts_ms)
    return {"fwd": fwd, "bwd": bwd, "route": route, "parts_ms": parts_ms,
            "shape": shape}


def k3_exp_split(torch, d: int) -> dict:
    """The bf16 forward kernel's tiling and exponential split as its
    library reports them, which must be the plain twin's at every
    head_dim; at head_dim d the polynomial's share of the pairs, its
    stated relative-error limit, and the largest relative error of the
    plain ``exp2_poly`` (the kernel's arithmetic) against exp2 in f64
    over [-126, 0] on the card."""
    from dragonfly2_tpu_torch.ops.flash_attention import (
        EXP2_POLY_REL_ERR,
        FORWARD_TILING,
        exp2_poly,
        kernel_exp_split,
    )

    for dim, tiling in FORWARD_TILING.items():
        if kernel_exp_split(dim) != tiling:
            raise AssertionError(f"head_dim {dim}: the kernel tiles "
                                 f"{kernel_exp_split(dim)}, the plain twin "
                                 f"{tiling}")
    tile, poly = FORWARD_TILING[d]
    x = torch.linspace(-126, 0, 1_000_001, dtype=torch.float64,
                       device="cuda")
    err = float((exp2_poly(x.float()).double() / torch.exp2(x) - 1)
                .abs().max())
    if not err <= EXP2_POLY_REL_ERR:
        raise AssertionError(f"exp2_poly relative error {err} over "
                             f"{EXP2_POLY_REL_ERR}")
    return {"poly_share": 8 * poly / tile, "poly_blocks": poly,
            "key_tile": tile, "poly_rel_err_limit": EXP2_POLY_REL_ERR,
            "poly_max_rel_err": err}


def check_k3_shapes(torch) -> None:
    """K3 forward and gradients on every head_dim the kernels take, and
    at head_dims 24 and 96 (which the wrapper zero-pads to 32 and 128),
    ragged and tiny T, causal and not, with fewer heads than a tile's
    rows, in f32 (the FMA kernels) and bf16 (the tensor-core kernels),
    against the plain version run in f32 on the same values on the
    card."""
    from dragonfly2_tpu_torch.ops.flash_attention import (
        HEAD_DIMS,
        chunked_attention,
        flash_attention,
    )

    gen = torch.Generator(device="cuda").manual_seed(SEED)
    heads = 3
    for name, dtype in (("f32", torch.float32), ("bf16", torch.bfloat16)):
        errs, tol = {}, K3_TOL[name]
        for d in HEAD_DIMS + PADDED_HEAD_DIMS:
            for t in (1, 100, 1000, 4096):
                q, k, v, dout = (torch.randn(t, heads, d, generator=gen,
                                             device="cuda").to(dtype)
                                 for _ in range(4))
                for causal in (False, True):
                    got = k3_grads(torch, flash_attention, q, k, v, causal,
                                   dout)
                    again = k3_grads(torch, flash_attention, q, k, v,
                                     causal, dout)
                    if not all(torch.equal(a, b) for a, b in zip(got, again)):
                        raise AssertionError(
                            f"K3 {name} head_dim {d}, T {t}, causal "
                            f"{causal}: two launches differ")
                    del again
                    ref = k3_reference(torch, lambda *a: chunked_attention(
                        *a, block=512), q, k, v, causal, dout, got[0])
                    key = f"{d}/{t}/{'causal' if causal else 'full'}"
                    case = k3_errors(torch, got, ref)
                    if not k3_within(case, tol):
                        raise AssertionError(
                            f"K3 {name} head_dim {d}, T {t}, causal "
                            f"{causal}: errors {case}")
                    errs[key] = [case[n] for n in ("out", "dq", "dk", "dv")]
        worst = max(errs.items(), key=lambda kv: max(kv[1]))
        log("flash_attention_shapes", dtype=name, cases=len(errs),
            heads=heads, bit_identical=True, max_out_err=max(e[0] for e in errs.values()),
            max_grad_err=max(max(e[1:]) for e in errs.values()),
            worst_case=worst, tol=tol)


def run_ulysses(torch, counts) -> dict:
    """The slice's main path: ``ulysses_attention`` on an NCCL process
    group of one rank, T = 32k causal, 8 heads of 8, chunk 2048, bf16,
    forward and backward of (out.float() ** 2).sum(), with every launch
    count set to 0 just before and read just after: both K3 kernels must
    have launched and the plain scan never run. Then output and gradients
    against the plain version run in f32 on the same values, peak memory
    against the dense scores, and the times. Returns the counts."""
    import tempfile

    import torch.distributed as dist

    from dragonfly2_tpu_torch.ops.flash_attention import chunked_attention
    from dragonfly2_tpu_torch.parallel import ulysses_attention

    heads, d, chunk = 8, 8, 2048
    gen = torch.Generator(device="cuda").manual_seed(SEED + 3)
    inputs = [torch.randn(LONG_T, heads, d, generator=gen, device="cuda")
              .to(torch.bfloat16) for _ in range(3)]
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group("nccl", init_method=f"file://{tmp}/store",
                                world_size=1, rank=0)
        try:
            q, k, v = (x.clone().requires_grad_() for x in inputs)
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
            base = torch.cuda.memory_allocated()
            counts.reset()
            chunked_attention.calls = 0
            out = ulysses_attention(q, k, v, causal=True, chunk=chunk)
            (out.float() ** 2).sum().backward()
            torch.cuda.synchronize()
            launches = counts.read()
            plain_calls = chunked_attention.calls
            peak = torch.cuda.max_memory_allocated()
            if (launches["flash_attention"] < 1
                    or launches["flash_attention_backward"] < 1
                    or plain_calls != 0):
                raise AssertionError(f"ulysses: launches {launches}, plain "
                                     f"scan calls {plain_calls}")
            if peak >= DENSE_SCORES_BYTES:
                raise AssertionError(f"ulysses: peak {peak} B is not below "
                                     f"the dense scores' {DENSE_SCORES_BYTES}")
            with torch.no_grad():
                fwd_ms = cuda_ms(torch, lambda: ulysses_attention(
                    q, k, v, causal=True, chunk=chunk), iters=5, warmup=1)

            def fwd_bwd():
                o = ulysses_attention(q, k, v, causal=True, chunk=chunk)
                torch.autograd.grad((o.float() ** 2).sum(), (q, k, v))

            fwd_bwd_ms = cuda_ms(torch, fwd_bwd, iters=3, warmup=1)
        finally:
            dist.destroy_process_group()
    # The plain version on the same inputs, and the same loss.
    ref = k3_reference(torch, lambda *a: chunked_attention(*a, block=chunk),
                       *inputs, True, 2 * out.detach().float(), out.detach())
    errs = k3_errors(torch, (out.detach(), q.grad, k.grad, v.grad), ref)
    tol = K3_TOL["bf16"]
    if not k3_within(errs, tol):
        raise AssertionError(f"ulysses vs plain: {errs} over {tol}")
    log("ulysses", shape=[LONG_T, heads, d], dtype="bf16", causal=True,
        chunk=chunk, world=1, launches=launches, plain_scan_calls=plain_calls,
        errors=errs, tol=tol, fwd_ms=fwd_ms, fwd_bwd_ms=fwd_bwd_ms,
        peak_memory_gib=peak / 2**30,
        peak_above_inputs_gib=(peak - base) / 2**30,
        dense_scores_gib=DENSE_SCORES_BYTES / 2**30)
    return launches


def check_small_model(torch) -> None:
    """The whole model on a small graph: card kernels against the CPU
    plain path, f32 compute, both kernel-carrying modes; then gradients."""
    import torch.nn.functional as F

    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.models.graph_transformer import (
        GraphTransformer,
        build_inverse_index,
        build_neighbor_lists,
        pad_graph_sparse,
    )

    g = SyntheticCluster(n_hosts=60, seed=SEED).probe_graph(3000)
    nbr, val = build_neighbor_lists(g.n_nodes, g.edge_src, g.edge_dst,
                                    g.edge_rtt_ns, cap=16)
    feats, nbr, val, _ = pad_graph_sparse(g.node_features, nbr, val, 16)
    inputs = [torch.from_numpy(a) for a in (feats, nbr, val)]
    errs = {}
    for mode in ("gather", "blocks"):
        model = GraphTransformer(hidden=32, embed=16, layers=2, heads=4,
                                 chunk=16, attention=mode,
                                 dtype=torch.float32,
                                 generator=torch.Generator().manual_seed(1))
        with torch.no_grad():
            cpu = model.node_embeddings(*inputs)
            card = model.cuda().node_embeddings(*(t.cuda() for t in inputs))
        errs[mode] = float((card.cpu() - cpu).abs().max())
        if not errs[mode] <= SMALL_F32_TOL:
            raise AssertionError(f"small model {mode}: card vs CPU max abs "
                                 f"err {errs[mode]} > {SMALL_F32_TOL}")
        if mode == "blocks":
            try:
                model.node_embeddings(*(t.cuda() for t in inputs))
            except ValueError:
                pass
            else:
                raise AssertionError("graph_flash_attention ran under "
                                     "autograd on the card without the "
                                     "inverse index")

    # Gradients of the training loss: the card (gather and scatter-add
    # kernels in gather mode, with the trainer's inverse index and with
    # the transpose derived on the card; K1's forward and backward in
    # blocks and ring mode) against the CPU (their plain versions).
    rng = np.random.default_rng(SEED)
    src, dst = (torch.from_numpy(rng.integers(0, g.n_nodes, 256).astype(
        np.int32)) for _ in range(2))
    y = torch.from_numpy((rng.random(256) < 0.5).astype(np.float32))
    inv = torch.from_numpy(build_inverse_index(nbr))
    grad_errs = {}
    for name, mode, use_inv in (("gather_inv", "gather", inv),
                                ("gather_derived", "gather", None),
                                ("blocks", "blocks", inv),
                                ("ring", "ring", inv)):
        grads = {}
        for dev in ("cpu", "cuda"):
            model = GraphTransformer(
                hidden=32, embed=16, layers=2, heads=4, chunk=16,
                attention=mode, dtype=torch.float32,
                generator=torch.Generator().manual_seed(1)).to(dev)
            args = [t.to(dev) for t in (*inputs, src, dst)]
            logits = model(*args, inv=None if use_inv is None
                           else use_inv.to(dev))
            F.binary_cross_entropy_with_logits(logits, y.to(dev)).backward()
            grads[dev] = {k: None if p.grad is None else p.grad.cpu()
                          for k, p in model.named_parameters()}
        missing = [k for k, v in grads["cuda"].items() if v is None]
        if missing:
            raise AssertionError(f"no gradient on the card for {missing}")
        floor = 1e-3 * max(float(v.abs().max())
                           for v in grads["cpu"].values())
        grad_errs[name] = max(
            float((grads["cuda"][k] - ref).abs().max())
            / max(float(ref.abs().max()), floor)
            for k, ref in grads["cpu"].items())
        if not grad_errs[name] <= GRAD_F32_TOL:
            raise AssertionError(f"gradients ({name}) card vs CPU: "
                                 f"{grad_errs[name]} > {GRAD_F32_TOL}")
    log("small_model", max_abs_err=errs, tol=SMALL_F32_TOL,
        grad_rel_err=grad_errs, grad_tol=GRAD_F32_TOL,
        flash_refuses_grad_without_inv=True)


def host_pace_us(torch, calls: int = 2000) -> float:
    """The host's wall microseconds to enqueue one small eager op
    (``x.add_(1)`` on a one-element tensor on the card): the pace at
    which the host issues a step's launches."""
    x = torch.zeros(1, device="cuda")
    for _ in range(100):
        x.add_(1)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(calls):
        x.add_(1)
    us = (time.perf_counter() - t0) / calls * 1e6
    torch.cuda.synchronize()
    return us


def profile_averages(torch, fn, calls: int):
    """``fn()`` ``calls`` times under ``torch.profiler`` (CPU and CUDA)
    → (its ``key_averages()``, the host's wall ms a call, the
    profile)."""
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3 / calls
    return prof.key_averages(), wall_ms, prof


def launch_shapes(prof) -> dict:
    """{kernel: [grid, block]} of the kernels a profile recorded, from
    its Chrome trace."""
    import tempfile

    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    return {e["name"][:160]: [e["args"].get("grid"), e["args"].get("block")]
            for e in events if e.get("cat") == "kernel"}


def device_kernels(averages, calls: int) -> list:
    """[(kernel, device ms a call, launches a call)] slowest first. A CPU
    op's entry, and a user annotation's range on the device (the
    optimizer's step), repeat the time of the kernels inside: kernels
    only."""
    from torch.autograd import DeviceType

    return sorted(((e.key, e.self_device_time_total / 1e3 / calls,
                    e.count / calls)
                   for e in averages
                   if e.device_type == DeviceType.CUDA
                   and not getattr(e, "is_user_annotation", False)
                   and e.self_device_time_total > 0),
                  key=lambda kv: -kv[1])


def time_and_profile(torch, step, batches) -> dict:
    """``step(ids)`` over 13 ``batches``: the steady step time (10 steps
    after 3 warm ones, CUDA events), then a profile of 3 more steps →
    dict(step_ms; device_ms, the kernels' time a step; kernels, [(kernel,
    ms, launches)] a step, slowest first; device_ops, the device's
    kernels and copies a step; runtime, {CUDA runtime call: [calls, host
    ms]} a step — launches, copies, and the waits a read of a device
    value makes; cpu_ops, the 12 host ops with the most self time a step,
    [(op, calls, ms)]; cpu_self_ms, all ops' self time a step;
    profiled_step_ms, a profiled step's wall time; host_pace_us,
    :func:`host_pace_us`; host_step_ms, the host's wall time in each timed
    step; gc_ms, the time Python's garbage collector took in the timed
    steps, and gc_runs, its collections)."""
    import gc

    from torch.autograd import DeviceType

    for ids in batches[:3]:
        step(ids)
    torch.cuda.synchronize()
    gc_ms, gc_runs, gc_start = [0.0], [0], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            gc_ms[0] += (time.perf_counter() - gc_start[0]) * 1e3
            gc_runs[0] += 1

    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    host_step_ms = []
    gc.callbacks.append(on_gc)
    start.record()
    for ids in batches[3:13]:
        t0 = time.perf_counter()
        step(ids)
        host_step_ms.append((time.perf_counter() - t0) * 1e3)
    end.record()
    end.synchronize()
    gc.callbacks.remove(on_gc)
    step_ms = start.elapsed_time(end) / 10
    steps = iter(batches[:3])
    averages, profiled_ms, _ = profile_averages(
        torch, lambda: step(next(steps)), 3)
    kernels = device_kernels(averages, 3)
    host = [e for e in averages if e.device_type == DeviceType.CPU]
    runtime = {e.key: [e.count / 3, e.self_cpu_time_total / 3e3]
               for e in host
               if e.key.startswith("cu") and "::" not in e.key}
    cpu_ops = sorted(((e.key, e.count / 3, e.self_cpu_time_total / 3e3)
                      for e in host), key=lambda kv: -kv[2])
    return dict(step_ms=step_ms, device_ms=sum(k[1] for k in kernels),
                kernels=kernels, device_ops=sum(k[2] for k in kernels),
                runtime=runtime, cpu_ops=cpu_ops[:12],
                cpu_self_ms=sum(op[2] for op in cpu_ops),
                profiled_step_ms=profiled_ms,
                host_pace_us=host_pace_us(torch), host_step_ms=host_step_ms,
                gc_ms=gc_ms[0], gc_runs=gc_runs[0])


def log_profile(phase: str, timing: dict) -> None:
    """The profile half of :func:`time_and_profile`'s result as
    ``phase``."""
    log(phase, device_ms_per_step=timing["device_ms"],
        busy_share=timing["device_ms"] / timing["step_ms"],
        top_kernels_ms=[k[:2] for k in timing["kernels"][:15]],
        device_ops_per_step=timing["device_ops"],
        runtime_per_step=timing["runtime"],
        top_cpu_ops_ms=timing["cpu_ops"],
        cpu_self_ms_per_step=timing["cpu_self_ms"],
        profiled_step_ms=timing["profiled_step_ms"],
        host_pace_us=timing["host_pace_us"],
        host_step_ms=timing["host_step_ms"], gc_ms=timing["gc_ms"],
        gc_runs=timing["gc_runs"])


def run_train(torch, graph, cfg, counts, phase: str):
    """Train config #3 (``GATTrainer.fit``, the body of ``train_gat``)
    with every launch count set to 0 just before and read just after. The
    mode's kernels must have launched exactly as often as its path needs
    — its forward kernel once a layer in every forward (train steps and
    eval chunks), its backward kernel once a layer in every backward —
    and the other mode's and K3's never; the loss must be finite and
    fall. Then the steady step time (10 steps after 3 warm ones, CUDA
    events), samples/s, F1, accuracy, peak memory, and a profile of 3
    steps (device time by kernel, the device's busy share), logged as
    ``phase`` and ``phase``_profile (:func:`time_and_profile`). Returns
    (trainer, result, launches)."""
    from dragonfly2_tpu_torch.train.gat_trainer import GATTrainer
    from dragonfly2_tpu_torch.train.metrics import padded_chunks

    counts.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = GATTrainer(graph, cfg)
    result = trainer.fit()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = counts.read()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = len(result.step_losses)
    eval_chunks = len(list(padded_chunks(trainer.eval_ids, trainer.batch)))
    forwards = cfg.layers * (steps + eval_chunks)
    backwards = cfg.layers * steps
    expected = dict.fromkeys(launches, 0)
    if cfg.attention == "gather":
        expected.update(table_gather=forwards, table_scatter_add=backwards)
    else:
        expected.update(graph_flash_attention=forwards,
                        graph_flash_attention_backward=backwards)
    if steps < 1 or launches != expected:
        raise AssertionError(f"{phase}: launches {launches} on the train "
                             f"path, expected {expected}")
    losses = np.asarray(result.step_losses)
    if len(losses) < 21 or not np.isfinite(losses).all():
        raise AssertionError(f"{phase}: {len(losses)} steps, finite: "
                             f"{bool(np.isfinite(losses).all())}")
    early, late = float(losses[1:11].mean()), float(losses[-10:].mean())
    if not late < early:
        raise AssertionError(f"{phase}: loss did not fall: steps 2-11 mean "
                             f"{early}, last 10 mean {late}")
    order = np.random.default_rng(SEED + 1).permutation(trainer.train_ids)
    timing = time_and_profile(
        torch, trainer.step,
        order[:13 * trainer.batch].reshape(13, trainer.batch))
    step_ms = timing["step_ms"]
    log_profile(f"{phase}_profile", timing)
    log(phase, attention=cfg.attention, seconds=train_s, steps=steps,
        launches=launches, expected_launches=expected,
        loss_first=float(losses[0]), loss_steps_2_11=early,
        loss_last_10=late, history=result.history, step_ms=step_ms,
        samples_per_sec=result.samples_per_sec, f1=result.f1,
        accuracy=result.accuracy, precision=result.precision,
        recall=result.recall, peak_memory_gib=peak_gib,
        rows=int(trainer.nbr.shape[0]),
        inverse_index=list(trainer.g_inv.shape),
        train_edges=len(trainer.train_ids), eval_edges=len(trainer.eval_ids),
        batch=trainer.batch)
    return trainer, result, launches


def serve_trained(torch, result, graph, service, ctx, pairs,
                  phase: str) -> None:
    """The trained result as a port artifact, loaded through
    ``_gat_scorer_from_artifact`` and answering ModelInfer requests, which
    must equal the trained model's own scores."""
    from dragonfly2_tpu_torch.inference.sidecar import (
        ModelInferRequest,
        _gat_scorer_from_artifact,
    )
    from dragonfly2_tpu_torch.train.checkpoint import gat_artifact_from_result

    t0 = time.perf_counter()
    trained = _gat_scorer_from_artifact(gat_artifact_from_result(
        result, graph, f"smoke-gat-{phase}"))
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    service.install_scorer("gat", trained, version=phase)
    served = [service.ModelInfer(ModelInferRequest("gat", p), ctx).outputs
              for p in pairs]
    own = result.model.cuda().eval()
    with torch.no_grad():
        own_emb = own.node_embeddings(*(torch.from_numpy(a).cuda() for a in (
            result.node_features, result.neighbors, result.neighbor_vals)))
        own_scores = [own.score_pairs(
            own_emb, *torch.from_numpy(p.astype(np.int32)).cuda().T
        ).float().cpu().numpy() for p in pairs]
    if not all(np.isfinite(o).all() and o.shape == (len(p),)
               for o, p in zip(served, pairs)):
        raise AssertionError(f"{phase}: bad response shapes or values")
    served_err = max(float(np.abs(a - b).max())
                     for a, b in zip(served, own_scores))
    if served_err > MODE_TOL:
        raise AssertionError(f"{phase}: served vs the model's own scores: "
                             f"{served_err} > {MODE_TOL}")
    log(phase, attention=result.config.attention, load_seconds=load_s,
        max_abs_diff=served_err, tol=MODE_TOL, requests=len(served))


def run_ring_one(torch, counts) -> dict:
    """Ring mode in a world of one, at small width: a ring trainer on the
    card (rows padded to whole chunks) with every launch count set to 0
    just before and read just after — K1's forward and backward must have
    launched once a layer a forward and a backward, nothing else — and a
    finite loss; its trained embeddings on the card must equal blocks
    mode's on the same weights (the same K1 forward); and the ring result
    must serve through a port artifact. Returns the launches."""
    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.inference.sidecar import (
        CallContext,
        InferenceService,
    )
    from dragonfly2_tpu_torch.models.graph_transformer import GraphTransformer
    from dragonfly2_tpu_torch.train.gat_trainer import (
        GATTrainConfig,
        GATTrainer,
    )
    from dragonfly2_tpu_torch.train.metrics import padded_chunks

    graph = SyntheticCluster(n_hosts=300, seed=SEED).probe_graph(6000)
    cfg = GATTrainConfig(**RING_CFG)
    counts.reset()
    trainer = GATTrainer(graph, cfg)
    result = trainer.fit()
    torch.cuda.synchronize()
    launches = counts.read()
    steps = len(result.step_losses)
    eval_chunks = len(list(padded_chunks(trainer.eval_ids, trainer.batch)))
    expected = dict.fromkeys(launches, 0)
    expected.update(graph_flash_attention=cfg.layers * (steps + eval_chunks),
                    graph_flash_attention_backward=cfg.layers * steps)
    rows = trainer.nbr.shape[0]
    if steps < 3 or launches != expected or rows % cfg.chunk:
        raise AssertionError(f"ring_one: {steps} steps, {rows} rows, "
                             f"launches {launches}, expected {expected}")
    if not np.isfinite(result.step_losses).all():
        raise AssertionError("ring_one: non-finite loss")
    graph_in = [torch.from_numpy(a).cuda() for a in (
        result.node_features, result.neighbors, result.neighbor_vals)]
    emb = {}
    for mode in ("ring", "blocks"):
        model = GraphTransformer(
            in_features=result.node_features.shape[1], hidden=cfg.hidden,
            embed=cfg.embed, layers=cfg.layers, heads=cfg.heads,
            chunk=cfg.chunk, attention=mode)
        model.load_state_dict(result.state_dict)
        with torch.no_grad():
            emb[mode] = model.cuda().node_embeddings(*graph_in).float()
    emb_err = float((emb["ring"] - emb["blocks"]).abs().max())
    if not torch.isfinite(emb["ring"]).all() or emb_err > MODE_TOL:
        raise AssertionError(f"ring_one: ring vs blocks embeddings "
                             f"{emb_err} > {MODE_TOL}")
    pairs = [np.random.default_rng(SEED + 2).integers(
        0, graph.n_nodes, (16, 2)) for _ in range(3)]
    serve_trained(torch, result, graph, InferenceService(micro_batch=False),
                  CallContext(), pairs, "ring_to_serve")
    log("ring_one", steps=steps, rows=rows, launches=launches,
        expected_launches=expected, history=result.history,
        ring_vs_blocks_embeddings=emb_err,
        bit_equal=bool(torch.equal(emb["ring"], emb["blocks"])),
        tol=MODE_TOL, f1=result.f1, accuracy=result.accuracy)
    return launches


def gnn_batch(torch, trainer, n: int, seed: int):
    """(src, dst, labels) of ``n`` train edges on the trainer's device, in
    a seeded order."""
    pos = np.random.default_rng(seed).permutation(
        trainer.train_sampler.n_edges)[:n]
    ids = torch.from_numpy(pos).to(trainer.device)
    return tuple(t[ids] for t in trainer.train_edges)


def check_gnn_sampling(torch, trainer) -> None:
    """On-device sampling on the card against the same sampling on the
    CPU, for the trainer's own tables and a train batch, at three salt
    pairs: every id, rtt and mask bit-equal (integer ops must not drift
    between devices)."""
    from dragonfly2_tpu_torch.train.fused_sampling import (
        put_graph_tables,
        sample_indices,
    )

    cpu_tables = put_graph_tables(trainer.csr, "cpu")
    src, dst, _ = gnn_batch(torch, trainer, trainer.batch, SEED + 3)
    salt_pairs = [(0, 2**32 - 1), (2**31, 7),
                  tuple(np.random.default_rng(SEED).integers(0, 2**32, 2))]
    for salts in salt_pairs:
        card = sample_indices(trainer.tables, src, dst, salts,
                              trainer.config.fanouts)
        cpu = sample_indices(cpu_tables, src.cpu(), dst.cpu(), salts,
                             trainer.config.fanouts)
        for name, a, b in zip(("centers", "nbr1", "rtt1", "mask1", "nbr2",
                               "rtt2", "mask2"), card, cpu):
            if a.dtype != b.dtype or not torch.equal(a.cpu(), b):
                raise AssertionError(f"gnn sampling: {name} on the card "
                                     f"differs from the CPU at salts "
                                     f"{salts}")
    log("gnn_sampling", bit_equal=True, batch=int(src.shape[0]),
        salts=[[int(x) for x in p] for p in salt_pairs],
        sampled_rows=int(card[4].numel()))


def check_gnn_small_model(torch) -> None:
    """A small GraphSAGE in f32, card (on-device sampling, K2a) against
    the CPU (the same sampling, the plain gather): logits within
    SMALL_F32_TOL and every parameter's gradient of the loss within
    GRAD_F32_TOL of its leaf's max."""
    import torch.nn.functional as F

    from dragonfly2_tpu_torch.data import SyntheticCluster
    from dragonfly2_tpu_torch.data.graph_sampler import CSRGraph
    from dragonfly2_tpu_torch.models.graphsage import GraphSAGE
    from dragonfly2_tpu_torch.train.fused_sampling import (
        put_graph_tables,
        sample_and_apply,
    )

    csr = CSRGraph.from_graph(
        SyntheticCluster(n_hosts=100, seed=SEED).probe_graph(10000))
    rng = np.random.default_rng(SEED)
    src, dst = (torch.from_numpy(rng.integers(0, csr.n_nodes, 256).astype(
        np.int32)) for _ in range(2))
    y = torch.from_numpy((rng.random(256) < 0.5).astype(np.float32))
    logits, grads = {}, {}
    for dev in ("cpu", "cuda"):
        model = GraphSAGE(hidden=32, embed=16, dtype=torch.float32,
                          generator=torch.Generator().manual_seed(1)).to(dev)
        out = sample_and_apply(model, put_graph_tables(csr, dev),
                               src.to(dev), dst.to(dev), (5, 2**32 - 3),
                               (10, 5))
        F.binary_cross_entropy_with_logits(out, y.to(dev)).backward()
        logits[dev] = out.detach().cpu()
        grads[dev] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    err = float((logits["cuda"] - logits["cpu"]).abs().max())
    grad_err = max(float((grads["cuda"][k] - ref).abs().max())
                   / max(float(ref.abs().max()), 1e-12)
                   for k, ref in grads["cpu"].items())
    if not (err <= SMALL_F32_TOL and grad_err <= GRAD_F32_TOL):
        raise AssertionError(f"gnn small model card vs CPU: logits {err} "
                             f"(tol {SMALL_F32_TOL}), gradients {grad_err} "
                             f"(tol {GRAD_F32_TOL})")
    log("gnn_small_model", max_abs_err=err, tol=SMALL_F32_TOL,
        grad_rel_err=grad_err, grad_tol=GRAD_F32_TOL)


def gnn_step_indices(torch, trainer):
    """One train step's concatenated int32 feature-gather indices
    (centres, 1-hop, 2-hop), as ``gather_features`` builds them."""
    from dragonfly2_tpu_torch.train.fused_sampling import sample_indices

    src, dst, _ = gnn_batch(torch, trainer, trainer.batch, SEED + 4)
    ids = sample_indices(trainer.tables, src, dst, (1, 2),
                         trainer.config.fanouts)
    return torch.cat([ids[i].reshape(-1) for i in (0, 1, 4)])


def run_train_gnn(torch, graph, counts, device_sample: bool, phase: str):
    """Train config #2 (``GNNTrainer.fit``, the body of ``train_gnn``),
    sampling on the card or (``device_sample=False``) on the host, with
    every launch count set to 0 just before and read just after: K2a once
    a forward (train steps and eval chunks), no other kernel; the loss
    finite and falling; F1 at least GNN_F1_MIN; samples/s, quality and
    peak memory, logged as ``phase``. On the card-sampling path also the
    steady step time and a profile of 3 steps (:func:`time_and_profile`),
    logged as ``phase``_profile. Returns (trainer, result, launches)."""
    from dragonfly2_tpu_torch.train.gnn_trainer import (
        GNNTrainConfig,
        GNNTrainer,
    )
    from dragonfly2_tpu_torch.train.metrics import padded_chunks

    counts.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = GNNTrainer(graph, GNNTrainConfig(
        **GNN_CFG, device_sample=device_sample))
    result = trainer.fit()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = counts.read()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = len(result.step_losses)
    eval_chunks = len(list(padded_chunks(trainer.eval_ids, trainer.batch)))
    expected = dict.fromkeys(launches, 0)
    expected["table_gather"] = steps + eval_chunks
    if steps < 21 or launches != expected:
        raise AssertionError(f"{phase}: {steps} steps, launches "
                             f"{launches}, expected {expected}")
    losses = np.asarray(result.step_losses)
    early, late = float(losses[1:11].mean()), float(losses[-10:].mean())
    if not (np.isfinite(losses).all() and late < early):
        raise AssertionError(f"{phase}: loss steps 2-11 mean {early}, "
                             f"last 10 mean {late}")
    if not result.f1 >= GNN_F1_MIN:
        raise AssertionError(f"{phase}: F1 {result.f1} < {GNN_F1_MIN}")
    timed = {}
    if device_sample:
        order = np.random.default_rng(SEED + 1).permutation(
            trainer.train_sampler.n_edges)
        timing = time_and_profile(
            torch, trainer.step,
            order[:13 * trainer.batch].reshape(13, trainer.batch))
        log_profile(f"{phase}_profile", timing)
        timed = dict(step_ms=timing["step_ms"],
                     samples_per_sec_at_step_ms=(
                         trainer.batch / timing["step_ms"] * 1e3))
    log(phase, device_sample=device_sample, seconds=train_s, steps=steps,
        epochs=trainer.config.epochs,
        launches=launches, expected_launches=expected,
        loss_first=float(losses[0]), loss_steps_2_11=early,
        loss_last_10=late, history=result.history,
        samples_per_sec=result.samples_per_sec, **timed,
        f1=result.f1, precision=result.precision, recall=result.recall,
        accuracy=result.accuracy, peak_memory_gib=peak_gib,
        train_edges=len(trainer.train_ids), eval_edges=len(trainer.eval_ids),
        batch=trainer.batch, f1_min=GNN_F1_MIN)
    return trainer, result, launches


def gnn_to_artifact(torch, trainer, result, graph) -> None:
    """The trained result as a ``gnn`` artifact, loaded back on the card:
    its logits on one batch (the same salts) equal the trained model's."""
    from dragonfly2_tpu_torch.train.checkpoint import (
        gnn_artifact_from_result,
        gnn_model_from_artifact,
    )
    from dragonfly2_tpu_torch.train.fused_sampling import sample_and_apply

    t0 = time.perf_counter()
    artifact = gnn_artifact_from_result(result, "smoke-gnn",
                                        n_samples=graph.n_edges)
    loaded, node_features, metadata = gnn_model_from_artifact(artifact)
    load_s = time.perf_counter() - t0
    src, dst, _ = gnn_batch(torch, trainer, 1024, SEED + 5)
    with torch.no_grad():
        got, want = (sample_and_apply(m, trainer.tables, src, dst, (3, 4),
                                      trainer.config.fanouts)
                     for m in (loaded, result.model.cuda()))
    if not (np.array_equal(node_features, result.node_features)
            and metadata.model_type == "gnn"
            and bool(torch.isfinite(got).all()) and torch.equal(got, want)):
        raise AssertionError(f"gnn artifact: loaded logits differ by "
                             f"{float((got - want).abs().max())}")
    log("train_gnn_to_artifact", bytes=len(artifact), load_seconds=load_s,
        logits_equal=True, rows=int(got.shape[0]),
        evaluation=metadata.evaluation)


# -- slice 9: the MLP bandwidth predictor, the cost model, the evaluators ---


class SmokeHost:
    """A duck-typed scheduler host (``evaluator.base.HostLike``); ``type``
    is truthy for a seed host."""

    def __init__(self, type: int, upload_count: int,
                 upload_failed_count: int, concurrent_upload_limit: int,
                 concurrent_upload_count: int, idc: str, location: str):
        self.type = type
        self.upload_count = upload_count
        self.upload_failed_count = upload_failed_count
        self.concurrent_upload_limit = concurrent_upload_limit
        self.concurrent_upload_count = concurrent_upload_count
        self.idc = idc
        self.location = location

    def free_upload_count(self) -> int:
        return self.concurrent_upload_limit - self.concurrent_upload_count


class SmokePeer:
    """A duck-typed scheduler peer (``evaluator.base.PeerLike``) whose
    piece costs judge ``is_bad_node`` through the numpy path."""

    def __init__(self, id: str, host: SmokeHost, state: str, finished: int,
                 costs: list):
        self.id = id
        self.host = host
        self._state = state
        self._finished = finished
        self.costs = costs

    def state(self) -> str:
        return self._state

    def finished_piece_count(self) -> int:
        return self._finished

    def piece_costs(self):
        return self.costs


def smoke_peer(rng, name: str) -> SmokePeer:
    """A seeded peer: a host in a 4-region/4-zone/8-rack tree (a tenth of
    them seeds), its uploads and failures, one of three states (one of
    them, ReceivedNormal, bad by state), and 8–40 piece costs around its
    own typical cost, the latest ×1, ×5 or ×30 that cost."""
    seed = bool(rng.random() < 0.1)
    limit = 300 if seed else 50
    uploads = int(rng.poisson(50))
    region, zone, rack = (int(v) for v in rng.integers(0, (4, 4, 8)))
    host = SmokeHost(
        type=int(seed), upload_count=uploads,
        upload_failed_count=int(rng.binomial(uploads, 0.1)),
        concurrent_upload_limit=limit,
        concurrent_upload_count=int(rng.integers(0, limit)),
        idc=f"idc-{region * 4 + zone}",
        location=f"r{region}|z{zone}|k{rack}")
    typical = float(rng.lognormal(np.log(0.05), 0.6))
    costs = list(rng.lognormal(np.log(typical), 0.2,
                               int(rng.integers(8, 41))))
    costs[-1] = typical * float(rng.choice([1.0, 5.0, 30.0]))
    return SmokePeer(name, host, str(rng.choice(
        ["Running", "ReceivedNormal", "Succeeded"])),
        int(rng.integers(0, 256)), costs)


def seeded_decisions(seed: int, n: int, k: int) -> list:
    """``n`` seeded (parents, child, total_piece_count) decisions of ``k``
    candidates each."""
    rng = np.random.default_rng(seed)
    return [([smoke_peer(rng, f"p{d}-{i}") for i in range(k)],
             smoke_peer(rng, f"c{d}"),
             int(rng.choice([0, 64, 256, 1024]))) for d in range(n)]


def mlp_artifact(tree: dict, model_type: str, hidden, evaluation=None):
    from dragonfly2_tpu_torch.train.checkpoint import (
        ModelMetadata,
        write_artifact,
    )

    return write_artifact(tree, ModelMetadata(
        model_id=f"smoke-{model_type}", model_type=model_type,
        evaluation=evaluation or {}, config={"hidden": list(hidden)}))


def poisoned(tree: dict, how: str) -> dict:
    """``tree`` with every weight NaN (``"nan"``) or 0 (``"zero"``): a
    loadable model whose scores the guard must reject (NaN, or one
    constant)."""
    fill = np.nan if how == "nan" else 0.0

    def walk(node):
        return {k: walk(v) if isinstance(v, dict)
                else np.full_like(v, fill) for k, v in node.items()}

    return dict(tree, params=walk(tree["params"]))


def f32_cpu_scorer(torch, artifact: bytes, max_batch: int = 64):
    """A CPU copy of an MLP-layout artifact's model, computing in f32,
    ``max_batch`` rows a forward."""
    from dragonfly2_tpu_torch.inference.scorer import ParentScorer
    from dragonfly2_tpu_torch.models.mlp import MLPBandwidthPredictor
    from dragonfly2_tpu_torch.train.checkpoint import (
        load_artifact,
        mlp_from_tree,
        mlp_state_dict_from_flax,
    )

    tree, metadata = load_artifact(artifact)
    params, norm, target = mlp_from_tree(tree)
    model = MLPBandwidthPredictor(hidden=metadata.config["hidden"],
                                  dtype=torch.float32)
    model.load_state_dict(mlp_state_dict_from_flax(params))
    return ParentScorer(model, norm, target, max_batch=max_batch,
                        device="cpu")


def check_mlp_small_model(torch) -> None:
    """A small MLP in f32, card against CPU on the same weights and rows:
    the loss and every parameter's gradient of it within GRAD_F32_TOL of
    its leaf's max."""
    from dragonfly2_tpu_torch.models.mlp import MLPBandwidthPredictor
    from dragonfly2_tpu_torch.train.mlp_trainer import mlp_loss

    rng = np.random.default_rng(SEED)
    x = torch.from_numpy(rng.standard_normal((1024, 11)).astype(np.float32))
    t = torch.from_numpy(rng.standard_normal(1024).astype(np.float32))
    losses, grads = {}, {}
    for dev in ("cpu", "cuda"):
        model = MLPBandwidthPredictor(
            hidden=(32, 32), dtype=torch.float32,
            generator=torch.Generator().manual_seed(1)).to(dev)
        loss = mlp_loss(model, x.to(dev), t.to(dev))
        loss.backward()
        losses[dev] = float(loss.detach())
        grads[dev] = {k: p.grad.cpu() for k, p in model.named_parameters()}
    loss_err = abs(losses["cuda"] - losses["cpu"])
    grad_err = max(float((grads["cuda"][k] - ref).abs().max())
                   / max(float(ref.abs().max()), 1e-12)
                   for k, ref in grads["cpu"].items())
    if not (loss_err <= SMALL_F32_TOL and grad_err <= GRAD_F32_TOL):
        raise AssertionError(f"mlp small model card vs CPU: loss {loss_err} "
                             f"(tol {SMALL_F32_TOL}), gradients {grad_err} "
                             f"(tol {GRAD_F32_TOL})")
    log("mlp_small_model", loss_abs_err=loss_err, tol=SMALL_F32_TOL,
        grad_rel_err=grad_err, grad_tol=GRAD_F32_TOL)


def falling(losses) -> tuple[float, float]:
    """(mean of the first w steps after the first, mean of the last w),
    w = min(10, a third of the run): a run's loss must be finite and the
    second below the first."""
    losses = np.asarray(losses)
    w = min(10, len(losses) // 3)
    early, late = float(losses[1:1 + w].mean()), float(losses[-w:].mean())
    if w < 4 or not (np.isfinite(losses).all() and late < early):
        raise AssertionError(f"{len(losses)} steps, loss steps 2-{w + 1} "
                             f"mean {early}, last {w} mean {late}")
    return early, late


def run_train_mlp(torch, X, y, counts):
    """Train config #1 (``MLPTrainer.fit``, the body of ``train_mlp``)
    with every launch count set to 0 just before and read just after — no
    kernel may launch — a finite, falling loss and an eval MAE below
    predicting the train split's mean; then the steady step time and a
    profile of 3 steps (:func:`time_and_profile`). Returns (trainer,
    result, launches)."""
    from dragonfly2_tpu_torch.train.mlp_trainer import (
        MLPTrainConfig,
        MLPTrainer,
    )

    counts.reset()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    trainer = MLPTrainer(X, y, MLPTrainConfig(**MLP_CFG))
    result = trainer.fit()
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = counts.read()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    if any(launches.values()):
        raise AssertionError(f"train_mlp launched kernels: {launches}")
    early, late = falling(result.step_losses)
    train_y = trainer.train_ds.arrays[1]
    eval_y = trainer.eval_y.cpu().numpy()
    mean_mae = float(np.abs(eval_y - train_y.mean()).mean())
    if not (np.isfinite(result.mse) and result.mae < mean_mae):
        raise AssertionError(f"train_mlp: eval MAE {result.mae} not below "
                             f"the predict-mean MAE {mean_mae}")
    order = trainer.epoch_order(0)
    timing = time_and_profile(torch, trainer.step, [
        order[i * trainer.batch:(i + 1) * trainer.batch] for i in range(13)])
    log_profile("train_mlp_profile", timing)
    log("train_mlp", seconds=train_s, steps=len(result.step_losses),
        epochs=trainer.config.epochs, launches=launches,
        loss_first=result.step_losses[0], loss_early=early,
        loss_late=late, history=result.history,
        samples_per_sec=result.samples_per_sec, step_ms=timing["step_ms"],
        samples_per_sec_at_step_ms=trainer.batch / timing["step_ms"] * 1e3,
        eval_mse=result.mse, eval_mae=result.mae, predict_mean_mae=mean_mae,
        peak_memory_gib=peak_gib, train_rows=len(train_y),
        eval_rows=len(eval_y), batch=trainer.batch)
    return trainer, result, launches


def serve_trained_mlp(torch, result, eval_x, service, ctx):
    """The trained result as an ``mlp`` artifact, loaded through
    ``_scorer_from_artifact`` and answering 15-candidate ModelInfer
    requests, which must equal the trained model's own predictions
    exactly; ModelInfer p50. Returns (artifact, the loaded scorer)."""
    from dragonfly2_tpu_torch.inference.sidecar import (
        ModelInferRequest,
        _scorer_from_artifact,
    )
    from dragonfly2_tpu_torch.train.checkpoint import mlp_tree

    artifact = mlp_artifact(
        mlp_tree(result.params, result.normalizer, result.target_norm),
        "mlp", result.config.hidden, {"mse": result.mse, "mae": result.mae})
    t0 = time.perf_counter()
    scorer = _scorer_from_artifact(artifact)
    load_s = time.perf_counter() - t0
    service.install_scorer("mlp", scorer, version="trained")
    requests = [eval_x[i * 15:(i + 1) * 15] for i in range(20)]
    served = [service.ModelInfer(ModelInferRequest("mlp", r), ctx).outputs
              for r in requests]
    # The model's own forward at the scorer's one shape (zero rows to
    # max_batch): at another row count cuBLAS sums in another order.
    own = result.model.cuda().eval()
    mean, std = (torch.from_numpy(a).cuda()
                 for a in (result.normalizer.mean, result.normalizer.std))
    t_mean, t_std = (float(a[0]) for a in (result.target_norm.mean,
                                           result.target_norm.std))
    own_scores = []
    with torch.no_grad():
        for r in requests:
            x = torch.zeros(scorer.max_batch, r.shape[1], device=mean.device)
            x[:len(r)] = torch.from_numpy(r)
            own_scores.append((own((x - mean) / std) * t_std + t_mean
                               )[:len(r)].cpu().numpy())
    differ = sum(int((a != b).sum()) for a, b in zip(served, own_scores))
    if differ or not all(np.isfinite(o).all() and o.shape == (15,)
                         for o in served):
        raise AssertionError(f"train_mlp_to_serve: {differ} of "
                             f"{15 * len(requests)} replies differ from the "
                             "trained model's predictions")
    p50 = p50_ms(lambda: service.ModelInfer(
        ModelInferRequest("mlp", requests[0]), ctx), n=200)
    log("train_mlp_to_serve", bytes=len(artifact), load_seconds=load_s,
        replies=15 * len(requests), replies_differing=differ,
        model_infer_p50_ms=p50, candidates=15)
    return artifact, scorer


def check_score_corpus(torch, scorer, X) -> None:
    """All rows through ``score_corpus`` (rows/s), and again shuffled;
    sampled rows through ``score`` in requests of 1 to 64 rows: every
    row must be bit-identical to its ``score_corpus`` output."""
    t0 = time.perf_counter()
    corpus = scorer.score_corpus(X)
    corpus_s = time.perf_counter() - t0
    perm = np.random.default_rng(SEED + 7).permutation(len(X))
    differ = {"corpus_shuffled": int(
        (scorer.score_corpus(X[perm]) != corpus[perm]).sum())}
    sample = perm[:1024]
    for n in SCORE_REQUEST_ROWS:
        got = np.concatenate([scorer.score(X[sample[s:s + n]])
                              for s in range(0, len(sample), n)])
        differ[f"requests_of_{n}"] = int((got != corpus[sample]).sum())
    total = sum(differ.values())
    if total or not np.isfinite(corpus).all():
        raise AssertionError(f"score_corpus: rows differing {differ}")
    log("score_corpus", rows=len(X), seconds=corpus_s,
        rows_per_sec=len(X) / corpus_s, block=scorer.max_batch,
        rows_checked=len(X) + len(sample) * len(SCORE_REQUEST_ROWS),
        rows_differing=total, by_case=differ)


def check_ml_evaluator(torch, artifact, scorer) -> None:
    """``new_evaluator("ml")`` over the trained scorer on seeded
    decisions: each order identical to a CPU copy of the artifact in f32,
    or differing only between candidates whose card (bf16) scores are
    under ML_ORDER_GAP apart; decision p50. A NaN-weighted and a
    zero-weighted artifact must each give exactly the rule evaluator's
    order on every decision, count a guard trip per decision, and call
    the quarantine hook once."""
    from dragonfly2_tpu_torch.inference.sidecar import _scorer_from_artifact
    from dragonfly2_tpu_torch.scheduler.evaluator import (
        BaseEvaluator,
        new_evaluator,
    )
    from dragonfly2_tpu_torch.scheduler.evaluator.base import (
        build_feature_matrix,
    )
    from dragonfly2_tpu_torch.train.checkpoint import load_artifact
    from dragonfly2_tpu_torch.utils.servingstats import ServingStats

    decisions = seeded_decisions(SEED + 8, ML_DECISIONS, ML_CANDIDATES)
    card = new_evaluator("ml", scorer=scorer, stats=ServingStats())
    cpu = new_evaluator("ml", scorer=f32_cpu_scorer(torch, artifact),
                        stats=ServingStats())
    identical, worst_gap = 0, 0.0
    for parents, child, total in decisions:
        got = card.evaluate_parents(parents, child, total)
        want = cpu.evaluate_parents(parents, child, total)
        if got == want:
            identical += 1
            continue
        scores = dict(zip((p.id for p in parents), scorer.score(
            build_feature_matrix(parents, child, total))))
        pos = {p.id: i for i, p in enumerate(got)}
        for i, a in enumerate(want):
            for b in want[i + 1:]:
                if pos[a.id] > pos[b.id]:
                    worst_gap = max(worst_gap, float(abs(
                        scores[a.id] - scores[b.id])))
    if worst_gap >= ML_ORDER_GAP or card.scored_count != ML_DECISIONS:
        raise AssertionError(
            f"ml evaluator: {identical}/{ML_DECISIONS} orders identical to "
            f"the f32 CPU copy; candidates {worst_gap} apart swapped "
            f"(limit {ML_ORDER_GAP}); {card.scored_count} scored")
    parents, child, total = decisions[0]
    p50_us = p50_ms(lambda: card.evaluate_parents(parents, child, total),
                    n=200) * 1e3
    tree, metadata = load_artifact(artifact)
    rule = BaseEvaluator()
    poison = {}
    for how in ("nan", "zero"):
        fired = []
        stats = ServingStats()
        ev = new_evaluator("ml", scorer=_scorer_from_artifact(mlp_artifact(
            poisoned(tree, how), "mlp", metadata.config["hidden"])),
            stats=stats,
            on_quarantine=lambda reason: fired.append(reason))
        same = sum(ev.evaluate_parents(p, c, t) == rule.evaluate_parents(
            p, c, t) for p, c, t in decisions)
        poison[how] = dict(rule_orders=same, guard_trips=ev.guard_trips,
                           quarantines=len(fired), reasons=sorted(set(fired)),
                           stats=stats.snapshot())
        if not (same == ML_DECISIONS and ev.guard_trips == ML_DECISIONS
                and len(fired) == 1
                and stats.get("ml_guard_trips") == ML_DECISIONS
                and stats.get("ml_quarantines_reported") == 1):
            raise AssertionError(f"ml evaluator on a {how} artifact: "
                                 f"{poison[how]}")
    log("ml_evaluator", decisions=ML_DECISIONS, candidates=ML_CANDIDATES,
        identical_to_f32_cpu=identical, worst_swapped_gap=worst_gap,
        gap_limit=ML_ORDER_GAP, decision_p50_us=p50_us, poisoned=poison)


class ColumnarCorpus:
    """A duck-typed columnar replay corpus: [N, K] candidate slots with
    their decision-time features [N, K, 11], ``valid``, ``realized_n`` and
    ``realized_cost`` (what ``cost_examples_from_corpus`` reads)."""

    def __init__(self, features, valid, realized_n, realized_cost):
        self.features = features
        self.valid = valid
        self.realized_n = realized_n
        self.realized_cost = realized_cost


def cost_corpus(X, y) -> ColumnarCorpus:
    """The cost model's stand-in corpus: COST_ROWS synthetic pair rows as
    decisions of COST_SLOTS candidate slots, each realizing the cost of a
    PIECE_MB piece at its bandwidth (the inverse of
    ``bandwidth_examples_from_corpus``); a seeded tenth of the slots
    realized no cost (and every slot of the last decision is invalid)."""
    n = COST_ROWS // COST_SLOTS
    rng = np.random.default_rng(SEED + 9)
    realized_n = rng.integers(1, 20, (n, COST_SLOTS))
    realized_n[rng.random((n, COST_SLOTS)) < 0.1] = 0
    valid = np.ones((n, COST_SLOTS), bool)
    valid[-1] = False
    cost = np.where(realized_n > 0, PIECE_MB / y[:COST_ROWS].reshape(
        n, COST_SLOTS), -1.0).astype(np.float32)
    return ColumnarCorpus(X[:COST_ROWS].reshape(n, COST_SLOTS, -1), valid,
                          realized_n, cost)


def run_train_cost(torch, X, y, counts):
    """The cost model on the stand-in corpus (``cost_examples_from_corpus``'s
    mask path, then ``train_cost`` at ``CostTrainConfig``'s defaults) with
    every launch count set to 0 just before and read just after — no
    kernel may launch — a finite, falling loss and a correlation of
    predicted with realized cost above COST_CORR_MIN through the loaded
    ``cost`` artifact. Returns (artifact, cost scorer, launches)."""
    from dragonfly2_tpu_torch.inference.sidecar import (
        _cost_scorer_from_artifact,
    )
    from dragonfly2_tpu_torch.train.cost_trainer import (
        MODEL_TYPE_COST,
        cost_examples_from_corpus,
        cost_tree,
        train_cost,
    )

    corpus = cost_corpus(X, y)
    cx, cy = cost_examples_from_corpus(corpus)
    counts.reset()
    t0 = time.perf_counter()
    result = train_cost(cx, cy)
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    launches = counts.read()
    if any(launches.values()):
        raise AssertionError(f"train_cost launched kernels: {launches}")
    early, late = falling(result.step_losses)
    artifact = mlp_artifact(cost_tree(result), MODEL_TYPE_COST,
                            result.config.hidden,
                            {"mse": result.mse, "mae": result.mae})
    scorer = _cost_scorer_from_artifact(artifact, version="smoke")
    pred = np.concatenate([scorer.predict_cost_s(cx[i:i + 64])
                           for i in range(0, len(cx), 64)])
    corr = float(np.corrcoef(pred, cy)[0, 1])
    if not corr > COST_CORR_MIN:
        raise AssertionError(f"train_cost: corr {corr} <= {COST_CORR_MIN}")
    log("train_cost", seconds=train_s, examples=len(cx),
        slots=int(corpus.valid.size), steps=len(result.step_losses),
        launches=launches, loss_first=result.step_losses[0],
        loss_early=early, loss_late=late, history=result.history,
        samples_per_sec=result.samples_per_sec, eval_mse_s2=result.mse,
        eval_mae_s=result.mae, corr=corr, corr_min=COST_CORR_MIN,
        corr_ceiling=COST_CORR_CEILING,
        typical_cost_s=scorer.typical_cost_s)
    return artifact, scorer, launches


def check_cost_evaluator(torch, artifact, scorer) -> None:
    """``new_evaluator("cost")`` over the trained cost scorer: orders by
    ascending predicted cost; ``is_bad_node`` verdicts on seeded peers
    equal a CPU copy's of the artifact; a verdict's miss (a one-row
    device round trip) and cache hit in µs; a NaN-weighted artifact
    gives the rule evaluator's orders and verdicts, a guard trip each."""
    from dragonfly2_tpu_torch.inference.sidecar import (
        _cost_scorer_from_artifact,
    )
    from dragonfly2_tpu_torch.scheduler.controlstats import ControlPlaneStats
    from dragonfly2_tpu_torch.scheduler.evaluator import (
        BaseEvaluator,
        new_evaluator,
    )
    from dragonfly2_tpu_torch.scheduler.evaluator.base import (
        _BAD_STATES,
        MIN_AVAILABLE_COST_LEN,
        build_feature_matrix,
    )
    from dragonfly2_tpu_torch.train.checkpoint import load_artifact

    decisions = seeded_decisions(SEED + 10, ML_DECISIONS, ML_CANDIDATES)
    card = new_evaluator("cost", scorer=scorer, stats=ControlPlaneStats())
    for parents, child, total in decisions:
        got = card.evaluate_parents(parents, child, total)
        cost = dict(zip((p.id for p in parents), scorer.predict_cost_s(
            build_feature_matrix(parents, child, total))))
        ranked = [cost[p.id] for p in got]
        if any(a > b for a, b in zip(ranked, ranked[1:])):
            raise AssertionError(f"cost evaluator order not ascending in "
                                 f"predicted cost: {ranked}")
    cpu_scorer = _cost_scorer_from_artifact(artifact, device="cpu")
    cpu = new_evaluator("cost", scorer=cpu_scorer, stats=ControlPlaneStats())
    # The peers the model judges (the others are bad by state, or too new).
    peers = [p for parents, _, _ in decisions for p in parents
             if p.state() not in _BAD_STATES
             and len(p.costs) >= MIN_AVAILABLE_COST_LEN]
    t0 = time.perf_counter()
    got = [card.is_bad_node(p) for p in peers]
    miss_us = (time.perf_counter() - t0) / len(peers) * 1e6
    t0 = time.perf_counter()
    hits = [card.is_bad_node(p) for p in peers]
    hit_us = (time.perf_counter() - t0) / len(peers) * 1e6
    want = [cpu.is_bad_node(p) for p in peers]
    differ = [p.id for p, a, b in zip(peers, got, want) if a != b]
    if differ or hits != got:
        raise AssertionError(f"cost is_bad_node: card vs CPU differ on "
                             f"{differ}; cache hits equal: {hits == got}")
    tree, metadata = load_artifact(artifact)
    stats = ControlPlaneStats()
    nan_ev = new_evaluator("cost", scorer=_cost_scorer_from_artifact(
        mlp_artifact(poisoned(tree, "nan"), "cost",
                     metadata.config["hidden"])), stats=stats)
    rule = BaseEvaluator()
    orders = sum(nan_ev.evaluate_parents(p, c, t) == rule.evaluate_parents(
        p, c, t) for p, c, t in decisions)
    verdicts = sum(nan_ev.is_bad_node(p) == rule.is_bad_node(p)
                   for p in peers)
    if not (orders == ML_DECISIONS and verdicts == len(peers)
            and stats.cost_guard_trips == ML_DECISIONS + len(peers)
            and stats.cost_fallbacks == ML_DECISIONS):
        raise AssertionError(f"cost evaluator on a NaN artifact: {orders} "
                             f"rule orders, {verdicts} rule verdicts, "
                             f"{stats.snapshot()}")
    log("cost_evaluator", decisions=ML_DECISIONS, peers=len(peers),
        bad=int(sum(got)), verdicts_equal_cpu=len(peers), miss_us=miss_us,
        hit_us=hit_us,
        nan_artifact={"rule_orders": orders, "rule_verdicts": verdicts,
                      "stats": stats.snapshot()})


def column_equal(a, b) -> bool:
    """Numeric columns bit for bit; string columns string for string (a
    packed column's width is its longest string's)."""
    if a.dtype.kind == "U" and b.dtype.kind == "U":
        return a.shape == b.shape and bool(np.array_equal(a, b))
    return a.dtype == b.dtype and a.shape == b.shape and \
        np.ascontiguousarray(a).tobytes() == np.ascontiguousarray(b).tobytes()


def run_replay_store(torch, root: str):
    """replay_store: ``synth_replay_corpus(REPLAY_DECISIONS)`` through
    ``ReplayStoreWriter`` into rotated ``.npc`` segments, read back with
    ``open_dir``: ``check_corpus`` green on every segment, every column
    equal to the corpus in memory (``column_equal``); a segment with its
    tail marker cut off and one with its first byte flipped must each make
    ``open_corpus`` raise ``ReplayStoreError`` and ``check_corpus``
    report the file invalid (without raising). Returns the opened
    corpus."""
    from dragonfly2_tpu_torch.scheduler import replaystore
    from dragonfly2_tpu_torch.scheduler.replaybench import synth_replay_corpus

    t0 = time.perf_counter()
    corpus = synth_replay_corpus(REPLAY_DECISIONS, seed=SEED)
    synth_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    events = corpus.to_events()
    events_s = time.perf_counter() - t0
    store = os.path.join(root, "store")
    t0 = time.perf_counter()
    writer = replaystore.ReplayStoreWriter(store,
                                           segment_decisions=REPLAY_SEGMENT)
    for start in range(0, len(events), REPLAY_SEGMENT):
        writer.append_batch(events[start:start + REPLAY_SEGMENT])
    writer.close()
    pack_s = time.perf_counter() - t0
    del events
    segments = writer.segments()
    t0 = time.perf_counter()
    opened = replaystore.open_dir(store)
    open_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    reports = [replaystore.check_corpus(p) for p in segments]
    check_s = time.perf_counter() - t0
    differ = [name for name in replaystore.ALL_COLUMNS
              if not column_equal(getattr(opened, name),
                                getattr(corpus, name))]
    with open(segments[0], "rb") as f:
        data = f.read()
    broken = {}
    for kind, body in (("tail_cut", data[:-len(replaystore.TAIL_MAGIC)]),
                       ("first_byte_flipped",
                        bytes([data[0] ^ 0xFF]) + data[1:])):
        path = os.path.join(root, f"{kind}.npc")
        with open(path, "wb") as f:
            f.write(body)
        try:
            replaystore.open_corpus(path)
            raised = None
        except replaystore.ReplayStoreError as exc:
            raised = str(exc)
        report = replaystore.check_corpus(path)
        broken[kind] = {"open_raised": raised, "check_ok": report["ok"],
                        "check_errors": report["errors"]}
    seg_bytes = sum(os.path.getsize(p) for p in segments)
    ok = (len(segments) >= 3 and all(r["ok"] for r in reports)
          and sum(r["decisions"] for r in reports) == REPLAY_DECISIONS
          and not differ and opened.n == REPLAY_DECISIONS
          and all(b["open_raised"] and b["check_ok"] is False
                  and b["check_errors"] for b in broken.values()))
    fields = dict(
        decisions=opened.n, k=opened.k, segments=len(segments),
        candidates=int(opened.valid.sum()),
        features_mb=opened.features.nbytes / 1e6, segment_mb=seg_bytes / 1e6,
        columns_differing=differ, checks_ok=[r["ok"] for r in reports],
        broken=broken, synth_seconds=synth_s, to_events_seconds=events_s,
        pack_seconds=pack_s, pack_mb_per_sec=seg_bytes / 1e6 / pack_s,
        open_seconds=open_s, check_seconds=check_s)
    if not ok:
        raise AssertionError(f"replay_store: {fields}")
    log("replay_store", **fields)
    return opened


def bf16_limit(a: float, b: float) -> float:
    """The bf16 parity tolerance (``tests/test_torch_evaluator.py``: rtol
    and atol 6e-2) for two scores: ML_ORDER_GAP · (1 + the larger
    magnitude). The ml_evaluator phase's scores are of order 1, where
    this is ML_ORDER_GAP itself."""
    return ML_ORDER_GAP * (1.0 + max(abs(a), abs(b)))


def replay_swaps(cc, got, want, score_rows) -> dict:
    """Between two runs over ``cc``: the decisions whose orders differ,
    and the swapped pair (two candidates ordered oppositely) whose gap in
    ``score_rows`` scores is the largest share of ``bf16_limit`` — its
    scores, gap and share (the order check fails from share 1)."""
    seqs = cc.seq.tolist()
    differ = [i for i, seq in enumerate(seqs)
              if got.full_order.get(seq) != want.full_order.get(seq)]
    worst = {"share": 0.0, "gap": 0.0, "scores": None}
    if not differ:
        return dict(worst, differing=0)
    counts = cc.n_candidates[differ]
    rows = np.concatenate([cc.features[i, :n] for i, n in
                           zip(differ, counts.tolist())])
    scores = np.split(score_rows(rows).astype(np.float64),
                      np.cumsum(counts)[:-1])
    for i, row in zip(differ, scores):
        slot = {cid: j for j, cid in
                enumerate(cc.cand_id[i, :len(row)].tolist())}
        a, b = got.full_order[seqs[i]], want.full_order[seqs[i]]
        pos = {cid: j for j, cid in enumerate(a)}
        for x, c1 in enumerate(b):
            for c2 in b[x + 1:]:
                if pos[c1] > pos[c2]:
                    s1, s2 = float(row[slot[c1]]), float(row[slot[c2]])
                    share = abs(s1 - s2) / bf16_limit(s1, s2)
                    if share > worst["share"]:
                        worst = {"share": share, "gap": abs(s1 - s2),
                                 "scores": [s1, s2]}
    return dict(worst, differing=len(differ))


def run_replay_vectorized(torch, cc, mlp_artifact_bytes, cost_artifact,
                          counts) -> dict:
    """replay_vectorized: the opened corpus through
    ``replay_decisions_vectorized`` for the rule evaluator,
    ``new_evaluator("ml")`` over the trained config #1 MLP and ``cost``
    over the trained cost model, both loaded onto the card through the
    sidecar's artifact loaders (scoring through ``score_corpus`` there),
    with every launch count set to 0 just before and read just after —
    no kernel may launch. Per evaluator: the digest at 1 and at
    REPLAY_SHARDS shards (REPLAY_WORKERS prefetch workers) equal; on the
    first REPLAY_SEQ_DECISIONS decisions the sequential harness's
    digest, orders and guard counters equal the vectorized run's, and
    ``score_run`` equals
    ``score_run_vectorized`` key by key, and the ``ml`` and ``cost``
    scores are within MLP_TOL · (1 + |score|) of an f32 CPU copy of the
    artifact's; the ``ml`` and ``cost`` orders over the whole corpus
    equal the f32 CPU copy's except between candidates whose card scores
    are under ``bf16_limit`` apart. A NaN-weighted ``ml`` artifact must
    replay the rule evaluator's digest with a fallback and a guard trip
    on every ``parents`` decision of the first REPLAY_SEQ_DECISIONS.
    Returns the launches."""
    from dragonfly2_tpu_torch.inference.scorer import CostScorer
    from dragonfly2_tpu_torch.inference.sidecar import (
        _cost_scorer_from_artifact,
        _scorer_from_artifact,
    )
    from dragonfly2_tpu_torch.models.mlp import FEATURE_DIM
    from dragonfly2_tpu_torch.scheduler import replay
    from dragonfly2_tpu_torch.scheduler.controlstats import ControlPlaneStats
    from dragonfly2_tpu_torch.scheduler.evaluator import (
        BaseEvaluator,
        new_evaluator,
    )
    from dragonfly2_tpu_torch.train.checkpoint import load_artifact
    from dragonfly2_tpu_torch.utils.servingstats import ServingStats

    t_phase = time.perf_counter()
    ml_scorer = _scorer_from_artifact(mlp_artifact_bytes)
    cost_scorer = _cost_scorer_from_artifact(cost_artifact, version="smoke")
    # The f32 CPU copies score every valid row in one forward.
    valid_rows = int(cc.valid.sum())
    cpu_ml = f32_cpu_scorer(torch, mlp_artifact_bytes, max_batch=valid_rows)
    cpu_cost = CostScorer(f32_cpu_scorer(torch, cost_artifact,
                                         max_batch=valid_rows),
                          typical_cost_s=cost_scorer.typical_cost_s)
    makers = {
        "rule": lambda: BaseEvaluator(),
        "ml": lambda: new_evaluator("ml", scorer=ml_scorer,
                                    stats=ServingStats()),
        "cost": lambda: new_evaluator("cost", scorer=cost_scorer,
                                      stats=ControlPlaneStats()),
    }
    cpu_makers = {
        "ml": lambda: new_evaluator("ml", scorer=cpu_ml, stats=ServingStats()),
        "cost": lambda: new_evaluator("cost", scorer=cpu_cost,
                                      stats=ControlPlaneStats()),
    }
    parents = int(((cc.verdict == 0) & (cc.n_candidates > 0)).sum())
    head = cc.slice(0, REPLAY_SEQ_DECISIONS)
    head_events = list(head.decisions())
    verdicts = replay.rule_bad_node_verdicts(head)
    results, failures, runs = {}, [], {}
    counts.reset()
    for name, make in makers.items():
        ev = make()
        t0 = time.perf_counter()
        whole = replay.replay_decisions_vectorized(cc, ev, name=name)
        torch.cuda.synchronize()
        vec_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        sharded = replay.replay_decisions_vectorized(
            cc, make(), name=name, shards=REPLAY_SHARDS,
            prefetch_workers=REPLAY_WORKERS)
        torch.cuda.synchronize()
        sharded_s = time.perf_counter() - t0
        seq_ev, vec_ev = make(), make()
        t0 = time.perf_counter()
        seq = replay.replay_decisions(head_events, seq_ev, name=name)
        seq_s = time.perf_counter() - t0
        part = replay.replay_decisions_vectorized(head, vec_ev, name=name)
        scored_seq = replay.score_run(
            head_events, seq, evaluator=None if name == "cost" else seq_ev)
        scored_vec = replay.score_run_vectorized(
            head, seq, bad_node_verdicts=None if name == "cost" else verdicts)
        keys_differing = sorted(k for k in scored_seq
                                if scored_vec.get(k) != scored_seq[k])
        counters = {}
        if name != "rule":
            counters = {
                "whole": [ev.scored_count, ev.fallback_count,
                          ev.guard_trips],
                "head_sequential": [seq_ev.scored_count,
                                    seq_ev.fallback_count,
                                    seq_ev.guard_trips],
                "head_vectorized": [vec_ev.scored_count,
                                    vec_ev.fallback_count,
                                    vec_ev.guard_trips]}
            if (counters["head_sequential"] != counters["head_vectorized"]
                    or ev.scored_count + ev.fallback_count != parents):
                failures.append(f"{name} guard counters {counters}")
        if whole.digest != sharded.digest:
            failures.append(f"{name}: shards 1 and {REPLAY_SHARDS} digests "
                            "differ")
        if seq.digest != part.digest or seq.full_order != part.full_order:
            failures.append(f"{name}: sequential and vectorized digests "
                            f"differ on {REPLAY_SEQ_DECISIONS} decisions")
        if keys_differing:
            failures.append(f"{name}: score_run vs score_run_vectorized "
                            f"differ in {keys_differing}")
        runs[name] = whole
        results[name] = dict(
            digest=whole.digest, shards_digest_equal=whole.digest
            == sharded.digest, head_digest_equal=seq.digest == part.digest,
            score_run_keys_equal=not keys_differing,
            regret_mean_s=scored_vec["regret_mean_s"],
            rank_agreement_mean=scored_vec["rank_agreement_mean"],
            bad_node_precision=scored_vec.get("bad_node_precision"),
            bad_node_recall=scored_vec.get("bad_node_recall"),
            counters=counters, vectorized_seconds=vec_s,
            sharded_seconds=sharded_s, sequential_seconds=seq_s,
            sequential_decisions_per_s=REPLAY_SEQ_DECISIONS / seq_s,
            vectorized_decisions_per_s=cc.n / vec_s,
            sharded_decisions_per_s=cc.n / sharded_s)
    # Against the f32 CPU copies: the same engine, the same corpus.
    card_rows = {"ml": ml_scorer.score_corpus,
                 "cost": cost_scorer.score_corpus}
    cpu_rows = {"ml": cpu_ml.score_corpus, "cost": cpu_cost.score_corpus}
    head_rows = head.features[head.valid]
    for name, make in cpu_makers.items():
        t0 = time.perf_counter()
        cpu_run = replay.replay_decisions_vectorized(cc, make(), name=name)
        cpu_s = time.perf_counter() - t0
        swaps = replay_swaps(cc, runs[name], cpu_run, card_rows[name])
        card = card_rows[name](head_rows).astype(np.float64)
        cpu = cpu_rows[name](head_rows).astype(np.float64)
        err = np.abs(card - cpu)
        share = float((err / (MLP_TOL * (1.0 + np.abs(cpu)))).max())
        results[name].update(
            orders_differing_from_f32_cpu=swaps["differing"],
            worst_swap=swaps, head_max_abs_err_vs_f32_cpu=float(err.max()),
            head_max_err_share_of_tol=share, f32_cpu_seconds=cpu_s)
        if not swaps["share"] < 1.0:
            failures.append(f"{name}: candidates ordered unlike the f32 CPU "
                            f"copy {swaps} (limit bf16_limit)")
        if not share <= 1.0:
            failures.append(f"{name}: scores on the first "
                            f"{REPLAY_SEQ_DECISIONS} decisions off the f32 "
                            f"CPU copy's by {share} of MLP_TOL (1 + |s|)")
    # A NaN-weighted ml artifact replays the rule evaluator's decisions
    # (on the first REPLAY_SEQ_DECISIONS: the guard path, not the scale).
    tree, metadata = load_artifact(mlp_artifact_bytes)
    nan_ev = new_evaluator("ml", scorer=_scorer_from_artifact(mlp_artifact(
        poisoned(tree, "nan"), "mlp", metadata.config["hidden"])),
        stats=ServingStats())
    nan_run = replay.replay_decisions_vectorized(head, nan_ev, name="ml-nan")
    rule_head = replay.replay_decisions_vectorized(head, BaseEvaluator())
    torch.cuda.synchronize()
    launches = counts.read()
    head_parents = int(((head.verdict == 0) & (head.n_candidates > 0)).sum())
    nan_result = dict(decisions=head.n,
                      digest_equal_rule=nan_run.digest == rule_head.digest,
                      fallback_count=nan_ev.fallback_count,
                      guard_trips=nan_ev.guard_trips,
                      scored_count=nan_ev.scored_count, parents=head_parents)
    if not (nan_result["digest_equal_rule"] and nan_ev.fallback_count
            == nan_ev.guard_trips == head_parents
            and nan_ev.scored_count == 0):
        failures.append(f"NaN ml artifact: {nan_result}")
    if any(launches.values()):
        failures.append(f"the replay path launched kernels: {launches}")
    block = ml_scorer.max_batch
    device_bytes = -(-valid_rows // block) * block * FEATURE_DIM * 4 \
        + valid_rows * 4
    fields = dict(decisions=cc.n, parents=parents, candidates=valid_rows,
                  shards=REPLAY_SHARDS, shard_workers=REPLAY_WORKERS,
                  evaluators=results, nan_ml=nan_result, launches=launches,
                  corpus_device_bytes_per_pass=device_bytes,
                  score_block=block,
                  seconds=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError(f"replay_vectorized: {failures}; {fields}")
    log("replay_vectorized", **fields)
    return launches


def run_swarm_record(torch, root: str, mlp_artifact_bytes, cost_artifact,
                     counts) -> None:
    """swarm_record: a profiled RECORD_PEERS-peer swarm
    (``run_swarm_bench``, RECORD_WORKERS announce workers) through the
    port's ``SchedulerService`` with a ``ReplayRecorder`` into a rotating
    scheduler ``Storage``, read back from disk (``corpus_from_storage``):
    no swarm error, every decision recorded and finalized, a corpus of at
    least ``MIN_CORPUS_DECISIONS``. That corpus packed with
    ``ReplayStoreWriter`` and opened (``open_dir``) must hold the columns
    ``as_columnar`` builds from the events, and replay through
    ``replay_decisions_vectorized`` for the rule, ``ml`` (the trained
    config #1 MLP) and ``cost`` (the trained cost model) evaluators on
    the card with the digest ``replay_decisions`` gives on the events,
    with every launch count set to 0 just before and read just after —
    no kernel may launch."""
    from dragonfly2_tpu_torch.inference.sidecar import (
        _cost_scorer_from_artifact,
        _scorer_from_artifact,
    )
    from dragonfly2_tpu_torch.scheduler import replay, replaystore
    from dragonfly2_tpu_torch.scheduler.controlstats import ControlPlaneStats
    from dragonfly2_tpu_torch.scheduler.evaluator import (
        BaseEvaluator,
        new_evaluator,
    )
    from dragonfly2_tpu_torch.scheduler.loadbench import run_swarm_bench
    from dragonfly2_tpu_torch.scheduler.replaybench import (
        MIN_CORPUS_DECISIONS,
    )
    from dragonfly2_tpu_torch.scheduler.replaylog import ReplayRecorder
    from dragonfly2_tpu_torch.scheduler.storage.storage import (
        Storage,
        StorageConfig,
    )
    from dragonfly2_tpu_torch.utils.servingstats import ServingStats

    t_phase = time.perf_counter()
    storage = Storage(os.path.join(root, "sched"),
                      StorageConfig(max_size=256 * 1024, buffer_size=25))
    recorder = ReplayRecorder(storage)
    rung = run_swarm_bench(RECORD_PEERS, workers=RECORD_WORKERS,
                           recorder=recorder, cost_profile="profiled",
                           profile_seed=SEED)
    recorder.close()
    t0 = time.perf_counter()
    corpus = replay.corpus_from_storage(storage)
    read_s = time.perf_counter() - t0
    failures = []
    if rung["errors"]:
        failures.append(f"swarm errors {rung['errors']}")
    if len(corpus) < MIN_CORPUS_DECISIONS:
        failures.append(f"corpus {len(corpus)} < {MIN_CORPUS_DECISIONS}")
    if not (rung["replay_decisions"] == rung["replay_finalized"]
            == rung["decisions"] + rung["back_to_source"] == len(corpus)):
        failures.append("decisions recorded, finalized and read back differ")
    store = os.path.join(root, "store")
    t0 = time.perf_counter()
    writer = replaystore.ReplayStoreWriter(store,
                                           segment_decisions=RECORD_SEGMENT)
    for start in range(0, len(corpus), RECORD_SEGMENT):
        writer.append_batch(corpus[start:start + RECORD_SEGMENT])
    writer.close()
    opened = replaystore.open_dir(store)
    pack_s = time.perf_counter() - t0
    built = replay.as_columnar(corpus)
    differ = [name for name in replaystore.ALL_COLUMNS
              if not column_equal(getattr(opened, name),
                                getattr(built, name))]
    if differ or opened.n != len(corpus):
        failures.append(f"packed columns differ: {differ}")
    ml_scorer = _scorer_from_artifact(mlp_artifact_bytes)
    cost_scorer = _cost_scorer_from_artifact(cost_artifact, version="smoke")
    makers = {
        "rule": lambda: BaseEvaluator(),
        "ml": lambda: new_evaluator("ml", scorer=ml_scorer,
                                    stats=ServingStats()),
        "cost": lambda: new_evaluator("cost", scorer=cost_scorer,
                                      stats=ControlPlaneStats()),
    }
    replays = {}
    counts.reset()
    for name, make in makers.items():
        t0 = time.perf_counter()
        seq = replay.replay_decisions(corpus, make(), name=name)
        seq_s = time.perf_counter() - t0
        t0 = time.perf_counter()
        vec = replay.replay_decisions_vectorized(opened, make(), name=name)
        torch.cuda.synchronize()
        vec_s = time.perf_counter() - t0
        scored = replay.score_run_vectorized(opened, vec)
        replays[name] = dict(
            digest=vec.digest, digest_equal_sequential=vec.digest
            == seq.digest, sequential_seconds=seq_s,
            vectorized_seconds=vec_s, regret_mean_s=scored["regret_mean_s"],
            rank_agreement_mean=scored["rank_agreement_mean"])
        if vec.digest != seq.digest:
            failures.append(f"{name}: vectorized digest differs from the "
                            "sequential one")
    launches = counts.read()
    if any(launches.values()):
        failures.append(f"the recorded replays launched kernels: {launches}")
    if len({r["digest"] for r in replays.values()}) != len(replays):
        failures.append("two evaluators replayed the same decisions")
    fields = dict(
        peers=rung["peers"], workers=rung["workers"], tasks=rung["tasks"],
        decisions=rung["decisions"], back_to_source=rung["back_to_source"],
        replay_decisions=rung["replay_decisions"],
        replay_finalized=rung["replay_finalized"],
        replay_evicted=rung["replay_evicted"], dropped=recorder.dropped,
        replay_appends_batched=rung["replay_appends_batched"],
        replay_files=len(storage.replay.all_files()),
        corpus_decisions=len(corpus), corpus_k=opened.k,
        candidates=int(opened.valid.sum()),
        segments=len(writer.segments()),
        announce_p50_ms=rung["announce_p50_ms"],
        announce_p99_ms=rung["announce_p99_ms"],
        decisions_per_sec=rung["decisions_per_sec"],
        swarm_seconds=rung["seconds"], read_seconds=read_s,
        pack_seconds=pack_s, replays=replays, launches=launches,
        errors=rung["errors"], seconds=time.perf_counter() - t_phase)
    if failures:
        raise AssertionError(f"swarm_record: {failures}; {fields}")
    log("swarm_record", **fields)


def run_replay_ab_phase(torch, counts) -> dict:
    """replay_ab: ``run_replay_ab(seed=SEED, record_peers=RECORD_PEERS)``
    on the card (record → train → gate → rule vs ``ml`` vs ``cost``) with
    every launch count set to 0 just before and read just after — no
    kernel may launch. It must hold the JAX package's verdict but for
    the recorder-overhead bound (the recorder_overhead phase prints it):
    no error, deterministic replays, both gates ``active``, ``ml`` and
    ``cost`` regret within bound, no swarm error. Returns the launches."""
    from dragonfly2_tpu_torch.scheduler.replaybench import run_replay_ab

    counts.reset()
    t0 = time.perf_counter()
    report = run_replay_ab(seed=SEED, record_peers=RECORD_PEERS,
                           workers=RECORD_WORKERS, overhead_guard=False)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches = counts.read()
    ab = report.get("ab") or {}
    gate = report.get("gate") or {}
    failures = []
    if report.get("error"):
        failures.append(f"error {report['error']}")
    if not ab.get("deterministic"):
        failures.append("replays not deterministic")
    if {n: g.get("state") for n, g in gate.items()} != {
            "cost": "active", "mlp": "active"}:
        failures.append("a gate did not promote")
    if report.get("regret_within_bound") != {"ml": True, "cost": True}:
        failures.append("learned regret over its bound")
    if (report.get("record") or {}).get("errors", ["missing"]):
        failures.append("swarm errors")
    if any(launches.values()):
        failures.append(f"the replay_ab path launched kernels: {launches}")
    evaluators = {
        name: {key: scored.get(key) for key in (
            "regret_mean_s", "regret_p99_s", "regret_delta_vs_baseline_s",
            "rank_agreement_mean", "bad_node_labeled", "bad_node_tp",
            "bad_node_fp", "bad_node_fn", "bad_node_tn",
            "bad_node_precision", "bad_node_recall",
            "decision_latency_p50_ms", "decision_latency_p99_ms",
            "deterministic", "digest")}
        for name, scored in (ab.get("evaluators") or {}).items()}
    fields = dict(
        record=report.get("record"), train=report.get("train"),
        gate={name: {"state": g.get("state"), "validation": {
            key: (g.get("validation") or {}).get(key) for key in (
                "passed", "rank_correlation", "max_batch_latency_s",
                "batches", "scored_rows", "trace_source", "reasons")}}
            for name, g in gate.items()},
        evaluators=evaluators, deterministic=ab.get("deterministic"),
        regret_within_bound=report.get("regret_within_bound"),
        regret_bounds=report.get("regret_bounds"),
        verdict_pass_without_overhead=report.get("verdict_pass"),
        launches=launches, phase_seconds=report.get("seconds"),
        seconds=seconds, error=report.get("error"))
    if failures:
        raise AssertionError(f"replay_ab: {failures}; {fields}")
    log("replay_ab", **fields)
    return launches


def run_swarm_ladder_phase() -> None:
    """swarm_ladder: ``run_swarm_ladder(SWARM_LADDER_SIZES,
    workers=SWARM_LADDER_WORKERS)`` — no rung may report a swarm error;
    the largest rung's announce p99 over the smallest's is printed with
    the 4 x bound's verdict, which decides nothing here (a limit on the
    host's speed, set on another machine)."""
    from dragonfly2_tpu_torch.scheduler.loadbench import run_swarm_ladder

    t0 = time.perf_counter()
    out = run_swarm_ladder(SWARM_LADDER_SIZES, workers=SWARM_LADDER_WORKERS)
    rungs = {size: {key: rung[key] for key in (
        "peers", "tasks", "peers_per_task", "workers", "seconds",
        "announce_p50_ms", "announce_p99_ms", "decisions",
        "decisions_per_sec", "piece_reports_per_sec", "back_to_source",
        "filter_ms_p99", "evaluate_ms_p99", "gc_ticks",
        "gc_budget_overruns", "gc_reclaimed", "gc_pause_p50_ms",
        "gc_pause_p99_ms", "bytes_per_peer", "errors")}
        for size, rung in out["ladder"].items()}
    errors = {size: r["errors"] for size, r in rungs.items() if r["errors"]}
    fields = dict(rungs=rungs, decision_p99_ratio=out["decision_p99_ratio"],
                  ladder_p99_bound=out["ladder_p99_bound"],
                  p99_within_bound=out["p99_within_bound"],
                  bound_decides_exit=False,
                  seconds=time.perf_counter() - t0)
    if errors:
        raise AssertionError(f"swarm_ladder: swarm errors {errors}; {fields}")
    log("swarm_ladder", **fields)


def run_recorder_overhead_phase() -> None:
    """recorder_overhead: ``run_recorder_overhead_guard()`` — announce p99
    with the recorder on against off, best of the interleaved
    repetitions, and its retry; printed with the 1.05 x bound's verdict,
    which decides nothing here (a limit on the host's speed)."""
    from dragonfly2_tpu_torch.scheduler.loadbench import (
        run_recorder_overhead_guard,
    )

    t0 = time.perf_counter()
    guard = run_recorder_overhead_guard()
    log("recorder_overhead", **guard, bound_decides_exit=False,
        seconds=time.perf_counter() - t0)


class HealthLog:
    """Forwards ``set_status`` to a ``HealthService`` and keeps each
    transition (seconds since creation, status)."""

    def __init__(self, health):
        self.health = health
        self.t0 = time.perf_counter()
        self.transitions = []

    def set_status(self, service: str, status: str) -> None:
        self.transitions.append(
            (round(time.perf_counter() - self.t0, 3), status))
        self.health.set_status(service, status)


class LoadThread:
    """A thread sending ModelInfer requests back to back (one of
    ``requests`` after another) until ``stop``; keeps each reply's
    latency (ms, with its end time), version, and failures by status."""

    def __init__(self, service, name: str, requests):
        import threading

        from dragonfly2_tpu_torch.inference.sidecar import (
            CallContext,
            ModelInferRequest,
            RpcAbort,
        )

        self._stop = threading.Event()
        self.samples = []          # (end time, ms, version)
        self.failures = {}

        def run():
            ctx = CallContext()
            i = 0
            while not self._stop.is_set():
                request = ModelInferRequest(name, requests[i % len(requests)])
                i += 1
                t0 = time.perf_counter()
                try:
                    resp = service.ModelInfer(request, ctx)
                except RpcAbort as exc:
                    self.failures[exc.code.name] = self.failures.get(
                        exc.code.name, 0) + 1
                    continue
                t1 = time.perf_counter()
                self.samples.append((t1, (t1 - t0) * 1e3,
                                     resp.model_version))

        self._thread = threading.Thread(target=run, name=f"load-{name}",
                                        daemon=True)
        self._thread.start()

    def stop(self) -> None:
        self._stop.set()
        self._thread.join(timeout=30)
        if self._thread.is_alive():
            raise AssertionError("load thread did not stop")

    def window(self, t_from: float, t_to: float | None = None) -> dict:
        """p50/p99 ms and count of the replies that ended in the window."""
        ms = sorted(m for t, m, _ in list(self.samples)
                    if t >= t_from and (t_to is None or t <= t_to))
        if not ms:
            return {"replies": 0}
        return {"replies": len(ms), "p50_ms": ms[len(ms) // 2],
                "p99_ms": ms[min(int(len(ms) * 0.99), len(ms) - 1)]}


def wait_until(what: str, predicate, timeout_s: float = 60.0) -> float:
    """Poll ``predicate`` until true; seconds waited. Fails on timeout."""
    t0 = time.perf_counter()
    while not predicate():
        if time.perf_counter() - t0 > timeout_s:
            raise AssertionError(f"timed out waiting for {what}")
        time.sleep(0.02)
    return time.perf_counter() - t0


def concurrent_identity(service, name: str, scorer, requests,
                        threads: int) -> dict:
    """``threads`` threads send their share of ``requests`` through
    ``service.ModelInfer`` at once; every reply, whatever it was coalesced
    with and whichever lane served it, is held against ``scorer.score``
    of the same rows alone. Returns the rows that differ."""
    import threading

    from dragonfly2_tpu_torch.inference.sidecar import (
        CallContext,
        ModelInferRequest,
    )

    replies = [None] * len(requests)
    errors = []
    barrier = threading.Barrier(threads)

    def run(tid: int) -> None:
        ctx = CallContext()
        barrier.wait()
        try:
            for i in range(tid, len(requests), threads):
                replies[i] = service.ModelInfer(
                    ModelInferRequest(name, requests[i]), ctx).outputs
        except Exception as exc:  # noqa: BLE001 — reported below
            errors.append(repr(exc))

    workers = [threading.Thread(target=run, args=(t,)) for t in range(threads)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=120)
    if errors or any(w.is_alive() for w in workers):
        raise AssertionError(f"{name} concurrent requests failed: {errors}")
    differ = sum(int((got != scorer.score(req)).sum())
                 for got, req in zip(replies, requests))
    return {"requests": len(requests), "rows": int(sum(
        len(r) for r in requests)), "rows_differing": differ}


def ladder(scorer, requests_for, threads_list, seconds: float,
           shed_fallback_s: float = 0.0005) -> list:
    """``measure_colocated`` rungs at the inference service's default
    knobs (2 lanes, queue depth 32, adaptive window 0.5 ms)."""
    from dragonfly2_tpu_torch.inference.loadgen import measure_colocated

    rungs = []
    for threads in threads_list:
        rung = measure_colocated(
            scorer, threads=threads, rows_per_request=REQUEST_ROWS,
            duration_s=seconds, adaptive_wait_s=0.0005, lanes=2,
            queue_depth=32, shed_fallback_s=shed_fallback_s,
            requests=requests_for(threads))
        rungs.append({k: rung[k] for k in (
            "threads", "p50_ms", "p99_ms", "requests_per_sec", "requests",
            "coalesce_factor", "dispatches", "inflight_depth_avg",
            "overlap_ratio", "sheds", "active_lanes", "max_queue_depth",
            "bucket_hits")})
    return rungs


def service_rung(service, name: str, requests, seconds: float,
                 shed_fallback_s: float = 0.0005) -> dict:
    """``len(requests)`` threads, each sending its request through
    ``service.ModelInfer`` back to back for ``seconds``: p50/p99 ms of
    the replies, replies a second, aborts by status code and the
    service's batcher counters (none when it serves unbatched). A thread
    whose request is shed (RESOURCE_EXHAUSTED) waits ``shed_fallback_s``
    before its next one, the rule scoring ``measure_colocated`` models."""
    import threading

    from dragonfly2_tpu_torch.inference.sidecar import (
        CallContext,
        ModelInferRequest,
        RpcAbort,
    )

    threads = len(requests)
    latencies = [[] for _ in range(threads)]
    aborts = [dict() for _ in range(threads)]
    stop = threading.Event()
    barrier = threading.Barrier(threads + 1)

    def run(tid: int) -> None:
        ctx = CallContext()
        request = ModelInferRequest(name, requests[tid])
        barrier.wait()
        while not stop.is_set():
            t0 = time.perf_counter()
            try:
                service.ModelInfer(request, ctx)
            except RpcAbort as exc:
                code = exc.code.name
                aborts[tid][code] = aborts[tid].get(code, 0) + 1
                if code == "RESOURCE_EXHAUSTED":
                    time.sleep(shed_fallback_s)
                continue
            latencies[tid].append((time.perf_counter() - t0) * 1e3)

    service.ModelInfer(ModelInferRequest(name, requests[0]), CallContext())
    workers = [threading.Thread(target=run, args=(t,), daemon=True)
               for t in range(threads)]
    for w in workers:
        w.start()
    barrier.wait()
    t0 = time.perf_counter()
    time.sleep(seconds)
    stop.set()
    for w in workers:
        w.join(timeout=30)
    wall = time.perf_counter() - t0
    if any(w.is_alive() for w in workers):
        raise AssertionError(f"{name}: a ModelInfer thread hung")
    ms = sorted(x for sub in latencies for x in sub)
    codes = {}
    for a in aborts:
        for code, n in a.items():
            codes[code] = codes.get(code, 0) + n
    batcher = service.batcher_stats().get(name)
    return {"threads": threads, "replies": len(ms),
            "p50_ms": ms[len(ms) // 2] if ms else None,
            "p99_ms": ms[min(int(len(ms) * 0.99), len(ms) - 1)]
            if ms else None,
            "replies_per_sec": len(ms) / wall, "aborts": codes,
            "batcher": None if batcher is None else {k: batcher[k] for k in (
                "dispatches", "coalesce_factor", "sheds", "active_lanes")}}


def run_microbatch_controls(scorer, requests_for) -> dict:
    """Controls beside the ladder, in one harness (``ModelInfer`` from N
    threads, :func:`service_rung`): the same scorer served unbatched
    (``micro_batch=False``), through one lane and through the default two
    at 8 and 32 threads, in turns; the 128-thread rung again with a shed
    costing 5 ms instead of 0.5; and a burst of 128 threads at queue
    depth 2, whose RESOURCE_EXHAUSTED aborts must equal the batcher's
    sheds and be more than 0."""
    from dragonfly2_tpu_torch.inference.sidecar import InferenceService

    variants = {"unbatched": dict(micro_batch=False),
                "lanes_1": dict(batch_lanes=1), "lanes_2": dict()}
    rungs = []
    for threads in SERVICE_CONTROL_THREADS:
        for variant, knobs in variants.items():
            service = InferenceService(**knobs)
            service.install_scorer("mlp", scorer, version=variant)
            try:
                rungs.append({"variant": variant, **service_rung(
                    service, "mlp", requests_for(threads), LADDER_S)})
            finally:
                service.stop()
    slow_shed = ladder(scorer, requests_for, (128,), LADDER_S,
                       shed_fallback_s=SLOW_SHED_S)[0]
    service = InferenceService(batch_queue_depth=2)
    service.install_scorer("mlp", scorer, version="depth-2")
    try:
        burst = service_rung(service, "mlp", requests_for(SHED_THREADS),
                             SHED_BURST_S)
    finally:
        service.stop()
    exhausted = burst["aborts"].get("RESOURCE_EXHAUSTED", 0)
    if not (exhausted == burst["batcher"]["sheds"] > 0
            and set(burst["aborts"]) == {"RESOURCE_EXHAUSTED"}):
        raise AssertionError(f"microbatch: ModelInfer burst at depth 2 "
                             f"{burst}")
    return {"service_rungs": rungs, "ladder_128_slow_shed": {
        "shed_fallback_s": SLOW_SHED_S, **slow_shed},
        "model_infer_burst": {"queue_depth": 2, **burst}}


def run_microbatch(torch, scorer, eval_x) -> None:
    """Config #1's trained MLP behind ``InferenceService(micro_batch=True)``
    at its defaults: the ladder and its controls
    (:func:`run_microbatch_controls`), bit identity of coalesced replies
    against solo scores under 32 threads (must be 0 rows), and
    ``/debug/vars``
    from a ``DebugMonitor`` carrying ``serving``, ``scheduler`` and the
    service's batcher stats with their ``per_lane`` block."""
    import urllib.request

    from dragonfly2_tpu_torch.inference.sidecar import InferenceService
    from dragonfly2_tpu_torch.utils.debugmon import (
        DebugMonitor,
        register_debug_var,
    )

    service = InferenceService(micro_batch=True)
    service.install_scorer("mlp", scorer, version="trained")
    rng = np.random.default_rng(SEED + 11)

    def requests_for(threads: int):
        return eval_x[rng.integers(0, len(eval_x), (threads, REQUEST_ROWS))]

    rungs = ladder(scorer, requests_for, MLP_LADDER_THREADS, LADDER_S)
    controls = run_microbatch_controls(scorer, requests_for)
    requests = [eval_x[rng.integers(0, len(eval_x), int(n))]
                for n in rng.integers(1, 17, IDENTITY_REQUESTS)]
    identity = concurrent_identity(service, "mlp", scorer, requests,
                                   IDENTITY_THREADS)
    stats = service.batcher_stats()["mlp"]
    if identity["rows_differing"]:
        raise AssertionError(f"microbatch: coalesced replies differ from "
                             f"solo scores: {identity}")
    register_debug_var("inference_batcher_stats", service.batcher_stats)
    monitor = DebugMonitor("127.0.0.1", 0)
    monitor.start()
    try:
        with urllib.request.urlopen(
                f"http://{monitor.address}/debug/vars", timeout=30) as resp:
            page = json.loads(resp.read())
    finally:
        monitor.stop()
        service.stop()
    blocks = {k: page.get(k) for k in ("serving", "scheduler",
                                       "inference_batcher_stats")}
    if not (all(isinstance(v, dict) for v in blocks.values())
            and "per_lane" in blocks["inference_batcher_stats"].get(
                "mlp", {})):
        raise AssertionError(f"debug_vars: blocks {sorted(page)}")
    log("microbatch", model="mlp", knobs={"lanes": 2, "queue_depth": 32,
                                          "adaptive_wait_s": 0.0005,
                                          "max_batch": scorer.max_batch},
        request_rows=REQUEST_ROWS, seconds_a_rung=LADDER_S, ladder=rungs,
        solo_p50_ms=p50_ms(lambda: scorer.score(requests[0]), n=200),
        identity=identity, identity_threads=IDENTITY_THREADS,
        controls=controls, service_batcher={k: stats[k] for k in (
            "dispatches", "coalesced_requests", "coalesce_factor",
            "active_lanes", "sheds")})
    log("debug_vars", address="127.0.0.1", keys=sorted(page),
        per_lane=blocks["inference_batcher_stats"]["mlp"]["per_lane"],
        serving=blocks["serving"], torch=page.get("torch"))


def run_microbatch_gat(torch, scorer) -> None:
    """Config #3's pair scorer behind the batcher: the 8- and 32-thread
    rungs and the bit identity of coalesced replies against solo scores
    (buckets 8 … 64 hold a pair's logit bit for bit on the card:
    tests/gat_bucket_stability.py, so it must be 0 rows)."""
    from dragonfly2_tpu_torch.inference.sidecar import InferenceService

    service = InferenceService(micro_batch=True)
    service.install_scorer("gat", scorer, version="gather")
    rng = np.random.default_rng(SEED + 12)
    rungs = ladder(scorer, lambda t: rng.integers(
        0, N_HOSTS, (t, REQUEST_ROWS, 2)).astype(np.int32),
        GAT_LADDER_THREADS, LADDER_S)
    requests = [rng.integers(0, N_HOSTS, (int(n), 2)).astype(np.int32)
                for n in rng.integers(1, 17, IDENTITY_REQUESTS)]
    identity = concurrent_identity(service, "gat", scorer, requests,
                                   IDENTITY_THREADS)
    service.stop()
    if identity["rows_differing"]:
        raise AssertionError(f"microbatch_gat: coalesced replies differ "
                             f"from solo scores: {identity}")
    log("microbatch_gat", model="gat", request_rows=REQUEST_ROWS,
        seconds_a_rung=LADDER_S, ladder=rungs, identity=identity,
        buckets=scorer.buckets, fix="none needed: buckets 8-64 are "
        "bit-identical (tests/gat_bucket_stability.py)")


def run_shed(torch, scorer) -> None:
    """``new_evaluator("ml", micro_batch=True, batch_lanes=2,
    batch_queue_depth=2)`` under SHED_THREADS threads of seeded
    15-candidate decisions: sheds happen and are counted alike by the
    evaluator and ``ml_sheds``, every shed decision is the rule
    evaluator's order and every other one the solo ML order, no request
    fails otherwise (no timeout), and ``close()`` drains every lane."""
    import threading

    from dragonfly2_tpu_torch.inference.batcher import BatcherSaturatedError
    from dragonfly2_tpu_torch.scheduler.evaluator import (
        BaseEvaluator,
        new_evaluator,
    )
    from dragonfly2_tpu_torch.utils.servingstats import ServingStats

    decisions = seeded_decisions(SEED + 13, SHED_DECISIONS, ML_CANDIDATES)
    rule = BaseEvaluator()
    solo = new_evaluator("ml", scorer=scorer, stats=ServingStats())
    want = [([p.id for p in solo.evaluate_parents(*d)],
             [p.id for p in rule.evaluate_parents(*d)]) for d in decisions]
    stats = ServingStats()
    evaluator = new_evaluator("ml", scorer=scorer, micro_batch=True,
                              batch_lanes=2, batch_queue_depth=2,
                              stats=stats)
    batcher = evaluator._scorer
    shed_local = threading.local()

    class Recording:
        """The batcher, recording whether this thread's last call shed."""

        def score(self, features):
            shed_local.shed = False
            try:
                return batcher.score(features)
            except BatcherSaturatedError:
                shed_local.shed = True
                raise

    evaluator._scorer = Recording()
    outcome = {"shed_rule": 0, "shed_not_rule": 0, "served_ml": 0,
               "served_not_ml": 0}
    lock = threading.Lock()
    barrier = threading.Barrier(SHED_THREADS)

    def run(tid: int) -> None:
        barrier.wait()
        for i in range(tid, len(decisions), SHED_THREADS):
            got = [p.id for p in evaluator.evaluate_parents(*decisions[i])]
            ml, by_rule = want[i]
            key = (("shed_rule" if got == by_rule else "shed_not_rule")
                   if shed_local.shed else
                   ("served_ml" if got == ml else "served_not_ml"))
            with lock:
                outcome[key] += 1

    t0 = time.perf_counter()
    workers = [threading.Thread(target=run, args=(t,))
               for t in range(SHED_THREADS)]
    for w in workers:
        w.start()
    for w in workers:
        w.join(timeout=120)
    seconds = time.perf_counter() - t0
    hung = sum(w.is_alive() for w in workers)
    batcher_stats = batcher.stats()
    evaluator._scorer = batcher
    evaluator.close()
    drained = not any(lane.worker.is_alive() or lane.queue.qsize()
                      for lane in batcher._lanes)
    counters = {"shed_count": evaluator.shed_count,
                "ml_sheds": stats.get("ml_sheds"),
                "fallback_count": evaluator.fallback_count,
                "ml_fallbacks": stats.get("ml_fallbacks"),
                "scored_count": evaluator.scored_count}
    log("shed", threads=SHED_THREADS, decisions=SHED_DECISIONS,
        candidates=ML_CANDIDATES, seconds=seconds, counters=counters,
        outcome=outcome, hung_threads=hung, lanes_drained=drained,
        batcher={k: batcher_stats[k] for k in (
            "dispatches", "coalesce_factor", "sheds", "shed_rate",
            "active_lanes", "max_queue_depth")})
    if not (counters["shed_count"] == counters["ml_sheds"] > 0
            and counters["fallback_count"] == counters["shed_count"]
            and outcome["shed_rule"] == counters["shed_count"]
            and outcome["shed_not_rule"] == outcome["served_not_ml"] == 0
            and outcome["served_ml"] == counters["scored_count"]
            and hung == 0 and drained):
        raise AssertionError(f"shed: {counters} {outcome} hung {hung} "
                             f"drained {drained}")


def device_bytes(torch) -> int:
    """Bytes the caching allocator holds for live tensors, after a
    collection and with cuBLAS's per-handle workspaces freed (each new
    thread's handle allocates one; they are not the models')."""
    import gc

    gc.collect()
    torch.cuda.synchronize()
    torch._C._cuda_clearCublasWorkspaces()
    return torch.cuda.memory_allocated()


def artifact_dir(root: str, tag: str, tree: dict, hidden) -> str:
    from dragonfly2_tpu_torch.train.checkpoint import ModelMetadata, save_model

    path = os.path.join(root, tag)
    save_model(path, tree, ModelMetadata(
        model_id=f"smoke-{tag}", model_type="mlp",
        config={"hidden": list(hidden)}))
    return path


def distilled_mlp_artifact(torch) -> bytes:
    """An MLP at config #1's widths distilled on the card from the rule
    evaluator's scores over seeded synthetic traces (the JAX package's
    lifecycle rung's recipe, ``guardbench.train_rule_distilled_mlp``, at
    hidden (128, 128, 64) instead of its (32,)): trained, and over the
    gate's rank-correlation floor by construction."""
    from dragonfly2_tpu_torch.manager.validation import synthetic_traces
    from dragonfly2_tpu_torch.scheduler.evaluator import scoring
    from dragonfly2_tpu_torch.train.checkpoint import mlp_tree
    from dragonfly2_tpu_torch.train.mlp_trainer import (
        MLPTrainConfig,
        train_mlp,
    )

    x = np.concatenate(synthetic_traces(seed=3, batches=64, rows=12))
    y = np.asarray(scoring.rule_scores(x), np.float32)
    result = train_mlp(x, y, MLPTrainConfig(
        hidden=MLP_CFG["hidden"], epochs=30, batch_size=128,
        eval_fraction=0.2))
    return mlp_artifact(mlp_tree(result.params, result.normalizer,
                                 result.target_norm), "mlp",
                        MLP_CFG["hidden"], {"mae": result.mae})


def run_lifecycle(torch, config1_artifact: bytes) -> None:
    """The registry and the inference service's watcher on the card,
    with ModelInfer sent continuously, on the rule-distilled MLP
    (:func:`distilled_mlp_artifact`; the gate's verdict on config #1's
    trained MLP is logged beside it): good v1 through the gate (built on
    the card) and installed directly; a NaN-weighted version quarantined
    by the gate; good v2 (the weights, 1 % seeded noise) with the gate
    skipped, canaried on mirrored live batches and promoted; v3 under a
    ``model.weights`` CORRUPT rule, shadow guard trip, quarantined, v2
    serving on; v4 under ``model.artifact`` TRUNCATE, a memoized load
    failure not retried; an explicit rollback. Every
    ``infer.model_infer`` visit LIFECYCLE_UNAVAILABLE_NTH-th aborts
    UNAVAILABLE: the only failures the load thread may see.
    ``model_reload_failures`` must equal the artifact faults injected,
    and device memory after ``stop()`` be within one model's footprint of
    the start."""
    import tempfile

    from dragonfly2_tpu_torch.inference.sidecar import (
        InferenceService,
        _scorer_from_artifact,
    )
    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.manager.validation import (
        ValidationConfig,
        validate_artifact,
    )
    from dragonfly2_tpu_torch.rpc.health import HealthService
    from dragonfly2_tpu_torch.train.checkpoint import load_artifact
    from dragonfly2_tpu_torch.utils import faultplan
    from dragonfly2_tpu_torch.utils.servingstats import ServingStats

    config1_gate = validate_artifact("mlp", config1_artifact, None,
                                     ValidationConfig()).to_dict()
    t0 = time.perf_counter()
    artifact = distilled_mlp_artifact(torch)
    distill_s = time.perf_counter() - t0
    tree, metadata = load_artifact(artifact)
    hidden = metadata.config["hidden"]
    rng = np.random.default_rng(SEED + 14)
    noisy = dict(tree, params=jitter(tree["params"], rng))
    start = device_bytes(torch)
    probe = _scorer_from_artifact(artifact)
    footprint = device_bytes(torch) - start
    del probe
    start = device_bytes(torch)
    raw_start = torch.cuda.memory_allocated()
    tmp = tempfile.mkdtemp(prefix="smoke-lifecycle-")
    dirs = {tag: artifact_dir(tmp, tag, t, hidden) for tag, t in (
        ("good", tree), ("nan", poisoned(tree, "nan")), ("v2", noisy))}
    stats = ServingStats()
    manager = ManagerService(
        Database(os.path.join(tmp, "manager.db")),
        FilesystemObjectStore(os.path.join(tmp, "objects")),
        validation=ValidationConfig(), serving_stats=stats)
    service = InferenceService(
        manager=manager, reload_interval=LIFECYCLE_TICK_S,
        canary_batches=8, reload_grace_s=LIFECYCLE_GRACE_S,
        serving_stats=stats)
    health = HealthLog(HealthService())
    service.set_health(health)
    plan = faultplan.install(faultplan.FaultPlan(seed=SEED))
    plan.add("infer.model_infer", faultplan.FaultKind.UNAVAILABLE,
             every_nth=LIFECYCLE_UNAVAILABLE_NTH)
    requests = [f.astype(np.float32) for f in rng.uniform(
        0, 100, (16, ML_CANDIDATES, 11))]
    versions = []
    steps = []
    load = None

    def create(tag: str, **kw):
        row = manager.create_model("smoke", "mlp", "host", "127.0.0.1",
                                   "smoke", {}, dirs[tag], **kw)
        versions.append(row.version)
        return row

    def index(version):
        return versions.index(version) if version in versions else None

    def step(name: str, t_from: float, **fields) -> None:
        snap = stats.snapshot()
        steps.append(dict(
            step=name, serving=index(service.serving_version("mlp")),
            registry={index(r.version): r.state
                      for r in manager.list_models()},
            serving_stats={k: v for k, v in snap.items() if v},
            load=load.window(t_from) if load else None, **fields))

    try:
        t = time.perf_counter()
        v1 = create("good")
        gate_s = time.perf_counter() - t
        if v1.state != "active":
            raise AssertionError(f"lifecycle: v1 {v1.state}: "
                                 f"{v1.evaluation['validation']}")
        service.serve_watcher()
        wait_until("v1 installed",
                   lambda: service.serving_version("mlp") == v1.version)
        load = LoadThread(service, "mlp", requests)
        step("v1 gate passed, installed", t,
             gate_seconds=gate_s, gate=v1.evaluation["validation"])

        t = time.perf_counter()
        nan = create("nan")
        time.sleep(3 * LIFECYCLE_TICK_S)
        if nan.state != "quarantined" or manager.get_active_model_version(
                "mlp") != v1.version:
            raise AssertionError(f"lifecycle: NaN version {nan.state}")
        step("NaN version quarantined by the gate", t,
             gate_reasons=nan.evaluation["validation"]["reasons"])

        t = time.perf_counter()
        v2 = create("v2", skip_validation=True)
        waited = wait_until("v2 promoted",
                            lambda: service.serving_version("mlp")
                            == v2.version)
        step("v2 shadowed, canaried, promoted", t, seconds=waited)

        t = time.perf_counter()
        plan.add("model.weights", faultplan.FaultKind.CORRUPT, every_nth=1,
                 max_fires=1)
        v3 = create("good", skip_validation=True)
        waited = wait_until("v3 quarantined",
                            lambda: manager.get_model_version_state(
                                "mlp", v3.version) == "quarantined")
        time.sleep(3 * LIFECYCLE_TICK_S)
        step("v3 NaN weights: shadow guard trip, quarantined", t,
             seconds=waited)

        t = time.perf_counter()
        plan.add("model.artifact", faultplan.FaultKind.TRUNCATE,
                 every_nth=1, max_fires=1)
        v4 = create("good")
        wait_until("v4 load failure",
                   lambda: stats.get("model_reload_failures") == 1)
        visits = plan.snapshot()["model.artifact"]["visits"]
        time.sleep(4 * LIFECYCLE_TICK_S)
        retried = plan.snapshot()["model.artifact"]["visits"] - visits
        step("v4 truncated artifact: memoized load failure", t,
             gate_passed=v4.state == "active", retries=retried)

        t = time.perf_counter()
        restored = manager.rollback("mlp", reason="smoke rollback")
        time.sleep(3 * LIFECYCLE_TICK_S)
        step("explicit rollback", t,
             restored=index(restored.version) if restored else None)
        load.stop()
        whole = load.window(0.0)
    finally:
        if load is not None:
            load.stop()
        faultplan.uninstall()
        service.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    stopped = device_bytes(torch)
    raw_stopped = torch.cuda.memory_allocated()
    served = {index(v) for _, _, v in load.samples}
    artifact_faults = plan.snapshot()["model.artifact"]["total_fires"]
    unavailable = plan.snapshot()["infer.model_infer"]["total_fires"]
    final = {index(r.version): r.state for r in manager.list_models()}
    for s in steps:
        log("lifecycle_step", **s)
    log("lifecycle", config1_gate=config1_gate, distill_seconds=distill_s,
        steps=len(steps), load=whole,
        versions_served=sorted(served), failures=load.failures,
        injected_unavailable=unavailable, artifact_faults=artifact_faults,
        model_reload_failures=stats.get("model_reload_failures"),
        weights_faults=plan.snapshot()["model.weights"]["total_fires"],
        health_transitions=health.transitions, registry=final,
        memory={"start": start, "after_stop": stopped,
                "one_model": footprint, "raw_start": raw_start,
                "raw_after_stop": raw_stopped})
    if not (stats.get("model_reload_failures") == artifact_faults == 1
            and load.failures == ({"UNAVAILABLE": unavailable}
                                  if unavailable else {})
            and served == {0, 2}
            and final == {0: "inactive", 1: "quarantined", 2: "active",
                          3: "quarantined", 4: "quarantined"}
            and stats.get("canary_promotions") == 1
            and stats.get("canary_rollbacks") == 1
            and stats.get("shadow_batches") > 0
            and steps[-2]["retries"] == 0
            and {"NOT_SERVING", "SERVING"} <= set(
                s for _, s in health.transitions)
            and stopped - start <= footprint):
        raise AssertionError("lifecycle: see the lines above")


def jitter(params: dict, rng) -> dict:
    """``params`` with every float leaf times (1 + 1 % seeded noise)."""
    return {k: jitter(v, rng) if isinstance(v, dict) else
            (v * (1 + 0.01 * rng.standard_normal(v.shape))).astype(v.dtype)
            for k, v in params.items()}


def run_lifecycle_gat(torch, artifacts: dict, counts) -> dict:
    """Config #3 versions through the gate and a shadow load behind a
    serving incumbent (gather mode), at full width, while a load thread
    sends ModelInfer to the incumbent: a blocks-mode version, then a
    gather-mode one, each canaried on probe batches and promoted. Each
    version's gate build and shadow build is one embedding pass (2
    layers): K1 (blocks) or K2a (gather) must launch exactly 2 × 2 times
    a version, with the launch counts set to 0 just before and read just
    after. Prints each pass's build time and the incumbent's p99 while
    the shadow's pass runs (serving and the watcher share the default
    stream). Returns the launches."""
    import tempfile

    from dragonfly2_tpu_torch.inference.sidecar import InferenceService
    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.manager.service import untar_to_directory
    from dragonfly2_tpu_torch.manager.validation import ValidationConfig
    from dragonfly2_tpu_torch.utils.servingstats import ServingStats

    tmp = tempfile.mkdtemp(prefix="smoke-lifecycle-gat-")
    dirs = {}
    for mode, payload in artifacts.items():
        dirs[mode] = os.path.join(tmp, mode)
        untar_to_directory(payload, dirs[mode])
    stats = ServingStats()
    manager = ManagerService(
        Database(), FilesystemObjectStore(os.path.join(tmp, "objects")),
        validation=ValidationConfig(), serving_stats=stats)
    service = InferenceService(manager=manager, canary_batches=8,
                               canary_probe_grace_s=0.0,
                               reload_grace_s=LIFECYCLE_GRACE_S,
                               serving_stats=stats)

    def create(mode: str):
        t0 = time.perf_counter()
        row = manager.create_model("smoke-gat", "gat", "host", "127.0.0.1",
                                   "smoke", {}, dirs[mode])
        torch.cuda.synchronize()
        if row.state != "active":
            raise AssertionError(f"lifecycle_gat: {mode} version "
                                 f"{row.state}: {row.evaluation}")
        return row, time.perf_counter() - t0

    incumbent, incumbent_gate_s = create("gather")
    service.reload_from_manager()
    rng = np.random.default_rng(SEED + 15)
    load = LoadThread(service, "gat", [
        rng.integers(0, N_HOSTS, (REQUEST_ROWS, 2)) for _ in range(16)])
    time.sleep(1.0)
    baseline = load.window(0.0)
    counts.reset()
    passes = []
    try:
        for mode in ("blocks", "gather"):
            row, gate_s = create(mode)
            t0 = time.perf_counter()
            service.reload_from_manager()  # the shadow's build
            torch.cuda.synchronize()
            t1 = time.perf_counter()
            shadow = service.shadow_stats().get("gat", {})
            service.process_shadows()
            promoted = service.serving_version("gat") == row.version
            time.sleep(0.5)
            passes.append({
                "attention": mode, "gate_seconds": gate_s,
                "shadow_build_seconds": t1 - t0,
                "incumbent_during_shadow_build": load.window(t0, t1),
                "shadow_version_seen": shadow.get("version") == row.version,
                "promoted": promoted,
                "gate_checks": row.evaluation["validation"]["checks"]})
    finally:
        launches = counts.read()
        load.stop()
        service.stop()
        shutil.rmtree(tmp, ignore_errors=True)
    want = {name: 0 for name in launches} | {
        "graph_flash_attention": 2 * GAT_CFG["layers"],
        "table_gather": 2 * GAT_CFG["layers"]}
    log("lifecycle_gat", incumbent_gate_seconds=incumbent_gate_s,
        incumbent_baseline=baseline, passes=passes, launches=launches,
        expected_launches=want, load_failures=load.failures,
        serving_stats={k: v for k, v in stats.snapshot().items() if v})
    if launches != want or load.failures or not all(
            p["shadow_version_seen"] and p["promoted"] for p in passes):
        raise AssertionError("lifecycle_gat: see the line above")
    return launches


class TimedHTTP:
    """REST calls on the manager's listeners on loopback, each call's
    round trip kept in ms: ``call`` speaks JSON to a URL (a bearer token
    if given), ``client`` wraps a ``ManagerHTTPClient`` method."""

    def __init__(self):
        self.ms = []

    def call(self, method: str, url: str, body=None, token: str = ""):
        import urllib.request

        req = urllib.request.Request(
            url, data=None if body is None else json.dumps(body).encode(),
            method=method, headers={"Content-Type": "application/json",
                                    "Authorization": token})
        t0 = time.perf_counter()
        with urllib.request.urlopen(req, timeout=30) as resp:
            out = json.loads(resp.read())
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def client(self, fn, *args, **kw):
        t0 = time.perf_counter()
        out = fn(*args, **kw)
        self.ms.append((time.perf_counter() - t0) * 1e3)
        return out

    def percentiles(self) -> dict:
        ms = sorted(self.ms)
        return {"calls": len(ms), "p50_ms": ms[len(ms) // 2],
                "p99_ms": ms[min(int(len(ms) * 0.99), len(ms) - 1)]}


def start_manager(tmp: str):
    """``python -m dragonfly2_tpu_torch.cmd.manager`` in a child process
    (auth and the model gate on, both listeners on free loopback ports)
    → (process, public port, internal port), read from its stdout."""
    err = open(os.path.join(tmp, "manager.err"), "w")
    proc = subprocess.Popen(
        [sys.executable, "-m", "dragonfly2_tpu_torch.cmd.manager",
         "--host", "127.0.0.1", "--port", "0", "--internal-port", "0",
         "--db", os.path.join(tmp, "manager.db"),
         "--object-store-dir", os.path.join(tmp, "objects"),
         "--model-gate"], cwd=ROOT, stdout=subprocess.PIPE, stderr=err,
        text=True)
    err.close()
    # A child that hangs before printing is killed, so readline returns.
    import threading

    watchdog = threading.Timer(MANAGER_START_TIMEOUT_S, proc.kill)
    watchdog.start()
    lines = [proc.stdout.readline() for _ in range(2)]
    watchdog.cancel()
    if not (lines[0].startswith("manager serving on 127.0.0.1:")
            and lines[1].startswith("manager internal surface on ")):
        stop_manager(proc)
        with open(os.path.join(tmp, "manager.err")) as fh:
            raise AssertionError(f"manager did not start: {lines}, "
                                 f"{fh.read()[-2000:]}")
    public = int(lines[0].split(":")[1].split()[0])
    internal = int(lines[1].rstrip().rsplit(":", 1)[1])
    return proc, public, internal


def stop_manager(proc) -> int:
    """SIGTERM (the command's graceful stop), then SIGKILL after 20 s."""
    import signal

    if proc.poll() is None:
        proc.send_signal(signal.SIGTERM)
    try:
        return proc.wait(timeout=20)
    except subprocess.TimeoutExpired:
        proc.kill()
        return proc.wait()


def run_manager_plane(torch, artifacts: dict, mlp_bytes: bytes,
                      counts) -> dict:
    """The manager as a service (slice 20) at a fleet's size, beside the
    card: the manager started through its entry point in a child
    process; a root JWT over HTTP; MANAGER_CLUSTERS scheduler clusters
    with CIDR, IDC and location scopes; MANAGER_SCHEDULERS instances
    registered and kept alive over the internal surface;
    MANAGER_QUERIES seeded ``daemon_dynconfig`` answers held against the
    same ``Searcher``'s pick recomputed here from the listed rows. Then
    a scheduler in this process linked through ``connect_manager`` (its
    row must turn active, a PATCHed cluster config must reach
    ``Scheduling.apply_dynconfig``), whose ``RemoteMLEvaluator`` scores
    through an ``InferenceService`` watching a trainer-side registry on
    the same database: config #3 v1 (blocks) and v2 (gather) gated on
    the card, v2 served; a JWT rollback of v2 over REST, after which the
    watcher must rebuild v1 on the card and ModelInfer equal a direct
    load of v1 (MANAGER_ROLLBACK_TOL); a ``model.weights`` CORRUPT rule
    planted under the MLP's v2, whose NaN scores trip the evaluator's
    guard, which escalates through the link to
    ``/internal/v1/models/quarantine``: v1 must come back; the recorded
    traces uploaded through the link, which the next MLP candidate's
    gate must replay. K1 and K2a must launch 2 passes × 2 layers each
    (v1's gate and rebuild; v2's gate and install), with the counts set
    to 0 just before the gate builds and read after the rebuild.
    Returns the launches."""
    import tempfile

    from dragonfly2_tpu_torch.cmd.scheduler import connect_manager
    from dragonfly2_tpu_torch.inference.sidecar import (
        CallContext,
        InferenceService,
        LocalInferenceClient,
        ModelInferRequest,
        RemoteMLEvaluator,
        _gat_scorer_from_artifact,
    )
    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
        Searcher,
    )
    from dragonfly2_tpu_torch.manager.client import ManagerHTTPClient
    from dragonfly2_tpu_torch.manager.service import untar_to_directory
    from dragonfly2_tpu_torch.manager.validation import ValidationConfig
    from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
    from dragonfly2_tpu_torch.scheduler.scheduling.core import Scheduling
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService
    from dragonfly2_tpu_torch.scheduler.storage.storage import Storage
    from dragonfly2_tpu_torch.utils import faultplan
    from dragonfly2_tpu_torch.utils.servingstats import ServingStats

    tmp = tempfile.mkdtemp(prefix="smoke-manager-")
    steps, http = {}, TimedHTTP()
    proc = link = sidecar = None
    t_phase = time.perf_counter()
    try:
        t0 = time.perf_counter()
        proc, public, internal = start_manager(tmp)
        base = f"http://127.0.0.1:{public}"
        client = ManagerHTTPClient(f"127.0.0.1:{internal}")
        steps["start"] = time.perf_counter() - t0

        # -- the fleet: clusters, instances, dynconfig answers ----------
        t0 = time.perf_counter()
        token = "Bearer " + http.call(
            "POST", f"{base}/api/v1/users/signin",
            {"name": "root", "password": "dragonfly"})["token"]
        cluster_ids = []
        for c in range(MANAGER_CLUSTERS):
            cluster_ids.append(http.call(
                "POST", f"{base}/api/v1/scheduler-clusters",
                {"name": f"smoke-c{c}", "is_default": c == 0,
                 "scopes": {"cidrs": [f"10.{c}.0.0/16"],
                            "idc": f"idc-{c % 4}",
                            "location": f"r{c % 4}|z{c}"},
                 "client_config": {"load_limit": 100 + c}}, token)["id"])
        per = MANAGER_SCHEDULERS // MANAGER_CLUSTERS
        fleet = [(cluster_ids[c], f"sched-{c}-{j}", f"10.{c}.1.{j + 1}")
                 for c in range(MANAGER_CLUSTERS) for j in range(per)]
        for cid, host, ip in fleet:
            http.client(client.update_scheduler_instance, hostname=host,
                        ip=ip, port=8002, cluster_id=cid)
        for _ in range(2):
            for cid, host, ip in fleet:
                http.client(client.keepalive_scheduler, hostname=host,
                            ip=ip, cluster_id=cid)
        steps["fleet"] = time.perf_counter() - t0

        t0 = time.perf_counter()
        clusters = [types.SimpleNamespace(**c) for c in http.call(
            "GET", f"{base}/api/v1/scheduler-clusters", token=token)]
        rows = http.call("GET", f"{base}/api/v1/schedulers?all=1",
                         token=token)
        active_of = {}
        for r in rows:
            if r["state"] == "active":
                active_of.setdefault(r["scheduler_cluster_id"], []).append(
                    f"{r['ip']}:{r['port']}")
        searcher = Searcher()
        rng = np.random.default_rng(SEED + 20)
        mismatches, picked = [], set()
        for q in range(MANAGER_QUERIES):
            ip = (f"10.{int(rng.integers(0, MANAGER_CLUSTERS + 2))}."
                  f"{int(rng.integers(256))}.{int(rng.integers(1, 255))}"
                  if rng.random() < 0.8 else
                  f"192.168.{int(rng.integers(256))}.1")
            hostname = f"daemon-{q}"
            got = http.client(client.daemon_dynconfig, ip=ip,
                              hostname=hostname)
            ranked = searcher.find_scheduler_clusters(
                clusters, ip, hostname, {},
                has_active_schedulers=lambda c: c.id in active_of)
            want = sorted(active_of[ranked[0].id]) if ranked else []
            picked.add(ranked[0].id if ranked else None)
            if sorted(got["schedulers"]) != want:
                mismatches.append({"ip": ip, "got": got["schedulers"],
                                   "want": want})
        steps["dynconfig"] = time.perf_counter() - t0
        fleet_active = sum(r["state"] == "active" for r in rows
                           if r["hostname"].startswith("sched-"))

        # -- the scheduler's link ----------------------------------------
        t0 = time.perf_counter()
        db_path = os.path.join(tmp, "manager.db")
        objects = os.path.join(tmp, "objects")
        stats = ServingStats()
        trainer = ManagerService(Database(db_path),
                                 FilesystemObjectStore(objects),
                                 validation=ValidationConfig(),
                                 serving_stats=stats)
        sidecar = InferenceService(
            manager=trainer, scheduler_id=MANAGER_SCHEDULER_ID,
            reload_interval=MANAGER_TICK_S, micro_batch=False,
            shadow_mode=False, serving_stats=stats)
        evaluator = RemoteMLEvaluator(LocalInferenceClient(sidecar),
                                      stats=stats, guard_trip_limit=3)
        scheduler = SchedulerService(
            resource=Resource(), scheduling=Scheduling(evaluator),
            storage=Storage(os.path.join(tmp, "datasets")))
        link = connect_manager(
            scheduler, f"127.0.0.1:{internal}", port=8002,
            cluster_id=cluster_ids[0], scheduler_id=MANAGER_SCHEDULER_ID,
            advertise_ip="127.0.0.1", hostname="smoke-scheduler",
            data_dir=tmp, keepalive_interval=MANAGER_TICK_S,
            dynconfig_interval=MANAGER_TICK_S)
        link_state = [r["state"] for r in http.call(
            "GET", f"{base}/api/v1/schedulers?all=1", token=token)
            if r["hostname"] == "smoke-scheduler"]
        patched = {"filter_parent_limit": 9, "candidate_parent_limit": 5}
        http.call("PATCH",
                  f"{base}/api/v1/scheduler-clusters/{cluster_ids[0]}",
                  {"config": patched}, token)
        cfg = scheduler.scheduling.config
        dynconfig_s = wait_until(
            "the PATCHed cluster config",
            lambda: (cfg.filter_parent_limit, cfg.candidate_parent_limit)
            == (9, 5), timeout_s=10.0)
        steps["link"] = time.perf_counter() - t0

        # -- config #3 through the gate, served, rolled back over REST --
        dirs = {}
        for tag, payload in (("blocks", artifacts["blocks"]),
                             ("gather", artifacts["gather"]),
                             ("mlp", mlp_bytes)):
            dirs[tag] = os.path.join(tmp, f"artifact-{tag}")
            untar_to_directory(payload, dirs[tag])
        versions = []

        def create(name, model_type, tag, **kw):
            row = trainer.create_model(
                name, model_type, "host", "127.0.0.1", "smoke", {},
                dirs[tag], scheduler_id=MANAGER_SCHEDULER_ID, **kw)
            versions.append(row.version)
            return row

        t0 = time.perf_counter()
        counts.reset()
        gat_v1 = create("smoke-gat", "gat", "blocks")
        gat_v2 = create("smoke-gat", "gat", "gather")
        torch.cuda.synchronize()
        steps["gat_gates"] = time.perf_counter() - t0
        mlp_v1 = create("smoke-mlp", "mlp", "mlp", skip_validation=True)
        t0 = time.perf_counter()
        sidecar.reload_from_manager()
        torch.cuda.synchronize()
        steps["serve_v2"] = time.perf_counter() - t0
        served = {"gat": sidecar.serving_version("gat") == gat_v2.version,
                  "mlp": sidecar.serving_version("mlp") == mlp_v1.version}
        sidecar.serve_watcher()
        for parents, child, total in seeded_decisions(
                SEED + 21, MANAGER_WARM_DECISIONS, ML_CANDIDATES):
            evaluator.evaluate_parents(parents, child, total)
        warm_scored = evaluator.scored_count

        t0 = time.perf_counter()
        rollback = http.call("POST",
                             f"{base}/api/v1/models/{gat_v2.id}/rollback",
                             {"reason": "smoke operator rollback"}, token)
        reload_s = wait_until(
            "gat v1 rebuilt after the rollback",
            lambda: sidecar.serving_version("gat") == gat_v1.version,
            timeout_s=60.0)
        torch.cuda.synchronize()
        launches = counts.read()
        steps["rollback"] = time.perf_counter() - t0
        pairs = np.random.default_rng(SEED + 22).integers(
            0, N_HOSTS, (REQUEST_ROWS, 2))
        served_scores = sidecar.ModelInfer(
            ModelInferRequest("gat", pairs), CallContext()).outputs
        direct = _gat_scorer_from_artifact(trainer.get_active_model(
            "gat", MANAGER_SCHEDULER_ID).artifact)
        direct_scores = direct.score(pairs)
        del direct
        rollback_err = float(np.abs(np.asarray(served_scores, np.float64)
                                    - direct_scores).max())

        # -- the guard's escalation through the link ------------------------
        t0 = time.perf_counter()
        plan = faultplan.install(faultplan.FaultPlan(seed=SEED))
        try:
            plan.add("model.weights", faultplan.FaultKind.CORRUPT,
                     every_nth=1, max_fires=1, match="mlp")
            mlp_v2 = create("smoke-mlp", "mlp", "mlp", skip_validation=True)
            wait_until("mlp v2 serving", lambda: sidecar.serving_version(
                "mlp") == mlp_v2.version, timeout_s=30.0)
            poisoned = 0
            for parents, child, total in seeded_decisions(
                    SEED + 23, 10, ML_CANDIDATES):
                if stats.get("ml_quarantines_reported"):
                    break
                evaluator.evaluate_parents(parents, child, total)
                poisoned += 1
            restore_s = wait_until(
                "mlp v1 restored", lambda: sidecar.serving_version(
                    "mlp") == mlp_v1.version, timeout_s=30.0)
            weights_faults = plan.snapshot()["model.weights"]["total_fires"]
        finally:
            faultplan.uninstall()
        steps["escalation"] = time.perf_counter() - t0

        # -- the traces reach the next gate ------------------------------
        t0 = time.perf_counter()
        uploaded = link.upload_traces()
        traces = trainer.load_announce_traces(MANAGER_SCHEDULER_ID) or []
        mlp_v3 = create("smoke-mlp", "mlp", "mlp")
        gate = mlp_v3.evaluation["validation"]
        steps["traces"] = time.perf_counter() - t0
        registry = {versions.index(r.version): (r.type, r.state)
                    for r in trainer.list_models()}
        keepalives = link.keepalives
    finally:
        if link is not None:
            link.stop()
        if sidecar is not None:
            sidecar.stop()
        manager_rc = stop_manager(proc) if proc is not None else None
        shutil.rmtree(tmp, ignore_errors=True)
    want = {name: 0 for name in launches} | {
        "graph_flash_attention": 2 * GAT_CFG["layers"],
        "table_gather": 2 * GAT_CFG["layers"]}
    checks = {
        "fleet_active": fleet_active == MANAGER_SCHEDULERS,
        "dynconfig_picks": not mismatches,
        "link_active": link_state == ["active"],
        "dynconfig_applied": (cfg.filter_parent_limit,
                              cfg.candidate_parent_limit) == (9, 5),
        "served_v2": all(served.values()),
        "rollback_restored": (rollback["restored"] or {}).get("id")
        == gat_v1.id,
        "rollback_scores": rollback_err <= MANAGER_ROLLBACK_TOL,
        "escalation": (weights_faults == 1
                       and stats.get("ml_quarantines_reported") == 1
                       and registry[versions.index(mlp_v2.version)]
                       == ("mlp", "quarantined")),
        "traces_gated": (uploaded and len(traces) == warm_scored + poisoned
                         and gate["trace_source"] == "recorded"
                         and gate["batches"] == len(traces)),
        "launches": launches == want,
        "manager_exit": manager_rc == 0,
    }
    log("manager_plane", seconds=time.perf_counter() - t_phase,
        step_seconds=steps, clusters=MANAGER_CLUSTERS,
        schedulers={"registered": MANAGER_SCHEDULERS, "active": fleet_active},
        dynconfig={"queries": MANAGER_QUERIES, "mismatches": len(mismatches),
                   "first_mismatches": mismatches[:3],
                   "clusters_picked": len(picked)},
        link={"state": link_state, "keepalives": keepalives,
              "dynconfig_applied_seconds": dynconfig_s, "config": patched},
        rest_rtt=http.percentiles(),
        rollback={"restored_v1": checks["rollback_restored"],
                  "reload_seconds": reload_s, "max_abs_err": rollback_err,
                  "tol": MANAGER_ROLLBACK_TOL},
        escalation={"decisions_warm": warm_scored,
                    "decisions_poisoned": poisoned,
                    "guard_trips": evaluator.guard_trips,
                    "restore_seconds": restore_s,
                    "weights_faults": weights_faults},
        traces={"uploaded": uploaded, "batches": len(traces),
                "gate": {k: gate[k] for k in ("passed", "batches",
                                              "trace_source", "reasons")}},
        registry={str(k): v for k, v in sorted(registry.items())},
        launches=launches, expected_launches=want, checks=checks,
        manager_exit=manager_rc)
    failed = [name for name, ok in checks.items() if not ok]
    if failed:
        raise AssertionError(f"manager_plane: {failed}; see the line above")
    return launches


def training_records():
    """(NetworkTopology records, Download records) of the training phase:
    one seeded SyntheticCluster of TRAINING_HOSTS hosts, topology first."""
    from dragonfly2_tpu_torch.data import SyntheticCluster

    cluster = SyntheticCluster(n_hosts=TRAINING_HOSTS, seed=SEED)
    return (cluster.topology(TRAINING_TOPOLOGY),
            cluster.downloads(TRAINING_DOWNLOADS))


def replay_records(corpus) -> list:
    """The cost stand-in's decisions as ``ReplayDecision`` records: each
    valid slot a ``ReplayCandidate`` with its feature row, ``realized_n``
    and ``realized_cost`` (float32 values, which the CSV round trip keeps
    exactly)."""
    from dragonfly2_tpu_torch.scheduler.evaluator.scoring import FEATURE_NAMES
    from dragonfly2_tpu_torch.schema import (
        ReplayCandidate,
        ReplayDecision,
        ReplayFeatureRow,
    )

    return [ReplayDecision(seq=i, verdict="parents", candidates=[
        ReplayCandidate(
            id=f"parent-{j}", rank=int(j),
            features=ReplayFeatureRow(**dict(zip(
                FEATURE_NAMES, map(float, corpus.features[i, j])))),
            realized_n=int(corpus.realized_n[i, j]),
            realized_cost=float(corpus.realized_cost[i, j]))
        for j in np.flatnonzero(corpus.valid[i])])
        for i in range(len(corpus.valid))]


def write_segments(storage, prefix: str, record_type, records,
                   n_segments: int, scratch: str) -> None:
    """``records`` as ``n_segments`` CSV files (headered, the port's
    writer), each appended to ``storage`` as a new segment of
    TRAINING_HOST_ID."""
    from dragonfly2_tpu_torch.schema.io import CsvRecordWriter

    path = os.path.join(scratch, f"{prefix}.csv")
    for part in np.array_split(np.arange(len(records)), n_segments):
        with CsvRecordWriter(record_type, path) as writer:
            for i in part:
                writer.write(records[i])
        with open(path, "rb") as f:
            storage.append(prefix, TRAINING_HOST_ID, f.read(), new_file=True)
        os.remove(path)


def write_training_segments(storage, mlp_x, mlp_y, scratch: str,
                            host_s: dict) -> tuple:
    """The training phase's records (``training_records`` and the cost
    stand-in's decisions) written into ``storage`` as TRAINING_SEGMENTS
    closed segments of each kind; the host seconds of generating and
    writing go into ``host_s``. Returns (topology, downloads,
    decisions)."""
    from dragonfly2_tpu_torch.schema import (
        Download,
        NetworkTopology,
        ReplayDecision,
    )

    t0 = time.perf_counter()
    topology, downloads = training_records()
    decisions = replay_records(cost_corpus(mlp_x, mlp_y))
    host_s["generate"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    for prefix, record_type, records in (
            ("networktopology", NetworkTopology, topology),
            ("download", Download, downloads),
            ("replay", ReplayDecision, decisions)):
        write_segments(storage, prefix, record_type, records,
                       TRAINING_SEGMENTS, scratch)
    storage.close_host(TRAINING_HOST_ID)
    host_s["write"] = time.perf_counter() - t0
    return topology, downloads, decisions


def training_config():
    """The training phase's jobs at their published widths."""
    from dragonfly2_tpu_torch.train.cost_trainer import CostTrainConfig
    from dragonfly2_tpu_torch.train.gat_trainer import GATTrainConfig
    from dragonfly2_tpu_torch.train.gnn_trainer import GNNTrainConfig
    from dragonfly2_tpu_torch.train.mlp_trainer import MLPTrainConfig
    from dragonfly2_tpu_torch.trainer import TrainingConfig

    return TrainingConfig(
        gnn=GNNTrainConfig(**TRAINING_GNN_CFG),
        mlp=MLPTrainConfig(**TRAINING_MLP_CFG),
        gat=GATTrainConfig(**TRAINING_GAT_CFG),
        cost=CostTrainConfig(), train_gat_model=True)


class MetricFamily(dict):
    """One labelled metric family kept as a dict by job name: the part of
    a prometheus family that ``Training`` reports into."""

    def labels(self, model: str):
        def record(value: float) -> None:
            self[model] = value
        return types.SimpleNamespace(observe=record, set=record)


class JobMetrics:
    """``Training``'s metrics hook: each job's seconds and samples/s."""

    def __init__(self):
        self.training_duration = MetricFamily()
        self.train_samples_per_sec = MetricFamily()


def predicted_training_launches(graph, config, names) -> dict:
    """The kernel launches ``Training.train`` must make on ``graph``:
    GraphSAGE one K2a a forward (its steps and eval chunks), the blocks-mode
    GraphTransformer one K1 forward a layer a forward (its steps, eval
    chunks and the gate's embedding pass) and one K1 backward a layer a
    step; the MLP and the cost model none. ``names``: every kernel's row
    name."""
    from dragonfly2_tpu_torch.train.split import edge_split

    def steps_and_chunks(job_config, batch_size: int):
        train_ids, eval_ids = edge_split(graph, job_config.eval_fraction,
                                         job_config.seed)
        batch = min(batch_size, len(train_ids))
        steps = job_config.epochs * max(len(train_ids) // batch, 1)
        return steps, -(-len(eval_ids) // batch)

    gnn_steps, gnn_chunks = steps_and_chunks(config.gnn,
                                             config.gnn.batch_size)
    gat_steps, gat_chunks = steps_and_chunks(config.gat,
                                             config.gat.edge_batch_size)
    layers = config.gat.layers
    counts = dict.fromkeys(names, 0)
    counts["table_gather"] = gnn_steps + gnn_chunks
    counts["graph_flash_attention"] = layers * (gat_steps + gat_chunks + 1)
    counts["graph_flash_attention_backward"] = layers * gat_steps
    return counts


def run_training(torch, mlp_x, mlp_y, counts) -> dict:
    """The training orchestrator, slice 11's path: seeded records written
    as CSV segments (each kind in TRAINING_SEGMENTS closed segments and
    one topology segment left open), ``Training.train`` with all four
    jobs at their published widths on the card, the registry a
    ``ManagerService`` gating on the card, with every launch count set to
    0 just before and read just after — each kernel exactly as often as
    ``predicted_training_launches`` says; no job error; the GraphSAGE and
    GraphTransformer F1 at least GNN_F1_MIN and the MLP's eval MAE below
    predicting the train mean; every closed segment deleted and the open
    one kept; the gate's verdict for each model, the ``gat`` version
    active and answering ModelInfer through ``reload_from_manager``.
    Returns (the launches, the predicted launches, each job's
    evaluation)."""
    import tempfile

    from dragonfly2_tpu_torch.data import ArrayDataset
    from dragonfly2_tpu_torch.data.features import (
        graph_from_table,
        pair_examples_from_table,
    )
    from dragonfly2_tpu_torch.inference.sidecar import (
        CallContext,
        InferenceService,
        ModelInferRequest,
    )
    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.manager.validation import ValidationConfig
    from dragonfly2_tpu_torch.schema import Download, NetworkTopology
    from dragonfly2_tpu_torch.schema.io import records_to_table
    from dragonfly2_tpu_torch.train.cost_trainer import (
        cost_examples_from_corpus,
    )
    from dragonfly2_tpu_torch.trainer import TrainerStorage, Training

    host_s = {}
    tmp = tempfile.mkdtemp(prefix="smoke-training-")
    try:
        storage = TrainerStorage(os.path.join(tmp, "segments"))
        topology, downloads, decisions = write_training_segments(
            storage, mlp_x, mlp_y, tmp, host_s)
        t0 = time.perf_counter()
        with open(storage.network_topology_files(TRAINING_HOST_ID)[0],
                  "rb") as f:
            open_path = storage.append("networktopology", TRAINING_HOST_ID,
                                       f.read(), new_file=True)
        host_s["write"] += time.perf_counter() - t0
        closed = [p for files in storage.snapshot(TRAINING_HOST_ID)
                  for p in files]

        # The stages Training runs inside one call, timed on their own.
        t0 = time.perf_counter()
        files = storage.snapshot(TRAINING_HOST_ID)
        topo_recs = storage.list_network_topology(TRAINING_HOST_ID, files[1])
        dl_recs = storage.list_download(TRAINING_HOST_ID, files[0])
        replay_recs = storage.list_replay(TRAINING_HOST_ID, files[2])
        host_s["snapshot_parse"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        graph = graph_from_table(records_to_table(NetworkTopology, topo_recs))
        host_s["graph_from_table"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        X, y = pair_examples_from_table(records_to_table(Download, dl_recs))
        host_s["pair_examples_from_table"] = time.perf_counter() - t0
        cost_x, _ = cost_examples_from_corpus(replay_recs)
        del topo_recs, dl_recs, replay_recs

        config = training_config()
        predicted = predicted_training_launches(graph, config,
                                                counts.read())
        manager = ManagerService(
            Database(os.path.join(tmp, "manager.db")),
            FilesystemObjectStore(os.path.join(tmp, "objects")),
            validation=ValidationConfig())
        metrics = JobMetrics()
        training = Training(storage, manager, config, metrics=metrics)
        counts.reset()
        t0 = time.perf_counter()
        outcome = training.train(TRAINING_IP, TRAINING_HOSTNAME,
                                 TRAINING_HOST_ID, TRAINING_SCHEDULER_ID)
        torch.cuda.synchronize()
        train_s = time.perf_counter() - t0
        launches = counts.read()
        host_s["jobs"] = dict(metrics.training_duration)
        rows = manager.db.find("models", scheduler_id=TRAINING_SCHEDULER_ID)
        registry = [{"type": r.type, "name": r.name, "version": r.version,
                     "scheduler_id": r.scheduler_id, "state": r.state,
                     "gate": r.evaluation.get("validation")} for r in rows]
        left = sorted(os.listdir(os.path.join(tmp, "segments")))
        evaluations = {job: getattr(outcome, f"{job}_evaluation")
                       for job in ("gnn", "gat", "mlp", "cost")}
        train_ds, held = ArrayDataset(X, y).split(
            config.mlp.eval_fraction, config.mlp.seed)
        mean_mae = float(np.abs(held.arrays[1]
                                - train_ds.arrays[1].mean()).mean())
        log("training", seconds=train_s, host_seconds=host_s,
            n_nodes=graph.n_nodes, n_edges=graph.n_edges,
            pair_examples=len(X), cost_examples=len(cost_x),
            records={"topology": len(topology), "download": len(downloads),
                     "replay": len(decisions)},
            segments_closed=len(closed), segments_left=left,
            samples_per_sec=dict(metrics.train_samples_per_sec),
            evaluations=evaluations, mlp_mean_mae=mean_mae,
            model_ids={job: getattr(outcome, f"{job}_model_id")
                       for job in ("gnn", "gat", "mlp", "cost")},
            errors=outcome.errors, registry=registry,
            launches=launches, predicted_launches=predicted)
        if outcome.errors:
            raise AssertionError(f"training job errors: {outcome.errors}")
        if launches != predicted:
            raise AssertionError(f"training launches {launches} != "
                                 f"predicted {predicted}")
        for job in ("gnn", "gat"):
            if not evaluations[job]["f1"] >= GNN_F1_MIN:
                raise AssertionError(f"training {job}: F1 "
                                     f"{evaluations[job]['f1']} < {GNN_F1_MIN}")
        if not evaluations["mlp"]["mae"] < mean_mae:
            raise AssertionError(f"training mlp: eval MAE "
                                 f"{evaluations['mlp']['mae']} >= {mean_mae}")
        if any(os.path.exists(p) for p in closed) or left != [
                os.path.basename(open_path)]:
            raise AssertionError(f"segments left after training: {left}")
        by_type = {r["type"]: r for r in registry}
        if set(by_type) != {"gnn", "gat", "mlp", "cost"} or any(
                r["state"] not in ("active", "quarantined")
                for r in registry):
            raise AssertionError(f"registry rows {registry}")
        if by_type["gat"]["state"] != "active":
            raise AssertionError(f"the gate quarantined the gat version: "
                                 f"{by_type['gat']['gate']}")

        service = InferenceService(manager=manager,
                                   scheduler_id=TRAINING_SCHEDULER_ID,
                                   micro_batch=False)
        try:
            if not service.reload_from_manager():
                raise AssertionError("reload_from_manager installed nothing")
            installed = service.serving_version("gat")
            pairs = np.random.default_rng(SEED).integers(
                0, graph.n_nodes, (16, 2))
            scores = service.ModelInfer(ModelInferRequest("gat", pairs),
                                        CallContext()).outputs
        finally:
            service.stop()
        if installed != by_type["gat"]["version"] or not (
                scores.shape == (16,) and np.isfinite(scores).all()):
            raise AssertionError(f"gat {installed} scores {scores}")
        log("training_to_serve", gat_version=installed,
            scores=[float(v) for v in scores])
        storage.close_host(TRAINING_HOST_ID)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches, predicted, evaluations


class LoopTrainerClient:
    """The announcer's trainer client: the port's ``TrainerService``
    called in process. Keeps the summed size of the snapshot's files,
    which the announcer has frozen when it calls ``train``."""

    def __init__(self, service, storage):
        self.service = service
        self.storage = storage
        self.snapshot_bytes = None

    def train(self, requests):
        from dragonfly2_tpu_torch.rpc.status import CallContext

        self.snapshot_bytes = sum(
            os.path.getsize(path) for dataset in (
                self.storage.download, self.storage.network_topology,
                self.storage.replay) for path in dataset.all_files())
        return self.service.Train(requests, CallContext())


class LoopTraining:
    """``Training`` behind the trainer service, keeping its outcome (the
    service logs job errors and goes on) and the closed segments it
    trains from."""

    def __init__(self, training, storage):
        self.training = training
        self.storage = storage
        self.outcome = None
        self.segments = []

    def train(self, ip, hostname, host_id, scheduler_id=0):
        self.segments = [path for files in self.storage.snapshot(host_id)
                         for path in files]
        self.outcome = self.training.train(ip, hostname, host_id,
                                           scheduler_id)
        return self.outcome


def plain_gat_scorer(artifact: bytes):
    """The artifact's scorer built with K1 swapped for its plain twin,
    ``graph_flash_attention_plain``, on the same card: the same weights
    and inputs, the embedding pass in plain PyTorch."""
    from dragonfly2_tpu_torch.inference.sidecar import (
        _gat_scorer_from_artifact,
    )
    from dragonfly2_tpu_torch.models import graph_transformer
    from dragonfly2_tpu_torch.ops.flash_attention import (
        graph_flash_attention_plain,
    )

    kernel = graph_transformer.graph_flash_attention
    graph_transformer.graph_flash_attention = (
        lambda q, k, v, nbr, val, block, inv=None:
        graph_flash_attention_plain(q, k, v, nbr, val, block))
    try:
        return _gat_scorer_from_artifact(artifact)
    finally:
        graph_transformer.graph_flash_attention = kernel


def probe_downloads(daemons, url: str, first: int) -> list:
    """Every daemon downloads ``url`` in PROBE_WAVES, starting at daemon
    ``first``: one back to source, then each wave at once from the
    parents before it. Returns each wave's seconds."""
    import threading

    order = daemons[first:] + daemons[:first]
    seconds, start = [], 0
    for size in PROBE_WAVES:
        wave, start = order[start:start + size], start + size
        results = [None] * len(wave)

        def fetch(i, daemon):
            results[i] = daemon.download_file(url)

        t0 = time.perf_counter()
        threads = [threading.Thread(target=fetch, args=(i, d), daemon=True)
                   for i, d in enumerate(wave)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=PROBE_DOWNLOAD_TIMEOUT_S)
        seconds.append(time.perf_counter() - t0)
        failed = [(d.config.hostname, r and r.error)
                  for d, r in zip(wave, results) if not (r and r.success)]
        if failed:
            raise AssertionError(f"probe_loop downloads failed: {failed}")
    return seconds


def run_probe_loop(torch, counts) -> dict:
    """The ML loop's collection half, slice 19's path: PROBE_DAEMONS port
    daemons probing each other live (``Prober`` → ``netping`` →
    ``probe_finished`` → the store's queues → ``snapshot()`` → the
    topology dataset) while they download files in waves (``Download``
    records, and the recorder's ``replay`` decisions) → ``Announcer.train``
    → the port's ``TrainerService.Train`` (``train_async=False``) →
    ``Training.train`` with ``training_config()`` on the card → the
    gating ``ManagerService`` → ``reload_from_manager`` → ModelInfer on
    every installed version. Every launch count is set to 0 just before
    the upload and read after the last ModelInfer: exactly the training
    part's ``predicted_training_launches`` on the graph the loop made,
    plus one K1 forward a layer for the reload's ``gat`` build. Fails on
    a prober that did not build or report, a failed probe between live
    daemons, a probe cycle's exception, a host missing from the store,
    accepted bytes other than the snapshot's, a dataset or segment left,
    a job error, a registry row without the announcer's host and
    scheduler id, a gate that quarantined the ``gat`` version, or served
    ``gat`` scores off the plain twin's by more than MODE_TOL. Returns
    the launches."""
    import logging
    import tempfile
    from concurrent.futures import ThreadPoolExecutor

    from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_tpu_torch.client.networktopology import Prober
    from dragonfly2_tpu_torch.data.features import (
        graph_from_table,
        pair_examples_from_table,
    )
    from dragonfly2_tpu_torch.inference.sidecar import (
        CallContext,
        InferenceService,
        ModelInferRequest,
    )
    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.manager.validation import ValidationConfig
    from dragonfly2_tpu_torch.scheduler.announcer import (
        Announcer,
        AnnouncerConfig,
    )
    from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator
    from dragonfly2_tpu_torch.scheduler.networktopology.store import (
        NetworkTopologyConfig,
        NetworkTopologyStore,
    )
    from dragonfly2_tpu_torch.scheduler.replaylog import ReplayRecorder
    from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
    from dragonfly2_tpu_torch.scheduler.scheduling.core import (
        Scheduling,
        SchedulingConfig,
    )
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService
    from dragonfly2_tpu_torch.scheduler.storage.storage import Storage
    from dragonfly2_tpu_torch.schema import Download, NetworkTopology
    from dragonfly2_tpu_torch.schema.io import records_to_table
    from dragonfly2_tpu_torch.train.cost_trainer import (
        MIN_COST_EXAMPLES,
        cost_examples_from_corpus,
    )
    from dragonfly2_tpu_torch.trainer import (
        TrainerService,
        TrainerStorage,
        Training,
    )

    class CycleErrors(logging.Handler):
        """A probe cycle's exception: the ticker logs it and goes on."""

        def __init__(self):
            super().__init__(logging.ERROR)
            self.messages = []

        def emit(self, record):
            self.messages.append(f"{record.getMessage()}: "
                                 f"{record.exc_info and record.exc_info[1]!r}")

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="smoke-probe-loop-")
    probe_log = logging.getLogger(
        "dragonfly2_tpu_torch.client.networktopology")
    cycle_errors = CycleErrors()
    probe_log.addHandler(cycle_errors)
    daemons, recorder, service = [], None, None
    failures, host_s = [], {}
    try:
        resource = Resource()
        storage = Storage(os.path.join(tmp, "datasets"))
        recorder = ReplayRecorder(storage)
        store = NetworkTopologyStore(NetworkTopologyConfig(),
                                     resource=resource, storage=storage)
        scheduler = SchedulerService(
            resource=resource,
            scheduling=Scheduling(BaseEvaluator(), SchedulingConfig(
                retry_interval=0.01, retry_back_to_source_limit=2),
                recorder=recorder),
            storage=storage, network_topology=store)
        t0 = time.perf_counter()
        for i in range(PROBE_DAEMONS):
            daemon = Daemon(scheduler, DaemonConfig(
                storage_root=os.path.join(tmp, f"peer-{i}"),
                hostname=f"peer-{i}", idc=f"idc-{i % 4}",
                location=f"region-{i % 2}|zone-{i % 4}",
                probe_interval=PROBE_INTERVAL_S,
                probe_timeout=PROBE_TIMEOUT_S))
            daemon.start()
            daemons.append(daemon)
            if not isinstance(daemon.prober, Prober):
                raise AssertionError(f"peer-{i}: no prober ({daemon.prober})")
        t_probing = time.perf_counter()
        host_s["start_daemons"] = t_probing - t0

        origin_dir = os.path.join(tmp, "origin")
        os.makedirs(origin_dir)
        for f in range(PROBE_FILES):
            with open(os.path.join(origin_dir, f"blob-{f}.bin"), "wb") as out:
                out.write(np.random.default_rng((SEED, f)).bytes(
                    PROBE_FILE_BYTES))
        wave_s = []
        with OriginServer(origin_dir) as origin:
            for f in range(PROBE_FILES):
                wave_s.append(probe_downloads(
                    daemons, origin.url(f"blob-{f}.bin"),
                    f * PROBE_DAEMONS // PROBE_FILES))
        host_s["downloads"] = time.perf_counter() - t_probing
        snapshots = []
        for n in range(1, PROBE_SNAPSHOTS + 1):
            time.sleep(max(0.0, t_probing + n * PROBE_SECONDS
                           / PROBE_SNAPSHOTS - time.perf_counter()))
            snapshots.append(store.snapshot())
        for daemon in daemons:
            daemon.prober.stop()
        host_s["probing"] = time.perf_counter() - t_probing
        recorder.finalize_all()
        recorder.flush()

        ids = [d.host_id for d in daemons]
        reported = {d.config.hostname: {
            outcome: d.metrics.probe_count.labels(outcome=outcome).get()
            for outcome in ("ok", "failed")} for d in daemons}
        edges = dict(store._edges)
        rtts = np.array([p.rtt for e in edges.values() for p in e.queue])
        sources = {src for src, _ in edges}
        records = {"topology": storage.network_topology_count(),
                   "download": storage.download_count(),
                   "replay": storage.replay_count()}
        if any(r["ok"] < 1 for r in reported.values()):
            failures.append(f"a prober reported nothing: {reported}")
        if any(r["failed"] for r in reported.values()):
            failures.append(f"probes between live daemons failed: "
                            f"{reported}")
        if cycle_errors.messages:
            failures.append(f"probe cycles raised: "
                            f"{cycle_errors.messages[:3]}")
        if sources != set(ids) or not all(dst in ids for _, dst in edges):
            failures.append(f"the store holds probes from "
                            f"{len(sources)} of {len(ids)} hosts")
        if not all(records.values()):
            failures.append(f"empty datasets: {records}")
        if failures:
            raise AssertionError(f"probe_loop: {failures}")

        # What the trainer will receive, read back from the datasets.
        t0 = time.perf_counter()
        graph = graph_from_table(records_to_table(
            NetworkTopology, storage.list_network_topology()))
        pair_x, _ = pair_examples_from_table(records_to_table(
            Download, storage.list_download()))
        cost_x, _ = cost_examples_from_corpus(storage.list_replay())
        host_s["read_back"] = time.perf_counter() - t0
        config = training_config()
        predicted = predicted_training_launches(graph, config,
                                                counts.read())

        trainer_storage = TrainerStorage(os.path.join(tmp, "trainer"))
        manager = ManagerService(
            Database(os.path.join(tmp, "manager.db")),
            FilesystemObjectStore(os.path.join(tmp, "objects")),
            validation=ValidationConfig())
        metrics = JobMetrics()
        training = LoopTraining(Training(trainer_storage, manager, config,
                                         metrics=metrics), trainer_storage)
        client = LoopTrainerClient(
            TrainerService(trainer_storage, training, train_async=False),
            storage)
        announcer = Announcer(
            host_id=PROBE_HOST_ID, ip=PROBE_IP, hostname=PROBE_HOSTNAME,
            port=PROBE_PORT, storage=storage, trainer_client=client,
            config=AnnouncerConfig(upload_chunk=PROBE_UPLOAD_CHUNK),
            scheduler_id=PROBE_SCHEDULER_ID)
        counts.reset()
        t0 = time.perf_counter()
        response = announcer.train()
        torch.cuda.synchronize()
        upload_train_s = time.perf_counter() - t0
        outcome = training.outcome
        rows = manager.db.find("models", scheduler_id=PROBE_SCHEDULER_ID)
        registry = [{"type": r.type, "version": r.version, "bio": r.bio,
                     "scheduler_id": r.scheduler_id, "state": r.state,
                     "gate": r.evaluation.get("validation")} for r in rows]
        by_type = {r.type: r for r in rows}

        service = InferenceService(manager=manager,
                                   scheduler_id=PROBE_SCHEDULER_ID,
                                   micro_batch=False)
        t0 = time.perf_counter()
        service.reload_from_manager()
        torch.cuda.synchronize()
        reload_s = time.perf_counter() - t0
        served = {name: service.serving_version(name)
                  for name in ("gat", "mlp")}
        pairs = np.random.default_rng(SEED).integers(
            0, graph.n_nodes, (16, 2))
        ctx = CallContext()
        answers = {}
        if served["gat"] is not None:
            answers["gat"] = service.ModelInfer(
                ModelInferRequest("gat", pairs), ctx).outputs
        if served["mlp"] is not None:
            answers["mlp"] = service.ModelInfer(
                ModelInferRequest("mlp", pair_x[:15]), ctx).outputs
        launches = counts.read()
        service.stop()
        service = None

        want = dict(predicted)
        if served["gat"] is not None:
            want["graph_flash_attention"] += config.gat.layers
        twin_err = None
        if "gat" in answers and by_type["gat"].state == "active":
            twin = plain_gat_scorer(manager.store.get_object(
                "models", by_type["gat"].object_key))
            twin_err = float(np.abs(twin.score(pairs)
                                    - answers["gat"]).max())
        evaluations = ({job: getattr(outcome, f"{job}_evaluation")
                        for job in ("gnn", "gat", "mlp", "cost")}
                       if outcome is not None else None)
        cost_case = ("trained" if len(cost_x) >= MIN_COST_EXAMPLES
                     else f"skipped: {len(cost_x)} examples < "
                     f"{MIN_COST_EXAMPLES}")
        fields = dict(
            daemons=len(daemons), probe_interval_s=PROBE_INTERVAL_S,
            probers_reported=reported,
            probes_stored=int(sum(store.probed_count(h) for h in ids)),
            probes_in_queues=int(rtts.size), edges=len(edges),
            rtt_ms={"p50": float(np.percentile(rtts, 50)) * 1e3,
                    "p99": float(np.percentile(rtts, 99)) * 1e3},
            snapshots=snapshots, records=records,
            n_nodes=graph.n_nodes, n_edges=graph.n_edges,
            pair_examples=len(pair_x), cost_examples=len(cost_x),
            cost_case=cost_case, wave_seconds=wave_s,
            accepted_bytes=response.accepted_bytes if response else None,
            snapshot_bytes=client.snapshot_bytes,
            datasets_left=[storage.download_count(),
                           storage.network_topology_count(),
                           storage.replay_count()],
            segments_trained=len(training.segments),
            segments_left=sorted(os.listdir(trainer_storage.base_dir)),
            upload_train_seconds=upload_train_s, reload_seconds=reload_s,
            jobs_seconds=dict(metrics.training_duration),
            host_seconds=host_s, evaluations=evaluations,
            errors=outcome.errors if outcome is not None else None,
            registry=registry, served=served,
            answers={k: [float(x) for x in v] for k, v in answers.items()},
            gat_vs_plain_twin=twin_err, tol=MODE_TOL,
            launches=launches, expected_launches=want,
            seconds=time.perf_counter() - t_phase)
        if outcome is None:
            failures.append("Training.train did not return (see the log)")
        elif outcome.errors:
            failures.append(f"job errors {outcome.errors}")
        if response is None or not response.accepted_bytes or (
                response.accepted_bytes != client.snapshot_bytes):
            failures.append("accepted bytes differ from the snapshot's")
        if any(fields["datasets_left"]):
            failures.append("the scheduler's datasets are not empty")
        if not training.segments or any(
                os.path.exists(p) for p in training.segments):
            failures.append("closed segments left after training")
        jobs = {"gnn", "gat", "mlp"} | (
            {"cost"} if cost_case == "trained" else set())
        if set(by_type) != jobs or len(rows) != len(jobs):
            failures.append(f"registered {sorted(by_type)}, want "
                            f"{sorted(jobs)}")
        if any(r.bio.split("/")[-1] != PROBE_HOST_ID
               or r.scheduler_id != PROBE_SCHEDULER_ID for r in rows):
            failures.append("a registry row lacks the announcer's host_id "
                            "or scheduler_id")
        if "gat" in by_type and by_type["gat"].state != "active":
            failures.append(f"the gate quarantined the gat version: "
                            f"{by_type['gat'].evaluation.get('validation')}")
        if served["gat"] != getattr(by_type.get("gat"), "version", None):
            failures.append(f"serving gat {served['gat']}")
        if not all(np.isfinite(a).all() and a.shape == (len(pairs),)
                   if k == "gat" else np.isfinite(a).all()
                   for k, a in answers.items()):
            failures.append("bad ModelInfer outputs")
        if twin_err is None or twin_err > MODE_TOL:
            failures.append(f"gat scores vs the plain twin's: {twin_err}")
        if launches != want:
            failures.append(f"launches {launches} != expected {want}")
        for name in ("table_gather", "graph_flash_attention",
                     "graph_flash_attention_backward"):
            if launches[name] < 1:
                failures.append(f"{name} never launched")
        if failures:
            raise AssertionError(f"probe_loop: {failures}; {fields}")
        log("probe_loop", **fields)
        return launches
    finally:
        probe_log.removeHandler(cycle_errors)
        if service is not None:
            service.stop()
        # Each stop persists a daemon's store; they share nothing.
        with ThreadPoolExecutor(max(len(daemons), 1)) as pool:
            list(pool.map(lambda d: d.stop(), daemons))
        if recorder is not None:
            recorder.close()
        shutil.rmtree(tmp, ignore_errors=True)


def profiled_kernel_launches(torch, fn):
    """``fn()`` under ``torch.profiler`` (the card's activity) → (its
    result, {"launches": {kernel row: launches}, "device_events": every
    kernel and copy on the card}), each row's launches counted from the
    profiler's kernel names that are one of KERNEL_FUNCTIONS[row] as a
    whole word — what ran on the card, whoever launched it. A warm-up
    step comes first and its events are discarded: without it a
    profiling window's first kernels can go missing
    (``tests/profiler_capture.py`` measures how often). The raw events
    are read, not
    ``key_averages()``: a training phase records hundreds of thousands
    of them."""
    import collections
    import re

    from torch.profiler import ProfilerActivity, profile, schedule

    names = collections.Counter()

    def collect(prof):
        names.update(e.name() for e in prof.profiler.kineto_results.events()
                     if e.device_type() == torch.autograd.DeviceType.CUDA)

    with profile(activities=[ProfilerActivity.CUDA],
                 schedule=schedule(wait=0, warmup=1, active=1, repeat=1),
                 on_trace_ready=collect) as prof:
        torch.ones(8, 8, device="cuda").sum()
        torch.cuda.synchronize()
        prof.step()
        out = fn()
        torch.cuda.synchronize()
        prof.step()
    launches = {}
    for row, functions in KERNEL_FUNCTIONS.items():
        pattern = re.compile(r"(?<!\w)(%s)(?!\w)" % "|".join(functions))
        launches[row] = sum(n for name, n in names.items()
                            if pattern.search(name))
    return out, {"launches": launches, "device_events": sum(names.values())}


def check_profiler_sees_kernels(torch) -> None:
    """The profiler's count must see the port's kernels: of PROFILER_CHECK
    K2a launches it must record at least one, on K2a's row alone, so a
    0 read from it on a path means no launch there that it could see.
    Deep in this script the profiler records only a share of the
    launches it is shown (``gather_library_profile`` records a fifth of
    ``index_select``'s), so the share is logged too."""
    from dragonfly2_tpu_torch.ops.table_gather import table_gather

    table = torch.zeros(64, 16, device="cuda")
    idx = torch.arange(32, device="cuda", dtype=torch.int32)

    def launch():
        for _ in range(PROFILER_CHECK):
            table_gather(table, idx)

    _, seen = profiled_kernel_launches(torch, launch)
    log("profiler_check", launched=PROFILER_CHECK, recorded=seen["launches"],
        device_events=seen["device_events"])
    others = {row: n for row, n in seen["launches"].items()
              if row != "table_gather"}
    if seen["launches"]["table_gather"] < 1 or any(others.values()):
        raise AssertionError(f"the profiler's kernel count read "
                             f"{seen['launches']} for {PROFILER_CHECK} "
                             f"K2a launches")


def run_federated(torch, counts) -> dict:
    """The federated bench's three rungs on the card
    (``run_federated_bench(seed=SEED, include_kill=True)``: the clean
    fleet registered through the gate and replayed against each solo
    model and the rule, the poisoned fleet's screens and quarantine, and
    the SIGKILLed child coordinator resumed from its journal), with
    every launch count set to 0 just before and read just after and the
    profiler's kernel count over the run — no kernel of the port may
    launch. ``verdict_pass`` must hold. Returns the launches."""
    from dragonfly2_tpu_torch.train.fedbench import run_federated_bench

    counts.reset()
    t0 = time.perf_counter()
    report, profiled = profiled_kernel_launches(
        torch, lambda: run_federated_bench(seed=SEED, include_kill=True))
    seconds = time.perf_counter() - t0
    launches = counts.read()
    clean, poisoned, kill = (report["clean"], report["poisoned"],
                             report["kill"])
    log("federated", seconds=seconds, rung_seconds=report["seconds"],
        verdict_pass=report["verdict_pass"], error=report["error"],
        clean_rounds=clean["rounds"], poisoned_rounds=poisoned["rounds"],
        screened_reasons=poisoned["screened_reasons"],
        screens_ok=poisoned["screens_ok"], escalated=poisoned["escalated"],
        quarantined_version=poisoned["quarantined_version"],
        gate_state={"clean": clean["gate_state"],
                    "poisoned": poisoned["gate_state"]},
        regret=clean["regret"], best_solo_regret=clean["best_solo_regret"],
        federated_regret=clean["federated_regret"],
        poisoned_regret=poisoned["regret"],
        within_poison_bound=poisoned["within_poison_bound"],
        deterministic=clean["deterministic"],
        rank_agreement={name: (s or {}).get("rank_agreement_mean")
                        for name, s in (report.get("ab") or {}).get(
                            "evaluators", {}).items()},
        kill={key: kill.get(key) for key in (
            "ok", "killed_after_updates", "resumed", "received",
            "committed", "train_counts", "no_retrain", "error")},
        bounds=report["bounds"], launches=launches,
        profiled_launches=profiled["launches"],
        profiled_device_events=profiled["device_events"])
    if not report["verdict_pass"]:
        raise AssertionError(f"federated bench failed: {report['error']}; "
                             f"clean ok {clean['ok']}, poisoned ok "
                             f"{poisoned['ok']}, kill {kill}")
    if any(launches.values()) or any(profiled["launches"].values()):
        raise AssertionError(f"the federated path launched kernels: "
                             f"{launches}, profiled {profiled['launches']}")
    return launches


class FederationProbe:
    """Times a coordinator's stages from outside: while entered, the
    federation module's ``train_mlp`` (each local fit: seconds,
    samples/s, steps, batch), ``screen_updates``, ``aggregate_updates``,
    ``atomic_write_json`` (seconds, fsync included, and bytes) and
    ``register_federated_model`` (the gate: seconds, state, report) are
    wrapped; :meth:`take` returns and clears what was recorded."""

    NAMES = ("train_mlp", "screen_updates", "aggregate_updates",
             "atomic_write_json", "register_federated_model")

    def __init__(self):
        from dragonfly2_tpu_torch.trainer import federation

        self._module = federation
        self._events = []

    def _wrap(self, name, original):
        def timed(*args, **kwargs):
            t0 = time.perf_counter()
            out = original(*args, **kwargs)
            if name == "train_mlp":
                # Each fit ends reading its params to the host, so the
                # host clock holds its device work. Its batch is
                # train_mlp's: the config's, clamped to the train split.
                rows, config = len(args[0]), args[2]
                extra = {"samples_per_sec": out.samples_per_sec,
                         "steps": len(out.step_losses), "rows": rows,
                         "batch": min(config.batch_size, rows - int(
                             rows * config.eval_fraction))}
            elif name == "atomic_write_json":
                extra = {"bytes": os.path.getsize(args[0])}
            elif name == "register_federated_model":
                extra = {"state": out.state,
                         "gate": out.evaluation.get("validation")}
            else:
                extra = {}
            self._events.append((name, time.perf_counter() - t0, extra))
            return out
        return timed

    def __enter__(self):
        self._saved = {n: getattr(self._module, n) for n in self.NAMES}
        for n, fn in self._saved.items():
            setattr(self._module, n, self._wrap(n, fn))
        return self

    def __exit__(self, *exc):
        for n, fn in self._saved.items():
            setattr(self._module, n, fn)

    def take(self) -> dict:
        events, self._events = self._events, []
        by = {n: [(s, x) for name, s, x in events if name == n]
              for n in self.NAMES}
        fits = [dict(x, seconds=s,
                     step_ms=(x["batch"] / x["samples_per_sec"] * 1e3
                              if x["samples_per_sec"] else None))
                for s, x in by["train_mlp"]]
        gates = [dict(x, seconds=s)
                 for s, x in by["register_federated_model"]]
        return {
            "fits": fits,
            "fit_seconds": sum(f["seconds"] for f in fits),
            "screen_seconds": sum(s for s, _ in by["screen_updates"]),
            "aggregate_seconds": sum(s for s, _ in by["aggregate_updates"]),
            "journal_writes": len(by["atomic_write_json"]),
            "journal_seconds": sum(s for s, _ in by["atomic_write_json"]),
            "journal_bytes": sum(x["bytes"]
                                 for _, x in by["atomic_write_json"]),
            "gate_seconds": sum(g["seconds"] for g in gates),
            "gate_states": [g["state"] for g in gates],
            "gate_reports": [g["gate"] for g in gates],
        }


def fed4_endpoints(datasets, local, counter_path=None, straggler=None,
                   straggler_delay_s=0.0):
    """One ``LocalClusterEndpoint`` a dataset on the card, each fit
    appended to ``counter_path``; cluster ``straggler`` sleeps
    ``straggler_delay_s`` and then fails its attempt once, so it never
    journals an update in the round it misses."""
    from dragonfly2_tpu_torch.trainer.federation import LocalClusterEndpoint

    return [LocalClusterEndpoint(
        ds, local, counter_path=counter_path,
        **({"delay_s": straggler_delay_s, "fail_times": 1}
           if ds.scheduler_id == straggler else {}))
        for ds in datasets]


def run_federated_config4(torch, counts) -> dict:
    """Config #4 at config #1's scale and widths (FED4_*): three band
    clusters of ~100 000 examples, FedAvg over FED4_ROUNDS rounds at
    quorum 3 through ``FederationCoordinator`` with a gating
    ``ManagerService`` and traces from the eval corpus, on the card. With
    every launch count set to 0 just before and read just after (and the
    profiler's kernel count over the second run) — no kernel may launch
    — it requires: every round committed; a second run on a fresh
    journal with the same global params, bit for bit; a run whose round
    0 first fails quorum (cluster 3 straggles past the deadline, 2
    updates journaled), resumed by a new coordinator that trains only
    cluster 3 (one fit a journaled cluster in the counter file), with
    the same bits again; and the global's pooled-holdout MAE below the
    train-mean predictor's. Logs each round's seconds split into local
    fits, screening, aggregation, journal writes and the gate, with its
    verdict, and peak device memory; when the global activates, serves
    it through ``reload_from_manager`` and ModelInfer. Returns the
    launches."""
    import tempfile

    from dragonfly2_tpu_torch.inference.sidecar import (
        CallContext,
        InferenceService,
        ModelInferRequest,
    )
    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.manager.validation import ValidationConfig
    from dragonfly2_tpu_torch.scheduler.replay import _row_array
    from dragonfly2_tpu_torch.train.fedbench import (
        synth_cluster_corpora,
        synth_federated_corpus,
    )
    from dragonfly2_tpu_torch.train.federated import (
        GLOBAL_SCHEDULER_ID,
        FederatedConfig,
        cluster_datasets_from_corpora,
        tree_leaves,
    )
    from dragonfly2_tpu_torch.train.mlp_trainer import MLPTrainConfig
    from dragonfly2_tpu_torch.trainer.federation import (
        FederationConfig,
        FederationCoordinator,
        FederationQuorumError,
    )

    t0 = time.perf_counter()
    corpora = synth_cluster_corpora(FED4_CLUSTERS, FED4_DECISIONS, seed=SEED)
    datasets = cluster_datasets_from_corpora(corpora)
    eval_events = list(synth_federated_corpus(
        FED_EVAL_DECISIONS, seed=SEED + 7919, band=None).decisions())
    traces = [np.stack([_row_array(c) for c in e.candidates])
              for e in eval_events[:100] if e.candidates]
    data_s = time.perf_counter() - t0
    local = MLPTrainConfig(**FED4_LOCAL_CFG)
    fed = FederatedConfig(local=local, rounds=FED4_ROUNDS)
    tmp = tempfile.mkdtemp(prefix="smoke-fed4-")
    counts.reset()
    torch.cuda.reset_peak_memory_stats()
    try:
        def coordinator(journal, endpoints, deadline_s=60.0):
            manager = ManagerService(
                Database(os.path.join(tmp, f"{journal}.db")),
                FilesystemObjectStore(os.path.join(tmp, f"{journal}-obj")),
                validation=ValidationConfig())
            return FederationCoordinator(
                endpoints, os.path.join(tmp, journal),
                FederationConfig(fed=fed, quorum=FED4_CLUSTERS,
                                 round_deadline_s=deadline_s),
                manager=manager, traces=traces), manager

        # Run 1: clean, timed stage by stage.
        coord, manager = coordinator("clean", fed4_endpoints(datasets, local))
        rounds = []
        with FederationProbe() as probe:
            while coord.stats["rounds_committed"] < FED4_ROUNDS:
                report = coord.run_round()
                rounds.append(dict(report.to_dict(), **probe.take()))
        clean = tree_leaves(coord.global_params)
        result = coord.result()
        # The train-mean predictor: the mean of every cluster's local
        # training targets, scored on the pooled holdout.
        train_y = np.concatenate([ep._train_y for ep in coord.endpoints])
        hold_y = coord.holdout[1]
        mean_mae = float(np.abs(hold_y - train_y.mean()).mean())

        # Run 2: a fresh journal, under the profiler.
        def second_run():
            run = coordinator("again", fed4_endpoints(datasets, local))[0]
            run.run(FED4_ROUNDS)
            return run

        again, profiled = profiled_kernel_launches(torch, second_run)
        same_again = all(np.array_equal(a, b) for a, b in zip(
            clean, tree_leaves(again.global_params)))

        # Run 3: round 0 fails quorum, a new coordinator resumes it.
        fit_s = sorted(f["seconds"] for f in rounds[0]["fits"])
        deadline_s = max(8.0, 5.0 + 3.0 * sum(fit_s[:2]))
        counter = os.path.join(tmp, "fits.txt")
        failing, _ = coordinator("resume", fed4_endpoints(
            datasets, local, counter, straggler=3,
            straggler_delay_s=deadline_s + 1.0), deadline_s)
        t0 = time.perf_counter()
        try:
            failing.run_round()
            raise AssertionError("round 0 committed without cluster 3")
        except FederationQuorumError as exc:
            quorum_error = str(exc)
        failed_s = time.perf_counter() - t0
        drained = failing.drain(timeout=120.0)
        with open(os.path.join(tmp, "resume", "round_000000.json")) as f:
            journaled = sorted(int(s) for s in json.load(f)["updates"])
        resumer, _ = coordinator("resume", fed4_endpoints(
            datasets, local, counter))
        resumed = resumer.run(FED4_ROUNDS)
        with open(counter) as f:
            fits = [tuple(map(int, line.split())) for line in f]
        round0_fits = {sid: sum(1 for s, r in fits if s == sid and r == 0)
                       for sid in (1, 2, 3)}
        same_resumed = all(np.array_equal(a, b) for a, b in zip(
            clean, tree_leaves(resumer.global_params)))
        launches = counts.read()
        peak_gib = torch.cuda.max_memory_allocated() / 2**30

        active = manager.get_active_model("mlp", GLOBAL_SCHEDULER_ID)
        served = None
        if active is not None:
            service = InferenceService(manager=manager,
                                       scheduler_id=GLOBAL_SCHEDULER_ID,
                                       micro_batch=False)
            try:
                if not service.reload_from_manager():
                    raise AssertionError("reload_from_manager installed "
                                         "nothing")
                scores = service.ModelInfer(
                    ModelInferRequest("mlp", traces[0]),
                    CallContext()).outputs
            finally:
                service.stop()
            if not (scores.shape == (len(traces[0]),)
                    and np.isfinite(scores).all()):
                raise AssertionError(f"federated global scores {scores}")
            served = {"version": active.version,
                      "scores": [float(v) for v in scores]}
        log("federated_config4", data_seconds=data_s,
            examples={d.scheduler_id: len(d.X) for d in datasets},
            holdout_rows=len(hold_y), train_rows=len(train_y),
            local=dict(FED4_LOCAL_CFG, hidden=list(local.hidden)),
            rounds=rounds, lineage=result.lineage,
            holdout_mse=result.mse, holdout_mae=result.mae,
            train_mean_mae=mean_mae, bit_identical_again=same_again,
            quorum_failure={"deadline_s": deadline_s, "seconds": failed_s,
                            "error": quorum_error, "journaled": journaled,
                            "drained": drained,
                            "resumed": resumed[0].resumed,
                            "received": resumed[0].received,
                            "round0_fits": round0_fits,
                            "rounds_committed": len(resumed)},
            bit_identical_resumed=same_resumed, served=served,
            launches=launches, profiled_launches=profiled["launches"],
            profiled_device_events=profiled["device_events"],
            peak_memory_gib=peak_gib)
        if not all(r["committed"] for r in rounds) or len(rounds) != \
                FED4_ROUNDS:
            raise AssertionError(f"config #4 rounds {rounds}")
        if not same_again:
            raise AssertionError("config #4: a second run on a fresh "
                                 "journal gave other global params")
        if not (drained and journaled == [1, 2]
                and resumed[0].resumed == [1, 2]
                and round0_fits == {1: 1, 2: 1, 3: 1}
                and len(resumed) == FED4_ROUNDS and same_resumed):
            raise AssertionError("config #4 quorum failure and resume: "
                                 f"journaled {journaled}, drained {drained},"
                                 f" resumed {resumed[0].to_dict()}, round 0 "
                                 f"fits {round0_fits}, same bits "
                                 f"{same_resumed}")
        if not result.mae < mean_mae:
            raise AssertionError(f"config #4 global holdout MAE "
                                 f"{result.mae} >= train-mean {mean_mae}")
        if any(launches.values()) or any(profiled["launches"].values()):
            raise AssertionError(f"config #4 launched kernels: {launches}, "
                                 f"profiled {profiled['launches']}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


def dp_configs() -> dict:
    """The data-parallel phases' jobs: config #2 (both sampling paths)
    and config #1 as their phases train them, config #3 cut to one epoch
    at WORLD_GAT_BATCH (29 steps, as the ring and TP worlds train it),
    each without a wall-clock cap (a cap would add a collective a step:
    the ranks must agree when to stop)."""
    from dragonfly2_tpu_torch.train.gat_trainer import GATTrainConfig
    from dragonfly2_tpu_torch.train.gnn_trainer import GNNTrainConfig
    from dragonfly2_tpu_torch.train.mlp_trainer import MLPTrainConfig

    gnn = dict(GNN_CFG, max_seconds=None)
    gat = dict(TRAIN_CFG, epochs=DP_GAT_EPOCHS,
               edge_batch_size=WORLD_GAT_BATCH, max_seconds=None)
    return {
        "gnn_device": ("gnn", GNNTrainConfig(**gnn, device_sample=True)),
        "gnn_host": ("gnn", GNNTrainConfig(**gnn, device_sample=False)),
        "mlp": ("mlp", MLPTrainConfig(**dict(MLP_CFG, max_seconds=None))),
        "gat_blocks": ("gat", GATTrainConfig(**gat, attention="blocks")),
        "gat_gather": ("gat", GATTrainConfig(**gat, attention="gather")),
    }


def dp_data(kind: str):
    """The seeded inputs of a job: config #2's graph, config #1's pair
    examples or config #3's graph."""
    from dragonfly2_tpu_torch.data import SyntheticCluster

    if kind == "gnn":
        return SyntheticCluster(n_hosts=GNN_HOSTS, seed=SEED).probe_graph(
            GNN_EDGES)
    if kind == "mlp":
        return SyntheticCluster(n_hosts=MLP_HOSTS, seed=SEED
                                ).pair_example_columns(MLP_ROWS)
    return SyntheticCluster(n_hosts=N_HOSTS, seed=SEED).probe_graph(N_EDGES)


def dp_fit(kind: str, config, data, group):
    """One job's trainer (the body of ``train_gnn`` / ``train_mlp`` /
    ``train_gat``) over ``group`` → (trainer, result, state dict, the
    kernel launches one rank must make)."""
    from dragonfly2_tpu_torch.train.checkpoint import mlp_state_dict_from_flax
    from dragonfly2_tpu_torch.train.gat_trainer import GATTrainer
    from dragonfly2_tpu_torch.train.gnn_trainer import GNNTrainer
    from dragonfly2_tpu_torch.train.metrics import padded_chunks
    from dragonfly2_tpu_torch.train.mlp_trainer import MLPTrainer

    expected = dict.fromkeys(Counts().read(), 0)
    if kind == "mlp":
        trainer = MLPTrainer(*data, config, group=group)
        result = trainer.fit()
        return (trainer, result, mlp_state_dict_from_flax(result.params),
                expected)
    cls = GNNTrainer if kind == "gnn" else GATTrainer
    trainer = cls(data, config, group=group)
    result = trainer.fit()
    steps = len(result.step_losses)
    chunks = len(list(padded_chunks(trainer.eval_ids, trainer.batch)))
    if kind == "gnn":
        # One K2a a forward on each rank, over its share of the rows.
        expected["table_gather"] = steps + chunks
    elif config.attention == "blocks":
        # Every rank runs the embedding pass of its rows.
        expected["graph_flash_attention"] = config.layers * (steps + chunks)
        expected["graph_flash_attention_backward"] = config.layers * steps
    else:
        expected["table_gather"] = config.layers * (steps + chunks)
        expected["table_scatter_add"] = config.layers * steps
    return trainer, result, result.state_dict, expected


def dp_quality(kind: str, result) -> dict:
    key = "mae" if kind == "mlp" else "f1"
    return {"loss": float(result.history[-1]), key: float(getattr(result,
                                                                  key))}


def dp_allreduce_ms(torch, trainer) -> float:
    """Milliseconds of the trainer's per-step all-reduce (every gradient
    and the loss in one buffer) on the trained model's gradients, over
    DP_ALLREDUCE_ITERS calls, each rank calling alike."""
    params = list(trainer.model.parameters())
    loss = torch.zeros((), device=trainer.device)
    for _ in range(3):
        trainer.dp.allreduce_grads_(params, loss)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(DP_ALLREDUCE_ITERS):
        trainer.dp.allreduce_grads_(params, loss)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) / DP_ALLREDUCE_ITERS * 1e3


def dp_rank(rank: int, world: int, address: str, backend: str,
            out_dir: str, segments: str, predicted: dict) -> None:
    """One rank of the dp_train phase (a spawned process): joins the
    fleet with ``init_multihost`` (its device cuda:(rank % cards)),
    checks all_reduce and broadcast on one CUDA tensor, then trains every
    job of :func:`dp_configs` and ``Training.train`` over the default
    group, each with the launch counts set to 0 just before and read
    just after. Writes ``rank<rank>.json`` to ``out_dir`` (a traceback to
    ``rank<rank>.err``)."""
    import traceback

    try:
        report = dp_rank_jobs(rank, world, address, backend, segments,
                              predicted)
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(report, fh)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def dp_rank_jobs(rank, world, address, backend, segments, predicted) -> dict:
    import torch
    import torch.distributed as dist

    from dragonfly2_tpu_torch.manager import (
        Database,
        FilesystemObjectStore,
        ManagerService,
    )
    from dragonfly2_tpu_torch.manager.validation import ValidationConfig
    from dragonfly2_tpu_torch.parallel.dryrun import state_digest
    from dragonfly2_tpu_torch.parallel.multihost import agree, init_multihost
    from dragonfly2_tpu_torch.trainer import TrainerStorage, Training

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    info = init_multihost(address, world, rank, backend=backend)
    report = {"rank": rank, "backend": info.backend,
              "device": str(info.device),
              "start_seconds": time.perf_counter() - t_start}
    try:
        # gloo stages CUDA tensors through the host: one tensor each way.
        summed = torch.full((4,), float(rank + 1), device=info.device)
        dist.all_reduce(summed)
        sent = torch.full((4,), float(rank + 7), device=info.device)
        dist.broadcast(sent, src=0)
        torch.cuda.synchronize()
        report["collective_check"] = {
            "all_reduce": summed.tolist(), "broadcast": sent.tolist(),
            "ok": bool((summed == world * (world + 1) / 2).all()
                       and (sent == 7).all())}
        if not report["collective_check"]["ok"]:
            raise AssertionError(f"collectives on CUDA tensors: "
                                 f"{report['collective_check']}")
        counts = Counts()
        data = {}
        for name, (kind, config) in dp_configs().items():
            if kind not in data:
                data[kind] = dp_data(kind)
            counts.reset()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            trainer, result, state, expected = dp_fit(kind, config,
                                                      data[kind], None)
            torch.cuda.synchronize()
            seconds = time.perf_counter() - t0
            launches = counts.read()
            digests = agree(state_digest(state)).ravel().tolist()
            step_ms = trainer.batch / result.samples_per_sec * 1e3
            allreduce_ms = dp_allreduce_ms(torch, trainer)
            report[name] = dict(
                seconds=seconds, steps=len(result.step_losses),
                batch=trainer.batch, history=result.history,
                **dp_quality(kind, result), digests=digests,
                launches=launches, expected_launches=expected,
                step_ms=step_ms,
                samples_per_sec_global=result.samples_per_sec,
                samples_per_sec_per_rank=result.samples_per_sec / world,
                allreduce_ms=allreduce_ms,
                allreduce_share=allreduce_ms / step_ms,
                allreduce_bytes=4 * (1 + sum(
                    p.numel() for p in trainer.model.parameters())),
                peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
            del trainer, result, state
        del data

        # The orchestrator on the training phase's records, each rank on
        # its own copy of the segments; rank 0 alone uploads.
        root = f"{segments}-rank{rank}"
        shutil.copytree(segments, os.path.join(root, "segments"))
        try:
            storage = TrainerStorage(os.path.join(root, "segments"))
            manager = ManagerService(
                Database(os.path.join(root, "manager.db")),
                FilesystemObjectStore(os.path.join(root, "objects")),
                validation=ValidationConfig())
            metrics = JobMetrics()
            counts.reset()
            torch.cuda.reset_peak_memory_stats()
            t0 = time.perf_counter()
            outcome = Training(storage, manager, training_config(),
                               metrics=metrics, group=None).train(
                TRAINING_IP, TRAINING_HOSTNAME, TRAINING_HOST_ID,
                TRAINING_SCHEDULER_ID)
            torch.cuda.synchronize()
            expected = dict(predicted)
            if rank != 0:
                # The gate's embedding pass runs where the upload goes.
                expected["graph_flash_attention"] -= training_config(
                    ).gat.layers
            rows = manager.db.find("models",
                                   scheduler_id=TRAINING_SCHEDULER_ID)
            report["training"] = dict(
                seconds=time.perf_counter() - t0, errors=outcome.errors,
                evaluations={job: getattr(outcome, f"{job}_evaluation")
                             for job in ("gnn", "gat", "mlp", "cost")},
                job_seconds=dict(metrics.training_duration),
                samples_per_sec_global=dict(metrics.train_samples_per_sec),
                registered=sorted((r.type, r.state) for r in rows),
                launches=counts.read(), expected_launches=expected,
                peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30)
        finally:
            shutil.rmtree(root, ignore_errors=True)
    finally:
        dist.destroy_process_group()
    return report


def dp_world_one_child(address: str, out_path: str) -> None:
    """The dp_world_one phase's process: a world of one joined through the
    ``DF2_*`` environment over NCCL on cuda:0, training config #2
    GraphSAGE (sampling on the device) over it; saves the state dict to
    ``out_path``."""
    import torch

    from dragonfly2_tpu_torch.parallel.multihost import init_multihost

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    os.environ.update(DF2_COORDINATOR_ADDRESS=address, DF2_NUM_PROCESSES="1",
                      DF2_PROCESS_ID="0")
    info = init_multihost()
    import torch.distributed as dist

    try:
        kind, config = dp_configs()["gnn_device"]
        _, result, state, _ = dp_fit(kind, config, dp_data(kind), None)
        torch.save({"state": state, "backend": info.backend,
                    "history": result.history}, out_path)
    finally:
        dist.destroy_process_group()


def release_card_memory(torch) -> float:
    """Return this process's cached device memory to the card before
    ranks that share it start (the earlier phases leave tens of GB
    reserved in the caching allocator); returns the GiB still reserved."""
    import gc

    gc.collect()
    torch.cuda.empty_cache()
    return torch.cuda.memory_reserved() / 2**30


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("localhost", 0))
        return sock.getsockname()[1]


def start_processes(targets) -> list:
    """Start each (function, args) in a spawned process."""
    import multiprocessing as mp

    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=fn, args=args) for fn, args in targets]
    for proc in procs:
        proc.start()
    return procs


def join_processes(procs, timeout_s: float, out_dir: str) -> None:
    """Wait for ``procs`` within ``timeout_s``, terminate what is left, and
    raise with each failed process's traceback (``rank<i>.err`` under
    ``out_dir``)."""
    deadline = time.monotonic() + timeout_s
    for proc in procs:
        proc.join(max(0.0, deadline - time.monotonic()))
    hung = [i for i, proc in enumerate(procs) if proc.is_alive()]
    for proc in procs:
        if proc.is_alive():
            proc.terminate()
            proc.join(10)
        if proc.is_alive():
            proc.kill()
            proc.join()
    failed = {}
    for i, proc in enumerate(procs):
        if proc.exitcode != 0:
            err = os.path.join(out_dir, f"rank{i}.err")
            failed[i] = (open(err).read()[-4000:] if os.path.exists(err)
                         else f"exit code {proc.exitcode}")
    if hung or failed:
        raise AssertionError(f"processes hung {hung} or failed {failed}")


def run_data_parallel(torch, mlp_x, mlp_y, training_ref) -> dict:
    """Data parallelism, slice 13's path (the JAX mesh's ``data`` axis).

    dp_world_one: a child process joins a world of one over NCCL through
    ``init_multihost`` and trains config #2 GraphSAGE; its parameters
    must equal the same run's without a process group (here) bit for
    bit (its seconds include this process's reference runs beside it). dp_train: DP_WORLD ranks spawned once on cuda:0 over gloo (NCCL
    refuses two ranks on one card) train every job of :func:`dp_configs`
    and ``Training.train`` (:func:`dp_train`). dp_nccl_cards: the same
    over NCCL with a rank a card where the machine has several cards;
    with one it is logged as waiting. Returns rank 0's launches in
    dp_train, summed over its jobs."""
    import tempfile

    from dragonfly2_tpu_torch.trainer import TrainerStorage

    tmp = tempfile.mkdtemp(prefix="smoke-dp-")
    try:
        # dp_world_one's child (NCCL, one rank) runs while this process
        # trains the world-of-one references (no process group) and
        # writes the training records; the card's numerics do not depend
        # on who else runs on it.
        t0 = time.perf_counter()
        parent_gib = release_card_memory(torch)
        out_path = os.path.join(tmp, "world_one.pt")
        child = start_processes([(dp_world_one_child,
                                  (f"localhost:{free_port()}", out_path))])
        reference, state_one = {}, None
        for name, (kind, config) in dp_configs().items():
            trainer, result, state, _ = dp_fit(kind, config, dp_data(kind),
                                               None)
            reference[name] = dp_quality(kind, result)
            if name == "gnn_device":
                state_one = {k: v.clone() for k, v in state.items()}
            del trainer, result, state
        reference["training"] = training_ref["evaluations"]
        segments = os.path.join(tmp, "segments")
        write_training_segments(TrainerStorage(segments), mlp_x, mlp_y, tmp,
                                {})
        join_processes(child, DP_TIMEOUT_S, tmp)
        one = torch.load(out_path)
        gaps = {k: float((one["state"][k].float()
                          - state_one[k].float()).abs().max())
                for k in state_one}
        log("dp_world_one", seconds=time.perf_counter() - t0,
            parent_reserved_gib=parent_gib,
            backend=one["backend"], max_abs_gap=max(gaps.values()),
            bit_equal=all(torch.equal(one["state"][k], state_one[k])
                          for k in state_one),
            history=one["history"])
        if not all(torch.equal(one["state"][k], state_one[k])
                   for k in state_one):
            raise AssertionError(f"dp_world_one: a world of one over NCCL "
                                 f"is not the no-group run: {gaps}")

        ranks = dp_train(torch, "dp_train", "gloo", DP_WORLD, tmp, segments,
                         training_ref["predicted"], reference)
        cards = torch.cuda.device_count()
        if cards > 1:
            dp_train(torch, "dp_nccl_cards", "nccl", cards, tmp, segments,
                     training_ref["predicted"], reference)
        else:
            log("dp_nccl_cards", cards=cards)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    launches = dict.fromkeys(ranks[0]["training"]["launches"], 0)
    for name in list(dp_configs()) + ["training"]:
        for row, n in ranks[0][name]["launches"].items():
            launches[row] += n
    return launches


def dp_train(torch, phase: str, backend: str, world: int, tmp: str,
             segments: str, predicted: dict, reference: dict) -> list:
    """``world`` ranks over ``backend``, spawned once (:func:`dp_rank`):
    both ranks' parameter digests equal, each job's gaps to its
    world-of-one run (``reference``; the training phase's evaluations for
    ``Training.train``) within DP_LOSS_TOL / DP_F1_TOL / DP_MAE_RTOL, each
    rank's launches as predicted, rank 0 alone uploading; logs the step,
    the all-reduce's time and share of it, samples/s and peak memory of
    each rank as ``phase``. Returns the ranks' reports."""
    out_dir = os.path.join(tmp, phase)
    os.makedirs(out_dir)
    parent_gib = release_card_memory(torch)
    t0 = time.perf_counter()
    address = f"localhost:{free_port()}"
    join_processes(start_processes(
        [(dp_rank, (rank, world, address, backend, out_dir, segments,
                    predicted)) for rank in range(world)]),
        DP_TIMEOUT_S, out_dir)
    ranks = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as fh:
            ranks.append(json.load(fh))
    seconds = time.perf_counter() - t0

    failures, jobs = [], {}
    for name, (kind, _) in dp_configs().items():
        per_rank = [r[name] for r in ranks]
        key = "mae" if kind == "mlp" else "f1"
        ref = reference[name]
        gaps = {"loss": abs(per_rank[0]["loss"] - ref["loss"]),
                key: abs(per_rank[0][key] - ref[key])}
        tol = {"loss": DP_LOSS_TOL[kind],
               key: (DP_MAE_RTOL * ref[key] if kind == "mlp"
                     else DP_F1_TOL[kind])}
        jobs[name] = {"world_one": ref, "gaps": gaps, "tol": tol,
                      "ranks": per_rank}
        if len({d for r in per_rank for d in r["digests"]}) != 1:
            failures.append(f"{name}: digests {per_rank[0]['digests']}")
        if any(gaps[k] > tol[k] for k in gaps):
            failures.append(f"{name}: gaps {gaps} over {tol}")
        for r in per_rank:
            if r["launches"] != r["expected_launches"]:
                failures.append(f"{name}: launches {r['launches']} != "
                                f"{r['expected_launches']}")
    training = [r["training"] for r in ranks]
    t_gaps = {}
    for job, key in (("gnn", "f1"), ("gat", "f1"), ("mlp", "mae")):
        got = training[0]["evaluations"][job][key]
        want = reference["training"][job][key]
        t_gaps[job] = abs(got - want)
        tol = DP_MAE_RTOL * want if key == "mae" else DP_F1_TOL[job]
        if t_gaps[job] > tol:
            failures.append(f"training {job}: {key} {got} vs {want}")
    for r in training:
        if r["errors"] or r["launches"] != r["expected_launches"]:
            failures.append(f"training: errors {r['errors']}, launches "
                            f"{r['launches']} != {r['expected_launches']}")
    if len(training[0]["registered"]) != 4 or any(
            r["registered"] for r in training[1:]):
        failures.append(f"training uploads "
                        f"{[r['registered'] for r in training]}")
    if any(r["evaluations"] != training[0]["evaluations"]
           for r in training[1:]):
        failures.append("training: the ranks' evaluations differ")
    where = "one card" if backend == "gloo" else f"{world} cards"
    log(phase, label=f"{backend}, {world} ranks on {where}", seconds=seconds,
        world=world, parent_reserved_gib=parent_gib,
        collective_check=[r["collective_check"] for r in ranks],
        start_seconds=[r["start_seconds"] for r in ranks], jobs=jobs,
        training={"ranks": training, "world_one": reference["training"],
                  "gaps": t_gaps})
    if failures:
        raise AssertionError(f"{phase}: {failures}")
    return ranks


# -- sequence, pipeline and expert parallelism, slice 15 ---------------------

# The card every rank of these phases works on (rank r: cuda:(r % cards)
# through init_multihost; a world of one: the current card).
CARD = "cuda"
# Ranks of the gloo world that shares the one card, and how long its
# processes may take (graph build, one config #3 epoch, the two layouts).
PAR_WORLD = 2
PAR_TIMEOUT_S = 600
# Ring attention at the Ulysses cell's widths (8 heads of 8, causal, bf16)
# over T = 8192, with the last 5 % of keys masked out by kv_valid; one
# world-of-one score tensor is [8, 8192, 8192] f32, 2.15 GB.
RING_ATT_T, RING_ATT_HEADS, RING_ATT_DIM = 8192, 8, 8
RING_ATT_MASKED = 0.05
# Ring attention against plain f32 attention, row by row (k3_errors). The
# JAX algebra rounds each score block to bf16 before its f32 softmax and
# p to bf16 before P·V (K3 keeps f32 scores, hence K3_TOL is tighter),
# and the backward's products take bf16 operands. Measured worst on an
# H100 (world 1, PERF.md): out 0.045, gradients 0.063; a run that drops
# one key in 512 or ignores kv_valid gives row errors of 1 and more
# (tests/ring_attention_tolerance.py).
RING_ATT_TOL = {"out": 0.1, "grad": 0.15}
# A rank's score blocks are [T/d, T/d] a head: at d = 2 a quarter of the
# world of one's, so the forward's peak above its inputs must stay under
# this share of the world of one's (ring_attention.py:7-9's O((T/d)²)).
RING_ATT_MEMORY_SHARE = 0.35
# The pipeline and the experts at config #3's hidden width over its
# padded rows, with the dry-run twin's tanh(x @ w) stage and expert; M
# microbatches; capacity factors with nothing dropped and the Switch
# default, the gates skewed toward expert 0 so that the default drops.
PIPE_ROWS, PIPE_WIDTH, PIPE_MICRO = 20_480, 128, 8
MOE_FACTORS = (8.0, 1.25)
MOE_SKEW = 1.0
# f32 products with TF32 off, against plain references on the card: each
# tensor's max |got − ref| over its max |ref|.
PAR_F32_TOL = 1e-4


def ring_gat_config():
    """Config #3 in ring mode cut to one epoch at WORLD_GAT_BATCH (29
    steps), with no wall-clock cap."""
    from dragonfly2_tpu_torch.train.gat_trainer import GATTrainConfig

    return GATTrainConfig(**dict(TRAIN_CFG, epochs=DP_GAT_EPOCHS,
                                 edge_batch_size=WORLD_GAT_BATCH,
                                 max_seconds=None, attention="ring"))


def rel_err(got, ref) -> float:
    """max |got − ref| over max |ref| (f32)."""
    ref = ref.float()
    return float((got.float() - ref).abs().max()
                 / ref.abs().max().clamp_min(1e-30))


def par_ring_gat(torch, graph, rank: int, world: int, counts,
                 out_dir: str) -> dict:
    """Config #3 in ring mode over the default group (``GATTrainer.fit``,
    the body of ``train_gat``) with the launch and exchange counts set to
    0 just before and read just after; then the trained model's
    embeddings of every row (gathered from the ranks) and its scores of
    seeded pairs. Rank 0 writes the artifact, the embeddings and the
    scores to ``out_dir``."""
    import torch.distributed as dist

    from dragonfly2_tpu_torch.parallel.dryrun import state_digest
    from dragonfly2_tpu_torch.parallel.mesh import (
        EXCHANGES,
        all_gather_rows,
        ring_shift,
    )
    from dragonfly2_tpu_torch.parallel.multihost import agree
    from dragonfly2_tpu_torch.train.checkpoint import gat_artifact_from_result
    from dragonfly2_tpu_torch.train.gat_trainer import GATTrainer
    from dragonfly2_tpu_torch.train.metrics import padded_chunks

    cfg = ring_gat_config()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    EXCHANGES.reset()
    t0 = time.perf_counter()
    trainer = GATTrainer(graph, cfg)
    result = trainer.fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, exchanges = counts.read(), EXCHANGES.read()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = len(result.step_losses)
    chunks = len(list(padded_chunks(trainer.eval_ids, trainer.batch)))
    rows, n_loc = trainer.nbr.shape[0], trainer.g_nbr.shape[0]
    # What the path must exchange: a hop of K and V a layer a ring step
    # but the last, forward and backward, in train steps and eval
    # chunks; the embedding table gathered a forward, scattered back a
    # backward; under gloo each through pinned host memory both ways.
    hops = cfg.layers * (world - 1) * (2 * steps + chunks)
    kv_bytes = 2 * n_loc * cfg.hidden * 2                  # bf16 K and V
    emb_bytes = n_loc * cfg.embed * 2
    expected = dict.fromkeys(exchanges, 0)
    if world > 1:
        expected.update(ring_shift=hops, all_gather=steps + chunks,
                        reduce_scatter=steps)
        if dist.get_backend() == "gloo" and trainer.device.type != "cpu":
            expected["staged_bytes"] = (
                hops * 2 * kv_bytes
                + (steps + chunks) * (1 + world) * emb_bytes
                + steps * 2 * rows * cfg.embed * 4)
    step_ms = trainer.batch / result.samples_per_sec * 1e3
    digests = agree(state_digest(result.state_dict)).ravel().tolist()

    pairs = np.random.default_rng(SEED + 7).integers(0, graph.n_nodes,
                                                     (64, 2))
    trainer.model.eval()
    with torch.no_grad():
        emb = trainer.model.node_embeddings(trainer.g_feat, trainer.g_nbr,
                                            trainer.g_val)
        if trainer.sharded:
            emb = all_gather_rows(emb)
        src, dst = torch.from_numpy(pairs.astype(np.int32)).to(CARD).T
        scores = trainer.model.score_pairs(emb, src, dst).float()
        # One hop of the trained K/V shapes, timed (ranks in step).
        kv = torch.zeros(2, n_loc, cfg.hidden, dtype=torch.bfloat16,
                         device=CARD)
        hop_ms = (cuda_ms(torch, lambda: ring_shift((kv[0], kv[1])),
                          iters=10, warmup=2) if world > 1 else 0.0)
    if rank == 0:
        torch.save({"artifact": gat_artifact_from_result(
                        result, graph, f"smoke-ring-{world}"),
                    "emb": emb.float().cpu(), "scores": scores.cpu(),
                    "pairs": pairs},
                   os.path.join(out_dir, f"ring_gat_world{world}.pt"))
    return dict(seconds=seconds, steps=steps, eval_chunks=chunks,
                batch=trainer.batch, rows=rows, rows_per_rank=n_loc,
                sharded=trainer.sharded, history=result.history,
                step_losses_first_last=[result.step_losses[0],
                                        result.step_losses[-1]],
                f1=result.f1, accuracy=result.accuracy, digests=digests,
                launches=launches, exchanges=exchanges,
                expected_exchanges=expected, step_ms=step_ms,
                samples_per_sec_global=result.samples_per_sec,
                hop_ms=hop_ms, hop_bytes=kv_bytes,
                peak_memory_gib=peak_gib)


def ring_att_inputs(torch):
    """The ring-attention phase's seeded q, k, v and cotangent ([T, 8, 8]
    bf16, made on the card) and its key-valid mask."""
    gen = torch.Generator(device=CARD).manual_seed(SEED + 5)
    shape = (RING_ATT_T, RING_ATT_HEADS, RING_ATT_DIM)
    q, k, v, dout = (torch.randn(shape, generator=gen, device=CARD).to(
        torch.bfloat16) for _ in range(4))
    valid = torch.arange(RING_ATT_T, device=CARD) < int(
        RING_ATT_T * (1 - RING_ATT_MASKED))
    return q, k, v, dout, valid


def par_ring_attention(torch, rank: int, world: int, counts,
                       out_dir: str) -> dict:
    """``ring_attention`` on this rank's rows: the forward's peak memory
    above its inputs under ``no_grad``; the forward and backward with the
    launch and exchange counts set to 0 just before and read just after;
    the forward and forward + backward times. Saves the rank's out and
    gradients to ``out_dir``."""
    from dragonfly2_tpu_torch.parallel import ring_attention
    from dragonfly2_tpu_torch.parallel.mesh import EXCHANGES

    full_q, full_k, full_v, full_dout, full_valid = ring_att_inputs(torch)
    rows = slice(rank * RING_ATT_T // world, (rank + 1) * RING_ATT_T // world)
    q, k, v = (x[rows].clone().requires_grad_()
               for x in (full_q, full_k, full_v))
    dout, valid = full_dout[rows].clone(), full_valid[rows].clone()
    del full_q, full_k, full_v, full_dout, full_valid

    def forward():
        return ring_attention(q, k, v, causal=True, kv_valid=valid)

    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    with torch.no_grad():
        forward()
    torch.cuda.synchronize()
    peak_above = torch.cuda.max_memory_allocated() - base
    counts.reset()
    EXCHANGES.reset()
    out = forward()
    out.backward(dout)
    torch.cuda.synchronize()
    launches, exchanges = counts.read(), EXCHANGES.read()
    with torch.no_grad():
        fwd_ms = cuda_ms(torch, forward, iters=5, warmup=1)

    def fwd_bwd():
        torch.autograd.grad(forward(), (q, k, v), dout)

    fwd_bwd_ms = cuda_ms(torch, fwd_bwd, iters=3, warmup=1)
    torch.save({"out": out.detach().cpu(), "dq": q.grad.cpu(),
                "dk": k.grad.cpu(), "dv": v.grad.cpu()},
               os.path.join(out_dir, f"ring_att_world{world}_rank{rank}.pt"))
    return dict(shape=[RING_ATT_T, RING_ATT_HEADS, RING_ATT_DIM],
                rows_per_rank=rows.stop - rows.start, launches=launches,
                exchanges=exchanges, fwd_ms=fwd_ms, fwd_bwd_ms=fwd_bwd_ms,
                peak_above_inputs_gib=peak_above / 2**30)


def tanh_stage(params, x):
    """The dry-run twin's stage and expert."""
    import torch

    return torch.tanh(x @ params["w"])


def pipe_moe_inputs(torch, world: int) -> dict:
    """Seeded f32 inputs on the card: ``world`` stacked stage and expert
    weights [world, 128, 128], rows [20480, 128], their cotangent, and
    gate logits [20480, world] skewed toward expert 0."""
    gen = torch.Generator(device=CARD).manual_seed(SEED + 6)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device=CARD)

    scale = PIPE_WIDTH ** -0.5
    gates = randn(PIPE_ROWS, world)
    gates[:, 0] += MOE_SKEW
    return {"stages": randn(world, PIPE_WIDTH, PIPE_WIDTH) * scale,
            "experts": randn(world, PIPE_WIDTH, PIPE_WIDTH) * scale,
            "x": randn(PIPE_ROWS, PIPE_WIDTH),
            "dout": randn(PIPE_ROWS, PIPE_WIDTH), "gates": gates}


def par_pipeline_moe(torch, rank: int, world: int, counts,
                     out_dir: str) -> dict:
    """``pipeline_apply`` (M microbatches, a stage a rank) and
    ``moe_apply`` (an expert a rank, this rank's tokens) forward and
    backward with the launch and exchange counts set to 0 just before
    and read just after each, and their times. Saves what the rank holds
    (outputs, its stage's and expert's weight gradients, x's and its
    gates' gradients) to ``out_dir``."""
    from dragonfly2_tpu_torch.parallel import moe_apply, pipeline_apply
    from dragonfly2_tpu_torch.parallel.mesh import EXCHANGES

    inputs = pipe_moe_inputs(torch, world)
    report, saved = {}, {}
    stages = {"w": inputs["stages"].clone().requires_grad_()}
    x = inputs["x"].clone().requires_grad_()

    def pipe():
        return pipeline_apply(tanh_stage, stages, x, microbatches=PIPE_MICRO)

    counts.reset()
    EXCHANGES.reset()
    out = pipe()
    out.backward(inputs["dout"])
    torch.cuda.synchronize()
    report["pipeline"] = dict(
        launches=counts.read(), exchanges=EXCHANGES.read(),
        fwd_ms=cuda_ms(torch, pipe, iters=5, warmup=1),
        fwd_bwd_ms=cuda_ms(torch, lambda: torch.autograd.grad(
            pipe(), (stages["w"], x), inputs["dout"]), iters=3, warmup=1))
    saved["pipeline"] = {"out": out.detach().cpu(),
                         "dw": stages["w"].grad[rank].cpu(),
                         "dx": x.grad.cpu()}

    tokens = slice(rank * PIPE_ROWS // world, (rank + 1) * PIPE_ROWS // world)
    x_mine, dout_mine = inputs["x"][tokens], inputs["dout"][tokens]
    for factor in MOE_FACTORS:
        experts = {"w": inputs["experts"].clone().requires_grad_()}
        gates = inputs["gates"][tokens].clone().requires_grad_()

        def moe():
            return moe_apply(tanh_stage, experts, x_mine, gates,
                             capacity_factor=factor)

        counts.reset()
        EXCHANGES.reset()
        out = moe()
        out.backward(dout_mine)
        torch.cuda.synchronize()
        report[f"moe_{factor}"] = dict(
            launches=counts.read(), exchanges=EXCHANGES.read(),
            dropped=int((out == 0).all(-1).sum()),
            fwd_ms=cuda_ms(torch, moe, iters=5, warmup=1),
            fwd_bwd_ms=cuda_ms(torch, lambda: torch.autograd.grad(
                moe(), (experts["w"], gates), dout_mine), iters=3,
                warmup=1))
        saved[f"moe_{factor}"] = {"out": out.detach().cpu(),
                                  "dw": experts["w"].grad[rank].cpu(),
                                  "dgates": gates.grad.cpu()}
    torch.save(saved, os.path.join(out_dir,
                                   f"pipe_moe_world{world}_rank{rank}.pt"))
    return report


def par_phases(torch, graph, rank: int, world: int, out_dir: str) -> dict:
    """The three paths on this rank, in one process: ring-mode config #3,
    ring attention, the pipeline and the experts."""
    counts, report = Counts(), {}
    for name, run, args in (
            ("ring_gat", par_ring_gat, (graph, rank, world)),
            ("ring_attention", par_ring_attention, (rank, world)),
            ("pipeline_moe", par_pipeline_moe, (rank, world))):
        t0 = time.perf_counter()
        report[name] = run(torch, *args, counts, out_dir)
        report[f"{name}_seconds"] = time.perf_counter() - t0
    return report


def par_rank(rank: int, world: int, address: str, backend: str,
             out_dir: str) -> None:
    """One rank of the parallel phases (a spawned process): joins the
    fleet with ``init_multihost`` (its device cuda:(rank % cards)), builds
    config #3's graph and runs :func:`par_phases`. Writes
    ``rank<rank>.json`` to ``out_dir`` (a traceback to
    ``rank<rank>.err``)."""
    import traceback

    import torch
    import torch.distributed as dist

    from dragonfly2_tpu_torch.parallel.multihost import init_multihost

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        info = init_multihost(address, world, rank, backend=backend)
        report = {"rank": rank, "backend": info.backend,
                  "device": str(info.device),
                  "start_seconds": time.perf_counter() - t0}
        try:
            t0 = time.perf_counter()
            graph = dp_data("gat")
            report["graph_seconds"] = time.perf_counter() - t0
            report.update(par_phases(torch, graph, rank, world, out_dir))
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(report, fh)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def par_world_one(torch, graph, out_dir: str) -> dict:
    """:func:`par_phases` in this process in a one-rank NCCL group: ring
    mode there is the world of one's K1 path, and the layouts make no
    exchange."""
    import torch.distributed as dist

    dist.init_process_group("nccl", init_method=f"file://{out_dir}/store1",
                            world_size=1, rank=0)
    try:
        return par_phases(torch, graph, 0, 1, out_dir)
    finally:
        dist.destroy_process_group()


def dense_attention(torch, q, k, v, causal: bool, valid):
    """Plain softmax attention in f32 over [T, h, d], keys masked by
    ``valid`` (and the causal triangle)."""
    q, k, v = (x.float() for x in (q, k, v))
    s = torch.einsum("nhd,mhd->hnm", q, k) * q.shape[-1] ** -0.5
    t = q.shape[0]
    mask = valid[None, None, :]
    if causal:
        mask = mask & torch.ones(t, t, dtype=torch.bool,
                                 device=q.device).tril()[None]
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), dim=-1)
    return torch.einsum("hnm,mhd->nhd", p, v)


def check_ring_attention(torch, world: int, out_dir: str) -> dict:
    """The ranks' ring-attention shards put together, out and gradients,
    against :func:`dense_attention` run in f32 on the same values on the
    card, row by row (``k3_errors``, within RING_ATT_TOL)."""
    q, k, v, dout, valid = ring_att_inputs(torch)
    shards = [torch.load(os.path.join(
        out_dir, f"ring_att_world{world}_rank{r}.pt")) for r in range(world)]
    got = tuple(torch.cat([s[key] for s in shards]).to(CARD)
                for key in ("out", "dq", "dk", "dv"))
    leaves = [x.float().requires_grad_() for x in (q, k, v)]
    ref_out = dense_attention(torch, *leaves, True, valid)
    grads = torch.autograd.grad(ref_out, leaves, dout.float())
    ref = (ref_out.detach(), *grads)
    del leaves, ref_out, grads
    errs = k3_errors(torch, got, ref)
    if not k3_within(errs, RING_ATT_TOL):
        raise AssertionError(f"ring_attention world {world} vs dense: "
                             f"{errs} over {RING_ATT_TOL}")
    return errs


def pipe_moe_references(torch, world: int, factor: float) -> dict:
    """Plain references on the card, f32: the stages applied one after
    another and their gradients of (out · dout).sum(); each rank's
    tokens through its top-1 expert, a token kept when fewer than the
    capacity of that rank's tokens before it chose the same expert,
    scaled by its gate, and the gradients of the same loss."""
    inputs = pipe_moe_inputs(torch, world)
    ref = {}
    w = inputs["stages"].clone().requires_grad_()
    x = inputs["x"].clone().requires_grad_()
    y = x
    for s in range(world):
        y = torch.tanh(y @ w[s])
    dw, dx = torch.autograd.grad(y, (w, x), inputs["dout"])
    ref["pipeline"] = {"out": y.detach(), "dw": dw, "dx": dx}

    w = inputs["experts"].clone().requires_grad_()
    gates = inputs["gates"].clone().requires_grad_()
    t_loc = PIPE_ROWS // world
    capacity = max(int(np.ceil(t_loc / world * factor)), 1)
    outs, n_kept = [], 0
    for r in range(world):
        mine = slice(r * t_loc, (r + 1) * t_loc)
        g = gates[mine]
        idx = g.argmax(-1)
        prob = torch.softmax(g, -1).gather(-1, idx[:, None])[:, 0]
        kept = torch.zeros(t_loc, dtype=torch.bool, device=CARD)
        y = torch.zeros(t_loc, PIPE_WIDTH, device=CARD)
        for e in range(world):
            chosen = torch.nonzero(idx == e)[:, 0]
            kept[chosen[:capacity]] = True
            y = y.index_put((chosen,), torch.tanh(
                inputs["x"][mine][chosen] @ w[e]))
        outs.append(y * (prob * kept)[:, None])
        n_kept += int(kept.sum())
    out = torch.cat(outs)
    dw, dgates = torch.autograd.grad(out, (w, gates), inputs["dout"])
    ref["moe"] = {"out": out.detach(), "dw": dw, "dgates": dgates,
                  "dropped": PIPE_ROWS - n_kept}
    return ref


def check_pipeline_moe(torch, world: int, out_dir: str) -> dict:
    """Every rank's pipeline output and x's gradient, and its stage's
    weight gradient, against the sequential reference; the experts'
    outputs and gate gradients put together, and each rank's expert
    gradient, against the dense reference, at each capacity factor.
    Returns each tensor's error (:func:`rel_err`) and the drops."""
    shards = [torch.load(os.path.join(
        out_dir, f"pipe_moe_world{world}_rank{r}.pt")) for r in range(world)]
    errs = {}
    for factor in MOE_FACTORS:
        ref = pipe_moe_references(torch, world, factor)
        if "pipeline" not in errs:
            pipe = ref["pipeline"]
            errs["pipeline"] = {
                key: max(rel_err(s["pipeline"][key].to(CARD),
                                 pipe[key][r] if key == "dw" else pipe[key])
                         for r, s in enumerate(shards))
                for key in ("out", "dx", "dw")}
        moe, key = ref["moe"], f"moe_{factor}"
        errs[key] = {
            name: rel_err(torch.cat([s[key][name] for s in shards]).to(CARD),
                          moe[name]) for name in ("out", "dgates")}
        errs[key]["dw"] = max(rel_err(s[key]["dw"].to(CARD), moe["dw"][r])
                              for r, s in enumerate(shards))
        errs[key]["dropped_reference"] = moe["dropped"]
    bad = {name: e for name, e in errs.items()
           if any(v > PAR_F32_TOL for n, v in e.items()
                  if n != "dropped_reference")}
    if bad:
        raise AssertionError(f"pipeline_moe world {world}: {bad} over "
                             f"{PAR_F32_TOL}")
    return errs


def expected_layout_exchanges(world: int) -> dict:
    """What the pipeline and the experts must exchange in a world > 1, a
    forward and a backward: M + S − 2 hops each way, the all-reduce of
    the output and that of x's gradient; two all-to-alls forward and one
    backward (the dispatch carries no gradient: x takes none)."""
    return {"pipeline": {"ring_shift": 2 * (PIPE_MICRO + world - 2),
                         "all_reduce": 2},
            "moe": {"all_to_all": 3}}


def par_failures(ranks: list, world: int) -> list:
    """The checks that read only the ranks' reports: equal digests,
    launches, exchange counts and staged bytes as predicted."""
    failures = []
    gat = [r["ring_gat"] for r in ranks]
    if len({d for g in gat for d in g["digests"]}) != 1:
        failures.append(f"ring_gat digests {gat[0]['digests']}")
    expected = expected_layout_exchanges(world)
    zero = dict.fromkeys(gat[0]["launches"], 0)
    for r in ranks:
        g = r["ring_gat"]
        if world > 1 and (g["launches"] != zero
                          or g["exchanges"] != g["expected_exchanges"]):
            failures.append(f"ring_gat rank {r['rank']}: launches "
                            f"{g['launches']}, exchanges {g['exchanges']} "
                            f"!= {g['expected_exchanges']}")
        att = r["ring_attention"]
        hops = 2 * (world - 1)
        if att["launches"] != zero or att["exchanges"]["ring_shift"] != hops:
            failures.append(f"ring_attention rank {r['rank']}: launches "
                            f"{att['launches']}, exchanges "
                            f"{att['exchanges']}")
        for name, rep in r["pipeline_moe"].items():
            want = expected["pipeline" if name == "pipeline" else "moe"]
            got = {k: v for k, v in rep["exchanges"].items()
                   if v and k != "staged_bytes"}
            if rep["launches"] != zero or got != want:
                failures.append(f"{name} rank {r['rank']}: launches "
                                f"{rep['launches']}, exchanges "
                                f"{rep['exchanges']} != {want}")
    return failures


def run_parallel_world(torch, phase: str, backend: str, world: int,
                       tmp: str, one: dict, graph) -> dict:
    """``world`` ranks over ``backend`` spawned once (:func:`par_rank`),
    checked against the world of one (``one``, run in this process):
    ring_gat_ranks, ring_attention and pipeline_moe logged with ``phase``
    as their prefix where it is not the one-card gloo run. Returns rank
    0's launches a path."""
    from dragonfly2_tpu_torch.inference.sidecar import (
        CallContext,
        InferenceService,
        ModelInferRequest,
        _gat_scorer_from_artifact,
    )
    from dragonfly2_tpu_torch.models.graph_transformer import GraphTransformer
    from dragonfly2_tpu_torch.train.checkpoint import (
        gat_state_dict_from_flax,
        gat_from_tree,
        load_artifact,
    )

    out_dir = os.path.join(tmp, f"{phase}-world{world}")
    os.makedirs(out_dir)
    parent_gib = release_card_memory(torch)
    t0 = time.perf_counter()
    address = f"localhost:{free_port()}"
    join_processes(start_processes(
        [(par_rank, (rank, world, address, backend, out_dir))
         for rank in range(world)]), PAR_TIMEOUT_S, out_dir)
    ranks = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as fh:
            ranks.append(json.load(fh))
    seconds = time.perf_counter() - t0
    failures = par_failures(ranks, world)
    label = f"{backend}, {world} ranks on " + (
        "one card" if backend == "gloo" else f"{world} cards")
    prefix = "" if phase == "parallel" else f"{phase}_"

    # -- ring_gat_ranks: against the world of one, blocks mode, serving --
    gat, ref = ranks[0]["ring_gat"], one["ring_gat"]
    gaps = {"loss": abs(gat["history"][-1] - ref["history"][-1]),
            "f1": abs(gat["f1"] - ref["f1"])}
    tol = {"loss": DP_LOSS_TOL["gat"], "f1": DP_F1_TOL["gat"]}
    if any(gaps[k] > tol[k] for k in gaps):
        failures.append(f"ring_gat gaps {gaps} over {tol}")
    saved = torch.load(os.path.join(out_dir, f"ring_gat_world{world}.pt"),
                       weights_only=False)
    tree, metadata = load_artifact(saved["artifact"])
    params, feats, nbr, val, _ = gat_from_tree(tree)
    blocks = GraphTransformer(
        in_features=feats.shape[1], **GAT_CFG | {"attention": "blocks"})
    blocks.load_state_dict(gat_state_dict_from_flax(params))
    with torch.no_grad():
        blocks_emb = blocks.to(CARD).node_embeddings(*(
            torch.from_numpy(a).to(CARD) for a in (feats, nbr, val))).float()
    emb_err = float((blocks_emb - saved["emb"].to(CARD)).abs().max())
    counts = Counts()
    counts.reset()
    t_load = time.perf_counter()
    scorer = _gat_scorer_from_artifact(saved["artifact"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t_load
    service = InferenceService(micro_batch=False)
    service.install_scorer("gat", scorer, version=f"ring-{world}")
    pairs = saved["pairs"]
    served = np.concatenate([service.ModelInfer(
        ModelInferRequest("gat", pairs[i:i + 16]), CallContext()).outputs
        for i in range(0, len(pairs), 16)])
    serve_launches = counts.read()
    served_err = float(np.abs(served - saved["scores"].numpy()).max())
    if (emb_err > MODE_TOL or served_err > MODE_TOL
            or not np.isfinite(served).all()
            or serve_launches["graph_flash_attention"] != GAT_CFG["layers"]):
        failures.append(f"ring_gat: blocks embeddings {emb_err}, served "
                        f"{served_err} (tol {MODE_TOL}), serve launches "
                        f"{serve_launches}")
    del blocks, scorer, service
    log(f"{prefix}ring_gat_ranks", label=label, seconds=seconds, world=world,
        parent_reserved_gib=parent_gib,
        start_seconds=[r["start_seconds"] for r in ranks],
        graph_seconds=[r["graph_seconds"] for r in ranks],
        phase_seconds=[{k: v for k, v in r.items() if k.endswith("_seconds")}
                       for r in ranks],
        world_one_phase_seconds={k: v for k, v in one.items()
                                 if k.endswith("_seconds")},
        ranks=[r["ring_gat"] for r in ranks], world_one=ref, gaps=gaps,
        tol=tol, blocks_embeddings_err=emb_err, served_err=served_err,
        serve_load_seconds=load_s, serve_launches=serve_launches,
        artifact_attention=metadata.config["attention"], mode_tol=MODE_TOL)

    # -- ring_attention: shards against the dense reference; memory ------
    errs = {"world1": one.get("ring_attention_errs")
            or check_ring_attention(torch, 1, one["out_dir"])}
    one["ring_attention_errs"] = errs["world1"]
    errs[f"world{world}"] = check_ring_attention(torch, world, out_dir)
    att = [r["ring_attention"] for r in ranks]
    share = (max(a["peak_above_inputs_gib"] for a in att)
             / one["ring_attention"]["peak_above_inputs_gib"])
    if share > RING_ATT_MEMORY_SHARE:
        failures.append(f"ring_attention: peak share {share} over "
                        f"{RING_ATT_MEMORY_SHARE}")
    log(f"{prefix}ring_attention", label=label, world=world,
        world_one=one["ring_attention"], ranks=att, errors=errs,
        tol=RING_ATT_TOL, memory_share=share,
        memory_share_max=RING_ATT_MEMORY_SHARE,
        masked_keys=int(RING_ATT_T * RING_ATT_MASKED), causal=True,
        dtype="bf16")

    # -- pipeline_moe: against the sequential and dense references -------
    errs = {"world1": one.get("pipeline_moe_errs")
            or check_pipeline_moe(torch, 1, one["out_dir"])}
    one["pipeline_moe_errs"] = errs["world1"]
    errs[f"world{world}"] = check_pipeline_moe(torch, world, out_dir)
    drops = [sum(r["pipeline_moe"][f"moe_{f}"]["dropped"] for r in ranks)
             for f in MOE_FACTORS]
    want_drops = [errs[f"world{world}"][f"moe_{f}"]["dropped_reference"]
                  for f in MOE_FACTORS]
    if drops != want_drops or drops[0] != 0 or drops[1] == 0:
        failures.append(f"moe drops {drops} (reference {want_drops}) at "
                        f"factors {MOE_FACTORS}")
    log(f"{prefix}pipeline_moe", label=label, world=world,
        rows=PIPE_ROWS, width=PIPE_WIDTH, microbatches=PIPE_MICRO,
        capacity_factors=list(MOE_FACTORS), drops=drops,
        world_one=one["pipeline_moe"],
        ranks=[r["pipeline_moe"] for r in ranks], errors=errs,
        tol=PAR_F32_TOL)
    if failures:
        raise AssertionError(f"{phase}: {failures}")
    return {"ring_gat_ranks": gat["launches"],
            "ring_attention": ranks[0]["ring_attention"]["launches"],
            "pipeline_moe": {
                name: sum(rep["launches"][name]
                          for rep in ranks[0]["pipeline_moe"].values())
                for name in gat["launches"]}}


def run_parallel(torch, graph) -> dict:
    """Sequence, pipeline and expert parallelism, slice 15's paths.

    The world of one first, in this process over a one-rank NCCL group
    (ring mode's K1 path with the same seed; the layouts without an
    exchange), then PAR_WORLD gloo ranks spawned once on the one card
    (:func:`run_parallel_world`): ring_gat_ranks (config #3 in ring mode,
    rows sharded, K/V around the ring; digests equal, loss and F1 gaps to
    the world of one, the trained weights' embeddings against blocks
    mode's, rank 0's artifact served in a world of one through K1, hops
    and staged bytes as predicted), ring_attention (shards against the
    f32 dense reference, row by row; the forward's peak memory share) and
    pipeline_moe (against the sequential and dense references; drops as
    the reference counts them). parallel_nccl_cards: the same over NCCL
    with a rank a card where the machine has several cards; with one it
    is logged as waiting. Every path must launch no kernel. Returns rank
    0's launches a path of the gloo run."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="smoke-par-")
    try:
        one_dir = os.path.join(tmp, "world1")
        os.makedirs(one_dir)
        release_card_memory(torch)
        t0 = time.perf_counter()
        one = par_world_one(torch, graph, one_dir)
        one["out_dir"] = one_dir
        one["seconds"] = time.perf_counter() - t0
        ring = one["ring_gat"]
        expected = dict.fromkeys(ring["launches"], 0)
        expected.update(
            graph_flash_attention=TRAIN_CFG["layers"] * (
                ring["steps"] + ring["eval_chunks"]),
            graph_flash_attention_backward=TRAIN_CFG["layers"]
            * ring["steps"])
        if ring["launches"] != expected or ring["sharded"]:
            raise AssertionError(f"ring world of one: launches "
                                 f"{ring['launches']} != {expected}")
        launches = run_parallel_world(torch, "parallel", "gloo", PAR_WORLD,
                                      tmp, one, graph)
        cards = torch.cuda.device_count()
        if cards > 1:
            run_parallel_world(torch, "parallel_nccl_cards", "nccl", cards,
                               tmp, one, graph)
        else:
            log("parallel_nccl_cards", cards=cards)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# -- tensor parallelism, slice 16 --------------------------------------------

# Config #3 on (data, model) grids of gloo ranks sharing the one card,
# (world, model axis): 1 x 2, then 2 x 2. Each trains in blocks mode (K1
# forward and backward on a rank's head share, 2 heads of 32, its query
# rows against every row's K/V) and in gather mode (K2a and K2b on the
# share's 256-byte [k|v] rows), cut to one epoch at WORLD_GAT_BATCH (29
# steps) as ring_gat_ranks is, with no wall-clock cap.
TP_GRIDS = ((2, 2), (4, 2))
TP_MODES = ("blocks", "gather")
# A grid's last epoch loss against the world of one's on the same seed
# and batches (the CPU tests hold the same runs at test size to 2e-3).
TP_LOSS_TOL = 5e-3
TP_TIMEOUT_S = 600
# Seeded pairs the ranks score on the grid and the served artifact
# scores in a world of one.
TP_PAIRS = 64


def tp_config(mode: str):
    """Config #3 in ``mode`` cut to one epoch at WORLD_GAT_BATCH, no
    wall-clock cap."""
    from dragonfly2_tpu_torch.train.gat_trainer import GATTrainConfig

    return GATTrainConfig(**dict(TRAIN_CFG, epochs=DP_GAT_EPOCHS,
                                 edge_batch_size=WORLD_GAT_BATCH,
                                 max_seconds=None, attention=mode))


def tp_expected_exchanges(cfg, n_data: int, n_model: int, steps: int,
                          chunks: int, rows: int, sharded_numel: int,
                          staged: bool) -> dict:
    """What one rank of an ``n_data x n_model`` grid must exchange in a
    fit of ``steps`` steps and ``chunks`` eval chunks over ``rows``
    padded rows. Model axis: a layer's two g all-reduces a forward and
    two f all-reduces a backward of its [rows / n_data, hidden] f32
    activations, and the one all-gather of the sharded parameters at the
    end. Data axis: a layer's [k|v] all-gather of the head share (bf16)
    and the embedding table's a forward, each summed back in f32 a
    backward. Under gloo, device tensors go through pinned host memory
    both ways: an all-reduce stages its f32 buffer out and back, an
    all-gather its shard out and the world's back."""
    from dragonfly2_tpu_torch.parallel.mesh import Exchanges

    layers, hidden, embed = cfg.layers, cfg.hidden, cfg.embed
    n_loc = rows // n_data
    fwd = steps + chunks
    out = dict.fromkeys(Exchanges.KINDS, 0)
    staged_bytes = 0
    if n_model > 1:
        out["all_reduce"] = 2 * layers * fwd + 2 * layers * steps
        out["all_gather"] += 1
        staged_bytes += out["all_reduce"] * 2 * n_loc * hidden * 4
        staged_bytes += (1 + n_model) * sharded_numel * 4
    if n_data > 1:
        out["all_gather"] += (layers + 1) * fwd
        out["reduce_scatter"] = (layers + 1) * steps
        kv = n_loc * 2 * (hidden // n_model) * 2
        staged_bytes += fwd * (1 + n_data) * (layers * kv + n_loc * embed * 2)
        staged_bytes += steps * 2 * rows * 4 * (
            layers * 2 * (hidden // n_model) + embed)
    return dict(out, staged_bytes=staged_bytes if staged else 0)


def tp_fit(torch, graph, mode: str, grid, rank: int, tag: str,
           out_dir: str) -> dict:
    """Config #3 in ``mode`` on ``grid`` (``GATTrainer.fit``, the body of
    ``train_gat``) with the launch and exchange counts set to 0 just
    before and read just after; then the rank's parameter and optimizer
    bytes against the replicated model's, the digests of the replicated
    parameters and of the gathered whole state agreed across the ranks,
    the model's scores of seeded pairs on the grid, and one model-axis
    all-reduce of a layer's activations, timed. Rank 0 saves the
    artifact and the scores to ``out_dir``."""
    import torch.distributed as dist

    from dragonfly2_tpu_torch.parallel.dryrun import state_digest
    from dragonfly2_tpu_torch.parallel.mesh import (
        EXCHANGES,
        all_gather_rows,
        reduce_from_model,
    )
    from dragonfly2_tpu_torch.parallel.multihost import agree
    from dragonfly2_tpu_torch.train.checkpoint import gat_artifact_from_result
    from dragonfly2_tpu_torch.train.gat_trainer import GATTrainer
    from dragonfly2_tpu_torch.train.metrics import padded_chunks

    cfg = tp_config(mode)
    counts = Counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    counts.reset()
    EXCHANGES.reset()
    t0 = time.perf_counter()
    trainer = GATTrainer(graph, cfg, grid=grid)
    result = trainer.fit()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    launches, exchanges = counts.read(), EXCHANGES.read()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    steps = len(result.step_losses)
    chunks = len(list(padded_chunks(trainer.eval_ids, trainer.batch)))
    expected = dict.fromkeys(launches, 0)
    fwd, bwd = ((("graph_flash_attention", "graph_flash_attention_backward"))
                if mode == "blocks" else ("table_gather", "table_scatter_add"))
    expected[fwd] = cfg.layers * (steps + chunks)
    expected[bwd] = cfg.layers * steps

    state = trainer.model.state_dict()
    sharded = sorted(k for k in state
                     if state[k].shape != result.state_dict[k].shape)
    param_bytes = nbytes(*trainer.model.parameters())
    whole_bytes = nbytes(*result.state_dict.values())
    moments = [t for st in trainer.optimizer.state.values()
               for name, t in st.items() if name != "step"]
    staged = (dist.get_backend() == "gloo"
              and trainer.device.type != "cpu")
    expected_exchanges = tp_expected_exchanges(
        cfg, grid.n_data, grid.n_model, steps, chunks, len(trainer.nbr),
        sum(state[k].numel() for k in sharded), staged)
    digests = agree(np.concatenate([
        state_digest({k: v for k, v in state.items() if k not in sharded}),
        state_digest(result.state_dict)])).tolist()

    pairs = np.random.default_rng(SEED + 11).integers(0, graph.n_nodes,
                                                      (TP_PAIRS, 2))
    trainer.model.eval()
    with torch.no_grad():
        emb = trainer.model.node_embeddings(trainer.g_feat, trainer.g_nbr,
                                            trainer.g_val)
        if trainer.sharded:
            emb = all_gather_rows(emb, grid.data)
        src, dst = torch.from_numpy(pairs.astype(np.int32)).to(
            trainer.device).T
        scores = trainer.model.score_pairs(emb, src, dst).float().cpu()
        # One model-axis all-reduce of a layer's f32 activations, timed
        # (ranks in step).
        act = torch.zeros(len(trainer.nbr) // grid.n_data, cfg.hidden,
                          device=trainer.device)
        allreduce_ms = (cuda_ms(torch, lambda: reduce_from_model(
            act, grid.model), iters=10, warmup=2)
            if grid.n_model > 1 else 0.0)
    if rank == 0:
        torch.save({"artifact": gat_artifact_from_result(
                        result, graph, f"smoke-tp-{tag}-{mode}"),
                    "scores": scores, "pairs": pairs},
                   os.path.join(out_dir, f"tp_{tag}_{mode}.pt"))
    return dict(seconds=seconds, steps=steps, eval_chunks=chunks,
                batch=trainer.batch, rows=len(trainer.nbr),
                rows_per_rank=int(trainer.g_nbr.shape[0]),
                history=result.history,
                step_losses_first_last=[result.step_losses[0],
                                        result.step_losses[-1]],
                f1=result.f1, accuracy=result.accuracy,
                step_ms=trainer.batch / result.samples_per_sec * 1e3,
                samples_per_sec_global=result.samples_per_sec,
                model_allreduce_ms=allreduce_ms,
                model_allreduce_bytes=nbytes(act),
                peak_memory_gib=peak_gib, param_bytes=param_bytes,
                replicated_param_bytes=whole_bytes,
                optimizer_bytes=nbytes(*moments),
                replicated_optimizer_bytes=2 * whole_bytes,
                sharded_tensors=len(sharded),
                replicated_and_whole_digests=digests,
                launches=launches, expected_launches=expected,
                exchanges=exchanges, expected_exchanges=expected_exchanges)


def tp_rank(rank: int, world: int, model_parallel: int, address: str,
            backend: str, out_dir: str) -> None:
    """One rank of the tp_grid phase (a spawned process): joins the fleet
    with ``init_multihost`` (its device cuda:(rank % cards)), builds
    config #3's graph and the ``(world / model_parallel x
    model_parallel)`` grid (``multihost_grid``) and runs :func:`tp_fit`
    in every mode. Writes ``rank<rank>.json`` to ``out_dir`` (a
    traceback to ``rank<rank>.err``)."""
    import traceback

    import torch
    import torch.distributed as dist

    from dragonfly2_tpu_torch.parallel.multihost import (
        init_multihost,
        multihost_grid,
    )

    try:
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        t0 = time.perf_counter()
        info = init_multihost(address, world, rank, backend=backend)
        report = {"rank": rank, "backend": info.backend,
                  "device": str(info.device),
                  "start_seconds": time.perf_counter() - t0}
        try:
            t0 = time.perf_counter()
            graph = dp_data("gat")
            report["graph_seconds"] = time.perf_counter() - t0
            grid = multihost_grid(model_parallel)
            report["grid"] = [grid.data_rank, grid.model_rank, grid.n_data,
                              grid.n_model]
            for mode in TP_MODES:
                report[mode] = tp_fit(torch, graph, mode, grid, rank,
                                      f"world{world}", out_dir)
        finally:
            dist.destroy_process_group()
        with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as fh:
            json.dump(report, fh)
    except BaseException:
        with open(os.path.join(out_dir, f"rank{rank}.err"), "w") as fh:
            fh.write(traceback.format_exc())
        raise


def tp_world_one(torch, graph, out_dir: str) -> dict:
    """:func:`tp_fit` in every mode in this process on a one-rank NCCL
    group: the reference runs, with the same seed and batches, and no
    exchange."""
    import torch.distributed as dist

    from dragonfly2_tpu_torch.parallel.mesh import grid_groups

    dist.init_process_group("nccl", init_method=f"file://{out_dir}/store1",
                            world_size=1, rank=0)
    try:
        grid = grid_groups(1)
        return {mode: tp_fit(torch, graph, mode, grid, 0, "world1", out_dir)
                for mode in TP_MODES}
    finally:
        dist.destroy_process_group()


def run_tp_world(torch, phase: str, backend: str, world: int,
                 model_parallel: int, tmp: str, one: dict) -> dict:
    """``world`` ranks over ``backend`` as a ``(world / model_parallel x
    model_parallel)`` grid, spawned once (:func:`tp_rank`), checked
    against the world of one (``one``): the grid as JAX lays out its
    mesh; in every mode equal digests of the replicated parameters and
    of the gathered state on every rank, the loss gap to the world of
    one within TP_LOSS_TOL (the F1 gap logged), each rank's launches and
    exchanges as predicted, its parameter bytes below the replicated
    ones, and rank 0's artifact served in a world of one through
    ``InferenceService``, its scores against the ranks'. Returns rank
    0's launches, summed over the modes."""
    from dragonfly2_tpu_torch.inference.sidecar import (
        CallContext,
        InferenceService,
        ModelInferRequest,
        _gat_scorer_from_artifact,
    )

    out_dir = os.path.join(tmp, f"{phase}-world{world}")
    os.makedirs(out_dir)
    parent_gib = release_card_memory(torch)
    t0 = time.perf_counter()
    address = f"localhost:{free_port()}"
    join_processes(start_processes(
        [(tp_rank, (rank, world, model_parallel, address, backend, out_dir))
         for rank in range(world)]), TP_TIMEOUT_S, out_dir)
    ranks = []
    for rank in range(world):
        with open(os.path.join(out_dir, f"rank{rank}.json")) as fh:
            ranks.append(json.load(fh))
    seconds = time.perf_counter() - t0
    n_data = world // model_parallel
    failures = [f"rank {r['rank']} grid {r['grid']}" for r in ranks
                if r["grid"] != [r["rank"] // model_parallel,
                                 r["rank"] % model_parallel, n_data,
                                 model_parallel]]
    label = f"{backend}, {world} ranks on " + (
        "one card" if backend == "gloo" else f"{world} cards")
    launches = dict.fromkeys(ranks[0][TP_MODES[0]]["launches"], 0)
    modes = {}
    for mode in TP_MODES:
        per_rank, ref = [r[mode] for r in ranks], one[mode]
        for row, n in per_rank[0]["launches"].items():
            launches[row] += n
        for i in range(2):
            if len({r["replicated_and_whole_digests"][k][i]
                    for r in per_rank for k in range(world)}) != 1:
                failures.append(f"{mode}: digests "
                                f"{per_rank[0]['replicated_and_whole_digests']}")
        for r in per_rank:
            if (r["launches"] != r["expected_launches"]
                    or r["exchanges"] != r["expected_exchanges"]
                    or not r["param_bytes"] < r["replicated_param_bytes"]
                    or not r["optimizer_bytes"]
                    < r["replicated_optimizer_bytes"]):
                failures.append(
                    f"{mode}: launches {r['launches']} (want "
                    f"{r['expected_launches']}), exchanges {r['exchanges']} "
                    f"(want {r['expected_exchanges']}), bytes "
                    f"{r['param_bytes']} of {r['replicated_param_bytes']}")
        gaps = {"loss": abs(per_rank[0]["history"][-1] - ref["history"][-1]),
                "f1": abs(per_rank[0]["f1"] - ref["f1"])}
        if not gaps["loss"] <= TP_LOSS_TOL:
            failures.append(f"{mode}: loss gap {gaps['loss']} over "
                            f"{TP_LOSS_TOL}")

        # Rank 0's artifact in a world of one, against the ranks' scores.
        saved = torch.load(os.path.join(
            out_dir, f"tp_world{world}_{mode}.pt"), weights_only=False)
        counts = Counts()
        counts.reset()
        t_load = time.perf_counter()
        scorer = _gat_scorer_from_artifact(saved["artifact"])
        torch.cuda.synchronize()
        load_s = time.perf_counter() - t_load
        service = InferenceService(micro_batch=False)
        service.install_scorer("gat", scorer, version=f"tp-{world}-{mode}")
        pairs = saved["pairs"]
        served = np.concatenate([service.ModelInfer(
            ModelInferRequest("gat", pairs[i:i + 16]), CallContext()).outputs
            for i in range(0, len(pairs), 16)])
        serve_launches = counts.read()
        served_err = float(np.abs(served - saved["scores"].numpy()).max())
        fwd = ("graph_flash_attention" if mode == "blocks"
               else "table_gather")
        if (served_err > MODE_TOL or not np.isfinite(served).all()
                or serve_launches[fwd] != TRAIN_CFG["layers"]):
            failures.append(f"{mode}: served {served_err} (tol {MODE_TOL}), "
                            f"serve launches {serve_launches}")
        del scorer, service
        modes[mode] = dict(ranks=per_rank, world_one=ref, gaps=gaps,
                           served_err=served_err, serve_load_seconds=load_s,
                           serve_launches=serve_launches)
    log(phase, label=label, seconds=seconds, world=world,
        grid=[n_data, model_parallel], parent_reserved_gib=parent_gib,
        start_seconds=[r["start_seconds"] for r in ranks],
        graph_seconds=[r["graph_seconds"] for r in ranks], modes=modes,
        tol={"loss": TP_LOSS_TOL, "served": MODE_TOL})
    if failures:
        raise AssertionError(f"{phase} world {world}: {failures}")
    return launches


def tp_kernel_inputs(torch, graph, mode: str, n_data: int, model_parallel):
    """The kernels' inputs on data rank 0 of an ``n_data x
    model_parallel`` grid at config #3 (the trainer's padding, its rows
    of the neighbor lists, their inverse index over every row) and
    seeded random activations of the rank's head share: q, k, v for
    blocks mode, the [k|v] table and its cotangent for gather mode."""
    from dragonfly2_tpu_torch.models.graph_transformer import (
        build_inverse_index,
        build_neighbor_lists,
        pad_graph_sparse,
        pad_multiple,
    )

    nbr, val = build_neighbor_lists(graph.n_nodes, graph.edge_src,
                                    graph.edge_dst, graph.edge_rtt_ns,
                                    cap=NEIGHBOR_CAP)
    multiple = (pad_multiple(n_data, GAT_CFG["chunk"], graph.n_nodes)
                if mode == "blocks" else n_data)
    _, nbr, val, _ = pad_graph_sparse(graph.node_features, nbr, val,
                                      multiple)
    rows, n_loc = len(nbr), len(nbr) // n_data
    inv = torch.from_numpy(build_inverse_index(nbr[:n_loc], rows)).cuda()
    nbr, val = (torch.from_numpy(a[:n_loc]).cuda() for a in (nbr, val))
    heads = GAT_CFG["heads"] // model_parallel
    head_dim = GAT_CFG["hidden"] // GAT_CFG["heads"]
    gen = torch.Generator(device="cuda").manual_seed(SEED + 13)

    def randn(*shape):
        return torch.randn(shape, generator=gen, device="cuda").to(
            torch.bfloat16)

    if mode == "blocks":
        return (randn(n_loc, heads, head_dim), randn(rows, heads, head_dim),
                randn(rows, heads, head_dim), nbr, val, inv)
    width = 2 * heads * head_dim
    idx = torch.where(nbr >= rows, 0, nbr).reshape(-1)
    return randn(rows, width), idx, randn(idx.shape[0], width), inv, rows


def run_tp_kernels(torch, graph, rows: list) -> None:
    """tp_kernels: the four kernels of the tensor-parallel path at its new
    shapes on data rank 0 of the 2 x 2 grid — K1 forward and backward at
    a 2-head share of 32 ([20 480 / 2 query rows, 2, 32] bf16 against
    20 480 key rows) and K2a and K2b on the share's 256-byte [k|v] rows
    (a rank's 10 000 rows x 64 slots into the 20 000-row table) — each
    against its plain twin with the existing phases' tolerances, timed
    beside the plain twin, its library call (SDPA over the dense [n_q,
    n_k] bf16 mask; ``index_select``; ``index_add_`` into f32 zeros)
    and its bound. Their figures ride on the kernels line's rows under
    ``at_tensor_parallel``."""
    from dragonfly2_tpu_torch.models.graph_transformer import _flash_block

    n_data, model_parallel = TP_GRIDS[-1][0] // TP_GRIDS[-1][1], \
        TP_GRIDS[-1][1]
    q, k, v, nbr, val, inv = tp_kernel_inputs(torch, graph, "blocks", n_data,
                                              model_parallel)
    got = {"graph_flash_attention": check_graph_flash(
        torch, q, k, v, nbr, val, _flash_block(k.shape[0], GAT_CFG["chunk"])),
        "graph_flash_attention_backward": check_k1_backward(
            torch, q, k, v, nbr, val, inv)}
    shapes = {"graph_flash_attention": {"q": list(q.shape),
                                        "k": list(k.shape),
                                        "nbr": list(nbr.shape)}}
    shapes["graph_flash_attention_backward"] = dict(
        shapes["graph_flash_attention"], inv=list(inv.shape))
    del q, k, v, nbr, val, inv
    table, idx, ct, inv, n_rows = tp_kernel_inputs(torch, graph, "gather",
                                                   n_data, model_parallel)
    got["table_gather"] = check_table_gather(torch, table, idx)
    got["table_scatter_add"] = check_table_scatter_add(torch, ct, idx, inv,
                                                       n_rows)
    shapes["table_gather"] = {"table": list(table.shape),
                              "idx": list(idx.shape)}
    shapes["table_scatter_add"] = {"ct": list(ct.shape),
                                   "inv": list(inv.shape), "rows": n_rows}
    del table, idx, ct, inv
    for row in rows:
        if row["name"] in got:
            row["at_tensor_parallel"] = {
                key: got[row["name"]][key] for key in
                ("source", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "max_abs_err")} | {
                "shape": shapes[row["name"]]}
    log("tp_kernels", grid=[n_data, model_parallel], kernels={
        name: row["at_tensor_parallel"] for name, row in
        ((r["name"], r) for r in rows) if name in got})


def run_hbm_sink_sharded(torch, dev) -> None:
    """hbm_sink_sharded: a small safetensors file through two sinks onto
    ``dev``, the sinks of ranks 0 and 1 of a 2-way split
    (``HBMSink(shard_for=...)``, pieces in reversed order): each holds
    its block of the split tensor's rows bit-equal to the file's, with
    the block's bytes on the device, and every other tensor whole; a
    world that does not divide the rows is refused."""
    import tempfile

    from dragonfly2_tpu_torch.client.hbm_sink import HBMSink, write_safetensors

    sources = sink_test_tensors(torch)
    split = "embed.weight"
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "m.safetensors")
        write_safetensors(path, sources)
        with open(path, "rb") as f:
            raw = f.read()
    offsets = list(range(0, len(raw), 4096))[::-1]
    report = {}
    whole = sources[split]
    for rank in range(2):
        sink = HBMSink(len(raw), device=dev, shard_for=lambda name, r=rank: (
            (2, r) if name == split else None))
        for off in offsets:
            sink.write(off, raw[off:off + 4096])
        block = whole.chunk(2)[rank]
        seconds = sink_case(torch, dev, sink, dict(sources, **{split: block}))
        placed = sink.wait()[split]
        device_bytes = placed.untyped_storage().nbytes()
        if device_bytes != nbytes(block):
            raise AssertionError(f"rank {rank}: {device_bytes} device bytes "
                                 f"for a {nbytes(block)}-byte block")
        report[f"rank{rank}"] = dict(shape=list(placed.shape),
                                     device_bytes=device_bytes,
                                     whole_bytes=nbytes(whole),
                                     copy_seconds=seconds)
    sink = HBMSink(len(raw), device=dev, shard_for=lambda name: (
        (3, 0) if name == split else None))
    sink.write(0, raw)
    try:
        sink.wait(timeout=30)
    except RuntimeError as exc:
        report["uneven_split"] = str(exc)
    else:
        raise AssertionError("a 3-way split of 256 rows was placed")
    finally:
        sink.close()
    log("hbm_sink_sharded", split=split, world=2, **report)


def run_tensor_parallel(torch, graph, rows: list) -> dict:
    """Tensor parallelism, slice 16's path (the JAX mesh's model axis).

    tp_world_one: config #3 in blocks and gather mode on a one-rank NCCL
    group in this process, the reference runs. tp_grid: TP_GRIDS' worlds
    of gloo ranks spawned on the one card, one after the other
    (:func:`run_tp_world`), logged as ``tp_grid``. tp_kernels: the path's
    kernels at its new shapes (:func:`run_tp_kernels`). tp_nccl_cards:
    the 2 x 2 grid over NCCL with a rank a card where the machine has at
    least 4 cards; with fewer it is logged as waiting. Returns rank 0's
    launches of the 2 x 2 gloo grid, summed over the modes."""
    import tempfile

    tmp = tempfile.mkdtemp(prefix="smoke-tp-")
    try:
        one_dir = os.path.join(tmp, "world1")
        os.makedirs(one_dir)
        release_card_memory(torch)
        t0 = time.perf_counter()
        one = tp_world_one(torch, graph, one_dir)
        failures = [f"{mode}: launches {r['launches']} != "
                    f"{r['expected_launches']}, exchanges {r['exchanges']}"
                    for mode, r in one.items()
                    if r["launches"] != r["expected_launches"]
                    or r["exchanges"] != r["expected_exchanges"]]
        log("tp_world_one", seconds=time.perf_counter() - t0, modes=one)
        if failures:
            raise AssertionError(f"tp_world_one: {failures}")
        for world, model_parallel in TP_GRIDS:
            launches = run_tp_world(torch, "tp_grid", "gloo", world,
                                    model_parallel, tmp, one)
        run_tp_kernels(torch, graph, rows)
        cards = torch.cuda.device_count()
        world, model_parallel = TP_GRIDS[-1]
        if cards >= world:
            run_tp_world(torch, "tp_nccl_cards", "nccl", world,
                         model_parallel, tmp, one)
        else:
            log("tp_nccl_cards", cards=cards)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return launches


# -- BASELINE config #5, slice 14: the P2P mesh into the device sink ---------

class OriginServer:
    """Config #5's origin: one directory over HTTP/1.1 with single-range
    support (the port's ``client/piece.parse_http_range``), answering as
    ``tests/fileserver.py`` does; bodies go out with ``sendfile``."""

    def __init__(self, root: str, host: str = "127.0.0.1"):
        from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

        from dragonfly2_tpu_torch.client.piece import parse_http_range

        class Handler(BaseHTTPRequestHandler):
            protocol_version = "HTTP/1.1"

            def log_message(self, fmt, *args):
                pass

            def _file(self):
                path = os.path.join(root, self.path.lstrip("/"))
                if not os.path.isfile(path):
                    self.send_error(404)
                    return None
                return path

            def do_HEAD(self):  # noqa: N802
                path = self._file()
                if path is not None:
                    self.send_response(200)
                    self.send_header("Content-Length",
                                     str(os.path.getsize(path)))
                    self.end_headers()

            def do_GET(self):  # noqa: N802
                path = self._file()
                if path is None:
                    return
                size = os.path.getsize(path)
                start, length = 0, size
                header = self.headers.get("Range")
                if header:
                    rng = parse_http_range(header, size)
                    start, length = rng.start, rng.length
                    self.send_response(206)
                    self.send_header("Content-Range",
                                     f"bytes {rng.start}-{rng.end}/{size}")
                else:
                    self.send_response(200)
                self.send_header("Content-Length", str(length))
                self.end_headers()
                if length:
                    with open(path, "rb") as f:
                        self.connection.sendfile(f, start, length)

        self._server = ThreadingHTTPServer((host, 0), Handler)
        self._thread = None

    def url(self, name: str) -> str:
        host, port = self._server.server_address[:2]
        return f"http://{host}:{port}/{name}"

    def __enter__(self):
        import threading

        self._thread = threading.Thread(target=self._server.serve_forever,
                                        name="origin", daemon=True)
        self._thread.start()
        return self

    def __exit__(self, *exc):
        self._server.shutdown()
        self._server.server_close()
        self._thread.join(timeout=10)


def sink_case(torch, dev, sink, sources: dict, timeout_s: float = 60.0):
    """Wait for ``sink``; every tensor must sit on ``dev`` with its
    source's dtype and shape and, copied back, the source's bytes."""
    got = sink.wait(timeout=timeout_s)
    if set(got) != set(sources):
        raise AssertionError(f"sink names {sorted(got)} != "
                             f"{sorted(sources)}")
    for name, want in sources.items():
        t = got[name]
        if (t.device != dev or t.dtype != want.dtype
                or tuple(t.shape) != tuple(want.shape)):
            raise AssertionError(f"{name}: {t.device} {t.dtype} "
                                 f"{tuple(t.shape)}, want {dev} "
                                 f"{want.dtype} {tuple(want.shape)}")
        back = t.cpu().reshape(-1).view(torch.uint8)
        if not torch.equal(back, want.reshape(-1).view(torch.uint8)):
            raise AssertionError(f"{name}: bytes differ after the copy back")
    return sum(sink.copy_ms.values()) / 1e3


def sink_test_tensors(torch) -> dict:
    """``tests/test_hbm_sink.py``'s tensors plus a BF16 one."""
    rng = np.random.default_rng(SEED)
    bf16 = rng.integers(0, 1 << 16, (3, 33), dtype=np.uint16)
    return {name: torch.from_numpy(arr) for name, arr in {
        "embed.weight": rng.normal(size=(256, 64)).astype(np.float32),
        "layer0.w": rng.normal(size=(64, 128)).astype(np.float32),
        "layer0.b": rng.normal(size=(128,)).astype(np.float32),
        "head.weight": rng.normal(size=(128, 32)).astype(np.float16),
        "counts": rng.integers(0, 100, size=(7,)).astype(np.int32),
    }.items()} | {"norm.bf16": torch.from_numpy(
        bf16.view(np.int16)).view(torch.bfloat16)}


def every_dtype_tensors(torch) -> dict:
    """One tensor of each safetensors dtype, in odd sizes."""
    from dragonfly2_tpu_torch.client.hbm_sink import _DTYPES

    rng = np.random.default_rng(SEED)
    out = {}
    for i, (name, dtype) in enumerate(_DTYPES.items()):
        shape = (3, 5 + i)
        bits = rng.integers(0, 256, int(np.prod(shape)) * dtype.itemsize,
                            dtype=np.uint8)
        if dtype == torch.bool:
            bits %= 2
        out[f"t.{name.lower()}"] = torch.from_numpy(bits).view(
            dtype).reshape(shape)
    return out


def unaligned_file(path: str, tensors: dict) -> bytes:
    """The tensors written with metadata padded until the data starts at
    an odd offset: no wide element of the file is aligned."""
    from dragonfly2_tpu_torch.client.hbm_sink import (
        parse_safetensors_header,
        write_safetensors,
    )

    for pad in range(16):
        write_safetensors(path, tensors, metadata={"pad": "x" * pad})
        with open(path, "rb") as f:
            raw = f.read()
        if parse_safetensors_header(raw)[1] % 2:
            return raw
    raise AssertionError("no metadata length gave an odd data start")


def run_hbm_sink_small(torch, dev) -> None:
    """The sink on the card at test size: pieces in reversed order (the
    header last) with an unaligned header, every dtype, the header and
    first tensor alone (eager transfer), a write past the end, and a
    timeout's progress message."""
    import tempfile

    from dragonfly2_tpu_torch.client.hbm_sink import (
        HBMSink,
        parse_safetensors_header,
    )

    t_phase = time.perf_counter()
    with tempfile.TemporaryDirectory(prefix="smoke-sink-") as tmp:
        model = sink_test_tensors(torch)
        raw = unaligned_file(os.path.join(tmp, "m.safetensors"), model)
        all_dtypes = every_dtype_tensors(torch)
        raw_all = unaligned_file(os.path.join(tmp, "d.safetensors"),
                                 all_dtypes)
    copy_s, staging_s = {}, {}
    for case, (data, sources, piece) in {
            "reversed": (raw, model, 1000),
            "every_dtype_reversed": (raw_all, all_dtypes, 333)}.items():
        sink = HBMSink(len(data), device=dev)
        for off in reversed(range(0, len(data), piece)):
            sink.write(off, data[off:off + piece])
        copy_s[case] = sink_case(torch, dev, sink, sources)
        staging_s[case] = sink.staging_seconds

    first = parse_safetensors_header(raw)[0][0]
    sink = HBMSink(len(raw), device=dev)
    sink.write(0, raw[:first.end])  # header + first tensor only
    deadline = time.monotonic() + 30
    while sink.tensors_on_device < 1:
        if time.monotonic() > deadline:
            raise AssertionError("eager: the first tensor never landed")
        time.sleep(0.01)
    eager_before_rest = sink.tensors_on_device
    sink.write(first.end, raw[first.end:])
    copy_s["eager"] = sink_case(torch, dev, sink, model)

    sink = HBMSink(100, device=dev)
    try:
        sink.write(90, b"x" * 20)
        raise AssertionError("a write past the end was accepted")
    except ValueError as exc:
        past_end = str(exc)
    sink.close()

    sink = HBMSink(len(raw), device=dev)
    sink.write(0, raw[:first.start])  # the header only
    try:
        sink.wait(timeout=0.2)
        raise AssertionError("wait did not time out")
    except TimeoutError as exc:
        timeout_msg = str(exc)
    sink.close()
    if not timeout_msg.startswith(f"hbm sink: 0/{len(model)} tensors"):
        raise AssertionError(f"timeout message {timeout_msg!r}")
    log("hbm_sink_small", device=str(dev),
        data_start=parse_safetensors_header(raw)[1],
        tensors={"model": len(model), "every_dtype": len(all_dtypes)},
        copy_event_seconds=copy_s, staging_seconds=staging_s,
        eager_on_device_before_rest=eager_before_rest,
        past_end=past_end, timeout=timeout_msg,
        seconds=time.perf_counter() - t_phase)


def llama_shard_specs(layers: int) -> list:
    """(name, shape) of Llama-3-8B's embedding and first ``layers``
    decoder layers, in the order of its first safetensors shard."""
    h, f = LLAMA3_8B["hidden"], LLAMA3_8B["intermediate"]
    kv = LLAMA3_8B["kv_width"]
    specs = [("model.embed_tokens.weight", (LLAMA3_8B["vocab"], h))]
    for i in range(layers):
        p = f"model.layers.{i}."
        specs += [(p + "self_attn.q_proj.weight", (h, h)),
                  (p + "self_attn.k_proj.weight", (kv, h)),
                  (p + "self_attn.v_proj.weight", (kv, h)),
                  (p + "self_attn.o_proj.weight", (h, h)),
                  (p + "mlp.gate_proj.weight", (f, h)),
                  (p + "mlp.up_proj.weight", (f, h)),
                  (p + "mlp.down_proj.weight", (h, f)),
                  (p + "input_layernorm.weight", (h,)),
                  (p + "post_attention_layernorm.weight", (h,))]
    return specs


def bf16_bytes(shape) -> int:
    return 2 * int(np.prod(shape))


def write_llama_shard(path: str, specs: list) -> dict:
    """Write the shard as bf16 safetensors, each tensor's bytes from its
    own seeded stream, data offsets padded to FANOUT_ALIGN; returns the
    sha256 of each tensor's bytes."""
    import hashlib
    import struct

    header, offset = {}, 0
    for name, shape in specs:
        n = bf16_bytes(shape)
        header[name] = {"dtype": "BF16", "shape": list(shape),
                        "data_offsets": [offset, offset + n]}
        offset += n + (-n) % FANOUT_ALIGN
    header["__metadata__"] = {"format": "pt"}
    raw = json.dumps(header).encode()
    raw += b" " * ((-(8 + len(raw))) % FANOUT_ALIGN)
    digests = {}
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(raw)))
        f.write(raw)
        for i, (name, shape) in enumerate(specs):
            rng = np.random.default_rng((SEED, i))
            digest, left = hashlib.sha256(), bf16_bytes(shape)
            while left:
                chunk = rng.bytes(min(left, FANOUT_CHUNK))
                digest.update(chunk)
                f.write(chunk)
                left -= len(chunk)
            f.write(b"\0" * ((-bf16_bytes(shape)) % FANOUT_ALIGN))
            digests[name] = digest.hexdigest()
    return digests


def fanout_mesh(root: str):
    """The port's in-process config #5 topology, built as
    ``tests/test_p2p_e2e.py`` builds the JAX one: the scheduler service
    (resource model, scheduling core, dataset storage); returns it and a
    function that starts a daemon on it."""
    from dragonfly2_tpu_torch.client.daemon import Daemon, DaemonConfig
    from dragonfly2_tpu_torch.scheduler.evaluator.base import BaseEvaluator
    from dragonfly2_tpu_torch.scheduler.resource.resource import Resource
    from dragonfly2_tpu_torch.scheduler.scheduling.core import (
        Scheduling,
        SchedulingConfig,
    )
    from dragonfly2_tpu_torch.scheduler.service import SchedulerService
    from dragonfly2_tpu_torch.scheduler.storage.storage import Storage

    scheduler = SchedulerService(
        resource=Resource(),
        scheduling=Scheduling(BaseEvaluator(), SchedulingConfig(
            retry_interval=0.01, retry_back_to_source_limit=2)),
        storage=Storage(os.path.join(root, "datasets")))

    def daemon(name: str, host_type):
        d = Daemon(scheduler, DaemonConfig(
            storage_root=os.path.join(root, name), hostname=name,
            host_type=host_type))
        d.start()
        return d

    return scheduler, daemon


def fanout_layers(tmp: str) -> int:
    """The most layers (up to FANOUT_LAYERS) whose shard fits
    FANOUT_COPIES times on the disk under ``tmp``."""
    free = shutil.disk_usage(tmp).free
    layers = FANOUT_LAYERS
    while layers > 0 and FANOUT_COPIES * sum(
            bf16_bytes(s) for _, s in llama_shard_specs(layers)) \
            + FANOUT_DISK_SLACK > free:
        layers -= 1
    return layers


def run_hbm_fanout(torch, counts, dev) -> dict:
    """BASELINE config #5 through the port's entry point: the shard at an
    origin → the in-process scheduler, a SUPER_SEED daemon and a warmed
    peer → a third daemon's ``download_to_hbm`` onto ``dev``. Launch
    counts are set to 0 just before the download and read just after."""
    import hashlib
    import tempfile
    import threading

    from dragonfly2_tpu_torch import native
    from dragonfly2_tpu_torch.client.hbm_sink import download_to_hbm
    from dragonfly2_tpu_torch.client.piece import (
        compute_piece_count,
        compute_piece_size,
    )
    from dragonfly2_tpu_torch.utils.hosttypes import HostType

    on_card = dev.type == "cuda"
    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="smoke-fanout-")
    daemons = []
    try:
        layers = fanout_layers(tmp)
        if layers < 1:
            raise AssertionError(f"{shutil.disk_usage(tmp).free} bytes free "
                                 "under the temp dir: not one layer fits")
        specs = llama_shard_specs(layers)
        reduced = [
            f"Llama-3-8B cut to its first shard's tensors: "
            f"model.embed_tokens.weight and layers 0-{layers - 1} whole "
            f"({sum(bf16_bytes(s) for _, s in specs)} data bytes; the "
            "published first shard is 4.98 of 16.06 GB)",
            "random bf16 bits from seeds, not trained weights",
            "one process: the in-process scheduler service, no gRPC"]
        if layers < FANOUT_LAYERS:
            reduced.append(f"{FANOUT_LAYERS - layers} fewer layers: "
                           "the disk under the temp dir is short")
        origin_dir = os.path.join(tmp, "origin")
        os.makedirs(origin_dir)
        path = os.path.join(origin_dir, "model.safetensors")
        t0 = time.perf_counter()
        digests = write_llama_shard(path, specs)
        write_s = time.perf_counter() - t0
        length = os.path.getsize(path)
        piece_size = compute_piece_size(length)

        with OriginServer(origin_dir) as origin:
            url = origin.url("model.safetensors")
            scheduler, start_daemon = fanout_mesh(tmp)
            daemons.append(start_daemon("seed-1", HostType.SUPER_SEED))
            scheduler.seed_peer_client = daemons[0].seed_client()
            daemons.append(start_daemon("peer-warm", HostType.NORMAL))
            t0 = time.perf_counter()
            warm = daemons[1].download_file(url)
            if not warm.success:
                raise AssertionError(f"warm download failed: {warm.error}")
            warm_s = time.perf_counter() - t0
            daemons.append(start_daemon("peer-hbm", HostType.NORMAL))

            if on_card:
                release_card_memory(torch)
                torch.cuda.reset_peak_memory_stats()
            box, timeline = {}, []
            stop = threading.Event()

            def sample():
                while not stop.wait(FANOUT_SAMPLE_S):
                    sink = box.get("sink")
                    if sink is not None:
                        timeline.append([
                            round(time.perf_counter() - t_start, 3),
                            sink._coverage.covered_bytes(),
                            sink.tensors_on_device])

            counts.reset()
            t_start = time.perf_counter()
            sampler = threading.Thread(target=sample, daemon=True)
            sampler.start()
            tensors = download_to_hbm(
                daemons[2], url, device=dev, timeout=FANOUT_TIMEOUT_S,
                on_sink=lambda s: box.update(sink=s))
            t_last_tensor = time.perf_counter() - t_start
            launches = counts.read()
            stop.set()
            sampler.join(timeout=10)
            peak_gib = (torch.cuda.max_memory_allocated() / 2**30
                        if on_card else None)
        sink = box["sink"]
        t_last_piece = sink.written_at - t_start
        landed = sorted(t - t_start for t in sink.landed.values())

        # Every tensor on the device, right dtype and shape, its bytes
        # copied back equal to the digest made when the file was written.
        t0 = time.perf_counter()
        for name, shape in specs:
            t = tensors[name]
            if (t.device != dev or t.dtype != torch.bfloat16
                    or tuple(t.shape) != shape):
                raise AssertionError(f"{name}: {t.device} {t.dtype} "
                                     f"{tuple(t.shape)}")
            back = t.reshape(-1).view(torch.uint8).cpu().numpy()
            if hashlib.sha256(back).hexdigest() != digests[name]:
                raise AssertionError(f"{name}: sha256 differs from the "
                                     "origin's")
        if set(tensors) != set(digests):
            raise AssertionError("extra or missing tensors")
        verify_s = time.perf_counter() - t0
        if not landed[0] < t_last_piece:
            raise AssertionError(f"no tensor on the device before the last "
                                 f"piece ({landed[0]} >= {t_last_piece})")

        # The same tensors copied again from staging after the fact: what
        # a download-then-copy loader pays on top of the download.
        del tensors
        staging = sink._staging
        if on_card:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        seq = []
        for spec in sink._specs:
            out = torch.empty(spec.nbytes, dtype=torch.uint8, device=dev)
            out.copy_(staging[spec.start:spec.end], non_blocking=True)
            seq.append(out)
        if on_card:
            torch.cuda.synchronize()
        seq_transfer_s = time.perf_counter() - t0
        del seq, staging
        copied = sum(spec.nbytes for spec in sink._specs)
        tail = t_last_tensor - t_last_piece
        parents = sorted({p.host.hostname
                          for r in scheduler.storage.list_download()
                          if r.host.hostname == "peer-hbm"
                          for p in r.parents})
        step = max(1, len(timeline) // 100)
        log("hbm_fanout", device=str(dev), card=nvidia_smi() if on_card
            else None, reduced=reduced, layers=layers, tensors=len(specs),
            content_bytes=length, piece_size=piece_size,
            piece_count=compute_piece_count(length, piece_size),
            native_available=native.available(),
            write_file_s=write_s, warm_download_s=warm_s,
            t_last_piece_s=t_last_piece, t_last_tensor_s=t_last_tensor,
            first_tensor_landed_s=landed[0],
            last_tensor_landed_s=landed[-1],
            tail_after_last_piece_s=tail,
            device_tail_after_last_piece_s=landed[-1] - t_last_piece,
            seq_transfer_s=seq_transfer_s,
            sequential_baseline_s=t_last_piece + seq_transfer_s,
            overlap_saving_s=t_last_piece + seq_transfer_s - t_last_tensor,
            overlap_hidden_fraction=1.0 - max(tail, 0.0) / seq_transfer_s,
            overlap_hidden_fraction_device=1.0 - max(
                landed[-1] - t_last_piece, 0.0) / seq_transfer_s,
            download_MBps=length / 1e6 / t_last_piece,
            h2d_GBps=copied / 1e9 / seq_transfer_s,
            overlapped_copy_event_GBps=copied / 1e9 / (
                sum(sink.copy_ms.values()) / 1e3) if sink.copy_ms else None,
            staging_alloc_s=sink.staging_seconds,
            sink_write_s=sink.write_seconds,
            sink_write_share=sink.write_seconds / t_last_piece,
            peak_memory_gib=peak_gib, launches=launches,
            hbm_peer_parents=parents, verify_s=verify_s,
            timeline=timeline[::step], landed_s=landed,
            seconds=time.perf_counter() - t_phase)
        if any(launches.values()):
            raise AssertionError(f"a kernel launched on the sink's path: "
                                 f"{launches}")
        return launches
    finally:
        for d in reversed(daemons):
            d.stop()
        shutil.rmtree(tmp, ignore_errors=True)


def expect_abort(service, request, code, context) -> None:
    from dragonfly2_tpu_torch.inference.sidecar import RpcAbort

    try:
        service.ModelInfer(request, context)
    except RpcAbort as exc:
        if exc.code != code:
            raise AssertionError(f"expected {code}, got {exc.code}") from exc
        return
    raise AssertionError(f"expected {code}, request was answered")


def p50_ms(fn, n: int = 50) -> float:
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        times.append((time.perf_counter() - t0) * 1e3)
    return sorted(times)[n // 2]


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    try:
        import dragonfly2_tpu_torch  # noqa: F401
    except ImportError as exc:
        print(f"chip_smoke: the port package is missing: {exc}",
              file=sys.stderr)
        return 2
    from dragonfly2_tpu_torch.data import ArrayDataset, SyntheticCluster
    from dragonfly2_tpu_torch.inference.scorer import ParentScorer
    from dragonfly2_tpu_torch.inference.sidecar import (
        CallContext,
        InferenceService,
        ModelInferRequest,
        ModelReadyRequest,
        ServerReadyRequest,
        StatusCode,
        _gat_scorer_from_artifact,
        _scorer_from_artifact,
    )
    from dragonfly2_tpu_torch.models.graph_transformer import (
        GraphTransformer,
        _flash_block,
        build_neighbor_lists,
        pad_graph_sparse,
        pad_multiple,
    )
    from dragonfly2_tpu_torch.models.mlp import (
        FEATURE_DIM,
        MLPBandwidthPredictor,
        Normalizer,
    )
    from dragonfly2_tpu_torch.ops import _build
    from dragonfly2_tpu_torch.train.checkpoint import (
        ModelMetadata,
        flax_from_gat_state_dict,
        flax_from_mlp_state_dict,
        gat_tree,
        mlp_tree,
        write_artifact,
    )
    from dragonfly2_tpu_torch.train.gat_trainer import GATTrainConfig

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    t_start = time.perf_counter()
    dev = torch.device("cuda")
    kind = torch.cuda.get_device_name(0)
    smi = nvidia_smi()
    log("card", kind=kind, count=torch.cuda.device_count(), nvidia_smi=smi,
        torch=torch.__version__, cuda=torch.version.cuda)

    # -- phase 2: build ------------------------------------------------------
    t0 = time.perf_counter()
    reports = _build.build_all()
    log("build", seconds=time.perf_counter() - t0,
        source_seconds={name: rep["seconds"] for name, rep in reports.items()},
        ptxas={name: [ln.strip() for ln in rep["ptxas"].splitlines()
                      if "registers" in ln or "spill" in ln]
               for name, rep in reports.items()})

    # -- config #3 graph -------------------------------------------------------
    t0 = time.perf_counter()
    graph = SyntheticCluster(n_hosts=N_HOSTS, seed=SEED).probe_graph(N_EDGES)
    nbr, val = build_neighbor_lists(graph.n_nodes, graph.edge_src,
                                    graph.edge_dst, graph.edge_rtt_ns,
                                    cap=NEIGHBOR_CAP)
    # Gather mode trains unpadded on one device; blocks mode pads rows to
    # the 1024-row key blocks (gat_trainer: pad_multiple(n_data, chunk, N)).
    gather_graph = pad_graph_sparse(graph.node_features, nbr, val, 1)
    blocks_graph = pad_graph_sparse(
        graph.node_features, nbr, val,
        pad_multiple(1, GAT_CFG["chunk"], graph.n_nodes))
    log("graph", seconds=time.perf_counter() - t0, n_nodes=graph.n_nodes,
        n_edges=graph.n_edges, neighbor_width=int(nbr.shape[1]),
        blocks_rows=int(blocks_graph[0].shape[0]))

    # -- phase 3: kernels against their plain versions -------------------------
    gen = torch.Generator(device=dev).manual_seed(SEED)
    heads = GAT_CFG["heads"]
    head_dim = GAT_CFG["hidden"] // heads
    n_gather = gather_graph[0].shape[0]
    g_nbr = torch.from_numpy(gather_graph[1]).to(dev)
    kv_table = torch.randn(n_gather, 2 * heads * head_dim, generator=gen,
                           device=dev).to(torch.bfloat16)
    gather_idx = torch.where(g_nbr >= n_gather, 0, g_nbr).reshape(-1)
    rows = [check_table_gather(torch, kv_table, gather_idx)]
    check_table_gather_widths(torch)

    n_blocks = blocks_graph[0].shape[0]
    q, k, v = (torch.randn(n_blocks, heads, head_dim, generator=gen,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    b_nbr = torch.from_numpy(blocks_graph[1]).to(dev)
    b_val = torch.from_numpy(blocks_graph[2]).to(dev)
    rows.append(check_graph_flash(
        torch, q, k, v, b_nbr, b_val,
        _flash_block(n_blocks, GAT_CFG["chunk"])))
    del kv_table, gather_idx, q, k, v
    check_flash_shapes(torch)
    check_scatter_cases(torch)
    check_small_model(torch)

    # -- phase 4: the main path ----------------------------------------------
    model = GraphTransformer(**GAT_CFG,
                             generator=torch.Generator().manual_seed(SEED))
    params = flax_from_gat_state_dict(model.state_dict())
    artifacts = {}
    for mode, (feats, m_nbr, m_val, _) in (("gather", gather_graph),
                                           ("blocks", blocks_graph)):
        artifacts[mode] = write_artifact(
            gat_tree(params, feats, m_nbr, m_val, node_ids=graph.node_ids),
            ModelMetadata(model_id=f"smoke-gat-{mode}", model_type="gat",
                          config=dict(GAT_CFG, attention=mode)))
    rng = np.random.default_rng(SEED)
    features = rng.uniform(0, 100, (4096, FEATURE_DIM)).astype(np.float32)
    mlp = MLPBandwidthPredictor(generator=torch.Generator().manual_seed(SEED))
    norm = Normalizer.fit(features)
    target = Normalizer(np.array([2.5], np.float32),
                        np.array([0.7], np.float32))
    mlp_artifact = write_artifact(
        mlp_tree(flax_from_mlp_state_dict(mlp.state_dict()), norm, target),
        ModelMetadata(model_id="smoke-mlp", model_type="mlp",
                      config={"hidden": [128, 128, 64]}))

    counts = Counts()
    counts.reset()
    torch.cuda.reset_peak_memory_stats()
    scorers, load_s = {}, {}
    for mode in ("gather", "blocks"):
        t0 = time.perf_counter()
        scorers[mode] = _gat_scorer_from_artifact(artifacts[mode])
        torch.cuda.synchronize()
        load_s[mode] = time.perf_counter() - t0
    mlp_scorer = _scorer_from_artifact(mlp_artifact)

    # One dispatch a request, as these phases have always timed it; the
    # micro-batcher's phases follow.
    service = InferenceService(micro_batch=False)
    ctx = CallContext()
    pairs = [rng.integers(0, N_HOSTS, (16, 2)) for _ in range(5)]
    answers = {}
    for mode in ("gather", "blocks"):
        service.install_scorer("gat", scorers[mode], version=mode)
        answers[mode] = [service.ModelInfer(
            ModelInferRequest("gat", p), ctx).outputs for p in pairs]
    service.install_scorer("mlp", mlp_scorer, version="smoke")
    mlp_out = [service.ModelInfer(
        ModelInferRequest("mlp", features[i * 15:(i + 1) * 15]), ctx).outputs
        for i in range(5)]
    launches = counts.read()
    peak_gib = torch.cuda.max_memory_allocated() / 2**30
    log("main_path", launches=launches, load_seconds=load_s,
        peak_memory_gib=peak_gib)
    for name in ("table_gather", "graph_flash_attention"):
        if launches[name] < 1:
            raise AssertionError(f"{name} never launched on the main path")

    # What came out: shapes, finiteness, gather ≡ blocks, MLP ≡ f32 CPU.
    emb = {m: s.embeddings.float() for m, s in scorers.items()}
    if emb["gather"].shape != (N_HOSTS, GAT_CFG["embed"]) or emb[
            "blocks"].shape != (n_blocks, GAT_CFG["embed"]):
        raise AssertionError(f"embedding shapes {emb['gather'].shape}, "
                             f"{emb['blocks'].shape}")
    if not all(torch.isfinite(e).all() for e in emb.values()):
        raise AssertionError("non-finite embeddings")
    emb_err = float((emb["gather"] - emb["blocks"][:N_HOSTS]).abs().max())
    score_err = max(float(np.abs(a - b).max()) for a, b in
                    zip(answers["gather"], answers["blocks"]))
    if emb_err > MODE_TOL or score_err > MODE_TOL:
        raise AssertionError(f"gather vs blocks: embeddings {emb_err}, "
                             f"scores {score_err} > {MODE_TOL}")
    mlp_f32 = MLPBandwidthPredictor(dtype=torch.float32)
    mlp_f32.load_state_dict(mlp.state_dict())
    cpu_mlp = ParentScorer(mlp_f32, norm, target, device="cpu")
    mlp_err = max(float(np.abs(out - cpu_mlp.score(
        features[i * 15:(i + 1) * 15])).max())
        for i, out in enumerate(mlp_out))
    if not (all(np.isfinite(o).all() and o.shape == (16,)
                for a in answers.values() for o in a)
            and all(np.isfinite(o).all() and o.shape == (15,)
                    for o in mlp_out)):
        raise AssertionError("bad response shapes or values")
    if mlp_err > MLP_TOL:
        raise AssertionError(f"mlp card vs f32 CPU: {mlp_err} > {MLP_TOL}")
    log("outputs", embed_gather_vs_blocks=emb_err,
        score_gather_vs_blocks=score_err, mlp_vs_f32_cpu=mlp_err)

    expect_abort(service, ModelInferRequest("nope", features[:2]),
                 StatusCode.NOT_FOUND, ctx)
    expect_abort(service, ModelInferRequest("mlp", features[:2, :5]),
                 StatusCode.INVALID_ARGUMENT, ctx)
    expect_abort(service, ModelInferRequest("gat", np.zeros((2, 3))),
                 StatusCode.INVALID_ARGUMENT, ctx)
    expect_abort(service, ModelInferRequest("gat", np.array([[0, N_HOSTS]])),
                 StatusCode.INVALID_ARGUMENT, ctx)
    expect_abort(service, ModelInferRequest("mlp", features[:65]),
                 StatusCode.INVALID_ARGUMENT, ctx)
    if not (service.ModelReady(ModelReadyRequest("gat"), ctx).ready
            and service.ServerReady(ServerReadyRequest(), ctx).ready):
        raise AssertionError("service not ready")
    request_p50 = {
        "gat": p50_ms(lambda: service.ModelInfer(
            ModelInferRequest("gat", pairs[0]), ctx)),
        "mlp": p50_ms(lambda: service.ModelInfer(
            ModelInferRequest("mlp", features[:15]), ctx)),
    }
    log("requests", p50_ms=request_p50, rows={"gat": 16, "mlp": 15})

    # -- the serving plane on config #3: batcher, gate and shadow loads ------
    run_microbatch_gat(torch, scorers["gather"])
    lifecycle_launches = run_lifecycle_gat(torch, artifacts, counts)
    manager_launches = run_manager_plane(torch, artifacts, mlp_artifact,
                                         counts)

    # -- phase 5: train in gather mode, slice 2's path --------------------
    trainer, result, train_launches = run_train(
        torch, graph, GATTrainConfig(**TRAIN_CFG), counts, "train")
    serve_trained(torch, result, graph, service, ctx, pairs, "train_to_serve")
    gather_quality = {"f1": result.f1, "accuracy": result.accuracy}
    del result

    # -- the scatter-add kernel on the trainer's own inverse index ------------
    ct = torch.randn(trainer.nbr.size, 2 * heads * head_dim, generator=gen,
                     device=dev).to(torch.bfloat16)
    t_idx = torch.from_numpy(np.where(trainer.nbr >= trainer.nbr.shape[0], 0,
                                      trainer.nbr).reshape(-1)).to(dev)
    rows.append(check_table_scatter_add(torch, ct, t_idx, trainer.g_inv,
                                        trainer.nbr.shape[0]))
    del ct, t_idx, trainer

    # -- phase 6: train in blocks mode through K1's forward and backward ----
    blocks_cfg = GATTrainConfig(**TRAIN_CFG, attention="blocks")
    trainer, result, blocks_launches = run_train(
        torch, graph, blocks_cfg, counts, "train_blocks")
    gaps = {"f1": abs(result.f1 - gather_quality["f1"]),
            "accuracy": abs(result.accuracy - gather_quality["accuracy"])}
    log("train_blocks_vs_gather", f1={"blocks": result.f1,
                                      "gather": gather_quality["f1"]},
        accuracy={"blocks": result.accuracy,
                  "gather": gather_quality["accuracy"]},
        gaps=gaps, tol={"f1": TRAIN_F1_ATOL,
                        "accuracy": TRAIN_ACCURACY_ATOL})
    if gaps["f1"] > TRAIN_F1_ATOL or gaps["accuracy"] > TRAIN_ACCURACY_ATOL:
        raise AssertionError(f"blocks vs gather quality gaps {gaps}")
    serve_trained(torch, result, graph, service, ctx, pairs,
                  "train_blocks_to_serve")
    del result

    # -- the K1 backward on the blocks trainer's graph and inverse index ----
    b_rows = trainer.nbr.shape[0]
    q, k, v = (torch.randn(b_rows, heads, head_dim, generator=gen,
                           device=dev).to(torch.bfloat16) for _ in range(3))
    rows.append(check_k1_backward(torch, q, k, v, trainer.g_nbr,
                                  trainer.g_val, trainer.g_inv))
    del q, k, v, trainer

    # -- phase 7: embedding-pass times (launches here are not counted) -------
    pass_ms = {}
    for mode, (feats, m_nbr, m_val, _) in (("gather", gather_graph),
                                           ("blocks", blocks_graph)):
        gpu_model = scorers[mode]._model
        args = [torch.from_numpy(a).to(dev) for a in (feats, m_nbr, m_val)]
        with torch.no_grad():
            pass_ms[mode] = cuda_ms(
                torch, lambda: gpu_model.node_embeddings(*args),
                iters=5, warmup=1)
    log("embedding_pass", ms=pass_ms,
        peak_memory_gib=torch.cuda.max_memory_allocated() / 2**30,
        total_seconds=time.perf_counter() - t_start)
    del scorers, service

    # -- phase 8: K3 against its plain version, then Ulysses ------------------
    k3 = check_k3(torch, LONG_T, 8, 8, torch.bfloat16)  # main-path shape
    check_k3(torch, LONG_T, 8, 8, torch.float32)
    wide = check_k3(torch, LONG_T, 4, 128, torch.bfloat16)
    if wide["route"] != "sm90":
        raise AssertionError(f"[{LONG_T}, 4, 128] bf16 took the "
                             f"{wide['route']} route, not sm90")
    dim32 = check_k3(torch, LONG_T, 8, 32, torch.bfloat16)
    if dim32["route"] != "mma":
        raise AssertionError(f"[{LONG_T}, 8, 32] bf16 took the "
                             f"{dim32['route']} route, not mma")
    # The K3 rows are the main path's shape; the head_dim-128 and
    # head_dim-32 figures ride along under "at_head_dim_128" / "_32".
    for part in ("fwd", "bwd"):
        k3[part]["k3_route"] = k3["route"]
        k3[part]["backward_parts_ms"] = k3["parts_ms"]
        for key, other in (("at_head_dim_128", wide),
                           ("at_head_dim_32", dim32)):
            k3[part][key] = {
                name: other[part][name] for name in
                ("source", "ms", "plain_ms", "bound_ms", "bound_by",
                 "library_ms", "max_abs_err", "exp_split")
                if name in other[part]} | {
                "k3_route": other["route"], "shape": other["shape"],
                "backward_parts_ms": other["parts_ms"]}
    rows += [k3["fwd"], k3["bwd"]]
    check_k3_shapes(torch)
    ulysses_launches = run_ulysses(torch, counts)

    # Each kernel counts on the path of the slice that ported it.
    home = {"table_scatter_add": "train", "flash_attention": "ulysses",
            "flash_attention_backward": "ulysses",
            "graph_flash_attention_backward": "train_blocks"}
    ring_launches = run_ring_one(torch, counts)

    # -- phase 11: GraphSAGE, config #2, slice 7's path -----------------------
    check_gnn_small_model(torch)
    t0 = time.perf_counter()
    gnn_graph = SyntheticCluster(n_hosts=GNN_HOSTS, seed=SEED).probe_graph(
        GNN_EDGES)
    log("gnn_graph", seconds=time.perf_counter() - t0,
        n_nodes=gnn_graph.n_nodes, n_edges=gnn_graph.n_edges)
    gnn_trainer, gnn_result, gnn_launches = run_train_gnn(
        torch, gnn_graph, counts, True, "train_gnn")
    gnn_to_artifact(torch, gnn_trainer, gnn_result, gnn_graph)
    check_gnn_sampling(torch, gnn_trainer)
    # K2a at the GraphSAGE shape: the [N, 8] f32 feature table and one
    # step's concatenated indices; it rides on the K2a row.
    gnn_idx = gnn_step_indices(torch, gnn_trainer)
    gnn_row = check_table_gather(torch, gnn_trainer.node_features, gnn_idx)
    log("gather_library_profile", **gather_library_profile(
        torch, gnn_trainer.node_features, gnn_idx))
    rows[0]["at_graphsage"] = {
        name: gnn_row[name] for name in
        ("source", "ms", "plain_ms", "bound_ms", "bound_by", "library_ms",
         "max_abs_err", "wrapper_ms")} | {
        "shape": {"table": list(gnn_trainer.node_features.shape),
                  "idx": list(gnn_idx.shape)},
        "launches": gnn_launches["table_gather"]}
    del gnn_trainer, gnn_result, gnn_idx
    # The host-sampling path: batches sampled in prefetch threads, placed
    # on the card, gathered through K2a.
    host_launches = run_train_gnn(torch, gnn_graph, counts, False,
                                  "train_gnn_host")[2]
    del gnn_graph

    # -- phase 12: config #1, the cost model and the evaluators, slice 9 ------
    check_mlp_small_model(torch)
    t0 = time.perf_counter()
    mlp_x, mlp_y = SyntheticCluster(
        n_hosts=MLP_HOSTS, seed=SEED).pair_example_columns(MLP_ROWS)
    log("mlp_data", seconds=time.perf_counter() - t0, rows=len(mlp_x))
    mlp_result, mlp_launches = run_train_mlp(torch, mlp_x, mlp_y, counts)[1:]
    eval_x = ArrayDataset(mlp_x, mlp_y).split(
        MLP_CFG["eval_fraction"], SEED)[1].arrays[0]
    mlp_service = InferenceService(micro_batch=False)
    mlp_artifact_bytes, trained_mlp = serve_trained_mlp(
        torch, mlp_result, eval_x, mlp_service, ctx)
    check_score_corpus(torch, trained_mlp, mlp_x)
    check_ml_evaluator(torch, mlp_artifact_bytes, trained_mlp)

    # -- phase 13: the serving plane, slice 10's path ------------------------
    run_microbatch(torch, trained_mlp, eval_x)
    run_shed(torch, trained_mlp)
    run_lifecycle(torch, mlp_artifact_bytes)
    cost_artifact, cost_scorer, cost_launches = run_train_cost(
        torch, mlp_x, mlp_y, counts)
    check_cost_evaluator(torch, cost_artifact, cost_scorer)

    # -- phase 13b: the replay engine, slice 17 ------------------------------
    import tempfile

    replay_tmp = tempfile.mkdtemp(prefix="smoke-replay-")
    try:
        t0 = time.perf_counter()
        replay_corpus = run_replay_store(torch, replay_tmp)
        replay_launches = run_replay_vectorized(
            torch, replay_corpus, mlp_artifact_bytes, cost_artifact, counts)
        del replay_corpus
        log("replay_phases", seconds=time.perf_counter() - t0)
    finally:
        shutil.rmtree(replay_tmp, ignore_errors=True)

    # -- phase 13c: the replay plane's recording half, slice 18 -------------
    record_tmp = tempfile.mkdtemp(prefix="smoke-record-")
    try:
        t0 = time.perf_counter()
        run_swarm_record(torch, record_tmp, mlp_artifact_bytes,
                         cost_artifact, counts)
        replay_ab_launches = run_replay_ab_phase(torch, counts)
        run_swarm_ladder_phase()
        run_recorder_overhead_phase()
        log("recording_phases", seconds=time.perf_counter() - t0)
    finally:
        shutil.rmtree(record_tmp, ignore_errors=True)

    # -- phase 14: the training orchestrator, slice 11's path ---------------
    training_launches, training_predicted, training_evals = run_training(
        torch, mlp_x, mlp_y, counts)

    # -- phase 14b: the ML loop's collection half, slice 19 ------------------
    probe_launches = run_probe_loop(torch, counts)

    # -- phase 15: federated training, config #4, slice 12 ------------------
    check_profiler_sees_kernels(torch)
    federated_launches = run_federated(torch, counts)
    config4_launches = run_federated_config4(torch, counts)

    # -- phase 16: data parallelism, slice 13 -------------------------------
    dp_launches = run_data_parallel(torch, mlp_x, mlp_y, {
        "evaluations": training_evals, "predicted": training_predicted})

    # -- phase 17: BASELINE config #5, slice 14 -----------------------------
    card0 = torch.device("cuda", 0)
    run_hbm_sink_small(torch, card0)
    fanout_launches = run_hbm_fanout(torch, counts, card0)

    # -- phase 18: sequence, pipeline and expert parallelism, slice 15 ------
    par_launches = run_parallel(torch, graph)

    # -- phase 19: tensor parallelism, slice 16 -----------------------------
    tp_launches = run_tensor_parallel(torch, graph, rows)
    run_hbm_sink_sharded(torch, card0)

    for row in rows:
        by_path = {"serve": launches[row["name"]],
                   "train": train_launches[row["name"]],
                   "train_blocks": blocks_launches[row["name"]],
                   "ulysses": ulysses_launches[row["name"]],
                   "ring_one": ring_launches[row["name"]],
                   "train_gnn": gnn_launches[row["name"]],
                   "train_gnn_host": host_launches[row["name"]],
                   "train_mlp": mlp_launches[row["name"]],
                   "train_cost": cost_launches[row["name"]],
                   "replay": replay_launches[row["name"]],
                   "replay_ab": replay_ab_launches[row["name"]],
                   "lifecycle": lifecycle_launches[row["name"]],
                   "manager_plane": manager_launches[row["name"]],
                   "training": training_launches[row["name"]],
                   "probe_loop": probe_launches[row["name"]],
                   "federated": federated_launches[row["name"]],
                   "federated_config4": config4_launches[row["name"]],
                   "data_parallel": dp_launches[row["name"]],
                   "hbm_fanout": fanout_launches[row["name"]],
                   **{path: par[row["name"]]
                      for path, par in par_launches.items()},
                   "tensor_parallel": tp_launches[row["name"]]}
        row["launches"] = by_path[home.get(row["name"], "serve")]
        row["launches_by_path"] = by_path
    log("total", seconds=time.perf_counter() - t_start)

    print(json.dumps({"kernels": rows}), flush=True)
    print(nvidia_smi(), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": kind,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
