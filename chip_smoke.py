#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port on one NVIDIA card and hold its kernels
against their plain PyTorch versions.

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py

Phases, each printing one JSON line (``"phase": ...``):

1. build     nvcc-build ``parameter_server_tpu_torch/csrc/scatter_kernels.cu``.
2. kernels   each of the four kernels against its plain version at dim 1, 3,
             4, 128 and 1024 and on misaligned views (storage offset 1), ids
             with trash pads: gather and scatter-set of 1 to 4 planes in one
             launch, scatter-add, apply under all four optimizers (the trash
             row must keep its fill); the public ``scatter_add_rows`` with
             repeated ids against ``index_put_(accumulate=True)``; then
             ``KVTable.push`` at the main path's full width on the card and
             on the CPU, every row of every plane, trash rows at their fill.
3. main      BASELINE config #1 at full width: 2 KVServers + 2 KVWorkers on a
             LoopbackVan, 2^22 x 1 AdaGrad (lr 0.05) table, batch 16384 x 39
             keys of SyntheticCTR(2^26 keys), AsyncLRLearner under BSP.  The
             loss must fall, every table must be on the card, the fused
             apply and gather kernels must have launched (one gather per
             pull), and every trash row must still hold its fill; then a
             small run of the same loop on the card must agree with it on
             the CPU, and a seeded push sequence at full width must give
             bitwise-equal tables twice (the worker pre-combine is
             deterministic).  Every server runs its default apply ledger:
             after the run, applies submitted == retired == pushes, none
             censored, one ``apply.w`` digest sample a push.
4. three_pass  the same loop with ``fused_apply=False``: one scatter-set
             launch (value + sum_sq) per push.
5. bundled   ``handle_request_batch`` at the apply-engine shape (16 x 2048
             ids from a 2048-row hot set, dim 128, Adam, 2^15 rows) under both
             duplicate policies, twice each: bitwise-equal tables, and close
             to the same bundle on the CPU.
6. combine   ``combine_and_scatter_add`` on one batch's slots (scatter-add).
7. ledger    the main run's ledger digests (p50/p99 of apply, apply_host,
             apply_h2d, apply_dev); the PS loop with the ledger on and off in
             10 pairs, alternating which runs first (examples/s medians and
             quartiles, pairs won); the push ack path
             (single push and a bundle) under ``set_sync_debug_mode("error")``
             and a stale-epoch push fenced; a blocking and a spinning CUDA
             event waited on from a second thread (does the wait release the
             GIL); ``LedgerConfig(backlog_bundles=1)`` at the apply-engine
             shape with 16 pushes back to back, as sent and with the card held
             behind a ``torch.cuda._sleep``: ``server_busy()`` and
             ``apply.backlog`` enter then clear.
   coalesce  the PS loop on ``CoalescingVan(LoopbackVan())`` (counters,
             launches); an ordered full-width loop (each worker's push and
             next pull in one window) on the plain and the coalescing stack:
             bitwise-equal tables; the apply-engine shape sent by one worker
             in one ``coalesce_window``: one bundle, one
             ``handle_request_batch``, one ledger entry, ``ps_apply`` launches
             per bundle, and bench.py's ms per bundle against the same pushes
             one request each, under both duplicate policies ("rounds"
             bitwise equal to per-request; "combine" within 1e-5 of one push
             of the per-row sums).
   localizer one config #1 batch through ``Localizer(2^22)``: the native
             keymap must have built (g++) and give the numpy engine's slots;
             keys per second of both engines (host clock).
   flightrec a failing handler on a throwaway node journals
             ``recv.exception`` and keeps serving; ``dump()`` of the run's
             ring, each bundle read back with the fields
             ``tools/postmortem.py`` reads; events by kind.
   hier      bench.py's hierarchical-push arm at config #1 width: 4 workers x
             2 servers on ``CoalescingVan(MeteredVan(LoopbackVan()))``, every
             worker on the same SyntheticCTR(seed 5) batches, barrier-locked
             pull_sync -> card gradient -> push_sync; group sizes 1, 2 and 4,
             3 warm-up then 5 timed steps.  PUSH requests into the servers per
             timed step must be 2 x 4 / size, no fallback, the servers' group
             booking one apply per group step; ``ps_gather`` launches =
             served pulls, ``ps_apply`` = applied pushes.  Then the size-2 arm
             for 2 steps on the card and on the CPU: tables within 1e-5.
   consist   the wire gate at the same width: 3 workers x 2 servers on a
             LoopbackVan, ``gate_deadline_s=30``, arms bsp, ssp1, ssp4 and
             asp, 8 steps a worker, worker 0 pausing 0.06 s at seeded steps;
             the servers' fleet clocks sampled about every millisecond must
             never spread past bound + 1 (bsp: 1), every arm must end within
             its budget with nothing forced through; launches as in ``hier``.
             A park leg (bsp, worker 0 pausing 0.5 s before step 1) must be
             deferred at the gate and released.  Then 2 workers strictly alternating 6 steps under BSP: tables
             bitwise equal to the ungated run.
8. local    bench.py's headline path at full width: ``LocalLRTrainer(mode=
             "dense", device_hash=True)`` on the same 2^22 x 1 AdaGrad table,
             blocks of 32 steps of 16384 x 39 raw uint32 keys hashed on the
             card, fed by ``PrefetchPipeline(depth=2)`` from a pool of 4
             distinct blocks: 2 warm-up blocks, then timed blocks.  The loss
             must fall, the tables must be on the card, the trash row 0.
   local_reference  one 4-step block from the trained state on the card and
             on the CPU (losses 1e-4, every row 1e-5, trash row exactly 0);
             the same block twice on the card gives bitwise-equal tables;
             ``mix32_torch`` and ``device_slots`` on the card equal the host
             hash bit for bit.
   local_sync_free  one ``step_block_device`` under
             ``torch.cuda.set_sync_debug_mode("error")``.
   local_rows  rows mode at full width, 4 steps on the card and the CPU from
             one state: one gather and one apply launch per step (three-pass:
             one gather and one scatter-set), card and CPU agree.
   local_profile  ``torch.profiler`` over 2 blocks of the local path: wall,
             device busy, idle share, top device ops, the segment sum's share.
   dlrm      BASELINE config #3 at bench.py's stepped shape through
             ``parallel/dlrm_scale.scale_run``: ``SpmdDLRMTrainer`` over a
             2^28 x 16 AdaGrad table (value + sum_sq, 32 GiB on the card, read
             from the tensors), batch 8192 of SyntheticDLRM(seed 3), 1 warm +
             4 timed steps; one two-plane ``ps_gather`` and one two-plane
             ``ps_scatter_set`` launch a step; the host localize and the rest
             of a step; one step's peak memory less the table below table / 8;
             the trash row at its fill; 5 steps on one batch lower the loss;
             both kernels at the top 1024 rows of the table (element offsets
             past 2^32) against the plain versions; both kernels' times at the
             step's shape (8 consecutive batches' slots, CUDA-graph replay)
             beside the byte bound; then the 2^22 control and the step-time
             flatness ratio.  The MFU of the timed steps: the dense part's
             matmul FLOPs (``counted_flops`` on ``meta`` copies) against the
             card's fp32 peak (the MLPs run in fp32: TF32 off), within
             (0, 100%).
   dlrm_profile  ``torch.profiler`` over 3 steps: device busy, idle share,
             top device ops, the segment sum's share.
   dlrm_reference  the test's shape (2^14 x 16, batch 256) from one state on
             the card twice and on the CPU, both TF32 flags off: 1 step within
             1e-5, 5 steps within 1e-4, the two card runs bitwise equal.
   dense_spmd  BASELINE config #2: ``SpmdDenseTrainer`` with ResNet-50 (224 x
             224, 1000 classes, one fixed batch of 64, SGD momentum 0.9):
             images/s, peak memory, the loss falling, 2 steps profiled; a
             tiny ResNet on the card and the CPU, TF32 off, within 1e-4.  The
             MFU of the timed steps against the card's TF32 peak (torch's
             default runs the convolutions in TF32), within (0, 100%).
   dense_async  ``AsyncDenseLearner``, 2 workers x 2 servers (``DenseKVServer``
             on the card) on ``MeteredVan(LoopbackVan())`` under BSP,
             ResNet-50, a fixed batch of 64 each: images/s, PUSH and PULL
             bytes a step, the loss falling, BatchNorm statistics local; 2
             more steps profiled.
   dense_ckpt  ResNet-50's flat vector on 2 ``DenseKVServer``s with AdaGrad,
             one seeded push, ``DenseKVWorker.save_model``, ``load_model``
             onto 3 servers: value and state bitwise equal; write and read s.
   serve     the serving plane over config #3's table: 2 KVServers holding
             2^28 x 16 AdaGrad (2^27 + 1 rows a shard, value + sum_sq, 32
             GiB read from the tensors) and one KVWorker with
             ``HotRowCache(65536)`` and ``ServeConfig()``: one ``push_sync``
             of seeded gradients at the load generator's 65,536 hottest keys,
             each shard's ``ps_apply`` held to its plain version on the same
             ids (trash pads included) and gradients; ``pull(read_only=True)``
             == ``pull_sync`` == the planes' rows by ``index_select``;
             ``pull_serve`` cold == ``pull_sync``, warm all hits with no
             gather launch, after a write to 1,024 keys the new rows; the p50
             of a cached ``pull_serve`` and of an uncached ``pull_sync`` (128
             keys, 200 iterations; bench.py's JAX floor of 10x printed beside
             the ratio); open-loop Zipf(1.1) load over 2^28 keys, 8 a pull,
             through ``AdmissionController`` at 200 and 2,000 offered q/s for
             2 s (the rate achieved, p50, p99, hit rate, served/pulls,
             ``ro_pulls`` and their digest, one ``ps_gather`` a read-only
             request, nothing shed); the overload drill (``reject``, 0.5 s:
             everything shed, no read-only pull, no launch); one read-only
             request's ``handle_request`` time alone; ``ps_gather`` exact
             against its plain version at a 256-id bucket with trash pads on
             a shard, and timed; then the gate's stale-cache shed at config
             #1 width (SSP bound 0, deadline 0.4 s): one shed, the warm rows.
   replica   the replica chain at 2^27 x 16 AdaGrad: 8 ``push_sync`` steps of
             65,536 seeded keys on 2 servers (the control, 16 GiB), then on
             ``make_replicated_servers`` (2 primaries, 2 standbys, 32 GiB)
             sync, and async (max lag 4, ``device_replies``, flushed before
             the kill): S0 dies after step 4, its standby is promoted, the
             touched rows at the end bitwise equal to the control's; in each
             run the first ``ps_apply`` on every primary and standby held to
             its plain version on the same ids and gradients; push
             p50s; ``pull_result_device`` on the card equal to
             ``pull_result``, every reply value a CUDA tensor.
   durable   the durability plane over config #3's table at 2^27 x 16
             AdaGrad (the replica phase's cut; Zipf(1.1) keys, 65,536 a
             push), after the host's free disk and memory are checked:
             ``ckpt_legacy`` (config #1's table after 8 PS-loop steps,
             ``save_model`` on 2 servers, ``load_model`` onto 3, every row
             bitwise); ``migrate_chain`` (config #1's table on 2 sync
             replica chains, 2^20 rows of S0 moved to S1 with a push between
             chunks: the standbys follow through ``migrate_adopt`` /
             ``migrate_release``, bitwise equal to their primaries);
             ``snapshot`` (2 servers, 4 warm pushes, full snapshot
             step 1 with a push right after ``snap_begin`` and one after the
             segment writes, 2 pushes into S0's range, incremental step 2
             with S1's file carried, ``load_snapshot`` onto 3 servers, every
             row bitwise on the card; write s and GB/s, each commit's
             freeze and delta rows, restore s); ``migrate`` (``ShardMigrator
             (chunk_rows=65536)`` moves 2^22 rows of S0 to S1 with pushes
             between chunks, the restored fleet taking the same pushes as
             the control, every row bitwise; rows/s, the freeze, the delta,
             each ``_rebuild_table``'s ms and memory peak; ``save_checkpoint``
             refused with ``CheckpointLayoutError``); ``restart`` (snapshot
             step 3 of the migrated fleet, S1 unbound and brought back by
             ``restart_same_id`` from it: source ``partitioned``, the new
             epoch, rows bitwise equal to S1 before; the time to recover);
             the ack's dirty tracking cost.  Every ``ps_gather`` and
             ``ps_scatter_set`` launch of the 2^27 path held to
             ``index_select`` (exact), ``ps_apply`` to its plain version.
   elastic   the membership and elasticity plane at config #1 width (2^22 x 1
             AdaGrad on 2 servers, SyntheticCTR batches of 16384 x 39, 2
             batches a workload), each leg a ``launch_local_cluster`` on a
             LoopbackVan with ``ElasticTrainer``'s heartbeat thread (0.2 s)
             and the scheduler's monitor (timeout 2 s), every
             ``on_node_dead`` call recorded: ``worker_death`` (3 workers x 12
             workloads under ASP, W2 killed after 2: all done, W2 alone
             dead, kill-to-detection s, examples/s); ``server_death`` (2
             workers, a legacy checkpoint every 2 workloads, S1 disconnected:
             a pull raises; ``recover_server`` on the card bitwise the
             checkpoint, a push moves it; recovery s, checkpoint bytes);
             ``promotion`` (sync chains, ``ReplicaSet(manager=sched)``, 1
             worker x 6 workloads: S0 silent after 2 and promoted, S1
             restarted by ``restart_server`` from its standby after 4 at
             incarnation 1 with its range; the last beat to promotion; rows
             and losses bitwise the 2-server control's); ``scale``
             (``scale_up`` onto S2 streaming over workload 4, ``drain_down``
             of S1 over workload 5, each commit between workloads, tables
             adopted from the scheduler's broadcast: bitwise the control's,
             as many push retries, a nonempty delta each; rows moved,
             freezes); ``vs_cpu`` (4 workloads on the card and on the CPU:
             losses 1e-4, tables 1e-5).  Every ``ps_gather`` and
             ``ps_scatter_set`` launch held to ``index_select`` (exact), the
             first ``ps_apply`` on each table to its plain version.
   wire      the wire's reliability layer at config #1 width: 1 worker x 2
             servers (2^22 x 1 AdaGrad, lr 0.05) run 8 steps of pull_sync ->
             card gradient -> push_sync over SyntheticCTR(2^26 keys) batches
             of 16384 x 39 on three stacks: ``clean`` (LoopbackVan), ``drop``
             (``ReliableVan(ChaosVan(LoopbackVan(), seed 0, drop 0.05))``, a
             flat 0.25 s retransmit deadline) and ``framed`` (``CoalescingVan(
             MeteredVan(ReliableVan(ChaosVan(FrameCodecVan(LoopbackVan()),
             drop, duplicate and corrupt 0.05))))``: every message rides real
             frame bytes).  Losses and every row of value and sum_sq of both
             shards bitwise equal to ``clean``; the servers' pushes and the
             ``ps_apply`` / ``ps_gather`` launches equal to clean's (exactly
             once, seen at the kernel); nothing given up, drops injected, no
             pull retry, ``flush`` settled; in ``framed`` corrupt frames
             injected and rejected by the CRC, no message passed unframed,
             frame bytes above payload bytes.  Then a ``push_device`` push of
             a CUDA plane over the framed stack (one message a server): each
             passes the codec unframed (``frame_passthrough`` rises once for
             each delivery), is applied once and not rejected for good.
             Examples/s of each run, the resender's counters, server 0's
             push frame (bytes, overhead, ``encode`` / ``decode`` us, median
             of 20 on the host clock).  ``straggler``: 2 workers x 2 servers
             on ``MeteredVan(ReliableVan(ChaosVan(LoopbackVan())))`` with
             ``launch_local_cluster``: ``slow_node("S1", 120)`` gets S1
             flagged by ``FleetMonitor`` within 5 heartbeats and no healthy
             node ever; ``slow_node("S1", 0)`` and a fresh monitor over the
             traffic since: no node flagged in 5 beats.  The first
             ``ps_apply`` on each table held to its plain version, every
             ``ps_gather`` to ``index_select``.
   sockets   the production wire at config #1 width: 1 worker x 2 servers
             (2^22 x 1 AdaGrad, lr 0.05), each node on its own ``TcpVan`` on
             localhost, 8 steps of pull_sync -> card gradient -> push_sync
             over the ``wire`` batches, legs ``tcp_shm`` (epoll core, shm
             rings negotiated), ``tcp_only`` (shm off), ``threaded`` (the
             thread-per-connection core), each bitwise equal to the
             ``wire`` phase's ``clean`` LoopbackVan run (losses, every row of
             both shards, pushes, ``ps_apply`` / ``ps_gather`` launches);
             ``lossless`` (``make_chain("lossless")`` on every van) and
             ``reliable`` (``ReliableVan(ChaosVan(TcpVan, drop 0.05))``
             under the worker, ``ReliableVan(TcpVan)`` under each server;
             nothing given up), each bitwise equal to ``tcp_shm``;
             ``int8_ef`` (``CoalescingVan(codec=quantizer_from_tables)``
             with int8 error feedback on table ``w``): final loss and the
             mean of the last 3 within 0.03 of ``tcp_shm``'s, PUSH raw above
             wire bytes.  Every van's backend ``epoll`` (``threaded`` in its
             leg), shm frames in every leg but ``tcp_only``, no frame
             rejected; push / pull p50 (host clock) beside LoopbackVan's,
             payload bytes, codec overhead.  Then ``launch(device="cuda")``
             (a scheduler, 2 servers, 2 workers as OS processes, config #1
             width, 8 steps) with the default filters and with none: every
             return code 0, the loss falls, every child reports ``cuda``,
             the servers launched ``ps_gather`` and ``ps_apply``; payload
             bytes of both runs and their ratio, the codec's overhead.
             Every ``ps_gather`` of the in-process legs held to
             ``index_select``, the first ``ps_apply`` on each table to its
             plain version.
   observe   the observability plane at config #1 width: 1 worker x 2
             servers, each node on its own ``TcpVan`` (shm rings), 8 steps of
             the ``wire`` batches (the first untimed) in three trace arms:
             ``KVWorker(trace=TraceConfig(enabled=False))``, sampling 1/1024
             and 1/1.  Each arm bitwise equal to the ``wire`` phase's clean
             run, 16 ``ps_gather`` and 16 ``ps_apply`` launches each; the
             1/1024 arm's payload bytes within 1% of the off arm's; in the
             1/1 arm ``trace_samples == trace_closed > 0``.  Examples/s of
             each arm over the off arm, reported (one run an arm cannot
             resolve a 3% gate).  The 1/1 arm also carries the telemetry
             plane (a scheduler ``H`` with a ``TelemetryAggregator`` over an
             ``SloEngine`` of ``device_plane_specs`` and
             ``tracing_plane_specs``, a ``TelemetryPublisher`` on every node,
             one beat each 0.2 s) and a ``Tracer`` on every node: frames from
             every node, no dedup drop, ``tools/pstop.py`` renders the
             spill; the armed ``ro-p99`` serving spec (1 ns) shuts the
             ``AdmissionController`` within the beats its window needs,
             reads are shed, and reads flow again once it is lifted; the
             verdicts; ``tools/critpath.py`` over the flight-recorder dump
             (exit 0, every sampled request one complete span tree, a wire
             segment, planes summing to its e2e within 10%) and
             ``tools/merge_traces.py`` over the nodes' ``Tracer`` dumps
             (valid, a flow across nodes); two more steps under
             ``torch_profile``: device events of ``ps_gather`` and
             ``ps_apply`` under their ``scatter_kernels.cu`` symbols.  Then
             DLRM at 2^22 x 16, batch 8192, 4 steps, with and without its MFU
             count: losses, table and MLP bitwise equal; and the war game's
             ``smoke_scenario(0)`` on this host: the scorecard complete, the
             report's postmortem and critpath sections present.  Every
             ``ps_gather`` held to ``index_select``, the first ``ps_apply``
             on each table to its plain version.
9. times     every kernel at the main path's shapes: device time per call
             (CUDA-graph replay), the byte bound at 3.35 TB/s, the plain
             version's time and one PyTorch library call's time; an empty
             kernel's time (the launch floor); a pull's value + sum_sq gather
             and a three-pass push's value + sum_sq scatter-set, each as one
             launch, held against their plain versions and timed; at dim 1,
             gather and apply through their dim-1 forms and through the
             general row kernel; gather, Adam apply, scatter-set of 1 and 4
             planes and scatter-add at a wide shape (dim 128, 2^20 + 1 rows,
             8 disjoint id sets so L2 holds no round); the worker
             pre-combine's time.

Then the card's name and power limit (nvidia-smi), one JSON line of
per-kernel results, and ``{"ok": true, "device": {...}}`` last.  Any failed
check raises, so the script exits nonzero and prints no result; it also exits
nonzero on a machine without a card.
"""

from __future__ import annotations

import ctypes
import functools
import itertools
import json
import subprocess
import sys
import time

import numpy as np

#: H100 SXM device-memory rate (NVIDIA data sheet), for the byte bounds
HBM_BYTES_PER_S = 3.35e12
#: the main path's configuration (BASELINE config #1)
ROWS, DIM, BATCH, NNZ, KEY_SPACE = 1 << 22, 1, 16384, 39, 1 << 26
MAIN_STEPS = 8
#: the wide shape of phase ``times``: dim-128 rows, as the apply engine and
#: the embedding tables use them
WIDE_ROWS, WIDE_DIM, WIDE_N, WIDE_SETS = 1 << 20, 128, 32768, 8
THREE_PASS_STEPS = 2
#: depth of the new planes' loops: ledger on/off runs and their pairs, the
#: learner's loop on the coalescing stack, the ordered loop on both stacks
LEDGER_STEPS, LEDGER_PAIRS, COALESCE_STEPS, ORDERED_STEPS = 4, 10, 4, 3
#: the local (single-device) path: steps per block, distinct blocks in the
#: pool, warm-up and timed blocks, steps of the reference and rows legs
BLOCK, LOCAL_POOL, LOCAL_WARM, LOCAL_TIMED = 32, 4, 2, 8
LOCAL_REF_STEPS, LOCAL_ROWS_STEPS = 4, 4
#: the synchronous push plane: bench.py's hierarchical-push arm (4 workers x
#: 2 servers, group sizes 1, 2, 4; warm-up and timed steps) and its
#: consistency arms (3 workers x 2 servers, steps a worker, worker 0's
#: seeded pauses, a budget per arm)
HIER_WORKERS, HIER_SERVERS, HIER_WARM, HIER_TIMED, HIER_SIZES = 4, 2, 3, 5, (1, 2, 4)
CONSIST_WORKERS, CONSIST_STEPS, CONSIST_SLOW_P, CONSIST_SLOW_S = 3, 8, 0.25, 0.06
CONSIST_BUDGET_S = 120.0
#: the park leg: under BSP, worker 0 pauses longer than a step before step 1,
#: so its peers must be deferred at the gate and released
CONSIST_PARK_S = 0.5
CONSIST_ARMS = (("bsp", "bsp", 0), ("ssp1", "ssp", 1), ("ssp4", "ssp", 4), ("asp", "asp", 0))
#: BASELINE config #3 (DLRM): bench.py's stepped shape (2^28 x 16 AdaGrad
#: table, batch 8192 of SyntheticDLRM, 1 warm + 4 timed steps), the 2^22
#: control, the repeated-batch steps, the profiled steps, the id sets cycled
#: by the kernel timings, and the card-vs-CPU shape of tests/test_torch_dlrm.py
DLRM_ROWS_LOG2, DLRM_CONTROL_LOG2, DLRM_DIM, DLRM_BATCH, DLRM_STEPS = 28, 22, 16, 8192, 4
DLRM_MIN_BUCKET, DLRM_REPEAT_STEPS, DLRM_PROFILE_STEPS, DLRM_TIME_SETS = 1 << 14, 5, 3, 8
DLRM_REF_ROWS, DLRM_REF_BATCH, DLRM_REF_STEPS = 1 << 14, 256, 5
#: BASELINE config #2 (ResNet-50, 224 x 224, 1000 classes, 64 images a
#: batch): the single-card trainer's warm-up and timed steps and its SGD
#: (momentum 0.9) rate; the async learner's workers, servers, steps a worker
#: and the servers' SGD rate
RESNET_HW, RESNET_CLASSES, RESNET_BATCH = 224, 1000, 64
DENSE_WARM, DENSE_TIMED, DENSE_LR = 2, 6, 0.1
ASYNC_WORKERS, ASYNC_SERVERS, ASYNC_STEPS, ASYNC_LR = 2, 2, 4, 0.1
#: the serving plane over config #3's table (2^28 x 16 AdaGrad on 2 servers):
#: warm keys (the load generator's hottest ranks), the cache contract's keys
#: and written keys, the latency leg's hot keys and iterations, bench.py's
#: open-loop load (10^6 clients, Zipf 1.1, 8 keys a pull, seed 3) at two
#: per-client rates (200 and 2,000 q/s) for 2 s each, the overload drill, the
#: gather check's bucket, and the gate's stale-shed leg at config #1 width
SERVE_ROWS_LOG2, SERVE_DIM, SERVE_CACHE_ROWS = 28, 16, 1 << 16
SERVE_WARM_KEYS, SERVE_CONTRACT_KEYS, SERVE_WRITE_KEYS = 1 << 16, 1 << 14, 1024
SERVE_HOT_KEYS, SERVE_LAT_ITERS = 128, 200
SERVE_CLIENTS, SERVE_RATES, SERVE_ZIPF_S, SERVE_KEYS_PER_PULL = 1_000_000, (2e-4, 2e-3), 1.1, 8
SERVE_SEED, SERVE_RUN_S, SERVE_DRILL_S, SERVE_BUCKET = 3, 2.0, 0.5, 256
SERVE_STALE_KEYS, SERVE_STALE_DEADLINE_S = 4096, 0.4
#: the replica chain at half of serve's depth (2^27 x 16): steps of 65,536
#: seeded keys, the step after which S0 dies, the async chain's lag bound
REPLICA_ROWS_LOG2, REPLICA_STEPS, REPLICA_KEYS, REPLICA_KILL_AFTER = 27, 8, 1 << 16, 4
REPLICA_MAX_LAG, REPLICA_SEED = 4, 21
#: the durability plane at the replica phase's depth (2^27 x 16 AdaGrad):
#: seeded Zipf(1.1) keys, 65,536 a push, warm-up pushes, the migrated range
#: and its chunks
DURABLE_ROWS_LOG2, DURABLE_KEYS, DURABLE_SEED, DURABLE_WARM = 27, 1 << 16, 33, 4
DURABLE_MIG_ROWS, DURABLE_CHUNK, DURABLE_ZIPF = 1 << 22, 1 << 16, 1.1
#: the dense store's checkpoint: AdaGrad servers over ResNet-50's vector
DENSE_CKPT_LR = 0.01
#: the membership and elasticity plane at config #1 width: the heartbeat
#: timeout (safely above a step's host time, 3-4 threads sharing the GIL)
#: and interval, batches a workload, the worker-death run's workloads and the
#: workloads done before the kill, the 1-worker legs' workloads, when S0 dies
#: and S1 restarts, when scale_up starts (drain_down one workload later),
#: the migration chunk, the card-vs-CPU run's workloads, the data seed
ELASTIC_HB_TIMEOUT_S, ELASTIC_HB_INTERVAL_S, ELASTIC_BATCHES = 2.0, 0.2, 2
ELASTIC_WORKLOADS, ELASTIC_KILL_AFTER, ELASTIC_RUN_WORKLOADS = 12, 2, 6
ELASTIC_PROMOTE_AFTER, ELASTIC_RESTART_AFTER, ELASTIC_SCALE_AT = 2, 4, 3
ELASTIC_CHUNK, ELASTIC_REF_WORKLOADS, ELASTIC_SEED = 1 << 16, 4, 41
#: the worker-death run's request timeout: a request the victim had in
#: flight at the kill never gets its reply, and the run waits it out
ELASTIC_DEATH_TIMEOUT_S = 10.0
#: the wire's reliability layer at config #1 width: one worker's steps (the
#: first untimed), the chaos seed and rates, the resender's flat retransmit
#: deadline (above the clean run's pull round trips after its first step,
#: printed beside it) and budget, the codec's timing reps, the straggler
#: leg's slow delay and beats, the ``push_device`` leg's keys
WIRE_STEPS, WIRE_SEED, WIRE_DROP, WIRE_DUP, WIRE_CORRUPT = 8, 0, 0.05, 0.05, 0.05
WIRE_TIMEOUT_S, WIRE_RETRIES, WIRE_CODEC_REPS = 0.25, 60, 20
WIRE_SLOW_MS, WIRE_BEATS, WIRE_DEVICE_KEYS = 120.0, 5, 4096
#: the observability plane at config #1 width: the trace arms (name, 1-in-N
#: sampling; 0 = tracing off), the telemetry beat, the bound on the SLO
#: leg's breach and recovery polls, the war game's seed
OBSERVE_ARMS = (("off", 0), ("1/1024", 1024), ("1/1", 1))
OBSERVE_BEAT_S, OBSERVE_SLO_DEADLINE_S, OBSERVE_SCENARIO_SEED = 0.2, 15.0, 0
DEVICE = "cuda"
SOURCE = "parameter_server_tpu_torch/csrc/scatter_kernels.cu"
REPLACES = {
    "apply": "parameter_server_tpu/ops/scatter.py:385",
    "gather": "parameter_server_tpu/ops/scatter.py:157",
    "scatter_set": "parameter_server_tpu/ops/scatter.py:307",
    "scatter_add": "parameter_server_tpu/ops/scatter.py:202",
}


def emit(phase: str, **fields) -> None:
    print(json.dumps({"phase": phase, **fields}), flush=True)


def check(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(what)


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False
    from parameter_server_tpu_torch.core import flightrec
    from parameter_server_tpu_torch.ops import _build, scatter

    flightrec.configure(capacity=1 << 15, clear=True)  # no wrap in one run

    dev = torch.device(DEVICE)
    errs = {k: 0.0 for k in REPLACES}

    # -- 1. build --------------------------------------------------------------
    t0 = time.perf_counter()
    _build.load_library()
    emit("build", seconds=round(time.perf_counter() - t0, 3),
         nvcc_seconds=round(_build.build_seconds, 3),
         library=_build.library_path().name)

    # -- 2. kernels vs plain ---------------------------------------------------
    for dim in (1, 3, 4, 128, 1024):
        emit("kernels", dim=dim, **kernels_vs_plain(torch, scatter, dev, dim, errs))
    for dim in (1, 128):
        emit("kernels", dim=dim, storage_offset=1,
             **kernels_vs_plain(torch, scatter, dev, dim, errs, offset=1))
    emit("kernels", case="table_push_vs_cpu", **table_push_vs_cpu(torch, dev))

    # -- 3. main path ------------------------------------------------------------
    launches = {}
    scatter.reset_launch_counts()
    main = run_loop(torch, dev, fused=True, steps=MAIN_STEPS)
    counts = scatter.launch_counts()
    launches["apply"], launches["gather"] = counts["apply"], counts["gather"]
    check(counts["apply"] > 0 and counts["gather"] > 0, f"main path launches {counts}")
    check(counts["gather"] == main["pulls"],
          f"{counts['gather']} gather launches for {main['pulls']} pulls")
    first, last = np.mean(main["losses"][:2]), np.mean(main["losses"][-2:])
    check(last < first - 0.01, f"loss did not fall: {first} -> {last}")
    emit("main", steps_per_worker=MAIN_STEPS, workers=2, servers=2,
         examples_per_s=main["examples_per_s"], loss_first=float(first),
         loss_last=float(last), launches=counts, pulls=main["pulls"],
         trash_rows_at_fill=True, tables_on=main["devices"], ledger=main["ledger"])
    emit("main_reference", **small_reference(torch, dev))
    emit("main_determinism", **determinism(torch, dev))
    emit("main_profile", **profile_loop(torch, dev))

    # -- 4. three-pass push ------------------------------------------------------
    scatter.reset_launch_counts()
    tp = run_loop(torch, dev, fused=False, steps=THREE_PASS_STEPS)
    counts = scatter.launch_counts()
    launches["scatter_set"] = counts["scatter_set"]
    check(counts["scatter_set"] > 0 and counts["apply"] == 0, f"three-pass launches {counts}")
    check(counts["scatter_set"] == tp["pushes"],
          f"{counts['scatter_set']} scatter-set launches for {tp['pushes']} pushes")
    emit("three_pass", examples_per_s=tp["examples_per_s"], launches=counts,
         pushes=tp["pushes"])

    # -- 5. bundled apply ----------------------------------------------------------
    emit("bundled", **bundled_apply(torch, dev))

    # -- 6. combine_and_scatter_add ------------------------------------------------
    scatter.reset_launch_counts()
    comb = combine_phase(torch, scatter, dev, errs)
    counts = scatter.launch_counts()
    launches["scatter_add"] = counts["scatter_add"]
    check(counts["scatter_add"] > 0, f"combine launches {counts}")
    emit("combine", launches=counts, **comb)

    # -- 7. the server's default planes ----------------------------------------------
    emit("ledger", **ledger_phase(torch, dev, main["ledger"]))
    emit("coalesce", **coalesce_phase(torch, scatter, dev))
    emit("localizer", **localizer_phase())
    emit("flightrec", **flightrec_phase())

    # -- 7b. the synchronous push plane --------------------------------------------
    hier_batches, consist_streams = sync_plane_batches()
    hier = hier_phase(torch, scatter, dev, hier_batches)
    emit("hier", **hier)
    consist = consist_phase(torch, scatter, dev, consist_streams)
    emit("consist", **consist)
    del hier_batches, consist_streams

    # -- 8. the local (single-device) path ------------------------------------------
    pool = local_pool()
    scatter.reset_launch_counts()
    trainer, fields = local_phase(torch, dev, pool)
    counts = scatter.launch_counts()
    emit("local", launches=counts, **fields)
    state = trained_state(trainer)
    emit("local_reference", **local_reference(torch, dev, state, pool))
    emit("local_sync_free", **local_sync_free(torch, dev, trainer, pool))
    rows = local_rows(torch, scatter, dev, pool)
    emit("local_rows", **rows)
    emit("local_profile", **local_profile(torch, dev, trainer, pool))
    del trainer, state, pool
    torch.cuda.empty_cache()

    # -- 8b. BASELINE config #3: DLRM over a 2^28-row embedding table -----------
    dlrm, dlrm_launches, dtrainer = dlrm_phase(torch, scatter, dev)
    profiled = dlrm_profile(torch, dtrainer)
    dlrm["top_rows"] = dlrm_top_rows(torch, scatter, dtrainer, errs)
    dlrm["kernel_times"] = dlrm_kernel_times(torch, scatter, dtrainer, errs)
    del dtrainer
    torch.cuda.empty_cache()
    dlrm.update(dlrm_control(torch, dev, dlrm, profiled))
    emit("dlrm", **dlrm)
    emit("dlrm_profile", **profiled)
    emit("dlrm_reference", **dlrm_reference(torch, dev))
    torch.cuda.empty_cache()

    # -- 8c. BASELINE config #2: ResNet-50 on the dense plane ---------------------
    batches = resnet_batches()
    emit("dense_spmd", **dense_spmd(torch, dev, batches[0]))
    emit("dense_async", **dense_async(torch, dev, batches))
    emit("dense_ckpt", **dense_ckpt(torch, dev))
    del batches
    torch.cuda.empty_cache()

    # -- 8d. the serving plane and the replica chain over config #3's table ------
    serve, serve_launches = serve_phase(torch, scatter, dev, errs)
    emit("serve", **serve)
    replica, replica_launches = replica_phase(torch, scatter, dev, errs)
    emit("replica", **replica)

    # -- 8e. the durability plane over config #3's table at 2^27 rows ---------------
    durable, durable_launches = durable_phase(torch, scatter, dev, errs)
    emit("durable", **durable)

    # -- 8f. the membership and elasticity plane at config #1 width -----------------
    elastic, elastic_launches = elastic_phase(torch, scatter, dev, errs)
    emit("elastic", **{k: elastic[k] for k in ("launches", "phase_s", "gather_check",
                                                "scatter_set_check", "apply_check")})

    # -- 8g. the wire's reliability layer at config #1 width -------------------------
    wire, wire_launches = wire_phase(torch, scatter, dev, errs)
    emit("wire", **{k: wire[k] for k in ("launches", "phase_s", "gather_check",
                                          "apply_check")})

    # -- 8h. the production wire: sockets, filters and the launcher ------------------
    clean = wire.pop("clean_run")
    sockets, sockets_launches = sockets_phase(torch, scatter, dev, errs, clean)
    emit("sockets", **{k: sockets[k] for k in ("launches", "phase_s", "gather_check",
                                                "apply_check", "loopback", "launch",
                                                "launch_child_launches")})

    # -- 8i. the observability plane --------------------------------------------------
    observe, observe_launches = observe_phase(torch, scatter, dev, errs, clean)
    del clean
    emit("observe", **{k: observe[k] for k in ("launches", "phase_s", "gather_check",
                                                "apply_check", "wire_bytes_1_1024_vs_off")})

    # -- 9. times ----------------------------------------------------------------
    kernels = times_phase(torch, scatter, dev, errs, launches)
    for k in kernels:
        k["observe_launches"] = observe_launches[k["name"]]
        # scatter-set and scatter-add are not on the observability path
        k["observe"] = observe.get(f"{k['name']}_check")
        k["sockets_launches"] = sockets_launches[k["name"]]
        k["launch_child_launches"] = sockets["launch_child_launches"][k["name"]]
        # scatter-set and scatter-add are not on the sockets path either
        k["sockets"] = sockets.get(f"{k['name']}_check")
        k["wire_launches"] = wire_launches[k["name"]]
        # scatter-set and scatter-add are not on the wire path
        k["wire"] = wire.get(f"{k['name']}_check")
        k["serve_launches"] = serve_launches[k["name"]]
        k["replica_launches"] = replica_launches[k["name"]]
        k["durable_launches"] = durable_launches[k["name"]]
        k["elastic_launches"] = elastic_launches[k["name"]]
        # scatter-add is not on the elasticity path either
        k["elastic"] = elastic.get(f"{k['name']}_check")
        # scatter-add is not on the durability path
        k["durable"] = durable.get(f"{k['name']}_check")
        if k["name"] == "gather":
            k["serve"] = serve["gather_at_serving_shape"]
        if k["name"] == "apply":
            k["serve"] = serve["apply_check"]
            k["replica"] = {run: replica[run]["apply_check"]
                            for run in ("control", "sync_chain", "async_chain")}
        if k["name"] in ("apply", "gather"):
            k["local_rows_launches"] = rows["launches"][k["name"]]
            k["hier_launches"] = hier["launches"][k["name"]]
            k["consist_launches"] = consist["launches"][k["name"]]
        if k["name"] in ("gather", "scatter_set"):
            k["dlrm_launches"] = dlrm_launches[k["name"]]
            k["dlrm"] = dlrm["kernel_times"][k["name"]]
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()
    print(smi[0])
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count(),
    }}))
    return 0


# ---------------------------------------------------------------------------
# phase 2
# ---------------------------------------------------------------------------


def _ids_with_pads(rng, rows, n_real, n_pad):
    return np.concatenate(
        [rng.choice(rows, size=n_real, replace=False), np.full(n_pad, rows)]
    ).astype(np.int32)


def _on_card(torch, arr, dev, offset):
    """``arr`` on the card; with ``offset`` > 0 as a contiguous view that
    starts ``offset`` elements into its storage (not 16-byte aligned)."""
    t = torch.as_tensor(arr)
    flat = torch.empty(offset + t.numel(), dtype=t.dtype, device=dev)
    view = flat[offset:].view(t.shape)
    view.copy_(t)
    return view


def kernels_vs_plain(torch, scatter, dev, dim, errs, offset=0):
    """Each kernel against its plain version at ``dim`` on 1,001 real ids and
    22 trash pads (an id count that is not a multiple of 4, so the kernels'
    masked tails run).  Gather and scatter-set take 1 to 4 planes in one
    launch; apply runs all four optimizers and must leave the trash row
    untouched; ``scatter_add_rows`` takes 1,023 ids drawn with repeats from
    300 rows.  ``offset`` > 0 runs every tensor as a misaligned view, which
    the wrappers send to the scalar form of each kernel."""
    from parameter_server_tpu_torch.config import OptimizerConfig
    from parameter_server_tpu_torch.kv.optim import make_optimizer

    rng = np.random.default_rng(dim + 1000 * offset)
    rows, n_real, n_pad = 4096, 1001, 22
    planes_np = rng.normal(size=(4, rows + 1, dim)).astype(np.float32)
    planes_np[:, rows] = 0
    planes = [_on_card(torch, p, dev, offset) for p in planes_np]
    table = planes[0]
    ids = _on_card(torch, _ids_with_pads(rng, rows, n_real, n_pad), dev, offset)
    # one row set per plane; pad rows are identical (zero), as the contract asks
    vals_np = rng.normal(size=(4, n_real + n_pad, dim)).astype(np.float32)
    vals_np[:, n_real:] = 0
    vals_planes = [_on_card(torch, v, dev, offset) for v in vals_np]
    vals = vals_planes[0]
    if offset:
        check(not scatter._aligned(table, ids, vals), "misaligned views are aligned")
    out = {}

    def record(name, got, want, rtol, atol):
        err = float((got - want).abs().max())
        ok = torch.allclose(got, want, rtol=rtol, atol=atol)
        check(bool(ok), f"{name} dim {dim} offset {offset}: kernel vs plain max err {err}")
        key = next((k for k in errs if name.startswith(k)), None)
        if key:  # a kernel against its plain version
            errs[key] = max(errs[key], err)
        err = max(err, out.get(name, {}).get("max_abs_err", 0.0))
        out[name] = {"max_abs_err": err, "rtol": rtol, "atol": atol}

    # row moves copy bytes: exact
    for p in range(1, 5):
        got = scatter.cuda_gather_planes(planes[:p], ids)
        want = [scatter.gather_rows_torch(t, ids) for t in planes[:p]]
        record("gather", torch.cat(got), torch.cat(want), 0.0, 0.0)
        got = scatter.cuda_scatter_set_planes([t.clone() for t in planes[:p]], ids,
                                              vals_planes[:p])
        want = [scatter.scatter_update_rows_torch(t.clone(), ids, v)
                for t, v in zip(planes[:p], vals_planes[:p])]
        record("scatter_set", torch.cat(got), torch.cat(want), 0.0, 0.0)
    # one float add per element either way: exact
    record("scatter_add", scatter.cuda_scatter_add(table.clone(), ids, vals),
           scatter.scatter_add_rows_torch(table.clone(), ids, vals), 0.0, 0.0)
    # repeated ids through the public dispatcher: merged, then one kernel
    # launch.  Exact against the plain add of the same merged rows; against
    # index_put_(accumulate=True), which adds the repeats to the table one by
    # one, the sums associate differently: rtol = atol = 1e-5.
    rep_ids = _on_card(torch, rng.integers(0, 300, size=n_real + n_pad).astype(np.int32),
                       dev, offset)
    got = scatter.scatter_add_rows(table.clone(), rep_ids, vals)
    merged_ids, merged = scatter._merge_repeats(rep_ids, vals)
    record("scatter_add_repeats_merged", got,
           scatter.scatter_add_rows_torch(table.clone(), merged_ids, merged), 0.0, 0.0)
    record("repeats_vs_index_put", got,
           scatter.scatter_add_rows_torch(table.clone(), rep_ids, vals), 1e-5, 1e-5)
    opts = {
        "sgd": dict(kind="sgd", learning_rate=0.1, l2=0.01),
        "adagrad": dict(kind="adagrad", learning_rate=0.05, l1=0.001, l2=0.01),
        "adam": dict(kind="adam", learning_rate=0.01, l2=0.01),
        "ftrl": dict(kind="ftrl", l1=0.5, l2=0.1),
    }
    for kind, cfg in opts.items():
        opt = make_optimizer(OptimizerConfig(**cfg))
        state_np = {k: np.abs(rng.normal(size=(rows + 1, dim))).astype(np.float32)
                    for k in opt.state_shapes()}
        if "t" in state_np:
            state_np["t"] = np.floor(state_np["t"] * 3)
        before = [planes_np[0]] + [state_np[k] for k in sorted(state_np)]
        kv, ks = scatter.cuda_apply(
            _on_card(torch, planes_np[0], dev, offset),
            {k: _on_card(torch, x, dev, offset) for k, x in state_np.items()},
            ids, vals, opt)
        pv, ps = scatter.apply_rows_torch(
            torch.tensor(planes_np[0], device=dev),
            {k: torch.tensor(x, device=dev) for k, x in state_np.items()},
            ids, vals, opt)
        got = [kv] + [ks[k] for k in sorted(ks)]
        # multi-op float math in the same order (-fmad=false); pow and
        # division by a scalar may round differently by an ulp: 1e-5
        # relative.  Every row, the trash row included: both sides must
        # leave it as it was.
        record(f"apply_{kind}", torch.cat(got),
               torch.cat([pv] + [ps[k] for k in sorted(ps)]), 1e-5, 1e-6)
        for g, b in zip(got, before):
            check(bool(torch.equal(g[rows].cpu(), torch.from_numpy(b[rows]))),
                  f"apply_{kind} dim {dim}: the kernel wrote the trash row")
    torch.cuda.synchronize()
    return out


def table_push_vs_cpu(torch, dev):
    """``KVTable.push`` at the main path's full width (a 2^21 + 1 row shard,
    dim 1, server 0's request: 32,768 ids of which 12,851 trash pads), three
    pushes per optimizer, on the card and on the CPU: every row of every
    plane, the trash row included, within rtol 1e-5 / atol 1e-6, and on the
    card the trash row of every plane still exactly at its fill (the fused
    push never resets it: neither the kernel nor the plain version writes
    it)."""
    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
    from parameter_server_tpu_torch.kv.table import KVTable

    shard, n, n_real = ROWS // 2, 32768, 19917
    out = {}
    for kind in ("sgd", "adagrad", "adam", "ftrl"):
        cfg = TableConfig(name="w", rows=shard, dim=DIM,
                          optimizer=OptimizerConfig(kind=kind, learning_rate=0.05, l1=0.01))
        tables = [KVTable(cfg, device=dev), KVTable(cfg, device="cpu")]
        rng = np.random.default_rng(17)
        for _ in range(3):
            ids = np.full(n, shard, dtype=np.int32)
            ids[:n_real] = np.sort(rng.choice(shard, size=n_real, replace=False))
            grads = np.zeros((n, DIM), np.float32)
            grads[:n_real] = rng.normal(size=(n_real, DIM))
            for t in tables:
                t.push(torch.tensor(ids, device=t.device), torch.tensor(grads, device=t.device))
        card, cpu = tables
        err = 0.0
        fills = card.optimizer.state_shapes()
        for name in ["value", *sorted(card.state)]:
            a = (card.value if name == "value" else card.state[name]).cpu()
            b = cpu.value if name == "value" else cpu.state[name]
            err = max(err, float((a - b).abs().max()))
            check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-6)),
                  f"{kind} KVTable.push card vs cpu, plane {name}: max err {err}")
            fill = 0.0 if name == "value" else fills[name]
            check(bool((a[shard] == fill).all()), f"{kind}: trash row of {name} left its fill")
        out[kind] = {"max_abs_err": err, "rtol": 1e-5, "atol": 1e-6, "trash_rows_at_fill": True}
    return out


# ---------------------------------------------------------------------------
# phase 3 / 4: the PS loop
# ---------------------------------------------------------------------------


def build_cluster(torch, device, *, rows, fused, n_workers, min_bucket=256,
                  devobs=None, coalesce=False, tables=None):
    """2 servers and ``n_workers`` workers of config #1 on a LoopbackVan (or,
    with ``coalesce``, a CoalescingVan over one); ``devobs`` is the servers'
    ledger config (None: the default, enabled ledger); ``tables`` replaces
    the table configs."""
    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
    from parameter_server_tpu_torch.core.coalesce import CoalescingVan
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker

    cfgs = tables or {"w": TableConfig(
        name="w", rows=rows, dim=DIM,
        optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.05),
        fused_apply=fused,
    )}
    van = CoalescingVan(LoopbackVan()) if coalesce else LoopbackVan()
    servers = [KVServer(Postoffice(f"S{i}", van), cfgs, i, 2, device=device, devobs=devobs)
               for i in range(2)]
    workers = [KVWorker(Postoffice(f"W{i}", van), cfgs, 2, min_bucket=min_bucket,
                        device=device)
               for i in range(n_workers)]
    return van, servers, workers


def close_cluster(van, servers):
    van.close()
    for srv in servers:
        if srv.ledger is not None:
            srv.ledger.close()


def ledger_stats(servers, per_push=True):
    """Drain every server's apply ledger and hold it to its pushes: applies
    submitted == retired (== pushes where every push is its own apply,
    ``per_push``), none censored, one ``apply.w`` digest sample an entry;
    the four digests merged over the servers, as p50 / p99 in ms (bucket
    upper bounds, 25% wide)."""
    from parameter_server_tpu_torch.utils.trace import LatencyHistogram

    totals = dict.fromkeys(("pushes", "applies_submitted", "applies_retired",
                            "applies_censored"), 0)
    merged = {name: LatencyHistogram() for name in ("apply", "apply_host", "apply_h2d",
                                                    "apply_dev")}
    for srv in servers:
        check(srv.ledger.drain(60.0), f"{srv.post.node_id}: the ledger did not drain")
        c = srv.ledger.counters()
        entries = srv.pushes if per_push else c["applies_submitted"]
        check(c["applies_submitted"] == c["applies_retired"] == entries,
              f"{srv.post.node_id}: ledger {c} for {srv.pushes} pushes")
        check(c["applies_censored"] == 0, f"{srv.post.node_id}: censored applies {c}")
        digests = srv.latency_digests()
        check(digests["apply.w"]["count"] == entries,
              f"{srv.post.node_id}: apply.w digest {digests['apply.w']['count']} samples "
              f"for {entries} entries")
        totals["pushes"] += srv.pushes
        for k in ("applies_submitted", "applies_retired", "applies_censored"):
            totals[k] += c[k]
        for name, hist in merged.items():
            hist.merge_dict(digests[f"{name}.w"])
    totals["ms"] = {name: {"p50": 1e3 * h.percentile(0.5), "p99": 1e3 * h.percentile(0.99),
                           "count": h.count}
                    for name, h in merged.items()}
    return totals


def run_loop(torch, dev, *, fused, steps, devobs=None, coalesce=False):
    from parameter_server_tpu_torch.config import ConsistencyConfig
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
    from parameter_server_tpu_torch.learner.sgd import AsyncLRLearner

    van, servers, workers = build_cluster(torch, dev, rows=ROWS, fused=fused, n_workers=2,
                                          devobs=devobs, coalesce=coalesce)
    try:
        data = [SyntheticCTR(key_space=KEY_SPACE, nnz=NNZ, batch_size=BATCH, seed=i,
                             informative=0.1) for i in range(2)]
        learner = AsyncLRLearner(workers, ConsistencyConfig(), device=dev)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = learner.run([d.next_batch for d in data], steps, timeout=300)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        devices = sorted({str(t.device) for s in servers for tbl in s.tables.values()
                          for t in [tbl.value, *tbl.state.values()]})
        check(devices == [str(torch.empty(0, device=dev).device)], f"tables on {devices}")
        keys, _ = data[0].next_batch()
        w = workers[0].pull_sync("w", keys, timeout=300)
        check(w.shape == keys.shape and bool(np.isfinite(w).all()), "pulled weights")
        check(float(np.abs(w).max()) > 0, "pulled weights are all zero")
        for tbl in (t for srv in servers for t in srv.tables.values()):
            fills = {"value": 0.0, **tbl.optimizer.state_shapes()}
            for name, plane in [("value", tbl.value), *tbl.state.items()]:
                check(bool((plane[-1] == fills[name]).all()),
                      f"trash row of {name} left its fill {fills[name]}")
        out = {"losses": losses, "examples_per_s": 2 * steps * BATCH / wall,
               "devices": devices, "pulls": sum(srv.pulls for srv in servers),
               "pushes": sum(srv.pushes for srv in servers)}
        if servers[0].ledger is not None:
            out["ledger"] = ledger_stats(servers)
        if coalesce:
            out["van"] = van.counters()
        return out
    finally:
        close_cluster(van, servers)


def _device_profile(torch, fn, top_n):
    """``torch.profiler`` over ``fn()``: wall, device busy, idle share, the
    segment sum's share of busy and the top ``top_n`` device ops."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall_ms = (time.perf_counter() - t0) * 1e3
    on_device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    seg_ms = sum(e.self_device_time_total for e in on_device
                 if "segment_reduce" in e.key) / 1e3
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:top_n]
    measured = bool(on_device) and busy_ms > 0
    return {
        "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if measured else "not measured",
        "device_idle_share": 1 - busy_ms / wall_ms if measured else "not measured",
        "segment_sum_share": seg_ms / busy_ms if measured else "not measured",
        "top_device_ms": [[e.key[:70], e.self_device_time_total / 1e3, e.count] for e in top],
    }


def profile_loop(torch, dev, steps=2):
    """Device busy time and idle share over ``steps`` BSP steps of the main
    path under ``torch.profiler`` (a fresh cluster, after one warm step)."""
    from parameter_server_tpu_torch.config import ConsistencyConfig
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
    from parameter_server_tpu_torch.learner.sgd import AsyncLRLearner

    van, servers, workers = build_cluster(torch, dev, rows=ROWS, fused=True, n_workers=2)
    try:
        data = [SyntheticCTR(key_space=KEY_SPACE, nnz=NNZ, batch_size=BATCH, seed=20 + i,
                             informative=0.1) for i in range(2)]
        AsyncLRLearner(workers, ConsistencyConfig(), device=dev).run(
            [d.next_batch for d in data], 1, timeout=300)
        learner = AsyncLRLearner(workers, ConsistencyConfig(), device=dev)
        out = _device_profile(torch, lambda: learner.run([d.next_batch for d in data], steps,
                                                         timeout=300), top_n=6)
    finally:
        close_cluster(van, servers)
    return {"steps": steps, **out}


def small_reference(torch, dev):
    """The same loop at a small size on the card (kernels) and on the CPU
    (plain versions): losses within 1e-4, tables within 1e-5."""
    from parameter_server_tpu_torch.config import ConsistencyConfig
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
    from parameter_server_tpu_torch.learner.sgd import AsyncLRLearner

    out = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        van, servers, workers = build_cluster(torch, device, rows=1 << 14, fused=True,
                                              n_workers=1)
        try:
            data = SyntheticCTR(key_space=1 << 18, nnz=NNZ, batch_size=512, seed=5,
                                informative=0.1)
            losses = AsyncLRLearner(workers, ConsistencyConfig(), device=device).run(
                [data.next_batch], 6, timeout=300)
            out[side] = (losses, [s.export_shard()["w"] for s in servers])
        finally:
            close_cluster(van, servers)
    lc, lg = np.asarray(out["cpu"][0]), np.asarray(out["card"][0])
    check(np.allclose(lg, lc, rtol=1e-4, atol=1e-4), f"losses {lg} vs cpu {lc}")
    err = 0.0
    for sg, sc in zip(out["card"][1], out["cpu"][1]):
        for a, b in [(sg["value"], sc["value"]), (sg["state"]["sum_sq"], sc["state"]["sum_sq"])]:
            check(np.allclose(a, b, rtol=1e-5, atol=1e-5), "small-run tables vs cpu")
            err = max(err, float(np.abs(a - b).max()))
    return {"loss_max_abs_err": float(np.abs(lg - lc).max()), "table_max_abs_err": err,
            "loss_tol": 1e-4, "table_tol": 1e-5}


def determinism(torch, dev):
    """A seeded push sequence at full width, twice: bitwise-equal tables."""
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR

    shards = []
    for _ in range(2):
        van, servers, (worker,) = build_cluster(torch, dev, rows=ROWS, fused=True,
                                                n_workers=1)
        try:
            data = SyntheticCTR(key_space=KEY_SPACE, nnz=NNZ, batch_size=BATCH, seed=11,
                                informative=0.1)
            rng = np.random.default_rng(12)
            for _ in range(3):
                keys, _labels = data.next_batch()
                grads = rng.normal(size=keys.shape).astype(np.float32)
                check(worker.wait(worker.push("w", keys, grads), timeout=300), "push ack")
            shards.append([s.export_shard()["w"] for s in servers])
        finally:
            close_cluster(van, servers)
    for a, b in zip(*shards):
        check(np.array_equal(a["value"], b["value"]), "value differs between runs")
        check(np.array_equal(a["state"]["sum_sq"], b["state"]["sum_sq"]),
              "state differs between runs")
    return {"pushes": 3, "bitwise_equal": True,
            "nonzero_rows": int(sum((s["value"] != 0).sum() for s in shards[0]))}


# ---------------------------------------------------------------------------
# phase 5
# ---------------------------------------------------------------------------


def bundled_apply(torch, dev):
    from parameter_server_tpu_torch.config import (
        ApplyEngineConfig, OptimizerConfig, TableConfig)
    from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.server import KVServer

    k, batch, pool, dim, rows = 16, 2048, 2048, 128, 1 << 15

    def msgs():
        rng = np.random.default_rng(0)
        out = []
        for _ in range(k):
            ids = np.sort(rng.choice(pool, size=batch, replace=False)).astype(np.int32)
            out.append(Message(
                task=Task(TaskKind.PUSH, "kv", payload={"table": "w"}),
                sender="W0", recver="S0", keys=ids,
                values=[rng.standard_normal((batch, dim)).astype(np.float32)],
            ))
        return out

    result = {}
    for policy in ("rounds", "combine"):
        shards, ms = [], []
        for device in (dev, dev, torch.device("cpu")):
            van = LoopbackVan()
            try:
                srv = KVServer(
                    Postoffice("S0", van),
                    {"w": TableConfig(name="w", rows=rows, dim=dim,
                                      optimizer=OptimizerConfig(kind="adam",
                                                                learning_rate=0.05))},
                    0, 1, apply=ApplyEngineConfig(apply_batch=k, dup_policy=policy),
                    device=device,
                )
                bundle = msgs()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                replies = srv.handle_request_batch(bundle)
                torch.cuda.synchronize()
                ms.append((time.perf_counter() - t0) * 1e3)
                check(all("__error__" not in r.task.payload for r in replies), "bundle error")
                shards.append(srv.export_shard()["w"])
            finally:
                van.close()
                srv.ledger.close()
        planes = ["value"] + sorted(shards[0]["state"])

        def plane(s, p):
            return s["value"] if p == "value" else s["state"][p]

        for p in planes:
            check(np.array_equal(plane(shards[0], p), plane(shards[1], p)),
                  f"{policy}: {p} differs between two runs on the card")
        err = max(float(np.abs(plane(shards[0], p) - plane(shards[2], p)).max())
                  for p in planes)
        # up to 16 sequential Adam steps per row: 1e-4 relative
        for p in planes:
            check(np.allclose(plane(shards[0], p), plane(shards[2], p), rtol=1e-4, atol=1e-5),
                  f"{policy}: {p} vs cpu (max err {err})")
        result[policy] = {"bitwise_equal_runs": True, "max_abs_err_vs_cpu": err,
                          "rtol": 1e-4, "atol": 1e-5, "card_ms": ms[:2]}
    return result


# ---------------------------------------------------------------------------
# phase 6
# ---------------------------------------------------------------------------


def _main_batch_slots():
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
    from parameter_server_tpu_torch.utils.keys import HashLocalizer, localize_to_slots

    keys, _ = SyntheticCTR(key_space=KEY_SPACE, nnz=NNZ, batch_size=BATCH, seed=0,
                           informative=0.1).next_batch()
    slots, inverse, n = localize_to_slots(keys, HashLocalizer(ROWS), min_bucket=256)
    return keys, slots, inverse, n


def combine_phase(torch, scatter, dev, errs):
    keys, slots, inverse, n = _main_batch_slots()
    rng = np.random.default_rng(7)
    values = torch.tensor(rng.normal(size=(keys.size, DIM)), dtype=torch.float32, device=dev)
    table = torch.zeros((ROWS + 1, DIM), dtype=torch.float32, device=dev)
    ids = torch.tensor(slots, device=dev)
    inv = torch.tensor(inverse, device=dev)
    got = scatter.combine_and_scatter_add(table, ids, inv, values, int(slots.size),
                                          unique_ids=True)
    want = scatter.scatter_add_rows_torch(
        torch.zeros_like(table), ids, scatter.segment_combine(values, inv, int(slots.size)))
    err = float((got - want).abs().max())
    check(err == 0.0, f"combine_and_scatter_add vs plain: {err}")
    errs["scatter_add"] = max(errs["scatter_add"], err)
    check(float(got[ROWS].abs().max()) == 0.0, "trash row received nonzero sums")
    return {"positions": int(keys.size), "unique_slots": int(n), "max_abs_err": err}


# ---------------------------------------------------------------------------
# phase 7: the server's default planes (ledger, coalescing, localizer, flight recorder)
# ---------------------------------------------------------------------------


def _ms_quantiles(samples):
    return {"median": float(np.median(samples)), "min": float(np.min(samples)),
            "max": float(np.max(samples)), "n": len(samples)}


def _server0_request(seed=0):
    """Server 0's slice of one main-path batch as a wire PUSH: global ids
    (pads == ROWS) and one gradient row each, pads zero."""
    from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind
    from parameter_server_tpu_torch.kv.routing import RoutingTable

    _keys, slots, _inverse, _n = _main_batch_slots()
    _, _pos, ids0 = next(RoutingTable.uniform({"w": ROWS}, 2).slice_ids("w", slots))
    vals = np.random.default_rng(seed).normal(size=(ids0.size, DIM)).astype(np.float32)
    vals[ids0 >= ROWS] = 0

    def msg(epoch=0):
        return Message(task=Task(TaskKind.PUSH, "kv",
                                 payload={"table": "w", "__repoch__": epoch}),
                       sender="W0", recver="S0", keys=ids0.astype(np.int32), values=[vals])
    return msg


def ack_sync_free(torch, dev):
    """The push ack path at server 0's main-path request under
    ``torch.cuda.set_sync_debug_mode("error")``: one single push and one
    bundled apply of two members, ledger registration included; then a
    push with a stale routing epoch, which must be fenced (``fence.routing``).
    Also whether a CUDA event's ``query()`` / ``synchronize()`` (the reaper's
    calls) trip the mode."""
    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.server import KVServer

    cfgs = {"w": TableConfig(name="w", rows=ROWS, dim=DIM,
                             optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.05))}
    van = LoopbackVan()
    srv = KVServer(Postoffice("S0", van), cfgs, 0, 2, device=dev)
    msg = _server0_request()
    try:
        srv.handle_request(msg())  # warm: pinned pool, reaper thread
        torch.cuda.synchronize()
        check(srv.ledger.drain(30.0), "ack path warm-up did not retire")
        torch.cuda.set_sync_debug_mode("error")
        try:
            single = srv.handle_request(msg())
            batch = srv.handle_request_batch([msg(), msg()])
        finally:
            torch.cuda.set_sync_debug_mode(0)
        check("__error__" not in single.task.payload, "sync-free single push failed")
        check(all("__error__" not in r.task.payload for r in batch), "sync-free bundle failed")
        event_trips = {}
        for call in ("query", "synchronize"):
            event = torch.cuda.Event(blocking=True)
            event.record()
            torch.cuda.set_sync_debug_mode("error")
            try:
                getattr(event, call)()
                event_trips[call] = False
            except RuntimeError:
                event_trips[call] = True
            finally:
                torch.cuda.set_sync_debug_mode(0)
        fenced = srv.handle_request(msg(epoch=5))
        check(fenced.task.payload.get("__fenced__") is True, "stale-epoch push not fenced")
        # warm-up, single push, one bundle: three applies for four pushes
        stats = ledger_stats([srv], per_push=False)
        check(stats["applies_submitted"] == 3 and stats["pushes"] == 4,
              f"ack path ledger entries {stats}")
    finally:
        van.close()
        srv.ledger.close()
    return {"ids": int(msg().keys.size), "sync_debug_mode": "error", "raised": False,
            "single_push": True, "bundle_members": 2,
            "ledger_entries_after_warmup": stats["applies_submitted"] - 1,
            "event_trips_debug_mode": event_trips, "fenced": True}


def event_wait(torch, dev, cycles=200_000_000):
    """A blocking and a spinning ``torch.cuda.Event`` waited on from a second
    thread behind a ~0.1 s ``torch.cuda._sleep``: the waiter's wall and CPU
    time, and how far the main thread's Python loop got meanwhile (it runs
    only while the waiter has released the GIL)."""
    import threading

    out = {}
    for name, blocking in (("sleeping_thread", None), ("blocking", True), ("spinning", False),
                           ("blocking_2", True)):
        torch.cuda.synchronize()
        event = torch.cuda.Event(blocking=bool(blocking))
        torch.cuda._sleep(cycles)
        event.record()
        res = {}

        def waiter():
            c0, t0 = time.thread_time(), time.perf_counter()
            if blocking is None:  # the reference: a thread that sleeps
                time.sleep(0.1)
            else:
                event.synchronize()
            res["wall_ms"] = (time.perf_counter() - t0) * 1e3
            res["cpu_ms"] = (time.thread_time() - c0) * 1e3

        th = threading.Thread(target=waiter)
        th.start()
        iters, t0 = 0, time.perf_counter()
        while th.is_alive():
            iters += 1
        main_ms = (time.perf_counter() - t0) * 1e3
        th.join()
        res["main_thread_iters_per_ms"] = iters / main_ms
        res["waiter_cpu_share"] = res["cpu_ms"] / res["wall_ms"]
        out[name] = res
    torch.cuda.synchronize()
    base = out["sleeping_thread"]["main_thread_iters_per_ms"]
    for name in ("blocking", "blocking_2"):
        check(out[name]["main_thread_iters_per_ms"] > 0.5 * base,
              f"{name} event wait held the GIL: {out}")
    return out


def backlog_leg(torch, dev, hold_cycles=400_000_000):
    """``LedgerConfig(backlog_bundles=1)`` at the apply-engine shape: 16
    single pushes of 2048 ids (2048-row pool, dim 128, Adam, 2^15 rows) sent
    back to back by one worker, their pre-combine done beforehand.  First as
    they come; then with the card held behind a ~0.2 s ``torch.cuda._sleep``
    queued first, so the applies wait on the stream: the acks must carry
    ``__busy__`` (``server_busy``), and ``apply.backlog`` enter then clear
    must land in the flight recorder."""
    from parameter_server_tpu_torch.config import LedgerConfig, OptimizerConfig, TableConfig
    from parameter_server_tpu_torch.core import flightrec
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker
    from parameter_server_tpu_torch.utils.keys import IdentityLocalizer

    k, batch, pool, dim, rows = 16, 2048, 2048, 128, 1 << 15
    cfgs = {"w": TableConfig(name="w", rows=rows, dim=dim,
                             optimizer=OptimizerConfig(kind="adam", learning_rate=0.05))}
    van = LoopbackVan()
    srv = KVServer(Postoffice("S0", van), cfgs, 0, 1, device=dev,
                   devobs=LedgerConfig(backlog_bundles=1))
    worker = KVWorker(Postoffice("W0", van), cfgs, 1, device=dev,
                      localizers={"w": IdentityLocalizer(rows)})
    rng = np.random.default_rng(1)
    prepared = [worker._prepare_push("w", rng.choice(pool, size=batch, replace=False)
                                     .astype(np.uint64),
                                     rng.standard_normal((batch, dim)).astype(np.float32))
                for _ in range(k)]
    out = {}
    try:
        for leg in ("as_sent", "card_held"):
            torch.cuda.synchronize()
            check(srv.ledger.drain(30.0), "backlog leg: ledger did not drain")
            hints0 = worker.busy_hints
            seq0 = flightrec.get().events()[-1]["seq"] if len(flightrec.get()) else -1
            if leg == "card_held":
                torch.cuda._sleep(hold_cycles)
            t0 = time.perf_counter()
            ts = [worker._submit_push("w", slots, comb)[0] for slots, comb in prepared]
            check(all(worker.wait(t, timeout=120) for t in ts), "backlog leg: acks")
            acks_ms = (time.perf_counter() - t0) * 1e3
            busy_now = worker.server_busy("S0")
            inflight = srv.ledger.counters()["inflight_bundles"]
            torch.cuda.synchronize()
            check(srv.ledger.drain(30.0), "backlog leg: ledger did not drain")
            edges = [e["state"] for e in flightrec.get().events_since(seq0)
                     if e["kind"] == "apply.backlog" and e.get("node") == "S0"]
            out[leg] = {"pushes": k, "acks_ms": acks_ms, "busy_hints": worker.busy_hints - hints0,
                        "server_busy": busy_now, "inflight_after_acks": inflight,
                        "backlog_events": edges, "overloaded_after_drain": srv.ledger.overloaded()}
        held = out["card_held"]
        check(held["server_busy"] and held["busy_hints"] > 0,
              f"backlog leg: the worker never saw __busy__ ({held})")
        check(held["backlog_events"][:1] == ["enter"] and held["backlog_events"][-1:] == ["clear"],
              f"backlog leg: apply.backlog events {held['backlog_events']}")
        check(not held["overloaded_after_drain"], "backlog leg: still overloaded after drain")
        c = srv.ledger.counters()
        check(c["applies_submitted"] == c["applies_retired"] == 2 * k
              and c["applies_censored"] == 0, f"backlog leg ledger {c}")
    finally:
        van.close()
        srv.ledger.close()
    out["hold_cycles"] = hold_cycles
    return out


def ledger_phase(torch, dev, main_ledger):
    """The main run's ledger, then the PS loop with the ledger on and off in
    ``LEDGER_PAIRS`` pairs, alternating which runs first (medians,
    quartiles, pairs the ledger-on run won), the ack path under sync debug
    mode, the event wait, and the backlog leg."""
    from parameter_server_tpu_torch.config import LedgerConfig

    rates = {"on": [], "off": []}
    for pair in range(LEDGER_PAIRS):
        for which in (("on", "off"), ("off", "on"))[pair % 2]:
            r = run_loop(torch, dev, fused=True, steps=LEDGER_STEPS,
                         devobs=None if which == "on" else LedgerConfig(enabled=False))
            check(("ledger" in r) == (which == "on"), f"ledger {which}: {sorted(r)}")
            rates[which].append(r["examples_per_s"])
    med = {k: float(np.median(v)) for k, v in rates.items()}
    return {
        "main": main_ledger, "steps_per_worker": LEDGER_STEPS, "pairs": LEDGER_PAIRS,
        "examples_per_s": rates, "examples_per_s_median": med,
        "examples_per_s_quartiles": {k: [float(q) for q in np.percentile(v, [25, 75])]
                                     for k, v in rates.items()},
        "pairs_on_faster": int(sum(a > b for a, b in zip(rates["on"], rates["off"]))),
        "on_vs_off": med["on"] / med["off"] - 1.0,
        "ack_sync_free": ack_sync_free(torch, dev),
        "event_wait": event_wait(torch, dev),
        "backlog": backlog_leg(torch, dev),
    }


def ordered_loop(torch, dev, *, coalesce, steps=ORDERED_STEPS):
    """The config #1 loop driven in a fixed order, at full width: each step,
    W0 then W1 pushes its gradient and pulls the next batch's weights in one
    ``coalesce_window`` (on the coalescing stack, one bundle per server of a
    PUSH and a PULL through the apply engine).  The same operations reach
    the servers in the same order on either stack."""
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
    from parameter_server_tpu_torch.models import linear

    van, servers, workers = build_cluster(torch, dev, rows=ROWS, fused=True, n_workers=2,
                                          coalesce=coalesce)
    try:
        data = [SyntheticCTR(key_space=KEY_SPACE, nnz=NNZ, batch_size=BATCH, seed=30 + i,
                             informative=0.1) for i in range(2)]
        batches = [d.next_batch() for d in data]
        weights = [w.pull_sync("w", b[0], timeout=300) for w, b in zip(workers, batches)]
        for _ in range(steps):
            for i, (w, d) in enumerate(zip(workers, data)):
                keys, labels = batches[i]
                g, _gb, _loss = linear.grad_rows(torch.tensor(weights[i], device=dev),
                                                 torch.tensor(labels, device=dev))
                batches[i] = d.next_batch()
                with w.coalesce_window():
                    push_ts = w.push("w", keys, g.cpu().numpy() / labels.shape[0])
                    pull_ts = w.pull("w", batches[i][0])
                check(w.wait(push_ts, timeout=300), "ordered loop push ack")
                weights[i] = w.pull_result(pull_ts, timeout=300)
        torch.cuda.synchronize()
        out = {"tables": [s.export_shard()["w"] for s in servers],
               "pushes": sum(s.pushes for s in servers), "pulls": sum(s.pulls for s in servers),
               "ledger": ledger_stats(servers)}
        if coalesce:
            out["van"] = van.counters()
        return out
    finally:
        close_cluster(van, servers)


def apply_engine_leg(torch, scatter, dev, policy, reps=7):
    """bench.py's apply-engine shape (``bench.py:1778-1789``): 16 pushes of
    2048 ids from a 2048-row pool, dim 128, Adam, 2^15 rows.  One worker
    sends them in one ``coalesce_window``: one bundle, one
    ``handle_request_batch`` call, one ledger entry.  Then bench.py's timing
    (``bench.py:1842-1864``) on the bundle the server received, replayed on
    fresh servers: ms per bundle through ``handle_request_batch`` and the
    same 16 pushes one ``handle_request`` each, device completion included
    (``torch.cuda.synchronize`` outside the server), interleaved, medians."""
    from parameter_server_tpu_torch.config import ApplyEngineConfig, OptimizerConfig, TableConfig
    from parameter_server_tpu_torch.core.coalesce import CoalescingVan
    from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker
    from parameter_server_tpu_torch.utils.keys import IdentityLocalizer

    k, batch, pool, dim, rows = 16, 2048, 2048, 128, 1 << 15
    cfgs = {"w": TableConfig(name="w", rows=rows, dim=dim,
                             optimizer=OptimizerConfig(kind="adam", learning_rate=0.05))}
    engine = ApplyEngineConfig(apply_batch=k, dup_policy=policy)
    rng = np.random.default_rng(0)
    pushes = [(np.sort(rng.choice(pool, size=batch, replace=False)).astype(np.uint64),
               rng.standard_normal((batch, dim)).astype(np.float32)) for _ in range(k)]

    def server(van):
        return KVServer(Postoffice("S0", van), cfgs, 0, 1, apply=engine, device=dev)

    van = CoalescingVan(LoopbackVan())
    srv = server(van)
    bundles = []
    real_batch = srv.handle_request_batch

    def spy(msgs):
        bundles.append(list(msgs))
        return real_batch(msgs)

    srv.handle_request_batch = spy
    try:
        worker = KVWorker(Postoffice("W0", van), cfgs, 1, device=dev,
                          localizers={"w": IdentityLocalizer(rows)})
        torch.cuda.synchronize()
        scatter.reset_launch_counts()
        with worker.coalesce_window():
            ts = [worker.push("w", keys, g) for keys, g in pushes]
        check(all(worker.wait(t, timeout=120) for t in ts), f"{policy}: bundle acks")
        torch.cuda.synchronize()
        launches = scatter.launch_counts()
        check(srv.ledger.drain(30.0), f"{policy}: ledger did not drain")
        ledger = srv.ledger.counters()
        coalesce = van.counters()
        window_table = srv.export_shard()["w"]
    finally:
        van.close()
        srv.ledger.close()
    check(len(bundles) == 1 and len(bundles[0]) == k,
          f"{policy}: {[len(b) for b in bundles]} handle_request_batch calls for {k} pushes")
    check(ledger["applies_submitted"] == ledger["applies_retired"] == 1
          and ledger["applies_censored"] == 0, f"{policy}: ledger {ledger}")
    msgs = bundles[0]
    ids_all = np.concatenate([m.keys for m in msgs]).astype(np.int64)
    want_launches = int(np.bincount(ids_all).max()) if policy == "rounds" else 1
    check(launches["apply"] == want_launches,
          f"{policy}: {launches['apply']} ps_apply launches, want {want_launches}")

    # the per-request reference ("rounds": the same pushes one by one,
    # bitwise) or the sum reference ("combine": one push of the per-row
    # sums in member order, 1e-5)
    van = LoopbackVan()
    ref_srv = server(van)
    try:
        if policy == "rounds":
            for m in msgs:
                ref_srv.handle_request(m)
        else:
            acc = np.zeros((rows, dim), np.float32)
            for m in msgs:
                acc[m.keys] += np.asarray(m.values[0]).reshape(-1, dim)
            uids = np.unique(ids_all)
            ref_srv.handle_request(Message(
                task=Task(TaskKind.PUSH, "kv", payload={"table": "w"}), sender="W0",
                recver="S0", keys=uids.astype(np.int32), values=[acc[uids]]))
        ref_table = ref_srv.export_shard()["w"]
    finally:
        van.close()
        ref_srv.ledger.close()
    err = 0.0
    for name in ["value", *sorted(window_table["state"])]:
        a = window_table["value"] if name == "value" else window_table["state"][name]
        b = ref_table["value"] if name == "value" else ref_table["state"][name]
        err = max(err, float(np.abs(a - b).max()))
        if policy == "rounds":
            check(np.array_equal(a, b), f"rounds: {name} differs from the per-request table")
        else:
            check(np.allclose(a, b, rtol=1e-5, atol=1e-5),
                  f"combine: {name} vs the summed push, max err {err}")

    # bench.py's timing on the received bundle, replayed
    samples = {"bundled": [], "per_request": []}
    vans = [LoopbackVan(), LoopbackVan()]
    arms = {"bundled": server(vans[0]), "per_request": server(vans[1])}
    try:
        def once(arm):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            if arm == "bundled":
                arms[arm].handle_request_batch(list(msgs))
            else:
                for m in msgs:
                    arms[arm].handle_request(m)
            torch.cuda.synchronize()
            return (time.perf_counter() - t0) * 1e3

        once("bundled"), once("per_request")  # warm-up
        for rep in range(reps):  # interleaved: b, p, p, b, b, p, ...
            for arm in (("bundled", "per_request"), ("per_request", "bundled"))[rep % 2]:
                samples[arm].append(once(arm))
    finally:
        for v in vans:
            v.close()
        for a in arms.values():
            a.ledger.close()
    med = {arm: float(np.median(v)) for arm, v in samples.items()}
    return {"members": k, "ids_per_push": batch, "pool": pool, "dim": dim, "rows": rows,
            "handle_request_batch_calls": len(bundles), "bundle_members": len(msgs),
            "ps_apply_launches_per_bundle": launches["apply"],
            "ledger_entries_per_bundle": ledger["applies_submitted"],
            "launches": launches, "coalesce": coalesce,
            "max_abs_err_vs_reference": err,
            "reference": "per-request, bitwise" if policy == "rounds"
            else "one push of the per-row sums, rtol=atol=1e-5",
            "ms_per_bundle": _ms_quantiles(samples["bundled"]),
            "ms_per_request_arm": _ms_quantiles(samples["per_request"]),
            "per_request_over_bundled": med["per_request"] / med["bundled"]}


def coalesce_phase(torch, scatter, dev):
    """The PS loop on ``CoalescingVan(LoopbackVan())``: the learner's loop
    (timer-flushed frames), the ordered loop on both stacks (bitwise-equal
    tables), and the apply-engine shape under both duplicate policies."""
    scatter.reset_launch_counts()
    loop = run_loop(torch, dev, fused=True, steps=COALESCE_STEPS, coalesce=True)
    counts = scatter.launch_counts()
    check(counts["apply"] == loop["pushes"] and counts["gather"] == loop["pulls"],
          f"coalesced loop launches {counts} for {loop['pushes']} pushes, {loop['pulls']} pulls")
    check(all(np.isfinite(loop["losses"])), "coalesced loop losses")
    runs = {side: ordered_loop(torch, dev, coalesce=side == "coalesced")
            for side in ("plain", "coalesced")}
    for a, b in zip(runs["plain"]["tables"], runs["coalesced"]["tables"]):
        check(np.array_equal(a["value"], b["value"])
              and np.array_equal(a["state"]["sum_sq"], b["state"]["sum_sq"]),
              "ordered loop: coalesced tables differ from the plain stack's")
    van = runs["coalesced"]["van"]
    check(van["coalesce_msgs"] > van["coalesce_frames"], f"ordered loop never bundled: {van}")
    return {
        "loop": {"steps_per_worker": COALESCE_STEPS, "examples_per_s": loop["examples_per_s"],
                 "loss_first": float(np.mean(loop["losses"][:2])),
                 "loss_last": float(np.mean(loop["losses"][-2:])),
                 "launches": counts, "van": loop["van"], "ledger": loop["ledger"]},
        "ordered": {"steps": ORDERED_STEPS, "workers": 2, "servers": 2,
                    "pushes": runs["coalesced"]["pushes"], "pulls": runs["coalesced"]["pulls"],
                    "bitwise_equal_tables": True, "van": van,
                    "ledger": runs["coalesced"]["ledger"]},
        "apply_engine": {p: apply_engine_leg(torch, scatter, dev, p)
                         for p in ("rounds", "combine")},
    }


def localizer_phase():
    """One config #1 batch (638,976 keys) through ``Localizer(2^22)`` on the
    native keymap (built with g++ at first use) and on the numpy engine:
    identical slots; keys per second of a first pass (inserts) and a second
    pass (lookups), host clock."""
    from parameter_server_tpu_torch import native
    from parameter_server_tpu_torch.utils import keys as keys_mod

    flat = _main_batch_slots()[0].reshape(-1).astype(np.uint64)
    t0 = time.perf_counter()
    engines = {"native": keys_mod.Localizer(ROWS)}
    build_s = time.perf_counter() - t0
    check(engines["native"]._native is not None,
          "the native keymap did not build: Localizer fell back to numpy")
    real = keys_mod._native_keymap
    keys_mod._native_keymap = lambda cap: None
    try:
        engines["numpy"] = keys_mod.Localizer(ROWS)
    finally:
        keys_mod._native_keymap = real
    check(engines["numpy"]._native is None, "numpy engine")
    out, slots = {}, {}
    for name, loc in engines.items():
        passes = []
        for _ in range(2):
            t0 = time.perf_counter()
            got = loc.assign(flat)
            passes.append(time.perf_counter() - t0)
            slots.setdefault(name, got)
            check(np.array_equal(got, slots[name]), f"{name}: second pass moved a slot")
        out[name] = {"insert_keys_per_s": flat.size / passes[0],
                     "lookup_keys_per_s": flat.size / passes[1],
                     "vocab": len(loc), "overflowed": bool(loc.overflowed)}
    check(np.array_equal(slots["native"], slots["numpy"]), "native slots differ from numpy's")
    return {"keys": int(flat.size), "unique": int(np.unique(flat).size), "capacity": ROWS,
            "engine": "native", "library": native.library_path("keymap").split("/")[-1],
            "first_load_s": build_s, "slots_equal": True, **out}


def flightrec_phase():
    """The flight recorder after the phases above: a failing handler on a
    throwaway node journals ``recv.exception`` and its receive thread keeps
    serving; then ``dump()`` into the build directory, every bundle read
    back as JSON with the fields ``tools/postmortem.py`` reads."""
    import collections
    import pathlib
    import shutil

    from parameter_server_tpu_torch.core import flightrec
    from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind
    from parameter_server_tpu_torch.core.van import LoopbackVan

    van = LoopbackVan()
    served = []

    def handler(msg):
        if msg.task.time == 0:
            raise RuntimeError("chip_smoke: deliberate handler failure")
        served.append(msg.task.time)

    try:
        van.bind("SMOKE_X", handler)
        for t in (0, 1):
            van.send(Message(task=Task(TaskKind.CONTROL, "c", time=t), sender="SMOKE_W",
                             recver="SMOKE_X"))
        deadline = time.monotonic() + 10
        while served != [1] and time.monotonic() < deadline:
            time.sleep(0.005)
    finally:
        van.close()
    check(served == [1], f"the receive thread stopped serving: {served}")
    exc = [e for e in flightrec.get().events()
           if e["kind"] == "recv.exception" and e.get("node") == "SMOKE_X"]
    check(len(exc) == 1 and exc[0]["exc_type"] == "RuntimeError", f"recv.exception {exc}")

    out_dir = (pathlib.Path(__file__).resolve().parent / "parameter_server_tpu_torch"
               / "build" / "flightrec_dump")
    shutil.rmtree(out_dir, ignore_errors=True)
    try:
        paths = flightrec.dump(str(out_dir), reason="chip_smoke")
        kinds, nodes = collections.Counter(), []
        for path in paths:
            with open(path) as f:
                doc = json.load(f)
            for field in ("node", "events", "wall_anchor_s", "mono_anchor_s", "clock_offset_s",
                          "counters"):
                check(field in doc, f"{path}: no {field!r}")
            check(all({"kind", "seq", "t_mono_s"} <= set(e) for e in doc["events"]),
                  f"{path}: an event without kind/seq/t_mono_s")
            kinds.update(e["kind"] for e in doc["events"])
            nodes.append(doc["node"])
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    for kind in ("apply.submit", "apply.done", "apply.backlog", "bundle.flush", "fence.routing",
                 "recv.exception", "postmortem.dump"):
        check(kinds[kind] > 0, f"no {kind} event in the dump")
    check(kinds["apply.submit"] == kinds["apply.done"],
          f"apply.submit {kinds['apply.submit']} != apply.done {kinds['apply.done']}")
    check(set(kinds) <= flightrec.EVENTS, f"unregistered kinds {set(kinds) - flightrec.EVENTS}")
    return {"bundles": len(paths), "nodes": sorted(nodes), "events": sum(kinds.values()),
            "ring_capacity": flightrec.get()._ring.maxlen, "by_kind": dict(sorted(kinds.items())),
            "recv_exception_kept_serving": True}


# ---------------------------------------------------------------------------
# phase 7b: the synchronous push plane (worker groups, the consistency gate)
# ---------------------------------------------------------------------------


def _config1_tables(consistency=None):
    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig

    return {"w": TableConfig(name="w", rows=ROWS, dim=DIM,
                             optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.05),
                             consistency=consistency)}


def _card_grad(torch, device, w_pos, labels):
    """The LR gradient of one batch, computed on ``device``, as the host
    plane ``push_sync`` takes; and the batch's loss."""
    from parameter_server_tpu_torch.models import linear

    g, _gb, loss = linear.grad_rows(torch.tensor(w_pos, device=device),
                                    torch.tensor(labels, device=device))
    return g.cpu().numpy() / labels.shape[0], float(loss)


def _run_threads(fns, budget_s, on_tick=None):
    """Run ``fns`` on threads; call ``on_tick`` about every millisecond until
    they end or ``budget_s`` passes.  Returns (seconds, every thread ended)."""
    import threading

    errors = []

    def guard(fn):
        try:
            fn()
        except BaseException as e:  # noqa: BLE001 — re-raised below
            errors.append(e)

    threads = [threading.Thread(target=guard, args=(fn,), daemon=True) for fn in fns]
    t0 = time.perf_counter()
    for th in threads:
        th.start()
    while any(th.is_alive() for th in threads) and time.perf_counter() - t0 < budget_s:
        if on_tick is not None:
            on_tick()
        time.sleep(0.001)
    wall = time.perf_counter() - t0
    ended = not any(th.is_alive() for th in threads)
    for th in threads:
        th.join(timeout=5)
    if errors:
        raise errors[0]
    return wall, ended


def _inbound_push(metered):
    """PUSH requests and payload bytes into the servers, from MeteredVan."""
    tot = {"msgs": 0, "bytes": 0}
    for link, d in metered.links().items():
        if link.partition("->")[2].startswith("S"):
            vb = d["verbs"].get("PUSH")
            if vb:
                tot["msgs"] += vb["msgs"]
                tot["bytes"] += vb["bytes"]
    return tot


def sync_plane_batches():
    """The config #1 batches of phases ``hier`` (one stream, seed 5, every
    worker trains on it) and ``consist`` (one stream a worker, seeds 300 +
    i), made once and shared by every arm."""
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR

    def stream(seed, n):
        data = SyntheticCTR(key_space=KEY_SPACE, nnz=NNZ, batch_size=BATCH, seed=seed,
                            informative=0.1)
        return [data.next_batch() for _ in range(n)]

    return (stream(5, HIER_WARM + HIER_TIMED),
            [stream(300 + i, CONSIST_STEPS) for i in range(CONSIST_WORKERS)])


def hier_arm(torch, device, size, batches, warm):
    """bench.py's ``_hier_arm`` (``bench.py:2775-2907``) on the port: 4
    workers x 2 servers on ``CoalescingVan(MeteredVan(LoopbackVan()))``, the
    config #1 table, groups of ``size`` (1: direct pushes).  Every worker
    trains on the same batches, barrier-locked: pull_sync, the gradient on
    ``device``, push_sync.  ``warm`` steps, then the timed rest."""
    import threading

    from parameter_server_tpu_torch.config import GroupConfig
    from parameter_server_tpu_torch.core.coalesce import CoalescingVan
    from parameter_server_tpu_torch.core.netmon import MeteredVan
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.routing import WorkerGroup
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker

    cfgs = _config1_tables()
    metered = MeteredVan(LoopbackVan())
    van = CoalescingVan(metered)
    servers = [KVServer(Postoffice(f"S{s}", van), cfgs, s, HIER_SERVERS, device=device)
               for s in range(HIER_SERVERS)]
    try:
        names = [f"W{i}" for i in range(HIER_WORKERS)]
        workers = []
        for i, name in enumerate(names):
            group = group_cfg = None
            if size > 1:
                base = (i // size) * size
                group = WorkerGroup(members=tuple(names[base:base + size]))
                # as bench.py: the clean path must never fall back because a
                # thread was descheduled
                group_cfg = GroupConfig(size=size, fallback_timeout=30.0)
            workers.append(KVWorker(Postoffice(name, van), cfgs, HIER_SERVERS, group=group,
                                    group_cfg=group_cfg, device=device))
        losses = [[] for _ in workers]
        barrier = threading.Barrier(HIER_WORKERS)

        def loop(i, kv, phase_batches):
            try:
                for keys, labels in phase_batches:
                    barrier.wait()
                    w_pos = kv.pull_sync("w", keys, timeout=300)
                    g, loss = _card_grad(torch, device, w_pos, labels)
                    kv.push_sync("w", keys, g, timeout=300)
                    losses[i].append(loss)
            except BaseException:
                barrier.abort()
                raise

        def phase(phase_batches):
            wall, ended = _run_threads(
                [functools.partial(loop, i, kv, phase_batches) for i, kv in enumerate(workers)],
                600)
            check(ended, f"hier size {size}: a worker did not finish")
            return wall

        if warm:
            phase(batches[:warm])
        push0 = _inbound_push(metered)
        _sync(torch, device)
        elapsed = phase(batches[warm:])
        _sync(torch, device)
        push1 = _inbound_push(metered)
        return {
            "examples_per_s": HIER_WORKERS * BATCH * (len(batches) - warm) / elapsed,
            "elapsed_s": elapsed, "loss_first": losses[0][0], "loss_last": losses[0][-1],
            "push_msgs": push1["msgs"] - push0["msgs"],
            "push_bytes": push1["bytes"] - push0["bytes"],
            "group_pushes": sum(s.group_pushes for s in servers),
            "group_members": sum(s.group_members for s in servers),
            "group_fallbacks": sum(w.counters().get("group_fallbacks", 0) for w in workers),
            "pushes": sum(s.pushes for s in servers), "pulls": sum(s.pulls for s in servers),
            "tables": [s.export_shard()["w"] for s in servers],
        }
    finally:
        close_cluster(van, servers)


def _sync(torch, device):
    if device.type == "cuda":
        torch.cuda.synchronize()


def hier_phase(torch, scatter, dev, batches):
    """Group sizes 1, 2 and 4 at config #1's full width: PUSH requests per
    timed step must be 2 servers x 4 workers / size, with no fallback; then
    the size-2 arm for 2 steps on the card and on the CPU (1e-5)."""
    arms = {}
    scatter.reset_launch_counts()
    for size in HIER_SIZES:
        r = hier_arm(torch, dev, size, batches, HIER_WARM)
        r.pop("tables")
        want = HIER_TIMED * HIER_SERVERS * HIER_WORKERS // size
        check(r["push_msgs"] == want,
              f"hier size {size}: {r['push_msgs']} PUSH requests in {HIER_TIMED} steps, "
              f"want {want}")
        check(r["group_fallbacks"] == 0, f"hier size {size}: {r['group_fallbacks']} fallbacks")
        if size > 1:
            check(r["group_pushes"] == r["pushes"]
                  and r["group_members"] == size * r["group_pushes"],
                  f"hier size {size}: group booking {r}")
        check(r["loss_last"] < r["loss_first"], f"hier size {size}: loss did not fall")
        r["push_msgs_per_step"] = r["push_msgs"] / HIER_TIMED
        arms[size] = r
    launches = scatter.launch_counts()
    pulls = sum(r["pulls"] for r in arms.values())
    pushes = sum(r["pushes"] for r in arms.values())
    check(launches["gather"] == pulls and launches["apply"] == pushes,
          f"hier launches {launches} for {pulls} pulls and {pushes} pushes")
    # the size-2 arm, 2 steps, on the card and on the CPU (plain versions)
    tables = {side: hier_arm(torch, device, 2, batches[:2], 0)["tables"]
              for side, device in (("card", dev), ("cpu", torch.device("cpu")))}
    err = 0.0
    for sg, sc in zip(tables["card"], tables["cpu"]):
        for a, b in [(sg["value"], sc["value"]), (sg["state"]["sum_sq"], sc["state"]["sum_sq"])]:
            err = max(err, float(np.abs(a - b).max()))
    check(err <= 1e-5, f"hier size 2: card vs cpu tables differ by {err}")
    return {"workers": HIER_WORKERS, "servers": HIER_SERVERS, "warm_steps": HIER_WARM,
            "timed_steps": HIER_TIMED, "arms": {str(k): v for k, v in arms.items()},
            "launches": launches, "size2_card_vs_cpu_max_abs_err": err, "tol": 1e-5}


def consist_arm(torch, dev, mode, bound, batches, slow_steps, slow_s=CONSIST_SLOW_S,
                budget_s=CONSIST_BUDGET_S):
    """bench.py's ``_consistency_one`` (``bench.py:3995-4150``) on the port:
    3 workers x 2 servers on a LoopbackVan, the config #1 table gated by
    ``mode`` / ``bound`` (deadline 30 s), every worker registered by
    ``consist_hello``; worker 0 sleeps ``slow_s`` at ``slow_steps``.
    The servers' fleet clocks are sampled about every millisecond."""
    from parameter_server_tpu_torch.config import ConsistencyConfig, ConsistencyMode

    van, servers, workers = build_cluster(torch, dev, rows=ROWS, fused=True,
                                          n_workers=CONSIST_WORKERS, tables=_config1_tables(
                                              ConsistencyConfig(mode=ConsistencyMode(mode),
                                                                max_delay=bound,
                                                                gate_deadline_s=30.0)))
    try:
        for kv in workers:
            kv.consist_hello(table="w")
        spread = [0]

        def sample():
            for s in servers:
                snap = s._consist["w"]["clock"].snapshot()
                if len(snap) == CONSIST_WORKERS:
                    spread[0] = max(spread[0], max(snap.values()) - min(snap.values()))

        def loop(i, kv):
            for t, (keys, labels) in enumerate(batches[i]):
                if i == 0 and t in slow_steps:
                    time.sleep(slow_s)
                w_pos = kv.pull_sync("w", keys, timeout=120)
                g, _loss = _card_grad(torch, dev, w_pos, labels)
                kv.push_sync("w", keys, g, timeout=120)

        wall, ended = _run_threads([functools.partial(loop, i, kv)
                                    for i, kv in enumerate(workers)], budget_s, sample)
        sample()
        sc = [s.counters() for s in servers]
        return {
            "mode": mode, "bound": bound, "ended_within_budget": ended, "wall_s": wall,
            "examples_per_s": CONSIST_WORKERS * CONSIST_STEPS * BATCH / wall,
            "consist_defers": sum(c["consist_defers"] for c in sc),
            "consist_releases": sum(c["consist_releases"] for c in sc),
            "max_clock_spread": spread[0],
            "worker_waits": sum(kv.consist_waits for kv in workers),
            "worker_forced": sum(kv.consist_forced for kv in workers),
            "steps": [kv.consist_step("w") for kv in workers],
            "pushes": sum(s.pushes for s in servers), "pulls": sum(s.pulls for s in servers),
        }
    finally:
        close_cluster(van, servers)


def bsp_alternation(torch, dev, batches, gated):
    """tests/test_consistency.py:300-326 at full width: 2 workers strictly
    alternating 6 steps (pull, card gradient, push), gated by BSP or not."""
    from parameter_server_tpu_torch.config import ConsistencyConfig, ConsistencyMode

    gate = ConsistencyConfig(mode=ConsistencyMode.BSP, gate_deadline_s=30.0) if gated else None
    van, servers, (wa, wb) = build_cluster(torch, dev, rows=ROWS, fused=True, n_workers=2,
                                           tables=_config1_tables(gate))
    try:
        if gated:
            wa.consist_hello(table="w")
            wb.consist_hello(table="w")
        for i in range(6):
            kv = (wa, wb)[i % 2]
            keys, labels = batches[i]
            g, _loss = _card_grad(torch, dev, kv.pull_sync("w", keys, timeout=120), labels)
            kv.push_sync("w", keys, g, timeout=120)
        return ([s.export_shard()["w"] for s in servers],
                sum(kv.consist_waits for kv in (wa, wb)))
    finally:
        close_cluster(van, servers)


def consist_phase(torch, scatter, dev, streams):
    """The four arms of ``bench.py``'s ``_CONSIST_ARMS`` (``bench.py:
    3986-3992``) but ssp16, 8 steps a worker, worker 0 a seeded straggler
    (``bench.py:4045-4048``): the fleet clocks never spread past bound + 1
    under SSP and BSP, no arm deadlocks; then BSP under strict alternation
    bitwise equal to the ungated run."""
    srng = np.random.default_rng(777)
    slow_steps = set(np.nonzero(srng.random(CONSIST_STEPS) < CONSIST_SLOW_P)[0].tolist())
    arms = {}
    scatter.reset_launch_counts()
    for name, mode, bound in CONSIST_ARMS:
        r = consist_arm(torch, dev, mode, bound, streams, slow_steps)
        check(r["ended_within_budget"], f"consist {name}: not done in {CONSIST_BUDGET_S} s")
        check(r["steps"] == [CONSIST_STEPS] * CONSIST_WORKERS, f"consist {name}: {r['steps']}")
        check(r["worker_forced"] == 0, f"consist {name}: {r['worker_forced']} forced requests")
        if mode != "asp":
            check(r["max_clock_spread"] <= bound + 1,
                  f"consist {name}: fleet clocks spread {r['max_clock_spread']} > {bound + 1}")
        arms[name] = r
    # the park leg: a pause longer than a step must be waited out at the gate
    park = consist_arm(torch, dev, "bsp", 0, streams, {1}, CONSIST_PARK_S)
    check(park["ended_within_budget"] and park["worker_forced"] == 0
          and park["max_clock_spread"] <= 1, f"consist park: {park}")
    check(park["consist_defers"] > 0 and park["consist_releases"] > 0,
          f"consist park: worker 0 paused {CONSIST_PARK_S} s and nobody was deferred: {park}")
    arms["bsp_park"] = park
    launches = scatter.launch_counts()
    pulls = sum(r["pulls"] for r in arms.values())
    pushes = sum(r["pushes"] for r in arms.values())
    check(launches["gather"] == pulls and launches["apply"] == pushes,
          f"consist launches {launches} for {pulls} pulls and {pushes} pushes")
    (gated, waits), (ungated, _) = (bsp_alternation(torch, dev, streams[0], g)
                                     for g in (True, False))
    for a, b in zip(gated, ungated):
        check(np.array_equal(a["value"], b["value"])
              and np.array_equal(a["state"]["sum_sq"], b["state"]["sum_sq"]),
              "BSP under strict alternation differs from the ungated run")
    return {"workers": CONSIST_WORKERS, "servers": 2, "steps_per_worker": CONSIST_STEPS,
            "slow_steps_worker0": sorted(slow_steps), "slow_s": CONSIST_SLOW_S, "park_s": CONSIST_PARK_S, "arms": arms,
            "launches": launches,
            "bsp_alternation": {"steps": 6, "bitwise_equal_to_ungated": True,
                                "gate_waits": waits}}


# ---------------------------------------------------------------------------
# phase 8: the local (single-device) path
# ---------------------------------------------------------------------------


def local_pool():
    """4 distinct host blocks of 32 batches each (``bench.py``'s memoised
    pool): keys validated to uint32 once, as the bench's producer does."""
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
    from parameter_server_tpu_torch.utils.keys import ensure_uint32_keys

    data = SyntheticCTR(key_space=KEY_SPACE, nnz=NNZ, batch_size=BATCH, seed=0,
                        informative=0.1)
    pool = []
    for _ in range(LOCAL_POOL):
        batches = [data.next_batch() for _ in range(BLOCK)]
        pool.append((ensure_uint32_keys(np.stack([b[0] for b in batches])),
                     np.stack([b[1] for b in batches])))
    return pool


def _local_trainer(device, **kw):
    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
    from parameter_server_tpu_torch.learner.sgd import LocalLRTrainer

    cfg = TableConfig(name="w", rows=ROWS, dim=DIM,
                      optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.05),
                      fused_apply=kw.pop("fused_apply", True))
    return LocalLRTrainer(cfg, device=device, **kw)


def _dense_trainer(device):
    return _local_trainer(device, mode="dense", device_hash=True)


def _check_local_tables(torch, trainer, dev):
    planes = [trainer.table.value, *trainer.table.state.values(), trainer.bias]
    devices = sorted({str(t.device) for t in planes})
    check(devices == [str(torch.empty(0, device=dev).device)], f"local tables on {devices}")
    for name, plane in [("value", trainer.table.value), *trainer.table.state.items()]:
        check(float(plane[ROWS].abs().max()) == 0.0, f"local trash row of {name} is not 0")
    return devices


def local_phase(torch, dev, pool):
    """bench.py's pipelined headline loop: blocks through the prefetch
    pipeline into ``step_block_device``, a barrier at the end."""
    from parameter_server_tpu_torch.data.prefetch import PrefetchPipeline

    trainer = _dense_trainer(dev)
    losses = []
    with PrefetchPipeline(lambda i: pool[i % LOCAL_POOL], depth=2, device=dev) as pf:
        for _ in range(LOCAL_WARM):
            losses.append(trainer.step_block_device(*pf.get()))
        torch.cuda.synchronize()
        warm = pf.counters()
        t0 = time.perf_counter()
        for _ in range(LOCAL_TIMED):
            losses.append(trainer.step_block_device(*pf.get()))
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        timed = pf.counters()
    losses = torch.cat(losses).cpu().numpy()
    check(losses.shape == ((LOCAL_WARM + LOCAL_TIMED) * BLOCK,) and bool(np.isfinite(losses).all()),
          f"local losses {losses.shape}")
    first, last = float(losses[:BLOCK].mean()), float(losses[-BLOCK:].mean())
    check(last < first - 0.01, f"local loss did not fall: {first} -> {last}")
    check(trainer.step_count == (LOCAL_WARM + LOCAL_TIMED) * BLOCK, "local step count")
    devices = _check_local_tables(torch, trainer, dev)
    return trainer, {
        "rows": ROWS, "batch": BATCH, "nnz": NNZ, "block": BLOCK, "pool_blocks": LOCAL_POOL,
        "prefetch_depth": 2, "warm_blocks": LOCAL_WARM, "timed_blocks": LOCAL_TIMED,
        "wall_s": wall, "examples_per_s": LOCAL_TIMED * BLOCK * BATCH / wall,
        "ms_per_step": wall * 1e3 / (LOCAL_TIMED * BLOCK),
        "loss_first": float(losses[0]), "loss_last": float(losses[-1]),
        "loss_first_block_mean": first, "loss_last_block_mean": last,
        "prefetch_timed": {k: timed[k] - warm[k] for k in timed},
        "prefetch_total": timed, "tables_on": devices, "trash_rows_zero": True,
    }


def trained_state(trainer):
    """The trainer's table and bias as numpy (for ``trainer_from_numpy``)."""
    return (trainer.table.value.cpu().numpy(),
            {k: v.cpu().numpy() for k, v in trainer.table.state.items()},
            trainer.bias.cpu().numpy(),
            {k: v.cpu().numpy() for k, v in trainer.bias_state.items()})


def _planes(trainer):
    return [trainer.table.value, trainer.table.state["sum_sq"], trainer.bias,
            trainer.bias_state["sum_sq"]]


def local_reference(torch, dev, state, pool):
    """One 4-step block from the trained state (every row it touches has
    sum_sq > 0) on the card twice and on the CPU once; then the device hash
    against the host hash."""
    from parameter_server_tpu_torch.convert import trainer_from_numpy
    from parameter_server_tpu_torch.models import linear
    from parameter_server_tpu_torch.utils.keys import (
        PAD_KEY, HashLocalizer, ensure_uint32_keys, mix32)

    keys, labels = pool[0][0][:LOCAL_REF_STEPS], pool[0][1][:LOCAL_REF_STEPS]
    runs = []
    for device in (dev, dev, torch.device("cpu")):
        tr = _dense_trainer(device)
        trainer_from_numpy(tr, *state)
        losses = tr.step_block(keys, labels)
        runs.append((losses.cpu(), [p.cpu() for p in _planes(tr)]))
        del tr
    (l1, p1), (l2, p2), (lc, pc) = runs
    check(torch.equal(l1, l2) and all(torch.equal(a, b) for a, b in zip(p1, p2)),
          "the same block twice on the card gave different tables")
    loss_err = float((l1 - lc).abs().max())
    check(bool(torch.allclose(l1, lc, rtol=1e-4, atol=1e-4)), f"local losses vs cpu: {loss_err}")
    table_err = 0.0
    for a, b in zip(p1, pc):
        table_err = max(table_err, float((a - b).abs().max()))
        check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5)), f"local tables vs cpu: {table_err}")
    check(float(p1[0][ROWS].abs().max()) == 0.0 and float(p1[1][ROWS].abs().max()) == 0.0,
          "local reference: trash row is not 0")
    # the device hash, bit for bit: 2^20 random keys and the edge keys
    rng = np.random.default_rng(21)
    hkeys = np.concatenate([np.array([0, 1, 2**31, 2**32 - 2, 2**32 - 1], np.uint32),
                            rng.integers(0, 2**32, size=1 << 20, dtype=np.uint64)
                            .astype(np.uint32)])
    for seed in (0, 7):
        got = linear.mix32_torch(torch.from_numpy(hkeys.view(np.int32)).to(dev), seed)
        check(np.array_equal(got.cpu().numpy().astype(np.uint32),
                             mix32(hkeys, np.uint32(seed))), f"mix32_torch seed {seed}")
    # one batch's slots (and PAD) against the host localizer
    k64 = np.concatenate([pool[0][0][0].reshape(-1).astype(np.uint64),
                          np.array([0, 2**32 - 2, PAD_KEY], np.uint64)])
    got = linear.device_slots(torch.from_numpy(ensure_uint32_keys(k64).view(np.int32)).to(dev),
                              ROWS, 0)
    check(np.array_equal(got.cpu().numpy(), HashLocalizer(ROWS, hash_bits=32).assign(k64)),
          "device_slots vs HashLocalizer")
    return {"steps": LOCAL_REF_STEPS, "loss_max_abs_err": loss_err,
            "table_max_abs_err": table_err, "loss_tol": 1e-4, "table_tol": 1e-5,
            "bitwise_equal_runs": True, "trash_row_zero": True,
            "mix32_keys": int(hkeys.size), "mix32_bit_equal": True,
            "slots_keys": int(k64.size), "slots_equal": True}


def local_sync_free(torch, dev, trainer, pool):
    """One block through ``step_block_device`` with the card's sync debug
    mode set to raise on any host synchronisation."""
    from parameter_server_tpu_torch.data.prefetch import host_tensor

    kd, yd = host_tensor(pool[1][0]).to(dev), torch.from_numpy(pool[1][1]).to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        losses = trainer.step_block_device(kd, yd)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    losses = losses.cpu()
    check(bool(torch.isfinite(losses).all()), "sync-free block gave non-finite losses")
    return {"steps": int(losses.numel()), "sync_debug_mode": "error", "raised": False}


def _random_rows_state(rng):
    """A full-width AdaGrad state with every sum_sq > 0 (no row at its first
    touch, where the step's sign decides the update)."""
    value = rng.normal(scale=0.05, size=(ROWS + 1, 1)).astype(np.float32)
    sum_sq = rng.uniform(0.01, 1.0, size=(ROWS + 1, 1)).astype(np.float32)
    value[ROWS], sum_sq[ROWS] = 0, 0
    return (value, {"sum_sq": sum_sq}, np.full((1, 1), -0.5, np.float32),
            {"sum_sq": np.full((1, 1), 0.5, np.float32)})


def local_rows(torch, scatter, dev, pool):
    """Rows mode at full width: the card (kernels) against the CPU (plain
    versions) from one state; launches counted over the card's steps."""
    from parameter_server_tpu_torch.convert import trainer_from_numpy

    state = _random_rows_state(np.random.default_rng(22))
    batches = [(pool[0][0][k], pool[0][1][k]) for k in range(LOCAL_ROWS_STEPS)]
    out = {}
    for fused, steps in ((True, LOCAL_ROWS_STEPS), (False, 2)):
        runs = {}
        for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
            tr = _local_trainer(device, fused_apply=fused)
            trainer_from_numpy(tr, *state)
            torch.cuda.synchronize()
            scatter.reset_launch_counts()
            t0 = time.perf_counter()
            losses = [tr.step(k, y) for k, y in batches[:steps]]
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
            runs[side] = (np.asarray(losses), [p.cpu() for p in _planes(tr)],
                          scatter.launch_counts(), wall)
            if side == "card":
                _check_local_tables(torch, tr, dev)
            del tr
        (lg, pg, counts, wall), (lc, pc, cpu_counts, _) = runs["card"], runs["cpu"]
        check(cpu_counts == dict.fromkeys(cpu_counts, 0), f"cpu rows steps launched {cpu_counts}")
        want = {"apply": steps, "gather": steps, "scatter_set": 0, "scatter_add": 0}
        if not fused:
            want.update(apply=0, scatter_set=steps)
        check(counts == want, f"rows-mode launches {counts}, want {want}")
        check(np.allclose(lg, lc, rtol=1e-4, atol=1e-4), f"rows losses {lg} vs cpu {lc}")
        err = max(float((a - b).abs().max()) for a, b in zip(pg, pc))
        for a, b in zip(pg, pc):
            check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-5)), f"rows tables vs cpu: {err}")
        leg = {"steps": steps, "launches": counts, "loss_max_abs_err": float(np.abs(lg - lc).max()),
               "table_max_abs_err": err, "examples_per_s": steps * BATCH / wall}
        if fused:
            out.update(leg)
        else:
            out["three_pass"] = leg
    out.update(loss_tol=1e-4, table_tol=1e-5)
    return out


def local_profile(torch, dev, trainer, pool, blocks=2):
    """Device busy time, idle share and the top device ops over ``blocks``
    prefetch-fed blocks (after one warm block); then the dense segment sum
    of one batch timed alone in its shipped [N, 1] form and as 1-D data."""
    from parameter_server_tpu_torch.data.prefetch import PrefetchPipeline
    from parameter_server_tpu_torch.models import linear
    from parameter_server_tpu_torch.ops.scatter import segment_combine

    with PrefetchPipeline(lambda i: pool[(i + 2) % LOCAL_POOL], depth=2, device=dev) as pf:
        trainer.step_block_device(*pf.get())
        out = _device_profile(torch, lambda: [trainer.step_block_device(*pf.get())
                                              for _ in range(blocks)], top_n=10)
    # the segment sum of one batch alone: [N, 1] (as shipped) and 1-D data
    slots = linear.device_slots(torch.from_numpy(pool[0][0][0].view(np.int32)).to(dev),
                                ROWS).reshape(-1)
    vals = torch.randn((slots.numel(), 1), generator=torch.Generator(device=dev).manual_seed(3),
                       device=dev) / BATCH
    seg = {
        "rows_2d_ms": _time_ms(torch, lambda: segment_combine(vals, slots, ROWS + 1),
                               reps=20, warmup=3),
        "flat_1d_ms": _time_ms(torch, lambda: segment_combine(vals.reshape(-1), slots,
                                                              ROWS + 1), reps=20, warmup=3),
    }
    a = segment_combine(vals, slots, ROWS + 1).reshape(-1)
    b = segment_combine(vals.reshape(-1), slots, ROWS + 1)
    seg["flat_vs_2d_max_abs_err"] = float((a - b).abs().max())
    return {"blocks": blocks, "steps": blocks * BLOCK, **out,
            "examples_per_s": blocks * BLOCK * BATCH / (out["wall_ms"] / 1e3),
            "segment_sum_one_batch": seg}


# ---------------------------------------------------------------------------
# phase 8b: BASELINE config #3, DLRM over a 2^28-row embedding table
# ---------------------------------------------------------------------------


def _tf32_off(torch):
    """Both TF32 flags off (card-vs-CPU checks); returns a restore function."""
    old = (torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32)

    def restore():
        torch.backends.cuda.matmul.allow_tf32, torch.backends.cudnn.allow_tf32 = old

    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False
    return restore


def _dlrm_stream(rows):
    """dlrm_scale's batch stream (SyntheticDLRM, seed 3) at ``rows`` keys."""
    from parameter_server_tpu_torch.data.synthetic import SyntheticDLRM

    return SyntheticDLRM(key_space=rows, batch_size=DLRM_BATCH, seed=3)


def _mfu(dashboard, examples_per_s, what):
    """The MFU fields of a trainer's dashboard at a rate measured on the
    card: FLOPs per example (``counted_flops``), the card's data-sheet peak
    for the step's math mode, the mode, and the utilisation, which must lie
    strictly between 0 and 100%."""
    fpe, peak = dashboard.flops_per_example, dashboard.peak_flops
    check(fpe > 0 and peak > 0, f"{what}: flops/example {fpe}, peak {peak}")
    pct = 100.0 * fpe * examples_per_s / peak
    check(0.0 < pct < 100.0, f"{what}: mfu {pct}%")
    return {"flops_per_example": fpe, "peak_flops": peak, "precision": dashboard.precision,
            "examples_per_s": examples_per_s, "mfu_pct": pct}


def dlrm_phase(torch, scatter, dev):
    """``dlrm_scale.scale_run`` at bench.py's stepped shape (2^28 x 16, batch
    8192, 1 warm + 4 timed steps) with the launch count of that run; then,
    on the same trainer: the host / device split of a step, one step's peak
    memory, the trash row, 5 steps on one repeated batch.  Returns (fields,
    launches, trainer)."""
    from parameter_server_tpu_torch.parallel.dlrm_scale import scale_run
    from parameter_server_tpu_torch.utils.keys import localize_to_slots

    torch.cuda.synchronize()
    scatter.reset_launch_counts()
    out, trainer = scale_run(DLRM_ROWS_LOG2, DLRM_DIM, DLRM_BATCH, DLRM_STEPS,
                             DLRM_MIN_BUCKET, "zeros", dev)
    counts = scatter.launch_counts()
    runs = DLRM_STEPS + 1
    check(counts == {"apply": 0, "gather": runs, "scatter_set": runs, "scatter_add": 0},
          f"dlrm launches {counts} for {runs} steps")
    rows = 1 << DLRM_ROWS_LOG2
    planes = {"value": trainer.emb_value, **trainer.emb_state}
    table_bytes = sum(p.nbytes for p in planes.values())
    check(all(p.device.type == dev.type and not p.requires_grad for p in planes.values()),
          "dlrm table planes must be on the card and need no gradient")
    # 32 GiB at 2^28 x 16: value and sum_sq, read from the tensors
    check(table_bytes == 2 * (rows + 1) * DLRM_DIM * 4
          and out["table_gib"] == round(table_bytes / 2**30, 2),
          f"dlrm table {out['table_gib']} GiB, {table_bytes} bytes")
    check(bool(np.isfinite(out["losses"]).all()), f"dlrm losses {out['losses']}")

    # host part (localize_to_slots) and the rest of a step, on the next batches
    stream = _dlrm_stream(rows)
    for _ in range(runs):
        stream.next_batch()
    host_ms, dev_ms, event_ms = [], [], []
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    for _ in range(DLRM_STEPS):
        keys, dense, labels = stream.next_batch()
        t0 = time.perf_counter()
        slots, inverse, _n = localize_to_slots(keys, trainer.localizer,
                                               min_bucket=trainer.min_bucket)
        host_ms.append((time.perf_counter() - t0) * 1e3)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        start.record()
        loss = trainer.step_localized(slots, inverse, dense, labels)
        end.record()
        torch.cuda.synchronize()
        dev_ms.append((time.perf_counter() - t0) * 1e3)
        event_ms.append(start.elapsed_time(end))
        check(bool(torch.isfinite(loss)), "dlrm loss is not finite")

    # one step's peak memory above what is allocated before it
    keys, dense, labels = stream.next_batch()
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated(dev)
    torch.cuda.reset_peak_memory_stats(dev)
    trainer.step(keys, dense, labels)
    torch.cuda.synchronize()
    peak = torch.cuda.max_memory_allocated(dev)
    check(peak - table_bytes < table_bytes / 8,
          f"dlrm step peak {peak} bytes, table {table_bytes}")
    for name, p in planes.items():
        check(float(p[rows].abs().max()) == 0.0, f"dlrm trash row of {name} is not at its fill")

    # 5 steps on one repeated batch: the loss must fall
    rep = [trainer.step(keys, dense, labels) for _ in range(DLRM_REPEAT_STEPS)]
    check(bool(np.isfinite(rep).all()) and rep[-1] < rep[0], f"dlrm repeated batch {rep}")
    slots, inverse, n_unique = localize_to_slots(keys, trainer.localizer,
                                                 min_bucket=trainer.min_bucket)
    hot = int(np.bincount(inverse).max())
    fields = {
        **out, "launches": counts, "table_bytes": table_bytes,
        "host_localize_ms": host_ms, "host_localize_ms_median": float(np.median(host_ms)),
        "step_localized_ms": dev_ms, "step_localized_ms_median": float(np.median(dev_ms)),
        "step_localized_event_ms": event_ms,
        "memory_before_step_bytes": base, "step_peak_bytes": peak,
        "step_peak_less_table_bytes": peak - table_bytes,
        "step_peak_less_before_bytes": peak - base, "trash_rows_at_fill": True,
        "repeated_batch_losses": rep, "positions": int(keys.size),
        "unique_slots": n_unique, "bucket": int(slots.size), "hottest_slot_positions": hot,
        # the timed steps' median (host localize included) against the
        # dense part's matmul FLOPs
        "mfu": _mfu(trainer.dashboard, DLRM_BATCH / (out["step_ms_median"] / 1e3), "dlrm"),
    }
    return fields, counts, trainer


def dlrm_top_rows(torch, scatter, trainer, errs):
    """Both kernels at the top of the 2^28-row planes, where element offsets
    pass 2^32: a scatter-set of random rows into the 1024 rows below and at
    the trash row, read back by the plain gather and by the kernel."""
    dev = trainer.emb_value.device
    rows = trainer.cfg.rows
    planes = [trainer.emb_value, trainer.emb_state["sum_sq"]]
    ids = torch.arange(rows - 1023, rows + 1, dtype=torch.int32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    new = [torch.randn((ids.numel(), DLRM_DIM), generator=gen, device=dev) for _ in planes]
    scatter.scatter_update_rows_planes(planes, ids, new)
    plain = [torch.index_select(p, 0, ids.long()) for p in planes]
    err_set = max(float((a - b).abs().max()) for a, b in zip(plain, new))
    got = scatter.gather_rows_planes(planes, ids)
    err_get = max(float((a - b).abs().max()) for a, b in zip(got, plain))
    check(err_set == 0.0 and err_get == 0.0,
          f"top rows: scatter-set {err_set}, gather {err_get}")
    errs["scatter_set"] = max(errs["scatter_set"], err_set)
    errs["gather"] = max(errs["gather"], err_get)
    planes[0][rows:] = 0.0  # trash row back at its fill
    planes[1][rows:] = 0.0
    return {"ids": [rows - 1023, rows], "max_element_offset": (rows + 1) * DLRM_DIM - 1,
            "scatter_set_err": err_set, "gather_err": err_get}


def dlrm_kernel_times(torch, scatter, trainer, errs):
    """The step's two kernels at its shape: a two-plane gather and a
    two-plane scatter-set of one batch's 65,536 bucketed slots on the 2^28 x
    16 planes (the pads, about 29k, all at the trash row), for the slot sets
    of 8 consecutive batches.  Each set is first held against the plain
    versions: the gather against index_select, and a scatter-set of seeded
    rows (one row for each id, so the pads carry one) read back by
    index_select; then the gathered rows go back.  Then the times, cycling
    the sets (hot rows repeat across batches, as in training) in CUDA-graph
    replay: kernel, plain versions (two index_select / two index_put_) and
    library calls (index_select, index_copy_; two each, no single call
    covers two planes).  The timed scatter-set writes back the rows it
    gathered, so the table is unchanged."""
    from parameter_server_tpu_torch.utils.keys import localize_to_slots

    dev = trainer.emb_value.device
    planes = [trainer.emb_value, trainer.emb_state["sum_sq"]]
    stream = _dlrm_stream(1 << DLRM_ROWS_LOG2)
    id_sets = [localize_to_slots(stream.next_batch()[0], trainer.localizer,
                                 min_bucket=trainer.min_bucket)[0]
               for _ in range(DLRM_TIME_SETS)]
    n = id_sets[0].size
    check(all(s.size == n for s in id_sets), "dlrm slot sets differ in bucket size")
    ids = [torch.tensor(s, device=dev) for s in id_sets]
    longs = [i.long() for i in ids]
    rows = [scatter.cuda_gather_planes(planes, i) for i in ids]
    gen = torch.Generator(device=dev).manual_seed(29)
    err_get = err_set = 0.0
    uniq = []  # touched rows of each set: the pads collapse to one
    for s, i32, i, got in zip(id_sets, ids, longs, rows):
        err_get = max(err_get, *(float((g - torch.index_select(t, 0, i)).abs().max())
                                 for g, t in zip(got, planes)))
        u, first, inv = np.unique(s, return_index=True, return_inverse=True)
        uniq.append(int(u.size))
        same = torch.from_numpy(first[inv]).to(dev)  # each position -> its id's first
        new = [torch.randn((n, DLRM_DIM), generator=gen, device=dev)[same] for _ in planes]
        scatter.cuda_scatter_set_planes(planes, i32, new)
        err_set = max(err_set, *(float((torch.index_select(t, 0, i) - r).abs().max())
                                 for t, r in zip(planes, new)))
        for t, g in zip(planes, got):
            scatter.scatter_update_rows_torch(t, i, g)
    top = trainer.cfg.rows
    check(err_get == 0.0 and err_set == 0.0,
          f"dlrm-shape kernels vs plain: gather {err_get}, scatter-set {err_set}")
    check(all(float(t[top].abs().max()) == 0.0 for t in planes),
          "dlrm trash row not back at its fill after the kernel checks")
    errs["gather"] = max(errs["gather"], err_get)
    errs["scatter_set"] = max(errs["scatter_set"], err_set)
    f, row_bytes, p = 4, 4 * DLRM_DIM, len(planes)
    # each input read once, each output written once: ids, the touched table
    # rows and the n list rows of every plane
    nbytes = float(np.mean([f * n + p * (u + n) * row_bytes for u in uniq]))

    def cycle(fn):
        it = itertools.cycle(range(DLRM_TIME_SETS))
        return lambda: fn(next(it))

    specs = {
        "gather": dict(
            kernel=cycle(lambda i: scatter.cuda_gather_planes(planes, ids[i])),
            plain=cycle(lambda i: [scatter.gather_rows_torch(t, ids[i]) for t in planes]),
            library=cycle(lambda i: [torch.index_select(t, 0, longs[i]) for t in planes])),
        "scatter_set": dict(
            kernel=cycle(lambda i: scatter.cuda_scatter_set_planes(planes, ids[i], rows[i])),
            plain=cycle(lambda i: [scatter.scatter_update_rows_torch(t, ids[i], r)
                                   for t, r in zip(planes, rows[i])]),
            library=cycle(lambda i: [t.index_copy_(0, longs[i], r)
                                     for t, r in zip(planes, rows[i])])),
    }
    out = {}
    for name, spec in specs.items():
        row = {k: _graph_ms(torch, spec[k], per_graph=2 * DLRM_TIME_SETS, replays=10)
               for k in ("kernel", "plain", "library")}
        out[name] = {"ms": row["kernel"], "plain_ms": row["plain"], "library_ms": row["library"],
                     "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3, "bytes": nbytes,
                     "n": int(n), "dim": DLRM_DIM, "planes": p, "table_rows": int(planes[0].shape[0]),
                     "unique_rows_mean": float(np.mean(uniq)), "id_sets": DLRM_TIME_SETS,
                     "max_abs_err_vs_plain": err_get if name == "gather" else err_set}
        emit("times", kernel=name, case="dlrm", **out[name])
    return out


def dlrm_profile(torch, trainer, steps=DLRM_PROFILE_STEPS):
    """``steps`` DLRM steps (host localize included) under the profiler, and
    the segment sum's share of the device time."""
    stream = _dlrm_stream(trainer.cfg.rows)
    batches = [stream.next_batch() for _ in range(steps)]
    out = _device_profile(torch, lambda: [trainer.step(*b) for b in batches], top_n=12)
    return {"steps": steps, "ms_per_step": out["wall_ms"] / steps, **out}


def dlrm_control(torch, dev, stepped, profiled):
    """The 2^22-row control at the same batch: step-time flatness, as
    bench.py reads it (whole steps, host localize included), and on device
    busy time (``dlrm_profile``'s steps), where a step that walked the
    table would show."""
    from parameter_server_tpu_torch.parallel.dlrm_scale import scale_run

    small, trainer = scale_run(DLRM_CONTROL_LOG2, DLRM_DIM, DLRM_BATCH, DLRM_STEPS,
                               DLRM_MIN_BUCKET, "zeros", dev)
    ctl = dlrm_profile(torch, trainer)
    del trainer
    busy, ctl_busy = profiled["device_busy_ms"], ctl["device_busy_ms"]
    measured = isinstance(busy, float) and isinstance(ctl_busy, float)
    return {"step_ms_median_2e22": small["step_ms_median"], "step_ms_2e22": small["step_ms"],
            "table_gib_2e22": small["table_gib"],
            "flatness_vs_2e22": stepped["step_ms_median"] / max(small["step_ms_median"], 1e-9),
            "device_busy_ms_per_step_2e22":
                ctl_busy / ctl["steps"] if measured else "not measured",
            "device_flatness_vs_2e22": busy / ctl_busy if measured else "not measured",
            "segment_sum_share_2e22": ctl["segment_sum_share"],
            "top_device_ms_2e22": ctl["top_device_ms"][:6]}


def _dlrm_ref_trainer(device):
    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
    from parameter_server_tpu_torch.models.dlrm import SpmdDLRMTrainer

    cfg = TableConfig(name="emb", rows=DLRM_REF_ROWS, dim=DLRM_DIM, init_scale=0.01,
                      optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.05))
    return SpmdDLRMTrainer(cfg, device=device, learning_rate=0.01, min_bucket=1024)


def _dlrm_tensors(trainer):
    return {"value": trainer.emb_value, "sum_sq": trainer.emb_state["sum_sq"],
            **{k: p.detach() for k, p in trainer.model.named_parameters()}}


def dlrm_reference(torch, dev):
    """The test's small shape (2^14 x 16, batch 256, AdaGrad 0.05) from one
    numpy state (gaussian table, positive sum_sq, trash row at its fill, one
    MLP) on the card twice and on the CPU, both TF32 flags off: 1 step within
    1e-5, 5 steps within 1e-4; the two card runs bitwise equal after every
    step (else the first step and tensors that differ are named)."""
    from parameter_server_tpu_torch.convert import dlrm_from_numpy
    from parameter_server_tpu_torch.models.layers import params_tree

    restore = _tf32_off(torch)
    try:
        seed_tr = _dlrm_ref_trainer("cpu")
        value = seed_tr.emb_value.numpy()
        sum_sq = np.random.default_rng(23).uniform(0.01, 1.0, size=value.shape).astype(np.float32)
        sum_sq[DLRM_REF_ROWS:] = 0.0
        mlp = params_tree(seed_tr.model)
        stream = _dlrm_stream(DLRM_REF_ROWS)
        stream.batch_size = DLRM_REF_BATCH
        batches = [stream.next_batch() for _ in range(DLRM_REF_STEPS)]
        runs = []
        for device in (dev, dev, torch.device("cpu")):
            tr = _dlrm_ref_trainer(device)
            dlrm_from_numpy(tr, value, {"sum_sq": sum_sq}, mlp)
            losses, states = [], []
            for b in batches:
                losses.append(tr.step(*b))
                states.append({k: t.cpu().clone() for k, t in _dlrm_tensors(tr).items()})
            runs.append((np.asarray(losses), states))
            del tr
    finally:
        restore()
    (l1, s1), (l2, s2), (lc, sc) = runs
    for step, (a, b) in enumerate(zip(s1, s2)):
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        check(not differ and l1[step] == l2[step],
              f"dlrm: two seeded card runs differ at step {step + 1} in {differ} "
              f"(loss {l1[step]} vs {l2[step]})")
    out = {"rows": DLRM_REF_ROWS, "batch": DLRM_REF_BATCH, "steps": DLRM_REF_STEPS,
           "tf32": False, "bitwise_equal_runs": True}
    for label, step, tol in (("step1", 0, 1e-5), ("steps5", DLRM_REF_STEPS - 1, 1e-4)):
        loss_err = float(np.abs(l1[: step + 1] - lc[: step + 1]).max())
        check(np.allclose(l1[: step + 1], lc[: step + 1], rtol=tol, atol=tol),
              f"dlrm {label} losses {l1} vs cpu {lc}")
        err = 0.0
        for k, a in s1[step].items():
            e = float((a - sc[step][k]).abs().max())
            err = max(err, e)
            check(bool(torch.allclose(a, sc[step][k], rtol=tol, atol=tol)),
                  f"dlrm {label}: {k} vs cpu {e}")
        out[label] = {"loss_max_abs_err": loss_err, "state_max_abs_err": err, "tol": tol}
    check(float(s1[-1]["value"][DLRM_REF_ROWS].abs().max()) == 0.0, "dlrm ref trash row")
    return out


# ---------------------------------------------------------------------------
# phase 8c: BASELINE config #2, ResNet-50 on the dense plane
# ---------------------------------------------------------------------------


def resnet_batches():
    """One fixed batch for the single-card trainer and one for each async
    worker: SyntheticImages at 224 x 224, 1000 classes, 64 images."""
    from parameter_server_tpu_torch.data.synthetic import SyntheticImages

    data = SyntheticImages(num_classes=RESNET_CLASSES, hw=RESNET_HW,
                           batch_size=RESNET_BATCH, seed=0)
    return [data.next_batch() for _ in range(1 + ASYNC_WORKERS)]


def _resnet50(torch):
    from parameter_server_tpu_torch.models.resnet import resnet50

    return resnet50(num_classes=RESNET_CLASSES, generator=torch.Generator().manual_seed(0))


def _tf32_flags(torch):
    return {"matmul": torch.backends.cuda.matmul.allow_tf32,
            "cudnn": torch.backends.cudnn.allow_tf32}


def dense_spmd(torch, dev, batch):
    """``SpmdDenseTrainer`` with ResNet-50 on one fixed batch (SGD 0.1,
    momentum 0.9), torch's default precision flags: images/s over the timed
    steps, peak memory, the loss falling; then a tiny ResNet on the card and
    on the CPU from one init with both TF32 flags off."""
    from parameter_server_tpu_torch.learner.dense import SpmdDenseTrainer

    tr = SpmdDenseTrainer(_resnet50(torch), functools.partial(
        torch.optim.SGD, lr=DENSE_LR, momentum=0.9), device=dev)
    torch.cuda.reset_peak_memory_stats(dev)
    losses = [tr.step(*batch) for _ in range(DENSE_WARM)]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses += [tr.step(*batch) for _ in range(DENSE_TIMED)]
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0] - 0.1,
          f"resnet-50 loss did not fall: {losses}")
    check(all(p.device.type == dev.type for p in tr.model.parameters()),
          "resnet-50 params off the card")
    peak = torch.cuda.max_memory_allocated(dev)
    mfu = _mfu(tr.dashboard, DENSE_TIMED * RESNET_BATCH / wall, "resnet-50")
    profiled = _device_profile(torch, lambda: [tr.step(*batch) for _ in range(2)], top_n=12)
    del tr
    return {"model": "resnet50", "hw": RESNET_HW, "classes": RESNET_CLASSES,
            "batch": RESNET_BATCH, "warm_steps": DENSE_WARM, "timed_steps": DENSE_TIMED,
            "lr": DENSE_LR, "tf32": _tf32_flags(torch), "wall_s": wall,
            "images_per_s": DENSE_TIMED * RESNET_BATCH / wall,
            "ms_per_step": wall * 1e3 / DENSE_TIMED, "losses": losses,
            "peak_memory_bytes": peak, "profile_2_steps": profiled, "mfu": mfu,
            "tiny_vs_cpu": _tiny_resnet_vs_cpu(torch, dev)}


def _tiny_resnet_vs_cpu(torch, dev, steps=3):
    """A bottleneck ResNet (7x7/2 stem, max-pool, width 8) at 32 x 32, 3 SGD
    momentum steps from one init on the card and on the CPU, TF32 off:
    losses and every parameter and statistic within 1e-4, logits of the
    eval-mode forward within 1e-4."""
    import copy

    from parameter_server_tpu_torch.learner.dense import SpmdDenseTrainer
    from parameter_server_tpu_torch.models.resnet import ResNet

    rng = np.random.default_rng(31)
    images = rng.normal(size=(16, 32, 32, 3)).astype(np.float32)
    labels = rng.integers(0, 10, size=16).astype(np.int32)
    base = ResNet([1, 1], num_classes=10, width=8, generator=torch.Generator().manual_seed(5))
    restore = _tf32_off(torch)
    try:
        out = []
        for device in (dev, torch.device("cpu")):
            tr = SpmdDenseTrainer(copy.deepcopy(base), functools.partial(
                torch.optim.SGD, lr=0.3, momentum=0.9), device=device)
            losses = [tr.step(images, labels) for _ in range(steps)]
            state = {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}
            out.append((np.asarray(losses), state, tr.eval_logits(images)))
    finally:
        restore()
    (lg, sg, eg), (lc, scpu, ec) = out
    err = max(float((sg[k] - scpu[k]).abs().max()) for k in sg)
    check(np.allclose(lg, lc, rtol=1e-4, atol=1e-4), f"tiny resnet losses {lg} vs cpu {lc}")
    check(all(torch.allclose(sg[k], scpu[k], rtol=1e-4, atol=1e-4) for k in sg),
          f"tiny resnet state vs cpu {err}")
    check(np.allclose(eg, ec, rtol=1e-4, atol=1e-4), "tiny resnet eval logits vs cpu")
    return {"steps": steps, "loss_max_abs_err": float(np.abs(lg - lc).max()),
            "state_max_abs_err": err, "logits_max_abs_err": float(np.abs(eg - ec).max()),
            "tol": 1e-4, "tf32": False}


def dense_async(torch, dev, batches):
    """``AsyncDenseLearner``: 2 workers x 2 servers on ``MeteredVan(
    LoopbackVan())`` under BSP, ResNet-50 (25.6 M floats, about 102 MB a push
    and a pull), each worker memorising its fixed batch of 64, the servers'
    plain SGD (lr 0.1) on the card.  images/s over the run, PUSH and PULL
    payload bytes a step from the van, the loss falling."""
    from parameter_server_tpu_torch.config import (
        ConsistencyConfig, ConsistencyMode, OptimizerConfig)
    from parameter_server_tpu_torch.core.netmon import MeteredVan
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.dense import DenseKVServer, DenseKVWorker
    from parameter_server_tpu_torch.learner.dense import AsyncDenseLearner

    van = MeteredVan(LoopbackVan())
    try:
        model = _resnet50(torch)
        total = sum(p.numel() for p in model.parameters())
        workers = [DenseKVWorker(Postoffice(f"W{i}", van), {"model": total}, ASYNC_SERVERS,
                                 device=dev) for i in range(ASYNC_WORKERS)]
        learner = AsyncDenseLearner(model, workers, ConsistencyConfig(mode=ConsistencyMode.BSP),
                                    device=dev)
        init = learner.initial_vector()
        servers = [DenseKVServer(Postoffice(f"S{i}", van),
                                 {"model": (total, OptimizerConfig(kind="sgd",
                                                                   learning_rate=ASYNC_LR))},
                                 i, ASYNC_SERVERS, init_vectors={"model": init}, device=dev)
                   for i in range(ASYNC_SERVERS)]
        del init
        batch_fns = [lambda b=b: b for b in batches[1:]]
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        losses = learner.run(batch_fns, ASYNC_STEPS, timeout=300)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        links = van.links()
        # 2 more BSP steps under the profiler, through a fresh learner (its
        # own clock) on the same workers and servers
        again = AsyncDenseLearner(learner.model, workers,
                                  ConsistencyConfig(mode=ConsistencyMode.BSP), device=dev)
        profiled = _device_profile(torch, lambda: again.run(batch_fns, 2, timeout=300),
                                   top_n=12)
        del again
        check(all(s.segments["model"]["value"].device.type == dev.type for s in servers),
              "dense servers off the card")
        a, b = (dict(r.named_buffers()) for r in learner.replicas)
        check(not torch.equal(a["stem_bn.mean"], b["stem_bn.mean"]),
              "batch statistics must stay local to each worker")
        codec_total = learner.codec.total
        del learner, servers, workers, a, b
    finally:
        van.close()
    verb_bytes = {"PUSH": 0, "PULL": 0}
    for link, d in links.items():
        src, _, dst = link.partition("->")
        for verb, to_server in (("PUSH", True), ("PULL", False)):
            if (dst if to_server else src).startswith("S") and verb in d["verbs"]:
                verb_bytes[verb] += d["verbs"][verb]["bytes"]
    n = len(losses)
    first, last = float(np.mean(losses[:ASYNC_WORKERS])), float(np.mean(losses[-ASYNC_WORKERS:]))
    check(n == ASYNC_WORKERS * ASYNC_STEPS and bool(np.isfinite(losses).all()),
          f"dense async losses {losses}")
    check(last < first - 0.1, f"dense async loss did not fall: {first} -> {last}")
    return {"model": "resnet50", "workers": ASYNC_WORKERS, "servers": ASYNC_SERVERS,
            "mode": "bsp", "steps_per_worker": ASYNC_STEPS, "batch_per_worker": RESNET_BATCH,
            "server_lr": ASYNC_LR, "params": codec_total, "tf32": _tf32_flags(torch),
            "wall_s": wall, "images_per_s": ASYNC_WORKERS * ASYNC_STEPS * RESNET_BATCH / wall,
            # PUSH payloads into the servers and PULL replies out of them, over
            # the whole fleet (every worker) per step
            "push_bytes_per_step": verb_bytes["PUSH"] / ASYNC_STEPS,
            "pull_bytes_per_step": verb_bytes["PULL"] / ASYNC_STEPS,
            "vector_bytes": codec_total * 4, "losses": losses, "profile_2_steps": profiled,
            "loss_first_step_mean": first, "loss_last_step_mean": last}


def dense_ckpt(torch, dev):
    """ResNet-50's flat vector on 2 ``DenseKVServer``s with AdaGrad (value and
    ``sum_sq`` on the card), one seeded gradient pushed so the state is not
    its fill; ``DenseKVWorker.save_model``, then ``load_model`` onto 3
    servers: every element of value and state bitwise equal."""
    import os
    import shutil

    from parameter_server_tpu_torch.config import OptimizerConfig
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.dense import DenseKVServer, DenseKVWorker, PytreeCodec
    from parameter_server_tpu_torch.models.layers import params_tree

    model = _resnet50(torch)
    tree = params_tree(model)
    init = PytreeCodec(tree).flatten(tree)
    del model, tree
    total = int(init.size)
    opt = OptimizerConfig(kind="adagrad", learning_rate=DENSE_CKPT_LR)
    root = os.path.join(_durable_root(), "dense")
    shutil.rmtree(root, ignore_errors=True)
    vans = [LoopbackVan(), LoopbackVan()]
    try:
        fleets = []
        for van, n in zip(vans, (2, 3)):
            servers = [DenseKVServer(Postoffice(f"S{i}", van), {"model": (total, opt)}, i, n,
                                     init_vectors={"model": init}, device=dev)
                       for i in range(n)]
            fleets.append((servers, DenseKVWorker(Postoffice("W0", van), {"model": total}, n,
                                                  device=dev)))
        (writers, wkr), (readers, rdr) = fleets
        grad = np.random.default_rng(5).normal(size=total).astype(np.float32)
        check(wkr.wait(wkr.push("model", grad), timeout=300), "dense push timed out")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        wkr.save_model(root, 1)
        write_s = time.perf_counter() - t0
        nbytes = _dir_bytes(root)
        t0 = time.perf_counter()
        rdr.load_model(root, 1)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0

        def whole(servers, name):
            return torch.cat([(s.segments["model"]["value"] if name == "value"
                               else s.segments["model"]["state"][name]).reshape(-1)
                              for s in servers])

        for name in ("value", "sum_sq"):
            check(torch.equal(whole(writers, name), whole(readers, name)),
                  f"dense {name} differs after the reshard")
        check(bool(whole(writers, "sum_sq").abs().max() > 0), "dense state is zero")
        check(all(s.segments["model"]["value"].device.type == dev.type for s in readers),
              "dense readers off the card")
        return {"model": "resnet50", "params": total, "optimizer": "adagrad",
                "writers": 2, "readers": 3, "bytes": nbytes, "write_s": write_s,
                "read_s": read_s, "write_gb_per_s": nbytes / write_s / 1e9,
                "read_gb_per_s": nbytes / read_s / 1e9, "value_and_state_bitwise_equal": True}
    finally:
        for van in vans:
            van.close()
        shutil.rmtree(root, ignore_errors=True)


# ---------------------------------------------------------------------------
# phase 8d: the serving plane and the replica chain
# ---------------------------------------------------------------------------


def _serve_tables(rows, consistency=None, dim=SERVE_DIM):
    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig

    return {"w": TableConfig(name="w", rows=rows, dim=dim,
                             optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.05),
                             consistency=consistency)}


def _free_cluster(torch, van, servers):
    """Close a cluster and hand its tables back to the card."""
    import gc

    close_cluster(van, servers)
    for srv in servers:
        srv.tables.clear()
    servers.clear()
    gc.collect()
    torch.cuda.empty_cache()


def _table_bytes(servers):
    """Bytes of every plane of every server's tables, read from the tensors."""
    return sum(t.value.nbytes + sum(p.nbytes for p in t.state.values())
               for srv in servers for t in srv.tables.values())


def _unique_lines(keys, slots, lines, n):
    """The first ``n`` of ``keys`` whose slots fall on distinct lines of a
    ``lines``-line direct-mapped cache (distinct slots too)."""
    _, first = np.unique(slots & (lines - 1), return_index=True)
    pick = np.sort(first)[:n]
    check(pick.size == n, f"only {pick.size} keys on distinct cache lines, need {n}")
    return keys[pick]


def _rows_by_plane(torch, servers, slots):
    """The servable rows of global ``slots``, read by ``index_select`` from
    the owning shard's planes (the plain reference of a pull)."""
    routing = servers[0].routing.tables["w"]
    out = None
    for s, srv in enumerate(servers):
        table = srv.tables["w"]
        for lo, hi in routing.owned_segments(s):
            mask = (slots >= lo) & (slots < hi)
            idx = torch.from_numpy((slots[mask] - lo).astype(np.int64)).to(table.value.device)
            rows = table.optimizer.pull_weights(
                table.value.index_select(0, idx),
                {k: p.index_select(0, idx) for k, p in table.state.items()}).cpu().numpy()
            if out is None:
                out = np.zeros((slots.size, rows.shape[1]), np.float32)
            out[mask] = rows
    return out


class ApplyTap:
    """Holds ``ps_apply`` to its plain version on the path's own inputs.

    While installed, ``scatter.cuda_apply`` is wrapped: the first apply on
    each table (told apart by its value plane) gathers the rows its ids
    touch, and the trash row, from every plane before the launch; the
    wrapper then launches the kernel once, as the path asked, and runs
    ``apply_rows_torch`` on those copies (a compact table: the gathered rows,
    the trash row last, the pads pointed at it) with the same ids and
    gradients.  Everything stays on the launching stream, with no host
    synchronisation; :meth:`result` reads the errors once the run is over:
    the rows the kernel left against the plain ones (rtol 1e-5, atol 1e-6,
    as in ``kernels_vs_plain``) and the trash row unchanged."""

    def __init__(self, torch, scatter):
        self.torch, self.scatter, self.orig = torch, scatter, None
        self.seen, self.records = set(), []

    def __enter__(self):
        self.orig = self.scatter.cuda_apply
        self.scatter.cuda_apply = self._apply
        return self

    def __exit__(self, *exc):
        self.scatter.cuda_apply = self.orig

    def _apply(self, value, state, ids, grads, optimizer):
        torch, key = self.torch, value.data_ptr()
        if key in self.seen:
            return self.orig(value, state, ids, grads, optimizer)
        self.seen.add(key)
        trash = value.shape[0] - 1
        planes = [value, *(state[k] for k in sorted(state))]
        idx = ids.long()
        pre = [torch.cat([p.index_select(0, idx), p[trash:]]) for p in planes]
        self.orig(value, state, ids, grads, optimizer)
        n = idx.shape[0]
        pad = idx == trash
        cids = torch.where(pad, n, torch.arange(n, device=idx.device))
        ref_v, ref_s = self.scatter.apply_rows_torch(
            pre[0].clone(), {k: p.clone() for k, p in zip(sorted(state), pre[1:])},
            cids, grads, optimizer)
        want = [ref_v] + [ref_s[k] for k in sorted(state)]
        got = [torch.cat([p.index_select(0, idx), p[trash:]]) for p in planes]
        diff = torch.stack([(g - w).abs().max() for g, w in zip(got, want)]).max()
        over = torch.stack([((g - w).abs() - 1e-6 - 1e-5 * w.abs()).max()
                            for g, w in zip(got, want)]).max()
        moved = torch.stack([(g[n] != b[n]).any() for g, b in zip(got, pre)]).any()
        self.records.append((n, pad.sum(), diff, over, moved))
        return value, state

    def result(self, errs, expect):
        """Check ``expect`` applies were held and all agreed; fold the
        largest error into ``errs["apply"]``."""
        self.torch.cuda.synchronize()
        check(len(self.records) == expect,
              f"the apply check saw {len(self.records)} tables, expected {expect}")
        err = max(float(r[2]) for r in self.records)
        check(all(float(r[3]) <= 0 for r in self.records),
              f"ps_apply on the path vs its plain version: max err {err}")
        check(not any(bool(r[4]) for r in self.records), "ps_apply on the path wrote the trash row")
        errs["apply"] = max(errs["apply"], err)
        return {"applies": len(self.records), "ids": [r[0] for r in self.records],
                "pads": [int(r[1]) for r in self.records], "max_abs_err": err,
                "rtol": 1e-5, "atol": 1e-6, "trash_row_unchanged": True}


def serve_gather_check(torch, scatter, dev, table, errs):
    """``ps_gather`` against its plain version at the serving shape: a
    bucket of 256 ids (seeded rows of the shard, the rest trash-row pads),
    the value and ``sum_sq`` planes of one 2^27 + 1 row shard, dim 16; then
    its device time beside the byte bound, the plain version and two
    ``index_select``s."""
    rows = table.rows
    rng = np.random.default_rng(17)
    n_real = 150
    ids_np = np.full(SERVE_BUCKET, rows, dtype=np.int32)
    ids_np[:n_real] = np.sort(rng.choice(rows, size=n_real, replace=False))
    ids = torch.tensor(ids_np, device=dev)
    planes = [table.value, *table.state.values()]
    got = scatter.cuda_gather_planes(planes, ids)
    want = [scatter.gather_rows_torch(p, ids) for p in planes]
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(err == 0.0, f"ps_gather at the serving shape: kernel vs plain {err}")
    check(all(float(g[n_real:].abs().max()) == 0.0 for g in got[:1]),
          "serving gather: pads must read the trash row's zeros")
    errs["gather"] = max(errs["gather"], err)
    idx64 = ids.long()
    u = n_real + 1  # rows touched: the real ids and the trash row once
    nbytes = 4 * SERVE_BUCKET + len(planes) * (u + SERVE_BUCKET) * SERVE_DIM * 4
    return {
        "n": SERVE_BUCKET, "real_ids": n_real, "planes": len(planes), "dim": SERVE_DIM,
        "table_rows": rows + 1, "max_abs_err": err,
        "ms": _graph_ms(torch, lambda: scatter.cuda_gather_planes(planes, ids)),
        "plain_ms": _graph_ms(torch, lambda: [scatter.gather_rows_torch(p, ids)
                                              for p in planes]),
        "library_ms": _graph_ms(torch, lambda: [torch.index_select(p, 0, idx64)
                                                for p in planes]),
        "library": "index_select x2", "bytes": nbytes,
        "bound_ms": nbytes / HBM_BYTES_PER_S * 1e3,
    }


def _p50_us(samples):
    return float(np.median(samples)) * 1e6


def ro_request_us(torch, srv, keys, reps=SERVE_LAT_ITERS):
    """One read-only request's server time: ``handle_request`` of a
    ``__ro__`` PULL of ``keys`` (global ids of this shard) called on this
    thread with no van, each call followed by a stream synchronisation;
    the host-clock p50 in us."""
    from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind

    msg = Message(task=Task(TaskKind.PULL, "kv", payload={"table": "w", "__ro__": True}),
                  sender="W0", recver=srv.post.node_id, keys=keys.astype(np.int32))
    stream = torch.cuda.current_stream(srv.device)
    samples = []
    for i in range(reps + 20):
        t0 = time.perf_counter()
        srv.handle_request(msg)
        stream.synchronize()
        if i >= 20:
            samples.append(time.perf_counter() - t0)
    return {"ids": int(keys.size), "handle_request_p50_us": _p50_us(samples)}


def _load_leg(gen, adm, servers, scatter, seconds):
    """One open-loop run through ``adm``: the report, the servers' read-only
    pulls and ``ro_pull.w`` digest of this run, and its gather launches."""
    from parameter_server_tpu_torch.utils.trace import LatencyHistogram

    gen.pull_fn = adm.pull
    for srv in servers:  # this run's server-side digest only
        srv.ro_hist["w"] = LatencyHistogram()
    ro0 = sum(s.ro_pulls for s in servers)
    g0 = scatter.launch_counts()["gather"]
    rep = gen.run(seconds)
    ro = sum(s.ro_pulls for s in servers) - ro0
    launches = scatter.launch_counts()["gather"] - g0
    merged = LatencyHistogram()
    for srv in servers:
        merged.merge(srv.ro_hist["w"])
    return rep, ro, launches, {"count": merged.count, "p50_ms": 1e3 * merged.percentile(0.5),
                               "p99_ms": 1e3 * merged.percentile(0.99),
                               "max_ms": 1e3 * merged.max_s}


def serve_phase(torch, scatter, dev, errs):
    """The serving plane over config #3's table: 2 KVServers holding 2^28 x 16
    AdaGrad (2^27 + 1 rows a shard, value + ``sum_sq``, 32 GiB on the card)
    and one serving KVWorker with ``HotRowCache(65536)`` and
    ``ServeConfig()``.  Warm (each shard's apply held to its plain
    version), bitwise, the cache's contract, latency, open-loop load at 200
    and 2,000 q/s through ``AdmissionController``, the overload drill; the
    gather kernel at the serving shape.  Returns (fields, launches of the
    path)."""
    from parameter_server_tpu_torch.config import ServeConfig
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.cache import HotRowCache
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker
    from parameter_server_tpu_torch.serve.admission import AdmissionController
    from parameter_server_tpu_torch.serve.loadgen import LoadGenerator

    num_keys = 1 << SERVE_ROWS_LOG2
    cfgs = _serve_tables(num_keys)
    serve_cfg = ServeConfig()
    van = LoopbackVan()
    servers = [KVServer(Postoffice(f"S{s}", van), cfgs, s, 2, device=dev) for s in range(2)]
    cache = HotRowCache(serve_cfg.cache_rows, node="W0")
    worker = KVWorker(Postoffice("W0", van), cfgs, 2, cache=cache, device=dev)
    out = {"rows": num_keys, "dim": SERVE_DIM, "servers": 2,
           "shard_rows": [s.tables["w"].rows + 1 for s in servers],
           "cache_rows": cache.capacity_rows, "serve_config": dict(vars(serve_cfg))}
    try:
        nbytes = _table_bytes(servers)
        check(all(p.device.type == dev.type for s in servers for t in s.tables.values()
                  for p in (t.value, *t.state.values())), "serve tables off the card")
        check(nbytes == 2 * 2 * ((1 << (SERVE_ROWS_LOG2 - 1)) + 1) * SERVE_DIM * 4,
              f"serve tables hold {nbytes} bytes")
        out.update(table_bytes=nbytes, table_gib=nbytes / 2**30)
        gens, build_s = {}, {}
        t0 = time.perf_counter()
        gens[SERVE_RATES[0]] = LoadGenerator(
            None, table="w", num_keys=num_keys, keys_per_pull=SERVE_KEYS_PER_PULL,
            clients=SERVE_CLIENTS, per_client_qps=SERVE_RATES[0], zipf_s=SERVE_ZIPF_S,
            seed=SERVE_SEED, cache=cache)
        build_s[SERVE_RATES[0]] = time.perf_counter() - t0
        emit("serve_build", rate_qps=gens[SERVE_RATES[0]].qps,
             seconds=build_s[SERVE_RATES[0]], num_keys=num_keys)

        torch.cuda.synchronize()
        scatter.reset_launch_counts()
        # 1. warm: the generator's hottest ranks, seeded dim-16 gradients;
        # each shard's apply held to its plain version on the same inputs
        warm_keys = gens[SERVE_RATES[0]]._rank_to_key[:SERVE_WARM_KEYS].copy()
        rng = np.random.default_rng(SERVE_SEED)
        grads = rng.normal(size=(warm_keys.size, SERVE_DIM)).astype(np.float32)
        with ApplyTap(torch, scatter) as tap:
            worker.push_sync("w", warm_keys, grads, timeout=120)
        out["apply_check"] = tap.result(errs, len(servers))
        # 2. bitwise: read-only pull == training pull == the planes' rows
        ro = worker.pull_result(worker.pull("w", warm_keys, read_only=True), timeout=120)
        normal = worker.pull_sync("w", warm_keys, timeout=120)
        slots = worker.localizers["w"].assign(warm_keys.astype(np.uint64)).astype(np.int64)
        ref = _rows_by_plane(torch, servers, slots)
        check(np.array_equal(ro, normal), "read-only pull differs from pull_sync")
        check(np.array_equal(normal, ref), "pull_sync differs from the planes' rows")
        check(bool((np.abs(ref).sum(axis=1) > 0).all()), "a warm row is still zero")
        out["bitwise"] = {"keys": int(warm_keys.size), "ro_equals_pull": True,
                          "pull_equals_planes": True}
        # 3. the cache's contract on keys with distinct cache lines
        ck = _unique_lines(warm_keys, slots, cache.capacity_rows, SERVE_CONTRACT_KEYS)
        c0, g0 = cache.counters(), scatter.launch_counts()["gather"]
        cold = worker.pull_serve("w", ck, timeout=120)
        c1, g1 = cache.counters(), scatter.launch_counts()["gather"]
        check(np.array_equal(cold, worker.pull_sync("w", ck, timeout=120)),
              "cold pull_serve differs from pull_sync")
        g2 = scatter.launch_counts()["gather"]
        warm = worker.pull_serve("w", ck, timeout=120)
        c2, g3 = cache.counters(), scatter.launch_counts()["gather"]
        check(np.array_equal(warm, cold), "warm pull_serve differs from the cold one")
        check(c1["cache_misses"] - c0["cache_misses"] == ck.size
              and c1["cache_hits"] == c0["cache_hits"], f"cold serve counters {c0} -> {c1}")
        check(c2["cache_hits"] - c1["cache_hits"] == ck.size
              and c2["cache_misses"] == c1["cache_misses"], f"warm serve counters {c1} -> {c2}")
        check(g3 == g2, f"a fully cached pull_serve launched {g3 - g2} gathers")
        wk = ck[:SERVE_WRITE_KEYS]
        worker.push_sync("w", wk, np.ones((wk.size, SERVE_DIM), np.float32), timeout=120)
        after = worker.pull_serve("w", ck, timeout=120)
        c3 = cache.counters()
        check(np.array_equal(after, worker.pull_sync("w", ck, timeout=120)),
              "pull_serve after the write differs from pull_sync")
        check(bool((after[:wk.size] != cold[:wk.size]).any(axis=1).all()),
              "pull_serve after the write returned an old row of a written key")
        check(np.array_equal(after[wk.size:], cold[wk.size:]), "an unwritten row changed")
        check(c3["cache_invalidations"] > c2["cache_invalidations"],
              "the write's watermark invalidated nothing")
        out["contract"] = {"keys": int(ck.size), "written": int(wk.size),
                           "cold": c1, "warm": c2, "after_write": c3,
                           "cold_gathers": g1 - g0, "warm_gathers": g3 - g2}
        # 4. latency: a fully cached pull_serve against an uncached pull_sync
        hot = ck[:SERVE_HOT_KEYS].copy()
        for _ in range(20):
            worker.pull_serve("w", hot)
            worker.pull_sync("w", hot, timeout=60)
        hit_s, rpc_s = [], []
        h0 = cache.hits
        for _ in range(SERVE_LAT_ITERS):
            t0 = time.perf_counter()
            worker.pull_serve("w", hot)
            hit_s.append(time.perf_counter() - t0)
        check(cache.hits - h0 == SERVE_LAT_ITERS * hot.size, "the cached leg missed")
        for _ in range(SERVE_LAT_ITERS):
            t0 = time.perf_counter()
            worker.pull_sync("w", hot, timeout=60)
            rpc_s.append(time.perf_counter() - t0)
        hit_us, rpc_us = _p50_us(hit_s), _p50_us(rpc_s)
        out["latency"] = {"hot_keys": int(hot.size), "iters": SERVE_LAT_ITERS,
                          "cached_p50_us": hit_us, "rpc_p50_us": rpc_us,
                          "ratio": rpc_us / hit_us, "jax_bench_floor": 10.0}
        emit("serve_latency", **out["latency"])
        # 5. open-loop Zipfian load through admission control (healthy)
        adm = AdmissionController(worker, healthy=lambda: True, cfg=serve_cfg, node="W0")
        legs = []
        for rate in SERVE_RATES:
            if rate not in gens:
                gens.clear()  # one generator's 4 GiB of tables at a time
                t0 = time.perf_counter()
                gens[rate] = LoadGenerator(
                    None, table="w", num_keys=num_keys, keys_per_pull=SERVE_KEYS_PER_PULL,
                    clients=SERVE_CLIENTS, per_client_qps=rate, zipf_s=SERVE_ZIPF_S,
                    seed=SERVE_SEED, cache=cache)
                build_s[rate] = time.perf_counter() - t0
                emit("serve_build", rate_qps=gens[rate].qps, seconds=build_s[rate],
                     num_keys=num_keys)
            rep, ro_n, launches, ro_digest = _load_leg(gens[rate], adm, servers, scatter,
                                                       SERVE_RUN_S)
            check(rep.shed == 0 and rep.served == rep.pulls > 0,
                  f"healthy load at {rep.offered_qps} q/s: {rep}")
            check(launches == ro_n > 0, f"{launches} gathers for {ro_n} read-only pulls")
            check(ro_digest["count"] == ro_n, f"ro_pull.w holds {ro_digest['count']}")
            leg = {**rep.to_dict(), "achieved_qps": rep.pulls / rep.duration_s,
                   "served_over_pulls": rep.served / rep.pulls,
                   "ro_pulls": ro_n, "gather_launches": launches, "ro_pull_digest": ro_digest,
                   "generator_build_s": build_s[rate]}
            legs.append(leg)
            emit("serve_load", **leg)
        out["load"] = legs
        # 6. overload drill: every read sheds, none reaches a server
        down = AdmissionController(worker, healthy=lambda: False, cfg=serve_cfg, node="W0")
        rep, ro_n, launches, _ = _load_leg(gens[SERVE_RATES[-1]], down, servers, scatter,
                                           SERVE_DRILL_S)
        check(rep.shed == rep.pulls > 0 and rep.served == 0, f"overload drill {rep}")
        check(ro_n == 0 and launches == 0, f"the drill reached the servers: {ro_n}, {launches}")
        out["drill"] = {**rep.to_dict(), "ro_pulls": ro_n, "gather_launches": launches,
                        "policy": down.cfg.policy, "serve_shed": down.serve_shed}
        gens.clear()
        counts = scatter.launch_counts()
        pulls = sum(s.pulls + s.ro_pulls for s in servers)
        pushes = sum(s.pushes for s in servers)
        check(counts["gather"] == pulls and counts["apply"] == pushes
              and counts["scatter_set"] == counts["scatter_add"] == 0,
              f"serve launches {counts} for {pulls} pulls and {pushes} pushes")
        out.update(launches=counts, pulls_handled=pulls, pushes_applied=pushes,
                   worker=worker.counters())
        # one read-only request's server time, without the van: 8 keys of S0
        s0_slots = slots[slots < servers[0].tables["w"].rows]
        out["ro_request"] = ro_request_us(
            torch, servers[0], np.sort(s0_slots[:SERVE_KEYS_PER_PULL]))
        emit("serve_ro_request", **out["ro_request"])
        out["gather_at_serving_shape"] = serve_gather_check(
            torch, scatter, dev, servers[0].tables["w"], errs)
    finally:
        _free_cluster(torch, van, servers)
    out["stale_shed"] = stale_shed_leg(torch, dev)
    return out, counts


def stale_shed_leg(torch, dev):
    """The gate's stale-cache shed at config #1 width (2^22 x 1, SSP bound 0,
    ``gate_deadline_s`` 0.4), as the JAX package's test runs it: worker A
    steps once, warms its cache through ``pull_serve``, and its next pull is
    parked at the gate (worker B never steps) until the deadline sheds it to
    the cache."""
    from parameter_server_tpu_torch.config import ConsistencyConfig, ConsistencyMode
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.cache import HotRowCache
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker
    from parameter_server_tpu_torch.utils.keys import HashLocalizer

    cfgs = _serve_tables(ROWS, dim=DIM, consistency=ConsistencyConfig(
        mode=ConsistencyMode.SSP, max_delay=0, gate_deadline_s=SERVE_STALE_DEADLINE_S))
    rng = np.random.default_rng(SERVE_SEED)
    pool = rng.choice(KEY_SPACE, size=2 * SERVE_STALE_KEYS, replace=False).astype(np.int64)
    slots = HashLocalizer(ROWS).assign(pool.astype(np.uint64)).astype(np.int64)
    keys = _unique_lines(pool, slots, SERVE_CACHE_ROWS, SERVE_STALE_KEYS)
    van = LoopbackVan()
    servers = [KVServer(Postoffice(f"S{s}", van), cfgs, s, 2, device=dev) for s in range(2)]
    wa = KVWorker(Postoffice("W0", van), cfgs, 2, cache=HotRowCache(SERVE_CACHE_ROWS),
                  device=dev)
    wb = KVWorker(Postoffice("W1", van), cfgs, 2, device=dev)
    try:
        wa.consist_hello(table="w")
        wb.consist_hello(table="w")
        wa.pull_sync("w", keys, timeout=60)  # step 0 for worker A
        wa.push_sync("w", keys, np.ones(keys.size, np.float32), timeout=60)
        warm = wa.pull_serve("w", keys, timeout=60)
        t0 = time.perf_counter()
        got = wa.pull_sync("w", keys, timeout=60)  # step 1: parked, then shed
        waited = time.perf_counter() - t0
        c = wa.counters()
        check(c["consist_sheds"] == 1 and c["consist_forced"] == 0,
              f"stale shed counters {c}")
        check(np.array_equal(got, warm), "the shed pull differs from the warm pull_serve")
        check(SERVE_STALE_DEADLINE_S < waited < 30, f"the shed pull took {waited} s")
        check(bool(np.abs(warm).max() > 0), "the warm rows are zero")
        return {"keys": int(keys.size), "rows": ROWS, "deadline_s": SERVE_STALE_DEADLINE_S,
                "waited_s": waited, "consist_sheds": c["consist_sheds"],
                "consist_forced": c["consist_forced"], "consist_waits": c["consist_waits"],
                "rows_equal_warm_pull_serve": True}
    finally:
        _free_cluster(torch, van, servers)


def _replica_batches():
    """8 batches of 65,536 seeded keys over the replica table, with seeded
    dim-16 gradients."""
    rng = np.random.default_rng(REPLICA_SEED)
    rows = 1 << REPLICA_ROWS_LOG2
    return [(rng.integers(0, rows, size=REPLICA_KEYS).astype(np.int64),
             rng.normal(size=(REPLICA_KEYS, SERVE_DIM)).astype(np.float32))
            for _ in range(REPLICA_STEPS)]


def replica_run(torch, scatter, dev, batches, errs, *, chain=None, device_replies=False):
    """The replica phase's push sequence on 2 servers (``chain`` None) or a
    chain from ``make_replicated_servers`` (``"sync"`` or ``"async"``, whose
    S0 dies after step 4 and whose standby is promoted).  The first apply on
    every server's table is held to its plain version (:class:`ApplyTap`).
    Returns the touched rows read back, each push's seconds, and the fields
    of the run."""
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv import replica as replica_lib
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker

    cfgs = _serve_tables(1 << REPLICA_ROWS_LOG2)
    van = LoopbackVan()
    if chain is None:
        servers = [KVServer(Postoffice(f"S{s}", van), cfgs, s, 2, device=dev)
                   for s in range(2)]
        primaries, standbys = servers, []
    else:
        primaries, standbys = replica_lib.make_replicated_servers(
            van, cfgs, 2, sync=chain == "sync", max_lag=REPLICA_MAX_LAG,
            device_replies=device_replies, device=dev)
        servers = primaries + standbys
    worker = KVWorker(Postoffice("W0", van), cfgs, 2, device=dev)
    fields = {"chain": chain or "none", "table_bytes": _table_bytes(servers)}
    try:
        push_s = []
        with ApplyTap(torch, scatter) as tap:
            for i, (keys, grads) in enumerate(batches):
                t0 = time.perf_counter()
                worker.push_sync("w", keys, grads, timeout=120)
                push_s.append(time.perf_counter() - t0)
                if chain is not None and i == REPLICA_KILL_AFTER - 1:
                    if chain == "async":
                        primaries[0].flush_replica()  # the lag window clear at the kill
                    van.unbind("S0")  # the primary dies
                    replica_lib.promote(van, standbys[0], "S0")
            touched = np.unique(np.concatenate([k for k, _ in batches]))
            rows = worker.pull_sync("w", touched, timeout=120)
        fields["apply_check"] = tap.result(errs, len(servers))
        if device_replies:
            seen = []
            tap = worker._on_response

            def spy(msg):  # on the card: every reply value's .is_cuda
                seen.extend(isinstance(v, torch.Tensor) and v.device.type == dev.type
                            for v in msg.values)
                tap(msg)

            worker._on_response = spy
            on_card = worker.pull_result_device(worker.pull("w", touched), timeout=120)
            worker._on_response = tap
            check(on_card.device.type == dev.type and len(seen) == 2 and all(seen),
                  f"device replies: {seen}, result on {on_card.device}")
            check(np.array_equal(on_card.cpu().numpy(), rows),
                  "pull_result_device differs from pull_result")
            fields["device_replies"] = {"reply_values_on_card": len(seen),
                                        "result_device": str(on_card.device),
                                        "equals_pull_result": True}
        fields.update(
            pushes=[s.pushes for s in servers], pulls=[s.pulls for s in servers],
            push_s=push_s, push_p50_ms=1e3 * float(np.median(push_s)),
            touched_rows=int(touched.size))
        return rows, fields
    finally:
        _free_cluster(torch, van, servers)


def replica_phase(torch, scatter, dev, errs):
    """The replica chain at half of ``serve``'s depth (2^27 x 16 AdaGrad):
    the control run on 2 servers (16 GiB), a sync chain and an async chain
    (max lag 4, ``device_replies``) of 2 primaries and 2 standbys (32 GiB
    each), S0 killed after step 4 and its standby promoted; the rows at the
    end bitwise equal to the control's; each run's first apply on every
    server held to its plain version.  Returns (fields, launches)."""
    batches = _replica_batches()
    torch.cuda.synchronize()
    scatter.reset_launch_counts()
    control, cf = replica_run(torch, scatter, dev, batches, errs)
    sync_rows, sf = replica_run(torch, scatter, dev, batches, errs, chain="sync")
    async_rows, af = replica_run(torch, scatter, dev, batches, errs, chain="async",
                                 device_replies=True)
    counts = scatter.launch_counts()
    check(bool(np.abs(control).max() > 0), "the control rows are zero")
    check(np.array_equal(sync_rows, control), "the sync chain's rows differ from the control")
    check(np.array_equal(async_rows, control), "the async chain's rows differ from the control")
    pushes = sum(sum(f["pushes"]) for f in (cf, sf, af))
    pulls = sum(sum(f["pulls"]) for f in (cf, sf, af))
    # control: 8 pushes a server; a chain: 4 on each primary and its standby
    # before the kill, then S0's 4 on the promoted standby and S1's 4 applied
    # on S1 and forwarded to R1
    check(cf["pushes"] == [8, 8] and sf["pushes"] == af["pushes"] == [4, 8, 8, 8],
          f"replica pushes {cf['pushes']} {sf['pushes']} {af['pushes']}")
    check(counts["apply"] == pushes and counts["gather"] == pulls
          and counts["scatter_set"] == counts["scatter_add"] == 0,
          f"replica launches {counts} for {pushes} pushes and {pulls} pulls")
    return {"rows": 1 << REPLICA_ROWS_LOG2, "dim": SERVE_DIM, "steps": REPLICA_STEPS,
            "keys_per_step": REPLICA_KEYS, "kill_after": REPLICA_KILL_AFTER,
            "control": cf, "sync_chain": sf, "async_chain": af,
            "sync_equals_control": True, "async_equals_control": True,
            "push_p50_ms": {"no_replica": cf["push_p50_ms"], "sync_chain": sf["push_p50_ms"],
                            "async_chain": af["push_p50_ms"]},
            "launches": counts}, counts


# ---------------------------------------------------------------------------
# phase 8e: the durability plane
# ---------------------------------------------------------------------------


class PlanesTap:
    """Holds ``ps_gather`` and ``ps_scatter_set`` to their plain versions on
    the path's own inputs, every launch while installed.

    ``scatter.cuda_gather_planes`` and ``cuda_scatter_set_planes`` are
    wrapped: each launch runs as the path asked, then its result is compared
    on the launching stream with ``index_select`` of the same planes at the
    same ids (exact: both move rows).  The errors stay on the card until
    :meth:`result`."""

    def __init__(self, torch, scatter):
        self.torch, self.scatter = torch, scatter
        self.records = {"gather": [], "scatter_set": []}

    def __enter__(self):
        self.orig = (self.scatter.cuda_gather_planes, self.scatter.cuda_scatter_set_planes)
        self.scatter.cuda_gather_planes = self._gather
        self.scatter.cuda_scatter_set_planes = self._scatter_set
        return self

    def __exit__(self, *exc):
        self.scatter.cuda_gather_planes, self.scatter.cuda_scatter_set_planes = self.orig

    def _err(self, got, tables, ids):
        idx = ids.long()
        return self.torch.stack([(g - t.index_select(0, idx)).abs().max()
                                 if g.numel() else g.new_zeros(())
                                 for g, t in zip(got, tables)]).max()

    def _gather(self, tables, ids):
        outs = self.orig[0](tables, ids)
        self.records["gather"].append((int(ids.shape[0]), len(tables),
                                       self._err(outs, tables, ids)))
        return outs

    def _scatter_set(self, tables, ids, rows):
        out = self.orig[1](tables, ids, rows)
        self.records["scatter_set"].append((int(ids.shape[0]), len(tables),
                                            self._err(rows, tables, ids)))
        return out

    def result(self, errs, name):
        self.torch.cuda.synchronize()
        recs = self.records[name]
        check(bool(recs), f"no {name} launch was held to its plain version")
        err = max(float(r[2]) for r in recs)
        check(err == 0.0, f"{name} on the durability path vs index_select: max err {err}")
        errs[name] = max(errs[name], err)
        return {"launches_held": len(recs), "ids": [r[0] for r in recs],
                "planes": [r[1] for r in recs], "max_abs_err": err, "tolerance": 0.0}


class RebuildTap:
    """Times ``KVServer._rebuild_table`` on the card (synchronised before and
    after) and reads its memory peak, per server."""

    def __init__(self, torch):
        from parameter_server_tpu_torch.kv.server import KVServer

        self.torch, self.cls, self.records = torch, KVServer, []

    def __enter__(self):
        self.orig = self.cls._rebuild_table
        tap = self

        def rebuild(srv, t, new_segs, extra):
            torch = tap.torch
            torch.cuda.synchronize()
            base = torch.cuda.memory_allocated()
            torch.cuda.reset_peak_memory_stats()
            old_rows = srv.tables[t].rows
            t0 = time.perf_counter()
            tap.orig(srv, t, new_segs, extra)
            torch.cuda.synchronize()
            tap.records.append({
                "server": srv.post.node_id, "old_rows": old_rows,
                "new_rows": srv.tables[t].rows, "ms": 1e3 * (time.perf_counter() - t0),
                "allocated_before_gib": base / 2**30,
                "peak_gib": torch.cuda.max_memory_allocated() / 2**30,
                "peak_over_before_gib": (torch.cuda.max_memory_allocated() - base) / 2**30})

        self.cls._rebuild_table = rebuild
        return self

    def __exit__(self, *exc):
        self.cls._rebuild_table = self.orig


def _durable_root():
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "parameter_server_tpu_torch", "build", "durable")


def _host_room(root, need_disk, need_ram):
    """Free disk at ``root`` and available host memory, in GiB; fails with a
    clear message when either is below what the phase writes and holds."""
    import os
    import shutil

    os.makedirs(root, exist_ok=True)
    disk = shutil.disk_usage(root).free / 2**30
    with open("/proc/meminfo") as f:
        meminfo = dict(line.split(":", 1) for line in f)
    ram = int(meminfo["MemAvailable"].split()[0]) / 2**20
    check(disk >= need_disk, f"durable: {disk:.1f} GiB free at {root}, the phase writes "
          f"up to {need_disk:.1f} GiB")
    check(ram >= need_ram, f"durable: {ram:.1f} GiB of host memory available, the phase "
          f"needs {need_ram:.1f} GiB")
    return {"disk_free_gib": disk, "ram_available_gib": ram, "disk_needed_gib": need_disk,
            "ram_needed_gib": need_ram}


def _dir_bytes(path):
    import os

    return sum(os.path.getsize(os.path.join(d, f)) for d, _, fs in os.walk(path) for f in fs)


def _zipf_keys(rng, rows, n):
    """``n`` seeded Zipf(1.1) draws over ``rows`` keys (rank - 1, folded)."""
    return ((rng.zipf(DURABLE_ZIPF, size=n) - 1) % rows).astype(np.int64)


def _durable_batch(rng, rows, keep=None, loc=None):
    """One push of ``DURABLE_KEYS`` Zipf keys and dim-16 gradients; with
    ``keep`` (a slot range), only keys whose slots fall in it."""
    if keep is None:
        keys = _zipf_keys(rng, rows, DURABLE_KEYS)
    else:
        parts, got = [], 0
        while got < DURABLE_KEYS:
            k = _zipf_keys(rng, rows, 2 * DURABLE_KEYS)
            slots = loc.assign(k.astype(np.uint64))
            k = k[(slots >= keep[0]) & (slots < keep[1])]
            parts.append(k)
            got += k.size
        keys = np.concatenate(parts)[:DURABLE_KEYS]
    return keys, rng.normal(size=(keys.size, SERVE_DIM)).astype(np.float32)


def _durable_fleet(torch, dev, van, n, rows):
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker

    cfgs = _serve_tables(rows)
    servers = [KVServer(Postoffice(f"S{s}", van), cfgs, s, n, device=dev) for s in range(n)]
    return cfgs, servers, KVWorker(Postoffice("W0", van), cfgs, n, device=dev)


def _fleets_equal(torch, a, a_routing, b, b_routing, table="w"):
    """Every row of two fleets' shards, value and state, compared on the card
    range by range (each overlap of an A segment with a B segment is one
    slice of each plane).  Returns the rows compared."""
    def pieces(servers, routing):
        out = []
        for i, (lo, hi, o) in enumerate(routing.tables[table].segments()):
            starts, _, locs = servers[o]._shard_maps[table]
            j = int(np.searchsorted(starts, lo, side="right")) - 1
            out.append((lo, hi, servers[o].tables[table], int(locs[j])))
        return out

    pa, pb = pieces(a, a_routing), pieces(b, b_routing)
    rows, bad = 0, []
    for lo_a, hi_a, ta, la in pa:
        for lo_b, hi_b, tb, lb in pb:
            x, y = max(lo_a, lo_b), min(hi_a, hi_b)
            if x >= y:
                continue
            sa, sb = la + x - lo_a, lb + x - lo_b
            n = y - x
            for name, pa_, pb_ in [("value", ta.value, tb.value),
                                   *((k, ta.state[k], tb.state[k]) for k in ta.state)]:
                if not torch.equal(pa_[sa:sa + n], pb_[sb:sb + n]):
                    bad.append((name, x, y))
            rows += n
    check(not bad, f"fleets differ in {bad[:4]}")
    return rows


def _snapshot_window(worker, pushes):
    """Push ``pushes[0]`` right after ``snap_begin`` and ``pushes[1]`` after
    the first ``snap_write`` round of the next ``save_snapshot`` (on a
    2-server fleet, the only one): writes land inside its open window,
    deterministically, as the JAX package's freeze test drives its control
    rounds.  Returns the function that removes the hook."""
    orig = worker._control_round
    todo = list(pushes)

    def hooked(msgs, what, timeout):
        out = orig(msgs, what, timeout)
        if todo and what in ("snap_begin", "snap_write"):
            worker.push_sync("w", *todo.pop(0), timeout=300)
        return out

    worker._control_round = hooked
    return lambda: setattr(worker, "_control_round", orig)


def ack_dirty_cost(torch, srv, keys, reps=50):
    """Host time of the push ack (``KVServer._ack_push``) on one request of
    ``keys`` (global rows srv owns) with no window open, with a snapshot
    window and with a migration window over all of them: the dirty tracking
    the ack pays while a window is open.  Each under
    ``set_sync_debug_mode("error")``.  Beside it, the same rows added to a
    Python set one key at a time, as the JAX server tracks them."""
    from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind

    msg = Message(task=Task(TaskKind.PUSH, "kv", payload={"table": "w"}), sender="W0",
                  recver=srv.post.node_id, keys=keys, values=[None])
    kn, segs = keys.astype(np.int64), np.zeros(1, np.int64)
    lo, hi = int(kn.min()), int(kn.max()) + 1

    def timed():
        samples = []
        torch.cuda.set_sync_debug_mode("error")
        try:
            for _ in range(reps):
                t0 = time.perf_counter()
                srv._ack_push(msg, "w", kn, segs)
                samples.append(1e3 * (time.perf_counter() - t0))
        finally:
            torch.cuda.set_sync_debug_mode(0)
        return _ms_quantiles(samples)

    out = {"keys": int(kn.size), "none": timed()}
    srv._snapshots["probe"] = {"dirty": {}}
    out["snapshot_window"] = timed()
    dirty = srv._snapshots.pop("probe")["dirty"]["w"].rows()
    check(np.array_equal(dirty, np.unique(kn)), "the snapshot window's dirty rows")
    from parameter_server_tpu_torch.kv.server import _DirtyRows

    srv._migrations["probe"] = {"table": "w", "lo": lo, "hi": hi, "dirty": _DirtyRows()}
    out["migration_window"] = timed()
    srv._migrations.pop("probe")
    samples = []
    for _ in range(reps):
        t0 = time.perf_counter()
        py_set = set()
        py_set.update(int(x) for x in kn[(kn >= lo) & (kn < hi)])
        samples.append(1e3 * (time.perf_counter() - t0))
    out["python_set_per_key"] = _ms_quantiles(samples)
    return out


def ckpt_legacy_leg(torch, dev, root):
    """Config #1's table (2^22 x 1 AdaGrad) after 8 PS-loop steps on 2
    servers: ``save_model``, then ``load_model`` onto 3 servers; every row of
    value and state bitwise equal to the writers'."""
    import os

    from parameter_server_tpu_torch.config import ConsistencyConfig
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker
    from parameter_server_tpu_torch.learner.sgd import AsyncLRLearner

    van, servers, workers = build_cluster(torch, dev, rows=ROWS, fused=True, n_workers=2)
    van2 = LoopbackVan()
    readers = []
    try:
        data = [SyntheticCTR(key_space=KEY_SPACE, nnz=NNZ, batch_size=BATCH, seed=i,
                             informative=0.1) for i in range(2)]
        AsyncLRLearner(workers, ConsistencyConfig(), device=dev).run(
            [d.next_batch for d in data], MAIN_STEPS, timeout=300)
        ckpt = os.path.join(root, "legacy")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        workers[0].save_model(ckpt, MAIN_STEPS)
        write_s = time.perf_counter() - t0
        nbytes = _dir_bytes(ckpt)
        cfgs = servers[0].table_cfgs
        readers = [KVServer(Postoffice(f"S{i}", van2), cfgs, i, 3, device=dev)
                   for i in range(3)]
        reader = KVWorker(Postoffice("W0", van2), cfgs, 3, device=dev)
        t0 = time.perf_counter()
        reader.load_model(ckpt, MAIN_STEPS)
        torch.cuda.synchronize()
        read_s = time.perf_counter() - t0
        rows = _fleets_equal(torch, servers, workers[0].routing, readers, reader.routing)
        check(rows == ROWS, f"legacy restore compared {rows} rows of {ROWS}")
        check(bool(servers[0].tables["w"].state["sum_sq"].abs().max() > 0),
              "the legacy writer's optimizer state is zero")
        return {"table_rows": ROWS, "dim": DIM, "steps": MAIN_STEPS, "writers": 2,
                "readers": 3, "write_s": write_s, "read_s": read_s, "bytes": nbytes,
                "write_gb_per_s": nbytes / write_s / 1e9, "read_gb_per_s": nbytes / read_s / 1e9,
                "rows_bitwise_equal": rows}
    finally:
        close_cluster(van, servers)
        close_cluster(van2, readers)


def migrate_chain_leg(torch, dev):
    """Config #1's table on 2 sync replica chains: 2 pushes, then a live
    migration of the upper half of S0's range (2^20 rows) to S1 with a push
    between chunks, and one push after.  The standbys follow through ``_forward_control``: R1 adopts
    the range (``migrate_adopt``, one ``ps_scatter_set`` over 2^20 ids), R0
    drops it (``migrate_release``); every plane of every standby bitwise
    equal to its primary's, all four at the new epoch."""
    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
    from parameter_server_tpu_torch.kv import replica as replica_lib
    from parameter_server_tpu_torch.kv.migrate import ShardMigrator
    from parameter_server_tpu_torch.kv.worker import KVWorker

    cfgs = {"w": TableConfig(name="w", rows=ROWS, dim=DIM,
                             optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.05))}
    van = LoopbackVan()
    primaries, standbys = replica_lib.make_replicated_servers(van, cfgs, 2, sync=True,
                                                              device=dev)
    try:
        worker = KVWorker(Postoffice("W0", van), cfgs, 2, device=dev)
        data = SyntheticCTR(key_space=KEY_SPACE, nnz=NNZ, batch_size=BATCH, seed=7,
                            informative=0.1)
        grads = np.random.default_rng(DURABLE_SEED).normal(size=(BATCH, NNZ)).astype(np.float32)

        def push():
            worker.push_sync("w", data.next_batch()[0], grads, timeout=300)

        push()
        push()
        mig = ShardMigrator(Postoffice("M1", van), chunk_rows=DURABLE_CHUNK, timeout=300)
        rpc, sent = mig._rpc, []

        def chunked(recver, payload):
            reply = rpc(recver, payload)
            if payload["op"] == "migrate_send":
                sent.append(payload["lo"])
                if len(sent) == 1:
                    push()
            return reply

        mig._rpc = chunked
        s0_lo, hi = primaries[0].routing.tables["w"].owned_segments(0)[0]
        lo = (s0_lo + hi) // 2  # the upper half of S0's range: 2^20 rows
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        routing = mig.migrate(worker.routing, "w", lo, hi, 1)
        torch.cuda.synchronize()
        mig_s = time.perf_counter() - t0
        check(worker.adopt_routing(routing), "the worker did not adopt the new routing")
        push()
        for p, sb in zip(primaries, standbys):
            pt, st = p.tables["w"], sb.tables["w"]
            check(p.routing.epoch == sb.routing.epoch == routing.epoch,
                  f"{p.post.node_id} / {sb.post.node_id} epochs")
            check(pt.rows == st.rows and torch.equal(pt.value, st.value)
                  and all(torch.equal(pt.state[k], st.state[k]) for k in pt.state),
                  f"standby {sb.post.node_id} differs from its primary after the migration")
        return {"table_rows": ROWS, "dim": DIM, "moved": [lo, hi], "chunks": len(sent),
                "seconds": mig_s, "commit_freeze_ms": 1e3 * primaries[0].migration_freeze_last_s,
                "rows_migrated_in": [s.rows_migrated_in for s in primaries + standbys],
                "shard_rows": [s.tables["w"].rows for s in primaries + standbys],
                "standbys_bitwise_equal": True}
    finally:
        close_cluster(van, primaries + standbys)


def durable_phase(torch, scatter, dev, errs):
    """The durability plane over config #3's table at 2^27 x 16 AdaGrad:
    ``ckpt_legacy``, ``snapshot``, ``migrate``, ``restart`` (see the module
    docstring).  Returns (fields, launches)."""
    import os
    import shutil

    from parameter_server_tpu_torch import checkpoint
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv import replica as replica_lib
    from parameter_server_tpu_torch.kv.migrate import ShardMigrator

    rows = 1 << DURABLE_ROWS_LOG2
    plane_gib = (rows + 2) * SERVE_DIM * 4 / 2**30
    root = _durable_root()
    shutil.rmtree(root, ignore_errors=True)
    # the snapshot files at their peak (the full and the incremental) and the
    # host copies three restoring servers hold at once
    out = {"host": _host_room(root, need_disk=3.5 * plane_gib, need_ram=4.0 * plane_gib),
           "rows": rows, "dim": SERVE_DIM, "keys_per_push": DURABLE_KEYS,
           "zipf_s": DURABLE_ZIPF}
    emit("durable_host", **out["host"])
    rng = np.random.default_rng(DURABLE_SEED)
    out["ckpt_legacy"] = ckpt_legacy_leg(torch, dev, root)
    emit("durable_ckpt_legacy", **out["ckpt_legacy"])
    torch.cuda.synchronize()
    scatter.reset_launch_counts()
    van, ctl_van = LoopbackVan(), LoopbackVan()
    servers, control, old_s1 = [], [], None
    try:
        with PlanesTap(torch, scatter) as planes, ApplyTap(torch, scatter) as applies, \
                RebuildTap(torch) as rebuilds:
            out["migrate_chain"] = migrate_chain_leg(torch, dev)
            emit("durable_migrate_chain", **out["migrate_chain"])
            cfgs, servers, worker = _durable_fleet(torch, dev, van, 2, rows)
            loc = worker.localizers["w"]
            for _ in range(DURABLE_WARM):
                worker.push_sync("w", *_durable_batch(rng, rows), timeout=300)
            # -- snapshot: full step 1 with writes in its window, 2 pushes into
            # S0's range, incremental step 2, restore onto 3 servers
            snap = os.path.join(root, "snap")
            window = [_durable_batch(rng, rows) for _ in range(2)]
            restore_hook = _snapshot_window(worker, window)
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            full = worker.save_snapshot(snap, 1)
            full_s = time.perf_counter() - t0
            restore_hook()
            full_bytes = _dir_bytes(os.path.join(snap, "snap_000001"))
            full_delta = [srv.ckpt_delta_rows for srv in servers]
            check(full["delta_rows"] > 0 and full["carried"] == 0, f"full snapshot {full}")
            s0_range = worker.routing.tables["w"].owned_segments(0)[0]
            for _ in range(2):
                worker.push_sync("w", *_durable_batch(rng, rows, keep=s0_range, loc=loc),
                                 timeout=300)
            t0 = time.perf_counter()
            inc = worker.save_snapshot(snap, 2, base_step=1)
            inc_s = time.perf_counter() - t0
            inc_bytes = _dir_bytes(os.path.join(snap, "snap_000002"))
            manifest = checkpoint.read_snapshot(snap, 2)
            ref_bytes = sum(e["bytes"] for e in manifest["segments"] + manifest["deltas"])
            carried = [e for e in manifest["segments"] if e["file"].startswith("snap_000001/")]
            check(inc["carried"] == 1 and len(carried) == 1 and carried[0]["lo"] == s0_range[1],
                  f"S1's segment must carry: {inc}, {carried}")
            ctl_cfgs, control, ctl_worker = _durable_fleet(torch, dev, ctl_van, 3, rows)
            t0 = time.perf_counter()
            ctl_worker.load_snapshot(snap, 2)
            torch.cuda.synchronize()
            restore_s = time.perf_counter() - t0
            restored = _fleets_equal(torch, servers, worker.routing, control,
                                     ctl_worker.routing)
            check(restored == rows, f"snapshot restore compared {restored} rows")
            out["snapshot"] = {
                "full": {"write_s": full_s, "bytes": full_bytes,
                         "gb_per_s": full_bytes / full_s / 1e9, "segments": full["segments"],
                         "delta_rows": full["delta_rows"],
                         "per_server_delta_rows": full_delta,
                         "per_server_freeze_ms": [1e3 * f for f in full["freeze_s"]]},
                "incremental": {"write_s": inc_s, "bytes": inc_bytes,
                                "gb_per_s": inc_bytes / inc_s / 1e9, "carried": inc["carried"],
                                "delta_rows": inc["delta_rows"],
                                "per_server_freeze_ms": [1e3 * f for f in inc["freeze_s"]]},
                "restore": {"servers": 3, "seconds": restore_s, "bytes_referenced": ref_bytes,
                            "gb_per_s": ref_bytes / restore_s / 1e9,
                            "rows_bitwise_equal": restored},
                "gather_launches": scatter.launch_counts()["gather"]}
            emit("durable_snapshot", **out["snapshot"])
            shutil.rmtree(snap, ignore_errors=True)
            # -- migrate: [lo, lo + 2^22) of S0 to S1 in 65,536-row chunks,
            # pushes between chunks; the restored 3-server fleet is the control
            lo = s0_range[1] // 2
            hi = lo + DURABLE_MIG_ROWS
            mig = ShardMigrator(Postoffice("M0", van), chunk_rows=DURABLE_CHUNK, timeout=300)
            between = [_durable_batch(rng, rows) for _ in range(2)]
            chunks = -(-DURABLE_MIG_ROWS // DURABLE_CHUNK)
            at = {chunks // 4: between[0], (3 * chunks) // 4: between[1]}
            rpc, sent = mig._rpc, []

            def chunked(recver, payload):
                reply = rpc(recver, payload)
                if payload["op"] == "migrate_send":
                    sent.append(payload["lo"])
                    if len(sent) in at:
                        worker.push_sync("w", *at[len(sent)], timeout=300)
                return reply

            mig._rpc = chunked
            n_rebuilds, before = len(rebuilds.records), scatter.launch_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            routing = mig.migrate(worker.routing, "w", lo, hi, 1)
            torch.cuda.synchronize()
            mig_s = time.perf_counter() - t0
            check(worker.adopt_routing(routing), "the worker did not adopt the new routing")
            after = scatter.launch_counts()
            for batch in between:
                ctl_worker.push_sync("w", *batch, timeout=300)
            check(routing.tables["w"].owned_segments(1)[0] == (lo, hi),
                  f"migrated layout {routing.tables['w']}")
            same = _fleets_equal(torch, servers, routing, control, ctl_worker.routing)
            # the commit's delta: the donor's one gather, the recipient's one
            # scatter-set, over the same rows
            launched = {k: after[k] - before[k] for k in after}
            check(launched["gather"] == 1 and launched["scatter_set"] == 1,
                  f"migration launches {launched}")
            delta_rows = planes.records["scatter_set"][-1][0]
            check(delta_rows > 0 and planes.records["gather"][-1][0] == delta_rows,
                  "no push landed in the moving range between chunks")
            layout_refused = False
            try:
                servers[0].save_checkpoint(os.path.join(root, "refused"), 1)
            except checkpoint.CheckpointLayoutError:
                layout_refused = True
            check(layout_refused, "save_checkpoint on a migrated layout did not refuse")
            out["migrate"] = {
                "lo": lo, "hi": hi, "rows": DURABLE_MIG_ROWS, "chunk_rows": DURABLE_CHUNK,
                "chunks": len(sent), "seconds": mig_s, "rows_per_s": DURABLE_MIG_ROWS / mig_s,
                "commit_freeze_ms": 1e3 * servers[0].migration_freeze_last_s,
                "delta_rows": delta_rows, "epoch": routing.epoch,
                "rebuilds": rebuilds.records[n_rebuilds:], "launches": launched,
                "rows_bitwise_equal_to_control": same,
                "save_checkpoint_refused": "CheckpointLayoutError"}
            emit("durable_migrate", **out["migrate"])
            close_cluster(ctl_van, control)
            control = []
            torch.cuda.empty_cache()
            # -- restart: snapshot step 3 of the migrated fleet, S1 killed and
            # brought back under its own id from it
            snap3 = os.path.join(root, "snap3")
            t0 = time.perf_counter()
            s3 = worker.save_snapshot(snap3, 3)
            s3_s = time.perf_counter() - t0
            s3_bytes = _dir_bytes(snap3)
            old_s1 = servers[1]
            old_s1.ledger.close()
            van.unbind("S1")
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            new_s1, source = replica_lib.restart_same_id(van, cfgs, 1, 2, ckpt_root=snap3,
                                                         device=dev)
            torch.cuda.synchronize()
            recover_s = time.perf_counter() - t0
            servers[1] = new_s1
            check(source == "partitioned" and new_s1.routing.epoch == routing.epoch > 0,
                  f"restart from {source} at epoch {new_s1.routing.epoch}")
            check(new_s1.routing.tables["w"].owned_segments(1)
                  == old_s1.routing.tables["w"].owned_segments(1), "restarted layout")
            old_t, new_t = old_s1.tables["w"], new_s1.tables["w"]
            check(torch.equal(old_t.value, new_t.value)
                  and all(torch.equal(old_t.state[k], new_t.state[k]) for k in old_t.state),
                  "the restarted S1 differs from S1 before the kill")
            old_s1.tables.clear()
            old_s1 = None
            worker.push_sync("w", *_durable_batch(rng, rows), timeout=300)  # serving again
            own = servers[0].routing.tables["w"].owned_segments(0)[0]
            slots = np.unique(loc.assign(_zipf_keys(rng, rows, 8 * DURABLE_KEYS)
                                         .astype(np.uint64)).astype(np.int64))
            slots = slots[(slots >= own[0]) & (slots < own[1])][:DURABLE_KEYS]
            out["ack_dirty_cost_ms"] = ack_dirty_cost(torch, servers[0], slots)
            emit("durable_ack_cost", **out["ack_dirty_cost_ms"])
            out["restart"] = {"snapshot_write_s": s3_s, "snapshot_bytes": s3_bytes,
                              "snapshot_gb_per_s": s3_bytes / s3_s / 1e9,
                              "segments": s3["segments"], "source": source,
                              "epoch": new_s1.routing.epoch, "recover_s": recover_s,
                              "rows": new_t.rows, "bitwise_equal": True}
            emit("durable_restart", **out["restart"])
            counts = scatter.launch_counts()
            out["gather_check"] = planes.result(errs, "gather")
            out["scatter_set_check"] = planes.result(errs, "scatter_set")
            check(len(applies.records) >= 2, f"{len(applies.records)} applies held")
            out["apply_check"] = applies.result(errs, len(applies.records))
    finally:
        close_cluster(van, servers)
        close_cluster(ctl_van, control)
        servers.clear()
        shutil.rmtree(root, ignore_errors=True)
        import gc

        gc.collect()
        torch.cuda.empty_cache()
        empty_host = getattr(torch._C, "_host_emptyCache", None)
        if empty_host is not None:
            empty_host()
    check(counts["gather"] > 0 and counts["scatter_set"] > 0 and counts["apply"] > 0,
          f"durable launches {counts}")
    out["launches"] = counts
    return out, counts


# ---------------------------------------------------------------------------
# phase 8f: the membership and elasticity plane
# ---------------------------------------------------------------------------


def _elastic_shards(n, seed):
    """``n`` workloads of ``ELASTIC_BATCHES`` config #1 batches each."""
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR

    data = SyntheticCTR(key_space=KEY_SPACE, nnz=NNZ, batch_size=BATCH, seed=seed,
                        informative=0.1)
    return [[data.next_batch() for _ in range(ELASTIC_BATCHES)] for _ in range(n)]


def _tables_on(servers):
    """The devices every plane of every server's tables lives on."""
    return sorted({str(t.device) for srv in servers for tbl in srv.tables.values()
                   for t in [tbl.value, *tbl.state.values()]})


class _Cluster:
    """``launch_local_cluster`` on a LoopbackVan (scheduler, ``n_servers``
    servers, ``n_workers`` workers, each with its Manager), config #1's
    table, and every ``on_node_dead`` call the scheduler makes, timed."""

    def __init__(self, torch, dev, *, n_workers, n_servers=2, chain=False):
        from parameter_server_tpu_torch.core.manager import launch_local_cluster
        from parameter_server_tpu_torch.core.van import LoopbackVan
        from parameter_server_tpu_torch.kv import replica as replica_lib
        from parameter_server_tpu_torch.kv.server import KVServer
        from parameter_server_tpu_torch.kv.worker import KVWorker

        self.torch, self.van, self.cfgs = torch, LoopbackVan(), _config1_tables()
        self.sched, self.managers, self.posts = launch_local_cluster(
            self.van, num_workers=n_workers, num_servers=n_servers, key_space=ROWS,
            heartbeat_timeout=ELASTIC_HB_TIMEOUT_S)
        self.deaths = []
        self.sched.on_node_dead.append(lambda nid: self.deaths.append((nid, time.monotonic())))
        self.standbys = []
        if chain:
            self.servers, self.standbys = replica_lib.make_replicated_servers(
                self.van, self.cfgs, n_servers, sync=True, device=dev, posts=self.posts)
        else:
            self.servers = [KVServer(self.posts[f"S{s}"], self.cfgs, s, n_servers, device=dev)
                            for s in range(n_servers)]
        self.workers = {f"W{i}": KVWorker(self.posts[f"W{i}"], self.cfgs, n_servers,
                                          device=dev) for i in range(n_workers)}
        check(_tables_on(self.servers + self.standbys) == [str(torch.empty(0, device=dev).device)],
              f"elastic: server tables on {_tables_on(self.servers + self.standbys)}")

    def trainer(self, shards, dev, timeout=300.0, **kw):
        from parameter_server_tpu_torch.config import ConsistencyConfig, ConsistencyMode
        from parameter_server_tpu_torch.learner.elastic import ElasticTrainer

        return ElasticTrainer(self.workers, self.sched, shards,
                              ConsistencyConfig(mode=ConsistencyMode.ASP), managers=self.managers,
                              heartbeat_interval=ELASTIC_HB_INTERVAL_S, timeout=timeout,
                              device=dev, **kw)

    def dead(self):
        return [nid for nid, _ in self.deaths]

    def close(self):
        _free_cluster(self.torch, self.van,
                      [s for s in self.servers + self.standbys if s is not None])


def _on_done(trainer, fn):
    """Call ``fn(num_done)`` on the finishing worker's thread after each
    workload that counted: between two workloads, so a 1-worker run is
    deterministic around the event."""
    finish = trainer.pool.finish

    def hooked(worker, workload_id):
        ok = finish(worker, workload_id)
        if ok:
            fn(trainer.pool.num_done())
        return ok

    trainer.pool.finish = hooked


def _wait_for(predicate, seconds, what):
    deadline = time.monotonic() + seconds
    while not predicate():
        check(time.monotonic() < deadline, f"elastic: {what} within {seconds} s")
        time.sleep(0.01)


def _timed_run(torch, trainer):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    losses = trainer.run()
    torch.cuda.synchronize()
    return losses, time.perf_counter() - t0


def elastic_worker_death(torch, scatter, dev, shards):
    """3 workers draw the workloads under ASP; W2 is killed (its thread stops,
    its endpoint disconnected) once 2 are done.  Every workload completes,
    W2 alone is reported dead; the time from the kill to detection, and
    examples/s until the last workload is done (the run itself also waits
    out the victim's request that was in flight at the kill: the trainer's
    timeout)."""
    import threading

    cl = _Cluster(torch, dev, n_workers=3)
    try:
        trainer = cl.trainer(shards, dev, timeout=ELASTIC_DEATH_TIMEOUT_S)
        drained = []
        _on_done(trainer, lambda n: n == len(shards) and drained.append(time.perf_counter()))
        before = scatter.launch_counts()
        out = {}
        t_start = time.perf_counter()
        runner = threading.Thread(target=lambda: out.update(zip(("losses", "wall"),
                                                               _timed_run(torch, trainer))))
        runner.start()
        _wait_for(lambda: trainer.pool.num_done() >= ELASTIC_KILL_AFTER or not runner.is_alive(),
                  300, "2 workloads done")
        kill_t = time.monotonic()
        trainer.kill("W2")
        cl.van.disconnect("W2")
        runner.join(600)
        check("losses" in out, "elastic worker_death: the run raised or hung")
        check(trainer.pool.all_done(), f"{trainer.pool.num_done()}/{len(trainer.pool)} done")
        after = scatter.launch_counts()
        # detection is asynchronous to completion: the survivors keep beating
        # (the trainer's heartbeat thread ended with its run) while it sweeps
        while "W2" not in cl.dead():
            check(time.monotonic() - kill_t < 60, "W2 never detected dead")
            for nid, mgr in cl.managers.items():
                if nid not in ("H", "W2"):
                    mgr.send_heartbeat()
            cl.sched.check_heartbeats()
            time.sleep(ELASTIC_HB_INTERVAL_S)
        check(cl.dead() == ["W2"], f"elastic worker_death: dead {cl.dead()}, only W2 died")
        check(len(drained) == 1, "the last workload's completion was not seen")
        drain_s = drained[0] - t_start
        by = {}
        for w in trainer.pool._workloads.values():
            by[w.completed_by] = by.get(w.completed_by, 0) + 1
        launched = {k: after[k] - before[k] for k in after}
        check(launched["gather"] > 0 and launched["apply"] > 0, f"launches {launched}")
        return {"workers": 3, "workloads": len(shards), "batches_per_workload": ELASTIC_BATCHES,
                "kill_after_workloads": ELASTIC_KILL_AFTER, "all_done": True,
                "dead": cl.dead(), "kill_to_detect_s": cl.deaths[0][1] - kill_t,
                "heartbeat_timeout_s": ELASTIC_HB_TIMEOUT_S,
                "heartbeat_interval_s": ELASTIC_HB_INTERVAL_S,
                "steps_trained": len(out["losses"]), "drain_s": drain_s,
                "examples_per_s": len(out["losses"]) * BATCH / drain_s,
                "run_s": out["wall"], "trainer_timeout_s": ELASTIC_DEATH_TIMEOUT_S,
                "completed_by": by, "launches": launched, "tables_on": _tables_on(cl.servers)}
    finally:
        cl.close()


def elastic_server_death(torch, scatter, dev, shards, root):
    """2 workers with a checkpoint every 2 workloads (``CheckpointConfig()``,
    auto); S1 is disconnected, a pull raises; ``recover_server`` rebuilds it
    on the card from the latest checkpoint: its rows bitwise the
    checkpoint's, and a push moves them."""
    import gc
    import os

    from parameter_server_tpu_torch import checkpoint
    from parameter_server_tpu_torch.config import CheckpointConfig
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.learner.elastic import recover_server

    cl = _Cluster(torch, dev, n_workers=2)
    try:
        trainer = cl.trainer(shards, dev, ckpt_root=root, ckpt_every=2,
                             ckpt_config=CheckpointConfig())
        losses, wall = _timed_run(torch, trainer)
        step = checkpoint.latest_step(root)
        plane = "partitioned" if checkpoint.latest_snapshot(root) is not None else "legacy"
        check(step is not None and step == trainer.last_ckpt_step and plane == "legacy",
              f"checkpoint plane {plane} at step {step} ({trainer.last_ckpt_step})")
        w0 = cl.workers["W0"]
        keys = shards[0][0][0]
        cl.van.disconnect("S1")
        raised = False
        try:
            w0.pull_sync("w", keys, timeout=10)
        except (RuntimeError, TimeoutError):
            raised = True
        check(raised, "a pull with S1 dead returned instead of raising")
        old = cl.servers[1]  # the dead shard's card memory goes first
        old.ledger.close()
        old.tables.clear()
        cl.servers[1] = old = None
        gc.collect()
        torch.cuda.empty_cache()
        cl.van.unbind("S1")
        cl.van.reconnect("S1")
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        new = recover_server(lambda: KVServer(Postoffice("S1", cl.van), cl.cfgs, 1, 2,
                                              device=dev), root)
        torch.cuda.synchronize()
        recover_s = time.perf_counter() - t0
        cl.servers[1] = new
        check(_tables_on([new]) == _tables_on(cl.servers[:1]), "recovered S1 is not on the card")
        lo, hi = (int(x) for x in new.partitions["w"].offsets[1:3])
        saved = checkpoint.load_global_arrays(root, step, "w")
        tbl = new.tables["w"]
        same = (np.array_equal(tbl.value[:hi - lo].cpu().numpy(), saved["value"][lo:hi])
                and all(np.array_equal(tbl.state[k][:hi - lo].cpu().numpy(), saved[f"state.{k}"][lo:hi])
                        for k in tbl.state))
        check(same, "the recovered S1 differs from the checkpoint on its range")
        slots = w0.localizers["w"].assign(keys.reshape(-1))
        probe = np.unique(keys.reshape(-1)[(slots >= lo) & (slots < hi)])[:4096]
        before = w0.pull_sync("w", probe, timeout=60)
        w0.push_sync("w", probe, np.ones((probe.size, DIM), np.float32), timeout=60)
        moved = float(np.abs(w0.pull_sync("w", probe, timeout=60) - before).max())
        check(moved > 1e-4, f"a push to the recovered S1 moved its rows by {moved}")
        step_dir = next(d for d in os.listdir(root) if d.endswith(f"{step:06d}"))
        return {"workers": 2, "workloads": len(shards), "ckpt_every": 2, "plane": plane,
                "ckpt_step": step, "ckpt_bytes": _dir_bytes(os.path.join(root, step_dir)),
                "run_s": wall, "steps_trained": len(losses), "dead_pull_raised": True,
                "recover_s": recover_s, "rows_bitwise_equal_to_ckpt": hi - lo,
                "push_moved_max": moved, "dead": cl.dead()}
    finally:
        cl.close()


def elastic_control(torch, dev, shards):
    """The fixed 2-server, 1-worker run the event legs are held to; returns
    (cluster, losses, the worker's counters), the cluster still open."""
    cl = _Cluster(torch, dev, n_workers=1)
    losses, wall = _timed_run(torch, cl.trainer(shards, dev))
    check(cl.dead() == [], f"control: dead {cl.dead()}")
    return cl, losses, cl.workers["W0"].counters(), wall


def elastic_promotion(torch, scatter, dev, shards, control):
    """Sync replica chains on the cluster's postoffices, ``ReplicaSet(van,
    standbys, manager=sched)``, 1 worker: after workload 2 S0 stops beating
    and is disconnected; the scheduler's monitor finds it silent and the set
    promotes standby 0.  After workload 4 S1 is restarted under its own id by
    ``restart_server`` from its standby.  Losses, rows and optimizer state
    equal the control's bit for bit; S0 alone is reported dead."""
    import gc

    from parameter_server_tpu_torch.kv.replica import ReplicaSet
    from parameter_server_tpu_torch.learner.elastic import restart_server

    ctl, ctl_losses, ctl_counters, _ = control
    cl = _Cluster(torch, dev, n_workers=1, chain=True)
    try:
        rset = ReplicaSet(cl.van, cl.standbys, manager=cl.sched)
        promoted_at = []
        cl.sched.on_node_dead.append(lambda nid: promoted_at.append(time.monotonic()))
        trainer = cl.trainer(shards, dev)
        s1_before = next(n for n in cl.sched.nodes() if n.node_id == "S1")
        ev = {}

        def event(n):
            if n == ELASTIC_PROMOTE_AFTER:
                ev["kill_t"] = time.monotonic()
                trainer.kill("S0")  # its beats stop
                cl.van.disconnect("S0")  # the primary process dies
                _wait_for(lambda: 0 in rset.promoted, 60, "standby 0 promoted")
            elif n == ELASTIC_RESTART_AFTER:
                old = cl.servers[1]  # S1 crashes: its card memory goes first
                old.ledger.close()
                old.tables.clear()
                cl.servers[1] = old = None
                gc.collect()
                torch.cuda.empty_cache()
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                server, source, mgr = restart_server(
                    cl.van, cl.cfgs, 1, 2, num_workers=1, standby=cl.standbys[1],
                    heartbeat_timeout=ELASTIC_HB_TIMEOUT_S, device=dev)
                torch.cuda.synchronize()
                ev["restart_s"] = time.perf_counter() - t0
                cl.servers[1] = server
                trainer.managers["S1"] = mgr  # the new process beats
                ev["source"] = source

        _on_done(trainer, event)
        losses, wall = _timed_run(torch, trainer)
        s0_row = next(n for n in cl.sched.nodes() if n.node_id == "S0")
        s1_row = next(n for n in cl.sched.nodes() if n.node_id == "S1")
        check(cl.dead() == ["S0"] and not s0_row.alive, f"promotion: dead {cl.dead()}")
        check(ev.get("source") == "replica", f"restart source {ev.get('source')}")
        check(s1_row.alive and s1_row.incarnation == 1
              and (s1_row.range_begin, s1_row.range_end)
              == (s1_before.range_begin, s1_before.range_end),
              f"S1 after the restart: {s1_row}")
        fleet = [rset.promoted[0], cl.servers[1]]
        check(_tables_on(fleet) == _tables_on(ctl.servers), "promoted fleet is not on the card")
        check(losses == ctl_losses, "promotion: the losses differ from the control's")
        rows = _fleets_equal(torch, fleet, cl.workers["W0"].routing, ctl.servers,
                             ctl.workers["W0"].routing)
        check(rows == ROWS, f"promotion compared {rows} rows")
        return {"workers": 1, "workloads": len(shards), "chains": "sync",
                "promote_after_workloads": ELASTIC_PROMOTE_AFTER, "dead": cl.dead(),
                "last_beat_to_promotion_s": promoted_at[0] - s0_row.last_seen,
                "kill_to_promotion_s": promoted_at[0] - ev["kill_t"],
                "restart_after_workloads": ELASTIC_RESTART_AFTER, "restart_source": ev["source"],
                "restart_s": ev["restart_s"], "s1_incarnation": s1_row.incarnation,
                "s1_range": [s1_row.range_begin, s1_row.range_end],
                "run_s": wall, "losses_equal_control": True, "rows_bitwise_equal_control": rows}
    finally:
        cl.close()


class _CommitGate:
    """Holds every ``migrate_commit`` of a migrator until :meth:`release`:
    chunks stream while the worker trains a workload, and the commit (the
    freeze) lands between two workloads."""

    def __init__(self, migrator):
        import threading

        self.migrator, self.rpc, self.open = migrator, migrator._rpc, threading.Event()
        migrator._rpc = self._rpc

    def _rpc(self, recver, payload):
        if payload["op"] == "migrate_commit":
            check(self.open.wait(600), "a migration commit was never released")
        return self.rpc(recver, payload)

    def release(self):
        self.open.set()

    def close(self):
        self.migrator._rpc = self.rpc


def elastic_scale(torch, scatter, dev, shards, control, planes):
    """1 worker; ``scale_up`` onto S2 streams while the 4th workload trains
    and commits after it, ``drain_down`` of S1 likewise over the 5th.  The
    scheduler broadcasts each table (``sched=``), the worker adopts it
    through ``Manager.on_routing``.  Trajectory and table bitwise the
    control's, with as many push retries."""
    import threading

    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.kv.migrate import ShardMigrator
    from parameter_server_tpu_torch.learner.elastic import drain_down, scale_up

    ctl, ctl_losses, ctl_counters, _ = control
    cl = _Cluster(torch, dev, n_workers=1)
    worker = cl.workers["W0"]
    try:
        cl.managers["W0"].on_routing.append(worker.adopt_routing)
        mig = ShardMigrator(Postoffice("M0", cl.van), chunk_rows=ELASTIC_CHUNK, timeout=300)
        trainer = cl.trainer(shards, dev)
        by_index = dict(enumerate(cl.servers))
        legs, state = [], {}

        def start(name, fn):
            gate = _CommitGate(mig)
            before = scatter.launch_counts()
            n_sets = len(planes.records["scatter_set"])
            rows0 = mig.rows_moved

            def body():
                state[name] = fn()

            t = threading.Thread(target=body)
            t0 = time.perf_counter()
            t.start()
            return {"name": name, "gate": gate, "thread": t, "t0": t0, "before": before,
                    "n_sets": n_sets, "rows0": rows0}

        def finish(leg):
            leg["gate"].release()
            leg["thread"].join(600)
            leg["gate"].close()
            check(leg["name"] in state, f"{leg['name']} raised")
            epoch = cl.sched.routing.epoch
            _wait_for(lambda: worker.routing.epoch == epoch, 60, "the broadcast adopted")
            torch.cuda.synchronize()
            after = scatter.launch_counts()
            deltas = [r[0] for r in planes.records["scatter_set"][leg["n_sets"]:]]
            legs.append({"op": leg["name"], "seconds": time.perf_counter() - leg["t0"],
                         "rows_moved": mig.rows_moved - leg["rows0"], "epoch": epoch,
                         "commit_freeze_ms": 1e3 * mig.freeze_s_last,
                         "delta_rows": deltas,
                         "launches": {k: after[k] - leg["before"][k] for k in after}})

        def event(n):
            if n == ELASTIC_SCALE_AT:
                state["up"] = start("scale_up", lambda: scale_up(
                    cl.van, cl.cfgs, worker.routing, 2, migrator=mig, num_servers=3,
                    sched=cl.sched, device=dev))
            elif n == ELASTIC_SCALE_AT + 1:
                finish(state["up"])
                by_index[2], routing = state["scale_up"]
                cl.servers.append(by_index[2])
                check(routing.tables["w"].server_rows(2) > 0, "S2 owns no rows")
                state["down"] = start("drain_down", lambda: drain_down(
                    cl.van, routing, 1, migrator=mig, sched=cl.sched))
            elif n == ELASTIC_SCALE_AT + 2:
                finish(state["down"])

        _on_done(trainer, event)
        losses, wall = _timed_run(torch, trainer)
        routing = state["drain_down"]
        check(1 not in routing.servers() and worker.routing.epoch == routing.epoch,
              f"final routing {routing.tables['w']}")
        check(cl.dead() == [], f"scale: dead {cl.dead()}")
        fleet = {s: by_index[s] for s in routing.servers()}
        check(_tables_on(fleet.values()) == _tables_on(ctl.servers), "scaled fleet off the card")
        check(losses == ctl_losses, "scale: the losses differ from the control's")
        rows = _fleets_equal(torch, fleet, routing, ctl.servers, ctl.workers["W0"].routing)
        check(rows == ROWS, f"scale compared {rows} rows")
        retries = worker.counters()["push_retries"]
        check(retries == ctl_counters["push_retries"],
              f"push retries {retries} vs the control's {ctl_counters['push_retries']}")
        check(all(leg["delta_rows"] and leg["delta_rows"][0] > 0 for leg in legs),
              f"a commit's delta was empty: {legs}")
        return {"workers": 1, "workloads": len(shards), "chunk_rows": ELASTIC_CHUNK,
                "legs": legs, "run_s": wall, "epoch": routing.epoch,
                "segments": routing.tables["w"].segments(), "push_retries": retries,
                "losses_equal_control": True, "rows_bitwise_equal_control": rows}
    finally:
        cl.close()


def elastic_vs_cpu(torch, dev, shards):
    """The 1-worker run on the card and with ``device="cpu"`` servers and
    worker: losses within 1e-4, every row of value and state within 1e-5."""
    out = {}
    for side, device in (("card", dev), ("cpu", torch.device("cpu"))):
        cl = _Cluster(torch, device, n_workers=1)
        try:
            losses = cl.trainer(shards, device).run()
            out[side] = (np.asarray(losses), [s.export_shard()["w"] for s in cl.servers])
        finally:
            cl.close()
    lg, lc = out["card"][0], out["cpu"][0]
    check(np.allclose(lg, lc, rtol=1e-4, atol=1e-4), f"losses {lg} vs cpu {lc}")
    err = 0.0
    for sg, sc in zip(out["card"][1], out["cpu"][1]):
        for a, b in [(sg["value"], sc["value"]),
                     *((sg["state"][k], sc["state"][k]) for k in sc["state"])]:
            check(np.allclose(a, b, rtol=1e-5, atol=1e-5), "elastic card vs cpu tables")
            err = max(err, float(np.abs(a - b).max()))
    return {"workloads": len(shards), "steps": int(lg.size),
            "loss_max_abs_err": float(np.abs(lg - lc).max()), "table_max_abs_err": err,
            "loss_tol": 1e-4, "table_tol": 1e-5}


def elastic_phase(torch, scatter, dev, errs):
    """The membership and elasticity plane at config #1 width: legs
    ``worker_death``, ``server_death``, ``promotion`` (with the same-id
    ``restart``), ``scale`` and the kernel checks.  Returns (fields,
    launches)."""
    import os
    import shutil

    root = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "parameter_server_tpu_torch", "build", "elastic")
    shutil.rmtree(root, ignore_errors=True)
    t_phase = time.perf_counter()
    death_shards = _elastic_shards(ELASTIC_WORKLOADS, ELASTIC_SEED)
    shards = death_shards[:ELASTIC_RUN_WORKLOADS]
    out = {"rows": ROWS, "dim": DIM, "batch": BATCH, "nnz": NNZ,
           "heartbeat_timeout_s": ELASTIC_HB_TIMEOUT_S,
           "heartbeat_interval_s": ELASTIC_HB_INTERVAL_S}
    torch.cuda.synchronize()
    scatter.reset_launch_counts()
    control = None
    try:
        with PlanesTap(torch, scatter) as planes, ApplyTap(torch, scatter) as applies:
            out["worker_death"] = elastic_worker_death(torch, scatter, dev, death_shards)
            emit("elastic_worker_death", **out["worker_death"])
            out["server_death"] = elastic_server_death(torch, scatter, dev, shards, root)
            emit("elastic_server_death", **out["server_death"])
            control = elastic_control(torch, dev, shards)
            out["control"] = {"run_s": control[3], "steps": len(control[1]),
                              "push_retries": control[2]["push_retries"]}
            out["promotion"] = elastic_promotion(torch, scatter, dev, shards, control)
            emit("elastic_promotion", **out["promotion"])
            out["scale"] = elastic_scale(torch, scatter, dev, shards, control, planes)
            emit("elastic_scale", **out["scale"])
            control[0].close()
            control = None
            out["vs_cpu"] = elastic_vs_cpu(torch, dev, shards[:ELASTIC_REF_WORKLOADS])
            emit("elastic_vs_cpu", **out["vs_cpu"])
            counts = scatter.launch_counts()
            out["gather_check"] = planes.result(errs, "gather")
            out["scatter_set_check"] = planes.result(errs, "scatter_set")
            check(len(applies.records) >= 4, f"{len(applies.records)} applies held")
            out["apply_check"] = applies.result(errs, len(applies.records))
    finally:
        if control is not None:
            control[0].close()
        shutil.rmtree(root, ignore_errors=True)
    check(counts["gather"] > 0 and counts["apply"] > 0 and counts["scatter_set"] > 0,
          f"elastic launches {counts}")
    out["launches"] = counts
    out["phase_s"] = time.perf_counter() - t_phase
    return out, counts


def wire_batches():
    """The config #1 batches of phase ``wire``: one stream, seed 51."""
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR

    data = SyntheticCTR(key_space=KEY_SPACE, nnz=NNZ, batch_size=BATCH, seed=51,
                        informative=0.1)
    return [data.next_batch() for _ in range(WIRE_STEPS)]


def wire_stack(kind):
    """The van of run ``kind`` and its layers by name: ``clean`` is a plain
    LoopbackVan; ``drop`` the reference's ``_reliable_stack``
    (``tests/test_chaos.py:50``) at 5% drop; ``framed`` its production stack
    over real frame bytes (``tests/test_frame.py:644``)."""
    from parameter_server_tpu_torch.core.chaos import ChaosVan
    from parameter_server_tpu_torch.core.coalesce import CoalescingVan
    from parameter_server_tpu_torch.core.frame import FrameCodecVan
    from parameter_server_tpu_torch.core.netmon import MeteredVan
    from parameter_server_tpu_torch.core.resender import ReliableVan
    from parameter_server_tpu_torch.core.van import LoopbackVan

    if kind == "clean":
        return LoopbackVan(), {}
    layers = {}
    base = LoopbackVan()
    faults = dict(drop=WIRE_DROP)
    if kind == "framed":
        base = layers["codec"] = FrameCodecVan(base)
        faults.update(duplicate=WIRE_DUP, corrupt=WIRE_CORRUPT)
    layers["chaos"] = ChaosVan(base, seed=WIRE_SEED, **faults)
    van = layers["reliable"] = ReliableVan(
        layers["chaos"], timeout=WIRE_TIMEOUT_S, backoff=1.0, max_retries=WIRE_RETRIES,
        seed=WIRE_SEED)
    if kind == "framed":
        layers["metered"] = MeteredVan(van, stamp=False)
        van = CoalescingVan(layers["metered"])
    return van, layers


class _PushFrameTap:
    """Keeps the last PUSH request to S0 that reaches a FrameCodecVan, and
    counts the messages with a plane on the card that reach it."""

    def __init__(self, torch, codec):
        self.torch, self.codec, self.orig = torch, codec, codec.send
        self.push, self.card_planes = None, []
        codec.send = self._send

    def _send(self, msg):
        if msg.is_request and msg.recver == "S0" and msg.task.kind.value == "push":
            self.push = msg
        if any(isinstance(v, self.torch.Tensor) and v.is_cuda for v in msg.values):
            self.card_planes.append(msg.recver)
        return self.orig(msg)


def wire_run(torch, scatter, dev, batches, kind):
    """One worker's pull_sync -> card gradient -> push_sync over stack
    ``kind``: losses, both shards' planes, pushes, launches, counters."""
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker

    van, layers = wire_stack(kind)
    servers = []
    try:
        servers = [KVServer(Postoffice(f"S{s}", van), _config1_tables(), s, 2, device=dev)
                   for s in range(2)]
        worker = KVWorker(Postoffice("W0", van), _config1_tables(), 2, device=dev)
        tap = _PushFrameTap(torch, layers["codec"]) if "codec" in layers else None
        out = _timed_steps(torch, scatter, dev, batches, worker)
        check(van.flush(10), f"wire {kind}: the van did not settle")
        out.update(pushes=sum(s.pushes for s in servers), pull_retries=worker.pull_retries,
                   planes=[(e["value"], [e["state"][k] for k in sorted(e["state"])])
                           for e in (s.export_shard()["w"] for s in servers)])
        if "reliable" in layers:
            out["reliable"] = layers["reliable"].counters()
            out["chaos"] = layers["chaos"].counters()
        if tap is not None:
            out.update(codec=layers["codec"].counters(), metered=layers["metered"].counters())
            out["push_frame"] = codec_times(tap.push)
            out["device_push"] = wire_device_push(torch, scatter, dev, worker, servers, layers,
                                                  tap)
        return out
    finally:
        _free_cluster(torch, van, servers)


def codec_times(msg):
    """Server 0's push frame as the codec writes it: bytes, overhead, and
    ``encode`` / ``decode`` us, medians of ``WIRE_CODEC_REPS`` (host clock)."""
    from parameter_server_tpu_torch.core import frame

    check(msg is not None, "wire framed: no PUSH request to S0 reached the codec")
    enc, dec = [], []
    for _ in range(WIRE_CODEC_REPS):
        t0 = time.perf_counter()
        buf = frame.encode(msg)
        t1 = time.perf_counter()
        frame.decode(buf)
        dec.append(time.perf_counter() - t1)
        enc.append(t1 - t0)
    info = frame.peek(buf)
    check(frame.frame_nbytes(msg) == (len(buf), info.overhead), "frame_nbytes vs encode")
    return {"bytes": len(buf), "overhead_bytes": info.overhead, "keys": int(msg.keys.size),
            "encode_us": 1e6 * float(np.median(enc)), "decode_us": 1e6 * float(np.median(dec))}


def wire_device_push(torch, scatter, dev, worker, servers, layers, tap):
    """A ``push_device`` push of a plane on the card over the framed stack
    (one message a server, each with a CUDA plane): every such message
    reaches the codec unframed (``frame_passthrough`` rises once a delivery,
    twice where chaos duplicates one), each server applies it once, and it
    is not rejected as corrupt for good (nothing gave up, the van settled)."""
    keys = np.arange(WIRE_DEVICE_KEYS, dtype=np.uint64)
    grads = torch.full((WIRE_DEVICE_KEYS,), 1e-3, device=dev)
    codec, rel = layers["codec"], layers["reliable"]
    before = (codec.frame_passthrough, len(tap.card_planes), [s.pushes for s in servers],
              scatter.launch_counts()["apply"], rel.rejected_corrupt)
    check(worker.wait(worker.push_device("w", keys, grads), timeout=120),
          "wire: push_device did not complete")
    check(layers["metered"].flush(10), "wire: the van did not settle after push_device")
    passthrough = codec.frame_passthrough - before[0]
    reached = tap.card_planes[before[1]:]
    pushes = [s.pushes - b for s, b in zip(servers, before[2])]
    applies = scatter.launch_counts()["apply"] - before[3]
    check(reached and passthrough == len(reached),
          f"push_device: {passthrough} unframed of {len(reached)} card-plane deliveries")
    check(sorted(set(reached)) == [f"S{i}" for i in range(len(servers))]
          and pushes == [1] * len(servers),
          f"push_device applied {pushes} times per server, sent to {sorted(set(reached))}")
    check(1 <= applies <= len(servers), f"push_device: {applies} ps_apply launches")
    check(rel.gave_up == 0, "push_device: the resender gave up")
    return {"passthrough": passthrough, "card_plane_deliveries": len(reached),
            "applied": pushes, "apply_launches": applies,
            "rejected_corrupt": rel.rejected_corrupt - before[4]}


def _same_tables(ref, got, what, ref_name):
    """Hold run ``what`` bitwise to run ``ref_name``, exactly once: losses,
    every row of both shards' planes, pushes applied, gather and apply
    launches, no pull retried."""
    check(np.array_equal(got["losses"], ref["losses"]),
          f"{what}: losses {got['losses']} vs {ref_name} {ref['losses']}")
    for (gv, gs), (cv, cs) in zip(got["planes"], ref["planes"]):
        check(np.array_equal(gv, cv) and all(np.array_equal(a, b) for a, b in zip(gs, cs)),
              f"{what}: a table plane differs from {ref_name}")
    check(got["pushes"] == ref["pushes"],
          f"{what}: {got['pushes']} pushes applied, {ref_name} {ref['pushes']}")
    for name in ("apply", "gather"):
        check(got["launches"][name] == ref["launches"][name],
              f"{what}: {name} launches {got['launches']} vs {ref_name} {ref['launches']}")
    check(got["pull_retries"] == 0, f"{what}: {got['pull_retries']} pull retries")


def _same_run(clean, got, kind):
    """Hold run ``kind`` bitwise to the clean run, exactly once, with drops
    injected and nothing given up."""
    _same_tables(clean, got, f"wire {kind}", "clean")
    rel, chaos = got["reliable"], got["chaos"]
    check(rel["gave_up"] == 0, f"wire {kind}: gave up {rel['gave_up']}")
    check(chaos["chaos_drops"] > 0, f"wire {kind}: no drop injected")


class _WindowedFleet:
    """A FleetMonitor fed only the traffic since it was made: each link's
    deliver histogram less its state at that moment (the per-link digests
    riding heartbeats are cumulative)."""

    def __init__(self, monitor, metered):
        from parameter_server_tpu_torch.utils.trace import LatencyHistogram

        self.monitor, self.hist = monitor, LatencyHistogram
        self.base = {link: d["deliver"] for link, d in metered.links().items()}

    def _since(self, link, digest):
        base = self.base.get(link)
        if base is None:
            return digest
        h = self.hist.from_dict(digest["deliver"])
        b = self.hist.from_dict(base)
        h.counts = [c - o for c, o in zip(h.counts, b.counts)]
        h.count -= b.count
        h.sum_s -= b.sum_s
        top = max((i for i, c in enumerate(h.counts) if c), default=None)
        # the window's max is unknown: bound it by its top bucket's edge
        h.max_s = 0.0 if top is None else h.BASE * h.GROWTH ** top
        return {**digest, "deliver": h.to_dict()}

    def observe(self, node_id, stats, now=None):
        stats = dict(stats or {})
        stats["links"] = {link: self._since(link, d)
                          for link, d in (stats.get("links") or {}).items()}
        self.monitor.observe(node_id, stats, now)

    def __getattr__(self, name):
        return getattr(self.monitor, name)


def wire_straggler(torch, dev, batches):
    """``tests/test_fleet.py:201`` at config #1 width on the card: S1 slowed
    by ``WIRE_SLOW_MS`` must be flagged within ``WIRE_BEATS`` heartbeats and
    no healthy node ever; healed, a fresh monitor flags no node."""
    from parameter_server_tpu_torch.core.chaos import ChaosVan
    from parameter_server_tpu_torch.core.fleet import FleetMonitor, StragglerPolicy
    from parameter_server_tpu_torch.core.manager import launch_local_cluster
    from parameter_server_tpu_torch.core.messages import SCHEDULER
    from parameter_server_tpu_torch.core.netmon import MeteredVan
    from parameter_server_tpu_torch.core.resender import ReliableVan
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker

    chaos = ChaosVan(LoopbackVan(), seed=0)
    reliable = ReliableVan(chaos, timeout=5.0, backoff=1.0, max_retries=3, seed=0)
    van = MeteredVan(reliable)
    servers = []
    try:
        sched, managers, posts = launch_local_cluster(van, num_workers=2, num_servers=2,
                                                      key_space=ROWS)
        servers = [KVServer(posts[f"S{s}"], _config1_tables(), s, 2, device=dev)
                   for s in range(2)]
        workers = [KVWorker(posts[f"W{w}"], _config1_tables(), 2, device=dev) for w in range(2)]
        rng = np.random.default_rng(7)
        feed = itertools.cycle(batches)

        def beats(monitor):
            """``WIRE_BEATS`` rounds of one push a worker and one heartbeat a
            node; the stragglers after each round."""
            sched.fleet = monitor
            flags = []
            for _ in range(WIRE_BEATS):
                for w in workers:
                    keys = next(feed)[0]
                    grads = rng.standard_normal(keys.size).astype(np.float32) / BATCH
                    check(w.wait(w.push("w", keys, grads), timeout=120), "straggler: push")
                for nid, mgr in managers.items():
                    if nid != SCHEDULER:
                        check(mgr.wait(mgr.send_heartbeat(), timeout=120), "straggler: beat")
                flags.append(sorted(monitor.stragglers()))
            return flags

        policy = StragglerPolicy(k=4.0, p99_floor_ms=40.0)
        chaos.slow_node("S1", WIRE_SLOW_MS)
        slow_monitor = FleetMonitor(policy=policy)
        t0 = time.perf_counter()
        slowed = beats(slow_monitor)
        flagged_at = next((i + 1 for i, f in enumerate(slowed) if "S1" in f), None)
        check(all(set(f) <= {"S1"} for f in slowed), f"straggler: a healthy node flagged {slowed}")
        check(flagged_at is not None, f"straggler: S1 not flagged in {WIRE_BEATS} beats: "
              f"{slow_monitor.snapshot()}")
        injected = chaos.injected_slow
        check(injected > 0, "straggler: no slowed delivery")
        chaos.slow_node("S1", 0)
        healed_monitor = _WindowedFleet(FleetMonitor(policy=policy), van)
        healed = beats(healed_monitor)
        check(all(not f for f in healed), f"straggler: flags after the heal {healed}")
        check(chaos.injected_slow == injected, "straggler: slowed deliveries after the heal")
        snap = slow_monitor.snapshot()
        return {"slow_ms": WIRE_SLOW_MS, "beats": WIRE_BEATS, "flagged_at_beat": flagged_at,
                "flags_by_beat": slowed, "healed_flags_by_beat": healed,
                "slowed_deliveries": injected,
                "s1_push_p99_ms": snap["S1"].get("push_p99_ms"),
                "s0_push_p99_ms": snap["S0"].get("push_p99_ms"),
                "s1_push_p99_ms_healed": healed_monitor.snapshot()["S1"].get("push_p99_ms"),
                "seconds": time.perf_counter() - t0}
    finally:
        _free_cluster(torch, van, servers)


def wire_phase(torch, scatter, dev, errs):
    """The wire's reliability layer at config #1 width: runs ``clean``,
    ``drop`` and ``framed`` of one worker, the ``push_device`` leg and the
    straggler leg.  Returns (fields, launches of the phase's runs)."""
    t_phase = time.perf_counter()
    batches = wire_batches()
    total = dict.fromkeys(REPLACES, 0)
    runs = {}
    with PlanesTap(torch, scatter) as planes, ApplyTap(torch, scatter) as applies:
        for kind in ("clean", "drop", "framed"):
            applies.seen.clear()  # hold each run's first apply on every table
            runs[kind] = wire_run(torch, scatter, dev, batches, kind)
            counts = scatter.launch_counts()  # the framed run's include push_device
            for name in total:
                total[name] += counts[name]
        # the retransmit deadline against the clean run's pull round trips
        # after the warm-up step (an upper bound on the ACK's round trip)
        steady = runs["clean"]["pull_s"][1:]
        out = {"rows": ROWS, "dim": DIM, "batch": BATCH, "nnz": NNZ, "steps": WIRE_STEPS,
               "seed": WIRE_SEED, "timeout_s": WIRE_TIMEOUT_S,
               "clean_pull_s_median": float(np.median(steady)),
               "clean_pull_s_max": float(max(steady))}
        clean = runs["clean"]
        for kind in ("drop", "framed"):
            _same_run(clean, runs[kind], kind)
        fr = runs["framed"]
        check(fr["chaos"]["chaos_corrupt"] > 0 and fr["reliable"]["rejected_corrupt"] > 0,
              f"wire framed: corruption {fr['chaos']} / {fr['reliable']}")
        check(fr["codec"]["frame_passthrough"] == 0,
              f"wire framed: {fr['codec']['frame_passthrough']} messages passed unframed")
        check(fr["metered"]["wire_frame_bytes"] > fr["metered"]["wire_bytes"],
              f"wire framed: metering {fr['metered']}")
        for kind, r in runs.items():
            out[kind] = {k: r[k] for k in ("examples_per_s", "timed_s", "launches", "pushes",
                                           "pull_s")}
            out[kind]["loss_first"], out[kind]["loss_last"] = map(float, r["losses"][[0, -1]])
            for k in ("reliable", "chaos", "codec", "metered", "push_frame", "device_push"):
                if k in r:
                    out[kind][k] = r[k]
            emit("wire_" + kind, **out[kind])
        scatter.reset_launch_counts()
        applies.seen.clear()
        out["straggler"] = wire_straggler(torch, dev, batches)
        emit("wire_straggler", **out["straggler"])
        counts = scatter.launch_counts()
        for name in total:
            total[name] += counts[name]
        out["gather_check"] = planes.result(errs, "gather")
        check(len(applies.records) == 8, f"{len(applies.records)} applies held, expected 8 "
              "(2 tables x 3 runs and the straggler leg)")
        out["apply_check"] = applies.result(errs, len(applies.records))
    check(total["gather"] > 0 and total["apply"] > 0, f"wire launches {total}")
    out["launches"] = total
    out["phase_s"] = time.perf_counter() - t_phase
    out["clean_run"] = runs["clean"]  # the sockets phase holds its legs to it
    return out, total


def _wire_tables(compression=None):
    """Config #1's table, with a lossy wire codec for the ``int8_ef`` leg."""
    import dataclasses

    return {t: dataclasses.replace(c, compression=compression)
            for t, c in _config1_tables().items()}


def sockets_stack(kind):
    """The vans of leg ``kind``: one ``TcpVan`` on localhost for each server
    and one for the worker (three processes' worth of sockets, shm rings
    negotiated unless the leg says otherwise), wrapped as the leg asks.
    Returns (server vans, worker van, layers by name)."""
    from parameter_server_tpu_torch.config import TransportConfig, WireCompressionConfig
    from parameter_server_tpu_torch.core.chaos import ChaosVan
    from parameter_server_tpu_torch.core.coalesce import CoalescingVan
    from parameter_server_tpu_torch.core.filters import make_chain, quantizer_from_tables
    from parameter_server_tpu_torch.core.netmon import MeteredVan
    from parameter_server_tpu_torch.core.resender import ReliableVan
    from parameter_server_tpu_torch.core.tcp_van import TcpVan

    transport = {"tcp_only": TransportConfig(shm=False),
                 "threaded": TransportConfig(wire="threaded")}.get(kind, TransportConfig())
    spec = "lossless" if kind == "lossless" else "none"
    tcps = [TcpVan(transport=transport, filter_chain=make_chain(spec)) for _ in range(3)]
    layers = {"tcp": tcps}
    server_vans, worker_van = list(tcps[:2]), tcps[2]
    if kind == "int8_ef":
        tables = _wire_tables(WireCompressionConfig(codec="int8", error_feedback=True))
        server_vans = [CoalescingVan(t, codec=quantizer_from_tables(tables)) for t in tcps[:2]]
        layers["metered"] = MeteredVan(tcps[2], stamp=False)
        worker_van = CoalescingVan(layers["metered"], codec=quantizer_from_tables(tables))
        layers["codec"] = worker_van.codec
    elif kind == "reliable":
        server_vans = [ReliableVan(t, timeout=WIRE_TIMEOUT_S, backoff=1.0,
                                   max_retries=WIRE_RETRIES, seed=WIRE_SEED) for t in tcps[:2]]
        layers["chaos"] = ChaosVan(tcps[2], seed=WIRE_SEED, drop=WIRE_DROP)
        worker_van = layers["reliable"] = ReliableVan(
            layers["chaos"], timeout=WIRE_TIMEOUT_S, backoff=1.0, max_retries=WIRE_RETRIES,
            seed=WIRE_SEED)
        layers["server_reliable"] = server_vans
    for s, t in enumerate(tcps[:2]):
        tcps[2].add_route(f"S{s}", t.address)
    return server_vans, worker_van, layers


def sockets_run(torch, scatter, dev, batches, kind):
    """One worker's pull_sync -> card gradient -> push_sync with each node on
    its own ``TcpVan`` (leg ``kind``): as ``wire_run``, plus the sockets'
    counters, payload bytes and each van's wire backend."""
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker

    server_vans, worker_van, layers = sockets_stack(kind)
    compression = (layers["codec"].per_table["w"] if "codec" in layers else None)
    tables = _wire_tables(compression)
    servers = []
    try:
        servers = [KVServer(Postoffice(f"S{s}", v), tables, s, 2, device=dev)
                   for s, v in enumerate(server_vans)]
        worker = KVWorker(Postoffice("W0", worker_van), tables, 2, device=dev)
        out = _timed_steps(torch, scatter, dev, batches, worker)
        check(worker_van.flush(10), f"sockets {kind}: the worker's van did not settle")
        tcps = layers["tcp"]
        out.update(
            pushes=sum(s.pushes for s in servers), pull_retries=worker.pull_retries,
            planes=[(e["value"], [e["state"][k] for k in sorted(e["state"])])
                    for e in (s.export_shard()["w"] for s in servers)],
            backends=[t.wire_backend for t in tcps],
            payload_bytes_sent=sum(t.payload_bytes_sent() for t in tcps),
            socket_bytes_sent=sum(t.bytes_sent() for t in tcps),
            tcp=[{k: c[k] for k in ("sent", "dropped", "frame_rejects", "shm_links",
                                    "shm_frames_sent", "shm_frames_recv", "ring_full",
                                    "writeq_full")}
                 for c in (t.counters() for t in tcps)])
        chains = [t.filter_chain for t in tcps if t.filter_chain is not None]
        if chains:
            out["filter_overhead"] = [c.overhead() for c in chains]
            out["zlib_bytes_in_out"] = [c.compressed_bytes() for c in chains]
        if "codec" in layers:
            out["codec"] = layers["codec"].counters()
            out["metered"] = layers["metered"].counters()
            out["metered_links"] = {
                link: {k: d[k] for k in ("msgs", "bytes", "raw_bytes", "frame_bytes", "verbs")}
                for link, d in layers["metered"].links().items()}
        if "reliable" in layers:
            out["reliable"] = layers["reliable"].counters()
            out["chaos"] = layers["chaos"].counters()
            out["server_gave_up"] = sum(v.gave_up for v in layers["server_reliable"])
        return out
    finally:
        for v in (worker_van, *server_vans):
            v.close()
        for srv in servers:
            if srv.ledger is not None:
                srv.ledger.close()
            srv.tables.clear()
        servers.clear()
        import gc

        gc.collect()
        torch.cuda.empty_cache()


def _timed_steps(torch, scatter, dev, batches, worker):
    """One worker's pull_sync -> card gradient -> push_sync over ``batches``,
    launch counts from 0: the first step warms the path up, the rest are
    timed; per-step pull and push seconds on the host clock."""
    losses, pull_s, push_s = [], [], []
    torch.cuda.synchronize()
    scatter.reset_launch_counts()
    for step, (keys, labels) in enumerate(batches):
        if step == 1:
            torch.cuda.synchronize()
            t0 = time.perf_counter()
        t1 = time.perf_counter()
        w_pos = worker.pull_sync("w", keys, timeout=120)
        pull_s.append(time.perf_counter() - t1)
        grad, loss = _card_grad(torch, dev, w_pos, labels)
        t1 = time.perf_counter()
        worker.push_sync("w", keys, grad, timeout=120)
        push_s.append(time.perf_counter() - t1)
        losses.append(loss)
    torch.cuda.synchronize()
    elapsed = time.perf_counter() - t0
    return {"losses": np.asarray(losses), "examples_per_s": BATCH * (len(batches) - 1) / elapsed,
            "timed_s": elapsed, "launches": scatter.launch_counts(), "pull_s": pull_s,
            "push_s": push_s}


def _p50_ms(samples):
    return 1e3 * float(np.median(samples[1:]))


def sockets_launch_leg(torch, filters):
    """``launch()`` itself at config #1 width on the card: a scheduler, 2
    servers and 2 workers as OS processes over ``TcpVan`` with ``filters``.
    Every child must exit 0 and report ``cuda``; the servers must have
    launched ``ps_gather`` and ``ps_apply``; the loss must fall."""
    import json
    import os
    import shutil

    from parameter_server_tpu_torch.launch import launch

    outdir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                          "parameter_server_tpu_torch", "build", f"launch_{filters}")
    shutil.rmtree(outdir, ignore_errors=True)
    os.makedirs(outdir)
    try:
        t0 = time.perf_counter()
        res = launch(device=DEVICE, num_workers=2, num_servers=2, rows=ROWS, batch_size=BATCH,
                     nnz=NNZ, steps=WIRE_STEPS, filters=filters, run_timeout=300.0,
                     outdir=outdir)
        seconds = time.perf_counter() - t0
        check(res["returncodes"] == [0] * 5, f"launch {filters}: return codes {res}")
        check(res["workers_reported"] == ["W0", "W1"] and res["steps_total"] == 2 * WIRE_STEPS,
              f"launch {filters}: {res}")
        check(res["final_loss"] < res["first_loss"],
              f"launch {filters}: loss {res['first_loss']} -> {res['final_loss']}")
        children = {}
        for node in ("S0", "S1", "W0", "W1"):
            with open(os.path.join(outdir, f"{node}.json")) as f:
                row = json.load(f)
            check(row["device"] == "cuda", f"launch {filters}: {node} ran on {row['device']}")
            children[node] = row["launches"]
        for node in ("S0", "S1"):
            check(children[node]["gather"] > 0 and children[node]["apply"] > 0,
                  f"launch {filters}: {node} launches {children[node]}")
        return {**res, "seconds": seconds, "child_launches": children}
    finally:
        shutil.rmtree(outdir, ignore_errors=True)


def sockets_phase(torch, scatter, dev, errs, clean):
    """The production wire at config #1 width: 1 worker x 2 servers, each on
    its own ``TcpVan`` on localhost, legs ``tcp_shm``, ``tcp_only``,
    ``threaded`` (each bitwise equal to the wire phase's ``clean``
    LoopbackVan run), ``lossless`` and ``reliable`` (bitwise equal to
    ``tcp_shm``), ``int8_ef`` (within 0.03 of ``tcp_shm``'s loss), then the
    multi-process ``launch`` with the default filters and with none.
    Returns (fields, launches of the in-process legs)."""
    t_phase = time.perf_counter()
    batches = wire_batches()
    total = dict.fromkeys(REPLACES, 0)
    runs = {}
    legs = ("tcp_shm", "tcp_only", "threaded", "lossless", "int8_ef", "reliable")
    with PlanesTap(torch, scatter) as planes, ApplyTap(torch, scatter) as applies:
        for kind in legs:
            applies.seen.clear()  # hold each run's first apply on every table
            runs[kind] = sockets_run(torch, scatter, dev, batches, kind)
            for name in total:
                total[name] += runs[kind]["launches"][name]
        out = {"rows": ROWS, "dim": DIM, "batch": BATCH, "nnz": NNZ, "steps": WIRE_STEPS,
               "workers": 1, "servers": 2, "seed": WIRE_SEED}
        for kind in ("tcp_shm", "tcp_only", "threaded"):
            _same_tables(clean, runs[kind], f"sockets {kind}", "clean")
        for kind in ("lossless", "reliable"):
            _same_tables(runs["tcp_shm"], runs[kind], f"sockets {kind}", "tcp_shm")
        for kind, r in runs.items():
            want = "threaded" if kind == "threaded" else "epoll"
            check(r["backends"] == [want] * 3, f"sockets {kind}: wire backends {r['backends']}")
            shm = sum(c["shm_frames_sent"] for c in r["tcp"])
            check((shm == 0) == (kind == "tcp_only"), f"sockets {kind}: {shm} frames on shm rings")
            check(not any(c["frame_rejects"] for c in r["tcp"]),
                  f"sockets {kind}: frames rejected {r['tcp']}")
        rel = runs["reliable"]
        check(rel["reliable"]["gave_up"] == 0 and rel["server_gave_up"] == 0,
              f"sockets reliable: gave up {rel['reliable']}")
        check(rel["chaos"]["chaos_drops"] > 0 and rel["reliable"]["retransmits"] > 0,
              f"sockets reliable: {rel['chaos']} / {rel['reliable']}")
        ef, ref = runs["int8_ef"], runs["tcp_shm"]
        loss_gap = abs(float(ef["losses"][-1]) - float(ref["losses"][-1]))
        last3_gap = abs(float(np.mean(ef["losses"][-3:])) - float(np.mean(ref["losses"][-3:])))
        check(loss_gap < 0.03 and last3_gap < 0.03,
              f"sockets int8_ef: loss {ef['losses']} vs uncompressed {ref['losses']}")
        # the worker's outbound links carry its PUSHes (the only lossy
        # planes) and its PULL requests (keys only, nothing saved)
        push_links = {link: d for link, d in ef["metered_links"].items()
                      if link.startswith("W0->S")}
        check(all(d["raw_bytes"] > d["bytes"] for d in push_links.values()),
              f"sockets int8_ef: metered links {push_links}")
        check(ef["codec"]["compress_raw_bytes"] > ef["codec"]["compress_wire_bytes"] > 0,
              f"sockets int8_ef: codec {ef['codec']}")
        for kind, r in runs.items():
            row = {k: r[k] for k in ("examples_per_s", "timed_s", "launches", "pushes",
                                     "backends", "payload_bytes_sent", "socket_bytes_sent",
                                     "tcp")}
            row["loss_first"], row["loss_last"] = map(float, r["losses"][[0, -1]])
            row["pull_p50_ms"], row["push_p50_ms"] = _p50_ms(r["pull_s"]), _p50_ms(r["push_s"])
            row["examples_per_s_over_loopback"] = r["examples_per_s"] / clean["examples_per_s"]
            for k in ("filter_overhead", "zlib_bytes_in_out", "codec", "metered", "reliable",
                      "chaos", "server_gave_up"):
                if k in r:
                    row[k] = r[k]
            out[kind] = row
        out["loopback"] = {"examples_per_s": clean["examples_per_s"],
                           "pull_p50_ms": _p50_ms(clean["pull_s"]),
                           "push_p50_ms": _p50_ms(clean["push_s"])}
        out["lossless"]["payload_bytes_over_tcp_shm"] = (
            runs["lossless"]["payload_bytes_sent"] / runs["tcp_shm"]["payload_bytes_sent"])
        out["int8_ef"].update(loss_gap=loss_gap, last3_gap=last3_gap, bound=0.03,
                              push_links=push_links,
                              wire_raw_bytes=ef["metered"].get("wire_raw_bytes"),
                              wire_bytes=ef["metered"].get("wire_bytes"))
        for kind in legs:
            emit("sockets_" + kind, **out[kind])
        out["gather_check"] = planes.result(errs, "gather")
        check(len(applies.records) == 2 * len(legs),
              f"{len(applies.records)} applies held, expected {2 * len(legs)}")
        out["apply_check"] = applies.result(errs, len(applies.records))
    check(total["gather"] > 0 and total["apply"] > 0, f"sockets launches {total}")
    launches = {}
    for filters in ("lossless", "none"):
        launches[filters] = sockets_launch_leg(torch, filters)
        emit("sockets_launch_" + filters, **launches[filters])
    out["launch"] = {
        "wire_sent": {f: r["wire_sent"] for f, r in launches.items()},
        "wire_recv": {f: r["wire_recv"] for f, r in launches.items()},
        "wire_sent_lossless_over_none": launches["lossless"]["wire_sent"]
        / launches["none"]["wire_sent"],
        "filter_overhead": launches["lossless"]["filter_overhead"],
        "seconds": {f: r["seconds"] for f, r in launches.items()}}
    out["launch_child_launches"] = {
        name: sum(r["child_launches"][n][name] for r in launches.values()
                  for n in r["child_launches"]) for name in REPLACES}
    out["launches"] = total
    out["phase_s"] = time.perf_counter() - t_phase
    return out, total


# ---------------------------------------------------------------------------
# phase 8i: the observability plane
# ---------------------------------------------------------------------------


def _tool(name):
    """A repo tool module (``tools/`` is not a package), loaded off disk."""
    import importlib.util
    import os

    path = os.path.join(os.path.dirname(os.path.abspath(__file__)), "tools", f"{name}.py")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_tool(name, *args):
    """``python3 tools/<name>.py args``: (return code, stdout, stderr)."""
    import os

    root = os.path.dirname(os.path.abspath(__file__))
    proc = subprocess.run([sys.executable, os.path.join(root, "tools", f"{name}.py"), *args],
                          capture_output=True, text=True, timeout=120, cwd=root)
    return proc.returncode, proc.stdout, proc.stderr


def _observe_root():
    import os

    return os.path.join(os.path.dirname(os.path.abspath(__file__)),
                        "parameter_server_tpu_torch", "build", "observe")


class _Beats:
    """Every node's heartbeat, each ``OBSERVE_BEAT_S`` on one thread: a beat
    also publishes the node's telemetry frame (``Manager.send_heartbeat``)."""

    def __init__(self, managers):
        import threading

        self.managers, self.stop = managers, threading.Event()
        self.errors = []
        self.thread = threading.Thread(target=self._loop, name="observe-beats", daemon=True)
        self.thread.start()

    def _loop(self):
        while not self.stop.is_set():
            try:
                for mgr in self.managers:
                    mgr.send_heartbeat()
            except Exception as e:  # noqa: BLE001 — surfaced by close()
                self.errors.append(repr(e))
                return
            self.stop.wait(OBSERVE_BEAT_S)

    def close(self):
        self.stop.set()
        self.thread.join(timeout=10)
        check(not self.thread.is_alive(), "observe: the beat thread did not stop")
        check(not self.errors, f"observe: heartbeats failed: {self.errors}")


def _telemetry_plane(vans, posts, servers, worker, spill):
    """The scheduler ``H`` with a ``TelemetryAggregator`` (over an SLO engine
    of ``device_plane_specs`` and ``tracing_plane_specs``, spilling to
    ``spill``) and a publisher on every node; the nodes register through
    their Managers (the table broadcast wires their routes) and beat from
    then on.  Returns (aggregator, base engine, beats)."""
    from parameter_server_tpu_torch.core.fleet import FleetMonitor
    from parameter_server_tpu_torch.core.manager import Manager
    from parameter_server_tpu_torch.core.telemetry import TelemetryAggregator, TelemetryPublisher
    from parameter_server_tpu_torch.utils.slo import (
        SloEngine,
        device_plane_specs,
        tracing_plane_specs,
    )

    managers = {n: Manager(posts[n], num_workers=1, num_servers=2,
                           advertise=vans[n].address, heartbeat_timeout=60.0)
                for n in ("H", "S0", "S1", "W0")}
    sched = managers["H"]
    engine = SloEngine(device_plane_specs("w") + tracing_plane_specs())
    agg = TelemetryAggregator(slo=engine, fleet=FleetMonitor(), jsonl_path=spill)
    sched.fleet, sched.telemetry = agg.fleet, agg
    sources = {"S0": servers[0], "S1": servers[1], "W0": worker}
    for n in ("S0", "S1", "W0"):
        vans[n].add_route("H", vans["H"].address)
        managers[n].telemetry_pub = TelemetryPublisher(n, vans[n], sources=[sources[n]])
        managers[n].register_with_scheduler(wait=False)
    check(sched.wait_ready(60) and all(managers[n].wait_ready(60) for n in sources),
          "observe: the node table never arrived")
    return agg, engine, _Beats([managers[n] for n in ("S0", "S1", "W0")])


def _wait_on(predicate, seconds, what):
    """Poll ``predicate`` every 10 ms for at most ``seconds``."""
    deadline = time.monotonic() + seconds
    while not predicate():
        check(time.monotonic() < deadline, f"observe: {what} within {seconds} s")
        time.sleep(0.01)


def observe_slo_leg(torch, worker, agg):
    """Arm a serving spec the run must breach — ``ro-p99`` of the servers'
    read-only pulls at 1 ns — as the live aggregator's engine, while
    read-only pulls flow through an ``AdmissionController`` fed by the
    engine's ``healthy``: the gate must shut within the beats the p99 window
    needs (two frames of a server with read-only pulls after arming), reads
    must be shed, and once the spec is lifted (an engine without it) reads
    flow again.  ``tests/test_serving.py:291`` on the card, on live
    telemetry.  The aggregator runs an engine with no spec before the leg,
    so only the armed spec can shut the gate."""
    from parameter_server_tpu_torch.serve.admission import AdmissionController, ShedError
    from parameter_server_tpu_torch.utils.slo import SloEngine, SloSpec

    keys = np.arange(1, 4097, dtype=np.int64) * 977 % ROWS
    adm = AdmissionController(
        worker, healthy=lambda: agg.slo.healthy("S0") and agg.slo.healthy("S1"))
    _wait_on(lambda: not adm.overloaded("w"), OBSERVE_SLO_DEADLINE_S,
             f"the gate open before arming (busy: {[worker.server_busy(s) for s in ('S0', 'S1')]})")
    served = adm.pull("w", keys, timeout=60).shape[0]
    armed = SloEngine([SloSpec("ro-p99", "ro_pull.w", 1e-6, source="p99", window_s=30.0)])
    frames0 = {n: len(agg.rows(n)) for n in ("S0", "S1")}
    agg.slo = armed
    t0 = time.monotonic()
    pulls_before_shed = 0
    try:
        while True:
            check(time.monotonic() - t0 < OBSERVE_SLO_DEADLINE_S,
                  f"observe: the armed ro-p99 spec never shut the gate ({pulls_before_shed} "
                  "reads served)")
            try:
                adm.pull("w", keys, timeout=60)
                pulls_before_shed += 1
            except ShedError:
                break
            time.sleep(0.01)
        breach_s = time.monotonic() - t0
        beats = {n: len(agg.rows(n)) - frames0[n] for n in frames0}
        breached = sorted(n for n in ("S0", "S1") if not armed.healthy(n))
        check(bool(breached), "observe: shed while no server breached the armed spec")
        sheds = 0
        for _ in range(3):
            try:
                adm.pull("w", keys, timeout=60)
            except ShedError:
                sheds += 1
        check(sheds == 3 and adm.serve_shed == 4, f"observe: {adm.serve_shed} reads shed")
    finally:
        agg.slo = SloEngine([])  # the spec lifted
    t1 = time.monotonic()
    _wait_on(lambda: not adm.overloaded("w"), OBSERVE_SLO_DEADLINE_S, "the gate open again")
    recovered = adm.pull("w", keys, timeout=60).shape[0]
    check(served == recovered == keys.size, "observe: a read after recovery lost rows")
    return {"spec": {"name": "ro-p99", "metric": "ro_pull.w", "max_ms": 1e-6},
            "reads_served_after_arming": pulls_before_shed, "breached": breached,
            "frames_to_breach": beats, "seconds_to_breach": breach_s,
            "reads_shed": adm.serve_shed, "seconds_to_recover": time.monotonic() - t1,
            "recovered": True}


def observe_profile(torch, scatter, dev, batches, worker, root):
    """Two more steps of the full arm under ``torch_profile``: the exported
    Chrome trace must hold device events of ``ps_gather``
    (``move_*_kernel<0, ...>``) and ``ps_apply`` (``apply_*_kernel``), the
    symbols of ``scatter_kernels.cu``, each with a duration above 0."""
    import re

    from parameter_server_tpu_torch.utils.trace import torch_profile

    torch.cuda.synchronize()
    with torch_profile(root, device=dev) as prof:
        for keys, labels in batches[:2]:
            w_pos = worker.pull_sync("w", keys, timeout=120)
            grad, _loss = _card_grad(torch, dev, w_pos, labels)
            worker.push_sync("w", keys, grad, timeout=120)
    names = {"gather": re.compile(r"move_(dim1|rows)_kernel<(\(Move\))?0[,>]"),
             "apply": re.compile(r"apply_(dim1|rows)_kernel<")}
    out = {"trace": prof.path, "device_events": len(prof.device_events)}
    for kernel, pat in names.items():
        hits = [e for e in prof.device_events if pat.search(e["name"])]
        check(bool(hits) and all(e["dur"] > 0 for e in hits),
              f"observe profile: no {kernel} kernel with a duration in the trace "
              f"({sorted({e['name'][:60] for e in prof.device_events})[:12]})")
        out[kernel] = {"events": len(hits), "symbol": hits[0]["name"][:120],
                       "dur_us_total": sum(e["dur"] for e in hits)}
    return out


def observe_stitch(root, tids, tracers):
    """``tools/critpath.py`` over the full arm's flight-recorder dump, and
    ``tools/merge_traces.py`` over the nodes' ``Tracer`` dumps, both run as
    the user runs them.  Every sampled request of the arm (``tids``) must be
    complete — one span tree (one submit, one closing ack), every plane
    stamped, a wire segment above 0, its planes summing to its ``e2e``
    within 10% — and the merged timeline must validate, with a flow arrow
    between two nodes."""
    import json as _json
    import os

    from parameter_server_tpu_torch.core import flightrec

    bundles = flightrec.dump(os.path.join(root, "bundles"), reason="observe")
    rc, stdout, stderr = _run_tool("critpath", "--json", "--requests", "0", *bundles)
    check(rc == 0, f"observe: critpath exited {rc}: {stderr[-400:]}")
    doc = _json.loads(stdout)
    events = []
    for b in bundles:
        with open(b) as f:
            events += _json.load(f)["events"]
    subs = [e["tid"] for e in events if e.get("kind") == "trace.submit" and e["tid"] in tids]
    acks = [e["tid"] for e in events if e.get("kind") == "trace.ack" and e["tid"] in tids]
    check(sorted(subs) == sorted(acks) == sorted(tids),
          f"observe: {len(tids)} sampled, {len(subs)} submits, {len(acks)} closing acks")
    worst = 0.0
    planes = {}
    for tid in tids:
        q = doc["requests"].get(tid)
        check(q is not None and q["segments_s"] is not None, f"observe: {tid} incomplete: {q}")
        segs = q["segments_s"]
        check(segs["wire"] > 0 and all(v >= 0 for v in segs.values()),
              f"observe: {tid} segments {segs}")
        e2e = q["e2e_ms"] / 1e3
        gap = abs(segs["e2e"] - e2e) / e2e
        check(gap <= 0.1, f"observe: {tid} planes sum {segs['e2e']} s vs e2e {e2e} s")
        worst = max(worst, gap)
        for k, v in segs.items():
            planes.setdefault(k, []).append(v)
    dumps = []
    for node, tr in tracers.items():
        path = os.path.join(root, f"trace_{node}.json")
        tr.dump_chrome_trace(path, process_name=node)
        dumps.append(path)
    merged_path = os.path.join(root, "merged_trace.json")
    rc, stdout, stderr = _run_tool("merge_traces", "-o", merged_path, *dumps)
    check(rc == 0, f"observe: merge_traces exited {rc}: {stderr[-400:]}")
    with open(merged_path) as f:
        merged = _json.load(f)
    problems = _tool("merge_traces").validate_chrome_trace(merged)
    check(problems == [], f"observe: merged trace invalid: {problems[:3]}")
    flows = {}
    for e in merged["traceEvents"]:
        if e.get("ph") in ("s", "f"):
            flows.setdefault(e["id"], set()).add(e["pid"])
    cross = sum(1 for pids in flows.values() if len(pids) > 1)
    check(cross > 0, f"observe: no flow crosses nodes ({len(flows)} flows)")
    return {"critpath_rc": 0, "requests": len(tids), "complete": len(tids),
            "planes_vs_e2e_worst": worst,
            "plane_p50_ms": {k: 1e3 * float(np.median(v)) for k, v in planes.items()},
            "attribution": doc["attribution"], "bundles": len(bundles),
            "merged_flows": len(flows), "cross_node_flows": cross,
            "merged_spans": sum(1 for e in merged["traceEvents"] if e.get("ph") == "X"),
            "tracer_dumps": [os.path.basename(p) for p in dumps]}


def observe_run(torch, scatter, dev, batches, arm, sample_every, root):
    """One trace arm: 1 worker x 2 servers at config #1 width, each node on
    its own ``TcpVan`` (shm rings), ``KVWorker(trace=TraceConfig(...))`` of
    the arm (``sample_every`` 0 = ``enabled=False``); 8 steps of pull_sync
    -> card gradient -> push_sync, the first untimed.  The ``1/1`` arm also
    carries the telemetry plane (a scheduler, a publisher a node, a beat each
    0.2 s) and a ``Tracer`` on every node, and after its steps runs the SLO
    leg, the profiler hook and the stitch checks."""
    import os

    from parameter_server_tpu_torch.config import TraceConfig
    from parameter_server_tpu_torch.core import flightrec
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.tcp_van import TcpVan
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker
    from parameter_server_tpu_torch.utils.slo import SloEngine
    from parameter_server_tpu_torch.utils.trace import NULL_TRACER, Tracer

    full = sample_every == 1
    names = ("S0", "S1", "W0") + (("H",) if full else ())
    vans = {n: TcpVan() for n in names}
    tracers = {n: Tracer() for n in ("S0", "S1", "W0")} if full else {}
    trace = (TraceConfig(sample_every=sample_every) if sample_every
             else TraceConfig(enabled=False))
    servers, beats = [], None
    try:
        posts = {n: Postoffice(n, vans[n]) for n in names}
        tables = _config1_tables()
        servers = [KVServer(posts[f"S{s}"], tables, s, 2, device=dev,
                            tracer=tracers.get(f"S{s}", NULL_TRACER)) for s in range(2)]
        worker = KVWorker(posts["W0"], tables, 2, device=dev, trace=trace,
                          tracer=tracers.get("W0", NULL_TRACER))
        if full:
            spill = os.path.join(root, "telemetry.jsonl")
            agg, base, beats = _telemetry_plane(vans, posts, servers, worker, spill)
        else:
            for s in ("S0", "S1"):
                vans["W0"].add_route(s, vans[s].address)
        seq0 = flightrec.get().events()[-1]["seq"] if len(flightrec.get()) else -1
        out = _timed_steps(torch, scatter, dev, batches, worker)
        check(vans["W0"].flush(10), f"observe {arm}: the worker's van did not settle")
        _wait_on(lambda: worker.trace_closed == worker.trace_samples, 10,
                 f"{arm}: every sampled request closed")
        data_vans = [vans[n] for n in ("S0", "S1", "W0")]
        out.update(arm=arm, pushes=sum(s.pushes for s in servers),
                   pull_retries=worker.pull_retries,
                   trace_samples=worker.trace_samples, trace_closed=worker.trace_closed,
                   payload_bytes_sent=sum(v.payload_bytes_sent() for v in data_vans),
                   shm_frames_sent=sum(v.counters()["shm_frames_sent"] for v in data_vans),
                   planes=[(e["value"], [e["state"][k] for k in sorted(e["state"])])
                           for e in (s.export_shard()["w"] for s in servers)])
        if not full:
            return out
        tids = sorted({e["tid"] for e in flightrec.get().events_since(seq0)
                       if e.get("kind") == "trace.submit" and e.get("node") == "W0"})
        out["sampled_tids"] = len(tids)
        # the live plane: frames from every node, deduped, rendered by pstop
        _wait_on(lambda: all(len(agg.rows(n)) >= 3 for n in ("S0", "S1", "W0")), 10,
                 "three telemetry frames from every node")
        # the base engine's verdicts, read once the scheduler stopped feeding
        # it (an engine is fed and evaluated from one thread at a time)
        agg.slo = SloEngine([])
        frames = {n: len(agg.rows(n)) for n in ("S0", "S1", "W0")}
        _wait_on(lambda: all(len(agg.rows(n)) >= frames[n] + 2 for n in frames), 10,
                 "two frames a node after the base engine was detached")
        out["verdicts"] = {n: {"healthy": v.healthy, "observed": v.observed,
                               "breaches": v.breaches}
                           for n, v in base.evaluate().items()}
        out["slo"] = observe_slo_leg(torch, worker, agg)
        beats.close()
        beats = None
        agg.flush_jsonl()
        drops = {n: agg.drops(n) for n in ("S0", "S1", "W0")}
        check(agg.counters()["telemetry_dup_frames"] == 0 and not any(drops.values()),
              f"observe: telemetry dedup drops {agg.counters()} {drops}")
        latest = agg.latest()
        rc, stdout, stderr = _run_tool("pstop", "--once", spill)
        check(rc == 0 and all(n in stdout for n in ("S0", "S1", "W0")),
              f"observe: pstop exited {rc}: {stderr[-300:]}")
        out["telemetry"] = {
            "frames": {n: len(agg.rows(n)) for n in ("S0", "S1", "W0")},
            "counters": agg.counters(), "drops": drops, "pstop_rc": rc,
            "pstop": stdout.strip().splitlines()[:6],
            "digests": {n: sorted(latest[n].get("digests", {})) for n in latest},
            "w0_trace_e2e": latest["W0"].get("digests", {}).get("trace.e2e")}
        out["stitch"] = observe_stitch(root, tids, tracers)
        out["profile"] = observe_profile(torch, scatter, dev, batches, worker, root)
        out["spans"] = {n: {k: v["count"] for k, v in tr.summary().items()}
                        for n, tr in tracers.items()}
        return out
    finally:
        if beats is not None:
            beats.stop.set()
            beats.thread.join(timeout=10)
        for v in vans.values():
            v.close()
        for srv in servers:
            if srv.ledger is not None:
                srv.ledger.close()
            srv.tables.clear()
        servers.clear()
        import gc

        gc.collect()
        torch.cuda.empty_cache()


def observe_mfu_leg(torch, dev):
    """DLRM at the 2^22 control's shape (2^22 x 16 AdaGrad, batch 8192, 4
    steps) twice from one seed, once counting its MFU and once with the count
    replaced by nothing: the losses, the table and the MLP bitwise equal (the
    count runs on ``meta`` copies and executes nothing on the live state)."""
    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
    from parameter_server_tpu_torch.data.synthetic import SyntheticDLRM
    from parameter_server_tpu_torch.models.dlrm import SpmdDLRMTrainer
    from parameter_server_tpu_torch.utils import metrics as metrics_lib

    rows = 1 << DLRM_CONTROL_LOG2
    cfg = TableConfig(name="emb", rows=rows, dim=DLRM_DIM,
                      optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.05))
    stream = SyntheticDLRM(key_space=rows, batch_size=DLRM_BATCH, seed=3)
    batches = [stream.next_batch() for _ in range(DLRM_STEPS)]
    real = metrics_lib.counted_flops_by_kind
    runs = {}
    for arm in ("counted", "not_counted"):
        if arm == "not_counted":
            metrics_lib.counted_flops_by_kind = lambda *a, **k: {"conv": 0.0, "matmul": 0.0}
        try:
            tr = SpmdDLRMTrainer(cfg, device=dev, learning_rate=0.01,
                                 min_bucket=DLRM_MIN_BUCKET, table_init="normal")
            losses = [tr.step(*b) for b in batches]
        finally:
            metrics_lib.counted_flops_by_kind = real
        runs[arm] = (losses, tr)
    (la, ta), (lb, tb) = runs["counted"], runs["not_counted"]
    same = (la == lb and torch.equal(ta.emb_value, tb.emb_value)
            and all(torch.equal(ta.emb_state[k], tb.emb_state[k]) for k in ta.emb_state)
            and all(torch.equal(p, q) for p, q in zip(ta.model.parameters(),
                                                       tb.model.parameters())))
    check(same, f"observe mfu: losses {la} counted vs {lb} not counted")
    check(ta.dashboard.flops_per_example > 0 and tb.dashboard.flops_per_example == 0,
          "observe mfu: the count did not run in one arm only")
    return {"rows_log2": DLRM_CONTROL_LOG2, "batch": DLRM_BATCH, "steps": DLRM_STEPS,
            "losses": la, "bitwise_equal": True,
            "flops_per_example": ta.dashboard.flops_per_example,
            "precision": ta.dashboard.precision}


def observe_scenario():
    """The war game's ``smoke_scenario(seed=0)`` through the port's runner on
    this host (no JAX): its scorecard written and complete, and the incident
    report's tool-derived sections (``tools/postmortem.py`` chain,
    ``tools/critpath.py`` attribution) present."""
    import json as _json
    import os

    from parameter_server_tpu_torch.scenario import ScenarioRunner, render_report, smoke_scenario
    from parameter_server_tpu_torch.scenario.scorecard import scorecard_json

    runner = ScenarioRunner(smoke_scenario(OBSERVE_SCENARIO_SEED))
    try:
        t0 = time.perf_counter()
        card = runner.run()
        seconds = time.perf_counter() - t0
        report = render_report(runner, card)
    finally:
        runner.close()
    path = os.path.join(_observe_root(), "scorecard.json")
    with open(path, "w") as f:
        f.write(scorecard_json(card))
    with open(path) as f:
        written = _json.load(f)
    check(set(card) == {"scenario", "fleet", "slo", "totals", "autoscaler", "telemetry"}
          and written == _json.loads(scorecard_json(card)),
          f"observe scenario: scorecard keys {sorted(card)}")
    text = "\n".join(report)
    for section in ("-- worst breach window:", "postmortem chain (worst breach window):",
                    "critpath attribution"):
        check(section in text, f"observe scenario: report lacks {section!r}")
    check(card["slo"]["breach_minutes"] > 0 and card["telemetry"]["dedup_drops"] == 0,
          f"observe scenario: {card['slo']['breach_minutes']} breach-minutes, "
          f"{card['telemetry']['dedup_drops']} dedup drops")
    return {"seed": OBSERVE_SCENARIO_SEED, "seconds": seconds,
            "breach_minutes": card["slo"]["breach_minutes"], "totals": card["totals"],
            "actions": len(card["autoscaler"]["actions"]),
            "telemetry": card["telemetry"], "report_lines": len(report),
            "report_head": report[:4]}


def observe_phase(torch, scatter, dev, errs, clean):
    """The observability plane at config #1 width (see the module docstring):
    the three trace arms, each bitwise equal to the ``wire`` phase's clean
    run; then the MFU count's no-effect leg and the war game.  Returns
    (fields, launches of the three arms)."""
    import os
    import shutil

    t_phase = time.perf_counter()
    root = _observe_root()
    shutil.rmtree(root, ignore_errors=True)
    os.makedirs(root)
    batches = wire_batches()
    total = dict.fromkeys(REPLACES, 0)
    runs = {}
    try:
        with PlanesTap(torch, scatter) as planes, ApplyTap(torch, scatter) as applies:
            for arm, every in OBSERVE_ARMS:
                applies.seen.clear()  # hold each run's first apply on every table
                runs[arm] = observe_run(torch, scatter, dev, batches, arm, every, root)
                for name in total:
                    total[name] += runs[arm]["launches"][name]
            out = {"rows": ROWS, "dim": DIM, "batch": BATCH, "nnz": NNZ, "steps": WIRE_STEPS,
                   "workers": 1, "servers": 2, "beat_s": OBSERVE_BEAT_S}
            for arm, r in runs.items():
                _same_tables(clean, r, f"observe {arm}", "clean")
                check(r["launches"]["gather"] == r["launches"]["apply"] == 2 * WIRE_STEPS,
                      f"observe {arm}: launches {r['launches']}")
                check(r["shm_frames_sent"] > 0, f"observe {arm}: no frame on an shm ring")
            off, some, every = runs["off"], runs["1/1024"], runs["1/1"]
            check(off["trace_samples"] == 0, f"observe off: {off['trace_samples']} sampled")
            bytes_gap = abs(some["payload_bytes_sent"] - off["payload_bytes_sent"]) / \
                off["payload_bytes_sent"]
            check(bytes_gap <= 0.01, f"observe 1/1024: wire bytes {some['payload_bytes_sent']} "
                  f"vs off {off['payload_bytes_sent']}")
            check(every["trace_samples"] == every["trace_closed"] > 0
                  and every["sampled_tids"] == every["trace_samples"],
                  f"observe 1/1: {every['trace_samples']} sampled, {every['trace_closed']} "
                  f"closed, {every['sampled_tids']} submits")
            for arm, r in runs.items():
                row = {k: r[k] for k in ("examples_per_s", "timed_s", "launches", "pushes",
                                         "trace_samples", "trace_closed",
                                         "payload_bytes_sent")}
                row["examples_per_s_over_off"] = r["examples_per_s"] / off["examples_per_s"]
                row["loss_first"], row["loss_last"] = map(float, r["losses"][[0, -1]])
                row["pull_p50_ms"], row["push_p50_ms"] = _p50_ms(r["pull_s"]), _p50_ms(r["push_s"])
                emit("observe_trace_" + arm.replace("/", "_"), **row)
                out[arm] = row
            out["wire_bytes_1_1024_vs_off"] = bytes_gap
            for k in ("verdicts", "slo", "telemetry", "stitch", "profile", "spans"):
                out[k] = every[k]
                emit("observe_" + k, **(every[k] if isinstance(every[k], dict) else {k: every[k]}))
            out["gather_check"] = planes.result(errs, "gather")
            check(len(applies.records) == 2 * len(OBSERVE_ARMS),
                  f"{len(applies.records)} applies held, expected {2 * len(OBSERVE_ARMS)}")
            out["apply_check"] = applies.result(errs, len(applies.records))
        runs.clear()
        torch.cuda.empty_cache()
        out["mfu_count"] = observe_mfu_leg(torch, dev)
        emit("observe_mfu_count", **out["mfu_count"])
        torch.cuda.empty_cache()
        out["scenario"] = observe_scenario()
        emit("observe_scenario", **out["scenario"])
    finally:
        shutil.rmtree(root, ignore_errors=True)
    out["launches"] = total
    out["phase_s"] = time.perf_counter() - t_phase
    return out, total


# ---------------------------------------------------------------------------
# phase 9
# ---------------------------------------------------------------------------


def _time_ms(torch, fn, reps=200, warmup=10):
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _graph_ms(torch, fn, per_graph=20, replays=20):
    """Device time per call: ``per_graph`` calls captured in one CUDA graph,
    replayed back to back, so the host's per-call cost (Python, the wrapper's
    checks, the launch) drops out and the device time remains."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capture, as capture needs
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(per_graph):
            fn()
    graph.replay()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (per_graph * replays)


def times_phase(torch, scatter, dev, errs, launches):
    from parameter_server_tpu_torch.config import OptimizerConfig
    from parameter_server_tpu_torch.kv.optim import make_optimizer
    from parameter_server_tpu_torch.kv.routing import RoutingTable
    from parameter_server_tpu_torch.kv.server import _bucket
    from parameter_server_tpu_torch.ops import _build

    keys, slots, inverse, n_unique = _main_batch_slots()
    # server 0's request of one main-path pull/push: its slice, localized and
    # bucket-padded to the trash row of its 2^21-row shard
    shard_rows = ROWS // 2
    _, _pos, ids0 = next(RoutingTable.uniform({"w": ROWS}, 2).slice_ids("w", slots))
    real = ids0[ids0 < ROWS]
    n = _bucket(int(ids0.size))
    ids_np = np.full(n, shard_rows, dtype=np.int32)
    ids_np[:real.size] = real
    u = int(np.unique(ids_np).size)  # rows this request touches (trash once)
    rng = np.random.default_rng(9)
    ids = torch.tensor(ids_np, device=dev)
    table = torch.tensor(rng.normal(size=(shard_rows + 1, DIM)), dtype=torch.float32,
                         device=dev)
    rows = torch.tensor(rng.normal(size=(n, DIM)), dtype=torch.float32, device=dev)
    rows[real.size:] = 0
    opt = make_optimizer(OptimizerConfig(kind="adagrad", learning_rate=0.05))
    sum_sq = torch.rand((shard_rows + 1, DIM), device=dev)
    sum_sq_rows = torch.rand((n, DIM), device=dev)  # a push's new sum_sq rows
    sum_sq_rows[real.size:] = 0
    idx64 = ids.long()
    f = 4  # bytes per float32 / int32

    def bound(nbytes):
        return nbytes / HBM_BYTES_PER_S * 1e3

    specs = {
        "apply": dict(
            kernel=lambda: scatter.cuda_apply(table, {"sum_sq": sum_sq}, ids, rows, opt),
            plain=lambda: scatter.apply_rows_torch(table, {"sum_sq": sum_sq}, ids, rows, opt),
            library=None,
            # ids + grads read once; value and sum_sq rows read and written once
            nbytes=f * n + f * n * DIM + 2 * 2 * f * u * DIM,
            shape=dict(n=n, dim=DIM, table_rows=shard_rows + 1, state_planes=1),
        ),
        "gather": dict(
            kernel=lambda: scatter.cuda_gather(table, ids),
            plain=lambda: scatter.gather_rows_torch(table, ids),
            library=lambda: torch.index_select(table, 0, idx64),
            nbytes=f * n + f * u * DIM + f * n * DIM,
            shape=dict(n=n, dim=DIM, table_rows=shard_rows + 1),
        ),
        "scatter_set": dict(
            kernel=lambda: scatter.cuda_scatter_set(table, ids, rows),
            plain=lambda: scatter.scatter_update_rows_torch(table, ids, rows),
            library=lambda: table.index_copy_(0, idx64, rows),
            nbytes=f * n + f * n * DIM + f * u * DIM,
            shape=dict(n=n, dim=DIM, table_rows=shard_rows + 1),
        ),
    }
    # scatter-add at its path's shape: one batch's unique slots over the
    # whole 2^22-row table (combine_and_scatter_add)
    add_ids = torch.tensor(slots, device=dev)
    add_u = int(np.unique(slots).size)
    add_table = torch.zeros((ROWS + 1, DIM), dtype=torch.float32, device=dev)
    add_rows = torch.tensor(rng.normal(size=(slots.size, DIM)), dtype=torch.float32,
                            device=dev)
    add_rows[n_unique:] = 0
    add_idx64 = add_ids.long()
    specs["scatter_add"] = dict(
        kernel=lambda: scatter.cuda_scatter_add(add_table, add_ids, add_rows),
        plain=lambda: scatter.scatter_add_rows_torch(add_table, add_ids, add_rows),
        library=lambda: add_table.index_add_(0, add_idx64, add_rows),
        nbytes=f * slots.size + f * slots.size * DIM + 2 * f * add_u * DIM,
        shape=dict(n=int(slots.size), dim=DIM, table_rows=ROWS + 1),
    )

    # kernel vs plain once more at these shapes (errors enter max_abs_err)
    base = {"table": table.clone(), "sum_sq": sum_sq.clone(), "add": add_table.clone()}
    for name in specs:
        outs = []
        for which in ("kernel", "plain"):
            table.copy_(base["table"])
            sum_sq.copy_(base["sum_sq"])
            add_table.copy_(base["add"])
            r = specs[name][which]()
            r = torch.cat([r[0], r[1]["sum_sq"]]) if name == "apply" else r
            outs.append(r[:-1].clone() if name in ("scatter_set", "scatter_add") else r.clone())
        err = float((outs[0] - outs[1]).abs().max())
        tol = 1e-5 * float(outs[1].abs().max()) + 1e-6 if name == "apply" else 0.0
        check(err <= tol, f"{name} at main shape: kernel vs plain {err}")
        errs[name] = max(errs[name], err)
    # the pull's gather as the main path runs it: value + sum_sq in one launch
    got = scatter.cuda_gather_planes([table, sum_sq], ids)
    want = [scatter.gather_rows_torch(table, ids), scatter.gather_rows_torch(sum_sq, ids)]
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(err == 0.0, f"two-plane gather at main shape: kernel vs plain {err}")
    errs["gather"] = max(errs["gather"], err)
    # the three-pass push's write-back as the main path runs it: value +
    # sum_sq in one launch
    push_planes, push_rows = [table, sum_sq], [rows, sum_sq_rows]
    got = scatter.cuda_scatter_set_planes([t.clone() for t in push_planes], ids, push_rows)
    want = [scatter.scatter_update_rows_torch(t.clone(), ids, r)
            for t, r in zip(push_planes, push_rows)]
    err = max(float((g - w).abs().max()) for g, w in zip(got, want))
    check(err == 0.0, f"two-plane scatter-set at main shape: kernel vs plain {err}")
    errs["scatter_set"] = max(errs["scatter_set"], err)

    kernels = []
    for name, spec in specs.items():
        before = scatter.launch_counts()[name]
        # "ms" columns: device time per call (CUDA-graph replay); the
        # "call_ms" columns: eager calls back to back, host cost included
        ms = _graph_ms(torch, spec["kernel"])
        check(scatter.launch_counts()[name] > before, f"{name} timing did not launch")
        plain_ms = _graph_ms(torch, spec["plain"])
        lib_ms = _graph_ms(torch, spec["library"]) if spec["library"] else None
        call = {
            "call_ms": _time_ms(torch, spec["kernel"]),
            "plain_call_ms": _time_ms(torch, spec["plain"]),
            "library_call_ms": _time_ms(torch, spec["library"]) if spec["library"] else None,
        }
        b = bound(spec["nbytes"])
        kernels.append({
            "name": name, "route": "cuda", "source": SOURCE, "replaces": REPLACES[name],
            "launches": launches[name], "max_abs_err": errs[name],
            "ms": ms, "plain_ms": plain_ms, "bound_ms": b, "bound_by": "bytes",
            "library_ms": lib_ms,
        })
        emit("times", kernel=name, ms=ms, plain_ms=plain_ms, library_ms=lib_ms,
             bound_ms=b, bytes=int(spec["nbytes"]), **call, **spec["shape"])

    # the launch floor: an empty kernel, timed the same way
    lib = _build.load_library()

    def noop():
        err = lib.ps_noop(ctypes.c_void_p(torch.cuda.current_stream().cuda_stream))
        check(err == 0, f"ps_noop launch failed: cudaError {err}")

    floor_ms = _graph_ms(torch, noop)
    emit("times", kernel="noop", ms=floor_ms)
    # one pull's gather at server 0's request: the value and sum_sq planes
    pull_ms = _graph_ms(torch, lambda: scatter.cuda_gather_planes([table, sum_sq], ids))
    pull_bytes = f * n + 2 * (f * u * DIM + f * n * DIM)
    emit("times", kernel="gather", case="pull_value_sum_sq", ms=pull_ms,
         bound_ms=bound(pull_bytes), bytes=pull_bytes, planes=2, n=n, dim=DIM)
    # one three-pass push's write-back: ids read once, each plane's rows read
    # and its touched rows written
    push_bytes = f * n + 2 * (f * n * DIM + f * u * DIM)
    push = {
        "ms": _graph_ms(torch, lambda: scatter.cuda_scatter_set_planes(push_planes, ids,
                                                                       push_rows)),
        "plain_ms": _graph_ms(torch, lambda: [scatter.scatter_update_rows_torch(t, ids, r)
                                              for t, r in zip(push_planes, push_rows)]),
        "library_ms": _graph_ms(torch, lambda: [t.index_copy_(0, idx64, r)
                                                for t, r in zip(push_planes, push_rows)]),
    }
    emit("times", kernel="scatter_set", case="push_value_sum_sq", **push,
         bound_ms=bound(push_bytes), bytes=push_bytes, planes=2, n=n, dim=DIM,
         library="index_copy_ x2")
    # the dim-1 forms against the general row kernel (float lanes) on the same
    # work: ids 4 bytes off a 16-byte boundary send a call to the latter
    ids_off = _on_card(torch, ids_np, dev, 1)
    check(not scatter._aligned(ids_off), "offset ids are aligned")
    route = {
        "gather_value_sum_sq": lambda i: scatter.cuda_gather_planes([table, sum_sq], i),
        "apply_adagrad": lambda i: scatter.cuda_apply(table, {"sum_sq": sum_sq}, i, rows, opt),
    }
    for name, fn in route.items():
        form, row = [], []
        for _ in range(2):  # interleaved: form, row, form, row
            form.append(_graph_ms(torch, lambda: fn(ids)))
            row.append(_graph_ms(torch, lambda: fn(ids_off)))
        emit("times", case="dim1_route", kernel=name, dim1_form_ms=form, row_kernel_ms=row,
             n=n, dim=DIM)
    wide = wide_times(torch, scatter, dev, errs, bound)
    for k in kernels:
        k["floor_ms"] = floor_ms
        k["wide"] = wide[k["name"]]
        if k["name"] == "scatter_set":
            k["wide_4_planes"] = wide["scatter_set_4"]
    emit("times", step="worker_precombine", **precombine_ms(torch, dev, keys))
    return kernels


def wide_times(torch, scatter, dev, errs, bound):
    """Gather (one plane), Adam apply (value + 3 planes), scatter-set of 1 and
    4 planes and scatter-add at dim 128: 32,768 unique sorted ids into a
    2^20 + 1 row table (512 MiB a plane).  Each graph cycles through 8
    disjoint id sets, so one round touches more rows than the 50 MB L2 holds
    and every call reads its rows from device memory.  The scatters run after
    the apply (scatter-set overwrites Adam's planes); scatter-set writes rows
    of its own per id set and plane, scatter-add adds the finite gradients."""
    from parameter_server_tpu_torch.config import OptimizerConfig
    from parameter_server_tpu_torch.kv.optim import make_optimizer

    rng = np.random.default_rng(13)
    perm = rng.permutation(WIDE_ROWS)[: WIDE_SETS * WIDE_N].reshape(WIDE_SETS, WIDE_N)
    id_sets = [torch.tensor(np.sort(p).astype(np.int32), device=dev) for p in perm]
    id_longs = [i.long() for i in id_sets]  # the library calls' index type
    gen = torch.Generator(device=dev).manual_seed(13)
    shape = (WIDE_ROWS + 1, WIDE_DIM)
    value = torch.randn(shape, generator=gen, device=dev)
    value[-1] = 0
    opt = make_optimizer(OptimizerConfig(kind="adam", learning_rate=0.01))
    state = {
        "m": torch.randn(shape, generator=gen, device=dev),
        "t": torch.floor(torch.rand(shape, generator=gen, device=dev) * 3),
        "v": torch.rand(shape, generator=gen, device=dev),
    }
    grads = [torch.randn((WIDE_N, WIDE_DIM), generator=gen, device=dev)
             for _ in range(WIDE_SETS)]
    f, n, d = 4, WIDE_N, WIDE_DIM

    # kernel vs plain on the first id set, every row of every plane
    got = scatter.cuda_gather(value, id_sets[0])
    err = float((got - scatter.gather_rows_torch(value, id_sets[0])).abs().max())
    check(err == 0.0, f"gather at dim {d}: kernel vs plain {err}")
    plain = scatter.apply_rows_torch(value.clone(), {k: p.clone() for k, p in state.items()},
                                     id_sets[0], grads[0], opt)
    scatter.cuda_apply(value, state, id_sets[0], grads[0], opt)
    for a, b in zip([value] + [state[k] for k in sorted(state)],
                    [plain[0]] + [plain[1][k] for k in sorted(state)]):
        aerr = float((a - b).abs().max())
        check(bool(torch.allclose(a, b, rtol=1e-5, atol=1e-6)),
              f"adam apply at dim {d}: kernel vs plain {aerr}")
        errs["apply"] = max(errs["apply"], aerr)
    del plain

    def cycle(fn):
        it = itertools.cycle(range(WIDE_SETS))
        return lambda: fn(next(it))

    specs = {
        "gather": dict(
            kernel=cycle(lambda i: scatter.cuda_gather(value, id_sets[i])),
            plain=cycle(lambda i: scatter.gather_rows_torch(value, id_sets[i])),
            library=cycle(lambda i: torch.index_select(value, 0, id_longs[i])),
            nbytes=f * n + 2 * f * n * d, planes=1,
        ),
        "apply": dict(
            kernel=cycle(lambda i: scatter.cuda_apply(value, state, id_sets[i], grads[i], opt)),
            plain=cycle(lambda i: scatter.apply_rows_torch(value, state, id_sets[i],
                                                           grads[i], opt)),
            library=None,
            # ids + grads read; value, m, t, v rows read and written once
            nbytes=f * n + f * n * d + 2 * 4 * f * n * d, planes=4,
        ),
    }
    out = {}
    _time_wide(torch, specs, out, n, d, bound)

    # scatter-set and scatter-add, kernel vs plain on the first id set, every
    # row of every plane; then timed
    planes = [value] + [state[k] for k in sorted(state)]
    set_rows = [list(torch.randn((4, n, d), generator=gen, device=dev))
                for _ in range(WIDE_SETS)]
    want = [scatter.scatter_update_rows_torch(p.clone(), id_sets[0], r)
            for p, r in zip(planes, set_rows[0])]
    scatter.cuda_scatter_set_planes(planes, id_sets[0], set_rows[0])
    err = max(float((a - b).abs().max()) for a, b in zip(planes, want))
    check(err == 0.0, f"4-plane scatter-set at dim {d}: kernel vs plain {err}")
    errs["scatter_set"] = max(errs["scatter_set"], err)
    want = scatter.scatter_add_rows_torch(value.clone(), id_sets[0], grads[0])
    scatter.cuda_scatter_add(value, id_sets[0], grads[0])
    err = float((value - want).abs().max())
    check(err == 0.0, f"scatter-add at dim {d}: kernel vs plain {err}")
    errs["scatter_add"] = max(errs["scatter_add"], err)
    del want
    specs = {
        "scatter_set": dict(
            kernel=cycle(lambda i: scatter.cuda_scatter_set(value, id_sets[i], set_rows[i][0])),
            plain=cycle(lambda i: scatter.scatter_update_rows_torch(value, id_sets[i],
                                                                    set_rows[i][0])),
            library=cycle(lambda i: value.index_copy_(0, id_longs[i], set_rows[i][0])),
            nbytes=f * n + 2 * f * n * d, planes=1,
        ),
        "scatter_set_4": dict(
            kernel=cycle(lambda i: scatter.cuda_scatter_set_planes(planes, id_sets[i],
                                                                   set_rows[i])),
            plain=cycle(lambda i: [scatter.scatter_update_rows_torch(p, id_sets[i], r)
                                   for p, r in zip(planes, set_rows[i])]),
            # four calls: no one PyTorch call writes four tables
            library=cycle(lambda i: [p.index_copy_(0, id_longs[i], r)
                                     for p, r in zip(planes, set_rows[i])]),
            nbytes=f * n + 4 * 2 * f * n * d, planes=4,
        ),
        "scatter_add": dict(
            kernel=cycle(lambda i: scatter.cuda_scatter_add(value, id_sets[i], grads[i])),
            plain=cycle(lambda i: scatter.scatter_add_rows_torch(value, id_sets[i], grads[i])),
            library=cycle(lambda i: value.index_add_(0, id_longs[i], grads[i])),
            # ids and update rows read, table rows read and written
            nbytes=f * n + 3 * f * n * d, planes=1,
        ),
    }
    _time_wide(torch, specs, out, n, d, bound)
    return out


def _time_wide(torch, specs, out, n, d, bound):
    """Time each spec's kernel, plain and library calls (2 rounds of the id
    sets per CUDA graph); record and print a row per spec into ``out``."""
    for name, spec in specs.items():
        row = {
            "ms": _graph_ms(torch, spec["kernel"], per_graph=2 * WIDE_SETS, replays=10),
            "plain_ms": _graph_ms(torch, spec["plain"], per_graph=2 * WIDE_SETS, replays=10),
            "library_ms": (_graph_ms(torch, spec["library"], per_graph=2 * WIDE_SETS,
                                     replays=10) if spec["library"] else None),
            "bound_ms": bound(spec["nbytes"]), "bytes": int(spec["nbytes"]),
        }
        out[name] = row
        emit("times", kernel=name, case="wide", n=n, dim=d, table_rows=WIDE_ROWS + 1,
             id_sets=WIDE_SETS, planes=spec["planes"], **row)


def precombine_ms(torch, dev, keys):
    """``KVWorker._prepare_push`` at the main shape (host localize, upload,
    device segment_combine, readback), and its device part alone: upload +
    ``segment_combine`` + readback.  Median of 5 after one warm-up, host
    clock."""
    from parameter_server_tpu_torch.ops.scatter import segment_combine
    from parameter_server_tpu_torch.utils.keys import HashLocalizer, localize_to_slots

    van, servers, (worker,) = build_cluster(torch, dev, rows=ROWS, fused=True,
                                            n_workers=1)
    try:
        grads = np.random.default_rng(3).normal(size=keys.shape).astype(np.float32)
        slots, inverse, _n = localize_to_slots(keys, HashLocalizer(ROWS), min_bucket=256)

        def device_part():
            segment_combine(torch.tensor(grads.reshape(-1, 1), device=dev),
                            torch.tensor(inverse, device=dev), slots.shape[0]).cpu()

        out = {}
        for name, fn in (("prepare_push_ms", lambda: worker._prepare_push("w", keys, grads)),
                         ("device_combine_ms", device_part)):
            samples = []
            for _ in range(6):
                torch.cuda.synchronize()
                t0 = time.perf_counter()
                fn()
                samples.append((time.perf_counter() - t0) * 1e3)
            out[name] = float(np.median(samples[1:]))
        out["positions"] = int(keys.size)
        return out
    finally:
        close_cluster(van, servers)


if __name__ == "__main__":
    sys.exit(main())
