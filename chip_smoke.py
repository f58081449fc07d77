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
             flatness ratio.
   dlrm_profile  ``torch.profiler`` over 3 steps: device busy, idle share,
             top device ops, the segment sum's share.
   dlrm_reference  the test's shape (2^14 x 16, batch 256) from one state on
             the card twice and on the CPU, both TF32 flags off: 1 step within
             1e-5, 5 steps within 1e-4, the two card runs bitwise equal.
   dense_spmd  BASELINE config #2: ``SpmdDenseTrainer`` with ResNet-50 (224 x
             224, 1000 classes, one fixed batch of 64, SGD momentum 0.9):
             images/s, peak memory, the loss falling, 2 steps profiled; a
             tiny ResNet on the card and the CPU, TF32 off, within 1e-4.
   dense_async  ``AsyncDenseLearner``, 2 workers x 2 servers (``DenseKVServer``
             on the card) on ``MeteredVan(LoopbackVan())`` under BSP,
             ResNet-50, a fixed batch of 64 each: images/s, PUSH and PULL
             bytes a step, the loss falling, BatchNorm statistics local; 2
             more steps profiled.
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
    del batches
    torch.cuda.empty_cache()

    # -- 9. times ----------------------------------------------------------------
    kernels = times_phase(torch, scatter, dev, errs, launches)
    for k in kernels:
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
    profiled = _device_profile(torch, lambda: [tr.step(*batch) for _ in range(2)], top_n=12)
    del tr
    return {"model": "resnet50", "hw": RESNET_HW, "classes": RESNET_CLASSES,
            "batch": RESNET_BATCH, "warm_steps": DENSE_WARM, "timed_steps": DENSE_TIMED,
            "lr": DENSE_LR, "tf32": _tf32_flags(torch), "wall_s": wall,
            "images_per_s": DENSE_TIMED * RESNET_BATCH / wall,
            "ms_per_step": wall * 1e3 / DENSE_TIMED, "losses": losses,
            "peak_memory_bytes": peak, "profile_2_steps": profiled,
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
