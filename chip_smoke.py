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
             deterministic).
4. three_pass  the same loop with ``fused_apply=False``: one scatter-set
             launch (value + sum_sq) per push.
5. bundled   ``handle_request_batch`` at the apply-engine shape (16 x 2048
             ids from a 2048-row hot set, dim 128, Adam, 2^15 rows) under both
             duplicate policies, twice each: bitwise-equal tables, and close
             to the same bundle on the CPU.
6. combine   ``combine_and_scatter_add`` on one batch's slots (scatter-add).
7. local     bench.py's headline path at full width: ``LocalLRTrainer(mode=
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
8. times     every kernel at the main path's shapes: device time per call
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
#: the local (single-device) path: steps per block, distinct blocks in the
#: pool, warm-up and timed blocks, steps of the reference and rows legs
BLOCK, LOCAL_POOL, LOCAL_WARM, LOCAL_TIMED = 32, 4, 2, 8
LOCAL_REF_STEPS, LOCAL_ROWS_STEPS = 4, 4
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
    from parameter_server_tpu_torch.ops import _build, scatter

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
         trash_rows_at_fill=True, tables_on=main["devices"])
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

    # -- 7. the local (single-device) path ------------------------------------------
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
    del trainer, state

    # -- 8. times ----------------------------------------------------------------
    kernels = times_phase(torch, scatter, dev, errs, launches)
    for k in kernels:
        if k["name"] in ("apply", "gather"):
            k["local_rows_launches"] = rows["launches"][k["name"]]
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


def build_cluster(torch, device, *, rows, fused, n_workers, min_bucket=256):
    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker

    cfgs = {"w": TableConfig(
        name="w", rows=rows, dim=DIM,
        optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.05),
        fused_apply=fused,
    )}
    van = LoopbackVan()
    servers = [KVServer(Postoffice(f"S{i}", van), cfgs, i, 2, device=device)
               for i in range(2)]
    workers = [KVWorker(Postoffice(f"W{i}", van), cfgs, 2, min_bucket=min_bucket,
                        device=device)
               for i in range(n_workers)]
    return van, servers, workers


def run_loop(torch, dev, *, fused, steps):
    from parameter_server_tpu_torch.config import ConsistencyConfig
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
    from parameter_server_tpu_torch.learner.sgd import AsyncLRLearner

    van, servers, workers = build_cluster(torch, dev, rows=ROWS, fused=fused, n_workers=2)
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
        return {"losses": losses, "examples_per_s": 2 * steps * BATCH / wall,
                "devices": devices, "pulls": sum(srv.pulls for srv in servers),
                "pushes": sum(srv.pushes for srv in servers)}
    finally:
        van.close()


def profile_loop(torch, dev, steps=2):
    """Device busy time and idle share over ``steps`` BSP steps of the main
    path under ``torch.profiler`` (a fresh cluster, after one warm step)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parameter_server_tpu_torch.config import ConsistencyConfig
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
    from parameter_server_tpu_torch.learner.sgd import AsyncLRLearner

    van, _servers, workers = build_cluster(torch, dev, rows=ROWS, fused=True, n_workers=2)
    try:
        data = [SyntheticCTR(key_space=KEY_SPACE, nnz=NNZ, batch_size=BATCH, seed=20 + i,
                             informative=0.1) for i in range(2)]
        AsyncLRLearner(workers, ConsistencyConfig(), device=dev).run(
            [d.next_batch for d in data], 1, timeout=300)
        learner = AsyncLRLearner(workers, ConsistencyConfig(), device=dev)
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            learner.run([d.next_batch for d in data], steps, timeout=300)
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    finally:
        van.close()
    on_device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:6]
    return {
        "steps": steps, "wall_ms": wall_ms,
        "device_busy_ms": busy_ms if on_device else "not measured",
        "device_idle_share": 1 - busy_ms / wall_ms if on_device else "not measured",
        "top_device_ms": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                          for e in top],
    }


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
            van.close()
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
            van.close()
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
# phase 7: the local (single-device) path
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
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from parameter_server_tpu_torch.data.prefetch import PrefetchPipeline
    from parameter_server_tpu_torch.models import linear
    from parameter_server_tpu_torch.ops.scatter import segment_combine

    with PrefetchPipeline(lambda i: pool[(i + 2) % LOCAL_POOL], depth=2, device=dev) as pf:
        trainer.step_block_device(*pf.get())
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(blocks):
                trainer.step_block_device(*pf.get())
            torch.cuda.synchronize()
            wall_ms = (time.perf_counter() - t0) * 1e3
    on_device = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    busy_ms = sum(e.self_device_time_total for e in on_device) / 1e3
    top = sorted(on_device, key=lambda e: -e.self_device_time_total)[:10]
    seg_ms = sum(e.self_device_time_total for e in on_device
                 if "segment_reduce" in e.key) / 1e3
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
    return {
        "blocks": blocks, "steps": blocks * BLOCK, "wall_ms": wall_ms,
        "examples_per_s": blocks * BLOCK * BATCH / (wall_ms / 1e3),
        "device_busy_ms": busy_ms if on_device else "not measured",
        "device_idle_share": 1 - busy_ms / wall_ms if on_device else "not measured",
        "segment_sum_share": seg_ms / busy_ms if on_device else "not measured",
        "top_device_ms": [[e.key[:70], e.self_device_time_total / 1e3, e.count]
                          for e in top],
        "segment_sum_one_batch": seg,
    }


# ---------------------------------------------------------------------------
# phase 8
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

    van, _servers, (worker,) = build_cluster(torch, dev, rows=ROWS, fused=True,
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
        van.close()


if __name__ == "__main__":
    sys.exit(main())
