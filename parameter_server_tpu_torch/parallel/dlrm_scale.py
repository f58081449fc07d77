"""Step a largest-that-fits DLRM table on one card for real.

Torch counterpart of ``parameter_server_tpu/parallel/dlrm_scale.py``: it
allocates the embedding table's value and optimizer-state planes on the
device and drives real train steps through ``SpmdDLRMTrainer`` — one gather
launch for every plane at the batch's unique rows, MLP forward and backward,
the row-wise optimizer, one scatter-set launch back — recording init and
step wall times and the touched-rows traffic model::

    python -m parameter_server_tpu_torch.parallel.dlrm_scale \\
        --rows-log2 28 --dim 16 --batch 8192 --steps 4

At the default shape the table is 32 GiB: two planes (value and AdaGrad's
``sum_sq``) of (2^28 + 1) x 16 float32, 40% of an 80 GB card.  Per-step
memory stays O(batch): the step touches only the bucketed unique rows, never
the table.  One card runs the JAX package's ``--mesh`` as ``1,1`` only.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import numpy as np
import torch


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def scale_run(rows_log2: int = 28, dim: int = 16, batch: int = 8192, steps: int = 4,
              min_bucket: int = 1 << 14, table_init: str = "zeros",
              device: str | torch.device = "cuda"):
    """Build the trainer and step it ``steps + 1`` times (the first is a warm
    step).  Returns ``(result dict, trainer)``."""
    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
    from parameter_server_tpu_torch.data.synthetic import SyntheticDLRM
    from parameter_server_tpu_torch.models.dlrm import SpmdDLRMTrainer
    from parameter_server_tpu_torch.utils.keys import localize_to_slots

    device = torch.device(device)
    rows = 1 << rows_log2
    cfg = TableConfig(
        name="emb", rows=rows, dim=dim,
        optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.05),
    )
    t0 = time.perf_counter()
    trainer = SpmdDLRMTrainer(cfg, device=device, learning_rate=0.01,
                              min_bucket=min_bucket, table_init=table_init)
    _sync(device)
    init_s = time.perf_counter() - t0
    # table accounting straight from the tensors, not arithmetic
    table_bytes = trainer.emb_value.nbytes + sum(p.nbytes for p in trainer.emb_state.values())

    stream = SyntheticDLRM(key_space=rows, batch_size=batch, seed=3)
    losses, step_ms, uniq, slot_counts = [], [], [], []
    for i in range(steps + 1):  # +1 warm step
        keys, dense, labels = stream.next_batch()
        t0 = time.perf_counter()
        loss = trainer.step(keys, dense, labels)
        dt = (time.perf_counter() - t0) * 1e3
        if i:  # step 0 pays the first launches
            step_ms.append(dt)
            losses.append(loss)
            uniq.append(len(np.unique(keys)))
            # the step gathers and scatters the BUCKETED slot array (padded to
            # a power of two), not just the unique keys: count what the
            # device touches
            slots, _inv, _n = localize_to_slots(keys, trainer.localizer,
                                                min_bucket=trainer.min_bucket)
            slot_counts.append(slots.shape[0])
        else:
            compile_ms = dt
    mean_slots = float(np.mean(slot_counts))
    n_planes = 1 + len(trainer.emb_state)
    # touched-rows traffic: (value + state planes) x (read + write)
    bytes_per_step = mean_slots * dim * 4 * n_planes * 2
    out = {
        "rows_log2": rows_log2,
        "dim": dim,
        "mesh": {"data": 1, "model": 1},
        "batch": batch,
        "table_gib": round(table_bytes / 2**30, 2),
        "shard_gib_per_device": round(table_bytes / 2**30, 3),
        "init_s": round(init_s, 1),
        "compile_ms": round(compile_ms, 0),
        "step_ms_median": round(float(np.median(step_ms)), 1),
        "step_ms": [round(x, 1) for x in step_ms],
        "unique_rows_per_step": round(float(np.mean(uniq)), 0),
        "gathered_slots_per_step": round(mean_slots, 0),
        "touched_mb_per_step": round(bytes_per_step / 1e6, 2),
        "losses": [round(x, 4) for x in losses],
        "backend": device.type,
    }
    return out, trainer


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    p.add_argument("--rows-log2", type=int, default=28)
    p.add_argument("--dim", type=int, default=16)
    p.add_argument("--mesh", default="1,1",
                   help="data,model shape; one card runs 1,1 only")
    p.add_argument("--batch", type=int, default=8192)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--min-bucket", type=int, default=1 << 14)
    p.add_argument("--table-init", default="zeros", choices=["zeros", "normal"],
                   help="zeros = memset-speed bring-up (the layout and step are "
                   "identical)")
    p.add_argument("--device", default="cuda")
    args = p.parse_args(argv)
    if tuple(int(x) for x in args.mesh.split(",")) != (1, 1):
        p.error(f"--mesh {args.mesh}: one card runs 1,1 only")
    out, _trainer = scale_run(args.rows_log2, args.dim, args.batch, args.steps,
                              args.min_bucket, args.table_init, args.device)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
