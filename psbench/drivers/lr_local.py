"""Driver of the single-card sparse LR cells: the port's ``LocalLRTrainer``
in dense mode with the device hash, fed blocks of batches by
``PrefetchPipeline`` into ``step_block_device`` (``bench.py``'s headline
loop).  One window step is one block.

Set-up makes the ``ctr`` pool on the card from the seed, counts each
batch's unique slots (the roofline's bytes), keeps the pool on the host as
the pipeline's source, builds the trainer and drives it through the first
``checked_blocks`` blocks of the pool, reading what the comparison needs.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from psbench import compare, traffic
from psbench.reference import lr as reference

RATE = "examples_per_s"
#: blocks of the pool the reference follows (rows all differ between them)
CHECKED_BLOCKS = 3


class Driver:
    def __init__(self, torch, cfg: dict, workload: dict, seed: int, device, tracer=None):
        self.torch, self.cfg, self.seed, self.device = torch, cfg, seed, torch.device(device)
        self.params = workload["traffic"]
        if self.params["pool_blocks"] < CHECKED_BLOCKS:
            raise ValueError(f"the pool needs at least {CHECKED_BLOCKS} distinct blocks")
        self.examples_per_block = self.params["block"] * self.params["batch"]

    # -- set-up --------------------------------------------------------------
    def setup(self) -> None:
        torch, cfg, p = self.torch, self.cfg, self.params
        from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
        from parameter_server_tpu_torch.data.prefetch import PrefetchPipeline
        from parameter_server_tpu_torch.learner.sgd import LocalLRTrainer

        if p["generator"] != "ctr":
            raise ValueError(f"the lr_local driver reads ctr traffic, not {p['generator']!r}")
        t0 = time.perf_counter()
        keys, labels = traffic.ctr_blocks(torch, p, self.seed, self.device)
        slots = reference.slots(keys, cfg["table_rows"], cfg["hash_seed"])
        #: unique slots of each batch of the pool [P, K] (the bytes a step needs)
        self.unique = torch.tensor([[torch.unique(slots[i, k]).numel()
                                     for k in range(p["block"])]
                                    for i in range(p["pool_blocks"])])
        self.pool = [(keys[i].cpu().numpy(), labels[i].cpu().numpy())
                     for i in range(p["pool_blocks"])]
        del keys, labels, slots
        t1 = time.perf_counter()
        opt = cfg["optimizer"]
        if cfg["init"] != "zeros" or opt["kind"] != "adagrad":
            raise ValueError("the lr_local driver runs a zero-initialised AdaGrad table")
        table = TableConfig(name="w", rows=cfg["table_rows"], dim=cfg["dim"],
                            optimizer=OptimizerConfig(kind="adagrad",
                                                      learning_rate=opt["learning_rate"],
                                                      eps=opt["eps"], l1=opt["l1"],
                                                      l2=opt["l2"]))
        self.trainer = LocalLRTrainer(table, mode=cfg["mode"], device_hash=cfg["device_hash"],
                                      device=self.device)
        if self.trainer.localizer.seed != cfg["hash_seed"]:
            raise ValueError("the trainer's hash seed is not the configuration's")
        pool = self.pool
        self.pipeline = PrefetchPipeline(lambda i: pool[i % len(pool)],
                                         depth=p["prefetch_depth"], device=self.device)
        self.blocks = 0
        t2 = time.perf_counter()
        self.readings = self._first_blocks()
        self.phases = {"traffic": t1 - t0, "program": t2 - t1,
                       "checked_blocks": time.perf_counter() - t2}

    def _first_blocks(self) -> dict:
        torch, tr, rows = self.torch, self.trainer, self.cfg["table_rows"]
        losses, grad, levels = [], {}, None
        for b in range(CHECKED_BLOCKS):
            losses.append(self._block())
            if b == 0:
                sum_sq, bias_sq = tr.table.state["sum_sq"][:rows, 0], tr.bias_state["sum_sq"]
                grad = {"table": float(torch.sqrt(sum_sq.double().sum())),
                        "bias": float(torch.sqrt(bias_sq.double().sum()))}
                levels = compare.write_levels(sum_sq)
        change = {"table": float(torch.linalg.vector_norm(tr.table.value[:rows].double())),
                  "bias": float(tr.bias.double().abs().sum())}
        return {"losses": torch.cat(losses).tolist(), "grad": grad, "change": change,
                "rows": levels}

    def _block(self):
        self.blocks += 1
        return self.trainer.step_block_device(*self.pipeline.get())

    # -- the window -------------------------------------------------------------
    def window_start(self) -> None:
        self._losses, self._first = [], self.blocks
        self._stall0 = self.pipeline.counters()["prefetch_stall_s"]

    def step(self) -> int:
        self._losses.append(self._block())
        return self.examples_per_block

    def sync(self) -> None:
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def window_end(self) -> dict:
        """The window's counts, for ``attempted`` / ``failed`` and the
        per-layer readers."""
        self.sync()
        losses = self.torch.cat(self._losses)
        pool_ids = [i % len(self.pool) for i in range(self._first, self.blocks)]
        return {
            "steps": int(losses.numel()),
            "failed": int((~self.torch.isfinite(losses)).sum()),
            "batch": self.params["batch"], "nnz": self.params["nnz"],
            "unique_slots": int(self.unique[pool_ids].sum()),
            "prefetch_stall_s": self.pipeline.counters()["prefetch_stall_s"] - self._stall0,
        }

    # -- after the window -------------------------------------------------------
    def free(self) -> None:
        """Stop the pipeline and drop the program's state (what set-up built
        of it, where set-up failed)."""
        if hasattr(self, "pipeline"):
            self.pipeline.close()
        self.__dict__.pop("pipeline", None)
        self.__dict__.pop("trainer", None)
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def reference(self, **control) -> dict:
        """The reference's readings over the checked blocks (``control``:
        ``precision`` / ``half_batch``, for the control and the faults)."""
        torch = self.torch
        keys = torch.from_numpy(np.stack([k for k, _ in self.pool[:CHECKED_BLOCKS]]))
        labels = torch.from_numpy(np.stack([y for _, y in self.pool[:CHECKED_BLOCKS]]))
        return reference.train(self.cfg, keys.to(self.device), labels.to(self.device),
                               **control)

    #: the control: the reference in the precision below float32's
    CONTROL = {"precision": "bfloat16"}
