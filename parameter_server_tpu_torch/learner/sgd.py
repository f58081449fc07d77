"""SGD learners: the single-device LR trainer and the asynchronous PS loop.

Torch counterpart of ``parameter_server_tpu/learner/sgd.py``:

- :class:`LocalLRTrainer`: the table lives on ``device`` and each step is
  one :mod:`~parameter_server_tpu_torch.models.linear` step updating it in
  place: rows mode (host dedup, one gather launch and the fused apply
  kernel per step) or dense mode (per-position hashed slots, full-table
  elementwise apply), optionally hashing raw 32-bit keys on the device and
  running K steps per call (``step_block``).  This is the bench path.
- :class:`AsyncLRLearner`: N worker threads each run
  ``wait_turn -> pull(w) -> grad -> push(g) -> advance`` through a
  :class:`~parameter_server_tpu_torch.kv.worker.KVWorker`, gated by a
  :class:`~parameter_server_tpu_torch.core.clock.ConsistencyController`
  (BSP/SSP/ASP).  The gradient is computed on ``device``.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch.config import ConsistencyConfig, TableConfig
from parameter_server_tpu_torch.core.clock import ConsistencyController
from parameter_server_tpu_torch.data.prefetch import host_tensor
from parameter_server_tpu_torch.kv.optim import require_dense_apply
from parameter_server_tpu_torch.kv.table import KVTable
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.models import linear
from parameter_server_tpu_torch.utils import metrics as metrics_lib
from parameter_server_tpu_torch.utils.keys import (
    HashLocalizer,
    ensure_uint32_keys,
    localize_to_slots,
)
from parameter_server_tpu_torch.utils.threads import run_threads
from parameter_server_tpu_torch.utils.trace import NULL_TRACER

Batch = Tuple[np.ndarray, np.ndarray]  # (keys [B, nnz], labels [B])
BatchFn = Callable[[], Batch]


class LocalLRTrainer:
    """Single-device sparse LR: fused pull + grad + apply per step."""

    def __init__(
        self,
        table_cfg: TableConfig,
        *,
        min_bucket: int = 1024,
        dashboard: Optional[metrics_lib.Dashboard] = None,
        mode: str = "rows",
        device_hash: bool = False,
        tracer=None,
        device: str | torch.device = "cuda",
    ) -> None:
        """``mode="rows"``: bucketed-unique gather/apply/scatter (general).
        ``mode="dense"``: per-position hashed slots + full-table apply — no
        host dedup; requires l1 == l2 == 0 and a g=0-stable optimizer.
        ``device_hash``: hash raw uint32 keys on the device (dense mode);
        :meth:`step_block` runs K steps per call.  ``tracer``: the dense
        steps' spans (``lr.hash``, ``lr.forward``, ``lr.segment_sum``,
        ``lr.apply``)."""
        if table_cfg.dim != 1:
            raise ValueError("LR weight table must have dim=1")
        if mode not in ("rows", "dense"):
            raise ValueError(f"unknown mode {mode!r}")
        if mode == "dense":
            require_dense_apply(table_cfg.optimizer)
        if device_hash and mode != "dense":
            raise ValueError("device_hash requires mode='dense'")
        self.mode = mode
        self.device_hash = device_hash
        self.cfg = table_cfg
        self.device = torch.device(device)
        self.table = KVTable(table_cfg, device=self.device)
        self.optimizer = self.table.optimizer
        self.localizer = HashLocalizer(
            table_cfg.rows, hash_bits=32 if device_hash else 64
        )
        self.min_bucket = min_bucket
        self.bias = torch.zeros((1, 1), dtype=torch.float32, device=self.device)
        self.bias_state = {
            k: torch.zeros((1, 1), dtype=torch.float32, device=self.device)
            for k in self.optimizer.state_shapes()
        }
        self.dashboard = dashboard or metrics_lib.Dashboard(print_every=0)
        self.tracer = tracer or NULL_TRACER
        self.step_count = 0

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return host_tensor(arr).to(self.device)

    def _dense_step(self, keys: np.ndarray, labels: np.ndarray) -> torch.Tensor:
        t = self.table
        loss = linear.dense_fused_step(
            t.value, t.state, self.bias, self.bias_state,
            self._to_device(self.localizer.assign(keys)),  # [B, nnz], no dedup
            self._to_device(np.asarray(labels, np.float32)),
            self.optimizer, self.cfg.rows, self.tracer,
        )
        self.step_count += 1
        return loss

    def _localize(self, keys: np.ndarray):
        slots, inverse, _n = localize_to_slots(
            keys, self.localizer, min_bucket=self.min_bucket
        )
        return self._to_device(slots), self._to_device(inverse), int(slots.shape[0])

    def step(self, keys: np.ndarray, labels: np.ndarray) -> float:
        if self.mode == "dense":
            return float(self._dense_step(keys, labels))
        t = self.table
        ids, inverse, n = self._localize(keys)
        loss = linear.fused_train_step(
            t.value, t.state, self.bias, self.bias_state, ids, inverse,
            self._to_device(np.asarray(labels, np.float32)), self.optimizer, n,
            fused_apply=t.fused_apply,
        )
        self.step_count += 1
        return float(loss)

    def step_async(self, keys: np.ndarray, labels: np.ndarray) -> torch.Tensor:
        """Dense-mode step without host sync; returns the device loss."""
        if self.mode != "dense":
            raise ValueError("step_async requires mode='dense'")
        return self._dense_step(keys, labels)

    def step_block(
        self, keys_block: np.ndarray, labels_block: np.ndarray
    ) -> torch.Tensor:
        """K dense steps in one call (requires ``device_hash``).

        ``keys_block``: ``[K, B, nnz]`` keys at their RAW width (the
        out-of-range guard only runs on non-uint32 input, so a caller-side
        ``astype(np.uint32)`` would wrap bad keys before it sees them);
        ``labels_block``: ``[K, B]``.  Returns the device losses ``[K]``.
        """
        if not self.device_hash:
            raise ValueError("step_block requires device_hash=True")
        keys_block = ensure_uint32_keys(keys_block)
        return self.step_block_device(
            self._to_device(keys_block),
            self._to_device(np.asarray(labels_block, np.float32)),
        )

    def step_block_device(
        self, keys_block: torch.Tensor, labels_block: torch.Tensor
    ) -> torch.Tensor:
        """:meth:`step_block` for keys and labels already on the device
        (validated 32-bit keys as int32 or uint32).  Pure dispatch: nothing
        here waits on the device, so the prefetch producer stages the next
        block while this one runs.  Callers own the validation contract."""
        if not self.device_hash:
            raise ValueError("step_block_device requires device_hash=True")
        t = self.table
        losses = linear.dense_scan_train_step(
            t.value, t.state, self.bias, self.bias_state, keys_block,
            labels_block, self.optimizer, self.cfg.rows, self.localizer.seed,
            self.tracer,
        )
        self.step_count += keys_block.shape[0]
        return losses

    def train_stream(self, pipeline, num_blocks: Optional[int] = None) -> list:
        """Drain a :class:`~parameter_server_tpu_torch.data.prefetch.PrefetchPipeline`
        of ``(keys_block, labels_block)`` device pairs through
        :meth:`step_block_device`; returns the per-block device losses."""
        losses = []
        for kd, yd in pipeline:
            losses.append(self.step_block_device(kd, yd))
            if num_blocks is not None and len(losses) >= num_blocks:
                break
        return losses

    def train(self, batch_fn: BatchFn, num_steps: int) -> None:
        for _ in range(num_steps):
            keys, labels = batch_fn()
            loss = self.step(keys, labels)
            self.dashboard.record(self.step_count, loss, examples=labels.shape[0])

    def eval_auc(self, batch_fn: BatchFn, num_batches: int) -> float:
        scores, labels_all = [], []
        for _ in range(num_batches):
            keys, labels = batch_fn()
            ids, inverse, _n = self._localize(keys)
            logits = linear.eval_logits(
                self.table.value, self.table.state, self.bias, self.bias_state,
                ids, inverse, labels.shape[0], self.optimizer,
            )
            scores.append(logits.cpu().numpy())
            labels_all.append(labels)
        return metrics_lib.auc(np.concatenate(labels_all), np.concatenate(scores))


class AsyncLRLearner:
    """Multi-worker PS loop over the Van with BSP/SSP/ASP gating."""

    def __init__(
        self,
        workers: list[KVWorker],
        consistency: ConsistencyConfig,
        *,
        table: str = "w",
        dashboard: Optional[metrics_lib.Dashboard] = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.workers = workers
        self.controller = ConsistencyController(consistency, len(workers))
        self.table = table
        self.dashboard = dashboard or metrics_lib.Dashboard(print_every=0)
        self.device = torch.device(device)
        self._lock = threading.Lock()
        self._losses: list[float] = []

    def run(
        self, batch_fns: list[BatchFn], steps_per_worker: int, *, timeout: float = 60.0
    ) -> list[float]:
        """Run all workers to completion; returns per-iteration losses."""
        run_threads(
            [
                functools.partial(
                    self._worker_loop, w, batch_fns[i], i, steps_per_worker, timeout
                )
                for i, w in enumerate(self.workers)
            ],
            name="sgd-worker",
        )
        return list(self._losses)

    def _worker_loop(
        self, kv: KVWorker, batch_fn: BatchFn, index: int, steps: int, timeout: float
    ) -> None:
        for t in range(steps):
            if not self.controller.wait_turn(index, t, timeout=timeout):
                raise TimeoutError(f"worker {index} stalled at iter {t} (SSP bound)")
            keys, labels = batch_fn()
            w_pos = kv.pull_sync(self.table, keys, timeout=timeout)
            g, _gb, loss = linear.grad_rows(
                torch.tensor(w_pos, device=self.device),
                torch.tensor(labels, device=self.device),
            )
            push_ts = kv.push(self.table, keys, g.cpu().numpy() / labels.shape[0])
            kv.wait(push_ts, timeout=timeout)
            self.controller.finish_iteration(index)
            with self._lock:
                self._losses.append(float(loss))
                self.dashboard.record(
                    len(self._losses), float(loss), examples=labels.shape[0]
                )
