"""SGD learner: the asynchronous PS loop over the Van.

Torch counterpart of ``AsyncLRLearner`` in
``parameter_server_tpu/learner/sgd.py``: N worker threads each run
``wait_turn -> pull(w) -> grad -> push(g) -> advance`` through a
:class:`~parameter_server_tpu_torch.kv.worker.KVWorker`, gated by a
:class:`~parameter_server_tpu_torch.core.clock.ConsistencyController`
(BSP/SSP/ASP).  The gradient is computed on ``device``.  The single-process
``LocalLRTrainer`` waits for its own slice.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch.config import ConsistencyConfig
from parameter_server_tpu_torch.core.clock import ConsistencyController
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.models import linear
from parameter_server_tpu_torch.utils import metrics as metrics_lib
from parameter_server_tpu_torch.utils.threads import run_threads

Batch = Tuple[np.ndarray, np.ndarray]  # (keys [B, nnz], labels [B])
BatchFn = Callable[[], Batch]


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
