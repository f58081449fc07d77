"""Dense-model trainers: single-card data-parallel and Van-path async PS.

Torch counterpart of ``parameter_server_tpu/learner/dense.py`` for BASELINE
config #2 (ResNet-50 under BSP/SSP):

- :class:`SpmdDenseTrainer`: one train step on ``device`` (the JAX trainer's
  mesh collapses to one card): forward, backward, the optimizer.  BSP by
  construction.  Its dashboard's MFU numerator is a flop count of the step
  (forward, loss, backward) on ``meta`` copies at each new batch shape; the
  denominator is the card's peak for the math mode most of those FLOPs run
  in (a conv net's convolutions: TF32 under torch's defaults).
- :class:`AsyncDenseLearner`: N worker threads, each with its own replica of
  the model; per iteration a worker pulls the flat parameter vector from the
  :class:`~parameter_server_tpu_torch.kv.dense.DenseKVServer`\\ s, computes
  gradients on its batch, pushes them and advances the consistency clock
  (BSP/SSP/ASP as in the sparse path).  BatchNorm statistics stay local to
  each worker; only params travel.

A model is a ``torch.nn.Module`` built with its own initial weights (the
port's ``models/resnet.py``), where the JAX trainers init a flax module from
a seed; an optimizer is a callable ``params -> torch.optim.Optimizer`` in
place of an optax transformation (``functools.partial(torch.optim.SGD,
lr=..., momentum=0.9)`` is ``optax.sgd(lr, momentum=0.9)``'s rule).
"""

from __future__ import annotations

import copy
import functools
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch.config import ConsistencyConfig
from parameter_server_tpu_torch.core.clock import ConsistencyController
from parameter_server_tpu_torch.kv.dense import DenseKVWorker, PytreeCodec
from parameter_server_tpu_torch.models.layers import flat_items, params_tree
from parameter_server_tpu_torch.utils import metrics as metrics_lib
from parameter_server_tpu_torch.utils.threads import run_threads

Batch = Tuple[np.ndarray, np.ndarray]  # (images [B, H, W, C], labels [B])
BatchFn = Callable[[], Batch]


def softmax_xent(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean cross-entropy with integer labels."""
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.mean(torch.gather(logp, 1, labels.long()[:, None]))


def _batch_on(device: torch.device, images, labels):
    return (torch.as_tensor(np.asarray(images, np.float32)).to(device),
            torch.as_tensor(np.asarray(labels)).to(device))


class SpmdDenseTrainer:
    """Data-parallel trainer for a dense model on one card (BSP)."""

    def __init__(
        self,
        model: torch.nn.Module,
        tx: Callable[..., torch.optim.Optimizer],
        *,
        loss_fn=softmax_xent,
        dashboard: Optional[metrics_lib.Dashboard] = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.optimizer = tx(self.model.parameters())
        self.loss_fn = loss_fn
        self.dashboard = dashboard or metrics_lib.Dashboard(print_every=0)
        self.step_count = 0
        #: the batch shape of the last MFU count
        self._flops_shape: Optional[tuple] = None

    def _count_flops(self, x: torch.Tensor, y: torch.Tensor) -> None:
        """Recount the step's FLOPs for a new batch shape (on ``meta``
        copies of the model and batch: nothing runs on the live state)."""
        loss_fn = self.loss_fn

        def step(model, x, y):
            loss_fn(model(x), y).backward()

        metrics_lib.set_mfu(
            self.dashboard, metrics_lib.counted_flops_by_kind(step, self.model, x, y),
            x.shape[0], self.device,
        )
        self._flops_shape = tuple(x.shape)

    def step(self, images: np.ndarray, labels: np.ndarray) -> float:
        x, y = _batch_on(self.device, images, labels)
        self.model.train()
        if tuple(x.shape) != self._flops_shape:
            self._count_flops(x, y)
        loss = self.loss_fn(self.model(x), y)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        loss_f = float(loss.detach())
        self.step_count += 1
        self.dashboard.record(self.step_count, loss_f, examples=int(len(labels)))
        return loss_f

    @torch.no_grad()
    def eval_logits(self, images: np.ndarray) -> np.ndarray:
        self.model.eval()
        x = torch.as_tensor(np.asarray(images, np.float32)).to(self.device)
        return self.model(x).cpu().numpy()


class AsyncDenseLearner:
    """Async PS training of a dense model over the Van.

    Workers keep local BatchNorm statistics (standard async-PS behaviour);
    only the parameters travel through the store.
    """

    def __init__(
        self,
        model: torch.nn.Module,
        workers: list[DenseKVWorker],
        consistency: ConsistencyConfig,
        *,
        table: str = "model",
        loss_fn=softmax_xent,
        dashboard: Optional[metrics_lib.Dashboard] = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = torch.device(device)
        self.model = model.to(self.device)
        self.kv_workers = workers
        self.table = table
        self.controller = ConsistencyController(consistency, len(workers))
        self.dashboard = dashboard or metrics_lib.Dashboard(print_every=0)
        self.codec = PytreeCodec(params_tree(self.model))
        self.loss_fn = loss_fn
        # each worker's replica starts from the model's weights and statistics
        self.replicas = [copy.deepcopy(self.model) for _ in workers]
        self._lock = threading.Lock()
        self._losses: list[float] = []

    def initial_vector(self) -> np.ndarray:
        """Flat init vector to seed the servers (pass as init_vectors)."""
        with torch.no_grad():
            return self.codec.flatten(params_tree(self.model))

    def run(self, batch_fns: list[BatchFn], steps_per_worker: int, *,
            timeout: float = 120.0) -> list[float]:
        run_threads(
            [
                functools.partial(self._worker_loop, kv, batch_fns[i], i,
                                  steps_per_worker, timeout)
                for i, kv in enumerate(self.kv_workers)
            ],
            name="dense-worker",
        )
        return list(self._losses)

    def _worker_loop(self, kv, batch_fn, index, steps, timeout):
        replica = self.replicas[index]
        replica.train()
        named = dict(replica.named_parameters())
        for t in range(steps):
            if not self.controller.wait_turn(index, t, timeout=timeout):
                raise TimeoutError(f"worker {index} stalled at iter {t}")
            images, labels = batch_fn()
            vec = kv.pull_sync(self.table, timeout).to(self.device)
            with torch.no_grad():
                for path, leaf in flat_items(self.codec.unflatten(vec)):
                    named[path].copy_(leaf)
            x, y = _batch_on(self.device, images, labels)
            loss = self.loss_fn(replica(x), y)
            replica.zero_grad(set_to_none=True)
            loss.backward()
            with torch.no_grad():
                grads = self.codec.flatten_tensor(params_tree(replica, grads=True))
            ts = kv.push(self.table, grads)
            kv.wait(ts, timeout)
            self.controller.finish_iteration(index)
            loss_f = float(loss.detach())
            with self._lock:
                self._losses.append(loss_f)
                self.dashboard.record(len(self._losses), loss_f, examples=len(labels))
