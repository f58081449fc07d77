"""Dense-model trainers: single-card data-parallel and Van-path async PS.

Torch counterpart of ``parameter_server_tpu/learner/dense.py`` for BASELINE
configs #2 (ResNet-50 under BSP/SSP) and #4 (BERT-base, async push/pull of
dense layers):

- :class:`SpmdDenseTrainer`: one train step on ``device`` (``mesh=None``)
  or data-parallel over a mesh's ``data`` axis: each rank runs its block of
  the global batch, the gradients are summed over ``data`` (the global
  mean's gradient) before the optimizer, and BatchNorm takes its statistics
  over the global batch (``models/resnet.py``), as GSPMD makes the JAX
  trainer's.  BSP by construction.  Its dashboard's MFU numerator is a flop
  count of the step (forward, loss, backward) on ``meta`` copies at each new
  batch shape; the denominator is the card's peak for the math mode most of
  those FLOPs run in (a conv net's convolutions: TF32 under torch's
  defaults).  A rank's dashboard counts its own examples.
- :class:`AsyncDenseLearner`: N worker threads, each with its own replica of
  the model; per iteration a worker pulls the flat parameter vector from the
  :class:`~parameter_server_tpu_torch.kv.dense.DenseKVServer`\\ s, computes
  gradients on its batch, pushes them and advances the consistency clock
  (BSP/SSP/ASP as in the sparse path).  BatchNorm statistics stay local to
  each worker; only params travel.
- :class:`ChunkedAsyncDenseLearner`: config #4's spine (BERT-base MLM): the
  flat vector streams in per-segment pushes and pulls, each segment's next
  pull sent right behind its push, a push window of ``consistency.bound``
  steps.

A model is a ``torch.nn.Module`` built with its own initial weights (the
port's ``models/resnet.py``), where the JAX trainers init a flax module from
a seed; an optimizer is a callable ``params -> torch.optim.Optimizer`` in
place of an optax transformation (``functools.partial(torch.optim.SGD,
lr=..., momentum=0.9)`` is ``optax.sgd(lr, momentum=0.9)``'s rule).
"""

from __future__ import annotations

import collections
import copy
import functools
import threading
from typing import Callable, Optional, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch.config import ConsistencyConfig
from parameter_server_tpu_torch.core.clock import ConsistencyController
from parameter_server_tpu_torch.kv.dense import DenseKVWorker, PytreeCodec, fixed_segments
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
    """Data-parallel trainer for a dense model on one card or a mesh (BSP)."""

    def __init__(
        self,
        model: torch.nn.Module,
        tx: Callable[..., torch.optim.Optimizer],
        mesh=None,
        *,
        loss_fn=softmax_xent,
        dashboard: Optional[metrics_lib.Dashboard] = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.device
        self.model = model.to(self.device)
        self._n_data = 1
        if mesh is not None:
            from parameter_server_tpu_torch.models.resnet import BatchNorm
            from parameter_server_tpu_torch.parallel import mesh as mesh_lib

            self._n_data = mesh.shape[mesh_lib.DATA_AXIS]
            if self._n_data > 1:
                for m in self.model.modules():
                    if isinstance(m, BatchNorm):
                        m.sync = (mesh, mesh_lib.DATA_AXIS)
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

    def _local_batch(self, images: np.ndarray, labels: np.ndarray):
        """This rank's block of the global batch (all of it with no mesh)."""
        if self.mesh is None:
            return _batch_on(self.device, images, labels)
        from parameter_server_tpu_torch.parallel import distributed
        from parameter_server_tpu_torch.parallel import mesh as mesh_lib

        images, labels = np.asarray(images, np.float32), np.asarray(labels)
        return tuple(distributed.host_local_batch(mesh_lib.batch_sharding(self.mesh, a.ndim),
                                                  a, a.shape)
                     for a in (images, labels))

    def step(self, images: np.ndarray, labels: np.ndarray) -> float:
        """One step on the global batch (every rank of a mesh passes all of
        it); returns the global mean loss."""
        x, y = self._local_batch(images, labels)
        self.model.train()
        if tuple(x.shape) != self._flops_shape:
            self._count_flops(x, y)
        loss = self.loss_fn(self.model(x), y)
        self.optimizer.zero_grad(set_to_none=True)
        if self._n_data > 1:
            from parameter_server_tpu_torch.parallel import mesh as mesh_lib

            (loss / self._n_data).backward()
            grads = [p.grad for p in self.model.parameters() if p.grad is not None]
            flat = self.mesh.all_reduce(torch.cat([g.reshape(-1) for g in grads]),
                                        mesh_lib.DATA_AXIS)
            for g, part in zip(grads, flat.split([g.numel() for g in grads])):
                g.copy_(part.view_as(g))
            loss = self.mesh.all_reduce(loss.detach() / self._n_data, mesh_lib.DATA_AXIS)
        else:
            loss.backward()
        self.optimizer.step()
        loss_f = float(loss.detach())
        self.step_count += 1
        self.dashboard.record(self.step_count, loss_f, examples=int(x.shape[0]))
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


class ChunkedAsyncDenseLearner:
    """Config #4's spine: async PS training with per-segment overlapped
    push/pull of the dense parameter vector.

    Where :class:`AsyncDenseLearner` ships the whole flat vector a step
    (BERT-base: ~440 MB a worker a step), this learner streams fixed-size
    (or per-layer, ``kv.dense.layer_segments``) element segments, each with
    its own timestamp:

    - every segment push is immediately followed by the NEXT step's pull of
      the same segment: per-link FIFO delivery makes the server apply the
      push before it answers the pull.  That is exact for a single worker
      and the normal staleness-tolerant shape under SSP/ASP; under BSP with
      several workers FIFO cannot order one worker's pull after its peers'
      pushes, so the learner then pulls after the barrier;
    - pushes are not waited one by one: ``consistency.bound`` steps of
      unacked pushes may be outstanding (all of them under ASP);
    - ``max_inflight`` is the high-water mark of concurrently pending
      segment tasks;
    - a step's bytes ride the dashboard rows (``push_mb``, ``pull_mb``,
      ``inflight_max``, and ``wire_mb_total`` when the Van carries a
      ``FilterChain``).

    ``loss_fn(params, *batch) -> scalar tensor`` keeps the learner
    model-agnostic: ``params`` is the parameter tree (nested dict keyed by
    flax path, ``models/layers.py::params_tree``) as views into the pulled
    vector on ``device``, which the loss evaluates through
    ``torch.func.functional_call``; ``batch_fn()`` returns numpy arrays,
    moved to ``device`` as they are.  The flat gradient is the vector's own
    ``.grad``; it leaves through ``push_segment``'s host copy, as in the
    reference.  ``functional_call`` swaps a module's parameters while it
    runs, so workers sharing one module would read each other's vectors:
    the learner evaluates one worker's loss and gradient at a time (the
    pushes and pulls still overlap).
    """

    def __init__(
        self,
        loss_fn,
        example_params,
        workers: list[DenseKVWorker],
        consistency: ConsistencyConfig,
        *,
        table: str = "model",
        segments: Optional[list] = None,
        chunk_elems: int = 1 << 16,
        dashboard: Optional[metrics_lib.Dashboard] = None,
        device: str | torch.device = "cuda",
    ) -> None:
        self.device = torch.device(device)
        self.kv_workers = workers
        self.table = table
        self.codec = PytreeCodec(example_params)
        self.segments = (
            list(segments) if segments is not None
            else fixed_segments(self.codec.total, chunk_elems)
        )
        if not self.segments or self.segments[-1][1] != self.codec.total:
            raise ValueError("segments must cover the full parameter vector")
        self.consistency = consistency
        self.controller = ConsistencyController(consistency, len(workers))
        self.dashboard = dashboard or metrics_lib.Dashboard(print_every=0)
        self.init_params = example_params
        self.loss_fn = loss_fn
        self._lock = threading.Lock()
        #: one loss and gradient evaluation at a time (see the class doc)
        self._grad_lock = threading.Lock()
        self._losses: list[float] = []
        #: high-water mark of concurrently in-flight segment tasks
        self.max_inflight = 0

    def initial_vector(self) -> np.ndarray:
        """Flat init vector to seed the servers (pass as init_vectors)."""
        with torch.no_grad():
            return self.codec.flatten(self.init_params)

    def _note_inflight(self, kv: DenseKVWorker) -> None:
        n = kv.pending_count()
        with self._lock:
            if n > self.max_inflight:
                self.max_inflight = n

    @staticmethod
    def _wire_mb(kv: DenseKVWorker) -> Optional[float]:
        chain = getattr(kv.post.van, "filter_chain", None)
        if chain is None:
            return None
        _bytes_in, out = chain.compressed_bytes()
        return out / 1e6 if out else None

    def _grad(self, vec: torch.Tensor, batch) -> tuple:
        """(loss, flat gradient) of ``loss_fn`` at the pulled vector."""
        leaf = vec.detach().requires_grad_(True)
        args = [torch.as_tensor(np.asarray(b)).to(self.device) for b in batch]
        with self._grad_lock:
            loss = self.loss_fn(self.codec.unflatten(leaf), *args)
            loss.backward()
        return float(loss.detach()), leaf.grad

    def run(self, batch_fns: list, steps_per_worker: int, *,
            timeout: float = 120.0) -> list[float]:
        run_threads(
            [
                functools.partial(self._worker_loop, kv, batch_fns[i], i,
                                  steps_per_worker, timeout)
                for i, kv in enumerate(self.kv_workers)
            ],
            name="chunked-dense-worker",
        )
        return list(self._losses)

    def _worker_loop(self, kv, batch_fn, index, steps, timeout):
        table, segs = self.table, self.segments
        delay = self.consistency.bound  # None = ASP (unbounded pushes)
        # eager pulls (right behind the pushes) are sound only when no
        # barrier peer's update can land later: one worker, or a
        # staleness-tolerant mode
        eager = len(self.kv_workers) == 1 or delay != 0
        pulls = ({i: kv.pull_segment(table, a, b - a) for i, (a, b) in enumerate(segs)}
                 if eager else None)
        push_window: collections.deque[list[int]] = collections.deque()
        vec = torch.empty(self.codec.total, dtype=torch.float32, device=self.device)
        for t in range(steps):
            if not self.controller.wait_turn(index, t, timeout=timeout):
                raise TimeoutError(f"worker {index} stalled at iter {t}")
            bytes0 = (kv.bytes_pushed, kv.bytes_pulled)
            if pulls is None:  # post-barrier pulls (multi-worker BSP)
                pulls = {i: kv.pull_segment(table, a, b - a) for i, (a, b) in enumerate(segs)}
            for i, (a, b) in enumerate(segs):
                vec[a:b] = kv.pull_segment_result(pulls[i], timeout)
            loss, gvec = self._grad(vec, batch_fn())
            step_pushes = []
            pulls = {} if eager else None
            for i, (a, b) in enumerate(segs):
                # push segment i, then (eager) request the next step's
                # weights of segment i at once: FIFO per link applies the
                # push first, and the pull's latency hides behind the
                # remaining segments' pushes
                step_pushes.append(kv.push_segment(table, a, gvec[a:b]))
                if eager:
                    pulls[i] = kv.pull_segment(table, a, b - a)
                self._note_inflight(kv)
            push_window.append(step_pushes)
            while len(push_window) > (delay if delay is not None else len(push_window)):
                for ts in push_window.popleft():
                    if not kv.wait(ts, timeout):
                        raise TimeoutError(f"segment push ts={ts} not acked")
            self.controller.finish_iteration(index)
            with self._lock:
                self._losses.append(loss)
                extra = {
                    "push_mb": round((kv.bytes_pushed - bytes0[0]) / 1e6, 3),
                    "pull_mb": round((kv.bytes_pulled - bytes0[1]) / 1e6, 3),
                    "inflight_max": self.max_inflight,
                }
                wire = self._wire_mb(kv)
                if wire is not None:
                    extra["wire_mb_total"] = round(wire, 3)
                self.dashboard.record(len(self._losses), loss, extra=extra)
        # epoch end: drain the push window and any prefetched pulls
        for step_ts in push_window:
            for ts in step_ts:
                kv.wait(ts, timeout)
        for i in pulls or {}:
            kv.pull_segment_result(pulls[i], timeout)
