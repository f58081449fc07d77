"""Block coordinate descent scaffold + DARLIN L1-LR (delayed block proximal
gradient with KKT filtering).

Torch counterpart of ``parameter_server_tpu/learner/bcd.py``.  Reference
analogues (all [U]): ``src/learner/bcd.h`` (BCDScheduler/Server/Worker
triad, feature-block partition), ``src/app/linear_method/darlin*.h/.cc``
(delayed block proximal gradient, bounded delay τ, KKT filter skipping
inactive features), ``src/app/linear_method/loss.h`` / ``penalty.h``
(logit loss, L1 prox).

- Workers keep the per-example **margin** vector ``Xw`` on ``device``.  A
  block update only needs ``margin += X[:,b] @ delta_b``, a segment sum, so
  no full pass over the data is ever taken.
- Block gradient ``g_b = X[:,b]^T (sigma(margin) - y)`` is a segment sum
  over the block's nonzeros; the curvature bound ``u_b`` depends on the
  block's coordinates only, so it is computed once at construction.
- The server applies the proximal step ``w_b <- S(w_b - g/u, lambda/u)``
  (soft threshold ``S``) and keeps the **KKT active mask**: a feature with
  ``w_j == 0`` and ``|g_j| <= lambda - kkt_delta`` is *inactive*.
- Within a block the update is BSP (the server waits for every worker's
  partial gradient); across blocks up to ``tau`` block tasks are in flight
  per worker, with parked pull replies.

Every sum is deterministic.  The KKT filter and the soft threshold are
discrete, so float noise in a sum could flip a coordinate's activity; where
the JAX steps use ``segment_sum`` and ``.at[].add``, this module sorts each
block's nonzeros once at construction (by column for the gradient, by row
for the margin) and sums each segment in a fixed order with
``torch.segment_reduce``; the margin takes each touched row's sum through
``index_add`` over unique rows, one addition per row.  A server sums the
workers' partials in worker order.  The margin is updated out of place: a
task's snapshot is a tensor no later update writes.
"""

from __future__ import annotations

import dataclasses
import threading
from typing import Dict, List, Optional

import numpy as np
import torch

from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind, server_id
from parameter_server_tpu_torch.core.postoffice import Customer, Postoffice
from parameter_server_tpu_torch.kv.partition import RangePartition
from parameter_server_tpu_torch.utils import metrics as metrics_lib
from parameter_server_tpu_torch.utils.threads import ErrorGroup


@dataclasses.dataclass(frozen=True)
class BCDConfig:
    num_features: int
    num_blocks: int
    #: L1 penalty weight (lambda) and optional L2.
    l1: float = 1e-3
    l2: float = 0.0
    #: bounded delay: block-tasks in flight per worker (1 = sequential BSP).
    tau: int = 2
    #: KKT filter slack: inactive iff w==0 and |g| <= l1 - kkt_delta.
    kkt_delta: float = 1e-4
    #: trust-region cap on a single coordinate step (DARLIN's delta_max).
    delta_max: float = 1.0
    loss: str = "logistic"  # or "squared"


class BlockPartition:
    """Even contiguous split of the localized feature space into blocks."""

    def __init__(self, num_features: int, num_blocks: int) -> None:
        self.num_features = num_features
        self.num_blocks = num_blocks
        self.offsets = RangePartition(num_features, num_blocks).offsets

    def block_range(self, b: int) -> tuple[int, int]:
        return int(self.offsets[b]), int(self.offsets[b + 1])

    def block_size(self, b: int) -> int:
        lo, hi = self.block_range(b)
        return hi - lo


@dataclasses.dataclass
class _Block:
    """One feature block's nonzeros on a worker, sorted once.

    ``rows_by_col``: example row of each nonzero, grouped by local column
    (row order within a column) with ``col_lengths`` nonzeros a column;
    ``cols_by_row``: local column of each nonzero, grouped by row, over the
    block's touched rows ``urows`` with ``row_lengths`` nonzeros each; ``u``:
    the curvature bound."""

    rows_by_col: torch.Tensor  # [nnz] int32
    col_lengths: torch.Tensor  # [n] int64
    cols_by_row: torch.Tensor  # [nnz] int32
    urows: torch.Tensor  # [touched] int64
    row_lengths: torch.Tensor  # [touched] int64
    u: torch.Tensor  # [n] f32


# -- device steps ------------------------------------------------------------


def _block_grad(margin: torch.Tensor, labels: torch.Tensor, blk: _Block, loss: str):
    """Partial gradient + curvature bound of one feature block.

    Binary features (value 1), the CTR case.  ``g`` is each column's
    residual sum in row order (``segment_reduce`` over the column-sorted
    nonzeros)."""
    if loss == "logistic":
        resid = torch.sigmoid(margin) - labels  # dl/dmargin for y in {0,1}
    else:  # squared: l = 0.5 (margin - y)^2
        resid = margin - labels
    g = torch.segment_reduce(
        torch.index_select(resid, 0, blk.rows_by_col), "sum",
        lengths=blk.col_lengths, unsafe=True,
    )
    return g, blk.u


def _curvature(col_lengths: torch.Tensor, row_lengths: torch.Tensor, loss: str):
    """``u = cap * colsum * r``: the joint block update's diagonal majorizer.

    The diagonal bound alone is NOT a majorizer (cross terms).  For binary
    X, X_b^T X_b <= r * diag(colsum) with r = max block-nonzeros in any
    example, so scaling u by r keeps the prox step a true descent step (the
    reference's per-block learning-rate scaling)."""
    curv_cap = 0.25 if loss == "logistic" else 1.0  # max p(1-p), or 1
    maxrow = max(int(row_lengths.max()) if row_lengths.numel() else 0, 1)
    return curv_cap * col_lengths.to(torch.float32) * float(maxrow)


def _apply_margin_delta(margin: torch.Tensor, blk: _Block, delta: torch.Tensor):
    """``margin_i + sum_{nonzeros (i,j) in block} delta_j``, out of place."""
    per_row = torch.segment_reduce(
        torch.index_select(delta, 0, blk.cols_by_row), "sum",
        lengths=blk.row_lengths, unsafe=True,
    )
    return margin.index_add(0, blk.urows, per_row)


def _prox_step(w, g, u, l1, l2, delta_max, kkt_delta):
    """DARLIN server update for one block.

    Returns (new_w, delta, new_active).  Minimizes the quadratic model
    ``g*d + 0.5*u*d^2 + l1*|w+d|`` per coordinate: ``z = S(w - g/u, l1/u)``,
    ``d = clip(z - w, +-delta_max)``; only KKT-active coordinates move.
    """
    u = u + l2 + 1e-12
    z = w - g / u
    thr = l1 / u
    z = torch.sign(z) * torch.clamp_min(torch.abs(z) - thr, 0.0)
    d = torch.clamp(z - w, -delta_max, delta_max)
    # KKT check at the *current* point: w==0 and |g| within the subgradient
    # interval (slack kkt_delta) => coordinate provably stays at 0.
    inactive_now = (w == 0.0) & (torch.abs(g) <= l1 - kkt_delta)
    new_active = ~inactive_now
    d = torch.where(new_active, d, torch.zeros_like(d))
    return w + d, d, new_active


# -- server ------------------------------------------------------------------


class DarlinServer(Customer):
    """Owns the weight blocks routed to it; aggregates worker partials.

    Blocks are assigned block-cyclically to servers (``b % num_servers``).
    A PULL for a block version not yet applied is parked and answered when
    the last worker's PUSH triggers the prox step (the Executor dependency
    park).  Weights and active masks live on ``device``; deltas go back to
    the workers as numpy.
    """

    def __init__(
        self,
        post: Postoffice,
        cfg: BCDConfig,
        blocks: BlockPartition,
        server_index: int,
        num_servers: int,
        num_workers: int,
        *,
        name: str = "darlin",
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__(name, post)
        self.cfg = cfg
        self.blocks = blocks
        self.server_index = server_index
        self.num_workers = num_workers
        self.device = torch.device(device)
        self._state_lock = threading.Lock()
        #: per owned block: weights, active mask, accumulators, applied iter
        self._w: Dict[int, torch.Tensor] = {}
        self._active: Dict[int, torch.Tensor] = {}
        self._acc: Dict[tuple, dict] = {}  # (block, iter) -> sender -> (g, u)
        self._applied: Dict[int, int] = {}  # block -> latest applied iter
        self._delta: Dict[tuple, np.ndarray] = {}  # (block, iter) -> delta
        self._served: Dict[tuple, int] = {}  # (block, iter) -> pulls served
        self._parked: Dict[tuple, List[Message]] = {}
        for b in range(blocks.num_blocks):
            if b % num_servers == server_index:
                n = blocks.block_size(b)
                self._w[b] = torch.zeros(n, dtype=torch.float32, device=self.device)
                self._active[b] = torch.ones(n, dtype=torch.bool, device=self.device)
                self._applied[b] = -1

    def handle_request(self, msg: Message) -> Optional[Message]:
        b = msg.task.payload["block"]
        it = msg.task.payload["iter"]
        if msg.task.kind == TaskKind.PUSH:
            self._on_push(b, it, msg)
            return msg.reply()
        if msg.task.kind == TaskKind.PULL:
            with self._state_lock:
                if self._applied[b] >= it:
                    return msg.reply(values=[self._take_delta_locked(b, it)])
                self._parked.setdefault((b, it), []).append(msg)
                return None  # parked: answered after the prox step
        raise ValueError(f"unsupported task kind {msg.task.kind}")

    def _take_delta_locked(self, b: int, it: int) -> np.ndarray:
        """Serve one worker's delta pull; free it after the last worker."""
        d = self._delta[(b, it)]
        served = self._served.get((b, it), 0) + 1
        if served >= self.num_workers:
            self._delta.pop((b, it), None)
            self._served.pop((b, it), None)
        else:
            self._served[(b, it)] = served
        return d

    def _on_push(self, b: int, it: int, msg: Message) -> None:
        g, u = msg.values
        release: List[Message] = []
        with self._state_lock:
            parts = self._acc.setdefault((b, it), {})
            parts[msg.sender] = (g, u)
            if len(parts) < self.num_workers:
                return
            del self._acc[(b, it)]
            # worker order, whatever order the pushes arrived in
            order = sorted(parts)
            g_sum, u_sum = np.zeros_like(g), np.zeros_like(u)
            for sender in order:
                g_sum += parts[sender][0]
                u_sum += parts[sender][1]
            cfg = self.cfg
            new_w, delta, new_active = _prox_step(
                self._w[b],
                torch.from_numpy(g_sum).to(self.device),
                torch.from_numpy(u_sum).to(self.device),
                cfg.l1, cfg.l2, cfg.delta_max, cfg.kkt_delta,
            )
            self._w[b] = new_w
            self._active[b] = new_active
            dnp = delta.cpu().numpy()
            self._delta[(b, it)] = dnp
            self._applied[b] = it
            release = self._parked.pop((b, it), [])
            # parked pulls count toward the serve quota that frees the delta
            for _ in release:
                self._take_delta_locked(b, it)
        for parked in release:
            self.post.send(parked.reply(values=[dnp]))

    # -- dashboard / eval ----------------------------------------------------
    def weight_stats(self) -> dict:
        with self._state_lock:
            ws = list(self._w.values())
            actives = list(self._active.values())
        if not ws:
            return {"nnz": 0, "l1_norm": 0.0, "active": 0, "total": 0}
        w = torch.cat(ws)
        return {
            "nnz": int((w != 0).sum()),
            "l1_norm": sum(float(torch.abs(x).sum()) for x in ws),
            "active": int(torch.cat(actives).sum()),
            "total": int(w.shape[0]),
        }

    def dense_weights(self) -> np.ndarray:
        """Full weight vector over this server's blocks, for evaluation."""
        out = np.zeros(self.blocks.num_features, np.float32)
        with self._state_lock:
            for b, w in self._w.items():
                lo, hi = self.blocks.block_range(b)
                out[lo:hi] = w.cpu().numpy()
        return out


# -- worker ------------------------------------------------------------------


class DarlinWorker(Customer):
    """Holds a data shard (CSR over localized features) + the margin vector.

    ``indptr``/``indices`` describe the examples' features (binary values).
    The per-block coordinate lists are built once on ``device`` (the
    SlotReader's column-block role): two stable sorts of all nonzeros, by
    feature (column order inside each block, rows ascending) and by block
    (row order inside each block), so each block task is a few fixed device
    calls.
    """

    def __init__(
        self,
        post: Postoffice,
        cfg: BCDConfig,
        blocks: BlockPartition,
        num_servers: int,
        indptr: np.ndarray,
        indices: np.ndarray,
        labels: np.ndarray,
        *,
        name: str = "darlin",
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__(name, post)
        self.cfg = cfg
        self.blocks = blocks
        self.num_servers = num_servers
        self.device = torch.device(device)
        self.num_examples = int(labels.shape[0])
        self.labels = torch.as_tensor(np.asarray(labels, np.float32)).to(self.device)
        self.margin = torch.zeros(self.num_examples, dtype=torch.float32, device=self.device)
        self._margin_lock = threading.Lock()
        self._blocks = self._build_blocks(indptr, indices)

    def _build_blocks(self, indptr: np.ndarray, indices: np.ndarray) -> List[_Block]:
        dev = self.device
        idx = torch.as_tensor(np.asarray(indices, np.int64)).to(dev)
        per_row = torch.as_tensor(np.diff(np.asarray(indptr, np.int64))).to(dev)
        row_of = torch.repeat_interleave(
            torch.arange(self.num_examples, dtype=torch.int64, device=dev), per_row
        )
        offsets = torch.as_tensor(np.asarray(self.blocks.offsets, np.int64)).to(dev)
        blk_of = torch.bucketize(idx, offsets[1:-1], right=True)
        by_col = torch.sort(idx, stable=True).indices
        by_blk = torch.sort(blk_of, stable=True).indices
        col_len = torch.bincount(idx, minlength=self.blocks.num_features)
        nnz_of = torch.bincount(blk_of, minlength=self.blocks.num_blocks).cpu().numpy()
        starts = np.concatenate([[0], np.cumsum(nnz_of)])
        out = []
        for b in range(self.blocks.num_blocks):
            lo, hi = self.blocks.block_range(b)
            s, e = int(starts[b]), int(starts[b + 1])
            r_sel = by_blk[s:e]
            urows, row_len = torch.unique_consecutive(row_of[r_sel], return_counts=True)
            cols = col_len[lo:hi]
            out.append(_Block(
                rows_by_col=row_of[by_col[s:e]].to(torch.int32),
                col_lengths=cols,
                cols_by_row=(idx[r_sel] - lo).to(torch.int32),
                urows=urows,
                row_lengths=row_len,
                u=_curvature(cols, row_len, self.cfg.loss),
            ))
        return out

    def block_task(self, b: int, it: int, timeout: float = 60.0) -> None:
        """One DARLIN block step: grad -> push -> pull delta -> margin."""
        blk = self._blocks[b]
        with self._margin_lock:
            margin = self.margin  # never written in place: a true snapshot
        g, u = _block_grad(margin, self.labels, blk, self.cfg.loss)
        sid = server_id(b % self.num_servers)
        push_ts = self.submit(
            [
                Message(
                    task=Task(
                        TaskKind.PUSH, self.name, payload={"block": b, "iter": it}
                    ),
                    recver=sid,
                    values=[g.cpu().numpy(), u.cpu().numpy()],
                )
            ]
        )
        pull_ts = self.submit(
            [
                Message(
                    task=Task(
                        TaskKind.PULL, self.name, payload={"block": b, "iter": it}
                    ),
                    recver=sid,
                )
            ],
            keep_responses=True,
        )
        if not self.wait(pull_ts, timeout):
            raise TimeoutError(f"block {b} iter {it} pull timed out")
        (resp,) = self.take_responses(pull_ts)
        delta = torch.as_tensor(np.asarray(resp.values[0], np.float32)).to(self.device)
        with self._margin_lock:
            self.margin = _apply_margin_delta(self.margin, blk, delta)
        if not self.wait(push_ts, timeout):
            raise TimeoutError(f"block {b} iter {it} push timed out")

    def logloss(self) -> float:
        """Total (sum) loss over this worker's shard — the unit the DARLIN
        objective is minimized in (gradients are sums, l1 applies to sums)."""
        with self._margin_lock:
            margin = self.margin
        if self.cfg.loss == "logistic":
            ll = torch.sum(torch.logaddexp(torch.zeros_like(margin), margin)
                           - self.labels * margin)
        else:
            ll = 0.5 * torch.sum((margin - self.labels) ** 2)
        return float(ll)

    def scores(self) -> np.ndarray:
        with self._margin_lock:
            return self.margin.cpu().numpy()


# -- scheduler ---------------------------------------------------------------


class DarlinScheduler:
    """Drives randomized block iterations with a tau-bounded pipeline.

    Per epoch: shuffle blocks; each worker walks the same order.  A worker
    may start block-task t only once its own task t - tau has fully applied
    (margin updated) — the reference's bounded-delay window.  Within a block
    the server's prox step waits for all workers (BSP), so no per-block
    consistency controller is needed.
    """

    def __init__(
        self,
        cfg: BCDConfig,
        workers: List[DarlinWorker],
        servers: List[DarlinServer],
        *,
        seed: int = 0,
        dashboard: Optional[metrics_lib.Dashboard] = None,
    ) -> None:
        self.cfg = cfg
        self.workers = workers
        self.servers = servers
        self.rng = np.random.default_rng(seed)
        self.dashboard = dashboard or metrics_lib.Dashboard(print_every=0)
        self.history: List[dict] = []

    def objective(self) -> dict:
        """Global objective in sum units: total logloss + l1 penalty.

        (Sum, not mean: worker gradients are sums over examples, so this is
        the function the prox steps provably decrease.)
        """
        loss = float(np.sum([w.logloss() for w in self.workers]))
        n = sum(w.num_examples for w in self.workers)
        stats = [s.weight_stats() for s in self.servers]
        l1_norm = sum(s["l1_norm"] for s in stats)
        return {
            "loss": loss,
            "mean_loss": loss / max(n, 1),
            "objective": loss + self.cfg.l1 * l1_norm,
            "nnz": sum(s["nnz"] for s in stats),
            "active": sum(s["active"] for s in stats),
            "total": sum(s["total"] for s in stats),
        }

    def run(self, num_epochs: int, *, timeout: float = 120.0) -> List[dict]:
        tau = max(1, self.cfg.tau)
        task_iter = 0
        for epoch in range(num_epochs):
            order = self.rng.permutation(self.cfg.num_blocks)
            iters = list(range(task_iter, task_iter + len(order)))
            task_iter += len(order)
            group = ErrorGroup()

            def worker_run(w: DarlinWorker) -> None:
                # tau-bounded pipeline: block-task t starts once t - tau has
                # fully applied; each task runs in a child thread so its
                # gradient/push can overlap the previous task's parked pull.
                done: List[threading.Thread] = []
                for t, (b, it) in enumerate(zip(order, iters)):
                    group.check()
                    if t >= tau:
                        done[t - tau].join(timeout)
                        if done[t - tau].is_alive():
                            raise TimeoutError(
                                f"block task {t - tau} never completed"
                            )
                    done.append(group.spawn(w.block_task, int(b), it, timeout))
                for th in done:
                    th.join(timeout)
                    if th.is_alive():
                        raise TimeoutError("block task never completed")

            threads = [group.spawn(worker_run, w) for w in self.workers]
            for th in threads:
                th.join()
            group.check()
            row = {"epoch": epoch, **self.objective()}
            self.history.append(row)
            self.dashboard.record(epoch, row["objective"], extra=row)
        return self.history

    def dense_weights(self) -> np.ndarray:
        out = np.zeros(self.cfg.num_features, np.float32)
        for s in self.servers:
            out += s.dense_weights()
        return out
