"""Hybrid LM trainer: PS-served embeddings + a dense transformer body.

Torch counterpart of ``parameter_server_tpu/learner/hybrid.py``, BASELINE
config #5 (Llama-3-8B: PS embeddings, a synchronously trained body).  One
step combines both planes:

- **embedding rows ride the Van**: pulled from and pushed to
  :class:`~parameter_server_tpu_torch.kv.server.KVServer`\\ s through a
  :class:`~parameter_server_tpu_torch.kv.worker.KVWorker` with an
  :class:`~parameter_server_tpu_torch.utils.keys.IdentityLocalizer`, so token
  id == table row.  A pull answers with ``ps_gather`` on each server; a push
  is merged per row on the worker (``segment_combine``) and applied with the
  fused row-wise optimizer (``ps_apply``);
- **the dense body trains on one card** (the JAX trainer's GSPMD mesh
  collapses to ``device``): forward, causal loss, backward and AdamW, the
  gradient with respect to the input embeddings flowing back to the table.

Pushes are not waited one by one: ``max_delay`` of them may be in flight
before a step blocks on the oldest ack (SSP's τ; 0 = BSP).  With
``step(next_tokens=...)`` the next step's rows are pulled right behind this
step's push, so the pull's latency hides behind the body; per-link FIFO
makes those rows include this step's update.

``save`` / ``restore`` cover both planes: the table through
``KVWorker.save_model`` (the shard files both packages read), the body into
``hybrid_body_{step:06d}.npz`` laid out as the JAX trainer lays it out:
``p{i}`` the parameters in ``jax.tree`` order (flax paths sorted), ``o{i}``
optax ``adamw``'s state leaves (``count`` as int32, then ``mu``, then
``nu``, each in that order).  A JAX-written checkpoint resumes here and the
other way round.

On a ``(data, model)`` mesh (``mesh=``) the body's parameters are DTensors
placed by ``parallel/tp.py``'s rules, and the step is the JAX trainer's
multi-process branch, since a torch rank is a process of its own: each
``data`` index owns its ``local_batch_slice`` of the global batch.  The
``model``-index-0 rank of each ``data`` line is the one that talks to the
Van: it pulls only its slice's rows (host arrays: a socket Van carries no
card tensors), broadcasts them over its ``model`` group, and after the body
step pushes only its slice's gradients, once.  The body computes as Megatron
splits over ``model`` (``parallel/tp.py``: each rank its heads, its slice of
``d_ff`` and of the vocabulary, the loss vocab-parallel); the input
embeddings are replicated over ``model`` and ``tp.copy_to_model`` sums their
gradient there, so every rank of the line holds the same rows' gradient.
Each data block's parameter gradients are summed over ``data`` with
``Mesh.all_reduce``; the loss is the global batch's.  A prefetch pulls the next batch's slice.
``launch_hybrid.py`` runs this across processes with the embedding servers
behind ``TcpVan``.
"""

from __future__ import annotations

import collections
import os
from typing import Dict, Optional

import numpy as np
import torch

from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
from parameter_server_tpu_torch.learner.lm import adamw, lm_dashboard
from parameter_server_tpu_torch.models import transformer as tfm
from parameter_server_tpu_torch.models.layers import flat_items, params_tree
from parameter_server_tpu_torch.utils import metrics as metrics_lib
from parameter_server_tpu_torch.utils.keys import IdentityLocalizer
from parameter_server_tpu_torch.utils.trace import NULL_TRACER


def embedding_table_cfg(
    cfg: tfm.TransformerConfig,
    *,
    learning_rate: float = 0.05,
    optimizer: str = "adagrad",
) -> TableConfig:
    """KV table config for the PS-served embedding: row per token id."""
    return TableConfig(
        name="emb",
        rows=cfg.vocab_size,
        dim=cfg.d_model,
        optimizer=OptimizerConfig(kind=optimizer, learning_rate=learning_rate),
        init_scale=0.02,  # normal(0.02) rows, matching the dense init
    )


def embedding_localizers(cfg: tfm.TransformerConfig) -> Dict[str, object]:
    """Localizer map for :class:`KVWorker`: identity (token id == row)."""
    return {"emb": IdentityLocalizer(cfg.vocab_size)}


class _Objective(torch.nn.Module):
    """The trainer's loss as a module over its body, so
    ``torch.func.functional_call`` runs it on the rank's shards."""

    def __init__(self, trainer: "HybridLMTrainer") -> None:
        super().__init__()
        self.body = trainer.body
        self._loss = trainer._loss

    def forward(self, emb, tok):
        return self._loss(emb, tok)


class HybridLMTrainer:
    """One step = Van pull (rows) -> body forward / backward -> Van push
    (per-position embedding gradients).

    ``max_delay``: how many embedding pushes may be in flight before the
    next step blocks on the oldest ack (τ of SSP; 0 = BSP, every push
    waited before the next pull).
    """

    def __init__(
        self,
        cfg: tfm.TransformerConfig,
        worker,
        *,
        mesh=None,
        table: str = "emb",
        learning_rate: float = 1e-3,
        max_delay: int = 0,
        seed: int = 0,
        dashboard: Optional[metrics_lib.Dashboard] = None,
        push_timeout: float = 60.0,
        tracer=None,
        loss_chunk: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        """``loss_chunk > 0`` fuses the lm_head into the checkpointed
        chunked loss (``chunked_causal_lm_loss``): the f32 [B, S, vocab]
        logits never exist whole.  ``mesh``: a ``(data, model)`` mesh to run
        the body on (``device`` is then the mesh's); ``worker`` may be None
        on a rank that does not talk to the Van (``model`` index > 0)."""
        if cfg.tie_embeddings:
            raise ValueError(
                "hybrid requires untied embeddings: the lm_head is dense, "
                "the input table is PS-served"
            )
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.device
        self.worker = worker
        self.table = table
        self.max_delay = max_delay
        self.push_timeout = push_timeout
        self.loss_chunk = loss_chunk
        self.dashboard = lm_dashboard(dashboard, self.device)
        from parameter_server_tpu_torch.parallel import tp

        # the blocks' config: the mesh's model axis is the split they compute
        self.body = tfm.TransformerBody(tp.split_config(cfg, mesh), device=self.device,
                                        generator=tfm.make_generator(self.device, seed))
        #: body parameter count for the MFU column (6ND: train FLOPs ~ 6 x
        #: params x tokens, set a step since the sequence rides the batch)
        self.n_body_params = sum(int(p.numel()) for p in self.body.parameters())
        if mesh is None:
            self.params = None
            self.optimizer = adamw(self.body.parameters(), learning_rate)
        else:
            from parameter_server_tpu_torch.parallel import mesh as mesh_lib

            self.shardings = tp.transformer_param_shardings(self.body, mesh)
            #: dotted name -> DTensor parameter; the module keeps only the
            #: structure they run in (on ``meta``)
            self.params = tp.place_params(self.body, mesh, self.shardings)
            tfm.release_to_meta(self.body)
            self.optimizer = adamw(self.params.values(), learning_rate)
            self._objective = _Objective(self)
            self._n_data = mesh.shape[mesh_lib.DATA_AXIS]
            self._data_index = mesh.index(mesh_lib.DATA_AXIS)
            #: this rank talks to the Van for its data slice
            self.van_rank = mesh.index(mesh_lib.MODEL_AXIS) == 0
            if self.van_rank and worker is None:
                raise ValueError("the model-index-0 rank of each data line needs a worker")
        self._inflight: collections.deque[int] = collections.deque()
        #: (pull_ts, tokens) announced via ``step(next_tokens=...)``
        self._prefetch: Optional[tuple] = None
        self.tracer = tracer or NULL_TRACER
        self.step_count = 0

    def _loss(self, emb_in: torch.Tensor, targets: torch.Tensor) -> torch.Tensor:
        cfg = self.body.cfg
        if self.loss_chunk > 0:
            return tfm.chunked_causal_lm_loss(self.body.trunk(emb_in),
                                              self.body.lm_head.kernel, targets,
                                              self.loss_chunk, cfg)
        return tfm.causal_lm_loss(self.body(emb_in), targets, cfg)

    def _body_step(self, emb: torch.Tensor, tok: torch.Tensor):
        """Loss, AdamW on the body, and the gradient with respect to the
        input embeddings (what flows back to the table).  On a mesh: this
        rank's data block's share of the global loss (the shares sum to it),
        on its ``model`` shards, the parameter gradients summed over ``data``
        before AdamW; the returned loss is the global one."""
        self.body.train()
        emb = emb.detach().to(torch.float32).requires_grad_(True)
        if self.mesh is None:
            loss = self._loss(emb, tok)
        else:
            from torch.func import functional_call

            from parameter_server_tpu_torch.parallel import tp

            # the gradients arrive on the model shards unsummed over data;
            # the all-reduce over data follows
            local = {f"body.{n}": t for n, t in
                     tp.materialize(self.params, self.mesh, partial_over=()).items()}
            loss = functional_call(self._objective, local, (emb, tok)) / self._n_data
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        if self.mesh is not None:
            from parameter_server_tpu_torch.parallel import mesh as mesh_lib

            for p in self.params.values():
                self.mesh.all_reduce(p.grad.to_local(), mesh_lib.DATA_AXIS)
            loss = self.mesh.all_reduce(loss.detach().clone(), mesh_lib.DATA_AXIS)
        self.optimizer.step()
        return loss.detach(), emb.grad

    # -- the hybrid hot path -------------------------------------------------
    def step(
        self,
        tokens: np.ndarray,
        *,
        next_tokens: Optional[np.ndarray] = None,
        pull_timeout: float = 60.0,
    ) -> float:
        """tokens [B, S] -> loss.  Van pull + body step + Van push.

        Rows arrive on the card (``pull_result_device``) and gradients leave
        as card tensors (``push_device``): the only host traffic is the token
        ids.  Pass ``next_tokens`` to prefetch the following step's rows:
        the pull is sent right after this step's push.  On a mesh, the
        multi-process branch (:meth:`_mesh_step`)."""
        tokens = np.asarray(tokens)
        if self.mesh is not None:
            loss_f = self._mesh_step(tokens, next_tokens, pull_timeout)
            self._record(tokens, loss_f)
            return loss_f
        # 1) PS plane: this batch's rows — from the prefetch if step(t-1)
        # announced them, else pulled now
        ts = None
        if self._prefetch is not None:
            pts, ptok = self._prefetch
            self._prefetch = None
            if ptok.shape == tokens.shape and np.array_equal(ptok, tokens):
                ts = pts
            else:  # the caller deviated from the announced batch: drain + repull
                self.worker.pull_result(pts, timeout=pull_timeout)
        if ts is None:
            ts = self.worker.pull(self.table, tokens)
        with self.tracer.span("hybrid.pull_wait"):
            emb_in = self.worker.pull_result_device(ts, timeout=pull_timeout)
        tok = torch.as_tensor(tokens.astype(np.int64)).to(self.device)
        # 2) dense plane: the body step, queued on the card (the host goes on
        # to the push and prefetch while it runs)
        with self.tracer.span("hybrid.body_dispatch"):
            loss, g_emb = self._body_step(emb_in.to(self.device), tok)
        # 3) PS plane: push the per-position embedding gradients as card
        # tensors.  The push MUST precede the prefetch pull: both are async
        # submits, and per-link FIFO then makes the prefetched rows include
        # this step's update (pull-before-push would hand back rows one
        # update stale even at max_delay=0)
        ts = self.worker.push_device(self.table, tokens.reshape(-1),
                                     g_emb.reshape(-1, self.cfg.d_model))
        # 4) prefetch the next batch's rows
        if next_tokens is not None:
            next_tokens = np.asarray(next_tokens)
            self._prefetch = (self.worker.pull(self.table, next_tokens), next_tokens)
        self._inflight.append(ts)
        self._bound_inflight()
        with self.tracer.span("hybrid.loss_sync"):
            loss_f = float(loss)
        self._record(tokens, loss_f)
        return loss_f

    def _bound_inflight(self) -> None:
        while len(self._inflight) > self.max_delay:
            old = self._inflight.popleft()
            if not self.worker.wait(old, timeout=self.push_timeout):
                raise TimeoutError(f"embedding push ts={old} not acked")

    def _record(self, tokens: np.ndarray, loss_f: float) -> None:
        self.step_count += 1
        emb_mb = tokens.size * self.cfg.d_model * 4 * 2 / 1e6  # pull + push
        # one example = one sequence: 6 x body params x seq tokens
        self.dashboard.flops_per_example = 6.0 * self.n_body_params * tokens.shape[1]
        self.dashboard.record(self.step_count, loss_f, examples=tokens.shape[0],
                              extra={"emb_plane_mb": round(emb_mb, 3)})

    def _mesh_step(self, tokens: np.ndarray, next_tokens, pull_timeout: float) -> float:
        """The multi-process branch: this data index's slice of the batch,
        its rows pulled and its gradients pushed by the line's Van rank as
        host arrays, the rows broadcast over the ``model`` group."""
        import torch.distributed as dist

        from parameter_server_tpu_torch.parallel import distributed
        from parameter_server_tpu_torch.parallel import mesh as mesh_lib

        B, S = tokens.shape
        d = self.cfg.d_model
        sl = distributed.local_batch_slice(self._data_index, self._n_data, B)
        feed = tokens[sl]
        if self.van_rank:
            ts = None
            if self._prefetch is not None:
                pts, ptok = self._prefetch
                self._prefetch = None
                if ptok.shape == tokens.shape and np.array_equal(ptok, tokens):
                    ts = pts
                else:  # the caller deviated from the announced batch
                    self.worker.pull_result(pts, timeout=pull_timeout)
            if ts is None:
                ts = self.worker.pull(self.table, feed)
            with self.tracer.span("hybrid.pull_wait"):
                rows = np.asarray(self.worker.pull_result(ts, timeout=pull_timeout), np.float32)
            emb = torch.from_numpy(rows.reshape(feed.shape + (d,))).to(self.device)
        else:
            emb = torch.empty(feed.shape + (d,), dtype=torch.float32, device=self.device)
        if self.mesh.shape[mesh_lib.MODEL_AXIS] > 1:
            group = self.mesh.group(mesh_lib.MODEL_AXIS)
            dist.broadcast(emb, dist.get_global_rank(group, 0), group=group)
        tok = torch.as_tensor(feed.astype(np.int64)).to(self.device)
        with self.tracer.span("hybrid.body_dispatch"):
            loss, g_emb = self._body_step(emb, tok)
        if self.van_rank:
            # push before the prefetch pull (per-link FIFO: the prefetched
            # rows include this step's update)
            self._inflight.append(self.worker.push(
                self.table, feed.reshape(-1), g_emb.cpu().numpy().reshape(-1, d)))
            if next_tokens is not None:
                next_tokens = np.asarray(next_tokens)
                # the NEXT batch's slice: its size may differ from this one's
                nsl = distributed.local_batch_slice(self._data_index, self._n_data,
                                                    next_tokens.shape[0])
                self._prefetch = (self.worker.pull(self.table, next_tokens[nsl]),
                                  next_tokens)
            self._bound_inflight()
        with self.tracer.span("hybrid.loss_sync"):
            return float(loss)

    def drain(self) -> None:
        """Block until every in-flight embedding push is acked (epoch end),
        and consume a dangling announced prefetch (its kept replies would
        otherwise stay pinned in the worker).  A rank without a worker has
        nothing in flight."""
        if self.worker is None:
            return
        while self._inflight:
            old = self._inflight.popleft()
            if not self.worker.wait(old, timeout=self.push_timeout):
                raise TimeoutError(f"embedding push ts={old} not acked")
        if self._prefetch is not None:
            pts, _ptok = self._prefetch
            self._prefetch = None
            self.worker.pull_result(pts, timeout=self.push_timeout)

    # -- checkpoint / resume of the whole config-#5 state ----------------------
    def _named_params(self) -> list:
        """(dotted path, parameter) in ``jax.tree`` order; on a mesh the
        placed DTensors."""
        if self.mesh is None:
            return list(flat_items(params_tree(self.body)))
        tree: dict = {}
        for name, p in self.params.items():
            *path, leaf = name.split(".")
            node = tree
            for part in path:
                node = node.setdefault(part, {})
            node[leaf] = p
        return list(flat_items(tree))

    def _param_leaves(self) -> list:
        return [p for _, p in self._named_params()]

    @staticmethod
    def _host(t: torch.Tensor) -> np.ndarray:
        """A whole host copy (a DTensor's ``full_tensor``: a collective)."""
        full = t.full_tensor() if hasattr(t, "full_tensor") else t
        return full.detach().cpu().numpy()

    def _opt_leaves(self) -> list:
        """optax adamw's state leaves: [count, *mu, *nu] (host arrays)."""
        params = self._param_leaves()
        states = [self.optimizer.state.get(p, {}) for p in params]
        count = int(states[0]["step"]) if states and "step" in states[0] else 0
        host = [np.asarray(count, np.int32)]
        for key in ("exp_avg", "exp_avg_sq"):
            host += [self._host(s[key]) if key in s
                     else np.zeros(tuple(p.shape), np.float32)
                     for p, s in zip(params, states)]
        return host

    def _barrier(self) -> None:
        if self.mesh is not None and self.mesh.size > 1:
            import torch.distributed as dist

            dist.barrier()

    def save(self, root: str, step: int, *, timeout: float = 600.0) -> None:
        """Checkpoint the embedding table (PS shards) and the body's
        parameters and AdamW state (npz), under one step.  On a mesh every
        rank calls it: the pushes of every data line land first (a barrier),
        rank 0 writes both, and every rank waits for it at a barrier."""
        self.drain()  # every push applied before the server shards snapshot
        self._barrier()
        flat = {f"p{i}": self._host(p) for i, p in enumerate(self._param_leaves())}
        flat.update({f"o{i}": leaf for i, leaf in enumerate(self._opt_leaves())})
        if self.mesh is None or self.mesh.device_mesh.get_rank() == 0:
            self.worker.save_model(root, step, timeout=timeout)
            path = os.path.join(root, f"hybrid_body_{step:06d}.npz")
            tmp = path + ".tmp"
            with open(tmp, "wb") as f:
                np.savez(f, **flat)
            os.replace(tmp, path)
        self._barrier()

    def _placed_like(self, p: torch.Tensor, arr) -> torch.Tensor:
        t = torch.from_numpy(np.asarray(arr, np.float32)).reshape(tuple(p.shape))
        if self.mesh is None:
            return t.to(p.device)
        from torch.distributed.tensor import distribute_tensor

        return distribute_tensor(t.to(self.device), self.mesh.device_mesh, p.placements)

    def restore(self, root: str, step: int, *, timeout: float = 600.0) -> None:
        """Restore both planes; the trainer continues mid-trajectory.  On a
        mesh every rank calls it and rank 0 loads the table."""
        if self.mesh is None or self.mesh.device_mesh.get_rank() == 0:
            self.worker.load_model(root, step, timeout=timeout)
        params = self._param_leaves()
        n = len(params)
        path = os.path.join(root, f"hybrid_body_{step:06d}.npz")
        with np.load(path) as z, torch.no_grad():
            for i, p in enumerate(params):
                p.copy_(self._placed_like(p, z[f"p{i}"]))
            count = int(z["o0"])
            for i, p in enumerate(params):
                # torch keeps the step count as a float scalar on the host
                # (AdamW's non-capturable form); optax an int32
                self.optimizer.state[p] = {
                    "step": torch.tensor(float(count), dtype=torch.float32),
                    "exp_avg": self._placed_like(p, z[f"o{1 + i}"]),
                    "exp_avg_sq": self._placed_like(p, z[f"o{1 + n + i}"]),
                }
        self._barrier()

    @torch.no_grad()
    def logits(self, tokens: np.ndarray, *, pull_timeout: float = 60.0) -> np.ndarray:
        """Logits of the whole batch.  On a mesh every rank calls it, each
        with a worker (the vocabulary is gathered over ``model``: a
        collective)."""
        tokens = np.asarray(tokens)
        emb_in = self.worker.pull_sync(self.table, tokens, timeout=pull_timeout)
        x = torch.as_tensor(np.asarray(emb_in, np.float32)).to(self.device)
        if self.mesh is None:
            return self.body(x).cpu().numpy()
        from torch.func import functional_call

        from parameter_server_tpu_torch.parallel import tp

        local = functional_call(self.body, tp.materialize(self.params, self.mesh), (x,))
        return tp.gather_vocab(local, self.mesh, self.cfg.vocab_size).cpu().numpy()
