"""Sequence-parallel causal-LM trainer: ring attention inside the model.

Torch counterpart of ``parameter_server_tpu/parallel/sp_lm.py``: long-context
training with the sequence split over an ``sp`` mesh axis.  Every
position-local layer (norms, MLP, rotary, the embedding gather, the head,
the loss) runs on the rank's sequence block as it is, and attention is the
exact ring (``ops/ring_attention.py``) or Ulysses (``ops/ulysses.py``) over
the rank's ``sp`` line, so a rank's activations are O(seq / n).

Parameters are replicated: each rank holds the whole tree, initialised from
one seed exactly as the dense :class:`~parameter_server_tpu_torch.models.
transformer.Transformer` (the same parameter tree, so weights move freely
between the two).  A step runs the rank's block with positions ``idx *
s_local + arange(s_local)``; the loss is ``sum(nll * mask) / count`` with
both summed over ``sp`` (and ``data`` when the mesh has it, which splits
the batch rows); each rank's gradients are its share of that loss, summed
over the same axes with ``Mesh.all_reduce`` before AdamW, so every rank
takes the same update.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch

from parameter_server_tpu_torch.learner.lm import adamw
from parameter_server_tpu_torch.models import transformer as tfm
from parameter_server_tpu_torch.parallel import mesh as mesh_lib
from parameter_server_tpu_torch.utils import metrics as metrics_lib

SP_AXIS = "sp"


def shift_targets(tokens: np.ndarray, n_shards: int, cfg: tfm.TransformerConfig):
    """Host-side next-token targets and loss mask of a ``[B, S]`` batch
    (``targets[t] = tokens[t + 1]``, the last global position masked), after
    the sequence checks a sharded step needs: ``S`` divisible by the ``sp``
    shards and, with learned positions, at most ``max_seq`` (an index past
    the position table must fail here, where the global ``S`` is known)."""
    tokens = np.asarray(tokens, np.int64)
    B, S = tokens.shape
    if S % n_shards:
        raise ValueError(f"seq {S} % sp shards {n_shards} != 0")
    if cfg.positional == "learned" and S > cfg.max_seq:
        raise ValueError(f"global sequence {S} exceeds learned-positional max_seq "
                         f"{cfg.max_seq}")
    targets = np.concatenate([tokens[:, 1:], np.zeros((B, 1), np.int64)], axis=1)
    mask = np.repeat((np.arange(S) < S - 1).astype(np.float32)[None], B, axis=0)
    return tokens, targets, mask


def block_positions(mesh, sp_axis: str, B: int, s_local: int, device) -> torch.Tensor:
    """Global positions ``[B, s_local]`` of this rank's sequence block."""
    start = mesh.index(sp_axis) * s_local
    return (start + torch.arange(s_local, device=device)).expand(B, s_local)


def sp_mesh_check(cfg: tfm.TransformerConfig, mesh, axes, who: str) -> None:
    for axis in axes:
        if axis not in mesh.axis_names:
            raise ValueError(f"mesh must carry a {axis!r} axis, got {mesh.axis_names}")
    if not cfg.causal:
        raise ValueError(f"{who} is a causal-LM trainer")
    if cfg.tie_embeddings:
        raise ValueError(f"{who} needs untied embeddings (the head matmul runs on "
                         "sequence shards via params['lm_head'])")


class SpLMTrainer:
    """Causal LM trained with the sequence split over ``sp``."""

    def __init__(
        self,
        cfg: tfm.TransformerConfig,
        mesh=None,
        *,
        learning_rate: float = 1e-3,
        seed: int = 0,
        dashboard: Optional[metrics_lib.Dashboard] = None,
        attn: str = "ring",
        device: str | torch.device = "cuda",
    ) -> None:
        """``mesh``: an ``("sp",)`` or ``("data", "sp")`` mesh; by default
        every rank of the world on ``sp`` (a process with no world forms one
        of its own on ``device``).  ``attn``: "ring" (K/V rotate; O(S/n)
        memory everywhere, the long-context default) or "ulysses" (all-to-all
        head redistribution; full-sequence scores for a subset of heads)."""
        if attn not in ("ring", "ulysses"):
            raise ValueError(f"attn must be ring|ulysses, got {attn!r}")
        if mesh is None:
            mesh = mesh_lib.make_mesh(None, (SP_AXIS,), device=device)
        sp_mesh_check(cfg, mesh, (SP_AXIS,), "SpLMTrainer")
        self.mesh = mesh
        self.device = mesh.device
        self.n_shards = mesh.shape[SP_AXIS]
        #: DP x SP: a "data" axis beside "sp" splits the batch rows, and the
        #: loss and gradients sum over both
        self._data_axis = mesh_lib.DATA_AXIS if mesh_lib.DATA_AXIS in mesh.axis_names else None
        self._axes = (SP_AXIS,) if self._data_axis is None else (self._data_axis, SP_AXIS)
        #: the SP twin of the caller's config (the same parameter tree)
        self.cfg = dataclasses.replace(cfg, attn_impl=attn, sp_axis=SP_AXIS, spmd_mesh=mesh)
        self.model = tfm.Transformer(self.cfg, device=self.device,
                                     generator=tfm.make_generator(self.device, seed))
        self.optimizer = adamw(self.model.parameters(), learning_rate)
        self.dashboard = metrics_lib.trainer_dashboard(
            dashboard, mesh.size, metrics_lib.float32_math_mode("matmul"), self.device)
        self.n_matmul_params = metrics_lib.lm_matmul_params(
            self.model.state_dict(), frozenset({"pos_embedding", "embedding"}))
        self.step_count = 0

    def _sum(self, t: torch.Tensor) -> torch.Tensor:
        for axis in self._axes:
            self.mesh.all_reduce(t, axis)
        return t

    def _place(self, tokens: np.ndarray):
        """This rank's block of the shifted batch: its ``data`` rows and its
        ``sp`` stretch of the sequence, on its device."""
        tokens, targets, mask = shift_targets(tokens, self.n_shards, self.cfg)
        B, S = tokens.shape
        s_local = S // self.n_shards
        i = self.mesh.index(SP_AXIS)
        cols = slice(i * s_local, (i + 1) * s_local)
        rows = slice(0, B)
        if self._data_axis is not None:
            from parameter_server_tpu_torch.parallel import distributed

            rows = distributed.local_batch_slice(self.mesh.index(self._data_axis),
                                                 self.mesh.shape[self._data_axis], B)
        return tuple(torch.from_numpy(np.ascontiguousarray(a[rows, cols])).to(self.device)
                     for a in (tokens, targets, mask))

    def _local(self, tok, tgt, msk):
        """(this rank's masked NLL sum, the global count)."""
        model = self.model
        B, s_local = tok.shape
        positions = block_positions(self.mesh, SP_AXIS, B, s_local, self.device)
        hidden = model.trunk(model.embedding[tok], positions=positions)
        logits = tfm._lm_head(self.cfg, model.lm_head, hidden)
        loss_sum = torch.sum(tfm._nll(logits, tgt) * msk)
        count = self._sum(torch.sum(msk).detach().clone())
        return loss_sum, torch.clamp(count, min=1.0)

    def step(self, tokens: np.ndarray) -> float:
        tok, tgt, msk = self._place(tokens)
        self.model.train()
        loss_sum, count = self._local(tok, tgt, msk)
        self.optimizer.zero_grad(set_to_none=True)
        (loss_sum / count).backward()
        for p in self.model.parameters():
            self._sum(p.grad)
        self.optimizer.step()
        loss_f = float(self._sum(loss_sum.detach().clone()) / count)
        self.step_count += 1
        self.dashboard.flops_per_example = 6.0 * self.n_matmul_params * tokens.shape[1]
        self.dashboard.record(self.step_count, loss_f, examples=int(tokens.shape[0]))
        return loss_f

    @torch.no_grad()
    def loss(self, tokens: np.ndarray) -> float:
        loss_sum, count = self._local(*self._place(tokens))
        return float(self._sum(loss_sum.clone()) / count)
