"""Sequence parallelism composed with tensor parallelism and FSDP-state.

Torch counterpart of ``parameter_server_tpu/parallel/sp_fsdp.py``: the
long-context trainer at scale, on an ``(sp, model)`` mesh, where

- the **sequence** is split over ``sp`` (ring attention, exact, O(S/n)
  activations a rank: ``attn_impl="ring_spmd"`` over the mesh's ``sp``
  line);
- the **weights** are placed by ``parallel/tp.py``'s rules over ``model``
  (DTensors) and computed with as Megatron splits: a step gathers them over
  ``sp`` only, and each rank runs the ring (or Ulysses) on its own heads,
  its slice of ``d_ff`` and of the vocabulary (the loss vocab-parallel);
- with ``fsdp="state"`` the **AdamW moments** are split over ``sp`` as well
  (ZeRO-style): each rank keeps and updates only its ``sp`` slice of every
  parameter's moments and then gathers the updated weights back over
  ``sp``;
- ``cfg.scan_blocks`` / ``cfg.remat`` and a chunked fused-head loss
  (:func:`sp_chunked_causal_loss`) bound activation memory.

The loss is each rank's chunked NLL over its own block, summed over ``sp``
into the global masked mean (the shift semantics of ``causal_lm_loss``).
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from parameter_server_tpu_torch.learner.lm import adamw
from parameter_server_tpu_torch.models import transformer as tfm
from parameter_server_tpu_torch.parallel import mesh as mesh_lib
from parameter_server_tpu_torch.parallel import tp
from parameter_server_tpu_torch.parallel.sp_lm import (
    SP_AXIS,
    block_positions,
    shift_targets,
    sp_mesh_check,
)
from parameter_server_tpu_torch.utils import metrics as metrics_lib

MODEL_AXIS = mesh_lib.MODEL_AXIS


class _SumToReplicated(torch.autograd.Function):
    """Sum a per-rank value over a mesh axis into one value every rank
    holds.  The caller's loss downstream is the same on every rank, so each
    rank's cotangent already is the replicated one: the backward is the
    identity (the transpose of ``psum`` into a replicated output)."""

    @staticmethod
    def forward(ctx, t, mesh, axis):
        return mesh.all_reduce(t.clone(), axis)

    @staticmethod
    def backward(ctx, g):
        return g, None, None


def sp_chunked_causal_loss(hidden: torch.Tensor, head_kernel: torch.Tensor,
                           targets: torch.Tensor, mask: torch.Tensor, *, mesh,
                           chunk: int, cfg=None) -> torch.Tensor:
    """Fused-head causal NLL of a sequence split over ``sp``.

    ``hidden`` ``[B, s_local, d]``, ``targets`` / ``mask`` ``[B, s_local]``:
    this rank's block, with the caller's shift (``targets[t] = tokens[t +
    1]``, the last global position masked).  The rank chunks its own block,
    each chunk under ``torch.utils.checkpoint`` so one ``[B, chunk, V]`` slab
    is live at a time, and the sums over ``sp`` give the global masked mean:
    ``causal_lm_loss(hidden @ head_kernel, tokens)`` up to summation order,
    the same value on every rank.  ``cfg``: the model's; where its mesh
    splits ``model``, ``head_kernel`` is the rank's vocabulary block and the
    NLL vocab-parallel (``models/transformer.py``'s losses)."""
    B, s_local, _d = hidden.shape
    hidden = tp.copy_to_model(hidden, None if cfg is None else cfg.spmd_mesh)
    c = min(chunk, s_local)
    pad = (-s_local) % c
    if pad:
        hidden = F.pad(hidden, (0, 0, 0, pad))
        targets = F.pad(targets, (0, pad))
        mask = F.pad(mask, (0, pad))
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for s in range(0, s_local + pad, c):
        args = (hidden[:, s:s + c], head_kernel, targets[:, s:s + c], mask[:, s:s + c], cfg)
        if torch.is_grad_enabled():
            total = total + checkpoint(tfm._chunk_nll, *args, use_reentrant=False)
        else:
            total = total + tfm._chunk_nll(*args)
    loss_sum = _SumToReplicated.apply(total, mesh, SP_AXIS)
    count = mesh.all_reduce(torch.sum(mask).detach().clone(), SP_AXIS)
    return loss_sum / torch.clamp(count, min=1.0)


class _Objective(torch.nn.Module):
    """The composed step's loss as a module over the model, so
    ``torch.func.functional_call`` runs it on the rank's shards."""

    def __init__(self, model: tfm.Transformer, mesh, chunk: int) -> None:
        super().__init__()
        self.model, self.mesh, self.chunk = model, mesh, chunk

    def forward(self, tok, tgt, msk):
        model = self.model
        B, s_local = tok.shape
        positions = block_positions(self.mesh, SP_AXIS, B, s_local, tok.device)
        hidden = model.trunk(model.embed(tok), positions=positions)
        return sp_chunked_causal_loss(hidden, model.lm_head.kernel, tgt, msk,
                                      mesh=self.mesh, chunk=self.chunk, cfg=model.cfg)


def make_sp_step(cfg_run: tfm.TransformerConfig, mesh, chunk: int):
    """The composed step's loss function, over a fresh model of
    ``cfg_run`` (which must carry ``attn_impl="ring_spmd"`` and the mesh):
    ``loss_fn(params, tok, tgt, msk)`` with ``params`` the rank's
    ``{dotted name: tensor}`` (``tp.materialize``) and the batch this rank's
    block.  Returns
    (loss_fn, the model whose structure the parameters run in)."""
    from torch.func import functional_call

    if cfg_run.attn_impl != "ring_spmd" or cfg_run.spmd_mesh is None:
        raise ValueError("make_sp_step needs cfg_run with attn_impl='ring_spmd' and spmd_mesh")
    model = tfm.Transformer(cfg_run, device="meta")
    objective = _Objective(model, mesh, chunk)

    def loss_fn(params, tok, tgt, msk):
        full = {f"model.{n}": t for n, t in params.items()}
        return functional_call(objective, full, (tok, tgt, msk))

    return loss_fn, model


class SpTpLMTrainer:
    """Causal LM: sequence over ``sp`` x weights over ``model`` x AdamW
    moments over ``sp`` too: the composed long-context trainer."""

    def __init__(
        self,
        cfg: tfm.TransformerConfig,
        mesh=None,
        *,
        learning_rate: float = 1e-3,
        seed: int = 0,
        fsdp: str = "state",
        loss_chunk: int = 512,
        dashboard: Optional[metrics_lib.Dashboard] = None,
        device: str | torch.device = "cuda",
    ) -> None:
        """``mesh``: an ``(sp, model)`` mesh; by default every rank of the
        world on ``sp`` and ``model`` 1 (a process with no world forms one of
        its own on ``device``)."""
        if fsdp not in ("none", "state"):
            raise ValueError(f"fsdp must be none|state, got {fsdp!r}")
        if mesh is None:
            mesh = mesh_lib.make_mesh(None, (SP_AXIS, MODEL_AXIS), device=device)
        sp_mesh_check(cfg, mesh, (SP_AXIS, MODEL_AXIS), "SpTpLMTrainer")
        self.mesh = mesh
        self.device = mesh.device
        self.n_shards = mesh.shape[SP_AXIS]
        self.fsdp = fsdp
        self.loss_chunk = int(loss_chunk)
        #: the runtime twin: the ring over the mesh's sp line
        self.cfg = dataclasses.replace(cfg, attn_impl="ring_spmd", sp_axis=SP_AXIS,
                                       spmd_mesh=mesh)
        init = tfm.Transformer(self.cfg, device=self.device,
                               generator=tfm.make_generator(self.device, seed))
        self.shardings = tp.transformer_param_shardings(init, mesh)
        #: dotted name -> DTensor parameter placed by the TP rules
        self.params = tp.place_params(init, mesh, self.shardings)
        self.n_matmul_params = metrics_lib.lm_matmul_params(
            init.state_dict(), frozenset({"pos_embedding", "embedding"}))
        del init
        #: the moments' layout: with fsdp="state" the TP spec plus sp on the
        #: first free dim
        self.state_shardings = (tp.transformer_param_shardings(
            self.params, mesh, fsdp=True, fsdp_axis=SP_AXIS) if fsdp == "state"
            else self.shardings)
        self.learning_rate = learning_rate
        self.reslice()
        self._loss_fn, self.model = make_sp_step(self.cfg, mesh, self.loss_chunk)
        self.dashboard = metrics_lib.trainer_dashboard(
            dashboard, mesh.size, metrics_lib.float32_math_mode("matmul"), self.device)
        self.step_count = 0

    def reslice(self) -> None:
        """(Re)build what AdamW updates from the placed parameters, with
        fresh moments: with fsdp="state" each parameter's ``sp`` slice, else
        the parameters themselves."""
        if self.fsdp == "state":
            self._slices = {n: torch.nn.Parameter(p.detach().redistribute(
                self.mesh.device_mesh, self.state_shardings[n].placements))
                for n, p in self.params.items()}
        else:
            self._slices = self.params
        self.optimizer = adamw(self._slices.values(), self.learning_rate)

    def _place(self, tokens: np.ndarray):
        """This rank's ``sp`` block of the shifted batch, on its device."""
        tokens, targets, mask = shift_targets(tokens, self.n_shards, self.cfg)
        s_local = tokens.shape[1] // self.n_shards
        i = self.mesh.index(SP_AXIS)
        cols = slice(i * s_local, (i + 1) * s_local)
        return tuple(torch.from_numpy(np.ascontiguousarray(a[:, cols])).to(self.device)
                     for a in (tokens, targets, mask))

    def _full(self):
        # gathered over sp only (a no-op: the weights are replicated there),
        # the model shards kept; each rank's gradient is its sequence block's
        # share: partial over sp
        return tp.materialize(self.params, self.mesh, partial_over=(SP_AXIS,))

    def step(self, tokens: np.ndarray) -> float:
        loss_f = float(self._update(tokens))
        self.step_count += 1
        self.dashboard.flops_per_example = 6.0 * self.n_matmul_params * tokens.shape[1]
        self.dashboard.record(self.step_count, loss_f, examples=int(tokens.shape[0]))
        return loss_f

    def _update(self, tokens: np.ndarray) -> torch.Tensor:
        """The step with the loss left on the device (``parallel/
        feasibility.py`` traces it on fake tensors)."""
        tok, tgt, msk = self._place(tokens)
        self.model.train()
        loss = self._loss_fn(self._full(), tok, tgt, msk)
        self.optimizer.zero_grad(set_to_none=True)
        for p in self.params.values():
            p.grad = None
        loss.backward()
        if self.fsdp == "state":
            for n, p in self.params.items():
                # replicated over sp -> this rank's sp slice: no traffic
                self._slices[n].grad = p.grad.redistribute(
                    self.mesh.device_mesh, self.state_shardings[n].placements)
            self.optimizer.step()
            with torch.no_grad():
                for n, p in self.params.items():  # gather the updated slices over sp
                    p.copy_(self._slices[n].redistribute(self.mesh.device_mesh,
                                                         self.shardings[n].placements))
        else:
            self.optimizer.step()
        return loss.detach()

    @torch.no_grad()
    def loss(self, tokens: np.ndarray) -> float:
        return float(self._loss_fn(self._full(), *self._place(tokens)))
