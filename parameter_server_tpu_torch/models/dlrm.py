"""DLRM / Wide&Deep — BASELINE config #3 (billion-row sparse embeddings).

Torch counterpart of ``parameter_server_tpu/models/dlrm.py``, on one card.
Dense features go through the bottom MLP; categorical features become
embedding rows of the PS table; pairwise dot products of the features
(interactions) and the bottom output feed the top MLP, which gives the CTR
logit.

The embedding table is the parameter-server table, ``[rows + 1, dim]`` value
and optimizer-state planes on the card (the last row is the trash row that
bucket pads point at).  A step gathers the batch's bucketed unique rows of
every plane in one ``ps_gather`` launch, differentiates with respect to
*those rows only* (the expansion ``rows[inverse]`` takes its gradient back
through the deterministic segment sum of ``ops/scatter.py``), applies the
row-wise ServerOptimizer to them and writes every plane back in one
``ps_scatter_set`` launch.  The table planes never require a gradient, so
per-step memory is O(batch), never O(table).

On one card the JAX package's (data, model) mesh collapses: the trainer takes
``device`` where the JAX trainer takes ``mesh``.

MFU: the step's numerator is :func:`dense_step_flops`, a flop count of the
dense part (both MLPs, the interactions, the loss and their backward), which
holds every matmul FLOP of a DLRM step.  The gathers and scatters of the
table run through ctypes kernels on raw pointers and cannot run on the
``meta`` device; they are data movement, which the count leaves out anyway.
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
from torch import nn

from parameter_server_tpu_torch.config import TableConfig
from parameter_server_tpu_torch.kv.optim import ServerOptimizer, make_optimizer
from parameter_server_tpu_torch.models.layers import Dense
from parameter_server_tpu_torch.models.linear import logloss
from parameter_server_tpu_torch.ops import scatter
from parameter_server_tpu_torch.utils import metrics as metrics_lib
from parameter_server_tpu_torch.utils.keys import HashLocalizer, localize_to_slots


class MLP(nn.Module):
    """flax ``MLP``: ``Dense_i`` layers, ReLU after each (after the last only
    with ``final_activation``)."""

    def __init__(self, in_features: int, features: Sequence[int],
                 final_activation: bool = True,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.final_activation = final_activation
        self.n_layers = len(features)
        for i, f in enumerate(features):
            self.add_module(f"Dense_{i}", Dense(in_features, f, generator))
            in_features = f

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        for i in range(self.n_layers):
            x = getattr(self, f"Dense_{i}")(x)
            if i < self.n_layers - 1 or self.final_activation:
                x = torch.relu(x)
        return x


class DLRM(nn.Module):
    """Dense part of DLRM: bottom MLP (``MLP_0``), interactions, top MLP
    (``MLP_1``).  The embedding rows come in as an argument (they live in the
    PS table)."""

    def __init__(self, n_dense: int, n_sparse: int, bottom_mlp: Sequence[int],
                 top_mlp: Sequence[int], emb_dim: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        f = n_sparse + 1  # the bottom output is one more feature
        self.MLP_0 = MLP(n_dense, tuple(bottom_mlp) + (emb_dim,), generator=generator)
        self.MLP_1 = MLP(emb_dim + f * (f - 1) // 2, tuple(top_mlp) + (1,),
                         final_activation=False, generator=generator)
        # the strict upper triangle of the [F, F] interactions, row-major (the
        # order of jnp.triu_indices(f, k=1)), as flat indices into F * F
        iu, ju = torch.triu_indices(f, f, 1)
        self.register_buffer("pairs", iu * f + ju, persistent=False)

    def forward(self, dense_feats: torch.Tensor, emb: torch.Tensor) -> torch.Tensor:
        """dense_feats [B, n_dense]; emb [B, n_sparse, emb_dim] -> logits [B]."""
        bottom = self.MLP_0(dense_feats)
        feats = torch.cat([bottom[:, None, :], emb], dim=1)  # [B, F, D]
        inter = torch.bmm(feats, feats.transpose(1, 2))  # [B, F, F]
        inter_flat = inter.reshape(inter.shape[0], -1).index_select(1, self.pairs)
        return self.MLP_1(torch.cat([bottom, inter_flat], dim=1))[:, 0]


class _ExpandRows(torch.autograd.Function):
    """``rows[inverse]`` whose backward sums each row's positions with the
    deterministic ``segment_combine`` (a stable sort and a serial sum per row,
    in position order), where ``index_select``'s own backward would use float
    atomics on the card.  This is the JAX step's duplicate-combining
    segment-sum."""

    @staticmethod
    def forward(ctx, rows: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
        ctx.save_for_backward(inverse)
        ctx.num_rows = rows.shape[0]
        return rows.index_select(0, inverse)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        (inverse,) = ctx.saved_tensors
        return scatter.segment_combine(grad, inverse, ctx.num_rows), None


def expand_rows(rows: torch.Tensor, inverse: torch.Tensor) -> torch.Tensor:
    """``rows[inverse]`` with a deterministic backward (see ``_ExpandRows``)."""
    return _ExpandRows.apply(rows, inverse)


def make_dlrm_step(table_cfg: TableConfig, model: DLRM, optimizer: ServerOptimizer,
                   tx: torch.optim.Optimizer, n_sparse: int):
    """The DLRM train step as a function on tensors.

    ``step(emb_value, emb_state, ids, inverse, dense_feats, labels) -> loss``
    updates the table planes in place and the MLP through ``tx``, and returns
    the loss as a tensor on the table's device (no host sync).  ``ids`` are
    the bucketed unique slots (int32, pads at the trash row ``rows``),
    ``inverse`` maps each of the ``B * n_sparse`` positions to its slot.
    """
    names = optimizer.state_names()
    fills = optimizer.state_shapes()
    trash = table_cfg.rows  # trash row id (pads live there)

    def step(emb_value: torch.Tensor, emb_state: Dict[str, torch.Tensor],
             ids: torch.Tensor, inverse: torch.Tensor, dense_feats: torch.Tensor,
             labels: torch.Tensor) -> torch.Tensor:
        planes = [emb_value] + [emb_state[k] for k in names]
        gathered = scatter.gather_rows_planes(planes, ids)
        v_rows, s_rows = gathered[0], dict(zip(names, gathered[1:]))
        w_rows = optimizer.pull_weights(v_rows, s_rows).detach().requires_grad_()
        emb = expand_rows(w_rows, inverse).reshape(labels.shape[0], n_sparse, -1)
        loss = logloss(model(dense_feats, emb), labels)
        tx.zero_grad(set_to_none=True)
        loss.backward()
        tx.step()
        with torch.no_grad():
            new_v, new_s = optimizer.apply(v_rows, s_rows, w_rows.grad)
            # pads all gather the trash row and get a zero gradient, so they
            # write identical rows, as the scatter-set kernel requires
            scatter.scatter_update_rows_planes(planes, ids, [new_v] + [new_s[k] for k in names])
            # trash-row reset (PAD gradients)
            emb_value[trash].fill_(0.0)
            for k in names:
                emb_state[k][trash].fill_(fills[k])
        return loss.detach()

    return step


def dense_step_flops(model: DLRM, batch: int, n_dense: int, n_sparse: int,
                     dim: int) -> Dict[str, float]:
    """Matmul FLOPs of one DLRM step's dense part at ``batch`` examples —
    forward, loss and backward of the MLPs and the interactions, with the
    gradient taken back into the embedding rows — by kind
    (:func:`~parameter_server_tpu_torch.utils.metrics.counted_flops_by_kind`),
    counted on ``meta`` copies: nothing runs on the live model."""

    def step(m, dense_feats, emb, labels):
        logloss(m(dense_feats, emb), labels).backward()

    return metrics_lib.counted_flops_by_kind(
        step, model,
        torch.empty((batch, n_dense), device="meta"),
        torch.empty((batch, n_sparse, dim), device="meta", requires_grad=True),
        torch.empty((batch,), device="meta"),
    )


def init_sharded_table(
    table_cfg: TableConfig,
    optimizer: ServerOptimizer,
    total_rows: int,
    generator: Optional[torch.Generator] = None,
    kind: str = "normal",
    *,
    device: str | torch.device = "cuda",
) -> Tuple[torch.Tensor, Dict[str, torch.Tensor]]:
    """The value plane and the optimizer's state planes, ``[total_rows, dim]``
    each, made on ``device``.

    ``kind="normal"`` draws values from ``generator`` (on ``device``; seeded
    with 0 when None) scaled by ``init_scale``, and zeroes the trash and pad
    rows; ``kind="zeros"`` is a memset (cold-start embeddings at tens of GB).
    State planes hold their fills either way.
    """
    if kind not in ("normal", "zeros"):
        raise ValueError(f"kind must be normal|zeros, got {kind!r}")
    device = torch.device(device)
    shape = (total_rows, table_cfg.dim)
    if kind == "zeros":
        value = torch.zeros(shape, dtype=torch.float32, device=device)
    else:
        if generator is None:
            generator = torch.Generator(device=device).manual_seed(0)
        value = torch.randn(shape, generator=generator, dtype=torch.float32, device=device)
        value.mul_(table_cfg.init_scale)
        value[table_cfg.rows:] = 0.0  # trash + pad rows
    state = {k: torch.full(shape, fill, dtype=torch.float32, device=device)
             for k, fill in sorted(optimizer.state_shapes().items())}
    return value, state


class SpmdDLRMTrainer:
    """DLRM on one card: the PS embedding table on the device, the dense part
    trained by Adam."""

    def __init__(
        self,
        table_cfg: TableConfig,
        *,
        device: str | torch.device = "cuda",
        n_dense: int = 13,
        n_sparse: int = 26,
        bottom_mlp: Sequence[int] = (64, 32),
        top_mlp: Sequence[int] = (64, 32),
        learning_rate: float = 0.01,
        min_bucket: int = 1024,
        seed: int = 0,
        table_init: str = "normal",
        dashboard: Optional[metrics_lib.Dashboard] = None,
    ) -> None:
        self.cfg = table_cfg
        self.device = torch.device(device)
        self.n_sparse = n_sparse
        self.n_dense = n_dense
        self.min_bucket = min_bucket
        self.dashboard = dashboard or metrics_lib.Dashboard(print_every=0)
        self.step_count = 0
        #: (bucketed slots, batch) of the last MFU count: recounted when
        #: either changes shape, as the JAX trainer recounts its XLA cost
        self._flops_shape: Optional[Tuple[int, int]] = None
        self.optimizer: ServerOptimizer = make_optimizer(table_cfg.optimizer)
        self.localizer = HashLocalizer(table_cfg.rows, seed=seed)
        # one device: the trash row is the only row past ``rows``
        self.total_rows = table_cfg.rows + 1
        self.emb_value, self.emb_state = init_sharded_table(
            table_cfg, self.optimizer, self.total_rows,
            torch.Generator(device=self.device).manual_seed(seed), kind=table_init,
            device=self.device,
        )
        # the MLP is drawn on the host, so every device starts from the same one
        self.model = DLRM(n_dense, n_sparse, bottom_mlp, top_mlp, table_cfg.dim,
                          generator=torch.Generator().manual_seed(seed)).to(self.device)
        self.tx = torch.optim.Adam(self.model.parameters(), lr=learning_rate,
                                   betas=(0.9, 0.999), eps=1e-8)
        self._step = make_dlrm_step(table_cfg, self.model, self.optimizer, self.tx, n_sparse)

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return torch.from_numpy(np.ascontiguousarray(arr)).to(self.device)

    def step_localized(self, slots: np.ndarray, inverse: np.ndarray,
                       dense_feats: np.ndarray, labels: np.ndarray) -> torch.Tensor:
        """One step from host-localized slots; the loss stays on the device."""
        return self._step(self.emb_value, self.emb_state, self._to_device(slots),
                          self._to_device(inverse), self._to_device(dense_feats),
                          self._to_device(labels))

    def step(self, keys: np.ndarray, dense_feats: np.ndarray, labels: np.ndarray) -> float:
        slots, inverse, _n = localize_to_slots(keys, self.localizer, min_bucket=self.min_bucket)
        shape_key = (int(slots.shape[0]), int(labels.shape[0]))
        if shape_key != self._flops_shape:
            metrics_lib.set_mfu(
                self.dashboard,
                dense_step_flops(self.model, shape_key[1], self.n_dense, self.n_sparse,
                                 self.cfg.dim),
                shape_key[1], self.device,
            )
            self._flops_shape = shape_key
        loss_f = float(self.step_localized(slots, inverse, dense_feats, labels))
        self.step_count += 1
        self.dashboard.record(self.step_count, loss_f, examples=int(labels.shape[0]))
        return loss_f
