"""SPMD sparse-LR training over a (data, model) mesh.

Torch counterpart of ``parameter_server_tpu/parallel/lr_spmd.py``: the
multi-device version of :func:`models.linear.dense_fused_step`, with the
collectives GSPMD inserts in JAX written out over the mesh's groups.

- table value / state: contiguous row blocks over ``model`` (the reference's
  server key-range partition); each rank holds ``total_rows / n_model`` rows
  as a plain local tensor.  Bias and its state are replicated.
- batch (slots, labels): split over ``data`` (the worker data shards); the
  ranks of one ``model`` group see the same rows.

One step (:func:`sharded_dense_step`):

1. each rank reads the per-position weights of the slots it owns — rows it
   does not own read as exact zeros — and sums them over ``model``.  Every
   slot has one owner, so the sum is exact (x + 0): every rank then holds
   the single-device ``w[slot]`` values, bit for bit;
2. loss and residual ``(p - y) / global_batch`` on the rank's rows (the same
   on every rank of a ``model`` group);
3. each rank segment-sums the residuals of its owned slots into a gradient
   for its own block (the deterministic ``scatter.segment_combine``) and sums
   it over ``data``: the "psum before push" of ``parallel/mesh.py``;
4. the trash row's gradient is zeroed on its owner, and the dense rule runs
   elementwise over the local block; the bias's gradient is summed over
   ``data`` and its rule runs everywhere.

The data-axis sum changes the float order against one device, so a multi-rank
run matches it to float tolerance, as the JAX one does.  On a mesh of one
rank every collective is skipped and the step is ``dense_fused_step``'s
arithmetic.  Like the JAX module, this reaches no Pallas / CUDA kernel.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch.config import TableConfig
from parameter_server_tpu_torch.kv.optim import (
    ServerOptimizer,
    make_optimizer,
    require_dense_apply,
)
from parameter_server_tpu_torch.models.linear import logloss, predict_logits
from parameter_server_tpu_torch.ops import scatter
from parameter_server_tpu_torch.parallel import distributed
from parameter_server_tpu_torch.parallel import mesh as mesh_lib
from parameter_server_tpu_torch.utils.keys import HashLocalizer


class ShardedLRState(NamedTuple):
    value: torch.Tensor  # this rank's [total_rows / n_model, 1] block
    state: Dict[str, torch.Tensor]
    bias: torch.Tensor  # [1, 1] replicated
    bias_state: Dict[str, torch.Tensor]


def _round_up(x: int, m: int) -> int:
    return ((x + m - 1) // m) * m


def sharded_dense_step(
    st: ShardedLRState,
    slots_pos: torch.Tensor,
    labels: torch.Tensor,
    optimizer: ServerOptimizer,
    trash_row: int,
    mesh: mesh_lib.Mesh,
    row_lo: int,
) -> torch.Tensor:
    """One dense-apply LR step on this rank's blocks, in place.

    ``slots_pos`` ``[b, nnz]`` and ``labels`` ``[b]`` are this rank's rows of
    the global batch (every data rank holds ``b`` of them); ``row_lo`` is the
    first table row this rank owns.  Returns the global mean loss, the same
    on every rank.
    """
    value, state, bias, bias_state = st
    names = list(state)
    n_data = mesh.shape[mesh_lib.DATA_AXIS]
    local_rows = value.shape[0]
    flat = slots_pos.reshape(-1).long()
    owned = (flat >= row_lo) & (flat < row_lo + local_rows)
    local = torch.where(owned, flat - row_lo, 0)
    w_pos = optimizer.pull_weights(
        torch.index_select(value, 0, local),
        {k: torch.index_select(state[k], 0, local) for k in names},
    )[:, 0]
    w_pos = mesh.all_reduce(torch.where(owned, w_pos, 0.0), mesh_lib.MODEL_AXIS)
    w_pos = w_pos.reshape(labels.shape[0], -1)
    bias_w = optimizer.pull_weights(bias, bias_state)
    logits = predict_logits(w_pos, bias_w[0, 0])
    loss = logloss(logits, labels)
    residual = (torch.sigmoid(logits) - labels) / (labels.shape[0] * n_data)
    g_pos = residual[:, None].expand(w_pos.shape).reshape(-1, 1)
    # positions this rank does not own land in one extra segment, dropped
    grad = scatter.segment_combine(g_pos, torch.where(owned, local, local_rows),
                                   local_rows + 1)[:local_rows]
    mesh.all_reduce(grad, mesh_lib.DATA_AXIS)
    if row_lo <= trash_row < row_lo + local_rows:
        grad[trash_row - row_lo].zero_()  # drop PAD contributions
    new_v, new_s = optimizer.apply(value, state, grad)
    value.copy_(new_v)
    for k in names:
        state[k].copy_(new_s[k])
    bias_grad = mesh.all_reduce(torch.sum(residual)[None, None], mesh_lib.DATA_AXIS)
    new_b, new_bs = optimizer.apply(bias, bias_state, bias_grad)
    bias.copy_(new_b)
    for k in bias_state:
        bias_state[k].copy_(new_bs[k])
    if n_data > 1:
        loss = mesh.all_reduce(loss / n_data, mesh_lib.DATA_AXIS)
    return loss


class SpmdLRTrainer:
    """Sparse LR over a mesh: the dense-apply step with sharded tables."""

    def __init__(self, table_cfg: TableConfig, mesh: mesh_lib.Mesh, *, seed: int = 0):
        require_dense_apply(table_cfg.optimizer)
        self.cfg = table_cfg
        self.mesh = mesh
        self.device = mesh.device
        self.optimizer: ServerOptimizer = make_optimizer(table_cfg.optimizer)
        self.localizer = HashLocalizer(table_cfg.rows, seed=seed)
        n_model = mesh.shape[mesh_lib.MODEL_AXIS]
        #: trash row is id == cfg.rows; extra rows pad to an even shard split.
        self.total_rows = _round_up(table_cfg.rows + 1, n_model)
        self.row_lo, hi = mesh_lib.row_block(mesh, self.total_rows)
        shape, dev = (hi - self.row_lo, 1), self.device
        fills = self.optimizer.state_shapes()
        self.state = ShardedLRState(
            value=torch.zeros(shape, dtype=torch.float32, device=dev),
            state={k: torch.full(shape, fill, dtype=torch.float32, device=dev)
                   for k, fill in fills.items()},
            bias=torch.zeros((1, 1), dtype=torch.float32, device=dev),
            bias_state={k: torch.zeros((1, 1), dtype=torch.float32, device=dev)
                        for k in fills},
        )
        self._batch2 = mesh_lib.batch_sharding(mesh, 2)
        self._batch1 = mesh_lib.batch_sharding(mesh, 1)

    def place_batch(
        self,
        keys: np.ndarray,
        labels: np.ndarray,
        *,
        global_batch: Optional[int] = None,
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Hash keys to slots on the host and put this rank's rows on its
        device.

        ``keys``/``labels`` are THIS host's rows of the global batch (the
        whole batch when one host feeds it).  ``global_batch``: total rows
        across all hosts; defaults to ``local * hosts`` (an even data-axis
        split over hosts); pass it when each host feeds the full batch.
        """
        slots_pos = np.asarray(self.localizer.assign(keys))
        labels = np.asarray(labels)
        gb = global_batch or labels.shape[0] * distributed.process_count()
        return (
            distributed.host_local_batch(self._batch2, slots_pos, (gb, slots_pos.shape[1])),
            distributed.host_local_batch(self._batch1, labels, (gb,)),
        )

    def step(
        self,
        keys: np.ndarray,
        labels: np.ndarray,
        *,
        global_batch: Optional[int] = None,
    ) -> float:
        slots, labels_d = self.place_batch(keys, labels, global_batch=global_batch)
        return float(self.step_placed(slots, labels_d))

    def step_placed(self, slots: torch.Tensor, labels_d: torch.Tensor) -> torch.Tensor:
        """Step on pre-placed rows (no host sync); returns the loss tensor."""
        return sharded_dense_step(self.state, slots, labels_d, self.optimizer,
                                  self.cfg.rows, self.mesh, self.row_lo)

    def full_state(self) -> Dict[str, np.ndarray]:
        """The whole table, gathered over ``model``, as the checkpoint's
        numpy arrays: ``value``, ``bias``, ``state.<k>``, ``bias_state.<k>``.
        A collective: every rank of the mesh calls it."""
        st = self.state
        out = {"value": mesh_lib.gather_over_model(self.mesh, st.value),
               "bias": st.bias.cpu().numpy()}
        out.update({f"state.{k}": mesh_lib.gather_over_model(self.mesh, v)
                    for k, v in st.state.items()})
        out.update({f"bias_state.{k}": v.cpu().numpy() for k, v in st.bias_state.items()})
        return out

    def load_full_state(self, arrays: Dict[str, np.ndarray]) -> None:
        """Install whole-table arrays (``full_state``'s keys): each rank
        copies its own row block."""
        lo, hi = self.row_lo, self.row_lo + self.state.value.shape[0]
        st = self.state

        def put(dst: torch.Tensor, arr: np.ndarray) -> None:
            dst.copy_(torch.from_numpy(np.ascontiguousarray(arr, np.float32)))

        put(st.value, arrays["value"][lo:hi])
        for k, v in st.state.items():
            put(v, arrays[f"state.{k}"][lo:hi])
        put(st.bias, arrays["bias"])
        for k, v in st.bias_state.items():
            put(v, arrays[f"bias_state.{k}"])

