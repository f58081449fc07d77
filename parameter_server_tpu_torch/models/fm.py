"""Factorization machine over the KV layer.

Torch counterpart of ``parameter_server_tpu/models/fm.py``.  Reference
analogue: ``src/app/factorization_machine/`` — the FM model served from KV
tables [U].  One table holds, per feature row, the linear weight AND the
factor vector: ``dim = 1 + k`` (column 0 = w_i, columns 1..k = v_i), so a
single Push/Pull moves the whole per-feature parameter block and one gather
launch reads it.

With one-hot categorical inputs (x_i = 1 at the example's keys) the
second-order FM term reduces to

    1/2 * sum_f [ (sum_i v_if)^2 - sum_i v_if^2 ]

and the per-position gradients are dl/dw_i = r and
dl/dv_if = r * (S_f - v_if) with S_f = sum_j v_jf, r = dloss/dlogit.

- :func:`fm_grad_rows`: the PS loop's worker compute (pull rows -> grads).
- :func:`fused_train_step`: one step on a device-resident table, in place,
  the structure of ``models/linear.py::fused_train_step``: one
  ``ps_gather`` launch for the value and state rows, the FM loss and
  per-position gradient, the deterministic duplicate pre-combine, one
  ``ps_apply`` launch.
"""

from __future__ import annotations

from typing import Dict, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch.kv.optim import ServerOptimizer
from parameter_server_tpu_torch.models.linear import _apply_bias, logloss
from parameter_server_tpu_torch.ops import scatter

Planes = Dict[str, torch.Tensor]


def fm_logits(rows_pos: torch.Tensor, bias) -> torch.Tensor:
    """Per-example logits from per-position parameter rows ``[B, nnz, 1+k]``."""
    w_pos = rows_pos[..., 0]  # [B, nnz]
    v_pos = rows_pos[..., 1:]  # [B, nnz, k]
    s = torch.sum(v_pos, dim=1)  # [B, k]
    pair = 0.5 * torch.sum(s * s - torch.sum(v_pos * v_pos, dim=1), dim=-1)
    return torch.sum(w_pos, dim=-1) + pair + bias


def _grad_pos(rows_pos: torch.Tensor, r: torch.Tensor) -> torch.Tensor:
    """Per-position gradient rows ``[B, nnz, 1+k]`` for residuals ``r [B]``."""
    v_pos = rows_pos[..., 1:]
    s = torch.sum(v_pos, dim=1, keepdim=True)  # [B, 1, k]
    g_w = r[:, None, None].expand(*rows_pos.shape[:2], 1)  # [B, nnz, 1]
    g_v = r[:, None, None] * (s - v_pos)  # [B, nnz, k]
    return torch.cat([g_w, g_v], dim=-1)


def fm_grad_rows(
    rows_pos: torch.Tensor, labels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Van-path worker compute: per-position gradient rows ``[B, nnz, 1+k]``.

    Returns ``(g_pos, bias_grad, loss)``; gradients are mean-loss scaled so
    the server applies them unmodified (matches ``linear.grad_rows`` usage).
    """
    logits = fm_logits(rows_pos, 0.0)
    loss = logloss(logits, labels)
    r = (torch.sigmoid(logits) - labels) / labels.shape[0]  # [B]
    return _grad_pos(rows_pos, r), torch.sum(r), loss


def fused_train_step(
    value: torch.Tensor,
    state: Planes,
    bias: torch.Tensor,
    bias_state: Planes,
    ids: torch.Tensor,
    inverse: torch.Tensor,
    labels: torch.Tensor,
    optimizer: ServerOptimizer,
    num_rows: int,
) -> torch.Tensor:
    """One FM step on the device-resident ``[rows+1, 1+k]`` table, in place.

    ``ids``: unique int32 row slots ``[num_rows]`` (bucket-padded, pads at
    the trash row); ``inverse``: position -> slot-row map ``[B * nnz]``;
    ``labels``: ``[B]``.  The apply kernel leaves the trash row alone, so it
    stays at zero and its state at the fills.  Returns the loss as a tensor
    on the table's device (no host sync).
    """
    batch, dim = labels.shape[0], value.shape[1]
    names = list(state)
    rows = scatter.gather_rows_planes([value, *(state[k] for k in names)], ids)
    w_rows = optimizer.pull_weights(rows[0], dict(zip(names, rows[1:])))  # [num_rows, 1+k]
    inv = inverse.reshape(-1).long()
    rows_pos = w_rows[inv].reshape(batch, -1, dim)
    bias_w = optimizer.pull_weights(bias, bias_state)
    logits = fm_logits(rows_pos, bias_w[0, 0])
    loss = logloss(logits, labels)
    r = (torch.sigmoid(logits) - labels) / batch
    g_pos = _grad_pos(rows_pos, r).reshape(-1, dim)
    combined = scatter.segment_combine(g_pos, inv, num_rows).contiguous()
    scatter.apply_rows(value, state, ids, combined, optimizer)
    _apply_bias(bias, bias_state, r, optimizer)
    return loss


def eval_logits_np(table_rows, bias, slots_pos):
    """Offline scoring from a host-side weight table (model evaluation path).

    ``table_rows``: full ``[rows, 1+k]`` numpy array (e.g. from
    ``checkpoint.load_global_weights``); ``slots_pos``: ``[B, nnz]`` row ids.
    """
    rows_pos = table_rows[slots_pos]  # [B, nnz, 1+k]
    w_pos = rows_pos[..., 0]
    v_pos = rows_pos[..., 1:]
    s = np.sum(v_pos, axis=1)
    pair = 0.5 * np.sum(s * s - np.sum(v_pos * v_pos, axis=1), axis=-1)
    return np.sum(w_pos, axis=-1) + pair + bias
