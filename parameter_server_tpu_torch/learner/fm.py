"""FM learner: the single-device fused trainer for the factorization machine.

Torch counterpart of ``parameter_server_tpu/learner/fm.py``.  Reference
analogue: the factorization-machine app over the SGD scaffold
(``src/app/factorization_machine/`` + ``src/learner/sgd.h`` [U]).  The Van
path needs no dedicated class — ``KVWorker.pull/push`` with
``models.fm.fm_grad_rows`` is the loop; this module provides the fused local
path mirroring :class:`~parameter_server_tpu_torch.learner.sgd.LocalLRTrainer`:
the table lives on ``device`` and each step is one
:func:`~parameter_server_tpu_torch.models.fm.fused_train_step` (one
``ps_gather`` and one ``ps_apply`` launch on the card).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch

from parameter_server_tpu_torch.config import TableConfig
from parameter_server_tpu_torch.data.prefetch import host_tensor
from parameter_server_tpu_torch.kv.table import KVTable
from parameter_server_tpu_torch.models import fm
from parameter_server_tpu_torch.utils import metrics as metrics_lib
from parameter_server_tpu_torch.utils.keys import HashLocalizer, localize_to_slots


class LocalFMTrainer:
    """Single-device FM: fused pull + grad + apply per step.

    ``table_cfg.dim`` must be ``1 + k`` (linear weight + k factors); use
    ``init_scale > 0`` so factor vectors break symmetry (column 0's linear
    weight tolerates random init like the reference's FM).
    """

    def __init__(
        self,
        table_cfg: TableConfig,
        *,
        min_bucket: int = 1024,
        dashboard: Optional[metrics_lib.Dashboard] = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        if table_cfg.dim < 2:
            raise ValueError("FM table dim must be 1 + k (k >= 1 factors)")
        self.cfg = table_cfg
        self.device = torch.device(device)
        self.table = KVTable(table_cfg, seed=seed, device=self.device)
        self.optimizer = self.table.optimizer
        self.localizer = HashLocalizer(table_cfg.rows)
        self.min_bucket = min_bucket
        self.bias = torch.zeros((1, 1), dtype=torch.float32, device=self.device)
        self.bias_state = {
            k: torch.zeros((1, 1), dtype=torch.float32, device=self.device)
            for k in self.optimizer.state_shapes()
        }
        self.dashboard = dashboard or metrics_lib.Dashboard(print_every=0)
        self.step_count = 0

    def _to_device(self, arr: np.ndarray) -> torch.Tensor:
        return host_tensor(arr).to(self.device)

    def step(self, keys: np.ndarray, labels: np.ndarray) -> float:
        """One fused step; the loss read back is its only host sync."""
        t = self.table
        slots, inverse, _n = localize_to_slots(
            keys, self.localizer, min_bucket=self.min_bucket
        )
        loss = fm.fused_train_step(
            t.value, t.state, self.bias, self.bias_state,
            self._to_device(slots), self._to_device(inverse),
            self._to_device(np.asarray(labels, np.float32)),
            self.optimizer, int(slots.shape[0]),
        )
        self.step_count += 1
        return float(loss)

    def train(self, batch_fn, num_steps: int) -> None:
        for _ in range(num_steps):
            keys, labels = batch_fn()
            loss = self.step(keys, labels)
            self.dashboard.record(self.step_count, loss, examples=labels.shape[0])

    def eval_auc(self, batch_fn, num_batches: int) -> float:
        weights = self.table.weights().cpu().numpy()
        bias = float(self.optimizer.pull_weights(self.bias, self.bias_state)[0, 0])
        scores, labels_all = [], []
        for _ in range(num_batches):
            keys, labels = batch_fn()
            slots_pos = self.localizer.assign(keys)
            # PAD slots (== capacity) cannot appear with fixed-nnz batches;
            # guard anyway by clipping into the real row range
            slots_pos = np.minimum(slots_pos, self.cfg.rows - 1)
            scores.append(fm.eval_logits_np(weights, bias, slots_pos))
            labels_all.append(labels)
        return metrics_lib.auc(np.concatenate(labels_all), np.concatenate(scores))
