"""KVTable: a parameter table resident in device memory.

Torch counterpart of ``parameter_server_tpu/kv/table.py``.  The table is a
fixed ``[rows + 1, dim]`` float32 tensor on ``device`` (the last row is the
trash row that bucket pads point at) plus one tensor of the same shape per
optimizer state plane.  Where the JAX table donates its buffers to a jitted
step, this one updates its tensors in place: ``push`` runs the fused apply
kernel (or, with ``fused_apply=False``, gather kernels -> plain rule ->
scatter-set kernels) straight into ``value`` and ``state``, then re-zeros the
trash row in place.  ``pull`` gathers rows and derives servable weights.
"""

from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from parameter_server_tpu_torch.config import TableConfig
from parameter_server_tpu_torch.kv.optim import ServerOptimizer, make_optimizer
from parameter_server_tpu_torch.ops import scatter


class KVTable:
    """One table (or one row-range shard of a table) on ``device``."""

    def __init__(
        self,
        cfg: TableConfig,
        *,
        rows: Optional[int] = None,
        seed: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        if cfg.scatter_impl != "auto":
            raise ValueError(f"scatter_impl must be 'auto', got {cfg.scatter_impl!r}")
        if cfg.dtype != "float32":
            raise ValueError(f"tables are float32, got {cfg.dtype!r}")
        self.cfg = cfg
        self.device = torch.device(device)
        #: actual row count of this shard; one trash row is appended
        self.rows = cfg.rows if rows is None else rows
        self.dim = cfg.dim
        shape = (self.rows + 1, self.dim)
        if cfg.init_scale > 0.0:
            gen = torch.Generator().manual_seed(seed)
            value = torch.randn(shape, generator=gen, dtype=torch.float32)
            value = (value * cfg.init_scale).to(self.device)
            value[self.rows].zero_()
        else:
            value = torch.zeros(shape, dtype=torch.float32, device=self.device)
        self.value: torch.Tensor = value
        self.optimizer: ServerOptimizer = make_optimizer(cfg.optimizer)
        self.state: Dict[str, torch.Tensor] = {
            name: torch.full(shape, fill, dtype=torch.float32, device=self.device)
            for name, fill in self.optimizer.state_shapes().items()
        }
        self.fused_apply = cfg.fused_apply

    def _apply_core(self, ids: torch.Tensor, grads: torch.Tensor) -> None:
        """Apply ``grads`` at unique ``ids`` (fused or three-pass), then reset
        the trash row; shared by every push entry point."""
        if self.fused_apply:
            scatter.apply_rows(self.value, self.state, ids, grads, self.optimizer)
        else:
            v_rows = scatter.gather_rows(self.value, ids)
            s_rows = {k: scatter.gather_rows(v, ids) for k, v in self.state.items()}
            new_v, new_s = self.optimizer.apply(v_rows, s_rows, grads)
            scatter.scatter_update_rows(self.value, ids, new_v.contiguous())
            for k in self.state:
                scatter.scatter_update_rows(self.state[k], ids, new_s[k].contiguous())
        # pads route (zero) gradients to the trash row and may race there;
        # resetting keeps pulls of padded positions exactly zero
        self.value[-1].zero_()
        fills = self.optimizer.state_shapes()
        for k, plane in self.state.items():
            plane[-1].fill_(fills[k])

    # -- public ops ---------------------------------------------------------
    def push(self, ids: torch.Tensor, combined_grads: torch.Tensor) -> torch.Tensor:
        """Apply pre-combined gradient rows at unique ``ids`` (in place).

        Pads point at the trash row and must carry zero gradients.  Returns
        ``value`` (the tensor every later push keeps updating).
        """
        self._apply_core(ids, combined_grads)
        return self.value

    def push_batch(
        self, ids: torch.Tensor, positions: torch.Tensor, vals: torch.Tensor
    ) -> torch.Tensor:
        """One bundled apply round: unique ``ids`` take their gradient rows
        from the stacked member values ``vals`` ``(k, bm, dim)`` by
        ``positions``; pad positions index an appended zero row."""
        flat = vals.reshape(-1, vals.shape[-1])
        flat = torch.cat([flat, flat.new_zeros((1, flat.shape[1]))])
        self._apply_core(ids, flat[positions.long()])
        return self.value

    def push_combined(
        self, ids: torch.Tensor, inverse: torch.Tensor, vals: torch.Tensor
    ) -> torch.Tensor:
        """Bundled apply with device pre-combine: every stacked value row is
        segment-summed into its unique-id slot (``inverse``), then applied
        once — the ``dup_policy="combine"`` mode."""
        flat = vals.reshape(-1, vals.shape[-1])
        combined = scatter.segment_combine(flat, inverse, int(ids.shape[0]))
        self._apply_core(ids, combined)
        return self.value

    def combine(
        self, inverse: torch.Tensor, values: torch.Tensor, num_rows: int
    ) -> torch.Tensor:
        """Worker-side duplicate pre-combine (deterministic segment sum)."""
        return scatter.segment_combine(values, inverse, num_rows)

    def pull(self, ids: torch.Tensor) -> torch.Tensor:
        """Servable weight rows for unique ``ids``."""
        v_rows = scatter.gather_rows(self.value, ids)
        s_rows = {k: scatter.gather_rows(v, ids) for k, v in self.state.items()}
        return self.optimizer.pull_weights(v_rows, s_rows)

    # -- direct row access (checkpoint, tests, model eval) ------------------
    def weights(self) -> torch.Tensor:
        """Full servable weight table (excluding the trash row)."""
        return self.optimizer.pull_weights(self.value, self.state)[: self.rows]

    def set_value(self, value) -> None:
        if tuple(value.shape) != (self.rows + 1, self.dim):
            raise ValueError(f"expected {(self.rows + 1, self.dim)}, got {value.shape}")
        self.value = _to_device(value, self.device)

    def install_rows(self, value: np.ndarray, state: Dict[str, np.ndarray]) -> None:
        """Replace the shard with ``[rows, dim]`` host arrays (NO trash row):
        a fresh trash row (zero value, init state fills) is appended and the
        shard installed via :meth:`resize`."""
        if set(state) != set(self.state):
            raise ValueError(
                f"optimizer state keys mismatch: {set(state)} != {set(self.state)}"
            )
        n = int(value.shape[0])
        buf = np.zeros((n + 1, self.dim), np.float32)
        buf[:n] = value
        sbuf = {}
        for k, fill in self.optimizer.state_shapes().items():
            sk = np.full((n + 1, self.dim), fill, np.float32)
            sk[:n] = state[k]
            sbuf[k] = sk
        self.resize(buf, sbuf)

    def resize(self, value, state) -> None:
        """Replace the shard wholesale, possibly with a different row count;
        ``value``/``state`` are ``[new_rows + 1, dim]`` INCLUDING the trash row."""
        if value.ndim != 2 or value.shape[1] != self.dim or value.shape[0] < 1:
            raise ValueError(f"bad resize value shape {tuple(value.shape)}")
        if set(state) != set(self.state):
            raise ValueError(
                f"optimizer state keys mismatch: {set(state)} != {set(self.state)}"
            )
        self.rows = int(value.shape[0]) - 1
        self.value = _to_device(value, self.device)
        self.state = {k: _to_device(v, self.device) for k, v in state.items()}


def _to_device(arr, device: torch.device) -> torch.Tensor:
    """A contiguous float32 copy of a numpy array or tensor on ``device``."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device, dtype=torch.float32, copy=True).contiguous()
    return torch.tensor(np.asarray(arr, dtype=np.float32), device=device)
