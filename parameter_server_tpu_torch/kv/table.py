"""KVTable: a parameter table resident in device memory.

Torch counterpart of ``parameter_server_tpu/kv/table.py``.  The table is a
fixed ``[rows + 1, dim]`` float32 tensor on ``device`` (the last row is the
trash row that bucket pads point at) plus one tensor of the same shape per
optimizer state plane.  Where the JAX table donates its buffers to a jitted
step, this one updates its tensors in place: ``push`` runs the fused apply
kernel (or, with ``fused_apply=False``, one gather launch -> plain rule ->
one scatter-set launch) straight into ``value`` and ``state``.  The trash row is
set to its fill when a shard is installed; the fused apply never touches it
and the three-pass path resets it after each push.  ``pull`` gathers the
value and state rows in one launch and derives servable weights.
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

    def _gather(self, ids: torch.Tensor):
        """Value and state rows at ``ids``: one gather launch for all planes."""
        rows = scatter.gather_rows_planes([self.value, *self.state.values()], ids)
        return rows[0], dict(zip(self.state, rows[1:]))

    def _reset_trash_row(self) -> None:
        """Zero value and init state fills in the trash row, so pulls of
        padded positions read exactly zero."""
        self.value[-1].zero_()
        fills = self.optimizer.state_shapes()
        for k, plane in self.state.items():
            plane[-1].fill_(fills[k])

    def _apply_core(self, ids: torch.Tensor, grads: torch.Tensor) -> None:
        """Apply ``grads`` at unique ``ids`` (fused or three-pass), keeping the
        trash row at its fill; shared by every push entry point."""
        if self.fused_apply:  # leaves the trash row alone
            scatter.apply_rows(self.value, self.state, ids, grads, self.optimizer)
            return
        v_rows, s_rows = self._gather(ids)
        new_v, new_s = self.optimizer.apply(v_rows, s_rows, grads)
        # one write-back launch for the value and every state plane
        scatter.scatter_update_rows_planes(
            [self.value, *self.state.values()], ids,
            [new_v.contiguous(), *(new_s[k].contiguous() for k in self.state)],
        )
        # pads write the rule's output for the trash row there
        self._reset_trash_row()

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
        return self.optimizer.pull_weights(*self._gather(ids))

    # -- direct row access (checkpoint, tests, model eval) ------------------
    def weights(self) -> torch.Tensor:
        """Full servable weight table (excluding the trash row)."""
        return self.optimizer.pull_weights(self.value, self.state)[: self.rows]

    def set_value(self, value) -> None:
        if tuple(value.shape) != (self.rows + 1, self.dim):
            raise ValueError(f"expected {(self.rows + 1, self.dim)}, got {value.shape}")
        self.value = _to_device(value, self.device)
        self.value[-1].zero_()

    def install_rows(self, value, state: Dict[str, np.ndarray]) -> None:
        """Replace the shard with ``[rows, dim]`` host arrays (NO trash row),
        possibly of another row count (a restore onto another fleet shape).

        New planes are allocated on the device and each host array is copied
        into its first ``rows`` rows once; the trash row gets its fill.  The
        old planes are dropped first, so a restore needs no room for two
        shards."""
        if set(state) != set(self.state):
            raise ValueError(
                f"optimizer state keys mismatch: {set(state)} != {set(self.state)}"
            )
        n = int(value.shape[0])
        if value.ndim != 2 or value.shape[1] != self.dim:
            raise ValueError(f"bad install_rows value shape {tuple(value.shape)}")
        self.value, self.state = None, {k: None for k in self.state}
        planes = {}
        for k, rows in [("", value), *((k, state[k]) for k in sorted(state))]:
            plane = torch.empty((n + 1, self.dim), dtype=torch.float32, device=self.device)
            if n:
                plane[:n].copy_(_host_tensor(rows))
            planes[k] = plane
        self.adopt_planes(planes.pop(""), planes)
        self._reset_trash_row()

    def adopt_planes(self, value: torch.Tensor, state: Dict[str, torch.Tensor]) -> None:
        """Take ``[new_rows + 1, dim]`` float32 planes on this table's device
        as the shard, without a copy, trash row as given (a migration rebuilds
        the planes on the card and carries the old trash row over)."""
        if set(state) != set(self.state):
            raise ValueError(
                f"optimizer state keys mismatch: {set(state)} != {set(self.state)}"
            )
        for plane in (value, *state.values()):
            if (plane.dim() != 2 or plane.shape != value.shape or plane.shape[1] != self.dim
                    or plane.shape[0] < 1 or plane.dtype != torch.float32
                    or not _on(plane, self.device) or not plane.is_contiguous()):
                raise ValueError(
                    f"adopt_planes: need contiguous float32 [rows + 1, {self.dim}] planes "
                    f"on {self.device}, got {tuple(plane.shape)} {plane.dtype} on {plane.device}"
                )
        self.rows = int(value.shape[0]) - 1
        self.value = value
        self.state = {k: state[k] for k in self.state}

    def resize(self, value, state) -> None:
        """Replace the shard wholesale, possibly with a different row count;
        ``value``/``state`` are ``[new_rows + 1, dim]`` INCLUDING the trash row,
        which is set to its fill here (the fused push never rewrites it)."""
        if value.ndim != 2 or value.shape[1] != self.dim or value.shape[0] < 1:
            raise ValueError(f"bad resize value shape {tuple(value.shape)}")
        if set(state) != set(self.state):
            raise ValueError(
                f"optimizer state keys mismatch: {set(state)} != {set(self.state)}"
            )
        self.rows = int(value.shape[0]) - 1
        self.value = _to_device(value, self.device)
        self.state = {k: _to_device(v, self.device) for k, v in state.items()}
        self._reset_trash_row()


def _on(t: torch.Tensor, device: torch.device) -> bool:
    """``t`` lies on ``device`` (``cuda`` matches ``cuda:<current>``)."""
    if t.device.type != device.type:
        return False
    if device.type != "cuda":
        return True
    index = torch.cuda.current_device() if device.index is None else device.index
    return t.device.index == index


def _host_tensor(arr) -> torch.Tensor:
    """A float32 host array (or tensor) as a tensor to copy from: numpy is
    wrapped without a copy where it is writable float32 and C-contiguous."""
    if isinstance(arr, torch.Tensor):
        return arr.to(torch.float32)
    return torch.from_numpy(np.require(arr, np.float32, ["C", "W"]))


def _to_device(arr, device: torch.device) -> torch.Tensor:
    """A contiguous float32 copy of a numpy array or tensor on ``device``."""
    if isinstance(arr, torch.Tensor):
        return arr.to(device=device, dtype=torch.float32, copy=True).contiguous()
    return torch.tensor(np.asarray(arr, dtype=np.float32), device=device)
