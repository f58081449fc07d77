"""Carry table state across packages.

``trainer_from_numpy`` installs a JAX ``LocalLRTrainer``'s arrays
(``table.value``, ``table.state``, ``bias``, ``bias_state``, as numpy) into
the port's ``LocalLRTrainer``.

``shard_from_numpy`` takes the dict that ``KVServer.export_shard()`` returns
in either package — ``{table: {"value": ndarray, "state": {name: ndarray}}}``
with ``[rows + 1, dim]`` float32 arrays, trash row included — and returns the
same structure as float32 tensors on ``device``, ready for the port's
``KVServer.import_shard`` / ``KVTable.resize``.  The parity tests use it to
start both packages from one numpy state, since JAX's PRNG and torch's
generators cannot be matched bit for bit.
"""

from __future__ import annotations

from typing import Dict

import numpy as np
import torch


def _plane(arr, device: torch.device) -> torch.Tensor:
    if isinstance(arr, torch.Tensor):
        t = arr.to(device=device, dtype=torch.float32, copy=True)
    else:
        # np.array copies: inputs may be read-only views of another buffer
        t = torch.from_numpy(np.array(arr, dtype=np.float32)).to(device)
    if t.dim() != 2:
        raise ValueError(f"table planes are 2-D [rows + 1, dim], got {tuple(t.shape)}")
    return t.contiguous()


def shard_from_numpy(shard: Dict[str, dict], device) -> Dict[str, dict]:
    device = torch.device(device)
    out = {}
    for table, blob in shard.items():
        value = _plane(blob["value"], device)
        state = {k: _plane(v, device) for k, v in blob["state"].items()}
        for k, v in state.items():
            if v.shape != value.shape:
                raise ValueError(
                    f"{table}: state {k!r} shape {tuple(v.shape)} != value "
                    f"{tuple(value.shape)}"
                )
        out[table] = {"value": value, "state": state}
    return out


def trainer_from_numpy(trainer, value, state: Dict[str, object], bias,
                       bias_state: Dict[str, object]) -> None:
    """Install ``[rows + 1, 1]`` table planes and ``[1, 1]`` bias planes into
    the port's ``LocalLRTrainer`` on its device.  The table goes through
    ``KVTable.resize``, which puts the trash row at its fill, where a JAX
    trainer's steps always leave it."""
    dev = trainer.device
    value = _plane(value, dev)
    if tuple(value.shape) != (trainer.cfg.rows + 1, trainer.cfg.dim):
        raise ValueError(
            f"value shape {tuple(value.shape)} != {(trainer.cfg.rows + 1, trainer.cfg.dim)}"
        )
    trainer.table.resize(value, {k: _plane(v, dev) for k, v in state.items()})
    bias = _plane(bias, dev)
    bias_state = {k: _plane(v, dev) for k, v in bias_state.items()}
    if set(bias_state) != set(trainer.bias_state):
        raise ValueError(f"bias state keys {set(bias_state)} != {set(trainer.bias_state)}")
    for t in (bias, *bias_state.values()):
        if tuple(t.shape) != (1, 1):
            raise ValueError(f"bias planes are [1, 1], got {tuple(t.shape)}")
    trainer.bias, trainer.bias_state = bias, bias_state
