"""Carry table state across packages.

``trainer_from_numpy`` installs a JAX ``LocalLRTrainer``'s arrays
(``table.value``, ``table.state``, ``bias``, ``bias_state``, as numpy) into
the port's ``LocalLRTrainer``.  ``dlrm_from_numpy`` installs a JAX
``SpmdDLRMTrainer``'s table planes and flax MLP params into the port's, and
``resnet_from_numpy`` a flax ResNet's ``params`` and ``batch_stats`` into the
port's ``ResNet``.  The port's dense models keep flax's parameter names and
layouts (``models/layers.py``), so those two copy by path.

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

from parameter_server_tpu_torch.models.layers import flat_items


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


def _copy_tree(named: Dict[str, torch.Tensor], tree, what: str) -> None:
    """Copy every leaf of a nested dict (numpy arrays or tensors) into the
    tensor of the same dotted path; the two must hold the same paths and
    shapes."""
    leaves = dict(flat_items(tree))
    if set(leaves) != set(named):
        raise ValueError(f"{what}: paths differ: only in the tree "
                         f"{sorted(set(leaves) - set(named))}, only in the model "
                         f"{sorted(set(named) - set(leaves))}")
    with torch.no_grad():
        for path, arr in leaves.items():
            t = named[path]
            src = (arr.detach() if isinstance(arr, torch.Tensor)
                   else torch.from_numpy(np.array(arr, dtype=np.float32)))
            if tuple(src.shape) != tuple(t.shape):
                raise ValueError(f"{what}: {path} shape {tuple(src.shape)} != {tuple(t.shape)}")
            t.copy_(src)


def dlrm_from_numpy(trainer, emb_value, emb_state: Dict[str, object], mlp_params) -> None:
    """Install ``[total_rows, dim]`` table planes and a flax DLRM params tree
    (numpy or tensor leaves) into the port's ``SpmdDLRMTrainer``.  The MLP's Adam state
    starts at zero, as a fresh JAX trainer's does."""
    dev = trainer.device
    value = _plane(emb_value, dev)
    if tuple(value.shape) != (trainer.total_rows, trainer.cfg.dim):
        raise ValueError(f"value shape {tuple(value.shape)} != "
                         f"{(trainer.total_rows, trainer.cfg.dim)}")
    state = {k: _plane(v, dev) for k, v in emb_state.items()}
    if set(state) != set(trainer.emb_state) or any(v.shape != value.shape
                                                    for v in state.values()):
        raise ValueError(f"state planes {sorted(state)} do not match {sorted(trainer.emb_state)}")
    trainer.emb_value, trainer.emb_state = value, state
    _copy_tree(dict(trainer.model.named_parameters()), mlp_params, "dlrm params")
    trainer.tx.state.clear()


def resnet_from_numpy(model, params, batch_stats) -> None:
    """Install a flax ResNet's ``params`` and ``batch_stats`` trees (numpy
    leaves) into the port's ``ResNet``, in place."""
    _copy_tree(dict(model.named_parameters()), params, "resnet params")
    _copy_tree(dict(model.named_buffers()), batch_stats, "resnet batch_stats")
