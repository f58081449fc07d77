"""Carry table state across packages.

``trainer_from_numpy`` installs a JAX ``LocalLRTrainer``'s arrays
(``table.value``, ``table.state``, ``bias``, ``bias_state``, as numpy) into
the port's ``LocalLRTrainer``.  ``dlrm_from_numpy`` installs a JAX
``SpmdDLRMTrainer``'s table planes and flax MLP params into the port's, and
``resnet_from_numpy`` a flax ResNet's ``params`` and ``batch_stats`` into the
port's ``ResNet``, and ``transformer_from_numpy`` a flax transformer's
``params`` (unrolled ``layer_{i}`` or ``scan_blocks``'s stacked
``blocks.block``) into the port's ``Transformer`` / ``TransformerBody`` /
``TransformerTrunk``, and ``pipelined_from_numpy`` a JAX
``PipelinedLMTrainer``'s stage-stacked tree into the port's pipeline.  The
port's dense models keep flax's parameter names
and layouts (``models/layers.py``, ``models/transformer.py``), so these copy
by path.

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
    trainer's steps always leave it.  An ``SpmdLRTrainer`` (which has a
    ``mesh``) takes ``[total_rows, 1]`` planes, of which each rank copies its
    own row block."""
    if getattr(trainer, "mesh", None) is not None:
        arrays = {"value": np.asarray(value), "bias": np.asarray(bias)}
        arrays.update({f"state.{k}": np.asarray(v) for k, v in state.items()})
        arrays.update({f"bias_state.{k}": np.asarray(v) for k, v in bias_state.items()})
        if arrays["value"].shape != (trainer.total_rows, 1):
            raise ValueError(f"value shape {arrays['value'].shape} != {(trainer.total_rows, 1)}")
        trainer.load_full_state(arrays)
        return
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
    (numpy or tensor leaves) into the port's ``SpmdDLRMTrainer``.  On a mesh
    each rank keeps its own row block of the planes.  The MLP's Adam state
    starts at zero, as a fresh JAX trainer's does."""
    dev = trainer.device
    value = _plane(emb_value, dev)
    if tuple(value.shape) != (trainer.total_rows, trainer.cfg.dim):
        raise ValueError(f"value shape {tuple(value.shape)} != "
                         f"{(trainer.total_rows, trainer.cfg.dim)}")
    block = slice(trainer.row_lo, trainer.row_lo + trainer.emb_value.shape[0])
    value = value[block].contiguous()
    state = {k: _plane(v, dev)[block].contiguous() for k, v in emb_state.items()}
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


def transformer_from_numpy(module, params) -> None:
    """Install a flax transformer's ``params`` tree (nested dicts of numpy
    arrays or tensors) into the port's transformer ``module``, in place.
    The two must hold the same paths (the same model class, the same layout
    of the block stack) and shapes: ``DenseGeneral`` kernels ``[d, H, D]``
    for q / k / v and ``[H, D, d]`` for ``o``, ``Dense`` kernels ``[in,
    out]``, a LayerNorm's leaves under ``LayerNorm_0``.  The JAX package has
    no latent attention and no expert layer: a module with either is
    refused."""
    from parameter_server_tpu_torch.models import transformer as tfm

    tfm.refuse_deepseek(module.cfg, "convert")
    _copy_tree(dict(module.named_parameters()), params, "transformer params")


def placed_from_numpy(trainer, params) -> None:
    """Install a flax transformer's ``params`` tree into a trainer that
    holds its parameters placed on a mesh (``trainer.params``: dotted name
    -> DTensor; ``SpmdLMTrainer`` / ``HybridLMTrainer`` on a mesh,
    ``SpTpLMTrainer``).  Every rank gives the whole tree and keeps its own
    shards; the optimizer's state starts again, as a fresh JAX trainer's."""
    from torch.distributed.tensor import distribute_tensor

    placed = trainer.params
    full = {n: torch.empty(tuple(p.shape)) for n, p in placed.items()}
    _copy_tree(full, params, "placed params")
    with torch.no_grad():
        for n, p in placed.items():
            local = p.to_local()
            p.copy_(distribute_tensor(full[n].to(local.device), p.device_mesh, p.placements))
    trainer.optimizer.state.clear()
    reslice = getattr(trainer, "reslice", None)
    if reslice is not None:
        reslice()


def pipelined_from_numpy(trainer, params) -> None:
    """Install a JAX ``PipelinedLMTrainer``'s parameters — ``{"stages": the
    flax ``Stage`` tree stacked on a leading ``[S]`` axis, "embed": [vocab,
    d], "head": [d, vocab], "norm": the final norm's tree}`` as numpy or
    tensors — into the port's ``PipelinedLMTrainer`` (each rank loads its own
    stage slice; under ``tp`` its shards of it) or ``VirtualPipeline`` (every
    slice).  The names are the flax ones, as in
    :func:`transformer_from_numpy`; AdamW starts again, as a fresh JAX
    trainer's does."""
    from torch.distributed.tensor import distribute_tensor

    stacked = dict(flat_items(params["stages"]))
    stages = getattr(trainer, "stages", None)
    if stages is not None:  # the virtual pipeline: every stage here
        slices = [(st, dict(st.named_parameters()), s) for s, st in enumerate(stages)]
        embed, head, norm, opt = trainer.embed, trainer.head, trainer.norm, trainer.optimizer
    else:
        pp = trainer.pp
        slices = [(None, pp.stage_params, pp.stage_index)]
        embed, head, norm, opt = pp.embed, pp.head, pp.norm, pp.optimizer
    for _module, named, s in slices:
        if any(np.shape(a)[0] <= s for a in stacked.values()):
            raise ValueError(f"the stage tree has fewer than {s + 1} stages")
        tree = {k: np.asarray(v[s]) if not isinstance(v, torch.Tensor) else v[s]
                for k, v in stacked.items()}
        placed = {k: p for k, p in named.items() if hasattr(p, "placements")}
        if placed:
            full = {k: torch.empty(tuple(p.shape)) for k, p in named.items()}
            _copy_tree(full, nest(tree), "pipelined stage")
            with torch.no_grad():
                for k, p in named.items():
                    p.copy_(distribute_tensor(full[k].to(p.to_local().device), p.device_mesh,
                                              p.placements))
        else:
            _copy_tree(named, nest(tree), "pipelined stage")
    _copy_tree({"embed": embed, "head": head}, {"embed": params["embed"],
                                                "head": params["head"]}, "pipelined tail")
    _copy_tree(dict(norm.named_parameters()), params["norm"], "pipelined norm")
    opt.state.clear()


def nest(flat: Dict[str, object]) -> Dict[str, object]:
    """``{dotted path: leaf}`` as the nested dict :func:`_copy_tree` reads."""
    tree: Dict[str, object] = {}
    for path, leaf in flat.items():
        *parts, last = path.split(".")
        node = tree
        for part in parts:
            node = node.setdefault(part, {})
        node[last] = leaf
    return tree
