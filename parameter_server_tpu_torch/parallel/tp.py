"""Tensor-parallel sharding rules for the transformer family.

Torch counterpart of ``parameter_server_tpu/parallel/tp.py``.  The rules are
the JAX module's, path for path; a parameter's path is its dotted name in
``named_parameters()`` (the port keeps flax's names, ``convert.py``), split
at the dots.  A sharding is a ``parallel.mesh.Sharding`` (the JAX
``PartitionSpec`` as a tuple) whose DTensor placements :func:`place_params`
gives the parameter.

Rules (matching ``models/transformer.py`` param naming):
- token embedding rows sharded over ``model`` — the PS table partition;
- attention q/k/v sharded over heads; output projection over heads;
- MLP up/gate sharded over d_ff, down over d_ff (Megatron-style pairing);
- norms, biases of row-parallel layers, and positional embeddings replicated;
- ``fsdp``: every parameter's first still-replicated, evenly divisible
  dimension is split over ``fsdp_axis`` too.

The trainers compute with each parameter materialised in full
(``learner/lm.py``): the placements decide where parameters, gradients and
AdamW's moments live, not how the block's matmuls are split.  Computing the
model axis as Megatron column / row splits is a speed question left for
later.
"""

from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from parameter_server_tpu_torch.parallel.mesh import DATA_AXIS, MODEL_AXIS, Sharding

Spec = Tuple[Any, ...]


def _spec_for(path: Tuple[str, ...], value: Any) -> Spec:
    names = [p for p in path]
    leaf = names[-1]
    parent = names[-2] if len(names) >= 2 else ""
    ndim = getattr(value, "ndim", 0)

    if leaf == "embedding":
        return (MODEL_AXIS, None)  # vocab-row sharded (PS table scheme)
    if leaf == "pos_embedding":
        return ()
    if parent in ("q", "k", "v"):
        if leaf == "kernel":  # [d_model, heads, head_dim]
            return (None, MODEL_AXIS, None)
        return (MODEL_AXIS, None)  # bias [heads, head_dim]
    if parent == "o":
        if leaf == "kernel":  # [heads, head_dim, d_model]
            return (MODEL_AXIS, None, None)
        return ()  # row-parallel bias replicated
    if parent in ("gate", "up"):
        if leaf == "kernel":  # [d_model, d_ff]
            return (None, MODEL_AXIS)
        return (MODEL_AXIS,)
    if parent == "down":
        if leaf == "kernel":  # [d_ff, d_model]
            return (MODEL_AXIS, None)
        return ()
    if parent == "lm_head":
        return (None, MODEL_AXIS) if ndim == 2 else (MODEL_AXIS,)
    return ()  # norms and everything else replicated


def _add_fsdp_axis(spec: Spec, shape, data_n: int, axis: str) -> Spec:
    """Extend a TP spec with ``data``-axis sharding on the first free dim
    (parameters, and so AdamW's moments, split over the data axis instead of
    replicated per data replica)."""
    parts = list(spec) + [None] * (len(shape) - len(spec))
    for i, (p, s) in enumerate(zip(parts, shape)):
        if p is None and s % data_n == 0 and s >= data_n:
            parts[i] = axis
            break
    return tuple(parts)


class _TailView:
    """Shape/ndim proxy dropping the leading (layer-stack) axis."""

    def __init__(self, value):
        self.shape = tuple(value.shape[1:])
        self.ndim = len(self.shape)


def _named(params) -> Dict[str, torch.Tensor]:
    if isinstance(params, torch.nn.Module):
        return dict(params.named_parameters())
    return dict(params)


def transformer_param_shardings(
    params, mesh, *, fsdp: bool = False, fsdp_axis: str = DATA_AXIS
) -> Dict[str, Sharding]:
    """Map a transformer's parameters (a module, or ``{dotted name: tensor}``)
    to shardings per the TP rules, keyed by dotted name.  Reads only
    ``mesh.shape`` and ``mesh.axis_names``."""
    data_n = int(mesh.shape.get(fsdp_axis, 1)) if fsdp else 1
    out = {}
    for name, value in _named(params).items():
        names = tuple(name.split("."))
        if names[0] == "blocks":
            # scan_blocks layout: every block param carries a leading
            # n_layers axis; the per-layer rules apply to the tail dims.
            spec = (None, *_spec_for(names, _TailView(value)))
        else:
            spec = _spec_for(names, value)
        if data_n > 1:
            spec = _add_fsdp_axis(spec, value.shape, data_n, fsdp_axis)
        out[name] = Sharding(mesh, spec)
    return out


def place_params(params, mesh, shardings=None) -> Dict[str, torch.nn.Parameter]:
    """Each parameter (identical on every rank) as a DTensor parameter placed
    per ``shardings`` (default: the TP rules), keyed by dotted name."""
    from torch.distributed.tensor import distribute_tensor

    named = _named(params)
    shardings = shardings or transformer_param_shardings(named, mesh)
    return {
        name: torch.nn.Parameter(distribute_tensor(
            t.detach().to(mesh.device), mesh.device_mesh, shardings[name].placements))
        for name, t in named.items()
    }


def materialize(params: Dict[str, torch.Tensor], mesh,
                partial_over: Tuple[str, ...] = (DATA_AXIS,)) -> Dict[str, torch.Tensor]:
    """Every DTensor parameter in full, as a plain tensor of this rank
    (``redistribute`` to ``Replicate``: an all-gather of the shards).

    Differentiable: a materialised tensor's gradient is taken as a partial
    sum over the ``partial_over`` axes (each rank's share of the batch there)
    and as identical over the others, so it arrives on the parameter summed
    and placed — all-reduced where the parameter is replicated,
    reduce-scattered onto its shard where it is split.
    """
    from torch.distributed.tensor import Partial, Replicate

    full = [Replicate()] * len(mesh.axis_names)
    grads = [Partial() if a in partial_over else Replicate() for a in mesh.axis_names]
    return {name: p.redistribute(mesh.device_mesh, full).to_local(grad_placements=grads)
            for name, p in params.items()}
