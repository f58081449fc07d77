"""Tensor-parallel sharding rules for the transformer family, and the
Megatron split they compute as.

Torch counterpart of ``parameter_server_tpu/parallel/tp.py``.  The rules are
the JAX module's, path for path; a parameter's path is its dotted name in
``named_parameters()`` (the port keeps flax's names, ``convert.py``), split
at the dots.  A sharding is a ``parallel.mesh.Sharding`` (the JAX
``PartitionSpec`` as a tuple) whose DTensor placements :func:`place_params`
gives the parameter.

Rules (matching ``models/transformer.py`` param naming):
- token embedding rows sharded over ``model`` — the PS table partition;
- attention q/k/v sharded over heads; output projection over heads;
- MLP up/gate sharded over d_ff, down over d_ff (Megatron-style pairing:
  column- then row-parallel, one allreduce per block);
- norms, biases of row-parallel layers, and positional embeddings replicated;
- ``fsdp``: every parameter's first still-replicated, evenly divisible
  dimension is split over ``fsdp_axis`` too.

The ``model`` axis computes as those splits, where GSPMD puts the JAX
package's collectives: :func:`materialize` gathers a parameter over the
other axes only and hands each rank its ``model`` shard, and the block
functions (``models/transformer.py``) run on the rank's heads and its
slice of ``d_ff`` and of the vocabulary.  Two conjugate operators carry
the split: :func:`copy_to_model` (identity forward, gradient all-reduced
over ``model``) in front of every column-parallel product, and
:func:`reduce_from_model` (all-reduce forward, identity backward) after
every row-parallel one.  The embedding is vocab-parallel
(:func:`vocab_parallel_embed`) and so is the loss
(:func:`vocab_parallel_nll`): no rank holds the full ``[B, S, V]`` logits.
Where the KV heads do not split into whole groups a rank (fewer KV heads
than ``model`` ranks), ``k`` and ``v`` are gathered over ``model`` (they
are small) and each rank takes the heads its queries use; their gradients
reduce-scatter back onto the owning shards.  On a ``model`` axis of one
every operator is the identity and no collective runs.
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
    """Every DTensor parameter as this rank's plain tensor to compute with:
    gathered over every axis but ``model`` (``data`` under fsdp, ``sp`` for
    the moments' slices), and on ``model`` the rank's own shard — never the
    whole of a ``model``-split parameter, except ``k`` / ``v`` where the KV
    heads do not split into whole groups a rank (:func:`kv_full`).

    Differentiable: a tensor's gradient is taken as a partial sum over the
    ``partial_over`` axes (each rank's share of the batch there), as the
    rank's shard on ``model`` and as identical over the rest, so it arrives
    on the parameter summed and placed — all-reduced where the parameter is
    replicated, reduce-scattered where it is split over a ``partial_over``
    axis.  A gathered ``k`` / ``v`` takes its gradient as partial over
    ``model`` too (each rank's queries' share), reduce-scattered back onto
    the owning shards.
    """
    from torch.distributed.tensor import Partial, Replicate

    axes = mesh.axis_names
    m = int(mesh.shape.get(MODEL_AXIS, 1))
    heads = _head_counts(params, m)
    out = {}
    for name, p in params.items():
        full = name in heads and kv_full(*heads[name], m)
        keep = [pl if a == MODEL_AXIS and not full else Replicate()
                for a, pl in zip(axes, p.placements)]
        grads = [Partial() if a in partial_over or (a == MODEL_AXIS and full) else
                 (pl if a == MODEL_AXIS else Replicate())
                 for a, pl in zip(axes, p.placements)]
        out[name] = p.redistribute(mesh.device_mesh, keep).to_local(grad_placements=grads)
    return out


def place_grad(param: torch.Tensor, grad: torch.Tensor, mesh) -> torch.Tensor:
    """The gradient of :func:`materialize`'s tensor for ``param`` (taken as
    identical over the non-``model`` axes), as a DTensor on ``param``'s
    placements: the rank's shard as it is, or, for a ``k`` / ``v`` that
    came whole, each rank's share reduce-scattered onto the shards."""
    from torch.distributed.tensor import DTensor, Partial, Replicate

    if tuple(grad.shape) == tuple(param.to_local().shape):
        return DTensor.from_local(grad, mesh.device_mesh, param.placements,
                                  shape=param.shape, stride=param.stride())
    partial = [Partial() if a == MODEL_AXIS else Replicate() for a in mesh.axis_names]
    return DTensor.from_local(grad, mesh.device_mesh, partial).redistribute(
        mesh.device_mesh, param.placements)


def _head_counts(params: Dict[str, torch.Tensor], m: int) -> Dict[str, Tuple[int, int]]:
    """``{k / v parameter name: (query heads, KV heads)}``, read from the
    global shapes of each one and of its sibling ``q`` kernel."""
    out = {}
    if m == 1:
        return out
    for name, p in params.items():
        path = name.split(".")
        if len(path) < 2 or path[-2] not in ("k", "v"):
            continue
        *path, _parent, leaf = path
        q = params[".".join(path + ["q", "kernel"])]
        lead = 1 if path and path[0] == "blocks" else 0  # the layer-stack axis
        axis = lead + (1 if leaf == "kernel" else 0)  # [d, H, D] / [H, D]
        out[name] = (int(q.shape[lead + 1]), int(p.shape[axis]))
    return out


# -- the Megatron split over ``model`` --------------------------------------------


def model_split(mesh) -> int:
    """The size of ``mesh``'s ``model`` axis (1 without a mesh or an axis)."""
    if mesh is None:
        return 1
    return int(mesh.shape.get(MODEL_AXIS, 1))


def split_config(cfg, mesh):
    """``cfg`` with ``mesh`` as its ``spmd_mesh`` where ``mesh`` splits
    ``model`` (the config whose blocks compute the split), else ``cfg``
    itself."""
    if model_split(mesh) == 1:
        return cfg
    import dataclasses

    return dataclasses.replace(cfg, spmd_mesh=mesh)


def kv_full(n_heads: int, kv_heads: int, m: int) -> bool:
    """Whether ``k`` / ``v`` are computed whole on every rank of a ``model``
    axis of ``m``: unless both head counts split evenly, a rank's query
    heads may use KV heads another rank holds."""
    return m > 1 and not (n_heads % m == 0 and kv_heads % m == 0)


def shard_range(mesh, size: int) -> Tuple[int, int]:
    """``[lo, hi)``: the indices of a ``size``-long dimension split over
    ``mesh``'s ``model`` axis that this rank holds, by DTensor's own
    chunking (uneven sizes included)."""
    from torch._subclasses.fake_tensor import unset_fake_temporarily
    from torch.distributed.tensor import Replicate, Shard
    from torch.distributed.tensor._utils import compute_local_shape_and_global_offset

    placements = [Shard(0) if a == MODEL_AXIS else Replicate() for a in mesh.axis_names]
    with unset_fake_temporarily():  # it reads the mesh's rank grid: real in a fake trace
        (n,), (lo,) = compute_local_shape_and_global_offset((size,), mesh.device_mesh,
                                                            placements)
    return int(lo), int(lo) + int(n)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; the gradient all-reduced over ``model`` (the
    column-parallel input's conjugate)."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        import torch.distributed as dist

        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _ReduceFromModel(torch.autograd.Function):
    """All-reduce over ``model`` forward (the row-parallel output); identity
    backward."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed as dist

        y = x.clone()
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, g):
        return g, None


def copy_to_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` unchanged; its gradient summed over ``mesh``'s ``model`` axis.
    The identity itself on an axis of one."""
    if model_split(mesh) == 1:
        return x
    return _CopyToModel.apply(x, mesh.group(MODEL_AXIS))


def reduce_from_model(x: torch.Tensor, mesh) -> torch.Tensor:
    """``x`` summed over ``mesh``'s ``model`` axis.  The identity itself on
    an axis of one."""
    if model_split(mesh) == 1:
        return x
    return _ReduceFromModel.apply(x, mesh.group(MODEL_AXIS))


def vocab_parallel_embed(table: torch.Tensor, ids: torch.Tensor, mesh,
                         vocab: int) -> torch.Tensor:
    """``full_table[ids]`` from this rank's row block ``table`` of a
    ``vocab``-row table split over ``model``: the ids outside the block
    masked, the local rows looked up, the masked rows zeroed, the sum taken
    over ``model``.  A plain lookup on an axis of one."""
    if model_split(mesh) == 1:
        return table[ids]
    lo, hi = shard_range(mesh, vocab)
    inside = (ids >= lo) & (ids < hi)
    if hi > lo:
        rows = table[torch.where(inside, ids - lo, 0)]
        rows = torch.where(inside[..., None], rows, 0.0)
    else:  # an empty block (more ranks than rows of the last chunk)
        rows = table.new_zeros(tuple(ids.shape) + (table.shape[-1],))
    return reduce_from_model(rows, mesh)


class _VocabParallelNLL(torch.autograd.Function):
    """``-log softmax(logits)[target]`` over a vocabulary split over
    ``model``, from each rank's ``[..., V / m]`` block of the logits: the
    max over ``model`` (a constant), the sum of exps and the target logit
    summed over ``model``.  Backward: the local softmax less the local
    one-hot, times the incoming gradient."""

    @staticmethod
    def forward(ctx, logits, targets, lo, group):
        import torch.distributed as dist

        logits = logits.to(torch.float32)
        vmax = logits.detach().amax(dim=-1)
        dist.all_reduce(vmax, op=dist.ReduceOp.MAX, group=group)
        shifted = logits - vmax[..., None]
        inside = (targets >= lo) & (targets < lo + logits.shape[-1])
        idx = torch.where(inside, targets - lo, 0).long()
        if logits.shape[-1]:
            tgt = torch.gather(shifted, -1, idx[..., None])[..., 0] * inside
        else:
            tgt = shifted.new_zeros(targets.shape)
        exp = shifted.exp_()
        total = exp.sum(dim=-1)
        sums = torch.stack([total, tgt])
        dist.all_reduce(sums, group=group)
        total, tgt = sums[0], sums[1]
        exp.div_(total[..., None])  # the local block of the softmax
        ctx.save_for_backward(exp, idx, inside)
        return torch.log(total) - tgt

    @staticmethod
    def backward(ctx, g):
        softmax, idx, inside = ctx.saved_tensors
        grad = softmax  # consumed: the backward runs once
        if grad.shape[-1]:
            grad.scatter_add_(-1, idx[..., None], -inside.to(grad.dtype)[..., None])
        grad.mul_(g[..., None])
        return grad, None, None, None


def vocab_parallel_nll(logits: torch.Tensor, targets: torch.Tensor, mesh,
                       vocab: int) -> torch.Tensor:
    """Per-position NLL of ``targets`` from this rank's block of the
    logits of a ``vocab``-long vocabulary split over ``model`` (its rows
    at :func:`shard_range`); the same value on every rank."""
    lo, _hi = shard_range(mesh, vocab)
    return _VocabParallelNLL.apply(logits, targets, lo, mesh.group(MODEL_AXIS))


def gather_vocab(local: torch.Tensor, mesh, vocab: int) -> torch.Tensor:
    """The whole ``[..., vocab]`` from each rank's last-axis block over
    ``model``, laid out by DTensor's chunking (a collective; for
    inspection, never in a step)."""
    if model_split(mesh) == 1:
        return local
    from torch.distributed.tensor import DTensor, Replicate, Shard

    shape = tuple(local.shape[:-1]) + (vocab,)
    placements = [Shard(local.dim() - 1) if a == MODEL_AXIS else Replicate()
                  for a in mesh.axis_names]
    stride = torch.empty(shape, device="meta").stride()
    return DTensor.from_local(local.contiguous(), mesh.device_mesh, placements, shape=shape,
                              stride=stride).full_tensor()
