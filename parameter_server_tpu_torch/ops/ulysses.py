"""Ulysses-style sequence parallelism: all-to-all head redistribution.

Torch counterpart of ``parameter_server_tpu/ops/ulysses.py``, the
alternative to ring attention: each rank starts with every head on its
sequence block, an all-to-all gives it every sequence position for ``H / n``
of the heads, it runs ordinary full-sequence attention on those, and a
second all-to-all brings the output back to its sequence block.  Two
collectives a call; the better choice when heads >> ranks and a rank's
full-sequence block fits its memory.

The all-to-alls are tiled as ``jax.lax.all_to_all(tiled=True)``: one axis
split into ``n`` chunks in rank order, the chunks received concatenated on
another axis in source order, so ``seq_to_heads`` and ``heads_to_seq`` are
exact mirrors and heads stay group-major.  ``torch.distributed.all_to_all``
is not differentiable: :class:`_AllToAll` gives it its backward, the
reverse all-to-all, so training runs through it.
"""

from __future__ import annotations

import torch
import torch.distributed as dist

from parameter_server_tpu_torch.ops.ring_attention import (
    _ring,
    sp_group,
    local_block,
    reference_attention,
)


def _all_to_all(x: torch.Tensor, group, split_axis: int, concat_axis: int) -> torch.Tensor:
    n, _ = _ring(group)
    if n == 1:
        return x
    chunks = [c.contiguous() for c in torch.chunk(x, n, dim=split_axis)]
    out = [torch.empty_like(chunks[0]) for _ in range(n)]
    dist.all_to_all(out, chunks, group=group)
    return torch.cat(out, dim=concat_axis)


class _AllToAll(torch.autograd.Function):
    """Tiled all-to-all whose backward is the mirrored all-to-all."""

    @staticmethod
    def forward(ctx, x, group, split_axis, concat_axis):
        ctx.group, ctx.axes = group, (split_axis, concat_axis)
        return _all_to_all(x, group, split_axis, concat_axis)

    @staticmethod
    def backward(ctx, g):
        split_axis, concat_axis = ctx.axes
        return _all_to_all(g.contiguous(), ctx.group, concat_axis, split_axis), None, None, None


def ulysses_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group=None,
                      causal: bool = False) -> torch.Tensor:
    """q / k / v: this rank's blocks ``[B, S_local, H, D]``, ``H`` divisible
    by the group's size.  Returns the rank's output block ``[B, S_local, H,
    D]``."""
    n, _ = _ring(group)
    if q.shape[2] % n:
        raise ValueError(f"{q.shape[2]} heads are not divisible by {n} ranks")

    def seq_to_heads(x):  # [B, S_loc, H, D] -> [B, S_glob, H/n, D]
        return _AllToAll.apply(x, group, 2, 1)

    def heads_to_seq(x):  # [B, S_glob, H/n, D] -> [B, S_loc, H, D]
        return _AllToAll.apply(x, group, 1, 2)

    out = reference_attention(seq_to_heads(q), seq_to_heads(k), seq_to_heads(v),
                              causal=causal)
    return heads_to_seq(out)


def make_ulysses_attention(mesh, *, sp_axis: str, causal: bool = False):
    """A function of the whole ``[B, S, H, D]`` q / k / v (the same on every
    rank) returning this rank's block of the output, the sequence split over
    ``sp_axis`` (as ``make_ring_attention``)."""
    group = sp_group(mesh, sp_axis)

    def fn(q, k, v):
        blocks = (local_block(x, mesh, sp_axis) for x in (q, k, v))
        return ulysses_attention(*blocks, group=group, causal=causal)

    return fn
