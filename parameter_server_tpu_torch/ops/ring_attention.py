"""Ring attention: exact attention over a sequence sharded across ranks.

Torch counterpart of ``parameter_server_tpu/ops/ring_attention.py``.  The
sequence is split over the ranks of an ``sp`` process group; each rank holds
one Q/K/V block.  K/V blocks rotate around the ring (rank ``i`` sends to
``(i + 1) mod n`` with ``torch.distributed.batch_isend_irecv``) while each
rank folds the visiting block into its queries' attention with the online
softmax (all in f32)::

    m' = max(m, rowmax(S))
    l' = l * exp(m - m') + rowsum(exp(S - m'))
    o' = o * exp(m - m') + exp(S - m') V

After ``n`` blocks every query has seen every key: the result is exact
attention.  Causality across blocks uses global offsets: at ring step ``r``
rank ``i`` holds the block that started on rank ``(i - r) mod n``.

The backward is the flash recurrence (:class:`_RingAttention`): the forward
keeps only the local q, k, v, the output and the per-query logsumexp; the
backward sends K/V around the ring again, recomputes each step's
probabilities, and the dK/dV accumulators of each visiting block ride along
with it, arriving at the block's owner after ``n`` rotations.  A rank keeps
O(S/n) for the backward and one (S/n)^2 block at a time.

One step of either pass is a function of its blocks (:func:`forward_step`,
:func:`backward_step`); the ring loops call them, and a single process can
run ``n`` virtual ranks over a list of blocks with the same code.  A group
of one rank (or ``group=None``) is a ring of one block: no rotation.

Attention here is plain tensor products, as the JAX reference's einsums,
with no fused attention kernel.
"""

from __future__ import annotations

import math
from typing import Tuple

import torch
import torch.distributed as dist


def _causal_mask(sq: int, sk: int, q_off: int, k_off: int, device) -> torch.Tensor:
    q_ids = q_off + torch.arange(sq, device=device)[:, None]
    k_ids = k_off + torch.arange(sk, device=device)[None, :]
    return k_ids <= q_ids


def _scores(q, k, q_off: int, k_off: int, scale: float, causal: bool) -> torch.Tensor:
    """``[B, H, Sq, Sk]`` f32 scores of a Q block against a K block, masked
    by global position when ``causal``."""
    s = torch.einsum("bqhd,bkhd->bhqk", q, k) * scale
    if causal:
        mask = _causal_mask(q.shape[1], k.shape[1], q_off, k_off, q.device)
        s = torch.where(mask[None, None], s, -math.inf)
    return s


def _block_attn(q, k, v, q_off: int, k_off: int, scale: float, causal: bool):
    """Partial (unnormalised) attention of one Q block against one K/V
    block: (row max ``[B, H, Sq]``, exp-sum ``[B, H, Sq]``, weighted values
    ``[B, Sq, H, D]``), f32."""
    s = _scores(q, k, q_off, k_off, scale, causal)
    m = torch.amax(s, dim=-1)
    # a row with no valid key in this block: its max is -inf
    m_safe = torch.where(torch.isfinite(m), m, torch.zeros_like(m))
    p = torch.exp(s - m_safe[..., None])
    p = torch.where(torch.isfinite(s), p, torch.zeros_like(p))
    l = torch.sum(p, dim=-1)  # noqa: E741
    o = torch.einsum("bhqk,bkhd->bqhd", p, v)
    return m_safe, l, o


def init_carry(q: torch.Tensor):
    """The online softmax's start: ``m = -inf``, ``l = 0``, ``o = 0``."""
    m = torch.full((q.shape[0], q.shape[2], q.shape[1]), -math.inf, dtype=torch.float32,
                   device=q.device)
    return m, torch.zeros_like(m), torch.zeros_like(q, dtype=torch.float32)


def forward_step(q, k_block, v_block, q_off: int, k_off: int, m, l, o, *,  # noqa: E741
                 causal: bool):
    """One ring step of the forward: fold the visiting K/V block (global
    offset ``k_off``) into the queries' running ``(m, l, o)``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    bm, bl, bo = _block_attn(q, k_block, v_block, q_off, k_off, scale, causal)
    new_m = torch.maximum(m, bm)
    # rescale both accumulators to the new max
    alpha = torch.where(torch.isfinite(m), torch.exp(m - new_m), torch.zeros_like(m))
    beta = torch.where(torch.isfinite(bm) & (bl > 0), torch.exp(bm - new_m),
                       torch.zeros_like(bm))
    new_l = l * alpha + bl * beta
    new_o = o * alpha.transpose(1, 2)[..., None] + bo * beta.transpose(1, 2)[..., None]
    return new_m, new_l, new_o


def finish(m, l, o):  # noqa: E741
    """(output ``[B, Sq, H, D]``, logsumexp ``[B, H, Sq]``) of a finished
    online softmax."""
    l_safe = torch.clamp(l, min=1e-30)
    return o / l_safe.transpose(1, 2)[..., None], m + torch.log(l_safe)


def backward_step(q, k_block, v_block, do, lse, d_term, q_off: int, k_off: int,
                  dq, dk, dv, *, causal: bool):
    """One ring step of the flash backward: the queries' ``dq`` and the
    visiting block's ``dk`` / ``dv`` accumulators, each with this step's
    share added.  ``d_term`` is ``rowsum(dO * O)`` ``[B, H, Sq]``."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = _scores(q, k_block, q_off, k_off, scale, causal)
    p = torch.exp(s - lse[..., None])  # exact probabilities (masked -> 0)
    dp = torch.einsum("bqhd,bkhd->bhqk", do, v_block)
    ds = p * (dp - d_term[..., None])
    dq = dq + torch.einsum("bhqk,bkhd->bqhd", ds, k_block) * scale
    dk = dk + torch.einsum("bhqk,bqhd->bkhd", ds, q) * scale
    dv = dv + torch.einsum("bhqk,bqhd->bkhd", p, do)
    return dq, dk, dv


def _ring(group) -> Tuple[int, int]:
    """(ring size, this rank's place on it); a ring of one without a group."""
    if group is None:
        return 1, 0
    return dist.get_world_size(group), dist.get_rank(group)


def _rotate(tensors, group, n: int, idx: int):
    """Send each tensor to the next rank of the ring and receive the
    previous rank's, all in one batch of point-to-point operations."""
    nxt = dist.get_global_rank(group, (idx + 1) % n)
    prv = dist.get_global_rank(group, (idx - 1) % n)
    out = [torch.empty_like(t) for t in tensors]
    ops = []
    for t, r in zip(tensors, out):
        ops.append(dist.P2POp(dist.isend, t.contiguous(), nxt, group))
        ops.append(dist.P2POp(dist.irecv, r, prv, group))
    for req in dist.batch_isend_irecv(ops):
        req.wait()
    return out


def ring_forward(q32, k32, v32, group, causal: bool):
    """The online-softmax ring pass: (output f32, logsumexp ``[B, H, Sq]``)."""
    n, idx = _ring(group)
    s_local = q32.shape[1]
    q_off = idx * s_local
    m, l, o = init_carry(q32)  # noqa: E741
    kr, vr = k32, v32
    for r in range(n):
        src = (idx - r) % n  # ring step r holds the block from rank src
        m, l, o = forward_step(q32, kr, vr, q_off, src * s_local, m, l, o,  # noqa: E741
                               causal=causal)
        if r + 1 < n:
            kr, vr = _rotate([kr, vr], group, n, idx)
    return finish(m, l, o)


def ring_backward(q32, k32, v32, out, lse, do, group, causal: bool):
    """The flash backward around the ring: (dq, dk, dv) of the local
    blocks; each block's dK/dV accumulator rotates with it and is home after
    ``n`` rotations."""
    n, idx = _ring(group)
    s_local = q32.shape[1]
    q_off = idx * s_local
    d_term = torch.einsum("bqhd,bqhd->bhq", do, out)
    dq = torch.zeros_like(q32)
    dk, dv = torch.zeros_like(k32), torch.zeros_like(v32)
    kr, vr = k32, v32
    for r in range(n):
        src = (idx - r) % n
        dq, dk, dv = backward_step(q32, kr, vr, do, lse, d_term, q_off, src * s_local,
                                   dq, dk, dv, causal=causal)
        if n > 1:
            moving = [dk, dv] + ([kr, vr] if r + 1 < n else [])
            moved = _rotate(moving, group, n, idx)
            dk, dv = moved[0], moved[1]
            if r + 1 < n:
                kr, vr = moved[2], moved[3]
    return dq, dk, dv


class _RingAttention(torch.autograd.Function):
    """Ring attention with the flash backward: the forward saves only the
    local q, k, v, the output and the logsumexp."""

    @staticmethod
    def forward(ctx, q32, k32, v32, group, causal):
        out, lse = ring_forward(q32, k32, v32, group, causal)
        ctx.save_for_backward(q32, k32, v32, out, lse)
        ctx.group, ctx.causal = group, causal
        return out

    @staticmethod
    def backward(ctx, g):
        q32, k32, v32, out, lse = ctx.saved_tensors
        dq, dk, dv = ring_backward(q32, k32, v32, out, lse, g.to(torch.float32), ctx.group,
                                   ctx.causal)
        return dq, dk, dv, None, None


def ring_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *, group=None,
                   causal: bool = False) -> torch.Tensor:
    """Exact attention over a sequence split across ``group``'s ranks.

    q / k / v: this rank's blocks ``[B, S_local, H, D]`` (the same heads on
    every rank), the blocks in rank order along the sequence.  Returns the
    rank's output block ``[B, S_local, H, D]`` in ``q.dtype``;
    differentiable through the flash-style ring backward."""
    q32, k32, v32 = (x.to(torch.float32) for x in (q, k, v))
    return _RingAttention.apply(q32, k32, v32, group, causal).to(q.dtype)


def sp_group(mesh, sp_axis: str):
    """The process group of this rank's ``sp_axis`` line (None on an axis of
    one: a ring of one block)."""
    return mesh.group(sp_axis) if mesh.shape[sp_axis] > 1 else None


def ring_attention_spmd(q, k, v, *, mesh, sp_axis: str, causal: bool = False) -> torch.Tensor:
    """Ring attention as one op of a model whose other layers run on local
    sequence blocks: the ring is ``mesh``'s ``sp_axis`` line through this
    rank, and every other mesh axis is left to the caller (a tensor-parallel
    ``model`` axis keeps its own placements).  ``q`` / ``k`` / ``v`` are this
    rank's blocks, as for :func:`ring_attention`."""
    return ring_attention(q, k, v, group=sp_group(mesh, sp_axis), causal=causal)


def local_block(x: torch.Tensor, mesh, sp_axis: str, dim: int = 1) -> torch.Tensor:
    """This rank's block of a tensor split evenly along ``dim`` over the
    mesh's ``sp_axis``, in rank order."""
    n, i = mesh.shape[sp_axis], mesh.index(sp_axis)
    if x.shape[dim] % n:
        raise ValueError(f"dimension {x.shape[dim]} is not divisible by {sp_axis}={n}")
    return x.narrow(dim, i * (x.shape[dim] // n), x.shape[dim] // n)


def make_ring_attention(mesh, *, sp_axis: str, causal: bool = False):
    """A function of the whole ``[B, S, H, D]`` q / k / v (the same on every
    rank) returning this rank's block of the output, the sequence split over
    ``sp_axis``: the JAX ``shard_map`` with its sequence-sharded specs.
    Gradients reach the whole tensors, non-zero on this rank's block."""

    def fn(q, k, v):
        blocks = (local_block(x, mesh, sp_axis) for x in (q, k, v))
        return ring_attention_spmd(*blocks, mesh=mesh, sp_axis=sp_axis, causal=causal)

    return fn


def reference_attention(q, k, v, *, causal: bool = False) -> torch.Tensor:
    """Plain full-softmax attention (the test oracle), f32 scores."""
    scale = 1.0 / math.sqrt(q.shape[-1])
    s = torch.einsum("bqhd,bkhd->bhqk", q.to(torch.float32), k.to(torch.float32)) * scale
    if causal:
        mask = torch.tril(torch.ones((q.shape[1], k.shape[1]), dtype=torch.bool,
                                     device=q.device))
        s = torch.where(mask[None, None], s, -math.inf)
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bhqk,bkhd->bqhd", p, v.to(torch.float32))
    return out.to(q.dtype)
