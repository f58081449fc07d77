"""Sparse logistic regression: the worker-side math of the PS loop and the
single-device training steps.

Torch counterpart of ``parameter_server_tpu/models/linear.py``.  With one-hot
categorical features the per-example logit is the sum of the weights at the
example's keys plus bias, and d(loss)/d(w_k) = (p - y) for each position
holding key k.

- :func:`grad_rows`: the PS loop's worker compute.
- :func:`fused_train_step`: rows mode.  One gather launch reads the value
  and state rows at the batch's unique slots; the table's apply runs through
  the kernel dispatchers (:func:`~parameter_server_tpu_torch.ops.scatter.apply_rows`,
  or the three-pass write-back with ``fused_apply=False``).
- :func:`dense_fused_step` / :func:`dense_scan_train_step`: dense mode.
  Per-position hashed slots index the whole table with no host dedup; the
  slots are sorted on the device (once a block), the segment-sum kernel of
  ``ops/scatter.py`` sums each touched row's gradient in position order, and
  the fused apply kernel runs the rule on the touched rows alone, which
  gives the JAX step's full-table rule bit for bit on every row.  Nothing in
  the step grows with the table.

Where the JAX steps donate their buffers and return new arrays, these update
``value``, ``state``, ``bias`` and ``bias_state`` in place and return the
loss as a tensor on the table's device (no host sync).
"""

from __future__ import annotations

from typing import Dict, Tuple

import torch

from parameter_server_tpu_torch.kv.optim import ServerOptimizer
from parameter_server_tpu_torch.ops import scatter
from parameter_server_tpu_torch.utils.keys import MIX32_A, MIX32_B
from parameter_server_tpu_torch.utils.trace import NULL_TRACER, Tracer

Planes = Dict[str, torch.Tensor]
_MASK32 = 0xFFFF_FFFF


def predict_logits(w_pos: torch.Tensor, bias) -> torch.Tensor:
    """Per-example logits from per-position weights ``[B, nnz]``."""
    return torch.sum(w_pos, dim=-1) + bias


def logloss(logits: torch.Tensor, labels: torch.Tensor, dim=None) -> torch.Tensor:
    """Mean binary cross-entropy from logits (numerically stable); over
    ``dim`` alone where one is given."""
    terms = (torch.clamp_min(logits, 0) - logits * labels
             + torch.log1p(torch.exp(-torch.abs(logits))))
    return torch.mean(terms) if dim is None else torch.mean(terms, dim=dim)


def grad_rows(
    w_pos: torch.Tensor, labels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-position gradient values: ``(grads [B, nnz], bias_grad [], loss [])``."""
    logits = predict_logits(w_pos, 0.0)
    residual = torch.sigmoid(logits) - labels  # [B]
    g = residual[:, None].expand(w_pos.shape)
    return g, torch.mean(residual), logloss(logits, labels)


def _loss_and_residual(w_pos, bias, bias_state, labels, optimizer):
    """Loss and the mean-scaled residual ``(p - y) / B`` of one batch."""
    # bias goes through the same lazy-weight transform (FTRL stores z there)
    bias_w = optimizer.pull_weights(bias, bias_state)
    logits = predict_logits(w_pos, bias_w[0, 0])
    loss = logloss(logits, labels)
    residual = (torch.sigmoid(logits) - labels) / labels.shape[0]
    return loss, residual


def _apply_bias(bias, bias_state, residual, optimizer) -> None:
    """The optimizer rule on the bias's 1 x 1 "table", in place."""
    new_b, new_bs = optimizer.apply(bias, bias_state, torch.sum(residual)[None, None])
    bias.copy_(new_b)
    for k in bias_state:
        bias_state[k].copy_(new_bs[k])


def fused_train_step(
    value: torch.Tensor,
    state: Planes,
    bias: torch.Tensor,
    bias_state: Planes,
    ids: torch.Tensor,
    inverse: torch.Tensor,
    labels: torch.Tensor,
    optimizer: ServerOptimizer,
    num_rows: int,
    *,
    fused_apply: bool = True,
) -> torch.Tensor:
    """One rows-mode LR step on the device-resident table, in place.

    ``ids``: unique int32 row slots ``[num_rows]`` (bucket-padded, pads at
    the trash row); ``inverse``: position -> slot-row map ``[B * nnz]``;
    ``labels``: ``[B]``.  The trash row ends at its fill.  Returns the loss.
    """
    names = list(state)
    rows = scatter.gather_rows_planes([value, *(state[k] for k in names)], ids)
    v_rows, s_rows = rows[0], dict(zip(names, rows[1:]))
    inv = inverse.reshape(-1).long()
    w_rows = optimizer.pull_weights(v_rows, s_rows)  # [num_rows, 1]
    w_pos = w_rows[inv, 0].reshape(labels.shape[0], -1)  # [B, nnz]
    loss, residual = _loss_and_residual(w_pos, bias, bias_state, labels, optimizer)
    g_pos = residual[:, None].expand(w_pos.shape).reshape(-1, 1)
    combined = scatter.segment_combine(g_pos, inv, num_rows).contiguous()
    if fused_apply:  # the kernel leaves trash-row ids alone
        scatter.apply_rows(value, state, ids, combined, optimizer)
    else:
        new_v, new_s = optimizer.apply(v_rows, s_rows, combined)
        scatter.scatter_update_rows_planes(
            [value, *(state[k] for k in names)], ids,
            [new_v.contiguous(), *(new_s[k].contiguous() for k in names)],
        )
        # pads wrote the rule's output for the trash row there
        fills = optimizer.state_shapes()
        value[-1].zero_()
        for k in names:
            state[k][-1].fill_(fills[k])
    _apply_bias(bias, bias_state, residual, optimizer)
    return loss


def _dense_touched_step(value, state, bias, bias_state, flat, labels, optimizer,
                        trash_row, tracer, logits, groups=None):
    """One dense step over the touched rows, in place (see
    :func:`dense_fused_step`): writes the step's logits into ``logits``
    (``[B]``; the caller takes the loss from them), and takes ``groups``,
    the step's ``(order, uid, ids)``, if a block's sort made them, else
    groups its ``flat`` slots itself."""
    # only a rule whose weights are derived from its state (FTRL) needs the
    # state at the positions
    reads_state = type(optimizer).pull_weights is not ServerOptimizer.pull_weights
    names = list(state) if reads_state else []
    with tracer.span("lr.forward"):
        # pull_weights is elementwise: on the gathered positions it gives the
        # same bits as on the whole table, at a fraction of the bytes
        w_pos = optimizer.pull_weights(
            torch.index_select(value, 0, flat),
            {k: torch.index_select(state[k], 0, flat) for k in names},
        )[:, 0].reshape(labels.shape[0], -1)
        bias_w = optimizer.pull_weights(bias, bias_state)
        torch.sum(w_pos, dim=-1, out=logits).add_(bias_w[0, 0])
        residual = (torch.sigmoid(logits) - labels) / labels.shape[0]
    with tracer.span("lr.segment_sum"):
        if groups is None:
            groups = [g[0] for g in scatter.group_slots(flat[None], trash_row)]
        order, uid, ids = groups
        grads = scatter.segment_sum_sorted(residual, order, uid, w_pos.shape[1])
    with tracer.span("lr.apply"):
        scatter.apply_rows(value, state, ids, grads, optimizer)
        _apply_bias(bias, bias_state, residual, optimizer)


def dense_fused_step(
    value: torch.Tensor,
    state: Planes,
    bias: torch.Tensor,
    bias_state: Planes,
    slots_pos: torch.Tensor,
    labels: torch.Tensor,
    optimizer: ServerOptimizer,
    trash_row: int,
    tracer: Tracer = NULL_TRACER,
) -> torch.Tensor:
    """Dense-apply LR step, in place: no host dedup, and no work that grows
    with the table.  Returns the loss as a device tensor.

    Per-position hashed row slots ``slots_pos`` ``[B, nnz]`` index the table
    directly.  :func:`~parameter_server_tpu_torch.ops.scatter.group_slots`
    sorts them and gives the step's unique rows at a static length (pads at
    ``trash_row``, the PAD slot); ``segment_sum_sorted`` sums each row's
    gradient in position order; ``apply_rows`` runs the rule on those rows
    alone and leaves the trash row as it was.  That is the full-table rule's
    arithmetic on every row, bit for bit: the rows it would give a zero
    gradient stay exactly as they were under a ``g0_stable`` rule with
    ``l1 == l2 == 0`` (see ``kv.optim.require_dense_apply``), which the
    caller enforces.  ``tracer``: the spans ``lr.forward``,
    ``lr.segment_sum`` (the grouping and the sum) and ``lr.apply``.
    """
    logits = torch.empty((1, labels.shape[0]), dtype=torch.float32, device=labels.device)
    _dense_touched_step(value, state, bias, bias_state, slots_pos.reshape(-1), labels,
                        optimizer, trash_row, tracer, logits[0])
    return logloss(logits, labels[None], dim=1)[0]


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for int64 ``x`` in ``[0, 2**32)``, with no
    product above 2**49: ``c`` is split into 16-bit halves, so nothing
    relies on how a signed 64-bit overflow wraps on the device."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def _widen(keys: torch.Tensor) -> torch.Tensor:
    """32-bit keys (int32 views of uint32, uint32 or int64) as int64 in
    ``[0, 2**32)``."""
    return keys.to(torch.int64) & _MASK32


def _fmix32(x: torch.Tensor, seed: int) -> torch.Tensor:
    x = x ^ (int(seed) & _MASK32)
    x = x ^ (x >> 16)
    x = _mul32(x, MIX32_A)
    x = x ^ (x >> 13)
    x = _mul32(x, MIX32_B)
    return x ^ (x >> 16)


def mix32_torch(keys: torch.Tensor, seed: int = 0) -> torch.Tensor:
    """murmur3 fmix32 on the keys' device: twin of ``utils.keys.mix32``.

    Torch has no uint32 shift or modulo, so the keys (4 bytes each: an int32
    view of uint32, or uint32) widen to int64 and every step is masked to
    the low 32 bits.  Returns int64 values in ``[0, 2**32)``, bit for bit the
    uint32 result of the host twin.
    """
    return _fmix32(_widen(keys), seed)


def device_slots(keys: torch.Tensor, num_rows: int, seed: int = 0) -> torch.Tensor:
    """The hashing trick on the device: ``mix32 % num_rows`` per key, and
    ``num_rows`` (the trash row of a ``[num_rows + 1]`` table) for PAD keys
    (``0xFFFFFFFF``) — what ``HashLocalizer(num_rows, seed, hash_bits=32)``
    assigns on the host.  int64, the shape of ``keys``."""
    x = _widen(keys)
    return torch.where(x == _MASK32, num_rows, _fmix32(x, seed) % num_rows)


def dense_scan_train_step(
    value: torch.Tensor,
    state: Planes,
    bias: torch.Tensor,
    bias_state: Planes,
    keys_block: torch.Tensor,
    labels_block: torch.Tensor,
    optimizer: ServerOptimizer,
    num_rows: int,
    seed: int = 0,
    tracer: Tracer = NULL_TRACER,
) -> torch.Tensor:
    """K dense-apply LR steps on raw 32-bit keys ``[K, B, nnz]`` (int32 views
    of uint32) and labels ``[K, B]``, in place.

    The block's keys are hashed on the device in one pass
    (:func:`device_slots`); PAD keys route to the trash row, so real keys
    must be < 2**32 - 1.  One sort groups every step's slots, and K
    :func:`dense_fused_step` steps are enqueued back to back.  Returns the
    losses ``[K]`` as a device tensor: nothing here waits on the device, so
    the host can stage the next block while this one runs.  ``tracer``: the
    span ``lr.hash`` (the hash and the grouping) and each step's.
    """
    k_steps = keys_block.shape[0]
    with tracer.span("lr.hash"):
        # int32 slots: what the step's gather and sort take; one sort
        # groups every step's slots
        slots = device_slots(keys_block, num_rows, seed).to(torch.int32).reshape(k_steps, -1)
        order, uid, ids = scatter.group_slots(slots, num_rows)
    logits = torch.empty(labels_block.shape, dtype=torch.float32, device=labels_block.device)
    for k in range(k_steps):
        _dense_touched_step(value, state, bias, bias_state, slots[k], labels_block[k],
                            optimizer, num_rows, tracer, logits[k], (order[k], uid[k], ids[k]))
    # the losses need nothing of the updates: one pass over the block's logits
    return logloss(logits, labels_block, dim=1)


def eval_logits(
    value: torch.Tensor,
    state: Planes,
    bias: torch.Tensor,
    bias_state: Planes,
    ids: torch.Tensor,
    inverse: torch.Tensor,
    batch: int,
    optimizer: ServerOptimizer,
) -> torch.Tensor:
    """Forward-only logits for evaluation batches (one gather launch for the
    value and state rows)."""
    names = list(state)
    rows = scatter.gather_rows_planes([value, *(state[k] for k in names)], ids)
    w_rows = optimizer.pull_weights(rows[0], dict(zip(names, rows[1:])))
    w_pos = w_rows[inverse.reshape(-1).long(), 0].reshape(batch, -1)
    bias_w = optimizer.pull_weights(bias, bias_state)
    return predict_logits(w_pos, bias_w[0, 0])
