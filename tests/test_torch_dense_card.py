"""The dense LR step's segment-sum kernel and the touched-rows step on the
card, against their plain versions (run on the H100: ``python -m pytest -m
cuda tests/``).  No JAX here: the card's results are held to the port's own
plain PyTorch versions."""

import numpy as np
import pytest
import torch

from parameter_server_tpu_torch.config import OptimizerConfig
from parameter_server_tpu_torch.kv.optim import make_optimizer
from parameter_server_tpu_torch.models import linear
from parameter_server_tpu_torch.ops import scatter

pytestmark = pytest.mark.cuda


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the kernels have no CPU mode")


def _bits(t):
    return t.view(torch.int32)


def _case(kind, rng):
    """(slots [1, n], nnz) of one case: rows that end at and run past the
    kernel's windows (32 sorted entries) and its batches (16 x 32)."""
    if kind == "one_position":
        return np.array([[5]]), 1
    if kind == "one_row_short":
        return np.full((1, 30 * 7), 3), 7
    if kind == "one_row_many_batches":
        return np.full((1, 5 * 2048 + 17), 9), 1
    if kind == "rows_end_at_batch_edges":
        return (np.arange(32 + 512 * 3) // (32 + 512 * 2)).reshape(1, -1), 1
    if kind == "rows_cross_window_edges":
        return (np.arange(33 * 7) // 33).reshape(1, -1), 7
    # one row at 30% of the positions, PAD at every 7th, the rest spread
    slots = rng.integers(0, 1 << 20, size=4096 * 39)
    slots[rng.random(slots.size) < 0.3] = 12345
    slots[::7] = 1 << 20
    return slots.reshape(1, -1), 39


CASES = ["one_position", "one_row_short", "one_row_many_batches", "rows_end_at_batch_edges",
         "rows_cross_window_edges", "zipf_hot_row"]


@pytest.mark.parametrize("kind", CASES)
def test_cuda_segment_sum_is_the_plain_sums_bit_for_bit_and_repeats(kind):
    """``ps_segment_sum``: bitwise the position-ordered plain sums (zeros
    past the last row), one launch a call, a second launch bitwise equal."""
    _card()
    rng = np.random.default_rng(CASES.index(kind))
    slots, nnz = _case(kind, rng)
    order, uid, _ids = (g[0] for g in scatter.group_slots(torch.from_numpy(slots).cuda(),
                                                          1 << 20))
    residual = torch.from_numpy(rng.normal(size=slots.size // nnz).astype(np.float32)).cuda()
    scatter.reset_launch_counts()
    got = scatter.segment_sum_sorted(residual, order, uid, nnz)
    again = scatter.cuda_segment_sum(residual, order, uid, nnz)
    assert scatter.launch_counts()["segment_sum"] == 2
    want = scatter.segment_sum_sorted_torch(residual.cpu(), order.cpu(), uid.cpu(), nnz)
    assert torch.equal(_bits(got.cpu()), _bits(want))
    assert torch.equal(_bits(got), _bits(again))


def test_dense_step_on_the_card_is_one_segment_sum_and_one_apply_and_repeats_bitwise():
    """The touched-rows step launches one ``ps_segment_sum`` and one
    ``ps_apply``, agrees with the CPU step (the forward's reductions sum in
    another order there) and gives the same bits on a second run."""
    _card()
    rows, batch, nnz = 1 << 16, 2048, 39
    rng = np.random.default_rng(14)
    value = rng.normal(scale=0.3, size=(rows + 1, 1)).astype(np.float32)
    sum_sq = (np.abs(rng.normal(scale=0.3, size=(rows + 1, 1))) + 0.01).astype(np.float32)
    value[rows], sum_sq[rows] = 0, 0
    slots = rng.integers(0, rows // 2, size=batch * nnz)
    slots[rng.random(slots.size) < 0.3] = rows // 3
    slots[::7] = rows
    slots = torch.from_numpy(slots.reshape(batch, nnz))
    labels = torch.from_numpy(rng.integers(0, 2, size=batch).astype(np.float32))
    opt = make_optimizer(OptimizerConfig(kind="adagrad", learning_rate=0.1))
    runs = []
    for device in ("cuda", "cuda", "cpu"):
        planes = [torch.tensor(value, device=device), torch.tensor(sum_sq, device=device),
                  torch.full((1, 1), -0.2, device=device), torch.full((1, 1), 0.3, device=device)]
        scatter.reset_launch_counts()
        loss = linear.dense_fused_step(planes[0], {"sum_sq": planes[1]}, planes[2],
                                       {"sum_sq": planes[3]}, slots.to(device),
                                       labels.to(device), opt, rows)
        runs.append(([loss, *planes], scatter.launch_counts()))
    (card, counts), (again, _), (cpu, cpu_counts) = runs
    assert counts["segment_sum"] == counts["apply"] == 1 and counts["gather"] == 0
    assert not any(cpu_counts.values())
    for a, b, c in zip(card, again, cpu):
        assert torch.equal(_bits(a), _bits(b))
        np.testing.assert_allclose(a.cpu().numpy(), c.numpy(), rtol=1e-5, atol=1e-6)
