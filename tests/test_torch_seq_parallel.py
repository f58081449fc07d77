"""The port's ring and Ulysses attention against the JAX package's, on an
8-rank gloo world.

Twin of ``tests/test_seq_parallel.py``, case for case.  The same seeded
numpy q / k / v go through the JAX oracle (``reference_attention``, and
``jax.grad`` of it) in this process and through the port's
``make_ring_attention`` / ``make_ulysses_attention`` on an ``("sp",)`` mesh
of 8 ranks (``tests/torch_world.py``), each rank returning its output block
and its share of the gradients of ``sum(out * w)``; the blocks are joined in
rank order and the shares summed.

Tolerances are the JAX test's: values atol 2e-5, dQ / dK / dV rtol 1e-4 /
atol 1e-5.  The memory twins have no XLA memory analysis: per rank they
count the bytes autograd saves for the backward
(``torch.autograd.graph.saved_tensors_hooks``) and the peak of the live
bytes of the forward and of the backward (``torch.profiler`` memory
events), and take the full score matrix analytically (``B * H * S * S *
4``); full attention is not run at 8k for the bound.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parameter_server_tpu.ops.ring_attention import reference_attention as jax_reference

import torch_world

N = 8
VALUES = dict(atol=2e-5)
GRADS = dict(rtol=1e-4, atol=1e-5)


@pytest.fixture(scope="module")
def world():
    w = torch_world.World(N)
    yield w
    w.close()


def _qkv(rng, b=2, s=64, h=8, d=16):
    return tuple(rng.normal(size=(b, s, h, d)).astype(np.float32) for _ in range(3))


def _run(world, kind, causal, q, k, v, w=None):
    """(the joined output, the summed gradients or None)."""
    res = world.run(torch_world.sp_attention, N, kind, causal, q, k, v, w)
    out = np.concatenate([r[0] for r in res], axis=1)
    grads = None if w is None else [sum(r[1][i] for r in res) for i in range(3)]
    return out, grads


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_matches_reference(world, causal):
    q, k, v = _qkv(np.random.default_rng(0))
    out, _ = _run(world, "ring", causal, q, k, v)
    np.testing.assert_allclose(out, np.asarray(jax_reference(q, k, v, causal=causal)), **VALUES)


@pytest.mark.parametrize("causal", [False, True])
def test_ulysses_matches_reference(world, causal):
    q, k, v = _qkv(np.random.default_rng(1))  # h=8 divisible by sp=8
    out, _ = _run(world, "ulysses", causal, q, k, v)
    np.testing.assert_allclose(out, np.asarray(jax_reference(q, k, v, causal=causal)), **VALUES)


def test_ulysses_multiple_heads_per_device(world):
    """hn > 1: head regrouping must preserve head identity."""
    q, k, v = _qkv(np.random.default_rng(3), b=1, s=32, h=16, d=8)  # hn = 16/8 = 2
    out, _ = _run(world, "ulysses", True, q, k, v)
    np.testing.assert_allclose(out, np.asarray(jax_reference(q, k, v, causal=True)), **VALUES)


def test_ring_attention_long_seq_smoke(world):
    """4k tokens over 8 shards: the shape and finite values."""
    q, k, v = _qkv(np.random.default_rng(2), b=1, s=4096, h=2, d=8)
    out, _ = _run(world, "ring", True, q, k, v)
    assert out.shape == (1, 4096, 2, 8)
    assert np.isfinite(out).all()


def test_ring_attention_memory_bound_at_8k(world):
    """A rank's forward temporaries are O(seq / n) blockwise, not O(seq^2):
    at seq 8192 over 8 ranks, the peak of the forward's live bytes on each
    rank, times n, stays under the full f32 score matrix, and what the
    backward keeps is the local q / k / v / output blocks and the
    logsumexp."""
    B, S, H, D = 1, 8192, 4, 64
    res = world.run(torch_world.sp_ring_memory, N, (B, S, H, D), True)
    scores_bytes = B * H * S * S * 4  # the f32 score matrix full attention holds
    block = B * (S // N) * H * D * 4
    for saved, fwd_peak, _bwd in res:
        assert fwd_peak * N <= scores_bytes, (fwd_peak, scores_bytes)
        assert saved <= 4 * block + B * H * (S // N) * 4 + 4096, (saved, block)


def test_ring_attention_exact_at_8k(world):
    """Exactness (not just smoke) at seq 8192: ring == full softmax."""
    q, k, v = _qkv(np.random.default_rng(4), b=1, s=8192, h=2, d=8)
    out, _ = _run(world, "ring", True, q, k, v)
    np.testing.assert_allclose(out, np.asarray(jax_reference(q, k, v, causal=True)), **VALUES)


@pytest.mark.parametrize("causal", [False, True])
def test_ring_attention_gradients_match_reference(world, causal):
    """The flash-style ring backward must give full attention's exact dQ /
    dK / dV: value parity alone would not catch a mis-rotated
    accumulator."""
    rng = np.random.default_rng(7)
    q, k, v = _qkv(rng, b=1, s=32, h=2, d=8)
    w = rng.normal(size=q.shape).astype(np.float32)
    _, got = _run(world, "ring", causal, q, k, v, w)

    def ref_loss(q_, k_, v_):
        return jnp.sum(jax_reference(q_, k_, v_, causal=causal) * w)

    want = jax.grad(ref_loss, argnums=(0, 1, 2))(q, k, v)
    for g, r in zip(got, want):
        np.testing.assert_allclose(g, np.asarray(r), **GRADS)


def test_ring_attention_backward_memory_stays_blockwise(world):
    """Training through the ring saves no per-step score blocks (O(S^2/n))
    and no per-step K/V copies (O(S) x n): the backward's peak live bytes
    on each rank stay under the full score matrix over n."""
    B, S, H, D = 1, 8192, 4, 64
    res = world.run(torch_world.sp_ring_memory, N, (B, S, H, D), True)
    scores_bytes = B * H * S * S * 4
    for _saved, _fwd, bwd_peak in res:
        assert 0 < bwd_peak < scores_bytes // N, (bwd_peak, scores_bytes // N)
