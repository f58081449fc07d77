"""The port's sequence-parallel LM trainer against the JAX package's dense
trainer, on an 8-rank gloo world.

Twin of ``tests/test_sp_lm.py``, case for case: the SP trainer must compute
the dense trainer's function (the same parameters, the same stream), train
end to end, and keep a rank's memory O(seq / n).  The trajectory cases start
the port's ``SpLMTrainer`` from the JAX ``SpmdLMTrainer``'s initial
parameters (``convert.transformer_from_numpy``) and hold its losses to the
JAX dense trainer's at the JAX test's rtol 2e-4 / atol 1e-5.

A torch mesh covers its world, so the JAX test's 4-device Ulysses mesh is
the ``(data 2, sp 4)`` mesh here (4 heads over 4 sp ranks, as there).  The
memory twin counts, on each rank, the bytes autograd saves for a step's
backward and the peak of the live bytes of its forward and backward, and
holds them to the full score matrix's analytic bytes.
"""

import types

import jax
import numpy as np
import pytest

from parameter_server_tpu.learner.lm import SpmdLMTrainer as JaxSpmdLMTrainer
from parameter_server_tpu.models import transformer as jtfm
from parameter_server_tpu.parallel import mesh as jmesh_lib
from parameter_server_tpu_torch.models import transformer as tfm
from parameter_server_tpu_torch.parallel.sp_lm import SpLMTrainer

import torch_world

N = 8
TRAJ = dict(rtol=2e-4, atol=1e-5)


@pytest.fixture(scope="module")
def world():
    w = torch_world.World(N)
    yield w
    w.close()


def _cfg_kw(**kw):
    defaults = dict(causal=True, tie_embeddings=False, n_heads=4, n_kv_heads=4, max_seq=256)
    defaults.update(kw)
    return defaults


def _tokens(vocab, rng, batch=4, seq=64):
    return rng.integers(0, vocab, size=(batch, seq)).astype(np.int32)


def _jax_dense(cfg_kw, batches, lr, seed):
    """(the JAX dense trainer's initial parameters, its losses)."""
    tr = JaxSpmdLMTrainer(jtfm.tiny_config(**cfg_kw),
                          jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1]),
                          learning_rate=lr, seed=seed)
    params = jax.tree.map(np.asarray, tr.params)
    return params, [tr.step_causal(b) for b in batches]


def _sp_losses(world, shape, axes, cfg_kw, params, batches, **kw):
    res = world.run(torch_world.sp_lm_from_params, shape, axes, cfg_kw, params, batches,
                    dict(device="cpu", **kw))
    assert all(r == res[0] for r in res)  # the loss is global
    return res[0]


def test_sp_trainer_matches_dense_trainer_trajectory(world):
    """Same init, same stream: the 8-shard ring trajectory equals the dense
    trajectory (identical parameter trees; the ring is exact attention)."""
    cfg_kw = _cfg_kw()
    rng = np.random.default_rng(0)
    batches = [_tokens(256, rng) for _ in range(4)]
    params, want = _jax_dense(cfg_kw, batches, 1e-2, 3)
    got = _sp_losses(world, (N,), ("sp",), cfg_kw, params, batches, learning_rate=1e-2)
    np.testing.assert_allclose(got, want, **TRAJ)


def test_sp_trainer_trains_long_sequences(world):
    cfg_kw = _cfg_kw(max_seq=2048)
    rng = np.random.default_rng(2)
    # a structured stream a tiny model can learn
    base = rng.integers(0, 256, size=(2, 1))
    tokens = ((base + np.arange(1024)[None, :]) % 256).astype(np.int32)
    res = world.run(torch_world.sp_lm_losses, (N,), ("sp",), cfg_kw, [tokens] * 8,
                    dict(learning_rate=3e-3, seed=1, device="cpu"))
    losses = res[0]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses


def test_sp_trainer_memory_stays_blockwise(world):
    """A step must not hold the O(S^2) score matrix: at seq 4096 over 8
    ranks, what a rank saves for the backward and the peak of its step's
    live bytes stay far below the full matrix's bytes."""
    cfg_kw = _cfg_kw(max_seq=4096, n_layers=2)
    B, S = 1, 4096
    batch = np.zeros((B, S), np.int32)
    res = world.run(torch_world.sp_lm_step_bytes, N, cfg_kw, batch)
    scores_bytes = B * 4 * S * S * 4  # the full matrix, per layer (4 heads)
    for saved, peak in res:
        assert 0 < saved < scores_bytes and 0 < peak < scores_bytes, (saved, peak,
                                                                       scores_bytes)


def test_sp_trainer_scan_blocks_composes(world):
    """SP x the stacked block layout x remat trains (finite losses)."""
    cfg_kw = _cfg_kw(scan_blocks=True, remat=True, n_layers=2)
    rng = np.random.default_rng(5)
    res = world.run(torch_world.sp_lm_losses, (N,), ("sp",), cfg_kw,
                    [_tokens(256, rng) for _ in range(4)],
                    dict(learning_rate=3e-3, seed=4, device="cpu"))
    assert np.isfinite(res[0]).all()


def test_sp_trainer_rejects_bad_configs(world):
    with pytest.raises(ValueError, match="sp"):
        SpLMTrainer(tfm.tiny_config(**_cfg_kw()),
                    types.SimpleNamespace(axis_names=("data", "model")))
    with pytest.raises(ValueError, match="causal"):
        SpLMTrainer(tfm.tiny_config(causal=False, tie_embeddings=False),
                    types.SimpleNamespace(axis_names=("sp",)))
    errors = world.run(torch_world.sp_lm_errors, N, _cfg_kw(), [
        ({}, (2, 60)),  # 60 % 8 != 0
        # learned positions + a global seq past max_seq must fail loudly at
        # the trainer, which knows the global sequence
        (dict(positional="learned", norm="ln", max_seq=32), (2, 64)),
    ])[0]
    assert "sp shards" in errors[0], errors
    assert "max_seq" in errors[1], errors


def test_sp_composes_with_dp(world):
    """DP x SP on one (data, sp) mesh: batch rows over data, sequence over
    sp, gradients summed over both; the dense trainer's trajectory."""
    cfg_kw = _cfg_kw()
    rng = np.random.default_rng(6)
    batches = [_tokens(256, rng, batch=4, seq=64) for _ in range(3)]
    params, want = _jax_dense(cfg_kw, batches, 1e-2, 9)
    got = _sp_losses(world, (2, 4), ("data", "sp"), cfg_kw, params, batches,
                     learning_rate=1e-2)
    np.testing.assert_allclose(got, want, **TRAJ)


def test_sp_trainer_ulysses_matches_dense(world):
    """attn="ulysses": the all-to-all head redistribution gives the dense
    trainer's trajectory (4 heads over 4 sp ranks)."""
    cfg_kw = _cfg_kw()
    rng = np.random.default_rng(8)
    batches = [_tokens(256, rng) for _ in range(3)]
    params, want = _jax_dense(cfg_kw, batches, 1e-2, 11)
    got = _sp_losses(world, (2, 4), ("data", "sp"), cfg_kw, params, batches,
                     learning_rate=1e-2, attn="ulysses")
    np.testing.assert_allclose(got, want, **TRAJ)
