"""The port's ``SpmdLMTrainer`` against the JAX trainer, on the CPU.

Both start from the JAX trainer's weights (``convert.transformer_from_numpy``)
with fresh AdamW state, on one device (the JAX trainer on a ``(1, 1)`` mesh),
and take the same seeded batches.  Tolerances: ``logits`` before training
1e-5; multi-step losses ``rtol=1e-4, atol=1e-4``; the chunked-loss
trajectory against the plain one ``rtol=2e-4, atol=1e-5`` (the JAX test's
own bound).  Parameters after a step are not compared element for element:
Adam's first update is ``lr * g / (|g| + 1e-8)``, so a gradient of ~1e-8
(float32 noise of a sum) moves its parameter by up to ``lr`` in either
package.
"""

import io
import json

import jax
import numpy as np
import pytest
import torch

from parameter_server_tpu.learner.lm import SpmdLMTrainer as JaxSpmdLMTrainer
from parameter_server_tpu.models import transformer as jtfm
from parameter_server_tpu.parallel import mesh as mesh_lib
from parameter_server_tpu_torch.convert import transformer_from_numpy
from parameter_server_tpu_torch.learner.lm import ADAMW, SpmdLMTrainer, make_mlm_batch
from parameter_server_tpu_torch.models import transformer as tfm
from parameter_server_tpu_torch.utils import metrics as metrics_lib

TRAJ = dict(rtol=1e-4, atol=1e-4)


def _cfg(pkg, **kw):
    """tests/test_lm_scale_knobs.py's config: causal, untied, MHA."""
    defaults = dict(causal=True, tie_embeddings=False, n_heads=4, n_kv_heads=4)
    defaults.update(kw)
    return pkg.tiny_config(**defaults)


def _tokens(rng, batch=8, seq=16, vocab=256):
    return rng.integers(0, vocab, size=(batch, seq)).astype(np.int32)


def _mesh():
    return mesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])


def _pair(jcfg, cfg, lr, seed, **kw):
    """A JAX trainer and a port trainer holding its initial weights."""
    jtr = JaxSpmdLMTrainer(jcfg, _mesh(), learning_rate=lr, seed=seed, **kw)
    tr = SpmdLMTrainer(cfg, learning_rate=lr, seed=seed, device="cpu", **kw)
    transformer_from_numpy(tr.model, jax.tree.map(np.asarray, jtr.params))
    return jtr, tr


@pytest.mark.parametrize("loss_chunk", [0, 4])
def test_causal_steps_match_the_jax_trainer(loss_chunk):
    jtr, tr = _pair(_cfg(jtfm), _cfg(tfm), 1e-2, 1, loss_chunk=loss_chunk)
    rng = np.random.default_rng(0)
    probe = _tokens(rng, batch=2)
    np.testing.assert_allclose(tr.logits(probe), jtr.logits(probe), rtol=1e-5, atol=1e-5)
    for _ in range(4):
        b = _tokens(rng)
        np.testing.assert_allclose(tr.step_causal(b), jtr.step_causal(b), **TRAJ)


@pytest.mark.parametrize("scan_blocks", [False, True])
def test_mlm_steps_match_the_jax_trainer(scan_blocks):
    jtr, tr = _pair(jtfm.tiny_config(causal=False, scan_blocks=scan_blocks),
                    tfm.tiny_config(causal=False, scan_blocks=scan_blocks), 5e-3, 2)
    rng = np.random.default_rng(3)
    for _ in range(4):
        toks = rng.integers(1, 20, size=(8, 16))
        batch = make_mlm_batch(toks, 256, rng)
        np.testing.assert_allclose(tr.step_mlm(*batch), jtr.step_mlm(*batch), **TRAJ)


def test_spmd_lm_chunked_loss_matches_plain():
    """The ``loss_chunk`` half of test_lm_scale_knobs.py:31: ``loss_chunk``
    is an evaluation order, so the trajectory matches the plain trainer's
    step for step."""
    cfg = _cfg(tfm)
    rng = np.random.default_rng(0)
    batches = [_tokens(rng) for _ in range(4)]
    plain = SpmdLMTrainer(cfg, learning_rate=1e-2, seed=1, device="cpu")
    knobs = SpmdLMTrainer(cfg, learning_rate=1e-2, seed=1, loss_chunk=4, device="cpu")
    for b in batches:
        np.testing.assert_allclose(knobs.step_causal(b), plain.step_causal(b),
                                   rtol=2e-4, atol=1e-5)


def test_spmd_lm_scan_blocks_trains():
    """scan_blocks restructures the param tree (stacked layers under
    blocks.block); the trainer must still train it."""
    cfg = _cfg(tfm, scan_blocks=True, remat=True, n_layers=2)
    tr = SpmdLMTrainer(cfg, learning_rate=3e-2, seed=2, loss_chunk=4, device="cpu")
    names = dict(tr.model.named_parameters())
    assert "blocks.block.attn.q.kernel" in names  # stacked layout in use
    assert names["blocks.block.attn.q.kernel"].shape[0] == cfg.n_layers
    rng = np.random.default_rng(3)
    losses = [tr.step_causal(_tokens(rng)) for _ in range(8)]
    assert np.isfinite(losses).all()
    assert np.mean(losses[-2:]) < np.mean(losses[:2]), losses


def test_fsdp_raises():
    """``fsdp=True`` no longer raises: on a one-rank (1, 1) mesh (a gloo
    world of this process) the DTensor-placed trainer equals the plain one
    on one device bit for bit — losses, parameters and AdamW's moments,
    which take the parameters' placements."""
    from torch.distributed.tensor import DTensor

    from parameter_server_tpu_torch.parallel import mesh as port_mesh

    one = port_mesh.make_mesh((1, 1), device="cpu")
    knobs = SpmdLMTrainer(_cfg(tfm), one, fsdp=True, learning_rate=1e-2, seed=1, device="cpu")
    plain = SpmdLMTrainer(_cfg(tfm), learning_rate=1e-2, seed=1, device="cpu")
    rng = np.random.default_rng(0)
    for _ in range(3):
        toks = _tokens(rng)
        assert knobs.step_causal(toks) == plain.step_causal(toks)
    params = dict(plain.model.named_parameters())
    assert set(knobs.params) == set(params)
    for name, p in knobs.params.items():
        assert torch.equal(p.full_tensor(), params[name].detach()), name
        moment = knobs.optimizer.state[p]["exp_avg"]
        assert isinstance(moment, DTensor) and moment.placements == p.placements
        assert torch.equal(moment.full_tensor(), plain.optimizer.state[params[name]]["exp_avg"])
    toks = _tokens(rng)
    assert np.array_equal(knobs.logits(toks), plain.logits(toks))


@pytest.mark.parametrize("kw", [dict(causal=False), dict(tie_embeddings=True)])
def test_loss_chunk_needs_a_causal_untied_model(kw):
    with pytest.raises(ValueError, match="loss_chunk requires"):
        SpmdLMTrainer(_cfg(tfm, **kw), loss_chunk=4, device="cpu")


def test_step_kind_must_match_the_model():
    causal = SpmdLMTrainer(_cfg(tfm), device="cpu")
    with pytest.raises(ValueError, match="step_mlm on a causal"):
        causal.step_mlm(np.zeros((1, 4)), np.zeros((1, 4)), np.zeros((1, 4)))
    mlm = SpmdLMTrainer(tfm.tiny_config(causal=False), device="cpu")
    with pytest.raises(ValueError, match="step_causal on a non-causal"):
        mlm.step_causal(np.zeros((1, 4)))


def test_adamw_is_optax_adamw():
    """weight_decay 1e-4 (optax's default, not torch's 0.01)."""
    tr = SpmdLMTrainer(_cfg(tfm), device="cpu")
    group = tr.optimizer.param_groups[0]
    assert isinstance(tr.optimizer, torch.optim.AdamW)
    assert (group["betas"], group["eps"], group["weight_decay"]) == (
        ADAMW["betas"], ADAMW["eps"], ADAMW["weight_decay"]) == ((0.9, 0.999), 1e-8, 1e-4)


@pytest.mark.parametrize("tied", [False, True])
def test_mfu_counts_the_jax_matmul_params(tied):
    """6 x matmul params x seq an example, as the JAX trainer counts them
    (the input embedding only when tied, learned positions never)."""
    kw = dict(causal=not tied, tie_embeddings=tied)
    jtr = JaxSpmdLMTrainer(jtfm.tiny_config(**kw), _mesh())
    sink = io.StringIO()
    tr = SpmdLMTrainer(tfm.tiny_config(**kw), device="cpu",
                       dashboard=metrics_lib.Dashboard(jsonl=sink, print_every=0))
    assert tr.n_matmul_params == jtr.n_matmul_params
    toks = _tokens(np.random.default_rng(4), batch=2)
    if tied:
        tr.step_mlm(*make_mlm_batch(toks, 256, np.random.default_rng(5)))
    else:
        tr.step_causal(toks)
    assert tr.dashboard.flops_per_example == 6.0 * jtr.n_matmul_params * 16
    assert json.loads(sink.getvalue().splitlines()[0])["mfu_pct"] > 0
