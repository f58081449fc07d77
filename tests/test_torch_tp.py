"""The port's tensor-parallel / fsdp placements and the mesh LM trainer
against the JAX package's, on the CPU and an 8-rank gloo world.

Twins of ``tests/test_transformers.py:78`` (the placements cover the tree,
the embedding rows split over ``model``), ``tests/test_feasibility.py:77``
(fsdp's bytes per device, every shard shape divides) and ``:118`` (fsdp
training still converges), and ``tests/test_lm_scale_knobs.py:31`` (fsdp +
``loss_chunk`` equals the plain trainer at ``(2, 4)``).  The placement
rules are host code: every leaf's spec equals the JAX
``transformer_param_shardings`` spec exactly, for the unrolled and the
``scan_blocks`` trees, with and without fsdp.  The rules read only the mesh's
shape, so those cases need no world.

Tolerances: specs exactly; fsdp + ``loss_chunk`` against plain rtol 2e-4 /
atol 1e-5 (the JAX test's); the fsdp body against the JAX fsdp body and
against the port's TP placement rtol 1e-4 (the JAX test's).
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from parameter_server_tpu.models import transformer as jtfm
from parameter_server_tpu.parallel import mesh as jmesh_lib
from parameter_server_tpu.parallel.tp import transformer_param_shardings as jax_shardings
from parameter_server_tpu_torch.models import transformer as tfm
from parameter_server_tpu_torch.parallel import tp

import torch_world

SHAPE = {"data": 2, "model": 4}
MESH_24 = types.SimpleNamespace(shape=SHAPE, axis_names=("data", "model"))


@pytest.fixture(scope="module")
def world():
    w = torch_world.World(8)
    yield w
    w.close()


def _body_cfg(pkg, **kw):
    defaults = dict(causal=True, tie_embeddings=False, d_model=64, n_layers=2,
                    n_heads=4, n_kv_heads=4)
    defaults.update(kw)
    return pkg.tiny_config(**defaults)


def _jax_specs(params, fsdp):
    sh = jax_shardings(params, jmesh_lib.make_mesh((2, 4)), fsdp=fsdp)
    flat = jax.tree_util.tree_flatten_with_path(sh)[0]
    return {".".join(k.key for k in path): tuple(s.spec) for path, s in flat}


@pytest.mark.parametrize("scan", [False, True])
@pytest.mark.parametrize("fsdp", [False, True])
def test_every_leaf_spec_is_the_jax_spec(scan, fsdp):
    kw = dict(causal=True, scan_blocks=scan, n_layers=2)
    jparams = jax.eval_shape(lambda: jtfm.Transformer(jtfm.tiny_config(**kw)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    want = _jax_specs(jparams, fsdp)
    model = tfm.Transformer(tfm.tiny_config(**kw), device="cpu")
    got = {n: s.spec for n, s in tp.transformer_param_shardings(model, MESH_24,
                                                                fsdp=fsdp).items()}
    assert got == want
    if scan:  # fsdp splits the layer-stack axis over data, one layer a rank
        assert got["blocks.block.attn.q.kernel"][:3] == (("data", None, "model") if fsdp
                                                        else (None, None, "model"))


def test_tp_shardings_cover_tree():
    model = tfm.Transformer(tfm.tiny_config(causal=True), device="cpu")
    shardings = tp.transformer_param_shardings(model, MESH_24)
    assert set(shardings) == {n for n, _ in model.named_parameters()}
    # embedding must be row-sharded over model
    emb = shardings["embedding"]
    assert emb.spec[0] == "model"
    assert [str(p) for p in emb.placements] == ["R", "S(0)"]


def test_fsdp_shardings_split_state_over_data_axis():
    body = tfm.TransformerBody(_body_cfg(tfm), device="cpu")
    named = dict(body.named_parameters())
    tp_sh = tp.transformer_param_shardings(body, MESH_24)
    fsdp_sh = tp.transformer_param_shardings(body, MESH_24, fsdp=True)

    def per_device_bytes(shardings):
        return sum(int(np.prod(shardings[n].shard_shape(t.shape))) * t.element_size()
                   for n, t in named.items())

    # FSDP state footprint per device must be ~half the TP-only footprint
    # on a data=2 mesh (small replicated leaves may not split)
    assert per_device_bytes(fsdp_sh) < 0.6 * per_device_bytes(tp_sh)
    for n, t in named.items():
        fsdp_sh[n].shard_shape(t.shape)  # raises if not divisible


def test_fsdp_trainer_holds_only_its_shards(world):
    """What the placements promise, the trainer keeps: counting every tensor
    an ``SpmdLMTrainer`` holds on a rank after a step (its parameters,
    AdamW's moments, the module it runs them in), fsdp on a data=2 mesh
    holds under 0.6 x the TP layout's bytes, as the placements do."""
    cfg_kw = dict(causal=True, tie_embeddings=False, n_heads=4, n_kv_heads=4)
    vocab = tfm.tiny_config(**cfg_kw).vocab_size
    batch = np.random.default_rng(0).integers(0, vocab, size=(8, 16)).astype(np.int32)
    fsdp = world.run(torch_world.lm_held_bytes, (2, 4), cfg_kw, batch, True)
    plain = world.run(torch_world.lm_held_bytes, (2, 4), cfg_kw, batch, False)
    full = sum(p.numel() * p.element_size() for p in tfm.Transformer(
        tfm.tiny_config(**cfg_kw), device="cpu").parameters())
    assert max(fsdp) < 0.6 * min(plain), (fsdp, plain)
    # parameters and two moments, split 4 ways at least over model for the
    # large leaves: well under one full-size copy of the weights a rank
    assert max(plain) < full, (plain, full)


def test_fsdp_training_still_converges(world):
    """fsdp placements are a layout, not a math change: the tiny body under
    fsdp behaves as under TP, and as the JAX body under fsdp."""
    import optax

    cfg_kw = dict(causal=True, tie_embeddings=False, d_model=64, n_layers=2, n_heads=4,
                  n_kv_heads=4)
    jcfg = jtfm.tiny_config(**cfg_kw)
    body = jtfm.TransformerBody(jcfg)
    rng = np.random.default_rng(2)
    tokens = rng.integers(0, jcfg.vocab_size, size=(4, 16)).astype(np.int32)
    emb = rng.normal(size=(4, 16, jcfg.d_model)).astype(np.float32)
    params = body.init(jax.random.PRNGKey(0), jnp.zeros((1, 8, jcfg.d_model)))["params"]
    mesh = jmesh_lib.make_mesh((2, 4))
    jp = jax.tree.map(jax.device_put, params, jax_shardings(params, mesh, fsdp=True))
    tx = optax.adamw(1e-2)
    opt = tx.init(jp)

    @jax.jit
    def step(p, o, e, t):
        def loss_fn(p_):
            return jtfm.causal_lm_loss(body.apply({"params": p_}, e), t)

        l, g = jax.value_and_grad(loss_fn)(p)
        u, o = tx.update(g, o, p)
        return optax.apply_updates(p, u), o, l

    want = []
    for _ in range(3):
        jp, opt, l = step(jp, opt, jnp.asarray(emb), jnp.asarray(tokens))
        want.append(float(l))
    np_params = jax.tree.map(np.asarray, params)
    fsdp = world.run(torch_world.body_losses, (2, 4), cfg_kw, np_params, emb, tokens, True, 3)
    plain = world.run(torch_world.body_losses, (2, 4), cfg_kw, np_params, emb, tokens, False, 3)
    np.testing.assert_allclose(fsdp[0], plain[0], rtol=1e-4)
    np.testing.assert_allclose(fsdp[0], want, rtol=1e-4)
    assert fsdp[0][-1] < fsdp[0][0]


def test_spmd_lm_fsdp_and_chunked_loss_match_plain(world):
    """fsdp is a layout, loss_chunk is an evaluation order: at (2, 4) the
    trajectory matches the plain trainer step for step; the fsdp parameters
    really are split over data (and the embedding over model)."""
    cfg_kw = dict(causal=True, tie_embeddings=False, n_heads=4, n_kv_heads=4)
    rng = np.random.default_rng(0)
    vocab = tfm.tiny_config(**cfg_kw).vocab_size
    batches = [rng.integers(0, vocab, size=(8, 16)).astype(np.int32) for _ in range(4)]
    plain = world.run(torch_world.lm_losses, (2, 4), cfg_kw, batches,
                      dict(learning_rate=1e-2, seed=1))
    knobs = world.run(torch_world.lm_losses, (2, 4), cfg_kw, batches,
                      dict(learning_rate=1e-2, seed=1, fsdp=True, loss_chunk=4))
    np.testing.assert_allclose(knobs[0][0], plain[0][0], rtol=2e-4, atol=1e-5)
    assert all(r[0] == knobs[0][0] for r in knobs)  # the loss is global
    placements, local = knobs[0][1], knobs[0][2]
    assert placements["embedding"] == ("S(1)", "S(0)")
    model = tfm.Transformer(tfm.tiny_config(**cfg_kw), device="cpu")
    full = dict(model.named_parameters())
    assert local["embedding"] == (full["embedding"].shape[0] // 4,
                                  full["embedding"].shape[1] // 2)
    assert plain[0][1]["embedding"] == ("R", "S(0)")


def test_mesh_mlm_equals_one_device_on_the_global_batch(world):
    """The masked-LM loss on a (4, 2) mesh is the global batch's mean over
    every data block's masked positions: it equals one device's trainer."""
    from parameter_server_tpu_torch.learner.lm import SpmdLMTrainer, make_mlm_batch

    rng = np.random.default_rng(4)
    cfg = tfm.tiny_config(causal=False)
    batches = [make_mlm_batch(rng.integers(0, cfg.vocab_size, size=(8, 16)),
                              cfg.vocab_size, rng) for _ in range(3)]
    mesh_losses = world.run(torch_world.lm_mlm_losses, (4, 2), batches, 2)[0]
    one = SpmdLMTrainer(cfg, learning_rate=5e-3, seed=2, device="cpu")
    np.testing.assert_allclose(mesh_losses, [one.step_mlm(*b) for b in batches], rtol=2e-4)
