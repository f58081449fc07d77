"""The port's SP x TP x FSDP-state trainer against the JAX package's, on an
8-rank gloo world.

Twin of ``tests/test_sp_fsdp.py``, case for case, and a parity case of
``sp_chunked_causal_loss`` against the JAX ``causal_lm_loss``.  The composed
trainer runs on an ``(sp 4, model 2)`` mesh: the sequence over ``sp`` (the
ring), the weights placed over ``model`` by the TP rules, AdamW's moments
split over ``sp`` as well.  It starts from the JAX dense trainer's initial
parameters (``convert.placed_from_numpy``: each rank keeps its shards) and
follows that trainer's losses at the JAX test's rtol 2e-4 / atol 2e-5.  The
moments' layout is the JAX ``transformer_param_shardings(fsdp=True,
fsdp_axis="sp")`` spec for every leaf, and their local sizes are the shard
sizes: a rank that kept full moments would fail.
"""

import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from jax.sharding import Mesh

from parameter_server_tpu.learner.lm import SpmdLMTrainer as JaxSpmdLMTrainer
from parameter_server_tpu.models import transformer as jtfm
from parameter_server_tpu.parallel import mesh as jmesh_lib
from parameter_server_tpu.parallel.tp import transformer_param_shardings as jax_shardings
from parameter_server_tpu_torch.models import transformer as tfm
from parameter_server_tpu_torch.parallel import tp
from parameter_server_tpu_torch.parallel.sp_fsdp import SpTpLMTrainer

import torch_world

SHAPE = (4, 2)


@pytest.fixture(scope="module")
def world():
    w = torch_world.World(8)
    yield w
    w.close()


def _cfg_kw(**kw):
    defaults = dict(causal=True, tie_embeddings=False, n_heads=4, n_kv_heads=2, max_seq=256)
    defaults.update(kw)
    return defaults


def _toks(rng, n, seq=64):
    return [rng.integers(0, 256, size=(2, seq)).astype(np.int32) for _ in range(n)]


def test_sptp_matches_dense_trainer_trajectory(world):
    """Same init, same stream: the (sp 4, model 2) composed trajectory
    equals the dense one-device trainer's; ring + TP + moments over sp +
    chunked loss change the distribution, not the math."""
    cfg_kw = _cfg_kw()
    toks = _toks(np.random.default_rng(0), 4)
    ref = JaxSpmdLMTrainer(jtfm.tiny_config(**cfg_kw),
                           jmesh_lib.make_mesh((1, 1), devices=jax.devices()[:1]), seed=0)
    params = jax.tree.map(np.asarray, ref.params)
    want = [ref.step_causal(t) for t in toks]
    res = world.run(torch_world.sptp_run, SHAPE, cfg_kw, params, toks,
                    dict(fsdp="state", loss_chunk=16, device="cpu"))
    assert all(r[0] == res[0][0] for r in res)  # the loss is global
    np.testing.assert_allclose(res[0][0], want, rtol=2e-4, atol=2e-5)


def test_sptp_composes_with_scan_remat(world):
    """The stacked block layout + remat + the composed placements in one
    step: finite, and trains rather than diverges."""
    cfg_kw = _cfg_kw(scan_blocks=True, remat=True)
    res = world.run(torch_world.sptp_run, SHAPE, cfg_kw, None,
                    _toks(np.random.default_rng(1), 3),
                    dict(fsdp="state", loss_chunk=16, seed=1, device="cpu"))
    losses = res[0][0]
    assert np.all(np.isfinite(losses))
    assert losses[-1] < losses[0] + 0.5


def test_sptp_shardings_are_real(world):
    """Weights carry the model axis; their AdamW moments carry model AND sp
    (the JAX fsdp_axis="sp" spec, leaf for leaf), and a rank holds only its
    shard of each moment."""
    cfg_kw = _cfg_kw()
    res = world.run(torch_world.sptp_run, SHAPE, cfg_kw, None,
                    _toks(np.random.default_rng(2), 1),
                    dict(fsdp="state", loss_chunk=16, device="cpu"))
    _losses, local, moments, placements = res[0]
    jparams = jax.eval_shape(lambda: jtfm.Transformer(jtfm.tiny_config(**cfg_kw)).init(
        jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32)))["params"]
    jmesh = Mesh(np.asarray(jax.devices()).reshape(SHAPE), ("sp", "model"))
    flat = jax.tree_util.tree_flatten_with_path(
        jax_shardings(jparams, jmesh, fsdp=True, fsdp_axis="sp"))[0]
    want = {".".join(k.key for k in path): tuple(s.spec) for path, s in flat}
    mesh = types.SimpleNamespace(shape={"sp": 4, "model": 2}, axis_names=("sp", "model"))
    model = tfm.Transformer(tfm.tiny_config(**cfg_kw), device="cpu")
    got = tp.transformer_param_shardings(model, mesh, fsdp=True, fsdp_axis="sp")
    assert {n: s.spec for n, s in got.items()} == want
    for n, p in model.named_parameters():
        assert moments[n] == got[n].shard_shape(p.shape), n
    q = "layer_0.attn.q.kernel"
    assert local[q] == (64, 2, 16)  # TP over heads
    assert placements[q] == ("S(0)", "S(1)")  # moments: sp on d_model, model on heads
    assert np.prod(moments[q]) * 8 == np.prod(model.get_parameter(q).shape)


def test_sptp_rejects_bad_configs(world):
    with pytest.raises(ValueError, match="sp"):  # a data / model mesh
        SpTpLMTrainer(tfm.tiny_config(**_cfg_kw()),
                      types.SimpleNamespace(axis_names=("data", "model")))
    with pytest.raises(ValueError, match="causal"):
        SpTpLMTrainer(tfm.tiny_config(causal=False, tie_embeddings=False),
                      types.SimpleNamespace(axis_names=("sp", "model")))
    err = world.run(torch_world.sptp_errors, SHAPE, _cfg_kw(), (2, 30))[0]
    assert "sp shards" in err, err  # 30 % 4 != 0


def test_sp_chunked_loss_matches_causal_lm_loss(world):
    """Each rank's chunked NLL of its block, summed over sp, is the JAX
    ``causal_lm_loss`` of the whole sequence's logits (rtol 1e-5), and its
    gradient with respect to each rank's hidden block is the JAX gradient's
    block (rtol 1e-4 / atol 1e-6).  A chunk of 3 leaves a padded tail."""
    rng = np.random.default_rng(3)
    B, S, d, V = 2, 64, 16, 32
    hidden = rng.normal(size=(B, S, d)).astype(np.float32)
    head = (rng.normal(size=(d, V)) * 0.3).astype(np.float32)
    tokens = rng.integers(0, V, size=(B, S)).astype(np.int32)

    def ref(h):
        return jtfm.causal_lm_loss(jnp.einsum("bsd,dv->bsv", h, head), jnp.asarray(tokens))

    want, want_grad = jax.value_and_grad(ref)(jnp.asarray(hidden))
    res = world.run(torch_world.sp_chunked_loss, 8, hidden, head, tokens, 3)
    for value, _g in res:
        np.testing.assert_allclose(value, float(want), rtol=1e-5)
    grad = np.concatenate([g for _v, g in res], axis=1)
    np.testing.assert_allclose(grad, np.asarray(want_grad), rtol=1e-4, atol=1e-6)
