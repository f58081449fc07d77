"""The port's transformer family against the JAX package's, on the CPU.

Weights start from the flax model's init, carried into the port with
``convert.transformer_from_numpy``; inputs are seeded numpy.  Tolerances:
the flat vector and the parameter paths bit for bit; logits and the three
losses ``atol=1e-5`` (relative 1e-5 where values pass 1); flat gradients
``atol=1e-5``.  The twins of ``tests/test_transformers.py`` keep its cases'
names; ``test_tiny_llama_learns`` runs over the two block layouts where the
JAX test runs over two meshes (the port trains on one card).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.flatten_util import ravel_pytree
from torch.func import functional_call

from parameter_server_tpu.learner.lm import make_mlm_batch as jax_make_mlm_batch
from parameter_server_tpu.models import transformer as jtfm
from parameter_server_tpu_torch.convert import transformer_from_numpy
from parameter_server_tpu_torch.kv.dense import PytreeCodec
from parameter_server_tpu_torch.learner.lm import SpmdLMTrainer, make_mlm_batch
from parameter_server_tpu_torch.models import transformer as tfm
from parameter_server_tpu_torch.models.layers import flat_items, params_tree

TOL = dict(rtol=1e-5, atol=1e-5)

#: (causal, config overrides): every layout and norm of the family
VARIANTS = {
    "llama": (True, {}),
    "llama_scan": (True, {"scan_blocks": True}),
    "llama_remat": (True, {"remat": True}),
    "llama_scan_remat": (True, {"scan_blocks": True, "remat": True}),
    "bert": (False, {}),
    "bert_scan_remat": (False, {"scan_blocks": True, "remat": True}),
    "llama_mha": (True, {"n_kv_heads": 4}),
}


def _markov_tokens(rng, batch, seq, vocab):
    """Learnable sequences: t_{i+1} = 3*t_i + 7 (mod vocab) with noise."""
    t = np.zeros((batch, seq), np.int32)
    t[:, 0] = rng.integers(0, vocab, batch)
    for i in range(1, seq):
        nxt = (3 * t[:, i - 1] + 7) % vocab
        noise = rng.random(batch) < 0.1
        t[:, i] = np.where(noise, rng.integers(0, vocab, batch), nxt)
    return t


def _twins(causal, seed=0, cls="Transformer", **kw):
    """(flax module, its params as numpy, port module with the same weights)."""
    jcfg = jtfm.tiny_config(causal=causal, **kw)
    cfg = tfm.tiny_config(causal=causal, **kw)
    jm = getattr(jtfm, cls)(jcfg)
    if cls == "Transformer":
        example = jnp.zeros((1, 8), jnp.int32)
    else:
        example = jnp.zeros((1, 8, cfg.d_model), jnp.float32)
    params = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed), example)["params"])
    pm = getattr(tfm, cls)(cfg, device="cpu", generator=tfm.make_generator("cpu", seed))
    transformer_from_numpy(pm, params)
    return jm, params, pm


def _tokens(rng, cfg_vocab=256, batch=2, seq=16):
    return rng.integers(0, cfg_vocab, size=(batch, seq)).astype(np.int32)


# -- twins of tests/test_transformers.py ----------------------------------------


def _count(cfg):
    return sum(int(p.numel()) for p in tfm.Transformer(cfg, device="meta").parameters())


def _jax_count(cfg):
    model = jtfm.Transformer(cfg)
    shapes = jax.eval_shape(
        lambda: model.init(jax.random.PRNGKey(0), jnp.zeros((1, 8), jnp.int32))
    )["params"]
    return sum(int(np.prod(x.shape)) for x in jax.tree.leaves(shapes))


def test_bert_base_param_count():
    n = _count(tfm.bert_base())
    # BERT-base ~110M params (no token-type embeddings, no pooler)
    assert 95e6 < n < 120e6, n
    assert n == _jax_count(jtfm.bert_base())


def test_llama3_8b_param_count():
    n = _count(tfm.llama3_8b())
    assert 7.9e9 < n < 8.2e9, n
    assert n == _jax_count(jtfm.llama3_8b())


def test_causal_masking_is_causal():
    """Token t's logits must not depend on tokens > t."""
    cfg = tfm.tiny_config(causal=True)
    model = tfm.Transformer(cfg, device="cpu", generator=tfm.make_generator("cpu", 0))
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 16)))
    with torch.no_grad():
        base = model(toks).numpy()
        toks2 = toks.clone()
        toks2[0, 10] = (toks2[0, 10] + 1) % cfg.vocab_size  # perturb a future token
        out2 = model(toks2).numpy()
    np.testing.assert_allclose(base[0, :10], out2[0, :10], atol=1e-5)
    assert not np.allclose(base[0, 10:], out2[0, 10:])


def test_bidirectional_attends_both_ways():
    cfg = tfm.tiny_config(causal=False)
    model = tfm.Transformer(cfg, device="cpu", generator=tfm.make_generator("cpu", 0))
    rng = np.random.default_rng(0)
    toks = torch.as_tensor(rng.integers(0, cfg.vocab_size, size=(1, 16)))
    with torch.no_grad():
        base = model(toks).numpy()
        toks2 = toks.clone()
        toks2[0, 15] = (toks2[0, 15] + 1) % cfg.vocab_size
        out2 = model(toks2).numpy()
    # earlier positions DO change (bidirectional)
    assert not np.allclose(base[0, :10], out2[0, :10])


@pytest.mark.parametrize("scan_blocks", [False, True])
def test_tiny_llama_learns(scan_blocks):
    cfg = tfm.tiny_config(causal=True, scan_blocks=scan_blocks)
    trainer = SpmdLMTrainer(cfg, learning_rate=3e-3, device="cpu")
    rng = np.random.default_rng(0)
    losses = [trainer.step_causal(_markov_tokens(rng, 32, 32, cfg.vocab_size))
              for _ in range(25)]
    # structure is learnable: CE must fall well below uniform (ln 256 = 5.55)
    assert losses[-1] < losses[0] - 1.0, losses[::8]


def test_tiny_bert_mlm_learns():
    cfg = tfm.tiny_config(causal=False)
    trainer = SpmdLMTrainer(cfg, learning_rate=5e-3, device="cpu")
    rng = np.random.default_rng(0)
    losses = []
    for _ in range(50):
        toks = _markov_tokens(rng, 64, 32, cfg.vocab_size)
        losses.append(trainer.step_mlm(*make_mlm_batch(toks, cfg.vocab_size, rng)))
    assert np.mean(losses[-5:]) < losses[0] - 1.0, losses[::10]


def test_gqa_heads_repeat():
    """GQA (n_kv_heads < n_heads) gives MHA-shaped outputs; the kernels keep
    flax's [d, heads, head_dim] layout."""
    cfg = tfm.tiny_config(causal=True, n_kv_heads=2)
    model = tfm.Transformer(cfg, device="cpu")
    with torch.no_grad():
        out = model(torch.zeros((2, 8), dtype=torch.long))
    assert tuple(out.shape) == (2, 8, cfg.vocab_size)
    assert model.layer_0.attn.k.kernel.shape[1] == 2  # kv heads
    assert model.layer_0.attn.q.kernel.shape[1] == 4


# -- parity with flax ------------------------------------------------------------


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_forward_logits_match_flax(variant):
    causal, kw = VARIANTS[variant]
    jm, params, pm = _twins(causal, seed=3, **kw)
    toks = _tokens(np.random.default_rng(1))
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks)))
    with torch.no_grad():
        got = pm(torch.as_tensor(toks)).numpy()
    assert got.dtype == np.float32 and got.shape == want.shape
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("variant", sorted(VARIANTS))
def test_flat_vector_is_ravel_pytree(variant):
    """``PytreeCodec(port).flatten`` equals ``ravel_pytree`` of the flax tree
    element for element (``layer_10`` sorts before ``layer_2`` in both)."""
    causal, kw = VARIANTS[variant]
    _jm, params, pm = _twins(causal, **kw)
    tree = params_tree(pm)
    flat = PytreeCodec(tree).flatten(tree)
    np.testing.assert_array_equal(flat, np.asarray(ravel_pytree(params)[0]))


def test_flat_vector_orders_layer_10_before_layer_2():
    _jm, params, pm = _twins(True, n_layers=11, d_model=16, n_heads=2, n_kv_heads=1, d_ff=16)
    paths = [p for p, _ in flat_items(params_tree(pm))]
    assert paths.index("layer_10.attn.k.kernel") < paths.index("layer_2.attn.k.kernel")
    tree = params_tree(pm)
    np.testing.assert_array_equal(PytreeCodec(tree).flatten(tree),
                                  np.asarray(ravel_pytree(params)[0]))


@pytest.mark.parametrize("cls", ["TransformerBody", "TransformerTrunk"])
def test_body_and_trunk_match_flax(cls):
    jm, params, pm = _twins(True, seed=4, cls=cls, tie_embeddings=False)
    x = np.random.default_rng(2).normal(size=(2, 12, 64)).astype(np.float32)
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(x)))
    with torch.no_grad():
        got = pm(torch.as_tensor(x)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_attention_mask_matches_flax():
    jm, params, pm = _twins(False, seed=5)
    toks = _tokens(np.random.default_rng(3))
    mask = np.ones(toks.shape, bool)
    mask[:, 11:] = False
    want = np.asarray(jm.apply({"params": params}, jnp.asarray(toks), jnp.asarray(mask)))
    with torch.no_grad():
        got = pm(torch.as_tensor(toks), torch.as_tensor(mask)).numpy()
    np.testing.assert_allclose(got, want, **TOL)


def test_causal_lm_loss_matches():
    logits = np.random.default_rng(4).normal(size=(3, 10, 40)).astype(np.float32)
    toks = np.random.default_rng(5).integers(0, 40, size=(3, 10)).astype(np.int32)
    want = float(jtfm.causal_lm_loss(jnp.asarray(logits), jnp.asarray(toks)))
    got = float(tfm.causal_lm_loss(torch.as_tensor(logits), torch.as_tensor(toks)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("chunk", [3, 4, 9, 1024])
def test_chunked_causal_lm_loss_matches(chunk):
    """Pads to whole chunks, masks the pad, divides by B * (S - 1); equal to
    the JAX scan and to the unchunked loss of the same logits."""
    rng = np.random.default_rng(6)
    hidden = rng.normal(size=(2, 10, 8)).astype(np.float32)
    head = rng.normal(size=(8, 30)).astype(np.float32)
    toks = rng.integers(0, 30, size=(2, 10)).astype(np.int32)
    want = float(jtfm.chunked_causal_lm_loss(jnp.asarray(hidden), jnp.asarray(head),
                                             jnp.asarray(toks), chunk))
    got = tfm.chunked_causal_lm_loss(torch.as_tensor(hidden), torch.as_tensor(head),
                                     torch.as_tensor(toks), chunk)
    np.testing.assert_allclose(float(got), want, **TOL)
    plain = tfm.causal_lm_loss(torch.as_tensor(hidden) @ torch.as_tensor(head),
                               torch.as_tensor(toks))
    np.testing.assert_allclose(float(got), float(plain), **TOL)


def test_chunked_loss_gradient_matches_the_plain_one():
    rng = np.random.default_rng(7)
    hidden = torch.as_tensor(rng.normal(size=(2, 10, 8)).astype(np.float32)).requires_grad_()
    head = torch.as_tensor(rng.normal(size=(8, 30)).astype(np.float32)).requires_grad_()
    toks = torch.as_tensor(rng.integers(0, 30, size=(2, 10)))
    g_chunk = torch.autograd.grad(tfm.chunked_causal_lm_loss(hidden, head, toks, 4),
                                  (hidden, head))
    g_plain = torch.autograd.grad(tfm.causal_lm_loss(hidden @ head, toks), (hidden, head))
    for a, b in zip(g_chunk, g_plain):
        np.testing.assert_allclose(a.numpy(), b.numpy(), **TOL)


@pytest.mark.parametrize("masked", [0, 5, 40])
def test_mlm_loss_matches(masked):
    """Mean over masked positions, the denominator at least 1 (masked=0)."""
    rng = np.random.default_rng(8)
    logits = rng.normal(size=(4, 10, 30)).astype(np.float32)
    targets = rng.integers(0, 30, size=(4, 10)).astype(np.int32)
    mask = np.zeros(40, np.float32)
    mask[rng.permutation(40)[:masked]] = 1
    mask = mask.reshape(4, 10)
    want = float(jtfm.mlm_loss(jnp.asarray(logits), jnp.asarray(targets), jnp.asarray(mask)))
    got = float(tfm.mlm_loss(torch.as_tensor(logits), torch.as_tensor(targets),
                             torch.as_tensor(mask)))
    np.testing.assert_allclose(got, want, **TOL)


@pytest.mark.parametrize("variant", ["llama", "llama_scan_remat", "bert"])
def test_loss_gradient_matches_flax(variant):
    """The flat gradient of the model's loss (what a PS worker pushes)
    against ``ravel_pytree`` of flax's."""
    causal, kw = VARIANTS[variant]
    jm, params, pm = _twins(causal, seed=9, **kw)
    rng = np.random.default_rng(10)
    toks = _tokens(rng, batch=4)
    if causal:
        def jloss(p):
            return jtfm.causal_lm_loss(jm.apply({"params": p}, jnp.asarray(toks)),
                                       jnp.asarray(toks))

        def ploss(tree):
            logits = functional_call(pm, dict(flat_items(tree)), (torch.as_tensor(toks),))
            return tfm.causal_lm_loss(logits, torch.as_tensor(toks))
    else:
        inputs, targets, mask = jax_make_mlm_batch(toks, 256, np.random.default_rng(11))

        def jloss(p):
            return jtfm.mlm_loss(jm.apply({"params": p}, jnp.asarray(inputs)),
                                 jnp.asarray(targets), jnp.asarray(mask))

        def ploss(tree):
            logits = functional_call(pm, dict(flat_items(tree)), (torch.as_tensor(inputs),))
            return tfm.mlm_loss(logits, torch.as_tensor(targets), torch.as_tensor(mask))
    jl, jg = jax.value_and_grad(jloss)(jax.tree.map(jnp.asarray, params))
    codec = PytreeCodec(params_tree(pm))
    vec = torch.as_tensor(codec.flatten(params_tree(pm))).requires_grad_()
    pl = ploss(codec.unflatten(vec))
    pl.backward()
    np.testing.assert_allclose(float(pl), float(jl), **TOL)
    np.testing.assert_allclose(vec.grad.numpy(), np.asarray(ravel_pytree(jg)[0]), **TOL)


def test_make_mlm_batch_is_the_jax_draw():
    toks = np.random.default_rng(12).integers(1, 20, size=(8, 16))
    got = make_mlm_batch(toks, 256, np.random.default_rng(13))
    want = jax_make_mlm_batch(toks, 256, np.random.default_rng(13))
    for a, b in zip(got, want):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


# -- what the port refuses -------------------------------------------------------


@pytest.mark.parametrize("impl", tfm.SEQ_PARALLEL_IMPLS)
def test_sequence_parallel_attention_raises(impl):
    """Each sequence-parallel ``attn_impl`` on an ``("sp",)`` mesh of one
    rank (a world-1 gloo group in this process) is a ring of one block: the
    logits and the input embeddings' gradient equal the dense model's from
    the same weights (1e-5); it needs the mesh and refuses a padding mask."""
    from parameter_server_tpu_torch.parallel import mesh as mesh_lib

    mesh = mesh_lib.make_mesh((1,), ("sp",), device="cpu")
    dense = tfm.Transformer(tfm.tiny_config(causal=True), device="cpu")
    sp = tfm.Transformer(tfm.tiny_config(causal=True, attn_impl=impl, spmd_mesh=mesh),
                         device="cpu")
    sp.load_state_dict(dense.state_dict())
    tokens = torch.as_tensor(np.random.default_rng(9).integers(0, 256, size=(2, 16)))
    outs = []
    for model in (dense, sp):
        x = model.embedding[tokens].detach().requires_grad_(True)
        logits = tfm._lm_head(model.cfg, model.lm_head, model.trunk(x))
        logits.square().mean().backward()
        outs.append((logits.detach().numpy(), x.grad.numpy()))
    np.testing.assert_allclose(outs[1][0], outs[0][0], atol=1e-5)
    np.testing.assert_allclose(outs[1][1], outs[0][1], atol=1e-5)
    with pytest.raises(ValueError, match="attn_mask"):
        sp.trunk(torch.zeros((1, 8, 64)), attn_mask=torch.ones((1, 8), dtype=torch.bool))
    no_mesh = tfm.Transformer(tfm.tiny_config(causal=True, attn_impl=impl), device="cpu")
    with pytest.raises(ValueError, match="spmd_mesh"):
        no_mesh(torch.zeros((1, 8), dtype=torch.long))


def test_learned_positions_refuse_a_long_sequence():
    cfg = tfm.tiny_config(causal=False, max_seq=8)
    model = tfm.Transformer(cfg, device="cpu")
    with pytest.raises(ValueError, match="exceeds learned-positional max_seq"):
        model(torch.zeros((1, 9), dtype=torch.long))


def test_convert_refuses_other_paths_and_shapes():
    _jm, params, pm = _twins(True)
    bad = jax.tree.map(lambda x: x, params)
    bad["layer_0"]["attn"]["q"]["kernel"] = np.zeros((64, 4, 8), np.float32)
    with pytest.raises(ValueError, match="shape"):
        transformer_from_numpy(pm, bad)
    scanned = tfm.Transformer(tfm.tiny_config(causal=True, scan_blocks=True), device="cpu")
    with pytest.raises(ValueError, match="paths differ"):
        transformer_from_numpy(scanned, params)

