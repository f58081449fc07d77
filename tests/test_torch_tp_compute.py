"""The port's ``model`` axis computes as Megatron splits, held to the JAX
package on the CPU and an 8-rank gloo world.

The JAX package shards the transformer's math over ``model`` through GSPMD
(``parameter_server_tpu/parallel/tp.py``: column- then row-parallel, one
all-reduce a block); the port writes the same split out
(``parameter_server_tpu_torch/parallel/tp.py``, ``models/transformer.py``).
From the same numpy seed, the JAX functions run in this process on
``conftest.py``'s 8 virtual CPU devices, the port's on the ranks of one
``torch_world.World``; a ``(1, 4)`` mesh is ``(rep 2, data 1, model 4)`` there
(a torch mesh covers its world).

- One causal block (2 or 4 KV heads over 4 model ranks: the first has fewer
  KV heads than ranks) and one MLM block (LayerNorm, biases, GELU, a padding
  mask) on ``(2, 4)`` and ``(1, 4)``: forward, and the gradients of the
  parameters and the input, against the JAX block at 1e-5 (relative, and
  absolute of the largest entry: ``TOL``).
- The vocab-parallel embedding and cross-entropy (plain, chunked, MLM) on a
  vocabulary of 250 rows, which 4 does not divide, against the full-logit
  JAX functions: values and gradients at 1e-5.
- The whole model through ``SpmdLMTrainer``'s own loss (the causal tiny
  config with 2 KV heads over 4 ranks; the tied MLM one with an uneven
  vocabulary): the loss and every gradient against JAX at 1e-5.
- A fake trace of every trainer that computes the split (each rank of a
  ``fake`` world, ``parallel/feasibility.py``): a ``(1, 4)`` rank's
  parameter and gradient bytes are at most a quarter of ``(1, 1)``'s plus
  the parameters replicated over ``model`` (under 2% here), and no operator
  of its step makes a tensor of a ``model``-split parameter's whole shape;
  and the tracker counts a DTensor operator's output by the rank's shard.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from parameter_server_tpu.models import transformer as jtfm

import torch_world

HERE = os.path.dirname(os.path.abspath(__file__))
#: relative, and absolute of the largest entry of the tensor or (gradients)
#: of any parameter's gradient: a sum over a reordered split differs from the
#: JAX sum by rounding relative to its terms' size (``k``'s bias has a zero
#: gradient, rounding noise on both sides)
TOL = 1e-5
MESHES = [(2, 4), (1, 4)]
BLOCKS = {
    "causal_kv2": dict(causal=True),  # tiny_config: 4 heads, 2 KV heads
    "causal_kv4": dict(causal=True, n_kv_heads=4),
    "mlm": dict(causal=False),
}


@pytest.fixture(scope="module")
def world():
    w = torch_world.World(8)
    yield w
    w.close()


def _flat(tree):
    return {".".join(k.key for k in path): np.asarray(leaf)
            for path, leaf in jax.tree_util.tree_flatten_with_path(tree)[0]}


def _close(got, want, what, scale=None):
    want = np.asarray(want)
    scale = float(np.abs(want).max()) if scale is None else scale
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL * scale, err_msg=what)


def _close_grads(got, want):
    assert set(got) == set(want)
    scale = max(float(np.abs(g).max()) for g in want.values())
    for n, g in got.items():
        _close(g, want[n], n, scale)


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", list(BLOCKS))
def test_block_matches_the_jax_block(world, kind, shape):
    cfg_kw = BLOCKS[kind]
    cfg = jtfm.tiny_config(**cfg_kw)
    rng = np.random.default_rng(0)
    B, S = 4, 8
    x = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    cot = rng.normal(size=(B, S, cfg.d_model)).astype(np.float32)
    positions = np.broadcast_to(np.arange(S), (B, S)).astype(np.int64).copy()
    mask = None
    if not cfg.causal:
        mask = rng.random((B, S)) < 0.8
        mask[:, 0] = True
    block = jtfm.Block(cfg)
    params = block.init(jax.random.PRNGKey(1), jnp.asarray(x), jnp.asarray(positions))["params"]
    # non-zero biases and scales: every term of the split shows
    params = jax.tree.map(lambda a: a + 0.1 * rng.normal(size=a.shape).astype(np.float32),
                          params)

    def f(p, xx):
        out = block.apply({"params": p}, xx, jnp.asarray(positions),
                          None if mask is None else jnp.asarray(mask))
        return jnp.sum(out * cot), out

    (_, want_out), (want_gp, want_gx) = jax.value_and_grad(f, argnums=(0, 1), has_aux=True)(
        params, jnp.asarray(x))
    res = world.run(torch_world.tp_block, shape, cfg_kw, _flat(params), x, positions, mask,
                    cot)
    n_data = shape[0]
    rows = B // n_data
    want_gp = _flat(want_gp)
    for idx, out, gx, grads in res:
        sl = slice(idx * rows, (idx + 1) * rows)
        _close(out, np.asarray(want_out)[sl], "forward")
        _close(gx, np.asarray(want_gx)[sl], "input gradient")
        _close_grads(grads, want_gp)


VOCAB_KINDS = ["embed", "causal", "chunked", "mlm"]


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", VOCAB_KINDS)
def test_vocab_parallel_embedding_and_loss_on_an_uneven_vocabulary(world, kind, shape):
    """250 rows over 4 ranks: DTensor's blocks of 63, 63, 63, 61."""
    rng = np.random.default_rng(3)
    B, S, d, V, chunk = 2, 9, 16, 250, 3
    tokens = rng.integers(0, V, size=(B, S)).astype(np.int32)
    mask = (rng.random((B, S)) < 0.5).astype(np.float32)
    hidden = rng.normal(size=(B, S, d)).astype(np.float32)
    if kind == "embed":
        weight = rng.normal(size=(V, d)).astype(np.float32)

        def f(w):
            out = jnp.asarray(w)[tokens]
            return jnp.sum(out * hidden), out

        (_, want), want_gw = jax.value_and_grad(f, has_aux=True)(weight)
        want_gh = None
    else:
        weight = rng.normal(size=(d, V)).astype(np.float32)

        def f(h, w):
            if kind == "chunked":
                return jtfm.chunked_causal_lm_loss(h, w, tokens, chunk)
            logits = jnp.einsum("bsd,dv->bsv", h, w)
            if kind == "causal":
                return jtfm.causal_lm_loss(logits, tokens)
            return jtfm.mlm_loss(logits, tokens, mask)

        want, (want_gh, want_gw) = jax.value_and_grad(f, argnums=(0, 1))(hidden, weight)
    res = world.run(torch_world.tp_vocab, shape, kind, V, hidden, weight, tokens, mask, chunk)
    for got, gh, gw in res:
        _close(got, np.asarray(want), "value")
        if want_gh is not None:
            _close(gh, np.asarray(want_gh), "hidden gradient")
        _close(gw, np.asarray(want_gw), "weight gradient")


MODELS = {
    # 4 heads, 2 KV heads over 4 model ranks; untied head; vocab 256
    "causal_kv2": dict(causal=True, tie_embeddings=False),
    # tied embeddings (one row shard for the lookup and the head), 250 rows
    "mlm_tied_v250": dict(causal=False, vocab_size=250),
}


@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
@pytest.mark.parametrize("kind", list(MODELS))
def test_whole_model_loss_and_gradients_match_jax(world, kind, shape):
    cfg_kw = MODELS[kind]
    cfg = jtfm.tiny_config(**cfg_kw)
    rng = np.random.default_rng(5)
    B, S = 4, 12
    tokens = rng.integers(0, cfg.vocab_size, size=(B, S)).astype(np.int32)
    model = jtfm.Transformer(cfg)
    params = model.init(jax.random.PRNGKey(2), jnp.asarray(tokens[:1]))["params"]
    if cfg.causal:
        inputs, targets, mask = tokens, tokens, None

        def f(p):
            return jtfm.causal_lm_loss(model.apply({"params": p}, inputs), targets)
    else:
        inputs = tokens.copy()
        mask = (rng.random((B, S)) < 0.3).astype(np.float32)
        mask[:, 1] = 1.0
        inputs[mask > 0] = 0
        targets = tokens

        def f(p):
            return jtfm.mlm_loss(model.apply({"params": p}, inputs), targets, mask)

    want, want_g = jax.value_and_grad(f)(params)
    np_params = jax.tree.map(np.asarray, params)
    res = world.run(torch_world.tp_model, shape, cfg_kw, np_params, inputs, targets, mask)
    want_g = _flat(want_g)
    for loss, grads in res:
        _close(loss, float(want), "loss")
        _close_grads(grads, want_g)


@pytest.fixture(scope="module")
def traced():
    code = "import json, torch_world; print(json.dumps(torch_world.tp_trace_cases()))"
    env = dict(os.environ, PYTHONPATH=os.pathsep.join([os.path.dirname(HERE), HERE]))
    proc = subprocess.run([sys.executable, "-c", code], cwd=HERE, env=env,
                          capture_output=True, text=True, timeout=240)
    assert proc.returncode == 0, proc.stderr[-4000:]
    return json.loads(proc.stdout.strip().splitlines()[-1])


@pytest.mark.parametrize("kind", ["lm", "hybrid", "body_step", "sptp", "pp"])
def test_a_model_rank_holds_a_quarter_and_makes_no_whole_split_parameter(traced, kind):
    """``SpmdLMTrainer``, ``HybridLMTrainer``'s body step, ``make_body_step``,
    ``SpTpLMTrainer`` and ``PipelinedLMTrainer(tp=True)`` (its stage) on
    ``(1, 4)`` against ``(1, 1)``."""
    one, four = traced[kind]["1,1"], traced[kind]["1,4"]
    assert four["n_split"] > 0 and four["n_split"] == one["n_split"]
    assert four["replicated"] < 0.02 * one["bytes"], four
    assert four["bytes"] <= one["bytes"] / 4 + four["replicated"], (one, four)
    assert four["whole_shapes_made"] == [], four
    # the recorder sees them where a rank does hold the whole
    assert one["whole_shapes_made"], one


def test_tracker_counts_a_dtensor_by_its_local_shard(traced):
    """A DTensor operator reaches the feasibility tracker as one operator on
    DTensors, whose wrapper reports the global size: the tracker counts the
    rank's shard (a quarter here)."""
    got = traced["dtensor_op"]
    assert got["shard"] == 1024 * 64 * 4 // 4
    assert got["peak"] == got["shard"], got
