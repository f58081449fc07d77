"""The port's chunked dense plane (config #4's spine) against the JAX
package's, on the CPU: per-segment overlapped push/pull, byte accounting, and
the chunked learner's trajectory on a tiny BERT.

Twins of ``tests/test_chunked_dense.py``'s six cases (the wire-bytes case,
``test_chunked_with_wire_filters``, included), then 5 chunked BSP steps of
the port's ``ChunkedAsyncDenseLearner`` against the JAX learner from the same
flat vector on the same seeded MLM batches: losses ``rtol=1e-4,
atol=1e-4``; segments and offsets bit for bit; the trained vectors leaf by
leaf (see ``_assert_final_vectors_agree``).
"""

import io
import json
import sys

import jax
import numpy as np
import pytest
import torch
from torch.func import functional_call

from parameter_server_tpu.config import ConsistencyConfig as JaxConsistencyConfig
from parameter_server_tpu.config import ConsistencyMode as JaxConsistencyMode
from parameter_server_tpu.config import OptimizerConfig as JaxOptimizerConfig
from parameter_server_tpu.core.postoffice import Postoffice as JaxPostoffice
from parameter_server_tpu.core.van import LoopbackVan as JaxLoopbackVan
from parameter_server_tpu.kv import dense as jdense
from parameter_server_tpu.learner import dense as jlearner
from parameter_server_tpu.learner.lm import make_mlm_batch as jax_make_mlm_batch
from parameter_server_tpu.models import transformer as jtfm
from parameter_server_tpu_torch.config import (
    ConsistencyConfig,
    ConsistencyMode,
    OptimizerConfig,
)
from parameter_server_tpu_torch.convert import transformer_from_numpy
from parameter_server_tpu_torch.core.filters import (
    CompressingFilter,
    FilterChain,
    FixingFloatFilter,
)
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.kv.dense import (
    DenseKVServer,
    DenseKVWorker,
    PytreeCodec,
    fixed_segments,
    layer_segments,
)
from parameter_server_tpu_torch.learner.dense import ChunkedAsyncDenseLearner
from parameter_server_tpu_torch.learner.lm import make_mlm_batch
from parameter_server_tpu_torch.models import transformer as tfm
from parameter_server_tpu_torch.models.layers import flat_items, params_tree
from parameter_server_tpu_torch.utils import metrics as metrics_lib

TRAJ = dict(rtol=1e-4, atol=1e-4)


def test_fixed_segments_cover_exactly():
    segs = fixed_segments(1000, 256)
    assert segs[0] == (0, 256)
    assert segs[-1] == (768, 1000)
    assert sum(b - a for a, b in segs) == 1000
    assert segs == jdense.fixed_segments(1000, 256)
    with pytest.raises(ValueError):
        fixed_segments(10, 0)


def test_layer_segments_split_and_coalesce():
    tree = {
        "a": np.zeros(10),      # coalesces with b
        "b": np.zeros(20),
        "c": np.zeros(100),     # giant: splits into 40-chunks
        "d": np.zeros(5),
    }
    segs = layer_segments(tree, max_elems=40)
    # full coverage, in flatten order, no overlap
    assert segs[0][0] == 0 and segs[-1][1] == 135
    for (a1, b1), (a2, b2) in zip(segs, segs[1:]):
        assert b1 == a2
    assert all(b - a <= 40 for a, b in segs)
    assert segs == jdense.layer_segments(tree, max_elems=40)


def _bert_tiny_setup(seed=0):
    """(config, port model, its params tree, port loss_fn, flax params) with
    the flax init's weights."""
    jm = jtfm.Transformer(jtfm.tiny_config(causal=False))
    jparams = jax.tree.map(np.asarray, jm.init(jax.random.PRNGKey(seed),
                                               np.zeros((1, 8), np.int32))["params"])
    cfg = tfm.tiny_config(causal=False)
    model = tfm.Transformer(cfg, device="cpu")
    transformer_from_numpy(model, jparams)

    def loss_fn(params, inputs, targets, mask):
        logits = functional_call(model, dict(flat_items(params)), (inputs,))
        return tfm.mlm_loss(logits, targets, mask)

    return cfg, model, params_tree(model), loss_fn, (jm, jparams)


def _mlm_batch_fn(cfg, seed, make=make_mlm_batch):
    rng = np.random.default_rng(seed)

    def fn():
        # a NARROW unigram distribution: masked-token prediction then has
        # learnable structure (entropy log 20 << log vocab), so the loss
        # verifiably falls from its log-vocab starting point
        tokens = rng.integers(1, 20, size=(8, 16))
        return make(tokens, cfg.vocab_size, rng)

    return fn


def _cluster(van, total, num_servers, init_vec, lr=0.1):
    opt = OptimizerConfig(kind="adagrad", learning_rate=lr)
    servers = [
        DenseKVServer(Postoffice(f"S{i}", van), {"model": (total, opt)}, i, num_servers,
                      init_vectors={"model": init_vec}, device="cpu")
        for i in range(num_servers)
    ]
    worker = DenseKVWorker(Postoffice("W0", van), {"model": total}, num_servers,
                           device="cpu")
    return servers, worker


def _run_chunked(chunk_elems, *, van=None, steps=5, jsonl=None, max_delay=0):
    cfg, _model, params, loss_fn, _j = _bert_tiny_setup()
    codec = PytreeCodec(params)
    own_van = van is None
    van = van or LoopbackVan()
    try:
        _servers, worker = _cluster(van, codec.total, 2, codec.flatten(params))
        learner = ChunkedAsyncDenseLearner(
            loss_fn, params, [worker],
            ConsistencyConfig(mode=ConsistencyMode.SSP if max_delay else ConsistencyMode.BSP,
                              max_delay=max_delay),
            chunk_elems=chunk_elems,
            dashboard=metrics_lib.Dashboard(jsonl=jsonl, print_every=0),
            device="cpu",
        )
        losses = learner.run([_mlm_batch_fn(cfg, 7)], steps, timeout=120)
        return losses, learner, worker
    finally:
        if own_van:
            van.close()


def test_segment_push_pull_roundtrip():
    """Segment pulls reassemble exactly what whole-vector pulls see."""
    _cfg, _m, params, _l, _j = _bert_tiny_setup()
    codec = PytreeCodec(params)
    van = LoopbackVan()
    try:
        init = codec.flatten(params)
        _servers, worker = _cluster(van, codec.total, 3, init)
        whole = worker.pull_sync("model", timeout=30).numpy()
        np.testing.assert_array_equal(whole, init)
        out = np.zeros_like(whole)
        for a, b in fixed_segments(codec.total, 1777):  # odd size: spans servers
            ts = worker.pull_segment("model", a, b - a)
            out[a:b] = worker.pull_segment_result(ts, timeout=30).numpy()
        np.testing.assert_array_equal(out, whole)
        # a segment push touches exactly its range
        g = np.ones(500, np.float32)
        worker.wait(worker.push_segment("model", 1000, g), timeout=30)
        after = worker.pull_sync("model", timeout=30).numpy()
        np.testing.assert_array_equal(after[:1000], whole[:1000])
        np.testing.assert_array_equal(after[1500:], whole[1500:])
        assert not np.allclose(after[1000:1500], whole[1000:1500])
    finally:
        van.close()


def test_chunked_matches_monolithic_bert_tiny():
    """BSP chunked (many segments) == single-segment (monolithic) losses."""
    mono, _l1, _w1 = _run_chunked(chunk_elems=1 << 30)  # one segment
    sink = io.StringIO()
    chunked, learner, _worker = _run_chunked(chunk_elems=4096, jsonl=sink)
    assert len(mono) == len(chunked) == 5
    np.testing.assert_allclose(chunked, mono, rtol=1e-4, atol=1e-5)
    # the loss falls (it trains)
    assert chunked[-1] < chunked[0]
    # >= 2 segments genuinely in flight
    assert learner.max_inflight >= 2, learner.max_inflight
    # byte accounting rode the dashboard
    rows = [json.loads(line) for line in sink.getvalue().splitlines()]
    assert all(r["push_mb"] > 0 for r in rows)
    assert all(r["pull_mb"] > 0 for r in rows)
    assert all(r["inflight_max"] >= 2 for r in rows)
    total_mb = PytreeCodec(_bert_tiny_setup()[2]).total * 4 / 1e6
    # each step pushes and pulls the whole vector once, in segments
    assert abs(rows[0]["push_mb"] - total_mb) / total_mb < 0.01


def test_chunked_with_wire_filters():
    """FilterChain (int8 then zlib) on the segment traffic: training still
    converges and the dashboard reports compressed wire bytes."""
    # quantize f32 -> int8 FIRST, then zlib the int8 bytes (zlib over raw
    # float mantissas compresses ~nothing)
    chain = FilterChain([FixingFloatFilter(), CompressingFilter(level=1)])
    van = LoopbackVan(filter_chain=chain)
    sink = io.StringIO()
    try:
        losses, _learner, _worker = _run_chunked(chunk_elems=8192, van=van, steps=5,
                                                 jsonl=sink)
    finally:
        van.close()
    assert np.isfinite(losses).all()
    assert losses[-1] < losses[0]  # int8 wire gradients still train
    rows = [json.loads(line) for line in sink.getvalue().splitlines()]
    assert rows[-1]["wire_mb_total"] > 0
    # int8 + zlib on near-normal gradients: wire bytes well under raw f32
    raw_mb = sum(r["push_mb"] + r["pull_mb"] for r in rows)
    assert rows[-1]["wire_mb_total"] < 0.6 * raw_mb


def test_chunked_ssp_window_two_workers():
    """SSP tau=1 with 2 workers over layer segments: finite, decreasing."""
    cfg, _m, params, loss_fn, _j = _bert_tiny_setup()
    codec = PytreeCodec(params)
    van = LoopbackVan()
    try:
        # two async workers double the update pressure: a calmer lr keeps
        # the tiny model descending instead of oscillating
        opt = OptimizerConfig(kind="adagrad", learning_rate=0.02)
        init_vec = codec.flatten(params)
        _servers = [
            DenseKVServer(Postoffice(f"S{i}", van), {"model": (codec.total, opt)}, i, 2,
                          init_vectors={"model": init_vec}, device="cpu")
            for i in range(2)
        ]
        workers = [DenseKVWorker(Postoffice(f"W{i}", van), {"model": codec.total}, 2,
                                 device="cpu") for i in range(2)]
        learner = ChunkedAsyncDenseLearner(
            loss_fn, params, workers, ConsistencyConfig(mode=ConsistencyMode.SSP, max_delay=1),
            segments=layer_segments(params, max_elems=16384), device="cpu",
        )
        losses = learner.run([_mlm_batch_fn(cfg, 11), _mlm_batch_fn(cfg, 13)], 6, timeout=120)
        assert len(losses) == 12
        assert np.isfinite(losses).all()
        assert np.mean(losses[-3:]) < np.mean(losses[:3])
    finally:
        van.close()


def test_workers_sharing_one_module_do_not_read_each_others_vectors():
    """Four ASP workers over one shared module (``functional_call`` swaps
    its parameters while it runs), thread switches forced every
    microsecond: every worker's gradient must be of its own pulled vector.
    A race shows as autograd's in-place version error (another worker's
    pull overwrote the vector a graph was built on) or as a loss that is
    not the loss of the vector the worker pulled."""
    cfg, _m, params, loss_fn, _j = _bert_tiny_setup()
    codec = PytreeCodec(params)
    seen = []

    def checked_loss(tree, *batch):
        loss = loss_fn(tree, *batch)
        with torch.no_grad():  # the same loss on a private copy of the vector
            again = float(loss_fn(codec.unflatten(codec.flatten_tensor(tree).clone()), *batch))
        seen.append(abs(float(loss.detach()) - again) <= 1e-6 * abs(again))
        return loss

    van = LoopbackVan()
    switch = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        opt = OptimizerConfig(kind="adagrad", learning_rate=0.02)
        _servers = [
            DenseKVServer(Postoffice(f"S{i}", van), {"model": (codec.total, opt)}, i, 2,
                          init_vectors={"model": codec.flatten(params)}, device="cpu")
            for i in range(2)
        ]
        workers = [DenseKVWorker(Postoffice(f"W{i}", van), {"model": codec.total}, 2,
                                 device="cpu") for i in range(4)]
        learner = ChunkedAsyncDenseLearner(
            checked_loss, params, workers, ConsistencyConfig(mode=ConsistencyMode.ASP),
            chunk_elems=8192, device="cpu")
        losses = learner.run([_mlm_batch_fn(cfg, 20 + i) for i in range(4)], 3, timeout=120)
    finally:
        sys.setswitchinterval(switch)
        van.close()
    assert len(losses) == 12 and np.isfinite(losses).all()
    assert len(seen) == 12 and all(seen)


# -- against the JAX learner -------------------------------------------------------


def _jax_run(jm, jparams, segments, steps, lr):
    def loss_fn(params, inputs, targets, mask):
        return jtfm.mlm_loss(jm.apply({"params": params}, inputs), targets, mask)

    codec = jdense.PytreeCodec(jparams)
    van = JaxLoopbackVan()
    try:
        opt = JaxOptimizerConfig(kind="adagrad", learning_rate=lr)
        _servers = [
            jdense.DenseKVServer(JaxPostoffice(f"S{i}", van), {"model": (codec.total, opt)},
                                 i, 2, init_vectors={"model": codec.flatten(jparams)})
            for i in range(2)
        ]
        worker = jdense.DenseKVWorker(JaxPostoffice("W0", van), {"model": codec.total}, 2)
        learner = jlearner.ChunkedAsyncDenseLearner(
            loss_fn, jparams, [worker], JaxConsistencyConfig(mode=JaxConsistencyMode.BSP),
            segments=segments,
        )
        cfg = jtfm.tiny_config(causal=False)
        losses = learner.run([_mlm_batch_fn(cfg, 7, jax_make_mlm_batch)], steps, timeout=120)
        final = worker.pull_sync("model", timeout=30)
        return losses, np.asarray(final), learner
    finally:
        van.close()


@pytest.mark.parametrize("chunks", ["fixed_4096", "layers"])
def test_chunked_bsp_steps_match_the_jax_learner(chunks):
    cfg, _m, params, loss_fn, (jm, jparams) = _bert_tiny_setup()
    codec = PytreeCodec(params)
    segments = (fixed_segments(codec.total, 4096) if chunks == "fixed_4096"
                else layer_segments(params, max_elems=8192))
    assert segments == (jdense.fixed_segments(codec.total, 4096) if chunks == "fixed_4096"
                        else jdense.layer_segments(jparams, max_elems=8192))
    jlosses, jfinal, jlearn = _jax_run(jm, jparams, segments, 5, 0.1)
    van = LoopbackVan()
    try:
        _servers, worker = _cluster(van, codec.total, 2, codec.flatten(params))
        np.testing.assert_array_equal(codec.flatten(params), jlearn.initial_vector())
        learner = ChunkedAsyncDenseLearner(
            loss_fn, params, [worker], ConsistencyConfig(mode=ConsistencyMode.BSP),
            segments=segments, device="cpu",
        )
        losses = learner.run([_mlm_batch_fn(cfg, 7)], 5, timeout=120)
        final = worker.pull_sync("model", timeout=30).numpy()
    finally:
        van.close()
    np.testing.assert_allclose(losses, jlosses, **TRAJ)
    assert losses[-1] < losses[0]
    _assert_final_vectors_agree(jm, jparams, cfg, final, jfinal)


def _assert_final_vectors_agree(jm, jparams, cfg, final, jfinal):
    """The trained vectors, leaf by leaf, against the JAX learner's.

    AdaGrad's step is ``lr * g / sqrt(sum g^2)``: where the gradient is float
    noise the step is too, and the two packages part by up to ``lr``.  Which
    elements carry signal is read off the reference's first gradient
    (``|g| > 1e-6``).  The only leaves with none are the attention key
    biases, whose gradient is zero in exact arithmetic (softmax is
    shift-invariant along the keys).  Every other leaf keeps 99% of its
    elements within 1e-4, and every signal element lies within 1e-3 (a
    small first gradient leaves a later step sensitive to the gradient's
    rounding)."""
    from jax.flatten_util import ravel_pytree

    def loss(params, inputs, targets, mask):
        return jtfm.mlm_loss(jm.apply({"params": params}, inputs), targets, mask)

    first = _mlm_batch_fn(cfg, 7, jax_make_mlm_batch)()
    g0 = np.abs(np.asarray(ravel_pytree(jax.grad(loss)(jparams, *first))[0]))
    diff = np.abs(final - jfinal)
    signal = g0 > 1e-6
    np.testing.assert_array_less(diff[signal], 1e-3)
    noise_leaves, off = [], 0
    for path, leaf in jax.tree_util.tree_flatten_with_path(jparams)[0]:
        name = "/".join(k.key for k in path)
        part = slice(off, off + leaf.size)
        off += leaf.size
        if not signal[part].any():
            noise_leaves.append(name)
            continue
        close = np.mean(diff[part] <= 1e-4)
        assert close >= 0.99, f"{name}: {close:.4f} of its elements within 1e-4"
    assert off == final.size
    assert noise_leaves == [f"layer_{i}/attn/k/bias" for i in range(cfg.n_layers)]


def test_segments_must_cover_the_vector():
    _cfg, _m, params, loss_fn, _j = _bert_tiny_setup()
    total = PytreeCodec(params).total
    with pytest.raises(ValueError, match="cover the full parameter vector"):
        ChunkedAsyncDenseLearner(loss_fn, params, [], ConsistencyConfig(),
                                 segments=[(0, total - 1)], device="cpu")
