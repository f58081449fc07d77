"""The port's dense plane (BASELINE config #2) against the JAX package's, on
the CPU: ResNet, the flat codec, the dense KV store and the dense learners.

Weights start from the JAX model's init, carried into the port with
``convert.resnet_from_numpy``; inputs are seeded numpy.  Tolerances: host
code (codec vectors, segments, offsets) bit for bit; a forward pass, its flat
gradient and the BatchNorm-statistics update ``rtol=1e-4, atol=1e-5``;
multi-step learner trajectories within 1e-4.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.flatten_util import ravel_pytree

from parameter_server_tpu.config import ConsistencyConfig as JaxConsistencyConfig
from parameter_server_tpu.config import ConsistencyMode as JaxConsistencyMode
from parameter_server_tpu.config import OptimizerConfig as JaxOptimizerConfig
from parameter_server_tpu.core.postoffice import Postoffice as JaxPostoffice
from parameter_server_tpu.core.van import LoopbackVan as JaxLoopbackVan
from parameter_server_tpu.kv import dense as jdense
from parameter_server_tpu.learner import dense as jlearner
from parameter_server_tpu.models import resnet as jresnet
from parameter_server_tpu.parallel import mesh as mesh_lib
from parameter_server_tpu_torch.config import (
    ConsistencyConfig,
    ConsistencyMode,
    OptimizerConfig,
)
from parameter_server_tpu_torch.convert import resnet_from_numpy
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.kv.dense import (
    DenseKVServer,
    DenseKVWorker,
    PytreeCodec,
    fixed_segments,
    layer_segments,
    segment_offsets,
)
from parameter_server_tpu_torch.learner.dense import (
    AsyncDenseLearner,
    SpmdDenseTrainer,
    softmax_xent,
)
from parameter_server_tpu_torch.models import resnet
from parameter_server_tpu_torch.models.layers import params_tree

FWD = dict(rtol=1e-4, atol=1e-5)
TRAJ = dict(rtol=1e-4, atol=1e-4)

#: (flax model, port model, image size): a BasicBlock small-inputs net and a
#: BottleneckBlock net with the 7x7/2 stem and the max-pool, where every
#: "SAME" pad of a stride-2 window is asymmetric
NETS = {
    "basic_small": (lambda: jresnet.ResNet(stage_sizes=[1, 1], num_classes=10, width=8,
                                           bottleneck=False, small_inputs=True),
                    lambda: resnet.ResNet([1, 1], num_classes=10, width=8,
                                          bottleneck=False, small_inputs=True), 16),
    "bottleneck_stem": (lambda: jresnet.ResNet(stage_sizes=[1, 1], num_classes=10, width=8,
                                               bottleneck=True),
                        lambda: resnet.ResNet([1, 1], num_classes=10, width=8,
                                              bottleneck=True), 32),
}


def _batch(rng, n=16, hw=16, num_classes=10):
    images = rng.normal(size=(n, hw, hw, 3)).astype(np.float32)
    labels = rng.integers(0, num_classes, size=n).astype(np.int32)
    return images, labels


def _np(tree):
    return jax.tree.map(np.asarray, tree)


@functools.lru_cache(maxsize=None)
def _flax_variables(name, seed=0):
    """flax init of net ``name`` (jitted: eager init is slow on the CPU);
    the params depend on the image shape only, not on its values."""
    jnet, _pnet, hw = NETS[name]
    init = jax.jit(functools.partial(jnet().init, train=False))
    return init(jax.random.PRNGKey(seed), jnp.zeros((1, hw, hw, 3), jnp.float32))


class _CachedInit:
    """A flax net whose ``init`` returns the cached jitted init of ``_init``
    (the JAX learners init eagerly, which is slow on the CPU); ``apply`` is
    the net's own."""

    def __init__(self, name):
        self.name, self.net = name, NETS[name][0]()

    def init(self, key, images, train):
        assert not train and np.array_equal(np.asarray(key), np.asarray(jax.random.PRNGKey(0)))
        return _flax_variables(self.name)

    def apply(self, *args, **kw):
        return self.net.apply(*args, **kw)


def _init(name, seed=0):
    """The flax model and variables of net ``name``, and the port model
    loaded with them."""
    jnet, pnet, _hw = NETS[name]
    variables = _flax_variables(name, seed)
    ours = pnet()
    resnet_from_numpy(ours, _np(variables["params"]), _np(variables["batch_stats"]))
    return jnet(), variables, ours


def test_same_pads_are_flax_s():
    assert resnet.same_pads(224, 7, 2) == (2, 3)  # the stem
    assert resnet.same_pads(112, 3, 2) == (0, 1)  # the max-pool
    for n in (56, 28, 14):
        assert resnet.same_pads(n, 3, 2) == (0, 1)
        assert resnet.same_pads(n, 1, 2) == (0, 0)
    assert resnet.same_pads(56, 3, 1) == (1, 1)
    assert resnet.same_pads(7, 3, 2) == (1, 1)


@pytest.fixture(scope="module")
def r50():
    """flax ResNet-50's params and batch_stats shapes (parameter shapes do not
    depend on the image size: traced at 32 x 32) and the port's ResNet-50."""
    model = jresnet.resnet50(num_classes=1000)
    shapes = jax.eval_shape(lambda: model.init(jax.random.PRNGKey(0),
                                               jnp.zeros((1, 32, 32, 3)), train=False))
    return shapes, resnet.resnet50(num_classes=1000, generator=torch.Generator().manual_seed(1))


def _paths(tree):
    return {".".join(k.key for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(tree)[0]}


def test_port_resnet50_has_flax_s_tree_and_init_rules(r50):
    shapes, ours = r50
    assert {n: tuple(p.shape) for n, p in ours.named_parameters()} == {
        n: tuple(v.shape) for n, v in _paths(shapes["params"]).items()}
    assert {n: tuple(b.shape) for n, b in ours.named_buffers()} == {
        n: tuple(v.shape) for n, v in _paths(shapes["batch_stats"]).items()}
    assert float(ours.BottleneckBlock_0.BatchNorm_2.scale.detach().abs().max()) == 0.0
    assert float(ours.BottleneckBlock_0.BatchNorm_0.scale.detach().min()) == 1.0
    k = ours.stem.kernel.detach().numpy()
    assert abs(k.var() * 7 * 7 * 3 - 1.0) < 0.05
    assert np.abs(k).max() <= 2.0 / 0.87962566103423978 / np.sqrt(7 * 7 * 3) + 1e-7


def test_resnet50_codec_is_ravel_pytree(r50):
    """25.5-25.7 M elements, as the JAX package's count; the flat vector is
    ``ravel_pytree`` of the same tree bit for bit, leaves in jax.tree order."""
    shapes, ours = r50
    rng = np.random.default_rng(8)
    params = jax.tree.map(lambda s: rng.normal(size=s.shape).astype(np.float32),
                          shapes["params"])
    stats = jax.tree.map(lambda s: rng.uniform(size=s.shape).astype(np.float32),
                         shapes["batch_stats"])
    resnet_from_numpy(ours, params, stats)
    codec = PytreeCodec(params_tree(ours))
    want = np.asarray(ravel_pytree(params)[0])
    assert 25_500_000 < codec.total == want.size < 25_700_000
    assert np.array_equal(codec.flatten(params_tree(ours)), want)
    assert [p for p, _ in codec.leaves][:2] == ["BottleneckBlock_0.BatchNorm_0.bias",
                                               "BottleneckBlock_0.BatchNorm_0.scale"]
    # BottleneckBlock_10 sorts before BottleneckBlock_2, as in jax.tree
    blocks = list(dict.fromkeys(p.split(".")[0] for p, _ in codec.leaves))
    assert blocks.index("BottleneckBlock_10") < blocks.index("BottleneckBlock_2")
    assert layer_segments(params_tree(ours)) == jdense.layer_segments(params)
    assert np.array_equal(dict(ours.named_buffers())["stem_bn.var"],
                          stats["stem_bn"]["var"])


@pytest.mark.parametrize("name", sorted(NETS))
def test_tiny_resnet_forward_gradient_and_bn_stats_match_flax(name):
    hw = NETS[name][2]
    images, labels = _batch(np.random.default_rng(3), n=8, hw=hw)
    model, variables, ours = _init(name)
    params, stats = variables["params"], variables["batch_stats"]

    def loss(p):
        out, new = model.apply({"params": p, "batch_stats": stats}, images, train=True,
                               mutable=["batch_stats"])
        return jlearner.softmax_xent(out, labels), (out, new)

    (jl, (jout, jnew)), jg = jax.jit(jax.value_and_grad(loss, has_aux=True))(params)
    ours.train()
    out = ours(torch.from_numpy(images))
    l = softmax_xent(out, torch.from_numpy(labels))
    l.backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), **FWD)
    np.testing.assert_allclose(float(l.detach()), float(jl), **FWD)
    codec = PytreeCodec(params_tree(ours))
    np.testing.assert_allclose(codec.flatten(params_tree(ours, grads=True)),
                               np.asarray(ravel_pytree(jg)[0]), **FWD)
    got_stats = {n: b.numpy() for n, b in ours.named_buffers()}
    for path, want in jax.tree_util.tree_flatten_with_path(jnew["batch_stats"])[0]:
        np.testing.assert_allclose(got_stats[".".join(k.key for k in path)],
                                   np.asarray(want), **FWD)
    # evaluation mode reads the running statistics
    ours.eval()
    with torch.no_grad():
        ev = ours(torch.from_numpy(images)).numpy()
    want = jax.jit(functools.partial(model.apply, train=False))(
        {"params": params, "batch_stats": jnew["batch_stats"]}, images)
    np.testing.assert_allclose(ev, np.asarray(want), **FWD)


def test_codec_roundtrip_and_segments_match_jax():
    _model, variables, ours = _init("basic_small")
    codec = PytreeCodec(params_tree(ours))
    jcodec = jdense.PytreeCodec(variables["params"])
    vec = codec.flatten(params_tree(ours))
    assert codec.total == jcodec.total and np.array_equal(vec, jcodec.flatten(
        variables["params"]))
    back = codec.unflatten(vec + 1.0)
    assert np.array_equal(codec.flatten(back), vec + 1.0)
    for max_elems in (1 << 22, 500, 64):
        assert (layer_segments(params_tree(ours), max_elems)
                == jdense.layer_segments(variables["params"], max_elems))
    for chunk in (1, 1777, codec.total, codec.total + 5):
        assert fixed_segments(codec.total, chunk) == jdense.fixed_segments(codec.total, chunk)
    with pytest.raises(ValueError):
        fixed_segments(10, 0)
    for total, n in ((10, 3), (codec.total, 2), (7, 7)):
        assert np.array_equal(segment_offsets(total, n), jdense.segment_offsets(total, n))
    with pytest.raises(ValueError):
        codec.unflatten(vec[:-1])


def _cluster(van, total, num_servers, init_vec, opt=None):
    opt = opt or OptimizerConfig(kind="sgd", learning_rate=0.1)
    servers = [DenseKVServer(Postoffice(f"S{i}", van), {"model": (total, opt)}, i,
                             num_servers, init_vectors={"model": init_vec}, device="cpu")
               for i in range(num_servers)]
    worker = DenseKVWorker(Postoffice("W0", van), {"model": total}, num_servers,
                           device="cpu")
    return servers, worker


def test_segment_push_pull_roundtrip():
    """The port's twin of ``tests/test_chunked_dense.py::
    test_segment_push_pull_roundtrip``, on the tiny ResNet's params."""
    _m, _v, ours = _init("basic_small")
    codec = PytreeCodec(params_tree(ours))
    init = codec.flatten(params_tree(ours))
    van = LoopbackVan()
    try:
        servers, worker = _cluster(van, codec.total, 3, init)
        assert servers[0].device == torch.device("cpu")
        whole = worker.pull_sync("model", timeout=30).numpy()
        assert np.array_equal(whole, init)
        out = np.zeros_like(whole)
        for a, b in fixed_segments(codec.total, 1777):  # odd size: spans servers
            ts = worker.pull_segment("model", a, b - a)
            out[a:b] = worker.pull_segment_result(ts, timeout=30).numpy()
        assert np.array_equal(out, whole)
        assert worker.bytes_pulled == whole.nbytes
        # a segment push touches exactly its range
        g = np.ones(500, np.float32)
        worker.wait(worker.push_segment("model", 1000, g), timeout=30)
        after = worker.pull_sync("model", timeout=30).numpy()
        assert np.array_equal(after[:1000], whole[:1000])
        assert np.array_equal(after[1500:], whole[1500:])
        np.testing.assert_allclose(after[1000:1500], whole[1000:1500] - 0.1, rtol=1e-6)
        # a whole-vector push (a tensor) applies SGD everywhere
        worker.wait(worker.push("model", torch.ones(codec.total)), timeout=30)
        again = worker.pull_sync("model", timeout=30).numpy()
        np.testing.assert_allclose(again, after - 0.1, rtol=1e-6, atol=1e-7)
        assert worker.bytes_pushed == 500 * 4 + codec.total * 4
    finally:
        van.close()


def test_dense_server_matches_jax_under_adam():
    """Whole-vector and segment pushes and pulls against the JAX server's."""
    rng = np.random.default_rng(4)
    total = 1000
    init = rng.normal(size=total).astype(np.float32)
    opt = dict(kind="adam", learning_rate=0.01)
    van, jvan = LoopbackVan(), JaxLoopbackVan()
    try:
        _s, worker = _cluster(van, total, 2, init, OptimizerConfig(**opt))
        _js = [jdense.DenseKVServer(JaxPostoffice(f"S{i}", jvan),
                                    {"model": (total, JaxOptimizerConfig(**opt))}, i, 2,
                                    init_vectors={"model": init}) for i in range(2)]
        jworker = jdense.DenseKVWorker(JaxPostoffice("W0", jvan), {"model": total}, 2)
        for k in range(3):
            g = rng.normal(size=total).astype(np.float32)
            worker.wait(worker.push("model", g), 30)
            jworker.wait(jworker.push("model", g), 30)
            seg = rng.normal(size=300).astype(np.float32)
            worker.wait(worker.push_segment("model", 350 + k, seg), 30)
            jworker.wait(jworker.push_segment("model", 350 + k, seg), 30)
        got = worker.pull_sync("model", 30).numpy()
        np.testing.assert_allclose(got, jworker.pull_sync("model", 30), rtol=1e-5, atol=1e-6)
        ts, jts = worker.pull_segment("model", 480, 40), jworker.pull_segment("model", 480, 40)
        np.testing.assert_allclose(worker.pull_segment_result(ts, 30).numpy(),
                                   jworker.pull_segment_result(jts, 30), rtol=1e-5, atol=1e-6)
    finally:
        van.close()
        jvan.close()


def test_dense_server_refuses_control_ops_and_bad_ranges():
    from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind

    van = LoopbackVan()
    try:
        (server, _s1), worker = _cluster(van, 10, 2, np.zeros(10, np.float32))
        # the dense store takes save_model / load_model only (as the JAX
        # one): a snapshot op is refused
        ts = worker.submit([Message(task=Task(TaskKind.CONTROL, "dense",
                                              payload={"op": "snap_begin"}),
                                    recver="S0")], keep_responses=True)
        assert worker.wait(ts, 30)
        assert any("unsupported control op 'snap_begin'" in e for e in worker.errors(ts))
        worker.take_responses(ts)
        for payload, n in (({"table": "model", "offset": 3}, 4),  # past S0's 5 rows
                           ({"table": "model"}, 4)):  # a whole push of the wrong size
            msg = Message(task=Task(TaskKind.PUSH, "dense", payload=payload), recver="S0",
                          values=[np.ones(n, np.float32)])
            with pytest.raises(ValueError):
                server.handle_request(msg)
        assert float(server.segments["model"]["value"].abs().max()) == 0.0
    finally:
        van.close()


def _jax_learner_run(jmodel, variables, batches, steps, n_workers, mode, lr):
    van = JaxLoopbackVan()
    try:
        codec = jdense.PytreeCodec(variables["params"])
        workers = [jdense.DenseKVWorker(JaxPostoffice(f"W{i}", van), {"model": codec.total}, 2)
                   for i in range(n_workers)]
        learner = jlearner.AsyncDenseLearner(
            jmodel, workers, JaxConsistencyConfig(mode=mode), batches[0])
        servers = [jdense.DenseKVServer(
            JaxPostoffice(f"S{i}", van),
            {"model": (codec.total, JaxOptimizerConfig(kind="sgd", learning_rate=lr))}, i, 2,
            init_vectors={"model": learner.initial_vector()}) for i in range(2)]
        losses = learner.run([lambda b=b: b for b in batches], steps_per_worker=steps)
        return losses, workers[0].pull_sync("model", 30), servers
    finally:
        van.close()


def _port_learner(ours, n_workers, mode, lr, van):
    total = PytreeCodec(params_tree(ours)).total
    workers = [DenseKVWorker(Postoffice(f"W{i}", van), {"model": total}, 2, device="cpu")
               for i in range(n_workers)]
    learner = AsyncDenseLearner(ours, workers, ConsistencyConfig(mode=mode), device="cpu")
    servers = [DenseKVServer(Postoffice(f"S{i}", van),
                             {"model": (total, OptimizerConfig(kind="sgd", learning_rate=lr))},
                             i, 2, init_vectors={"model": learner.initial_vector()},
                             device="cpu") for i in range(2)]
    return learner, workers, servers


def test_async_dense_learner_matches_jax():
    """1 worker x 2 servers, 3 steps on one fixed batch: losses and the
    servers' vector within 1e-4; the init vectors bit for bit."""
    batch = _batch(np.random.default_rng(5), n=16)
    _m, variables, ours = _init("basic_small")
    jlosses, jvec, _ = _jax_learner_run(_CachedInit("basic_small"), variables, [batch], 3, 1,
                                        JaxConsistencyMode.BSP, 0.3)
    van = LoopbackVan()
    try:
        learner, workers, _s = _port_learner(ours, 1, ConsistencyMode.BSP, 0.3, van)
        assert np.array_equal(learner.initial_vector(),
                              np.asarray(ravel_pytree(variables["params"])[0]))
        losses = learner.run([lambda: batch], steps_per_worker=3)
        vec = workers[0].pull_sync("model", 30).numpy()
    finally:
        van.close()
    np.testing.assert_allclose(losses, jlosses, **TRAJ)
    np.testing.assert_allclose(vec, jvec, **TRAJ)


def test_async_dense_learner_bsp():
    """The port's twin of ``tests/test_resnet_dense.py::test_async_dense_learner_bsp``:
    2 workers x 2 servers under BSP, each memorising a fixed batch."""
    _m, _v, ours = _init("basic_small")
    van = LoopbackVan()
    try:
        learner, _w, _s = _port_learner(ours, 2, ConsistencyMode.BSP, 0.3, van)
        fixed = [_batch(np.random.default_rng(10 + i), n=16) for i in range(2)]
        losses = learner.run([lambda b=b: b for b in fixed], steps_per_worker=8)
    finally:
        van.close()
    assert len(losses) == 16
    assert np.mean(losses[-4:]) < np.mean(losses[:4]) - 0.1, losses
    # BatchNorm statistics stayed local: the two replicas saw different batches
    a, b = (dict(r.named_buffers()) for r in learner.replicas)
    assert not torch.equal(a["stem_bn.mean"], b["stem_bn.mean"])


def test_spmd_dense_trainer_matches_jax():
    """3 steps of SGD with momentum 0.9 from one init: losses within 1e-4."""
    batch = _batch(np.random.default_rng(6), n=16)
    _m, variables, ours = _init("basic_small")
    jtr = jlearner.SpmdDenseTrainer(_CachedInit("basic_small"), optax.sgd(0.3, momentum=0.9),
                                    mesh_lib.make_mesh((1, 1), devices=jax.devices()[:1]),
                                    batch)
    # the JAX trainer inits from PRNGKey(0), as ``_init`` did
    assert np.array_equal(np.asarray(ravel_pytree(jtr.params)[0]),
                          np.asarray(ravel_pytree(variables["params"])[0]))
    tr = SpmdDenseTrainer(ours, functools.partial(torch.optim.SGD, lr=0.3, momentum=0.9),
                          device="cpu")
    want = [jtr.step(*batch) for _ in range(3)]
    got = [tr.step(*batch) for _ in range(3)]
    np.testing.assert_allclose(got, want, **TRAJ)
    np.testing.assert_allclose(tr.eval_logits(batch[0][:4]),
                               jtr.eval_logits(batch[0][:4]), **TRAJ)


def test_spmd_dense_trainer_learns():
    """The port's twin of ``tests/test_resnet_dense.py::test_spmd_dense_trainer_learns``."""
    batch = _batch(np.random.default_rng(0), n=16)
    tr = SpmdDenseTrainer(NETS["basic_small"][1](),
                          functools.partial(torch.optim.SGD, lr=0.3, momentum=0.9),
                          device="cpu")
    losses = [tr.step(*batch) for _ in range(30)]
    assert losses[-1] < losses[0] - 0.5, losses[::10]
    assert tr.step_count == 30


def test_softmax_xent_matches_jax():
    rng = np.random.default_rng(7)
    logits = rng.normal(size=(9, 5)).astype(np.float32)
    labels = rng.integers(0, 5, size=9).astype(np.int32)
    np.testing.assert_allclose(
        float(softmax_xent(torch.from_numpy(logits), torch.from_numpy(labels))),
        float(jlearner.softmax_xent(jnp.asarray(logits), jnp.asarray(labels))), rtol=1e-6)


def test_spmd_dense_trainer_mfu_counts_convs_and_executes_nothing(monkeypatch):
    """The dense trainer's MFU numerator is the flop count of its step on
    ``meta`` copies (convolutions and the head, forward and backward); the
    count never runs on the live model, so the losses are bitwise those of a
    trainer that does not count; the math mode is the convolutions' (TF32
    under torch's defaults).  The ratio to the JAX trainer's XLA count is
    reported, and held only to a broad band: the two count convolutions
    differently (the flop counter charges every output position the full
    kernel, padding included), and XLA counts the elementwise ops too."""
    from parameter_server_tpu_torch.utils import metrics as metrics_lib

    batch = _batch(np.random.default_rng(8), n=16)
    _m, variables, ours = _init("basic_small")
    _m2, _v2, twin = _init("basic_small")
    # a fresh flax net, not the cached init: a JAX trainer donates the
    # params it was handed, and an earlier test's may have been the cache's
    jtr = jlearner.SpmdDenseTrainer(NETS["basic_small"][0](), optax.sgd(0.3, momentum=0.9),
                                    mesh_lib.make_mesh((1, 1), devices=jax.devices()[:1]),
                                    batch)
    sgd = functools.partial(torch.optim.SGD, lr=0.3, momentum=0.9)
    tr = SpmdDenseTrainer(ours, sgd, device="cpu")
    quiet = SpmdDenseTrainer(twin, sgd, device="cpu")
    got = [tr.step(*batch) for _ in range(3)]
    monkeypatch.setattr(metrics_lib, "counted_flops_by_kind",
                        lambda *a, **k: {"conv": 0.0, "matmul": 0.0})
    want = [quiet.step(*batch) for _ in range(3)]
    assert got == want  # bitwise
    for a, b in zip(tr.model.state_dict().values(), quiet.model.state_dict().values()):
        assert torch.equal(a, b)
    per_example = tr.dashboard.flops_per_example
    assert per_example > 0
    assert tr.dashboard.precision == metrics_lib.float32_math_mode("conv")
    ratio = per_example / jtr.dashboard.flops_per_example
    print(f"ResNet basic_small flops/example: port {per_example:.0f}, "
          f"JAX lowered {jtr.dashboard.flops_per_example:.0f}, ratio {ratio:.4f}")
    assert 0.25 < ratio < 4.0
