"""The port's hybrid LM trainer (BASELINE config #5) against the JAX
package's, on the CPU: PS-served embeddings over real KVWorker / KVServer
traffic, a dense body trained on one device.

Twins of ``tests/test_hybrid.py``'s cases, the hybrid half of
``test_lm_scale_knobs.py``'s chunked-loss case, and the cross-package
checks: 4 steps from the JAX trainer's body weights and the JAX servers'
table rows (losses ``rtol=1e-4, atol=1e-4``, tables ``rtol=1e-5,
atol=1e-5``), and a JAX-written checkpoint resumed by the port (losses
``rtol=1e-4, atol=1e-4``).  The mesh cases run the trainer on an 8-rank
gloo world (``tests/torch_world.py``), each data line's Van rank over its
own LoopbackVan cluster with the same seeded tables (the dual-plane file
shares one cluster over sockets): the multi-process branch pushes once a
data line, and the body's gradients are all-reduced over ``data`` in each
step; the first step's loss equals one device's (rtol 1e-5).
"""

import io
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch

from parameter_server_tpu.core.postoffice import Postoffice as JaxPostoffice
from parameter_server_tpu.core.van import LoopbackVan as JaxLoopbackVan
from parameter_server_tpu.kv.server import KVServer as JaxKVServer
from parameter_server_tpu.kv.worker import KVWorker as JaxKVWorker
from parameter_server_tpu.learner import hybrid as jhybrid
from parameter_server_tpu.models import transformer as jtfm
from parameter_server_tpu.parallel import mesh as mesh_lib
from parameter_server_tpu_torch.convert import shard_from_numpy, transformer_from_numpy
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.learner import hybrid
from parameter_server_tpu_torch.models import transformer as tfm
from parameter_server_tpu_torch.models.layers import flat_items, params_tree
from parameter_server_tpu_torch.utils import metrics as metrics_lib
from parameter_server_tpu_torch.utils.keys import PAD_KEY, IdentityLocalizer
from parameter_server_tpu_torch.utils.trace import Tracer

import torch_world

NUM_SERVERS = 2
TRAJ = dict(rtol=1e-4, atol=1e-4)
TABLE = dict(rtol=1e-5, atol=1e-5)


def _cfg(pkg=tfm, **kw):
    return pkg.tiny_config(causal=True, tie_embeddings=False, **kw)


def _tokens(cfg, rng, batch=8, seq=16):
    # structured stream (periodic patterns) so a tiny model can learn it
    base = rng.integers(0, cfg.vocab_size, size=(batch, 1))
    offs = np.arange(seq)[None, :]
    return ((base + offs) % cfg.vocab_size).astype(np.int32)


def _close(van, servers):
    van.close()
    for s in servers:
        if s.ledger is not None:
            s.ledger.close()


def _hybrid_cluster(van, cfg, *, device_replies=False, lr=0.1):
    table_cfgs = {"emb": hybrid.embedding_table_cfg(cfg, learning_rate=lr)}
    servers = [KVServer(Postoffice(f"S{s}", van), table_cfgs, s, NUM_SERVERS,
                        device_replies=device_replies, device="cpu")
               for s in range(NUM_SERVERS)]
    worker = KVWorker(Postoffice("W0", van), table_cfgs, NUM_SERVERS,
                      localizers=hybrid.embedding_localizers(cfg), device="cpu")
    return servers, worker


@pytest.fixture(scope="module")
def world():
    w = torch_world.World(8)
    yield w
    w.close()


@pytest.fixture
def cluster():
    van = LoopbackVan()
    cfg = _cfg()
    servers, worker = _hybrid_cluster(van, cfg)
    try:
        yield cfg, van, servers, worker
    finally:
        _close(van, servers)


def _trainer(cfg, worker, **kw):
    return hybrid.HybridLMTrainer(cfg, worker, device="cpu", **kw)


# -- twins of tests/test_hybrid.py --------------------------------------------------


def test_hybrid_trains_and_routes_embeddings_via_van(cluster):
    cfg, van, servers, worker = cluster
    trainer = _trainer(cfg, worker, learning_rate=3e-3, max_delay=0)
    rng = np.random.default_rng(0)
    losses = [trainer.step(_tokens(cfg, rng)) for _ in range(12)]
    trainer.drain()
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses
    # embedding traffic went through the Van to BOTH range shards
    assert all(s.pushes > 0 and s.pulls > 0 for s in servers)
    assert van.sent_messages > 0
    # and the PS table learned (moved off its init)
    t0 = servers[0].tables["emb"]
    assert float(t0.state["sum_sq"][:-1].abs().sum()) > 0


def test_hybrid_ssp_bounded_delay(cluster):
    """max_delay=tau keeps at most tau embedding pushes un-acked (SSP)."""
    cfg, van, servers, worker = cluster
    trainer = _trainer(cfg, worker, learning_rate=3e-3, max_delay=3)
    rng = np.random.default_rng(2)
    losses = [trainer.step(_tokens(cfg, rng)) for _ in range(10)]
    assert len(trainer._inflight) <= 3
    trainer.drain()
    assert not trainer._inflight
    assert np.all(np.isfinite(losses))
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_hybrid_rejects_tied_embeddings():
    with pytest.raises(ValueError, match="untied"):
        hybrid.HybridLMTrainer(tfm.tiny_config(causal=True, tie_embeddings=True), None,
                               device="cpu")


def test_identity_localizer_contract():
    loc = IdentityLocalizer(100)
    out = loc.assign(np.array([0, 5, 99, PAD_KEY], dtype=np.uint64))
    assert out.tolist() == [0, 5, 99, 100]
    with pytest.raises(ValueError, match="outside"):
        loc.assign(np.array([150], dtype=np.uint64))


def test_hybrid_device_resident_plane_matches_host_plane():
    """device_replies + push_device == the numpy plane, loss for loss."""
    cfg = _cfg()
    losses = {}
    for mode in (False, True):
        van = LoopbackVan()
        servers, worker = _hybrid_cluster(van, cfg, device_replies=mode)
        try:
            tr = _trainer(cfg, worker, learning_rate=1e-2, max_delay=0, seed=3)
            rng = np.random.default_rng(5)
            losses[mode] = [tr.step(_tokens(cfg, rng)) for _ in range(4)]
            tr.drain()
        finally:
            _close(van, servers)
    np.testing.assert_allclose(losses[True], losses[False], rtol=1e-4)
    assert losses[True][-1] < losses[True][0]


def test_hybrid_pull_replies_are_device_tensors():
    """With device_replies the Van reply payloads are tensors on the
    server's device (no host copy), and a device push round-trips."""
    cfg = _cfg()
    van = LoopbackVan()
    servers, worker = _hybrid_cluster(van, cfg, device_replies=True)
    try:
        keys = np.arange(12, dtype=np.uint64).reshape(3, 4)
        ts = worker.pull("emb", keys)
        replies = []
        orig = worker._pull_pairs

        def spy(ts, timeout):
            plan, pairs = orig(ts, timeout)
            replies.extend(rows for _pos, rows, *_m in pairs)
            return plan, pairs

        worker._pull_pairs = spy
        out = worker.pull_result_device(ts, timeout=30)
        assert replies and all(isinstance(r, torch.Tensor) for r in replies)
        assert tuple(out.shape) == (3, 4, cfg.d_model)
        g = torch.ones((12, cfg.d_model))
        worker.wait(worker.push_device("emb", keys.reshape(-1), g), timeout=30)
        after = worker.pull_result_device(worker.pull("emb", keys), timeout=30)
        assert not torch.allclose(after, out)
    finally:
        _close(van, servers)


class _DelayVan(LoopbackVan):
    """Loopback with a concurrent, timer-delivered reply delay (a fake
    network round trip)."""

    def __init__(self, reply_delay_s: float):
        super().__init__()
        self.reply_delay_s = reply_delay_s

    def send(self, msg):
        if not msg.is_request:  # delay replies: worker-visible Van latency
            t = threading.Timer(self.reply_delay_s, lambda: LoopbackVan.send(self, msg))
            t.daemon = True
            t.start()
            return True
        return super().send(msg)


def test_hybrid_prefetch_hides_pull_latency():
    """Announced next_tokens hide the pull's Van latency behind the body
    step (>= 50% hidden against the synchronous pull).  The tiny CPU body
    takes milliseconds, so a sleep between steps stands for a long body
    step; RTT 0.2 s against a 0.3 s step."""
    cfg = _cfg()
    delay = 0.2

    def run(prefetch: bool) -> float:
        van = _DelayVan(delay)
        servers, worker = _hybrid_cluster(van, cfg, device_replies=True)
        try:
            tracer = Tracer()
            tr = _trainer(cfg, worker, learning_rate=1e-2, max_delay=2, tracer=tracer)
            rng = np.random.default_rng(9)
            batches = [_tokens(cfg, rng, batch=16, seq=32) for _ in range(6)]
            for i, b in enumerate(batches):
                nxt = batches[i + 1] if prefetch and i + 1 < len(batches) else None
                tr.step(b, next_tokens=nxt)
                if i + 1 < len(batches):
                    time.sleep(0.3)  # the emulated long body step
            tr.drain()
            waits = [s[2] for s in tracer.spans("hybrid.pull_wait")]
            return float(np.mean(waits[1:]))  # step 0 is never prefetched
        finally:
            _close(van, servers)

    sync_wait = run(prefetch=False)
    prefetched_wait = run(prefetch=True)
    if prefetched_wait >= 0.5 * sync_wait:
        # one retry: a GC pause or a neighbouring test can inflate one run
        sync_wait = run(prefetch=False)
        prefetched_wait = run(prefetch=True)
    assert sync_wait > delay * 0.9  # the synthetic RTT is visible
    assert prefetched_wait < 0.5 * sync_wait, (sync_wait, prefetched_wait)


def test_hybrid_dashboard_reports_mfu(cluster):
    cfg, _van, _servers, worker = cluster
    sink = io.StringIO()
    tr = _trainer(cfg, worker, dashboard=metrics_lib.Dashboard(jsonl=sink, print_every=0))
    tr.step(_tokens(cfg, np.random.default_rng(1)))
    tr.drain()
    row = json.loads(sink.getvalue().splitlines()[0])
    assert row["mfu_pct"] > 0
    assert row["emb_plane_mb"] == round(8 * 16 * cfg.d_model * 4 * 2 / 1e6, 3)
    assert tr.dashboard.flops_per_example == 6.0 * tr.n_body_params * 16


def test_hybrid_checkpoint_resume_continues_exactly(tmp_path):
    """The checkpoint covers both planes (PS shards + body params / AdamW):
    a fresh cluster restored at step k replays the uninterrupted run's
    suffix loss for loss."""
    root = str(tmp_path / "hybrid_ckpt")
    cfg = _cfg()
    rng = np.random.default_rng(12)
    batches = [_tokens(cfg, rng) for _ in range(6)]

    def fresh():
        van = LoopbackVan()
        servers, worker = _hybrid_cluster(van, cfg)
        return van, servers, _trainer(cfg, worker, learning_rate=1e-2, max_delay=0, seed=7)

    van, servers, tr = fresh()
    try:
        for b in batches[:3]:
            tr.step(b)
        tr.save(root, step=3)
        tail_ref = [tr.step(b) for b in batches[3:]]
        tr.drain()
    finally:
        _close(van, servers)
    # fresh everything (server tables and body re-initialised), restore, resume
    van, servers, tr2 = fresh()
    try:
        tr2.restore(root, step=3)
        tail = [tr2.step(b) for b in batches[3:]]
        tr2.drain()
    finally:
        _close(van, servers)
    np.testing.assert_allclose(tail, tail_ref, rtol=1e-6, atol=1e-7)


def test_hybrid_chunked_loss_matches_plain():
    """The hybrid half of test_lm_scale_knobs.py:64."""
    cfg = _cfg(n_heads=4, n_kv_heads=4)
    rng = np.random.default_rng(4)
    batches = [rng.integers(0, cfg.vocab_size, size=(8, 16)).astype(np.int32)
               for _ in range(3)]

    def run(loss_chunk):
        van = LoopbackVan()
        servers, worker = _hybrid_cluster(van, cfg, lr=0.05)
        try:
            tr = _trainer(cfg, worker, learning_rate=1e-2, seed=5, loss_chunk=loss_chunk)
            out = [tr.step(b) for b in batches]
            tr.drain()
            return out
        finally:
            _close(van, servers)

    np.testing.assert_allclose(run(0), run(4), rtol=2e-4, atol=1e-5)


# -- push before prefetch -------------------------------------------------------------


def test_prefetched_rows_include_this_steps_push():
    """Per-link FIFO with the push sent before the prefetch pull: a run
    that prefetches every step equals one that pulls every step, bitwise
    (losses and table).  Issuing the prefetch first would hand the next
    step rows one update stale and break the equality."""
    cfg = _cfg()
    rng = np.random.default_rng(21)
    batches = [_tokens(cfg, rng) for _ in range(5)]

    def run(prefetch):
        van = LoopbackVan()
        servers, worker = _hybrid_cluster(van, cfg, device_replies=True)
        try:
            tr = _trainer(cfg, worker, learning_rate=1e-2, max_delay=0, seed=2)
            losses = []
            for i, b in enumerate(batches):
                nxt = batches[i + 1] if prefetch and i + 1 < len(batches) else None
                losses.append(tr.step(b, next_tokens=nxt))
            tr.drain()
            return losses, [s.tables["emb"].value.clone() for s in servers]
        finally:
            _close(van, servers)

    (sync_losses, sync_tables), (pre_losses, pre_tables) = run(False), run(True)
    assert pre_losses == sync_losses
    for a, b in zip(pre_tables, sync_tables):
        assert torch.equal(a, b)


def test_push_is_submitted_before_the_prefetch_pull(cluster):
    cfg, _van, _servers, worker = cluster
    order = []
    for name in ("push_device", "pull"):
        orig = getattr(worker, name)

        def spy(*a, _orig=orig, _name=name, **kw):
            order.append(_name)
            return _orig(*a, **kw)

        setattr(worker, name, spy)
    tr = _trainer(cfg, worker)
    rng = np.random.default_rng(3)
    tr.step(_tokens(cfg, rng), next_tokens=_tokens(cfg, rng))
    tr.drain()
    assert order == ["pull", "push_device", "pull"]


def test_a_deviating_batch_drains_the_prefetch_and_repulls(cluster):
    cfg, _van, _servers, worker = cluster
    tr = _trainer(cfg, worker)
    rng = np.random.default_rng(4)
    tr.step(_tokens(cfg, rng), next_tokens=_tokens(cfg, rng))
    assert tr._prefetch is not None
    tr.step(_tokens(cfg, rng))  # not the announced batch
    assert tr._prefetch is None
    tr.drain()
    assert worker.pending_count() == 0


def _one_device_losses(cfg, batches, emb_optimizer):
    van = LoopbackVan()
    cfgs = {"emb": hybrid.embedding_table_cfg(cfg, optimizer=emb_optimizer)}
    servers = [KVServer(Postoffice(f"S{s}", van), cfgs, s, NUM_SERVERS, device="cpu")
               for s in range(NUM_SERVERS)]
    worker = KVWorker(Postoffice("W0", van), cfgs, NUM_SERVERS,
                      localizers=hybrid.embedding_localizers(cfg), device="cpu")
    try:
        tr = _trainer(cfg, worker, seed=1)
        losses = [tr.step(b) for b in batches]
        tr.drain()
        return losses
    finally:
        _close(van, servers)


def test_multi_process_branch_raises(world):
    """The multi-process branch on a mesh pushes once a data line: on a
    (1, 8) mesh only rank 0 holds a worker and each step sends one push
    request a server, and the run equals one device's step for step (one
    table); on a (2, 4) mesh ranks 0 and 4 push, once each a step."""
    cfg_kw = dict(causal=True, tie_embeddings=False)
    cfg = tfm.tiny_config(**cfg_kw)
    rng = np.random.default_rng(0)
    batches = [rng.integers(0, cfg.vocab_size, size=(8, 16)).astype(np.int32)
               for _ in range(3)]
    want = _one_device_losses(cfg, batches, "sgd")
    res = world.run(torch_world.hybrid_mesh_run, (1, 8), cfg_kw, batches, "sgd", dict(seed=1))
    assert [r[3] for r in res] == [True] + [False] * 7
    assert [r[2] for r in res] == [NUM_SERVERS * len(batches)] + [None] * 7
    for r in res:
        np.testing.assert_allclose(r[0], want, rtol=1e-5, atol=1e-6)
    res = world.run(torch_world.hybrid_mesh_run, (2, 4), cfg_kw, batches[:1], "sgd",
                    dict(seed=1))
    assert [r[2] for r in res] == [NUM_SERVERS, None, None, None] * 2


def test_mesh_checkpoint_resume_continues_exactly(world, tmp_path):
    """``save`` / ``restore`` on a (1, 8) mesh: every rank gathers the
    placed parameters and moments, rank 0 writes the table shards and the
    body npz between barriers, and a fresh trainer (another seed) restored
    from them takes the next steps as the saving run did."""
    cfg_kw = dict(causal=True, tie_embeddings=False)
    cfg = tfm.tiny_config(**cfg_kw)
    rng = np.random.default_rng(7)
    batches = [_tokens(cfg, rng) for _ in range(5)]
    res = world.run(torch_world.hybrid_mesh_ckpt, (1, 8), cfg_kw, batches,
                    str(tmp_path / "ckpt"), 3)
    for ref, tail in res:
        np.testing.assert_allclose(tail, ref, rtol=1e-6)
    assert (tmp_path / "ckpt" / "hybrid_body_000003.npz").exists()


def test_hybrid_body_step_contains_allreduce(world):
    """The dense half is synchronous data parallelism: on a (2, 4) mesh
    each step all-reduces every body gradient (and the loss) over ``data``
    with ``Mesh.all_reduce``, and the first step's global loss equals one
    device's on the whole batch."""
    cfg_kw = dict(causal=True, tie_embeddings=False)
    cfg = tfm.tiny_config(**cfg_kw)
    batch = np.random.default_rng(1).integers(0, cfg.vocab_size, size=(8, 16)).astype(np.int32)
    want = _one_device_losses(cfg, [batch], "adagrad")
    n_params = len(list(tfm.TransformerBody(cfg, device="cpu").parameters()))
    res = world.run(torch_world.hybrid_mesh_run, (2, 4), cfg_kw, [batch], "adagrad",
                    dict(seed=1))
    for losses, per_step, _pushes, _van in res:
        assert per_step[0].get("data") == n_params + 1, per_step
        np.testing.assert_allclose(losses, want, rtol=1e-5, atol=1e-6)


# -- against the JAX trainer ----------------------------------------------------------


def _jax_cluster(van, cfg, lr=0.1):
    table_cfgs = {"emb": jhybrid.embedding_table_cfg(cfg, learning_rate=lr)}
    servers = [JaxKVServer(JaxPostoffice(f"S{s}", van), table_cfgs, s, NUM_SERVERS)
               for s in range(NUM_SERVERS)]
    worker = JaxKVWorker(JaxPostoffice("W0", van), table_cfgs, NUM_SERVERS,
                         localizers=jhybrid.embedding_localizers(cfg))
    return servers, worker


def _jax_trainer(worker, **kw):
    mesh = mesh_lib.make_mesh((1, 1), devices=jax.devices()[:1])
    return jhybrid.HybridLMTrainer(_cfg(jtfm), mesh, worker, **kw)


def _port_twin(jservers, jtr, van, **kw):
    """A port cluster holding the JAX servers' shards and a port trainer
    holding the JAX trainer's body weights."""
    cfg = _cfg()
    servers, worker = _hybrid_cluster(van, cfg)
    for js, ps in zip(jservers, servers):
        ps.import_shard(shard_from_numpy(js.export_shard(), "cpu"))
    tr = _trainer(cfg, worker, **kw)
    transformer_from_numpy(tr.body, jax.tree.map(np.asarray, jtr.params))
    return servers, tr


@pytest.mark.parametrize("max_delay", [0, 2])
def test_steps_match_the_jax_trainer(max_delay):
    cfg = _cfg()
    rng = np.random.default_rng(31)
    batches = [_tokens(cfg, rng) for _ in range(4)]
    jvan, van = JaxLoopbackVan(), LoopbackVan()
    jservers, jworker = _jax_cluster(jvan, _cfg(jtfm))
    try:
        # the trainer's default AdamW rate (1e-3): Adam moves a parameter
        # whose gradient is float noise (~1e-8) by up to lr in either package,
        # and at 1e-2 that reaches the table rows past 1e-5 within 4 steps
        jtr = _jax_trainer(jworker, max_delay=max_delay, seed=4)
        servers, tr = _port_twin(jservers, jtr, van, max_delay=max_delay)
        for i, b in enumerate(batches):
            nxt = batches[i + 1] if i + 1 < len(batches) else None
            np.testing.assert_allclose(tr.step(b, next_tokens=nxt),
                                       jtr.step(b, next_tokens=nxt), **TRAJ)
        tr.drain()
        jtr.drain()
        for js, ps in zip(jservers, servers):
            want, got = js.export_shard()["emb"], ps.export_shard()["emb"]
            np.testing.assert_allclose(got["value"], want["value"], **TABLE)
            np.testing.assert_allclose(got["state"]["sum_sq"], want["state"]["sum_sq"],
                                       **TABLE)
    finally:
        jvan.close()
        _close(van, servers)


def test_a_jax_checkpoint_resumes_in_the_port(tmp_path):
    """The JAX trainer saves after 3 steps (table shards + hybrid_body npz
    with optax's adamw state); a fresh port cluster restores it and its
    next steps follow the JAX trainer's."""
    root = str(tmp_path / "ckpt")
    cfg = _cfg()
    rng = np.random.default_rng(41)
    batches = [_tokens(cfg, rng) for _ in range(6)]
    jvan = JaxLoopbackVan()
    _jservers, jworker = _jax_cluster(jvan, _cfg(jtfm))
    try:
        jtr = _jax_trainer(jworker, learning_rate=1e-2, max_delay=0, seed=6)
        for b in batches[:3]:
            jtr.step(b)
        jtr.save(root, step=3)
        tail_ref = [jtr.step(b) for b in batches[3:]]
        jtr.drain()
    finally:
        jvan.close()
    van = LoopbackVan()
    servers, worker = _hybrid_cluster(van, cfg)
    try:
        tr = _trainer(cfg, worker, learning_rate=1e-2, max_delay=0, seed=99)
        tr.restore(root, step=3)
        assert all(float(s["step"]) == 3.0 for s in tr.optimizer.state.values())
        tail = [tr.step(b) for b in batches[3:]]
        tr.drain()
    finally:
        _close(van, servers)
    np.testing.assert_allclose(tail, tail_ref, **TRAJ)


def test_the_port_checkpoint_is_laid_out_as_the_jax_one(tmp_path):
    """``p{i}`` in jax.tree order, ``o{i}`` optax adamw's leaves (count
    int32, mu, nu): the JAX trainer restores a port-written body."""
    root = str(tmp_path / "ckpt")
    cfg = _cfg()
    van = LoopbackVan()
    servers, worker = _hybrid_cluster(van, cfg)
    try:
        tr = _trainer(cfg, worker, learning_rate=1e-2, seed=8)
        tr.step(_tokens(cfg, np.random.default_rng(5)))
        tr.save(root, step=1)
    finally:
        _close(van, servers)
    jvan = JaxLoopbackVan()
    _jservers, jworker = _jax_cluster(jvan, _cfg(jtfm))
    try:
        jtr = _jax_trainer(jworker, learning_rate=1e-2)
        jtr.restore(root, step=1)
        leaves = jax.tree.leaves(jtr.opt_state)
        assert leaves[0].dtype == np.int32 and int(leaves[0]) == 1
        port = [p for _, p in flat_items(params_tree(tr.body))]
        for leaf, p in zip(jax.tree.leaves(jtr.params), port):
            np.testing.assert_array_equal(np.asarray(leaf), p.detach().numpy())
        n = len(port)
        for m, v, p in zip(leaves[1:1 + n], leaves[1 + n:], port):
            state = tr.optimizer.state[p]
            np.testing.assert_array_equal(np.asarray(m), state["exp_avg"].numpy())
            np.testing.assert_array_equal(np.asarray(v), state["exp_avg_sq"].numpy())
    finally:
        jvan.close()
