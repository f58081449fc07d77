"""The port's serving plane against the JAX package's, on the CPU.

A JAX cluster and a port cluster, two servers each on a ``LoopbackVan``; the
port's shards start from the JAX cluster's ``export_shard()`` through
``convert.shard_from_numpy`` (the tables are initialised at random, so the
import is what makes the two sides equal).  The same pushes, then
``pull_serve`` cold, warm and after a write on both sides; the server's
read-only fast path bitwise equal to ``pull`` and, in a bundle, not flushing
the open push group; admission control's busy hint and its ``stale`` and
``queue`` policies; the load generator's request sequence against the JAX
one for three seeds (with ``rate_fn`` thinning and ``shift_hot_set``); and
``pull_result_device`` against ``pull_result``.

Tolerances: rows at rtol = atol = 1e-6 against the JAX package (the same
float math in two frameworks); within the port bitwise; hit / miss counts,
counters and the load generator's arrays exactly.
"""

import time
import types

import numpy as np
import pytest
import torch

from parameter_server_tpu import config as jax_config
from parameter_server_tpu.core import messages as jax_messages
from parameter_server_tpu.core import postoffice as jax_postoffice
from parameter_server_tpu.core import van as jax_van
from parameter_server_tpu.kv import cache as jax_cache
from parameter_server_tpu.kv import server as jax_server
from parameter_server_tpu.kv import worker as jax_worker
from parameter_server_tpu.serve import admission as jax_admission
from parameter_server_tpu.serve import loadgen as jax_loadgen
from parameter_server_tpu_torch import config
from parameter_server_tpu_torch.convert import shard_from_numpy
from parameter_server_tpu_torch.core import messages, postoffice, van
from parameter_server_tpu_torch.kv import cache, server, worker
from parameter_server_tpu_torch.serve import admission, loadgen
from parameter_server_tpu_torch.serve.admission import AdmissionController, ShedError
from parameter_server_tpu_torch.serve.loadgen import LoadGenerator

ROWS = 1 << 10
DIM = 4
NUM_SERVERS = 2
TOL = dict(rtol=1e-6, atol=1e-6)

JAX = types.SimpleNamespace(
    cfg=jax_config, msg=jax_messages, post=jax_postoffice, van=jax_van, cache=jax_cache,
    server=jax_server, worker=jax_worker, admission=jax_admission, loadgen=jax_loadgen,
    kw={},
)
PORT = types.SimpleNamespace(
    cfg=config, msg=messages, post=postoffice, van=van, cache=cache, server=server,
    worker=worker, admission=admission, loadgen=loadgen, kw={"device": "cpu"},
)


def _table_cfgs(pkg, init_scale=0.0):
    return {"w": pkg.cfg.TableConfig(
        name="w", rows=ROWS, dim=DIM, init_scale=init_scale,
        optimizer=pkg.cfg.OptimizerConfig(kind="adagrad", learning_rate=0.1),
    )}


def _cluster(pkg, v, *, cache_rows=None, init_scale=0.0, **server_kw):
    cfgs = _table_cfgs(pkg, init_scale)
    servers = [pkg.server.KVServer(pkg.post.Postoffice(f"S{s}", v), cfgs, s, NUM_SERVERS,
                                   **server_kw, **pkg.kw)
               for s in range(NUM_SERVERS)]
    c = pkg.cache.HotRowCache(cache_rows, node="W0") if cache_rows else None
    w = pkg.worker.KVWorker(pkg.post.Postoffice("W0", v), cfgs, NUM_SERVERS, cache=c,
                            **pkg.kw)
    return servers, w


def _close(v, servers):
    v.close()
    for s in servers:
        if s.ledger is not None:
            s.ledger.close()


def _twin_clusters(cache_rows=None):
    """A JAX cluster with randomly initialised shards and a port cluster
    holding the same shards, imported from the JAX servers' exports."""
    jv, pv = jax_van.LoopbackVan(), van.LoopbackVan()
    jservers, jw = _cluster(JAX, jv, cache_rows=cache_rows, init_scale=0.1)
    pservers, pw = _cluster(PORT, pv, cache_rows=cache_rows)
    for js, ps in zip(jservers, pservers):
        ps.import_shard(shard_from_numpy(js.export_shard(), "cpu"))
    return (jv, jservers, jw), (pv, pservers, pw)


def test_twin_clusters_start_from_the_same_shards():
    (jv, jservers, _), (pv, pservers, _) = _twin_clusters()
    try:
        for js, ps in zip(jservers, pservers):
            jsh, psh = js.export_shard()["w"], ps.export_shard()["w"]
            assert np.abs(jsh["value"]).max() > 0  # random, not zeros
            np.testing.assert_array_equal(psh["value"], jsh["value"])
            for k in jsh["state"]:
                np.testing.assert_array_equal(psh["state"][k], jsh["state"][k])
    finally:
        _close(jv, jservers)
        _close(pv, pservers)


def test_pull_serve_matches_jax_cold_warm_and_after_write():
    """The same pushes and serves on both packages: rows within 1e-6 of the
    JAX package and bitwise equal to the port's own ``pull_sync``, and the
    caches' hit / miss / invalidation counts identical after every call."""
    (jv, jservers, jw), (pv, pservers, pw) = _twin_clusters(cache_rows=1 << 11)
    try:
        rng = np.random.default_rng(0)
        keys = rng.choice(ROWS, size=256, replace=False).astype(np.int64)
        grads = rng.normal(size=(keys.size, DIM)).astype(np.float32)
        # duplicates, unsorted order, and a 2-D batch
        probe = np.concatenate([keys[:64][::-1], keys[:9]])
        batch2d = keys[:32].reshape(4, 8)
        for w in (jw, pw):
            w.push_sync("w", np.sort(keys), grads, timeout=60)
        steps = [("cold", probe), ("warm", probe), ("write", None), ("after", probe),
                 ("2d", batch2d)]
        for name, k in steps:
            if k is None:  # the write: its acks raise the watermarks
                for w in (jw, pw):
                    w.push_sync("w", np.sort(keys[:64]), np.ones((64, DIM), np.float32),
                                timeout=60)
                continue
            got_j = np.asarray(jw.pull_serve("w", k, timeout=60))
            got_p = pw.pull_serve("w", k, timeout=60)
            np.testing.assert_allclose(got_p, got_j, **TOL, err_msg=name)
            np.testing.assert_array_equal(got_p, pw.pull_sync("w", k, timeout=60))
            assert pw.cache.counters() == jw.cache.counters(), name
        c = pw.cache.counters()
        assert c["cache_hits"] > 0 and c["cache_invalidations"] > 0
        assert {k: v for k, v in pw.counters().items() if k.startswith("cache_")} == c
    finally:
        _close(jv, jservers)
        _close(pv, pservers)


def test_read_only_fast_path_is_bitwise_equal_and_instrumented():
    """Within the port: a read-only pull equals a training pull bit for bit,
    counts in ``ro_pulls`` and ``ro_pull.w``; the JAX servers count the
    same requests."""
    (jv, jservers, jw), (pv, pservers, pw) = _twin_clusters()
    try:
        rng = np.random.default_rng(1)
        keys = np.sort(rng.choice(ROWS, size=512, replace=False)).astype(np.int64)
        grads = rng.normal(size=(keys.size, DIM)).astype(np.float32)
        out = {}
        for name, w in (("jax", jw), ("port", pw)):
            w.push_sync("w", keys, grads, timeout=60)
            normal = np.asarray(w.pull_sync("w", keys, timeout=60))
            ro = np.asarray(w.pull_result(w.pull("w", keys, read_only=True), timeout=60))
            np.testing.assert_array_equal(normal, ro)
            out[name] = ro
        np.testing.assert_allclose(out["port"], out["jax"], **TOL)
        assert [s.ro_pulls for s in pservers] == [s.ro_pulls for s in jservers] == [1, 1]
        assert [s.counters()["ro_pulls"] for s in pservers] == [1, 1]
        for s in pservers:
            assert s.latency_digests()["ro_pull.w"]["count"] == 1
    finally:
        _close(jv, jservers)
        _close(pv, pservers)


def _ro_bundle(pkg, seed=2):
    """PUSH, read-only PULL, training PULL of the same ids, in one bundle."""
    rng = np.random.default_rng(seed)
    ids = np.sort(rng.choice(ROWS // 2, size=24, replace=False)).astype(np.int32)
    m, kind = pkg.msg, pkg.msg.TaskKind
    push = m.Message(task=m.Task(kind.PUSH, "kv", payload={"table": "w"}), sender="W0",
                     recver="S0", keys=ids,
                     values=[rng.standard_normal((ids.size, DIM)).astype(np.float32)])
    pulls = [m.Message(task=m.Task(kind.PULL, "kv", payload=p), sender="W0", recver="S0",
                       keys=ids)
             for p in ({"table": "w", "__ro__": True}, {"table": "w"})]
    return ids, [push, *pulls]


def test_read_only_pull_in_a_bundle_does_not_flush_the_push_group():
    """``handle_request_batch``: the read-only member sees the shard as of
    dispatch (without the bundle's push), the training pull after it; both
    as the JAX server answers the same bundle."""
    (jv, jservers, _), (pv, pservers, _) = _twin_clusters()
    try:
        replies = {}
        for name, pkg, srv in (("jax", JAX, jservers[0]), ("port", PORT, pservers[0])):
            ids, msgs = _ro_bundle(pkg)
            before = np.asarray(srv.export_shard()["w"]["value"])[ids]
            rep = srv.handle_request_batch(msgs)
            after = np.asarray(srv.export_shard()["w"]["value"])[ids]
            ro, normal = (np.asarray(r.values[0]) for r in rep[1:])
            np.testing.assert_array_equal(ro, before)
            np.testing.assert_array_equal(normal, after)
            assert not np.array_equal(before, after)
            replies[name] = (ro, normal, [r.task.payload.get("__sver__") for r in rep])
            assert srv.ro_pulls == 1 and srv.pulls == 1
        for a, b in zip(replies["port"][:2], replies["jax"][:2]):
            np.testing.assert_allclose(a, b, **TOL)
        assert replies["port"][2] == replies["jax"][2]
    finally:
        _close(jv, jservers)
        _close(pv, pservers)


def test_pull_result_device_equals_pull_result():
    """Assembled on the worker's device (here the CPU), with duplicate keys
    and a 2-D batch, from numpy replies and from ``device_replies``
    tensors."""
    for device_replies in (False, True):
        v = van.LoopbackVan()
        servers, w = _cluster(PORT, v, device_replies=device_replies)
        try:
            rng = np.random.default_rng(3)
            keys = rng.choice(ROWS, size=128, replace=False).astype(np.int64)
            w.push_sync("w", np.sort(keys), rng.normal(size=(128, DIM)).astype(np.float32),
                        timeout=60)
            for k in (np.concatenate([keys, keys[:7]]), keys[:32].reshape(4, 8)):
                dev = w.pull_result_device(w.pull("w", k), timeout=60)
                assert isinstance(dev, torch.Tensor) and dev.device == w.device
                np.testing.assert_array_equal(dev.numpy(), w.pull_sync("w", k, timeout=60))
        finally:
            _close(v, servers)


def test_device_replies_keep_the_rows_as_tensors():
    v = van.LoopbackVan()
    servers, w = _cluster(PORT, v, device_replies=True)
    seen = []
    tap = w._on_response

    def spy(msg):
        if msg.task.kind == messages.TaskKind.PULL:
            seen.append(all(isinstance(x, torch.Tensor) for x in msg.values))
        tap(msg)

    w._on_response = spy
    try:
        keys = np.arange(16, dtype=np.int64)
        w.pull_result(w.pull("w", keys), timeout=60)
        w.pull_result(w.pull("w", keys, read_only=True), timeout=60)
        assert seen == [True] * 4
    finally:
        _close(v, servers)


# ---------------------------------------------------------- admission control


def test_busy_hint_alone_trips_admission():
    v = van.LoopbackVan()
    servers, w = _cluster(PORT, v, cache_rows=64)
    try:
        adm = AdmissionController(w, node="W0")
        assert not adm.overloaded("w")
        # a live __busy__ hint from an owner of "w" is a local overload
        # signal (stamp what the reply tap would)
        with w._staleness_lock:
            w._busy_last["S1"] = time.monotonic()
        assert adm.overloaded("w")
        with pytest.raises(ShedError):
            adm.pull("w", np.arange(4, dtype=np.int64))
        assert adm.counters() == {"serve_shed": 1, "serve_stale": 0, "serve_queue_waits": 0}
    finally:
        _close(v, servers)


def test_stale_policy_serves_cached_rows_and_sheds_uncached():
    v = van.LoopbackVan()
    servers, w = _cluster(PORT, v, cache_rows=1 << 11)
    try:
        keys = np.arange(16, dtype=np.int64)
        w.push_sync("w", keys, np.ones((keys.size, DIM), np.float32), timeout=60)
        ref = w.pull_sync("w", keys, timeout=60)
        w.pull_serve("w", keys, timeout=60)  # warm the cache
        adm = AdmissionController(w, healthy=lambda: False, node="W0",
                                  cfg=config.ServeConfig(policy="stale"))
        np.testing.assert_array_equal(adm.pull("w", keys), ref)  # degraded, answered
        assert adm.serve_stale == 1
        with pytest.raises(ShedError):
            adm.pull("w", np.arange(900, 910, dtype=np.int64))  # not cached
        assert adm.serve_shed == 1
    finally:
        _close(v, servers)


def test_queue_policy_waits_for_health_then_serves_or_sheds():
    v = van.LoopbackVan()
    servers, w = _cluster(PORT, v, cache_rows=1 << 11)
    try:
        keys = np.arange(8, dtype=np.int64)
        w.push_sync("w", keys, np.ones((keys.size, DIM), np.float32), timeout=60)
        calls = {"n": 0}

        def healthy_after_three():
            calls["n"] += 1
            return calls["n"] > 3

        adm = AdmissionController(
            w, healthy=healthy_after_three, node="W0",
            cfg=config.ServeConfig(policy="queue", queue_deadline_s=2.0, queue_poll_s=0.001),
        )
        assert adm.pull("w", keys, timeout=60).shape == (keys.size, DIM)
        assert adm.serve_queue_waits == 1 and adm.serve_shed == 0
        down = AdmissionController(
            w, healthy=lambda: False, node="W0",
            cfg=config.ServeConfig(policy="queue", queue_deadline_s=0.02, queue_poll_s=0.001),
        )
        with pytest.raises(ShedError):
            down.pull("w", keys)
    finally:
        _close(v, servers)


def test_serve_config_matches_jax():
    import dataclasses

    assert ({f.name: f.default for f in dataclasses.fields(config.ServeConfig)}
            == {f.name: f.default for f in dataclasses.fields(jax_config.ServeConfig)})
    for pkg in (config, jax_config):
        with pytest.raises(ValueError):
            pkg.ServeConfig(policy="drop")


# ---------------------------------------------------------------- load generator


def test_loadgen_is_open_loop_seeded_and_counts_sheds():
    seen: list = []

    def record_pull(table, keys):
        seen.append(np.asarray(keys).copy())
        if len(seen) % 2 == 0:
            raise ShedError("drill", 0.01)

    kw = dict(table="w", num_keys=ROWS, keys_per_pull=4, clients=1000, per_client_qps=0.05,
              zipf_s=1.1, seed=11)
    gen = LoadGenerator(record_pull, **kw)
    assert gen.qps == pytest.approx(50.0)
    rep = gen.run(0.3)
    assert rep.pulls == rep.served + rep.shed and rep.pulls == len(seen)
    assert rep.shed == rep.pulls // 2
    assert rep.shed_rate == round(rep.shed / rep.pulls, 4)
    # same seed -> the identical offered request sequence
    seen2: list = []
    LoadGenerator(lambda t, k: seen2.append(np.asarray(k).copy()), **kw).run(0.3)
    assert len(seen2) == len(seen)
    for a, b in zip(seen, seen2):
        np.testing.assert_array_equal(a, b)


def _diurnal(t):
    return 1.0 + 0.8 * np.sin(2 * np.pi * t / 0.5)


@pytest.mark.parametrize("seed", [0, 3, 11])
def test_loadgen_arrivals_are_bit_identical_to_jax(seed):
    """``_arrivals`` on both packages: flat rate, ``rate_fn`` thinning, and
    after ``shift_hot_set`` — the same ``sched`` and ``keys`` arrays."""
    kw = dict(table="w", num_keys=5000, keys_per_pull=8, clients=10_000,
              per_client_qps=0.02, zipf_s=1.1, seed=seed)
    for rate_fn in (None, _diurnal):
        port = LoadGenerator(lambda t, k: None, rate_fn=rate_fn, **kw)
        ref = jax_loadgen.LoadGenerator(lambda t, k: None, rate_fn=rate_fn, **kw)
        for shift in (None, seed + 7):
            if shift is not None:
                port.shift_hot_set(shift)
                ref.shift_hot_set(shift)
            got = port._arrivals(np.random.default_rng(seed + 1), 1.0)
            want = ref._arrivals(np.random.default_rng(seed + 1), 1.0)
            for a, b in zip(got, want):
                assert a.dtype == b.dtype
                np.testing.assert_array_equal(a, b)
            assert got[0].size > 50


def test_load_report_fields_match_jax():
    import dataclasses

    assert ([f.name for f in dataclasses.fields(loadgen.LoadReport)]
            == [f.name for f in dataclasses.fields(jax_loadgen.LoadReport)])


def test_loadgen_through_admission_serves_every_request():
    """The serve path end to end at a small size: every request served, none
    shed, the hit rate and the servers' read-only pulls accounted."""
    v = van.LoopbackVan()
    servers, w = _cluster(PORT, v, cache_rows=1 << 10)
    try:
        adm = AdmissionController(w, healthy=lambda: True, node="W0")
        gen = LoadGenerator(adm.pull, table="w", num_keys=ROWS, keys_per_pull=8,
                            clients=1000, per_client_qps=0.2, seed=3, cache=w.cache)
        rep = gen.run(0.3)
        assert rep.shed == 0 and rep.served == rep.pulls > 0
        assert rep.cache_hits + rep.cache_misses == 8 * rep.pulls
        assert rep.hit_rate > 0
        assert sum(s.ro_pulls for s in servers) > 0 and sum(s.pulls for s in servers) == 0
    finally:
        _close(v, servers)
