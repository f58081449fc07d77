"""The port's parameter-server loop against the JAX package's, on the CPU:
KVWorker -> LoopbackVan -> KVServer -> KVTable, the bundle-batched apply
engine under both duplicate policies, the export_shard -> shard_from_numpy
round trip, and a short AsyncLRLearner loss trajectory.

Tolerances: host code (routing, version stamps, exported bytes) is compared
exactly; device float math with float32 allclose at rtol = atol = 1e-5 for a
few pushes, 1e-4 for multi-step loss trajectories.
"""

import numpy as np
import pytest

import torch

from parameter_server_tpu.config import ApplyEngineConfig as JaxApplyEngineConfig
from parameter_server_tpu.config import ConsistencyConfig as JaxConsistencyConfig
from parameter_server_tpu.config import OptimizerConfig as JaxOptimizerConfig
from parameter_server_tpu.config import TableConfig as JaxTableConfig
from parameter_server_tpu.core.messages import Message as JaxMessage
from parameter_server_tpu.core.messages import Task as JaxTask
from parameter_server_tpu.core.messages import TaskKind as JaxTaskKind
from parameter_server_tpu.core.postoffice import Postoffice as JaxPostoffice
from parameter_server_tpu.core.van import LoopbackVan as JaxLoopbackVan
from parameter_server_tpu.data.synthetic import SyntheticCTR as JaxSyntheticCTR
from parameter_server_tpu.kv.server import KVServer as JaxKVServer
from parameter_server_tpu.kv.worker import KVWorker as JaxKVWorker
from parameter_server_tpu.learner.sgd import AsyncLRLearner as JaxAsyncLRLearner
from parameter_server_tpu_torch.config import (
    ApplyEngineConfig,
    ConsistencyConfig,
    OptimizerConfig,
    TableConfig,
)
from parameter_server_tpu_torch.convert import shard_from_numpy
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.learner.sgd import AsyncLRLearner

TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)


def _cfgs(rows, dim, opt, impl="auto"):
    jax_cfg = JaxTableConfig(name="e", rows=rows, dim=dim,
                             optimizer=JaxOptimizerConfig(**opt), scatter_impl=impl)
    port_cfg = TableConfig(name="e", rows=rows, dim=dim,
                           optimizer=OptimizerConfig(**opt))
    return {"e": jax_cfg}, {"e": port_cfg}


def _cluster(jax_side, cfgs, n_servers, n_workers=1, min_bucket=256, **server_kw):
    """(van, servers, workers) of one package over a LoopbackVan."""
    if jax_side:
        van = JaxLoopbackVan()
        servers = [JaxKVServer(JaxPostoffice(f"S{i}", van), cfgs, i, n_servers, **server_kw)
                   for i in range(n_servers)]
        workers = [JaxKVWorker(JaxPostoffice(f"W{i}", van), cfgs, n_servers,
                               min_bucket=min_bucket)
                   for i in range(n_workers)]
    else:
        van = LoopbackVan()
        servers = [KVServer(Postoffice(f"S{i}", van), cfgs, i, n_servers,
                            device="cpu", **server_kw)
                   for i in range(n_servers)]
        workers = [KVWorker(Postoffice(f"W{i}", van), cfgs, n_servers,
                            min_bucket=min_bucket, device="cpu")
                   for i in range(n_workers)]
    return van, servers, workers


@pytest.mark.parametrize("dim", [1, 128])
def test_two_server_push_pull_matches_jax(dim):
    """Mirror of test_scatter.py::test_kvserver_full_path_pallas_parity:
    repeated pushes with duplicate keys and bucket pads through two servers,
    then a pull; version stamps must match exactly.  The JAX side runs XLA:
    that test holds its Pallas loop to its XLA loop, and the Pallas kernels
    themselves are held against the port in test_torch_scatter/_table (the
    interpret-mode loop takes tens of seconds)."""
    keys = (np.arange(24, dtype=np.uint64) * 7919) % 3000
    keys = np.concatenate([keys, keys[:8]])  # duplicates pre-combine
    grads = np.random.RandomState(0).randn(keys.size, dim).astype(np.float32)
    jcfgs, pcfgs = _cfgs(512, dim, dict(kind="adagrad", learning_rate=0.1))
    out = {}
    for side, cfgs in (("jax", jcfgs), ("port", pcfgs)):
        van, servers, (worker,) = _cluster(side == "jax", cfgs, 2, min_bucket=16)
        try:
            for _ in range(3):
                assert worker.wait(worker.push("e", keys, grads), timeout=60)
            out[side] = (
                worker.pull_sync("e", keys, timeout=60),
                [s._seg_versions["e"].copy() for s in servers],
                [s.pushes for s in servers],
            )
        finally:
            van.close()
    np.testing.assert_allclose(out["port"][0], out["jax"][0], **TOL)
    for pv, jv in zip(out["port"][1], out["jax"][1]):
        np.testing.assert_array_equal(pv, jv)
    assert out["port"][2] == out["jax"][2]


def _bundle(msg_cls, task_cls, kind_cls, k, batch, pool, dim, seed):
    """k worker-shaped PUSHes (sorted unique ids each, duplicates ACROSS
    members) from a hot pool, plus a PULL of the pool at the end."""
    rng = np.random.default_rng(seed)
    msgs = []
    for _ in range(k):
        ids = np.sort(rng.choice(pool, size=batch, replace=False)).astype(np.int32)
        msgs.append(msg_cls(
            task=task_cls(kind_cls.PUSH, "kv", payload={"table": "e"}),
            sender="W0", recver="S0", keys=ids,
            values=[rng.standard_normal((batch, dim)).astype(np.float32)],
        ))
    msgs.append(msg_cls(
        task=task_cls(kind_cls.PULL, "kv", payload={"table": "e"}),
        sender="W0", recver="S0", keys=np.arange(pool, dtype=np.int32),
    ))
    return msgs


@pytest.mark.parametrize("dup_policy", ["rounds", "combine"])
def test_handle_request_batch_matches_jax(dup_policy):
    jcfgs, pcfgs = _cfgs(64, 8, dict(kind="adam", learning_rate=0.05))
    jax_srv_van, (jsrv,), _ = _cluster(
        True, jcfgs, 1, apply=JaxApplyEngineConfig(dup_policy=dup_policy))
    van, (psrv,), _ = _cluster(
        False, pcfgs, 1, apply=ApplyEngineConfig(dup_policy=dup_policy))
    try:
        jrep = jsrv.handle_request_batch(
            _bundle(JaxMessage, JaxTask, JaxTaskKind, 4, 24, 40, 8, seed=1))
        prep = psrv.handle_request_batch(
            _bundle(Message, Task, TaskKind, 4, 24, 40, 8, seed=1))
        for j, p in zip(jrep, prep):
            assert p.task.payload.get("__sver__") == j.task.payload.get("__sver__")
            assert "__error__" not in p.task.payload
        np.testing.assert_allclose(prep[-1].values[0], np.asarray(jrep[-1].values[0]), **TOL)
        jshard, pshard = jsrv.export_shard()["e"], psrv.export_shard()["e"]
        np.testing.assert_allclose(pshard["value"], jshard["value"], **TOL)
        for k in jshard["state"]:
            np.testing.assert_allclose(pshard["state"][k], jshard["state"][k], **TOL)
    finally:
        jax_srv_van.close()
        van.close()


def test_rounds_policy_equals_sequential_applies_bitwise():
    """``dup_policy="rounds"`` inside the port: one bundled call gives the
    same bytes as handling every member on its own."""
    _, pcfgs = _cfgs(64, 8, dict(kind="adam", learning_rate=0.05))
    vans = []
    try:
        shards = []
        for batched in (True, False):
            van, (srv,), _ = _cluster(False, pcfgs, 1)
            vans.append(van)
            msgs = _bundle(Message, Task, TaskKind, 4, 24, 40, 8, seed=2)[:-1]
            if batched:
                srv.handle_request_batch(msgs)
            else:
                for m in msgs:
                    srv.handle_request(m)
            shards.append(srv.export_shard()["e"])
        np.testing.assert_array_equal(shards[0]["value"], shards[1]["value"])
        for k in shards[0]["state"]:
            np.testing.assert_array_equal(shards[0]["state"][k], shards[1]["state"][k])
    finally:
        for v in vans:
            v.close()


def test_export_shard_round_trip_between_packages():
    """JAX export -> shard_from_numpy -> port import -> port export gives the
    JAX bytes back, and the port's export imports into the JAX server."""
    jcfgs, pcfgs = _cfgs(40, 4, dict(kind="ftrl", l1=0.1))
    jvan, jservers, (jworker,) = _cluster(True, jcfgs, 2)
    pvan, pservers, _ = _cluster(False, pcfgs, 2)
    try:
        keys = np.arange(30, dtype=np.uint64) * 13
        grads = np.random.default_rng(3).normal(size=(30, 4)).astype(np.float32)
        assert jworker.wait(jworker.push("e", keys, grads), timeout=60)
        for js, ps in zip(jservers, pservers):
            exported = js.export_shard()
            moved = shard_from_numpy(exported, "cpu")
            assert moved["e"]["value"].dtype == torch.float32
            ps.import_shard(exported)
            back = ps.export_shard()
            np.testing.assert_array_equal(back["e"]["value"], exported["e"]["value"])
            for k in exported["e"]["state"]:
                np.testing.assert_array_equal(
                    back["e"]["state"][k], exported["e"]["state"][k])
            js.import_shard(back)
            np.testing.assert_array_equal(
                np.asarray(js.tables["e"].value), exported["e"]["value"])
        with pytest.raises(ValueError, match="shape"):
            pservers[0].import_shard(
                {"e": {"value": np.zeros((3, 4), np.float32),
                       "state": {"n": np.zeros((3, 4), np.float32)}}})
    finally:
        jvan.close()
        pvan.close()


def test_async_lr_learner_trajectory_matches_jax():
    """One worker, two servers, BSP: both packages start from one random
    numpy shard (via shard_from_numpy on the port side) and must produce the
    same loss trajectory and the same final tables."""
    rows, steps = 4096, 5
    opt = dict(kind="adagrad", learning_rate=0.05)
    jcfgs = {"w": JaxTableConfig(name="w", rows=rows, dim=1,
                                 optimizer=JaxOptimizerConfig(**opt))}
    pcfgs = {"w": TableConfig(name="w", rows=rows, dim=1,
                              optimizer=OptimizerConfig(**opt))}
    rng = np.random.default_rng(4)
    half = rows // 2
    init = [
        {"w": {"value": np.concatenate(
            [rng.normal(scale=0.1, size=(half, 1)), np.zeros((1, 1))]).astype(np.float32),
               "state": {"sum_sq": np.zeros((half + 1, 1), np.float32)}}}
        for _ in range(2)
    ]
    data = dict(key_space=1 << 16, batch_size=256, seed=0, informative=0.1)
    results = {}
    for side in ("jax", "port"):
        if side == "jax":
            van = JaxLoopbackVan()
            servers = [JaxKVServer(JaxPostoffice(f"S{i}", van), jcfgs, i, 2)
                       for i in range(2)]
            worker = JaxKVWorker(JaxPostoffice("W0", van), jcfgs, 2)
            learner = JaxAsyncLRLearner([worker], JaxConsistencyConfig())
            batches = JaxSyntheticCTR(**data)
        else:
            van = LoopbackVan()
            servers = [KVServer(Postoffice(f"S{i}", van), pcfgs, i, 2, device="cpu")
                       for i in range(2)]
            worker = KVWorker(Postoffice("W0", van), pcfgs, 2, device="cpu")
            learner = AsyncLRLearner([worker], ConsistencyConfig(), device="cpu")
            batches = SyntheticCTR(**data)
        try:
            for s, shard in zip(servers, init):
                s.import_shard(shard)
            losses = learner.run([batches.next_batch], steps)
            results[side] = (losses, [s.export_shard()["w"] for s in servers])
        finally:
            van.close()
    jl, pl = results["jax"][0], results["port"][0]
    assert len(pl) == steps
    np.testing.assert_allclose(pl, jl, **TRAJ_TOL)
    for js, ps in zip(results["jax"][1], results["port"][1]):
        np.testing.assert_allclose(ps["value"], js["value"], **TRAJ_TOL)
        np.testing.assert_allclose(ps["state"]["sum_sq"], js["state"]["sum_sq"], **TRAJ_TOL)


def test_host_key_path_and_routing_match_jax_exactly():
    """The loop's host code is copied, not imported: key hashing, slots,
    bucket pads, routing slices, data and AUC must equal the JAX package's
    bit for bit."""
    from parameter_server_tpu.kv.partition import RangePartition as JaxRangePartition
    from parameter_server_tpu.kv.routing import RoutingTable as JaxRoutingTable
    from parameter_server_tpu.kv.server import _bucket as jax_bucket
    from parameter_server_tpu.utils import keys as jkeys
    from parameter_server_tpu.utils.metrics import auc as jax_auc
    from parameter_server_tpu_torch.kv.partition import RangePartition
    from parameter_server_tpu_torch.kv.routing import RoutingTable
    from parameter_server_tpu_torch.kv.server import _bucket
    from parameter_server_tpu_torch.utils import keys as pkeys
    from parameter_server_tpu_torch.utils.metrics import auc

    rng = np.random.default_rng(8)
    raw = rng.integers(0, 2**63, size=(64, 7), dtype=np.uint64)
    raw[3, 2] = pkeys.PAD_KEY
    np.testing.assert_array_equal(pkeys.mix64(raw, 5), jkeys.mix64(raw, 5))
    small = (raw % np.uint64(2**32 - 1)).astype(np.uint64)
    np.testing.assert_array_equal(pkeys.ensure_uint32_keys(small),
                                  jkeys.ensure_uint32_keys(small))
    np.testing.assert_array_equal(pkeys.mix32(small.astype(np.uint32), 3),
                                  jkeys.mix32(small.astype(np.uint32), 3))
    for n in (0, 1, 7, 8, 9, 255, 256, 257, 40171):
        assert pkeys.bucket_size(n) == jkeys.bucket_size(n)
        assert _bucket(n) == jax_bucket(n)
    for a, b in zip(pkeys.localize_batch(raw, min_bucket=16),
                    jkeys.localize_batch(raw, min_bucket=16)):
        np.testing.assert_array_equal(a, b)
    for bits in (32, 64):
        ploc = pkeys.HashLocalizer(1000, seed=2, hash_bits=bits)
        jloc = jkeys.HashLocalizer(1000, seed=2, hash_bits=bits)
        keys = small if bits == 32 else raw
        for a, b in zip(pkeys.localize_to_slots(keys, ploc, min_bucket=32),
                        jkeys.localize_to_slots(keys, jloc, min_bucket=32)):
            np.testing.assert_array_equal(a, b)
    dense = rng.integers(0, 50, size=30).astype(np.uint64)
    np.testing.assert_array_equal(pkeys.IdentityLocalizer(50).assign(dense),
                                  jkeys.IdentityLocalizer(50).assign(dense))
    slots = np.sort(rng.choice(1001, size=300, replace=False)).astype(np.int32)
    slots = np.concatenate([slots, np.full(20, 1001, np.int32)])
    for n_servers in (1, 2, 3):
        prt = RoutingTable.uniform({"w": 1001}, n_servers)
        jrt = JaxRoutingTable.uniform({"w": 1001}, n_servers)
        assert prt.to_payload() == jrt.to_payload()
        for (ps, ppos, pids), (js, jpos, jids) in zip(
            prt.slice_ids("w", slots), jrt.slice_ids("w", slots)
        ):
            assert ps == js
            np.testing.assert_array_equal(ppos, jpos)
            np.testing.assert_array_equal(pids, jids)
        for (ps, pseg, plocal), (js, jseg, jlocal) in zip(
            RangePartition(1001, n_servers).slice_ids(slots),
            JaxRangePartition(1001, n_servers).slice_ids(slots),
        ):
            assert (ps, pseg) == (js, jseg)
            np.testing.assert_array_equal(plocal, jlocal)
    data = dict(key_space=1 << 20, batch_size=64, seed=3, informative=0.1)
    pdata, jdata = SyntheticCTR(**data), JaxSyntheticCTR(**data)
    for _ in range(2):
        (pk, pl), (jk, jl) = pdata.next_batch(), jdata.next_batch()
        np.testing.assert_array_equal(pk, jk)
        np.testing.assert_array_equal(pl, jl)
    labels = rng.integers(0, 2, size=200).astype(np.float32)
    scores = np.round(rng.normal(size=200), 1)  # ties exercise rank averaging
    assert auc(labels, scores) == jax_auc(labels, scores)


def test_push_device_equals_wire_push_bitwise():
    """Device-resident value planes (push_device over the Loopback plane)
    and wire numpy planes reach the tables as the same bytes."""
    _, pcfgs = _cfgs(300, 4, dict(kind="adagrad", learning_rate=0.1))
    keys = (np.arange(90, dtype=np.uint64) * 31) % 500
    grads = np.random.default_rng(9).normal(size=(90, 4)).astype(np.float32)
    shards = []
    for device_plane in (False, True):
        van, servers, (worker,) = _cluster(False, pcfgs, 2)
        try:
            if device_plane:
                ts = worker.push_device("e", keys, torch.from_numpy(grads))
            else:
                ts = worker.push("e", keys, grads)
            assert worker.wait(ts, timeout=60)
            shards.append([s.export_shard()["e"]["value"] for s in servers])
            assert sum(s.pushes for s in servers) == 2
        finally:
            van.close()
    for a, b in zip(*shards):
        np.testing.assert_array_equal(a, b)


def test_wrong_routing_epoch_is_fenced_not_applied():
    from parameter_server_tpu_torch.kv.routing import FENCED_KEY, ROUTING_KEY

    _, pcfgs = _cfgs(64, 1, dict(kind="sgd"))
    van, (srv,), _ = _cluster(False, pcfgs, 1)
    try:
        msg = Message(
            task=Task(TaskKind.PUSH, "kv", payload={"table": "e", "__repoch__": 3}),
            sender="W0", recver="S0", keys=np.arange(4, dtype=np.int32),
            values=[np.ones((4, 1), np.float32)],
        )
        reply = srv.handle_request(msg)
        assert reply.task.payload[FENCED_KEY] is True
        assert reply.task.payload[ROUTING_KEY]["epoch"] == 0
        assert "__error__" in reply.task.payload
        assert srv.fenced_rejects == 1 and srv.pushes == 0
        assert not srv.export_shard()["e"]["value"].any()
        assert msg.task.payload == {"table": "e", "__repoch__": 3}  # copy-on-write
    finally:
        van.close()
