"""The port's elasticity plane against the JAX package's, on the CPU.

Ports of ``tests/test_elastic.py`` (a worker killed mid-run, a server lost
and rebuilt from its checkpoint, dead-server pulls that raise, sparse and
dense) and of the cases other reference files deferred to the manager and
the elastic trainer:

- a 1-worker ``ElasticTrainer`` trajectory against the JAX trainer's;
- ``test_durability.py::test_elastic_auto_mode_picks_the_right_plane``;
- ``test_consistency.py``'s elastic announce-and-retune case;
- ``test_restart.py::test_full_restart_lifecycle_with_scheduler`` on a
  ``LoopbackVan``;
- ``test_migration.py``'s monitor-driven rebalance under Zipfian skew, the
  scheduler's ROUTING broadcast and the migration counters in one
  ``CounterGroup``;
- ``AutoscalePolicy`` decisions against the JAX policy's over seeded views.

And the trainer-level runs the card's ``elastic`` phase drives, each equal
to a control run with no event, bit for bit: a primary killed by missed
heartbeats and promoted by ``ReplicaSet(manager=)``, and ``scale_up`` then
``drain_down`` with the scheduler broadcasting each routing table.

Tolerances: within the port bit for bit; against the JAX package rtol =
atol = 1e-4 for loss trajectories and 1e-5 for tables, as in
``test_torch_replica.py``; host state (rebalance moves, counters,
autoscale intents) equal.
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parameter_server_tpu import config as jax_config
from parameter_server_tpu.core import manager as jax_manager
from parameter_server_tpu.core.fleet import FleetMonitor as JaxFleetMonitor
from parameter_server_tpu.core.netmon import MeteredVan as JaxMeteredVan
from parameter_server_tpu.core.postoffice import Postoffice as JaxPostoffice
from parameter_server_tpu.core.van import LoopbackVan as JaxLoopbackVan
from parameter_server_tpu.kv.migrate import ShardMigrator as JaxShardMigrator
from parameter_server_tpu.kv.server import KVServer as JaxKVServer
from parameter_server_tpu.kv.worker import KVWorker as JaxKVWorker
from parameter_server_tpu.learner import elastic as jax_elastic
from parameter_server_tpu.models import linear as jax_linear
from parameter_server_tpu.utils.metrics import CounterGroup as JaxCounterGroup
from parameter_server_tpu_torch import checkpoint
from parameter_server_tpu_torch import config as port_config
from parameter_server_tpu_torch.config import (
    CheckpointConfig,
    ConsistencyConfig,
    ConsistencyMode,
    OptimizerConfig,
    TableConfig,
)
from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.fleet import FleetMonitor
from parameter_server_tpu_torch.core.manager import launch_local_cluster
from parameter_server_tpu_torch.core.messages import server_id, worker_id
from parameter_server_tpu_torch.core.netmon import MeteredVan
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
from parameter_server_tpu_torch.kv import replica as replica_lib
from parameter_server_tpu_torch.kv.consistency import BoundTuner
from parameter_server_tpu_torch.kv.dense import DenseKVServer, DenseKVWorker
from parameter_server_tpu_torch.kv.migrate import ShardMigrator
from parameter_server_tpu_torch.kv.routing import RoutingTable
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.learner import elastic
from parameter_server_tpu_torch.models import linear
from parameter_server_tpu_torch.utils.keys import HashLocalizer
from parameter_server_tpu_torch.utils.metrics import CounterGroup

ROWS = 1 << 10
TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)
ASP = ConsistencyConfig(mode=ConsistencyMode.ASP)


def _table_cfgs(cfg=port_config, rows=ROWS, consistency=None):
    return {"w": cfg.TableConfig(
        name="w", rows=rows, dim=1,
        optimizer=cfg.OptimizerConfig(kind="adagrad", learning_rate=0.1),
        consistency=consistency,
    )}


def _shards(n_shards, batches_per_shard=2, batch=64, key_space=5000, seed=0):
    data = SyntheticCTR(key_space=key_space, nnz=8, batch_size=batch, seed=seed)
    return [[data.next_batch() for _ in range(batches_per_shard)] for _ in range(n_shards)]


def _close(van, servers):
    van.close()
    for s in servers:
        if getattr(s, "ledger", None) is not None:
            s.ledger.close()


def _assemble(routing, servers_by_index, table="w"):
    """The full ``[rows, dim]`` value and optimizer state, stitched per
    segment from each owner's ``export_range``."""
    tr = routing.tables[table]
    value, state = None, None
    for i, owner in enumerate(tr.owners):
        lo, hi = int(tr.offsets[i]), int(tr.offsets[i + 1])
        v, st = servers_by_index[owner].export_range(table, lo, hi)
        v, st = np.asarray(v), {k: np.asarray(a) for k, a in st.items()}
        if value is None:
            value = np.zeros((tr.rows,) + v.shape[1:], v.dtype)
            state = {k: np.zeros((tr.rows,) + a.shape[1:], a.dtype) for k, a in st.items()}
        value[lo:hi] = v
        for k, a in st.items():
            state[k][lo:hi] = a
    return value, state


def _on_done(trainer, fn):
    """Call ``fn(num_done)`` on the finishing worker's thread after each
    workload that counted — between workloads, so a 1-worker run is
    deterministic around the event."""
    finish = trainer.pool.finish

    def hooked(worker, workload_id):
        ok = finish(worker, workload_id)
        if ok:
            fn(trainer.pool.num_done())
        return ok

    trainer.pool.finish = hooked


def _settle(predicate, deadline_s=10.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


# ------------------------------------------------- ports of test_elastic.py


def _kv_cluster(posts, num_workers, num_servers, rows=2000):
    cfgs = _table_cfgs(rows=rows)
    loc = {"w": HashLocalizer(rows)}
    servers = {server_id(i): KVServer(posts[server_id(i)], cfgs, i, num_servers, device="cpu")
               for i in range(num_servers)}
    workers = {worker_id(i): KVWorker(posts[worker_id(i)], cfgs, num_servers, localizers=loc,
                                      min_bucket=16, device="cpu")
               for i in range(num_workers)}
    return cfgs, servers, workers, loc


def test_worker_death_reassigns_and_completes():
    """Kill one of three workers mid-run; the survivors finish every
    workload, the victim is detected dead and no other node ever is."""
    van = LoopbackVan()
    servers = {}
    try:
        sched, managers, posts = launch_local_cluster(van, num_workers=3, num_servers=2,
                                                      heartbeat_timeout=2.0)
        deaths = []
        sched.on_node_dead.append(deaths.append)
        cfgs, servers, workers, _ = _kv_cluster(posts, 3, 2)
        trainer = elastic.ElasticTrainer(workers, sched, _shards(12), ASP, managers=managers,
                                         heartbeat_interval=0.05, timeout=20.0, device="cpu")
        done, result = threading.Event(), {}

        def run():
            result["losses"] = trainer.run()
            done.set()

        t = threading.Thread(target=run)
        t.start()
        deadline = time.monotonic() + 30
        while trainer.pool.num_done() < 2 and time.monotonic() < deadline:
            time.sleep(0.01)
        victim = worker_id(2)
        trainer.kill(victim)
        van.disconnect(victim)
        t.join(timeout=60)
        assert done.is_set(), f"run incomplete: {trainer.pool.num_done()}/{len(trainer.pool)}"
        assert trainer.pool.all_done()
        # detection is asynchronous to completion: the survivors keep beating
        # (the trainer's heartbeat thread ended with the run) while the
        # scheduler sweeps, until it fires
        def sweep():
            for nid, mgr in managers.items():
                if nid not in ("H", victim):
                    mgr.send_heartbeat()
            sched.check_heartbeats()
            return not sched.is_alive(victim)

        assert _settle(sweep)
        assert deaths == [victim]
        completed_by = {w.completed_by for w in trainer.pool._workloads.values()}
        assert completed_by <= {worker_id(0), worker_id(1), victim}
        assert len(result["losses"]) >= 24  # every batch trained at least once
    finally:
        _close(van, servers.values())


def test_server_death_recovery_from_checkpoint(tmp_path):
    """Lose a server shard; rebuild it from the last committed checkpoint:
    bitwise the checkpoint's rows, and a push moves them."""
    root = str(tmp_path)
    van = LoopbackVan()
    servers = {}
    try:
        sched, managers, posts = launch_local_cluster(van, num_workers=2, num_servers=2,
                                                      heartbeat_timeout=30)
        cfgs, servers, workers, loc = _kv_cluster(posts, 2, 2)
        trainer = elastic.ElasticTrainer(workers, sched, _shards(6), ASP, managers=managers,
                                         ckpt_root=root, ckpt_every=2, timeout=20.0,
                                         device="cpu")
        trainer.run()
        assert trainer.last_ckpt_step is not None
        assert checkpoint.latest_snapshot(root) is None  # uniform layout: legacy plane
        w0 = workers[worker_id(0)]
        probe = np.arange(100, dtype=np.uint64) * 31
        dead = server_id(1)
        van.disconnect(dead)  # S1's state is gone
        with pytest.raises((RuntimeError, TimeoutError)):
            w0.pull_sync("w", probe, timeout=2)
        van.unbind(dead)
        van.reconnect(dead)
        servers[dead].ledger.close()
        servers[dead] = elastic.recover_server(
            lambda: KVServer(Postoffice(dead, van), cfgs, 1, 2, device="cpu"), root)
        after = w0.pull_sync("w", probe, timeout=10)
        full = checkpoint.load_global_weights(root, checkpoint.latest_step(root), "w")
        slots = loc["w"].assign(probe)
        on_s1 = slots >= int(servers[dead].partitions["w"].offsets[1])
        assert on_s1.any()
        np.testing.assert_array_equal(after[on_s1], full[slots[on_s1], 0])
        assert w0.wait(w0.push("w", probe, np.ones((100, 1), np.float32)), timeout=10)
        assert np.abs(w0.pull_sync("w", probe, timeout=10) - after).max() > 1e-4
    finally:
        _close(van, servers.values())


def test_dead_server_pull_raises_not_zeros():
    van = LoopbackVan()
    cfgs = {"w": TableConfig(name="w", rows=100, dim=1, optimizer=OptimizerConfig(kind="sgd"))}
    servers = [KVServer(Postoffice(server_id(i), van), cfgs, i, 2, device="cpu")
               for i in range(2)]
    try:
        worker = KVWorker(Postoffice("W0", van), cfgs, 2, min_bucket=16, device="cpu")
        keys = np.arange(50, dtype=np.uint64)
        worker.pull_sync("w", keys, timeout=10)  # a healthy pull works
        van.disconnect(server_id(0))
        with pytest.raises((RuntimeError, TimeoutError)):
            worker.pull_sync("w", keys, timeout=2)
    finally:
        _close(van, servers)


def test_dense_dead_server_pull_raises_not_zeros():
    van = LoopbackVan()
    try:
        opt = OptimizerConfig(kind="sgd", learning_rate=1.0)
        for i in range(2):
            DenseKVServer(Postoffice(server_id(i), van), {"m": (100, opt)}, i, 2, device="cpu")
        worker = DenseKVWorker(Postoffice("W0", van), {"m": 100}, 2, device="cpu")
        assert tuple(worker.pull_sync("m", timeout=10).shape) == (100,)
        van.disconnect(server_id(1))
        with pytest.raises((RuntimeError, TimeoutError)):
            worker.pull_sync("m", timeout=2)
    finally:
        van.close()


# ---------------------------------------------- 1-worker trajectory vs JAX


def _one_worker_run(pkg, shards):
    if pkg == "port":
        mod, van, post_cls = elastic, LoopbackVan(), Postoffice
        launch, cfgs = launch_local_cluster, _table_cfgs()
        make_server = lambda p, s: KVServer(p, cfgs, s, 2, device="cpu")  # noqa: E731
        make_worker = lambda p: KVWorker(p, cfgs, 2, device="cpu")  # noqa: E731
        kw = {"device": "cpu"}
    else:
        mod, van, post_cls = jax_elastic, JaxLoopbackVan(), JaxPostoffice
        launch, cfgs = jax_manager.launch_local_cluster, _table_cfgs(jax_config)
        make_server = lambda p, s: JaxKVServer(p, cfgs, s, 2)  # noqa: E731
        make_worker = lambda p: JaxKVWorker(p, cfgs, 2)  # noqa: E731
        kw = {}
    servers = {}
    try:
        sched, managers, posts = launch(van, num_workers=1, num_servers=2, heartbeat_timeout=30)
        servers = {s: make_server(posts[server_id(s)], s) for s in range(2)}
        worker = make_worker(posts["W0"])
        ccfg = (ASP if pkg == "port"
                else jax_config.ConsistencyConfig(mode=jax_config.ConsistencyMode.ASP))
        trainer = mod.ElasticTrainer({"W0": worker}, sched, shards, ccfg, managers=managers,
                                     heartbeat_interval=0.05, timeout=30.0, **kw)
        losses = trainer.run()
        return losses, _assemble(worker.routing, servers), worker.counters()
    finally:
        _close(van, servers.values() if pkg == "port" else [])


def test_one_worker_trajectory_matches_jax():
    shards = _shards(4, key_space=4 * ROWS, batch=128, seed=3)
    losses, (value, state), _ = _one_worker_run("port", shards)
    again, (value2, state2), _ = _one_worker_run("port", shards)
    assert losses == again and np.array_equal(value, value2)  # the port repeats bitwise
    j_losses, (j_value, j_state), _ = _one_worker_run("jax", shards)
    assert len(losses) == 8
    np.testing.assert_allclose(losses, j_losses, **TRAJ_TOL)
    np.testing.assert_allclose(value, j_value, **TOL)
    np.testing.assert_allclose(state["sum_sq"], j_state["sum_sq"], **TOL)


# ------------------------------------------------- checkpoint plane choice


def _auto_mode_verdicts(pkg, root):
    if pkg == "port":
        van, cfgs = LoopbackVan(), _table_cfgs()
        servers = [KVServer(Postoffice(server_id(s), van), cfgs, s, 2, device="cpu")
                   for s in range(2)]
        worker = KVWorker(Postoffice("W0", van), cfgs, 2, device="cpu")
        mod, ckpt_cls, mig_cls, post_cls = elastic, CheckpointConfig, ShardMigrator, Postoffice
    else:
        van, cfgs = JaxLoopbackVan(), _table_cfgs(jax_config)
        servers = [JaxKVServer(JaxPostoffice(server_id(s), van), cfgs, s, 2) for s in range(2)]
        worker = JaxKVWorker(JaxPostoffice("W0", van), cfgs, 2)
        mod, ckpt_cls = jax_elastic, jax_config.CheckpointConfig
        mig_cls, post_cls = JaxShardMigrator, JaxPostoffice
    try:
        trainer = mod.ElasticTrainer.__new__(mod.ElasticTrainer)
        trainer.ckpt_root = str(root / "a")
        trainer.ckpt_config = ckpt_cls(mode="auto")
        got = [trainer._use_partitioned(worker)]  # uniform, no chain: legacy
        worker.save_snapshot(trainer.ckpt_root, 1)
        got.append(trainer._use_partitioned(worker))  # a chain is extended
        for mode in ("legacy", "partitioned"):
            trainer.ckpt_config = ckpt_cls(mode=mode)  # explicit modes win
            got.append(trainer._use_partitioned(worker))
        trainer.ckpt_config = ckpt_cls(mode="auto")
        trainer.ckpt_root = str(root / "fresh")
        mig = mig_cls(post_cls("M0", van), chunk_rows=128)
        assert worker.adopt_routing(mig.migrate(worker.routing, "w", 900, ROWS, 0))
        got.append(trainer._use_partitioned(worker))  # a migrated layout
        return got
    finally:
        _close(van, servers if pkg == "port" else [])


def test_elastic_auto_mode_picks_the_right_plane(tmp_path):
    got = _auto_mode_verdicts("port", tmp_path / "port")
    assert got == [False, True, False, True, True]
    assert got == _auto_mode_verdicts("jax", tmp_path / "jax")


# --------------------------------------------- consistency announce + retune


def test_elastic_trainer_announces_and_retunes():
    """On a wire-gated table every worker is registered with the servers'
    fleet clocks before training, and a BoundTuner's wire-bottleneck
    verdict widens the bound fleet-wide mid-run."""
    flightrec.configure(enabled=True, clear=True)
    van = LoopbackVan()
    servers = {}
    try:
        sched, managers, posts = launch_local_cluster(van, num_workers=2, num_servers=2,
                                                      heartbeat_timeout=5.0)
        ccfg = ConsistencyConfig(mode=ConsistencyMode.SSP, max_delay=2)
        cfgs = _table_cfgs(rows=2000, consistency=ccfg)
        loc = {"w": HashLocalizer(2000)}
        servers = {server_id(i): KVServer(posts[server_id(i)], cfgs, i, 2, device="cpu")
                   for i in range(2)}
        workers = {worker_id(i): KVWorker(posts[worker_id(i)], cfgs, 2, localizers=loc,
                                          min_bucket=16, device="cpu")
                   for i in range(2)}
        tuner = BoundTuner(ccfg, min_bound=1, max_bound=16)
        trainer = elastic.ElasticTrainer(workers, sched, _shards(6), ccfg, managers=managers,
                                         bound_tuner=tuner, wire_bottleneck=lambda: True,
                                         retune_interval_s=0.0, timeout=30.0, device="cpu")
        assert trainer.run()
        for sid, s in servers.items():
            c = s.counters()
            assert c["consist_clock_size"] == 2, (sid, c)
            assert c["consist_bound"] > ccfg.max_delay, (sid, c)
        retunes = [e for e in flightrec.get().events() if e["kind"] == "consist.retune"]
        assert retunes and "widen" in retunes[0]["why"]
        assert tuner.retunes >= 1
    finally:
        _close(van, servers.values())


# ------------------------------- trainer-level events against a control run


SHARDS = 6


def _control_run(shards):
    """The fixed 2-server run the event runs are held to."""
    van = LoopbackVan()
    servers = {}
    try:
        sched, managers, posts = launch_local_cluster(van, num_workers=1, num_servers=2,
                                                      heartbeat_timeout=30)
        cfgs = _table_cfgs()
        servers = {s: KVServer(posts[server_id(s)], cfgs, s, 2, device="cpu") for s in range(2)}
        worker = KVWorker(posts["W0"], cfgs, 2, device="cpu")
        trainer = elastic.ElasticTrainer({"W0": worker}, sched, shards, ASP, managers=managers,
                                         heartbeat_interval=0.05, timeout=30.0, device="cpu")
        losses = trainer.run()
        return losses, _assemble(worker.routing, servers), worker.counters()
    finally:
        _close(van, servers.values())


def _assert_same(run, control):
    (losses, (value, state), _), (c_losses, (c_value, c_state), _) = run, control
    assert losses == c_losses
    np.testing.assert_array_equal(value, c_value)
    for k in c_state:
        np.testing.assert_array_equal(state[k], c_state[k])


def test_heartbeat_death_promotes_standby_mid_training_equal_to_control():
    """A 1-worker ``ElasticTrainer`` over sync replica chains: S0 stops
    beating and is disconnected between workloads; the scheduler's monitor
    finds it silent and ``ReplicaSet(manager=)`` promotes its standby.  The
    losses, rows and optimizer state equal the control run's bit for bit,
    and S0 is the only node ever reported dead."""
    shards = _shards(SHARDS, key_space=4 * ROWS, batch=128, seed=3)
    control = _control_run(shards)
    van = LoopbackVan()
    primaries, standbys = [], []
    try:
        sched, managers, posts = launch_local_cluster(van, num_workers=1, num_servers=2,
                                                      heartbeat_timeout=2.0)
        deaths = []
        sched.on_node_dead.append(deaths.append)
        cfgs = _table_cfgs()
        primaries, standbys = replica_lib.make_replicated_servers(van, cfgs, 2, sync=True,
                                                                  device="cpu", posts=posts)
        assert primaries[0].post is posts["S0"]
        rset = replica_lib.ReplicaSet(van, standbys, manager=sched)
        worker = KVWorker(posts["W0"], cfgs, 2, device="cpu")
        trainer = elastic.ElasticTrainer({"W0": worker}, sched, shards, ASP, managers=managers,
                                         heartbeat_interval=0.05, timeout=30.0, device="cpu")

        def event(n):
            if n == 2:
                trainer.kill("S0")  # its beats stop
                van.disconnect("S0")  # the primary process dies
                assert _settle(lambda: 0 in rset.promoted), "never promoted"

        _on_done(trainer, event)
        losses = trainer.run()
        by_index = {0: rset.promoted[0], 1: primaries[1]}
        run = (losses, _assemble(worker.routing, by_index), worker.counters())
        _assert_same(run, control)
        assert deaths == ["S0"] and not sched.is_alive("S0")
    finally:
        _close(van, primaries + standbys)


class _CommitGate:
    """Holds every ``migrate_commit`` of a migrator until :meth:`release`:
    chunks stream while the worker trains a workload, and the commit lands
    between two workloads."""

    def __init__(self, migrator):
        self.rpc, self.open, self.commits = migrator._rpc, threading.Event(), 0
        migrator._rpc = self._rpc

    def _rpc(self, recver, payload):
        if payload["op"] == "migrate_commit":
            assert self.open.wait(60), "commit never released"
            self.commits += 1
        return self.rpc(recver, payload)

    def release(self):
        self.open.set()


def test_scale_up_then_drain_down_in_trainer_equal_to_control():
    """A 1-worker ``ElasticTrainer``: ``scale_up`` onto S2 streams while the
    4th workload trains and commits after it, ``drain_down`` of S1 likewise
    over the 5th; the scheduler broadcasts each table and the worker adopts
    it through ``Manager.on_routing``.  The trajectory, the rows and the
    optimizer state equal the fixed 2-server run's bit for bit, with as many
    push retries (no fence on the wire), and pushes in the moving ranges
    rode each commit's delta."""
    shards = _shards(SHARDS, key_space=4 * ROWS, batch=128, seed=3)
    control = _control_run(shards)
    flightrec.configure(enabled=True, clear=True)
    van = LoopbackVan()
    servers = {}
    try:
        sched, managers, posts = launch_local_cluster(van, num_workers=1, num_servers=2,
                                                      heartbeat_timeout=30)
        deaths = []
        sched.on_node_dead.append(deaths.append)
        cfgs = _table_cfgs()
        servers = {s: KVServer(posts[server_id(s)], cfgs, s, 2, device="cpu") for s in range(2)}
        worker = KVWorker(posts["W0"], cfgs, 2, device="cpu")
        managers["W0"].on_routing.append(worker.adopt_routing)
        mig = ShardMigrator(Postoffice("M0", van), chunk_rows=64)
        trainer = elastic.ElasticTrainer({"W0": worker}, sched, shards, ASP, managers=managers,
                                         heartbeat_interval=0.05, timeout=30.0, device="cpu")
        state = {}

        def start(name, fn):
            gate = _CommitGate(mig)
            t = threading.Thread(target=lambda: state.__setitem__(name, fn()))
            t.start()
            return gate, t

        def finish(gate, t):
            gate.release()
            t.join(60)
            mig._rpc = gate.rpc
            assert gate.commits >= 1
            epoch = sched.routing.epoch
            assert _settle(lambda: worker.routing.epoch == epoch), "broadcast not adopted"

        def event(n):
            if n == SHARDS // 2:
                state["up"] = start("scaled", lambda: elastic.scale_up(
                    van, cfgs, worker.routing, 2, migrator=mig, num_servers=3, sched=sched,
                    device="cpu"))
            elif n == SHARDS // 2 + 1:
                finish(*state["up"])
                servers[2], routing = state["scaled"]
                assert routing.tables["w"].server_rows(2) > 0
                state["down"] = start("drained", lambda: elastic.drain_down(
                    van, routing, 1, migrator=mig, sched=sched))
            elif n == SHARDS // 2 + 2:
                finish(*state["down"])

        _on_done(trainer, event)
        losses = trainer.run()
        routing = state["drained"]
        assert 1 not in routing.servers() and "S1" not in van._endpoints
        assert worker.routing.epoch == routing.epoch == sched.routing.epoch
        run = (losses, _assemble(routing, servers), worker.counters())
        _assert_same(run, control)
        assert run[2]["push_retries"] == control[2]["push_retries"]
        commits = [e for e in flightrec.get().events() if e["kind"] == "migrate.commit"]
        assert len(commits) == 2 and all(e["dirty"] > 0 for e in commits)
        assert deaths == []
    finally:
        _close(van, servers.values())


# ---------------------------------------------- restart with the scheduler


def test_full_restart_lifecycle_with_scheduler():
    """``restart_server``: crash S0, restore it from its standby and
    re-register; the scheduler bumps the incarnation, keeps the range, and
    the worker keeps training against the same identity with zero loss."""
    data = SyntheticCTR(key_space=4 * ROWS, nnz=8, batch_size=128, seed=3)
    batches = [data.next_batch() for _ in range(12)]

    def train(worker, on_step=None):
        losses = []
        for i, (keys, labels) in enumerate(batches):
            w_pos = worker.pull_sync("w", keys, timeout=30)
            g, _gb, loss = linear.grad_rows(torch.from_numpy(w_pos), torch.from_numpy(labels))
            worker.push_sync("w", keys, g.numpy() / labels.shape[0], timeout=30)
            losses.append(float(loss))
            if on_step is not None:
                on_step(i)
        return losses

    cfgs = _table_cfgs()
    van = LoopbackVan()
    ref = [KVServer(Postoffice(f"S{s}", van), cfgs, s, 2, device="cpu") for s in range(2)]
    try:
        ref_losses = train(KVWorker(Postoffice("W0", van), cfgs, 2, device="cpu"))
    finally:
        _close(van, ref)
    van = LoopbackVan()
    servers = []
    try:
        sched, _managers, posts = launch_local_cluster(van, num_workers=1, num_servers=2,
                                                       heartbeat_timeout=30)
        standbys = [KVServer(Postoffice(f"R{s}", van), cfgs, s, 2, device="cpu")
                    for s in range(2)]
        servers = standbys + [KVServer(posts[f"S{s}"], cfgs, s, 2, replica=f"R{s}",
                                       replica_sync=True, device="cpu") for s in range(2)]
        before = next(n for n in sched.nodes() if n.node_id == "S0")
        worker = KVWorker(posts["W0"], cfgs, 2, device="cpu")
        restarted = {}

        def on_step(i):
            if i == 6:
                van.unbind("S0")
                van.unbind("S0.fw")
                restarted["got"] = elastic.restart_server(
                    van, cfgs, 0, 2, num_workers=1, standby=standbys[0], heartbeat_timeout=30,
                    device="cpu")

        losses = train(worker, on_step)
        assert losses == ref_losses
        server, source, mgr = restarted["got"]
        servers.append(server)
        assert source == "replica" and mgr is not None
        row = next(n for n in sched.nodes() if n.node_id == "S0")
        assert row.incarnation == 1 and row.alive
        assert (row.range_begin, row.range_end) == (before.range_begin, before.range_end)
    finally:
        _close(van, servers)


# ------------------------------------------------------ monitor rebalance


def _keys_hashing_into(lo, hi, count):
    """Raw keys whose HashLocalizer slot lands in global rows [lo, hi)."""
    loc = HashLocalizer(ROWS)
    out, start = [], 0
    while len(out) < count:
        cand = np.arange(start, start + 4096, dtype=np.uint64)
        slots = loc.assign(cand)
        out.extend(cand[(slots >= lo) & (slots < hi)].tolist())
        start += 4096
    return np.asarray(out[:count], dtype=np.int64)


def _skewed_batches(steps=12):
    rs = np.random.RandomState(7)
    hot = _keys_hashing_into(896, ROWS, 96)  # inside S1's tail half
    cold = rs.randint(0, 4 * ROWS, size=4096).astype(np.int64)
    out = []
    for _ in range(steps):
        pick = rs.rand(128, 8) < 0.85
        keys = np.where(pick, hot[rs.randint(0, hot.size, size=(128, 8))],
                        cold[rs.randint(0, cold.size, size=(128, 8))])
        out.append((keys, rs.randint(0, 2, size=128).astype(np.float32)))
    return out


def _rebalance_run(pkg, batches, rebalance):
    if pkg == "port":
        van, cfgs = MeteredVan(LoopbackVan()), _table_cfgs()
        servers = {s: KVServer(Postoffice(f"S{s}", van), cfgs, s, 2, device="cpu")
                   for s in range(2)}
        worker = KVWorker(Postoffice("W0", van), cfgs, 2, device="cpu")
        mig = ShardMigrator(Postoffice("M0", van), chunk_rows=256)
        monitor, mod = FleetMonitor(), elastic

        def grad(w_pos, labels):
            g, _gb, loss = linear.grad_rows(torch.from_numpy(w_pos), torch.from_numpy(labels))
            return g.numpy(), float(loss)
    else:
        van, cfgs = JaxMeteredVan(JaxLoopbackVan()), _table_cfgs(jax_config)
        servers = {s: JaxKVServer(JaxPostoffice(f"S{s}", van), cfgs, s, 2) for s in range(2)}
        worker = JaxKVWorker(JaxPostoffice("W0", van), cfgs, 2)
        mig = JaxShardMigrator(JaxPostoffice("M0", van), chunk_rows=256)
        monitor, mod = JaxFleetMonitor(), jax_elastic

        def grad(w_pos, labels):
            g, _gb, loss = jax_linear.grad_rows(jnp.asarray(w_pos), jnp.asarray(labels))
            return np.asarray(g), float(loss)
    policy = mod.RebalancePolicy(monitor, mig, config=mod.RebalanceConfig(hot_share=0.6))
    state = {"routing": worker.routing, "at_move": None}
    losses = []
    try:
        for i, (keys, labels) in enumerate(batches):
            g, loss = grad(worker.pull_sync("w", keys, timeout=60), labels)
            worker.push_sync("w", keys, g / labels.shape[0], timeout=60)
            losses.append(loss)
            if rebalance and state["at_move"] is None:
                monitor.observe("W0", {"links": van.links()})
                routing, moved = policy.maybe_rebalance(state["routing"])
                if moved:
                    state["routing"] = routing
                    state["at_move"] = (i, monitor.inbound_totals())
                    assert worker.adopt_routing(routing)
        monitor.observe("W0", {"links": van.links()})
        table = _assemble(state["routing"], servers)
        return (losses, table, sum(s.pushes for s in servers.values()), policy.moves,
                state["at_move"], monitor.inbound_totals())
    finally:
        _close(van, servers.values() if pkg == "port" else [])


def test_zipfian_skew_triggers_rebalance_with_parity():
    """A Zipf-hot workload concentrates inbound bytes on S1; the
    FleetMonitor -> RebalancePolicy loop splits the hot range off mid-run.
    Nothing lost or applied twice (the trajectory, applied pushes and table
    equal the run without a rebalance), the hot server's inbound share
    falls, and the moves equal the JAX policy's."""
    batches = _skewed_batches()
    ref_losses, (ref_value, ref_state), ref_pushes, *_ = _rebalance_run("port", batches, False)
    losses, (value, state), pushes, moves, at_move, totals_end = _rebalance_run(
        "port", batches, True)
    assert at_move is not None and at_move[0] < len(batches) - 2
    assert moves and moves[0]["frm"] == 1 and moves[0]["share"] >= 0.6
    assert losses == ref_losses and pushes == ref_pushes
    np.testing.assert_array_equal(value, ref_value)
    np.testing.assert_array_equal(state["sum_sq"], ref_state["sum_sq"])

    def share(a, b):
        delta = {s: b.get(f"S{s}", {}).get("bytes", 0) - a.get(f"S{s}", {}).get("bytes", 0)
                 for s in range(2)}
        return delta[1] / max(sum(delta.values()), 1)

    before, after = share({}, at_move[1]), share(at_move[1], totals_end)
    assert before > 0.6 and after < before - 0.2
    j_losses, (j_value, _), _, j_moves, j_at, _ = _rebalance_run("jax", batches, True)
    assert moves == j_moves and at_move[0] == j_at[0]
    np.testing.assert_allclose(losses, j_losses, **TRAJ_TOL)
    np.testing.assert_allclose(value, j_value, **TOL)


# ----------------------------------------------------- scheduler broadcast


def test_scheduler_routing_broadcast_reaches_managers_and_workers():
    """``Manager.set_routing``: peers store the table, fire ``on_routing``,
    and a wired worker adopts eagerly; a stale (lower-epoch) broadcast is
    ignored everywhere."""
    van = LoopbackVan()
    try:
        sched, managers, posts = launch_local_cluster(van, num_workers=1, num_servers=2,
                                                      heartbeat_timeout=30)
        cfgs = _table_cfgs()
        worker = KVWorker(posts["W0"], cfgs, 2, device="cpu")
        managers["W0"].on_routing.append(worker.adopt_routing)
        rt = RoutingTable.uniform(cfgs, 2).move("w", 768, ROWS, 0)
        sched.set_routing(rt)
        assert _settle(lambda: worker.routing.epoch == rt.epoch, 5)
        assert worker.routing.tables["w"] == rt.tables["w"]
        assert managers["W0"].routing.epoch == rt.epoch
        assert all(managers[s].routing.epoch == rt.epoch for s in ("S0", "S1"))
        sched.routing = None
        sched.set_routing(RoutingTable.uniform(cfgs, 2))
        time.sleep(0.1)
        assert worker.routing.epoch == rt.epoch
    finally:
        van.close()


def _counter_group_run(pkg):
    if pkg == "port":
        van, cfgs = LoopbackVan(), _table_cfgs()
        servers = [KVServer(Postoffice(f"S{s}", van), cfgs, s, 2, device="cpu")
                   for s in range(2)]
        worker = KVWorker(Postoffice("W0", van), cfgs, 2, device="cpu")
        mig, group_cls = ShardMigrator(Postoffice("M0", van), chunk_rows=128), CounterGroup
    else:
        van, cfgs = JaxLoopbackVan(), _table_cfgs(jax_config)
        servers = [JaxKVServer(JaxPostoffice(f"S{s}", van), cfgs, s, 2) for s in range(2)]
        worker = JaxKVWorker(JaxPostoffice("W0", van), cfgs, 2)
        mig = JaxShardMigrator(JaxPostoffice("M0", van), chunk_rows=128)
        group_cls = JaxCounterGroup
    try:
        group = group_cls(*servers, worker, mig)
        new_routing = mig.migrate(worker.routing, "w", 768, ROWS, 0)
        keys = _keys_hashing_into(768, ROWS, 8)  # a stale push: fenced, then re-applied
        worker.push_sync("w", keys, np.ones(keys.size, np.float32), timeout=60)
        assert worker.routing.epoch == new_routing.epoch
        got = group.counters()
        return {k: got[k] for k in ("rows_migrated_out", "rows_migrated_in", "fenced_rejects",
                                    "refresh_retries", "rows_moved", "migrations",
                                    "push_retries")}, got["migration_freeze_s"]
    finally:
        _close(van, servers if pkg == "port" else [])


def test_migration_counters_merge_into_counter_group():
    got, freeze = _counter_group_run("port")
    assert got["rows_migrated_out"] == 256 and got["rows_migrated_in"] >= 256
    assert got["fenced_rejects"] > 0 and got["refresh_retries"] > 0
    assert got["rows_moved"] == 256 and got["migrations"] == 1 and freeze > 0.0
    assert got == _counter_group_run("jax")[0]


# ------------------------------------------------------------- autoscaling


def _views(seed, ticks=120):
    rng = np.random.default_rng(seed)
    n = 4
    out = []
    for t in range(ticks):
        n = int(np.clip(n + rng.integers(-1, 2) * (rng.random() < 0.1), 2, 16))
        breach = rng.random() < (0.6 if (t // 20) % 2 else 0.05)
        out.append((float(t) * 5.0, {
            f"S{i}": {"healthy": not (breach and rng.random() < 0.5),
                      "load": float(rng.gamma(2.0, 50.0))} for i in range(n)}))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
@pytest.mark.parametrize("cfg", [
    {},
    {"drain_below_load": 150.0, "down_after_ticks": 3, "cooldown_s": 10.0},
    {"max_servers": 5, "up_after_ticks": 1, "step_frac": 0.5, "cooldown_s": 0.0},
], ids=["default", "drain", "ceiling"])
def test_autoscale_policy_decisions_match_jax(seed, cfg):
    port = elastic.AutoscalePolicy(elastic.AutoscaleConfig(**cfg))
    ref = jax_elastic.AutoscalePolicy(jax_elastic.AutoscaleConfig(**cfg))
    for now, view in _views(seed):
        assert port.tick(now, view) == ref.tick(now, view)
    assert port.decisions == ref.decisions
    assert port.decisions  # the policy acted


@pytest.mark.parametrize("bad", [{"min_servers": 0}, {"max_servers": 1}, {"breach_frac_up": 0.0},
                                 {"up_after_ticks": 0}, {"step_frac": 0.0}, {"cooldown_s": -1}])
def test_autoscale_config_refuses_what_jax_refuses(bad):
    with pytest.raises(ValueError):
        elastic.AutoscaleConfig(**bad)
    with pytest.raises(ValueError):
        jax_elastic.AutoscaleConfig(**bad)
