"""The port's hot-replica chain against the JAX package's, on the CPU.

Ports of the JAX package's replica tests: a primary dies mid-run, its
standby is promoted, and training continues as if nothing happened — every
loss equal to an uninterrupted run of the port (sync chain; async after a
flush).  The sync chain acks after the standby applied; promotion keeps the
optimizer state; ``ReplicaSet.on_node_dead`` promotes.  Then the port's
loss trajectory, with the kill and the promotion, against the JAX
package's.

Then the same-id restart's restore cases: the legacy-checkpoint fallback
with its bounded rewind, and the restore preference replica > checkpoint >
cold, each beside the JAX package's run.

And the heartbeat-driven promotion: ``ReplicaSet(manager=)`` on the
scheduler's :class:`~parameter_server_tpu_torch.core.manager.Manager`
promotes when the sweep finds the primary silent, every loss equal to the
uninterrupted run's, beside the JAX package's same loop.

Then the same-id restart over ``ReliableVan(ChaosVan(LoopbackVan()))``
(twins of ``tests/test_restart.py``): S0 killed and restarted in place
twice under 5% drop, bitwise the clean run with exactly-once pushes; a
zombie's stale-incarnation frame fenced without an ACK; the seq space reset
on an incarnation advance; the scheduler's re-registration reaching every
endpoint's transport fence; the full lifecycle through
``learner.elastic.restart_server``; and a remote cancel dropping queued
work at the receiver.

Not ported here: forwarding over real sockets (the TCP van).

Tolerances: within the port exactly (the standby replays the same update
stream through the same apply); against the JAX package rtol = atol = 1e-4
(a 12-step loss trajectory in two frameworks).
"""

import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parameter_server_tpu import config as jax_config
from parameter_server_tpu.core.postoffice import Postoffice as JaxPostoffice
from parameter_server_tpu.core.van import LoopbackVan as JaxLoopbackVan
from parameter_server_tpu.data.synthetic import SyntheticCTR as JaxSyntheticCTR
from parameter_server_tpu.kv import replica as jax_replica
from parameter_server_tpu.kv.server import KVServer as JaxKVServer
from parameter_server_tpu.kv.worker import KVWorker as JaxKVWorker
from parameter_server_tpu.models import linear as jax_linear
from parameter_server_tpu_torch import config as port_config
from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.chaos import ChaosConfig, ChaosVan
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind
from parameter_server_tpu_torch.core.postoffice import Customer, Postoffice
from parameter_server_tpu_torch.core.resender import CRC_KEY, SEQ_KEY, ReliableVan, payload_crc32
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
from parameter_server_tpu_torch.kv import replica as replica_lib
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.models import linear

ROWS = 1 << 10
NUM_SERVERS = 2
STEPS = 12
KILL_AFTER = 6
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)


def _table_cfgs(cfg=port_config):
    return {"w": cfg.TableConfig(
        name="w", rows=ROWS, dim=1,
        optimizer=cfg.OptimizerConfig(kind="adagrad", learning_rate=0.1),
    )}


def _batches(synthetic=SyntheticCTR):
    data = synthetic(key_space=4 * ROWS, nnz=8, batch_size=128, seed=3)
    return [data.next_batch() for _ in range(STEPS)]


def _train(worker, batches, on_step=None) -> list:
    losses = []
    for i, (keys, labels) in enumerate(batches):
        w_pos = worker.pull_sync("w", keys, timeout=30)
        g, _gb, loss = linear.grad_rows(torch.from_numpy(w_pos),
                                        torch.from_numpy(labels.astype(np.float32)))
        ts = worker.push("w", keys, g.numpy() / labels.shape[0])
        assert worker.wait(ts, timeout=30)
        losses.append(float(loss))
        if on_step is not None:
            on_step(i)
    return losses


def _close(van, servers):
    van.close()
    for s in servers:
        if s.ledger is not None:
            s.ledger.close()


def _worker(van):
    return KVWorker(Postoffice("W0", van), _table_cfgs(), NUM_SERVERS, device="cpu")


def _reference_losses() -> list:
    van = LoopbackVan()
    servers = [KVServer(Postoffice(f"S{s}", van), _table_cfgs(), s, NUM_SERVERS, device="cpu")
               for s in range(NUM_SERVERS)]
    try:
        return _train(_worker(van), _batches())
    finally:
        _close(van, servers)


def _killed_run(sync: bool) -> list:
    van = LoopbackVan()
    primaries, standbys = replica_lib.make_replicated_servers(
        van, _table_cfgs(), NUM_SERVERS, sync=sync, max_lag=4, device="cpu")
    try:
        worker = _worker(van)

        def on_step(i):
            if i != KILL_AFTER - 1:
                return
            if not sync:
                # async chain: forwards may still be in flight; drain them
                # to model the lag window being clear at the failure instant
                primaries[0].flush_replica()
            van.unbind("S0")  # the primary dies
            replica_lib.promote(van, standbys[0], "S0")

        return _train(worker, _batches(), on_step=on_step)
    finally:
        _close(van, primaries + standbys)


@pytest.mark.parametrize("sync", [True, False], ids=["sync=True", "sync=False"])
def test_promoted_standby_continues_trajectory_exactly(sync):
    """Kill primary S0 mid-run, promote its standby, keep training: every
    loss equals the uninterrupted run's — no update lost (sync chain), or
    none after an explicit flush (async with bounded lag)."""
    flightrec.configure(enabled=True, clear=True)
    losses = _killed_run(sync)
    assert losses == _reference_losses()
    promos = [e for e in flightrec.get().events() if e["kind"] == "node.promote"]
    assert [(e["node"], e["standby"]) for e in promos] == [("S0", "R0")]


def test_sync_chain_acks_after_replica_applied():
    """replica_sync=True: when the worker's push ack fires, the standby has
    already applied the update (tables bitwise equal right then)."""
    van = LoopbackVan()
    primaries, standbys = replica_lib.make_replicated_servers(
        van, _table_cfgs(), NUM_SERVERS, sync=True, device="cpu")
    try:
        _train(_worker(van), _batches()[:1])
        for p, s in zip(primaries, standbys):
            assert p.pushes == s.pushes == 1
            torch.testing.assert_close(p.tables["w"].value, s.tables["w"].value,
                                       rtol=0, atol=0)
    finally:
        _close(van, primaries + standbys)


def test_promotion_preserves_optimizer_state():
    """AdaGrad accumulators ride the chain too: post-promotion updates use
    the primary's accumulated state, not a fresh one."""
    van = LoopbackVan()
    primaries, standbys = replica_lib.make_replicated_servers(
        van, _table_cfgs(), NUM_SERVERS, sync=True, device="cpu")
    try:
        _train(_worker(van), _batches()[:4])
        for p, s in zip(primaries, standbys):
            assert set(p.tables["w"].state) == {"sum_sq"}
            for k, st in p.tables["w"].state.items():
                assert st.abs().max() > 0
                torch.testing.assert_close(st, s.tables["w"].state[k], rtol=0, atol=0)
    finally:
        _close(van, primaries + standbys)


def test_replica_set_on_node_dead_promotes_once():
    """``on_node_dead("S1")`` promotes standby 1 (once; worker and unknown
    ids are ignored) and training continues on the promoted standby."""
    van = LoopbackVan()
    primaries, standbys = replica_lib.make_replicated_servers(
        van, _table_cfgs(), NUM_SERVERS, sync=True, device="cpu")

    class Manager:
        on_node_dead: list = []

    mgr = Manager()
    try:
        rset = replica_lib.ReplicaSet(van, standbys, manager=mgr)
        assert mgr.on_node_dead == [rset.on_node_dead]
        worker = _worker(van)
        batches = _batches()
        _train(worker, batches[:3])
        van.unbind("S1")
        for nid in ("W0", "S7", "S1", "S1"):
            rset.on_node_dead(nid)
        assert list(rset.promoted) == [1] and rset.promoted[1] is standbys[1]
        assert standbys[1].post.node_id == "S1"
        losses = _train(worker, batches[3:6])
        assert np.all(np.isfinite(losses))
        assert standbys[1].pushes == 6  # 3 forwarded, 3 direct
    finally:
        _close(van, primaries + standbys)


def _heartbeat_promotion_run(pkg):
    """Sync chains on a ``launch_local_cluster`` fleet: 4 steps, then S0's
    process dies (disconnected, no more beats); the other nodes keep beating
    while the scheduler sweeps until ``ReplicaSet`` has promoted standby 0;
    then 4 more steps.  Returns the losses, the dead ids and the promoted
    indexes."""
    if pkg == "port":
        from parameter_server_tpu_torch.core.manager import launch_local_cluster

        van, cfgs, lib = LoopbackVan(), _table_cfgs(), replica_lib
        kw, batches = {"device": "cpu"}, _batches()
        post_cls, server_cls, worker_cls = Postoffice, KVServer, KVWorker
    else:
        from parameter_server_tpu.core.manager import launch_local_cluster

        van, cfgs, lib = JaxLoopbackVan(), _table_cfgs(jax_config), jax_replica
        kw, batches = {}, _batches(JaxSyntheticCTR)
        post_cls, server_cls, worker_cls = JaxPostoffice, JaxKVServer, JaxKVWorker
    servers = []
    try:
        sched, managers, posts = launch_local_cluster(van, num_workers=1,
                                                      num_servers=NUM_SERVERS,
                                                      heartbeat_timeout=0.6)
        dead = []
        sched.on_node_dead.append(dead.append)
        # the primaries share the cluster's S* postoffices with their managers
        standbys = [server_cls(post_cls(lib.replica_id(s), van), cfgs, s, NUM_SERVERS, **kw)
                    for s in range(NUM_SERVERS)]
        primaries = [server_cls(posts[f"S{s}"], cfgs, s, NUM_SERVERS,
                                replica=lib.replica_id(s), replica_sync=True, **kw)
                     for s in range(NUM_SERVERS)]
        servers = primaries + standbys
        rset = lib.ReplicaSet(van, standbys, manager=sched)
        worker = worker_cls(posts["W0"], cfgs, NUM_SERVERS, **kw)
        losses = []
        beating = [m for nid, m in managers.items() if nid != "H"]
        for i, (keys, labels) in enumerate(batches[:8]):
            w_pos = worker.pull_sync("w", keys, timeout=30)
            if pkg == "port":
                g, _gb, loss = linear.grad_rows(torch.from_numpy(w_pos),
                                                torch.from_numpy(labels.astype(np.float32)))
                g = g.numpy()
            else:
                g, _gb, loss = jax_linear.grad_rows(jnp.asarray(w_pos), jnp.asarray(labels))
                g = np.asarray(g)
            assert worker.wait(worker.push("w", keys, g / labels.shape[0]), timeout=30)
            losses.append(float(loss))
            if i == 3:
                van.disconnect("S0")  # the primary process dies, its beats stop
                beating = [m for nid, m in managers.items() if nid not in ("H", "S0")]
                deadline = time.monotonic() + 10.0
                while time.monotonic() < deadline and 0 not in rset.promoted:
                    for mgr in beating:
                        assert mgr.wait(mgr.send_heartbeat(), timeout=30)
                    time.sleep(0.1)
                    sched.check_heartbeats()
                assert not sched.is_alive("S0")
            for mgr in beating:  # every live node beats once a step
                assert mgr.wait(mgr.send_heartbeat(), timeout=30)
        return losses, dead, sorted(rset.promoted)
    finally:
        _close(van, servers if pkg == "port" else [])


def test_manager_heartbeat_death_triggers_promotion():
    """The failure loop end to end: the scheduler's heartbeat sweep finds the
    dead primary and the ReplicaSet promotes its standby; the worker keeps
    pulling from S0 and every loss equals the uninterrupted run's."""
    losses, dead, promoted = _heartbeat_promotion_run("port")
    assert dead == ["S0"] and promoted == [0]
    assert losses == _reference_losses()[:8]
    j_losses, j_dead, j_promoted = _heartbeat_promotion_run("jax")
    assert (j_dead, j_promoted) == (dead, promoted)
    np.testing.assert_allclose(losses, j_losses, **TRAJ_TOL)


def test_make_replicated_servers_chains_every_shard():
    van = LoopbackVan()
    primaries, standbys = replica_lib.make_replicated_servers(
        van, _table_cfgs(), NUM_SERVERS, sync=False, max_lag=3, device_replies=True,
        device="cpu")
    try:
        assert [p.replica for p in primaries] == ["R0", "R1"]
        assert [s.post.node_id for s in standbys] == ["R0", "R1"]
        assert all(s.replica is None for s in standbys)
        assert all(p.max_replica_lag == 3 and not p.replica_sync for p in primaries)
        assert all(x.device_replies for x in primaries + standbys)
        assert [p._fwd_post.node_id for p in primaries] == ["S0.fw", "S1.fw"]
    finally:
        _close(van, primaries + standbys)


def _jax_killed_run(sync: bool) -> list:
    cfgs = _table_cfgs(jax_config)
    van = JaxLoopbackVan()
    try:
        primaries, standbys = jax_replica.make_replicated_servers(
            van, cfgs, NUM_SERVERS, sync=sync, max_lag=4)
        worker = JaxKVWorker(JaxPostoffice("W0", van), cfgs, NUM_SERVERS)
        losses = []
        for i, (keys, labels) in enumerate(_batches(JaxSyntheticCTR)):
            w_pos = worker.pull_sync("w", keys, timeout=30)
            g, _gb, loss = jax_linear.grad_rows(jnp.asarray(w_pos), jnp.asarray(labels))
            assert worker.wait(worker.push("w", keys, np.asarray(g) / labels.shape[0]),
                               timeout=30)
            losses.append(float(loss))
            if i == KILL_AFTER - 1:
                if not sync:
                    primaries[0].flush_replica()
                van.unbind("S0")
                jax_replica.promote(van, standbys[0], "S0")
        return losses
    finally:
        van.close()


@pytest.mark.parametrize("sync", [True, False], ids=["sync=True", "sync=False"])
def test_killed_run_loss_trajectory_matches_jax(sync):
    port, ref = _killed_run(sync), _jax_killed_run(sync)
    assert port[-1] < port[0]
    np.testing.assert_allclose(port, ref, **TRAJ_TOL)


# -- same-id restart (ports of tests/test_restart.py's restore cases) ----------


def _restart_fallback_run(pkg, root):
    """Save a legacy checkpoint at step 3, kill S0 at step 7 and restart it
    with no standby: the checkpoint path.  Returns the losses, the shard at
    save time, the restarted shard and the source."""
    if pkg == "port":
        van, cfgs, lib = LoopbackVan(), _table_cfgs(), replica_lib
        servers = [KVServer(Postoffice(f"S{s}", van), cfgs, s, NUM_SERVERS, device="cpu")
                   for s in range(NUM_SERVERS)]
        worker, batches, kw = _worker(van), _batches(), {"device": "cpu"}
    else:
        van, cfgs, lib = JaxLoopbackVan(), _table_cfgs(jax_config), jax_replica
        servers = [JaxKVServer(JaxPostoffice(f"S{s}", van), cfgs, s, NUM_SERVERS)
                   for s in range(NUM_SERVERS)]
        worker = JaxKVWorker(JaxPostoffice("W0", van), cfgs, NUM_SERVERS)
        batches, kw = _batches(JaxSyntheticCTR), {}
    got = {}
    try:
        losses = []
        for i, (keys, labels) in enumerate(batches):
            w_pos = np.asarray(worker.pull_sync("w", keys, timeout=30))
            g, _gb, loss = linear.grad_rows(torch.from_numpy(w_pos),
                                            torch.from_numpy(labels.astype(np.float32)))
            worker.push_sync("w", keys, g.numpy() / labels.shape[0], timeout=30)
            losses.append(float(loss))
            if i == 3:
                worker.save_model(root, step=i, timeout=60)
                got["at_save"] = servers[0].export_shard()
            if i == 7:
                van.unbind("S0")
                srv, got["source"] = lib.restart_same_id(van, cfgs, 0, NUM_SERVERS,
                                                         ckpt_root=root, **kw)
                servers.append(srv)
                got["restored"] = srv.export_shard()
        return losses, got
    finally:
        van.close()
        for s in servers:
            if getattr(s, "ledger", None) is not None:
                s.ledger.close()


def test_same_id_restart_checkpoint_fallback_bounded_rewind(tmp_path):
    """No standby: the restarted shard rewinds to the latest committed
    checkpoint and no further (its rows equal the shard at save time, bit for
    bit), and training completes through the rewind.  The same run through
    the JAX package: the same source, losses within the trajectory
    tolerance (the rewind is part of both trajectories)."""
    losses, got = _restart_fallback_run("port", str(tmp_path / "port"))
    assert got["source"] == "checkpoint" and len(losses) == STEPS
    np.testing.assert_array_equal(got["restored"]["w"]["value"], got["at_save"]["w"]["value"])
    for k, v in got["at_save"]["w"]["state"].items():
        np.testing.assert_array_equal(got["restored"]["w"]["state"][k], v)
    j_losses, j_got = _restart_fallback_run("jax", str(tmp_path / "jax"))
    assert j_got["source"] == got["source"]
    np.testing.assert_allclose(losses, j_losses, **TRAJ_TOL)


def _restore_selection(pkg, root):
    """Server, standby and checkpoint in three distinct states, then
    restarts: standby > checkpoint > cold.  Returns each source with the
    restored value plane, and the three states."""
    if pkg == "port":
        van, cfgs, lib, kw = LoopbackVan(), _table_cfgs(), replica_lib, {"device": "cpu"}
        from parameter_server_tpu_torch import checkpoint as ckpt

        make = lambda nid: KVServer(Postoffice(nid, van), cfgs, 0, 1, device="cpu")  # noqa: E731
        worker = KVWorker(Postoffice("W0", van), cfgs, 1, device="cpu")
    else:
        van, cfgs, lib, kw = JaxLoopbackVan(), _table_cfgs(jax_config), jax_replica, {}
        from parameter_server_tpu import checkpoint as ckpt

        make = lambda nid: JaxKVServer(JaxPostoffice(nid, van), cfgs, 0, 1)  # noqa: E731
        worker = JaxKVWorker(JaxPostoffice("W0", van), cfgs, 1)
    server, standby = make("S0"), make("R0")
    servers = [server, standby]
    try:
        states = {"cold": server.export_shard()["w"]["value"].copy()}
        keys = np.arange(16, dtype=np.int64)
        worker.push_sync("w", keys, np.ones(16, np.float32), timeout=60)
        server.save_checkpoint(root, step=1)
        ckpt.finalize(root, 1, 1, {"w": cfgs["w"].rows})
        states["checkpoint"] = server.export_shard()["w"]["value"].copy()
        worker.push_sync("w", keys, np.ones(16, np.float32), timeout=60)
        standby.import_shard(server.export_shard())
        states["replica"] = standby.export_shard()["w"]["value"].copy()
        restored = []
        for extra in ({"standby": standby, "ckpt_root": root}, {"ckpt_root": root}, {}):
            van.unbind("S0")
            srv, source = lib.restart_same_id(van, cfgs, 0, 1, **extra, **kw)
            servers.append(srv)
            restored.append((source, np.asarray(srv.export_shard()["w"]["value"]).copy()))
        return restored, states
    finally:
        van.close()
        for s in servers:
            if getattr(s, "ledger", None) is not None:
                s.ledger.close()


def test_restore_selection_replica_then_checkpoint_then_cold(tmp_path):
    """restart_same_id's preference: live standby > latest committed
    checkpoint > cold seeded init, each restoring its source's rows exactly;
    the JAX package picks the same sources and its states agree."""
    restored, states = _restore_selection("port", str(tmp_path / "port"))
    assert not np.array_equal(states["checkpoint"], states["replica"])
    assert [s for s, _ in restored] == ["replica", "checkpoint", "cold"]
    for source, value in restored:
        np.testing.assert_array_equal(value, states[source])
    j_restored, j_states = _restore_selection("jax", str(tmp_path / "jax"))
    assert [s for s, _ in j_restored] == [s for s, _ in restored]
    for source in states:
        np.testing.assert_allclose(states[source], j_states[source], rtol=1e-5, atol=1e-5)


# ------------------------------------- same-id restart over the reliable wire


def _reliable_stack(*, seed=0, timeout=0.05, max_retries=60, **chaos_kw):
    chaos = ChaosVan(LoopbackVan(), seed=seed, **chaos_kw)
    return ReliableVan(chaos, timeout=timeout, backoff=1.0, max_retries=max_retries,
                       seed=seed), chaos


def _settle(predicate, deadline_s=5.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.005)
    return predicate()


_CLEAN_APPLIED = {}


def _clean_applied() -> int:
    """Pushes the clean run's servers apply: the exactly-once ground truth."""
    if not _CLEAN_APPLIED:
        van = LoopbackVan()
        servers = [KVServer(Postoffice(f"S{s}", van), _table_cfgs(), s, NUM_SERVERS,
                            device="cpu") for s in range(NUM_SERVERS)]
        try:
            _train(_worker(van), _batches())
            _CLEAN_APPLIED["n"] = sum(s.pushes for s in servers)
        finally:
            _close(van, servers)
    return _CLEAN_APPLIED["n"]


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [0, 1])
def test_same_id_double_restart_under_drop_matches_clean_run(seed):
    """S0 killed and restarted in place twice under seeded 5% drop, restored
    from its sync standby each time: the clean trajectory bit for bit,
    exactly the clean number of pushes applied, no stale frame delivered."""
    ref_losses = _reference_losses()
    van, chaos = _reliable_stack(seed=seed, timeout=0.1, drop=0.05)
    primaries, standbys = replica_lib.make_replicated_servers(
        van, _table_cfgs(), NUM_SERVERS, sync=True, device="cpu")
    instances = [primaries[0]]
    try:
        worker = _worker(van)

        def on_step(i):
            if i in (STEPS // 3, 2 * STEPS // 3):
                van.unbind("S0")
                van.unbind("S0.fw")
                van.restart_node("S0")
                srv, source = replica_lib.restart_same_id(
                    van, _table_cfgs(), 0, NUM_SERVERS, standby=standbys[0], device="cpu")
                assert source == "replica"
                instances.append(srv)

        assert _train(worker, _batches(), on_step=on_step) == ref_losses
        assert len(instances) == 3
        assert sum(s.pushes for s in instances) + primaries[1].pushes == _clean_applied()
        assert van.incarnations.get("S0") == 2
        assert van.flush(10)
        assert van.gave_up == 0
        assert chaos.injected_drops > 0
    finally:
        _close(van, instances + primaries[1:] + standbys)


class _Recorder(Customer):
    def __init__(self, name, post, seen, field=None):
        super().__init__(name, post)
        self.seen, self.field = seen, field

    def handle_request(self, msg):
        self.seen.append(msg.task.payload.get(self.field) if self.field
                         else float(msg.values[0][0]))
        return msg.reply()


@pytest.mark.chaos
def test_zombie_stale_incarnation_frames_are_fenced():
    """A frame stamped with a superseded incarnation (and a valid CRC) is
    dropped without an ACK or delivery; the successor still works."""
    van = ReliableVan(LoopbackVan(), timeout=30.0)
    try:
        seen = []
        _Recorder("rec", Postoffice("S0", van), seen)
        client = Customer("rec", Postoffice("W0", van))

        def push(x):
            return client.submit([Message(task=Task(TaskKind.PUSH, "rec"), recver="S0",
                                          values=[np.array([x])])])

        assert client.wait(push(1.0), timeout=10)
        assert seen == [1.0]
        assert van.restart_node("W0") == 1
        zombie = Message(task=Task(TaskKind.PUSH, "rec"), sender="W0", recver="S0",
                         values=[np.array([666.0])])
        zombie.task.payload = {SEQ_KEY: 99, CRC_KEY: payload_crc32(zombie)}
        acks_before = van.acks_sent
        van.inner.send(zombie)  # below the resender's stamping
        assert _settle(lambda: van.rejected_stale == 1)
        time.sleep(0.05)  # the frame must not trickle through late
        assert seen == [1.0]
        assert van.acks_sent == acks_before
        assert client.wait(push(2.0), timeout=10)
        assert seen == [1.0, 2.0]
    finally:
        van.close()


@pytest.mark.chaos
def test_incarnation_advance_resets_windows_and_seq():
    van = ReliableVan(LoopbackVan(), timeout=30.0)
    try:
        seen = []
        _Recorder("rec", Postoffice("S0", van), seen, field="n")
        client = Customer("rec", Postoffice("W0", van))

        def push(n):
            ts = client.submit([Message(task=Task(TaskKind.PUSH, "rec", payload={"n": n}),
                                        recver="S0")])
            assert client.wait(ts, timeout=10)

        for n in range(3):
            push(n)
        assert seen == [0, 1, 2] and van.dup_suppressed == 0
        van.restart_node("W0")
        for n in range(3, 6):  # seqs 0..2 again, under the new incarnation
            push(n)
        assert seen == [0, 1, 2, 3, 4, 5]
        assert van.dup_suppressed == 0 and van.rejected_stale == 0
    finally:
        van.close()


@pytest.mark.chaos
def test_manager_reregistration_reaches_the_transport_fence():
    """A REGISTER for a known id bumps the row's incarnation, keeps its range,
    rebroadcasts, and every endpoint's reliable van learns the new epoch."""
    from parameter_server_tpu_torch.core.manager import Manager, launch_local_cluster

    van, _chaos = _reliable_stack(seed=0, timeout=0.1)
    try:
        sched, managers, _posts = launch_local_cluster(van, num_workers=1, num_servers=1,
                                                       heartbeat_timeout=30)
        row = next(n for n in sched.nodes() if n.node_id == "S0")
        assert row.incarnation == 0
        van.unbind("S0")
        new_mgr = Manager(Postoffice("S0", van), num_workers=1, num_servers=1)
        assert new_mgr.register_with_scheduler(timeout=10)
        row = next(n for n in sched.nodes() if n.node_id == "S0")
        assert row.incarnation == 1 and row.alive
        assert (row.range_begin, row.range_end) == sched.server_range("S0")
        assert _settle(lambda: van.incarnations.get("S0") == 1)
        assert _settle(lambda: len(new_mgr.nodes()) == len(sched.nodes()))
        assert _settle(lambda: any(n.node_id == "S0" and n.incarnation == 1
                                   for n in managers["W0"].nodes()))
    finally:
        van.close()


@pytest.mark.chaos
def test_full_restart_lifecycle_with_scheduler():
    """``learner.elastic.restart_server`` under 2% drop: S0 crashes, restores
    from its standby and re-registers; the scheduler and the transport both
    hold incarnation 1 and training keeps the clean trajectory."""
    from parameter_server_tpu_torch.core.manager import launch_local_cluster
    from parameter_server_tpu_torch.learner.elastic import restart_server

    ref_losses = _reference_losses()
    van, _chaos = _reliable_stack(seed=4, timeout=0.1, drop=0.02)
    servers = []
    try:
        sched, _managers, posts = launch_local_cluster(van, num_workers=1,
                                                       num_servers=NUM_SERVERS,
                                                       heartbeat_timeout=30)
        cfgs = _table_cfgs()
        standbys = [KVServer(Postoffice(f"R{s}", van), cfgs, s, NUM_SERVERS, device="cpu")
                    for s in range(NUM_SERVERS)]
        servers += standbys
        servers += [KVServer(posts[f"S{s}"], cfgs, s, NUM_SERVERS, replica=f"R{s}",
                             replica_sync=True, device="cpu") for s in range(NUM_SERVERS)]
        worker = KVWorker(posts["W0"], cfgs, NUM_SERVERS, device="cpu")
        restarted = {}

        def on_step(i):
            if i != STEPS // 2:
                return
            van.unbind("S0")
            van.unbind("S0.fw")
            server, source, mgr = restart_server(
                van, cfgs, 0, NUM_SERVERS, num_workers=1, standby=standbys[0],
                heartbeat_timeout=30, device="cpu")
            assert source == "replica" and mgr is not None
            restarted["server"] = server
            servers.append(server)

        assert _train(worker, _batches(), on_step=on_step) == ref_losses
        assert "server" in restarted
        assert next(n for n in sched.nodes() if n.node_id == "S0").incarnation == 1
        assert van.incarnations.get("S0") == 1
        assert van.flush(10)
    finally:
        _close(van, servers)


@pytest.mark.chaos
def test_remote_cancel_drops_queued_work_at_receiver():
    """``Customer.cancel(remote=True)``: the CANCEL frame fences a delayed
    request at the receiving Postoffice, which drops it unexecuted."""
    chaos = ChaosVan(LoopbackVan(), seed=0)
    try:
        ran = []

        class Ran(Customer):
            def handle_request(self, msg):
                ran.append(self.post.node_id)
                return msg.reply()

        s0_post, s1_post = Postoffice("S0", chaos), Postoffice("S1", chaos)
        Ran("rec", s0_post)
        Ran("rec", s1_post)
        client = Customer("rec", Postoffice("W0", chaos))
        chaos.set_link("W0", "S1", ChaosConfig(delay=0.4))
        ts = client.submit([Message(task=Task(TaskKind.PUSH, "rec"), recver="S0"),
                            Message(task=Task(TaskKind.PUSH, "rec"), recver="S1")])
        assert _settle(lambda: ran == ["S0"])
        chaos.set_link("W0", "S1", ChaosConfig())
        assert client.cancel(ts, "test deadline", remote=True)
        assert _settle(lambda: s1_post.cancelled_drops == 1, 3.0)
        time.sleep(0.2)  # past the delayed delivery
        assert ran == ["S0"]
        assert s0_post.cancelled_drops == 0
        ts = client.submit([Message(task=Task(TaskKind.PUSH, "rec"), recver="S1")])
        assert client.wait(ts, timeout=10)
        assert ran == ["S0", "S1"]
    finally:
        chaos.close()
