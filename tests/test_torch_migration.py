"""The port's live shard migration against the JAX package's, on the CPU.

Ports of ``tests/test_migration.py``:

1. ``ShardMigrator.migrate`` mid-training moves value and optimizer state
   bit for bit, shrinking the donor and growing the recipient;
2. pushes landing after their chunk shipped ride the commit's dirty delta:
   nothing lost, nothing doubled, against a twin fleet with no migration;
3. scale up to a third server live, then drain one away: the trajectory and
   the final table equal the fixed two-server run's.
4. with sync replica chains, the standbys follow the migration through
   ``_forward_control`` (``migrate_adopt`` / ``migrate_release``), bit for
   bit with their primaries.

Each runs the same seeded batches through the JAX package's migration too:
losses and tables against it, and the migrator's and the servers' migration
counters equal to its own.  The scale case goes through the port's
``learner.elastic.scale_up`` / ``drain_down``.  Not ported here: the chaos
cases (a donor killed mid-stream, a stale worker fenced under packet loss:
the reliable van).  The fleet monitor's rebalance, the scheduler broadcast
and the counter group are in ``test_torch_elastic.py``.

Tolerances: within the port bit for bit (the per-row apply does not depend
on the layout); against the JAX package rtol = atol = 1e-5 for tables and
rtol = atol = 1e-4 for the 12-step loss trajectory, as in
``test_torch_replica.py``.
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parameter_server_tpu import config as jax_config
from parameter_server_tpu.core.postoffice import Postoffice as JaxPostoffice
from parameter_server_tpu.core.van import LoopbackVan as JaxLoopbackVan
from parameter_server_tpu.data.synthetic import SyntheticCTR as JaxSyntheticCTR
from parameter_server_tpu.kv.migrate import ShardMigrator as JaxShardMigrator
from parameter_server_tpu.kv.server import KVServer as JaxKVServer
from parameter_server_tpu.kv.worker import KVWorker as JaxKVWorker
from parameter_server_tpu.learner.elastic import drain_down as jax_drain_down
from parameter_server_tpu.learner.elastic import scale_up as jax_scale_up
from parameter_server_tpu.models import linear as jax_linear
from parameter_server_tpu_torch import config as port_config
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
from parameter_server_tpu_torch.kv.migrate import MigrationError, ShardMigrator
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.learner.elastic import drain_down, scale_up
from parameter_server_tpu_torch.models import linear
from parameter_server_tpu_torch.utils.keys import HashLocalizer

ROWS = 1 << 10
NUM_SERVERS = 2
STEPS = 12
TOL = dict(rtol=1e-5, atol=1e-5)
TRAJ_TOL = dict(rtol=1e-4, atol=1e-4)


def _table_cfgs(cfg=port_config):
    return {"w": cfg.TableConfig(
        name="w", rows=ROWS, dim=1,
        optimizer=cfg.OptimizerConfig(kind="adagrad", learning_rate=0.1),
    )}


def _batches(synthetic=SyntheticCTR):
    data = synthetic(key_space=4 * ROWS, nnz=8, batch_size=128, seed=3)
    return [data.next_batch() for _ in range(STEPS)]


class _Fleet:
    """``NUM_SERVERS`` servers, one worker and a migrator of either package."""

    def __init__(self, pkg):
        self.pkg = pkg
        if pkg == "port":
            self.van = LoopbackVan()
            self.cfgs = _table_cfgs()
            self.servers = {s: KVServer(Postoffice(f"S{s}", self.van), self.cfgs, s,
                                        NUM_SERVERS, device="cpu")
                            for s in range(NUM_SERVERS)}
            self.worker = KVWorker(Postoffice("W0", self.van), self.cfgs, NUM_SERVERS,
                                   device="cpu")
            self.migrator = ShardMigrator(Postoffice("M0", self.van), chunk_rows=128)
        else:
            self.van = JaxLoopbackVan()
            self.cfgs = _table_cfgs(jax_config)
            self.servers = {s: JaxKVServer(JaxPostoffice(f"S{s}", self.van), self.cfgs, s,
                                           NUM_SERVERS)
                            for s in range(NUM_SERVERS)}
            self.worker = JaxKVWorker(JaxPostoffice("W0", self.van), self.cfgs, NUM_SERVERS)
            self.migrator = JaxShardMigrator(JaxPostoffice("M0", self.van), chunk_rows=128)

    def train(self, batches, on_step=None):
        losses = []
        for i, (keys, labels) in enumerate(batches):
            w_pos = self.worker.pull_sync("w", keys, timeout=60)
            if self.pkg == "port":
                g, _gb, loss = linear.grad_rows(torch.from_numpy(w_pos),
                                                torch.from_numpy(labels.astype(np.float32)))
                g = g.numpy()
            else:
                g, _gb, loss = jax_linear.grad_rows(jnp.asarray(w_pos), jnp.asarray(labels))
                g = np.asarray(g)
            self.worker.push_sync("w", keys, g / labels.shape[0], timeout=60)
            losses.append(float(loss))
            if on_step is not None:
                on_step(i)
        return losses

    def rows(self, routing=None):
        """The whole table, value and state, stitched per segment."""
        routing = routing or self.worker.routing
        parts = [self.servers[o].export_range("w", lo, hi)
                 for lo, hi, o in routing.tables["w"].segments()]
        return (np.concatenate([v for v, _ in parts]),
                {k: np.concatenate([st[k] for _, st in parts]) for k in parts[0][1]})

    def close(self):
        self.van.close()
        for s in self.servers.values():
            if s.ledger is not None:
                s.ledger.close()


def _reference(pkg):
    """The fixed-topology run: losses and the final table."""
    fleet = _Fleet(pkg)
    try:
        losses = fleet.train(_batches(SyntheticCTR if pkg == "port" else JaxSyntheticCTR))
        return losses, fleet.rows()
    finally:
        fleet.close()


def _assert_rows(got, want, tol=None):
    check = np.testing.assert_array_equal if tol is None else (
        lambda a, b: np.testing.assert_allclose(a, b, **tol))
    check(got[0], want[0])
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        check(got[1][k], want[1][k])


def _keys_hashing_into(lo, hi, count):
    """Raw keys whose HashLocalizer slot lands in global rows [lo, hi)."""
    loc = HashLocalizer(ROWS)
    found, k = [], 0
    while len(found) < count:
        cand = np.arange(k, k + 4096, dtype=np.int64)
        slots = loc.assign(cand.astype(np.uint64))
        found.extend(int(x) for x in cand[(slots >= lo) & (slots < hi)])
        k += 4096
    return np.asarray(found[:count], dtype=np.int64)


def _counters(fleet):
    mig = fleet.migrator.counters()
    srv = {s: fleet.servers[s].counters() for s in sorted(fleet.servers)}
    return ({k: mig[k] for k in ("migrations", "migration_aborts", "rows_moved")},
            {s: {k: c[k] for k in ("rows_migrated_in", "rows_migrated_out")}
             for s, c in srv.items()},
            {s: c["migration_freeze_s"] for s, c in srv.items()})


# ------------------------------------------------------ 1. basic migration


def _migrating_run(pkg):
    fleet = _Fleet(pkg)
    try:
        moved = {}

        def on_step(i):
            if i != STEPS // 2:
                return
            # move the tail half of S1's range to S0, live
            routing = fleet.worker.routing
            new_routing = fleet.migrator.migrate(routing, "w", 768, ROWS, 0)
            assert new_routing.epoch == routing.epoch + 1
            assert fleet.worker.adopt_routing(new_routing)
            moved["routing"] = new_routing

        losses = fleet.train(_batches(SyntheticCTR if pkg == "port" else JaxSyntheticCTR),
                             on_step=on_step)
        routing = moved["routing"]
        assert routing.tables["w"].owned_segments(0) == [(0, 512), (768, ROWS)]
        assert routing.tables["w"].owned_segments(1) == [(512, 768)]
        return losses, fleet.rows(routing), _counters(fleet), fleet
    finally:
        fleet.close()


def test_migrate_moves_value_and_optimizer_state_bitwise():
    ref_losses, ref_rows = _reference("port")
    losses, rows, (mig, moved, freeze), fleet = _migrating_run("port")
    assert losses == ref_losses  # the per-row apply ignores the layout
    _assert_rows(rows, ref_rows)
    assert moved[1]["rows_migrated_out"] == 256
    assert moved[0]["rows_migrated_in"] >= 256  # chunks + dirty delta
    assert mig["migrations"] == 1 and mig["rows_moved"] == 256
    assert 0.0 <= fleet.servers[1].migration_freeze_last_s < 5.0
    # the same run through the JAX package
    j_losses, j_rows, (j_mig, j_moved, j_freeze), _ = _migrating_run("jax")
    np.testing.assert_allclose(losses, j_losses, **TRAJ_TOL)
    _assert_rows(rows, j_rows, TOL)
    assert (mig, moved) == (j_mig, j_moved)
    assert (freeze[1] > 0) == (j_freeze[1] > 0)


# ------------------------------------ 2. dirty delta inside the commit fence


def _delta_run(pkg):
    """Push, stream every chunk, push again into the moving range, commit;
    returns the migrated fleet's table, its twin's, and the counters."""
    lo, hi = 768, ROWS
    hot = _keys_hashing_into(lo, hi, 32)
    fleet, twin = _Fleet(pkg), _Fleet(pkg)
    try:
        ones = np.ones(hot.size, np.float32)
        for f in (fleet, twin):
            f.worker.push_sync("w", hot, ones, timeout=60)
        new_routing = fleet.worker.routing.move("w", lo, hi, 0)
        mid = "test:delta:0"
        rpc = fleet.migrator._rpc
        rpc("S1", {"op": "migrate_begin", "mid": mid, "table": "w", "lo": lo, "hi": hi})
        for a in range(lo, hi, 128):
            rpc("S1", {"op": "migrate_send", "mid": mid, "to": "S0", "lo": a, "hi": a + 128})
        # every chunk has shipped; NOW dirty some of the migrating rows
        for f in (fleet, twin):
            f.worker.push_sync("w", hot, 2 * ones, timeout=60)
        rpc("S1", {"op": "migrate_commit", "mid": mid, "to": "S0",
                   "routing": new_routing.to_payload()})
        assert fleet.worker.adopt_routing(new_routing)
        return fleet.rows(new_routing), twin.rows(), _counters(fleet)
    finally:
        fleet.close()
        twin.close()


def test_push_between_chunks_rides_commit_delta():
    """Rows dirtied after their chunk shipped are re-sent in the commit
    freeze: the recipient holds the late push exactly once."""
    rows, twin_rows, (_, moved, freeze) = _delta_run("port")
    _assert_rows(rows, twin_rows)
    # the counter is DISTINCT rows handed over, not chunk + delta traffic
    assert moved[0]["rows_migrated_in"] == ROWS - 768
    assert freeze[1] > 0.0
    j_rows, _, (_, j_moved, _) = _delta_run("jax")
    _assert_rows(rows, j_rows, TOL)
    assert moved == j_moved


# ----------------------------------------------- 3. scale up + drain down


def _elastic_run(pkg):
    fleet = _Fleet(pkg)
    state = {"routing": fleet.worker.routing}
    try:
        def on_step(i):
            routing = state["routing"]
            if i == STEPS // 3:
                # scale_up: a server that owns no rows joins, then the tail
                # half of the largest segment migrates onto it
                if pkg == "jax":
                    server, routing = jax_scale_up(fleet.van, fleet.cfgs, routing, 2,
                                                   migrator=fleet.migrator, num_servers=3)
                else:
                    server, routing = scale_up(fleet.van, fleet.cfgs, routing, 2,
                                               migrator=fleet.migrator, num_servers=3,
                                               device="cpu")
                fleet.servers[2] = server
                assert routing.tables["w"].server_rows(2) > 0
            elif i == 2 * STEPS // 3:
                # drain_down: every range off S1, then its endpoints go
                drain = jax_drain_down if pkg == "jax" else drain_down
                routing = drain(fleet.van, routing, 1, migrator=fleet.migrator)
            else:
                return
            state["routing"] = routing
            assert fleet.worker.adopt_routing(routing)

        losses = fleet.train(_batches(SyntheticCTR if pkg == "port" else JaxSyntheticCTR),
                             on_step=on_step)
        routing = state["routing"]
        assert 1 not in routing.servers() and routing.tables["w"].server_rows(1) == 0
        assert "S1" not in fleet.van._endpoints
        for s in fleet.servers.values():
            assert s.migration_freeze_last_s < 5.0  # bounded, never a pause
        return losses, fleet.rows(routing), _counters(fleet)
    finally:
        fleet.close()


def test_scale_up_then_drain_down_zero_loss():
    """Grow to a third server live, then retire S1 live: the trajectory and
    the final model equal the fixed 2-server run's, every freeze bounded,
    and the retired identity serves nothing."""
    ref_losses, ref_rows = _reference("port")
    losses, rows, (mig, moved, _) = _elastic_run("port")
    assert losses == ref_losses
    _assert_rows(rows, ref_rows)
    j_losses, j_rows, (j_mig, j_moved, _) = _elastic_run("jax")
    np.testing.assert_allclose(losses, j_losses, **TRAJ_TOL)
    _assert_rows(rows, j_rows, TOL)
    assert (mig, moved) == (j_mig, j_moved)


# ------------------------------------------------------ protocol edges


def test_migration_refuses_a_range_of_two_donors_and_aborts_cleanly():
    """A range spanning two owners is refused before any op is sent; a
    commit to a recipient that is gone aborts both sides, leaves ownership
    where it was and counts the abort, as the JAX migrator does."""
    out = {}
    for pkg in ("jax", "port"):
        fleet = _Fleet(pkg)
        try:
            with pytest.raises(ValueError, match="spans donors"):
                fleet.migrator.migrate(fleet.worker.routing, "w", 500, 600, 0)
            routing = fleet.worker.routing
            fleet.migrator.timeout = 2.0
            with pytest.raises(Exception) as err:
                fleet.migrator.migrate(routing, "w", 900, ROWS, 2)  # no S2 is bound
            assert "MigrationError" in type(err.value).__name__
            assert fleet.servers[1]._migrations == {}
            assert fleet.servers[1].routing.epoch == 0
            assert fleet.servers[1].routing.tables["w"].owned_segments(1) == [(512, ROWS)]
            out[pkg] = fleet.migrator.counters()["migration_aborts"]
        finally:
            fleet.close()
    assert out["port"] == out["jax"] == 1
    assert issubclass(MigrationError, RuntimeError)


# ------------------------------------------- the replica chain follows a migration


def _chained_run(pkg):
    """Sync replica chains on both servers; train, migrate mid-run with
    pushes between chunks, train on.  Returns the primaries' and the
    standbys' tables (each per segment of the final routing), the losses
    and each side's migration counters."""
    if pkg == "port":
        from parameter_server_tpu_torch.kv import replica as lib

        van, cfgs, kw = LoopbackVan(), _table_cfgs(), {"device": "cpu"}
        worker = KVWorker(Postoffice("W0", van), cfgs, NUM_SERVERS, device="cpu")
        mig = ShardMigrator(Postoffice("M0", van), chunk_rows=128)
        batches = _batches()
    else:
        from parameter_server_tpu.kv import replica as lib

        van, cfgs, kw = JaxLoopbackVan(), _table_cfgs(jax_config), {}
        worker = JaxKVWorker(JaxPostoffice("W0", van), cfgs, NUM_SERVERS)
        mig = JaxShardMigrator(JaxPostoffice("M0", van), chunk_rows=128)
        batches = _batches(JaxSyntheticCTR)
    primaries, standbys = lib.make_replicated_servers(van, cfgs, NUM_SERVERS, sync=True, **kw)
    fleet = _Fleet.__new__(_Fleet)
    fleet.pkg, fleet.van, fleet.worker, fleet.migrator = pkg, van, worker, mig
    fleet.servers = dict(enumerate(primaries))
    try:
        def on_step(i):
            if i == STEPS // 2:
                keys, _ = batches[i]
                rpc, sent = mig._rpc, []

                def chunked(recver, payload):
                    reply = rpc(recver, payload)
                    if payload["op"] == "migrate_send":
                        sent.append(1)
                        if len(sent) == 1:  # a push lands between chunks
                            worker.push_sync("w", keys, np.full(keys.shape, 0.01, np.float32),
                                             timeout=60)
                    return reply

                mig._rpc = chunked
                assert worker.adopt_routing(mig.migrate(worker.routing, "w", 640, ROWS, 0))
                mig._rpc = rpc

        losses = fleet.train(batches, on_step=on_step)
        routing = worker.routing
        rows = fleet.rows(routing)
        fleet.servers = dict(enumerate(standbys))
        standby_rows = fleet.rows(routing)
        counters = [{k: s.counters()[k] for k in ("rows_migrated_in", "rows_migrated_out")}
                    for s in primaries + standbys]
        epochs = [s.routing.epoch for s in primaries + standbys]
        return losses, rows, standby_rows, counters, epochs
    finally:
        fleet.servers = dict(enumerate(primaries + standbys))
        fleet.close()


def test_migration_is_chained_to_the_standbys():
    """With sync chains on both servers, a live migration reaches the
    standbys through ``_forward_control``: the recipient's standby adopts the
    assembled range (``migrate_adopt``), the donor's drops it
    (``migrate_release``), both at the new epoch, and every standby row
    equals its primary's bit for bit; the same counters and epochs as the
    JAX package's run, its tables within float32 tolerance."""
    losses, rows, standby_rows, counters, epochs = _chained_run("port")
    _assert_rows(standby_rows, rows)
    assert epochs == [1, 1, 1, 1]
    j_losses, j_rows, _, j_counters, j_epochs = _chained_run("jax")
    assert (counters, epochs) == (j_counters, j_epochs)
    np.testing.assert_allclose(losses, j_losses, **TRAJ_TOL)
    _assert_rows(rows, j_rows, TOL)
