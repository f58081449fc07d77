"""The port's partitioned snapshots against the JAX package's, on the CPU.

Ports of ``tests/test_durability.py`` (all but the elastic trainer's mode
pick, which needs ``learner/elastic.py``):

1. a rebalanced (migrated) fleet snapshots mid-training and restores onto
   other server counts bit for bit, optimizer state included;
2. an incremental chain (full -> delta -> delta) restores to the same bits
   as one full snapshot of the same state;
3. the commit freeze is bounded by the dirty set: the delta log holds
   exactly the rows written while the window was open, fewer than a shard
   (asserted on rows; the two wall-clock times are reported, not raced);
4. a server dying mid-snapshot leaves the previous restore point;
5. CRC armour on segment files and manifests;
6. restore-source ordering on a same-id restart (replica > partitioned >
   legacy > cold), and a restart after a migration adopting the snapshot's
   routing;
7. the legacy format's typed ``CheckpointLayoutError``;
8. retention keeps an incremental chain's base.

Then the files across packages: a format-2 chain (full + incremental) written
by the JAX package restores in the port onto another fleet shape, and one
written by the port restores in the JAX package, every row bit for bit.

Tolerances: restores and chains bit for bit (tolerance 0); the same seeded
pushes through both packages rtol = atol = 1e-5.
"""

import json
import os
import time

import numpy as np
import pytest

from parameter_server_tpu import checkpoint as jax_checkpoint
from parameter_server_tpu import config as jax_config
from parameter_server_tpu.core.postoffice import Postoffice as JaxPostoffice
from parameter_server_tpu.core.van import LoopbackVan as JaxLoopbackVan
from parameter_server_tpu.kv.migrate import ShardMigrator as JaxShardMigrator
from parameter_server_tpu.kv.server import KVServer as JaxKVServer
from parameter_server_tpu.kv.worker import KVWorker as JaxKVWorker
from parameter_server_tpu_torch import checkpoint
from parameter_server_tpu_torch import config as port_config
from parameter_server_tpu_torch.config import CheckpointConfig
from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.kv import replica as replica_lib
from parameter_server_tpu_torch.kv.migrate import ShardMigrator
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.utils.keys import HashLocalizer

ROWS = 1024
DIM = 4
SEED = 1234
TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(rows=ROWS, dim=DIM, cfg=port_config):
    return {"w": cfg.TableConfig(
        name="w", rows=rows, dim=dim,
        optimizer=cfg.OptimizerConfig(kind="adagrad", learning_rate=0.5),
    )}


class _Fleet:
    """Servers, one worker and a migrator of either package on one van."""

    def __init__(self, pkg, num_servers, *, rows=ROWS, dim=DIM):
        self.pkg = pkg
        if pkg == "port":
            self.van = LoopbackVan()
            self.cfgs = _cfgs(rows, dim)
            self.servers = [KVServer(Postoffice(f"S{i}", self.van), self.cfgs, i, num_servers,
                                     device="cpu") for i in range(num_servers)]
            self.worker = KVWorker(Postoffice("W0", self.van), self.cfgs, num_servers,
                                   min_bucket=16, device="cpu")
            self.migrator = ShardMigrator(Postoffice("M0", self.van), chunk_rows=128)
        else:
            self.van = JaxLoopbackVan()
            self.cfgs = _cfgs(rows, dim, cfg=jax_config)
            self.servers = [JaxKVServer(JaxPostoffice(f"S{i}", self.van), self.cfgs, i,
                                        num_servers) for i in range(num_servers)]
            self.worker = JaxKVWorker(JaxPostoffice("W0", self.van), self.cfgs, num_servers,
                                      min_bucket=16)
            self.migrator = JaxShardMigrator(JaxPostoffice("M0", self.van), chunk_rows=128)

    def migrate(self, lo, hi, to):
        assert self.worker.adopt_routing(self.migrator.migrate(self.worker.routing, "w",
                                                               lo, hi, to))

    def pull(self, keys):
        return np.asarray(self.worker.pull_sync("w", keys, timeout=30))

    def rows(self):
        """The whole table, value and state, stitched from the shards."""
        parts = []
        for lo, hi, owner in self.worker.routing.tables["w"].segments():
            v, st = self.servers[owner].export_range("w", lo, hi)
            parts.append((v, st))
        return (np.concatenate([v for v, _ in parts]),
                {k: np.concatenate([st[k] for _, st in parts]) for k in parts[0][1]})

    def close(self):
        self.van.close()
        for s in self.servers:
            if s.ledger is not None:
                s.ledger.close()


def _push(worker, *, seed, count=256, dim=DIM):
    rng = np.random.RandomState(seed)
    keys = np.unique(rng.randint(0, 1 << 31, size=count).astype(np.uint64))
    grads = rng.randn(keys.size, dim).astype(np.float32)
    worker.push_sync("w", keys, grads, timeout=30)
    return keys, grads


def _keys_hashing_into(lo, hi, count, *, rows=ROWS):
    """Raw keys whose HashLocalizer slot lands in global rows [lo, hi)."""
    loc = HashLocalizer(rows)
    found, k = [], 0
    while len(found) < count:
        cand = np.arange(k, k + 4096, dtype=np.int64)
        slots = loc.assign(cand.astype(np.uint64))
        found.extend(int(x) for x in cand[(slots >= lo) & (slots < hi)])
        k += 4096
    return np.asarray(found[:count], dtype=np.uint64)


def _push_keys(worker, keys, *, seed, dim=DIM):
    grads = np.random.RandomState(seed).randn(keys.size, dim).astype(np.float32)
    worker.push_sync("w", keys, grads, timeout=30)


def _assert_rows_equal(got, want):
    np.testing.assert_array_equal(got[0], want[0])
    assert sorted(got[1]) == sorted(want[1])
    for k in want[1]:
        np.testing.assert_array_equal(got[1][k], want[1][k])


# ------------------------------------------------- 1. reshard-restore parity


def test_rebalanced_snapshot_restores_to_any_fleet_shape(tmp_path):
    out = {}
    for pkg in ("jax", "port"):
        root = str(tmp_path / pkg)
        fleet = _Fleet(pkg, 3)
        try:
            keys, _ = _push(fleet.worker, seed=SEED)
            # move the tail of S2's range onto S0: a layout the legacy
            # format cannot express
            fleet.migrate(800, ROWS, 0)
            _push(fleet.worker, seed=SEED + 1)
            summary = fleet.worker.save_snapshot(root, 7)
            assert summary["segments"] == len(fleet.worker.routing.tables["w"].segments())
            ref = fleet.pull(keys)
            extra = np.random.RandomState(SEED + 2).randn(keys.size, DIM).astype(np.float32)
            fleet.worker.push_sync("w", keys, extra, timeout=30)
            ref_after = fleet.pull(keys)
        finally:
            fleet.close()
        out[pkg] = ref_after
        if pkg == "jax":
            continue
        for n in (2, 5):
            fleet2 = _Fleet("port", n)
            try:
                fleet2.worker.load_snapshot(root, 7)
                np.testing.assert_array_equal(fleet2.pull(keys), ref)
                # optimizer state restored bitwise: the same gradient takes the
                # same AdaGrad step as it did on the writer fleet
                fleet2.worker.push_sync("w", keys, extra, timeout=30)
                np.testing.assert_array_equal(fleet2.pull(keys), ref_after)
            finally:
                fleet2.close()
    np.testing.assert_allclose(out["port"], out["jax"], **TOL)


# ------------------------------------------- 2. incremental chain == full


def test_incremental_chain_bitwise_equals_full_snapshot(tmp_path):
    root = str(tmp_path)
    fleet = _Fleet("port", 3)
    try:
        _push(fleet.worker, seed=SEED)
        fleet.worker.save_snapshot(root, 1)
        # writes confined to the first segment, so the other two segments'
        # version clocks stand still and their files carry
        seg0 = fleet.worker.routing.tables["w"].segments()[0]
        hot = _keys_hashing_into(seg0[0], seg0[1], 24)
        _push_keys(fleet.worker, hot, seed=SEED + 1)
        inc2 = fleet.worker.save_snapshot(root, 2, base_step=1)
        _push_keys(fleet.worker, hot, seed=SEED + 2)
        inc3 = fleet.worker.save_snapshot(root, 3, base_step=2)
        assert inc2["carried"] + inc3["carried"] > 0
        full = fleet.worker.save_snapshot(root, 9)
        m_chain = checkpoint.read_snapshot(root, 3)
        m_full = checkpoint.read_snapshot(root, 9)
        assert m_chain["base_step"] == 2 and m_full["base_step"] is None
        _assert_rows_equal(checkpoint.snapshot_rows(root, m_chain, "w", 0, ROWS),
                           checkpoint.snapshot_rows(root, m_full, "w", 0, ROWS))
        assert full["carried"] == 0
    finally:
        fleet.close()


# --------------------------- 3. non-blocking: dirty-delta-bounded freeze


def test_commit_freeze_is_delta_bounded(tmp_path, record_property):
    """Pushes land inside the open window (after ``snap_begin``, and after
    the segment files are written); the commit exports exactly the rows they
    touched, fewer than any shard holds, and the restore sees them."""
    root = str(tmp_path)
    rows = 3 * 4096
    fleet = _Fleet("port", 3, rows=rows, dim=32)
    worker, servers = fleet.worker, fleet.servers
    try:
        def control(payloads_by_server):
            msgs = [Message(task=Task(TaskKind.CONTROL, worker.name, payload=p),
                            recver=f"S{s}") for s, p in payloads_by_server]
            return worker._control_round(msgs, "snap", 30)

        _push(worker, seed=SEED, count=2048, dim=32)
        sid = "freeze-drill"
        control([(s, {"op": "snap_begin", "sid": sid}) for s in range(3)])
        k1, _ = _push(worker, seed=SEED + 1, count=64, dim=32)
        writes = [(owner, {"op": "snap_write", "sid": sid, "root": root, "step": 1,
                           "table": "w", "lo": lo, "hi": hi})
                  for lo, hi, owner in worker.routing.tables["w"].segments()]
        entries = [dict(r.task.payload["entry"]) for r in control(writes)]
        k2, _ = _push(worker, seed=SEED + 2, count=64, dim=32)
        deltas, freezes = [], []
        for r in control([(s, {"op": "snap_commit", "sid": sid, "root": root, "step": 1})
                          for s in range(3)]):
            deltas.extend(r.task.payload["deltas"])
            freezes.append(float(r.task.payload["freeze_s"]))
        loc = worker.localizers["w"]
        dirty = np.unique(np.concatenate([loc.assign(k1), loc.assign(k2)]).astype(np.int64))
        delta_rows = sum(d["rows"] for d in deltas)
        assert delta_rows == dirty.size > 0
        logged = set()
        for d in deltas:
            with np.load(os.path.join(root, d["file"])) as z:
                logged.update(int(x) for x in z["rows"])
        assert logged == set(dirty.tolist())
        # the bound: no server's delta reaches its shard's rows
        for srv in servers:
            assert delta_rows < srv.tables["w"].rows
        # reported, not asserted: the freeze against a blocking full export
        t0 = time.perf_counter()
        v, st = servers[0].export_range("w", 0, 4096)
        checkpoint.write_segment_file(root, 99, "w", 0, 4096, v, st)
        record_property("freeze_s_max", max(freezes))
        record_property("full_export_s", time.perf_counter() - t0)
        checkpoint.finalize_snapshot(root, 1, worker.routing.to_payload(), entries, deltas)
        ref = fleet.pull(k2)
    finally:
        fleet.close()
    fleet2 = _Fleet("port", 2, rows=rows, dim=32)
    try:
        fleet2.worker.load_snapshot(root, 1)
        np.testing.assert_array_equal(fleet2.pull(k2), ref)
    finally:
        fleet2.close()


# ------------------------------------------------ 4. kill mid-snapshot


def test_kill_mid_snapshot_leaves_previous_restore_point(tmp_path, monkeypatch):
    root = str(tmp_path)
    fleet = _Fleet("port", 3)
    try:
        keys, _ = _push(fleet.worker, seed=SEED)
        fleet.worker.save_snapshot(root, 1)
        assert checkpoint.latest_snapshot(root) == 1
        _push(fleet.worker, seed=SEED + 1)
        real_write = checkpoint.write_segment_file
        calls = {"n": 0}

        def dying_write(*a, **kw):
            calls["n"] += 1
            if calls["n"] == 2:  # the first segment lands, then the "crash"
                raise OSError("server killed mid-snapshot")
            return real_write(*a, **kw)

        monkeypatch.setattr(checkpoint, "write_segment_file", dying_write)
        with pytest.raises(RuntimeError):
            fleet.worker.save_snapshot(root, 2)
        monkeypatch.undo()
        assert not os.path.exists(os.path.join(root, "snap_000002", "MANIFEST.json"))
        assert checkpoint.latest_snapshot(root) == 1
        assert all(not s._snapshots for s in fleet.servers)
        fleet.worker.save_snapshot(root, 3)  # the plane is not wedged
        assert checkpoint.latest_snapshot(root) == 3
        ref = fleet.pull(keys)
    finally:
        fleet.close()
    fleet2 = _Fleet("port", 2)
    try:
        fleet2.worker.load_snapshot(root, 3)
        np.testing.assert_array_equal(fleet2.pull(keys), ref)
    finally:
        fleet2.close()
    checkpoint.retain_snapshots(root, 2)  # sweeps the aborted step-2 dir
    assert not os.path.isdir(os.path.join(root, "snap_000002"))


# ------------------------------------------------------- 5. CRC armour


def test_finalize_refuses_torn_segment_file(tmp_path):
    root = str(tmp_path)
    rng = np.random.RandomState(0)
    v = rng.randn(8, 4).astype(np.float32)
    st = {"g2": rng.rand(8, 4).astype(np.float32)}
    e1 = checkpoint.write_segment_file(root, 1, "w", 0, 8, v, st)
    e2 = checkpoint.write_segment_file(root, 1, "w", 8, 16, v, st)
    routing = {"tables": {"w": {"rows": 16}}}
    path = os.path.join(root, e2["file"])
    with open(path, "r+b") as f:  # the torn-write shape a crash leaves
        f.truncate(os.path.getsize(path) // 2)
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.finalize_snapshot(root, 1, routing, [e1, e2], [])
    assert checkpoint.latest_snapshot(root) is None
    os.unlink(path)
    with pytest.raises(FileNotFoundError):
        checkpoint.finalize_snapshot(root, 1, routing, [e1, e2], [])
    with pytest.raises(checkpoint.CheckpointCorruptError):  # a coverage gap
        checkpoint.finalize_snapshot(root, 1, routing, [e1], [])


def test_corrupt_manifest_is_rejected_and_skipped(tmp_path):
    root = str(tmp_path)
    fleet = _Fleet("port", 2)
    try:
        _push(fleet.worker, seed=SEED)
        fleet.worker.save_snapshot(root, 1)
        _push(fleet.worker, seed=SEED + 1)
        fleet.worker.save_snapshot(root, 2)
    finally:
        fleet.close()
    mpath = os.path.join(root, "snap_000002", "MANIFEST.json")
    with open(mpath) as f:
        doc = json.load(f)
    doc["segments"][0]["crc"] = int(doc["segments"][0]["crc"]) ^ 0xBEEF
    with open(mpath, "w") as f:
        json.dump(doc, f)
    for ckpt in (checkpoint, jax_checkpoint):  # both packages refuse it
        with pytest.raises(ckpt.CheckpointCorruptError):
            ckpt.read_snapshot(root, 2)
        assert ckpt.latest_snapshot(root) == 1
    with open(mpath, "w") as f:
        f.write("{ torn")
    with pytest.raises(checkpoint.CheckpointCorruptError):
        checkpoint.read_snapshot(root, 2)


# ---------------------------------------------- 6. restore-source ordering


def test_restart_restore_source_ordering(tmp_path):
    root = str(tmp_path)
    fleet = _Fleet("port", 1)
    van, cfgs = fleet.van, fleet.cfgs
    try:
        keys, _ = _push(fleet.worker, seed=SEED)
        fleet.worker.save_model(root, 1)  # legacy uniform checkpoint
        _push(fleet.worker, seed=SEED + 1)
        fleet.worker.save_snapshot(root, 2)  # partitioned, newer
        ref = fleet.pull(keys)
        s, source = replica_lib.restart_same_id(van, cfgs, 0, 1, ckpt_root=root, device="cpu")
        assert source == "partitioned"
        np.testing.assert_array_equal(fleet.pull(keys), ref)
        standby = KVServer(Postoffice("R0", van), cfgs, 0, 1, device="cpu")
        standby.import_shard(s.export_shard())
        _s2, source = replica_lib.restart_same_id(van, cfgs, 0, 1, standby=standby,
                                                  ckpt_root=root, device="cpu")
        assert source == "replica"
        for step in checkpoint.list_snapshots(root):
            with open(os.path.join(root, f"snap_{step:06d}", "MANIFEST.json"), "w") as f:
                f.write("not json")
        _s3, source = replica_lib.restart_same_id(van, cfgs, 0, 1, ckpt_root=root,
                                                  device="cpu")
        assert source == "checkpoint"
        _s4, source = replica_lib.restart_same_id(van, cfgs, 0, 1,
                                                  ckpt_root=str(tmp_path / "empty"),
                                                  device="cpu")
        assert source == "cold"
        fleet.servers += [s, standby, _s2, _s3, _s4]
    finally:
        fleet.close()


def test_restart_after_migration_adopts_snapshot_routing(tmp_path):
    """A same-id restart on a migrated fleet rejoins at the snapshot's
    routing epoch: a fresh server starts at the uniform epoch 0 and would not
    own its migrated segments, so every worker leg into them would fence."""
    root = str(tmp_path)
    out = {}
    for pkg in ("jax", "port"):
        fleet = _Fleet(pkg, 3)
        try:
            keys, _ = _push(fleet.worker, seed=SEED)
            fleet.migrate(800, ROWS, 0)
            _push(fleet.worker, seed=SEED + 1)
            if pkg == "jax":
                out[pkg] = fleet.pull(keys)
                continue
            fleet.worker.save_snapshot(root, 1)
            ref = fleet.pull(keys)
            fleet.van.unbind("S0")
            fleet.van.unbind("S0.fw")
            srv, source = replica_lib.restart_same_id(fleet.van, fleet.cfgs, 0, 3,
                                                      ckpt_root=root, device="cpu")
            fleet.servers.append(srv)
            assert source == "partitioned"
            assert srv.routing.epoch == fleet.worker.routing.epoch == 1
            np.testing.assert_array_equal(fleet.pull(keys), ref)
            _push(fleet.worker, seed=SEED + 2)  # training goes on through it
            assert not np.array_equal(fleet.pull(keys), ref)
            out[pkg] = ref
        finally:
            fleet.close()
    np.testing.assert_allclose(out["port"], out["jax"], **TOL)


# --------------------------------------------------- 7. typed layout error


def test_legacy_guard_raises_typed_layout_error(tmp_path):
    fleet = _Fleet("port", 2)
    try:
        _push(fleet.worker, seed=SEED)
        fleet.migrate(900, ROWS, 0)
        with pytest.raises(checkpoint.CheckpointLayoutError):
            fleet.servers[0].save_checkpoint(str(tmp_path), 1)
        assert issubclass(checkpoint.CheckpointLayoutError, RuntimeError)
        # over the wire too: the worker's save fails and commits nothing
        with pytest.raises(RuntimeError, match="CheckpointLayoutError"):
            fleet.worker.save_model(str(tmp_path), 1)
        assert checkpoint.latest_step(str(tmp_path)) is None
        fleet.worker.save_snapshot(str(tmp_path), 1)  # the partitioned plane takes it
        assert checkpoint.latest_snapshot(str(tmp_path)) == 1
    finally:
        fleet.close()


@pytest.mark.parametrize("kw", [dict(interval_s=0), dict(max_delta_rows=0),
                                dict(retention=-1), dict(mode="sometimes"), {}])
def test_checkpoint_config_validation(kw):
    """The port's CheckpointConfig accepts and refuses what the JAX one does."""
    try:
        jax_config.CheckpointConfig(**kw)
    except ValueError:
        with pytest.raises(ValueError):
            CheckpointConfig(**kw)
    else:
        assert CheckpointConfig(**kw).__dict__ == jax_config.CheckpointConfig(**kw).__dict__


# ------------------------------------------------- 8. retention + chains


def test_retention_preserves_incremental_chain_bases(tmp_path):
    root = str(tmp_path)
    fleet = _Fleet("port", 3)
    try:
        keys, _ = _push(fleet.worker, seed=SEED)
        fleet.worker.save_snapshot(root, 1)
        fleet.worker.save_snapshot(root, 2, base_step=1)  # carries everything
        fleet.worker.save_snapshot(root, 3, base_step=2)
        ref = fleet.pull(keys)
    finally:
        fleet.close()
    checkpoint.retain_snapshots(root, 1)
    assert checkpoint.list_snapshots(root)[-1] == 3
    assert os.path.isdir(os.path.join(root, "snap_000001"))
    fleet2 = _Fleet("port", 2)
    try:
        fleet2.worker.load_snapshot(root, 3)
        np.testing.assert_array_equal(fleet2.pull(keys), ref)
    finally:
        fleet2.close()
    checkpoint.retain_snapshots(root, 0)
    assert checkpoint.list_snapshots(root) == []


# ------------------------------------------------- counters and events


def test_ckpt_counters_and_events_flow(tmp_path):
    flightrec.configure(enabled=True, clear=True)
    fleet = _Fleet("port", 2)
    try:
        servers, worker = fleet.servers, fleet.worker
        before = servers[0].counters()
        assert before["ckpt_commits"] == 0 and before["ckpt_age_s"] >= 0.0
        _push(worker, seed=SEED)
        worker.save_snapshot(str(tmp_path), 1)
        after = servers[0].counters()
        assert after["ckpt_commits"] == 1
        assert after["ckpt_age_s"] <= before["ckpt_age_s"] + 1.0
        kinds = {e["kind"] for e in flightrec.get().events() if e.get("node") == "S0"}
        assert {"ckpt.begin", "ckpt.segment", "ckpt.commit"} <= kinds
        # routing churn aborts an open snapshot, journalled as an anomaly
        msgs = [Message(task=Task(TaskKind.CONTROL, worker.name,
                                  payload={"op": "snap_begin", "sid": "doomed"}), recver="S0")]
        worker._control_round(msgs, "snap_begin", 30)
        fleet.migrate(900, ROWS, 0)
        assert not servers[0]._snapshots
        aborts = [e for e in flightrec.get().events()
                  if e["kind"] == "ckpt.abort" and e.get("node") == "S0"]
        assert aborts and "ckpt.abort" in flightrec.anomaly_kinds()
    finally:
        fleet.close()
        flightrec.configure(enabled=True, clear=True)


# ------------------------------------------------- the files across packages


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")],
                         ids=["jax_to_port", "port_to_jax"])
def test_format2_chain_crosses_packages(tmp_path, writer, reader):
    """A migrated 3-server fleet of one package writes a full snapshot and an
    incremental one (pushes confined to one segment, so files carry); the
    other package restores the chain onto 2 servers: every row of value and
    state bit for bit, and the manifest reads the same in both."""
    root = str(tmp_path)
    fleet = _Fleet(writer, 3)
    try:
        _push(fleet.worker, seed=SEED)
        fleet.migrate(800, ROWS, 0)
        _push(fleet.worker, seed=SEED + 1)
        fleet.worker.save_snapshot(root, 1)
        seg0 = fleet.worker.routing.tables["w"].segments()[0]
        _push_keys(fleet.worker, _keys_hashing_into(seg0[0], seg0[1], 24), seed=SEED + 2)
        inc = fleet.worker.save_snapshot(root, 2, base_step=1)
        assert inc["carried"] > 0
        want = fleet.rows()
    finally:
        fleet.close()
    assert checkpoint.read_snapshot(root, 2) == jax_checkpoint.read_snapshot(root, 2)
    fleet2 = _Fleet(reader, 2)
    try:
        fleet2.worker.load_snapshot(root, 2)
        got = fleet2.rows()
    finally:
        fleet2.close()
    assert np.abs(want[0]).max() > 0
    _assert_rows_equal(got, want)
