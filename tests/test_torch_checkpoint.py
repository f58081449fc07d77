"""The port's legacy checkpoints against the JAX package's, on the CPU.

Ports of ``tests/test_checkpoint.py`` (all but the offline-eval case, which
needs ``evaluation.py``): a sharded save over the Van and its restore, the
optimizer state surviving a resume, the elastic restore onto another server
count, the commit marker, retention, a failing save raising, and the dense
store's roundtrip and reshard.  Then the files themselves: a checkpoint
written by the JAX package restores in the port and one written by the port
restores in the JAX package, sparse and dense, onto another server count.

Tolerances: a restore reproduces the saved rows bit for bit (tolerance 0),
in either package; training math against the JAX package (the same seeded
pushes through both) rtol = atol = 1e-5, as in ``test_torch_ps_loop.py``.
"""

import dataclasses
import json
import os
import zipfile

import numpy as np
import pytest
import torch

from parameter_server_tpu import checkpoint as jax_checkpoint
from parameter_server_tpu import config as jax_config
from parameter_server_tpu.core.postoffice import Postoffice as JaxPostoffice
from parameter_server_tpu.core.van import LoopbackVan as JaxLoopbackVan
from parameter_server_tpu.kv.dense import DenseKVServer as JaxDenseKVServer
from parameter_server_tpu.kv.dense import DenseKVWorker as JaxDenseKVWorker
from parameter_server_tpu.kv.server import KVServer as JaxKVServer
from parameter_server_tpu.kv.worker import KVWorker as JaxKVWorker
from parameter_server_tpu_torch import checkpoint
from parameter_server_tpu_torch import config as port_config
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.kv.dense import DenseKVServer, DenseKVWorker
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.table import KVTable
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.utils.keys import HashLocalizer

TOL = dict(rtol=1e-5, atol=1e-5)


def _cfgs(rows=1000, dim=4, kind="adagrad", cfg=port_config):
    return {"w": cfg.TableConfig(
        name="w", rows=rows, dim=dim,
        optimizer=cfg.OptimizerConfig(kind=kind, learning_rate=0.5),
    )}


class _Fleet:
    """Servers + one worker of either package on its own LoopbackVan."""

    def __init__(self, pkg, num_servers, *, rows=1000, dim=4, kind="adagrad",
                 localizers=None):
        self.pkg = pkg
        if pkg == "port":
            self.van = LoopbackVan()
            cfgs = _cfgs(rows, dim, kind)
            self.servers = [KVServer(Postoffice(f"S{i}", self.van), cfgs, i, num_servers,
                                     device="cpu") for i in range(num_servers)]
            self.worker = KVWorker(Postoffice("W0", self.van), cfgs, num_servers,
                                   min_bucket=16, localizers=localizers, device="cpu")
        else:
            self.van = JaxLoopbackVan()
            cfgs = _cfgs(rows, dim, kind, cfg=jax_config)
            self.servers = [JaxKVServer(JaxPostoffice(f"S{i}", self.van), cfgs, i, num_servers)
                            for i in range(num_servers)]
            self.worker = JaxKVWorker(JaxPostoffice("W0", self.van), cfgs, num_servers,
                                      min_bucket=16, localizers=localizers)

    def push(self, keys, grads):
        assert self.worker.wait(self.worker.push("w", keys, grads), timeout=30)

    def pull(self, keys):
        return np.asarray(self.worker.pull_sync("w", keys, timeout=30))

    def rows(self):
        """The whole table, value and state, stitched from the shards."""
        parts = []
        for i, srv in enumerate(self.servers):
            for lo, hi in self.worker.routing.tables["w"].owned_segments(i):
                v, st = srv.export_range("w", lo, hi)
                parts.append((lo, v, st))
        parts.sort(key=lambda p: p[0])
        return (np.concatenate([v for _, v, _ in parts]),
                {k: np.concatenate([st[k] for _, _, st in parts]) for k in parts[0][2]})

    def close(self):
        self.van.close()
        for s in self.servers:
            if s.ledger is not None:
                s.ledger.close()


def _seeded(seed, n=64, dim=4):
    rng = np.random.RandomState(seed)
    keys = np.unique(rng.randint(0, 1 << 31, size=n).astype(np.uint64))
    return keys, rng.randn(keys.size, dim).astype(np.float32)


def test_save_restore_roundtrip(tmp_path):
    keys = np.arange(0, 64, dtype=np.uint64) * 7919
    grads = np.random.RandomState(0).randn(64, 4).astype(np.float32)
    out = {}
    for pkg in ("jax", "port"):
        fleet = _Fleet(pkg, 2)
        try:
            fleet.push(keys, grads)
            before = fleet.pull(keys)
            root = str(tmp_path / pkg)
            fleet.worker.save_model(root, step=3, clocks=[1, 1], extras={"epoch": 2})
            for s in fleet.servers:  # clobber the tables, then restore over the Van
                t = s.tables["w"]
                t.set_value(np.full((t.rows + 1, t.dim), 9.0, np.float32))
            fleet.worker.load_model(root, step=3)
            after = fleet.pull(keys)
            out[pkg] = before
        finally:
            fleet.close()
        if pkg == "port":
            np.testing.assert_array_equal(after, before)
        else:
            np.testing.assert_allclose(after, before, rtol=1e-6)
        info = checkpoint.read_info(root, 3)
        assert info.clocks == [1, 1] and info.extras["epoch"] == 2
        # the key -> row mapping is recorded for offline eval
        assert info.extras["localizers"]["w"]["kind"] == "HashLocalizer"
        assert info.extras["localizers"]["w"]["hash_bits"] == 64
        assert checkpoint.latest_step(root) == 3
    np.testing.assert_allclose(out["port"], out["jax"], **TOL)
    # the two manifests say the same thing
    with open(tmp_path / "jax" / "step_000003" / "MANIFEST.json") as f:
        jm = json.load(f)
    with open(tmp_path / "port" / "step_000003" / "MANIFEST.json") as f:
        pm = json.load(f)
    assert pm == jm


def test_optimizer_state_survives_resume(tmp_path):
    """Resume continues the AdaGrad trajectory, it does not restart it."""
    keys = np.array([11, 22, 33], dtype=np.uint64)
    g = np.ones((3, 4), dtype=np.float32)
    loc = {"w": HashLocalizer(1000)}
    out = {}
    for pkg in ("jax", "port"):
        root = str(tmp_path / pkg)
        fleet = _Fleet(pkg, 2, localizers=loc)
        try:
            fleet.push(keys, g)
            fleet.worker.save_model(root, step=1)
            fleet.push(keys, g)
            truth = fleet.pull(keys)
        finally:
            fleet.close()
        fresh = _Fleet(pkg, 2, localizers=loc)
        try:
            fresh.worker.load_model(root, step=1)
            fresh.push(keys, g)
            resumed = fresh.pull(keys)
        finally:
            fresh.close()
        if pkg == "port":
            np.testing.assert_array_equal(resumed, truth)
        out[pkg] = resumed
    np.testing.assert_allclose(out["port"], out["jax"], **TOL)


@pytest.mark.parametrize("new_servers", [1, 3, 4])
def test_elastic_restore_different_server_count(tmp_path, new_servers):
    """Save with 2 servers, restore with N: the elastic reshard."""
    loc = {"w": HashLocalizer(500)}
    keys = (np.arange(80, dtype=np.uint64) * 104729) % 100000
    grads = np.random.RandomState(1).randn(80, 2).astype(np.float32)
    fleet = _Fleet("port", 2, rows=500, dim=2, kind="sgd", localizers=loc)
    try:
        fleet.push(keys, grads)
        before = fleet.pull(keys)
        fleet.worker.save_model(str(tmp_path), step=7)
    finally:
        fleet.close()
    fleet2 = _Fleet("port", new_servers, rows=500, dim=2, kind="sgd", localizers=loc)
    try:
        fleet2.worker.load_model(str(tmp_path), step=7)
        np.testing.assert_array_equal(fleet2.pull(keys), before)
    finally:
        fleet2.close()


@pytest.mark.parametrize("ckpt", [checkpoint, jax_checkpoint], ids=["port", "jax"])
def test_uncommitted_checkpoint_ignored(tmp_path, ckpt):
    """No manifest, no checkpoint: the same verdict from both packages on a
    shard the port wrote."""
    table = KVTable(_cfgs(rows=100, dim=1)["w"], rows=100, device="cpu")
    checkpoint.save_shard(str(tmp_path), 5, "w", table, 0, 1, 0)
    assert ckpt.latest_step(str(tmp_path)) is None
    ckpt.finalize(str(tmp_path), 5, 1, {"w": 100})
    assert checkpoint.latest_step(str(tmp_path)) == jax_checkpoint.latest_step(str(tmp_path)) == 5


def test_finalize_refuses_missing_shards(tmp_path):
    table = KVTable(_cfgs(rows=100, dim=1)["w"], rows=50, device="cpu")
    checkpoint.save_shard(str(tmp_path), 2, "w", table, 0, 2, 0)
    with pytest.raises(FileNotFoundError):
        checkpoint.finalize(str(tmp_path), 2, 2, {"w": 100})


def test_load_global_weights_and_retain(tmp_path):
    cfg = _cfgs(rows=100, dim=3)["w"]
    full = np.arange(300, dtype=np.float32).reshape(100, 3)
    for step in (1, 2, 3):
        for s, (lo, hi) in enumerate(((0, 50), (50, 100))):
            t = KVTable(cfg, rows=hi - lo, device="cpu")
            buf = np.zeros((t.rows + 1, 3), np.float32)
            buf[: t.rows] = full[lo:hi] * step
            t.set_value(torch.from_numpy(buf))
            checkpoint.save_shard(str(tmp_path), step, "w", t, s, 2, lo)
        checkpoint.finalize(str(tmp_path), step, 2, {"w": 100})
    got = checkpoint.load_global_weights(str(tmp_path), 2, "w")
    np.testing.assert_array_equal(got, full * 2)
    # the JAX package reads the port's files to the same rows
    np.testing.assert_array_equal(jax_checkpoint.load_global_weights(str(tmp_path), 2, "w"), got)
    checkpoint.retain(str(tmp_path), keep=1)
    assert checkpoint.list_steps(str(tmp_path)) == [3]


def test_save_model_failure_raises_not_hangs(tmp_path):
    """A server-side save error surfaces as an exception on the worker (an
    error reply), not as an endless wait for the missing response."""
    fleet = _Fleet("port", 2, rows=100, dim=1)
    try:
        bad = tmp_path / "not_a_dir"
        bad.write_text("file in the way")
        with pytest.raises(RuntimeError, match="failed on"):
            fleet.worker.save_model(str(bad / "ckpt"), step=1, timeout=30)
    finally:
        fleet.close()


def test_retain_keep_zero_deletes_all(tmp_path):
    fleet = _Fleet("port", 2)
    try:
        for step in (1, 2, 3):
            fleet.worker.save_model(str(tmp_path), step=step)
        checkpoint.retain(str(tmp_path), keep=2)
        assert checkpoint.list_steps(str(tmp_path)) == [2, 3]
        checkpoint.retain(str(tmp_path), keep=0)
        assert checkpoint.list_steps(str(tmp_path)) == []
        with pytest.raises(ValueError):
            checkpoint.retain(str(tmp_path), keep=-1)
    finally:
        fleet.close()


# -- the dense store -------------------------------------------------------------


class _DenseFleet:
    def __init__(self, pkg, num_servers, total):
        self.pkg = pkg
        if pkg == "port":
            self.van = LoopbackVan()
            opt = port_config.OptimizerConfig(kind="adagrad", learning_rate=0.5)
            self.servers = [DenseKVServer(Postoffice(f"S{i}", self.van), {"m": (total, opt)},
                                          i, num_servers, device="cpu")
                            for i in range(num_servers)]
            self.worker = DenseKVWorker(Postoffice("W0", self.van), {"m": total}, num_servers,
                                        device="cpu")
        else:
            self.van = JaxLoopbackVan()
            opt = jax_config.OptimizerConfig(kind="adagrad", learning_rate=0.5)
            self.servers = [JaxDenseKVServer(JaxPostoffice(f"S{i}", self.van),
                                             {"m": (total, opt)}, i, num_servers)
                            for i in range(num_servers)]
            self.worker = JaxDenseKVWorker(JaxPostoffice("W0", self.van), {"m": total},
                                           num_servers)

    def push(self, vec):
        assert self.worker.wait(self.worker.push("m", vec), timeout=30)

    def pull(self):
        out = self.worker.pull_sync("m", timeout=30)
        return out.numpy() if isinstance(out, torch.Tensor) else np.asarray(out)

    def state(self):
        """The whole vector's value and state, stitched from the segments."""
        segs = [s.segments["m"] for s in self.servers]
        return (np.concatenate([np.asarray(g["value"]) for g in segs]),
                {k: np.concatenate([np.asarray(g["state"][k]) for g in segs])
                 for k in segs[0]["state"]})

    def close(self):
        self.van.close()


def test_dense_checkpoint_roundtrip_and_reshard(tmp_path):
    """Dense segments save and restore, onto a new server count too."""
    total = 1000
    rng = np.random.RandomState(0)
    grads = [rng.randn(total).astype(np.float32) for _ in range(3)]
    out = {}
    for pkg in ("jax", "port"):
        root = str(tmp_path / pkg)
        fleet = _DenseFleet(pkg, 2, total)
        try:
            for g in grads:
                fleet.push(g)
            before = fleet.pull()
            fleet.worker.save_model(root, step=4, clocks=[3])
        finally:
            fleet.close()
        fleet2 = _DenseFleet(pkg, 3, total)
        try:
            fleet2.worker.load_model(root, step=4)
            after = fleet2.pull()
            if pkg == "port":
                np.testing.assert_array_equal(after, before)
            else:
                np.testing.assert_allclose(after, before, rtol=1e-6)
            # the optimizer state came back too: one more push moves the weights
            fleet2.push(np.ones(total, np.float32))
            moved = fleet2.pull()
            assert np.abs(moved - after).max() > 1e-4
            out[pkg] = moved
        finally:
            fleet2.close()
        assert checkpoint.read_info(root, 4).clocks == [3]
    np.testing.assert_allclose(out["port"], out["jax"], **TOL)


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")],
                         ids=["jax_to_port", "port_to_jax"])
def test_dense_checkpoint_crosses_packages(tmp_path, writer, reader):
    """A dense checkpoint written by one package restores in the other onto 3
    servers, every element of value and state bit for bit."""
    total = 1001
    rng = np.random.RandomState(4)
    fleet = _DenseFleet(writer, 2, total)
    try:
        for _ in range(2):
            fleet.push(rng.randn(total).astype(np.float32))
        want_v, want_s = fleet.state()
        fleet.worker.save_model(str(tmp_path), step=1)
    finally:
        fleet.close()
    fleet2 = _DenseFleet(reader, 3, total)
    try:
        fleet2.worker.load_model(str(tmp_path), step=1)
        got_v, got_s = fleet2.state()
    finally:
        fleet2.close()
    np.testing.assert_array_equal(got_v, want_v)
    assert sorted(got_s) == sorted(want_s)
    for k in want_s:
        np.testing.assert_array_equal(got_s[k], want_s[k])


# -- the files, across packages ------------------------------------------------------


@pytest.mark.parametrize("writer,reader", [("jax", "port"), ("port", "jax")],
                         ids=["jax_to_port", "port_to_jax"])
def test_legacy_checkpoint_crosses_packages(tmp_path, writer, reader):
    """A legacy checkpoint written by one package (2 servers, AdaGrad, after
    seeded pushes) restores in the other onto 3 servers: every row of value
    and state bit for bit."""
    root = str(tmp_path)
    fleet = _Fleet(writer, 2)
    try:
        for seed in (1, 2, 3):
            fleet.push(*_seeded(seed))
        want_v, want_s = fleet.rows()
        fleet.worker.save_model(root, step=5, clocks=[3])
    finally:
        fleet.close()
    fleet2 = _Fleet(reader, 3)
    try:
        fleet2.worker.load_model(root, step=5)
        got_v, got_s = fleet2.rows()
    finally:
        fleet2.close()
    assert np.abs(want_v).max() > 0
    np.testing.assert_array_equal(got_v, want_v)
    np.testing.assert_array_equal(got_s["sum_sq"], want_s["sum_sq"])


def test_legacy_shard_files_have_the_same_members(tmp_path):
    """One table state saved by both packages: the same file names, npz
    members in the same order with the same dtypes and shapes, the same
    bytes of every array, and equal manifests."""
    rows = 100
    rng = np.random.RandomState(7)
    value = rng.randn(rows + 1, 3).astype(np.float32)
    sum_sq = rng.rand(rows + 1, 3).astype(np.float32)
    pt = KVTable(_cfgs(rows=rows, dim=3)["w"], rows=rows, device="cpu")
    pt.set_value(torch.from_numpy(value))
    pt.state["sum_sq"] = torch.from_numpy(sum_sq.copy())
    from parameter_server_tpu.kv.table import KVTable as JaxKVTable
    import jax.numpy as jnp

    jt = JaxKVTable(_cfgs(rows=rows, dim=3, cfg=jax_config)["w"], rows=rows)
    jt.value = jnp.asarray(value)
    jt.state["sum_sq"] = jnp.asarray(sum_sq)
    for pkg, ckpt, table in (("port", checkpoint, pt), ("jax", jax_checkpoint, jt)):
        ckpt.save_shard(str(tmp_path / pkg), 1, "w", table, 0, 1, 0)
        ckpt.finalize(str(tmp_path / pkg), 1, 1, {"w": rows}, clocks=[2])
    names = {pkg: sorted(os.listdir(tmp_path / pkg / "step_000001")) for pkg in ("port", "jax")}
    assert names["port"] == names["jax"] == ["MANIFEST.json", "w.shard0-of-1.npz"]
    members = {}
    for pkg in ("port", "jax"):
        path = tmp_path / pkg / "step_000001" / "w.shard0-of-1.npz"
        with zipfile.ZipFile(path) as z:
            members[pkg] = [(i.filename, i.file_size) for i in z.infolist()]
        with np.load(path) as z:
            members[pkg + "_arrays"] = {k: (z[k].dtype.str, z[k].shape, z[k].tobytes())
                                        for k in z.files}
    assert members["port"] == members["jax"]
    assert members["port_arrays"] == members["jax_arrays"]
    assert dataclasses.asdict(checkpoint.read_info(str(tmp_path / "port"), 1)) == (
        dataclasses.asdict(jax_checkpoint.read_info(str(tmp_path / "jax"), 1)))


def test_eval_reconstructs_manifest_localizer(tmp_path):
    """The port's twin of ``tests/test_checkpoint.py::
    test_eval_reconstructs_manifest_localizer``: offline eval scores with the
    TRAINING hash width recorded in the manifest, not a default; a 32-bit
    hash table scored through the 64-bit default mis-assigns its rows.  The
    JAX evaluation reads the port's checkpoint to the same report."""
    from parameter_server_tpu import evaluation as jax_evaluation
    from parameter_server_tpu_torch import evaluation
    from parameter_server_tpu_torch.utils.keys import localizer_from_meta, localizer_meta

    rows = 512
    loc32 = HashLocalizer(rows, seed=7, hash_bits=32)
    # meta roundtrip preserves the full construction
    rebuilt = localizer_from_meta(localizer_meta(loc32))
    keys = np.arange(1, 400, dtype=np.uint64) * 2654435761
    np.testing.assert_array_equal(rebuilt.assign(keys), loc32.assign(keys))

    fleet = _Fleet("port", 2, rows=rows, dim=1, localizers={"w": loc32})
    try:
        # teach the table a planted signal: weight +3 on half the keys
        pos_keys, neg_keys = keys[: keys.size // 2], keys[keys.size // 2:]
        for _ in range(30):
            fleet.push(pos_keys, -np.ones((pos_keys.size, 1), np.float32))
            fleet.push(neg_keys, np.ones((neg_keys.size, 1), np.float32))
        fleet.worker.save_model(str(tmp_path), step=1)
    finally:
        fleet.close()

    def batches():
        lab = np.concatenate([np.ones(pos_keys.size), np.zeros(neg_keys.size)])
        return [(np.concatenate([pos_keys, neg_keys]).reshape(-1, 1), lab)]

    good = evaluation.evaluate_checkpoint(str(tmp_path), "w", batches())
    assert good["auc"] > 0.9  # manifest localizer -> rows line up
    # forcing the (wrong) 64-bit default must visibly degrade scoring
    bad = evaluation.evaluate_checkpoint(str(tmp_path), "w", batches(), hash_bits=64)
    assert bad["auc"] < good["auc"]
    assert jax_evaluation.evaluate_checkpoint(str(tmp_path), "w", batches()) == good
