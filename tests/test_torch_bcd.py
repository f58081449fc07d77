"""The port's DARLIN block coordinate descent against the JAX package's and a
numpy reference, on the CPU.

Twins of ``tests/test_bcd.py``: the numpy golden run (weights rtol 1e-4 /
atol 1e-5, margins atol 1e-4, as there), the objective and KKT filter, and
bounded delay at τ = 2 and 3.  Then 3 epochs at τ = 1 against the JAX
scheduler on the same shard and seed (weights within 1e-5, margins within
1e-4: the same update in float32, the sums associated differently), two
seeded runs bitwise equal, and a τ = 2 run whose every margin snapshot must
still hold what it held when its task took it.
"""

import numpy as np
import pytest
import torch

from parameter_server_tpu.core.postoffice import Postoffice as JaxPostoffice
from parameter_server_tpu.core.van import LoopbackVan as JaxLoopbackVan
from parameter_server_tpu.learner import bcd as jbcd
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.learner import bcd
from parameter_server_tpu_torch.learner.bcd import (
    BCDConfig,
    BlockPartition,
    DarlinScheduler,
    DarlinServer,
    DarlinWorker,
)

F, B, N, NNZ = 64, 4, 512, 8


def _make_data(seed: int, n: int = N):
    rng = np.random.default_rng(seed)
    indices = rng.integers(0, F, size=(n, NNZ)).astype(np.int64)
    w_true = np.zeros(F)
    w_true[: F // 8] = rng.normal(0, 1.5, F // 8)  # few informative features
    margin = w_true[indices].sum(axis=1) - w_true.sum() * NNZ / F
    labels = (rng.random(n) < 1 / (1 + np.exp(-margin))).astype(np.float32)
    indptr = np.arange(n + 1, dtype=np.int64) * NNZ
    return indptr, indices.ravel(), labels


def _numpy_darlin(shards, cfg: BCDConfig, block_orders):
    """Single-process reference: same update rule, sequential blocks."""
    blocks = BlockPartition(cfg.num_features, cfg.num_blocks)
    w = np.zeros(cfg.num_features)
    margins = [np.zeros(len(labels)) for _, _, labels in shards]
    rows_cols = []
    for indptr, indices, _ in shards:
        row_of = np.repeat(np.arange(len(indptr) - 1), np.diff(indptr))
        rows_cols.append((row_of, indices))
    for order in block_orders:
        for b in order:
            lo, hi = blocks.block_range(b)
            g = np.zeros(hi - lo)
            u = np.zeros(hi - lo)
            for (rows, cols), margin, (_, _, labels) in zip(rows_cols, margins, shards):
                sel = (cols >= lo) & (cols < hi)
                p = 1 / (1 + np.exp(-margin))
                resid = (p - labels)[rows[sel]]
                np.add.at(g, cols[sel] - lo, resid)
                rc = np.bincount(rows[sel], minlength=len(margin))
                maxrow = max(rc.max() if rc.size else 0, 1)
                np.add.at(u, cols[sel] - lo, 0.25 * maxrow)
            ueff = u + cfg.l2 + 1e-12
            z = w[lo:hi] - g / ueff
            z = np.sign(z) * np.maximum(np.abs(z) - cfg.l1 / ueff, 0.0)
            d = np.clip(z - w[lo:hi], -cfg.delta_max, cfg.delta_max)
            inactive = (w[lo:hi] == 0.0) & (np.abs(g) <= cfg.l1 - cfg.kkt_delta)
            d = np.where(~inactive, d, 0.0)
            w[lo:hi] += d
            for (rows, cols), i in zip(rows_cols, range(len(margins))):
                sel = (cols >= lo) & (cols < hi)
                np.add.at(margins[i], rows[sel], d[cols[sel] - lo])
    return w, margins


def _build_cluster(cfg, shards, num_servers=1, *, mod=bcd, van_cls=LoopbackVan,
                   post_cls=Postoffice):
    van = van_cls()
    kw = {"device": "cpu"} if mod is bcd else {}
    blocks = mod.BlockPartition(cfg.num_features, cfg.num_blocks)
    servers = [
        mod.DarlinServer(post_cls(f"S{s}", van), cfg, blocks, s, num_servers, len(shards),
                         **kw)
        for s in range(num_servers)
    ]
    workers = [
        mod.DarlinWorker(post_cls(f"W{i}", van), cfg, blocks, num_servers, indptr, indices,
                         labels, **kw)
        for i, (indptr, indices, labels) in enumerate(shards)
    ]
    return van, workers, servers


def test_darlin_matches_numpy_reference_exactly():
    cfg = BCDConfig(num_features=F, num_blocks=B, l1=0.5, tau=1)
    shards = [_make_data(0)]
    van, workers, servers = _build_cluster(cfg, shards)
    try:
        sched = DarlinScheduler(cfg, workers, servers, seed=7)
        sched.run(3)
        orders = np.random.default_rng(7)
        block_orders = [orders.permutation(B) for _ in range(3)]
        w_ref, margins_ref = _numpy_darlin(shards, cfg, block_orders)
        np.testing.assert_allclose(sched.dense_weights(), w_ref, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(workers[0].scores(), margins_ref[0], rtol=1e-4, atol=1e-4)
    finally:
        van.close()


def test_darlin_objective_decreases_and_kkt_filters():
    # l1 in sum-loss units: noise-feature |g| ~ sqrt(count)/2 ~ 4 here
    cfg = BCDConfig(num_features=F, num_blocks=B, l1=6.0, tau=1)
    shards = [_make_data(1)]
    van, workers, servers = _build_cluster(cfg, shards)
    try:
        sched = DarlinScheduler(cfg, workers, servers, seed=3)
        hist = sched.run(6)
        objs = [h["objective"] for h in hist]
        assert objs[-1] < objs[0]
        assert all(o2 <= o1 + 1e-6 for o1, o2 in zip(objs, objs[1:]))
        # strong L1: most noise features end inactive, few weights nonzero
        assert hist[-1]["active"] < F
        assert 0 < hist[-1]["nnz"] < F // 2
    finally:
        van.close()


@pytest.mark.parametrize("tau", [2, 3])
def test_darlin_bounded_delay_multiworker(tau):
    cfg = BCDConfig(num_features=F, num_blocks=B, l1=0.5, tau=tau)
    shards = [_make_data(10), _make_data(11), _make_data(12)]
    van, workers, servers = _build_cluster(cfg, shards, num_servers=2)
    try:
        sched = DarlinScheduler(cfg, workers, servers, seed=5)
        hist = sched.run(5)
        assert hist[-1]["objective"] < hist[0]["objective"]
        # bounded delay may lag the sequential run slightly but must land in
        # the same neighborhood
        cfg1 = BCDConfig(num_features=F, num_blocks=B, l1=0.5, tau=1)
        van2, workers2, servers2 = _build_cluster(cfg1, shards, num_servers=2)
        try:
            hist2 = DarlinScheduler(cfg1, workers2, servers2, seed=5).run(5)
            assert hist[-1]["objective"] <= hist2[-1]["objective"] * 1.2 + 0.05
        finally:
            van2.close()
    finally:
        van.close()


def _run(mod, cfg, shards, num_servers, epochs, seed, **kw):
    if mod is bcd:
        van, workers, servers = _build_cluster(cfg, shards, num_servers)
    else:
        van, workers, servers = _build_cluster(
            cfg, shards, num_servers, mod=jbcd, van_cls=JaxLoopbackVan,
            post_cls=JaxPostoffice)
    try:
        sched = mod.DarlinScheduler(cfg, workers, servers, seed=seed)
        hist = sched.run(epochs)
        return sched.dense_weights(), [w.scores() for w in workers], hist
    finally:
        van.close()


@pytest.mark.parametrize("num_servers,n_shards", [(1, 1), (2, 2)], ids=["1x1", "2x2"])
def test_darlin_matches_jax_scheduler_tau1(num_servers, n_shards):
    """3 epochs at τ = 1 from the same shards and seed: weights within 1e-5,
    margins within 1e-4, and the per-epoch nnz / active counts equal."""
    cfg = jbcd.BCDConfig(num_features=F, num_blocks=B, l1=0.5, tau=1)
    shards = [_make_data(20 + i) for i in range(n_shards)]
    jw, jm, jhist = _run(jbcd, cfg, shards, num_servers, 3, seed=11)
    tcfg = BCDConfig(num_features=F, num_blocks=B, l1=0.5, tau=1)
    tw, tm, thist = _run(bcd, tcfg, shards, num_servers, 3, seed=11)
    np.testing.assert_allclose(tw, jw, rtol=0, atol=1e-5)
    for a, b in zip(tm, jm):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)
    assert [(h["nnz"], h["active"], h["total"]) for h in thist] == \
        [(h["nnz"], h["active"], h["total"]) for h in jhist]
    np.testing.assert_allclose([h["objective"] for h in thist],
                               [h["objective"] for h in jhist], rtol=1e-5)


def test_darlin_seeded_runs_bitwise_equal():
    """Two workers, two servers, τ = 1: every sum has a fixed order, so two
    runs from one seed give the same bits."""
    cfg = BCDConfig(num_features=F, num_blocks=B, l1=0.5, tau=1)
    shards = [_make_data(30), _make_data(31)]
    a = _run(bcd, cfg, shards, 2, 3, seed=4)
    b = _run(bcd, cfg, shards, 2, 3, seed=4)
    np.testing.assert_array_equal(a[0], b[0])
    for x, y in zip(a[1], b[1]):
        np.testing.assert_array_equal(x, y)
    assert [h["objective"] for h in a[2]] == [h["objective"] for h in b[2]]


def test_block_structures_sum_like_the_coordinates():
    """The sorted block lists give exactly the JAX kernels' segment sums on a
    shard with empty rows, repeated features in a row and an empty block."""
    cfg = BCDConfig(num_features=16, num_blocks=4, tau=1)
    blocks = BlockPartition(16, 4)
    # features 8..11 (block 2) never occur; row 1 is empty
    indptr = np.array([0, 3, 3, 7, 9], dtype=np.int64)
    indices = np.array([0, 0, 13, 4, 5, 5, 15, 12, 1], dtype=np.int64)
    labels = np.array([1, 0, 1, 0], dtype=np.float32)
    van = LoopbackVan()
    try:
        w = DarlinWorker(Postoffice("W0", van), cfg, blocks, 1, indptr, indices, labels,
                         device="cpu")
        margin = torch.tensor([0.5, -1.0, 2.0, 0.25])
        row_of = np.repeat(np.arange(4), np.diff(indptr))
        for b in range(4):
            lo, hi = blocks.block_range(b)
            sel = (indices >= lo) & (indices < hi)
            resid = torch.sigmoid(margin).numpy() - labels
            g_ref = np.zeros(hi - lo, np.float32)
            np.add.at(g_ref, indices[sel] - lo, resid[row_of[sel]])
            g, u = bcd._block_grad(margin, w.labels, w._blocks[b], "logistic")
            np.testing.assert_allclose(g.numpy(), g_ref, rtol=1e-6)
            rc = np.bincount(row_of[sel], minlength=4)
            cnt = np.bincount(indices[sel] - lo, minlength=hi - lo)
            np.testing.assert_array_equal(u.numpy(), 0.25 * cnt * max(rc.max(), 1))
            delta = torch.arange(1, hi - lo + 1, dtype=torch.float32)
            m_ref = margin.numpy().copy()
            np.add.at(m_ref, row_of[sel], delta.numpy()[indices[sel] - lo])
            got = bcd._apply_margin_delta(margin, w._blocks[b], delta)
            np.testing.assert_allclose(got.numpy(), m_ref, rtol=1e-6)
    finally:
        van.close()


def test_tau2_margin_snapshots_are_never_written(monkeypatch):
    """τ = 2 with two workers: every snapshot a task takes of the margin
    still holds, after the run, what it held when the task took it.  An
    in-place margin update would change a snapshot under its reader."""
    taken = []
    real = bcd._block_grad

    def recording(margin, labels, blk, loss):
        taken.append((margin, margin.clone()))
        return real(margin, labels, blk, loss)

    monkeypatch.setattr(bcd, "_block_grad", recording)
    cfg = BCDConfig(num_features=F, num_blocks=8, l1=0.5, tau=2)
    _w, margins, _h = _run(bcd, cfg, [_make_data(40), _make_data(41)], 2, 2, seed=6)
    assert len(taken) == 2 * 2 * 8
    assert any(np.abs(m).sum() > 0 for m in margins)
    changed = [i for i, (m, copy) in enumerate(taken) if not torch.equal(m, copy)]
    assert changed == []


def test_entry_points_default_to_the_card():
    import inspect

    for cls in (DarlinServer, DarlinWorker):
        param = inspect.signature(cls.__init__).parameters["device"]
        assert param.default == "cuda" and param.kind is inspect.Parameter.KEYWORD_ONLY
