"""End-to-end sampled request tracing in the PyTorch port.

The twin of ``tests/test_traceplane.py`` on the port's worker, server and
socket van: zero trace bytes when unsampled; exactly one span tree per
request under chaos, an shm->TCP fallback and a live promotion, with the
tracing-off run's losses; ``CoalescingVan`` bundles carrying their members'
contexts; and the cross-node stitch on real sockets (shm and TCP arms):
per-node Chrome dumps merged by ``tools/merge_traces.py`` with cross-node
flow arrows, and ``tools/critpath.py`` plane segments summing to each
request's worker-measured end-to-end latency within 10%.

Then the cross-package checks: a JAX worker traced against a port server
over localhost sockets, and the reverse, stitches into one complete span
tree per request under ``tools/critpath.py`` (the two packages' flight
recorders dumped and merged); and the two packages' workers sample the
same request ids for the same seed, with no ``__trace__`` key on an
unsampled request.
"""

import importlib.util
import os
import sys
import time

import numpy as np
import pytest

import torch

from parameter_server_tpu_torch import native

if native.load("tcpvan") is None:  # pragma: no cover
    pytest.skip("no native toolchain for tcpvan", allow_module_level=True)

from parameter_server_tpu_torch.config import (
    OptimizerConfig,
    TableConfig,
    TraceConfig,
    TransportConfig,
)
from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.chaos import ChaosVan
from parameter_server_tpu_torch.core.coalesce import CoalescingVan
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.resender import ReliableVan
from parameter_server_tpu_torch.core.tcp_van import TcpVan
from parameter_server_tpu_torch.core.tracectx import TRACE_KEY, sampled
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
from parameter_server_tpu_torch.kv import replica as replica_lib
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.models import linear
from parameter_server_tpu_torch.utils.trace import Tracer

_TOOLS = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "tools"
)

ROWS = 1 << 10
STEPS = 10


def _tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(_TOOLS, f"{name}.py")
    )
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def cp():
    return _tool("critpath")


@pytest.fixture(scope="module")
def mt():
    return _tool("merge_traces")


def _table_cfgs():
    return {
        "w": TableConfig(
            name="w", rows=ROWS, dim=1,
            optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.1),
        )
    }


def _batches():
    data = SyntheticCTR(key_space=4 * ROWS, nnz=8, batch_size=128, seed=3)
    return [data.next_batch() for _ in range(STEPS)]


def _train(worker, batches, on_step=None):
    losses = []
    for i, (keys, labels) in enumerate(batches):
        w_pos = worker.pull_sync("w", keys, timeout=60)
        g, _gb, loss = linear.grad_rows(torch.from_numpy(np.asarray(w_pos)),
                                        torch.from_numpy(np.asarray(labels)))
        worker.push_sync("w", keys, g.numpy() / labels.shape[0], timeout=60)
        losses.append(float(loss))
        if on_step is not None:
            on_step(i)
    return losses


def _clean_reference():
    van = LoopbackVan()
    try:
        server = KVServer(Postoffice("S0", van), _table_cfgs(), 0, 1, device="cpu")
        worker = KVWorker(
            Postoffice("W0", van), _table_cfgs(), 1,
            trace=TraceConfig(enabled=False), device="cpu",
        )
        losses = _train(worker, _batches())
        return losses, server.pushes
    finally:
        van.close()


def _wait_for(predicate, deadline_s=10.0, tick=0.01):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(tick)
    return predicate()


# ------------------------------------------------- zero bytes when unsampled


def _tcp_run_bytes(trace_cfg):
    """Total wire bytes + trace event count for one fixed TCP workload."""
    flightrec.configure(enabled=True, clear=True)
    transport = TransportConfig(shm=False)  # all traffic on counted TCP
    van_s = TcpVan(transport=transport)
    van_w = TcpVan(transport=transport)
    try:
        cfgs = _table_cfgs()
        KVServer(Postoffice("S0", van_s), cfgs, 0, 1, device="cpu")
        van_w.add_route("S0", van_s.address)
        worker = KVWorker(
            Postoffice("W0", van_w), cfgs, 1, trace=trace_cfg, device="cpu"
        )
        _train(worker, _batches()[:4])
        # the server's send counters land on its event-loop thread, which
        # can trail the worker's last synchronous ack by a beat — settle
        # both vans (4 pulls + 4 pushes each way) before reading bytes
        assert _wait_for(
            lambda: van_w.counters()["sent"] >= 8
            and van_s.counters()["sent"] >= 8
        )
        n_trace = sum(
            1 for e in flightrec.get().events()
            if str(e.get("kind", "")).startswith("trace.")
        )
        total = (
            van_w.counters()["bytes_sent"] + van_s.counters()["bytes_sent"]
        )
        return total, n_trace, worker.trace_samples
    finally:
        van_w.close()
        van_s.close()


def test_unsampled_requests_carry_zero_trace_bytes():
    """Tracing enabled but sampling nothing is byte-identical to tracing
    disabled — the ``__trace__`` key is ABSENT, not empty — while full
    sampling demonstrably grows the same counters."""
    # sample_every chosen so no tid of this run hashes to the sample;
    # verified explicitly so the run can't pass vacuously
    unsampled = TraceConfig(sample_every=1 << 20, seed=5)
    for req in range(64):
        assert not sampled(f"W0/kv/{req}", unsampled.seed,
                           unsampled.sample_every)
    bytes_off, trace_off, _ = _tcp_run_bytes(TraceConfig(enabled=False))
    bytes_unsampled, trace_unsampled, samples = _tcp_run_bytes(unsampled)
    assert samples == 0
    assert trace_off == 0 and trace_unsampled == 0
    assert bytes_unsampled == bytes_off  # zero trace bytes on the wire

    bytes_all, trace_all, samples_all = _tcp_run_bytes(
        TraceConfig(sample_every=1)
    )
    assert samples_all > 0 and trace_all > 0
    assert bytes_all > bytes_off  # the context is real wire weight


# ------------------------------- exactly-once span trees under chaos + churn


@pytest.mark.chaos
def test_one_span_tree_per_request_under_chaos_fallback_migration():
    """Seeded drop+dup chaos, rings torn down a third of the way in
    (shm->TCP fallback), a live S0 migration two thirds in — and every
    sampled request still produces EXACTLY one complete span tree, with
    bitwise training parity against the tracing-off clean run."""
    ref_losses, _ = _clean_reference()

    flightrec.configure(enabled=True, clear=True)
    tcp_s = TcpVan()
    van_s = ReliableVan(tcp_s, timeout=0.1, backoff=1.0, max_retries=120)
    tcp_w = TcpVan()
    chaos_w = ChaosVan(tcp_w, seed=7, drop=0.15, duplicate=0.1, corrupt=0.0)
    van_w = ReliableVan(chaos_w, timeout=0.1, backoff=1.0, max_retries=120)
    try:
        cfgs = _table_cfgs()
        primaries, standbys = replica_lib.make_replicated_servers(
            van_s, cfgs, 1, sync=True, device="cpu"
        )
        assert primaries
        van_w.add_route("S0", van_s.address)
        worker = KVWorker(
            Postoffice("W0", van_w), cfgs, 1,
            trace=TraceConfig(sample_every=1), device="cpu",
        )

        fall_back_at = STEPS // 3
        migrate_at = (2 * STEPS) // 3

        def on_step(i):
            if i == fall_back_at:
                tcp_w.drop_shm_links(disable=True)
                tcp_s.drop_shm_links(disable=True)
            elif i == migrate_at:
                replica_lib.promote(van_s, standbys[0], "S0")

        losses = _train(worker, _batches(), on_step=on_step)
        np.testing.assert_allclose(losses, ref_losses, rtol=1e-7, atol=0)
        assert chaos_w.injected_drops > 0  # the run was actually lossy

        evs = flightrec.get().events()
        sub_tids = [e["tid"] for e in evs if e["kind"] == "trace.submit"]
        ack_tids = [e["tid"] for e in evs if e["kind"] == "trace.ack"]
        assert sub_tids  # every request sampled
        assert len(sub_tids) == len(set(sub_tids))
        # exactly ONE closure per sampled request: no tree left open by a
        # drop, none closed twice by a duplicate/retransmit
        assert len(ack_tids) == len(set(ack_tids))
        assert set(ack_tids) == set(sub_tids)
        assert worker.trace_closed == worker.trace_samples
        # dropped frames surfaced as traced retransmits, not lost spans
        retx = [e for e in evs if e["kind"] == "trace.retransmit"]
        assert retx, "chaos dropped frames but no trace.retransmit recorded"
    finally:
        van_w.close()
        van_s.close()


# --------------------------------------------------- coalesced bundle fan-out


def test_bundle_carries_member_contexts_and_fans_out():
    """Sub-messages bundled by CoalescingVan keep their sampled contexts:
    the bundle frame carries the members' tids, the decode side journals
    ``trace.bundle``, and every member's span tree still closes."""
    flightrec.configure(enabled=True, clear=True)
    van = CoalescingVan(LoopbackVan(), max_msgs=2, max_delay=0.2)
    try:
        cfgs = _table_cfgs()
        for s in range(2):
            KVServer(Postoffice(f"S{s}", van), cfgs, s, 2, device="cpu")
        worker = KVWorker(
            Postoffice("W0", van), cfgs, 2, min_bucket=16,
            trace=TraceConfig(sample_every=1), device="cpu",
        )
        keys = np.arange(40, dtype=np.uint64)
        vals = np.ones((40, 1), np.float32)
        stamps = [worker.push("w", keys, vals) for _ in range(4)]
        for ts in stamps:
            assert worker.wait(ts, timeout=30)
        van.flush()
        assert _wait_for(
            lambda: worker.trace_closed == worker.trace_samples, 10
        )
        evs = flightrec.get().events()
        bundles = [e for e in evs if e["kind"] == "trace.bundle"]
        assert any(e["subs"] > 1 for e in bundles)  # real aggregation
        bundled_tids = {t for e in bundles for t in e["tids"]}
        sub_tids = {e["tid"] for e in evs if e["kind"] == "trace.submit"}
        ack_tids = {e["tid"] for e in evs if e["kind"] == "trace.ack"}
        assert bundled_tids & sub_tids  # members rode a bundle
        assert ack_tids == sub_tids
    finally:
        van.close()


# ------------------------------------- cross-node stitching + plane critpath


@pytest.mark.parametrize("shm", [True, False], ids=["shm", "tcp"])
def test_cross_node_timeline_stitches_and_planes_sum_to_e2e(
    shm, cp, mt, tmp_path
):
    """Acceptance: a seeded 2-worker/2-server run over real sockets yields
    (a) one merged Perfetto timeline with cross-pid flow arrows for the
    sampled requests and (b) a critpath decomposition whose plane-segment
    sum is within 10% of the worker-measured end-to-end latency, with a
    real wire segment — on both the shm and pure-TCP arms."""
    flightrec.configure(enabled=True, clear=True)
    transport = TransportConfig(shm=shm)
    van_s = ReliableVan(TcpVan(transport=transport), timeout=1.0,
                        backoff=1.0, max_retries=30)
    van_w = ReliableVan(TcpVan(transport=transport), timeout=1.0,
                        backoff=1.0, max_retries=30)
    tracers = {n: Tracer() for n in ("W0", "W1", "S0", "S1")}
    try:
        cfgs = _table_cfgs()
        for s in range(2):
            KVServer(
                Postoffice(f"S{s}", van_s), cfgs, s, 2,
                tracer=tracers[f"S{s}"], device="cpu",
            )
        workers = []
        for w in range(2):
            van_w.add_route(f"S{w}", van_s.address)
            workers.append(
                KVWorker(
                    Postoffice(f"W{w}", van_w), cfgs, 2, min_bucket=16,
                    tracer=tracers[f"W{w}"],
                    trace=TraceConfig(sample_every=1), device="cpu",
                )
            )
        keys = np.arange(40, dtype=np.uint64)
        vals = np.ones((40, 1), np.float32)
        for _ in range(3):
            for worker in workers:
                assert worker.wait(
                    worker.push("w", keys, vals), timeout=30
                )
                worker.pull_sync("w", keys, timeout=30)
        for worker in workers:
            assert _wait_for(
                lambda w=worker: w.trace_closed == w.trace_samples, 10
            )
        if shm:
            inner = van_w.inner
            assert inner.counters()["shm_frames_sent"] > 0

        # (a) merged chrome timeline: flow arrows stitch worker spans to
        # server spans of other pids
        trace_paths = []
        for nid, tr in tracers.items():
            p = str(tmp_path / f"trace_{nid}.json")
            tr.dump_chrome_trace(p, process_name=nid)
            trace_paths.append(p)
        merged = mt.merge_traces(trace_paths)
        assert mt.validate_chrome_trace(merged) == []
        starts = [e for e in merged["traceEvents"] if e.get("ph") == "s"]
        ends = [e for e in merged["traceEvents"] if e.get("ph") == "f"]
        assert starts and ends
        assert all(e["cat"] == "traceflow" for e in starts + ends)
        by_id = {}
        for e in starts + ends:
            by_id.setdefault(e["id"], set()).add(e["pid"])
        assert any(len(pids) > 1 for pids in by_id.values())  # cross-node

        # (b) critpath: plane segments reconstruct the measured e2e
        bundle_dir = tmp_path / "bundles"
        paths = flightrec.dump(str(bundle_dir), reason="test")
        events = cp.merge_events([str(p) for p in paths])
        reqs = cp.requests(events)
        complete = {
            tid: q for tid, q in reqs.items()
            if cp.segments(q) is not None
        }
        assert complete
        # at least one request fully stitched across every plane
        full = [
            q for q in complete.values()
            if all(q[k] is not None
                   for k in ("t_tx", "t_rx", "t_disp", "t_reply"))
        ]
        assert full, "no fully-stitched cross-node request"
        for q in complete.values():
            segs = cp.segments(q)
            assert all(v >= 0 for v in segs.values())
            if q["e2e_ms"] is None:
                continue
            e2e = q["e2e_ms"] / 1e3
            assert abs(segs["e2e"] - e2e) <= 0.1 * e2e + 1e-4
        for q in full:
            segs = cp.segments(q)
            assert segs["wire"] > 0  # real wire transit attributed
        attr = cp.attribution(reqs)
        assert attr["complete"] == len(complete)
        assert attr["planes"]["e2e"]["p99_ms"] > 0
    finally:
        van_w.close()
        van_s.close()


# --------------------------------------------------- against the JAX package


def _pkgs(name):
    """``(config, flightrec, postoffice, tcp_van, server, worker, kw)`` of one
    package."""
    if name == "port":
        from parameter_server_tpu_torch import config as c
        from parameter_server_tpu_torch.core import flightrec as f, postoffice as p
        from parameter_server_tpu_torch.core import tcp_van as t
        from parameter_server_tpu_torch.kv import server as s, worker as w

        return c, f, p, t, s, w, {"device": "cpu"}
    from parameter_server_tpu import config as c
    from parameter_server_tpu.core import flightrec as f, postoffice as p
    from parameter_server_tpu.core import tcp_van as t
    from parameter_server_tpu.kv import server as s, worker as w

    return c, f, p, t, s, w, {}


def _tables(cfg):
    return {"w": cfg.TableConfig(
        name="w", rows=ROWS, dim=1,
        optimizer=cfg.OptimizerConfig(kind="adagrad", learning_rate=0.1))}


@pytest.mark.parametrize("worker_pkg,server_pkg", [("jax", "port"), ("port", "jax")])
def test_cross_package_requests_stitch_into_one_tree_each(worker_pkg, server_pkg, cp,
                                                          tmp_path):
    wc, wf, wp, wt, _ws, ww, wkw = _pkgs(worker_pkg)
    sc, sf, sp, st, ss, _sw, skw = _pkgs(server_pkg)
    for f in (wf, sf):
        f.configure(enabled=True, clear=True)
    van_s = st.TcpVan(transport=sc.TransportConfig(shm=False))
    van_w = wt.TcpVan(transport=wc.TransportConfig(shm=False))
    try:
        for s in range(2):
            ss.KVServer(sp.Postoffice(f"S{s}", van_s), _tables(sc), s, 2, **skw)
            van_w.add_route(f"S{s}", van_s.address)
        worker = ww.KVWorker(wp.Postoffice("W0", van_w), _tables(wc), 2, min_bucket=16,
                             trace=wc.TraceConfig(sample_every=1), **wkw)
        keys = np.arange(40, dtype=np.uint64)
        vals = np.full((40, 1), 0.5, np.float32)
        for _ in range(3):
            worker.push_sync("w", keys, vals, timeout=30)
            worker.pull_sync("w", keys, timeout=30)
        assert _wait_for(lambda: worker.trace_closed == worker.trace_samples, 10)
        assert worker.trace_samples == 6

        paths = [str(p) for p in wf.dump(str(tmp_path / "w"), reason="test")]
        paths += [str(p) for p in sf.dump(str(tmp_path / "s"), reason="test")]
        events = cp.merge_events(paths)
        subs = [e["tid"] for e in events if e.get("kind") == "trace.submit"]
        acks = [e["tid"] for e in events if e.get("kind") == "trace.ack"]
        # one span tree per request: one submit, one closing ack each
        assert len(subs) == len(set(subs)) == 6 and sorted(acks) == sorted(subs)
        reqs = cp.requests(events)
        assert set(subs) <= set(reqs)
        for tid in subs:
            q = reqs[tid]
            segs = cp.segments(q)
            assert segs is not None, (tid, q)
            assert all(q[k] is not None for k in ("t_tx", "t_rx", "t_disp", "t_reply"))
            assert all(v >= 0 for v in segs.values())
            assert segs["wire"] > 0
            e2e = q["e2e_ms"] / 1e3
            assert abs(segs["e2e"] - e2e) <= 0.1 * e2e + 1e-4
        disp = [e for e in events if e.get("kind") == "trace.dispatch"]
        assert {e["tid"] for e in disp} == set(subs) and len(disp) == 12  # 2 legs each
    finally:
        van_w.close()
        van_s.close()
        for f in (wf, sf):
            f.configure(clear=True)


class _Tap:
    """Records every request's payload keys at the server, by sender."""

    def __init__(self, server):
        self.keys = []
        inner = server.handle_request

        def handle(msg):
            self.keys.append(set(msg.task.payload))
            return inner(msg)

        server.handle_request = handle


@pytest.mark.parametrize("every", [1, 3, 1 << 20])
def test_both_packages_sample_the_same_requests(every):
    """The same request sequence (async and sync pushes, pulls, a serving
    pull) on each package over the loopback: the same sampled trace ids,
    and no ``__trace__`` key on any unsampled request's payload."""
    out = {}
    for name in ("port", "jax"):
        c, f, p, _t, s, w, kw = _pkgs(name)
        if name == "port":
            from parameter_server_tpu_torch.core.van import LoopbackVan as Van
        else:
            from parameter_server_tpu.core.van import LoopbackVan as Van
        f.configure(enabled=True, clear=True)
        van = Van()
        try:
            taps = [_Tap(s.KVServer(p.Postoffice(f"S{i}", van), _tables(c), i, 2, **kw))
                    for i in range(2)]
            worker = w.KVWorker(p.Postoffice("W0", van), _tables(c), 2, min_bucket=16,
                                trace=c.TraceConfig(sample_every=every, seed=11), **kw)
            keys = np.arange(40, dtype=np.uint64)
            vals = np.ones((40, 1), np.float32)
            for _ in range(4):
                assert worker.wait(worker.push("w", keys, vals), timeout=30)
                worker.push_sync("w", keys, vals, timeout=30)
                worker.pull_sync("w", keys, timeout=30)
                worker.pull_serve("w", keys[:8], timeout=30)
            assert _wait_for(lambda: worker.trace_closed == worker.trace_samples, 10)
            sampled_tids = sorted(e["tid"] for e in f.get().events()
                                  if e["kind"] == "trace.submit")
            carried = sum("__trace__" in k for t in taps for k in t.keys)
            out[name] = (sampled_tids, carried, sum(len(t.keys) for t in taps),
                         worker.trace_samples, worker.trace_closed)
        finally:
            van.close()
            f.configure(clear=True)
    assert out["port"] == out["jax"]
    tids, carried, total, samples, closed = out["port"]
    assert samples == closed == len(tids)
    if every == 1:
        assert carried == total
    elif every == 1 << 20:
        assert tids == [] and carried == 0
    else:
        assert 0 < carried < total
