"""The port's flight recorder against the JAX package's, on the CPU.

``parameter_server_tpu_torch/core/flightrec.py`` is a copy of the JAX
module: the ring, ``configure``, the per-node bundle split, the
receive-thread exception trigger, and the bundle format that
``tools/postmortem.py`` merges.  These tests replay the JAX package's own
recorder cases on the port, run one seeded 2 x 2 LR loop through both
packages (with a routing fence, a cancellation drop and a failing handler
on a throwaway node) and compare the event kinds journaled, and merge a port
dump with a JAX dump through the tool.  Host code: compared exactly.
"""

import collections
import json
import pathlib
import sys
import time

import numpy as np
import pytest

from parameter_server_tpu.config import ConsistencyConfig as JaxConsistencyConfig
from parameter_server_tpu.config import OptimizerConfig as JaxOptimizerConfig
from parameter_server_tpu.config import TableConfig as JaxTableConfig
from parameter_server_tpu.core import flightrec as jax_flightrec
from parameter_server_tpu.core import messages as jax_messages
from parameter_server_tpu.core.postoffice import Postoffice as JaxPostoffice
from parameter_server_tpu.core.van import LoopbackVan as JaxLoopbackVan
from parameter_server_tpu.data.synthetic import SyntheticCTR as JaxSyntheticCTR
from parameter_server_tpu.kv.server import KVServer as JaxKVServer
from parameter_server_tpu.kv.worker import KVWorker as JaxKVWorker
from parameter_server_tpu.learner.sgd import AsyncLRLearner as JaxAsyncLRLearner
from parameter_server_tpu.utils.trace import LatencyHistogram as JaxLatencyHistogram
from parameter_server_tpu_torch.config import (
    ConsistencyConfig,
    OptimizerConfig,
    TableConfig,
)
from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core import messages as port_messages
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.learner.sgd import AsyncLRLearner
from parameter_server_tpu_torch.utils.trace import LatencyHistogram

sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))

import postmortem  # noqa: E402


def _settle(predicate, deadline_s=5.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.005)
    return predicate()


# ------------------------------------------------------------- ring basics


def test_event_registry_is_the_jax_registry():
    assert flightrec.EVENTS == jax_flightrec.EVENTS
    assert flightrec.anomaly_kinds() == jax_flightrec.anomaly_kinds()
    assert flightrec.anomaly_kinds() == postmortem.ANOMALY_KINDS
    assert flightrec.DUMP_DIR_ENV == jax_flightrec.DUMP_DIR_ENV


def test_ring_is_bounded_and_ordered():
    rec = flightrec.FlightRecorder(capacity=16)
    for i in range(40):
        rec.record("frame.send", node="A", i=i)
    assert len(rec) == 16
    evs = rec.events()
    assert [e["i"] for e in evs] == list(range(24, 40))  # oldest evicted
    assert [e["seq"] for e in evs] == sorted(e["seq"] for e in evs)
    t = [e["t_mono_s"] for e in evs]
    assert t == sorted(t)


def test_disabled_recorder_records_nothing():
    rec = flightrec.FlightRecorder(capacity=16, enabled=False)
    rec.record("frame.send", node="A")
    assert len(rec) == 0


def test_configure_resizes_preserving_tail():
    flightrec.configure(clear=True)
    try:
        for i in range(10):
            flightrec.record("frame.send", node="A", i=i)
        rec = flightrec.configure(capacity=4)
        assert [e["i"] for e in rec.events()] == [6, 7, 8, 9]
    finally:
        flightrec.configure(capacity=4096, clear=True)


def test_events_since_matches_jax():
    recs = [flightrec.FlightRecorder(capacity=8), jax_flightrec.FlightRecorder(capacity=8)]
    for rec in recs:
        for i in range(12):
            rec.record("frame.recv", node="B", i=i)
    got = [[(e["seq"], e["i"]) for e in r.events_since(6)] for r in recs]
    assert got[0] == got[1] == [(s, s) for s in range(7, 12)]


# ------------------------------------------------------------ bundle dumps


def test_dump_splits_events_per_node(tmp_path):
    rec = flightrec.FlightRecorder(capacity=64)
    rec.record("frame.send", node="S0", bytes=10)
    rec.record("frame.recv", node="W0", sender="S0")
    rec.record("slo.breach")  # no node field -> _process bundle
    paths = rec.dump(str(tmp_path), reason="unit")
    names = {pathlib.Path(p).name for p in paths}
    assert names == {
        "flightrec__process.json",
        "flightrec_S0.json",
        "flightrec_W0.json",
    }
    s0 = json.loads((tmp_path / "flightrec_S0.json").read_text())
    assert s0["node"] == "S0" and s0["reason"] == "unit"
    assert [e["kind"] for e in s0["events"]] == ["frame.send"]
    assert s0["wall_anchor_s"] > 0 and "mono_anchor_s" in s0
    proc = json.loads((tmp_path / "flightrec__process.json").read_text())
    # the dump marker itself is journaled into the node-less bundle
    assert [e["kind"] for e in proc["events"]] == ["slo.breach", "postmortem.dump"]


def test_dump_bundle_has_the_jax_layout(tmp_path):
    docs = []
    for name, mod in (("port", flightrec), ("jax", jax_flightrec)):
        rec = mod.FlightRecorder(capacity=8)
        rec.record("cancel.drop", node="S0", sender="W0", customer="kv", ts=3)
        (path,) = [p for p in rec.dump(str(tmp_path / name), reason="unit")
                   if p.endswith("flightrec_S0.json")]
        docs.append(json.loads(pathlib.Path(path).read_text()))
    port_doc, jax_doc = docs
    assert set(port_doc) == set(jax_doc)
    strip = ("seq", "t_mono_s")
    assert ([{k: v for k, v in e.items() if k not in strip} for e in port_doc["events"]]
            == [{k: v for k, v in e.items() if k not in strip} for e in jax_doc["events"]])


def test_dump_walks_van_counters(tmp_path):
    """The port has no MeteredVan: the walk reaches the LoopbackVan's
    counters and the per-link digests stay empty."""
    van = LoopbackVan()
    try:
        rec = flightrec.FlightRecorder()
        rec.record("frame.send", node="A")
        paths = rec.dump(str(tmp_path), van=van)
        doc = json.loads(pathlib.Path(paths[0]).read_text())
        assert doc["counters"] == {"sent": 0, "dropped": 0}
        assert doc["histograms"] is None
    finally:
        van.close()


def test_postoffice_counters_carry_cancelled_drops():
    van = LoopbackVan()
    try:
        post = Postoffice("A", van)
        assert post.counters() == {"cancelled_drops": 0}
    finally:
        van.close()


# ------------------------------------------------- LatencyHistogram copy


@pytest.mark.parametrize("seed", [0, 7])
def test_latency_histogram_matches_jax_exactly(seed):
    samples = np.abs(np.random.default_rng(seed).lognormal(-6.0, 1.5, size=3000))
    port, ref = LatencyHistogram(), JaxLatencyHistogram()
    for s in samples:
        port.record(float(s))
        ref.record(float(s))
    assert port.to_dict() == ref.to_dict()
    for p in (0.0, 0.5, 0.9, 0.99, 1.0):
        assert port.percentile(p) == ref.percentile(p)
    assert port.stats() == ref.stats()
    merged = LatencyHistogram.from_dict(ref.to_dict()).merge_dict(port.to_dict())
    assert merged.count == 2 * len(samples)
    assert LatencyHistogram().percentile(0.99) == 0.0


# ----------------------------------------------- recv-exception trigger


def test_recv_exception_journals_autodumps_and_keeps_serving(tmp_path, monkeypatch):
    monkeypatch.setenv(flightrec.DUMP_DIR_ENV, str(tmp_path / "auto"))
    flightrec.configure(clear=True)
    van = LoopbackVan()
    try:
        served = []

        def handler(msg):
            if msg.task.time == 0:
                raise RuntimeError("boom in handler")
            served.append(msg.task.time)

        van.bind("X", handler)
        for t in (0, 1):
            van.send(port_messages.Message(
                sender="Y", recver="X",
                task=port_messages.Task(kind=port_messages.TaskKind.CONTROL,
                                        customer="c", time=t),
            ))
        assert _settle(lambda: served == [1])  # the thread survived the raise
        evs = [e for e in flightrec.get().events() if e["kind"] == "recv.exception"]
        assert evs and evs[0]["node"] == "X"
        assert evs[0]["exc_type"] == "RuntimeError"
        assert "boom in handler" in evs[0]["exc"]
        assert list((tmp_path / "auto").glob("flightrec_*.json"))
    finally:
        van.close()
        flightrec.configure(clear=True)


def test_a_failing_recorder_never_kills_the_receive_thread(monkeypatch):
    van = LoopbackVan()
    try:
        served = []

        def handler(msg):
            if msg.task.time == 0:
                raise RuntimeError("handler")
            served.append(msg.task.time)

        def broken(node_id, exc):
            raise OSError("recorder down")

        monkeypatch.setattr(flightrec, "on_recv_exception", broken)
        van.bind("X", handler)
        for t in (0, 1):
            van.send(port_messages.Message(
                sender="Y", recver="X",
                task=port_messages.Task(kind=port_messages.TaskKind.CONTROL,
                                        customer="c", time=t),
            ))
        assert _settle(lambda: served == [1])
    finally:
        van.close()


# -------------------------------------- one seeded loop through both packages


ROWS = 1 << 12


def _run_loop(side, tag, steps=3):
    """A seeded 2 workers x 2 servers BSP LR loop, then a routing fence, a
    cancelled request and a failing handler on a throwaway node; returns the
    events of this run's nodes (servers are ``S0``/``S1`` by protocol; the
    workers and the throwaway node carry ``tag``)."""
    if side == "jax":
        rec_mod, msgs = jax_flightrec, jax_messages
        opt = JaxOptimizerConfig(kind="adagrad", learning_rate=0.05)
        cfgs = {"w": JaxTableConfig(name="w", rows=ROWS, dim=1, optimizer=opt)}
        van = JaxLoopbackVan()
        servers = [JaxKVServer(JaxPostoffice(f"S{i}", van), cfgs, i, 2)
                   for i in range(2)]
        workers = [JaxKVWorker(JaxPostoffice(f"{tag}W{i}", van), cfgs, 2) for i in range(2)]
        learner = JaxAsyncLRLearner(workers, JaxConsistencyConfig())
        data = [JaxSyntheticCTR(key_space=1 << 16, batch_size=128, seed=i, informative=0.1)
                for i in range(2)]
    else:
        rec_mod, msgs = flightrec, port_messages
        opt = OptimizerConfig(kind="adagrad", learning_rate=0.05)
        cfgs = {"w": TableConfig(name="w", rows=ROWS, dim=1, optimizer=opt)}
        van = LoopbackVan()
        servers = [KVServer(Postoffice(f"S{i}", van), cfgs, i, 2, device="cpu")
                   for i in range(2)]
        workers = [KVWorker(Postoffice(f"{tag}W{i}", van), cfgs, 2, device="cpu")
                   for i in range(2)]
        learner = AsyncLRLearner(workers, ConsistencyConfig(), device="cpu")
        data = [SyntheticCTR(key_space=1 << 16, batch_size=128, seed=i, informative=0.1)
                for i in range(2)]
    try:
        learner.run([d.next_batch for d in data], steps)
        srv = servers[0]
        # a push stamped with a stale routing epoch: fence.routing
        stale = msgs.Message(
            task=msgs.Task(msgs.TaskKind.PUSH, "kv",
                           payload={"table": "w", "__repoch__": 9}),
            sender=f"{tag}W0", recver="S0",
            keys=np.arange(4, dtype=np.int32), values=[np.ones((4, 1), np.float32)],
        )
        assert "__fenced__" in srv.handle_request(stale).task.payload
        # a request whose cancellation fence arrived first: cancel.drop
        post = srv.post
        post._on_cancel(msgs.Message(
            task=msgs.Task(msgs.TaskKind.CONTROL, "__cancel__",
                           payload={"customer": "kv", "time": 77}),
            sender=f"{tag}W1", recver=post.node_id,
        ))
        post._on_recv(msgs.Message(
            task=msgs.Task(msgs.TaskKind.PULL, "kv", time=77, payload={"table": "w"}),
            sender=f"{tag}W1", recver=post.node_id, keys=np.arange(2, dtype=np.int32),
        ))
        assert post.cancelled_drops == 1
        # a throwaway node whose handler raises: recv.exception
        van.bind(f"{tag}X", lambda m: (_ for _ in ()).throw(ValueError("bad")))
        van.send(msgs.Message(sender=f"{tag}W0", recver=f"{tag}X",
                              task=msgs.Task(msgs.TaskKind.CONTROL, "c", time=0)))
        assert _settle(lambda: any(e["kind"] == "recv.exception" and e.get("node") == f"{tag}X"
                                   for e in rec_mod.get().events()))
        for s in servers:
            assert s.ledger.drain(5.0)
        nodes = {"S0", "S1", f"{tag}W0", f"{tag}W1", f"{tag}X"}
        return [e for e in rec_mod.get().events() if e.get("node") in nodes]
    finally:
        van.close()
        if side == "port":
            for s in servers:
                s.ledger.close()


def test_seeded_loop_journals_the_same_kinds_as_jax():
    flightrec.configure(clear=True)
    jax_flightrec.configure(clear=True)
    try:
        port = _run_loop("port", "FRP")
        ref = _run_loop("jax", "FRJ")
    finally:
        flightrec.configure(clear=True)
        jax_flightrec.configure(clear=True)
    port_kinds = collections.Counter(e["kind"] for e in port)
    jax_kinds = collections.Counter(e["kind"] for e in ref)
    assert port_kinds == jax_kinds
    # 2 workers x 3 steps, each push split over both servers
    assert port_kinds["apply.submit"] == port_kinds["apply.done"] == 12
    assert {"fence.routing", "cancel.drop", "recv.exception"} <= set(port_kinds)
    assert set(port_kinds) <= flightrec.EVENTS
    fence = next(e for e in port if e["kind"] == "fence.routing")
    assert fence["node"] == "S0" and fence["sender"] == "FRPW0" and fence["epoch"] == 0


def test_port_dump_merges_with_a_jax_dump_through_postmortem(tmp_path):
    port_rec, jax_rec = flightrec.FlightRecorder(), jax_flightrec.FlightRecorder()
    port_rec.record("fence.routing", node="S0", sender="W0", epoch=0, why="x")
    jax_rec.record("apply.submit", node="S1", bundle=1, table="w", members=1, rows=4)
    port_rec.record("recv.exception", node="S0", exc_type="ValueError", exc="bad")
    paths = (port_rec.dump(str(tmp_path / "port"), reason="unit")
             + jax_rec.dump(str(tmp_path / "jax"), reason="unit"))
    merged = postmortem.merge_bundles(paths)
    # each dump marker lands in its recorder's node-less bundle
    assert merged["nodes"] == ["S0", "S1", "_process"]
    kinds = [e["kind"] for e in merged["events"]]
    assert sorted(kinds) == sorted(["fence.routing", "recv.exception", "postmortem.dump",
                                    "apply.submit", "postmortem.dump"])
    t = [e["t_s"] for e in merged["events"]]
    assert t == sorted(t)
    assert merged["events"][postmortem.first_anomaly(merged["events"])]["kind"] in (
        "fence.routing", "recv.exception")
    assert postmortem.report(merged)
