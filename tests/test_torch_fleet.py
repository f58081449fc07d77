"""The port's FleetMonitor against the JAX package's, on the CPU.

Ports of the ``tests/test_fleet.py`` cases that need no ``ChaosVan``: the
same ``observe()`` sequence with explicit ``now`` goes into both packages'
monitors and ``snapshot()``, ``stragglers()``, ``inbound_totals()`` and the
JSONL rows must be equal, bit for bit:

- a node with slow inbound links flagged within five beats, healthy nodes
  never; a healthy fleet; the absolute floor under microsecond jitter;
- heartbeat-gap stragglers; snapshot rates and inbound latency; cumulative
  link digests replaced, not double counted; clock offsets;
- ``RotatingJsonlWriter`` rotating between whole lines;
- the Manager's auto-stats heartbeat (``resource``, ``net``, ``links``)
  feeding the scheduler's monitor over the port's ``MeteredVan``, and
  ``sync_clock`` over a loopback.

- the two end-to-end slow-node cases over the port's ``ChaosVan``: a
  ``slow_node`` server under ``MeteredVan(ReliableVan(ChaosVan(...)))``
  flagged within five beats and no healthy node ever; ``slow_node(nid, 0)``
  heals the link.
"""

import io
import json
import time

import numpy as np
import pytest

from parameter_server_tpu.core.fleet import FleetMonitor as JaxFleetMonitor
from parameter_server_tpu.core.fleet import RotatingJsonlWriter as JaxRotatingJsonlWriter
from parameter_server_tpu.core.fleet import StragglerPolicy as JaxStragglerPolicy
from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
from parameter_server_tpu_torch.core.fleet import (
    FleetMonitor,
    RotatingJsonlWriter,
    StragglerPolicy,
)
from parameter_server_tpu_torch.core.manager import SCHEDULER, launch_local_cluster
from parameter_server_tpu_torch.core.messages import server_id, worker_id
from parameter_server_tpu_torch.core.netmon import MeteredVan
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.utils.trace import LatencyHistogram


class _Pair:
    """The port's and the JAX package's monitors fed the same calls."""

    def __init__(self, **policy):
        self.port = FleetMonitor(policy=StragglerPolicy(**policy))
        self.jax = JaxFleetMonitor(policy=JaxStragglerPolicy(**policy))

    def observe(self, node, stats, now):
        self.port.observe(node, json.loads(json.dumps(stats)), now=now)
        self.jax.observe(node, json.loads(json.dumps(stats)), now=now)

    def stragglers(self, now):
        got = self.port.stragglers(now=now)
        assert got == self.jax.stragglers(now=now)
        return got

    def snapshot(self, now):
        got = self.port.snapshot(now=now)
        assert got == self.jax.snapshot(now=now)
        assert self.port.inbound_totals() == self.jax.inbound_totals()
        return got


def _digest(latencies_s, nbytes=1000, msgs=10):
    h = LatencyHistogram()
    for s in latencies_s:
        h.record(s)
    return {"msgs": msgs, "bytes": nbytes, "send": LatencyHistogram().to_dict(),
            "deliver": h.to_dict(), "verbs": {"PUSH": {"msgs": msgs, "bytes": nbytes}}}


def _observe_round(pair, now, slow_node=None, slow_s=0.2):
    """One synthetic heartbeat round: 3 nodes, healthy links ~1 ms, links
    into ``slow_node`` at ``slow_s``."""
    nodes = ["A", "B", "C"]
    for n in nodes:
        links = {f"{n}->{peer}": _digest([slow_s if peer == slow_node else 0.001] * 4)
                 for peer in nodes if peer != n}
        pair.observe(n, {"links": links}, now)


def test_straggler_flagged_within_five_beats_healthy_never():
    pair = _Pair(k=4.0, p99_floor_ms=40.0)
    flagged_at = None
    for beat in range(1, 6):
        _observe_round(pair, float(beat), slow_node="C", slow_s=0.2)
        flags = pair.stragglers(float(beat))
        assert set(flags) <= {"C"}  # healthy nodes never flagged
        if "C" in flags and flagged_at is None:
            flagged_at = beat
        pair.snapshot(float(beat))
    assert flagged_at is not None and flagged_at <= 5
    assert any("p99" in r for r in pair.stragglers(5.0)["C"])


def test_healthy_fleet_has_no_stragglers():
    pair = _Pair()
    for beat in range(1, 6):
        _observe_round(pair, float(beat))
        assert pair.stragglers(float(beat)) == {}


def test_absolute_floor_suppresses_microsecond_jitter():
    pair = _Pair(k=4.0, p99_floor_ms=10.0)
    for beat in range(1, 6):
        _observe_round(pair, float(beat), slow_node="C", slow_s=50e-6)
        assert pair.stragglers(float(beat)) == {}


def test_heartbeat_gap_straggler():
    pair = _Pair(k=4.0, gap_floor_s=1.0)
    for beat in range(10):
        now = 0.5 * beat
        for n in ("A", "B"):
            pair.observe(n, {}, now)
        if beat < 3:  # C beats 3 times, then goes silent
            pair.observe("C", {}, now)
    flags = pair.stragglers(5.0)
    assert set(flags) == {"C"} and any("silent" in r for r in flags["C"])
    snap = pair.snapshot(5.0)
    assert snap["A"]["heartbeats"] == 10 and snap["C"]["heartbeats"] == 3


def test_snapshot_derives_rates_and_inbound_latency():
    pair = _Pair()
    for beat in range(1, 4):
        pair.observe("A", {
            "resource": {"time": 100.0 + beat, "rss_mb": 50.0,
                         "cpu_user_s": 0.5 * beat, "cpu_sys_s": 0.0},
            "net": {"wire_bytes": 1000 * beat},
            "links": {"A->B": _digest([0.002] * 5)},
        }, float(beat))
        pair.observe("B", {}, float(beat))
    snap = pair.snapshot(3.0)
    a = snap["A"]
    assert a["heartbeats"] == 3 and a["beat_interval_s"] == 1.0 and a["rss_mb"] == 50.0
    assert abs(a["cpu_pct"] - 50.0) < 1e-6  # 0.5 cpu-s per 1 s of wall time
    assert a["wire_bytes_per_s"] == 1000.0
    assert "push_p99_ms" not in a  # the A->B link is inbound to B, not A
    assert snap["B"]["inbound_count"] == 5
    assert snap["B"]["push_p99_ms"] >= snap["B"]["push_p50_ms"]


def test_write_jsonl_rows_match_jax():
    sinks = {"port": io.StringIO(), "jax": io.StringIO()}
    mons = {"port": FleetMonitor(jsonl=sinks["port"]), "jax": JaxFleetMonitor(jsonl=sinks["jax"])}
    for beat in range(1, 4):
        for n in ("A", "B", "C"):
            links = {f"{n}->{p}": _digest([0.2 if p == "C" else 0.001] * 4)
                     for p in ("A", "B", "C") if p != n}
            for mon in mons.values():
                mon.observe(n, json.loads(json.dumps({"links": links})), now=float(beat))
        for mon in mons.values():
            mon.write_jsonl(now=float(beat), wall=1000.0 + beat)
    rows = [json.loads(line) for line in sinks["port"].getvalue().splitlines()]
    assert rows == [json.loads(line) for line in sinks["jax"].getvalue().splitlines()]
    assert len(rows) == 3 and all(set(r) == {"t", "nodes", "stragglers"} for r in rows)
    assert "C" in rows[-1]["stragglers"]


def test_rotating_writer_rotates_between_whole_lines(tmp_path):
    out = {}
    for name, cls in (("port", RotatingJsonlWriter), ("jax", JaxRotatingJsonlWriter)):
        path = tmp_path / f"{name}.jsonl"
        w = cls(str(path), rotate_bytes=64)
        for i in range(12):
            w.write_line(json.dumps({"i": i, "pad": "x" * (i % 5)}))
        w.sync()
        rotations = w.rotations
        w.close()
        files = [path] + [tmp_path / f"{name}.jsonl.{k}" for k in range(1, rotations + 1)]
        texts = [f.read_text() for f in files]
        assert all(t.endswith("\n") for t in texts if t)
        out[name] = (rotations, texts)
    assert out["port"] == out["jax"] and out["port"][0] > 1


def test_cumulative_digests_replace_not_double_count():
    pair = _Pair()
    h = LatencyHistogram()
    for i in range(1, 6):
        h.record(0.001)
        d = {"msgs": i, "bytes": 100 * i, "send": LatencyHistogram().to_dict(),
             "deliver": h.to_dict()}
        pair.observe("A", {"links": {"A->B": d}}, float(i))
        pair.observe("B", {}, float(i))
    assert pair.snapshot(5.0)["B"]["inbound_count"] == 5  # not 1+2+..+5


def test_clock_stats_ingest_and_relative_offset():
    pair = _Pair()
    pair.observe("W0", {"clock": {"offset_s": 0.5, "rtt_s": 0.01}}, 1.0)
    for mon in (pair.port, pair.jax):
        assert mon.clock_offset("W0") == 0.5 and mon.clock_offset("W1") is None
        assert mon.relative_offset("W0", SCHEDULER) == 0.5
        assert mon.relative_offset(SCHEDULER, "W0") == -0.5
        assert mon.relative_offset("W0", "W1") is None  # W1 never synced
    pair.observe("W1", {"clock": {"offset_s": -0.25, "rtt_s": 0.02}}, 1.0)
    assert pair.port.relative_offset("W0", "W1") == 0.75
    snap = pair.snapshot(2.0)
    assert snap["W0"]["clock_offset_ms"] == 500.0 and snap["W1"]["clock_rtt_ms"] == 20.0


# ----------------------------------------------------------- manager wiring


def _tables():
    return {"w": TableConfig(name="w", rows=256, dim=1,
                             optimizer=OptimizerConfig(kind="sgd", learning_rate=0.1))}


def test_manager_heartbeat_autostats_feed_fleet():
    """``send_heartbeat(auto=True)`` over a metered van attaches resource,
    net and links; the scheduler's ``_on_heartbeat`` feeds them to the
    attached monitor."""
    van = MeteredVan(LoopbackVan())
    server = None
    try:
        sched, managers, posts = launch_local_cluster(van, num_workers=1, num_servers=1)
        fleet = FleetMonitor()
        sched.fleet = fleet
        server = KVServer(posts[server_id(0)], _tables(), 0, 1, device="cpu")
        worker = KVWorker(posts[worker_id(0)], _tables(), 1, min_bucket=16, device="cpu")
        keys = np.arange(30, dtype=np.uint64)
        assert worker.wait(worker.push("w", keys, np.ones(30, np.float32)), timeout=30)
        stats = {}
        orig = fleet.observe
        fleet.observe = lambda nid, s, now=None: (stats.setdefault(nid, s), orig(nid, s, now))
        for nid, mgr in managers.items():
            if nid != SCHEDULER:
                assert mgr.wait(mgr.send_heartbeat(), timeout=30)
        assert set(fleet.nodes()) == {server_id(0), worker_id(0)}
        w = stats[worker_id(0)]
        assert {"resource", "net", "links"} <= set(w)
        assert w["net"]["wire_msgs"] > 0 and w["resource"]["rss_mb"] > 0
        assert all(link.startswith("W0->") for link in w["links"])
        snap = fleet.snapshot()
        assert snap[worker_id(0)]["heartbeats"] == 1
        assert snap[worker_id(0)]["last_seen_s"] is not None
        # the push traffic W0->S0 lands as S0 inbound latency
        assert snap[server_id(0)].get("inbound_count", 0) > 0
        assert fleet.inbound_totals()[server_id(0)]["verbs"]["PUSH"]["msgs"] == 1
    finally:
        van.close()
        if server is not None:
            server.ledger.close()


def test_sync_clock_over_loopback_and_heartbeat_ingest():
    """In one process both ends share one monotonic clock, so the min-RTT
    offset estimate is about 0; it rides the next heartbeat into the
    scheduler's monitor."""
    van = MeteredVan(LoopbackVan())
    try:
        sched, managers, _ = launch_local_cluster(van, num_workers=1, num_servers=1)
        fleet = FleetMonitor()
        sched.fleet = fleet
        mgr = managers[worker_id(0)]
        off = mgr.sync_clock()
        assert off is not None and abs(off) < 0.05
        assert 0.0 <= mgr.clock_rtt < 0.05
        assert mgr.wait(mgr.send_heartbeat(), timeout=30)
        assert fleet.clock_offset(worker_id(0)) == off
        assert fleet.relative_offset(worker_id(0), SCHEDULER) == off
    finally:
        van.close()


@pytest.mark.parametrize("bad", [{"resource": "not a dict"}, {"links": 3}])
def test_malformed_stats_never_cost_a_heartbeat(bad):
    """A stats payload the monitor cannot read is logged, and the beat still
    refreshes liveness (monitoring must never read as a death)."""
    van = LoopbackVan()
    try:
        sched, managers, _ = launch_local_cluster(van, num_workers=1, num_servers=1,
                                                  heartbeat_timeout=0.2)
        sched.fleet = FleetMonitor()
        time.sleep(0.3)
        for nid in ("S0", "W0"):
            assert managers[nid].wait(managers[nid].send_heartbeat(bad, auto=False), timeout=30)
        assert sched.check_heartbeats() == []
    finally:
        van.close()


# ---------------------------------------------- gray failures over ChaosVan


def test_e2e_slow_node_flagged_within_five_heartbeats():
    """Metered(Reliable(Chaos(Loopback))) with ``slow_node`` on one server:
    traffic and heartbeats flag the slowed server within 5 beats; healthy
    nodes never."""
    from parameter_server_tpu_torch.core.chaos import ChaosVan
    from parameter_server_tpu_torch.core.resender import ReliableVan

    chaos = ChaosVan(LoopbackVan(), seed=0)
    van = MeteredVan(ReliableVan(chaos, timeout=5.0, backoff=1.0, max_retries=3, seed=0))
    try:
        sched, managers, posts = launch_local_cluster(van, num_workers=2, num_servers=2)
        fleet = FleetMonitor(policy=StragglerPolicy(k=4.0, p99_floor_ms=40.0))
        sched.fleet = fleet
        cfgs = {"w": TableConfig(name="w", rows=1 << 10, dim=2,
                                 optimizer=OptimizerConfig(kind="sgd", learning_rate=0.1))}
        servers = [KVServer(posts[server_id(s)], cfgs, s, 2, device="cpu") for s in range(2)]
        workers = [KVWorker(posts[worker_id(w)], cfgs, 2, min_bucket=16, device="cpu")
                   for w in range(2)]
        chaos.slow_node(server_id(1), 120.0)
        rng = np.random.default_rng(1)
        flagged_at = None
        for beat in range(1, 6):
            for w in workers:
                keys = rng.integers(0, 1 << 10, size=48).astype(np.uint64)
                grads = rng.standard_normal((48, 2)).astype(np.float32)
                assert w.wait(w.push("w", keys, grads), timeout=60)
            for nid, mgr in managers.items():
                if nid != SCHEDULER:
                    assert mgr.wait(mgr.send_heartbeat(), timeout=60)
            flags = fleet.stragglers()
            assert set(flags) <= {server_id(1)}
            if server_id(1) in flags and flagged_at is None:
                flagged_at = beat
        assert flagged_at is not None and flagged_at <= 5, fleet.snapshot()
        assert chaos.injected_slow > 0
        del servers
    finally:
        van.close()


def test_slow_node_heals_and_flags_clear_on_fresh_monitor():
    """``slow_node(nid, 0)`` heals the link: the next delivery pays no delay."""
    from parameter_server_tpu_torch.core.chaos import ChaosVan
    from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind

    chaos = ChaosVan(LoopbackVan(), seed=0)
    van = MeteredVan(chaos)
    try:
        got = []
        van.bind("B", got.append)
        van.bind("A", got.append)
        chaos.slow_node("B", 50.0)
        t0 = time.perf_counter()
        van.send(Message(task=Task(TaskKind.CONTROL, "x"), sender="A", recver="B"))
        deadline = time.time() + 5
        while len(got) < 1 and time.time() < deadline:
            time.sleep(0.005)
        assert time.perf_counter() - t0 >= 0.05
        chaos.slow_node("B", 0)
        t1 = time.perf_counter()
        van.send(Message(task=Task(TaskKind.CONTROL, "x"), sender="A", recver="B"))
        deadline = time.time() + 5
        while len(got) < 2 and time.time() < deadline:
            time.sleep(0.005)
        assert len(got) == 2
        assert time.perf_counter() - t1 < 0.05
    finally:
        van.close()
