"""The port's membership manager and workload pool against the JAX package's.

Ports of ``tests/test_manager.py`` and the manager half of
``tests/test_restart.py``, on the CPU over each package's ``LoopbackVan``:

- the node table each package's scheduler broadcasts under the same
  registration order: every row (``dataclasses.asdict``, role by value, the
  wall-clock ``last_seen`` left out) equal, and ``NodeAssigner.ranges``
  equal over a grid of key spaces and server counts;
- heartbeat death and its callbacks, a death that unblocks the SSP clock,
  a heartbeat rejoin that rebroadcasts the row: the same dead sets in both;
- the barrier: completes and drains, times out without leaking, and a
  scheduler lost in flight cancels the stuck poll round;
- ``WorkloadPool`` assignment sequences under the same seeded calls, equal
  to the JAX pool's;
- ``CONTROL_VERBS`` equal to the JAX set, and every ``{"cmd": ...}``
  payload literal in the port names a registered verb;
- re-registration under a known id bumps the row's incarnation, keeps its
  range and rebroadcasts (a ``LoopbackVan`` has no transport fence).

Host state is compared bit for bit.  Not ported here:
``test_barrier_survives_chaos_message_loss`` and the transport fence of the
restart cases (they need the reliable and chaos vans).
"""

import ast
import dataclasses
import pathlib
import threading
import time

import numpy as np
import pytest

from parameter_server_tpu.config import ConsistencyConfig as JaxConsistencyConfig
from parameter_server_tpu.config import ConsistencyMode as JaxConsistencyMode
from parameter_server_tpu.core import manager as jax_manager
from parameter_server_tpu.core.clock import ConsistencyController as JaxController
from parameter_server_tpu.core.postoffice import Postoffice as JaxPostoffice
from parameter_server_tpu.core.van import LoopbackVan as JaxLoopbackVan
from parameter_server_tpu.learner.workload import WorkloadPool as JaxWorkloadPool
from parameter_server_tpu_torch.config import ConsistencyConfig, ConsistencyMode
from parameter_server_tpu_torch.core import manager as port_manager
from parameter_server_tpu_torch.core.clock import ConsistencyController
from parameter_server_tpu_torch.core.messages import NodeRole
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.learner.workload import WorkloadPool

ROOT = pathlib.Path(__file__).resolve().parent.parent
#: the heartbeat timeout of the death cases, and a silence past it: every
#: live node's beat is waited for before a sweep, so only the silent node
#: can be past the timeout
HB_TIMEOUT, HB_SILENCE = 0.5, 0.6
PKGS = {
    "jax": (jax_manager, JaxLoopbackVan, JaxPostoffice, JaxController,
            JaxConsistencyConfig, JaxConsistencyMode),
    "port": (port_manager, LoopbackVan, Postoffice, ConsistencyController,
             ConsistencyConfig, ConsistencyMode),
}


def _settle(predicate, deadline_s=5.0):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(0.01)
    return predicate()


def _rows(mgr):
    """The node table as plain dicts: role by value, ``last_seen`` (a clock
    reading) left out."""
    out = []
    for n in mgr.nodes():
        row = dataclasses.asdict(n)
        row["role"] = NodeRole(row["role"]).value
        del row["last_seen"]
        out.append(row)
    return out


def _cluster(pkg, **kw):
    mod, van_cls = PKGS[pkg][:2]
    van = van_cls()
    sched, managers, posts = mod.launch_local_cluster(van, **kw)
    return van, sched, managers, posts


def _beat(managers, skip=()):
    """One heartbeat from every node but the scheduler and ``skip``, each
    waited for: its reply means the scheduler has processed it."""
    for nid, mgr in managers.items():
        if nid != "H" and nid not in skip:
            assert mgr.wait(mgr.send_heartbeat(), timeout=30)


# ------------------------------------------------------------ node table


@pytest.mark.parametrize("key_space", [10, 1 << 20, (1 << 22) + 7])
@pytest.mark.parametrize("num_servers", [1, 2, 3, 7])
def test_node_assigner_ranges_match_jax(key_space, num_servers):
    got = port_manager.NodeAssigner(key_space).ranges(num_servers)
    assert got == jax_manager.NodeAssigner(key_space).ranges(num_servers)
    assert got[0][0] == 0 and got[-1][1] == key_space
    assert all(got[i][1] == got[i + 1][0] for i in range(num_servers - 1))


@pytest.mark.parametrize("workers,servers", [(3, 2), (1, 4)])
def test_cluster_table_rows_match_jax(workers, servers):
    """Every node sees the full table with assigned server ranges; the rows
    equal the JAX scheduler's under the same registration order."""
    tables = {}
    for pkg in PKGS:
        van, sched, managers, _ = _cluster(pkg, num_workers=workers, num_servers=servers,
                                           key_space=(1 << 22) + 3)
        try:
            for mgr in managers.values():
                assert mgr.wait_ready(5)
                assert _rows(mgr) == _rows(sched)
                assert len(mgr.nodes(NodeRole.WORKER)) == workers
            sids = [f"S{s}" for s in range(servers)]
            assert [n.node_id for n in sched.nodes(NodeRole.SERVER)] == sids
            assert sched.server_range(sids[0])[0] == 0
            assert sched.server_range(sids[-1])[1] == sched.assigner.key_space
            tables[pkg] = _rows(sched)
        finally:
            van.close()
    assert tables["port"] == tables["jax"]


# ------------------------------------------------------------- heartbeats


def _death_run(pkg):
    van, sched, managers, _ = _cluster(pkg, num_workers=2, num_servers=1,
                                       heartbeat_timeout=HB_TIMEOUT)
    try:
        dead_seen = []
        sched.on_node_dead.append(dead_seen.append)
        _beat(managers)  # everyone once, with stats
        time.sleep(HB_SILENCE)
        _beat(managers, skip=("W1",))  # then W1 goes silent
        newly_dead = sched.check_heartbeats()
        assert not sched.is_alive("W1") and sched.is_alive("W0")
        # surviving nodes learn the death by the REMOVE_NODE broadcast
        assert _settle(lambda: not managers["W0"].is_alive("W1"))
        # W1 recovers: its heartbeat marks it alive again on the scheduler
        managers["W1"].send_heartbeat()
        assert _settle(lambda: sched.is_alive("W1"))
        return newly_dead, dead_seen
    finally:
        van.close()


def test_heartbeat_death_detection_and_callbacks_match_jax():
    got = _death_run("port")
    assert got == (["W1"], ["W1"])
    assert got == _death_run("jax")


def _ssp_run(pkg):
    _, _, _, controller, ccfg, mode = PKGS[pkg]
    van, sched, managers, _ = _cluster(pkg, num_workers=2, num_servers=1,
                                       heartbeat_timeout=HB_TIMEOUT)
    try:
        ctrl = controller(ccfg(mode.SSP, max_delay=1), num_workers=2)
        index = {"W0": 0, "W1": 1}
        sched.on_node_dead.append(lambda nid: nid in index and ctrl.mark_dead(index[nid]))
        # W0 runs ahead; W1 never advances -> W0 blocked at t=3 under SSP(1)
        ctrl.finish_iteration(0)
        ctrl.finish_iteration(0)
        blocked = ctrl.wait_turn(0, 3, timeout=0.05)
        time.sleep(HB_SILENCE)
        _beat(managers, skip=("W1",))
        dead = sched.check_heartbeats()
        return blocked, dead, ctrl.wait_turn(0, 3, timeout=2.0)
    finally:
        van.close()


def test_death_unblocks_ssp_clock_matches_jax():
    """A dead worker must not stall the SSP bound (Executor::ReplaceNode)."""
    got = _ssp_run("port")
    assert got == (False, ["W1"], True)
    assert got == _ssp_run("jax")


def _rejoin_run(pkg):
    van, sched, managers, _ = _cluster(pkg, num_workers=2, num_servers=1,
                                       heartbeat_timeout=HB_TIMEOUT)
    try:
        readded = []
        sched.on_node_added.append(readded.append)
        time.sleep(HB_SILENCE)
        _beat(managers, skip=("W1",))
        dead = sched.check_heartbeats()
        assert _settle(lambda: not managers["W0"].is_alive("W1"))
        managers["W1"].send_heartbeat()  # the node was only slow, not dead
        assert _settle(lambda: sched.is_alive("W1") and managers["W0"].is_alive("W1"))
        return dead, readded, _rows(managers["W0"]) == _rows(sched)
    finally:
        van.close()


def test_heartbeat_rejoin_rebroadcasts_table_row_matches_jax():
    """A heartbeat from a dead-marked node rebroadcasts its row to the live
    peers and fires ``on_node_added``."""
    got = _rejoin_run("port")
    assert got == (["W1"], ["W1"], True)
    assert got == _rejoin_run("jax")


# ----------------------------------------------------------------- barrier


def test_barrier_completes_and_scheduler_drains():
    van, sched, managers, _ = _cluster("port", num_workers=2, num_servers=1)
    try:
        results = {}

        def enter(nid):
            results[nid] = managers[nid].barrier("step", 2, timeout=10)

        threads = [threading.Thread(target=enter, args=(w,)) for w in ("W0", "W1")]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=15)
        assert results == {"W0": True, "W1": True}
        assert sched.barrier_drain("step", 2, timeout=10)
        # the final ack is fire-and-forget: its reply may still be in flight
        assert _settle(lambda: not any(managers[w].pending_count() for w in ("W0", "W1")))
    finally:
        van.close()


def test_barrier_timeout_returns_false_without_leaking():
    van, sched, managers, _ = _cluster("port", num_workers=2, num_servers=1)
    try:
        t0 = time.time()
        assert not managers["W0"].barrier("lonely", 2, timeout=0.5, poll=0.02)
        assert time.time() - t0 < 5
        assert managers["W0"].pending_count() == 0
        assert not sched.barrier_drain("lonely", 2, timeout=0.2, poll=0.02)
    finally:
        van.close()


class _LossyLink:
    """A van decorator that loses ``sender -> recver`` messages in flight once
    ``cut`` is called (``send`` still reports success), as a partition the
    sender cannot see at send time."""

    def __init__(self, inner):
        self.inner, self.cut_links = inner, set()

    def cut(self, sender, recver):
        self.cut_links.add((sender, recver))

    def bind(self, node_id, handler):
        self.inner.bind(node_id, handler)

    def unbind(self, node_id):
        self.inner.unbind(node_id)

    def send(self, msg):
        if (msg.sender, msg.recver) in self.cut_links:
            return True
        return self.inner.send(msg)

    def close(self):
        self.inner.close()


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_barrier_unreachable_scheduler_cancels_stuck_round(pkg):
    """The scheduler silently unreachable: the poll round's wait times out
    and the task is cancelled, so nothing stays pending."""
    mod, van_cls = PKGS[pkg][:2]
    van = _LossyLink(van_cls())
    try:
        sched, managers, _ = mod.launch_local_cluster(van, num_workers=1, num_servers=1)
        assert sched.wait_ready(5)
        van.cut("W0", "H")
        assert not managers["W0"].barrier("b", 2, timeout=0.6, poll=0.02)
        assert managers["W0"].pending_count() == 0
    finally:
        van.close()


# ---------------------------------------------------------- workload pool


def _pool_trace(pool_cls, seed, n=24):
    """A seeded sequence of get / finish / mark_dead / mark_alive calls;
    returns every call's result."""
    rng = np.random.default_rng(seed)
    pool = pool_cls([f"f{i}" for i in range(n)], straggler_factor=1e9, min_history=3)
    held = {w: [] for w in ("W0", "W1", "W2")}
    trace = []
    for _ in range(200):
        w = f"W{int(rng.integers(0, 3))}"
        op = rng.random()
        if op < 0.5:
            wl = pool.get(w)
            trace.append(("get", w, None if wl is None else (wl.workload_id, wl.payload)))
            if wl is not None:
                held[w].append(wl.workload_id)
        elif op < 0.85 and held[w]:
            wid = held[w].pop(int(rng.integers(0, len(held[w]))))
            trace.append(("finish", w, wid, pool.finish(w, wid)))
        elif op < 0.93:
            trace.append(("dead", w, pool.mark_dead(w)))
            held[w] = []
        else:
            pool.mark_alive(w)
            trace.append(("alive", w))
        trace.append(("done", pool.num_done(), pool.all_done()))
    return trace


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_workload_pool_sequences_match_jax(seed):
    got = _pool_trace(WorkloadPool, seed)
    assert got == _pool_trace(JaxWorkloadPool, seed)
    assert any(t[0] == "dead" and t[2] for t in got)  # a requeue happened


def test_workload_pool_basic_and_reassignment():
    out = []
    for cls in (WorkloadPool, JaxWorkloadPool):
        pool = cls(["f0", "f1", "f2", "f3"])
        w0, w1 = pool.get("W0"), pool.get("W1")
        assert {w0.payload, w1.payload} == {"f0", "f1"}
        assert pool.finish("W0", w0.workload_id)
        requeued = pool.mark_dead("W1")  # the dead worker's shard returns
        assert requeued == [w1.workload_id]
        assert pool.get("W1") is None  # dead workers get nothing
        picked = [pool.get("W0") for _ in range(3)]
        assert [p.payload for p in picked if p] == ["f2", "f3", "f1"]
        for p in picked:
            pool.finish("W0", p.workload_id)
        assert pool.all_done()
        out.append([(w.workload_id, w.completed_by) for w in pool._workloads.values()])
    assert out[0] == out[1]


def test_workload_pool_straggler_duplication_matches_jax():
    out = []
    for cls in (WorkloadPool, JaxWorkloadPool):
        pool = cls(["a", "b", "c", "d"], straggler_factor=1.5, min_history=3)
        slow = pool.get("W0")
        for _ in range(3):
            w = pool.get("W1")
            pool.finish("W1", w.workload_id)
        slow.started_at["W0"] -= 10.0  # the outstanding workload looks old
        dup = pool.get("W1")
        assert dup is not None and dup.workload_id == slow.workload_id
        first, second = pool.finish("W1", dup.workload_id), pool.finish("W0", slow.workload_id)
        assert (first, second) == (True, False)  # the speculative copy wins
        assert pool.all_done()
        out.append((dup.workload_id, dup.assigned_to, dup.completed_by))
    assert out[0] == out[1]


# ------------------------------------------------------------ control verbs


def _cmd_literals(path):
    """Every string value of a ``"cmd"`` key in a dict literal of ``path``."""
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Dict):
            for k, v in zip(node.keys, node.values):
                if isinstance(k, ast.Constant) and k.value == "cmd":
                    yield v


def test_control_verbs_match_jax_and_cover_every_cmd_literal():
    assert port_manager.CONTROL_VERBS == jax_manager.CONTROL_VERBS
    tree = ast.parse((ROOT / "parameter_server_tpu_torch" / "core" / "manager.py").read_text())
    literal = next(n.value for n in tree.body if isinstance(n, ast.Assign)
                   and getattr(n.targets[0], "id", None) == "CONTROL_VERBS")
    parsed = {e.value for e in literal.args[0].elts}
    assert parsed == port_manager.CONTROL_VERBS
    seen = 0
    for path in sorted((ROOT / "parameter_server_tpu_torch").rglob("*.py")):
        for v in _cmd_literals(path):
            seen += 1
            name = v.value if isinstance(v, ast.Constant) else getattr(v, "id", None)
            verb = name if isinstance(v, ast.Constant) else getattr(port_manager, name, None)
            assert verb in port_manager.CONTROL_VERBS, f"{path.name}: cmd {ast.unparse(v)}"
    assert seen >= 8


# ---------------------------------------------------------- re-registration


def _reregister_run(pkg):
    mod, _, post_cls = PKGS[pkg][:3]
    van, sched, managers, _ = _cluster(pkg, num_workers=1, num_servers=1,
                                       heartbeat_timeout=30)
    try:
        added = []
        sched.on_node_added.append(added.append)
        before = next(n for n in sched.nodes() if n.node_id == "S0")
        assert before.incarnation == 0
        van.unbind("S0")  # the S0 process dies; a replacement registers
        new_mgr = mod.Manager(post_cls("S0", van), num_workers=1, num_servers=1)
        assert new_mgr.register_with_scheduler(timeout=10)
        row = next(n for n in sched.nodes() if n.node_id == "S0")
        assert row.alive and (row.range_begin, row.range_end) == (before.range_begin,
                                                                 before.range_end)
        # the restarted node learned the full table back; peers saw the row
        assert _settle(lambda: len(new_mgr.nodes()) == len(sched.nodes()))
        assert _settle(lambda: any(n.node_id == "S0" and n.incarnation == 1
                                   for n in managers["W0"].nodes()))
        return _rows(sched), _rows(new_mgr), added
    finally:
        van.close()


def test_reregistration_bumps_incarnation_and_broadcasts_matches_jax():
    got = _reregister_run("port")
    s0 = next(r for r in got[0] if r["node_id"] == "S0")
    assert s0["incarnation"] == 1 and got[2] == ["S0"]
    assert got == _reregister_run("jax")
