"""The port's reliable and chaos vans (``core/resender.py``, ``core/chaos.py``)
against the JAX package's, on the CPU.

- **Twins of ``tests/test_chaos.py``** on the port's
  ``ReliableVan(ChaosVan(LoopbackVan()))``: RPCs under heavy loss,
  duplicates suppressed exactly, the retry budget and its give-up hook,
  asymmetric partitions, latency FIFO and reorders, gray failures
  (``slow_node``, ``slow_ms``) that draw nothing, seed determinism, counters
  merged through the stack, payload corruption caught by the CRC and
  repaired, the corruption and bandwidth streams isolated from the fault
  schedule; and the e2e runs (LR training under 5% drop, coalesced under
  drop and duplication, a server killed and its standby promoted, pulls
  retransmitted into a promotion, the deadline retry, seed determinism),
  each bitwise equal to the port's own clean run.  The JAX package's
  ``test_reliable_over_tcp_van_sockets`` waits for the TCP van (not
  ported yet).
- **Fault-schedule parity**: one seed and one 2,000-message sequence give
  the same drops, duplicates, reorders, latencies and flipped byte and bit
  in both packages (a recording timer wheel, so no wall clock decides the
  comparison); ``ReliableVan`` stamps the same ``__rseq__``, ``__rinc__``
  and ``__rcrc__`` on the same messages.

Tolerances: exact throughout.  The clean run is held to the JAX package's
within 1e-4 in ``tests/test_torch_frame.py`` (the same configuration).
"""

import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parameter_server_tpu.core import chaos as jax_chaos
from parameter_server_tpu.core import messages as jax_messages
from parameter_server_tpu.core import resender as jax_resender
from parameter_server_tpu_torch import config as port_config
from parameter_server_tpu_torch.core import chaos as port_chaos
from parameter_server_tpu_torch.core import messages as port_messages
from parameter_server_tpu_torch.core import resender as port_resender
from parameter_server_tpu_torch.core.chaos import ChaosConfig, ChaosVan
from parameter_server_tpu_torch.core.coalesce import CoalescingVan
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind
from parameter_server_tpu_torch.core.postoffice import Customer, Postoffice
from parameter_server_tpu_torch.core.resender import ReliableVan
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
from parameter_server_tpu_torch.kv import replica as replica_lib
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.models import linear
from parameter_server_tpu_torch.utils.metrics import transport_counters

pytestmark = pytest.mark.chaos

ROWS = 1 << 10
NUM_SERVERS = 2
STEPS = 12


class Echo(Customer):
    def handle_request(self, msg):
        return msg.reply(values=[v * 2 for v in msg.values])


def _reliable_stack(*, seed=0, timeout=0.05, backoff=1.0, max_retries=60, **chaos_kw):
    """ReliableVan(ChaosVan(LoopbackVan())) with a flat backoff."""
    chaos = ChaosVan(LoopbackVan(), seed=seed, **chaos_kw)
    van = ReliableVan(chaos, timeout=timeout, backoff=backoff, max_retries=max_retries,
                      seed=seed)
    return van, chaos


def _settle(predicate, deadline_s=5.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.005)
    return predicate()


def _ctl(i, sender="A", recver="B", **kw):
    return Message(task=Task(TaskKind.CONTROL, "x", time=i), sender=sender, recver=recver, **kw)


# --------------------------------------------------------------- unit level


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_rpc_survives_heavy_drop(seed):
    van, chaos = _reliable_stack(seed=seed, timeout=0.02, drop=0.5)
    try:
        Echo("echo", Postoffice("S0", van))
        client = Customer("echo", Postoffice("W0", van))
        for i in range(30):
            ts = client.submit([Message(task=Task(TaskKind.PUSH, "echo"), recver="S0",
                                        values=[np.array([float(i)])])], keep_responses=True)
            assert client.wait(ts, timeout=60), f"rpc {i} never completed"
            (resp,) = client.take_responses(ts)
            np.testing.assert_allclose(resp.values[0], [2.0 * i])
        assert chaos.injected_drops > 0
        assert van.retransmits > 0
        assert van.gave_up == 0
        assert van.flush(10)
    finally:
        van.close()


def test_duplicates_are_suppressed_exactly():
    van, chaos = _reliable_stack(seed=7, timeout=30.0, duplicate=0.4)
    try:
        seen = []

        class Recorder(Customer):
            def handle_request(self, msg):
                seen.append(float(msg.values[0][0]))
                return msg.reply()

        Recorder("rec", Postoffice("S0", van))
        client = Customer("rec", Postoffice("W0", van))
        for i in range(50):
            ts = client.submit([Message(task=Task(TaskKind.PUSH, "rec"), recver="S0",
                                        values=[np.array([float(i)])])])
            assert client.wait(ts, timeout=10)
        assert seen == [float(i) for i in range(50)]
        assert chaos.injected_dups > 0

        def balanced():
            return van.dup_suppressed + van.acks_received - van.acks_sent == chaos.injected_dups

        assert _settle(balanced)
        assert van.retransmits == 0
    finally:
        van.close()


def test_give_up_after_retry_budget():
    van, chaos = _reliable_stack(seed=0, timeout=0.005, max_retries=3)
    try:
        Echo("echo", Postoffice("S0", van))
        client = Customer("echo", Postoffice("W0", van))
        chaos.partition("W0", "S0")
        ts = client.submit([Message(task=Task(TaskKind.PUSH, "echo"), recver="S0")])
        assert _settle(lambda: van.gave_up == 1, 10)
        assert van.inflight() == 0
        assert not client.wait(ts, timeout=0.05)
        assert client.cancel(ts, "test deadline")
        assert client.wait(ts, timeout=1)
        assert client.pending_count() == 0
    finally:
        van.close()


def test_give_up_hook_fires_with_the_dead_message():
    gave = []
    van, chaos = _reliable_stack(seed=0, timeout=0.005, max_retries=2)
    van.on_give_up = gave.append
    try:
        chaos.partition("A", "B")
        van.bind("B", lambda m: None)
        assert van.send(_ctl(0))
        assert _settle(lambda: len(gave) == 1, 10)
        assert gave[0].recver == "B"
    finally:
        van.close()


def test_asymmetric_partition_drops_one_direction():
    chaos = ChaosVan(LoopbackVan(), seed=0)
    try:
        got = []
        chaos.bind("A", got.append)
        chaos.bind("B", got.append)
        chaos.partition("A", "B")
        msg_ab, msg_ba = _ctl(0), _ctl(0, sender="B", recver="A")
        assert chaos.send(msg_ab)
        assert chaos.send(msg_ba)
        assert _settle(lambda: len(got) == 1)
        time.sleep(0.05)  # the partitioned copy must not trickle in
        assert [m.sender for m in got] == ["B"]
        assert chaos.partition_drops == 1
        chaos.heal()
        assert chaos.send(msg_ab)
        assert _settle(lambda: len(got) == 2)
        assert [m.sender for m in got] == ["B", "A"]
    finally:
        chaos.close()


def test_latency_preserves_fifo_and_jitter_reorders():
    chaos = ChaosVan(LoopbackVan(), seed=3, delay=0.02)
    try:
        got = []
        chaos.bind("B", got.append)
        for i in range(20):
            chaos.send(_ctl(i))
        assert _settle(lambda: len(got) == 20)
        assert [m.task.time for m in got] == list(range(20))
    finally:
        chaos.close()
    chaos = ChaosVan(LoopbackVan(), seed=3,
                     default=ChaosConfig(delay=0.002, reorder=0.4, reorder_delay=0.1))
    try:
        got = []
        chaos.bind("B", got.append)
        for i in range(20):
            chaos.send(_ctl(i))
        assert _settle(lambda: len(got) == 20)
        order = [m.task.time for m in got]
        assert sorted(order) == list(range(20))
        assert order != list(range(20))
        assert chaos.injected_reorders > 0
    finally:
        chaos.close()


def test_slow_node_delays_inbound_only_and_heals():
    chaos = ChaosVan(LoopbackVan(), seed=0)
    try:
        got_b, got_c = [], []
        chaos.bind("B", lambda m: got_b.append(time.perf_counter()))
        chaos.bind("C", lambda m: got_c.append(time.perf_counter()))
        chaos.slow_node("B", 80.0)

        def send(recver):
            t0 = time.perf_counter()
            assert chaos.send(_ctl(0, recver=recver))
            return t0

        t0 = send("B")
        assert _settle(lambda: len(got_b) == 1)
        assert got_b[0] - t0 >= 0.08
        t0 = send("C")
        assert _settle(lambda: len(got_c) == 1)
        assert got_c[0] - t0 < 0.08
        assert chaos.counters()["chaos_slow"] == 1
        chaos.slow_node("B", 0)
        t0 = send("B")
        assert _settle(lambda: len(got_b) == 2)
        assert got_b[1] - t0 < 0.08
        assert chaos.counters()["chaos_slow"] == 1
    finally:
        chaos.close()


def test_slow_link_config_and_rng_isolation():
    def drops_on_ab(extra_slow_link):
        chaos = ChaosVan(LoopbackVan(), seed=5)
        try:
            chaos.set_link("A", "B", ChaosConfig(drop=0.3))
            if extra_slow_link:
                chaos.set_link("A", "C", ChaosConfig(slow_ms=5.0))
            chaos.bind("B", lambda m: None)
            chaos.bind("C", lambda m: None)
            for i in range(100):
                chaos.send(_ctl(i))
                if extra_slow_link:
                    chaos.send(_ctl(i, recver="C"))
            drops = chaos.injected_drops
            if extra_slow_link:
                assert _settle(lambda: chaos.injected_slow == 100)
            return drops
        finally:
            chaos.close()

    assert drops_on_ab(False) == drops_on_ab(True) > 0


def test_slow_node_composes_with_randomized_faults():
    chaos = ChaosVan(LoopbackVan(), seed=1, drop=0.2)
    try:
        got = []
        chaos.bind("B", got.append)
        chaos.slow_node("B", 30.0)
        t0 = time.perf_counter()
        for i in range(30):
            chaos.send(_ctl(i))
        expect = 30 - chaos.injected_drops
        assert chaos.injected_drops > 0
        assert _settle(lambda: len(got) == expect)
        assert time.perf_counter() - t0 >= 0.03
        assert chaos.injected_slow == expect
    finally:
        chaos.close()


def test_seed_determinism_across_runs():
    def run(seed):
        chaos = ChaosVan(LoopbackVan(), seed=seed, drop=0.3, duplicate=0.2)
        got = []
        try:
            chaos.bind("B", lambda m: got.append(m.task.time))
            for i in range(200):
                chaos.send(_ctl(i))
            expect = 200 - chaos.injected_drops + chaos.injected_dups
            assert _settle(lambda: len(got) == expect)
            return chaos.injected_drops, chaos.injected_dups, tuple(got)
        finally:
            chaos.close()

    a, b, c = run(11), run(11), run(12)
    assert a == b
    assert a != c
    assert a[0] > 0 and a[1] > 0


def test_chaos_counters_merge_through_the_stack():
    van, chaos = _reliable_stack(seed=1, drop=0.25, timeout=0.02)
    try:
        Echo("echo", Postoffice("S0", van))
        client = Customer("echo", Postoffice("W0", van))
        for _ in range(10):
            ts = client.submit([Message(task=Task(TaskKind.PUSH, "echo"), recver="S0")])
            assert client.wait(ts, timeout=30)
        merged = transport_counters(van)
        assert merged["retransmits"] == van.retransmits
        assert merged["chaos_drops"] == chaos.injected_drops
        assert merged["sent"] > 0
    finally:
        van.close()


# ----------------------------------------------- payload corruption (CRC)


def test_corrupt_frames_rejected_and_retransmit_recovers():
    van, chaos = _reliable_stack(seed=2, timeout=0.02, corrupt=0.3)
    try:
        Echo("echo", Postoffice("S0", van))
        client = Customer("echo", Postoffice("W0", van))
        for i in range(30):
            ts = client.submit([Message(task=Task(TaskKind.PUSH, "echo"), recver="S0",
                                        values=[np.arange(8, dtype=np.float64) + i])],
                               keep_responses=True)
            assert client.wait(ts, timeout=60), f"rpc {i} never completed"
            (resp,) = client.take_responses(ts)
            np.testing.assert_array_equal(resp.values[0], 2.0 * (np.arange(8, dtype=np.float64) + i))
        assert chaos.injected_corrupt > 0
        assert van.rejected_corrupt > 0
        assert van.retransmits > 0
        assert van.gave_up == 0
        assert van.flush(10)
    finally:
        van.close()


def test_corruption_never_mutates_sender_buffer():
    chaos = ChaosVan(LoopbackVan(), seed=0)
    try:
        chaos.set_link("A", "B", ChaosConfig(corrupt=1.0))
        got = []
        chaos.bind("B", got.append)
        original = np.arange(64, dtype=np.float32)
        pristine = original.copy()
        chaos.send(_ctl(0, values=[original]))
        assert _settle(lambda: len(got) == 1)
        assert chaos.injected_corrupt == 1
        np.testing.assert_array_equal(original, pristine)
        delivered = got[0].values[0]
        assert np.unpackbits(delivered.view(np.uint8) ^ pristine.view(np.uint8)).sum() == 1
    finally:
        chaos.close()


def test_torch_planes_are_never_corrupted():
    """A tensor plane is never flipped (the JAX van treats its device arrays
    so): a message with only tensor planes passes intact, one with numpy keys
    has a key bit flipped instead."""
    chaos = ChaosVan(LoopbackVan(), seed=0)
    try:
        chaos.set_link("A", "B", ChaosConfig(corrupt=1.0))
        got = []
        chaos.bind("B", got.append)
        plane = torch.arange(8, dtype=torch.float32)
        chaos.send(_ctl(0, values=[plane]))
        keys = np.arange(8, dtype=np.int64)
        chaos.send(_ctl(1, keys=keys, values=[plane]))
        assert _settle(lambda: len(got) == 2)
        assert got[0].values[0] is plane and chaos.injected_corrupt == 1
        assert got[1].values[0] is plane
        assert np.unpackbits(got[1].keys.view(np.uint8) ^ keys.view(np.uint8)).sum() == 1
    finally:
        chaos.close()


def test_corruption_rng_isolated_from_fault_schedule():
    def drops_on_ab(corrupt):
        chaos = ChaosVan(LoopbackVan(), seed=5)
        try:
            chaos.set_link("A", "B", ChaosConfig(drop=0.3, corrupt=0.9 if corrupt else 0.0))
            chaos.bind("B", lambda m: None)
            for i in range(100):
                chaos.send(_ctl(i, values=[np.arange(4, dtype=np.float32)]))
            if corrupt:
                assert _settle(lambda: chaos.injected_corrupt > 0)
            return chaos.injected_drops
        finally:
            chaos.close()

    assert drops_on_ab(False) == drops_on_ab(True) > 0


def test_bandwidth_cap_delays_and_preserves_fifo():
    chaos = ChaosVan(LoopbackVan(), seed=0)
    try:
        chaos.set_link("A", "B", ChaosConfig(bandwidth_bps=10_000.0))
        got = []
        chaos.bind("B", lambda m: got.append(m.task.time))
        t0 = time.perf_counter()
        for i in range(5):
            chaos.send(_ctl(i, values=[np.zeros(1000, dtype=np.uint8)]))
        assert _settle(lambda: len(got) == 5)
        assert time.perf_counter() - t0 >= 0.4
        assert got == [0, 1, 2, 3, 4]
        assert chaos.bandwidth_delays == 5
    finally:
        chaos.close()


def test_bandwidth_cap_is_draw_free():
    def drops_on_ab(capped):
        chaos = ChaosVan(LoopbackVan(), seed=5)
        try:
            chaos.set_link("A", "B", ChaosConfig(drop=0.3, bandwidth_bps=1e9 if capped else 0.0))
            chaos.bind("B", lambda m: None)
            for i in range(100):
                chaos.send(_ctl(i, values=[np.zeros(100, dtype=np.uint8)]))
            if capped:
                assert chaos.bandwidth_delays > 0
            return chaos.injected_drops
        finally:
            chaos.close()

    assert drops_on_ab(False) == drops_on_ab(True) > 0


def test_payload_nbytes_reads_tensors():
    msg = _ctl(0, keys=np.arange(4, dtype=np.int64),
               values=[torch.zeros((3, 2)), torch.empty(5, dtype=torch.bfloat16, device="meta")])
    assert port_chaos.payload_nbytes(msg) == 32 + 24 + 10


# ------------------------------------------------- cross-package parity


class _Recorder:
    """Inner van for either package: records what reaches it."""

    def __init__(self):
        self.sent = []

    def bind(self, node_id, handler):
        pass

    def unbind(self, node_id):
        pass

    def send(self, msg):
        self.sent.append(msg)
        return True

    def flush(self, timeout=5.0):
        return True

    def close(self):
        pass

    def counters(self):
        return {}


class _Wheel:
    """A timer wheel that runs each delivery at once and records its delay:
    the schedule is compared, not the wall clock."""

    def __init__(self, log):
        self.log = log

    def schedule(self, delay, fn):
        self.log.append(round(delay, 12))
        fn()

    def stop(self):
        pass


def _plane_record(x):
    if isinstance(x, np.ndarray):
        return (str(x.dtype), x.shape, x.tobytes())
    return "device"


def _schedule_run(msgs, chaos_mod, device_plane, n=2000, seed=17):
    rng = np.random.default_rng(seed)
    rec, delays = _Recorder(), []
    van = chaos_mod.ChaosVan(rec, seed=seed, drop=0.1, duplicate=0.1, reorder=0.1,
                             delay=0.001, jitter=0.002, corrupt=0.15)
    van._ensure_wheel = lambda: _Wheel(delays)
    links = [("W0", "S0"), ("W0", "S1"), ("S0", "W0"), ("W1", "S0")]
    for i in range(n):
        sender, recver = links[i % len(links)]
        kind = i % 5
        keys = values = None
        if kind in (1, 2, 3):
            keys = rng.integers(0, 1 << 30, size=int(rng.integers(1, 40))).astype(np.int64)
        if kind in (2, 3, 4):
            values = [rng.standard_normal((int(rng.integers(0, 12)), 2)).astype(np.float32)]
            if kind == 3:
                values.append(device_plane(rng.standard_normal(3).astype(np.float32)))
        van.send(msgs.Message(task=msgs.Task(msgs.TaskKind.PUSH, "w", time=i), sender=sender,
                              recver=recver, keys=keys, values=values or []))
    out = [(m.sender, m.recver, m.task.time,
            None if m.keys is None else _plane_record(m.keys),
            tuple(_plane_record(v) for v in m.values)) for m in rec.sent]
    counts = (van.injected_drops, van.injected_dups, van.injected_reorders, van.injected_corrupt)
    return out, delays, counts


def test_fault_schedule_is_identical_across_packages():
    """2,000 messages over four links, one seed, drop / duplicate / reorder /
    jitter / corrupt on: the same deliveries in the same order with the same
    delays, and the same flipped byte and bit, in both packages.  Messages
    with a device plane (``jnp`` on the JAX side, a tensor on the port's)
    take the legacy flip over their numpy planes in both."""
    port = _schedule_run(port_messages, port_chaos, torch.from_numpy)
    ref = _schedule_run(jax_messages, jax_chaos, jnp.asarray)
    assert port[2] == ref[2]
    assert all(c > 0 for c in port[2])
    assert port[1] == ref[1]
    assert len(port[0]) == len(ref[0])
    for a, b in zip(port[0], ref[0]):
        assert a == b


def test_reliable_stamps_match_jax():
    """The same messages through both packages' ReliableVan: the same
    ``__rseq__`` per link, ``__rinc__`` after a restart, and ``__rcrc__``
    over numpy and CPU-tensor planes alike (bfloat16 as its bits)."""
    rng = np.random.default_rng(5)
    specs = []
    for i in range(60):
        keys = rng.integers(0, 1 << 40, size=int(rng.integers(0, 30))).astype(np.uint64)
        vals = rng.standard_normal((keys.size, 2)).astype(np.float32)
        specs.append((("W0", "S0"), ("W0", "S1"), ("S0", "W0"))[i % 3] + (keys, vals))

    def run(msgs, resender_mod, as_plane):
        rec = _Recorder()
        van = resender_mod.ReliableVan(rec, timeout=60.0, seed=3)
        try:
            for i, (s, r, keys, vals) in enumerate(specs):
                if i == 30:
                    assert van.restart_node("W0") == 1
                van.send(msgs.Message(task=msgs.Task(msgs.TaskKind.PUSH, "w", time=i,
                                                     payload={"table": "w"}),
                                      sender=s, recver=r, keys=keys, values=[as_plane(vals)]))
            return [{k: m.task.payload.get(k) for k in ("__rseq__", "__rinc__", "__rcrc__")}
                    for m in rec.sent]
        finally:
            van.close()

    ref = run(jax_messages, jax_resender, lambda v: v)
    assert run(port_messages, port_resender, lambda v: v) == ref
    assert run(port_messages, port_resender, torch.from_numpy) == ref
    assert {s["__rinc__"] for s in ref} == {None, 1}
    bits = rng.integers(0, 1 << 16, size=(8, 2)).astype(np.uint16)
    for s in (port_resender, jax_resender):
        assert s.ACK_KEY == "__rack__" and s.ACK_CUSTOMER == "__resender__"
    import ml_dtypes

    jm = jax_messages.Message(task=jax_messages.Task(jax_messages.TaskKind.PUSH, "w"),
                              values=[bits.view(ml_dtypes.bfloat16)])
    pm = Message(task=Task(TaskKind.PUSH, "w"),
                 values=[torch.from_numpy(bits.view(np.int16)).view(torch.bfloat16)])
    assert port_resender.payload_crc32(pm) == jax_resender.payload_crc32(jm)


# ------------------------------------------------------------ e2e training


def _table_cfgs(cfg=port_config):
    return {"w": cfg.TableConfig(
        name="w", rows=ROWS, dim=1,
        optimizer=cfg.OptimizerConfig(kind="adagrad", learning_rate=0.1))}


def _batches():
    data = SyntheticCTR(key_space=4 * ROWS, nnz=8, batch_size=128, seed=3)
    return [data.next_batch() for _ in range(STEPS)]


def _train(worker, batches, on_step=None):
    losses = []
    for i, (keys, labels) in enumerate(batches):
        w_pos = worker.pull_sync("w", keys, timeout=60)
        g, _gb, loss = linear.grad_rows(torch.from_numpy(np.asarray(w_pos)),
                                        torch.from_numpy(labels.astype(np.float32)))
        worker.push_sync("w", keys, g.numpy() / labels.shape[0], timeout=60)
        losses.append(float(loss))
        if on_step is not None:
            on_step(i)
    return losses


def _servers(van):
    return [KVServer(Postoffice(f"S{s}", van), _table_cfgs(), s, NUM_SERVERS, device="cpu")
            for s in range(NUM_SERVERS)]


def _worker(van):
    return KVWorker(Postoffice("W0", van), _table_cfgs(), NUM_SERVERS, device="cpu")


def _tables(servers):
    return [(e["value"], e["state"]["sum_sq"]) for e in (s.export_shard()["w"] for s in servers)]


def _close(van, servers):
    van.close()
    for s in servers:
        if s.ledger is not None:
            s.ledger.close()


_CLEAN = {}


def _clean_reference():
    """(losses, applied pushes, tables) of the port's clean run, once."""
    if not _CLEAN:
        van = LoopbackVan()
        servers = _servers(van)
        try:
            losses = _train(_worker(van), _batches())
            _CLEAN["ref"] = (losses, sum(s.pushes for s in servers), _tables(servers))
        finally:
            _close(van, servers)
    return _CLEAN["ref"]


def _assert_tables_equal(got, want):
    for (gv, gs), (wv, ws) in zip(got, want):
        np.testing.assert_array_equal(gv, wv)
        np.testing.assert_array_equal(gs, ws)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lr_training_under_5pct_drop_matches_clean_run(seed):
    ref_losses, ref_applied, ref_tables = _clean_reference()
    van, chaos = _reliable_stack(seed=seed, timeout=0.1, drop=0.05)
    servers = []
    try:
        servers = _servers(van)
        worker = _worker(van)
        losses = _train(worker, _batches())
        assert losses == ref_losses  # bitwise
        _assert_tables_equal(_tables(servers), ref_tables)
        assert sum(s.pushes for s in servers) == ref_applied
        assert van.flush(10)
        assert van.gave_up == 0
        assert chaos.injected_drops > 0
        assert worker.pull_retries == 0
    finally:
        _close(van, servers)


@pytest.mark.parametrize("seed", [0, 1])
def test_lr_training_coalesced_under_chaos_matches_clean_run(seed):
    ref_losses, ref_applied, ref_tables = _clean_reference()
    rel, chaos = _reliable_stack(seed=seed, timeout=0.1, drop=0.05, duplicate=0.05)
    van = CoalescingVan(rel)
    servers = []
    try:
        servers = _servers(van)
        losses = _train(_worker(van), _batches())
        assert losses == ref_losses
        _assert_tables_equal(_tables(servers), ref_tables)
        assert sum(s.pushes for s in servers) == ref_applied
        assert van.flush(10)
        assert rel.gave_up == 0
        assert chaos.injected_drops + chaos.injected_dups > 0
        c = van.counters()
        assert c["coalesce_frames"] > 0
        assert c["coalesce_msgs"] >= c["coalesce_frames"]
    finally:
        _close(van, servers)


def _replicated(van):
    primaries, standbys = replica_lib.make_replicated_servers(
        van, _table_cfgs(), NUM_SERVERS, sync=True, device="cpu")
    return primaries, standbys


def test_lr_training_survives_server_kill_and_promotion_under_drop():
    """S0 killed mid-run and its sync standby promoted under 1% drop: the
    clean trajectory exactly, no checkpoint rewind."""
    ref_losses, _, _ = _clean_reference()
    van, chaos = _reliable_stack(seed=5, timeout=0.1, drop=0.01)
    primaries = standbys = []
    try:
        primaries, standbys = _replicated(van)
        worker = _worker(van)

        def on_step(i):
            if i == STEPS // 2 - 1:
                van.unbind("S0")
                replica_lib.promote(van, standbys[0], "S0")

        assert _train(worker, _batches(), on_step=on_step) == ref_losses
    finally:
        _close(van, primaries + standbys)


def test_pull_retransmits_into_promotion_window():
    van, _chaos = _reliable_stack(seed=0, timeout=0.05)
    primaries = standbys = []
    try:
        primaries, standbys = _replicated(van)
        worker = _worker(van)
        keys, _labels = _batches()[0]
        worker.pull_sync("w", keys, timeout=60)
        van.unbind("S0")
        ts = worker.pull("w", keys)
        t = threading.Timer(0.3, lambda: replica_lib.promote(van, standbys[0], "S0"))
        t.start()
        try:
            out = worker.pull_result(ts, timeout=60)
        finally:
            t.join()
        assert out.shape == keys.shape
        assert worker.pull_retries == 0
    finally:
        _close(van, primaries + standbys)


def test_pull_deadline_retry_against_promoted_server():
    van, _chaos = _reliable_stack(seed=0, timeout=0.01, max_retries=1)
    primaries = standbys = []
    try:
        primaries, standbys = _replicated(van)
        worker = _worker(van)
        keys, _labels = _batches()[0]
        worker.pull_sync("w", keys, timeout=60)
        van.unbind("S0")
        ts = worker.pull("w", keys)
        assert not worker.wait(ts, timeout=0.3)
        replica_lib.promote(van, standbys[0], "S0")
        out = worker.pull_result(ts, timeout=2)
        assert out.shape == keys.shape
        assert worker.pull_retries == 1
        assert worker.pending_count() == 0
    finally:
        _close(van, primaries + standbys)


def test_chaos_e2e_seed_deterministic():
    def run():
        van, chaos = _reliable_stack(seed=9, timeout=0.25, drop=0.05)
        servers = []
        try:
            servers = _servers(van)
            losses = _train(_worker(van), _batches())
            assert van.flush(10)
            return losses, chaos.injected_drops
        finally:
            _close(van, servers)

    losses_a, drops_a = run()
    losses_b, drops_b = run()
    assert losses_a == losses_b
    assert drops_a == drops_b > 0


@pytest.mark.slow
@pytest.mark.parametrize("seed", [0, 1, 2, 3, 4])
def test_stress_sweep_heavy_chaos(seed):
    ref_losses, ref_applied, _ = _clean_reference()
    chaos = ChaosVan(LoopbackVan(), seed=seed, default=ChaosConfig(
        drop=0.15, duplicate=0.1, reorder=0.2, delay=0.001, jitter=0.004, reorder_delay=0.01))
    van = ReliableVan(chaos, timeout=0.05, backoff=1.0, max_retries=200, seed=seed)
    servers = []
    try:
        servers = _servers(van)
        assert _train(_worker(van), _batches()) == ref_losses
        assert sum(s.pushes for s in servers) == ref_applied
        assert van.gave_up == 0
    finally:
        _close(van, servers)


def test_incarnation_hooks_reach_the_reliable_van():
    """The port's planes that waited on the reliable van find it under a
    ``CoalescingVan(MeteredVan(ReliableVan(...)))`` stack and fire: the
    Manager's incarnation broadcast reaches ``set_incarnation``; the
    coalescer's codec reset and the gated server's clock prune ride
    ``on_incarnation_advance``; ``restart_same_id``'s cold path calls
    ``drop_inbound_state``."""
    from parameter_server_tpu_torch.core.manager import Manager
    from parameter_server_tpu_torch.core.netmon import MeteredVan

    rel = ReliableVan(LoopbackVan(), timeout=30.0)
    resets = []

    class Codec:
        def reset_residuals(self, reason):
            resets.append(reason)

        def encode(self, msg):
            return msg

        def decode(self, msg):
            return msg

        def on_send_failed(self, *a):
            pass

    van = CoalescingVan(MeteredVan(rel), codec=Codec())
    servers = []
    try:
        cfgs = {"w": port_config.TableConfig(
            name="w", rows=64, dim=1,
            optimizer=port_config.OptimizerConfig(kind="sgd", learning_rate=0.1),
            consistency=port_config.ConsistencyConfig(
                mode=port_config.ConsistencyMode.SSP, max_delay=1))}
        servers.append(KVServer(Postoffice("S0", van), cfgs, 0, 1, device="cpu"))
        assert len(rel.on_incarnation_advance) == 2  # the codec's and the gate's
        fired = []
        rel.on_incarnation_advance[:] = [
            (lambda hook: lambda nid, inc: (fired.append((nid, inc)), hook(nid, inc)))(h)
            for h in rel.on_incarnation_advance]
        worker = KVWorker(Postoffice("W0", van), cfgs, 1, device="cpu")
        assert worker.wait(worker.push("w", np.arange(8, dtype=np.uint64),
                                       np.ones(8, np.float32)), timeout=30)
        assert van.flush(10)
        assert ("W0", "S0") in rel._windows

        mgr = Manager(Postoffice("H", van), num_workers=1, num_servers=1)
        mgr._learn_incarnation("W0", 1)
        assert rel.incarnations.get("W0") == 1
        assert fired == [("W0", 1), ("W0", 1)]
        assert resets == ["incarnation_advance:W0:1"]

        rel._windows[("W0", "S0")] = port_resender._SeenWindow(rel.window)
        srv, source = replica_lib.restart_same_id(van, cfgs, 0, 1, device="cpu")
        servers.append(srv)
        assert source == "cold" and ("W0", "S0") not in rel._windows
    finally:
        _close(van, servers)
