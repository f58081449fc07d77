"""The port's transport planes (``core/shm_ring.py``, the shm fast path and
both wire cores of ``core/tcp_van.py``) on the CPU over localhost.

- **Twins of ``tests/test_transport2.py``** (its 14 non-``slow`` cases):
  the ring's wraparound, full-ring refusal and recovery, out-of-order
  release holding the tail, torn writes staying invisible, oversized and
  closed rejection; shm negotiation with exact per-link FIFO across the
  cutover on the epoll and the threaded core, the reply path on a ring,
  the config and environment opt-outs, a declining peer, peer death and
  revival, a mid-run ``drop_shm_links``; and LR training under seeded drop,
  duplication and corruption over shm and over pure TCP, then with a
  mid-run shm fallback and a standby promotion, each bitwise equal to the
  port's clean ``LoopbackVan`` run with as many pushes applied.  The
  10k-connection soak stays ``slow`` in the reference and is not twinned.
- **Cross-package rings**: a JAX ring read by the port's reader and the
  other way round, record for record.
- **Ring slots and the card**: a slot stays held while a
  ``torch.from_numpy`` alias of a received plane lives and frees when it
  dies; a server that applied pushes off a ring holds no slot afterwards
  (its upload copies on the host first), nor does a worker's
  ``pull_result_device``.

Every wait is a bounded poll of a condition or an event; vans bind port 0
and ring files are per-process temporary files.  Tolerances: exact
throughout.
"""

import gc
import threading
import time

import numpy as np
import pytest
import torch

from parameter_server_tpu.core import shm_ring as jax_shm_ring
from parameter_server_tpu_torch import native
from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig, TransportConfig
from parameter_server_tpu_torch.core.chaos import ChaosVan
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.resender import ReliableVan
from parameter_server_tpu_torch.core.shm_ring import ShmRing
from parameter_server_tpu_torch.core.tcp_van import TcpVan
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
from parameter_server_tpu_torch.kv import replica as replica_lib
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.models import linear

if native.load("tcpvan") is None:  # pragma: no cover
    pytest.skip("no native toolchain for tcpvan", allow_module_level=True)

ROWS = 1 << 10
STEPS = 10


def _msg(recver="S0", sender="W0", time_=0, values=None):
    return Message(
        task=Task(TaskKind.PUSH, "w", time=time_, payload={"tag": "t"}),
        sender=sender, recver=recver,
        values=values if values is not None else [np.ones(4, np.float32)],
    )


def _wait_for(predicate, deadline_s=10.0, tick=0.01):
    deadline = time.time() + deadline_s
    while time.time() < deadline:
        if predicate():
            return True
        time.sleep(tick)
    return predicate()


# ----------------------------------------------------------- ring unit level


class TestShmRing:
    def test_roundtrip_and_wraparound(self):
        ring = ShmRing.create(capacity=1 << 14)
        rx = ShmRing.attach(ring.path)
        try:
            record = np.random.default_rng(0).integers(0, 256, size=1500, dtype=np.uint8)
            for i in range((3 * ring.capacity) // record.nbytes):
                payload = (record + i).astype(np.uint8)
                segs = [memoryview(payload[:100]), memoryview(payload[100:])]
                assert ring.write(segs, payload.nbytes, timeout=2.0)
                assert rx.poll(2.0)
                idx, view = rx.read()
                np.testing.assert_array_equal(np.frombuffer(view, np.uint8), payload)
                rx.release(idx)
            assert ring.counters()["shm_ring_full"] == 0
        finally:
            rx.close()
            ring.close()

    def test_full_refuses_then_release_recovers(self):
        ring = ShmRing.create(capacity=1 << 12)
        rx = ShmRing.attach(ring.path)
        try:
            payload = bytes(900)
            writes = 0
            while ring.write([payload], len(payload), timeout=0.0):
                writes += 1
                assert writes < 100  # must fill up
            assert ring.counters()["shm_ring_full"] == 1
            held = []
            while (rec := rx.read()) is not None:
                held.append(rec[0])
            for idx in held:
                rx.release(idx)
            assert ring.write([payload], len(payload), timeout=0.5)
        finally:
            rx.close()
            ring.close()

    def test_out_of_order_release_holds_tail(self):
        ring = ShmRing.create(capacity=1 << 12)
        rx = ShmRing.attach(ring.path)
        try:
            for _ in range(3):
                assert ring.write([bytes(64)], 64, timeout=1.0)
            recs = [rx.read() for _ in range(3)]
            assert all(r is not None for r in recs)
            tail0 = ring.tail
            rx.release(recs[2][0])
            assert ring.tail == tail0  # held by unreleased predecessors
            rx.release(recs[0][0])
            assert ring.tail != tail0
            mid = ring.tail
            rx.release(recs[1][0])
            assert ring.tail != mid
        finally:
            rx.close()
            ring.close()

    def test_torn_write_invisible_until_published(self):
        ring = ShmRing.create(capacity=1 << 12)
        rx = ShmRing.attach(ring.path)
        try:
            head = ring.head
            ring._data[head:head + 4] = (123).to_bytes(4, "little")
            ring._data[head + 4:head + 36] = b"\xde" * 32
            assert not rx.poll(0.05)
            assert rx.read() is None
            payload = bytes(range(200)) * 2
            assert ring.write([payload], len(payload), timeout=1.0)
            rec = rx.read()
            assert rec is not None and bytes(rec[1]) == payload
            rx.release(rec[0])
        finally:
            rx.close()
            ring.close()

    def test_oversized_and_closed_rejected(self):
        ring = ShmRing.create(capacity=1 << 12)
        try:
            assert not ring.write([bytes(1 << 12)], 1 << 12, timeout=0.0)
            ring.mark_closed()
            assert not ring.write([bytes(8)], 8, timeout=0.0)
        finally:
            ring.close()


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_rings_cross_packages(writer):
    """The ring layout is the JAX module's: either side reads the other's."""
    mods = {"jax": jax_shm_ring.ShmRing, "port": ShmRing}
    ring = mods[writer].create(capacity=1 << 13)
    rx = mods["port" if writer == "jax" else "jax"].attach(ring.path)
    try:
        rng = np.random.default_rng(3)
        for n in rng.integers(1, 3000, size=20):
            payload = rng.integers(0, 256, size=int(n), dtype=np.uint8)
            assert ring.write([memoryview(payload)], payload.nbytes, timeout=2.0)
            assert rx.poll(2.0)
            idx, view = rx.read()
            assert bytes(view) == payload.tobytes()
            rx.release(idx)
    finally:
        rx.close()
        ring.close()


# -------------------------------------------------------- link level over TCP


def _fifo_burst(a, b, n=200, *, expect_shm):
    """``n`` ordered messages a -> b across the shm negotiation window, in
    exact per-link FIFO (the cutover-marker contract)."""
    seen, done = [], threading.Event()

    def handler(msg):
        seen.append(msg.task.time)
        if len(seen) == n:
            done.set()

    b.bind("S0", handler)
    a.add_route("S0", b.address)
    for t in range(n):
        assert a.send(_msg(time_=t))
    assert done.wait(30)
    assert seen == list(range(n))
    if expect_shm:
        assert _wait_for(lambda: a.counters()["shm_links"] == 1)
        for t in range(n, n + 50):  # a tail burst after the cutover rides the ring
            assert a.send(_msg(time_=t))
        assert _wait_for(lambda: len(seen) == n + 50, 30)
        assert seen == list(range(n + 50))
        assert a.counters()["shm_frames_sent"] > 0
        assert b.counters()["shm_frames_recv"] > 0
    else:
        assert a.counters()["shm_links"] == 0
        assert a.counters()["shm_frames_sent"] == 0


@pytest.mark.parametrize("wire", ["epoll", "threaded"])
def test_shm_negotiates_and_preserves_fifo(wire):
    cfg = TransportConfig(wire=wire)
    a, b = TcpVan(transport=cfg), TcpVan(transport=cfg)
    try:
        _fifo_burst(a, b, expect_shm=True)
        assert a.wire_backend == b.wire_backend == wire
    finally:
        a.close()
        b.close()


def test_shm_reply_path_rides_ring_too():
    a, b = TcpVan(), TcpVan()
    try:
        ev, replies = threading.Event(), []
        a.bind("W0", lambda m: (replies.append(m), ev.set()))
        b.bind("S0", lambda m: b.send(m.reply([np.asarray(m.values[0]) * 2])))
        a.add_route("S0", b.address)
        for i in range(50):
            ev.clear()
            assert a.send(_msg(values=[np.full(8, i, np.float32)]))
            assert ev.wait(10)
        np.testing.assert_allclose(replies[-1].values[0], np.full(8, 98.0))
        assert _wait_for(lambda: b.counters()["shm_frames_sent"] > 0)
    finally:
        a.close()
        b.close()


def test_shm_disabled_by_config_and_env(monkeypatch):
    cfg = TransportConfig(shm=False)
    a, b = TcpVan(transport=cfg), TcpVan(transport=cfg)
    try:
        _fifo_burst(a, b, n=50, expect_shm=False)
    finally:
        a.close()
        b.close()
    monkeypatch.setenv("PS_NO_SHM", "1")
    a, b = TcpVan(), TcpVan()
    try:
        assert not a.shm_enabled and not b.shm_enabled
        _fifo_burst(a, b, n=50, expect_shm=False)
    finally:
        a.close()
        b.close()


def test_mixed_peer_degrades_to_tcp():
    a, b = TcpVan(), TcpVan(transport=TransportConfig(shm=False))
    try:
        _fifo_burst(a, b, n=50, expect_shm=False)
        assert _wait_for(lambda: not a._shm_links and not b._shm_links)
    finally:
        a.close()
        b.close()


def test_fallback_on_peer_death_then_revival():
    a, b = TcpVan(), TcpVan()
    got = threading.Event()
    b.bind("S0", lambda m: got.set())
    port = b.port
    a.add_route("S0", b.address)
    try:
        assert a.send(_msg())
        assert got.wait(10)
        assert _wait_for(lambda: a.counters()["shm_links"] == 1)
        b.close()  # peer death
        assert _wait_for(lambda: not a._shm_links, 15)
        # conn death may take a send to surface: poll until sends fail
        assert _wait_for(lambda: not a.send(_msg()), 10, tick=0.05)
        assert not a.send(_msg())
        b = TcpVan(port=port)  # revival on the same address
        got2 = threading.Event()
        b.bind("S0", lambda m: got2.set())
        assert _wait_for(lambda: a.send(_msg()), 15)
        assert got2.wait(10)
        assert _wait_for(lambda: a.counters()["shm_links"] == 1)  # renegotiated
    finally:
        a.close()
        b.close()


def test_midrun_drop_shm_links_keeps_fifo():
    a, b = TcpVan(), TcpVan()
    try:
        seen, done, n = [], threading.Event(), 300

        def handler(msg):
            seen.append(msg.task.time)
            if len(seen) == n:
                done.set()

        b.bind("S0", handler)
        a.add_route("S0", b.address)
        for t in range(n):
            assert a.send(_msg(time_=t))
            if t == n // 2:
                assert _wait_for(lambda: len(seen) >= n // 2, 20)
                a.drop_shm_links(disable=True)
                b.drop_shm_links(disable=True)
        assert done.wait(30)
        assert seen == list(range(n))
        assert a.counters()["shm_links"] == 0
    finally:
        a.close()
        b.close()


# ------------------------------------------------------- e2e training parity


def _table_cfgs():
    return {"w": TableConfig(name="w", rows=ROWS, dim=1,
                             optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.1))}


def _batches():
    data = SyntheticCTR(key_space=4 * ROWS, nnz=8, batch_size=128, seed=3)
    return [data.next_batch() for _ in range(STEPS)]


def _train(worker, batches, on_step=None):
    losses = []
    for i, (keys, labels) in enumerate(batches):
        w_pos = worker.pull_sync("w", keys, timeout=60)
        g, _gb, loss = linear.grad_rows(torch.tensor(w_pos), torch.tensor(labels))
        worker.push_sync("w", keys, g.numpy() / labels.shape[0], timeout=60)
        losses.append(float(loss))
        if on_step is not None:
            on_step(i)
    return losses


def _clean_reference():
    van = LoopbackVan()
    try:
        srv = KVServer(Postoffice("S0", van), _table_cfgs(), 0, 1, device="cpu")
        wkr = KVWorker(Postoffice("W0", van), _table_cfgs(), 1, device="cpu")
        return _train(wkr, _batches()), srv.pushes
    finally:
        van.close()


def _cross_van_stack(transport, *, seed, drop=0.1, duplicate=0.05, corrupt=0.05):
    """Worker and server on separate TcpVans, chaos under the worker's
    resender."""
    tcp_s = TcpVan(transport=transport)
    van_s = ReliableVan(tcp_s, timeout=0.1, backoff=1.0, max_retries=120)
    tcp_w = TcpVan(transport=transport)
    chaos_w = ChaosVan(tcp_w, seed=seed, drop=drop, duplicate=duplicate, corrupt=corrupt)
    van_w = ReliableVan(chaos_w, timeout=0.1, backoff=1.0, max_retries=120)
    return tcp_s, van_s, tcp_w, chaos_w, van_w


@pytest.mark.parametrize("shm", [True, False], ids=["shm", "tcp"])
def test_training_parity_exactly_once_under_chaos(shm):
    ref_losses, ref_applied = _clean_reference()
    tcp_s, van_s, tcp_w, chaos_w, van_w = _cross_van_stack(TransportConfig(shm=shm), seed=7)
    try:
        server = KVServer(Postoffice("S0", van_s), _table_cfgs(), 0, 1, device="cpu")
        van_w.add_route("S0", van_s.address)
        wkr = KVWorker(Postoffice("W0", van_w), _table_cfgs(), 1, device="cpu")
        losses = _train(wkr, _batches())
        np.testing.assert_array_equal(losses, ref_losses)
        assert _wait_for(lambda: server.pushes == ref_applied, 10)
        assert server.pushes == ref_applied  # exactly once
        assert chaos_w.injected_drops > 0
        assert van_w.gave_up == 0 and van_s.gave_up == 0
        if shm:
            assert tcp_w.counters()["shm_frames_sent"] > 0
            assert tcp_s.counters()["shm_frames_sent"] > 0
        else:
            assert tcp_w.counters()["shm_frames_sent"] == 0
    finally:
        van_w.close()
        van_s.close()


def test_training_parity_shm_fallback_and_migration_under_chaos():
    ref_losses, _ = _clean_reference()
    tcp_s, van_s, tcp_w, _chaos, van_w = _cross_van_stack(
        TransportConfig(), seed=11, drop=0.05, duplicate=0.05, corrupt=0.0)
    try:
        primaries, standbys = replica_lib.make_replicated_servers(
            van_s, _table_cfgs(), 1, sync=True, device="cpu")
        assert primaries
        van_w.add_route("S0", van_s.address)
        wkr = KVWorker(Postoffice("W0", van_w), _table_cfgs(), 1, device="cpu")
        shm_was_live = []

        def on_step(i):
            if i == STEPS // 3:
                shm_was_live.append(tcp_w.counters()["shm_frames_sent"])
                tcp_w.drop_shm_links(disable=True)
                tcp_s.drop_shm_links(disable=True)
            elif i == (2 * STEPS) // 3:
                replica_lib.promote(van_s, standbys[0], "S0")

        losses = _train(wkr, _batches(), on_step=on_step)
        np.testing.assert_array_equal(losses, ref_losses)
        assert shm_was_live and shm_was_live[0] > 0  # the fallback was a real cut
        assert tcp_w.counters()["shm_links"] == 0
        assert van_w.gave_up == 0 and van_s.gave_up == 0
    finally:
        van_w.close()
        van_s.close()


# ----------------------------------------------------- ring slots and the card


def test_ring_slot_held_by_a_tensor_alias_until_it_dies():
    """A received plane aliased by ``torch.from_numpy`` keeps its ring slot:
    the slot frees only when the alias dies too."""
    a, b = TcpVan(), TcpVan()
    try:
        held, ev = [], threading.Event()

        def keep(m):
            held.append(torch.from_numpy(np.asarray(m.values[0])))
            ev.set()

        b.bind("S0", keep)
        a.add_route("S0", b.address)
        assert a.send(_msg())  # negotiates the link
        assert ev.wait(10) and _wait_for(lambda: a.counters()["shm_links"] == 1)
        held.clear()
        gc.collect()
        ring = a._shm_tx_live[next(iter(a._shm_tx_live))]
        assert _wait_for(lambda: ring.tail == ring.head)
        ev.clear()
        assert a.send(_msg(values=[np.arange(64, dtype=np.float32)]))
        assert ev.wait(10) and a.counters()["shm_frames_sent"] >= 1
        alias = held.pop()
        gc.collect()
        assert ring.tail != ring.head  # the alias alone holds the slot
        np.testing.assert_array_equal(alias.numpy(), np.arange(64, dtype=np.float32))
        del alias
        gc.collect()
        assert _wait_for(lambda: ring.tail == ring.head)
    finally:
        a.close()
        b.close()


def test_server_and_device_pull_hold_no_ring_slot():
    """The server's push staging and ``pull_result_device`` copy a wire
    plane on the host before it goes to the device, so once the traffic
    settles every ring slot on both sides is free."""
    tcp_s, tcp_w = TcpVan(), TcpVan()
    try:
        srv = KVServer(Postoffice("S0", tcp_s), _table_cfgs(), 0, 1, device="cpu")
        tcp_w.add_route("S0", tcp_s.address)
        wkr = KVWorker(Postoffice("W0", tcp_w), _table_cfgs(), 1, device="cpu")
        batches = _batches()[:4]
        _train(wkr, batches)
        keys = batches[0][0]
        on_dev = wkr.pull_result_device(wkr.pull("w", keys), timeout=60)
        np.testing.assert_array_equal(on_dev.numpy(), wkr.pull_sync("w", keys, timeout=60))
        assert tcp_w.counters()["shm_frames_sent"] > 0 and tcp_s.counters()["shm_frames_sent"] > 0
        del on_dev
        gc.collect()
        rings = [r for v in (tcp_s, tcp_w) for r in v._shm_tx_live.values()]
        assert len(rings) == 2
        assert _wait_for(lambda: all(r.tail == r.head for r in rings))
        assert srv.pushes == len(batches)
    finally:
        tcp_w.close()
        tcp_s.close()
