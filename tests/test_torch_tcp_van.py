"""The port's socket van (``core/tcp_van.py`` over the native cores in
``native/src/``) against the JAX package's, on the CPU over localhost.

- **Twins of ``tests/test_tcp_van.py``** (8 cases): serialization roundtrip,
  an empty frame, the in-process fast path, a cross-van request and reply,
  unroutable drops, a filter chain on the wire, per-link FIFO over 100
  messages, and a real two-process exchange with a child interpreter.
- **Cross-package sockets**: a JAX ``TcpVan`` and a port ``TcpVan`` carry
  a worker's pulls and pushes to a server of the other package, in both
  directions, with ``make_chain("lossless")`` on both ends (the worker's
  key cache hits, the server's decode restores the keys) and once with the
  int8 error-feedback codec (``CoalescingVan(codec=...)`` on both ends).
  Gradients are computed in numpy, so the server's package alone decides
  the float math: every pull and the final table are bitwise equal to the
  same run of the server's package over ``LoopbackVan``.
- **Differences by design**: a shm link whose reader never started tears
  down cleanly (the JAX van joins an unstarted thread there); a plane on
  the card is refused at send with a typed ``FrameError`` (the JAX van
  frames a ``jax.Array`` below its resender, whose CRC then disagrees).

Every wait is on an event or a reply with a deadline; vans bind port 0.
Tolerances: exact throughout.
"""

import subprocess
import sys
import threading

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from parameter_server_tpu import config as jax_config
from parameter_server_tpu.core import coalesce as jax_coalesce
from parameter_server_tpu.core import filters as jax_filters
from parameter_server_tpu.core import messages as jax_messages
from parameter_server_tpu.core import postoffice as jax_postoffice
from parameter_server_tpu.core import resender as jax_resender
from parameter_server_tpu.core import tcp_van as jax_tcp
from parameter_server_tpu.core import van as jax_van
from parameter_server_tpu.kv import server as jax_server
from parameter_server_tpu.kv import worker as jax_worker
from parameter_server_tpu_torch import config, native
from parameter_server_tpu_torch.core import coalesce, filters, messages, postoffice, tcp_van, van
from parameter_server_tpu_torch.core.frame import FrameError
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind
from parameter_server_tpu_torch.core.resender import ReliableVan, payload_crc32
from parameter_server_tpu_torch.core.tcp_van import (
    TcpVan,
    deserialize_message,
    serialize_message,
)
from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
from parameter_server_tpu_torch.kv import server, worker

if native.load("tcpvan") is None:  # pragma: no cover
    pytest.skip("no native toolchain for tcpvan", allow_module_level=True)


def _msg(recver="S0", sender="W0", time_=3, values=None, keys=None, msgs=messages):
    return msgs.Message(
        task=msgs.Task(msgs.TaskKind.PUSH, "w", time=time_, payload={"tag": "t"}),
        sender=sender,
        recver=recver,
        keys=keys,
        values=values if values is not None else [np.ones(4, np.float32)],
    )


# ------------------------------------------------- twins of test_tcp_van.py


def test_serialize_roundtrip():
    m = _msg(keys=np.arange(10, dtype=np.uint64), values=[
        np.random.default_rng(0).normal(size=(10, 4)).astype(np.float32),
        np.arange(3, dtype=np.int32)])
    m2 = deserialize_message(memoryview(serialize_message(m)))
    assert m2.task.kind == TaskKind.PUSH and m2.task.time == 3
    assert m2.task.payload == {"tag": "t"}
    assert m2.sender == "W0" and m2.recver == "S0" and m2.is_request
    np.testing.assert_array_equal(m.keys, m2.keys)
    for a, b in zip(m.values, m2.values):
        np.testing.assert_array_equal(a, b)
    # the same bytes as the JAX van writes for the same message
    jm = _msg(keys=m.keys, values=m.values, msgs=jax_messages)
    assert bytes(serialize_message(m)) == bytes(jax_tcp.serialize_message(jm))


def test_serialize_no_keys_empty_values():
    m = Message(task=Task(TaskKind.CONTROL, "mgr"), sender="H", recver="W0")
    m2 = deserialize_message(memoryview(serialize_message(m)))
    assert m2.keys is None and m2.values == []


def test_local_fast_path_no_socket():
    v = TcpVan()
    try:
        got, ev = [], threading.Event()
        v.bind("S0", lambda m: (got.append(m), ev.set()))
        m = _msg()
        sent_before = v.bytes_sent()
        assert v.send(m)
        assert ev.wait(5)  # delivered on the endpoint's own thread ...
        assert got and got[0] is m  # ... by reference, nothing on the socket
        assert v.bytes_sent() == sent_before
    finally:
        v.close()


def test_cross_van_roundtrip_and_reply():
    a, b = TcpVan(), TcpVan()
    try:
        ev, replies = threading.Event(), []
        a.bind("W0", lambda m: (replies.append(m), ev.set()))
        b.bind("S0", lambda m: b.send(m.reply([np.asarray(m.values[0]) * 2])))
        a.add_route("S0", b.address)
        b.add_route("W0", a.address)
        assert a.send(_msg(values=[np.arange(6, dtype=np.float32)]))
        assert ev.wait(10)
        r = replies[0]
        assert not r.is_request and r.sender == "S0"
        np.testing.assert_allclose(r.values[0], np.arange(6) * 2.0)
        assert a.payload_bytes_sent() > 0 and b.payload_bytes_recv() > 0
    finally:
        a.close()
        b.close()


def test_unroutable_drops():
    v = TcpVan()
    try:
        assert not v.send(_msg(recver="S404"))
        assert v.dropped_messages == 1
        v.add_route("S1", ("127.0.0.1", 1))  # a dead port: connect fails, no hang
        assert not v.send(_msg(recver="S1"))
    finally:
        v.close()


def test_filter_chain_applies_on_wire():
    a = TcpVan(filter_chain=filters.FilterChain([filters.CompressingFilter()]))
    b = TcpVan(filter_chain=filters.FilterChain([filters.CompressingFilter()]))
    try:
        got, ev = [], threading.Event()
        b.bind("S0", lambda m: (got.append(m), ev.set()))
        a.add_route("S0", b.address)
        vals = np.zeros(10000, np.float32)  # compresses well
        assert a.send(_msg(values=[vals]))
        assert ev.wait(10)
        np.testing.assert_array_equal(got[0].values[0], vals)
        assert a.payload_bytes_sent() < vals.nbytes // 10  # actually compressed
    finally:
        a.close()
        b.close()


def test_many_messages_ordered_per_link():
    a, b = TcpVan(), TcpVan()
    try:
        seen, done = [], threading.Event()

        def handler(m):
            seen.append(m.task.time)
            if len(seen) == 100:
                done.set()

        b.bind("S0", handler)
        a.add_route("S0", b.address)
        for t in range(100):
            assert a.send(_msg(time_=t))
        assert done.wait(15)
        assert seen == list(range(100))  # FIFO per link
    finally:
        a.close()
        b.close()


_CHILD = """
import sys, threading
import numpy as np
from parameter_server_tpu_torch.core.tcp_van import TcpVan
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind

van = TcpVan()
done = threading.Event()

def server(msg):
    if msg.task.payload.get("stop"):
        done.set()
        return
    van.send(msg.reply([np.asarray(msg.values[0]) + 100.0]))

van.bind("S0", server)
van.add_route("W0", ("127.0.0.1", int(sys.argv[1])))
van.send(Message(task=Task(TaskKind.CONTROL, "mgr", payload={"port": van.port}),
                 sender="S0", recver="W0"))
done.wait(30)
van.close()
"""


def test_multiprocess_push_pull():
    """A real two-process exchange over TCP: the child is a fresh
    interpreter running the port's van."""
    v = TcpVan()
    try:
        port_ev, reply_ev, state = threading.Event(), threading.Event(), {}

        def handler(m):
            if m.task.kind == TaskKind.CONTROL:
                state["port"] = m.task.payload["port"]
                port_ev.set()
            else:
                state["reply"] = m
                reply_ev.set()

        v.bind("W0", handler)
        proc = subprocess.Popen([sys.executable, "-c", _CHILD, str(v.port)],
                                stdout=subprocess.PIPE, stderr=subprocess.PIPE)
        try:
            assert port_ev.wait(60), "child never announced itself"
            v.add_route("S0", ("127.0.0.1", state["port"]))
            assert v.send(_msg(values=[np.arange(5, dtype=np.float32)]))
            assert reply_ev.wait(30), "no reply from the child process"
            np.testing.assert_allclose(state["reply"].values[0], np.arange(5) + 100.0)
            v.send(Message(task=Task(TaskKind.CONTROL, "w", payload={"stop": True}),
                           sender="W0", recver="S0"))
            assert proc.wait(timeout=30) == 0
        finally:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    finally:
        v.close()


# ----------------------------------------------------- cross-package sockets

ROWS = 1 << 10


class _Pkg:
    def __init__(self, name):
        self.name = name
        if name == "port":
            self.cfg, self.coal, self.filt, self.post = config, coalesce, filters, postoffice
            self.tcp, self.van, self.server, self.worker = tcp_van, van, server, worker
            self.kw = {"device": "cpu"}
        else:
            self.cfg, self.coal, self.filt = jax_config, jax_coalesce, jax_filters
            self.post, self.tcp, self.van = jax_postoffice, jax_tcp, jax_van
            self.server, self.worker, self.kw = jax_server, jax_worker, {}

    def tables(self, int8):
        comp = (self.cfg.WireCompressionConfig(codec="int8", error_feedback=True)
                if int8 else None)
        return {"w": self.cfg.TableConfig(
            name="w", rows=ROWS, dim=1, compression=comp,
            optimizer=self.cfg.OptimizerConfig(kind="adagrad", learning_rate=0.1))}

    def stack(self, base, int8):
        """``base`` under the int8 EF codec's CoalescingVan, or as is."""
        if not int8:
            return base
        return self.coal.CoalescingVan(base, codec=self.filt.quantizer_from_tables(
            self.tables(True)))


def _np_grad(w_pos, labels):
    """The LR gradient in numpy, so neither package's float math is in it."""
    w = np.asarray(w_pos, np.float32)
    p = (1.0 / (1.0 + np.exp(-w.sum(axis=1, dtype=np.float32)))).astype(np.float32)
    g = np.broadcast_to((p - labels.astype(np.float32))[:, None], w.shape)
    return (g / np.float32(labels.shape[0])).astype(np.float32)


def _batches():
    data = SyntheticCTR(key_space=4 * ROWS, nnz=8, batch_size=128, seed=7)
    b0, b1 = data.next_batch(), data.next_batch()
    return [b0, b0, b1, b1]  # repeated key sets: the key cache hits


def _drive(wkr, batches):
    pulls = []
    for keys, labels in batches:
        w_pos = np.asarray(wkr.pull_sync("w", keys, timeout=60), np.float32)
        pulls.append(w_pos.copy())
        wkr.push_sync("w", keys, _np_grad(w_pos, labels), timeout=60)
    return pulls


def _shard(srv):
    return np.asarray(srv.export_shard()["w"]["value"], np.float32)


def _reference(srv_pkg, int8, batches):
    """The server's package alone, over LoopbackVan."""
    v = srv_pkg.stack(srv_pkg.van.LoopbackVan(), int8)
    try:
        cfgs = srv_pkg.tables(int8)
        srv = srv_pkg.server.KVServer(srv_pkg.post.Postoffice("S0", v), cfgs, 0, 1,
                                      **srv_pkg.kw)
        wkr = srv_pkg.worker.KVWorker(srv_pkg.post.Postoffice("W0", v), cfgs, 1,
                                      **srv_pkg.kw)
        return _drive(wkr, batches), _shard(srv)
    finally:
        v.close()


@pytest.mark.parametrize("codec", ["lossless", "int8_ef"])
@pytest.mark.parametrize("worker_pkg,server_pkg", [("jax", "port"), ("port", "jax")])
def test_jax_and_port_nodes_push_and_pull_over_sockets(worker_pkg, server_pkg, codec):
    wp, sp = _Pkg(worker_pkg), _Pkg(server_pkg)
    int8 = codec == "int8_ef"
    batches = _batches()
    ref_pulls, ref_table = _reference(sp, int8, batches)
    tcp_s = sp.tcp.TcpVan(filter_chain=sp.filt.make_chain("lossless"))
    tcp_w = wp.tcp.TcpVan(filter_chain=wp.filt.make_chain("lossless"))
    vs, vw = sp.stack(tcp_s, int8), wp.stack(tcp_w, int8)
    try:
        srv = sp.server.KVServer(sp.post.Postoffice("S0", vs), sp.tables(int8), 0, 1, **sp.kw)
        vw.add_route("S0", tcp_s.address)
        wkr = wp.worker.KVWorker(wp.post.Postoffice("W0", vw), wp.tables(int8), 1, **wp.kw)
        pulls = _drive(wkr, batches)
        for got, want in zip(pulls, ref_pulls):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(_shard(srv), ref_table)
        assert srv.pushes == len(batches)
        # the worker's key cache hit on the repeated key sets and the
        # server's decode restored the keys (else the pulls would differ)
        assert tcp_w.filter_chain.filters[0].hits >= 2
        assert tcp_w.payload_bytes_sent() > 0 and tcp_s.payload_bytes_recv() > 0
        if int8:
            codec_w = wp.filt.find_quantizers(vw)[0]
            assert codec_w.counters()["compress_wire_bytes"] > 0
    finally:
        vw.close()
        vs.close()


# ------------------------------------------------------- differences by design


def test_teardown_of_a_link_whose_reader_never_started():
    """The shm reader join race: the JAX van publishes ``link.reader`` before starting it,
    so a teardown in between joins an unstarted thread.  The port starts and
    publishes under the link's lock, and starts nothing on a dead link."""
    jv = jax_tcp.TcpVan()
    try:
        jlink = jax_tcp._ShmLink(4242)
        jlink.reader = threading.Thread(target=lambda: None)  # published, not started
        jv._shm_links[4242] = jlink
        with pytest.raises(RuntimeError, match="cannot join thread before it is started"):
            jv._teardown_shm(4242)
    finally:
        jv.close()

    v = TcpVan()
    try:
        link = tcp_van._ShmLink(4242)
        v._shm_links[4242] = link
        v._teardown_shm(4242)  # no reader yet: nothing to join, no error
        assert link.dead and link.reader is None
        v._start_reader(link)  # a torn-down link starts no reader
        assert link.reader is None
        # a live link's reader is published started, and joined at teardown
        live = tcp_van._ShmLink(4343)
        from parameter_server_tpu_torch.core.shm_ring import ShmRing

        tx = ShmRing.create(1 << 12)
        live.rx = ShmRing.attach(tx.path)
        v._shm_links[4343] = live
        v._start_reader(live)
        assert live.reader is not None and live.reader.is_alive()
        v._teardown_shm(4343)
        assert not live.reader.is_alive()
        tx.close()
    finally:
        v.close()


def test_card_planes_are_refused_at_send_and_the_jax_crc_disagrees():
    """Card planes on a socket: a socket has no by-reference.  The JAX van frames a
    ``jax.Array`` as numpy beneath its resender, which skipped the plane by
    type: the receiver's CRC covers bytes the sender's did not.  The port
    refuses a plane off the host with a typed ``FrameError`` before any
    filter runs (a ``meta`` tensor stands in for a CUDA one), delivers it by
    reference in-process, and hashes a CPU tensor the same on both ends."""
    vals = np.arange(12, dtype=np.float32).reshape(4, 3)
    jm = _msg(values=[jnp.asarray(vals)], msgs=jax_messages)
    received = jax_tcp.deserialize_message(memoryview(jax_tcp.serialize_message(jm)))
    assert jax_resender.payload_crc32(jm) != jax_resender.payload_crc32(received)

    cpu = _msg(values=[torch.from_numpy(vals)])
    got = deserialize_message(memoryview(serialize_message(cpu)))
    assert payload_crc32(cpu) == payload_crc32(got)

    chain = filters.make_chain("lossless")
    a, b = TcpVan(filter_chain=chain), TcpVan()
    rel = ReliableVan(a, timeout=0.1, backoff=1.0, max_retries=3)
    try:
        seen, ev = [], threading.Event()
        a.bind("W1", lambda m: (seen.append(m), ev.set()))
        a.add_route("S0", b.address)
        card = _msg(keys=np.arange(4, dtype=np.int64),
                    values=[torch.empty((4, 3), device="meta")])
        with pytest.raises(FrameError, match="cannot cross a socket"):
            a.send(card)
        with pytest.raises(FrameError):
            rel.send(card)
        assert chain.overhead()["encode_calls"] == 0  # no filter ran
        assert a.dropped_messages == 0
        local = _msg(recver="W1", values=[torch.empty((4, 3), device="meta")])
        assert a.send(local) and ev.wait(5)
        assert seen[0] is local  # in-process: by reference
    finally:
        rel.close()
        b.close()
