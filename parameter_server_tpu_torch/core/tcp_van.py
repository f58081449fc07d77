"""TcpVan: the socket transport over native TCP cores + shm rings.

The port's copy of ``parameter_server_tpu/core/tcp_van.py``.  Reference
analogue: ``src/system/van.h/.cc`` — ZeroMQ sockets, a node table, and a
receive thread.  The socket/framing/thread core is native C++ (loaded via
ctypes); this module owns routing (node id -> address), message
serialization, per-link filter chains, and handler dispatch.  Frames are
the flat frames of ``core/frame.py``, byte-identical to the JAX package's,
so a JAX ``TcpVan`` and a port ``TcpVan`` talk to each other.

Two planes behind the same Van contract:

- **Wire backend**: ``native/src/epollvan.cc`` (default) multiplexes every
  connection on ONE event-loop thread with non-blocking vectored ``writev``
  sends and bounded per-connection write queues; ``native/src/tcpvan.cc``
  (``PS_WIRE=threaded`` or ``TransportConfig(wire="threaded")``) is the
  thread-per-connection core.  Either way the wire format is the flat
  frame inside ``[u32 magic][u64 len]`` framing, and the receive path hands
  Python a BORROWED native buffer decoded zero-copy (``np.frombuffer``
  views) and freed only when the last view dies.
- **Shared-memory fast path**: links whose peers share a kernel boot id
  negotiate a pair of SPSC mmap rings (``core/shm_ring.py``) over the TCP
  connection; data frames then bypass TCP entirely, decoded zero-copy
  straight off the ring.  TCP stays attached as the control/fallback
  plane: a full ring degrades that one frame to TCP (counted
  ``ring_full``), and any conn death tears the rings down, so chaos,
  migration, and restart paths behave exactly as before.  A peer that
  never answers the offer leaves the link pure TCP.

Shm negotiation and the FIFO cutover.  The handshake rides the TCP conn it
upgrades (``__shmneg__`` control frames, never delivered to endpoints)::

    offer(boot, path)     initiator created ring R_i (it will WRITE R_i)
    accept(boot, path)    acceptor attached R_i as a gated reader and
                          created R_a; its own tx stays OFF
    cutover               each side, at the instant it enables its tx
    confirm(ok)           initiator attached R_a; acceptor enables its tx

Per-link FIFO survives the transition because every data send for a conn —
ring or TCP — runs under that conn's send lock, the ``cutover`` marker is
written to the TCP stream under the SAME lock in the same act that enables
the ring, and the receiver's ring reader is GATED until the dispatch thread
(which enqueues TCP frames in stream order) has processed the marker.

Ring-full backpressure is the one place the two planes can reorder: the
degraded frame rides TCP behind ring frames already in flight.  Links with
no stateful filters tolerate that (the reliable layer dedups), so they
degrade per frame; links running a stateful chain (key caching needs exact
wire FIFO) DROP the frame instead — ``on_send_failed`` rolls the codec back
and the resender retransmits.

Differences from the JAX module, by design:

- **A plane on the card is refused at send.**  A socket carries bytes, not
  references, and the port's resender (``core/resender.py``) hashes CPU
  planes but skips device planes.  Framing a CUDA plane (a D2H copy below
  the resender) would make the receiver's CRC cover bytes the sender's did
  not, so every retransmit would be rejected as corrupt until the resender
  gives up — what the JAX van does with a ``jax.Array``.  So a message for
  a remote node whose keys or values hold a tensor that is not on the CPU
  raises :class:`~parameter_server_tpu_torch.core.frame.FrameError` before
  any filter runs; the caller moves the plane to the host.  In-process
  delivery (a bound local node) still passes it by reference.
- **A shm reader is started under its link's lock.**  The JAX module
  publishes ``link.reader`` before ``Thread.start``, so a teardown in
  between joins an unstarted thread (``RuntimeError: cannot join thread
  before it is started``).  Here start and publication are one act under
  ``link.lock``, teardown marks the link dead under the same lock, and a
  reader is never started on a dead link.
- Receivers copy wire planes on the host before they go to the card (see
  ``core/shm_ring.py``), so a ring slot or native buffer is never read by
  a copy that outlives its views.

Design notes:

- One ``TcpVan`` per *process*; multiple logical nodes (scheduler + servers +
  workers colocated on a host) may bind on it, exactly like LoopbackVan.
- Filters (key caching / compression / quantization — core/filters.py) apply
  per link on the encoded Message before serialization; which plane the
  frame then rides is decided below the filters, so they see one logical
  link either way.
- Unreachable/unknown destinations drop the message and return False — same
  contract as LoopbackVan, which the failure-detection layer builds on.
"""

from __future__ import annotations

import ctypes
import logging
import os
import socket
import threading
import time
import weakref
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch import native
from parameter_server_tpu_torch.config import TransportConfig
from parameter_server_tpu_torch.core import flightrec, frame, shm_ring
from parameter_server_tpu_torch.core.frame import FrameError
from parameter_server_tpu_torch.core.tracectx import TRACE_KEY, trace_ids
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind
from parameter_server_tpu_torch.core.van import Van, _Endpoint

_u8p = ctypes.POINTER(ctypes.c_uint8)
_u8pp = ctypes.POINTER(_u8p)

#: internal handshake customer — intercepted by the dispatch loop, never
#: delivered to endpoints.  Old peers (pre-v2) drop these frames on the
#: floor (no endpoint named ``__shmneg__``), which IS the negotiation
#: failure path: silence leaves the link pure TCP.
SHMNEG_CUSTOMER = "__shmneg__"

#: env overrides (see :class:`~parameter_server_tpu_torch.config.TransportConfig`)
WIRE_ENV = "PS_WIRE"
NO_SHM_ENV = "PS_NO_SHM"

#: native iovec cap of the epoll backend (kMaxIov in epollvan.cc); frames
#: with more segments take the joined single-buffer path.
_MAX_IOV = 64

# _send_on_conn return codes (superset of the native ps_van_send contract)
_SEND_OK = 0
_SEND_DEAD = -1        # conn dead: drop conn, tear down shm, reconnect later
_SEND_WRITEQ_FULL = -2  # epoll write queue refused the frame; conn is fine
_SEND_RING_DROP = -4   # ring full on a stateful-filtered link: frame dropped


def _setup_sigs(lib: ctypes.CDLL) -> ctypes.CDLL:
    if getattr(lib, "_ps_sigs", False):
        return lib
    lib.ps_van_new.argtypes = [
        ctypes.c_char_p, ctypes.c_int, ctypes.POINTER(ctypes.c_int)
    ]
    lib.ps_van_new.restype = ctypes.c_void_p
    lib.ps_van_connect.argtypes = [ctypes.c_void_p, ctypes.c_char_p, ctypes.c_int]
    lib.ps_van_send.argtypes = [ctypes.c_void_p, ctypes.c_int, _u8p, ctypes.c_int64]
    lib.ps_van_recv.argtypes = [
        ctypes.c_void_p, ctypes.c_double, ctypes.POINTER(_u8p),
        ctypes.POINTER(ctypes.c_int),
    ]
    lib.ps_van_recv.restype = ctypes.c_int64
    lib.ps_van_free.argtypes = [_u8p]
    lib.ps_van_disconnect.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.ps_van_close.argtypes = [ctypes.c_void_p]
    lib.ps_van_port.argtypes = [ctypes.c_void_p]
    lib.ps_van_bytes_sent.argtypes = [ctypes.c_void_p]
    lib.ps_van_bytes_sent.restype = ctypes.c_int64
    lib.ps_van_bytes_recv.argtypes = [ctypes.c_void_p]
    lib.ps_van_bytes_recv.restype = ctypes.c_int64
    try:
        # epoll backend only: vectored send + typed write-queue counter
        lib.ps_van_send_vec.argtypes = [
            ctypes.c_void_p, ctypes.c_int, _u8pp,
            ctypes.POINTER(ctypes.c_int64), ctypes.c_int,
        ]
        lib.ps_van_writeq_full.argtypes = [ctypes.c_void_p]
        lib.ps_van_writeq_full.restype = ctypes.c_int64
    except AttributeError:
        pass
    lib._ps_sigs = True
    return lib


def _lib() -> ctypes.CDLL:
    """Legacy threaded backend (kept for ``PS_WIRE=threaded`` and callers
    that import this directly)."""
    return _setup_sigs(native.load("tcpvan", required=True))


def _load_wire(wire: str) -> Tuple[ctypes.CDLL, str]:
    """Resolve the wire backend: requested (env beats config), with a quiet
    fallback from epoll to threaded when the epoll core fails to build."""
    wire = os.environ.get(WIRE_ENV, wire)
    if wire == "epoll":
        lib = native.load("epollvan")
        if lib is not None:
            return _setup_sigs(lib), "epoll"
        logging.getLogger(__name__).warning(
            "tcpvan: epoll backend unavailable; falling back to threaded"
        )
    return _lib(), "threaded"


# ------------------------------------------------------------ serialization


def serialize_message(msg: Message) -> bytes:
    """Message -> flat frame bytes (``core/frame.py``).  One join over the
    header, the binary meta section, and the arrays' own buffers — no
    ``tobytes()`` intermediates, no pickle."""
    return frame.encode(msg)


def deserialize_message(buf) -> Message:
    """Flat frame buffer -> Message; arrays are zero-copy ``frombuffer``
    views.  Raises :class:`~parameter_server_tpu_torch.core.frame.FrameError`
    (typed) on truncated/garbled/corrupt frames — including a plane CRC
    check made in one pass over the raw buffer before any reconstruction."""
    return frame.decode(buf)


# DNS memoization: gethostbyname runs once per host,
# not on every cold connect; a failed connect invalidates the entry so a
# migrated/re-addressed host re-resolves on the retry.
_DNS_LOCK = threading.Lock()
_DNS_CACHE: Dict[str, str] = {}


def _resolve(host: str) -> str:
    """inet_addr in the native core needs a numeric IPv4 (memoized)."""
    with _DNS_LOCK:
        ip = _DNS_CACHE.get(host)
    if ip is not None:
        return ip
    ip = socket.gethostbyname(host)
    with _DNS_LOCK:
        _DNS_CACHE[host] = ip
    return ip


def _dns_invalidate(host: str) -> None:
    with _DNS_LOCK:
        _DNS_CACHE.pop(host, None)


def _refuse_device_planes(msg: Message) -> None:
    """A message leaving the process carries host planes only: a tensor that
    is not on the CPU is a typed :class:`FrameError` (see the module
    docstring), raised before any filter commits per-link state."""
    for a in (msg.keys, *msg.values):
        if isinstance(a, torch.Tensor) and a.device.type != "cpu":
            raise FrameError(
                f"TcpVan: a {a.device.type} tensor plane for {msg.recver!r} "
                "cannot cross a socket; copy it to the host first"
            )


def _free_native(lib: ctypes.CDLL, addr: int) -> None:
    """weakref.finalize target: release a borrowed native recv buffer once
    the last decoded view over it has died."""
    lib.ps_van_free(ctypes.cast(addr, _u8p))


class _ShmLink:
    """One colocated link in (or past) negotiation: the ring we write
    (``tx``), the ring we read (``rx`` + its gated reader thread), and the
    TCP conn that anchors the link's liveness (conn death tears it down)."""

    __slots__ = ("conn", "addr", "tx", "rx", "reader", "gate", "lock", "dead")

    def __init__(self, conn: int, addr: Optional[Tuple[str, int]] = None) -> None:
        self.conn = conn
        self.addr = addr  # set on the initiator side only
        self.tx: Optional[shm_ring.ShmRing] = None
        self.rx: Optional[shm_ring.ShmRing] = None
        #: the rx ring's reader, published only once STARTED (under ``lock``)
        self.reader: Optional[threading.Thread] = None
        #: opened by the peer's ``cutover`` marker: until then the reader
        #: must not deliver (FIFO vs TCP frames still in the dispatch queue)
        self.gate = threading.Event()
        #: orders the reader's start against teardown: a reader is started
        #: and published in one act, and never on a link torn down
        self.lock = threading.Lock()
        self.dead = False


# ------------------------------------------------------------------- TcpVan


class TcpVan(Van):
    """Cross-host Van over the native wire core + colocated shm rings.

    Usage::

        van = TcpVan()                      # binds an ephemeral port
        van.bind("S0", server_handler)      # local node(s)
        van.add_route("W0", ("10.0.0.2", 9001))
        van.send(msg)                       # routes local or remote
    """

    def __init__(
        self,
        host: str = "0.0.0.0",
        port: int = 0,
        *,
        filter_chain=None,
        advertise_host: Optional[str] = None,
        transport: Optional[TransportConfig] = None,
    ) -> None:
        self.transport = transport or TransportConfig()
        self._lib, self.wire_backend = _load_wire(self.transport.wire)
        self._send_vec = getattr(self._lib, "ps_van_send_vec", None)
        actual = ctypes.c_int()
        self._van = self._lib.ps_van_new(
            host.encode(), port, ctypes.byref(actual)
        )
        if not self._van:
            raise OSError(f"TcpVan: cannot bind {host}:{port}")
        self.port = actual.value
        self.advertise_host = advertise_host or "127.0.0.1"
        self.filter_chain = filter_chain
        self._stateless_chain = None  # lazily-built reply-path subchain
        #: bound local nodes: per-node inbox + single handler thread, exactly
        #: like LoopbackVan — KVServer table mutation relies on each node's
        #: handler being single-threaded by construction.
        self._endpoints: Dict[str, _Endpoint] = {}
        self._routes: Dict[str, Tuple[str, int]] = {}
        self._conns: Dict[Tuple[str, int], int] = {}
        #: sender node id -> native conn the last inbound frame arrived on.
        #: Replies ride the requester's own connection (the ZMQ ROUTER
        #: identity pattern), so a server can answer peers it has no route
        #: for yet — e.g. a pull racing ahead of the node-table broadcast.
        self._peer_conns: Dict[str, int] = {}
        self._link_locks: Dict[tuple, threading.Lock] = {}
        #: per-conn send locks: the ring-vs-TCP choice, the write itself,
        #: and the shm cutover are atomic per conn (the FIFO story above)
        self._conn_locks: Dict[int, threading.Lock] = {}
        self._lock = threading.Lock()
        self._closed = threading.Event()
        self.sent_messages = 0
        self.dropped_messages = 0
        self.frame_rejects = 0
        # -- shm fast path state ------------------------------------------
        self.shm_enabled = (
            self.transport.shm and not os.environ.get(NO_SHM_ENV)
        )
        self._boot_id = shm_ring.boot_id()
        #: conn id -> link state (from first offer until teardown)
        self._shm_links: Dict[int, _ShmLink] = {}
        #: conn id -> LIVE tx ring (the flip _send_on_conn checks);
        #: entered only under the conn's send lock, with the cutover marker
        self._shm_tx_live: Dict[int, shm_ring.ShmRing] = {}
        self.shm_frames_sent = 0
        self.shm_bytes_sent = 0
        self.shm_frames_recv = 0
        self.shm_bytes_recv = 0
        self.ring_fulls = 0    # frames hitting a full ring (degraded/dropped)
        self.writeq_fulls = 0  # vectored sends refused by the write queue
        self._dispatch = threading.Thread(
            target=self._dispatch_loop, name=f"tcpvan-dispatch-{self.port}",
            daemon=True,
        )
        self._dispatch.start()

    @property
    def address(self) -> Tuple[str, int]:
        return (self.advertise_host, self.port)

    # -- routing -------------------------------------------------------------
    def add_route(self, node_id: str, address: Tuple[str, int]) -> None:
        with self._lock:
            self._routes[node_id] = address

    def routes(self) -> Dict[str, Tuple[str, int]]:
        with self._lock:
            return dict(self._routes)

    def bind(self, node_id: str, handler: Callable[[Message], None]) -> None:
        with self._lock:
            if node_id in self._endpoints:
                raise ValueError(f"node {node_id!r} already bound")
            self._endpoints[node_id] = _Endpoint(node_id, handler)

    def unbind(self, node_id: str) -> None:
        """Tear down a node's endpoint (see LoopbackVan.unbind)."""
        with self._lock:
            ep = self._endpoints.pop(node_id, None)
        if ep is not None:
            ep.stop()

    # -- send ----------------------------------------------------------------
    def send(self, msg: Message) -> bool:
        if self._closed.is_set():
            with self._lock:
                self.dropped_messages += 1
            return False
        with self._lock:
            local = self._endpoints.get(msg.recver)
        if local is not None:
            # same-process fast path: no serialization; the endpoint's own
            # thread runs the handler (single-threaded per node)
            with self._lock:
                self.sent_messages += 1
            local.inbox.put(msg)
            return True
        _refuse_device_planes(msg)
        with self._lock:
            addr = self._routes.get(msg.recver)
        if addr is None:
            return self._send_via_peer_conn(msg)
        if self.filter_chain is not None:
            # Stateful filters (key caching) need wire-FIFO per link: hold the
            # link lock across encode AND the transport write so a later
            # encode cannot overtake an earlier frame onto the wire/ring
            # (LoopbackVan documents the same invariant).
            with self._lock:
                ll = self._link_locks.setdefault(
                    (msg.sender, msg.recver), threading.Lock()
                )
            with ll:
                orig = msg
                msg = self.filter_chain.encode(msg)
                ok = self._send_wire(msg, addr, stateful=True)
                if not ok:
                    # the receiver never saw this frame — stateful filters
                    # (key caching) must roll back or the link poisons, and
                    # byte counters must un-commit
                    self.filter_chain.on_send_failed(orig, msg)
                return ok
        return self._send_wire(msg, addr)

    def _send_via_peer_conn(self, msg: Message) -> bool:
        """No route: answer over the connection the peer last spoke on."""
        with self._lock:
            conn = self._peer_conns.get(msg.recver)
        if conn is None or self._van is None:
            with self._lock:
                self.dropped_messages += 1
            return False
        # STATELESS filters only on this path (compression/quantization):
        # per-link state (key caching) is keyed by the route-table identity
        # we lack here, but the codec filters are marker-driven — the
        # requester's full chain decodes them fine.  Pull replies are the
        # bulk of the wire's bytes, so skipping them would forfeit most of
        # the compression win.
        orig = msg
        sub = None
        if self.filter_chain is not None:
            sub = self._stateless_chain
            if sub is None:
                sub = self._stateless_chain = self.filter_chain.stateless_subchain()
            msg = sub.encode(msg)
        rc = self._send_on_conn(conn, msg)
        with self._lock:
            if rc == _SEND_OK:
                self.sent_messages += 1
            else:
                self.dropped_messages += 1
                if rc == _SEND_DEAD and self._peer_conns.get(msg.recver) == conn:
                    self._peer_conns.pop(msg.recver, None)  # stale conn
        if rc != _SEND_OK and sub is not None:
            # un-commit codec byte counters for a frame that never hit the
            # wire (same rollback as the routed path)
            sub.on_send_failed(orig, msg)
        if rc == _SEND_DEAD:
            self._teardown_shm(conn)
        return rc == _SEND_OK

    def _send_wire(
        self, msg: Message, addr: Tuple[str, int], *, stateful: bool = False
    ) -> bool:
        if self._closed.is_set() or self._van is None:
            with self._lock:
                self.dropped_messages += 1
            return False
        conn = self._get_conn(addr)
        if conn is None:
            with self._lock:
                self.dropped_messages += 1
            return False
        rc = self._send_on_conn(conn, msg, stateful=stateful)
        with self._lock:
            if rc == _SEND_OK:
                self.sent_messages += 1
            else:
                self.dropped_messages += 1
                # a dead conn forces a reconnect next time; write-queue/ring
                # backpressure keeps the conn: the frame is dropped for the
                # resender to retransmit, nothing below is broken
                if rc == _SEND_DEAD and self._conns.get(addr) == conn:
                    self._conns.pop(addr, None)
        if rc == _SEND_DEAD:
            self._teardown_shm(conn)
            self._lib.ps_van_disconnect(self._van, conn)
        return rc == _SEND_OK

    def _conn_lock(self, conn: int) -> threading.Lock:
        with self._lock:
            return self._conn_locks.setdefault(conn, threading.Lock())

    def _send_on_conn(
        self, conn: int, msg: Message, *, stateful: bool = False
    ) -> int:
        """The per-conn choke point: ring if live, else TCP, atomically.

        Returns ``_SEND_OK``/``_SEND_DEAD``/``_SEND_WRITEQ_FULL``/
        ``_SEND_RING_DROP``.  ``stateful`` marks frames from a stateful
        filter chain: on ring-full those DROP (caller rolls the codec back,
        resender retransmits) instead of degrading to TCP, because the
        degraded frame would arrive out of order and poison key-cache state.
        """
        payload = msg.task.payload
        if isinstance(payload, dict) and TRACE_KEY in payload:
            # sampled request tracing: this is the per-conn
            # choke point every outbound frame — ring OR TCP — passes, so
            # one gated record covers both wire planes.  Unsampled frames
            # (no trace key) cost the dict membership test only.
            flightrec.record(
                "trace.wire_tx",
                tids=trace_ids(payload),
                recver=msg.recver,
                conn=conn,
            )
        with self._conn_lock(conn):
            ring = self._shm_tx_live.get(conn)
            if ring is not None and not ring.closed:
                segs, total = frame.encode_vec(msg)
                if ring.write(segs, total, timeout=self.transport.ring_wait_s):
                    with self._lock:
                        self.shm_frames_sent += 1
                        self.shm_bytes_sent += total
                    return _SEND_OK
                with self._lock:
                    self.ring_fulls += 1
                flightrec.record(
                    "net.ring_full", recver=msg.recver, nbytes=total,
                )
                if stateful:
                    return _SEND_RING_DROP
                return self._wire_send_segs(conn, segs, total)
            return self._wire_send_msg(conn, msg)

    def _wire_send_msg(self, conn: int, msg: Message) -> int:
        if self._send_vec is None:
            data = serialize_message(msg)
            buf = ctypes.cast(ctypes.c_char_p(data), _u8p)
            return self._lib.ps_van_send(self._van, conn, buf, len(data))
        segs, total = frame.encode_vec(msg)
        return self._wire_send_segs(conn, segs, total)

    def _wire_send_segs(self, conn: int, segs: list, total: int) -> int:
        """Vectored send on the epoll backend: a coalesced bundle's header
        and member planes ride one ``writev`` without ever concatenating
        host-side.  Frames over the native iovec cap (or on the threaded
        backend) take the joined single-buffer path."""
        if self._send_vec is not None and len(segs) < _MAX_IOV:
            n = len(segs)
            bufs = (_u8p * n)()
            lens = (ctypes.c_int64 * n)()
            # uint8 views resolve each segment (bytes / bytearray / plane
            # memoryview) to a stable pointer without copying; `holders`
            # pins the buffers for the duration of the call (the native
            # side copies any unsent tail before returning).
            holders = []
            for i, s in enumerate(segs):
                a = np.frombuffer(s, dtype=np.uint8)
                holders.append(a)
                bufs[i] = a.ctypes.data_as(_u8p)
                lens[i] = a.nbytes
            rc = self._lib.ps_van_send_vec(self._van, conn, bufs, lens, n)
            del holders
            if rc == _SEND_WRITEQ_FULL:
                with self._lock:
                    self.writeq_fulls += 1
                flightrec.record("net.writeq_full", conn=conn, nbytes=total)
            if rc != -3:  # -3: over the native seg cap — join instead
                return rc
        data = b"".join(bytes(s) if not isinstance(s, bytes) else s
                        for s in segs)
        buf = ctypes.cast(ctypes.c_char_p(data), _u8p)
        return self._lib.ps_van_send(self._van, conn, buf, len(data))

    def _get_conn(self, addr: Tuple[str, int]) -> Optional[int]:
        with self._lock:
            conn = self._conns.get(addr)
        if conn is not None:
            return conn
        try:
            ip = _resolve(addr[0])
        except OSError:
            return None
        conn = self._lib.ps_van_connect(self._van, ip.encode(), addr[1])
        if conn < 0:
            # the cached resolution may be stale (host re-addressed after a
            # migration): drop it so the retry resolves fresh
            _dns_invalidate(addr[0])
            return None
        with self._lock:
            # lost race: keep the first connection
            existing = self._conns.setdefault(addr, conn)
        if existing != conn:
            # release the abandoned duplicate (fd + native recv state)
            self._lib.ps_van_disconnect(self._van, conn)
        elif self.shm_enabled:
            self._shm_offer(conn, addr)
        return existing

    # -- shm negotiation -----------------------------------------------------
    def _neg_send(self, conn: int, op: str, **fields) -> None:
        payload = {"op": op, "boot": self._boot_id, **fields}
        m = Message(
            task=Task(TaskKind.CONTROL, SHMNEG_CUSTOMER, payload=payload),
            sender="", recver="",
        )
        data = frame.encode(m)
        buf = ctypes.cast(ctypes.c_char_p(data), _u8p)
        self._lib.ps_van_send(self._van, conn, buf, len(data))

    def _shm_offer(self, conn: int, addr: Tuple[str, int]) -> None:
        """Initiator: create our tx ring for this link and offer it."""
        try:
            ring = shm_ring.ShmRing.create(self.transport.ring_capacity)
        except OSError:
            return
        link = _ShmLink(conn, addr)
        link.tx = ring  # created, but OFF until the peer's accept
        with self._lock:
            self._shm_links[conn] = link
        self._neg_send(conn, "offer", path=ring.path)

    def _shm_on_offer(self, conn: int, payload: dict) -> None:
        if (
            not self.shm_enabled
            or payload.get("boot") != self._boot_id
            or not isinstance(payload.get("path"), str)
        ):
            self._neg_send(conn, "nak")
            return
        try:
            rx = shm_ring.ShmRing.attach(payload["path"])
            tx = shm_ring.ShmRing.create(self.transport.ring_capacity)
        except (OSError, shm_ring.ShmRingError):
            self._neg_send(conn, "nak")
            return
        link = _ShmLink(conn)
        link.rx = rx
        link.tx = tx  # OFF until the initiator's confirm
        with self._lock:
            self._shm_links[conn] = link
        self._start_reader(link)  # gated: waits for the initiator's cutover
        self._neg_send(conn, "accept", path=tx.path)

    def _shm_on_accept(self, conn: int, payload: dict) -> None:
        with self._lock:
            link = self._shm_links.get(conn)
        if (
            link is None or link.addr is None or link.rx is not None
            or payload.get("boot") != self._boot_id
            or not isinstance(payload.get("path"), str)
        ):
            return  # not ours / stale / duplicate accept: ignore
        try:
            rx = shm_ring.ShmRing.attach(payload["path"])
        except (OSError, shm_ring.ShmRingError):
            self._neg_send(conn, "confirm", ok=False)
            self._teardown_shm(conn)
            return
        link.rx = rx
        self._start_reader(link)  # gated: waits for the acceptor's cutover
        self._flip_tx_live(conn, link.tx)
        self._neg_send(conn, "confirm", ok=True)

    def _shm_on_confirm(self, conn: int, payload: dict) -> None:
        with self._lock:
            link = self._shm_links.get(conn)
        if link is None or link.addr is not None or link.rx is None:
            return  # not an acceptor-side link: ignore
        if not payload.get("ok"):
            self._teardown_shm(conn)
            return
        self._flip_tx_live(conn, link.tx)

    def _flip_tx_live(self, conn: int, ring: shm_ring.ShmRing) -> None:
        """Enable the ring for sends AND put the cutover marker on the TCP
        stream in one atomic act (vs this conn's data sends): after this, no
        data frame follows the marker on TCP, so the peer's gated reader
        starting at the marker preserves per-link FIFO exactly."""
        with self._conn_lock(conn):
            self._shm_tx_live[conn] = ring
            self._neg_send(conn, "cutover")

    def _start_reader(self, link: _ShmLink) -> None:
        """Start the link's gated reader, unless the link was torn down.

        Start and publication are one act under ``link.lock``, so
        :meth:`_teardown_shm` either sees no reader (and the link is dead,
        so none will start) or a started one it can join."""
        with link.lock:
            if link.dead:
                return
            t = threading.Thread(
                target=self._shm_reader, args=(link,),
                name=f"shm-reader-{self.port}-{link.conn}", daemon=True,
            )
            t.start()
            link.reader = t

    def _shm_reader(self, link: _ShmLink) -> None:
        """Drain one rx ring: zero-copy decode + the same dispatch path TCP
        frames take.  Gated until the peer's cutover marker has passed the
        dispatch thread; exits when the ring closes or the van shuts down."""
        ring = link.rx
        while not link.gate.is_set():
            if self._closed.is_set() or ring.closed:
                return
            link.gate.wait(0.1)
        while not self._closed.is_set():
            if not ring.poll(0.1):
                if ring.closed:
                    return
                continue
            rec = ring.read()
            if rec is None:
                # poll() reports ready on a CLOSED ring too; a drained +
                # closed ring means the peer is gone — exit (don't spin)
                # so teardown's join() succeeds before it unmaps the ring.
                if ring.closed:
                    return
                continue
            idx, view = rec
            # GC-anchored reclamation: every decoded array's base chain
            # roots at this wrapper; the ring slot frees when the LAST view
            # (numpy array or tensor alias) dies — see core/shm_ring.py.
            wrapper = np.frombuffer(view, dtype=np.uint8)
            weakref.finalize(wrapper, ring.release, idx)
            with self._lock:
                self.shm_frames_recv += 1
                self.shm_bytes_recv += len(view)
            self._dispatch_frame(wrapper, len(view), link.conn)
            del wrapper, view, rec

    def _teardown_shm(self, conn: int) -> None:
        """Conn died (or negotiation failed): close both rings, stop the
        reader, fall back to pure TCP.  Re-negotiated on reconnect."""
        with self._lock:
            link = self._shm_links.pop(conn, None)
        if link is None:
            return
        with self._conn_lock(conn):
            self._shm_tx_live.pop(conn, None)
        with self._lock:
            self._conn_locks.pop(conn, None)
        for ring in (link.tx, link.rx):
            if ring is not None:
                ring.mark_closed()
        link.gate.set()  # unblock a reader still waiting on the cutover
        with link.lock:
            link.dead = True  # no reader starts after this
            reader = link.reader
        if reader is not None and reader is not threading.current_thread():
            reader.join(timeout=5)
        for ring in (link.tx, link.rx):
            if ring is not None:
                ring.close()

    def drop_shm_links(self, *, disable: bool = False) -> int:
        """Chaos/test hook: tear down every negotiated shm link (traffic
        falls back to TCP mid-run, the same path a dying peer triggers).
        ``disable=True`` also stops future negotiation, pinning the van to
        pure TCP."""
        if disable:
            self.shm_enabled = False
        with self._lock:
            conns = list(self._shm_links)
        for conn in conns:
            self._teardown_shm(conn)
        return len(conns)

    # -- receive -------------------------------------------------------------
    def _dispatch_loop(self) -> None:
        while not self._closed.is_set():
            data = _u8p()
            conn = ctypes.c_int()
            n = self._lib.ps_van_recv(
                self._van, 0.2, ctypes.byref(data), ctypes.byref(conn)
            )
            if n == -1:
                continue  # timeout tick: re-check closed flag
            if n == -3:
                return
            if n == -2:
                # peer closed; routes stay (reconnect on send), but any shm
                # link anchored to the conn dies with it — that is the
                # fallback path chaos/migration/restart rely on
                self._teardown_shm(conn.value)
                continue
            # Borrowed-buffer decode (no string_at copy): wrap the native
            # malloc'd buffer, decode zero-copy views over it, and free it
            # only when the last view dies (weakref.finalize -> ps_van_free).
            addr = ctypes.cast(data, ctypes.c_void_p).value
            carr = (ctypes.c_ubyte * n).from_address(addr)
            wrapper = np.frombuffer(carr, dtype=np.uint8)
            weakref.finalize(wrapper, _free_native, self._lib, addr)
            self._dispatch_frame(wrapper, n, conn.value)
            del wrapper, carr

    def _dispatch_frame(self, buf, n: int, conn: Optional[int]) -> None:
        """Decode one inbound frame and route it to its endpoint — shared by
        the TCP dispatch loop and every shm ring reader."""
        try:
            msg = deserialize_message(buf)
        except FrameError as e:
            # typed rejection (bad magic/version, header/meta/plane CRC
            # mismatch, truncation): count it and keep the recv thread
            # alive — wire noise reads as loss, repaired by the
            # resender's retransmit, never as a dead transport
            with self._lock:
                self.frame_rejects += 1
                self.dropped_messages += 1
            flightrec.record(
                "frame.reject", reason="decode", nbytes=n,
                error=str(e)[:120],
            )
            logging.getLogger(__name__).debug(
                "tcpvan: rejecting %d-byte frame: %s", n, e
            )
            return
        except Exception:  # noqa: BLE001 — the codec's contract is that
            # every decode failure is a FrameError, but this thread is a
            # process-wide singleton: an exception type the codec missed
            # must still read as one dropped frame, not dead reception
            # for every node in the process
            with self._lock:
                self.frame_rejects += 1
                self.dropped_messages += 1
            flightrec.record("frame.reject", reason="codec-bug", nbytes=n)
            logging.getLogger(__name__).exception(
                "tcpvan: untyped decode failure on %d-byte frame "
                "(codec bug — dropping frame)", n
            )
            return
        if msg.task.customer == SHMNEG_CUSTOMER:
            payload = msg.task.payload
            op = payload.get("op") if isinstance(payload, dict) else None
            if conn is not None:
                self._shm_neg_dispatch(conn, op, payload)
            return  # handshake traffic never reaches endpoints
        if msg.sender and conn is not None:
            with self._lock:
                self._peer_conns[msg.sender] = conn
        try:
            if self.filter_chain is not None:
                with self._lock:
                    ll = self._link_locks.setdefault(
                        (msg.sender, msg.recver), threading.Lock()
                    )
                with ll:
                    msg = self.filter_chain.decode(msg)
        except Exception:  # noqa: BLE001 — one bad message must not kill
            # the single dispatch thread (that would silently disable all
            # reception for every node in this process)
            logging.getLogger(__name__).exception(
                "tcpvan: dropping message for %r after filter-decode error",
                msg.recver,
            )
            with self._lock:
                self.dropped_messages += 1
            return
        payload = msg.task.payload
        if isinstance(payload, dict):
            tctx = payload.get(TRACE_KEY)
            if isinstance(tctx, dict):
                # sampled request tracing: stamp the receive
                # time INTO the context — safe exactly here because this
                # payload dict was freshly decoded off the wire (TCP and
                # shm reader alike), never shared with a sender.  The
                # server's queue attribution (trace.sq) is dispatch - rx.
                tctx["rx"] = time.monotonic()
                flightrec.record(
                    "trace.wire_rx",
                    tids=trace_ids(payload),
                    sender=msg.sender,
                    nbytes=n,
                )
        with self._lock:
            ep = self._endpoints.get(msg.recver)
        if ep is not None:
            ep.inbox.put(msg)  # handler runs on the endpoint's own thread

    def _shm_neg_dispatch(self, conn: int, op, payload) -> None:
        if op == "offer":
            self._shm_on_offer(conn, payload)
        elif op == "accept":
            self._shm_on_accept(conn, payload)
        elif op == "confirm":
            self._shm_on_confirm(conn, payload)
        elif op == "cutover":
            with self._lock:
                link = self._shm_links.get(conn)
            if link is not None:
                link.gate.set()
        elif op == "nak":
            self._teardown_shm(conn)

    # -- stats / lifecycle ---------------------------------------------------
    def counters(self) -> dict:
        with self._lock:
            tx_rings = [
                l.tx for l in self._shm_links.values() if l.tx is not None
            ]
            c = {
                "sent": self.sent_messages,
                "dropped": self.dropped_messages,
                "frame_rejects": self.frame_rejects,
                "bytes_sent": self.bytes_sent(),
                "bytes_recv": self.bytes_recv(),
                "shm_links": len(self._shm_tx_live),
                "shm_frames_sent": self.shm_frames_sent,
                "shm_bytes_sent": self.shm_bytes_sent,
                "shm_frames_recv": self.shm_frames_recv,
                "shm_bytes_recv": self.shm_bytes_recv,
                "ring_full": self.ring_fulls,
                "writeq_full": self.writeq_fulls,
            }
        for tx in tx_rings:
            c["ring_full"] += tx.ring_full
        if self._send_vec is not None and self._van:
            c["writeq_full_native"] = int(
                self._lib.ps_van_writeq_full(self._van)
            )
        return c

    def bytes_sent(self) -> int:
        van = self._van
        return int(self._lib.ps_van_bytes_sent(van)) if van else 0

    def bytes_recv(self) -> int:
        van = self._van
        return int(self._lib.ps_van_bytes_recv(van)) if van else 0

    # Payload egress/ingress regardless of medium: socket bytes PLUS frames
    # that rode a colocated shm ring.  Byte-accounting flows (launch result
    # JSON, bench plane-overlap arm) must use these — with shm negotiated,
    # bytes_sent() alone reads near zero because data frames bypass the
    # socket entirely, while wire filters still compress ring frames.
    def payload_bytes_sent(self) -> int:
        with self._lock:
            return self.bytes_sent() + self.shm_bytes_sent

    def payload_bytes_recv(self) -> int:
        with self._lock:
            return self.bytes_recv() + self.shm_bytes_recv

    def close(self) -> None:
        if self._closed.is_set():
            return
        # dispatch thread exits on its next timeout tick BEFORE the native
        # handle is destroyed (it dereferences the handle in ps_van_recv);
        # shm readers exit on the same flag / their rings' closed marks
        self._closed.set()
        with self._lock:
            conns = list(self._shm_links)
        for conn in conns:
            self._teardown_shm(conn)
        self._dispatch.join(timeout=30)
        with self._lock:
            endpoints = list(self._endpoints.values())
        for ep in endpoints:
            ep.stop()
        if self._dispatch.is_alive():
            # The dispatch thread is wedged (>30s).  Freeing the native van
            # now would be a use-after-free in that thread; leak the handle
            # instead — the process is tearing down anyway.
            logging.getLogger(__name__).error(
                "tcpvan: dispatch thread did not exit; leaking native handle"
            )
            return
        self._lib.ps_van_close(self._van)
        self._van = None
