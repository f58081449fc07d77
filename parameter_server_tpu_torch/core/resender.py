"""ReliableVan: ACK / retransmit / dedup on top of any Van.

The port's copy of ``parameter_server_tpu/core/resender.py``: the same
stamps (``__rseq__``, ``__rinc__``, ``__rcrc__``), ACK frames, seen windows,
incarnation fence and retransmit loop, so both packages stamp the same
sequence numbers and CRCs on the same messages.  Where it differs by
design: :func:`payload_crc32` hashes numpy arrays and CPU tensors (as the
bytes the frame codec writes for them) and skips tensors on the card, the
very planes ``core/frame.py`` refuses to frame.  The JAX module skips its
device arrays by type too, but its codec frames them, so a framed device
plane reaches the receiver as numpy and fails the CRC there; here sender
and receiver agree, framed or not.

Reference analogue: ``src/system/resender.h`` [U] — the layer the reference
kept between the Van's ZeroMQ sockets and the Postoffice so that a message
lost *in flight* (not rejected at send time) is retransmitted until acked,
and a retransmission that races its own ack is deduplicated at the receiver
instead of double-applying a gradient push.

Protocol, per directed link ``(sender, recver)``:

- every outbound message is stamped with a monotonically increasing
  sequence number (``task.payload["__rseq__"]`` — payload-borne so it
  survives the TcpVan's pickle header unchanged);
- the receiving ReliableVan immediately answers with a tiny ACK control
  frame (customer ``__resender__``, never delivered to the Postoffice),
  then checks the seq against a per-link seen-window: fresh messages are
  delivered with the stamp stripped, repeats are counted in
  ``dup_suppressed`` and swallowed — retried pushes are idempotent;
- unacked sends are retransmitted by a single timer thread with
  exponential backoff plus seeded jitter, up to ``max_retries``; exhausting
  the budget drops the message (``gave_up``) and fires ``on_give_up`` so a
  higher layer can fail the task instead of hanging.

Send-time failures (``inner.send`` returning False: receiver unbound on a
LoopbackVan, no route on a TcpVan) stay fail-fast — the transport can
already *name* the receiver as absent, and ``Customer.submit`` turns that
into an immediate undeliverable error.  Retransmits, by contrast, keep
trying through send-time failures for the rest of their budget: a dead
server's identity can come back mid-retry via hot-standby promotion
(:func:`parameter_server_tpu_torch.kv.replica.promote`), and the retransmit
then lands on the promoted replica.  Under a :class:`~parameter_server_tpu_torch.core.
chaos.ChaosVan` (which accepts every frame and loses it in flight) every
loss is handled by retransmission — the stack to prove reliability is
``ReliableVan(ChaosVan(LoopbackVan()))``.

Dedup state is keyed by link, not by endpoint object, so a promoted standby
binding the dead primary's node id inherits the link's seq/window history
(same Van instance in-process); on a cross-process TcpVan promotion is a
route update and each process keeps its own windows.

Same-id restart (incarnation fencing): a process that crashes and restarts
UNDER THE SAME node id cannot reuse the link's seq space — its fresh seq 0
would read as a duplicate to every peer's seen-window, and its stale
pre-crash twin (a zombie that is slow to die) could keep emitting frames
that corrupt the successor's state.  Every frame therefore also carries the
sender's **incarnation** (:data:`~parameter_server_tpu_torch.core.messages.
INCARNATION_KEY`, assigned by the scheduler on re-registration): receivers
key dedup windows by ``(link, incarnation)``, reset the window when a
peer's incarnation advances, and FENCE (drop + count ``rejected_stale``,
no ACK) frames from any lower incarnation.  ACKs echo ``(seq, inc)`` so a
zombie's ACK can never clear the successor's pending entries.
:meth:`ReliableVan.restart_node` is the local half of the lifecycle: it
resets the restarted node's outbound seq counters (the new process starts
at 0 under the new incarnation) and drops the dead process's unacked sends.

Integrity: each data frame is stamped with a CRC32 over its key/value bytes
(``__rcrc__``); a receiver that computes a different digest drops the frame
WITHOUT acking (``rejected_corrupt``), so the sender's normal retransmit
path repairs in-flight payload corruption (ChaosVan bit-flips, bad NICs)
exactly like loss.  Disable with ``integrity=False`` for stacks whose
base-van filter chain is intentionally lossy (int8 quantization).
"""

from __future__ import annotations

import dataclasses
import logging
import random
import threading
import time
import zlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.frame import FrameError, host_plane, plane_view
from parameter_server_tpu_torch.core.tracectx import TRACE_KEY, trace_ids
from parameter_server_tpu_torch.core.messages import (
    INCARNATION_KEY,
    IncarnationRegistry,
    Message,
    Task,
    TaskKind,
)
from parameter_server_tpu_torch.core.van import Van, VanWrapper

#: payload key carrying the per-link sequence stamp.
SEQ_KEY = "__rseq__"
#: payload key carrying the acked sequence number in ACK frames.
ACK_KEY = "__rack__"
#: payload key carrying the CRC32 of the frame's key/value bytes.
CRC_KEY = "__rcrc__"
#: customer name of ACK frames; intercepted below the Postoffice.
ACK_CUSTOMER = "__resender__"
#: payload keys stripped before a frame is delivered to the Postoffice.
_STAMP_KEYS = (SEQ_KEY, INCARNATION_KEY, CRC_KEY)

_log = logging.getLogger(__name__)


def payload_crc32(msg: Message) -> int:
    """CRC32 over the frame's key bytes and every value array's bytes.

    Covers exactly what in-flight corruption can touch and what the wire
    moves (tensor payloads); Task metadata is excluded on purpose — upper
    layers (netmon stamps, trace ctx) legitimately rewrite the payload dict
    between send and delivery.

    Numpy arrays and CPU tensors are hashed as the bytes the frame codec
    writes for them (a bfloat16 tensor as its 16-bit patterns), so a CPU
    tensor and the numpy plane it decodes to give the same digest.  Tensors
    on the card are skipped on both ends: they are delivered by reference
    (nothing on the wire to corrupt), the codec refuses to frame them, and
    hashing them would force the device sync that ``push_device`` exists
    to avoid.  The skip decision is type-based, so sender and receiver
    agree on what was covered.

    Zero-copy: the CRC runs incrementally over each array's own buffer
    (``core/frame.py``'s byte view) — no ``tobytes()`` materialization.
    ``ascontiguousarray`` is a no-op passthrough for the contiguous arrays
    the wire always carries.
    """
    crc = 0
    for a in ([msg.keys] if msg.keys is not None else []) + list(msg.values):
        if isinstance(a, np.ndarray):
            crc = zlib.crc32(plane_view(np.ascontiguousarray(a)), crc)
        elif isinstance(a, torch.Tensor) and a.device.type == "cpu":
            try:
                arr, _name = host_plane(a)
            except FrameError:
                continue  # a dtype the codec cannot frame either
            crc = zlib.crc32(plane_view(arr), crc)
    return crc & 0xFFFFFFFF


class _SeenWindow:
    """Per-link receiver dedup: contiguous low-watermark + sparse set.

    ``fresh(seq)`` is True exactly once per seq.  Memory is bounded at
    ``size`` outstanding out-of-order seqs; past that the watermark jumps
    forward and anything below it reads as a duplicate (safe: the sender's
    retry budget is far smaller than any sane window).
    """

    __slots__ = ("size", "low", "seen")

    def __init__(self, size: int) -> None:
        self.size = size
        self.low = -1  # every seq <= low has been delivered
        self.seen: set[int] = set()

    def fresh(self, seq: int) -> bool:
        if seq <= self.low or seq in self.seen:
            return False
        self.seen.add(seq)
        while self.low + 1 in self.seen:
            self.low += 1
            self.seen.discard(self.low)
        if len(self.seen) > self.size:
            self.low = min(self.seen)
            self.seen = {s for s in self.seen if s > self.low}
        return True


@dataclasses.dataclass
class _Pending:
    msg: Message  # the stamped copy, resent verbatim
    link: Tuple[str, str]
    seq: int
    attempts: int = 0
    due: float = 0.0


class ReliableVan(VanWrapper):
    """Reliable-delivery Van decorator (see module docstring).

    ``timeout`` is the first retransmit deadline; attempt ``n`` waits
    ``timeout * backoff**n`` plus uniform seeded jitter of up to
    ``jitter`` of that value.  Defaults suit in-process tests (ms RTTs);
    DCN deployments should scale ``timeout`` to their RTT.
    """

    def __init__(
        self,
        inner: Van,
        *,
        timeout: float = 0.25,
        backoff: float = 2.0,
        jitter: float = 0.25,
        max_retries: int = 10,
        window: int = 4096,
        seed: int = 0,
        integrity: bool = True,
        on_give_up: Optional[Callable[[Message], None]] = None,
    ) -> None:
        super().__init__(inner)
        self.timeout = timeout
        self.backoff = backoff
        self.jitter = jitter
        self.max_retries = max_retries
        self.window = window
        self.integrity = integrity
        self.on_give_up = on_give_up
        self._rng = random.Random(seed)
        self._next_seq: Dict[Tuple[str, str], int] = {}
        self._pending: Dict[Tuple[Tuple[str, str], int, int], _Pending] = {}
        self._windows: Dict[Tuple[str, str], _SeenWindow] = {}
        #: node_id -> incarnation: stamps local sends, fences inbound frames.
        self.incarnations = IncarnationRegistry()
        self._lock = threading.Lock()
        self._wake = threading.Condition(self._lock)
        self._closed = False
        #: dashboard counters (metrics.transport_counters merges them).
        self.retransmits = 0
        self.dup_suppressed = 0
        self.gave_up = 0
        self.acks_sent = 0
        self.acks_received = 0
        #: frames dropped by the incarnation fence (zombie senders).
        self.rejected_stale = 0
        #: frames dropped by the CRC32 integrity check (bit-flips in flight).
        self.rejected_corrupt = 0
        #: callbacks ``(node_id, incarnation)`` fired (outside the lock)
        #: whenever a peer's incarnation ADVANCES — both the receive-side
        #: learn and the explicit :meth:`set_incarnation` path.  Consumers:
        #: the quantizing codec drops error-feedback residuals so carried
        #: quantization error never replays into a restarted peer.
        self.on_incarnation_advance: list = []
        self._thread = threading.Thread(
            target=self._retransmit_loop, name="resender-retx", daemon=True
        )
        self._thread.start()

    # -- receive side --------------------------------------------------------
    def bind(self, node_id: str, handler: Callable[[Message], None]) -> None:
        self.inner.bind(node_id, self._wrap_handler(handler))

    def _wrap_handler(
        self, handler: Callable[[Message], None]
    ) -> Callable[[Message], None]:
        def wrapped(msg: Message) -> None:
            if msg.task.customer == ACK_CUSTOMER:
                self._on_ack(msg)
                return
            seq = msg.task.payload.get(SEQ_KEY)
            if seq is None:
                handler(msg)  # unstamped (foreign/legacy) traffic
                return
            inc = msg.task.payload.get(INCARNATION_KEY, 0)
            known = self.incarnations.get(msg.sender)
            if inc < known:
                # Incarnation fence: a frame from a dead pre-restart process
                # (zombie).  Dropped WITHOUT an ACK — the zombie's resender
                # exhausts its budget into the void; acking would tell a
                # dead process its corruption landed.
                with self._lock:
                    self.rejected_stale += 1
                flightrec.record(
                    "fence.incarnation", node=msg.recver,
                    sender=msg.sender, inc=inc, known=known, seq=seq,
                )
                return
            crc = msg.task.payload.get(CRC_KEY)
            if crc is not None and self.integrity:
                if payload_crc32(msg) != crc:
                    # corrupted in flight: no ACK, so the sender's verbatim
                    # retransmit (its copy is intact) repairs it like a loss
                    with self._lock:
                        self.rejected_corrupt += 1
                    flightrec.record(
                        "frame.reject", node=msg.recver, reason="crc",
                        sender=msg.sender, seq=seq,
                    )
                    return
            link = (msg.sender, msg.recver)
            if inc > known and self.incarnations.learn(msg.sender, inc):
                # peer restarted: its new process counts seqs from 0 again —
                # reset every window keyed to the old incarnation's seq space
                self._reset_sender_windows(msg.sender)
                self._fire_incarnation_advance(msg.sender, inc)
            # ACK before processing: the sender's clock starts at *its* send
            self._send_ack(msg, seq, inc)
            with self._lock:
                win = self._windows.get(link)
                if win is None:
                    win = self._windows[link] = _SeenWindow(self.window)
                is_fresh = win.fresh(seq)
                if not is_fresh:
                    self.dup_suppressed += 1
            if not is_fresh:
                flightrec.record(
                    "resend.dup", node=msg.recver,
                    sender=msg.sender, seq=seq,
                )
                return
            # strip the stamps: replies share this Task's payload dict, and
            # a stale inherited seq would corrupt the reply link's dedup
            clean = dataclasses.replace(
                msg,
                task=dataclasses.replace(
                    msg.task,
                    payload={
                        k: v
                        for k, v in msg.task.payload.items()
                        if k not in _STAMP_KEYS
                    },
                ),
            )
            handler(clean)

        return wrapped

    def _reset_sender_windows(self, sender: str) -> None:
        """Drop dedup windows for every link originated by ``sender``."""
        with self._lock:
            for link in [l for l in self._windows if l[0] == sender]:
                del self._windows[link]

    def _send_ack(self, msg: Message, seq: int, inc: int) -> None:
        ack = Message(
            task=Task(
                TaskKind.CONTROL,
                ACK_CUSTOMER,
                payload={ACK_KEY: seq, INCARNATION_KEY: inc},
            ),
            sender=msg.recver,
            recver=msg.sender,
            is_request=False,
        )
        # ACKs are not themselves acked/stamped (that way lies recursion);
        # a lost ACK is repaired by the peer's retransmit -> dedup -> re-ACK
        self.inner.send(ack)
        with self._lock:
            self.acks_sent += 1

    def _on_ack(self, msg: Message) -> None:
        # ack for link (our node, peer): msg travelled peer -> us
        link = (msg.recver, msg.sender)
        seq = msg.task.payload.get(ACK_KEY)
        inc = msg.task.payload.get(INCARNATION_KEY, 0)
        with self._lock:
            self.acks_received += 1
            # keyed by (link, inc, seq): an ACK echoing a stale incarnation
            # (a zombie receiver acking pre-restart traffic) cannot clear a
            # successor incarnation's pending entry of the same seq
            self._pending.pop((link, inc, seq), None)

    # -- send side -----------------------------------------------------------
    def send(self, msg: Message) -> bool:
        if self._closed:
            return False
        link = (msg.sender, msg.recver)
        inc = self.incarnations.get(msg.sender)
        with self._lock:
            seq = self._next_seq.get(link, 0)
            self._next_seq[link] = seq + 1
        payload = {**msg.task.payload, SEQ_KEY: seq}
        if inc:
            payload[INCARNATION_KEY] = inc
        if self.integrity:
            payload[CRC_KEY] = payload_crc32(msg)
        stamped = dataclasses.replace(
            msg, task=dataclasses.replace(msg.task, payload=payload)
        )
        if not self.inner.send(stamped):
            return False  # fail-fast: see module docstring
        with self._wake:
            self._pending[(link, inc, seq)] = _Pending(
                stamped, link, seq, attempts=0,
                due=time.monotonic() + self._deadline(0),
            )
            self._wake.notify()
        return True

    def _deadline(self, attempt: int) -> float:
        base = self.timeout * (self.backoff ** attempt)
        return base * (1.0 + self.jitter * self._rng.random())

    def _retransmit_loop(self) -> None:
        while True:
            resend: list[_Pending] = []
            dead: list[_Pending] = []
            with self._wake:
                if self._closed:
                    return
                now = time.monotonic()
                nxt: Optional[float] = None
                for key, p in list(self._pending.items()):
                    if p.due > now:
                        nxt = p.due if nxt is None else min(nxt, p.due)
                        continue
                    p.attempts += 1
                    if p.attempts > self.max_retries:
                        del self._pending[key]
                        self.gave_up += 1
                        dead.append(p)
                    else:
                        p.due = now + self._deadline(p.attempts)
                        nxt = p.due if nxt is None else min(nxt, p.due)
                        resend.append(p)
                        self.retransmits += 1
                if not resend and not dead:
                    self._wake.wait(
                        timeout=(nxt - now) if nxt is not None else 0.2
                    )
                    continue
            for p in resend:
                flightrec.record(
                    "resend.retransmit", node=p.link[0],
                    recver=p.link[1], seq=p.seq, attempt=p.attempts,
                )
                payload = p.msg.task.payload
                if isinstance(payload, dict) and TRACE_KEY in payload:
                    # sampled request tracing: a sampled frame
                    # (or a bundle carrying sampled members) going around
                    # again — the context itself survives untouched
                    # (``_STAMP_KEYS`` never strips it), this event just
                    # makes the extra wire leg attributable
                    flightrec.record(
                        "trace.retransmit",
                        tids=trace_ids(payload),
                        recver=p.link[1],
                        seq=p.seq,
                        attempt=p.attempts,
                    )
                # send-time failure here is NOT fatal: the identity may be
                # rebound (promotion) before the budget runs out
                self.inner.send(p.msg)
            for p in dead:
                flightrec.record(
                    "resend.gave_up", node=p.link[0],
                    recver=p.link[1], seq=p.seq, attempts=p.attempts - 1,
                )
                _log.warning(
                    "resender: gave up on %s->%s seq=%s after %d attempts",
                    p.link[0], p.link[1], p.seq, p.attempts - 1,
                )
                if self.on_give_up is not None:
                    try:
                        self.on_give_up(p.msg)
                    except Exception:  # noqa: BLE001 — user hook
                        _log.exception("resender: on_give_up hook failed")

    # -- same-id restart lifecycle -------------------------------------------
    def set_incarnation(self, node_id: str, incarnation: int) -> bool:
        """Learn ``node_id``'s (possibly new) incarnation; True iff advanced.

        Called on every node when the scheduler broadcasts a bumped
        ``(id, incarnation)`` binding.  On an advance: frames still in
        flight from the node's PREVIOUS incarnation become stale (fenced at
        receivers), local sends from the node stamp the new incarnation and
        restart seq at 0 (the new process's counter), the dead process's
        unacked sends are dropped (their ACKs will never come), and dedup
        windows for links FROM the node reset so the fresh seq space is not
        eaten by pre-crash history.  Sends TO the node keep retransmitting
        untouched — they land on the restarted process, which dedups them
        against its recovered window state (see :meth:`drop_inbound_state`).
        """
        if not self.incarnations.learn(node_id, incarnation):
            return False
        flightrec.record(
            "incarnation.advance", node=node_id, inc=incarnation,
        )
        self._reset_sender_windows(node_id)
        with self._lock:
            for link in [l for l in self._next_seq if l[0] == node_id]:
                del self._next_seq[link]
            for key in [k for k in self._pending if k[0][0] == node_id]:
                del self._pending[key]
        self._fire_incarnation_advance(node_id, incarnation)
        return True

    def _fire_incarnation_advance(self, node_id: str, incarnation: int) -> None:
        for hook in list(self.on_incarnation_advance):
            try:
                hook(node_id, incarnation)
            except Exception:  # noqa: BLE001 — observer hooks must not
                _log.exception("resender: incarnation-advance hook failed")

    def restart_node(self, node_id: str) -> int:
        """Local-authority restart: bump ``node_id``'s incarnation in place.

        For tests and single-process clusters without a Manager; clusters
        with a scheduler should re-register instead (the Manager is the
        incarnation authority) and let the broadcast reach
        :meth:`set_incarnation`.  Returns the new incarnation.
        """
        inc = self.incarnations.get(node_id) + 1
        self.set_incarnation(node_id, inc)
        return inc

    def drop_inbound_state(self, node_id: str) -> None:
        """Forget dedup windows for links INTO ``node_id``.

        Models what a real crash loses at the RECEIVER: the restarted
        process has no memory of which peer seqs it already applied, so a
        pre-crash frame retransmitted into it re-delivers.  Call this on
        the checkpoint-fallback restore path (state rewound anyway —
        re-applies land inside the accepted rewind window).  The replica
        restore path must NOT call it: a sync chain forwards every applied
        push before acking, so "applied set == window content" — keeping
        the windows IS recovering the dedup state from the chain, and it
        is what makes same-id restart exactly-once end to end.
        """
        with self._lock:
            for link in [l for l in self._windows if l[1] == node_id]:
                del self._windows[link]

    # -- introspection / lifecycle -------------------------------------------
    def inflight(self) -> int:
        """Number of sends still awaiting an ACK."""
        with self._lock:
            return len(self._pending)

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until every send is acked (or gave up), then flush inner.

        Delegates the REMAINING budget down the wrapper chain (the
        ``VanWrapper`` flush contract — ``tools/check_wrappers.py``): an
        inner van with its own buffers must get its chance to drain them.
        False on timeout at either layer.
        """
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            if self.inflight() == 0:
                break
            time.sleep(0.005)
        if self.inflight() != 0:
            return False
        return self.inner.flush(max(deadline - time.monotonic(), 0.0))

    def counters(self) -> dict:
        with self._lock:
            return {
                "retransmits": self.retransmits,
                "dup_suppressed": self.dup_suppressed,
                "gave_up": self.gave_up,
                "acks_sent": self.acks_sent,
                "acks_received": self.acks_received,
                "rejected_stale": self.rejected_stale,
                "rejected_corrupt": self.rejected_corrupt,
            }

    def close(self) -> None:
        with self._wake:
            self._closed = True
            self._wake.notify()
        self._thread.join(timeout=5)
        self.inner.close()
