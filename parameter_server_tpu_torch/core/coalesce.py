"""Wire coalescing: bundle same-destination KV messages into one frame.

The port's copy of ``parameter_server_tpu/core/coalesce.py``: the bundle
format (``_pack`` / ``_unpack``), the per-link buffers and
:class:`CoalescingVan` with its flush triggers, counters and synthesized
``__error__`` replies, kept so that both packages pack the same messages
into the same index tuples and key bytes.  Values pass through ``_pack`` as
objects: the device-resident planes of ``KVWorker.push_device`` (CUDA
tensors) ride a loopback bundle untouched, never copied to the host here.
On the receive side a bundle reaches ``Postoffice.recv_batch`` as one group,
which hands the server's consecutive pushes to its bundled apply engine
(``KVServer.handle_request_batch``).  :class:`GroupReducer` is the
worker-group reduce stage that runs under the coalescing van: the elected
leader's rendezvous and deterministic host-side reduction of its members'
PUSH planes.

The reference parameter server wins throughput by batching communication
into few large ranged messages; the JAX package's :class:`ReliableVan` makes every frame
carry ACK/seq bookkeeping, so per-message overhead got *more* expensive.
:class:`CoalescingVan` amortizes it: PUSH/PULL messages headed for the same
link inside a flush window are merged into a single bundle frame — one
52-byte flat-frame header (``core/frame.py``), one seq/ACK leg, one filter
pass (key-cache / zlib / int8 quant see the concatenated arrays), one wire
message.  Bundling is re-encode-free by construction: member value arrays
become planes of the ONE bundle frame (the codec joins their buffers
directly), member key bytes concatenate into a single uint8 plane, and the
only new bytes are one header plus a compact tuple index in the meta
section.

Transport v2 extends "re-encode-free" down to the syscall: because member
value arrays stay separate planes here, ``frame.encode_vec`` hands the
transport the bundle as ``[header+meta] + plane`` views and the epoll
backend's vectored send (``ps_van_send_vec`` -> ``writev``) puts them on
the wire without EVER concatenating host-side — no join of the bundle
body exists anywhere between the members' original buffers and the kernel.
The same segment list slice-assigns piecewise into a colocated shm ring
(``core/shm_ring.py``), so both planes inherit the zero-concat property.

Stack position is OUTERMOST::

    CoalescingVan(ReliableVan(ChaosVan(LoopbackVan(filter_chain))))

so the reliability layer stamps exactly one sequence number per bundle and
the whole bundle is retransmitted / deduplicated as a unit — exactly-once
delivery of a bundle is exactly-once delivery of every sub-message, and the
in-order unpack on the receive side preserves per-link FIFO within it.

Wire format: a bundle is a CONTROL :class:`Task` for the reserved customer
``__bundle__`` whose payload carries a per-sub-message index of compact
tuples ``(customer, kind, time, wait_time, payload, is_request, key_meta,
n_values)``; ``Message.keys`` is the uint8 concatenation of every sub's key
bytes (content-hashable by the key-caching filter) and ``Message.values``
is the flat concatenation of every sub's value arrays (quantized per-array
by the int8 filter).

Both ends must be wrapped: an unwrapped receiver sees an unknown customer
``__bundle__`` and replies ``__error__`` (a loud config error, not silent
loss).  Sub-messages buffered at send time report delivery success
optimistically (True); if the bundle turns out undeliverable at flush time,
synthesized ``__error__`` replies are delivered to the local senders so
``Customer.wait`` fails fast instead of hanging — the async analogue of the
unwrapped vans' synchronous ``send() -> False`` contract.
"""

from __future__ import annotations

import contextlib
import dataclasses
import logging
import threading
import time
from typing import Callable

import numpy as np

from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind
from parameter_server_tpu_torch.core.tracectx import TRACE_KEY, trace_ids
from parameter_server_tpu_torch.core.van import Van, VanWrapper

logger = logging.getLogger(__name__)

#: reserved customer id for bundle frames (receivers not wrapped in a
#: CoalescingVan reply ``__error__`` for it — a visible config error).
BUNDLE_CUSTOMER = "__bundle__"
#: payload key holding the list of per-sub-message index dicts.
BUNDLE_KEY = "__subs__"


def _pack(subs: list[Message]) -> Message:
    """Merge ``subs`` (same sender/recver) into one bundle frame.

    The index is a flat tuple per sub (positional, no repeated dict keys) —
    it is the only per-sub overhead the bundle adds to the wire, so it is
    kept as small as the meta codec allows.
    """
    index = []
    key_chunks: list[np.ndarray] = []
    values: list = []
    for m in subs:
        if m.keys is not None:
            k = np.ascontiguousarray(m.keys)
            kb = k.reshape(-1).view(np.uint8)
            key_chunks.append(kb)
            key_meta = (k.dtype.str, tuple(k.shape), int(kb.nbytes))
        else:
            key_meta = None
        index.append(
            (
                m.task.customer,
                m.task.kind.value,
                m.task.time,
                m.task.wait_time,
                m.task.payload,
                m.is_request,
                key_meta,
                len(m.values),
            )
        )
        values.extend(m.values)
    keys = (
        np.concatenate(key_chunks)
        if key_chunks
        else np.empty(0, dtype=np.uint8)
    )
    return Message(
        task=Task(TaskKind.CONTROL, BUNDLE_CUSTOMER, payload={BUNDLE_KEY: index}),
        sender=subs[0].sender,
        recver=subs[0].recver,
        keys=keys,
        values=values,
        is_request=True,
    )


def _unpack(msg: Message) -> list[Message]:
    """Reconstruct the sub-messages of a bundle frame, in send order."""
    index = msg.task.payload[BUNDLE_KEY]
    key_bytes = (
        np.ascontiguousarray(msg.keys).reshape(-1).view(np.uint8)
        if msg.keys is not None
        else np.empty(0, dtype=np.uint8)
    )
    subs: list[Message] = []
    k_off = 0
    v_off = 0
    for customer, kind, time_, wait_time, payload, is_request, key_meta, n_v in index:
        if key_meta is not None:
            dtype, shape, nbytes = key_meta
            # .copy() gives an owned, aligned, writable buffer (frombuffer
            # views are read-only and the server mutates key arrays).
            keys = (
                key_bytes[k_off : k_off + nbytes]
                .copy()
                .view(np.dtype(dtype))
                .reshape(shape)
            )
            k_off += nbytes
        else:
            keys = None
        subs.append(
            Message(
                task=Task(
                    kind=TaskKind(kind),
                    customer=customer,
                    time=time_,
                    wait_time=wait_time,
                    payload=payload,
                ),
                sender=msg.sender,
                recver=msg.recver,
                keys=keys,
                values=list(msg.values[v_off : v_off + n_v]),
                is_request=is_request,
            )
        )
        v_off += n_v
    return subs


class _LinkBuffer:
    """Pending sub-messages for one (sender, recver) link."""

    __slots__ = ("msgs", "deadline", "flush_lock")

    def __init__(self) -> None:
        self.msgs: list[Message] = []
        self.deadline: float = float("inf")
        # serializes pop+wire-emit so two flushers can't reorder the link
        self.flush_lock = threading.Lock()


class CoalescingVan(VanWrapper):
    """Per-link submit-side bundler (see module docstring).

    Flush triggers, any of:

    - ``max_msgs`` sub-messages buffered on a link (count overflow — fires
      even inside a :meth:`window`),
    - ``max_delay`` seconds since the link's first buffered message (a
      background flusher thread; deferred while a :meth:`window` is open),
    - explicit :meth:`flush`, or a :meth:`window` exiting,
    - a non-bundlable frame (CONTROL, ACKs) sent on a link with a non-empty
      buffer — the buffer is flushed *first* so per-link FIFO holds across
      the passthrough.
    """

    def __init__(
        self,
        inner: Van,
        *,
        max_msgs: int = 64,
        max_delay: float = 0.002,
        codec=None,
    ) -> None:
        super().__init__(inner)
        self.max_msgs = int(max_msgs)
        self.max_delay = float(max_delay)
        #: optional lossy wire codec (``filters.QuantizingFilter``) applied
        #: ONCE per outgoing frame at flush time — a single pass over the
        #: bundled value plane — and inverted in ``unbundle`` before
        #: dispatch.  CONTROL passthrough traffic skips it.  Duck-typed
        #: (needs encode/decode/on_send_failed) to avoid a filters import.
        self.codec = codec
        if codec is not None:
            # Residual lifecycle: a peer incarnation advance (crash/restart,
            # same-id restart) means carried error must not replay into the
            # recovered server.  ReliableVan exposes the hook; find it by
            # walking inner (the stack order is fixed but spelled by config).
            reset = getattr(codec, "reset_residuals", None)
            v = inner
            while v is not None and reset is not None:
                hooks = v.__dict__.get("on_incarnation_advance")
                if isinstance(hooks, list):
                    hooks.append(
                        lambda node_id, inc, _r=reset: _r(
                            reason=f"incarnation_advance:{node_id}:{inc}"
                        )
                    )
                    break
                v = getattr(v, "inner", None)
        self._lock = threading.Lock()
        self._cv = threading.Condition(self._lock)
        self._buffers: dict[tuple[str, str], _LinkBuffer] = {}
        self._handlers: dict[str, Callable[[Message], None]] = {}
        self._holds = 0
        self._stopped = False
        # counters
        self._frames = 0
        self._msgs = 0
        self._passthrough = 0
        self._flush_full = 0
        self._flush_timer = 0
        self._undeliverable = 0
        self._flusher = threading.Thread(
            target=self._flush_loop, name="coalesce-flusher", daemon=True
        )
        self._flusher.start()

    # -- send path ----------------------------------------------------------
    def send(self, msg: Message) -> bool:
        link = (msg.sender, msg.recver)
        if msg.task.kind is TaskKind.CONTROL:
            # ACKs / barriers / heartbeats bypass bundling, but must not
            # overtake buffered PUSH/PULL traffic on the same link.
            self._flush_link(link)
            with self._lock:
                self._passthrough += 1
            return self.inner.send(msg)
        with self._lock:
            buf = self._buffers.setdefault(link, _LinkBuffer())
            if not buf.msgs:
                buf.deadline = time.monotonic() + self.max_delay
                self._cv.notify()
            buf.msgs.append(msg)
            full = len(buf.msgs) >= self.max_msgs
            if full:
                self._flush_full += 1
        if full:
            # count overflow flushes even inside a window()
            self._flush_link(link)
        return True

    @contextlib.contextmanager
    def window(self):
        """Defer timer flushes for the duration; flush everything on exit.

        Senders wrap a multi-message burst (a multi-table push, a server's
        reply batch) so the whole burst lands in one frame per link even if
        assembling it takes longer than ``max_delay``.
        """
        with self._lock:
            self._holds += 1
        try:
            yield self
        finally:
            with self._lock:
                self._holds -= 1
                last = self._holds == 0
                self._cv.notify()
            if last:
                # only the LAST window out flushes: another thread's
                # still-open window must not have its half-built burst split
                self.flush_buffers()

    def flush_buffers(self) -> None:
        """Emit every non-empty link buffer (one frame per link)."""
        with self._lock:
            links = [l for l, b in self._buffers.items() if b.msgs]
        for link in links:
            self._flush_link(link)

    def flush(self, timeout: float = 5.0) -> bool:
        """Flush own buffers, then block on the inner stack's flush (e.g.
        ``ReliableVan.flush`` waiting for ACKs)."""
        self.flush_buffers()
        return self.inner.flush(timeout)

    def _flush_link(self, link: tuple[str, str]) -> None:
        with self._lock:
            buf = self._buffers.get(link)
        if buf is None:
            return
        with buf.flush_lock:  # pop + emit is atomic per link (FIFO)
            with self._lock:
                subs = buf.msgs
                if not subs:
                    return
                buf.msgs = []
                buf.deadline = float("inf")
                self._frames += 1
                self._msgs += len(subs)
            frame = subs[0] if len(subs) == 1 else _pack(subs)
            if len(subs) > 1:
                # sampled request tracing: a bundle carries its
                # sampled members' trace ids as an AGGREGATE context on
                # the (fresh, _pack-owned) bundle payload, so the wire
                # planes below see one trace key per frame; ``unbundle``
                # fans the receive stamp back out to the member contexts.
                # Bundles with no sampled member carry nothing.
                tids = [
                    t for s in subs for t in trace_ids(s.task.payload)
                ]
                if tids:
                    frame.task.payload[TRACE_KEY] = {"tids": tids}
            if self.codec is not None:
                encoded = self.codec.encode(frame)
            else:
                encoded = frame
            ok = self.inner.send(encoded)
            if not ok and self.codec is not None:
                self.codec.on_send_failed(frame, encoded)
        if len(subs) > 1:
            flightrec.record(
                "bundle.flush", node=link[0], recver=link[1],
                subs=len(subs), ok=ok,
            )
        if not ok:
            self._deliver_errors(subs)

    def _deliver_errors(self, subs: list[Message]) -> None:
        """Buffered sends returned True optimistically; if the flush finds
        the link dead, synthesize the ``__error__`` replies the Postoffice
        would have produced, so local ``Customer.wait`` fails fast."""
        with self._lock:
            self._undeliverable += len(subs)
        for sub in subs:
            if not sub.is_request:
                continue
            handler = self._handlers.get(sub.sender)
            if handler is None:
                continue
            err = Message(
                task=dataclasses.replace(
                    sub.task,
                    payload={"__error__": f"undeliverable to {sub.recver}"},
                ),
                sender=sub.recver,
                recver=sub.sender,
                is_request=False,
            )
            try:
                handler(err)
            except Exception:  # noqa: BLE001 — one bad error reply must not
                # strand the rest of the bundle's waiters
                logger.exception("coalesce: error-reply handler failed")

    def _flush_loop(self) -> None:
        while True:
            with self._lock:
                if self._stopped:
                    return
                now = time.monotonic()
                nearest = min(
                    (b.deadline for b in self._buffers.values() if b.msgs),
                    default=float("inf"),
                )
                if self._holds > 0 or nearest > now:
                    # holds / empty buffers: sleep until notified (window
                    # exit, first buffered msg, close) — no busy spin
                    wait = (
                        None
                        if self._holds > 0 or nearest == float("inf")
                        else max(nearest - now, 1e-4)
                    )
                    self._cv.wait(timeout=wait)
                    continue
                expired = [
                    l
                    for l, b in self._buffers.items()
                    if b.msgs and b.deadline <= now
                ]
                self._flush_timer += len(expired)
            for link in expired:
                self._flush_link(link)

    # -- receive path -------------------------------------------------------
    def bind(self, node_id: str, handler: Callable[[Message], None]) -> None:
        with self._lock:
            self._handlers[node_id] = handler

        def unbundle(msg: Message) -> None:
            # Every delivery runs inside a window: replies the handler emits
            # coalesce into (at most) one response frame per link and are
            # flushed the moment handling ends — a sync round trip never
            # waits out ``max_delay``.
            with self.window():
                if self.codec is not None:
                    msg = self.codec.decode(msg)
                if msg.task.customer != BUNDLE_CUSTOMER:
                    handler(msg)
                    return
                subs = _unpack(msg)
                bctx = msg.task.payload.get(TRACE_KEY)
                if isinstance(bctx, dict):
                    # sampled request tracing: fan the bundle's
                    # receive stamp back out to its sampled members.  The
                    # ``rx`` stamp only exists on wire paths, where every
                    # member payload was freshly decoded — on a loopback
                    # plane (shared dicts, no rx) nothing is mutated.
                    rx = bctx.get("rx")
                    if rx is not None:
                        for sub in subs:
                            sctx = sub.task.payload.get(TRACE_KEY)
                            if isinstance(sctx, dict) and "rx" not in sctx:
                                sctx["rx"] = rx
                    flightrec.record(
                        "trace.bundle",
                        tids=trace_ids(msg.task.payload),
                        sender=msg.sender,
                        subs=len(subs),
                    )
                # grouped delivery: a Postoffice-bound handler takes the
                # whole bundle at once so batchable customers (the server
                # apply engine) see their members TOGETHER — one device
                # apply per same-table push run, one readback per bundle
                recv_batch = getattr(
                    getattr(handler, "__self__", None), "recv_batch", None
                )
                if recv_batch is not None:
                    recv_batch(subs)
                else:
                    for sub in subs:
                        handler(sub)

        self.inner.bind(node_id, unbundle)

    def unbind(self, node_id: str) -> None:
        with self._lock:
            self._handlers.pop(node_id, None)
        self.inner.unbind(node_id)

    # -- lifecycle / metrics ------------------------------------------------
    def close(self) -> None:
        self.flush_buffers()
        with self._lock:
            self._stopped = True
            self._cv.notify()
        self._flusher.join(timeout=5)
        self.inner.close()

    def counters(self) -> dict:
        with self._lock:
            out = {
                "coalesce_frames": self._frames,
                "coalesce_msgs": self._msgs,
                "coalesce_passthrough": self._passthrough,
                "coalesce_flush_full": self._flush_full,
                "coalesce_flush_timer": self._flush_timer,
                "coalesce_undeliverable": self._undeliverable,
            }
        codec_counters = getattr(self.codec, "counters", None)
        if codec_counters is not None:
            out.update(codec_counters())
        return out


# -- hierarchical push: the reduce-then-push stage ----------------------------
#
# GroupReducer is the leader-side half of the worker-group pre-reduction that
# runs UNDER the CoalescingVan: members ship their localized PUSH planes to
# the elected leader as CONTROL contributions (passthrough, never bundled),
# the leader rendezvouses them here per (table, step), and the ONE reduced
# tensor it pushes rides the normal coalesced frame plane.


class GroupReducer:
    """Per-(table, step) rendezvous + deterministic reduction.

    ``deposit`` collects one member's ``(keys, values)`` contribution; when
    ``expected`` members have deposited, the completed set is reduced and
    returned (exactly once: the set is consumed).  Contributions are ordered
    by member id.  Identical key sets sum in that order (path ``"sum"``);
    differing key sets (or ``mode="merge"``) take the sorted-union merge
    (``np.unique`` + ``np.add.at``, path ``"merge"``).  The JAX reducer's
    ``psum`` over a shared device mesh has no counterpart on a one-card
    host, where the JAX package also sums on the host.

    ``take_stale`` returns (and consumes) sets older than a timeout so the
    leader can flush a PARTIAL reduction when a member died mid-step: the
    contributions it did receive are never lost.
    """

    def __init__(self, expected: int, *, node: str, mode: str = "auto") -> None:
        self.expected = int(expected)
        self.node = node
        self.mode = mode
        self._lock = threading.Lock()
        #: (table, step) -> {"members": {id: (keys, vals, fanin)}, "t0": s}
        self._sets: dict[tuple, dict] = {}
        self.reduced_sets = 0
        self.partial_sets = 0

    def pending(self) -> int:
        with self._lock:
            return len(self._sets)

    def deposit(self, table: str, step: int, member: str, keys, values, fanin: int = 1):
        """Add one contribution; returns ``(keys, values, fanin)`` reduced
        over the full set when this deposit completes it, else None.
        Duplicate deposits (a retransmitted contribution) are ignored."""
        with self._lock:
            st = self._sets.setdefault((table, step), {"members": {}, "t0": time.monotonic()})
            if member in st["members"]:
                return None
            st["members"][member] = (keys, values, int(fanin))
            if len(st["members"]) < self.expected:
                return None
            del self._sets[(table, step)]
            self.reduced_sets += 1
        return self._reduce(table, step, st)

    def take(self, table: str, step: int):
        """Consume a specific pending set as a PARTIAL reduction, or None if
        it is absent (already completed or never started)."""
        with self._lock:
            st = self._sets.pop((table, step), None)
            if st is None:
                return None
            self.partial_sets += 1
        return self._reduce(table, step, st, partial=True)

    def take_stale(self, older_than_s: float) -> list:
        """Consume sets older than ``older_than_s``; returns
        ``[(table, step, (keys, values, fanin)), ...]`` partial reductions."""
        cutoff = time.monotonic() - older_than_s
        with self._lock:
            doomed = [key for key, st in self._sets.items() if st["t0"] <= cutoff]
            stale = [(key, self._sets.pop(key)) for key in doomed]
            self.partial_sets += len(stale)
        return [(t, step, self._reduce(t, step, st, partial=True)) for (t, step), st in stale]

    def _reduce(self, table: str, step: int, st: dict, *, partial=False):
        entries = [st["members"][m] for m in sorted(st["members"])]
        fanin = sum(e[2] for e in entries)
        k0 = np.asarray(entries[0][0])
        same_keys = self.mode != "merge" and all(
            np.array_equal(np.asarray(e[0]), k0) for e in entries[1:]
        )
        if same_keys:
            path = "sum"
            stacked = np.stack([np.asarray(e[1]) for e in entries])
            out = stacked.sum(axis=0, dtype=stacked.dtype) if len(entries) > 1 else stacked[0]
            keys = k0
        else:
            path = "merge"
            cat_keys = np.concatenate([np.asarray(e[0]) for e in entries])
            cat_vals = np.concatenate(
                [np.asarray(e[1]).reshape(np.asarray(e[0]).size, -1) for e in entries]
            )
            keys, inv = np.unique(cat_keys, return_inverse=True)
            out = np.zeros((keys.size, cat_vals.shape[1]), dtype=cat_vals.dtype)
            np.add.at(out, inv, cat_vals)
            tail = np.asarray(entries[0][1]).shape[1:]
            out = out.reshape((keys.size,) + tuple(tail))
        flightrec.record(
            "group.reduce", node=self.node, table=table, step=step,
            members=len(entries), fanin=fanin, rows=int(np.asarray(keys).size),
            path=path, partial=partial,
        )
        return keys, out, fanin
