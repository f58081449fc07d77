"""Van: the transport layer.

Counterpart of ``parameter_server_tpu/core/van.py``: the :class:`Van`
interface, the :class:`VanWrapper` base of decorator vans (the port's
:class:`~parameter_server_tpu_torch.core.coalesce.CoalescingVan`), and the
in-process :class:`LoopbackVan` (queues plus one receive thread per bound
node, per-sender FIFO, ``sent`` / ``dropped`` counters).  Handlers run on
those receive threads, so a server's kernels launch off the main thread, on
the current CUDA stream of that thread (the device's default stream).  A
handler exception is logged and journaled to the flight recorder
(``recv.exception``); the thread keeps serving.  ``disconnect`` /
``reconnect`` simulate a dead node (every message to or from it is dropped,
``send`` returns False).  ``filter_chain=`` runs a wire filter chain
(``core/filters.py``); the socket van is ``core/tcp_van.py``.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Optional

from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.messages import Message


class Van:
    """Transport interface: connect endpoints, send messages."""

    def bind(self, node_id: str, handler: Callable[[Message], None]) -> None:
        raise NotImplementedError

    def send(self, msg: Message) -> bool:
        """Deliver ``msg`` to ``msg.recver``.  Returns False if unreachable."""
        raise NotImplementedError

    def unbind(self, node_id: str) -> None:
        """Tear down a bound node's endpoint so a replacement can bind the
        same id."""
        raise NotImplementedError

    def close(self) -> None:
        pass

    def flush(self, timeout: float = 5.0) -> bool:
        """Block until buffered / in-flight frames are settled.

        Base transports deliver synchronously, so this is a no-op; layers
        that buffer (``CoalescingVan``) override it.  Returns False on
        timeout.
        """
        return True

    def counters(self) -> dict:
        """Dashboard counters (summed across a wrapper stack)."""
        return {}


class VanWrapper(Van):
    """Base for decorator Vans (coalescing).

    Delegates the Van interface to ``inner`` explicitly and everything else
    through ``__getattr__``, so a stack like ``CoalescingVan(LoopbackVan())``
    is a drop-in Van for the Postoffice.
    """

    def __init__(self, inner: Van) -> None:
        self.inner = inner

    def bind(self, node_id: str, handler: Callable[[Message], None]) -> None:
        self.inner.bind(node_id, handler)

    def send(self, msg: Message) -> bool:
        return self.inner.send(msg)

    def unbind(self, node_id: str) -> None:
        self.inner.unbind(node_id)

    def close(self) -> None:
        self.inner.close()

    def flush(self, timeout: float = 5.0) -> bool:
        # explicit (not via __getattr__: the base-class no-op would shadow
        # delegation) so flush() on any stack reaches every buffering layer
        return self.inner.flush(timeout)

    def __getattr__(self, name):
        # only reached for attributes not defined on the wrapper itself
        return getattr(self.inner, name)


class _Endpoint:
    """A bound node: its inbox queue and receive thread."""

    def __init__(self, node_id: str, handler: Callable[[Message], None]) -> None:
        self.node_id = node_id
        self.handler = handler
        self.inbox: "queue.Queue[Optional[Message]]" = queue.Queue()
        self.thread = threading.Thread(
            target=self._recv_loop, name=f"van-recv-{node_id}", daemon=True
        )
        self.thread.start()

    def _recv_loop(self) -> None:
        while True:
            msg = self.inbox.get()
            if msg is None:
                return
            try:
                self.handler(msg)
            except Exception as e:  # noqa: BLE001 — a bad message must not
                # kill the node's only receive thread
                logging.getLogger(__name__).exception(
                    "van: handler error on node %r; message dropped", self.node_id
                )
                # black-box trigger: journal the exception and, when a dump
                # dir is configured, capture the ring before it wraps
                try:
                    flightrec.on_recv_exception(self.node_id, e)
                except Exception:  # noqa: BLE001 — observability must never
                    pass  # take down the recv thread it exists to debug
            # drop the handled message now, not when the next one arrives: its
            # planes may be views into a shm ring slot or a native receive
            # buffer, freed only when the last view dies
            del msg

    def stop(self) -> None:
        self.inbox.put(None)
        self.thread.join(timeout=5)


class LoopbackVan(Van):
    """In-process Van: queues + one receive thread per bound node.

    Messages from A to B arrive in send order; cross-sender order is
    unspecified.
    """

    def __init__(self, filter_chain=None) -> None:
        """``filter_chain``: optional ``core.filters.FilterChain`` applied
        encode-on-send / decode-on-receive, so in-process traffic takes the
        codec path socket traffic does."""
        self._endpoints: dict[str, _Endpoint] = {}
        self._disconnected: set[str] = set()
        self._lock = threading.Lock()
        # Filter traffic serializes per LINK (sender, recver): key caching
        # needs wire FIFO per link, while different links encode in parallel.
        self.filter_chain = filter_chain
        self._link_locks: dict[tuple, threading.Lock] = {}
        #: counters for the dashboard (reference network_usage.h role).
        self.sent_messages = 0
        self.dropped_messages = 0

    def bind(self, node_id: str, handler: Callable[[Message], None]) -> None:
        with self._lock:
            if node_id in self._endpoints:
                raise ValueError(f"node {node_id!r} already bound")
            self._endpoints[node_id] = _Endpoint(node_id, handler)

    def send(self, msg: Message) -> bool:
        with self._lock:
            ep = self._endpoints.get(msg.recver)
            if ep is None or {msg.recver, msg.sender} & self._disconnected:
                self.dropped_messages += 1
                return False
            self.sent_messages += 1
        if self.filter_chain is not None:
            with self._lock:
                link_lock = self._link_locks.setdefault(
                    (msg.sender, msg.recver), threading.Lock()
                )
            with link_lock:
                msg = self.filter_chain.decode(self.filter_chain.encode(msg))
        ep.inbox.put(msg)
        return True

    # -- fault injection ----------------------------------------------------
    def disconnect(self, node_id: str) -> None:
        """Simulate a dead node: all traffic to/from it is dropped."""
        with self._lock:
            self._disconnected.add(node_id)

    def reconnect(self, node_id: str) -> None:
        with self._lock:
            self._disconnected.discard(node_id)

    def unbind(self, node_id: str) -> None:
        with self._lock:
            ep = self._endpoints.pop(node_id, None)
        if ep is not None:
            ep.stop()

    def counters(self) -> dict:
        with self._lock:
            return {
                "sent": self.sent_messages,
                "dropped": self.dropped_messages,
            }

    def close(self) -> None:
        with self._lock:
            eps = list(self._endpoints.values())
            self._endpoints.clear()
        for ep in eps:
            ep.stop()
