"""Van: the transport layer.

Counterpart of ``parameter_server_tpu/core/van.py``: the :class:`Van`
interface and the in-process :class:`LoopbackVan` (queues plus one receive
thread per bound node, per-sender FIFO).  Handlers run on those receive
threads, so a server's kernels launch off the main thread, on the current
CUDA stream of that thread (the device's default stream).  Filter chains,
fault injection, the TCP van and the flight recorder hook are not ported
yet.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, Optional

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
            except Exception:  # noqa: BLE001 — a bad message must not kill
                # the node's only receive thread
                logging.getLogger(__name__).exception(
                    "van: handler error on node %r; message dropped", self.node_id
                )

    def stop(self) -> None:
        self.inbox.put(None)
        self.thread.join(timeout=5)


class LoopbackVan(Van):
    """In-process Van: queues + one receive thread per bound node.

    Messages from A to B arrive in send order; cross-sender order is
    unspecified.
    """

    def __init__(self) -> None:
        self._endpoints: dict[str, _Endpoint] = {}
        self._lock = threading.Lock()

    def bind(self, node_id: str, handler: Callable[[Message], None]) -> None:
        with self._lock:
            if node_id in self._endpoints:
                raise ValueError(f"node {node_id!r} already bound")
            self._endpoints[node_id] = _Endpoint(node_id, handler)

    def send(self, msg: Message) -> bool:
        with self._lock:
            ep = self._endpoints.get(msg.recver)
        if ep is None:
            return False
        ep.inbox.put(msg)
        return True

    def unbind(self, node_id: str) -> None:
        with self._lock:
            ep = self._endpoints.pop(node_id, None)
        if ep is not None:
            ep.stop()

    def close(self) -> None:
        with self._lock:
            eps = list(self._endpoints.values())
            self._endpoints.clear()
        for ep in eps:
            ep.stop()
