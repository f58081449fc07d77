"""Postoffice + Customer: per-node message hub and async RPC bookkeeping.

Reference roles (``src/system/postoffice.h``, ``src/system/customer.h`` [U]):
the Postoffice is the per-process hub that owns the Van and routes inbound
messages to Customers; a Customer issues tasks (``Submit -> timestamp``),
tracks outstanding responses, and exposes ``Wait(ts)``.  The Executor's
per-sender ordering bookkeeping is folded into Customer here: the LoopbackVan
delivers per-sender FIFO and same-sender ``wait_time`` dependencies are
therefore satisfied structurally; cross-worker staleness gating happens at
dispatch time via :class:`~parameter_server_tpu_torch.core.clock.ConsistencyController`
(SURVEY.md §7 design stance: gate dispatch, don't park device work).

Copied from the JAX package's ``core/postoffice.py`` (which imports no JAX),
its ``cancel.drop`` flight-recorder record included.  ``recv_batch`` is the
grouped route a :class:`~parameter_server_tpu_torch.core.coalesce.CoalescingVan`
bundle takes to the server's apply engine.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import threading
from typing import Callable, Optional

from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.messages import (
    Message,
    Task,
    TaskKind,
    TimestampGenerator,
)
from parameter_server_tpu_torch.core.van import Van
from parameter_server_tpu_torch.utils.threads import CALLBACKS

#: pseudo-customer name of remote-cancellation control frames.  Intercepted
#: by the Postoffice before customer lookup, so a CANCEL needs no executor
#: and works even for customers that no longer exist on the receiver.
CANCEL_CUSTOMER = "__cancel__"

#: max remembered (origin, customer, ts) cancellation fences per node.
_CANCEL_CAP = 1024


class Postoffice:
    """Per-node hub: binds the node's Van endpoint, routes to customers."""

    def __init__(self, node_id: str, van: Van) -> None:
        self.node_id = node_id
        self.van = van
        self._customers: dict[str, "Customer"] = {}
        #: remote-cancellation fences: (origin, customer) -> cancelled ts
        #: set, FIFO-evicted at _CANCEL_CAP total entries.  A fence placed
        #: BEFORE the matching request arrives (the request leg was delayed
        #: or is a retransmit racing its canceller) drops that request
        #: instead of executing dead work — per-link FIFO means a cancel
        #: never overtakes a request on a healthy link, so fences only
        #: matter exactly when the request is late, which is the point.
        self._cancelled: dict[tuple[str, str], set[int]] = {}
        self._cancel_order: collections.deque = collections.deque()
        self._cancel_lock = threading.Lock()
        #: requests dropped because a cancellation fence matched.
        self.cancelled_drops = 0
        van.bind(node_id, self._on_recv)

    def register(self, customer: "Customer") -> None:
        if customer.name in self._customers:
            raise ValueError(f"customer {customer.name!r} already registered")
        self._customers[customer.name] = customer

    def counters(self) -> dict:
        """Dashboard-mergeable fence counters (utils.metrics attachments)."""
        return {"cancelled_drops": self.cancelled_drops}

    def send(self, msg: Message) -> bool:
        msg.sender = self.node_id
        return self.van.send(msg)

    # -- remote cancellation -------------------------------------------------
    def _on_cancel(self, msg: Message) -> None:
        key = (msg.sender, msg.task.payload["customer"])
        ts = int(msg.task.payload["time"])
        with self._cancel_lock:
            self._cancelled.setdefault(key, set()).add(ts)
            self._cancel_order.append((key, ts))
            while len(self._cancel_order) > _CANCEL_CAP:
                old_key, old_ts = self._cancel_order.popleft()
                fences = self._cancelled.get(old_key)
                if fences is not None:
                    fences.discard(old_ts)
                    if not fences:
                        del self._cancelled[old_key]

    def _consume_cancel(self, sender: str, customer: str, ts: int) -> bool:
        """True (once) if request ``ts`` from ``sender``/``customer`` was
        remotely cancelled; the fence is consumed — ReliableVan dedups
        duplicate deliveries below this layer, so one match is the most a
        fence can ever see."""
        with self._cancel_lock:
            fences = self._cancelled.get((sender, customer))
            if fences is None or ts not in fences:
                return False
            fences.discard(ts)
            if not fences:
                del self._cancelled[(sender, customer)]
            return True

    def _cancel_dropped(self, msg: Message) -> bool:
        """True iff a cancellation fence matched ``msg`` (now dropped)."""
        if not self._consume_cancel(
            msg.sender, msg.task.customer, msg.task.time
        ):
            return False
        self.cancelled_drops += 1
        flightrec.record(
            "cancel.drop", node=self.node_id, sender=msg.sender,
            customer=msg.task.customer, ts=msg.task.time,
        )
        logging.getLogger(__name__).info(
            "%s: dropped cancelled request ts=%s from %s/%s",
            self.node_id,
            msg.task.time,
            msg.sender,
            msg.task.customer,
        )
        return True

    def recv_batch(self, msgs: list[Message]) -> None:
        """Deliver the members of one unbundled frame together.

        Consecutive requests for a customer that implements
        ``handle_request_batch`` are handed over as ONE group (the
        bundle-batched server apply path); everything else — responses,
        cancels, unknown customers, non-batchable customers — routes
        through the ordinary per-message :meth:`_on_recv`, in frame order.
        Cancellation fences are still honoured per member.
        """
        i, n = 0, len(msgs)
        while i < n:
            msg = msgs[i]
            customer = (
                self._customers.get(msg.task.customer)
                if msg.is_request and msg.task.customer != CANCEL_CUSTOMER
                else None
            )
            if (
                customer is None
                or getattr(customer, "handle_request_batch", None) is None
            ):
                self._on_recv(msg)
                i += 1
                continue
            j = i
            live: list[Message] = []
            while (
                j < n
                and msgs[j].is_request
                and msgs[j].task.customer == msg.task.customer
            ):
                if not self._cancel_dropped(msgs[j]):
                    live.append(msgs[j])
                j += 1
            if live:
                try:
                    replies = customer.process_request_batch(live)
                except Exception as e:  # noqa: BLE001
                    # a batch-level failure must still answer EVERY member,
                    # or each requester's wait(ts) hangs forever
                    logging.getLogger(__name__).exception(
                        "%s: batch handler error (%d msgs) from %s",
                        self.node_id,
                        len(live),
                        msg.sender,
                    )
                    replies = []
                    for m in live:
                        reply = m.reply()
                        reply.task = dataclasses.replace(
                            m.task,
                            payload={
                                "__error__": f"{type(e).__name__}: {e}"
                            },
                        )
                        replies.append(reply)
                for reply in replies:
                    if reply is not None:
                        self.van.send(reply)
            i = j

    def _on_recv(self, msg: Message) -> None:
        if msg.is_request and msg.task.customer == CANCEL_CUSTOMER:
            self._on_cancel(msg)
            return  # fire-and-forget: the canceller already finalized
        if msg.is_request and self._cancel_dropped(msg):
            return
        customer = self._customers.get(msg.task.customer)
        if customer is None:
            # The reference glog-and-dropped here, which leaves the
            # requester's wait(ts) hanging forever.  Answer requests with an
            # __error__ payload instead so the task completes with a
            # reportable error; responses for unknown customers stay dropped
            # (replying to a response would ping-pong between two confused
            # nodes).
            if msg.is_request:
                logging.getLogger(__name__).warning(
                    "%s: request for unknown customer %r from %s",
                    self.node_id,
                    msg.task.customer,
                    msg.sender,
                )
                reply = msg.reply()
                reply.task = dataclasses.replace(
                    msg.task,
                    payload={
                        "__error__": (
                            f"unknown customer {msg.task.customer!r} "
                            f"on {self.node_id}"
                        )
                    },
                )
                self.van.send(reply)
            return
        if msg.is_request:
            try:
                reply = customer.process_request(msg)
            except Exception as e:  # noqa: BLE001
                # A failed handler must still answer: otherwise the
                # requester's wait(ts) hangs forever on the missing leg.  The
                # error rides back in the reply payload (Customer records it;
                # see Customer.errors) and the endpoint thread stays alive.
                logging.getLogger(__name__).exception(
                    "%s: handler error for %s from %s",
                    self.node_id,
                    msg.task.kind,
                    msg.sender,
                )
                reply = msg.reply()
                reply.task = dataclasses.replace(
                    msg.task, payload={"__error__": f"{type(e).__name__}: {e}"}
                )
            if reply is not None:
                self.van.send(reply)
        else:
            customer._on_response(msg)


class Customer:
    """Async task issuer/handler bound to one Postoffice node.

    ``submit`` assigns a timestamp, sends one message per receiver, and
    records how many responses complete the task; ``wait`` blocks on that.
    Server-side subclasses override :meth:`handle_request` to produce reply
    values (the reference's ``Parameter::GetValue/SetValue`` seam).
    """

    def __init__(self, name: str, post: Postoffice) -> None:
        self.name = name
        self.post = post
        self._ts = TimestampGenerator()
        self._pending: dict[int, int] = {}
        self._callbacks: dict[int, Callable[[list[Message]], None]] = {}
        self._responses: dict[int, list[Message]] = {}
        self._errors: dict[int, list[str]] = {}
        self._responded: dict[int, set[str]] = {}  # senders already counted
        self._receivers: dict[int, list[str]] = {}  # per-ts fan-out targets
        self._kept: set[int] = set()  # timestamps whose responses are retained
        self._executed: dict[str, int] = {}  # per-sender executed task time
        self._cond = threading.Condition()
        post.register(self)

    # -- requester side -----------------------------------------------------
    def submit(
        self,
        msgs: list[Message],
        callback: Optional[Callable[[list[Message]], None]] = None,
        *,
        keep_responses: bool = False,
    ) -> int:
        """Send one logical task as ``msgs`` (already sliced per receiver).

        All messages share the newly assigned timestamp; the task completes
        when every receiver has responded.  Returns the timestamp.

        Response bodies are retained only when ``keep_responses`` is set (the
        caller then MUST drain them via :meth:`take_responses`) or while a
        callback is pending — otherwise fire-and-forget tasks (pushes,
        heartbeats) would pin every reply payload for the process lifetime.
        """
        ts = self._ts.next()
        with self._cond:
            self._pending[ts] = len(msgs)
            self._receivers[ts] = [m.recver for m in msgs]
            if keep_responses or callback is not None:
                self._responses[ts] = []
            if callback is not None:
                self._callbacks[ts] = callback
            if keep_responses:
                self._kept.add(ts)
        undeliverable = []
        for m in msgs:
            m.task.customer = self.name
            m.task.time = ts
            if not self.post.send(m):
                undeliverable.append(m)
        if undeliverable:
            # Dead receiver(s): complete their legs immediately so wait()
            # cannot hang; the learner layer re-assigns work (WorkloadPool).
            # The drop is recorded as an error so callers that inspect
            # responses (pulls, checkpoints) can distinguish "acked" from
            # "silently dropped" instead of reading zeros.
            logging.getLogger(__name__).warning(
                "%s/%s: task %s undeliverable to %s (dropped)",
                self.post.node_id,
                self.name,
                ts,
                [m.recver for m in undeliverable],
            )
            with self._cond:
                for m in undeliverable:
                    self._errors.setdefault(ts, []).append(
                        f"{m.recver}: undeliverable"
                    )
                self._pending[ts] -= len(undeliverable)
                if self._pending[ts] <= 0:
                    self._finish_locked(ts)
        return ts

    def wait(self, ts: int, timeout: Optional[float] = None) -> bool:
        """Block until task ``ts`` has all responses.  False on timeout."""
        with self._cond:
            return self._cond.wait_for(lambda: ts not in self._pending, timeout)

    def wait_deadline(self, ts: int, deadline: Optional[float]) -> bool:
        """Like :meth:`wait` against an absolute ``time.monotonic`` deadline
        (callers waiting on several tasks share one budget instead of
        resetting the clock per task)."""
        import time as _time

        timeout = None if deadline is None else deadline - _time.monotonic()
        if timeout is not None and timeout <= 0:
            return self.done(ts)
        return self.wait(ts, timeout)

    def cancel(
        self, ts: int, reason: str = "cancelled", *, remote: bool = False
    ) -> bool:
        """Finalize a still-pending task ``ts`` with an error.

        A timed-out :meth:`wait` used to leave the task pending forever —
        ``_pending``/``_responses``/``_errors`` state leaked, and a late
        response could complete a task the caller had already abandoned.
        ``cancel`` closes that hole: the task finishes NOW with ``reason``
        recorded as an error (``errors(ts)``/``check(ts)`` report it for
        kept tasks), late responses are ignored by the existing
        duplicate-response guard, and all bookkeeping is freed by the normal
        completion path.  Returns False if ``ts`` already completed.

        ``remote=True`` additionally sends a fire-and-forget CANCEL control
        frame to every receiver that has not yet responded, so a delayed or
        retransmitted request leg is DROPPED there instead of executing dead
        work (the reference ran abandoned tasks to completion).  Callers
        about to re-submit the same work (deadline-retry paths) should use
        it: without the fence, the original and the retry can both execute —
        for pushes that is a double-apply.  Off by default because some
        abandoned work must still run remotely (a sync-replica forward that
        the primary already applied must reach the replica eventually, or
        the chain diverges).
        """
        with self._cond:
            if ts not in self._pending:
                return False
            targets = []
            if remote:
                responded = self._responded.get(ts, set())
                targets = [
                    r
                    for r in self._receivers.get(ts, [])
                    if r not in responded
                ]
            self._errors.setdefault(ts, []).append(reason)
            self._finish_locked(ts)
        for recver in targets:
            self.post.send(
                Message(
                    task=Task(
                        TaskKind.CONTROL,
                        CANCEL_CUSTOMER,
                        time=ts,
                        payload={"customer": self.name, "time": ts},
                    ),
                    recver=recver,
                )
            )
        return True

    def done(self, ts: int) -> bool:
        with self._cond:
            return ts not in self._pending

    def pending_count(self) -> int:
        """Number of tasks still awaiting responses (in-flight depth)."""
        with self._cond:
            return len(self._pending)

    def responses(self, ts: int) -> list[Message]:
        """Collected response messages for a completed kept task."""
        with self._cond:
            return list(self._responses.get(ts, []))

    def take_responses(self, ts: int) -> list[Message]:
        """Drain (and forget) the responses of a ``keep_responses`` task."""
        with self._cond:
            self._kept.discard(ts)
            self._errors.pop(ts, None)
            return self._responses.pop(ts, [])

    def _on_response(self, msg: Message) -> None:
        ts = msg.task.time
        err = msg.task.payload.get("__error__")
        with self._cond:
            if ts not in self._pending:
                return  # late/duplicate response
            responded = self._responded.setdefault(ts, set())
            if msg.sender in responded:
                # duplicate leg (an app-layer retry racing its original):
                # counting it would complete the task with another
                # receiver's response missing
                return
            responded.add(msg.sender)
            if err is not None:
                self._errors.setdefault(ts, []).append(f"{msg.sender}: {err}")
            if ts in self._responses:
                self._responses[ts].append(msg)
            self._pending[ts] -= 1
            if self._pending[ts] <= 0:
                self._finish_locked(ts)

    def errors(self, ts: int) -> list[str]:
        """Remote handler errors reported in task ``ts``'s responses."""
        with self._cond:
            return list(self._errors.get(ts, []))

    def check(self, ts: int) -> None:
        """Raise if any receiver answered task ``ts`` with an error."""
        errs = self.errors(ts)
        if errs:
            raise RuntimeError(f"task {ts} failed on: " + "; ".join(errs))

    def _finish_locked(self, ts: int) -> None:
        del self._pending[ts]
        self._responded.pop(ts, None)
        self._receivers.pop(ts, None)
        cb = self._callbacks.pop(ts, None)
        if ts in self._kept:
            responses = self._responses.get(ts, [])
        else:
            responses = self._responses.pop(ts, [])
            # error strings are only retained for kept tasks (the callers
            # that inspect them); fire-and-forget errors were already logged
            self._errors.pop(ts, None)
        self._cond.notify_all()
        if cb is not None:
            # Fire off-thread (callbacks may re-submit) on the shared daemon
            # pool — thread-per-callback was unbounded thread creation under
            # high async push rates.
            CALLBACKS.submit(cb, responses)

    # -- responder side -----------------------------------------------------
    def process_request(self, msg: Message) -> Optional[Message]:
        """Route an inbound request through :meth:`handle_request`."""
        reply = self.handle_request(msg)
        with self._cond:
            prev = self._executed.get(msg.sender, -1)
            self._executed[msg.sender] = max(prev, msg.task.time)
        return reply

    #: subclasses that can process a frame's requests TOGETHER (one device
    #: apply per group, one readback per bundle) define this as a method
    #: ``(msgs) -> [reply|None, ...]``; Postoffice.recv_batch routes grouped
    #: delivery through it.  ``None`` here = not batchable.
    handle_request_batch = None

    def process_request_batch(
        self, msgs: list[Message]
    ) -> list[Optional[Message]]:
        """Route a grouped frame through :meth:`handle_request_batch`.

        The handler answers every member itself (per-member errors become
        ``__error__`` replies inside), so all members count as executed.
        """
        replies = self.handle_request_batch(msgs)
        with self._cond:
            for m in msgs:
                prev = self._executed.get(m.sender, -1)
                self._executed[m.sender] = max(prev, m.task.time)
        return replies

    def handle_request(self, msg: Message) -> Optional[Message]:
        """Override: process a request, return the reply Message (or None)."""
        raise NotImplementedError

    def executed_time(self, sender: str) -> int:
        with self._cond:
            return self._executed.get(sender, -1)
