"""Message / Task model.

The reference's wire unit is ``Message{Task, SArray keys, SArray[] values}``
with ``Task.time`` (the integer timestamp returned by Push/Pull) and
``Task.wait_time`` (the dependency edge that encodes BSP/SSP/ASP in the
Executor DAG).  (Reference: ``src/system/message.h`` +
``src/system/proto/task.proto`` [U — reference mount empty, public layout].)

Here a Message is a plain dataclass carrying numpy arrays — zero-copy views
of host staging buffers (the SArray role).  A value plane may also be a
``torch.Tensor`` still on the device (``KVWorker.push_device`` over the
LoopbackVan); servers accept both.  Copied from the JAX package's
``core/messages.py``, which imports no JAX.
"""

from __future__ import annotations

import dataclasses
import enum
import itertools
import threading
from typing import Any, Optional

import numpy as np


class NodeRole(str, enum.Enum):
    SCHEDULER = "scheduler"
    SERVER = "server"
    WORKER = "worker"


#: Node-id conventions of the reference: scheduler "H", servers "S<i>",
#: workers "W<i>", plus group aliases usable as Message.recver.
SCHEDULER = "H"
SERVER_GROUP = "server_group"
WORKER_GROUP = "worker_group"
ALL_GROUP = "all_group"


def server_id(i: int) -> str:
    return f"S{i}"


def worker_id(i: int) -> str:
    return f"W{i}"


def node_role(node_id: str) -> NodeRole:
    if node_id == SCHEDULER:
        return NodeRole.SCHEDULER
    if node_id.startswith("S"):
        return NodeRole.SERVER
    if node_id.startswith("W"):
        return NodeRole.WORKER
    raise ValueError(f"unknown node id {node_id!r}")


class TaskKind(str, enum.Enum):
    PUSH = "push"
    PULL = "pull"
    CONTROL = "control"  # membership, heartbeats, workload assignment


@dataclasses.dataclass
class Task:
    kind: TaskKind
    customer: str
    #: logical timestamp assigned by the submitting Customer; the public async
    #: handle (``wait(ts)``).
    time: int = -1
    #: dependency: the receiver must have executed this customer's tasks up to
    #: ``wait_time`` before running this one (-1 = no dependency).  BSP sets
    #: it to ``time - 1``; SSP to ``time - 1 - max_delay``; ASP leaves -1.
    wait_time: int = -1
    #: free-form control payload (registration info, workload ids, ...).
    payload: dict[str, Any] = dataclasses.field(default_factory=dict)


@dataclasses.dataclass
class Message:
    task: Task
    sender: str = ""
    recver: str = ""
    #: sorted unique key array for PUSH/PULL (may be row ids once localized).
    keys: Optional[np.ndarray] = None
    #: value arrays (gradients, weights, optimizer rows): numpy, or torch
    #: tensors on the device for in-process planes.
    values: list[Any] = dataclasses.field(default_factory=list)
    #: request vs response leg of an RPC pair.
    is_request: bool = True

    def reply(self, values: Optional[list[np.ndarray]] = None) -> "Message":
        """Build the response leg for this request."""
        return Message(
            task=self.task,
            sender=self.recver,
            recver=self.sender,
            keys=self.keys,
            values=values or [],
            is_request=False,
        )


class TimestampGenerator:
    """Thread-safe monotonically increasing timestamps (per customer)."""

    def __init__(self) -> None:
        self._counter = itertools.count()
        self._lock = threading.Lock()

    def next(self) -> int:
        with self._lock:
            return next(self._counter)


#: payload key carrying the sender's incarnation (restart epoch) number.
#: Stamped next to the per-link sequence (``core/resender.py``) so a node's
#: transport identity is ``(node_id, incarnation, seq)``: a process that
#: crashes and restarts under the SAME node id gets a higher incarnation,
#: receivers reset their dedup windows for it, and frames from the dead
#: pre-crash process (a "zombie") are fenced instead of corrupting state.
INCARNATION_KEY = "__rinc__"


class IncarnationRegistry:
    """Thread-safe ``node_id -> incarnation`` table.

    The scheduler (``core/manager.py``) is the authority that ASSIGNS
    incarnations (re-registration under an existing id bumps it); every
    transport endpoint keeps a registry like this as its local view — used
    both to stamp outgoing frames from local nodes and to fence inbound
    frames from stale incarnations of a peer.  Incarnations only ever
    advance: ``learn`` ignores regressions (a delayed broadcast must never
    re-open the fence).
    """

    def __init__(self) -> None:
        self._inc: dict[str, int] = {}
        self._lock = threading.Lock()

    def get(self, node_id: str) -> int:
        with self._lock:
            return self._inc.get(node_id, 0)

    def learn(self, node_id: str, incarnation: int) -> bool:
        """Record ``incarnation`` for ``node_id``; True iff it advanced."""
        with self._lock:
            if incarnation <= self._inc.get(node_id, 0):
                return False
            self._inc[node_id] = incarnation
            return True

    def bump(self, node_id: str) -> int:
        """Advance ``node_id``'s incarnation by one and return it."""
        with self._lock:
            inc = self._inc.get(node_id, 0) + 1
            self._inc[node_id] = inc
            return inc

    def snapshot(self) -> dict[str, int]:
        with self._lock:
            return dict(self._inc)
