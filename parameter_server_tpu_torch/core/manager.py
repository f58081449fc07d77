"""Node management: registration, membership, heartbeats, elasticity.

Reference analogue (``src/system/manager.h/.cc`` + ``assigner.h`` +
``heartbeat_info.h`` [U — reference mount empty, public layout]): the
scheduler node collects REGISTER messages from launching workers/servers,
assigns node ids and server key ranges (NodeAssigner), and broadcasts
ADD_NODE with the full node table; afterwards it watches heartbeats and
broadcasts REMOVE_NODE when a node misses its window.

The same protocol runs over any :class:`~parameter_server_tpu_torch.core.van.Van`
as CONTROL messages.  Its value is the *elastic* paths: dead-worker detection
feeding :class:`~parameter_server_tpu_torch.core.clock.ConsistencyController`
and the WorkloadPool, dead-server detection feeding
:class:`~parameter_server_tpu_torch.kv.replica.ReplicaSet`, same-id rejoins
and the routing-table broadcast of live migrations.

Copied from the JAX package's ``core/manager.py``, which imports no JAX:
the same verbs, payloads and node-table rows.  The TELEMETRY verb carries
the live telemetry plane: attach a
:class:`~parameter_server_tpu_torch.core.telemetry.TelemetryAggregator` as
the scheduler's ``telemetry`` and a
:class:`~parameter_server_tpu_torch.core.telemetry.TelemetryPublisher` as
each node's ``telemetry_pub``; ``send_heartbeat`` then publishes a frame on
every beat and the scheduler ingests (and evaluates its SLO engine) before
it replies.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, List, Optional

from parameter_server_tpu_torch.core.messages import (
    SCHEDULER,
    Message,
    NodeRole,
    Task,
    TaskKind,
    node_role,
    server_id,
    worker_id,
)
from parameter_server_tpu_torch.core.postoffice import Customer, Postoffice

#: CONTROL payload "cmd" values — the reference's Control proto verbs.
REGISTER = "register"
ADD_NODE = "add_node"
REMOVE_NODE = "remove_node"
HEARTBEAT = "heartbeat"
BARRIER = "barrier"
PING = "ping"
#: routing-table broadcast: the scheduler owns the authoritative
#: epoch-versioned RoutingTable and pushes new generations to the fleet.
ROUTING = "routing"
#: live telemetry: delta-encoded per-node frames riding the heartbeat
#: cadence; the scheduler folds them into its TelemetryAggregator.
TELEMETRY = "telemetry"

#: The closed CONTROL-verb registry.  MUST stay a literal frozenset of
#: plain strings — ``tests/test_torch_manager.py`` parses this set out of
#: the AST (no import) and verifies every ``{"cmd": ...}`` payload literal
#: in the package names a registered verb.  Add new verbs here AND as a
#: module constant above.
CONTROL_VERBS = frozenset({
    "register",
    "add_node",
    "remove_node",
    "heartbeat",
    "barrier",
    "ping",
    "routing",
    "telemetry",
})
# import-time sync check: a verb constant that drifts from the registry
# fails the import, not just the AST pass
assert CONTROL_VERBS == frozenset({
    REGISTER, ADD_NODE, REMOVE_NODE, HEARTBEAT, BARRIER, PING, ROUTING,
    TELEMETRY,
}), "CONTROL_VERBS out of sync with the verb constants"


@dataclasses.dataclass
class NodeInfo:
    """One row of the scheduler's node table."""

    node_id: str
    role: NodeRole
    #: server key range [begin, end) over the global row space (servers only).
    range_begin: int = 0
    range_end: int = 0
    #: wall time of the last heartbeat seen by the scheduler.
    last_seen: float = 0.0
    alive: bool = True
    #: restart epoch of this node id (scheduler-assigned; bumped on every
    #: re-registration under the same id).  Broadcast with the table so
    #: every transport endpoint can fence frames from stale incarnations
    #: (the reliable van's fence, where the stack has one).
    incarnation: int = 0
    #: (host, port) the node's Van listens on (multi-process TcpVan runs;
    #: None on an in-process LoopbackVan).  Broadcast with the table so
    #: every process can route to every other.
    address: Optional[list] = None


class NodeAssigner:
    """Even key-range split over servers (``src/system/assigner.h`` [U]).

    The range here is an abstract [0, key_space) row space; concrete tables
    scale it to their own row counts via
    :class:`~parameter_server_tpu_torch.kv.partition.RangePartition`, which uses the
    same even-contiguous-split rule, so both layers agree on shard boundaries.
    """

    def __init__(self, key_space: int) -> None:
        self.key_space = key_space

    def ranges(self, num_servers: int) -> List[tuple[int, int]]:
        from parameter_server_tpu_torch.kv.partition import RangePartition

        off = RangePartition(self.key_space, num_servers).offsets
        return [(int(off[s]), int(off[s + 1])) for s in range(num_servers)]


class Manager(Customer):
    """Membership manager; scheduler-role instances own the node table.

    Every process creates one Manager on its Postoffice.  Non-scheduler nodes
    call :meth:`register_with_scheduler` at startup and then send periodic
    heartbeats; the scheduler replies to REGISTER once all expected nodes have
    arrived, broadcasting the complete table (one-shot batch ADD_NODE, which
    is the reference's startup behavior).
    """

    CUSTOMER_NAME = "manager"

    def __init__(
        self,
        post: Postoffice,
        *,
        num_workers: int,
        num_servers: int,
        key_space: int = 1 << 20,
        heartbeat_timeout: float = 5.0,
        advertise: Optional[tuple] = None,
    ) -> None:
        """``advertise``: this node's Van (host, port) for multi-process
        clusters — carried in REGISTER and broadcast with the node table so
        peers can ``van.add_route`` to each other."""
        super().__init__(self.CUSTOMER_NAME, post)
        self.advertise = advertise
        self.role = node_role(post.node_id)
        self.num_workers = num_workers
        self.num_servers = num_servers
        self.assigner = NodeAssigner(key_space)
        self.heartbeat_timeout = heartbeat_timeout
        self._table: Dict[str, NodeInfo] = {}
        self._barriers: Dict[str, set] = {}
        self._barrier_acks: Dict[str, set] = {}
        self._table_lock = threading.Lock()
        self._ready = threading.Event()
        #: elasticity callbacks: fn(node_id) on death / (re)join.
        self.on_node_dead: List[Callable[[str], None]] = []
        self.on_node_added: List[Callable[[str], None]] = []
        #: latest RoutingTable seen (scheduler: the authoritative copy set by
        #: set_routing; others: the last ROUTING broadcast adopted).
        self.routing = None
        #: fn(RoutingTable) fired on every newly-adopted broadcast — wire a
        #: worker's ``adopt_routing`` here for eager (non-fence) convergence.
        self.on_routing: List[Callable] = []
        self._monitor_thread: Optional[threading.Thread] = None
        self._stop = threading.Event()
        #: scheduler-side sink for heartbeat stats (attach a
        #: ``core.fleet.FleetMonitor``); None = stats dropped as before.
        self.fleet = None
        #: scheduler-side sink for TELEMETRY frames (attach a
        #: ``core.telemetry.TelemetryAggregator``); None = frames dropped.
        self.telemetry = None
        #: node-side frame source (attach a
        #: ``core.telemetry.TelemetryPublisher``); when set,
        #: ``send_heartbeat`` auto-publishes a frame after each beat.
        self.telemetry_pub = None
        #: clock offset vs the scheduler (local minus scheduler monotonic,
        #: seconds) + the RTT of the winning sample — set by sync_clock().
        self.clock_offset: Optional[float] = None
        self.clock_rtt: Optional[float] = None
        if self.role == NodeRole.SCHEDULER:
            self._register_self()

    # -- startup -------------------------------------------------------------
    def _register_self(self) -> None:
        with self._table_lock:
            self._table[self.post.node_id] = NodeInfo(
                self.post.node_id, self.role, last_seen=time.monotonic()
            )

    def register_with_scheduler(
        self, timeout: Optional[float] = 30.0, *, wait: bool = True
    ) -> bool:
        """Send REGISTER; optionally block until the table broadcast arrives.

        ``wait=False`` returns immediately (callers that launch many nodes
        from one thread register them all first, then ``wait_ready`` each —
        otherwise node k would block on nodes k+1.. ever registering).
        """
        payload = {"cmd": REGISTER, "role": self.role.value}
        if self.advertise is not None:
            payload["address"] = list(self.advertise)
        self.submit(
            [
                Message(
                    task=Task(TaskKind.CONTROL, self.name, payload=payload),
                    recver=SCHEDULER,
                )
            ]
        )
        if not wait:
            return True
        return self._ready.wait(timeout)

    def wait_ready(self, timeout: Optional[float] = 30.0) -> bool:
        """Scheduler: block until all expected nodes have registered."""
        return self._ready.wait(timeout)

    # -- table access --------------------------------------------------------
    def nodes(self, role: Optional[NodeRole] = None, alive_only: bool = False):
        with self._table_lock:
            rows = [
                n
                for n in self._table.values()
                if (role is None or n.role == role)
                and (not alive_only or n.alive)
            ]
        return sorted(rows, key=lambda n: n.node_id)

    def server_range(self, sid: str) -> tuple[int, int]:
        with self._table_lock:
            n = self._table[sid]
            return (n.range_begin, n.range_end)

    def is_alive(self, node_id: str) -> bool:
        with self._table_lock:
            n = self._table.get(node_id)
            return bool(n and n.alive)

    # -- message handling ----------------------------------------------------
    def handle_request(self, msg: Message) -> Optional[Message]:
        cmd = msg.task.payload.get("cmd")
        if cmd == REGISTER:
            self._on_register(msg)
        elif cmd == ADD_NODE:
            self._on_add_node(msg)
        elif cmd == REMOVE_NODE:
            self._on_remove_node(msg)
        elif cmd == HEARTBEAT:
            self._on_heartbeat(msg)
        elif cmd == BARRIER:
            return self._on_barrier(msg)
        elif cmd == PING:
            return self._on_ping(msg)
        elif cmd == ROUTING:
            self._on_routing(msg)
        elif cmd == TELEMETRY:
            self._on_telemetry(msg)
        return msg.reply()

    # -- routing-table broadcast ---------------------------------------------
    def set_routing(self, routing) -> None:
        """Scheduler: adopt ``routing`` as authoritative and broadcast it.

        One CONTROL message per alive node; delivery is per-node atomic (a
        node sees the old table or the new one, never a blend) and stragglers
        self-heal off server fences, so no global barrier is needed.
        """
        assert self.role == NodeRole.SCHEDULER, "set_routing on non-scheduler"
        self.routing = routing
        with self._table_lock:
            targets = [
                n.node_id
                for n in self._table.values()
                if n.alive and n.node_id != self.post.node_id
            ]
        msgs = [
            Message(
                task=Task(
                    TaskKind.CONTROL,
                    self.name,
                    payload={"cmd": ROUTING, "routing": routing.to_payload()},
                ),
                recver=t,
            )
            for t in targets
        ]
        if msgs:
            self.submit(msgs)

    def _on_routing(self, msg: Message) -> None:
        from parameter_server_tpu_torch.kv.routing import RoutingTable

        routing = RoutingTable.from_payload(msg.task.payload["routing"])
        # highest epoch wins — broadcasts can arrive out of order across
        # migrations, and a stale one must not roll a node's view back
        if self.routing is not None and routing.epoch <= self.routing.epoch:
            return
        self.routing = routing
        for cb in self.on_routing:
            try:
                cb(routing)
            except Exception:  # noqa: BLE001 — one bad sink must not block
                logging.getLogger(__name__).exception(
                    "on_routing callback failed on %s", self.post.node_id
                )

    # -- clock sync (heartbeat-RTT/2 offset estimation) ----------------------
    def _on_ping(self, msg: Message) -> Message:
        import numpy as np

        # reply carries the scheduler's monotonic clock reading; the pinger
        # timestamps both legs locally and estimates its offset NTP-style
        return msg.reply(
            values=[np.asarray([time.monotonic()], np.float64)]
        )

    def sync_clock(
        self, samples: int = 5, *, timeout: Optional[float] = 10.0
    ) -> Optional[float]:
        """Estimate this node's clock offset vs the scheduler (seconds).

        Sends ``samples`` PINGs, timestamps both legs locally, and keeps the
        minimum-RTT sample (least queueing noise): with the scheduler's
        reading assumed to land mid-flight, ``offset = midpoint - sched``,
        i.e. LOCAL minus SCHEDULER monotonic time.  The estimate (and the
        winning RTT) ride subsequent heartbeats under ``stats["clock"]`` so
        the fleet monitor (``core/fleet.py``) can correct cross-host
        deliver-latency attribution from ``core/netmon.py`` — node-local
        ``time.monotonic`` clocks share no epoch across processes, so raw
        one-way latencies off loopback are meaningless without this.

        Returns the offset, or None if every ping timed out (the previous
        estimate, if any, is kept).
        """
        best: Optional[tuple[float, float]] = None  # (rtt, offset)
        for _ in range(max(1, samples)):
            t0 = time.monotonic()
            ts = self.submit(
                [
                    Message(
                        task=Task(
                            TaskKind.CONTROL, self.name, payload={"cmd": PING}
                        ),
                        recver=SCHEDULER,
                    )
                ],
                keep_responses=True,
            )
            ok = self.wait(ts, timeout=timeout)
            if not ok:
                self.cancel(ts, "clock ping deadline")
            responses = self.take_responses(ts)
            if not ok or not responses or not responses[0].values:
                continue
            t1 = time.monotonic()
            sched = float(responses[0].values[0][0])
            rtt = t1 - t0
            offset = (t0 + t1) / 2.0 - sched
            if best is None or rtt < best[0]:
                best = (rtt, offset)
        if best is None:
            return None
        self.clock_rtt, self.clock_offset = best
        return self.clock_offset

    # -- barrier (poll-based; replies carry the arrival count) ---------------
    def _on_barrier(self, msg: Message) -> Message:
        import numpy as np

        name = msg.task.payload["name"]
        with self._table_lock:
            arrivals = self._barriers.setdefault(name, set())
            if msg.task.payload.get("enter"):
                arrivals.add(msg.sender)
            if msg.task.payload.get("ack"):
                self._barrier_acks.setdefault(name, set()).add(msg.sender)
            count = len(arrivals)
        return msg.reply(values=[np.asarray([count], np.int64)])

    def barrier(
        self,
        name: str,
        expected: int,
        *,
        timeout: Optional[float] = 60.0,
        poll: float = 0.05,
    ) -> bool:
        """Block until ``expected`` distinct nodes entered barrier ``name``.

        Poll-based (the scheduler cannot defer replies), so it works across
        processes over any Van.  Returns False on timeout.
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        enter = True
        while deadline is None or time.monotonic() < deadline:
            ts = self.submit(
                [
                    Message(
                        task=Task(
                            TaskKind.CONTROL,
                            self.name,
                            payload={"cmd": BARRIER, "name": name, "enter": enter},
                        ),
                        recver=SCHEDULER,
                    )
                ],
                keep_responses=True,
            )
            left = None if deadline is None else max(deadline - time.monotonic(), 0.1)
            ok = self.wait(ts, timeout=left)
            if not ok:
                # deadline while the scheduler is unreachable: finalize the
                # task so _pending/_responses don't leak one entry per
                # timed-out barrier round
                self.cancel(ts, "barrier poll deadline")
            responses = self.take_responses(ts)
            if not ok or not responses:
                return False
            enter = False  # entered; subsequent rounds just poll
            if int(responses[0].values[0][0]) >= expected:
                # fire-and-forget ack so the scheduler can barrier_drain:
                # it must outlive every participant still polling
                self.submit(
                    [
                        Message(
                            task=Task(
                                TaskKind.CONTROL,
                                self.name,
                                payload={"cmd": BARRIER, "name": name, "ack": True},
                            ),
                            recver=SCHEDULER,
                        )
                    ]
                )
                return True
            time.sleep(poll)
        return False

    def barrier_drain(
        self,
        name: str,
        expected: int,
        *,
        timeout: Optional[float] = 60.0,
        poll: float = 0.05,
    ) -> bool:
        """Scheduler: block until ``expected`` nodes ACKED barrier ``name``.

        Call after :meth:`barrier` and before process exit — otherwise the
        scheduler can die while a slow participant is still polling, and
        that participant hangs until its own timeout (the classic
        last-observer race).
        """
        deadline = None if timeout is None else time.monotonic() + timeout
        while deadline is None or time.monotonic() < deadline:
            with self._table_lock:
                n = len(self._barrier_acks.get(name, ()))
            if n >= expected:
                return True
            time.sleep(poll)
        return False

    def _on_register(self, msg: Message) -> None:
        assert self.role == NodeRole.SCHEDULER, "REGISTER sent to non-scheduler"
        addr = msg.task.payload.get("address")
        if addr and hasattr(self.post.van, "add_route"):
            self.post.van.add_route(msg.sender, tuple(addr))
        rejoin_row = None
        with self._table_lock:
            existing = self._table.get(msg.sender)
            if existing is not None:
                # Same-id restart: the scheduler is the incarnation
                # authority.  Bump the epoch, keep the assigned key range
                # (a restarted server still owns its shard), mark alive.
                existing.incarnation += 1
                existing.alive = True
                existing.last_seen = time.monotonic()
                if addr:
                    existing.address = list(addr)
                rejoin_row = dataclasses.asdict(existing)
                table_rows = [
                    dataclasses.asdict(n) for n in self._table.values()
                ]
                peers = [
                    n.node_id
                    for n in self._table.values()
                    if n.alive
                    and n.node_id not in (self.post.node_id, msg.sender)
                ]
            else:
                info = NodeInfo(
                    msg.sender, NodeRole(msg.task.payload["role"]),
                    last_seen=time.monotonic(),
                    address=addr,
                )
                self._table[msg.sender] = info
                workers = sum(
                    1 for n in self._table.values() if n.role == NodeRole.WORKER
                )
                servers = sum(
                    1 for n in self._table.values() if n.role == NodeRole.SERVER
                )
                complete = (
                    workers >= self.num_workers and servers >= self.num_servers
                )
                if complete:
                    ranges = self.assigner.ranges(self.num_servers)
                    sids = sorted(
                        n.node_id
                        for n in self._table.values()
                        if n.role == NodeRole.SERVER
                    )
                    for sid, (b, e) in zip(sids, ranges):
                        self._table[sid].range_begin = b
                        self._table[sid].range_end = e
                table_rows = [
                    dataclasses.asdict(n) for n in self._table.values()
                ]
        if rejoin_row is not None:
            # Fence first (locally), so any zombie frames still in flight
            # under the old incarnation die at this endpoint too; then tell
            # the fleet: peers get the one changed row, the restarted node
            # gets the full table (it lost its copy with its memory).
            self._learn_incarnation(msg.sender, rejoin_row["incarnation"])
            self._broadcast_table(table_rows, [msg.sender])
            if peers:
                self._broadcast_table([rejoin_row], peers)
            for cb in self.on_node_added:
                cb(msg.sender)
            return
        if complete:
            self._broadcast_table(table_rows)
            self._ready.set()

    def _learn_incarnation(self, node_id: str, incarnation: int) -> None:
        """Teach the local transport stack a node's incarnation.

        Hasattr-guarded: delegates down the Van decorator chain to
        ``ReliableVan.set_incarnation`` when one is present (a bare
        LoopbackVan stack simply has no fencing to update).  Idempotent —
        the registry only ever advances.
        """
        if incarnation and hasattr(self.post.van, "set_incarnation"):
            self.post.van.set_incarnation(node_id, incarnation)

    def _broadcast_table(
        self, rows: list[dict], targets: Optional[list[str]] = None
    ) -> None:
        if targets is None:
            targets = [r["node_id"] for r in rows if r["node_id"] != SCHEDULER]
        msgs = [
            Message(
                task=Task(
                    TaskKind.CONTROL,
                    self.name,
                    payload={"cmd": ADD_NODE, "table": rows},
                ),
                recver=t,
            )
            for t in targets
        ]
        if msgs:
            self.submit(msgs)

    def _on_add_node(self, msg: Message) -> None:
        learned: list[tuple[str, int]] = []
        with self._table_lock:
            for row in msg.task.payload["table"]:
                row = dict(row)
                row["role"] = NodeRole(row["role"])
                info = NodeInfo(**row)
                self._table[info.node_id] = info
                if info.incarnation:
                    learned.append((info.node_id, info.incarnation))
                # multi-process: learn routes to every peer from the table
                if (
                    info.address
                    and info.node_id != self.post.node_id
                    and hasattr(self.post.van, "add_route")
                ):
                    self.post.van.add_route(info.node_id, tuple(info.address))
        # outside the table lock: fence stale incarnations at this endpoint
        # (and arm this node's own stamp if the row is about itself)
        for node_id, inc in learned:
            self._learn_incarnation(node_id, inc)
        for cb in self.on_node_added:
            for row in msg.task.payload["table"]:
                cb(row["node_id"] if isinstance(row, dict) else row.node_id)
        self._ready.set()

    def _on_remove_node(self, msg: Message) -> None:
        dead = msg.task.payload["node_id"]
        with self._table_lock:
            if dead in self._table:
                self._table[dead].alive = False
        for cb in self.on_node_dead:
            cb(dead)

    def _on_heartbeat(self, msg: Message) -> None:
        fleet = self.fleet
        if fleet is not None:
            try:
                fleet.observe(msg.sender, msg.task.payload.get("stats") or {})
            except Exception:  # noqa: BLE001 — monitoring must never break
                # liveness handling (a malformed stats dict is not a death)
                logging.getLogger(__name__).exception(
                    "fleet: bad heartbeat stats from %s", msg.sender
                )
        recovered = None
        with self._table_lock:
            n = self._table.get(msg.sender)
            if n is not None:
                n.last_seen = time.monotonic()
                if not n.alive:
                    n.alive = True
                    recovered = dataclasses.asdict(n)
        if recovered is not None and self.role == NodeRole.SCHEDULER:
            # Re-join: peers learned REMOVE_NODE, so re-broadcast the row to
            # everyone and fire the add callbacks (ADD_NODE-on-recovery).
            with self._table_lock:
                targets = [
                    n.node_id
                    for n in self._table.values()
                    if n.alive and n.node_id != self.post.node_id
                ]
            self._broadcast_table([recovered], targets)
            for cb in self.on_node_added:
                cb(msg.sender)

    # -- live telemetry ------------------------------------------------------
    def _on_telemetry(self, msg: Message) -> None:
        """Scheduler: fold one TELEMETRY frame into the aggregator.

        Guarded like ``_on_heartbeat`` — a malformed frame must never break
        the CONTROL plane.  The reply (sent by ``handle_request`` after this
        returns) therefore doubles as an ingest ack: a publisher that
        ``wait()``s on its TELEMETRY ts knows the scheduler has evaluated.
        """
        agg = self.telemetry
        if agg is None:
            return
        try:
            agg.ingest(msg.sender, msg.task.payload.get("frame") or {})
        except Exception:  # noqa: BLE001 — telemetry must never break CONTROL
            logging.getLogger(__name__).exception(
                "telemetry: bad frame from %s", msg.sender
            )

    def publish_telemetry(self) -> Optional[int]:
        """Non-scheduler: build and send one telemetry frame.

        Returns the submit ts (``wait()`` on it to block until the
        scheduler has ingested + evaluated), or None when no publisher is
        attached or frame construction failed — telemetry never raises into
        the training loop.
        """
        pub = self.telemetry_pub
        if pub is None:
            return None
        try:
            frame = pub.frame()
        except Exception:  # noqa: BLE001 — a broken stat source must not
            # cost the caller (frame building walks user-attached sources)
            logging.getLogger(__name__).exception(
                "telemetry: frame build failed on %s", self.post.node_id
            )
            return None
        return self.submit(
            [
                Message(
                    task=Task(
                        TaskKind.CONTROL,
                        self.name,
                        payload={"cmd": TELEMETRY, "frame": frame},
                    ),
                    recver=SCHEDULER,
                )
            ]
        )

    # -- heartbeats / failure detection --------------------------------------
    def send_heartbeat(
        self, stats: Optional[dict] = None, *, auto: bool = True
    ) -> int:
        """Non-scheduler: report liveness + observability stats.

        ``auto=True`` (default) attaches what the reference carried in
        ``heartbeat_info.h`` [U] and what the scheduler's
        :class:`~parameter_server_tpu_torch.core.fleet.FleetMonitor` consumes:
        ``resource`` (:func:`~parameter_server_tpu_torch.utils.trace.resource_usage`),
        ``net`` (cumulative :func:`~parameter_server_tpu_torch.utils.metrics.transport_counters`
        of this node's Van stack), and ``links`` (per-link wire digests from
        a :class:`~parameter_server_tpu_torch.core.netmon.MeteredVan`, when one is
        in the stack).  Caller-provided ``stats`` keys win (``setdefault``);
        ``auto=False`` sends a bare liveness ping.  Stat collection failures
        are swallowed — metrics must never cost a heartbeat.
        """
        payload_stats = dict(stats or {})
        if auto:
            try:
                from parameter_server_tpu_torch.core.netmon import find_metered
                from parameter_server_tpu_torch.utils.metrics import (
                    transport_counters,
                )
                from parameter_server_tpu_torch.utils.trace import resource_usage

                payload_stats.setdefault("resource", resource_usage())
                payload_stats.setdefault(
                    "net", transport_counters(self.post.van)
                )
                if self.clock_offset is not None:
                    payload_stats.setdefault(
                        "clock",
                        {
                            "offset_s": self.clock_offset,
                            "rtt_s": self.clock_rtt,
                        },
                    )
                metered = find_metered(self.post.van)
                if metered is not None:
                    payload_stats.setdefault(
                        "links", metered.node_digests(self.post.node_id)
                    )
            except Exception:  # noqa: BLE001 — liveness > observability
                logging.getLogger(__name__).exception(
                    "heartbeat: stat collection failed on %s",
                    self.post.node_id,
                )
        ts = self.submit(
            [
                Message(
                    task=Task(
                        TaskKind.CONTROL,
                        self.name,
                        payload={"cmd": HEARTBEAT, "stats": payload_stats},
                    ),
                    recver=SCHEDULER,
                )
            ]
        )
        # telemetry rides the heartbeat cadence: the beat is submitted first
        # so the scheduler's FleetMonitor has seen this node (clock offset,
        # straggler state) before the frame is rebased against it
        if self.telemetry_pub is not None:
            self.publish_telemetry()
        return ts

    def check_heartbeats(self) -> List[str]:
        """Scheduler: mark nodes silent past the timeout dead; broadcast.

        Returns newly dead node ids.  Called from the monitor thread or
        directly by tests (deterministic failure injection).
        """
        now = time.monotonic()
        newly_dead: List[str] = []
        with self._table_lock:
            for n in self._table.values():
                if n.node_id == self.post.node_id or not n.alive:
                    continue
                if now - n.last_seen > self.heartbeat_timeout:
                    n.alive = False
                    newly_dead.append(n.node_id)
            live_targets = [
                n.node_id
                for n in self._table.values()
                if n.alive and n.node_id != self.post.node_id
            ]
        for dead in newly_dead:
            for cb in self.on_node_dead:
                cb(dead)
            msgs = [
                Message(
                    task=Task(
                        TaskKind.CONTROL,
                        self.name,
                        payload={"cmd": REMOVE_NODE, "node_id": dead},
                    ),
                    recver=t,
                )
                for t in live_targets
            ]
            if msgs:
                self.submit(msgs)
        return newly_dead

    def start_monitor(self, interval: float = 1.0) -> None:
        """Scheduler: poll heartbeats in a daemon thread."""
        self._stop.clear()  # allow start after a previous stop_monitor

        def loop() -> None:
            while not self._stop.wait(interval):
                self.check_heartbeats()

        self._monitor_thread = threading.Thread(
            target=loop, name="manager-monitor", daemon=True
        )
        self._monitor_thread.start()

    def stop_monitor(self) -> None:
        self._stop.set()
        if self._monitor_thread is not None:
            self._monitor_thread.join(timeout=5)
            self._monitor_thread = None


def launch_local_cluster(
    van,
    *,
    num_workers: int,
    num_servers: int,
    key_space: int = 1 << 20,
    heartbeat_timeout: float = 5.0,
) -> tuple[Manager, Dict[str, Manager], Dict[str, Postoffice]]:
    """Spin up scheduler + N servers + M workers on one Van (local sim).

    This is the ``script/local.sh`` analogue for in-process tests: every node
    gets its own Postoffice + Manager, workers/servers register, and the call
    returns once the scheduler has broadcast the node table.
    """
    posts: Dict[str, Postoffice] = {}
    managers: Dict[str, Manager] = {}

    def make(node_id: str) -> Manager:
        post = Postoffice(node_id, van)
        posts[node_id] = post
        mgr = Manager(
            post,
            num_workers=num_workers,
            num_servers=num_servers,
            key_space=key_space,
            heartbeat_timeout=heartbeat_timeout,
        )
        managers[node_id] = mgr
        return mgr

    sched = make(SCHEDULER)
    for i in range(num_servers):
        make(server_id(i))
    for i in range(num_workers):
        make(worker_id(i))
    for nid, mgr in managers.items():
        if nid != SCHEDULER:
            mgr.register_with_scheduler(wait=False)
    for nid, mgr in managers.items():
        if not mgr.wait_ready(timeout=30):
            raise TimeoutError(f"node {nid} never saw the table broadcast")
    return sched, managers, posts
