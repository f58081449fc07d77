"""FlightRecorder: per-node black-box event journal + postmortem bundles.

A copy of ``parameter_server_tpu/core/flightrec.py`` (stdlib only; the port
imports nothing of the JAX package), so both packages journal the same event
kinds and write bundles that ``tools/postmortem.py`` merges unchanged.  The
port records from the transport (``core/van.py`` receive-thread exceptions,
``core/postoffice.py`` cancellation drops, ``core/coalesce.py`` bundle
flushes), the server's routing fence, the apply ledger (``kv/ledger.py``),
the sampled request-tracing plane (``kv/worker.py``, ``kv/server.py``), the
telemetry plane and the war game.  ``_walk_counters`` / ``_find_metered``
walk a van stack as the JAX module does.

This module is the black box: a bounded ring of structured,
monotonic-stamped events recorded from every interesting transport and KV
lifecycle transition (frame send/recv/reject, retransmit/dedup/gave-up,
incarnation and routing fences, migration ops, restarts, cancels, SLO
breaches), cheap enough to leave on in production.

Cost model: one :func:`record` call is a dict build plus a GIL-atomic
``deque.append`` — no lock, no I/O, no formatting (~1 us).  The ring is
bounded (default 4096 events), so a run that never crashes pays a fixed
memory ceiling and zero disk.

When something DOES go wrong — a recv-thread exception
(``core/van.py::_Endpoint._recv_loop``), a failing chaos test (conftest
hook), or an explicit :func:`dump` — the ring is split per node and written
as a **postmortem bundle**: one JSON file per node carrying its events,
wall/monotonic clock anchors, optional min-RTT clock offset
(``FleetMonitor.clock_offset``), transport counters, fleet snapshot, and
per-link histogram digests.  ``tools/postmortem.py`` merges bundles from
many processes into one causal, clock-rebased timeline.

Event kinds are closed over :data:`EVENTS`; ``tools/check_wrappers.py``
enforces by AST that every ``flightrec.record("<kind>", ...)`` call site
uses a literal kind from this registry, so the taxonomy cannot drift
stringly-typed.
"""

from __future__ import annotations

import collections
import itertools
import json
import os
import threading
import time
from typing import Any, Dict, List, Optional

#: Closed event-kind registry.  ``tools/check_wrappers.py`` parses this
#: frozenset LITERAL by AST (no import), so keep it a plain frozenset of
#: plain string constants — no comprehensions, no concatenation.
EVENTS = frozenset({
    # transport: one logical message crossing the metered boundary
    "frame.send",
    "frame.recv",
    # transport: wire-level rejects (CRC / undecodable / unframeable)
    "frame.reject",
    # transport v2 backpressure (core/tcp_van.py): a colocated shm ring
    # refusing a frame (degraded to TCP or dropped for retransmit) and the
    # epoll backend's bounded per-conn write queue refusing a vectored send
    "net.ring_full",
    "net.writeq_full",
    # reliable delivery (core/resender.py)
    "resend.retransmit",
    "resend.dup",
    "resend.gave_up",
    # fences: stale-incarnation frames (resender) and wrong-owner /
    # stale-epoch requests (kv/server.py)
    "fence.incarnation",
    "fence.routing",
    "incarnation.advance",
    # coalescing (core/coalesce.py)
    "bundle.flush",
    # chaos injection (core/chaos.py) — fault name rides in fields
    "chaos.inject",
    # migration protocol (kv/server.py coordinating side + kv/migrate.py)
    "migrate.begin",
    "migrate.send",
    "migrate.stage",
    "migrate.commit",
    "migrate.install",
    "migrate.adopt",
    "migrate.release",
    "migrate.abort",
    # node lifecycle (kv/replica.py)
    "node.restart",
    "node.promote",
    # cancellation fences (core/postoffice.py)
    "cancel.drop",
    # recv-thread handler exception (core/van.py)
    "recv.exception",
    # SLO engine verdict transitions (utils/slo.py)
    "slo.breach",
    "slo.clear",
    # bundle written (self-describing marker, last event in a bundle)
    "postmortem.dump",
    # live telemetry plane (core/telemetry.py): frame published by a node /
    # duplicate-seq frame dropped by the scheduler's aggregator
    "telemetry.publish",
    "telemetry.drop",
    # device-plane apply ledger (kv/ledger.py): an in-flight device apply
    # registered at dispatch / retired by the reaper once the donated
    # buffers are ready / backlog bound crossed (edge-triggered both ways,
    # state field says which)
    "apply.submit",
    "apply.done",
    "apply.backlog",
    # read-heavy serving plane (kv/cache.py, serve/admission.py):
    # hot-row cache hit / miss (per serving request, n = row count),
    # cache entries dropped (watermark advance, routing-epoch adoption),
    # read traffic shed or deferred by admission control
    "cache.hit",
    "cache.miss",
    "cache.invalidate",
    "serve.shed",
    # quantized wire plane (core/filters.py QuantizingFilter): a frame's
    # value planes lossily encoded at flush / dequantized before dispatch /
    # error-feedback residual stores dropped (reason field says which
    # lifecycle edge: adopt_routing, incarnation_advance, send_failed)
    "compress.encode",
    "compress.decode",
    "compress.residual_reset",
    # hierarchical push (kv/worker.py group path + core/coalesce.py
    # GroupReducer): a group's value planes pre-reduced before the wire /
    # a leader elected for (table, step) (salt > 0 marks a fence
    # re-election) / the group degraded to direct per-worker push (reason
    # field says why: member_timeout, leader_timeout, dead_leader,
    # stale_set, wire_done_error)
    "group.reduce",
    "group.elect",
    "group.fallback",
    # durability plane (checkpoint.py + kv/server.py snapshot
    # ops): snapshot window armed / one segment file written (or carried
    # forward unchanged) / dirty-delta exported under the commit freeze /
    # a shard restored from a partitioned snapshot / a snapshot window
    # torn down without committing (server death, routing change mid-
    # snapshot, coordinator abort — the postmortem anomaly anchor)
    "ckpt.begin",
    "ckpt.segment",
    "ckpt.commit",
    "ckpt.restore",
    "ckpt.abort",
    # sampled request-tracing plane (core/tracectx.py): every
    # kind below fires ONLY for hash-sampled requests (the gate
    # tools/check_wrappers.py enforces).  submit = worker stamped a trace
    # ctx and handed the request to the van; wire_tx/wire_rx = the frame
    # crossed the per-conn choke point / was decoded off the wire (TCP or
    # shm ring alike); bundle = a coalesced frame fanned its members'
    # contexts back out; dispatch/reply = server handler entry / reply
    # built (verdict ok|fenced); apply = ApplyLedger retired the bundle
    # (host/h2d/device attribution); ack = the reply closed the span tree
    # back on the worker (tools/postmortem.py anchors on its absence);
    # retransmit = the resender re-sent a sampled frame
    "trace.submit",
    "trace.wire_tx",
    "trace.wire_rx",
    "trace.bundle",
    "trace.dispatch",
    "trace.reply",
    "trace.apply",
    "trace.ack",
    "trace.retransmit",
    # war-game plane: begin/end bracket a scenario run; phase =
    # a load phase became current; inject = a fault (gray failure,
    # partition, restart wave) landed — an ANOMALY kind, so postmortems
    # anchor on the injection that preceded the breach; heal = a fault was
    # lifted; action = the autoscaler/runner acted (scale_up, drain_down,
    # rebalance) on live telemetry
    "scenario.begin",
    "scenario.phase",
    "scenario.inject",
    "scenario.heal",
    "scenario.action",
    "scenario.end",
    # consistency plane (kv/server.py gate + kv/worker.py retry
    # loops): gate = a sender's FIRST ``__wait__`` defer on a gated table
    # (retries in between stay silent); release = that sender admitted
    # again — a gate with no later release is the wedged-fleet postmortem
    # anomaly anchor; shed = the gate deadline degraded a request (pull
    # shed to the stale cache or forced through ungated, push forced —
    # never dropped; how= says which); retune = the BoundTuner (or an
    # operator / scenario phase) changed a table's live mode/bound
    "consist.gate",
    "consist.release",
    "consist.shed",
    "consist.retune",
})

#: env var: when set, recv-thread exceptions auto-dump a bundle here.
DUMP_DIR_ENV = "PS_FLIGHTREC_DIR"


class FlightRecorder:
    """Bounded ring of ``(seq, t_mono, kind, fields)`` events.

    Lock-cheap by design: appends are GIL-atomic ``deque.append`` calls and
    the monotonically increasing ``seq`` (``itertools.count``) breaks ties
    between events sharing a clock tick.  Reads (:meth:`events`,
    :meth:`dump`) snapshot via ``list(deque)`` which is likewise safe — a
    concurrent append can only make the snapshot one event stale, never
    corrupt it.
    """

    def __init__(self, *, capacity: int = 4096, node: Optional[str] = None,
                 enabled: bool = True) -> None:
        self._ring: "collections.deque[tuple]" = collections.deque(
            maxlen=capacity
        )
        self._seq = itertools.count()
        self.node = node
        self.enabled = enabled
        #: paired wall/monotonic anchors captured together at construction:
        #: ``wall_anchor_s + (t_mono - mono_anchor_s)`` rebases any event
        #: stamp onto the wall clock (the merge_traces.py ``clock_t0_s``
        #: pattern, but for events instead of chrome spans).
        self.wall_anchor_s = time.time()
        self.mono_anchor_s = time.monotonic()
        #: this process's monotonic clock minus the reference (scheduler)
        #: clock, from the min-RTT sync (``FleetMonitor.clock_offset``);
        #: subtracted by the postmortem merger to line up cross-host events.
        self.clock_offset_s = 0.0

    def record(self, kind: str, **fields: Any) -> None:
        """Append one event.  ``kind`` MUST be a literal from :data:`EVENTS`
        at every call site (AST-enforced); ``fields`` are free-form but must
        stay JSON-safe scalars (they are dumped verbatim into bundles)."""
        if not self.enabled:
            return
        self._ring.append(
            (next(self._seq), time.monotonic(), kind, fields)
        )

    def events(self) -> List[dict]:
        """JSON-safe copies of the current ring, oldest first."""
        return [
            {"seq": seq, "t_mono_s": t, "kind": kind, **fields}
            for seq, t, kind, fields in list(self._ring)
        ]

    def events_since(self, seq: int) -> List[dict]:
        """Events with ``seq`` strictly greater than the watermark, oldest
        first — the telemetry publisher's incremental scan.  Walks the ring
        from the newest end and stops at the watermark, so a steady-state
        caller pays O(new events), not O(capacity).  Iterates the live deque
        (no snapshot copy); a concurrent append invalidates the iterator, in
        which case the scan retries once against a snapshot."""
        out: List[dict] = []
        try:
            for s, t, kind, fields in reversed(self._ring):
                if s <= seq:
                    break
                out.append({"seq": s, "t_mono_s": t, "kind": kind, **fields})
        except RuntimeError:  # ring mutated mid-scan
            out = []
            for s, t, kind, fields in reversed(list(self._ring)):
                if s <= seq:
                    break
                out.append({"seq": s, "t_mono_s": t, "kind": kind, **fields})
        out.reverse()
        return out

    def clear(self) -> None:
        self._ring.clear()

    def __len__(self) -> int:
        return len(self._ring)

    # -- bundles -------------------------------------------------------------
    def dump(
        self,
        out_dir: str,
        *,
        counters: Optional[Dict[str, Any]] = None,
        fleet=None,
        van=None,
        reason: str = "explicit",
    ) -> List[str]:
        """Write postmortem bundle files under ``out_dir``; returns paths.

        The ring is split by each event's ``node`` field (events recorded
        without one land in the ``_process`` bundle) so a single-process
        cluster — the test topology — still yields the per-node bundle
        layout that ``tools/postmortem.py`` merges.  Alongside the events,
        each bundle carries whatever context the caller can supply:

        - ``counters``: any counter dict (e.g. ``transport_counters(van)``
          output, or a server's ``counters()``);
        - ``van``: a Van stack — its ``.inner`` chain is walked for layer
          ``counters()`` and the first MeteredVan's per-link digests;
        - ``fleet``: a FleetMonitor — snapshot + straggler flags ride along,
          its JSONL sink is flushed first (the no-truncated-last-line
          guarantee), and per-node min-RTT clock offsets are embedded so
          the merger can rebase cross-host rings.
        """
        os.makedirs(out_dir, exist_ok=True)
        self.record("postmortem.dump", reason=reason, dir=out_dir)
        events = self.events()

        stack_counters: Dict[str, Any] = {}
        link_digests: Optional[dict] = None
        if van is not None:
            stack_counters = _walk_counters(van)
            metered = _find_metered(van)
            if metered is not None:
                link_digests = metered.links()
        if counters:
            stack_counters.update(counters)

        fleet_snapshot = None
        fleet_offsets: Dict[str, float] = {}
        if fleet is not None:
            fleet.flush_jsonl()
            fleet_snapshot = {
                "nodes": fleet.snapshot(),
                "stragglers": fleet.stragglers(),
            }
            for node_id in fleet.nodes():
                off = fleet.clock_offset(node_id)
                if off is not None:
                    fleet_offsets[node_id] = off

        by_node: Dict[str, List[dict]] = {}
        for ev in events:
            by_node.setdefault(
                str(ev.get("node") or self.node or "_process"), []
            ).append(ev)

        paths = []
        for node_id, evs in sorted(by_node.items()):
            bundle = {
                "node": node_id,
                "pid": os.getpid(),
                "reason": reason,
                "wall_anchor_s": self.wall_anchor_s,
                "mono_anchor_s": self.mono_anchor_s,
                "clock_offset_s": fleet_offsets.get(
                    node_id, self.clock_offset_s
                ),
                "events": evs,
                "counters": stack_counters,
                "fleet": fleet_snapshot,
                "histograms": link_digests,
            }
            path = os.path.join(
                out_dir, f"flightrec_{_safe_name(node_id)}.json"
            )
            with open(path, "w") as f:
                json.dump(bundle, f)
                f.flush()
                os.fsync(f.fileno())
            paths.append(path)
        return paths


def _safe_name(node_id: str) -> str:
    return "".join(c if c.isalnum() or c in "._-" else "_" for c in node_id)


def _walk_counters(van) -> Dict[str, Any]:
    """Sum ``counters()`` over a Van wrapper stack (``.inner`` walk).

    Local re-implementation of ``utils.metrics.transport_counters`` to keep
    core/ free of a utils.metrics import (metrics imports core modules)."""
    totals: Dict[str, Any] = {}
    seen = set()
    v = van
    while v is not None and id(v) not in seen:
        seen.add(id(v))
        c = getattr(v, "counters", None)
        if callable(c):
            for k, val in c().items():
                if isinstance(val, (int, float)):
                    totals[k] = totals.get(k, 0) + val
        v = getattr(v, "inner", None)
    return totals


def _find_metered(van):
    """First wrapper exposing per-link digests (``links()``), or None."""
    seen = set()
    v = van
    while v is not None and id(v) not in seen:
        seen.add(id(v))
        if callable(getattr(v, "links", None)):
            return v
        v = getattr(v, "inner", None)
    return None


# -- module-level default recorder -------------------------------------------
#
# A process hosts many logical nodes in the test topology, so the canonical
# call-site convention is the MODULE function ``flightrec.record(kind,
# node=..., ...)`` against one shared per-process ring: every component
# stamps the node it acts for, and ``dump()`` splits per node.  The module
# indirection is also what makes the AST contract checkable — call sites are
# statically recognizable as ``flightrec.record(...)`` without executing
# anything.

_default = FlightRecorder()
_dump_lock = threading.Lock()


def get() -> FlightRecorder:
    """The process-wide default recorder."""
    return _default


def record(kind: str, **fields: Any) -> None:
    """Record one event on the default recorder (the canonical call form)."""
    _default.record(kind, **fields)


def configure(
    *,
    capacity: Optional[int] = None,
    enabled: Optional[bool] = None,
    clear: bool = False,
) -> FlightRecorder:
    """Adjust the default recorder in place (tests, bench overhead guard)."""
    global _default
    if capacity is not None and capacity != _default._ring.maxlen:
        fresh = FlightRecorder(
            capacity=capacity, node=_default.node, enabled=_default.enabled
        )
        fresh._ring.extend(_default._ring)
        fresh.clock_offset_s = _default.clock_offset_s
        _default = fresh
    if enabled is not None:
        _default.enabled = enabled
    if clear:
        _default.clear()
    return _default


def dump(out_dir: str, **kwargs: Any) -> List[str]:
    """Dump the default recorder's bundle (see :meth:`FlightRecorder.dump`).

    Serialized under a lock so concurrent failure triggers (two recv
    threads dying at once) produce whole files, not interleaved writes.
    """
    with _dump_lock:
        return _default.dump(out_dir, **kwargs)


def on_recv_exception(node_id: str, exc: BaseException) -> None:
    """Failure trigger wired into ``_Endpoint._recv_loop``: journal the
    handler exception and, when :data:`DUMP_DIR_ENV` names a directory,
    write a bundle there immediately — the thread survives, but the ring
    near the failure is captured before it wraps."""
    record(
        "recv.exception",
        node=node_id,
        exc_type=type(exc).__name__,
        exc=str(exc)[:200],
    )
    out_dir = os.environ.get(DUMP_DIR_ENV)
    if out_dir:
        try:
            dump(out_dir, reason=f"recv-exception:{node_id}")
        except OSError:
            pass


def anomaly_kinds() -> frozenset:
    """Event kinds the postmortem report treats as anomalies (shared with
    ``tools/postmortem.py`` so the CLI and the library agree)."""
    return frozenset({
        "frame.reject",
        "resend.gave_up",
        "fence.incarnation",
        "fence.routing",
        "node.restart",
        "migrate.abort",
        "recv.exception",
        "slo.breach",
        "apply.backlog",
        "serve.shed",
        "group.fallback",
        "ckpt.abort",
        "scenario.inject",
        "consist.shed",
    })
