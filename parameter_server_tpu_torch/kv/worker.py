"""KVWorker: the classic Push/Pull facade with timestamps.

Torch counterpart of ``parameter_server_tpu/kv/worker.py``: ``push`` /
``pull`` return an integer timestamp, ``wait(ts)`` blocks, pulls deliver
values aligned with the request's key positions.

Pipeline per call:

1. host: ``localize_to_slots`` — dedup keys, map to unique row slots
   (deterministic ``HashLocalizer``, so every worker agrees).
2. device: ``segment_combine`` of duplicate positions (push only), read back
   to numpy for the wire — one device op and one synchronisation per push.
   With a :class:`~parameter_server_tpu_torch.kv.routing.WorkerGroup` this
   is where the group pre-reduction hangs: members hand their combined
   planes to the elected leader, which reduces them on the host
   (:class:`~parameter_server_tpu_torch.core.coalesce.GroupReducer`), so
   one reduced tensor crosses the wire per group per step.
3. host: ``RoutingTable.slice_ids`` — one request per owning server, stamped
   with the routing epoch.
4. Van: responses complete the timestamp; pull replies are numpy (tensors
   from a ``device_replies`` server) and are reassembled on the host, or on
   ``device`` by :meth:`pull_result_device`.

The sync paths (``push_sync``, ``pull_result``) loop over replies:

- routing fences (``__fenced__``): adopt the highest-epoch table the reply
  carries and re-submit ONLY the fenced positions, with linear backoff, up
  to ``max_fence_retries``;
- consistency defers (``__wait__``, on tables whose
  ``TableConfig.consistency`` is set): re-submit the waited positions on the
  gate's own budget (``gate_deadline_s``, honouring ``retry_after``); past
  the deadline the remainder is forced through ungated — counted
  (``consist_forced``), never dropped.  A fully acked ``push_sync`` commits
  this worker's step for the table: the ``__cstep__`` its later gated
  requests stamp;
- deadlines: a stuck task is cancelled (remotely too) and re-issued once
  against the same server ids (``retry_on_timeout``).

``coalesce_window`` / ``push_many`` bundle a burst of sends per server when
the van stack has a ``CoalescingVan`` (a no-op otherwise).  Every reply is
tapped for the server's ``__busy__`` backpressure hint (``server_busy``) and
its ``__sver__`` version stamp (``staleness_digests``; with a hot-row cache
it also raises the cache's invalidation watermark, fence rejects included).

The serving plane: with a :class:`~parameter_server_tpu_torch.kv.cache.
HotRowCache` the worker serves reads (:meth:`pull_serve`: cache first, the
misses as read-only ``__ro__`` pulls, which are never gated;
:meth:`pull_stale`: the cache regardless of freshness).  A gated pull held
past the gate deadline sheds to the stale cache when it covers the waited
rows (``consist_sheds``), else it is forced through.

The durability plane: :meth:`save_model` / :meth:`load_model` broadcast the
legacy uniform checkpoint ops and commit its manifest; :meth:`save_snapshot`
drives a partitioned incremental snapshot (begin, one write per segment,
commit, then the CRC-armored manifest) over any routing layout, and
:meth:`load_snapshot` restores one onto the current fleet, whatever its
shape.

Sampled request tracing: with ``trace=TraceConfig(...)`` a PUSH/PULL whose
hashed id falls in the 1-in-N sample stamps a trace context
(``core/tracectx.py``) into the payload of every wire leg; the server
echoes it back on each ack, and the last leg's ack closes the request's
span tree (``trace_samples`` / ``trace_closed``, the ``trace.e2e`` digest
of :meth:`latency_digests`, the ``trace.submit`` / ``trace.ack`` flight
events ``tools/critpath.py`` stitches).  An unsampled request carries no
``__trace__`` key at all.  ``tracer=`` records the host spans ``kv.push``,
``kv.pull.wait`` and ``kv.pull_serve`` (host time: a push's span ends when
its legs are submitted, not when the card applied them).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
import threading
import time
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch import checkpoint
from parameter_server_tpu_torch.config import GroupConfig, TableConfig, TraceConfig
from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.coalesce import GroupReducer
from parameter_server_tpu_torch.core.filters import find_quantizers
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind, server_id
from parameter_server_tpu_torch.core.postoffice import Customer, Postoffice
from parameter_server_tpu_torch.core.tracectx import TRACE_KEY, sampled
from parameter_server_tpu_torch.kv.cache import HotRowCache
from parameter_server_tpu_torch.kv.routing import (
    BUSY_KEY,
    CONSIST_STEP_KEY,
    FENCED_KEY,
    GROUP_KEY,
    READ_ONLY_KEY,
    ROUTING_EPOCH_KEY,
    ROUTING_KEY,
    VERSION_KEY,
    WAIT_KEY,
    RoutingTable,
    WorkerGroup,
)
from parameter_server_tpu_torch.ops import scatter
from parameter_server_tpu_torch.utils.keys import (
    HashLocalizer,
    localize_to_slots,
    localizer_meta,
)
from parameter_server_tpu_torch.utils.trace import NULL_TRACER, LatencyHistogram, Tracer


class KVWorker(Customer):
    def __init__(
        self,
        post: Postoffice,
        table_cfgs: Dict[str, TableConfig],
        num_servers: int,
        *,
        name: str = "kv",
        localizers: Optional[Dict[str, HashLocalizer]] = None,
        min_bucket: int = 256,
        tracer: Tracer = NULL_TRACER,
        retry_on_timeout: bool = True,
        routing: Optional[RoutingTable] = None,
        max_fence_retries: int = 8,
        fence_backoff: float = 0.02,
        cache: Optional[HotRowCache] = None,
        group: Optional[WorkerGroup] = None,
        group_cfg: Optional[GroupConfig] = None,
        trace: Optional[TraceConfig] = None,
        device: str | torch.device = "cuda",
    ) -> None:
        """``device`` is where the push pre-combine runs and where
        :meth:`pull_result_device` assembles rows.

        ``tracer``: host span recorder (push / pull latency histograms).
        ``trace``: the request-tracing sample policy (default
        ``TraceConfig()``: 1 in 1024); unsampled requests carry no trace
        context.

        ``retry_on_timeout``: a pull or sync push whose deadline expires is
        cancelled (remotely too) and re-issued once against the same server
        ids.  ``routing``: initial routing table (default: the uniform
        epoch-0 split); newer tables are adopted off fence replies
        (:meth:`adopt_routing`).

        ``cache``: a :class:`~parameter_server_tpu_torch.kv.cache.HotRowCache`
        turns this worker into a serving node: :meth:`pull_serve` answers hot
        keys locally, every stamped reply refreshes the cache's invalidation
        watermark, and routing adoption drops all entries.

        ``group``: the :class:`~parameter_server_tpu_torch.kv.routing.
        WorkerGroup` this worker belongs to.  Pushes then pre-reduce across
        the group and only the elected leader's reduced tensor crosses the
        wire.  ``group_cfg`` tunes fallback and reduction (default: a
        ``GroupConfig`` matched to the group's size and election)."""
        super().__init__(name, post)
        self.device = torch.device(device)
        #: host-side span recorder (push / pull latency histograms)
        self.tracer = tracer
        self.table_cfgs = table_cfgs
        self.num_servers = num_servers
        self.min_bucket = min_bucket
        self.retry_on_timeout = retry_on_timeout
        self.max_fence_retries = max_fence_retries
        self.fence_backoff = fence_backoff
        self.routing = routing or RoutingTable.uniform(table_cfgs, num_servers)
        self._routing_lock = threading.Lock()
        self.localizers = localizers or {
            t: HashLocalizer(cfg.rows) for t, cfg in table_cfgs.items()
        }
        #: per-timestamp reassembly info for pulls
        self._pull_plans: Dict[int, dict] = {}
        #: deadline and fence retry counters
        self.pull_retries = 0
        self.push_retries = 0
        self.refresh_retries = 0
        # -- sampled request tracing -------------------------------------------
        #: cross-node trace ids (see :meth:`_trace_ctx`)
        self._trace_seq = itertools.count()
        #: sampling policy: requests whose hashed id misses the 1-in-N
        #: sample carry NO trace context (zero wire bytes)
        self.trace = trace or TraceConfig()
        self._trace_lock = threading.Lock()
        #: tid -> [t0_mono, legs outstanding]; the span tree closes (and the
        #: e2e latency records) when the last leg's ack returns.  Bounded:
        #: oldest entries are evicted so a lost ack never leaks memory.
        self._trace_pending: Dict[str, list] = {}
        #: submit -> last-ack latency across sampled requests (``trace.e2e``)
        self._trace_e2e = LatencyHistogram()
        #: sampled requests stamped / span trees closed
        self.trace_samples = 0
        self.trace_closed = 0
        # -- staleness observability -------------------------------------------
        #: highest server version this worker's own pushes were acked at, per
        #: (table, server): the baseline update lag is measured from
        self._last_push_version: Dict[Tuple[str, str], int] = {}
        #: update-lag distributions per (table, server), in versions
        self._staleness: Dict[Tuple[str, str], LatencyHistogram] = {}
        self._staleness_lock = threading.Lock()
        self.staleness_samples = 0
        # -- device-plane backpressure -----------------------------------------
        #: total ``__busy__``-hinted acks seen, and the monotonic stamp of the
        #: last one per server (:meth:`server_busy`)
        self.busy_hints = 0
        self._busy_last: Dict[str, float] = {}
        # -- read-heavy serving plane --------------------------------------------
        #: hot-row cache; None = this worker does not serve reads
        self.cache = cache
        #: table -> (TableRouting identity, per-segment owner-code vector):
        #: the serve path's owner interning, memoized per adopted routing
        self._serve_codes: Dict[str, tuple] = {}
        # -- hierarchical push ---------------------------------------------------
        #: group membership; None (or size 1) = direct pushes
        self._group = group if (group is not None and group.size > 1) else None
        self._group_cfg: Optional[GroupConfig] = None
        #: how a group frame meets a lossy wire codec's error feedback:
        #: "leader" (fixed election: one sender owns the residual) or "bypass"
        #: (rotation would move the residual owner every step)
        self._group_ef: Optional[str] = None
        self._group_reducer: Optional[GroupReducer] = None
        if self._group is not None:
            if self.post.node_id not in self._group.members:
                raise ValueError(
                    f"{self.post.node_id} is not a member of group {self._group.gid}"
                )
            if group_cfg is not None and group_cfg.size != self._group.size:
                raise ValueError(
                    f"group_cfg.size={group_cfg.size} != group size {self._group.size}"
                )
            self._group_cfg = group_cfg or GroupConfig(
                size=self._group.size, election=self._group.election
            )
            self._group_ef = "leader" if self._group.election == "fixed" else "bypass"
            # every member carries a reducer: any of them can be elected
            self._group_reducer = GroupReducer(
                self._group.size, node=self.post.node_id, mode=self._group_cfg.reduce
            )
        self._group_lock = threading.Lock()
        #: per-table local step counter keying leader election (members
        #: advance in lockstep; skew degrades to the timeout fallback)
        self._group_steps: Dict[str, int] = {}
        #: (table, step) -> Event set by the done notify (sync waiters)
        self._group_events: Dict[Tuple[str, int], threading.Event] = {}
        self.group_pushes = 0  # reduced wire pushes sent (as leader)
        self.group_reduced_fanin = 0  # member contributions those carried
        self.group_contribs = 0  # contributions sent (as member)
        self.group_fallbacks = 0  # degradations to direct push
        self.group_done_recv = 0  # done notifies applied
        self.group_handoffs = 0  # fence re-elections handed to a new leader
        # -- consistency gate ----------------------------------------------------
        #: per-table committed step: how many push_sync calls fully
        #: completed; the ``__cstep__`` stamped on gated PUSH/PULL traffic
        self._consist_steps: Dict[str, int] = {}
        self._consist_lock = threading.Lock()
        #: ``__wait__`` defers received / pulls shed to the stale cache /
        #: requests forced through ungated past the gate deadline
        self.consist_waits = 0
        self.consist_sheds = 0
        self.consist_forced = 0
        #: seconds parked on gates (first defer -> admitted)
        self._gate_hist = LatencyHistogram()

    def _serve_owner_codes(self, table: str, tr, cache: HotRowCache) -> np.ndarray:
        """Owner :meth:`HotRowCache.server_code` per segment of ``tr``.

        Identity-keyed memo: :meth:`adopt_routing` replaces routing objects
        wholesale, so ``ent[0] is tr`` is exact — no epoch bookkeeping.
        """
        ent = self._serve_codes.get(table)
        if ent is not None and ent[0] is tr:
            return ent[1]
        codes = np.asarray(
            [cache.server_code(server_id(int(o))) for o in tr.owners], dtype=np.int32
        )
        self._serve_codes[table] = (tr, codes)
        return codes

    # -- routing --------------------------------------------------------------
    def adopt_routing(self, routing) -> bool:
        """Adopt a routing table (or its wire payload, as fence replies carry
        it) iff it is NEWER than the one held: highest epoch wins.  Adoption
        drops every hot-row cache entry (a range that moved and moved back
        across epochs could alias); the watermarks stay.  It also drops this
        worker's error-feedback residuals in every wire quantizer of its van
        stack: they describe error owed to the OLD owners of each range."""
        if routing is None:
            return False
        if isinstance(routing, dict):
            routing = RoutingTable.from_payload(routing)
        with self._routing_lock:
            if routing.epoch <= self.routing.epoch:
                return False
            self.routing = routing
        if self.cache is not None:
            self.cache.invalidate_all(reason="routing-epoch")
        van = getattr(self.post, "van", None)
        if van is not None:
            for codec in find_quantizers(van):
                codec.reset_residuals(sender=self.post.node_id, reason="adopt_routing")
        return True

    def counters(self) -> dict:
        """Retry, staleness, backpressure, group and gate counters,
        Dashboard-mergeable; the JAX worker's keys for what the port has."""
        out = {
            "pull_retries": self.pull_retries,
            "push_retries": self.push_retries,
            "refresh_retries": self.refresh_retries,
            "staleness_samples": self.staleness_samples,
            "busy_hints": self.busy_hints,
            "trace_samples": self.trace_samples,
            "trace_closed": self.trace_closed,
        }
        if self._group is not None:
            out.update(
                {
                    "group_pushes": self.group_pushes,
                    "group_reduced_fanin": self.group_reduced_fanin,
                    "group_contribs": self.group_contribs,
                    "group_fallbacks": self.group_fallbacks,
                    "group_done_recv": self.group_done_recv,
                    "group_handoffs": self.group_handoffs,
                }
            )
        if self.cache is not None:
            out.update(self.cache.counters())
        with self._consist_lock:
            if self.consist_waits or self._consist_steps:
                out["consist_waits"] = self.consist_waits
                out["consist_sheds"] = self.consist_sheds
                out["consist_forced"] = self.consist_forced
                out["consist_degraded"] = self.consist_sheds + self.consist_forced
                out["consist_step"] = sum(self._consist_steps.values())
        return out

    def server_busy(self, server: str, within_s: float = 1.0) -> bool:
        """True if ``server`` stamped ``__busy__`` onto an ack within the
        last ``within_s`` seconds — the soft-backpressure poll a throttling
        training loop consumes (the hint is advisory: pushes were applied)."""
        with self._staleness_lock:
            t = self._busy_last.get(server)
        return t is not None and (time.monotonic() - t) <= within_s

    def _on_response(self, msg) -> None:
        """Tap every reply, on the receive thread, then complete the task
        (always: observability never loses a reply).

        An echoed ``__trace__`` context closes one leg of a sampled
        request; the last leg records ``trace.e2e`` and the ``trace.ack``
        event.  ``__busy__`` counts a backpressure hint.  ``__sver__`` raises the
        hot-row cache's watermark for (table, server) on every stamped reply,
        fence rejects included.  Besides, a PUSH ack advances this worker's
        last-pushed version for (table, server); a PULL reply records
        ``server_version - last_pushed_version`` into that range's staleness
        histogram; a fence's stamp does neither."""
        try:
            payload = msg.task.payload
            tctx = payload.get(TRACE_KEY)
            if tctx is not None and isinstance(tctx, dict):
                tid = tctx.get("tid")
                done = e2e = None
                if tid is not None:
                    with self._trace_lock:
                        ent = self._trace_pending.get(tid)
                        if ent is not None:
                            ent[1] -= 1
                            if ent[1] <= 0:
                                self._trace_pending.pop(tid, None)
                                e2e = time.monotonic() - ent[0]
                                self._trace_e2e.record(max(e2e, 0.0))
                                self.trace_closed += 1
                                done = True
                    if done:
                        flightrec.record(
                            "trace.ack", tid=tid, node=self.post.node_id,
                            sender=msg.sender, fenced=bool(payload.get(FENCED_KEY)),
                            e2e_ms=round(e2e * 1e3, 3),
                        )
            if payload.get(BUSY_KEY):
                with self._staleness_lock:
                    self.busy_hints += 1
                    self._busy_last[msg.sender] = time.monotonic()
            sver = payload.get(VERSION_KEY)
            table = payload.get("table")
            if sver is not None and table is not None and self.cache is not None:
                self.cache.observe(table, msg.sender, int(sver))
            if sver is not None and table is not None and not payload.get(FENCED_KEY):
                key = (table, msg.sender)
                with self._staleness_lock:
                    if msg.task.kind == TaskKind.PUSH:
                        if sver > self._last_push_version.get(key, 0):
                            self._last_push_version[key] = int(sver)
                    elif msg.task.kind == TaskKind.PULL:
                        last = self._last_push_version.get(key)
                        if last is not None:
                            hist = self._staleness.get(key)
                            if hist is None:
                                hist = self._staleness[key] = LatencyHistogram()
                            hist.record(float(max(int(sver) - last, 0)))
                            self.staleness_samples += 1
        except Exception:  # noqa: BLE001 — observability must never lose
            pass  # the reply itself
        super()._on_response(msg)

    def staleness_digests(self) -> Dict[str, dict]:
        """Cumulative update-lag digests: ``staleness.<table>`` merges every
        server's distribution; ``staleness.<table>@<server>`` keeps the
        per-range split."""
        with self._staleness_lock:
            per_range = {
                f"staleness.{t}@{s}": h.to_dict() for (t, s), h in self._staleness.items()
            }
            merged: Dict[str, LatencyHistogram] = {}
            for (t, _s), h in self._staleness.items():
                agg = merged.get(t)
                if agg is None:
                    agg = merged[t] = LatencyHistogram()
                agg.merge(h)
        out = {f"staleness.{t}": h.to_dict() for t, h in merged.items()}
        out.update(per_range)
        return out

    def latency_digests(self) -> Dict[str, dict]:
        """``trace.e2e``: submit -> last-ack latency across sampled requests
        (the denominator ``tools/critpath.py`` attributes into planes), and
        ``consist.gate_wait``: seconds parked on consistency gates.
        Cumulative and monotone, for the telemetry publisher."""
        out = {}
        with self._trace_lock:
            if self._trace_e2e.count:
                out["trace.e2e"] = self._trace_e2e.to_dict()
        with self._consist_lock:
            if self._gate_hist.count:
                out["consist.gate_wait"] = self._gate_hist.to_dict()
        return out

    # -- sampled request tracing ------------------------------------------------
    def _trace_ctx(self) -> Optional[dict]:
        """Fresh trace context for one logical request — or ``None``.

        ``None`` means the request missed the deterministic hash sample
        (``core/tracectx.py``): no context is stamped, no ``__trace__``
        payload key exists and zero trace bytes ride the wire.  A sampled
        request gets a dict stamped into the payload of every wire leg and
        recorded as a ``trace`` attr on this worker's span; the receiving
        van stamps ``rx``, the server echoes the context back on acks.  The
        id is unique per (node, customer, request), and the sampling
        decision is a pure function of ``(tid, seed)``: replays sample the
        same requests, and the JAX worker samples the same ids.
        """
        tid = f"{self.post.node_id}/{self.name}/{next(self._trace_seq)}"
        if not self.trace.enabled or not sampled(
            tid, self.trace.seed, self.trace.sample_every
        ):
            return None
        return {
            "tid": tid,
            "origin": self.post.node_id,
            "customer": self.name,
            "t": time.monotonic(),
        }

    def _trace_submitted(self, tctx: Optional[dict], op: str, legs: int) -> None:
        """Bookkeep one sampled submit: ``legs`` acks close the span tree.

        A ``None`` tctx (unsampled request) is a no-op — the whole body sits
        behind the sampling gate (``tools/check_wrappers.py``'s
        ``TRACE_GATED_FUNCS``).  The pending map is bounded: the oldest
        entry is evicted when full, so a reply that never returns degrades
        to a missing e2e sample (``trace.submit`` with no ``trace.ack``,
        what ``tools/postmortem.py`` anchors on), never to leaked memory.
        """
        if tctx is not None:
            with self._trace_lock:
                self.trace_samples += 1
                while len(self._trace_pending) >= 4096:
                    self._trace_pending.pop(next(iter(self._trace_pending)))
                self._trace_pending[tctx["tid"]] = [tctx["t"], int(legs)]
            flightrec.record(
                "trace.submit", tid=tctx["tid"], op=op, node=self.post.node_id,
                legs=int(legs), t0_s=tctx["t"],
            )

    # -- consistency gate -------------------------------------------------------
    def consist_step(self, table: str) -> int:
        """This worker's committed step for ``table`` (completed pushes)."""
        with self._consist_lock:
            return self._consist_steps.get(table, 0)

    def _consist_commit(self, table: str) -> int:
        with self._consist_lock:
            s = self._consist_steps.get(table, 0) + 1
            self._consist_steps[table] = s
            return s

    def _gated(self, table: str) -> bool:
        return self.table_cfgs[table].consistency is not None

    @staticmethod
    def _scan_waits(responses, order) -> Tuple[list, list, list, float]:
        """Split out typed ``__wait__`` defers: fence-shaped but not fences
        (routing is fine; the sender ran ahead of the fleet minimum).
        Returns ``(rest, waits, waited position arrays, max retry_after)``."""
        rest, waits, pos, retry = [], [], [], 0.0
        for resp in responses:
            p = resp.task.payload
            if p.get(WAIT_KEY):
                waits.append(resp)
                pos.append(order[resp.sender])
                retry = max(retry, float(p.get("retry_after") or 0.0))
            else:
                rest.append(resp)
        return rest, waits, pos, retry

    @staticmethod
    def _scan_fences(responses, order) -> Tuple[list, set, List[np.ndarray]]:
        """Split a completed task's responses into (data, fenced senders,
        fenced position arrays)."""
        data, senders, fenced = [], set(), []
        for resp in responses:
            if resp.task.payload.get(FENCED_KEY):
                senders.add(resp.sender)
                fenced.append(order[resp.sender])
            else:
                data.append(resp)
        return data, senders, fenced

    @staticmethod
    def _real_errors(errs, fenced_senders) -> list:
        """Errors minus the typed fence rejects (recorded as 'S0: <err>')."""
        return [e for e in errs if not any(e.startswith(f"{s}: ") for s in fenced_senders)]

    def _adopt_from(self, responses) -> None:
        for resp in responses:
            if resp.task.payload.get(FENCED_KEY):
                self.adopt_routing(resp.task.payload.get(ROUTING_KEY))

    def _gate_deadline_s(self, table: str) -> float:
        cfg = self.table_cfgs[table].consistency
        return cfg.gate_deadline_s if cfg is not None else 0.0

    def _gate_pause(self, table: str, retry_after: float) -> None:
        cfg = self.table_cfgs[table].consistency
        time.sleep(max(retry_after, cfg.gate_retry_s if cfg is not None else 0.005))

    def _gate_admitted(self, gate_t0: Optional[float]) -> None:
        if gate_t0 is not None:
            with self._consist_lock:
                self._gate_hist.record(max(time.monotonic() - gate_t0, 0.0))

    # -- hierarchical push ------------------------------------------------------
    def _group_push(self, table, slots, combined, *, sync: bool, timeout) -> int:
        """Route one prepared push through the group: elect, then lead the
        rendezvous or contribute to the elected leader.  Returns the
        timestamp of the leg this member sent, or -1 when the leader's set
        was completed (and its wire push sent) by another thread."""
        step = self._group_step_next(table)
        leader = self._group.leader(table, step)
        flightrec.record(
            "group.elect", node=self.post.node_id, table=table, step=step,
            leader=leader, size=self._group.size,
        )
        # flush rendezvous sets a dead or skewed member stranded
        self._group_gc_stale()
        if leader == self.post.node_id:
            return self._group_lead(table, step, slots, combined, sync=sync, timeout=timeout)
        return self._group_contribute(
            table, step, leader, slots, combined, sync=sync, timeout=timeout
        )

    def _group_step_next(self, table: str) -> int:
        with self._group_lock:
            step = self._group_steps.get(table, 0)
            self._group_steps[table] = step + 1
        return step

    def _group_event(self, table: str, step: int) -> threading.Event:
        with self._group_lock:
            ev = self._group_events.get((table, step))
            if ev is None:
                ev = self._group_events[(table, step)] = threading.Event()
        return ev

    def _group_pop_event(self, table: str, step: int) -> None:
        with self._group_lock:
            self._group_events.pop((table, step), None)

    def _group_lead(self, table, step, slots, combined, *, sync, timeout) -> int:
        """Leader leg: deposit own contribution; push when the set
        completes; on member timeout flush a PARTIAL reduction (no loss)."""
        cfg = self._group_cfg
        ev = self._group_event(table, step) if sync else None
        done = self._group_reducer.deposit(table, step, self.post.node_id, slots, combined)
        ts = -1
        if done is not None:
            ts = self._group_wire_push(table, step, *done)
        if not sync:
            return ts
        try:
            # degradation runs on the group's own clock (fallback_timeout),
            # not the caller's push deadline
            if not ev.wait(cfg.fallback_timeout):
                part = self._group_reducer.take(table, step)
                if part is not None:
                    if cfg.fallback == "none":
                        raise TimeoutError(
                            f"group push of {table!r} step {step}: members "
                            f"missing and fallback='none'"
                        )
                    with self._group_lock:
                        self.group_fallbacks += 1
                    flightrec.record(
                        "group.fallback", node=self.post.node_id, table=table,
                        step=step, reason="member_timeout", fanin=part[2],
                    )
                    ts = self._group_wire_push(table, step, *part)
                # the wire push is in flight either way: wait for its acks
                if not ev.wait(timeout if timeout is not None else cfg.fallback_timeout):
                    raise TimeoutError(f"group push of {table!r} step {step} timed out")
            return ts
        finally:
            self._group_pop_event(table, step)

    def _group_contribute(self, table, step, leader, slots, combined, *, sync, timeout) -> int:
        """Member leg: ship the combined plane to the leader as a CONTROL
        contribution (never bundled); degrade to a direct push if the leader
        is dead or partitioned."""
        cfg = self._group_cfg
        ev = self._group_event(table, step) if sync else None
        msg = Message(
            task=Task(
                TaskKind.CONTROL,
                self.name,
                payload={
                    GROUP_KEY: {
                        "op": "contrib", "table": table, "step": int(step),
                        "member": self.post.node_id, "fanin": 1,
                    }
                },
            ),
            recver=leader,
            keys=np.asarray(slots).astype(np.int64, copy=False),
            values=[combined],
        )
        with self._group_lock:
            self.group_contribs += 1
        if not sync:
            cb = functools.partial(self._group_contrib_done, table, step, slots, combined)
            return self.submit([msg], callback=cb)
        ts = self.submit([msg], keep_responses=True)
        try:
            if not self.wait(ts, cfg.fallback_timeout):
                # partitioned leader: fence the contribution so a late
                # delivery cannot double-apply, then push direct
                self.cancel(ts, "group leader deadline", remote=True)
                self.take_responses(ts)
                return self._group_fallback(
                    table, step, slots, combined,
                    reason="leader_timeout", sync=True, timeout=timeout,
                )
            errs = self.errors(ts)
            self.take_responses(ts)
            if errs:
                # dead leader: the contribution was NOT absorbed
                return self._group_fallback(
                    table, step, slots, combined,
                    reason="dead_leader", sync=True, timeout=timeout,
                )
            # acked: the leader owns this gradient now.  Wait for the done
            # notify (it advances _last_push_version); no fallback after this
            # point, since re-pushing an absorbed gradient would double-apply
            ev.wait(timeout if timeout is not None else cfg.fallback_timeout)
            return ts
        finally:
            self._group_pop_event(table, step)

    def _group_contrib_done(self, table, step, slots, combined, responses):
        """Async-contribution callback: degrade on a dead leader."""
        if not any(r.task.payload.get("__error__") is None for r in responses):
            self._group_fallback(
                table, step, slots, combined, reason="dead_leader", sync=False, timeout=None
            )

    def _group_fallback(self, table, step, slots, combined, *, reason, sync, timeout) -> int:
        """Direct push of this member's own gradient: the same-step, no-loss
        degradation the group contract promises."""
        if self._group_cfg.fallback == "none":
            raise RuntimeError(
                f"group push of {table!r} step {step}: leader unreachable "
                f"({reason}) and fallback='none'"
            )
        with self._group_lock:
            self.group_fallbacks += 1
        flightrec.record(
            "group.fallback", node=self.post.node_id, table=table, step=step, reason=reason
        )
        if sync:
            return self._push_sync_prepared(table, slots, combined, timeout)
        ts, _ = self._submit_push(table, slots, combined)
        return ts

    def _group_gc_stale(self) -> None:
        """Flush rendezvous sets whose stragglers exceeded the timeout."""
        red = self._group_reducer
        if red is None or not red.pending():
            return
        for table, step, (keys, vals, fanin) in red.take_stale(self._group_cfg.fallback_timeout):
            with self._group_lock:
                self.group_fallbacks += 1
            flightrec.record(
                "group.fallback", node=self.post.node_id, table=table, step=step,
                reason="stale_set", fanin=fanin,
            )
            self._group_wire_push(table, step, keys, vals, fanin)

    def _group_wire_push(self, table, step, keys, vals, fanin, attempt: int = 0,
                         positions: Optional[np.ndarray] = None) -> int:
        """Push the reduced tensor, stamped as ONE logical group apply.

        Non-blocking: this runs on training threads, the receive thread (a
        completing deposit) and the callback pool (fence retries); blocking
        on a same-endpoint reply would deadlock the receive thread, so acks
        are handled by :meth:`_group_wire_done` via the submit callback.
        """
        stamp = {"id": self._group.gid, "n": int(fanin), "step": int(step), "ef": self._group_ef}
        # hierarchical hop: the LEADER stamps a fresh context for the reduced
        # wire push — the member contributions that fed it stayed in the group
        tctx = self._trace_ctx()
        routing = self.routing
        keys = np.asarray(keys)
        if positions is None:
            positions = np.arange(keys.shape[0], dtype=np.int64)
        msgs, order = [], {}
        for s, rel, ids in routing.slice_ids(table, keys[positions]):
            abs_pos = positions[rel]
            order[server_id(s)] = abs_pos
            payload = {"table": table, ROUTING_EPOCH_KEY: routing.epoch, GROUP_KEY: dict(stamp)}
            if tctx is not None:
                payload[TRACE_KEY] = tctx
            msgs.append(
                Message(
                    task=Task(TaskKind.PUSH, self.name, payload=payload),
                    recver=server_id(s),
                    keys=ids.astype(np.int32),
                    values=[vals[abs_pos]],
                )
            )
        cb = functools.partial(
            self._group_wire_done, table, step, keys, vals, fanin, attempt, order
        )
        # registered before the submit: the acks race the submit call
        self._trace_submitted(tctx, "group_push", len(msgs))
        with self.coalesce_window():
            ts = self.submit(msgs, callback=cb)
        with self._group_lock:
            self.group_pushes += 1
            self.group_reduced_fanin += int(fanin)
        return ts

    def _group_wire_done(self, table, step, keys, vals, fanin, attempt, order, responses):
        """Ack callback of a group wire push: adopt and re-elect on fences,
        then notify every member with the acked versions.  A fenced reduced
        push re-elects with ``salt=attempt+1``; if the new leader is another
        member the fenced subset is HANDED OFF to it."""
        try:
            self._adopt_from(responses)
            data, _senders, fenced = self._scan_fences(responses, order)
            vers = {}
            for r in data:
                p = r.task.payload
                if p.get("__error__") is None and p.get(VERSION_KEY) is not None:
                    vers[r.sender] = int(p[VERSION_KEY])
            if fenced and attempt < self.max_fence_retries:
                pos = np.sort(np.concatenate(fenced))
                with self._group_lock:
                    self.refresh_retries += 1
                new_leader = self._group.leader(table, step, salt=attempt + 1)
                flightrec.record(
                    "group.elect", node=self.post.node_id, table=table, step=step,
                    leader=new_leader, size=self._group.size, salt=attempt + 1,
                    cause="fence",
                )
                if new_leader != self.post.node_id:
                    self._group_handoff(
                        new_leader, table, step, keys[pos], vals[pos], fanin, attempt + 1
                    )
                else:
                    self._group_wire_push(
                        table, step, keys, vals, fanin, attempt + 1, positions=pos
                    )
            if fenced:
                if vers:  # acked legs advance versions; the retry notifies later
                    self._group_notify_done(table, step, vers, final=False)
            else:
                self._group_notify_done(table, step, vers, final=True)
        except Exception:  # noqa: BLE001 — a callback-thread error must not
            # pass silently: the group's sync waiters then time out on it
            flightrec.record(
                "group.fallback", node=self.post.node_id, table=table, step=step,
                reason="wire_done_error",
            )

    def _group_handoff(self, new_leader, table, step, keys, vals, fanin, attempt) -> None:
        with self._group_lock:
            self.group_handoffs += 1
        msg = Message(
            task=Task(
                TaskKind.CONTROL,
                self.name,
                payload={
                    GROUP_KEY: {
                        "op": "handoff", "table": table, "step": int(step),
                        "fanin": int(fanin), "attempt": int(attempt),
                    }
                },
            ),
            recver=new_leader,
            keys=np.asarray(keys).astype(np.int64, copy=False),
            values=[vals],
        )
        cb = functools.partial(
            self._group_handoff_done, table, step, keys, vals, fanin, attempt
        )
        self.submit([msg], callback=cb)

    def _group_handoff_done(self, table, step, keys, vals, fanin, attempt, responses) -> None:
        if not any(r.task.payload.get("__error__") is None for r in responses):
            # the new leader is unreachable too: retry the push locally
            self._group_wire_push(table, step, keys, vals, fanin, attempt)

    def _group_notify_done(self, table, step, vers, *, final) -> None:
        """Tell every member the group push landed (fire-and-forget), with
        the per-server acked versions: each member advances its OWN
        ``_last_push_version``, so staleness is measured from the group
        push for every member."""
        self._group_apply_done(table, step, vers, final)
        for m in self._group.members:
            if m == self.post.node_id:
                continue
            self.post.send(
                Message(
                    task=Task(
                        TaskKind.CONTROL,
                        self.name,
                        # fresh payload per leg (Loopback may alias them)
                        payload={
                            GROUP_KEY: {
                                "op": "done", "table": table, "step": int(step),
                                "vers": dict(vers), "final": bool(final),
                            }
                        },
                    ),
                    recver=m,
                )
            )

    def _group_apply_done(self, table, step, vers, final) -> None:
        with self._staleness_lock:
            for server, sver in vers.items():
                key = (table, server)
                if int(sver) > self._last_push_version.get(key, 0):
                    self._last_push_version[key] = int(sver)
        with self._group_lock:
            self.group_done_recv += 1
            ev = self._group_events.get((table, int(step))) if final else None
        if ev is not None:
            ev.set()

    def handle_request(self, msg: Message) -> Optional[Message]:
        """Worker-to-worker group ops: contribution deposit, fence-retry
        handoff, done notify.  Anything else keeps the base behaviour (a
        typed ``__error__`` reply)."""
        payload = msg.task.payload
        grp = payload.get(GROUP_KEY) if isinstance(payload, dict) else None
        if grp is None or self._group is None:
            return super().handle_request(msg)
        op = grp.get("op")
        if op == "contrib":
            table, step = grp["table"], int(grp["step"])
            done = self._group_reducer.deposit(
                table, step, grp.get("member", msg.sender), msg.keys, msg.values[0],
                fanin=int(grp.get("fanin", 1)),
            )
            if done is not None:
                self._group_wire_push(table, step, *done)
            self._group_gc_stale()
            return msg.reply()
        if op == "handoff":
            self._group_wire_push(
                grp["table"], int(grp["step"]), msg.keys, msg.values[0],
                int(grp.get("fanin", 1)), attempt=int(grp.get("attempt", 0)),
            )
            return msg.reply()
        if op == "done":
            self._group_apply_done(
                grp["table"], int(grp["step"]),
                {k: int(v) for k, v in (grp.get("vers") or {}).items()},
                bool(grp.get("final", True)),
            )
            return None  # fire-and-forget: the sender tracks no task
        return super().handle_request(msg)

    # -- push ---------------------------------------------------------------
    def _submit_push(
        self,
        table: str,
        slots: np.ndarray,
        combined,
        positions: Optional[np.ndarray] = None,
        *,
        keep: bool = False,
        tctx: Optional[dict] = None,
        ungated: bool = False,
    ) -> Tuple[int, Dict[str, np.ndarray]]:
        """Wire one push of ``combined[positions]`` rows at global ids
        ``slots[positions]``; returns ``(ts, {server: positions})``.

        ``positions`` (ascending indices into ``slots``) defaults to all of
        them; retries pass only the rejected subset.  ``combined`` is numpy,
        or a device tensor sliced per server as device views (push_device).
        Gated tables stamp the committed step unless ``ungated`` (the
        gate-deadline force-through).  ``tctx``: the caller's trace context;
        without one this submit draws its own sampling decision."""
        tctx = tctx if tctx is not None else self._trace_ctx()
        routing = self.routing  # one consistent table per submit
        if positions is None:
            positions = np.arange(slots.shape[0], dtype=np.int64)
        cstep = self.consist_step(table) if not ungated and self._gated(table) else None
        msgs, order = [], {}
        for s, rel, ids in routing.slice_ids(table, slots[positions]):
            abs_pos = positions[rel]
            order[server_id(s)] = abs_pos
            if isinstance(combined, torch.Tensor):
                plane = combined[torch.from_numpy(abs_pos).to(combined.device)]
            else:
                plane = combined[abs_pos]
            payload = {"table": table, ROUTING_EPOCH_KEY: routing.epoch}
            if cstep is not None:
                payload[CONSIST_STEP_KEY] = cstep
            if tctx is not None:
                payload[TRACE_KEY] = tctx
            msgs.append(
                Message(
                    task=Task(TaskKind.PUSH, self.name, payload=payload),
                    recver=server_id(s),
                    keys=ids.astype(np.int32),
                    values=[plane],
                )
            )
        # register the span tree BEFORE the wire submit: replies race the
        # submit call, and a decrement that finds no entry would leak a tree
        self._trace_submitted(tctx, "push", len(msgs))
        # under a CoalescingVan the burst flushes at window exit; nested in
        # push_many's window it coalesces across tables instead
        with self.coalesce_window():
            ts = self.submit(msgs, keep_responses=keep)
        return ts, order

    def _prepare_push(self, table: str, keys, values):
        """Host half of a push: localize, then the duplicate pre-combine on
        ``device``, read back to numpy."""
        cfg = self.table_cfgs[table]
        vals = np.asarray(values, dtype=cfg.dtype).reshape(keys.size, cfg.dim)
        slots, inverse, _n = localize_to_slots(
            keys, self.localizers[table], min_bucket=self.min_bucket
        )
        combined = scatter.segment_combine(
            torch.tensor(vals, device=self.device),
            torch.tensor(inverse, device=self.device),
            slots.shape[0],
        )
        return slots, combined.cpu().numpy()

    def push(self, table: str, keys: np.ndarray, values: np.ndarray) -> int:
        """Push per-position gradient rows for ``keys``; returns a timestamp.

        ``values`` has shape ``[len(keys), dim]`` (or ``[len(keys)]`` for
        dim=1 tables).  Fire-and-forget: ``wait(ts)`` blocks for the acks,
        which cannot observe fences or gates — use :meth:`push_sync` there.
        In a group the push routes through the pre-reduction (a dead leader
        degrades to a direct push via the submit callback).
        """
        tctx = self._trace_ctx()
        with self.tracer.span(
            "kv.push", table=table, n=int(keys.size),
            **({"trace": tctx["tid"]} if tctx is not None else {}),
        ):
            slots, combined = self._prepare_push(table, keys, values)
            if self._group is not None:
                return self._group_push(table, slots, combined, sync=False, timeout=None)
            ts, _ = self._submit_push(table, slots, combined, tctx=tctx)
            return ts

    def push_device(self, table: str, keys: np.ndarray, values: torch.Tensor) -> int:
        """Device-resident push: the gradient rows are combined on the device
        and sliced per server as device tensors, which reach in-process
        (Loopback) servers without a host round trip."""
        tctx = self._trace_ctx()
        with self.tracer.span(
            "kv.push", table=table, n=int(keys.size),
            **({"trace": tctx["tid"]} if tctx is not None else {}),
        ):
            cfg = self.table_cfgs[table]
            vals = values.reshape(keys.size, cfg.dim)
            slots, inverse, _n = localize_to_slots(
                keys, self.localizers[table], min_bucket=self.min_bucket
            )
            combined = scatter.segment_combine(
                vals, torch.tensor(inverse, device=vals.device), slots.shape[0]
            )
            ts, _ = self._submit_push(table, slots, combined, tctx=tctx)
            return ts

    def coalesce_window(self):
        """Context manager batching this worker's sends per destination when
        the van stack has a
        :class:`~parameter_server_tpu_torch.core.coalesce.CoalescingVan`;
        a null context on plain stacks."""
        win = getattr(self.post.van, "window", None)
        return win() if callable(win) else contextlib.nullcontext()

    def push_many(
        self, updates: Dict[str, Tuple[np.ndarray, np.ndarray]]
    ) -> Dict[str, int]:
        """Push several tables' gradients in one coalescing window.

        ``updates``: ``{table: (keys, values)}``.  Returns ``{table: ts}``
        — one timestamp per table (responses from the same server must not
        share a ts), all of whose wire messages coalesce into one frame per
        server.  ``wait()`` each ts as usual.
        """
        with self.coalesce_window():
            return {t: self.push(t, keys, values) for t, (keys, values) in updates.items()}

    def push_sync(
        self,
        table: str,
        keys: np.ndarray,
        values: np.ndarray,
        timeout: Optional[float] = None,
    ) -> int:
        """Push and block for all server acks; returns the completing ts.

        Deadline: the stuck task is cancelled (remotely too, so servers that
        have not applied it drop it) and re-issued once.  Fences: only the
        fenced positions are re-pushed under the adopted table (the fence
        fired before any apply, so nothing double-counts).  Gates: see
        :meth:`_push_sync_prepared`.

        In a group the push routes through the pre-reduction and blocks
        until the group's done notify (all members of a step must be in
        ``push_sync`` together); leader death degrades to this member's own
        direct push within the same step.
        """
        slots, combined = self._prepare_push(table, keys, values)
        if self._group is not None:
            return self._group_push(table, slots, combined, sync=True, timeout=timeout)
        return self._push_sync_prepared(table, slots, combined, timeout)

    def _push_sync_prepared(self, table, slots, combined, timeout=None) -> int:
        """The direct sync push loop over prepared planes, also the group
        mode's no-loss degradation target.  ``__wait__`` defers park the
        waited positions on the gate budget (no fence retries consumed);
        past ``gate_deadline_s`` the remainder is forced through ungated.
        A fully acked push commits this worker's step for the table."""
        positions: Optional[np.ndarray] = None
        ts = -1
        attempt = 0  # fence budget only; gate waits ride their own clock
        gate_t0 = None
        ungated = False
        while attempt <= self.max_fence_retries:
            ts, order = self._submit_push(
                table, slots, combined, positions, keep=True, ungated=ungated
            )
            if not self.wait(ts, timeout):
                if not self.retry_on_timeout:
                    raise TimeoutError(f"push ts={ts} timed out")
                self.cancel(ts, "push deadline", remote=True)
                self.take_responses(ts)
                self.push_retries += 1
                ts, order = self._submit_push(
                    table, slots, combined, positions, keep=True, ungated=ungated
                )
                if not self.wait(ts, timeout):
                    self.cancel(ts, "push deadline (retry)", remote=True)
                    self.take_responses(ts)
                    raise TimeoutError(f"push ts={ts} timed out after retry")
            errs = self.errors(ts)
            responses = self.take_responses(ts)
            self._adopt_from(responses)
            responses, waits, wait_pos, retry_after = self._scan_waits(responses, order)
            _, fenced_senders, fenced = self._scan_fences(responses, order)
            real = self._real_errors(errs, fenced_senders | {r.sender for r in waits})
            if real:
                raise RuntimeError(f"push ts={ts} failed on: " + "; ".join(real))
            if not fenced and not waits:
                if self._gated(table):
                    self._consist_commit(table)
                    self._gate_admitted(gate_t0)
                return ts
            pending = list(fenced)
            if waits:
                with self._consist_lock:
                    self.consist_waits += len(waits)
                if gate_t0 is None:
                    gate_t0 = time.monotonic()
                pending.append(np.sort(np.concatenate(wait_pos)))
                deadline = self._gate_deadline_s(table)
                if deadline > 0 and time.monotonic() - gate_t0 > deadline and not ungated:
                    # never dropped: force the remainder through ungated
                    ungated = True
                    with self._consist_lock:
                        self.consist_forced += 1
                    self._gate_admitted(gate_t0)
                    flightrec.record(
                        "consist.shed", node=self.post.node_id, table=table,
                        op="push", how="forced",
                        n=int(sum(p.shape[0] for p in wait_pos)),
                    )
                else:
                    self._gate_pause(table, retry_after)
            if fenced:
                self.refresh_retries += 1
                attempt += 1
                if attempt > 1:  # mid-broadcast epoch bounce: outlast it
                    time.sleep(self.fence_backoff * (attempt - 1))
            positions = np.sort(np.concatenate(pending))
        raise RuntimeError(
            f"push of {table!r}: routing fence retries exhausted after "
            f"{self.max_fence_retries} refreshes"
        )

    # -- pull ---------------------------------------------------------------
    def pull(self, table: str, keys: np.ndarray, *, read_only: bool = False) -> int:
        """Request weights for ``keys``; fetch with :meth:`pull_result`.

        ``read_only=True`` stamps the serving plane's ``__ro__`` flag: the
        server answers on its read-only fast path — relaxed reads that may
        not observe writes coalesced into the same wire bundle, and never
        gated.  Training pulls keep the default."""
        slots, inverse, _n = localize_to_slots(
            keys, self.localizers[table], min_bucket=self.min_bucket
        )
        return self._submit_pull(table, slots, inverse, keys.shape, read_only=read_only)

    def _submit_pull(self, table, slots, inverse, shape,
                     positions: Optional[np.ndarray] = None, *, read_only: bool = False,
                     ungated: bool = False) -> int:
        tctx = self._trace_ctx()
        routing = self.routing
        if positions is None:
            positions = np.arange(slots.shape[0], dtype=np.int64)
        payload = {"table": table, ROUTING_EPOCH_KEY: routing.epoch}
        # gated tables stamp the committed step; read-only serving pulls are
        # never gated (they are the shed target), and ``ungated`` is the
        # deadline force-through (fresh data never violates a staleness bound)
        if not read_only and not ungated and self._gated(table):
            payload[CONSIST_STEP_KEY] = self.consist_step(table)
        if tctx is not None:
            payload[TRACE_KEY] = tctx
        if read_only:
            payload[READ_ONLY_KEY] = True
        msgs, order = [], {}
        for s, rel, ids in routing.slice_ids(table, slots[positions]):
            order[server_id(s)] = positions[rel]
            msgs.append(
                Message(
                    # fresh dict per leg: a Loopback reply path may alias it
                    task=Task(TaskKind.PULL, self.name, payload=dict(payload)),
                    recver=server_id(s),
                    keys=ids.astype(np.int32),
                )
            )
        # registered before the submit: the replies race the submit call
        self._trace_submitted(tctx, "pull", len(msgs))
        with self.coalesce_window():
            ts = self.submit(msgs, keep_responses=True)
        self._pull_plans[ts] = {
            "order": order,
            "inverse": inverse,
            "n_slots": slots.shape[0],
            "shape": shape,
            "table": table,
            # retained so deadline/fence/gate retries can re-issue subsets
            "slots": slots,
            "trace": tctx["tid"] if tctx is not None else None,
            "ro": read_only,
            "ungated": ungated,
        }
        return ts

    def _await_pull(self, ts: int, timeout: Optional[float]) -> tuple:
        """Wait for pull ``ts``; on deadline, cancel the stuck task and
        retry ONCE against the same server ids.  Returns ``(plan,
        responses, errs)`` with all kept state drained."""
        tid = self._pull_plans[ts].get("trace")
        with self.tracer.span("kv.pull.wait", ts=ts, trace=tid):
            completed = self.wait(ts, timeout)
        if not completed and self.retry_on_timeout:
            plan = self._pull_plans.pop(ts)
            self.cancel(ts, "pull deadline", remote=True)
            self.take_responses(ts)
            self.pull_retries += 1
            pos = np.sort(np.concatenate(list(plan["order"].values())))
            ts = self._submit_pull(
                plan["table"], plan["slots"], plan["inverse"], plan["shape"],
                positions=pos, read_only=plan["ro"], ungated=plan["ungated"],
            )
            tid = self._pull_plans[ts].get("trace")
            with self.tracer.span("kv.pull.wait", ts=ts, retry=1, trace=tid):
                completed = self.wait(ts, timeout)
        plan = self._pull_plans.pop(ts)  # always reclaim, even on error paths
        errs = self.errors(ts)
        responses = self.take_responses(ts)
        if not completed:
            self.cancel(ts, "pull deadline")
            raise TimeoutError(f"pull ts={ts} timed out")
        return plan, responses, errs

    def _stale_rows(self, table: str, slots: np.ndarray):
        """Every row of ``slots`` from the cache regardless of freshness, as
        ``(rows, oldest sver)``; None without a cache or when a real slot is
        uncached.  Bucket pads stay zero, matching a wire reply."""
        cache = self.cache
        if cache is None:
            return None
        cfg = self.table_cfgs[table]
        grows = self.routing.tables[table].rows
        rows = np.zeros((int(slots.shape[0]), cfg.dim), dtype=cfg.dtype)
        sver = None
        for j, sl in enumerate(np.asarray(slots).tolist()):
            if int(sl) >= grows:
                continue
            hit = cache.lookup_stale(table, int(sl))
            if hit is None:
                return None
            rows[j] = hit[0]
            sver = hit[1] if sver is None else min(sver, hit[1])
        return rows, sver

    def _shed_pull_stale(self, plan: dict, pos: np.ndarray):
        """Answer the WAITED positions from the stale cache: the gate
        deadline's shed target, bounded by whatever ``__sver__`` each cached
        row's reply carried.  Returns a synthetic ``(positions, rows, sver,
        "cache")`` pair, or None when any waited slot is uncached (the caller
        then forces an ungated pull — fresh data, never a dropped read)."""
        got = self._stale_rows(plan["table"], plan["slots"][pos])
        return None if got is None else (pos, got[0], got[1], "cache")

    def _pull_pairs(self, ts: int, timeout: Optional[float]) -> tuple:
        """Resolve pull ``ts`` into ``(plan, [(positions, rows, sver,
        sender)])``, looping over fences (adopt, re-pull only the fenced
        positions) and ``__wait__`` defers (re-pull the waited positions on
        the gate budget).  Past the gate deadline the read degrades: shed to
        the stale cache when it covers the waited rows (``consist.shed``
        ``how=stale-cache``), else forced through ungated — counted, never
        dropped.  ``sver`` / ``sender`` let :meth:`pull_serve` stamp cache
        inserts with the version each reply carried.  Any other error leg,
        or a missing leg, raises: a dropped leg must not read as zero
        weights."""
        pairs: list = []
        first_plan = None
        attempt = 0  # fence budget only; gate waits ride their own clock
        gate_t0 = None
        forced = False
        ungated = False
        while attempt <= self.max_fence_retries:
            plan, responses, errs = self._await_pull(ts, timeout)
            if first_plan is None:
                first_plan = plan
                ungated = plan["ungated"]
            self._adopt_from(responses)
            responses, waits, wait_pos, retry_after = self._scan_waits(responses, plan["order"])
            data, fenced_senders, fenced = self._scan_fences(responses, plan["order"])
            real = self._real_errors(errs, fenced_senders | {r.sender for r in waits})
            if real:
                raise RuntimeError(f"pull ts={ts} failed on: " + "; ".join(real))
            if len(responses) + len(waits) < len(plan["order"]):
                raise RuntimeError(
                    f"pull ts={ts} incomplete: {len(responses)}/"
                    f"{len(plan['order'])} servers answered"
                )
            pairs.extend(
                (plan["order"][r.sender], r.values[0], r.task.payload.get(VERSION_KEY),
                 r.sender)
                for r in data
            )
            if not fenced and not waits:
                self._gate_admitted(gate_t0)
                return first_plan, pairs
            pending = list(fenced)
            if waits:
                with self._consist_lock:
                    self.consist_waits += len(waits)
                if gate_t0 is None:
                    gate_t0 = time.monotonic()
                table = first_plan["table"]
                deadline = self._gate_deadline_s(table)
                waited = np.sort(np.concatenate(wait_pos))
                if deadline > 0 and time.monotonic() - gate_t0 > deadline and not forced:
                    # graceful degradation: shed to the stale cache, else
                    # force the read through
                    shed = self._shed_pull_stale(first_plan, waited)
                    self._gate_admitted(gate_t0)
                    if shed is not None:
                        pairs.append(shed)
                        with self._consist_lock:
                            self.consist_sheds += 1
                        flightrec.record(
                            "consist.shed", node=self.post.node_id, table=table,
                            op="pull", how="stale-cache", n=int(waited.shape[0]),
                        )
                        if not fenced:
                            return first_plan, pairs
                    else:
                        forced = ungated = True
                        pending.append(waited)
                        with self._consist_lock:
                            self.consist_forced += 1
                        flightrec.record(
                            "consist.shed", node=self.post.node_id, table=table,
                            op="pull", how="forced", n=int(waited.shape[0]),
                        )
                else:
                    pending.append(waited)
                    self._gate_pause(table, retry_after)
            if fenced:
                self.refresh_retries += 1
                attempt += 1
                if attempt > 1:  # mid-broadcast epoch bounce: outlast it
                    time.sleep(self.fence_backoff * (attempt - 1))
            ts = self._submit_pull(
                first_plan["table"], first_plan["slots"], first_plan["inverse"],
                first_plan["shape"], positions=np.sort(np.concatenate(pending)),
                read_only=first_plan["ro"], ungated=ungated,
            )
        raise RuntimeError(
            f"pull of {first_plan['table']!r}: routing fence retries "
            f"exhausted after {self.max_fence_retries} refreshes"
        )

    @staticmethod
    def _sole_full_pair(pairs: list, n_slots: int):
        """The single reply covering every slot in identity order, or None."""
        if len(pairs) != 1:
            return None
        pos, rows = np.asarray(pairs[0][0]), pairs[0][1]
        if pos.size == n_slots and np.array_equal(pos, np.arange(n_slots)):
            return rows
        return None

    @staticmethod
    def _shaped(out, shape: tuple, dim: int):
        """Per-position rows in the caller's key shape: ``shape + (dim,)``,
        or ``shape`` for dim=1 tables."""
        return out.reshape(shape) if dim == 1 else out.reshape(shape + (dim,))

    @staticmethod
    def _host_rows(rows, dtype, dim: int) -> np.ndarray:
        """A reply's rows as a ``(n, dim)`` host array: wire replies are
        numpy already; a ``device_replies`` server's tensor is read back."""
        if isinstance(rows, torch.Tensor):
            rows = rows.cpu().numpy()
        return np.asarray(rows, dtype=dtype).reshape(-1, dim)

    def pull_result(self, ts: int, timeout: Optional[float] = None) -> np.ndarray:
        """Block for pull ``ts`` and reassemble per-position weight rows:
        ``keys.shape + (dim,)``, or ``keys.shape`` for dim=1 tables."""
        plan, pairs = self._pull_pairs(ts, timeout)
        cfg = self.table_cfgs[plan["table"]]
        sole = self._sole_full_pair(pairs, plan["n_slots"])
        if sole is not None:
            uniq_rows = self._host_rows(sole, cfg.dtype, cfg.dim)
        else:
            uniq_rows = np.zeros((plan["n_slots"], cfg.dim), dtype=cfg.dtype)
            for pos, rows, *_meta in pairs:
                uniq_rows[pos] = self._host_rows(rows, cfg.dtype, cfg.dim)
        return self._shaped(uniq_rows[plan["inverse"]], plan["shape"], cfg.dim)

    def pull_result_device(self, ts: int, timeout: Optional[float] = None) -> torch.Tensor:
        """Like :meth:`pull_result` but assembles the rows on ``device``.

        Replies of a ``KVServer(device_replies=True)`` on the same device
        never touch host memory; numpy replies are uploaded once each.  The
        unique rows land by ``index_copy_`` at their positions (every
        position is written at most once: no float accumulation), then one
        ``index_select`` by the inverse expands them per key.  Returns a
        tensor on ``device`` of shape ``keys.shape + (dim,)`` (or
        ``keys.shape`` for dim=1)."""
        plan, pairs = self._pull_pairs(ts, timeout)
        cfg = self.table_cfgs[plan["table"]]
        dev = self.device
        uniq = torch.zeros((plan["n_slots"], cfg.dim), dtype=torch.float32, device=dev)
        for pos, rows, *_meta in pairs:
            if not isinstance(rows, torch.Tensor):
                # a wire plane may be a view into a ring slot or a native
                # receive buffer, freed when its last view dies: copy it on
                # the host first, into a page-locked buffer the caching host
                # allocator holds until the copy up has run
                arr = np.asarray(rows, dtype=np.float32)
                rows = torch.empty(arr.shape, dtype=torch.float32,
                                   pin_memory=dev.type == "cuda")
                rows.numpy()[...] = arr
            rows = rows.to(dev, non_blocking=True).reshape(-1, cfg.dim)
            idx = torch.from_numpy(np.asarray(pos, dtype=np.int64)).to(dev)
            uniq.index_copy_(0, idx, rows)
        inverse = torch.from_numpy(np.asarray(plan["inverse"], dtype=np.int64)).to(dev)
        return self._shaped(uniq.index_select(0, inverse), plan["shape"], cfg.dim)

    def pull_sync(
        self, table: str, keys: np.ndarray, timeout: Optional[float] = None
    ) -> np.ndarray:
        return self.pull_result(self.pull(table, keys), timeout)

    # -- read-heavy serving plane ---------------------------------------------
    def pull_serve(
        self, table: str, keys: np.ndarray, timeout: Optional[float] = None
    ) -> np.ndarray:
        """Serve a read: hot-row cache first, read-only RPC for the misses.

        Same output contract as :meth:`pull_sync`, but every key the cache
        holds at a fresh version (entry ``__sver__`` >= the owner's observed
        watermark) is answered locally; only the misses go on the wire —
        stamped ``__ro__``, so the server answers them on its fast path.
        Fetched rows are inserted at the version THEIR reply carried, which
        keeps the bounded-staleness contract exact under races.  Without a
        cache this is a plain read-only pull.
        """
        keys = np.asarray(keys)
        cache = self.cache
        if cache is None:
            return self.pull_result(self.pull(table, keys, read_only=True), timeout)
        with self.tracer.span("kv.pull_serve", table=table, n=int(keys.size)):
            return self._serve_from_cache(table, keys, cache, timeout)

    def _serve_from_cache(self, table: str, keys: np.ndarray, cache: HotRowCache,
                          timeout: Optional[float]) -> np.ndarray:
        """:meth:`pull_serve`'s cache path: hits answered locally, the misses
        as one read-only pull whose rows are cached at their reply's version."""
        cfg = self.table_cfgs[table]
        # No dedup or sort on the hit path: ``assign`` is elementwise, so one
        # slot is probed PER POSITION and the inverse is the identity; only
        # the miss subset pays the sort ``slice_ids`` needs.
        slots = self.localizers[table].assign(
            np.ascontiguousarray(keys, dtype=np.uint64).ravel()
        )
        inverse = np.arange(slots.shape[0], dtype=np.int32)
        tr = self.routing.tables[table]
        grows = tr.rows
        rows_out = np.zeros((int(slots.shape[0]), cfg.dim), dtype=cfg.dtype)
        real = np.flatnonzero(slots < grows)
        rslots = slots[real].astype(np.int64, copy=False)
        seg = np.searchsorted(np.asarray(tr.offsets, dtype=np.int64), rslots, side="right") - 1
        seg = np.clip(seg, 0, len(tr.owners) - 1)
        # per-segment owner codes interned once per adopted routing table, so
        # the batch compare inside the cache is vector ops only
        owner_codes = self._serve_owner_codes(table, tr, cache)[seg]
        hit, hit_rows = cache.lookup_many(table, rslots, owner_codes)
        n_hit = int(hit.sum())
        if n_hit:
            rows_out[real[hit]] = hit_rows
            flightrec.record("cache.hit", node=self.post.node_id, table=table, n=n_hit)
        if n_hit < int(real.shape[0]):
            miss = ~hit
            # slice_ids routes by searchsorted: the subset must be sorted
            pos = real[miss][np.argsort(rslots[miss], kind="stable")]
            flightrec.record(
                "cache.miss", node=self.post.node_id, table=table, n=int(pos.shape[0])
            )
            ts = self._submit_pull(
                table, slots, inverse, keys.shape, positions=pos, read_only=True
            )
            _plan, pairs = self._pull_pairs(ts, timeout)
            for p, rows, sver, sender in pairs:
                rows = self._host_rows(rows, cfg.dtype, cfg.dim)
                rows_out[p] = rows
                ids = slots[p]
                realm = ids < grows
                if sver is not None and realm.any():
                    cache.insert(table, ids[realm], rows[realm], int(sver), sender)
        return self._shaped(rows_out[inverse], keys.shape, cfg.dim)

    def pull_stale(self, table: str, keys: np.ndarray) -> Optional[np.ndarray]:
        """Serve entirely from the cache IGNORING freshness — the "stale"
        shed policy's degraded answer during overload.  Returns None unless
        every real key is cached (a partly stale answer would mix freshness
        classes invisibly); never touches the wire."""
        if self.cache is None:
            return None
        keys = np.asarray(keys)
        slots, inverse, _n = localize_to_slots(
            keys, self.localizers[table], min_bucket=self.min_bucket
        )
        got = self._stale_rows(table, slots)
        if got is None:
            return None
        return self._shaped(got[0][inverse], keys.shape, self.table_cfgs[table].dim)

    # -- consistency gate control -------------------------------------------
    def consist_hello(
        self,
        *,
        table: Optional[str] = None,
        step: Optional[int] = None,
        incarnation: Optional[int] = None,
        timeout: Optional[float] = 30.0,
    ) -> None:
        """Register this worker in every server's fleet clock before
        training on a gated table, so a fast worker cannot free-run ahead of
        peers the clock has not seen yet.  After a same-id restart, re-hello
        at the restored ``step`` with the new incarnation."""
        if incarnation is None:
            reg = getattr(self.post.van, "incarnations", None)
            incarnation = reg.get(self.post.node_id) if reg is not None else 0
        if step is None:
            with self._consist_lock:
                step = (
                    self._consist_steps.get(table, 0)
                    if table is not None
                    else max(self._consist_steps.values(), default=0)
                )
        payload = {
            "worker": self.post.node_id,
            "incarnation": int(incarnation or 0),
            "step": int(step),
        }
        if table is not None:
            payload["table"] = table
        self._control_round(self._control_msgs("consist_hello", payload),
                            "consist_hello", timeout)

    def set_consistency(
        self,
        *,
        table: Optional[str] = None,
        bound: Optional[int] = None,
        mode: Optional[str] = None,
        why: str = "manual",
        timeout: Optional[float] = 30.0,
    ) -> None:
        """Live-retune the fleet's gate: new ``bound`` and/or ``mode``,
        broadcast to every server, then journaled as ``consist.retune``."""
        payload: dict = {}
        if table is not None:
            payload["table"] = table
        if bound is not None:
            payload["bound"] = int(bound)
        if mode is not None:
            payload["mode"] = str(mode)
        self._control_round(self._control_msgs("consist_set", payload), "consist_set", timeout)
        flightrec.record(
            "consist.retune", node=self.post.node_id, table=table or "*",
            bound=-1 if bound is None else int(bound), mode=mode or "-", why=why[:120],
        )

    # -- durability plane ---------------------------------------------------
    def save_model(
        self,
        root: str,
        step: int,
        *,
        clocks: Optional[list] = None,
        extras: Optional[dict] = None,
        timeout: Optional[float] = 600.0,
    ) -> None:
        """Broadcast ``save_model`` to every server, then commit the manifest
        (``checkpoint.finalize``).  Blocks until every shard is on disk;
        raises if any server's save failed instead of committing a partial
        checkpoint.  The manifest records each table's localizer, so offline
        evaluation rebuilds the exact key -> row map."""
        ts = self._broadcast_control("save_model", {"root": root, "step": step})
        if not self.wait(ts, timeout):
            raise TimeoutError("save_model timed out")
        self.check(ts)
        self.take_responses(ts)
        extras = dict(extras or {})
        extras.setdefault(
            "localizers", {t: localizer_meta(loc) for t, loc in self.localizers.items()}
        )
        checkpoint.finalize(
            root, step, self.num_servers,
            {t: cfg.rows for t, cfg in self.table_cfgs.items()},
            clocks=clocks, extras=extras,
        )

    def load_model(self, root: str, step: int, *, timeout: Optional[float] = 600.0) -> None:
        """Broadcast ``load_model``: every server restores its row range."""
        ts = self._broadcast_control("load_model", {"root": root, "step": step})
        if not self.wait(ts, timeout):
            raise TimeoutError("load_model timed out")
        self.check(ts)
        self.take_responses(ts)

    def _broadcast_control(self, op: str, payload: dict) -> int:
        """Submit ``op`` to the CURRENT owner set (after a migration it need
        not be ``0..num_servers-1``); returns the timestamp."""
        return self.submit(self._control_msgs(op, payload), keep_responses=True)

    def _control_to(self, server: int, payload: dict) -> Message:
        return Message(task=Task(TaskKind.CONTROL, self.name, payload=payload),
                       recver=server_id(server))

    def save_snapshot(
        self,
        root: str,
        step: int,
        *,
        base_step: Optional[int] = None,
        clocks: Optional[list] = None,
        extras: Optional[dict] = None,
        timeout: Optional[float] = 600.0,
    ) -> dict:
        """Partitioned, incremental, non-blocking snapshot of every table.

        Works for any routing layout: each owner writes one file per owned
        segment and this worker assembles and CRC-verifies the manifest.
        With ``base_step``, a segment whose version clock has not advanced is
        not rewritten: the base snapshot's file is carried by reference and
        only the dirty-row delta logs ship.  Pushes keep applying throughout;
        the only freeze is each server's delta export at ``snap_commit``.

        Returns ``{"step", "segments", "carried", "delta_rows", "freeze_s"}``
        (``freeze_s``: one commit freeze per server, in seconds).
        """
        base = checkpoint.read_snapshot(root, base_step) if base_step is not None else None
        base_entries = {
            (e["table"], int(e["lo"]), int(e["hi"])): e
            for e in (base["segments"] if base else [])
        }
        sid = f"ckpt-{int(step)}-e{self.routing.epoch}"
        servers = self.routing.servers()
        begun = False
        try:
            self._control_round([self._control_to(s, {"op": "snap_begin", "sid": sid})
                                 for s in servers], "snap_begin", timeout)
            begun = True
            # one snap_write per segment, to its owner; the servers take them
            # one at a time on their receive threads, so pushes interleave
            # between segments
            writes = []
            for t in sorted(self.routing.tables):
                for lo, hi, owner in self.routing.tables[t].segments():
                    payload = {"op": "snap_write", "sid": sid, "root": root,
                               "step": int(step), "table": t, "lo": lo, "hi": hi}
                    be = base_entries.get((t, lo, hi))
                    if be is not None:
                        payload["base_sver"] = int(be.get("sver", 0))
                    writes.append(self._control_to(owner, payload))
            # a migrated owner holds several segments, and a task takes one
            # response per sender: spread the writes over rounds that address
            # each server at most once
            rounds: List[List[Message]] = []
            for m in writes:
                for batch in rounds:
                    if all(b.recver != m.recver for b in batch):
                        batch.append(m)
                        break
                else:
                    rounds.append([m])
            entries: List[dict] = []
            carried_tables: set = set()
            n_carried = 0
            for batch in rounds:
                for r in self._control_round(batch, "snap_write", timeout):
                    pl = r.task.payload
                    key = (str(pl["table"]), int(pl["lo"]), int(pl["hi"]))
                    if pl.get("carried"):
                        entries.append(dict(base_entries[key]))
                        carried_tables.add(key[0])
                        n_carried += 1
                    else:
                        entries.append(dict(pl["entry"]))
            # commit: the measured, delta-bounded freeze on every server
            deltas: List[dict] = []
            svers: Dict[tuple, int] = {}
            freezes: List[float] = []
            delta_rows = 0
            commits = [self._control_to(s, {"op": "snap_commit", "sid": sid, "root": root,
                                            "step": int(step)}) for s in servers]
            for r in self._control_round(commits, "snap_commit", timeout):
                pl = r.task.payload
                for d in pl["deltas"]:
                    deltas.append(dict(d))
                    delta_rows += int(d["rows"])
                for t, lo, hi, v in pl["svers"]:
                    svers[(str(t), int(lo), int(hi))] = int(v)
                freezes.append(float(pl["freeze_s"]))
        except Exception:
            if begun:
                # release the servers' dirty tracking; orphan files are swept
                # by retention, and with no manifest the step never exists
                try:
                    self._control_round(
                        [self._control_to(s, {"op": "snap_abort", "sid": sid,
                                              "why": "coordinator error"}) for s in servers],
                        "snap_abort", timeout)
                except Exception:  # noqa: BLE001 — the original error is what matters
                    pass
            raise
        # commit-time segment versions: a row pushed between a segment's write
        # and the commit is in this snapshot's delta log, so the next snapshot
        # may carry the file at the commit-time clock
        for e in entries:
            key = (e["table"], int(e["lo"]), int(e["hi"]))
            if key in svers:
                e["sver"] = svers[key]
        # chains stay flat: carry the base's deltas only for tables that
        # carried a base file (fresh files carry THIS step's stamp, so older
        # deltas never apply to them)
        if base is not None:
            deltas.extend(dict(d) for d in base["deltas"] if d["table"] in carried_tables)
        extras = dict(extras or {})
        extras.setdefault(
            "localizers", {t: localizer_meta(loc) for t, loc in self.localizers.items()}
        )
        checkpoint.finalize_snapshot(
            root, step, self.routing.to_payload(), entries, deltas,
            base_step=base_step, clocks=clocks, extras=extras,
        )
        return {"step": int(step), "segments": len(entries), "carried": n_carried,
                "delta_rows": delta_rows, "freeze_s": freezes}

    def load_snapshot(self, root: str, step: int, *, timeout: Optional[float] = 600.0) -> None:
        """Restore a partitioned snapshot onto the current fleet, whatever its
        shape: each server reads the file ranges covering its segments."""
        self._control_round(
            self._control_msgs("restore_snap", {"root": root, "step": int(step)}),
            "restore_snap", timeout,
        )

    def _control_msgs(self, op: str, payload: dict) -> List[Message]:
        """One CONTROL message per server of the CURRENT owner set."""
        return [
            Message(
                task=Task(TaskKind.CONTROL, self.name, payload={"op": op, **payload}),
                recver=server_id(s),
            )
            for s in self.routing.servers()
        ]

    def _control_round(
        self, msgs: List[Message], what: str, timeout: Optional[float]
    ) -> List[Message]:
        """Submit control messages, wait, raise on any error, return replies."""
        ts = self.submit(msgs, keep_responses=True)
        if not self.wait(ts, timeout):
            raise TimeoutError(f"{what} timed out")
        self.check(ts)
        return self.take_responses(ts)
