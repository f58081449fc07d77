"""KVServer: the server-role Customer owning table shards.

Torch counterpart of the core of ``parameter_server_tpu/kv/server.py``.
Requests arrive on the Van receive thread of this node (one thread, so table
mutation is single-threaded by construction); the math runs in the
:class:`~parameter_server_tpu_torch.kv.table.KVTable` on ``device``.

Kept from the JAX server, with the same wire semantics: the epoch-0 routing
fence and localization, power-of-two id bucketing with floor 8, the
bundle-batched apply engine (``handle_request_batch`` with ``dup_policy``
``"rounds"`` and ``"combine"``), segment version stamping on acks and pull
replies, and ``export_shard`` / ``import_shard``.

Host <-> device traffic: wire value planes (numpy) are copied into one pinned
host buffer per request and uploaded with a single non-blocking copy (the
pinned buffer is fresh per request; PyTorch's caching host allocator does not
hand it out again before that copy has completed).  Pull replies are numpy,
read back once per bundle — or, with ``device_replies=True`` (in-process
planes whose worker shares the card), the gathered tensors sliced ``[:n]``,
never copied to the host.  The push ack never waits for the device.

The serving plane's read-only path: a PULL stamped ``__ro__`` is answered by
the same gather on its own books (``ro_pulls``, the per-table
``ro_pull.<t>`` latency digest) and skips what a write needs; in a bundle it
does not flush the open push group (the relaxed read sees the table as of
dispatch) and its readback is the bundle's second one.

Chain replication: ``replica=`` names a hot standby holding the same shard.
Every applied push is forwarded to it in apply order from ``_ack_push``,
through a forwarding ``Customer`` on its own endpoint (``<node>.fw``): the
receive thread that applies pushes must not wait on an ack that only it
could process.  ``replica_sync=True`` acks the worker after the standby
applied (no update lost on primary death); otherwise at most
``max_replica_lag`` forwards are in flight (``flush_replica`` drains them).
``kv/replica.py`` builds the chain and promotes a standby.

The apply ledger (``kv/ledger.py``, on by default as in the JAX server)
registers every device apply — one entry per single push, one per grouped
apply of a bundle — with a completion handle: on the card a CUDA event
recorded on the receive thread's current stream right after the last
launch.  Its reaper thread retires the entries; the ack only reads the
ledger's ``overloaded()`` flag and stamps ``__busy__`` from it.  Routing
fences journal ``fence.routing`` to the flight recorder.

The consistency gate: a table whose ``TableConfig.consistency`` is set keeps
a :class:`~parameter_server_tpu_torch.kv.consistency.FleetClock` of the
workers' committed steps.  A PUSH/PULL stamped ``__cstep__`` more than the
bound ahead of the fleet minimum is answered with a fence-shaped ``__wait__``
reply (``consist.gate`` on a sender's first defer, ``consist.release`` when
it is next admitted); an applied stamped push commits the sender's step in
``_ack_push``.  Control ops ``consist_hello`` (register a worker up front)
and ``consist_set`` (live mode / bound retune).  Group-stamped pushes
(``__grp__``, one reduced apply for a worker group) are booked in
``group_pushes`` / ``group_members``.  The gate and the booking are host
dict and int work: nothing on either path reads the card.

The durability plane: legacy uniform checkpoints (``save_model`` /
``load_model``), format-2 partitioned incremental snapshots (``snap_begin`` /
``snap_write`` / ``snap_commit`` / ``snap_abort``, ``restore_snap``) and live
shard migration (the ``migrate_*`` ops, chained to a standby by
``_forward_control``), with the JAX server's wire protocol and files.  On the
card every path moves only the rows the protocol names:

- a contiguous owned range (a migration chunk, a snapshot segment) is one
  slice of each plane, copied to the host;
- rows at arbitrary ids (a commit's dirty delta) are one ``ps_gather`` launch
  over the value and state planes (:meth:`_export_rows`);
- a layout change (:meth:`_rebuild_table`) builds the new shard on the card:
  slice copies of the kept segments and of the adopted range, rows at
  arbitrary ids by one ``ps_scatter_set`` launch, the trash row carried;
- streamed chunks are uploaded when they are staged, and the recipient writes
  the commit's delta into the assembled range with one ``ps_scatter_set``.

Dirty tracking for open migrations and snapshots appends the request's host
key array in ``_ack_push`` (no device read, no per-key Python work) and dedups
once at commit.  Every read of a plane runs on this receive thread's stream,
after every apply it launched there.  Not ported yet: request tracing.
"""

from __future__ import annotations

import collections
import dataclasses
import logging
import time
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch import checkpoint
from parameter_server_tpu_torch.config import (
    ApplyEngineConfig,
    ConsistencyMode,
    LedgerConfig,
    TableConfig,
)
from parameter_server_tpu_torch.convert import shard_from_numpy
from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind
from parameter_server_tpu_torch.core.postoffice import Customer, Postoffice
from parameter_server_tpu_torch.kv.consistency import MODE_CODES, FleetClock
from parameter_server_tpu_torch.kv.ledger import COMPLETED, ApplyLedger
from parameter_server_tpu_torch.kv.partition import RangePartition
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
)
from parameter_server_tpu_torch.kv.table import KVTable
from parameter_server_tpu_torch.ops import scatter
from parameter_server_tpu_torch.utils.keys import bucket_size
from parameter_server_tpu_torch.utils.trace import LatencyHistogram


def _bucket(n: int) -> int:
    """Server-side id bucket: next power of two, >= 8."""
    return bucket_size(max(n, 1), min_bucket=8)


class _DirtyRows:
    """The global rows written while a migration or snapshot window is open.

    The push ack appends the request's host key array as it is (one mask and
    one list append, no per-key Python work); :meth:`rows` dedups once, at
    the commit."""

    __slots__ = ("_parts",)

    def __init__(self) -> None:
        self._parts: List[np.ndarray] = []

    def add(self, rows: np.ndarray) -> None:
        if rows.size:
            self._parts.append(rows)

    def rows(self) -> np.ndarray:
        """The distinct rows, ascending (int64)."""
        if not self._parts:
            return np.empty(0, dtype=np.int64)
        self._parts = [np.unique(np.concatenate(self._parts).astype(np.int64, copy=False))]
        return self._parts[0]


class KVServer(Customer):
    """Server-side customer: routes Push/Pull to local table shards."""

    def __init__(
        self,
        post: Postoffice,
        table_cfgs: Dict[str, TableConfig],
        server_index: int,
        num_servers: int,
        *,
        name: str = "kv",
        device_replies: bool = False,
        replica: Optional[str] = None,
        replica_sync: bool = False,
        max_replica_lag: int = 8,
        replica_ack_timeout: float = 60.0,
        routing: Optional[RoutingTable] = None,
        migrate_timeout: float = 30.0,
        apply: Optional[ApplyEngineConfig] = None,
        devobs: Optional[LedgerConfig] = None,
        device: str | torch.device = "cuda",
    ) -> None:
        """``devobs``: the apply ledger's knobs; the default builds an
        enabled ledger, ``LedgerConfig(enabled=False)`` none.

        ``device_replies``: answer pulls with the gathered tensors on
        ``device`` instead of host numpy (in-process planes only).

        ``replica``: node id of a hot-standby KVServer holding the same
        shard; every applied push is forwarded to it in apply order.
        ``replica_sync=True`` is chain semantics (the worker's ack fires
        after the standby applied); ``False`` forwards asynchronously with at
        most ``max_replica_lag`` forwards in flight.  A forward not acked
        within ``replica_ack_timeout`` seconds fails the push.

        ``routing``: an explicit ownership map (default: the uniform epoch-0
        split); a post-migration table spawns a server into a rebalanced
        fleet.  ``migrate_timeout``: seconds a donor waits on each of the
        recipient's stage and install acks."""
        super().__init__(name, post)
        self.device = torch.device(device)
        self.device_replies = device_replies
        self.apply_cfg = apply or ApplyEngineConfig()
        if self.apply_cfg.dup_policy not in ("rounds", "combine"):
            raise ValueError(
                f"dup_policy must be rounds|combine, got {self.apply_cfg.dup_policy!r}"
            )
        #: device-plane observability: the ApplyLedger registers every
        #: launched device apply and retires it from its own reaper thread —
        #: the ack path only READS the level-triggered ``overloaded()`` flag
        #: (the ``__busy__`` hint), never device state.
        devobs = devobs or LedgerConfig()
        self.ledger: Optional[ApplyLedger] = (
            ApplyLedger(post.node_id, devobs) if devobs.enabled else None
        )
        self.server_index = server_index
        #: the uniform split: the legacy checkpoint's layout contract
        self.partitions = {
            t: RangePartition(cfg.rows, num_servers) for t, cfg in table_cfgs.items()
        }
        self.table_cfgs = table_cfgs
        self.routing = routing or RoutingTable.uniform(table_cfgs, num_servers)
        self._shard_maps: Dict[str, tuple] = {
            t: self._make_map(self.routing, t) for t in table_cfgs
        }
        #: per-table, per-owned-segment version clock, bumped on every
        #: push-apply touching the segment; the max over the segments a
        #: request touches is stamped into its reply (``__sver__``)
        self._seg_versions: Dict[str, np.ndarray] = {
            t: np.zeros(self._shard_maps[t][0].shape[0], dtype=np.int64)
            for t in table_cfgs
        }
        self.tables: Dict[str, KVTable] = {
            t: KVTable(
                cfg,
                rows=self.routing.tables[t].server_rows(server_index),
                # stable across processes (builtin str hash is salted)
                seed=zlib.crc32(f"{t}:{server_index}".encode()) & 0x7FFFFFFF,
                device=self.device,
            )
            for t, cfg in table_cfgs.items()
        }
        self.pushes = 0
        self.pulls = 0
        #: group-stamped pushes applied, and the member contributions they
        #: carried (``__grp__``'s ``n``): a group push is ONE apply here
        self.group_pushes = 0
        self.group_members = 0
        #: serving plane: read-only pulls answered, and their per-table
        #: server-side latency (dispatch -> reply built, readback included)
        self.ro_pulls = 0
        self.ro_hist: Dict[str, LatencyHistogram] = {
            t: LatencyHistogram() for t in table_cfgs
        }
        self.fenced_rejects = 0
        # -- consistency gate --------------------------------------------------
        #: per-gated-table live state: mode/bound start from the table's
        #: ConsistencyConfig and are retunable (``consist_set``); the clock is
        #: fed by ``__cstep__`` stamps on the receive thread
        self._consist: Dict[str, dict] = {
            t: {"cfg": cfg.consistency, "mode": cfg.consistency.mode,
                "bound": cfg.consistency.bound, "clock": FleetClock()}
            for t, cfg in table_cfgs.items()
            if cfg.consistency is not None
        }
        self.consist_defers = 0
        self.consist_releases = 0
        #: senders parked on a ``__wait__`` defer, per table: ``consist.gate``
        #: fires on a sender's first defer, ``consist.release`` when it is
        #: next admitted
        self._consist_waiting: Dict[str, set] = {t: set() for t in self._consist}
        if self._consist and hasattr(post.van, "on_incarnation_advance"):
            # a same-id restart: the dead incarnation must not wedge the minimum
            post.van.on_incarnation_advance.append(self._consist_incarnation)
        # -- durability plane --------------------------------------------------
        self.rows_migrated_in = 0
        self.rows_migrated_out = 0
        self.migration_freeze_s = 0.0
        self.migration_freeze_last_s = 0.0
        self.migrate_timeout = migrate_timeout
        #: open donor migrations: mid -> {table, lo, hi, dirty}
        self._migrations: Dict[str, dict] = {}
        #: recipient staging: mid -> {table, chunks: [(lo, hi, value, state)]},
        #: the chunks already on ``device``
        self._staging: Dict[str, dict] = {}
        #: open snapshot windows: sid -> {dirty: {table: _DirtyRows}}
        self._snapshots: Dict[str, dict] = {}
        self.ckpt_commits = 0
        self.ckpt_freeze_s = 0.0
        self.ckpt_freeze_last_s = 0.0
        self.ckpt_delta_rows = 0
        self.ckpt_delta_overflow = 0
        #: soft bound on a snapshot commit's delta (``CheckpointConfig.
        #: max_delta_rows``)
        self.ckpt_max_delta_rows = 65536
        #: basis of the ``ckpt_age_s`` gauge: construction, then every
        #: snapshot commit or restore
        self._ckpt_commit_t = time.monotonic()
        #: the donor's streaming client on ``<node>.mig``, made on first use
        self._mig: Optional[Customer] = None
        # -- hot-replica forwarding ------------------------------------------
        self.replica = replica
        self.replica_sync = replica_sync
        self.max_replica_lag = max_replica_lag
        self.replica_ack_timeout = replica_ack_timeout
        self._fwd_inflight: collections.deque = collections.deque()
        if replica is not None:
            # the primary's client role gets its OWN endpoint: waiting for
            # the standby's ack on this server's receive thread would
            # deadlock a sync chain (that thread would have to process the
            # ack).  The customer shares this server's name, so the standby
            # routes forwarded pushes into its kv handler.
            self._fwd_post = Postoffice(f"{post.node_id}.fw", post.van)
            self._fwd = Customer(name, self._fwd_post)

    # -- routing / shard maps -------------------------------------------------
    def _make_map(self, routing: RoutingTable, table: str) -> tuple:
        """``(starts, ends, locals)`` of this server's owned segments: global
        row ``g`` in segment ``i`` lives at local row ``g - starts[i] +
        locals[i]``."""
        return self._map_of(routing.tables[table].owned_segments(self.server_index))

    @staticmethod
    def _map_of(segs: List[Tuple[int, int]]) -> tuple:
        """The ``_make_map`` triple of a list of owned segments, packed
        contiguously in global order."""
        starts = np.asarray([lo for lo, _ in segs], dtype=np.int64)
        ends = np.asarray([hi for _, hi in segs], dtype=np.int64)
        locs = np.concatenate([[0], np.cumsum(ends - starts)])[:-1].astype(np.int64)
        return starts, ends, locs

    @staticmethod
    def _localize(smap: tuple, gids) -> Tuple[np.ndarray, np.ndarray]:
        """Global rows -> ``(local, owned)`` against a ``_make_map`` triple;
        ``local[i]`` is valid iff ``owned[i]``."""
        starts, ends, locs = smap
        gids = np.asarray(gids, dtype=np.int64)
        if starts.size == 0:
            return np.zeros(gids.shape, np.int64), np.zeros(gids.shape, bool)
        idx = np.searchsorted(starts, gids, side="right") - 1
        idx_c = np.clip(idx, 0, None)
        owned = (idx >= 0) & (gids >= 0) & (gids < ends[idx_c])
        return np.where(owned, gids - starts[idx_c] + locs[idx_c], 0), owned

    def _try_localize(self, table: str, gids) -> Tuple[np.ndarray, np.ndarray]:
        """Global rows -> ``(local, owned)`` against the CURRENT shard map."""
        return self._localize(self._shard_maps[table], gids)

    def _local_range(self, table: str, lo: int, hi: int) -> Optional[int]:
        """Local row of global ``lo`` when ``[lo, hi)`` lies inside one owned
        segment (so it is one contiguous slice of every plane), else None."""
        starts, ends, locs = self._shard_maps[table]
        i = int(np.searchsorted(starts, lo, side="right")) - 1
        if i < 0 or lo < starts[i] or hi > ends[i] or hi <= lo:
            return None
        return int(lo - starts[i] + locs[i])

    def _localize_request(
        self, table: str, keys
    ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        """Worker keys (sorted GLOBAL ids, pad == global rows) -> ``(local_ids
        int32, keys int64, touched_segments)``; pads map to this shard's
        trash row.  None when any real id is not owned here (the fence)."""
        grows = self.routing.tables[table].rows
        kn = np.asarray(keys, dtype=np.int64)
        out = np.full(kn.shape, self.tables[table].rows, dtype=np.int32)
        real = kn < grows
        segs = np.empty(0, dtype=np.int64)
        if real.any():
            starts, ends, locs = self._shard_maps[table]
            if starts.size == 0:
                return None
            rk = kn[real]
            idx = np.searchsorted(starts, rk, side="right") - 1
            idx_c = np.clip(idx, 0, None)
            owned = (idx >= 0) & (rk >= 0) & (rk < ends[idx_c])
            if not owned.all():
                return None
            out[real] = (rk - starts[idx_c] + locs[idx_c]).astype(np.int32)
            segs = np.unique(idx_c)
        return out, kn, segs

    def _fence_reply(self, msg: Message, why: str) -> Message:
        """Typed reject: ``__error__`` + ``__fenced__`` + the current table
        and the shard's version stamp."""
        self.fenced_rejects += 1
        flightrec.record(
            "fence.routing", node=self.post.node_id, sender=msg.sender,
            epoch=self.routing.epoch, why=why[:120],
        )
        reply = msg.reply()
        payload = {
            "__error__": why,
            FENCED_KEY: True,
            ROUTING_KEY: self.routing.to_payload(),
        }
        tname = msg.task.payload.get("table")
        if tname in self._seg_versions:
            payload["table"] = tname
            payload[VERSION_KEY] = self.version_max(tname)
        reply.task = dataclasses.replace(msg.task, payload=payload)
        return reply

    def _wait_reply(self, msg: Message, tname: str, step: int, fm: int) -> Message:
        """Typed consistency defer: the sender ran too far ahead.

        Fence-SHAPED (``__error__`` + ``__fenced__`` + the current routing
        table), so a worker without the gate retries it as a fence; workers
        with it key on ``__wait__`` first and retry on the gate budget,
        honouring ``retry_after``.  The fleet clock snapshot rides along.
        """
        st = self._consist[tname]
        self.consist_defers += 1
        waiting = self._consist_waiting[tname]
        if msg.sender not in waiting:
            waiting.add(msg.sender)
            flightrec.record(
                "consist.gate", node=self.post.node_id, sender=msg.sender,
                table=tname, step=step, fleet_min=fm, bound=int(st["bound"]),
            )
        reply = msg.reply()
        gap = step - fm - int(st["bound"])
        payload = {
            "__error__": (
                f"consistency gate ({st['mode'].value}): step {step} > "
                f"fleet_min {fm} + bound {st['bound']} on {tname!r}"
            ),
            FENCED_KEY: True,
            ROUTING_KEY: self.routing.to_payload(),
            WAIT_KEY: True,
            "clock": st["clock"].snapshot(),
            "fleet_min": fm,
            "bound": int(st["bound"]),
            "retry_after": min(0.25, 0.002 * max(1, gap)),
            "table": tname,
            VERSION_KEY: self.version_max(tname),
        }
        reply.task = dataclasses.replace(msg.task, payload=payload)
        return reply

    def _consist_incarnation(self, node_id: str, incarnation: int) -> None:
        """Van callback: a peer restarted under the same id; prune the dead
        incarnation's clock entry (the new one re-registers by
        ``consist_hello`` or its first stamped request)."""
        for st in self._consist.values():
            st["clock"].on_incarnation_advance(node_id, incarnation)

    # -- staleness version clock ----------------------------------------------
    def version_max(self, table: str) -> int:
        """Highest segment version of this shard (0 when it owns nothing)."""
        ver = self._seg_versions[table]
        return int(ver.max()) if ver.size else 0

    def _stamp_version(self, msg: Message, reply: Message, sver: int) -> Message:
        """Stamp ``__sver__`` onto a data reply, copy-on-write: the reply
        shares the request's Task, whose payload dict on a Loopback plane IS
        the sender's object, so the Task is replaced, never mutated."""
        reply.task = dataclasses.replace(
            msg.task, payload={**msg.task.payload, VERSION_KEY: sver}
        )
        return reply

    # -- host <-> device ------------------------------------------------------
    def _pinned(self, shape, dtype: torch.dtype) -> torch.Tensor:
        """A fresh host staging buffer, page-locked when the tables are on the
        card (so the upload is one asynchronous copy)."""
        return torch.empty(shape, dtype=dtype, pin_memory=self.device.type == "cuda")

    def _upload_ids(self, ids_host: np.ndarray) -> torch.Tensor:
        buf = self._pinned(ids_host.shape, torch.int32)
        buf.numpy()[...] = ids_host
        return buf.to(self.device, non_blocking=True)

    def _upload_values(self, vals, b: int, n: int, dim: int) -> torch.Tensor:
        """One request's value plane as a ``(b, dim)`` device tensor whose
        rows past ``n`` are exact zeros."""
        if isinstance(vals, torch.Tensor):
            # device-resident plane (push_device over the Loopback plane)
            vals = vals.to(self.device).reshape(n, dim)
            if b != n:
                vals = torch.cat([vals, vals.new_zeros((b - n, dim))])
            return vals.contiguous()
        # wire plane: copied (not wrapped: it may be a read-only frombuffer
        # view) into one pinned buffer, zero tail, one H2D copy
        buf = self._pinned((b, dim), torch.float32)
        arr = buf.numpy()
        arr[:n] = np.asarray(vals).reshape(n, dim)
        arr[n:] = 0.0
        return buf.to(self.device, non_blocking=True)

    def _stack_planes(
        self, table: KVTable, group: List[tuple], k: int, bm: int, tok=None
    ) -> torch.Tensor:
        """The bundle's ``(k, bm, dim)`` value stack: wire planes pack into
        ONE pinned buffer and ride a single H2D copy; device-resident planes
        stack on the device.  Pads are exact zeros either way.  ``tok``: the
        apply's ledger entry, whose host and H2D split points are marked
        here."""
        dim = table.dim
        if all(not isinstance(m.values[0], torch.Tensor) for _, m, *_ in group):
            buf = self._pinned((k, bm, dim), torch.float32)
            arr = buf.numpy()
            for i, (_, m, _, ids_np, _, _) in enumerate(group):
                n = int(ids_np.shape[0])
                arr[i, :n] = np.asarray(m.values[0]).reshape(n, dim)
                arr[i, n:] = 0.0
            if tok is not None:
                tok.mark_host()  # pinned-buffer pack done; H2D is next
            stack = buf.to(self.device, non_blocking=True)
            if tok is not None:
                tok.mark_h2d()
            return stack
        planes = [
            self._upload_values(m.values[0], bm, int(ids_np.shape[0]), dim)
            for _, m, _, ids_np, _, _ in group
        ]
        if tok is not None:
            tok.mark_host()  # device-resident planes: no host pack phase
        stack = torch.stack(planes)
        if tok is not None:
            tok.mark_h2d()
        return stack

    def _completion_handle(self, stream=None):
        """Completion handle of every apply launched so far on ``stream``:
        a blocking CUDA event recorded there (no timing; ``synchronize()``
        sleeps inside CUDA), or, on the CPU, where an apply has finished
        when it returns, the completed handle."""
        if self.device.type != "cuda":
            return COMPLETED
        event = torch.cuda.Event(blocking=True)
        event.record(stream)
        return event

    def _submit_apply(self, tok) -> None:
        """Register a launched apply with the ledger.  Its handle is recorded
        on the stream the kernels went to (this receive thread's current
        stream), after the last launch; the fallback records a fresh one on
        the same stream."""
        stream = (
            torch.cuda.current_stream(self.device) if self.device.type == "cuda" else None
        )
        self.ledger.submit(
            tok, self._completion_handle(stream), lambda: self._completion_handle(stream)
        )

    def _readback(self, tensors: List[torch.Tensor]) -> List[np.ndarray]:
        """Device rows -> numpy with ONE synchronisation for all of them."""
        if self.device.type != "cuda":
            return [t.numpy() for t in tensors]
        hosts = [torch.empty(t.shape, dtype=t.dtype, pin_memory=True) for t in tensors]
        for h, t in zip(hosts, tensors):
            h.copy_(t, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return [h.numpy() for h in hosts]

    # -- request handling -----------------------------------------------------
    def _validate_data_request(self, msg: Message):
        """Routing fence + localization for a PUSH/PULL: a fence-reject
        ``Message``, or ``(tname, ids_np, kn, segs)``.  A stamped epoch that
        disagrees is rejected with the current table rather than guessed."""
        tname = msg.task.payload["table"]
        repoch = msg.task.payload.get(ROUTING_EPOCH_KEY)
        if repoch is not None and repoch != self.routing.epoch:
            return self._fence_reply(
                msg,
                f"routing epoch mismatch: request {repoch} != "
                f"server {self.routing.epoch}",
            )
        loc = self._localize_request(tname, msg.keys)
        if loc is None:
            return self._fence_reply(
                msg,
                f"not owner: {self.post.node_id} does not own all of "
                f"{len(np.asarray(msg.keys))} requested rows of {tname!r} "
                f"at epoch {self.routing.epoch}",
            )
        # consistency gate: a stamped request on a gated table must sit
        # within ``bound`` of the fleet minimum or it is deferred.  After the
        # routing checks (a mis-routed request fences, not waits); unstamped
        # requests bypass.  Host dict/int work only.
        cstep = msg.task.payload.get(CONSIST_STEP_KEY)
        if cstep is not None and tname in self._consist:
            st = self._consist[tname]
            allowed, fm = st["clock"].gate(msg.sender, int(cstep), st["bound"])
            if not allowed:
                return self._wait_reply(msg, tname, int(cstep), fm)
            waiting = self._consist_waiting[tname]
            if msg.sender in waiting:
                waiting.discard(msg.sender)
                self.consist_releases += 1
                flightrec.record(
                    "consist.release", node=self.post.node_id, sender=msg.sender,
                    table=tname, step=int(cstep), fleet_min=fm,
                )
        ids_np, kn, segs = loc
        return tname, ids_np, kn, segs

    def _pad_ids(self, table: KVTable, ids_np: np.ndarray, b: int) -> np.ndarray:
        """Bucket-pad the per-server slice to ``b`` with trash-row ids (the
        per-server split gives arbitrary lengths; pads carry zero grads)."""
        n = int(ids_np.shape[0])
        if b == n:
            return ids_np
        padded = np.full(b, table.rows, dtype=np.int32)
        padded[:n] = ids_np
        return padded

    def _handle_push_single(
        self, msg: Message, tname: str, ids_np: np.ndarray, kn: np.ndarray,
        segs: np.ndarray,
    ) -> Message:
        table = self.tables[tname]
        n = int(ids_np.shape[0])
        b = _bucket(n)
        tok = self.ledger.begin(tname, 1, n) if self.ledger is not None else None
        ids_host = self._pad_ids(table, ids_np, b)
        if tok is not None:
            tok.mark_host()
        ids = self._upload_ids(ids_host)
        vals = self._upload_values(msg.values[0], b, n, table.dim)
        if tok is not None:
            tok.mark_h2d()
        table.push(ids, vals)
        if tok is not None:
            self._submit_apply(tok)
        return self._ack_push(msg, tname, kn, segs)

    def _ack_push(
        self, msg: Message, tname: str, kn: np.ndarray, segs: np.ndarray
    ) -> Message:
        """Post-dispatch bookkeeping + ack: the SYNC-FREE tail of every push.

        Runs after the device apply was launched and never observes it: host
        numpy bookkeeping only (no readback, no synchronisation — enforced by
        an AST test), so the ack latency is never device-apply latency.
        """
        self.pushes += 1
        cstep = msg.task.payload.get(CONSIST_STEP_KEY)
        if cstep is not None and tname in self._consist:
            # the stamped push is applied: its sender committed the step
            self._consist[tname]["clock"].commit(msg.sender, int(cstep))
        grp = msg.task.payload.get(GROUP_KEY)
        if grp is not None:
            # one apply standing for a whole group's step: count the fan-in
            self.group_pushes += 1
            self.group_members += int(grp.get("n") or 1)
        ver = self._seg_versions[tname]
        if segs.size:
            ver[segs] += 1
            sver = int(ver[segs].max())
        else:
            sver = self.version_max(tname)
        if self._migrations:
            # rows of a migrating range written after their chunk may have
            # shipped: the commit re-sends exactly these (host key arrays)
            for m in self._migrations.values():
                if m["table"] == tname:
                    m["dirty"].add(kn[(kn >= m["lo"]) & (kn < m["hi"])])
        if self._snapshots:
            # rows written during an open snapshot window go stale against
            # the segment files already written: snap_commit's delta log
            hit = kn[kn < self.routing.tables[tname].rows]
            for sn in self._snapshots.values():
                sn["dirty"].setdefault(tname, _DirtyRows()).add(hit)
        if self.replica is not None:
            # forward AFTER the local apply, in apply order (this receive
            # thread is the only writer), so the standby replays the
            # identical update sequence; a sync chain blocks here on the
            # standby's ack, never on device work
            self._forward_push(tname, msg)
        reply = self._stamp_version(msg, msg.reply(), sver)
        if self.ledger is not None and self.ledger.overloaded():
            # soft backpressure: the update WAS applied; the hint tells the
            # worker to slow down.  overloaded() is a host-side flag the
            # reaper maintains, so reading it keeps the ack sync-free;
            # _stamp_version built a fresh payload dict, so the hint cannot
            # leak into the sender's payload on a Loopback plane.
            reply.task.payload[BUSY_KEY] = True
        return reply

    def _forward_push(self, tname: str, msg: Message) -> None:
        """Forward one applied push to the standby: the worker's global ids
        and value plane as received (numpy on the wire, a tensor from
        ``push_device``), unstamped, so the standby localizes and applies
        them exactly as this server did."""
        fwd = Message(
            task=Task(TaskKind.PUSH, self._fwd.name, payload={"table": tname}),
            recver=self.replica,
            keys=msg.keys,
            values=[msg.values[0]],
        )
        ts = self._fwd.submit([fwd])
        if self.replica_sync:
            if not self._fwd.wait(ts, timeout=self.replica_ack_timeout):
                # free the stuck task before failing the push
                self._fwd.cancel(ts, "replica ack deadline")
                raise RuntimeError(f"replica {self.replica} did not ack push (sync chain)")
            self._fwd.check(ts)
        else:
            self._fwd_inflight.append(ts)
            while len(self._fwd_inflight) > self.max_replica_lag:
                old = self._fwd_inflight.popleft()
                if not self._fwd.wait(old, timeout=self.replica_ack_timeout):
                    self._fwd.cancel(old, "replica ack deadline")
                    raise RuntimeError(
                        f"replica {self.replica} lag exceeded "
                        f"{self.max_replica_lag} and oldest ack timed out"
                    )

    def flush_replica(self, timeout: float = 60.0) -> None:
        """Block until every async-forwarded push is acked by the replica."""
        while self._fwd_inflight:
            old = self._fwd_inflight.popleft()
            if not self._fwd.wait(old, timeout):
                self._fwd.cancel(old, "replica flush deadline")
                raise RuntimeError(f"replica flush: ts={old} not acked")

    def _forward_control(self, payload: dict, keys=None, values=None) -> None:
        """Chain a migration control op to the standby, synchronously: it
        rides the forwarded pushes' FIFO, so the standby changes its shard
        map after every push that preceded it here."""
        msg = Message(
            task=Task(TaskKind.CONTROL, self._fwd.name, payload=payload),
            recver=self.replica,
            keys=keys,
            values=values if values is not None else [],
        )
        ts = self._fwd.submit([msg], keep_responses=True)
        if not self._fwd.wait(ts, timeout=self.replica_ack_timeout):
            self._fwd.cancel(ts, "replica control deadline", remote=True)
            self._fwd.take_responses(ts)
            raise RuntimeError(f"replica {self.replica} did not ack {payload.get('op')!r}")
        errs = self._fwd.errors(ts)
        self._fwd.take_responses(ts)
        if errs:
            raise RuntimeError(f"replica {payload.get('op')!r} failed: " + "; ".join(errs))

    def _pull_device(
        self, msg: Message, tname: str, ids_np: np.ndarray, segs: np.ndarray,
        *, read_only: bool = False,
    ) -> Tuple[torch.Tensor, int, int]:
        """Launch the device gather; the readback is the caller's (the bundle
        path defers it to one per bundle).  ``read_only``: the serving
        plane's fast path (the JAX server's ``_pull_ro_device``), booked in
        ``ro_pulls``; a gather skips everything a write needs anyway."""
        table = self.tables[tname]
        n = int(ids_np.shape[0])
        ids = self._upload_ids(self._pad_ids(table, ids_np, _bucket(n)))
        rows = table.pull(ids)
        if read_only:
            self.ro_pulls += 1
        else:
            self.pulls += 1
        ver = self._seg_versions[tname]
        sver = int(ver[segs].max()) if segs.size else self.version_max(tname)
        return rows, n, sver

    def _reply_values(self, slices: List[torch.Tensor]) -> list:
        """Pull replies' value planes: the device rows as they are under
        ``device_replies``, else their host copies (one synchronisation)."""
        return list(slices) if self.device_replies else self._readback(slices)

    def _handle_control(self, msg: Message) -> Message:
        p = msg.task.payload
        op = p.get("op")
        if op == "save_model":
            self.save_checkpoint(p["root"], p["step"])
            return msg.reply()
        if op == "load_model":
            self.restore_checkpoint(p["root"], p["step"])
            return msg.reply()
        if op == "adopt_routing":
            self.adopt_routing(p["routing"])
            return msg.reply()
        if op and op.startswith("migrate_"):
            return self._handle_migrate(msg)
        if op and op.startswith("snap_"):
            return self._handle_snapshot(msg)
        if op == "restore_snap":
            self.restore_snapshot(p["root"], p["step"])
            return msg.reply()
        if op == "consist_hello":
            return self._handle_consist_hello(msg)
        if op == "consist_set":
            return self._handle_consist_set(msg)
        raise ValueError(f"unsupported control op {op!r}")

    def _handle_consist_hello(self, msg: Message) -> Message:
        """Register a worker in the fleet clock(s) before it trains, so a
        fast worker cannot free-run ahead of peers the clock has not seen
        yet; also the re-registration after a same-id restart."""
        p = msg.task.payload
        worker = str(p.get("worker") or msg.sender)
        inc, step = int(p.get("incarnation", 0)), int(p.get("step", 0))
        tname = p.get("table")
        for t in [tname] if tname else list(self._consist):
            if t in self._consist:
                self._consist[t]["clock"].hello(worker, inc, step)
        return msg.reply()

    def _handle_consist_set(self, msg: Message) -> Message:
        """Live retune of a gated table's mode and/or bound.  A mode flip
        recomputes the bound from the mode unless the payload pins one."""
        p = msg.task.payload
        tname = p.get("table")
        for t in [tname] if tname else list(self._consist):
            st = self._consist.get(t)
            if st is None:
                continue
            if p.get("mode") is not None:
                mode = ConsistencyMode(p["mode"])
                st["mode"] = mode
                if mode == ConsistencyMode.BSP:
                    st["bound"] = 0
                elif mode == ConsistencyMode.ASP:
                    st["bound"] = None
                else:
                    st["bound"] = int(p.get("bound", st["cfg"].max_delay))
            if p.get("bound") is not None:
                st["bound"] = int(p["bound"])
        return msg.reply()

    def handle_request(self, msg: Message) -> Message:
        if msg.task.kind == TaskKind.CONTROL:
            return self._handle_control(msg)
        v = self._validate_data_request(msg)
        if isinstance(v, Message):
            return v
        tname, ids_np, kn, segs = v
        if msg.task.kind == TaskKind.PUSH:
            return self._handle_push_single(msg, tname, ids_np, kn, segs)
        if msg.task.kind == TaskKind.PULL:
            read_only = bool(msg.task.payload.get(READ_ONLY_KEY))
            t0 = time.perf_counter()
            rows, n, sver = self._pull_device(msg, tname, ids_np, segs, read_only=read_only)
            vals = self._reply_values([rows[:n]])
            if read_only:
                self.ro_hist[tname].record(time.perf_counter() - t0)
            return self._stamp_version(msg, msg.reply(values=vals), sver)
        raise ValueError(f"unsupported task kind {msg.task.kind}")

    # -- bundle-batched apply engine ------------------------------------------
    def _error_reply(self, msg: Message, exc: Exception) -> Message:
        reply = msg.reply()
        reply.task = dataclasses.replace(
            msg.task, payload={"__error__": f"{type(exc).__name__}: {exc}"}
        )
        return reply

    def handle_request_batch(self, msgs: List[Message]) -> List[Message]:
        """Bundle-batched handling: consecutive same-table PUSHes (up to
        ``apply.apply_batch``) become ONE device apply; every PULL's readback
        is deferred to one per bundle.  A PULL, CONTROL, fence or table
        switch flushes the open PUSH run first, so each member observes
        exactly the writes before it in bundle order.  Read-only pulls
        (``__ro__``) are the exception: they do NOT flush the open push group
        (the relaxed read sees the shard as of dispatch, possibly without the
        writes riding the same bundle) and defer to their own readback.
        Failures are isolated per member, except that a grouped apply fails
        its whole group."""
        replies: List[Optional[Message]] = [None] * len(msgs)
        pulls: List[tuple] = []  # (i, msg, rows, n, sver)
        ro: List[tuple] = []  # (i, msg, tname, rows, n, sver, t0)
        group: List[tuple] = []  # (i, msg, tname, ids_np, kn, segs)

        def flush_group() -> None:
            if not group:
                return
            try:
                if len(group) == 1:
                    i, m, tname, ids_np, kn, segs = group[0]
                    replies[i] = self._handle_push_single(m, tname, ids_np, kn, segs)
                else:
                    self._apply_push_group(group, replies)
            except Exception as e:  # noqa: BLE001 — answer every member
                logging.getLogger(__name__).exception(
                    "%s: batched push apply failed (%d members)",
                    self.post.node_id, len(group),
                )
                for i, m, *_ in group:
                    replies[i] = self._error_reply(m, e)
            group.clear()

        batch_cap = max(1, self.apply_cfg.apply_batch)
        for i, msg in enumerate(msgs):
            try:
                if msg.task.kind == TaskKind.CONTROL:
                    flush_group()
                    replies[i] = self._handle_control(msg)
                    continue
                v = self._validate_data_request(msg)
                if isinstance(v, Message):
                    flush_group()  # the fence observes prior writes too
                    replies[i] = v
                    continue
                tname, ids_np, kn, segs = v
                if msg.task.kind == TaskKind.PUSH:
                    if group and (group[0][2] != tname or len(group) >= batch_cap):
                        flush_group()
                    group.append((i, msg, tname, ids_np, kn, segs))
                elif msg.task.kind == TaskKind.PULL:
                    if msg.task.payload.get(READ_ONLY_KEY):
                        # NO flush_group(): the relaxed read, see above
                        t0 = time.perf_counter()
                        rows, n, sver = self._pull_device(msg, tname, ids_np, segs,
                                                          read_only=True)
                        ro.append((i, msg, tname, rows, n, sver, t0))
                        continue
                    flush_group()  # the pull must see prior member pushes
                    rows, n, sver = self._pull_device(msg, tname, ids_np, segs)
                    pulls.append((i, msg, rows, n, sver))
                else:
                    raise ValueError(f"unsupported task kind {msg.task.kind}")
            except Exception as e:  # noqa: BLE001 — answer every member
                logging.getLogger(__name__).exception(
                    "%s: handler error for %s from %s",
                    self.post.node_id, msg.task.kind, msg.sender,
                )
                replies[i] = self._error_reply(msg, e)
        flush_group()
        self._finish_pulls(pulls, replies)
        self._finish_ro_pulls(ro, replies)
        return replies

    def _finish_pulls(self, pulls: List[tuple], replies: List) -> None:
        """Materialize deferred pull replies: ONE host readback per bundle
        (none under ``device_replies``: the rows stay on the card)."""
        if not pulls:
            return
        vals = self._reply_values([rows[:n] for _, _, rows, n, _ in pulls])
        for (i, m, _, _, sver), v in zip(pulls, vals):
            replies[i] = self._stamp_version(m, m.reply(values=[v]), sver)

    def _finish_ro_pulls(self, ro: List[tuple], replies: List) -> None:
        """Materialize deferred READ-ONLY pull replies: the bundle's other
        single readback, each member's serving latency recorded from its
        dispatch time."""
        if not ro:
            return
        vals = self._reply_values([rows[:n] for _, _, _, rows, n, _, _ in ro])
        done = time.perf_counter()
        for (i, m, tname, _, _, sver, t0), v in zip(ro, vals):
            replies[i] = self._stamp_version(m, m.reply(values=[v]), sver)
            self.ro_hist[tname].record(done - t0)

    def _apply_push_group(self, group: List[tuple], replies: List) -> None:
        """One device apply for a run of same-table PUSHes stacked as
        ``(k, bm, dim)``; cross-member duplicates follow ``dup_policy``.
        Acks then run per member in member order."""
        tname = group[0][2]
        table = self.tables[tname]
        k = len(group)
        bm = _bucket(max(int(g[3].shape[0]) for g in group))
        tok = (
            self.ledger.begin(tname, k, sum(int(g[3].shape[0]) for g in group))
            if self.ledger is not None
            else None
        )
        stack = self._stack_planes(table, group, k, bm, tok)
        # flat positions of every REAL id occurrence, in member order
        ids_list = [g[3] for g in group]
        all_ids = np.concatenate(ids_list).astype(np.int64)
        flat_pos = np.concatenate(
            [i * bm + np.arange(a.shape[0], dtype=np.int32) for i, a in enumerate(ids_list)]
        ).astype(np.int32)
        real = all_ids != table.rows
        rid = all_ids[real]
        rpos = flat_pos[real]
        if self.apply_cfg.dup_policy == "combine":
            self._push_group_combined(table, k, bm, rid, rpos, stack)
        else:
            self._push_group_rounds(table, k, bm, rid, rpos, stack)
        if tok is not None:  # one ledger entry for the whole grouped apply
            self._submit_apply(tok)
        for i, m, tname_, _, kn, segs in group:
            replies[i] = self._ack_push(m, tname_, kn, segs)

    def _push_group_rounds(
        self, table: KVTable, k: int, bm: int, rid: np.ndarray, rpos: np.ndarray,
        stack: torch.Tensor,
    ) -> None:
        """Occurrence rounds: round ``t`` applies each row's ``t``-th
        contribution in member order, so the per-row gradient sequence — and
        the result — equals sequential per-member applies bit for bit, for
        every optimizer.  Without cross-member duplicates: one device call."""
        pad_pos = k * bm  # the appended zero row
        if rid.size == 0:
            rounds = [(rid, rpos)]
        else:
            order = np.argsort(rid, kind="stable")
            sid = rid[order]
            spos = rpos[order]
            newgrp = np.empty(sid.shape, dtype=bool)
            newgrp[0] = True
            newgrp[1:] = sid[1:] != sid[:-1]
            ar = np.arange(sid.size, dtype=np.int64)
            grp_start = np.maximum.accumulate(np.where(newgrp, ar, 0))
            occ = ar - grp_start
            rounds = [(sid[occ == t], spos[occ == t]) for t in range(int(occ.max()) + 1)]
        for uids_t, pos_t in rounds:
            nt = int(uids_t.size)
            bu = _bucket(nt)
            ids_np = np.full(bu, table.rows, dtype=np.int32)
            ids_np[:nt] = uids_t.astype(np.int32)
            pos_np = np.full(bu, pad_pos, dtype=np.int32)
            pos_np[:nt] = pos_t
            table.push_batch(self._upload_ids(ids_np), self._upload_ids(pos_np), stack)

    def _push_group_combined(
        self, table: KVTable, k: int, bm: int, rid: np.ndarray, rpos: np.ndarray,
        stack: torch.Tensor,
    ) -> None:
        """Device pre-merge: duplicate rows across members segment-sum into one
        gradient row, then ONE apply (classic PS sum semantics)."""
        uids, inv_real = np.unique(rid, return_inverse=True)
        nu = int(uids.size)
        bu = _bucket(nu)
        if bu == nu and nu < k * bm:
            # every slot holds a real row but pad positions still need a
            # trash slot to sum (exact zeros) into — grow one bucket
            bu = _bucket(nu + 1)
        ids_np = np.full(bu, table.rows, dtype=np.int32)
        ids_np[:nu] = uids.astype(np.int32)
        inverse = np.full(k * bm, min(nu, bu - 1), dtype=np.int32)
        inverse[rpos] = inv_real.astype(np.int32)
        table.push_combined(self._upload_ids(ids_np), self._upload_ids(inverse), stack)

    # -- telemetry-facing reads -------------------------------------------------
    def counters(self) -> dict:
        """Fence, read-only, group and version counters, the migration and
        snapshot counters (``rows_migrated_*``, ``migration_freeze_s``,
        ``ckpt_*``), the consistency gate's totals and gauges on gated
        servers, plus the ledger's gauges and totals (``inflight_bundles``/
        ``inflight_rows``, ``backlog_age_s``, ``applies_*``),
        Dashboard-mergeable."""
        out = {
            "fenced_rejects": self.fenced_rejects,
            "ro_pulls": self.ro_pulls,
            "group_pushes": self.group_pushes,
            "group_members": self.group_members,
            "seg_version_max": sum(self.version_max(t) for t in self.tables),
            "rows_migrated_in": self.rows_migrated_in,
            "rows_migrated_out": self.rows_migrated_out,
            "migration_freeze_s": round(self.migration_freeze_s, 6),
            # seconds since this shard last committed to (or restored from)
            # a durable snapshot, commit totals and the bounded freeze
            "ckpt_age_s": round(time.monotonic() - self._ckpt_commit_t, 3),
            "ckpt_commits": self.ckpt_commits,
            "ckpt_freeze_s": round(self.ckpt_freeze_s, 6),
            "ckpt_delta_rows": self.ckpt_delta_rows,
            "ckpt_delta_overflow": self.ckpt_delta_overflow,
        }
        if self._consist:
            # defer/release totals and the first gated table's mode/bound
            first = self._consist[sorted(self._consist)[0]]
            out["consist_defers"] = self.consist_defers
            out["consist_releases"] = self.consist_releases
            out["consist_mode"] = MODE_CODES[first["mode"]]
            out["consist_bound"] = -1 if first["bound"] is None else int(first["bound"])
            out["consist_clock_size"] = sum(st["clock"].size() for st in self._consist.values())
            out["consist_pruned"] = sum(st["clock"].pruned for st in self._consist.values())
        if self.ledger is not None:
            out.update(self.ledger.counters())
        return out

    def latency_digests(self) -> Dict[str, dict]:
        """The ledger's cumulative per-table apply digests: ``apply.<t>``
        total and the ``apply_host`` / ``apply_h2d`` / ``apply_dev`` split;
        plus the read-only pull latency ``ro_pull.<t>`` of tables that
        served one."""
        out = self.ledger.latency_digests() if self.ledger is not None else {}
        for t, hist in self.ro_hist.items():
            if hist.count:
                out[f"ro_pull.{t}"] = hist.to_dict()
        return out

    # -- shard transfer ---------------------------------------------------------
    def export_shard(self) -> Dict[str, dict]:
        """Host snapshot of every table shard, value + optimizer state, in the
        JAX server's format: ``{table: {"value": np, "state": {name: np}}}``
        with ``[rows + 1, dim]`` float32 arrays (trash row included)."""
        return {
            t: {
                "value": table.value.to("cpu", copy=True).numpy(),
                "state": {
                    k: v.to("cpu", copy=True).numpy() for k, v in table.state.items()
                },
            }
            for t, table in self.tables.items()
        }

    def import_shard(self, shard: Dict[str, dict]) -> None:
        """Adopt an :meth:`export_shard` snapshot (numpy, from either package,
        or tensors) wholesale; shard shapes must match this server's."""
        for t, blob in shard_from_numpy(shard, self.device).items():
            table = self.tables[t]
            if tuple(blob["value"].shape) != (table.rows + 1, table.dim):
                raise ValueError(
                    f"shard {t!r} has shape {tuple(blob['value'].shape)}, "
                    f"server holds {(table.rows + 1, table.dim)}"
                )
            table.resize(blob["value"], blob["state"])

    # -- row export and upload ---------------------------------------------------
    def _host_rows(self, tensors: List[torch.Tensor]) -> List[np.ndarray]:
        """Host copies of row blocks of the planes (one synchronisation on the
        card); on the CPU the blocks are cloned, since they may be views of
        planes that later pushes update."""
        if self.device.type != "cuda":
            tensors = [t.clone() for t in tensors]
        return self._readback(tensors)

    def _upload_rows(self, rows) -> torch.Tensor:
        """A received ``[n, dim]`` row block as a float32 tensor of its own on
        ``device``: one pinned buffer, one asynchronous copy up."""
        if isinstance(rows, torch.Tensor):
            return rows.to(self.device, torch.float32, copy=True).contiguous()
        arr = np.asarray(rows, dtype=np.float32)
        buf = self._pinned(arr.shape, torch.float32)
        buf.numpy()[...] = arr
        return buf.to(self.device, non_blocking=True)

    def _export_rows(
        self, table: str, gids: np.ndarray
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Value and optimizer-state rows at owned GLOBAL ids, as host numpy:
        one ``ps_gather`` launch over every plane, one readback."""
        tbl = self.tables[table]
        local, owned = self._try_localize(table, gids)
        if not owned.all():
            raise ValueError(f"export of un-owned rows of {table!r} on {self.post.node_id}")
        ids = self._upload_ids(local.astype(np.int32))
        host = self._readback(scatter.gather_rows_planes([tbl.value, *tbl.state.values()], ids))
        return host[0], dict(zip(tbl.state, host[1:]))

    def export_range(
        self, table: str, lo: int, hi: int
    ) -> Tuple[np.ndarray, Dict[str, np.ndarray]]:
        """Rows ``[lo, hi)`` of ``table`` (value and state) as host numpy: a
        slice of each plane when the range lies in one owned segment, else a
        gather."""
        tbl = self.tables[table]
        a = self._local_range(table, lo, hi)
        if a is None:
            return self._export_rows(table, np.arange(lo, hi, dtype=np.int64))
        b = a + hi - lo
        host = self._host_rows([tbl.value[a:b], *(p[a:b] for p in tbl.state.values())])
        return host[0], dict(zip(tbl.state, host[1:]))

    # -- live migration ------------------------------------------------------------
    def _ensure_mig(self) -> Customer:
        """The donor's streaming client on its own endpoint ``<node>.mig``:
        stage and install acks are processed by that endpoint's receive
        thread while this server's receive thread waits in the handler."""
        if self._mig is None:
            self._mig = Customer(self.name, Postoffice(f"{self.post.node_id}.mig", self.post.van))
        return self._mig

    def _mig_rpc(self, recver: str, payload: dict, keys=None, values=None) -> Message:
        mig = self._ensure_mig()
        ts = mig.submit(
            [Message(task=Task(TaskKind.CONTROL, mig.name, payload=payload),
                     recver=recver, keys=keys, values=values)],
            keep_responses=True,
        )
        if not mig.wait(ts, timeout=self.migrate_timeout):
            mig.cancel(ts, f"migration {payload.get('op')!r} deadline", remote=True)
            mig.take_responses(ts)
            raise TimeoutError(f"{payload.get('op')!r} to {recver} timed out")
        errs = mig.errors(ts)
        responses = mig.take_responses(ts)
        if errs:
            raise RuntimeError(f"{payload.get('op')!r} to {recver} failed: " + "; ".join(errs))
        return responses[0]

    def _install_routing(self, new_routing: RoutingTable, extra: Optional[dict] = None) -> None:
        """Adopt ``new_routing``, rebuilding every table whose owned segments
        change.  ``extra``: ``{table: (where, value, state)}``, the source of
        newly adopted rows (see :meth:`_rebuild_table`).  Runs on the receive
        thread, so it is atomic with respect to pushes."""
        # files an open snapshot already wrote describe the old layout: abort
        # it, so its coordinator's commit fails and no manifest names them
        for sid in list(self._snapshots):
            del self._snapshots[sid]
            flightrec.record("ckpt.abort", node=self.post.node_id, sid=sid,
                             why="routing changed mid-snapshot")
        for t in self.tables:
            new_segs = new_routing.tables[t].owned_segments(self.server_index)
            old_segs = self.routing.tables[t].owned_segments(self.server_index)
            ex = (extra or {}).get(t)
            if new_segs != old_segs or ex is not None:
                self._rebuild_table(t, new_segs, ex)
        self.routing = new_routing
        self._shard_maps = {t: self._make_map(new_routing, t) for t in self.tables}
        # new segment layouts restart from the shard's previous maximum, so
        # the per-table version never goes backwards
        self._seg_versions = {
            t: np.full(self._shard_maps[t][0].shape[0],
                       self.version_max(t) if t in self._seg_versions else 0, dtype=np.int64)
            for t in self.tables
        }

    def _rebuild_table(self, t: str, new_segs: List[Tuple[int, int]], extra) -> None:
        """Re-pack the shard of ``t`` for a new segment layout, on ``device``.

        New planes are allocated and filled from the old shard (a slice copy
        per kept overlap) and from ``extra``: ``(lo, value, state)`` with
        ``int`` ``lo`` is a contiguous range of tensors on ``device`` (slice
        copies); ``(gids, value, state)`` are rows at arbitrary global ids
        (host arrays, written by one ``ps_scatter_set`` launch).  The old
        trash row is carried over.  A new-layout row that neither source
        covers is a protocol error, raised before anything is replaced; card
        memory peaks at the old shard plus the new one."""
        tbl = self.tables[t]
        names = list(tbl.state)
        old = [tbl.value, *(tbl.state[k] for k in names)]
        n = sum(hi - lo for lo, hi in new_segs)
        new = [torch.empty((n + 1, tbl.dim), dtype=torch.float32, device=self.device)
               for _ in old]
        for dst, src in zip(new, old):
            dst[n:].copy_(src[tbl.rows:])
        covered = np.zeros(n, dtype=bool)

        def copy_range(src_planes, src_lo: int, src_hi: int, src_local: int) -> None:
            """Slice-copy global rows ``[src_lo, src_hi)``, stored from local
            row ``src_local`` of ``src_planes``, to where the new layout has
            them."""
            at = 0
            for lo, hi in new_segs:
                a, b = max(lo, src_lo), min(hi, src_hi)
                if a < b:
                    for dst, src in zip(new, src_planes):
                        dst[at + a - lo:at + b - lo].copy_(
                            src[src_local + a - src_lo:src_local + b - src_lo])
                    covered[at + a - lo:at + b - lo] = True
                at += hi - lo

        starts, ends, locs = self._shard_maps[t]
        for s_lo, s_hi, s_loc in zip(starts.tolist(), ends.tolist(), locs.tolist()):
            copy_range(old, s_lo, s_hi, s_loc)
        if extra is not None:
            where, e_value, e_state = extra
            e_planes = [e_value, *(e_state[k] for k in names)]
            if isinstance(where, (int, np.integer)):
                copy_range(e_planes, int(where), int(where) + int(e_value.shape[0]), 0)
            else:
                new_map = self._map_of(new_segs)
                local, hit = self._localize(new_map, where)
                if hit.any():
                    sel = None if hit.all() else np.nonzero(hit)[0]
                    ids = self._upload_ids(local[hit].astype(np.int32))
                    rows = [self._upload_rows(p if sel is None else np.asarray(p)[sel])
                            for p in e_planes]
                    scatter.scatter_update_rows_planes(new, ids, rows)
                    covered[local[hit]] = True
        if n and not covered.all():
            missing = np.flatnonzero(~covered)
            raise RuntimeError(
                f"shard rebuild of {t!r} on {self.post.node_id}: {missing.size} rows "
                f"uncovered (first local: {missing[:4]})"
            )
        del old
        tbl.adopt_planes(new[0], dict(zip(names, new[1:])))

    def adopt_routing(self, routing) -> bool:
        """Adopt a broadcast routing table (a payload dict or a
        :class:`RoutingTable`) on a server the migration did not involve.
        Only a newer epoch applies, and it must not change this server's
        owned segments: content moves only through the migrate ops."""
        if isinstance(routing, dict):
            routing = RoutingTable.from_payload(routing)
        if routing.epoch <= self.routing.epoch:
            return False
        for t in self.tables:
            if (routing.tables[t].owned_segments(self.server_index)
                    != self.routing.tables[t].owned_segments(self.server_index)):
                raise ValueError(
                    f"adopt_routing would change owned segments of {t!r} on "
                    f"{self.post.node_id}; use the migration protocol"
                )
        self._install_routing(routing)
        return True

    def _handle_migrate(self, msg: Message) -> Message:
        p = msg.task.payload
        op = p["op"]
        if op == "migrate_begin":
            # donor: arm dirty tracking for [lo, hi); a fresh mid for the same
            # range supersedes a stale attempt
            mid, t, lo, hi = p["mid"], p["table"], int(p["lo"]), int(p["hi"])
            if self._local_range(t, lo, hi) is None:
                _, owned = self._try_localize(t, np.arange(lo, hi, dtype=np.int64))
                if not owned.all():
                    raise ValueError(
                        f"migrate_begin: {self.post.node_id} does not own [{lo}, {hi}) of {t!r}"
                    )
            for k in [k for k, m in self._migrations.items()
                      if (m["table"], m["lo"], m["hi"]) == (t, lo, hi)]:
                del self._migrations[k]
            self._migrations[mid] = {"table": t, "lo": lo, "hi": hi, "dirty": _DirtyRows()}
            flightrec.record("migrate.begin", node=self.post.node_id, mid=mid,
                             table=t, lo=lo, hi=hi)
            return msg.reply()
        if op == "migrate_send":
            # donor: stream one live chunk; requests queued behind this
            # handler wait one chunk, not the whole transfer
            m = self._migrations[p["mid"]]
            lo, hi = int(p["lo"]), int(p["hi"])
            flightrec.record("migrate.send", node=self.post.node_id, mid=p["mid"],
                             to=p["to"], lo=lo, hi=hi)
            value, state = self.export_range(m["table"], lo, hi)
            skeys = sorted(state)
            self._mig_rpc(
                p["to"],
                {"op": "migrate_stage", "mid": p["mid"], "table": m["table"],
                 "lo": lo, "hi": hi, "state_keys": skeys},
                values=[value] + [state[k] for k in skeys],
            )
            return msg.reply()
        if op == "migrate_stage":
            # recipient: upload the chunk now, so the install reads no host
            # copy of anything
            st = self._staging.setdefault(p["mid"], {"table": p["table"], "chunks": []})
            value = self._upload_rows(msg.values[0])
            state = {k: self._upload_rows(v) for k, v in zip(p["state_keys"], msg.values[1:])}
            st["chunks"].append((int(p["lo"]), int(p["hi"]), value, state))
            flightrec.record("migrate.stage", node=self.post.node_id, mid=p["mid"],
                             lo=int(p["lo"]), hi=int(p["hi"]))
            return msg.reply()
        if op == "migrate_commit":
            return self._commit_migration(msg)
        if op == "migrate_install":
            return self._install_migration(msg)
        if op == "migrate_adopt":
            # recipient's standby: adopt the assembled range, chained by the
            # recipient's install after every push it forwarded before
            routing = RoutingTable.from_payload(p["routing"])
            gids = np.asarray(msg.keys, dtype=np.int64)
            state = dict(zip(p["state_keys"], msg.values[1:]))
            self._install_routing(routing, extra={p["table"]: (gids, msg.values[0], state)})
            self.rows_migrated_in += int(gids.size)
            flightrec.record("migrate.adopt", node=self.post.node_id, table=p["table"],
                             rows=int(gids.size))
            return msg.reply()
        if op == "migrate_release":
            # donor's standby: drop the moved range, as its primary did
            self._install_routing(RoutingTable.from_payload(p["routing"]))
            flightrec.record("migrate.release", node=self.post.node_id, table=p["table"])
            return msg.reply()
        if op == "migrate_abort":
            self._migrations.pop(p["mid"], None)
            self._staging.pop(p["mid"], None)
            flightrec.record("migrate.abort", node=self.post.node_id, mid=p["mid"])
            return msg.reply()
        raise ValueError(f"unsupported migration op {op!r}")

    def _commit_migration(self, msg: Message) -> Message:
        """Donor commit, the freeze, bounded by the dirty delta: export the
        rows written since their chunk shipped (one gather launch), hand them
        to the recipient, which installs atomically, then shrink this shard
        and adopt the new epoch.  All on the receive thread, so no push
        interleaves; requests queued meanwhile meet the new table and fence.
        A failed install leaves the range owned and tracked here."""
        p = msg.task.payload
        m = self._migrations.pop(p["mid"])
        t0 = time.perf_counter()
        new_routing = RoutingTable.from_payload(p["routing"])
        t = m["table"]
        dirty = m["dirty"].rows()
        d_value, d_state = self._export_rows(t, dirty)
        skeys = sorted(d_state)
        try:
            self._mig_rpc(
                p["to"],
                {"op": "migrate_install", "mid": p["mid"], "table": t, "lo": m["lo"],
                 "hi": m["hi"], "state_keys": skeys, "routing": new_routing.to_payload()},
                keys=dirty,
                values=[d_value] + [d_state[k] for k in skeys],
            )
        except Exception:
            self._migrations[p["mid"]] = m  # still owned here: re-arm
            raise
        self._install_routing(new_routing)
        self.rows_migrated_out += m["hi"] - m["lo"]
        if self.replica is not None:
            self._forward_control({"op": "migrate_release", "table": t,
                                   "routing": new_routing.to_payload()})
        freeze = time.perf_counter() - t0
        self.migration_freeze_last_s = freeze
        self.migration_freeze_s += freeze
        flightrec.record(
            "migrate.commit", node=self.post.node_id, mid=p["mid"], table=t,
            rows=m["hi"] - m["lo"], dirty=int(dirty.size), epoch=new_routing.epoch,
            freeze_ms=round(1e3 * freeze, 3),
        )
        return msg.reply(values=[np.asarray([freeze], np.float64)])

    def _install_migration(self, msg: Message) -> Message:
        """Recipient install: the staged chunks (already on ``device``) are
        slice-copied into the range ``[lo, hi)``, the commit's dirty delta is
        written over them by one ``ps_scatter_set`` launch, and the range is
        slice-copied into the grown shard."""
        p = msg.task.payload
        t, lo, hi = p["table"], int(p["lo"]), int(p["hi"])
        st = self._staging.pop(p["mid"], {"chunks": []})
        tbl = self.tables[t]
        n = hi - lo
        names = sorted(tbl.state)
        planes = [torch.empty((n, tbl.dim), dtype=torch.float32, device=self.device)
                  for _ in range(1 + len(names))]
        covered = np.zeros(n, dtype=bool)
        for c_lo, c_hi, c_val, c_state in st["chunks"]:
            a, b = c_lo - lo, c_hi - lo
            for dst, src in zip(planes, [c_val, *(c_state[k] for k in names)]):
                dst[a:b].copy_(src)
            covered[a:b] = True
        d_ids = np.asarray(msg.keys if msg.keys is not None else [], dtype=np.int64)
        if d_ids.size:
            d_state = dict(zip(p["state_keys"], msg.values[1:]))
            rows = [self._upload_rows(msg.values[0]),
                    *(self._upload_rows(d_state[k]) for k in names)]
            scatter.scatter_update_rows_planes(
                planes, self._upload_ids((d_ids - lo).astype(np.int32)), rows)
            covered[d_ids - lo] = True
        if not covered.all():
            raise RuntimeError(
                f"migrate_install of {t!r}[{lo}:{hi}) on {self.post.node_id}: "
                f"{int((~covered).sum())} rows never staged"
            )
        routing = RoutingTable.from_payload(p["routing"])
        state = dict(zip(names, planes[1:]))
        self._install_routing(routing, extra={t: (lo, planes[0], state)})
        self.rows_migrated_in += n
        flightrec.record("migrate.install", node=self.post.node_id, mid=p["mid"],
                         table=t, lo=lo, hi=hi, epoch=routing.epoch)
        if self.replica is not None:
            self._forward_control(
                {"op": "migrate_adopt", "table": t, "lo": lo, "hi": hi,
                 "state_keys": names, "routing": routing.to_payload()},
                keys=np.arange(lo, hi, dtype=np.int64),
                values=self._host_rows(planes),
            )
        return msg.reply()

    # -- legacy checkpoints ----------------------------------------------------------
    def save_checkpoint(self, root: str, step: int) -> None:
        """Write this server's row range of every table (value and state) as
        a legacy uniform shard file.  A post-migration layout is refused with
        :class:`~parameter_server_tpu_torch.checkpoint.CheckpointLayoutError`:
        the format is uniform-contiguous; snapshot such a fleet with
        ``KVWorker.save_snapshot``."""
        for t, table in self.tables.items():
            part = self.partitions[t]
            lo, hi = int(part.offsets[self.server_index]), int(part.offsets[self.server_index + 1])
            segs = self.routing.tables[t].owned_segments(self.server_index)
            if segs != [seg for seg in [(lo, hi)] if seg[1] > seg[0]]:
                raise checkpoint.CheckpointLayoutError(
                    f"save_checkpoint: {self.post.node_id} owns migrated segments {segs} of "
                    f"{t!r} (uniform shard is {[(lo, hi)]}); the legacy shard-file format is "
                    "uniform-contiguous — use the partitioned durability plane "
                    "(KVWorker.save_snapshot) or drain the migration back"
                )
            checkpoint.save_shard(root, step, t, table, self.server_index,
                                  part.num_servers, lo)

    def restore_checkpoint(self, root: str, step: int) -> None:
        """Load this server's row range; the saved server count may differ."""
        for t, table in self.tables.items():
            checkpoint.restore_shard(root, step, t, table, self.server_index,
                                     self.partitions[t].num_servers)

    # -- partitioned incremental snapshots ---------------------------------------------
    def _handle_snapshot(self, msg: Message) -> Message:
        """The three-phase snapshot:

        - ``snap_begin`` arms per-table dirty tracking (``_ack_push`` appends
          host key arrays: sync-free);
        - ``snap_write`` writes ONE owned segment to its file, a slice of
          each plane copied to the host; pushes interleave between segments.
          A segment whose version clock still equals the coordinator's
          ``base_sver`` is not written: the coordinator carries the base
          entry;
        - ``snap_commit``, the only freeze: the rows dirtied since
          ``snap_begin`` (one gather launch a table) become the delta log,
          and the commit-time segment versions are stamped;
        - ``snap_abort`` drops the bookkeeping (files left behind are never
          named by a manifest; retention sweeps them).
        """
        p = msg.task.payload
        op = p["op"]
        if op == "snap_begin":
            sid = str(p["sid"])
            self._snapshots[sid] = {"dirty": {}}
            flightrec.record("ckpt.begin", node=self.post.node_id, sid=sid)
            return msg.reply()
        if op == "snap_abort":
            if self._snapshots.pop(str(p["sid"]), None) is not None:
                flightrec.record("ckpt.abort", node=self.post.node_id, sid=str(p["sid"]),
                                 why=str(p.get("why", "coordinator abort")))
            return msg.reply()
        sid = str(p["sid"])
        if sid not in self._snapshots:
            raise RuntimeError(
                f"snapshot {sid!r} is not open on {self.post.node_id} "
                "(aborted by a routing change?)"
            )
        reply = msg.reply()
        if op == "snap_write":
            t, lo, hi = p["table"], int(p["lo"]), int(p["hi"])
            starts, ends, _ = self._shard_maps[t]
            hit = np.nonzero((starts == lo) & (ends == hi))[0]
            if hit.size != 1:
                raise RuntimeError(
                    f"snap_write: {self.post.node_id} does not own segment "
                    f"{t}[{lo}:{hi}) as a whole"
                )
            cur = int(self._seg_versions[t][int(hit[0])])
            base = p.get("base_sver")
            out = {"carried": True, "sver": cur, "table": t, "lo": lo, "hi": hi}
            if base is None or int(base) != cur:
                value, state = self.export_range(t, lo, hi)
                entry = checkpoint.write_segment_file(
                    str(p["root"]), int(p["step"]), t, lo, hi, value, state)
                flightrec.record("ckpt.segment", node=self.post.node_id, sid=sid, table=t,
                                 lo=lo, hi=hi, bytes=entry["bytes"])
                out.update(carried=False, entry=entry)
            reply.task = dataclasses.replace(msg.task, payload=out)
            return reply
        if op == "snap_commit":
            return self._commit_snapshot(msg, sid)
        raise ValueError(f"unsupported snapshot op {op!r}")

    def _commit_snapshot(self, msg: Message, sid: str) -> Message:
        """``snap_commit``: export each table's dirty rows (one gather launch,
        one readback) into its delta file; stamp the segment versions."""
        p = msg.task.payload
        sn = self._snapshots.pop(sid)
        t0 = time.perf_counter()
        root, step = str(p["root"]), int(p["step"])
        deltas: List[dict] = []
        n_dirty = 0
        for t in sorted(sn["dirty"]):
            gids = sn["dirty"][t].rows()
            if not gids.size:
                continue
            value, state = self._export_rows(t, gids)
            entry = checkpoint.write_delta_file(root, step, t, self.server_index, gids,
                                                value, state)
            if entry is not None:
                deltas.append(entry)
                n_dirty += int(gids.size)
        svers = [
            [t, int(s), int(e), int(v)]
            for t in sorted(self.tables)
            for s, e, v in zip(self._shard_maps[t][0], self._shard_maps[t][1],
                               self._seg_versions[t])
        ]
        freeze = time.perf_counter() - t0
        self.ckpt_freeze_last_s = freeze
        self.ckpt_freeze_s += freeze
        self.ckpt_commits += 1
        self.ckpt_delta_rows += n_dirty
        over = n_dirty > self.ckpt_max_delta_rows
        if over:  # a soft bound: the snapshot commits, the breach is counted
            self.ckpt_delta_overflow += 1
        self._ckpt_commit_t = time.monotonic()
        flightrec.record("ckpt.commit", node=self.post.node_id, sid=sid, step=step,
                         dirty=n_dirty, freeze_ms=round(1e3 * freeze, 3), over_bound=over)
        reply = msg.reply()
        reply.task = dataclasses.replace(
            msg.task, payload={"deltas": deltas, "svers": svers, "freeze_s": freeze})
        return reply

    def restore_snapshot(self, root: str, step: int, *, adopt_routing: bool = False) -> None:
        """Point-in-time restore from a partitioned snapshot: this server
        reads the manifest and the file ranges covering the segments it owns
        under its CURRENT routing (the snapshot may come from a fleet of any
        shape), and re-seeds its segment version clock from the manifest.

        ``adopt_routing``: first adopt the manifest's routing when it is
        NEWER — a same-id restart, where the fresh server starts at the
        uniform epoch 0 but the snapshot's fleet had migrated since; without
        it the restarted server would not own its migrated segments.  A fleet
        restore (``load_snapshot``) keeps the current fleet's routing."""
        manifest = checkpoint.read_snapshot(root, step)
        if adopt_routing:
            snap_routing = RoutingTable.from_payload(manifest["routing"])
            if snap_routing.epoch > self.routing.epoch:
                # metadata only: every owned row is about to be overwritten
                # from the snapshot, which re-sizes the shard
                self.routing = snap_routing
                self._shard_maps = {t: self._make_map(snap_routing, t) for t in self.tables}
                self._seg_versions = {
                    t: np.zeros(self._shard_maps[t][0].shape[0], dtype=np.int64)
                    for t in self.tables
                }
        by_seg: Dict[Tuple[str, int, int], int] = {}
        for e in manifest["segments"]:
            key = (str(e["table"]), int(e["lo"]), int(e["hi"]))
            by_seg[key] = max(by_seg.get(key, 0), int(e.get("sver", 0)))
        for t, table in self.tables.items():
            segs = self.routing.tables[t].owned_segments(self.server_index)
            checkpoint.restore_segments(root, manifest, t, segs, table)
            ver = self._seg_versions[t]
            starts, ends, _ = self._shard_maps[t]
            for i in range(starts.shape[0]):
                lo, hi = int(starts[i]), int(ends[i])
                # exact match first; else the max over overlapping segments
                # (a restore onto another fleet shape)
                v = by_seg.get((t, lo, hi))
                if v is None:
                    v = max((sv for (tt, sl, sh), sv in by_seg.items()
                             if tt == t and sl < hi and sh > lo), default=0)
                ver[i] = max(int(ver[i]), v)
        self._ckpt_commit_t = time.monotonic()
        flightrec.record("ckpt.restore", node=self.post.node_id, step=int(step),
                         tables=len(self.tables))
