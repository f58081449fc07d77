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
read back once per bundle.  The push ack never waits for the device.

Not ported yet: the apply ledger, hot-row cache and read-only serving path,
replica forwarding, live migration, snapshots, the consistency gate and
request tracing.
"""

from __future__ import annotations

import dataclasses
import logging
import zlib
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch.config import ApplyEngineConfig, TableConfig
from parameter_server_tpu_torch.convert import shard_from_numpy
from parameter_server_tpu_torch.core.messages import Message, TaskKind
from parameter_server_tpu_torch.core.postoffice import Customer, Postoffice
from parameter_server_tpu_torch.kv.routing import (
    FENCED_KEY,
    ROUTING_EPOCH_KEY,
    ROUTING_KEY,
    VERSION_KEY,
    RoutingTable,
)
from parameter_server_tpu_torch.kv.table import KVTable
from parameter_server_tpu_torch.utils.keys import bucket_size


def _bucket(n: int) -> int:
    """Server-side id bucket: next power of two, >= 8."""
    return bucket_size(max(n, 1), min_bucket=8)


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
        routing: Optional[RoutingTable] = None,
        apply: Optional[ApplyEngineConfig] = None,
        device: str | torch.device = "cuda",
    ) -> None:
        super().__init__(name, post)
        self.device = torch.device(device)
        self.apply_cfg = apply or ApplyEngineConfig()
        if self.apply_cfg.dup_policy not in ("rounds", "combine"):
            raise ValueError(
                f"dup_policy must be rounds|combine, got {self.apply_cfg.dup_policy!r}"
            )
        self.server_index = server_index
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
        self.fenced_rejects = 0

    # -- routing / shard maps -------------------------------------------------
    def _make_map(self, routing: RoutingTable, table: str) -> tuple:
        """``(starts, ends, locals)`` of this server's owned segments: global
        row ``g`` in segment ``i`` lives at local row ``g - starts[i] +
        locals[i]``."""
        segs = routing.tables[table].owned_segments(self.server_index)
        starts = np.asarray([lo for lo, _ in segs], dtype=np.int64)
        ends = np.asarray([hi for _, hi in segs], dtype=np.int64)
        locs = np.concatenate([[0], np.cumsum(ends - starts)])[:-1].astype(np.int64)
        return starts, ends, locs

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
        self, table: KVTable, group: List[tuple], k: int, bm: int
    ) -> torch.Tensor:
        """The bundle's ``(k, bm, dim)`` value stack: wire planes pack into
        ONE pinned buffer and ride a single H2D copy; device-resident planes
        stack on the device.  Pads are exact zeros either way."""
        dim = table.dim
        if all(not isinstance(m.values[0], torch.Tensor) for _, m, *_ in group):
            buf = self._pinned((k, bm, dim), torch.float32)
            arr = buf.numpy()
            for i, (_, m, _, ids_np, _, _) in enumerate(group):
                n = int(ids_np.shape[0])
                arr[i, :n] = np.asarray(m.values[0]).reshape(n, dim)
                arr[i, n:] = 0.0
            return buf.to(self.device, non_blocking=True)
        planes = [
            self._upload_values(m.values[0], bm, int(ids_np.shape[0]), dim)
            for _, m, _, ids_np, _, _ in group
        ]
        return torch.stack(planes)

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
        ids = self._upload_ids(self._pad_ids(table, ids_np, b))
        vals = self._upload_values(msg.values[0], b, n, table.dim)
        table.push(ids, vals)
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
        ver = self._seg_versions[tname]
        if segs.size:
            ver[segs] += 1
            sver = int(ver[segs].max())
        else:
            sver = self.version_max(tname)
        return self._stamp_version(msg, msg.reply(), sver)

    def _pull_device(
        self, msg: Message, tname: str, ids_np: np.ndarray, segs: np.ndarray
    ) -> Tuple[torch.Tensor, int, int]:
        """Launch the device gather; the readback is the caller's (the bundle
        path defers it to one per bundle)."""
        table = self.tables[tname]
        n = int(ids_np.shape[0])
        ids = self._upload_ids(self._pad_ids(table, ids_np, _bucket(n)))
        rows = table.pull(ids)
        self.pulls += 1
        ver = self._seg_versions[tname]
        sver = int(ver[segs].max()) if segs.size else self.version_max(tname)
        return rows, n, sver

    def _handle_control(self, msg: Message) -> Message:
        # the in-process learners keep their barrier in ConsistencyController;
        # no server control op is ported yet
        raise ValueError(f"unsupported control op {msg.task.payload.get('op')!r}")

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
            rows, n, sver = self._pull_device(msg, tname, ids_np, segs)
            host = self._readback([rows[:n]])[0]
            return self._stamp_version(msg, msg.reply(values=[host]), sver)
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
        exactly the writes before it in bundle order.  Failures are isolated
        per member, except that a grouped apply fails its whole group."""
        replies: List[Optional[Message]] = [None] * len(msgs)
        pulls: List[tuple] = []  # (i, msg, rows, n, sver)
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
        return replies

    def _finish_pulls(self, pulls: List[tuple], replies: List) -> None:
        """Materialize deferred pull replies: ONE host readback per bundle."""
        if not pulls:
            return
        host = self._readback([rows[:n] for _, _, rows, n, _ in pulls])
        for (i, m, _, _, sver), h in zip(pulls, host):
            replies[i] = self._stamp_version(m, m.reply(values=[h]), sver)

    def _apply_push_group(self, group: List[tuple], replies: List) -> None:
        """One device apply for a run of same-table PUSHes stacked as
        ``(k, bm, dim)``; cross-member duplicates follow ``dup_policy``.
        Acks then run per member in member order."""
        tname = group[0][2]
        table = self.tables[tname]
        k = len(group)
        bm = _bucket(max(int(g[3].shape[0]) for g in group))
        stack = self._stack_planes(table, group, k, bm)
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
