"""ShardMigrator: the coordinating side of live shard migration.

Torch counterpart of ``parameter_server_tpu/kv/migrate.py`` (same control
ops, payloads and counters).  The donor keeps serving pushes while the bulk
of the range streams out:

1. ``migrate_begin`` arms dirty-row tracking on the donor for ``[lo, hi)``.
2. ``migrate_send`` x N streams fixed-size chunks donor -> recipient through
   the donor's own ``.mig`` endpoint; pushes landing between chunks are
   recorded as dirty.
3. ``migrate_commit`` is the freeze: on the donor's receive thread (atomic
   with respect to pushes) the dirty delta is exported, the recipient
   installs chunks + delta and adopts the new routing, then the donor
   shrinks.  The freeze is bounded by the delta, not the range.
4. The other servers adopt the new table (``adopt_routing``); workers
   converge off fences.

The recipient's install is acked before the donor drops its copy, so a dead
recipient never strands the range: the donor still owns it and the migration
re-runs (a fresh migration id supersedes stale staged chunks).
"""

from __future__ import annotations

import itertools
from typing import Optional

import numpy as np

from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind, server_id
from parameter_server_tpu_torch.core.postoffice import Customer, Postoffice
from parameter_server_tpu_torch.kv.routing import RoutingTable


class MigrationError(RuntimeError):
    """A migration attempt failed; ownership is unchanged (safe to retry)."""


class ShardMigrator(Customer):
    """Drives migrations against the servers' ``migrate_*`` control ops.

    One instance per coordinating process; it is a plain Customer on its
    own Postoffice (e.g. ``Postoffice("M0", van)``) speaking to the servers'
    ``kv`` customer.
    """

    def __init__(
        self,
        post: Postoffice,
        *,
        name: str = "kv",
        chunk_rows: int = 4096,
        timeout: float = 60.0,
    ) -> None:
        super().__init__(name, post)
        self.chunk_rows = chunk_rows
        self.timeout = timeout
        #: dashboard counters
        self.migrations = 0
        self.aborts = 0
        self.rows_moved = 0
        self.freeze_s_last = 0.0
        self._mid_seq = itertools.count()

    def counters(self) -> dict:
        return {
            "migrations": self.migrations,
            "migration_aborts": self.aborts,
            "rows_moved": self.rows_moved,
            # the dirty-delta-bounded commit freeze; the durability plane's
            # snapshot commit (kv/server.py snap_commit) reuses exactly this
            # dirty-tracking/bounded-freeze pattern, reported as
            # ckpt_freeze_s in the server's own counters
            "freeze_s_last": round(self.freeze_s_last, 6),
        }

    # -- low-level control RPC ------------------------------------------------
    def _rpc(self, recver: str, payload: dict) -> Message:
        ts = self.submit(
            [
                Message(
                    task=Task(TaskKind.CONTROL, self.name, payload=payload),
                    recver=recver,
                )
            ],
            keep_responses=True,
        )
        if not self.wait(ts, timeout=self.timeout):
            self.cancel(ts, f"{payload.get('op')!r} deadline", remote=True)
            self.take_responses(ts)
            raise MigrationError(f"{payload.get('op')!r} to {recver} timed out")
        errs = self.errors(ts)
        responses = self.take_responses(ts)
        if errs:
            raise MigrationError(
                f"{payload.get('op')!r} to {recver} failed: " + "; ".join(errs)
            )
        return responses[0]

    # -- the migration --------------------------------------------------------
    def migrate(
        self,
        routing: RoutingTable,
        table: str,
        lo: int,
        hi: int,
        to: int,
        *,
        sched=None,
    ) -> RoutingTable:
        """Move global rows ``[lo, hi)`` of ``table`` to server ``to``.

        The whole range must currently belong to ONE donor (split a
        multi-owner range into per-donor calls).  Returns the new routing
        table (epoch + 1); ``sched``: the scheduler's
        :class:`~parameter_server_tpu_torch.core.manager.Manager`, whose
        ``set_routing`` broadcasts the table fleet-wide (without one, workers
        converge off fences).  On failure
        both sides are aborted and :class:`MigrationError` raised —
        ownership is unchanged and the call is safe to re-run.
        """
        tr = routing.tables[table]
        if not (0 <= lo < hi <= tr.rows):
            raise ValueError(f"bad range [{lo}, {hi}) for rows={tr.rows}")
        donors = {tr.owner_of(r) for r in (lo, hi - 1)}
        donors.update(
            o
            for i, o in enumerate(tr.owners)
            if tr.offsets[i] < hi and tr.offsets[i + 1] > lo
        )
        if len(donors) != 1:
            raise ValueError(
                f"[{lo}, {hi}) of {table!r} spans donors {sorted(donors)}; "
                "migrate per-donor sub-ranges"
            )
        donor = donors.pop()
        if donor == to:
            return routing
        new_routing = routing.move(table, lo, hi, to)
        mid = (
            f"{self.post.node_id}:{table}:{lo}:{hi}:{to}:"
            f"{routing.epoch}:{next(self._mid_seq)}"
        )
        d_id, r_id = server_id(donor), server_id(to)
        try:
            self._rpc(
                d_id,
                {"op": "migrate_begin", "mid": mid, "table": table,
                 "lo": lo, "hi": hi},
            )
            for a in range(lo, hi, self.chunk_rows):
                b = min(a + self.chunk_rows, hi)
                self._rpc(
                    d_id,
                    {"op": "migrate_send", "mid": mid, "to": r_id,
                     "lo": a, "hi": b},
                )
            reply = self._rpc(
                d_id,
                {
                    "op": "migrate_commit",
                    "mid": mid,
                    "to": r_id,
                    "routing": new_routing.to_payload(),
                },
            )
            self.freeze_s_last = float(np.asarray(reply.values[0])[0])
        except MigrationError as e:
            self.aborts += 1
            flightrec.record(
                "migrate.abort", node=self.post.node_id, mid=mid,
                donor=d_id, recipient=r_id, error=str(e)[:120],
            )
            for node in (d_id, r_id):
                try:
                    self._rpc(node, {"op": "migrate_abort", "mid": mid})
                except MigrationError:
                    pass  # a dead side restarts without the stale mid anyway
            raise
        # lazily converge the rest of the fleet: non-participant servers
        # adopt eagerly here; workers adopt off their first fence (or the
        # scheduler broadcast below)
        for s in new_routing.servers():
            if s in (donor, to):
                continue
            try:
                self._rpc(
                    server_id(s),
                    {"op": "adopt_routing",
                     "routing": new_routing.to_payload()},
                )
            except MigrationError:
                pass  # fences self-heal; a dead server re-registers fresh
        if sched is not None:
            sched.set_routing(new_routing)
        self.migrations += 1
        self.rows_moved += hi - lo
        return new_routing

    def drain(
        self,
        routing: RoutingTable,
        server: int,
        *,
        sched=None,
        plan: Optional[dict] = None,
    ) -> RoutingTable:
        """Migrate EVERY range off ``server`` (the drain_down data plane).

        ``plan``: optional ``{table: target_server}``; defaults to the
        least-loaded-by-rows remaining owner per table.
        """
        for t, tr in routing.tables.items():
            for lo, hi in tr.owned_segments(server):
                if plan and t in plan:
                    target = plan[t]
                else:
                    others = [s for s in routing.servers() if s != server]
                    if not others:
                        raise MigrationError(
                            f"cannot drain {server}: no other owner"
                        )
                    target = min(
                        others, key=lambda s: routing.tables[t].server_rows(s)
                    )
                routing = self.migrate(routing, t, lo, hi, target, sched=sched)
        return routing
