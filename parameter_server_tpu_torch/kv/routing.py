"""Routing tables: which server owns which global row range.

Host-side numpy code copied from ``parameter_server_tpu/kv/routing.py``: the
wire payload keys, :class:`WorkerGroup` (group membership and the
deterministic per-``(table, step)`` leader election), :class:`TableRouting`
and the epoch-stamped :class:`RoutingTable` with its request slicing (the
``Parameter::Slice`` analogue) and its wire form, which fence replies carry
and workers adopt (highest epoch wins); and the rewrites live migration
makes (``move``: split at the range's bounds, reassign, coalesce, epoch + 1)
with the queries the durability plane iterates (``segments``,
``owner_of``).
"""

from __future__ import annotations

import bisect
import dataclasses
import functools
import zlib
from typing import Dict, Iterator, List, Tuple

import numpy as np

#: Task.payload key: routing epoch stamped by workers on every PUSH/PULL.
ROUTING_EPOCH_KEY = "__repoch__"
#: reply payload key: serialized RoutingTable riding a fence reject.
ROUTING_KEY = "__routing__"
#: reply payload key: marks a typed fence reject (wrong epoch / not owner).
FENCED_KEY = "__fenced__"
#: reply payload key: server-side segment version clock stamped onto PUSH
#: acks and PULL replies (max over the segments the request touched).
VERSION_KEY = "__sver__"
#: reply payload key: soft-backpressure hint on PUSH acks (apply ledger).
BUSY_KEY = "__busy__"
#: request payload key: marks a PULL as read-only serving traffic.
READ_ONLY_KEY = "__ro__"
#: request payload key: hierarchical-push group stamp.
GROUP_KEY = "__grp__"
#: request payload key: the sender's committed step (consistency gate).
CONSIST_STEP_KEY = "__cstep__"
#: reply payload key: typed consistency defer.
WAIT_KEY = "__wait__"


@dataclasses.dataclass(frozen=True)
class WorkerGroup:
    """Membership + deterministic per-step leader election.

    A group is the static set of co-located workers that pre-reduce their
    PUSH value planes before the wire.  :meth:`leader` is a pure function of
    ``(table, step, salt)``, so every member computes the same answer with
    no coordination; under ``"rotate"`` the pushing leg rotates per step,
    de-phased per table by a crc32 offset.  ``salt`` > 0 re-elects
    deterministically (a fenced leader hands its retry to the next member).
    """

    members: Tuple[str, ...]
    #: "rotate" (per-(table, step) rotation) or "fixed" (always member 0
    #: until salted)
    election: str = "rotate"

    def __post_init__(self) -> None:
        if not self.members:
            raise ValueError("a worker group needs at least one member")
        if len(set(self.members)) != len(self.members):
            raise ValueError(f"duplicate group members: {self.members}")
        if self.election not in ("rotate", "fixed"):
            raise ValueError(f"election must be rotate|fixed, got {self.election!r}")

    @property
    def size(self) -> int:
        return len(self.members)

    @property
    def gid(self) -> str:
        """Stable group id (member-derived; stamped onto group frames)."""
        return "+".join(self.members)

    def leader(self, table: str, step: int, salt: int = 0) -> str:
        """The member elected to push ``table``'s reduced tensor at
        ``step``; ``salt`` > 0 deterministically re-elects (fence retry)."""
        if self.election == "fixed" and salt == 0:
            return self.members[0]
        idx = (zlib.crc32(table.encode()) + int(step) + int(salt)) % len(self.members)
        return self.members[idx]


@dataclasses.dataclass(frozen=True)
class TableRouting:
    """One table's ownership map: ``owners[i]`` owns ``[offsets[i],
    offsets[i+1])`` of the global row space ``[0, rows)``.  The trash row
    (global id == ``rows``) is owned by the LAST segment's owner."""

    rows: int
    offsets: Tuple[int, ...]
    owners: Tuple[int, ...]

    def __post_init__(self) -> None:
        off, own = self.offsets, self.owners
        if len(off) != len(own) + 1:
            raise ValueError(f"offsets/owners length mismatch: {off} / {own}")
        if not own:
            raise ValueError("a table needs at least one segment")
        if off[0] != 0 or off[-1] != self.rows:
            raise ValueError(f"offsets must span [0, {self.rows}): {off}")
        if any(b <= a for a, b in zip(off, off[1:])):
            raise ValueError(f"offsets must be strictly increasing: {off}")
        if any(s < 0 for s in own):
            raise ValueError(f"owners must be non-negative: {own}")

    @functools.cached_property
    def _off(self) -> np.ndarray:
        return np.asarray(self.offsets, dtype=np.int64)

    @classmethod
    def uniform(cls, rows: int, num_servers: int) -> "TableRouting":
        """The even contiguous split (RangePartition-compatible)."""
        base, rem = divmod(rows, num_servers)
        sizes = [base + (1 if s < rem else 0) for s in range(num_servers)]
        # zero-row servers own no segment (tiny tables on big fleets)
        offsets, owners = [0], []
        for s, size in enumerate(sizes):
            if size > 0:
                owners.append(s)
                offsets.append(offsets[-1] + size)
        return cls(rows, tuple(offsets), tuple(owners))

    def owned_segments(self, server: int) -> List[Tuple[int, int]]:
        """``[(lo, hi), ...]`` global ranges owned by ``server``, in order."""
        return [
            (int(self.offsets[i]), int(self.offsets[i + 1]))
            for i, o in enumerate(self.owners)
            if o == server
        ]

    def server_rows(self, server: int) -> int:
        return sum(hi - lo for lo, hi in self.owned_segments(server))

    def distinct_owners(self) -> Tuple[int, ...]:
        return tuple(sorted(set(self.owners)))

    def segments(self) -> List[Tuple[int, int, int]]:
        """All segments as ``[(lo, hi, owner), ...]`` in row order: the
        partitioned snapshot writes one file per entry, by its owner."""
        return [
            (int(self.offsets[i]), int(self.offsets[i + 1]), int(o))
            for i, o in enumerate(self.owners)
        ]

    def owner_of(self, row: int) -> int:
        """Owner of global ``row``; the trash row (== rows) maps to the last
        segment's owner."""
        if row >= self.rows:
            return self.owners[-1]
        return self.owners[bisect.bisect_right(self.offsets, row) - 1]

    def move(self, lo: int, hi: int, to: int) -> "TableRouting":
        """Reassign global rows ``[lo, hi)`` to server ``to``: split the
        segments at the range's bounds, then coalesce adjacent segments of
        one owner, so two moves that land on the same ownership compare
        equal."""
        if not (0 <= lo < hi <= self.rows):
            raise ValueError(f"bad range [{lo}, {hi}) for rows={self.rows}")
        bounds = sorted(set(self.offsets) | {lo, hi})
        offsets, owners = [0], []
        for a, b in zip(bounds, bounds[1:]):
            o = to if lo <= a < hi else self.owner_of(a)
            if owners and o == owners[-1]:
                offsets[-1] = b  # coalesce with the previous segment
            else:
                owners.append(o)
                offsets.append(b)
        return TableRouting(self.rows, tuple(offsets), tuple(owners))


@dataclasses.dataclass(frozen=True)
class RoutingTable:
    """Epoch-stamped ownership maps for every registered table."""

    epoch: int
    tables: Dict[str, TableRouting]

    @classmethod
    def uniform(cls, table_cfgs, num_servers: int, *, epoch: int = 0):
        """Epoch-0 table: ``table_cfgs`` is ``{name: TableConfig}`` (anything
        with ``.rows``) or ``{name: rows}``."""
        tables = {
            t: TableRouting.uniform(int(getattr(cfg, "rows", cfg)), num_servers)
            for t, cfg in table_cfgs.items()
        }
        return cls(epoch, tables)

    def servers(self) -> Tuple[int, ...]:
        """Sorted distinct owners across all tables (the control-op
        broadcast set)."""
        out: set = set()
        for tr in self.tables.values():
            out.update(tr.owners)
        return tuple(sorted(out))

    def move(self, table: str, lo: int, hi: int, to: int) -> "RoutingTable":
        """A new table at ``epoch + 1`` with ``[lo, hi)`` of ``table`` owned
        by ``to``."""
        tables = dict(self.tables)
        tables[table] = tables[table].move(lo, hi, to)
        return RoutingTable(self.epoch + 1, tables)

    def slice_ids(
        self, table: str, sorted_ids: np.ndarray
    ) -> Iterator[Tuple[int, np.ndarray, np.ndarray]]:
        """Split sorted global row ids by owning server.

        Yields ``(server, positions, ids)`` for EVERY distinct owner (empty
        included — BSP tasks expect a response per server); ``positions``
        index ``sorted_ids``; pad ids (== rows) ride with the last owner.
        """
        tr = self.tables[table]
        n = sorted_ids.shape[0]
        cut = np.searchsorted(sorted_ids, tr._off[1:-1], side="left")
        bounds = np.concatenate([[0], cut, [n]])
        per_owner: Dict[int, list] = {o: [] for o in tr.owners}
        for i, o in enumerate(tr.owners):
            a, b = int(bounds[i]), int(bounds[i + 1])
            if b > a:
                per_owner[o].append(np.arange(a, b, dtype=np.int64))
        for o in sorted(per_owner):
            segs = per_owner[o]
            pos = np.concatenate(segs) if segs else np.empty(0, dtype=np.int64)
            yield o, pos, sorted_ids[pos]

    # -- wire form -----------------------------------------------------------
    def to_payload(self) -> dict:
        return {
            "epoch": int(self.epoch),
            "tables": {
                t: {
                    "rows": int(tr.rows),
                    "offsets": [int(x) for x in tr.offsets],
                    "owners": [int(x) for x in tr.owners],
                }
                for t, tr in self.tables.items()
            },
        }

    @classmethod
    def from_payload(cls, payload: dict) -> "RoutingTable":
        tables = {
            t: TableRouting(
                int(blob["rows"]),
                tuple(int(x) for x in blob["offsets"]),
                tuple(int(x) for x in blob["owners"]),
            )
            for t, blob in payload["tables"].items()
        }
        return cls(int(payload["epoch"]), tables)
