"""Routing tables: which server owns which global row range.

Host-side numpy code copied from ``parameter_server_tpu/kv/routing.py``: the
wire payload keys, :class:`TableRouting` and the epoch-stamped
:class:`RoutingTable` with its request slicing (the ``Parameter::Slice``
analogue).  This slice runs the epoch-0 uniform split only; live migration
(``move``) and worker groups are not ported yet.
"""

from __future__ import annotations

import dataclasses
import functools
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
