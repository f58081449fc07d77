"""Row-range partitioning of a table across servers.

The reference NodeAssigner splits the key space into contiguous ranges, one
per server, and ``Parameter::Slice`` routes each request's (keys, values) by
binary search (``src/system/assigner.h``, ``src/parameter/parameter.h`` [U]).
Here the partitioned space is the *localized row-id* space ``[0, rows)``
(plus the global trash row id ``rows``, owned by the last server as its own
local trash row).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Iterator

import numpy as np


@dataclasses.dataclass(frozen=True)
class RangePartition:
    rows: int
    num_servers: int

    @functools.cached_property
    def offsets(self) -> np.ndarray:
        """``num_servers + 1`` row offsets; server s owns [off[s], off[s+1]).

        Cached: ``slice_ids`` sits on the per-request routing hot path and
        was rebuilding the cumsum every call.  ``cached_property`` stores
        into the instance ``__dict__`` directly, so the dataclass stays
        frozen (no ``__setattr__`` involved).
        """
        base = self.rows // self.num_servers
        rem = self.rows % self.num_servers
        sizes = [base + (1 if s < rem else 0) for s in range(self.num_servers)]
        return np.cumsum([0] + sizes)

    def server_rows(self, s: int) -> int:
        off = self.offsets
        return int(off[s + 1] - off[s])

    def slice_ids(
        self, sorted_ids: np.ndarray
    ) -> Iterator[tuple[int, slice, np.ndarray]]:
        """Split sorted unique row ids into per-server segments.

        Yields ``(server, segment_slice, local_ids)`` for every server (empty
        segments included — BSP tasks expect a response from each server).
        Padded ids (== rows) fall to the last server's trash row.
        """
        off = self.offsets
        idx = np.searchsorted(sorted_ids, off[1:-1], side="left")
        bounds = np.concatenate([[0], idx, [sorted_ids.shape[0]]])
        for s in range(self.num_servers):
            seg = slice(int(bounds[s]), int(bounds[s + 1]))
            local = (sorted_ids[seg] - off[s]).astype(np.int32)
            yield s, seg, local
