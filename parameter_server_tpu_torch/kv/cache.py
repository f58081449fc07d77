"""HotRowCache: worker-side row cache with version-clock invalidation.

Copied from ``parameter_server_tpu/kv/cache.py`` (framework-free numpy; the
port keeps its own copy and imports nothing of the JAX package).

The serving plane turns the worker into a read-mostly model store: most
pulls hit a small popular key set (Zipfian traffic), and the staleness
plane already ships exactly the invalidation signal a cache needs for
free — every PUSH ack and PULL reply carries ``__sver__``, the owning
shard's per-segment version clock.  This module closes that loop:

- entries are keyed ``(table, global row id)`` and stamped with the
  ``__sver__`` the row was fetched at plus the server it came from;
- a per-``(table, server)`` **watermark** tracks the highest ``__sver__``
  this worker has observed from that server on ANY reply — push acks,
  pull replies and fence rejects all refresh it, so invalidation is
  piggybacked on traffic the worker already receives, never a broadcast;
- a lookup is a hit iff the entry came from the row's CURRENT owner and
  its stamp is not older than that owner's watermark.  The check is
  conservative: a write to any segment of the shard advances the shard's
  max clock and invalidates every cached row from that server, which may
  over-invalidate (a different segment was written) but can never serve a
  row staler than the watermark.

Storage is a **direct-mapped arena** per table — parallel numpy vectors
``tags`` (global row id, -1 empty), ``svers``, ``owners`` (interned
server code) and a ``rows`` matrix, indexed by ``row_id & (capacity-1)``.
That makes the serving hot path (:meth:`lookup_many`) a handful of
vectorized compares and one fancy-index gather instead of a per-key
Python loop.  Eviction is by hash collision (a new row landing on an
occupied line overwrites it), which bounds memory at ``capacity_rows``
lines per table with zero bookkeeping on the hit path; collisions cost hit
rate, never correctness.

Migration safety: entries remember their source server, so a row whose
range moved simply misses (new owner != entry server) even before the
worker clears the cache on routing-epoch adoption
(:meth:`~parameter_server_tpu_torch.kv.worker.KVWorker.adopt_routing`).

Thread safety: lookups/inserts run on serving threads while watermarks
advance on the Van receive thread (``KVWorker._on_response``); one lock
covers both.
"""

from __future__ import annotations

import threading
from typing import Dict, List, Optional, Tuple

import numpy as np

from parameter_server_tpu_torch.core import flightrec


class _Arena:
    """Per-table direct-mapped store: parallel vectors over cache lines."""

    __slots__ = ("tags", "svers", "owners", "rows")

    def __init__(self, cap: int, dim: int, dtype) -> None:
        self.tags = np.full(cap, -1, dtype=np.int64)
        self.svers = np.zeros(cap, dtype=np.int64)
        self.owners = np.zeros(cap, dtype=np.int32)
        self.rows = np.zeros((cap, dim), dtype=dtype)


class HotRowCache:
    """Bounded direct-mapped ``(table, key) -> (row, sver, server)`` cache."""

    def __init__(
        self,
        capacity_rows: int = 65536,
        *,
        node: Optional[str] = None,
        audit: bool = False,
    ) -> None:
        cap = int(capacity_rows)
        #: lines per table, rounded up to a power of two so the index is a
        #: mask (``key & (cap - 1)``) instead of a modulo
        self.capacity_rows = (
            1 << (cap - 1).bit_length() if cap > 0 else 0
        )
        self._mask = self.capacity_rows - 1
        self.node = node
        self._arenas: Dict[str, _Arena] = {}
        #: server id string -> small dense code (arena ``owners`` entries)
        self._codes: Dict[str, int] = {}
        #: table -> watermark vector indexed by server code: the highest
        #: ``__sver__`` observed from that server on any reply
        self._wm: Dict[str, np.ndarray] = {}
        self._lock = threading.Lock()
        #: dashboard counters (Dashboard/telemetry-mergeable)
        self.hits = 0
        self.misses = 0
        self.invalidations = 0
        #: bounded-staleness audit trail (tests): every HIT appends
        #: ``(table, key, entry_sver, watermark_at_serve)`` — the invariant
        #: is ``entry_sver >= watermark_at_serve`` for every record.
        self.audit: Optional[List[tuple]] = [] if audit else None

    # -- server interning -----------------------------------------------------
    def _intern(self, server: str) -> int:
        """Dense code for a server id string (lock held by caller)."""
        code = self._codes.get(server)
        if code is None:
            code = len(self._codes)
            self._codes[server] = code
        return code

    def server_code(self, server: str) -> int:
        """Public interning entry point — lets the serving path translate
        owner strings to codes once per DISTINCT owner, then compare codes
        vectorized across the whole slot batch."""
        with self._lock:
            return self._intern(server)

    def _wm_vec(self, table: str) -> np.ndarray:
        """The table's watermark-by-code vector, grown to cover every
        interned code (lock held by caller)."""
        vec = self._wm.get(table)
        n = len(self._codes)
        if vec is None:
            vec = np.zeros(max(n, 1), dtype=np.int64)
            self._wm[table] = vec
        elif vec.shape[0] < n:
            vec = np.concatenate(
                [vec, np.zeros(n - vec.shape[0], dtype=np.int64)]
            )
            self._wm[table] = vec
        return vec

    # -- watermark (the piggybacked invalidation signal) ---------------------
    def observe(self, table: str, server: str, sver: int) -> None:
        """Advance the ``(table, server)`` watermark to at least ``sver``.

        Called from the worker's reply tap for every stamped reply; a
        lower/equal stamp (reordered reply) is a no-op — the watermark is
        monotone, matching the server clock it shadows.
        """
        with self._lock:
            code = self._intern(server)
            vec = self._wm_vec(table)
            if sver > vec[code]:
                vec[code] = int(sver)

    def watermark(self, table: str, server: str) -> int:
        with self._lock:
            code = self._intern(server)
            return int(self._wm_vec(table)[code])

    # -- lookup / insert ------------------------------------------------------
    def lookup_many(
        self, table: str, slots: np.ndarray, owner_codes: np.ndarray
    ) -> Tuple[np.ndarray, Optional[np.ndarray]]:
        """Batched freshness-checked probe — the serving hot path.

        ``slots`` are global row ids (int64), ``owner_codes`` the parallel
        :meth:`server_code` of each row's CURRENT owner.  Returns
        ``(hit_mask, hit_rows)``: a boolean mask over ``slots`` and the
        cached rows for the hits in mask order (None when nothing hit).
        Semantics match per-key :meth:`lookup` — lazy eviction of
        moved/watermark-stale lines, counters, audit — but the whole batch
        costs one lock acquisition and a few vector ops.
        """
        n = int(slots.shape[0])
        with self._lock:
            ar = self._arenas.get(table)
            if ar is None or n == 0:
                self.misses += n
                return np.zeros(n, dtype=bool), None
            idx = slots & self._mask
            tags = ar.tags[idx]
            present = tags == slots
            wm = self._wm_vec(table)
            hit = present & (ar.owners[idx] == owner_codes)
            hit &= ar.svers[idx] >= wm[owner_codes]
            dead = present & ~hit
            if dead.any():
                # present but moved or watermark-stale: evict on the spot
                ar.tags[idx[dead]] = -1
                self.invalidations += int(dead.sum())
            n_hit = int(hit.sum())
            self.hits += n_hit
            self.misses += n - n_hit
            hit_rows = ar.rows[idx[hit]] if n_hit else None
            if self.audit is not None and n_hit:
                hi = idx[hit]
                for sl, sv, oc in zip(
                    slots[hit].tolist(),
                    ar.svers[hi].tolist(),
                    ar.owners[hi].tolist(),
                ):
                    self.audit.append((table, sl, sv, int(wm[oc])))
        return hit, hit_rows

    def lookup(self, table: str, key: int, owner: str):
        """The cached row for ``(table, key)`` iff still fresh, else None.

        Fresh means: cached from the row's CURRENT owner AND stamped at or
        above that owner's watermark.  A stale line is evicted on the spot
        (lazy invalidation — the watermark advance itself never walks
        lines).  Scalar convenience over :meth:`lookup_many`.
        """
        k = int(key)
        with self._lock:
            ar = self._arenas.get(table)
            if ar is None:
                self.misses += 1
                return None
            i = k & self._mask
            if int(ar.tags[i]) != k:
                self.misses += 1
                return None
            code = self._intern(owner)
            wm = int(self._wm_vec(table)[code])
            if int(ar.owners[i]) != code or int(ar.svers[i]) < wm:
                # the range moved (or the shard clock passed it): dead line
                ar.tags[i] = -1
                self.invalidations += 1
                self.misses += 1
                return None
            self.hits += 1
            if self.audit is not None:
                self.audit.append((table, k, int(ar.svers[i]), wm))
            return ar.rows[i].copy()

    def lookup_stale(self, table: str, key: int):
        """The cached row regardless of watermark/owner — the "stale" shed
        policy's degraded serve.  Returns ``(row, sver)`` or None."""
        k = int(key)
        with self._lock:
            ar = self._arenas.get(table)
            if ar is None:
                return None
            i = k & self._mask
            if int(ar.tags[i]) != k:
                return None
            return ar.rows[i].copy(), int(ar.svers[i])

    def insert(
        self, table: str, keys: np.ndarray, rows: np.ndarray,
        sver: int, server: str,
    ) -> None:
        """Cache fetched rows at the ``__sver__`` their reply carried.

        ``rows[i]`` is the value for ``keys[i]``; rows are copied into the
        arena so entries never alias a (possibly wire-view) reply buffer.
        A line holding the SAME key at a strictly fresher stamp is kept (a
        reordered stale reply must not regress the cache); a different key
        on the line is simply overwritten — collision eviction.
        """
        if self.capacity_rows <= 0:
            return
        keys = np.asarray(keys, dtype=np.int64)
        rows = np.asarray(rows)
        sver = int(sver)
        with self._lock:
            code = self._intern(server)
            ar = self._arenas.get(table)
            if ar is None:
                ar = _Arena(
                    self.capacity_rows, int(rows.shape[-1]), rows.dtype
                )
                self._arenas[table] = ar
            idx = keys & self._mask
            fresher = (ar.tags[idx] == keys) & (ar.svers[idx] > sver)
            if fresher.any():
                keep = ~fresher
                keys, idx, rows = keys[keep], idx[keep], rows[keep]
            ar.tags[idx] = keys
            ar.svers[idx] = sver
            ar.owners[idx] = code
            ar.rows[idx] = rows

    def invalidate_all(self, reason: str = "explicit") -> int:
        """Drop every entry (e.g. on routing-epoch adoption); returns the
        number dropped.  Watermarks survive — they shadow server clocks,
        which do not reset on migration (``_install_routing`` carries each
        shard's max forward)."""
        with self._lock:
            n = 0
            for ar in self._arenas.values():
                n += int((ar.tags != -1).sum())
                ar.tags.fill(-1)
            self.invalidations += n
        if n:
            flightrec.record(
                "cache.invalidate", node=self.node, n=n, reason=reason
            )
        return n

    # -- introspection --------------------------------------------------------
    def __len__(self) -> int:
        with self._lock:
            return sum(
                int((ar.tags != -1).sum()) for ar in self._arenas.values()
            )

    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def counters(self) -> dict:
        """Dashboard/telemetry-mergeable counters (+ the entries gauge)."""
        return {
            "cache_hits": self.hits,
            "cache_misses": self.misses,
            "cache_invalidations": self.invalidations,
            "cache_entries": len(self),
        }
