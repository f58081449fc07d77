"""Key localization: global 64-bit feature keys -> dense local row ids.

Host-side numpy code, copied from ``parameter_server_tpu/utils/keys.py`` (the
port imports nothing of the JAX package) so slot assignments match it bit
for bit: the hash mixes, power-of-two bucketing, per-batch dedup
(:func:`localize_batch`), the full key -> unique-slot pipeline
(:func:`localize_to_slots`), the deterministic :class:`HashLocalizer` /
:class:`IdentityLocalizer`, the growing :class:`Localizer` with both of its
engines (the C++ keymap of ``native/src/keymap.cc``, built with g++ at first
use, and the windowed numpy probe that stands in where no toolchain is
found), and ``localizer_meta`` / ``localizer_from_meta``.
"""

from __future__ import annotations

from typing import Tuple

import numpy as np

#: Sentinel padding key: never a valid feature key. Padded rows scatter into a
#: dedicated trash row on device (see ops.scatter), so no masking is needed on
#: the hot path.
PAD_KEY = np.uint64(0xFFFFFFFFFFFFFFFF)

_MIX_MUL = np.uint64(0xFF51AFD7ED558CCD)
_MIX_MUL2 = np.uint64(0xC4CEB9FE1A85EC53)


def mix64(x: np.ndarray, seed: int | np.uint64 = 0) -> np.ndarray:
    """splitmix64-style avalanche mix, vectorized over uint64 arrays."""
    x = np.asarray(x, dtype=np.uint64)
    with np.errstate(over="ignore"):
        x = (x ^ np.uint64(seed)) * _MIX_MUL
        x ^= x >> np.uint64(33)
        x *= _MIX_MUL2
        x ^= x >> np.uint64(33)
    return x


#: murmur3 fmix32 constants — the 32-bit avalanche used when hashing happens
#: ON DEVICE (``models/linear.py``'s ``mix32_torch`` hashes 32-bit keys with
#: them, so host and device slot assignments agree).
MIX32_A = 0x85EB_CA6B
MIX32_B = 0xC2B2_AE35

#: uint32 image of PAD_KEY under truncation; reserved on the device-hash
#: path (keys must be < 2**32 - 1 there).
PAD_KEY32 = np.uint32(0xFFFF_FFFF)


def mix32(x: np.ndarray, seed: int | np.uint32 = 0) -> np.ndarray:
    """murmur3 fmix32 avalanche, vectorized over uint32 arrays.

    Host twin of the device-side 32-bit hash: both produce identical slot
    assignments, so host preprocessing and device hashing interoperate.
    """
    x = np.asarray(x, dtype=np.uint32)
    with np.errstate(over="ignore"):
        x = x ^ np.uint32(seed)
        x ^= x >> np.uint32(16)
        x *= np.uint32(MIX32_A)
        x ^= x >> np.uint32(13)
        x *= np.uint32(MIX32_B)
        x ^= x >> np.uint32(16)
    return x


def ensure_uint32_keys(keys: np.ndarray) -> np.ndarray:
    """Validate raw-width keys for the device-hash path; return them uint32.

    The device-hash trainer truncates keys to uint32, so keys ``>= 2**32-1``
    would silently wrap (or alias :data:`PAD_KEY32` and route to the trash
    row), corrupting training with no error.  This enforces the documented
    "< 2**32 - 1 unless PAD" contract: callers pass keys at their RAW width
    (a caller-side ``astype(np.uint32)`` would wrap bad keys before the
    check can see them — ADVICE r2), and this returns the validated uint32
    array.  Already-uint32 input passes through untouched (the width itself
    is the proof).  Shared by ``LocalLRTrainer.step_block`` and the prefetch
    producer so pipelined ingest keeps the same guard.
    """
    keys = np.asarray(keys)
    if keys.dtype == np.uint32:
        return keys
    kb = keys.astype(np.uint64)  # signed -1 coerces to PAD_KEY
    # cheap scalar early-out: only blocks containing a suspicious key
    # (>= uint32 max; PAD_KEY itself is uint64 max) pay for the mask
    if int(kb.max(initial=0)) >= 0xFFFF_FFFF:
        bad = (kb != PAD_KEY) & (kb >= np.uint64(0xFFFF_FFFF))
        if bad.any():
            raise ValueError(
                "device-hash keys must be < 2**32 - 1 "
                f"(or PAD_KEY); got {int(kb[bad][0])}"
            )
    return kb.astype(np.uint32)


def bucket_size(n: int, *, min_bucket: int = 256) -> int:
    """Round ``n`` up to the next power-of-two bucket (>= min_bucket).

    Bucketing the number of unique keys per batch keeps jit cache size
    logarithmic in batch size instead of recompiling per distinct count.
    """
    if n <= min_bucket:
        return min_bucket
    return 1 << int(np.ceil(np.log2(n)))


def localize_batch(
    keys: np.ndarray, *, pad_to_bucket: bool = True, min_bucket: int = 256
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Deduplicate a batch of global keys.

    Args:
      keys: int/uint array of global feature keys, any shape; flattened.
      pad_to_bucket: pad the unique-key array with :data:`PAD_KEY` up to a
        power-of-two bucket so downstream jit sees few distinct shapes.

    Returns:
      ``(unique_keys, inverse, n_unique)`` where ``unique_keys`` is sorted
      (padded with PAD_KEY at the tail if requested), ``inverse`` maps each
      input position to its row in ``unique_keys``, and ``n_unique`` is the
      true (unpadded) unique count.

    The sortedness of ``unique_keys`` is what lets the server side slice by
    key range with binary search (reference ``Parameter::Slice`` [U]).
    """
    # Keys are uint64 by contract; coerce signed parser output so PAD_KEY
    # padding cannot wrap to -1 and break the sortedness invariant.
    flat = np.ascontiguousarray(keys).ravel().astype(np.uint64, copy=False)
    uniq, inverse = np.unique(flat, return_inverse=True)
    n_unique = int(uniq.shape[0])
    if pad_to_bucket:
        cap = bucket_size(n_unique, min_bucket=min_bucket)
        if cap > n_unique:
            pad = np.full(cap - n_unique, PAD_KEY, dtype=uniq.dtype)
            uniq = np.concatenate([uniq, pad])
    return uniq, inverse.astype(np.int32), n_unique


def localize_to_slots(
    keys: np.ndarray, localizer, *, min_bucket: int = 256
) -> Tuple[np.ndarray, np.ndarray, int]:
    """Full host-side key pipeline: raw keys -> unique row slots + inverse.

    Composes :func:`localize_batch` with :meth:`Localizer.assign` and then
    re-uniquifies the *slots* (after vocabulary overflow two distinct keys may
    hash-share a slot; the device requires unique ids for the scatter fast
    path).  Returns ``(slots, inverse, n)``: sorted unique slot ids padded to
    a power-of-two bucket (pads point at the trash row ``capacity``),
    position->slot-row inverse, and the true unique-slot count.
    """
    uniq, key_inv, _ = localize_batch(
        keys, pad_to_bucket=False, min_bucket=min_bucket
    )
    raw_slots = localizer.assign(uniq)
    uniq_slots, slot_inv = np.unique(raw_slots, return_inverse=True)
    n = int(uniq_slots.shape[0])
    cap = bucket_size(n, min_bucket=min_bucket)
    if cap > n:
        uniq_slots = np.concatenate(
            [uniq_slots, np.full(cap - n, localizer.capacity, dtype=uniq_slots.dtype)]
        )
    inverse = slot_inv[key_inv].astype(np.int32)
    return uniq_slots.astype(np.int32, copy=False), inverse, n


class HashLocalizer:
    """Stateless deterministic key -> slot mapping (the hashing trick).

    Multi-worker training requires every worker to map a global key to the
    *same* table row without coordination; a deterministic hash provides that
    (at the cost of collisions, which :func:`localize_to_slots` tolerates by
    re-uniquifying slots).  This is the standard large-vocabulary CTR/DLRM
    scheme and the multi-worker counterpart of :class:`Localizer`.
    """

    def __init__(self, capacity: int, seed: int = 0, hash_bits: int = 64):
        if not (0 < capacity < 2**31 - 1):
            raise ValueError(
                "capacity must fit int32 row ids (shard billion-row tables "
                "across servers / mesh axes instead)"
            )
        if hash_bits not in (32, 64):
            raise ValueError("hash_bits must be 32 or 64")
        self.capacity = capacity
        self.seed = seed
        #: 32 = murmur fmix32 on truncated keys, matching the device-side
        #: 32-bit hash; keys must fit
        #: uint32 for collision behavior to stay key-space-uniform.
        self.hash_bits = hash_bits
        self.overflowed = True  # collisions always possible

    def assign(self, unique_keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(unique_keys, dtype=np.uint64)
        if self.hash_bits == 32:
            slots = (
                mix32(keys.astype(np.uint32), np.uint32(self.seed))
                % np.uint32(self.capacity)
            ).astype(np.int32)
        else:
            slots = (
                mix64(keys, self.seed) % np.uint64(self.capacity)
            ).astype(np.int32)
        return np.where(keys == PAD_KEY, np.int32(self.capacity), slots)


class IdentityLocalizer:
    """Exact key == row-slot mapping for dense-vocabulary tables.

    Embedding tables (token id -> row) need every id to hit ITS OWN row —
    hashing would collide distinct tokens.  Keys must already be dense ids
    in ``[0, capacity)``; PAD_KEY maps to the trash row ``capacity``.
    """

    def __init__(self, capacity: int):
        if not (0 < capacity < 2**31 - 1):
            raise ValueError("capacity must fit int32 row ids")
        self.capacity = capacity
        self.overflowed = False

    def assign(self, unique_keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(unique_keys, dtype=np.uint64)
        is_pad = keys == PAD_KEY
        # only PAD may reach the trash row (== capacity); a real key equal to
        # capacity must error, not silently alias pad updates
        bad = ~is_pad & (keys >= np.uint64(self.capacity))
        if bad.any():
            raise ValueError(
                f"IdentityLocalizer: key {int(keys[bad][0])} outside [0, "
                f"{self.capacity}) (dense-vocab tables take raw ids)"
            )
        return np.where(
            is_pad, np.int64(self.capacity), keys.astype(np.int64)
        ).astype(np.int32)


class _NativeKeyMap:
    """ctypes wrapper around the C++ keymap (``native/src/keymap.cc``)."""

    def __init__(self, lib, capacity: int) -> None:
        self._lib = lib
        self._h = lib.ps_keymap_new(capacity)
        if not self._h:
            raise MemoryError("ps_keymap_new failed")

    def assign(self, flat_keys: np.ndarray) -> np.ndarray:
        import ctypes

        flat_keys = np.ascontiguousarray(flat_keys, dtype=np.uint64)
        out = np.empty(flat_keys.shape[0], dtype=np.int32)
        self._lib.ps_keymap_assign(
            self._h,
            flat_keys.ctypes.data_as(ctypes.POINTER(ctypes.c_uint64)),
            flat_keys.shape[0],
            out.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        )
        return out

    def len(self) -> int:
        return int(self._lib.ps_keymap_len(self._h))

    def overflowed(self) -> bool:
        return bool(self._lib.ps_keymap_overflowed(self._h))

    def __del__(self) -> None:  # pragma: no cover — interpreter teardown
        h, self._h = getattr(self, "_h", None), None
        if h:
            try:
                self._lib.ps_keymap_free(h)
            except Exception:
                pass


def _native_keymap(capacity: int):
    """Load the native keymap engine, or None (numpy fallback)."""
    import ctypes

    from parameter_server_tpu_torch import native

    lib = native.load("keymap")
    if lib is None:
        return None
    if not getattr(lib, "_ps_keymap_sigs", False):
        lib.ps_keymap_new.argtypes = [ctypes.c_int64]
        lib.ps_keymap_new.restype = ctypes.c_void_p
        lib.ps_keymap_free.argtypes = [ctypes.c_void_p]
        lib.ps_keymap_len.argtypes = [ctypes.c_void_p]
        lib.ps_keymap_len.restype = ctypes.c_int64
        lib.ps_keymap_overflowed.argtypes = [ctypes.c_void_p]
        lib.ps_keymap_assign.argtypes = [
            ctypes.c_void_p,
            ctypes.POINTER(ctypes.c_uint64),
            ctypes.c_int64,
            ctypes.POINTER(ctypes.c_int32),
        ]
        lib._ps_keymap_sigs = True
    return _NativeKeyMap(lib, capacity)


class Localizer:
    """Persistent global-key -> stable dense row-slot mapping.

    Streaming learners (async SGD / FTRL over an unbounded key stream) need a
    key to map to the *same* table row every time so its optimizer state
    accumulates.  The reference keeps this in the server's hash map
    (``src/parameter/kv_map.h`` :: ``KVMap`` [U]); here the table is a fixed
    ``[capacity + 1, dim]`` tensor in device memory, so the hash lives on the
    host and hands the device dense row ids.

    When the vocabulary overflows ``capacity``, new keys hash-share rows
    (feature hashing) rather than erroring — matching large-scale CTR practice
    and the reference's countmin-based tail filtering spirit.

    The mapping is a flat open-addressing hash table (linear probing, load
    factor <= 1/2) with two interchangeable engines: the native C++ one
    (``native/src/keymap.cc``, the reference's KVMap/Localizer analogue —
    ~10-20x the old per-key dict loop) and a vectorized numpy fallback
    (windowed batch probing) for toolchain-less hosts.  A per-key Python
    dict loop is the host bottleneck at Criteo batch rates.  Both engines
    hand out the same slots as the JAX package's, bit for bit.
    """

    #: empty bucket sentinel in the probe table (PAD_KEY never enters it —
    #: assign() short-circuits pads to the trash row first).
    _EMPTY = PAD_KEY
    #: probe window: each vectorized round inspects W consecutive buckets
    #: per key, so a linear-probe cluster walk of length L costs ceil(L/W)
    #: rounds instead of L (rounds are the Python-level cost).
    _W = 8

    def __init__(self, capacity: int):
        if not (0 < capacity < 2**31 - 1):
            raise ValueError("capacity must be positive and fit int32 row ids")
        self.capacity = capacity
        self._native = _native_keymap(capacity)
        if self._native is None:
            self._size = 1 << 16
            self._tkeys = np.full(self._size, self._EMPTY, dtype=np.uint64)
            self._tvals = np.zeros(self._size, dtype=np.int32)
        self._n = 0
        self._overflowed = False

    def __len__(self) -> int:
        if self._native is not None:
            return self._native.len()
        return self._n

    @property
    def overflowed(self) -> bool:
        if self._native is not None:
            return self._native.overflowed()
        return self._overflowed

    def _lookup(self, keys: np.ndarray) -> np.ndarray:
        """Vectorized windowed probe: slot for each key, -1 where absent."""
        mask = np.int64(self._size - 1)
        offs = np.arange(self._W, dtype=np.int64)
        pos = (mix64(keys) & np.uint64(mask)).astype(np.int64)
        vals = np.full(keys.shape[0], -1, dtype=np.int32)
        active = np.arange(keys.shape[0])
        while active.size:
            win = (pos[active][:, None] + offs) & mask  # [n, W]
            cur = self._tkeys[win]
            hit = cur == keys[active][:, None]
            stop = hit | (cur == self._EMPTY)  # absent iff EMPTY before hit
            stopped = stop.any(axis=1)
            first = stop.argmax(axis=1)
            rows = np.nonzero(stopped)[0]
            is_hit = hit[rows, first[rows]]
            hrows = rows[is_hit]
            vals[active[hrows]] = self._tvals[win[hrows, first[hrows]]]
            cont = active[~stopped]
            pos[cont] = (pos[cont] + self._W) & mask
            active = cont
        return vals

    def _insert(self, keys: np.ndarray, vals: np.ndarray) -> None:
        """Vectorized insert of NEW unique keys (callers grow first)."""
        mask = np.int64(self._size - 1)
        offs = np.arange(self._W, dtype=np.int64)
        pos = (mix64(keys) & np.uint64(mask)).astype(np.int64)
        remaining = np.arange(keys.shape[0])
        while remaining.size:
            win = (pos[remaining][:, None] + offs) & mask
            empty = self._tkeys[win] == self._EMPTY
            has_empty = empty.any(axis=1)
            # fully occupied window: jump that key ahead by W
            full = remaining[~has_empty]
            pos[full] = (pos[full] + self._W) & mask
            rows = np.nonzero(has_empty)[0]
            if rows.size:
                # claim each key's first empty bucket; duplicate targets
                # resolve by numpy scatter last-writer-wins, verified by
                # re-gather (keys are unique, so the winner re-reads itself).
                # Losers re-probe the SAME window next round: the bucket they
                # lost is occupied now, so they fall to a later empty slot.
                target = win[rows, empty[rows].argmax(axis=1)]
                cand = remaining[rows]
                self._tkeys[target] = keys[cand]
                self._tvals[target] = vals[cand]
                won = self._tkeys[target] == keys[cand]
                keep = np.zeros(keys.shape[0], dtype=bool)
                keep[remaining] = True
                keep[cand[won]] = False
                remaining = remaining[keep[remaining]]
            else:
                remaining = full

    def _grow_for(self, n_new: int) -> None:
        grew = False
        while (self._n + n_new) * 2 > self._size:
            self._size *= 2
            grew = True
        if grew:
            live = self._tkeys != self._EMPTY
            old_keys = self._tkeys[live]
            old_vals = self._tvals[live]
            self._tkeys = np.full(self._size, self._EMPTY, dtype=np.uint64)
            self._tvals = np.zeros(self._size, dtype=np.int32)
            if old_keys.size:
                self._insert(old_keys, old_vals)

    def assign(self, unique_keys: np.ndarray) -> np.ndarray:
        """Map unique global keys to row slots, growing the vocab as needed.

        PAD_KEY maps to slot ``capacity`` (the trash row — tables allocate
        ``capacity + 1`` rows; see ops.scatter).  Slot order matches the
        sequential first-appearance order of the old dict implementation:
        new keys get ids ``len(self)..`` in batch order.
        """
        keys = np.asarray(unique_keys, dtype=np.uint64)
        flat = keys.ravel()
        if self._native is not None:
            return self._native.assign(flat).reshape(keys.shape)
        out = np.empty(flat.shape[0], dtype=np.int32)
        is_pad = flat == PAD_KEY
        out[is_pad] = self.capacity
        real = np.nonzero(~is_pad)[0]
        rk = flat[real]
        vals = self._lookup(rk)
        missing = vals < 0
        if missing.any():
            new_keys = rk[missing]
            # dedup first (the contract says unique keys, but duplicates must
            # still share ONE slot, like the native engine / old dict — else
            # a dupe would burn an unreachable vocab row); slots are handed
            # out in first-appearance order
            uniq_new, first_idx, inv = np.unique(
                new_keys, return_index=True, return_inverse=True
            )
            arrival = np.argsort(first_idx, kind="stable")
            rank = np.empty(arrival.size, dtype=np.int64)
            rank[arrival] = np.arange(arrival.size)
            n_take = min(max(self.capacity - self._n, 0), arrival.size)
            taken = rank < n_take
            slots_u = np.empty(arrival.size, dtype=np.int32)
            slots_u[taken] = (self._n + rank[taken]).astype(np.int32)
            if n_take < arrival.size:
                # Feature-hashing fallback on overflow. Deterministic pure
                # function of the key — deliberately NOT cached, so host
                # memory stays bounded by ``capacity`` on unbounded
                # streaming key sets.
                self._overflowed = True
                slots_u[~taken] = (
                    uniq_new[~taken] % np.uint64(self.capacity)
                ).astype(np.int32)
            if n_take:
                self._grow_for(n_take)
                self._insert(uniq_new[taken], slots_u[taken])
                self._n += n_take
            vals[missing] = slots_u[inv]
        out[real] = vals
        return out.reshape(keys.shape)


def localizer_meta(loc) -> dict:
    """Reconstruction metadata for a localizer (checkpoint manifest extras).

    A checkpointed table is only servable with the SAME key->row mapping it
    was trained with (the reference writes raw key ranges so the mapping is
    the identity; here the mapping is a host-side function and must be
    recorded alongside the shards).
    """
    meta = {"kind": type(loc).__name__, "capacity": int(loc.capacity)}
    if isinstance(loc, HashLocalizer):
        meta["seed"] = int(loc.seed)
        meta["hash_bits"] = int(loc.hash_bits)
    return meta


def localizer_from_meta(meta: dict):
    """Rebuild the key->row mapping recorded by :func:`localizer_meta`.

    Only deterministic localizers reconstruct (``HashLocalizer``,
    ``IdentityLocalizer``); the stateful :class:`Localizer` depends on key
    arrival order, which the checkpoint does not capture — pass the live
    instance (or re-stream the training keys) instead.
    """
    kind = meta.get("kind")
    if kind == "HashLocalizer":
        return HashLocalizer(
            int(meta["capacity"]),
            seed=int(meta.get("seed", 0)),
            hash_bits=int(meta.get("hash_bits", 64)),
        )
    if kind == "IdentityLocalizer":
        return IdentityLocalizer(int(meta["capacity"]))
    raise ValueError(
        f"cannot reconstruct localizer from meta {meta!r} (stateful "
        "Localizer mappings are arrival-order-dependent; pass the instance)"
    )
