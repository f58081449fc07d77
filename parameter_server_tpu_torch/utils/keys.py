"""Key localization: global 64-bit feature keys -> dense local row ids.

Host-side numpy code, copied from ``parameter_server_tpu/utils/keys.py`` (the
port imports nothing of the JAX package) so slot assignments match it bit
for bit: the hash mixes, power-of-two bucketing, per-batch dedup
(:func:`localize_batch`), the full key -> unique-slot pipeline
(:func:`localize_to_slots`), and the deterministic :class:`HashLocalizer` /
:class:`IdentityLocalizer`.  The growing native ``Localizer`` is not ported
yet.
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
#: ON DEVICE (the device-hash LR step, not ported yet, hashes 32-bit keys
#: with them so host and device slot assignments agree).
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
