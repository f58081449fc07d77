"""Count-min sketch for tail-feature filtering.

The port's copy of ``parameter_server_tpu/utils/countmin.py``: host numpy,
so the same keys and seed give the same counts as the JAX package's.

Workers count the keys of their stream in a count-min sketch and admit a
key once it was seen ``>= threshold`` times (reference ``src/util/
countmin.h`` [U]; the linear method's preprocessing stage).  Filtering the
long tail shrinks billion-row CTR vocabularies by large factors.  Each row
hashes with the splitmix64-style ``mix64`` of ``utils/keys.py``.
"""

from __future__ import annotations

import numpy as np

from parameter_server_tpu_torch.utils.keys import mix64 as _mix64


class CountMin:
    """Count-min sketch: conservative frequency estimates, never undercounts."""

    def __init__(self, width: int = 1 << 20, depth: int = 4, seed: int = 0):
        self.width = int(width)
        self.depth = int(depth)
        self._table = np.zeros((depth, self.width), dtype=np.uint32)
        rng = np.random.default_rng(seed)
        self._seeds = rng.integers(1, 2**63, size=depth, dtype=np.uint64)

    def _slots(self, keys: np.ndarray) -> np.ndarray:
        keys = np.asarray(keys, dtype=np.uint64).ravel()
        return np.stack(
            [_mix64(keys, s) % np.uint64(self.width) for s in self._seeds]
        )  # [depth, n]

    def add(self, keys: np.ndarray, counts: np.ndarray | int = 1) -> None:
        slots = self._slots(keys)
        counts = np.broadcast_to(
            np.asarray(counts, dtype=np.uint32), slots.shape[1:]
        )
        for d in range(self.depth):
            np.add.at(self._table[d], slots[d], counts)

    def query(self, keys: np.ndarray) -> np.ndarray:
        """Estimated counts (>= true counts) for each key."""
        slots = self._slots(keys)
        est = self._table[0][slots[0]]
        for d in range(1, self.depth):
            est = np.minimum(est, self._table[d][slots[d]])
        return est

    def filter(self, keys: np.ndarray, threshold: int) -> np.ndarray:
        """Boolean mask of keys whose estimated count >= threshold."""
        return self.query(keys) >= np.uint32(threshold)
