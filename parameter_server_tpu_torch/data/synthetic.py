"""Synthetic sparse CTR data: Criteo-shaped batches with known ground truth.

Host-side numpy code copied from ``parameter_server_tpu/data/synthetic.py``
(``SyntheticCTR`` only): each example has ``nnz`` categorical keys drawn
zipf-skewed from ``key_space``, and the label is Bernoulli of the logistic of
a hidden sparse weight vector.  The same seed gives the same batches as the
JAX package.
"""

from __future__ import annotations

import dataclasses
from typing import Iterator, Tuple

import numpy as np

from parameter_server_tpu_torch.utils.keys import mix64


@dataclasses.dataclass
class SyntheticCTR:
    """Deterministic stream of (keys [B, nnz], labels [B]) batches."""

    key_space: int = 1 << 22
    nnz: int = 39  # criteo: 39 categorical slots
    batch_size: int = 1024
    seed: int = 0
    #: fraction of informative features; the rest are noise keys
    informative: float = 0.05
    zipf_a: float = 1.3

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)
        self._n_inf = max(1, int(self.key_space * self.informative))
        self._true_w_scale = 1.0
        self._bias = -1.0

    def _true_weight(self, keys: np.ndarray) -> np.ndarray:
        """Deterministic hidden weight for each key (no giant table needed)."""
        h = mix64(keys, seed=0xABCDEF)
        informative = (h % np.uint64(self.key_space)) < np.uint64(self._n_inf)
        sign = np.where((h >> np.uint64(1)) & np.uint64(1), 1.0, -1.0)
        return np.where(informative, sign * self._true_w_scale, 0.0)

    def batches(self, num_batches: int) -> Iterator[Tuple[np.ndarray, np.ndarray]]:
        for _ in range(num_batches):
            yield self.next_batch()

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        rng = self._rng
        # zipf-skewed keys remixed over the key space (hot-key distribution)
        raw = rng.zipf(self.zipf_a, size=(self.batch_size, self.nnz)).astype(np.uint64)
        keys = mix64(raw, seed=7) % np.uint64(self.key_space)
        logits = self._true_weight(keys).sum(axis=1) + self._bias
        p = 1.0 / (1.0 + np.exp(-logits))
        labels = (rng.random(self.batch_size) < p).astype(np.float32)
        return keys, labels
