"""Synthetic data with known ground truth: Criteo-shaped CTR batches, DLRM
batches and a learnable image stream.

Host-side numpy code copied from ``parameter_server_tpu/data/synthetic.py``:

- :class:`SyntheticCTR`: each example has ``nnz`` categorical keys drawn
  zipf-skewed from ``key_space``, and the label is Bernoulli of the logistic
  of a hidden sparse weight vector.
- :class:`SyntheticDLRM`: dense floats plus 26 categorical keys; the label
  depends on both, so the MLPs and the embedding table must train.
- :class:`SyntheticImages`: each class owns a fixed random template, a sample
  is its template plus noise (NHWC float32).

The same seed gives the same batches as the JAX package, bit for bit.
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


@dataclasses.dataclass
class SyntheticDLRM:
    """Criteo-DLRM-shaped batches: dense floats + categorical keys + label.

    The label depends on both the dense features and per-key hidden weights,
    so learning requires the MLPs *and* the embedding table to train.
    """

    key_space: int = 1 << 20
    n_dense: int = 13
    n_sparse: int = 26
    batch_size: int = 512
    seed: int = 0

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)
        self._w_dense = np.random.default_rng(self.seed + 1).normal(
            size=self.n_dense
        ) / np.sqrt(self.n_dense)

    def _key_effect(self, keys: np.ndarray) -> np.ndarray:
        h = mix64(keys, seed=0x5EED)
        sign = np.where((h >> np.uint64(2)) & np.uint64(1), 1.0, -1.0)
        active = (h % np.uint64(4)) == 0  # quarter of keys matter
        return np.where(active, sign * 0.5, 0.0)

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """``(keys [B, n_sparse] uint64, dense [B, n_dense] f32, labels [B] f32)``."""
        rng = self._rng
        dense = rng.normal(size=(self.batch_size, self.n_dense)).astype(np.float32)
        raw = rng.zipf(1.2, size=(self.batch_size, self.n_sparse)).astype(np.uint64)
        keys = mix64(raw, seed=11) % np.uint64(self.key_space)
        logits = dense @ self._w_dense + self._key_effect(keys).sum(axis=1) - 0.5
        labels = (rng.random(self.batch_size) < 1 / (1 + np.exp(-logits))).astype(
            np.float32
        )
        return keys, dense, labels


@dataclasses.dataclass
class SyntheticImages:
    """Learnable image-classification stream (ResNet-class benchmarks).

    Each class owns a fixed random template; a sample is its class template
    plus gaussian noise, so a small convnet separates the classes quickly.
    """

    num_classes: int = 10
    hw: int = 16
    batch_size: int = 64
    seed: int = 0
    noise: float = 1.0

    def __post_init__(self) -> None:
        self._rng = np.random.default_rng(self.seed)
        tmpl_rng = np.random.default_rng(0xC1A55)
        self._templates = tmpl_rng.normal(
            size=(self.num_classes, self.hw, self.hw, 3)
        ).astype(np.float32)

    def next_batch(self) -> Tuple[np.ndarray, np.ndarray]:
        """``(images [B, hw, hw, 3] f32 NHWC, labels [B] int32)``."""
        rng = self._rng
        labels = rng.integers(
            0, self.num_classes, size=self.batch_size
        ).astype(np.int32)
        images = (
            self._templates[labels]
            + self.noise
            * rng.normal(size=(self.batch_size, self.hw, self.hw, 3))
        ).astype(np.float32)
        return images, labels
