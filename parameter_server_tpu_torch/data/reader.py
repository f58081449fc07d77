"""Chunked file readers: the host input pipeline.

The port's copy of ``parameter_server_tpu/data/reader.py`` (host numpy):
the same files give the same chunks and batches as the JAX readers.

Reference analogues: ``src/data/slot_reader.h`` (parse once, cache column
groups locally, re-read cheaply per block) and ``src/data/stream_reader.h``
(minibatch streaming for online learners) [U].

- :class:`SlotReader` — parse text files once into CSR chunks, cache each
  parsed chunk as an ``.npz`` next to a content fingerprint; later passes
  (BCD iterates over feature blocks many times) load the cache instead of
  re-parsing.
- :class:`StreamReader` — endless minibatch iterator over a file list with
  fixed batch size (carry remainder across chunk boundaries), for the
  async-SGD/FTRL streaming path.
"""

from __future__ import annotations

import hashlib
import os
from typing import Callable, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from parameter_server_tpu_torch.data import fs
from parameter_server_tpu_torch.data import text as text_lib

CHUNK_BYTES = 8 << 20


def _read_chunks(path: str, chunk_bytes: int) -> Iterator[bytes]:
    """Yield line-aligned byte chunks of a text file.

    ``path`` may be any :mod:`parameter_server_tpu_torch.data.fs` url — local,
    ``.gz``, or a remote ``psfs://`` shard — so every reader feeds from the
    cluster file service with no call-site changes (reference ``file.h``
    HDFS role).
    """
    with fs.open_stream(path) as f:
        carry = b""
        while True:
            block = f.read(chunk_bytes)
            if not block:
                if carry.strip():
                    yield carry
                return
            block = carry + block
            cut = block.rfind(b"\n")
            if cut < 0:
                carry = block
                continue
            yield block[: cut + 1]
            carry = block[cut + 1 :]


class SlotReader:
    """Parse-once, cache-locally reader for batch training (BCD path).

    ``format`` is ``"libsvm"`` (CSR) — criteo batch use goes through
    :class:`StreamReader`.  Cached chunks are keyed by (file size, mtime,
    chunk index) so edits invalidate the cache.
    """

    def __init__(
        self,
        files: Sequence[str],
        *,
        cache_dir: Optional[str] = None,
        chunk_bytes: int = CHUNK_BYTES,
    ) -> None:
        self.files = list(files)
        self.cache_dir = cache_dir
        self.chunk_bytes = chunk_bytes
        if cache_dir:
            os.makedirs(cache_dir, exist_ok=True)

    def _file_tag(self, path: str) -> str:
        st = fs.stat(path)  # works for local AND psfs:// shard urls
        ident = path if "://" in path else os.path.abspath(path)
        return hashlib.sha1(
            f"{ident}:{st.size}:{st.mtime_ns}:"
            f"{self.chunk_bytes}".encode()
        ).hexdigest()[:16]

    def _cache_path(self, tag: str, idx: int) -> Optional[str]:
        if not self.cache_dir:
            return None
        return os.path.join(self.cache_dir, f"slot_{tag}_{idx}.npz")

    def _manifest_path(self, tag: str) -> str:
        return os.path.join(self.cache_dir, f"slot_{tag}.manifest")  # type: ignore[arg-type]

    def _load_chunk(self, cpath: str) -> text_lib.CSRBatch:
        z = np.load(cpath)
        return text_lib.CSRBatch(
            z["labels"], z["indptr"], z["indices"], z["values"]
        )

    def chunks(self) -> Iterator[text_lib.CSRBatch]:
        for path in self.files:
            tag = self._file_tag(path) if self.cache_dir else ""
            # warm-cache fast path: the manifest records the chunk count, so
            # later passes (BCD iterates many times) never re-read the raw
            # text at all
            if self.cache_dir:
                mpath = self._manifest_path(tag)
                if os.path.exists(mpath):
                    with open(mpath) as mf:
                        n_chunks = int(mf.read().strip())
                    paths = [self._cache_path(tag, i) for i in range(n_chunks)]
                    if all(os.path.exists(p) for p in paths):  # type: ignore[arg-type]
                        for p in paths:
                            yield self._load_chunk(p)  # type: ignore[arg-type]
                        continue
            n_chunks = 0
            for idx, raw in enumerate(_read_chunks(path, self.chunk_bytes)):
                n_chunks = idx + 1
                cpath = self._cache_path(tag, idx)
                if cpath and os.path.exists(cpath):
                    yield self._load_chunk(cpath)
                    continue
                batch = text_lib.parse_libsvm(raw)
                if cpath:
                    # name must end in .npz or np.savez appends it
                    tmp = cpath + f".{os.getpid()}.tmp.npz"
                    np.savez(
                        tmp,
                        labels=batch.labels,
                        indptr=batch.indptr,
                        indices=batch.indices,
                        values=batch.values,
                    )
                    os.replace(tmp, cpath)
                yield batch
            if self.cache_dir:
                tmp = self._manifest_path(tag) + f".{os.getpid()}.tmp"
                with open(tmp, "w") as mf:
                    mf.write(str(n_chunks))
                os.replace(tmp, self._manifest_path(tag))

    def read_all(self) -> text_lib.CSRBatch:
        """Concatenate every chunk (small datasets / tests)."""
        parts = list(self.chunks())
        if not parts:
            return text_lib.CSRBatch(
                np.zeros(0, np.float32), np.zeros(1, np.int64),
                np.zeros(0, np.uint64), np.zeros(0, np.float32),
            )
        labels = np.concatenate([p.labels for p in parts])
        indices = np.concatenate([p.indices for p in parts])
        values = np.concatenate([p.values for p in parts])
        indptr = [np.zeros(1, np.int64)]
        base = 0
        for p in parts:
            indptr.append(p.indptr[1:] + base)
            base += int(p.indptr[-1])
        return text_lib.CSRBatch(labels, np.concatenate(indptr), indices, values)


class StreamReader:
    """Fixed-size minibatch stream over text files (async SGD / FTRL path).

    Yields ``(keys [B, max_nnz], values, labels)`` for libsvm or
    ``(keys [B, 26], dense [B, 13], labels)`` for criteo.  Remainder rows at
    a chunk boundary carry into the next chunk; a final short batch is
    dropped (epoch semantics of streaming learners).
    """

    def __init__(
        self,
        files: Sequence[str],
        batch_size: int,
        *,
        format: str = "libsvm",
        max_nnz: int = 64,
        epochs: Optional[int] = None,
        chunk_bytes: int = CHUNK_BYTES,
        shuffle_seed: Optional[int] = None,
    ) -> None:
        if format not in ("libsvm", "criteo"):
            raise ValueError(f"unknown format {format!r}")
        self.files = list(files)
        self.batch_size = batch_size
        self.format = format
        self.max_nnz = max_nnz
        self.epochs = epochs
        self.chunk_bytes = chunk_bytes
        self.shuffle_seed = shuffle_seed

    def __iter__(self) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
        epoch = 0
        rng = (
            np.random.default_rng(self.shuffle_seed)
            if self.shuffle_seed is not None
            else None
        )
        pend: List[Tuple[np.ndarray, np.ndarray, np.ndarray]] = []
        pend_rows = 0
        while self.epochs is None or epoch < self.epochs:
            for path in self.files:
                for raw in _read_chunks(path, self.chunk_bytes):
                    triple = self._parse(raw)
                    if rng is not None:
                        perm = rng.permutation(triple[2].shape[0])
                        triple = tuple(t[perm] for t in triple)  # type: ignore
                    pend.append(triple)
                    pend_rows += triple[2].shape[0]
                    while pend_rows >= self.batch_size:
                        batch, pend, pend_rows = _take(pend, self.batch_size)
                        yield batch
            epoch += 1

    def _parse(self, raw: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        if self.format == "criteo":
            labels, dense, keys = text_lib.parse_criteo(raw)
            return keys, dense, labels
        batch = text_lib.parse_libsvm(raw)
        keys, vals, labels = batch.to_fixed_nnz(self.max_nnz)
        return keys, vals, labels


def _take(
    pend: List[Tuple[np.ndarray, np.ndarray, np.ndarray]], n: int
) -> Tuple[Tuple[np.ndarray, np.ndarray, np.ndarray], list, int]:
    """Pop exactly n rows off the pending chunk list."""
    got, rows = [], 0
    while rows < n:
        t = pend.pop(0)
        take = min(n - rows, t[2].shape[0])
        got.append(tuple(x[:take] for x in t))
        if take < t[2].shape[0]:
            pend.insert(0, tuple(x[take:] for x in t))
        rows += take
    batch = tuple(np.concatenate([g[i] for g in got]) for i in range(3))
    left = sum(t[2].shape[0] for t in pend)
    return batch, pend, left  # type: ignore


def criteo_log_transform(dense: np.ndarray) -> np.ndarray:
    """Standard Criteo dense preprocess: ``log1p(max(x, 0))``."""
    return np.log1p(np.maximum(dense, 0.0)).astype(np.float32)
