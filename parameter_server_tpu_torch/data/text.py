"""Text example parsers: libsvm and Criteo TSV -> numpy batches.

The port's copy of ``parameter_server_tpu/data/text.py``: host numpy over
the port's copy of the native parser (``native/src/textparse.cc``, built by
:func:`parameter_server_tpu_torch.native.load`).  The same bytes give the
same CSR planes, keys and labels as the JAX package's parser, through the
native route and through the Python fallbacks alike.

Reference analogue: ``src/data/text_parser.h/.cc`` parsing libsvm / criteo
lines into ``Example`` protos [U].  Here parsing produces flat numpy arrays
directly: CSR for variable-nnz libsvm, fixed-width arrays for Criteo's 13
dense + 26 categorical slots.  The Python fallbacks (``_parse_libsvm_py``,
``_parse_criteo_py``) are bit-identical to the native path, the per-slot
salted mix64 categorical hashing included; they serve a host with no g++.
"""

from __future__ import annotations

import ctypes
import dataclasses
from typing import Optional, Tuple

import numpy as np

from parameter_server_tpu_torch import native
from parameter_server_tpu_torch.utils.keys import PAD_KEY, mix64

N_DENSE = 13  # criteo integer feature count
N_CAT = 26  # criteo categorical slot count
_MISSING_CAT = np.uint64(0xFFFFFFFFFFFFFFFE)

_f32p = ctypes.POINTER(ctypes.c_float)
_i64p = ctypes.POINTER(ctypes.c_int64)
_u64p = ctypes.POINTER(ctypes.c_uint64)


def _lib() -> Optional[ctypes.CDLL]:
    lib = native.load("textparse")
    if lib is not None and not getattr(lib, "_ps_sigs", False):
        lib.ps_libsvm_count.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, _i64p, _i64p,
            _i64p, _i64p,
        ]
        lib.ps_libsvm_fill.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, _i64p, _i64p,
            _f32p, _i64p, _u64p, _f32p,
        ]
        lib.ps_criteo_count.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, _i64p, _i64p,
        ]
        lib.ps_criteo_fill.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int, _i64p,
            ctypes.c_int, ctypes.c_int, _f32p, _f32p, _u64p,
        ]
        lib.ps_mix64.argtypes = [ctypes.c_uint64, ctypes.c_uint64]
        lib.ps_mix64.restype = ctypes.c_uint64
        lib._ps_sigs = True
    return lib


@dataclasses.dataclass
class CSRBatch:
    """Variable-nnz sparse examples in CSR form."""

    labels: np.ndarray  # [rows] f32
    indptr: np.ndarray  # [rows + 1] i64
    indices: np.ndarray  # [nnz] u64 feature keys
    values: np.ndarray  # [nnz] f32

    @property
    def rows(self) -> int:
        return int(self.labels.shape[0])

    def slice(self, lo: int, hi: int) -> "CSRBatch":
        a, b = int(self.indptr[lo]), int(self.indptr[hi])
        return CSRBatch(
            self.labels[lo:hi],
            (self.indptr[lo : hi + 1] - a).astype(np.int64),
            self.indices[a:b],
            self.values[a:b],
        )

    def to_fixed_nnz(
        self, max_nnz: int, *, pad_key: np.uint64 = PAD_KEY
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Pad/truncate to ``(keys [rows, max_nnz], vals, labels)``.

        Fixed-shape batches are what the learners consume.  PAD_KEY
        positions route to the table's trash row, contributing zero to
        logits and gradients (the table keeps that row at zero).
        """
        rows = self.rows
        keys = np.full((rows, max_nnz), pad_key, dtype=np.uint64)
        vals = np.zeros((rows, max_nnz), dtype=np.float32)
        counts = np.minimum(np.diff(self.indptr), max_nnz).astype(np.int64)
        # ragged -> rectangular via flat scatter (fully vectorized)
        row_idx = np.repeat(np.arange(rows), counts)
        starts = np.repeat(np.cumsum(counts) - counts, counts)
        within = np.arange(int(counts.sum()), dtype=np.int64) - starts
        src = within + np.repeat(self.indptr[:-1], counts)
        keys[row_idx, within] = self.indices[src]
        vals[row_idx, within] = self.values[src]
        return keys, vals, self.labels


def parse_libsvm(data: bytes, *, nthreads: int = 0) -> CSRBatch:
    """Parse a libsvm text buffer into a :class:`CSRBatch`.

    ``nthreads=0`` = auto.  Native path when available, else numpy fallback.
    """
    lib = _lib()
    if lib is not None:
        return _parse_libsvm_native(lib, data, nthreads or _auto_threads())
    return _parse_libsvm_py(data)


def _auto_threads() -> int:
    return min(8, __import__("os").cpu_count() or 1)


def _parse_libsvm_native(lib: ctypes.CDLL, data: bytes, nthreads: int) -> CSRBatch:
    rows = ctypes.c_int64()
    nnz = ctypes.c_int64()
    chunk_rows = np.zeros(max(nthreads, 1), dtype=np.int64)
    chunk_nnz = np.zeros(max(nthreads, 1), dtype=np.int64)
    lib.ps_libsvm_count(
        data, len(data), nthreads, ctypes.byref(rows), ctypes.byref(nnz),
        chunk_rows.ctypes.data_as(_i64p), chunk_nnz.ctypes.data_as(_i64p),
    )
    labels = np.empty(rows.value, dtype=np.float32)
    indptr = np.zeros(rows.value + 1, dtype=np.int64)
    indices = np.empty(nnz.value, dtype=np.uint64)
    values = np.empty(nnz.value, dtype=np.float32)
    lib.ps_libsvm_fill(
        data, len(data), nthreads,
        chunk_rows.ctypes.data_as(_i64p), chunk_nnz.ctypes.data_as(_i64p),
        labels.ctypes.data_as(_f32p), indptr.ctypes.data_as(_i64p),
        indices.ctypes.data_as(_u64p), values.ctypes.data_as(_f32p),
    )
    return CSRBatch(labels, indptr, indices, values)


def _float_prefix(tok: bytes) -> tuple[float, int]:
    """Mirror of the C parser's numeric subset: ``[-+]?d*[.d*][eE[-+]?d*]``.

    Returns ``(value, chars_consumed)``; consumed == 0 when the mantissa has
    no digits (malformed).  Used by both fallback parsers so accept/skip
    decisions match the native path token for token (no nan/inf, no
    locale, junk tolerated only after the numeric prefix).
    """
    i, n = 0, len(tok)
    neg = False
    if i < n and tok[i : i + 1] in (b"+", b"-"):
        neg = tok[i : i + 1] == b"-"
        i += 1
    v = 0.0
    digits = 0
    while i < n and 48 <= tok[i] <= 57:
        v = v * 10.0 + (tok[i] - 48)
        i += 1
        digits += 1
    if i < n and tok[i : i + 1] == b".":
        i += 1
        scale = 0.1
        while i < n and 48 <= tok[i] <= 57:
            v += (tok[i] - 48) * scale
            scale *= 0.1
            i += 1
            digits += 1
    if digits == 0:
        return 0.0, 0
    if i < n and tok[i : i + 1] in (b"e", b"E"):
        i += 1
        eneg = False
        if i < n and tok[i : i + 1] in (b"+", b"-"):
            eneg = tok[i : i + 1] == b"-"
            i += 1
        ex = 0
        while i < n and 48 <= tok[i] <= 57:
            if ex < 10000:  # saturate like the native parser
                ex = ex * 10 + (tok[i] - 48)
            i += 1
        try:
            v *= 10.0 ** (-ex if eneg else ex)
        except OverflowError:  # C pow() returns inf here; match it
            v = float("inf") if v else 0.0
    return (-v if neg else v), i


def _parse_libsvm_py(data: bytes) -> CSRBatch:
    labels, indptr, indices, values = [], [0], [], []
    for line in data.split(b"\n"):
        line = line.strip()
        # '#' is a comment ONLY at token start (native rule): a full-line
        # comment skips the row; '#' glued inside a token makes that token
        # malformed (skipped whole below), NOT a line truncation.
        if not line or line.startswith(b"#"):
            continue
        parts = line.split()
        label, _ = _float_prefix(parts[0])  # junk label -> 0.0, row kept
        labels.append(label)
        for tok in parts[1:]:
            if tok.startswith(b"#"):
                break  # trailing comment: rest of line ignored
            # accept/skip rules identical to the native parse_feature():
            # key must be all digits; value (if present) must be a fully-
            # consumed numeric; malformed tokens are skipped whole.
            k, _, v = tok.partition(b":")
            if not k.isdigit():
                continue
            if v or tok.endswith(b":"):
                val, used = _float_prefix(v)
                if used == 0 or used != len(v):
                    continue
            else:
                val = 1.0
            indices.append(int(k))
            values.append(val)
        indptr.append(len(indices))
    return CSRBatch(
        np.asarray(labels, np.float32),
        np.asarray(indptr, np.int64),
        np.asarray(indices, np.uint64),
        np.asarray(values, np.float32),
    )


def hash_cat(raw: np.ndarray, slot: np.ndarray | int) -> np.ndarray:
    """Per-slot salted key hash for categorical values (numpy reference).

    Must match the C++ ``mix64(raw, slot + 1)`` exactly.
    """
    seed = np.asarray(slot, dtype=np.uint64) + np.uint64(1)
    # mix64 takes a scalar seed; vectorize by folding the seed xor in here
    x = np.asarray(raw, dtype=np.uint64) ^ seed
    return mix64(x, 0)


def parse_criteo(
    data: bytes, *, nthreads: int = 0
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Parse Criteo TSV -> ``(labels [B], dense [B,13] f32, keys [B,26] u64)``.

    Missing dense fields parse as 0; missing categoricals hash a per-slot
    sentinel so every slot always yields a key (fixed-shape batches).
    """
    lib = _lib()
    if lib is not None:
        rows = ctypes.c_int64()
        nt = nthreads or _auto_threads()
        chunk_rows = np.zeros(max(nt, 1), dtype=np.int64)
        lib.ps_criteo_count(
            data, len(data), nt, ctypes.byref(rows),
            chunk_rows.ctypes.data_as(_i64p),
        )
        labels = np.empty(rows.value, dtype=np.float32)
        dense = np.empty((rows.value, N_DENSE), dtype=np.float32)
        keys = np.empty((rows.value, N_CAT), dtype=np.uint64)
        lib.ps_criteo_fill(
            data, len(data), nt, chunk_rows.ctypes.data_as(_i64p),
            N_DENSE, N_CAT,
            labels.ctypes.data_as(_f32p), dense.ctypes.data_as(_f32p),
            keys.ctypes.data_as(_u64p),
        )
        return labels, dense, keys
    return _parse_criteo_py(data)


_HEX = b"0123456789abcdefABCDEF"


def _hex_prefix(tok: bytes) -> np.uint64:
    """Native-parity hex parse: leading hex digits, wrapping mod 2**64;
    no hex digits (or empty) -> the missing sentinel.  Matches the C++
    parser's tolerance of junk suffixes and >16-digit fields exactly."""
    v = 0
    n = 0
    for c in tok:
        d = _HEX.find(c % 256 if isinstance(c, int) else c)
        if d < 0:
            break
        v = ((v << 4) | (d if d < 16 else d - 6)) & 0xFFFFFFFFFFFFFFFF
        n += 1
    return np.uint64(v) if n else _MISSING_CAT


def _parse_criteo_py(data: bytes) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    labels, dense, keys = [], [], []
    slots = np.arange(N_CAT, dtype=np.uint64)
    for line in data.split(b"\n"):
        if not line.strip():
            continue
        f = line.rstrip(b"\r").split(b"\t")
        labels.append(_float_prefix(f[0])[0])
        d = np.zeros(N_DENSE, dtype=np.float32)
        for i in range(N_DENSE):
            tok = f[1 + i] if 1 + i < len(f) else b""
            if tok:
                d[i] = _float_prefix(tok)[0]  # junk-suffix tolerant
        dense.append(d)
        raw = np.empty(N_CAT, dtype=np.uint64)
        for i in range(N_CAT):
            tok = f[1 + N_DENSE + i] if 1 + N_DENSE + i < len(f) else b""
            raw[i] = _hex_prefix(tok)
        keys.append(hash_cat(raw, slots))
    return (
        np.asarray(labels, np.float32),
        np.stack(dense) if dense else np.zeros((0, N_DENSE), np.float32),
        np.stack(keys) if keys else np.zeros((0, N_CAT), np.uint64),
    )


def write_libsvm(path: str, batch: CSRBatch) -> None:
    """Inverse of :func:`parse_libsvm`, for tests and cache round-trips."""
    with open(path, "w") as f:
        for r in range(batch.rows):
            a, b = int(batch.indptr[r]), int(batch.indptr[r + 1])
            feats = " ".join(
                f"{int(batch.indices[i])}:{batch.values[i]:g}" for i in range(a, b)
            )
            f.write(f"{batch.labels[r]:g} {feats}\n")
