"""Quantization codecs for the wire's value plane.

The port's copy of ``parameter_server_tpu/ops/quantize.py``: pure numpy, so
codes and scales are bit-identical to the JAX package's for the same input
and ``rng``.  A CPU tensor is accepted wherever an array is (``np.asarray``
reads it without a copy).

Symmetric per-tensor (or per-row) int8 with a float32 scale; fp8 (e4m3 /
e5m2) by numpy bit tricks, with no hardware or ``ml_dtypes`` dependency: the
codes ARE the standard fp8 bit patterns.  Stochastic rounding takes a
seeded, caller-provided rng.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np


def quantize_int8(
    x: np.ndarray,
    *,
    per_row: bool = False,
    stochastic: bool = False,
    rng: Optional[np.random.Generator] = None,
    seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """float array -> (int8 array, float32 scale).  scale shape: [] or [rows,1].

    Stochastic rounding REQUIRES a caller-provided ``rng`` (the filter's
    seeded, lock-guarded generator — ``core/filters.FixingFloatFilter``) or
    an explicit ``seed``.  It used to fall back to an unseeded
    ``np.random.default_rng()`` per call, which silently broke the repo-wide
    seeded-determinism contract (every other randomness source — chaos
    schedules, data shards, noise filters — replays bitwise from a seed).
    """
    x = np.asarray(x, np.float32)
    if per_row and x.ndim >= 2:
        amax = np.max(np.abs(x), axis=tuple(range(1, x.ndim)), keepdims=True)
    else:
        amax = np.max(np.abs(x)) if x.size else np.float32(0.0)
    scale = np.where(amax > 0, amax / 127.0, 1.0).astype(np.float32)
    y = x / scale
    if stochastic:
        if rng is None:
            if seed is None:
                raise ValueError(
                    "quantize_int8(stochastic=True) needs rng= or seed=: an "
                    "implicit unseeded generator would break seeded replay "
                    "determinism (thread one from the filter config instead)"
                )
            rng = np.random.default_rng(seed)
        y = np.floor(y + rng.random(y.shape, dtype=np.float32))
    else:
        y = np.rint(y)
    return np.clip(y, -127, 127).astype(np.int8), scale


def dequantize_int8(q: np.ndarray, scale: np.ndarray) -> np.ndarray:
    return q.astype(np.float32) * np.asarray(scale, np.float32)


# ------------------------------------------------------------------- fp8
#
# fp8 via numpy bit arithmetic: the decode table is generated from the bit
# fields (sign / E exponent bits / M mantissa bits), so a code byte IS the
# standard fp8 bit pattern — a future hardware path can reinterpret the
# same wire plane.  e4m3 follows the "fn" convention (no inf; exp=15,
# man=7 is NaN; max finite 448); e5m2 is IEEE-like (exp=31 non-finite;
# max finite 57344).  Encode is a vectorized nearest/stochastic pick over
# the 2^7 non-negative representable values.

#: fmt -> (exponent bits, mantissa bits, bias, max finite magnitude)
FP8_FORMATS: Dict[str, Tuple[int, int, int, float]] = {
    "e4m3": (4, 3, 7, 448.0),
    "e5m2": (5, 2, 15, 57344.0),
}

#: fmt -> (decode table[256] f32, sorted non-negative values, their codes)
_FP8_TABLES: Dict[str, Tuple[np.ndarray, np.ndarray, np.ndarray]] = {}


def _fp8_tables(fmt: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    cached = _FP8_TABLES.get(fmt)
    if cached is not None:
        return cached
    if fmt not in FP8_FORMATS:
        raise ValueError(f"fp8 format must be one of {sorted(FP8_FORMATS)}, "
                         f"got {fmt!r}")
    e_bits, m_bits, bias, _fmax = FP8_FORMATS[fmt]
    codes = np.arange(256, dtype=np.uint16)
    sign = np.where(codes >> 7, -1.0, 1.0)
    exp = ((codes >> m_bits) & ((1 << e_bits) - 1)).astype(np.int64)
    man = (codes & ((1 << m_bits) - 1)).astype(np.float64)
    vals = sign * np.where(
        exp > 0,                                   # normals
        (1.0 + man / (1 << m_bits)) * np.exp2(exp - bias),
        man * np.exp2(1 - bias - m_bits),          # subnormals (exp == 0)
    )
    exp_max = (1 << e_bits) - 1
    if fmt == "e4m3":  # fn: only the all-ones code per sign is non-finite
        bad = (exp == exp_max) & (man == (1 << m_bits) - 1)
    else:              # e5m2: the whole top exponent is inf/NaN
        bad = exp == exp_max
    decode = np.where(bad, np.nan, vals).astype(np.float32)
    # non-negative finite values, ascending (monotone in the bit pattern)
    pos_codes = np.nonzero((codes < 128) & ~bad)[0].astype(np.uint8)
    pos_vals = decode[pos_codes]
    order = np.argsort(pos_vals, kind="stable")
    entry = (decode, pos_vals[order], pos_codes[order])
    _FP8_TABLES[fmt] = entry
    return entry


def quantize_fp8(
    x: np.ndarray,
    *,
    fmt: str = "e4m3",
    per_row: bool = False,
    stochastic: bool = False,
    rng: Optional[np.random.Generator] = None,
    seed: Optional[int] = None,
) -> Tuple[np.ndarray, np.ndarray]:
    """float array -> (uint8 fp8 codes, float32 scale).

    The scale maps the array's (per-tensor or per-row) absmax onto the
    format's max finite value, so the fp8 dynamic range is fully used.
    Stochastic rounding picks the bracketing representable value with
    probability proportional to proximity — same seeded-rng contract as
    :func:`quantize_int8` (an implicit unseeded generator is refused).
    """
    decode, pos_vals, pos_codes = _fp8_tables(fmt)
    fmax = FP8_FORMATS[fmt][3]
    x = np.asarray(x, np.float32)
    if per_row and x.ndim >= 2:
        amax = np.max(np.abs(x), axis=tuple(range(1, x.ndim)), keepdims=True)
    else:
        amax = np.max(np.abs(x)) if x.size else np.float32(0.0)
    scale = np.where(amax > 0, amax / fmax, 1.0).astype(np.float32)
    y = np.minimum(np.abs(x / scale), np.float32(fmax))
    if stochastic:
        if rng is None:
            if seed is None:
                raise ValueError(
                    "quantize_fp8(stochastic=True) needs rng= or seed=: an "
                    "implicit unseeded generator would break seeded replay "
                    "determinism (thread one from the filter config instead)"
                )
            rng = np.random.default_rng(seed)
        lo = np.maximum(
            np.searchsorted(pos_vals, y, side="right") - 1, 0
        )
        hi = np.minimum(lo + 1, len(pos_vals) - 1)
        v_lo, v_hi = pos_vals[lo], pos_vals[hi]
        gap = v_hi - v_lo
        frac = np.where(gap > 0, (y - v_lo) / np.where(gap > 0, gap, 1.0), 0.0)
        idx = np.where(rng.random(y.shape, dtype=np.float32) < frac, hi, lo)
    else:
        mid = (pos_vals[:-1] + pos_vals[1:]) * 0.5
        idx = np.searchsorted(mid, y, side="right")
    q = pos_codes[idx]
    return np.where(x < 0, q | np.uint8(0x80), q).astype(np.uint8), scale


def dequantize_fp8(
    q: np.ndarray, scale: np.ndarray, *, fmt: str = "e4m3"
) -> np.ndarray:
    """fp8 codes + scale -> float32.  One table gather — works directly on
    a read-only ``frombuffer`` wire view (the server's pre-H2D path)."""
    decode = _fp8_tables(fmt)[0]
    return decode[np.asarray(q)] * np.asarray(scale, np.float32)
