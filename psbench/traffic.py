"""Traffic generators: each reads a traffic file's parameters and makes a
cell's inputs from ``--seed``.  A workload file names its generator under
``traffic.generator``; a new mix of an existing kind is a data file only.

- ``ctr``: Criteo-shaped click batches, a copy of the port's
  ``data/synthetic.py::SyntheticCTR`` (Zipf-skewed raw keys remixed over the
  key space, labels Bernoulli of the logistic of a hidden sparse weight
  vector), drawn on the card: the Zipf draw is numpy's rejection sampler
  (Devroye) vectorised, the remix a 32-bit avalanche of the draw's halves.
- ``zipf_tokens``: token batches whose ids follow a Zipf law over the
  vocabulary (natural-text frequencies), ranks mapped to ids through a
  permutation drawn from the seed.
"""

from __future__ import annotations

import numpy as np

_MASK32 = 0xFFFF_FFFF
_M1, _M2 = 0x85EB_CA6B, 0xC2B2_AE35


def seed_of(seed: int, stream: int) -> int:
    """A 63-bit generator seed for one stream of a run's seed (any whole
    number, negative or above 2**32 included)."""
    ss = np.random.SeedSequence([int(seed) % (1 << 64), stream])
    return int(ss.generate_state(1, np.uint64)[0] >> np.uint64(1))


def _mul32(x, c: int):
    """``(x * c) mod 2**32`` for int64 ``x`` in [0, 2**32), with no product
    above 2**49 (nothing relies on how a signed overflow wraps)."""
    lo, hi = c & 0xFFFF, c >> 16
    return (x * lo + (((x * hi) & 0xFFFF) << 16)) & _MASK32


def fmix32(x, seed: int):
    """murmur3's 32-bit finaliser of int64 ``x`` in [0, 2**32) xor ``seed``."""
    x = x ^ (seed & _MASK32)
    x = x ^ (x >> 16)
    x = _mul32(x, _M1)
    x = x ^ (x >> 13)
    x = _mul32(x, _M2)
    return x ^ (x >> 16)


def zipf_draw(torch, n: int, a: float, gen, device):
    """``n`` Zipf(``a``) integers >= 1 as int64, by numpy's ``random_zipf``
    rejection scheme over float64 uniforms from ``gen``."""
    am1 = a - 1.0
    b = 2.0 ** am1
    umin = float(np.iinfo(np.int64).max) ** -am1
    out = torch.empty(n, dtype=torch.int64, device=device)
    todo = torch.arange(n, device=device)
    while todo.numel():
        m = todo.numel()
        u01 = torch.rand(m, dtype=torch.float64, generator=gen, device=device)
        v = torch.rand(m, dtype=torch.float64, generator=gen, device=device)
        x = torch.floor((u01 * umin + (1.0 - u01)) ** (-1.0 / am1))
        t = (1.0 + 1.0 / x) ** am1
        ok = (x >= 1.0) & (x < 2.0 ** 62) & (v * x * (t - 1.0) / (b - 1.0) <= t / b)
        out[todo[ok]] = x[ok].to(torch.int64)
        todo = todo[~ok]
    return out


def ctr_blocks(torch, params: dict, seed: int, device):
    """``params["pool_blocks"]`` blocks of ``params["block"]`` batches of
    ``batch`` x ``nnz`` keys (uint32 values below ``key_space`` <= 2**32 - 1,
    so never the PAD key 2**32 - 1, as int32 views) and labels, made on
    ``device``.  Returns (keys [P, K, B, nnz] int32, labels [P, K, B]
    float32) on ``device``."""
    P, K, B, F = params["pool_blocks"], params["block"], params["batch"], params["nnz"]
    space, a = params["key_space"], params["zipf_a"]
    if not 0 < space < 1 << 32:
        raise ValueError(f"key_space must lie in (0, 2**32 - 1], got {space}")
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, 1))
    raw = zipf_draw(torch, P * K * B * F, a, gen, device)
    lo, hi = raw & _MASK32, raw >> 32
    keys = fmix32(lo ^ fmix32(hi, 0x9E37_79B9), 7) % space
    # the hidden weight of each key: informative keys +-1, noise keys 0
    h = fmix32(keys, 0xABCDEF)
    informative = (h % space) < max(1, int(space * params["informative"]))
    sign = torch.where(((h >> 1) & 1) == 1, 1.0, -1.0)
    w = torch.where(informative, sign, 0.0).to(torch.float32)
    logits = w.reshape(P * K * B, F).sum(dim=1) + params["label_bias"]
    u = torch.rand(P * K * B, dtype=torch.float32, generator=gen, device=device)
    labels = (u < torch.sigmoid(logits)).to(torch.float32)
    keys = torch.where(keys >= 1 << 31, keys - (1 << 32), keys).to(torch.int32)  # uint32 views
    return keys.reshape(P, K, B, F), labels.reshape(P, K, B)


def zipf_tokens(params: dict, seed: int, vocab: int) -> np.ndarray:
    """``params["pool_batches"]`` batches of ``batch`` x ``seq`` token ids
    (int32): Zipf(``zipf_a``) ranks over the vocabulary, mapped to ids by a
    permutation drawn from the seed."""
    rng = np.random.default_rng(seed_of(seed, 2))
    n, B, S = params["pool_batches"], params["batch"], params["seq"]
    ranks = np.arange(1, vocab + 1, dtype=np.float64)
    cdf = np.cumsum(ranks ** -params["zipf_a"])
    cdf /= cdf[-1]
    perm = rng.permutation(vocab)
    draws = np.minimum(np.searchsorted(cdf, rng.random(n * B * S)), vocab - 1)
    return perm[draws].astype(np.int32).reshape(n, B, S)
