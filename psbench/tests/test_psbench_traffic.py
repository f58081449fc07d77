"""The traffic generators: the same seed gives the same inputs, and the
card-side copy of ``SyntheticCTR`` draws what the port's host generator
draws (Zipf law, key spread, labels of both kinds)."""

from __future__ import annotations

import numpy as np
import torch

from psbench import traffic

CTR = {"batch": 4096, "nnz": 39, "key_space": 1 << 26, "zipf_a": 1.3, "informative": 0.1,
       "label_bias": -1.0, "block": 2, "pool_blocks": 2}


def test_zipf_draw_follows_numpys_law():
    gen = torch.Generator().manual_seed(1)
    ours = traffic.zipf_draw(torch, 400_000, 1.3, gen, "cpu").numpy()
    theirs = np.random.default_rng(1).zipf(1.3, size=400_000)
    assert ours.min() >= 1
    for k in (1, 2, 3, 10):
        assert abs((ours == k).mean() - (theirs == k).mean()) < 0.004


def test_ctr_pool_is_seeded_and_shaped_like_synthetic_ctr():
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR

    keys, labels = traffic.ctr_blocks(torch, CTR, 2**31 + 1, "cpu")
    again, _ = traffic.ctr_blocks(torch, CTR, 2**31 + 1, "cpu")
    other, _ = traffic.ctr_blocks(torch, CTR, 2**31 + 2, "cpu")
    assert torch.equal(keys, again) and not torch.equal(keys, other)
    assert keys.shape == (2, 2, 4096, 39) and keys.dtype == torch.int32
    assert int(keys.min()) >= 0 and int(keys.max()) < CTR["key_space"]
    host = SyntheticCTR(key_space=CTR["key_space"], nnz=39, batch_size=4096, seed=3,
                        informative=0.1)
    hk, hy = host.next_batch()
    ours = torch.unique(keys[0, 0]).numel() / keys[0, 0].numel()
    theirs = np.unique(hk).size / hk.size
    assert abs(ours - theirs) < 0.03
    # both label by a hidden weight of the hottest keys: neither all 0 nor 1
    assert 0.05 < float(labels.mean()) < 0.95 and 0.05 < float(hy.mean()) < 0.95


def test_ctr_keys_span_the_32_bit_space_as_int32_views():
    """Keys over Criteo's 32-bit space come as int32 views of uint32, and
    never as the PAD key 2**32 - 1."""
    p = dict(CTR, key_space=(1 << 32) - 1, batch=1024)
    keys, _ = traffic.ctr_blocks(torch, p, 2**31 + 5, "cpu")
    raw = keys.to(torch.int64) & 0xFFFF_FFFF
    assert int(raw.max()) < (1 << 32) - 1 and bool((keys < 0).any())
    assert int((raw >= 1 << 31).sum()) > keys.numel() // 4


def test_zipf_tokens_are_seeded_and_skewed():
    p = {"batch": 4, "seq": 256, "zipf_a": 1.1, "pool_batches": 8}
    a = traffic.zipf_tokens(p, 5, 32000)
    assert a.shape == (8, 4, 256) and a.dtype == np.int32
    assert np.array_equal(a, traffic.zipf_tokens(p, 5, 32000))
    assert not np.array_equal(a, traffic.zipf_tokens(p, 6, 32000))
    assert 0 <= a.min() and a.max() < 32000
    # natural-text skew: the commonest id takes several percent of the tokens
    assert np.bincount(a.ravel()).max() / a.size > 0.05


def test_seeds_of_any_size_are_taken():
    for seed in (0, -1, 2**31 + 5, 2**40):
        assert 0 <= traffic.seed_of(seed, 1) < 2**63
