"""The yardstick's counts, from shapes: the Mistral cut's matmul and body
parameters (and the Llama cut's, against the port's own count), causal
attention's FLOPs, the LR step's bytes from its batch's unique slots; each
share of a peak stays under 100% on recorded figures."""

from __future__ import annotations

import json

import pytest
import torch

from psbench import roofline, run
from psbench.reference import lr as lr_reference
from psbench.reference import transformer as lm_reference

H100 = "NVIDIA H100 80GB HBM3"


def _mistral() -> dict:
    return json.loads((run.BENCH / "configs" / "mistral-7b-hybrid.json").read_text())


#: PR 19's Llama-3-8B cut (4 of 32 layers), as chip_smoke.py runs it
LLAMA_CUT = {"hidden_size": 4096, "num_attention_heads": 32, "num_key_value_heads": 8,
             "intermediate_size": 14336, "vocab_size": 128256, "num_hidden_layers": 4}


def test_body_counts():
    cfg = _mistral()
    assert roofline.block_matmul_params(4096, 32, 8, 128, 14336) == 218_103_808
    assert roofline.body_matmul_params(cfg) == 8 * 218_103_808 + 32000 * 4096
    assert roofline.body_params(cfg) == 1_875_972_096 == 8 * 218_112_000 + 131_072_000 + 4096
    assert roofline.body_params(LLAMA_CUT) == 1_397_788_672  # PR 19's body_params


def test_counts_match_the_program_and_the_reference():
    """At a toy size: the port's body and the reference's weights hold
    exactly the parameters the count gives."""
    from parameter_server_tpu_torch.models import transformer as tfm
    from psbench.drivers.hybrid import transformer_config

    cfg = _mistral()
    cfg.update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
               intermediate_size=96, vocab_size=256, num_hidden_layers=2)
    body = tfm.TransformerBody(transformer_config(torch, cfg), device="cpu")
    assert sum(p.numel() for p in body.parameters()) == roofline.body_params(cfg)
    weights = lm_reference.make_weights(cfg, 1, "cpu")
    body_leaves = [w for n, w in weights.items() if n != "embedding"]
    assert sum(w.numel() for w in body_leaves) == roofline.body_params(cfg)


def test_attention_and_step_flops():
    cfg = _mistral()
    assert roofline.causal_attention_flops(4096, 4096) == 6 * 4096 ** 3
    s512 = roofline.train_step_flops(cfg, 8, 512)
    assert s512 == pytest.approx(6 * 1_875_902_464 * 4096 + 8 * 8 * 6 * 512 ** 2 * 4096)
    assert s512 / 1e12 == pytest.approx(46.51, abs=0.01)
    s4096 = roofline.train_step_flops(cfg, 1, 4096)
    assert (s4096 - 6 * 1_875_902_464 * 4096) / 1e12 == pytest.approx(3.299, abs=0.001)


def test_shares_of_the_peak_stay_under_100_on_recorded_figures():
    # PR 19: the Llama cut at 8 x 512 in 769.0 ms a step (chip_smoke.py)
    mfu = roofline.train_step_flops(LLAMA_CUT, 8, 512) / (0.769 * roofline.peak_flops(H100, "fp32"))
    assert 0.66 < mfu < 1.0
    # PR 4-19: 2.43 M examples/s at 16384 x 39: a step in 6.74 ms
    step_s = 16384 / 2.43e6
    least = roofline.least_time_s(roofline.lr_step_flops(16384, 39, 16384 * 39),
                                  roofline.lr_step_bytes(16384, 39, 16384 * 39), H100, "fp32")
    assert 0 < least / step_s < 0.01  # even with every position a unique slot


def test_lr_bytes_follow_the_unique_slots():
    keys = torch.tensor([[1, 2, 3], [1, 2, 4]], dtype=torch.int32)
    slots = lr_reference.slots(keys, 1 << 20, 0)
    unique = torch.unique(slots).numel()
    assert unique == 4
    assert roofline.lr_step_bytes(2, 3, unique) == 2 * 3 * 4 + 2 * 4 + 4 * 16 + 4
    pad = lr_reference.slots(torch.tensor([-1], dtype=torch.int32), 1 << 20, 0)
    assert int(pad) == 1 << 20  # the PAD key goes to the trash row


def test_device_hash_matches_the_program():
    """The reference's frozen copy of the device hash gives the port's slots."""
    from parameter_server_tpu_torch.models import linear

    keys = torch.randint(-2**31, 2**31 - 1, (4096,), dtype=torch.int32,
                         generator=torch.Generator().manual_seed(5))
    for rows in (1 << 22, 1 << 28):
        for seed in (0, 7):
            assert torch.equal(lr_reference.slots(keys, rows, seed),
                               linear.device_slots(keys, rows, seed))


def test_peaks_refuse_an_unknown_card():
    assert roofline.peak_flops(H100, "fp32") == 67e12
    with pytest.raises(ValueError):
        roofline.peak_flops("cpu", "fp32")
