"""The Moonlight hybrid cell at toy sizes on the CPU (its own sizes: the
shared fixtures' table is keyed by driver): a run gives the contract's line
and is correct; the control and the half-batch fault are not, nor a run
whose timed path is broken underneath; and ``roofline_moe`` counts what a
hand count gives."""

from __future__ import annotations

import copy
import json

import pytest
import torch

from psbench import compare, control, roofline_moe, run

CELL = "moonlight-16b-a3b-hybrid.s2048-b16"
#: every width cut, every key kept: 16 router outputs, experts 4-7 held here
TOY_CFG = dict(hidden_size=64, num_attention_heads=4, kv_lora_rank=16, qk_nope_head_dim=8,
               qk_rope_head_dim=4, v_head_dim=8, intermediate_size=96,
               moe_intermediate_size=32, router_experts=16, n_routed_experts=4,
               experts_held_first=4, num_experts_per_tok=3, vocab_size=256,
               num_hidden_layers=3)
TOY_TRAFFIC = dict(batch=2, seq=16, pool_batches=8)


def _toy():
    spec = run.bench_spec()
    cell, cfg, workload = run.load_cell(spec, CELL)
    cfg, workload = copy.deepcopy(cfg), copy.deepcopy(workload)
    cfg.update(TOY_CFG)
    workload["traffic"].update(TOY_TRAFFIC)
    return spec, cell, cfg, workload


@pytest.mark.parametrize("trace", [False, True])
def test_a_run_gives_the_contracts_line(trace):
    spec, cell, cfg, workload = _toy()
    result = run.run_cell(torch, spec, cell, cfg, workload, seed=2**31 + 11, seconds=0.3,
                          trace=trace, device="cpu", t0=0.0)
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    assert list(result) == keys + (["breakdown", "checks"] if trace else ["checks"])
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    json.dumps(result)
    if trace:  # device metrics are never read from a CPU run
        assert set(result["metrics"]) <= {m["name"] for m in run.per_layer_metrics(spec, cell)}
        assert "mfu.moe" not in result["metrics"]
    else:
        assert set(result["metrics"]) == set(run.end_to_end_metrics(spec, cell))


def test_the_control_and_the_fault_fail_and_the_program_passes():
    _spec, _cell, cfg, workload = _toy()
    limits = workload["limits"]
    for seed in (1, 12345678901):
        row = control.readings(torch, cfg, workload, seed, "cpu")
        assert compare.judge(row["program"], limits), row["program"]
        assert not compare.judge(row["control"], limits), row["control"]
        assert not compare.judge(row["half_batch"], limits), row["half_batch"]


def _unchanged(monkeypatch):
    from parameter_server_tpu_torch.learner.hybrid import HybridLMTrainer

    def body_step(self, emb, tok):
        with torch.no_grad():
            loss = self._loss(emb.to(torch.float32), tok)
        return loss, torch.zeros_like(emb)

    monkeypatch.setattr(HybridLMTrainer, "_body_step", body_step)


def _half_batch(monkeypatch):
    from parameter_server_tpu_torch.learner.hybrid import HybridLMTrainer

    real = HybridLMTrainer._loss
    monkeypatch.setattr(HybridLMTrainer, "_loss", lambda self, emb, tok: real(
        self, emb[: emb.shape[0] // 2], tok[: tok.shape[0] // 2]))


def _no_balance_update(monkeypatch):
    from parameter_server_tpu_torch.learner.hybrid import HybridLMTrainer

    monkeypatch.setattr(HybridLMTrainer, "_balance_experts", lambda self: None)


@pytest.mark.parametrize("fault", [_unchanged, _half_batch, _no_balance_update],
                         ids=lambda f: f.__name__)
def test_a_broken_timed_path_is_not_correct(monkeypatch, fault):
    spec, cell, cfg, workload = _toy()
    fault(monkeypatch)
    result = run.run_cell(torch, spec, cell, cfg, workload, seed=2**31 + 3, seconds=0.2,
                          trace=False, device="cpu", t0=0.0)
    assert result["correct"] is False, result["checks"]


def test_the_step_flops_are_a_hand_count():
    """Moonlight cut to 9 layers on one card, by hand: latent attention
    2048 x 16 x 192 + 2048 x 576 + 512 x 16 x 256 + 16 x 128 x 2048 a layer;
    layer 0's MLP 3 x 2048 x 11264; each expert layer's router 2048 x 64 and
    shared experts 3 x 2048 x 2816; the head 2048 x 20480; an expert
    3 x 2048 x 1408."""
    cfg = json.loads((run.BENCH / "configs" / "moonlight-16b-a3b-hybrid.json").read_text())
    mla = 6_291_456 + 1_179_648 + 2_097_152 + 4_194_304
    assert roofline_moe.mla_matmul_params(cfg) == mla == 13_762_560
    dense = 9 * mla + 69_206_016 + 8 * (131_072 + 17_301_504) + 41_943_040
    assert roofline_moe.dense_path_matmul_params(cfg) == dense == 374_472_704
    assert roofline_moe.expert_matmul_params(cfg) == 8_650_752
    attention = 3 * 2048 ** 2 * 16 * (128 + 64 + 128) * 16 * 9
    # 2 steps of 6 choices a token in 8 layers, an 8th of them to the held experts
    held = 2 * 16 * 2048 * 6 * 8 // 8
    want = 2 * (6 * dense * 16 * 2048 + attention) + 6 * 8_650_752 * held
    assert roofline_moe.window_flops(cfg, 16, 2048, 2, held) == pytest.approx(want, rel=1e-12)
    # ~2.84 GFLOP a token
    assert want / (2 * 16 * 2048) == pytest.approx(2.84e9, rel=0.01)
