"""Each driver at a toy size on the CPU: the program agrees with the plain
reference under the cell's limits; the control (the reference in the
precision below the configuration's, in the program's place) and the
half-batch fault do not; and a run whose timed path is broken underneath
comes out not correct."""

from __future__ import annotations

import pytest
import torch

from psbench import compare, control, run

CELLS = ["criteo-lr.local-b16k", "mistral-7b-hybrid.s512-b8", "mistral-7b-hybrid.s4096-b1"]


@pytest.mark.parametrize("name", CELLS)
def test_program_passes_and_control_and_fault_fail(tiny, name):
    _spec, _cell, cfg, workload = tiny(name)
    limits = workload["limits"]
    for seed in (1, 2**31 + 7, 12345678901):
        row = control.readings(torch, cfg, workload, seed, "cpu")
        assert compare.judge(row["program"], limits), row["program"]
        assert not compare.judge(row["control"], limits), row["control"]
        assert not compare.judge(row["half_batch"], limits), row["half_batch"]


def test_a_row_whose_gradients_cancel_to_rounding_is_no_mismatch():
    """A row's sum of squares at rounding's size (its gradients cancelled)
    is a write of its own level; the smallest real write, seven orders under
    the median, is a write.  Only a write against no write at all counts."""
    sum_sq = torch.tensor([0.0, *[1e-9] * 5, 1e-16, 1e-23])
    levels = compare.write_levels(sum_sq)
    assert levels.tolist() == [0] + [2] * 6 + [1]
    reading = {"losses": [1.0], "grad": {"w": 1.0}, "change": {"w": 1.0}}
    cancelled = {**reading, "rows": compare.write_levels(torch.tensor([0.0, *[1e-9] * 5, 1e-16, 0.0]))}
    assert compare.numbers({**reading, "rows": levels}, cancelled)["slot_mismatch"] == 0
    moved = {**reading, "rows": compare.write_levels(torch.tensor([1e-9, *[1e-9] * 5, 0.0, 1e-23]))}
    assert compare.numbers({**reading, "rows": levels}, moved)["slot_mismatch"] == 2


def _lr_unchanged(monkeypatch):
    from parameter_server_tpu_torch.learner.sgd import LocalLRTrainer

    real = LocalLRTrainer.step_block_device

    def step(self, keys, labels):
        planes = [self.table.value, *self.table.state.values(), self.bias,
                  *self.bias_state.values()]
        kept = [p.clone() for p in planes]
        losses = real(self, keys, labels)
        for p, k in zip(planes, kept):
            p.copy_(k)
        return losses

    monkeypatch.setattr(LocalLRTrainer, "step_block_device", step)


def _lr_half_batch(monkeypatch):
    from parameter_server_tpu_torch.learner.sgd import LocalLRTrainer

    real = LocalLRTrainer.step_block_device
    monkeypatch.setattr(LocalLRTrainer, "step_block_device", lambda self, k, y: real(
        self, k[:, : k.shape[1] // 2], y[:, : y.shape[1] // 2]))


def _hybrid_unchanged(monkeypatch):
    from parameter_server_tpu_torch.learner.hybrid import HybridLMTrainer

    def body_step(self, emb, tok):
        with torch.no_grad():
            loss = self._loss(emb.to(torch.float32), tok)
        return loss, torch.zeros_like(emb)

    monkeypatch.setattr(HybridLMTrainer, "_body_step", body_step)


def _hybrid_half_batch(monkeypatch):
    from parameter_server_tpu_torch.learner.hybrid import HybridLMTrainer

    real = HybridLMTrainer._loss
    monkeypatch.setattr(HybridLMTrainer, "_loss", lambda self, emb, tok: real(
        self, emb[: emb.shape[0] // 2], tok[: tok.shape[0] // 2]))


FAULTS = {"criteo-lr.local-b16k": [_lr_unchanged, _lr_half_batch],
          "mistral-7b-hybrid.s512-b8": [_hybrid_unchanged, _hybrid_half_batch]}


@pytest.mark.parametrize("name,fault", [(n, f) for n, fs in FAULTS.items() for f in fs],
                         ids=lambda x: getattr(x, "__name__", x))
def test_a_broken_timed_path_is_not_correct(tiny, monkeypatch, name, fault):
    """The whole run but the look for a card, with the program's step broken:
    its state left unchanged, or half of each batch left out."""
    spec, cell, cfg, workload = tiny(name)
    fault(monkeypatch)
    result = run.run_cell(torch, spec, cell, cfg, workload, seed=2**31 + 3, seconds=0.2,
                          trace=False, device="cpu", t0=0.0)
    assert result["correct"] is False, result["checks"]
