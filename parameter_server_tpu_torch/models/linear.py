"""Sparse logistic regression: the worker-side math of the PS loop.

Torch counterpart of ``predict_logits``, ``logloss`` and ``grad_rows`` in
``parameter_server_tpu/models/linear.py``.  With one-hot categorical features
the per-example logit is the sum of the weights at the example's keys plus
bias, and d(loss)/d(w_k) = (p - y) for each position holding key k.  The
fused single-device steps wait for the ``LocalLRTrainer`` slice.
"""

from __future__ import annotations

from typing import Tuple

import torch


def predict_logits(w_pos: torch.Tensor, bias) -> torch.Tensor:
    """Per-example logits from per-position weights ``[B, nnz]``."""
    return torch.sum(w_pos, dim=-1) + bias


def logloss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits (numerically stable)."""
    return torch.mean(
        torch.clamp_min(logits, 0) - logits * labels
        + torch.log1p(torch.exp(-torch.abs(logits)))
    )


def grad_rows(
    w_pos: torch.Tensor, labels: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Per-position gradient values: ``(grads [B, nnz], bias_grad [], loss [])``."""
    logits = predict_logits(w_pos, 0.0)
    residual = torch.sigmoid(logits) - labels  # [B]
    g = residual[:, None].expand(w_pos.shape)
    return g, torch.mean(residual), logloss(logits, labels)
