"""Language-model trainers: BERT MLM and causal LM (Llama) on one card.

Torch counterpart of ``parameter_server_tpu/learner/lm.py`` for BASELINE
configs #4 / #5.  The JAX trainer's ``data x model`` mesh collapses to one
card (``device=``): one step is the forward, the loss, the backward and
AdamW.  ``torch.optim.AdamW`` runs with optax ``adamw``'s defaults
(``betas=(0.9, 0.999)``, ``eps=1e-8``, ``weight_decay=1e-4``; torch's own
default decay of 0.01 would leave the reference's trajectory at the first
step).  Parameters start from :class:`~parameter_server_tpu_torch.models.
transformer.Transformer`'s init on ``device`` with a generator seeded by
``seed``; ``convert.transformer_from_numpy`` carries a flax tree in.

The dashboard's MFU is the JAX trainer's: 6 x the matmul parameters
(``metrics.lm_matmul_params``: the input embedding counts only when tied,
learned positions never) x the sequence, an example being one sequence,
over the card's peak for the math mode the step's float32 matmuls run in
(``metrics.float32_math_mode("matmul")``).

``fsdp=True`` shards parameters and moments over a data axis: that needs the
port's ``parallel/tp.py`` (ROADMAP Queue 1 step 9) and raises here.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch.models import transformer as tfm
from parameter_server_tpu_torch.utils import metrics as metrics_lib

#: optax.adamw's defaults, which torch.optim.AdamW must be given
ADAMW = dict(betas=(0.9, 0.999), eps=1e-8, weight_decay=1e-4)


def make_mlm_batch(
    tokens: np.ndarray, vocab_size: int, rng: np.random.Generator,
    mask_token: int = 0, mask_rate: float = 0.15,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """BERT masking: 15% positions; 80% [MASK], 10% random, 10% kept."""
    mask = rng.random(tokens.shape) < mask_rate
    r = rng.random(tokens.shape)
    inputs = tokens.copy()
    inputs[mask & (r < 0.8)] = mask_token
    rand_sites = mask & (r >= 0.8) & (r < 0.9)
    inputs[rand_sites] = rng.integers(
        0, vocab_size, size=int(rand_sites.sum()), dtype=tokens.dtype
    )
    return inputs, tokens, mask.astype(np.float32)


def adamw(params, learning_rate: float) -> torch.optim.AdamW:
    """``optax.adamw(learning_rate)``'s rule as a torch optimizer."""
    return torch.optim.AdamW(params, lr=learning_rate, **ADAMW)


def lm_dashboard(dashboard: Optional[metrics_lib.Dashboard], device) -> metrics_lib.Dashboard:
    """A trainer's dashboard with the MFU denominator of one card's float32
    matmuls (a caller's non-zero ``peak_flops`` wins)."""
    return metrics_lib.trainer_dashboard(dashboard, 1, metrics_lib.float32_math_mode("matmul"),
                                         device)


class SpmdLMTrainer:
    """Trainer for the transformer family on one card."""

    def __init__(
        self,
        cfg: tfm.TransformerConfig,
        *,
        learning_rate: float = 1e-3,
        seed: int = 0,
        dashboard: Optional[metrics_lib.Dashboard] = None,
        fsdp: bool = False,
        loss_chunk: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        """``loss_chunk`` > 0 computes the causal loss with the head fused
        into checkpointed chunks (``chunked_causal_lm_loss``); composable
        with ``cfg.scan_blocks`` / ``cfg.remat``."""
        if fsdp:
            raise NotImplementedError(
                "fsdp=True needs the port's parallel/tp.py "
                "(transformer_param_shardings): ROADMAP Queue 1 step 9"
            )
        if loss_chunk > 0 and (not cfg.causal or cfg.tie_embeddings):
            raise ValueError(
                "loss_chunk requires a causal model with untied embeddings "
                "(the fused head reads params['lm_head'])"
            )
        self.cfg = cfg
        self.device = torch.device(device)
        self.loss_chunk = loss_chunk
        self.model = tfm.Transformer(cfg, device=self.device,
                                     generator=tfm.make_generator(self.device, seed))
        self.optimizer = adamw(self.model.parameters(), learning_rate)
        self.dashboard = lm_dashboard(dashboard, self.device)
        drop = frozenset({"pos_embedding"}) | (
            frozenset() if cfg.tie_embeddings else frozenset({"embedding"})
        )
        self.n_matmul_params = metrics_lib.lm_matmul_params(self.model.state_dict(), drop)
        self.step_count = 0

    def _loss(self, inputs, targets, mask) -> torch.Tensor:
        cfg, model = self.cfg, self.model
        if cfg.causal and self.loss_chunk > 0:
            hidden = model.trunk(model.embedding[inputs])
            return tfm.chunked_causal_lm_loss(hidden, model.lm_head.kernel, targets,
                                              self.loss_chunk)
        if cfg.causal:
            return tfm.causal_lm_loss(model(inputs), targets)
        return tfm.mlm_loss(model(inputs), targets, mask)

    def _step(self, inputs, targets, mask) -> float:
        self.model.train()
        loss = self._loss(inputs, targets, mask)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        loss_f = float(loss.detach())
        self.step_count += 1
        # one example = one sequence: 6 x matmul params x seq tokens
        self.dashboard.flops_per_example = 6.0 * self.n_matmul_params * inputs.shape[1]
        self.dashboard.record(self.step_count, loss_f, examples=int(inputs.shape[0]))
        return loss_f

    def _tokens(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.int64)).to(self.device)

    # -- steps --------------------------------------------------------------
    def step_causal(self, tokens: np.ndarray) -> float:
        if not self.cfg.causal:
            raise ValueError("step_causal on a non-causal (MLM) trainer")
        tok = self._tokens(tokens)
        return self._step(tok, tok, None)

    def step_mlm(self, inputs: np.ndarray, targets: np.ndarray, mask: np.ndarray) -> float:
        if self.cfg.causal:
            raise ValueError("step_mlm on a causal-LM trainer")
        m = torch.as_tensor(np.asarray(mask, np.float32)).to(self.device)
        return self._step(self._tokens(inputs), self._tokens(targets), m)

    @torch.no_grad()
    def logits(self, tokens: np.ndarray) -> np.ndarray:
        return self.model(self._tokens(tokens)).cpu().numpy()
