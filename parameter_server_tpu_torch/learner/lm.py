"""Language-model trainers: BERT MLM and causal LM (Llama) on one card or a
``(data, model)`` mesh.

Torch counterpart of ``parameter_server_tpu/learner/lm.py`` for BASELINE
configs #4 / #5.  With ``mesh=None`` the trainer runs on one card
(``device=``): one step is the forward, the loss, the backward and AdamW.  ``torch.optim.AdamW`` runs with optax ``adamw``'s defaults
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

On a mesh the parameters are DTensors placed by ``parallel/tp.py``'s rules
(``fsdp=True`` splits them over ``data`` too), and AdamW's moments take the
parameters' placements.  A step gathers each parameter over ``data`` only
(``tp.materialize``; a no-op without fsdp) and runs the model on the rank's
``model`` shards and its ``data`` block of the batch: the ``model`` axis
computes as Megatron splits (column- and row-parallel attention and MLP, a
vocab-parallel embedding and loss; ``models/transformer.py``), so no rank
holds a ``model``-split parameter, or the logits, whole.  The gradients come
back as partial sums over ``data``, so each parameter's gradient arrives
summed (all-reduced, or reduce-scattered onto its shard).  The loss is the
global batch's.  On a mesh the weights are ``trainer.params``;
``trainer.model`` is only the structure they run in (its parameters are on
the ``meta`` device).  ``fsdp`` is a layout, not a change to the math.  On
one card, or a ``model`` axis of one, the model is the one-card math.
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


class _Objective(torch.nn.Module):
    """The trainer's loss as a module over the model, so
    ``torch.func.functional_call`` can run it on the rank's shards."""

    def __init__(self, trainer: "SpmdLMTrainer") -> None:
        super().__init__()
        self.model = trainer.model
        self._loss = trainer._loss

    def forward(self, inputs, targets, mask):
        return self._loss(inputs, targets, mask)


class SpmdLMTrainer:
    """Trainer for the transformer family on one card or a mesh."""

    def __init__(
        self,
        cfg: tfm.TransformerConfig,
        mesh=None,
        *,
        learning_rate: float = 1e-3,
        seed: int = 0,
        dashboard: Optional[metrics_lib.Dashboard] = None,
        fsdp: bool = False,
        loss_chunk: int = 0,
        device: str | torch.device = "cuda",
    ) -> None:
        """``fsdp=True`` shards params AND optimizer moments over the data
        axis besides the TP rules (see ``parallel/tp.py``); ``loss_chunk`` >
        0 computes the causal loss with the head fused into checkpointed
        chunks (``chunked_causal_lm_loss``); composable with
        ``cfg.scan_blocks`` / ``cfg.remat``."""
        if loss_chunk > 0 and (not cfg.causal or cfg.tie_embeddings):
            raise ValueError(
                "loss_chunk requires a causal model with untied embeddings "
                "(the fused head reads params['lm_head'])"
            )
        # the route bias's balance update and the balance loss live in
        # HybridLMTrainer
        tfm.refuse_deepseek(cfg, "SpmdLMTrainer")
        self.cfg = cfg
        self.mesh = mesh
        self.device = torch.device(device) if mesh is None else mesh.device
        self.loss_chunk = loss_chunk
        from parameter_server_tpu_torch.parallel import tp

        # the blocks' config: the mesh's model axis is the split they compute
        self.model = tfm.Transformer(tp.split_config(cfg, mesh), device=self.device,
                                     generator=tfm.make_generator(self.device, seed))
        if mesh is None:
            self.params = None
            self.optimizer = adamw(self.model.parameters(), learning_rate)
        else:
            from parameter_server_tpu_torch.parallel import mesh as mesh_lib

            self.shardings = tp.transformer_param_shardings(self.model, mesh, fsdp=fsdp)
            #: dotted name -> DTensor parameter (the model runs on each
            #: step's local shards of them)
            self.params = tp.place_params(self.model, mesh, self.shardings)
            # the module keeps only the structure the placed weights run in:
            # its own full-size copies go to ``meta`` and hold no memory
            tfm.release_to_meta(self.model)
            self.optimizer = adamw(self.params.values(), learning_rate)
            self._n_data = mesh.shape[mesh_lib.DATA_AXIS]
            self._objective = _Objective(self)
        self.dashboard = lm_dashboard(dashboard, self.device)
        drop = frozenset({"pos_embedding"}) | (
            frozenset() if cfg.tie_embeddings else frozenset({"embedding"})
        )
        self.n_matmul_params = metrics_lib.lm_matmul_params(self.model.state_dict(), drop)
        self.step_count = 0

    def _loss(self, inputs, targets, mask) -> torch.Tensor:
        model = self.model
        cfg = model.cfg
        if cfg.causal and self.loss_chunk > 0:
            hidden = model.trunk(model.embed(inputs))
            return tfm.chunked_causal_lm_loss(hidden, model.lm_head.kernel, targets,
                                              self.loss_chunk, cfg)
        if cfg.causal:
            return tfm.causal_lm_loss(model(inputs), targets, cfg)
        return tfm.mlm_loss(model(inputs), targets, mask, cfg)

    def _mesh_loss(self, inputs, targets, mask) -> torch.Tensor:
        """This rank's share of the global loss (the shares sum to it over
        ``data``), on its ``model`` shards."""
        from torch.func import functional_call

        from parameter_server_tpu_torch.parallel import tp

        full = {f"model.{n}": t for n, t in tp.materialize(self.params, self.mesh).items()}
        loss = functional_call(self._objective, full, (inputs, targets, mask))
        if self._n_data == 1:
            return loss
        if mask is None:  # a causal loss: the data blocks hold equal counts
            return loss / self._n_data
        from parameter_server_tpu_torch.parallel import mesh as mesh_lib

        # MLM: the global mean over every block's masked positions
        local = torch.clamp(torch.sum(mask), min=1.0)
        total = self.mesh.all_reduce(torch.sum(mask).detach().clone(), mesh_lib.DATA_AXIS)
        return loss * (local / torch.clamp(total, min=1.0))

    def _update(self, inputs, targets, mask) -> torch.Tensor:
        """The loss, its backward and AdamW: the step with the loss left on
        the device (``parallel/feasibility.py`` traces it on fake tensors)."""
        self.model.train()
        if self.mesh is None:
            loss = self._loss(inputs, targets, mask)
        else:
            inputs, targets, mask = self._local_rows(inputs, targets, mask)
            loss = self._mesh_loss(inputs, targets, mask)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        if self.mesh is not None and self._n_data > 1:
            from parameter_server_tpu_torch.parallel import mesh as mesh_lib

            loss = self.mesh.all_reduce(loss.detach().clone(), mesh_lib.DATA_AXIS)
        return loss.detach()

    def _step(self, inputs, targets, mask) -> float:
        loss_f = float(self._update(inputs, targets, mask))
        self.step_count += 1
        # one example = one sequence: 6 x matmul params x seq tokens
        self.dashboard.flops_per_example = 6.0 * self.n_matmul_params * inputs.shape[1]
        self.dashboard.record(self.step_count, loss_f, examples=int(inputs.shape[0]))
        return loss_f

    def _tokens(self, x) -> torch.Tensor:
        return torch.as_tensor(np.asarray(x, np.int64)).to(self.device)

    def _local_rows(self, *arrays):
        """This rank's ``data`` block of each ``[B, S]`` tensor (None passes)."""
        from parameter_server_tpu_torch.parallel import distributed
        from parameter_server_tpu_torch.parallel import mesh as mesh_lib

        b = next(a for a in arrays if a is not None).shape[0]
        rows = distributed.local_batch_slice(self.mesh.index(mesh_lib.DATA_AXIS),
                                             self._n_data, b)
        return tuple(None if a is None else a[rows] for a in arrays)

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
        if self.mesh is None:
            return self.model(self._tokens(tokens)).cpu().numpy()
        from torch.func import functional_call

        from parameter_server_tpu_torch.parallel import tp

        # the step's math on the rank's shards; the vocabulary gathered once
        local = functional_call(self.model, tp.materialize(self.params, self.mesh),
                                (self._tokens(tokens),))
        return tp.gather_vocab(local, self.mesh, self.cfg.vocab_size).cpu().numpy()
