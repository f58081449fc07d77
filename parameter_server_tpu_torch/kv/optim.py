"""Server-side optimizers: row-wise update rules applied on Push.

Torch counterpart of ``parameter_server_tpu/kv/optim.py``.  An optimizer is a
pair of elementwise functions over ``[n, dim]`` row tensors: ``apply``
consumes gradient rows and per-row state rows; ``pull_weights`` maps stored
value rows to servable weights (identity except for FTRL).  These functions
are the plain versions of the fused apply kernel's rule math
(``csrc/scatter_kernels.cu``, ``apply_rule``), which mirrors them line by line.
"""

from __future__ import annotations

from typing import Callable, Dict

import torch

from parameter_server_tpu_torch.config import OptimizerConfig

Rows = torch.Tensor  # [n, dim]
State = Dict[str, Rows]


class ServerOptimizer:
    """Interface: init per-row state, apply updates, derive pull weights."""

    name = "base"
    #: kernel selector passed to ``ps_apply`` (see ``csrc/scatter_kernels.cu``)
    kernel_kind = -1
    #: True iff apply(value, state, 0) == (value, state) when l1 == l2 == 0:
    #: required by the dense (full-table elementwise) apply of the LR step.
    g0_stable = False

    def __init__(self, cfg: OptimizerConfig) -> None:
        self.cfg = cfg

    def state_shapes(self) -> Dict[str, float]:
        """State array names -> fill value at init."""
        return {}

    def state_names(self) -> tuple[str, ...]:
        """Deterministic state-plane order (the kernel's s0, s1, s2)."""
        return tuple(sorted(self.state_shapes()))

    def apply(self, value: Rows, state: State, grad: Rows) -> tuple[Rows, State]:
        raise NotImplementedError

    def pull_weights(self, value: Rows, state: State) -> Rows:
        return value


class SGD(ServerOptimizer):
    g0_stable = True
    name = "sgd"
    kernel_kind = 0

    def apply(self, value, state, grad):
        cfg = self.cfg
        g = grad + cfg.l2 * value
        return value - cfg.learning_rate * g, state


class AdaGrad(ServerOptimizer):
    """AdaGrad with optional L1 truncation (the async-SGD sparse LR rule)."""

    g0_stable = True
    name = "adagrad"
    kernel_kind = 1

    def state_shapes(self):
        return {"sum_sq": 0.0}

    def apply(self, value, state, grad):
        cfg = self.cfg
        g = grad + cfg.l2 * value
        sum_sq = state["sum_sq"] + g * g
        lr = cfg.learning_rate / (torch.sqrt(sum_sq) + cfg.eps)
        new = value - lr * g
        if cfg.l1 > 0:
            # soft-threshold (proximal L1): shrink toward zero by lr*l1
            new = torch.sign(new) * torch.clamp_min(torch.abs(new) - lr * cfg.l1, 0.0)
        return new, {"sum_sq": sum_sq}


class Adam(ServerOptimizer):
    """Adam with per-row step counts."""

    name = "adam"
    kernel_kind = 2

    def state_shapes(self):
        return {"m": 0.0, "v": 0.0, "t": 0.0}

    def apply(self, value, state, grad):
        cfg = self.cfg
        g = grad + cfg.l2 * value
        t = state["t"] + 1.0
        m = cfg.beta1 * state["m"] + (1 - cfg.beta1) * g
        v = cfg.beta2 * state["v"] + (1 - cfg.beta2) * g * g
        m_hat = m / (1 - torch.pow(cfg.beta1, t))
        v_hat = v / (1 - torch.pow(cfg.beta2, t))
        new = value - cfg.learning_rate * m_hat / (torch.sqrt(v_hat) + cfg.eps)
        return new, {"m": m, "v": v, "t": t}


class FTRL(ServerOptimizer):
    """FTRL-proximal: value stores ``z``; state stores ``n``; the weight is
    computed lazily on Pull (and inside ``apply``)."""

    g0_stable = True
    name = "ftrl"
    kernel_kind = 3

    def state_shapes(self):
        return {"n": 0.0}

    def pull_weights(self, value, state):
        cfg = self.cfg
        z, n = value, state["n"]
        w = -(z - torch.sign(z) * cfg.l1) / (
            (cfg.ftrl_beta + torch.sqrt(n)) / cfg.ftrl_alpha + cfg.l2
        )
        return torch.where(torch.abs(z) <= cfg.l1, torch.zeros_like(w), w)

    def apply(self, value, state, grad):
        cfg = self.cfg
        z, n = value, state["n"]
        w = self.pull_weights(z, state)
        sigma = (torch.sqrt(n + grad * grad) - torch.sqrt(n)) / cfg.ftrl_alpha
        z = z + grad - sigma * w
        n = n + grad * grad
        return z, {"n": n}


_REGISTRY: Dict[str, Callable[[OptimizerConfig], ServerOptimizer]] = {
    "sgd": SGD,
    "adagrad": AdaGrad,
    "adam": Adam,
    "ftrl": FTRL,
}


def make_optimizer(cfg: OptimizerConfig) -> ServerOptimizer:
    try:
        return _REGISTRY[cfg.kind](cfg)
    except KeyError:
        raise ValueError(
            f"unknown optimizer {cfg.kind!r}; have {sorted(_REGISTRY)}"
        ) from None


def require_dense_apply(cfg: OptimizerConfig) -> None:
    """Validate that ``cfg`` is safe for the dense-apply (full-table) paths.

    Dense apply touches every row each step, so the update must be exactly
    zero at g=0: no penalties, and a ``g0_stable`` rule.
    """
    opt = make_optimizer(cfg)
    if cfg.l1 != 0.0 or cfg.l2 != 0.0 or not opt.g0_stable:
        raise ValueError(
            "dense-apply requires l1=l2=0 and a g0-stable optimizer "
            f"(got kind={cfg.kind!r}, l1={cfg.l1}, l2={cfg.l2}); "
            "use the row-apply path instead"
        )
