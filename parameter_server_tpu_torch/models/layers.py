"""Layers shared by the dense models, in flax's parameter layout.

The port's DLRM and ResNet store every parameter under flax's name and in
flax's layout (``Dense_0.kernel`` as ``[in, out]``, a conv kernel as
``HWIO``), so a parameter's dotted name in ``named_parameters()`` is its path
in the JAX package's params tree.  Carrying weights between the packages is
then a copy by name (``convert.py``), and the dense store's flat vector
(``kv/dense.py::PytreeCodec``) is ``ravel_pytree`` of that tree, element for
element.

Initialisation follows flax's defaults: kernels ``lecun_normal`` (a normal
truncated at two standard deviations, scaled to variance ``1 / fan_in``),
biases zero.  Draws come from an explicit ``torch.Generator``.
"""

from __future__ import annotations

import math
from typing import Dict, Optional

import torch
from torch import nn

#: standard deviation of a unit normal truncated to [-2, 2] (flax's
#: ``variance_scaling`` divides by it so the truncated draw keeps its variance)
_TRUNC_STD = 0.87962566103423978


def lecun_normal_(w: torch.Tensor, fan_in: int,
                  generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """flax's ``lecun_normal()`` in place: truncated normal, variance 1/fan_in."""
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        return nn.init.trunc_normal_(w, std=std, a=-2 * std, b=2 * std,
                                     generator=generator)


class Dense(nn.Module):
    """flax ``nn.Dense``: ``x @ kernel + bias``, the kernel stored ``[in, out]``."""

    def __init__(self, in_features: int, out_features: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.kernel = nn.Parameter(torch.empty(in_features, out_features))
        self.bias = nn.Parameter(torch.zeros(out_features))
        lecun_normal_(self.kernel, in_features, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return torch.addmm(self.bias, x, self.kernel)


def params_tree(module: nn.Module, grads: bool = False) -> Dict[str, object]:
    """The module's parameters (or their ``.grad``) as a nested dict keyed by
    flax path, the shape of the JAX package's ``variables["params"]``."""
    tree: Dict[str, object] = {}
    for name, p in module.named_parameters():
        *path, leaf = name.split(".")
        node = tree
        for part in path:
            node = node.setdefault(part, {})
        node[leaf] = p.grad if grads else p
    return tree


def flat_items(tree, prefix: str = ""):
    """``(dotted path, leaf)`` of a nested dict in ``jax.tree`` order: keys
    sorted at every level, as jax flattens a dict."""
    for key in sorted(tree):
        node, path = tree[key], f"{prefix}{key}"
        if isinstance(node, dict):
            yield from flat_items(node, path + ".")
        else:
            yield path, node
