"""ResNet (v1.5 bottleneck) — BASELINE config #2 (ResNet-50/ImageNet).

Torch counterpart of ``parameter_server_tpu/models/resnet.py``.  The model
takes NHWC images as the flax model does and turns them into NCHW views once,
at the stem; the layout in memory stays channels-last throughout, which is
what the card's convolutions prefer.

What it keeps of flax, so one set of weights gives the same function:

- **Names and layouts.**  Every parameter sits at its flax path
  (``stem.kernel``, ``BottleneckBlock_3.Conv_1.kernel``, ``stem_bn.scale``,
  ``Dense_0.kernel``; the running statistics are the buffers ``mean`` and
  ``var``), conv kernels in flax's ``HWIO``, the dense kernel ``[in, out]``.
- **"SAME" padding.**  flax pads ``total = max((ceil(n / s) - 1) * s + k - n,
  0)`` with ``total // 2`` before and the rest after: asymmetric at stride 2
  on even inputs (the 7x7/2 stem on 224 pads 2 and 3, each stride-2 3x3 pads
  0 and 1, the 3x3/2 max-pool pads 0 and 1 with -inf).  Torch's ``padding=``
  is symmetric, so an asymmetric pad is an explicit ``F.pad``.
- **BatchNorm.**  Training normalises with the batch statistics; the running
  statistics move as ``ra = 0.9 * ra + 0.1 * batch`` with the *biased* batch
  variance (``F.batch_norm``'s own update would take the unbiased one), so
  they are updated here and ``F.batch_norm`` only normalises.  Evaluation
  (``model.eval()``) uses the running statistics.  On a data-parallel mesh
  (``BatchNorm.sync``, set by ``SpmdDenseTrainer``) the batch statistics
  are those of the GLOBAL batch, as GSPMD makes them for the JAX model (a
  mean over a sharded batch axis is a global reduction): each rank sums
  ``x`` and ``x * x`` per channel and the sums are all-reduced over
  ``data``, differentiably, before the normalisation.
- **Initialisation.**  Conv and dense kernels ``lecun_normal``, BatchNorm
  scale 1 and bias 0, except the last BatchNorm of each block, whose scale
  starts at 0.

A block's projection shortcut exists where its stride is not 1 or its
channels change (flax decides on the output shape, which differs only for a
1-pixel input to a stride-2 block).

ResNet-50 == ``ResNet(stage_sizes=[3, 4, 6, 3], bottleneck=True)``.
"""

from __future__ import annotations

from typing import Optional, Sequence, Tuple

import torch
import torch.nn.functional as F
from torch import nn

from parameter_server_tpu_torch.models.layers import Dense, lecun_normal_


def same_pads(n: int, k: int, s: int) -> Tuple[int, int]:
    """flax/XLA "SAME" padding of one spatial dim: (before, after)."""
    total = max((-(-n // s) - 1) * s + k - n, 0)
    return total // 2, total - total // 2


def _pad_same(x: torch.Tensor, k: int, s: int, value: float = 0.0):
    """``x`` padded for a k x k window at stride s, and the symmetric padding
    left for the op itself: an asymmetric pad is applied here, a symmetric one
    is handed to the op (no copy)."""
    (top, bottom), (left, right) = (same_pads(x.shape[2], k, s),
                                    same_pads(x.shape[3], k, s))
    if top == bottom and left == right:
        return x, (top, left)
    return F.pad(x, (left, right, top, bottom), value=value), (0, 0)


class Conv(nn.Module):
    """flax ``nn.Conv(use_bias=False)`` with "SAME" padding; kernel ``HWIO``."""

    def __init__(self, in_ch: int, out_ch: int, k: int, stride: int = 1,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.k, self.stride = k, stride
        self.kernel = nn.Parameter(torch.empty(k, k, in_ch, out_ch))
        lecun_normal_(self.kernel, k * k * in_ch, generator)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        x, pad = _pad_same(x, self.k, self.stride)
        return F.conv2d(x, self.kernel.permute(3, 2, 0, 1), stride=self.stride, padding=pad)


class BatchNorm(nn.Module):
    """flax ``nn.BatchNorm(momentum=0.9, epsilon=1e-5)`` over NCHW."""

    def __init__(self, ch: int, zero_scale: bool = False, momentum: float = 0.9,
                 eps: float = 1e-5) -> None:
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.scale = nn.Parameter(torch.zeros(ch) if zero_scale else torch.ones(ch))
        self.bias = nn.Parameter(torch.zeros(ch))
        self.register_buffer("mean", torch.zeros(ch))
        self.register_buffer("var", torch.ones(ch))
        #: ``(mesh, axis)`` whose ranks share the batch statistics, or None
        self.sync = None

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        if not self.training:
            return F.batch_norm(x, self.mean, self.var, self.scale, self.bias,
                                training=False, eps=self.eps)
        if self.sync is not None:
            return self._synced(x)
        # one pass for the statistics: the normalising call, at momentum 1,
        # leaves the batch mean and the unbiased batch variance in fresh
        # buffers; flax's running update takes the biased one
        mean, var = torch.zeros_like(self.mean), torch.zeros_like(self.var)
        y = F.batch_norm(x, mean, var, self.scale, self.bias, training=True,
                         momentum=1.0, eps=self.eps)
        n = x.numel() // x.shape[1]
        with torch.no_grad():
            m = self.momentum
            self.mean.mul_(m).add_(mean, alpha=1 - m)
            self.var.mul_(m).add_(var, alpha=(1 - m) * (n - 1) / n)
        return y

    def _synced(self, x: torch.Tensor) -> torch.Tensor:
        """Training normalisation with the statistics of every rank's batch
        along ``self.sync``'s axis: flax's mean and fast variance
        ``E[x^2] - E[x]^2`` over the global batch."""
        from torch.distributed.nn import functional as dist_fn

        mesh, axis = self.sync
        ch = x.shape[1]
        sums = torch.cat([x.sum(dim=(0, 2, 3)), (x * x).sum(dim=(0, 2, 3))])
        sums = dist_fn.all_reduce(sums, group=mesh.group(axis))
        n = (x.numel() // ch) * mesh.shape[axis]
        mean, mean2 = sums[:ch] / n, sums[ch:] / n
        var = torch.clamp_min(mean2 - mean * mean, 0.0)
        inv = torch.rsqrt(var + self.eps) * self.scale
        y = (x - mean[None, :, None, None]) * inv[None, :, None, None] \
            + self.bias[None, :, None, None]
        with torch.no_grad():
            m = self.momentum
            self.mean.mul_(m).add_(mean.detach(), alpha=1 - m)
            self.var.mul_(m).add_(var.detach(), alpha=1 - m)
        return y


class BottleneckBlock(nn.Module):
    expansion = 4

    def __init__(self, in_ch: int, filters: int, strides: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        out = filters * 4
        self.Conv_0 = Conv(in_ch, filters, 1, 1, generator)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, strides, generator)
        self.BatchNorm_1 = BatchNorm(filters)
        self.Conv_2 = Conv(filters, out, 1, 1, generator)
        self.BatchNorm_2 = BatchNorm(out, zero_scale=True)
        self.has_shortcut = in_ch != out or strides != 1
        if self.has_shortcut:
            self.shortcut = Conv(in_ch, out, 1, strides, generator)
            self.shortcut_bn = BatchNorm(out)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = torch.relu(self.BatchNorm_1(self.Conv_1(y)))
        y = self.BatchNorm_2(self.Conv_2(y))
        residual = self.shortcut_bn(self.shortcut(x)) if self.has_shortcut else x
        return torch.relu(residual + y)


class BasicBlock(nn.Module):
    expansion = 1

    def __init__(self, in_ch: int, filters: int, strides: int,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.Conv_0 = Conv(in_ch, filters, 3, strides, generator)
        self.BatchNorm_0 = BatchNorm(filters)
        self.Conv_1 = Conv(filters, filters, 3, 1, generator)
        self.BatchNorm_1 = BatchNorm(filters, zero_scale=True)
        self.has_shortcut = in_ch != filters or strides != 1
        if self.has_shortcut:
            self.shortcut = Conv(in_ch, filters, 1, strides, generator)
            self.shortcut_bn = BatchNorm(filters)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        y = torch.relu(self.BatchNorm_0(self.Conv_0(x)))
        y = self.BatchNorm_1(self.Conv_1(y))
        residual = self.shortcut_bn(self.shortcut(x)) if self.has_shortcut else x
        return torch.relu(residual + y)


class ResNet(nn.Module):
    """flax ``ResNet``; ``small_inputs``: 3x3 stem, no max-pool (CIFAR-style)."""

    def __init__(self, stage_sizes: Sequence[int], num_classes: int = 1000,
                 width: int = 64, bottleneck: bool = True, small_inputs: bool = False,
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.small_inputs = small_inputs
        if small_inputs:
            self.stem = Conv(3, width, 3, 1, generator)
        else:
            self.stem = Conv(3, width, 7, 2, generator)
        self.stem_bn = BatchNorm(width)
        block = BottleneckBlock if bottleneck else BasicBlock
        self.blocks = []
        in_ch = width
        for i, n_blocks in enumerate(stage_sizes):
            for j in range(n_blocks):
                strides = 2 if i > 0 and j == 0 else 1
                name = f"{block.__name__}_{len(self.blocks)}"
                self.add_module(name, block(in_ch, width * 2**i, strides, generator))
                self.blocks.append(name)
                in_ch = width * 2**i * block.expansion
        self.Dense_0 = Dense(in_ch, num_classes, generator)

    def forward(self, images: torch.Tensor) -> torch.Tensor:
        """images [B, H, W, 3] (NHWC) -> logits [B, num_classes]."""
        x = images.permute(0, 3, 1, 2)  # NCHW view of channels-last memory
        x = torch.relu(self.stem_bn(self.stem(x)))
        if not self.small_inputs:
            x, pad = _pad_same(x, 3, 2, value=float("-inf"))
            x = F.max_pool2d(x, 3, 2, padding=pad)
        for name in self.blocks:
            x = getattr(self, name)(x)
        return self.Dense_0(x.mean(dim=(2, 3)))


def resnet18(**kw) -> ResNet:
    return ResNet(stage_sizes=[2, 2, 2, 2], bottleneck=False, **kw)


def resnet50(**kw) -> ResNet:
    return ResNet(stage_sizes=[3, 4, 6, 3], bottleneck=True, **kw)
