"""Plain reference of the sparse LR cells: hashed logistic regression
trained by AdaGrad, step after step, written from its definition.

It imports nothing of the program.  The slot of a key is the device hash's
arithmetic as the configuration states it (murmur3's 32-bit finaliser of the
key xor ``hash_seed``, modulo ``table_rows``; a frozen copy), and each step
updates only the rows its batch touched (a sparse formulation, where the
program applies the rule over the whole table).

``precision`` is the dtype the planes and the arithmetic are held in
(``"float32"`` as the configuration states; ``"bfloat16"`` is the
control), and
``half_batch`` the fault that drops the second half of every batch and takes
the mean over the rest.
"""

from __future__ import annotations

import torch

from psbench.compare import write_levels
from psbench.traffic import fmix32

_MASK32 = 0xFFFF_FFFF


def slots(keys: torch.Tensor, rows: int, seed: int) -> torch.Tensor:
    """Row slot of each 32-bit key (int32 views of uint32): the hash modulo
    ``rows``, and ``rows`` (the trash row) for the PAD key 2**32 - 1."""
    x = keys.to(torch.int64) & _MASK32
    return torch.where(x == _MASK32, rows, fmix32(x, seed) % rows)


def _softplus_loss(logits: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """Mean binary cross-entropy from logits, in the logits' precision."""
    return torch.mean(torch.clamp_min(logits, 0) - logits * labels
                      + torch.log1p(torch.exp(-torch.abs(logits))))


def train(cfg: dict, keys_blocks: torch.Tensor, labels_blocks: torch.Tensor, *,
          precision: str = "float32", half_batch: bool = False) -> dict:
    """Train from the configuration's zero table over blocks of batches
    ``keys_blocks`` [N, K, B, nnz] and ``labels_blocks`` [N, K, B], on their
    device.  Returns the readings: every step's loss, each leaf's gradient
    norm as AdaGrad holds it after the first block (the root of its summed
    squares), each leaf's change after all ``N`` blocks, and each row's
    write level after the first block."""
    dtype = getattr(torch, precision)
    opt = cfg["optimizer"]
    lr, eps = opt["learning_rate"], opt["eps"]
    rows = cfg["table_rows"]
    dev = keys_blocks.device
    value = torch.zeros(rows + 1, dtype=dtype, device=dev)
    sum_sq = torch.zeros(rows + 1, dtype=dtype, device=dev)
    bias = torch.zeros((), dtype=dtype, device=dev)
    bias_sq = torch.zeros((), dtype=dtype, device=dev)
    losses, grad, levels = [], {}, None
    for n in range(keys_blocks.shape[0]):
        for k in range(keys_blocks.shape[1]):
            keys, labels = keys_blocks[n, k], labels_blocks[n, k].to(dtype)
            if half_batch:
                keys, labels = keys[: keys.shape[0] // 2], labels[: labels.shape[0] // 2]
            s = slots(keys, rows, cfg["hash_seed"])
            logits = value[s].sum(dim=1) + bias
            losses.append(float(_softplus_loss(logits, labels)))
            residual = (torch.sigmoid(logits) - labels) / labels.shape[0]
            uniq, inv = torch.unique(s.reshape(-1), return_inverse=True)
            g = torch.zeros(uniq.shape[0], dtype=dtype, device=dev)
            g.index_add_(0, inv, residual[:, None].expand(s.shape).reshape(-1))
            keep = uniq != rows  # PAD positions leave the trash row alone
            uniq, g = uniq[keep], g[keep]
            sum_sq[uniq] += g * g
            value[uniq] -= lr * g / (torch.sqrt(sum_sq[uniq]) + eps)
            gb = residual.sum()
            bias_sq += gb * gb
            bias -= lr * gb / (torch.sqrt(bias_sq) + eps)
        if n == 0:
            grad = {"table": float(torch.sqrt(sum_sq.double().sum())),
                    "bias": float(torch.sqrt(bias_sq.double()))}
            levels = write_levels(sum_sq[:rows])
    change = {"table": float(torch.linalg.vector_norm(value.double())),
              "bias": float(bias.double().abs())}
    return {"losses": losses, "grad": grad, "change": change, "rows": levels}
