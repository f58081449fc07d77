"""Offline model evaluation from saved checkpoints.

Torch-package counterpart of ``parameter_server_tpu/evaluation.py``: host
numpy over the port's checkpoints (``checkpoint.load_global_weights``), so
it reads a checkpoint either package wrote.  Reference analogue:
``src/app/linear_method/model_evaluation.h`` [U] — after SaveModel, read the
servers' weight files back and score a validation set (AUC).  Evaluation
reassembles the global table on the host and scores batches without
standing up a cluster.
"""

from __future__ import annotations

from typing import Callable, Iterable, Optional, Tuple

import numpy as np

from parameter_server_tpu_torch import checkpoint
from parameter_server_tpu_torch.models.fm import eval_logits_np
from parameter_server_tpu_torch.utils import metrics as metrics_lib
from parameter_server_tpu_torch.utils.keys import HashLocalizer, localizer_from_meta

Batch = Tuple[np.ndarray, np.ndarray]  # (keys [B, nnz], labels [B])


def _scores_lr(weights: np.ndarray, slots_pos: np.ndarray, bias: float) -> np.ndarray:
    return weights[slots_pos, 0].sum(axis=-1) + bias


def evaluate_checkpoint(
    root: str,
    table: str,
    batches: Iterable[Batch],
    *,
    step: Optional[int] = None,
    model: str = "lr",
    localizer: Optional[HashLocalizer] = None,
    hash_bits: Optional[int] = None,
    bias: float = 0.0,
) -> dict:
    """Score ``batches`` against the saved model; returns metrics.

    ``model``: ``"lr"`` (sum of weights) or ``"fm"`` (factorization machine,
    table dim = 1 + k).  The key->row mapping must match training: an
    explicit ``localizer`` wins; otherwise the manifest's recorded localizer
    metadata (``KVWorker.save_model`` writes it) is reconstructed; only as a
    last resort is a default ``HashLocalizer`` assumed, with ``hash_bits``
    overriding its width (a 32-bit device-hash table scored with the 64-bit
    default mis-assigns every row).

    Note: weights are read as raw value rows; for lazy-weight optimizers
    (FTRL) pass the training-time table through ``KVTable.weights()`` and a
    direct scorer instead — the checkpoint stores z/n, not w.
    """
    if step is None:
        step = checkpoint.latest_step(root)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint under {root}")
    weights = checkpoint.load_global_weights(root, step, table)
    rows = weights.shape[0]
    loc = localizer
    if loc is None:
        meta = checkpoint.read_info(root, step).extras.get("localizers", {})
        if table in meta:
            m = dict(meta[table])
            if hash_bits is not None and m.get("kind") == "HashLocalizer":
                # override the width only — the recorded seed must survive,
                # or the override reintroduces the mis-scoring it exists to fix
                m["hash_bits"] = hash_bits
            loc = localizer_from_meta(m)
    if loc is None:
        loc = HashLocalizer(rows, hash_bits=hash_bits or 64)

    if model == "lr":
        score: Callable = lambda sp: _scores_lr(weights, sp, bias)
    elif model == "fm":
        score = lambda sp: eval_logits_np(weights, bias, sp)
    else:
        raise ValueError(f"unknown model {model!r}")

    scores, labels_all = [], []
    for keys, labels in batches:
        slots_pos = np.minimum(loc.assign(keys), rows - 1)
        scores.append(score(slots_pos))
        labels_all.append(labels)
    s = np.concatenate(scores)
    y = np.concatenate(labels_all)
    return {
        "step": step,
        "examples": int(y.shape[0]),
        "auc": metrics_lib.auc(y, s),
        "logloss": float(
            np.mean(np.maximum(s, 0) - s * y + np.log1p(np.exp(-np.abs(s))))
        ),
    }
