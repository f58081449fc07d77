"""The yardstick's arithmetic: the card's data-sheet peaks and the work a
step needs, counted from shapes.

Peaks are NVIDIA's H100 SXM data sheet (dense rates, no sparsity, at the
card's full 700 W limit); the arithmetic of ``H100_SXM_PEAK_FLOPS`` and of
the math mode read from torch's flags is copied from the port's
``utils/metrics.py``.  Operations and bytes are what the algorithm needs for
the inputs given (no recompute, no re-reads), so a share of a peak computed
from them cannot pass 100% unless the time leaves out part of the work.
"""

from __future__ import annotations

#: dense peak FLOP/s of one H100 SXM by math mode (data sheet)
H100_SXM_PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "fp32": 67e12}
#: HBM3 bytes/s of one H100 SXM (data sheet)
H100_SXM_PEAK_BYTES = 3.35e12
#: card names (as ``torch.cuda.get_device_name`` gives them) -> peak table
CARD_PEAKS = (("H100 80GB HBM3", H100_SXM_PEAK_FLOPS), ("H100 SXM", H100_SXM_PEAK_FLOPS))


def peak_flops(card_name: str, math_mode: str) -> float:
    """Data-sheet peak of ``card_name`` in ``math_mode``; raises for a card
    the table does not know (no share of a guessed peak is reported)."""
    for pattern, table in CARD_PEAKS:
        if pattern in card_name:
            return table[math_mode]
    raise ValueError(f"no data-sheet peak for card {card_name!r}")


def peak_bytes(card_name: str) -> float:
    peak_flops(card_name, "fp32")  # the same card check
    return H100_SXM_PEAK_BYTES


def float32_matmul_mode(torch) -> str:
    """The math mode a float32 matmul runs in under torch's current flags."""
    if torch.backends.cuda.matmul.allow_tf32:
        return "tf32"
    return {"highest": "fp32", "high": "tf32", "medium": "bf16"}[
        torch.get_float32_matmul_precision()]


# -- sparse logistic regression (one dense-mode step) --------------------------


def lr_step_flops(batch: int, nnz: int, unique_slots: int) -> float:
    """Operations one LR step needs: the per-example sum of ``nnz`` weights
    and the per-position gradient's sum into its slot (one add each), the
    loss and residual (~10 an example), AdaGrad on each touched slot (6: the
    square, the add, the root, the eps add, the divide and the update)."""
    return 2.0 * batch * nnz + 10.0 * batch + 6.0 * unique_slots


def lr_step_bytes(batch: int, nnz: int, unique_slots: int, key_bytes: int = 4) -> float:
    """Bytes one LR step needs: the raw keys and the labels read once, each
    unique touched slot's value and AdaGrad state read and written once
    (fp32), and the loss written."""
    return (batch * nnz * key_bytes + batch * 4 + unique_slots * 4 * 2 * 2 + 4)


def least_time_s(flops: float, nbytes: float, card_name: str, math_mode: str) -> float:
    """The least time the card could take: the larger of the two bounds."""
    return max(flops / peak_flops(card_name, math_mode), nbytes / peak_bytes(card_name))


# -- a decoder-only transformer body (Llama / Mistral blocks) ------------------


def block_matmul_params(d_model: int, n_heads: int, n_kv_heads: int, head_dim: int,
                        d_ff: int) -> int:
    """Matmul parameters of one block: q, k, v, o and the gated MLP."""
    attn = d_model * n_heads * head_dim * 2 + d_model * n_kv_heads * head_dim * 2
    return attn + 3 * d_model * d_ff


def body_matmul_params(cfg: dict) -> int:
    """N_matmul of the hybrid body: the blocks and the untied head (the
    input embedding lives on the servers and is no matmul)."""
    per_block = block_matmul_params(cfg["hidden_size"], cfg["num_attention_heads"],
                                    cfg["num_key_value_heads"], head_dim(cfg),
                                    cfg["intermediate_size"])
    return cfg["num_hidden_layers"] * per_block + cfg["hidden_size"] * cfg["vocab_size"]


def body_params(cfg: dict) -> int:
    """Every parameter of the body: the matmuls, two norm scales a block and
    the final norm."""
    d = cfg["hidden_size"]
    return body_matmul_params(cfg) + cfg["num_hidden_layers"] * 2 * d + d


def head_dim(cfg: dict) -> int:
    return cfg.get("head_dim") or cfg["hidden_size"] // cfg["num_attention_heads"]


def causal_attention_flops(seq: int, d_model: int) -> float:
    """Training FLOPs causal attention needs in one layer for one sequence:
    the score and value products (2 x 2 S^2 d) over the lower triangle (a
    half), forward and backward (x 3): 3 x 2 x S^2 x d."""
    return 3.0 * 2.0 * seq * seq * d_model


def train_step_flops(cfg: dict, batch: int, seq: int) -> float:
    """Model FLOPs of one training step: 6 N_matmul per token plus causal
    attention; recompute and the embedding table are not counted."""
    tokens = batch * seq
    attn = cfg["num_hidden_layers"] * batch * causal_attention_flops(seq, cfg["hidden_size"])
    return 6.0 * body_matmul_params(cfg) * tokens + attn
