"""Plain reference of the hybrid LM cells: a Mistral-style decoder (GQA,
interleaved rotary pairs, RMS norm, SiLU-gated MLP, no bias, untied head)
whose input embedding is a table trained by AdaGrad while the body trains by
AdamW, step after step, written from the published description.

It imports nothing of the program.  It also makes the cells' weights:
:func:`make_weights` draws every matrix from the seed on the card in one
call, and the benchmark hands the same tensors to the program and to
:func:`train`.

``matmul`` is the precision of every matrix product: ``"fp32"`` as the
configuration states, or ``"tf32"`` (the control), whose operands are
rounded to TF32's 10-bit mantissa, forward and backward, before an fp32
product, as the card's tensor cores take them.  ``half_batch`` is the fault
that drops the second half of the loss terms and takes the mean over the
rest.
"""

from __future__ import annotations

import math

import torch
from torch.utils.checkpoint import checkpoint

from psbench.roofline import head_dim
from psbench.traffic import seed_of

#: leaves of one block, in order, with (rows, cols) as functions of the cfg
_BLOCK_MATS = ("wq", "wk", "wv", "wo", "w_gate", "w_up", "w_down")


def _shapes(cfg: dict) -> dict:
    d, H, KV, D = (cfg["hidden_size"], cfg["num_attention_heads"],
                   cfg["num_key_value_heads"], head_dim(cfg))
    F = cfg["intermediate_size"]
    return {"wq": (d, H * D), "wk": (d, KV * D), "wv": (d, KV * D), "wo": (H * D, d),
            "w_gate": (d, F), "w_up": (d, F), "w_down": (F, d)}


def leaf_names(cfg: dict) -> list:
    """The body's leaves in the reference's layout, then the table."""
    names = []
    for i in range(cfg["num_hidden_layers"]):
        names += [f"layers.{i}.attn_norm", *(f"layers.{i}.{m}" for m in _BLOCK_MATS),
                  f"layers.{i}.mlp_norm"]
    return names + ["final_norm", "lm_head", "embedding"]


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every weight of the cell from ``seed``: the matrices from one normal
    draw on ``device`` (std 1/sqrt(fan_in)), the norm scales ones, the
    embedding table normal with std 0.02 from a second draw."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    shapes = _shapes(cfg)
    mats = [(f"layers.{i}.{m}", shapes[m]) for i in range(cfg["num_hidden_layers"])
            for m in _BLOCK_MATS] + [("lm_head", (d, V))]
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, 3))
    flat = torch.randn(sum(r * c for _, (r, c) in mats), generator=gen, device=device)
    out, at = {}, 0
    for name, (r, c) in mats:
        out[name] = flat[at: at + r * c].view(r, c).mul_(1.0 / math.sqrt(r))
        at += r * c
    for i in range(cfg["num_hidden_layers"]):
        out[f"layers.{i}.attn_norm"] = torch.ones(d, device=device)
        out[f"layers.{i}.mlp_norm"] = torch.ones(d, device=device)
    out["final_norm"] = torch.ones(d, device=device)
    out["embedding"] = torch.randn(V, d, generator=gen, device=device).mul_(0.02)
    return out


def _round_mantissa(x: torch.Tensor, drop_bits: int) -> torch.Tensor:
    """``x`` (fp32) with its mantissa rounded to nearest, ``drop_bits`` low
    bits cleared."""
    i = x.contiguous().view(torch.int32)
    half = 1 << (drop_bits - 1)
    return ((i + half) & ~((1 << drop_bits) - 1)).view(torch.float32)


class _TF32Matmul(torch.autograd.Function):
    """``a @ b`` with both operands rounded to TF32 in the forward and in
    both backward products."""

    @staticmethod
    def forward(ctx, a, b):
        ctx.save_for_backward(a, b)
        return _round_mantissa(a, 13) @ _round_mantissa(b, 13)

    @staticmethod
    def backward(ctx, g):
        a, b = ctx.saved_tensors
        g = _round_mantissa(g, 13)
        return (g @ _round_mantissa(b, 13).transpose(-1, -2),
                _round_mantissa(a, 13).transpose(-1, -2) @ g)


def _matmul(a, b, mode: str):
    return a @ b if mode == "fp32" else _TF32Matmul.apply(a, b)


def _rms_norm(x, scale, eps):
    return x * torch.rsqrt(x.pow(2).mean(dim=-1, keepdim=True) + eps) * scale


def _rotary(x, theta):
    """Rotate interleaved pairs of ``x`` [B, S, H, D] by position."""
    B, S, H, D = x.shape
    inv = 1.0 / (theta ** (torch.arange(0, D, 2, dtype=torch.float32, device=x.device) / D))
    ang = torch.arange(S, dtype=torch.float32, device=x.device)[:, None] * inv  # [S, D/2]
    cos, sin = torch.cos(ang)[None, :, None, :], torch.sin(ang)[None, :, None, :]
    xr, xi = x[..., 0::2], x[..., 1::2]
    return torch.stack([xr * cos - xi * sin, xr * sin + xi * cos], dim=-1).reshape(x.shape)


def _block(cfg, w, i, x, mode):
    B, S, d = x.shape
    H, KV, D = cfg["num_attention_heads"], cfg["num_key_value_heads"], head_dim(cfg)
    p = f"layers.{i}."
    h = _rms_norm(x, w[p + "attn_norm"], cfg["rms_norm_eps"])
    q = _matmul(h, w[p + "wq"], mode).view(B, S, H, D)
    k = _matmul(h, w[p + "wk"], mode).view(B, S, KV, D)
    v = _matmul(h, w[p + "wv"], mode).view(B, S, KV, D)
    q, k = _rotary(q, cfg["rope_theta"]), _rotary(k, cfg["rope_theta"])
    k = k.repeat_interleave(H // KV, dim=2)
    v = v.repeat_interleave(H // KV, dim=2)
    q, k, v = (t.transpose(1, 2) for t in (q, k, v))  # [B, H, S, D]
    scores = _matmul(q, k.transpose(-1, -2), mode) / math.sqrt(D)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    att = _matmul(torch.softmax(scores, dim=-1), v, mode)  # [B, H, S, D]
    x = x + _matmul(att.transpose(1, 2).reshape(B, S, H * D), w[p + "wo"], mode)
    h = _rms_norm(x, w[p + "mlp_norm"], cfg["rms_norm_eps"])
    gated = torch.nn.functional.silu(_matmul(h, w[p + "w_gate"], mode)) * _matmul(
        h, w[p + "w_up"], mode)
    return x + _matmul(gated, w[p + "w_down"], mode)


def loss(cfg: dict, w: dict, emb: torch.Tensor, tokens: torch.Tensor, *,
         matmul: str = "fp32", half_batch: bool = False) -> torch.Tensor:
    """Mean next-token cross-entropy of ``tokens`` [B, S] from their input
    embeddings ``emb`` [B, S, d]."""
    x = emb
    for i in range(cfg["num_hidden_layers"]):
        # the backward pass recomputes each block from its input: only the
        # blocks' inputs are kept, so the reference fits at the timed sizes
        x = checkpoint(_block, cfg, w, i, x, matmul, use_reentrant=False)
    x = _rms_norm(x, w["final_norm"], cfg["rms_norm_eps"])
    logits = _matmul(x, w["lm_head"], matmul)[:, :-1]
    nll = torch.nn.functional.cross_entropy(
        logits.reshape(-1, logits.shape[-1]), tokens[:, 1:].reshape(-1).long(),
        reduction="none")
    if half_batch:
        nll = nll[: nll.shape[0] // 2]
    return nll.mean()


def train(cfg: dict, weights: dict, batches: list, *, matmul: str = "fp32",
          half_batch: bool = False) -> dict:
    """Train from ``weights`` (left as they are) over ``batches`` (token
    tensors [B, S] on the weights' device), one step each: rows gathered
    from the table, the loss, AdamW on the body, the embedding gradient
    summed per row and AdaGrad on the table.  Returns the readings: each
    step's loss, each leaf's gradient norm at the first step, each leaf's
    change after the last."""
    tr = cfg["training"]
    ao, eo = tr["body_optimizer"], tr["embedding_optimizer"]
    body = [n for n in leaf_names(cfg) if n != "embedding"]
    w = {n: weights[n].clone().requires_grad_(True) for n in body}
    table = weights["embedding"].clone()
    sum_sq = torch.zeros_like(table)
    m = {n: torch.zeros_like(w[n]) for n in body}
    v = {n: torch.zeros_like(w[n]) for n in body}
    b1, b2 = ao["beta1"], ao["beta2"]
    losses, grad = [], {}
    for t, tokens in enumerate(batches, start=1):
        emb = table[tokens.long()].requires_grad_(True)
        step_loss = loss(cfg, w, emb, tokens, matmul=matmul, half_batch=half_batch)
        gs = torch.autograd.grad(step_loss, [*(w[n] for n in body), emb])
        losses.append(float(step_loss.detach()))
        g_rows = torch.zeros_like(table).index_add_(
            0, tokens.reshape(-1).long(), gs[-1].reshape(-1, table.shape[1]))
        if t == 1:
            grad = {n: float(torch.linalg.vector_norm(g)) for n, g in zip(body, gs)}
            grad["embedding"] = float(torch.linalg.vector_norm(g_rows))
        with torch.no_grad():
            for n, g in zip(body, gs):
                m[n].mul_(b1).add_(g, alpha=1 - b1)
                v[n].mul_(b2).addcmul_(g, g, value=1 - b2)
                m_hat = m[n] / (1 - b1 ** t)
                v_hat = v[n] / (1 - b2 ** t)
                w[n].mul_(1 - ao["learning_rate"] * ao["weight_decay"])
                w[n].sub_(ao["learning_rate"] * m_hat / (v_hat.sqrt() + ao["eps"]))
            sum_sq.addcmul_(g_rows, g_rows)
            table.sub_(eo["learning_rate"] * g_rows / (sum_sq.sqrt() + eo["eps"]))
        del gs, g_rows, emb, step_loss
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(w[n] - weights[n])) for n in body}
        change["embedding"] = float(torch.linalg.vector_norm(table - weights["embedding"]))
    return {"losses": losses, "grad": grad, "change": change}
