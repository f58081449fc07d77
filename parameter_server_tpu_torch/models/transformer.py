"""Transformer family: one configurable module covering BERT and Llama.

Torch counterpart of ``parameter_server_tpu/models/transformer.py`` for
BASELINE configs #4 (BERT-base MLM over the chunked dense plane) and #5 (the
Llama-3-8B hybrid: PS-served embeddings, a dense body).

What it keeps of flax, so one set of weights gives the same function:

- **Names and layouts.**  Every parameter sits at its flax path
  (``layer_0.attn.q.kernel``, ``layer_0.mlp.down.bias``, ``final_norm.scale``;
  a LayerNorm's under its unnamed ``LayerNorm_0``: ``layer_0.attn_norm.
  LayerNorm_0.scale``) in flax's layout: ``DenseGeneral`` kernels ``[d, H, D]``
  for q / k / v and ``[H, D, d]`` for ``o``, ``Dense`` kernels ``[in, out]``.
  With ``scan_blocks`` the blocks live under ``blocks.block.…`` with a
  leading layer axis, as flax ``nn.scan(variable_axes={"params": 0})`` lays
  them out, and the stack is a loop over that axis.  So
  ``convert.transformer_from_numpy`` is a copy by path, and
  ``kv/dense.py::PytreeCodec`` flattens the tree to ``ravel_pytree`` of the
  flax tree element for element.
- **The math.**  Attention is the dense path only: scores in f32, ``-1e30``
  masking, softmax, then the value product, as plain tensor products (no
  ``scaled_dot_product_attention``, whose masking and backward are not the
  reference's).  GQA repeats each KV head ``H / KV`` times in place
  (``jnp.repeat`` on the head axis), by ``expand``, whose backward is a sum
  (no atomics).  Rotary embeddings rotate interleaved pairs in f32; RMS norm
  is ``x * rsqrt(mean(x²) + 1e-6)`` in f32, cast, times ``scale``;
  LayerNorm is flax's: epsilon 1e-6, the variance as ``E[x²] - E[x]²``
  clipped at 0; GELU is the tanh approximation.  DenseGeneral / Dense carry
  a bias only when ``norm == "ln"`` (BERT).
- **Latent attention and experts** (DeepSeek-V3's block, off by default):
  ``attn_kind="mla"`` compresses K / V into ``kv_lora_rank`` (RMS-normed,
  then up-projected per head) beside one ``qk_rope_dim`` rotary key that all
  heads share; with ``n_experts`` the blocks from ``first_dense`` on hold an
  expert layer (:class:`MoEBlock`): a sigmoid router over all ``n_experts``,
  the top ``top_k`` of score + a selection-only bias, and the SwiGLU of the
  experts this card holds (``experts_held``) on their tokens, none dropped,
  beside ``n_shared`` shared experts.  Tokens routed to experts held
  elsewhere get nothing from them here (an expert-parallel rank's part of
  the layer; no exchange stands in for the other ranks).  Neither runs
  under ``scan_blocks``, a ``model`` split or sequence parallelism.
- **Initialisation.**  Kernels ``lecun_normal`` over their contracted axes,
  biases zero, norm scales one, embeddings ``normal(0.02)``; draws from an
  explicit ``torch.Generator`` on the parameters' device.
- **Rematerialisation.**  ``remat`` checkpoints each block
  (``torch.utils.checkpoint``); ``chunked_causal_lm_loss`` checkpoints each
  chunk, so only one ``[B, chunk, vocab]`` slab is live.

- **Sequence parallelism.**  ``attn_impl`` ``"ring"`` and ``"ring_spmd"``
  (``ops/ring_attention.py``; one op here, since every layer runs on local
  blocks) and ``"ulysses"`` (``ops/ulysses.py``) run the
  model on this rank's block of the sequence, the attention exchanging K/V
  or heads over the ``sp_axis`` line of ``spmd_mesh`` (torch has no ambient
  ``shard_map`` axis, so every mode reads its group from the config's mesh).
  The caller passes the block's global ``positions`` to ``trunk``.  No
  padding mask there.
- **Tensor parallelism.**  Where ``spmd_mesh`` has a ``model`` axis of more
  than one, the parameters are that rank's shards (``parallel/tp.py``'s
  rules) and the blocks compute as Megatron splits: q / k / v, gate and up
  are column-parallel on the rank's heads and ``d_ff`` slice behind
  ``tp.copy_to_model``; ``o`` and ``down`` are row-parallel, summed by
  ``tp.reduce_from_model`` before their replicated bias.  The embedding and
  the loss are vocab-parallel (``tp.vocab_parallel_embed``,
  ``tp.vocab_parallel_nll``): a model's logits are the rank's block of the
  vocabulary, and the losses take the config to find the split.  A
  ``model`` axis of one is the one-card math.
"""

from __future__ import annotations

import dataclasses
import math
import time
from typing import Any, Dict, Optional, Tuple

import torch
import torch.nn.functional as F
from torch import nn
from torch.utils.checkpoint import checkpoint

from parameter_server_tpu_torch.models.layers import lecun_normal_
from parameter_server_tpu_torch.parallel import tp as tp_lib
from parameter_server_tpu_torch.utils.trace import NULL_TRACER, Tracer

#: attention modes that split the sequence over ``spmd_mesh``'s ``sp_axis``
SEQ_PARALLEL_IMPLS = ("ring", "ulysses", "ring_spmd")
#: flax's LayerNorm and this file's RMS norm epsilon
NORM_EPS = 1e-6
#: what a masked attention score is set to
MASK_VALUE = -1e30


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    vocab_size: int
    n_layers: int
    n_heads: int
    d_model: int
    d_ff: int
    n_kv_heads: Optional[int] = None  # None -> == n_heads (MHA)
    max_seq: int = 2048
    causal: bool = True
    positional: str = "rotary"  # "rotary" | "learned"
    norm: str = "rms"  # "rms" | "ln"
    activation: str = "swiglu"  # "swiglu" | "gelu"
    tie_embeddings: bool = False
    dtype: Any = torch.float32
    rope_theta: float = 500_000.0
    #: checkpoint each block on backward: the backward pass then keeps only
    #: the block inputs and recomputes the rest
    remat: bool = False
    #: keep the blocks as one stacked tree under ``blocks.block`` (leading
    #: layer axis), the layout of the JAX package's ``nn.scan``
    scan_blocks: bool = False
    #: "dense", or a sequence-parallel mode (SEQ_PARALLEL_IMPLS) over
    #: ``spmd_mesh``'s ``sp_axis``; a ``model`` axis of ``spmd_mesh`` is the
    #: tensor-parallel split the parameters are shards of
    attn_impl: str = "dense"
    sp_axis: str = "sp"
    spmd_mesh: Any = None
    #: the RMS norm's and LayerNorm's epsilon
    norm_eps: float = NORM_EPS
    #: "gqa" (q / k / v heads, ``n_kv_heads``) or "mla" (latent attention:
    #: a compressed KV of ``kv_lora_rank``, per-head keys of ``qk_nope_dim``
    #: beside a shared rotary key of ``qk_rope_dim``, values of ``v_head_dim``)
    attn_kind: str = "gqa"
    kv_lora_rank: int = 0
    qk_nope_dim: int = 0
    qk_rope_dim: int = 0
    v_head_dim: int = 0
    #: the expert layer, in the blocks from ``first_dense`` on (0: none).
    #: ``n_experts`` is the router's width; this card holds the experts
    #: ``experts_held`` = (first, count) of it, each a SwiGLU of ``moe_d_ff``;
    #: ``n_shared`` shared experts form one SwiGLU of ``n_shared * moe_d_ff``.
    #: The chosen scores are divided by their sum and scaled by
    #: ``routed_scale``.  ``balance_alpha`` weighs the sequence-wise
    #: balance loss; ``bias_rate`` is the route bias's step (the trainer's)
    n_experts: int = 0
    experts_held: Tuple[int, int] = (0, 0)
    top_k: int = 0
    moe_d_ff: int = 0
    n_shared: int = 0
    routed_scale: float = 1.0
    first_dense: int = 0
    balance_alpha: float = 0.0
    bias_rate: float = 0.0

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads

    def moe_layer(self, i: int) -> bool:
        """Whether block ``i`` holds the expert layer."""
        return self.n_experts > 0 and i >= self.first_dense


def refuse_deepseek(cfg: TransformerConfig, path: str) -> None:
    """Raise for a config with latent attention or experts on ``path``, which
    runs dense GQA blocks only."""
    if cfg.attn_kind != "gqa" or cfg.n_experts:
        raise ValueError(f"{path} runs dense GQA blocks only, not attn_kind="
                         f"{cfg.attn_kind!r} with n_experts={cfg.n_experts}")


def bert_base(vocab_size: int = 30522, **kw) -> TransformerConfig:
    """BERT-base: 12L, 12H, 768d, bidirectional, learned pos, LN, GELU."""
    return TransformerConfig(
        vocab_size=vocab_size, n_layers=12, n_heads=12, d_model=768,
        d_ff=3072, max_seq=512, causal=False, positional="learned",
        norm="ln", activation="gelu", tie_embeddings=True, **kw,
    )


def llama3_8b(vocab_size: int = 128_256, **kw) -> TransformerConfig:
    """Llama-3-8B: 32L, 32H/8KV, 4096d, 14336ff, rotary, RMS, SwiGLU."""
    return TransformerConfig(
        vocab_size=vocab_size, n_layers=32, n_heads=32, n_kv_heads=8,
        d_model=4096, d_ff=14336, max_seq=8192, **kw,
    )


def tiny_config(causal: bool = True, **kw) -> TransformerConfig:
    """Small config for tests: same code paths, toy sizes."""
    defaults = dict(
        vocab_size=256, n_layers=2, n_heads=4, n_kv_heads=2, d_model=64,
        d_ff=128, max_seq=64, causal=causal,
    )
    if not causal:
        defaults.update(positional="learned", norm="ln", activation="gelu",
                        n_kv_heads=4, tie_embeddings=True)
    defaults.update(kw)
    return TransformerConfig(**defaults)


def make_generator(device, seed: int) -> torch.Generator:
    """A generator on ``device`` seeded with ``seed`` (parameter init draws
    on the parameters' own device)."""
    return torch.Generator(device=torch.device(device)).manual_seed(int(seed))


def release_to_meta(module: nn.Module) -> nn.Module:
    """Put every parameter of ``module`` on ``meta`` (its shape, no memory):
    the module keeps only the structure that placed weights run in.  Unlike
    ``module.to("meta")``, which swaps each tensor in place, this also holds
    for fake tensors (``parallel/feasibility.py`` runs trainers on them)."""
    for mod in module.modules():
        for name, p in list(mod._parameters.items()):
            if p is not None:
                mod._parameters[name] = nn.Parameter(torch.empty_like(p, device="meta"),
                                                     requires_grad=p.requires_grad)
    return module


# -- the functions of one block, over a dict of its parameters ------------------


def _sub(w: Dict[str, torch.Tensor], name: str) -> Dict[str, torch.Tensor]:
    """The entries of ``w`` under ``name.``, with that prefix dropped."""
    pre = name + "."
    return {k[len(pre):]: v for k, v in w.items() if k.startswith(pre)}


def _tp_mesh(cfg: Optional[TransformerConfig]):
    """The mesh whose ``model`` axis splits the blocks, or None (no such
    axis, or an axis of one: the one-card math)."""
    mesh = None if cfg is None else cfg.spmd_mesh
    return mesh if tp_lib.model_split(mesh) > 1 else None


def _rotary(x: torch.Tensor, positions: torch.Tensor, theta: float) -> torch.Tensor:
    """Rotary embedding over the last (head_dim) axis of ``x`` [B, S, H, D],
    interleaved pairs ``(x[..., 0::2], x[..., 1::2])``, in f32."""
    d = x.shape[-1]
    freq = 1.0 / (theta ** (torch.arange(0, d, 2, dtype=torch.float32,
                                         device=x.device) / d))
    angles = positions[:, :, None].to(torch.float32) * freq  # [B, S, D/2]
    cos = torch.cos(angles)[:, :, None, :]
    sin = torch.sin(angles)[:, :, None, :]
    x1, x2 = x[..., 0::2], x[..., 1::2]
    out1 = x1 * cos - x2 * sin
    out2 = x2 * cos + x1 * sin
    return torch.stack([out1, out2], dim=-1).reshape(x.shape).to(x.dtype)


def _dense(cfg: TransformerConfig, w: Dict[str, torch.Tensor], x: torch.Tensor,
           n_in: int) -> torch.Tensor:
    """flax ``DenseGeneral`` / ``Dense``: contract the last ``n_in`` axes of
    ``x`` with the first ``n_in`` of ``kernel``, add ``bias`` if present;
    inputs and kernel in ``cfg.dtype``."""
    kernel = w["kernel"].to(cfg.dtype)
    in_shape, out_shape = kernel.shape[:n_in], kernel.shape[n_in:]
    lead = x.shape[: x.dim() - n_in]
    # explicit sizes: a rank may hold no heads of a split (more ranks than heads)
    y = x.to(cfg.dtype).reshape(math.prod(lead), math.prod(in_shape)) @ kernel.reshape(
        math.prod(in_shape), math.prod(out_shape))
    y = y.reshape(*lead, *out_shape)
    if "bias" in w:
        y = y + w["bias"].to(cfg.dtype)
    return y


def _norm(cfg: TransformerConfig, w: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    if cfg.norm == "rms":
        var = torch.mean(torch.square(x.to(torch.float32)), dim=-1, keepdim=True)
        return (x * torch.rsqrt(var + cfg.norm_eps)).to(cfg.dtype) * w["scale"]
    # flax nn.LayerNorm: f32 statistics, the fast variance, scale folded
    # into the reciprocal before it multiplies
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    mean2 = torch.square(xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - torch.square(mean), min=0.0)
    mul = torch.rsqrt(var + cfg.norm_eps) * w["LayerNorm_0.scale"]
    y = (x - mean) * mul + w["LayerNorm_0.bias"]
    return y.to(cfg.dtype)


def _row_parallel(cfg: TransformerConfig, w: Dict[str, torch.Tensor], x: torch.Tensor,
                  n_in: int, mesh) -> torch.Tensor:
    """A row-parallel ``_dense``: the rank's partial product summed over
    ``model``, then the replicated bias."""
    if mesh is None:
        return _dense(cfg, w, x, n_in)
    y = tp_lib.reduce_from_model(_dense(cfg, {"kernel": w["kernel"]}, x, n_in), mesh)
    if "bias" in w:
        y = y + w["bias"].to(cfg.dtype)
    return y


def _repeat_kv(t: torch.Tensor, heads: int) -> torch.Tensor:
    """``jnp.repeat(t, heads // KV, axis=2)``: each KV head of ``t`` [B, S,
    KV, D] repeated in place, by ``expand`` (its backward is a sum)."""
    B, S, KV, D = t.shape
    rep = heads // KV
    return t[:, :, :, None, :].expand(B, S, KV, rep, D).reshape(B, S, heads, D)


def _attention(cfg: TransformerConfig, w: Dict[str, torch.Tensor], x: torch.Tensor,
               positions: torch.Tensor, attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
    mesh = _tp_mesh(cfg)
    x = tp_lib.copy_to_model(x, mesh)
    q = _dense(cfg, _sub(w, "q"), x, 1)  # [B, S, H (this rank's), D]
    k = _dense(cfg, _sub(w, "k"), x, 1)
    v = _dense(cfg, _sub(w, "v"), x, 1)
    if cfg.positional == "rotary":
        q = _rotary(q, positions, cfg.rope_theta)
        k = _rotary(k, positions, cfg.rope_theta)
    H, KV = q.shape[2], k.shape[2]
    if mesh is not None and tp_lib.kv_full(cfg.n_heads, cfg.kv_heads,
                                           tp_lib.model_split(mesh)):
        # k / v came whole: every query head's, then this rank's heads
        lo, hi = tp_lib.shard_range(mesh, cfg.n_heads)
        k = _repeat_kv(k, cfg.n_heads)[:, :, lo:hi]
        v = _repeat_kv(v, cfg.n_heads)[:, :, lo:hi]
    elif KV != H:
        k, v = _repeat_kv(k, H), _repeat_kv(v, H)
    if cfg.attn_impl in SEQ_PARALLEL_IMPLS:
        if attn_mask is not None:
            raise ValueError("sequence-parallel attention does not support attn_mask "
                             "(padding masks are a dense-impl feature)")
        out = _seq_parallel_attention(cfg, q, k, v).to(cfg.dtype)
        return _row_parallel(cfg, _sub(w, "o"), out, 2, mesh)
    return _row_parallel(cfg, _sub(w, "o"), _dense_attention(cfg, q, k, v, attn_mask), 2, mesh)


def _dense_attention(cfg: TransformerConfig, q, k, v,
                     attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Softmax attention of ``q`` / ``k`` [B, S, H, Dk] over ``v`` [B, S, H,
    Dv]: scores in f32 over sqrt(Dk), masked to ``MASK_VALUE``."""
    S = q.shape[1]
    scores = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32) / math.sqrt(q.shape[-1])
    if cfg.causal:
        causal = torch.tril(torch.ones((S, S), dtype=torch.bool, device=q.device))
        scores = torch.where(causal[None, None], scores, MASK_VALUE)
    if attn_mask is not None:  # [B, S] True = attend
        scores = torch.where(attn_mask[:, None, None, :].to(torch.bool), scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    return torch.einsum("bhst,bthd->bshd", probs, v.to(cfg.dtype)).to(cfg.dtype)


def _mla(cfg: TransformerConfig, w: Dict[str, torch.Tensor], x: torch.Tensor,
         positions: torch.Tensor, attn_mask: Optional[torch.Tensor]) -> torch.Tensor:
    """Latent attention (DeepSeek-V3's, no q compression): q per head in
    ``qk_nope_dim + qk_rope_dim``; ``kv_a`` gives the compressed KV and the
    rotary key, the KV is RMS-normed and ``kv_b`` up-projects it to each
    head's ``qk_nope_dim`` key and ``v_head_dim`` value; the one rotary key
    is every head's.  The rotary rotates interleaved pairs: DeepSeek's
    rotate-half over de-interleaved pairs permutes q's and k's rope
    dimensions alike, which leaves q.k as it is."""
    B, S, _ = x.shape
    nope, rope, rank = cfg.qk_nope_dim, cfg.qk_rope_dim, cfg.kv_lora_rank
    q = _dense(cfg, _sub(w, "q"), x, 1)  # [B, S, H, nope + rope]
    c = _dense(cfg, _sub(w, "kv_a"), x, 1)  # [B, S, rank + rope]
    kv = _dense(cfg, _sub(w, "kv_b"), _norm(cfg, _sub(w, "kv_norm"), c[..., :rank]), 1)
    H = q.shape[2]
    q = torch.cat([q[..., :nope], _rotary(q[..., nope:], positions, cfg.rope_theta)], dim=-1)
    k_pe = _rotary(c[:, :, None, rank:], positions, cfg.rope_theta).expand(B, S, H, rope)
    k = torch.cat([kv[..., :nope], k_pe], dim=-1)
    out = _dense_attention(cfg, q, k, kv[..., nope:], attn_mask)  # [B, S, H, v_head_dim]
    return _dense(cfg, _sub(w, "o"), out, 2)


def _seq_parallel_attention(cfg: TransformerConfig, q, k, v) -> torch.Tensor:
    """Attention of this rank's sequence block over ``cfg.spmd_mesh``'s
    ``sp_axis`` line."""
    from parameter_server_tpu_torch.ops import ring_attention, ulysses

    mesh = cfg.spmd_mesh
    if mesh is None:
        raise ValueError(f"attn_impl={cfg.attn_impl!r} needs cfg.spmd_mesh (the mesh "
                         "whose sp_axis the sequence is split over)")
    if cfg.attn_impl == "ulysses":
        return ulysses.ulysses_attention(q, k, v, group=ring_attention.sp_group(
            mesh, cfg.sp_axis), causal=cfg.causal)
    return ring_attention.ring_attention_spmd(q, k, v, mesh=mesh, sp_axis=cfg.sp_axis,
                                              causal=cfg.causal)


def _mlp(cfg: TransformerConfig, w: Dict[str, torch.Tensor], x: torch.Tensor) -> torch.Tensor:
    mesh = _tp_mesh(cfg)
    x = tp_lib.copy_to_model(x, mesh)
    if cfg.activation == "swiglu":
        h = F.silu(_dense(cfg, _sub(w, "gate"), x, 1)) * _dense(cfg, _sub(w, "up"), x, 1)
    else:
        h = F.gelu(_dense(cfg, _sub(w, "up"), x, 1), approximate="tanh")
    return _row_parallel(cfg, _sub(w, "down"), h, 1, mesh)


# -- the expert layer: a token's ``k`` choices are its slots ``t * k + j`` ------


def _route(cfg: TransformerConfig, w: Dict[str, torch.Tensor], x: torch.Tensor,
           moe: "MoEBlock", plan: dict) -> torch.Tensor:
    """Sigmoid scores of ``x`` [T, d] over every expert, in f32; the top
    ``top_k`` of score + ``moe.route_bias`` (the bias only chooses); the
    chosen scores over their sum (+1e-20) times ``routed_scale``: [T, k].
    Sets ``moe``'s step record and the grouping (:func:`_group`)."""
    s = torch.sigmoid(_dense(cfg, _sub(w, "router"), x, 1).to(torch.float32))
    idx = torch.topk(s + moe.route_bias, cfg.top_k, dim=-1).indices
    weights = torch.gather(s, 1, idx)
    weights = weights / (weights.sum(dim=-1, keepdim=True) + 1e-20)
    balance = _balance_loss(cfg, s, idx, plan["batch"])
    moe.record(idx, balance.detach())
    _group(cfg, idx, plan)
    return _AddLoss.apply(weights * cfg.routed_scale, balance)


def _group(cfg: TransformerConfig, idx: torch.Tensor, plan: dict) -> None:
    """The held experts' assignments grouped by expert: a stable sort of the
    slots by held expert (the others last), ``plan["order"]``; each group's
    size on its way to the host, and ``plan["read_sizes"]``, which waits for
    and returns them (the matmuls' shapes).  The copy is queued here and read in
    :func:`_dispatch`, so the shared experts' work is queued on the card
    before the host waits."""
    first, held = cfg.experts_held
    local = idx.reshape(-1) - first
    key = torch.where((local >= 0) & (local < held), local, held)
    plan["order"] = torch.sort(key.to(torch.int32), stable=True).indices
    counts = torch.bincount(key, minlength=held + 1)[:held]
    if counts.device.type != "cuda":
        plan["read_sizes"] = counts.tolist
        return
    host = counts.to("cpu", non_blocking=True)
    copied = torch.cuda.Event()
    copied.record()

    def sizes() -> list:
        copied.synchronize()
        return host.tolist()

    plan["read_sizes"] = sizes


class _AddLoss(torch.autograd.Function):
    """Identity on ``y`` whose backward also gives ``loss`` (a scalar term of
    the training loss) its gradient, 1: the term's gradient joins the
    backward where ``y``'s passes.  The term itself leaves the layer only as
    a value, since a graph kept outside the layer would keep alive every
    tensor a recompute under remat makes."""

    @staticmethod
    def forward(ctx, y, loss):
        return y.view_as(y)

    @staticmethod
    def backward(ctx, grad):
        return grad, torch.ones((), dtype=grad.dtype, device=grad.device)


def _balance_loss(cfg: TransformerConfig, s: torch.Tensor, idx: torch.Tensor,
                  batch: int) -> torch.Tensor:
    """DeepSeek-V3's sequence-wise balance loss ``alpha * sum_i f_i P_i``,
    averaged over the sequences: ``f_i`` is ``E / (k S)`` times the tokens
    of the sequence that chose expert ``i``, ``P_i`` the mean over them of
    ``i``'s score over the token's score sum."""
    E, k = cfg.n_experts, cfg.top_k
    probs = (s / s.sum(dim=-1, keepdim=True)).view(batch, -1, E).mean(dim=1)
    seq_idx = idx.reshape(batch, -1)
    chosen = torch.zeros_like(probs).scatter_add_(
        1, seq_idx, torch.ones(seq_idx.shape, dtype=probs.dtype, device=probs.device))
    f = chosen * (E / seq_idx.shape[1])  # seq_idx.shape[1] is k S
    return cfg.balance_alpha * (f * probs).sum(dim=1).mean()


def _slots_to_tokens(rows: torch.Tensor, sel: torch.Tensor, T: int, k: int) -> torch.Tensor:
    """Each of ``rows`` at its slot ``sel`` (distinct slots) of a ``[T, k]``
    grid, zeros elsewhere, the ``k`` slots of a token summed in slot order:
    no atomic add, so the sum's bits do not change from run to run."""
    grid = rows.new_zeros(T * k, rows.shape[1]).index_copy_(0, sel, rows).view(T, k, -1)
    out = grid[:, 0].clone()
    for j in range(1, k):
        out += grid[:, j]
    return out


def _token_rows(x: torch.Tensor, sel: torch.Tensor, k: int) -> torch.Tensor:
    """The row of ``x`` [T, d] of each slot in ``sel``: its token's."""
    return x.index_select(0, torch.div(sel, k, rounding_mode="floor"))


class _SlotRows(torch.autograd.Function):
    """:func:`_token_rows`, whose backward is :func:`_slots_to_tokens`
    (``index_select``'s would add a token's slots with atomics)."""

    @staticmethod
    def forward(ctx, x, sel, k: int):
        ctx.save_for_backward(sel)
        ctx.T, ctx.k = x.shape[0], k
        return _token_rows(x, sel, k)

    @staticmethod
    def backward(ctx, grad):
        (sel,) = ctx.saved_tensors
        return _slots_to_tokens(grad, sel, ctx.T, ctx.k), None, None


class _SlotSum(torch.autograd.Function):
    """:func:`_slots_to_tokens`, whose backward is :func:`_token_rows`: the
    two are each other's adjoint, and neither backward builds the ``[T, k,
    d]`` grid a slice's backward would, once a slot."""

    @staticmethod
    def forward(ctx, rows, sel, T: int, k: int):
        ctx.save_for_backward(sel)
        ctx.k = k
        return _slots_to_tokens(rows, sel, T, k)

    @staticmethod
    def backward(ctx, grad):
        (sel,) = ctx.saved_tensors
        return _token_rows(grad, sel, ctx.k), None, None, None


def _dispatch(cfg: TransformerConfig, plan: dict, x: torch.Tensor) -> torch.Tensor:
    """The rows of the held experts' assignments in group order: the groups'
    sizes read (:func:`_group`), then their slots' token rows.  Sets
    ``plan["sel"]`` (the slots, in group order) and ``plan["sizes"]``."""
    sizes = plan["read_sizes"]()
    plan["sel"], plan["sizes"] = plan["order"][: sum(sizes)], sizes
    return _SlotRows.apply(x, plan["sel"], cfg.top_k)


def _experts(cfg: TransformerConfig, w: Dict[str, torch.Tensor], xs: torch.Tensor,
             plan: dict) -> torch.Tensor:
    """Each held expert's SwiGLU over its group of ``xs``: one matmul chain a
    group, the groups' outputs in group order."""
    gate, up, down = (w[f"{n}.kernel"].to(cfg.dtype).unbind(0) for n in ("gate", "up", "down"))
    outs, lo = [], 0
    for e, n in enumerate(plan["sizes"]):
        xe = xs[lo: lo + n]
        outs.append((F.silu(xe @ gate[e]) * (xe @ up[e])) @ down[e])
        lo += n
    return torch.cat(outs)


def _combine(cfg: TransformerConfig, plan: dict, ys: torch.Tensor,
             weights: torch.Tensor) -> torch.Tensor:
    """The held experts' outputs times their weights, back at their slots,
    summed over each token's slots: [T, d]."""
    sel = plan["sel"]
    rows = ys * weights.reshape(-1).index_select(0, sel)[:, None]
    return _SlotSum.apply(rows, sel, weights.shape[0], cfg.top_k)


def _moe(cfg: TransformerConfig, w: Dict[str, torch.Tensor], x: torch.Tensor,
         moe: "MoEBlock", tracer: Tracer) -> torch.Tensor:
    """The expert layer of ``x`` [B, S, d]: the shared experts plus the held
    experts' weighted outputs, each stage a span under ``tfm.mlp``."""
    B, S, d = x.shape
    flat = x.reshape(B * S, d)
    plan = {"batch": B}
    weights = _traced(tracer, "tfm.moe.route", _route, cfg, w, flat, moe, plan)
    if cfg.n_shared:  # queued before the host waits for the groups' sizes
        shared = _traced(tracer, "tfm.moe.shared", _mlp, cfg, _sub(w, "shared"), flat)
    xs = _traced(tracer, "tfm.moe.dispatch", _dispatch, cfg, plan, flat)
    ys = _traced(tracer, "tfm.moe.experts", _experts, cfg, _sub(w, "experts"), xs, plan)
    out = _traced(tracer, "tfm.moe.combine", _combine, cfg, plan, ys, weights)
    if cfg.n_shared:
        out = out + shared
    return out.reshape(B, S, d)


class _BackwardSpan(torch.autograd.Function):
    """Identity whose backward opens (``opens``) or closes a span: placed
    on a region's output it opens when the region's backward starts, on
    its input it closes when that backward is done, on the thread autograd
    runs it on.  ``mark`` is the region's (tracer, name, start)."""

    @staticmethod
    def forward(ctx, x, mark: list, opens: bool):
        ctx.mark, ctx.opens = mark, opens
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        tracer, name, start = ctx.mark
        if ctx.opens:
            ctx.mark[2] = time.perf_counter()
        elif start is not None:
            tracer.record(name, time.perf_counter() - start, start_s=start)
        return grad, None, None


def _traced(tracer: Tracer, name: str, fn, cfg, w, x: torch.Tensor, *rest) -> torch.Tensor:
    """``fn(cfg, w, x, *rest)`` as span ``name`` of ``tracer``, forward and,
    where autograd records, backward (:class:`_BackwardSpan` markers on
    ``x`` and on the result).  A disabled tracer adds nothing to the graph."""
    if not tracer.enabled:
        return fn(cfg, w, x, *rest)
    with tracer.span(name):
        if not torch.is_grad_enabled():
            return fn(cfg, w, x, *rest)
        mark = [tracer, name, None]
        out = fn(cfg, w, _BackwardSpan.apply(x, mark, False), *rest)
        return _BackwardSpan.apply(out, mark, True)


def _block(cfg: TransformerConfig, w: Dict[str, torch.Tensor], x: torch.Tensor,
           positions: torch.Tensor, attn_mask: Optional[torch.Tensor],
           tracer: Tracer = NULL_TRACER, moe: Optional["MoEBlock"] = None) -> torch.Tensor:
    """One pre-norm block; ``moe``: the block's expert layer, if it has one."""
    h = _norm(cfg, _sub(w, "attn_norm"), x)
    attention = _mla if cfg.attn_kind == "mla" else _attention
    x = x + _traced(tracer, "tfm.attention", attention, cfg, _sub(w, "attn"), h,
                    positions, attn_mask)
    h = _norm(cfg, _sub(w, "mlp_norm"), x)
    if moe is not None:
        return x + _traced(tracer, "tfm.mlp", _moe, cfg, _sub(w, "mlp"), h, moe, tracer)
    return x + _traced(tracer, "tfm.mlp", _mlp, cfg, _sub(w, "mlp"), h)


# -- modules: parameters at their flax paths -----------------------------------


class _DenseGeneral(nn.Module):
    """A ``kernel`` of shape ``in_shape + out_shape`` (``lecun_normal`` over
    ``in_shape``) and, with ``use_bias``, a zero ``bias`` of ``out_shape``;
    ``stack`` > 0 adds a leading layer axis to both."""

    def __init__(self, in_shape: tuple, out_shape: tuple, use_bias: bool, *, stack: int,
                 device, generator: Optional[torch.Generator]) -> None:
        super().__init__()
        lead = (stack,) if stack else ()
        self.kernel = nn.Parameter(torch.empty(lead + in_shape + out_shape, device=device))
        lecun_normal_(self.kernel, math.prod(in_shape), generator)
        if use_bias:
            self.bias = nn.Parameter(torch.zeros(lead + out_shape, device=device))


class Norm(nn.Module):
    """RMS norm (``scale``) or flax LayerNorm (``LayerNorm_0.scale`` /
    ``.bias``) over the last axis."""

    def __init__(self, cfg: TransformerConfig, *, stack: int = 0, device="cuda") -> None:
        super().__init__()
        self.cfg = cfg
        lead = (stack,) if stack else ()
        d = cfg.d_model
        if cfg.norm == "rms":
            self.scale = nn.Parameter(torch.ones(lead + (d,), device=device))
        else:
            self.LayerNorm_0 = nn.Module()
            self.LayerNorm_0.scale = nn.Parameter(torch.ones(lead + (d,), device=device))
            self.LayerNorm_0.bias = nn.Parameter(torch.zeros(lead + (d,), device=device))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _norm(self.cfg, dict(self.named_parameters()), x)


class Attention(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, stack: int = 0, device="cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        H, KV, D, d = cfg.n_heads, cfg.kv_heads, cfg.head_dim, cfg.d_model
        kw = dict(stack=stack, device=device, generator=generator)
        bias = cfg.norm == "ln"
        self.q = _DenseGeneral((d,), (H, D), bias, **kw)
        self.k = _DenseGeneral((d,), (KV, D), bias, **kw)
        self.v = _DenseGeneral((d,), (KV, D), bias, **kw)
        self.o = _DenseGeneral((H, D), (d,), bias, **kw)

    def forward(self, x, positions, attn_mask=None):
        return _attention(self.cfg, dict(self.named_parameters()), x, positions, attn_mask)


class MLAttention(nn.Module):
    """Latent attention's parameters (:func:`_mla`): ``q`` [d, H, nope +
    rope], ``kv_a`` [d, rank + rope], ``kv_norm.scale`` [rank], ``kv_b``
    [rank, H, nope + v], ``o`` [H, v, d]."""

    def __init__(self, cfg: TransformerConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        H, d, rank = cfg.n_heads, cfg.d_model, cfg.kv_lora_rank
        kw = dict(stack=0, device=device, generator=generator)
        self.q = _DenseGeneral((d,), (H, cfg.qk_nope_dim + cfg.qk_rope_dim), False, **kw)
        self.kv_a = _DenseGeneral((d,), (rank + cfg.qk_rope_dim,), False, **kw)
        self.kv_norm = nn.Module()
        self.kv_norm.scale = nn.Parameter(torch.ones(rank, device=device))
        self.kv_b = _DenseGeneral((rank,), (H, cfg.qk_nope_dim + cfg.v_head_dim), False, **kw)
        self.o = _DenseGeneral((H, cfg.v_head_dim), (d,), False, **kw)

    def forward(self, x, positions, attn_mask=None):
        return _mla(self.cfg, dict(self.named_parameters()), x, positions, attn_mask)


class MLPBlock(nn.Module):
    """``d_ff``: the width, by default the config's."""

    def __init__(self, cfg: TransformerConfig, *, stack: int = 0, device="cuda",
                 generator: Optional[torch.Generator] = None,
                 d_ff: Optional[int] = None) -> None:
        super().__init__()
        self.cfg = cfg
        kw = dict(stack=stack, device=device, generator=generator)
        bias = cfg.norm == "ln"
        d_ff = d_ff or cfg.d_ff
        if cfg.activation == "swiglu":
            self.gate = _DenseGeneral((cfg.d_model,), (d_ff,), bias, **kw)
        self.up = _DenseGeneral((cfg.d_model,), (d_ff,), bias, **kw)
        self.down = _DenseGeneral((d_ff,), (cfg.d_model,), bias, **kw)

    def forward(self, x):
        return _mlp(self.cfg, dict(self.named_parameters()), x)


class MoEBlock(nn.Module):
    """The expert layer's parameters (:func:`_moe`): ``router`` [d,
    n_experts]; the held experts' ``experts.gate`` / ``up`` [held, d,
    moe_d_ff] and ``down`` [held, moe_d_ff, d]; ``shared`` one SwiGLU of
    ``n_shared * moe_d_ff``; and the buffer ``route_bias`` [n_experts], which
    only chooses and which the trainer's balance update moves.

    Each forward records ``loads`` (int64 [n_experts]: every expert's
    assignments, held or not) and ``balance`` (the balance loss's value; its
    gradient joins the routing weights' backward); a recompute under remat
    records the same again.  ``choice_hook``, where set, is called with
    each forward's choices [T, top_k]."""

    #: a class default: no hook, and no copy of the choices
    choice_hook = None

    def __init__(self, cfg: TransformerConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        d, f, held = cfg.d_model, cfg.moe_d_ff, cfg.experts_held[1]
        kw = dict(device=device, generator=generator)
        self.router = _DenseGeneral((d,), (cfg.n_experts,), False, stack=0, **kw)
        self.experts = nn.Module()
        self.experts.gate = _DenseGeneral((d,), (f,), False, stack=held, **kw)
        self.experts.up = _DenseGeneral((d,), (f,), False, stack=held, **kw)
        self.experts.down = _DenseGeneral((f,), (d,), False, stack=held, **kw)
        if cfg.n_shared:
            self.shared = MLPBlock(cfg, d_ff=cfg.n_shared * f, **kw)
        self.register_buffer("route_bias", torch.zeros(cfg.n_experts, device=device))
        self.loads = torch.zeros(cfg.n_experts, dtype=torch.int64, device=device)
        self.balance: Optional[torch.Tensor] = None

    def record(self, idx: torch.Tensor, balance: torch.Tensor) -> None:
        """A forward's record: the loads of choices ``idx`` [T, top_k], the
        balance loss's value."""
        self.loads = torch.bincount(idx.reshape(-1), minlength=self.cfg.n_experts)
        self.balance = balance
        if self.choice_hook is not None:
            self.choice_hook(idx)

    def forward(self, x):
        return _moe(self.cfg, dict(self.named_parameters()), x, self, NULL_TRACER)


class Block(nn.Module):
    """Pre-norm block: ``x + attn(norm(x))``, then ``x + mlp(norm(x))``.
    ``stack`` > 0 holds that many layers' parameters on a leading axis (the
    ``scan_blocks`` layout); ``forward`` then runs them in order.
    ``tracer``: records the spans ``tfm.attention`` and ``tfm.mlp``, forward
    and backward; a profiling harness sets it on a built model's blocks."""

    #: a class default, so an untraced block holds no tracer of its own
    #: (a tracer's lock neither copies nor pickles)
    tracer: Tracer = NULL_TRACER

    def __init__(self, cfg: TransformerConfig, *, stack: int = 0, device="cuda",
                 generator: Optional[torch.Generator] = None, moe: bool = False) -> None:
        """``moe``: the block holds the expert layer in place of the MLP."""
        super().__init__()
        self.cfg, self.stack = cfg, stack
        kw = dict(device=device, generator=generator)
        self.attn_norm = Norm(cfg, stack=stack, device=device)
        if cfg.attn_kind == "mla":
            self.attn = MLAttention(cfg, **kw)
        else:
            self.attn = Attention(cfg, stack=stack, **kw)
        self.mlp_norm = Norm(cfg, stack=stack, device=device)
        self.mlp = MoEBlock(cfg, **kw) if moe else MLPBlock(cfg, stack=stack, **kw)

    def forward(self, x, positions, attn_mask=None):
        w = dict(self.named_parameters())
        if not self.stack:
            moe = self.mlp if isinstance(self.mlp, MoEBlock) else None
            return _run_block(self.cfg, w, x, positions, attn_mask, self.tracer, moe)
        # unbind once: its backward stacks the per-layer gradients in one op
        per_layer = {k: v.unbind(0) for k, v in w.items()}
        for i in range(self.stack):
            x = _run_block(self.cfg, {k: v[i] for k, v in per_layer.items()}, x,
                           positions, attn_mask, self.tracer)
        return x


def _run_block(cfg, w, x, positions, attn_mask, tracer, moe=None):
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(_block, cfg, w, x, positions, attn_mask, tracer, moe,
                          use_reentrant=False)
    return _block(cfg, w, x, positions, attn_mask, tracer, moe)


class _BodyModule(nn.Module):
    """The block stack shared by every model of the family: learned
    positions (if any), the blocks (``layer_{i}`` or ``blocks.block``) and
    ``final_norm``, at the same names in each, so a body's parameters apply
    in any of them."""

    def _build_body(self, cfg: TransformerConfig, device, generator) -> None:
        if cfg.scan_blocks or cfg.attn_impl != "dense" or _tp_mesh(cfg) is not None:
            refuse_deepseek(cfg, "scan_blocks, sequence parallelism or a model split")
        self.cfg = cfg
        if cfg.positional == "learned":
            self.pos_embedding = nn.Parameter(torch.empty(cfg.max_seq, cfg.d_model,
                                                          device=device))
            with torch.no_grad():
                self.pos_embedding.normal_(0.0, 0.02, generator=generator)
        if cfg.scan_blocks:
            self.blocks = nn.ModuleDict({"block": Block(cfg, stack=cfg.n_layers,
                                                        device=device, generator=generator)})
        else:
            for i in range(cfg.n_layers):
                self.add_module(f"layer_{i}", Block(cfg, device=device, generator=generator,
                                                    moe=cfg.moe_layer(i)))
        self.final_norm = Norm(cfg, device=device)

    def moe_layers(self) -> list:
        """The expert layers (:class:`MoEBlock`), in layer order."""
        return [m for m in self.modules() if isinstance(m, MoEBlock)]

    def trunk(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None,
              positions: Optional[torch.Tensor] = None) -> torch.Tensor:
        """Hidden states of input embeddings ``x`` [B, S, d] (no head)."""
        return _apply_body(self, self.cfg, x, attn_mask, positions)


def _apply_body(mod: _BodyModule, cfg: TransformerConfig, x: torch.Tensor,
                attn_mask: Optional[torch.Tensor] = None,
                positions: Optional[torch.Tensor] = None) -> torch.Tensor:
    """The shared block stack: positional embedding + layers + final norm,
    over ``mod``'s parameters.

    ``positions``: global token positions ``[B, S]``; by default ``0..S-1``,
    and then a learned-position model refuses ``S`` above ``max_seq`` (the
    gather would read past its table)."""
    B, S, _ = x.shape
    x = x.to(cfg.dtype)
    if positions is None:
        if cfg.positional == "learned" and S > cfg.max_seq:
            raise ValueError(f"sequence {S} exceeds learned-positional max_seq "
                             f"{cfg.max_seq}")
        positions = torch.arange(S, device=x.device).expand(B, S)
    if cfg.positional == "learned":
        x = x + mod.pos_embedding[positions].to(cfg.dtype)
    if cfg.scan_blocks:
        x = mod.blocks["block"](x, positions, attn_mask)
    else:
        for i in range(cfg.n_layers):
            x = getattr(mod, f"layer_{i}")(x, positions, attn_mask)
    return mod.final_norm(x)


def _lm_head(cfg: TransformerConfig, module: _DenseGeneral, x: torch.Tensor) -> torch.Tensor:
    """Logits in f32: the rank's block of the vocabulary under TP."""
    x = tp_lib.copy_to_model(x, _tp_mesh(cfg))
    return _dense(cfg, {"kernel": module.kernel}, x, 1).to(torch.float32)


class Transformer(_BodyModule):
    """tokens [B, S] -> logits [B, S, vocab] (f32; under TP the rank's block
    of the vocabulary)."""

    def __init__(self, cfg: TransformerConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.embedding = nn.Parameter(torch.empty(cfg.vocab_size, cfg.d_model, device=device))
        with torch.no_grad():
            self.embedding.normal_(0.0, 0.02, generator=generator)
        self._build_body(cfg, device, generator)
        if not cfg.tie_embeddings:
            self.lm_head = _DenseGeneral((cfg.d_model,), (cfg.vocab_size,), False, stack=0,
                                         device=device, generator=generator)

    def embed(self, tokens: torch.Tensor) -> torch.Tensor:
        """The input embeddings of ``tokens`` (vocab-parallel under TP)."""
        return tp_lib.vocab_parallel_embed(self.embedding, tokens, _tp_mesh(self.cfg),
                                           self.cfg.vocab_size)

    def forward(self, tokens: torch.Tensor, attn_mask: Optional[torch.Tensor] = None):
        cfg = self.cfg
        x = self.trunk(self.embed(tokens), attn_mask)
        if cfg.tie_embeddings:
            x = tp_lib.copy_to_model(x, _tp_mesh(cfg))
            dt = torch.promote_types(x.dtype, cfg.dtype)
            return torch.einsum("bsd,vd->bsv", x.to(dt),
                                self.embedding.to(cfg.dtype).to(dt)).to(torch.float32)
        return _lm_head(cfg, self.lm_head, x)


class TransformerTrunk(_BodyModule):
    """Block stack + final norm without a head: hidden states out.  Its
    parameter names are :class:`TransformerBody`'s less ``lm_head``."""

    def __init__(self, cfg: TransformerConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self._build_body(cfg, device, generator)

    def forward(self, x, attn_mask=None, positions=None):
        return self.trunk(x, attn_mask, positions)


class TransformerBody(_BodyModule):
    """The dense half of the PS hybrid (config #5): blocks + final norm +
    untied ``lm_head``, over input embeddings pulled from the parameter
    server (``learner/hybrid.py``)."""

    def __init__(self, cfg: TransformerConfig, *, device="cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self._build_body(cfg, device, generator)
        self.lm_head = _DenseGeneral((cfg.d_model,), (cfg.vocab_size,), False, stack=0,
                                     device=device, generator=generator)

    def forward(self, x: torch.Tensor, attn_mask: Optional[torch.Tensor] = None):
        """x [B, S, d_model] input embeddings -> logits [B, S, vocab]."""
        return _lm_head(self.cfg, self.lm_head, self.trunk(x, attn_mask))


# -- losses ----------------------------------------------------------------------
#
# ``cfg``: the model's config.  Where its ``spmd_mesh`` splits ``model``, the
# logits (or the head kernel) are the rank's block of the vocabulary and the
# loss is vocab-parallel; without one, the plain log-softmax.


def _nll(logits: torch.Tensor, targets: torch.Tensor,
         cfg: Optional[TransformerConfig] = None) -> torch.Tensor:
    mesh = _tp_mesh(cfg)
    if mesh is not None:
        return tp_lib.vocab_parallel_nll(logits, targets.long(), mesh, cfg.vocab_size)
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.gather(logp, -1, targets.long()[..., None])[..., 0]


def causal_lm_loss(logits: torch.Tensor, tokens: torch.Tensor,
                   cfg: Optional[TransformerConfig] = None) -> torch.Tensor:
    """Next-token CE: predict tokens[:, 1:] from logits[:, :-1]."""
    return torch.mean(_nll(logits[:, :-1], tokens[:, 1:], cfg))


def _chunk_nll(xc, head_kernel, tc, mc, cfg=None):
    logits = torch.einsum("bcd,dv->bcv", xc, head_kernel).to(torch.float32)
    return torch.sum(_nll(logits, tc, cfg) * mc)


def chunked_causal_lm_loss(hidden: torch.Tensor, head_kernel: torch.Tensor,
                           tokens: torch.Tensor, chunk: int = 1024,
                           cfg: Optional[TransformerConfig] = None) -> torch.Tensor:
    """Next-token CE with the head matmul fused into the loss, by chunks of
    the sequence, each checkpointed: only one ``[B, chunk, vocab]`` slab is
    live and backward recomputes it.  Pads to whole chunks, masks the pad and
    divides by ``B * (S - 1)``; the chunk sums add up in order, as the JAX
    ``lax.scan`` adds them.  Under TP ``head_kernel`` is the rank's column
    block and a slab its block of the vocabulary."""
    B, S, _d = hidden.shape
    n = S - 1
    hidden = tp_lib.copy_to_model(hidden, _tp_mesh(cfg))
    xs, tg = hidden[:, :-1], tokens[:, 1:]
    chunk = min(chunk, n)
    pad = (-n) % chunk
    if pad:
        xs = F.pad(xs, (0, 0, 0, pad))
        tg = F.pad(tg, (0, pad))
    valid = (torch.arange(n + pad, device=hidden.device) < n).to(torch.float32)
    total = torch.zeros((), dtype=torch.float32, device=hidden.device)
    for c in range(0, n + pad, chunk):
        args = (xs[:, c:c + chunk], head_kernel, tg[:, c:c + chunk], valid[c:c + chunk], cfg)
        if torch.is_grad_enabled():
            total = total + checkpoint(_chunk_nll, *args, use_reentrant=False)
        else:
            total = total + _chunk_nll(*args)
    return total / (B * n)


def mlm_loss(logits: torch.Tensor, targets: torch.Tensor, mask: torch.Tensor,
             cfg: Optional[TransformerConfig] = None) -> torch.Tensor:
    """Masked-LM CE over masked positions only (mask 1 = predict)."""
    nll = _nll(logits, targets, cfg)
    mask = mask.to(torch.float32)
    denom = torch.clamp(torch.sum(mask), min=1.0)
    return torch.sum(nll * mask) / denom
