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
from typing import Any, Dict, Optional

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

    @property
    def head_dim(self) -> int:
        return self.d_model // self.n_heads

    @property
    def kv_heads(self) -> int:
        return self.n_kv_heads or self.n_heads


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
        return (x * torch.rsqrt(var + NORM_EPS)).to(cfg.dtype) * w["scale"]
    # flax nn.LayerNorm: f32 statistics, the fast variance, scale folded
    # into the reciprocal before it multiplies
    xf = x.to(torch.float32)
    mean = xf.mean(dim=-1, keepdim=True)
    mean2 = torch.square(xf).mean(dim=-1, keepdim=True)
    var = torch.clamp(mean2 - torch.square(mean), min=0.0)
    mul = torch.rsqrt(var + NORM_EPS) * w["LayerNorm_0.scale"]
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
    B, S, _ = x.shape
    D = cfg.head_dim
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
    scores = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32) / math.sqrt(D)
    if cfg.causal:
        causal = torch.tril(torch.ones((S, S), dtype=torch.bool, device=x.device))
        scores = torch.where(causal[None, None], scores, MASK_VALUE)
    if attn_mask is not None:  # [B, S] True = attend
        scores = torch.where(attn_mask[:, None, None, :].to(torch.bool), scores, MASK_VALUE)
    probs = torch.softmax(scores, dim=-1).to(cfg.dtype)
    out = torch.einsum("bhst,bthd->bshd", probs, v.to(cfg.dtype)).to(cfg.dtype)
    return _row_parallel(cfg, _sub(w, "o"), out, 2, mesh)


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
           tracer: Tracer = NULL_TRACER) -> torch.Tensor:
    h = _norm(cfg, _sub(w, "attn_norm"), x)
    x = x + _traced(tracer, "tfm.attention", _attention, cfg, _sub(w, "attn"), h,
                    positions, attn_mask)
    h = _norm(cfg, _sub(w, "mlp_norm"), x)
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


class MLPBlock(nn.Module):
    def __init__(self, cfg: TransformerConfig, *, stack: int = 0, device="cuda",
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg = cfg
        kw = dict(stack=stack, device=device, generator=generator)
        bias = cfg.norm == "ln"
        if cfg.activation == "swiglu":
            self.gate = _DenseGeneral((cfg.d_model,), (cfg.d_ff,), bias, **kw)
        self.up = _DenseGeneral((cfg.d_model,), (cfg.d_ff,), bias, **kw)
        self.down = _DenseGeneral((cfg.d_ff,), (cfg.d_model,), bias, **kw)

    def forward(self, x):
        return _mlp(self.cfg, dict(self.named_parameters()), x)


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
                 generator: Optional[torch.Generator] = None) -> None:
        super().__init__()
        self.cfg, self.stack = cfg, stack
        self.attn_norm = Norm(cfg, stack=stack, device=device)
        self.attn = Attention(cfg, stack=stack, device=device, generator=generator)
        self.mlp_norm = Norm(cfg, stack=stack, device=device)
        self.mlp = MLPBlock(cfg, stack=stack, device=device, generator=generator)

    def forward(self, x, positions, attn_mask=None):
        w = dict(self.named_parameters())
        if not self.stack:
            return _run_block(self.cfg, w, x, positions, attn_mask, self.tracer)
        # unbind once: its backward stacks the per-layer gradients in one op
        per_layer = {k: v.unbind(0) for k, v in w.items()}
        for i in range(self.stack):
            x = _run_block(self.cfg, {k: v[i] for k, v in per_layer.items()}, x,
                           positions, attn_mask, self.tracer)
        return x


def _run_block(cfg, w, x, positions, attn_mask, tracer):
    if cfg.remat and torch.is_grad_enabled():
        return checkpoint(_block, cfg, w, x, positions, attn_mask, tracer,
                          use_reentrant=False)
    return _block(cfg, w, x, positions, attn_mask, tracer)


class _BodyModule(nn.Module):
    """The block stack shared by every model of the family: learned
    positions (if any), the blocks (``layer_{i}`` or ``blocks.block``) and
    ``final_norm``, at the same names in each, so a body's parameters apply
    in any of them."""

    def _build_body(self, cfg: TransformerConfig, device, generator) -> None:
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
                self.add_module(f"layer_{i}", Block(cfg, device=device, generator=generator))
        self.final_norm = Norm(cfg, device=device)

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
