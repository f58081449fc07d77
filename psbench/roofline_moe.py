"""Model FLOPs of a DeepSeek-V3 body's training step (the Moonlight hybrid
cell), counted from shapes and from the step's held assignments: what the
algorithm needs (no recompute, no table), as ``psbench/roofline.py``
counts the Mistral body's.

- the dense path, every matmul a token passes through whatever it is routed
  to: latent attention's projections in every layer (``q``, ``kv_a``,
  ``kv_b``, ``o``), the dense layers' SwiGLU, the expert layers' router and
  shared experts, and the head;
- the held experts: one SwiGLU of ``moe_intermediate_size`` an assignment
  computed here (assignments to experts held elsewhere are not this card's
  work);
- causal attention: the score product over ``qk_nope + qk_rope`` and the
  value product over ``v_head_dim``, a half of the S x S products, forward
  and backward: 3 x S^2 x H x (nope + rope + v) a layer a sequence.
"""

from __future__ import annotations


def mla_matmul_params(cfg: dict) -> int:
    """Latent attention's matmul parameters in one layer."""
    d, H, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    return d * H * (nope + rope) + d * (r + rope) + r * H * (nope + dv) + H * dv * d


def expert_matmul_params(cfg: dict) -> int:
    """One routed expert's SwiGLU."""
    return 3 * cfg["hidden_size"] * cfg["moe_intermediate_size"]


def dense_path_matmul_params(cfg: dict) -> int:
    """Every matmul parameter a token meets whatever its routing: attention
    in every layer, the dense layers' MLP, the expert layers' router and
    shared experts, the head."""
    d, L, dense = cfg["hidden_size"], cfg["num_hidden_layers"], cfg["first_k_dense_replace"]
    shared = cfg["n_shared_experts"] * expert_matmul_params(cfg)
    return (L * mla_matmul_params(cfg) + dense * 3 * d * cfg["intermediate_size"]
            + (L - dense) * (d * cfg["router_experts"] + shared) + d * cfg["vocab_size"])


def attention_flops(cfg: dict, batch: int, seq: int) -> float:
    """Causal attention's training FLOPs in one step, every layer."""
    width = cfg["qk_nope_head_dim"] + cfg["qk_rope_head_dim"] + cfg["v_head_dim"]
    return (3.0 * seq * seq * cfg["num_attention_heads"] * width
            * batch * cfg["num_hidden_layers"])


def window_flops(cfg: dict, batch: int, seq: int, steps: int, held_assignments: int) -> float:
    """Model FLOPs of ``steps`` training steps that computed
    ``held_assignments`` assignments on the held experts in all."""
    per_step = 6.0 * dense_path_matmul_params(cfg) * batch * seq + attention_flops(cfg, batch, seq)
    return steps * per_step + 6.0 * expert_matmul_params(cfg) * held_assignments
