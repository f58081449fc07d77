"""Plain reference of the Moonlight hybrid cell: DeepSeek-V3's decoder block
(latent attention; a dense SwiGLU MLP in the first ``first_k_dense_replace``
layers, then a sigmoid-routed expert layer with shared experts and a
selection-only bias), whose input embedding is a table trained by AdaGrad
while the body trains by AdamW, the route bias by DeepSeek-V3's balance
update and the loss with its sequence-wise balance loss, step after step,
written from the published description (DeepSeek-V3's ``modeling_deepseek.py``
and arXiv:2412.19437, sections 2.1.2 and 4.2).

It imports nothing of the program, and shares the Mistral reference's
helpers (``psbench/reference/transformer.py``): the matrix product in fp32
or, for the control, with TF32 operands, the RMS norm and the rotary over
interleaved pairs (DeepSeek rotates the halves of de-interleaved pairs: the
same permutation of q's and k's rope dimensions, so the same q.k).

The card holds the experts ``experts_held_first`` onward, ``n_routed_experts``
of them, of the router's ``router_experts``; a token routed to an expert held
elsewhere gets nothing from it (an expert-parallel rank's part of the
layer).  :func:`layer_output` computes that part for any span of experts.

**Near ties.**  Two fp32 programs differ in the last bits of the scores, so
where a token's ``top_k``-th and next score + bias lie within ``delta`` the
two may choose differently, and one flipped choice moves an expert's
gradient far beyond rounding.  Given the program's choices (``choices``),
the reference takes them at such near ties and its own elsewhere; where a
choice of the program lies more than ``delta`` below the reference's
``top_k``-th score, the program chose what the reference would not, and
every loss is NaN.  So is every loss where the program's route biases
after the last step are not the reference's, bit for bit.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from psbench.reference.transformer import _matmul, _rms_norm, _rotary
from psbench.traffic import seed_of

_ATTN_MATS = ("wq", "w_kv_a", "w_kv_b", "wo")
_DENSE_MATS = ("w_gate", "w_up", "w_down")
_MOE_MATS = ("router", "e_gate", "e_up", "e_down", "s_gate", "s_up", "s_down")


def moe_layer(cfg: dict, i: int) -> bool:
    return i >= cfg["first_k_dense_replace"]


def matrix_shapes(cfg: dict) -> dict:
    """Each matrix's shape; an expert stack's leading axis is the held
    experts, its fan-in the second axis."""
    d, H, r = cfg["hidden_size"], cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    F_, f, n = cfg["intermediate_size"], cfg["moe_intermediate_size"], cfg["n_routed_experts"]
    fs = cfg["n_shared_experts"] * f
    return {"wq": (d, H * (nope + rope)), "w_kv_a": (d, r + rope),
            "w_kv_b": (r, H * (nope + dv)), "wo": (H * dv, d),
            "w_gate": (d, F_), "w_up": (d, F_), "w_down": (F_, d),
            "router": (d, cfg["router_experts"]),
            "e_gate": (n, d, f), "e_up": (n, d, f), "e_down": (n, f, d),
            "s_gate": (d, fs), "s_up": (d, fs), "s_down": (fs, d)}


def _layer_mats(cfg: dict, i: int) -> tuple:
    return _ATTN_MATS + (_MOE_MATS if moe_layer(cfg, i) else _DENSE_MATS)


def leaf_names(cfg: dict) -> list:
    """The body's leaves in the reference's layout, then the table."""
    names = []
    for i in range(cfg["num_hidden_layers"]):
        names += [f"layers.{i}.attn_norm", f"layers.{i}.kv_norm",
                  *(f"layers.{i}.{m}" for m in _layer_mats(cfg, i)), f"layers.{i}.mlp_norm"]
    return names + ["final_norm", "lm_head", "embedding"]


def make_weights(cfg: dict, seed: int, device) -> dict:
    """Every weight of the cell from ``seed``: the matrices from one normal
    draw on ``device`` (std 1/sqrt(fan_in)), the norm scales ones, the
    embedding table normal with std 0.02 from a second draw."""
    d, V = cfg["hidden_size"], cfg["vocab_size"]
    shapes = matrix_shapes(cfg)
    mats = [(f"layers.{i}.{m}", shapes[m]) for i in range(cfg["num_hidden_layers"])
            for m in _layer_mats(cfg, i)] + [("lm_head", (d, V))]
    gen = torch.Generator(device=device).manual_seed(seed_of(seed, 3))
    flat = torch.randn(sum(math.prod(s) for _, s in mats), generator=gen, device=device)
    out, at = {}, 0
    for name, shape in mats:
        n = math.prod(shape)
        out[name] = flat[at: at + n].view(shape).mul_(1.0 / math.sqrt(shape[-2]))
        at += n
    for i in range(cfg["num_hidden_layers"]):
        out[f"layers.{i}.attn_norm"] = torch.ones(d, device=device)
        out[f"layers.{i}.kv_norm"] = torch.ones(cfg["kv_lora_rank"], device=device)
        out[f"layers.{i}.mlp_norm"] = torch.ones(d, device=device)
    out["final_norm"] = torch.ones(d, device=device)
    out["embedding"] = torch.randn(V, d, generator=gen, device=device).mul_(0.02)
    return out


def _attention(cfg, w, p, x, mode):
    """Latent attention: q per head, the compressed KV RMS-normed and
    up-projected to each head's key and value, one rotary key for every
    head; causal softmax over sqrt(nope + rope)."""
    B, S, _ = x.shape
    H, r = cfg["num_attention_heads"], cfg["kv_lora_rank"]
    nope, rope, dv = cfg["qk_nope_head_dim"], cfg["qk_rope_head_dim"], cfg["v_head_dim"]
    q = _matmul(x, w[p + "wq"], mode).view(B, S, H, nope + rope)
    c = _matmul(x, w[p + "w_kv_a"], mode)
    kv = _matmul(_rms_norm(c[..., :r], w[p + "kv_norm"], cfg["rms_norm_eps"]),
                 w[p + "w_kv_b"], mode).view(B, S, H, nope + dv)
    q = torch.cat([q[..., :nope], _rotary(q[..., nope:], cfg["rope_theta"])], dim=-1)
    k_pe = _rotary(c[:, :, None, r:], cfg["rope_theta"]).expand(B, S, H, rope)
    k = torch.cat([kv[..., :nope], k_pe], dim=-1)
    q, k, v = (t.transpose(1, 2) for t in (q, k, kv[..., nope:]))  # [B, H, S, D]
    scores = _matmul(q, k.transpose(-1, -2), mode) / math.sqrt(nope + rope)
    mask = torch.ones(S, S, dtype=torch.bool, device=x.device).tril()
    scores = scores.masked_fill(~mask, float("-inf"))
    att = _matmul(torch.softmax(scores, dim=-1), v, mode)  # [B, H, S, dv]
    return _matmul(att.transpose(1, 2).reshape(B, S, H * dv), w[p + "wo"], mode)


def _swiglu(x, gate, up, down, mode):
    return _matmul(F.silu(_matmul(x, gate, mode)) * _matmul(x, up, mode), down, mode)


def _choose(cfg: dict, c: torch.Tensor, program, delta: float, note: dict) -> torch.Tensor:
    """The top ``num_experts_per_tok`` of ``c`` (score + bias) [T, E], with the
    program's choices taken at near ties (module docstring).  ``note`` gets
    ``taken`` (tokens where the program's choice, not this one's, was
    taken), ``gap`` (how far the program's least choice lies below this
    side's k-th score, at most) and ``bad`` (a choice outside the rule)."""
    k = cfg["num_experts_per_tok"]
    c = c.detach()
    top = torch.topk(c, k + 1, dim=-1)
    own = top.indices[:, :k]
    if program is None:
        return own
    if program.shape != own.shape:
        note.update(bad=True, taken=0, gap=math.inf)
        return own
    kth, nxt = top.values[:, k - 1], top.values[:, k]
    below = kth - c.gather(1, program).min(dim=1).values
    tie = (kth - nxt) < delta
    differs = (program.sort(dim=1).values != own.sort(dim=1).values).any(dim=1)
    note.update(bad=bool((below > delta).any()), taken=int((tie & differs).sum()),
                gap=float(below.max()))
    return torch.where(tie[:, None], program, own)


def layer_output(cfg: dict, w: dict, p: str, x: torch.Tensor, bias: torch.Tensor,
                 experts: range, mode: str = "fp32", program=None, delta: float = 0.0,
                 note=None):
    """The expert layer over ``x`` [B, S, d] with the experts ``experts`` of
    the router's (their weights ``w[p + "e_*"]`` in that order): the routed
    part, the shared experts' output, the balance loss and every expert's
    load (int64)."""
    B, S, d = x.shape
    E, k = cfg["router_experts"], cfg["num_experts_per_tok"]
    xf = x.reshape(B * S, d)
    s = torch.sigmoid(_matmul(xf, w[p + "router"], mode))
    idx = _choose(cfg, s + bias, program, delta, {} if note is None else note)
    g = s.gather(1, idx)
    if cfg["norm_topk_prob"]:
        g = g / (g.sum(dim=-1, keepdim=True) + 1e-20)
    g = g * cfg["routed_scaling_factor"]
    routed = torch.zeros_like(xf)
    for j, e in enumerate(experts):
        tok, slot = (idx == e).nonzero(as_tuple=True)  # a token chooses an expert once
        y = _swiglu(xf[tok], w[p + "e_gate"][j], w[p + "e_up"][j], w[p + "e_down"][j], mode)
        routed = routed.index_add(0, tok, y * g[tok, slot, None])
    shared = _swiglu(xf, w[p + "s_gate"], w[p + "s_up"], w[p + "s_down"], mode)
    # sequence-wise balance loss: f_i = E / (k S) x the sequence's tokens
    # that chose i, P_i = the mean over them of s_i / sum_j s_j
    P = (s / s.sum(dim=-1, keepdim=True)).view(B, S, E).mean(dim=1)
    chosen = F.one_hot(idx.reshape(B, S * k), E).sum(dim=1).to(P.dtype)
    balance = cfg["training"]["balance_loss_alpha"] * (chosen * (E / (k * S)) * P).sum(1).mean()
    loads = torch.bincount(idx.reshape(-1), minlength=E)
    return routed.view(B, S, d), shared.view(B, S, d), balance, loads


def _balance_point(s: torch.Tensor, k: int, rounds: int = 300) -> torch.Tensor:
    """The bias under which the top ``k`` of ``s`` + bias [T, E] give every
    expert the mean load, to within the last step: the balance update's own
    rule, sign of the mean load less the load, in steps shrinking from 1e-2
    to 1e-5."""
    b = torch.zeros(s.shape[1], device=s.device)
    mean, step = s.shape[0] * k / s.shape[1], 1e-2
    for _ in range(rounds):
        load = torch.bincount(torch.topk(s + b, k, dim=-1).indices.reshape(-1),
                              minlength=s.shape[1]).to(s.dtype)
        b += step * torch.sign(mean - load)
        step = max(step * 0.97, 1e-5)
    return b


@torch.no_grad()
def settled_route_bias(cfg: dict, w: dict, batches: list) -> dict:
    """Each expert layer's route bias at the balance point of ``batches``
    (token tensors [B, S]): a forward in which each layer routes with the
    bias under which that layer's experts share the batches' assignments
    equally.  A deployment's balance update holds the biases near that
    point; random weights start far from it, and training from them moves
    the experts' loads from step to step and from seed to seed."""
    xs = [w["embedding"][t.long()] for t in batches]
    eps, first = cfg["rms_norm_eps"], cfg["experts_held_first"]
    biases = {}
    for i in range(cfg["num_hidden_layers"]):
        p = f"layers.{i}."
        hs = []
        for j, x in enumerate(xs):
            xs[j] = x = x + _attention(cfg, w, p, _rms_norm(x, w[p + "attn_norm"], eps), "fp32")
            hs.append(_rms_norm(x, w[p + "mlp_norm"], eps))
        if not moe_layer(cfg, i):
            xs = [x + _swiglu(h, w[p + "w_gate"], w[p + "w_up"], w[p + "w_down"], "fp32")
                  for x, h in zip(xs, hs)]
            continue
        s = torch.cat([torch.sigmoid(h.reshape(-1, h.shape[-1]) @ w[p + "router"]) for h in hs])
        biases[i] = _balance_point(s, cfg["num_experts_per_tok"])
        held = range(first, first + cfg["n_routed_experts"])
        for j, h in enumerate(hs):
            routed, shared, _, _ = layer_output(cfg, w, p, h, biases[i], held)
            xs[j] = xs[j] + routed + shared
    return biases


def _block(cfg, w, biases, i, x, mode, program, delta, note):
    p = f"layers.{i}."
    eps = cfg["rms_norm_eps"]
    x = x + _attention(cfg, w, p, _rms_norm(x, w[p + "attn_norm"], eps), mode)
    h = _rms_norm(x, w[p + "mlp_norm"], eps)
    if not moe_layer(cfg, i):
        zero = torch.zeros((), device=x.device)
        return (x + _swiglu(h, w[p + "w_gate"], w[p + "w_up"], w[p + "w_down"], mode), zero,
                torch.zeros(cfg["router_experts"], dtype=torch.int64, device=x.device))
    first = cfg["experts_held_first"]
    routed, shared, balance, loads = layer_output(
        cfg, w, p, h, biases[i], range(first, first + cfg["n_routed_experts"]), mode,
        program, delta, note)
    return x + routed + shared, balance, loads


def loss(cfg: dict, w: dict, biases: dict, emb: torch.Tensor, tokens: torch.Tensor, *,
         matmul: str = "fp32", half_batch: bool = False, choices=None, delta: float = 0.0,
         notes=None):
    """Mean next-token cross-entropy of ``tokens`` [B, S] from their input
    embeddings ``emb`` [B, S, d], plus each expert layer's balance loss;
    and each expert layer's loads.  ``choices``: the program's choices by
    layer; ``notes``: a dict the near-tie notes go to, by layer."""
    x = emb
    loads = {}
    total_balance = []
    for i in range(cfg["num_hidden_layers"]):
        note = {} if notes is None else notes.setdefault(i, {})
        program = None if choices is None else choices.get(i)
        # the backward pass recomputes each block from its input: only the
        # blocks' inputs are kept, so the reference fits at the timed sizes
        x, balance, loads[i] = checkpoint(_block, cfg, w, biases, i, x, matmul, program,
                                          delta, note, use_reentrant=False)
        if moe_layer(cfg, i):
            total_balance.append(balance)
    x = _rms_norm(x, w["final_norm"], cfg["rms_norm_eps"])
    logits = _matmul(x, w["lm_head"], matmul)[:, :-1]
    nll = F.cross_entropy(logits.reshape(-1, logits.shape[-1]),
                          tokens[:, 1:].reshape(-1).long(), reduction="none")
    if half_batch:
        nll = nll[: nll.shape[0] // 2]
    out = nll.mean()
    for balance in total_balance:
        out = out + balance
    return out, loads


def train(cfg: dict, weights: dict, batches: list, *, matmul: str = "fp32",
          half_batch: bool = False, choices=None, delta: float = 0.0,
          route_bias=None, route_bias_init=None) -> dict:
    """Train from ``weights`` (left as they are) over ``batches`` (token
    tensors [B, S] on the weights' device), one step each: rows gathered
    from the table, the loss, AdamW on the body, the route biases' balance
    update, the embedding gradient summed per row and AdaGrad on the table.
    ``route_bias_init``: each expert layer's bias before the first step
    (zeros where not given); ``choices``: the program's choices, by step,
    then by layer;
    ``route_bias``: the program's route biases after the last step, by
    layer.  A bias is a count of steps of ``bias_update_speed`` from loads
    that are counts of the same choices, so it is held to the reference's
    exactly: one that differs makes every loss NaN.  Returns the
    readings (each step's loss, each leaf's gradient norm at the first step,
    each leaf's change after the last), ``routing`` (the near-tie rule's
    count of choices taken from the program and its largest gap) and
    ``route_bias`` (each expert layer's bias after the last step)."""
    tr = cfg["training"]
    ao, eo = tr["body_optimizer"], tr["embedding_optimizer"]
    body = [n for n in leaf_names(cfg) if n != "embedding"]
    w = {n: weights[n].clone().requires_grad_(True) for n in body}
    biases = {i: torch.zeros(cfg["router_experts"], device=w["lm_head"].device)
              if route_bias_init is None else route_bias_init[i].clone()
              for i in range(cfg["num_hidden_layers"]) if moe_layer(cfg, i)}
    table = weights["embedding"].clone()
    sum_sq = torch.zeros_like(table)
    m = {n: torch.zeros_like(w[n]) for n in body}
    v = {n: torch.zeros_like(w[n]) for n in body}
    b1, b2 = ao["beta1"], ao["beta2"]
    losses, grad, taken, gap, bad = [], {}, 0, 0.0, False
    for t, tokens in enumerate(batches, start=1):
        emb = table[tokens.long()].requires_grad_(True)
        notes = {}
        step_loss, loads = loss(cfg, w, biases, emb, tokens, matmul=matmul,
                                half_batch=half_batch, delta=delta, notes=notes,
                                choices=None if choices is None else choices[t - 1])
        gs = torch.autograd.grad(step_loss, [*(w[n] for n in body), emb])
        losses.append(float(step_loss.detach()))
        for note in notes.values():
            if note:
                taken, gap = taken + note["taken"], max(gap, note["gap"])
                bad = bad or note["bad"]
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
            for i, b in biases.items():
                load = loads[i].to(torch.float32)
                b.add_(tr["bias_update_speed"] * torch.sign(load.mean() - load))
            sum_sq.addcmul_(g_rows, g_rows)
            table.sub_(eo["learning_rate"] * g_rows / (sum_sq.sqrt() + eo["eps"]))
        del gs, g_rows, emb, step_loss
    if route_bias is not None:
        bad = bad or any(not torch.equal(route_bias[i], b) for i, b in biases.items())
    if bad:
        losses = [math.nan] * len(losses)
    with torch.no_grad():
        change = {n: float(torch.linalg.vector_norm(w[n] - weights[n])) for n in body}
        change["embedding"] = float(torch.linalg.vector_norm(table - weights["embedding"]))
    return {"losses": losses, "grad": grad, "change": change,
            "routing": {"taken": taken, "gap": gap}, "route_bias": biases}
