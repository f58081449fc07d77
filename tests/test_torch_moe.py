"""The port's DeepSeek-V3 block (latent attention, the expert layer) and its
training through ``HybridLMTrainer`` against the benchmark's plain
reference (``psbench/reference/moe_transformer.py``), on the CPU at toy
sizes, on the reference's seeded weights: 16 router outputs, 4 experts held
(experts 4-7), top 3, 2 shared experts, a dense first layer.

Tolerances are float32's: outputs and losses ``rtol=1e-5``, gradients and
trained parameters ``rtol=1e-4`` (the two sides add in other orders).  The
route biases and the held assignments are counts and signs: exact.
"""

import copy
import dataclasses
import json
import pathlib
import types

import numpy as np
import pytest
import torch

from parameter_server_tpu_torch import convert
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.kv.partition import RangePartition
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.learner import hybrid
from parameter_server_tpu_torch.learner.lm import SpmdLMTrainer
from parameter_server_tpu_torch.models import transformer as tfm
from parameter_server_tpu_torch.parallel.pp import PipelinedLMTrainer
from parameter_server_tpu_torch.utils.trace import Tracer
from psbench.drivers import hybrid_moe
from psbench.reference import moe_transformer as reference

ROOT = pathlib.Path(__file__).resolve().parents[1]
OUT = dict(rtol=1e-5, atol=1e-6)
GRAD = dict(rtol=1e-4, atol=1e-6)
#: the toy sizes: every width of the configuration file cut, its keys kept
TOY = dict(hidden_size=64, num_attention_heads=4, kv_lora_rank=16, qk_nope_head_dim=8,
           qk_rope_head_dim=4, v_head_dim=8, intermediate_size=96, moe_intermediate_size=32,
           router_experts=16, n_routed_experts=4, experts_held_first=4,
           num_experts_per_tok=3, vocab_size=256, num_hidden_layers=3)
B, S = 2, 16


def _cfg(**kw) -> dict:
    cfg = json.loads((ROOT / "psbench/configs/moonlight-16b-a3b-hybrid.json").read_text())
    cfg.update(TOY, **kw)
    return cfg


def _port_cfg(cfg: dict, **kw) -> tfm.TransformerConfig:
    return dataclasses.replace(hybrid_moe.transformer_config(torch, cfg), **kw)


def _load(module, weights: dict) -> None:
    """The reference's weights into the port's body (or trainer body)."""
    params = dict(module.named_parameters())
    with torch.no_grad():
        for leaf, w in weights.items():
            if leaf != "embedding":
                p = params[hybrid_moe.program_name(leaf)]
                p.copy_(w.reshape(p.shape))


def _trainer(cfg: dict, seed: int = 5, worker=None, **kw):
    lr = cfg["training"]["body_optimizer"]["learning_rate"]
    tr = hybrid.HybridLMTrainer(_port_cfg(cfg, **kw), worker, learning_rate=lr, device="cpu")
    weights = reference.make_weights(cfg, seed, "cpu")
    _load(tr.body, weights)
    return tr, weights


def _moe_block(cfg: dict, weights: dict, layer: int, first: int, held: int) -> tfm.MoEBlock:
    """An expert layer holding experts ``first .. first + held`` of the
    uncut layer whose weights ``weights`` hold all of them."""
    moe = tfm.MoEBlock(_port_cfg(cfg, experts_held=(first, held)), device="cpu")
    p = f"layers.{layer}."
    names = {"router": "router.kernel", "s_gate": "shared.gate.kernel",
             "s_up": "shared.up.kernel", "s_down": "shared.down.kernel",
             "e_gate": "experts.gate.kernel", "e_up": "experts.up.kernel",
             "e_down": "experts.down.kernel"}
    params = dict(moe.named_parameters())
    with torch.no_grad():
        for leaf, name in names.items():
            w = weights[p + leaf]
            params[name].copy_(w[first: first + held] if leaf.startswith("e_") else w)
    return moe


def _x(seed: int = 0) -> torch.Tensor:
    return torch.randn(B, S, 64, generator=torch.Generator().manual_seed(seed))


# -- the parts ----------------------------------------------------------------------


def test_latent_attention_matches_the_reference():
    cfg = _cfg()
    tr, w = _trainer(cfg)
    x = _x()
    positions = torch.arange(S).expand(B, S)
    with torch.no_grad():
        got = tr.body.layer_1.attn(x, positions)
    want = reference._attention(cfg, w, "layers.1.", x, "fp32")
    torch.testing.assert_close(got, want, **OUT)


def test_the_expert_layer_matches_the_reference():
    """Choice (top 3 of score + bias), weights (over their sum, times 2.446),
    the held experts' outputs and the shared experts; the loads over all 16
    and the balance loss."""
    cfg = _cfg()
    tr, w = _trainer(cfg)
    moe = tr.body.layer_1.mlp
    bias = 0.05 * torch.randn(16, generator=torch.Generator().manual_seed(1))
    moe.route_bias.copy_(bias)
    seen = []
    moe.choice_hook = seen.append
    x = _x()
    with torch.no_grad():
        got = moe(x)
        routed, shared, balance, loads = reference.layer_output(
            cfg, w, "layers.1.", x, bias, range(4, 8))
    torch.testing.assert_close(got, routed + shared, **OUT)
    s = torch.sigmoid(x.reshape(B * S, 64) @ w["layers.1.router"])
    own = torch.topk(s + bias, 3, dim=-1).indices
    assert torch.equal(seen[0].sort(dim=1).values, own.sort(dim=1).values)
    assert torch.equal(moe.loads, loads) and int(loads.sum()) == B * S * 3
    torch.testing.assert_close(moe.balance, balance, **OUT)
    # the scale and the renormalisation reach the routed part only
    unscaled = tfm.MoEBlock(dataclasses.replace(moe.cfg, routed_scale=1.0), device="cpu")
    unscaled.load_state_dict(moe.state_dict())
    with torch.no_grad():
        torch.testing.assert_close((got - shared) / 2.446, unscaled(x) - shared, **OUT)


def test_the_shares_add_up_to_the_uncut_layer():
    """Four cards holding 4 experts each: their routed parts, plus the
    shared experts once, are the uncut 16-expert layer, the port's and the
    reference's."""
    cfg = _cfg(n_routed_experts=16, experts_held_first=0)
    w = reference.make_weights(cfg, 7, "cpu")
    bias = 0.05 * torch.randn(16, generator=torch.Generator().manual_seed(2))
    x = _x(3)
    uncut = _moe_block(cfg, w, 1, 0, 16)
    shares = [_moe_block(cfg, w, 1, 4 * s, 4) for s in range(4)]
    with torch.no_grad():
        for moe in (uncut, *shares):
            moe.route_bias.copy_(bias)
        shared = uncut.shared(x)
        whole = uncut(x)
        parts = [moe(x) - shared for moe in shares]
        routed, ref_shared, _, _ = reference.layer_output(cfg, w, "layers.1.", x, bias,
                                                          range(16))
    torch.testing.assert_close(sum(parts) + shared, whole, **OUT)
    torch.testing.assert_close(whole, routed + ref_shared, **OUT)
    # each share's loads are the router's, over every expert
    assert all(torch.equal(m.loads, uncut.loads) for m in shares)


@pytest.mark.parametrize("remat", [False, True])
def test_the_body_loss_and_gradients_match_the_reference(remat):
    """The trainer's loss (the LM loss plus each expert layer's balance
    loss) and every leaf's gradient and the input embeddings'."""
    cfg = _cfg()
    tr, w = _trainer(cfg, remat=remat)
    tr.body.layer_2.mlp.route_bias.copy_(0.01 * torch.arange(16.0))
    tok = torch.randint(0, 256, (B, S), generator=torch.Generator().manual_seed(4))
    emb = (0.02 * _x(5)).requires_grad_(True)
    loss = tr._loss(emb, tok)
    loss.backward()
    body = [n for n in reference.leaf_names(cfg) if n != "embedding"]
    wr = {n: w[n].clone().requires_grad_(True) for n in body}
    emb_r = emb.detach().clone().requires_grad_(True)
    biases = {1: torch.zeros(16), 2: 0.01 * torch.arange(16.0)}
    want, _ = reference.loss(cfg, wr, biases, emb_r, tok)
    want.backward()
    torch.testing.assert_close(loss.detach(), want.detach(), **OUT)
    params = dict(tr.body.named_parameters())
    for n in body:
        got = params[hybrid_moe.program_name(n)].grad
        torch.testing.assert_close(got.reshape(wr[n].shape), wr[n].grad, **GRAD, msg=n)
    torch.testing.assert_close(emb.grad, emb_r.grad, **GRAD)


def test_three_trained_steps_match_the_reference():
    """Three ``HybridLMTrainer`` steps over a PS table on two servers: the
    losses with the balance loss, AdamW, the route biases' balance update
    (exact), the table's AdaGrad, and the held assignments counted on the
    card."""
    cfg = _cfg()
    tcfg = _port_cfg(cfg)
    van = LoopbackVan()
    tables = {"emb": hybrid.embedding_table_cfg(
        tcfg, learning_rate=cfg["training"]["embedding_optimizer"]["learning_rate"])}
    servers = [KVServer(Postoffice(f"S{s}", van), tables, s, 2, device_replies=True,
                        device="cpu") for s in range(2)]
    try:
        worker = KVWorker(Postoffice("W0", van), tables, 2,
                          localizers=hybrid.embedding_localizers(tcfg), device="cpu")
        tr, w = _trainer(cfg, worker=worker)
        offsets = RangePartition(256, 2).offsets
        with torch.no_grad():
            for s, srv in enumerate(servers):
                srv.tables["emb"].value[: srv.tables["emb"].rows].copy_(
                    w["embedding"][offsets[s]: offsets[s + 1]])
        choices = [{} for _ in range(3)]
        for i, moe in ((1, tr.body.layer_1.mlp), (2, tr.body.layer_2.mlp)):
            moe.choice_hook = lambda idx, i=i: choices[tr.step_count].__setitem__(i, idx)
        batches = [np.random.default_rng(t).integers(0, 256, (B, S)).astype(np.int32)
                   for t in range(3)]
        losses = [tr.step(b) for b in batches]
        tr.drain()
        held = sum(int(((c >= 4) & (c < 8)).sum()) for step in choices for c in step.values())
        assert int(tr.held_assignments) == held > 0
        ref = reference.train(cfg, w, [torch.from_numpy(b) for b in batches],
                              choices=choices, delta=1e-4)
        np.testing.assert_allclose(losses, ref["losses"], rtol=1e-5)
        for i, moe in ((1, tr.body.layer_1.mlp), (2, tr.body.layer_2.mlp)):
            assert torch.equal(moe.route_bias, ref["route_bias"][i])
            assert moe.route_bias.abs().max() > 0
        params = dict(tr.body.named_parameters())
        for n, change in ref["change"].items():
            if n != "embedding":
                got = float(torch.linalg.vector_norm(
                    params[hybrid_moe.program_name(n)].detach().reshape(w[n].shape) - w[n]))
                np.testing.assert_allclose(got, change, rtol=1e-4, err_msg=n)
    finally:
        van.close()
        for srv in servers:
            if srv.ledger is not None:
                srv.ledger.close()


def test_the_trainer_counts_active_parameters():
    """6ND's N: the held experts count by the share a token reaches, top_k x
    held / n_experts of them (3 x 4 / 16 here)."""
    cfg = _cfg()
    tr, _ = _trainer(cfg)
    total = sum(p.numel() for p in tr.body.parameters())
    per_expert = 3 * 64 * 32
    assert tr.n_body_params == total - 2 * (4 - 0.75) * per_expert


def test_the_expert_layer_records_its_spans():
    cfg = _cfg()
    tr, _ = _trainer(cfg, remat=False)  # a recompute would record its forward again
    tracer = Tracer()
    for block in tr.body.modules():
        if isinstance(block, tfm.Block):
            block.tracer = tracer
    tok = torch.randint(0, 256, (B, S))
    tr._loss(0.02 * _x(), tok).backward()
    for name in ("tfm.attention", "tfm.mlp", "tfm.moe.route", "tfm.moe.dispatch",
                 "tfm.moe.experts", "tfm.moe.combine", "tfm.moe.shared"):
        # forward and backward of each layer that has the stage
        want = 2 * (3 if name in ("tfm.attention", "tfm.mlp") else 2)
        assert len(tracer.spans(name)) == want, name


# -- the near-tie rule -------------------------------------------------------------


def test_near_ties_take_the_programs_choice_choice_for_choice():
    cfg = {"num_experts_per_tok": 3}
    c = torch.tensor([[0.9, 0.8, 0.7, 0.7 - 5e-5, 0.1],   # 3rd and 4th within delta
                      [0.9, 0.8, 0.7, 0.5, 0.1],          # no tie
                      [0.1, 0.9, 0.8, 0.7, 0.7 - 2e-5]])  # a tie, the same choice
    program = torch.tensor([[0, 1, 3], [1, 0, 2], [1, 2, 3]])
    note = {}
    got = reference._choose(cfg, c, program, 1e-4, note)
    assert got.sort(dim=1).values.tolist() == [[0, 1, 3], [0, 1, 2], [1, 2, 3]]
    assert note["taken"] == 1 and not note["bad"]
    assert note["gap"] == pytest.approx(5e-5, rel=1e-3)
    # a choice 0.2 under the reference's third: outside the rule
    note = {}
    reference._choose(cfg, c, torch.tensor([[0, 1, 3], [0, 1, 3], [1, 2, 3]]), 1e-4, note)
    assert note["bad"]
    note = {}
    reference._choose(cfg, c, program[:2], 1e-4, note)  # another shape: another batch
    assert note["bad"]


def test_a_choice_or_a_bias_outside_the_rule_makes_every_reference_loss_nan():
    cfg = _cfg()
    w = reference.make_weights(cfg, 3, "cpu")
    batches = [torch.randint(0, 256, (B, S), generator=torch.Generator().manual_seed(t))
               for t in range(2)]
    sound = reference.train(cfg, w, batches)
    assert all(np.isfinite(sound["losses"]))
    # the reference's own biases pass; one step of one expert's bias off does not
    same = reference.train(cfg, w, batches, route_bias=sound["route_bias"])
    assert same["losses"] == sound["losses"]
    off = {i: b.clone() for i, b in sound["route_bias"].items()}
    off[2][5] += cfg["training"]["bias_update_speed"]
    assert all(np.isnan(reference.train(cfg, w, batches, route_bias=off)["losses"]))
    # every token's choice: experts 0-2, whatever the scores
    wrong = [{i: torch.arange(3).expand(B * S, 3) for i in (1, 2)} for _ in batches]
    assert all(np.isnan(reference.train(cfg, w, batches, choices=wrong, delta=1e-4)["losses"]))


# -- what stays as it was, and what refuses ------------------------------------------


def test_a_dense_config_builds_and_computes_as_before():
    """A config without the new fields: the same parameters (names, shapes),
    no buffer, no expert layer, and attention computed by the same sequence
    of operations, bit for bit."""
    cfg = tfm.tiny_config(causal=True, tie_embeddings=False)
    body = tfm.TransformerBody(cfg, device="cpu", generator=tfm.make_generator("cpu", 0))
    want = {"final_norm.scale": (64,), "lm_head.kernel": (64, 256)}
    for i in range(2):
        want.update({f"layer_{i}.attn_norm.scale": (64,), f"layer_{i}.mlp_norm.scale": (64,),
                     f"layer_{i}.attn.q.kernel": (64, 4, 16), f"layer_{i}.attn.k.kernel": (64, 2, 16),
                     f"layer_{i}.attn.v.kernel": (64, 2, 16), f"layer_{i}.attn.o.kernel": (4, 16, 64),
                     f"layer_{i}.mlp.gate.kernel": (64, 128), f"layer_{i}.mlp.up.kernel": (64, 128),
                     f"layer_{i}.mlp.down.kernel": (128, 64)})
    assert {n: tuple(p.shape) for n, p in body.named_parameters()} == want
    assert not list(body.buffers()) and body.moe_layers() == []
    w = {k[len("layer_0.attn."):]: v for k, v in body.named_parameters()
         if k.startswith("layer_0.attn.")}
    x = _x()
    positions = torch.arange(S).expand(B, S)
    with torch.no_grad():
        got = tfm._attention(cfg, w, x, positions, None)
        q = tfm._rotary(tfm._dense(cfg, tfm._sub(w, "q"), x, 1), positions, cfg.rope_theta)
        k = tfm._rotary(tfm._dense(cfg, tfm._sub(w, "k"), x, 1), positions, cfg.rope_theta)
        k, v = tfm._repeat_kv(k, 4), tfm._repeat_kv(tfm._dense(cfg, tfm._sub(w, "v"), x, 1), 4)
        scores = torch.einsum("bshd,bthd->bhst", q, k).to(torch.float32) / np.sqrt(16)
        causal = torch.tril(torch.ones((S, S), dtype=torch.bool))
        scores = torch.where(causal[None, None], scores, tfm.MASK_VALUE)
        out = torch.einsum("bhst,bthd->bshd", torch.softmax(scores, dim=-1), v)
        want_out = tfm._dense(cfg, tfm._sub(w, "o"), out, 2)
    assert torch.equal(got, want_out)


def test_paths_not_extended_refuse_the_new_blocks():
    cfg = _port_cfg(_cfg())
    model_split = types.SimpleNamespace(shape={"model": 2})
    for bad in (dict(scan_blocks=True), dict(attn_impl="ring"), dict(spmd_mesh=model_split)):
        with pytest.raises(ValueError, match="dense GQA blocks only"):
            tfm.TransformerBody(dataclasses.replace(cfg, **bad), device="cpu")
    mla_only = dataclasses.replace(cfg, n_experts=0)
    with pytest.raises(ValueError, match="dense GQA blocks only"):
        tfm.TransformerBody(dataclasses.replace(mla_only, scan_blocks=True), device="cpu")
    with pytest.raises(ValueError, match="PipelinedLMTrainer"):
        PipelinedLMTrainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="SpmdLMTrainer"):
        SpmdLMTrainer(cfg, device="cpu")
    with pytest.raises(ValueError, match="convert"):
        convert.transformer_from_numpy(tfm.TransformerBody(cfg, device="cpu"), {})
    with pytest.raises(ValueError, match="one card"):
        hybrid.HybridLMTrainer(cfg, None, mesh=model_split, device="cpu")


def test_the_config_file_keeps_the_published_numbers():
    """Every key of the published config at its published value, but the
    three cuts (and the dtype), each stated in ``reduced_from``."""
    cfg = json.loads((ROOT / "psbench/configs/moonlight-16b-a3b-hybrid.json").read_text())
    spec = json.loads((ROOT / "BENCHMARK.json").read_text())
    entry = next(c for c in spec["configs"] if c["name"] == "moonlight-16b-a3b-hybrid")
    assert set(cfg["reduced_from"]) == set(entry["reduced"])
    assert (cfg["num_hidden_layers"], cfg["n_routed_experts"], cfg["vocab_size"]) == (
        9, 8, 163840 // 8)
    assert cfg["router_experts"] == cfg["reduced_from"]["n_routed_experts"] == 64
    tcfg = hybrid_moe.transformer_config(torch, copy.deepcopy(cfg))
    assert (tcfg.n_experts, tcfg.experts_held, tcfg.top_k, tcfg.norm_eps) == (64, (0, 8), 6, 1e-5)


@pytest.mark.parametrize("key,value", [("norm_topk_prob", False), ("scoring_func", "softmax"),
                                       ("topk_method", "greedy")])
def test_the_driver_refuses_a_router_the_port_does_not_run(key, value):
    """The port always renormalises the chosen sigmoid scores and chooses
    by score + bias: a configuration stating otherwise is refused."""
    cfg = json.loads((ROOT / "psbench/configs/moonlight-16b-a3b-hybrid.json").read_text())
    cfg[key] = value
    with pytest.raises(ValueError, match=key):
        hybrid_moe.transformer_config(torch, cfg)


def test_the_settled_route_biases_balance_their_batch():
    """The cell's starting biases (the first batch's balance point): on that
    batch every expert takes the mean load, in the reference and through
    the port's trainer; from zeros the loads spread far wider."""
    cfg = _cfg()
    tr, w = _trainer(cfg, remat=False)
    tok = torch.randint(0, 256, (8, 64), generator=torch.Generator().manual_seed(1))
    biases = reference.settled_route_bias(cfg, w, [tok])
    mean = 8 * 64 * 3 // 16

    def loads():
        with torch.no_grad():
            tr._loss(w["embedding"][tok.long()], tok)
        return [moe.loads for moe in tr._moe]

    assert all(int((L - mean).abs().max()) > mean // 4 for L in loads())
    for i, b in biases.items():
        getattr(tr.body, f"layer_{i}").mlp.route_bias.copy_(b)
    assert all(int((L - mean).abs().max()) <= 1 for L in loads())
