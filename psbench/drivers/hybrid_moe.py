"""Driver of the Moonlight hybrid cell: the hybrid LM driver
(``psbench/drivers/hybrid.py``) over the port's DeepSeek-V3 body (latent
attention, a dense first layer, then expert layers holding this card's
experts) and its plain reference (``psbench/reference/moe_transformer.py``).

One window step is one ``trainer.step(tokens, next_tokens=...)``, as in the
hybrid driver; the trainer's step also moves each layer's route bias and
adds the step's held assignments to its card-side counter, which the
window reads once, at its end (``held_assignments``, for ``mfu.moe``).

Set-up builds the port's config first, before any server starts (a program
without the expert layer fails here at once), then the cluster and the
trainer as the hybrid driver does, and sets each expert layer's route bias
at the balance point of the pool's first ``SETTLE_BATCHES`` batches
(``reference.settled_route_bias``), the reference's starting point too.
Over the checked steps each expert layer hands its choices to the driver
(``MoEBlock.choice_hook``, unset before the window), and the reference
takes them at near ties, those within the workload's ``route_tie_delta``;
it holds the route biases after them to its own, exactly (the reference's
docstring).  The window's end prints the held experts' share of its
assignments.
"""

from __future__ import annotations

import sys
import time

from psbench import traffic
from psbench.drivers import hybrid
from psbench.reference import moe_transformer as reference

RATE = "tokens_per_s"
CHECKED_STEPS = hybrid.CHECKED_STEPS
#: the batches whose balance point the route biases start from: those of the
#: checked steps and of a 30-s window
SETTLE_BATCHES = 16

#: the reference's leaf names -> the program's parameter names, in a layer
_PROGRAM_NAMES = {
    "attn_norm": "attn_norm.scale", "wq": "attn.q.kernel", "w_kv_a": "attn.kv_a.kernel",
    "kv_norm": "attn.kv_norm.scale", "w_kv_b": "attn.kv_b.kernel", "wo": "attn.o.kernel",
    "mlp_norm": "mlp_norm.scale", "w_gate": "mlp.gate.kernel", "w_up": "mlp.up.kernel",
    "w_down": "mlp.down.kernel", "router": "mlp.router.kernel",
    "e_gate": "mlp.experts.gate.kernel", "e_up": "mlp.experts.up.kernel",
    "e_down": "mlp.experts.down.kernel", "s_gate": "mlp.shared.gate.kernel",
    "s_up": "mlp.shared.up.kernel", "s_down": "mlp.shared.down.kernel",
}


def program_name(leaf: str) -> str:
    if leaf.startswith("layers."):
        _, i, part = leaf.split(".")
        return f"layer_{i}.{_PROGRAM_NAMES[part]}"
    return {"final_norm": "final_norm.scale", "lm_head": "lm_head.kernel"}[leaf]


def transformer_config(torch, cfg: dict):
    """The port's ``TransformerConfig`` for the configuration file, refusing
    what the port cannot run as stated."""
    from parameter_server_tpu_torch.learner.lm import ADAMW
    from parameter_server_tpu_torch.models import transformer as tfm

    tr = cfg["training"]
    ao, eo = tr["body_optimizer"], tr["embedding_optimizer"]
    stated = {"hidden_act": "silu", "torch_dtype": "float32", "tie_word_embeddings": False,
              "q_lora_rank": None, "attention_bias": False, "scoring_func": "sigmoid",
              "topk_method": "noaux_tc", "n_group": 1, "topk_group": 1, "moe_layer_freq": 1,
              "seq_aux": True, "num_nextn_predict_layers": 0, "norm_topk_prob": True}
    for key, want in stated.items():
        if cfg[key] != want:
            raise ValueError(f"the port runs {key}={want!r}, the configuration states {cfg[key]!r}")
    if (ADAMW["betas"], ADAMW["eps"], ADAMW["weight_decay"]) != (
            (ao["beta1"], ao["beta2"]), ao["eps"], ao["weight_decay"]):
        raise ValueError(f"the port's AdamW is {ADAMW}, the configuration states {ao}")
    if eo["kind"] != "adagrad" or eo["eps"] != 1e-8 or tr["matmul"] != "fp32":
        raise ValueError("the hybrid driver runs an AdaGrad table (eps 1e-8) and fp32 matmuls")
    return tfm.TransformerConfig(
        vocab_size=cfg["vocab_size"], n_layers=cfg["num_hidden_layers"],
        n_heads=cfg["num_attention_heads"], d_model=cfg["hidden_size"],
        d_ff=cfg["intermediate_size"], max_seq=cfg["max_position_embeddings"],
        rope_theta=float(cfg["rope_theta"]), norm_eps=cfg["rms_norm_eps"], causal=True,
        positional="rotary", norm="rms", activation="swiglu", tie_embeddings=False,
        dtype=torch.float32, remat=tr["remat"], attn_kind="mla",
        kv_lora_rank=cfg["kv_lora_rank"], qk_nope_dim=cfg["qk_nope_head_dim"],
        qk_rope_dim=cfg["qk_rope_head_dim"], v_head_dim=cfg["v_head_dim"],
        n_experts=cfg["router_experts"],
        experts_held=(cfg["experts_held_first"], cfg["n_routed_experts"]),
        top_k=cfg["num_experts_per_tok"], moe_d_ff=cfg["moe_intermediate_size"],
        n_shared=cfg["n_shared_experts"], routed_scale=cfg["routed_scaling_factor"],
        first_dense=cfg["first_k_dense_replace"],
        balance_alpha=tr["balance_loss_alpha"], bias_rate=tr["bias_update_speed"])


class Driver(hybrid.Driver):
    def __init__(self, torch, cfg: dict, workload: dict, seed: int, device, tracer=None):
        super().__init__(torch, cfg, workload, seed, device, tracer=tracer)
        self.delta = workload["route_tie_delta"]
        #: the program's choices over the checked steps: by step, by layer
        self.choices = [{} for _ in range(CHECKED_STEPS)]

    # -- set-up --------------------------------------------------------------
    def setup(self) -> None:
        torch, cfg = self.torch, self.cfg
        # first: a port without the expert layer refuses these fields here
        tcfg = transformer_config(torch, cfg)
        from parameter_server_tpu_torch.core.postoffice import Postoffice
        from parameter_server_tpu_torch.core.van import LoopbackVan
        from parameter_server_tpu_torch.kv.partition import RangePartition
        from parameter_server_tpu_torch.kv.server import KVServer
        from parameter_server_tpu_torch.kv.worker import KVWorker
        from parameter_server_tpu_torch.learner import hybrid as learner

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        if self.params["generator"] != "zipf_tokens":
            raise ValueError("the hybrid driver reads zipf_tokens traffic, not "
                             f"{self.params['generator']!r}")
        tr = cfg["training"]
        t0 = time.perf_counter()
        n_srv = tr["embedding_servers"]
        self.van = LoopbackVan()
        tables = {"emb": learner.embedding_table_cfg(
            tcfg, learning_rate=tr["embedding_optimizer"]["learning_rate"])}
        self.servers = [KVServer(Postoffice(f"S{s}", self.van), tables, s, n_srv,
                                 device_replies=True, device=self.device)
                        for s in range(n_srv)]
        worker = KVWorker(Postoffice("W0", self.van), tables, n_srv,
                          localizers=learner.embedding_localizers(tcfg), device=self.device)
        self.trainer = learner.HybridLMTrainer(
            tcfg, worker, learning_rate=tr["body_optimizer"]["learning_rate"],
            max_delay=tr["max_delay"], seed=0, tracer=self.tracer, device=self.device)
        self.offsets = RangePartition(cfg["vocab_size"], n_srv).offsets
        t1 = time.perf_counter()
        weights = reference.make_weights(cfg, self.seed, self.device)
        params = dict(self.trainer.body.named_parameters())
        with torch.no_grad():
            for leaf, w in weights.items():
                if leaf == "embedding":
                    for s, shard in enumerate(self._shards()):
                        shard.copy_(w[self.offsets[s]: self.offsets[s + 1]])
                else:
                    params[program_name(leaf)].copy_(w.reshape(params[program_name(leaf)].shape))
        self.tokens = traffic.zipf_tokens(self.params, self.seed, cfg["vocab_size"])
        self.steps = 0
        layers = {i: getattr(self.trainer.body, f"layer_{i}").mlp
                  for i in range(tcfg.n_layers) if tcfg.moe_layer(i)}
        #: the route biases before the first step: the first batches' balance point
        self.route_bias_init = reference.settled_route_bias(
            cfg, weights, [torch.from_numpy(t).to(self.device)
                           for t in self.tokens[:SETTLE_BATCHES]])
        with torch.no_grad():
            for i, moe in layers.items():
                moe.route_bias.copy_(self.route_bias_init[i])
        t2 = time.perf_counter()
        for i, moe in layers.items():
            moe.choice_hook = self._hook(i)
        try:
            self.readings = self._first_steps(weights, params)
        finally:
            for moe in layers.values():
                del moe.choice_hook  # the class default: no hook in the window
        #: the route biases after the checked steps, held to the reference's
        self.route_bias = {i: moe.route_bias.clone() for i, moe in layers.items()}
        self.phases = {"program": t1 - t0, "inputs": t2 - t1,
                       "checked_steps": time.perf_counter() - t2}

    def _hook(self, layer: int):
        def keep(idx):  # a recompute under remat hands the same choices again
            self.choices[self.steps][layer] = idx
        return keep

    def _first_steps(self, weights: dict, params: dict) -> dict:
        torch, tr = self.torch, self.trainer
        losses, grad = [], {}
        for t in range(CHECKED_STEPS):
            losses.append(self._step())
            tr.drain()  # every push applied before the tables are read
            if t == 0:
                scale = 1.0 - tr.optimizer.defaults["betas"][0]  # exp_avg = (1 - b1) g
                grad = {leaf: float(torch.linalg.vector_norm(tr.optimizer.state.get(
                    params[program_name(leaf)], {}).get("exp_avg", torch.zeros(1)))) / scale
                    for leaf in weights if leaf != "embedding"}
                sq = sum(float(s.tables["emb"].state["sum_sq"][: s.tables["emb"].rows]
                               .double().sum()) for s in self.servers)
                grad["embedding"] = sq ** 0.5
        with torch.no_grad():
            change = {leaf: float(torch.linalg.vector_norm(
                params[program_name(leaf)].reshape(w.shape) - w))
                for leaf, w in weights.items() if leaf != "embedding"}
            sq = sum(float(torch.sum(torch.square(
                shard.double() - weights["embedding"][self.offsets[s]: self.offsets[s + 1]])))
                for s, shard in enumerate(self._shards()))
            change["embedding"] = sq ** 0.5
        return {"losses": losses, "grad": grad, "change": change}

    # -- the window -------------------------------------------------------------
    def window_start(self) -> None:
        """The held-assignment count from zero."""
        super().window_start()
        self.trainer.held_assignments.zero_()

    def window_end(self) -> dict:
        counts = super().window_end()
        counts["held_assignments"] = held = int(self.trainer.held_assignments)
        every = (counts["steps"] * self.tokens_per_step * self.trainer.cfg.top_k
                 * len(self.trainer.body.moe_layers()))
        print(f"psbench: held experts' share of the window's assignments "
              f"{held / max(every, 1)!r}", file=sys.stderr)
        return counts

    # -- after the window -------------------------------------------------------
    def reference(self, **control) -> dict:
        """The reference's readings over the checked steps, at the program's
        near-tie choices (``control``: ``matmul`` / ``half_batch``, for the
        control and the faults)."""
        weights = reference.make_weights(self.cfg, self.seed, self.device)
        batches = [self.torch.from_numpy(self.tokens[t]).to(self.device)
                   for t in range(CHECKED_STEPS)]
        out = reference.train(self.cfg, weights, batches, choices=self.choices,
                              delta=self.delta, route_bias=self.route_bias,
                              route_bias_init=self.route_bias_init, **control)
        routing = out["routing"]
        print(f"psbench: near ties {control or 'sound'}: {routing['taken']} program choices "
              f"taken, the program's least choice at most {routing['gap']!r} under the "
              f"reference's k-th (delta {self.delta!r})", file=sys.stderr)
        return out
