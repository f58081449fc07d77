"""Driver of the hybrid LM cells (config #5's path): the port's
``HybridLMTrainer`` over ``KVServer``s with device replies on a
``LoopbackVan``, the input embedding a PS table trained by AdaGrad, the body
a dense transformer trained by AdamW.  One window step is one
``trainer.step(tokens, next_tokens=...)``: the pull of this batch's rows
(prefetched by the step before), the body's forward, backward and AdamW,
the push of the embedding gradient, the prefetch of the next batch's rows.

Set-up builds the cluster and the trainer, writes the weights the benchmark
made from the seed into the body and the servers' table, and drives the
trainer through the first ``CHECKED_STEPS`` batches of the pool, reading the
gradients after the first and the change after the last.
"""

from __future__ import annotations

import gc
import time

import numpy as np

from psbench import traffic
from psbench.reference import transformer as reference

RATE = "tokens_per_s"
#: steps the reference follows
CHECKED_STEPS = 3

#: the reference's leaf names -> the program's parameter names
_PROGRAM_NAMES = {
    "attn_norm": "attn_norm.scale", "wq": "attn.q.kernel", "wk": "attn.k.kernel",
    "wv": "attn.v.kernel", "wo": "attn.o.kernel", "mlp_norm": "mlp_norm.scale",
    "w_gate": "mlp.gate.kernel", "w_up": "mlp.up.kernel", "w_down": "mlp.down.kernel",
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
    stated = {"rms_norm_eps": tfm.NORM_EPS, "hidden_act": "silu", "torch_dtype": "float32",
              "tie_word_embeddings": False}
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
        n_heads=cfg["num_attention_heads"], n_kv_heads=cfg["num_key_value_heads"],
        d_model=cfg["hidden_size"], d_ff=cfg["intermediate_size"],
        max_seq=cfg["max_position_embeddings"], rope_theta=cfg["rope_theta"],
        causal=True, positional="rotary", norm="rms", activation="swiglu",
        tie_embeddings=False, dtype=torch.float32)


class Driver:
    def __init__(self, torch, cfg: dict, workload: dict, seed: int, device, tracer=None):
        self.torch, self.cfg, self.seed, self.device = torch, cfg, seed, torch.device(device)
        self.params = workload["traffic"]
        if self.params["pool_batches"] <= CHECKED_STEPS:
            raise ValueError(f"the pool needs more than {CHECKED_STEPS} distinct batches")
        self.tokens_per_step = self.params["batch"] * self.params["seq"]
        self.tracer = tracer

    # -- set-up --------------------------------------------------------------
    def setup(self) -> None:
        torch, cfg = self.torch, self.cfg
        from parameter_server_tpu_torch.core.postoffice import Postoffice
        from parameter_server_tpu_torch.core.van import LoopbackVan
        from parameter_server_tpu_torch.kv.partition import RangePartition
        from parameter_server_tpu_torch.kv.server import KVServer
        from parameter_server_tpu_torch.kv.worker import KVWorker
        from parameter_server_tpu_torch.learner import hybrid

        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
        torch.set_float32_matmul_precision("highest")
        if self.params["generator"] != "zipf_tokens":
            raise ValueError("the hybrid driver reads zipf_tokens traffic, not "
                             f"{self.params['generator']!r}")
        tcfg = transformer_config(torch, cfg)
        tr = cfg["training"]
        t0 = time.perf_counter()
        n_srv = tr["embedding_servers"]
        self.van = LoopbackVan()
        tables = {"emb": hybrid.embedding_table_cfg(
            tcfg, learning_rate=tr["embedding_optimizer"]["learning_rate"])}
        self.servers = [KVServer(Postoffice(f"S{s}", self.van), tables, s, n_srv,
                                 device_replies=True, device=self.device)
                        for s in range(n_srv)]
        worker = KVWorker(Postoffice("W0", self.van), tables, n_srv,
                          localizers=hybrid.embedding_localizers(tcfg), device=self.device)
        self.trainer = hybrid.HybridLMTrainer(
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
        t2 = time.perf_counter()
        self.readings = self._first_steps(weights, params)
        self.phases = {"program": t1 - t0, "inputs": t2 - t1,
                       "checked_steps": time.perf_counter() - t2}

    def _shards(self) -> list:
        """Each server's rows of the embedding (its trash row left out)."""
        return [s.tables["emb"].value[: s.tables["emb"].rows] for s in self.servers]

    def _first_steps(self, weights: dict, params: dict) -> dict:
        torch, tr = self.torch, self.trainer
        losses, grad = [], {}
        for t in range(CHECKED_STEPS):
            losses.append(self._step())
            tr.drain()  # every push applied before the tables are read
            if t == 0:
                scale = 1.0 - tr.optimizer.defaults["betas"][0]  # exp_avg = (1 - b1) g
                # a parameter AdamW never stepped has no state: no gradient
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

    def _step(self) -> float:
        n = len(self.tokens)
        loss = self.trainer.step(self.tokens[self.steps % n],
                                 next_tokens=self.tokens[(self.steps + 1) % n])
        self.steps += 1
        return loss

    # -- the window -------------------------------------------------------------
    def window_start(self) -> None:
        self._losses = []
        if self.tracer is not None:
            self.tracer.clear()

    def step(self) -> int:
        self._losses.append(self._step())
        return self.tokens_per_step

    def sync(self) -> None:
        self.trainer.drain()
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def window_end(self) -> dict:
        self.sync()
        waits = ([s[2] for s in self.tracer.spans("hybrid.pull_wait")]
                 if self.tracer is not None else [])
        return {"steps": len(self._losses),
                "failed": int(sum(not np.isfinite(x) for x in self._losses)),
                "batch": self.params["batch"], "seq": self.params["seq"],
                "pull_wait_s": waits}

    # -- after the window -------------------------------------------------------
    def free(self) -> None:
        """Stop the cluster and drop the program's state (what set-up built
        of it, where set-up failed)."""
        tr = self.__dict__.pop("trainer", None)
        if tr is not None:
            tr.drain()
            tr.optimizer.state.clear()
            tr.optimizer.zero_grad(set_to_none=True)
        if hasattr(self, "van"):
            self.van.close()
        for srv in self.__dict__.pop("servers", []):
            if srv.ledger is not None:
                srv.ledger.close()
        self.__dict__.pop("van", None)
        del tr
        gc.collect()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()

    def reference(self, **control) -> dict:
        """The reference's readings over the checked steps (``control``:
        ``matmul`` / ``half_batch``, for the control and the faults)."""
        weights = reference.make_weights(self.cfg, self.seed, self.device)
        batches = [self.torch.from_numpy(self.tokens[t]).to(self.device)
                   for t in range(CHECKED_STEPS)]
        return reference.train(self.cfg, weights, batches, **control)

    #: the control: the reference with TF32 matrix products
    CONTROL = {"matmul": "tf32"}
