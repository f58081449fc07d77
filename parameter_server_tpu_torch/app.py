"""App factory: registry + config-file driven app construction.

Torch-package counterpart of ``parameter_server_tpu/app.py``: the same
registry names, config schema (yaml or json) and result dicts.  Reference
analogue: ``src/system/app.h/.cc`` — ``App::Create(conf)`` reads the config,
looks up the app class by its config type, and the scheduler calls
``app->Run()`` [U].  Here the registry is keyed by the config's ``app:``
field; a builder takes the :class:`AppConfig` and the device and returns a
zero-argument ``run`` callable producing a result dict.  :func:`create`
hands its ``device`` (the card unless the caller asks for the CPU) to the
builder, and every app allocates its tables and models there.
"""

from __future__ import annotations

import dataclasses
import json
from typing import Any, Callable, Dict, Optional

import torch

from parameter_server_tpu_torch.config import (
    ConsistencyConfig,
    ConsistencyMode,
    OptimizerConfig,
    TableConfig,
    TopologyConfig,
)


@dataclasses.dataclass
class DataConfig:
    """Input source: synthetic CTR stream or an on-disk text dataset."""

    kind: str = "synthetic"  # synthetic | libsvm | criteo
    path: Optional[str] = None
    batch_size: int = 1024
    #: synthetic stream parameters (ignored for file inputs)
    key_space: int = 1 << 22
    nnz: int = 39
    seed: int = 0
    #: > 0 enables count-min tail filtering on the key stream: keys whose
    #: estimated frequency is below the threshold mask to the trash row
    #: (the reference's DARLIN preprocessing countmin filter, on the
    #: production input path).
    tail_threshold: int = 0


@dataclasses.dataclass
class AppConfig:
    """One training/eval job — the reference's app-level text proto."""

    app: str
    table: TableConfig
    data: DataConfig = dataclasses.field(default_factory=DataConfig)
    consistency: ConsistencyConfig = dataclasses.field(
        default_factory=ConsistencyConfig
    )
    topology: TopologyConfig = dataclasses.field(default_factory=TopologyConfig)
    steps: int = 100
    eval_batches: int = 0
    ckpt_root: Optional[str] = None
    ckpt_every: int = 0


_REGISTRY: Dict[str, Callable[..., Callable[[], dict]]] = {}


def register_app(name: str):
    """Decorator: register an app builder under ``name``.

    A builder takes the :class:`AppConfig` and the device and returns a
    zero-arg ``run`` callable producing a result dict (losses, metrics, ...).
    """

    def deco(builder):
        if name in _REGISTRY:
            raise ValueError(f"app {name!r} already registered")
        _REGISTRY[name] = builder
        return builder

    return deco


def registered_apps() -> list[str]:
    return sorted(_REGISTRY)


def create(cfg: AppConfig, *, device: str | torch.device = "cuda") -> Callable[[], dict]:
    """The ``App::Create`` seam: config -> runnable app on ``device``."""
    try:
        builder = _REGISTRY[cfg.app]
    except KeyError:
        raise ValueError(
            f"unknown app {cfg.app!r}; registered: {registered_apps()}"
        ) from None
    return builder(cfg, torch.device(device))


# --------------------------------------------------------------- config IO --


def _hydrate(cls, obj: Any):
    """Recursively build a dataclass from a plain dict (yaml/json)."""
    if obj is None or not dataclasses.is_dataclass(cls):
        return obj
    if not isinstance(obj, dict):
        raise TypeError(f"expected mapping for {cls.__name__}, got {type(obj)}")
    kwargs = {}
    fields = {f.name for f in dataclasses.fields(cls)}
    for k, v in obj.items():
        if k not in fields:
            raise ValueError(f"unknown field {k!r} for {cls.__name__}")
        target = _FIELD_TYPES.get((cls.__name__, k))
        if target is not None:
            v = _hydrate(target, v) if isinstance(v, dict) else target(v)
        kwargs[k] = v
    return cls(**kwargs)


#: nested dataclass/enum fields (dataclass field types are strings under
#: ``from __future__ import annotations``, so map them explicitly)
_FIELD_TYPES = {
    ("AppConfig", "table"): TableConfig,
    ("AppConfig", "data"): DataConfig,
    ("AppConfig", "consistency"): ConsistencyConfig,
    ("AppConfig", "topology"): TopologyConfig,
    ("TableConfig", "optimizer"): OptimizerConfig,
    ("ConsistencyConfig", "mode"): ConsistencyMode,
}


def load_config(path: str) -> AppConfig:
    """Read a yaml/json app config file into an :class:`AppConfig`."""
    with open(path) as f:
        text = f.read()
    if path.endswith(".json"):
        raw = json.loads(text)
    else:
        import yaml

        raw = yaml.safe_load(text)
    if not isinstance(raw, dict) or "app" not in raw:
        raise ValueError(f"{path}: config must be a mapping with an 'app' key")
    return _hydrate(AppConfig, raw)


# ------------------------------------------------------------ built-in apps --


def _tail_wrap(batch_fn, data: DataConfig):
    """Apply the count-min tail filter when configured (else pass through)."""
    if data.tail_threshold <= 0:
        return batch_fn
    from parameter_server_tpu_torch.data.tailfilter import TailFilteredStream

    return TailFilteredStream(batch_fn, data.tail_threshold)


def _tail_stats(batch_fn) -> dict:
    """Result-dict stats for a tail-filtered batch source (empty if none)."""
    frac = getattr(batch_fn, "masked_fraction", None)
    if frac is None:
        return {}
    return {
        "tail_masked_fraction": round(float(frac), 6),
        "tail_seen_positions": int(batch_fn.seen),
    }


def _make_batch_fn(data: DataConfig):
    if data.kind == "synthetic":
        from parameter_server_tpu_torch.data.synthetic import SyntheticCTR

        stream = SyntheticCTR(
            key_space=data.key_space,
            nnz=data.nnz,
            batch_size=data.batch_size,
            seed=data.seed,
        )
        return _tail_wrap(stream.next_batch, data)
    if data.kind in ("libsvm", "criteo"):
        import os as os_lib

        from parameter_server_tpu_torch.data import fs
        from parameter_server_tpu_torch.data.reader import StreamReader

        if not data.path:
            raise ValueError(f"data.kind={data.kind!r} requires data.path")
        # the path may be a glob and/or a psfs:// url — shard expansion and
        # remote streaming both go through the fs layer (file.h/HDFS role).
        # An empty expansion is a config error NOW, not a FileNotFoundError
        # three layers deep at the first batch — unless the "glob" is really
        # a literal filename containing metacharacters (day[1].csv) that
        # exists on disk, which must keep working.
        files = fs.list_files(data.path)
        if not files:
            literal = (
                data.path[len("file://") :]
                if data.path.startswith("file://")
                else data.path
            )
            if not data.path.startswith("psfs://") and os_lib.path.exists(literal):
                files = [data.path]
            else:
                raise FileNotFoundError(
                    f"data.path {data.path!r} matched no files"
                )
        reader = StreamReader(
            files, data.batch_size, format=data.kind, epochs=None
        )
        it = iter(reader)

        def next_batch():
            keys, _vals, labels = next(it)
            return keys, labels

        return _tail_wrap(next_batch, data)
    raise ValueError(f"unknown data kind {data.kind!r}")


def _close(van, servers) -> None:
    """Stop a cluster: the van's threads and each server's apply ledger."""
    van.close()
    for srv in servers:
        if srv.ledger is not None:
            srv.ledger.close()


def _local_run(trainer, cfg: AppConfig) -> dict:
    """``cfg.steps`` steps of a fused single-device trainer, then
    ``cfg.eval_batches`` batches of AUC, from the config's batch source."""
    batch_fn = _make_batch_fn(cfg.data)
    losses = [trainer.step(*batch_fn()) for _ in range(cfg.steps)]
    out = {"losses": losses, "steps": cfg.steps, **_tail_stats(batch_fn)}
    if cfg.eval_batches:
        out["auc"] = trainer.eval_auc(batch_fn, cfg.eval_batches)
    return out


@register_app("sparse_lr")
def _build_sparse_lr(cfg: AppConfig, device: torch.device) -> Callable[[], dict]:
    """Single-device fused sparse LR (BASELINE config #1 shape)."""
    from parameter_server_tpu_torch.learner.sgd import LocalLRTrainer

    def run() -> dict:
        return _local_run(LocalLRTrainer(cfg.table, device=device), cfg)

    return run


@register_app("fm")
def _build_fm(cfg: AppConfig, device: torch.device) -> Callable[[], dict]:
    """Single-device fused factorization machine (table dim = 1 + k)."""
    from parameter_server_tpu_torch.learner.fm import LocalFMTrainer

    def run() -> dict:
        return _local_run(LocalFMTrainer(cfg.table, device=device), cfg)

    return run


@register_app("llama_hybrid")
def _build_llama_hybrid(cfg: AppConfig, device: torch.device) -> Callable[[], dict]:
    """BASELINE config #5: PS-served embedding table over the Van + the
    transformer body on a ``(world, 1)`` mesh over every rank of the world
    (``learner/hybrid.py``; a plain process is a world of one).
    ``cfg.table.optimizer`` is the embedding optimizer; the vocab is
    ``data.key_space`` (kept tiny by default so the app runs anywhere);
    ``consistency.max_delay`` bounds in-flight embedding pushes (SSP).
    Batches of (2 x world) x 32 tokens."""

    def run() -> dict:
        import numpy as np

        from parameter_server_tpu_torch.core.postoffice import Postoffice
        from parameter_server_tpu_torch.core.van import LoopbackVan
        from parameter_server_tpu_torch.kv.server import KVServer
        from parameter_server_tpu_torch.kv.worker import KVWorker
        from parameter_server_tpu_torch.learner import hybrid
        from parameter_server_tpu_torch.models import transformer as tfm
        from parameter_server_tpu_torch.parallel import mesh as mesh_lib

        ns = cfg.topology.num_servers
        model_cfg = tfm.tiny_config(
            causal=True, tie_embeddings=False,
            vocab_size=min(cfg.data.key_space, 1 << 16),
        )
        van = LoopbackVan()
        servers = []
        try:
            table = dataclasses.replace(
                hybrid.embedding_table_cfg(model_cfg),
                optimizer=cfg.table.optimizer,
            )
            tables = {"emb": table}
            servers += [
                KVServer(Postoffice(f"S{i}", van), tables, i, ns, device=device)
                for i in range(ns)
            ]
            worker = KVWorker(
                Postoffice("W0", van), tables, ns,
                localizers=hybrid.embedding_localizers(model_cfg), device=device,
            )
            world = _world_size()
            trainer = hybrid.HybridLMTrainer(
                model_cfg, worker, mesh=mesh_lib.make_mesh((world, 1), device=device),
                max_delay=cfg.consistency.max_delay,
            )
            rng = np.random.default_rng(cfg.data.seed)
            B, S = 2 * world, 32  # batch divisible by the data axis
            losses = []
            for _ in range(cfg.steps):
                base = rng.integers(0, model_cfg.vocab_size, size=(B, 1))
                tokens = (base + np.arange(S)[None]) % model_cfg.vocab_size
                losses.append(trainer.step(tokens.astype(np.int32)))
            trainer.drain()
            return {"losses": losses, "steps": cfg.steps}
        finally:
            _close(van, servers)

    return run


def _world_size() -> int:
    """Ranks in the process group (1 in a process that has none)."""
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def _sp_app_knobs(cfg: AppConfig, round_to: int):
    """Shared knobs of the long-context apps (sp_lm / sptp_lm).

    One source for the model config, sequence length (``data.nnz * 64``
    rounded up to ``round_to``: nnz reused as a length knob so the app
    config stays one schema), batch rows, and the synthetic token stream.
    """
    import numpy as np

    from parameter_server_tpu_torch.models import transformer as tfm

    model_cfg = tfm.tiny_config(
        causal=True, tie_embeddings=False,
        vocab_size=min(cfg.data.key_space, 1 << 16),
        max_seq=1 << 16,
    )
    seq = max(cfg.data.nnz, 1) * 64
    seq = ((seq + round_to - 1) // round_to) * round_to
    B = max(cfg.data.batch_size // 256, 1)
    rng = np.random.default_rng(cfg.data.seed)

    def next_tokens() -> np.ndarray:
        base = rng.integers(0, model_cfg.vocab_size, size=(B, 1))
        return ((base + np.arange(seq)[None]) % model_cfg.vocab_size).astype(np.int32)

    return model_cfg, seq, next_tokens


@register_app("sp_lm")
def _build_sp_lm(cfg: AppConfig, device: torch.device) -> Callable[[], dict]:
    """Long-context causal LM: the sequence split over EVERY rank of the
    world (``parallel/sp_lm.py``), ring attention inside the transformer.
    The vocab is ``data.key_space`` (kept small by default); the batch is
    ``data.batch_size // 256`` rows; sequence length per ``_sp_app_knobs``."""

    def run() -> dict:
        from parameter_server_tpu_torch.parallel import mesh as mesh_lib
        from parameter_server_tpu_torch.parallel.sp_lm import SpLMTrainer

        n = _world_size()
        model_cfg, seq, next_tokens = _sp_app_knobs(cfg, n)
        mesh = mesh_lib.make_mesh((n,), ("sp",), device=device)
        trainer = SpLMTrainer(model_cfg, mesh, learning_rate=3e-3)
        losses = [trainer.step(next_tokens()) for _ in range(cfg.steps)]
        return {"losses": losses, "steps": cfg.steps, "seq": seq}

    return run


@register_app("sptp_lm")
def _build_sptp_lm(cfg: AppConfig, device: torch.device) -> Callable[[], dict]:
    """The COMPOSED long-context causal LM (``parallel/sp_fsdp.py``): ring
    attention over an ``sp`` axis x tensor parallelism over ``model`` x
    AdamW moments FSDP over ``sp``.  The mesh shape comes from
    ``topology.mesh_shape`` (data, model) read as (sp, model) over every
    rank of the world: ``None`` (unset) is every rank on sp x model 1, and
    an explicit shape that does not factor the world raises.  Sequence
    length as in the ``sp_lm`` app, rounded to a multiple of sp."""

    def run() -> dict:
        from parameter_server_tpu_torch.parallel import mesh as mesh_lib
        from parameter_server_tpu_torch.parallel.sp_fsdp import SpTpLMTrainer

        n = _world_size()
        shape = None if cfg.topology.mesh_shape is None else tuple(cfg.topology.mesh_shape)
        if shape is None:
            sp_n, tp_n = n, 1
        elif len(shape) == 2 and shape[0] * shape[1] == n:
            sp_n, tp_n = shape
        else:
            # a silently substituted mesh would run the composed SP x TP app
            # with no TP at all: fail the misconfiguration loudly
            raise ValueError(f"topology.mesh_shape {shape} does not factor the {n} "
                             "ranks of the world into (sp, model)")
        model_cfg, seq, next_tokens = _sp_app_knobs(cfg, sp_n)
        mesh = mesh_lib.make_mesh((sp_n, tp_n), ("sp", "model"), device=device)
        trainer = SpTpLMTrainer(model_cfg, mesh, learning_rate=3e-3, fsdp="state",
                                loss_chunk=max(seq // (4 * sp_n), 8))
        losses = [trainer.step(next_tokens()) for _ in range(cfg.steps)]
        return {"losses": losses, "steps": cfg.steps, "seq": seq,
                "mesh": {"sp": sp_n, "model": tp_n}}

    return run


@register_app("async_lr")
def _build_async_lr(cfg: AppConfig, device: torch.device) -> Callable[[], dict]:
    """Classic PS topology on one host: scheduler + servers + worker threads
    over the LoopbackVan with BSP/SSP/ASP gating and elastic workloads."""

    def run() -> dict:
        import numpy as np

        from parameter_server_tpu_torch.core.fleet import FleetMonitor
        from parameter_server_tpu_torch.core.manager import launch_local_cluster
        from parameter_server_tpu_torch.core.messages import server_id, worker_id
        from parameter_server_tpu_torch.core.netmon import MeteredVan
        from parameter_server_tpu_torch.core.van import LoopbackVan
        from parameter_server_tpu_torch.kv.server import KVServer
        from parameter_server_tpu_torch.kv.worker import KVWorker
        from parameter_server_tpu_torch.learner.elastic import ElasticTrainer
        from parameter_server_tpu_torch.utils.keys import HashLocalizer
        from parameter_server_tpu_torch.utils.metrics import transport_counters

        nw, ns = cfg.topology.num_workers, cfg.topology.num_servers
        # metered outermost: per-link wire accounting on every logical
        # message; heartbeats carry the digests to the scheduler's fleet
        # monitor
        van = MeteredVan(LoopbackVan())
        servers = {}
        try:
            sched, managers, posts = launch_local_cluster(
                van, num_workers=nw, num_servers=ns
            )
            sched.fleet = FleetMonitor()
            tables = {cfg.table.name: cfg.table}
            loc = {cfg.table.name: HashLocalizer(cfg.table.rows)}
            servers.update({
                server_id(i): KVServer(posts[server_id(i)], tables, i, ns, device=device)
                for i in range(ns)
            })
            workers = {
                worker_id(i): KVWorker(
                    posts[worker_id(i)], tables, ns, localizers=loc, device=device
                )
                for i in range(nw)
            }
            batch_fn = _make_batch_fn(cfg.data)
            batches_per_shard = 4
            n_shards = max(1, cfg.steps // batches_per_shard)
            shards = [
                [batch_fn() for _ in range(batches_per_shard)]
                for _ in range(n_shards)
            ]
            trainer = ElasticTrainer(
                workers,
                sched,
                shards,
                cfg.consistency,
                managers=managers,
                table=cfg.table.name,
                ckpt_root=cfg.ckpt_root,
                ckpt_every=cfg.ckpt_every,
                device=device,
            )
            losses = trainer.run()
            return {
                "losses": losses,
                "steps": len(losses),
                "mean_loss_tail": float(np.mean(losses[-10:])),
                "last_ckpt_step": trainer.last_ckpt_step,
                "net": transport_counters(van),
                "fleet": sched.fleet.snapshot(),
                "stragglers": sched.fleet.stragglers(),
            }
        finally:
            _close(van, list(servers.values()))

    return run
