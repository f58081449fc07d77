"""Dual-plane config #5 launch: TcpVan embedding servers + a body on a mesh.

Torch counterpart of ``parameter_server_tpu/launch_hybrid.py``, the
deployment BASELINE config #5 describes: KVServers holding the embedding
table run in their OWN OS processes on the native ``TcpVan`` (wire filters
on), while the transformer body runs on a ``(data, model)`` mesh across
more processes, two communication planes crossing real process boundaries:

- **embedding plane**: each body host's first rank is a Van worker and
  pulls and pushes ONLY its host's ``local_batch_slice`` of every global
  batch over real sockets (key-cached, zlib-compressed by default);
- **dense plane**: the body ranks form one process group and one mesh;
  the gradient all-reduce over ``data`` runs over it (gloo on the CPU,
  NCCL on the card).

A JAX body *process* of ``cpu_devices`` devices is a **host of
``cpu_devices`` gloo ranks** here (as in ``launch_spmd.py``): host ``p``'s
ranks form the ``model`` group of data index ``p``, and only the host's
rank 0 talks to the Van (``learner/hybrid.py``'s mesh branch), so the
servers see ``num_body`` workers.  On the card there is one host of one
NCCL rank a card (``num_body > 1`` raises), and the servers are processes
of their own that keep their tables on the card (the kernels run there; an
H100 is shared by processes).  The scheduler holds no table.

Consistency across the plane: ``--bsp`` (default) drains every push and
barriers the body ranks each step, so every push lands before anyone's next
pull; with an ``sgd`` embedding optimizer the two-halves-pushed-separately
update then equals the one-push update up to float summation order, and
the run follows the in-process hybrid.  ``--no-bsp`` is the production
overlap: ``max_delay`` pushes in flight and prefetched pulls (SSP).

Roles mirror ``launch.py`` (scheduler H / servers S* / bodies W*); every
server and body host writes a JSON with its ``device`` and
``scatter.launch_counts()``.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import Optional

from parameter_server_tpu_torch.core.filters import DEFAULT_SPEC
from parameter_server_tpu_torch.launch import (
    READY_FILE,
    _build_cluster,
    _free_port,
    _log,
    _wait_ready,
    _write_json,
    run_scheduler,
)
from parameter_server_tpu_torch.launch_spmd import _host_rc


def _tfm_cfg(args):
    from parameter_server_tpu_torch.models import transformer as tfm

    return tfm.TransformerConfig(
        vocab_size=args.vocab,
        n_layers=args.layers,
        n_heads=args.heads,
        n_kv_heads=args.kv_heads,
        d_model=args.d_model,
        d_ff=args.d_ff,
        max_seq=args.seq,
        causal=True,
        tie_embeddings=False,
    )


def _table_cfgs(args):
    from parameter_server_tpu_torch.learner import hybrid

    return {
        "emb": hybrid.embedding_table_cfg(
            _tfm_cfg(args),
            learning_rate=args.emb_lr,
            optimizer=args.emb_optimizer,
        )
    }


def run_server(args) -> int:
    """One embedding KVServer shard in its own process (TcpVan, filters),
    its table on ``args.device``."""
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.ops import scatter

    index = int(args.node_id[1:])
    van, post, mgr, server = _build_cluster(
        args,
        0,
        setup=lambda post: KVServer(
            post, _table_cfgs(args), index, args.num_servers, device=args.device
        ),
    )
    try:
        _log(args, "emb shard serving; waiting on shutdown barrier")
        n_nodes = args.num_workers + args.num_servers
        ok = mgr.barrier("shutdown", n_nodes + 1, timeout=args.run_timeout)
        _log(args, f"shutdown barrier -> {ok}")
        # every body host has passed its last push before the barrier opens
        _write_json(args, {
            "node": args.node_id,
            "device": server.device.type,
            "pushes": server.pushes,
            "pulls": server.pulls,
            "launches": scatter.launch_counts(),
        })
        return 0
    finally:
        van.close()


def run_body(args) -> int:
    """One rank of a body host: a mesh member, and, as the host's rank 0,
    its Van embedding worker."""
    import torch.distributed as dist

    from parameter_server_tpu_torch.parallel import distributed

    t0 = time.perf_counter()
    host = int(args.node_id[1:])
    # the dense plane first: the process group forms before the Van attaches
    distributed.initialize(
        args.coordinator, args.num_workers, host,
        cpu_devices=args.cpu_devices, local_rank=args.local_rank,
        device=args.device, timeout=args.run_timeout,
    )
    import numpy as np
    import torch

    from parameter_server_tpu_torch.kv.worker import KVWorker
    from parameter_server_tpu_torch.learner import hybrid
    from parameter_server_tpu_torch.ops import scatter

    if args.cpu_devices:
        torch.set_num_threads(1)  # a host's ranks share its cores
    cfg = _tfm_cfg(args)
    mesh = distributed.global_mesh()
    van = mgr = worker = None
    if args.local_rank == 0:
        van, post, mgr, _ = _build_cluster(args, 0)
        worker = KVWorker(post, _table_cfgs(args), args.num_servers,
                          localizers=hybrid.embedding_localizers(cfg), device=mesh.device)
    try:
        tr = hybrid.HybridLMTrainer(
            cfg, worker, mesh=mesh, learning_rate=args.lr,
            max_delay=0 if args.bsp else args.max_delay, seed=args.seed,
        )
        # the deterministic global batch stream, the same on every rank (the
        # reference's coordination-free WorkloadPool determinism)
        rng = np.random.default_rng(args.seed + 1)
        batches = [
            rng.integers(0, cfg.vocab_size, size=(args.global_batch, args.seq)).astype(np.int32)
            for _ in range(args.steps + 1)
        ]
        _log(args, f"rank {dist.get_rank()} training on mesh {mesh.shape}")
        losses, step_s = [], []
        for s in range(args.steps):
            t_step = time.perf_counter()
            nxt = None if args.bsp else batches[s + 1]
            loss = tr.step(batches[s], next_tokens=nxt)
            if args.bsp:
                # BSP across the embedding plane: every host's pushes applied
                # (drained) before anyone's next pull
                tr.drain()
                dist.barrier()
            losses.append(loss)
            step_s.append(time.perf_counter() - t_step)
        tr.drain()
        if van is not None:
            chain = getattr(van, "filter_chain", None)
            _write_json(args, {
                "node": args.node_id,
                "losses": losses,
                "step_s": step_s,
                # socket + colocated shm-ring bytes: the cross-process proof
                # must not read zero because colocated links took the ring
                "wire_sent": van.payload_bytes_sent(),
                "wire_recv": van.payload_bytes_recv(),
                "filter_overhead": chain.overhead() if chain is not None else None,
                "device": mesh.device.type,
                "mesh": mesh.shape,
                "launches": scatter.launch_counts(),
                "job_s": time.perf_counter() - t0,
            })
            n_nodes = args.num_workers + args.num_servers
            ok = mgr.barrier("shutdown", n_nodes + 1, timeout=args.run_timeout)
            _log(args, f"shutdown barrier -> {ok}")
        return 0
    finally:
        if van is not None:
            van.close()
        if dist.is_initialized():
            dist.destroy_process_group()


def launch_hybrid(
    *,
    num_body: int = 2,
    cpu_devices: int = 4,
    num_servers: int = 2,
    steps: int = 4,
    vocab: int = 256,
    layers: int = 2,
    heads: int = 2,
    kv_heads: Optional[int] = None,
    d_model: int = 32,
    d_ff: int = 64,
    seq: int = 16,
    global_batch: int = 8,
    lr: float = 1e-3,
    emb_lr: float = 0.05,
    emb_optimizer: str = "adagrad",
    bsp: bool = True,
    max_delay: int = 2,
    seed: int = 0,
    filters: str = DEFAULT_SPEC,
    run_timeout: float = 300.0,
    python: str = sys.executable,
    device: str = "cuda",
) -> dict:
    """Spawn the dual-plane job: scheduler + embedding servers + body hosts.

    ``device="cpu"``: ``num_body`` hosts of ``cpu_devices`` gloo ranks each
    (0 counts as 1).  ``device="cuda"``: one host of one NCCL rank a card
    (``num_body > 1`` raises ``ValueError``: every host starts on this
    machine), servers on the card too.  ``kv_heads``: grouped-query
    attention's KV heads (Llama-3-8B's 8; default one per head, as the JAX
    launcher's body).  Colocated links negotiate shm rings only when a
    host's rows fit one (:func:`_rows_fit_ring`).

    Returns the JAX keys, by body host: ``returncodes`` (scheduler, servers,
    then each host's), ``losses``, ``wire`` (``sent`` / ``recv`` bytes) and
    ``filter_overhead``; and ``rank_returncodes``, each server's JSON under
    ``servers`` (its ``launches``, ``pushes``, ``pulls``, ``device``), each
    host's ``step_s`` and ``job_s``, and the launch's ``seconds``.
    """
    from parameter_server_tpu_torch.core.filters import make_chain

    make_chain(filters)  # validate the spec HERE, not in the children
    if device == "cuda":
        if num_body > 1:
            raise ValueError(f"launch_hybrid(device='cuda') starts every host on this "
                             f"machine, one rank per card: num_body={num_body} would put "
                             "several ranks on a card; pass num_body=1 or device='cpu'")
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("launch_hybrid(device='cuda'): no CUDA device is visible")
        per_host, cpu_devices = torch.cuda.device_count(), 0
    else:
        per_host = cpu_devices = max(int(cpu_devices), 1)
    shm = _rows_fit_ring(global_batch // num_body, seq, d_model)
    t0 = time.perf_counter()
    sched_port = _free_port()
    coord_port = _free_port()
    outdir = tempfile.mkdtemp(prefix="psx_hybrid_")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pypath = os.environ.get("PYTHONPATH", "")
    env = dict(
        os.environ,
        PYTHONPATH=f"{repo_root}:{pypath}" if pypath else repo_root,
    )

    def spawn(role: str, node_id: str, local_rank: int = 0) -> subprocess.Popen:
        cmd = [
            python, "-m", "parameter_server_tpu_torch.launch_hybrid",
            "--role", role, "--node-id", node_id,
            "--scheduler-port", str(sched_port),
            "--coordinator", f"127.0.0.1:{coord_port}",
            "--num-body", str(num_body),
            "--cpu-devices", str(cpu_devices),
            "--local-rank", str(local_rank),
            "--num-servers", str(num_servers),
            "--steps", str(steps),
            "--vocab", str(vocab), "--layers", str(layers),
            "--heads", str(heads), "--d-model", str(d_model),
            *(["--kv-heads", str(kv_heads)] if kv_heads else []),
            "--d-ff", str(d_ff), "--seq", str(seq),
            "--global-batch", str(global_batch),
            "--lr", str(lr), "--emb-lr", str(emb_lr),
            "--emb-optimizer", emb_optimizer,
            "--max-delay", str(max_delay),
            "--seed", str(seed),
            "--filters", filters,
            "--outdir", outdir,
            "--run-timeout", str(run_timeout),
            "--device", device,
        ] + (["--bsp"] if bsp else ["--no-bsp"]) + ([] if shm else ["--no-shm"])
        return subprocess.Popen(cmd, env=env)

    deadline = time.monotonic() + run_timeout
    procs = []
    rcs = []
    try:
        procs.append(spawn("scheduler", "H"))
        _wait_ready(os.path.join(outdir, READY_FILE), procs[0], run_timeout)
        procs += [spawn("server", f"S{i}") for i in range(num_servers)]
        procs += [spawn("body", f"W{p}", j) for p in range(num_body) for j in range(per_host)]
        for p in procs:
            try:
                rcs.append(p.wait(timeout=max(deadline - time.monotonic(), 1.0)))
            except subprocess.TimeoutExpired:
                rcs.append(None)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            if p.poll() is None:
                try:
                    p.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass  # unkillable (D-state): its rc stays None
    rcs = [p.poll() if rc is None else rc for rc, p in zip(rcs + [None] * len(procs), procs)]
    n_roles = 1 + num_servers
    body_rcs = rcs[n_roles:]
    out = {
        "returncodes": rcs[:n_roles] + [_host_rc(body_rcs[i * per_host:(i + 1) * per_host])
                                        for i in range(num_body)],
        "rank_returncodes": body_rcs,
        "losses": {}, "wire": {}, "filter_overhead": {}, "step_s": {}, "job_s": {},
        "servers": {},
    }
    for i in range(num_body):
        rec = _read_json(outdir, f"W{i}")
        if rec is not None:
            out["losses"][i] = rec["losses"]
            out["wire"][i] = {"sent": rec["wire_sent"], "recv": rec["wire_recv"]}
            out["filter_overhead"][i] = rec.get("filter_overhead")
            out["step_s"][i] = rec["step_s"]
            out["job_s"][i] = rec["job_s"]
    for i in range(num_servers):
        rec = _read_json(outdir, f"S{i}")
        if rec is not None:
            out["servers"][i] = rec
    shutil.rmtree(outdir, ignore_errors=True)
    out["seconds"] = time.perf_counter() - t0
    return out


def _rows_fit_ring(batch: int, seq: int, d_model: int) -> bool:
    """Whether a host's embedding rows (its pull reply, its push: at most
    ``batch x seq`` rows of ``d_model`` floats) fit half a colocated link's
    shm ring.  A stateful filter chain (key caching) drops a frame that the
    ring cannot hold rather than let it overtake on TCP, so wider planes keep
    every link on TCP (config #5 at Llama-3-8B width: ~33 MB a server)."""
    from parameter_server_tpu_torch.config import TransportConfig

    return batch * seq * d_model * 4 <= TransportConfig().ring_capacity // 2


def _read_json(outdir: str, node: str) -> Optional[dict]:
    path = os.path.join(outdir, f"{node}.json")
    if not os.path.exists(path):
        return None
    with open(path) as f:
        return json.load(f)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--role", required=True,
                   choices=["scheduler", "server", "body"])
    p.add_argument("--node-id", required=True)
    p.add_argument("--scheduler-port", type=int, required=True)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-body", type=int, default=2)
    p.add_argument("--cpu-devices", type=int, default=4,
                   help="gloo ranks a body host (the CPU simulation); 0 on the card")
    p.add_argument("--local-rank", type=int, default=0)
    p.add_argument("--num-servers", type=int, default=2)
    p.add_argument("--steps", type=int, default=4)
    p.add_argument("--vocab", type=int, default=256)
    p.add_argument("--layers", type=int, default=2)
    p.add_argument("--heads", type=int, default=2)
    p.add_argument("--kv-heads", type=int, default=None,
                   help="grouped-query KV heads (default: one per head)")
    p.add_argument("--d-model", type=int, default=32)
    p.add_argument("--d-ff", type=int, default=64)
    p.add_argument("--seq", type=int, default=16)
    p.add_argument("--global-batch", type=int, default=8)
    p.add_argument("--lr", type=float, default=1e-3)
    p.add_argument("--emb-lr", type=float, default=0.05)
    p.add_argument("--emb-optimizer", default="adagrad")
    p.add_argument("--bsp", action=argparse.BooleanOptionalAction,
                   default=True)
    p.add_argument("--max-delay", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--filters", default=DEFAULT_SPEC)
    p.add_argument("--outdir", default=None)
    p.add_argument("--heartbeat-timeout", type=float, default=30.0)
    p.add_argument("--run-timeout", type=float, default=300.0)
    p.add_argument("--device", default="cuda",
                   help="where the servers hold their tables and the body ranks "
                   "run: 'cuda' (default) or 'cpu'")
    p.add_argument("--shm", action=argparse.BooleanOptionalAction, default=True,
                   help="negotiate shared-memory rings between colocated nodes "
                   "(launch_hybrid turns them off for rows wider than a ring)")
    args = p.parse_args(argv)
    # Manager / launch code sizes barriers by num_workers: the body hosts
    # (each one Van worker) are the workers of this topology
    args.num_workers = args.num_body
    return {
        "scheduler": run_scheduler,
        "server": run_server,
        "body": run_body,
    }[args.role](args)


if __name__ == "__main__":
    sys.exit(main())
