"""Multi-host SPMD job launch: one rank per device, hosts of ranks, one mesh.

Torch counterpart of ``parameter_server_tpu/launch_spmd.py``.  A JAX pod runs
one process per host over that host's chips; a torch world runs one rank per
device, so a JAX process with ``cpu_devices=k`` is a **host of k ranks**
here: ``launch_spmd(num_procs=2, cpu_devices=4, device="cpu")`` starts 8 gloo
ranks as 2 hosts of 4, and host ``p``'s ranks form the ``model`` group of
data index ``p`` on a ``(2, 4)`` mesh.  On the card a host has one rank per
card, joined by NCCL.

Per-rank flow (:func:`main`): ``distributed.initialize`` -> global
``(data, model)`` mesh -> :class:`~parameter_server_tpu_torch.parallel.lr_spmd.SpmdLRTrainer`
row-sharded across all ranks -> each step, every host generates ONLY its own
data shards (the WorkloadPool assignment, the same streams as the JAX job)
and each rank feeds its block of them.  Each host's first rank writes the
loss trajectory for the launcher to aggregate.

Checkpoints keep the JAX file layout (``spmd_step{step:06d}.npz``, keys
``value``, ``bias``, ``state.<k>``, ``bias_state.<k>``): the table is gathered
over ``model``, rank 0 writes atomically, and every rank waits at a barrier.
A gloo world does not survive a dead rank, so a killed job rejoins by being
launched again with ``resume``: a NEW world forms, loads the newest
checkpoint and fast-forwards the data streams.
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

from parameter_server_tpu_torch.launch import _free_port


def _assign_shards(num_procs: int, n_shards: int) -> dict:
    """Deterministic WorkloadPool shard assignment, same on every host.

    Every host replays the identical request order against a local
    :class:`~parameter_server_tpu_torch.learner.workload.WorkloadPool`, so the
    assignment is coordination-free.  Shards are CONTIGUOUS blocks per host —
    shard i is global-batch rows [i*B/n, (i+1)*B/n) — and the shard streams
    are host-count-independent, so a 1-host job and an N-host job see
    byte-identical global batches.
    """
    from parameter_server_tpu_torch.learner.workload import WorkloadPool

    if n_shards % num_procs:
        raise ValueError(f"data shards {n_shards} % procs {num_procs} != 0")
    per = n_shards // num_procs
    pool = WorkloadPool(list(range(n_shards)))
    assignment: dict = {}
    for p in range(num_procs):  # block order: proc p owns [p*per, (p+1)*per)
        assignment[p] = [pool.get(f"proc{p}").payload for _ in range(per)]
    return assignment


def _ckpt_path(root: str, step: int) -> str:
    return os.path.join(root, f"spmd_step{step:06d}.npz")


def _latest_ckpt_step(root: str) -> Optional[int]:
    if not root or not os.path.isdir(root):
        return None
    steps = []
    for name in os.listdir(root):
        if name.startswith("spmd_step") and name.endswith(".npz"):
            steps.append(int(name[len("spmd_step") : -4]))
    return max(steps) if steps else None


def run_job(
    *,
    coordinator: Optional[str],
    num_procs: int,
    proc_id: int,
    cpu_devices: int,
    steps: int,
    rows: int,
    global_batch: int,
    nnz: int,
    mesh_data: int,
    seed: int = 0,
    data_shards: Optional[int] = None,
    ckpt_root: Optional[str] = None,
    ckpt_every: int = 0,
    resume: bool = False,
    die_after_step: Optional[int] = None,
    die_proc: int = 1,
    local_rank: int = 0,
    device: str = "cuda",
    timeout: float = 300.0,
) -> dict:
    """One rank's share of the SPMD LR job.

    Returns ``{"losses": [...], "data_digest": ..., "start_step": ...}``.
    Losses are global (reduced over ``data``), so every rank returns the same
    trajectory.  Each host generates ONLY its own shard streams.  With
    ``ckpt_root``/``ckpt_every`` the full sharded state checkpoints every K
    steps; ``resume`` restarts from the newest checkpoint with the data
    streams fast-forwarded.  ``die_after_step`` is the fault-injection hook:
    every rank of host ``die_proc`` (of every host for -1) exits with code 17
    after that step.  ``timeout`` bounds every collective.
    """
    from parameter_server_tpu_torch.parallel import distributed

    distributed.initialize(coordinator, num_procs, proc_id, cpu_devices=cpu_devices,
                           local_rank=local_rank, device=device, timeout=timeout)
    import numpy as np_
    import torch
    import torch.distributed as dist

    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
    from parameter_server_tpu_torch.parallel import lr_spmd

    if cpu_devices:
        torch.set_num_threads(1)  # a host's ranks share its cores
    n_dev = dist.get_world_size()
    if n_dev % mesh_data:
        raise ValueError(f"{n_dev} devices not divisible by data={mesh_data}")
    mesh = distributed.global_mesh((mesh_data, n_dev // mesh_data))
    cfg = TableConfig(
        name="w",
        rows=rows,
        dim=1,
        optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.1),
    )
    trainer = lr_spmd.SpmdLRTrainer(cfg, mesh, seed=seed)

    # -- per-host data shards (each host generates ONLY its share) ----------
    # When the data axis spans the hosts (mesh_data >= num_procs) each host
    # generates exactly its own shards; otherwise every host feeds the full
    # batch — the streams are identical either way.
    n_shards = data_shards or max(2 * num_procs, 4)
    if global_batch % n_shards:
        raise ValueError(f"global_batch {global_batch} % shards {n_shards}")
    shard_batch = global_batch // n_shards
    sharded_feed = mesh_data >= num_procs and mesh_data % num_procs == 0
    if sharded_feed:
        my_shards = _assign_shards(num_procs, n_shards)[proc_id]
    else:
        my_shards = list(range(n_shards))

    def _stream(shard: int) -> SyntheticCTR:
        return SyntheticCTR(
            key_space=4 * rows, nnz=nnz, batch_size=shard_batch,
            seed=seed + 7919 * (shard + 1),
        )

    streams = {shard: _stream(shard) for shard in my_shards}
    digest = None  # first local batch fingerprint (test observability)

    # -- resume --------------------------------------------------------------
    start_step = 0
    if resume and ckpt_root:
        last = _latest_ckpt_step(ckpt_root)
        if last is not None:
            with np_.load(_ckpt_path(ckpt_root, last)) as z:
                trainer.load_full_state({k: z[k] for k in z.files})
            start_step = last
    # absolute-step indexed feeding: regenerate and skip consumed batches so
    # a resumed run sees exactly the batches the lost steps would have seen
    for _ in range(start_step):
        for stream in streams.values():
            stream.next_batch()

    losses = []
    for s in range(start_step, steps):
        parts = [streams[sh].next_batch() for sh in my_shards]
        keys = np_.concatenate([p[0] for p in parts])
        labels = np_.concatenate([p[1] for p in parts])
        if digest is None:
            digest = int(np_.asarray(keys, dtype=np_.uint64).sum())
        losses.append(trainer.step(keys, labels, global_batch=global_batch))
        done = s + 1
        if ckpt_root and ckpt_every and done % ckpt_every == 0 and done < steps:
            full = trainer.full_state()  # a collective over each model group
            if dist.get_rank() == 0:
                os.makedirs(ckpt_root, exist_ok=True)
                tmp = _ckpt_path(ckpt_root, done) + ".tmp"
                with open(tmp, "wb") as f:
                    np_.savez(f, **full)
                os.replace(tmp, _ckpt_path(ckpt_root, done))
            dist.barrier()
        if (
            die_after_step is not None
            and (die_proc < 0 or proc_id == die_proc)
            and done == die_after_step
        ):
            # fault injection: hard kill mid-job.  die_proc=-1 kills every
            # host at that step (a whole-job death); a single host's death
            # leaves the survivors blocked in their next collective until
            # its timeout raises — resume semantics are identical.
            os._exit(17)
    return {"losses": losses, "data_digest": digest, "start_step": start_step}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--coordinator", default=None)
    p.add_argument("--num-procs", type=int, default=1)
    p.add_argument("--proc-id", type=int, default=0)
    p.add_argument("--local-rank", type=int, default=0)
    p.add_argument("--cpu-devices", type=int, default=0)
    p.add_argument("--device", default="cuda")
    p.add_argument("--timeout", type=float, default=300.0)
    p.add_argument("--steps", type=int, default=8)
    p.add_argument("--rows", type=int, default=1 << 12)
    p.add_argument("--global-batch", type=int, default=256)
    p.add_argument("--nnz", type=int, default=8)
    p.add_argument("--mesh-data", type=int, default=2)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--outdir", default=None)
    p.add_argument("--data-shards", type=int, default=None)
    p.add_argument("--ckpt-root", default=None)
    p.add_argument("--ckpt-every", type=int, default=0)
    p.add_argument("--resume", action="store_true")
    p.add_argument("--die-after-step", type=int, default=None)
    p.add_argument("--die-proc", type=int, default=1)
    args = p.parse_args(argv)
    t0 = time.perf_counter()
    result = run_job(
        coordinator=args.coordinator,
        num_procs=args.num_procs,
        proc_id=args.proc_id,
        cpu_devices=args.cpu_devices,
        steps=args.steps,
        rows=args.rows,
        global_batch=args.global_batch,
        nnz=args.nnz,
        mesh_data=args.mesh_data,
        seed=args.seed,
        data_shards=args.data_shards,
        ckpt_root=args.ckpt_root,
        ckpt_every=args.ckpt_every,
        resume=args.resume,
        die_after_step=args.die_after_step,
        die_proc=args.die_proc,
        local_rank=args.local_rank,
        device=args.device,
        timeout=args.timeout,
    )
    if args.outdir and args.local_rank == 0:
        path = os.path.join(args.outdir, f"proc{args.proc_id}.json")
        with open(path, "w") as f:
            json.dump({"proc": args.proc_id, "job_s": time.perf_counter() - t0,
                       **result}, f)
    import torch.distributed as dist

    dist.destroy_process_group()
    return 0


def _host_rc(rcs: list):
    """A host's code: None if a rank could not be reaped, else its first
    non-zero (-9 for a rank killed at the deadline), else 0."""
    if any(rc is None for rc in rcs):
        return None
    return next((rc for rc in rcs if rc), 0)


def launch_spmd(
    *,
    num_procs: int = 2,
    cpu_devices: int = 0,
    steps: int = 8,
    rows: int = 1 << 12,
    global_batch: int = 256,
    nnz: int = 8,
    mesh_data: int = 2,
    seed: int = 0,
    timeout: float = 300.0,
    python: str = sys.executable,
    data_shards: Optional[int] = None,
    ckpt_root: Optional[str] = None,
    ckpt_every: int = 0,
    resume: bool = False,
    die_after_step: Optional[int] = None,
    die_proc: int = 1,
    device: str = "cuda",
    group_timeout: float = 300.0,
) -> dict:
    """Start the job: ``num_procs`` hosts, each of ``cpu_devices`` gloo
    ranks (the CPU simulation, ``device="cpu"``; 0 counts as 1) or one host
    of one NCCL rank per card (``device="cuda"``; ``num_procs > 1`` raises
    ``ValueError``, since every host runs on this machine).

    Returns ``{"returncodes": [...], "losses": {proc_id: [...]},
    "digests": {...}, "start_steps": {...}}`` keyed by host, as the JAX
    launcher does, plus ``"rank_returncodes"`` and each host's ``"job_s"``.
    A rank that hangs past ``timeout`` is killed and reported (-9), not
    raised.
    """
    if device == "cuda":
        if cpu_devices:
            raise ValueError("cpu_devices simulates a host's devices on the CPU: "
                             "pass device='cpu'")
        if num_procs > 1:
            # every host starts on this machine and its rank j takes cuda:j,
            # so a second host would put a second rank on each card
            raise ValueError(f"launch_spmd(device='cuda') starts every host on this "
                             f"machine, one rank per card: num_procs={num_procs} would "
                             "put several ranks on a card; pass num_procs=1 (one host "
                             "of every card) or device='cpu'")
        import torch

        if not torch.cuda.is_available():
            raise RuntimeError("launch_spmd(device='cuda'): no CUDA device is visible")
        per_host = torch.cuda.device_count()
    else:
        per_host = max(int(cpu_devices), 1)
    port = _free_port()
    outdir = tempfile.mkdtemp(prefix="psx_spmd_")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pypath = os.environ.get("PYTHONPATH", "")
    env = dict(
        os.environ,
        PYTHONPATH=f"{repo_root}:{pypath}" if pypath else repo_root,
    )

    extra = []
    if data_shards is not None:
        extra += ["--data-shards", str(data_shards)]
    if ckpt_root:
        extra += ["--ckpt-root", ckpt_root, "--ckpt-every", str(ckpt_every)]
    if resume:
        extra += ["--resume"]
    if die_after_step is not None:
        extra += [
            "--die-after-step", str(die_after_step), "--die-proc", str(die_proc)
        ]
    if device != "cuda":
        extra += ["--cpu-devices", str(per_host)]
    procs = [
        subprocess.Popen(
            [
                python, "-m", "parameter_server_tpu_torch.launch_spmd",
                "--coordinator", f"127.0.0.1:{port}",
                "--num-procs", str(num_procs),
                "--proc-id", str(i), "--local-rank", str(j),
                "--device", device, "--timeout", str(group_timeout),
                "--steps", str(steps), "--rows", str(rows),
                "--global-batch", str(global_batch), "--nnz", str(nnz),
                "--mesh-data", str(mesh_data), "--seed", str(seed),
                "--outdir", outdir,
                *extra,
            ],
            env=env,
        )
        for i in range(num_procs)
        for j in range(per_host)
    ]
    deadline = time.monotonic() + timeout
    rcs = []
    try:
        for p_ in procs:
            try:
                rcs.append(
                    p_.wait(timeout=max(deadline - time.monotonic(), 1.0))
                )
            except subprocess.TimeoutExpired:
                # e.g. a rank died and a peer hangs in a collective: report
                # which ranks hung instead of raising
                rcs.append(None)
    finally:
        for p_ in procs:
            if p_.poll() is None:
                p_.kill()
        for p_ in procs:
            # reap: SIGKILL delivery is asynchronous, so wait bounds it
            if p_.poll() is None:
                try:
                    p_.wait(timeout=5.0)
                except subprocess.TimeoutExpired:
                    pass  # unkillable (D-state): leave rc as None
    rcs = [p_.poll() if rc is None else rc for rc, p_ in zip(rcs, procs)]
    losses, digests, start_steps, job_s = {}, {}, {}, {}
    for i in range(num_procs):
        path = os.path.join(outdir, f"proc{i}.json")
        if os.path.exists(path):
            with open(path) as f:
                rec = json.load(f)
            losses[i] = rec["losses"]
            digests[i] = rec.get("data_digest")
            start_steps[i] = rec.get("start_step", 0)
            job_s[i] = rec.get("job_s")
    shutil.rmtree(outdir, ignore_errors=True)
    return {
        "returncodes": [_host_rc(rcs[i * per_host:(i + 1) * per_host])
                        for i in range(num_procs)],
        "rank_returncodes": rcs,
        "losses": losses,
        "digests": digests,
        "start_steps": start_steps,
        "job_s": job_s,
    }


if __name__ == "__main__":
    sys.exit(main())
