"""Multi-process cluster launch over the native socket Van.

The port's counterpart of ``parameter_server_tpu/launch.py`` (the
reference's ``script/local.sh``): spawn a scheduler, N servers and M
workers as separate OS processes with their role and topology on the
command line.  The transport is the real socket ``TcpVan`` on loopback
(colocated processes negotiate shm rings), so this is also the
multi-process integration test of the whole stack; the same code runs with
remote addresses across hosts.

Flow: the launcher picks a free port and spawns the scheduler; once the
scheduler has written its ready file, every other role is spawned as
``python -m parameter_server_tpu_torch.launch --role ...``.  Nodes register
with the scheduler carrying their Van address; the node-table broadcast
gives every process routes to every other; workers train async-SGD sparse
LR against the servers, synchronize on a Manager barrier, worker 0 saves
the model, and each server and worker writes a JSON to ``outdir`` for the
launcher to aggregate.

Every role runs on ``device`` (default ``"cuda"``; tests pass ``"cpu"``):
servers hold their tables there, workers compute ``models/linear.py::
grad_rows`` there and push host numpy gradients.  Children are fresh
interpreters (``subprocess``), never forks of a process that has touched
CUDA.  A child's JSON adds its ``device`` and ``scatter.launch_counts()``
to the reference's fields, so a run on the card shows that the entry
point's own processes ran there and launched the kernels.
"""

from __future__ import annotations

import argparse
import json
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time
from typing import Optional

import numpy as np

from parameter_server_tpu_torch.core.filters import DEFAULT_SPEC

#: the scheduler's marker in ``outdir``: its van, postoffice and manager are
#: up, so a REGISTER sent now is handled (the manager sends it once)
READY_FILE = "H.ready"


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _build_cluster(args, role_port: int, setup=None):
    """Common per-process setup: Van, Postoffice, Manager, registration.

    ``setup(post)`` runs BEFORE registration — servers must bind their
    KVServer customer first, because the moment the table broadcast lands,
    workers may start sending Push/Pull at them.
    """
    from parameter_server_tpu_torch.config import TransportConfig
    from parameter_server_tpu_torch.core.filters import make_chain
    from parameter_server_tpu_torch.core.manager import Manager
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.tcp_van import TcpVan

    van = TcpVan(
        port=role_port,
        filter_chain=make_chain(getattr(args, "filters", "none")),
        # ``shm`` False keeps colocated links on TCP (launch_hybrid's wide rows)
        transport=TransportConfig(shm=getattr(args, "shm", True)),
    )
    if args.node_id != "H":
        van.add_route("H", ("127.0.0.1", args.scheduler_port))
    post = Postoffice(args.node_id, van)
    mgr = Manager(
        post,
        num_workers=args.num_workers,
        num_servers=args.num_servers,
        advertise=van.address,
        heartbeat_timeout=args.heartbeat_timeout,
    )
    result = setup(post) if setup is not None else None
    if args.node_id != "H":
        if not mgr.register_with_scheduler(timeout=60):
            raise TimeoutError(f"{args.node_id}: node table never arrived")
    else:
        if args.outdir:
            with open(os.path.join(args.outdir, READY_FILE), "w") as f:
                f.write(str(van.port))
        if not mgr.wait_ready(timeout=60):
            raise TimeoutError("scheduler: not all nodes registered")
    return van, post, mgr, result


def _table_cfgs(args):
    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig

    return {
        "w": TableConfig(
            name="w",
            rows=args.rows,
            dim=1,
            optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.1),
        )
    }


def _write_json(args, row: dict) -> None:
    if args.outdir:
        with open(os.path.join(args.outdir, f"{args.node_id}.json"), "w") as f:
            json.dump(row, f)


def run_scheduler(args) -> int:
    van, post, mgr, _ = _build_cluster(args, args.scheduler_port)
    try:
        _log(args, "ready; waiting on shutdown barrier")
        # stay up until every node passed the final barrier
        n_nodes = args.num_workers + args.num_servers
        ok = mgr.barrier("shutdown", n_nodes + 1, timeout=args.run_timeout)
        _log(args, f"shutdown barrier -> {ok}")
        # Last-observer protocol: the scheduler must outlive every participant
        # still polling the barrier, or their next poll hits a closed van and
        # spuriously returns False.  barrier() acks on success; drain all
        # n_nodes + 1 acks (incl. our own) before tearing the van down.
        if ok:
            drained = mgr.barrier_drain(
                "shutdown", n_nodes + 1, timeout=min(args.run_timeout, 60.0)
            )
            _log(args, f"shutdown barrier drained -> {drained}")
        return 0
    finally:
        van.close()


def run_server(args) -> int:
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.ops import scatter

    index = int(args.node_id[1:])
    van, post, mgr, _server = _build_cluster(
        args,
        0,
        setup=lambda post: KVServer(
            post, _table_cfgs(args), index, args.num_servers, device=args.device
        ),
    )
    try:
        _log(args, "serving; waiting on shutdown barrier")
        n_nodes = args.num_workers + args.num_servers
        ok = mgr.barrier("shutdown", n_nodes + 1, timeout=args.run_timeout)
        _log(args, f"shutdown barrier -> {ok}")
        # every worker has passed its last push before the barrier opens
        _write_json(args, {
            "node": args.node_id,
            "device": _server.device.type,
            "launches": scatter.launch_counts(),
        })
        return 0
    finally:
        van.close()
        _log(args, "van closed")


def _log(args, msg: str) -> None:
    print(
        f"[launch {args.node_id} {time.strftime('%H:%M:%S')}] {msg}",
        file=sys.stderr,
        flush=True,
    )


def run_worker(args) -> int:
    import torch

    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
    from parameter_server_tpu_torch.kv.worker import KVWorker
    from parameter_server_tpu_torch.models import linear
    from parameter_server_tpu_torch.ops import scatter

    van, post, mgr, _ = _build_cluster(args, 0)
    try:
        index = int(args.node_id[1:])
        worker = KVWorker(
            post, _table_cfgs(args), args.num_servers, device=args.device
        )
        dev = worker.device
        data = SyntheticCTR(
            key_space=4 * args.rows,
            nnz=args.nnz,
            batch_size=args.batch_size,
            seed=100 + index,
        )
        _log(args, "training")
        losses = []
        for _ in range(args.steps):
            keys, labels = data.next_batch()
            w_pos = worker.pull_sync("w", keys, timeout=60)
            g, _gb, loss = linear.grad_rows(
                torch.tensor(w_pos, device=dev), torch.tensor(labels, device=dev)
            )
            ts = worker.push("w", keys, g.cpu().numpy() / labels.shape[0])
            if not worker.wait(ts, timeout=60):
                raise TimeoutError("push not acked")
            losses.append(float(loss))
        _log(args, "trained; entering trained barrier")
        # all workers done training before anyone saves (BSP-style epoch end)
        if not mgr.barrier("trained", args.num_workers, timeout=args.run_timeout):
            raise TimeoutError("trained barrier timed out")
        _log(args, "trained barrier passed")
        if index == 0 and args.ckpt_root:
            worker.save_model(args.ckpt_root, step=args.steps)
        # wire byte accounting: the van counts the frame bytes handed to the
        # transport — headers and scales included, socket or shm ring — so
        # runs with and without filters compare the true reduction.
        chain = getattr(van, "filter_chain", None)
        _write_json(args, {
            "node": args.node_id,
            "losses": losses,
            "wire_sent": van.payload_bytes_sent(),
            "wire_recv": van.payload_bytes_recv(),
            # per-message codec cost of the default-on filter stack
            "filter_overhead": chain.overhead() if chain is not None else None,
            "device": dev.type,
            "launches": scatter.launch_counts(),
        })
        n_nodes = args.num_workers + args.num_servers
        ok = mgr.barrier("shutdown", n_nodes + 1, timeout=args.run_timeout)
        _log(args, f"shutdown barrier -> {ok}")
        return 0
    finally:
        van.close()


def _wait_ready(path: str, proc: subprocess.Popen, timeout: float) -> None:
    """Block until the scheduler wrote ``path`` (it is up), it died, or
    ``timeout`` passed."""
    deadline = time.monotonic() + timeout
    while not os.path.exists(path):
        if proc.poll() is not None:
            raise RuntimeError(f"launch: scheduler exited with {proc.returncode}")
        if time.monotonic() > deadline:
            raise TimeoutError("launch: scheduler never became ready")
        time.sleep(0.01)


def launch(
    *,
    num_workers: int = 2,
    num_servers: int = 2,
    steps: int = 20,
    rows: int = 1 << 14,
    batch_size: int = 256,
    nnz: int = 8,
    ckpt_root: Optional[str] = None,
    filters: str = DEFAULT_SPEC,
    run_timeout: float = 300.0,
    python: str = sys.executable,
    device: str = "cuda",
    outdir: Optional[str] = None,
) -> dict:
    """Spawn the full cluster as OS processes; returns aggregated results.

    ``outdir``: where each server and worker writes its JSON (kept for the
    caller); by default a temporary directory, removed before returning."""
    from parameter_server_tpu_torch.core.filters import make_chain

    make_chain(filters)  # validate the spec HERE, not in five children
    port = _free_port()
    own_outdir = outdir is None
    if own_outdir:
        outdir = tempfile.mkdtemp(prefix="psx_launch_")
    repo_root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    pypath = os.environ.get("PYTHONPATH", "")
    env = dict(
        os.environ,
        PYTHONPATH=f"{repo_root}:{pypath}" if pypath else repo_root,
    )

    def spawn(role: str, node_id: str) -> subprocess.Popen:
        cmd = [
            python, "-m", "parameter_server_tpu_torch.launch",
            "--role", role, "--node-id", node_id,
            "--scheduler-port", str(port),
            "--num-workers", str(num_workers),
            "--num-servers", str(num_servers),
            "--steps", str(steps), "--rows", str(rows),
            "--batch-size", str(batch_size), "--nnz", str(nnz),
            "--outdir", outdir,
            "--run-timeout", str(run_timeout),
            "--filters", filters,
            "--device", device,
        ]
        if ckpt_root:
            cmd += ["--ckpt-root", ckpt_root]
        return subprocess.Popen(cmd, env=env)

    try:
        procs = [spawn("scheduler", "H")]
        deadline = time.monotonic() + run_timeout
        rcs = []
        try:
            _wait_ready(os.path.join(outdir, READY_FILE), procs[0], run_timeout)
            procs += [spawn("server", f"S{i}") for i in range(num_servers)]
            procs += [spawn("worker", f"W{i}") for i in range(num_workers)]
            for p in procs:
                left = max(deadline - time.monotonic(), 1.0)
                rcs.append(p.wait(timeout=left))
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        return _aggregate(outdir, num_workers, rcs)
    finally:
        if own_outdir:
            shutil.rmtree(outdir, ignore_errors=True)


def _aggregate(outdir: str, num_workers: int, rcs: list) -> dict:
    losses = []
    per_worker = {}
    wire_sent = wire_recv = 0
    overheads = []
    for i in range(num_workers):
        path = os.path.join(outdir, f"W{i}.json")
        if os.path.exists(path):
            with open(path) as f:
                row = json.load(f)
            per_worker[row["node"]] = row["losses"]
            losses.extend(row["losses"])
            wire_sent += row.get("wire_sent", 0)
            wire_recv += row.get("wire_recv", 0)
            if row.get("filter_overhead"):
                overheads.append(row["filter_overhead"])
    overhead = None
    if overheads:
        overhead = {
            "encode_us_per_msg": round(
                float(np.mean([o["encode_us_per_msg"] for o in overheads])), 2
            ),
            "decode_us_per_msg": round(
                float(np.mean([o["decode_us_per_msg"] for o in overheads])), 2
            ),
            "messages": int(sum(o["encode_calls"] for o in overheads)),
        }
    return {
        "returncodes": rcs,
        "workers_reported": sorted(per_worker),
        "steps_total": len(losses),
        "first_loss": float(np.mean(losses[:5])) if losses else None,
        "final_loss": float(np.mean(losses[-5:])) if losses else None,
        "wire_sent": wire_sent,
        "wire_recv": wire_recv,
        "filter_overhead": overhead,
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--role", required=True,
                   choices=["scheduler", "server", "worker"])
    p.add_argument("--node-id", required=True)
    p.add_argument("--scheduler-port", type=int, required=True)
    p.add_argument("--num-workers", type=int, required=True)
    p.add_argument("--num-servers", type=int, required=True)
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--rows", type=int, default=1 << 14)
    p.add_argument("--batch-size", type=int, default=256)
    p.add_argument("--nnz", type=int, default=8)
    p.add_argument("--outdir", default=None)
    p.add_argument("--ckpt-root", default=None)
    p.add_argument(
        "--filters", default=DEFAULT_SPEC,
        help="wire filter stack on the TcpVan: 'none', 'lossless' "
        "(=key_caching+zlib, the default — bit-exact wire), 'full' "
        "(adds the LOSSY int8 quantizer; explicit opt-in), or a "
        "'+'-separated pipeline over {key_caching, int8, zlib, noise}",
    )
    p.add_argument("--device", default="cuda",
                   help="where servers hold their tables and workers compute "
                   "gradients: 'cuda' (default) or 'cpu'")
    p.add_argument("--heartbeat-timeout", type=float, default=30.0)
    p.add_argument("--run-timeout", type=float, default=300.0)
    args = p.parse_args(argv)
    return {"scheduler": run_scheduler, "server": run_server,
            "worker": run_worker}[args.role](args)


if __name__ == "__main__":
    sys.exit(main())
