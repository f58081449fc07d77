"""Multi-rank dry run: one training step of each sharded path over n ranks.

Torch twin of ``__graft_entry__.py::dryrun_multichip``.  It runs the same
sections in the same order and prints the same ``dryrun ... OK`` lines:

1. the PS row-sharded sparse-LR table on a ``(data, model)`` mesh;
2. the DP x TP transformer train step;
3. ring attention over an ``sp`` mesh, against full attention;
4. the SP trainer (ring attention inside the model);
5. the composed SP x TP trainer (even n >= 4);
6. the pipeline, GPipe and 1F1B;
7. config #5's hybrid: embeddings served by KVServers over a LoopbackVan
   (on each data line's model-index-0 rank), the body on the mesh;
8. the multi-host runtime: ``launch_spmd`` as 2 hosts (even n >= 2);
9. the dual plane: ``launch_hybrid``'s servers on sockets in their own
   processes and a 2-host body (even n >= 4).

A JAX mesh is n devices in one process; here sections 1-7 run on ``n``
spawned ranks in one world (gloo on the CPU, NCCL with one rank a card) and
rank 0 prints their lines; sections 8 and 9 start their own processes from
this one.  A section that n does not allow is skipped, as JAX skips it, and
the skip is printed.  Sections 8 and 9 run on the CPU whatever ``device``
is, as JAX runs them on ``cpu_devices``: their two hosts all start on this
machine, and the launchers give a card world one host.  Their lines say so,
and the result's ``section_devices`` names the device each section ran on.

Run: ``python -m parameter_server_tpu_torch.dryrun --ranks 4 --device cpu``.
"""

from __future__ import annotations

import argparse
import json
import multiprocessing as mp
import socket
import sys
import time
import traceback
from typing import Dict, List

import numpy as np


def _free_port() -> int:
    s = socket.socket()
    s.bind(("127.0.0.1", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def _say(lines: List[str], rank: int, text: str) -> None:
    lines.append(text)
    if rank == 0:
        print(text, flush=True)


def _lr_shape(n: int):
    return (n // 2, 2) if n % 2 == 0 and n > 1 else (n, 1)


def _sections(n: int, device: str) -> dict:
    """Sections 1-7 on this rank of the world."""
    import torch
    import torch.distributed as dist

    from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
    from parameter_server_tpu_torch.models import transformer as tfm
    from parameter_server_tpu_torch.ops import scatter
    from parameter_server_tpu_torch.parallel import mesh as mesh_lib
    from parameter_server_tpu_torch.parallel.lr_spmd import SpmdLRTrainer

    rank = dist.get_rank()
    lines: List[str] = []
    losses: Dict[str, object] = {}
    scatter.reset_launch_counts()
    mesh = mesh_lib.make_mesh(_lr_shape(n), device=device)

    # 1) PS path: row-sharded table, data-parallel batch, the sum before the push
    cfg = TableConfig(name="w", rows=1 << 12, dim=1,
                      optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.1))
    trainer = SpmdLRTrainer(cfg, mesh)
    data = SyntheticCTR(key_space=1 << 12, nnz=8, batch_size=8 * n, seed=0)
    loss = trainer.step(*data.next_batch())
    assert np.isfinite(loss), loss
    losses["ps_lr"] = loss
    _say(lines, rank, f"dryrun PS-LR OK: mesh={dict(mesh.shape)} loss={loss:.4f} "
                      f"table_shards={mesh.shape[mesh_lib.MODEL_AXIS]}")

    # 2) Transformer DP x TP: embedding rows sharded over model, TP placements
    from parameter_server_tpu_torch.learner.lm import SpmdLMTrainer

    lm_cfg = tfm.tiny_config(causal=True)
    lm = SpmdLMTrainer(lm_cfg, mesh, learning_rate=1e-3)
    tokens = np.random.default_rng(1).integers(
        0, lm_cfg.vocab_size, size=(max(2 * mesh.shape[mesh_lib.DATA_AXIS], 2), 16))
    lm_loss = lm.step_causal(tokens)
    assert np.isfinite(lm_loss), lm_loss
    losses["lm_dp_tp"] = lm_loss
    _say(lines, rank, f"dryrun LM DPxTP OK: loss={lm_loss:.4f} "
                      f"emb_shards={mesh.shape[mesh_lib.MODEL_AXIS]}")

    # 3) Sequence parallelism: ring attention over an sp mesh
    from parameter_server_tpu_torch.ops import ring_attention as ra

    sp_mesh = mesh_lib.make_mesh((n,), ("sp",), device=device)
    rng = np.random.default_rng(2)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 8 * n, 2, 16)).astype(np.float32))
               .to(mesh.device) for _ in range(3))
    out = ra.make_ring_attention(sp_mesh, sp_axis="sp", causal=True)(q, k, v)
    want = ra.local_block(ra.reference_attention(q, k, v, causal=True), sp_mesh, "sp")
    err = float((out - want).abs().max())
    assert err <= 2e-5, err
    _say(lines, rank, f"dryrun ring-attention OK: sp={n} seq={q.shape[1]}")

    # 3b) the SP trainer: ring attention inside the transformer, one step
    from parameter_server_tpu_torch.parallel.sp_lm import SpLMTrainer

    sp_cfg = tfm.tiny_config(causal=True, tie_embeddings=False)
    sp_loss = SpLMTrainer(sp_cfg, sp_mesh, learning_rate=1e-3).step(
        np.random.default_rng(6).integers(0, sp_cfg.vocab_size, size=(2, 8 * n)))
    assert np.isfinite(sp_loss), sp_loss
    losses["sp_lm"] = sp_loss
    _say(lines, rank, f"dryrun SP-LM trainer OK: seq={8 * n} loss={sp_loss:.4f}")

    # 3c) the composed long-context trainer on an (sp, model) mesh
    if n >= 4 and n % 2 == 0:
        from parameter_server_tpu_torch.parallel.sp_fsdp import SpTpLMTrainer

        sptp_mesh = mesh_lib.make_mesh((n // 2, 2), ("sp", "model"), device=device)
        sptp = SpTpLMTrainer(sp_cfg, sptp_mesh, fsdp="state", loss_chunk=8)
        sptp_loss = sptp.step(np.random.default_rng(7).integers(
            0, sp_cfg.vocab_size, size=(2, 4 * n)))
        assert np.isfinite(sptp_loss), sptp_loss
        losses["sptp"] = sptp_loss
        _say(lines, rank, f"dryrun SPxTP trainer OK: mesh=(sp={n // 2}, model=2) "
                          f"seq={4 * n} loss={sptp_loss:.4f}")
    else:
        _say(lines, rank, f"dryrun SPxTP trainer SKIPPED: needs an even n >= 4, n={n}")

    # 6) Pipeline parallelism: GPipe, then 1F1B, on the same mesh
    from parameter_server_tpu_torch.parallel.pp import PipelinedLMTrainer

    pp_n = 4 if n >= 4 else 2
    stages = min(pp_n, n)  # JAX's devices[:pp_n] holds n of them below pp_n
    pp_mesh = mesh_lib.make_mesh((n // stages, stages), ("rep", "pp"), device=device)
    pp_cfg = tfm.tiny_config(causal=True, n_layers=pp_n)
    pp_tokens = np.random.default_rng(5).integers(0, pp_cfg.vocab_size, size=(8, 16))
    pp_loss = PipelinedLMTrainer(pp_cfg, pp_mesh, n_micro=4).step(pp_tokens)
    pp_1f1b = PipelinedLMTrainer(pp_cfg, pp_mesh, n_micro=4, schedule="1f1b").step(pp_tokens)
    assert np.isfinite(pp_loss) and np.isfinite(pp_1f1b), (pp_loss, pp_1f1b)
    losses["pp"] = [pp_loss, pp_1f1b]
    _say(lines, rank, f"dryrun PP OK: stages={stages} n_micro=4 gpipe={pp_loss:.4f} "
                      f"1f1b={pp_1f1b:.4f}")

    # 5) config #5: PS-served embeddings over the Van + the body on the mesh
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.van import LoopbackVan
    from parameter_server_tpu_torch.kv.server import KVServer
    from parameter_server_tpu_torch.kv.worker import KVWorker
    from parameter_server_tpu_torch.learner import hybrid

    hy_cfg = tfm.tiny_config(causal=True, tie_embeddings=False)
    van, worker = None, None
    if mesh.index(mesh_lib.MODEL_AXIS) == 0:  # each data line's Van rank
        van = LoopbackVan()
        tables = {"emb": hybrid.embedding_table_cfg(hy_cfg)}
        for s in range(2):
            KVServer(Postoffice(f"S{s}", van), tables, s, 2, device_replies=True,
                     device=mesh.device)
        worker = KVWorker(Postoffice("W0", van), tables, 2,
                          localizers=hybrid.embedding_localizers(hy_cfg), device=mesh.device)
    try:
        tr = hybrid.HybridLMTrainer(hy_cfg, worker, mesh=mesh, max_delay=1)
        rng = np.random.default_rng(3)
        toks = [rng.integers(0, hy_cfg.vocab_size,
                             size=(2 * mesh.shape[mesh_lib.DATA_AXIS], 16)) for _ in range(2)]
        hy_loss = tr.step(toks[0], next_tokens=toks[1])
        hy_loss2 = tr.step(toks[1])
        tr.drain()
    finally:
        if van is not None:
            van.close()
    assert np.isfinite(hy_loss) and np.isfinite(hy_loss2), (hy_loss, hy_loss2)
    losses["hybrid"] = [hy_loss, hy_loss2]
    _say(lines, rank, f"dryrun hybrid OK: mesh={dict(mesh.shape)} losses="
                      f"[{hy_loss:.4f}, {hy_loss2:.4f}] (prefetched pull on step 2)")
    return {"lines": lines, "losses": losses, "launches": scatter.launch_counts(),
            "device": str(mesh.device), "backend": dist.get_backend()}


def _rank_main(rank: int, n: int, port: int, device: str, timeout: float, conn) -> None:
    try:
        from parameter_server_tpu_torch.parallel import distributed

        if device == "cpu":
            import torch

            torch.set_num_threads(1)  # the ranks share the host's cores
            distributed.initialize(f"127.0.0.1:{port}", 1, 0, cpu_devices=n, local_rank=rank,
                                   timeout=timeout)
        else:
            distributed.initialize(f"127.0.0.1:{port}", 1, 0, local_rank=rank,
                                   device="cuda", timeout=timeout)
            from parameter_server_tpu_torch.ops import _build

            _build.load_library()
        conn.send(("ok", _sections(n, device)))
    except Exception:
        conn.send(("err", f"rank {rank}: {traceback.format_exc()}"))
    finally:
        import torch.distributed as dist

        if dist.is_initialized():
            dist.destroy_process_group()


def _run_ranks(n: int, device: str, timeout: float) -> List[dict]:
    ctx = mp.get_context("spawn")
    port = _free_port()
    procs, conns = [], []
    for r in range(n):
        parent, child = ctx.Pipe()
        p = ctx.Process(target=_rank_main, args=(r, n, port, device, timeout / 2, child),
                        daemon=True)
        p.start()
        child.close()
        procs.append(p)
        conns.append(parent)
    out: List[dict] = [None] * n  # type: ignore[list-item]
    end = time.monotonic() + timeout
    try:
        for r, conn in enumerate(conns):
            left = end - time.monotonic()
            if left <= 0 or not conn.poll(left):
                raise TimeoutError(f"dryrun rank {r} gave no result in {timeout} s")
            status, value = conn.recv()
            if status != "ok":
                raise RuntimeError(value)
            out[r] = value
    finally:
        for p in procs:
            p.join(timeout=10.0)
            if p.is_alive():
                p.kill()
                p.join(timeout=5.0)
    return out


def dryrun_multichip(n_devices: int, *, device: str = "cuda", timeout: float = 600.0) -> dict:
    """One training step of each sharded path over ``n_devices`` ranks.
    Returns the printed lines, the losses, the skipped sections, the device
    each section that ran used and the scatter-kernel launches summed over
    the ranks."""
    import torch

    if device == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("dryrun_multichip(device='cuda'): no CUDA device is visible")
        if n_devices > torch.cuda.device_count():
            raise RuntimeError(f"need {n_devices} cards, have {torch.cuda.device_count()}")
    elif device != "cpu":
        raise ValueError(f"device must be cuda|cpu, got {device!r}")
    ranks = _run_ranks(n_devices, device, timeout)
    lines = list(ranks[0]["lines"])
    losses = dict(ranks[0]["losses"])
    launches = {k: sum(r["launches"][k] for r in ranks) for k in ranks[0]["launches"]}
    sections = dict.fromkeys(("ring_attention", *losses), ranks[0]["device"])
    for r in ranks[1:]:  # every global loss is the same on every rank
        for key in ("ps_lr", "lm_dp_tp", "sp_lm", "pp"):
            np.testing.assert_allclose(r["losses"][key], losses[key], rtol=1e-6)

    # 4) Multi-host runtime: the same LR job as 2 hosts, losses matched
    if n_devices >= 2 and n_devices % 2 == 0:
        from parameter_server_tpu_torch.launch_spmd import launch_spmd

        result = launch_spmd(num_procs=2, cpu_devices=n_devices // 2, steps=2, rows=1 << 10,
                             global_batch=8 * n_devices, nnz=8, mesh_data=2,
                             timeout=240.0, device="cpu")
        assert result["returncodes"] == [0, 0], result
        np.testing.assert_allclose(result["losses"][0], result["losses"][1], rtol=1e-6)
        losses["multihost"] = result["losses"][0]
        sections["multihost"] = "cpu"
        _say(lines, 0, f"dryrun multihost OK (on the CPU): 2 procs x {n_devices // 2} devices, "
                       f"losses={[round(x, 4) for x in result['losses'][0]]}")
    else:
        _say(lines, 0, f"dryrun multihost SKIPPED: needs an even n >= 2, n={n_devices}")

    # 7) the dual plane: socket servers in their own processes + a 2-host body
    if n_devices >= 4 and n_devices % 2 == 0:
        from parameter_server_tpu_torch import native
        from parameter_server_tpu_torch.launch_hybrid import launch_hybrid

        if native.load("tcpvan") is None:
            _say(lines, 0, "dryrun dual-plane SKIPPED: no native tcpvan")
        else:
            result = launch_hybrid(
                num_body=2, cpu_devices=n_devices // 2, num_servers=2, steps=2,
                vocab=256, layers=2, heads=4, d_model=32, d_ff=64, seq=16,
                global_batch=8, emb_optimizer="sgd", bsp=True, filters="full",
                run_timeout=240.0, device="cpu")
            assert result["returncodes"] == [0] * 5, result
            assert all(np.isfinite(result["losses"][p]).all() for p in (0, 1)), result
            assert all(result["wire"][p]["sent"] > 0 for p in (0, 1))
            losses["dual_plane"] = result["losses"][0]
            sections["dual_plane"] = "cpu"
            _say(lines, 0, "dryrun dual-plane OK (on the CPU): 2 TcpVan emb servers + "
                           "2-proc body, "
                           f"losses={[round(x, 4) for x in result['losses'][0]]} "
                           f"wire_sent={[result['wire'][p]['sent'] for p in (0, 1)]}B")
    else:
        _say(lines, 0, f"dryrun dual-plane SKIPPED: needs an even n >= 4, n={n_devices}")
    return {"n": n_devices, "device": device, "rank_devices": [r["device"] for r in ranks],
            "backend": ranks[0]["backend"], "lines": lines, "losses": losses,
            "skipped": [ln for ln in lines if "SKIPPED" in ln], "section_devices": sections,
            "launches": launches}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--ranks", type=int, default=None,
                   help="default: every card (device cuda) / 4 (device cpu)")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--timeout", type=float, default=600.0)
    args = p.parse_args(argv)
    n = args.ranks
    if n is None:
        import torch

        n = torch.cuda.device_count() if args.device == "cuda" else 4
    result = dryrun_multichip(n, device=args.device, timeout=args.timeout)
    print(json.dumps({k: result[k] for k in ("n", "device", "rank_devices", "backend",
                                               "losses", "skipped", "section_devices",
                                               "launches")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
