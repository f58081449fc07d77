"""psx — the port's command-line launcher.

Torch-package counterpart of ``parameter_server_tpu/cli.py``, with the same
subcommands.  Reference analogue: ``script/local.sh`` + the gflags
``main.cc`` entry point [U]: one binary, behavior selected by config::

    python -m parameter_server_tpu_torch.cli run job.json [--steps N]
    python -m parameter_server_tpu_torch.cli run --config job.json
    python -m parameter_server_tpu_torch.cli eval CKPT_ROOT --table w ...
    python -m parameter_server_tpu_torch.cli serve SHARD_DIR --port 0
    python -m parameter_server_tpu_torch.cli apps
    python -m parameter_server_tpu_torch.cli launch --workers 2 --servers 2

    python -m parameter_server_tpu_torch.cli launch-spmd
    python -m parameter_server_tpu_torch.cli launch-spmd --device cpu \
        --num-procs 2 --cpu-devices 4

    python -m parameter_server_tpu_torch.cli launch-hybrid
    python -m parameter_server_tpu_torch.cli launch-hybrid --device cpu \
        --num-body 2 --cpu-devices 4

``run``, ``launch``, ``launch-spmd`` and ``launch-hybrid`` take ``--device``
(default ``cuda``): the app, the launched cluster or the job runs on the
card unless ``--device cpu`` asks for the CPU (for the two mesh launchers,
``--cpu-devices k`` gloo ranks a host; on the card one host of every card).
``eval`` and ``serve`` are host work.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys

import numpy as np

from parameter_server_tpu_torch.core.filters import DEFAULT_SPEC


def _cmd_run(args: argparse.Namespace) -> int:
    from parameter_server_tpu_torch import app as app_lib

    if (args.config is None) == (args.config_path is None):
        raise SystemExit("psx run: give the config once, as CONFIG or --config")
    cfg = app_lib.load_config(args.config or args.config_path)
    if args.steps is not None:
        cfg = dataclasses.replace(cfg, steps=args.steps)
    if args.tail_filter is not None:
        cfg = dataclasses.replace(
            cfg,
            data=dataclasses.replace(cfg.data, tail_threshold=args.tail_filter),
        )
    run = app_lib.create(cfg, device=args.device)
    result = run()
    losses = result.pop("losses", [])
    if losses:
        result["first_loss"] = round(float(np.mean(losses[:10])), 6)
        result["final_loss"] = round(float(np.mean(losses[-10:])), 6)
    print(json.dumps({"app": cfg.app, **result}))
    return 0


def _cmd_eval(args: argparse.Namespace) -> int:
    from parameter_server_tpu_torch import evaluation
    from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
    from parameter_server_tpu_torch.utils.keys import HashLocalizer

    stream = SyntheticCTR(
        key_space=args.key_space,
        nnz=args.nnz,
        batch_size=args.batch_size,
        seed=args.seed,
    )
    batches = [stream.next_batch() for _ in range(args.batches)]
    report = evaluation.evaluate_checkpoint(
        args.ckpt_root,
        args.table,
        batches,
        step=args.step,
        model=args.model,
        localizer=(
            HashLocalizer(args.rows, hash_bits=args.hash_bits or 64)
            if args.rows
            else None
        ),
        hash_bits=args.hash_bits or None,
    )
    print(json.dumps(report))
    return 0


def _cmd_serve(args: argparse.Namespace) -> int:
    """Run the psfs shard file server (reference file.h/HDFS host role)."""
    import threading

    from parameter_server_tpu_torch.data.fs import FileServer

    srv = FileServer(
        args.root, host=args.host, port=args.port,
        advertise_host=args.advertise_host,
    ).start()
    print(json.dumps({"url": srv.url, "root": srv.root}), flush=True)
    try:
        threading.Event().wait()  # serve until interrupted
    except KeyboardInterrupt:
        srv.stop()
    return 0


def _cmd_apps(_args: argparse.Namespace) -> int:
    from parameter_server_tpu_torch import app as app_lib

    for name in app_lib.registered_apps():
        print(name)
    return 0


def _device_flag(p: argparse.ArgumentParser) -> None:
    p.add_argument(
        "--device", default="cuda",
        help="where the tables and models live (default: the card; 'cpu' "
        "runs the plain versions of the kernels on the host)",
    )


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(prog="psx", description=__doc__,
                                formatter_class=argparse.RawDescriptionHelpFormatter)
    sub = p.add_subparsers(dest="cmd", required=True)

    run = sub.add_parser("run", help="run an app from a yaml/json config")
    run.add_argument("config", nargs="?", default=None)
    run.add_argument("--config", dest="config_path", default=None,
                     help="the config file (the same as the positional CONFIG)")
    run.add_argument("--steps", type=int, default=None, help="override steps")
    run.add_argument(
        "--tail-filter", type=int, default=None, metavar="K",
        help="override data.tail_threshold: mask keys seen < K times "
        "(count-min tail filter on the input stream; 0 disables)",
    )
    _device_flag(run)
    run.set_defaults(fn=_cmd_run)

    ev = sub.add_parser("eval", help="offline eval of a saved checkpoint")
    ev.add_argument("ckpt_root")
    ev.add_argument("--table", default="w")
    ev.add_argument("--model", default="lr", choices=["lr", "fm"])
    ev.add_argument("--step", type=int, default=None)
    ev.add_argument("--rows", type=int, default=0, help="localizer capacity")
    ev.add_argument(
        "--hash-bits", type=int, default=0, choices=[0, 32, 64],
        help="hash width of the training localizer (0 = manifest/default); "
        "device-hash tables need 32",
    )
    ev.add_argument("--batches", type=int, default=8)
    ev.add_argument("--batch-size", type=int, default=1024)
    ev.add_argument("--key-space", type=int, default=1 << 22)
    ev.add_argument("--nnz", type=int, default=39)
    ev.add_argument("--seed", type=int, default=0)
    ev.set_defaults(fn=_cmd_eval)

    apps = sub.add_parser("apps", help="list registered apps")
    apps.set_defaults(fn=_cmd_apps)

    se = sub.add_parser(
        "serve",
        help="serve a shard directory over psfs:// (readers stream from it)",
    )
    se.add_argument("root")
    se.add_argument("--host", default="0.0.0.0")
    se.add_argument("--port", type=int, default=0)
    se.add_argument("--advertise-host", default="127.0.0.1")
    se.set_defaults(fn=_cmd_serve)

    la = sub.add_parser(
        "launch",
        help="spawn scheduler+servers+workers as OS processes over TcpVan",
    )
    la.add_argument("--workers", type=int, default=2)
    la.add_argument("--servers", type=int, default=2)
    la.add_argument("--steps", type=int, default=20)
    la.add_argument("--rows", type=int, default=1 << 14)
    la.add_argument("--batch-size", type=int, default=256)
    la.add_argument("--ckpt-root", default=None)
    la.add_argument(
        "--filters", default=DEFAULT_SPEC,
        help="wire filter stack on the TcpVan: 'none' to opt out, "
        "'lossless' (=key_caching+zlib, default — bit-exact wire), 'full' "
        "(adds the LOSSY int8 quantizer; explicit opt-in), or a "
        "'+'-joined subset of {key_caching, int8, zlib, noise}",
    )
    _device_flag(la)
    la.set_defaults(fn=_cmd_launch)

    sp = sub.add_parser(
        "launch-spmd",
        help="multi-host SPMD job: hosts of ranks joined in one process "
        "group and one (data, model) mesh (CPU simulation with --device cpu)",
    )
    sp.add_argument("--num-procs", type=int, default=None,
                    help="hosts (default 2 with --device cpu; on the card one "
                    "host of every card, the only layout one machine forms)")
    sp.add_argument("--cpu-devices", type=int, default=0,
                    help="gloo ranks per host with --device cpu (0 = one); "
                    "on the card a host has one rank per card")
    sp.add_argument("--steps", type=int, default=8)
    sp.add_argument("--rows", type=int, default=1 << 12)
    sp.add_argument("--global-batch", type=int, default=256)
    sp.add_argument("--mesh-data", type=int, default=None,
                    help="the mesh's data axis (default: the hosts)")
    _device_flag(sp)
    sp.set_defaults(fn=_cmd_launch_spmd)

    hy = sub.add_parser(
        "launch-hybrid",
        help="dual-plane config #5: TcpVan embedding servers in their own "
        "processes + a body on a (data, model) mesh across processes (CPU "
        "simulation with --device cpu)",
    )
    hy.add_argument("--num-body", type=int, default=None,
                    help="body hosts (default 2 with --device cpu; on the card one "
                    "host of every card)")
    hy.add_argument("--cpu-devices", type=int, default=4,
                    help="gloo ranks a body host with --device cpu")
    hy.add_argument("--num-servers", type=int, default=2)
    hy.add_argument("--steps", type=int, default=4)
    hy.add_argument("--vocab", type=int, default=256)
    hy.add_argument("--layers", type=int, default=2)
    hy.add_argument("--heads", type=int, default=4)
    hy.add_argument("--d-model", type=int, default=32)
    hy.add_argument("--d-ff", type=int, default=64)
    hy.add_argument("--seq", type=int, default=16)
    hy.add_argument("--global-batch", type=int, default=8)
    hy.add_argument("--emb-optimizer", default="adagrad")
    hy.add_argument("--bsp", action=argparse.BooleanOptionalAction, default=True)
    hy.add_argument("--max-delay", type=int, default=2)
    hy.add_argument("--filters", default=DEFAULT_SPEC)
    _device_flag(hy)
    hy.set_defaults(fn=_cmd_launch_hybrid)
    return p


def _cmd_launch_hybrid(args: argparse.Namespace) -> int:
    from parameter_server_tpu_torch.launch_hybrid import launch_hybrid

    result = launch_hybrid(
        num_body=args.num_body or (1 if args.device == "cuda" else 2),
        cpu_devices=args.cpu_devices,
        num_servers=args.num_servers,
        steps=args.steps,
        vocab=args.vocab, layers=args.layers, heads=args.heads,
        d_model=args.d_model, d_ff=args.d_ff, seq=args.seq,
        global_batch=args.global_batch,
        emb_optimizer=args.emb_optimizer,
        bsp=args.bsp, max_delay=args.max_delay,
        filters=args.filters,
        device=args.device,
    )
    print(json.dumps({
        "returncodes": result["returncodes"],
        "losses": result["losses"].get(0, []),
        "wire": result["wire"],
    }))
    return 0 if all(rc == 0 for rc in result["returncodes"]) else 1


def _cmd_launch_spmd(args: argparse.Namespace) -> int:
    from parameter_server_tpu_torch.launch_spmd import launch_spmd

    num_procs = args.num_procs or (1 if args.device == "cuda" else 2)
    result = launch_spmd(
        num_procs=num_procs,
        cpu_devices=args.cpu_devices,
        steps=args.steps,
        rows=args.rows,
        global_batch=args.global_batch,
        mesh_data=args.mesh_data or num_procs,
        device=args.device,
    )
    losses = result["losses"].get(0, [])
    print(json.dumps({
        "returncodes": result["returncodes"],
        "first_loss": losses[0] if losses else None,
        "final_loss": losses[-1] if losses else None,
    }))
    return 0 if all(rc == 0 for rc in result["returncodes"]) else 1


def _cmd_launch(args: argparse.Namespace) -> int:
    from parameter_server_tpu_torch.launch import launch

    result = launch(
        num_workers=args.workers,
        num_servers=args.servers,
        steps=args.steps,
        rows=args.rows,
        batch_size=args.batch_size,
        ckpt_root=args.ckpt_root,
        filters=args.filters,
        device=args.device,
    )
    print(json.dumps(result))
    return 0 if all(rc == 0 for rc in result["returncodes"]) else 1


def main(argv=None) -> int:
    args = build_parser().parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
