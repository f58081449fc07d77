"""Readings that set a cell's limits, for a list of seeds in one process:
the program's (sound runs), the control's (the reference in the precision
below the configuration's, in the program's place) and each fault's,
every one compared with the reference as a run compares it.  No window:
training's readings come from the set-up's checked steps.

    python3 psbench/control.py --workload <cell> --seeds 1,2,3

One JSON line a seed on stdout.  The benchmark's own runs never run this.
"""

from __future__ import annotations

import argparse
import json
import pathlib
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]


def readings(torch, cfg: dict, workload: dict, seed: int, device) -> dict:
    """The compared numbers of the program, the control and the half-batch
    fault for one seed, each against the float32 reference."""
    import importlib

    from psbench import compare

    module = importlib.import_module(f"psbench.drivers.{workload['driver']}")
    driver = module.Driver(torch, cfg, workload, seed, torch.device(device))
    t0 = time.perf_counter()
    driver.setup()
    setup_s = time.perf_counter() - t0
    prog = driver.readings
    driver.free()
    t0 = time.perf_counter()
    ref = driver.reference()
    out = {"seed": seed, "setup_s": setup_s, "reference_s": time.perf_counter() - t0,
           "program": compare.numbers(prog, ref),
           "control": compare.numbers(driver.reference(**module.Driver.CONTROL), ref),
           "half_batch": compare.numbers(driver.reference(half_batch=True), ref)}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True, help="comma-separated seeds")
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    from psbench import run

    run.set_cache_dirs()
    import torch

    spec = run.bench_spec()
    cell, cfg, workload = run.load_cell(spec, args.workload)
    run.check_card(torch, cell["chips"])
    for seed in (int(s) for s in args.seeds.split(",")):
        row = readings(torch, cfg, workload, seed, "cuda")
        print(json.dumps({"workload": args.workload, **row}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
