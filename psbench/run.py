"""Run one benchmark cell once and print its result as the last line.

    python3 psbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

The cell is an entry of ``BENCHMARK.json``'s ``workloads``; everything it
needs is found by name: its configuration (the entry's ``file``), its
workload file ``psbench/workloads/<cell>.json`` (the driver and the traffic),
the driver ``psbench/drivers/<driver>.py`` and, with ``--trace 1``, a reader
``psbench/layer_metrics/<metric>.py`` for each per-layer metric of the
cell.  The run:

1. refuses to run without as many CUDA cards as the cell asks for;
2. set-up: the driver builds the program and its inputs from the seed and
   drives its first steps, which warm up every shape the window uses and
   give the readings the reference is held to (``setup_s`` runs from the
   process start to the first timed step);
3. the window: driver steps for ``--seconds``, closed by a device sync;
   ``--trace 0`` reports the cell's end-to-end metrics, ``--trace 1`` its
   per-layer metrics, with a ``torch.profiler`` stretch of CUDA activity
   after the window for the device's busy time and the breakdown;
4. the program's state is freed, the reference follows the checked steps
   and each compared number is printed beside its limit (stderr's last
   lines, and the result's last key);
5. refuses to print a result if JAX, flax or the JAX package was loaded.
"""

from __future__ import annotations

import time

_T0 = time.perf_counter()

import argparse  # noqa: E402
import bisect  # noqa: E402
import importlib  # noqa: E402
import importlib.util  # noqa: E402
import itertools  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parents[1]
BENCH = pathlib.Path(__file__).resolve().parent
#: top-level module names no run may load (compared whole: the port's name
#: begins with the JAX package's)
FORBIDDEN = ("jax", "jaxlib", "flax", "parameter_server_tpu")
#: trace categories of operations on the device, and of the host's calls
DEVICE_OPS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_OPS = ("cpu_op", "cuda_runtime", "cuda_driver")
#: the traced stretch's time a step may differ from the window's median by
#: this share before the run flags it (device-only tracing adds ~1-1.5%)
STRETCH_SLACK = 0.02
#: caches of the program and its libraries, at fixed paths in the checkout
CACHE_DIRS = {"TRITON_CACHE_DIR": "triton", "TORCH_EXTENSIONS_DIR": "torch_extensions",
              "CUDA_CACHE_PATH": "cuda"}


class NoCard(RuntimeError):
    """The run found fewer CUDA cards than the cell asks for."""


def bench_spec() -> dict:
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def load_cell(spec: dict, name: str):
    """(cell entry, configuration, workload file) of cell ``name``."""
    cells = {w["name"]: w for w in spec["workloads"]}
    if name not in cells:
        raise SystemExit(f"unknown workload {name!r}; BENCHMARK.json has {sorted(cells)}")
    cell = cells[name]
    config = next(c for c in spec["configs"] if c["name"] == cell["config"])
    cfg = json.loads((ROOT / config["file"]).read_text())
    workload = json.loads((BENCH / "workloads" / f"{name}.json").read_text())
    return cell, cfg, workload


def per_layer_metrics(spec: dict, cell: dict) -> list:
    """The per-layer metrics this cell reports: those whose ``workloads``
    list it (every per-layer entry names its cells)."""
    return [m for m in spec["per_layer"] if cell["name"] in m["workloads"]]


def end_to_end_metrics(spec: dict, cell: dict) -> list:
    return [m["name"] for m in spec["end_to_end"]
            if "workloads" not in m or cell["name"] in m["workloads"]]


def reader(metric: str):
    """The reader module of per-layer metric ``metric``."""
    path = BENCH / "layer_metrics" / f"{metric}.py"
    mod_spec = importlib.util.spec_from_file_location(f"psbench_layer_{metric}", path)
    module = importlib.util.module_from_spec(mod_spec)
    mod_spec.loader.exec_module(module)
    return module


def check_card(torch, chips: int) -> None:
    if not torch.cuda.is_available():
        raise NoCard("torch.cuda.is_available() is false: no CUDA card to measure on")
    if torch.cuda.device_count() < chips:
        raise NoCard(f"{torch.cuda.device_count()} CUDA cards, the cell asks for {chips}")


# -- the device trace -----------------------------------------------------------


def _union(intervals: list) -> list:
    merged = []
    for start, end in sorted(intervals):
        if merged and start <= merged[-1][1]:
            merged[-1][1] = max(merged[-1][1], end)
        else:
            merged.append([start, end])
    return merged


def traced_stretch(torch, driver, steps: int, device) -> dict:
    """``steps`` driver steps under ``torch.profiler``, after one step under
    a first profiler session that starts the tracer: the stretch's length
    (from the device sync before its first step to the one after its last),
    the union of the device's operation intervals (kernels, copies, sets)
    within it, the device operations that took most time and the idle gaps
    by the CUDA call the host was in, or else the operation that ended the
    gap.  On the card only CUDA activity (the device's operations and the
    host's CUDA calls) is traced: recording every host operation as well
    would slow the host's share of each step and read as device idle time."""
    import tempfile

    from torch.profiler import ProfilerActivity, profile

    cuda = device.type == "cuda"
    activities = [ProfilerActivity.CUDA if cuda else ProfilerActivity.CPU]
    with profile(activities=activities):
        driver.step()
        driver.sync()
    with profile(activities=activities) as prof:
        _device_sync(torch, device)
        t0 = time.perf_counter()
        for _ in range(steps):
            driver.step()
        driver.sync()
        _device_sync(torch, device)
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    return {**reduce_trace(events, wall), "host_s": wall, "steps": steps}


def reduce_trace(events: list, wall: float) -> dict:
    """Busy time, stretch length and breakdown of a traced stretch's complete
    events (chrome-trace ``X`` events, times in us): the stretch runs from
    the end of its first ``cudaDeviceSynchronize`` to the end of its last,
    or where none was traced, ``wall`` seconds from the first device
    operation."""
    syncs = sorted(e["ts"] + e["dur"] for e in events
                   if e.get("cat") == "cuda_runtime" and e["name"] == "cudaDeviceSynchronize")
    on_device = sorted((e for e in events if e.get("cat") in DEVICE_OPS), key=lambda e: e["ts"])
    if len(syncs) >= 2:
        w0, w1 = syncs[0], syncs[-1]
    else:  # no CUDA calls traced (a CPU run): the host's clock
        w0 = min((e["ts"] for e in on_device), default=0.0)
        w1 = w0 + wall * 1e6
    busy = _union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in on_device
                   if e["ts"] + e["dur"] > w0 and e["ts"] < w1])
    ops: dict = {}
    for e in on_device:
        ops[e["name"]] = ops.get(e["name"], 0.0) + e["dur"] / 1e6
    calls = sorted((e for e in events if e.get("cat") in HOST_OPS), key=lambda e: e["ts"])
    call_starts = [e["ts"] for e in calls]
    reach = list(itertools.accumulate((e["ts"] + e["dur"] for e in calls), max))
    op_starts = [e["ts"] for e in on_device]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    gaps: dict = {}
    for start, end in zip(edges[0::2], edges[1::2]):
        if end <= start:
            continue
        mid = (start + end) / 2
        name = None
        # the latest call that started by ``mid`` and is still running then
        j = bisect.bisect_right(call_starts, mid) - 1
        while j >= 0 and reach[j] >= mid:
            if calls[j]["ts"] + calls[j]["dur"] >= mid:
                name = calls[j]["name"]
                break
            j -= 1
        if name is None:
            k = bisect.bisect_left(op_starts, end - 1)
            name = "host code, before " + (on_device[k]["name"][:80] if k < len(on_device)
                                           else "the end")
        gaps[name] = gaps.get(name, 0.0) + (end - start) / 1e6
    top = lambda d: [[k, v] for k, v in sorted(d.items(), key=lambda kv: -kv[1])[:10]]  # noqa: E731
    return {"busy_s": sum(e - s for s, e in busy) / 1e6, "window_s": (w1 - w0) / 1e6,
            "breakdown": {"device_ops": top(ops), "idle_gaps": top(gaps)}}


def _device_sync(torch, device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


# -- one run --------------------------------------------------------------------


def run_cell(torch, spec: dict, cell: dict, cfg: dict, workload: dict, *, seed: int,
             seconds: float, trace: bool, device, t0: float) -> dict:
    """Set-up, window, reference and comparison of one cell on ``device``;
    returns the result object."""
    from psbench import compare
    from psbench.traffic import seed_of

    device = torch.device(device)
    torch.manual_seed(seed_of(seed, 0))
    module = importlib.import_module(f"psbench.drivers.{workload['driver']}")
    tracer = None
    if trace:
        from parameter_server_tpu_torch.utils.trace import Tracer

        tracer = Tracer()
    driver = module.Driver(torch, cfg, workload, seed, device, tracer=tracer)
    cuda = device.type == "cuda"
    freed = False
    try:
        driver.setup()
        driver.sync()
        print(f"psbench: set-up phases (s) {driver.phases}", file=sys.stderr)
        if cuda:
            torch.cuda.reset_peak_memory_stats(device)
        driver.window_start()
        start = time.perf_counter()
        setup_s = start - t0
        units, marks = 0, [start]
        while marks[-1] - start < seconds:
            units += driver.step()
            marks.append(time.perf_counter())
        counts = driver.window_end()
        wall = time.perf_counter() - start
        steps_ms = sorted(1e3 * (b - a) for a, b in zip(marks, marks[1:]))
        print(f"psbench: window {wall:.3f} s, {len(steps_ms)} driver steps, host ms a step "
              f"min {steps_ms[0]:.2f} median {steps_ms[len(steps_ms) // 2]:.2f} "
              f"max {steps_ms[-1]:.2f}", file=sys.stderr)
        peak = torch.cuda.max_memory_allocated(device) if cuda else 0
        device_info = {"platform": "gpu" if cuda else device.type,
                       "kind": torch.cuda.get_device_name(device) if cuda else "cpu",
                       "count": 1, "memory_peak_bytes": int(peak)}
        record = {"window_s": wall, **counts, "device": device_info,
                  "config": cfg, "workload": workload, "math_mode": "fp32"}
        if cuda:
            from psbench.roofline import float32_matmul_mode

            record["math_mode"] = float32_matmul_mode(torch)
        result = {"correct": False, "attempted": counts["steps"], "failed": counts["failed"]}
        if trace:
            traced = traced_stretch(torch, driver, workload["trace_steps"], device)
            record["trace"] = traced
            _report_stretch(traced, steps_ms)
            device_info.update(busy_s=traced["busy_s"], window_s=traced["window_s"])
            metrics = {}
            for m in per_layer_metrics(spec, cell):
                value = reader(m["name"]).read(record)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        else:
            e2e = end_to_end_metrics(spec, cell)
            metrics = {module.RATE: {"value": units / wall, "unit": _unit(spec, module.RATE)},
                       "setup_s": {"value": setup_s, "unit": "s"}}
            missing = set(e2e) - set(metrics)
            if missing:
                raise RuntimeError(f"the driver gives no {sorted(missing)}")
        result.update(metrics=metrics, device=device_info)
        if trace:
            result["breakdown"] = record["trace"]["breakdown"]
        prog = driver.readings
        driver.free()
        freed = True
        values = compare.numbers(prog, driver.reference())
        limits = workload["limits"]
        result["correct"] = compare.judge(values, limits)
        result["checks"] = {k: {"value": values[k], "limit": limit}
                            for k, limit in limits.items()}
        return result
    finally:
        if not freed:
            driver.free()


def _report_stretch(traced: dict, steps_ms: list) -> None:
    """Set the traced stretch beside the window on stderr: its time a step
    against the window's median step, flagged where the two differ by more
    than ``STRETCH_SLACK`` (the tracer, or a change of pace, then moves the
    idle share), and the idle share that the stretch's busy time a step
    gives against the window's median step."""
    per_step = 1e3 * traced["window_s"] / traced["steps"]
    median = steps_ms[len(steps_ms) // 2]
    slower = per_step / median - 1 if median > 0 else 0.0
    print(f"psbench: traced stretch {traced['steps']} steps, {per_step:.2f} ms a step "
          f"(host clock {1e3 * traced['host_s'] / traced['steps']:.2f}), window median "
          f"{median:.2f} ms ({steps_ms[0]:.2f}-{steps_ms[-1]:.2f}): {100 * slower:+.2f}%"
          + ("" if abs(slower) <= STRETCH_SLACK else
             "; FLAG: the traced steps' pace is not the window's, so the idle share is not"),
          file=sys.stderr)
    if median > 0:
        busy_ms = 1e3 * traced["busy_s"] / traced["steps"]
        print(f"psbench: busy {busy_ms:.2f} ms a traced step; against the window's median "
              f"step the device idles {100 * (1 - busy_ms / median):.2f}%", file=sys.stderr)


def _unit(spec: dict, name: str) -> str:
    return next(m["unit"] for m in spec["end_to_end"] if m["name"] == name)


def forbidden_modules() -> list:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def set_cache_dirs() -> None:
    """Point the library caches at fixed directories inside the checkout."""
    for var, sub in CACHE_DIRS.items():
        path = ROOT / ".psbench_cache" / sub
        path.mkdir(parents=True, exist_ok=True)
        os.environ[var] = str(path)
    os.environ["USE_FLAX"] = "0"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    set_cache_dirs()
    sys.path.insert(0, str(ROOT))
    import torch

    spec = bench_spec()
    cell, cfg, workload = load_cell(spec, args.workload)
    try:
        check_card(torch, cell["chips"])
    except NoCard as e:
        print(f"psbench: {e}", file=sys.stderr)
        return 2
    result = run_cell(torch, spec, cell, cfg, workload, seed=args.seed, seconds=args.seconds,
                      trace=bool(args.trace), device="cuda", t0=_T0)
    found = forbidden_modules()
    if found:
        print(f"psbench: the run loaded {found}", file=sys.stderr)
        return 3
    for name, check in result["checks"].items():
        print(f"{name} {check['value']!r} limit {check['limit']!r}", file=sys.stderr)
    print(json.dumps(result))
    return 0


if __name__ == "__main__":
    sys.exit(main())
