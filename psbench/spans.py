"""Device time by program span: each operation of a traced stretch given to
the span of the port's ``Tracer`` (``utils/trace.py``) that launched it.

    python3 psbench/spans.py --workload <cell> --seed <n> --seconds <s>

runs one cell of ``BENCHMARK.json`` as ``run.py --trace 1`` does, with the
tracer handed to every part of the program that takes one (the drivers
build the PS servers, the worker, the LR trainer and the prefetch pipeline
without it), and prints one JSON line: the window's rate with every span
on, the traced stretch's device time by span, its idle gaps named by the
span open on the step's thread, the clock check, and the per-layer
readings :data:`METRICS` defines.

Attribution (:func:`reduce`): the stretch's chrome-trace complete events
and the tracer's spans on the trace's time axis (a ``TraceClock`` from the
tightest of the bracketed device syncs that open the stretch), each on the
trace's id of its thread (:func:`on_trace_threads`).  A kernel, copy or
memset goes to the innermost span open, when the runtime call that
launched it began, on the thread that made that call (the call and the
operation share the trace's ``correlation``); where that thread had none
open, to the innermost span then open on the step's thread (so autograd's
device thread outside the attention and MLP markers falls to
``hybrid.backward``); else to :data:`NONE`.  A launch from a thread that no
span names goes to :data:`UNKNOWN`, whoever's spans were open then.  The
busy time, the stretch and the device operations are
``run.reduce_trace``'s, unchanged.
"""

from __future__ import annotations

import argparse
import bisect
import collections
import importlib
import itertools
import json
import os
import pathlib
import sys
import tempfile
import threading
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

from psbench import run  # noqa: E402

#: where an operation goes when no span was open at its launch
NONE = "(none)"
#: where an operation goes when its launching thread is none that a span names
UNKNOWN = "(unknown thread)"
#: trace categories of the host's CUDA calls (the launches)
RUNTIME = ("cuda_runtime", "cuda_driver")
#: per-layer readings: name -> (the driver whose cells report it, the spans
#: whose device time it adds up), in ms a training step
METRICS = {
    "lr_segment_sum_ms.examples": ("lr_local", ("lr.segment_sum",)),
    "lr_apply_ms.examples": ("lr_local", ("lr.apply",)),
    "attention_ms.tokens": ("hybrid", ("tfm.attention",)),
    "mlp_ms.tokens": ("hybrid", ("tfm.mlp",)),
    "optimizer_ms.tokens": ("hybrid", ("hybrid.optimizer",)),
    "ps_device_ms.tokens": ("hybrid", ("kv.server.pull", "kv.server.push")),
}
#: the clock check: a placed span ends this close to the sync it closes
SYNC_SLACK_US = 50.0
#: device syncs bracketed as the stretch opens (the tightest places the
#: spans), and each kind of the clock check's spans as it closes
ANCHORS = 8


class _OpenSpans:
    """One thread's spans, for the innermost one open at a time: for spans
    nested as a thread's spans are, the latest-starting span still open."""

    def __init__(self, spans: list) -> None:
        # at one start the outer span first, so the inner one is found
        self.spans = sorted(spans, key=lambda s: (s[0], -s[1]))
        self.starts = [s[0] for s in self.spans]
        self.reach = list(itertools.accumulate((s[1] for s in self.spans), max))

    def at(self, t: float):
        j = bisect.bisect_right(self.starts, t) - 1
        while j >= 0 and self.reach[j] >= t:
            if self.spans[j][1] >= t:
                return self.spans[j][2]
            j -= 1
        return None


def trace_tid(ident: int) -> int:
    """The trace's id of a thread that ``threading.get_ident`` (its
    ``pthread_self``) names: the ident's low 32 bits read as a signed
    integer, its sign dropped (torch 2.11's profiler, 16 of 16 threads)."""
    low = ident & 0xFFFF_FFFF
    return low if low < 1 << 31 else (1 << 32) - low


def on_trace_threads(placed: list, step_ident: int, step_tid: int) -> list:
    """Placed spans (name, start us, end us, thread ident) on the trace's
    ids of their threads: the step's thread is ``step_tid``, read from a
    device sync it made; any other is its :func:`trace_tid`."""
    return [(name, start, end, step_tid if ident == step_ident else trace_tid(ident))
            for name, start, end, ident in placed]


def _threads(placed: list) -> dict:
    """Trace thread id -> its :class:`_OpenSpans`, from placed spans (name,
    start us, end us, thread id)."""
    by_tid: dict = {}
    for name, start, end, tid in placed:
        by_tid.setdefault(int(tid), []).append((start, end, name))
    return {tid: _OpenSpans(spans) for tid, spans in by_tid.items()}


def _tid(e: dict):
    try:
        return int(e.get("tid"))
    except (TypeError, ValueError):
        return None


def window(events: list, wall: float) -> tuple:
    """The stretch ``(w0, w1)`` in trace us, as ``run.reduce_trace`` takes
    it, and the device operations sorted by start."""
    syncs = sorted(e["ts"] + e["dur"] for e in events
                   if e.get("cat") == "cuda_runtime" and e["name"] == "cudaDeviceSynchronize")
    on_device = sorted((e for e in events if e.get("cat") in run.DEVICE_OPS),
                       key=lambda e: e["ts"])
    if len(syncs) >= 2:
        return (syncs[0], syncs[-1]), on_device
    w0 = min((e["ts"] for e in on_device), default=0.0)
    return (w0, w0 + wall * 1e6), on_device


def gaps(events: list, wall: float) -> list:
    """The stretch's idle gaps ``(start, end, name)``, named as
    ``run.reduce_trace`` names them: by the CUDA call the host was in at
    the gap's midpoint, else by the operation that ended the gap."""
    (w0, w1), on_device = window(events, wall)
    busy = run._union([(max(e["ts"], w0), min(e["ts"] + e["dur"], w1)) for e in on_device
                       if e["ts"] + e["dur"] > w0 and e["ts"] < w1])
    calls = sorted((e for e in events if e.get("cat") in run.HOST_OPS), key=lambda e: e["ts"])
    call_starts = [e["ts"] for e in calls]
    reach = list(itertools.accumulate((e["ts"] + e["dur"] for e in calls), max))
    op_starts = [e["ts"] for e in on_device]
    edges = [w0] + [x for iv in busy for x in iv] + [w1]
    out = []
    for start, end in zip(edges[0::2], edges[1::2]):
        if end <= start:
            continue
        mid = (start + end) / 2
        name = None
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
        out.append((start, end, name))
    return out


def by_span(events: list, wall: float, placed: list, step_tid: int) -> tuple:
    """Device seconds by span name over the stretch (each operation
    clipped to it), and the count of operations whose launch the trace
    does not hold (they go to :data:`NONE`).  ``placed``: spans on the
    trace's thread ids (:func:`on_trace_threads`); a launch from a thread
    no span has goes to :data:`UNKNOWN`: its thread may be one whose id was
    not matched, and another thread's span open then says nothing of it."""
    (w0, w1), on_device = window(events, wall)
    launches = {e["args"]["correlation"]: e for e in events
                if e.get("cat") in RUNTIME and "correlation" in e.get("args", {})}
    threads = _threads(placed)
    step = threads.get(step_tid)
    out: dict = {}
    unmatched = 0
    for e in on_device:
        dur = min(e["ts"] + e["dur"], w1) - max(e["ts"], w0)
        if dur <= 0:
            continue
        launch = launches.get(e.get("args", {}).get("correlation"))
        name = None
        if launch is None:
            unmatched += 1
        elif _tid(launch) not in threads:
            name = UNKNOWN
        else:
            name = threads[_tid(launch)].at(launch["ts"])
            if name is None and step is not None:
                name = step.at(launch["ts"])
        key = name or NONE
        out[key] = out.get(key, 0.0) + dur / 1e6
    return out, unmatched


def reduce(events: list, wall: float, placed: list, step_tid: int) -> dict:
    """``run.reduce_trace``'s result with the device time by span
    (``by_span``, seconds, largest first) and each idle gap's name prefixed
    by the innermost span open on the step's thread at its midpoint (``<span>
    | <name>``; a gap outside every span keeps its name)."""
    out = run.reduce_trace(events, wall)
    spans, unmatched = by_span(events, wall, placed, step_tid)
    step = _threads(placed).get(step_tid)
    named: dict = {}
    for start, end, name in gaps(events, wall):
        span = step.at((start + end) / 2) if step is not None else None
        key = f"{span} | {name}" if span else name
        named[key] = named.get(key, 0.0) + (end - start) / 1e6
    out["breakdown"]["idle_gaps"] = [[k, v] for k, v in
                                     sorted(named.items(), key=lambda kv: -kv[1])[:10]]
    out["by_span"] = dict(sorted(spans.items(), key=lambda kv: -kv[1]))
    out["unlaunched_ops"] = unmatched
    return out


def read(record: dict, names) -> float | None:
    """Device ms a training step under spans ``names`` over the traced
    stretch (an LR driver step is a block of ``traffic.block`` steps), or
    None where the record has no device time by span."""
    trace = record.get("trace") or {}
    if "by_span" not in trace or not trace.get("steps"):
        return None
    steps = trace["steps"] * record["workload"]["traffic"].get("block", 1)
    return 1e3 * sum(trace["by_span"].get(n, 0.0) for n in names) / steps


# -- the stretch on the card -----------------------------------------------------


def connect(driver, tracer) -> None:
    """Hand ``tracer`` to the parts of a driver's program that take one:
    the PS servers, the worker and the body's blocks (hybrid; its trainer
    has it from the driver), the LR trainer and the prefetch pipeline."""
    from parameter_server_tpu_torch.models.transformer import Block

    for srv in getattr(driver, "servers", []):
        srv.tracer = tracer
    trainer = driver.trainer
    trainer.tracer = tracer
    if getattr(trainer, "worker", None) is not None:
        trainer.worker.tracer = tracer
    if getattr(trainer, "body", None) is not None:
        for block in trainer.body.modules():
            if isinstance(block, Block):
                block.tracer = tracer
    if hasattr(driver, "pipeline"):
        driver.pipeline.tracer = tracer


def _syncs(events: list, tid=None) -> list:
    """The device syncs of the trace (of thread ``tid``), in order."""
    return sorted((e for e in events if e.get("cat") == "cuda_runtime"
                   and e["name"] == "cudaDeviceSynchronize"
                   and (tid is None or _tid(e) == tid)), key=lambda e: e["ts"])


def _tightest(brackets: list, syncs: list):
    """The clock of the bracketed sync whose perf_counter readings lie
    closest around its trace event (another thread holding the
    interpreter's lock can delay the reading after a call), and its error
    bound in us."""
    from parameter_server_tpu_torch.utils.trace import TraceClock

    err, (a, b), e = min((0.5 * (1e6 * (b - a) - e["dur"]), (a, b), e)
                         for (a, b), e in zip(brackets, syncs))
    return TraceClock.bracket(a, b, e), err


def clock_check(events: list, placed: list, tid: int) -> dict:
    """The :data:`ANCHORS` spans ``clock.launch`` (each around one kernel
    launch) and ``clock.sync`` (each around one device sync) that end the
    stretch, ``placed``, against their runtime events on the step's thread
    ``tid``: every launch lies inside its span, and a span ends within
    :data:`SYNC_SLACK_US` of the end of the sync it closes around (the
    closest of them: a span can only end late, when another thread holds
    the interpreter's lock as the sync returns)."""
    spans = {n: [(s0, s1) for name, s0, s1, _ in placed if name == n]
             for n in ("clock.launch", "clock.sync")}
    syncs = _syncs(events, tid)[-ANCHORS:]
    launches = sorted((e for e in events if e.get("cat") in RUNTIME and _tid(e) == tid
                       and "Launch" in e["name"] and e["ts"] < syncs[0]["ts"]),
                      key=lambda e: e["ts"])[-ANCHORS:]
    margins = [min(e["ts"] - s0, s1 - e["ts"] - e["dur"])
               for (s0, s1), e in zip(spans["clock.launch"], launches)]
    gaps = sorted(s1 - (e["ts"] + e["dur"]) for (_s0, s1), e in zip(spans["clock.sync"], syncs))
    return {"launch_margin_us": min(margins), "launches_inside": sum(m >= 0 for m in margins),
            "launches": len(margins), "sync_end_gap_us": gaps,
            "sync_end_ok": min(abs(g) for g in gaps) <= SYNC_SLACK_US}


def stretch(torch, driver, tracer, steps: int, device) -> dict:
    """``steps`` driver steps under ``torch.profiler`` (CUDA activity only,
    after a one-step session that starts it, as ``run.traced_stretch``
    runs them), the tracer on: ``reduce``'s result, the clock and its
    check.  The stretch opens with :data:`ANCHORS` bracketed device syncs,
    the tightest of which places the spans, and closes with the check's
    spans, seconds later."""
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CUDA]
    with profile(activities=activities):
        driver.step()
        driver.sync()
        torch.cuda.synchronize(device)
    tracer.clear()
    marker = torch.zeros((), device=device)
    with profile(activities=activities) as prof:
        opening = []
        for _ in range(ANCHORS):
            a = time.perf_counter()
            torch.cuda.synchronize(device)
            opening.append((a, time.perf_counter()))
        t0 = time.perf_counter()
        for _ in range(steps):
            driver.step()
        driver.sync()
        for _ in range(ANCHORS):
            with tracer.span("clock.launch"):
                marker.add_(1)
        for _ in range(ANCHORS):
            with tracer.span("clock.sync"):
                torch.cuda.synchronize(device)
        wall = time.perf_counter() - t0
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = [e for e in json.load(f)["traceEvents"] if e.get("ph") == "X"]
    # only this thread syncs the device: the first sync is the stretch's
    tid = _tid(_syncs(events)[0])
    clock, err = _tightest(opening, _syncs(events, tid)[:ANCHORS])
    launching = collections.Counter(_tid(e) for e in events if e.get("cat") in RUNTIME
                                    and "Launch" in e["name"])
    placed = on_trace_threads(tracer.timeline(clock), threading.get_ident(), tid)
    spanned = {p[3] for p in placed}
    out = reduce(events, wall, placed, tid)
    out.update(host_s=wall, steps=steps,
               clock={"anchor_error_us": err, **clock_check(events, placed, tid)},
               launch_threads={str(t): [n, "step" if t == tid else t in spanned]
                               for t, n in launching.items()})
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    args = ap.parse_args(argv)
    run.set_cache_dirs()
    import torch

    from parameter_server_tpu_torch.utils.trace import Tracer
    from psbench.traffic import seed_of

    spec = run.bench_spec()
    cell, cfg, workload = run.load_cell(spec, args.workload)
    try:
        run.check_card(torch, cell["chips"])
    except run.NoCard as e:
        print(f"psbench: {e}", file=sys.stderr)
        return 2
    device = torch.device("cuda")
    torch.manual_seed(seed_of(args.seed, 0))
    module = importlib.import_module(f"psbench.drivers.{workload['driver']}")
    tracer = Tracer()
    driver = module.Driver(torch, cfg, workload, args.seed, device, tracer=tracer)
    try:
        driver.setup()
        driver.sync()
        connect(driver, tracer)
        driver.window_start()
        start = time.perf_counter()
        units, marks = 0, [start]
        while marks[-1] - start < args.seconds:
            units += driver.step()
            marks.append(time.perf_counter())
        driver.window_end()
        wall = time.perf_counter() - start
        steps_ms = sorted(1e3 * (b - a) for a, b in zip(marks, marks[1:]))
        traced = stretch(torch, driver, tracer, workload["trace_steps"], device)
        run._report_stretch(traced, steps_ms)
        record = {"trace": traced, "workload": workload}
        readings = {name: read(record, names) for name, (drv, names) in METRICS.items()
                    if drv == workload["driver"]}
        print(json.dumps({
            "workload": args.workload, "seed": args.seed,
            "device": torch.cuda.get_device_name(device),
            module.RATE: units / wall, "window_s": wall, "window_steps": len(steps_ms),
            "median_step_ms": steps_ms[len(steps_ms) // 2], "metrics": readings,
            "none_share": traced["by_span"].get(NONE, 0.0) / traced["busy_s"],
            "unknown_share": traced["by_span"].get(UNKNOWN, 0.0) / traced["busy_s"],
            **traced}))
    finally:
        driver.free()
    return 0


if __name__ == "__main__":
    sys.exit(main())
