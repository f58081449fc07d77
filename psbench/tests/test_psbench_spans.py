"""Device time by program span (``psbench/spans.py``) on synthetic traces:
each operation goes to the innermost span open on its launching thread,
else on the step's thread, else to ``(none)``, and one from a thread no
span names to ``(unknown thread)``; idle gaps take the step
thread's span as a prefix; what ``run.reduce_trace`` gives stays as it
was; the readings in ms a training step; and the tracer reaching every
part of a tiny cell's program."""

from __future__ import annotations

import pytest
import torch

from psbench import run, spans

STEP, SERVER, AUTOGRAD = 100, 200, 300


def ev(cat, name, ts, dur, tid=STEP, corr=None):
    e = {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "tid": tid}
    if corr is not None:
        e["args"] = {"correlation": corr}
    return e


def launched(name, at, tid, corr, ts, dur):
    """A runtime launch at ``at`` on ``tid`` and its kernel at ``ts``."""
    return [ev("cuda_runtime", "cudaLaunchKernel", at, 2, tid, corr),
            ev("kernel", name, ts, dur, 7, corr)]


#: spans on the trace's axis: (name, start us, end us, OS thread id)
PLACED = [("hybrid.backward", 100, 600, STEP), ("tfm.mlp", 200, 300, STEP),
          ("tfm.attention", 200, 250, STEP),  # same start as its parent
          ("kv.server.pull", 400, 500, SERVER)]

EVENTS = ([ev("cuda_runtime", "cudaDeviceSynchronize", 0, 10),
           ev("cuda_runtime", "cudaDeviceSynchronize", 1000, 10)]
          + launched("inner", 220, STEP, 1, 230, 20)        # tfm.attention
          + launched("nested", 260, STEP, 2, 260, 10)       # tfm.mlp
          + launched("outer", 150, STEP, 3, 300, 30)        # hybrid.backward
          + launched("gather", 450, SERVER, 4, 455, 40)     # kv.server.pull
          + launched("grad", 240, AUTOGRAD, 5, 520, 10)     # no spans: unknown
          + launched("late", 550, SERVER, 6, 560, 10)       # server idle: the step's
          + launched("after", 700, STEP, 7, 700, 50)        # nothing open
          + [ev("kernel", "orphan", 800, 20, 7, 8),         # its launch not traced
             ev("cuda_runtime", "cudaStreamSynchronize", 580, 100)])


def test_each_operation_goes_to_the_innermost_span_of_its_launch():
    got, unmatched = spans.by_span(EVENTS, 1.0, PLACED, STEP)
    assert got == pytest.approx({"tfm.attention": 20e-6, "tfm.mlp": 10e-6,
                                 "hybrid.backward": 30e-6 + 10e-6, "kv.server.pull": 40e-6,
                                 spans.UNKNOWN: 10e-6, spans.NONE: 50e-6 + 20e-6})
    assert unmatched == 1


def test_spans_go_to_the_trace_ids_of_their_threads():
    step_ident, other_ident, high_ident = 0x7F16_CCD2_B300, 0x7F13_5F1F_F6C0, 0x7F13_955F_F6C0
    placed = [("a", 1, 2, step_ident), ("b", 3, 4, other_ident), ("c", 5, 6, high_ident)]
    # the step's thread by its sync; any other by its ident's low 32 bits,
    # their sign dropped (0x955F_F6C0 is -0x6AA0_0940 as a signed integer)
    assert spans.on_trace_threads(placed, step_ident, 858606848) == [
        ("a", 1, 2, 858606848), ("b", 3, 4, 0x5F1F_F6C0), ("c", 5, 6, 0x6AA0_0940)]


def test_launches_of_unknown_threads_take_no_other_threads_span():
    """Two threads that no span names, each launching while the other's
    spans and the step's are open: neither launch goes to a span."""
    placed = PLACED + [("kv.server.push", 690, 800, SERVER + 1),
                       ("tfm.mlp", 650, 760, AUTOGRAD + 1)]
    events = (EVENTS + launched("apply", 700, 998, 9, 900, 5)
              + launched("gemm", 720, 999, 10, 910, 7))
    got, _ = spans.by_span(events, 1.0, placed, STEP)
    assert got[spans.UNKNOWN] == pytest.approx(10e-6 + 5e-6 + 7e-6)
    assert "kv.server.push" not in got
    assert got["tfm.mlp"] == pytest.approx(10e-6)
    # a launch on a known thread outside its spans still falls to the step's
    assert got[spans.NONE] == pytest.approx(50e-6 + 20e-6)


def test_without_spans_no_operation_goes_to_a_span():
    got, _ = spans.by_span(EVENTS, 1.0, [], STEP)
    assert got == pytest.approx({spans.UNKNOWN: 190e-6 - 20e-6, spans.NONE: 20e-6})


def test_reduce_keeps_the_reduction_and_prefixes_the_gaps():
    plain = run.reduce_trace(EVENTS, 1.0)
    got = spans.reduce(EVENTS, 1.0, PLACED, STEP)
    for key in ("busy_s", "window_s"):
        assert got[key] == plain[key]
    assert got["breakdown"]["device_ops"] == plain["breakdown"]["device_ops"]
    assert set(got["breakdown"]) == set(plain["breakdown"])
    gaps = dict(got["breakdown"]["idle_gaps"])
    # a gap outside every span keeps its name; one inside takes the
    # innermost span's
    assert gaps["cudaStreamSynchronize"] == pytest.approx(130e-6)
    assert gaps["host code, before orphan"] == pytest.approx(50e-6)
    assert gaps["hybrid.backward | host code, before inner"] == pytest.approx(220e-6)
    assert gaps["hybrid.backward | host code, before gather"] == pytest.approx(125e-6)
    assert gaps["tfm.mlp | host code, before nested"] == pytest.approx(10e-6)
    stripped: dict = {}
    for name, sec in gaps.items():
        key = name.split(" | ")[-1]
        stripped[key] = stripped.get(key, 0.0) + sec
    assert stripped == pytest.approx(dict(plain["breakdown"]["idle_gaps"]))
    assert list(got["by_span"]) == sorted(got["by_span"], key=lambda k: -got["by_span"][k])
    assert got["unlaunched_ops"] == 1


def test_gaps_are_named_as_the_reduction_names_them():
    named: dict = {}
    for start, end, name in spans.gaps(EVENTS, 1.0):
        assert end > start
        named[name] = named.get(name, 0.0) + (end - start) / 1e6
    assert named == pytest.approx(dict(run.reduce_trace(EVENTS, 1.0)["breakdown"]["idle_gaps"]))


@pytest.mark.parametrize("name", sorted(spans.METRICS))
def test_readings_in_ms_a_training_step(name):
    driver, names = spans.METRICS[name]
    by_span = {n: 0.004 * (i + 1) for i, n in enumerate(names)}
    by_span.update({"other": 1.0, spans.NONE: 1.0})
    block = 32 if driver == "lr_local" else None
    traffic = {"block": block} if block else {"seq": 512}
    record = {"trace": {"steps": 8, "by_span": by_span}, "workload": {"traffic": traffic}}
    want = 1e3 * sum(by_span[n] for n in names) / (8 * (block or 1))
    assert spans.read(record, names) == pytest.approx(want)
    # a run without the device time by span reads nothing
    assert spans.read({"trace": {"steps": 8}, "workload": {"traffic": traffic}}, names) is None
    assert spans.read({"workload": {"traffic": traffic}}, names) is None


@pytest.mark.parametrize("name,want", [
    ("criteo-lr.local-b16k", {"lr.hash", "lr.forward", "lr.segment_sum", "lr.apply",
                              "prefetch.stage"}),
    ("mistral-7b-hybrid.s512-b8", {"hybrid.pull", "hybrid.pull_wait", "hybrid.forward",
                                   "hybrid.backward", "hybrid.optimizer", "hybrid.push",
                                   "hybrid.inflight_wait", "hybrid.loss_sync", "tfm.attention",
                                   "tfm.mlp", "kv.server.pull", "kv.server.push", "kv.push"}),
])
def test_connect_reaches_every_traced_part(tiny, name, want):
    """A tiny cell's driver on the CPU, its tracer handed on by ``connect``:
    a window step records the spans of every layer."""
    from parameter_server_tpu_torch.utils.trace import Tracer

    _spec, _cell, cfg, workload = tiny(name)
    module = __import__(f"psbench.drivers.{workload['driver']}", fromlist=["Driver"])
    tracer = Tracer()
    driver = module.Driver(torch, cfg, workload, 5, "cpu", tracer=tracer)
    try:
        driver.setup()
        spans.connect(driver, tracer)
        driver.window_start()
        tracer.clear()
        for _ in range(2):
            driver.step()
        driver.sync()
        assert want <= set(tracer.totals())
    finally:
        driver.free()
