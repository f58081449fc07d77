"""Tracing and MFU of the PyTorch port, against the JAX package's.

The twin of ``tests/test_trace.py`` (spans, histograms, exports, KV-layer
wiring) and of the MFU and attribution cases of ``tests/test_metrics.py``
on the port's ``utils/trace.py`` and ``utils/metrics.py``, plus:

- the Chrome-trace and JSONL exports of the same recorded spans are byte
  for byte the JAX tracer's;
- ``counted_flops`` is exact (2·M·N·K per matmul, per convolution output)
  on a tiny MLP and conv net, runs on ``meta`` copies (the live parameters,
  buffers and gradients are untouched), and its ratio to the JAX package's
  ``lowered_flops`` of the same model is reported: XLA counts every op, the
  flop counter matmuls and convolutions only;
- the peak table: the H100's data-sheet figures by math mode, 0 for an
  unknown card, the nominal 1e11 on the CPU;
- ``torch_profile`` exports a trace on the CPU and raises when CUDA activity
  was asked for and the trace holds no device event;
- device time by span: a disabled tracer's span is one shared object,
  :class:`TraceClock` places ``perf_counter`` seconds on a trace's axis and
  the timeline each span there with its thread,
  and the hybrid trainer (its body's attention and MLP forward and
  backward), the dense LR steps and the prefetch wait record their spans
  every step, with losses bitwise those of the same runs untraced.
"""

import builtins
import io
import json
import pathlib
import threading
import time

import numpy as np
import pytest
import torch

from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.utils import metrics as metrics_lib
from parameter_server_tpu_torch.utils.trace import (
    NULL_TRACER,
    LatencyHistogram,
    TraceClock,
    Tracer,
    resource_usage,
)


def test_span_recording_and_histogram():
    tr = Tracer()
    for i in range(20):
        with tr.span("op", i=i):
            time.sleep(0.001)
    h = tr.histogram("op")
    assert h["count"] == 20
    assert h["p50_us"] >= 1000  # slept >= 1ms
    assert h["p99_us"] >= h["p50_us"]
    assert h["max_us"] >= h["p99_us"]
    assert tr.histogram("missing")["count"] == 0
    assert "op" in tr.summary()


def test_span_thread_safety_and_capacity():
    tr = Tracer(capacity=100)

    def worker():
        for _ in range(100):
            with tr.span("w"):
                pass

    threads = [threading.Thread(target=worker) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert len(tr.spans("w")) == 100  # bounded by capacity, no crash


def test_null_tracer_records_nothing():
    with NULL_TRACER.span("x"):
        pass
    NULL_TRACER.record("y", 0.5)
    assert NULL_TRACER.spans() == []


def test_exports(tmp_path):
    tr = Tracer()
    with tr.span("a", table="w"):
        pass
    tr.record("b", 0.002)
    chrome = tmp_path / "trace.json"
    tr.dump_chrome_trace(str(chrome))
    events = json.loads(chrome.read_text())["traceEvents"]
    assert {e["name"] for e in events} == {"a", "b"}
    assert all(e["ph"] == "X" and "dur" in e for e in events)
    assert any(e.get("args") == {"table": "w"} for e in events)

    jl = tmp_path / "trace.jsonl"
    tr.dump_jsonl(str(jl))
    rows = [json.loads(line) for line in jl.read_text().splitlines()]
    assert len(rows) == 2 and rows[1]["dur_s"] == 0.002


def test_resource_usage_fields():
    ru = resource_usage()
    assert ru["rss_mb"] > 1.0
    assert ru["cpu_user_s"] >= 0.0
    assert ru["threads"] >= 1


def test_resource_usage_non_linux_fallback(monkeypatch):
    """No /proc (macOS/Windows): a time-only dict, never an exception."""
    real_open = builtins.open

    def fake_open(path, *args, **kwargs):
        if str(path).startswith("/proc/"):
            raise OSError("no /proc on this platform")
        return real_open(path, *args, **kwargs)

    monkeypatch.setattr(builtins, "open", fake_open)
    ru = resource_usage()
    assert set(ru) == {"time"}
    assert ru["time"] > 0


# ------------------------------------------------------- LatencyHistogram


def test_latency_histogram_exact_moments_and_bounded_percentiles():
    h = LatencyHistogram()
    values = [0.0005, 0.001, 0.002, 0.004, 0.008, 0.5]
    for v in values:
        h.record(v)
    assert h.count == len(values)
    assert abs(h.sum_s - sum(values)) < 1e-12  # count/sum/max are EXACT
    assert h.max_s == 0.5
    # percentiles are bucket upper bounds: >= the true quantile, <= max,
    # within the 25% bucket growth factor
    p50 = h.percentile(0.50)
    assert 0.002 <= p50 <= 0.002 * LatencyHistogram.GROWTH
    assert h.percentile(0.99) <= h.max_s
    assert h.percentile(1.0) == h.max_s
    # negative durations clamp to bucket 0, never throw
    h.record(-1.0)
    assert h.count == len(values) + 1


def test_latency_histogram_empty_and_extremes():
    h = LatencyHistogram()
    assert h.percentile(0.99) == 0.0
    assert h.stats() == {"count": 0}
    h.record(1e-9)  # below BASE -> bucket 0
    h.record(1e9)  # beyond the last bucket -> max stays exact, but
    # percentiles saturate at the last bucket's upper edge (<= max)
    assert h.max_s == 1e9
    assert h.percentile(1.0) <= h.max_s
    last_edge = LatencyHistogram.BASE * (
        LatencyHistogram.GROWTH ** (LatencyHistogram.NBUCKETS - 1)
    )
    assert h.percentile(1.0) == last_edge  # ~27 min: the range ceiling


def test_latency_histogram_merge_equals_union():
    a, b, u = LatencyHistogram(), LatencyHistogram(), LatencyHistogram()
    for i in range(50):
        v = 1e-5 * (i + 1)
        (a if i % 2 else b).record(v)
        u.record(v)
    a.merge(b)
    assert a.counts == u.counts
    assert a.count == u.count
    assert abs(a.sum_s - u.sum_s) < 1e-12
    assert a.percentile(0.9) == u.percentile(0.9)


def test_latency_histogram_dict_round_trip():
    h = LatencyHistogram()
    for v in (1e-5, 3e-4, 0.02, 1.5):
        h.record(v)
    d = h.to_dict()
    json.dumps(d)  # heartbeat-safe
    back = LatencyHistogram.from_dict(d)
    assert back.counts == h.counts
    assert back.count == h.count
    assert back.max_s == h.max_s


def test_tracer_histogram_survives_deque_wraparound():
    """The old bounded-deque histogram silently became 'stats of the last
    capacity spans'; the LatencyHistogram backing must count everything."""
    tr = Tracer(capacity=10)
    for _ in range(100):
        tr.record("op", 0.001)
    assert len(tr.spans("op")) == 10  # timeline stays bounded...
    assert tr.histogram("op")["count"] == 100  # ...aggregates do not
    assert tr.totals()["op"] >= 0.1 - 1e-9
    digests = tr.digests()
    assert digests["op"]["count"] == 100


def test_kv_layer_traced_push_pull():
    van = LoopbackVan()
    try:
        cfgs = {
            "w": TableConfig(
                name="w", rows=500, dim=2,
                optimizer=OptimizerConfig(kind="sgd", learning_rate=1.0),
            )
        }
        server_tracer = Tracer()
        worker_tracer = Tracer()
        servers = [
            KVServer(
                Postoffice(f"S{i}", van), cfgs, i, 2, tracer=server_tracer,
                device="cpu",
            )
            for i in range(2)
        ]
        worker = KVWorker(
            Postoffice("W0", van), cfgs, 2, min_bucket=16, tracer=worker_tracer,
            device="cpu",
        )
        keys = np.arange(40, dtype=np.uint64)
        for _ in range(3):
            worker.wait(
                worker.push("w", keys, np.ones((40, 2), np.float32)), timeout=10
            )
            worker.pull_sync("w", keys, timeout=10)
        s = worker_tracer.summary()
        assert s["kv.push"]["count"] == 3
        assert s["kv.pull.wait"]["count"] == 3
        ss = server_tracer.summary()
        # both servers share the tracer: 3 pushes+pulls x 2 servers
        assert ss["kv.server.push"]["count"] == 6
        assert ss["kv.server.pull"]["count"] == 6
        assert ss["kv.server.push"]["mean_us"] > 0
    finally:
        van.close()


# ------------------------------------------------------ exports vs the JAX tracer


def _both_tracers(capacity=100_000):
    from parameter_server_tpu.utils.trace import Tracer as JaxTracer

    mine, theirs = Tracer(capacity=capacity), JaxTracer(capacity=capacity)
    theirs._t0 = mine._t0  # one clock origin, so the offsets are the same
    return mine, theirs


def _record_seeded(tracers, seed):
    rng = np.random.default_rng(seed)
    names = ["kv.push", "kv.pull.wait", "kv.server.push", "h2d"]
    for i in range(40):
        name = names[int(rng.integers(0, len(names)))]
        dur = float(rng.exponential(1e-3))
        start = float(1000.0 + rng.uniform(0, 5))
        attrs = {"table": "w", "n": int(rng.integers(1, 100))} if i % 3 else {}
        if i % 5 == 0:
            attrs["trace"] = f"W0/kv/{i}"
        for tr in tracers:
            tr.record(name, dur, start_s=start, **attrs)


@pytest.mark.parametrize("seed", [0, 1])
def test_exports_are_byte_equal_to_the_jax_tracer(tmp_path, seed):
    mine, theirs = _both_tracers()
    _record_seeded((mine, theirs), seed)
    for fmt in ("chrome", "chrome_node", "jsonl"):
        a, b = tmp_path / f"{fmt}.port", tmp_path / f"{fmt}.jax"
        if fmt == "jsonl":
            mine.dump_jsonl(str(a))
            theirs.dump_jsonl(str(b))
        else:
            node = "S0" if fmt == "chrome_node" else None
            mine.dump_chrome_trace(str(a), process_name=node)
            theirs.dump_chrome_trace(str(b), process_name=node)
        assert a.read_bytes() == b.read_bytes(), fmt
    assert mine.summary() == theirs.summary()
    assert mine.digests() == theirs.digests()
    assert mine.totals() == theirs.totals()


def test_wrapped_deque_exports_equal_the_jax_tracer(tmp_path):
    mine, theirs = _both_tracers(capacity=7)
    _record_seeded((mine, theirs), 3)
    mine.dump_chrome_trace(str(tmp_path / "a.json"))
    theirs.dump_chrome_trace(str(tmp_path / "b.json"))
    assert (tmp_path / "a.json").read_bytes() == (tmp_path / "b.json").read_bytes()
    assert len(mine.spans()) == 7 and mine.histogram("h2d") == theirs.histogram("h2d")


# ------------------------------------------------------------------- MFU


def test_dashboard_mfu_per_iter():
    sink = io.StringIO()
    dash = metrics_lib.Dashboard(
        jsonl=sink, print_every=0, flops_per_example=1e6, peak_flops=1e12,
    )
    dash.record(1, 0.7, examples=1000)
    dash.record(2, 0.6, examples=1000)
    rows = [json.loads(line) for line in sink.getvalue().splitlines()]
    assert all("mfu_pct" in r for r in rows)
    assert all(r["mfu_pct"] > 0 for r in rows)
    assert rows[0]["mfu_pct"] <= 100.0 or rows[0]["sec"] < 0.001


def test_dashboard_auto_peak_flops_backend():
    # auto-detect fills peak_flops lazily at first MFU computation (the CPU
    # here: the nominal 1e11)
    dash = metrics_lib.Dashboard(print_every=0, flops_per_example=10.0)
    dash.record(1, 0.5, examples=10)
    assert dash.peak_flops == metrics_lib.CPU_NOMINAL_FLOPS


def test_dashboard_span_attribution():
    tracer = Tracer()
    with tracer.span("host.assemble"):
        pass
    with tracer.span("device.step"):
        pass
    with tracer.span("device.step"):
        pass
    sink = io.StringIO()
    dash = metrics_lib.Dashboard(jsonl=sink, print_every=1, tracer=tracer)
    attr = dash.attribution()
    assert set(attr) == {"host.assemble", "device.step"}
    assert all(v >= 0 for v in attr.values())
    dash.record(1, 1.0, examples=1)
    row = json.loads(sink.getvalue().splitlines()[0])
    assert "spans_s" in row and "device.step" in row["spans_s"]


def test_dashboard_no_mfu_when_unconfigured():
    sink = io.StringIO()
    dash = metrics_lib.Dashboard(jsonl=sink, print_every=0)
    dash.record(1, 0.5, examples=10)
    row = json.loads(sink.getvalue().splitlines()[0])
    assert "mfu_pct" not in row


def test_dashboard_rows_equal_the_jax_dashboard():
    """The same records through both dashboards (fixed clocks, a tracer,
    a transport with wire bytes): the same JSONL rows."""
    from parameter_server_tpu.utils import metrics as jax_metrics

    class _Wire:
        def __init__(self):
            self.n = 0

        def counters(self):
            return {"wire_bytes": self.n, "sent": self.n // 100,
                    "coalesce_frames": 2, "coalesce_msgs": 5}

    rows = {}
    for side, mod in (("port", metrics_lib), ("jax", jax_metrics)):
        tracer, _ = _both_tracers()
        tracer.record("device.step", 0.25, start_s=1.0)
        sink, wire = io.StringIO(), _Wire()
        dash = mod.Dashboard(jsonl=sink, print_every=0, flops_per_example=2e6,
                             peak_flops=1e12, tracer=tracer, transport=wire,
                             _start=100.0)
        for i in range(1, 4):
            wire.n += 4000 * i
            dash.record(i, 1.0 / i, examples=64, now=100.0 + 0.5 * i)
        rows[side] = sink.getvalue()
    assert rows["port"] == rows["jax"]


def test_unknown_card_turns_the_mfu_column_off(monkeypatch):
    monkeypatch.setattr(metrics_lib, "_auto_peak_flops", lambda *a, **k: 0.0)
    sink = io.StringIO()
    dash = metrics_lib.Dashboard(jsonl=sink, print_every=1, flops_per_example=1e6)
    dash.record(1, 0.5, examples=10)
    assert "mfu_pct" not in json.loads(sink.getvalue())
    assert dash.peak_flops == 0.0


@pytest.mark.parametrize("name, precision, want", [
    ("NVIDIA H100 80GB HBM3", "bf16", 989e12),
    ("NVIDIA H100 80GB HBM3", "fp16", 989e12),
    ("NVIDIA H100 80GB HBM3", "tf32", 495e12),
    ("NVIDIA H100 80GB HBM3", "fp32", 67e12),
    ("NVIDIA A100-SXM4-80GB", "bf16", 0.0),
    ("Some Future Card", "tf32", 0.0),
])
def test_peak_table_is_the_data_sheet_or_nothing(name, precision, want):
    assert metrics_lib.peak_flops_of(name, precision) == want


def test_peak_table_rejects_an_unknown_math_mode():
    with pytest.raises(ValueError):
        metrics_lib.peak_flops_of("NVIDIA H100 80GB HBM3", "fp8")
    with pytest.raises(ValueError):
        metrics_lib._auto_peak_flops("int4", device="cpu")


def test_mesh_peak_and_trainer_dashboard():
    assert metrics_lib.mesh_peak_flops(4) == 4 * metrics_lib.CPU_NOMINAL_FLOPS
    d = metrics_lib.trainer_dashboard(None, 2, precision="tf32")
    assert d.peak_flops == 2 * metrics_lib.CPU_NOMINAL_FLOPS and d.precision == "tf32"
    mine = metrics_lib.Dashboard(print_every=0, peak_flops=5.0)
    assert metrics_lib.trainer_dashboard(mine, 8) is mine and mine.peak_flops == 5.0


def test_float32_math_mode_follows_the_flags():
    old = (torch.get_float32_matmul_precision(), torch.backends.cudnn.allow_tf32)
    try:
        torch.set_float32_matmul_precision("highest")
        assert metrics_lib.float32_math_mode("matmul") == "fp32"
        torch.set_float32_matmul_precision("high")
        assert metrics_lib.float32_math_mode("matmul") == "tf32"
        torch.backends.cudnn.allow_tf32 = True
        assert metrics_lib.float32_math_mode("conv") == "tf32"
        torch.backends.cudnn.allow_tf32 = False
        assert metrics_lib.float32_math_mode("conv") == "fp32"
    finally:
        torch.set_float32_matmul_precision(old[0])
        torch.backends.cudnn.allow_tf32 = old[1]


def _tiny_mlp(widths=(12, 32, 16, 4)):
    torch.manual_seed(0)
    layers = []
    for a, b in zip(widths[:-1], widths[1:]):
        layers += [torch.nn.Linear(a, b), torch.nn.ReLU()]
    return torch.nn.Sequential(*layers[:-1])


def _mlp_matmul_flops(widths, batch):
    return sum(2 * batch * a * b for a, b in zip(widths[:-1], widths[1:]))


def test_counted_flops_is_exact_on_a_tiny_mlp():
    widths, batch = (12, 32, 16, 4), 7
    net = _tiny_mlp(widths)
    x = torch.randn(batch, widths[0])
    fwd = _mlp_matmul_flops(widths, batch)
    assert metrics_lib.counted_flops(lambda m, x: m(x), net, x) == fwd

    def step(m, x):
        m(x).square().mean().backward()

    # backward: a weight gradient for every layer, an input gradient for
    # every layer but the first (x needs none)
    first = 2 * batch * widths[0] * widths[1]
    assert metrics_lib.counted_flops(step, net, x) == 3 * fwd - first


def test_counted_flops_is_exact_on_a_tiny_conv_net():
    torch.manual_seed(0)
    net = torch.nn.Sequential(
        torch.nn.Conv2d(3, 8, 3, padding=1), torch.nn.BatchNorm2d(8), torch.nn.ReLU(),
        torch.nn.Conv2d(8, 4, 3, stride=2, padding=1), torch.nn.Flatten(),
        torch.nn.Linear(4 * 5 * 5, 10),
    )
    x = torch.randn(2, 3, 10, 10)
    want = (2 * 2 * 8 * 10 * 10 * 3 * 9      # conv 1: B·Cout·H·W · Cin·k·k MACs
            + 2 * 2 * 4 * 5 * 5 * 8 * 9      # conv 2, stride 2
            + 2 * 2 * 100 * 10)              # the linear head
    assert metrics_lib.counted_flops(lambda m, x: m(x), net, x) == want


def test_counted_flops_never_touches_the_live_state():
    net = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 3), torch.nn.BatchNorm2d(4),
                              torch.nn.Flatten(), torch.nn.Linear(4 * 6 * 6, 3))
    opt = torch.optim.Adam(net.parameters(), lr=0.1)
    x = torch.randn(2, 3, 8, 8)
    before = {k: v.clone() for k, v in net.state_dict().items()}

    def step(m, x):
        loss = m(x).square().mean()
        loss.backward()
        return loss

    assert metrics_lib.counted_flops(step, net, x) > 0
    after = net.state_dict()
    assert all(torch.equal(before[k], after[k]) for k in before)
    assert all(p.grad is None for p in net.parameters())
    assert opt.state_dict()["state"] == {}


def test_counted_flops_ratio_to_the_jax_lowered_flops():
    """The same MLP train step counted by both packages.  XLA's count
    includes the bias adds, activations, loss and its own elementwise
    backward; the flop counter only the matmuls — so the ratio sits below
    1.  Printed for the record (``-s``)."""
    import jax
    import jax.numpy as jnp

    from parameter_server_tpu.utils.metrics import lowered_flops

    widths, batch = (64, 256, 128, 8), 32
    net = _tiny_mlp(widths)
    x = torch.randn(batch, widths[0])
    params = [(jnp.asarray(net[i].weight.detach().numpy().T),
               jnp.asarray(net[i].bias.detach().numpy())) for i in (0, 2, 4)]

    def loss(ps, x):
        for i, (w, b) in enumerate(ps):
            x = x @ w + b
            if i < len(ps) - 1:
                x = jax.nn.relu(x)
        return jnp.mean(x ** 2)

    xla = lowered_flops(jax.jit(jax.grad(loss)), params, jnp.asarray(x.numpy()))

    def step(m, x):
        m(x).square().mean().backward()

    counted = metrics_lib.counted_flops(step, net, x)
    ratio = counted / xla
    print(f"counted_flops / lowered_flops on a {widths} MLP, batch {batch}: "
          f"{counted:.0f} / {xla:.0f} = {ratio:.4f}")
    assert counted == 3 * _mlp_matmul_flops(widths, batch) - 2 * batch * widths[0] * widths[1]
    assert 0.5 < ratio <= 1.0


def test_lm_matmul_params_drops_the_gather_tables():
    emb = torch.nn.Embedding(50, 8)
    body = torch.nn.Linear(8, 8)
    sd = {**{f"embed.{k}": v for k, v in emb.state_dict().items()},
          **{f"body.{k}": v for k, v in body.state_dict().items()}}
    assert metrics_lib.lm_matmul_params(sd, frozenset({"embed"})) == 8 * 8 + 8


# -------------------------------------------------------- the profiler hook


def test_torch_profile_exports_a_cpu_trace(tmp_path):
    from parameter_server_tpu_torch.utils.trace import torch_profile

    with torch_profile(str(tmp_path), device="cpu") as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    doc = json.loads(pathlib.Path(prof.path).read_text())
    assert any("mm" in e.get("name", "") for e in doc["traceEvents"])
    assert prof.device_events == []


def test_torch_profile_raises_when_the_card_left_no_trace(tmp_path):
    """CUDA activity asked for, none in the trace (no card here): it raises
    rather than hand back a device profile without the device."""
    from parameter_server_tpu_torch.utils.trace import torch_profile

    with pytest.raises(RuntimeError, match="no device event"):
        with torch_profile(str(tmp_path), device="cuda"):
            torch.ones(8) + 1


# ------------------------------------------------------- device time by span


def test_a_disabled_span_is_one_shared_no_op():
    off = Tracer(enabled=False)
    assert off.span("a") is off.span("b", n=1) is NULL_TRACER.span("c")
    with off.span("a"):
        with off.span("a"):  # reusable and re-entrant
            pass
    assert off.spans() == [] and off.totals() == {}


def test_the_timeline_places_each_span_with_its_thread(tmp_path):
    tr = Tracer()
    ids = {}

    def work(tag):
        ids[tag] = threading.get_ident()
        with tr.span(tag):
            pass
        tr.record(tag + ".cb", 1e-6)

    t = threading.Thread(target=work, args=("other",))
    t.start()
    t.join(timeout=10)
    assert not t.is_alive()
    work("main")
    want = {"other": ids["other"], "other.cb": ids["other"],
            "main": ids["main"], "main.cb": ids["main"]}
    assert {s[0]: s[3] for s in tr.spans()} == want
    placed = tr.timeline(TraceClock(tr._t0, 0.0))
    assert {name: tid for name, _s, _e, tid in placed} == want
    for (name, start, dur, _tid, _a), (pname, s0, s1, _n) in zip(tr.spans(), placed):
        assert pname == name
        assert s0 == pytest.approx(1e6 * start) and s1 - s0 == pytest.approx(1e6 * dur)
    # the exports are as they were
    tr.dump_jsonl(str(tmp_path / "t.jsonl"))
    rows = [json.loads(line) for line in (tmp_path / "t.jsonl").read_text().splitlines()]
    assert set(rows[0]) == {"name", "start_s", "dur_s", "tid", "attrs"}
    assert [r["tid"] for r in rows] == [s[3] for s in tr.spans()]
    tr.clear()
    assert tr.timeline(TraceClock(0.0, 0.0)) == []


def test_trace_clock_maps_on_a_synthetic_anchor():
    # a sync bracketed at perf 10.000100 / 10.000140 s, traced at 5000-5020 us
    clock = TraceClock.bracket(10.0001, 10.00014, {"ts": 5000.0, "dur": 20.0})
    assert (clock.perf_s, clock.trace_us) == pytest.approx((10.00012, 5010.0))
    assert clock(10.00012) == pytest.approx(5010.0)
    assert clock(12.0) == pytest.approx(5010.0 + 1e6 * (12.0 - 10.00012))
    assert clock(10.0) == pytest.approx(5010.0 - 120.0)


def _lm_cluster(cfg):
    from parameter_server_tpu_torch.learner import hybrid

    van = LoopbackVan()
    tables = {"emb": hybrid.embedding_table_cfg(cfg, learning_rate=0.1)}
    servers = [KVServer(Postoffice(f"S{s}", van), tables, s, 2, device_replies=True,
                        device="cpu") for s in range(2)]
    worker = KVWorker(Postoffice("W0", van), tables, 2,
                      localizers=hybrid.embedding_localizers(cfg), device="cpu")
    return van, servers, worker


def _hybrid_losses(tracer, steps=3, body=False):
    """A tiny hybrid run's losses; ``body``: ``tracer`` also set on the
    body's blocks, as a profiling harness sets it."""
    from parameter_server_tpu_torch.learner import hybrid
    from parameter_server_tpu_torch.models import transformer as tfm

    cfg = tfm.tiny_config(causal=True, tie_embeddings=False)
    van, servers, worker = _lm_cluster(cfg)
    try:
        tr = hybrid.HybridLMTrainer(cfg, worker, learning_rate=1e-2, max_delay=1, seed=0,
                                    tracer=tracer, device="cpu")
        if body:
            for block in tr.body.modules():
                if isinstance(block, tfm.Block):
                    block.tracer = tracer
        rng = np.random.default_rng(4)
        batches = [rng.integers(0, cfg.vocab_size, size=(2, 16)) for _ in range(steps + 1)]
        losses = [tr.step(batches[i], next_tokens=batches[i + 1]) for i in range(steps)]
        tr.drain()
        return losses, cfg
    finally:
        van.close()


HYBRID_SPANS = ("hybrid.pull_wait", "hybrid.forward", "hybrid.backward", "hybrid.optimizer",
                "hybrid.push", "hybrid.inflight_wait", "hybrid.loss_sync")


def test_hybrid_records_its_phases_every_step_and_trains_as_untraced():
    phases_only = Tracer()
    _hybrid_losses(phases_only)
    # the trainer's tracer leaves the body's blocks untraced
    assert not {"tfm.attention", "tfm.mlp"} & set(phases_only.totals())
    tracer = Tracer()
    traced, cfg = _hybrid_losses(tracer, body=True)
    plain, _ = _hybrid_losses(None)
    assert traced == plain  # bitwise: the markers are identities
    counts = {k: v["count"] for k, v in tracer.summary().items()}
    for name in HYBRID_SPANS:
        assert counts[name] == 3, name
    assert counts["hybrid.pull"] == 3 + 1  # each step's prefetch, and the first pull
    assert "hybrid.body_dispatch" not in counts
    # each layer's attention and MLP: once forward, once backward, a step
    assert counts["tfm.attention"] == counts["tfm.mlp"] == 3 * 2 * cfg.n_layers
    phases = {name: [(s[1], s[1] + s[2]) for s in tracer.spans(name)]
              for name in ("hybrid.forward", "hybrid.backward")}

    def within(name, phase):
        return sum(any(a <= s[1] and s[1] + s[2] <= b for a, b in phases[phase])
                   for s in tracer.spans(name))

    for name in ("tfm.attention", "tfm.mlp"):
        assert within(name, "hybrid.forward") == within(name, "hybrid.backward") \
            == 3 * cfg.n_layers


def _traced_body(cfg, tracer):
    """A tiny body with ``tracer`` set on its blocks (None: left unset)."""
    from parameter_server_tpu_torch.models import transformer as tfm

    body = tfm.TransformerBody(cfg, device="cpu", generator=tfm.make_generator("cpu", 0))
    for block in body.modules():
        if isinstance(block, tfm.Block) and tracer is not None:
            block.tracer = tracer
    return body


def test_the_body_marks_its_backward_on_the_thread_that_runs_it():
    """The forward on this thread, the backward on another: the backward's
    ``tfm.attention`` / ``tfm.mlp`` carry the other thread's id."""
    from parameter_server_tpu_torch.models import transformer as tfm

    cfg = tfm.tiny_config(causal=True, tie_embeddings=False)
    tracer = Tracer()
    body = _traced_body(cfg, tracer)
    x = torch.randn(2, 8, cfg.d_model, requires_grad=True)
    loss = body(x).square().mean()
    here = threading.get_ident()
    there = {}

    def backward():
        there["id"] = threading.get_ident()
        loss.backward()

    t = threading.Thread(target=backward)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and x.grad is not None
    placed = tracer.timeline(TraceClock(0.0, 0.0))
    for name in ("tfm.attention", "tfm.mlp"):
        tids = sorted(tid == there["id"] for n, _s, _e, tid in placed if n == name)
        assert tids == [False] * cfg.n_layers + [True] * cfg.n_layers, name
        assert all(tid in (here, there["id"]) for n, _s, _e, tid in placed if n == name)


def test_an_untraced_body_adds_no_marker_to_the_graph():
    from parameter_server_tpu_torch.models import transformer as tfm

    cfg = tfm.tiny_config(causal=True, tie_embeddings=False)
    graphs = []
    for tracer in (None, NULL_TRACER, Tracer()):
        body = _traced_body(cfg, tracer)
        out = body(torch.randn(1, 4, cfg.d_model, requires_grad=True))
        seen, stack = set(), [out.grad_fn]
        while stack:
            fn = stack.pop()
            if fn is None or fn in seen:
                continue
            seen.add(fn)
            stack.extend(f for f, _ in fn.next_functions)
        graphs.append(sum(type(fn).__name__ == "_BackwardSpanBackward" for fn in seen))
        if tracer is None:  # the class default: the block holds no tracer
            assert "tracer" not in vars(body.layer_0)
    assert graphs == [0, 0, 4 * cfg.n_layers]


def _lr_losses(tracer, blocks=2):
    from parameter_server_tpu_torch.learner.sgd import LocalLRTrainer

    table = TableConfig(name="w", rows=1024, dim=1,
                        optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.05))
    tr = LocalLRTrainer(table, mode="dense", device_hash=True, tracer=tracer, device="cpu")
    rng = np.random.default_rng(2)
    out = []
    for _ in range(blocks):
        keys = rng.integers(0, 2**32 - 1, size=(4, 32, 5), dtype=np.uint64).astype(np.uint32)
        labels = rng.integers(0, 2, size=(4, 32)).astype(np.float32)
        out.append(tr.step_block(keys, labels))
    out.append(tr.step_async(keys[0], labels[0])[None])
    return torch.cat(out), tr


def test_dense_lr_steps_record_their_phases_and_train_as_untraced():
    tracer = Tracer()
    traced, tr = _lr_losses(tracer)
    plain, plain_tr = _lr_losses(None)
    assert torch.equal(traced, plain)
    assert torch.equal(tr.table.value, plain_tr.table.value)
    counts = {k: v["count"] for k, v in tracer.summary().items()}
    # 2 blocks of 4 steps, then one step alone
    assert counts == {"lr.hash": 2, "lr.forward": 9, "lr.segment_sum": 9, "lr.apply": 9}


def test_the_prefetch_wait_is_a_span_beside_its_counter():
    from parameter_server_tpu_torch.data.prefetch import PrefetchPipeline

    def slow(i):
        time.sleep(0.02)
        return (np.full(4, i, np.int32),)

    tracer = Tracer()
    with PrefetchPipeline(slow, depth=1, limit=4, device="cpu", tracer=tracer) as pipe:
        got = [int(b[0][0]) for b in pipe]
        counters = pipe.counters()
    assert got == [0, 1, 2, 3]
    waits = tracer.spans("prefetch.wait")
    assert len(waits) == counters["prefetch_stalls"] > 0
    assert sum(s[2] for s in waits) <= counters["prefetch_stall_s"] + 1e-3
    assert len(tracer.spans("prefetch.stage")) >= 4
