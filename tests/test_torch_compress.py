"""The port's quantized wire plane with per-key error feedback
(``core/filters.py::QuantizingFilter``, ``ops/quantize.py`` fp8,
``config.WireCompressionConfig``) against the JAX package's, on the CPU.

- **Twins of ``tests/test_compress.py``** up to
  ``test_residuals_reset_on_same_id_restart``: the bundle constants, fp8
  error bounds, zeros and range, the seeded stochastic contract and its
  bias, ``per_row`` resolution and its effect, the codec's single-push
  roundtrip and ``FLAG_COMPRESSED``, its PUSH-request-only scope, error
  feedback recovering sub-step gradients, ``quantizer_from_tables``, a
  cluster roundtrip with ``MeteredVan``'s raw bytes, plain int8 stalling
  where EF converges under chaos, int8 EF training within 0.03 of the
  uncompressed run under chaos across a live migration, and the residual
  resets on ``adopt_routing`` and on a same-id restart.  The telemetry,
  SLO and benchdiff cases wait for the observability plane.
- **Cross-package bytes**: one push sequence (EF hits, misses, a padded
  bucket, a promotion to the dense store) and one coalesced bundle give
  frames byte-identical to the JAX codec's, with the same residual norm.

Tolerances: exact for codec bytes and counters; the reference's own
quantization bounds and its 0.03 loss bound for the trajectories.
"""

import numpy as np
import pytest
import torch

from parameter_server_tpu.config import WireCompressionConfig as JaxWCC
from parameter_server_tpu.core import coalesce as jax_coalesce
from parameter_server_tpu.core import filters as jax_filters
from parameter_server_tpu.core import frame as jax_frame
from parameter_server_tpu.core import messages as jax_messages
from parameter_server_tpu_torch.config import (
    OptimizerConfig,
    TableConfig,
    WireCompressionConfig,
)
from parameter_server_tpu_torch.core import coalesce, flightrec, frame, messages
from parameter_server_tpu_torch.core import filters as filters_mod
from parameter_server_tpu_torch.core.chaos import ChaosVan
from parameter_server_tpu_torch.core.coalesce import CoalescingVan
from parameter_server_tpu_torch.core.filters import (
    FixingFloatFilter,
    QuantizingFilter,
    _resolve_per_row,
    find_quantizers,
    quantizer_from_tables,
)
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind
from parameter_server_tpu_torch.core.netmon import MeteredVan
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.resender import ReliableVan
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.data.synthetic import SyntheticCTR
from parameter_server_tpu_torch.kv.migrate import ShardMigrator
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.models import linear
from parameter_server_tpu_torch.ops.quantize import FP8_FORMATS, dequantize_fp8, quantize_fp8
from parameter_server_tpu_torch.utils.metrics import transport_counters

ROWS = 1 << 10
NUM_SERVERS = 2
STEPS = 12


def _int8_ef(**kw):
    return WireCompressionConfig(codec="int8", error_feedback=True, **kw)


def _table_cfgs(compression=None):
    return {"w": TableConfig(name="w", rows=ROWS, dim=1,
                             optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.1),
                             compression=compression)}


def _push_msg(keys, values, table="w", msgs=messages):
    return msgs.Message(task=msgs.Task(msgs.TaskKind.PUSH, "kv", payload={"table": table}),
                        sender="W0", recver="S0", keys=keys, values=list(values))


def _servers(van, cfgs, n=NUM_SERVERS):
    return [KVServer(Postoffice(f"S{s}", van), cfgs, s, n, device="cpu") for s in range(n)]


def _grad(w_pos, labels):
    g, _gb, loss = linear.grad_rows(torch.tensor(w_pos), torch.tensor(labels))
    return g.numpy() / labels.shape[0], float(loss)


# ------------------------------------------------------------------ constants


def test_bundle_constants_match_coalesce():
    """filters.py mirrors the bundle literals to avoid an import cycle."""
    assert filters_mod._BUNDLE_CUSTOMER == coalesce.BUNDLE_CUSTOMER
    assert filters_mod._BUNDLE_KEY == coalesce.BUNDLE_KEY


def test_wire_compression_config_matches_jax():
    import dataclasses

    port = {f.name: f.default for f in dataclasses.fields(WireCompressionConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(JaxWCC)}
    assert port == ref
    assert TableConfig(name="w", rows=1).compression is None
    with pytest.raises(ValueError):
        WireCompressionConfig(codec="int4")


# ----------------------------------------------------------------------- fp8


@pytest.mark.parametrize("fmt,bound", [("e4m3", 0.0625), ("e5m2", 0.125)])
def test_fp8_roundtrip_relative_error_bound(fmt, bound):
    x = np.random.default_rng(0).normal(size=(256, 4)).astype(np.float32)
    q, s = quantize_fp8(x, fmt=fmt)
    got = dequantize_fp8(q, s, fmt=fmt)
    amax = float(np.abs(x).max())
    normal = np.abs(x) >= amax / 32.0
    rel = np.abs(got - x) / np.maximum(np.abs(x), 1e-9)
    assert normal.sum() > 100
    assert float(rel[normal].max()) <= bound
    assert float(np.abs(got - x)[~normal].max()) <= amax / 32.0


@pytest.mark.parametrize("fmt", sorted(FP8_FORMATS))
def test_fp8_zeros_and_dynamic_range(fmt):
    q, s = quantize_fp8(np.zeros((8,), np.float32), fmt=fmt)
    np.testing.assert_array_equal(dequantize_fp8(q, s, fmt=fmt), 0.0)
    x = np.array([0.01, 0.1, 1.0, 10.0, 100.0], np.float32)
    got = dequantize_fp8(*quantize_fp8(x, fmt=fmt), fmt=fmt)
    assert np.all(np.isfinite(got)) and np.all(np.diff(got) > 0)


def test_fp8_stochastic_needs_seed_and_replays_deterministically():
    x = np.linspace(-2, 2, 97).astype(np.float32)
    with pytest.raises(ValueError, match="needs rng= or seed="):
        quantize_fp8(x, stochastic=True)
    a, _ = quantize_fp8(x, stochastic=True, seed=7)
    b, _ = quantize_fp8(x, stochastic=True, seed=7)
    c, _ = quantize_fp8(x, stochastic=True, seed=8)
    np.testing.assert_array_equal(a, b)
    assert not np.array_equal(a, c)


def test_fp8_stochastic_rounding_is_unbiased():
    x = np.array([1.0, 0.30], np.float32)  # scale pinned by the 1.0
    rng = np.random.default_rng(3)
    draws = [dequantize_fp8(*quantize_fp8(x, stochastic=True, rng=rng))[1]
             for _ in range(2000)]
    assert abs(float(np.mean(draws)) - 0.30) < 0.005


# ------------------------------------------------------ per_row config plumbing


def test_per_row_resolution():
    wide, narrow = np.zeros((4, 32), np.float32), np.zeros((4, 1), np.float32)
    assert _resolve_per_row("auto", wide) is True
    assert _resolve_per_row("auto", narrow) is False
    assert _resolve_per_row(True, narrow) is True
    assert _resolve_per_row(False, wide) is False


def test_fixing_float_per_row_config_changes_precision():
    x = np.vstack([np.full((1, 32), 100.0, np.float32), np.full((1, 32), 0.1, np.float32)])
    per_row = FixingFloatFilter(config=WireCompressionConfig(per_row=True))
    per_tensor = FixingFloatFilter(config=WireCompressionConfig(per_row=False))
    got_row = per_row.decode(per_row.encode(_push_msg(None, [x]))).values[0]
    got_tensor = per_tensor.decode(per_tensor.encode(_push_msg(None, [x]))).values[0]
    assert np.abs(got_row[1] - 0.1).max() < 0.001  # 0.1/127 grid
    assert np.abs(got_tensor[1] - 0.1).max() > 0.01  # 100/127 grid rounds 0.1 to 0


# ------------------------------------------------------------ QuantizingFilter


def test_quantizing_filter_single_push_roundtrip_and_flag():
    codec = QuantizingFilter(default=_int8_ef())
    keys = np.arange(32, dtype=np.int64)
    vals = np.linspace(-1, 1, 32).astype(np.float32).reshape(32, 1)
    enc = codec.encode(_push_msg(keys, [vals]))
    assert enc.values[0].dtype == np.int8
    assert frame.COMPRESSED_KEY in enc.task.payload
    assert frame.peek(frame.encode(enc)).flags & frame.FLAG_COMPRESSED
    dec = codec.decode(enc)
    assert frame.COMPRESSED_KEY not in dec.task.payload
    assert dec.values[0].dtype == np.float32
    np.testing.assert_allclose(dec.values[0], vals, atol=1.0 / 127 + 1e-6)
    c = codec.counters()
    assert c["compress_raw_bytes"] > c["compress_wire_bytes"] > 0


def test_quantizing_filter_scopes_to_push_requests_only():
    codec = QuantizingFilter(default=_int8_ef())
    vals = [np.ones((8, 1), np.float32)]
    pull = Message(task=Task(TaskKind.PULL, "kv", payload={"table": "w"}),
                   sender="W0", recver="S0", keys=np.arange(8), values=list(vals))
    assert codec.encode(pull) is pull
    reply = _push_msg(np.arange(8), vals)
    reply.is_request = False
    assert codec.encode(reply) is reply
    off = QuantizingFilter(default=WireCompressionConfig(),
                           per_table={"w": WireCompressionConfig()})
    msg = _push_msg(np.arange(8), vals)
    assert off.encode(msg) is msg


def test_error_feedback_recovers_sub_step_gradients():
    keys = np.arange(2, dtype=np.int64)
    g = np.array([[100.0], [0.3]], np.float32)

    def total(codec):
        out = np.zeros((2, 1), np.float32)
        for _ in range(10):
            out += codec.decode(codec.encode(_push_msg(keys, [g.copy()]))).values[0]
        return out

    ef = total(QuantizingFilter(default=_int8_ef()))
    plain = total(QuantizingFilter(
        default=WireCompressionConfig(codec="int8", error_feedback=False)))
    assert abs(ef[1, 0] - 3.0) < 100.0 / 127  # within one quant step
    assert plain[1, 0] == 0.0  # every push rounded the 0.3 away
    assert abs(ef[0, 0] - 1000.0) < 1e-3


def test_quantizer_from_tables_accepts_dicts_and_gates_on_config():
    assert quantizer_from_tables(_table_cfgs(None)) is None
    codec = quantizer_from_tables(_table_cfgs(_int8_ef()))
    assert isinstance(codec, QuantizingFilter)
    assert codec.per_table["w"].codec == "int8"


# ------------------------------------------------------ cluster: bytes + parity


def _codec_stack(compression, *, seed=0, drop=0.0):
    """CoalescingVan(MeteredVan(ReliableVan(ChaosVan(LoopbackVan))),
    codec=...): the codec runs once per bundle above the reliability layer,
    so retransmits resend the already-quantized frame."""
    chaos = ChaosVan(LoopbackVan(), seed=seed, drop=drop)
    rel = ReliableVan(chaos, timeout=0.1, backoff=1.0, max_retries=60, seed=seed)
    codec = quantizer_from_tables(_table_cfgs(compression)) if compression is not None else None
    return CoalescingVan(MeteredVan(rel), codec=codec), rel, codec


def test_cluster_roundtrip_and_metered_raw_bytes():
    cfgs = _table_cfgs(_int8_ef())
    van, _rel, codec = _codec_stack(_int8_ef())
    try:
        servers = _servers(van, cfgs)
        worker = KVWorker(Postoffice("W0", van), cfgs, NUM_SERVERS, device="cpu")
        rng = np.random.default_rng(0)
        keys = np.sort(rng.choice(ROWS, 200, replace=False)).astype(np.int64)
        vals = rng.normal(size=(keys.size, 1)).astype(np.float32)
        worker.push_sync("w", keys, vals, timeout=60)
        got = worker.pull_sync("w", keys, timeout=60)
        assert np.all(np.isfinite(got)) and float(np.abs(got).max()) > 0
        c = transport_counters(van)
        assert c["compress_raw_bytes"] > c["compress_wire_bytes"] > 0
        # MeteredVan books what the frame WOULD have weighed
        assert c["wire_raw_bytes"] > c["wire_bytes"] > 0
        saved = c["wire_raw_bytes"] - c["wire_bytes"]
        assert saved == c["compress_raw_bytes"] - c["compress_wire_bytes"]
        assert find_quantizers(van) == [codec]
        assert servers
    finally:
        van.close()


@pytest.mark.chaos
def test_plain_int8_stalls_where_error_feedback_converges():
    pushes = 12
    sgd = OptimizerConfig(kind="sgd", learning_rate=1.0)

    def run(compression):
        chaos = ChaosVan(LoopbackVan(), seed=1, drop=0.05)
        rel = ReliableVan(chaos, timeout=0.1, backoff=1.0, max_retries=60, seed=1)
        van = CoalescingVan(rel, codec=QuantizingFilter(default=compression)
                            if compression else None)
        try:
            cfg = {"w": TableConfig(name="w", rows=64, dim=1, optimizer=sgd,
                                    compression=compression)}
            server = KVServer(Postoffice("S0", van), cfg, 0, 1, device="cpu")
            worker = KVWorker(Postoffice("W0", van), cfg, 1, device="cpu")
            keys = np.arange(40, dtype=np.int64)
            g = np.full((keys.size, 1), -0.3, np.float32)
            g[0, 0] = -100.0  # pins the per-tensor scale at ~100/127
            for _ in range(pushes):
                worker.push_sync("w", keys, g.copy(), timeout=60)
            w = worker.pull_sync("w", keys, timeout=60)
            assert server.pushes >= pushes
            return np.asarray(w, np.float32).reshape(-1)
        finally:
            van.close()

    exact = run(None)
    ef = run(_int8_ef())
    plain = run(WireCompressionConfig(codec="int8", error_feedback=False))
    single = np.isclose(exact, pushes * 0.3, atol=1e-3)
    assert single.sum() >= 5
    assert float(np.abs(ef - exact).max()) <= 100.0 / 127 + 1e-5
    assert float(np.abs(plain[single]).max()) == 0.0


@pytest.mark.chaos
@pytest.mark.migration
def test_training_parity_int8_ef_under_chaos_across_live_migration():
    def run(compression, migrate):
        van, _rel, codec = _codec_stack(compression, seed=2, drop=0.05)
        cfgs = _table_cfgs(compression)
        try:
            servers = _servers(van, cfgs)
            worker = KVWorker(Postoffice("W0", van), cfgs, NUM_SERVERS, device="cpu")
            data = SyntheticCTR(key_space=4 * ROWS, nnz=8, batch_size=128, seed=3)
            batches = [data.next_batch() for _ in range(STEPS)]
            mig = ShardMigrator(Postoffice("M0", van), chunk_rows=256)
            losses = []
            for i, (keys, labels) in enumerate(batches):
                if migrate and i == STEPS // 2:
                    assert worker.adopt_routing(mig.migrate(worker.routing, "w", 768, ROWS, 0))
                    if codec is not None:
                        assert codec.resets >= 1
                g, loss = _grad(worker.pull_sync("w", keys, timeout=60), labels)
                worker.push_sync("w", keys, g, timeout=60)
                losses.append(loss)
            assert servers
            return losses
        finally:
            van.close()

    ref = run(None, migrate=False)
    comp = run(_int8_ef(), migrate=True)
    assert ref[-1] < ref[0]
    assert abs(comp[-1] - ref[-1]) < 0.03
    assert abs(float(np.mean(comp[-3:])) - float(np.mean(ref[-3:]))) < 0.03


# ------------------------------------------------------------ residual lifecycle


def _reset_events(node):
    return [e for e in flightrec.get().events()
            if e["kind"] == "compress.residual_reset" and e.get("node") == node]


@pytest.mark.migration
def test_residuals_reset_on_adopt_routing():
    flightrec.configure(enabled=True)
    cfgs = _table_cfgs(_int8_ef())
    codec = quantizer_from_tables(cfgs)
    van = CoalescingVan(LoopbackVan(), codec=codec)
    try:
        servers = _servers(van, cfgs)
        worker = KVWorker(Postoffice("W0", van), cfgs, NUM_SERVERS, device="cpu")
        rng = np.random.default_rng(4)
        keys = np.sort(rng.choice(ROWS, 100, replace=False)).astype(np.int64)
        worker.push_sync("w", keys, rng.normal(size=(100, 1)).astype(np.float32), timeout=60)
        assert codec._residuals and codec.resets == 0
        before = len(_reset_events("W0"))
        mig = ShardMigrator(Postoffice("M0", van), chunk_rows=256)
        assert worker.adopt_routing(mig.migrate(worker.routing, "w", 768, ROWS, 0))
        assert codec.resets >= 1 and not codec._residuals
        events = _reset_events("W0")[before:]
        assert events and events[-1]["reason"] == "adopt_routing"
        assert servers
    finally:
        van.close()


def test_residuals_reset_on_same_id_restart():
    cfgs = _table_cfgs(_int8_ef())
    codec = quantizer_from_tables(cfgs)
    rel = ReliableVan(LoopbackVan(), timeout=0.1, backoff=1.0, max_retries=60, seed=0)
    van = CoalescingVan(rel, codec=codec)
    try:
        servers = _servers(van, cfgs)
        worker = KVWorker(Postoffice("W0", van), cfgs, NUM_SERVERS, device="cpu")
        rng = np.random.default_rng(5)
        keys = np.sort(rng.choice(ROWS, 64, replace=False)).astype(np.int64)
        worker.push_sync("w", keys, rng.normal(size=(64, 1)).astype(np.float32), timeout=60)
        assert codec._residuals
        rel.restart_node("S0")
        assert codec.resets >= 1 and not codec._residuals
        assert servers
    finally:
        van.close()


# ----------------------------------------------------------- cross-package bytes


def _push_sequence(msgs):
    """Pushes of one sender: sorted unique keys (EF hits and misses), a
    padded bucket (trash-row tail), a store past the dense promotion, a
    dim-16 plane and a second table."""
    rng = np.random.default_rng(21)
    out = []
    for n in (500, 700, 20000, 20000):
        keys = np.sort(rng.choice(40000, n, replace=False)).astype(np.int64)
        out.append(_push_msg(keys, [rng.normal(size=(n, 1)).astype(np.float32)], msgs=msgs))
    keys = np.concatenate([np.sort(rng.choice(4000, 300, replace=False)),
                           np.full(212, 4095)]).astype(np.int64)
    vals = rng.normal(size=(512, 1)).astype(np.float32)
    vals[300:] = 0.0
    out.append(_push_msg(keys, [vals], msgs=msgs))
    keys = np.sort(rng.choice(1000, 64, replace=False)).astype(np.int64)
    out.append(_push_msg(keys, [rng.normal(size=(64, 16)).astype(np.float32)], table="e",
                         msgs=msgs))
    return out


@pytest.mark.parametrize("codec", ["int8", "fp8"])
@pytest.mark.parametrize("rounding", ["nearest", "stochastic"])
def test_quantizer_frames_are_bitwise_jax(codec, rounding):
    kw = dict(codec=codec, error_feedback=True, rounding=rounding, seed=3)
    port = QuantizingFilter(default=WireCompressionConfig(**kw))
    ref = jax_filters.QuantizingFilter(default=JaxWCC(**kw))
    for pm, jm in zip(_push_sequence(messages), _push_sequence(jax_messages)):
        pe, je = port.encode(pm), ref.encode(jm)
        assert bytes(frame.encode(pe)) == bytes(jax_frame.encode(je))
        pd = port.decode(frame.decode(jax_frame.encode(je)))
        jd = ref.decode(jax_frame.decode(frame.encode(pe)))
        assert bytes(frame.encode(pd)) == bytes(jax_frame.encode(jd))
    assert port._residuals[("W0", "w")].get("dense")  # the promoted store ran
    assert port.counters() == ref.counters()


def test_quantizer_bundle_frame_is_bitwise_jax():
    def bundle(coal, msgs):
        subs = _push_sequence(msgs)[:2] + [msgs.Message(
            task=msgs.Task(msgs.TaskKind.PULL, "kv", payload={"table": "w"}),
            sender="W0", recver="S0", keys=np.arange(16, dtype=np.int64))]
        return coal._pack(subs)

    port = QuantizingFilter(default=_int8_ef())
    ref = jax_filters.QuantizingFilter(default=JaxWCC(codec="int8", error_feedback=True))
    pe = port.encode(bundle(coalesce, messages))
    je = ref.encode(bundle(jax_coalesce, jax_messages))
    assert bytes(frame.encode(pe)) == bytes(jax_frame.encode(je))
    assert port.counters() == ref.counters()


# ------------------------------------------------------------- observability


def _pstop():
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))
    import pstop

    return pstop


def test_cmpr_pct_rides_telemetry_into_pstop():
    from parameter_server_tpu_torch.core.telemetry import (
        TelemetryAggregator,
        TelemetryPublisher,
    )

    class _Src:
        def counters(self):
            return {"wire_bytes": 300, "wire_raw_bytes": 1200}

    rec = flightrec.FlightRecorder(capacity=16)
    pub = TelemetryPublisher("W0", None, recorder=rec, sources=[_Src()])
    agg = TelemetryAggregator()
    assert agg.ingest("W0", pub.frame(now=1.0), now=1.0)
    assert agg.latest()["W0"]["cmpr_pct"] == 25.0
    out = "\n".join(_pstop().render(agg.latest()))
    assert "CMPR%" in out and "25.0" in out


def test_compression_slo_breaches_on_bad_ratio():
    from parameter_server_tpu_torch.utils.slo import SloEngine, compression_plane_specs

    specs = compression_plane_specs(max_ratio_pct=50.0)
    assert [s.metric for s in specs] == ["compress_ratio_pct", "compress_residual_norm"]
    eng = SloEngine(specs, recorder=flightrec.FlightRecorder(capacity=16))
    eng.ingest_counters("W0", {"compress_ratio_pct": 80.0}, now=1.0)
    verdicts = eng.evaluate(now=1.5)
    assert not verdicts["W0"].healthy and "compress-ratio" in verdicts["W0"].breaches
    eng.ingest_counters("W0", {"compress_ratio_pct": 26.0}, now=20.0)
    assert eng.evaluate(now=20.5)["W0"].healthy


def test_compress_events_registered_everywhere():
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))
    import check_wrappers

    kinds = {"compress.encode", "compress.decode", "compress.residual_reset"}
    assert kinds <= flightrec.EVENTS
    assert kinds <= set(check_wrappers.REQUIRED_EVENTS)
