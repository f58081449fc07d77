"""The live telemetry plane of the PyTorch port, against the JAX package's.

The twin of ``tests/test_telemetry.py`` on the port's ``core/telemetry.py``,
``utils/slo.py`` and ``core/manager.py`` (delta encoding, publisher
seq/watermark, aggregator dedup/late/rebase, JSONL spill -> ``tools/pstop``,
the SLO engine under reordering and clock offsets, the live staleness breach
under a slowed worker), plus the cross-package checks: the two packages'
publishers build equal frames from equal sources, each package's aggregator
ingests the other's frames into rows equal to its own, and the two SLO
engines reach equal verdicts and breach timelines on one series.
"""

import json
import pathlib
import sys
import time

import numpy as np
import pytest

from parameter_server_tpu_torch.config import OptimizerConfig, TableConfig
from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.chaos import ChaosVan
from parameter_server_tpu_torch.core.fleet import FleetMonitor
from parameter_server_tpu_torch.core.manager import SCHEDULER, launch_local_cluster
from parameter_server_tpu_torch.core.messages import server_id, worker_id
from parameter_server_tpu_torch.core.netmon import MeteredVan
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.resender import ReliableVan
from parameter_server_tpu_torch.core.telemetry import (
    TelemetryAggregator,
    TelemetryPublisher,
    delta_digest,
)
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.utils.slo import SloEngine, SloSpec
from parameter_server_tpu_torch.utils.trace import LatencyHistogram

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import pstop  # noqa: E402

ROWS = 1 << 10


def _table_cfgs():
    return {
        "w": TableConfig(
            name="w", rows=ROWS, dim=2,
            optimizer=OptimizerConfig(kind="sgd", learning_rate=0.1),
        )
    }


# ------------------------------------------------------------ delta encoding


def test_delta_digest_sparse_roundtrip():
    h = LatencyHistogram()
    for v in (0.001, 0.002, 0.005):
        h.record(v)
    prev = h.to_dict()
    h.record(0.009)
    h.record(0.009)
    cur = h.to_dict()
    dd = delta_digest(prev, cur)
    assert dd["count"] == 2
    # reconstructing prev + delta yields cur's distribution
    back = LatencyHistogram.from_dict(prev)
    back.merge(LatencyHistogram.from_dict(dd))
    assert back.count == h.count
    assert back.percentile(0.99) == h.percentile(0.99)


def test_delta_digest_nothing_new_is_none():
    h = LatencyHistogram()
    h.record(0.001)
    d = h.to_dict()
    assert delta_digest(d, d) is None
    assert delta_digest(None, {"count": 0}) is None
    assert delta_digest(d, None) is None


def test_delta_digest_reset_falls_back_to_full():
    h = LatencyHistogram()
    for _ in range(5):
        h.record(0.001)
    big = h.to_dict()
    h2 = LatencyHistogram()
    h2.record(0.002)
    small = h2.to_dict()
    # count moved backwards: recorder restarted -> full current digest
    assert delta_digest(big, small) == small


# ----------------------------------------------------------------- publisher


class _Src:
    """Minimal telemetry source: counters + one staleness series."""

    def __init__(self):
        self.hist = LatencyHistogram()
        self.n = 0

    def counters(self):
        return {"pushes": self.n}

    def staleness_digests(self):
        return {"staleness.w": self.hist.to_dict()}


def test_publisher_emits_deltas_and_advances_seq():
    src = _Src()
    rec = flightrec.FlightRecorder(capacity=64)
    pub = TelemetryPublisher("W0", None, recorder=rec, sources=[src])
    src.n = 3
    src.hist.record(1.0)
    f1 = pub.frame(now=1.0)
    assert (f1["v"], f1["node"], f1["seq"]) == (1, "W0", 1)
    assert f1["counters"] == {"pushes": 3}
    assert f1["staleness"]["staleness.w"]["count"] == 1
    # nothing changed: the next frame carries no counter/staleness sections
    f2 = pub.frame(now=2.0)
    assert f2["seq"] == 2
    assert "counters" not in f2 and "staleness" not in f2
    src.n = 5
    f3 = pub.frame(now=3.0)
    assert f3["counters"] == {"pushes": 2}  # delta, not cumulative


def test_publisher_event_watermark_counts_each_event_once():
    rec = flightrec.FlightRecorder(capacity=64)
    pub = TelemetryPublisher("W0", None, recorder=rec)
    rec.record("frame.send", node="W0")
    rec.record("frame.send", node="W0")
    rec.record("frame.send", node="S9")  # other node: attributed, not echoed
    f1 = pub.frame(now=1.0)
    assert f1["events"] == {"frame.send": 2}
    f2 = pub.frame(now=2.0)
    assert "events" not in f2  # watermark advanced: nothing re-reported
    rec.record("frame.recv", node="W0")
    assert pub.frame(now=3.0)["events"] == {"frame.recv": 1}


# ---------------------------------------------------------------- aggregator


def test_aggregator_drops_duplicate_frames():
    flightrec.configure(clear=True)
    try:
        agg = TelemetryAggregator()
        rec_pub = flightrec.FlightRecorder(capacity=16)
        pub = TelemetryPublisher("W0", None, recorder=rec_pub)
        f = pub.frame(now=1.0)
        assert agg.ingest("W0", f, now=1.0)
        assert not agg.ingest("W0", dict(f), now=1.1)  # replay
        assert agg.counters()["telemetry_dup_frames"] == 1
        drops = [
            e for e in flightrec.get().events()
            if e["kind"] == "telemetry.drop"
        ]
        assert drops and drops[0]["node"] == "W0"
        assert len(agg.rows("W0")) == 1  # the dup added no row
    finally:
        flightrec.configure(clear=True)


def test_aggregator_rebases_sender_clock_and_counts_late_frames():
    class _Fleet:
        def clock_offset(self, node):
            return 5.0  # node clock runs 5s ahead of the scheduler

        def stragglers(self, now):
            return {}

    agg = TelemetryAggregator(fleet=_Fleet())
    assert agg.ingest("W0", {"seq": 1, "t_mono_s": 105.0}, now=50.0)
    row = agg.latest()["W0"]
    assert row["t"] == pytest.approx(100.0)  # 105 - offset
    # newer seq, older sender stamp: kept, but flagged late (no rates)
    assert agg.ingest("W0", {"seq": 2, "t_mono_s": 104.0}, now=51.0)
    assert agg.counters()["telemetry_late_frames"] == 1
    assert "msgs_per_s" not in agg.latest()["W0"]


def test_aggregator_ring_is_bounded_and_spills_jsonl(tmp_path):
    path = str(tmp_path / "telemetry.jsonl")
    agg = TelemetryAggregator(window=4, jsonl_path=path)
    for i in range(1, 11):
        agg.ingest("W0", {"seq": i, "t_mono_s": float(i)}, now=float(i))
    assert len(agg.rows("W0")) == 4  # ring bound
    agg.close()
    lines = [
        json.loads(ln)
        for ln in pathlib.Path(path).read_text().splitlines() if ln
    ]
    assert len(lines) == 10  # the spill keeps what the ring evicted
    assert [r["seq"] for r in lines] == list(range(1, 11))


def test_pstop_renders_spill(tmp_path):
    path = str(tmp_path / "telemetry.jsonl")
    src = _Src()
    rec = flightrec.FlightRecorder(capacity=16)
    pub = TelemetryPublisher("W0", None, recorder=rec, sources=[src])
    eng = SloEngine([
        SloSpec("stale", "staleness.w", 2.0, source="p99",
                window_s=600.0, min_samples=1, p99_scale=1.0),
    ], recorder=rec)
    agg = TelemetryAggregator(slo=eng, jsonl_path=path)
    src.hist.record(1.0)
    agg.ingest("W0", pub.frame(now=1.0), now=1.0)
    src.hist.record(9.0)
    src.hist.record(9.0)
    agg.ingest("W0", pub.frame(now=2.0), now=2.0)
    with open(path, "a") as f:
        f.write('{"torn json...\n')  # reader must skip a torn line
    agg.close()
    latest = pstop.load_rows(path)
    assert set(latest) == {"W0"} and latest["W0"]["seq"] == 2
    out = "\n".join(pstop.render(latest))
    assert "W0" in out and "BREACH:stale" in out
    assert "9/9" in out  # staleness p50/p99 column
    assert pstop.render({}) == ["(no telemetry rows yet)"]


# ---------------------- satellite: SLO under clock offsets + reordering


def _digests(values):
    """Cumulative staleness digests after each prefix of ``values``."""
    h = LatencyHistogram()
    out = []
    for v in values:
        h.record(float(v))
        out.append(h.to_dict())
    return out


def test_windowed_gauge_sorts_out_of_order_samples():
    eng = SloEngine([SloSpec("g", "lag", 10.0, window_s=100.0)])
    eng.observe("W0", "lag", 50.0, now=5.0)
    eng.observe("W0", "lag", 1.0, now=3.0)  # LATE arrival of an older sample
    v = eng.evaluate(now=6.0)["W0"]
    # the window's latest gauge is the newest BY TIME, not by append order
    assert v.observed["g"] == 50.0
    assert not v.healthy


def test_late_frame_cannot_retroflip_edge_triggered_breach():
    rec = flightrec.FlightRecorder(capacity=64)
    eng = SloEngine([
        SloSpec("stale", "staleness.w", 8.0, source="p99",
                window_s=30.0, min_samples=2, p99_scale=1.0),
    ], recorder=rec)
    d = _digests([1.0, 1.0, 20.0, 20.0])
    eng.observe("W1", "staleness.w", d[1], now=100.0)
    eng.observe("W1", "staleness.w", d[3], now=110.0)
    eng.evaluate(now=110.0)
    assert not eng.healthy("W1")
    kinds = [e["kind"] for e in rec.events()]
    assert kinds == ["slo.breach"]
    # a LATE frame arrives carrying an old digest and an old clock: the
    # evaluation clamps to the high-water now, so the breach edge holds
    eng.observe("W1", "staleness.w", d[0], now=95.0)
    eng.evaluate(now=96.0)
    assert not eng.healthy("W1")
    kinds = [e["kind"] for e in rec.events()]
    assert kinds == ["slo.breach"]  # no clear, no re-breach


def test_slo_windows_align_under_nonzero_clock_offset():
    """Two nodes with a 5s clock skew: the aggregator rebases frames into
    the scheduler domain before feeding the engine, so both nodes' samples
    land in one comparable window."""

    class _Fleet:
        def clock_offset(self, node):
            return {"W0": 0.0, "W1": 5.0}[node]

        def stragglers(self, now):
            return {}

    eng = SloEngine([
        SloSpec("stale", "staleness.w", 8.0, source="p99",
                window_s=60.0, min_samples=2, p99_scale=1.0),
    ])
    agg = TelemetryAggregator(slo=eng, fleet=_Fleet())
    d = _digests([1.0, 1.0])
    # same scheduler-domain instants, expressed in each node's own clock
    for node, skew in (("W0", 0.0), ("W1", 5.0)):
        agg.ingest(node, {
            "seq": 1, "t_mono_s": 100.0 + skew,
            "staleness": {"staleness.w": d[0]},
        }, now=100.0)
        agg.ingest(node, {
            "seq": 2, "t_mono_s": 110.0 + skew,
            "staleness": {"staleness.w": delta_digest(d[0], d[1]) or {}},
        }, now=110.0)
    for node in ("W0", "W1"):
        times = [t for t, _ in eng._series[(node, "staleness.w")]]
        assert times == [pytest.approx(100.0), pytest.approx(110.0)]
        assert eng.healthy(node)


# --------------------------- acceptance: live staleness breach vs slow_node


@pytest.mark.chaos
def test_staleness_slo_breaches_live_under_slow_worker():
    """Full Metered(Reliable(Chaos(Loopback))) stack with telemetry riding
    heartbeats: the slowed worker's staleness p99 diverges from the fleet
    and the staleness SLO breaches ON ARRIVAL of the live TELEMETRY
    stream — the test never calls ``evaluate``/``ingest`` itself — and
    never during the clean phase.

    The async schedule is driven explicitly for determinism: ``slow_node``
    delays every delivery INTO W1 by 60ms, so each W1 round trip eats
    ~120ms of injected latency while W0 (a few ms per round) keeps
    pushing — the test pins that ratio at 12 healthy rounds per straggler
    round instead of racing wall-clock threads, which makes the measured
    version lag (~12 vs ~1) exact rather than scheduler-dependent."""
    flightrec.configure(clear=True)
    chaos = ChaosVan(LoopbackVan(), seed=0)
    van = MeteredVan(
        ReliableVan(chaos, timeout=5.0, backoff=1.0, max_retries=3, seed=0)
    )
    rec = flightrec.FlightRecorder(capacity=256)
    try:
        sched, managers, posts = launch_local_cluster(
            van, num_workers=2, num_servers=2
        )
        fleet = FleetMonitor()
        sched.fleet = fleet
        eng = SloEngine([
            SloSpec("staleness-p99", "staleness.w", 8.0, source="p99",
                    window_s=600.0, min_samples=2, p99_scale=1.0),
        ], recorder=rec)
        sched.telemetry = TelemetryAggregator(slo=eng, fleet=fleet)
        cfgs = _table_cfgs()
        servers = [
            KVServer(posts[server_id(s)], cfgs, s, 2, device="cpu") for s in range(2)
        ]
        workers = {
            worker_id(w): KVWorker(posts[worker_id(w)], cfgs, 2, min_bucket=16,
                                  device="cpu")
            for w in range(2)
        }
        for nid, mgr in managers.items():
            if nid == SCHEDULER:
                continue
            mgr.telemetry_pub = TelemetryPublisher(
                nid, van,
                sources=[workers[nid]] if nid in workers else [],
            )

        def publish_all():
            # heartbeat first (clock/straggler state), then one frame whose
            # ts we CAN wait on — ingestion + evaluation happen before the
            # scheduler's reply, so this blocks until verdicts are current
            for nid, mgr in managers.items():
                if nid == SCHEDULER:
                    continue
                assert mgr.wait(mgr.send_heartbeat(), timeout=60)
                ts = mgr.publish_telemetry()
                assert ts is not None and mgr.wait(ts, timeout=60)

        def step(wid, rng):
            w = workers[wid]
            keys = rng.integers(0, ROWS, size=48).astype(np.uint64)
            w.pull_sync("w", keys, timeout=60)
            assert w.wait(
                w.push("w", keys, rng.standard_normal((48, 2)).astype(np.float32)),
                timeout=60,
            )

        rngs = {wid: np.random.default_rng(i) for i, wid in enumerate(workers)}
        for _ in range(3):  # clean phase: both workers in lockstep
            for wid in workers:
                step(wid, rngs[wid])
            publish_all()
        assert all(eng.healthy(wid) for wid in workers)
        assert [e["kind"] for e in rec.events()] == []  # no breach when clean
        assert all(w.staleness_samples > 0 for w in workers.values())

        chaos.slow_node(worker_id(1), 60.0)  # the straggler
        t0 = time.monotonic()
        for _ in range(5):
            for _ in range(12):  # W0 trains on while W1's round crawls
                step(worker_id(0), rngs[worker_id(0)])
            step(worker_id(1), rngs[worker_id(1)])  # ~120ms injected latency
            publish_all()  # the live stream, at heartbeat cadence
        # the straggler's rounds really were wire-delayed, not just scheduled
        assert time.monotonic() - t0 > 5 * 0.12
        publish_all()  # final frames carry the last staleness deltas

        # healthy() flipped purely from wire-delivered frames
        assert not eng.healthy(worker_id(1))
        assert eng.healthy(worker_id(0))
        breaches = [e for e in rec.events() if e["kind"] == "slo.breach"]
        assert breaches and {e["node"] for e in breaches} == {worker_id(1)}
        assert all(e["slo"] == "staleness-p99" for e in breaches)
        # the straggler's update-lag distribution visibly diverged
        agg = sched.telemetry
        p99_slow = agg.staleness_quantile(worker_id(1), "staleness.w", 0.99)
        p99_fast = agg.staleness_quantile(worker_id(0), "staleness.w", 0.99)
        assert p99_slow > 8.0 >= p99_fast, (p99_slow, p99_fast)
        lat = agg.latest()
        assert lat[worker_id(1)]["healthy"] is False
        assert "staleness-p99" in lat[worker_id(1)].get("breaches", [])
        assert chaos.injected_slow > 0
        del servers
    finally:
        van.close()
        flightrec.configure(clear=True)


# ------------------------------------------------- wire plumbing (manager)


def test_telemetry_rides_heartbeat_and_dedups_on_wire():
    """A publisher attached to a manager publishes on every heartbeat; the
    scheduler-side aggregator sees monotonically increasing seqs and drops
    a replayed frame."""
    flightrec.configure(clear=True)
    van = LoopbackVan()
    try:
        sched, managers, posts = launch_local_cluster(
            van, num_workers=1, num_servers=1
        )
        sched.telemetry = TelemetryAggregator()
        wid = worker_id(0)
        mgr = managers[wid]
        mgr.telemetry_pub = TelemetryPublisher(wid, van)
        for _ in range(3):
            assert mgr.wait(mgr.send_heartbeat(), timeout=60)
        ts = mgr.publish_telemetry()
        assert ts is not None and mgr.wait(ts, timeout=60)
        rows = sched.telemetry.rows(wid)
        assert [r["seq"] for r in rows] == [1, 2, 3, 4]
        # replayed frame (same seq) is dropped, not double-counted
        f = dict(rows[-1])
        assert not sched.telemetry.ingest(wid, {"seq": 4})
        assert sched.telemetry.counters()["telemetry_dup_frames"] == 1
        del f
    finally:
        van.close()
        flightrec.configure(clear=True)


# ----------------------------------------------------- device-plane channel


class _LedgerSrc:
    """Minimal device-plane source: apply-latency digests like ApplyLedger."""

    def __init__(self):
        self.hist = LatencyHistogram()

    def counters(self):
        return {"applies_submitted": self.hist.count}

    def latency_digests(self):
        return {"apply.w": self.hist.to_dict()}


def test_latency_digest_channel_deltas_then_cumulative_fold():
    """Publisher delta-encodes ``latency_digests()`` into ``frame["digests"]``;
    the aggregator folds each delta into a cumulative per-(node, series)
    histogram and re-derives count/p50/p99 on every row."""
    src = _LedgerSrc()
    agg = TelemetryAggregator()
    pub = TelemetryPublisher("S0", None,
                             recorder=flightrec.FlightRecorder(capacity=8),
                             sources=[src])
    src.hist.record(0.010)
    f1 = pub.frame(now=1.0)
    assert f1["digests"]["apply.w"]["count"] == 1
    agg.ingest("S0", f1, now=1.0)
    # quiet frame: the series is unchanged, so no digests section at all
    f2 = pub.frame(now=2.0)
    assert "digests" not in f2
    agg.ingest("S0", f2, now=2.0)
    src.hist.record(0.030)
    f3 = pub.frame(now=3.0)
    assert f3["digests"]["apply.w"]["count"] == 1  # the DELTA, not cum=2
    agg.ingest("S0", f3, now=3.0)
    row = agg.rows("S0")[-1]
    stats = row["digests"]["apply.w"]
    assert stats["count"] == 2  # cumulative across delta frames
    assert 0.010 <= stats["p50"] <= stats["p99"]
    assert stats["p99"] >= 0.030 * 0.8  # bucket-resolution upper bound


def test_aggregator_ctl_self_metrics_ride_every_row():
    """Control-plane self-observability: ring occupancy
    against capacity and per-node dedup drops ride each derived row."""
    agg = TelemetryAggregator(window=4)
    pub = TelemetryPublisher("S0", None,
                             recorder=flightrec.FlightRecorder(capacity=8))
    f1 = pub.frame(now=1.0)
    agg.ingest("S0", f1, now=1.0)
    row = agg.rows("S0")[-1]
    assert row["ctl"] == {"ring": 1, "ring_cap": 4, "drops": 0}
    # replay the same frame: dropped as a duplicate, counted per node
    assert agg.ingest("S0", f1, now=1.5) is False
    agg.ingest("S0", pub.frame(now=2.0), now=2.0)
    row = agg.rows("S0")[-1]
    assert row["ctl"] == {"ring": 2, "ring_cap": 4, "drops": 1}
    # another node's drops are accounted separately
    pub_b = TelemetryPublisher("S1", None,
                               recorder=flightrec.FlightRecorder(capacity=8))
    agg.ingest("S1", pub_b.frame(now=2.5), now=2.5)
    assert agg.rows("S1")[-1]["ctl"]["drops"] == 0


# ------------------------------------ fleet-scaled rings + breach math


def test_telemetry_config_scales_ring_with_fleet_size():
    from parameter_server_tpu_torch.config import TelemetryConfig

    cfg = TelemetryConfig(window=256, ring_budget_rows=8192, min_window=8)
    assert cfg.node_window(1) == 256          # capped at the window
    assert cfg.node_window(50) == 163         # 8192 // 50
    assert cfg.node_window(200) == 40         # 8192 // 200
    assert cfg.node_window(10_000) == 8       # floor wins
    with pytest.raises(ValueError):
        TelemetryConfig(window=0)
    with pytest.raises(ValueError):
        TelemetryConfig(window=16, min_window=32)
    with pytest.raises(ValueError):
        TelemetryConfig(window=64, ring_budget_rows=32)


def test_aggregator_recaps_rings_and_never_dedup_drops_at_200_publishers():
    """The per-node ring derives its capacity from the
    fleet size (total row budget / publishers) so 200 honest publishers fit
    the same memory envelope as 8 — and NONE of their frames are dropped as
    duplicates (dedup drops stay zero; only the rings shrink)."""
    from parameter_server_tpu_torch.config import TelemetryConfig

    cfg = TelemetryConfig(window=64, ring_budget_rows=1024, min_window=4)
    agg = TelemetryAggregator(config=cfg)
    nodes = [f"S{i}" for i in range(200)]
    pubs = {
        n: TelemetryPublisher(
            n, None, recorder=flightrec.FlightRecorder(capacity=8)
        )
        for n in nodes
    }
    for beat in range(3):
        for n in nodes:
            assert agg.ingest(
                n, pubs[n].frame(now=1.0 + beat), now=1.0 + beat
            )
    # zero dedup-drop growth: every honest frame landed
    assert agg.counters()["telemetry_dup_frames"] == 0
    assert all(
        (r[-1]["ctl"]["drops"] == 0) for r in (agg.rows(n) for n in nodes)
    )
    # rings re-capped for the fleet: 1024 // 200 = 5 rows per node
    caps = {agg.rows(n)[-1]["ctl"]["ring_cap"] for n in nodes}
    assert caps == {cfg.node_window(200)} == {5}
    total = sum(len(agg.rows(n)) for n in nodes)
    assert total <= cfg.ring_budget_rows


def test_breach_minutes_integrate_exactly_under_out_of_order_frames():
    """Edge-triggered breach/clear pairs integrate to
    EXACT breach-minutes, and a late out-of-order frame (older digest, older
    clock) neither shortens nor forks the open interval."""
    eng = SloEngine([
        SloSpec("stale", "staleness.w", 8.0, source="p99",
                window_s=30.0, min_samples=1, p99_scale=1.0),
    ])
    d = _digests([20.0, 20.0, 1.0, 1.0])
    eng.observe("W1", "staleness.w", d[0], now=100.0)
    eng.observe("W1", "staleness.w", d[1], now=110.0)
    eng.evaluate(now=110.0)                      # breach opens at 110
    assert eng.breach_seconds(now=130.0) == pytest.approx(20.0)
    # late frame: old digest, old clock — clamped, interval unchanged
    eng.observe("W1", "staleness.w", d[0], now=95.0)
    eng.evaluate(now=96.0)
    assert eng.breach_seconds(now=130.0) == pytest.approx(20.0)
    # healthy samples slide into the 30s window -> clear closes the interval
    eng.observe("W1", "staleness.w", d[2], now=140.0)
    eng.observe("W1", "staleness.w", d[3], now=150.0)
    eng.evaluate(now=150.0)
    assert eng.healthy("W1")
    assert eng.breach_seconds() == pytest.approx(40.0)   # 110 -> 150
    tl = eng.breach_timeline()
    assert tl == [
        {"slo": "stale", "node": "W1", "t0": 110.0, "t1": 150.0},
    ]
    # closed intervals do not keep growing
    assert eng.breach_seconds(now=500.0) == pytest.approx(40.0)


def test_breach_minutes_exact_under_nonzero_clock_offset():
    """Frames from a node whose clock runs 5s ahead: the aggregator rebases
    into the scheduler domain BEFORE the engine sees them, so the breach
    interval — and hence breach-minutes — lands on scheduler time."""

    class _Fleet:
        def clock_offset(self, node):
            return 5.0

        def stragglers(self, now):
            return {}

    eng = SloEngine([
        SloSpec("stale", "staleness.w", 8.0, source="p99",
                window_s=60.0, min_samples=1, p99_scale=1.0),
    ])
    agg = TelemetryAggregator(slo=eng, fleet=_Fleet())
    d = _digests([20.0, 20.0])
    agg.ingest("W0", {
        "seq": 1, "t_mono_s": 105.0,
        "staleness": {"staleness.w": d[0]},
    }, now=100.0)
    agg.ingest("W0", {
        "seq": 2, "t_mono_s": 115.0,
        "staleness": {"staleness.w": delta_digest(d[0], d[1]) or {}},
    }, now=110.0)
    assert not eng.healthy("W0")
    # interval opened at the REBASED stamp (110), not the node's 115
    assert eng.breach_seconds(now=140.0) == pytest.approx(30.0)
    tl = eng.breach_timeline(now=140.0)
    assert tl == [
        {"slo": "stale", "node": "W0", "t0": 110.0, "t1": 140.0,
         "open": True},
    ]


def test_restricted_evaluate_sweeps_only_named_nodes():
    eng = SloEngine([
        SloSpec("g", "lag", 10.0, window_s=100.0, min_samples=1),
    ])
    eng.observe("W0", "lag", 50.0, now=5.0)
    eng.observe("W1", "lag", 50.0, now=5.0)
    verdicts = eng.evaluate(now=6.0, nodes=["W0"])
    assert set(verdicts) == {"W0"}
    assert not eng.healthy("W0")
    assert eng.healthy("W1")  # untouched by the restricted sweep
    # the full sweep still covers everyone
    assert set(eng.evaluate(now=7.0)) == {"W0", "W1"}
    assert not eng.healthy("W1")


def test_pstop_fleet_summary_footer_rolls_up_the_fleet():
    """One footer row carries aggregate MSG/S, the worst
    node's staleness p99, running breach-minutes and the scenario phase."""
    latest = {
        "S0": {
            "seq": 3, "t_ingest": 10.0, "msgs_per_s": 12.5,
            "staleness": {"w": {"p50": 1.0, "p99": 4.0}},
            "ctl": {"ring": 1, "ring_cap": 8, "drops": 0,
                    "phase": "warmup", "breach_min": 0.1},
        },
        "S1": {
            "seq": 4, "t_ingest": 11.0, "msgs_per_s": 7.5,
            "staleness": {"w": {"p50": 2.0, "p99": 9.0}},
            "ctl": {"ring": 1, "ring_cap": 8, "drops": 0,
                    "phase": "flash_crowd", "breach_min": 0.25},
        },
    }
    fleet = pstop.fleet_summary(latest)
    assert fleet == {
        "msgs_per_s": 20.0, "worst_stale_p99": 9.0,
        "breach_minutes": 0.25, "phase": "flash_crowd",  # freshest row wins
    }
    out = "\n".join(pstop.render(latest, now=11.0))
    assert "== FLEET" in out and "MSG/S=20.0" in out
    assert "breach-min=0.25" in out and "phase=flash_crowd" in out
    snap = pstop.snapshot(latest, now=11.0)
    assert snap["fleet"]["phase"] == "flash_crowd"
    # no scenario, no slo: the footer degrades to dashes, not crashes
    bare = pstop.fleet_summary({"S0": {"seq": 1, "t_ingest": 1.0}})
    assert bare == {
        "msgs_per_s": None, "worst_stale_p99": None,
        "breach_minutes": None, "phase": None,
    }


# ------------------------------------------------- against the JAX package


class _MixedSrc:
    """One node's sources: counters, a staleness series and a latency
    series, drawn from a seeded generator, in either package's
    ``LatencyHistogram``."""

    def __init__(self, hist_cls, seed):
        self.rng = np.random.default_rng(seed)
        self.stale = hist_cls()
        self.lat = hist_cls()
        self.c = {"pushes": 0, "ro_pulls": 0, "serve_shed": 0, "cache_hits": 0,
                  "cache_misses": 0, "wire_bytes": 0, "wire_raw_bytes": 0,
                  "group_pushes": 0, "group_members": 0, "ckpt_age_s": 0.0}

    def advance(self):
        for k in self.c:
            self.c[k] += int(self.rng.integers(0, 50))
        for v in self.rng.exponential(4.0, size=int(self.rng.integers(0, 6))):
            self.stale.record(float(v))
        for v in self.rng.exponential(0.01, size=int(self.rng.integers(0, 6))):
            self.lat.record(float(v))

    def counters(self):
        return dict(self.c)

    def staleness_digests(self):
        return {"staleness.w": self.stale.to_dict()} if self.stale.count else {}

    def latency_digests(self):
        return {"apply.w": self.lat.to_dict(), "trace.e2e": self.lat.to_dict()} \
            if self.lat.count else {}


def _frames(side, node, seed, n=6):
    """``n`` frames of one node from ``side``'s publisher over a seeded
    source, with a few flight-recorder events of its own between them."""
    if side == "jax":
        from parameter_server_tpu.core import flightrec as fr
        from parameter_server_tpu.core.telemetry import TelemetryPublisher as Pub
        from parameter_server_tpu.utils.trace import LatencyHistogram as Hist
    else:
        fr, Pub, Hist = flightrec, TelemetryPublisher, LatencyHistogram
    src = _MixedSrc(Hist, seed)
    rec = fr.FlightRecorder(capacity=256)
    pub = Pub(node, None, recorder=rec, sources=[src])
    out = []
    for i in range(n):
        src.advance()
        for _ in range(i % 3):
            rec.record("frame.send", node=node)
        rec.record("migrate.begin", node=node)
        out.append(pub.frame(now=10.0 + i))
    return out


def _specs(mod):
    return [
        mod.SloSpec("stale", "staleness.w", 8.0, source="p99", window_s=30.0,
                    min_samples=1, p99_scale=1.0),
        mod.SloSpec("apply-p99", "apply.w", 0.02, source="p99", window_s=30.0,
                    min_samples=1),
        mod.SloSpec("push-rate", "pushes", 30.0, source="rate", window_s=5.0),
    ]


def _aggregate(side, frames_by_node):
    """Rows, verdicts and breach timeline of ``side``'s aggregator (with an
    SLO engine) over the same frames, ingested at fixed clocks."""
    if side == "jax":
        from parameter_server_tpu.core import flightrec as fr
        from parameter_server_tpu.core.telemetry import TelemetryAggregator as Agg
        from parameter_server_tpu.utils import slo as slo_mod
    else:
        from parameter_server_tpu_torch.utils import slo as slo_mod

        fr, Agg = flightrec, TelemetryAggregator
    eng = slo_mod.SloEngine(_specs(slo_mod), recorder=fr.FlightRecorder(capacity=256))
    agg = Agg(slo=eng, window=16)
    n = len(next(iter(frames_by_node.values())))
    for i in range(n):
        for node, frames in sorted(frames_by_node.items()):
            agg.ingest(node, frames[i], now=10.0 + i)
    rows = {node: agg.rows(node) for node in agg.nodes()}
    verdicts = {node: (v.healthy, v.breaches, v.observed)
                for node, v in eng.evaluate(now=20.0).items()}
    return rows, verdicts, eng.breach_timeline(now=20.0)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_publishers_build_equal_frames_from_equal_sources(seed):
    assert _frames("port", "S0", seed) == _frames("jax", "S0", seed)


@pytest.mark.parametrize("frames_of", ["port", "jax"])
def test_each_aggregator_ingests_the_other_packages_frames(frames_of):
    """The JAX aggregator ingests the port's frames and the port's the JAX
    ones: the rows, verdicts and breach timelines equal each other."""
    frames = {node: _frames(frames_of, node, seed)
              for seed, node in enumerate(("S0", "S1", "W0"))}
    port = _aggregate("port", frames)
    jax_side = _aggregate("jax", frames)
    assert port[0] == jax_side[0]
    assert port[1] == jax_side[1]
    assert port[2] == jax_side[2]
    assert any(row.get("breaches") for rows in port[0].values() for row in rows)


@pytest.mark.parametrize("builder", ["device_plane_specs", "serving_plane_specs",
                                     "compression_plane_specs", "durability_plane_specs",
                                     "tracing_plane_specs", "consistency_plane_specs"])
def test_plane_spec_builders_equal_the_jax_package(builder):
    import dataclasses

    from parameter_server_tpu.utils import slo as jax_slo
    from parameter_server_tpu_torch.utils import slo as port_slo

    mine = getattr(port_slo, builder)()
    theirs = getattr(jax_slo, builder)()
    assert [dataclasses.asdict(s) for s in mine] == [dataclasses.asdict(s) for s in theirs]


def test_slo_verdicts_equal_on_one_series():
    """One seeded gauge, counter and digest series through both engines:
    the same verdicts at every evaluation and the same breach timeline."""
    from parameter_server_tpu.utils import slo as jax_slo
    from parameter_server_tpu.utils.trace import LatencyHistogram as JaxHist
    from parameter_server_tpu_torch.utils import slo as port_slo

    from parameter_server_tpu.core import flightrec as jax_flightrec

    def run(mod, hist_cls, fr):
        eng = mod.SloEngine([
            mod.SloSpec("lag", "lag", 10.0, window_s=20.0),
            *_specs(mod),
        ], recorder=fr.FlightRecorder(capacity=256))
        rng = np.random.default_rng(7)
        h = hist_cls()
        pushes = 0
        out = []
        for i in range(40):
            t = 100.0 + 2.0 * i
            eng.observe("W0", "lag", float(rng.uniform(0, 20)), now=t)
            pushes += int(rng.integers(0, 120))
            eng.ingest_counters("W0", {"pushes": pushes}, t)
            for v in rng.exponential(6.0, size=3):
                h.record(float(v))
            eng.observe("W0", "staleness.w", h.to_dict(), now=t)
            v = eng.evaluate(now=t)["W0"]
            out.append((v.healthy, v.breaches, v.observed))
        return out, eng.breach_timeline(now=200.0), eng.breach_seconds(now=200.0)

    mine = run(port_slo, LatencyHistogram, flightrec)
    theirs = run(jax_slo, JaxHist, jax_flightrec)
    assert mine == theirs
    assert mine[1]  # the series breaches and clears
