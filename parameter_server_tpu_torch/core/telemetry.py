"""TelemetryBus: live, delta-encoded per-node telemetry -> scheduler ring.

The port's copy of ``parameter_server_tpu/core/telemetry.py`` (host code,
stdlib only), over the port's flight recorder, ``RotatingJsonlWriter`` and
``LatencyHistogram``: frames and derived rows equal the JAX module's for the
same inputs, so a JAX aggregator ingests the port's frames and the reverse.

The flight recorder and the SLO verdicts are the *postmortem* half of
observability; this module is the live half — the layer the serving
plane's admission control reads its ``SloEngine.healthy()`` signal from.

Two halves, one wire verb:

- :class:`TelemetryPublisher` runs on every node.  Each call to
  :meth:`~TelemetryPublisher.frame` produces one **delta-encoded** frame —
  transport-counter deltas (cumulative counters differenced against the
  previous frame), per-link :class:`~parameter_server_tpu_torch.utils.trace.LatencyHistogram`
  *bucket* deltas, a flight-recorder event-rate summary (kind -> count of
  events journaled since the last frame, tracked by recorder ``seq``
  watermark), and any named digest series from attached sources (the
  KVWorker staleness histograms).  Delta framing keeps the wire cost
  proportional to what CHANGED since the last heartbeat, not to run length.
- :class:`TelemetryAggregator` runs on the scheduler.  It deduplicates by
  per-node frame ``seq``, rebases node-monotonic stamps into the scheduler
  clock domain via ``FleetMonitor.clock_offset``, reconstructs cumulative
  counters/histograms from the deltas, appends one derived row per frame to
  a bounded per-node ring (JSONL-spillable through
  :class:`~parameter_server_tpu_torch.core.fleet.RotatingJsonlWriter`), and runs
  ``SloEngine.evaluate()`` on every arrival — so ``healthy(node)`` is
  always current and ``slo.breach`` / ``slo.clear`` fire in real time, not
  at dump time.

Transport: frames ride the ``TELEMETRY`` CONTROL verb
(``core/manager.py``), published at heartbeat cadence by
``Manager.send_heartbeat`` when a publisher is attached
(``mgr.telemetry_pub = TelemetryPublisher(...)``); the scheduler ingests in
``Manager._on_telemetry`` when an aggregator is attached
(``sched.telemetry = TelemetryAggregator(...)``).  ``tools/pstop.py``
renders the aggregator's ring (or its JSONL spill) as a live fleet console.
"""

from __future__ import annotations

import collections
import json
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.fleet import RotatingJsonlWriter
from parameter_server_tpu_torch.utils.trace import LatencyHistogram

#: frame format version (bumped on incompatible changes).
FRAME_VERSION = 1


def delta_digest(prev: Optional[dict], cur: Optional[dict]) -> Optional[dict]:
    """Sparse bucket delta between two CUMULATIVE histogram digests.

    Returns a digest dict (``LatencyHistogram.to_dict`` shape) holding only
    the samples recorded between ``prev`` and ``cur``, or None when nothing
    new was recorded.  A reset (any count moving backwards — recorder
    restarted) falls back to the full current digest rather than inventing
    negative mass; the aggregator's cumulative reconstruction then
    over-counts that one boundary, which is the standard delta-encoding
    trade for restart tolerance.
    """
    if not cur or not cur.get("count"):
        return None
    if not prev or not prev.get("count"):
        return dict(cur)
    if cur["count"] < prev["count"]:
        return dict(cur)  # reset fallback
    buckets: Dict[str, int] = {}
    prev_b = prev.get("b") or {}
    for i, c in (cur.get("b") or {}).items():
        d = int(c) - int(prev_b.get(i, 0))
        if d < 0:
            return dict(cur)  # reset fallback
        if d:
            buckets[i] = d
    count = int(cur["count"]) - int(prev["count"])
    if count <= 0:
        return None
    return {
        "count": count,
        "sum_s": round(max(float(cur.get("sum_s", 0.0)) - float(prev.get("sum_s", 0.0)), 0.0), 9),
        # upper bound: the exact inter-frame max is not tracked, and the
        # cumulative max is what percentile() clamps against anyway
        "max_s": cur.get("max_s", 0.0),
        "b": buckets,
    }


class TelemetryPublisher:
    """Node-side frame builder.  One instance per logical node.

    ``van``: this node's Van stack — its ``.inner`` chain is walked for
    layer ``counters()`` and the first MeteredVan's per-link digests
    (``node_digests``: only links this node ORIGINATED, so no link is
    reported twice fleet-wide).  ``sources``: extra objects contributing
    ``counters()`` dicts and/or ``staleness_digests()`` named cumulative
    histogram series (e.g. a :class:`~parameter_server_tpu_torch.kv.worker.KVWorker`).
    ``recorder``: flight recorder to summarize (default: the process-wide
    one); only events stamped ``node=<this node>`` are counted, so the
    shared in-process ring is attributed, not multiply reported.
    ``verdicts``: optional zero-arg callable returning a JSON-safe local
    SLO verdict blob to ride along (a node running its own engine).
    """

    def __init__(
        self,
        node_id: str,
        van=None,
        *,
        recorder: Optional[flightrec.FlightRecorder] = None,
        sources: tuple = (),
        verdicts: Optional[Callable[[], dict]] = None,
    ) -> None:
        self.node_id = node_id
        self.van = van
        self._recorder = recorder
        self.sources: List[object] = list(sources)
        self.verdicts_fn = verdicts
        self._lock = threading.Lock()
        self._seq = 0
        self._prev_counters: Dict[str, float] = {}
        self._prev_links: Dict[str, dict] = {}
        self._prev_series: Dict[str, dict] = {}
        self._prev_latency: Dict[str, dict] = {}
        #: flight-recorder seq watermark: events <= this are already reported.
        self._ev_seq = -1

    def add_source(self, *sources) -> "TelemetryPublisher":
        with self._lock:
            self.sources.extend(sources)
        return self

    def _cumulative_counters(self) -> Dict[str, float]:
        cur: Dict[str, float] = {}
        if self.van is not None:
            cur.update(flightrec._walk_counters(self.van))
        for src in self.sources:
            get = getattr(src, "counters", None)
            if not callable(get):
                continue
            try:
                for k, v in get().items():
                    if isinstance(v, (int, float)):
                        cur[k] = cur.get(k, 0) + v
            except Exception:  # pragma: no cover — telemetry never crashes
                pass  # the node it observes
        return cur

    def frame(self, now: Optional[float] = None) -> dict:
        """Build the next delta frame (thread-safe, advances the seq)."""
        now = time.monotonic() if now is None else now
        with self._lock:
            self._seq += 1
            out: dict = {
                "v": FRAME_VERSION,
                "node": self.node_id,
                "seq": self._seq,
                "t_mono_s": now,
            }
            # -- transport + source counter deltas ---------------------------
            cur = self._cumulative_counters()
            deltas: Dict[str, float] = {}
            for k, v in cur.items():
                d = v - self._prev_counters.get(k, 0)
                if d:
                    deltas[k] = round(d, 6) if isinstance(d, float) else d
            self._prev_counters = cur
            if deltas:
                out["counters"] = deltas
            # -- per-link wire digest deltas ---------------------------------
            metered = (
                flightrec._find_metered(self.van)
                if self.van is not None else None
            )
            if metered is not None:
                links: Dict[str, dict] = {}
                digs = metered.node_digests(self.node_id)
                for link, d in digs.items():
                    prev = self._prev_links.get(link) or {}
                    row: Dict[str, object] = {}
                    for k in ("msgs", "bytes", "frame_bytes", "overhead_bytes"):
                        dv = int(d.get(k, 0)) - int(prev.get(k, 0))
                        if dv:
                            row[k] = dv
                    for k in ("send", "deliver"):
                        dd = delta_digest(prev.get(k), d.get(k))
                        if dd:
                            row[k] = dd
                    if row:
                        links[link] = row
                self._prev_links = digs
                if links:
                    out["links"] = links
            # -- flight-recorder event-rate summary --------------------------
            rec = self._recorder if self._recorder is not None else flightrec.get()
            counts: Dict[str, int] = {}
            for ev in rec.events_since(self._ev_seq):
                if ev["seq"] > self._ev_seq:
                    self._ev_seq = ev["seq"]
                if ev.get("node") != self.node_id:
                    continue  # shared per-process ring: attribute, don't echo
                kind = ev.get("kind")
                counts[kind] = counts.get(kind, 0) + 1
            if counts:
                out["events"] = counts
            # -- named cumulative digest series (staleness) ------------------
            series: Dict[str, dict] = {}
            for src in self.sources:
                get = getattr(src, "staleness_digests", None)
                if not callable(get):
                    continue
                try:
                    digests = get()
                except Exception:  # pragma: no cover — telemetry never crashes
                    continue
                for name, dig in digests.items():
                    dd = delta_digest(self._prev_series.get(name), dig)
                    self._prev_series[name] = dig
                    if dd:
                        series[name] = dd
            if series:
                out["staleness"] = series
            # -- device-plane latency digest series ---------------
            # Same delta framing, separate frame field: staleness rides a
            # unitless axis (pstop's STALE column takes the max-p99 across
            # the field), while these are seconds-axis apply attributions
            # (apply.<t> + host/h2d/dev splits from the ApplyLedger).
            lat: Dict[str, dict] = {}
            for src in self.sources:
                get = getattr(src, "latency_digests", None)
                if not callable(get):
                    continue
                try:
                    digests = get()
                except Exception:  # pragma: no cover — telemetry never crashes
                    continue
                for name, dig in digests.items():
                    dd = delta_digest(self._prev_latency.get(name), dig)
                    self._prev_latency[name] = dig
                    if dd:
                        lat[name] = dd
            if lat:
                out["digests"] = lat
            # -- local SLO verdicts ------------------------------------------
            if self.verdicts_fn is not None:
                try:
                    v = self.verdicts_fn()
                    if v:
                        out["verdicts"] = v
                except Exception:  # pragma: no cover — telemetry never crashes
                    pass
            seq_out = self._seq
        # journaled AFTER the watermark advanced, so the publish marker of
        # frame N is reported by frame N+1, never by itself
        flightrec.record("telemetry.publish", node=self.node_id, seq=seq_out)
        return out


class TelemetryAggregator:
    """Scheduler-side windowed per-node time-series ring.

    Attach to the scheduler's Manager (``sched.telemetry = aggregator``);
    every TELEMETRY frame then lands in :meth:`ingest`, which:

    1. drops duplicate/stale frames by per-node ``seq`` (journaled as
       ``telemetry.drop`` — a replayed frame must not double-count deltas);
    2. rebases the sender's monotonic stamp into the scheduler clock domain
       (``t_sched = t_node - clock_offset(node)``) when a ``fleet`` monitor
       is attached;
    3. folds counter/histogram deltas back into per-node cumulative state;
    4. feeds the attached :class:`~parameter_server_tpu_torch.utils.slo.SloEngine`
       (cumulative counters for gauge/rate specs, cumulative digests for
       p99 specs) and calls ``evaluate()`` — breach/clear fire on ARRIVAL;
    5. appends one derived row (rates, staleness quantiles, health) to a
       bounded per-node ring and the optional JSONL spill.

    Memory is bounded: ``window`` rows per node in the ring, plus one
    cumulative counter dict / histogram per (node, series).
    """

    def __init__(
        self,
        *,
        window: int = 256,
        slo=None,
        fleet=None,
        jsonl_path: Optional[str] = None,
        rotate_bytes: int = 0,
        config=None,
        evaluate_scope: str = "fleet",
    ) -> None:
        if evaluate_scope not in ("fleet", "node"):
            raise ValueError(
                f"evaluate_scope must be 'fleet' or 'node', "
                f"got {evaluate_scope!r}"
            )
        from parameter_server_tpu_torch.config import TelemetryConfig

        self.slo = slo
        self.fleet = fleet
        # ring sizing scales with fleet size: ``config`` is the
        # knob; a bare ``window=`` call synthesizes one that keeps the
        # legacy fixed-window behaviour for small fleets but still bounds
        # total retained rows once hundreds of publishers appear.
        self.config = config if config is not None else TelemetryConfig(
            window=window,
            ring_budget_rows=max(8192, window),
            min_window=min(8, window),
        )
        self.window = self.config.window
        #: "fleet" re-evaluates every node per ingest (breach/clear edges
        #: fire on ANY frame arrival — the live-cluster default); "node"
        #: evaluates only the frame's sender, for 200-publisher fleets
        #: where a per-ingest fleet sweep is O(fleet^2) per beat — the
        #: war-game runner pairs it with one full sweep per tick.
        self._evaluate_scope = evaluate_scope
        #: current scenario phase (war-game plane); None outside a run.
        self._phase: Optional[str] = None
        self._lock = threading.Lock()
        self._rings: Dict[str, collections.deque] = {}
        self._max_seq: Dict[str, int] = {}
        #: last frame timestamp per node, in the SENDER's clock (rate dt).
        self._last_t: Dict[str, float] = {}
        self._cum_counters: Dict[str, Dict[str, float]] = {}
        self._cum_series: Dict[Tuple[str, str], LatencyHistogram] = {}
        self._ev_totals: Dict[str, Dict[str, int]] = {}
        self._verdicts: Dict[str, dict] = {}
        self.frames = 0
        self.duplicates = 0
        self.late = 0
        #: per-node duplicate/stale-frame drops (control-plane self-metric:
        #: ring sizing is a scaling risk, so drops surface per node).
        self._drops: Dict[str, int] = {}
        self.writer: Optional[RotatingJsonlWriter] = (
            RotatingJsonlWriter(jsonl_path, rotate_bytes=rotate_bytes)
            if jsonl_path is not None
            else None
        )

    # -- ingest ---------------------------------------------------------------
    def ingest(self, node: str, frame: dict, now: Optional[float] = None) -> bool:
        """Fold one frame in; returns False for dropped (duplicate) frames."""
        now = time.monotonic() if now is None else now
        seq = int(frame.get("seq") or 0)
        with self._lock:
            have = self._max_seq.get(node, 0)
            if seq <= have:
                self.duplicates += 1
                self._drops[node] = self._drops.get(node, 0) + 1
                flightrec.record(
                    "telemetry.drop", node=node, seq=seq, have=have
                )
                return False
            self._max_seq[node] = seq
            t_node = float(frame.get("t_mono_s") or now)
            offset = None
            if self.fleet is not None:
                try:
                    offset = self.fleet.clock_offset(node)
                except Exception:  # pragma: no cover — a malformed clock row
                    offset = None  # must not drop the frame
            t_sched = t_node - (offset or 0.0)
            prev_t = self._last_t.get(node)
            dt = (t_node - prev_t) if prev_t is not None else None
            if dt is not None and dt < 0:
                # newer seq with an older stamp (clock step on the node):
                # keep the frame, but rates for this hop are meaningless
                self.late += 1
                dt = None
            self._last_t[node] = max(t_node, prev_t or t_node)
            # cumulative reconstruction
            cum = self._cum_counters.setdefault(node, {})
            for k, d in (frame.get("counters") or {}).items():
                if isinstance(d, (int, float)):
                    cum[k] = cum.get(k, 0) + d
            ev_tot = self._ev_totals.setdefault(node, {})
            for kind, c in (frame.get("events") or {}).items():
                ev_tot[kind] = ev_tot.get(kind, 0) + int(c)
            stale_stats: Dict[str, dict] = {}
            slo_digests: Dict[str, dict] = {}
            # only series a p99 spec reads need the full digest re-exported
            want_digest: frozenset = frozenset()
            if self.slo is not None:
                want_digest = frozenset(
                    s.metric
                    for s in getattr(self.slo, "specs", ())
                    if getattr(s, "source", "") == "p99"
                )
            for name, dd in (frame.get("staleness") or {}).items():
                h = self._cum_series.get((node, name))
                if h is None:
                    h = self._cum_series[(node, name)] = LatencyHistogram()
                try:
                    h.merge_dict(dd)
                except Exception:
                    continue  # a malformed series must not drop the frame
                stale_stats[name] = {
                    "count": h.count,
                    "p50": round(h.percentile(0.50), 6),
                    "p99": round(h.percentile(0.99), 6),
                }
                if name in want_digest:
                    slo_digests[name] = h.to_dict()
            # device-plane latency series: same cumulative fold, own frame
            # field + row field (seconds axis — consumers scale to ms)
            lat_stats: Dict[str, dict] = {}
            for name, dd in (frame.get("digests") or {}).items():
                h = self._cum_series.get((node, name))
                if h is None:
                    h = self._cum_series[(node, name)] = LatencyHistogram()
                try:
                    h.merge_dict(dd)
                except Exception:
                    continue  # a malformed series must not drop the frame
                lat_stats[name] = {
                    "count": h.count,
                    "p50": round(h.percentile(0.50), 6),
                    "p99": round(h.percentile(0.99), 6),
                }
                if name in want_digest:
                    slo_digests[name] = h.to_dict()
            d_msgs = d_bytes = 0
            deliver = LatencyHistogram()
            for row in (frame.get("links") or {}).values():
                d_msgs += int(row.get("msgs") or 0)
                d_bytes += int(row.get("bytes") or 0)
                if row.get("deliver"):
                    try:
                        deliver.merge(
                            LatencyHistogram.from_dict(row["deliver"])
                        )
                    except Exception:
                        pass
            if frame.get("verdicts") is not None:
                self._verdicts[node] = frame["verdicts"]
            mig = (
                ev_tot.get("migrate.begin", 0)
                - ev_tot.get("migrate.commit", 0)
                - ev_tot.get("migrate.abort", 0)
            )
            cum_snapshot = dict(cum)
            self.frames += 1
        # continuous evaluation (outside the ring lock: SloEngine has its
        # own state, and recorder hooks must not run under our lock)
        healthy = None
        breaches: List[str] = []
        if self.slo is not None:
            self.slo.ingest_counters(node, cum_snapshot, t_sched)
            for name, dig in slo_digests.items():
                self.slo.observe(node, name, dig, t_sched)
            if self._evaluate_scope == "node":
                try:
                    self.slo.evaluate(now, nodes=[node])
                except TypeError:  # engine predates the nodes= restriction
                    self.slo.evaluate(now)
            else:
                self.slo.evaluate(now)
            healthy = self.slo.healthy(node)
            breaches = sorted(
                name for (name, n), hit in self.slo._breached.items()
                if hit and n == node
            )
        flags: List[str] = []
        if self.fleet is not None:
            try:
                flags = self.fleet.stragglers(now).get(node, [])
            except Exception:  # pragma: no cover — detector must not drop
                flags = []  # the frame
        row: dict = {
            "node": node,
            "seq": seq,
            "t": round(t_sched, 6),
            "t_ingest": round(now, 6),
        }
        if dt is not None and dt > 0:
            row["dt_s"] = round(dt, 6)
            row["msgs_per_s"] = round(d_msgs / dt, 2)
            row["bytes_per_s"] = round(d_bytes / dt, 1)
            n_ev = sum((frame.get("events") or {}).values())
            row["events_per_s"] = round(n_ev / dt, 2)
            # serving plane: per-beat read/shed rates off the
            # frame's counter DELTAS (sparse: only nodes that serve)
            fc = frame.get("counters") or {}
            d_ro = fc.get("ro_pulls")
            if d_ro:
                row["ro_per_s"] = round(d_ro / dt, 2)
            d_shed = fc.get("serve_shed")
            if d_shed:
                row["shed_per_s"] = round(d_shed / dt, 2)
        # serving plane: lifetime cache hit ratio off the CUMULATIVE
        # counters (a rate would thrash at low traffic)
        looked = cum_snapshot.get("cache_hits", 0) + cum_snapshot.get(
            "cache_misses", 0
        )
        if looked:
            row["cache_hit_pct"] = round(
                100.0 * cum_snapshot.get("cache_hits", 0) / looked, 2
            )
        # quantized wire plane: lifetime compressed-vs-raw ratio
        # off the CUMULATIVE MeteredVan byte counters (same reasoning)
        raw = cum_snapshot.get("wire_raw_bytes", 0)
        if raw and raw != cum_snapshot.get("wire_bytes", 0):
            row["cmpr_pct"] = round(
                100.0 * cum_snapshot.get("wire_bytes", 0) / raw, 2
            )
        # hierarchical push: group-reduced PUSH fan-in — the
        # wire applies a server saw as a % of the raw member pushes they
        # stand for (100 = no pre-reduction, 25 = 4-member groups fully
        # merged).  Off the server's CUMULATIVE group counters.
        graw = cum_snapshot.get("group_members", 0)
        if graw:
            row["grp_pct"] = round(
                100.0 * cum_snapshot.get("group_pushes", 0) / graw, 2
            )
        # durability plane: snapshot staleness as a first-class
        # derived field.  The server reports ckpt_age_s as a GAUGE (seconds
        # since last snap_commit/restore), so the reconstructed cumulative
        # value IS the age — surface it for pstop's CKPT column and the
        # ckpt-age SLO without any extra plumbing.
        if "ckpt_age_s" in cum_snapshot:
            row["ckpt_age_s"] = round(float(cum_snapshot["ckpt_age_s"]), 3)
        # consistency plane: the server's mode/bound ride the
        # counter channel as GAUGES (delta-framed like ckpt_age_s), so the
        # reconstructed cumulative value IS the current setting — surface
        # them for pstop's MODE/BOUND columns and the live-retune audit.
        if "consist_mode" in cum_snapshot:
            row["consist_mode"] = int(cum_snapshot["consist_mode"])
            row["consist_bound"] = int(cum_snapshot.get("consist_bound", 0))
        if deliver.count:
            row["deliver_p99_ms"] = round(1e3 * deliver.percentile(0.99), 3)
            row["deliver_p50_ms"] = round(1e3 * deliver.percentile(0.50), 3)
        if stale_stats:
            row["staleness"] = stale_stats
        if lat_stats:
            row["digests"] = lat_stats
        if frame.get("events"):
            row["events"] = dict(frame["events"])
        if mig > 0:
            row["migrations_active"] = mig
        if healthy is not None:
            row["healthy"] = healthy
            if breaches:
                row["breaches"] = breaches
        if flags:
            row["straggler"] = flags
        row["counters"] = cum_snapshot
        with self._lock:
            ring = self._rings.get(node)
            if ring is None:
                # a NEW publisher re-derives the fleet-wide per-node cap
                # and re-caps existing rings in place, so the total stays
                # near ``config.ring_budget_rows`` at any fleet size.
                cap = self.config.node_window(len(self._rings) + 1)
                if self._rings and next(iter(self._rings.values())).maxlen != cap:
                    for n, r in self._rings.items():
                        self._rings[n] = collections.deque(r, maxlen=cap)
                ring = self._rings[node] = collections.deque(maxlen=cap)
            ring.append(row)
            # control-plane self-metrics: the aggregator's own
            # state rides every derived row, so ring pressure and dedup
            # drops are visible downstream (pstop DRP column) without a
            # side channel.  Occupancy is post-append: cap hit => eviction.
            row["ctl"] = {
                "ring": len(ring),
                "ring_cap": ring.maxlen,
                "drops": self._drops.get(node, 0),
            }
            # war-game extras ride only when the planes exist, so the ctl
            # dict stays exactly the triple everywhere else.
            if self._phase is not None:
                row["ctl"]["phase"] = self._phase
            if self.slo is not None and hasattr(self.slo, "breach_seconds"):
                row["ctl"]["breach_min"] = round(
                    self.slo.breach_seconds() / 60.0, 4
                )
        if self.writer is not None:
            self.writer.write_line(json.dumps(row))
        return True

    # -- war-game plane --------------------------------------------
    def set_phase(self, phase: Optional[str]) -> None:
        """Stamp the live scenario phase onto subsequent ctl blocks (and
        pstop's fleet footer).  ``None`` ends the run — ctl reverts to the
        bare ring/cap/drops triple."""
        self._phase = phase

    @property
    def phase(self) -> Optional[str]:
        return self._phase

    def breach_minutes(self) -> float:
        """Running fleet-wide SLO-breach-minutes off the attached engine
        (0.0 when no engine — or an engine without breach accounting — is attached)."""
        if self.slo is None or not hasattr(self.slo, "breach_seconds"):
            return 0.0
        return self.slo.breach_seconds() / 60.0

    # -- reads ----------------------------------------------------------------
    def nodes(self) -> List[str]:
        with self._lock:
            return sorted(self._rings)

    def rows(self, node: str) -> List[dict]:
        """This node's retained derived rows, oldest first."""
        with self._lock:
            return list(self._rings.get(node, ()))

    def latest(self) -> Dict[str, dict]:
        """Most recent derived row per node — what ``pstop`` renders."""
        with self._lock:
            return {n: r[-1] for n, r in self._rings.items() if r}

    def staleness_quantile(self, node: str, series: str, q: float) -> float:
        """Quantile of a node's cumulative staleness series (0.0 if unseen)."""
        with self._lock:
            h = self._cum_series.get((node, series))
            return h.percentile(q) if h is not None and h.count else 0.0

    def event_totals(self, node: str) -> Dict[str, int]:
        with self._lock:
            return dict(self._ev_totals.get(node, {}))

    def counters(self) -> dict:
        """Dashboard-mergeable ingest counters."""
        with self._lock:
            return {
                "telemetry_frames": self.frames,
                "telemetry_dup_frames": self.duplicates,
                "telemetry_late_frames": self.late,
            }

    def drops(self, node: str) -> int:
        """Cumulative duplicate/stale-frame drops for ``node``."""
        with self._lock:
            return self._drops.get(node, 0)

    def flush_jsonl(self) -> None:
        if self.writer is not None:
            self.writer.sync()

    def close(self) -> None:
        if self.writer is not None:
            self.writer.close()
