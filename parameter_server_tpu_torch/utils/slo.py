"""Declarative SLOs over the observability plane's existing series.

The port's copy of ``parameter_server_tpu/utils/slo.py`` (host code, stdlib
only): the same specs, windows, verdicts and plane-spec builders, so both
packages reach the same verdicts on one series.  The read-heavy serving
plane needs breach detection before admission control / load shedding can
act; this module is that substrate.  An
:class:`SloSpec` names a metric, a ceiling, and how to read the samples
(instantaneous gauge, windowed rate of a cumulative counter, or windowed
p99 of a cumulative :class:`~parameter_server_tpu_torch.utils.trace.LatencyHistogram`
digest); an :class:`SloEngine` holds per-(node, metric) rolling windows fed
from the series the plane already produces — FleetMonitor snapshot rows,
``transport_counters`` dicts, MeteredVan per-link digests — and turns them
into per-node health verdicts.

Breaches are edge-triggered into the flight recorder: ``slo.breach`` when a
spec first exceeds its ceiling on a node, ``slo.clear`` when it recovers —
so the postmortem timeline shows WHEN health flipped, not a line per sweep.
The verdict objects themselves are level-triggered (current truth), which
is what an admission controller will poll.

Examples::

    specs = [
        SloSpec("inbound-p99", "push_p99_ms", 50.0),            # gauge
        SloSpec("retransmit-rate", "retransmits", 10.0,
                source="rate", window_s=5.0),                    # per-second
        SloSpec("bytes-per-step", "wire_bytes_per_step", 2e6),   # gauge
    ]
    eng = SloEngine(specs)
    eng.ingest_fleet(fleet)               # each monitor sweep
    eng.ingest_counters("S1", transport_counters(van))
    verdicts = eng.evaluate()             # {node: SloVerdict}
"""

from __future__ import annotations

import collections
import dataclasses
import time
from typing import Deque, Dict, List, Optional, Tuple

from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.utils.trace import LatencyHistogram

_SOURCES = ("gauge", "rate", "p99")


@dataclasses.dataclass(frozen=True)
class SloSpec:
    """One service-level objective: ``metric`` must stay <= ``max_value``.

    ``source`` picks the sample semantics:

    - ``"gauge"``: latest observed value inside the window (snapshot rows
      like ``push_p99_ms`` are already derived — compare directly);
    - ``"rate"``: (last - first) / elapsed over the window, for CUMULATIVE
      counters (``retransmits``, ``wire_bytes``) — ``max_value`` is per
      second;
    - ``"p99"``: windowed p99 of a cumulative LatencyHistogram digest
      series, scaled by ``p99_scale`` — the window's delta histogram is
      reconstructed by differencing bucket counts, so the p99 covers only
      samples recorded inside the window, not the whole run.

    ``p99_scale`` converts the histogram's native seconds axis into the
    units ``max_value`` is written in: the default ``1e3`` reads latency
    digests in milliseconds; unitless series that reuse the axis as a raw
    count — the staleness version-lag digests — pass ``1.0``
    ("p99 staleness <= 8 versions" is ``SloSpec("stale", "staleness.w",
    8.0, source="p99", p99_scale=1.0)``).
    """

    name: str
    metric: str
    max_value: float
    source: str = "gauge"
    window_s: float = 10.0
    min_samples: int = 1
    p99_scale: float = 1e3

    def __post_init__(self) -> None:
        if self.source not in _SOURCES:
            raise ValueError(
                f"SloSpec {self.name!r}: source must be one of {_SOURCES}, "
                f"got {self.source!r}"
            )
        if self.window_s <= 0:
            raise ValueError(f"SloSpec {self.name!r}: window_s must be > 0")
        if self.p99_scale <= 0:
            raise ValueError(f"SloSpec {self.name!r}: p99_scale must be > 0")


@dataclasses.dataclass
class SloVerdict:
    """Per-node health verdict from one :meth:`SloEngine.evaluate` sweep."""

    node: str
    healthy: bool
    #: spec name -> (observed value, ceiling) for every breached spec.
    breaches: Dict[str, Tuple[float, float]]
    #: spec name -> observed value for every spec that had enough samples.
    observed: Dict[str, float]


class SloEngine:
    """Rolling-window evaluator for a set of :class:`SloSpec` objects.

    Feed it with any mix of :meth:`observe` (raw samples),
    :meth:`ingest_fleet` (FleetMonitor snapshot rows + per-link deliver
    digests), and :meth:`ingest_counters` (cumulative counter dicts);
    :meth:`evaluate` computes windowed values per node and edge-triggers
    ``slo.breach`` / ``slo.clear`` flight-recorder events on transitions.
    """

    def __init__(
        self,
        specs: List[SloSpec],
        *,
        recorder: Optional[flightrec.FlightRecorder] = None,
    ) -> None:
        names = [s.name for s in specs]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate SloSpec names: {sorted(names)}")
        self.specs = list(specs)
        self._recorder = recorder
        #: metrics any spec reads — bulk ingest skips everything else.
        self._spec_metrics = frozenset(s.metric for s in self.specs)
        #: widest window any spec holds over a metric: samples older than
        #: this are dead to EVERY spec, so ``_windowed`` may expire them
        #: from the series for good (amortized O(1) per sample) instead of
        #: re-scanning past them on every evaluation.
        self._max_window: Dict[str, float] = {}
        for s in self.specs:
            self._max_window[s.metric] = max(
                self._max_window.get(s.metric, 0.0), s.window_s
            )
        #: (node, metric) -> deque of (t, value-or-digest-dict) samples.
        self._series: Dict[Tuple[str, str], Deque[Tuple[float, object]]] = {}
        #: series keys that ever saw an out-of-order sample; only these pay
        #: a sort in ``_windowed`` — the common in-order path appends are
        #: already time-sorted.
        self._unsorted: set = set()
        self._last_obs_t: Dict[Tuple[str, str], float] = {}
        #: (spec name, node) -> currently breached?  (edge-trigger state)
        self._breached: Dict[Tuple[str, str], bool] = {}
        self._nodes: set = set()
        #: high-water mark of evaluate's ``now`` — late re-evaluations are
        #: clamped forward so an out-of-order caller cannot shrink the
        #: window backwards and retro-flip an edge-triggered breach.
        self._last_now: Optional[float] = None
        #: (spec name, node) -> engine time the CURRENT breach opened at.
        self._breach_open: Dict[Tuple[str, str], float] = {}
        #: (spec name, node) -> accumulated seconds over CLOSED breaches.
        self._breach_acc_s: Dict[Tuple[str, str], float] = {}
        #: closed breach intervals, in close order:
        #: {"slo", "node", "t0", "t1"} — the scorecard's breach timeline.
        self._breach_log: List[dict] = []

    # -- ingest --------------------------------------------------------------
    def observe(
        self, node: str, metric: str, value, now: Optional[float] = None
    ) -> None:
        """Record one sample.  ``value`` is a number for gauge/rate metrics
        or a LatencyHistogram digest dict (``to_dict`` form) for p99 ones."""
        now = time.monotonic() if now is None else now
        self._nodes.add(node)
        key = (node, metric)
        dq = self._series.get(key)
        if dq is None:
            dq = self._series[key] = collections.deque(maxlen=1024)
        last = self._last_obs_t.get(key)
        if last is not None and now < last:
            self._unsorted.add(key)
        else:
            self._last_obs_t[key] = now
        dq.append((now, value))

    def ingest_fleet(self, fleet, now: Optional[float] = None) -> None:
        """Sample every numeric field of each FleetMonitor snapshot row,
        plus each node's cumulative inbound deliver digest (for ``p99``
        specs over ``inbound_deliver``)."""
        now = time.monotonic() if now is None else now
        for node, row in fleet.snapshot(now).items():
            self._nodes.add(node)  # verdict coverage even with no spec metric
            for metric, value in row.items():
                if metric in self._spec_metrics and isinstance(value, (int, float)):
                    self.observe(node, metric, float(value), now)
        wants_inbound = any(
            s.source == "p99" and s.metric == "inbound_deliver"
            for s in self.specs
        )
        if wants_inbound:
            with fleet._lock:
                links = dict(fleet._links)
            for node in fleet.nodes():
                h = fleet._inbound_hist(links, node)
                if h.count:
                    self.observe(node, "inbound_deliver", h.to_dict(), now)

    def ingest_counters(
        self, node: str, counters: dict, now: Optional[float] = None
    ) -> None:
        """Sample a cumulative counter dict (``transport_counters`` output,
        a server's ``counters()``) for ``rate`` and ``gauge`` specs.  Only
        metrics some spec actually reads are retained — the telemetry plane
        calls this once per frame with dozens of transport counters."""
        now = time.monotonic() if now is None else now
        self._nodes.add(node)  # verdict coverage even with no spec metric
        for metric, value in counters.items():
            if metric in self._spec_metrics and isinstance(value, (int, float)):
                self.observe(node, metric, float(value), now)

    # -- evaluation ----------------------------------------------------------
    def _windowed(
        self, spec: SloSpec, node: str, now: float
    ) -> Optional[float]:
        """Current value of ``spec`` on ``node``, or None without enough
        in-window samples."""
        dq = self._series.get((node, spec.metric))
        if not dq:
            return None
        cutoff = now - spec.window_s
        # order by sample time, not append order: the live telemetry plane
        # delivers frames out of order, and a LATE old sample
        # must not masquerade as the window's latest gauge / rate endpoint.
        # A series that only ever appended in order is already time-sorted;
        # only series flagged by ``observe`` pay a filter + sort.
        if (node, spec.metric) in self._unsorted:
            window: object = sorted(
                (s for s in dq if s[0] >= cutoff), key=lambda s: s[0]
            )
        else:
            # time-sorted series: expire samples no spec can ever read
            # again (evaluate's ``now`` only moves forward, so neither can
            # any cutoff) — each sample is popped at most once across the
            # engine's whole lifetime instead of re-scanned every sweep
            expire = now - self._max_window[spec.metric]
            while dq and dq[0][0] < expire:
                dq.popleft()
            if not dq:
                return None
            if dq[0][0] >= cutoff:
                window = dq  # everything in window — evaluate in place
            else:
                window = [s for s in dq if s[0] >= cutoff]
        if len(window) < spec.min_samples:
            return None
        if spec.source == "gauge":
            return float(window[-1][1])
        if spec.source == "rate":
            if len(window) < 2:
                return None
            (t0, v0), (t1, v1) = window[0], window[-1]
            if t1 <= t0:
                return None
            return (float(v1) - float(v0)) / (t1 - t0)
        # p99 over the window's delta histogram
        if len(window) < 2:
            return None
        first, last = window[0][1], window[-1][1]
        delta = _delta_hist(first, last)
        if delta.count < spec.min_samples:
            return None
        return spec.p99_scale * delta.percentile(0.99)

    def evaluate(
        self,
        now: Optional[float] = None,
        nodes: Optional[List[str]] = None,
    ) -> Dict[str, SloVerdict]:
        """Per-node verdicts; edge-triggers breach/clear recorder events.

        ``now`` only moves forward: an evaluation stamped EARLIER than a
        previous one (a late telemetry frame re-triggering the sweep) is
        evaluated at the high-water clock, so an already-fired breach edge
        cannot retro-flip on stale time.

        ``nodes`` restricts the sweep to a subset (the 200-publisher
        war-game aggregator evaluates only the frame's sender per ingest
        — O(specs) instead of O(fleet x specs) — and runs one full-fleet
        sweep per runner tick).  Edge/interval state for unlisted nodes
        is untouched.
        """
        now = time.monotonic() if now is None else now
        if self._last_now is not None and now < self._last_now:
            now = self._last_now
        self._last_now = now
        sweep = (
            sorted(self._nodes) if nodes is None
            else sorted(self._nodes.intersection(nodes))
        )
        # explicit None test: an EMPTY FlightRecorder is falsy (__len__ == 0),
        # and the first breach is exactly when the injected recorder is empty
        rec = (
            flightrec.record if self._recorder is None
            else self._recorder.record
        )
        out: Dict[str, SloVerdict] = {}
        for node in sweep:
            breaches: Dict[str, Tuple[float, float]] = {}
            observed: Dict[str, float] = {}
            for spec in self.specs:
                value = self._windowed(spec, node, now)
                if value is None:
                    continue
                observed[spec.name] = value
                key = (spec.name, node)
                was = self._breached.get(key, False)
                is_breach = value > spec.max_value
                if is_breach:
                    breaches[spec.name] = (value, spec.max_value)
                if is_breach and not was:
                    # interval accounting opens on the same clamped clock
                    # the edge fired at, so out-of-order re-evaluations can
                    # neither reopen a closed interval nor shrink this one.
                    self._breach_open[key] = now
                    rec(
                        "slo.breach",
                        node=node,
                        slo=spec.name,
                        metric=spec.metric,
                        value=round(value, 4),
                        limit=spec.max_value,
                    )
                elif was and not is_breach:
                    t0 = self._breach_open.pop(key, now)
                    dur = max(now - t0, 0.0)
                    self._breach_acc_s[key] = (
                        self._breach_acc_s.get(key, 0.0) + dur
                    )
                    self._breach_log.append(
                        {"slo": spec.name, "node": node, "t0": t0, "t1": now}
                    )
                    rec(
                        "slo.clear",
                        node=node,
                        slo=spec.name,
                        metric=spec.metric,
                        value=round(value, 4),
                        limit=spec.max_value,
                    )
                self._breached[key] = is_breach
            out[node] = SloVerdict(
                node=node,
                healthy=not breaches,
                breaches=breaches,
                observed=observed,
            )
        return out

    def healthy(self, node: str) -> bool:
        """Level-triggered health of one node per the LAST evaluate sweep —
        the poll the future serving plane's admission control consumes."""
        return not any(
            breached and name_node[1] == node
            for name_node, breached in self._breached.items()
        )

    # -- breach-interval accounting ------------------------------------------
    def breach_seconds(
        self,
        *,
        node: Optional[str] = None,
        spec: Optional[str] = None,
        now: Optional[float] = None,
    ) -> float:
        """Total breached seconds, integrated from the edge-trigger stream.

        Sums every CLOSED breach interval plus the open tail of any breach
        still in flight, measured to ``now`` (clamped to the evaluate
        high-water clock — the same forward-only time the edges fired on,
        so a stale caller clock cannot shrink an open interval).  Filter by
        ``node`` and/or ``spec`` name; divide by 60 for the scorecard's
        SLO-breach-minutes.
        """
        if now is None:
            now = self._last_now if self._last_now is not None else 0.0
        elif self._last_now is not None and now < self._last_now:
            now = self._last_now
        total = 0.0
        for (sname, n), acc in self._breach_acc_s.items():
            if (node is None or n == node) and (spec is None or sname == spec):
                total += acc
        for (sname, n), t0 in self._breach_open.items():
            if (node is None or n == node) and (spec is None or sname == spec):
                total += max(now - t0, 0.0)
        return total

    def breach_timeline(self, now: Optional[float] = None) -> List[dict]:
        """Every breach interval — closed ones verbatim, open ones extended
        to ``now`` (high-water clamped) with ``"open": True`` — sorted by
        start time.  This is the per-node × per-SLO timeline the war-game
        scorecard integrates."""
        if now is None:
            now = self._last_now if self._last_now is not None else 0.0
        elif self._last_now is not None and now < self._last_now:
            now = self._last_now
        out = [dict(iv) for iv in self._breach_log]
        for (sname, n), t0 in self._breach_open.items():
            out.append(
                {"slo": sname, "node": n, "t0": t0,
                 "t1": max(now, t0), "open": True}
            )
        out.sort(key=lambda iv: (iv["t0"], iv["node"], iv["slo"]))
        return out


def device_plane_specs(
    table: str = "w",
    *,
    apply_p99_ms: float = 250.0,
    backlog_bundles: int = 8,
    window_s: float = 10.0,
) -> List[SloSpec]:
    """The device-plane SLO pair, wired to the ApplyLedger series.

    - ``apply-p99``: windowed p99 of the ``apply.<table>`` total-latency
      digest (submit -> retire, milliseconds) the ledger publishes through
      the telemetry ``digests`` channel;
    - ``apply-backlog``: the ``inflight_bundles`` gauge riding the server's
      ``counters()`` — the canonical async-PS overload signal.  Breaching
      it flips ``SloEngine.healthy(node)``, the same signal the server's
      soft-backpressure ``__busy__`` hint mirrors locally.
    """
    return [
        SloSpec(
            "apply-p99",
            f"apply.{table}",
            apply_p99_ms,
            source="p99",
            window_s=window_s,
        ),
        SloSpec(
            "apply-backlog",
            "inflight_bundles",
            float(backlog_bundles),
            source="gauge",
            window_s=window_s,
        ),
    ]


def serving_plane_specs(
    table: str = "w",
    *,
    ro_p99_ms: float = 50.0,
    backlog_bundles: int = 8,
    window_s: float = 10.0,
) -> List[SloSpec]:
    """The serving-plane SLO pair, for admission control.

    - ``ro-p99``: windowed p99 of the ``ro_pull.<table>`` digest — the
      server-side latency of the read-only fast path, published through
      the same telemetry ``digests`` channel as the apply digests;
    - ``apply-backlog``: the ``inflight_bundles`` gauge again.  Serving
      shares the device with training, so write backlog IS a serving
      overload signal: breaching either flips ``SloEngine.healthy(node)``
      false and the :class:`~parameter_server_tpu_torch.serve.admission.
      AdmissionController` starts shedding within one telemetry beat.
    """
    return [
        SloSpec(
            "ro-p99",
            f"ro_pull.{table}",
            ro_p99_ms,
            source="p99",
            window_s=window_s,
        ),
        SloSpec(
            "apply-backlog",
            "inflight_bundles",
            float(backlog_bundles),
            source="gauge",
            window_s=window_s,
        ),
    ]


def compression_plane_specs(
    *,
    max_ratio_pct: float = 50.0,
    max_residual_norm: float = 1e4,
    window_s: float = 10.0,
) -> List[SloSpec]:
    """The quantized-wire-plane SLO pair.

    Both metrics ride the telemetry counter channel (the QuantizingFilter's
    ``counters()`` merged through ``CoalescingVan`` / ``transport_counters``),
    so ``SloEngine.ingest_counters`` picks them up with no new plumbing:

    - ``compress-ratio``: ``compress_ratio_pct`` gauge (compressed bytes as
      a percentage of raw) — breaching the ceiling means the codec stopped
      earning its keep (e.g. per-row scales inflating a narrow table);
    - ``compress-residual``: ``compress_residual_norm`` gauge, the L2 norm
      of outstanding error-feedback debt.  A norm that grows without bound
      means carried error is diverging (keys pushed once and never again),
      which quietly degrades convergence long before loss curves show it.
    """
    return [
        SloSpec(
            "compress-ratio",
            "compress_ratio_pct",
            max_ratio_pct,
            source="gauge",
            window_s=window_s,
        ),
        SloSpec(
            "compress-residual",
            "compress_residual_norm",
            max_residual_norm,
            source="gauge",
            window_s=window_s,
        ),
    ]


def durability_plane_specs(
    *,
    max_age_s: float = 120.0,
    window_s: float = 10.0,
) -> List[SloSpec]:
    """The durability-plane SLO.

    ``ckpt-age`` watches the server's ``ckpt_age_s`` gauge — seconds since
    the shard last committed to (or restored from) a durable snapshot.  The
    gauge's basis is stamped at server construction, so a fleet that NEVER
    snapshots breaches once ``max_age_s`` elapses: silence is a failure
    mode here, not a healthy default.  Breaching bounds the restore rewind
    (work since the last snapshot) — tighten the checkpoint interval or
    investigate why commits stopped (coordinator wedged, disk full, snapshots
    aborted by a routing churn loop).
    """
    return [
        SloSpec(
            "ckpt-age",
            "ckpt_age_s",
            max_age_s,
            source="gauge",
            window_s=window_s,
        ),
    ]


def tracing_plane_specs(
    *,
    wire_p99_ms: float = 5.0,
    window_s: float = 10.0,
) -> List[SloSpec]:
    """The tracing-plane SLO.

    ``trace-wire-p99`` watches the windowed p99 of the ``trace.wire``
    digest — worker submit stamp -> van receive for sampled requests,
    the only direct cross-node wire-transit measurement the fleet has
    (everything else folds queueing and apply in).  The server publishes
    it through ``latency_digests()`` like every other latency series, so
    the engine needs no new plumbing.  The digest only populates on real
    wire transports (TCP/epoll or the shm ring; loopback never stamps a
    receive), so in-process clusters simply report insufficient samples
    rather than a vacuous pass/fail.  Breaching means the network plane
    itself — not server queueing, not the device — is eating the request
    budget: look at retransmits, backpressure instants (``net.*``), or
    ``tools/critpath.py`` for the full per-plane split.
    """
    return [
        SloSpec(
            "trace-wire-p99",
            "trace.wire",
            wire_p99_ms,
            source="p99",
            window_s=window_s,
        ),
    ]


def consistency_plane_specs(
    *,
    gate_wait_p99_ms: float = 250.0,
    shed_per_s: float = 1.0,
    window_s: float = 10.0,
) -> List[SloSpec]:
    """The consistency-plane SLO pair.

    - ``gate-wait-p99``: windowed p99 of the worker's ``consist.gate_wait``
      digest — wall time a gated pull/push spent parked on ``__wait__``
      replies before the server admitted it.  Breaching means the wire
      (the staleness bound), not the device, is the fleet's bottleneck —
      the exact signal :class:`~parameter_server_tpu_torch.kv.consistency.
      BoundTuner` consumes as its ``wire_bottleneck`` verdict to WIDEN
      the SSP bound.
    - ``shed-rate``: per-second rate of the worker's cumulative
      ``consist_degraded`` counter (stale-cache sheds + forced ungated
      requests).  Degradation is deliberate — bounded by the advertised
      ``__sver__`` watermark and flight-recorded — but a sustained rate
      means the gate deadline is doing the consistency plane's job, i.e.
      the configured mode is not actually being enforced.
    """
    return [
        SloSpec(
            "gate-wait-p99",
            "consist.gate_wait",
            gate_wait_p99_ms,
            source="p99",
            window_s=window_s,
        ),
        SloSpec(
            "shed-rate",
            "consist_degraded",
            shed_per_s,
            source="rate",
            window_s=window_s,
        ),
    ]


def _delta_hist(first: dict, last: dict) -> LatencyHistogram:
    """Histogram of the samples recorded BETWEEN two cumulative digests.

    Differences sparse bucket counts; count/sum difference likewise.  A
    negative difference (recorder reset between samples) falls back to the
    later digest alone rather than inventing negative mass.
    """
    h_last = LatencyHistogram.from_dict(last)
    h_first = LatencyHistogram.from_dict(first)
    if h_last.count < h_first.count:
        return h_last
    delta = LatencyHistogram()
    for i in range(delta.NBUCKETS):
        delta.counts[i] = h_last.counts[i] - h_first.counts[i]
        if delta.counts[i] < 0:
            return h_last
    delta.count = h_last.count - h_first.count
    delta.sum_s = max(h_last.sum_s - h_first.sum_s, 0.0)
    delta.max_s = h_last.max_s  # upper bound: exact window max not tracked
    return delta
