"""Deterministic war-game runner: a simulated fleet over a real wire.

:class:`ScenarioRunner` replays a compiled schedule
(:func:`~parameter_server_tpu_torch.scenario.dsl.compile_schedule`) against a
50-200-node simulated fleet in VIRTUAL time.  The parts that matter for
control-plane scaling are real:

- telemetry frames are built by real
  :class:`~parameter_server_tpu_torch.core.telemetry.TelemetryPublisher`
  instances (delta encoding, digest series, event summaries) and travel
  as real CONTROL messages over a real
  :class:`~parameter_server_tpu_torch.core.chaos.ChaosVan` wire (pass any Van —
  loopback by default, a TCP/shm stack for wire realism) to a scheduler
  handler that ingests into a real
  :class:`~parameter_server_tpu_torch.core.telemetry.TelemetryAggregator` +
  :class:`~parameter_server_tpu_torch.utils.slo.SloEngine`;
- partitions drop those frames on the wire (``ChaosVan.partition``), gray
  failures are registered with ``ChaosVan.slow_node`` AND degrade the
  victim's service model;
- the autoscaler (:class:`~parameter_server_tpu_torch.learner.elastic.
  AutoscalePolicy`) closes the loop on the aggregator's LIVE verdicts,
  never on sim ground truth.

What is simulated is each node's serving behaviour: a fluid queue
(offered load in, capacity out, bounded queue that sheds) whose latency
feeds the node's ``serve.lat`` digest.  Everything is driven by one
thread on a virtual clock — the only wall-clock waits are for the van's
recv thread to drain each tick's expected deliveries — so two runs with
the same scenario produce identical telemetry, identical breach edges,
and an identical scorecard.
"""

from __future__ import annotations

import threading
import time
import zlib
from typing import Dict, List, Optional

from parameter_server_tpu_torch.config import TelemetryConfig
from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.chaos import ChaosVan
from parameter_server_tpu_torch.core.manager import TELEMETRY
from parameter_server_tpu_torch.core.messages import (
    SCHEDULER,
    Message,
    Task,
    TaskKind,
)
from parameter_server_tpu_torch.core.telemetry import (
    TelemetryAggregator,
    TelemetryPublisher,
)
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.learner.elastic import (
    AutoscaleConfig,
    AutoscalePolicy,
)
from parameter_server_tpu_torch.scenario import dsl
from parameter_server_tpu_torch.utils.slo import SloEngine
from parameter_server_tpu_torch.utils.trace import LatencyHistogram

class _SimFleet:
    """Clock-offset oracle for the aggregator (stragglers: none)."""

    def __init__(self, offsets: Dict[str, float]) -> None:
        self._offsets = offsets

    def clock_offset(self, node: str) -> float:
        return self._offsets.get(node, 0.0)

    def stragglers(self, now: Optional[float] = None) -> Dict[str, list]:
        return {}


def _node_offset(node: str, max_offset_s: float) -> float:
    """Deterministic per-node clock offset in [-max, +max] — a pure hash,
    no RNG draw, so adding nodes never shifts anyone else's offset."""
    if max_offset_s <= 0:
        return 0.0
    frac = (zlib.crc32(node.encode()) % 10_000) / 10_000.0
    return (2.0 * frac - 1.0) * max_offset_s


class _SimNode:
    """One simulated serving node: fluid queue + telemetry source.

    The model is intentionally simple and fully deterministic: per tick,
    ``offered`` requests arrive, up to ``capacity`` (degraded by a gray
    failure's ``slow_ms``) are served, the rest queue; the queue is
    bounded at ``max_queue_s`` worth of capacity and overflow is SHED.
    Service latency = base + gray-failure delay + queueing delay, recorded
    into the cumulative ``serve.lat`` digest the SLO engine reads.
    """

    def __init__(
        self,
        node_id: str,
        *,
        capacity_qps: float,
        base_ms: float = 20.0,
        max_queue_s: float = 2.0,
    ) -> None:
        self.node_id = node_id
        self.capacity = capacity_qps
        self.base_s = base_ms / 1e3
        self.max_queue_s = max_queue_s
        self.queue = 0.0
        self.slow_ms = 0.0
        self.partitioned = False
        #: virtual time a same-id restart brings the node back, or None.
        self.offline_until: Optional[float] = None
        self.served = 0.0
        self.shed = 0.0
        self.fence_rejects = 0.0
        self.restarts = 0
        self.last_latency_s = self.base_s
        self._lat = LatencyHistogram()

    # -- telemetry source interface ------------------------------------------
    def counters(self) -> dict:
        return {
            "served": int(self.served),
            "shed": int(self.shed),
            "fence_rejects": int(self.fence_rejects),
            "restarts": self.restarts,
        }

    def latency_digests(self) -> dict:
        return {"serve.lat": self._lat.to_dict()}

    # -- model ----------------------------------------------------------------
    def step(self, offered_qps: float, tick_s: float, now: float) -> None:
        if self.offline_until is not None:
            if now < self.offline_until:
                # dead process: clients get fenced, nothing is served
                self.fence_rejects += offered_qps * tick_s
                return
            # revived (same-id restart): queue was lost with the process
            self.offline_until = None
            self.queue = 0.0
            self.restarts += 1
        slow_s = self.slow_ms / 1e3
        # a gray failure stretches every service slot: capacity shrinks by
        # the ratio of healthy to degraded service time
        eff_cap = self.capacity * self.base_s / (self.base_s + slow_s)
        arriving = offered_qps * tick_s
        budget = eff_cap * tick_s
        done = min(self.queue + arriving, budget)
        self.queue = self.queue + arriving - done
        qcap = eff_cap * self.max_queue_s
        if self.queue > qcap:
            self.shed += self.queue - qcap
            self.queue = qcap
        self.served += done
        latency = self.base_s + slow_s + (
            self.queue / eff_cap if eff_cap > 0 else 0.0
        )
        self.last_latency_s = latency
        # one digest sample per tick: the p99 spec windows over ticks
        self._lat.record(latency)


class ScenarioRunner:
    """Drive one compiled scenario; collect everything the scorecard needs.

    ``run()`` returns the machine-readable scorecard dict
    (:func:`~parameter_server_tpu_torch.scenario.scorecard.build_scorecard`);
    the runner object keeps the engine/aggregator/chaos state for the
    human report.
    """

    def __init__(
        self,
        scenario: dsl.Scenario,
        *,
        autoscale: bool = True,
        autoscale_config: Optional[AutoscaleConfig] = None,
        slo_specs=None,
        van=None,
        telemetry_config: Optional[TelemetryConfig] = None,
        jsonl_path: Optional[str] = None,
        base_ms: float = 20.0,
        hot_boost: float = 3.0,
        table_rows: int = 1 << 20,
        table_dim: int = 32,
        max_clock_offset_s: float = 0.25,
        autoscale_every_ticks: int = 5,
        trace_sample: bool = True,
        ingest_timeout_s: float = 30.0,
    ) -> None:
        self.scenario = scenario
        self.schedule = dsl.compile_schedule(scenario)
        self.hot_boost = hot_boost
        self.base_ms = base_ms
        self.table_rows = table_rows
        self.table_dim = table_dim
        self.autoscale_every = max(1, autoscale_every_ticks)
        self.trace_sample = trace_sample
        self.ingest_timeout_s = ingest_timeout_s
        self._max_offset = max_clock_offset_s

        self.van = van if van is not None else ChaosVan(
            LoopbackVan(), seed=scenario.seed
        )
        self.chaos: Optional[ChaosVan] = (
            self.van if isinstance(self.van, ChaosVan) else None
        )
        self.engine = SloEngine(
            list(slo_specs) if slo_specs is not None
            else dsl.wargame_plane_specs()
        )
        self._offsets: Dict[str, float] = {}
        self.agg = TelemetryAggregator(
            slo=self.engine,
            fleet=_SimFleet(self._offsets),
            config=telemetry_config or TelemetryConfig(),
            jsonl_path=jsonl_path,
            evaluate_scope="node",
        )
        if autoscale and autoscale_config is None:
            # headroom scales with the scenario: a 50-node drill must be
            # able to actually scale up, not just rebalance at the default
            # 16-server ceiling
            autoscale_config = AutoscaleConfig(
                max_servers=max(16, 2 * scenario.nodes)
            )
        self.autoscaler: Optional[AutoscalePolicy] = (
            AutoscalePolicy(autoscale_config) if autoscale else None
        )

        self.nodes: Dict[str, _SimNode] = {}
        self.pubs: Dict[str, TelemetryPublisher] = {}
        #: per-node extra load weight on top of the uniform 1.0 (hot set).
        self.extra_weight: Dict[str, float] = {}
        self.hot_node: Optional[str] = None
        self._next_index = 0
        self.bytes_migrated = 0
        #: counters of drained nodes (ground truth survives retirement).
        self.retired_totals: Dict[str, int] = {
            "served": 0, "shed": 0, "fence_rejects": 0, "restarts": 0,
        }
        self.actions: List[dict] = []
        self.now = 0.0
        self.phase: Optional[str] = None
        #: consistency plane: the phase knob's current setting.
        #: The runner simulates load, not training, so the flip is state +
        #: callbacks: a caller running a REAL fleet appends a callable
        #: ``(mode, bound) -> None`` (typically a ``consist_set`` broadcast
        #: through any live worker) to ``on_consistency_mode``.
        self.consistency_mode: Optional[str] = None
        self.consistency_bound: Optional[int] = None
        self.on_consistency_mode: List = []
        #: synthetic sampled-request trace events (critpath.py shapes,
        #: pre-rebased: ``t_s`` is virtual time) for the incident report.
        self.trace_events: List[dict] = []
        self._trace_seq = 0
        #: virtual-time -> wall-monotonic anchors (postmortem windowing).
        self.wall_of_tick: Dict[float, float] = {}

        self._cond = threading.Condition()
        self._ingested = 0
        self._ingest_now = 0.0
        self.van.bind(SCHEDULER, self._on_msg)
        for _ in range(scenario.nodes):
            self._add_node(record=False)

    # -- fleet shape ----------------------------------------------------------
    def _add_node(self, *, record: bool = True) -> str:
        node = f"S{self._next_index}"
        self._next_index += 1
        self.nodes[node] = _SimNode(
            node,
            capacity_qps=self.scenario.node_capacity_qps,
            base_ms=self.base_ms,
        )
        # per-node recorder: frames summarize only this node's events
        # without scanning the shared process ring 200x per beat
        self.pubs[node] = TelemetryPublisher(
            node,
            recorder=flightrec.FlightRecorder(capacity=512, node=node),
            sources=(self.nodes[node],),
        )
        self._offsets[node] = _node_offset(node, self._max_offset)
        if record:
            # joining node takes its uniform share: 1/(n+1) of the table
            moved = self.table_rows // max(1, len(self.nodes))
            self.bytes_migrated += moved * self.table_dim * 4
        return node

    def _remove_node(self, node: str) -> None:
        # its shard moves to the survivors before the process exits
        self.bytes_migrated += (
            self.table_rows // max(1, len(self.nodes))
        ) * self.table_dim * 4
        sim = self.nodes.get(node)
        if sim is not None:
            for k in self.retired_totals:
                self.retired_totals[k] += int(getattr(sim, k))
        self.nodes.pop(node, None)
        self.pubs.pop(node, None)
        self.extra_weight.pop(node, None)
        if self.hot_node == node:
            self.hot_node = None

    # -- wire -----------------------------------------------------------------
    def _on_msg(self, msg: Message) -> None:
        if msg.task.payload.get("cmd") != TELEMETRY:
            return
        self.agg.ingest(
            msg.sender,
            msg.task.payload.get("frame") or {},
            now=self._ingest_now,
        )
        with self._cond:
            self._ingested += 1
            self._cond.notify_all()

    def _publish_tick(self) -> None:
        """Build + send every online node's frame; wait for ingestion.

        Frames into a partitioned link are still SENT (and dropped by the
        chaos layer, exactly like production); the runner only waits for
        the deliveries the partition map says can arrive, so virtual time
        never advances past an un-ingested frame.
        """
        self._ingest_now = self.now
        with self._cond:
            start = self._ingested
        expected = 0
        for node, sim in sorted(self.nodes.items()):
            if sim.offline_until is not None:
                continue  # dead process publishes nothing
            frame = self.pubs[node].frame(self.now + self._offsets[node])
            self.van.send(Message(
                task=Task(
                    TaskKind.CONTROL,
                    "scenario",
                    payload={"cmd": TELEMETRY, "frame": frame},
                ),
                sender=node,
                recver=SCHEDULER,
            ))
            if not sim.partitioned:
                expected += 1
        deadline = time.monotonic() + self.ingest_timeout_s
        with self._cond:
            while self._ingested < start + expected:
                left = deadline - time.monotonic()
                if left <= 0:
                    raise TimeoutError(
                        f"tick t={self.now}: ingested "
                        f"{self._ingested - start}/{expected} frames"
                    )
                self._cond.wait(timeout=left)

    # -- schedule execution ---------------------------------------------------
    def _apply_event(self, ev: dict) -> None:
        kind = ev["event"]
        if kind == "phase":
            self.phase = ev["phase"]
            self.agg.set_phase(ev["phase"])
            flightrec.record(
                "scenario.phase", node=SCHEDULER, phase=ev["phase"],
                t_virtual=ev["t"],
            )
            mode = ev.get("consistency_mode")
            if mode is not None:
                bound = ev.get("consistency_bound")
                self.consistency_mode = mode
                self.consistency_bound = bound
                for cb in self.on_consistency_mode:
                    cb(mode, bound)
                flightrec.record(
                    "consist.retune", node=SCHEDULER, table="*",
                    mode=mode, bound=-1 if bound is None else int(bound),
                    why=f"scenario phase {ev['phase']}",
                )
        elif kind == "hot_shift":
            if self.hot_node is not None:
                self.extra_weight.pop(self.hot_node, None)
            node = ev["node"]
            if node in self.nodes:
                self.hot_node = node
                self.extra_weight[node] = self.hot_boost - 1.0
        elif kind == "inject":
            fault = ev["fault"]
            node = ev.get("node")
            sim = self.nodes.get(node)
            if sim is None:
                return
            if fault == "slow_node":
                sim.slow_ms = float(ev["slow_ms"])
                if self.chaos is not None:
                    self.chaos.slow_node(node, sim.slow_ms)
            elif fault == "partition":
                sim.partitioned = True
                if self.chaos is not None:
                    self.chaos.partition(node, SCHEDULER, symmetric=True)
            elif fault == "restart":
                sim.offline_until = self.now + float(ev["offline_s"])
            flightrec.record(
                "scenario.inject", node=node, fault=fault,
                t_virtual=ev["t"],
            )
            self._record_node_event(node, "scenario.inject", fault=fault)
        elif kind == "heal":
            fault = ev["fault"]
            node = ev.get("node")
            sim = self.nodes.get(node)
            if sim is None:
                return
            if fault == "slow_node":
                sim.slow_ms = 0.0
                if self.chaos is not None:
                    self.chaos.slow_node(node, 0.0)
            elif fault == "partition":
                sim.partitioned = False
                if self.chaos is not None:
                    self.chaos.heal(node, SCHEDULER)
                    self.chaos.heal(SCHEDULER, node)
            flightrec.record(
                "scenario.heal", node=node, fault=fault, t_virtual=ev["t"],
            )
            self._record_node_event(node, "scenario.heal", fault=fault)
        elif kind == "scale":
            self._execute({"kind": ev["action"], "reason": "scheduled"})
        elif kind == "end":
            pass

    def _record_node_event(self, node: str, kind: str, **fields) -> None:
        """Mirror a scenario event into the victim's publisher recorder so
        it rides that node's next telemetry frame (event-rate channel)."""
        pub = self.pubs.get(node)
        if pub is not None and pub._recorder is not None:
            pub._recorder.record(kind, node=node, **fields)

    def _execute(self, intent: dict) -> None:
        """Carry out one autoscaler/scheduled intent on the sim fleet."""
        kind = intent["kind"]
        done = dict(intent)
        done["t"] = self.now
        if kind == "scale_up":
            count = max(1, int(intent.get("count", 1)))
            done["node"] = ",".join(
                self._add_node() for _ in range(count)
            )
        elif kind == "drain_down":
            node = intent.get("node")
            if node is None or node not in self.nodes:
                # retire the coldest non-hot node (deterministic order)
                pool = [
                    n for n in sorted(self.nodes)
                    if n != self.hot_node and self.nodes[n].offline_until is None
                ]
                if not pool:
                    return
                node = pool[-1]
            if len(self.nodes) <= 2:
                return
            done["node"] = node
            self._remove_node(node)
        elif kind == "rebalance":
            node = intent.get("node") or self.hot_node
            if node is None or node not in self.nodes:
                return
            extra = self.extra_weight.get(node, 0.0)
            if extra <= 0.0:
                return
            # move half the hot share to the least-loaded peer
            pool = [n for n in sorted(self.nodes) if n != node]
            if not pool:
                return
            coldest = min(
                pool, key=lambda n: (self.extra_weight.get(n, 0.0), n)
            )
            moved_w = extra / 2.0
            self.extra_weight[node] = extra - moved_w
            self.extra_weight[coldest] = (
                self.extra_weight.get(coldest, 0.0) + moved_w
            )
            total_w = len(self.nodes) + sum(self.extra_weight.values())
            moved_rows = int(self.table_rows * moved_w / max(total_w, 1e-9))
            self.bytes_migrated += moved_rows * self.table_dim * 4
            done["node"] = node
            done["moved_rows"] = moved_rows
        self.actions.append(done)
        target = done.get("node")
        flightrec.record(
            "scenario.action",
            # a multi-node scale_up is the scheduler's act, not any one
            # node's — keep the postmortem's per-node index clean
            node=(
                target if target and "," not in target else SCHEDULER
            ),
            action=kind, target=target or "",
            reason=intent.get("reason", ""),
            t_virtual=self.now,
        )

    # -- load model -----------------------------------------------------------
    def _weights(self) -> Dict[str, float]:
        return {
            n: 1.0 + self.extra_weight.get(n, 0.0)
            for n in sorted(self.nodes)
        }

    def _offered(self) -> Dict[str, float]:
        total = self.scenario.base_qps * self.scenario.multiplier(self.now)
        w = self._weights()
        wsum = sum(w.values()) or 1.0
        return {n: total * wi / wsum for n, wi in w.items()}

    # -- synthetic sampled request (critpath shapes) --------------------------
    def _sample_trace(self, offered: Dict[str, float]) -> None:
        """Emit one sampled request's span set per tick, targeted at the
        currently worst-latency node — the requests the incident report's
        critpath attribution will decompose for the worst breach window.

        The stamps are derived from the victim's queue model (``t_s`` is
        VIRTUAL time, already rebased), shaped exactly like
        ``tools/critpath.merge_events`` output so ``critpath.requests``
        consumes them directly.
        """
        live = [
            n for n, s in self.nodes.items() if s.offline_until is None
        ]
        if not live:
            return
        victim = max(
            sorted(live), key=lambda n: self.nodes[n].last_latency_s
        )
        sim = self.nodes[victim]
        self._trace_seq += 1
        tid = f"W0/{self._trace_seq}"
        t0 = self.now
        serialize = 0.0002
        send_q = 0.0003
        wire = 0.0005
        queue_s = max(sim.last_latency_s - sim.base_s - sim.slow_ms / 1e3, 0.0)
        service = sim.base_s + sim.slow_ms / 1e3
        t_send = t0 + serialize
        t_tx = t_send + send_q
        t_rx = t_tx + wire
        t_disp = t_rx + queue_s
        t_reply = t_disp + service
        t_ack = t_reply + wire
        self.trace_events.extend([
            {"kind": "trace.submit", "tid": tid, "node": "W0",
             "t_s": t_send, "_t0_s": t0, "op": "pull", "legs": 1},
            {"kind": "trace.wire_tx", "tids": [tid], "node": "W0",
             "recver": victim, "t_s": t_tx},
            {"kind": "trace.wire_rx", "tids": [tid], "node": victim,
             "sender": "W0", "t_s": t_rx},
            {"kind": "trace.dispatch", "tid": tid, "node": victim,
             "t_s": t_disp},
            {"kind": "trace.reply", "tid": tid, "node": victim,
             "t_s": t_reply, "verdict": "ok"},
            {"kind": "trace.ack", "tid": tid, "node": "W0", "t_s": t_ack,
             "e2e_ms": round((t_ack - t0) * 1e3, 3)},
        ])

    # -- main loop ------------------------------------------------------------
    def run(self) -> dict:
        from parameter_server_tpu_torch.scenario import scorecard as sc

        # size the global ring to the run: every tick publishes one
        # telemetry.publish marker per node into it, and a 200-node drill
        # would otherwise evict the injects/breaches the postmortem needs
        need = int(
            len(self.nodes)
            * (self.scenario.duration_s / self.scenario.tick_s)
        ) + 4096
        if (flightrec.get()._ring.maxlen or 0) < need:
            flightrec.configure(capacity=need)
        flightrec.record(
            "scenario.begin", node=SCHEDULER,
            scenario=self.scenario.name, seed=self.scenario.seed,
            nodes=len(self.nodes),
        )
        pending = list(self.schedule)
        tick = 0
        end_t = self.scenario.duration_s
        while self.now < end_t or pending:
            while pending and pending[0]["t"] <= self.now:
                self._apply_event(pending.pop(0))
            if self.now >= end_t:
                break
            self.wall_of_tick[self.now] = time.monotonic()
            offered = self._offered()
            for node in sorted(self.nodes):
                self.nodes[node].step(
                    offered[node], self.scenario.tick_s, self.now
                )
            if self.trace_sample:
                self._sample_trace(offered)
            self._publish_tick()
            # one full-fleet sweep per tick: nodes whose frames were lost
            # to a partition still age out of their windows on time
            self.engine.evaluate(self.now)
            if (
                self.autoscaler is not None
                and tick % self.autoscale_every == 0
            ):
                view = {}
                for node, row in self.agg.latest().items():
                    if node not in self.nodes:
                        continue  # drained node's last rows linger
                    view[node] = {
                        "healthy": bool(row.get("healthy", True)),
                        "load": offered.get(node, 0.0),
                    }
                for intent in self.autoscaler.tick(self.now, view):
                    self._execute(intent)
            self.now = round(self.now + self.scenario.tick_s, 6)
            tick += 1
        self.agg.set_phase(None)
        flightrec.record(
            "scenario.end", node=SCHEDULER, scenario=self.scenario.name,
            breach_min=round(self.engine.breach_seconds(now=end_t) / 60.0, 4),
        )
        return sc.build_scorecard(self)

    def close(self) -> None:
        try:
            self.agg.close()  # flush the JSONL spill, if any
        except Exception:
            pass
        try:
            self.van.close()
        except Exception:
            pass
