"""Declarative war-game scenarios compiled to absolute-time schedules.

A :class:`Scenario` is a pure, seeded spec: an initial fleet size, a list
of :class:`Phase` objects (each with a :class:`LoadCurve` shaping offered
load over the phase), and a list of :class:`Fault` injections (gray
failures, partitions, restart waves, scale events) at phase-relative
times.  :func:`compile_schedule` expands it into a flat, absolute-time
event list — every random choice (which node a cascade hits next, where a
flash crowd moves the hot set) is drawn from ``random.Random(seed)`` in a
fixed order, so the same spec + seed always compiles to the bit-identical
schedule.  The runner replays that schedule; it never draws randomness of
its own.

Load curves are *multipliers* on the scenario's base offered rate:

- ``flat``: constant ``base``;
- ``diurnal``: ``base * (1 + amplitude * sin(2*pi*t/period_s))`` clamped
  at >= 0 — the classic day/night swing;
- ``flash_crowd``: ``base``, stepping to ``base * peak`` over ``ramp_s``
  at ``at_s`` and holding for ``hold_s`` before ramping back.  With
  ``shift_hot_set`` the crowd also lands on a NEW Zipf hot set (the
  compile step draws the new hot nodes), which is what makes flash crowds
  dangerous: caches and shard placement tuned for the old hot set are
  suddenly wrong.
"""

from __future__ import annotations

import dataclasses
import math
import random
from typing import Dict, List, Optional, Tuple

from parameter_server_tpu_torch.utils.slo import SloSpec

_CURVES = ("flat", "diurnal", "flash_crowd")
_FAULTS = (
    "slow_node", "partition", "restart_wave", "scale_up", "drain_down",
)


@dataclasses.dataclass(frozen=True)
class LoadCurve:
    """Offered-load multiplier over one phase's local time."""

    kind: str = "flat"
    base: float = 1.0
    #: diurnal swing as a fraction of ``base`` (0.5 => 0.5x..1.5x).
    amplitude: float = 0.5
    period_s: float = 600.0
    #: flash-crowd peak multiplier relative to ``base``.
    peak: float = 4.0
    #: flash-crowd start, seconds into the phase.
    at_s: float = 0.0
    ramp_s: float = 5.0
    hold_s: float = 30.0
    #: flash crowd lands on a new Zipf hot set (compile draws it).
    shift_hot_set: bool = False

    def __post_init__(self) -> None:
        if self.kind not in _CURVES:
            raise ValueError(
                f"LoadCurve kind must be one of {_CURVES}, got {self.kind!r}"
            )
        if self.base < 0:
            raise ValueError(f"base must be >= 0, got {self.base!r}")
        if self.kind == "diurnal" and self.period_s <= 0:
            raise ValueError("diurnal period_s must be > 0")
        if self.kind == "flash_crowd" and self.peak < 1.0:
            raise ValueError(f"flash peak must be >= 1, got {self.peak!r}")

    def multiplier(self, t: float) -> float:
        """Load multiplier at ``t`` seconds into the phase."""
        if self.kind == "flat":
            return self.base
        if self.kind == "diurnal":
            return max(
                0.0,
                self.base
                * (1.0 + self.amplitude * math.sin(2.0 * math.pi * t / self.period_s)),
            )
        # flash_crowd: trapezoid base -> base*peak -> base
        rel = t - self.at_s
        if rel < 0:
            return self.base
        ramp = max(self.ramp_s, 1e-9)
        if rel < self.ramp_s:
            return self.base * (1.0 + (self.peak - 1.0) * rel / ramp)
        if rel < self.ramp_s + self.hold_s:
            return self.base * self.peak
        rel -= self.ramp_s + self.hold_s
        if rel < self.ramp_s:
            return self.base * (self.peak - (self.peak - 1.0) * rel / ramp)
        return self.base


#: phase-level consistency-plane settings: mode names match
#: ``config.ConsistencyMode`` values; the runner applies them through the
#: ``consist_set`` control broadcast at the phase boundary.
_CONSIST_MODES = ("bsp", "ssp", "asp")


@dataclasses.dataclass(frozen=True)
class Phase:
    name: str
    duration_s: float
    load: LoadCurve = LoadCurve()
    #: flip the fleet's gated tables to this consistency mode at phase
    #: start (None = leave as-is).  Lets a war game answer "does BSP
    #: survive this straggler cascade, and what does SSP(4) buy us?"
    #: inside one scenario.
    consistency_mode: Optional[str] = None
    #: SSP staleness bound for the flip (ignored unless mode == "ssp").
    consistency_bound: int = 4

    def __post_init__(self) -> None:
        if self.duration_s <= 0:
            raise ValueError(
                f"phase {self.name!r}: duration_s must be > 0"
            )
        if (
            self.consistency_mode is not None
            and self.consistency_mode not in _CONSIST_MODES
        ):
            raise ValueError(
                f"phase {self.name!r}: consistency_mode must be one of "
                f"{_CONSIST_MODES}, got {self.consistency_mode!r}"
            )
        if self.consistency_bound < 0:
            raise ValueError(
                f"phase {self.name!r}: consistency_bound must be >= 0"
            )


@dataclasses.dataclass(frozen=True)
class Fault:
    """One injection, timed relative to the START of phase ``phase``.

    Kinds and their parameters:

    - ``slow_node``: gray failure — ``slow_ms`` extra service latency on
      ``node`` (or a seeded-random serving node) for ``duration_s``;
      ``cascade`` > 0 trips that many FURTHER nodes at ``cascade_gap_s``
      intervals (each for the same duration) — the correlated-failure
      shape that breaks naive per-node alerting;
    - ``partition``: ``node`` (or seeded-random) loses the control plane
      (symmetric node <-> scheduler partition) for ``duration_s``, then
      heals;
    - ``restart_wave``: ``count`` rolling same-id restarts, ``gap_s``
      apart, each node offline ``duration_s``;
    - ``scale_up`` / ``drain_down``: forced fleet-shape events (the
      autoscaler's own actions ride separately, off live telemetry).
    """

    kind: str
    phase: str
    at_s: float
    node: Optional[str] = None
    duration_s: float = 30.0
    slow_ms: float = 200.0
    cascade: int = 0
    cascade_gap_s: float = 10.0
    count: int = 1
    gap_s: float = 10.0

    def __post_init__(self) -> None:
        if self.kind not in _FAULTS:
            raise ValueError(
                f"Fault kind must be one of {_FAULTS}, got {self.kind!r}"
            )
        if self.at_s < 0:
            raise ValueError(f"at_s must be >= 0, got {self.at_s!r}")
        if self.duration_s <= 0:
            raise ValueError(
                f"duration_s must be > 0, got {self.duration_s!r}"
            )
        if self.cascade < 0 or self.count < 1:
            raise ValueError("cascade must be >= 0 and count >= 1")


@dataclasses.dataclass(frozen=True)
class Scenario:
    """A complete seeded war game.  Compile with :func:`compile_schedule`."""

    name: str
    seed: int
    nodes: int
    phases: Tuple[Phase, ...]
    faults: Tuple[Fault, ...] = ()
    #: runner tick (virtual seconds per control sweep).
    tick_s: float = 1.0
    #: fleet-aggregate offered load at multiplier 1.0 (requests/s).
    base_qps: float = 1000.0
    #: per-node service capacity (requests/s).
    node_capacity_qps: float = 120.0

    def __post_init__(self) -> None:
        if self.nodes < 2:
            raise ValueError(f"nodes must be >= 2, got {self.nodes!r}")
        if not self.phases:
            raise ValueError("a scenario needs at least one phase")
        names = [p.name for p in self.phases]
        if len(set(names)) != len(names):
            raise ValueError(f"duplicate phase names: {names}")
        known = set(names)
        for f in self.faults:
            if f.phase not in known:
                raise ValueError(
                    f"fault {f.kind!r} names unknown phase {f.phase!r}"
                )
        if self.tick_s <= 0 or self.base_qps <= 0 or self.node_capacity_qps <= 0:
            raise ValueError("tick_s/base_qps/node_capacity_qps must be > 0")

    @property
    def duration_s(self) -> float:
        return sum(p.duration_s for p in self.phases)

    def phase_starts(self) -> Dict[str, float]:
        out: Dict[str, float] = {}
        t = 0.0
        for p in self.phases:
            out[p.name] = t
            t += p.duration_s
        return out

    def multiplier(self, t: float) -> float:
        """Offered-load multiplier at absolute scenario time ``t``."""
        t0 = 0.0
        for p in self.phases:
            if t < t0 + p.duration_s or p is self.phases[-1]:
                return p.load.multiplier(t - t0)
            t0 += p.duration_s
        return self.phases[-1].load.multiplier(t - t0)


def _server_ids(n: int) -> List[str]:
    return [f"S{i}" for i in range(n)]


def compile_schedule(scenario: Scenario) -> List[dict]:
    """Expand a :class:`Scenario` into the absolute-time event list.

    Every event is a plain dict ``{"t": float, "event": str, ...}``,
    sorted by ``(t, order drawn)``; random node choices come from ONE
    ``random.Random(scenario.seed)`` consumed in spec order, so the
    schedule is a pure function of the spec.  Event kinds: ``phase``,
    ``inject`` (fault=slow_node|partition|restart), ``heal``
    (fault=slow_node|partition), ``scale`` (action=scale_up|drain_down),
    ``hot_shift`` (the flash crowd's new hot node), ``end``.
    """
    rng = random.Random(scenario.seed)
    starts = scenario.phase_starts()
    servers = _server_ids(scenario.nodes)
    events: List[dict] = []
    # the initial hot node is itself a seeded draw: draw order is fixed
    # (hot set first, then phases in order, then faults in order)
    hot = rng.choice(servers)
    events.append({"t": 0.0, "event": "hot_shift", "node": hot})
    for p in scenario.phases:
        ev = {"t": starts[p.name], "event": "phase", "phase": p.name}
        if p.consistency_mode is not None:
            ev["consistency_mode"] = p.consistency_mode
            if p.consistency_mode == "ssp":
                ev["consistency_bound"] = p.consistency_bound
        events.append(ev)
        if p.load.kind == "flash_crowd" and p.load.shift_hot_set:
            hot = rng.choice([s for s in servers if s != hot])
            events.append({
                "t": starts[p.name] + p.load.at_s,
                "event": "hot_shift",
                "node": hot,
            })
    for f in scenario.faults:
        t0 = starts[f.phase] + f.at_s
        if f.kind == "slow_node":
            victims = [f.node or rng.choice(servers)]
            for _ in range(f.cascade):
                pool = [s for s in servers if s not in victims]
                if not pool:
                    break
                victims.append(rng.choice(pool))
            for i, node in enumerate(victims):
                t = t0 + i * f.cascade_gap_s
                events.append({
                    "t": t, "event": "inject", "fault": "slow_node",
                    "node": node, "slow_ms": f.slow_ms,
                })
                events.append({
                    "t": t + f.duration_s, "event": "heal",
                    "fault": "slow_node", "node": node,
                })
        elif f.kind == "partition":
            node = f.node or rng.choice(servers)
            events.append({
                "t": t0, "event": "inject", "fault": "partition",
                "node": node,
            })
            events.append({
                "t": t0 + f.duration_s, "event": "heal",
                "fault": "partition", "node": node,
            })
        elif f.kind == "restart_wave":
            pool = list(servers)
            for i in range(f.count):
                node = f.node if (f.node and i == 0) else rng.choice(pool)
                if node in pool and len(pool) > 1:
                    pool.remove(node)
                events.append({
                    "t": t0 + i * f.gap_s, "event": "inject",
                    "fault": "restart", "node": node,
                    "offline_s": f.duration_s,
                })
        else:  # scale_up / drain_down
            events.append({"t": t0, "event": "scale", "action": f.kind})
    events.append({"t": scenario.duration_s, "event": "end"})
    # stable sort preserves draw order among same-time events
    events.sort(key=lambda e: e["t"])
    for ev in events:
        ev["t"] = round(ev["t"], 6)
    return events


def wargame_plane_specs(
    *,
    serve_p99_ms: float = 150.0,
    shed_per_s: float = 1.0,
    window_s: float = 8.0,
) -> List[SloSpec]:
    """The war game's scoring SLOs over the sim fleet's telemetry.

    - ``serve-p99``: windowed p99 of each node's ``serve.lat`` digest
      (service + queueing, milliseconds) — the availability headline;
    - ``shed-rate``: per-second rate of the cumulative ``shed`` counter —
      requests turned away count against the SLO even when the survivors
      are fast.
    """
    return [
        SloSpec(
            "serve-p99",
            "serve.lat",
            serve_p99_ms,
            source="p99",
            window_s=window_s,
            min_samples=2,
        ),
        SloSpec(
            "shed-rate",
            "shed",
            shed_per_s,
            source="rate",
            window_s=window_s,
            min_samples=2,
        ),
    ]


# -- canonical scenarios ------------------------------------------------------

def smoke_scenario(seed: int = 0) -> Scenario:
    """Tier-1 seeded 8-node smoke: one flash crowd + one gray failure +
    one partition-then-heal, short enough for the default test budget."""
    return Scenario(
        name="smoke-8",
        seed=seed,
        nodes=8,
        base_qps=640.0,
        node_capacity_qps=120.0,
        tick_s=1.0,
        phases=(
            Phase("warmup", 20.0, LoadCurve("flat", base=0.8)),
            Phase("crowd", 60.0, LoadCurve(
                "flash_crowd", base=0.9, peak=2.5, at_s=10.0,
                ramp_s=5.0, hold_s=20.0, shift_hot_set=True,
            )),
            Phase("cooldown", 20.0, LoadCurve("flat", base=0.7)),
        ),
        faults=(
            Fault("slow_node", "crowd", at_s=15.0, duration_s=20.0,
                  slow_ms=400.0),
            Fault("partition", "cooldown", at_s=2.0, duration_s=8.0),
        ),
    )


def reference_scenario(seed: int = 0) -> Scenario:
    """The BASELINE.md reference drill: 50 nodes, flash crowd + one gray
    failure + one partition-then-heal (the smoke shape)."""
    return Scenario(
        name="reference-50",
        seed=seed,
        nodes=50,
        # 50 x 120 = 6000 qps of fleet capacity; the flash peak offers
        # 4000 x 0.9 x 1.8 = 6480 qps (~108%) — an overload added capacity
        # can actually catch, so the closed loop has a real fight to win
        # (at 2-3x overload EVERY node drowns regardless and scaling up
        # only adds breach surface)
        base_qps=4000.0,
        node_capacity_qps=120.0,
        tick_s=1.0,
        phases=(
            Phase("steady", 30.0, LoadCurve("flat", base=0.8)),
            Phase("crowd", 90.0, LoadCurve(
                "flash_crowd", base=0.9, peak=1.8, at_s=10.0,
                ramp_s=8.0, hold_s=40.0, shift_hot_set=True,
            )),
            Phase("recovery", 40.0, LoadCurve("flat", base=0.75)),
        ),
        faults=(
            Fault("slow_node", "crowd", at_s=20.0, duration_s=30.0,
                  slow_ms=500.0),
            Fault("partition", "recovery", at_s=5.0, duration_s=12.0),
        ),
    )


def drill_scenario(seed: int = 0) -> Scenario:
    """The full 200-node production drill (``slow``-marked): diurnal base
    load, a hot-set-shifting flash crowd, a cascading gray failure, a
    rolling restart wave, a partition-then-heal, and forced scale events."""
    return Scenario(
        name="drill-200",
        seed=seed,
        nodes=200,
        base_qps=16000.0,
        node_capacity_qps=120.0,
        tick_s=1.0,
        phases=(
            Phase("day", 120.0, LoadCurve(
                "diurnal", base=0.8, amplitude=0.4, period_s=120.0,
            )),
            Phase("crowd", 120.0, LoadCurve(
                "flash_crowd", base=0.9, peak=3.0, at_s=15.0,
                ramp_s=10.0, hold_s=60.0, shift_hot_set=True,
            )),
            Phase("night", 80.0, LoadCurve("flat", base=0.6)),
        ),
        faults=(
            Fault("slow_node", "day", at_s=40.0, duration_s=40.0,
                  slow_ms=400.0, cascade=2, cascade_gap_s=15.0),
            Fault("restart_wave", "crowd", at_s=30.0, count=3,
                  gap_s=15.0, duration_s=6.0),
            Fault("partition", "night", at_s=10.0, duration_s=15.0),
            Fault("scale_up", "crowd", at_s=5.0),
            Fault("drain_down", "night", at_s=40.0),
        ),
    )
