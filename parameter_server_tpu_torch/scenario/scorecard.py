"""SLO-breach-minutes scorecard + automated incident report.

:func:`build_scorecard` folds a finished
:class:`~parameter_server_tpu_torch.scenario.runner.ScenarioRunner` into one
machine-readable dict: the per-node x per-SLO breach timeline integrated
into **SLO-breach-minutes** (off the engine's edge-triggered interval
accounting, so out-of-order frames and clock offsets are already
handled), plus the ground-truth totals the availability number alone
hides — bytes migrated, requests shed, fence rejects, frames the
partitions ate.  Serialize with :func:`scorecard_json` — key-sorted,
rounded — so two same-seed runs emit byte-identical JSON (the
reproducibility check diffs exactly that string).

:func:`render_report` is the human half: a worked incident report that
finds the WORST breach window and auto-attaches (a) the flight-recorder
postmortem chain around it (``tools/postmortem.py`` — the
``scenario.inject`` anomaly that preceded the breach anchors the chain)
and (b) the critical-path attribution of the sampled requests inside it
(``tools/critpath.py`` — which plane ate the latency budget).
"""

from __future__ import annotations

import json
import pathlib
import sys
import tempfile
from typing import Dict, List, Optional

from parameter_server_tpu_torch.core import flightrec

_TOOLS = pathlib.Path(__file__).resolve().parents[2] / "tools"


def _tool(name: str):
    """Import a repo tool module (tools/ is not a package).  A tool that
    fails to import raises ``ImportError``: the report's tool-derived
    sections are never dropped quietly."""
    if str(_TOOLS) not in sys.path:
        sys.path.insert(0, str(_TOOLS))
    try:
        return __import__(name)
    except Exception as e:
        raise ImportError(f"tools/{name}.py is not importable from {_TOOLS}: {e}") from e


def build_scorecard(runner) -> dict:
    """Machine-readable scorecard for one finished run."""
    eng = runner.engine
    end = runner.scenario.duration_s
    timeline = eng.breach_timeline(now=end)
    by_slo: Dict[str, float] = {}
    by_node: Dict[str, float] = {}
    for iv in timeline:
        dur_min = (iv["t1"] - iv["t0"]) / 60.0
        by_slo[iv["slo"]] = by_slo.get(iv["slo"], 0.0) + dur_min
        by_node[iv["node"]] = by_node.get(iv["node"], 0.0) + dur_min
    totals = {"served": 0, "shed": 0, "fence_rejects": 0, "restarts": 0}
    for sim in runner.nodes.values():
        for k in totals:
            totals[k] += int(getattr(sim, k))
    for k, v in runner.retired_totals.items():
        totals[k] = totals.get(k, 0) + int(v)
    chaos_counters = (
        runner.chaos.counters() if runner.chaos is not None else {}
    )
    return {
        "scenario": {
            "name": runner.scenario.name,
            "seed": runner.scenario.seed,
            "nodes": runner.scenario.nodes,
            "duration_s": round(end, 3),
            "tick_s": runner.scenario.tick_s,
            "schedule_events": len(runner.schedule),
        },
        "fleet": {
            "start": runner.scenario.nodes,
            "end": len(runner.nodes),
        },
        "slo": {
            "breach_minutes": round(eng.breach_seconds(now=end) / 60.0, 4),
            "by_slo": {
                k: round(v, 4) for k, v in sorted(by_slo.items())
            },
            "by_node": {
                k: round(v, 4) for k, v in sorted(by_node.items())
            },
            "timeline": [
                {
                    "slo": iv["slo"],
                    "node": iv["node"],
                    "t0": round(iv["t0"], 3),
                    "t1": round(iv["t1"], 3),
                    **({"open": True} if iv.get("open") else {}),
                }
                for iv in timeline
            ],
        },
        "totals": {
            **{k: int(v) for k, v in sorted(totals.items())},
            "bytes_migrated": int(runner.bytes_migrated),
            "partition_dropped_frames": int(
                chaos_counters.get("chaos_partition_drops", 0)
                or chaos_counters.get("partition_drops", 0)
            ),
        },
        "autoscaler": {
            "enabled": runner.autoscaler is not None,
            "actions": [
                {
                    "t": round(a["t"], 3),
                    "kind": a["kind"],
                    **({"node": a["node"]} if a.get("node") else {}),
                }
                for a in runner.actions
            ],
        },
        "telemetry": {
            "frames": runner.agg.frames,
            "dedup_drops": sum(runner.agg._drops.values()),
            "ring_cap_per_node": (
                next(iter(runner.agg._rings.values())).maxlen
                if runner.agg._rings else runner.agg.window
            ),
        },
    }


def scorecard_json(card: dict) -> str:
    """Canonical serialization — the bit-reproducibility surface."""
    return json.dumps(card, sort_keys=True, separators=(",", ":"))


def worst_breach_window(card: dict) -> Optional[dict]:
    """The single longest breach interval (the incident to explain)."""
    timeline = card["slo"]["timeline"]
    if not timeline:
        return None
    return max(timeline, key=lambda iv: (iv["t1"] - iv["t0"], -iv["t0"]))


def _wall_window(runner, t0: float, t1: float):
    """Map a virtual-time window onto wall-monotonic bounds (with slack)."""
    ticks = sorted(runner.wall_of_tick)
    if not ticks:
        return None
    lo = max((t for t in ticks if t <= t0), default=ticks[0])
    hi = min((t for t in ticks if t >= t1), default=ticks[-1])
    slack = 0.05
    return (
        runner.wall_of_tick[lo] - slack,
        runner.wall_of_tick[hi] + slack,
    )


def render_report(runner, card: Optional[dict] = None) -> List[str]:
    """The human incident report for one finished run."""
    if card is None:
        card = build_scorecard(runner)
    sc = card["scenario"]
    lines = [
        f"== war game: {sc['name']} (seed {sc['seed']}) ==",
        f"fleet {card['fleet']['start']} -> {card['fleet']['end']} nodes, "
        f"{sc['duration_s']:.0f}s simulated, "
        f"{sc['schedule_events']} scheduled events",
        f"SLO-breach-minutes: {card['slo']['breach_minutes']:.2f}"
        + "".join(
            f"  [{k}: {v:.2f}]"
            for k, v in card["slo"]["by_slo"].items()
        ),
        f"totals: served={card['totals']['served']} "
        f"shed={card['totals']['shed']} "
        f"fence_rejects={card['totals']['fence_rejects']} "
        f"bytes_migrated={card['totals']['bytes_migrated']} "
        f"partition_dropped_frames="
        f"{card['totals']['partition_dropped_frames']}",
        f"autoscaler: "
        f"{'on' if card['autoscaler']['enabled'] else 'off'}, "
        f"{len(card['autoscaler']['actions'])} actions"
        + "".join(
            f"\n  t={a['t']:8.1f}s  {a['kind']:<10s} {a.get('node', '')}"
            for a in card["autoscaler"]["actions"][:12]
        ),
    ]
    worst = worst_breach_window(card)
    if worst is None:
        lines.append("no SLO breaches — nothing to explain")
        return lines
    lines.append(
        f"-- worst breach window: {worst['slo']} on {worst['node']} "
        f"t={worst['t0']:.1f}s..{worst['t1']:.1f}s "
        f"({(worst['t1'] - worst['t0']) / 60.0:.2f} breach-minutes) --"
    )
    # (a) flight-recorder postmortem chain around the window
    pm = _tool("postmortem")
    try:
        with tempfile.TemporaryDirectory(prefix="wargame_pm_") as d:
            paths = flightrec.dump(d, reason="wargame-report")
            merged = pm.merge_bundles(paths)
            # drop the per-frame publish markers — at 200 publishers
            # they bury the injects/breaches the chain exists to show
            events = [
                ev for ev in merged["events"]
                if ev.get("kind") != "telemetry.publish"
            ]
            window = _wall_window(runner, worst["t0"], worst["t1"])
            if window is not None:
                inside = [
                    ev for ev in events
                    if window[0] <= float(ev.get("t_mono_s") or 0.0)
                    <= window[1]
                ]
                if inside:
                    events = inside
            merged = dict(merged, events=events)
            lines.append("postmortem chain (worst breach window):")
            lines.extend("  " + ln for ln in pm.report(merged, last=20))
    except Exception as e:  # report must never fail the run
        lines.append(f"postmortem chain unavailable: {e}")
    # (b) critpath attribution of sampled requests inside the window
    cp = _tool("critpath")
    sampled = [
        ev for ev in runner.trace_events
        if worst["t0"] <= ev["t_s"] <= worst["t1"] + 1.0
    ]
    if sampled:
        try:
            reqs = cp.requests(sampled)
            lines.append(
                "critpath attribution (sampled requests in window):"
            )
            lines.extend("  " + ln for ln in cp.render(reqs, show=1))
        except Exception as e:
            lines.append(f"critpath attribution unavailable: {e}")
    else:
        lines.append("critpath attribution: no sampled requests in "
                     "the window")
    return lines
