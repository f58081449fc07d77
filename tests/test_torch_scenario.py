"""The war-game plane of the PyTorch port, against the JAX package's.

The twin of ``tests/test_scenario.py``: the same cases on the port's
``parameter_server_tpu_torch.scenario`` (the 8-node smoke scenario in
tier-1; the 50-node reference and the 200-node drill ``slow``, as there),
plus the cross-package checks: the same seed compiles to the same schedule
and runs to the same canonical scorecard in both packages, and the port's
incident report raises where a repo tool it needs cannot be imported.
"""

import json
import pathlib
import sys

import pytest

from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.scenario import (
    Fault,
    LoadCurve,
    Phase,
    Scenario,
    ScenarioRunner,
    compile_schedule,
    drill_scenario,
    reference_scenario,
    render_report,
    smoke_scenario,
)
from parameter_server_tpu_torch.scenario.scorecard import (
    scorecard_json,
    worst_breach_window,
)

REPO = pathlib.Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO / "tools"))

import pstop  # noqa: E402


@pytest.fixture(autouse=True)
def _clean_ring():
    flightrec.configure(clear=True)
    yield
    flightrec.configure(clear=True)


def _run(scenario, **kw):
    r = ScenarioRunner(scenario, **kw)
    try:
        return r, r.run()
    finally:
        r.close()


# ------------------------------------------------------------------- DSL


def test_compile_schedule_is_deterministic_and_ordered():
    a = compile_schedule(smoke_scenario(7))
    b = compile_schedule(smoke_scenario(7))
    assert a == b
    assert json.dumps(a, sort_keys=True) == json.dumps(b, sort_keys=True)
    ts = [e["t"] for e in a]
    assert ts == sorted(ts)
    assert a[0]["event"] == "hot_shift" and a[-1]["event"] == "end"
    kinds = {e["event"] for e in a}
    assert {"phase", "inject", "heal", "end"} <= kinds
    # a different seed picks different victims (schedule shape persists)
    c = compile_schedule(smoke_scenario(8))
    assert [e["event"] for e in c] == [e["event"] for e in a]
    assert c != a


def test_drill_scenario_compiles_cascades_waves_and_scale_events():
    sched = compile_schedule(drill_scenario(3))
    by_kind = {}
    for e in sched:
        by_kind.setdefault(e["event"], []).append(e)
    slow = [e for e in by_kind["inject"] if e["fault"] == "slow_node"]
    assert len(slow) >= 3  # primary + cascade of 2
    assert len({e["node"] for e in slow}) == len(slow)  # distinct victims
    restarts = [e for e in by_kind["inject"] if e["fault"] == "restart"]
    assert len(restarts) == 3
    assert {e["action"] for e in by_kind["scale"]} == {
        "scale_up", "drain_down"
    }


def test_dsl_rejects_malformed_specs():
    with pytest.raises(ValueError):
        LoadCurve(kind="square_wave")
    with pytest.raises(ValueError):
        LoadCurve(kind="flash_crowd", peak=0.5)
    with pytest.raises(ValueError):
        Phase("p", duration_s=0.0)
    with pytest.raises(ValueError):
        Fault(kind="meteor", phase="p", at_s=1.0)
    with pytest.raises(ValueError):
        Fault(kind="slow_node", phase="p", at_s=-1.0)
    phases = (Phase("p", duration_s=10.0),)
    with pytest.raises(ValueError):
        Scenario("s", seed=0, nodes=1, phases=phases)
    with pytest.raises(ValueError):
        Scenario("s", seed=0, nodes=4, phases=())
    with pytest.raises(ValueError):
        Scenario("s", seed=0, nodes=4, phases=phases, faults=(
            Fault(kind="slow_node", phase="nope", at_s=1.0),
        ))
    with pytest.raises(ValueError):
        Scenario("s", seed=0, nodes=4, phases=(
            Phase("p", 10.0), Phase("p", 10.0),
        ))


def test_load_curves_shape_the_multiplier():
    flat = LoadCurve()
    assert flat.multiplier(0.0) == flat.multiplier(999.0) == 1.0
    flash = LoadCurve(kind="flash_crowd", at_s=10.0, ramp_s=5.0,
                      hold_s=10.0, peak=3.0)
    assert flash.multiplier(0.0) == pytest.approx(1.0)
    assert flash.multiplier(12.5) == pytest.approx(2.0)   # mid-ramp
    assert flash.multiplier(20.0) == pytest.approx(3.0)   # on the plateau
    assert flash.multiplier(60.0) == pytest.approx(1.0)   # decayed
    diurnal = LoadCurve(kind="diurnal", period_s=100.0, amplitude=0.5)
    tops = max(diurnal.multiplier(t) for t in range(100))
    bots = min(diurnal.multiplier(t) for t in range(100))
    assert tops == pytest.approx(1.5, abs=0.01)
    assert bots == pytest.approx(0.5, abs=0.01)


# ---------------------------------------------- tier-1: 8-node smoke run


def test_smoke_run_is_bit_reproducible_and_autoscaler_earns_its_keep():
    s = smoke_scenario(0)
    _, card_a = _run(s)
    flightrec.configure(clear=True)
    _, card_b = _run(s)
    # acceptance: identical schedules AND identical canonical scorecards
    assert compile_schedule(s) == compile_schedule(s)
    assert scorecard_json(card_a) == scorecard_json(card_b)
    # the scenario bites: breaches happen, the partition eats frames
    assert card_a["slo"]["breach_minutes"] > 0
    assert card_a["slo"]["timeline"]
    assert card_a["totals"]["partition_dropped_frames"] > 0
    assert card_a["totals"]["served"] > 0
    # honest publishers, fleet-scaled rings: zero dedup drops
    assert card_a["telemetry"]["dedup_drops"] == 0
    # acceptance: closed loop beats open loop on the SAME scenario
    flightrec.configure(clear=True)
    _, card_off = _run(s, autoscale=False)
    assert card_off["autoscaler"]["enabled"] is False
    assert (
        card_a["slo"]["breach_minutes"] < card_off["slo"]["breach_minutes"]
    )
    assert card_a["autoscaler"]["actions"]  # it actually acted


def test_smoke_run_lights_up_the_observability_surface(tmp_path):
    s = smoke_scenario(0)
    spill = str(tmp_path / "telemetry.jsonl")
    runner = ScenarioRunner(s, jsonl_path=spill)
    try:
        card = runner.run()
        # scenario.* events in the flight recorder, in wall order
        kinds = [e["kind"] for e in flightrec.get().events()
                 if e["kind"].startswith("scenario.")]
        assert kinds[0] == "scenario.begin" and kinds[-1] == "scenario.end"
        assert "scenario.phase" in kinds and "scenario.inject" in kinds
        assert "scenario.heal" in kinds
        # live rows carry the running phase + breach-minutes in ctl
        latest = runner.agg.latest()
        row = next(iter(latest.values()))
        assert row["ctl"]["phase"] == s.phases[-1].name
        assert row["ctl"]["breach_min"] == pytest.approx(
            card["slo"]["breach_minutes"], abs=0.2
        )
        # the pstop footer rolls the fleet up from the same rows
        out = "\n".join(pstop.render(latest))
        assert "== FLEET" in out
        assert f"phase={s.phases[-1].name}" in out
        assert "breach-min=" in out and "breach-min=-" not in out
        # incident report: worst window + postmortem chain + critpath
        report = "\n".join(render_report(runner, card))
        assert "-- worst breach window:" in report
        assert "postmortem chain" in report
        assert "slo.breach" in report or "scenario.inject" in report
        assert "critpath attribution" in report
        worst = worst_breach_window(card)
        assert worst is not None and worst["t1"] > worst["t0"]
    finally:
        runner.close()
    # the spill file (flushed by close) feeds the same footer out-of-process
    rows = pstop.load_rows(spill)
    assert pstop.fleet_summary(rows)["phase"] is not None


def test_restart_wave_fences_stale_writes_without_dedup_drops():
    s = Scenario(
        "restarts", seed=4, nodes=4,
        phases=(Phase("steady", duration_s=60.0),),
        faults=(
            Fault(kind="restart_wave", phase="steady", at_s=10.0,
                  count=2, gap_s=15.0, duration_s=6.0),
        ),
        base_qps=300.0, node_capacity_qps=120.0,
    )
    _, card = _run(s, autoscale=False)
    assert card["totals"]["restarts"] == 2
    assert card["totals"]["fence_rejects"] > 0
    # same-id restart resumes the same publisher: no seq-dedup casualties
    assert card["telemetry"]["dedup_drops"] == 0


def test_forced_scale_events_move_bytes_and_reshape_the_fleet():
    s = Scenario(
        "reshape", seed=1, nodes=4,
        phases=(Phase("steady", duration_s=40.0),),
        faults=(
            Fault(kind="scale_up", phase="steady", at_s=10.0),
            Fault(kind="drain_down", phase="steady", at_s=25.0),
        ),
    )
    runner, card = _run(s, autoscale=False)
    assert card["fleet"]["start"] == card["fleet"]["end"] == 4
    assert card["totals"]["bytes_migrated"] > 0
    acts = [a["kind"] for a in card["autoscaler"]["actions"]]
    assert acts == ["scale_up", "drain_down"]


# ----------------------------------------------------- slow: 50 and 200


@pytest.mark.slow
def test_reference_scenario_50_nodes_reproducible_and_scored():
    s = reference_scenario(0)
    assert s.nodes == 50
    _, card_a = _run(s)
    flightrec.configure(clear=True)
    _, card_b = _run(s)
    assert scorecard_json(card_a) == scorecard_json(card_b)
    assert card_a["slo"]["breach_minutes"] > 0
    flightrec.configure(clear=True)
    _, card_off = _run(s, autoscale=False)
    assert (
        card_a["slo"]["breach_minutes"] < card_off["slo"]["breach_minutes"]
    )


@pytest.mark.slow
def test_drill_200_nodes_rings_scale_and_report_renders():
    s = drill_scenario(0)
    assert s.nodes == 200
    runner = ScenarioRunner(s)
    try:
        card = runner.run()
        # satellite: ring budget re-capped for 200 publishers, zero dedup
        assert card["telemetry"]["dedup_drops"] == 0
        cap = card["telemetry"]["ring_cap_per_node"]
        assert cap == runner.agg.config.node_window(len(runner.nodes))
        assert cap < runner.agg.config.window
        report = "\n".join(render_report(runner, card))
        assert "-- worst breach window:" in report
    finally:
        runner.close()


# ------------------------------------------------- against the JAX package


def _jax_run(scenario, **kw):
    from parameter_server_tpu.core import flightrec as jax_flightrec
    from parameter_server_tpu.scenario import ScenarioRunner as JaxRunner

    jax_flightrec.configure(clear=True)
    r = JaxRunner(scenario, **kw)
    try:
        return r, r.run()
    finally:
        r.close()
        jax_flightrec.configure(clear=True)


def _jax_twin(scenario):
    """The same scenario built from the JAX package's dataclasses."""
    import dataclasses

    from parameter_server_tpu.scenario import dsl as jax_dsl

    def conv(obj):
        if dataclasses.is_dataclass(obj):
            cls = getattr(jax_dsl, type(obj).__name__)
            return cls(**{f.name: conv(getattr(obj, f.name))
                          for f in dataclasses.fields(obj)})
        if isinstance(obj, tuple):
            return tuple(conv(v) for v in obj)
        if isinstance(obj, list):
            return [conv(v) for v in obj]
        return obj

    return conv(scenario)


@pytest.mark.parametrize("build", ["smoke", "drill"])
def test_schedules_equal_the_jax_package(build):
    from parameter_server_tpu.scenario import dsl as jax_dsl

    mine = {"smoke": smoke_scenario, "drill": drill_scenario}[build](3)
    theirs = getattr(jax_dsl, f"{build}_scenario")(3)
    assert compile_schedule(mine) == jax_dsl.compile_schedule(theirs)


@pytest.mark.parametrize("autoscale", [True, False], ids=["autoscale", "open_loop"])
def test_smoke_scorecard_equals_the_jax_runner(autoscale):
    from parameter_server_tpu.scenario.scorecard import scorecard_json as jax_json

    s = smoke_scenario(0)
    _, card = _run(s, autoscale=autoscale)
    _, jax_card = _jax_run(_jax_twin(s), autoscale=autoscale)
    assert scorecard_json(card) == jax_json(jax_card)


def test_custom_scenario_scorecard_equals_the_jax_runner():
    from parameter_server_tpu.scenario.scorecard import scorecard_json as jax_json

    s = Scenario(
        "restarts", seed=4, nodes=4,
        phases=(Phase("steady", duration_s=60.0),),
        faults=(
            Fault(kind="restart_wave", phase="steady", at_s=10.0,
                  count=2, gap_s=15.0, duration_s=6.0),
            Fault(kind="scale_up", phase="steady", at_s=30.0),
        ),
        base_qps=300.0, node_capacity_qps=120.0,
    )
    _, card = _run(s, autoscale=False)
    _, jax_card = _jax_run(_jax_twin(s), autoscale=False)
    assert scorecard_json(card) == jax_json(jax_card)


def test_report_raises_where_a_tool_cannot_be_imported(monkeypatch):
    from parameter_server_tpu_torch.scenario import scorecard as sc

    s = smoke_scenario(0)
    runner = ScenarioRunner(s)
    try:
        card = runner.run()
        monkeypatch.setattr(sc, "_TOOLS", REPO / "no_such_tools_dir")
        monkeypatch.delitem(sys.modules, "critpath", raising=False)
        monkeypatch.delitem(sys.modules, "postmortem", raising=False)
        monkeypatch.setattr(sys, "path", [p for p in sys.path
                                          if pathlib.Path(p).resolve() != REPO / "tools"])
        with pytest.raises(ImportError, match="postmortem"):
            sc.render_report(runner, card)
    finally:
        runner.close()
