"""The harness: files found by name, the contract's shape of BENCHMARK.json
and of the result line, the refusal to measure without a card, and the
import rule."""

from __future__ import annotations

import json
import os
import re
import shutil
import subprocess
import sys

import pytest
import torch

from psbench import run

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


def _one_line(text: str) -> bool:
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_benchmark_json_keeps_the_contract():
    spec = run.bench_spec()
    assert set(spec) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert spec["command"] == ["python3", "psbench/run.py"] and spec["paths"] == ["psbench"]
    assert isinstance(spec["run_seconds"], int) and 1 <= spec["run_seconds"] <= 51
    # a full check of 24 cells fits its time
    assert (2 + 14 * 24) * (spec["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
    names = [x["name"] for k in ("configs", "workloads", "end_to_end", "per_layer")
             for x in spec[k]]
    assert len(names) == len(set(names)) and all(NAME.match(n) for n in names)
    for c in spec["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _one_line(c["source"]) and _one_line(c["why"]) and len(c["reduced"]) <= 16
        assert c["file"].startswith("psbench/") and all(NAME.match(k) for k in c["reduced"])
    cells = {w["name"]: w for w in spec["workloads"]}
    assert len({(w["config"], w["traffic"]) for w in cells.values()}) == len(cells)
    for w in cells.values():
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _one_line(w["why"]) and NAME.match(w["traffic"])
    assert {c["name"] for c in spec["configs"]} == {w["config"] for w in cells.values()}
    for m in spec["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in {"host_clock", "device_trace"} and UNIT.match(m["unit"])
        assert 0.01 <= m["bound"] <= 0.25 and m["better"] in ("lower", "higher")
    for m in spec["per_layer"]:
        assert set(m) == {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["source"] in SOURCES and UNIT.match(m["unit"]) and _one_line(m["layer"])
        for name in m["workloads"]:  # each listed cell reports what it moves
            assert m["moves"] in run.end_to_end_metrics(spec, cells[name])
    for cell in cells.values():
        e2e = run.end_to_end_metrics(spec, cell)
        assert "setup_s" in e2e and len(e2e) >= 2 and run.per_layer_metrics(spec, cell)
    assert len(json.dumps(spec)) <= 64 * 1024


def test_every_file_is_found_by_name():
    spec = run.bench_spec()
    for cell in spec["workloads"]:
        _, cfg, workload = run.load_cell(spec, cell["name"])
        driver = __import__(f"psbench.drivers.{workload['driver']}", fromlist=["Driver"])
        assert hasattr(driver, "Driver") and driver.RATE in run.end_to_end_metrics(spec, cell)
        assert set(workload["limits"]) and workload["trace_steps"] >= 1
    for metric in spec["per_layer"]:
        assert callable(run.reader(metric["name"]).read)


def _check_result(result: dict, trace: bool):
    keys = ["correct", "attempted", "failed", "metrics", "device"]
    keys += ["breakdown", "checks"] if trace else ["checks"]
    assert list(result) == keys  # the checks come last
    assert set(result["device"]) >= {"platform", "kind", "count", "memory_peak_bytes"}
    for check in result["checks"].values():
        assert set(check) == {"value", "limit"}
    if trace:
        assert set(result["device"]) >= {"busy_s", "window_s"}
        assert set(result["breakdown"]) == {"device_ops", "idle_gaps"}
    json.dumps(result)


@pytest.mark.parametrize("name", ["criteo-lr.local-b16k", "mistral-7b-hybrid.s512-b8"])
@pytest.mark.parametrize("trace", [False, True])
def test_a_run_gives_the_contracts_line(tiny, name, trace):
    spec, cell, cfg, workload = tiny(name)
    result = run.run_cell(torch, spec, cell, cfg, workload, seed=2**31 + 11, seconds=0.3,
                          trace=trace, device="cpu", t0=0.0)
    _check_result(result, trace)
    assert result["correct"] is True and result["failed"] == 0 and result["attempted"] > 0
    want = ({m["name"] for m in run.per_layer_metrics(spec, cell)} if trace
            else set(run.end_to_end_metrics(spec, cell)))
    # device metrics are never read from a CPU run
    assert set(result["metrics"]) <= want and "mfu.examples" not in result["metrics"]
    if not trace:
        assert set(result["metrics"]) == want
        assert all(v["value"] > 0 for v in result["metrics"].values())


def test_trace_reduction_unions_device_intervals_within_the_syncs():
    """Busy time is the union of device intervals between the two device
    syncs (overlap on two streams counted once, what lies outside cut off);
    each idle gap is named by the CUDA call running at its middle, or else
    by the device operation that ends it."""
    def ev(cat, name, ts, dur):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [ev("cuda_runtime", "cudaDeviceSynchronize", 0, 10),
              ev("kernel", "a", 5, 25),  # starts before the stretch
              ev("kernel", "b", 20, 20), ev("gpu_memcpy", "copy", 35, 15),  # overlap
              ev("cuda_runtime", "cudaStreamSynchronize", 55, 10),
              ev("kernel", "c", 70, 20),
              ev("kernel", "d", 95, 15),
              ev("cuda_runtime", "cudaDeviceSynchronize", 100, 20),
              ev("kernel", "late", 130, 10)]  # after the stretch
    got = run.reduce_trace(events, wall=1.0)
    assert got["window_s"] == pytest.approx(110e-6)
    # [10, 50] + [70, 90] + [95, 110]
    assert got["busy_s"] == pytest.approx(75e-6)
    gaps = dict(got["breakdown"]["idle_gaps"])
    assert gaps == pytest.approx({"cudaStreamSynchronize": 20e-6,
                                  "host code, before d": 5e-6, "cudaDeviceSynchronize": 10e-6})
    assert dict(got["breakdown"]["device_ops"])["a"] == pytest.approx(25e-6)


def _cli(args, cwd, env=None):
    return subprocess.run([sys.executable, "psbench/run.py", *args], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=120)


def test_run_refuses_to_measure_without_a_card():
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    got = _cli(["--workload", "criteo-lr.local-b16k", "--seed", str(2**31 + 3),
                "--seconds", "1", "--trace", "0"], run.ROOT, env)
    assert got.returncode != 0 and got.stdout == ""
    assert "no CUDA card" in got.stderr


def test_run_needs_the_program(card, tmp_path):
    """In a directory that holds only BENCHMARK.json and psbench/, a run
    fails and prints no result."""
    shutil.copy(run.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(run.BENCH, tmp_path / "psbench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    got = _cli(["--workload", "criteo-lr.local-b16k", "--seed", "5", "--seconds", "1",
                "--trace", "0"], tmp_path)
    assert got.returncode != 0 and got.stdout == ""


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "parameter_server_tpu_torch_fake", object())
    assert run.forbidden_modules() == []
    monkeypatch.setitem(sys.modules, "parameter_server_tpu.fake", object())
    assert run.forbidden_modules() == ["parameter_server_tpu"]


def test_run_prints_no_result_once_jax_is_loaded(monkeypatch, capsys):
    monkeypatch.setattr(run, "check_card", lambda torch, chips: None)
    monkeypatch.setattr(run, "run_cell", lambda *a, **k: {"correct": True, "checks": {}})
    monkeypatch.setitem(sys.modules, "jax", object())
    code = run.main(["--workload", "criteo-lr.local-b16k", "--seed", "1", "--seconds", "1"])
    out = capsys.readouterr()
    assert code != 0 and out.out == "" and "jax" in out.err


def test_no_module_a_run_loads_is_jax_or_the_jax_package():
    """Every module a run loads (both drivers, traced, then the reference),
    by top-level name compared whole."""
    code = f"""
import sys, json
sys.path.insert(0, {str(run.ROOT / 'psbench' / 'tests')!r})
sys.path.insert(0, {str(run.ROOT)!r})
import torch
from conftest import tiny_cell
from psbench import run
for name in ("criteo-lr.local-b16k", "mistral-7b-hybrid.s512-b8"):
    spec, cell, cfg, wl = tiny_cell(name)
    assert run.run_cell(torch, spec, cell, cfg, wl, seed=3, seconds=0.2, trace=True,
                        device="cpu", t0=0.0)["correct"]
print(json.dumps(sorted({{m.split(".")[0] for m in sys.modules}})))
"""
    got = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, env=dict(os.environ, USE_FLAX="0"))
    assert got.returncode == 0, got.stderr[-2000:]
    top = set(json.loads(got.stdout.strip().splitlines()[-1]))
    assert "parameter_server_tpu_torch" in top  # the port, whose name begins alike
    assert not top & set(run.FORBIDDEN)


def test_a_new_cell_config_and_metric_need_only_new_files(tmp_path, monkeypatch):
    """Adding a configuration file, a workload file, a reader and their
    entries in BENCHMARK.json is all a new cell with a new metric takes."""
    root = tmp_path / "checkout"
    shutil.copytree(run.BENCH, root / "psbench", ignore=shutil.ignore_patterns("__pycache__"))
    spec = run.bench_spec()
    cfg = json.loads((run.BENCH / "configs" / "criteo-lr.json").read_text())
    cfg.update(table_rows=2048)
    (root / "psbench" / "configs" / "criteo-lr-small.json").write_text(json.dumps(cfg))
    wl = json.loads((run.BENCH / "workloads" / "criteo-lr.local-b16k.json").read_text())
    wl["traffic"].update(batch=32, nnz=3, key_space=1 << 12, block=2)
    (root / "psbench" / "workloads" / "criteo-lr-small.b32.json").write_text(json.dumps(wl))
    (root / "psbench" / "layer_metrics" / "steps_a_window.examples.py").write_text(
        "def read(run):\n    return float(run['steps'])\n")
    spec["configs"].append({"name": "criteo-lr-small", "source": "https://example.org/x",
                            "file": "psbench/configs/criteo-lr-small.json",
                            "reduced": ["table_rows"], "why": "a test"})
    spec["workloads"].append({"name": "criteo-lr-small.b32", "config": "criteo-lr-small",
                              "traffic": "b32", "chips": 1, "why": "a test"})
    for m in spec["end_to_end"]:
        if m["name"] == "examples_per_s":
            m["workloads"].append("criteo-lr-small.b32")
    spec["per_layer"].append({"name": "steps_a_window.examples", "unit": "steps",
                              "better": "higher", "source": "host_clock", "layer": "ingest",
                              "moves": "examples_per_s", "workloads": ["criteo-lr-small.b32"]})
    (root / "BENCHMARK.json").write_text(json.dumps(spec))
    monkeypatch.setattr(run, "ROOT", root)
    monkeypatch.setattr(run, "BENCH", root / "psbench")
    spec = run.bench_spec()
    cell, cfg, wl = run.load_cell(spec, "criteo-lr-small.b32")
    result = run.run_cell(torch, spec, cell, cfg, wl, seed=9, seconds=0.2, trace=True,
                          device="cpu", t0=0.0)
    assert result["correct"] is True
    assert result["metrics"]["steps_a_window.examples"]["value"] == result["attempted"]

