"""The port's wire-enforced consistency gate and sync push against the JAX
package's, on the CPU.

Units: ``FleetClock`` and ``BoundTuner`` driven by the same call sequences
in both packages give the same answers.  Wire: 2 workers x 2 servers on a
``LoopbackVan`` in each package — the gate parks a worker that ran ahead
and releases it when the fleet advances (observed through the worker's
``consist_waits`` with a bounded wait, never a fixed sleep); the
``__wait__`` reply is fence-shaped with the JAX package's payload; BSP
under a strict alternation equals the ungated run; a push held past the
gate deadline is forced through, never dropped, and a pull sheds to the
stale hot-row cache when it covers the waited rows; the live mode flip; the
sync push's routing-fence retry, message for message; the worker's
counter and digest keys.  Under ``ReliableVan(ChaosVan(...))`` with drop,
duplication and delay, 3 workers under SSP(2) through a live migration and a
same-id worker restart: the all-live clocks never spread past bound + 1, the
dead incarnation's entry is pruned, every worker finishes and nothing is
forced or shed; the straggler is held on the gate's defers, not on sleeps.

Tolerances: host code (clock answers, tuner decisions, payloads, counters,
message counts) exactly; tables bitwise within the port and within rtol =
atol = 1e-5 against the JAX package (the same float math in two
frameworks).
"""

import dataclasses
import threading
import time
import types

import numpy as np
import pytest

from parameter_server_tpu import config as jax_config
from parameter_server_tpu.core import flightrec as jax_flightrec
from parameter_server_tpu.core import netmon as jax_netmon
from parameter_server_tpu.core import postoffice as jax_postoffice
from parameter_server_tpu.core import van as jax_van
from parameter_server_tpu.kv import cache as jax_cache
from parameter_server_tpu.kv import consistency as jax_consistency
from parameter_server_tpu.kv import routing as jax_routing
from parameter_server_tpu.kv import server as jax_server
from parameter_server_tpu.kv import worker as jax_worker
from parameter_server_tpu_torch import config
from parameter_server_tpu_torch.core import flightrec, netmon, postoffice, van
from parameter_server_tpu_torch.kv import cache, consistency, routing, server, worker
from parameter_server_tpu_torch.utils.trace import LatencyHistogram

ROWS = 1 << 8
DIM = 4
NUM_SERVERS = 2
TOL = dict(rtol=1e-5, atol=1e-5)
KEYS = np.arange(8, dtype=np.int64)
GRADS = np.ones((8, DIM), dtype=np.float32)

JAX = types.SimpleNamespace(
    cfg=jax_config, post=jax_postoffice, van=jax_van, routing=jax_routing,
    server=jax_server, worker=jax_worker, consistency=jax_consistency,
    flightrec=jax_flightrec, netmon=jax_netmon, cache=jax_cache, kw={},
)
PORT = types.SimpleNamespace(
    cfg=config, post=postoffice, van=van, routing=routing, server=server,
    worker=worker, consistency=consistency, flightrec=flightrec, netmon=netmon,
    cache=cache, kw={"device": "cpu"},
)
PKGS = {"jax": JAX, "port": PORT}


def _table_cfgs(pkg, mode=None, bound=0, *, deadline=30.0):
    consistency_cfg = None
    if mode is not None:
        consistency_cfg = pkg.cfg.ConsistencyConfig(
            mode=pkg.cfg.ConsistencyMode(mode), max_delay=bound, gate_deadline_s=deadline)
    return {"w": pkg.cfg.TableConfig(
        name="w", rows=ROWS, dim=DIM,
        optimizer=pkg.cfg.OptimizerConfig(kind="sgd", learning_rate=0.1),
        consistency=consistency_cfg,
    )}


def _cluster(pkg, v, cfgs, n_workers=2, server_routing=None, worker_routing=None,
             caches=None):
    servers = [pkg.server.KVServer(pkg.post.Postoffice(f"S{s}", v), cfgs, s, NUM_SERVERS,
                                   routing=server_routing, **pkg.kw)
               for s in range(NUM_SERVERS)]
    workers = [pkg.worker.KVWorker(pkg.post.Postoffice(f"W{i}", v), cfgs, NUM_SERVERS,
                                   routing=worker_routing, cache=(caches or {}).get(i),
                                   **pkg.kw)
               for i in range(n_workers)]
    return servers, workers


def _close(v, servers):
    v.close()
    for s in servers:
        if s.ledger is not None:
            s.ledger.close()


def _step(w, keys, grads, timeout=30.0):
    vals = w.pull_sync("w", keys, timeout=timeout)
    w.push_sync("w", keys, grads, timeout=timeout)
    return vals


def _until(predicate, deadline_s=10.0):
    deadline = time.monotonic() + deadline_s
    while not predicate():
        if time.monotonic() > deadline:
            return False
        time.sleep(0.002)
    return True


def _tables(servers):
    return [np.asarray(s.export_shard()["w"]["value"]) for s in servers]


# --------------------------------------------------------- FleetClock units


def _clock_script(mod):
    """One call sequence over every FleetClock method; returns the answers."""
    out = []
    c = mod.FleetClock()
    c.hello("W0", 0)
    c.hello("W1", 0)
    out.append(c.gate("W0", 0, 0))
    c.commit("W0", 0)
    out += [c.gate("W0", 1, 0), c.gate("W0", 1, 1), c.gate("W0", 7, None), c.snapshot()]
    c.commit("W1", 0)
    out.append(c.fleet_min())
    # incarnation advance prunes the corpse; an older hello cannot resurrect
    c.hello("W2", 0, step=0)
    c.on_incarnation_advance("W2", 1)
    out += [c.pruned, c.fleet_min(), c.size()]
    c.hello("W2", 1, step=7)
    c.hello("W2", 0, step=0)
    out += [c.fleet_min(), c.snapshot()]
    c.forget("W2")
    c.observe("W3", 4)
    out += [c.snapshot(), c.pruned, c.gate("W3", 9, 2)]
    # a single worker never gates
    single = mod.FleetClock()
    single.hello("W0", 0)
    for s in range(20):
        out.append(single.gate("W0", s, 0))
        single.commit("W0", s)
    return out


def test_fleet_clock_answers_match_jax():
    assert _clock_script(consistency) == _clock_script(jax_consistency)
    assert consistency.MODE_CODES.keys() == {
        config.ConsistencyMode.BSP, config.ConsistencyMode.SSP, config.ConsistencyMode.ASP}
    assert {k.value: v for k, v in consistency.MODE_CODES.items()} == \
        {k.value: v for k, v in jax_consistency.MODE_CODES.items()}
    assert consistency.MODE_NAMES == jax_consistency.MODE_NAMES


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_fleet_clock_idle_prune_unwedges_the_gate(pkg):
    c = PKGS[pkg].consistency.FleetClock(idle_timeout_s=0.05)
    c.hello("W0", 0)
    c.hello("W1", 0)
    c.commit("W0", 0)
    assert not c.gate("W0", 1, 0)[0]  # W1 holds the minimum
    time.sleep(0.08)  # W1 goes silent past the idle timeout
    assert c.gate("W0", 1, 0) == (True, 1)
    assert (c.pruned, c.size()) == (1, 1)


def _tuner_script(mod, cfg_mod):
    cfg = cfg_mod.ConsistencyConfig(mode=cfg_mod.ConsistencyMode.SSP, max_delay=4)
    t = mod.BoundTuner(cfg, min_bound=1, max_bound=16, window=4, cooldown_s=10.0)
    out = [t.maybe_retune(0.0, wire_bottleneck=True), t.maybe_retune(5.0, wire_bottleneck=True),
           t.maybe_retune(11.0, wire_bottleneck=True), t.maybe_retune(22.0, wire_bottleneck=True)]
    for x in [1.0, 1.01, 0.99, 1.0, 1.0, 3.0, -1.0, 2.5, float("nan")]:
        t.observe_loss(x)
    out += [t.maybe_retune(40.0, wire_bottleneck=True), t.maybe_retune(60.0,
                                                                      wire_bottleneck=False)]
    out += [t.bound, t.retunes]
    with pytest.raises(ValueError):
        mod.BoundTuner(cfg_mod.ConsistencyConfig(mode=cfg_mod.ConsistencyMode.BSP))
    return out


def test_bound_tuner_decisions_match_jax():
    got = _tuner_script(consistency, config)
    assert got == _tuner_script(jax_consistency, jax_config)
    assert got[:4] == [(8, "gate-wait SLO breach: widen"), None,
                       (16, "gate-wait SLO breach: widen"), None]
    assert got[4][0] == 8 and "tighten" in got[4][1]


# ------------------------------------------------------ wire enforcement


def test_ssp_gate_parks_fast_worker_until_release():
    """A worker 2 steps ahead of the fleet minimum under bound 1 is parked
    by ``__wait__`` replies — never dropped — and admitted once the
    straggler commits.  The park is observed through ``consist_waits``
    (bounded wait), not after a fixed sleep."""
    flightrec.configure(enabled=True, clear=True)
    v = van.LoopbackVan()
    servers, (wa, wb) = _cluster(PORT, v, _table_cfgs(PORT, "ssp", 1))
    try:
        wa.consist_hello(table="w")
        wb.consist_hello(table="w")
        done = threading.Event()

        def fast():
            for _ in range(3):
                _step(wa, KEYS, GRADS)
            done.set()

        th = threading.Thread(target=fast, daemon=True)
        th.start()
        assert _until(lambda: wa.consist_waits > 0), "worker A was never deferred"
        assert not done.is_set(), "worker A outran the bound ungated"
        assert wa.consist_step("w") == 2  # parked at its third step
        _step(wb, KEYS, GRADS)  # the straggler commits: fleet_min -> 1
        assert done.wait(10), "gate never released after the fleet advanced"
        th.join(timeout=5)
        sc = {}
        for s in servers:
            for k, val in s.counters().items():
                sc[k] = sc.get(k, 0) + val
        assert sc["consist_defers"] > 0 and sc["consist_releases"] >= 1
        events = [e for e in flightrec.get().events() if e.get("node") in ("S0", "S1")]
        gates = [e for e in events if e["kind"] == "consist.gate"]
        rels = [e for e in events if e["kind"] == "consist.release"]
        assert gates and len(gates) == len(rels) == sc["consist_releases"]
        assert all(g["sender"] == "W0" for g in gates)
        assert wa.latency_digests()["consist.gate_wait"]["count"] >= 1
        assert wa.counters()["consist_waits"] == wa.consist_waits
        assert (wa.consist_step("w"), wb.consist_step("w")) == (3, 1)
    finally:
        _close(v, servers)


def _first_wait_payload(pkg):
    """The first ``__wait__`` reply of a BSP fleet: W0's second step parks
    behind W1; returns its payload (spied in ``_scan_waits``)."""
    v = pkg.van.LoopbackVan()
    captured = []
    orig = pkg.worker.KVWorker._scan_waits

    def spy(responses, order):
        for r in responses:
            p = r.task.payload
            if p.get(pkg.routing.WAIT_KEY):
                captured.append(dict(p))
        return orig(responses, order)

    servers, (wa, wb) = _cluster(pkg, v, _table_cfgs(pkg, "bsp"))
    try:
        wa.consist_hello(table="w")
        wb.consist_hello(table="w")
        pkg.worker.KVWorker._scan_waits = staticmethod(spy)
        _step(wa, KEYS, GRADS)  # step 0: admitted
        done = threading.Event()
        th = threading.Thread(target=lambda: (_step(wa, KEYS, GRADS), done.set()), daemon=True)
        th.start()
        assert _until(lambda: wa.consist_waits > 0)  # step 1 parks behind W1
        _step(wb, KEYS, GRADS)
        assert done.wait(10)
        th.join(timeout=5)
        return captured[0]
    finally:
        pkg.worker.KVWorker._scan_waits = staticmethod(orig)
        _close(v, servers)


def test_wait_reply_is_fence_shaped_with_the_jax_payload():
    """A ``__wait__`` reply carries the fence keys (a worker without the
    gate retries it as a fence) and the typed fields; every key and value
    equals the JAX package's reply to the same request."""
    port, ref = _first_wait_payload(PORT), _first_wait_payload(JAX)
    assert port[routing.FENCED_KEY] is True and port[routing.WAIT_KEY] is True
    assert "consistency gate" in port["__error__"]
    assert port["clock"] == {"W0": 1, "W1": 0}
    assert port["bound"] == 0 and port["retry_after"] > 0
    ref.pop("__trace__", None)  # the JAX worker's sampled request tracing
    assert port == ref


def _bsp_run(pkg, gated, keys, grads):
    v = pkg.van.LoopbackVan()
    servers, (wa, wb) = _cluster(pkg, v, _table_cfgs(pkg, "bsp" if gated else None))
    try:
        if gated:
            wa.consist_hello(table="w")
            wb.consist_hello(table="w")
        for i in range(6):  # strict alternation: a rendezvous schedule
            _step((wa, wb)[i % 2], keys[i], grads[i])
        return wa.pull_sync("w", np.arange(ROWS, dtype=np.int64)), _tables(servers)
    finally:
        _close(v, servers)


def test_bsp_wire_is_bitwise_equal_to_the_ungated_path():
    """Gating only defers requests before apply, so a lockstep schedule
    admits everything untouched: the gated table is bit-identical to the
    ungated path's in the port, and within 1e-5 of the JAX package's."""
    rng = np.random.default_rng(5)
    keys = rng.choice(ROWS, size=(6, 8), replace=False).astype(np.int64)
    grads = rng.normal(size=(6, 8, DIM)).astype(np.float32)
    ungated, ungated_shards = _bsp_run(PORT, False, keys, grads)
    gated, gated_shards = _bsp_run(PORT, True, keys, grads)
    np.testing.assert_array_equal(gated, ungated)
    for a, b in zip(gated_shards, ungated_shards):
        np.testing.assert_array_equal(a, b)
    ref, _ = _bsp_run(JAX, True, keys, grads)
    np.testing.assert_allclose(gated, ref, **TOL)


def _forced_run(pkg, gated):
    v = pkg.van.LoopbackVan()
    cfgs = _table_cfgs(pkg, "ssp", 0, deadline=0.3) if gated else _table_cfgs(pkg)
    servers, (wa, wb) = _cluster(pkg, v, cfgs)
    try:
        if gated:
            wa.consist_hello(table="w")
            wb.consist_hello(table="w")
        _step(wa, KEYS, GRADS)  # step 0
        _step(wa, KEYS, GRADS)  # step 1: pull and push forced through
        return wa.counters(), _tables(servers)
    finally:
        _close(v, servers)


def test_gate_deadline_forces_push_through_never_dropped():
    """A push (and a pull: this worker has no stale cache to shed to) held
    past the gate deadline is forced through ungated, journaled as
    ``consist.shed`` ``how=forced``; the gradient is never dropped, so the
    table equals an ungated run of the same two steps exactly, and the JAX
    package's forced run within 1e-5."""
    flightrec.configure(enabled=True, clear=True)
    counters, degraded = _forced_run(PORT, True)
    _, control = _forced_run(PORT, False)
    for a, b in zip(degraded, control):
        np.testing.assert_array_equal(a, b)
    assert counters["consist_forced"] == 2
    assert counters["consist_degraded"] == counters["consist_sheds"] + counters["consist_forced"]
    sheds = [e for e in flightrec.get().events() if e["kind"] == "consist.shed"
             and e.get("node") == "W0"]
    assert sorted((e["op"], e["how"]) for e in sheds) == [("pull", "forced"),
                                                          ("push", "forced")]
    ref_counters, ref = _forced_run(JAX, True)
    for a, b in zip(degraded, ref):
        np.testing.assert_allclose(a, b, **TOL)
    for k in ("consist_forced", "consist_sheds", "consist_degraded", "consist_step"):
        assert counters[k] == ref_counters[k], k


def _stale_shed_run(pkg):
    pkg.flightrec.configure(enabled=True, clear=True)
    v = pkg.van.LoopbackVan()
    c = pkg.cache.HotRowCache(1 << 8, node="W0")
    servers, (wa, wb) = _cluster(pkg, v, _table_cfgs(pkg, "ssp", 0, deadline=0.4),
                                 caches={0: c})
    try:
        wa.consist_hello(table="w")
        wb.consist_hello(table="w")
        _step(wa, KEYS, GRADS)  # step 0 for wa; wb never advances
        # warm the cache through the serving path (read-only, never gated)
        warm = np.asarray(wa.pull_serve("w", KEYS, timeout=30))
        t0 = time.monotonic()
        got = np.asarray(wa.pull_sync("w", KEYS, timeout=30))  # step 1: parks, sheds
        waited = time.monotonic() - t0
        sheds = [(e["how"], e["op"]) for e in pkg.flightrec.get().events()
                 if e["kind"] == "consist.shed" and e.get("node") == "W0"]
        return warm, got, waited, wa.counters(), sheds
    finally:
        _close(v, servers)


def test_gate_deadline_sheds_read_to_stale_cache():
    """A pull parked past the gate deadline answers from the hot-row cache's
    stale path (rows as the warm ``pull_serve`` got them) and journals
    ``consist.shed`` ``how=stale-cache``; nothing is forced through.  The
    JAX package's run gives the same counters and rows within 1e-5."""
    warm, got, waited, counters, sheds = _stale_shed_run(PORT)
    assert 0.4 < waited < 10
    np.testing.assert_array_equal(got, warm)
    assert counters["consist_sheds"] == 1 and counters["consist_forced"] == 0
    assert counters["consist_degraded"] == 1 and counters["consist_waits"] > 0
    assert sheds == [("stale-cache", "pull")]
    ref_warm, ref_got, _, ref_counters, ref_sheds = _stale_shed_run(JAX)
    np.testing.assert_allclose(got, ref_got, **TOL)
    np.testing.assert_allclose(warm, ref_warm, **TOL)
    for k in ("consist_sheds", "consist_forced", "consist_degraded", "consist_step"):
        assert counters[k] == ref_counters[k], k
    assert sheds == ref_sheds


def _mode_flip(pkg):
    pkg.flightrec.configure(enabled=True, clear=True)
    v = pkg.van.LoopbackVan()
    servers, (wa,) = _cluster(pkg, v, _table_cfgs(pkg, "ssp", 2), n_workers=1)
    try:
        wa.consist_hello(table="w")
        seen = [servers[0].counters()]
        wa.set_consistency(table="w", bound=8, why="test widen")
        seen.append(servers[1].counters())
        wa.set_consistency(table="w", mode="asp", why="test free-run")
        seen.append(servers[0].counters())
        wa.set_consistency(mode="ssp", why="test ssp default bound")
        seen.append(servers[1].counters())
        wa.set_consistency(mode="bsp", bound=3, why="test pinned bound")
        seen.append(servers[0].counters())
        keys = ("consist_mode", "consist_bound", "consist_defers", "consist_releases",
                "consist_clock_size", "consist_pruned")
        retunes = [{k: e[k] for k in ("table", "bound", "mode", "why")}
                   for e in pkg.flightrec.get().events() if e["kind"] == "consist.retune"]
        return [{k: c[k] for k in keys} for c in seen], retunes
    finally:
        _close(v, servers)


def test_consist_set_flips_mode_live_and_records_retune():
    port, ref = _mode_flip(PORT), _mode_flip(JAX)
    assert port == ref
    assert [(c["consist_mode"], c["consist_bound"]) for c in port[0]] == \
        [(2, 2), (2, 8), (3, -1), (2, 2), (1, 3)]
    assert [r["why"] for r in port[1]][:2] == ["test widen", "test free-run"]


def _fence_run(pkg):
    """Servers at routing epoch 1 with a moved split; the worker starts at
    epoch 0.  Its first push is fenced by both servers, adopts their table
    and re-sends the rejected positions under it; the pull then routes at
    epoch 1."""
    rows = ROWS
    moved = pkg.routing.RoutingTable(1, {"w": pkg.routing.TableRouting(
        rows, (0, 40, rows), (1, 0))})
    v0 = pkg.van.LoopbackVan()
    metered = pkg.netmon.MeteredVan(v0)
    cfgs = _table_cfgs(pkg)
    servers, (w,) = _cluster(pkg, metered, cfgs, n_workers=1, server_routing=moved)
    try:
        keys = np.array([3, 17, 39, 40, 41, 100, 250], dtype=np.int64)
        grads = np.arange(keys.size * DIM, dtype=np.float32).reshape(keys.size, DIM)
        w.push_sync("w", keys, grads, timeout=30)
        got = w.pull_sync("w", keys, timeout=30)
        links = {k: (d["msgs"], d["bytes"], d["verbs"]) for k, d in metered.links().items()}
        return {
            "epoch": w.routing.epoch,
            "counters": {k: w.counters()[k] for k in ("refresh_retries", "push_retries",
                                                      "pull_retries")},
            "fenced": [s.counters()["fenced_rejects"] for s in servers],
            "pushes": [s.pushes for s in servers],
            "links": links,
            "pulled": got,
        }
    finally:
        _close(metered, servers)


def test_push_sync_fence_retry_matches_jax_message_for_message():
    port, ref = _fence_run(PORT), _fence_run(JAX)
    # the push is fenced by both servers; the pull already routes at epoch 1
    assert port["epoch"] == 1 and port["counters"]["refresh_retries"] == 1
    assert sum(port["fenced"]) > 0 and sum(port["pushes"]) == 2
    np.testing.assert_allclose(port.pop("pulled"), ref.pop("pulled"), **TOL)
    assert port == ref


def test_counter_and_digest_keys_match_the_jax_worker():
    """After a gated step and a pull on both packages: the worker's
    ``counters()`` keys (less request tracing), ``staleness_digests()`` and
    ``latency_digests()`` keys, and the server's gate counters."""
    def run(pkg):
        v = pkg.van.LoopbackVan()
        servers, (wa, wb) = _cluster(pkg, v, _table_cfgs(pkg, "ssp", 1))
        try:
            for w in (wa, wb):
                w.consist_hello(table="w")
            for w in (wa, wb, wa):
                _step(w, KEYS, GRADS)
            wa.pull_sync("w", KEYS, timeout=30)
            counters = {k: val for k, val in wa.counters().items()
                        if not k.startswith("trace_")}
            lat = sorted(k for k in wa.latency_digests() if not k.startswith("trace."))
            srv = {k: val for k, val in servers[0].counters().items()
                   if k.startswith("consist_") or k.startswith("group_")}
            return counters, lat, srv, wa.staleness_digests()
        finally:
            _close(v, servers)

    port, ref = run(PORT), run(JAX)
    assert port[0] == ref[0]
    assert port[1] == ref[1]
    assert port[2] == ref[2]
    assert port[3] == ref[3] and "staleness.w" in port[3] and "staleness.w@S0" in port[3]


def test_ssp_spread_never_exceeds_bound_plus_one():
    """3 workers under SSP(1), worker 0 a straggler: the servers' fleet
    clocks never spread past bound + 1, and every worker finishes (no
    deadlock).

    The straggler is a handshake, not a wall-clock sleep: before each of
    its even steps worker 0 is held until the servers have deferred a peer
    (or both peers are done), so the peers are parked at the gate on every
    hold whatever the machine's load.  The clocks are sampled when a hold
    is released and after every step of every worker."""
    v = van.LoopbackVan()
    servers, workers = _cluster(PORT, v, _table_cfgs(PORT, "ssp", 1), n_workers=3)
    spreads, errs = [], []
    sample_lock = threading.Lock()
    holds = [threading.Event() for _ in range(3)]  # before worker 0's steps 0, 2, 4

    def sample():
        with sample_lock:
            for s in servers:
                snap = s._consist["w"]["clock"].snapshot()
                if len(snap) == 3:
                    spreads.append(max(snap.values()) - min(snap.values()))

    def defers():
        return sum(s.consist_defers for s in servers)

    try:
        for w in workers:
            w.consist_hello(table="w")

        def loop(i, w):
            try:
                for t in range(6):
                    if i == 0 and t % 2 == 0:
                        assert holds[t // 2].wait(30), f"hold {t // 2} never released"
                    _step(w, KEYS + 8 * i, GRADS)
                    sample()
            except Exception as e:  # noqa: BLE001
                errs.append(e)

        threads = [threading.Thread(target=loop, args=(i, w), daemon=True)
                   for i, w in enumerate(workers)]
        for t in threads:
            t.start()
        for hold in holds:
            base = defers()
            parked = _until(lambda: defers() > base or all(
                w.consist_step("w") == 6 for w in workers[1:]), deadline_s=20.0)
            sample()
            hold.set()
            assert parked, "no peer was deferred while worker 0 was held"
        for t in threads:
            t.join(timeout=30)
        assert not errs, errs
        assert spreads and max(spreads) <= 2
        assert [w.consist_step("w") for w in workers] == [6, 6, 6]
        assert sum(s.consist_defers for s in servers) > 0
    finally:
        _close(v, servers)


def test_table_config_consistency_field_matches_jax():
    fields = {f.name: f.default for f in dataclasses.fields(config.TableConfig)}
    ref = {f.name: f.default for f in dataclasses.fields(jax_config.TableConfig)}
    assert fields["consistency"] is ref["consistency"] is None
    with pytest.raises(ValueError):
        config.ConsistencyConfig(gate_retry_s=0)


# ------------------------------------------------- the chaos acceptance case


@pytest.mark.chaos
@pytest.mark.parametrize("seed", [0, 3])
def test_ssp_bound_holds_under_chaos_migration_and_restart(seed):
    """3 workers under SSP(bound=2) over seeded drop / duplicate / delay, a
    live migration and a same-id restart of W2 mid-run: the all-live
    clocks never spread past bound + 1, the restart's stale entry is pruned,
    every worker completes, the final clocks agree, nothing forced or shed.

    Worker 0 is the straggler by handshake: before each of its first
    ``HELD`` steps it waits until the servers have deferred a peer (or W1 is
    done), so the gate is exercised whatever the machine's load."""
    from parameter_server_tpu_torch.core.chaos import ChaosVan
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.core.resender import ReliableVan
    from parameter_server_tpu_torch.kv.migrate import ShardMigrator

    BOUND, STEPS, HELD = 2, 20, 6
    chaos = ChaosVan(van.LoopbackVan(), seed=seed, drop=0.05, duplicate=0.1, delay=0.002)
    v = ReliableVan(chaos, timeout=0.05, backoff=1.0, max_retries=120, seed=seed)
    cfgs = _table_cfgs(PORT, "ssp", BOUND, deadline=0.0)
    servers, workers = _cluster(PORT, v, cfgs, n_workers=3)
    phase, spreads, fails = [0], [], []
    done = [threading.Event() for _ in range(3)]
    stop = threading.Event()

    def sample():
        for s in servers:
            snap = s._consist["w"]["clock"].snapshot()
            if len(snap) >= 2:
                sp = max(snap.values()) - min(snap.values())
                spreads.append((phase[0], sp))  # the phase read after the sample

    def defers():
        return sum(s.consist_defers for s in servers)

    def loop(i, kv):
        rng = np.random.default_rng(1000 * seed + i)
        try:
            for t in range(STEPS):
                if i == 0 and t < HELD:
                    base = defers()
                    assert _until(lambda: defers() > base or done[1].is_set(), 60.0), \
                        f"hold {t}: no peer deferred"
                keys = rng.choice(ROWS, size=8, replace=False).astype(np.int64)
                _step(kv, keys, GRADS, timeout=60.0)
                sample()
        except Exception as e:  # noqa: BLE001 — surfaced below
            fails.append((i, e))
        finally:
            done[i].set()

    def audit():
        while not stop.wait(0.005):
            sample()

    try:
        for w in workers:
            w.consist_hello(table="w")
        auditor = threading.Thread(target=audit, daemon=True)
        auditor.start()
        threads = [threading.Thread(target=loop, args=(i, kv), daemon=True)
                   for i, kv in enumerate(workers[:2])]
        for th in threads:
            th.start()
        w2 = workers[2]
        for _ in range(5):
            _step(w2, KEYS, GRADS, timeout=60.0)
        restored_step = w2.consist_step("w")
        phase[0] = 1
        v.unbind("W2")
        v.restart_node("W2")
        assert any(s.counters().get("consist_pruned", 0) > 0 for s in servers), \
            "incarnation advance did not prune the dead entry"
        w2b = worker.KVWorker(Postoffice("W2", v), cfgs, NUM_SERVERS, device="cpu")
        w2b.consist_hello(table="w", step=restored_step)
        th2 = threading.Thread(target=loop, args=(2, w2b), daemon=True)
        th2.start()
        mig = ShardMigrator(Postoffice("M0", v), chunk_rows=64)
        new_routing = mig.migrate(workers[0].routing, "w", ROWS - ROWS // 4, ROWS, 0)
        # W0's own requests may meet a fence first and adopt the new table
        # from its reply (a race with this thread under load): either way
        # W0 now routes by the migration's table
        workers[0].adopt_routing(new_routing)
        assert workers[0].routing == new_routing
        for th in threads + [th2]:
            th.join(timeout=180)
        stop.set()
        auditor.join(timeout=5)
        assert not fails, f"worker failures: {fails}"
        assert all(not th.is_alive() for th in threads + [th2]), "a worker never finished"
        assert chaos.injected_drops > 0
        strict = [sp for ph, sp in spreads if ph == 0]
        assert strict, "the all-live phase was never sampled"
        assert max(strict) <= BOUND + 1, f"clock spread {max(strict)} > bound {BOUND} + 1"
        for s in servers:
            snap = s._consist["w"]["clock"].snapshot()
            assert len(snap) == 3
            assert max(snap.values()) - min(snap.values()) == 0, snap
        assert sum(w.consist_sheds + w.consist_forced for w in list(workers[:2]) + [w2b]) == 0
    finally:
        stop.set()
        _close(v, servers)


# ------------------------------------------------------------- observability


def _tools(name):
    import pathlib
    import sys

    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parent.parent / "tools"))
    return __import__(name)


def test_consistency_plane_specs_evaluated_by_aggregator():
    """The gate-wait p99 and shed-rate SLOs ride the port's telemetry
    channel as every other plane: worker digests and counters in, windowed
    verdicts out; the server's mode / bound gauges surface on its row."""
    from parameter_server_tpu_torch.core.telemetry import (
        TelemetryAggregator,
        TelemetryPublisher,
    )
    from parameter_server_tpu_torch.utils.slo import SloEngine, consistency_plane_specs

    v = van.LoopbackVan()
    servers, (wa, wb) = _cluster(PORT, v, _table_cfgs(PORT, "ssp", 0, deadline=0.2))
    try:
        wa.consist_hello(table="w")
        wb.consist_hello(table="w")
        engine = SloEngine(consistency_plane_specs(gate_wait_p99_ms=1.0, shed_per_s=1e9),
                           recorder=flightrec.FlightRecorder(capacity=64))
        agg = TelemetryAggregator(slo=engine)
        pub_w = TelemetryPublisher("W0", None, recorder=flightrec.FlightRecorder(capacity=64),
                                   sources=[wa])
        pub_s = TelemetryPublisher("S0", None, recorder=flightrec.FlightRecorder(capacity=64),
                                   sources=[servers[0]])
        _step(wa, KEYS, GRADS)
        _step(wa, KEYS, GRADS)  # parks 0.2 s, then forces: a real gate wait
        assert wa.consist_waits > 0
        agg.ingest("W0", pub_w.frame())
        agg.ingest("S0", pub_s.frame())
        _step(wa, KEYS, GRADS)  # parks again (wb never advances)
        agg.ingest("W0", pub_w.frame())
        agg.ingest("S0", pub_s.frame())
        verdict = engine.evaluate()["W0"]
        assert verdict.observed["gate-wait-p99"] > 1.0
        assert not verdict.healthy and "gate-wait-p99" in verdict.breaches
        row = agg.latest()["S0"]
        assert row["consist_mode"] == 2 and row["consist_bound"] == 0
    finally:
        _close(v, servers)


def test_pstop_renders_mode_bound_and_gate_columns():
    """Rows the port's aggregator derives render in pstop's MODE / BOUND /
    GATEms columns."""
    from parameter_server_tpu_torch.core.telemetry import TelemetryAggregator

    pstop = _tools("pstop")
    agg = TelemetryAggregator()
    agg.ingest("S0", {"seq": 1, "t_mono_s": 1.0,
                      "counters": {"consist_mode": 2, "consist_bound": 4}}, now=1.0)
    agg.ingest("S1", {"seq": 1, "t_mono_s": 1.0,
                      "counters": {"consist_mode": 3, "consist_bound": -1}}, now=1.0)
    h = LatencyHistogram()
    for x in (0.01, 0.02, 0.05, 0.05):
        h.record(x)
    agg.ingest("W0", {"seq": 1, "t_mono_s": 1.0,
                      "digests": {"consist.gate_wait": h.to_dict()}}, now=1.0)
    rows = agg.latest()
    out = "\n".join(pstop.render(rows, now=1.0))
    assert "MODE" in out and "BOUND" in out and "GATEms" in out
    s0 = next(ln for ln in out.splitlines() if ln.startswith("S0"))
    assert " ssp " in s0 and " 4 " in s0
    s1 = next(ln for ln in out.splitlines() if ln.startswith("S1"))
    assert " asp " in s1 and " inf " in s1
    assert pstop._consist_columns(rows["W0"])[2] > 0


def test_postmortem_anchors_on_gate_never_released(tmp_path):
    """A port ``consist.gate`` with no later ``consist.release`` anchors the
    merged postmortem report; a matching release clears it."""
    postmortem = _tools("postmortem")
    flightrec.configure(enabled=True, clear=True)
    try:
        flightrec.record("consist.gate", node="S0", sender="W1", table="w",
                         step=9, fleet_min=2)
        paths = flightrec.dump(str(tmp_path), reason="test")
        merged = postmortem.merge_bundles(paths)
        gates = postmortem.unreleased_gates(merged)
        assert len(gates) == 1 and gates[0]["sender"] == "W1"
        assert "consistency gate never released" in "\n".join(postmortem.report(merged))
        flightrec.record("consist.release", node="S0", sender="W1", table="w")
        paths = flightrec.dump(str(tmp_path / "b"), reason="test")
        assert postmortem.unreleased_gates(postmortem.merge_bundles(paths)) == []
        assert "consist.shed" in postmortem.ANOMALY_KINDS
    finally:
        flightrec.configure(enabled=True, clear=True)


def test_scenario_phase_knob_compiles_and_applies():
    from parameter_server_tpu_torch.scenario import dsl
    from parameter_server_tpu_torch.scenario.runner import ScenarioRunner

    sc = dsl.Scenario(
        name="consist-drill", seed=7, nodes=4,
        phases=(
            dsl.Phase("warm", 10.0),
            dsl.Phase("ssp", 10.0, consistency_mode="ssp", consistency_bound=4),
            dsl.Phase("bsp", 10.0, consistency_mode="bsp"),
        ),
    )
    evs = [e for e in dsl.compile_schedule(sc) if e["event"] == "phase"]
    assert "consistency_mode" not in evs[0]
    assert evs[1]["consistency_mode"] == "ssp" and evs[1]["consistency_bound"] == 4
    assert "consistency_bound" not in evs[2]
    with pytest.raises(ValueError):
        dsl.Phase("bad", 5.0, consistency_mode="tso")
    runner = ScenarioRunner(sc, autoscale=False)
    try:
        seen = []
        runner.on_consistency_mode.append(lambda m, b: seen.append((m, b)))
        for e in evs:
            runner._apply_event(e)
        assert seen == [("ssp", 4), ("bsp", None)]
        assert runner.consistency_mode == "bsp"
    finally:
        runner.close()
