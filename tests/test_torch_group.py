"""The port's worker groups against the JAX package's, on the CPU.

Each case builds the same cluster in both packages from the same seeded
numpy inputs: 2 servers (1 for the staleness case) and size-2 or size-4
groups on ``CoalescingVan(MeteredVan(LoopbackVan()))``, every member
inside ``push_sync`` together.  Compared: final tables, the servers'
``pushes`` / ``group_pushes`` / ``group_members``, the worker counters and
the inbound PUSH requests and bytes ``MeteredVan`` counts at the servers.

The reduction ``path`` the reducers journal is not compared: under the
tests' 8 virtual CPU devices the JAX reducer takes its ``psum`` path, the
port sums on the host in member order (a one-card host has no collective
across members).

Then the wire quantizer under groups: ``ef: "bypass"`` (rotating
election) leaves a group PUSH unquantized, ``ef: "leader"`` (fixed
election) quantizes it under the pinned leader's residual store, with the
JAX codec's frame bytes; the ``GROUP_KEY`` mirror in ``core/filters.py``.

Tolerances: host code (elections, validation, counters, wire counts,
reducer output of the 2-member sum and of the merge) exactly; tables
bitwise within the port and against the JAX package where the gradients are
integers (float addition is then exact); the 4-member case at atol = 1e-6
against the JAX package, whose psum may add in another order.
"""

import threading
import types

import numpy as np
import pytest

from parameter_server_tpu import config as jax_config
from parameter_server_tpu.core import coalesce as jax_coalesce
from parameter_server_tpu.core import flightrec as jax_flightrec
from parameter_server_tpu.core import netmon as jax_netmon
from parameter_server_tpu.core import postoffice as jax_postoffice
from parameter_server_tpu.core import van as jax_van
from parameter_server_tpu.kv import routing as jax_routing
from parameter_server_tpu.kv import server as jax_server
from parameter_server_tpu.kv import worker as jax_worker
from parameter_server_tpu.utils.trace import LatencyHistogram as JaxLatencyHistogram
from parameter_server_tpu_torch import config
from parameter_server_tpu_torch.core import coalesce, flightrec, netmon, postoffice, van
from parameter_server_tpu_torch.kv import routing, server, worker
from parameter_server_tpu_torch.utils.trace import LatencyHistogram

ROWS = 1 << 12

JAX = types.SimpleNamespace(
    cfg=jax_config, coalesce=jax_coalesce, netmon=jax_netmon, post=jax_postoffice,
    van=jax_van, routing=jax_routing, server=jax_server, worker=jax_worker,
    flightrec=jax_flightrec, hist=JaxLatencyHistogram, kw={},
)
PORT = types.SimpleNamespace(
    cfg=config, coalesce=coalesce, netmon=netmon, post=postoffice, van=van,
    routing=routing, server=server, worker=worker, flightrec=flightrec,
    hist=LatencyHistogram, kw={"device": "cpu"},
)
PKGS = {"jax": JAX, "port": PORT}


def _cfgs(pkg, lr=1.0, dim=2):
    return {"w": pkg.cfg.TableConfig(
        name="w", rows=ROWS, dim=dim,
        optimizer=pkg.cfg.OptimizerConfig(kind="sgd", learning_rate=lr),
    )}


def _cluster(pkg, worker_names, *, num_servers=2, group=None, group_cfg=None, loop=None):
    loop = loop or pkg.van.LoopbackVan()
    metered = pkg.netmon.MeteredVan(loop)
    v = pkg.coalesce.CoalescingVan(metered)
    cfgs = _cfgs(pkg)
    servers = [pkg.server.KVServer(pkg.post.Postoffice(f"S{s}", v), cfgs, s, num_servers,
                                   **pkg.kw)
               for s in range(num_servers)]
    workers = [pkg.worker.KVWorker(pkg.post.Postoffice(n, v), cfgs, num_servers,
                                   group=group, group_cfg=group_cfg, **pkg.kw)
               for n in worker_names]
    return v, metered, servers, workers


def _close(v, servers):
    v.close()
    for s in servers:
        if s.ledger is not None:
            s.ledger.close()


def _group(pkg, names, size, timeout=10.0, election="rotate"):
    return (pkg.routing.WorkerGroup(members=tuple(names), election=election),
            pkg.cfg.GroupConfig(size=size, election=election, fallback_timeout=timeout))


def _concurrent_push(workers, keys, grads, timeout=30):
    """Every group member inside push_sync together (the rendezvous
    contract): one thread per member."""
    errs = []

    def go(w, g):
        try:
            w.push_sync("w", keys, g, timeout=timeout)
        except Exception as e:  # noqa: BLE001 — surfaced to the test
            errs.append(e)

    threads = [threading.Thread(target=go, args=(w, g), daemon=True)
               for w, g in zip(workers, grads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errs, errs


def _inbound_push(metered):
    tot = {"msgs": 0, "bytes": 0}
    for link, d in metered.links().items():
        if link.partition("->")[2].startswith("S"):
            vb = (d.get("verbs") or {}).get("PUSH")
            if vb:
                tot["msgs"] += vb["msgs"]
                tot["bytes"] += vb["bytes"]
    return tot


# ------------------------------------------------------------- config plane


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_group_config_validation(pkg):
    cfg = PKGS[pkg].cfg
    assert cfg.GroupConfig(size=4, election="rotate", fallback="direct").fallback_timeout > 0
    for kw, match in [({"election": "raft"}, "election"), ({"fallback": "retry"}, "fallback"),
                      ({"reduce": "allgather"}, "reduce"), ({"fallback_timeout": 0}, None)]:
        with pytest.raises(ValueError, match=match):
            cfg.GroupConfig(size=2, **kw)
    with pytest.raises(ValueError):
        cfg.GroupConfig(size=0)


def test_group_config_fields_match_jax():
    import dataclasses

    def fields(cls):
        return [(f.name, f.default) for f in dataclasses.fields(cls)]

    assert fields(config.GroupConfig) == fields(jax_config.GroupConfig)
    assert fields(config.ConsistencyConfig) == fields(jax_config.ConsistencyConfig)


@pytest.mark.parametrize("pkg", ["jax", "port"])
def test_worker_group_validation_and_props(pkg):
    wg = PKGS[pkg].routing.WorkerGroup
    g = wg(members=("W0", "W1", "W2"))
    assert (g.size, g.gid) == (3, "W0+W1+W2")
    for members, election in [((), "rotate"), (("W0", "W0"), "rotate"), (("W0", "W1"), "paxos")]:
        with pytest.raises(ValueError):
            wg(members=members, election=election)


@pytest.mark.parametrize("election", ["rotate", "fixed"])
@pytest.mark.parametrize("size", [2, 3, 4])
def test_leader_election_matches_jax(election, size):
    names = tuple(f"W{i}" for i in range(size))
    port = routing.WorkerGroup(members=names, election=election)
    ref = jax_routing.WorkerGroup(members=names, election=election)
    for table in ("w", "v", "emb_0"):
        got = [port.leader(table, s, salt) for s in range(9) for salt in range(3)]
        assert got == [ref.leader(table, s, salt) for s in range(9) for salt in range(3)]
    if election == "rotate":  # every member leads once per size steps
        assert sorted(port.leader("w", s) for s in range(size)) == sorted(names)
        assert port.leader("w", 3, salt=1) == port.leader("w", 4)
    else:
        assert {port.leader("w", s) for s in range(5)} == {"W0"}


def test_wire_keys_match_jax():
    for key in ("GROUP_KEY", "CONSIST_STEP_KEY", "WAIT_KEY", "FENCED_KEY", "ROUTING_KEY"):
        assert getattr(routing, key) == getattr(jax_routing, key)
    assert netmon.STAMP_KEY == jax_netmon.STAMP_KEY


# ------------------------------------------------------------ GroupReducer


def _reduce_both(expected, mode, deposits):
    """Run one deposit script through both reducers; returns every deposit's
    result per package."""
    out = {}
    for name, mod in (("jax", jax_coalesce), ("port", coalesce)):
        red = mod.GroupReducer(expected, node="T", mode=mode)
        out[name] = [red.deposit(*d) for d in deposits]
        assert not red.pending()
    return out["port"], out["jax"]


def _assert_same_result(a, b):
    assert (a is None) == (b is None)
    if a is not None:
        assert a[2] == b[2]
        np.testing.assert_array_equal(a[0], b[0])
        assert a[1].dtype == b[1].dtype
        np.testing.assert_array_equal(a[1], b[1])


@pytest.mark.parametrize("seed", [0, 1])
def test_reducer_same_keys_sum_is_bitwise_jax(seed):
    rng = np.random.default_rng(seed)
    keys = np.sort(rng.choice(1000, 64, replace=False)).astype(np.int64)
    a, b = (rng.normal(size=(64, 3)).astype(np.float32) for _ in range(2))
    port, ref = _reduce_both(2, "auto", [("w", 0, "W1", keys, b), ("w", 0, "W0", keys, a)])
    for p, r in zip(port, ref):
        _assert_same_result(p, r)
    np.testing.assert_array_equal(port[1][1], a + b)  # member order: W0 then W1
    assert port[1][2] == 2


def test_reducer_union_merge_disjoint_keys_is_bitwise_jax():
    rng = np.random.default_rng(3)
    k0 = np.sort(rng.choice(50, 20, replace=False)).astype(np.int64)
    k1 = np.sort(rng.choice(50, 25, replace=False)).astype(np.int64)
    v0 = rng.normal(size=(20, 1)).astype(np.float32)
    v1 = rng.normal(size=(25, 1)).astype(np.float32)
    port, ref = _reduce_both(2, "merge", [("w", 0, "W0", k0, v0), ("w", 0, "W1", k1, v1)])
    _assert_same_result(port[1], ref[1])
    np.testing.assert_array_equal(port[1][0], np.union1d(k0, k1))
    # the documented small case
    port, ref = _reduce_both(2, "merge", [
        ("w", 0, "W0", np.array([1, 3]), np.array([[1.0], [5.0]], np.float32)),
        ("w", 0, "W1", np.array([1, 2]), np.array([[1.0], [7.0]], np.float32)),
    ])
    _assert_same_result(port[1], ref[1])
    np.testing.assert_array_equal(port[1][1], [[2.0], [7.0], [5.0]])


def test_reducer_duplicate_member_deposit_ignored_as_jax():
    keys = np.array([1], dtype=np.int64)
    v = np.ones((1, 1), np.float32)
    port, ref = _reduce_both(2, "auto", [("w", 0, "W0", keys, v), ("w", 0, "W0", keys, 5 * v),
                                         ("w", 0, "W1", keys, v)])
    assert port[:2] == [None, None] and ref[:2] == [None, None]
    _assert_same_result(port[2], ref[2])
    np.testing.assert_array_equal(port[2][1], 2 * v)


def test_reducer_take_partial_and_stale_flush_as_jax():
    keys = np.array([2, 4], dtype=np.int64)
    v = np.ones((2, 1), np.float32)
    got = {}
    for name, mod in (("jax", jax_coalesce), ("port", coalesce)):
        red = mod.GroupReducer(3, node="T")
        assert red.deposit("w", 5, "W0", keys, v) is None
        part = red.take("w", 5)
        assert red.take("w", 5) is None  # consumed
        assert red.deposit("w", 6, "W0", keys, v) is None
        stale = red.take_stale(0.0)
        assert not red.pending()
        got[name] = (part, [(t, s) for t, s, _ in stale], stale[0][2],
                     red.reduced_sets, red.partial_sets)
    _assert_same_result(got["port"][0], got["jax"][0])
    assert got["port"][1] == got["jax"][1] == [("w", 6)]
    _assert_same_result(got["port"][2], got["jax"][2])
    assert got["port"][3:] == got["jax"][3:] == (0, 2)


# ------------------------------------------------- cluster: parity + wire


def _sum_once_run(pkg, grouped, keys, grads):
    names = ("W0", "W1")
    group, gcfg = _group(pkg, names, 2) if grouped else (None, None)
    v, metered, servers, workers = _cluster(pkg, names, group=group, group_cfg=gcfg)
    try:
        before = workers[0].pull_sync("w", keys, timeout=30).copy()
        _concurrent_push(workers, keys, grads)
        after = workers[0].pull_sync("w", keys, timeout=30)
        return {
            "delta": after - before,
            "push": _inbound_push(metered),
            "group_pushes": sum(s.group_pushes for s in servers),
            "group_members": sum(s.group_members for s in servers),
            "pushes": sum(s.pushes for s in servers),
            "server_counters": [{k: c[k] for k in ("group_pushes", "group_members",
                                                   "fenced_rejects")}
                                for c in (s.counters() for s in servers)],
            "worker_counters": [w.counters() for w in workers],
        }
    finally:
        _close(v, servers)


def test_group_push_applies_sum_once_with_fewer_requests():
    keys = np.array([1, 5, 9, ROWS + 7], dtype=np.int64)
    # integer-valued grads: float addition is exact, so every arm of both
    # packages applies the same table bit for bit
    grads = [np.full((keys.size, 2), 1.0, np.float32), np.full((keys.size, 2), 2.0, np.float32)]
    res = {(p, g): _sum_once_run(PKGS[p], g, keys, grads)
           for p in ("jax", "port") for g in (False, True)}
    direct, grouped = res[("port", False)], res[("port", True)]
    np.testing.assert_array_equal(direct["delta"], grouped["delta"])
    np.testing.assert_array_equal(grouped["delta"], -3.0 * np.ones((4, 2)))
    # one logical apply for the whole group, booked with its fan-in
    assert grouped["pushes"] == grouped["group_pushes"]
    assert grouped["group_members"] == 2 * grouped["group_pushes"]
    assert direct["group_pushes"] == 0
    # the wire saw HALF the PUSH requests (and bytes, same keys)
    assert grouped["push"]["msgs"] * 2 == direct["push"]["msgs"]
    assert grouped["push"]["bytes"] * 2 == direct["push"]["bytes"]
    assert all(c.get("group_fallbacks", 0) == 0 for c in grouped["worker_counters"])
    for g in (False, True):  # every count and table equals the JAX package's
        p, j = res[("port", g)], res[("jax", g)]
        np.testing.assert_array_equal(p["delta"], j["delta"])
        for k in ("push", "group_pushes", "group_members", "pushes", "server_counters"):
            assert p[k] == j[k], k
        keys_ = ("group_pushes", "group_reduced_fanin", "group_contribs", "group_fallbacks",
                 "group_done_recv", "group_handoffs", "push_retries", "refresh_retries")
        assert sorted(p["worker_counters"][0]) == sorted(
            k for k in j["worker_counters"][0] if not k.startswith("trace_"))
        assert [{k: c.get(k) for k in keys_} for c in p["worker_counters"]] == \
            [{k: c.get(k) for k in keys_} for c in j["worker_counters"]]


def _staleness_run(pkg, size, grouped, keys, grad, steps=4):
    names = tuple(f"W{i}" for i in range(size))
    group, gcfg = _group(pkg, names, size) if grouped else (None, None)
    # ONE server so version arithmetic is single-stream
    v, _m, servers, workers = _cluster(pkg, names, num_servers=1, group=group, group_cfg=gcfg)
    barrier = threading.Barrier(size)
    errs = []

    def drive(w):
        try:
            for _ in range(steps):
                barrier.wait()
                w.push_sync("w", keys, grad, timeout=30)
                barrier.wait()  # every apply lands before any pull
                w.pull_sync("w", keys, timeout=30)
        except Exception as e:  # noqa: BLE001
            errs.append(e)

    try:
        threads = [threading.Thread(target=drive, args=(w,), daemon=True) for w in workers]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        assert not errs, errs
        p99s, counts = [], []
        for w in workers:
            d = w.staleness_digests().get("staleness.w")
            assert d is not None and d["count"] >= steps
            p99s.append(pkg.hist.from_dict(d).percentile(0.99))
            counts.append(d["count"])
        table = servers[0].export_shard()["w"]
        return {"p99": max(p99s), "counts": counts, "pushes": servers[0].pushes,
                "table": np.asarray(table["value"])}
    finally:
        _close(v, servers)


@pytest.mark.parametrize("size", [2, 4])
def test_staleness_p99_no_regression_vs_direct(size):
    """Barrier-disciplined training at group sizes 2 and 4: the grouped
    arm's ``staleness.w`` p99 must not exceed the direct arm's (the done
    notify credits the one group apply to every member).  Each arm's sample
    multiset is fixed by the barriers, so p99s, sample counts and push
    counts must also equal the JAX package's."""
    rng = np.random.default_rng(7)
    keys = np.sort(rng.choice(ROWS, 32, replace=False)).astype(np.int64)
    grad = np.ones((keys.size, 2), np.float32)
    res = {(p, g): _staleness_run(PKGS[p], size, g, keys, grad)
           for p in ("jax", "port") for g in (False, True)}
    direct, grouped = res[("port", False)], res[("port", True)]
    assert grouped["p99"] <= direct["p99"] and direct["p99"] >= 1.0
    assert (direct["pushes"], grouped["pushes"]) == (4 * size, 4)
    for g in (False, True):
        p, j = res[("port", g)], res[("jax", g)]
        assert (p["p99"], p["counts"], p["pushes"]) == (j["p99"], j["counts"], j["pushes"])
        # integer grads: exact at size 2; the 4-member psum may add in
        # another order in the JAX package, hence 1e-6 there
        np.testing.assert_allclose(p["table"], j["table"], rtol=0, atol=1e-6)
    np.testing.assert_array_equal(direct["table"], grouped["table"])


# ------------------------------------------------------------------ chaos


def _leader_death_run(pkg, kill, keys, grads, steps=6, kill_at=3):
    names = ("W0", "W1")
    loop = pkg.van.LoopbackVan()
    pkg.flightrec.configure(enabled=True, clear=True)
    group, gcfg = _group(pkg, names, 2, timeout=0.3)
    v, _m, servers, workers = _cluster(pkg, names, group=group, group_cfg=gcfg, loop=loop)
    try:
        # clean reference arm: an ungrouped worker pushes the survivor's
        # post-death gradients directly
        direct = pkg.worker.KVWorker(pkg.post.Postoffice("W9", v), _cfgs(pkg), 2, **pkg.kw)
        for s in range(kill_at):
            _concurrent_push(workers, keys, grads[s])
        if kill:
            loop.disconnect("W1")
            for s in range(kill_at, steps):
                workers[0].push_sync("w", keys, grads[s][0], timeout=30)
        else:
            for s in range(kill_at, steps):
                direct.push_sync("w", keys, grads[s][0], timeout=30)
        final = (workers[0] if kill else direct).pull_sync("w", keys, timeout=30)
        fallbacks = sum(w.counters().get("group_fallbacks", 0) for w in workers)
        reasons = {e.get("reason") for e in pkg.flightrec.get().events()
                   if e["kind"] == "group.fallback" and e.get("node") in names}
        return np.asarray(final), fallbacks, reasons
    finally:
        _close(v, servers)
        pkg.flightrec.configure(enabled=True, clear=True)


@pytest.mark.chaos
def test_leader_death_falls_back_bitwise_equal_to_clean_path():
    """Kill the peer member mid-run: the survivor's remaining steps degrade
    to direct per-worker push with NO loss, and the final table is BITWISE
    equal to a clean run that pushes the same gradients directly, in the
    port and against the JAX package (integer gradients)."""
    keys = np.array([3, 11, 42, 1000], dtype=np.int64)
    steps, kill_at = 6, 3
    grads = [[np.full((keys.size, 2), float(1 + s), np.float32),
              np.full((keys.size, 2), float(10 + s), np.float32)] for s in range(steps)]
    clean, clean_fallbacks, _ = _leader_death_run(PORT, False, keys, grads)
    chaos, chaos_fallbacks, reasons = _leader_death_run(PORT, True, keys, grads)
    np.testing.assert_array_equal(chaos, clean)
    assert clean_fallbacks == 0
    assert chaos_fallbacks == steps - kill_at
    assert reasons and reasons <= {"member_timeout", "dead_leader", "stale_set"}
    ref, ref_fallbacks, ref_reasons = _leader_death_run(JAX, True, keys, grads)
    np.testing.assert_array_equal(chaos, ref)
    assert (chaos_fallbacks, reasons) == (ref_fallbacks, ref_reasons)


def test_fixed_election_only_the_leader_pushes_as_jax():
    names = ("W0", "W1")
    keys = np.array([4, 8], dtype=np.int64)
    grads = [np.ones((2, 2), np.float32)] * 2
    senders = {}
    for name, pkg in PKGS.items():
        group, gcfg = _group(pkg, names, 2, election="fixed")
        v, metered, servers, workers = _cluster(pkg, names, group=group, group_cfg=gcfg)
        try:
            assert [w._group_ef for w in workers] == ["leader", "leader"]
            _concurrent_push(workers, keys, grads)
            senders[name] = {link.partition("->")[0] for link, d in metered.links().items()
                             if link.partition("->")[2].startswith("S")
                             and (d.get("verbs") or {}).get("PUSH")}
        finally:
            _close(v, servers)
    assert senders["port"] == senders["jax"] == {"W0"}


def test_metered_van_counts_like_jax():
    """The same direct push/pull traffic metered by both packages: equal
    messages and payload bytes per link and per verb."""
    keys = np.array([2, 9, 700, 3000], dtype=np.int64)
    grads = np.full((keys.size, 2), 0.5, np.float32)
    links = {}
    for name, pkg in PKGS.items():
        v, metered, servers, (w,) = _cluster(pkg, ("W0",))
        try:
            w.pull_sync("w", keys, timeout=30)
            w.push_sync("w", keys, grads, timeout=30)
            w.pull_sync("w", keys, timeout=30)
            links[name] = {k: (d["msgs"], d["bytes"], d["verbs"])
                           for k, d in metered.links().items()}
            assert metered.counters()["wire_msgs"] == sum(d[0] for d in links[name].values())
            assert netmon.find_metered(v) is not None if name == "port" else True
        finally:
            _close(v, servers)
    assert links["port"] == links["jax"]


# ------------------------------------------------- error feedback under groups


def test_group_key_mirrors_filters_module():
    """kv/routing.py owns the wire constant; core/filters.py mirrors it to
    avoid a core -> kv import cycle, in both packages."""
    from parameter_server_tpu.core import filters as jax_filters
    from parameter_server_tpu_torch.core import filters

    assert routing.GROUP_KEY == filters._GROUP_KEY == jax_filters._GROUP_KEY


def _group_push_msg(pkg, ef):
    from parameter_server_tpu.core import messages as jax_messages
    from parameter_server_tpu_torch.core import messages

    msgs = messages if pkg is PORT else jax_messages
    return msgs.Message(
        task=msgs.Task(msgs.TaskKind.PUSH, "kv", payload={
            "table": "w", pkg.routing.GROUP_KEY: {"id": "W0+W1", "n": 2, "step": 0, "ef": ef}}),
        sender="W0", recver="S0", keys=np.array([1, 2], dtype=np.int32),
        values=[np.array([[1.5], [2.5]], np.float32)],
    )


def _quantizer(pkg):
    from parameter_server_tpu.core import filters as jax_filters
    from parameter_server_tpu_torch.core import filters

    mod = filters if pkg is PORT else jax_filters
    return mod.QuantizingFilter(default=pkg.cfg.WireCompressionConfig(
        codec="int8", error_feedback=True))


def test_ef_bypass_skips_codec_for_rotating_groups():
    for pkg in (PORT, JAX):
        codec = _quantizer(pkg)
        msg = _group_push_msg(pkg, "bypass")
        out = codec.encode(msg)
        # the frame untouched: float32 planes, no residual store created
        assert out is msg and out.values[0].dtype == np.float32
        assert codec.counters().get("compress_wire_bytes", 0) == 0
        assert not codec._residuals


def test_ef_leader_mode_quantizes_under_pinned_residual_as_jax():
    from parameter_server_tpu.core import frame as jax_frame
    from parameter_server_tpu_torch.core import frame

    out = {}
    for name, pkg in PKGS.items():
        codec = _quantizer(pkg)
        enc = codec.encode(_group_push_msg(pkg, "leader"))
        assert enc.values[0].dtype == np.int8  # quantized
        # the PINNED leader's (sender, table) store owns the group's residual
        assert set(codec._residuals) == {("W0", "w")}
        out[name] = bytes((frame if pkg is PORT else jax_frame).encode(enc))
    assert out["port"] == out["jax"]


def test_rotate_election_worker_stamps_bypass_ef():
    names = ("W0", "W1")
    for pkg in (PORT, JAX):
        group, gcfg = _group(pkg, names, 2)
        v, _m, servers, workers = _cluster(pkg, names, group=group, group_cfg=gcfg)
        try:
            assert [w._group_ef for w in workers] == ["bypass", "bypass"]
        finally:
            _close(v, servers)
