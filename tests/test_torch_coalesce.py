"""The port's wire coalescing against the JAX package's, on the CPU.

``parameter_server_tpu_torch/core/coalesce.py`` is a copy of the JAX
module's bundle format and ``CoalescingVan``.  These tests hold ``_pack`` /
``_unpack`` to the JAX ones byte for byte (and across packages), replay the
JAX package's flush-trigger and KV-plane cases on the port, and run a
2 workers x 2 servers two-table loop through ``push_many`` on both
packages' coalescing stacks.

Tolerances: host code (bundle index, key bytes, counters) exactly; tables
bitwise within the port (bundled against unbundled), within rtol = atol =
1e-5 against the JAX package.
"""

import time

import numpy as np
import pytest
import torch

from parameter_server_tpu.config import OptimizerConfig as JaxOptimizerConfig
from parameter_server_tpu.config import TableConfig as JaxTableConfig
from parameter_server_tpu.core import coalesce as jax_coalesce
from parameter_server_tpu.core import messages as jax_messages
from parameter_server_tpu.core.postoffice import Postoffice as JaxPostoffice
from parameter_server_tpu.core.van import LoopbackVan as JaxLoopbackVan
from parameter_server_tpu.kv.server import KVServer as JaxKVServer
from parameter_server_tpu.kv.worker import KVWorker as JaxKVWorker
from parameter_server_tpu_torch.config import ApplyEngineConfig, OptimizerConfig, TableConfig
from parameter_server_tpu_torch.core import coalesce
from parameter_server_tpu_torch.core import messages as port_messages
from parameter_server_tpu_torch.core.coalesce import (
    BUNDLE_CUSTOMER,
    CoalescingVan,
    _pack,
    _unpack,
)
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker

ROWS = 1 << 10
NUM_SERVERS = 2
TOL = dict(rtol=1e-5, atol=1e-5)


def _settle(predicate, deadline_s=5.0):
    deadline = time.monotonic() + deadline_s
    while time.monotonic() < deadline:
        if predicate():
            return True
        time.sleep(0.005)
    return predicate()


def _msg(i, *, customer="t", sender="A", recver="B", keys=None, values=()):
    return Message(
        task=Task(TaskKind.PUSH, customer, time=i),
        sender=sender,
        recver=recver,
        keys=keys,
        values=list(values),
    )


# ------------------------------------------------------------- wire format


def _seeded_subs(msgs, seed):
    """Mixed dtypes/shapes/payloads, keys=None, several value arrays and a
    reply, from one seed — built with either package's message classes."""
    rng = np.random.default_rng(seed)
    return [
        msgs.Message(
            task=msgs.Task(msgs.TaskKind.PUSH, "w", time=3, payload={"table": "w"}),
            sender="W0", recver="S0",
            keys=rng.integers(0, 1 << 20, size=12).astype(np.uint32).reshape(3, 4),
            values=[rng.normal(size=12).astype(np.float32)],
        ),
        msgs.Message(
            task=msgs.Task(msgs.TaskKind.PULL, "u", time=4),
            sender="W0", recver="S0",
            values=[np.ones(3, np.float32), rng.integers(0, 9, size=2).astype(np.int32)],
        ),
        msgs.Message(
            task=msgs.Task(msgs.TaskKind.PUSH, "w", time=5, wait_time=4),
            sender="W0", recver="S0",
            keys=rng.integers(0, 1 << 40, size=3).astype(np.uint64),
            is_request=False,
        ),
        msgs.Message(
            task=msgs.Task(msgs.TaskKind.PUSH, "w", time=6, payload={"table": "w"}),
            sender="W0", recver="S0",
            keys=np.sort(rng.choice(64, size=7, replace=False)).astype(np.int32),
            values=[rng.normal(size=(7, 2)).astype(np.float32)],
        ),
    ]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_pack_matches_jax_byte_for_byte(seed):
    port = _pack(_seeded_subs(port_messages, seed))
    ref = jax_coalesce._pack(_seeded_subs(jax_messages, seed))
    assert port.task.customer == ref.task.customer == BUNDLE_CUSTOMER
    assert port.task.kind.value == ref.task.kind.value == "control"
    assert coalesce.BUNDLE_KEY == jax_coalesce.BUNDLE_KEY
    assert port.task.payload[coalesce.BUNDLE_KEY] == ref.task.payload[jax_coalesce.BUNDLE_KEY]
    assert port.keys.dtype == ref.keys.dtype == np.uint8
    assert port.keys.tobytes() == ref.keys.tobytes()
    assert len(port.values) == len(ref.values)
    for a, b in zip(port.values, ref.values):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()
    assert (port.sender, port.recver, port.is_request) == (ref.sender, ref.recver, ref.is_request)


@pytest.mark.parametrize("direction", ["jax_to_port", "port_to_jax"])
def test_each_package_unpacks_the_others_bundle(direction):
    if direction == "jax_to_port":
        subs = _seeded_subs(jax_messages, 3)
        out = _unpack(jax_coalesce._pack(subs))
    else:
        subs = _seeded_subs(port_messages, 3)
        out = jax_coalesce._unpack(_pack(subs))
    assert len(out) == len(subs)
    for got, want in zip(out, subs):
        assert got.task.kind.value == want.task.kind.value
        assert (got.task.customer, got.task.time, got.task.wait_time) == (
            want.task.customer, want.task.time, want.task.wait_time)
        assert got.task.payload == want.task.payload
        assert got.is_request == want.is_request
        if want.keys is None:
            assert got.keys is None
        else:
            assert got.keys.dtype == want.keys.dtype and got.keys.shape == want.keys.shape
            np.testing.assert_array_equal(got.keys, want.keys)
            assert got.keys.flags.writeable  # the server writes key arrays
        assert len(got.values) == len(want.values)
        for gv, wv in zip(got.values, want.values):
            np.testing.assert_array_equal(gv, wv)


def test_pack_unpack_roundtrip_bitwise():
    subs = _seeded_subs(port_messages, 4)
    out = _unpack(_pack(subs))
    for got, want in zip(out, subs):
        assert got.task.kind is want.task.kind
        if want.keys is not None:
            assert got.keys.tobytes() == want.keys.tobytes()
            assert got.keys is not want.keys  # an owned copy
        for gv, wv in zip(got.values, want.values):
            assert gv.tobytes() == wv.tobytes()


def test_tensor_values_pass_through_a_bundle_untouched():
    """Device-resident planes (``push_device``) ride the bundle as the same
    tensor objects: ``_pack`` never converts or copies them."""
    planes = [torch.arange(6, dtype=torch.float32).reshape(3, 2), torch.ones(4, 2)]
    subs = [_msg(i, keys=np.arange(3 + i, dtype=np.int32)[:3], values=[p])
            for i, p in enumerate(planes)]
    frame = _pack(subs)
    assert all(a is b for a, b in zip(frame.values, planes))
    out = _unpack(frame)
    assert all(m.values[0] is p for m, p in zip(out, planes))


# ---------------------------------------------------------- flush triggers


def test_window_bundles_burst_into_one_frame():
    base = LoopbackVan()
    van = CoalescingVan(base)
    try:
        got = []
        van.bind("B", got.append)
        with van.window():
            for i in range(3):
                assert van.send(_msg(i))
        assert _settle(lambda: len(got) == 3)
        assert [m.task.time for m in got] == [0, 1, 2]  # in-order unpack
        assert base.sent_messages == 1  # one wire frame for the burst
        c = van.counters()
        assert c["coalesce_frames"] == 1 and c["coalesce_msgs"] == 3
    finally:
        van.close()


def test_single_message_flush_sends_raw_frame():
    """A 1-message buffer skips the bundle envelope (no pointless pack)."""
    base = LoopbackVan()
    van = CoalescingVan(base)
    try:
        got = []
        van.bind("B", got.append)
        with van.window():
            van.send(_msg(0, customer="solo"))
        assert _settle(lambda: len(got) == 1)
        assert got[0].task.customer == "solo"
        assert base.sent_messages == 1
        c = van.counters()
        assert c["coalesce_frames"] == 1 and c["coalesce_msgs"] == 1
    finally:
        van.close()


def test_timer_flush_without_window():
    van = CoalescingVan(LoopbackVan(), max_delay=0.01)
    try:
        got = []
        van.bind("B", got.append)
        van.send(_msg(0))  # no window: only the flusher thread can emit it
        assert _settle(lambda: len(got) == 1)
        assert van.counters()["coalesce_flush_timer"] >= 1
    finally:
        van.close()


def test_count_overflow_flushes_inside_window():
    base = LoopbackVan()
    van = CoalescingVan(base, max_msgs=4)
    try:
        got = []
        van.bind("B", got.append)
        with van.window():
            for i in range(10):
                van.send(_msg(i))
        assert _settle(lambda: len(got) == 10)
        assert [m.task.time for m in got] == list(range(10))  # FIFO held
        # 4 + 4 on overflow, final 2 at window exit
        assert base.sent_messages == 3
        c = van.counters()
        assert c["coalesce_flush_full"] == 2 and c["coalesce_msgs"] == 10
    finally:
        van.close()


def test_control_passthrough_flushes_buffer_first():
    """A CONTROL frame bypasses bundling but must not overtake buffered data
    traffic on its link."""
    base = LoopbackVan()
    van = CoalescingVan(base)
    try:
        got = []
        van.bind("B", got.append)
        with van.window():
            van.send(_msg(0))
            van.send(_msg(1))
            van.send(Message(task=Task(TaskKind.CONTROL, "ctl", time=2),
                             sender="A", recver="B"))
        assert _settle(lambda: len(got) == 3)
        assert [m.task.time for m in got] == [0, 1, 2]
        assert base.sent_messages == 2  # bundle(0,1) then raw control
        assert van.counters()["coalesce_passthrough"] == 1
    finally:
        van.close()


def test_undeliverable_bundle_synthesizes_error_replies():
    """Buffered sends return True optimistically; when the flush finds the
    link dead, locally bound request senders get the ``__error__`` reply the
    Postoffice would have produced — waiters fail fast, never hang."""
    van = CoalescingVan(LoopbackVan())
    try:
        got = []
        van.bind("A", got.append)  # sender's inbox; "B" never bound
        with van.window():
            assert van.send(_msg(7, customer="w"))  # optimistic True
        assert _settle(lambda: len(got) == 1)
        err = got[0]
        assert err.sender == "B" and err.recver == "A"
        assert not err.is_request
        assert err.task.customer == "w" and err.task.time == 7
        assert "undeliverable" in err.task.payload["__error__"]
        assert van.counters()["coalesce_undeliverable"] == 1
    finally:
        van.close()


def test_flush_reaches_the_inner_van_and_counters_match_jax_names():
    port, ref = CoalescingVan(LoopbackVan()), jax_coalesce.CoalescingVan(JaxLoopbackVan())
    try:
        assert port.flush(1.0) and ref.flush(1.0)
        assert set(port.counters()) == set(ref.counters())
    finally:
        port.close()
        ref.close()


# --------------------------------------------------------------- KV plane


def _table_cfgs():
    opt = OptimizerConfig(kind="adagrad", learning_rate=0.1)
    return {
        "w": TableConfig(name="w", rows=ROWS, dim=1, optimizer=opt),
        "u": TableConfig(name="u", rows=ROWS, dim=1, optimizer=opt),
    }


def _keys_grads(seed):
    rng = np.random.default_rng(seed)
    keys = rng.integers(0, 1 << 20, size=128, dtype=np.uint32)
    grads = rng.normal(size=128).astype(np.float32)
    return keys, grads


def _make_worker(van, servers=None):
    cfgs = _table_cfgs()
    made = [KVServer(Postoffice(f"S{s}", van), cfgs, s, NUM_SERVERS, device="cpu")
            for s in range(NUM_SERVERS)]
    if servers is not None:
        servers.extend(made)
    return KVWorker(Postoffice("W0", van), cfgs, NUM_SERVERS, device="cpu")


def _push_two_tables(worker):
    """One 2-table push window, settled (every server ack received)."""
    kw, gw = _keys_grads(1)
    ku, gu = _keys_grads(2)
    ts_by_table = worker.push_many({"w": (kw, gw), "u": (ku, gu)})
    assert set(ts_by_table) == {"w", "u"}
    for ts in ts_by_table.values():
        assert worker.wait(ts, timeout=30)
    return kw, ku


def test_coalesce_window_is_a_null_context_on_a_plain_stack():
    van = LoopbackVan()
    try:
        worker = _make_worker(van)
        with worker.coalesce_window() as win:
            assert win is None
    finally:
        van.close()


def test_two_table_push_uses_half_the_wire_frames():
    """A 2-table push window over CoalescingVan emits at most HALF the wire
    messages of the identical uncoalesced push."""
    base_unc = LoopbackVan()
    try:
        _push_two_tables(_make_worker(base_unc))
        unc_sent = base_unc.sent_messages
    finally:
        base_unc.close()

    base = LoopbackVan()
    van = CoalescingVan(base)
    try:
        _push_two_tables(_make_worker(van))
        assert van.flush(10)
        coal_sent = base.sent_messages
        assert van.counters()["coalesce_frames"] == coal_sent
    finally:
        van.close()

    # 2 tables x 2 servers x (request + ack) = 8 uncoalesced; bundling
    # folds them onto the 4 links (W0<->S0, W0<->S1, each direction once)
    assert unc_sent == 2 * NUM_SERVERS * 2
    assert 2 * coal_sent <= unc_sent


def test_bundled_traffic_is_bitwise_identical_to_unbundled():
    def run(van):
        worker = _make_worker(van)
        kw, ku = _push_two_tables(worker)
        return worker.pull_sync("w", kw, timeout=30), worker.pull_sync("u", ku, timeout=30)

    base_unc = LoopbackVan()
    try:
        w_ref, u_ref = run(base_unc)
    finally:
        base_unc.close()

    van = CoalescingVan(LoopbackVan())
    try:
        w_got, u_got = run(van)
    finally:
        van.close()

    np.testing.assert_array_equal(w_got, w_ref)  # bitwise, not allclose
    np.testing.assert_array_equal(u_got, u_ref)


@pytest.mark.parametrize("dup_policy", ["rounds", "combine"])
def test_a_window_of_pushes_reaches_the_apply_engine_as_one_batch(dup_policy):
    """16 same-table pushes inside one ``coalesce_window`` arrive as ONE
    bundle, ONE ``handle_request_batch`` call and ONE ledger entry.
    ``"rounds"`` gives the bytes of the same pushes sent one by one;
    ``"combine"`` (classic PS sum semantics: one apply of the per-row sums)
    equals one push of all members' gradients within 1e-5."""
    dim, k, n = 8, 16, 48
    cfgs = {"e": TableConfig(name="e", rows=256, dim=dim,
                             optimizer=OptimizerConfig(kind="adam", learning_rate=0.05))}
    rng = np.random.default_rng(5)
    pool = rng.choice(1 << 20, size=64, replace=False).astype(np.uint64)
    pushes = [(rng.choice(pool, size=n, replace=False),
               rng.normal(size=(n, dim)).astype(np.float32)) for _ in range(k)]
    shards = []
    for leg in ("coalesced", "reference"):
        base = LoopbackVan()
        van = CoalescingVan(base) if leg == "coalesced" else base
        try:
            srv = KVServer(Postoffice("S0", van), cfgs, 0, 1, device="cpu",
                           apply=ApplyEngineConfig(apply_batch=k, dup_policy=dup_policy))
            calls = []
            real = srv.handle_request_batch

            def spy(msgs, real=real):
                calls.append(len(msgs))
                return real(msgs)

            srv.handle_request_batch = spy
            worker = KVWorker(Postoffice("W0", van), cfgs, 1, device="cpu")
            if leg == "coalesced":
                with worker.coalesce_window():
                    ts = [worker.push("e", keys, g) for keys, g in pushes]
                assert all(worker.wait(t, timeout=30) for t in ts)
                assert calls == [k] and srv.pushes == k
                assert van.counters()["coalesce_msgs"] >= k
                assert srv.ledger.counters()["applies_submitted"] == 1
            elif dup_policy == "rounds":
                for keys, g in pushes:
                    assert worker.wait(worker.push("e", keys, g), timeout=30)
                assert srv.pushes == k
            else:  # one push carrying every member's rows: the sum semantics
                keys = np.concatenate([p[0] for p in pushes])
                grads = np.concatenate([p[1] for p in pushes])
                assert worker.wait(worker.push("e", keys, grads), timeout=30)
            if leg == "reference":
                assert calls == []
            shards.append(srv.export_shard()["e"])
        finally:
            van.close()
            srv.ledger.close()
    got, want = shards
    for name in ["value", *sorted(got["state"])]:
        a = got["value"] if name == "value" else got["state"][name]
        b = want["value"] if name == "value" else want["state"][name]
        if dup_policy == "rounds":
            np.testing.assert_array_equal(a, b)
        else:
            np.testing.assert_allclose(a, b, **TOL)


# ------------------------------------------ a loop through both packages


def _loop(side, steps=3):
    """2 workers x 2 servers, two tables, ``steps`` rounds of a push_many
    window then a pull window per worker; returns (tables, van counters)."""
    rng = np.random.default_rng(8)
    stream = [[(rng.integers(0, 1 << 20, size=96).astype(np.uint64),
                rng.integers(0, 1 << 20, size=64).astype(np.uint64),
                rng.normal(size=96).astype(np.float32),
                rng.normal(size=64).astype(np.float32)) for _ in range(2)]
              for _ in range(steps)]
    if side == "jax":
        opt = JaxOptimizerConfig(kind="adagrad", learning_rate=0.1)
        cfgs = {t: JaxTableConfig(name=t, rows=ROWS, dim=1, optimizer=opt) for t in "wu"}
        van = jax_coalesce.CoalescingVan(JaxLoopbackVan())
        servers = [JaxKVServer(JaxPostoffice(f"S{s}", van), cfgs, s, 2) for s in range(2)]
        workers = [JaxKVWorker(JaxPostoffice(f"W{i}", van), cfgs, 2) for i in range(2)]
    else:
        opt = OptimizerConfig(kind="adagrad", learning_rate=0.1)
        cfgs = {t: TableConfig(name=t, rows=ROWS, dim=1, optimizer=opt) for t in "wu"}
        van = CoalescingVan(LoopbackVan())
        servers = [KVServer(Postoffice(f"S{s}", van), cfgs, s, 2, device="cpu")
                   for s in range(2)]
        workers = [KVWorker(Postoffice(f"W{i}", van), cfgs, 2, device="cpu")
                   for i in range(2)]
    try:
        pulled = []
        for step in stream:
            for worker, (kw, ku, gw, gu) in zip(workers, step):
                ts = worker.push_many({"w": (kw, gw), "u": (ku, gu)})
                assert all(worker.wait(t, timeout=30) for t in ts.values())
                with worker.coalesce_window():
                    pw, pu = worker.pull("w", kw), worker.pull("u", ku)
                pulled.append((worker.pull_result(pw, timeout=30),
                               worker.pull_result(pu, timeout=30)))
        assert van.flush(10)
        tables = [{t: s.export_shard()[t] for t in "wu"} for s in servers]
        counters = {k: v for k, v in van.counters().items() if k.startswith("coalesce_")}
        return tables, counters, pulled
    finally:
        van.close()
        if side == "port":
            for s in servers:
                s.ledger.close()


def test_push_many_loop_matches_jax_on_coalescing_stacks():
    port_tables, port_counters, port_pulled = _loop("port")
    jax_tables, jax_counters, jax_pulled = _loop("jax")
    # which trigger emits a frame whose window closed while another thread's
    # was open (the last window out, or the timer) is a race in both
    # packages; the frames and messages are not
    for c in (port_counters, jax_counters):
        c.pop("coalesce_flush_timer")
    assert port_counters == jax_counters
    assert port_counters["coalesce_frames"] < port_counters["coalesce_msgs"]
    for p, j in zip(port_tables, jax_tables):
        for t in "wu":
            np.testing.assert_allclose(p[t]["value"], j[t]["value"], **TOL)
            np.testing.assert_allclose(p[t]["state"]["sum_sq"], j[t]["state"]["sum_sq"], **TOL)
    for (pw, pu), (jw, ju) in zip(port_pulled, jax_pulled):
        np.testing.assert_allclose(pw, np.asarray(jw), **TOL)
        np.testing.assert_allclose(pu, np.asarray(ju), **TOL)
