"""The port's ApplyLedger and its server wiring against the JAX package's,
on the CPU.

``parameter_server_tpu_torch/kv/ledger.py`` keeps the JAX ledger's submit
side, FIFO per table, counters, digests, events and lazy reaper; only the
completion handle changes (a CUDA event on the card, polled with
``query()`` and waited on with ``synchronize()``; a completed handle on the
CPU).  These tests run the JAX package's scripted ledger cases on both
ledgers with the same handle script, feed a port and a JAX ``KVServer`` the
same pushes (single, three-pass, bundled under both duplicate policies) and
compare their ledger entries, and drive the ``__busy__`` hint and
``server_busy()`` with a completion handle that stays pending.

Tolerances: counters, events and ledger entries exactly; tables within
rtol = atol = 1e-5.
"""

import dataclasses
import time

import numpy as np
import pytest
import torch

from parameter_server_tpu.config import ApplyEngineConfig as JaxApplyEngineConfig
from parameter_server_tpu.config import LedgerConfig as JaxLedgerConfig
from parameter_server_tpu.config import OptimizerConfig as JaxOptimizerConfig
from parameter_server_tpu.config import TableConfig as JaxTableConfig
from parameter_server_tpu.core import flightrec as jax_flightrec
from parameter_server_tpu.core import messages as jax_messages
from parameter_server_tpu.core.postoffice import Postoffice as JaxPostoffice
from parameter_server_tpu.core.van import LoopbackVan as JaxLoopbackVan
from parameter_server_tpu.kv.ledger import ApplyLedger as JaxApplyLedger
from parameter_server_tpu.kv.server import KVServer as JaxKVServer
from parameter_server_tpu_torch.config import (
    ApplyEngineConfig,
    LedgerConfig,
    OptimizerConfig,
    TableConfig,
)
from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core import messages as port_messages
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import LoopbackVan
from parameter_server_tpu_torch.kv.ledger import COMPLETED, ApplyLedger
from parameter_server_tpu_torch.kv.server import KVServer
from parameter_server_tpu_torch.kv.worker import KVWorker

DIM = 4
ROWS = 64
TOL = dict(rtol=1e-5, atol=1e-5)

#: fast reaper degraded-mode cadence for scripted handles, which have no
#: wait method and so push the reaper onto its polling fallback.
_FAST = dict(reap_interval_s=0.002, idle_stop_s=0.2)

#: event fields that carry times (they differ run to run)
_TIME_FIELDS = {"seq", "t_mono_s", "ms", "host_ms", "h2d_ms", "device_ms", "age_s"}


class _Ref:
    """Scripted completion handle: ``is_ready()`` for the JAX ledger,
    ``query()`` for the port's; both raise once ``dead``."""

    def __init__(self, ready=False, dead=False):
        self.ready = ready
        self.dead = dead

    def is_ready(self):
        if self.dead:
            raise RuntimeError("handle gone")
        return self.ready

    query = is_ready


def _ledgers(**cfg):
    """(port, jax) ledgers with the same config, each with its own ring."""
    recs = (flightrec.FlightRecorder(capacity=256),
            jax_flightrec.FlightRecorder(capacity=256))
    return [
        (ApplyLedger("S0", LedgerConfig(**cfg), recorder=recs[0]), recs[0]),
        (JaxApplyLedger("S0", JaxLedgerConfig(**cfg), recorder=recs[1]), recs[1]),
    ]


def _drained(ledger, timeout=5.0):
    """``drain()``, then wait until the reaper has finished the retires it
    counted: both ledgers drop the in-flight count before ``_retire``
    records the entry's digests and its ``apply.done`` event."""
    assert ledger.drain(timeout), ledger.counters()
    rec = ledger._recorder

    def settled():
        retired = ledger.counters()["applies_retired"]
        digs = ledger.latency_digests()
        if sum(d["count"] for k, d in digs.items() if k.startswith("apply.")) < retired:
            return False
        if rec is None or len(rec._ring) == rec._ring.maxlen:
            return True  # the global ring, or a wrapped one: no event count
        return sum(e["kind"] == "apply.done" for e in rec.events()) >= retired

    deadline = time.monotonic() + timeout
    while not settled():
        assert time.monotonic() < deadline, ledger.counters()
        time.sleep(0.001)


def _stripped(rec):
    return [{k: v for k, v in e.items() if k not in _TIME_FIELDS} for e in rec.events()]


def _same_outcome(pair):
    """Counters (but the age gauge), digest counts and events' non-time
    fields, in order, equal between the two ledgers."""
    (port, prec), (ref, rrec) = pair
    pc, rc = port.counters(), ref.counters()
    pc.pop("backlog_age_s")
    rc.pop("backlog_age_s")
    assert pc == rc
    assert ({k: d["count"] for k, d in port.latency_digests().items()}
            == {k: d["count"] for k, d in ref.latency_digests().items()})
    assert _stripped(prec) == _stripped(rrec)


# --------------------------------------------------- scripted, both ledgers


def test_ledger_config_has_the_jax_fields_and_defaults():
    assert ([(f.name, f.default) for f in dataclasses.fields(LedgerConfig)]
            == [(f.name, f.default) for f in dataclasses.fields(JaxLedgerConfig)])
    for cls in (ApplyLedger, JaxApplyLedger):
        cfg = (LedgerConfig if cls is ApplyLedger else JaxLedgerConfig)(reap_interval_s=0)
        with pytest.raises(ValueError, match="reap_interval_s"):
            cls("S0", cfg)


def test_submit_retires_exactly_once_with_attribution_digests():
    pair = _ledgers(**_FAST)
    try:
        for led, rec in pair:
            tok = led.begin("w", members=2, rows=12)
            tok.mark_host()
            tok.mark_h2d()
            ref = _Ref(ready=False)
            led.submit(tok, ref, fallback=lambda ref=ref: ref)
            c = led.counters()
            assert c["inflight_bundles"] == 1 and c["inflight_rows"] == 12
            assert c["applies_submitted"] == 1 and c["applies_retired"] == 0
            assert not led.overloaded()
            ref.ready = True
            _drained(led)
            digs = led.latency_digests()
            assert set(digs) == {"apply.w", "apply_host.w", "apply_h2d.w", "apply_dev.w"}
            assert [e["kind"] for e in rec.events()] == ["apply.submit", "apply.done"]
            done = rec.events()[-1]
            assert done["ms"] >= done["host_ms"] >= 0
        _same_outcome(pair)
        assert pair[0][0].counters()["applies_retired"] == 1
    finally:
        for led, _ in pair:
            led.close()


def test_unpollable_handle_retires_via_fallback_and_is_censored():
    pair = _ledgers(**_FAST)
    try:
        for led, _ in pair:
            tok = led.begin("w", 1, 4)
            led.submit(tok, _Ref(dead=True), fallback=lambda: _Ref(ready=True))
            _drained(led)
        _same_outcome(pair)
        c = pair[0][0].counters()
        assert c["applies_retired"] == 1 and c["applies_censored"] == 1
    finally:
        for led, _ in pair:
            led.close()


def test_backlog_edge_events_and_overloaded_level():
    pair = _ledgers(backlog_bundles=2, **_FAST)
    try:
        levels = []
        for led, rec in pair:
            refs = [_Ref() for _ in range(3)]
            seen = []
            for r in refs:
                led.submit(led.begin("w", 1, 1), r, fallback=lambda r=r: r)
                seen.append(led.overloaded())
            for r in refs:
                r.ready = True
            _drained(led)
            seen.append(led.overloaded())
            levels.append(seen)
            edges = [e for e in rec.events() if e["kind"] == "apply.backlog"]
            assert [e["state"] for e in edges] == ["enter", "clear"]
            assert edges[0]["inflight_bundles"] == 3
        assert levels[0] == levels[1] == [False, False, True, False]
        _same_outcome(pair)
    finally:
        for led, _ in pair:
            led.close()


def test_fifo_per_table_retires_heads_in_order():
    pair = _ledgers(**_FAST)
    try:
        for led, rec in pair:
            refs = {t: [_Ref(), _Ref()] for t in ("w", "u")}
            for i in range(2):
                for t in ("w", "u"):
                    led.submit(led.begin(t, 1, 1 + i), refs[t][i], lambda: _Ref(ready=True))
            refs["w"][1].ready = True  # the younger one first: must wait for its head
            assert led._reap_once() == []
            assert led.counters()["applies_retired"] == 0
            refs["w"][0].ready = True
            deadline = time.monotonic() + 5
            while led.counters()["applies_retired"] < 2 and time.monotonic() < deadline:
                time.sleep(0.005)
            assert led.counters()["applies_retired"] == 2
            for r in refs["u"]:
                r.ready = True
            _drained(led)
        (port, prec), (ref, rrec) = pair
        done = [[(e["table"], e["bundle"]) for e in r.events() if e["kind"] == "apply.done"]
                for r in (prec, rrec)]
        assert done[0] == done[1]
        assert [b for t, b in done[0] if t == "w"] == [1, 3]
    finally:
        for led, _ in pair:
            led.close()


def test_reaper_self_stops_when_idle_and_restarts_on_submit():
    led = ApplyLedger("S0", LedgerConfig(**_FAST))
    try:
        led.submit(led.begin("w", 1, 1), _Ref(ready=True), lambda: None)
        _drained(led)
        deadline = time.monotonic() + 5.0
        while time.monotonic() < deadline:
            reaper = led._reaper
            if reaper is None or not reaper.is_alive():
                break
            time.sleep(0.01)
        else:
            pytest.fail("reaper did not self-stop after idle_stop_s")
        led.submit(led.begin("w", 1, 1), COMPLETED, lambda: COMPLETED)
        _drained(led)
        assert led.counters()["applies_retired"] == 2
    finally:
        led.close()


def test_completed_handle_reads_done_and_waits_for_nothing():
    assert COMPLETED.query() is True
    assert COMPLETED.synchronize() is None


# ------------------------------------------------- server: same pushes, both


def _push_msgs(msgs, seed, k, n, pool=48):
    rng = np.random.default_rng(seed)
    return [
        msgs.Message(
            task=msgs.Task(msgs.TaskKind.PUSH, "kv", payload={"table": "w"}),
            sender="W0", recver="LS0",
            keys=np.sort(rng.choice(pool, size=n, replace=False)).astype(np.int32),
            values=[rng.normal(size=(n, DIM)).astype(np.float32)],
        )
        for _ in range(k)
    ]


def _servers(fused, dup_policy):
    opt = dict(kind="adagrad", learning_rate=0.1)
    jvan, pvan = JaxLoopbackVan(), LoopbackVan()
    jsrv = JaxKVServer(
        JaxPostoffice("LS0", jvan),
        {"w": JaxTableConfig(name="w", rows=ROWS, dim=DIM, fused_apply=fused,
                             optimizer=JaxOptimizerConfig(**opt))},
        0, 1, apply=JaxApplyEngineConfig(dup_policy=dup_policy))
    psrv = KVServer(
        Postoffice("LS0", pvan),
        {"w": TableConfig(name="w", rows=ROWS, dim=DIM, fused_apply=fused,
                          optimizer=OptimizerConfig(**opt))},
        0, 1, apply=ApplyEngineConfig(dup_policy=dup_policy), device="cpu")
    return (jvan, jsrv), (pvan, psrv)


def _entries(mod):
    return [(e["table"], e["members"], e["rows"]) for e in mod.get().events()
            if e["kind"] == "apply.submit" and e.get("node") == "LS0"]


@pytest.mark.parametrize("fused", [True, False], ids=["fused", "three_pass"])
@pytest.mark.parametrize("dup_policy", ["rounds", "combine"])
def test_server_ledger_entries_match_jax(fused, dup_policy):
    """Two single pushes, a bundle of four (cross-member duplicates), one
    more single push: the same ledger entries (table, members, rows) in both
    packages, every entry retired, tables within 1e-5."""
    flightrec.configure(clear=True)
    jax_flightrec.configure(clear=True)
    (jvan, jsrv), (pvan, psrv) = _servers(fused, dup_policy)
    try:
        for srv, msgs in ((jsrv, jax_messages), (psrv, port_messages)):
            singles = _push_msgs(msgs, 1, 3, 20)
            for m in singles[:2]:
                assert "__error__" not in srv.handle_request(m).task.payload
            replies = srv.handle_request_batch(_push_msgs(msgs, 2, 4, 24))
            assert all("__error__" not in r.task.payload for r in replies)
            srv.handle_request(singles[2])
            assert srv.ledger.drain(5.0)
        port_entries, jax_entries = _entries(flightrec), _entries(jax_flightrec)
        assert port_entries == jax_entries
        assert [m for _, m, _ in port_entries] == [1, 1, 4, 1]
        pc, jc = psrv.counters(), jsrv.counters()
        for key in ("applies_submitted", "applies_retired", "inflight_bundles",
                    "inflight_rows", "fenced_rejects", "seg_version_max"):
            assert pc[key] == jc[key], key
        # the JAX tables donate their buffers, so its reaper may censor an
        # entry; the port updates in place and never does
        assert pc["applies_retired"] == 4 and pc["applies_censored"] == 0
        digs = psrv.latency_digests()
        assert {k: d["count"] for k, d in digs.items()} == {
            k: d["count"] for k, d in jsrv.latency_digests().items()}
        assert digs["apply.w"]["count"] == 4
        jshard, pshard = jsrv.export_shard()["w"], psrv.export_shard()["w"]
        np.testing.assert_allclose(pshard["value"], jshard["value"], **TOL)
        np.testing.assert_allclose(pshard["state"]["sum_sq"], jshard["state"]["sum_sq"], **TOL)
    finally:
        jvan.close()
        pvan.close()
        psrv.ledger.close()
        flightrec.configure(clear=True)
        jax_flightrec.configure(clear=True)


def test_cpu_server_submits_the_completed_handle():
    (jvan, _), (pvan, psrv) = _servers(True, "rounds")
    try:
        seen = []
        real = psrv.ledger.submit
        psrv.ledger.submit = lambda tok, ref, fb: (seen.append((ref, fb())), real(tok, ref, fb))
        psrv.handle_request(_push_msgs(port_messages, 3, 1, 8)[0])
        assert seen == [(COMPLETED, COMPLETED)]
    finally:
        jvan.close()
        pvan.close()
        psrv.ledger.close()


def test_disabled_ledger_builds_none_and_never_hints():
    van = LoopbackVan()
    try:
        srv = KVServer(
            Postoffice("LS0", van),
            {"w": TableConfig(name="w", rows=ROWS, dim=DIM)}, 0, 1,
            devobs=LedgerConfig(enabled=False), device="cpu")
        assert srv.ledger is None
        reply = srv.handle_request(_push_msgs(port_messages, 4, 1, 8)[0])
        assert "__busy__" not in reply.task.payload
        assert "applies_submitted" not in srv.counters()
        assert srv.latency_digests() == {}
    finally:
        van.close()


# ------------------------------------------------------- backpressure


class _Pending:
    """A completion handle that stays pending until the test opens it (no
    wait method: the reaper polls it)."""

    def __init__(self):
        self.ready = False

    def query(self):
        return self.ready


def test_ack_lands_while_the_apply_is_still_in_flight():
    """The sync-free contract with the ledger attached: the push ack returns
    while the apply's handle is pending and the ledger still holds it;
    retirement comes strictly after the handle completes."""
    van = LoopbackVan()
    try:
        srv = KVServer(Postoffice("LS0", van),
                       {"w": TableConfig(name="w", rows=ROWS, dim=DIM)}, 0, 1,
                       devobs=LedgerConfig(**_FAST), device="cpu")
        handles = []

        def pending(stream=None):
            handles.append(_Pending())
            return handles[-1]

        srv._completion_handle = pending
        reply = srv.handle_request(_push_msgs(port_messages, 5, 1, 8)[0])
        assert "__error__" not in reply.task.payload
        c = srv.ledger.counters()
        assert c["applies_submitted"] == 1 and c["applies_retired"] == 0
        assert c["inflight_bundles"] == 1
        handles[0].ready = True
        _drained(srv.ledger)
        assert srv.ledger.counters()["applies_retired"] == 1
    finally:
        van.close()
        srv.ledger.close()


def test_backlog_stamps_busy_on_acks_and_the_worker_sees_it():
    """Acks keep landing while nothing retires: past ``backlog_bundles`` the
    server stamps ``__busy__``, the worker counts the hint and reports the
    server busy; once the handles complete the backlog clears, the edge
    events land in the flight recorder and acks stop carrying the hint."""
    flightrec.configure(clear=True)
    van = LoopbackVan()
    try:
        cfgs = {"w": TableConfig(name="w", rows=ROWS, dim=DIM,
                                 optimizer=OptimizerConfig(kind="adagrad", learning_rate=0.1))}
        srv = KVServer(Postoffice("S0", van), cfgs, 0, 1,
                       devobs=LedgerConfig(backlog_bundles=2, **_FAST), device="cpu")
        worker = KVWorker(Postoffice("BW0", van), cfgs, 1, device="cpu")
        handles = []

        def pending(stream=None):
            handles.append(_Pending())
            return handles[-1]

        srv._completion_handle = pending
        rng = np.random.default_rng(3)
        keys = np.sort(rng.choice(ROWS, size=8, replace=False)).astype(np.uint32)

        def push():
            g = rng.standard_normal((8, DIM)).astype(np.float32)
            assert worker.wait(worker.push("w", keys, g), timeout=60)

        push()  # healthy: one apply in flight, then retired
        handles[-1].ready = True
        _drained(srv.ledger)
        assert worker.busy_hints == 0 and not worker.server_busy("S0")

        for _ in range(4):
            push()
        assert srv.ledger.counters()["inflight_bundles"] == 4
        assert srv.ledger.overloaded()
        assert worker.busy_hints == 2  # the 3rd and 4th acks: 3 > 2, 4 > 2
        assert worker.server_busy("S0") and not worker.server_busy("S1")
        assert srv.counters()["inflight_bundles"] == 4

        for h in handles:
            h.ready = True
        _drained(srv.ledger)
        assert not srv.ledger.overloaded()
        edges = [e["state"] for e in flightrec.get().events()
                 if e["kind"] == "apply.backlog" and e.get("node") == "S0"]
        assert edges == ["enter", "clear"]
        hints = worker.busy_hints
        push()
        handles[-1].ready = True
        _drained(srv.ledger)
        assert worker.busy_hints == hints
    finally:
        van.close()
        srv.ledger.close()
        flightrec.configure(clear=True)


@pytest.mark.cuda
def test_card_handle_is_a_blocking_event_on_the_apply_stream():
    """On the card the server's completion handle is a CUDA event recorded
    after the launch; the reaper retires every push (run on the H100:
    ``python -m pytest -m cuda tests/``)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card: the apply ledger's events live there")
    van = LoopbackVan()
    try:
        srv = KVServer(Postoffice("LS0", van),
                       {"w": TableConfig(name="w", rows=ROWS, dim=DIM)}, 0, 1)
        handle = srv._completion_handle(torch.cuda.current_stream())
        assert isinstance(handle, torch.cuda.Event)
        for m in _push_msgs(port_messages, 6, 3, 8):
            srv.handle_request(m)
        _drained(srv.ledger)
        c = srv.ledger.counters()
        assert c["applies_retired"] == c["applies_submitted"] == 3
        assert c["applies_censored"] == 0
    finally:
        van.close()
        srv.ledger.close()
