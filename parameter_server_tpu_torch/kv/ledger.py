"""ApplyLedger: device-plane observability for the sync-free apply engine.

The port of ``parameter_server_tpu/kv/ledger.py``.  The server acks a PUSH
as soon as its device apply is LAUNCHED (``kv/server.py::_ack_push`` never
touches device state), which keeps the ack fast and makes the device
invisible: true apply latency, device queue depth, and the
host-assembly/H2D/compute split appear in no latency the ack measures.
This module is that gauge.

Lifecycle of one in-flight apply::

    tok = ledger.begin(table, members, rows)   # recv thread, t_submit
    ...host plane assembly...                  #   (one pinned host buffer)
    tok.mark_host()                            # host-assembly split point
    ...non_blocking H2D copy / device stack...
    tok.mark_h2d()
    ...kernel launch(es)...
    ledger.submit(tok, ref, fallback)          # still the recv thread

``ref`` is the apply's completion handle.  On the card it is a
``torch.cuda.Event(blocking=True)`` that the server records on the stream
the kernels were launched on (the receive thread's current stream) right
after the last launch; on the CPU, where the apply has finished when
``KVTable.push`` returns, it is :data:`COMPLETED`.  The **reaper** — a
lazy-started daemon thread — retires entries once ``ref.query()`` is True
(where the JAX ledger polls ``is_ready()``) and never runs on the ack path,
so the sync-free contract holds by construction (and by AST:
``tests/test_torch_rules.py`` bans device syncs and ``query`` in
``begin``/``mark_host``/``mark_h2d``/``submit``/``overloaded``).  Between
completions the reaper BLOCKS on the oldest in-flight handle with
``ref.synchronize()`` (where JAX calls ``block_until_ready()``): a blocking
event sleeps inside CUDA with the GIL released, one wakeup per apply.
``reap_interval_s`` is only the degraded-mode cadence (a handle whose poll
raises, :meth:`drain`).

Ordering: entries retire in FIFO order per table, and the reaper waits on
the oldest one first.  That assumes the oldest dispatch completes first,
which holds because every apply of a server is launched on one stream (all
servers of a process share the device's default stream).

Fallback: the port updates its tables in place, so nothing donates a
buffer and a handle's poll does not raise; ``applies_censored`` stays 0 on
the card.  The path is kept from the JAX ledger for a handle that does
raise: it is replaced by ``fallback()`` — a fresh handle recorded on the
apply's stream, whose completion bounds every older apply's — and its
latency is then an upper bound (``applies_censored``).

What the ledger feeds:

- flight recorder: ``apply.submit`` / ``apply.done`` per apply and an
  edge-triggered ``apply.backlog`` when a configured bound is crossed
  (both directions, ``state=enter|clear``);
- :meth:`counters` gauges (``inflight_bundles``, ``inflight_rows``,
  ``backlog_age_s``) and :meth:`latency_digests` cumulative per-table
  histograms (``apply.<t>`` total plus ``apply_host.<t>`` /
  ``apply_h2d.<t>`` / ``apply_dev.<t>`` attribution, host monotonic
  stamps).  On one card ``apply_dev`` is queue plus compute: it includes
  whatever else the stream ran before the apply;
- backpressure: :meth:`overloaded` is the level-triggered signal
  ``KVServer._ack_push`` turns into the ``__busy__`` ack hint.
"""

from __future__ import annotations

import collections
import threading
import time
from typing import Callable, Dict, List, Optional

from parameter_server_tpu_torch.config import LedgerConfig
from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.utils.trace import LatencyHistogram


class CompletedHandle:
    """Completion handle of an apply that finished before it was submitted
    (every apply on the CPU): ``query()`` is True, ``synchronize()`` returns
    at once — the interface of ``torch.cuda.Event`` the reaper uses."""

    __slots__ = ()

    def query(self) -> bool:
        return True

    def synchronize(self) -> None:
        return None


#: the shared completed handle
COMPLETED = CompletedHandle()


class _Inflight:
    """One registered apply.  Slotted: the submit path builds exactly one
    of these per bundle, nothing else."""

    __slots__ = (
        "bundle", "table", "members", "rows",
        "t_submit", "t_host", "t_h2d", "ref", "fallback", "tid",
    )

    def __init__(
        self,
        bundle: int,
        table: str,
        members: int,
        rows: int,
        tid: Optional[str] = None,
    ):
        self.bundle = bundle
        self.table = table
        self.members = members
        self.rows = rows
        self.t_submit = time.monotonic()
        self.t_host: Optional[float] = None
        self.t_h2d: Optional[float] = None
        self.ref = None
        self.fallback: Optional[Callable[[], object]] = None
        #: sampled trace id: set when a sampled request rode
        #: this apply — retirement then records a ``trace.apply`` child
        #: span carrying the host/H2D/device split
        self.tid = tid

    def mark_host(self) -> None:
        """Host plane assembly finished (the pinned-buffer pack)."""
        self.t_host = time.monotonic()

    def mark_h2d(self) -> None:
        """Device handoff dispatched (the non-blocking H2D copy / device
        stack)."""
        self.t_h2d = time.monotonic()


class ApplyLedger:
    """Per-server registry of in-flight device applies + reaper thread.

    Submit-side methods (:meth:`begin`, ``mark_host``/``mark_h2d`` on the
    token, :meth:`submit`) run on the server's recv thread and are
    host-bookkeeping only — one lock acquire and a deque append.  Retiring
    happens exclusively on the reaper, which blocks inside CUDA on the
    oldest in-flight handle between completions, self-stops after
    ``idle_stop_s`` with nothing in flight, and restarts lazily on the
    next submit — idle servers pay nothing, busy servers pay one wakeup
    per apply.
    """

    def __init__(
        self,
        node_id: str,
        cfg: Optional[LedgerConfig] = None,
        *,
        recorder: Optional[flightrec.FlightRecorder] = None,
    ) -> None:
        self.node_id = node_id
        self.cfg = cfg or LedgerConfig()
        if self.cfg.reap_interval_s <= 0:
            raise ValueError("reap_interval_s must be > 0")
        self._recorder = recorder
        self._lock = threading.Lock()
        #: submit -> reaper doorbell; shares the ledger lock.
        self._cond = threading.Condition(self._lock)
        #: per-table FIFO of in-flight entries (one stream executes launches
        #: in order, so per-table head completion implies everything older).
        self._inflight: Dict[str, collections.deque] = {}
        self._bundle_seq = 0
        self._inflight_rows = 0
        self._inflight_bundles = 0
        self.applies_submitted = 0
        self.applies_retired = 0
        #: retired via the fallback handle (latency is an upper bound); 0
        #: on the card, where no handle's poll raises.
        self.applies_censored = 0
        #: cumulative seconds-axis histograms, per table.
        self._hists: Dict[str, LatencyHistogram] = {}
        self._overloaded = False
        self._reaper: Optional[threading.Thread] = None
        self._closed = False

    # -- submit side (recv thread; sync-free by AST contract) ---------------
    def begin(
        self,
        table: str,
        members: int,
        rows: int,
        tid: Optional[str] = None,
    ) -> _Inflight:
        """Open an in-flight entry at dispatch start; returns the token the
        apply path marks its split points on.  ``tid``: sampled trace id
        riding this apply, if any."""
        with self._lock:
            self._bundle_seq += 1
            seq = self._bundle_seq
        return _Inflight(seq, table, members, rows, tid)

    def submit(
        self, tok: _Inflight, ref, fallback: Callable[[], object]
    ) -> None:
        """Register the dispatched apply for reaping.

        ``ref``: the apply's completion handle (polled with ``query()``,
        waited on with ``synchronize()``): a CUDA event recorded after the
        launch, or :data:`COMPLETED`;
        ``fallback``: zero-arg callable returning a fresh handle on the
        apply's stream, used when polling ``ref`` raises.
        """
        tok.ref = ref
        tok.fallback = fallback
        with self._lock:
            if self._closed:
                return
            dq = self._inflight.get(tok.table)
            if dq is None:
                dq = self._inflight[tok.table] = collections.deque()
            dq.append(tok)
            self._inflight_bundles += 1
            self._inflight_rows += tok.rows
            self.applies_submitted += 1
            crossed = self._backlog_edge_locked()
            start = self._reaper is None or not self._reaper.is_alive()
            if start:
                self._reaper = threading.Thread(
                    target=self._reap_loop,
                    name=f"apply-ledger-{self.node_id}",
                    daemon=True,
                )
                self._reaper.start()
            else:
                self._cond.notify()
        self._record(
            "apply.submit", node=self.node_id, bundle=tok.bundle,
            table=tok.table, members=tok.members, rows=tok.rows,
        )
        if crossed is not None:
            self._record_backlog(crossed)

    # -- backpressure --------------------------------------------------------
    def overloaded(self) -> bool:
        """Level-triggered backlog signal — the ``__busy__`` ack hint."""
        return self._overloaded

    def _backlog_age_locked(self, now: float) -> float:
        oldest = None
        for dq in self._inflight.values():
            if dq:
                t = dq[0].t_submit
                if oldest is None or t < oldest:
                    oldest = t
        return (now - oldest) if oldest is not None else 0.0

    def _backlog_edge_locked(self) -> Optional[bool]:
        """Recompute the overload state; returns the new state on a
        transition, None when unchanged.  Caller holds the lock."""
        c = self.cfg
        over = bool(
            (c.backlog_bundles and self._inflight_bundles > c.backlog_bundles)
            or (c.backlog_rows and self._inflight_rows > c.backlog_rows)
            or (
                c.backlog_age_s
                and self._backlog_age_locked(time.monotonic())
                > c.backlog_age_s
            )
        )
        if over == self._overloaded:
            return None
        self._overloaded = over
        return over

    def _record(self, kind: str, **fields) -> None:
        # aliased-callable form (as utils/slo.py): every call SITE passes a
        # literal kind from the EVENTS registry; the dispatch here stays
        # out of check_wrappers' definitive flightrec.record(...) scan
        rec = (
            flightrec.record if self._recorder is None
            else self._recorder.record
        )
        rec(kind, **fields)

    def _record_backlog(self, entered: bool) -> None:
        with self._lock:
            bundles = self._inflight_bundles
            rows = self._inflight_rows
            age = self._backlog_age_locked(time.monotonic())
        self._record(
            "apply.backlog",
            node=self.node_id,
            state="enter" if entered else "clear",
            inflight_bundles=bundles,
            inflight_rows=rows,
            age_s=round(age, 6),
        )

    # -- reaper --------------------------------------------------------------
    def _reap_loop(self) -> None:
        while True:
            with self._cond:
                while not self._closed and self._inflight_bundles == 0:
                    if not self._cond.wait(timeout=self.cfg.idle_stop_s):
                        # idle too long with nothing in flight: self-stop.
                        # The decision happens UNDER the lock, so a racing
                        # submit either lands before (wait returns True) or
                        # sees the dead thread and re-spawns.
                        if self._inflight_bundles == 0:
                            self._reaper = None
                            return
                if self._closed:
                    return
            self._reap_once()
            head = self._oldest_head()
            if head is None:
                continue
            try:
                # sleep INSIDE CUDA until the oldest launched apply
                # completes: a blocking event's synchronize() releases the
                # GIL and wakes once per completion — no poll cadence, no
                # recv-thread preemption.  One stream => oldest completes
                # first, so this is never a priority inversion.
                head.ref.synchronize()
            except Exception:
                # a handle without a wait, or one whose wait raised: degrade
                # to one interval of polling; _reap_once swaps in the
                # fallback where the poll raises too
                time.sleep(self.cfg.reap_interval_s)

    def _oldest_head(self) -> Optional[_Inflight]:
        with self._lock:
            heads = [dq[0] for dq in self._inflight.values() if dq]
        return min(heads, key=lambda e: e.t_submit, default=None)

    def _reap_once(self) -> List[_Inflight]:
        """Retire every per-table FIFO head whose handle reports done."""
        done: List[_Inflight] = []
        censored: List[_Inflight] = []
        with self._lock:
            tables = list(self._inflight)
        for t in tables:
            while True:
                with self._lock:
                    dq = self._inflight.get(t)
                    head = dq[0] if dq else None
                if head is None:
                    break
                try:
                    ready = head.ref.query()
                except Exception:
                    # the handle cannot be polled: poll a fresh handle on
                    # the apply's stream instead — its completion bounds
                    # this (older) apply's
                    try:
                        head.ref = head.fallback()
                    except Exception:
                        ready = True  # table gone (resize/close): retire
                    else:
                        censored.append(head)
                        continue
                if not ready:
                    break
                with self._lock:
                    dq = self._inflight.get(t)
                    if not dq or dq[0] is not head:
                        break  # closed/cleared underneath us
                    dq.popleft()
                    self._inflight_bundles -= 1
                    self._inflight_rows -= head.rows
                    self.applies_retired += 1
                    if head in censored:
                        self.applies_censored += 1
                    crossed = self._backlog_edge_locked()
                self._retire(head)
                if crossed is not None:
                    self._record_backlog(crossed)
                done.append(head)
        return done

    def _retire(self, e: _Inflight) -> None:
        t_done = time.monotonic()
        t_host = e.t_host if e.t_host is not None else e.t_submit
        t_h2d = e.t_h2d if e.t_h2d is not None else t_host
        total = t_done - e.t_submit
        host = t_host - e.t_submit
        h2d = t_h2d - t_host
        dev = t_done - t_h2d
        with self._lock:
            hists = self._hists
            for name, v in (
                (f"apply.{e.table}", total),
                (f"apply_host.{e.table}", host),
                (f"apply_h2d.{e.table}", h2d),
                (f"apply_dev.{e.table}", dev),
            ):
                h = hists.get(name)
                if h is None:
                    h = hists[name] = LatencyHistogram()
                h.record(max(v, 0.0))
        self._record(
            "apply.done", node=self.node_id, bundle=e.bundle, table=e.table,
            members=e.members, rows=e.rows, ms=round(1e3 * total, 3),
            host_ms=round(1e3 * host, 3), h2d_ms=round(1e3 * h2d, 3),
            device_ms=round(1e3 * dev, 3),
        )
        if e.tid is not None:
            # sampled request tracing: the device-plane child
            # span — host pack / H2D / device execution attribution for
            # the apply the sampled request rode
            self._record(
                "trace.apply",
                tid=e.tid,
                node=self.node_id,
                table=e.table,
                ms=round(1e3 * total, 3),
                host_ms=round(1e3 * host, 3),
                h2d_ms=round(1e3 * h2d, 3),
                device_ms=round(1e3 * dev, 3),
            )

    # -- telemetry-facing reads ----------------------------------------------
    def counters(self) -> dict:
        """Live gauges + cumulative totals, publisher/Dashboard-mergeable.

        Gauges (``inflight_*``, ``backlog_age_s``) move both ways; the
        telemetry delta framing reconstructs them exactly (the cumulative
        sum of deltas IS the current value)."""
        with self._lock:
            return {
                "inflight_bundles": self._inflight_bundles,
                "inflight_rows": self._inflight_rows,
                "backlog_age_s": round(
                    self._backlog_age_locked(time.monotonic()), 6
                ),
                "applies_submitted": self.applies_submitted,
                "applies_retired": self.applies_retired,
                "applies_censored": self.applies_censored,
            }

    def latency_digests(self) -> Dict[str, dict]:
        """Cumulative per-table attribution digests, named for the
        telemetry plane (``TelemetryPublisher`` delta-encodes them; a
        ``SloSpec("apply-p99", "apply.w", 50.0, source="p99")`` reads the
        total in milliseconds via the default ``p99_scale``)."""
        with self._lock:
            return {name: h.to_dict() for name, h in self._hists.items()}

    def drain(self, timeout: float = 10.0) -> bool:
        """Block until everything in flight retired (tests, shutdown)."""
        deadline = time.monotonic() + timeout
        while time.monotonic() < deadline:
            with self._lock:
                if self._inflight_bundles == 0:
                    return True
            time.sleep(self.cfg.reap_interval_s)
        return False

    def close(self) -> None:
        """Stop the reaper and drop in-flight entries (not retired)."""
        with self._lock:
            self._closed = True
            reaper = self._reaper
            self._inflight.clear()
            self._inflight_bundles = 0
            self._inflight_rows = 0
            self._cond.notify_all()
        if reaper is not None and reaper.is_alive():
            reaper.join(timeout=2.0)
