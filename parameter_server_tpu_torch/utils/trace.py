"""Host-side tracing: spans, latency histograms, chrome-trace export, and
the device profiler hook.

The port's copy of ``parameter_server_tpu/utils/trace.py`` (stdlib only,
but for :func:`torch_profile`): the same :class:`LatencyHistogram` buckets
and digests, the same :class:`Tracer` spans and exports — a Chrome trace or
JSONL dump of the same recorded spans is laid out byte for byte as the JAX
tracer's, so ``tools/merge_traces.py`` merges both packages' dumps — and
:func:`resource_usage`, the heartbeat's ``resource`` stat.

Spans time the host.  CUDA work is asynchronous, so a span around a launch
measures its submit; the card's time for an apply is the apply ledger's
``trace.apply`` child, read from its CUDA event (``kv/ledger.py``).  The
device side of a window is :func:`torch_profile`, the counterpart of the
JAX module's ``jax_profile``.

Device time by span: :class:`TraceClock` places ``perf_counter`` seconds
on a ``torch.profiler`` trace's time axis from a CUDA runtime call
bracketed by ``perf_counter`` readings, and :meth:`Tracer.timeline` gives
the spans on that axis with the thread each ran on (the :data:`Span`
tuple's thread ident, ``pthread_self``; the trace stamps a runtime call
with that ident's low 32 bits, read as signed, without their sign).  A
profiling harness then gives each kernel, copy and memset to the span
open on its launching thread when the runtime call that launched it ran
(the trace pairs the two by correlation id).  That happens after the run,
in the harness: nothing on the hot path reads the card or its clock.

Design: recording a span is two ``perf_counter`` calls and one deque append
under a lock (~1 microsecond) so the tracer can stay on in production; the
module-level :data:`NULL_TRACER` short-circuits to nothing for hot loops
that want zero overhead: a disabled tracer's :meth:`Tracer.span` returns one
shared do-nothing context manager and reads no clock.
"""

from __future__ import annotations

import collections
import contextlib
import json
import math
import os
import threading
import time
from typing import Dict, Iterator, List, Optional, Tuple

#: one recorded span: (name, start_s, duration_s, thread_id, attrs)
Span = Tuple[str, float, float, int, Optional[dict]]
#: a span on a profiler trace's time axis: (name, start_us, end_us, thread_id)
PlacedSpan = Tuple[str, float, float, int]

#: what a disabled tracer's ``span`` returns: one shared, reusable no-op
_NO_SPAN = contextlib.nullcontext()


class LatencyHistogram:
    """O(1) mergeable log-bucketed streaming duration histogram.

    Buckets are geometric: bucket ``i`` has upper edge ``BASE * GROWTH**i``
    (bucket 0 holds everything <= 1 us); 96 buckets reach ~27 minutes at
    <= 25% relative error — the right resolution for wire and handler
    latencies.  Unlike the Tracer's bounded span deque this NEVER drops
    history: count/sum/max are exact, percentiles are bucket-resolution
    upper bounds (clamped to the observed max, so ``p99 <= max`` always).
    Two histograms merge by adding bucket counts, which is what lets
    per-link digests ride heartbeats and be re-aggregated fleet-side
    (the reference monitor merged per-node ``network_usage`` the same way).

    No internal lock: recorders (Tracer, MeteredVan) already serialize
    under their own locks, and every mutation is a single GIL-atomic
    scalar op, so a concurrent read can only skew a snapshot, never
    corrupt state.
    """

    BASE = 1e-6
    GROWTH = 1.25
    NBUCKETS = 96
    _LOG_G = math.log(GROWTH)
    #: interned bucket-key strings — ``to_dict`` runs per telemetry frame
    #: on hot paths; 96 ``str(i)`` calls per digest add up.
    _BKEYS = tuple(str(i) for i in range(NBUCKETS))

    __slots__ = ("counts", "count", "sum_s", "max_s")

    def __init__(self) -> None:
        self.counts = [0] * self.NBUCKETS
        self.count = 0
        self.sum_s = 0.0
        self.max_s = 0.0

    def _bucket(self, seconds: float) -> int:
        if seconds <= self.BASE:
            return 0
        return min(
            self.NBUCKETS - 1,
            1 + int(math.log(seconds / self.BASE) / self._LOG_G),
        )

    def record(self, seconds: float) -> None:
        seconds = max(float(seconds), 0.0)
        self.counts[self._bucket(seconds)] += 1
        self.count += 1
        self.sum_s += seconds
        if seconds > self.max_s:
            self.max_s = seconds

    def merge(self, other: "LatencyHistogram") -> "LatencyHistogram":
        """Add ``other``'s mass into this histogram (returns self)."""
        for i, c in enumerate(other.counts):
            self.counts[i] += c
        self.count += other.count
        self.sum_s += other.sum_s
        self.max_s = max(self.max_s, other.max_s)
        return self

    def merge_dict(self, d: dict) -> "LatencyHistogram":
        """Fold a ``to_dict`` digest in without materializing it — touches
        only the sparse occupied buckets, so merging a per-frame DELTA
        digest (usually one or two buckets) costs O(buckets present), not
        O(NBUCKETS).  The telemetry aggregator's per-frame cumulative fold
        is exactly that shape."""
        for i, c in (d.get("b") or {}).items():
            self.counts[int(i)] += int(c)
        self.count += int(d.get("count", 0))
        self.sum_s += float(d.get("sum_s", 0.0))
        self.max_s = max(self.max_s, float(d.get("max_s", 0.0)))
        return self

    def percentile(self, p: float) -> float:
        """Upper bound (seconds) of the bucket holding the p-quantile."""
        if self.count == 0:
            return 0.0
        target = max(1, math.ceil(p * self.count))
        cum = 0
        for i, c in enumerate(self.counts):
            cum += c
            if cum >= target:
                return min(self.BASE * self.GROWTH**i, self.max_s)
        return self.max_s  # pragma: no cover — cum == count by construction

    def stats(self) -> dict:
        """The Tracer.histogram row shape (count / mean / p50 / p99 / max)."""
        if self.count == 0:
            return {"count": 0}
        return {
            "count": self.count,
            "total_s": self.sum_s,
            "mean_us": 1e6 * self.sum_s / self.count,
            "p50_us": 1e6 * self.percentile(0.50),
            "p90_us": 1e6 * self.percentile(0.90),
            "p99_us": 1e6 * self.percentile(0.99),
            "max_us": 1e6 * self.max_s,
        }

    # -- wire form (heartbeat digests are JSON) ------------------------------
    def to_dict(self) -> dict:
        """JSON-safe digest; sparse buckets keep heartbeats small."""
        return {
            "count": self.count,
            "sum_s": self.sum_s,
            "max_s": self.max_s,
            "b": {self._BKEYS[i]: c for i, c in enumerate(self.counts) if c},
        }

    @classmethod
    def from_dict(cls, d: dict) -> "LatencyHistogram":
        h = cls()
        h.count = int(d.get("count", 0))
        h.sum_s = float(d.get("sum_s", 0.0))
        h.max_s = float(d.get("max_s", 0.0))
        for i, c in (d.get("b") or {}).items():
            h.counts[int(i)] = int(c)
        return h


class Tracer:
    """Thread-safe span recorder: bounded timeline + unbounded histograms.

    Two stores per span name, updated together under one lock:

    - a bounded deque of full spans (timelines / chrome-trace export) —
      oldest spans drop past ``capacity``;
    - a :class:`LatencyHistogram` that never drops, so
      :meth:`histogram` percentiles cover the whole run, not a silent
      recent window (they used to be computed over the deque: after 100k
      spans wrapped, "p99" quietly became "p99 of the last 100k").
    """

    def __init__(self, *, capacity: int = 100_000, enabled: bool = True) -> None:
        self.enabled = enabled
        self._spans: collections.deque[Span] = collections.deque(maxlen=capacity)
        #: never-dropping per-name latency histograms (histogram/summary/
        #: totals read these, so aggregates survive deque wraparound).
        self._hists: Dict[str, LatencyHistogram] = {}
        self._lock = threading.Lock()
        self._t0 = time.perf_counter()

    def span(self, name: str, **attrs):
        """Context manager timing its block as span ``name``; a disabled
        tracer returns one shared no-op and reads no clock."""
        if not self.enabled:
            return _NO_SPAN
        return self._span(name, attrs)

    @contextlib.contextmanager
    def _span(self, name: str, attrs: dict) -> Iterator[None]:
        start = time.perf_counter()
        try:
            yield
        finally:
            self._add(name, start, time.perf_counter() - start, attrs)

    def record(self, name: str, duration_s: float,
               start_s: Optional[float] = None, **attrs) -> None:
        """Record an externally timed span (e.g. from a callback).

        ``start_s``: the span's start as a ``time.perf_counter()`` value —
        without it the span is placed ending "now", which misorders
        retrospectively recorded phases on a timeline.
        """
        if not self.enabled:
            return
        if start_s is None:
            start_s = time.perf_counter() - duration_s
        self._add(name, start_s, duration_s, attrs)

    def _add(self, name: str, start_s: float, duration_s: float, attrs: dict) -> None:
        with self._lock:
            self._spans.append(
                (name, start_s - self._t0, duration_s, threading.get_ident(),
                 attrs or None)
            )
            h = self._hists.get(name)
            if h is None:
                h = self._hists[name] = LatencyHistogram()
            h.record(duration_s)

    def totals(self) -> Dict[str, float]:
        """Cumulative seconds per span name (O(names), never drops spans)."""
        with self._lock:
            return {name: h.sum_s for name, h in self._hists.items()}

    def spans(self, name: Optional[str] = None) -> List[Span]:
        with self._lock:
            out = list(self._spans)
        return out if name is None else [s for s in out if s[0] == name]

    def timeline(self, clock: "TraceClock") -> List[PlacedSpan]:
        """The recorded spans on a profiler trace's time axis (``clock``),
        each with the ident of the thread it ran on."""
        return [(name, clock(self._t0 + start), clock(self._t0 + start + dur), tid)
                for name, start, dur, tid, _attrs in self.spans()]

    def clear(self) -> None:
        with self._lock:
            self._spans.clear()
            self._hists.clear()

    # -- aggregation ---------------------------------------------------------
    def histogram(self, name: str) -> dict:
        """Latency stats for one span name (the Push/Pull histogram).

        Backed by the never-dropping :class:`LatencyHistogram`, so the
        percentiles cover every span ever recorded under ``name`` — not
        just the ones still in the bounded deque.
        """
        with self._lock:
            h = self._hists.get(name)
            stats = h.stats() if h is not None else {"count": 0}
        return {"name": name, **stats}

    def summary(self) -> Dict[str, dict]:
        """Histogram per distinct span name."""
        with self._lock:
            names = sorted(self._hists)
        return {name: self.histogram(name) for name in names}

    def digests(self) -> Dict[str, dict]:
        """JSON-safe per-name histogram digests (heartbeat payload form)."""
        with self._lock:
            return {name: h.to_dict() for name, h in self._hists.items()}

    # -- export --------------------------------------------------------------
    def dump_chrome_trace(self, path: str,
                          process_name: Optional[str] = None) -> None:
        """Write the spans as a chrome://tracing / Perfetto JSON timeline.

        ``process_name`` (e.g. the node id): embeds a top-level
        ``metadata`` block — the node name plus this tracer's perf_counter
        epoch — that ``tools/merge_traces.py`` uses to label the process
        and align per-node clocks on one merged timeline.
        """
        events = [
            {
                "name": name,
                "ph": "X",
                "ts": start * 1e6,
                "dur": dur * 1e6,
                "pid": os.getpid(),
                "tid": tid,
                **({"args": attrs} if attrs else {}),
            }
            for name, start, dur, tid, attrs in self.spans()
        ]
        doc: dict = {"traceEvents": events}
        if process_name is not None:
            doc["metadata"] = {"node": process_name, "clock_t0_s": self._t0}
        with open(path, "w") as f:
            json.dump(doc, f)

    def dump_jsonl(self, path: str) -> None:
        with open(path, "w") as f:
            for name, start, dur, tid, attrs in self.spans():
                f.write(
                    json.dumps(
                        {"name": name, "start_s": start, "dur_s": dur,
                         "tid": tid, "attrs": attrs}
                    )
                    + "\n"
                )


#: shared do-nothing tracer for hot paths with tracing off
NULL_TRACER = Tracer(enabled=False)


class TraceClock:
    """``time.perf_counter()`` seconds on a ``torch.profiler`` trace's time
    axis (the trace's ``ts``, microseconds), from one anchor: a pair
    (perf_counter seconds, trace microseconds) of one instant.

    :meth:`bracket` makes the anchor from a CUDA runtime call bracketed by
    two ``perf_counter`` readings and that call's event in the trace, so
    the clock the profiler stamps host events with need not be known.
    Over a traced stretch of seconds the two clocks stay within tens of
    microseconds of this line (an H100 host, torch 2.11).
    """

    def __init__(self, perf_s: float, trace_us: float) -> None:
        self.perf_s, self.trace_us = perf_s, trace_us

    @classmethod
    def bracket(cls, before_s: float, after_s: float, event: dict) -> "TraceClock":
        """The clock of one runtime call: ``perf_counter`` readings taken
        just before and just after it, and its trace event (``ts`` and
        ``dur`` in microseconds).  Midpoint to midpoint: off by at most
        half of the readings' spread less the call's length."""
        return cls((before_s + after_s) / 2, event["ts"] + event["dur"] / 2)

    def __call__(self, perf_s: float) -> float:
        return self.trace_us + (perf_s - self.perf_s) * 1e6


#: Chrome-trace categories of work that ran on the card (kernels, copies and
#: memsets, as ``torch.profiler`` exports them)
DEVICE_CATEGORIES = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})


class TorchProfile:
    """What :func:`torch_profile` captured: the exported Chrome trace's
    ``path``, the ``torch.profiler.profile`` object (``prof``), and the
    trace's device events (``device_events``: name, start and duration in
    microseconds, as the trace has them).  Filled in when the block exits."""

    def __init__(self, path: str) -> None:
        self.path = path
        self.prof = None
        self.device_events: List[dict] = []


@contextlib.contextmanager
def torch_profile(logdir: str, device="cuda") -> Iterator[TorchProfile]:
    """Device-side profile of a window: wraps ``torch.profiler``.

    The host :class:`Tracer` covers van and host latency; this captures the
    timeline of the same window on the device.  It records CPU activity,
    and CUDA activity when ``device`` is a card, and exports a Chrome trace
    into ``logdir`` (``torch_trace_<pid>.json``, loadable in Perfetto).

    On a card it never comes back quietly empty: when CUDA activity was
    asked for and the trace holds no device event, it raises
    ``RuntimeError`` — a profile without the device is not a device profile.
    Run it outside any timed block: the profiler owns the card's tracing
    session while it is on.
    """
    import torch
    from torch.profiler import ProfilerActivity, profile

    on_card = torch.device(device).type == "cuda"
    activities = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if on_card else [])
    os.makedirs(logdir, exist_ok=True)
    out = TorchProfile(os.path.join(logdir, f"torch_trace_{os.getpid()}.json"))
    with profile(activities=activities) as prof:
        yield out
        if on_card and torch.cuda.is_available():
            torch.cuda.synchronize()
    out.prof = prof
    prof.export_chrome_trace(out.path)
    with open(out.path) as f:
        events = json.load(f).get("traceEvents", [])
    out.device_events = [
        {"name": e.get("name", ""), "ts": e.get("ts", 0.0), "dur": e.get("dur", 0.0)}
        for e in events
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATEGORIES
    ]
    if on_card and not out.device_events:
        raise RuntimeError(
            f"torch_profile: CUDA activity was asked for but the trace "
            f"{out.path} holds no device event"
        )


def resource_usage() -> dict:
    """Process CPU/memory snapshot (reference ``util/resource_usage.h`` [U]).

    Reads ``/proc`` directly (Linux); suitable as heartbeat ``stats`` payload.
    """
    out: dict = {"time": time.time()}
    try:
        with open("/proc/self/stat") as f:
            stat = f.read()
        # field 2 is "(comm)" and may itself contain spaces/parens — split
        # only AFTER the last ')', then index relative to field 3 ("state")
        parts = stat[stat.rindex(")") + 2 :].split()
        tick = os.sysconf("SC_CLK_TCK")
        out["cpu_user_s"] = int(parts[11]) / tick  # utime (field 14)
        out["cpu_sys_s"] = int(parts[12]) / tick  # stime (field 15)
        out["threads"] = int(parts[17])  # num_threads (field 20)
        out["rss_mb"] = int(parts[21]) * os.sysconf("SC_PAGE_SIZE") / 2**20
    except (OSError, IndexError, ValueError):
        pass  # non-Linux: time-only heartbeat stats
    return out
