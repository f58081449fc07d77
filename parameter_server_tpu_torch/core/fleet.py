"""FleetMonitor: scheduler-side node time series + straggler detection.

Reference analogue: ``heartbeat_info.h`` -> ``monitor.h`` -> ``dashboard.h``
[U] — worker/server heartbeats carried CPU and network usage, the scheduler
kept per-node rows and printed the fleet table.  Our Manager accepted those
``stats`` payloads and dropped them; this module is where they land.

The interesting detector is the GRAY-FAILURE one.  A slow-but-alive node heartbeats on time, so the liveness
sweep (``Manager.check_heartbeats``) never fires; what gives it away is
latency: every link INTO it runs k× slower than the fleet.  Heartbeats
auto-attach per-link deliver-latency digests
(:meth:`~parameter_server_tpu_torch.core.netmon.MeteredVan.node_digests`);
FleetMonitor merges them into a per-node INBOUND histogram and flags nodes
whose push p99 exceeds k× the fleet median — with an absolute floor so
microsecond-scale jitter inside a uniformly healthy fleet can never trip
it.  Heartbeat-GAP straggling (a node that reports, but late) is flagged
the same relative way against the fleet's median beat interval.

Wall-clock discipline: every entry point takes an explicit ``now``
(``time.monotonic()`` domain) so tests drive synthetic clocks and the
detector is deterministic under load.

Copied from the JAX package's ``core/fleet.py``, which imports no JAX: the
same rows, reasons and JSONL lines, fed by the port's
:class:`~parameter_server_tpu_torch.core.netmon.MeteredVan` digests, whose
``bytes`` is the same payload count as the JAX van's.
"""

from __future__ import annotations

import dataclasses
import json
import os
import statistics
import threading
import time
from typing import IO, Dict, List, Optional

from parameter_server_tpu_torch.utils.trace import LatencyHistogram


class RotatingJsonlWriter:
    """Size-rotated JSONL sink writing WHOLE lines only.

    Each :meth:`write_line` is one ``write()`` call of a complete
    ``...\\n``-terminated line followed by ``flush()``, and rotation happens
    BETWEEN lines (the current file is renamed to ``<path>.<n>`` and a fresh
    one opened), so no reader — and no postmortem bundle — can ever capture
    a truncated last line.  :meth:`sync` adds an fsync for the dump path.
    """

    def __init__(self, path: str, *, rotate_bytes: int = 0) -> None:
        self.path = path
        self.rotate_bytes = rotate_bytes
        self._lock = threading.Lock()
        self._rotations = 0
        self._f = open(path, "a")
        self._size = self._f.tell()

    def write_line(self, line: str) -> None:
        if not line.endswith("\n"):
            line += "\n"
        with self._lock:
            if (
                self.rotate_bytes > 0
                and self._size > 0
                and self._size + len(line) > self.rotate_bytes
            ):
                self._rotate_locked()
            self._f.write(line)
            self._f.flush()
            self._size += len(line)

    def _rotate_locked(self) -> None:
        self._f.close()
        self._rotations += 1
        os.replace(self.path, f"{self.path}.{self._rotations}")
        self._f = open(self.path, "a")
        self._size = 0

    @property
    def rotations(self) -> int:
        with self._lock:
            return self._rotations

    def sync(self) -> None:
        """Flush + fsync (the flush-on-dump guarantee for bundles)."""
        with self._lock:
            self._f.flush()
            os.fsync(self._f.fileno())

    def close(self) -> None:
        with self._lock:
            self._f.close()


@dataclasses.dataclass(frozen=True)
class StragglerPolicy:
    """Thresholds for the two detectors.  Both are RELATIVE (k× the fleet
    median) with ABSOLUTE floors: relative-only would flag one node of a
    uniformly fast fleet over microseconds of noise; absolute-only would
    need retuning per deployment."""

    #: flag when a node's stat exceeds k× the fleet median of that stat.
    k: float = 4.0
    #: inbound push p99 must also exceed this to flag (absolute floor).
    p99_floor_ms: float = 10.0
    #: heartbeat gap must also exceed this to flag (absolute floor).
    gap_floor_s: float = 1.0
    #: minimum inbound deliver samples before the latency detector speaks.
    min_latency_count: int = 4
    #: minimum heartbeats per node before the gap detector speaks.
    min_heartbeats: int = 2


class _NodeSeries:
    """Retained per-node state: beat times + latest cumulative stats."""

    __slots__ = (
        "beats", "resource", "prev_resource", "net", "prev_net", "clock",
    )

    def __init__(self, window: int) -> None:
        import collections

        self.beats: "collections.deque[float]" = collections.deque(
            maxlen=window
        )
        self.resource: dict = {}
        self.prev_resource: dict = {}
        self.net: dict = {}
        self.prev_net: dict = {}
        #: latest clock-sync estimate from Manager.sync_clock:
        #: {"offset_s": local-minus-scheduler, "rtt_s": winning RTT}.
        self.clock: dict = {}


class FleetMonitor:
    """Aggregates heartbeat stats into per-node series + straggler flags.

    Attach to the scheduler's Manager (``sched.fleet = FleetMonitor()``);
    ``Manager._on_heartbeat`` then feeds every beat's stats here.  Pass a
    ``jsonl`` stream and each :meth:`write_jsonl` call appends one fleet
    snapshot line (the ``fleet`` JSONL artifact — field meanings in the
    README Observability section).
    """

    def __init__(
        self,
        *,
        policy: Optional[StragglerPolicy] = None,
        window: int = 256,
        jsonl: Optional[IO[str]] = None,
        jsonl_path: Optional[str] = None,
        rotate_bytes: int = 0,
    ) -> None:
        """``jsonl``: an open text stream (legacy form, no rotation), or
        ``jsonl_path``: a file path managed through a
        :class:`RotatingJsonlWriter` with ``rotate_bytes`` size rotation
        (0 = never rotate).  Mutually exclusive."""
        if jsonl is not None and jsonl_path is not None:
            raise ValueError("pass jsonl OR jsonl_path, not both")
        self.policy = policy or StragglerPolicy()
        self.jsonl = jsonl
        self.jsonl_writer: Optional[RotatingJsonlWriter] = (
            RotatingJsonlWriter(jsonl_path, rotate_bytes=rotate_bytes)
            if jsonl_path is not None
            else None
        )
        self._window = window
        self._lock = threading.Lock()
        self._series: Dict[str, _NodeSeries] = {}
        #: latest CUMULATIVE per-link digest, keyed "sender->recver".
        #: Cumulative digests are REPLACED, never re-merged — merging two
        #: snapshots of the same counter would double-count every sample.
        self._links: Dict[str, dict] = {}

    # -- ingest --------------------------------------------------------------
    def observe(
        self, node_id: str, stats: dict, now: Optional[float] = None
    ) -> None:
        """Record one heartbeat's stats payload from ``node_id``."""
        now = time.monotonic() if now is None else now
        stats = stats or {}
        with self._lock:
            s = self._series.get(node_id)
            if s is None:
                s = self._series[node_id] = _NodeSeries(self._window)
            s.beats.append(now)
            if stats.get("resource"):
                s.prev_resource, s.resource = s.resource, dict(stats["resource"])
            if stats.get("net"):
                s.prev_net, s.net = s.net, dict(stats["net"])
            if stats.get("clock"):
                s.clock = dict(stats["clock"])
            for link, digest in (stats.get("links") or {}).items():
                self._links[link] = digest

    # -- clock offsets (cross-host latency attribution) ----------------------
    def clock_offset(self, node_id: str) -> Optional[float]:
        """``node_id``'s monotonic clock minus the scheduler's (seconds),
        as last reported over heartbeat; None before its first sync.  The
        scheduler itself is the reference: offset 0 by definition."""
        with self._lock:
            s = self._series.get(node_id)
            if s is not None and "offset_s" in s.clock:
                return float(s.clock["offset_s"])
        return None

    def relative_offset(self, a: str, b: str) -> Optional[float]:
        """Clock of node ``a`` minus clock of node ``b`` (seconds).

        This is the number a receiver needs to correct one-way deliver
        latencies measured from ``__mts__`` stamps
        (:class:`~parameter_server_tpu_torch.core.netmon.MeteredVan.set_clock_offset`):
        node-local monotonic clocks share no epoch across hosts, so the raw
        ``recv_local - send_remote`` difference is offset + latency until
        corrected.  None until BOTH nodes have synced (the scheduler counts
        as always synced at 0).
        """
        from parameter_server_tpu_torch.core.messages import SCHEDULER

        off_a = 0.0 if a == SCHEDULER else self.clock_offset(a)
        off_b = 0.0 if b == SCHEDULER else self.clock_offset(b)
        if off_a is None or off_b is None:
            return None
        return off_a - off_b

    def nodes(self) -> List[str]:
        with self._lock:
            return sorted(self._series)

    # -- derived stats -------------------------------------------------------
    @staticmethod
    def _inbound_hist(links: Dict[str, dict], node_id: str) -> LatencyHistogram:
        """Merged deliver-latency histogram of every link INTO a node.

        Safe to merge: each link digest appears exactly once in ``links``
        (latest snapshot), and distinct links are independent streams.
        """
        h = LatencyHistogram()
        for link, digest in links.items():
            if link.endswith(f"->{node_id}") and digest.get("deliver"):
                h.merge(LatencyHistogram.from_dict(digest["deliver"]))
        return h

    def inbound_totals(self) -> Dict[str, dict]:
        """Cumulative inbound wire load per node:
        ``{node: {bytes, msgs, verbs}}``.

        Summed over the latest per-link digests of every link INTO each
        node — the load-ranking signal the rebalancer consumes
        (``learner/elastic.py::RebalancePolicy``).  Cumulative by design:
        the policy differences successive calls to get rates, so one missed
        heartbeat cannot fake a load drop.

        ``verbs`` splits the totals per request verb
        (``{"PUSH": {"msgs", "bytes"}, ...}``, from MeteredVan's per-link
        verb counters) so the hierarchical-push reduction — and
        the Zipfian rebalance bench's before/after — can report inbound
        request COUNT, not just bytes.  Empty for digests from pre-verb
        publishers (old snapshots merge cleanly).
        """
        with self._lock:
            links = dict(self._links)
        out: Dict[str, dict] = {}
        for link, digest in links.items():
            _, _, recver = link.partition("->")
            if not recver:
                continue
            row = out.setdefault(recver, {"bytes": 0, "msgs": 0, "verbs": {}})
            row["bytes"] += int(digest.get("bytes", 0))
            row["msgs"] += int(digest.get("msgs", 0))
            for verb, vd in (digest.get("verbs") or {}).items():
                vrow = row["verbs"].setdefault(verb, {"msgs": 0, "bytes": 0})
                vrow["msgs"] += int(vd.get("msgs", 0))
                vrow["bytes"] += int(vd.get("bytes", 0))
        return out

    def snapshot(self, now: Optional[float] = None) -> Dict[str, dict]:
        """Per-node derived rows: beat cadence, rates, inbound latency."""
        now = time.monotonic() if now is None else now
        with self._lock:
            series = dict(self._series)
            links = dict(self._links)
        out: Dict[str, dict] = {}
        for node_id, s in series.items():
            beats = list(s.beats)
            row: dict = {
                "heartbeats": len(beats),
                "last_seen_s": round(now - beats[-1], 3) if beats else None,
            }
            if len(beats) >= 2:
                gaps = [b - a for a, b in zip(beats, beats[1:])]
                row["beat_interval_s"] = round(statistics.median(gaps), 3)
            res, prev = s.resource, s.prev_resource
            if res:
                if "rss_mb" in res:
                    row["rss_mb"] = round(res["rss_mb"], 1)
                dt = res.get("time", 0.0) - prev.get("time", 0.0)
                if prev and dt > 0 and "cpu_user_s" in res:
                    busy = (
                        res.get("cpu_user_s", 0.0) + res.get("cpu_sys_s", 0.0)
                        - prev.get("cpu_user_s", 0.0) - prev.get("cpu_sys_s", 0.0)
                    )
                    row["cpu_pct"] = round(100.0 * busy / dt, 1)
            net, pnet = s.net, s.prev_net
            if net and pnet and len(beats) >= 2:
                dt = beats[-1] - beats[-2]
                if dt > 0 and "wire_bytes" in net:
                    row["wire_bytes_per_s"] = round(
                        (net["wire_bytes"] - pnet.get("wire_bytes", 0)) / dt, 1
                    )
            if "offset_s" in s.clock:
                row["clock_offset_ms"] = round(1e3 * s.clock["offset_s"], 3)
                if s.clock.get("rtt_s") is not None:
                    row["clock_rtt_ms"] = round(1e3 * s.clock["rtt_s"], 3)
            h = self._inbound_hist(links, node_id)
            if h.count:
                row["push_p99_ms"] = round(1e3 * h.percentile(0.99), 3)
                row["push_p50_ms"] = round(1e3 * h.percentile(0.50), 3)
                row["inbound_count"] = h.count
            out[node_id] = row
        return out

    # -- detection -----------------------------------------------------------
    def stragglers(self, now: Optional[float] = None) -> Dict[str, List[str]]:
        """Nodes currently flagged, with human-readable reasons.

        Empty dict = healthy fleet.  Needs >= 2 reporting nodes — "k× the
        fleet median" is meaningless for a fleet of one.
        """
        now = time.monotonic() if now is None else now
        pol = self.policy
        flags: Dict[str, List[str]] = {}
        with self._lock:
            series = dict(self._series)
            links = dict(self._links)
        if len(series) < 2:
            return flags

        # gray failures: inbound push p99 vs fleet median
        p99s = {}
        for node_id in series:
            h = self._inbound_hist(links, node_id)
            if h.count >= pol.min_latency_count:
                p99s[node_id] = h.percentile(0.99)
        if len(p99s) >= 2:
            med = statistics.median(p99s.values())
            for node_id, p99 in p99s.items():
                if p99 > pol.k * med and p99 * 1e3 > pol.p99_floor_ms:
                    flags.setdefault(node_id, []).append(
                        f"inbound push p99 {p99 * 1e3:.1f}ms > "
                        f"{pol.k:g}x fleet median {med * 1e3:.1f}ms"
                    )

        # heartbeat-gap stragglers: silence vs fleet median beat interval
        intervals = {}
        for node_id, s in series.items():
            beats = list(s.beats)
            if len(beats) >= pol.min_heartbeats:
                gaps = [b - a for a, b in zip(beats, beats[1:])]
                if gaps:
                    intervals[node_id] = statistics.median(gaps)
        if len(intervals) >= 2:
            med = statistics.median(intervals.values())
            for node_id, s in series.items():
                if node_id not in intervals or not s.beats:
                    continue
                gap = now - s.beats[-1]
                if gap > pol.k * max(med, 1e-9) and gap > pol.gap_floor_s:
                    flags.setdefault(node_id, []).append(
                        f"heartbeat silent {gap:.2f}s > {pol.k:g}x fleet "
                        f"median interval {med:.2f}s"
                    )
        return flags

    # -- JSONL sink ----------------------------------------------------------
    def write_jsonl(
        self, now: Optional[float] = None, *, wall: Optional[float] = None
    ) -> Optional[dict]:
        """Append one fleet snapshot line to the attached ``jsonl`` stream.

        Returns the row (or None without a sink).  Call per monitor sweep;
        one line = one fleet-wide observation, replayable offline.
        ``wall``: the tick's shared wall-clock stamp — pass the same value
        the co-running ``Dashboard.record(now=...)`` uses so a slow dump
        cannot skew the two sinks' rate denominators apart.
        """
        if self.jsonl is None and self.jsonl_writer is None:
            return None
        now = time.monotonic() if now is None else now
        row = {
            "t": time.time() if wall is None else wall,
            "nodes": self.snapshot(now),
            "stragglers": self.stragglers(now),
        }
        line = json.dumps(row) + "\n"
        if self.jsonl_writer is not None:
            self.jsonl_writer.write_line(line)
        else:
            self.jsonl.write(line)
            self.jsonl.flush()
        return row

    def flush_jsonl(self) -> None:
        """Durably flush the JSONL sink (called by ``flightrec`` bundle
        dumps — the no-truncated-last-line guarantee)."""
        if self.jsonl_writer is not None:
            self.jsonl_writer.sync()
        elif self.jsonl is not None:
            self.jsonl.flush()
            fileno = getattr(self.jsonl, "fileno", None)
            if fileno is not None:
                try:
                    os.fsync(fileno())
                except (OSError, ValueError):
                    pass  # StringIO and friends have no real fd
