"""Host-side latency histograms and the process resource snapshot.

The port's copies of ``LatencyHistogram`` and ``resource_usage`` from
``parameter_server_tpu/utils/trace.py`` (stdlib only): the same buckets,
percentiles and ``to_dict`` digest, so the apply ledger's digests
(``kv/ledger.py``) read the same in both packages and merge with the JAX
package's; ``resource_usage`` is the heartbeat's ``resource`` stat.  The
span ``Tracer`` and the device-profiler hook are not ported yet.
"""

from __future__ import annotations

import math
import os
import time


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
