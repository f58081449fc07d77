"""Open-loop synthetic serving load with Zipfian key popularity.

Counterpart of ``parameter_server_tpu/serve/loadgen.py``: the same seeded
draws in the same order, so for one seed both packages offer the identical
request sequence (arrival offsets and key batches, bit for bit).

Simulates the serving plane's canonical tenant: on the order of 10^6
concurrent clients, each issuing reads at a tiny individual rate.  The
superposition of that many independent thin Poisson streams is itself a
Poisson stream at the summed rate, so the generator draws ONE aggregate
arrival process (exponential gaps at ``clients * per_client_qps``) instead
of simulating a million timers — statistically identical arrivals, none of
the bookkeeping.

Two properties make the numbers honest:

- **Open loop**: arrivals are scheduled in advance and never wait for the
  previous request — a slow server faces a growing backlog exactly as a
  real fleet of independent clients would, instead of the closed-loop
  auto-throttle that hides overload.
- **Coordinated-omission-free latency**: each request's latency is
  measured from its SCHEDULED arrival, not from when the loop got around
  to sending it, so queueing delay behind a stall lands in the histogram
  instead of vanishing.

Key popularity is Zipfian (``P(rank k) ∝ 1/k^s``) over a rank permutation
of the key space, so hot ranks scatter across servers rather than packing
into one shard's range.
"""

from __future__ import annotations

import dataclasses
import time
from typing import Callable, Optional

import numpy as np

from parameter_server_tpu_torch.serve.admission import ShedError
from parameter_server_tpu_torch.utils.trace import LatencyHistogram


@dataclasses.dataclass
class LoadReport:
    """One run's serving scorecard."""

    pulls: int
    served: int
    shed: int
    duration_s: float
    offered_qps: float
    p50_ms: float
    p99_ms: float
    hit_rate: float
    shed_rate: float
    cache_hits: int
    cache_misses: int

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)


class LoadGenerator:
    """Drive ``pull_fn(table, keys)`` with open-loop Zipfian read traffic.

    ``pull_fn``: the read entry point — ``AdmissionController.pull`` (sheds
    count) or ``KVWorker.pull_serve`` (no admission).  ``cache``: the
    worker's :class:`~parameter_server_tpu_torch.kv.cache.HotRowCache`, read
    before/after for the run's hit/miss delta; None reports zeros.

    ``clients``/``per_client_qps`` set the aggregate offered rate
    (``clients * per_client_qps``); the default models 10^6 clients at one
    read every ~100 s.  All randomness is seeded — two runs with the same
    arguments offer the identical request sequence.
    """

    def __init__(
        self,
        pull_fn: Callable,
        *,
        table: str = "w",
        num_keys: int,
        keys_per_pull: int = 8,
        clients: int = 1_000_000,
        per_client_qps: float = 1e-5,
        zipf_s: float = 1.1,
        seed: int = 0,
        cache=None,
        rate_fn: Optional[Callable[[float], float]] = None,
    ) -> None:
        if num_keys <= 0:
            raise ValueError("num_keys must be positive")
        self.pull_fn = pull_fn
        self.table = table
        self.keys_per_pull = int(keys_per_pull)
        self.qps = float(clients) * float(per_client_qps)
        if self.qps <= 0:
            raise ValueError("aggregate rate must be positive")
        self.seed = int(seed)
        self.cache = cache
        #: optional offered-load curve: a multiplier on the base
        #: rate as a function of run time, so one generator can follow a
        #: diurnal sine or a flash-crowd step instead of a flat rate.  The
        #: inhomogeneous Poisson process is realized by thinning, so the
        #: arrival stream stays seeded-deterministic for a fixed curve.
        self.rate_fn = rate_fn
        rng = np.random.default_rng(self.seed)
        # Zipf pmf over ranks 1..num_keys, inverse-CDF sampled; ranks map
        # to key ids through a seeded permutation (hot keys spread across
        # the row space, therefore across shards)
        pmf = 1.0 / np.power(np.arange(1, num_keys + 1, dtype=np.float64), zipf_s)
        pmf /= pmf.sum()
        self._cdf = np.cumsum(pmf)
        self._rank_to_key = rng.permutation(num_keys).astype(np.int64)

    def shift_hot_set(self, seed: int) -> None:
        """Re-draw the rank -> key permutation (flash crowds).

        The Zipf pmf over RANKS is unchanged; which concrete keys are hot
        changes, which is exactly what a flash crowd does to a serving
        cache — the hit-rate machinery has to re-learn the hot set.
        Seeded, so scenario replays shift to the identical new hot set.
        """
        rng = np.random.default_rng(int(seed))
        self._rank_to_key = rng.permutation(
            self._rank_to_key.size
        ).astype(np.int64)

    def _arrivals(self, rng, duration_s: float):
        """Scheduled arrival offsets + per-request key batches.

        With a ``rate_fn`` the arrivals follow the inhomogeneous Poisson
        process ``qps * rate_fn(t)`` via thinning: draw a homogeneous
        stream at the curve's peak rate, keep each arrival with
        probability ``rate_fn(t)/peak``.  Same rng, fixed draw order —
        deterministic for a fixed seed + curve.
        """
        if self.rate_fn is None:
            n = max(1, rng.poisson(self.qps * duration_s))
            sched = np.sort(rng.random(n) * duration_s)
        else:
            grid = np.linspace(0.0, duration_s, 1025)
            mult = np.array([float(self.rate_fn(t)) for t in grid])
            if np.any(mult < 0):
                raise ValueError("rate_fn must be >= 0")
            peak = float(mult.max())
            if peak <= 0:
                sched = np.zeros(1)
            else:
                n = max(1, rng.poisson(self.qps * peak * duration_s))
                cand = np.sort(rng.random(n) * duration_s)
                accept = rng.random(n) * peak <= np.array(
                    [float(self.rate_fn(t)) for t in cand]
                )
                sched = cand[accept]
                if sched.size == 0:
                    sched = cand[:1]
        n = sched.shape[0]
        u = rng.random((n, self.keys_per_pull))
        ranks = np.searchsorted(self._cdf, u, side="left")
        keys = self._rank_to_key[np.minimum(ranks, self._rank_to_key.size - 1)]
        return sched, keys

    def run(self, duration_s: float) -> LoadReport:
        """Offer ``duration_s`` worth of scheduled traffic, then report.

        Runs past ``duration_s`` if the server is slower than the offered
        rate (open loop: every scheduled request is still issued, and its
        queueing delay is measured).
        """
        rng = np.random.default_rng(self.seed + 1)
        sched, keys = self._arrivals(rng, duration_s)
        hist = LatencyHistogram()
        hits0 = misses0 = 0
        if self.cache is not None:
            hits0, misses0 = self.cache.hits, self.cache.misses
        served = 0
        shed = 0
        t0 = time.perf_counter()
        for i in range(sched.shape[0]):
            now = time.perf_counter() - t0
            if now < sched[i]:
                time.sleep(sched[i] - now)
            try:
                self.pull_fn(self.table, keys[i])
                served += 1
                # latency from the SCHEDULED arrival (includes queueing)
                hist.record((time.perf_counter() - t0) - float(sched[i]))
            except ShedError:
                shed += 1
        dur = time.perf_counter() - t0
        hits = misses = 0
        if self.cache is not None:
            hits = self.cache.hits - hits0
            misses = self.cache.misses - misses0
        n = sched.shape[0]
        looked = hits + misses
        return LoadReport(
            pulls=int(n),
            served=served,
            shed=shed,
            duration_s=round(dur, 3),
            offered_qps=round(self.qps, 3),
            p50_ms=round(1e3 * hist.percentile(0.5), 3),
            p99_ms=round(1e3 * hist.percentile(0.99), 3),
            hit_rate=round(hits / looked, 4) if looked else 0.0,
            shed_rate=round(shed / n, 4) if n else 0.0,
            cache_hits=int(hits),
            cache_misses=int(misses),
        )
