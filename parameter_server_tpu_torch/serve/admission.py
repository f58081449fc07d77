"""SLO-driven admission control for the serving plane.

Counterpart of ``parameter_server_tpu/serve/admission.py``, same policies
and events.  A serving worker that keeps pulling through an overloaded fleet
makes the overload worse AND serves its training tenants worse.  The
admission controller sits in front of
:meth:`~parameter_server_tpu_torch.kv.worker.KVWorker.pull_serve` and sheds
or defers read traffic when either overload signal fires:

- the **SLO plane** says so: ``SloEngine.healthy()`` is level-triggered
  over live telemetry (``utils/slo.py``, fed by ``core/telemetry.py``), so
  a breach of any armed spec — serving p99, apply backlog — flips the gate
  within one telemetry beat;
- the **device plane** says so: the server's ApplyLedger stamped
  ``__busy__`` onto a recent ack, which this worker remembers per server
  (:meth:`KVWorker.server_busy`) — the fast local signal that needs no
  aggregator round trip.

What "shed" means is the configured policy (:class:`~parameter_server_tpu_torch.
config.ServeConfig`):

- ``"reject"``: fail fast with :class:`ShedError` carrying an advisory
  ``retry_after_s`` — the client's backoff hint;
- ``"stale"``: answer from the cache IGNORING freshness (bounded only by
  what the cache holds); keys not fully cached still shed — degraded but
  bounded, never silently partial;
- ``"queue"``: park the read up to ``queue_deadline_s`` waiting for
  health, then serve (adding the wait to latency) or shed.

Every shed is a ``serve.shed`` flight-recorder event and a counter the
telemetry plane turns into pstop's SHED/S column.
"""

from __future__ import annotations

import time
from typing import Callable, Optional

import numpy as np

from parameter_server_tpu_torch.config import ServeConfig
from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.messages import server_id
from parameter_server_tpu_torch.kv.worker import KVWorker


class ShedError(RuntimeError):
    """A read was shed by admission control; retry after ``retry_after_s``."""

    def __init__(self, why: str, retry_after_s: float) -> None:
        super().__init__(why)
        self.retry_after_s = retry_after_s


class AdmissionController:
    """Policy gate in front of a serving worker's read path.

    ``healthy``: zero-arg callable, False = overloaded (typically
    ``lambda: eng.healthy(node)`` over the live ``SloEngine``); None = no
    SLO feed, gate on ``__busy__`` hints alone.
    """

    def __init__(
        self,
        worker: KVWorker,
        *,
        healthy: Optional[Callable[[], bool]] = None,
        cfg: Optional[ServeConfig] = None,
        node: Optional[str] = None,
    ) -> None:
        self.worker = worker
        self.healthy = healthy
        self.cfg = cfg or ServeConfig()
        self.node = node or worker.post.node_id
        #: dashboard counters (telemetry-mergeable; SHED/S in pstop)
        self.serve_shed = 0
        self.serve_stale = 0
        self.serve_queue_waits = 0

    # -- overload signal ------------------------------------------------------
    def overloaded(self, table: Optional[str] = None) -> bool:
        """True when either overload signal is live.

        ``table`` scopes the ``__busy__`` scan to that table's owners;
        None scans every server the routing table names.
        """
        if self.healthy is not None and not self.healthy():
            return True
        routing = self.worker.routing
        servers = (
            routing.tables[table].distinct_owners()
            if table is not None
            else routing.servers()
        )
        return any(
            self.worker.server_busy(server_id(s), self.cfg.busy_within_s)
            for s in servers
        )

    # -- the gated read -------------------------------------------------------
    def pull(
        self, table: str, keys: np.ndarray, timeout: Optional[float] = None
    ) -> np.ndarray:
        """Admission-controlled read: :meth:`KVWorker.pull_serve` when the
        plane is healthy, the configured shed policy when it is not."""
        if not self.overloaded(table):
            return self.worker.pull_serve(table, keys, timeout)
        policy = self.cfg.policy
        if policy == "stale":
            rows = self.worker.pull_stale(table, keys)
            if rows is not None:
                self.serve_stale += 1
                return rows
            return self._shed(table, keys, "overloaded; keys not cached")
        if policy == "queue":
            deadline = time.monotonic() + self.cfg.queue_deadline_s
            self.serve_queue_waits += 1
            while time.monotonic() < deadline:
                if not self.overloaded(table):
                    return self.worker.pull_serve(table, keys, timeout)
                time.sleep(self.cfg.queue_poll_s)
            return self._shed(table, keys, "overloaded past queue deadline")
        return self._shed(table, keys, "overloaded")

    def _shed(self, table: str, keys, why: str) -> np.ndarray:
        self.serve_shed += 1
        flightrec.record(
            "serve.shed", node=self.node, table=table,
            n=int(np.asarray(keys).size), policy=self.cfg.policy,
            why=why[:120],
        )
        raise ShedError(
            f"read of {int(np.asarray(keys).size)} keys of {table!r} shed "
            f"({self.cfg.policy}): {why}",
            self.cfg.retry_after_s,
        )

    def counters(self) -> dict:
        """Telemetry-mergeable counters (ride the worker's frame)."""
        return {
            "serve_shed": self.serve_shed,
            "serve_stale": self.serve_stale,
            "serve_queue_waits": self.serve_queue_waits,
        }
