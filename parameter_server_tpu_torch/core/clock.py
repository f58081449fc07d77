"""Consistency controller: the BSP/SSP/ASP spectrum as vector clocks.

The reference encodes consistency as dependency edges in the Executor's task
DAG (``Task.time``/``wait_time``; ``src/system/executor.h`` [U]): BSP depends
on all prior iterations, SSP on iteration ``t - max_delay``, ASP on nothing.
XLA execution is synchronous SPMD, so asynchrony lives on the host: this
controller holds the vector of per-worker clocks and gates *dispatch* of
already-compiled device steps (SURVEY.md §7 design stance).

Semantics (matching SSP literature and the reference's bounded delay):
a worker may *start* iteration ``t`` only when every worker has *completed*
iteration ``t - 1 - bound`` — i.e. the fastest worker leads the slowest by at
most ``bound`` iterations.  ``bound=0`` is BSP lockstep; ``bound=None`` is ASP.
"""

from __future__ import annotations

import threading
from typing import Optional

from parameter_server_tpu_torch.config import ConsistencyConfig


class VectorClock:
    """Thread-safe per-worker completed-iteration counters."""

    def __init__(self, num_workers: int) -> None:
        self._clocks = [0] * num_workers
        self._cond = threading.Condition()

    def __getitem__(self, w: int) -> int:
        with self._cond:
            return self._clocks[w]

    def min(self) -> int:
        with self._cond:
            return min(self._clocks)

    def snapshot(self) -> list[int]:
        with self._cond:
            return list(self._clocks)

    def advance(self, w: int) -> int:
        """Mark one more completed iteration for worker ``w``."""
        with self._cond:
            self._clocks[w] += 1
            self._cond.notify_all()
            return self._clocks[w]

    def wait_until_min(self, t: int, timeout: Optional[float] = None) -> bool:
        """Block until ``min(clocks) >= t``.  Returns False on timeout."""
        with self._cond:
            return self._cond.wait_for(lambda: min(self._clocks) >= t, timeout)


class ConsistencyController:
    """Gate worker iteration dispatch per the configured consistency mode.

    Replaces the reference Executor's dependency check loop: instead of
    parking messages, the host thread parks *before dispatching* the next
    jit-compiled step, which keeps the device queue free of stale work.
    """

    def __init__(self, cfg: ConsistencyConfig, num_workers: int) -> None:
        self.cfg = cfg
        self.clock = VectorClock(num_workers)
        self._dead: set[int] = set()
        self._dead_lock = threading.Lock()

    def wait_turn(self, worker: int, t: int, timeout: Optional[float] = None) -> bool:
        """Block until worker ``worker`` may start iteration ``t``.

        Returns False if the bound could not be satisfied within ``timeout``
        (callers treat that as a straggler signal, not an error).
        """
        bound = self.cfg.bound
        if bound is None:  # ASP
            return True
        need = t - bound  # all workers must have completed >= t - bound
        if need <= 0:
            return True
        return self._wait_min_alive(need, timeout)

    def _wait_min_alive(self, t: int, timeout: Optional[float]) -> bool:
        # Dead workers are excluded from the bound (elasticity: a lost worker
        # must not stall SSP forever; its shard is reassigned by the
        # WorkloadPool — reference Executor::ReplaceNode behavior [U]).
        cond = self.clock._cond
        with cond:
            return cond.wait_for(
                lambda: min(self._alive_clocks()) >= t, timeout
            )

    def _alive_clocks(self) -> list[int]:
        clocks = self.clock._clocks
        with self._dead_lock:
            alive = [c for w, c in enumerate(clocks) if w not in self._dead]
        return alive or [2**62]  # all workers dead: nothing to wait for

    def finish_iteration(self, worker: int) -> int:
        return self.clock.advance(worker)

    def mark_dead(self, worker: int) -> None:
        with self._dead_lock:
            self._dead.add(worker)
        with self.clock._cond:
            self.clock._cond.notify_all()

    def mark_alive(self, worker: int) -> None:
        with self._dead_lock:
            self._dead.discard(worker)

    # -- reference API parity: Task.wait_time computation ------------------
    def wait_time_for(self, t: int) -> int:
        """The ``Task.wait_time`` dependency the reference would emit."""
        bound = self.cfg.bound
        if bound is None:
            return -1
        return t - 1 - bound
