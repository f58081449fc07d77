"""WorkloadPool: data-shard assignment with dead-worker reassignment.

Reference analogue (``src/learner/workload_pool.h/.cc`` [U — reference mount
empty, public layout]): the scheduler owns a pool of workloads (file shards /
example ranges); workers ask for the next one, report completion, and a dead
worker's outstanding workloads return to the pool so surviving workers pick
them up.  Straggler handling: a workload outstanding far beyond the typical
completion time may be speculatively duplicated to an idle worker; the first
completion wins (the second is ignored).

Pure host-side logic, copied from the JAX package's ``learner/workload.py``
(which imports no JAX): the same assignment order under the same calls.
Thread-safe: called from worker loops and the Manager's failure callbacks
concurrently.
"""

from __future__ import annotations

import dataclasses
import threading
import time
from typing import Any, Dict, List, Optional


@dataclasses.dataclass
class Workload:
    """One unit of assignable work (a file shard, an example range, ...)."""

    workload_id: int
    payload: Any = None
    #: workers currently assigned (>1 only under speculative duplication).
    assigned_to: List[str] = dataclasses.field(default_factory=list)
    #: per-assignment start time, keyed by worker — durations are measured
    #: from the *winner's own* assignment so speculative duplicates never
    #: corrupt the completion-time history.
    started_at: Dict[str, float] = dataclasses.field(default_factory=dict)
    done: bool = False
    completed_by: Optional[str] = None


class WorkloadPool:
    def __init__(
        self,
        payloads: List[Any],
        *,
        straggler_factor: float = 4.0,
        min_history: int = 3,
    ) -> None:
        """``straggler_factor``: a workload outstanding longer than
        ``factor * median(done durations)`` becomes eligible for speculative
        re-assignment (needs ``min_history`` completions first)."""
        self._workloads: Dict[int, Workload] = {
            i: Workload(i, p) for i, p in enumerate(payloads)
        }
        self._pending: List[int] = list(self._workloads)
        self._durations: List[float] = []
        self.straggler_factor = straggler_factor
        self.min_history = min_history
        self._lock = threading.Lock()
        self._dead: set[str] = set()

    # -- assignment ----------------------------------------------------------
    def get(self, worker: str) -> Optional[Workload]:
        """Next workload for ``worker``; None when nothing is assignable.

        Preference order: fresh pending work, then speculative duplicates of
        straggling workloads (never duplicating onto the same worker).
        """
        with self._lock:
            if worker in self._dead:
                return None
            if self._pending:
                wid = self._pending.pop(0)
                w = self._workloads[wid]
                w.assigned_to.append(worker)
                w.started_at[worker] = time.monotonic()
                return w
            straggler = self._find_straggler_locked(worker)
            if straggler is not None:
                straggler.assigned_to.append(worker)
                straggler.started_at[worker] = time.monotonic()
                return straggler
        return None

    def _find_straggler_locked(self, worker: str) -> Optional[Workload]:
        if len(self._durations) < self.min_history:
            return None
        med = sorted(self._durations)[len(self._durations) // 2]
        cutoff = self.straggler_factor * max(med, 1e-9)
        now = time.monotonic()
        for w in self._workloads.values():
            live = [a for a in w.assigned_to if a not in self._dead]
            if (
                not w.done
                and len(live) == 1  # exactly the one straggling assignee
                and worker not in w.assigned_to
                and now - w.started_at.get(live[0], now) > cutoff
            ):
                return w
        return None

    def finish(self, worker: str, workload_id: int) -> bool:
        """Report completion.  Returns True iff this completion counted
        (False for the loser of a speculative duplicate or an unknown id)."""
        with self._lock:
            w = self._workloads.get(workload_id)
            if w is None or w.done:
                return False
            w.done = True
            w.completed_by = worker
            # A dead worker's in-flight finish may land after mark_dead
            # requeued the id — drop it from pending so get() never hands
            # out completed work.
            if workload_id in self._pending:
                self._pending.remove(workload_id)
            # duration from THIS worker's assignment; a finish from a worker
            # with no recorded start (requeue race) adds no history
            start = w.started_at.get(worker)
            if start is not None:
                self._durations.append(time.monotonic() - start)
            return True

    # -- elasticity ----------------------------------------------------------
    def mark_dead(self, worker: str) -> List[int]:
        """Return the dead worker's unfinished workloads to the pool.

        Wire this to ``Manager.on_node_dead`` — the reference's
        ``Executor::ReplaceNode`` + pool re-assignment path [U].
        """
        requeued: List[int] = []
        with self._lock:
            self._dead.add(worker)
            for w in self._workloads.values():
                if w.done or worker not in w.assigned_to:
                    continue
                w.assigned_to = [a for a in w.assigned_to if a != worker]
                if not w.assigned_to and w.workload_id not in self._pending:
                    self._pending.append(w.workload_id)
                    requeued.append(w.workload_id)
        return requeued

    def mark_alive(self, worker: str) -> None:
        with self._lock:
            self._dead.discard(worker)

    # -- progress ------------------------------------------------------------
    def all_done(self) -> bool:
        with self._lock:
            return all(w.done for w in self._workloads.values())

    def num_done(self) -> int:
        with self._lock:
            return sum(w.done for w in self._workloads.values())

    def __len__(self) -> int:
        return len(self._workloads)
