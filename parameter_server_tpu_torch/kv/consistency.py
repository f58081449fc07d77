"""Wire-enforced consistency plane: the fleet clock and the bound tuner.

Host code copied from ``parameter_server_tpu/kv/consistency.py``.

``FleetClock`` — the SERVER-side per-table vector clock of per-worker
committed steps.  Every gated request stamps the sender's committed step
(``CONSIST_STEP_KEY``); the clock folds it in and the server gates the
request against the fleet minimum: a sender more than ``bound`` steps
ahead of the slowest registered worker is deferred with a typed
``__wait__`` reply (fence-shaped, so workers without the gate retry it as a
fence — see ``kv/routing.py``).  The gate enforces the SSP contract: no
worker's step ``s`` may exceed ``fleet_min + bound``.

Liveness: the slowest registered worker always has ``s == fleet_min`` and
therefore always passes the gate, so the minimum can always advance; a
single registered worker is its own minimum and never gates; entries that
stop participating are pruned eagerly on incarnation advance (a same-id
restart) and lazily on idle timeout.  Deferred senders keep retrying, and
every retry re-observes their step, so a deferred sender never looks idle.

``BoundTuner`` — the training-loop-side closed loop over the SSP bound.  Pure
decision logic (the caller supplies the clock time and the SLO verdict):
widen the bound when workers spend their time parked on ``__wait__``
replies, tighten it when loss variance spikes.  The caller applies the
verdict fleet-wide via the ``consist_set`` control op
(``KVWorker.set_consistency``), which records ``consist.retune``.
"""

from __future__ import annotations

import math
import threading
import time
from typing import Dict, List, Optional, Tuple

from parameter_server_tpu_torch.config import ConsistencyConfig, ConsistencyMode

#: telemetry gauge encoding of the active mode (0 = ungated table).
MODE_CODES = {
    ConsistencyMode.BSP: 1,
    ConsistencyMode.SSP: 2,
    ConsistencyMode.ASP: 3,
}
MODE_NAMES = {0: "-", 1: "bsp", 2: "ssp", 3: "asp"}


class FleetClock:
    """Per-table vector clock of per-worker committed steps.

    Single-writer friendly: all mutation happens on the server's recv
    thread, but reads (counters/telemetry) come from other threads, so a
    lock guards the tiny dict ops — never any device or wire work.
    """

    def __init__(self, *, idle_timeout_s: float = 30.0) -> None:
        self._lock = threading.Lock()
        #: worker id -> [incarnation, committed step, last-seen monotonic]
        self._clock: Dict[str, List[float]] = {}
        self.idle_timeout_s = float(idle_timeout_s)
        self.pruned = 0  # cumulative entries dropped (telemetry)

    # -- membership -----------------------------------------------------
    def hello(self, worker: str, incarnation: int, step: int = 0) -> None:
        """Register (or re-register) a worker at ``step``.

        A newer incarnation replaces the old entry outright — the old
        incarnation is dead by definition and its step must not wedge
        the fleet minimum.  An equal/older incarnation only raises the
        step (hellos may race data traffic that already advanced it).
        """
        with self._lock:
            ent = self._clock.get(worker)
            now = time.monotonic()
            if ent is None or incarnation > ent[0]:
                self._clock[worker] = [incarnation, int(step), now]
            else:
                ent[1] = max(ent[1], int(step))
                ent[2] = now

    def on_incarnation_advance(self, worker: str, incarnation: int) -> None:
        """Van-observed same-id restart: drop the DEAD incarnation's entry.

        The new incarnation re-registers via ``consist_hello`` (or its
        first stamped request) at its restored step; until then it simply
        does not participate in the minimum — pruning, not resetting,
        is what keeps a crashed worker from deadlocking the fleet.
        """
        with self._lock:
            ent = self._clock.get(worker)
            if ent is not None and incarnation > ent[0]:
                del self._clock[worker]
                self.pruned += 1

    def forget(self, worker: str) -> None:
        """Planned removal (scale-down drain): drop the entry."""
        with self._lock:
            if self._clock.pop(worker, None) is not None:
                self.pruned += 1

    # -- clock advance --------------------------------------------------
    def observe(self, worker: str, step: int) -> None:
        """Fold a stamped request's step in (request seen, not applied)."""
        with self._lock:
            ent = self._clock.get(worker)
            now = time.monotonic()
            if ent is None:
                # unannounced sender (old-style bring-up): register at its
                # stamped step with incarnation 0 so any later real
                # incarnation advance still prunes it
                self._clock[worker] = [0, int(step), now]
            else:
                ent[1] = max(ent[1], int(step))
                ent[2] = now

    def commit(self, worker: str, step: int) -> None:
        """A push stamped ``step`` was APPLIED: the worker committed it,
        so its clock advances past it (``max(clock, step + 1)``)."""
        with self._lock:
            ent = self._clock.get(worker)
            now = time.monotonic()
            if ent is None:
                self._clock[worker] = [0, int(step) + 1, now]
            else:
                ent[1] = max(ent[1], int(step) + 1)
                ent[2] = now

    # -- gate -----------------------------------------------------------
    def fleet_min(self) -> int:
        with self._lock:
            if not self._clock:
                return 0
            return min(int(e[1]) for e in self._clock.values())

    def gate(
        self, worker: str, step: int, bound: Optional[int]
    ) -> Tuple[bool, int]:
        """Admission decision for a request stamped ``step``.

        Returns ``(allowed, fleet_min)``.  ``bound is None`` (ASP) always
        admits — the clock still tracked the observation.  Before
        deferring, idle entries (no traffic for ``idle_timeout_s``) are
        pruned so a vanished worker cannot wedge the fleet; deferred
        senders re-observe on every retry and thus never look idle.
        """
        self.observe(worker, step)
        if bound is None:
            return True, self.fleet_min()
        with self._lock:
            fm = min(int(e[1]) for e in self._clock.values())
            if int(step) - fm <= int(bound):
                return True, fm
            # would defer: make sure the minimum isn't held by a corpse
            now = time.monotonic()
            stale = [
                w
                for w, e in self._clock.items()
                if w != worker and now - e[2] > self.idle_timeout_s
            ]
            for w in stale:
                del self._clock[w]
                self.pruned += 1
            fm = min(int(e[1]) for e in self._clock.values())
            return int(step) - fm <= int(bound), fm

    # -- introspection --------------------------------------------------
    def snapshot(self) -> Dict[str, int]:
        """Worker -> committed step (the ``__wait__`` reply's fleet view)."""
        with self._lock:
            return {w: int(e[1]) for w, e in self._clock.items()}

    def size(self) -> int:
        with self._lock:
            return len(self._clock)


class BoundTuner:
    """Closed-loop SSP bound controller (training-loop side, pure decisions).

    Policy: WIDEN (double, capped) when the gate-wait SLO says workers
    are parked on the wire; TIGHTEN (halve, floored) when the loss-
    variance ratio of the recent window over the prior window spikes —
    staleness is hurting the statistics more than the stalls hurt the
    wall clock.  A cooldown keeps the two rules from fighting.
    """

    def __init__(
        self,
        cfg: ConsistencyConfig,
        *,
        min_bound: int = 1,
        max_bound: int = 64,
        window: int = 16,
        var_spike: float = 4.0,
        cooldown_s: float = 5.0,
    ) -> None:
        if cfg.mode != ConsistencyMode.SSP:
            raise ValueError("BoundTuner only tunes SSP bounds")
        self.bound = max(min_bound, int(cfg.max_delay))
        self.min_bound = int(min_bound)
        self.max_bound = int(max_bound)
        self.window = int(window)
        self.var_spike = float(var_spike)
        self.cooldown_s = float(cooldown_s)
        self._losses: List[float] = []
        self._last_retune: Optional[float] = None
        self.retunes = 0

    def observe_loss(self, loss: float) -> None:
        if math.isfinite(loss):
            self._losses.append(float(loss))
            if len(self._losses) > 2 * self.window:
                del self._losses[: -2 * self.window]

    def _variance_ratio(self) -> Optional[float]:
        if len(self._losses) < 2 * self.window:
            return None
        recent = self._losses[-self.window:]
        prior = self._losses[-2 * self.window: -self.window]

        def var(xs: List[float]) -> float:
            m = sum(xs) / len(xs)
            return sum((x - m) ** 2 for x in xs) / len(xs)

        vp = var(prior)
        return var(recent) / vp if vp > 0 else None

    def maybe_retune(
        self, now: float, *, wire_bottleneck: bool
    ) -> Optional[Tuple[int, str]]:
        """Returns ``(new_bound, why)`` when the bound should change.

        ``wire_bottleneck`` is the caller's SLO verdict (gate-wait p99
        breached).  Tightening wins over widening when both fire: a
        statistics regression is the costlier failure.
        """
        if (
            self._last_retune is not None
            and now - self._last_retune < self.cooldown_s
        ):
            return None
        ratio = self._variance_ratio()
        if ratio is not None and ratio > self.var_spike:
            nb = max(self.min_bound, self.bound // 2)
            if nb != self.bound:
                self.bound = nb
                self._last_retune = now
                self.retunes += 1
                return nb, f"loss variance spiked (x{ratio:.1f}): tighten"
        if wire_bottleneck:
            nb = min(self.max_bound, self.bound * 2)
            if nb != self.bound:
                self.bound = nb
                self._last_retune = now
                self.retunes += 1
                return nb, "gate-wait SLO breach: widen"
        return None
