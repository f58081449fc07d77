"""ElasticTrainer: fault-tolerant PS training — the full recovery loop.

Torch counterpart of ``parameter_server_tpu/learner/elastic.py``.  Glues the
pieces of the failure-handling story into one trainer, mirroring the
reference's composition (heartbeats -> Manager REMOVE_NODE ->
``Executor::ReplaceNode`` re-slice + WorkloadPool re-assignment [U]):

- :class:`~parameter_server_tpu_torch.core.manager.Manager` heartbeat
  monitoring detects silent nodes and fires ``on_node_dead``;
- a dead **worker**'s unfinished workloads return to the
  :class:`~parameter_server_tpu_torch.learner.workload.WorkloadPool` and
  surviving workers drain them; the
  :class:`~parameter_server_tpu_torch.core.clock.ConsistencyController`
  excludes the dead worker from the SSP bound so the window never wedges;
- a dead **server** means lost shard state: :func:`recover_server` restores
  the shard from the latest committed checkpoint, which the trainer writes
  every ``ckpt_every`` completed workloads — losing updates since the
  snapshot.  For ZERO-loss recovery, chain-replicate the shard instead:
  :mod:`parameter_server_tpu_torch.kv.replica` forwards applied pushes to a
  hot standby and a :class:`~parameter_server_tpu_torch.kv.replica.ReplicaSet`
  registered on the scheduler's manager promotes it on the same
  ``on_node_dead`` signal this trainer uses;
- a crashed server process restarted IN PLACE (same node id) goes through
  :func:`restart_server` → :func:`~parameter_server_tpu_torch.kv.replica.restart_same_id`:
  shard restored from the standby (zero loss) or checkpoint (bounded
  rewind), then re-registration with the scheduler, which bumps the node's
  incarnation — workers resume against the same ``S{i}`` identity without
  promotion or trajectory rewind;
- live resizing: :func:`scale_up` / :func:`drain_down` migrate ranges onto a
  new server or off a retiring one, and :class:`RebalancePolicy` moves load
  off a hot server read from the
  :class:`~parameter_server_tpu_torch.core.fleet.FleetMonitor`.

Each worker step runs as :class:`~parameter_server_tpu_torch.learner.sgd.
AsyncLRLearner`'s does: the pulled rows and labels become tensors on
``device``, ``linear.grad_rows`` runs there and the gradient goes back to the
host for the push.  The push is ``push_sync``: only its kept-responses path
sees a routing fence, which live migration needs.  The servers' kernels run
wherever their tables live.

The trainer is Van-agnostic: fault injection in tests uses
``LoopbackVan.disconnect`` (a dead socket) + a heartbeat sweep.
"""

from __future__ import annotations

import dataclasses
import logging
import threading
import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch.config import CheckpointConfig, ConsistencyConfig
from parameter_server_tpu_torch.core.clock import ConsistencyController
from parameter_server_tpu_torch.core.manager import Manager
from parameter_server_tpu_torch.kv.consistency import BoundTuner
from parameter_server_tpu_torch.kv.worker import KVWorker
from parameter_server_tpu_torch.learner.workload import WorkloadPool
from parameter_server_tpu_torch.models import linear
from parameter_server_tpu_torch.utils.threads import run_threads

log = logging.getLogger(__name__)

#: one workload payload: list of (keys, labels) minibatches
Shard = List[Tuple[np.ndarray, np.ndarray]]


class ElasticTrainer:
    """Pool-driven sparse-LR training that survives node loss.

    Unlike :class:`~parameter_server_tpu_torch.learner.sgd.AsyncLRLearner` (fixed
    steps per worker), workers here draw *workloads* (data shards) from the
    shared pool, so work lost to a death is re-drawn by survivors — the
    reference's SGD scaffold + WorkloadPool composition [U].
    """

    def __init__(
        self,
        workers: Dict[str, KVWorker],
        scheduler: Manager,
        shards: List[Shard],
        consistency: ConsistencyConfig,
        *,
        table: str = "w",
        managers: Optional[Dict[str, Manager]] = None,
        heartbeat_interval: float = 0.5,
        ckpt_root: Optional[str] = None,
        ckpt_every: int = 0,
        ckpt_config: Optional[CheckpointConfig] = None,
        timeout: float = 60.0,
        bound_tuner: Optional[BoundTuner] = None,
        wire_bottleneck: Optional[Callable[[], bool]] = None,
        retune_interval_s: float = 1.0,
        device: str | torch.device = "cuda",
    ) -> None:
        """``device``: where each worker step's gradient is computed."""
        self.workers = workers
        self.device = torch.device(device)
        self.scheduler = scheduler
        #: per-worker Manager instances for liveness reporting; without them
        #: the scheduler's heartbeat sweep would mark every worker dead.
        self.managers = managers or {}
        self.heartbeat_interval = heartbeat_interval
        self.table = table
        self.pool = WorkloadPool(shards)
        self.controller = ConsistencyController(consistency, len(workers))
        self._index = {wid: i for i, wid in enumerate(sorted(workers))}
        self.ckpt_root = ckpt_root
        self.ckpt_every = ckpt_every
        self.ckpt_config = ckpt_config or CheckpointConfig()
        self.timeout = timeout
        self._ckpt_lock = threading.Lock()
        self._ckpt_pending = 0
        self._ckpt_running = False
        self.last_ckpt_step: Optional[int] = None
        self.losses: List[float] = []
        self._loss_lock = threading.Lock()
        self._killed: set[str] = set()
        # wire-enforced consistency plane: the trainer announces
        # workers to the servers' FleetClocks up front and (optionally)
        # closes the loop over the SSP bound
        self.bound_tuner = bound_tuner
        self._wire_bottleneck = wire_bottleneck or (lambda: False)
        self.retune_interval_s = retune_interval_s
        self._retune_lock = threading.Lock()
        self._next_retune = 0.0
        # membership -> pool/clock wiring (Executor::ReplaceNode analogue)
        scheduler.on_node_dead.append(self._on_dead)
        scheduler.on_node_added.append(self._on_added)

    def kill(self, wid: str) -> None:
        """Fault injection: make worker ``wid`` stop executing (the
        kill-a-process hook).  The caller also disconnects its Van endpoint;
        the heartbeat sweep then detects the death and requeues its work."""
        self._killed.add(wid)

    # -- elasticity callbacks (scheduler thread) -----------------------------
    def _on_dead(self, node_id: str) -> None:
        requeued = self.pool.mark_dead(node_id)
        idx = self._index.get(node_id)
        if idx is not None:
            self.controller.mark_dead(idx)
        if requeued:
            log.warning("node %s dead: requeued workloads %s", node_id, requeued)

    def _on_added(self, node_id: str) -> None:
        self.pool.mark_alive(node_id)
        idx = self._index.get(node_id)
        if idx is not None:
            self.controller.mark_alive(idx)
        # a re-added worker re-announces to the servers' FleetClocks: its
        # hello carries the van's current incarnation, so a same-id restart
        # replaces the dead incarnation's entry instead of racing it
        kv = self.workers.get(node_id)
        if kv is not None:
            self._hello_one(node_id, kv)

    # -- wire-enforced consistency -------------------------------------------
    def _gated_tables(self, kv: KVWorker) -> List[str]:
        return sorted(
            t for t, c in kv.table_cfgs.items() if c.consistency is not None
        )

    def _hello_one(self, wid: str, kv: KVWorker) -> None:
        """Best-effort ``consist_hello`` for one worker's gated tables.

        Registration keeps a slow-to-start worker from letting the rest of
        the fleet free-run past the bound before its first stamped request;
        a hello that times out (dead server mid-restart) is non-fatal — the
        worker's first stamped request registers it anyway.
        """
        for t in self._gated_tables(kv):
            try:
                kv.consist_hello(table=t, timeout=self.timeout)
            except (TimeoutError, RuntimeError) as e:
                log.warning("consist_hello(%s, %s) failed: %s", wid, t, e)

    def announce_consistency(self) -> None:
        """Register every live worker with the servers' FleetClocks."""
        for wid, kv in self.workers.items():
            if wid not in self._killed:
                self._hello_one(wid, kv)

    def _maybe_retune(self, kv: KVWorker, loss: float) -> None:
        """Feed the BoundTuner and apply its verdict fleet-wide.

        Runs on worker threads at loss-record time; the interval check and
        lock keep the tuner single-file.  A verdict is applied through any
        live worker's ``consist_set`` broadcast, which also records the
        ``consist.retune`` flight-recorder event with the tuner's reason.
        """
        tuner = self.bound_tuner
        if tuner is None:
            return
        with self._retune_lock:
            tuner.observe_loss(loss)
            now = time.monotonic()
            if now < self._next_retune:
                return
            self._next_retune = now + self.retune_interval_s
            verdict = tuner.maybe_retune(
                now, wire_bottleneck=self._wire_bottleneck()
            )
        if verdict is None:
            return
        new_bound, why = verdict
        try:
            kv.set_consistency(
                table=self.table, bound=new_bound, why=why,
                timeout=self.timeout,
            )
            log.info("retuned SSP bound -> %d (%s)", new_bound, why)
        except (TimeoutError, RuntimeError) as e:  # pragma: no cover
            log.warning("set_consistency(bound=%d) failed: %s", new_bound, e)

    # -- training ------------------------------------------------------------
    def run(self, *, poll: float = 0.02) -> List[float]:
        """Drain the pool with all workers; returns recorded losses.

        Individual worker failures (Van timeouts after a kill) are swallowed
        — the scheduler's failure detection re-queues their work; only a
        wholly-failed run (work left but no live workers) raises.
        """
        self.announce_consistency()
        hb_stop = threading.Event()
        hb_thread = None
        started_monitor = False
        if self.managers:
            hb_thread = threading.Thread(
                target=self._heartbeat_loop,
                args=(hb_stop,),
                name="elastic-heartbeat",
                daemon=True,
            )
            hb_thread.start()
            # the detection side: run the scheduler's sweep unless the
            # caller already started one (tests may drive it manually too —
            # extra sweeps are idempotent)
            if self.scheduler._monitor_thread is None:
                self.scheduler.start_monitor(
                    interval=max(self.heartbeat_interval, 0.05)
                )
                started_monitor = True
        try:
            run_threads(
                [
                    (lambda wid=wid, kv=kv: self._worker_loop(wid, kv, poll))
                    for wid, kv in self.workers.items()
                ],
                name="elastic-worker",
            )
        finally:
            hb_stop.set()
            if hb_thread is not None:
                hb_thread.join(timeout=5)
            if started_monitor:
                self.scheduler.stop_monitor()
        if not self.pool.all_done():
            raise RuntimeError(
                f"workloads incomplete: {self.pool.num_done()}/{len(self.pool)}"
            )
        return list(self.losses)

    def _heartbeat_loop(self, stop: threading.Event) -> None:
        """Background liveness reporting for every managed node.

        A dedicated thread (the reference runs heartbeats off the worker
        compute thread too [U]) so a long device step / jit compile never
        reads as a death.  Killed nodes stop heartbeating — that IS the
        death signal the scheduler sweep detects.
        """
        from parameter_server_tpu_torch.core.messages import SCHEDULER

        while not stop.wait(self.heartbeat_interval):
            for nid, mgr in self.managers.items():
                if nid == SCHEDULER or nid in self._killed:
                    continue
                # auto-stats attach resource usage + wire digests, feeding
                # the scheduler's FleetMonitor when one is installed
                mgr.send_heartbeat()

    def _worker_loop(self, wid: str, kv: KVWorker, poll: float) -> None:
        idx = self._index[wid]
        iteration = 0
        try:
            self._worker_loop_inner(wid, kv, idx, iteration, poll)
        finally:
            # Retire from the staleness bound on ANY exit (drained, died,
            # stalled): a stopped clock must not wedge survivors' SSP window.
            self.controller.mark_dead(idx)

    def _worker_loop_inner(
        self, wid: str, kv: KVWorker, idx: int, iteration: int, poll: float
    ) -> None:
        while True:
            if wid in self._killed:
                return  # the "process" is gone; no further sends, no finish
            wl = self.pool.get(wid)
            if wl is None:
                if self.pool.all_done() or not self.scheduler.is_alive(wid):
                    return
                time.sleep(poll)  # pool empty but stragglers outstanding
                continue
            try:
                for keys, labels in wl.payload:
                    if wid in self._killed:
                        return
                    if not self.controller.wait_turn(
                        idx, iteration, timeout=self.timeout
                    ):
                        raise TimeoutError(f"{wid} stalled (SSP bound)")
                    w_pos = kv.pull_sync(self.table, keys, timeout=self.timeout)
                    g, _gb, loss = linear.grad_rows(
                        torch.tensor(w_pos, device=self.device),
                        torch.tensor(labels, device=self.device),
                    )
                    # push_sync, not fire-and-forget push: only the kept-
                    # responses path can see a routing fence, so this is
                    # what lets a live migration reshard mid-training
                    # without losing or double-applying a single push
                    kv.push_sync(
                        self.table,
                        keys,
                        g.cpu().numpy() / labels.shape[0],
                        timeout=self.timeout,
                    )
                    self.controller.finish_iteration(idx)
                    iteration += 1
                    with self._loss_lock:
                        self.losses.append(float(loss))
                    self._maybe_retune(kv, float(loss))
            except (TimeoutError, RuntimeError) as e:
                # This worker is partitioned/dead from the cluster's view
                # (pull timeout, undeliverable sends, or a dead-server leg) —
                # its thread exits (the "process" dies).  Joining _killed
                # stops its heartbeats so the scheduler sweep actually
                # detects the death and requeues the workload for survivors.
                log.warning("worker %s failed (%s); exiting loop", wid, e)
                self._killed.add(wid)
                return
            if self.pool.finish(wid, wl.workload_id):
                self._maybe_checkpoint(kv)

    def _use_partitioned(self, kv: KVWorker) -> bool:
        """Pick the checkpoint plane per ``ckpt_config.mode``.

        ``auto`` decides client-side (a server's typed
        ``CheckpointLayoutError`` does not survive the wire): the
        partitioned durability plane whenever a snapshot chain already
        exists (keep extending it incrementally) or the routing layout has
        drifted from the uniform split the legacy shard-file format
        requires; the legacy format otherwise, for compatibility with
        pre-format-2 readers.
        """
        mode = self.ckpt_config.mode
        if mode != "auto":
            return mode == "partitioned"
        from parameter_server_tpu_torch import checkpoint
        from parameter_server_tpu_torch.kv.routing import TableRouting

        if checkpoint.latest_snapshot(self.ckpt_root) is not None:
            return True
        for tr in kv.routing.tables.values():
            u = TableRouting.uniform(tr.rows, kv.num_servers)
            if (tuple(tr.offsets), tuple(tr.owners)) != (
                tuple(u.offsets), tuple(u.owners)
            ):
                return True
        return False

    def _maybe_checkpoint(self, kv: KVWorker) -> None:
        if not self.ckpt_root or self.ckpt_every <= 0:
            return
        # decide under the lock; run the (blocking) save OUTSIDE it so other
        # workers finishing workloads never queue behind checkpoint IO
        with self._ckpt_lock:
            self._ckpt_pending += 1
            if self._ckpt_pending < self.ckpt_every or self._ckpt_running:
                return
            self._ckpt_pending = 0
            self._ckpt_running = True
        step = self.pool.num_done()
        if step == self.last_ckpt_step:
            with self._ckpt_lock:
                self._ckpt_running = False
            return
        from parameter_server_tpu_torch import checkpoint

        try:
            clocks = self.controller.clock.snapshot()
            if self._use_partitioned(kv):
                kv.save_snapshot(
                    self.ckpt_root,
                    step,
                    base_step=checkpoint.latest_snapshot(self.ckpt_root),
                    clocks=clocks,
                    timeout=self.timeout,
                )
                if self.ckpt_config.retention > 0:
                    checkpoint.retain_snapshots(
                        self.ckpt_root, self.ckpt_config.retention
                    )
            else:
                kv.save_model(
                    self.ckpt_root, step, clocks=clocks, timeout=self.timeout
                )
            self.last_ckpt_step = step
        except (TimeoutError, RuntimeError, OSError) as e:
            # checkpoint failure must not kill training (a dead server
            # mid-save is exactly the scenario recovery handles); an
            # aborted snapshot leaves no manifest, so the previous one
            # stays the restore point
            log.warning("checkpoint at %s failed: %s", step, e)
        finally:
            with self._ckpt_lock:
                self._ckpt_running = False


def recover_server(
    make_server: Callable[[], object],
    ckpt_root: str,
    *,
    step: Optional[int] = None,
) -> object:
    """Rebuild a lost server shard from the latest committed checkpoint.

    ``make_server`` constructs the replacement
    :class:`~parameter_server_tpu_torch.kv.server.KVServer` (fresh tables, same
    shard index, on the caller's device) bound to a live Van endpoint; its
    shard rows are then restored in place.  Returns the new server.  Raises ``FileNotFoundError``
    when no committed checkpoint exists — the caller decides whether a cold
    restart is acceptable.
    """
    from parameter_server_tpu_torch import checkpoint

    if step is None:
        step = checkpoint.latest_step(ckpt_root)
    if step is None:
        raise FileNotFoundError(f"no committed checkpoint under {ckpt_root}")
    server = make_server()
    server.restore_checkpoint(ckpt_root, step)
    return server


@dataclasses.dataclass(frozen=True)
class RebalanceConfig:
    """Trigger thresholds for monitor-driven rebalancing.

    Relative share with an absolute floor, like
    :class:`~parameter_server_tpu_torch.core.fleet.StragglerPolicy`: share-only
    would fire on an idle fleet's noise, floor-only needs per-deployment
    tuning.
    """

    #: a server is HOT when its share of the fleet's inbound bytes since the
    #: previous check exceeds this (with >= 2 owners, uniform share is 1/n).
    hot_share: float = 0.5
    #: ignore observation windows with less total inbound traffic than this.
    min_window_bytes: int = 1
    #: fraction of the hot server's largest segment to move off (the tail
    #: end — one split point, so the routing table grows by at most one
    #: segment per move).
    move_fraction: float = 0.5


class RebalancePolicy:
    """Closes the loop: FleetMonitor load ranking -> ShardMigrator moves.

    Reads :meth:`~parameter_server_tpu_torch.core.fleet.FleetMonitor.inbound_totals`
    (cumulative inbound wire bytes per node, off the heartbeat link digests),
    differences successive calls into a per-window load share, and when one
    server's share crosses ``hot_share`` — or the monitor flags it as a
    straggler — migrates the tail of its largest segment to the
    least-loaded owner.  Drive it from the training loop or a monitor sweep:
    ``routing, moved = policy.maybe_rebalance(routing)``.
    """

    def __init__(
        self,
        monitor,
        migrator,
        *,
        config: Optional[RebalanceConfig] = None,
        sched: Optional[Manager] = None,
    ) -> None:
        self.monitor = monitor
        self.migrator = migrator
        self.config = config or RebalanceConfig()
        self.sched = sched
        self._prev: Dict[str, int] = {}
        #: move log: one dict per executed migration (dashboards/tests).
        self.moves: List[dict] = []

    def inbound_window(self, routing) -> Dict[int, int]:
        """Inbound bytes per OWNING server since the previous call."""
        from parameter_server_tpu_torch.core.messages import server_id

        totals = self.monitor.inbound_totals()
        out: Dict[int, int] = {}
        for s in routing.servers():
            nid = server_id(s)
            cur = int(totals.get(nid, {}).get("bytes", 0))
            out[s] = cur - self._prev.get(nid, cur)
            self._prev[nid] = cur
        return out

    def maybe_rebalance(self, routing, *, tables: Optional[List[str]] = None):
        """One control-loop tick.  Returns ``(routing, moved)``.

        At most one hot server is acted on per tick (the loop re-evaluates
        with fresh load next tick — chasing several moves off one stale
        window overshoots).
        """
        from parameter_server_tpu_torch.core.messages import server_id

        window = self.inbound_window(routing)
        if len(window) < 2:
            return routing, False
        total = sum(max(v, 0) for v in window.values())
        flagged = set(self.monitor.stragglers())
        hot = max(window, key=lambda s: window[s])
        share = window[hot] / total if total >= self.config.min_window_bytes else 0.0
        if share < self.config.hot_share and server_id(hot) not in flagged:
            return routing, False
        cold = min(
            (s for s in window if s != hot), key=lambda s: window[s]
        )
        moved = False
        for t in tables or list(routing.tables):
            segs = routing.tables[t].owned_segments(hot)
            if not segs:
                continue
            lo, hi = max(segs, key=lambda ab: ab[1] - ab[0])
            n = hi - lo
            if n < 2:
                continue  # nothing left to split off this server
            cut = hi - max(1, int(n * self.config.move_fraction))
            routing = self.migrator.migrate(
                routing, t, cut, hi, cold, sched=self.sched
            )
            self.moves.append(
                {
                    "table": t,
                    "lo": cut,
                    "hi": hi,
                    "frm": hot,
                    "to": cold,
                    "epoch": routing.epoch,
                    "share": round(share, 4),
                }
            )
            moved = True
        return routing, moved


def scale_up(
    van,
    table_cfgs,
    routing,
    new_index: int,
    *,
    migrator,
    num_servers: Optional[int] = None,
    device_replies: bool = False,
    sched: Optional[Manager] = None,
    moves: Optional[List[tuple]] = None,
    device: str | torch.device = "cuda",
):
    """Spawn ``S{new_index}`` on ``device`` and migrate ranges onto it, live.

    The new server starts owning ZERO rows (present in the cluster, absent
    from the routing table), so workers never see it until the first
    migration commit flips the epoch — no global pause beyond each move's
    bounded freeze window.  ``moves``: explicit ``[(table, lo, hi), ...]``;
    default splits every table's largest segment in half and moves the tail.
    ``sched``: the scheduler's Manager, which broadcasts each new routing
    table (``set_routing``).  Returns ``(server, routing)``.
    """
    from parameter_server_tpu_torch.core.messages import server_id
    from parameter_server_tpu_torch.core.postoffice import Postoffice
    from parameter_server_tpu_torch.kv.server import KVServer

    num_servers = num_servers if num_servers is not None else new_index + 1
    server = KVServer(
        Postoffice(server_id(new_index), van),
        table_cfgs,
        new_index,
        num_servers,
        device_replies=device_replies,
        routing=routing,
        device=device,
    )
    if moves is None:
        moves = []
        for t, tr in routing.tables.items():
            lo, hi = max(
                (
                    seg
                    for s in routing.servers()
                    for seg in tr.owned_segments(s)
                ),
                key=lambda ab: ab[1] - ab[0],
            )
            if hi - lo >= 2:
                moves.append((t, (lo + hi) // 2, hi))
    for t, lo, hi in moves:
        routing = migrator.migrate(routing, t, lo, hi, new_index, sched=sched)
    return server, routing


def drain_down(
    van,
    routing,
    server_index: int,
    *,
    migrator,
    sched: Optional[Manager] = None,
    plan: Optional[dict] = None,
):
    """Retire live server ``S{server_index}`` with zero loss.

    Data plane first (:meth:`ShardMigrator.drain` migrates every owned range
    off, each with its own bounded freeze), THEN the endpoints are unbound —
    by the time the identity disappears the routing table references it
    nowhere, so workers never time out against it.  Returns the new routing.
    """
    from parameter_server_tpu_torch.core.messages import server_id

    routing = migrator.drain(routing, server_index, sched=sched, plan=plan)
    nid = server_id(server_index)
    for endpoint in (nid, f"{nid}.fw", f"{nid}.mig"):
        try:
            van.unbind(endpoint)
        except Exception:  # noqa: BLE001 — never-bound side endpoints
            pass
    return routing


def restart_server(
    van,
    table_cfgs,
    server_index: int,
    num_servers: int,
    *,
    num_workers: int,
    standby=None,
    ckpt_root: Optional[str] = None,
    heartbeat_timeout: float = 5.0,
    register_timeout: Optional[float] = 30.0,
    device: str | torch.device = "cuda",
    **server_kw,
):
    """Full same-id crash-restart lifecycle for server ``S{server_index}``.

    Thin composition over
    :func:`parameter_server_tpu_torch.kv.replica.restart_same_id` that also runs
    the membership half: a fresh :class:`~parameter_server_tpu_torch.core.manager.Manager`
    on the restarted node re-registers with the scheduler, which — seeing an
    existing row for the id — bumps the node's incarnation and broadcasts
    the new binding, fencing the dead process's in-flight frames fleet-wide.

    Restore preference is ``standby`` (zero loss) > ``ckpt_root`` (rewind
    bounded by the checkpoint interval) > cold; the new server is built on
    ``device``.  Returns ``(server, source, manager)``.
    """
    from parameter_server_tpu_torch.core.manager import Manager
    from parameter_server_tpu_torch.kv.replica import restart_same_id

    restarted: dict = {}

    def register(post) -> None:
        mgr = Manager(
            post,
            num_workers=num_workers,
            num_servers=num_servers,
            heartbeat_timeout=heartbeat_timeout,
        )
        restarted["manager"] = mgr
        if not mgr.register_with_scheduler(register_timeout):
            raise TimeoutError(
                f"restarted {post.node_id} never saw the table broadcast"
            )

    server, source = restart_same_id(
        van,
        table_cfgs,
        server_index,
        num_servers,
        standby=standby,
        ckpt_root=ckpt_root,
        register=register,
        device=device,
        **server_kw,
    )
    return server, source, restarted.get("manager")


@dataclasses.dataclass(frozen=True)
class AutoscaleConfig:
    """Closed-loop fleet sizing off live SLO verdicts.

    The war-game runner ticks :class:`AutoscalePolicy` on its own clock
    with the telemetry plane's current per-node health; the policy answers
    with scale/heal intents.  Thresholds are fractions of the serving
    fleet so the same config drives 8-node smokes and 200-node drills.
    """

    #: fleet size bounds the policy may steer between.
    min_servers: int = 2
    max_servers: int = 16
    #: scale up when at least this fraction of servers is breaching ...
    breach_frac_up: float = 0.25
    #: ... for this many consecutive ticks (debounce single-sweep blips).
    up_after_ticks: int = 2
    #: drain down when the WHOLE fleet has been healthy this many ticks
    #: and utilization headroom exists.
    down_after_ticks: int = 10
    #: per-server load (msgs/s) below which a healthy fleet is considered
    #: overprovisioned; 0 disables drain-down on load.
    drain_below_load: float = 0.0
    #: fraction of the current fleet one scale_up adds (at least one
    #: server) — a 50-node drill needs +10% steps, not +1 node, for added
    #: capacity to outrun the load it is chasing.
    step_frac: float = 0.1
    #: seconds between ANY two actions — migrations must settle before the
    #: controller reads their effect, or it oscillates.
    cooldown_s: float = 30.0

    def __post_init__(self) -> None:
        if self.min_servers < 1:
            raise ValueError(
                f"min_servers must be >= 1, got {self.min_servers!r}"
            )
        if self.max_servers < self.min_servers:
            raise ValueError(
                f"max_servers ({self.max_servers!r}) must be >= "
                f"min_servers ({self.min_servers!r})"
            )
        if not 0.0 < self.breach_frac_up <= 1.0:
            raise ValueError(
                f"breach_frac_up must be in (0, 1], got "
                f"{self.breach_frac_up!r}"
            )
        if self.up_after_ticks < 1 or self.down_after_ticks < 1:
            raise ValueError("*_after_ticks must be >= 1")
        if self.step_frac <= 0.0:
            raise ValueError(
                f"step_frac must be > 0, got {self.step_frac!r}"
            )
        if self.cooldown_s < 0:
            raise ValueError(
                f"cooldown_s must be >= 0, got {self.cooldown_s!r}"
            )


class AutoscalePolicy:
    """SLO-driven fleet sizing: telemetry verdicts in, scale intents out.

    Pure control logic on an EXPLICIT clock — no wall time, no threads —
    so the scenario runner can drive it deterministically in virtual time
    and production can tick it from a monitor sweep.  Each ``tick`` takes
    the current per-node view (``{node: {"healthy": bool, "load": float}}``)
    and returns zero or more intents::

        [{"kind": "scale_up", "count": 5}]           # add count servers
        [{"kind": "drain_down", "node": "S3"}]       # retire the coldest
        [{"kind": "rebalance", "node": "S1"}]        # shed the hottest

    The caller owns execution (``scale_up``/``drain_down``/
    ``RebalancePolicy`` in a live fleet, the simulated equivalents in a
    war game) and reports the fleet size back on the next tick.  Every
    decision lands in ``self.decisions`` for the scorecard.
    """

    def __init__(self, config: Optional[AutoscaleConfig] = None) -> None:
        self.config = config or AutoscaleConfig()
        self._breach_ticks = 0
        self._healthy_ticks = 0
        self._last_action_t: Optional[float] = None
        #: decision log: {"t", "kind", "node"?, "reason"} per intent.
        self.decisions: List[dict] = []

    def _emit(self, now: float, kind: str, reason: str,
              node: Optional[str] = None) -> dict:
        intent = {"t": now, "kind": kind, "reason": reason}
        if node is not None:
            intent["node"] = node
        self.decisions.append(intent)
        self._last_action_t = now
        return intent

    def tick(self, now: float, view: Dict[str, dict]) -> List[dict]:
        """One control sweep at virtual/real time ``now``.

        ``view`` maps server node id -> ``{"healthy": bool, "load":
        float}`` (load in msgs/s or any consistent per-node rate).
        Returns the intents the caller should execute, possibly empty.
        """
        cfg = self.config
        if not view:
            return []
        unhealthy = sorted(n for n, v in view.items() if not v.get("healthy", True))
        frac = len(unhealthy) / len(view)
        if unhealthy:
            self._breach_ticks += 1
            self._healthy_ticks = 0
        else:
            self._healthy_ticks += 1
            self._breach_ticks = 0
        in_cooldown = (
            self._last_action_t is not None
            and now - self._last_action_t < cfg.cooldown_s
        )
        if in_cooldown:
            return []
        intents: List[dict] = []
        if (
            frac >= cfg.breach_frac_up
            and self._breach_ticks >= cfg.up_after_ticks
        ):
            if len(view) < cfg.max_servers:
                count = min(
                    max(1, int(len(view) * cfg.step_frac)),
                    cfg.max_servers - len(view),
                )
                intent = self._emit(
                    now, "scale_up",
                    f"{len(unhealthy)}/{len(view)} breaching",
                )
                intent["count"] = count
                intents.append(intent)
            else:
                # at the ceiling: shed the hottest breaching server's load
                hottest = max(
                    unhealthy, key=lambda n: view[n].get("load", 0.0)
                )
                intents.append(self._emit(
                    now, "rebalance", "breaching at max_servers", hottest
                ))
            self._breach_ticks = 0
        elif (
            not unhealthy
            and self._healthy_ticks >= cfg.down_after_ticks
            and len(view) > cfg.min_servers
            and cfg.drain_below_load > 0.0
        ):
            loads = {n: v.get("load", 0.0) for n, v in view.items()}
            if max(loads.values()) < cfg.drain_below_load:
                coldest = min(sorted(loads), key=lambda n: loads[n])
                intents.append(self._emit(
                    now, "drain_down",
                    f"all healthy, peak load {max(loads.values()):.1f} < "
                    f"{cfg.drain_below_load:.1f}",
                    coldest,
                ))
                self._healthy_ticks = 0
        return intents
