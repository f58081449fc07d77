"""Hot-replica failover: chain replication of server key ranges.

Counterpart of ``parameter_server_tpu/kv/replica.py`` (the reference paper's
recovery of a dead server's key range from a replica chain):

- a **standby** is just another :class:`~parameter_server_tpu_torch.kv.server.
  KVServer` holding the same shard (same ``server_index`` / ``num_servers``:
  identical row range and identical init seed), bound under a replica node
  id;
- the **primary** (``KVServer(replica="R0", ...)``) forwards every applied
  push to it in apply order over the Van, so table values and optimizer
  state replay identically through the same kernels — synchronously (no
  update lost: the worker's ack waits for the chain) or asynchronously with
  bounded lag;
- on primary death, :func:`promote` rebinds the standby's endpoint under
  the primary's node id: workers keep addressing ``S{i}`` and the
  trajectory continues without a checkpoint rewind.

- :func:`restart_same_id` brings ``S{i}`` back under its own node id:
  state from a live standby, else the newest partitioned snapshot (adopting
  its routing), else the newest legacy checkpoint, else a cold seeded init.

Promotion rebinds a Van endpoint, which is in-process state: it covers the
``LoopbackVan``.  :class:`ReplicaSet` registered on the scheduler's
:class:`~parameter_server_tpu_torch.core.manager.Manager` promotes on a
missed-heartbeat death.
"""

from __future__ import annotations

import logging
from typing import Callable, Dict, Optional

import torch

from parameter_server_tpu_torch import checkpoint
from parameter_server_tpu_torch.config import TableConfig
from parameter_server_tpu_torch.core import flightrec
from parameter_server_tpu_torch.core.postoffice import Postoffice
from parameter_server_tpu_torch.core.van import Van
from parameter_server_tpu_torch.kv.routing import RoutingTable
from parameter_server_tpu_torch.kv.server import KVServer


def replica_id(server_index: int) -> str:
    return f"R{server_index}"


def make_replicated_servers(
    van: Van,
    table_cfgs: Dict[str, TableConfig],
    num_servers: int,
    *,
    sync: bool = True,
    max_lag: int = 8,
    device_replies: bool = False,
    routing: Optional[RoutingTable] = None,
    device: str | torch.device = "cuda",
    posts: Optional[Dict[str, Postoffice]] = None,
) -> tuple[list[KVServer], list[KVServer]]:
    """Build ``num_servers`` primaries on ``device``, each chained to a hot
    standby.  Returns ``(primaries, standbys)``; standby ``i`` mirrors shard
    ``i``.  ``routing`` seeds one ownership map on both sides of every
    chain (a standby must hold its primary's exact shard layout).
    ``posts``: existing Postoffices by node id (a cluster's, from
    ``launch_local_cluster``, whose Managers share them); a primary ``S{i}``
    attaches to ``posts["S{i}"]`` where given, else to a new one."""
    posts = posts or {}
    standbys = [
        KVServer(
            Postoffice(replica_id(s), van), table_cfgs, s, num_servers,
            device_replies=device_replies, routing=routing, device=device,
        )
        for s in range(num_servers)
    ]
    primaries = [
        KVServer(
            posts.get(f"S{s}") or Postoffice(f"S{s}", van), table_cfgs, s, num_servers,
            device_replies=device_replies, replica=replica_id(s),
            replica_sync=sync, max_replica_lag=max_lag, routing=routing,
            device=device,
        )
        for s in range(num_servers)
    ]
    return primaries, standbys


def promote(van: Van, standby: KVServer, primary_id: str) -> KVServer:
    """Take over a dead primary's identity with its hot standby.

    Rebinds the standby's Van endpoint under ``primary_id``, so worker
    traffic addressed to the dead server lands on the replica, whose state
    is the primary's last applied update (sync) or lag-bounded (async).
    Replies carry ``primary_id`` as sender, so the workers' in-flight
    bookkeeping keeps working.  The standby stops answering under its old
    replica id and has no replica of its own.  Returns the standby.
    """
    post = standby.post
    old_id = post.node_id
    van.unbind(primary_id)  # the dead primary's endpoint, if still bound
    # identity BEFORE endpoint: a request landing between the bind and the
    # rename would be answered under the old R{i} sender id, which the
    # workers' pull and push bookkeeping would not recognise
    post.node_id = primary_id
    van.bind(primary_id, post._on_recv)
    van.unbind(old_id)
    # a disconnected identity (a simulated dead node) comes back with the
    # promoted standby
    reconnect = getattr(van, "reconnect", None)
    if reconnect is not None:
        reconnect(primary_id)
    flightrec.record("node.promote", node=primary_id, standby=old_id)
    return standby


def restart_same_id(
    van: Van,
    table_cfgs: Dict[str, TableConfig],
    server_index: int,
    num_servers: int,
    *,
    standby: Optional[KVServer] = None,
    ckpt_root: Optional[str] = None,
    register: Optional[Callable[[Postoffice], None]] = None,
    device_replies: bool = False,
    replica_sync: bool = True,
    max_lag: int = 8,
    routing: Optional[RoutingTable] = None,
    device: str | torch.device = "cuda",
) -> tuple[KVServer, str]:
    """Bring ``S{server_index}`` back under its OWN node id after a crash.

    1. The dead process's endpoints (``S{i}``, ``S{i}.fw``, ``S{i}.mig``) are
       unbound and the identity stays disconnected while state restores: a
       retransmit landing on a cold table that the restore then overwrites
       would be an acked but lost update.
    2. A fresh :class:`KVServer` is built on ``device`` (same index: same row
       range and init seed) and restores, in order of preference, from the
       live ``standby`` (bit-identical, optimizer state included), from the
       newest partitioned snapshot in ``ckpt_root`` (adopting the manifest's
       newer routing, so a migrated shard comes back at the fleet's epoch),
       from the newest legacy checkpoint there, or cold (seeded init).  A
       corrupt snapshot falls through to the next source.
    3. On the checkpoint and cold paths the van's dedup windows into ``S{i}``
       would claim effects the rewind lost, so ``drop_inbound_state`` (where
       the van has it) clears them.
    4. The identity reconnects, and ``register`` (when given) re-registers it
       with a scheduler.

    Returns ``(server, source)``, source in {"replica", "partitioned",
    "checkpoint", "cold"}.  With a standby the new server chains to it.
    """
    primary_id = f"S{server_index}"
    endpoints = (primary_id, f"{primary_id}.fw", f"{primary_id}.mig")
    for nid in endpoints:
        van.unbind(nid)  # the dead process's endpoints, where still bound
    disconnect = getattr(van, "disconnect", None)
    if disconnect is not None:
        disconnect(primary_id)
    if routing is None and standby is not None:
        # a post-migration layout lives in the standby's routing; the new
        # server must hold the same map for the imported shard to fit
        routing = standby.routing
    server = KVServer(
        Postoffice(primary_id, van), table_cfgs, server_index, num_servers,
        device_replies=device_replies,
        replica=None if standby is None else standby.post.node_id,
        replica_sync=replica_sync, max_replica_lag=max_lag, routing=routing,
        device=device,
    )
    if standby is not None:
        server.import_shard(standby.export_shard())
        source = "replica"
    else:
        source = "cold"
        if ckpt_root is not None:
            snap = checkpoint.latest_snapshot(ckpt_root)
            if snap is not None:
                try:
                    server.restore_snapshot(ckpt_root, snap, adopt_routing=True)
                    source = "partitioned"
                except (OSError, checkpoint.CheckpointCorruptError):
                    source = "cold"
            if source == "cold":
                step = checkpoint.latest_step(ckpt_root)
                if step is not None:
                    server.restore_checkpoint(ckpt_root, step)
                    source = "checkpoint"
        if hasattr(van, "drop_inbound_state"):
            van.drop_inbound_state(primary_id)
    logging.getLogger(__name__).info("restart_same_id: %s restored from %s", primary_id, source)
    flightrec.record("node.restart", node=primary_id, source=source)
    reconnect = getattr(van, "reconnect", None)
    if reconnect is not None:
        for nid in endpoints:
            reconnect(nid)
    if register is not None:
        register(server.post)
    return server, source


class ReplicaSet:
    """Wire hot-standby promotion into the Manager's failure detection.

    The composition the reference paper describes (heartbeats -> dead
    server -> chain replica takes over the key range [U §4.3]): register
    this on the SCHEDULER's
    :class:`~parameter_server_tpu_torch.core.manager.Manager` (``manager=``)
    and a missed-heartbeat death of ``S{i}`` promotes standby ``i`` —
    workers' next pull/push to ``S{i}`` lands on the replica with the full
    state, instead of a checkpoint rewind.
    """

    def __init__(self, van: Van, standbys: list, *, manager=None) -> None:
        self.van = van
        self.standbys = list(standbys)
        self.promoted: dict[int, KVServer] = {}
        if manager is not None:
            manager.on_node_dead.append(self.on_node_dead)

    def on_node_dead(self, node_id: str) -> None:
        if not (node_id.startswith("S") and node_id[1:].isdigit()):
            return  # worker deaths are not a replica's business
        idx = int(node_id[1:])
        if idx in self.promoted or idx >= len(self.standbys):
            return
        self.promoted[idx] = promote(self.van, self.standbys[idx], node_id)
