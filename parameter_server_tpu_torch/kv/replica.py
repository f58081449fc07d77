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

Promotion rebinds a Van endpoint, which is in-process state: it covers the
``LoopbackVan``.  Not ported yet: ``restart_same_id`` (it restores from
``checkpoint.py``) and ``ReplicaSet``'s wiring into a manager's heartbeat
sweep (``core/manager.py``); :meth:`ReplicaSet.on_node_dead` is called
directly instead.
"""

from __future__ import annotations

from typing import Dict, Optional

import torch

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
) -> tuple[list[KVServer], list[KVServer]]:
    """Build ``num_servers`` primaries on ``device``, each chained to a hot
    standby.  Returns ``(primaries, standbys)``; standby ``i`` mirrors shard
    ``i``.  ``routing`` seeds one ownership map on both sides of every
    chain (a standby must hold its primary's exact shard layout)."""
    standbys = [
        KVServer(
            Postoffice(replica_id(s), van), table_cfgs, s, num_servers,
            device_replies=device_replies, routing=routing, device=device,
        )
        for s in range(num_servers)
    ]
    primaries = [
        KVServer(
            Postoffice(f"S{s}", van), table_cfgs, s, num_servers,
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


class ReplicaSet:
    """Promote standby ``i`` when ``S{i}`` is reported dead.

    ``manager``: anything with an ``on_node_dead`` callback list (the JAX
    package's heartbeat-sweeping manager); the port has no manager yet, so
    its callers invoke :meth:`on_node_dead` themselves.
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
