"""KVWorker: the classic Push/Pull facade with timestamps.

Torch counterpart of the core of ``parameter_server_tpu/kv/worker.py``:
``push`` / ``pull`` return an integer timestamp, ``wait(ts)`` blocks, pulls
deliver values aligned with the request's key positions.

Pipeline per call:

1. host: ``localize_to_slots`` — dedup keys, map to unique row slots
   (deterministic ``HashLocalizer``, so every worker agrees).
2. device: ``segment_combine`` of duplicate positions (push only), read back
   to numpy for the wire — one device op and one synchronisation per push.
3. host: ``RoutingTable.slice_ids`` — one request per owning server, stamped
   with the routing epoch.
4. Van: responses complete the timestamp; pull replies are numpy and are
   reassembled on the host.

Not ported yet: worker groups and wire coalescing, routing-fence and deadline
retries, the consistency stamp, ``pull_serve`` and the hot-row cache,
snapshots, request tracing and the staleness histograms.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch.config import TableConfig
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind, server_id
from parameter_server_tpu_torch.core.postoffice import Customer, Postoffice
from parameter_server_tpu_torch.kv.routing import (
    ROUTING_EPOCH_KEY,
    VERSION_KEY,
    RoutingTable,
)
from parameter_server_tpu_torch.ops import scatter
from parameter_server_tpu_torch.utils.keys import HashLocalizer, localize_to_slots


class KVWorker(Customer):
    def __init__(
        self,
        post: Postoffice,
        table_cfgs: Dict[str, TableConfig],
        num_servers: int,
        *,
        name: str = "kv",
        localizers: Optional[Dict[str, HashLocalizer]] = None,
        min_bucket: int = 256,
        routing: Optional[RoutingTable] = None,
        device: str | torch.device = "cuda",
    ) -> None:
        """``device`` is where the push pre-combine runs."""
        super().__init__(name, post)
        self.device = torch.device(device)
        self.table_cfgs = table_cfgs
        self.num_servers = num_servers
        self.min_bucket = min_bucket
        self.routing = routing or RoutingTable.uniform(table_cfgs, num_servers)
        self.localizers = localizers or {
            t: HashLocalizer(cfg.rows) for t, cfg in table_cfgs.items()
        }
        #: per-timestamp reassembly info for pulls
        self._pull_plans: Dict[int, dict] = {}

    # -- push ---------------------------------------------------------------
    def _submit_push(
        self, table: str, slots: np.ndarray, combined
    ) -> Tuple[int, Dict[str, np.ndarray]]:
        """Wire one push of ``combined`` rows at global ids ``slots``;
        returns ``(ts, {server: positions})``.  ``combined`` is numpy, or a
        device tensor sliced per server as device views (push_device)."""
        routing = self.routing  # one consistent table per submit
        msgs, order = [], {}
        for s, pos, ids in routing.slice_ids(table, slots):
            order[server_id(s)] = pos
            if isinstance(combined, torch.Tensor):
                plane = combined[torch.from_numpy(pos).to(combined.device)]
            else:
                plane = combined[pos]
            msgs.append(
                Message(
                    task=Task(
                        TaskKind.PUSH,
                        self.name,
                        payload={"table": table, ROUTING_EPOCH_KEY: routing.epoch},
                    ),
                    recver=server_id(s),
                    keys=ids.astype(np.int32),
                    values=[plane],
                )
            )
        return self.submit(msgs), order

    def _prepare_push(self, table: str, keys, values):
        """Host half of a push: localize, then the duplicate pre-combine on
        ``device``, read back to numpy."""
        cfg = self.table_cfgs[table]
        vals = np.asarray(values, dtype=cfg.dtype).reshape(keys.size, cfg.dim)
        slots, inverse, _n = localize_to_slots(
            keys, self.localizers[table], min_bucket=self.min_bucket
        )
        combined = scatter.segment_combine(
            torch.tensor(vals, device=self.device),
            torch.tensor(inverse, device=self.device),
            slots.shape[0],
        )
        return slots, combined.cpu().numpy()

    def push(self, table: str, keys: np.ndarray, values: np.ndarray) -> int:
        """Push per-position gradient rows for ``keys``; returns a timestamp.

        ``values`` has shape ``[len(keys), dim]`` (or ``[len(keys)]`` for
        dim=1 tables).  Fire-and-forget: ``wait(ts)`` blocks for the acks.
        """
        slots, combined = self._prepare_push(table, keys, values)
        ts, _ = self._submit_push(table, slots, combined)
        return ts

    def push_device(self, table: str, keys: np.ndarray, values: torch.Tensor) -> int:
        """Device-resident push: the gradient rows are combined on the device
        and sliced per server as device tensors, which reach in-process
        (Loopback) servers without a host round trip."""
        cfg = self.table_cfgs[table]
        vals = values.reshape(keys.size, cfg.dim)
        slots, inverse, _n = localize_to_slots(
            keys, self.localizers[table], min_bucket=self.min_bucket
        )
        combined = scatter.segment_combine(
            vals, torch.tensor(inverse, device=vals.device), slots.shape[0]
        )
        ts, _ = self._submit_push(table, slots, combined)
        return ts

    # -- pull ---------------------------------------------------------------
    def pull(self, table: str, keys: np.ndarray) -> int:
        """Request weights for ``keys``; fetch with :meth:`pull_result`."""
        slots, inverse, _n = localize_to_slots(
            keys, self.localizers[table], min_bucket=self.min_bucket
        )
        return self._submit_pull(table, slots, inverse, keys.shape)

    def _submit_pull(self, table, slots, inverse, shape) -> int:
        routing = self.routing
        msgs, order = [], {}
        for s, pos, ids in routing.slice_ids(table, slots):
            order[server_id(s)] = pos
            msgs.append(
                Message(
                    # fresh dict per leg: a Loopback reply path may alias it
                    task=Task(
                        TaskKind.PULL,
                        self.name,
                        payload={"table": table, ROUTING_EPOCH_KEY: routing.epoch},
                    ),
                    recver=server_id(s),
                    keys=ids.astype(np.int32),
                )
            )
        ts = self.submit(msgs, keep_responses=True)
        self._pull_plans[ts] = {
            "order": order,
            "inverse": inverse,
            "n_slots": slots.shape[0],
            "shape": shape,
            "table": table,
        }
        return ts

    def _pull_pairs(self, ts: int, timeout: Optional[float]) -> tuple:
        """Wait for pull ``ts``; ``(plan, [(positions, rows, sver, sender)])``.
        Any error leg (a fence included) or a missing leg raises: a dropped
        leg must not read as zero weights."""
        completed = self.wait(ts, timeout)
        plan = self._pull_plans.pop(ts)
        errs = self.errors(ts)
        responses = self.take_responses(ts)
        if not completed:
            self.cancel(ts, "pull deadline")
            raise TimeoutError(f"pull ts={ts} timed out")
        if errs:
            raise RuntimeError(f"pull ts={ts} failed on: " + "; ".join(errs))
        if len(responses) < len(plan["order"]):
            raise RuntimeError(
                f"pull ts={ts} incomplete: {len(responses)}/"
                f"{len(plan['order'])} servers answered"
            )
        pairs = [
            (
                plan["order"][r.sender],
                r.values[0],
                r.task.payload.get(VERSION_KEY),
                r.sender,
            )
            for r in responses
        ]
        return plan, pairs

    @staticmethod
    def _sole_full_pair(pairs: list, n_slots: int):
        """The single reply covering every slot in identity order, or None."""
        if len(pairs) != 1:
            return None
        pos, rows = np.asarray(pairs[0][0]), pairs[0][1]
        if pos.size == n_slots and np.array_equal(pos, np.arange(n_slots)):
            return rows
        return None

    def pull_result(self, ts: int, timeout: Optional[float] = None) -> np.ndarray:
        """Block for pull ``ts`` and reassemble per-position weight rows:
        ``keys.shape + (dim,)``, or ``keys.shape`` for dim=1 tables."""
        plan, pairs = self._pull_pairs(ts, timeout)
        cfg = self.table_cfgs[plan["table"]]
        sole = self._sole_full_pair(pairs, plan["n_slots"])
        if sole is not None:
            uniq_rows = np.asarray(sole, dtype=cfg.dtype).reshape(-1, cfg.dim)
        else:
            uniq_rows = np.zeros((plan["n_slots"], cfg.dim), dtype=cfg.dtype)
            for pos, rows, *_meta in pairs:
                uniq_rows[pos] = np.asarray(rows).reshape(-1, cfg.dim)
        out = uniq_rows[plan["inverse"]]
        if cfg.dim == 1:
            return out.reshape(plan["shape"])
        return out.reshape(plan["shape"] + (cfg.dim,))

    def pull_sync(
        self, table: str, keys: np.ndarray, timeout: Optional[float] = None
    ) -> np.ndarray:
        return self.pull_result(self.pull(table, keys), timeout)
