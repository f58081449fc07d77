"""Dense-tensor KV store: whole-model chunks across servers (KVLayer/KVStore).

Torch counterpart of ``parameter_server_tpu/kv/dense.py``.  A model's
parameter tree is flattened to one contiguous float32 vector
(:class:`PytreeCodec`, element for element the JAX package's
``ravel_pytree``); servers own contiguous element ranges of it
(:func:`segment_offsets`, the same rule as the sparse tables' key ranges),
stored on ``device`` as ``[n, 1]`` value and optimizer-state planes; workers
push gradients and pull weights for the whole vector or for per-segment
slices through the Van with the usual timestamp API.  The wire carries numpy
float32, as the JAX package's does.

A server applies a segment push to just that element range of its planes,
in place.  The checkpoint control ops (``save_model`` / ``load_model``) write
and read the legacy uniform shard files of ``checkpoint.py``, element ranges
as ``[n, 1]`` planes exactly as the JAX package writes them, so a restore may
reshard onto another server count; every other control op is refused.
"""

from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch import checkpoint
from parameter_server_tpu_torch.config import OptimizerConfig
from parameter_server_tpu_torch.core.messages import Message, Task, TaskKind, server_id
from parameter_server_tpu_torch.core.postoffice import Customer, Postoffice
from parameter_server_tpu_torch.kv.optim import ServerOptimizer, make_optimizer
from parameter_server_tpu_torch.kv.partition import RangePartition
from parameter_server_tpu_torch.models.layers import flat_items


def segment_offsets(total: int, num_servers: int) -> np.ndarray:
    """num_servers+1 element offsets; server s owns [off[s], off[s+1]).

    Delegates to :class:`RangePartition` so every layer (sparse tables, dense
    segments) splits by the identical rule.
    """
    return RangePartition(total, num_servers).offsets


def fixed_segments(total: int, chunk_elems: int) -> List[Tuple[int, int]]:
    """Equal-size element segments [(start, end), ...] covering ``total``:
    every segment except the tail is exactly ``chunk_elems`` long."""
    if chunk_elems <= 0:
        raise ValueError(f"chunk_elems must be positive, got {chunk_elems}")
    return [
        (a, min(a + chunk_elems, total)) for a in range(0, total, chunk_elems)
    ]


def layer_segments(example_tree, max_elems: int = 1 << 22) -> List[Tuple[int, int]]:
    """Per-layer segments over the flattened tree (the KVLayer scheme).

    Leaves coalesce greedily into segments up to ``max_elems``; an oversize
    leaf splits into ``max_elems`` chunks.  Boundaries follow the leaf order
    :class:`PytreeCodec` flattens with, so segment [a, b) is vector[a:b].
    """
    sizes = [int(np.prod(tuple(leaf.shape))) for _, leaf in flat_items(example_tree)]
    segs: List[Tuple[int, int]] = []
    start = 0
    acc = 0
    pos = 0
    for sz in sizes:
        if acc and acc + sz > max_elems:
            segs.append((start, pos))
            start, acc = pos, 0
        if sz > max_elems:  # split the giant leaf on its own
            if acc:
                segs.append((start, pos))
            for a in range(pos, pos + sz, max_elems):
                segs.append((a, min(a + max_elems, pos + sz)))
            start, acc = pos + sz, 0
        else:
            acc += sz
        pos += sz
    if acc:
        segs.append((start, pos))
    return segs


def _host_array(values) -> np.ndarray:
    """A float32 numpy vector of a tensor (copied to the host once) or array."""
    if isinstance(values, torch.Tensor):
        return values.detach().reshape(-1).to("cpu", torch.float32).numpy()
    return np.asarray(values, np.float32).reshape(-1)


def _device_rows(values: np.ndarray, device: torch.device) -> torch.Tensor:
    """A received float32 vector as ``[n, 1]`` rows on ``device``."""
    host = np.require(values, np.float32, ["C", "W"])  # copies only a read-only view
    return torch.from_numpy(host).reshape(-1, 1).to(device)


def _apply(opt: ServerOptimizer, value: torch.Tensor, state: Dict[str, torch.Tensor],
           grad: torch.Tensor) -> None:
    """The optimizer step on ``value`` / ``state`` rows (views), in place."""
    new_v, new_s = opt.apply(value, state, grad)
    value.copy_(new_v)
    for k in state:
        state[k].copy_(new_s[k])


def _slice(seg: dict, off: int, length: int):
    """Views of rows [off, off + length) of a segment's planes."""
    if off < 0 or off + length > seg["value"].shape[0]:
        raise ValueError(f"rows [{off}, {off + length}) outside the server's "
                         f"{seg['value'].shape[0]}")
    return (seg["value"][off:off + length],
            {k: v[off:off + length] for k, v in seg["state"].items()})


class DenseKVServer(Customer):
    """Owns one contiguous segment of each registered dense parameter vector."""

    def __init__(
        self,
        post: Postoffice,
        specs: Dict[str, Tuple[int, OptimizerConfig]],
        server_index: int,
        num_servers: int,
        *,
        name: str = "dense",
        init_vectors: Optional[Dict[str, np.ndarray]] = None,
        device: str | torch.device = "cuda",
    ) -> None:
        """``specs``: table name -> (total_elements, optimizer config)."""
        super().__init__(name, post)
        self.server_index = server_index
        self.num_servers = num_servers
        self.device = torch.device(device)
        self.offsets: Dict[str, np.ndarray] = {}
        self.segments: Dict[str, dict] = {}
        for t, (total, opt_cfg) in specs.items():
            off = segment_offsets(total, num_servers)
            self.offsets[t] = off
            lo, hi = int(off[server_index]), int(off[server_index + 1])
            opt = make_optimizer(opt_cfg)
            if init_vectors and t in init_vectors:
                value = _device_rows(_host_array(init_vectors[t])[lo:hi], self.device)
            else:
                value = torch.zeros((hi - lo, 1), dtype=torch.float32, device=self.device)
            self.segments[t] = {
                "opt": opt,
                "value": value,
                "state": {
                    k: torch.full((hi - lo, 1), fill, dtype=torch.float32, device=self.device)
                    for k, fill in opt.state_shapes().items()
                },
            }

    def handle_request(self, msg: Message) -> Message:
        if msg.task.kind == TaskKind.CONTROL:
            return self._handle_control(msg)
        table = msg.task.payload["table"]
        seg = self.segments[table]
        offset = msg.task.payload.get("offset")  # segment traffic when set
        local = 0 if offset is None else offset - int(self.offsets[table][self.server_index])
        if msg.task.kind == TaskKind.PUSH:
            grad = _device_rows(msg.values[0], self.device)
            if offset is None and grad.shape[0] != seg["value"].shape[0]:
                raise ValueError(f"push of {grad.shape[0]} elements to a segment of "
                                 f"{seg['value'].shape[0]}")
            _apply(seg["opt"], *_slice(seg, local, grad.shape[0]), grad)
            return msg.reply()
        if msg.task.kind == TaskKind.PULL:
            length = (seg["value"].shape[0] if offset is None
                      else int(msg.task.payload["length"]))
            w = seg["opt"].pull_weights(*_slice(seg, local, length))
            # a copy: the reply must not alias the planes later pushes update
            return msg.reply(values=[w.to("cpu", copy=True).numpy().ravel()])
        raise ValueError(f"unsupported task kind {msg.task.kind}")

    # -- checkpoint (the dense counterpart of KVServer's save_model) ---------
    def _handle_control(self, msg: Message) -> Message:
        op = msg.task.payload.get("op")
        if op == "save_model":
            self.save_checkpoint(msg.task.payload["root"], msg.task.payload["step"])
            return msg.reply()
        if op == "load_model":
            self.restore_checkpoint(msg.task.payload["root"], msg.task.payload["step"])
            return msg.reply()
        raise ValueError(f"unsupported control op {op!r}")

    def save_checkpoint(self, root: str, step: int) -> None:
        """Write this server's element range of every dense vector (value and
        state planes, copied to the host once)."""
        for t, seg in self.segments.items():
            checkpoint.save_arrays_shard(
                root, step, t, self.server_index, self.num_servers,
                int(self.offsets[t][self.server_index]),
                seg["value"].to("cpu").numpy(),
                {k: v.to("cpu").numpy() for k, v in seg["state"].items()},
            )

    def restore_checkpoint(self, root: str, step: int) -> None:
        """Load this server's element range; the saved server count may
        differ (the files overlapping the range are read and sliced)."""
        for t, seg in self.segments.items():
            arrays = checkpoint.load_arrays_shard(root, step, t, self.server_index,
                                                  self.num_servers)
            n = seg["value"].shape[0]
            if arrays["value"].shape != (n, 1):
                raise ValueError(f"dense {t!r}: saved range {arrays['value'].shape}, "
                                 f"server holds {(n, 1)}")
            seg["value"] = _device_rows(arrays["value"], self.device)
            seg["state"] = {k: _device_rows(arrays[f"state.{k}"], self.device)
                            for k in seg["state"]}


class DenseKVWorker(Customer):
    """Push/pull whole flattened parameter vectors with timestamps.

    Pushes take a gradient vector as a tensor (copied to the host once) or a
    numpy array; pulls assemble the servers' replies into a float32 tensor on
    ``device``.
    """

    def __init__(
        self,
        post: Postoffice,
        specs: Dict[str, int],
        num_servers: int,
        *,
        name: str = "dense",
        device: str | torch.device = "cuda",
    ) -> None:
        """``specs``: table name -> total_elements."""
        super().__init__(name, post)
        self.device = torch.device(device)
        self.offsets = {
            t: segment_offsets(total, num_servers) for t, total in specs.items()
        }
        self.num_servers = num_servers
        self._pull_meta: Dict[int, str] = {}
        self._seg_pull_meta: Dict[int, dict] = {}
        #: raw byte counters for the dashboard's bytes/step accounting: every
        #: push, and the segment pulls (as in the JAX package)
        self.bytes_pushed = 0
        self.bytes_pulled = 0

    def push(self, table: str, grad_vector) -> int:
        grad = _host_array(grad_vector)
        off = self.offsets[table]
        msgs = [
            Message(
                task=Task(TaskKind.PUSH, self.name, payload={"table": table}),
                recver=server_id(s),
                values=[grad[off[s]: off[s + 1]]],
            )
            for s in range(self.num_servers)
        ]
        self.bytes_pushed += int(grad.nbytes)
        return self.submit(msgs)

    # -- per-segment (KVLayer chunk) traffic ---------------------------------
    def push_segment(self, table: str, start: int, grad_slice, callback=None) -> int:
        """Push the gradient for elements [start, start+len).  Returns ts.

        One timestamp per segment, so a caller can stream segments while
        earlier ones are in flight; ``callback`` fires on the ack.
        """
        grad_slice = _host_array(grad_slice)
        off = self.offsets[table]
        end = start + grad_slice.shape[0]
        msgs = []
        for s in range(self.num_servers):
            a, b = max(start, int(off[s])), min(end, int(off[s + 1]))
            if a >= b:
                continue
            msgs.append(
                Message(
                    task=Task(TaskKind.PUSH, self.name,
                              payload={"table": table, "offset": a}),
                    recver=server_id(s),
                    values=[grad_slice[a - start: b - start]],
                )
            )
        self.bytes_pushed += int(grad_slice.nbytes)
        return self.submit(msgs, callback)

    def pull_segment(self, table: str, start: int, length: int) -> int:
        """Request weights for elements [start, start+length)."""
        off = self.offsets[table]
        end = start + length
        msgs = []
        order = {}
        for s in range(self.num_servers):
            a, b = max(start, int(off[s])), min(end, int(off[s + 1]))
            if a >= b:
                continue
            order[server_id(s)] = (a - start, b - start)
            msgs.append(
                Message(
                    task=Task(TaskKind.PULL, self.name,
                              payload={"table": table, "offset": a, "length": b - a}),
                    recver=server_id(s),
                )
            )
        ts = self.submit(msgs, keep_responses=True)
        self._seg_pull_meta[ts] = {"order": order, "length": length}
        return ts

    def _collect(self, ts: int, timeout: Optional[float], what: str, want: int):
        completed = self.wait(ts, timeout)
        errs = self.errors(ts)
        responses = self.take_responses(ts)  # always drain kept state
        if not completed:
            raise TimeoutError(f"{what} ts={ts} timed out")
        if errs:  # a dropped leg must not read as zero parameters
            raise RuntimeError(f"{what} ts={ts} failed on: " + "; ".join(errs))
        if len(responses) < want:
            raise RuntimeError(
                f"{what} ts={ts} incomplete: {len(responses)}/{want} servers "
                "answered (dead server?)"
            )
        return responses

    def _assemble(self, length: int, parts) -> torch.Tensor:
        out = torch.empty(length, dtype=torch.float32, device=self.device)
        for (a, b), values in parts:
            out[a:b].copy_(torch.from_numpy(np.require(values, np.float32, ["C", "W"])))
        return out

    def pull_segment_result(self, ts: int, timeout: Optional[float] = None) -> torch.Tensor:
        plan = self._seg_pull_meta.pop(ts)  # always reclaim
        responses = self._collect(ts, timeout, "segment pull", len(plan["order"]))
        out = self._assemble(plan["length"],
                             [(plan["order"][r.sender], r.values[0]) for r in responses])
        self.bytes_pulled += int(out.nbytes)
        return out

    def pull(self, table: str) -> int:
        msgs = [
            Message(
                task=Task(TaskKind.PULL, self.name, payload={"table": table}),
                recver=server_id(s),
            )
            for s in range(self.num_servers)
        ]
        ts = self.submit(msgs, keep_responses=True)
        self._pull_meta[ts] = table
        return ts

    def pull_result(self, ts: int, timeout: Optional[float] = None) -> torch.Tensor:
        table = self._pull_meta.pop(ts)  # always reclaim
        responses = self._collect(ts, timeout, "dense pull", self.num_servers)
        off = self.offsets[table]
        parts = []
        for r in responses:
            s = int(r.sender[1:])
            parts.append(((int(off[s]), int(off[s + 1])), r.values[0]))
        return self._assemble(int(off[-1]), parts)

    def pull_sync(self, table: str, timeout: Optional[float] = None) -> torch.Tensor:
        return self.pull_result(self.pull(table), timeout)

    # -- checkpoint broadcast (as KVWorker.save_model / load_model) ----------
    def save_model(
        self,
        root: str,
        step: int,
        *,
        clocks: Optional[List[int]] = None,
        extras: Optional[dict] = None,
        timeout: Optional[float] = 600.0,
    ) -> None:
        """Every server writes its element ranges; then the manifest is
        committed.  Use a root apart from any sparse-table checkpoint's (one
        manifest lists one worker's tables)."""
        self._control_round("save_model", {"root": root, "step": step}, timeout)
        checkpoint.finalize(
            root, step, self.num_servers,
            {t: int(off[-1]) for t, off in self.offsets.items()},
            clocks=clocks, extras=extras,
        )

    def load_model(self, root: str, step: int, *, timeout: Optional[float] = 600.0) -> None:
        """Every server restores its element ranges (any saved server count)."""
        self._control_round("load_model", {"root": root, "step": step}, timeout)

    def _broadcast_control(self, op: str, payload: dict) -> int:
        return self.submit(
            [Message(task=Task(TaskKind.CONTROL, self.name, payload={"op": op, **payload}),
                     recver=server_id(s))
             for s in range(self.num_servers)],
            keep_responses=True,
        )

    def _control_round(self, op: str, payload: dict, timeout: Optional[float]) -> None:
        ts = self._broadcast_control(op, payload)
        if not self.wait(ts, timeout):
            raise TimeoutError(f"dense {op} timed out")
        self.check(ts)
        self.take_responses(ts)


class PytreeCodec:
    """Flatten / unflatten a parameter tree to the store's flat vector.

    A tree is a nested dict of tensors or arrays keyed by flax path (see
    ``models/layers.py::params_tree``).  The vector holds the leaves in
    ``jax.tree`` order (dict keys sorted at every level), each in its own
    layout, so it equals ``ravel_pytree`` of the flax tree element for
    element.
    """

    def __init__(self, example_tree) -> None:
        self.leaves = [(path, tuple(leaf.shape)) for path, leaf in flat_items(example_tree)]
        self.total = int(sum(int(np.prod(shape)) for _, shape in self.leaves))

    def flatten_tensor(self, tree) -> torch.Tensor:
        """The flat vector as one tensor on the leaves' device."""
        items = list(flat_items(tree))
        if [p for p, _ in items] != [p for p, _ in self.leaves]:
            raise ValueError("tree paths differ from the codec's")
        return torch.cat([torch.as_tensor(leaf, dtype=torch.float32).detach().reshape(-1)
                          for _, leaf in items])

    def flatten(self, tree) -> np.ndarray:
        return self.flatten_tensor(tree).cpu().numpy()

    def unflatten(self, vector) -> dict:
        """A nested dict of views into ``vector`` (a tensor, or an array
        taken as a CPU tensor)."""
        vec = torch.as_tensor(vector, dtype=torch.float32)
        if vec.numel() != self.total:
            raise ValueError(f"vector has {vec.numel()} elements, codec {self.total}")
        tree: dict = {}
        pos = 0
        for path, shape in self.leaves:
            *parents, leaf = path.split(".")
            node = tree
            for part in parents:
                node = node.setdefault(part, {})
            n = int(np.prod(shape))
            node[leaf] = vec[pos:pos + n].view(shape)
            pos += n
        return tree
