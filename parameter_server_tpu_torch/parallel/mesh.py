"""Device mesh construction and canonical sharding rules.

Torch counterpart of ``parameter_server_tpu/parallel/mesh.py``.  The JAX mesh
is a grid of devices inside one program, and GSPMD derives the collectives
from sharding annotations.  Here a mesh is a
``torch.distributed.device_mesh.DeviceMesh`` over the initialised world, one
rank per device, with one sub-group per axis; the trainers write the
collectives out over those groups.

Axis conventions (as in the JAX package):
  data    — data parallelism (batch dimension; the worker pool)
  model   — table row shards / tensor parallelism (the server key ranges)

Ranks lie on the grid row-major: rank ``r`` sits at ``(r // n_model,
r % n_model)``, so the ranks of one host (consecutive ranks) share a ``model``
group, and the ``data`` axis crosses hosts (``distributed.global_mesh``).

A sharding is a :class:`Sharding`: the JAX ``PartitionSpec`` as a tuple (a
mesh axis name or ``None`` per tensor dimension), its DTensor placements, and
``shard_shape`` / ``local_slices`` for one rank's block.
"""

from __future__ import annotations

import datetime
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

#: timeout of a world this module forms itself, and of every sub-group
DEFAULT_TIMEOUT_S = 300.0
_timeout_s = DEFAULT_TIMEOUT_S


class Mesh:
    """A ``DeviceMesh`` with the JAX ``Mesh``'s read side: ``shape`` by axis
    name, plus this rank's coordinate (:meth:`index`) and process group
    (:meth:`group`) on each axis, and its device."""

    def __init__(self, device_mesh, device: torch.device) -> None:
        self.device_mesh = device_mesh
        self.axis_names: Tuple[str, ...] = tuple(device_mesh.mesh_dim_names)
        self.shape: Dict[str, int] = dict(zip(self.axis_names, device_mesh.mesh.shape))
        self.device = torch.device(device)
        self.size = int(device_mesh.mesh.numel())

    def index(self, axis: str) -> int:
        """This rank's coordinate on ``axis``."""
        return int(self.device_mesh.get_local_rank(axis))

    def group(self, axis: str):
        """The process group of this rank's line along ``axis``."""
        return self.device_mesh.get_group(axis)

    def all_reduce(self, t: torch.Tensor, axis: str) -> torch.Tensor:
        """Sum ``t`` in place over ``axis``; an identity on an axis of one."""
        if self.shape[axis] > 1:
            dist.all_reduce(t, group=self.group(axis))
        return t

    def __repr__(self) -> str:
        return f"Mesh({self.shape}, device={self.device})"


def _timedelta(seconds: float) -> datetime.timedelta:
    return datetime.timedelta(seconds=float(seconds))


def set_group_timeout(seconds: float) -> None:
    """The timeout of the sub-groups this process makes: the world's own, as
    ``distributed.initialize`` / :func:`init_local_world` formed it."""
    global _timeout_s
    _timeout_s = float(seconds)


def _backend_for(device: torch.device) -> str:
    return "nccl" if device.type == "cuda" else "gloo"


def init_local_world(device: str | torch.device = "cuda",
                     timeout_s: float = DEFAULT_TIMEOUT_S) -> None:
    """Form a world of this one process: gloo on the CPU, NCCL on the card
    (raises where NCCL cannot start), rendezvous through a ``TCPStore`` on
    loopback.  A collective that outlives ``timeout_s`` raises."""
    device = torch.device(device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("a world on 'cuda': no CUDA device is visible")
    set_group_timeout(timeout_s)
    store = dist.TCPStore("127.0.0.1", 0, 1, is_master=True,
                          timeout=_timedelta(timeout_s))
    kw = {}
    if device.type == "cuda":
        torch.cuda.set_device(device.index or 0)
        kw["device_id"] = torch.device("cuda", device.index or 0)
    dist.init_process_group(_backend_for(device), store=store, world_size=1, rank=0,
                            timeout=_timedelta(timeout_s), **kw)


def _rank_device(device: torch.device) -> torch.device:
    """This rank's device: its card (the one ``distributed.initialize`` /
    :func:`init_local_world` made current), or the CPU."""
    if device.type != "cuda":
        return torch.device("cpu")
    return torch.device("cuda", torch.cuda.current_device())


def make_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (DATA_AXIS, MODEL_AXIS),
    *,
    device: str | torch.device = "cuda",
) -> Mesh:
    """Build a mesh over the initialised world (one rank per device).

    Default shape: every rank on the data axis (pure DP), model axis 1.  A
    process with no world forms one of its own (:func:`init_local_world`).
    On ``"cuda"`` the world must be an NCCL one: a mesh on the card never
    runs its collectives through gloo or the host.
    """
    device = torch.device(device)
    if not dist.is_initialized():
        init_local_world(device)
    backend = dist.get_backend()
    # "fake": a memory-feasibility trace's world (parallel/feasibility.py),
    # whose collectives move nothing
    if backend != _backend_for(device) and backend != "fake":
        raise ValueError(f"a {device.type} mesh needs a {_backend_for(device)} world, "
                         f"this one is {backend}")
    world = dist.get_world_size()
    if shape is None:
        shape = (world,) + (1,) * (len(axis_names) - 1)
    shape = tuple(int(s) for s in shape)
    if len(shape) != len(axis_names):
        raise ValueError(f"mesh shape {shape} does not match axes {tuple(axis_names)}")
    if int(np.prod(shape)) != world:
        raise ValueError(f"mesh shape {shape} != {world} devices")
    grid = np.arange(world).reshape(shape)
    rank = dist.get_rank()
    timeout = _timedelta(_timeout_s)
    groups = []
    for axis in range(len(shape)):
        # every rank creates every group, in the same order (new_group is a
        # collective over the world); it keeps the one through its own rank
        lines = np.moveaxis(grid, axis, -1).reshape(-1, shape[axis])
        mine = None
        for line in lines:
            ranks = [int(r) for r in line]
            g = dist.new_group(ranks, timeout=timeout)
            if rank in ranks:
                mine = g
        groups.append(mine)
    from torch.distributed.device_mesh import DeviceMesh

    dm = DeviceMesh.from_group(groups, device.type, mesh=torch.as_tensor(grid),
                               mesh_dim_names=tuple(axis_names))
    return Mesh(dm, _rank_device(device))


class Sharding:
    """A ``NamedSharding``: the mesh and a spec, one mesh axis (or ``None``)
    per tensor dimension; missing trailing dimensions are replicated.  Only
    ``mesh.shape`` and ``mesh.axis_names`` are read, except by
    :meth:`local_slices`, which needs the rank's coordinates."""

    def __init__(self, mesh, spec: Sequence[Optional[str]]) -> None:
        self.mesh = mesh
        self.spec: Tuple[Optional[str], ...] = tuple(spec)

    def _parts(self, ndim: int) -> Tuple[Optional[str], ...]:
        if len(self.spec) > ndim:
            raise ValueError(f"spec {self.spec} has more entries than {ndim} dims")
        return self.spec + (None,) * (ndim - len(self.spec))

    @property
    def placements(self):
        """DTensor placements, one per mesh axis: ``Shard(dim)`` where the
        spec names the axis, else ``Replicate()``."""
        from torch.distributed.tensor import Replicate, Shard

        out = []
        for axis in self.mesh.axis_names:
            dims = [d for d, a in enumerate(self.spec) if a == axis]
            out.append(Shard(dims[0]) if dims else Replicate())
        return out

    def shard_shape(self, global_shape: Sequence[int]) -> Tuple[int, ...]:
        """One device's block of a ``global_shape`` array; raises where a
        sharded dimension does not divide evenly (as the JAX one does)."""
        out = []
        for size, axis in zip(global_shape, self._parts(len(global_shape))):
            n = 1 if axis is None else int(self.mesh.shape[axis])
            if size % n:
                raise ValueError(f"dimension {size} is not divisible by {axis}={n}")
            out.append(size // n)
        return tuple(out)

    def local_slices(self, global_shape: Sequence[int]) -> Tuple[slice, ...]:
        """This rank's block of a ``global_shape`` array, as slices."""
        block = self.shard_shape(global_shape)
        out = []
        for b, axis in zip(block, self._parts(len(global_shape))):
            i = 0 if axis is None else self.mesh.index(axis)
            out.append(slice(i * b, (i + 1) * b))
        return tuple(out)

    def __repr__(self) -> str:
        return f"Sharding(spec={self.spec})"


def table_sharding(mesh) -> Sharding:
    """Row-sharded table over the model axis (NodeAssigner key ranges)."""
    return Sharding(mesh, (MODEL_AXIS, None))


def replicated(mesh) -> Sharding:
    return Sharding(mesh, ())


def batch_sharding(mesh, ndim: int) -> Sharding:
    """Leading-axis (batch) sharding over the data axis."""
    return Sharding(mesh, (DATA_AXIS,) + (None,) * (ndim - 1))


def row_block(mesh: Mesh, total_rows: int) -> Tuple[int, int]:
    """``[lo, hi)``: the table rows this rank owns under :func:`table_sharding`."""
    rows = table_sharding(mesh).local_slices((total_rows, 1))[0]
    return rows.start, rows.stop


def gather_over_model(mesh: Mesh, block: torch.Tensor) -> np.ndarray:
    """Concatenate the ``model`` group's row blocks, in model order, on the
    host (a collective over that group)."""
    n = mesh.shape[MODEL_AXIS]
    if n == 1:
        return block.cpu().numpy()
    parts = [torch.empty_like(block) for _ in range(n)]
    dist.all_gather(parts, block.contiguous(), group=mesh.group(MODEL_AXIS))
    return torch.cat(parts).cpu().numpy()
