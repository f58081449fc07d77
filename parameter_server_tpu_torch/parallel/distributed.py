"""Multi-host runtime: process-group init, global mesh, per-host data.

Torch counterpart of ``parameter_server_tpu/parallel/distributed.py``.  A JAX
pod runs one process per host, each owning its local chips; a torch world
runs one rank per device.  So a JAX *process* is a **host** here: a group of
consecutive ranks, one per device of that host.

- :func:`initialize` — rank startup: ``torch.distributed.init_process_group``
  against the coordinator's ``TCPStore``, NCCL on the card, gloo on the CPU
  (``device="cpu"``, or ``cpu_devices=k``: the CPU-simulated host of ``k``
  ranks, which hides the card).  Every group carries ``timeout``: a
  collective that outlives it raises.
- :func:`global_mesh` — the job-wide mesh.  Its default layout puts the host
  boundary on the leading (``data``) axis, so ``model``-axis collectives stay
  inside a host.
- :func:`host_local_batch` — this rank's rows of the global batch, on its
  device, from the rows its host read.
- :func:`local_batch_slice` — host code, bit for bit the JAX function.
"""

from __future__ import annotations

from typing import Optional, Sequence

import numpy as np
import torch
import torch.distributed as dist

from parameter_server_tpu_torch.parallel import mesh as mesh_lib

_job = {"hosts": 1, "host": 0, "device": "cuda"}


def initialize(
    coordinator: Optional[str] = None,
    num_processes: int = 1,
    process_id: int = 0,
    *,
    cpu_devices: int = 0,
    local_rank: int = 0,
    device: str = "cuda",
    timeout: float = mesh_lib.DEFAULT_TIMEOUT_S,
) -> torch.device:
    """Join the job as rank ``local_rank`` of host ``process_id``.

    ``coordinator``: ``host:port`` of rank 0's store.  ``cpu_devices > 0``:
    the CPU simulation, ``cpu_devices`` gloo ranks per host (the card is
    hidden from this process).  Otherwise a host has one rank per card on
    ``"cuda"`` (NCCL, or raise) and one rank on ``"cpu"`` (gloo).  A single
    rank with no coordinator forms its own world.  Returns this rank's
    device.
    """
    if cpu_devices:
        from parameter_server_tpu_torch.utils.platform import force_cpu

        force_cpu(cpu_devices)
        device = "cpu"
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("initialize(device='cuda'): no CUDA device is visible")
        per_host = torch.cuda.device_count()
    else:
        per_host = max(int(cpu_devices), 1)
    if not 0 <= local_rank < per_host:
        raise ValueError(f"local rank {local_rank} outside a host of {per_host} ranks")
    world = num_processes * per_host
    rank = process_id * per_host + local_rank
    _job.update(hosts=int(num_processes), host=int(process_id), device=dev.type)
    mesh_lib.set_group_timeout(timeout)
    if dev.type == "cuda":
        dev = torch.device("cuda", local_rank)
        torch.cuda.set_device(dev)
    if dist.is_initialized():
        return dev
    if world == 1 and coordinator is None:
        mesh_lib.init_local_world(dev, timeout)
        return dev
    if coordinator is None:
        raise ValueError(f"a world of {world} ranks needs a coordinator")
    kw = {"device_id": dev} if dev.type == "cuda" else {}
    dist.init_process_group(
        "nccl" if dev.type == "cuda" else "gloo",
        init_method=f"tcp://{coordinator}", world_size=world, rank=rank,
        timeout=mesh_lib._timedelta(timeout), **kw,
    )
    return dev


def process_count() -> int:
    """Hosts in the job (the JAX ``jax.process_count()``)."""
    return _job["hosts"]


def process_index() -> int:
    """This rank's host (the JAX ``jax.process_index()``)."""
    return _job["host"]


def global_mesh(
    shape: Optional[Sequence[int]] = None,
    axis_names: Sequence[str] = (mesh_lib.DATA_AXIS, mesh_lib.MODEL_AXIS),
) -> mesh_lib.Mesh:
    """Mesh over every rank of every host in the job.

    Default shape: ``(hosts, ranks per host)`` for 2 axes — the data axis
    crosses the host boundary, the model axis stays on one host's devices,
    so table-row collectives never leave the host.
    """
    world = dist.get_world_size() if dist.is_initialized() else 1
    if shape is None and len(axis_names) == 2:
        shape = (process_count(), world // process_count())
    return mesh_lib.make_mesh(shape, axis_names, device=_job["device"])


def host_local_batch(sharding: mesh_lib.Sharding, local_data: np.ndarray,
                     global_shape: Sequence[int]) -> torch.Tensor:
    """This rank's block of the global batch, on its device.

    ``local_data`` holds the rows this rank's host read from ITS data shards:
    the whole global batch when one host feeds it all, else the host's
    contiguous ``1 / hosts`` share (process-major, as :func:`global_mesh` lays
    out the data axis).  The rank takes its ``sharding`` block out of it.
    """
    local_data = np.asarray(local_data)
    global_shape = tuple(int(s) for s in global_shape)
    rows = sharding.local_slices(global_shape)[0]
    n = local_data.shape[0]
    offset = 0 if n == global_shape[0] else process_index() * n
    start, stop = rows.start - offset, rows.stop - offset
    if start < 0 or stop > n:
        raise ValueError(f"rows [{rows.start}, {rows.stop}) of the global batch are not "
                         f"among this host's [{offset}, {offset + n})")
    block = np.ascontiguousarray(local_data[start:stop])
    return torch.from_numpy(block).to(sharding.mesh.device)


def local_batch_slice(process_id: int, num_processes: int,
                      global_batch: int) -> slice:
    """Contiguous rows of the global batch this process feeds.

    Matches the data-axis device order of :func:`global_mesh` (process-major),
    so a process's rows land on its own devices — no cross-host scatter.
    """
    if global_batch % num_processes:
        raise ValueError(
            f"global batch {global_batch} not divisible by {num_processes}"
        )
    per = global_batch // num_processes
    return slice(process_id * per, (process_id + 1) * per)
