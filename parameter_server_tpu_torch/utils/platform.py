"""Platform forcing for host-only roles and CPU-simulated device worlds.

Torch counterpart of ``parameter_server_tpu/utils/platform.py``.  Launched
roles that must never touch the card (a CPU-simulated mesh rank, a host-side
tool) hide it before torch initialises CUDA: with ``CUDA_VISIBLE_DEVICES``
empty, ``torch.cuda.is_available()`` is false in this process and in every
process it starts.  Where the JAX function forces ``n`` virtual CPU devices
into one process, a torch world runs one gloo rank per simulated device, so
``n`` is recorded as the number of ranks this host stands for
(:func:`cpu_devices`) and the launcher starts that many processes.
"""

from __future__ import annotations

import os

_cpu_devices = 0


def force_cpu(n_devices: int = 0) -> None:
    """Pin this process (and its children) to the CPU; optionally record that
    it is one of ``n_devices`` simulated devices of its host.

    Must run before anything initialises CUDA; afterwards the card stays
    visible to this process (CUDA reads the variable once), though not to
    the processes it starts.
    """
    global _cpu_devices
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    if n_devices:
        _cpu_devices = int(n_devices)


def cpu_devices() -> int:
    """The simulated devices per host recorded by :func:`force_cpu` (0: none)."""
    return _cpu_devices
