"""PyTorch/CUDA port of the parameter server: the sparse-LR PS loop with its
server's default planes (apply ledger, flight recorder, wire coalescing, the
native ``Localizer``), the synchronous push plane (``KVWorker.push_sync``
with fence, deadline and consistency-gate retries, worker groups that
pre-reduce before the wire, the servers' SSP/BSP/ASP gate), the
single-device trainer, DLRM over a card-resident embedding table, the
dense KV plane with ResNet, the serving plane and replica chains, the
durability plane (checkpoints, snapshots, live migration, same-id restart)
and the membership and elasticity plane (the scheduler's ``Manager`` with
heartbeat failure detection, ``FleetMonitor``, ``ElasticTrainer``).

The JAX package ``parameter_server_tpu`` is the reference; this package keeps
its module layout and names so each counterpart sits at the same path.  It
imports ``torch`` and numpy only.  Every entry point takes a ``device``
argument that defaults to ``"cuda"``; the CPU is used only when the caller
passes ``device="cpu"``.  On a CUDA tensor the four row kernels of
``ops/scatter.py`` always launch the hand-written CUDA kernels in ``csrc/``.
"""
