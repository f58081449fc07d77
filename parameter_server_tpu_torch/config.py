"""Configuration dataclasses: the fields of the JAX package's ``config.py``
that the sparse-LR push/pull loop and the server's apply ledger read, with
the same names and defaults."""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional


class ConsistencyMode(str, enum.Enum):
    """BSP = depend on all prior iterations; ASP = no dependencies; SSP =
    bounded staleness of ``max_delay`` iterations."""

    BSP = "bsp"
    SSP = "ssp"
    ASP = "asp"


@dataclasses.dataclass(frozen=True)
class ConsistencyConfig:
    mode: ConsistencyMode = ConsistencyMode.BSP
    #: SSP staleness bound; ignored for BSP (0) and ASP (unbounded).
    max_delay: int = 0

    @property
    def bound(self) -> Optional[int]:
        """Staleness bound as an int, or None for unbounded (ASP)."""
        if self.mode == ConsistencyMode.BSP:
            return 0
        if self.mode == ConsistencyMode.SSP:
            return self.max_delay
        return None

    def __post_init__(self) -> None:
        if self.max_delay < 0:
            raise ValueError(f"max_delay must be >= 0, got {self.max_delay!r}")


@dataclasses.dataclass(frozen=True)
class OptimizerConfig:
    """Server-side update rule: ``kind`` in {"sgd", "adagrad", "adam", "ftrl"}."""

    kind: str = "adagrad"
    learning_rate: float = 0.1
    l1: float = 0.0
    l2: float = 0.0
    #: adagrad/adam epsilon.
    eps: float = 1e-8
    beta1: float = 0.9
    beta2: float = 0.999
    #: ftrl alpha/beta per the FTRL-proximal paper parameterization.
    ftrl_alpha: float = 0.05
    ftrl_beta: float = 1.0


@dataclasses.dataclass(frozen=True)
class ApplyEngineConfig:
    """Bundle-batched push apply: how many same-table PUSHes of one bundle
    collapse into one device apply, and the cross-member duplicate policy
    (``"rounds"``: bitwise-sequential occurrence rounds; ``"combine"``:
    segment-summed, one apply)."""

    apply_batch: int = 16
    dup_policy: str = "rounds"


@dataclasses.dataclass(frozen=True)
class LedgerConfig:
    """Device-plane observability knobs (the server's ApplyLedger).

    Push acks are sync-free, so the ack never observes the device apply:
    true apply latency, device queue depth, and the host-assembly/H2D/compute
    split are invisible to it.  The ledger (``kv/ledger.py``) registers every
    in-flight apply at dispatch and retires it from a background reaper
    thread once its completion handle (a CUDA event on the card) reports
    done — never from the ack path, so the sync-free contract holds.  Between
    completions the reaper waits on the oldest in-flight handle;
    ``reap_interval_s`` is only the degraded-mode poll cadence (a handle
    whose poll raises, ``drain``).

    Backlog bounds drive the soft-backpressure hint: when any configured
    bound is exceeded, the server stamps ``__busy__`` into push acks and the
    ``apply.backlog`` flight-recorder event fires edge-triggered.  A bound
    of 0 disables that bound; all bounds 0 (the default) means the ledger
    observes but never hints.
    """

    enabled: bool = True
    #: reaper poll period; also bounds device-latency measurement error.
    reap_interval_s: float = 0.001
    #: reaper self-stops after this long with nothing in flight (restarted
    #: lazily on the next submit) — idle servers pay zero poll cost.
    idle_stop_s: float = 2.0
    #: backpressure bounds (0 = unbounded): in-flight device applies ...
    backlog_bundles: int = 0
    #: ... in-flight rows across those applies ...
    backlog_rows: int = 0
    #: ... and age of the oldest un-retired apply, in seconds.
    backlog_age_s: float = 0.0


@dataclasses.dataclass(frozen=True)
class TableConfig:
    """A KV table: the unit that is range-partitioned across servers."""

    name: str
    rows: int
    dim: int = 1
    dtype: str = "float32"
    optimizer: OptimizerConfig = dataclasses.field(default_factory=OptimizerConfig)
    #: stddev of normal init for value rows; 0.0 = zeros (LR weights).
    init_scale: float = 0.0
    #: only ``"auto"``: the CUDA kernels for tensors on the card, their plain
    #: PyTorch versions for tensors on the CPU.
    scatter_impl: str = "auto"
    #: fused push apply (one gather -> rule -> scatter kernel); False selects
    #: the three-pass path (gathers, plain rule, scatter-sets).
    fused_apply: bool = True
