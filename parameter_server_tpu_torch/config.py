"""Configuration dataclasses: the fields of the JAX package's ``config.py``
that the sparse-LR push/pull loop, the server's apply ledger, the
consistency gate, worker groups, the serving plane, the durability plane and
the transport read, the tracing and telemetry knobs, and the app layer's
topology, with the same names, defaults and validation."""

from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Tuple, Union


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
    #: graceful-degradation deadline of the wire-enforced gate: a request
    #: held by ``__wait__`` defers longer than this is forced through
    #: ungated (counted, never dropped).  <= 0 waits forever.
    gate_deadline_s: float = 5.0
    #: base sleep between gate retries when the server's ``__wait__`` reply
    #: advertises no ``retry_after`` hint.
    gate_retry_s: float = 0.005

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
        if self.gate_retry_s <= 0:
            raise ValueError(f"gate_retry_s must be > 0, got {self.gate_retry_s!r}")


@dataclasses.dataclass(frozen=True)
class TopologyConfig:
    """Process/device topology of an app — the reference's gflags layer:
    ``num_workers`` workers and ``num_servers`` table shards.

    ``mesh_shape`` / ``mesh_axis_names`` keep the JAX schema's mesh fields
    (data, model) so one config file serves both packages; ``sptp_lm`` reads
    ``mesh_shape`` as (sp, model) over every rank of the world.
    """

    num_workers: int = 1
    num_servers: int = 1
    mesh_shape: Optional[Tuple[int, ...]] = None
    mesh_axis_names: Tuple[str, ...] = ("data", "model")


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
class GroupConfig:
    """Hierarchical push: a worker group pre-reduces its PUSH value planes
    before the wire, and one elected member pushes the reduced tensor,
    booked by the servers as ONE logical apply.

    ``election``: ``"rotate"`` spreads the pushing leg across members per
    ``(table, step)``, ``"fixed"`` pins member 0.  ``fallback``: ``"direct"``
    re-pushes a member's own gradient within the same step when the leader
    is dead or partitioned, ``"none"`` raises instead.  ``reduce``:
    ``"auto"`` / ``"psum"`` sum same-key contributions in member order (a
    one-card host has no collective across members, as the JAX package on a
    one-device host), ``"merge"`` always takes the sorted-union merge.
    ``fallback_timeout``: seconds a member waits on the leader before
    falling back; also the age at which a leader flushes an incomplete
    rendezvous as a partial reduction.
    """

    size: int = 1
    election: str = "rotate"
    fallback: str = "direct"
    reduce: str = "auto"
    fallback_timeout: float = 0.25

    def __post_init__(self) -> None:
        if self.size < 1:
            raise ValueError(f"size must be >= 1, got {self.size!r}")
        if self.election not in ("rotate", "fixed"):
            raise ValueError(f"election must be rotate|fixed, got {self.election!r}")
        if self.fallback not in ("direct", "none"):
            raise ValueError(f"fallback must be direct|none, got {self.fallback!r}")
        if self.reduce not in ("auto", "psum", "merge"):
            raise ValueError(f"reduce must be auto|psum|merge, got {self.reduce!r}")
        if self.fallback_timeout <= 0:
            raise ValueError(
                f"fallback_timeout must be > 0, got {self.fallback_timeout!r}"
            )


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Read-heavy serving plane knobs.

    The serving plane layers three mechanisms over the training substrate:
    a worker-side hot-row cache invalidated by the piggybacked ``__sver__``
    segment version clock (``kv/cache.py``), a server-side read-only PULL
    fast path (``__ro__`` request flag), and admission control
    (``serve/admission.py``) consuming a health callable and the ledger's
    ``__busy__`` hints.
    """

    #: hot-row cache capacity, in rows per table (direct-mapped, rounded up
    #: to a power of two; collision-evicted); <= 0 disables caching.
    cache_rows: int = 65536
    #: what to do with read traffic while the plane is unhealthy (health
    #: callable False or a live ``__busy__`` hint): "reject" answers
    #: immediately with a retry-after shed; "stale" serves watermark-invalid
    #: cache entries (bounded only by what the cache holds) and sheds
    #: uncached keys; "queue" waits up to ``queue_deadline_s`` for health,
    #: then sheds.
    policy: str = "reject"
    #: advisory client back-off carried by a reject shed, seconds.
    retry_after_s: float = 0.05
    #: max time a "queue" policy read waits for the plane to recover.
    queue_deadline_s: float = 0.5
    #: poll period while a "queue" policy read is parked.
    queue_poll_s: float = 0.005
    #: how recent a ``__busy__`` hint must be to count as live overload.
    busy_within_s: float = 1.0

    def __post_init__(self) -> None:
        if self.policy not in ("reject", "stale", "queue"):
            raise ValueError(
                f"serve policy must be reject|stale|queue, got {self.policy!r}"
            )


@dataclasses.dataclass(frozen=True)
class CheckpointConfig:
    """Durability-plane knobs: the partitioned snapshot cadence.

    The partitioned snapshot path (``KVWorker.save_snapshot`` +
    ``checkpoint.finalize_snapshot``) snapshots any routing layout: one file
    per segment, a segment whose ``__sver__`` clock has not advanced carried
    forward from the base snapshot, and a dirty-row delta log that bounds the
    commit freeze.
    """

    #: target wall-clock seconds between durable manifests
    interval_s: float = 60.0
    #: soft bound on the dirty-row delta a snapshot commit exports in its
    #: freeze; a commit over it still lands, flagged ``over_bound`` on its
    #: ``ckpt.commit`` event and counted in ``ckpt_delta_overflow``
    max_delta_rows: int = 65536
    #: snapshots kept by ``checkpoint.retain_snapshots`` (chain bases that
    #: kept manifests reference are kept regardless)
    retention: int = 3
    #: "auto" = legacy uniform shards while the layout allows them, the
    #: partitioned path once the fleet has rebalanced (or a snapshot chain
    #: exists to extend); "partitioned" / "legacy" force one path
    mode: str = "auto"

    def __post_init__(self) -> None:
        if self.interval_s <= 0:
            raise ValueError(f"interval_s must be > 0, got {self.interval_s!r}")
        if self.max_delta_rows < 1:
            raise ValueError(f"max_delta_rows must be >= 1, got {self.max_delta_rows!r}")
        if self.retention < 0:
            raise ValueError(f"retention must be >= 0, got {self.retention!r}")
        if self.mode not in ("auto", "legacy", "partitioned"):
            raise ValueError(f"mode must be auto|legacy|partitioned, got {self.mode!r}")


@dataclasses.dataclass(frozen=True)
class TransportConfig:
    """Transport knobs: wire backend + colocated shm rings.

    ``TcpVan`` consumes this; both knobs also answer to env overrides
    (``PS_WIRE=epoll|threaded``, ``PS_NO_SHM=1``) so tests and rollouts can
    flip backends without plumbing a config through every constructor.
    """

    #: native wire backend: "epoll" (one event-loop thread multiplexing all
    #: connections, vectored writev sends, bounded write queues —
    #: ``native/src/epollvan.cc``) or "threaded" (the thread-per-
    #: connection core, ``native/src/tcpvan.cc``).  "epoll" quietly falls
    #: back to "threaded" when the epoll backend fails to build.
    wire: str = "epoll"
    #: negotiate shared-memory rings for colocated links (same boot id):
    #: frames bypass TCP via ``core/shm_ring.py``; any doubt (ring full,
    #: peer dead, old peer that never acks) degrades per-frame to TCP.
    shm: bool = True
    #: per-direction ring capacity in bytes.
    ring_capacity: int = 4 << 20
    #: how long a sender waits for ring space before falling back to TCP
    #: for that frame (counted in ``ring_full``).
    ring_wait_s: float = 0.0005

    def __post_init__(self) -> None:
        if self.wire not in ("epoll", "threaded"):
            raise ValueError(f"wire must be epoll|threaded, got {self.wire!r}")
        if self.ring_capacity < 4096:
            raise ValueError(
                f"ring_capacity must be >= 4096, got {self.ring_capacity!r}"
            )
        if self.ring_wait_s < 0:
            raise ValueError(
                f"ring_wait_s must be >= 0, got {self.ring_wait_s!r}"
            )


@dataclasses.dataclass(frozen=True)
class WireCompressionConfig:
    """Lossy wire codec for a table's PUSH value plane.

    Selected per table (``TableConfig.compression``) and composed under
    ``CoalescingVan`` through :class:`~parameter_server_tpu_torch.core.
    filters.QuantizingFilter`: one pass over the bundled value plane, PUSH
    requests only (PULL replies stay bit-exact).

    ``error_feedback`` keeps a per-(sender, table, key) residual on the
    sender: the quantization error of each push is added to the NEXT push
    of the same keys instead of lost, so the compressed run converges like
    the uncompressed one.  Residuals are dropped on ``adopt_routing`` (a new
    routing epoch), on a peer's incarnation advance and on a same-id
    restart.

    ``per_row``: ``True`` / ``False`` force per-row / per-tensor scales;
    ``"auto"`` uses per-row scales only when the last dim is >= 16 (each
    row scale costs 4 bytes, which would rival the int8 payload of a dim-1
    table).
    """

    #: wire codec: "none" (bit-exact), "int8", or "fp8".
    codec: str = "none"
    #: fp8 bit layout: "e4m3" (more mantissa) or "e5m2" (more range).
    fp8_format: str = "e4m3"
    #: "nearest" or "stochastic" (seeded from ``seed``: deterministic).
    rounding: str = "nearest"
    #: carry quantization error forward per (sender, table, key).
    error_feedback: bool = True
    #: per-row scales: True | False | "auto".
    per_row: Union[bool, str] = "auto"
    #: stochastic-rounding rng seed.
    seed: int = 0

    def __post_init__(self) -> None:
        if self.codec not in ("none", "int8", "fp8"):
            raise ValueError(
                f"codec must be none|int8|fp8, got {self.codec!r}"
            )
        if self.fp8_format not in ("e4m3", "e5m2"):
            raise ValueError(
                f"fp8_format must be e4m3|e5m2, got {self.fp8_format!r}"
            )
        if self.rounding not in ("nearest", "stochastic"):
            raise ValueError(
                f"rounding must be nearest|stochastic, got {self.rounding!r}"
            )
        if not (self.per_row in (True, False) or self.per_row == "auto"):
            raise ValueError(
                f'per_row must be True, False, or "auto", got {self.per_row!r}'
            )


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
    #: lossy wire codec for this table's PUSH plane; None = bit-exact wire.
    compression: Optional[WireCompressionConfig] = None
    #: wire-enforced consistency gate: when set, workers stamp their
    #: committed step (``__cstep__``) on this table's PUSH/PULL requests and
    #: servers gate them against the fleet's vector clock (SSP / BSP / ASP).
    #: None = ungated, no extra payload.
    consistency: Optional[ConsistencyConfig] = None


@dataclasses.dataclass(frozen=True)
class TraceConfig:
    """Sampled end-to-end request tracing.

    ``KVWorker`` consumes this to decide whether a PUSH/PULL submit stamps
    a trace context (``core/tracectx.py``) into its payload.  Sampling is
    a deterministic hash of ``(trace_id, seed)`` so seeded replays trace
    the same requests and unsampled requests carry zero trace bytes on
    the wire.
    """

    #: master switch; False stamps no contexts at all (the predicate the
    #: hot path is gated behind — see tools/check_wrappers.py).
    enabled: bool = True
    #: trace 1-in-N requests.  1 = every request (tests), 0 = never;
    #: 1024 is the default the bench gate holds to ≤3% overhead.
    sample_every: int = 1024
    #: seed folded into the sampling hash; replays with the same seed
    #: sample the same trace ids.
    seed: int = 0

    def __post_init__(self) -> None:
        if self.sample_every < 0:
            raise ValueError(
                f"sample_every must be >= 0, got {self.sample_every!r}"
            )


@dataclasses.dataclass(frozen=True)
class TelemetryConfig:
    """Scheduler-side telemetry aggregator sizing.

    The aggregator keeps a bounded ring of derived rows per publishing
    node.  A fixed per-node window tuned for ~4 nodes does not survive a
    200-publisher war game: 256 rows x 200 nodes is ~50k retained rows on
    the control plane.  Instead the per-node ring capacity is derived from
    a FLEET-WIDE row budget — ``min(window, ring_budget_rows // fleet)``,
    floored at ``min_window`` — and re-derived (rings re-capped in place)
    as new publishers appear, so total retained rows stay near the budget
    at any fleet size while small fleets keep the full ``window``.
    """

    #: per-node ring rows for small fleets.
    window: int = 256
    #: fleet-wide retained-row budget; per-node capacity shrinks as the
    #: publisher count grows so the scheduler's memory stays flat.
    ring_budget_rows: int = 8192
    #: per-node capacity floor — even a 1000-node fleet keeps enough rows
    #: per node for rate windows and pstop history.
    min_window: int = 8

    def __post_init__(self) -> None:
        if self.window < 1:
            raise ValueError(f"window must be >= 1, got {self.window!r}")
        if self.min_window < 1:
            raise ValueError(
                f"min_window must be >= 1, got {self.min_window!r}"
            )
        if self.min_window > self.window:
            raise ValueError(
                f"min_window ({self.min_window!r}) must be <= window "
                f"({self.window!r})"
            )
        if self.ring_budget_rows < self.window:
            raise ValueError(
                f"ring_budget_rows ({self.ring_budget_rows!r}) must be >= "
                f"window ({self.window!r})"
            )

    def node_window(self, fleet_size: int) -> int:
        """Per-node ring capacity for ``fleet_size`` publishers."""
        n = max(1, int(fleet_size))
        return max(self.min_window, min(self.window, self.ring_budget_rows // n))
