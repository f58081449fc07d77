"""Metrics and dashboard: AUC, counter merging, per-iteration rows and MFU.

The port's copy of ``parameter_server_tpu/utils/metrics.py``: :func:`auc`,
:func:`transport_counters` (the heartbeat's ``net`` stat),
:class:`CounterGroup` and :class:`Dashboard` — rows, the transport,
prefetch and migration attachments, the tracer attribution (``spans_s``)
and the MFU column (``mfu_pct``) — as they are.

The MFU half differs by design:

- the numerator comes from :func:`counted_flops`, a
  ``torch.utils.flop_counter.FlopCounterMode`` count of one call on
  ``meta``-device copies of its inputs.  It counts matmul and convolution
  FLOPs only (XLA's ``cost_analysis``, the JAX package's numerator, counts
  every op), and it executes nothing on live parameters or state;
- the denominator is the card's own data-sheet peak for the math mode the
  step runs in (:func:`peak_flops_of`), or 0 — which turns the column off —
  for a card the table does not know.  The CPU keeps the JAX package's
  nominal 1e11 so a CPU number is visibly not a device number.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import time
from typing import IO, Dict, Optional

import numpy as np


def auc(labels: np.ndarray, scores: np.ndarray) -> float:
    """Area under the ROC curve via rank statistic (ties averaged)."""
    labels = np.asarray(labels).ravel()
    scores = np.asarray(scores).ravel()
    pos = labels > 0.5
    n_pos = int(pos.sum())
    n_neg = labels.size - n_pos
    if n_pos == 0 or n_neg == 0:
        return float("nan")
    order = np.argsort(scores, kind="mergesort")
    ranks = np.empty(labels.size, dtype=np.float64)
    ranks[order] = np.arange(1, labels.size + 1)
    # average ranks over tied scores
    sorted_scores = scores[order]
    i = 0
    while i < labels.size:
        j = i
        while j + 1 < labels.size and sorted_scores[j + 1] == sorted_scores[i]:
            j += 1
        if j > i:
            ranks[order[i : j + 1]] = (i + 1 + j + 1) / 2.0
        i = j + 1
    return float((ranks[pos].sum() - n_pos * (n_pos + 1) / 2.0) / (n_pos * n_neg))


def transport_counters(van) -> dict:
    """Merge dashboard counters from a (possibly wrapped) Van stack.

    Walks the ``.inner`` chain of Van decorators (``MeteredVan``,
    ``CoalescingVan``) down to the base transport, merging each layer's
    ``counters()`` dict into one flat dict.  Same-named keys across layers
    are summed.
    """
    out: dict = {}
    seen = set()
    v = van
    while v is not None and id(v) not in seen:
        seen.add(id(v))
        get = getattr(v, "counters", None)
        if callable(get):
            try:
                for k, val in get().items():
                    out[k] = out.get(k, 0) + val
            except Exception:  # pragma: no cover — metrics must never crash
                pass
        v = getattr(v, "inner", None)
    return out


class CounterGroup:
    """Merge several ``counters()`` sources into one dict (summed keys).

    The migration plane's counters live on many objects: each
    :class:`~parameter_server_tpu_torch.kv.server.KVServer`
    (``fenced_rejects``, ``rows_migrated_in/out``, freeze seconds), each
    :class:`~parameter_server_tpu_torch.kv.worker.KVWorker`
    (``refresh_retries``) and the
    :class:`~parameter_server_tpu_torch.kv.migrate.ShardMigrator`
    (moves/aborts).  Group them (``CounterGroup(*servers, *workers,
    migrator)``) to read a rebalance in one dict.
    """

    def __init__(self, *sources) -> None:
        self.sources = list(sources)

    def add(self, *sources) -> "CounterGroup":
        self.sources.extend(sources)
        return self

    def counters(self) -> dict:
        out: dict = {}
        for src in self.sources:
            get = getattr(src, "counters", None)
            if not callable(get):
                continue
            try:
                for k, v in get().items():
                    out[k] = out.get(k, 0) + v
            except Exception:  # pragma: no cover — metrics must never crash
                pass
        return out


#: nominal CPU "peak" (the JAX package's): an MFU against it is visibly not
#: a device number
CPU_NOMINAL_FLOPS = 1e11

#: dense peak FLOP/s of one NVIDIA H100 SXM (the "H100 80GB HBM3" part) by
#: math mode, from NVIDIA's H100 Tensor Core GPU data sheet, dense rates
#: without sparsity, at the card's full 700 W limit: bf16 / fp16 tensor
#: cores 989 TFLOP/s, TF32 tensor cores 495 TFLOP/s, plain fp32 (no tensor
#: cores) 67 TFLOP/s
H100_SXM_PEAK_FLOPS = {"bf16": 989e12, "fp16": 989e12, "tf32": 495e12, "fp32": 67e12}

#: card-name patterns (as ``torch.cuda.get_device_name`` reports them) ->
#: peak table.  A card matching none gets 0: no MFU rather than a guess.
CARD_PEAKS = (("H100 80GB HBM3", H100_SXM_PEAK_FLOPS), ("H100 SXM", H100_SXM_PEAK_FLOPS))

#: the math modes a peak table is keyed by
MATH_MODES = ("bf16", "fp16", "tf32", "fp32")


def peak_flops_of(card_name: str, precision: str = "bf16") -> float:
    """Data-sheet dense peak FLOP/s of ``card_name`` in ``precision``; 0.0
    for a card :data:`CARD_PEAKS` does not know (the MFU column then stays
    off)."""
    if precision not in MATH_MODES:
        raise ValueError(f"precision must be one of {MATH_MODES}, got {precision!r}")
    for pattern, table in CARD_PEAKS:
        if pattern in card_name:
            return table[precision]
    return 0.0


def _auto_peak_flops(precision: str = "bf16", device=None) -> float:
    """Peak dense FLOP/s of ``device`` (default: the card when there is
    one, else the CPU) for the MFU denominator: the card's own data-sheet
    figure for ``precision`` (:func:`peak_flops_of`, 0.0 for an unknown
    card), or the nominal :data:`CPU_NOMINAL_FLOPS` on the CPU."""
    import torch

    if device is None:
        device = "cuda" if torch.cuda.is_available() else "cpu"
    device = torch.device(device)
    if device.type != "cuda":
        if precision not in MATH_MODES:
            raise ValueError(f"precision must be one of {MATH_MODES}, got {precision!r}")
        return CPU_NOMINAL_FLOPS
    return peak_flops_of(torch.cuda.get_device_name(device), precision)


def float32_math_mode(op: str = "matmul") -> str:
    """The math mode float32 ``op`` runs in on the card under torch's
    current flags: ``"conv"`` follows ``torch.backends.cudnn.allow_tf32``
    (on by default: TF32), ``"matmul"`` follows
    ``torch.get_float32_matmul_precision()`` (``"highest"``, the default:
    fp32; ``"high"``: TF32; ``"medium"``: bf16)."""
    import torch

    if op == "conv":
        return "tf32" if torch.backends.cudnn.allow_tf32 else "fp32"
    if op != "matmul":
        raise ValueError(f"op must be matmul|conv, got {op!r}")
    return {"highest": "fp32", "high": "tf32", "medium": "bf16"}[
        torch.get_float32_matmul_precision()
    ]


def _meta_copy(x, memo: dict):
    """``x`` with every tensor replaced by a ``meta``-device tensor of the
    same shape, dtype and ``requires_grad``; modules are deep-copied with
    their parameters and buffers swapped for such tensors, so no byte of
    the live state is copied or touched.  ``memo`` maps ``id`` of a tensor
    or module already copied to ``(original, copy)``: a tensor shared by two
    arguments stays shared."""
    import torch

    if isinstance(x, (torch.nn.Module, torch.Tensor)):
        hit = memo.get(id(x))
        if hit is not None:
            return hit[1]
        if isinstance(x, torch.nn.Module):
            swap = {k: v[1] for k, v in memo.items()}
            for p in x.parameters():
                if id(p) not in swap:
                    swap[id(p)] = torch.nn.Parameter(
                        torch.empty_like(p, device="meta"), requires_grad=p.requires_grad
                    )
            for b in x.buffers():
                if id(b) not in swap:
                    swap[id(b)] = torch.empty_like(b, device="meta")
            out = copy.deepcopy(x, swap)
        else:
            out = torch.empty_like(x, device="meta").requires_grad_(x.requires_grad)
        memo[id(x)] = (x, out)
        return out
    if isinstance(x, (list, tuple)):
        return type(x)(_meta_copy(v, memo) for v in x)
    if isinstance(x, dict):
        return {k: _meta_copy(v, memo) for k, v in x.items()}
    return x


def counted_flops_by_kind(fn, *example_args, **example_kwargs) -> Dict[str, float]:
    """FLOPs of ONE call of ``fn(*example_args, **example_kwargs)`` as
    ``torch.utils.flop_counter.FlopCounterMode`` counts them, split into
    ``"conv"`` (convolutions, forward and backward) and ``"matmul"``
    (every other counted op: mm, addmm, bmm, attention).

    The call runs on ``meta``-device copies of every tensor and module among
    the arguments (nested in lists, tuples and dicts too): shapes propagate,
    no kernel runs, and the live parameters, buffers and optimizer state are
    never read or written — so counting a train step cannot perturb the run
    it measures.  ``fn`` must reach its state through its arguments, not
    through a closure over live tensors.
    """
    from torch.utils.flop_counter import FlopCounterMode

    memo: dict = {}
    args = _meta_copy(list(example_args), memo)
    kwargs = _meta_copy(dict(example_kwargs), memo)
    counter = FlopCounterMode(display=False)
    with counter:
        fn(*args, **kwargs)
    out = {"conv": 0.0, "matmul": 0.0}
    for op, n in counter.get_flop_counts().get("Global", {}).items():
        out["conv" if "convolution" in str(op) else "matmul"] += float(n)
    return out


def counted_flops(fn, *example_args, **example_kwargs) -> float:
    """FLOPs of ONE call of ``fn(*example_args, **example_kwargs)``: the sum
    of :func:`counted_flops_by_kind`, on ``meta`` copies (nothing runs on
    the live state).

    The generic MFU numerator for models without a clean closed form (conv
    nets, DLRM's interactions), the counterpart of the JAX package's
    ``lowered_flops``.  The counter sees matmuls, convolutions and attention
    (forward and, when ``fn`` calls ``backward``, backward); elementwise
    ops, reductions, gathers and optimizer updates count zero.  So the
    number is below the JAX package's XLA count of the same step, which
    counts every op.
    """
    return sum(counted_flops_by_kind(fn, *example_args, **example_kwargs).values())


def step_math_mode(flops_by_kind: Dict[str, float]) -> str:
    """The math mode a float32 step's MFU denominator stands for: that of
    the op kind holding most of its counted FLOPs (:func:`float32_math_mode`
    of ``"conv"`` or ``"matmul"``)."""
    kind = "conv" if flops_by_kind.get("conv", 0.0) > flops_by_kind.get("matmul", 0.0) else "matmul"
    return float32_math_mode(kind)


def set_mfu(dashboard: "Dashboard", flops_by_kind: Dict[str, float], examples: int,
            device) -> None:
    """Point ``dashboard``'s MFU column at one counted step: FLOPs per
    example from ``flops_by_kind`` over ``examples``, and — unless the
    caller set ``peak_flops`` — the peak of ``device`` for the step's math
    mode (:func:`step_math_mode`; 0 for an unknown card, which leaves the
    column off)."""
    dashboard.flops_per_example = sum(flops_by_kind.values()) / max(int(examples), 1)
    if dashboard.peak_flops <= 0.0:
        dashboard.precision = step_math_mode(flops_by_kind)
        dashboard.peak_flops = _auto_peak_flops(dashboard.precision, device)


def mesh_peak_flops(n_devices: int, precision: str = "bf16") -> float:
    """Aggregate peak FLOP/s of ``n_devices`` cards (MFU denominator).

    The numerator counts FLOPs executed across ALL the devices, so the
    denominator must be their aggregate peak — one card's peak would
    report an 8-card run at up to 800% MFU.
    """
    return _auto_peak_flops(precision) * n_devices


def lm_matmul_params(state_dict, drop: frozenset) -> int:
    """6ND numerator: total size of matmul-participating parameters.

    ``state_dict``: a module's ``state_dict()`` (dotted names).  ``drop``:
    top-level names (the part before the first dot) that are gathers, not
    matmuls (the input embedding table when untied, positional
    embeddings).  Shared by every transformer trainer so the MFU accounting
    cannot drift between them.
    """
    return sum(
        int(v.numel())
        for k, v in state_dict.items()
        if k.split(".", 1)[0] not in drop
    )


def trainer_dashboard(dashboard, n_devices: int, precision: str = "bf16") -> "Dashboard":
    """The trainer-ctor idiom in one place: default Dashboard + mesh peak.

    Every trainer calls this instead of repeating the
    default-then-set-peak_flops dance (a caller-provided non-zero
    ``peak_flops`` wins).
    """
    d = dashboard or Dashboard(print_every=0)
    if d.peak_flops <= 0.0:
        d.peak_flops = mesh_peak_flops(n_devices, precision)
        d.precision = precision
    return d


@dataclasses.dataclass
class Dashboard:
    """Per-iteration progress table + JSONL sink.

    Prints rows like the reference scheduler dashboard (iter, time, objective,
    relative delta, examples/sec) and appends machine-readable JSONL.

    MFU: set ``flops_per_example`` (the model's FLOPs per trained example)
    and every row carries ``mfu_pct`` — per-interval model FLOP utilisation
    against ``peak_flops`` (auto-detected for ``precision`` when 0: the
    card's data-sheet peak, none for an unknown card).  Attach a
    :class:`~parameter_server_tpu_torch.utils.trace.Tracer`
    and printed/JSONL rows also carry the host/H2D/device second-attribution
    of everything the trainer recorded spans for (:meth:`attribution`).
    """

    jsonl: Optional[IO[str]] = None
    print_every: int = 10
    #: model FLOPs per example; 0 disables the MFU column.
    flops_per_example: float = 0.0
    #: peak FLOP/s for the MFU denominator; 0 = auto at first use (the
    #: card's peak for ``precision``; an unknown card leaves it 0 and the
    #: MFU column off).
    peak_flops: float = 0.0
    #: the math mode ``peak_flops`` stands for (``bf16``, ``fp16``,
    #: ``tf32`` or ``fp32``; see :func:`float32_math_mode`).
    precision: str = "bf16"
    #: optional span recorder feeding host/H2D/device attribution.
    tracer: Optional[object] = None
    #: optional Van (stacked wrappers fine): rows gain a ``net`` dict of
    #: cumulative transport counters — retransmits, dup_suppressed, gave_up,
    #: injected chaos faults, sent/dropped (see :func:`transport_counters`)
    #: plus derived wire-efficiency fields when a ``CoalescingVan`` is in
    #: the stack: ``bundle_occupancy`` (sub-messages per bundle frame) and
    #: ``frames_per_step`` (per-interval wire frames / iterations — the
    #: number coalescing exists to shrink).  With a ``MeteredVan`` in the
    #: stack, rows also carry ``bytes_per_example`` (cumulative wire bytes
    #: / examples trained — the wire cost of progress) and
    #: ``wire_bytes_per_sec`` (per-interval link throughput).
    transport: Optional[object] = None
    #: optional ``data.prefetch.PrefetchPipeline`` (anything with
    #: ``counters()``): rows gain a ``prefetch`` dict — produced/consumed
    #: block counts and cumulative stall count/seconds (consumer time spent
    #: waiting on the producer; nonzero means ingest is the bottleneck).
    prefetch: Optional[object] = None
    #: optional migration-plane counter source (anything with ``counters()``
    #: — typically a :class:`CounterGroup` over servers/workers/migrator):
    #: rows gain a ``migration`` dict — rows migrated in/out, fenced
    #: (wrong-epoch) rejects, refresh retries, cumulative handoff freeze
    #: seconds — so a live rebalance is visible in the same place as
    #: retransmits and cancels.
    migration: Optional[object] = None
    _start: float = dataclasses.field(default_factory=time.time)
    _last_obj: Optional[float] = None
    _last_t: Optional[float] = None
    _examples: int = 0
    _header_printed: bool = False
    _attr_last: dict = dataclasses.field(default_factory=dict)
    _net_sent_last: int = 0
    _net_iter_last: int = -1
    _net_bytes_last: int = 0
    _net_t_last: Optional[float] = None

    def record(self, iteration: int, objective: float, extra: Optional[dict] = None,
               examples: int = 0, now: Optional[float] = None) -> None:
        """``now``: the tick's shared wall-clock stamp (defaults to a fresh
        ``time.time()``).  Callers that also write a fleet JSONL row this
        tick should capture one stamp and pass it to BOTH this and
        ``FleetMonitor.write_jsonl(wall=...)`` — otherwise every interval
        rate here uses a denominator skewed by however long the other sink's
        dump took."""
        self._examples += examples
        now = time.time() if now is None else now
        rel = (
            (objective - self._last_obj) / abs(self._last_obj)
            if self._last_obj not in (None, 0.0)
            else 0.0
        )
        self._last_obj = objective
        interval = now - (self._last_t if self._last_t is not None else self._start)
        self._last_t = now
        row = {
            "iter": iteration,
            "sec": round(now - self._start, 3),
            "objective": round(float(objective), 6),
            "rel_delta": round(float(rel), 6),
            "examples": self._examples,
            "examples_per_sec": round(self._examples / max(now - self._start, 1e-9), 1),
        }
        mfu = None
        if self.flops_per_example > 0.0 and examples and self.peak_flops <= 0.0:
            self.peak_flops = _auto_peak_flops(self.precision)
        if self.flops_per_example > 0.0 and examples and self.peak_flops > 0.0:
            mfu = (
                self.flops_per_example * examples
                / max(interval, 1e-9)
                / self.peak_flops
            )
            row["mfu_pct"] = round(mfu * 100.0, 4)
        if extra:
            row.update(extra)
        if self.transport is not None:
            net = transport_counters(self.transport)
            if net:
                frames = net.get("coalesce_frames", 0)
                if frames:
                    net["bundle_occupancy"] = round(
                        net.get("coalesce_msgs", 0) / frames, 2
                    )
                sent = net.get("sent")
                if sent is not None:
                    d_iter = iteration - self._net_iter_last
                    if self._net_iter_last >= 0 and d_iter > 0:
                        net["frames_per_step"] = round(
                            (sent - self._net_sent_last) / d_iter, 2
                        )
                    self._net_sent_last = sent
                    self._net_iter_last = iteration
                wire_bytes = net.get("wire_bytes")
                if wire_bytes is not None:
                    # wire efficiency next to examples_per_sec: cumulative
                    # bytes per trained example + per-interval throughput
                    if self._examples:
                        net["bytes_per_example"] = round(
                            wire_bytes / self._examples, 2
                        )
                    if self._net_t_last is not None:
                        net["wire_bytes_per_sec"] = round(
                            (wire_bytes - self._net_bytes_last)
                            / max(now - self._net_t_last, 1e-9),
                            1,
                        )
                    self._net_bytes_last = wire_bytes
                    self._net_t_last = now
                row["net"] = net
        if self.prefetch is not None:
            pf_counters = getattr(self.prefetch, "counters", None)
            if callable(pf_counters):
                try:
                    row["prefetch"] = pf_counters()
                except Exception:  # pragma: no cover — metrics must never
                    pass  # crash training
        if self.migration is not None:
            mig_counters = getattr(self.migration, "counters", None)
            if callable(mig_counters):
                try:
                    row["migration"] = mig_counters()
                except Exception:  # pragma: no cover — metrics must never
                    pass  # crash training
        net_row = row.get("net")
        if net_row is not None:
            # every reject class in one 0-filled sub-dict, so a garbled-wire
            # or fencing storm is visible in the transport section without
            # grepping per-layer counters.  frame/CRC/incarnation rejects
            # come from the van walk; routing fences and cancellation drops
            # live on KVServers / Postoffices — attach them via the
            # ``migration`` CounterGroup to light those two up.
            mig_row = row.get("migration") or {}
            net_row["rejects"] = {
                "frame_rejects": int(net_row.get("frame_rejects", 0)),
                "rejected_corrupt": int(net_row.get("rejected_corrupt", 0)),
                "rejected_stale": int(net_row.get("rejected_stale", 0)),
                "fenced_rejects": int(mig_row.get("fenced_rejects", 0)),
                "cancelled_drops": int(mig_row.get("cancelled_drops", 0)),
            }
        printing = self.print_every and iteration % self.print_every == 0
        if self.tracer is not None and (printing or self.jsonl is not None):
            # interval DELTAS (this row's share), from the tracer's O(1)
            # running totals — not a scan of the span deque, and not a
            # misleading cumulative sum per row
            attr = self.attribution()
            row["spans_s"] = {
                k: round(v - self._attr_last.get(k, 0.0), 4)
                for k, v in attr.items()
                if v - self._attr_last.get(k, 0.0) > 0
            }
            self._attr_last = attr
        if self.jsonl is not None:
            self.jsonl.write(json.dumps(row) + "\n")
            self.jsonl.flush()
        if printing:
            if not self._header_printed:
                print(
                    f"{'iter':>6} {'sec':>8} {'objective':>10} {'rel':>9} "
                    f"{'ex/s':>10} {'mfu%':>8}"
                )
                self._header_printed = True
            mfu_s = f"{mfu * 100:>8.3f}" if mfu is not None else f"{'-':>8}"
            print(
                f"{iteration:>6} {row['sec']:>8.2f} {row['objective']:>10.5f} "
                f"{row['rel_delta']:>9.5f} {row['examples_per_sec']:>10.1f} "
                f"{mfu_s}"
            )

    def attribution(self) -> dict:
        """Cumulative seconds per span name from the attached tracer.

        Trainers record spans named by plane (e.g. ``host.assemble``,
        ``h2d``, ``device.step``, ``kv.push``); this sums their durations so
        a step-time budget — where did the wall clock actually go — rides
        next to the throughput numbers (SURVEY §5 observability).  Uses the
        tracer's O(1) running totals when available (hot-path safe).
        """
        if self.tracer is None:
            return {}
        totals = getattr(self.tracer, "totals", None)
        if callable(totals):
            return totals()
        out: dict = {}
        for name, _start, dur, _tid, _attrs in self.tracer.spans():
            out[name] = out.get(name, 0.0) + dur
        return out

    @property
    def examples_per_sec(self) -> float:
        return self._examples / max(time.time() - self._start, 1e-9)
