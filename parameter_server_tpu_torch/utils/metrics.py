"""Metrics and dashboard: AUC, counter merging and per-iteration rows.

Host-side code from ``parameter_server_tpu/utils/metrics.py``: :func:`auc`,
:func:`transport_counters` (the heartbeat's ``net`` stat) and
:class:`CounterGroup` as they are, and :class:`Dashboard` without its
transport, prefetch, migration, tracer and MFU attachments (not ported yet).
"""

from __future__ import annotations

import dataclasses
import json
import time
from typing import IO, Optional

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


@dataclasses.dataclass
class Dashboard:
    """Per-iteration progress table + JSONL sink (iter, time, objective,
    relative delta, examples/sec)."""

    jsonl: Optional[IO[str]] = None
    print_every: int = 10
    _start: float = dataclasses.field(default_factory=time.time)
    _last_obj: Optional[float] = None
    _examples: int = 0
    _header_printed: bool = False

    def record(
        self,
        iteration: int,
        objective: float,
        extra: Optional[dict] = None,
        examples: int = 0,
        now: Optional[float] = None,
    ) -> None:
        self._examples += examples
        now = time.time() if now is None else now
        rel = (
            (objective - self._last_obj) / abs(self._last_obj)
            if self._last_obj not in (None, 0.0)
            else 0.0
        )
        self._last_obj = objective
        row = {
            "iter": iteration,
            "sec": round(now - self._start, 3),
            "objective": round(float(objective), 6),
            "rel_delta": round(float(rel), 6),
            "examples": self._examples,
            "examples_per_sec": round(self._examples / max(now - self._start, 1e-9), 1),
        }
        if extra:
            row.update(extra)
        if self.jsonl is not None:
            self.jsonl.write(json.dumps(row) + "\n")
            self.jsonl.flush()
        if self.print_every and iteration % self.print_every == 0:
            if not self._header_printed:
                print(f"{'iter':>6} {'sec':>8} {'objective':>10} {'rel':>9} {'ex/s':>10}")
                self._header_printed = True
            print(
                f"{iteration:>6} {row['sec']:>8.2f} {row['objective']:>10.5f} "
                f"{row['rel_delta']:>9.5f} {row['examples_per_sec']:>10.1f}"
            )

    @property
    def examples_per_sec(self) -> float:
        return self._examples / max(time.time() - self._start, 1e-9)
