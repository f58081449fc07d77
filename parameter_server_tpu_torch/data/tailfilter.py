"""Count-min tail filtering of sparse key streams.

The port's copy of ``parameter_server_tpu/data/tailfilter.py`` (host
numpy): the same stream and seed mask the same positions.

Reference role: DARLIN's preprocessing drops tail features seen fewer than
``k`` times before training (countmin filter over the key stream —
``src/util/countmin.h`` + the linear-method preprocess stage [U]); the OSDI
paper credits this (with the KKT filter) for a large chunk of the traffic
reduction on 65 B-feature CTR data.  Billion-row DLRM tables have the same
shape of problem: most keys occur once or twice and their rows are pure
noise plus wasted pulls.

:class:`TailFilteredStream` applies the same idea online: a count-min
sketch counts arrivals; keys whose estimated frequency is below the
threshold are replaced with ``PAD_KEY`` — positions that localize to the
trash row, contribute zero to logits, and receive no updates.  The filter
is conservative (count-min never undercounts, so a frequent key is never
dropped) and warms up: early occurrences of eventually-frequent keys pass
once their count crosses the threshold.
"""

from __future__ import annotations

from typing import Callable, Iterator, Tuple

import numpy as np

from parameter_server_tpu_torch.utils.countmin import CountMin
from parameter_server_tpu_torch.utils.keys import PAD_KEY

Batch = Tuple[np.ndarray, ...]  # (keys [B, nnz], ...rest passthrough)


class TailFilteredStream:
    """Wrap a batch source; mask tail keys (est. count < threshold) to PAD.

    ``batch_fn`` returns ``(keys, *rest)``; only ``keys`` is rewritten.
    Statistics: ``seen``/``masked`` position counters -> ``masked_fraction``.
    """

    def __init__(
        self,
        batch_fn: Callable[[], Batch],
        threshold: int,
        *,
        width: int = 1 << 20,
        depth: int = 4,
        seed: int = 0,
    ) -> None:
        if threshold < 1:
            raise ValueError(f"threshold must be >= 1, got {threshold}")
        self.batch_fn = batch_fn
        self.threshold = threshold
        self.sketch = CountMin(width=width, depth=depth, seed=seed)
        self.seen = 0
        self.masked = 0

    def __call__(self) -> Batch:
        keys, *rest = self.batch_fn()
        keys = np.asarray(keys, dtype=np.uint64)
        real = keys != PAD_KEY
        flat = keys[real]
        # count first, then filter: a key's own arrivals in this batch count
        # toward its threshold (so threshold=1 passes everything)
        self.sketch.add(flat)
        keep = self.sketch.filter(flat, self.threshold)
        out = keys.copy()
        vals = out[real]
        vals[~keep] = PAD_KEY
        out[real] = vals
        self.seen += int(flat.size)
        self.masked += int((~keep).sum())
        return (out, *rest)

    @property
    def masked_fraction(self) -> float:
        return self.masked / max(self.seen, 1)

    def __iter__(self) -> Iterator[Batch]:
        while True:
            yield self()
