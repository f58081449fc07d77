"""Trace-context plumbing for the sampled request-tracing plane.

A copy of ``parameter_server_tpu/core/tracectx.py`` (stdlib only).  The
port's :class:`~.coalesce.CoalescingVan` reads :data:`TRACE_KEY` and
:func:`trace_ids` from it, so bundles carry sampled trace ids as the JAX
package's do; request tracing itself (stamping, spans) is not ported yet.

A *trace context* is a tiny dict stamped into a sampled request's payload
under :data:`TRACE_KEY` by the worker at submit time.  It rides the frame
meta plane end to end — through :class:`~.coalesce.CoalescingVan` bundling,
:class:`~.resender.ReliableVan` retransmit/dedup, both wire backends
(TCP/epoll and the shm ring), hierarchical-push leader hops — and is echoed
back on acks/pull replies by the server's copy-on-write reply stamping, so
the worker can close the span tree.

Shape (all keys optional except ``tid``)::

    {"tid": "<origin>/<customer>/<seq>",   # globally unique trace id
     "origin": "<node>", "customer": "<name>",
     "t": <monotonic submit time on the origin node>,
     "rx": <monotonic receive time, stamped by the receiving van>,
     "t_disp": <server dispatch>, "t_reply": <server reply built>}

Sampling is *deterministic and seeded*: whether a given ``tid`` is traced
depends only on ``(tid, seed, sample_every)``, so replays of a seeded run
sample the same requests and two nodes never disagree about a request's
sampling decision.  Unsampled requests carry **no** trace key at all —
zero bytes on the wire, and the int-only fast meta codec stays eligible.

Old peers simply ignore the key (it is plain frame meta), which is what
makes any-order rolling upgrades safe — see MIGRATION.md.
"""

from __future__ import annotations

import zlib
from typing import Any, List, Mapping, Optional

#: Payload key the trace context rides under.
TRACE_KEY = "__trace__"


def sampled(tid: str, seed: int, sample_every: int) -> bool:
    """Deterministic hash-sampling decision for ``tid``.

    ``sample_every <= 0`` disables sampling entirely; ``1`` samples every
    request.  The decision is a pure function of the arguments so every
    node (and every replay of a seeded run) agrees on it.
    """
    if sample_every <= 0:
        return False
    if sample_every == 1:
        return True
    return zlib.crc32(f"{tid}:{seed}".encode()) % sample_every == 0


def trace_ids(payload: Optional[Mapping[str, Any]]) -> List[str]:
    """All sampled trace ids carried by ``payload`` (empty when unsampled).

    Handles both the single-request form (``{"tid": ...}``) and the bundle
    aggregate form (``{"tids": [...]}``) that ``CoalescingVan`` stamps on a
    packed frame.
    """
    if not payload:
        return []
    ctx = payload.get(TRACE_KEY)
    if not isinstance(ctx, dict):
        return []
    tid = ctx.get("tid")
    if tid is not None:
        return [tid]
    tids = ctx.get("tids")
    if isinstance(tids, (list, tuple)):
        return [t for t in tids if t is not None]
    return []
