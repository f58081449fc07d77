"""MeteredVan: per-link wire accounting for any Van stack.

The port's copy of the accounting half of ``parameter_server_tpu/core/
netmon.py``.  A Van decorator: per directed link (sender -> recver) it
records message counts, payload bytes (keys + values nbytes, read off numpy
arrays and tensors alike, no device sync), the same split per verb (PUSH,
PULL, CONTROL: the group plane's inbound PUSH requests and bytes), and two
latency distributions in mergeable
:class:`~parameter_server_tpu_torch.utils.trace.LatencyHistogram`\\ s:

- **send**: the wall time of the inner ``send`` call;
- **deliver**: send-stamp to receive-side delivery, measured by stamping
  ``time.monotonic()`` into ``Task.payload`` (``__mts__``) on the way out and
  stripping it in a receive wrapper on the way in.

Besides the payload ``bytes`` each link counts ``frame_bytes``, the exact
flat-frame size of the message as sent (planes plus the 52-byte header and
the meta section, sized by ``core/frame.py::frame_nbytes`` without building
the frame), its non-plane share ``overhead_bytes``, and ``raw_bytes``: the
payload before a lossy wire codec (its ``COMPRESSED_KEY`` marker's
``saved``), equal to ``bytes`` on uncompressed links.  All are the JAX
package's counts for the same traffic.

Stack position: OUTERMOST — ``MeteredVan(ReliableVan(ChaosVan(base)))`` — so
each logical message is counted once (retransmits and ACKs happen below),
or under a ``CoalescingVan`` to count each bundle member's verb as sent.
"""

from __future__ import annotations

import threading
import time
from typing import Callable, Dict, Optional, Tuple

import numpy as np

from parameter_server_tpu_torch.core import flightrec, frame
from parameter_server_tpu_torch.core.messages import Message, Task
from parameter_server_tpu_torch.core.van import Van, VanWrapper
from parameter_server_tpu_torch.utils.trace import LatencyHistogram

#: payload key carrying the send-side monotonic stamp (stripped on receive).
STAMP_KEY = "__mts__"


def payload_nbytes(msg: Message) -> int:
    """Payload bytes of one message: keys nbytes + each value's nbytes
    (task metadata is not counted)."""
    total = 0
    if msg.keys is not None:
        total += int(msg.keys.nbytes)
    for v in msg.values:
        nb = getattr(v, "nbytes", None)
        if nb is None:
            nb = np.asarray(v).nbytes
        total += int(nb)
    return total


class _LinkStats:
    """Counters + histograms for one directed link."""

    __slots__ = ("msgs", "bytes", "raw_bytes", "frame_bytes",
                 "overhead_bytes", "verbs", "send", "deliver")

    def __init__(self) -> None:
        self.msgs = 0
        self.bytes = 0
        #: payload bytes before a lossy wire codec (``bytes`` plus its saving)
        self.raw_bytes = 0
        #: exact flat-frame size: planes plus the fixed header and meta
        self.frame_bytes = 0
        #: the non-plane share of ``frame_bytes`` (header + meta)
        self.overhead_bytes = 0
        #: per-verb split of msgs/bytes: ``{"PUSH": [msgs, bytes], ...}``
        self.verbs: Dict[str, list] = {}
        self.send = LatencyHistogram()
        self.deliver = LatencyHistogram()

    def digest(self) -> dict:
        return {
            "msgs": self.msgs,
            "bytes": self.bytes,
            "raw_bytes": self.raw_bytes,
            "frame_bytes": self.frame_bytes,
            "overhead_bytes": self.overhead_bytes,
            "verbs": {v: {"msgs": c[0], "bytes": c[1]} for v, c in self.verbs.items()},
            "send": self.send.to_dict(),
            "deliver": self.deliver.to_dict(),
        }


class MeteredVan(VanWrapper):
    """Wire-accounting Van decorator.  See module docstring.

    ``stamp=False`` disables the payload timestamp (and with it deliver
    latency) for stacks whose messages must round-trip byte-identical.
    """

    def __init__(self, inner: Van, *, stamp: bool = True) -> None:
        super().__init__(inner)
        self._stamp = stamp
        self._lock = threading.Lock()
        self._links: Dict[Tuple[str, str], _LinkStats] = {}
        self.undeliverable = 0
        #: per-sender clock correction (seconds) added to raw deliver
        #: latencies; in-process stacks share one clock (offset 0)
        self._clock_offsets: Dict[str, float] = {}

    def set_clock_offset(self, sender: str, offset_s: float) -> None:
        """Correct deliver latencies for frames FROM ``sender`` by its
        monotonic clock minus this process's."""
        with self._lock:
            if offset_s == 0.0:
                self._clock_offsets.pop(sender, None)
            else:
                self._clock_offsets[sender] = offset_s

    def _link(self, sender: str, recver: str) -> _LinkStats:
        st = self._links.get((sender, recver))
        if st is None:
            st = self._links[(sender, recver)] = _LinkStats()
        return st

    # -- send path -----------------------------------------------------------
    def send(self, msg: Message) -> bool:
        nbytes = payload_nbytes(msg)
        saved = 0
        p = msg.task.payload
        if isinstance(p, dict):
            wc = p.get(frame.COMPRESSED_KEY)
            if isinstance(wc, dict):
                saved = int(wc.get("saved", 0))
        out = msg
        if self._stamp:
            # direct constructors, not dataclasses.replace (per-message hot path)
            t = msg.task
            out = Message(
                task=Task(
                    kind=t.kind, customer=t.customer, time=t.time,
                    wait_time=t.wait_time,
                    payload={**t.payload, STAMP_KEY: time.monotonic()},
                ),
                sender=msg.sender, recver=msg.recver, keys=msg.keys,
                values=msg.values, is_request=msg.is_request,
            )
        # exact wire framing for this message as sent (with the __mts__
        # stamp just added); resender stamps added below ride the fixed
        # header, so they add no meta bytes
        try:
            fbytes, obytes = frame.frame_nbytes(out)
        except frame.FrameError:  # uncodable payload object (in-process only)
            fbytes, obytes = nbytes + frame.HEADER_SIZE, frame.HEADER_SIZE
        t0 = time.perf_counter()
        ok = self.inner.send(out)
        dt = time.perf_counter() - t0
        verb = msg.task.kind.name
        with self._lock:
            st = self._link(msg.sender, msg.recver)
            st.msgs += 1
            st.bytes += nbytes
            st.raw_bytes += nbytes + saved
            st.frame_bytes += fbytes
            st.overhead_bytes += obytes
            vb = st.verbs.get(verb)
            if vb is None:
                vb = st.verbs[verb] = [0, 0]
            vb[0] += 1
            vb[1] += nbytes
            st.send.record(dt)
            if not ok:
                self.undeliverable += 1
        flightrec.record(
            "frame.send", node=msg.sender, recver=msg.recver,
            verb=verb, bytes=nbytes, ok=ok,
        )
        return ok

    # -- receive path --------------------------------------------------------
    def bind(self, node_id: str, handler: Callable[[Message], None]) -> None:
        def metered(msg: Message) -> None:
            payload = msg.task.payload
            ts = payload.get(STAMP_KEY) if isinstance(payload, dict) else None
            if ts is not None:
                # strip the stamp before delivery: replies share the Task
                # (msg.reply()), so a leaked stamp would ride the response
                t = msg.task
                stripped = dict(payload)
                del stripped[STAMP_KEY]
                msg = Message(
                    task=Task(
                        kind=t.kind, customer=t.customer, time=t.time,
                        wait_time=t.wait_time, payload=stripped,
                    ),
                    sender=msg.sender, recver=msg.recver, keys=msg.keys,
                    values=msg.values, is_request=msg.is_request,
                )
                with self._lock:
                    correction = self._clock_offsets.get(msg.sender, 0.0)
                    lat = time.monotonic() - ts + correction
                    self._link(msg.sender, msg.recver).deliver.record(lat)
                flightrec.record(
                    "frame.recv", node=msg.recver, sender=msg.sender,
                    verb=msg.task.kind.name, deliver_ms=round(1e3 * lat, 3),
                )
            handler(msg)

        self.inner.bind(node_id, metered)

    # -- accounting ----------------------------------------------------------
    def counters(self) -> dict:
        """Numeric totals (the JAX van's ``wire_*`` keys this port meters)."""
        with self._lock:
            return {
                "wire_msgs": sum(st.msgs for st in self._links.values()),
                "wire_bytes": sum(st.bytes for st in self._links.values()),
                "wire_raw_bytes": sum(st.raw_bytes for st in self._links.values()),
                "wire_frame_bytes": sum(st.frame_bytes for st in self._links.values()),
                "wire_overhead_bytes": sum(st.overhead_bytes for st in self._links.values()),
                "wire_links": len(self._links),
                "wire_undeliverable": self.undeliverable,
            }

    def links(self) -> Dict[str, dict]:
        """Per-link digests keyed ``"sender->recver"`` (JSON-safe)."""
        with self._lock:
            return {f"{s}->{r}": st.digest() for (s, r), st in self._links.items()}

    def node_digests(self, node_id: str) -> Dict[str, dict]:
        """The links ``node_id`` originated (its heartbeat contribution)."""
        with self._lock:
            return {
                f"{s}->{r}": st.digest()
                for (s, r), st in self._links.items()
                if s == node_id
            }


def find_metered(van) -> Optional[MeteredVan]:
    """First MeteredVan in a wrapper stack (``.inner`` walk), or None."""
    seen = set()
    v = van
    while v is not None and id(v) not in seen:
        seen.add(id(v))
        if isinstance(v, MeteredVan):
            return v
        v = getattr(v, "inner", None)
    return None
