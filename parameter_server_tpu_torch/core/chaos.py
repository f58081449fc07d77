"""ChaosVan: seeded, deterministic fault injection for any Van.

The port's copy of ``parameter_server_tpu/core/chaos.py``: the same per-link
seeds (``zlib.crc32(f"{seed}:{a}->{b}")``), the same four draws a message and
the same separate corruption stream, so one seed and one send sequence give
the same drops, duplicates, reorders and flipped byte and bit in both
packages.  Torch planes are never corrupted (the JAX module treats its
device arrays so): a message carrying one takes the legacy flip over its
numpy planes only, which keeps the corruption stream's draws aligned.

The reference tolerated lossy asynchronous networks but never shipped a way
to *prove* it: ``script/local.sh`` integration runs exercised the happy path
only (SURVEY.md §4 "opportunity").  This module is the missing harness — a
Van decorator that injects in-flight faults between ``send`` and delivery:

- **drop**: the message is silently lost (the sender still sees ``True`` —
  a real network cannot tell you at send time, which is exactly the failure
  mode the fire-and-forget Van could not express before: ``disconnect`` is
  rejected-at-send, drop is lost-in-flight);
- **latency**: fixed delay plus uniform jitter, delivered via a timer wheel
  so in-order timestamps keep per-link FIFO and jitter breaks it;
- **duplicate**: the message is delivered twice (what a retransmitting
  sender looks like from the receiver's side);
- **reorder**: an extra delay penalty that lets the next message on the
  link overtake this one;
- **partition**: per-link blackholes, asymmetric by default (A can reach B
  while B cannot reach A — the split-brain shape ``disconnect`` cannot
  model);
- **slow** (gray failure): a fixed extra delivery delay, per link
  (``ChaosConfig.slow_ms``) or per NODE (:meth:`ChaosVan.slow_node` slows
  every link INTO the node) — the slow-but-alive shape the ROADMAP names
  as unmodeled.  A slowed node still heartbeats on time, so liveness
  sweeps never fire; only per-link latency attribution
  (``core/netmon.py`` -> ``core/fleet.py``) can see it.  Inbound-only by
  design: a gray node's observable symptom is work queueing at ITS door,
  and metering attributes deliver latency to the destination, so the
  detector's signal lands on the right node.
- **corrupt**: one payload bit flipped in flight, in a COPY of one
  keys/values array (the sender's buffer is a retransmit source and is
  never mutated).  Caught end-to-end by the CRC32 integrity stamp in
  ``core/resender.py`` (``rejected_corrupt``); the dropped ACK makes the
  sender retransmit the pristine original, so recovery is automatic;
- **bandwidth** (``ChaosConfig.bandwidth_bps``): a per-link deterministic
  token bucket over payload bytes — each delivery waits for the link's
  virtual transmit clock, modeling a capped pipe without any RNG draws.

Determinism: every decision comes from a per-link ``random.Random`` keyed
by ``(seed, sender, recver)`` via crc32, and exactly four uniforms are
drawn per message regardless of config, so a fixed seed plus a fixed
per-link send order yields the identical fault sequence run over run.
(Per-link send order is single-threaded everywhere in this codebase —
submitting threads on the requester side, the endpoint recv thread on the
responder side — so seeded chaos tests are reproducible; see
tests/test_chaos.py.)

Pair with :class:`~parameter_server_tpu_torch.core.resender.ReliableVan` *above*
this wrapper (``ReliableVan(ChaosVan(LoopbackVan()))``) to prove exactly-
once delivery under loss.
"""

from __future__ import annotations

import dataclasses
import heapq
import itertools
import logging
import random
import threading
import time
import zlib
from typing import Callable, Dict, Optional, Tuple

import numpy as np
import torch

from parameter_server_tpu_torch.core import flightrec, frame
from parameter_server_tpu_torch.core.messages import Message
from parameter_server_tpu_torch.core.van import Van, VanWrapper


def _owned(a):
    """A writable copy of a decoded plane (numpy, or a torch view of an
    extension dtype such as bfloat16)."""
    return a.clone() if isinstance(a, torch.Tensor) else np.array(a)


def payload_nbytes(msg: Message) -> int:
    """Wire size of a message's bulk payload (keys + values), in bytes.

    Only objects exposing ``nbytes`` count (numpy arrays and torch tensors,
    on the host or the card, read without a device sync); the
    small dict payload is control-plane noise next to them and is ignored,
    which keeps the bandwidth model focused on the data plane.
    """
    size = int(getattr(msg.keys, "nbytes", 0) or 0)
    for v in msg.values:
        size += int(getattr(v, "nbytes", 0) or 0)
    return size


@dataclasses.dataclass(frozen=True)
class ChaosConfig:
    """Per-link fault rates.  All probabilities in [0, 1]; delays in sec."""

    #: P(message silently lost in flight).
    drop: float = 0.0
    #: P(message delivered twice).
    duplicate: float = 0.0
    #: P(message delayed past its successor on the link).
    reorder: float = 0.0
    #: fixed added latency.
    delay: float = 0.0
    #: uniform extra latency in [0, jitter).
    jitter: float = 0.0
    #: penalty added on a reorder hit (must exceed the link's typical
    #: inter-send gap to actually swap adjacent messages).
    reorder_delay: float = 0.01
    #: gray failure: fixed extra delivery delay (milliseconds) on this
    #: link.  Deterministic — no RNG draw — so a slowed link never shifts
    #: the fault sequence of drop/dup/reorder decisions.
    slow_ms: float = 0.0
    #: P(one payload bit flipped in flight).  Draws come from a SEPARATE
    #: per-link RNG stream (keyed ``corrupt:``), so enabling corruption
    #: never shifts the seeded drop/dup/reorder schedule of this or any
    #: other link.  The flip lands in a COPY of one key/value array — the
    #: sender's buffer (a retransmit source) is never touched.
    corrupt: float = 0.0
    #: per-link bandwidth cap in bytes/sec (0 = uncapped): a deterministic
    #: token bucket over payload bytes delays each delivery until the
    #: link's virtual transmit clock frees up.  Zero RNG draws, so seeded
    #: fault schedules are unperturbed; FIFO is preserved (delays are
    #: monotone along a link).
    bandwidth_bps: float = 0.0

    @property
    def randomized(self) -> bool:
        """Any stochastic fault enabled — exactly these configs consume the
        four per-message RNG draws, so adding ``slow_ms`` to a link can
        never shift the seeded fault sequence of any other fault."""
        return not (
            self.drop == 0.0
            and self.duplicate == 0.0
            and self.reorder == 0.0
            and self.delay == 0.0
            and self.jitter == 0.0
        )

    @property
    def inert(self) -> bool:
        return (
            not self.randomized
            and self.slow_ms == 0.0
            and self.corrupt == 0.0
            and self.bandwidth_bps == 0.0
        )


class TimerWheel:
    """Deferred executor: ``schedule(delay, fn)`` runs ``fn`` on one wheel
    thread at ``now + delay``, ordered by (due time, enqueue order) — equal
    delays therefore preserve enqueue order (per-link FIFO under fixed
    latency), while jittered delays reorder, which is the point."""

    def __init__(self, name: str = "chaos-wheel") -> None:
        self._heap: list = []
        self._seq = itertools.count()
        self._cond = threading.Condition()
        self._stopped = False
        self._thread = threading.Thread(
            target=self._run, name=name, daemon=True
        )
        self._thread.start()

    def schedule(self, delay: float, fn: Callable[[], None]) -> None:
        due = time.monotonic() + max(delay, 0.0)
        with self._cond:
            if self._stopped:
                return
            heapq.heappush(self._heap, (due, next(self._seq), fn))
            self._cond.notify()

    def _run(self) -> None:
        while True:
            with self._cond:
                while not self._stopped:
                    if not self._heap:
                        self._cond.wait()
                        continue
                    wait = self._heap[0][0] - time.monotonic()
                    if wait <= 0:
                        break
                    self._cond.wait(wait)
                if self._stopped:
                    return
                _due, _n, fn = heapq.heappop(self._heap)
            try:
                fn()
            except Exception:  # noqa: BLE001 — a bad delivery must not kill
                # the only wheel thread (all later delayed messages would
                # silently never fire)
                logging.getLogger(__name__).exception(
                    "chaos: deferred delivery failed"
                )

    def stop(self) -> None:
        with self._cond:
            self._stopped = True
            self._cond.notify()
        self._thread.join(timeout=5)


class ChaosVan(VanWrapper):
    """Fault-injecting Van decorator.  See module docstring.

    ``send`` always returns True (unless the van is closed): the chaos
    layer models a network that *accepted* the frame — whether it arrives
    is decided in flight.  Inner-van send failures (unbound receiver) are
    swallowed and counted in ``unreachable_drops``, so a dead node looks
    like loss, which is what retransmission layers must survive.
    """

    def __init__(
        self,
        inner: Van,
        *,
        seed: int = 0,
        default: Optional[ChaosConfig] = None,
        links: Optional[Dict[Tuple[str, str], ChaosConfig]] = None,
        drop: float = 0.0,
        duplicate: float = 0.0,
        reorder: float = 0.0,
        delay: float = 0.0,
        jitter: float = 0.0,
        corrupt: float = 0.0,
        bandwidth_bps: float = 0.0,
    ) -> None:
        super().__init__(inner)
        if default is None:
            default = ChaosConfig(
                drop=drop, duplicate=duplicate, reorder=reorder,
                delay=delay, jitter=jitter, corrupt=corrupt,
                bandwidth_bps=bandwidth_bps,
            )
        self.seed = seed
        self.default = default
        self.links: Dict[Tuple[str, str], ChaosConfig] = dict(links or {})
        self._rngs: Dict[Tuple[str, str], random.Random] = {}
        self._partitions: set[Tuple[str, str]] = set()
        self._lock = threading.Lock()
        self._wheel: Optional[TimerWheel] = None
        self._closed = False
        #: injection counters (asserted by the chaos test suite).
        self.injected_drops = 0
        self.injected_dups = 0
        self.injected_reorders = 0
        self.injected_slow = 0
        self.injected_corrupt = 0
        self.bandwidth_delays = 0
        self.partition_drops = 0
        self.unreachable_drops = 0
        self.forwarded = 0
        #: gray failures: node id -> extra inbound delivery delay (seconds).
        self._slow: Dict[str, float] = {}
        #: corruption RNGs live in a SEPARATE per-link stream (keyed
        #: ``corrupt:``) so enabling bit-flips never shifts the seeded
        #: drop/dup/reorder schedule drawn from ``_rng``.
        self._corrupt_rngs: Dict[Tuple[str, str], random.Random] = {}
        #: token bucket: link -> monotonic time its virtual transmit clock
        #: frees up (bandwidth_bps caps).  Deterministic, draw-free.
        self._bw_free: Dict[Tuple[str, str], float] = {}

    # -- configuration -------------------------------------------------------
    def set_link(self, sender: str, recver: str, cfg: ChaosConfig) -> None:
        """Override the fault config for one directed link."""
        with self._lock:
            self.links[(sender, recver)] = cfg

    def config_for(self, link: Tuple[str, str]) -> ChaosConfig:
        with self._lock:
            return self.links.get(link, self.default)

    # -- partitions (asymmetric per directed link) ---------------------------
    def partition(self, a: str, b: str, *, symmetric: bool = False) -> None:
        """Blackhole traffic a -> b (and b -> a when ``symmetric``)."""
        with self._lock:
            self._partitions.add((a, b))
            if symmetric:
                self._partitions.add((b, a))

    def heal(self, a: Optional[str] = None, b: Optional[str] = None) -> None:
        """Heal one directed link, or every partition when called bare."""
        with self._lock:
            if a is None:
                self._partitions.clear()
            else:
                self._partitions.discard((a, b))

    # -- gray failures (slow-but-alive nodes) --------------------------------
    def slow_node(self, node_id: str, slow_ms: float) -> None:
        """Make ``node_id`` a gray failure: every delivery INTO it gains a
        fixed ``slow_ms`` delay (0 heals).  Deterministic — no RNG draws —
        so the seeded fault sequence of every other injector is unchanged.
        The node itself stays alive and heartbeating; only the fleet
        monitor's latency attribution can tell it apart from a healthy one.
        """
        with self._lock:
            if slow_ms <= 0.0:
                self._slow.pop(node_id, None)
            else:
                self._slow[node_id] = slow_ms / 1e3

    # -- send path -----------------------------------------------------------
    def _rng(self, link: Tuple[str, str]) -> random.Random:
        r = self._rngs.get(link)
        if r is None:
            key = zlib.crc32(f"{self.seed}:{link[0]}->{link[1]}".encode())
            r = self._rngs[link] = random.Random(key)
        return r

    def _corrupt_rng(self, link: Tuple[str, str]) -> random.Random:
        r = self._corrupt_rngs.get(link)
        if r is None:
            key = zlib.crc32(
                f"{self.seed}:corrupt:{link[0]}->{link[1]}".encode()
            )
            r = self._corrupt_rngs[link] = random.Random(key)
        return r

    @staticmethod
    def _flip_bit(msg: Message, rng: random.Random) -> Optional[Message]:
        """Return a copy of ``msg`` with one in-flight payload bit flipped.

        The flip operates on the FLAT WIRE BUFFER: the message is encoded
        into its ``core/frame.py`` frame, one bit of the key/value plane
        region is flipped (a uniformly random plane byte — exactly what
        wire corruption does to the bytes a TcpVan carries), and the frame
        is decoded back with ``verify=False`` (a real receiver's header
        plane-CRC would reject the frame at the transport; ChaosVan models
        the residual case that slips past it, which the resender's
        end-to-end ``__rcrc__`` stamp must still catch).  The original
        message object is never touched: it is a retransmit source held by
        the sender's ReliableVan, so in-place mutation would poison every
        future retransmit and make recovery impossible.

        Messages with a torch plane (the card's ``push_device`` planes ride
        by reference) fall back to the legacy direct array-copy flip over
        their numpy planes only, as the JAX module does for device arrays,
        so both packages draw the same corruption sequence.  Returns None
        when nothing is corruptible.
        """
        if (msg.keys is None or isinstance(msg.keys, np.ndarray)) and all(
            isinstance(v, np.ndarray) for v in msg.values
        ):
            try:
                data = frame.encode(msg)
            except frame.FrameError:
                data = None  # uncodable payload object: legacy flip below
            if data is not None:
                info = frame.peek(data)
                if info.planes_len <= 0:
                    return None  # no plane bytes — nothing corruptible
                buf = bytearray(data)
                off = (
                    frame.HEADER_SIZE
                    + info.meta_len
                    + rng.randrange(info.planes_len)
                )
                buf[off] ^= 1 << rng.randrange(8)
                out = frame.decode(bytes(buf), verify=False)
                # decoded arrays are read-only frombuffer views; deliver
                # owned writable copies like any chaos-free receive path
                if out.keys is not None:
                    out.keys = _owned(out.keys)
                out.values = [_owned(v) for v in out.values]
                return out
        candidates = []
        if isinstance(msg.keys, np.ndarray) and msg.keys.nbytes > 0:
            candidates.append(("keys", None))
        for i, v in enumerate(msg.values):
            if isinstance(v, np.ndarray) and v.nbytes > 0:
                candidates.append(("values", i))
        if not candidates:
            return None
        where, idx = candidates[rng.randrange(len(candidates))]
        target = msg.keys if where == "keys" else msg.values[idx]
        corrupted = target.copy()
        flat = corrupted.view(np.uint8).reshape(-1)
        flat[rng.randrange(flat.size)] ^= np.uint8(1 << rng.randrange(8))
        if where == "keys":
            return dataclasses.replace(msg, keys=corrupted)
        values = list(msg.values)
        values[idx] = corrupted
        return dataclasses.replace(msg, values=values)

    def send(self, msg: Message) -> bool:
        if self._closed:
            return False
        link = (msg.sender, msg.recver)
        with self._lock:
            if link in self._partitions:
                self.partition_drops += 1
                return True  # swallowed in flight
            cfg = self.links.get(link, self.default)
            # gray-failure delay: per-node (slow_node) + per-link config;
            # deterministic, consumes no draws
            slow = self._slow.get(msg.recver, 0.0) + cfg.slow_ms / 1e3
            randomized = cfg.randomized
            if randomized:
                # exactly four draws per message, config-independent, so a
                # config tweak cannot shift the fault sequence of later sends
                rng = self._rng(link)
                u_drop = rng.random()
                u_dup = rng.random()
                u_jit = rng.random()
                u_reord = rng.random()
            # corruption draws from its own stream — isolated from the four
            # draws above, so flipping cfg.corrupt on cannot shift the
            # seeded drop/dup/reorder schedule of this or any other link
            corrupt_hit = False
            if cfg.corrupt > 0.0:
                crng = self._corrupt_rng(link)
                corrupt_hit = crng.random() < cfg.corrupt
            # bandwidth cap: deterministic token bucket on payload bytes;
            # delays are monotone along a link (the bucket's free time only
            # advances), so FIFO through the wheel is preserved
            bw_delay = 0.0
            if cfg.bandwidth_bps > 0.0:
                now = time.monotonic()
                start = max(now, self._bw_free.get(link, now))
                done = start + payload_nbytes(msg) / cfg.bandwidth_bps
                self._bw_free[link] = done
                bw_delay = done - now
                if bw_delay > 0.0:
                    self.bandwidth_delays += 1
        if (
            not randomized
            and slow == 0.0
            and not corrupt_hit
            and bw_delay <= 0.0
        ):
            ok = self.inner.send(msg)
            with self._lock:
                if ok:
                    self.forwarded += 1
                else:
                    self.unreachable_drops += 1
            return True
        copies = 1
        latency = slow + bw_delay
        if randomized:
            if u_drop < cfg.drop:
                with self._lock:
                    self.injected_drops += 1
                flightrec.record(
                    "chaos.inject", fault="drop",
                    node=msg.sender, recver=msg.recver,
                )
                return True
            if u_dup < cfg.duplicate:
                copies = 2
                with self._lock:
                    self.injected_dups += 1
                flightrec.record(
                    "chaos.inject", fault="dup",
                    node=msg.sender, recver=msg.recver,
                )
            latency += cfg.delay + u_jit * cfg.jitter
            if u_reord < cfg.reorder:
                latency += cfg.reorder_delay
                with self._lock:
                    self.injected_reorders += 1
                flightrec.record(
                    "chaos.inject", fault="reorder",
                    node=msg.sender, recver=msg.recver,
                )
        if slow > 0.0:
            with self._lock:
                self.injected_slow += 1
        if corrupt_hit:
            flipped = self._flip_bit(msg, crng)
            if flipped is not None:
                msg = flipped
                with self._lock:
                    self.injected_corrupt += 1
                flightrec.record(
                    "chaos.inject", fault="corrupt",
                    node=msg.sender, recver=msg.recver,
                )
        if latency <= 0.0:
            # synchronous path: per-link FIFO preserved exactly (duplicates
            # arrive back to back, like an eager retransmitter)
            for _ in range(copies):
                self._deliver(msg)
            return True
        wheel = self._ensure_wheel()
        for _ in range(copies):
            wheel.schedule(latency, lambda m=msg: self._deliver(m))
        return True

    def _deliver(self, msg: Message) -> None:
        ok = self.inner.send(msg)
        with self._lock:
            if ok:
                self.forwarded += 1
            else:
                self.unreachable_drops += 1

    def _ensure_wheel(self) -> TimerWheel:
        with self._lock:
            if self._wheel is None:
                self._wheel = TimerWheel()
            return self._wheel

    # -- stats / lifecycle ---------------------------------------------------
    def counters(self) -> dict:
        with self._lock:
            return {
                "chaos_drops": self.injected_drops,
                "chaos_dups": self.injected_dups,
                "chaos_reorders": self.injected_reorders,
                "chaos_slow": self.injected_slow,
                "chaos_corrupt": self.injected_corrupt,
                "chaos_bw_delays": self.bandwidth_delays,
                "chaos_partition_drops": self.partition_drops,
                "chaos_unreachable": self.unreachable_drops,
            }

    def close(self) -> None:
        with self._lock:
            self._closed = True
            wheel = self._wheel
            self._wheel = None
        if wheel is not None:
            wheel.stop()
        self.inner.close()
