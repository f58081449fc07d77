"""SPSC shared-memory ring: the colocated-link fast path.

The port's copy of ``parameter_server_tpu/core/shm_ring.py``; the ring
layout and protocol are the same, so a JAX process and a port process on one
host share rings.  Colocated worker<->server links (same host, verified by boot id during the
``__shmneg__`` handshake in ``core/tcp_van.py``) bypass TCP entirely: the
sender writes flat frames (``core/frame.py``) verbatim into an mmap'd
ring file, the receiver decodes with ``frombuffer`` views STRAIGHT OFF the
ring — zero copies end to end.  TCP stays attached as the control/fallback
plane, so chaos, migration, and restart paths are untouched: any doubt
about the ring (full, torn, peer dead) degrades that one frame to TCP.

Layout (one ring per direction; the handshake sets up both)::

    [64-byte header][data region of ``capacity`` bytes]

    header:  0  u32 magic "PSR1"
             4  u32 version
             8  u64 capacity (data-region bytes, multiple of 8)
            16  u64 head   (writer cursor: byte offset into data region)
            24  u64 tail   (reader cursor: published after handler release)
            32  u64 frames written (writer heartbeat for debugging)
            40  u32 closed flag (either side sets; other side tears down)
            44  ..  reserved

    record:  [u32 len][payload][pad to 8]      — always CONTIGUOUS
             [u32 0xFFFFFFFF]                  — wrap marker: jump to 0

Records never straddle the end of the data region: when a record does not
fit in the remaining contiguous space the writer stamps a wrap marker and
continues at offset 0, so every payload is a single contiguous slice and
``frame.decode`` can take zero-copy array views over it.  Offsets stay
8-aligned and ``capacity`` is a multiple of 8, so there is always room for
the 4-byte marker.

SPSC publication protocol (torn-write safety): the writer copies the whole
record (length word first, then payload) into the data region and only then
publishes the new ``head`` with a single aligned 8-byte store.  The reader
never looks past ``head``, so a writer that dies mid-record leaves nothing
visible — the record simply never existed, and the resender retransmits
over TCP once the conn death tears the link down.  x86-TSO store ordering
(plus CPython's opcode-level memcpy for the slice writes) makes the
payload-before-head order hold without fences.

Ordered reclamation: decoded Messages carry ``frombuffer`` views INTO the
ring, and they escape to ``_Endpoint`` inboxes, handler threads, and
``torch.from_numpy`` aliases (which share the buffer and keep its numpy
base alive).  So :meth:`read` does NOT advance the shared ``tail``: it
hands out ``(idx, payload_view)`` and advances only a private cursor; the
receiver in ``core/tcp_van.py`` wraps each record in a uint8 array and ties
:meth:`release`\\ (idx) to its garbage collection (``weakref.finalize``),
which fires only when the LAST view — numpy array or tensor alias — dies.
``tail`` then advances over the longest fully-released prefix; until then
the writer sees that space as occupied and falls back to TCP rather than
overwrite a live view.

A view's death is the end of every HOST read of the slot, not of a device
read: an asynchronous host-to-card copy may still be reading after the
alias it started from is gone.  So no plane on a ring (or in a native
receive buffer) goes to the card straight from its view: the port's
receivers copy it on the host first, into a page-locked staging buffer that
the caching host allocator holds until the copy's CUDA event
(``KVServer._upload_values`` / ``_stack_planes`` / ``_upload_rows``,
``KVWorker.pull_result_device``).  The slot is then free the moment the
handler drops the message.
"""

from __future__ import annotations

import mmap
import os
import struct
import tempfile
import threading
import time
from collections import deque
from typing import Iterable, Optional, Tuple

MAGIC = b"PSR1"
VERSION = 1
HEADER_SIZE = 64
#: wrap marker in the length slot: "no record here, continue at offset 0".
_WRAP = 0xFFFFFFFF
#: default per-direction capacity; a full ring is a per-frame TCP fallback,
#: not an error, so this only needs to cover a burst of in-flight bundles.
DEFAULT_CAPACITY = 4 << 20

_pack_u32 = struct.Struct("<I").pack_into
_unpack_u32 = struct.Struct("<I").unpack_from
_pack_u64 = struct.Struct("<Q").pack_into
_unpack_u64 = struct.Struct("<Q").unpack_from

_OFF_CAPACITY = 8
_OFF_HEAD = 16
_OFF_TAIL = 24
_OFF_FRAMES = 32
_OFF_CLOSED = 40


def ring_dir() -> str:
    """Directory for ring files: /dev/shm when present (true shared memory,
    no writeback), else the tmpdir."""
    return "/dev/shm" if os.path.isdir("/dev/shm") else tempfile.gettempdir()


def boot_id() -> str:
    """Host identity for the colocation handshake: two processes share a
    kernel boot id iff they share a kernel — i.e. an mmap namespace."""
    try:
        with open("/proc/sys/kernel/random/boot_id") as f:
            return f.read().strip()
    except OSError:  # non-Linux dev box: never negotiate shm
        return f"no-boot-id-{os.getpid()}"


class ShmRingError(RuntimeError):
    """Ring file unusable (bad magic/version/size) — negotiate TCP-only."""


class ShmRing:
    """One direction of a colocated link.  Writer creates, reader attaches.

    Thread model: many sender threads may call :meth:`write` (internal
    lock); exactly one reader thread calls :meth:`poll`/:meth:`read`;
    :meth:`release` may be called from any handler thread.
    """

    def __init__(self, path: str, mm: mmap.mmap, *, writer: bool,
                 created: bool) -> None:
        self.path = path
        self._mm = mm
        self._mv = memoryview(mm)
        self._data = self._mv[HEADER_SIZE:]
        self.capacity = _unpack_u64(self._mm, _OFF_CAPACITY)[0]
        self._writer = writer
        self._created = created
        self._lock = threading.Lock()
        # reader-side private cursor + ordered-release bookkeeping
        self._read_pos = _unpack_u64(self._mm, _OFF_TAIL)[0]
        self._next_idx = 0
        self._pending: deque = deque()  # (idx, tail_after_record)
        self._released: set = set()
        # counters (surfaced through TcpVan.counters)
        self.frames_written = 0
        self.bytes_written = 0
        self.frames_read = 0
        self.ring_full = 0
        self._dead = False

    # -- construction --------------------------------------------------------
    @classmethod
    def create(cls, capacity: int = DEFAULT_CAPACITY,
               dir: Optional[str] = None) -> "ShmRing":
        """Writer side: create + size + mmap a fresh ring file."""
        capacity = max(4096, (capacity + 7) & ~7)
        fd, path = tempfile.mkstemp(prefix="psring-", suffix=".shm",
                                    dir=dir or ring_dir())
        try:
            os.ftruncate(fd, HEADER_SIZE + capacity)
            mm = mmap.mmap(fd, HEADER_SIZE + capacity)
        finally:
            os.close(fd)
        mm[0:4] = MAGIC
        _pack_u32(mm, 4, VERSION)
        _pack_u64(mm, _OFF_CAPACITY, capacity)
        _pack_u64(mm, _OFF_HEAD, 0)
        _pack_u64(mm, _OFF_TAIL, 0)
        _pack_u64(mm, _OFF_FRAMES, 0)
        _pack_u32(mm, _OFF_CLOSED, 0)
        return cls(path, mm, writer=True, created=True)

    @classmethod
    def attach(cls, path: str) -> "ShmRing":
        """Reader side: mmap an existing ring file (validates header)."""
        try:
            fd = os.open(path, os.O_RDWR)
        except OSError as e:
            raise ShmRingError(f"cannot open ring {path}: {e}") from e
        try:
            size = os.fstat(fd).st_size
            if size < HEADER_SIZE:
                raise ShmRingError(f"ring {path}: short file ({size} bytes)")
            mm = mmap.mmap(fd, size)
        finally:
            os.close(fd)
        if mm[0:4] != MAGIC or _unpack_u32(mm, 4)[0] != VERSION:
            mm.close()
            raise ShmRingError(f"ring {path}: bad magic/version")
        cap = _unpack_u64(mm, _OFF_CAPACITY)[0]
        if cap % 8 or HEADER_SIZE + cap > size:
            mm.close()
            raise ShmRingError(f"ring {path}: bad capacity {cap}")
        return cls(path, mm, writer=False, created=False)

    # -- shared-header accessors ---------------------------------------------
    @property
    def head(self) -> int:
        return _unpack_u64(self._mm, _OFF_HEAD)[0]

    @property
    def tail(self) -> int:
        return _unpack_u64(self._mm, _OFF_TAIL)[0]

    @property
    def closed(self) -> bool:
        return self._dead or _unpack_u32(self._mm, _OFF_CLOSED)[0] != 0

    def mark_closed(self) -> None:
        """Either side: tell the peer the link is going away."""
        try:
            _pack_u32(self._mm, _OFF_CLOSED, 1)
        except ValueError:  # mmap already closed locally
            pass

    # -- writer side ---------------------------------------------------------
    def _free(self, head: int, tail: int) -> int:
        # one slot always stays unused so head == tail is unambiguous EMPTY
        return (tail - head - 8) % self.capacity

    def write(self, segments: Iterable, total: int,
              timeout: float = 0.0005) -> bool:
        """Copy ``segments`` (bytes-like, summing to ``total``) into the
        ring as one record.  False = no space within ``timeout`` (caller
        falls back to TCP for this frame and counts ``ring_full``).

        The only data movement here is the slice-assign INTO the shared
        mapping — the frame's own buffers are never duplicated host-side
        first (no ``tobytes``/``bytes()`` staging).
        """
        slot = (4 + total + 7) & ~7
        if slot + 8 >= self.capacity:  # cannot ever fit: oversized frame
            return False
        with self._lock:
            if self.closed:
                return False
            head = self.head
            deadline = None
            while True:
                tail = self.tail
                avail_to_end = self.capacity - head
                need = slot if slot <= avail_to_end else avail_to_end + slot
                if self._free(head, tail) >= need:
                    break
                if deadline is None:
                    deadline = time.monotonic() + timeout
                elif time.monotonic() >= deadline:
                    self.ring_full += 1
                    return False
                time.sleep(0.00005)  # reader drains in parallel
                if self.closed:
                    return False
            if slot > avail_to_end:
                # stamp the wrap marker (alignment guarantees >= 8 bytes
                # remain) and restart the record at offset 0
                _pack_u32(self._data, head, _WRAP)
                head = 0
            pos = head + 4
            for seg in segments:
                n = seg.nbytes if isinstance(seg, memoryview) else len(seg)
                self._data[pos:pos + n] = seg
                pos += n
            _pack_u32(self._data, head, total)
            # publish: single aligned u64 store AFTER the record body
            _pack_u64(self._mm, _OFF_HEAD, (head + slot) % self.capacity)
            self.frames_written += 1
            self.bytes_written += total
            _pack_u64(self._mm, _OFF_FRAMES, self.frames_written)
            return True

    # -- reader side ---------------------------------------------------------
    def poll(self, timeout: float) -> bool:
        """True when a record is available (or the ring closed).  Spins
        briefly (hot path: sub-µs wakeup), then sleeps in short ticks."""
        for _ in range(200):
            if self.head != self._read_pos or self.closed:
                return True
        deadline = time.monotonic() + timeout
        tick = 0.0002
        while time.monotonic() < deadline:
            if self.head != self._read_pos or self.closed:
                return True
            time.sleep(tick)
            tick = min(tick * 2, 0.002)
        return self.head != self._read_pos

    def read(self) -> Optional[Tuple[int, memoryview]]:
        """Next record as ``(idx, payload_view)`` — a ZERO-COPY view into
        the mapping — or None when drained.  The shared ``tail`` does not
        move until :meth:`release`\\ (idx) confirms every earlier record's
        handler has finished with its views."""
        while True:
            head = self.head
            pos = self._read_pos
            if pos == head:
                return None
            n = _unpack_u32(self._data, pos)[0]
            if n == _WRAP:
                self._read_pos = 0
                continue
            if 4 + n > self.capacity - pos:  # corrupt length: poison ring
                self.mark_closed()
                return None
            slot = (4 + n + 7) & ~7
            view = self._data[pos + 4:pos + 4 + n]
            self._read_pos = (pos + slot) % self.capacity
            with self._lock:
                idx = self._next_idx
                self._next_idx += 1
                self._pending.append((idx, self._read_pos))
            self.frames_read += 1
            return idx, view

    def release(self, idx: int) -> None:
        """Handler done with record ``idx``: advance the shared ``tail``
        over the longest released prefix (out-of-order completions across
        endpoint threads are held until their predecessors finish)."""
        with self._lock:
            self._released.add(idx)
            advanced = None
            while self._pending and self._pending[0][0] in self._released:
                i, tail_after = self._pending.popleft()
                self._released.discard(i)
                advanced = tail_after
            if advanced is not None:
                try:
                    _pack_u64(self._mm, _OFF_TAIL, advanced)
                except ValueError:  # closed under us; writer is gone anyway
                    pass

    # -- lifecycle -----------------------------------------------------------
    def close(self, unlink: Optional[bool] = None) -> None:
        """Mark closed and drop the mapping.  The creator unlinks the file
        by default; an attached reader leaves it to the creator."""
        self._dead = True
        self.mark_closed()
        # the mmap cannot be closed while exported views (pending records
        # an endpoint handler still holds) are alive; release() bookkeeping
        # is abandoned — the OS reclaims the mapping when the views die.
        try:
            self._data.release()
            self._mv.release()
            self._mm.close()
        except (BufferError, ValueError):
            pass
        if unlink is None:
            unlink = self._created
        if unlink:
            try:
                os.unlink(self.path)
            except OSError:
                pass

    def counters(self) -> dict:
        return {
            "shm_frames_written": self.frames_written,
            "shm_bytes_written": self.bytes_written,
            "shm_frames_read": self.frames_read,
            "shm_ring_full": self.ring_full,
        }
