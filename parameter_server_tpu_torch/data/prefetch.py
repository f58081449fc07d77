"""Overlapped ingest: background batch assembly + H2D into a bounded queue.

Torch counterpart of ``parameter_server_tpu/data/prefetch.py``.  A producer
thread builds host block ``i + 1`` and stages its copy to the card while the
card runs block ``i``; the consumer takes device blocks from a bounded FIFO.

Staging on the card: each numpy array of a block is copied once into pinned
host memory, memoised by the array's identity for as long as the array
lives (a pool of blocks that is cycled, as the bench does, pins each
distinct array once; a pinned buffer is never rewritten, so no copy still in
flight can see it change), then copied to the card with ``non_blocking=True``
on a side stream the pipeline owns, and an event is recorded there.  :meth:`get`
makes the consumer's current stream wait on that event and marks the
tensors as used by it (``record_stream``), so the allocator does not hand
their memory to the next staged block while the consumer still reads it.
On the CPU (``device="cpu"``) staging wraps the arrays as tensors.

Determinism: one producer thread calling ``make_block(0), make_block(1),
...`` in order, one bounded FIFO — consumers see exactly the sequence a
serial loop would produce.  ``depth=2`` is double buffering.  Shutdown is
leak-free: :meth:`close` (or the context manager) stops the producer even
when it is blocked on a full queue, joins the thread, and drains the queue.
"""

from __future__ import annotations

import queue
import threading
import time
import weakref
from typing import Any, Callable, Iterator, List, Optional

import numpy as np
import torch

from parameter_server_tpu_torch.utils.trace import NULL_TRACER

#: queue sentinel: producer finished (``limit`` reached).
_DONE = object()


def host_tensor(arr: np.ndarray) -> torch.Tensor:
    """A CPU tensor on ``arr``'s bytes; uint32 arrays (raw device-hash keys)
    as their int32 view, which the device hash widens back."""
    arr = np.ascontiguousarray(arr)
    if arr.dtype == np.uint32:
        arr = arr.view(np.int32)
    return torch.from_numpy(arr)


def _map_arrays(fn: Callable[[np.ndarray], Any], block: Any) -> Any:
    """``block`` with ``fn`` applied to every numpy array in its tuples,
    lists and dicts; other leaves pass through."""
    if isinstance(block, np.ndarray):
        return fn(block)
    if isinstance(block, (tuple, list)):
        return type(block)(_map_arrays(fn, b) for b in block)
    if isinstance(block, dict):
        return {k: _map_arrays(fn, v) for k, v in block.items()}
    return block


class _Staged:
    """A device block whose copy was enqueued on the pipeline's stream."""

    __slots__ = ("block", "tensors", "event")

    def __init__(self, block: Any, tensors: List[torch.Tensor], event) -> None:
        self.block, self.tensors, self.event = block, tensors, event


class PrefetchPipeline:
    """Double-buffered producer of device-resident input blocks.

    Parameters
    ----------
    make_block:
        ``make_block(i) -> block`` builds the ``i``-th host block (numpy
        arrays in tuples, lists or dicts).  Runs on the producer thread —
        keep all per-block host work (assembly, validation, casting) here.
    depth:
        queue capacity (2 = double buffering).
    limit:
        number of blocks to produce (None = unbounded; the consumer stops
        by closing the pipeline).
    device_put:
        override the H2D stage (default: pinned copy + side-stream transfer
        to ``device``); tests pass an identity to run device-free.
    device:
        where blocks are staged (keyword-only; default ``"cuda"``).
    tracer:
        records ``prefetch.stage`` (the producer building and staging a
        block) and ``prefetch.wait`` (the consumer waiting on an empty
        queue: the time the ``prefetch_stall_s`` counter adds up).
    """

    def __init__(
        self,
        make_block: Callable[[int], Any],
        *,
        depth: int = 2,
        limit: Optional[int] = None,
        device_put: Optional[Callable[[Any], Any]] = None,
        device: str | torch.device = "cuda",
        tracer=None,
    ) -> None:
        if depth < 1:
            raise ValueError(f"prefetch depth must be >= 1, got {depth}")
        self._make_block = make_block
        self._limit = limit
        self.tracer = tracer or NULL_TRACER
        self.device = torch.device(device)
        self._stream = None
        if device_put is None:
            if self.device.type == "cuda":
                self._stream = torch.cuda.Stream(self.device)
                device_put = self._stage_cuda
            else:
                device_put = self._stage_host
        self._device_put = device_put
        #: id(host array) -> (weakref to it, its pinned copy)
        self._pinned: dict = {}
        self._q: "queue.Queue[Any]" = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error: Optional[BaseException] = None
        self._lock = threading.Lock()
        self._produced = 0
        self._consumed = 0
        self._stalls = 0
        self._stall_s = 0.0
        self._thread = threading.Thread(
            target=self._produce, name="prefetch-producer", daemon=True
        )
        self._thread.start()

    # -- staging ------------------------------------------------------------
    def _stage_host(self, block: Any) -> Any:
        return _map_arrays(lambda a: host_tensor(a).to(self.device), block)

    def _pinned_copy(self, arr: np.ndarray) -> torch.Tensor:
        """``arr`` in pinned host memory, pinned once per distinct array.  The
        entry goes when ``arr`` dies; its buffer is then freed, not
        rewritten, and the caching host allocator reuses it only after the
        copies recorded on it have finished."""
        key = id(arr)
        hit = self._pinned.get(key)
        if hit is not None and hit[0]() is arr:
            return hit[1]
        pinned = host_tensor(arr).pin_memory()
        self._pinned[key] = (weakref.ref(arr, lambda _, d=self._pinned: d.pop(key, None)),
                             pinned)
        return pinned

    def _stage_cuda(self, block: Any) -> _Staged:
        tensors: List[torch.Tensor] = []

        def copy(arr: np.ndarray) -> torch.Tensor:
            t = self._pinned_copy(arr).to(self.device, non_blocking=True)
            tensors.append(t)
            return t

        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = _map_arrays(copy, block)
            event = torch.cuda.Event()
            event.record(self._stream)
        return _Staged(out, tensors, event)

    # -- producer -----------------------------------------------------------
    def _produce(self) -> None:
        i = 0
        try:
            while not self._stop.is_set():
                if self._limit is not None and i >= self._limit:
                    self._put(_DONE)
                    return
                with self.tracer.span("prefetch.stage"):
                    block = self._device_put(self._make_block(i))
                if not self._put(block):
                    return  # stopped while waiting on a full queue
                with self._lock:
                    self._produced += 1
                i += 1
        except BaseException as e:  # noqa: BLE001 — surface on the consumer
            self._error = e
            self._put(_DONE)

    def _put(self, item: Any) -> bool:
        """put() that stays responsive to close() on a full queue."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.05)
                return True
            except queue.Full:
                continue
        return False

    # -- consumer -----------------------------------------------------------
    def get(self) -> Any:
        """Next device block; raises StopIteration when ``limit`` blocks
        were consumed.  Time spent waiting on an empty queue is counted as a
        prefetch stall (the producer was the bottleneck).  A block staged on
        the card is ordered after its copy on the caller's current stream."""
        try:
            item = self._q.get_nowait()
        except queue.Empty:
            t0 = time.perf_counter()
            with self.tracer.span("prefetch.wait"):
                item = self._q.get()
            with self._lock:
                self._stalls += 1
                self._stall_s += time.perf_counter() - t0
        if item is _DONE:
            self._q.put(_DONE)  # keep later get()s terminating too
            if self._error is not None:
                raise self._error
            raise StopIteration
        with self._lock:
            self._consumed += 1
        if isinstance(item, _Staged):
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(item.event)
            for t in item.tensors:
                t.record_stream(stream)
            item = item.block
        return item

    def __iter__(self) -> Iterator[Any]:
        while True:
            try:
                yield self.get()
            except StopIteration:
                return

    # -- lifecycle / metrics ------------------------------------------------
    def counters(self) -> dict:
        with self._lock:
            return {
                "prefetch_produced": self._produced,
                "prefetch_consumed": self._consumed,
                "prefetch_stalls": self._stalls,
                "prefetch_stall_s": round(self._stall_s, 4),
            }

    def close(self) -> None:
        """Stop the producer, join it, drain the queue (leak-free)."""
        self._stop.set()
        # unblock a producer stuck in put() by making room
        while True:
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._thread.join(timeout=10)
        while True:  # drain anything the producer squeezed in while dying
            try:
                self._q.get_nowait()
            except queue.Empty:
                break
        self._pinned.clear()

    def __enter__(self) -> "PrefetchPipeline":
        return self

    def __exit__(self, *exc) -> None:
        self.close()
