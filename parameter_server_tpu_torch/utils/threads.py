"""Thread fan-out with error propagation.

Every learner runs N worker loops in threads and must surface the first
failure to the caller instead of letting it die with the thread (Python's
default excepthook just prints).  One helper, used by the SGD, dense, and
BCD learners alike.
"""

from __future__ import annotations

import logging
import queue
import threading
from typing import Callable, List, Optional, Sequence


class CallbackExecutor:
    """Small shared pool of daemon threads for completion callbacks.

    ``Customer._finish_locked`` used to spawn one thread per callback;
    under high async push rates that is unbounded thread creation — a
    robustness hazard in its own right.  This executor caps the fan-out at
    ``workers`` lazily-started daemon threads feeding off one queue.

    Callbacks must not block indefinitely on OTHER callbacks (task
    completion itself is driven by Van recv threads, not this pool, so
    waiting on a task inside a callback is safe — waiting on another
    *callback* is not).
    """

    def __init__(self, workers: int = 4, name: str = "ps-callback") -> None:
        self._q: "queue.SimpleQueue" = queue.SimpleQueue()
        #: pool cap (public: tests assert the fan-out stays bounded by it).
        self.workers = workers
        self._name = name
        self._lock = threading.Lock()
        self._started = 0

    def submit(self, fn: Callable, *args) -> None:
        self._q.put((fn, args))
        with self._lock:
            if self._started < self.workers:
                i = self._started
                self._started += 1
                threading.Thread(
                    target=self._run, name=f"{self._name}-{i}", daemon=True
                ).start()

    def _run(self) -> None:
        while True:
            fn, args = self._q.get()
            try:
                fn(*args)
            except Exception:  # noqa: BLE001 — a bad callback must not kill
                # a shared pool thread
                logging.getLogger(__name__).exception(
                    "callback executor: callback raised"
                )


#: process-wide executor shared by every Customer (the "single shared
#: daemon executor" replacing thread-per-callback spawns).
CALLBACKS = CallbackExecutor()


class ErrorGroup:
    """Collects exceptions from spawned threads; re-raises the first."""

    def __init__(self) -> None:
        self._errors: List[BaseException] = []
        self._lock = threading.Lock()

    def spawn(self, fn: Callable, *args, name: Optional[str] = None) -> threading.Thread:
        def guarded() -> None:
            try:
                fn(*args)
            except BaseException as e:
                with self._lock:
                    self._errors.append(e)

        t = threading.Thread(target=guarded, name=name)
        t.start()
        return t

    def check(self) -> None:
        """Raise the first recorded error, if any."""
        with self._lock:
            if self._errors:
                raise self._errors[0]


def run_threads(
    targets: Sequence[Callable[[], None]],
    *,
    name: str = "worker",
) -> None:
    """Run callables in parallel threads; join all; raise the first error."""
    group = ErrorGroup()
    threads = [
        group.spawn(fn, name=f"{name}-{i}") for i, fn in enumerate(targets)
    ]
    for t in threads:
        t.join()
    group.check()
