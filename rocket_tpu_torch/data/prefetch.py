"""Read-ahead of host batches on a background thread (counterpart of
``rocket_tpu/data/prefetch.py``).

A daemon thread walks the loader ``depth`` batches ahead of the training
loop through a bounded queue, so reading and collating the next batch
overlaps the current step. The thread does host work only: the copy to
the card stays on the consumer thread (``core/dataset.py``), in the
stream order of the step that uses it, as the reference requires.
"""

from __future__ import annotations

import queue
import threading
from typing import Any, Iterable, Iterator

__all__ = ["PrefetchIterator"]


class PrefetchIterator:
    """Iterate ``iterable`` on a daemon thread, up to ``depth`` items ahead.

    An exception raised while iterating is raised again by the consumer's
    ``next``. ``close`` stops the thread and drops what is queued;
    exhaustion and an error close it too.
    """

    _END = object()

    def __init__(self, iterable: Iterable[Any], depth: int = 2) -> None:
        if depth < 1:
            raise ValueError(f"PrefetchIterator: depth must be >= 1, got {depth}")
        self._source = iterable
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._thread = threading.Thread(target=self._run, name="rocket-tpu-torch-prefetch",
                                        daemon=True)
        self._thread.start()

    def _run(self) -> None:
        try:
            for item in self._source:
                if not self._offer(item):
                    return
            self._offer(self._END)
        except BaseException as exc:  # noqa: BLE001 — handed to the consumer, who raises it
            self._offer(exc)

    def _offer(self, item: Any) -> bool:
        """Queue ``item``, waiting for room; False once ``close`` was called."""
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def __iter__(self) -> Iterator[Any]:
        return self

    def __next__(self) -> Any:
        if self._stop.is_set():
            raise StopIteration
        item = self._queue.get()
        if item is self._END:
            self.close()
            raise StopIteration
        if isinstance(item, BaseException):
            self.close()
            raise item
        return item

    def close(self) -> None:
        """Stop the thread and drop the queued items."""
        self._stop.set()
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        if self._thread.is_alive() and self._thread is not threading.current_thread():
            self._thread.join(timeout=5.0)

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
