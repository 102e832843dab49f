"""Batch reads in worker processes (counterpart of
``rocket_tpu/data/workers.py``): the streaming loader's ``num_workers``.

* Workers start by ``forkserver`` where the platform has it, else by
  ``spawn`` (:func:`default_start_method`). A parent that has initialised
  CUDA must not ``fork``: the child would inherit a CUDA context it cannot
  use. ``start_method="fork"`` stays selectable for datasets that cannot
  be pickled, with that risk.
* Workers never touch CUDA: each hides the cards from itself
  (``CUDA_VISIBLE_DEVICES=""``) before it reads a sample. They return
  host batches; the copy to the card is the consumer's.
* Index batches go out ``2 * num_workers`` ahead and their results come
  back in the order they went out, so the batches equal the serial
  loader's.
* Each worker reseeds numpy's and Python's global generators from
  ``(seed, worker id)``, so random augmentations in ``__getitem__`` differ
  between workers.
"""

from __future__ import annotations

import multiprocessing
import os
import random
from collections import deque
from concurrent.futures import ProcessPoolExecutor
from typing import Any, Callable, Iterable, Iterator, Optional

import numpy as np

__all__ = ["WorkerPool", "default_start_method"]

#: Set once in each worker by :func:`_start_worker`.
_DATASET: Any = None
_COLLATE: Optional[Callable] = None


def default_start_method() -> str:
    """``"forkserver"`` where available (POSIX), else ``"spawn"``."""
    return "forkserver" if "forkserver" in multiprocessing.get_all_start_methods() else "spawn"


def _start_worker(dataset, collate, seed: int, next_id) -> None:
    global _DATASET, _COLLATE
    os.environ["CUDA_VISIBLE_DEVICES"] = ""
    _DATASET, _COLLATE = dataset, collate
    with next_id.get_lock():
        worker_id = next_id.value
        next_id.value += 1
    np_seed, py_seed = np.random.SeedSequence([seed, worker_id, 0xF0C]).generate_state(2)
    np.random.seed(int(np_seed))
    random.seed(int(py_seed))


def _read(indices) -> Any:
    get_batch = getattr(_DATASET, "get_batch", None)
    if get_batch is not None:
        return get_batch(indices)
    return _COLLATE([_DATASET[int(i)] for i in indices])


class WorkerPool:
    """``num_workers`` processes that read collated batches by index list.
    Made on first use by a ``DataLoader``, kept across epochs, stopped by
    :meth:`close`."""

    def __init__(self, dataset, collate, num_workers: int, start_method: Optional[str] = None,
                 seed: int = 0) -> None:
        if num_workers < 1:
            raise ValueError(f"WorkerPool: num_workers must be >= 1, got {num_workers}")
        self.num_workers = num_workers
        self.start_method = start_method or default_start_method()
        ctx = multiprocessing.get_context(self.start_method)
        self._pool = ProcessPoolExecutor(max_workers=num_workers, mp_context=ctx,
                                         initializer=_start_worker,
                                         initargs=(dataset, collate, seed, ctx.Value("i", 0)))

    def imap(self, index_batches: Iterable) -> Iterator[Any]:
        """Each index batch read in a worker, yielded in submission order
        with up to ``2 * num_workers`` in flight."""
        lookahead = 2 * self.num_workers
        pending: deque = deque()
        source = iter(index_batches)
        exhausted = False
        while True:
            while not exhausted and len(pending) < lookahead:
                try:
                    pending.append(self._pool.submit(_read, next(source)))
                except StopIteration:
                    exhausted = True
            if not pending:
                return
            yield pending.popleft().result()

    def close(self) -> None:
        self._pool.shutdown(wait=False, cancel_futures=True)

    def __del__(self) -> None:
        try:
            self.close()
        except Exception:  # noqa: BLE001 — interpreter teardown
            pass
