"""Host-side batching with the reference's epoch order and resume
(counterpart of ``rocket_tpu/data/loader.py``).

* ``batch_size`` is the global batch: each of ``process_count``
  processes reads only its stripe, rows ``[lo, lo + stripe)`` of every
  global batch (``stripe = batch_size // process_count``, ``lo =
  process_index * stripe``; ``batch_size`` must divide), so the ranks'
  stripes laid end to end are the one-process batch;
* the epoch's order is ``np.arange(n)``, shuffled (when asked) by
  ``default_rng(SeedSequence([seed, epoch, 0x90C3E7]))`` — the same order
  both packages and both loaders here (streaming and device-resident) use;
* a short last batch (``drop_last=False``) is filled up to ``batch_size``
  with the first rows of the epoch's order, tiled when the dataset is
  shorter than the fill, so every rank's stripe has one shape, and its
  ``size`` says how many rows of the global batch are real;
* ``skip(n)`` makes the next pass start at batch ``n`` (a mid-epoch
  resume), ``set_epoch`` picks the epoch's order;
* an iterable dataset (no ``__len__``/``__getitem__``) is batched in the
  order it yields, striped over the processes sample by sample; its short
  last batch is filled by repeating its own rows in one process and
  dropped with several (the ranks could not agree on it).
"""

from __future__ import annotations

from typing import Any, Callable, Iterator, Optional, Sequence

import numpy as np

from rocket_tpu_torch.data.collate import default_collate

__all__ = ["Batch", "DataLoader", "epoch_order", "num_batches", "batch_indices"]

#: The third word of every epoch's shuffle seed, as in the reference.
SHUFFLE_SALT = 0x90C3E7


class Batch:
    """One batch: ``data`` (the collated pytree), ``size`` (its real rows;
    the rest are fill) and ``index`` (its position in the epoch)."""

    __slots__ = ("data", "size", "index")

    def __init__(self, data: Any, size: int, index: int) -> None:
        self.data = data
        self.size = size
        self.index = index


def epoch_order(n: int, seed: int, epoch: int, shuffle: bool) -> np.ndarray:
    """The sample order of one epoch."""
    order = np.arange(n)
    if shuffle:
        np.random.default_rng(np.random.SeedSequence([seed, epoch, SHUFFLE_SALT])).shuffle(order)
    return order


def num_batches(n: int, batch_size: int, drop_last: bool) -> int:
    return n // batch_size if drop_last else -(-n // batch_size)


def batch_indices(order: np.ndarray, batch_size: int, drop_last: bool, skip: int = 0,
                  process_index: int = 0, process_count: int = 1):
    """``(indices, real, b)`` for each batch ``b`` from ``skip`` on: the
    rows of process ``process_index``'s stripe of a global batch of
    ``batch_size`` rows, a short last one filled from the start of
    ``order`` (tiled by ``np.resize``); ``real`` counts the global batch's
    real rows."""
    stripe = batch_size // process_count
    lo = process_index * stripe
    for b in range(skip, num_batches(len(order), batch_size, drop_last)):
        idx = order[b * batch_size:(b + 1) * batch_size]
        real = len(idx)
        if real < batch_size:
            idx = np.concatenate([idx, np.resize(order, batch_size - real)])
        yield idx[lo:lo + stripe], real, b


class DataLoader:
    """Batches of a map-style or iterable ``dataset`` (module docstring).

    ``collate_fn`` builds a batch from a list of samples
    (:func:`~rocket_tpu_torch.data.collate.default_collate` by default); a
    map-style dataset with ``get_batch(indices)`` builds its own batches
    instead. ``num_workers`` > 0 reads and collates map-style batches in
    that many worker processes (``data/workers.py``), in order.
    """

    def __init__(self, dataset: Any, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False,
                 collate_fn: Optional[Callable[[Sequence[Any]], Any]] = None, seed: int = 0,
                 process_index: int = 0, process_count: int = 1,
                 num_workers: int = 0, worker_start_method: Optional[str] = None) -> None:
        if batch_size < 1:
            raise ValueError(f"DataLoader: batch_size must be >= 1, got {batch_size}")
        if process_count > 1 and batch_size % process_count != 0:
            raise ValueError(f"DataLoader: global batch_size {batch_size} must divide evenly "
                             f"over {process_count} processes.")
        if not 0 <= process_index < process_count:
            raise ValueError(f"DataLoader: process_index {process_index} is not one of "
                             f"{process_count} processes")
        self.process_index = int(process_index)
        self.process_count = int(process_count)
        self.dataset = dataset
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.collate_fn = collate_fn or default_collate
        self.seed = int(seed)
        self.map_style = hasattr(dataset, "__len__") and hasattr(dataset, "__getitem__")
        if not self.map_style and not hasattr(dataset, "__iter__"):
            raise TypeError(f"DataLoader: {type(dataset).__name__} is neither map-style nor "
                            "iterable")
        self.num_workers = int(num_workers)
        if self.num_workers and not self.map_style:
            raise ValueError("DataLoader: num_workers needs a map-style dataset "
                             "(__len__ and __getitem__)")
        self.worker_start_method = worker_start_method
        self._pool = None
        self._epoch = 0
        self._skip = 0

    # -- size, epoch, resume ------------------------------------------------

    def __len__(self) -> int:
        """Batches per epoch; a dataset without a length raises TypeError."""
        return num_batches(len(self.dataset), self.batch_size, self.drop_last)

    @property
    def total(self) -> Optional[int]:
        """Batches per epoch, or None for a dataset without a length."""
        return len(self) if hasattr(self.dataset, "__len__") else None

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def skip(self, batches: int) -> None:
        """Start the next pass at batch ``batches`` without reading the ones
        before it (map-style) or reading and dropping them (iterable)."""
        self._skip = int(batches)

    # -- iteration ----------------------------------------------------------

    def __iter__(self) -> Iterator[Batch]:
        skip, self._skip = self._skip, 0
        if not self.map_style:
            return self._iterable_batches(skip)
        order = epoch_order(len(self.dataset), self.seed, self._epoch, self.shuffle)
        plan = batch_indices(order, self.batch_size, self.drop_last, skip, self.process_index,
                             self.process_count)
        if self.num_workers:
            return self._worker_batches(plan)
        return self._serial_batches(plan)

    def _load(self, idx: np.ndarray):
        get_batch = getattr(self.dataset, "get_batch", None)
        if get_batch is not None:
            return get_batch(idx)
        return self.collate_fn([self.dataset[int(i)] for i in idx])

    def _serial_batches(self, plan) -> Iterator[Batch]:
        for idx, real, b in plan:
            yield Batch(self._load(idx), real, b)

    def _worker_batches(self, plan) -> Iterator[Batch]:
        if self._pool is None:
            from rocket_tpu_torch.data.workers import WorkerPool

            self._pool = WorkerPool(self.dataset, self.collate_fn, self.num_workers,
                                    start_method=self.worker_start_method, seed=self.seed)
        meta = []

        def indices():
            for idx, real, b in plan:
                meta.append((real, b))
                yield idx

        for data in self._pool.imap(indices()):
            real, b = meta.pop(0)
            yield Batch(data, real, b)

    def _iterable_batches(self, skip: int) -> Iterator[Batch]:
        stripe = self.batch_size // self.process_count
        rows: list = []
        b = 0
        trailing = 0  # samples of the (possibly partial) last batch
        for item, sample in enumerate(self.dataset):
            slot = item % self.batch_size
            trailing = slot + 1
            if slot // stripe == self.process_index:
                rows.append(sample)
            if slot == self.batch_size - 1:
                if b >= skip:
                    yield Batch(self.collate_fn(rows), self.batch_size, b)
                rows, b, trailing = [], b + 1, 0
        if trailing and not self.drop_last and self.process_count == 1 and b >= skip:
            real = len(rows)
            rows = [rows[i % real] for i in range(self.batch_size)]
            yield Batch(self.collate_fn(rows), real, b)

    def close(self) -> None:
        """Stop the worker processes, if any."""
        pool, self._pool = self._pool, None
        if pool is not None:
            pool.close()
