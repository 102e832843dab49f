"""A dataset kept on the card: no host-to-device copy inside a step
(counterpart of ``rocket_tpu/data/device_cache.py``).

A map-style dataset small enough for the card's memory is collated once,
uploaded once, and every batch is cut from it on the device:

* the whole collated pytree goes to the device at construction, float
  leaves cast to ``cache_dtype`` on the way when one is given (the
  rounding then happens once, not every step);
* each epoch's order (``loader.epoch_order``, the streaming loader's, so
  both give the same rows) is wrap-filled to whole batches and uploaded
  once per epoch;
* a batch is one ``index_select`` per leaf with a slice of that order,
  all on the device. Unshuffled batches that need no fill are contiguous
  rows: they are a slice of each leaf (a view of the cache; do not write
  into a batch in place).

``skip`` and ``set_epoch`` behave as the streaming loader's, so a resumed
run sees the same batches. The reference yields gather *markers* that its
compiled step turns into rows, to save one dispatch a step; an eager
PyTorch step has nothing to fuse them into, so batches here are rows.
"""

from __future__ import annotations

from collections.abc import Mapping
from typing import Any, Callable, Optional

import numpy as np
import torch

from rocket_tpu_torch.data.collate import to_tensor
from rocket_tpu_torch.data.loader import Batch, epoch_order, num_batches

__all__ = ["DeviceCachedLoader", "pytree_nbytes", "tree_leaves", "tree_map"]


def tree_map(fn: Callable[[Any], Any], tree: Any) -> Any:
    """``fn`` over the leaves of nested dicts, lists and tuples."""
    if isinstance(tree, Mapping):
        return {key: tree_map(fn, value) for key, value in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, value) for value in tree)
    return fn(tree)


def tree_leaves(tree: Any) -> list:
    out: list = []
    tree_map(out.append, tree)
    return out


def pytree_nbytes(tree: Any) -> int:
    """Bytes held by the array leaves (numpy or torch) of ``tree``."""
    total = 0
    for leaf in tree_leaves(tree):
        if isinstance(leaf, torch.Tensor):
            total += leaf.numel() * leaf.element_size()
        elif hasattr(leaf, "nbytes"):
            total += int(leaf.nbytes)
    return total


class DeviceCachedLoader:
    """The ``DataLoader`` interface over a collated pytree held on
    ``device``.

    ``data``: the collated dataset, every leaf an array with the sample
    count as its leading dim: host arrays are uploaded, tensors already on
    ``device`` (another loader's :attr:`cache`) are used as they are.
    ``cache_dtype``: a torch dtype for the float leaves, or None.
    """

    def __init__(self, data: Any, batch_size: int, device, shuffle: bool = False,
                 drop_last: bool = False, seed: int = 0,
                 cache_dtype: Optional[torch.dtype] = None) -> None:
        leaves = tree_leaves(data)
        if not leaves:
            raise ValueError("DeviceCachedLoader: the dataset has no array leaves")
        self._n = int(leaves[0].shape[0])
        if any(int(leaf.shape[0]) != self._n for leaf in leaves):
            raise ValueError("DeviceCachedLoader: the leaves differ in their leading dim")
        self.batch_size = int(batch_size)
        self.shuffle = shuffle
        self.drop_last = drop_last
        self.seed = int(seed)
        self.device = torch.device(device)
        self._epoch = 0
        self._skip = 0

        def upload(leaf):
            t = to_tensor(leaf).to(self.device)
            if cache_dtype is not None and t.is_floating_point():
                t = t.to(cache_dtype)
            return t

        self._cache = tree_map(upload, data)

    @property
    def cache(self):
        """The device-resident dataset, for other loaders over it."""
        return self._cache

    # -- size, epoch, resume ------------------------------------------------

    def __len__(self) -> int:
        return num_batches(self._n, self.batch_size, self.drop_last)

    @property
    def total(self) -> int:
        return len(self)

    def set_epoch(self, epoch: int) -> None:
        self._epoch = int(epoch)

    def skip(self, batches: int) -> None:
        self._skip = int(batches)

    # -- iteration ----------------------------------------------------------

    def __iter__(self):
        # The pending skip belongs to this pass, taken now: a pass that is
        # never advanced (a resumed epoch with no waves left) must not hand
        # it on to the next epoch's.
        skip, self._skip = self._skip, 0
        return self._batches(skip)

    def _batches(self, skip: int):
        count, bs = len(self), self.batch_size
        last_real = self._n - (count - 1) * bs
        contiguous = not self.shuffle and (self.drop_last or self._n % bs == 0)
        if not contiguous:
            order = epoch_order(self._n, self.seed, self._epoch, self.shuffle)
            # The one upload of the epoch: its order, wrap-filled to whole batches.
            perm = torch.from_numpy(np.resize(order, count * bs)).to(self.device)
        for b in range(skip, count):
            if contiguous:
                data = tree_map(lambda leaf: leaf[b * bs:(b + 1) * bs], self._cache)
            else:
                rows = perm[b * bs:(b + 1) * bs]
                data = tree_map(lambda leaf: leaf.index_select(0, rows), self._cache)
            real = last_real if b == count - 1 and not self.drop_last else bs
            yield Batch(data, real, b)

    def close(self) -> None:
        """Nothing to stop (the interface of ``DataLoader.close``)."""
