"""Dataset capsule — produce-if-absent batch source for a Looper phase
(counterpart of ``rocket_tpu/core/dataset.py``).

* wraps an indexable source (``__len__`` and ``__getitem__``, or a
  vectorized ``get_batch(indices)``) in batches of ``batch_size``, in
  order or shuffled, with the reference ``DataLoader``'s index math
  (``rocket_tpu/data/loader.py``): the shuffle is numpy's
  ``default_rng(SeedSequence([seed, epoch, 0x90C3E7])).shuffle``, and a
  short trailing batch (``drop_last=False``) is wrap-padded up to
  ``batch_size`` with the first rows of the epoch's order, its
  ``batch_info.size`` the real count — so both packages yield the same
  batches at the same seed;
* ``set()`` makes the epoch's iterator (fast-forwarding a mid-epoch
  resume when training) and exposes the batch total for the Looper;
* ``launch()`` fills ``attrs.batch`` only when it is ``None``; on
  exhaustion it sets ``attrs.looper.terminate``; otherwise it collates
  the samples into a dict of tensors on the runtime's device.

The device-resident cache, the prefetch thread and worker processes of
the reference wait for later slices (ROADMAP Queue A 2). The Module
trains on the padded rows, as the reference does; the Meter trims them
by ``batch_info.size``.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import Capsule

__all__ = ["Dataset", "default_collate"]


def default_collate(samples: list):
    """Stack a list of samples (arrays, numbers or dicts of them) along a
    new leading batch dim into numpy arrays."""
    first = samples[0]
    if isinstance(first, dict):
        return {k: default_collate([s[k] for s in samples]) for k in first}
    return np.stack([np.asarray(s) for s in samples])


def _to_device(tree, device):
    if isinstance(tree, dict):
        return {k: _to_device(v, device) for k, v in tree.items()}
    return torch.as_tensor(np.asarray(tree)).to(device)


class Dataset(Capsule):
    def __init__(self, dataset: Any, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn: Optional[Callable] = None,
                 statefull: bool = True, priority: int = 1000, runtime=None) -> None:
        super().__init__(statefull=statefull, priority=priority, runtime=runtime)
        if batch_size < 1:
            raise ValueError(f"Dataset: batch_size must be >= 1, got {batch_size}")
        self._dataset = dataset
        self._batch_size = int(batch_size)
        self._shuffle = shuffle
        self._drop_last = drop_last
        self._collate = collate_fn or default_collate
        self._iterator = None
        self._batch_idx = 0

    # -- events ------------------------------------------------------------

    def set(self, attrs: Attributes | None = None) -> None:
        super().set(attrs)
        epoch = 0
        if attrs is not None and attrs.launcher is not None:
            epoch = attrs.launcher.epoch_idx or 0
        # Mid-epoch resume fast-forwards when training.
        skip = self._batch_idx if attrs is None or attrs.mode == "train" else 0
        self._iterator = self._batches(epoch, skip)

    def _order(self, epoch: int) -> np.ndarray:
        order = np.arange(len(self._dataset))
        if self._shuffle:
            np.random.default_rng(
                np.random.SeedSequence([self._runtime.seed, epoch, 0x90C3E7])).shuffle(order)
        return order

    def _batches(self, epoch: int, skip: int):
        order = self._order(epoch)
        for i in range(skip, self.total):
            idx = order[i * self._batch_size:(i + 1) * self._batch_size]
            real = len(idx)
            if real < self._batch_size:
                # Wrap padding (the reference's even batches); np.resize
                # tiles the order when the dataset is shorter than the pad.
                idx = np.concatenate([idx, np.resize(order, self._batch_size - real)])
            if hasattr(self._dataset, "get_batch"):
                data = self._dataset.get_batch(idx)
            else:
                data = self._collate([self._dataset[int(j)] for j in idx])
            yield data, real, i

    def launch(self, attrs: Attributes | None = None) -> None:
        if attrs is None or attrs.batch is not None:
            return  # produce-if-absent
        try:
            data, size, index = next(self._iterator)
        except StopIteration:
            if attrs.looper is not None:
                attrs.looper.terminate = True
            return
        attrs.batch = _to_device(data, self._runtime.device)
        attrs.batch_info = Attributes(size=size, index=index)
        if attrs.looper is not None:
            attrs.looper.terminate = False
        self._batch_idx += 1

    def reset(self, attrs: Attributes | None = None) -> None:
        super().reset(attrs)
        self._iterator = None
        self._batch_idx = 0

    # -- Looper inference --------------------------------------------------

    @property
    def total(self) -> int:
        """Batches per epoch."""
        n, bs = len(self._dataset), self._batch_size
        return n // bs if self._drop_last else -(-n // bs)

    # -- checkpoint state --------------------------------------------------

    def state_dict(self) -> dict:
        return {"batch_idx": self._batch_idx}

    def load_state_dict(self, state: dict) -> None:
        self._batch_idx = int(state["batch_idx"])
