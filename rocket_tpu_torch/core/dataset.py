"""Dataset capsule — produce-if-absent batch source for a Looper phase
(counterpart of ``rocket_tpu/core/dataset.py``), over the data stack of
``rocket_tpu_torch/data``.

* ``setup`` prepares one loader per (raw dataset, loader settings) through
  the runtime's ``dataloaders`` registry: capsules asking for the same one
  share it, and the last to ``destroy`` closes it;
* ``device_cache="auto"`` keeps a map-style dataset on the device
  (``data/device_cache.py``) when its collated arrays fit the runtime's
  ``device_cache_bytes``, and streams it otherwise (``True`` keeps any
  collatable map-style dataset there, ``False`` always streams). The
  device-resident copy is shared by every loader over one dataset (the
  train and the val Looper upload once). This is the reference's rule, not
  a fallback: an upload that fails raises;
* with more than one process the device cache is off and each rank
  streams its stripe of every global batch (``process_index`` and
  ``process_count`` from the Runtime), as in the reference;
* streaming reads and collates on the host (``data/loader.py``; in
  ``num_workers`` processes with ``data/workers.py``), ``prefetch``
  batches ahead on a thread (``data/prefetch.py``), and copies each batch
  to the device on this thread when ``device_placement`` is on;
* ``set()`` picks the epoch's order (the reference's ``SeedSequence([seed,
  epoch, 0x90C3E7])`` shuffle; a short last batch wrap-filled with
  ``batch_info.size`` its real rows), fast-forwards a mid-epoch resume
  when training, and exposes the batch total for the Looper;
* ``launch()`` fills ``attrs.batch`` only when it is ``None`` (each batch
  through the runtime's fault injector first, when a plan is set); on
  exhaustion it sets ``attrs.looper.terminate``.

``fuse_gather`` is accepted, with the reference's default, and keys the
loader registry as there; it changes nothing here. The reference hands its
compiled step a gather *marker* so that the batch's row gather runs inside
the step's one dispatch; an eager PyTorch step has no compiled program to
fold it into, so the device-resident loader always yields rows.
"""

from __future__ import annotations

from typing import Any, Callable, Optional

import numpy as np
import torch

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import Capsule
from rocket_tpu_torch.data.collate import default_collate
from rocket_tpu_torch.data.device_cache import DeviceCachedLoader, pytree_nbytes, tree_leaves
from rocket_tpu_torch.data.loader import DataLoader, num_batches

__all__ = ["Dataset", "default_collate"]


def _torch_dtype(dtype) -> Optional[torch.dtype]:
    """``cache_dtype`` as a torch dtype: a torch dtype, or its name."""
    if dtype is None or isinstance(dtype, torch.dtype):
        return dtype
    resolved = getattr(torch, str(dtype), None)
    if not isinstance(resolved, torch.dtype):
        raise ValueError(f"Dataset: unknown cache_dtype {dtype!r}")
    return resolved


class Dataset(Capsule):
    def __init__(self, dataset: Any, batch_size: int = 1, shuffle: bool = False,
                 drop_last: bool = False, collate_fn: Optional[Callable] = None,
                 device_placement: Optional[bool] = None, device_cache: str | bool = "auto",
                 cache_dtype=None, fuse_gather: bool = True, num_workers: int = 0,
                 worker_start_method: Optional[str] = None, prefetch: int = 2,
                 statefull: bool = True, priority: int = 1000, runtime=None) -> None:
        super().__init__(statefull=statefull, priority=priority, runtime=runtime)
        if batch_size < 1:
            raise ValueError(f"Dataset: batch_size must be >= 1, got {batch_size}")
        if device_cache not in ("auto", True, False):
            raise ValueError(f"Dataset: device_cache must be 'auto', True or False, "
                             f"got {device_cache!r}")
        self._raw_dataset = dataset
        self._loader_kwargs = dict(batch_size=int(batch_size), shuffle=shuffle,
                                   drop_last=drop_last, collate_fn=collate_fn,
                                   num_workers=int(num_workers),
                                   worker_start_method=worker_start_method)
        self._device_placement = device_placement
        self._device_cache = device_cache
        self._cache_dtype = _torch_dtype(cache_dtype)
        self._fuse_gather = bool(fuse_gather)
        self._prefetch = int(prefetch)
        self._registry_key = (int(batch_size), shuffle, drop_last, id(collate_fn),
                              int(num_workers), worker_start_method, self._fuse_gather,
                              str(self._cache_dtype))
        self._dataloader = None
        self._device_resident = False
        self._iterator = None
        self._batch_idx = 0

    @property
    def device_resident(self) -> bool:
        """Whether the batches come from the device-resident copy."""
        return self._device_resident

    # -- events ------------------------------------------------------------

    def setup(self, attrs: Attributes | None = None) -> None:
        super().setup(attrs)
        self._prepare()

    def _prepare(self) -> None:
        """Look up or make the shared loader and count this capsule among
        its holders (once, however often it is set up)."""
        runtime = self._runtime
        loader = runtime.dataloaders.lookup(self._raw_dataset, self._registry_key)
        if loader is None:
            loader = runtime.dataloaders.add(self._raw_dataset, self._make_loader(runtime),
                                             self._registry_key)
        if self._dataloader is None:
            runtime.dataloaders.retain(self._raw_dataset, self._registry_key)
        self._dataloader = loader
        self._device_resident = isinstance(loader, DeviceCachedLoader)
        if self._device_placement is None:
            self._device_placement = runtime.device_placement

    def _make_loader(self, runtime):
        kw = self._loader_kwargs
        # The device cache holds the whole dataset on each rank's card; with
        # several processes the striped streaming loader runs instead, as
        # in the reference.
        if runtime.process_count > 1:
            self._device_cache = False
        if self._device_cache in ("auto", True):
            store_key = (id(self._raw_dataset), str(self._cache_dtype))
            data = runtime.device_cache_store.get(store_key)
            if data is None:
                data = self._materialize()
            if data is not None and (self._device_cache is True
                                     or pytree_nbytes(data) <= runtime.device_cache_bytes):
                loader = DeviceCachedLoader(data, kw["batch_size"], runtime.device,
                                            shuffle=kw["shuffle"], drop_last=kw["drop_last"],
                                            seed=runtime.seed, cache_dtype=self._cache_dtype)
                runtime.device_cache_store[store_key] = loader.cache
                return loader
        if self._cache_dtype is not None:
            runtime.get_logger("dataset").warning(
                "Dataset(cache_dtype=%s) has no effect on the streaming loader path "
                "(device_cache off, or the dataset does not fit or cannot be collated); "
                "inputs stay at their source dtype.", self._cache_dtype)
        return DataLoader(self._raw_dataset, seed=runtime.seed,
                          process_index=runtime.data_index,
                          process_count=runtime.data_axis_size, **kw)

    def _materialize(self):
        """The whole dataset as one collated host pytree whose every leaf is
        an array with the sample count as its leading dim, or None when the
        dataset is not map-style, is empty, or does not collate so (it is
        then streamed)."""
        ds = self._raw_dataset
        if not (hasattr(ds, "__len__") and hasattr(ds, "__getitem__")):
            return None
        n = len(ds)
        if n == 0:
            return None
        try:
            if hasattr(ds, "get_batch"):
                data = ds.get_batch(np.arange(n))
            else:
                collate = self._loader_kwargs["collate_fn"] or default_collate
                data = collate([ds[i] for i in range(n)])
        except (TypeError, ValueError, IndexError, KeyError):
            return None  # samples that do not stack: stream them
        if all(isinstance(leaf, np.ndarray) and leaf.shape[:1] == (n,)
               for leaf in tree_leaves(data)):
            return data
        return None

    def set(self, attrs: Attributes | None = None) -> None:
        super().set(attrs)
        if self._dataloader is None:
            self._prepare()  # a capsule bound and set without a tree's setup
        epoch = 0
        if attrs is not None and attrs.launcher is not None:
            epoch = attrs.launcher.epoch_idx or 0
        self._dataloader.set_epoch(epoch)
        # Mid-epoch resume fast-forwards when training.
        if self._batch_idx > 0 and (attrs is None or attrs.mode == "train"):
            self._dataloader.skip(self._batch_idx)
        self._close_iterator()
        iterator = iter(self._dataloader)
        if self._prefetch > 0 and not self._device_resident:
            from rocket_tpu_torch.data.prefetch import PrefetchIterator

            iterator = PrefetchIterator(iterator, depth=self._prefetch)
        self._iterator = iterator

    def launch(self, attrs: Attributes | None = None) -> None:
        if attrs is None or attrs.batch is not None:
            return  # produce-if-absent
        telemetry = self._runtime.telemetry
        try:
            # The loop's wait on the input pipeline is goodput's data_wait.
            with telemetry.span("data/next", cat="data_wait"):
                batch = next(self._iterator)
        except StopIteration:
            if attrs.looper is not None:
                attrs.looper.terminate = True
            return
        data = batch.data
        # A scheduled poison fault (ROCKET_TPU_FAULTS) NaN-fills this batch
        # before placement; a device-resident batch is filled on its card.
        faults = getattr(self._runtime, "faults", None)
        if faults is not None:
            data = faults.poison_hook(data)
        if self._device_placement and not self._device_resident:
            # The framework's own upload of a streamed batch: an explicit
            # transfer, legal under strict mode.
            from rocket_tpu_torch.runtime import explicit_transfer

            with telemetry.span("data/h2d", cat="data_wait"), explicit_transfer():
                data = self._runtime.shard_batch(data)
        attrs.batch = data
        attrs.batch_info = Attributes(size=batch.size, index=batch.index)
        if attrs.looper is not None:
            attrs.looper.terminate = False
        self._batch_idx += 1

    def reset(self, attrs: Attributes | None = None) -> None:
        super().reset(attrs)
        self._close_iterator()
        self._batch_idx = 0

    def destroy(self, attrs: Attributes | None = None) -> None:
        # A shared loader is closed (its workers stopped) by its last holder.
        if self._dataloader is not None and self._runtime is not None:
            if self._runtime.dataloaders.release(self._raw_dataset, self._registry_key):
                self._dataloader.close()
        self._dataloader = None
        self._close_iterator()
        super().destroy(attrs)

    def _close_iterator(self) -> None:
        iterator, self._iterator = self._iterator, None
        close = getattr(iterator, "close", None)
        if close is not None:
            close()

    # -- Looper inference --------------------------------------------------

    @property
    def total(self) -> Optional[int]:
        """Batches per epoch (None for a dataset without a length)."""
        if self._dataloader is not None:
            return self._dataloader.total
        if not hasattr(self._raw_dataset, "__len__"):
            return None
        kw = self._loader_kwargs
        return num_batches(len(self._raw_dataset), kw["batch_size"], kw["drop_last"])

    # -- checkpoint state --------------------------------------------------

    def state_dict(self) -> dict:
        return {"batch_idx": self._batch_idx}

    def load_state_dict(self, state: dict) -> None:
        self._batch_idx = int(state["batch_idx"])
