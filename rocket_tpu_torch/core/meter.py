"""Meter / Metric — evaluation metrics over the batches of a phase
(counterpart of ``rocket_tpu/core/meter.py``).

* ``Meter`` selects batch keys, gathers them across the data axis (each
  rank holds its stripe of the global batch, the ranks of one model group
  the same one; an ``all_gather`` over the data group lays the stripes end
  to end in order, the global batch, so no batch counts twice),
  trims the padding of a short last batch (``attrs.batch_info.size`` is
  the global batch's real sample count) and dispatches its children — the
  ``Metric`` capsules — on that batch. One process gathers nothing.
* A ``Metric`` that overrides :meth:`Metric.device_reduce` gets the
  device path: the Meter hands it the (untrimmed) key tensors of this
  rank's stripe and the stripe's real size; it returns a few scalars (sums
  over the rows), which are all-reduced over the data group, and
  :meth:`Metric.consume` accumulates them on the device; ``reset`` reads
  them on the host once per epoch. Other metrics get the trimmed batch in
  ``launch``.
* Errors inside metric children propagate — the reference's deliberate fix
  of ``rocket/core/meter.py:91-93``, whose bare ``except:`` masked them as
  "keys not found".
* The host metrics' pass over the gathered batch reads device tensors on
  the host by design, so it runs through the explicit-transfer helper
  (legal under strict mode). With health on, a published host scalar that
  is not finite is noted to the health monitor (``health/nonfinite_metrics``).
"""

from __future__ import annotations

import math
import numbers
from collections.abc import Mapping
from typing import Iterable, Optional, Sequence

import torch

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import Capsule
from rocket_tpu_torch.core.dispatcher import Dispatcher

__all__ = ["Meter", "Metric"]


class Meter(Dispatcher):
    """``keys``: the batch keys the metrics read. ``gather_on``: where the
    host-path metrics run in a multi-process run — ``"all"`` (every rank
    keeps the gathered global batch and dispatches its children) or
    ``"main"`` (every rank joins the gather, which is collective, but only
    the main process keeps the batch and accumulates). Device-path metrics
    run on every rank either way."""

    def __init__(self, keys: Sequence[str], capsules: Iterable[Capsule] = (),
                 gather_on: str = "all", statefull: bool = False, priority: int = 1000,
                 runtime=None) -> None:
        super().__init__(capsules, statefull=statefull, priority=priority, runtime=runtime)
        if gather_on not in ("all", "main"):
            raise ValueError(f"Meter: gather_on must be 'all'|'main', got {gather_on!r}")
        self._keys = tuple(keys)
        self._gather_on = gather_on

    def gather_for_metrics(self, value, real_size: Optional[int]):
        """The value gathered over the processes (a tensor with a leading
        batch dim), with the padding rows past ``real_size`` trimmed."""
        runtime = self._runtime
        if (runtime is not None and runtime.data_axis_size > 1
                and isinstance(value, torch.Tensor) and value.ndim >= 1):
            import torch.distributed as dist

            local = value.contiguous()
            out = local.new_empty((runtime.data_axis_size * local.shape[0],)
                                  + tuple(local.shape[1:]))
            dist.all_gather_into_tensor(out, local, group=runtime.axis_group("data"))
            value = out
        if real_size is not None and getattr(value, "ndim", 0) >= 1 and len(value) > real_size:
            return value[:real_size]
        return value

    def _reduce_over_ranks(self, reduced):
        """A :meth:`Metric.device_reduce` result summed over the ranks:
        tensors stay on the device; host numbers ride one f64 all-reduce
        and are read back once."""
        import torch.distributed as dist

        from rocket_tpu_torch.runtime import explicit_transfer

        group = self._runtime.axis_group("data")
        out, host = {}, {}
        for key, value in reduced.items():
            if isinstance(value, torch.Tensor):
                out[key] = value.clone()
                dist.all_reduce(out[key], group=group)
            else:
                host[key] = value
        if host:
            with explicit_transfer():
                totals = torch.tensor([float(v) for v in host.values()], dtype=torch.float64,
                                      device=self._runtime.device)
                dist.all_reduce(totals, group=group)
                values = totals.tolist()
            out.update({key: type(v)(total) for (key, v), total in zip(host.items(), values)})
        return {key: out[key] for key in reduced}

    def launch(self, attrs: Attributes | None = None) -> None:
        if attrs is None or attrs.batch is None:
            return
        batch = attrs.batch
        if not isinstance(batch, Mapping):
            raise TypeError(f"Meter: expects a dict batch, got {type(batch).__name__}")
        missing = [k for k in self._keys if k not in batch]
        if missing:
            raise KeyError(f"Meter: keys {missing} not found in batch "
                           f"(available: {sorted(batch.keys())})")
        real_size = attrs.batch_info.size if attrs.batch_info is not None else None
        subset = {k: batch[k] for k in self._keys}
        stripe = len(subset[self._keys[0]])
        procs = self._runtime.data_axis_size if self._runtime is not None else 1
        size = stripe if real_size is None else real_size
        if procs > 1 and real_size is not None:
            # This rank's real rows: its stripe is rows [lo, lo + stripe)
            # of the global batch (the ranks of one model group hold the same).
            size = min(max(real_size - self._runtime.data_index * stripe, 0), stripe)
        host_kids = []
        for child in self._capsules:
            if isinstance(child, Metric) and type(child).device_reduce is not Metric.device_reduce:
                reduced = child.device_reduce(subset, size)
                if procs > 1:
                    reduced = self._reduce_over_ranks(reduced)
                child.consume(reduced)
            else:
                host_kids.append(child)
        if not host_kids:
            return
        gathered = {k: self.gather_for_metrics(v, real_size) for k, v in subset.items()}
        if procs > 1 and self._gather_on == "main" and not self._runtime.is_main_process:
            return  # joined the gather; only the main process keeps it
        from rocket_tpu_torch.runtime import explicit_transfer

        original = attrs.batch
        attrs.batch = {**batch, **gathered}
        try:
            with explicit_transfer():
                for child in host_kids:  # already priority-sorted
                    child.launch(attrs)
        finally:
            attrs.batch = original


class Metric(Capsule):
    """Abstract accumulator: override ``launch`` and ``reset``
    (``rocket/core/meter.py:98-111``), or :meth:`device_reduce` +
    :meth:`consume` and ``reset`` for the device path."""

    def launch(self, attrs: Attributes | None = None) -> None:
        raise NotImplementedError(f"{type(self).__name__}: implement launch(attrs) to accumulate.")

    def reset(self, attrs: Attributes | None = None) -> None:
        raise NotImplementedError(
            f"{type(self).__name__}: implement reset(attrs) to finalize/clear.")

    def device_reduce(self, batch, real_size):
        """Mapping of the Meter's keys to tensors + the real size -> a
        small dict of device scalars. Overriding it selects the device
        path."""
        return None

    def consume(self, reduced) -> None:
        """Accumulate a :meth:`device_reduce` result on the device; a host
        read here would put a sync on every eval batch."""
        raise NotImplementedError

    def publish(self, attrs: Attributes | None, tag: str, value) -> None:
        """Route a finalised scalar to the tracker buffers and the live loop
        state."""
        if attrs is not None:
            if attrs.tracker is not None:
                attrs.tracker.scalars[tag] = value
            if attrs.looper is not None:
                attrs.looper.state[tag] = value
        health = getattr(self._runtime, "health", None)
        if (health is not None and health.enabled and isinstance(value, numbers.Real)
                and not math.isfinite(value)):
            # A host scalar only: checking a device one would read it back.
            health.note_nonfinite_metric(tag)
