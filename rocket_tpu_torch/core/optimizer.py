"""Optimizer capsule — contributes the update rule to the Module's train
step (counterpart of ``rocket_tpu/core/optimizer.py``).

``opt`` is a factory ``fn(params) -> torch.optim.Optimizer``
(``rocket_tpu_torch.optim``); the Module builds it over its params and
sets its learning rate before every update. ``clip_norm`` clips the
gradients to that global L2 norm first, by optax's formula
``g * c / max(||g||, c)`` (``torch.nn.utils.clip_grad_norm_`` adds 1e-6
to the norm and would differ); over the ranks of a sharded layout the
norm sums every shard. At launch the capsule keeps its host-side
roles: on the sync boundary it publishes lr (and the pre-clip grad norm)
and counts updates; with the health sentinels on it also publishes the
update ratio and the param norm (device scalars, read at the tracker's
flush).
"""

from __future__ import annotations

from typing import Callable, Optional

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import Capsule

__all__ = ["Optimizer"]


class Optimizer(Capsule):
    def __init__(self, opt: Callable, learning_rate: Optional[float] = None,
                 clip_norm: Optional[float] = None, grad_sync: str = "auto",
                 grad_bucket_mb: float = 4.0, grad_wire_dtype: Optional[str] = "bfloat16",
                 statefull: bool = False, priority: int = 1000, runtime=None) -> None:
        """``grad_sync``: the data-parallel gradient reduction, as in the
        reference. ``"auto"`` takes the bucketed asynchronous reduction
        (``parallel.grad_sync``) when the Module's ``param_sharding`` rule
        set carries the ``fsdp_axis`` marker (``fsdp_rules``) and the step
        qualifies (a pure data mesh, no gradient accumulation, no model
        state); ``"bucketed"`` takes it for any qualifying data-parallel
        step; ``"off"`` keeps the plain f32 mean all-reduce per leaf.
        ``grad_bucket_mb`` sizes the buckets; ``grad_wire_dtype`` is the
        dtype gradient payloads cross the wire in (None: the master
        precision; the default bf16 carries the f32 bucket-sum
        correction). In one process nothing is reduced."""
        if grad_sync not in ("auto", "bucketed", "off"):
            raise ValueError(f"Optimizer: grad_sync must be auto|bucketed|off, got {grad_sync!r}")
        super().__init__(statefull=statefull, priority=priority, runtime=runtime)
        self._opt = opt
        self._learning_rate = learning_rate
        self._clip_norm = clip_norm
        self._grad_sync = grad_sync
        self._grad_bucket_mb = float(grad_bucket_mb)
        self._grad_wire_dtype = grad_wire_dtype
        self._iter_idx = 0

    @property
    def opt(self) -> Callable:
        return self._opt

    @property
    def clip_norm(self) -> Optional[float]:
        return self._clip_norm

    @property
    def learning_rate(self) -> Optional[float]:
        return self._learning_rate

    @property
    def grad_sync(self) -> str:
        return self._grad_sync

    @property
    def grad_bucket_bytes(self) -> int:
        return int(self._grad_bucket_mb * (1 << 20))

    @property
    def grad_wire_dtype(self) -> Optional[str]:
        return self._grad_wire_dtype

    @property
    def iter_idx(self) -> int:
        return self._iter_idx

    def launch(self, attrs: Attributes | None = None) -> None:
        if attrs is None or attrs.mode != "train" or not attrs.sync_gradients:
            return
        self._iter_idx += 1
        metrics = attrs.step_metrics
        if metrics is None:
            return
        for key in ("lr", "grad_norm"):
            if metrics[key] is not None:
                if attrs.tracker is not None:
                    attrs.tracker.scalars[key] = metrics[key]
                if attrs.looper is not None:
                    attrs.looper.state[key] = metrics[key]
        ratio, pnorm = metrics["health/update_ratio"], metrics["health/param_norm"]
        if ratio is not None:
            if attrs.tracker is not None:
                attrs.tracker.scalars["health/update_ratio"] = ratio
            if attrs.looper is not None:
                attrs.looper.state.update_ratio = ratio
        if pnorm is not None and attrs.tracker is not None:
            attrs.tracker.scalars["health/param_norm"] = pnorm

    def state_dict(self) -> dict:
        return {"iter_idx": self._iter_idx}

    def load_state_dict(self, state: dict) -> None:
        self._iter_idx = int(state["iter_idx"])
