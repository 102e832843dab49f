"""Loss capsule — the training objective and its running value
(counterpart of ``rocket_tpu/core/loss.py``).

It contributes the objective (batch -> scalar) to the Module's train step
at setup, and keeps the host-side role at launch: on the sync boundary
it publishes the window's mean loss to ``attrs.looper.state.loss`` (and
``attrs.tracker.scalars[tag]`` when a tracker bag exists). Priority 1100,
so it runs before the Optimizer. The value stays a device scalar — no
per-step host sync; only ``state_dict`` reads it.
"""

from __future__ import annotations

from typing import Callable

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import PRIORITY_LOSS, Capsule

__all__ = ["Loss"]


class Loss(Capsule):
    def __init__(self, objective: Callable, tag: str = "loss", statefull: bool = True,
                 priority: int = PRIORITY_LOSS, runtime=None) -> None:
        super().__init__(statefull=statefull, priority=priority, runtime=runtime)
        if not callable(objective):
            raise TypeError("Loss: objective must be callable (batch -> scalar).")
        self._objective = objective
        self._tag = tag
        self._value = 0.0

    @property
    def objective(self) -> Callable:
        return self._objective

    @property
    def tag(self) -> str:
        return self._tag

    def launch(self, attrs: Attributes | None = None) -> None:
        if attrs is None or attrs.mode != "train":
            return
        if attrs.step_metrics is None or attrs.step_metrics.loss_window is None:
            return
        if attrs.sync_gradients:
            value = attrs.step_metrics.loss_window
            self._value = value
            if attrs.tracker is not None:
                attrs.tracker.scalars[self._tag] = value
            if attrs.looper is not None:
                attrs.looper.state.loss = value

    def state_dict(self) -> dict:
        return {"value": float(self._value)}

    def load_state_dict(self, state: dict) -> None:
        self._value = float(state["value"])
