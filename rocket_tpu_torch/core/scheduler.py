"""Scheduler capsule — contributes the lr schedule to the Module's train
step (counterpart of ``rocket_tpu/core/scheduler.py``).

The schedule is a pure ``step -> lr`` function (``rocket_tpu_torch.optim``)
that the Module reads before every update at the count of updates made
so far; the per-iteration ``scheduler.step()`` of a torch loop has no
host-side equivalent here. The capsule remains for composition parity.
"""

from __future__ import annotations

from typing import Callable

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import Capsule

__all__ = ["Scheduler"]


class Scheduler(Capsule):
    def __init__(self, schedule: Callable[[int], float], statefull: bool = False,
                 priority: int = 1000, runtime=None) -> None:
        super().__init__(statefull=statefull, priority=priority, runtime=runtime)
        if not callable(schedule):
            raise TypeError("Scheduler: schedule must be callable (step -> lr).")
        self._schedule = schedule

    @property
    def schedule(self) -> Callable[[int], float]:
        return self._schedule

    def launch(self, attrs: Attributes | None = None) -> None:
        pass  # read by the Module at each update
