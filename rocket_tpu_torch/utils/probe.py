"""Probe — a capsule that records every event it receives (counterpart of
``rocket_tpu/utils/probe.py``), the natural instrument for the five-event
protocol in tests and when debugging a tree.

Each entry of its trace is a :class:`ProbeEvent`: equal to the plain
``(name, event)`` tuple, and carrying the ``time.perf_counter`` of the
event (``.t``) and the ``attrs.mode`` in force (``.mode``: None outside a
Looper phase), so order, timing and mode can all be asserted on.
"""

from __future__ import annotations

import time
from typing import Optional

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import Capsule

__all__ = ["Probe", "ProbeEvent"]


class ProbeEvent(tuple):
    """``(name, event)`` with ``.t`` (monotonic seconds) and ``.mode``."""

    def __new__(cls, name: str, event: str, t: float, mode):
        entry = super().__new__(cls, (name, event))
        entry.t, entry.mode = t, mode
        return entry

    @property
    def name(self) -> str:
        return self[0]

    @property
    def event(self) -> str:
        return self[1]

    def __repr__(self) -> str:
        return f"ProbeEvent({self[0]!r}, {self[1]!r}, t={self.t:.6f}, mode={self.mode!r})"


class Probe(Capsule):
    """Appends a :class:`ProbeEvent` to ``trace`` (a list it may share with
    other probes) for each of the five events."""

    def __init__(self, name: str, trace: Optional[list] = None, statefull: bool = False,
                 priority: int = 1000, runtime=None) -> None:
        super().__init__(statefull=statefull, priority=priority, runtime=runtime)
        self.name = name
        self.trace = [] if trace is None else trace

    def _note(self, event: str, attrs: Attributes | None) -> None:
        self.trace.append(ProbeEvent(self.name, event, time.perf_counter(),
                                     None if attrs is None else attrs.mode))

    def setup(self, attrs=None):
        super().setup(attrs)  # registers a statefull probe first
        self._note("setup", attrs)

    def destroy(self, attrs=None):
        self._note("destroy", attrs)
        super().destroy(attrs)


def _noting(event: str):
    def handler(self, attrs=None):
        self._note(event, attrs)

    handler.__name__ = event
    return handler


for _event in ("set", "launch", "reset"):
    setattr(Probe, _event, _noting(_event))
del _event
