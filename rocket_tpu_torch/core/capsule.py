"""Capsule — the base unit of composition, and the five-event lifecycle
(counterpart of ``rocket_tpu/core/capsule.py``).

* ``Events`` names the handler methods; ``dispatch()`` is
  ``getattr(self, event.value)(attrs)``.
* A capsule holds a priority (default 1000; higher runs earlier inside a
  Dispatcher), a statefulness flag, a late-bound runtime handle and a
  logger.
* ``statefull`` capsules push themselves on the runtime's checkpoint
  stack at ``setup`` and pop at ``destroy`` (LIFO-checked); the
  Checkpointer saves and restores their ``state_dict`` in that order.

With run telemetry on (``Runtime(telemetry=True)``), ``dispatch`` wraps
every event in one span named ``<Class>.<event>``: the five-event protocol
makes it the one choke point of the whole tree.
"""

from __future__ import annotations

import logging
from enum import Enum
from typing import Optional

from rocket_tpu_torch.core.attributes import Attributes

__all__ = ["Events", "Capsule", "Attributes"]


class Events(Enum):
    """Lifecycle events. Values are handler-method names (dispatch contract)."""

    SETUP = "setup"
    DESTROY = "destroy"
    SET = "set"
    RESET = "reset"
    LAUNCH = "launch"


# Priority conventions: within one Dispatcher, higher priority runs earlier.
PRIORITY_LOSS = 1100
PRIORITY_DEFAULT = 1000
PRIORITY_TRACKER = 200
PRIORITY_CHECKPOINT = 100


class Capsule:
    """Base unit: receives the five events, reads/writes the ``Attributes`` bag.

    ``statefull``: the capsule has state for the Checkpointer to persist
    (spelling kept from the reference API): ``setup`` registers it on the
    runtime's checkpoint stack. ``priority``: dispatch
    order inside a Dispatcher — higher runs earlier. ``runtime``: usually
    late-bound by the root ``Launcher`` via :meth:`bind`.
    """

    def __init__(self, statefull: bool = False, priority: int = PRIORITY_DEFAULT,
                 runtime=None) -> None:
        self._priority = priority
        self._statefull = statefull
        self._runtime = runtime
        self._logger = logging.getLogger(type(self).__name__)

    @property
    def priority(self) -> int:
        return self._priority

    @property
    def statefull(self) -> bool:
        return self._statefull

    @property
    def runtime(self):
        return self._runtime

    # -- event handlers ----------------------------------------------------

    def setup(self, attrs: Attributes | None = None) -> None:
        """One-time initialization."""
        self._check_runtime()
        if self._statefull:
            self._runtime.register_for_checkpointing(self)
        self.log_debug("setup")

    def set(self, attrs: Attributes | None = None) -> None:
        """Per-epoch (or per-phase) preparation."""
        self.log_debug("set")

    def launch(self, attrs: Attributes | None = None) -> None:
        """The per-iteration work unit."""
        self.log_debug("launch")

    def reset(self, attrs: Attributes | None = None) -> None:
        """Per-epoch teardown."""
        self.log_debug("reset")

    def destroy(self, attrs: Attributes | None = None) -> None:
        """Final teardown."""
        if self._statefull and self._runtime is not None:
            self._runtime.unregister_from_checkpointing(self)
        self.log_debug("destroy")

    # -- dispatch ----------------------------------------------------------

    def dispatch(self, event: Events, attrs: Attributes | None = None) -> None:
        """Route an event to its handler method."""
        if not isinstance(event, Events):
            raise RuntimeError(
                f"{type(self).__name__}: dispatch expects an Events member, got {event!r}"
            )
        telemetry = getattr(self._runtime, "telemetry", None)
        if telemetry is not None and telemetry.enabled:
            with telemetry.span(f"{type(self).__name__}.{event.value}"):
                getattr(self, event.value)(attrs)
        else:
            getattr(self, event.value)(attrs)

    # -- runtime binding ---------------------------------------------------

    def bind(self, runtime) -> None:
        """Late-bind the runtime context. Idempotent for the same runtime;
        rebinding to a different runtime is an error."""
        if self._runtime is not None and self._runtime is not runtime:
            raise RuntimeError(f"{type(self).__name__}: already bound to a different runtime.")
        self._runtime = runtime
        self._logger = runtime.get_logger(type(self).__name__)

    def _check_runtime(self) -> None:
        if self._runtime is None:
            raise RuntimeError(
                f"{type(self).__name__}: no runtime bound. Construct the tree under a Launcher "
                "(which binds its runtime recursively) or call .bind(runtime) explicitly."
            )

    # -- checkpoint state --------------------------------------------------

    def state_dict(self) -> dict:
        """Host-side state to persist. Stateful subclasses override."""
        return {}

    def load_state_dict(self, state: dict) -> None:
        """Restore host-side state. Stateful subclasses override."""
        del state

    # -- logging -----------------------------------------------------------

    def log_debug(self, msg: str) -> None:
        self._logger.debug("%s: %s", type(self).__name__, msg)

    def log_info(self, msg: str) -> None:
        self._logger.info("%s: %s", type(self).__name__, msg)

    def log_warning(self, msg: str) -> None:
        self._logger.warning("%s: %s", type(self).__name__, msg)

    def __repr__(self) -> str:
        flags = []
        if self._statefull:
            flags.append("statefull")
        if self._priority != PRIORITY_DEFAULT:
            flags.append(f"priority={self._priority}")
        suffix = f" [{', '.join(flags)}]" if flags else ""
        return f"{type(self).__name__}{suffix}"
