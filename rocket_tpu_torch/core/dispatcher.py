"""Dispatcher — a composite capsule that fans events out to ordered children
(counterpart of ``rocket_tpu/core/dispatcher.py``).

Reference semantics (``rocket/core/dispatcher.py``):

* children are held **sorted by priority descending** with a stable sort, so
  equal priorities keep constructor order (``dispatcher.py:18-20``);
* every event is forwarded to children in that order, except ``destroy`` which
  iterates **reversed** to unwind the checkpoint-registration stack
  (``dispatcher.py:42-43``);
* ``guard()`` type-checks children (``dispatcher.py:78-82``); runtime binding
  recurses (``dispatcher.py:70-75``); ``__repr__`` renders the subtree
  (``dispatcher.py:85-101``).
"""

from __future__ import annotations

from typing import Iterable, Sequence

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import Capsule, Events

__all__ = ["Dispatcher"]


class Dispatcher(Capsule):
    """Composite capsule: owns children and forwards the five events to them."""

    def __init__(
        self,
        capsules: Iterable[Capsule] = (),
        statefull: bool = False,
        priority: int = 1000,
        runtime=None,
    ) -> None:
        super().__init__(statefull=statefull, priority=priority, runtime=runtime)
        capsules = list(capsules)
        self.guard(capsules)
        # Stable sort: ties keep user construction order.
        self._capsules: list[Capsule] = sorted(
            capsules, key=lambda c: c.priority, reverse=True
        )
        if runtime is not None:
            self.bind(runtime)

    # -- children ----------------------------------------------------------

    @property
    def capsules(self) -> Sequence[Capsule]:
        return tuple(self._capsules)

    def guard(self, capsules: Iterable[Capsule]) -> None:
        for capsule in capsules:
            if not isinstance(capsule, Capsule):
                raise RuntimeError(
                    f"{type(self).__name__}: child {capsule!r} is not a Capsule."
                )

    def find(self, cls: type) -> list[Capsule]:
        """All descendants (depth-first) that are instances of ``cls``."""
        found = []
        for capsule in self._capsules:
            if isinstance(capsule, cls):
                found.append(capsule)
            if isinstance(capsule, Dispatcher):
                found.extend(capsule.find(cls))
        return found

    # -- event fan-out -----------------------------------------------------

    def setup(self, attrs: Attributes | None = None) -> None:
        super().setup(attrs)
        for capsule in self._capsules:
            capsule.dispatch(Events.SETUP, attrs)

    def set(self, attrs: Attributes | None = None) -> None:
        super().set(attrs)
        for capsule in self._capsules:
            capsule.dispatch(Events.SET, attrs)

    def launch(self, attrs: Attributes | None = None) -> None:
        super().launch(attrs)
        for capsule in self._capsules:
            capsule.dispatch(Events.LAUNCH, attrs)

    def reset(self, attrs: Attributes | None = None) -> None:
        super().reset(attrs)
        for capsule in self._capsules:
            capsule.dispatch(Events.RESET, attrs)

    def destroy(self, attrs: Attributes | None = None) -> None:
        # Reverse order: teardown unwinds setup (dispatcher.py:42-43).
        for capsule in reversed(self._capsules):
            capsule.dispatch(Events.DESTROY, attrs)
        super().destroy(attrs)

    # -- runtime binding ---------------------------------------------------

    def bind(self, runtime) -> None:
        super().bind(runtime)
        for capsule in self._capsules:
            capsule.bind(runtime)

    # -- introspection -----------------------------------------------------

    def __repr__(self) -> str:
        head = super().__repr__()
        if not self._capsules:
            return head + "()"
        lines = [head + "("]
        for capsule in self._capsules:
            body = repr(capsule)
            indented = "\n".join("    " + line for line in body.splitlines())
            lines.append(indented + ",")
        lines.append(")")
        return "\n".join(lines)
