"""Launcher — the root of the capsule tree and the epoch loop (counterpart
of ``rocket_tpu/core/launcher.py``).

Reference semantics (``rocket/core/launcher.py``):

* ``launch()`` runs ``setup`` once, then per epoch drives each child
  **sequentially** through ``set -> launch -> reset`` (``launcher.py:37-45``) —
  child A completes its whole epoch before child B starts — then ``destroy``
  and runtime teardown (``launcher.py:48-55``);
* ``set``/``reset`` are overridden to no-ops so a Launcher is only ever a root
  (``launcher.py:23-27``);
* opt-in stateful: persists the epoch index (``launcher.py:58-63``).

Deliberate fix: the reference stores the epoch index *without* +1 after the
epoch body (``launcher.py:46``), so resume repeats the last epoch. Here
``_epoch_idx`` is advanced past the finished epoch.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Optional

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import Capsule, Events
from rocket_tpu_torch.core.dispatcher import Dispatcher

__all__ = ["Launcher"]


class Launcher(Dispatcher):
    """Root capsule: owns the runtime and the epoch loop.

    Parameters
    ----------
    capsules:
        Top-level children — typically one or more ``Looper`` phases plus
        trackers.
    num_epochs:
        Total epochs to run.
    statefull:
        Persist/restore the epoch index across checkpoints (opt-in as in the
        reference, ``launcher.py:17``).
    runtime:
        The :class:`~rocket_tpu_torch.runtime.Runtime`. If omitted, a default
        one (on the GPU) is created lazily at ``launch()``.
    """

    def __init__(
        self,
        capsules: Iterable[Capsule] = (),
        num_epochs: int = 1,
        statefull: bool = False,
        runtime=None,
    ) -> None:
        super().__init__(capsules, statefull=statefull, runtime=runtime)
        self._num_epochs = num_epochs
        self._epoch_idx = 0

    # -- the entry point ---------------------------------------------------

    def launch(self, attrs: Optional[Attributes] = None) -> Attributes:
        if self._runtime is None:
            # Lazy default: one process on the GPU.
            from rocket_tpu_torch.runtime import Runtime

            self.bind(Runtime())

        self.log_debug("launch")
        attrs = Attributes() if attrs is None else attrs

        # Strict mode: setup, each phase's set and reset and the teardown
        # move data by design (uploads, the epoch's order, the last flush),
        # so they run with the guard lifted; the phases' waves run guarded
        # (core/loop.py).
        strict = getattr(self._runtime, "strict", None)
        lifted = strict.lifted if strict is not None else contextlib.nullcontext
        with lifted():
            self.setup(attrs)
        try:
            while self._epoch_idx < self._num_epochs:
                attrs.launcher = Attributes(
                    epoch_idx=self._epoch_idx, num_epochs=self._num_epochs
                )
                for capsule in self._capsules:
                    with lifted():
                        capsule.dispatch(Events.SET, attrs)
                    capsule.dispatch(Events.LAUNCH, attrs)
                    with lifted():
                        capsule.dispatch(Events.RESET, attrs)
                # Advance past the finished epoch (fixes launcher.py:46).
                self._epoch_idx += 1
        finally:
            with lifted():
                self.destroy(attrs)
            self._runtime.end_training()
        return attrs

    # -- a Launcher is only ever a root (launcher.py:23-27) ----------------

    def setup(self, attrs: Attributes | None = None) -> None:
        Dispatcher.setup(self, attrs)

    def set(self, attrs: Attributes | None = None) -> None:
        pass

    def reset(self, attrs: Attributes | None = None) -> None:
        pass

    # -- checkpoint state --------------------------------------------------

    def state_dict(self) -> dict:
        return {"epoch_idx": self._epoch_idx}

    def load_state_dict(self, state: dict) -> None:
        self._epoch_idx = int(state["epoch_idx"])
