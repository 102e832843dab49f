"""The port's runtime: device resolution for the entry points, and the
single-process :class:`Runtime` shared by a capsule tree (counterpart of
``rocket_tpu/runtime/context.py``, without the mesh, the process group
and the ops plane — ROADMAP Queue A 3, 6 and 7)."""

from __future__ import annotations

import logging
from typing import Any, Optional, Union

import torch

from rocket_tpu_torch.nn import keys

__all__ = ["resolve_device", "Runtime", "IdentityRegistry"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU: it returns ``cuda`` and RAISES when no GPU is
    present — there is no silent CPU fallback, so a measurement path can
    never report CPU numbers as device numbers. The CPU is used only when
    the caller asks for it explicitly (``device="cpu"``, as the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "resolve_device: no CUDA device is available; pass "
                "device='cpu' to run on the CPU explicitly"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"resolve_device: {dev} requested but CUDA is unavailable")
    return dev


class IdentityRegistry:
    """Prepare-once registry keyed by object identity: two capsules
    wrapping the same raw object (a model shared by a train and an eval
    Module) share one prepared record, and preparing it twice is an error."""

    def __init__(self, kind: str) -> None:
        self._kind = kind
        self._entries: dict = {}  # id(raw) -> (raw, prepared)

    def lookup(self, raw: Any) -> Optional[Any]:
        entry = self._entries.get(id(raw))
        return None if entry is None else entry[1]

    def add(self, raw: Any, prepared: Any) -> Any:
        if id(raw) in self._entries:
            raise RuntimeError(f"Registry[{self._kind}]: object {type(raw).__name__} is already "
                               "prepared; share the prepared handle instead.")
        self._entries[id(raw)] = (raw, prepared)
        return prepared

    def remove(self, raw: Any) -> None:
        self._entries.pop(id(raw), None)


class Runtime:
    """Execution context shared by every capsule of a tree: the device,
    the seeds, gradient accumulation and the models registry. The
    checkpoint stack of stateful capsules comes with the Checkpointer
    (ROADMAP Queue A 2).

    ``device`` resolves through :func:`resolve_device` (CUDA unless
    ``"cpu"`` is asked for). Every seed a capsule takes derives from
    ``seed`` and the number of earlier draws (:meth:`next_seed`)."""

    #: Most recently constructed Runtime (the ambient context).
    _current: Optional["Runtime"] = None

    @classmethod
    def current(cls) -> Optional["Runtime"]:
        return cls._current

    def __init__(self, device=None, seed: int = 0, gradient_accumulation_steps: int = 1) -> None:
        if gradient_accumulation_steps < 1:
            raise RuntimeError("gradient_accumulation_steps must be >= 1")
        self.device = resolve_device(device)
        self._seed = int(seed)
        self._seed_counter = 0
        self.gradient_accumulation_steps = int(gradient_accumulation_steps)
        self.models = IdentityRegistry("models")
        Runtime._current = self

    # -- seeds ----------------------------------------------------------------

    @property
    def seed(self) -> int:
        return self._seed

    def next_seed(self) -> int:
        """A fresh 31-bit seed, deterministic given (seed, prior draws)."""
        value = keys.fold_in(keys.key(self._seed), self._seed_counter) & 0x7FFFFFFF
        self._seed_counter += 1
        return value

    # -- logging and teardown -------------------------------------------------

    def get_logger(self, name: str) -> logging.Logger:
        return logging.getLogger(f"rocket_tpu_torch.{name}")

    def end_training(self) -> None:
        """End of a launch. Nothing to flush yet: trackers and telemetry
        arrive with the ops plane (ROADMAP Queue A 7)."""
