"""The port's runtime: device resolution for the entry points, and the
single-process :class:`Runtime` shared by a capsule tree (counterpart of
``rocket_tpu/runtime/context.py``, without the mesh, the process group
and the ops plane — ROADMAP Queue A 3, 6 and 7). ``checkpoint_io`` holds
the checkpoint file format."""

from __future__ import annotations

import logging
from typing import Any, Optional, Sequence, Union

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
    """Prepare-once registry keyed by object identity and an optional
    ``extra_key`` (a loader's settings): two capsules wrapping the same raw
    object (a model shared by a train and an eval Module, a dataset read
    twice with one batching) share one prepared record, and preparing it
    twice is an error. :meth:`retain` and :meth:`release` count the holders
    of a record, so that only the last of them tears it down."""

    def __init__(self, kind: str) -> None:
        self._kind = kind
        self._entries: dict = {}  # (id(raw), extra_key) -> (raw, prepared)
        self._holders: dict = {}  # (id(raw), extra_key) -> count

    def lookup(self, raw: Any, extra_key: Any = None) -> Optional[Any]:
        entry = self._entries.get((id(raw), extra_key))
        return None if entry is None else entry[1]

    def add(self, raw: Any, prepared: Any, extra_key: Any = None) -> Any:
        key = (id(raw), extra_key)
        if key in self._entries:
            raise RuntimeError(f"Registry[{self._kind}]: object {type(raw).__name__} is already "
                               "prepared; share the prepared handle instead.")
        self._entries[key] = (raw, prepared)
        return prepared

    def remove(self, raw: Any, extra_key: Any = None) -> None:
        key = (id(raw), extra_key)
        self._entries.pop(key, None)
        self._holders.pop(key, None)

    def retain(self, raw: Any, extra_key: Any = None) -> None:
        """Count one more holder of the record."""
        key = (id(raw), extra_key)
        self._holders[key] = self._holders.get(key, 0) + 1

    def release(self, raw: Any, extra_key: Any = None) -> bool:
        """Drop one holder. True when it was the last one (a record never
        retained counts as one holder): the record is then removed, and the
        caller tears the prepared object down."""
        key = (id(raw), extra_key)
        left = self._holders.get(key, 1) - 1
        if left > 0:
            self._holders[key] = left
            return False
        self.remove(raw, extra_key)
        return True

    def __len__(self) -> int:
        return len(self._entries)

    def values(self) -> list:
        """The prepared records in registration order."""
        return [prepared for _, prepared in self._entries.values()]


class Runtime:
    """Execution context shared by every capsule of a tree: the device,
    the seeds, gradient accumulation, the models and dataloaders
    registries, the device-resident datasets, the checkpoint stack of
    stateful capsules and the tracker backends. One process: it is always
    the main process and its barrier is a no-op (the process group is
    ROADMAP Queue A 3).

    ``device`` resolves through :func:`resolve_device` (CUDA unless
    ``"cpu"`` is asked for). Every seed a capsule takes derives from
    ``seed`` and the number of earlier draws (:meth:`next_seed`).
    ``device_placement``: the default of ``Dataset(device_placement=)``,
    whether streamed batches are copied to ``device``.
    ``device_cache_bytes``: the size up to which ``Dataset(device_cache=
    "auto")`` keeps a dataset on the device (the reference's default, 1
    GiB, not a measurement of this card)."""

    #: Most recently constructed Runtime (the ambient context).
    _current: Optional["Runtime"] = None

    @classmethod
    def current(cls) -> Optional["Runtime"]:
        return cls._current

    def __init__(self, device=None, seed: int = 0, gradient_accumulation_steps: int = 1,
                 device_placement: bool = True, device_cache_bytes: int = 1 << 30) -> None:
        if gradient_accumulation_steps < 1:
            raise RuntimeError("gradient_accumulation_steps must be >= 1")
        self.device = resolve_device(device)
        self._seed = int(seed)
        self._seed_counter = 0
        self.gradient_accumulation_steps = int(gradient_accumulation_steps)
        self.device_placement = bool(device_placement)
        self.device_cache_bytes = int(device_cache_bytes)
        self.models = IdentityRegistry("models")
        # One loader per (raw dataset, loader settings), shared by the
        # Dataset capsules that ask for it and closed by the last of them.
        self.dataloaders = IdentityRegistry("dataloaders")
        # The device-resident copy of a dataset per (id(raw dataset), cache
        # dtype), shared by every loader over it (a train and a val loader
        # upload once).
        self.device_cache_store: dict = {}
        self.trackers: dict = {}
        self._checkpoint_stack: list = []
        Runtime._current = self

    # -- processes ------------------------------------------------------------

    @property
    def is_main_process(self) -> bool:
        return True

    def wait_for_everyone(self) -> None:
        """The cross-process barrier; one process has nothing to wait for."""

    # -- seeds ----------------------------------------------------------------

    @property
    def seed(self) -> int:
        return self._seed

    def next_seed(self) -> int:
        """A fresh 31-bit seed, deterministic given (seed, prior draws)."""
        value = keys.fold_in(keys.key(self._seed), self._seed_counter) & 0x7FFFFFFF
        self._seed_counter += 1
        return value

    def rng_state_dict(self) -> dict:
        """The seed and the draw counter (``rng.json`` of a checkpoint)."""
        return {"seed": self._seed, "key_counter": self._seed_counter}

    def load_rng_state_dict(self, state: dict) -> None:
        self._seed = int(state["seed"])
        self._seed_counter = int(state["key_counter"])

    # -- checkpoint stack -------------------------------------------------------

    @property
    def checkpoint_stack(self) -> Sequence[Any]:
        """The stateful capsules in setup order (what a checkpoint saves)."""
        return tuple(self._checkpoint_stack)

    def register_for_checkpointing(self, obj: Any) -> None:
        if any(existing is obj for existing in self._checkpoint_stack):
            raise RuntimeError(
                f"Runtime: {type(obj).__name__} registered for checkpointing twice."
            )
        self._checkpoint_stack.append(obj)

    def unregister_from_checkpointing(self, obj: Any) -> None:
        """Pop the stack, verifying LIFO identity: destroy unwinds setup."""
        if not self._checkpoint_stack:
            raise RuntimeError(
                f"Runtime: checkpoint stack empty while unregistering {type(obj).__name__}."
            )
        top = self._checkpoint_stack.pop()
        if top is not obj:
            raise RuntimeError(
                f"Runtime: checkpoint stack corrupted — expected {type(obj).__name__}, found "
                f"{type(top).__name__}. Destroy order must unwind setup order."
            )

    # -- logging and teardown -------------------------------------------------

    def get_logger(self, name: str) -> logging.Logger:
        return logging.getLogger(f"rocket_tpu_torch.{name}")

    # -- trackers ---------------------------------------------------------------

    def get_tracker(self, name: str):
        return self.trackers.get(name)

    def init_tracker(self, name: str, tracker: Any) -> Any:
        self.trackers[name] = tracker
        return tracker

    def end_training(self) -> None:
        """End of a launch: close every registered tracker backend, each
        on its own (one failing ``close`` must not leak the others). Run
        telemetry waits for the ops plane (ROADMAP Queue A 7)."""
        logger = self.get_logger("runtime")
        for name, tracker in list(self.trackers.items()):
            close = getattr(tracker, "close", None)
            if close is None:
                continue
            try:
                close()
            except Exception as exc:  # noqa: BLE001 — isolate per backend
                logger.warning("tracker backend %r failed to close: %r", name, exc)
        self.trackers.clear()
