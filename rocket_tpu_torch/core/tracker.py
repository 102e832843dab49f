"""Tracker capsule — experiment logging with pluggable backends
(counterpart of ``rocket_tpu/core/tracker.py``).

* priority ``PRIORITY_TRACKER`` (200); backends by name from a registry
  (:func:`register_tracker_backend`) or a ready duck-typed instance,
  shared across capsules through the runtime's tracker registry;
* ``set()`` opens the epoch's buffers ``attrs.tracker = {scalars,
  images}``, which the Loss and Optimizer capsules fill;
* ``launch()`` flushes on the gradient-sync boundary in training and on
  every launch in eval; ``reset()`` drains what is left at the epoch's
  end. A flush prefixes each name with the Looper's tag, converts the
  buffered device scalars to floats (the one host sync) and logs them at
  the tracker's own ``iter_idx``, which then advances (stateful);
* a backend whose factory raises ``ImportError`` (``tensorboard`` or
  ``wandb`` not installed) falls back to ``jsonl`` with a warning, as in
  the reference.

With run telemetry on, each flush is a ``flush`` span, its host reads go
through the explicit-transfer helper (legal under strict mode), and the
registry's snapshot rides along under ``obs/*`` (``health/*`` kept as it
is); the tracker's run directory becomes the telemetry files' default.
"""

from __future__ import annotations

import contextlib
import json
import os
import time
from typing import Optional

import numpy as np
import torch

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import PRIORITY_TRACKER, Capsule

__all__ = ["Tracker", "JsonlBackend", "TensorBoardBackend", "WandbBackend",
           "register_tracker_backend"]


class JsonlBackend:
    """One JSON object per flush, appended to ``<dir>/<project>.jsonl``."""

    def __init__(self, project: str, directory: str = "runs") -> None:
        os.makedirs(directory, exist_ok=True)
        self._path = os.path.join(directory, f"{project}.jsonl")
        self._file = open(self._path, "a", buffering=1)

    def log_scalars(self, scalars: dict, step: int) -> None:
        self._file.write(json.dumps({"step": step, "time": time.time(), **scalars}) + "\n")

    def log_images(self, images: dict, step: int) -> None:
        pass  # not representable in jsonl

    def close(self) -> None:
        self._file.close()


class TensorBoardBackend:
    def __init__(self, project: str, directory: str = "runs") -> None:
        from torch.utils.tensorboard import SummaryWriter  # needs the tensorboard package

        self._writer = SummaryWriter(os.path.join(directory, project))

    def log_scalars(self, scalars: dict, step: int) -> None:
        for key, value in scalars.items():
            self._writer.add_scalar(key, value, step)

    def log_images(self, images: dict, step: int) -> None:
        for key, value in images.items():
            self._writer.add_image(key, np.asarray(value), step, dataformats="HWC")

    def close(self) -> None:
        self._writer.close()


class WandbBackend:
    """Weights & Biases; without ``wandb`` installed the factory raises
    ImportError and ``Tracker.setup`` falls back to jsonl."""

    def __init__(self, project: str, directory: str = "runs") -> None:
        import wandb

        self._wandb = wandb
        self._run = wandb.init(project=project, dir=directory)

    def log_scalars(self, scalars: dict, step: int) -> None:
        self._run.log(dict(scalars), step=step)

    def log_images(self, images: dict, step: int) -> None:
        self._run.log({k: self._wandb.Image(np.asarray(v)) for k, v in images.items()}, step=step)

    def close(self) -> None:
        self._run.finish()


_BACKENDS = {"jsonl": JsonlBackend, "tensorboard": TensorBoardBackend, "wandb": WandbBackend}


def register_tracker_backend(name: str, factory) -> None:
    """Register ``factory(project, directory)`` under ``name``; it returns a
    backend with ``log_scalars(dict, step)``, ``log_images(dict, step)``
    and ``close()`` (:class:`JsonlBackend` is the minimal shape)."""
    _BACKENDS[name] = factory


def _host(value):
    return value.detach().cpu().numpy() if isinstance(value, torch.Tensor) else np.asarray(value)


class Tracker(Capsule):
    """``backend``: a registered name or a duck-typed backend instance
    (shared across capsules under the name of its type)."""

    def __init__(self, backend="jsonl", project: str = "rocket", config: Optional[dict] = None,
                 directory: str = "runs", statefull: bool = True,
                 priority: int = PRIORITY_TRACKER, runtime=None) -> None:
        super().__init__(statefull=statefull, priority=priority, runtime=runtime)
        if isinstance(backend, str):
            self._backend_name, self._backend_instance = backend, None
        else:
            missing = [m for m in ("log_scalars", "log_images", "close")
                       if not callable(getattr(backend, m, None))]
            if missing:
                raise RuntimeError(f"Tracker: backend instance {type(backend).__name__} lacks "
                                   f"{missing}; see JsonlBackend for the contract.")
            self._backend_name = type(backend).__name__
            self._backend_instance = backend
        self._project = project
        self._config = config or {}
        self._directory = directory
        self._backend = None
        self._iter_idx = 0

    # -- events ------------------------------------------------------------

    def setup(self, attrs: Attributes | None = None) -> None:
        super().setup(attrs)
        runtime = self._runtime
        backend = runtime.get_tracker(self._backend_name)
        if backend is None and runtime.is_main_process:
            if self._backend_instance is not None:
                backend = self._backend_instance
            else:
                factory = _BACKENDS.get(self._backend_name)
                if factory is None:
                    raise RuntimeError(f"Tracker: unknown backend {self._backend_name!r}; "
                                       f"available: {sorted(_BACKENDS)} (register custom ones "
                                       "with register_tracker_backend)")
                try:
                    backend = factory(self._project, self._directory)
                except ImportError:
                    self.log_warning(f"backend {self._backend_name!r} unavailable, falling "
                                     "back to jsonl")
                    backend = JsonlBackend(self._project, self._directory)
            runtime.init_tracker(self._backend_name, backend)
            telemetry = getattr(runtime, "telemetry", None)
            if telemetry is not None:
                # telemetry.json lands beside the run's log unless the
                # Runtime was given a telemetry_dir.
                telemetry.suggest_out_dir(os.path.join(self._directory, self._project))
            if self._config:
                backend.log_scalars({f"config/{k}": v for k, v in self._config.items()
                                     if isinstance(v, (int, float))}, step=0)
        self._backend = backend

    def set(self, attrs: Attributes | None = None) -> None:
        super().set(attrs)
        if attrs is not None:
            attrs.tracker = Attributes(scalars=Attributes(), images=Attributes())

    def launch(self, attrs: Attributes | None = None) -> None:
        if attrs is None or attrs.tracker is None:
            return
        if attrs.mode == "train" and not attrs.sync_gradients:
            return  # training flushes only on the sync boundary
        self._flush(attrs)

    def reset(self, attrs: Attributes | None = None) -> None:
        if attrs is not None and attrs.tracker is not None:
            self._flush(attrs)  # what is left of the epoch
            attrs.tracker = None
        super().reset(attrs)

    def destroy(self, attrs: Attributes | None = None) -> None:
        """Drop the backend handle. A backend registered in the runtime is
        closed by ``Runtime.end_training`` (other capsules may share it);
        one that is not is closed here."""
        backend, self._backend = self._backend, None
        if backend is not None and self._runtime is not None:
            if self._runtime.get_tracker(self._backend_name) is not backend:
                close = getattr(backend, "close", None)
                if close is not None:
                    try:
                        close()
                    except Exception as exc:  # noqa: BLE001 — teardown path
                        self.log_warning(f"backend close failed: {exc!r}")
        super().destroy(attrs)

    # -- flush -------------------------------------------------------------

    def _flush(self, attrs: Attributes) -> None:
        scalars = attrs.tracker.scalars or {}
        images = attrs.tracker.images or {}
        if not scalars and not images:
            return
        telemetry = getattr(self._runtime, "telemetry", None)
        obs_on = telemetry is not None and telemetry.enabled
        span = telemetry.span("tracker/flush", cat="flush") if obs_on else contextlib.nullcontext()
        with span:
            self._flush_to_backend(attrs, scalars, images, telemetry if obs_on else None)

    def _flush_to_backend(self, attrs: Attributes, scalars, images, telemetry) -> None:
        from rocket_tpu_torch.runtime import explicit_transfer

        tag = attrs.looper.tag if attrs.looper is not None else None
        name = (lambda k: f"{tag}/{k}" if tag else k)  # noqa: E731
        if self._backend is not None:
            # The flush is the deliberate host read of the buffered device
            # scalars: an explicit transfer, legal under strict mode.
            with explicit_transfer():
                host_scalars = {name(k): float(_host(v)) for k, v in scalars.items()}
                host_images = {name(k): _host(v) for k, v in images.items()}
            if host_scalars:
                self._backend.log_scalars(host_scalars, self._iter_idx)
            if host_images:
                self._backend.log_images(host_images, self._iter_idx)
            if telemetry is not None:
                # The registry's snapshot (host floats) under obs/*; health/*
                # and keys already under obs/ keep their names.
                snap = telemetry.scalars_snapshot()
                if snap:
                    self._backend.log_scalars(
                        {(k if k.startswith(("health/", "obs/")) else f"obs/{k}"): v
                         for k, v in snap.items()}, self._iter_idx)
        attrs.tracker.scalars = Attributes()
        attrs.tracker.images = Attributes()
        self._iter_idx += 1

    # -- checkpoint state --------------------------------------------------

    def state_dict(self) -> dict:
        return {"iter_idx": self._iter_idx}

    def load_state_dict(self, state: dict) -> None:
        self._iter_idx = int(state["iter_idx"])
