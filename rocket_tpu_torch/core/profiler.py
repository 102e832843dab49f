"""Profiler capsule — step timing and ``torch.profiler`` traces
(counterpart of ``rocket_tpu/core/profiler.py``).

Two jobs:

* **always-on step timing**: the host clock between iterations after
  ``warmup`` steps, smoothed as an EMA, published as
  ``attrs.looper.state.steps_per_sec`` and ``attrs.tracker.scalars
  ["perf/steps_per_sec"]`` — and, when ``flops_per_step`` (or
  ``flops_per_sample`` × ``attrs.batch_info.size``) is given, an ``mfu``
  scalar against the card's dense bf16 peak (``utils/perf.py``; None on
  the CPU or an unknown card, so no MFU is reported there);
* **trace capture**: a ``torch.profiler`` window over steps
  ``[trace_start, trace_start + trace_steps)`` (CPU activity, and CUDA
  where a card is present) written as a Chrome trace into ``trace_dir``
  (default ``traces``); ``destroy`` closes a still-open window. With no
  explicit ``trace_start``, ``ROCKET_TPU_PROF`` installs the
  bounded-overhead policy (:class:`rocket_tpu_torch.obs.prof.ProfPolicy`:
  ``N@M`` traces N steps every M, off by default). Inside a window each
  step runs under a ``ProfilerStep#N`` ``record_function`` range (from
  one launch of the capsule to the next), and each closed window is
  parsed (``obs/prof.parse_trace``) into the ``obs/prof/*`` gauges of
  the telemetry registry when telemetry is on.

The host clock measures the launch loop. Eager PyTorch queues kernels
ahead of the card, and once the queue is full each step waits for the
card, so after a few steps the clock reads the device's step time. With
telemetry on, the capsule sets the registry's ``perf/steps_per_sec`` and
``perf/mfu`` gauges as the reference does.
"""

from __future__ import annotations

import os
import time
from typing import Optional

import torch

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import Capsule
from rocket_tpu_torch.obs.prof import ProfPolicy

__all__ = ["Profiler"]


class Profiler(Capsule):
    def __init__(self, trace_dir: Optional[str] = None, trace_start: Optional[int] = None,
                 trace_steps: int = 3, trace_every: int = 0,
                 flops_per_step: Optional[float] = None,
                 flops_per_sample: Optional[float] = None, warmup: int = 2,
                 priority: int = 150, runtime=None) -> None:
        super().__init__(statefull=False, priority=priority, runtime=runtime)
        self._trace_dir = trace_dir
        if trace_start is None and trace_every > 0:
            # Periodic capture with no explicit first window: N@M semantics,
            # the first window opens at step trace_every.
            trace_start = int(trace_every)
        if trace_start is None:
            # No explicit window: the env policy (off by default) decides; a
            # malformed value raises here, at construction.
            policy = ProfPolicy.from_env(os.environ.get("ROCKET_TPU_PROF"))
            if policy is not None:
                trace_start, trace_steps, trace_every = policy.start, policy.steps, policy.every
        if 0 < trace_every <= trace_steps:
            raise ValueError("Profiler: trace_every must exceed trace_steps (the window must "
                             "close before the next opens)")
        self._trace_start = trace_start
        self._trace_steps = int(trace_steps)
        self._trace_every = int(trace_every)
        self._policy = None if trace_start is None else ProfPolicy(
            steps=self._trace_steps, every=self._trace_every, start=int(trace_start))
        self._flops_per_step = flops_per_step
        self._flops_per_sample = flops_per_sample
        self._warmup = int(warmup)
        self._iter_idx = 0
        self._prof = None
        self._step_range = None
        self._window_open_at = 0
        self._windows = 0
        self._t_last: Optional[float] = None
        self._ema: Optional[float] = None  # smoothed step seconds
        self._peak: Optional[float] = None

    # -- events --------------------------------------------------------------

    def setup(self, attrs: Attributes | None = None) -> None:
        super().setup(attrs)
        from rocket_tpu_torch.utils.perf import peak_flops

        self._peak = peak_flops(self._runtime.device)
        if self._trace_dir is None:
            self._trace_dir = "traces"

    def set(self, attrs: Attributes | None = None) -> None:
        super().set(attrs)
        self._t_last = None  # epoch boundary: inter-epoch time is not a step

    def launch(self, attrs: Attributes | None = None) -> None:
        self._maybe_trace()
        self._iter_idx += 1

        now = time.perf_counter()
        if self._t_last is None:
            self._t_last = now
            return
        dt, self._t_last = now - self._t_last, now
        if self._iter_idx <= self._warmup:
            return  # the first steps build kernels and warm the allocator
        self._ema = dt if self._ema is None else 0.9 * self._ema + 0.1 * dt

        steps_per_sec = 1.0 / self._ema if self._ema else 0.0
        flops = self._flops_per_step
        if flops is None and self._flops_per_sample is not None and attrs is not None:
            info = attrs.batch_info
            if info is not None and info.size is not None:
                flops = self._flops_per_sample * info.size
        # One process drives one card, so the step's FLOPs are one card's.
        mfu = flops * steps_per_sec / self._peak if flops is not None and self._peak else None
        telemetry = getattr(self._runtime, "telemetry", None)
        if telemetry is not None and telemetry.enabled:
            # The numbers the bar shows, in the registry (telemetry.json).
            telemetry.registry.gauge("perf/steps_per_sec").set(steps_per_sec)
            if mfu is not None:
                telemetry.registry.gauge("perf/mfu").set(mfu)
        if attrs is None:
            return
        if attrs.looper is not None and attrs.looper.state is not None:
            attrs.looper.state.steps_per_sec = round(steps_per_sec, 2)
            if mfu is not None:
                attrs.looper.state.mfu = round(mfu, 4)
        if attrs.tracker is not None and attrs.tracker.scalars is not None:
            attrs.tracker.scalars["perf/steps_per_sec"] = steps_per_sec
            if mfu is not None:
                attrs.tracker.scalars["perf/mfu"] = mfu

    def destroy(self, attrs: Attributes | None = None) -> None:
        self._stop_trace()
        super().destroy(attrs)

    # -- trace window ----------------------------------------------------------

    @property
    def trace_files(self) -> list:
        """The Chrome traces written so far, in window order."""
        return [os.path.join(self._trace_dir, f"window_{i}.json") for i in range(self._windows)]

    def _maybe_trace(self) -> None:
        if self._policy is None:
            return
        if self._prof is not None and self._iter_idx - self._window_open_at >= self._trace_steps:
            self._stop_trace()
        if self._prof is None and self._policy.window_start(self._iter_idx):
            from torch.profiler import ProfilerActivity, profile

            activities = [ProfilerActivity.CPU]
            if self._runtime.device.type == "cuda":
                activities.append(ProfilerActivity.CUDA)
            os.makedirs(self._trace_dir, exist_ok=True)
            self._prof = profile(activities=activities)
            self._prof.start()
            self._window_open_at = self._iter_idx
            self.log_info(f"profiler: tracing to {self._trace_dir}")
        if self._prof is not None:
            # The next step's host range: its launches file its kernels.
            self._close_step_range()
            self._step_range = torch.profiler.record_function(f"ProfilerStep#{self._iter_idx}")
            self._step_range.__enter__()

    def _close_step_range(self) -> None:
        if self._step_range is not None:
            self._step_range.__exit__(None, None, None)
            self._step_range = None

    def _stop_trace(self) -> None:
        if self._prof is None:
            return
        self._close_step_range()
        if self._runtime is not None and self._runtime.device.type == "cuda":
            torch.cuda.synchronize(self._runtime.device)  # the window's kernels end in it
        self._prof.stop()
        self._prof.export_chrome_trace(os.path.join(self._trace_dir,
                                                    f"window_{self._windows}.json"))
        self._prof = None
        self._windows += 1
        self.log_info("profiler: trace complete")
        self._publish_window()

    def _publish_window(self) -> None:
        """Parse the just-closed window into measured step attribution and
        publish it as ``obs/prof/*`` gauges: host work once per window,
        and, as in the reference, never fatal to training (a failed parse
        is logged as a warning and publishes nothing)."""
        telemetry = getattr(self._runtime, "telemetry", None)
        if telemetry is None or not telemetry.enabled:
            return
        from rocket_tpu_torch.obs.prof import (
            load_trace_events,
            parse_trace,
            prof_record,
            publish_prof,
        )

        try:
            summary = parse_trace(load_trace_events(self.trace_files[-1]))
        except ValueError as exc:
            self.log_warning(f"profiler: trace parse failed: {exc}")
            return
        publish_prof(telemetry.registry, prof_record(summary))
