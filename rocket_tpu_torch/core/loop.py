"""Looper — the per-phase iteration loop, one per train/val/test phase
(counterpart of ``rocket_tpu/core/loop.py``).

* ``set()`` infers the iteration count by summing child ``Dataset``
  totals (an explicit ``repeats`` wins; none at all is an error), and
  publishes the loop contract ``attrs.looper = {repeats, state,
  terminate, tag}``;
* ``launch()`` per iteration clears ``attrs.batch``, sets ``attrs.mode``,
  runs the children as one dispatch wave and breaks on
  ``attrs.looper.terminate``;
* ``grad_enabled`` becomes ``attrs.mode = "train" | "eval"``, which
  Module / Loss / Optimizer read from the bag (the reference's explicit
  mode, not torch's ambient grad mode); ``run_every`` skips whole
  epochs; nested Loopers are forbidden; ``epoch_idx`` / ``batch_idx`` are
  the stateful position.

The ops hooks of the reference loop: with telemetry on, each wave is a
step span (``compile`` for the first wave this Looper drives, which builds
the kernels) with a ``torch.profiler.record_function`` range, and the
hang watchdog is armed for the loop and beaten after every wave; under
strict mode every wave but the first of a launch runs under the CUDA sync
guard (``runtime.StrictMode``); at the loop's end the health words still in
their fetch lag are decoded (under ``dump_and_halt`` that raises here);
an exception escaping the loop writes a black-box bundle first.

Resilience: at every wave boundary the Looper polls the runtime's drain
flag (a SIGTERM lands mid-wave, the wave finishes, and the next boundary
writes ``Checkpointer.save_drain`` and raises ``GracefulDrain``, exit code
84) and calls the fault injector's ``step_hook`` (``ROCKET_TPU_FAULTS``),
so a scheduled kill or wedge strikes the real loop.
"""

from __future__ import annotations

import contextlib
from typing import Iterable, Optional

from rocket_tpu_torch.core.attributes import Attributes
from rocket_tpu_torch.core.capsule import Capsule
from rocket_tpu_torch.core.dispatcher import Dispatcher

__all__ = ["Looper"]


class Looper(Dispatcher):
    """Drives its children for ``repeats`` iterations per epoch.

    ``tag``: phase name. ``grad_enabled``: True -> ``attrs.mode =
    "train"``, False -> ``"eval"``. ``repeats``: explicit iteration count
    (None: inferred each epoch from child ``Dataset`` totals).
    ``run_every``: run only on epochs where ``epoch_idx % run_every ==
    0``. ``progress``: a tqdm bar (when tqdm is installed) whose postfix,
    every ``postfix_every`` iterations, reads ``attrs.looper.state`` —
    a device sync each time it does.
    """

    def __init__(self, capsules: Iterable[Capsule] = (), tag: str = "train",
                 grad_enabled: bool = True, repeats: Optional[int] = None, run_every: int = 1,
                 progress: bool = True, postfix_every: int = 1, statefull: bool = True,
                 priority: int = 1000, runtime=None) -> None:
        super().__init__(capsules, statefull=statefull, priority=priority, runtime=runtime)
        if run_every < 1:
            raise RuntimeError(f"Looper: run_every must be >= 1, got {run_every}")
        self._tag = tag
        self._grad_enabled = grad_enabled
        self._explicit_repeats = repeats
        self._repeats: Optional[int] = repeats
        self._run_every = run_every
        self._progress = progress
        self._postfix_every = max(1, postfix_every)
        self._epoch_idx = 0
        self._batch_idx = 0
        self._active = True
        self._warmed = False
        self._in_wave = False

    @property
    def tag(self) -> str:
        return self._tag

    @property
    def mode(self) -> str:
        return "train" if self._grad_enabled else "eval"

    def guard(self, capsules: Iterable[Capsule]) -> None:
        super().guard(capsules)
        for capsule in capsules:
            if isinstance(capsule, Looper):
                raise RuntimeError("Looper: nested Loopers are forbidden; compose phases "
                                   "side by side under the Launcher.")

    def _gated(self, attrs: Attributes | None) -> bool:
        epoch = 0
        if attrs is not None and attrs.launcher is not None:
            epoch = attrs.launcher.epoch_idx or 0
        return epoch % self._run_every != 0

    # -- events ------------------------------------------------------------

    def set(self, attrs: Attributes | None = None) -> None:
        self._active = not self._gated(attrs)
        if not self._active:
            return
        attrs = Attributes() if attrs is None else attrs
        if self._explicit_repeats is None:
            self._repeats = self._infer_repeats()
        if self._repeats is None:
            raise RuntimeError("Looper: cannot infer repeats — no child Dataset reports a "
                               "finite total; pass repeats= explicitly.")
        attrs.mode = self.mode
        attrs.looper = Attributes(repeats=self._repeats, state=Attributes(), terminate=False,
                                  tag=self._tag)
        super().set(attrs)

    def launch(self, attrs: Attributes | None = None) -> None:
        if not self._active:
            return
        attrs = Attributes() if attrs is None else attrs
        self.log_debug(f"launch: {self._repeats} iterations [{self._tag}]")
        bar = self._progress_bar()
        runtime = self._runtime
        telemetry = getattr(runtime, "telemetry", None)
        obs_on = telemetry is not None and telemetry.enabled
        strict = getattr(runtime, "strict", None)
        drain = getattr(runtime, "drain", None)
        faults = getattr(runtime, "faults", None)
        if obs_on:
            telemetry.watchdog_arm()
        start = self._batch_idx
        try:
            for it in range(start, self._repeats):
                if drain is not None and drain.requested:
                    self._drain_exit()
                if faults is not None:
                    faults.step_hook(self._tag, self._batch_idx)
                attrs.batch = None
                attrs.mode = self.mode
                # The first wave of a launch runs unguarded (it builds the
                # kernels and uploads the epoch's order); from the second on
                # an implicit host read or blocking copy raises.
                guard = (strict.lifted() if strict is not None and it == start
                         else contextlib.nullcontext())
                span = (telemetry.step_span(self._tag, self._batch_idx,
                                            cat="step" if self._warmed else "compile")
                        if obs_on else contextlib.nullcontext())
                self._in_wave = True
                try:
                    with guard, span:
                        Dispatcher.launch(self, attrs)
                finally:
                    self._in_wave = False
                self._warmed = True
                if obs_on:
                    telemetry.beat()
                if attrs.looper is not None and attrs.looper.terminate:
                    break
                self._batch_idx += 1
                if bar is not None:
                    bar.update(1)
                    if (self._batch_idx % self._postfix_every == 0 and attrs.looper is not None
                            and attrs.looper.state):
                        # A host read for the bar's display: only with progress on, once
                        # every postfix_every steps, through the explicit-transfer helper.
                        from rocket_tpu_torch.runtime import explicit_transfer

                        with explicit_transfer():
                            postfix = {k: f"{float(v):.4g}"  # rocketlint: disable=RKT106
                                       for k, v in attrs.looper.state.items()}
                        bar.set_postfix(postfix, refresh=False)
            health = getattr(runtime, "health", None)
            if health is not None and health.enabled:
                # The loop's end: decode the words still in their fetch lag,
                # so an anomaly in the last steps acts in this epoch.
                health.drain()
        except Exception as exc:
            # A black box before the stack unwinds (a HealthAnomalyError has
            # already written its own); re-raised unchanged.
            if telemetry is not None:
                telemetry.exception_dump(exc, tag=self._tag, epoch_idx=self._epoch_idx,
                                         batch_idx=self._batch_idx)
            raise
        finally:
            if obs_on:
                telemetry.watchdog_disarm()
            if bar is not None:
                bar.close()

    def reset(self, attrs: Attributes | None = None) -> None:
        if not self._active:
            return
        self._epoch_idx += 1
        self._batch_idx = 0
        super().reset(attrs)
        if attrs is not None:
            attrs.mode = None
            attrs.looper = None

    # -- helpers -----------------------------------------------------------

    def _drain_exit(self) -> None:
        """Honour a drain request at a wave boundary: a drain checkpoint
        through this phase's first Checkpointer (else the first live one of
        the run, so a drain in an eval phase still saves), the
        ``resilience/drains`` count, then :class:`~rocket_tpu_torch.
        resilience.faults.GracefulDrain`, a ``SystemExit``: the process
        unwinds through every ``finally`` and exits 84, which the
        supervisor reads as a clean stop. The black-box handler (``except
        Exception``) does not catch it."""
        from rocket_tpu_torch.core.checkpoint import Checkpointer
        from rocket_tpu_torch.resilience.faults import GracefulDrain

        runtime = self._runtime
        reason = runtime.drain.reason or "drain"
        self.log_info(f"drain requested ({reason}) — checkpointing and exiting "
                      f"[{self._tag}, batch {self._batch_idx}]")
        telemetry = getattr(runtime, "telemetry", None)
        if telemetry is not None:
            # The loop ends here: its watchdog is disarmed before the drain
            # save (a synchronous write of the whole train state, longer than
            # a short deadline's escalation; the reference keeps it armed),
            # as the loop's own finally would. A hung drain is bounded by the
            # sender's grace: the supervisor's --drain-grace, a scheduler's
            # SIGKILL.
            telemetry.watchdog_disarm()
        checkpointers = self.find(Checkpointer) or list(getattr(runtime, "checkpointers", ()))
        path = None
        if checkpointers:
            path = checkpointers[0].save_drain()
        else:
            self.log_warning("drain: no Checkpointer in this run — exiting without a drain "
                             "checkpoint")
        if telemetry is not None and telemetry.enabled:
            telemetry.registry.counter("resilience/drains").inc()
        raise GracefulDrain(checkpoint=path, reason=reason)

    def _infer_repeats(self) -> Optional[int]:
        from rocket_tpu_torch.core.dataset import Dataset

        totals = [d.total for d in self.find(Dataset)]
        totals = [t for t in totals if t is not None]
        return sum(totals) if totals else None

    def _progress_bar(self):
        if not self._progress:
            return None
        try:
            from tqdm import tqdm
        except ImportError:
            return None
        return tqdm(total=self._repeats, initial=self._batch_idx, desc=self._tag, leave=True,
                    dynamic_ncols=True)

    # -- checkpoint state --------------------------------------------------

    def state_dict(self) -> dict:
        """The loop's position. Taken inside a wave (a periodic checkpoint:
        the Checkpointer runs after the Module), it is the position after
        that wave, whose update the checkpoint holds, as the Dataset's and
        the Checkpointer's counts are. The reference records the wave's own
        index there, so its resume from a mid-epoch save under an explicit
        ``repeats`` runs one wave more than the uninterrupted run."""
        return {"epoch_idx": self._epoch_idx,
                "batch_idx": self._batch_idx + (1 if self._in_wave else 0)}

    def load_state_dict(self, state: dict) -> None:
        self._epoch_idx = int(state["epoch_idx"])
        self._batch_idx = int(state["batch_idx"])
