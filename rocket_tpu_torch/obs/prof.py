"""The bounded-overhead trace-window policy (counterpart of the
``ProfPolicy`` and ``parse_step_window`` of ``rocket_tpu/obs/prof.py``).
The trace parser and its ``obs/prof/*`` gauges are ROADMAP Queue A 7b
(the registry they publish into exists since the ops plane's training
half)."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

__all__ = ["ProfPolicy", "parse_step_window"]


@dataclass(frozen=True)
class ProfPolicy:
    """Trace-window policy (``ROCKET_TPU_PROF``).

    ``steps`` consecutive steps are traced per window; with ``every`` > 0
    a new window opens each time the step counter crosses another
    multiple of ``every``, otherwise exactly one window opens at
    ``start``. The tracer is live for ``steps / every`` of the run.

    Env grammar (off unless set):

    * ``ROCKET_TPU_PROF=1`` — one window, defaults (3 steps at step 10);
    * ``ROCKET_TPU_PROF=A:B`` — one window over steps ``[A, B)``;
    * ``ROCKET_TPU_PROF=N@M`` — N steps every M steps (first window at
      step M).
    """

    steps: int = 3
    every: int = 0
    start: int = 10

    @classmethod
    def from_env(cls, value: Optional[str]) -> Optional["ProfPolicy"]:
        """Parse the ``ROCKET_TPU_PROF`` grammar; None = tracing off. Raises
        ``ValueError`` on a malformed value: a typo'd policy must not run
        untraced."""
        if value is None:
            return None
        text = value.strip()
        if text in ("", "0", "off", "false"):
            return None
        if text in ("1", "on", "true"):
            return cls()
        if "@" in text:
            steps_s, _, every_s = text.partition("@")
            steps, every = int(steps_s), int(every_s)
            if steps <= 0 or every <= steps:
                raise ValueError(f"ROCKET_TPU_PROF={value!r}: N@M needs 0 < N < M")
            return cls(steps=steps, every=every, start=every)
        if ":" in text:
            try:
                start, stop = parse_step_window(text)
            except ValueError as exc:
                raise ValueError(f"ROCKET_TPU_PROF={value!r}: {exc}") from exc
            return cls(steps=stop - start, every=0, start=start)
        raise ValueError(f"ROCKET_TPU_PROF={value!r}: expected '1', 'A:B' or 'N@M'")

    def window_start(self, step: int) -> bool:
        """Does a trace window open at ``step``?"""
        if self.every > 0:
            return step >= self.start and (step - self.start) % self.every == 0
        return step == self.start


def parse_step_window(text: str) -> Tuple[int, int]:
    """``"A:B"`` -> (A, B) with 0 <= A < B."""
    start_s, sep, stop_s = text.partition(":")
    if not sep:
        raise ValueError(f"trace window {text!r}: expected 'A:B'")
    start, stop = int(start_s), int(stop_s)
    if start < 0 or stop <= start:
        raise ValueError(f"trace window {text!r}: needs 0 <= A < B")
    return start, stop
