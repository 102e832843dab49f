"""Goodput: the run's wall clock split into exclusive phases (counterpart
of ``rocket_tpu/obs/goodput.py``).

The phases are the reference's :data:`CATEGORIES`: ``compile`` (the first
wave of a Looper, which in the port builds the kernels and warms the
allocator where the reference traces and compiles), ``data_wait``,
``step`` (the goodput numerator), ``checkpoint``, ``flush`` and ``other``,
the remainder, so the phases always add up to the wall clock. A phase
entered inside another pauses it (self time), per thread; host arithmetic
only.
"""

from __future__ import annotations

import threading
import time
from typing import Optional

__all__ = ["CATEGORIES", "Goodput", "render_report"]

#: Phases in report order; "other" is derived, never charged.
CATEGORIES = ("compile", "data_wait", "step", "checkpoint", "flush", "other")
_CHARGED = CATEGORIES[:-1]


class Goodput:
    """Per-phase seconds from a per-thread stack of ``(phase, mark)``."""

    def __init__(self) -> None:
        self._seconds = dict.fromkeys(_CHARGED, 0.0)
        self._guard = threading.Lock()
        self._tls = threading.local()

    def _stack(self) -> list:
        if not hasattr(self._tls, "stack"):
            self._tls.stack = []
        return self._tls.stack

    def _add(self, phase: str, seconds: float) -> None:
        if seconds > 0.0:
            with self._guard:
                self._seconds[phase] = self._seconds.get(phase, 0.0) + seconds

    def push(self, cat: str, now: Optional[float] = None) -> None:
        """Enter ``cat``; the phase it interrupts is charged up to now."""
        now = time.perf_counter() if now is None else now
        stack = self._stack()
        if stack:
            outer, mark = stack[-1]
            self._add(outer, now - mark)
            stack[-1] = (outer, now)
        stack.append((cat, now))

    def pop(self, now: Optional[float] = None) -> None:
        """Leave the innermost phase, charge it, and resume the one below."""
        now = time.perf_counter() if now is None else now
        stack = self._stack()
        if not stack:
            return
        phase, mark = stack.pop()
        self._add(phase, now - mark)
        if stack:
            stack[-1] = (stack[-1][0], now)

    def totals(self) -> dict:
        with self._guard:
            return dict(self._seconds)

    def report(self, total_wall_s: float) -> dict:
        """Seconds and fractions of each phase over ``total_wall_s`` (at
        least what was charged), ``other`` taking the remainder, and the
        headline ``goodput_fraction`` (the ``step`` share)."""
        charged = self.totals()
        total = max(float(total_wall_s), sum(charged.values()))
        seconds = {cat: round(charged.get(cat, 0.0), 6) for cat in _CHARGED}
        seconds["other"] = round(max(0.0, total - sum(charged.values())), 6)
        shares = {cat: round(s / total if total > 0 else 0.0, 6) for cat, s in seconds.items()}
        return {"total_wall_s": round(total, 6), "categories": seconds, "fractions": shares,
                "goodput_fraction": shares["step"]}


def render_report(report: dict) -> str:
    """The goodput table of ``obs report``. A record with no steps (a run
    that died before its first wave, ``total_wall_s`` 0, no fractions) gets
    its fractions derived here without dividing by zero, and says "no steps
    recorded" in place of a 0.0% step share."""
    total = float(report.get("total_wall_s", 0.0) or 0.0)
    seconds = report.get("categories", {})
    shares = report.get("fractions") or {cat: (s / total if total > 0 else 0.0)
                                          for cat, s in seconds.items()}
    stepless = float(seconds.get("step", 0.0) or 0.0) == 0.0
    headline = "no steps recorded" if stepless else f"{report.get('goodput_fraction', 0.0):.1%}"
    lines = [f"total wall-clock: {total:.3f}s   goodput (step fraction): {headline}",
             f"{'phase':<12} {'seconds':>10} {'fraction':>9}"]
    for cat in (c for c in CATEGORIES if c in seconds):
        if cat == "step" and stepless:
            lines.append(f"{'step':<12} {'(no steps recorded)':>21}")
        else:
            lines.append(f"{cat:<12} {seconds[cat]:>10.3f} {shares.get(cat, 0.0):>8.1%}")
    return "\n".join(lines)
