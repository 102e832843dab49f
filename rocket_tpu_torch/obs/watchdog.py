"""Hang watchdog: a report when the step loop stops beating (counterpart of
``rocket_tpu/obs/watchdog.py``).

A wedged kernel, a deadlocked data worker or a blocked host read all look
the same from outside: the bar stops and nothing is printed. A daemon
thread watches a heartbeat that the Looper beats after every wave; when
none lands within ``deadline_s`` it reports, with the process still alive,
every Python thread's stack, the spans each thread was inside, and the
CUDA caching allocator's allocated and reserved bytes (a host query of the
allocator: no transfer, no sync; where the reference lists its live jax
arrays). The report is diagnostic: the run goes on. After
``escalate_after`` reports in a row without a beat, ``on_escalate`` fires
once (the Telemetry dumps the flight recorder). The watchdog is armed only
while a Looper iterates, so setup and an eval pass between epochs cannot
trip it.
"""

from __future__ import annotations

import sys
import threading
import time
import traceback
from typing import Callable, Optional

__all__ = ["Watchdog"]


def allocator_line() -> str:
    """One line on the CUDA caching allocator: bytes allocated and reserved
    on the current card, or why there is nothing to say."""
    try:
        import torch

        if not torch.cuda.is_available() or not torch.cuda.is_initialized():
            return "cuda allocator: no CUDA device in use"
        allocated = torch.cuda.memory_allocated()
        reserved = torch.cuda.memory_reserved()
        return (f"cuda allocator: {allocated / (1 << 20):.1f} MiB allocated, "
                f"{reserved / (1 << 20):.1f} MiB reserved")
    except Exception as exc:  # a wedged driver must not stop the stack dump
        return f"cuda allocator: unavailable ({type(exc).__name__})"


class Watchdog:
    """``deadline_s``: seconds without a beat before a report.
    ``on_stall(report)`` gets each report, ``on_escalate(report)`` the one
    that completes ``escalate_after`` windows in a row without a beat. The
    stall count goes to ``registry`` as ``watchdog/stalls``."""

    def __init__(self, deadline_s: float, on_stall: Optional[Callable[[str], None]] = None,
                 spans=None, registry=None, logger=None, poll_s: Optional[float] = None,
                 escalate_after: int = 3,
                 on_escalate: Optional[Callable[[str], None]] = None) -> None:
        if deadline_s <= 0:
            raise ValueError(f"Watchdog: deadline_s must be > 0, got {deadline_s}")
        self.deadline_s = float(deadline_s)
        self.escalate_after = int(escalate_after)
        self._on_stall, self._on_escalate = on_stall, on_escalate
        self._spans, self._registry, self._logger = spans, registry, logger
        self._poll_s = min(1.0, self.deadline_s / 4.0) if poll_s is None else poll_s
        self._armed = False
        self._last_beat = time.monotonic()
        self._quit = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self._in_a_row = 0
        self._escalated = False
        self.stall_count = 0
        self.escalation_count = 0
        self.last_report: Optional[str] = None
        #: ``{"rank", "hostname", "pid"}`` for the report's header (set by
        #: the Telemetry); None prints no process line.
        self.identity: Optional[dict] = None

    def start(self) -> None:
        if self._thread is None:
            self._thread = threading.Thread(target=self._watch, name="rocket-tpu-torch-watchdog",
                                            daemon=True)
            self._thread.start()

    def stop(self) -> None:
        self._quit.set()
        thread, self._thread = self._thread, None
        if thread is not None and thread.is_alive():
            thread.join(timeout=2.0)

    def arm(self) -> None:
        self._last_beat = time.monotonic()
        self._in_a_row, self._escalated = 0, False
        self._armed = True

    def disarm(self) -> None:
        self._armed = False

    def beat(self) -> None:
        """Progress: the clock restarts and escalation re-arms."""
        self._last_beat = time.monotonic()
        self._in_a_row, self._escalated = 0, False

    def _call(self, fn, report: str) -> None:
        if fn is None:
            return
        try:
            fn(report)
        except Exception:  # noqa: BLE001 — a callback must not kill the watcher
            pass

    def _watch(self) -> None:
        while not self._quit.wait(self._poll_s):
            idle = time.monotonic() - self._last_beat
            if not self._armed or idle < self.deadline_s:
                continue
            report = self.last_report = self._report(idle)
            if self._logger is not None:
                self._logger.error("%s", report)
            else:
                print(report, file=sys.stderr, flush=True)
            self._call(self._on_stall, report)
            self._in_a_row += 1
            if not self._escalated and self._in_a_row >= self.escalate_after:
                if self._on_escalate is not None:
                    self._escalated = True
                    self.escalation_count += 1
                    self._call(self._on_escalate, report)
            # Counted last: a reader that sees the count move sees the
            # report delivered.
            if self._registry is not None:
                self._registry.counter("watchdog/stalls").inc()
            self.stall_count += 1
            self._last_beat = time.monotonic()  # one report per window

    def _report(self, idle: float) -> str:
        lines = [f"rocket_tpu_torch watchdog: no step completed for {idle:.1f}s "
                 f"(deadline {self.deadline_s:.1f}s) — dumping diagnostics"]
        if self.identity:
            lines.append(f"process: rank {self.identity.get('rank')} on "
                         f"{self.identity.get('hostname')} (pid {self.identity.get('pid')})")
        live = self._spans.open_spans() if self._spans is not None else {}
        if live:
            lines.append("open spans (innermost last):")
            lines += [f"  [tid {tid}] " + " > ".join(stack) for tid, stack in live.items()]
        lines.append(allocator_line())
        names = {t.ident: t.name for t in threading.enumerate()}
        for tid, frame in sys._current_frames().items():
            if tid != threading.get_ident():  # the watcher's own stack says nothing
                lines.append(f"thread {names.get(tid, '?')} (tid {tid}):")
                lines.append("".join(traceback.format_stack(frame)).rstrip())
        return "\n".join(lines)
