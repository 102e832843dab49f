"""Host wall-clock spans, written as a Chrome trace (counterpart of
``rocket_tpu/obs/spans.py``).

Each capsule event, data wait, checkpoint write, tracker flush and first
(``compile``) wave becomes one complete (``"ph": "X"``) event on its
thread's row, which Perfetto and chrome://tracing load as they are. The
Looper's step spans also open a ``torch.profiler.record_function`` range
(``obs/telemetry.py``), so a profiler trace of the same run shows the same
step boundaries on the card's timeline.

A span costs two ``perf_counter`` reads and a list append: no device op,
no sync, so it is legal under the strict guard. The buffer is bounded
(``max_events``); what does not fit is counted in :attr:`SpanRecorder.
dropped`. The file layout is the reference's, so each package loads the
other's traces (:func:`load_chrome_trace`).
"""

from __future__ import annotations

import json
import os
import threading
import time
from typing import Optional

__all__ = ["SpanRecorder", "load_chrome_trace"]


class SpanRecorder:
    """Finished spans ``(name, cat, t_start, duration, tid)`` plus, per
    thread, the stack of spans still open — what the watchdog reports a
    stalled thread to be inside (:meth:`open_spans`)."""

    def __init__(self, max_events: int = 200_000) -> None:
        self.max_events = int(max_events)
        self.t0 = time.perf_counter()
        self.dropped = 0
        self._done: list = []
        self._live: dict = {}  # thread id -> [(name, cat, t_start), ...]
        self._guard = threading.Lock()

    def add(self, name: str, cat: Optional[str], t_start: float, duration: float,
            tid: Optional[int] = None) -> None:
        tid = threading.get_ident() if tid is None else tid
        with self._guard:
            if len(self._done) < self.max_events:
                self._done.append((name, cat, t_start, duration, tid))
            else:
                self.dropped += 1

    def push_open(self, name: str, cat: Optional[str], t_start: float) -> None:
        tid = threading.get_ident()
        if tid not in self._live:
            with self._guard:
                self._live.setdefault(tid, [])
        self._live[tid].append((name, cat, t_start))

    def pop_open(self) -> None:
        stack = self._live.get(threading.get_ident())
        if stack:
            stack.pop()

    def open_spans(self) -> dict:
        """``{tid: [outermost, ..., innermost]}`` of the spans still open."""
        return {tid: [entry[0] for entry in list(stack)]
                for tid, stack in list(self._live.items()) if stack}

    def __len__(self) -> int:
        return len(self._done)

    def events(self) -> list:
        with self._guard:
            return list(self._done)

    def category_totals(self) -> dict:
        """Seconds per category, nested spans counted in each (the exclusive
        split is ``obs/goodput.py``'s)."""
        totals: dict = {}
        for _, cat, _, dur, _ in self.events():
            if cat is not None:
                totals[cat] = totals.get(cat, 0.0) + dur
        return totals

    def to_chrome_trace(self) -> dict:
        pid = os.getpid()
        trace = [{"name": name, "cat": cat or "span", "ph": "X",
                  "ts": round((start - self.t0) * 1e6, 3), "dur": round(dur * 1e6, 3),
                  "pid": pid, "tid": tid}
                 for name, cat, start, dur, tid in self.events()]
        trace += [{"name": "thread_name", "ph": "M", "pid": pid, "tid": thread.ident,
                   "args": {"name": thread.name}}
                  for thread in threading.enumerate() if thread.ident is not None]
        return {"traceEvents": trace, "displayTimeUnit": "ms",
                "otherData": {"producer": "rocket_tpu_torch.obs", "dropped": self.dropped}}

    def write(self, path: str) -> str:
        """Write the trace atomically (temp file, then rename)."""
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = f"{path}.tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(self.to_chrome_trace(), f)
        os.replace(tmp, path)
        return path


def load_chrome_trace(path: str) -> list:
    """The event list of a Chrome-trace file, in either form (the
    ``{"traceEvents": [...]}`` object :meth:`SpanRecorder.write` emits, or a
    bare list), each event checked to be a dict with a ``"ph"``."""
    with open(path, "r", encoding="utf-8") as f:
        doc = json.load(f)
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError(f"{path}: no Chrome-trace event list")
    bad = next((e for e in events if not isinstance(e, dict) or "ph" not in e), None)
    if bad is not None:
        raise ValueError(f"{path}: malformed trace event {bad!r}")
    return events
