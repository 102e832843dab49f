"""Telemetry: the one object per run that owns the spans, the goodput
split, the metrics registry and the watchdog (counterpart of
``rocket_tpu/obs/telemetry.py``).

The Runtime makes it (``Runtime(telemetry=True)`` or
``ROCKET_TPU_TELEMETRY=1``) and every layer reaches it as
``runtime.telemetry``: ``Capsule.dispatch`` wraps each event in a span,
the Looper wraps each wave in a step span (``compile`` for its first) and
beats the watchdog, the Dataset charges its waits to ``data_wait``, the
Checkpointer its saves to ``checkpoint`` and the Tracker its flushes to
``flush``. Off (the default) it is inert: :meth:`Telemetry.span` hands back
one shared no-op context. On, it is host arithmetic only; the files
(``telemetry.json`` and the Chrome trace ``spans.trace.json``) are written
once, at the end of the run (``Runtime.end_training``), and the live export
plane (:meth:`Telemetry.start_export`, ``obs/export.py``) streams the
registry to shards and ``/metrics`` while it runs. Under a supervisor
(``escalation_exit_code``) a wedged step's escalation exits the process
after the black box is written, so the supervisor restarts it.

No compile listener: the reference counts XLA compile events through
``jax.monitoring``; eager PyTorch has no compile step to count, and
nothing on the port's paths calls ``torch.compile``. The first wave of a
Looper keeps the ``compile`` category (there it builds the kernels and
warms the caching allocator).
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import time
from typing import Optional

from rocket_tpu_torch.obs.export import host_identity
from rocket_tpu_torch.obs.goodput import CATEGORIES, Goodput
from rocket_tpu_torch.obs.registry import MetricsRegistry
from rocket_tpu_torch.obs.spans import SpanRecorder
from rocket_tpu_torch.obs.watchdog import Watchdog

__all__ = ["Telemetry"]

_PHASES = frozenset(CATEGORIES[:-1])


class _Span:
    """A span: a trace event, an open-stack entry while it runs, and the
    goodput phase of its category."""

    __slots__ = ("_tel", "_name", "_cat", "_t0")

    def __init__(self, telemetry: "Telemetry", name: str, cat: Optional[str]) -> None:
        self._tel, self._name, self._cat = telemetry, name, cat

    def __enter__(self) -> "_Span":
        self._t0 = time.perf_counter()
        self._tel.spans.push_open(self._name, self._cat, self._t0)
        if self._cat in _PHASES:
            self._tel.goodput.push(self._cat, self._t0)
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        end = time.perf_counter()
        if self._cat in _PHASES:
            self._tel.goodput.pop(end)
        self._tel.spans.pop_open()
        self._tel.spans.add(self._name, self._cat, self._t0, end - self._t0)


def _finite_json(obj):
    """Non-finite floats as their names ("NaN", "Infinity", "-Infinity"), so
    ``telemetry.json`` is strict JSON (a health gauge holds NaN after an
    anomaly). The black box keeps raw NaN: only the Python CLI reads it."""
    if isinstance(obj, float) and not math.isfinite(obj):
        return "NaN" if math.isnan(obj) else ("Infinity" if obj > 0 else "-Infinity")
    if isinstance(obj, dict):
        return {k: _finite_json(v) for k, v in obj.items()}
    if isinstance(obj, list):
        return [_finite_json(v) for v in obj]
    return obj


class Telemetry:
    """``enabled``: record anything at all. ``out_dir``: where the files go
    (else a Tracker's run directory, else the Runtime's default).
    ``watchdog_secs``: arm a :class:`~rocket_tpu_torch.obs.watchdog.
    Watchdog` with that deadline."""

    TELEMETRY_FILE = "telemetry.json"
    SPANS_FILE = "spans.trace.json"
    _NULL = contextlib.nullcontext()

    def __init__(self, enabled: bool = False, out_dir: Optional[str] = None,
                 watchdog_secs: Optional[float] = None, max_span_events: int = 200_000,
                 logger=None) -> None:
        self.enabled = bool(enabled)
        self.out_dir = out_dir
        self._suggested: Optional[str] = None
        self._logger = logger
        self.spans = SpanRecorder(max_events=max_span_events)
        self.goodput = Goodput()
        self.registry = MetricsRegistry()
        self.identity = host_identity()
        #: Set by the Runtime when health is on: the flight recorder and the
        #: health monitor (None otherwise; every use checks).
        self.flight = None
        self.health = None
        #: Set by a ServeEngine: its per-request timeline tracer
        #: (``obs/reqtrace.RequestTracer``), which the exporter flushes each
        #: window (finished timelines and tail exemplars into the shard
        #: dir). None outside serving; every use checks.
        self.reqtrace = None
        #: The live export plane (``obs/export.TelemetryExporter``), attached
        #: by :meth:`start_export`; None keeps the run post-hoc only.
        self.exporter = None
        #: Set by the Runtime under a supervisor (``EXIT_WEDGED``): the
        #: watchdog's escalation then exits with this code after the black
        #: box is written. None keeps escalation diagnostic only.
        self.escalation_exit_code: Optional[int] = None
        self.watchdog: Optional[Watchdog] = None
        if self.enabled and watchdog_secs is not None:
            self.watchdog = Watchdog(watchdog_secs, on_stall=self._on_stall,
                                     on_escalate=self._on_escalation, spans=self.spans,
                                     registry=self.registry, logger=logger)
        self._t0 = time.perf_counter()
        self._stalls: list = []
        self._closed = False

    # -- lifecycle ---------------------------------------------------------------

    def start(self) -> None:
        """Start the run's clock and the watchdog thread (when on)."""
        if not self.enabled:
            return
        self._t0 = self.spans.t0 = time.perf_counter()
        if self.watchdog is not None:
            self.watchdog.identity = self.identity
            self.watchdog.start()

    def start_export(self, config, default_dir: Optional[str] = None) -> None:
        """Attach and start the live export plane (shards, ``/metrics``, SLO
        burn rates) as ``config`` (an ``obs/export.ExportConfig``) asks. A
        no-op when the config is inactive or telemetry is off; once only."""
        if not self.enabled or self.exporter is not None or not getattr(config, "active", False):
            return
        from rocket_tpu_torch.obs.export import TelemetryExporter

        self.exporter = TelemetryExporter(self, config, identity=self.identity,
                                          default_dir=default_dir, logger=self._logger)
        self.exporter.start()

    # -- spans -------------------------------------------------------------------

    def span(self, name: str, cat: Optional[str] = None):
        """A context recording one host span, charged to goodput phase
        ``cat`` when it names one; a shared no-op when off."""
        return _Span(self, name, cat) if self.enabled else self._NULL

    def step_span(self, tag: str, step_num: int, cat: str = "step"):
        """One Looper wave: a host span plus a ``torch.profiler.
        record_function`` range named ``<tag>#<step>`` (what the reference's
        ``StepTraceAnnotation`` is to a jax trace), so a profiled window
        shows the same step boundaries."""
        if not self.enabled:
            return self._NULL
        import torch

        stack = contextlib.ExitStack()
        stack.enter_context(self.span(f"{tag}/step", cat=cat))
        stack.enter_context(torch.profiler.record_function(f"{tag}#{step_num}"))
        return stack

    # -- heartbeat ---------------------------------------------------------------

    def watchdog_arm(self) -> None:
        if self.watchdog is not None:
            self.watchdog.arm()

    def watchdog_disarm(self) -> None:
        if self.watchdog is not None:
            self.watchdog.disarm()

    def beat(self) -> None:
        if self.watchdog is not None:
            self.watchdog.beat()

    def _on_stall(self, report: str) -> None:
        self._stalls = (self._stalls + [report])[-5:]

    def _on_escalation(self, report: str) -> None:
        """Several deadline windows in a row without a wave: the run is
        wedged, not slow, so the black box is written now (it survives a
        later kill). Under a supervisor the process then exits with
        ``escalation_exit_code``: the wedged main thread cannot be unwound
        from the watchdog's thread, so ``os._exit`` skips every ``finally``
        on purpose and the supervisor restarts the worker."""
        if self.flight is not None:
            self.flight.dump("watchdog_stall", extra={"report": report})
        if self.escalation_exit_code is not None:
            if self._logger is not None:
                self._logger.error("watchdog escalation under supervision: exiting with code %d "
                                   "so the supervisor restarts this worker",
                                   self.escalation_exit_code)
            os._exit(self.escalation_exit_code)

    def exception_dump(self, exc: BaseException, **context) -> None:
        """A bundle for an exception escaping a Looper. A
        ``HealthAnomalyError`` has already dumped in the anomaly policy."""
        if self.flight is None:
            return
        from rocket_tpu_torch.obs.health import HealthAnomalyError

        if isinstance(exc, HealthAnomalyError):
            return
        import traceback

        self.flight.dump(f"exception_{type(exc).__name__}",
                         extra={"exception": repr(exc),
                                "traceback": traceback.format_exc(limit=40), **context})

    # -- snapshots ---------------------------------------------------------------

    def suggest_out_dir(self, path: str) -> None:
        """A Tracker's run directory as the default; ``out_dir`` wins and the
        first suggestion stays."""
        if self._suggested is None:
            self._suggested = path

    def _publish_goodput(self) -> dict:
        report = self.goodput.report(time.perf_counter() - self._t0)
        for cat, share in report["fractions"].items():
            self.registry.gauge(f"goodput/{cat}_fraction").set(share)
        self.registry.gauge("obs/spans_dropped").set(self.spans.dropped)
        return report

    def scalars_snapshot(self) -> dict:
        """The registry, flat, for tracker backends (``obs/*``), with the
        allocator watermarks and goodput fractions refreshed."""
        if not self.enabled:
            return {}
        self.registry.record_device_memory()
        self._publish_goodput()
        return self.registry.scalars()

    def live_snapshot(self) -> dict:
        """The registry's snapshot with the goodput fractions (and the
        headline ``goodput/goodput_fraction``) published first: what
        ``/metrics`` and the shards serve. No allocator query: a scrape
        stays host arithmetic."""
        if self.enabled:
            report = self._publish_goodput()
            self.registry.gauge("goodput/goodput_fraction").set(report["goodput_fraction"])
        return self.registry.snapshot()

    def summary(self) -> dict:
        """What ``telemetry.json`` holds."""
        self.registry.record_device_memory()
        self.registry.gauge("obs/spans_dropped").set(self.spans.dropped)
        watchdog = self.watchdog
        out = {"version": 1,
               "goodput": self.goodput.report(time.perf_counter() - self._t0),
               "metrics": self.registry.snapshot(),
               "spans": {"file": self.SPANS_FILE, "events": len(self.spans),
                         "dropped": self.spans.dropped},
               "watchdog": {"enabled": watchdog is not None,
                            "deadline_s": watchdog.deadline_s if watchdog else None,
                            "stalls": watchdog.stall_count if watchdog else 0}}
        if self.health is not None and self.health.enabled:
            out["health"] = self.health.summary()
        if self.flight is not None:
            out["blackbox"] = {"bundles": list(self.flight.dumped)}
        return out

    # -- files -------------------------------------------------------------------

    def resolve_out_dir(self, default_dir: Optional[str] = None) -> str:
        return (self.out_dir or self._suggested or default_dir
                or os.path.join("runs", "telemetry"))

    def flush(self, default_dir: Optional[str] = None) -> Optional[str]:
        """Write ``telemetry.json`` and the span trace (and the stall
        reports, if any); returns the directory, None when off."""
        if not self.enabled:
            return None
        out_dir = self.resolve_out_dir(default_dir)
        os.makedirs(out_dir, exist_ok=True)
        self.spans.write(os.path.join(out_dir, self.SPANS_FILE))
        payload = self.summary()
        if self._stalls:
            with open(os.path.join(out_dir, "watchdog_stalls.txt"), "w", encoding="utf-8") as f:
                f.write("\n\n".join(self._stalls) + "\n")
            payload["watchdog"]["report_file"] = "watchdog_stalls.txt"
        path = os.path.join(out_dir, self.TELEMETRY_FILE)
        with open(path + ".tmp", "w", encoding="utf-8") as f:
            json.dump(_finite_json(payload), f, indent=1, sort_keys=True, allow_nan=False)
            f.write("\n")
        os.replace(path + ".tmp", path)
        if self._logger is not None:
            self._logger.info("telemetry: wrote %s", path)
        return out_dir

    def close(self, default_dir: Optional[str] = None, write: bool = True) -> None:
        """The last flush and the watchdog's stop (once; ``write=False``
        stops the thread and writes nothing)."""
        if self._closed:
            return
        self._closed = True
        if self.exporter is not None:
            # The last shard record and the endpoint's teardown come first:
            # the last snapshot a reader sees is the one telemetry.json keeps.
            self.exporter.stop()
        if self.enabled and self.spans.dropped and self._logger is not None:
            self._logger.warning("telemetry: %d span(s) dropped (max_span_events=%d) — the "
                                 "trace file is incomplete", self.spans.dropped,
                                 self.spans.max_events)
        if self.enabled and write:
            self.flush(default_dir)
        if self.watchdog is not None:
            self.watchdog.stop()
