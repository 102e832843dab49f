"""The port's ops plane (counterpart of ``rocket_tpu.obs``): spans,
goodput, the metrics registry, the hang watchdog, the health sentinels
and the flight recorder, owned per run by one :class:`Telemetry`; the
serve engine's per-request timelines (``obs/reqtrace.py``); and device
traces, their capture and their parse (``obs/prof.py``).

``Runtime(telemetry=True)`` (or ``ROCKET_TPU_TELEMETRY=1``) turns it on;
at the end of the run ``telemetry.json`` and the Chrome trace
``spans.trace.json`` land in the run directory. ``Runtime(health=True)``
(or ``ROCKET_TPU_HEALTH``) adds the health word to the train step and arms
the flight recorder, whose bundles land under ``blackbox/``. Render either
with ``python -m rocket_tpu_torch.obs report|blackbox <path>``.

The live export plane (``export.py``: ``Runtime(export=True,
metrics_port=..., slo=...)`` or ``ROCKET_TPU_EXPORT``,
``ROCKET_TPU_METRICS_PORT``, ``ROCKET_TPU_SLO``) streams the registry to
``<run dir>/telemetry/rank<k>.jsonl`` and ``/metrics`` while the run goes
on, and evaluates the SLO specs of ``slo.py`` at every tick; ``python -m
rocket_tpu_torch.obs top|watch <run dir>`` reads the shards; ``python -m
rocket_tpu_torch.obs timeline <run dir>`` renders a serve run's request
waterfalls and ``python -m rocket_tpu_torch.obs prof <trace>`` a
``torch.profiler`` window's per-kernel device time.
"""

from rocket_tpu_torch.obs.export import (
    ExportConfig,
    PrometheusServer,
    ShardWriter,
    TelemetryExporter,
    host_identity,
    merge_rank_records,
    read_telemetry_dir,
    render_prometheus,
)
from rocket_tpu_torch.obs.flight import FlightRecorder
from rocket_tpu_torch.obs.goodput import CATEGORIES, Goodput, render_report
from rocket_tpu_torch.obs.health import HealthAnomalyError, HealthConfig, HealthMonitor
from rocket_tpu_torch.obs.registry import (
    Counter,
    Gauge,
    Histogram,
    MetricsRegistry,
    estimate_quantiles,
)
from rocket_tpu_torch.obs.slo import SLOEvaluator, SLOSpec, SLOStatus, load_slo_specs
from rocket_tpu_torch.obs.spans import SpanRecorder, load_chrome_trace
from rocket_tpu_torch.obs.telemetry import Telemetry
from rocket_tpu_torch.obs.watchdog import Watchdog

__all__ = [
    "CATEGORIES", "Counter", "ExportConfig", "FlightRecorder", "Gauge", "Goodput",
    "HealthAnomalyError", "HealthConfig", "HealthMonitor", "Histogram", "MetricsRegistry",
    "PrometheusServer", "SLOEvaluator", "SLOSpec", "SLOStatus", "ShardWriter", "SpanRecorder",
    "Telemetry", "TelemetryExporter", "Watchdog", "estimate_quantiles", "host_identity",
    "load_chrome_trace", "load_slo_specs", "merge_rank_records", "read_telemetry_dir",
    "render_prometheus", "render_report",
]
