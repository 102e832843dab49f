"""The live export plane: streaming metric shards and a Prometheus
endpoint (counterpart of ``rocket_tpu/obs/export.py``).

Everything else in ``obs`` is written at the end of a run
(``telemetry.json``); this is the live view over the same registry:

* :class:`ShardWriter`: each process appends periodic registry snapshots
  and the goodput report as crash-readable JSONL to ``<run dir>/telemetry/
  rank<k>.jsonl``, one complete object a line (a crash tears at most the
  last line, which every reader skips); past ``retention_lines`` the file
  is compacted to its newest half through a temp file and ``os.replace``.
* :func:`render_prometheus`: a registry snapshot in Prometheus text
  format 0.0.4, the power-of-two histograms as cumulative ``le`` buckets
  closed by ``+Inf``, with ``_sum`` and ``_count``.
* :class:`PrometheusServer`: a standard-library ``http.server`` thread
  serving ``/metrics`` from a snapshot callback (``Runtime(metrics_port=
  ...)``, ``ROCKET_TPU_METRICS_PORT``, ``launch --metrics-port``).
* :class:`TelemetryExporter`: the daemon thread tying it together,
  snapshot -> shard -> SLO evaluation (``obs/slo.py``) -> endpoint, every
  ``ExportConfig.interval_s``.
* the shard readers and the cross-rank merge (:func:`read_telemetry_dir`,
  :func:`merge_rank_records`) behind ``python -m rocket_tpu_torch.obs
  top|watch`` and ``report``'s fallback.

Standard library only: the supervisor mounts the same endpoint without
touching a device, and nothing here adds a device sync to the step, since
every input is a host dict the registry already keeps. The names on the
wire (the ``rocket_tpu_`` metric prefix, the shard record's keys) are the
reference's, so shards and scrapes of either package read with either.
"""

from __future__ import annotations

import dataclasses
import http.server
import json
import math
import os
import socket
import threading
import time
from typing import Callable, Optional

__all__ = ["ExportConfig", "PrometheusServer", "ShardWriter", "TelemetryExporter", "host_identity",
           "merge_rank_records", "prometheus_name", "read_shard_file", "read_telemetry_dir",
           "render_prometheus", "SHARD_DIR"]

#: Subdirectory of the run dir holding the per-rank shard files.
SHARD_DIR = "telemetry"

#: Shard record schema version.
SHARD_VERSION = 1


def host_identity(process_index: Optional[int] = None) -> dict:
    """``{"rank", "hostname", "pid"}`` of this process, for shard records,
    stall reports and black-box manifests. The rank is ``process_index``
    when the caller knows it, else the launcher's ``RANK``
    (torch.distributed's variable; the reference reads ``JAX_PROCESS_ID``),
    else 0."""
    if process_index is None:
        raw = os.environ.get("RANK", "").strip()
        process_index = int(raw) if raw.isdigit() else 0
    try:
        hostname = socket.gethostname()
    except OSError:
        hostname = "unknown"
    return {"rank": int(process_index), "hostname": hostname, "pid": os.getpid()}


# -- Prometheus text exposition ----------------------------------------------


def prometheus_name(name: str) -> str:
    """Registry name -> Prometheus metric name (``serve/ttft_s`` ->
    ``rocket_tpu_serve_ttft_s``; the reference's prefix, so one scrape
    configuration reads either package)."""
    safe = "".join(c if c.isalnum() or c == "_" else "_" for c in name)
    return f"rocket_tpu_{safe}".strip("_")


def _label_str(labels: Optional[dict], extra: Optional[dict] = None) -> str:
    merged = dict(labels or {})
    if extra:
        merged.update(extra)
    if not merged:
        return ""
    inner = ",".join(
        f'{k}="{str(v)}"' for k, v in sorted(merged.items())
    )
    return "{" + inner + "}"


def _fmt_value(value) -> str:
    value = float(value)
    if math.isnan(value):
        return "NaN"
    if math.isinf(value):
        return "+Inf" if value > 0 else "-Inf"
    return f"{value:g}"


def render_prometheus(snapshot: dict, labels: Optional[dict] = None) -> str:
    """A :meth:`MetricsRegistry.snapshot` record in Prometheus text
    exposition format (version 0.0.4).

    The registry's pow2 histograms store *per-bucket* counts keyed
    ``le_<upper>``; Prometheus buckets are *cumulative*, so each edge's
    sample is the sum of every bucket at or below it, closed by the
    mandatory ``+Inf`` bucket equal to ``_count``."""
    lines: list[str] = []
    for name in sorted(snapshot.get("counters", {})):
        metric = prometheus_name(name)
        lines.append(f"# TYPE {metric} counter")
        lines.append(
            f"{metric}{_label_str(labels)} "
            f"{_fmt_value(snapshot['counters'][name])}"
        )
    for name in sorted(snapshot.get("gauges", {})):
        value = snapshot["gauges"][name]
        if not isinstance(value, (int, float)):
            # telemetry._json_safe stores non-finite floats as strings.
            value = float(value.replace("Infinity", "inf")) \
                if isinstance(value, str) and "Infinity" in value else \
                (float("nan") if value == "NaN" else None)
            if value is None:
                continue
        metric = prometheus_name(name)
        lines.append(f"# TYPE {metric} gauge")
        lines.append(f"{metric}{_label_str(labels)} {_fmt_value(value)}")
    for name in sorted(snapshot.get("histograms", {})):
        hist = snapshot["histograms"][name] or {}
        metric = prometheus_name(name)
        lines.append(f"# TYPE {metric} histogram")
        edges = sorted(
            (float(key[3:]), int(count))
            for key, count in (hist.get("buckets") or {}).items()
            if key.startswith("le_")
        )
        cumulative = 0
        for upper, count in edges:
            cumulative += count
            lines.append(
                f"{metric}_bucket{_label_str(labels, {'le': f'{upper:g}'})} "
                f"{cumulative}"
            )
        total_count = int(hist.get("count") or 0)
        lines.append(
            f"{metric}_bucket{_label_str(labels, {'le': '+Inf'})} "
            f"{total_count}"
        )
        lines.append(
            f"{metric}_sum{_label_str(labels)} "
            f"{_fmt_value(hist.get('total') or 0.0)}"
        )
        lines.append(f"{metric}_count{_label_str(labels)} {total_count}")
    return "\n".join(lines) + "\n"


# -- streaming shards --------------------------------------------------------


class ShardWriter:
    """Bounded, crash-readable JSONL appender for one rank's shard.

    Appends are one ``write()`` of a complete line on an append-mode
    handle opened per call — a crash truncates at most the final line.
    Past ``retention_lines`` lines the shard is compacted: the newest
    half is rewritten to a temp file and ``os.replace``d over the shard,
    so concurrent readers see the old file or the new one, never a torn
    middle, and a week-long run's shard stays bounded on disk."""

    def __init__(self, path: str, retention_lines: int = 512) -> None:
        self.path = path
        self.retention_lines = max(2, int(retention_lines))
        self._lines_written = 0
        self._counted = False
        self._needs_newline = False

    def _count_existing(self) -> None:
        """Resume the line count over a pre-existing shard (a restarted
        worker appends to its generation's file rather than clobbering
        the crash evidence). A torn final line — the previous writer
        crashed mid-append — gets a newline terminator first, so the
        new record starts on its own line instead of fusing with the
        garbage tail."""
        self._counted = True
        try:
            with open(self.path, "rb") as f:
                data = f.read()
            self._lines_written = data.count(b"\n")
            self._needs_newline = bool(data) and not data.endswith(b"\n")
        except OSError:
            self._lines_written = 0
            self._needs_newline = False

    def append(self, record: dict) -> None:
        if not self._counted:
            self._count_existing()
        line = json.dumps(record, sort_keys=True, default=repr,
                          allow_nan=True)
        os.makedirs(os.path.dirname(self.path) or ".", exist_ok=True)
        with open(self.path, "a", encoding="utf-8") as f:
            f.write(("\n" if self._needs_newline else "") + line + "\n")
        self._needs_newline = False
        self._lines_written += 1
        if self._lines_written > self.retention_lines:
            self._compact()

    def _compact(self) -> None:
        keep = self.retention_lines // 2
        try:
            with open(self.path, "r", encoding="utf-8") as f:
                tail = f.readlines()[-keep:]
        except OSError:
            return
        tmp = self.path + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            f.writelines(tail)
        os.replace(tmp, self.path)
        self._lines_written = len(tail)


def read_shard_file(path: str) -> list[dict]:
    """Every parseable record of one shard, oldest first. Undecodable
    lines (the torn final line of a crashed writer, a mid-compaction
    read) are skipped — crash-readability is the shard's contract."""
    records: list[dict] = []
    try:
        with open(path, "r", encoding="utf-8") as f:
            for line in f:
                line = line.strip()
                if not line:
                    continue
                try:
                    record = json.loads(line)
                except json.JSONDecodeError:
                    continue
                if isinstance(record, dict):
                    records.append(record)
    except OSError:
        return []
    return records


def find_shard_dir(path: str) -> Optional[str]:
    """Resolve a run dir / telemetry dir / shard file to the directory
    holding ``rank*.jsonl`` shards; None when there are none."""
    if os.path.isfile(path):
        path = os.path.dirname(path) or "."
    for candidate in (path, os.path.join(path, SHARD_DIR)):
        if not os.path.isdir(candidate):
            continue
        try:
            names = os.listdir(candidate)
        except OSError:
            continue
        if any(n.startswith("rank") and n.endswith(".jsonl") for n in names):
            return candidate
    return None


def read_telemetry_dir(path: str) -> dict[int, list[dict]]:
    """All ranks' shard records under a run/telemetry dir:
    ``{rank: [records oldest-first]}`` (empty when no shards)."""
    shard_dir = find_shard_dir(path)
    if shard_dir is None:
        return {}
    out: dict[int, list[dict]] = {}
    for name in sorted(os.listdir(shard_dir)):
        if not (name.startswith("rank") and name.endswith(".jsonl")):
            continue
        stem = name[len("rank"):-len(".jsonl")]
        if not stem.isdigit():
            continue
        records = read_shard_file(os.path.join(shard_dir, name))
        if records:
            out[int(stem)] = records
    return out


def merge_rank_records(latest: dict[int, dict]) -> dict:
    """Fleet view over each rank's newest shard record.

    Counters and histogram buckets are summed across ranks (a counter is
    a per-process total; the fleet total is their sum). Gauges get the
    per-metric spread statistics the slow-rank hunt needs: sum, mean,
    min, max, the arg-max/arg-min ranks, and ``skew`` = (max - min) /
    |mean| (0 for a uniform fleet; the relative spread otherwise).
    Histograms additionally merge min/max/count/total so
    :func:`~rocket_tpu_torch.obs.registry.estimate_quantiles` works on the
    merged record."""
    counters: dict[str, float] = {}
    gauges: dict[str, dict] = {}
    histograms: dict[str, dict] = {}
    for rank in sorted(latest):
        metrics = latest[rank].get("metrics") or {}
        for name, value in (metrics.get("counters") or {}).items():
            if isinstance(value, (int, float)):
                counters[name] = counters.get(name, 0.0) + float(value)
        for name, value in (metrics.get("gauges") or {}).items():
            if not isinstance(value, (int, float)):
                continue
            stat = gauges.setdefault(
                name, {"sum": 0.0, "n": 0, "min": None, "max": None,
                       "min_rank": None, "max_rank": None},
            )
            value = float(value)
            stat["sum"] += value
            stat["n"] += 1
            if stat["min"] is None or value < stat["min"]:
                stat["min"], stat["min_rank"] = value, rank
            if stat["max"] is None or value > stat["max"]:
                stat["max"], stat["max_rank"] = value, rank
        for name, hist in (metrics.get("histograms") or {}).items():
            if not isinstance(hist, dict):
                continue
            merged = histograms.setdefault(
                name, {"count": 0, "total": 0.0, "min": None, "max": None,
                       "buckets": {}},
            )
            merged["count"] += int(hist.get("count") or 0)
            merged["total"] += float(hist.get("total") or 0.0)
            for bound in ("min", "max"):
                value = hist.get(bound)
                if isinstance(value, (int, float)):
                    best = merged[bound]
                    pick = min if bound == "min" else max
                    merged[bound] = value if best is None else pick(best, value)
            for key, count in (hist.get("buckets") or {}).items():
                merged["buckets"][key] = (
                    merged["buckets"].get(key, 0) + int(count)
                )
    for stat in gauges.values():
        mean = stat["sum"] / stat["n"] if stat["n"] else 0.0
        stat["mean"] = mean
        spread = (stat["max"] - stat["min"]) if stat["n"] else 0.0
        stat["skew"] = spread / abs(mean) if mean else 0.0
    for hist in histograms.values():
        hist["mean"] = (
            hist["total"] / hist["count"] if hist["count"] else None
        )
    return {
        "ranks": sorted(latest),
        "counters": counters,
        "gauges": gauges,
        "histograms": histograms,
    }


# -- the /metrics endpoint ---------------------------------------------------


class _MetricsHandler(http.server.BaseHTTPRequestHandler):
    server_version = "rocket-tpu-metrics"

    def do_GET(self):  # noqa: N802 - http.server API
        if self.path.split("?", 1)[0] not in ("/metrics", "/"):
            self.send_error(404)
            return
        try:
            body = self.server.render().encode("utf-8")  # type: ignore[attr-defined]
        except Exception:  # noqa: BLE001 - a scrape must not kill the server
            self.send_error(500)
            return
        try:
            self.send_response(200)
            self.send_header(
                "Content-Type", "text/plain; version=0.0.4; charset=utf-8"
            )
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)
        except (BrokenPipeError, ConnectionResetError):
            pass  # the scraper gave up (its timeout): not the server's fault

    def log_message(self, *args):  # scrapes are not log lines
        pass


class PrometheusServer:
    """A ``/metrics`` endpoint over a snapshot callback.

    ``snapshot_fn`` returns a :meth:`MetricsRegistry.snapshot`-shaped
    dict on every scrape — the live registry, not a cached copy, so the
    scrape always sees current values. ``port=0`` binds an ephemeral
    port (read it back from :attr:`port` — how the tests and the CI
    smoke avoid collisions)."""

    def __init__(
        self,
        snapshot_fn: Callable[[], dict],
        port: int,
        host: Optional[str] = None,
        labels: Optional[dict] = None,
    ) -> None:
        self._snapshot_fn = snapshot_fn
        self.labels = dict(labels or {})
        host = host if host is not None else os.environ.get(
            "ROCKET_TPU_METRICS_HOST", "127.0.0.1"
        )
        self._httpd = http.server.ThreadingHTTPServer(
            (host, int(port)), _MetricsHandler
        )
        self._httpd.daemon_threads = True
        self._httpd.render = self._render  # type: ignore[attr-defined]
        self.host = host
        self.port = self._httpd.server_address[1]
        self._thread: Optional[threading.Thread] = None

    def _render(self) -> str:
        return render_prometheus(self._snapshot_fn(), labels=self.labels)

    def start(self) -> None:
        if self._thread is not None:
            return
        self._thread = threading.Thread(
            target=self._httpd.serve_forever,
            kwargs={"poll_interval": 0.2},
            name="rocket-tpu-metrics", daemon=True,
        )
        self._thread.start()

    def stop(self) -> None:
        thread, self._thread = self._thread, None
        self._httpd.shutdown()
        self._httpd.server_close()
        if thread is not None and thread.is_alive():
            thread.join(timeout=2.0)


# -- configuration -----------------------------------------------------------


@dataclasses.dataclass
class ExportConfig:
    """Knobs of the live-export plane (Runtime args / CLI flags / env)."""

    #: Stream shard records at all.
    enabled: bool = False
    #: Seconds between exporter ticks (shard append + SLO evaluation).
    interval_s: float = 10.0
    #: Shard line bound before compaction (temp + rename to newest half).
    retention_lines: int = 512
    #: Mount ``/metrics`` on this port (0 = ephemeral; None = no server).
    metrics_port: Optional[int] = None
    #: SLO spec file (:mod:`rocket_tpu_torch.obs.slo` grammar), or the
    #: committed ``default:train`` spec.
    slo_path: Optional[str] = None

    @property
    def active(self) -> bool:
        return self.enabled or self.metrics_port is not None

    @classmethod
    def from_env(
        cls,
        enabled: Optional[bool] = None,
        interval_s: Optional[float] = None,
        retention_lines: Optional[int] = None,
        metrics_port: Optional[int] = None,
        slo_path: Optional[str] = None,
    ) -> "ExportConfig":
        """Explicit arguments win; unset ones read the environment.
        ``ROCKET_TPU_EXPORT`` accepts a truthy flag (``1``) or a number,
        which both enables export and sets the interval in seconds
        (``ROCKET_TPU_EXPORT=2.5``). ``ROCKET_TPU_METRICS_PORT`` mounts
        the endpoint without code changes."""
        raw = os.environ.get("ROCKET_TPU_EXPORT", "").strip().lower()
        if enabled is None:
            enabled = raw in ("1", "true", "yes", "on")
            if not enabled and raw:
                try:
                    env_interval = float(raw)
                except ValueError:
                    env_interval = None
                if env_interval is not None and env_interval > 0:
                    enabled = True
                    if interval_s is None:
                        interval_s = env_interval
        if metrics_port is None:
            port_raw = os.environ.get("ROCKET_TPU_METRICS_PORT", "").strip()
            if port_raw:
                try:
                    metrics_port = int(port_raw)
                except ValueError:
                    metrics_port = None
        if slo_path is None:
            slo_path = os.environ.get("ROCKET_TPU_SLO", "").strip() or None
        config = cls(enabled=bool(enabled))
        if interval_s is not None:
            config.interval_s = float(interval_s)
        if retention_lines is not None:
            config.retention_lines = int(retention_lines)
        config.metrics_port = metrics_port
        config.slo_path = slo_path
        return config


# -- the exporter thread -----------------------------------------------------


class TelemetryExporter:
    """Periodic snapshot -> shard -> SLO -> endpoint loop for one
    Telemetry.

    Owned by :class:`~rocket_tpu_torch.obs.telemetry.Telemetry`
    (``start_export``/``close``). Every tick is host dict arithmetic over
    the registry the instrumented code already feeds: the exporter adds no
    work and no device sync to the step path (strict mode stays quiet with
    export on)."""

    def __init__(
        self,
        telemetry,
        config: ExportConfig,
        identity: Optional[dict] = None,
        default_dir: Optional[str] = None,
        logger=None,
    ) -> None:
        self.telemetry = telemetry
        self.config = config
        self.identity = identity or host_identity()
        self._default_dir = default_dir
        self._logger = logger
        self._writer: Optional[ShardWriter] = None
        self._seq = 0
        self._t0 = time.perf_counter()
        self._stop = threading.Event()
        self._thread: Optional[threading.Thread] = None
        self.server: Optional[PrometheusServer] = None
        self.slos = None
        if config.slo_path:
            from rocket_tpu_torch.obs.slo import SLOEvaluator, load_slo_specs

            try:
                self.slos = SLOEvaluator(load_slo_specs(config.slo_path))
            except (OSError, ValueError) as exc:
                self._log_error(
                    f"export: cannot load SLO specs from "
                    f"{config.slo_path!r}: {exc}"
                )

    def _log_error(self, message: str) -> None:
        if self._logger is not None:
            self._logger.error("%s", message)

    # -- lifecycle ---------------------------------------------------------

    def start(self) -> None:
        if self.config.metrics_port is not None and self.server is None:
            try:
                # Per-rank port offset: N single-host processes each get
                # a distinct scrape target (port 0 stays ephemeral).
                port = self.config.metrics_port
                if port:
                    port += int(self.identity.get("rank", 0))
                # live_snapshot (when the telemetry provides it):
                # goodput fractions re-published per scrape, not just at
                # tracker-flush cadence.
                snapshot_fn = getattr(
                    self.telemetry, "live_snapshot", None
                ) or self.telemetry.registry.snapshot
                self.server = PrometheusServer(
                    snapshot_fn, port,
                    labels={"rank": self.identity.get("rank", 0)},
                )
                self.server.start()
            except OSError as exc:
                self.server = None
                self._log_error(
                    f"export: /metrics endpoint failed to bind port "
                    f"{self.config.metrics_port}: {exc}"
                )
        if self.config.enabled and self._thread is None:
            self._thread = threading.Thread(
                target=self._run, name="rocket-tpu-export", daemon=True
            )
            self._thread.start()

    def stop(self) -> None:
        """Final shard record + teardown (idempotent)."""
        self._stop.set()
        thread, self._thread = self._thread, None
        if thread is not None and thread.is_alive():
            thread.join(timeout=max(2.0, self.config.interval_s))
        if self.config.enabled:
            try:
                self.tick(final=True)
            except Exception as exc:  # noqa: BLE001 - teardown must finish
                self._log_error(f"export: final shard append failed: {exc!r}")
        if self.server is not None:
            self.server.stop()
            self.server = None

    def _run(self) -> None:
        while not self._stop.wait(self.config.interval_s):
            try:
                self.tick()
            except Exception as exc:  # noqa: BLE001 - keep exporting
                self._log_error(f"export: tick failed: {exc!r}")

    # -- one tick ----------------------------------------------------------

    def shard_path(self) -> str:
        out_dir = self.telemetry.resolve_out_dir(self._default_dir)
        return os.path.join(
            out_dir, SHARD_DIR, f"rank{self.identity.get('rank', 0)}.jsonl"
        )

    def tick(self, final: bool = False) -> dict:
        """Build + append one shard record; evaluate SLOs. Returns the
        record (tests drive this synchronously)."""
        tel = self.telemetry
        live = getattr(tel, "live_snapshot", None)
        snapshot = live() if live is not None else tel.registry.snapshot()
        goodput = tel.goodput.report(time.perf_counter() - tel._t0)
        record = {
            "version": SHARD_VERSION,
            "t_unix": time.time(),
            "uptime_s": round(time.perf_counter() - self._t0, 3),
            "seq": self._seq,
            "final": bool(final),
            **self.identity,
            "goodput": goodput,
            "metrics": snapshot,
        }
        self._seq += 1
        tracer = getattr(tel, "reqtrace", None)
        if tracer is not None:
            # Close the request-timeline window first: finished
            # waterfalls and slowest-k exemplars land in the shard dir,
            # and an SLO violation this tick names the window's exemplar
            # request ids in its anomaly.
            record["reqtrace"] = tracer.flush(tel.resolve_out_dir(self._default_dir))
        if self.slos is not None:
            self._evaluate_slos(record)
            # Re-snapshot so the shard carries its own obs/slo/* gauges.
            record["metrics"] = tel.registry.snapshot()
        path = self.shard_path()
        if self._writer is None or self._writer.path != path:
            if (
                self._writer is not None
                and os.path.exists(self._writer.path)
                and not os.path.exists(path)
            ):
                # The out dir resolved late (a Tracker suggested
                # runs/<project> after the first ticks): carry the early
                # records along instead of leaving a split history.
                os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
                os.replace(self._writer.path, path)
            self._writer = ShardWriter(
                path, retention_lines=self.config.retention_lines
            )
        self._writer.append(record)
        return record

    def _evaluate_slos(self, record: dict) -> None:
        registry = self.telemetry.registry
        statuses = self.slos.observe(
            record["t_unix"], record["metrics"], record["goodput"]
        )
        tracer = getattr(self.telemetry, "reqtrace", None)
        if tracer is not None:
            # A violated serve SLO carries the offending window's exemplar
            # request ids (`obs timeline <run> --request <id>`).
            for status in statuses:
                if status.violated:
                    status.exemplars = dict(tracer.last_window)
        record["slo"] = [dataclasses.asdict(s) for s in statuses]
        for status in statuses:
            prefix = f"obs/slo/{status.name}"
            registry.gauge(f"{prefix}/burn_rate").set(status.burn_rate)
            registry.gauge(f"{prefix}/violated").set(
                1.0 if status.violated else 0.0
            )
            if status.newly_violated:
                registry.counter(f"{prefix}/violations").inc()
                self._log_error(
                    f"SLO violation: {status.name} burn_rate="
                    f"{status.burn_rate:.2f} value={status.value} "
                    f"objective={status.objective}"
                )
                flight = getattr(self.telemetry, "flight", None)
                if flight is not None:
                    anomaly = {
                        "kind": "slo_violation",
                        "slo": status.name,
                        "burn_rate": status.burn_rate,
                        "value": status.value,
                        "objective": status.objective,
                        "t_unix": record["t_unix"],
                    }
                    if status.exemplars is not None:
                        anomaly["exemplars"] = status.exemplars
                    flight.note_anomaly(anomaly)
