"""``python -m rocket_tpu_torch.obs <report|blackbox> <path>`` (counterpart
of the ``report`` and ``blackbox`` subcommands of ``rocket_tpu/obs/
__main__.py``; the files of either package render with either CLI).

* ``report``: a ``telemetry.json`` (or the run directory holding it) as the
  goodput table, the health line, the registry's counters and gauges, each
  histogram's count, mean and estimated p50/p90/p99, the allocator
  watermarks, the watchdog and the span count; a Chrome-trace span file as
  its per-category span totals (inclusive). A record with no steps says so.
* ``blackbox``: a flight-recorder bundle (its directory or its
  ``blackbox.json``): reason, last good step, the anomaly timeline, the
  tail of the health history, and the emergency checkpoint.

Exit codes: 0 rendered, 2 a usage or parse error. The live views of the
reference (``top``, ``watch``, ``timeline``, ``prof``) wait for the export
plane (ROADMAP Queue A 7b).
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

from rocket_tpu_torch.obs.flight import BLACKBOX_FILE
from rocket_tpu_torch.obs.goodput import CATEGORIES, render_report
from rocket_tpu_torch.obs.registry import estimate_quantiles
from rocket_tpu_torch.obs.spans import load_chrome_trace


def _num(value, digits: int = 4) -> str:
    if isinstance(value, float):
        return str(value) if not math.isfinite(value) else f"{value:.{digits}g}"
    return str(value)


def _health_line(health: dict, full: bool = True) -> str:
    line = (f"health: action={health.get('action')} anomalies={health.get('anomalies', 0)} "
            f"skipped_steps={health.get('skipped_steps', 0)}")
    if full:
        line += (f" zscore_breaches={health.get('zscore_breaches', 0)} "
                 f"last_good_step={health.get('last_good_step')}")
    return line


def render_telemetry(doc: dict) -> str:
    """The ``report`` view of a ``telemetry.json`` record."""
    out = [render_report(doc.get("goodput", {}))]
    if doc.get("health"):
        out += ["", _health_line(doc["health"])]
    bundles = (doc.get("blackbox") or {}).get("bundles") or []
    if bundles:
        out.append("blackbox bundles:")
        out += [f"  {b}" for b in bundles]
    metrics = doc.get("metrics", {})
    scalars = {**metrics.get("counters", {}), **metrics.get("gauges", {})}
    if scalars:
        out += ["", "metrics:"]
        for name in sorted(scalars):
            value = scalars[name]  # non-finite values arrive as their names
            shown = f"{value:g}" if isinstance(value, (int, float)) else str(value)
            out.append(f"  {name:<36} {shown}")
    for name, hist in sorted(metrics.get("histograms", {}).items()):
        q = estimate_quantiles(hist)
        mean = hist.get("mean")
        out.append(f"  {name:<36} count={hist.get('count', 0)}"
                   + (f" mean={mean:.4g}s" if mean is not None else "")
                   + "".join(f" {k}={q[k]:.4g}s" for k in ("p50", "p90", "p99") if k in q))
    gauges = metrics.get("gauges", {})
    marks = [(n, gauges[n]) for n in ("hbm/bytes_in_use_max", "hbm/peak_bytes_in_use_max")
             if isinstance(gauges.get(n), (int, float))]
    if marks:
        out += ["", "hbm watermarks (max over local devices):"]
        out += [f"  {n:<36} {v / (1 << 30):.3f} GiB" for n, v in marks]
    watchdog = doc.get("watchdog", {})
    if watchdog.get("enabled"):
        out.append(f"watchdog: deadline {watchdog.get('deadline_s')}s, "
                   f"{watchdog.get('stalls', 0)} stall(s)")
    spans = doc.get("spans", {})
    if spans:
        out.append(f"spans: {spans.get('events', 0)} events ({spans.get('dropped', 0)} "
                   f"dropped) in {spans.get('file')}")
    return "\n".join(out)


def render_spans(events: list) -> str:
    """Span count and inclusive seconds per category of a span file."""
    seconds: dict = {}
    counts: dict = {}
    first = last = None
    for ev in (e for e in events if e.get("ph") == "X"):
        cat, ts, dur = ev.get("cat", "span"), float(ev.get("ts", 0.0)), float(ev.get("dur", 0.0))
        seconds[cat] = seconds.get(cat, 0.0) + dur / 1e6
        counts[cat] = counts.get(cat, 0) + 1
        first = ts if first is None else min(first, ts)
        last = ts + dur if last is None else max(last, ts + dur)
    width = 0.0 if first is None else (last - first) / 1e6
    out = [f"span file: {sum(counts.values())} complete spans over {width:.3f}s",
           f"{'category':<14} {'spans':>7} {'inclusive_s':>12}"]
    order = [c for c in CATEGORIES if c in seconds] + sorted(set(seconds) - set(CATEGORIES))
    out += [f"{c:<14} {counts[c]:>7} {seconds[c]:>12.3f}" for c in order]
    return "\n".join(out)


def render_blackbox(manifest: dict, bundle_dir: str) -> str:
    """The ``blackbox`` view of a bundle's manifest."""
    out = [f"black-box bundle: {bundle_dir or '(manifest only)'}",
           f"reason: {manifest.get('reason')}",
           f"last good step: {manifest.get('last_good_step')}",
           f"steps recorded: {manifest.get('steps_recorded', 0)} (ring of sentinel snapshots)"]
    proc = manifest.get("process")
    if proc:
        host = f" on {proc['hostname']}" if proc.get("hostname") else ""
        out.append(f"process: {proc.get('index')}/{proc.get('count')}{host} "
                   f"(pid {proc.get('pid')})")
    if manifest.get("health"):
        out.append(_health_line(manifest["health"], full=False))
    anomalies = manifest.get("anomalies") or []
    out.append("")
    if not anomalies:
        out.append("anomaly timeline: empty (dump was not anomaly-driven)")
    else:
        out.append(f"anomaly timeline ({len(anomalies)} record(s)):")
        out.append(f"  {'step':>8} {'flags':<28} {'loss':>12} {'grad_norm':>12} {'zscore':>8}")
        for rec in anomalies:
            where = [f"{kind}[{','.join(rec[key])}]" for kind, key in
                     (("grads", "bad_grad_branches"), ("params", "bad_param_branches"))
                     if rec.get(key)]
            out.append(f"  {rec.get('step', '?'):>8} "
                       f"{'+'.join(rec.get('flag_names', [])) or '-':<28} "
                       f"{_num(rec.get('loss')):>12} {_num(rec.get('grad_norm')):>12} "
                       f"{_num(rec.get('loss_zscore'), 3):>8}"
                       + ("  " + " ".join(where) if where else ""))
    history = manifest.get("sentinel_history") or []
    if history:
        tail = history[-10:]
        out += ["", f"sentinel history tail (last {len(tail)} of {len(history)}):",
                f"  {'step':>8} {'loss':>12} {'grad_norm':>12} {'upd_ratio':>10} flags"]
        out += [f"  {r.get('step', '?'):>8} {_num(r.get('loss')):>12} "
                f"{_num(r.get('grad_norm')):>12} {_num(r.get('update_ratio'), 3):>10} "
                f"{'+'.join(r.get('flag_names', [])) or '-'}" for r in tail]
    out.append("")
    if manifest.get("checkpoint"):
        path = os.path.join(bundle_dir, manifest["checkpoint"]) if bundle_dir else \
            manifest["checkpoint"]
        out.append(f"emergency checkpoint: {path}"
                   + ("" if os.path.isdir(path) else " (MISSING on disk)"))
    elif manifest.get("checkpoint_error"):
        out.append(f"emergency checkpoint FAILED: {manifest['checkpoint_error']}")
    else:
        out.append("emergency checkpoint: none (no Checkpointer in the tree)")
    if manifest.get("spans_tail"):
        out.append(f"span tail: {len(manifest['spans_tail'])} events (host timeline before "
                   "the dump)")
    extra = manifest.get("extra")
    if isinstance(extra, dict) and extra.get("report"):
        out += ["", "watchdog report:", str(extra["report"])]
    return "\n".join(out)


def _load(path: str):
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"error: cannot read {path}: {exc}", file=sys.stderr)
        return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m rocket_tpu_torch.obs",
                                     description="render telemetry records and black-box "
                                                 "bundles")
    sub = parser.add_subparsers(dest="command")
    sub.add_parser("report", help="render telemetry.json, its run dir or a span file") \
        .add_argument("path")
    sub.add_parser("blackbox", help="render a flight-recorder bundle") \
        .add_argument("path", help=f"bundle directory or its {BLACKBOX_FILE}")
    args = parser.parse_args(argv)
    if args.command not in ("report", "blackbox"):
        parser.print_help()
        return 2
    path = args.path
    if args.command == "blackbox":
        bundle_dir = path if os.path.isdir(path) else os.path.dirname(path)
        if os.path.isdir(path):
            path = os.path.join(path, BLACKBOX_FILE)
        manifest = _load(path)
        if not isinstance(manifest, dict) or "reason" not in manifest:
            if manifest is not None:
                print(f"error: {path} is not a black-box manifest", file=sys.stderr)
            return 2
        print(render_blackbox(manifest, bundle_dir))
        return 0
    if os.path.isdir(path):
        path = os.path.join(path, "telemetry.json")
    doc = _load(path)
    if doc is None:
        return 2
    if isinstance(doc, dict) and "goodput" in doc:
        print(render_telemetry(doc))
        return 0
    try:
        events = load_chrome_trace(path)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    print(render_spans(events))
    return 0


if __name__ == "__main__":
    sys.exit(main())
