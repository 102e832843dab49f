"""``python -m rocket_tpu_torch.obs <report|top|watch|timeline|blackbox|prof> <path>``
(counterpart of ``rocket_tpu/obs/__main__.py``; the files of either
package render with either CLI).

* ``report``: a ``telemetry.json`` (or the run directory holding it) as the
  goodput table, the health line, the registry's counters and gauges, each
  histogram's count, mean and estimated p50/p90/p99, the allocator
  watermarks, the measured step attribution of the last parsed trace
  window (the ``obs/prof/*`` gauges), the watchdog and the span count,
  with the run's
  ``supervisor.json`` beside it when there is one; a ``supervisor.json``
  alone as its generations; a Chrome-trace span file as its per-category
  span totals (inclusive). A run directory with no ``telemetry.json`` (a
  worker killed before its teardown) falls back to its streaming shards.
* ``top``: the cross-rank live view over a run's shards (``--once`` for one
  frame): each rank's liveness, counters summed, gauges' spread with the
  slowest rank, SLO burn rates, merged histogram percentiles.
* ``watch --slo SPEC``: the SLO specs replayed over the shards; exit 1 when
  any objective ends violated. Each process's records (one ``pid`` of a
  rank's shard, a supervised generation) replay through a fresh evaluator,
  as that process's live exporter evaluated them.
* ``timeline``: a serve run's request timelines (``reqtrace.jsonl`` and
  ``exemplars.jsonl``, ``obs/reqtrace.py``) as per-request waterfalls
  (``--request ID``, or the ``--slowest N``) and the aggregate phase
  breakdown; ``--format json`` for the records.
* ``blackbox``: a flight-recorder bundle (its directory or its
  ``blackbox.json``): reason, last good step, the anomaly timeline, the
  tail of the health history, and the emergency checkpoint.
* ``prof``: a captured ``torch.profiler`` trace (a file, or the directory
  a capture wrote into) as the measured per-kernel attribution table
  (``obs/prof.py``); ``--format json`` for the record. ``--target NAME``
  also reconciles the trace against that calibration target's priced step
  (``analysis/calib.py``: the join by launching op and ordinal, the error
  per category, join coverage, RKT702/703), as the reference's ``obs prof
  --target``; a CPU capture (the ``gpt2_sentinel`` target's) has no
  device slices and renders the join alone.

Exit codes: 0 rendered (``watch``: no violation), 1 a violation, 2 a usage
or parse error.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import sys

from rocket_tpu_torch.obs.export import merge_rank_records, read_telemetry_dir
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
    prof = render_prof_gauges(metrics)
    if prof:
        out += ["", prof]
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


def render_prof_gauges(metrics: dict) -> str:
    """The measured step attribution of the last parsed trace window (the
    ``obs/prof/*`` gauges the Profiler capsule publishes), or ``""`` when
    the run never traced."""
    gauges, counters = metrics.get("gauges", {}), metrics.get("counters", {})
    prof = {k: v for k, v in gauges.items() if k.startswith("obs/prof/")}
    if not prof:
        return ""
    step = prof.get("obs/prof/measured_step_us")
    out = ["measured step attribution (last trace window, obs.prof):",
           f"  windows parsed: {counters.get('obs/prof/windows_parsed', 0):g}  steps in "
           f"window: {prof.get('obs/prof/n_steps', 0):g}"]
    if step is not None:
        out.append(f"  per step: device span {step:g} us (busy "
                   f"{prof.get('obs/prof/device_busy_us', 0):g} us, wall "
                   f"{prof.get('obs/prof/wall_step_us', 0):g} us), exposed comm "
                   f"{prof.get('obs/prof/exposed_comm_us', 0):g} us")
    fracs = {k.rsplit("frac_", 1)[-1]: v for k, v in prof.items() if "/frac_" in k}
    if fracs:
        out.append("  device time: " + "  ".join(f"{cat}={value:.1%}"
                                                 for cat, value in sorted(fracs.items())))
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


def render_supervisor(doc: dict) -> str:
    """A ``supervisor.json`` (``launch --supervise``): the headline goodput
    under failures and one line per generation."""
    out = [f"supervisor: outcome={doc.get('outcome')} restarts={doc.get('restarts', 0)} "
           f"drain_events={doc.get('drain_events', 0)} "
           f"goodput_fraction={_num(doc.get('goodput_fraction'))} "
           f"(productive {_num(doc.get('productive_wall_s'))}s of "
           f"{_num(doc.get('total_wall_s'))}s)",
           f"  {'gen':>4} {'nproc':>5} {'outcome':<10} {'duration_s':>10} {'productive_s':>12} "
           f"{'rc':>5} {'ckpt_step':>9}"]
    for gen in doc.get("generations", []):
        out.append(f"  {gen.get('gen', '?'):>4} {gen.get('nproc', '?'):>5} "
                   f"{gen.get('outcome', '?'):<10} {_num(gen.get('duration_s')):>10} "
                   f"{_num(gen.get('productive_s')):>12} {str(gen.get('rc')):>5} "
                   f"{str(gen.get('ckpt_step')):>9}")
    return "\n".join(out)


def _latest_per_rank(path: str) -> dict:
    """Each rank's newest shard record under a run or telemetry dir."""
    return {rank: records[-1] for rank, records in read_telemetry_dir(path).items() if records}


def _slo_rows(latest: dict) -> list:
    """``(slo, rank, burn_rate, violated)`` from the ``obs/slo/<name>/*``
    gauges the live exporter writes into each shard record."""
    rows = []
    for rank in sorted(latest):
        gauges = (latest[rank].get("metrics") or {}).get("gauges") or {}
        for name, value in sorted(gauges.items()):
            if name.startswith("obs/slo/") and name.endswith("/burn_rate"):
                slo = name[len("obs/slo/"):-len("/burn_rate")]
                rows.append((slo, rank, value, bool(gauges.get(f"obs/slo/{slo}/violated", 0.0))))
    return sorted(rows, key=lambda r: (r[0], r[1]))


def render_top(latest: dict) -> str:
    """One frame of the cross-rank view over each rank's newest record."""
    import time

    merged = merge_rank_records(latest)
    now = time.time()
    out = [f"obs top — {len(latest)} rank(s)",
           f"  {'rank':>4} {'hostname':<20} {'pid':>7} {'seq':>6} {'uptime_s':>9} {'age_s':>6} "
           f"{'goodput':>8}"]
    for rank in sorted(latest):
        rec = latest[rank]
        goodput = (rec.get("goodput") or {}).get("goodput_fraction")
        out.append(f"  {rank:>4} {str(rec.get('hostname', '?'))[:20]:<20} {rec.get('pid', '?'):>7} "
                   f"{rec.get('seq', '?'):>6} {_num(rec.get('uptime_s')):>9} "
                   f"{now - rec.get('t_unix', now):>6.1f} {_num(goodput):>8}")
    if merged["counters"]:
        out += ["", "counters (summed across ranks):"]
        out += [f"  {n:<40} {merged['counters'][n]:g}" for n in sorted(merged["counters"])]
    if merged["gauges"]:
        out += ["", "gauges (spread across ranks):",
                f"  {'name':<40} {'mean':>10} {'min':>10} {'max':>10} {'skew':>6}  slowest"]
        for name in sorted(merged["gauges"]):
            stat = merged["gauges"][name]
            # The arg-max rank: for a duration or depth the biggest value is
            # the rank holding the fleet back.
            out.append(f"  {name:<40} {_num(stat['mean']):>10} {_num(stat['min']):>10} "
                       f"{_num(stat['max']):>10} {_num(stat['skew'], 3):>6}  "
                       f"rank {stat['max_rank']}")
    rows = _slo_rows(latest)
    if rows:
        out += ["", "slo (per rank, from obs/slo/* gauges):",
                f"  {'name':<32} {'rank':>4} {'burn_rate':>10}  status"]
        out += [f"  {name:<32} {rank:>4} {_num(burn):>10}  {'VIOLATED' if bad else 'ok'}"
                for name, rank, burn, bad in rows]
    if merged["histograms"]:
        out += ["", "histograms (merged):"]
        for name in sorted(merged["histograms"]):
            hist = merged["histograms"][name]
            q = estimate_quantiles(hist)
            mean = hist.get("mean")
            out.append(f"  {name:<40} count={hist.get('count', 0)}"
                       + (f" mean={mean:.4g}" if mean is not None else "")
                       + "".join(f" {k}={q[k]:.4g}" for k in ("p50", "p90", "p99") if k in q))
    return "\n".join(out)


def _top(args) -> int:
    latest = _latest_per_rank(args.path)
    if not latest:
        print(f"error: no telemetry shards (rank*.jsonl) under {args.path} — is the run "
              "exporting? (ROCKET_TPU_EXPORT=1 / Runtime(export=True))", file=sys.stderr)
        return 2
    if args.once:
        print(render_top(latest))
        return 0
    import time

    try:
        while True:
            sys.stdout.write("\x1b[2J\x1b[H" + render_top(_latest_per_rank(args.path)) + "\n")
            sys.stdout.flush()
            time.sleep(args.interval)
    except KeyboardInterrupt:
        return 0


def _processes(records: list) -> list:
    """A rank's shard split into its processes' runs of records (a
    supervised rank appends one run per generation to the same shard)."""
    runs: list = []
    for record in records:
        if not runs or record.get("pid") != runs[-1][-1].get("pid"):
            runs.append([])
        runs[-1].append(record)
    return runs


def _watch(args) -> int:
    from rocket_tpu_torch.obs.slo import SLOEvaluator, load_slo_specs

    try:
        specs = load_slo_specs(args.slo)
    except (OSError, ValueError, NotImplementedError) as exc:
        print(f"error: cannot load SLO specs from {args.slo!r}: {exc}", file=sys.stderr)
        return 2
    shards = read_telemetry_dir(args.path)
    if not shards:
        print(f"error: no telemetry shards (rank*.jsonl) under {args.path}", file=sys.stderr)
        return 2
    violated: dict = {}
    evaluated = 0
    for rank in sorted(shards):
        for records in _processes(shards[rank]):
            # One evaluator a process: its burn-rate windows and warmup are
            # that process's, as its live exporter computed them.
            evaluator = SLOEvaluator(specs)
            for record in records:
                evaluated += 1
                for status in evaluator.observe(record.get("t_unix", 0.0),
                                                record.get("metrics") or {},
                                                record.get("goodput") or {}):
                    if status.violated:
                        violated[f"{status.name}@rank{rank}"] = {
                            "rank": rank, "name": status.name, "burn_rate": status.burn_rate,
                            "value": status.value, "objective": status.objective}
    print(f"obs watch — {len(specs)} SLO(s) [{', '.join(s.name for s in specs)}] over "
          f"{len(shards)} rank shard(s), {evaluated} record(s)")
    if not violated:
        print("all SLOs within objective")
        return 0
    for key in sorted(violated):
        v = violated[key]
        print(f"VIOLATION {v['name']} (rank {v['rank']}): burn_rate={_num(v['burn_rate'])} "
              f"value={_num(v['value'])} objective={_num(v['objective'])}")
    return 1


def _report_from_shards(path: str) -> int:
    """``report`` of a run dir with no ``telemetry.json``: a worker killed
    before its teardown still left its streaming shards."""
    latest = _latest_per_rank(path)
    if not latest:
        print(f"error: no telemetry.json and no streaming shards under {path}", file=sys.stderr)
        return 2
    if len(latest) == 1:
        (rank, record), = latest.items()
        print(f"(reconstructed from streaming shards: rank {rank} seq {record.get('seq')}, no "
              "telemetry.json — worker died before DESTROY?)")
        print(render_telemetry({"goodput": record.get("goodput") or {},
                                "metrics": record.get("metrics") or {}}))
        return 0
    print("(reconstructed from streaming shards — no telemetry.json)")
    print(render_top(latest))
    return 0


def _timeline(args) -> int:
    """Waterfalls and the aggregate phase breakdown of a serve run's
    request timelines."""
    from rocket_tpu_torch.obs.reqtrace import (
        aggregate_phases,
        read_timeline_dir,
        render_aggregate,
        render_waterfall,
    )

    records = read_timeline_dir(args.path)
    if not records:
        print(f"error: no request timelines (reqtrace.jsonl / exemplars.jsonl) under "
              f"{args.path} — was the run served with reqtrace on and exporting?",
              file=sys.stderr)
        return 2
    if args.request is not None:
        selection = [r for r in records if r["rid"] == args.request]
        if not selection:
            known = ", ".join(str(r["rid"]) for r in records[:16])
            print(f"error: request {args.request} has no retained timeline (known: "
                  f"{known}{'...' if len(records) > 16 else ''})", file=sys.stderr)
            return 2
    else:
        selection = sorted(records, key=lambda r: -(r.get("total_s") or 0.0))[
            :max(args.slowest, 1)]
    if args.format == "json":
        print(json.dumps({"requests": selection, "aggregate": aggregate_phases(records)},
                         indent=2, sort_keys=True))
        return 0
    print(f"obs timeline — {len(records)} retained request(s), showing {len(selection)}")
    for record in selection:
        print()
        print(render_waterfall(record))
    print()
    print(render_aggregate(records))
    print("legend: . queue   # prefill   = decode   x preempted")
    return 0


def _prof(args) -> int:
    """Parse a captured device trace into the per-kernel table."""
    from rocket_tpu_torch.obs.prof import (
        find_trace_file,
        load_trace_events,
        parse_trace,
        prof_record,
        render_prof,
    )

    trace_file = find_trace_file(args.path)
    if trace_file is None:
        print(f"error: no trace-event file under {args.path}", file=sys.stderr)
        return 2
    try:
        events = load_trace_events(trace_file)
    except ValueError as exc:
        print(f"error: {exc}", file=sys.stderr)
        return 2
    summary = parse_trace(events, step_name=args.step_name)
    if summary.n_slices == 0 and not args.target:
        print(f"error: {trace_file} holds no device slices (kernel / gpu_memcpy / gpu_memset "
              "events)", file=sys.stderr)
        return 2
    record = prof_record(summary, top=args.top)
    record["trace_file"] = trace_file
    calib = None
    if args.target:
        from rocket_tpu_torch.analysis.calib import (
            CALIB_TARGETS,
            priced_ops_for_target,
            reconcile_trace,
        )
        from rocket_tpu_torch.obs.prof import capture_metadata

        target = CALIB_TARGETS.get(args.target)
        if target is None:
            print(f"error: --target must be a calib target (one of: "
                  f"{', '.join(sorted(CALIB_TARGETS))})", file=sys.stderr)
            return 2
        ops, priced_record = priced_ops_for_target(target)
        # The sidecar names the machine that MEASURED; this host must not
        # claim its own card.
        meta = capture_metadata(trace_file)
        calib = reconcile_trace(events, ops, priced_record, label=target.name,
                                measured_kind=meta.get("device_kind") or meta.get("platform")
                                or "cpu", join_floor=target.join_floor,
                                error_ceiling=target.error_ceiling)
        record["calib"] = calib.record
        record["calib_findings"] = [f.render() for f in calib.findings]
    if args.format == "json":
        print(json.dumps(record, indent=1, sort_keys=True))
        return 0
    print(f"trace: {trace_file}")
    if summary.n_slices:
        print(render_prof(summary, record, top=args.top))
    if calib is not None:
        from rocket_tpu_torch.analysis.calib import render_calib

        if calib.record:
            print(render_calib(calib.record))
        for finding in calib.findings:
            print(finding.render())
    return 0


def _load(path: str):
    try:
        with open(path, "r", encoding="utf-8") as f:
            return json.load(f)
    except (OSError, json.JSONDecodeError) as exc:
        print(f"error: cannot read {path}: {exc}", file=sys.stderr)
        return None


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(prog="python -m rocket_tpu_torch.obs",
                                     description="render telemetry records, black-box "
                                                 "bundles and device traces")
    sub = parser.add_subparsers(dest="command")
    sub.add_parser("report", help="render telemetry.json, supervisor.json, a run dir (falling "
                   "back to its streaming shards) or a span file").add_argument("path")
    top = sub.add_parser("top", help="cross-rank live view over a run's streaming shards")
    top.add_argument("path", help="run dir (or its telemetry/ dir) holding rank*.jsonl")
    top.add_argument("--once", action="store_true", help="render one frame and exit")
    top.add_argument("--interval", type=float, default=2.0, help="refresh seconds (default: 2)")
    watch = sub.add_parser("watch", help="evaluate SLO specs over a run's streaming shards; "
                           "exit 1 on a violation")
    watch.add_argument("path", help="run dir (or its telemetry/ dir) holding rank*.jsonl")
    watch.add_argument("--slo", required=True, metavar="SPEC",
                       help="SLO spec file (rocket_tpu_torch.obs.slo grammar), or "
                            "default:serve / default:train")
    timeline = sub.add_parser("timeline", help="per-request waterfalls and the phase breakdown "
                              "of a serve run's request timelines (obs.reqtrace)")
    timeline.add_argument("path", help="run dir (or its telemetry/ dir, or a reqtrace/"
                                       "exemplars jsonl file)")
    timeline.add_argument("--request", type=int, default=None, metavar="ID",
                          help="render this request id's waterfall only")
    timeline.add_argument("--slowest", type=int, default=3, metavar="N",
                          help="render the N slowest requests by total latency (default: 3; "
                               "ignored with --request)")
    timeline.add_argument("--format", choices=("text", "json"), default="text")
    sub.add_parser("blackbox", help="render a flight-recorder bundle") \
        .add_argument("path", help=f"bundle directory or its {BLACKBOX_FILE}")
    prof = sub.add_parser("prof", help="render a captured torch.profiler trace as measured "
                                       "per-kernel attribution")
    prof.add_argument("path", help="trace file (*.trace.json[.gz]) or a capture directory")
    prof.add_argument("--target", default=None,
                      help="reconcile against this calibration target's priced step "
                           "(python -m rocket_tpu_torch.analysis calib --list-targets)")
    prof.add_argument("--step-name", default=None, choices=("serve_tick", "ProfilerStep"),
                      help="only count steps of this annotation (default: all)")
    prof.add_argument("--top", type=int, default=15, help="rows in the per-kernel table")
    prof.add_argument("--format", choices=("text", "json"), default="text")
    args = parser.parse_args(argv)
    if args.command == "prof":
        return _prof(args)
    if args.command == "timeline":
        return _timeline(args)
    if args.command == "top":
        return _top(args)
    if args.command == "watch":
        return _watch(args)
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
        # A run dir: the teardown's record, else the supervisor's, else the
        # live exporter's shards (all a worker killed early leaves).
        names = [n for n in ("telemetry.json", "supervisor.json")
                 if os.path.exists(os.path.join(path, n))]
        if not names:
            return _report_from_shards(path)
        path = os.path.join(path, names[0])
    doc = _load(path)
    if doc is None:
        return 2
    if isinstance(doc, dict) and "generations" in doc and "goodput" not in doc:
        print(render_supervisor(doc))
        return 0
    if isinstance(doc, dict) and "goodput" in doc:
        out = render_telemetry(doc)
        # A supervised run keeps supervisor.json beside (or above) its record.
        here = os.path.dirname(os.path.abspath(path))
        for candidate in (os.path.join(here, "supervisor.json"),
                          os.path.join(os.path.dirname(here), "supervisor.json")):
            if os.path.exists(candidate):
                sup = _load(candidate)
                if isinstance(sup, dict):
                    out += "\n\n" + render_supervisor(sup)
                break
        print(out)
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
