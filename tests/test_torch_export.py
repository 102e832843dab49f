"""The port's live export plane (``obs/export.py``, ``obs/slo.py``) and the
obs CLI's live views against the JAX package's: streaming shards,
Prometheus text exposition, the ``/metrics`` endpoint, the cross-rank
merge, SLO burn rates, ``obs top`` / ``watch`` / ``report``'s shard
fallback, and the Runtime's export switches.

Parity with the reference: ``render_prometheus`` of one snapshot is
byte-identical; ``merge_rank_records`` gives equal records;
``SLOEvaluator`` over one record stream gives the same statuses; shards
written by either package's ``ShardWriter`` read with the other's readers.
"""

import dataclasses
import json
import math
import os
import urllib.error
import urllib.request

import pytest

import rocket_tpu_torch as rt
from rocket_tpu.obs import export as jexport
from rocket_tpu.obs import slo as jslo
from rocket_tpu.obs.registry import MetricsRegistry as JRegistry
from rocket_tpu_torch.obs.export import (
    ExportConfig,
    PrometheusServer,
    ShardWriter,
    TelemetryExporter,
    host_identity,
    merge_rank_records,
    prometheus_name,
    read_shard_file,
    read_telemetry_dir,
    render_prometheus,
)
from rocket_tpu_torch.obs.registry import MetricsRegistry, estimate_quantiles
from rocket_tpu_torch.obs.slo import SLOEvaluator, SLOSpec, load_slo_specs
from rocket_tpu_torch.obs.telemetry import Telemetry


def parse_prometheus(text: str) -> dict:
    """A small text-exposition (0.0.4) parser: ``{"types": {family: kind},
    "samples": {sample name: [(labels, value)]}}``."""
    families, samples = {}, {}
    for line in text.splitlines():
        if line.startswith("# TYPE "):
            _, _, name, kind = line.split()
            families[name] = kind
        elif line and not line.startswith("#"):
            name_labels, raw = line.rsplit(" ", 1)
            labels = {}
            if "{" in name_labels:
                name, inner = name_labels.split("{", 1)
                for pair in inner.rstrip("}").split(","):
                    key, val = pair.split("=", 1)
                    labels[key] = val.strip('"')
            else:
                name = name_labels
            samples.setdefault(name, []).append((labels, float(raw)))
    return {"types": families, "samples": samples}


def _fill(registry):
    registry.counter("serve/requests").inc(7)
    registry.counter("train/steps").inc(3)
    registry.gauge("goodput/goodput_fraction").set(0.85)
    registry.gauge("perf/steps_per_sec").set(6.25)
    registry.gauge("health/loss").set(float("nan"))
    hist = registry.histogram("serve/itl_s", base=1e-6)
    for value in (1e-6, 3e-6, 3e-6, 100e-6, 0.1):
        hist.observe(value)
    registry.histogram("empty/s")
    return registry


# -- parity -----------------------------------------------------------------------


@pytest.mark.parametrize("labels", [None, {"rank": 1}, {"role": "supervisor", "rank": 0}])
def test_render_prometheus_is_byte_identical_to_the_reference(labels):
    port, ref = _fill(MetricsRegistry()).snapshot(), _fill(JRegistry()).snapshot()
    assert render_prometheus(port, labels=labels) == jexport.render_prometheus(ref, labels=labels)
    assert render_prometheus(port, labels=labels) == jexport.render_prometheus(port, labels=labels)
    # The string forms of non-finite gauges (telemetry.json's) render alike too.
    strings = {"gauges": {"a": "NaN", "b": "Infinity", "c": "-Infinity", "d": "text"}}
    assert render_prometheus(strings) == jexport.render_prometheus(strings)


def _rank_record(rank, steps_per_sec, requests, itl_buckets, pid=None, t=1000.0, goodput=0.9):
    return {"rank": rank, "seq": 5, "t_unix": t, "uptime_s": 50.0, "hostname": f"host{rank}",
            "pid": 100 + rank if pid is None else pid, "goodput": {"goodput_fraction": goodput},
            "metrics": {"counters": {"serve/requests": requests},
                        "gauges": {"perf/steps_per_sec": steps_per_sec, "bad": "NaN"},
                        "histograms": {"serve/itl_s": {
                            "count": sum(itl_buckets.values()), "total": 1.0, "min": 1e-5,
                            "max": 1e-2, "buckets": itl_buckets}}}}


def test_merge_rank_records_equals_the_references():
    latest = {0: _rank_record(0, 50.0, 100.0, {"le_1e-05": 10, "le_2e-05": 30}),
              1: _rank_record(1, 40.0, 120.0, {"le_2e-05": 10, "le_4e-05": 50}),
              2: _rank_record(2, 10.0, 80.0, {"le_1e-05": 5})}
    merged = merge_rank_records(latest)
    assert merged == jexport.merge_rank_records(latest)
    assert merged["counters"]["serve/requests"] == pytest.approx(300.0)
    stat = merged["gauges"]["perf/steps_per_sec"]
    assert stat["min_rank"] == 2 and stat["max_rank"] == 0
    assert stat["skew"] == pytest.approx((50.0 - 10.0) / (100.0 / 3))
    hist = merged["histograms"]["serve/itl_s"]
    assert hist["count"] == 105 and hist["buckets"] == {"le_1e-05": 15, "le_2e-05": 40,
                                                        "le_4e-05": 50}
    assert 1e-5 <= estimate_quantiles(hist)["p50"] <= 4e-5
    uniform = {r: _rank_record(r, 42.0, 1.0, {"le_1e-05": 1}) for r in range(4)}
    assert merge_rank_records(uniform)["gauges"]["perf/steps_per_sec"]["skew"] == 0.0


SPECS = [dict(name="train_goodput", kind="gauge_min", metric="goodput/goodput_fraction",
              objective=0.8, warmup_s=30.0),
         dict(name="steps", kind="gauge_min", metric="perf/steps_per_sec", objective=3.0),
         dict(name="queue", kind="gauge_max", metric="serve/queue_depth", objective=64.0),
         dict(name="itl_p90", kind="quantile", metric="serve/itl_s", objective=1e-3,
              quantile=0.9, window_s=100.0)]


def _stream():
    """One process's records: goodput from a cold start, a steps/s dip, a
    queue spike and an ITL tail that ages out of its window."""
    registry = MetricsRegistry()
    hist = registry.histogram("serve/itl_s", base=1e-6)
    out = []
    for i, t in enumerate([0.0, 10.0, 35.0, 60.0, 70.0, 80.0, 200.0, 400.0]):
        for _ in range(20):
            hist.observe(1e-4 if i % 3 else 0.1)
        registry.gauge("perf/steps_per_sec").set([0.0, 2.0, 6.0, 6.1, 1.0, 6.2, 6.0, 5.9][i])
        registry.gauge("serve/queue_depth").set([1, 2, 128, 3, 4, 70, 2, 1][i])
        out.append((t, registry.snapshot(), {"goodput_fraction": [0.0, 0.3, 0.5, 0.85, 0.9, 0.7,
                                                                  0.95, 0.99][i]}))
    return out


def test_slo_evaluator_gives_the_references_statuses_over_one_stream():
    port = SLOEvaluator([SLOSpec(**s) for s in SPECS])
    ref = jslo.SLOEvaluator([jslo.SLOSpec(**s) for s in SPECS])
    seen_violation = set()
    for t, snap, goodput in _stream():
        got = [dataclasses.asdict(s) for s in port.observe(t, snap, goodput)]
        want = [dataclasses.asdict(s) for s in ref.observe(t, snap, goodput)]
        assert got == want, t
        seen_violation |= {s["name"] for s in got if s["newly_violated"]}
    assert seen_violation == {"train_goodput", "steps", "queue", "itl_p90"}


def test_shards_of_either_package_read_with_the_others_readers(tmp_path):
    records = [_rank_record(0, 40.0 + i, 1.0, {"le_1e-05": 1}) | {"seq": i} for i in range(3)]
    ShardWriter(str(tmp_path / "port" / "telemetry" / "rank0.jsonl")).append(records[0])
    jexport.ShardWriter(str(tmp_path / "ref" / "telemetry" / "rank1.jsonl")).append(records[1])
    for root in ("port", "ref"):
        with open(tmp_path / root / "telemetry" / os.listdir(tmp_path / root / "telemetry")[0],
                  "a") as f:
            f.write('{"torn')
    assert read_telemetry_dir(str(tmp_path / "ref")) == {1: [records[1]]}
    assert jexport.read_telemetry_dir(str(tmp_path / "port")) == {0: [records[0]]}
    # A writer of one package resumes the other's shard, torn tail and all.
    ShardWriter(str(tmp_path / "ref" / "telemetry" / "rank1.jsonl")).append(records[2])
    assert jexport.read_shard_file(str(tmp_path / "ref" / "telemetry" / "rank1.jsonl")) == [
        records[1], records[2]]


# -- streaming shards -------------------------------------------------------------


def test_shard_round_trip_skips_a_torn_last_line(tmp_path):
    path = str(tmp_path / "telemetry" / "rank0.jsonl")
    writer = ShardWriter(path)
    for seq in range(3):
        writer.append({"version": 1, "seq": seq, "metrics": {"gauges": {"x": 40 + seq}}})
    with open(path, "a", encoding="utf-8") as f:
        f.write('{"version": 1, "seq": 3, "metr')
    records = read_shard_file(path)
    assert [r["seq"] for r in records] == [0, 1, 2] and records[-1]["metrics"]["gauges"]["x"] == 42
    ShardWriter(path).append({"version": 1, "seq": 4})
    assert [r["seq"] for r in read_shard_file(path)] == [0, 1, 2, 4]


def test_shard_compaction_bounds_and_keeps_the_newest(tmp_path):
    path = str(tmp_path / "rank0.jsonl")
    writer = ShardWriter(path, retention_lines=10)
    for seq in range(25):
        writer.append({"seq": seq})
    records = read_shard_file(path)
    assert len(records) <= 10 and records[-1]["seq"] == 24 and not os.path.exists(path + ".tmp")


def test_read_telemetry_dir_groups_by_rank(tmp_path):
    for rank in (0, 2):
        ShardWriter(str(tmp_path / "run" / "telemetry" / f"rank{rank}.jsonl")).append({"seq": 0})
    (tmp_path / "run" / "telemetry" / "notes.txt").write_text("hi")
    assert sorted(read_telemetry_dir(str(tmp_path / "run"))) == [0, 2]
    assert sorted(read_telemetry_dir(str(tmp_path / "run" / "telemetry"))) == [0, 2]
    assert read_telemetry_dir(str(tmp_path / "empty")) == {}


# -- the endpoint ------------------------------------------------------------------


def test_prometheus_name_and_cumulative_buckets():
    assert prometheus_name("serve/ttft_s") == "rocket_tpu_serve_ttft_s"
    assert prometheus_name("obs/slo/x-y.z/burn_rate") == "rocket_tpu_obs_slo_x_y_z_burn_rate"
    parsed = parse_prometheus(render_prometheus(_fill(MetricsRegistry()).snapshot(),
                                                labels={"rank": 1}))
    assert parsed["types"]["rocket_tpu_serve_itl_s"] == "histogram"
    ordered = sorted(parsed["samples"]["rocket_tpu_serve_itl_s_bucket"],
                     key=lambda s: float(s[0]["le"].replace("+Inf", "inf")))
    counts = [value for _, value in ordered]
    assert counts == sorted(counts) and ordered[-1] == ({"le": "+Inf", "rank": "1"}, 5.0)
    (_, total), = parsed["samples"]["rocket_tpu_serve_itl_s_sum"]
    assert total == pytest.approx(1e-6 + 3e-6 + 3e-6 + 100e-6 + 0.1)
    (_, nan), = parsed["samples"]["rocket_tpu_health_loss"]
    assert math.isnan(nan)


def test_metrics_endpoint_serves_live_snapshots():
    registry = MetricsRegistry()
    registry.gauge("train/step").set(1)
    server = PrometheusServer(registry.snapshot, port=0, labels={"rank": 0})
    server.start()
    try:
        url = f"http://127.0.0.1:{server.port}/metrics"
        assert 'rocket_tpu_train_step{rank="0"} 1' in urllib.request.urlopen(
            url, timeout=5).read().decode()
        registry.gauge("train/step").set(2)
        assert 'rocket_tpu_train_step{rank="0"} 2' in urllib.request.urlopen(
            url, timeout=5).read().decode()
        with pytest.raises(urllib.error.HTTPError):
            urllib.request.urlopen(f"http://127.0.0.1:{server.port}/nope", timeout=5)
    finally:
        server.stop()


def test_export_config_from_env(monkeypatch):
    for name in ("ROCKET_TPU_EXPORT", "ROCKET_TPU_METRICS_PORT", "ROCKET_TPU_SLO"):
        monkeypatch.delenv(name, raising=False)
    assert not ExportConfig.from_env().active
    monkeypatch.setenv("ROCKET_TPU_EXPORT", "2.5")
    config = ExportConfig.from_env()
    assert config.enabled and config.interval_s == 2.5
    monkeypatch.setenv("ROCKET_TPU_EXPORT", "1")
    assert ExportConfig.from_env().interval_s == 10.0
    monkeypatch.setenv("ROCKET_TPU_METRICS_PORT", "9099")
    monkeypatch.setenv("ROCKET_TPU_SLO", "default:train")
    config = ExportConfig.from_env()
    assert config.metrics_port == 9099 and config.slo_path == "default:train"
    config = ExportConfig.from_env(enabled=False, metrics_port=7)
    assert not config.enabled and config.metrics_port == 7 and config.active
    assert dataclasses.asdict(ExportConfig.from_env()) == dataclasses.asdict(
        jexport.ExportConfig.from_env())


def test_host_identity_reads_torch_distributed_rank(monkeypatch):
    monkeypatch.setenv("RANK", "3")
    monkeypatch.setenv("JAX_PROCESS_ID", "7")
    identity = host_identity()
    assert identity["rank"] == 3 and identity["hostname"] and identity["pid"] == os.getpid()
    assert host_identity(process_index=5)["rank"] == 5


# -- SLO specs -----------------------------------------------------------------------


def test_slo_gauge_min_burn_and_warmup_grace():
    evaluator = SLOEvaluator([SLOSpec(**SPECS[0])])
    status, = evaluator.observe(0.0, {"gauges": {}}, {"goodput_fraction": 0.0})
    assert status.burn_rate == math.inf and not status.violated
    status, = evaluator.observe(10.0, {"gauges": {}}, {"goodput_fraction": 0.4})
    assert status.burn_rate == pytest.approx(2.0) and not status.violated
    status, = evaluator.observe(60.0, {"gauges": {}}, {"goodput_fraction": 0.4})
    assert status.violated and status.newly_violated
    status, = evaluator.observe(80.0, {"gauges": {}}, {"goodput_fraction": 0.95})
    assert not status.violated and status.burn_rate < 1.0


def test_default_train_spec_and_validation(tmp_path):
    train = load_slo_specs("default:train")
    assert {s.name for s in train} == {"train_goodput", "train_steps_per_sec"}
    assert all(s.warmup_s > 0 and s.kind == "gauge_min" for s in train)
    goodput = next(s for s in train if s.name == "train_goodput")
    assert goodput.objective == 0.8 and goodput.metric == "goodput/goodput_fraction"
    steps = next(s for s in train if s.name == "train_steps_per_sec")
    ref = next(s for s in jslo.load_slo_specs("default:train") if s.name == "train_steps_per_sec")
    # The reference's floor is half a CPU container's MLP rate; the port's
    # is half of GPT-2 124M's rate measured on the H100, named in the spec.
    assert steps.objective != ref.objective and 0 < steps.objective < 20
    with open(os.path.join(os.path.dirname(rt.obs.slo.__file__), "slo_specs",
                           "train.json")) as f:
        assert "H100" in json.load(f)["comment"]
    # The port's own serve spec: literal ITL/TTFT p99 ceilings measured on
    # the H100 (the reference derives them from a TPU roofline's budget).
    serve = {s.name: s for s in load_slo_specs("default:serve")}
    assert set(serve) == {s.name for s in jslo.load_slo_specs("default:serve")}
    assert serve["serve_queue_depth"].objective == 64
    assert all(s.kind == "quantile" and s.quantile == 0.99 and s.objective > 0
               for n, s in serve.items() if n != "serve_queue_depth")
    with open(os.path.join(os.path.dirname(rt.obs.slo.__file__), "slo_specs",
                           "serve.json")) as f:
        assert "H100" in json.load(f)["comment"]
    bad = tmp_path / "bad.json"
    bad.write_text(json.dumps({"version": 1, "slos": [{"name": "x", "kind": "nope",
                                                       "metric": "m", "objective": 1}]}))
    with pytest.raises(ValueError):
        load_slo_specs(str(bad))
    with pytest.raises(ValueError):
        load_slo_specs("default:imaginary")


# -- the exporter -------------------------------------------------------------------


def test_exporter_tick_shard_schema_and_slo_gauges(tmp_path):
    spec = tmp_path / "slo.json"
    spec.write_text(json.dumps({"version": 1, "slos": [
        {"name": "steps_floor", "kind": "gauge_min", "metric": "perf/steps_per_sec",
         "objective": 100.0}]}))
    telemetry = Telemetry(enabled=True, out_dir=str(tmp_path / "run"))
    telemetry.registry.gauge("perf/steps_per_sec").set(5.0)
    exporter = TelemetryExporter(telemetry, ExportConfig(enabled=True, slo_path=str(spec)),
                                 identity={"rank": 0, "hostname": "testhost", "pid": 1234})
    record = exporter.tick()
    assert (record["version"], record["seq"], record["rank"], record["final"]) == (1, 0, 0, False)
    assert record["hostname"] == "testhost" and record["goodput"]["goodput_fraction"] is not None
    verdict, = [s for s in record["slo"] if s["name"] == "steps_floor"]
    assert verdict["violated"] and verdict["burn_rate"] == pytest.approx(20.0)
    assert record["metrics"]["gauges"]["obs/slo/steps_floor/violated"] == 1.0
    assert record["metrics"]["counters"]["obs/slo/steps_floor/violations"] == 1
    assert "goodput/goodput_fraction" in record["metrics"]["gauges"]
    assert read_shard_file(str(tmp_path / "run" / "telemetry" / "rank0.jsonl"))[0]["seq"] == 0
    final = exporter.tick(final=True)
    assert final["final"] and final["seq"] == 1
    assert final["metrics"]["counters"]["obs/slo/steps_floor/violations"] == 1


def test_exporter_carries_its_shard_when_the_out_dir_resolves_late(tmp_path):
    telemetry = Telemetry(enabled=True)
    exporter = TelemetryExporter(telemetry, ExportConfig(enabled=True),
                                 identity={"rank": 0, "hostname": "h", "pid": 1},
                                 default_dir=str(tmp_path / "early"))
    exporter.tick()
    old = tmp_path / "early" / "telemetry" / "rank0.jsonl"
    assert old.exists()
    telemetry.suggest_out_dir(str(tmp_path / "runs" / "proj"))
    exporter.tick()
    assert not old.exists()
    assert [r["seq"] for r in read_shard_file(
        str(tmp_path / "runs" / "proj" / "telemetry" / "rank0.jsonl"))] == [0, 1]


def test_runtime_export_streams_shards_and_serves_metrics_during_the_run(tmp_path, monkeypatch):
    """``Runtime(export=True, metrics_port=0, slo="default:train")``: the
    endpoint answers during the run with the step counter a capsule keeps,
    the shards parse, the final record carries the SLO verdicts, and the
    teardown stops the endpoint."""
    for name in ("ROCKET_TPU_EXPORT", "ROCKET_TPU_METRICS_PORT", "ROCKET_TPU_SLO"):
        monkeypatch.delenv(name, raising=False)
    runtime = rt.Runtime(device="cpu", export=True, export_interval_s=0.05, metrics_port=0,
                         slo="default:train", project_dir=str(tmp_path),
                         telemetry_dir=str(tmp_path / "tel"))
    assert runtime.telemetry.enabled and runtime.telemetry.exporter is not None
    server = runtime.telemetry.exporter.server
    scraped = []

    class Scrape(rt.Capsule):
        def launch(self, attrs=None):
            runtime.telemetry.registry.counter("train/steps").inc()
            url = f"http://127.0.0.1:{server.port}/metrics"
            scraped.append(urllib.request.urlopen(url, timeout=5).read().decode())

    rt.Launcher([rt.Looper([Scrape()], repeats=3, progress=False)], runtime=runtime).launch()
    assert 'rocket_tpu_train_steps{rank="0"} 3' in scraped[-1]
    assert "rocket_tpu_goodput_goodput_fraction" in scraped[-1]
    records = read_shard_file(str(tmp_path / "tel" / "telemetry" / "rank0.jsonl"))
    assert records and records[-1]["final"] and records[-1]["metrics"]["counters"][
        "train/steps"] == 3
    assert {s["name"] for s in records[-1]["slo"]} == {"train_goodput", "train_steps_per_sec"}
    assert runtime.telemetry.exporter.server is None
    with pytest.raises(OSError):
        urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics", timeout=2)


def test_supervisor_metrics_endpoint(tmp_path):
    from rocket_tpu_torch.resilience.supervisor import Supervisor

    supervisor = Supervisor(nproc=2, script="train.py", metrics_port=0, state_dir=str(tmp_path))
    supervisor._start_metrics()
    try:
        assert supervisor._metrics_server is not None
        supervisor._publish_metrics()
        url = f"http://127.0.0.1:{supervisor._metrics_server.port}/metrics"
        body = urllib.request.urlopen(url, timeout=5).read().decode()
    finally:
        supervisor._stop_metrics()
    assert 'rocket_tpu_supervisor_restarts{role="supervisor"} 0' in body
    assert 'rocket_tpu_supervisor_generations{role="supervisor"} 0' in body
    assert "rocket_tpu_supervisor_goodput_fraction" in body


# -- the obs CLI: top, watch, report's fallback ---------------------------------------


def _write_fleet(run_dir, ranks=(0, 1)):
    for rank in ranks:
        ShardWriter(os.path.join(run_dir, "telemetry", f"rank{rank}.jsonl")).append(
            _rank_record(rank, 50.0 - 10 * rank, 100.0, {"le_1e-05": 10}))


def test_obs_top_once_renders_the_fleet(tmp_path, capsys):
    from rocket_tpu_torch.obs.__main__ import main

    _write_fleet(str(tmp_path))
    assert main(["top", str(tmp_path), "--once"]) == 0
    out = capsys.readouterr().out
    assert "obs top — 2 rank(s)" in out and "host0" in out and "host1" in out
    assert "perf/steps_per_sec" in out and "rank 0" in out and "serve/itl_s" in out
    assert main(["top", str(tmp_path / "void"), "--once"]) == 2


def test_obs_watch_gates_on_slo(tmp_path, capsys):
    from rocket_tpu_torch.obs.__main__ import main

    _write_fleet(str(tmp_path))
    tight, slack = tmp_path / "tight.json", tmp_path / "slack.json"
    for path, objective in ((tight, 1000.0), (slack, 1.0)):
        path.write_text(json.dumps({"version": 1, "slos": [
            {"name": "steps_floor", "kind": "gauge_min", "metric": "perf/steps_per_sec",
             "objective": objective}]}))
    assert main(["watch", str(tmp_path), "--slo", str(tight)]) == 1
    out = capsys.readouterr().out
    assert "VIOLATION steps_floor (rank 0)" in out and "VIOLATION steps_floor (rank 1)" in out
    assert main(["watch", str(tmp_path), "--slo", str(slack)]) == 0
    assert "all SLOs within objective" in capsys.readouterr().out
    assert main(["watch", str(tmp_path), "--slo", str(tmp_path / "missing.json")]) == 2
    # The serve spec loads; a train run's shards carry none of its metrics.
    assert main(["watch", str(tmp_path), "--slo", "default:serve"]) == 0


def test_obs_watch_gives_each_process_of_a_shard_its_own_warmup(tmp_path, capsys):
    """A supervised rank appends one run of records per generation to the
    same shard. Each process's records replay through a fresh evaluator, as
    its live exporter evaluated them: a restarted generation's cold start
    sits in its own warmup. One evaluator over the whole shard (the
    reference's replay) would read the restart's cold start, 40 s after
    the first process began, as a violation."""
    from rocket_tpu_torch.obs.__main__ import main

    path = str(tmp_path / "telemetry" / "rank0.jsonl")
    writer = ShardWriter(path)
    for pid, t0 in ((11, 1000.0), (12, 1040.0)):
        for dt, goodput in ((0.0, 0.0), (10.0, 0.5), (20.0, 0.6)):
            writer.append(_rank_record(0, 5.0, 1.0, {"le_1e-05": 1}, pid=pid, t=t0 + dt,
                                       goodput=goodput))
    spec = tmp_path / "goodput.json"
    spec.write_text(json.dumps({"version": 1, "slos": [
        {"name": "train_goodput", "kind": "gauge_min", "metric": "goodput/goodput_fraction",
         "objective": 0.8, "warmup_s": 30}]}))
    assert main(["watch", str(tmp_path), "--slo", str(spec)]) == 0
    assert "6 record(s)" in capsys.readouterr().out
    one = jslo.SLOEvaluator(jslo.load_slo_specs(str(spec)))
    verdicts = [one.observe(r["t_unix"], r["metrics"], r["goodput"])[0].violated
                for r in read_shard_file(path)]
    assert verdicts == [False, False, False, True, True, True]


def test_obs_report_falls_back_to_shards(tmp_path, capsys):
    from rocket_tpu_torch.obs.__main__ import main

    _write_fleet(str(tmp_path / "solo"), ranks=(0,))
    assert main(["report", str(tmp_path / "solo")]) == 0
    assert "reconstructed from streaming shards" in capsys.readouterr().out
    _write_fleet(str(tmp_path / "fleet"), ranks=(0, 1))
    assert main(["report", str(tmp_path / "fleet")]) == 0
    assert "obs top — 2 rank(s)" in capsys.readouterr().out
    assert main(["report", str(tmp_path / "void")]) == 2
