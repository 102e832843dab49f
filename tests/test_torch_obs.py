"""The port's ops plane (``rocket_tpu_torch/obs``, ``runtime.StrictMode``)
against the JAX package's (``rocket_tpu/obs``).

The same observations go through both packages' instruments and the
snapshots, quantiles and goodput tables must be equal; each package loads
the other's Chrome trace, and each CLI renders the other's telemetry record
and black-box bundle. The watchdog, the flight recorder and the Runtime's
ops arguments are held to the reference's structure (timings are not
compared: they are wall clocks).
"""

import json
import os
import threading
import time

import numpy as np
import pytest
import torch

import rocket_tpu as jrt
import rocket_tpu_torch as rt
from rocket_tpu.obs import __main__ as jcli
from rocket_tpu.obs import flight as jflight
from rocket_tpu.obs import goodput as jgoodput
from rocket_tpu.obs import registry as jregistry
from rocket_tpu.obs import spans as jspans
from rocket_tpu.obs.telemetry import Telemetry as JTelemetry
from rocket_tpu.utils.probe import Probe as JProbe
from rocket_tpu_torch.obs import __main__ as tcli
from rocket_tpu_torch.obs import flight as tflight
from rocket_tpu_torch.obs import goodput as tgoodput
from rocket_tpu_torch.obs import registry as tregistry
from rocket_tpu_torch.obs import spans as tspans
from rocket_tpu_torch.obs.telemetry import Telemetry
from rocket_tpu_torch.obs.watchdog import Watchdog
from rocket_tpu_torch.runtime import StrictMode, explicit_transfer
from rocket_tpu_torch.utils.probe import Probe

torch.set_num_threads(1)


def _observations(seed=0):
    rng = np.random.default_rng(seed)
    return np.concatenate([rng.lognormal(-7, 2, 300), [0.0, 1e-9, 3.5, 1e4]]).tolist()


def _fill(registry, values):
    registry.counter("events").inc()
    registry.counter("events").inc(2.5)
    registry.gauge("depth").set(7)
    registry.gauge("unset")
    for v in values:
        registry.histogram("latency").observe(v)
    for v in values[:40]:
        registry.histogram("depth_hist", base=1.0).observe(v * 1e4)


def test_registry_snapshots_and_quantiles_equal_the_reference():
    values = _observations()
    ours, ref = tregistry.MetricsRegistry(), jregistry.MetricsRegistry()
    _fill(ours, values)
    _fill(ref, values)
    assert ours.snapshot() == ref.snapshot()
    assert ours.scalars() == ref.scalars()
    snap = ours.snapshot()["histograms"]["latency"]
    for qs in ((0.5, 0.9, 0.99), (0.1, 0.75)):
        assert tregistry.estimate_quantiles(snap, qs) == jregistry.estimate_quantiles(snap, qs)
    for bad in ({}, {"count": 3, "buckets": {"le_x": 1}}, {"count": 0, "buckets": {}}):
        assert tregistry.estimate_quantiles(bad) == jregistry.estimate_quantiles(bad)
    assert ours.reset("dep") == ref.reset("dep") == 1
    assert ours.snapshot() == ref.snapshot()


def test_goodput_report_and_table_equal_the_reference():
    ours, ref = tgoodput.Goodput(), jgoodput.Goodput()
    for g in (ours, ref):
        g.push("step", 0.0)
        g.push("data_wait", 1.0)
        g.pop(1.25)
        g.push("flush", 2.0)
        g.pop(2.5)
        g.pop(4.0)
        g.push("compile", 4.0)
        g.pop(4.75)
    assert ours.totals() == ref.totals()
    for wall in (10.0, 3.0, 0.0):
        assert ours.report(wall) == ref.report(wall)
        assert tgoodput.render_report(ours.report(wall)) == jgoodput.render_report(
            ref.report(wall))
    empty = {"total_wall_s": 0, "categories": {"step": 0.0}}
    assert tgoodput.render_report(empty) == jgoodput.render_report(empty)
    assert tgoodput.CATEGORIES == jgoodput.CATEGORIES


def _record_spans(recorder):
    recorder.add("a", "step", recorder.t0 + 0.5, 0.25)
    recorder.add("b", None, recorder.t0 + 1.0, 0.125)
    recorder.push_open("open", "flush", recorder.t0)
    return recorder


def test_each_package_loads_the_others_chrome_trace(tmp_path):
    ours = _record_spans(tspans.SpanRecorder()).write(str(tmp_path / "port.trace.json"))
    theirs = _record_spans(jspans.SpanRecorder()).write(str(tmp_path / "jax.trace.json"))
    for path in (ours, theirs):
        a, b = tspans.load_chrome_trace(path), jspans.load_chrome_trace(path)
        assert a == b
        assert [(e["name"], e["cat"], e["dur"]) for e in a if e["ph"] == "X"] == [
            ("a", "step", 250000.0), ("b", "span", 125000.0)]
    assert _record_spans(tspans.SpanRecorder()).open_spans() == _record_spans(
        jspans.SpanRecorder()).open_spans()
    (tmp_path / "bad.json").write_text(json.dumps([{"name": "x"}]))
    for loader in (tspans.load_chrome_trace, jspans.load_chrome_trace):
        with pytest.raises(ValueError):
            loader(str(tmp_path / "bad.json"))


def test_span_buffer_is_bounded():
    recorder = tspans.SpanRecorder(max_events=2)
    for i in range(5):
        recorder.add(str(i), None, 0.0, 0.0)
    assert len(recorder) == 2 and recorder.dropped == 3


def test_watchdog_fires_on_a_stalled_beat():
    reports = []
    escalated = []
    dog = Watchdog(0.2, on_stall=reports.append, poll_s=0.02, escalate_after=2,
                   on_escalate=escalated.append)
    dog.start()
    try:
        dog.arm()
        for _ in range(5):  # beating: no report
            time.sleep(0.05)
            dog.beat()
        assert dog.stall_count == 0
        deadline = time.monotonic() + 5.0
        while dog.stall_count < 2 and time.monotonic() < deadline:
            time.sleep(0.02)
    finally:
        dog.stop()
    assert dog.stall_count >= 2 and len(escalated) == 1
    report = reports[0]
    assert "no step completed" in report and "cuda allocator:" in report
    assert f"(tid {threading.get_ident()})" in report  # the main thread's stack


def test_flight_recorder_manifest_keys_are_the_references(tmp_path):
    class _Runtime:
        is_main_process, process_index, process_count, project_dir = True, 0, 1, str(tmp_path)

        def rng_state_dict(self):
            return {"seed": 0, "key_counter": 3}

    manifests = []
    for flight_mod, telemetry in ((tflight, Telemetry(enabled=True,
                                                      out_dir=str(tmp_path / "port"))),
                                  (jflight, JTelemetry(enabled=True,
                                                       out_dir=str(tmp_path / "jax")))):
        recorder = flight_mod.FlightRecorder(max_steps=3, telemetry=telemetry,
                                             runtime=_Runtime())
        for step in range(5):
            recorder.record({"step": step, "flag_names": [] if step != 3 else ["x"]})
        recorder.note_anomaly({"step": 3, "flag_names": ["loss_nonfinite"]})
        bundle = recorder.dump("anomaly_step3", extra={"k": object()})
        with open(os.path.join(bundle, flight_mod.BLACKBOX_FILE)) as f:
            manifests.append(json.load(f))
        assert len(recorder) == 3
        assert recorder.last_good_step == 4
    port, ref = manifests
    assert sorted(port) == sorted(ref)
    assert sorted(port["process"]) == sorted(ref["process"])
    for key in ("reason", "last_good_step", "steps_recorded", "sentinel_history", "anomalies",
                "checkpoint", "rng", "version"):
        assert port[key] == ref[key], key


def _jax_run_files(tmp_path):
    """A JAX-package run's telemetry directory."""
    import jax

    runtime = jrt.Runtime(mesh_shape={"data": 1}, devices=jax.devices()[:1],
                          project_dir=str(tmp_path), telemetry=True,
                          telemetry_dir=str(tmp_path / "tel"), watchdog_secs=30.0)
    jrt.Launcher([jrt.Looper([JProbe("p")], repeats=3, progress=False)],
                 runtime=runtime).launch()
    return str(tmp_path / "tel")


def test_report_and_blackbox_render_the_reference_files(tmp_path, capsys):
    tel = _jax_run_files(tmp_path)
    for cli in (tcli, jcli):
        assert cli.main(["report", tel]) == 0
    ours, theirs = capsys.readouterr().out.split("total wall-clock:")[1:]
    assert ours.splitlines()[2:8] == theirs.splitlines()[2:8]  # the phase table's rows
    assert tcli.main(["report", os.path.join(tel, "spans.trace.json")]) == 0
    assert "span file:" in capsys.readouterr().out
    # A reference bundle, then a port bundle, through both CLIs.
    recorder = jflight.FlightRecorder(telemetry=JTelemetry(enabled=True,
                                                           out_dir=str(tmp_path / "jb")))
    recorder.record({"step": 1, "flag_names": [], "loss": 1.0, "grad_norm": 2.0})
    recorder.note_anomaly({"step": 2, "flag_names": ["loss_nonfinite"], "loss": float("nan"),
                           "grad_norm": 1.0, "loss_zscore": 0.0, "bad_grad_branches": ["h"]})
    jbundle = recorder.dump("anomaly_step2")
    port_rec = tflight.FlightRecorder(telemetry=Telemetry(enabled=True,
                                                          out_dir=str(tmp_path / "tb")))
    port_rec.record({"step": 1, "flag_names": []})
    tbundle = port_rec.dump("exception_KeyError")
    outs = []
    for bundle in (jbundle, tbundle):
        for cli in (tcli, jcli):
            assert cli.main(["blackbox", bundle]) == 0
            outs.append(capsys.readouterr().out)
    assert outs[0] == outs[1] and outs[2] == outs[3]
    assert "reason: anomaly_step2" in outs[0] and "loss_nonfinite" in outs[0]
    assert tcli.main(["blackbox", str(tmp_path)]) == 2


def test_port_run_writes_files_the_reference_cli_renders(tmp_path, capsys):
    runtime = rt.Runtime(device="cpu", project_dir=str(tmp_path), telemetry=True,
                         telemetry_dir=str(tmp_path / "tel"))
    trace = []
    rt.Launcher([rt.Looper([Probe("p", trace)], repeats=4, progress=False)],
                runtime=runtime).launch()
    with open(tmp_path / "tel" / "telemetry.json") as f:
        doc = json.load(f)
    categories = doc["goodput"]["categories"]
    assert abs(sum(categories.values()) - doc["goodput"]["total_wall_s"]) < 1e-4
    assert categories["compile"] > 0 and categories["step"] > 0
    events = tspans.load_chrome_trace(str(tmp_path / "tel" / "spans.trace.json"))
    names = {e["name"] for e in events if e["ph"] == "X"}
    assert {"Probe.launch", "train/step", "Looper.set"} <= names
    assert jcli.main(["report", str(tmp_path / "tel")]) == 0
    assert "goodput (step fraction)" in capsys.readouterr().out


@pytest.mark.parametrize("kw", [{"export": True}, {"metrics_port": 9100},
                                {"slo": "default:train"}, {"export_interval_s": 5.0}])
def test_live_export_arguments_raise_naming_queue_a_7b(kw, tmp_path, capsys):
    """The Runtime takes the live export plane's arguments, and since the
    serve half of the plane was ported (Queue A 7b item 4) so does the serve
    CLI: each of the four knobs serves on the CPU and writes its run dir."""
    from rocket_tpu_torch.serve import __main__ as serve_cli

    (key, value), = kw.items()
    flag = {"export": ["--export"], "metrics_port": ["--metrics-port", "0"],
            "slo": ["--slo", "default:serve"], "export_interval_s": ["--export-interval",
                                                                     str(value)]}[key]
    assert serve_cli.main(["run", "--device", "cpu", "--requests", "2", "--max-new-tokens", "3",
                           "--out-dir", str(tmp_path), *flag]) == 0
    assert '"serve_report"' in capsys.readouterr().out
    assert (tmp_path / "telemetry.json").exists()
    assert (tmp_path / "telemetry" / "reqtrace.jsonl").exists()


def test_live_export_environment_raises(monkeypatch, tmp_path):
    """``ROCKET_TPU_EXPORT`` turns the port's export on, and the serve SLO
    spec it may name loads (Queue A 7b item 4 is ported), from the
    environment as from the loader."""
    from rocket_tpu_torch.obs.slo import load_slo_specs

    monkeypatch.setenv("ROCKET_TPU_EXPORT", "1")
    monkeypatch.setenv("ROCKET_TPU_SLO", "default:serve")
    runtime = rt.Runtime(device="cpu", project_dir=str(tmp_path))
    try:
        exporter = runtime.telemetry.exporter
        assert exporter is not None and [s.name for s in exporter.slos.specs] == [
            s.name for s in load_slo_specs("default:serve")]
    finally:
        runtime.telemetry.close(write=False)


def test_ops_arguments_and_environment_follow_the_reference(monkeypatch, tmp_path):
    for env in ("ROCKET_TPU_HEALTH", "ROCKET_TPU_TELEMETRY", "ROCKET_TPU_STRICT",
                "ROCKET_TPU_WATCHDOG"):
        monkeypatch.delenv(env, raising=False)
    plain = rt.Runtime(device="cpu")
    assert not plain.telemetry.enabled and not plain.health.enabled and plain.flight is None
    assert not plain.strict.enabled
    healthy = rt.Runtime(device="cpu", health=True, project_dir=str(tmp_path))
    assert healthy.telemetry.enabled and healthy.flight is not None
    assert healthy.health.config.action == "warn"
    monkeypatch.setenv("ROCKET_TPU_HEALTH", "skip_step")
    from_env = rt.Runtime(device="cpu", project_dir=str(tmp_path))
    assert from_env.health.enabled and from_env.health.config.action == "skip_step"
    assert rt.Runtime(device="cpu", anomaly_action="warn").health.config.action == "warn"
    monkeypatch.setenv("ROCKET_TPU_WATCHDOG", "12.5")
    watched = rt.Runtime(device="cpu", health=False, telemetry=True)
    assert watched.telemetry.watchdog.deadline_s == 12.5
    for runtime in (healthy, from_env, watched):
        runtime.telemetry.close(write=False)
    with pytest.raises(ValueError):
        rt.Runtime(device="cpu", anomaly_action="explode")


def test_strict_mode_is_inert_on_the_cpu():
    """As the reference's guard is on a CPU backend (its caveat, context.py
    :50-53): on, off, lifted, a host read is legal, nothing is set."""
    strict = StrictMode()
    strict.activate()
    assert strict.enabled and strict.sync_debug_mode == "error"
    float(torch.ones(()) * 2)
    with strict.lifted(), explicit_transfer():
        float(torch.ones(()))
    assert strict.note_retraces("step", None) is None
    assert strict.note_collectives("step", 3) == 3 and strict.collective_counts == {"step": 3}
    strict.deactivate()
    assert not strict.enabled
    assert StrictMode("log").sync_debug_mode == "warn"
    with pytest.raises(ValueError):
        StrictMode("sometimes")
    runtime = rt.Runtime(device="cpu", strict=True)
    assert runtime.strict.enabled
    rt.Launcher([rt.Looper([Probe("p")], repeats=2, progress=False)], runtime=runtime).launch()
    assert not runtime.strict.enabled  # end_training lifts it
