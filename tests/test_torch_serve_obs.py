"""The serve half of the ops plane against the reference's engine: the
tiny GPT-2-style config (float32, bridged weights), six greedy requests
through a pool small enough that one is evicted and resumes, served by
each package's ``ServeEngine`` with an enabled ``Telemetry`` and the
request tracer on. The tokens, each request's sequence of tracer event
kinds, the wave count, the registry's ``serve/*`` gauge values and
histogram names and counts, the request spans and ``report()``'s keys all
agree (the port's report adds ``device``).

Then the CLI on the CPU: ``python -m rocket_tpu_torch.serve run`` with
every flag (export shards, ``/metrics``, ``default:serve``, a trace
window, request timelines, ``telemetry.json``), ``--trace-steps 3:1``
refused at parse time (exit 2), ``serve report`` and ``obs timeline``
over its run dir, and ``default:serve`` evaluated by ``obs watch``.
"""

import contextlib
import io
import json
import urllib.request

import jax
import numpy as np
import pytest
import torch

from rocket_tpu.models import transformer as jt
from rocket_tpu.obs.telemetry import Telemetry as JTelemetry
from rocket_tpu.serve import ServeConfig as JServeConfig
from rocket_tpu.serve import ServeEngine as JServeEngine
from rocket_tpu_torch.bridge import params_from_jax
from rocket_tpu_torch.models import transformer as tt
from rocket_tpu_torch.obs import prof as tprof
from rocket_tpu_torch.obs.slo import default_slo_path, load_slo_specs
from rocket_tpu_torch.obs.telemetry import Telemetry
from rocket_tpu_torch.serve import ServeConfig, ServeEngine

torch.set_num_threads(1)

CFG = dict(vocab_size=64, max_seq_len=64, dim=32, num_layers=2, num_heads=4, dropout=0.0)
SIZING = dict(max_slots=3, block_len=4, prefill_chunk=4, max_model_len=32, num_blocks=8)


def _workload():
    rng = np.random.default_rng(7)
    return [(rng.integers(0, 64, size=int(rng.integers(3, 12))).astype(np.int32),
             int(rng.integers(6, 14))) for _ in range(6)]


@pytest.fixture(scope="module")
def served():
    jmodel = jt.TransformerLM(jt.TransformerConfig(**CFG))
    jparams = jax.jit(jmodel.init)(jax.random.key(0))["params"]
    tmodel = tt.TransformerLM(tt.TransformerConfig(**CFG))
    jtel, ttel = JTelemetry(enabled=True), Telemetry(enabled=True)
    jeng = JServeEngine(jmodel, jparams, JServeConfig(**SIZING), telemetry=jtel)
    teng = ServeEngine(tmodel, params_from_jax(jax.tree.map(np.asarray, jparams)),
                       ServeConfig(**SIZING), telemetry=ttel, device="cpu")
    out = {}
    for name, eng in (("jax", jeng), ("port", teng)):
        rids = [eng.submit(p, max_new_tokens=m, temperature=0.0) for p, m in _workload()]
        eng.drain()
        out[name] = (eng, rids)
    return {"jax": out["jax"], "port": out["port"], "jtel": jtel, "ttel": ttel}


def test_tokens_and_eviction_match(served):
    (jeng, jids), (teng, tids) = served["jax"], served["port"]
    for jid, tid in zip(jids, tids):
        assert teng.result(tid).tokens == jeng.result(jid).tokens, tid
    rep = teng.report()
    assert rep["requests"]["completed"] == 6
    assert rep["requests"]["preemptions"] == jeng.report()["requests"]["preemptions"] > 0
    assert teng.engine.decode_waves == jeng.engine.decode_waves
    assert teng.tracer._seq == jeng.tracer._seq == teng.engine.decode_dispatches


def test_each_requests_tracer_events_match(served):
    (jeng, jids), (teng, tids) = served["jax"], served["port"]
    kinds = lambda rec: [ev["ev"] for ev in rec["events"]]  # noqa: E731
    for jid, tid in zip(jids, tids):
        got, want = teng.tracer.timeline(tid), jeng.tracer.timeline(jid)
        assert kinds(got) == kinds(want), tid
        assert got["tokens"] == want["tokens"] and got["preemptions"] == want["preemptions"]
        phases = got["phases"]
        assert sum(phases.values()) == pytest.approx(got["total_s"], rel=1e-3, abs=1e-5)
        assert [ev.get("n") for ev in got["events"] if ev["ev"] == "wave"] == \
            [ev.get("n") for ev in want["events"] if ev["ev"] == "wave"]
    assert any(teng.tracer.timeline(t)["preemptions"] for t in tids)
    assert set(teng.report()["phases"]) == set(jeng.report()["phases"])


def test_registry_names_counts_and_spans_match(served):
    got, want = served["ttel"].registry.snapshot(), served["jtel"].registry.snapshot()
    serve = lambda d: {k: v for k, v in d.items() if k.startswith("serve/")}  # noqa: E731
    assert serve(got["gauges"]) == serve(want["gauges"])
    assert serve(got["counters"]) == serve(want["counters"])
    hist = lambda snap: {k: v["count"] for k, v in serve(snap["histograms"]).items()}  # noqa
    assert hist(got) == hist(want)
    assert {"serve/ttft_s", "serve/itl_s", "serve/queue_wait_s", "serve/prefill_s",
            "serve/decode_s", "serve/preempted_s"} <= set(hist(got))
    assert hist(got)["serve/ttft_s"] == 6
    tokens = sum(len(served["port"][0].result(r).tokens) for r in served["port"][1])
    # Each token after a request's first batch lands one ITL sample.
    assert hist(got)["serve/itl_s"] == len(served["port"][0]._itl) <= tokens - 6
    assert served["ttel"].reqtrace is served["port"][0].tracer
    names = lambda tel: sorted(ev[0] for ev in tel.spans.events() if ev[1] == "serve")  # noqa
    assert names(served["ttel"]) == names(served["jtel"]) == [
        f"serve/request[{i}]" for i in range(6)]


def test_report_keys_match(served):
    got, want = served["port"][0].report(), served["jax"][0].report()
    assert set(got) - {"device"} == set(want)
    for key in ("requests", "compiled", "dispatch", "pool", "slots"):
        assert set(got[key]) == set(want[key]), key
    assert got["compiled"] == want["compiled"]


def test_reset_metrics_windows_the_registry_and_reqtrace_off_runs_alike(served):
    tmodel = tt.TransformerLM(tt.TransformerConfig(**CFG))
    params = tmodel.init(torch.Generator().manual_seed(1), device="cpu")
    tel = Telemetry(enabled=True)
    eng = ServeEngine(tmodel, params, ServeConfig(**SIZING), telemetry=tel, device="cpu")
    off = ServeEngine(tmodel, params, ServeConfig(reqtrace=False, **SIZING), device="cpu")
    ids = [(eng.submit(p, max_new_tokens=m), off.submit(p, max_new_tokens=m))
           for p, m in _workload()[:3]]
    eng.drain()
    off.drain()
    assert off.tracer is None and off.report()["phases"] is None
    for a, b in ids:
        assert eng.result(a).tokens == off.result(b).tokens
    assert tel.registry.snapshot()["histograms"]["serve/ttft_s"]["count"] == 3
    eng.reset_metrics()
    hists = tel.registry.snapshot()["histograms"]
    assert all(h["count"] == 0 for k, h in hists.items() if k.startswith("serve/"))
    eng.release(ids[0][0])
    assert eng.tracer.timeline(ids[0][0]) is None


# -- the CLI -----------------------------------------------------------------------


def _main(module, argv):
    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = module.main(argv)
    return rc, out.getvalue(), err.getvalue()


def test_serve_cli_with_every_flag_on_the_cpu(tmp_path, monkeypatch):
    from rocket_tpu_torch.obs import __main__ as obs_cli
    from rocket_tpu_torch.obs import export
    from rocket_tpu_torch.serve import __main__ as serve_cli

    scraped = []
    real_start = export.PrometheusServer.start

    def start_and_scrape(self):
        real_start(self)
        scraped.append(self)

    monkeypatch.setattr(export.PrometheusServer, "start", start_and_scrape)
    out = tmp_path / "run"
    rc, stdout, stderr = _main(serve_cli, [
        "run", "--device", "cpu", "--requests", "6", "--max-new-tokens", "8",
        "--export", "--export-interval", "0.2", "--metrics-port", "0",
        "--slo", "default:serve", "--trace-steps", "2:5", "--out-dir", str(out)])
    assert rc == 0, stderr
    report = json.loads(stdout[stdout.index("{"):])["serve_report"]
    assert report["requests"]["completed"] == 6 and report["phases"]["requests"] == 6
    assert "/metrics on http://" in stderr and scraped
    doc = json.loads((out / "telemetry.json").read_text())
    assert doc["metrics"]["histograms"]["serve/ttft_s"]["count"] == 6
    shards = (out / "telemetry" / "rank0.jsonl").read_text().splitlines()
    assert shards and any("slo" in json.loads(line) for line in shards)
    lines = (out / "telemetry" / "reqtrace.jsonl").read_text().splitlines()
    assert sorted(json.loads(line)["rid"] for line in lines) == list(range(6))
    assert (out / "telemetry" / "exemplars.jsonl").read_text().strip()
    trace = tprof.find_trace_file(str(out / "traces"))
    summary = tprof.parse_trace(tprof.load_trace_events(trace))
    assert [s.step for s in summary.steps] == [2, 3, 4]
    assert tprof.capture_metadata(trace)["platform"] == "cpu"
    rc, text, _ = _main(serve_cli, ["report", str(out)])
    assert rc == 0 and "serve/tokens_generated" in text and "serve/itl_s" in text
    rc, text, _ = _main(obs_cli, ["timeline", str(out), "--slowest", "3"])
    assert rc == 0 and text.count("request ") >= 3 and "aggregate" in text
    rc, text, _ = _main(obs_cli, ["report", str(out)])
    assert rc == 0 and "serve/queue_depth" in text
    # default:serve evaluates over the shards (the CPU's latencies are not
    # the card's, so either verdict is a valid evaluation here).
    rc, text, _ = _main(obs_cli, ["watch", str(out), "--slo", "default:serve"])
    assert rc in (0, 1) and "serve_itl_p99" in text and "serve_ttft_p99" in text


def test_serve_cli_without_reqtrace_and_a_bad_window(tmp_path):
    from rocket_tpu_torch.serve import __main__ as serve_cli

    out = tmp_path / "off"
    rc, _, _ = _main(serve_cli, ["run", "--device", "cpu", "--requests", "2", "--no-reqtrace",
                                 "--out-dir", str(out)])
    assert rc == 0 and (out / "telemetry.json").exists()
    assert not (out / "telemetry" / "reqtrace.jsonl").exists()
    with pytest.raises(SystemExit) as excinfo:
        _main(serve_cli, ["run", "--device", "cpu", "--trace-steps", "3:1",
                          "--out-dir", str(tmp_path / "never")])
    assert excinfo.value.code == 2 and not (tmp_path / "never").exists()
    rc, text, _ = _main(serve_cli, ["report", str(tmp_path / "missing")])
    assert rc == 2


def test_default_serve_loads_with_literal_objectives():
    specs = {s.name: s for s in load_slo_specs("default:serve")}
    assert set(specs) == {"serve_itl_p99", "serve_ttft_p99", "serve_queue_depth"}
    assert specs["serve_queue_depth"].objective == 64
    assert all(s.objective > 0 for s in specs.values())
    with open(default_slo_path("serve")) as f:
        doc = json.load(f)
    assert "H100" in doc["comment"] and "objective_from_budget" not in json.dumps(doc)


def test_a_live_scrape_carries_the_itl_histogram():
    from rocket_tpu_torch.obs.export import ExportConfig

    tmodel = tt.TransformerLM(tt.TransformerConfig(**CFG))
    params = tmodel.init(torch.Generator().manual_seed(2), device="cpu")
    tel = Telemetry(enabled=True)
    tel.start_export(ExportConfig(enabled=False, metrics_port=0))
    try:
        eng = ServeEngine(tmodel, params, ServeConfig(**SIZING), telemetry=tel, device="cpu")
        for p, m in _workload()[:4]:
            eng.submit(p, max_new_tokens=m)
        eng.drain()
        server = tel.exporter.server
        body = urllib.request.urlopen(f"http://127.0.0.1:{server.port}/metrics",
                                      timeout=10).read().decode()
    finally:
        tel.close(write=False)
    count = [line for line in body.splitlines()
             if line.startswith("rocket_tpu_serve_itl_s_count")]
    assert count and float(count[0].split()[-1]) == len(eng._itl)
