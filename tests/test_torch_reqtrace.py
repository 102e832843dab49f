"""The port's request tracer against the reference's: the same synthetic
event script (synthetic clocks, an eviction and resume, a trace-step id on
some waves, an event cap small enough to compact, a live request, a
release) fed to ``rocket_tpu.obs.reqtrace.RequestTracer`` and to the
port's gives equal timelines, phases, aggregates, flushed JSONL files
(byte for byte), exemplar windows and renders; and each package's ``obs
timeline`` renders the other's run dir exactly as its own.

Both tracers are stdlib-only; ``time.time`` (the records' ``t_unix``) is
pinned so the files compare byte for byte.
"""

import contextlib
import io
import time

import pytest

from rocket_tpu.obs import reqtrace as jrq
from rocket_tpu_torch.obs import reqtrace as trq


def _script(tracer):
    """Drive a tracer through three requests; returns the live rid."""
    tracer.on_submit(0, 10.0, prompt_len=5, max_new_tokens=12)
    tracer.on_submit(1, 10.25, prompt_len=3, max_new_tokens=9)
    tracer.on_submit(2, 10.5, prompt_len=7, max_new_tokens=4)
    tracer.on_admit(0, 11.0, 0, ctx_len=5)
    tracer.on_prefill(0, 11.125, 0, 4)
    tracer.on_admit(1, 11.25, 1, ctx_len=3)
    tracer.on_prefill(1, 11.375, 0, 2)
    t = 11.5
    for wave in range(14):
        tracer.trace_step = wave if 4 <= wave < 8 else None
        seq = tracer.on_dispatch(2 if wave < 6 else 1, t, waves=1)
        t += 0.0625
        tracer.on_harvest(seq, t)
        tracer.on_tokens(0, seq, 1, t)
        if wave < 6:
            tracer.on_tokens(1, seq, 1, t)
        if wave == 5:
            tracer.on_evict(1, t + 0.015625)
        if wave == 9:
            tracer.on_admit(1, t + 0.03125, 1, ctx_len=9, resumed=True)
            tracer.on_prefill(1, t + 0.046875, 0, 8)
        if wave >= 10:
            tracer.on_tokens(1, seq, 2, t)
        t += 0.0625
    tracer.trace_step = None
    tracer.on_finish(0, t)
    tracer.on_finish(1, t + 0.125)
    tracer.on_detokenize(0, t + 0.25)
    tracer.on_admit(2, t + 0.5, 0, ctx_len=7)
    tracer.on_prefill(2, t + 0.625, 0, 6)
    seq = tracer.on_dispatch(1, t + 0.75)
    tracer.on_harvest(seq, t + 1.0)
    tracer.on_tokens(2, seq, 1, t + 1.0)
    tracer.on_tokens(99, seq, 1, t + 1.0)  # unknown request: ignored
    return 2


@pytest.fixture
def pinned(monkeypatch):
    monkeypatch.setattr(time, "time", lambda: 1_700_000_000.5)


def _pair(max_events=8):
    return (jrq.RequestTracer(max_events=max_events, exemplar_k=2),
            trq.RequestTracer(max_events=max_events, exemplar_k=2))


def test_constants_match():
    for name in ("REQTRACE_FILE", "EXEMPLARS_FILE", "TIMELINE_VERSION"):
        assert getattr(trq, name) == getattr(jrq, name)
    assert trq._PHASE_CHARS == jrq._PHASE_CHARS and trq._COALESCIBLE == jrq._COALESCIBLE


@pytest.mark.parametrize("max_events", [8, 256])
def test_timelines_phases_and_aggregates_are_equal(pinned, max_events):
    want, got = _pair(max_events)
    live = _script(want)
    assert _script(got) == live
    for rid in (0, 1, live, 5):
        assert got.timeline(rid) == want.timeline(rid), rid
        assert got.phases(rid) == want.phases(rid), rid
    assert got.aggregate() == want.aggregate()
    assert got.finished_total == want.finished_total == 2
    finished = got.timeline(0)
    assert finished["final"] and not got.timeline(live)["final"]
    if max_events == 8:
        # The cap compacted wave runs into spans; the phases still hold.
        assert any(ev["ev"] == "wave_span" for ev in finished["events"])
        # The cap, and the detokenize stamp appended to the finished record.
        assert len(finished["events"]) <= 8 + 1 and finished["events"][-1]["ev"] == "detok"
    phases = finished["phases"]
    assert sum(phases.values()) == pytest.approx(finished["total_s"], abs=1e-5)
    evicted = got.timeline(1)
    assert evicted["preemptions"] == 1 and evicted["phases"]["preempted_s"] > 0
    steps = [ev.get("step") for ev in evicted["events"] if ev["ev"] == "wave"]
    assert max_events == 8 or steps[4:6] == [4, 5]


def test_compact_events_is_the_references():
    events = [{"ev": "submit", "t": 0.0}, {"ev": "admit", "t": 0.1}]
    events += [{"ev": "prefill", "t": 0.2 + i / 100, "n": 4} for i in range(3)]
    events += [{"ev": "wave", "t": 0.5 + i / 10, "n": 1, "seq": i, "occ": 1 + i % 3}
               for i in range(5)]
    events += [{"ev": "evict", "t": 1.5}, {"ev": "wave", "t": 2.0, "n": 2, "seq": 9}]
    assert trq._compact_events(events) == jrq._compact_events(events)


def test_flush_writes_the_same_files(pinned, tmp_path):
    want, got = _pair()
    _script(want)
    _script(got)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    assert got.flush(str(tdir)) == want.flush(str(jdir))
    assert got.last_window == want.last_window
    assert got.last_window["ttft"] and got.last_window["itl_gap"]
    for name in (trq.REQTRACE_FILE, trq.EXEMPLARS_FILE):
        assert (tdir / "telemetry" / name).read_bytes() == (jdir / "telemetry" / name).read_bytes()
    assert (tdir / "telemetry" / trq.EXEMPLARS_FILE).read_text().strip()
    # A second window with nothing new appends nothing and empties the picks.
    assert got.flush(str(tdir)) == want.flush(str(jdir))
    assert got.last_window == {"ttft": [], "itl_gap": []}
    # release drops both retained copies.
    got.release(0)
    want.release(0)
    assert got.timeline(0) is None and got.aggregate() == want.aggregate()


def test_readers_and_renders_are_equal(pinned, tmp_path):
    want, got = _pair()
    _script(want)
    _script(got)
    got.flush(str(tmp_path))
    records = trq.read_timeline_dir(str(tmp_path))
    assert records == jrq.read_timeline_dir(str(tmp_path))
    assert [r["rid"] for r in records] == [0, 1]
    assert records[0]["exemplar_by"]
    for record in records:
        assert trq.timeline_segments(record) == jrq.timeline_segments(record)
        for width in (60, 23):
            assert trq.render_waterfall(record, width) == jrq.render_waterfall(record, width)
    assert trq.render_aggregate(records) == jrq.render_aggregate(records)
    assert trq.aggregate_phases(records) == jrq.aggregate_phases(records)
    assert trq.render_aggregate([]) == jrq.render_aggregate([])
    assert trq.aggregate_phases([]) is None


def _cli(main, argv):
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.mark.parametrize("argv", [["--slowest", "3"], ["--request", "1"],
                                  ["--format", "json"]])
def test_each_obs_timeline_renders_the_others_run_dir_alike(pinned, tmp_path, argv):
    from rocket_tpu.obs.__main__ import main as jmain
    from rocket_tpu_torch.obs.__main__ import main as tmain

    want, got = _pair()
    _script(want)
    _script(got)
    want.flush(str(tmp_path / "jax"))
    got.flush(str(tmp_path / "port"))
    renders = {(pkg, run): _cli(main, ["timeline", str(tmp_path / run), *argv])
               for pkg, main in (("jax", jmain), ("port", tmain)) for run in ("jax", "port")}
    first = renders[("jax", "jax")]
    assert first[0] == 0 and first[1]
    assert all(r == first for r in renders.values()), renders


def test_obs_timeline_exits_two_without_timelines(tmp_path):
    from rocket_tpu_torch.obs.__main__ import main as tmain

    assert tmain(["timeline", str(tmp_path)]) == 2
    got = trq.RequestTracer()
    _script(got)
    got.flush(str(tmp_path))
    assert tmain(["timeline", str(tmp_path), "--request", "42"]) == 2
