"""The measured half of the trace loop: the port's ``obs/prof.py`` against
the reference's, and its torch-trace parser against hand-computed answers.

* ``prof_record``, ``publish_prof`` and ``render_prof`` of the same
  hand-built ``TraceSummary`` (each package's dataclasses) are equal, and
  the interval math (``_merge``, ``_union_length``, ``_uncovered``) gives
  the reference's numbers on the same random intervals;
* ``parse_trace`` of a synthetic trace in torch's Chrome format files each
  device slice under the step whose host range launched it, joined by
  correlation id: a wave's kernels that run after the next step's range
  opened stay with their own step. Categories follow the table in the
  module, and exposed communication is collective time no compute slice
  covers;
* the reference's fixture capture (``tests/fixtures/prof/``), rewritten
  into torch's format with the same ``ts``/``dur`` (each slice launched
  at its midpoint, the reference's attribution rule), gives the same
  per-step spans, busy times and op totals;
* ``load_trace_events`` and ``obs prof`` exit 2 on garbage; ``--target``
  reconciles (RKT702 on a trace without ProfilerStep ranges);
* the Profiler capsule publishes ``obs/prof/*`` from a CPU window.
"""

import contextlib
import gzip
import io
import json
import os
import random
from pathlib import Path

import numpy as np
import pytest
import torch

from rocket_tpu.obs import prof as jprof
from rocket_tpu.obs.registry import MetricsRegistry as JRegistry
from rocket_tpu_torch.obs import prof as tprof
from rocket_tpu_torch.obs.registry import MetricsRegistry as TRegistry

torch.set_num_threads(1)
ROOT = Path(__file__).resolve().parents[1]
FIXTURE = ROOT / "tests" / "fixtures" / "prof" / "perfetto_trace.json.gz"


def _summary(mod):
    ops = [mod.MeasuredOp("paged_split_kernel", "paged_split_kernel", "compute", "paged_decode",
                          1234.5, 24),
           mod.MeasuredOp("at::native::vectorized_elementwise_kernel", "x", "memory", "", 300.25,
                          96),
           mod.MeasuredOp("ncclDevKernel_AllReduce", "y", "collective", "", 80.0, 2),
           mod.MeasuredOp("Memcpy HtoD (Pageable -> Device)", "z", "memory", "", 12.0, 3)]
    steps = [mod.StepRecord("serve_tick", 4, 0.0, 900.0, wall_us=900.0, device_span_us=850.5,
                            device_busy_us=800.25, exposed_comm_us=20.0,
                            categories={"compute": 600.0, "memory": 180.0}),
             mod.StepRecord("serve_tick", 5, 900.0, 1800.0, wall_us=910.0, device_span_us=700.0,
                            device_busy_us=650.0, exposed_comm_us=0.0)]
    return mod.TraceSummary(ops=ops, steps=steps, modules={"paged_decode": 1234.5, "": 392.25},
                            n_slices=125, unattributed_us=7.5)


@pytest.mark.parametrize("top", [2, 10])
def test_record_publish_and_render_match_the_reference(top):
    got, want = _summary(tprof), _summary(jprof)
    assert tprof.prof_record(got, top=top) == jprof.prof_record(want, top=top)
    record = tprof.prof_record(got, top=top)
    treg, jreg = TRegistry(), JRegistry()
    tprof.publish_prof(treg, record)
    jprof.publish_prof(jreg, record)
    assert treg.snapshot() == jreg.snapshot()
    assert treg.snapshot()["counters"]["obs/prof/windows_parsed"] == 1
    assert tprof.render_prof(got, top=top) == jprof.render_prof(want, top=top)
    assert tprof.render_prof(got, record) == jprof.render_prof(want, record)
    empty_t = tprof.TraceSummary(ops=[], steps=[], modules={})
    empty_j = jprof.TraceSummary(ops=[], steps=[], modules={})
    assert tprof.prof_record(empty_t) == jprof.prof_record(empty_j)
    assert tprof.render_prof(empty_t) == jprof.render_prof(empty_j)


def test_interval_math_matches_the_reference():
    rng = random.Random(0)
    for _ in range(200):
        def draw():
            out = []
            for _ in range(rng.randint(0, 8)):
                lo = rng.uniform(0, 100)
                out.append((lo, lo + rng.uniform(0, 30)))
            return out

        a, b = draw(), draw()
        assert tprof._merge(a) == jprof._merge(a)
        assert tprof._union_length(a) == jprof._union_length(a)
        assert tprof._uncovered(a, b) == jprof._uncovered(a, b)


def test_policy_and_step_window_are_the_references():
    for text in (None, "", "0", "1", "on", "3:9", "2@10"):
        assert tprof.ProfPolicy.from_env(text) == (
            None if jprof.ProfPolicy.from_env(text) is None
            else tprof.ProfPolicy(**vars(jprof.ProfPolicy.from_env(text))))
    assert tprof.parse_step_window("4:8") == jprof.parse_step_window("4:8") == (4, 8)
    for bad in ("3:1", "x", "4:4"):
        with pytest.raises(ValueError):
            tprof.parse_step_window(bad)


# -- torch-format traces ---------------------------------------------------------


def _host(name, ts, dur, cat="user_annotation"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 1, "tid": 1, "ts": ts, "dur": dur,
            "args": {}}


def _launch(corr, ts, name="cudaLaunchKernel"):
    return {"ph": "X", "cat": "cuda_runtime", "name": name, "pid": 1, "tid": 1, "ts": ts,
            "dur": 2.0, "args": {"correlation": corr}}


def _kernel(name, corr, ts, dur, cat="kernel"):
    return {"ph": "X", "cat": cat, "name": name, "pid": 0, "tid": 7, "ts": ts, "dur": dur,
            "args": {"correlation": corr, "device": 0, "stream": 7}}


PAGED = "void paged_split_kernel<__nv_bfloat16, 64>(PagedArgs)"
COMBINE = "void paged_combine_kernel<__nv_bfloat16>(CombineArgs)"
GEMM = "sm90_xmma_gemm_bf16bf16_bf16f32_f32_tn_n_tilesize128x128x64_cublas"
ELEM = ("void at::native::vectorized_elementwise_kernel<4, at::native::AUnaryFunctor<float, "
        "float, float, at::native::binary_internal::MulFunctor<float> >, std::array<char*, "
        "2ul> >(int, at::native::AUnaryFunctor<float>, std::array<char*, 2ul>)")


def _pipelined_trace():
    """Two serve ticks, each launching a wave that runs mostly after the
    next tick's host range opened (the dispatch-then-harvest pipeline)."""
    return [
        _host("serve_tick#4", 0.0, 100.0), _host("serve_tick#5", 100.0, 100.0),
        _host("aten::mm", 10.0, 5.0, cat="cpu_op"),
        _launch(1, 20.0), _launch(2, 30.0), _launch(3, 40.0, "cuLaunchKernel"),
        _launch(4, 120.0), _launch(5, 130.0),
        _launch(6, 300.0, "cudaMemcpyAsync"),              # outside both ticks
        _kernel(PAGED, 1, 90.0, 30.0),                     # ends in tick 5's range
        _kernel(COMBINE, 2, 120.0, 10.0),                  # starts in tick 5's range
        _kernel(GEMM, 3, 130.0, 20.0),
        _kernel(PAGED, 4, 160.0, 30.0),                    # runs after tick 5's range
        _kernel("ncclDevKernel_AllReduce_Sum_f32_RING_LL(ncclDevComm*)", 5, 180.0, 40.0),
        _kernel("Memcpy DtoH (Device -> Pageable)", 6, 305.0, 4.0, cat="gpu_memcpy"),
        _kernel(ELEM, 7, 400.0, 3.0),                      # no launch event
        _host("serve_tick#5", 110.0, 5.0, cat="gpu_user_annotation"),
    ]


def test_steps_are_joined_by_correlation_not_by_timestamp():
    summary = tprof.parse_trace(_pipelined_trace())
    assert [(s.name, s.step) for s in summary.steps] == [("serve_tick", 4), ("serve_tick", 5)]
    tick4, tick5 = summary.steps
    # Tick 4 launched paged_split (90-120), combine (120-130) and the GEMM
    # (130-150): all three are its own, though they run in tick 5's range.
    assert tick4.categories == {"compute": 60.0}
    assert (tick4.device_span_us, tick4.device_busy_us) == (60.0, 60.0)
    # Tick 5: paged_split (160-190) and the all-reduce (180-220), whose
    # first 10 us the kernel covers.
    assert tick5.categories == {"compute": 30.0, "collective": 40.0}
    assert (tick5.device_span_us, tick5.device_busy_us) == (60.0, 60.0)
    assert tick5.exposed_comm_us == 30.0 and tick4.exposed_comm_us == 0.0
    assert (tick4.wall_us, tick5.wall_us) == (100.0, 100.0)
    # The copy launched outside both ticks and the kernel with no launch.
    assert summary.unattributed_us == 7.0 and summary.n_slices == 7
    assert summary.step_launches("paged_decode") == 2 and summary.step_launches("flash_fwd") == 0
    assert tick4.kernels == {"paged_split_kernel": 1, "paged_combine_kernel": 1, GEMM: 1}
    by_name = {op.name: op for op in summary.ops}
    assert by_name["paged_split_kernel"].count == 2
    assert by_name["paged_split_kernel"].module == "paged_decode"
    assert by_name["at::native::vectorized_elementwise_kernel"].category == "memory"
    assert summary.device_total_us == 137.0
    # A timestamp join would file the combine and the GEMM under tick 5.
    record = tprof.prof_record(summary)
    assert record["n_steps"] == 2 and record["exposed_comm_us"] == 15.0
    assert record["categories_us"] == {"collective": 40.0, "compute": 90.0, "memory": 7.0}
    only = tprof.parse_trace(_pipelined_trace() + [_host("ProfilerStep#1", 0.0, 400.0)],
                             step_name="ProfilerStep")
    assert [s.step for s in only.steps] == [1] and only.unattributed_us == 3.0


@pytest.mark.parametrize("name,cat,want", [
    (PAGED, "kernel", "compute"), (COMBINE, "kernel", "compute"),
    ("nvjet_tst_64x8_64x16_4x1_v_bz_NNT", "kernel", "compute"),
    ("void flash_fwd_tc_kernel<64, true>(FlashArgs)", "kernel", "compute"),
    ("grouped_wgmma_kernel", "kernel", "compute"), (GEMM, "kernel", "compute"),
    ("void cutlass::Kernel2<cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_32x32_128x2_nn_align8>"
     "(cutlass_80_wmma_tensorop_bf16_s161616gemm_bf16_32x32_128x2_nn_align8::Params)",
     "kernel", "compute"),
    ("void cudnn::cnn::conv2d_grouped_direct_kernel<float>(int)", "kernel", "compute"),
    ("ncclDevKernel_AllGather_RING_LL(ncclDevComm*)", "kernel", "collective"),
    (ELEM, "kernel", "memory"),
    ("void at::native::reduce_kernel<512, 1, at::native::ReduceOp<float> >(float)", "kernel",
     "memory"),
    ("void at::native::(anonymous namespace)::CatArrayBatchedCopy<int>(int)", "kernel",
     "memory"),
    ("Memcpy HtoD (Pageable -> Device)", "gpu_memcpy", "memory"),
    ("Memset (Device)", "gpu_memset", "memory"),
    ("void at::native::softmax_warp_forward<float>(float*)", "kernel", "other"),
])
def test_categories_follow_the_documented_table(name, cat, want):
    assert tprof.categorize(name, cat) == want


def test_canonical_names():
    assert tprof.canonical_op_name(PAGED) == "paged_split_kernel"
    assert tprof.canonical_op_name(ELEM) == "at::native::vectorized_elementwise_kernel"
    assert tprof.canonical_op_name(
        "void at::native::(anonymous namespace)::CatArrayBatchedCopy<int, 4>(int)") == \
        "at::native::CatArrayBatchedCopy"
    assert tprof.canonical_op_name(
        "void cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_nn_align4>(Params)") == \
        "cutlass::Kernel2<cutlass_80_tensorop_s1688gemm_64x64_nn_align4>"
    assert tprof.canonical_op_name(GEMM) == GEMM
    assert tprof.opcode_of("at::native::vectorized_elementwise_kernel") == \
        "vectorized_elementwise_kernel"


def _torch_form(events):
    """The reference fixture in torch's format: each step annotation a
    ``ProfilerStep#N`` host range, each device slice a kernel launched at
    its midpoint (where the reference files it), same ts and dur."""
    out, corr = [], 0
    for ev in events:
        if ev.get("ph") != "X":
            continue
        args = ev.get("args") or {}
        if "step_num" in args and "hlo_op" not in args:
            if ev.get("name") == "train":
                out.append(_host(f"ProfilerStep#{int(args['step_num'])}", ev["ts"], ev["dur"]))
        elif ("hlo_op" in args or "hlo_category" in args) and ev.get("dur", 0) > 0:
            corr += 1
            out.append(_launch(corr, ev["ts"] + ev["dur"] / 2))
            out.append(_kernel(jprof.canonical_op_name(args.get("hlo_op") or ev["name"]), corr,
                               ev["ts"], ev["dur"]))
    return out


def test_the_reference_fixture_gives_the_same_step_spans():
    events = jprof.load_trace_events(str(FIXTURE))
    want = jprof.parse_trace(events, step_name="train")
    got = tprof.parse_trace(_torch_form(events))
    assert len(got.steps) == len(want.steps) == 3
    for g, w in zip(got.steps, want.steps):
        assert g.step == w.step
        for field in ("start_us", "end_us", "wall_us", "device_span_us", "device_busy_us",
                      "exposed_comm_us"):
            assert getattr(g, field) == pytest.approx(getattr(w, field), abs=1e-6), field
    assert got.n_slices == want.n_slices
    assert got.unattributed_us == pytest.approx(want.unattributed_us, abs=1e-6)
    assert got.device_total_us == pytest.approx(want.device_total_us, abs=1e-6)
    assert sorted((op.name, op.count) for op in got.ops) == sorted(
        (op.name, op.count) for op in want.ops)


# -- files and the CLI ---------------------------------------------------------------


def test_load_trace_events_plain_gz_and_garbage(tmp_path):
    events = _pipelined_trace()
    plain = tmp_path / "a.trace.json"
    plain.write_text(json.dumps({"traceEvents": events}))
    gz = tmp_path / "b.trace.json.gz"
    with gzip.open(gz, "wt") as f:
        json.dump(events, f)
    assert tprof.load_trace_events(str(plain)) == tprof.load_trace_events(str(gz)) == events
    bad = tmp_path / "x.json"
    bad.write_text('{"notTraceEvents": 3}')
    with pytest.raises(ValueError):
        tprof.load_trace_events(str(bad))
    worse = tmp_path / "y.json.gz"
    with gzip.open(worse, "wt") as f:
        f.write("not json")
    with pytest.raises(ValueError):
        tprof.load_trace_events(str(worse))
    assert tprof.find_trace_file(str(tmp_path / "nothing")) is None
    sub = tmp_path / "cap"
    sub.mkdir()
    (sub / "window_0.trace.json").write_text(json.dumps(events))
    assert tprof.find_trace_file(str(sub)) == str(sub / "window_0.trace.json")
    (sub / "capture.json").write_text(json.dumps({"device_kind": "NVIDIA H100 80GB HBM3"}))
    assert tprof.capture_metadata(str(sub / "window_0.trace.json"))["device_kind"]
    assert tprof.capture_metadata(str(tmp_path)) == {}


def _obs(*argv):
    from rocket_tpu_torch.obs.__main__ import main

    out, err = io.StringIO(), io.StringIO()
    with contextlib.redirect_stdout(out), contextlib.redirect_stderr(err):
        rc = main(list(argv))
    return rc, out.getvalue(), err.getvalue()


def test_obs_prof_renders_and_exits_two_on_garbage(tmp_path):
    trace = tmp_path / "window_0.trace.json"
    trace.write_text(json.dumps({"traceEvents": _pipelined_trace()}))
    rc, out, _ = _obs("prof", str(tmp_path))
    assert rc == 0 and "paged_split_kernel" in out and "2 annotated step(s)" in out
    rc, out, _ = _obs("prof", str(trace), "--format", "json")
    record = json.loads(out)
    assert rc == 0 and record["n_steps"] == 2 and record["trace_file"] == str(trace)
    assert {op["name"] for op in record["top_ops"] if op["category"] == "compute"} >= {
        "paged_split_kernel", "paged_combine_kernel"}
    bad = tmp_path / "bad.json"
    bad.write_text("garbage")
    assert _obs("prof", str(bad))[0] == 2
    assert _obs("prof", str(tmp_path / "missing"))[0] == 2
    hostonly = tmp_path / "host.json"
    hostonly.write_text(json.dumps([_host("serve_tick#0", 0.0, 1.0)]))
    assert _obs("prof", str(hostonly))[0] == 2
    # --target reconciles against the calibration target's priced step; this
    # trace has no ProfilerStep ranges, so the join reports RKT702.
    rc, out, _ = _obs("prof", str(trace), "--target", "gpt2_sentinel")
    assert rc == 0 and "RKT702" in out and "paged_split_kernel" in out
    assert _obs("prof", str(trace), "--target", "nope")[0] == 2


def test_report_renders_the_prof_gauges_as_the_reference():
    from rocket_tpu.obs.__main__ import _render_prof_gauges
    from rocket_tpu_torch.obs.__main__ import render_prof_gauges

    registry = TRegistry()
    tprof.publish_prof(registry, tprof.prof_record(tprof.parse_trace(_pipelined_trace())))
    metrics = registry.snapshot()
    assert render_prof_gauges(metrics) == _render_prof_gauges(metrics)
    assert "device span" in render_prof_gauges(metrics)
    assert render_prof_gauges({"gauges": {}}) == ""


def test_trace_session_on_the_cpu_writes_a_trace_and_its_sidecar(tmp_path):
    session = tprof.TraceSession(str(tmp_path / "tr"))
    assert session.start() and not session.start()
    with torch.profiler.record_function("serve_tick#0"):
        torch.ones(4).sum()
    path = session.stop()
    assert session.stop() is None and path.endswith("window_0.trace.json")
    assert tprof.find_trace_file(str(tmp_path / "tr")) == path
    summary = tprof.parse_trace(tprof.load_trace_events(path))
    assert [s.step for s in summary.steps] == [0] and summary.n_slices == 0
    assert tprof.capture_metadata(path)["platform"] == "cpu"


def test_profiler_capsule_publishes_obs_prof_from_a_cpu_window(tmp_path, monkeypatch):
    import rocket_tpu_torch as rt
    from rocket_tpu_torch import optim as toptim
    from rocket_tpu_torch.models.mlp import MLP

    monkeypatch.setenv("ROCKET_TPU_PROF", "2:5")
    monkeypatch.chdir(tmp_path)
    rng = np.random.default_rng(0)
    data = [{"image": rng.normal(size=8).astype(np.float32), "label": np.int32(i % 4)}
            for i in range(64)]
    runtime = rt.Runtime(device="cpu", seed=0, project_dir=str(tmp_path), telemetry=True)
    model = MLP(in_features=8, num_classes=4, hidden=(16,))
    profiler = rt.Profiler(trace_dir=str(tmp_path / "traces"))
    module = rt.Module(model, [rt.Loss(lambda b: torch.nn.functional.cross_entropy(
        b["logits"], b["label"].long())), rt.Optimizer(toptim.adam(), learning_rate=1e-2)])
    rt.Launcher([rt.Looper([rt.Dataset(data, batch_size=8, device_cache=False), module,
                            profiler], tag="train", progress=False)],
                num_epochs=1, runtime=runtime).launch()
    assert len(profiler.trace_files) == 1
    summary = tprof.parse_trace(tprof.load_trace_events(profiler.trace_files[0]))
    assert [s.step for s in summary.steps] == [2, 3, 4]
    scalars = runtime.telemetry.registry.snapshot()
    assert scalars["gauges"]["obs/prof/n_steps"] == 3
    assert scalars["counters"]["obs/prof/windows_parsed"] == 1
    assert os.path.exists(profiler.trace_files[0])
