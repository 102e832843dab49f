"""The calibration (``rocket_tpu_torch/analysis/calib.py``, ``rules/
calib_rules.py``, ``obs/prof.parse_op_trace``) against the reference.

* RKT702 and RKT703 (``check_join_coverage``, ``check_error_ceiling``)
  report what the reference's report, with its defaults (join floor 0.5,
  ceiling 3.0);
* ``reconcile`` gives the reference's record on one hand-built summary
  and priced list;
* the join files a CUDA trace's kernels under their launching aten op (the
  outermost one the priced step knows), a hand kernel under its
  ``LaunchFact`` name, per step by ordinal, several kernels of one op
  summed;
* ``calib --target gpt2_sentinel`` measures on the CPU, joins every op,
  reports ``device_matched: false`` with RKT703 skipped, and exits 0
  against the committed ``tests/fixtures/torch_budgets/calib/``;
  ``obs prof <trace> --target gpt2_sentinel`` renders the join; the card
  target refuses to measure on the CPU.

Inputs are drawn from numpy seeds; torch runs on one thread.
"""

from __future__ import annotations

import json

import numpy as np
import pytest
import torch

from rocket_tpu.analysis import calib as ref_calib
from rocket_tpu.analysis.rules import calib_rules as ref_rules
from rocket_tpu.analysis.sched_audit import OpCost as RefOpCost
from rocket_tpu.obs import prof as ref_prof
from rocket_tpu_torch.analysis import __main__ as cli
from rocket_tpu_torch.analysis import calib
from rocket_tpu_torch.analysis.rules import calib_rules
from rocket_tpu_torch.analysis.sched_audit import OpCost
from rocket_tpu_torch.obs import prof
from rocket_tpu_torch.obs.__main__ import main as obs_main

torch.set_num_threads(1)


@pytest.mark.parametrize("seed", range(4))
def test_calib_rules_report_what_the_reference_reports(seed):
    rng = np.random.default_rng(seed)
    for _ in range(25):
        coverage, floor = float(rng.uniform(0, 1)), float(rng.choice([0.0, 0.5, rng.uniform()]))
        measured = float(rng.uniform(0, 1e5))
        port = calib_rules.check_join_coverage(coverage, floor, measured_us=measured,
                                               unjoined_us=(1 - coverage) * measured)
        ref = ref_rules.check_join_coverage(coverage, floor, measured_us=measured,
                                            unjoined_us=(1 - coverage) * measured)
        assert [(f.rule, f.path) for f in port] == [(f.rule, f.path) for f in ref]
        error = float(rng.uniform(-5, 5)) if rng.random() < 0.9 else None
        ceiling = 3.0 if rng.random() < 0.8 else None
        matched = bool(rng.random() < 0.5)
        port = calib_rules.check_error_ceiling(error, ceiling, device_matched=matched)
        ref = ref_rules.check_error_ceiling(error, ceiling, device_matched=matched)
        assert [(f.rule, f.message) for f in port] == [(f.rule, f.message) for f in ref]
    assert [r[0] for r in calib_rules.CALIB_RULES] == [r[0] for r in ref_rules.CALIB_RULES]
    target = calib.CALIB_TARGETS["train_flash"]
    assert (target.join_floor, target.error_ceiling) == (0.5, 3.0)


def _summaries(seed: int):
    """One hand-built measured summary in both packages' types and one
    priced op list in both, sharing most names."""
    rng = np.random.default_rng(seed)
    names = [f"aten::mm#{i}" for i in range(6)] + [f"flash_fwd#{i}" for i in range(3)] + [
        "aten::add#0", "all-reduce#0"]
    kinds = ["compute"] * 6 + ["compute", "memory", "compute", "memory", "comm"]
    priced = [dict(name=n, opcode=n.split("#")[0], kind=k, time_s=float(rng.uniform(1e-6, 1e-3)),
                   flops=float(rng.uniform(0, 1e10)), hbm_bytes=int(rng.integers(1, 1 << 24)),
                   comm_bytes=0, is_comm=k == "comm", operands=())
              for n, k in zip(names, kinds)]
    measured = names[:9] + ["at::native::elementwise_kernel", "nccl_other"]
    ops = [dict(name=n, opcode=n.split("#")[0], category=str(rng.choice(["compute", "memory"])),
                module="", total_us=float(rng.uniform(1, 1e4)), count=3) for n in measured]
    steps = [dict(name="ProfilerStep", step=i, start_us=1e4 * i, end_us=1e4 * (i + 1),
                  wall_us=float(rng.uniform(5e3, 1e4)), device_span_us=float(rng.uniform(1e3, 9e3)),
                  device_busy_us=0.0, exposed_comm_us=float(rng.uniform(0, 10)))
             for i in range(3)]
    port = prof.TraceSummary(ops=[prof.MeasuredOp(**o) for o in ops],
                             steps=[prof.StepRecord(**s) for s in steps], modules={"": 1.0})
    ref = ref_prof.TraceSummary(ops=[ref_prof.MeasuredOp(**o) for o in ops],
                                steps=[ref_prof.StepRecord(**s) for s in steps],
                                modules={"": 1.0})
    return port, ref, [OpCost(**p) for p in priced], [RefOpCost(**p) for p in priced]


@pytest.mark.parametrize("seed", range(3))
@pytest.mark.parametrize("kind", ["NVIDIA H100 80GB HBM3", "cpu"])
def test_reconcile_equals_the_reference(seed, kind):
    port_summary, ref_summary, port_ops, ref_ops = _summaries(seed)
    record = {"predicted_step_time_us": 1234.5, "exposed_comm_us": 3.0, "flops_per_step": 5e12,
              "predicted_mfu": 0.2, "device_kind": "NVIDIA H100"}
    port, port_rows = calib.reconcile(port_summary, port_ops, record, measured_kind=kind)
    ref, ref_rows = ref_calib.reconcile(ref_summary, ref_ops, dict(record), measured_kind=kind)
    assert port_rows == ref_rows
    if kind == "cpu":
        assert port == ref
    else:
        # The reference's peak tables hold no H100: its measured MFU is None
        # and its card unmatched; every other key agrees.
        assert port["device_matched"] and port["measured_mfu"] is not None
        assert {k: v for k, v in port.items() if k not in ("device_matched", "measured_mfu")} \
            == {k: v for k, v in ref.items() if k not in ("device_matched", "measured_mfu")}
    assert port["n_joined_ops"] == 9 and 0 < port["join_coverage"] < 1
    # The reference's committed record's keys, less the two run_calib_target adds.
    with open("tests/fixtures/budgets/calib/gpt2_sentinel.json") as f:
        assert set(port) | {"target", "kind"} == set(json.load(f))


def _cuda_trace() -> list:
    """Two ProfilerStep ranges; in each, aten::linear > aten::addmm launching
    two kernels (a split-K GEMM and its reduce), aten::add launching one,
    and a hand kernel launched under no aten op; the backward's aten::mm on
    another thread; a kernel launched outside every step."""
    events, corr = [], [0]

    def host(name, ts, dur, tid=1, cat="cpu_op"):
        events.append({"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur, "pid": 1,
                       "tid": tid})

    def launch(ts, kernel, dur, tid=1):
        corr[0] += 1
        events.append({"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "ts": ts,
                       "dur": 1, "pid": 1, "tid": tid, "args": {"correlation": corr[0]}})
        events.append({"ph": "X", "cat": "kernel", "name": kernel, "ts": ts + 50, "dur": dur,
                       "pid": 0, "tid": 7, "args": {"correlation": corr[0]}})

    for step in range(2):
        t0 = 1000.0 * step
        host(f"ProfilerStep#{step}", t0, 900, cat="user_annotation")
        host("aten::linear", t0 + 10, 100)
        host("aten::addmm", t0 + 20, 80)
        launch(t0 + 30, "void sm90_xmma_gemm_splitk<bf16>(Params)", 40 + step)
        launch(t0 + 40, "void splitKreduce_kernel<float>(float*)", 5)
        host("aten::add", t0 + 200, 20)
        launch(t0 + 205, "void at::native::vectorized_elementwise_kernel<4>(int)", 7)
        launch(t0 + 300, "void flash_fwd_tc_kernel<__nv_bfloat16, 64>(Args)", 100)
        host("aten::mm", t0 + 400, 50, tid=2)
        launch(t0 + 410, "nvjet_tst_128x64(Args)", 30, tid=2)
    launch(5000.0, "void at::native::vectorized_elementwise_kernel<4>(int)", 9)
    return events


def test_the_join_files_kernels_under_their_launching_op():
    summary = prof.parse_op_trace(_cuda_trace(), {"aten::addmm", "aten::add", "aten::mm"},
                                  step_name="ProfilerStep")
    ops = {op.name: op for op in summary.ops}
    assert set(ops) == {"aten::addmm#0", "aten::add#0", "flash_fwd#0", "aten::mm#0"}
    assert ops["aten::addmm#0"].total_us == (40 + 5) + (41 + 5)  # split-K and reduce summed
    assert ops["aten::addmm#0"].count == 2 and ops["flash_fwd#0"].total_us == 200
    assert len(summary.steps) == 2 and summary.unattributed_us == 9
    assert summary.steps[0].device_span_us == 490 - 80   # the GEMM's start to aten::mm's end


def test_the_sentinel_calibrates_on_the_cpu_against_the_committed_budget(tmp_path, capsys):
    root = str(tmp_path / "prof")
    assert cli.main(["calib", "--target", "gpt2_sentinel", "--trace-root", root]) == 0
    report = calib.run_calib_target(calib.CALIB_TARGETS["gpt2_sentinel"], trace_root=root)
    record = report.record
    assert report.clean and record["device_kind_measured"] == "cpu"
    assert record["device_matched"] is False and record["measured_mfu"] is None
    assert record["join_coverage"] == 1.0 and record["n_steps"] == 4
    assert -1.0 < record["calib_error"] < 0 and record["priced_for"] == "NVIDIA H100"
    # The CPU ran the priced op sequence exactly: every op joins.
    assert record["n_joined_ops"] == record["n_measured_ops"] > 100
    capsys.readouterr()
    assert obs_main(["prof", str(tmp_path / "prof" / "gpt2_sentinel"), "--target",
                     "gpt2_sentinel"]) == 0
    out = capsys.readouterr().out
    assert "calibration [gpt2_sentinel]" in out and "matched=False" in out
    assert obs_main(["prof", report.trace_file, "--target", "gpt2_sentinel", "--format",
                     "json"]) == 0
    assert json.loads(capsys.readouterr().out)["calib"]["join_coverage"] == 1.0


def test_the_card_target_never_measures_on_the_cpu(tmp_path):
    target = calib.CALIB_TARGETS["train_flash"]
    assert target.device == "cuda" and target.steps == 3
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="does not measure on the CPU"):
        calib.capture_target_trace(target, str(tmp_path))
    with pytest.raises(SystemExit) as err:
        cli.main(["calib", "--target", "train_flash", "--no-budgets"])
    assert err.value.code == 2
    # Its priced step is GPT-2 124M's train step priced as the H100.
    ops, record = calib.priced_ops_for_target(target)
    assert record["device_kind"] == "NVIDIA H100" and record["n_launches"] == 36
    assert sum(op.opcode == "flash_fwd" for op in ops) == 24
