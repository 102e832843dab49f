"""calib — the measuring leg of the roofline loop: a step's measured
device trace reconciled against its priced ops (counterpart of
``rocket_tpu/analysis/calib.py``).

``sched_audit`` predicts a step's per-op costs on the card it prices; this
module measures the same step and joins the two:

1. **price** — :func:`priced_ops_for_target` traces the target's step on
   meta tensors and prices it (``sched_audit.predict``): the as-issued
   simulation's ops and the budget record;
2. **capture** — :func:`capture_target_trace` runs the same step on real
   tensors (the target's device: the card unless the target is the CPU
   sentinel), ``warmup`` untraced and ``steps`` traced, each under a
   ``ProfilerStep#N`` range, through ``obs.prof.TraceSession``;
3. **join** — ``obs.prof.parse_op_trace`` files the device time under the
   op that launched it, named as the priced ops are: ``<aten op>#<k>``,
   the k-th op of that name in the step (a kernel attributed to its aten
   op through the launch's correlation id), a hand kernel by its
   ``LaunchFact`` name and launch ordinal (``flash_fwd#3``), several
   kernels under one op summed. A GEMM joins by its aten op, never by its
   cuBLAS kernel's name. The reference joins by HLO instruction name;
4. **reconcile** — :func:`reconcile` (the reference's, ``:105``): signed
   calibration error per roofline category and of the step, the top
   measured-vs-predicted offenders, join coverage, measured MFU.

The record keeps the reference's keys. RKT701 gates it against
``tests/fixtures/torch_budgets/calib/`` (``analysis/__main__.py``),
RKT702 fails a join under ``join_floor`` and RKT703 an error over
``error_ceiling`` when the measured card is the priced one
(``rules/calib_rules.py``). On the CPU (``gpt2_sentinel``) the device kind
is unknown to the peak tables, so the error measures the mismatch and the
ceiling is skipped, as in the reference; ``chip_smoke.py``'s ``calib``
phase reconciles its ``train`` phase's profiled GPT-2 124M window on the
H100, priced as the H100: matched hardware, so the ceiling gates there.

Targets: ``gpt2_sentinel`` (the audit LM, one rank, SGD, on the CPU) and
``train_flash`` (GPT-2 124M at B=8, T=1024, bf16, remat and AdamW: the
``train`` phase's configuration, on the card). The reference's
``fsdp_1x8`` and ``serve_decode`` targets are ROADMAP Queue A 9's
remainder.
"""

from __future__ import annotations

import os
import tempfile
from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional, Tuple

import torch

from rocket_tpu_torch.analysis.findings import Finding
from rocket_tpu_torch.analysis.rules.calib_rules import check_error_ceiling, check_join_coverage
from rocket_tpu_torch.analysis.sched_audit import DEFAULT_DEVICE_KIND
from rocket_tpu_torch.obs.prof import (
    TraceSession,
    TraceSummary,
    capture_metadata,
    load_trace_events,
    parse_op_trace,
)
from rocket_tpu_torch.utils.perf import device_name, device_spec

__all__ = [
    "CalibTarget", "CalibReport", "CALIB_TARGETS", "reconcile", "priced_ops_for_target",
    "capture_target_trace", "reconcile_trace", "run_calib_target", "render_calib",
]

#: sched_audit OpCost.kind -> measured category vocabulary.
_KIND_TO_CATEGORY = {"comm": "collective", "compute": "compute", "memory": "memory"}


# -- reconcile ---------------------------------------------------------------------------


def _pick_module(summary: TraceSummary, priced_names) -> Optional[str]:
    """The trace module whose ops best cover the priced names
    (time-weighted)."""
    best, best_time = None, -1.0
    for module in summary.modules:
        joined = sum(op.total_us for op in summary.module_ops(module) if op.name in priced_names)
        if joined > best_time:
            best, best_time = module, joined
    return best


def reconcile(summary: TraceSummary, priced_ops, priced_record: Mapping, *,
              module: Optional[str] = None, measured_kind: Optional[str] = None,
              label: str = "calib", top: int = 10) -> Tuple[dict, list]:
    """Join measured per-op durations against the priced ops (the
    reference's, ``:105``): returns ``(record, rows)``, the calibration
    record and the joined rows. ``priced_ops`` is the as-issued
    simulation's ``OpCost`` list, ``priced_record`` its record. Joined ops
    take the priced op's roofline kind as their category; unjoined ones
    keep the parser's. The per-op comparand is the measured mean per
    execution (``total_us / count``: one per step), the headline
    ``measured_step_us`` the per-step device span, the measured analogue
    of the simulated makespan."""
    priced = {op.name: op for op in priced_ops
              if op.kind != "free" and not op.opcode.endswith("-done")}
    if module is None:
        module = _pick_module(summary, set(priced))
    measured = summary.module_ops(module)
    n_steps = max(len(summary.steps), 1)

    rows = []
    joined_us = 0.0
    measured_total_us = sum(op.total_us for op in measured)
    meas_by_cat: dict = {}
    pred_by_cat: dict = {}
    for op in measured:
        priced_op = priced.get(op.name)
        mean_us = op.total_us / op.count if op.count else 0.0
        if priced_op is None:
            meas_by_cat[op.category] = meas_by_cat.get(op.category, 0.0) + mean_us
            continue
        joined_us += op.total_us
        category = _KIND_TO_CATEGORY.get(priced_op.kind, priced_op.kind)
        predicted_us = priced_op.time_s * 1e6
        meas_by_cat[category] = meas_by_cat.get(category, 0.0) + mean_us
        rows.append({
            "name": op.name,
            "category": category,
            "measured_us": round(mean_us, 3),
            "predicted_us": round(predicted_us, 3),
            "executions_per_step": round(op.count / n_steps, 2),
            "error": round((predicted_us - mean_us) / mean_us, 4) if mean_us > 0 else None,
            "where": priced_op.where,
        })
    for priced_op in priced.values():
        category = _KIND_TO_CATEGORY.get(priced_op.kind, priced_op.kind)
        pred_by_cat[category] = pred_by_cat.get(category, 0.0) + priced_op.time_s * 1e6

    categories = {}
    for cat in sorted(set(meas_by_cat) | set(pred_by_cat)):
        meas, pred = meas_by_cat.get(cat, 0.0), pred_by_cat.get(cat, 0.0)
        categories[cat] = {"measured_us": round(meas, 3), "predicted_us": round(pred, 3),
                           "error": round((pred - meas) / meas, 4) if meas > 0 else None}

    measured_step_us = summary.mean("device_span_us")
    predicted_step_us = float(priced_record.get("predicted_step_time_us") or 0.0)
    calib_error = ((predicted_step_us - measured_step_us) / measured_step_us
                   if measured_step_us > 0 else None)
    join_coverage = joined_us / measured_total_us if measured_total_us > 0 else 0.0

    # The kind of the machine that CAPTURED the trace (the sidecar), this
    # process's card only for a fresh capture without one.
    if measured_kind is None:
        measured_kind = device_name()
    spec = device_spec(measured_kind)
    flops = float(priced_record.get("flops_per_step") or 0.0)
    measured_mfu = None
    if spec is not None and measured_step_us > 0 and flops:
        measured_mfu = round(flops / (measured_step_us * 1e-6 * spec.flops_bf16), 4)

    rows.sort(key=lambda r: -abs(r["measured_us"] - r["predicted_us"]))
    record = {
        "module": module or "",
        "n_steps": len(summary.steps),
        "n_measured_ops": len(measured),
        "n_joined_ops": len(rows),
        "measured_step_us": round(measured_step_us, 3),
        "wall_step_us": round(summary.mean("wall_us"), 3),
        "predicted_step_us": round(predicted_step_us, 3),
        "calib_error": round(calib_error, 4) if calib_error is not None else None,
        "abs_calib_error": round(abs(calib_error), 4) if calib_error is not None else None,
        "measured_exposed_comm_us": round(summary.mean("exposed_comm_us"), 3),
        "predicted_exposed_comm_us": float(priced_record.get("exposed_comm_us") or 0.0),
        "measured_mfu": measured_mfu,
        "predicted_mfu": priced_record.get("predicted_mfu"),
        "join_coverage": round(join_coverage, 4),
        "unjoined_fraction": round(1.0 - join_coverage, 4),
        "categories": categories,
        "top_offenders": rows[:top],
        "device_kind_measured": measured_kind,
        "priced_for": priced_record.get("device_kind"),
        "device_matched": spec is not None and spec.kind == priced_record.get("device_kind"),
    }
    return record, rows


# -- targets -----------------------------------------------------------------------------


@dataclass(frozen=True)
class CalibTarget:
    """One calibration pairing: ``build(device) -> (step_fn, args)`` makes
    the step on ``"meta"`` (priced) or a real device (measured), the same
    aten sequence on both; ``device`` is where it measures (the card
    unless the target says the CPU, and never the CPU in the card's stead),
    ``device_kind`` the card it is priced for, ``steps`` traced after
    ``warmup``; ``join_floor`` RKT702's, ``error_ceiling`` RKT703's (None
    disables)."""

    name: str
    build: Callable[[str], tuple]
    device: str = "cuda"
    device_kind: str = DEFAULT_DEVICE_KIND
    steps: int = 4
    warmup: int = 2
    join_floor: float = 0.5
    error_ceiling: Optional[float] = 3.0
    kind: str = "train"
    doc: str = ""
    demo: bool = False


@dataclass
class CalibReport:
    """Findings, the record the budget gate reads and every joined row."""

    label: str
    findings: list = field(default_factory=list)
    record: dict = field(default_factory=dict)
    rows: list = field(default_factory=list)
    summary: Optional[TraceSummary] = None
    trace_file: Optional[str] = None

    @property
    def clean(self) -> bool:
        return not self.findings


def _gpt2_sentinel_parts(device: str):
    """The calibration sentinel: the audit LM every schedule target uses
    (``sched_audit._lm_config``, plain attention), one rank, B=16 T=64, the
    reference's SGD update; small enough to measure on every run."""
    from rocket_tpu_torch.analysis.sched_audit import _lm_config, _train_parts
    from rocket_tpu_torch.models.transformer import TransformerLM, next_token_loss

    model = TransformerLM(_lm_config())
    tokens = torch.zeros((16, 64), dtype=torch.int32, device=device)
    return _train_parts(model, {"tokens": tokens}, loss_fn=next_token_loss(), remat=False,
                        device=device)


def _train_flash_parts(device: str):
    """GPT-2 124M at B=8, T=1024, bf16, remat and AdamW: the ``train``
    phase's step (``sched_audit._gpt2_parts``)."""
    from rocket_tpu_torch.analysis.sched_audit import _gpt2_parts

    return _gpt2_parts(1024, device=device)


CALIB_TARGETS = {target.name: target for target in (
    CalibTarget("gpt2_sentinel", _gpt2_sentinel_parts, device="cpu",
                doc="audit LM train step, B=16 T=64, measured on the CPU"),
    CalibTarget("train_flash", _train_flash_parts, steps=3,
                doc="GPT-2 124M train step, B=8 T=1024, measured on the card"),
)}

#: Where the captures land by default (re-renderable with ``python -m
#: rocket_tpu_torch.obs prof runs/prof/<target> --target <target>``).
DEFAULT_TRACE_ROOT = os.path.join("runs", "prof")


def priced_ops_for_target(target: CalibTarget) -> tuple:
    """Trace the target's step on meta tensors and price it for its card:
    ``(ops, record)``, the as-issued simulation's ``OpCost`` s and the
    budget record."""
    from rocket_tpu_torch.analysis.sched_audit import predict, trace_step

    step_fn, args = target.build("meta")
    tracer = trace_step(step_fn, *args, device_kind=target.device_kind)
    scheduled, _ideal, record = predict(tracer.ops, target.device_kind)
    return scheduled.ops, dict(record, n_launches=len(tracer.launches))


def _measure_device(target: CalibTarget, device: Optional[str]) -> str:
    device = device or target.device
    if torch.device(device).type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"calib: target {target.name!r} measures on the card and no CUDA "
                           "device is present (it does not measure on the CPU instead)")
    return device


def capture_target_trace(target: CalibTarget, trace_dir: str,
                         device: Optional[str] = None) -> Optional[str]:
    """Run ``warmup`` untraced and ``steps`` traced steps of the target on
    ``device`` (default the target's), each traced step under a
    ``ProfilerStep#N`` range, and return the trace file."""
    device = _measure_device(target, device)
    step_fn, args = target.build(device)
    for _ in range(target.warmup):
        step_fn(*args)
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()
    session = TraceSession(trace_dir)
    session.start()
    try:
        for i in range(target.steps):
            with torch.profiler.record_function(f"ProfilerStep#{i}"):
                step_fn(*args)
                if torch.device(device).type == "cuda":
                    # Every step's kernels end inside its own range.
                    torch.cuda.synchronize()  # rocketlint: disable=RKT103
    finally:
        trace_file = session.stop()
    return trace_file


def reconcile_trace(events, ops, priced_record: Mapping, *, label: str,
                    measured_kind: Optional[str], join_floor: float = 0.5,
                    error_ceiling: Optional[float] = 3.0) -> CalibReport:
    """Join a trace's events against priced ``ops`` and check the record:
    RKT702 when no step was annotated or the join falls under
    ``join_floor``, RKT703 when the error passes ``error_ceiling`` on the
    priced card. The one path of the CLI, ``obs prof --target`` and
    ``chip_smoke.py``'s ``calib`` phase."""
    report = CalibReport(label=label)
    names = {op.opcode for op in ops if op.opcode.startswith("aten::")}
    summary = parse_op_trace(events, names, step_name="ProfilerStep")
    if not summary.steps:
        # A gate that measures nothing must fail, not pass vacuously.
        report.findings.append(Finding(
            "RKT702", f"<calib:{label}>", 0,
            "reconcile-join-failure: the capture holds no ProfilerStep#N ranges: the "
            "calibration error cannot be measured"))
        return report
    record, rows = reconcile(summary, ops, priced_record, measured_kind=measured_kind,
                             label=label)
    record.update(target=label, kind="train")
    report.record, report.summary, report.rows = record, summary, rows
    module_us = sum(op.total_us for op in summary.ops)
    report.findings += check_join_coverage(
        record["join_coverage"], join_floor, measured_us=module_us,
        unjoined_us=record["unjoined_fraction"] * module_us, label=label)
    report.findings += check_error_ceiling(record["calib_error"], error_ceiling,
                                           device_matched=record["device_matched"], label=label)
    return report


def _measured_kind(trace_file: str) -> str:
    meta = capture_metadata(trace_file)
    return meta.get("device_kind") or meta.get("platform") or "cpu"


def run_calib_target(target: CalibTarget, trace_root: Optional[str] = None,
                     device: Optional[str] = None) -> CalibReport:
    """Price -> capture -> join -> reconcile for one target. Traces land
    under ``<trace_root>/<target>/`` (default ``runs/prof/``; an
    unwritable root falls back to a temp dir)."""
    trace_dir = os.path.join(trace_root or DEFAULT_TRACE_ROOT, target.name)
    try:
        os.makedirs(trace_dir, exist_ok=True)
    except OSError:
        trace_dir = tempfile.mkdtemp(prefix=f"calib_{target.name}_")
    ops, priced_record = priced_ops_for_target(target)
    trace_file = capture_target_trace(target, trace_dir, device)
    if trace_file is None:
        report = CalibReport(label=target.name)
        report.findings.append(Finding(
            "RKT702", f"<calib:{target.name}>", 0,
            f"reconcile-join-failure: the profiler wrote no trace under {trace_dir}"))
        return report
    report = reconcile_trace(load_trace_events(trace_file), ops, priced_record,
                             label=target.name, measured_kind=_measured_kind(trace_file),
                             join_floor=target.join_floor, error_ceiling=target.error_ceiling)
    report.trace_file = trace_file
    return report


def _fmt(value, spec: str) -> str:
    """A nullable record field, formatted (a record may hold nulls)."""
    if not isinstance(value, (int, float)):
        return str(value)
    return format(value, spec)


def render_calib(record: Mapping) -> str:
    """Human view of one calibration record (the reference's; ``obs prof
    --target`` and ``analysis calib`` share it)."""
    lines = [
        f"calibration [{record.get('target', record.get('module'))}]: measured step "
        f"{_fmt(record.get('measured_step_us'), '.1f')} us vs predicted "
        f"{_fmt(record.get('predicted_step_us'), '.1f')} us -> error "
        f"{_fmt(record.get('calib_error'), '+.3f')} (join coverage "
        f"{_fmt(record.get('join_coverage'), '.1%')}, {record.get('n_steps')} steps)",
        f"  exposed comm: measured {_fmt(record.get('measured_exposed_comm_us'), '.1f')} us vs "
        f"predicted {_fmt(record.get('predicted_exposed_comm_us'), '.1f')} us; measured MFU "
        f"{record.get('measured_mfu')} (predicted {record.get('predicted_mfu')}); priced for "
        f"{record.get('priced_for')}, measured on {record.get('device_kind_measured')} "
        f"(matched={record.get('device_matched')})",
    ]
    categories = record.get("categories") or {}
    if categories:
        lines.append(f"  {'category':<12} {'measured_us':>12} {'predicted_us':>13} {'error':>8}")
        for cat, row in categories.items():
            lines.append(f"  {cat:<12} {row['measured_us']:>12.1f} {row['predicted_us']:>13.1f} "
                         f"{_fmt(row.get('error'), '+.3f'):>8}")
    offenders = record.get("top_offenders") or []
    if offenders:
        lines.append("  top measured-vs-predicted offenders:")
        lines.append(f"  {'op':<36} {'cat':<11} {'meas_us':>9} {'pred_us':>9} {'where'}")
        for row in offenders:
            lines.append(f"  {row['name'][:36]:<36} {row['category']:<11} "
                         f"{row['measured_us']:>9.2f} {row['predicted_us']:>9.2f} "
                         f"{row.get('where', '')}")
    return "\n".join(lines)
