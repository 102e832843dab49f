"""rocket_tpu_torch.analysis — checks of the port on the CPU and the
calibration that holds them to the card (counterpart of
``rocket_tpu/analysis``: its lint, its schedule audit, its budgets and its
``calib``).

* :mod:`~rocket_tpu_torch.analysis.rocketlint` — an AST lint over source
  files: host syncs in loops and in capsule ``launch`` bodies, capsule
  lifecycle overrides, ``fork`` after CUDA. CLI: ``python -m
  rocket_tpu_torch.analysis <paths>``.
* :mod:`~rocket_tpu_torch.analysis.sched_audit` — a target's step traced
  on ``meta`` tensors: every hand kernel's launch held to the card
  (RKT504), and the step priced as the card by a roofline cost model and a
  two-stream simulation (RKT501-503, RKT505; RKT506 its budgets). CLI:
  ``python -m rocket_tpu_torch.analysis sched``.
* :mod:`~rocket_tpu_torch.analysis.calib` — a measured ``torch.profiler``
  trace of the same step joined to the priced ops and reconciled
  (RKT701-703). CLI: ``python -m rocket_tpu_torch.analysis calib``.
* :mod:`~rocket_tpu_torch.analysis.budgets` — the committed records the
  audits diff against (``tests/fixtures/torch_budgets/``).

Every check reports :class:`~rocket_tpu_torch.analysis.findings.Finding`\\ s
and honours ``# rocketlint: disable=RKTxxx``. Only ``calib`` runs a step
for real, on the card unless its target is the CPU sentinel.
"""

from rocket_tpu_torch.analysis.findings import Finding, emit_findings, parse_suppressions
from rocket_tpu_torch.analysis.rocketlint import lint_file, lint_paths, lint_source
from rocket_tpu_torch.analysis.rules import AST_RULES, CALIB_RULES, SCHED_RULES, all_rules
from rocket_tpu_torch.analysis.sched_audit import (
    SCHED_TARGETS,
    SchedAuditReport,
    audit_schedule,
    collect_launch_facts,
    predict,
    run_sched_target,
    trace_step,
)

__all__ = [
    "Finding", "emit_findings", "parse_suppressions", "lint_file", "lint_paths", "lint_source",
    "AST_RULES", "CALIB_RULES", "SCHED_RULES", "all_rules", "SCHED_TARGETS", "SchedAuditReport",
    "audit_schedule", "collect_launch_facts", "predict", "run_sched_target", "trace_step",
]
