"""rocket_tpu_torch.analysis — static checks of the port, on the CPU
(counterpart of ``rocket_tpu/analysis``, its lint and the kernel leg of its
schedule audit).

* :mod:`~rocket_tpu_torch.analysis.rocketlint` — an AST lint over source
  files: host syncs in loops and in capsule ``launch`` bodies, capsule
  lifecycle overrides, ``fork`` after CUDA. CLI: ``python -m
  rocket_tpu_torch.analysis <paths>``.
* :mod:`~rocket_tpu_torch.analysis.sched_audit` — every hand kernel's
  launch (grid, threads, shared memory, operand tiles) collected from a
  step traced on ``meta`` tensors and held to the card (RKT504). CLI:
  ``python -m rocket_tpu_torch.analysis sched``.

Both report :class:`~rocket_tpu_torch.analysis.findings.Finding`\\ s and
honour ``# rocketlint: disable=RKTxxx``. Neither needs a card.
"""

from rocket_tpu_torch.analysis.findings import Finding, emit_findings, parse_suppressions
from rocket_tpu_torch.analysis.rocketlint import lint_file, lint_paths, lint_source
from rocket_tpu_torch.analysis.rules import AST_RULES, SCHED_RULES, all_rules
from rocket_tpu_torch.analysis.sched_audit import (
    SCHED_TARGETS,
    SchedAuditReport,
    audit_schedule,
    collect_launch_facts,
    run_sched_target,
)

__all__ = [
    "Finding", "emit_findings", "parse_suppressions", "lint_file", "lint_paths", "lint_source",
    "AST_RULES", "SCHED_RULES", "all_rules", "SCHED_TARGETS", "SchedAuditReport",
    "audit_schedule", "collect_launch_facts", "run_sched_target",
]
