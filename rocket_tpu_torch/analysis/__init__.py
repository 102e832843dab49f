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
* :mod:`~rocket_tpu_torch.analysis.trace_audit` — a step function run on
  meta tensors and audited: its in-place update, host reads, Python
  scalars, wide dtypes, retraces (RKT201-206). Library entry
  :func:`audit_step`.
* :mod:`~rocket_tpu_torch.analysis.shard_audit` — a rule set's placement
  and the collectives one rank's step issues under it (RKT301-306). CLI:
  ``python -m rocket_tpu_torch.analysis shard``.
* :mod:`~rocket_tpu_torch.analysis.mem_audit` — the liveness of an eager
  step on meta tensors: its peak and split, the in-place update, the
  saved set, the out-of-memory frontier, and on the card its
  reconciliation with the allocator (RKT801-805). CLI: ``python -m
  rocket_tpu_torch.analysis mem``.
* :mod:`~rocket_tpu_torch.analysis.prec_audit` — the dtype flow of a step
  on meta tensors: accumulation dtypes (cuBLAS's reduction flag and each
  hand kernel's declared accumulator included), transcendentals, narrowed
  state and collectives, cast churn, params cast at use (RKT401-406). CLI:
  ``python -m rocket_tpu_torch.analysis prec``.
* :mod:`~rocket_tpu_torch.analysis.repro_audit` — key discipline, the
  order-free sums a step runs on the card, resume and decode-wave
  identity, and the replay sentinel run twice on the CPU (RKT901-906).
  CLI: ``python -m rocket_tpu_torch.analysis repro``.
* :mod:`~rocket_tpu_torch.analysis.budgets` — the committed records the
  audits diff against (``tests/fixtures/torch_budgets/``).

Every check reports :class:`~rocket_tpu_torch.analysis.findings.Finding`\\ s
and honours ``# rocketlint: disable=RKTxxx``. Only ``calib`` and the
``repro`` sentinel run a step for real, the sentinel on the CPU.
"""

from rocket_tpu_torch.analysis.findings import Finding, emit_findings, parse_suppressions
from rocket_tpu_torch.analysis.rocketlint import lint_file, lint_paths, lint_source
from rocket_tpu_torch.analysis.mem_audit import MemAuditReport, audit_memory, simulate_liveness
from rocket_tpu_torch.analysis.prec_audit import (
    PREC_TARGETS,
    PrecAuditReport,
    audit_precision,
    certify_collectives,
    collect_dtype_flow,
    run_prec_target,
)
from rocket_tpu_torch.analysis.repro_audit import (
    REPRO_TARGETS,
    ReproAuditReport,
    audit_serve_repro,
    audit_train_repro,
    run_replay_sentinel,
    run_repro_target,
)
from rocket_tpu_torch.analysis.rules import (
    AST_RULES,
    AUDIT_RULES,
    CALIB_RULES,
    MEM_RULES,
    PREC_RULES,
    REPRO_RULES,
    SCHED_RULES,
    SPMD_RULES,
    all_rules,
)
from rocket_tpu_torch.analysis.sched_audit import (
    SCHED_TARGETS,
    SchedAuditReport,
    audit_schedule,
    collect_launch_facts,
    predict,
    run_sched_target,
    trace_step,
)
from rocket_tpu_torch.analysis.shard_audit import ShardAuditReport, audit_sharding, estimate_hbm
from rocket_tpu_torch.analysis.trace_audit import audit_retraces, audit_step, trace_signature

__all__ = [
    "Finding", "emit_findings", "parse_suppressions", "lint_file", "lint_paths", "lint_source",
    "AST_RULES", "AUDIT_RULES", "SPMD_RULES", "CALIB_RULES", "SCHED_RULES", "MEM_RULES",
    "all_rules", "SCHED_TARGETS", "SchedAuditReport", "audit_schedule", "collect_launch_facts",
    "predict", "run_sched_target", "trace_step", "audit_step", "audit_retraces",
    "trace_signature", "audit_sharding", "ShardAuditReport", "estimate_hbm", "audit_memory",
    "MemAuditReport", "simulate_liveness", "PREC_RULES", "REPRO_RULES", "PREC_TARGETS",
    "PrecAuditReport", "audit_precision", "certify_collectives", "collect_dtype_flow",
    "run_prec_target", "REPRO_TARGETS", "ReproAuditReport", "audit_train_repro",
    "audit_serve_repro", "run_replay_sentinel", "run_repro_target",
]
