"""The port's rule catalog (counterpart of
``rocket_tpu/analysis/rules/__init__.py``): every rule has a stable id, a
slug and a one-line contract, printed by ``--list-rules``.

* ``AST_RULES`` — the source lint (``RKT1xx``), objects with ``check(ctx)``
  over a :class:`~rocket_tpu_torch.analysis.rocketlint.FileContext`, run
  in id order;
* ``SCHED_RULES`` — the schedule audit (``RKT5xx``): the roofline legs
  RKT501-503 and RKT505, the kernel-launch rule RKT504 and the budgets'
  RKT506, applied by :mod:`rocket_tpu_torch.analysis.sched_audit` and the
  CLI;
* ``CALIB_RULES`` — the calibration (``RKT7xx``): RKT701 its budgets,
  RKT702 the join, RKT703 the error ceiling
  (:mod:`rocket_tpu_torch.analysis.calib`);
* ``AUDIT_RULES`` — the trace audit (``RKT2xx``) of a step run on meta
  tensors (:mod:`rocket_tpu_torch.analysis.trace_audit`, a library entry);
* ``SPMD_RULES`` — the SPMD audit (``RKT3xx``): a rule set's placement and
  one rank's collectives (:mod:`rocket_tpu_torch.analysis.shard_audit`);
* ``MEM_RULES`` — the memory audit (``RKT8xx``): the liveness of an eager
  step, its in-place update, its frontier and its reconciliation with the
  card's allocator (:mod:`rocket_tpu_torch.analysis.mem_audit`);
* ``PREC_RULES`` — the precision audit (``RKT4xx``): the dtype flow of a
  step (:mod:`rocket_tpu_torch.analysis.prec_audit`);
* ``REPRO_RULES`` — the determinism audit (``RKT9xx``): key discipline,
  order-free sums, resume and wave identity, the replay sentinel
  (:mod:`rocket_tpu_torch.analysis.repro_audit`).

The reference's other families (its serving and fault audits, and lint
rules RKT101, RKT102 and RKT108 to RKT114) are ROADMAP Queue A 9's
remainder.
"""

from __future__ import annotations

from rocket_tpu_torch.analysis.rules.calib_rules import CALIB_RULES
from rocket_tpu_torch.analysis.rules.capsule_rules import (
    CapsuleSuperRule,
    HandlerSignatureRule,
    LaunchHostSyncRule,
)
from rocket_tpu_torch.analysis.rules.host_rules import ForkStartMethodRule, SyncInLoopRule
from rocket_tpu_torch.analysis.rules.mem_rules import MEM_RULES
from rocket_tpu_torch.analysis.rules.prec_rules import PREC_RULES
from rocket_tpu_torch.analysis.rules.repro_rules import REPRO_RULES
from rocket_tpu_torch.analysis.rules.sched_rules import SCHED_RULES
from rocket_tpu_torch.analysis.rules.spmd_rules import SPMD_RULES

__all__ = ["AST_RULES", "AUDIT_RULES", "SPMD_RULES", "SCHED_RULES", "CALIB_RULES", "MEM_RULES",
           "PREC_RULES", "REPRO_RULES", "all_rules"]

AST_RULES = (
    SyncInLoopRule(),
    CapsuleSuperRule(),
    HandlerSignatureRule(),
    LaunchHostSyncRule(),
    ForkStartMethodRule(),
)


#: The trace audit's rules (id, slug, contract), the reference's ids and
#: slugs with contracts worded for torch; implemented in trace_audit.py.
AUDIT_RULES = (
    ("RKT201", "donation-unused",
     "a leaf of an argument the step updates in place is never written by a "
     "mutating op while the step produces a fresh tensor of its shape: the "
     "update went out of place (a 2x copy of the state)"),
    ("RKT202", "donation-duplicate",
     "one storage appears at two leaves of the in-place arguments: an "
     "in-place update of one writes the other"),
    ("RKT203", "host-callback-in-step",
     "a host read of a device tensor (.item(), float(), a copy to a CPU "
     "tensor) inside the step: a device-to-host sync every step"),
    ("RKT204", "weak-type-input",
     "a Python float or int among the step's tensor arguments: a new "
     "constant at every call, and a new capture under a CUDA graph"),
    ("RKT205", "retrace-excess",
     "the example inputs produce more distinct signatures (structure, shape, "
     "dtype, device) than max_traces: every new one recompiles or recaptures "
     "the step"),
    ("RKT206", "wide-dtype",
     "a float64/complex128 device tensor flows through the step: 64-bit "
     "float math runs at a fraction of the card's f32 rate"),
)


def all_rules() -> tuple:
    """``(id, slug, contract)`` of every rule, in id order."""
    return tuple(sorted([(r.rule_id, r.slug, r.contract) for r in AST_RULES]
                        + list(AUDIT_RULES) + list(SPMD_RULES) + list(SCHED_RULES)
                        + list(CALIB_RULES) + list(MEM_RULES) + list(PREC_RULES)
                        + list(REPRO_RULES)))
