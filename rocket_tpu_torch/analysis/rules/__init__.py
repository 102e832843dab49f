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
  (:mod:`rocket_tpu_torch.analysis.calib`).

The reference's other families (its jaxpr, SPMD, precision, serving,
memory, determinism, fault and trace audits, and lint rules RKT101, RKT102
and RKT108 to RKT114) are ROADMAP Queue A 9's remainder.
"""

from __future__ import annotations

from rocket_tpu_torch.analysis.rules.calib_rules import CALIB_RULES
from rocket_tpu_torch.analysis.rules.capsule_rules import (
    CapsuleSuperRule,
    HandlerSignatureRule,
    LaunchHostSyncRule,
)
from rocket_tpu_torch.analysis.rules.host_rules import ForkStartMethodRule, SyncInLoopRule
from rocket_tpu_torch.analysis.rules.sched_rules import SCHED_RULES

__all__ = ["AST_RULES", "SCHED_RULES", "CALIB_RULES", "all_rules"]

AST_RULES = (
    SyncInLoopRule(),
    CapsuleSuperRule(),
    HandlerSignatureRule(),
    LaunchHostSyncRule(),
    ForkStartMethodRule(),
)


def all_rules() -> tuple:
    """``(id, slug, contract)`` of every rule, in id order."""
    return tuple(sorted([(r.rule_id, r.slug, r.contract) for r in AST_RULES]
                        + list(SCHED_RULES) + list(CALIB_RULES)))
