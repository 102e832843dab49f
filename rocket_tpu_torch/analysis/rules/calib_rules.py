"""Calibration rules, ``RKT7xx`` — measured-vs-predicted drift
(counterpart of ``rocket_tpu/analysis/rules/calib_rules.py``).

The schedule audit (RKT5xx) predicts per-op costs from a roofline over a
step traced on meta tensors; ``analysis/calib.py`` reconciles a measured
``torch.profiler`` trace of the same step against it:

* **RKT701** gates drift in the calibration record itself (the budget
  machinery, ``tests/fixtures/torch_budgets/calib/``): the absolute
  calibration error and the unjoined measured fraction growing past
  tolerance mean the cost model and the card (or the join) drift apart;
* **RKT702** fires when the join failed structurally: too little of the
  measured device time matched the priced ops by (launching aten op or
  hand kernel, ordinal within the step), so the "calibration" would
  compare two different programs (the wrong trace for the target, a branch
  on the device outside a kernel wrapper, a stale capture);
* **RKT703** fires when the measured card is the priced card and the error
  still exceeds the target's ceiling — the one-sided "predicted within Kx
  of measured" contract. On a host whose kind the peak tables do not know
  (the CPU) the ceiling is skipped: the error there measures the device
  mismatch, not the model.

The checks are pure (facts in, findings out), the reference's own.
"""

from __future__ import annotations

from typing import Optional

from rocket_tpu_torch.analysis.findings import Finding

__all__ = [
    "CALIB_RULES",
    "check_join_coverage",
    "check_error_ceiling",
]

#: (id, slug, contract) — the catalog, same shape as SCHED_RULES.
CALIB_RULES = (
    ("RKT701", "calibration-drift",
     "the measured-vs-predicted calibration record regressed past "
     "tolerance over the committed budget (absolute calibration error "
     "or unjoined measured fraction grew): the roofline cost model and "
     "the measured hardware are drifting apart — re-baseline "
     "deliberately or fix the model"),
    ("RKT702", "reconcile-join-failure",
     "too little of the measured device time joined the priced step by "
     "(launching op, ordinal): the trace and the priced program differ "
     "(wrong trace for the target, a device branch outside a kernel "
     "wrapper, stale capture) — the calibration would compare two "
     "different programs"),
    ("RKT703", "calibration-error-ceiling",
     "measured and priced device kinds match and the absolute "
     "calibration error still exceeds the target's ceiling: the "
     "roofline prediction is out of contract on the hardware it "
     "prices — fix the cost model before trusting prediction gates"),
)


def check_join_coverage(
    join_coverage: float,
    floor: float,
    *,
    measured_us: float = 0.0,
    unjoined_us: float = 0.0,
    label: str = "calib",
) -> list:
    """RKT702 when less than ``floor`` of the measured device time
    joined the priced DAG (``floor <= 0`` disables)."""
    if floor <= 0 or join_coverage >= floor:
        return []
    return [Finding(
        "RKT702", f"<calib:{label}>", 0,
        f"reconcile-join-failure: only {join_coverage:.1%} of the "
        f"measured device time ({measured_us:.1f} us total, "
        f"{unjoined_us:.1f} us unjoined) matched the priced step's ops "
        f"(floor {floor:.0%}) — the trace does not "
        "correspond to the priced program",
    )]


def check_error_ceiling(
    calib_error: Optional[float],
    ceiling: Optional[float],
    *,
    device_matched: bool,
    label: str = "calib",
) -> list:
    """RKT703 when |calibration error| exceeds ``ceiling`` on matched
    hardware. ``ceiling`` None (or an unmatched device) disables — an
    unmatched host's error measures the device mismatch, not the
    model."""
    if ceiling is None or not device_matched or calib_error is None:
        return []
    if abs(calib_error) <= ceiling:
        return []
    return [Finding(
        "RKT703", f"<calib:{label}>", 0,
        f"calibration-error-ceiling: |{calib_error:+.3f}| > "
        f"{ceiling:.3f} with measured and priced device kinds matched "
        "— the roofline prediction is out of contract on the hardware "
        "it prices",
    )]
