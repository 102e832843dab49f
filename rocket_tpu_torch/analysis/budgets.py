"""Checked-in audit budgets and their regression gate (the port's own copy
of ``rocket_tpu/analysis/budgets.py``, plain JSON bookkeeping).

A budget file is one JSON record per audit target
(``tests/fixtures/torch_budgets/<family>/<target>.json``) holding the
numbers an audit measured or predicted for the repo's own steps. The
default diff mode fails when a gated metric grows more than ``TOLERANCE``
(10%) over the committed record; shrinking is never an error
(improvements re-baseline via ``--update-budgets``). A missing record is
itself a finding: a new target lands with its baseline.

The port gates six families: the schedule audit's ``SCHED_GATED_KEYS``
(RKT506: predicted step time and exposed communication, ``sched/``), the
calibration's ``CALIB_GATED_KEYS`` (RKT701: the absolute calibration error
and the unjoined measured fraction, ``calib/``), the SPMD audit's
``GATED_KEYS`` (RKT306: collective bytes per step and per-device memory,
``shard/``) and the memory audit's ``MEM_GATED_KEYS`` (RKT803: the
predicted peak and the saved-activation bytes, ``mem/``), the precision
audit's ``PREC_GATED_KEYS`` (RKT406: the f32-bytes fraction and the cast
counts, ``prec/``) and the determinism audit's ``REPRO_GATED_KEYS``
(RKT906: the program fingerprint, by equality, and the draw count,
``repro/``). The other key sets are the reference's, kept whole for the
audits still to be ported.
``tests/fixtures/budgets/`` is the reference's and is not read here. The
reference keeps its SPMD records at the top of its budgets directory; the
port's top level holds one directory per family, so they sit in
``shard/`` like every other family's.
"""

from __future__ import annotations

import json
import os
from typing import Mapping, Optional, Tuple

from rocket_tpu_torch.analysis.findings import Finding

__all__ = [
    "TOLERANCE",
    "GATED_KEYS",
    "PREC_GATED_KEYS",
    "SCHED_GATED_KEYS",
    "SERVE_GATED_KEYS",
    "CALIB_GATED_KEYS",
    "MEM_GATED_KEYS",
    "REPRO_GATED_KEYS",
    "FAULT_GATED_KEYS",
    "budget_path",
    "load_budget",
    "write_budget",
    "diff_budget",
]

#: Allowed relative growth over the committed budget before RKT306 fires.
TOLERANCE = 0.10

#: Record keys the SPMD regression gate compares (monotone cost metrics
#: only — counts are context, not gates).
GATED_KEYS = ("collective_bytes_per_step", "hbm_per_device_bytes")

#: Record keys the numerics (precision) gate compares — RKT406. The
#: fraction gates fp32 memory creep; the cast counts gate HLO churn.
PREC_GATED_KEYS = ("fp32_bytes_fraction", "widen_casts", "narrow_casts")

#: Record keys the schedule (roofline) gate compares — RKT506. Both are
#: monotone cost metrics from the static schedule simulation: total
#: predicted step time and the exposed (non-overlapped) collective time.
SCHED_GATED_KEYS = ("predicted_step_time_us", "exposed_comm_us")

#: Record keys the calibration gate compares — RKT701. Both are
#: monotone badness metrics of the measured-vs-predicted reconciliation
#: (rocket_tpu_torch.analysis.calib): the absolute calibration error of the
#: headline quantity (step time for train targets, decode ITL for serve
#: targets) and the fraction of measured device time that failed to
#: join the priced DAG by instruction name. Either growing means the
#: cost model and reality (or the join) are drifting apart.
CALIB_GATED_KEYS = ("abs_calib_error", "unjoined_fraction")

#: Record keys the serving gate compares — RKT606. All three are
#: monotone cost metrics of the AOT-compiled serving programs: predicted
#: inter-token latency (one decode wave), predicted time-to-first-token
#: (the chunked-prefill schedule for the target's reference prompt) and
#: the engine's steady-state HBM footprint (pool + master params +
#: compiled temps).
SERVE_GATED_KEYS = ("predicted_itl_us", "predicted_ttft_us",
                    "hbm_total_bytes")

#: Record keys the memory gate compares — RKT803. Both are monotone
#: cost metrics of the static liveness simulation
#: (the reference's mem_audit): the simulated peak-HBM watermark of
#: the compiled train step and the saved-for-backward activation bytes
#: (the remat-sensitive slice of it). A dropped donation or a lost
#: remat boundary grows one of them long before anyone OOMs on
#: hardware.
MEM_GATED_KEYS = ("predicted_peak_bytes", "saved_activation_bytes")

#: Record keys the determinism gate compares — RKT906. The program
#: fingerprint is a string identity, not a monotone cost: ANY drift vs
#: the committed value fails (the canonicalized traced program changed,
#: so bitwise resume/replay claims need re-certifying). The RNG-consumer
#: count gates the step's randomness surface — a new unreviewed random
#: draw shows up as growth.
REPRO_GATED_KEYS = ("program_fingerprint", "random_consumers")

#: Record keys the fault (crash-consistency) gate compares — RKT1006.
#: The counts are coverage metrics, not costs: growth means the save
#: paths/state machine got bigger (acknowledge via re-baseline), while
#: the ``coverage_fingerprint`` string key catches the bad direction —
#: ANY drift, including a SHRINKING crash-point or explored-state
#: count, fails until someone re-baselines: the audit must never get
#: quietly weaker. Each fault target's record carries its own subset
#: (the diff loop skips keys absent from either side).
FAULT_GATED_KEYS = ("crash_points", "states_explored",
                    "handlers_checked", "coverage_fingerprint")

#: Default budgets directory, relative to the repo checkout: the port's
#: own records, one subdirectory per family so a sweep over ``*.json``
#: never mixes record shapes.
DEFAULT_DIR = os.path.join("tests", "fixtures", "torch_budgets")
SCHED_DIR = os.path.join(DEFAULT_DIR, "sched")
CALIB_DIR = os.path.join(DEFAULT_DIR, "calib")
SHARD_DIR = os.path.join(DEFAULT_DIR, "shard")
MEM_DIR = os.path.join(DEFAULT_DIR, "mem")
PREC_DIR = os.path.join(DEFAULT_DIR, "prec")
REPRO_DIR = os.path.join(DEFAULT_DIR, "repro")


def budget_path(budgets_dir: str, target: str) -> str:
    return os.path.join(budgets_dir, f"{target}.json")


def load_budget(budgets_dir: str, target: str) -> Optional[dict]:
    """The committed record for ``target``, or None when absent/corrupt."""
    try:
        with open(budget_path(budgets_dir, target)) as fh:
            record = json.load(fh)
    except (OSError, ValueError):
        return None
    return record if isinstance(record, dict) else None


def write_budget(budgets_dir: str, target: str, record: Mapping) -> str:
    """Write ``record`` for ``target``; returns the path written."""
    os.makedirs(budgets_dir, exist_ok=True)
    path = budget_path(budgets_dir, target)
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(dict(record), fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    return path


def diff_budget(
    target: str,
    committed: Optional[Mapping],
    measured: Mapping,
    tolerance: float = TOLERANCE,
    keys: Tuple[str, ...] = GATED_KEYS,
    rule: str = "RKT306",
    family: str = "spmd",
) -> list[Finding]:
    """Budget-regression findings for ``measured`` vs the ``committed``
    record — RKT506 for ``keys=SCHED_GATED_KEYS``, RKT701 for
    ``keys=CALIB_GATED_KEYS`` (the reference's defaults kept).

    A missing budget file is itself a finding — a new audit target must
    land with its baseline (run ``--update-budgets``), or CI would
    silently gate nothing.
    """
    path = f"<{family}:{target}>"
    subcommand = {
        "spmd": "shard", "sched": "sched", "serve": "serve",
        "calib": "calib", "mem": "mem", "repro": "repro",
        "fault": "fault",
    }.get(family, "prec")
    if committed is None:
        return [Finding(
            rule, path, 0,
            "budget-regression: no committed budget for this target — "
            f"run `python -m rocket_tpu_torch.analysis {subcommand} "
            "--update-budgets` and commit the budget directory",
        )]
    def fmt(value) -> str:
        # Byte/count keys are ints and keep their exact digits (two
        # measurements must never render identically unless equal);
        # fractions print compact.
        if isinstance(value, int):
            return f"{value:,}"
        return f"{value:.4g}"

    findings = []
    for key in keys:
        old = committed.get(key)
        new = measured.get(key)
        if isinstance(old, str) or isinstance(new, str):
            # Identity keys (program fingerprints): equality, not growth
            # — any drift means the compiled/traced program changed.
            if old != new:
                findings.append(Finding(
                    rule, path, 0,
                    f"budget-regression: {key} changed ({old!r} -> "
                    f"{new!r}) — the committed fingerprint no longer "
                    "matches this program; if the change is intended, "
                    "re-baseline with --update-budgets",
                ))
            continue
        if not isinstance(old, (int, float)) or not isinstance(new, (int, float)):
            continue
        if old <= 0:
            # Growth from a zero baseline is infinite — the one case the
            # gate exists for most; never silently pass it.
            if new > 0:
                findings.append(Finding(
                    rule, path, 0,
                    f"budget-regression: {key} grew from a zero baseline "
                    f"to {fmt(new)} — if intended, re-baseline with "
                    "--update-budgets",
                ))
            continue
        growth = (new - old) / old
        if growth > tolerance:
            findings.append(Finding(
                rule, path, 0,
                f"budget-regression: {key} grew {growth * 100:.1f}% "
                f"({fmt(old)} -> {fmt(new)}; tolerance "
                f"{tolerance * 100:.0f}%) — if intended, re-baseline with "
                "--update-budgets",
            ))
    return findings
