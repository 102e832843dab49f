"""The memory audit's rules, ``RKT8xx``, over the simulated liveness of an
eager train step (counterpart of ``rocket_tpu/analysis/rules/mem_rules.py``).

The schedule audit (RKT5xx) prices a step's *time*; this family prices its
*space*. Eager PyTorch allocates a buffer when an op writes a new storage
and frees it when the last reference drops, so
:mod:`rocket_tpu_torch.analysis.mem_audit` replays exactly that on meta
tensors: every storage's birth and death in dispatch order, the peak of
the watermark split into train state, batch, saved-for-backward
activations, collective buffers and temps. These checks then ask what an
out-of-memory error answers after burning a run on the card: is the train
state updated in place, did the remat policy shrink the saved set, what
batch still fits each card, and does the model agree with the CUDA caching
allocator's own peak when the step runs on the card.

The reference's rules with their ids and slugs; RKT801 reads the bytes the
step writes in place where the TPU read donation, and RKT805 holds the
model to the allocator's measured peak (``torch.cuda.max_memory_allocated``)
where the TPU held it to the compiler's ``memory_analysis()``.
"""

from __future__ import annotations

from typing import Mapping, Optional

from rocket_tpu_torch.analysis.findings import Finding

__all__ = [
    "MEM_RULES",
    "check_donation_coverage",
    "check_remat_effectiveness",
    "check_oom_frontier",
    "check_reconciliation",
]

#: (id, slug, contract): the catalog, as the reference's.
MEM_RULES = (
    ("RKT801", "undonated-train-state",
     "the bytes the train step writes in place do not cover the params + "
     "optimizer state through the update: every state tensor the update "
     "rebuilds out of place is a transient 2x copy at the step boundary "
     "— update the state with in-place (foreach, copy_) ops"),
    ("RKT802", "remat-ineffective",
     "the saved-for-backward activation bytes (what autograd packs outside "
     "any checkpoint region) exceed the target's declared remat policy "
     "ceiling: the checkpointing policy is not actually shrinking the "
     "live set the backward pass holds"),
    ("RKT803", "mem-budget-regression",
     "the simulated peak memory or saved-activation bytes grew more than "
     "the tolerance over the checked-in memory budget file"),
    ("RKT804", "oom-frontier",
     "the simulated peak memory does not fit the audited card's "
     "capacity: the step runs out of memory before it runs — the finding "
     "carries the max batch that still fits each known card"),
    ("RKT805", "liveness-divergence",
     "the simulated peak diverged from the CUDA caching allocator's "
     "measured peak of the same step beyond the reconciliation floor: the "
     "liveness model is mispricing this step — fix the model, do not "
     "trust its numbers"),
)


def _mem_path(label: str) -> str:
    return f"<mem:{label}>"


def _mib(nbytes: float) -> str:
    return f"{nbytes / 2**20:.1f} MiB"


def check_donation_coverage(
    aliased_bytes: int,
    expected_state_bytes: int,
    *,
    expects_donation: bool = True,
    coverage_min: float = 0.9,
    label: str = "step",
) -> list[Finding]:
    """RKT801: the bytes written in place must cover the train state.

    ``aliased_bytes`` is what the step's mutating ops write into the state
    arguments' own storages (the eager counterpart of the compiler's
    input->output aliasing); ``expected_state_bytes`` is the params +
    optimizer state the step threads through. Eval steps
    (``expects_donation=False``) return no new state and are exempt.
    """
    if not expects_donation or expected_state_bytes <= 0:
        return []
    if aliased_bytes >= coverage_min * expected_state_bytes:
        return []
    return [Finding(
        "RKT801", _mem_path(label), 0,
        f"undonated-train-state: the step writes only "
        f"{_mib(aliased_bytes)} of the {_mib(expected_state_bytes)} "
        f"per-device train state in place through the update "
        f"(coverage {aliased_bytes / expected_state_bytes * 100:.0f}% < "
        f"{coverage_min * 100:.0f}%) — every state tensor rebuilt out of "
        "place is a transient 2x copy at the step boundary; update it "
        "with in-place ops (torch._foreach_*_, copy_)",
    )]


def check_remat_effectiveness(
    saved_activation_bytes: int,
    saved_max_bytes: int,
    *,
    label: str = "step",
) -> list[Finding]:
    """RKT802: saved-for-backward bytes vs the declared remat ceiling.

    ``saved_max_bytes`` is the target's declared prediction of what its
    checkpointing policy should leave live across the forward/backward
    boundary (0 disables: a target without a remat policy has nothing to
    hold the saved set against).
    """
    if saved_max_bytes <= 0 or saved_activation_bytes <= saved_max_bytes:
        return []
    return [Finding(
        "RKT802", _mem_path(label), 0,
        f"remat-ineffective: {_mib(saved_activation_bytes)} of "
        f"activations survive the forward pass for the backward "
        f"(declared remat ceiling {_mib(saved_max_bytes)}) — the "
        "checkpointing policy is not shrinking the live set; remat the "
        "block boundaries or re-declare the ceiling if the policy "
        "changed intentionally",
    )]


def check_oom_frontier(
    peak_bytes: int,
    capacity_bytes: int,
    *,
    frontier: Optional[Mapping[str, int]] = None,
    batch_size: int = 0,
    label: str = "step",
) -> list[Finding]:
    """RKT804: the simulated peak must fit the audited card's memory.

    ``frontier`` maps card kind -> max batch that still fits; it rides in
    the finding so the fix (drop the batch to the number printed) needs
    no re-audit.
    """
    if capacity_bytes <= 0 or peak_bytes <= capacity_bytes:
        return []
    fits = ", ".join(
        f"{kind}: batch<={mb}" for kind, mb in sorted((frontier or {}).items())
    )
    at = f" at batch {batch_size}" if batch_size else ""
    return [Finding(
        "RKT804", _mem_path(label), 0,
        f"oom-frontier: simulated peak {_mib(peak_bytes)}{at} exceeds "
        f"the {_mib(capacity_bytes)} device capacity — the step runs out "
        f"of memory before it runs; max batch per card: {fits or 'none'}",
    )]


def check_reconciliation(
    simulated_peak_bytes: int,
    measured_peak_bytes: Optional[int],
    *,
    floor: float = 0.5,
    label: str = "step",
) -> list[Finding]:
    """RKT805: the liveness simulation vs the card's own accounting.

    ``measured_peak_bytes`` is the CUDA caching allocator's peak over the
    same step (``torch.cuda.max_memory_allocated`` less what was allocated
    before the step's state was built). A divergence beyond ``floor`` means
    the liveness model is mispricing this step, which must fail loudly,
    because every other RKT80x number derives from the simulated peak.
    ``None`` (no card: the CPU measures nothing) skips the check rather
    than inventing a reference.
    """
    if measured_peak_bytes is None or measured_peak_bytes <= 0 or floor <= 0:
        return []
    error = abs(simulated_peak_bytes - measured_peak_bytes) / measured_peak_bytes
    if error <= floor:
        return []
    return [Finding(
        "RKT805", _mem_path(label), 0,
        f"liveness-divergence: simulated peak "
        f"{_mib(simulated_peak_bytes)} vs the allocator's measured "
        f"{_mib(measured_peak_bytes)} (error {error * 100:.0f}% > floor "
        f"{floor * 100:.0f}%) — the liveness model is mispricing this "
        "step; fix the model before trusting any RKT80x number it "
        "produced",
    )]
