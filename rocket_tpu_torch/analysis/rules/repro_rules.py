"""Determinism and replay rules (RKT901-906): check functions (counterpart
of ``rocket_tpu/analysis/rules/repro_rules.py``).

The port's headline contracts are bitwise: a resume, a drain, a replayed
serve wave, the held step. Two things silently break every one of them:
key misuse (a key drawn twice samples correlated noise; a loop body
drawing an unfolded key repeats the same draw every iteration) and
nondeterministic ops (a float sum whose terms arrive in whatever order
the card's threads do). :mod:`rocket_tpu_torch.analysis.repro_audit`
collects the facts (the draws ``nn/keys.record_draws`` notes, the aten
ops of a step traced on meta tensors, the hand kernels' declared
accumulation order, program fingerprints); the pure checks here turn them
into findings.

RKT906 is the budget gate (``budgets.diff_budget`` with
``REPRO_GATED_KEYS``): a committed program fingerprint that no longer
matches means the step's program changed.
"""

from __future__ import annotations

from typing import Iterable, Mapping, Optional, Sequence

from rocket_tpu_torch.analysis.findings import Finding

__all__ = [
    "REPRO_RULES",
    "check_key_reuse",
    "check_nondet_ops",
    "check_nondet_hlo",
    "check_resume_identity",
    "check_wave_invariance",
    "check_replay_sentinel",
]

#: (id, slug, contract), the reference's ids and slugs.
REPRO_RULES = (
    ("RKT901", "prng-key-reuse",
     "one key and element range is drawn twice (outside a checkpoint's "
     "recompute), a loop body (a decode wave, a layer loop) draws a key that "
     "does not fold in the loop position, or a torch random op draws from "
     "the global default generator: correlated samples, the same draw every "
     "iteration, or a draw no checkpoint can replay"),
    ("RKT902", "nondeterministic-hlo",
     "the step runs an op whose float sums arrive in no fixed order on the "
     "card (index_add, scatter_add, scatter_reduce, an accumulating "
     "index_put or put, the embedding and gather backwards, the ops torch "
     "names nondeterministic on CUDA, a hand kernel declaring an order-free "
     "accumulation) at a site the target has not reviewed"),
    ("RKT903", "resume-identity",
     "the train step built from state round-tripped through "
     "runtime/checkpoint_io must trace the program of the fresh build: a "
     "resume is bit-identical only if the restore reproduces every shape, "
     "dtype and op"),
    ("RKT904", "wave-replay-identity",
     "the k-wave decode dispatch must run k copies of one wave body for "
     "every waves_per_dispatch: re-dispatch boundaries (eviction, resume, "
     "drain) must not change the per-wave program"),
    ("RKT905", "replay-divergence",
     "the sentinel train step run twice from identical state must produce "
     "byte-equal params, loss and health word"),
    ("RKT906", "repro-budget-regression",
     "a gated determinism metric regressed (or a committed program "
     "fingerprint drifted) vs tests/fixtures/torch_budgets/repro/"),
)


def _repro_path(label: str) -> str:
    return f"<repro:{label}>"


def check_key_reuse(consumptions: Mapping[object, Sequence[str]],
                    unfolded: Iterable[tuple], *, label: str = "step") -> list:
    """RKT901 over the draw facts (the reference's check). ``consumptions``
    maps a key identity (a key and the element range it hashes) to the
    sites that drew it; two or more is reuse. ``unfolded`` holds ``(site,
    origin)`` pairs: a loop body's draw whose key is the same every
    iteration, or a draw from the global default generator."""
    findings = []
    for kid in sorted(consumptions, key=str):
        sites = consumptions[kid]
        if len(sites) < 2:
            continue
        findings.append(Finding(
            "RKT901", _repro_path(label), 0,
            f"prng-key-reuse: the same key value is consumed by {len(sites)} random draws "
            f"({', '.join(sites[:4])}{', ...' if len(sites) > 4 else ''}) — fold_in or split "
            "before each use; reused keys sample correlated noise",
        ))
    for site, origin in sorted(set(unfolded)):
        findings.append(Finding(
            "RKT901", _repro_path(label), 0,
            f"prng-key-reuse: {site} draws {origin} — every iteration (or every replay) "
            "repeats or loses the draw; fold the loop position into the key "
            "(keys.fold_in(key, i)), or draw from an explicit key",
        ))
    return findings


def check_nondet_ops(nondet_ops: Sequence[tuple], *, allow: Sequence[tuple] = (),
                     label: str = "step") -> list:
    """RKT902 over ``(op, site, detail)`` triples: each op whose float sum
    runs in no fixed order on the card, at the ``path:function`` that
    issued it. ``allow`` holds reviewed ``(site, op, reason)`` entries (the
    reference's ``scatter_allow``, each with its reason): a triple whose
    site contains an entry's site and whose op equals its op is accepted."""
    findings = []
    for op, site, detail in nondet_ops:
        if any(a_site in site and a_op == op for a_site, a_op, _ in allow):
            continue
        findings.append(Finding(
            "RKT902", _repro_path(label), 0,
            f"nondeterministic-hlo: {op} at {site or 'an unknown site'} ({detail}) — its "
            "float sums combine in whatever order the card's threads arrive; use a "
            "fixed-order form (index_put_ with accumulate=True sorts on CUDA) or allow-list "
            "the reviewed site on the audit target with its reason",
        ))
    return findings


#: The reference's name for the same check.
check_nondet_hlo = check_nondet_ops


def check_resume_identity(fresh_fingerprint: Optional[str], restored_fingerprint: Optional[str],
                          *, label: str = "step") -> list:
    """RKT903: the fingerprint of the step traced from fresh state vs from
    state round-tripped through ``checkpoint_io.save_pytree``/``load_pytree``."""
    if fresh_fingerprint is None or restored_fingerprint is None:
        return []
    if fresh_fingerprint == restored_fingerprint:
        return []
    return [Finding(
        "RKT903", _repro_path(label), 0,
        f"resume-identity: the train step traced from restored state fingerprints "
        f"{restored_fingerprint} vs {fresh_fingerprint} fresh — the restore changed a "
        "shape, dtype, layout or op (checkpoint_io.load_pytree drift), so a resume is NOT "
        "bit-identical",
    )]


def check_wave_invariance(fingerprints: Mapping[int, str], *, label: str = "serve") -> list:
    """RKT904: the per-wave body fingerprint for every ``waves_per_dispatch``
    must be one (the reference's check)."""
    if len(fingerprints) < 2:
        return []
    by_fp: dict = {}
    for k in sorted(fingerprints):
        by_fp.setdefault(fingerprints[k], []).append(k)
    if len(by_fp) == 1:
        return []
    groups = "; ".join(f"waves={ks} -> {fp}" for fp, ks in sorted(by_fp.items()))
    return [Finding(
        "RKT904", _repro_path(label), 0,
        f"wave-replay-identity: the per-wave decode body differs across waves_per_dispatch "
        f"({groups}) — k leaked into the per-wave math, so an eviction or resume that "
        "re-dispatches at another wave boundary replays different tokens",
    )]


def check_replay_sentinel(mismatches: Sequence[str], *, executed: bool = True,
                          label: str = "sentinel") -> list:
    """RKT905: the sentinel step run twice from identical state must give
    byte-equal outputs; ``mismatches`` names the outputs that differed."""
    if not executed:
        return [Finding(
            "RKT905", _repro_path(label), 0,
            "replay-divergence: the sentinel step could not run — the bitwise-replay proof "
            "did not run",
        )]
    if not mismatches:
        return []
    return [Finding(
        "RKT905", _repro_path(label), 0,
        f"replay-divergence: two runs from identical state produced different bytes at "
        f"{sorted(mismatches)[:6]} — the step is not replay-deterministic on this device",
    )]
