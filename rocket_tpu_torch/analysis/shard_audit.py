"""The SPMD audit for the port: a rule set's placement and the collectives
one rank issues under it (counterpart of ``rocket_tpu/analysis/
shard_audit.py``).

``parallel/sharding.py`` rule sets are matched by glob with no feedback: a
typo silently replicates a weight matrix onto every rank, and nothing fails
until the card runs out of memory. This pass closes the loop before any
run, on the CPU:

1. the rule set's fit to the param tree is checked statically: dead globs
   (RKT301), rank mismatches (RKT302), mesh divisibility (RKT303), large
   params silently replicated (RKT304);
2. one rank's step, built under the rule set as the Module builds it
   (``sched_audit._parallel_lm_parts`` with the stand-in ``_MetaRuntime``:
   the rank's shards from ``bridge.local_params``, the collective matmuls,
   the bucketed gradient reduction), runs on meta tensors. The reference
   compiled the step under a fake mesh and parsed the collectives GSPMD
   inserted out of the HLO; the port's collectives are explicit calls, each
   recording a ``CommFact`` on meta tensors, so
   :func:`collect_collectives` (the counterpart of ``parse_collectives``)
   counts them from the trace. Each is costed with the reference's ring
   model (:func:`_ring_bytes`) on its payload and gated by a per-step
   allowlist (RKT305);
3. a per-device memory footprint is estimated: params and optimizer state
   by shard-aware shape math, activation bytes from the memory audit's
   liveness of the same trace (``mem_audit.simulate_liveness``: its peak
   temps), where the reference read XLA's ``memory_analysis()``. With the
   collective bytes it is diffed against the committed budgets (RKT306,
   ``tests/fixtures/torch_budgets/shard/``).

CLI: ``python -m rocket_tpu_torch.analysis shard`` audits the port's own
(model, rule set, mesh) pairs, :data:`BUILTIN_TARGETS`; library entry
:func:`audit_sharding`.
"""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import torch

from rocket_tpu_torch.analysis.findings import Finding
from rocket_tpu_torch.analysis.rules.spmd_rules import (
    _leaf_nbytes,
    check_collectives,
    check_dead_rules,
    check_replication,
    check_specs,
)
from rocket_tpu_torch.analysis.sched_audit import _COMM_OPCODES, DEFAULT_DEVICE_KIND
from rocket_tpu_torch.ops._launch import CommFact

__all__ = [
    "CollectiveOp",
    "ShardAuditReport",
    "collect_collectives",
    "resolve_specs",
    "resolve_placement",
    "estimate_hbm",
    "audit_sharding",
    "AuditTarget",
    "BUILTIN_TARGETS",
    "run_target",
]

Spec = Optional[Tuple]

#: The collective kinds the auditor tracks: the reference's opcodes (the
#: port issues no reduce-scatter: an FSDP gradient's is an all-to-all and
#: a local sum, ``grad_sync._scatter``).
COLLECTIVE_KINDS = (
    "all-reduce", "all-gather", "reduce-scatter", "all-to-all",
    "collective-permute",
)


@dataclass(frozen=True)
class CollectiveOp:
    """One collective of one rank's step."""

    kind: str            # "all-gather", ...
    dtype: str           # dtype of the (first) result
    shape: Tuple[int, ...]  # the rank's result shape
    group_size: int      # ranks cooperating in one group
    result_bytes: int    # the rank's result buffer size
    bytes_moved: int     # ring-model estimate of bytes on the wire/device


def _ring_bytes(kind: str, result_bytes: int, n: int) -> int:
    """Per-device bytes-moved estimate under a ring algorithm (the
    reference's, unchanged).

    An all-gather's result is the full gathered buffer, a reduce-scatter's
    the small shard. The constants are the textbook ring costs — good
    enough to rank and budget traffic; not a latency model.
    """
    if n <= 1:
        return 0
    if kind == "all-reduce":
        return int(2 * (n - 1) / n * result_bytes)
    if kind == "all-gather":
        return int((n - 1) / n * result_bytes)
    if kind == "reduce-scatter":
        return int((n - 1) * result_bytes)
    if kind == "all-to-all":
        return int((n - 1) / n * result_bytes)
    return int(result_bytes)  # collective-permute: one hop


def collective_op(fact: CommFact, inputs, outputs) -> CollectiveOp:
    """The :class:`CollectiveOp` of one meta collective: its ``CommFact``
    and the tensors it reads and writes (an all-reduce writes its payload
    in place; a hop's result is what it receives)."""
    kind = _COMM_OPCODES.get(fact.kind, fact.kind)
    results = [t for t in (outputs or inputs) if isinstance(t, torch.Tensor)]
    result_bytes = sum(t.numel() * t.element_size() for t in results)
    first = results[0] if results else None
    return CollectiveOp(
        kind=kind,
        dtype=str(first.dtype).removeprefix("torch.") if first is not None else "?",
        shape=tuple(first.shape) if first is not None else (),
        group_size=int(fact.group), result_bytes=int(result_bytes),
        bytes_moved=_ring_bytes(kind, result_bytes, int(fact.group)),
    )


def collect_collectives(step_fn: Callable, *args,
                        device_kind: str = DEFAULT_DEVICE_KIND) -> list[CollectiveOp]:
    """The collectives one rank's ``step_fn(*args)`` issues (meta tensors in
    ``args``), in issue order: the counterpart of the reference's
    ``parse_collectives``, which read them out of the compiled module's
    HLO. Each explicit collective of ``parallel.collectives`` and
    ``parallel.grad_sync`` records a ``CommFact`` on its meta route, which
    the memory audit's trace of the step keeps."""
    from rocket_tpu_torch.analysis.mem_audit import simulate_liveness

    return simulate_liveness(step_fn, *args, device_kind=device_kind).collectives


# -- rule resolution ---------------------------------------------------------


def resolve_specs(
    rules: Callable[[Tuple[str, ...], Any], Spec],
    params,
    label: str = "params",
) -> tuple[list[Tuple[Tuple[str, ...], Any, Spec]], list[Finding]]:
    """Apply a rule fn to every leaf of the nested param dict ``params``;
    returns the resolved ``(path, leaf, spec)`` triples plus any findings
    raised *by* the rule set itself (a
    :class:`~rocket_tpu_torch.parallel.sharding.ShardingRuleError` becomes
    an RKT302 finding here, so one audit reports every bad rule instead of
    dying on the first). The paths are the port's (``blocks/0/attn/qkv/w``),
    the reference's for the same model."""
    from rocket_tpu_torch.core.module import _paths_leaves
    from rocket_tpu_torch.parallel.sharding import ShardingRuleError

    triples: list[Tuple[Tuple[str, ...], Any, Spec]] = []
    findings: list[Finding] = []
    for path, leaf in _paths_leaves(params):
        path = tuple(str(p) for p in path)
        try:
            spec = rules(path, leaf)
        except ShardingRuleError as exc:
            findings.append(Finding(
                "RKT302", f"<spmd:{label}>", 0,
                f"spec-rank-mismatch: {exc}",
            ))
            spec = None
        triples.append((path, leaf, spec))
    return triples, findings


def _shard_factor(spec: Spec, mesh_shape: Mapping[str, int]) -> int:
    """How many ways a spec splits one leaf across the mesh."""
    if spec is None:
        return 1
    factor = 1
    for entry in spec:
        if entry is None:
            continue
        axes = entry if isinstance(entry, (tuple, list)) else (entry,)
        for axis in axes:
            factor *= int(mesh_shape.get(str(axis), 1))
    return factor


def estimate_hbm(
    specs: Sequence[Tuple[Tuple[str, ...], Any, Spec]],
    mesh_shape: Mapping[str, int],
    optimizer_slots: int = 2,
    activation_bytes: Optional[int] = None,
) -> dict:
    """Per-device memory footprint estimate.

    Params and optimizer state (``optimizer_slots`` param-shaped moment
    trees, 2 for Adam, laid out like the params) are pure shard-aware
    shape math. Activation bytes are the memory audit's liveness peak of
    the rank's step (its temps above the arguments) when given, and the
    record's ``method`` is then ``"liveness"``; otherwise the estimate is
    flagged partial (``"shape-math"``) rather than padded with a made-up
    number.
    """
    params_bytes = sum(
        _leaf_nbytes(leaf) // max(_shard_factor(spec, mesh_shape), 1)
        for _path, leaf, spec in specs
    )
    optimizer_bytes = optimizer_slots * params_bytes
    method = "shape-math" if activation_bytes is None else "liveness"
    total = params_bytes + optimizer_bytes + (activation_bytes or 0)
    return {
        "params_bytes": int(params_bytes),
        "optimizer_bytes": int(optimizer_bytes),
        "activation_bytes": activation_bytes,
        "total_bytes": int(total),
        "method": method,
    }


# -- the orchestrator --------------------------------------------------------


@dataclass
class ShardAuditReport:
    """Everything one audit produced: findings plus the cost record the
    budget gate consumes."""

    label: str
    findings: list[Finding] = field(default_factory=list)
    collectives: list[CollectiveOp] = field(default_factory=list)
    record: dict = field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return not self.findings


def resolve_placement(
    params,
    *,
    rules: Callable[[Tuple[str, ...], Any], Spec],
    mesh_shape: Mapping[str, int],
    replicated_bytes_limit: int = 1 << 20,
    label: str = "step",
) -> tuple:
    """Resolve ``rules`` over the whole ``params`` on ``mesh_shape`` and run
    the static rule checks: returns ``(specs, findings)``, the findings
    RKT301-304 (so the SPMD and memory audits report them from one
    resolution). The rank's shards themselves are cut by
    ``bridge.local_params`` when its step is built."""
    specs, findings = resolve_specs(rules, params, label=label)
    patterns = getattr(rules, "patterns", None)
    if patterns:
        findings.extend(check_dead_rules(
            patterns, [path for path, _leaf, _spec in specs], label=label
        ))
    findings.extend(check_specs(specs, mesh_shape, label=label))
    findings.extend(check_replication(
        specs, mesh_shape, replicated_bytes_limit, label=label
    ))
    return specs, findings


def _placement_failed(label: str, exc: Exception) -> Finding:
    """A placement the port itself refuses (``grad_sync.shard_layout``'s
    NotImplementedError, a shape that does not fit the rank's shards):
    RKT303, so one audit reports every bad rule instead of dying on the
    first (the reference's failed-compile finding)."""
    return Finding(
        "RKT303", f"<spmd:{label}>", 0,
        f"axis-indivisible: one rank's step failed under this rule set: "
        f"{str(exc).splitlines()[0][:300]}",
    )


def audit_sharding(
    step_fn: Callable,
    *args,
    params,
    rules: Callable[[Tuple[str, ...], Any], Spec],
    mesh_shape: Mapping[str, int],
    allow: Optional[Mapping[str, int]] = None,
    replicated_bytes_limit: int = 1 << 20,
    optimizer_slots: int = 2,
    state: Sequence[torch.Tensor] = (),
    device_kind: str = DEFAULT_DEVICE_KIND,
    label: str = "step",
) -> ShardAuditReport:
    """Audit one rank's ``step_fn(*args)`` (meta tensors in ``args``, the
    step built under ``rules`` on ``mesh_shape``) and the placement of the
    whole ``params`` (a nested dict of meta tensors) under ``rules``.

    Returns a :class:`ShardAuditReport`; ``report.record`` is the budget
    record (the reference's keys) and ``report.findings`` the RKT30x hits.
    ``state`` (the rank's param leaves) splits the step's arguments from
    its batch in the liveness. Nothing runs on a device: the step is traced
    on meta tensors.
    """
    from rocket_tpu_torch.analysis.mem_audit import simulate_liveness

    specs, findings = resolve_placement(
        params, rules=rules, mesh_shape=mesh_shape,
        replicated_bytes_limit=replicated_bytes_limit, label=label,
    )
    collectives: list[CollectiveOp] = []
    activation_bytes = None
    try:
        liveness = simulate_liveness(step_fn, *args, state=state, device_kind=device_kind)
    except (NotImplementedError, ValueError, RuntimeError) as exc:
        findings.append(_placement_failed(label, exc))
    else:
        collectives = liveness.collectives
        activation_bytes = liveness.peak_temp_bytes
        findings.extend(check_collectives(collectives, allow, label=label))

    hbm = estimate_hbm(specs, mesh_shape, optimizer_slots=optimizer_slots,
                       activation_bytes=activation_bytes)
    counts: dict[str, int] = {}
    for op in collectives:
        counts[op.kind] = counts.get(op.kind, 0) + 1
    record = {
        "mesh": dict(mesh_shape),
        "collective_counts": counts,
        "collective_bytes_per_step": int(
            sum(op.bytes_moved for op in collectives)
        ),
        "hbm_per_device_bytes": int(hbm["total_bytes"]),
        "hbm": hbm,
    }
    return ShardAuditReport(
        label=label, findings=findings, collectives=collectives,
        record=record,
    )


# -- builtin targets: the port's own (model, rules, mesh) pairs ---------------


@dataclass(frozen=True)
class AuditTarget:
    """One self-gate configuration the CLI audits."""

    name: str
    mesh_shape: Mapping[str, int]
    #: () -> rule set; the step is built under it on ``mesh_shape``.
    rules: Callable[[], Callable]
    allow: Optional[Mapping[str, int]]
    optimizer_slots: int = 2
    replicated_bytes_limit: int = 1 << 20
    train: bool = True
    #: Demo targets (seeded-bad rule sets) are excluded from the default
    #: self-gate sweep and from budget bookkeeping.
    demo: bool = False
    doc: str = ""


def _tp_rules():
    from rocket_tpu_torch.parallel.sharding import gpt2_tp_rules

    return gpt2_tp_rules(axis="model")


def _fsdp_rules():
    from rocket_tpu_torch.parallel.sharding import fsdp_rules

    return fsdp_rules(axis="data", min_size=4096)


def _bad_rules():
    """Seeded-bad rule set for the true-positive fixture tests: a dead glob
    (RKT301), large params left replicated (RKT304), and a zero-tolerance
    allowlist any step over the mesh exceeds (RKT305)."""
    from rocket_tpu_torch.parallel.sharding import make_rules

    return make_rules([
        # Typo'd glob: matches nothing -> RKT301, and the qkv kernels it
        # meant to shard stay replicated -> RKT304 (with the tiny limit on
        # the target below).
        ("*/attn/qkv/w_typo", (None, "model")),
        # Row-split MLP-in with nothing else sharded coherently: the rank
        # runs the replicated program, gathering it whole at step entry,
        # and reduces its gradients over the data axis: collectives for
        # RKT305's empty allowlist to flag.
        ("*/mlp/fc_in/w", ("model", None)),
    ])


def _whole_params():
    """The audit LM's whole params on meta tensors (the tree the rules
    resolve over)."""
    from rocket_tpu_torch.analysis.sched_audit import _lm_config, _meta_params
    from rocket_tpu_torch.models.transformer import TransformerLM

    return _meta_params(TransformerLM(_lm_config()))[0]


#: name -> target. Ordered: the default sweep runs the non-demo entries.
#: Each allowlist is the port's first count of that kind plus the
#: reference's headroom over its own count (its allowlist less its
#: committed count, ``tests/fixtures/budgets/<name>.json``), written "port
#: count + headroom". The reference counted what GSPMD inserted on a TPU
#: mesh; the port counts its explicit calls, so only the headroom carries
#: over. A kind the reference left unlisted stays unlisted (unlimited).
#: The port issues an FSDP or vocab-parallel reduce-scatter as an
#: all-to-all and a local sum, so its all-to-all count is the reference's
#: all-to-alls and reduce-scatters together (12 = 5 + 7 on ``tp_2x4``).
BUILTIN_TARGETS: dict[str, AuditTarget] = {
    target.name: target
    for target in (
        AuditTarget(
            name="tp_2x4",
            mesh_shape={"data": 2, "model": 4},
            rules=_tp_rules,
            # The reference's headroom: 28 - 12, 14 - 7, 14 - 5, 80 - 0, 52 - 44.
            allow={"all-gather": 13 + 16, "reduce-scatter": 0 + 7,
                   "all-to-all": 12 + 9, "collective-permute": 0 + 80,
                   "all-reduce": 3 + 8},
            doc="audit LM train step under gpt2_tp_rules, one rank of data 2 x model 4",
        ),
        AuditTarget(
            name="tp_1x8",
            mesh_shape={"data": 1, "model": 8},
            rules=_tp_rules,
            # The reference's headroom: 18 - 12, 14 - 7, 14 - 5, 90 - 0.
            allow={"all-gather": 13 + 6, "reduce-scatter": 0 + 7,
                   "all-to-all": 12 + 9, "collective-permute": 0 + 90},
            doc="audit LM train step under gpt2_tp_rules, one rank of model 8",
        ),
        AuditTarget(
            name="fsdp_1x8",
            mesh_shape={"data": 8},
            rules=_fsdp_rules,
            # The reference's headroom: 30 - 13, 8 - 0, 24 - 13, 8 - 0.
            allow={"all-gather": 12 + 17, "reduce-scatter": 0 + 8,
                   "all-to-all": 12 + 11, "collective-permute": 0 + 8},
            doc="audit LM train step under fsdp_rules(min_size=4096), one rank of 8",
        ),
        AuditTarget(
            name="tp_2x4_eval",
            mesh_shape={"data": 2, "model": 4},
            rules=_tp_rules,
            optimizer_slots=0,
            train=False,
            # The reference's headroom: 12 - 7, 8 - 5, 4 - 0, 40 - 0.
            allow={"all-gather": 8 + 5, "reduce-scatter": 0 + 3,
                   "all-to-all": 5 + 4, "collective-permute": 0 + 40},
            doc="audit LM eval forward under gpt2_tp_rules, one rank of data 2 x model 4",
        ),
        AuditTarget(
            name="badrules",
            mesh_shape={"data": 2, "model": 4},
            rules=_bad_rules,
            allow={"all-gather": 0, "all-reduce": 0, "reduce-scatter": 0,
                   "all-to-all": 0, "collective-permute": 0},
            replicated_bytes_limit=1 << 16,
            demo=True,
            doc="seeded-bad: a dead glob, large params replicated, a zero allowlist",
        ),
    )
}


def run_target(target: AuditTarget,
               device_kind: str = DEFAULT_DEVICE_KIND) -> ShardAuditReport:
    """Build one rank's step of the audit LM under the target's rule set
    and mesh (``sched_audit._parallel_lm_parts``) and audit it."""
    from rocket_tpu_torch.analysis.sched_audit import _parallel_lm_parts

    rules = target.rules()
    params = _whole_params()
    try:
        step_fn, args = _parallel_lm_parts(target.mesh_shape, rules, train=target.train)
    except (NotImplementedError, ValueError, RuntimeError) as exc:
        specs_findings = resolve_placement(
            params, rules=rules, mesh_shape=target.mesh_shape,
            replicated_bytes_limit=target.replicated_bytes_limit, label=target.name)[1]
        return ShardAuditReport(label=target.name,
                                findings=specs_findings + [_placement_failed(target.name, exc)])
    return audit_sharding(
        step_fn, *args, params=params, rules=rules, mesh_shape=target.mesh_shape,
        allow=target.allow, replicated_bytes_limit=target.replicated_bytes_limit,
        optimizer_slots=target.optimizer_slots, state=getattr(step_fn, "leaves", ()),
        device_kind=device_kind, label=target.name,
    )
