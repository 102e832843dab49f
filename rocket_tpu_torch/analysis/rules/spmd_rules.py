"""The SPMD audit's rules, ``RKT3xx``, for the port's explicit collectives
(counterpart of ``rocket_tpu/analysis/rules/spmd_rules.py``).

The lint (RKT1xx) sees what the source says, the trace audit (RKT2xx) what
a step runs; this family sees a rule set's placement and the collectives
one rank of the mesh issues under it. The rule-set/param-tree fit is
checked statically (dead globs, rank and divisibility, silent
replication); the rank's collectives, counted from a trace of its step on
meta tensors (``analysis/shard_audit.collect_collectives``), are held to a
per-step allowlist; its bytes and per-device memory to the committed
budgets.

On the TPU a compiler (GSPMD) inserted the collectives a placement implied.
The port has no such compiler: each collective is an explicit call of
``parallel.collectives`` or ``parallel.grad_sync``, issued by the layer
that needs it. An excess count therefore means a layer or a placement
issues more than its layout should, not a compiler's reshard. The checks
are the reference's, facts in and findings out, with the same ids, slugs,
paths and messages; the mechanics live in
:mod:`rocket_tpu_torch.analysis.shard_audit`.
"""

from __future__ import annotations

import fnmatch
from typing import Iterable, Mapping, Optional, Sequence, Tuple

from rocket_tpu_torch.analysis.findings import Finding

__all__ = [
    "SPMD_RULES",
    "check_dead_rules",
    "check_specs",
    "check_replication",
    "check_collectives",
]

#: (id, slug, contract): the catalog, as the reference's.
SPMD_RULES = (
    ("RKT301", "dead-rule",
     "a sharding-rule glob matches no param path: the rule is dead and "
     "the params it was written for are silently replicated"),
    ("RKT302", "spec-rank-mismatch",
     "a partition spec names more dims than the matched param has: the "
     "placement fails (or means something else) when the rank cuts its "
     "shards"),
    ("RKT303", "axis-indivisible",
     "a sharded dim is not divisible by its mesh axis size (or the spec "
     "names an axis missing from the mesh): the rank's shards cannot be "
     "cut evenly and the placement falls back or fails"),
    ("RKT304", "replicated-large-param",
     "a large param is fully replicated under a rule set that shards "
     "others: every device holds a full copy the layout meant to split"),
    ("RKT305", "excess-collective",
     "one rank's step issues more collectives of a kind "
     "(all-gather/all-to-all/all-reduce/...) than the per-step "
     "allowlist: a layer or the placement moves bytes the layout did "
     "not intend"),
    ("RKT306", "budget-regression",
     "the estimated per-step collective bytes or per-device memory "
     "footprint grew more than the tolerance over the checked-in "
     "budget file"),
)

Spec = Optional[Tuple]


def _spmd_path(label: str) -> str:
    return f"<spmd:{label}>"


def _leaf_nbytes(leaf) -> int:
    shape = tuple(getattr(leaf, "shape", ()) or ())
    dtype = getattr(leaf, "dtype", None)
    itemsize = getattr(dtype, "itemsize", None) or 4
    n = 1
    for dim in shape:
        n *= int(dim)
    return n * int(itemsize)


def _spec_axes(entry) -> Tuple[str, ...]:
    """Mesh axis names one spec entry refers to ('x' or ('x','y'))."""
    if entry is None:
        return ()
    if isinstance(entry, (tuple, list)):
        return tuple(str(a) for a in entry)
    return (str(entry),)


def check_dead_rules(
    patterns: Sequence[Tuple[str, Spec]],
    paths: Iterable[Tuple[str, ...]],
    label: str = "params",
) -> list[Finding]:
    """RKT301: every glob in the rule table must WIN (first match wins,
    the ``make_rules`` contract) on >= 1 param path. A glob that matches
    only paths an earlier rule already claimed is as dead as one that
    matches nothing: its spec is never applied.

    ``patterns`` is the ``(glob, spec)`` table ``make_rules`` exposes as
    ``rule_fn.patterns``; function-built rule sets (``fsdp_rules``) have
    no globs and skip this check.
    """
    joined = ["/".join(p) for p in paths]
    wins = [0] * len(patterns)
    matches = [0] * len(patterns)
    for path in joined:
        won = False
        for i, (pattern, _spec) in enumerate(patterns):
            if fnmatch.fnmatch(path, pattern):
                matches[i] += 1
                if not won:
                    wins[i] += 1
                    won = True
    findings = []
    for i, (pattern, _spec) in enumerate(patterns):
        if wins[i]:
            continue
        if matches[i]:
            findings.append(Finding(
                "RKT301", _spmd_path(label), 0,
                f"dead-rule: glob {pattern!r} is shadowed — every path "
                "it matches is claimed by an earlier rule "
                "(first match wins), so its spec is never applied",
            ))
        else:
            findings.append(Finding(
                "RKT301", _spmd_path(label), 0,
                f"dead-rule: glob {pattern!r} matches no param path "
                f"({len(joined)} paths checked) — a typo here silently "
                "replicates the params it was written for onto every "
                "device",
            ))
    return findings


def check_specs(
    specs: Sequence[Tuple[Tuple[str, ...], object, Spec]],
    mesh_shape: Mapping[str, int],
    label: str = "params",
) -> list[Finding]:
    """RKT302 + RKT303 over resolved ``(path, leaf, spec)`` triples; a
    replicated leaf passes ``None``."""
    findings = []
    for path, leaf, spec in specs:
        if spec is None:
            continue
        joined = "/".join(path)
        shape = tuple(getattr(leaf, "shape", ()) or ())
        if len(spec) > len(shape):
            findings.append(Finding(
                "RKT302", _spmd_path(label), 0,
                f"spec-rank-mismatch: param {joined} has shape "
                f"{shape} (rank {len(shape)}) but its partition spec "
                f"{tuple(spec)} names {len(spec)} dims",
            ))
            continue
        for dim, entry in enumerate(spec):
            axes = _spec_axes(entry)
            split = 1  # a multi-axis entry splits by the PRODUCT
            known = True
            for axis in axes:
                size = mesh_shape.get(axis)
                if size is None:
                    known = False
                    findings.append(Finding(
                        "RKT303", _spmd_path(label), 0,
                        f"axis-indivisible: param {joined} spec "
                        f"{tuple(spec)} names mesh axis {axis!r} which is "
                        f"not in the mesh {dict(mesh_shape)}",
                    ))
                else:
                    split *= size
            if known and split > 1 and shape[dim] % split != 0:
                findings.append(Finding(
                    "RKT303", _spmd_path(label), 0,
                    f"axis-indivisible: param {joined} dim {dim} "
                    f"(size {shape[dim]}) is not divisible by its "
                    f"{split}-way split over {axes} — the rank's shards "
                    "cannot be cut evenly, so the leaf falls back to "
                    "replicated or the placement fails",
                ))
    return findings


def check_replication(
    specs: Sequence[Tuple[Tuple[str, ...], object, Spec]],
    mesh_shape: Mapping[str, int],
    replicated_bytes_limit: int = 1 << 20,
    label: str = "params",
) -> list[Finding]:
    """RKT304: large params left fully replicated under a sharding rule
    set that does shard something (a rule set sharding *nothing* is a
    deliberate replicated layout, not a mistake)."""
    any_sharded = any(
        spec is not None and any(_spec_axes(e) for e in spec)
        for _path, _leaf, spec in specs
    )
    if not any_sharded:
        return []
    findings = []
    for path, leaf, spec in specs:
        if spec is not None and any(_spec_axes(e) for e in spec):
            continue
        nbytes = _leaf_nbytes(leaf)
        if nbytes < replicated_bytes_limit:
            continue
        findings.append(Finding(
            "RKT304", _spmd_path(label), 0,
            f"replicated-large-param: {'/'.join(path)} "
            f"({nbytes / 2**20:.1f} MiB) is fully replicated onto every "
            f"device under a rule set that shards other params — "
            f"{nbytes / 2**20:.1f} MiB x "
            f"{max(mesh_shape.values(), default=1)} devices of memory for "
            "one matrix (dead glob? missing rule?)",
        ))
    return findings


def check_collectives(
    ops,  # Sequence[shard_audit.CollectiveOp]
    allow: Optional[Mapping[str, int]],
    label: str = "step",
) -> list[Finding]:
    """RKT305: per-kind collective counts of one rank's step against the
    per-step allowlist.

    ``allow`` maps a collective kind (``"all-gather"``, ...) to the max
    number one step may issue; kinds not listed are unlimited.
    ``allow=None`` disables the check (stats-only audit).
    """
    if allow is None:
        return []
    findings = []
    by_kind: dict[str, list] = {}
    for op in ops:
        by_kind.setdefault(op.kind, []).append(op)
    for kind, limit in sorted(allow.items()):
        hits = by_kind.get(kind, [])
        if len(hits) <= limit:
            continue
        total = sum(op.bytes_moved for op in hits)
        biggest = max(hits, key=lambda op: op.bytes_moved)
        findings.append(Finding(
            "RKT305", _spmd_path(label), 0,
            f"excess-collective: {len(hits)} {kind} ops in one rank's "
            f"step (allowlist {limit}), ~{total / 2**20:.2f} MiB moved "
            f"per device per step; largest {biggest.dtype}"
            f"{list(biggest.shape)} (~{biggest.bytes_moved / 2**20:.2f} "
            "MiB) — an unexpected collective usually means a rule places "
            "an operand differently from the layer that reads it",
        ))
    return findings
