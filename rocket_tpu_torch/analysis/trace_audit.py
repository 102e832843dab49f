"""trace_audit — run a step function on meta tensors and audit what it runs
(RKT201-206; counterpart of ``rocket_tpu/analysis/trace_audit.py``).

The lint sees what the source *says*; this pass sees what a step actually
*runs*. The reference abstract-evaluated the step into a jaxpr; the port
runs it on meta tensors (shapes and dtypes, no memory, no card) under a
``TorchDispatchMode`` that sees every aten op below autograd, the
backward's included, and checks the hot-path contracts the train step
relies on, in torch's forms:

* **RKT201 donation-unused** — a leaf of an argument the step should
  update in place (``inplace_argnums``: its params, its optimizer state)
  is never written by a mutating op, while the step produces a fresh
  tensor of its shape and dtype instead: the update went out of place, a
  transient 2x copy of the state every step (the reference's donation
  that degrades to a copy);
* **RKT202 donation-duplicate** — two leaves of such an argument share one
  storage: an in-place update of one writes the other;
* **RKT203 host-callback-in-step** — a host read of a device tensor in the
  step (``aten::_local_scalar_dense``/``item``, a copy to a CPU tensor):
  a device->host round trip, a sync, every iteration. On meta tensors
  ``.item()`` cannot run; the audit records the read as the finding and
  hands the step a zero, so the rest of the step is still audited;
* **RKT204 weak-type-input** — a Python ``float`` or ``int`` among the
  step's tensor arguments: a new constant at every call, and under a CUDA
  graph a value baked into the capture;
* **RKT206 wide-dtype** — a float64/complex128 device tensor flowing
  through the step: the H100 runs 64-bit float math at a fraction of its
  f32 rate.

``audit_retraces`` (RKT205) checks a *set* of example inputs against a
budget: each distinct (structure, shape, dtype, device) signature is one
``torch.compile`` specialization or one CUDA graph capture, so
shape-polymorphic callers (unpadded trailing batches, growing decode
lengths) pay a recompile or a capture each.

Like the reference's, this is a library entry, not a CLI subcommand: it
audits a user's step function, and the repo's own steps are the other
audits' targets. All checks return :class:`~rocket_tpu_torch.analysis.
findings.Finding` lists; empty means clean. A ``# rocketlint:
disable=RKT2xx`` comment anywhere in the audited step function's own
source suppresses that rule for the audit (the findings carry no line,
so a line-scoped directive inside the function scopes to the function).
Runtime enforcement of the host-read contract is ``runtime.StrictMode``.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Iterable, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from rocket_tpu_torch.analysis.findings import Finding, parse_suppressions

__all__ = ["audit_step", "audit_retraces", "trace_signature"]

#: Reads of one element into a Python scalar: a device->host sync.
_SCALAR_READS = ("aten::_local_scalar_dense", "aten::item")
#: Copies whose destination can be a host tensor.
_COPIES = ("aten::_to_copy", "aten::copy_")
_WIDE = (torch.float64, torch.complex128)


def _trace_path(label: str) -> str:
    return f"<trace:{label}>"


def _fn_suppressed_rules(fn: Callable, prefix: str = "RKT2") -> set:
    """Rule ids disabled by ``# rocketlint: disable=...`` directives in the
    step function's own source (the lint's waivers, for the trace audit).
    The findings have no line numbers, so a directive anywhere in the
    function body applies to the whole audit of that function, which is
    exactly why only EXPLICIT ids of the auditing family (``prefix``) count
    here: a line-scoped ``disable=all`` or a lint rule's id placed to
    silence the lint must not blank the whole audit. Functions without
    retrievable source (C callables, REPL lambdas) suppress nothing."""
    try:
        source = inspect.getsource(inspect.unwrap(fn))
    except (OSError, TypeError):
        return set()
    sup = parse_suppressions(source)
    rules = set(sup.everywhere)
    for line_rules in sup.per_line.values():
        rules |= set(line_rules)
    return {r for r in rules if r.startswith(prefix)}


def _filter_suppressed(findings: list[Finding], suppressed: Optional[set]) -> list[Finding]:
    if not suppressed:
        return findings
    return [f for f in findings if f.rule not in suppressed]


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _on_device(t: torch.Tensor) -> bool:
    return t.device.type != "cpu"


def _sig(t: torch.Tensor) -> str:
    return f"{str(t.dtype).removeprefix('torch.')}{list(t.shape)}"


def _zero_of(dtype: torch.dtype):
    if dtype == torch.bool:
        return False
    return 0.0 if dtype.is_floating_point or dtype.is_complex else 0


class _StepAudit(TorchDispatchMode):
    """What a step run on meta tensors does: its host reads, the storages
    its mutating ops write, the fresh tensors it produces (shape, dtype) and
    the wide dtypes it runs. It keeps every storage it saw, so no id is
    reused within the step."""

    def __init__(self) -> None:
        super().__init__()
        self.host_reads: list = []
        self.wide: set = set()
        self.written: set = set()
        self.fresh: dict = {}
        self._seen: dict = {}

    def _storage_id(self, t: torch.Tensor):
        try:
            s = t.untyped_storage()
        except (RuntimeError, NotImplementedError):
            return None
        self._seen.setdefault(id(s), s)
        return id(s)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        ins = _tensors((args, kwargs))
        if name in _SCALAR_READS and any(_on_device(t) for t in ins):
            self.host_reads.append(f"{name} of {_sig(ins[0])}")
            return _zero_of(ins[0].dtype)
        if name in _COPIES and any(_on_device(t) for t in ins):
            dst = args[0] if name == "aten::copy_" else None
            to_host = (dst is not None and dst.device.type == "cpu") or (
                dst is None and torch.device(kwargs.get("device") or ins[0].device).type == "cpu")
            if to_host:
                self.host_reads.append(f"{name} of {_sig(ins[-1])} to the host")
                if dst is not None:
                    return dst
                return torch.zeros(ins[0].shape, dtype=kwargs.get("dtype") or ins[0].dtype)
        before = {self._storage_id(t) for t in ins}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        for i, arg in enumerate(func._schema.arguments):
            if arg.alias_info is not None and arg.alias_info.is_write:
                value = args[i] if i < len(args) else kwargs.get(arg.name)
                self.written.update(self._storage_id(t) for t in _tensors(value))
        for t in outs:
            if _on_device(t) and self._storage_id(t) not in before:
                key = (tuple(t.shape), t.dtype)
                self.fresh[key] = self.fresh.get(key, 0) + 1
        for t in ins + outs:
            if _on_device(t) and t.dtype in _WIDE:
                self.wide.add(str(t.dtype).removeprefix("torch."))
        return out


def _to_meta(tree):
    """``tree`` with every non-meta tensor replaced by a meta tensor of its
    shape, dtype and ``requires_grad`` (the audit never runs on data)."""
    memo: dict = {}

    def move(t):
        if not isinstance(t, torch.Tensor) or t.device.type == "meta":
            return t
        if id(t) not in memo:
            m = torch.empty_strided(t.shape, t.stride(), dtype=t.dtype, device="meta")
            memo[id(t)] = m.requires_grad_(t.requires_grad) if t.is_leaf else m
        return memo[id(t)]
    return tree_map(move, tree)


def _inplace_leaves(args: Sequence[Any], inplace_argnums: Sequence[int]) -> list:
    """``(argnum, tensor)`` of every tensor leaf of the in-place arguments."""
    return [(argnum, t) for argnum in inplace_argnums if argnum < len(args)
            for t in _tensors(args[argnum])]


def _duplicate_leaves(leaves, label: str) -> list[Finding]:
    """RKT202: one storage at two leaves of the in-place arguments."""
    findings = []
    seen: dict = {}
    for argnum, t in leaves:
        key = id(t.untyped_storage())
        where = f"argument {argnum}"
        if key in seen:
            findings.append(Finding(
                "RKT202", _trace_path(label), 0,
                f"donation-duplicate: one storage appears at two leaves of "
                f"the in-place arguments ({seen[key]} and {where}); an "
                "in-place update of one writes the other",
            ))
        else:
            seen[key] = where
    return findings


def audit_step(fn: Callable, *example_args,
               inplace_argnums: Sequence[int] = (),
               label: str = "step",
               static_argnums: Sequence[int] = (),
               **example_kwargs) -> list[Finding]:
    """Run ``fn(*example_args, **example_kwargs)`` on meta tensors (any
    other tensor is replaced by a meta tensor of its shape and dtype) and
    audit what it runs. ``inplace_argnums`` name the arguments the step
    must update in place (its train state); ``static_argnums`` those whose
    Python values are configuration, not inputs (RKT204 skips them).
    Returns the findings; an empty list means the step is clean. A
    ``# rocketlint: disable=RKT2xx`` comment inside ``fn``'s own source
    suppresses that rule for this audit."""
    suppressed = _fn_suppressed_rules(fn)
    path = _trace_path(label)
    leaves = _inplace_leaves(example_args, inplace_argnums)
    findings = list(_duplicate_leaves(leaves, label))

    # RKT204: Python scalars among the inputs.
    for argnum, arg in enumerate(example_args):
        if argnum in static_argnums:
            continue
        for leaf in tree_flatten(arg)[0]:
            if isinstance(leaf, (int, float)) and not isinstance(leaf, bool):
                findings.append(Finding(
                    "RKT204", path, 0,
                    f"weak-type-input: argument {argnum} carries a Python "
                    f"{type(leaf).__name__} ({leaf!r}) — a new constant at every "
                    "call, and under a CUDA graph a value baked into the "
                    "capture; pass a tensor (torch.tensor(x, device=...)) so the "
                    "signature is stable",
                ))
    for key, leaf in example_kwargs.items():
        for value in tree_flatten(leaf)[0]:
            if isinstance(value, (int, float)) and not isinstance(value, bool):
                findings.append(Finding(
                    "RKT204", path, 0,
                    f"weak-type-input: keyword {key!r} carries a Python "
                    f"{type(value).__name__} ({value!r}) — a new constant at every "
                    "call; pass a tensor so the signature is stable",
                ))

    args, kwargs = _to_meta((example_args, example_kwargs))
    audit = _StepAudit()
    with audit:
        fn(*args, **kwargs)

    # RKT201: every in-place leaf written, or no fresh tensor stands in.
    pool = dict(audit.fresh)
    for argnum, t in _inplace_leaves(args, inplace_argnums):
        if id(t.untyped_storage()) in audit.written:
            continue
        key = (tuple(t.shape), t.dtype)
        if pool.get(key, 0) > 0:
            pool[key] -= 1
            findings.append(Finding(
                "RKT201", path, 0,
                f"donation-unused: in-place argument {argnum}'s leaf {_sig(t)} "
                "is never written in place while the step produces a fresh "
                "tensor of its shape — the update went out of place, a "
                "transient 2x copy of the state every step (update it with "
                "torch._foreach_*_ or copy_)",
            ))

    # RKT203: host reads.
    for read in audit.host_reads:
        findings.append(Finding(
            "RKT203", path, 0,
            f"host-callback-in-step: {read} inside the step — a "
            "device->host round trip every iteration (a .item(), float() or "
            ".cpu() left in the hot path?)",
        ))
    # RKT206: wide dtypes.
    for dtype in sorted(audit.wide):
        findings.append(Finding(
            "RKT206", path, 0,
            f"wide-dtype: {dtype} flows through the step — 64-bit float math "
            "runs at a fraction of the card's f32 rate; cast explicitly or "
            "keep torch's default dtype float32",
        ))
    return _filter_suppressed(findings, suppressed)


def trace_signature(tree) -> tuple:
    """Hashable (structure, shapes, dtypes, devices) signature of an input
    tree: two inputs with different signatures are two specializations of
    a compiled step, or two captures of a CUDA graph."""
    leaves, spec = tree_flatten(tree)

    def leaf_sig(leaf):
        if isinstance(leaf, torch.Tensor):
            return (tuple(leaf.shape), str(leaf.dtype), leaf.device.type)
        return ("pyscalar", type(leaf).__name__)

    return (str(spec), tuple(leaf_sig(leaf) for leaf in leaves))


def audit_retraces(example_inputs: Iterable[Any], max_traces: int = 1,
                   label: str = "step") -> list[Finding]:
    """RKT205: count distinct trace signatures over ``example_inputs``
    (e.g. the first epoch's batches) against a budget."""
    signatures: dict[tuple, int] = {}
    total = 0  # counted in the walk: example_inputs may be a one-shot iterator
    for tree in example_inputs:
        sig = trace_signature(tree)
        signatures[sig] = signatures.get(sig, 0) + 1
        total += 1
    if len(signatures) <= max_traces:
        return []
    shapes = "; ".join(
        f"{count}x {sig[1]}" for sig, count in list(signatures.items())[:4]
    )
    return [Finding(
        "RKT205", _trace_path(label), 0,
        f"retrace-excess: {len(signatures)} distinct trace signatures over "
        f"{total} example inputs (budget {max_traces}) — "
        f"every new shape/dtype recompiles or recaptures the step. Signatures: {shapes}",
    )]
