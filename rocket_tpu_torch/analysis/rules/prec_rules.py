"""Precision audit rules (``RKT4xx``): checks over the dtype flow of a
traced step (counterpart of ``rocket_tpu/analysis/rules/prec_rules.py``).

The bf16-compute / f32-master convention (``nn/layers.py``: params are f32
masters cast to the activation dtype at use) and the "reductions stay
f32" discipline hold only if every call site keeps them, and nothing in
torch enforces either: a kernel that accumulates in bf16 trains, a softmax
applied to a bf16 tensor runs its ``exp`` at 8 mantissa bits, and an EMA
update that round-trips through the compute dtype erodes the master
weights a little every step. This family checks the convention on what a
step ran (:mod:`rocket_tpu_torch.analysis.prec_audit`, on meta tensors);
this module holds the catalog and the checks that map the collected facts
to :class:`~rocket_tpu_torch.analysis.findings.Finding` s, so the rules
are testable without tracing anything.

What accumulates where, in the port's terms: an aten GEMM with bf16
operands accumulates in f32 inside cuBLAS, and only its split-K partials
may be reduced in bf16, when ``torch.backends.cuda.matmul.
allow_bf16_reduced_precision_reduction`` is on (torch's default): the
audit records the flag and reads such a GEMM as accumulating in bf16. The
aten reductions (``sum``, ``mean``, ``var``, ``_foreach_norm``) accumulate
in f32 for half inputs on the card and on the CPU (torch's ``acc_type``);
a sum that really runs in bf16 is a chain of elementwise adds into a
sub-f32 value (a Python loop ``acc = acc + x``). A hand kernel declares
its accumulator (``ops._launch.LaunchFact.acc_dtype``).

Deliberate non-rules, the reference's: bf16 GEMMs below the contraction
threshold are the mixed-precision convention itself, and bounded
activations (tanh/erf/sigmoid: gelu, silu) are safe at bf16, so only the
exp/log family counts for RKT402.
"""

from __future__ import annotations

from fnmatch import fnmatchcase
from typing import Mapping, Sequence, Tuple

from rocket_tpu_torch.analysis.findings import Finding

__all__ = [
    "PREC_RULES",
    "TRANSCENDENTAL_OPS",
    "is_float",
    "is_sub32_float",
    "check_accumulation",
    "check_transcendentals",
    "check_state_dtypes",
    "check_collective_operands",
    "check_cast_churn",
    "check_uncast_params",
]

#: (id, slug, contract), the reference's ids and slugs.
PREC_RULES = (
    ("RKT401", "low-precision-accumulation",
     "a large matmul or reduction accumulates below f32 (a bf16 GEMM whose "
     "split-K partials cuBLAS may reduce in bf16, a chain of bf16 adds, a "
     "hand kernel declaring a sub-f32 accumulator): rounding error grows "
     "with the contraction length; grouped matmuls and hand kernels chain "
     "partial sums and are flagged at any size"),
    ("RKT402", "sub-fp32-transcendental",
     "softmax/logsumexp/cross-entropy internals (exp/log/_softmax/"
     "_log_softmax/logsumexp) run on a sub-f32 operand: 8 mantissa bits "
     "flatten near-tied probabilities and overflow at |x| > 88"),
    ("RKT403", "state-narrowed",
     "optimizer/EMA/model state leaves the step narrower than it entered, "
     "or a collective moves a param narrowed from its master dtype: "
     "master-weight precision erodes a little every step; deliberate "
     "compressed-gradient wires are certified per path glob with "
     "@certify_collectives (a stale certification is itself a finding)"),
    ("RKT404", "cast-churn",
     "a value is widened and immediately narrowed back (bf16->f32->bf16) "
     "with nothing in between: dead casts that cost a kernel each and hide "
     "where precision actually changes"),
    ("RKT405", "param-never-cast",
     "a large f32 master param reaches a matmul uncast while the step "
     "declares a sub-f32 compute dtype: silent f32 compute (the tensor "
     "cores' bf16 rate forgone); deliberate f32 islands widen their "
     "activations explicitly and stay exempt"),
    ("RKT406", "numerics-budget-regression",
     "the f32-bytes fraction or widen/narrow cast counts of the traced step "
     "grew more than the tolerance over the checked-in numerics budget"),
)

#: Aten ops whose sub-f32 operand RKT402 flags: the exp/log family
#: (softmax, logsumexp, cross-entropy internals). Bounded activations are
#: excluded by design (module docstring).
TRANSCENDENTAL_OPS = frozenset({
    "aten::exp", "aten::exp2", "aten::log", "aten::log1p", "aten::log2", "aten::expm1",
    "aten::_softmax", "aten::_log_softmax", "aten::logsumexp",
})

_SIZES = {"float64": 8, "float32": 4, "bfloat16": 2, "float16": 2, "float8_e4m3fn": 1,
          "float8_e5m2": 1, "complex64": 8, "complex128": 16}


def _name(dtype) -> str:
    return str(dtype).removeprefix("torch.") if dtype is not None else ""


def is_float(dtype) -> bool:
    """A floating dtype (a ``torch.dtype`` or its name)."""
    return _name(dtype) in _SIZES and not _name(dtype).startswith("complex")


def is_sub32_float(dtype) -> bool:
    """A float dtype narrower than 32 bits (bf16, f16, fp8)."""
    return is_float(dtype) and _SIZES[_name(dtype)] < 4


def _size(dtype) -> int:
    return _SIZES.get(_name(dtype), 4)


def _prec_path(label: str) -> str:
    return f"<prec:{label}>"


def check_accumulation(dots: Sequence, reduces: Sequence, dot_contract_min: int = 2048,
                       reduce_factor_min: int = 4096, label: str = "step") -> list:
    """RKT401 over collected dot and reduce facts (``prec_audit.DotFact``,
    ``ReduceFact``). A GEMM below ``dot_contract_min`` passes; at or above
    it (and a grouped matmul or a hand kernel at any size: partial sums
    chain across tiles and groups) a sub-f32 accumulator is flagged.
    Reductions compare the elements summed per output with
    ``reduce_factor_min``."""
    findings = []
    for dot in dots:
        if not is_sub32_float(dot.acc_dtype):
            continue
        if not dot.grouped and dot.contract_size < dot_contract_min:
            continue
        where = f" (param {'/'.join(dot.param_path)})" if dot.param_path else ""
        findings.append(Finding(
            "RKT401", _prec_path(label), 0,
            f"low-precision-accumulation: {dot.prim} {dot.lhs_shape}x{dot.rhs_shape} "
            f"accumulates in {_name(dot.acc_dtype)} over a {dot.contract_size}-long "
            "contraction" + (" with grouped partial sums" if dot.grouped else "") + where
            + (f" — {dot.why}" if dot.why else "")
            + " — accumulate in f32 (an f32 accumulator, or cuBLAS's split-K reductions "
            "in f32) and round the result once",
        ))
    for red in reduces:
        if not is_sub32_float(red.dtype) or red.factor < reduce_factor_min:
            continue
        findings.append(Finding(
            "RKT401", _prec_path(label), 0,
            f"low-precision-accumulation: {red.prim} sums {red.factor} elements per output "
            f"in {_name(red.dtype)} — accumulate in f32 (sum the .float() operand, or "
            "torch.sum, which accumulates in f32, and round once)",
        ))
    return findings


def check_transcendentals(trans: Sequence, label: str = "step") -> list:
    """RKT402: exp/log-family ops on a sub-f32 operand."""
    findings = []
    for fact in trans:
        if not is_sub32_float(fact.dtype):
            continue
        findings.append(Finding(
            "RKT402", _prec_path(label), 0,
            f"sub-fp32-transcendental: {fact.prim} on {_name(fact.dtype)}{list(fact.shape)} — "
            "softmax/logsumexp internals need f32 (take .float() first; "
            "torch.softmax keeps its input's dtype unless told dtype=torch.float32)",
        ))
    return findings


def check_state_dtypes(in_dtypes: Mapping[Tuple[str, ...], object],
                       out_dtypes: Mapping[Tuple[str, ...], object],
                       label: str = "step") -> list:
    """RKT403 (state half): a state leaf that leaves the step as a narrower
    float than it entered. Matching is by path suffix, as the reference's:
    the step's output tree may nest the state under an index."""
    findings = []
    out_items = list(out_dtypes.items())
    for in_path, in_dtype in in_dtypes.items():
        if not is_float(in_dtype):
            continue
        for out_path, out_dtype in out_items:
            if len(out_path) < len(in_path) or tuple(out_path[-len(in_path):]) != tuple(in_path):
                continue
            if is_float(out_dtype) and _size(out_dtype) < _size(in_dtype):
                findings.append(Finding(
                    "RKT403", _prec_path(label), 0,
                    f"state-narrowed: {'/'.join(str(p) for p in in_path)} enters the step as "
                    f"{_name(in_dtype)} but leaves as {_name(out_dtype)} — master weights and "
                    "optimizer state must round-trip at full precision (cast compute "
                    "copies, not the state)",
                ))
    return findings


def check_collective_operands(collectives: Sequence, certified: Sequence[str] = (),
                              label: str = "step") -> list:
    """RKT403 (collective half): a collective whose operand was narrowed
    from a param's master dtype. ``certified`` holds path globs the step
    certifies for low-precision collectives (``prec_audit.
    certify_collectives``); every matching glob is credited, and a glob
    that matched nothing is itself a finding."""
    findings = []
    used: set = set()
    for fact in collectives:
        path = "/".join(fact.param_path)
        matched = [glob for glob in certified if fnmatchcase(path, glob)]
        if matched:
            used.update(matched)
            continue
        findings.append(Finding(
            "RKT403", _prec_path(label), 0,
            f"state-narrowed: collective {fact.prim} moves {path or 'a param'} narrowed "
            f"{_name(fact.master_dtype)}->{_name(fact.dtype)} at {fact.narrowed_at} — "
            "collectives over master state run at the master dtype (or certify the "
            "compression: @certify_collectives('<path glob>'))",
        ))
    for glob in certified:
        if glob in used:
            continue
        findings.append(Finding(
            "RKT403", _prec_path(label), 0,
            f"state-narrowed: certification {glob!r} matched no low-precision collective in "
            "this step — remove the stale certification (certified paths must stay an "
            "exact audit trail, not a blanket suppression)",
        ))
    return findings


def check_cast_churn(churn_count: int, churn_elems: int, max_churn: int = 0,
                     label: str = "step") -> list:
    """RKT404: widen-then-narrow-back round trips (one finding an audit)."""
    if churn_count <= max_churn:
        return []
    return [Finding(
        "RKT404", _prec_path(label), 0,
        f"cast-churn: {churn_count} widen-then-narrow-back cast chains ({churn_elems:,} "
        "elements round-tripped) — e.g. bf16->f32->bf16 with nothing in between; drop the "
        "dead pair or move the f32 work inside the widened window",
    )]


def check_uncast_params(uses: Sequence, compute_dtype, fp32_compute_bytes_min: int = 1 << 16,
                        label: str = "step") -> list:
    """RKT405: f32 master params reaching matmuls uncast while the step
    declares a sub-f32 compute dtype (``prec_audit.ParamUseFact``; an
    operand widened explicitly, or a param narrowed upstream, never makes
    a fact). Params under ``fp32_compute_bytes_min`` are policy, not a
    hazard."""
    if compute_dtype is None or not is_sub32_float(compute_dtype):
        return []
    findings = []
    seen: set = set()
    for use in uses:
        if use.nbytes < fp32_compute_bytes_min or use.param_path in seen:
            continue
        seen.add(use.param_path)
        findings.append(Finding(
            "RKT405", _prec_path(label), 0,
            f"param-never-cast: {'/'.join(use.param_path)} ({use.nbytes / 2**20:.2f} MiB "
            f"f32) feeds {use.prim} uncast under a declared {_name(compute_dtype)} compute "
            "dtype — silent f32 compute; cast at use (w.to(x.dtype)) or widen the "
            "activation explicitly for a deliberate f32 island",
        ))
    return findings
