"""prec_audit: the dtype-flow audit of the mixed-precision convention
(RKT401-406; counterpart of ``rocket_tpu/analysis/prec_audit.py``).

The port's speed rests on bf16 compute; its correctness rests on the
places that must not be bf16: f32 master params cast at use
(``nn/layers.py``), f32 softmax/logsumexp internals, f32 accumulation in
large and grouped matmuls and reductions, and state that round-trips the
step at full precision. None of that shows at a call site.

The reference walks the step's jaxpr. The port runs the step on meta
tensors (shapes and dtypes, no storage, no card) under
:class:`_PrecTracer`, a ``TorchDispatchMode`` that sees every aten op
below autograd (the backward's and a remat's recompute included), every
hand kernel's ``LaunchFact`` and every collective's ``CommFact``
(``ops._launch.record_launches``), and follows a provenance per tensor:

* where it came from (a master param, optimizer/model state, the batch,
  a computed value) and its master dtype there;
* where it was first narrowed below that dtype (the cast-at-use point, as
  ``file:function`` of the Python frame that cast it: the wire sites of
  ``parallel/grad_sync.py`` and ``parallel/collectives.py`` are named
  there, as the reference names its wire scopes);
* whether an explicit cast widened it (a deliberate f32 island) and the
  dtype of the cast before (widen-then-narrow churn).

Casts are ``aten::_to_copy`` and a ``copy_`` between dtypes; views and the
value-preserving ops (``clone``, ``index``, ``embedding``, ``gather``,
``where`` against a constant) carry the provenance; every other op makes
a computed value. The collected facts feed ``rules/prec_rules.py``:

* **RKT401**: an aten GEMM (``mm``, ``addmm``, ``bmm``, ``baddbmm``; its
  bf16 form accumulates in f32 inside cuBLAS, but its split-K partials may
  be reduced in bf16 while ``torch.backends.cuda.matmul.
  allow_bf16_reduced_precision_reduction`` is on: the audit records the
  flag as the trace sees it, the card's setting, and reads such a GEMM as
  a bf16 accumulation), ``_grouped_mm`` and convolutions (f32
  accumulators); the aten reductions (``sum``, ``mean``, ``var``,
  ``_foreach_norm``; torch accumulates them in f32 for half inputs) and
  chains of sub-f32 adds (a sum that really runs in bf16); and each hand
  kernel's declared ``LaunchFact.acc_dtype``;
* **RKT402**: ``exp``/``log``/``_softmax``/``_log_softmax``/``logsumexp``
  on a sub-f32 operand (a half ``_softmax`` asked for an f32 result
  computes in f32);
* **RKT403**: a state leaf leaving the step narrower than it entered (in
  the returned tree, or written in place with a value narrowed below its
  dtype), and a collective moving a param narrowed from its master dtype
  or a value narrowed at a wire site (certified per path glob,
  :func:`certify_collectives`);
* **RKT404** cast churn, **RKT405** an f32 master param reaching a GEMM
  uncast under a sub-f32 compute dtype, **RKT406** the budget
  (``tests/fixtures/torch_budgets/prec/``).

CLI: ``python -m rocket_tpu_torch.analysis prec``. Library entry:
:func:`audit_precision`. A ``# rocketlint: disable=RKT4xx`` comment in the
step function's own source waives that rule for the audit.
"""

from __future__ import annotations

import os
import sys
from dataclasses import dataclass, field, replace
from typing import Any, Callable, Optional, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_flatten_with_path

from rocket_tpu_torch.analysis.rules.prec_rules import (
    TRANSCENDENTAL_OPS,
    check_accumulation,
    check_cast_churn,
    check_collective_operands,
    check_state_dtypes,
    check_transcendentals,
    check_uncast_params,
    is_float,
    is_sub32_float,
)
from rocket_tpu_torch.analysis.trace_audit import _fn_suppressed_rules, _to_meta
from rocket_tpu_torch.ops._launch import CommFact, LaunchFact, dtype_name, record_launches

__all__ = [
    "DtypeFlow",
    "PrecAuditReport",
    "audit_precision",
    "certify_collectives",
    "collect_dtype_flow",
    "PREC_TARGETS",
    "run_prec_target",
]

#: Attribute the certification decorator stores its globs on.
_CERTIFIED_ATTR = "_rocket_certified_collectives"

#: The checkout the package sits in: sites are named relative to it.
_REPO = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_TORCH_DIR = os.path.dirname(os.path.abspath(torch.__file__))


def certify_collectives(*path_globs: str):
    """Certify a step function's deliberate low-precision collectives, per
    path glob (the reference's decorator): a param's path, or a wire site
    ``wire/<module>/<function>`` (``wire/grad_sync/*``: the gradient
    buckets and shards narrowed to the wire dtype). The audit skips RKT403
    for a matching collective and flags a glob that matched nothing."""

    def deco(fn):
        existing = tuple(getattr(fn, _CERTIFIED_ATTR, ()))
        setattr(fn, _CERTIFIED_ATTR, existing + tuple(path_globs))
        return fn

    return deco


#: The tracers' own frames, skipped when naming the code that issued an op.
_INTERNAL = {"__torch_dispatch__", "caller_site", "_op_site", "_cast", "_write", "_dot",
             "_add_chain", "_collective", "note", "record", "_site", "note_draw"}


def caller_site() -> str:
    """``path:function`` of the innermost Python frame outside torch and the
    tracers: the code that issued the current op (the path relative to the
    checkout where it lies inside it)."""
    frame = sys._getframe(1)
    while frame is not None:
        path = os.path.abspath(frame.f_code.co_filename)
        if not (path.startswith(_TORCH_DIR) or "/torch/" in path
                or path.endswith("contextlib.py")
                or (frame.f_code.co_name in _INTERNAL
                    and path.startswith(os.path.join(_REPO, "rocket_tpu_torch")))):
            rel = os.path.relpath(path, _REPO) if path.startswith(_REPO) else \
                os.path.basename(path)
            return f"{rel}:{frame.f_code.co_name}"
        frame = frame.f_back
    return ""


# -- facts the walk collects -----------------------------------------------------------


@dataclass(frozen=True)
class DotFact:
    """One matmul-family op or hand kernel with its accumulator dtype."""

    prim: str                  # the aten op, or the hand kernel's name
    acc_dtype: Any
    contract_size: int         # elements summed per output element
    lhs_shape: Tuple[int, ...]
    rhs_shape: Tuple[int, ...]
    param_path: Tuple[str, ...] = ()
    grouped: bool = False      # grouped products and hand kernels: any size
    why: str = ""              # what set a sub-f32 accumulator


@dataclass(frozen=True)
class ReduceFact:
    prim: str
    dtype: Any                 # the accumulator's dtype
    factor: int                # elements summed per output element


@dataclass(frozen=True)
class TransFact:
    prim: str
    dtype: Any
    shape: Tuple[int, ...]


@dataclass(frozen=True)
class CollectiveFact:
    prim: str
    dtype: Any
    param_path: Tuple[str, ...]
    master_dtype: Any
    narrowed_at: str


@dataclass(frozen=True)
class ParamUseFact:
    prim: str
    param_path: Tuple[str, ...]
    nbytes: int


@dataclass
class DtypeFlow:
    """Everything one trace collected: the rule facts, the byte and cast
    statistics the budget gates, and the cuBLAS reduction flags read."""

    dots: list = field(default_factory=list)
    reduces: list = field(default_factory=list)
    trans: list = field(default_factory=list)
    collectives: list = field(default_factory=list)
    uncast_params: list = field(default_factory=list)
    state_writes: dict = field(default_factory=dict)
    widen_casts: int = 0
    narrow_casts: int = 0
    churn_count: int = 0
    churn_elems: int = 0
    fp32_value_bytes: int = 0
    float_value_bytes: int = 0
    reduced_precision_reduction: dict = field(default_factory=dict)


# -- the provenance lattice ------------------------------------------------------------


@dataclass(frozen=True)
class _Prov:
    """Per-tensor provenance (the reference's ``_Prov``), plus ``chain``:
    the sub-f32 adds this value is the running sum of."""

    dtype: Any
    origin: str = "compute"            # "param" | "state" | "input" | "compute"
    path: Tuple[str, ...] = ()
    master_dtype: Any = None
    narrowed_at: Optional[str] = None
    narrowed_to: Any = None            # the dtype of that first narrowing
    widened_from: Any = None
    cast_from: Any = None
    chain: int = 0


def _compute(t: torch.Tensor) -> _Prov:
    return _Prov(dtype=dtype_name(t.dtype), master_dtype=dtype_name(t.dtype))


def _merge(a: _Prov, b: _Prov) -> _Prov:
    """The reference's ``_merge_provs``: agreement kept, disagreement
    degrades to compute, narrowing sticky."""
    if a == b:
        return a
    same = a.origin == b.origin and a.path == b.path
    return _Prov(dtype=a.dtype, origin=a.origin if same else "compute",
                 path=a.path if same else (),
                 master_dtype=a.master_dtype if a.master_dtype == b.master_dtype else a.dtype,
                 narrowed_at=a.narrowed_at or b.narrowed_at,
                 narrowed_to=a.narrowed_to or b.narrowed_to,
                 widened_from=a.widened_from if a.widened_from == b.widened_from else None,
                 cast_from=a.cast_from if a.cast_from == b.cast_from else None)


def _size(dtype) -> int:
    return torch.empty((), dtype=getattr(torch, dtype)).element_size()


#: Ops that carry their first operand's value (and provenance) besides the
#: views, which are found by their schema: the embedding pick and the other
#: gathers keep the table's provenance, a clone or a pad keeps its source's.
_TRANSPARENT = frozenset({
    "aten::clone", "aten::index", "aten::index_select", "aten::embedding", "aten::gather",
    "aten::flip", "aten::constant_pad_nd", "aten::repeat", "aten::lift_fresh",
    "aten::lift_fresh_copy", "aten::_unsafe_view",
})
#: GEMMs whose operands are (lhs, rhs) at these positions.
_GEMMS = {"aten::mm": (0, 1), "aten::bmm": (0, 1), "aten::addmm": (1, 2),
          "aten::baddbmm": (1, 2), "aten::_grouped_mm": (0, 1)}
_CONVS = frozenset({"aten::convolution", "aten::_convolution", "aten::cudnn_convolution"})
#: Reductions and what torch accumulates them in for each input dtype
#: (``acc_type``: f32 for the half types, on the card and on the CPU).
_REDUCTIONS = frozenset({"aten::sum", "aten::mean", "aten::var", "aten::var_mean",
                         "aten::std", "aten::std_mean", "aten::_foreach_norm", "aten::norm",
                         "aten::linalg_vector_norm", "aten::nansum"})
_ADDS = frozenset({"aten::add", "aten::add_", "aten::sub", "aten::sub_"})
_WHERE = frozenset({"aten::where"})
#: Ops that join several values into one (the reference's cond merge).
_JOINS = frozenset({"aten::cat", "aten::stack"})
#: Python frames whose narrowing casts are deliberate wire compressions.
_WIRE_SITES = {"rocket_tpu_torch/parallel/grad_sync.py:_scatter": ("wire", "grad_sync", "shard"),
               "rocket_tpu_torch/parallel/grad_sync.py:_issue": ("wire", "grad_sync", "bucket"),
               "rocket_tpu_torch/parallel/collectives.py:_narrow": ("wire", "collectives",
                                                                     "ring")}


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _aliases(func) -> bool:
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


def _acc_reduction_flag(dtype: str) -> tuple:
    """``(accumulator dtype, why)`` of an aten GEMM whose result is
    ``dtype``, as cuBLAS runs it under the current reduction flags."""
    matmul = torch.backends.cuda.matmul
    if dtype == "bfloat16" and matmul.allow_bf16_reduced_precision_reduction:
        return "bfloat16", ("cuBLAS may reduce its split-K partials in bfloat16 "
                            "(allow_bf16_reduced_precision_reduction=True)")
    if dtype == "float16" and matmul.allow_fp16_reduced_precision_reduction:
        return "float16", ("cuBLAS may reduce its split-K partials in float16 "
                           "(allow_fp16_reduced_precision_reduction=True)")
    return "float32", ""


class _PrecTracer(TorchDispatchMode):
    """Follows provenance through a step run on meta tensors (module
    docstring). ``provs`` keys each tensor by identity and holds it, so
    no id is reused within the step."""

    def __init__(self, flow: DtypeFlow, compute_dtype: Optional[str]) -> None:
        super().__init__()
        self.flow = flow
        self.compute_dtype = compute_dtype
        self.provs: dict = {}
        self.leaf_storage: dict = {}   # storage key -> (path, dtype) of a param/state leaf
        self._keep: list = []
        self._chain_max: dict = {}     # chain root -> (length, dtype)

    # -- plumbing --------------------------------------------------------------------

    def seed(self, t: torch.Tensor, origin: str, path: Tuple[str, ...] = ()) -> None:
        name = dtype_name(t.dtype)
        self.provs[id(t)] = _Prov(dtype=name, origin=origin, path=tuple(path), master_dtype=name)
        self._keep.append(t)
        if origin in ("param", "state"):
            self.leaf_storage[_storage(t)] = (tuple(path), name)

    def read(self, t) -> _Prov:
        if not isinstance(t, torch.Tensor):
            return _Prov(dtype=None)
        return self.provs.get(id(t)) or _compute(t)

    def set(self, t: torch.Tensor, prov: _Prov) -> None:
        self._keep.append(t)
        self.provs[id(t)] = replace(prov, dtype=dtype_name(t.dtype))

    def _count(self, outs) -> None:
        for t in outs:
            if t.is_floating_point():
                nbytes = t.numel() * t.element_size()
                self.flow.float_value_bytes += nbytes
                if t.element_size() >= 4:
                    self.flow.fp32_value_bytes += nbytes

    # -- handlers --------------------------------------------------------------------

    def _cast(self, src: _Prov, dst_dtype: str, numel: int) -> _Prov:
        narrowed_at, narrowed_to, widened_from = src.narrowed_at, src.narrowed_to, None
        if is_float(src.dtype) and is_float(dst_dtype):
            s, d = _size(src.dtype), _size(dst_dtype)
            if d < s:
                self.flow.narrow_casts += 1
                master = src.master_dtype if is_float(src.master_dtype) else src.dtype
                if narrowed_at is None and d < _size(master):
                    narrowed_at = f"aten::_to_copy@{caller_site()}"
                    narrowed_to = dst_dtype
                if (src.cast_from is not None and src.widened_from is not None
                        and src.cast_from == dst_dtype):
                    self.flow.churn_count += 1
                    self.flow.churn_elems += numel
            elif d > s:
                self.flow.widen_casts += 1
                widened_from = src.dtype
        return _Prov(dtype=dst_dtype, origin=src.origin, path=src.path,
                     master_dtype=src.master_dtype or src.dtype, narrowed_at=narrowed_at,
                     narrowed_to=narrowed_to, widened_from=widened_from, cast_from=src.dtype)

    def _dot(self, name: str, args, out) -> None:
        if name in _CONVS:
            # Each output sums (in channels / groups) x kernel window terms,
            # in an f32 accumulator in cuDNN for every input dtype.
            lhs, rhs = args[0], args[1]
            contract = _numel(rhs.shape[1:]) if rhs.dim() > 1 else 1
            grouped, acc, why = False, "float32", ""
        else:
            i, j = _GEMMS[name]
            lhs, rhs = args[i], args[j]
            contract = int(lhs.shape[-1])
            grouped = name == "aten::_grouped_mm"
            out_dtype = dtype_name(out.dtype)
            acc, why = ("float32", "") if grouped else _acc_reduction_flag(out_dtype)
        provs = [self.read(lhs), self.read(rhs)]
        param_path = next((p.path for p in provs if p.origin == "param" and p.path), ())
        self.flow.dots.append(DotFact(name, acc, contract, tuple(lhs.shape), tuple(rhs.shape),
                                      param_path, grouped, why))
        if self.compute_dtype is None or not is_sub32_float(self.compute_dtype):
            return
        for k, (prov, t) in enumerate(zip(provs, (lhs, rhs))):
            if prov.origin != "param" or prov.narrowed_at is not None:
                continue
            if not is_float(prov.dtype) or _size(prov.dtype) < 4:
                continue
            if provs[1 - k].widened_from is not None:
                continue
            self.flow.uncast_params.append(ParamUseFact(name, prov.path,
                                                        t.numel() * t.element_size()))

    def _add_chain(self, name: str, args, out: torch.Tensor) -> _Prov:
        """A sub-f32 add continues the running sum of the operand with the
        longer chain (a Python ``acc = acc + x`` loop, or ``add_`` into one
        buffer): one more element summed per output."""
        a, b = self.read(args[0]), self.read(args[1]) if len(args) > 1 else _Prov(None)
        if not is_sub32_float(dtype_name(out.dtype)):
            return _compute(out)
        base = a if a.chain >= b.chain else b
        chain = base.chain + 1
        root = base.path if base.chain else ("chain", id(out))
        prev = self._chain_max.get(root, (0, None))
        if chain > prev[0]:
            self._chain_max[root] = (chain, dtype_name(out.dtype))
        return _Prov(dtype=dtype_name(out.dtype), path=root, chain=chain)

    def _collective(self, fact: CommFact, inputs) -> None:
        floor = _size(self.compute_dtype) if self.compute_dtype else 4
        for t in inputs:
            prov = self.read(t)
            if prov.narrowed_at is None:
                continue
            if prov.origin == "param":
                path = prov.path
            else:
                site = prov.narrowed_at.split("@", 1)[-1]
                wire = _WIRE_SITES.get(site)
                if wire is None and not (is_float(prov.dtype) and _size(prov.dtype) < floor):
                    continue
                path = wire or ("wire", site)
            self.flow.collectives.append(CollectiveFact(
                fact.kind, prov.narrowed_to or prov.dtype, tuple(path), prov.master_dtype,
                prov.narrowed_at))

    def note(self, facts, inputs, outputs) -> None:
        """A hand kernel's or a collective's meta route (``ops._launch.record``)."""
        for fact in facts:
            if isinstance(fact, LaunchFact):
                self.flow.dots.append(DotFact(fact.name, fact.acc_dtype, 0, (), (), (), True,
                                              "the hand kernel's declared accumulator"))
            elif isinstance(fact, CommFact):
                self._collective(fact, inputs)
        for t in outputs:
            self.set(t, _compute(t))

    # -- the dispatch ----------------------------------------------------------------

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func._schema.name
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if not outs:
            return out
        if name == "aten::_to_copy" or (name == "aten::copy_" and args[0].dtype != args[1].dtype):
            src_t = args[0] if name == "aten::_to_copy" else args[1]
            dst = outs[0]
            src = self.read(src_t)
            if src_t.dtype == dst.dtype:
                prov = src
            else:
                prov = self._cast(src, dtype_name(dst.dtype), dst.numel())
                self._count([dst])
            self._write(name, args, dst, prov)
            return out
        if name == "aten::copy_":
            self._write(name, args, outs[0], self.read(args[1]))
            return out
        if _aliases(func) or name in _TRANSPARENT:
            src = self.read(args[0]) if args and isinstance(args[0], torch.Tensor) else None
            for t in outs:
                self.set(t, src if src is not None else _compute(t))
            return out
        self._count(outs)
        joined = (_tensors(args[0]) if name in _JOINS else
                  [v for v in args[1:] if isinstance(v, torch.Tensor)]
                  if name in _WHERE and len(args) == 3 else [])
        if joined:
            # A select merges its value operands (operand 0 is the
            # predicate), a join its pieces: disagreement degrades to
            # compute but a narrowing on any side survives, and masking a
            # param against a constant keeps the param's identity.
            values = [self.read(v) for v in joined]
            interesting = [p for p in values if p.origin in ("param", "state") or p.narrowed_at]
            merged = interesting[0] if len(interesting) == 1 else values[0]
            if len(interesting) != 1:
                for other in values[1:]:
                    merged = _merge(merged, other)
            self.set(outs[0], merged)
            return out
        if name in _GEMMS or name in _CONVS:
            self._dot(name, args, outs[0])
        elif name in _REDUCTIONS:
            for t in outs:
                if t.is_floating_point():
                    ins = _tensors(args[:1])
                    numel = sum(x.numel() for x in ins)
                    # torch's acc_type: f32 for the half types, else the dtype.
                    self.flow.reduces.append(ReduceFact(
                        name, "float32" if t.element_size() <= 4 else dtype_name(t.dtype),
                        max(1, numel // max(1, sum(o.numel() for o in outs)))))
                    break
        elif name in TRANSCENDENTAL_OPS:
            half_to_float = name in ("aten::_softmax", "aten::_log_softmax") and bool(args[2])
            x = args[0]
            self.flow.trans.append(TransFact(
                name, "float32" if half_to_float else dtype_name(x.dtype), tuple(x.shape)))
        elif name in _ADDS and isinstance(args[0], torch.Tensor) and \
                len(args) > 1 and isinstance(args[1], torch.Tensor) and \
                tuple(args[0].shape) == tuple(outs[0].shape):
            prov = self._add_chain(name, args, outs[0])
            self.set(outs[0], prov)
            return out
        mutated = func._schema.is_mutable
        for t in outs:
            prior = self.provs.get(id(t))
            if mutated and prior is not None and prior.origin in ("param", "state"):
                continue  # an in-place update keeps the leaf a leaf
            self.set(t, _compute(t))
        return out

    def _write(self, name, args, dst, prov: _Prov) -> None:
        """``dst`` now holds a value of provenance ``prov``; an in-place
        write into a param or state leaf of a value narrowed below the
        leaf's dtype is a state narrowing (RKT403)."""
        if name == "aten::copy_":
            leaf = self.leaf_storage.get(_storage(dst))
            if leaf is not None:
                path, leaf_dtype = leaf
                written = prov.narrowed_to or prov.dtype
                if is_float(written) and _size(written) < _size(leaf_dtype):
                    self.flow.state_writes[path] = written
                self.set(dst, replace(self.read(dst), narrowed_at=prov.narrowed_at,
                                      narrowed_to=prov.narrowed_to)
                         if prov.narrowed_at else self.read(dst))
                return
        self.set(dst, prov)


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()._cdata
    except (RuntimeError, NotImplementedError):
        return id(t)


def _path_names(key_path) -> Tuple[str, ...]:
    names = []
    for k in key_path:
        for attr in ("key", "idx", "name"):
            if hasattr(k, attr):
                names.append(str(getattr(k, attr)))
                break
        else:
            names.append(str(k))
    return tuple(names)


def collect_dtype_flow(step_fn: Callable, variables, batch, compute_dtype=None,
                       device_kind: Optional[str] = None) -> tuple:
    """Run ``step_fn(variables, batch)`` on meta tensors (any other tensor
    is replaced by a meta one of its shape, dtype and ``requires_grad``)
    and follow its dtypes. Returns ``(flow, in_dtypes, out_dtypes)``: the
    dtype maps are path-keyed over ``variables`` (``params/...`` and
    ``state/...``; a tree without those keys is all params) and over what
    the step returns, with the leaves it wrote in place holding the dtype
    their written value was narrowed to."""
    from rocket_tpu_torch.analysis.sched_audit import DEFAULT_DEVICE_KIND
    from rocket_tpu_torch.tune import priced_device_kind

    variables, batch = _to_meta((variables, batch))
    compute = dtype_name(compute_dtype) if compute_dtype is not None else None
    flow = DtypeFlow()
    matmul = torch.backends.cuda.matmul
    flow.reduced_precision_reduction = {
        "bf16": bool(matmul.allow_bf16_reduced_precision_reduction),
        "fp16": bool(matmul.allow_fp16_reduced_precision_reduction)}
    tracer = _PrecTracer(flow, compute)
    in_dtypes: dict = {}
    split = isinstance(variables, dict) and "params" in variables
    for key_path, leaf in tree_flatten_with_path(variables)[0]:
        if not isinstance(leaf, torch.Tensor):
            continue
        path = _path_names(key_path)
        origin = "param" if not split or path[0] == "params" else "state"
        tracer.seed(leaf, origin, path)
        in_dtypes[path] = dtype_name(leaf.dtype)
    for leaf in _tensors(batch):
        tracer.seed(leaf, "input")
    with priced_device_kind(device_kind or DEFAULT_DEVICE_KIND), \
            record_launches(sink=tracer), tracer:
        result = step_fn(variables, batch)
    for root, (length, dtype) in tracer._chain_max.items():
        flow.reduces.append(ReduceFact("add-chain", dtype, length + 1))
    out_dtypes = {_path_names(kp): dtype_name(leaf.dtype)
                  for kp, leaf in tree_flatten_with_path(result)[0]
                  if isinstance(leaf, torch.Tensor)}
    out_dtypes.update({("<written>",) + path: dtype for path, dtype in flow.state_writes.items()})
    return flow, in_dtypes, out_dtypes


@dataclass
class PrecAuditReport:
    """Findings plus the numerics record the budget gate reads."""

    label: str
    findings: list = field(default_factory=list)
    flow: Optional[DtypeFlow] = None
    record: dict = field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return not self.findings


def audit_precision(step_fn: Callable, variables, batch, *, compute_dtype=None,
                    dot_contract_min: int = 2048, reduce_factor_min: int = 4096,
                    fp32_compute_bytes_min: int = 1 << 16, max_cast_churn: int = 0,
                    check_state: bool = True, certified_collectives: Tuple[str, ...] = (),
                    label: str = "step") -> PrecAuditReport:
    """Audit the dtype flow of ``step_fn(variables, batch)`` (the
    reference's signature and thresholds). ``compute_dtype`` declares the
    step's activation dtype (RKT405 fires only under a sub-f32 one);
    ``check_state=False`` skips the state half of RKT403 (an eval step).
    Certified collectives merge from ``certified_collectives`` and the
    :func:`certify_collectives` decorator. Meta tensors only: no FLOPs, no
    device."""
    suppressed = _fn_suppressed_rules(step_fn, prefix="RKT4")
    certified = tuple(certified_collectives) + tuple(getattr(step_fn, _CERTIFIED_ATTR, ()))
    flow, in_dtypes, out_dtypes = collect_dtype_flow(step_fn, variables, batch,
                                                     compute_dtype=compute_dtype)
    findings = check_accumulation(flow.dots, flow.reduces, dot_contract_min=dot_contract_min,
                                  reduce_factor_min=reduce_factor_min, label=label)
    findings += check_transcendentals(flow.trans, label=label)
    if check_state:
        findings += check_state_dtypes(in_dtypes, out_dtypes, label=label)
    findings += check_collective_operands(flow.collectives, certified=certified, label=label)
    findings += check_cast_churn(flow.churn_count, flow.churn_elems, max_churn=max_cast_churn,
                                 label=label)
    findings += check_uncast_params(flow.uncast_params, compute_dtype,
                                    fp32_compute_bytes_min=fp32_compute_bytes_min, label=label)
    if suppressed:
        findings = [f for f in findings if f.rule not in suppressed]
    total = max(1, flow.float_value_bytes)
    record = {
        "fp32_bytes_fraction": round(flow.fp32_value_bytes / total, 4),
        "fp32_value_bytes": int(flow.fp32_value_bytes),
        "float_value_bytes": int(flow.float_value_bytes),
        "widen_casts": int(flow.widen_casts),
        "narrow_casts": int(flow.narrow_casts),
        "cast_churn": int(flow.churn_count),
        "compute_dtype": dtype_name(compute_dtype) if compute_dtype is not None else None,
        # Context, not a gate: the low-precision collectives this step certifies.
        "certified_collectives": len(certified),
        "bf16_reduced_precision_reduction": flow.reduced_precision_reduction["bf16"],
    }
    return PrecAuditReport(label=label, findings=findings, flow=flow, record=record)


# -- the targets: the reference's, built on the port's steps ---------------------------


@dataclass(frozen=True)
class PrecTarget:
    """One configuration the CLI audits: ``build() -> (step_fn, variables,
    batch, check_state)``. The names pair with the other audits' (the
    reference's); the precision walk is mesh-independent, so they differ
    by what they run: unrolled or ``scan_layers`` blocks, the GPT-2 layer
    set or the Llama one, train or eval."""

    name: str
    build: Callable[[], tuple]
    compute_dtype: Any = torch.bfloat16
    demo: bool = False
    doc: str = ""


def _as_variables(step, args, certs=()):
    """A ``sched_audit`` builder's ``(step, (local params, tokens))`` in the
    reference's ``step(variables, batch)`` form."""

    def step_fn(variables, batch):
        return step(variables["params"], batch)

    if certs:
        step_fn = certify_collectives(*certs)(step_fn)
    local, tokens = args
    return step_fn, {"params": local, "state": {}}, tokens


def _bf16_train_parts(mesh, rule, certs=(), train=True, **overrides):
    """The audit LM in bf16 compute at ``mesh``, one rank's step as the
    schedule, shard and memory audits build it (``sched_audit.
    _parallel_lm_parts``), so this audit walks the program they price and
    sees its wire narrows. ``certs``: the compressions the wiring makes
    for this configuration (the reference's): the vocab-parallel lookup
    narrows the f32 master table into its reduce-scatter under tensor
    parallelism, the FSDP gradient wire its buckets and shards."""
    from rocket_tpu_torch.analysis.sched_audit import _lm_config, _parallel_lm_parts

    config = _lm_config(activation_dtype="bfloat16", **overrides)
    step, args = _parallel_lm_parts(mesh, rule, train=train, config=config)
    return (*_as_variables(step, args, certs), train)


def _tp_parts():
    from rocket_tpu_torch.parallel.sharding import gpt2_tp_rules

    return _bf16_train_parts({"data": 2, "model": 4}, gpt2_tp_rules(axis="model"),
                             certs=("params/wte/table",))


def _scan_parts():
    """The reference's ``tp_1x8`` precision target traces ``scan_layers``
    blocks: the port's per-block remat under ``scan_layers``."""
    from rocket_tpu_torch.parallel.sharding import gpt2_tp_rules

    return _bf16_train_parts({"data": 1, "model": 8}, gpt2_tp_rules(axis="model"),
                             certs=("params/wte/table",), scan_layers=True)


def _gpt2_layerset_parts():
    from rocket_tpu_torch.parallel.sharding import fsdp_rules

    return _bf16_train_parts({"data": 8}, fsdp_rules(axis="data", min_size=4096),
                             certs=("wire/grad_sync/*",), pos_embedding="learned",
                             norm="layernorm", mlp="gelu", tied_embeddings=True)


def _eval_parts():
    from rocket_tpu_torch.parallel.sharding import gpt2_tp_rules

    return _bf16_train_parts({"data": 2, "model": 4}, gpt2_tp_rules(axis="model"),
                             certs=("params/wte/table",), train=False)


def _badprec_parts():
    """The seeded-bad step, the reference's five faults in torch: a bf16
    GEMM over a 4096-long contraction whose split-K partials cuBLAS may
    reduce in bf16 (RKT401, read with the reduction flag on, torch's
    default), a bf16 softmax (RKT402), EMA state narrowed to bf16 on the way
    out (RKT403), a bf16->f32->bf16 round trip (RKT404), and an 8 MiB f32
    param fed to a matmul uncast (RKT405)."""
    meta = torch.device("meta")
    variables = {
        "params": {"w_big": torch.empty(4096, 256, device=meta),
                   "emb": torch.empty(4096, 512, device=meta)},
        "state": {"ema": torch.empty(4096, 256, device=meta)},
    }
    batch = {"x": torch.empty(8, 4096, dtype=torch.bfloat16, device=meta),
             "x32": torch.empty(8, 4096, device=meta)}

    def bad_step(variables, batch):
        p = variables["params"]
        h = batch["x"] @ p["w_big"].to(torch.bfloat16)                  # RKT401
        probs = torch.softmax(h, dim=-1)                                 # RKT402
        churn = h.float().to(torch.bfloat16)                             # RKT404
        z = batch["x32"] @ p["emb"]                                      # RKT405
        ema = (0.9 * variables["state"]["ema"]
               + 0.1 * (batch["x32"].t() @ h.float())).to(torch.bfloat16)  # RKT403
        loss = probs.float().mean() + churn.float().mean() + z.mean()
        return {"params": p, "state": {"ema": ema}}, loss

    return bad_step, variables, batch, True


def _with_reduced_reduction(build):
    """``build`` traced with cuBLAS's bf16 reduced-precision reduction on,
    whatever the process set: the demo's RKT401 is seeded on it."""
    def wrapped():
        step_fn, variables, batch, check_state = build()

        def step(variables, batch):
            matmul = torch.backends.cuda.matmul
            previous = matmul.allow_bf16_reduced_precision_reduction
            matmul.allow_bf16_reduced_precision_reduction = True
            try:
                return step_fn(variables, batch)
            finally:
                matmul.allow_bf16_reduced_precision_reduction = previous

        return step, variables, batch, check_state
    return wrapped


#: name -> target. The default sweep runs the non-demo entries.
PREC_TARGETS: dict = {target.name: target for target in (
    PrecTarget("tp_2x4", _tp_parts, doc="audit LM bf16 train step, one rank of data 2 x model 4"),
    PrecTarget("tp_1x8", _scan_parts, doc="audit LM bf16 train step under scan_layers, one "
               "rank of model 8"),
    PrecTarget("fsdp_1x8", _gpt2_layerset_parts, doc="GPT-2 layer set (learned positions, "
               "layernorm, gelu, tied) bf16 train step, one rank of 8 FSDP ranks"),
    PrecTarget("tp_2x4_eval", _eval_parts, doc="audit LM bf16 eval forward, one rank of "
               "data 2 x model 4"),
    PrecTarget("badprec", _with_reduced_reduction(_badprec_parts), demo=True,
               doc="seeded-bad: RKT401-405, one of each"),
)}


def run_prec_target(target: PrecTarget) -> PrecAuditReport:
    step_fn, variables, batch, check_state = target.build()
    return audit_precision(step_fn, variables, batch, compute_dtype=target.compute_dtype,
                           check_state=check_state, label=target.name)


def render_prec(label: str, record) -> str:
    """One line of a target's numerics record."""
    return (f"{label}: f32 bytes {record['fp32_bytes_fraction']:.4f} of "
            f"{record['float_value_bytes']:,} B, {record['narrow_casts']} narrow / "
            f"{record['widen_casts']} widen casts, churn {record['cast_churn']}, "
            f"{record['certified_collectives']} certified collective glob(s), bf16 "
            f"reduced-precision reduction {record['bf16_reduced_precision_reduction']}")
