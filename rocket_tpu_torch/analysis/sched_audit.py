"""The schedule audit for Hopper: a roofline cost model of a whole step and
the kernel-launch check (counterpart of ``rocket_tpu/analysis/
sched_audit.py``).

The reference parses the scheduled HLO of a step compiled on a fake CPU
mesh. The port has no compiler between the program and the card: eager
PyTorch issues one kernel per aten op, in program order, so the program
IS the schedule. The step therefore runs on ``meta`` tensors — torch's
abstract tensors, shapes and dtypes with no storage, so a full-width
GPT-2 train step traces on the CPU in about a second and needs no card —
under :class:`StepTracer`, a ``TorchDispatchMode`` that records every aten
op in dispatch order, every hand kernel's ``LaunchFact`` (each wrapper's
meta route, ``ops/_launch.py``) and every collective's ``CommFact`` (the
meta route of ``parallel.collectives.collective``), and follows which op
produced each tensor (the dataflow the overlap simulation needs).

:func:`cost_ops` prices each traced op against the card
(``utils.perf.device_spec``), the counterpart of the reference's
``cost_ops`` (``:418``):

* an aten op: its FLOPs from ``torch.utils.flop_counter``'s registered
  formulas (matmuls, convolutions, attention; 0 for the rest: the
  reference's 1-FLOP-per-element estimate for elementwise fusions prices
  nothing and would only pad the MFU numerator) at the bf16 or f32 peak
  by its operands' dtype, and its HBM bytes, each tensor it reads and
  writes once. Views, ``detach``, allocations and other ops that launch
  no kernel are free (:data:`FREE_OPS`, the counterpart of
  ``_FREE_OPS``), and so is an op whose tensors all live on the host.
  Eager PyTorch does not fuse, so each elementwise op pays its own read
  and write: that is the truth of the port, not a flaw of the model;
* a hand kernel: its ``LaunchFact``'s ``flops`` (at its ``flop_dtype``'s
  peak) and ``bytes``, the same count as PERF.md's bound column;
* a collective: its ``CommFact``'s bytes over the card's NVLink
  (``DeviceSpec.link_bw``) plus ``DeviceSpec.collective_latency_s``.
  A collective whose wait comes later (``overlapped``: a gradient bucket,
  a gather issued before the forward) is an async ``-start`` for the
  simulation, a ring hop a ``collective-permute``; any other blocks the
  compute stream until it is done.

:func:`simulate` (the as-issued and the ideal-overlap runs) and
:func:`_simulate_dataflow` are the reference's (``:563``, ``:652``),
unchanged. :func:`predict` is ``predict_compiled`` (``:863``): the
predicted step time, its split into compute, memory and exposed
communication, and the predicted MFU. :func:`audit_schedule` (``:959``)
keeps the kernel-launch leg (RKT504 over the launches) and adds the
roofline legs, RKT501-503 and RKT505 (``rules/sched_rules.py``); RKT506
diffs the record against ``tests/fixtures/torch_budgets/sched/``
(``analysis/__main__.py``).

The numbers are a cost model, not a clock: good enough to rank steps,
attribute time and gate regressions. ``analysis/calib.py`` holds them to a
measured trace of the same step on the card.

``python -m rocket_tpu_torch.analysis sched`` audits the non-demo
:data:`SCHED_TARGETS`, each at the shapes ``chip_smoke.py`` runs it on the
card (the train targets as the whole step its ``train`` phase takes), and
the reference's multi-rank roofline targets as one rank's program at the
stated world, the ``CommFact`` s standing in for the group. The demos
(``badsched``, ``badoverlap``, ``badpallas``) run only when named.
"""

from __future__ import annotations

import contextlib
from dataclasses import dataclass, field
from typing import Any, Callable, Mapping, Optional, Sequence, Tuple

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten

from rocket_tpu_torch.analysis.rules.sched_rules import (
    check_convoys,
    check_exposed_comm,
    check_launches,
    check_memory_bound,
    check_mfu_floor,
    check_numerics_declared,
)
from rocket_tpu_torch.ops._launch import CommFact, LaunchFact, record_launches
from rocket_tpu_torch.utils.perf import device_spec

__all__ = [
    "DEFAULT_DEVICE_KIND", "FREE_OPS", "OpCost", "SimResult", "StepTracer", "TracedOp",
    "SchedAuditReport", "SchedTarget", "SCHED_TARGETS", "audit_schedule", "collect_launch_facts",
    "cost_ops", "predict", "run_sched_target", "simulate", "trace_step",
]

#: The card the audit prices against unless told otherwise: the card
#: ``chip_smoke.py`` runs on.
DEFAULT_DEVICE_KIND = "NVIDIA H100 80GB HBM3"

#: Allocations: they launch no kernel, and what they return comes from no op.
_ALLOCATIONS = frozenset({"aten::empty", "aten::empty_strided", "aten::empty_like",
                          "aten::new_empty", "aten::new_empty_strided"})
#: Aten ops that launch no kernel: the allocations, the views whose schema
#: declares no alias (every op whose schema returns an alias of an input is
#: free besides), storage plumbing and host reads.
FREE_OPS = _ALLOCATIONS | {"aten::_unsafe_view", "aten::_local_scalar_dense", "aten::set_",
                           "aten::resize_"}

#: CommFact kind -> the reference's collective opcode.
_COMM_OPCODES = {"all_gather": "all-gather", "all_to_all": "all-to-all",
                 "all_reduce": "all-reduce", "send_recv": "collective-permute"}

_HALF = ("bfloat16", "float16")


def _spec(device_kind: str):
    spec = device_spec(device_kind)
    if spec is None:
        raise ValueError(f"sched_audit: unknown device kind {device_kind!r}; add it to "
                         "rocket_tpu_torch.utils.perf.DEVICE_SPECS")
    return spec


# -- the trace -------------------------------------------------------------------------


@dataclass
class TracedOp:
    """One op of a traced step, device-independent: ``name`` is its join
    key, the op and its ordinal among the step's priced ops of that op
    (``"aten::mm#17"``, ``"flash_fwd#3"``); ``opcode`` the aten op, the
    kernel's ``LaunchFact`` name or the collective's opcode; ``flops`` and
    ``nbytes`` its work, ``flop_dtype`` the dtype whose peak its flops run
    at; ``operands`` the names of the ops that produced what it reads;
    ``comm`` its ``CommFact`` for a collective."""

    name: str
    opcode: str
    flops: float
    nbytes: int
    flop_dtype: str = "float32"
    operands: Tuple[str, ...] = ()
    comm: Optional[CommFact] = None
    where: str = ""


def _tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0] if isinstance(t, torch.Tensor)]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _aliases(func) -> bool:
    """Whether ``func`` returns a view of an input (its schema annotates a
    returned alias that it does not write)."""
    return any(r.alias_info is not None and not r.alias_info.is_write
               for r in func._schema.returns)


class StepTracer(TorchDispatchMode):
    """Records a step run on meta tensors (module docstring): ``ops``, the
    :class:`TracedOp` s in issue order, and ``launches``, the hand
    kernels' ``LaunchFact`` s in launch order (the kernel-launch leg's
    input). Use through :func:`trace_step`."""

    def __init__(self) -> None:
        super().__init__()
        self.ops: list = []
        self.launches: list = []
        self._producer: dict = {}
        self._keep: list = []     # every traced tensor, so no id is reused
        self._count: dict = {}

    def _name(self, opcode: str) -> str:
        k = self._count.get(opcode, 0)
        self._count[opcode] = k + 1
        return f"{opcode}#{k}"

    def _deps(self, tensors) -> tuple:
        names = []
        for t in tensors:
            name = self._producer.get(id(t))
            if name is not None and name not in names:
                names.append(name)
        return tuple(names)

    def _produce(self, tensors, name: Optional[str]) -> None:
        for t in tensors:
            self._keep.append(t)
            if name is None:
                self._producer.pop(id(t), None)
            else:
                self._producer[id(t)] = name

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        ins, outs = _tensors((args, kwargs)), _tensors(out)
        if all(t.device.type == "cpu" for t in ins + outs):
            return out  # host arithmetic: no kernel
        opcode = func._schema.name
        if opcode in FREE_OPS or _aliases(func):
            # A view carries its base's producer; a fresh allocation none.
            base = () if opcode in _ALLOCATIONS else self._deps(ins[:1])
            self._produce(outs, base[0] if base else None)
            return out
        written = outs
        if func._schema.is_mutable and not outs and args and isinstance(args[0], (list, tuple)):
            written = [t for t in args[0] if isinstance(t, torch.Tensor)]  # in-place foreach
        flops, dtype = _flops(func, args, kwargs, out, ins)
        nbytes = (sum(_nbytes(t) for t in {id(t): t for t in ins}.values())
                  + sum(_nbytes(t) for t in {id(t): t for t in written}.values()))
        name = self._name(opcode)
        self.ops.append(TracedOp(name, opcode, flops, nbytes, dtype, self._deps(ins)))
        self._produce(written, name)
        return out

    def note(self, facts, inputs, outputs) -> None:
        """A kernel wrapper's or a collective's meta route (``ops._launch.
        record``): one op per fact, each depending on the one before it, the
        first on what ``inputs`` came from; ``outputs`` come from the last."""
        deps = self._deps(inputs)
        name = None
        for fact in facts:
            if isinstance(fact, LaunchFact):
                self.launches.append(fact)
                opcode = fact.name
                op = TracedOp("", opcode, fact.flops, fact.bytes, fact.flop_dtype, deps)
            else:
                opcode = _COMM_OPCODES.get(fact.kind, fact.kind)
                if fact.overlapped and fact.kind != "send_recv":
                    opcode += "-start"
                op = TracedOp("", opcode, 0.0, 0, "float32", deps, comm=fact, where=fact.axis)
            name = op.name = self._name(opcode)
            self.ops.append(op)
            deps = (name,)
        self._produce(outputs, name)


def _flops(func, args, kwargs, out, ins) -> tuple:
    """``(flops, dtype name)`` of an aten op by ``torch.utils.flop_counter``'s
    registered formula (0 for an op without one), the dtype of its first
    floating operand."""
    from torch.utils.flop_counter import flop_registry

    dtype = next((str(t.dtype).removeprefix("torch.") for t in ins if t.is_floating_point()),
                 "float32")
    formula = flop_registry.get(func._overloadpacket)
    if formula is None:
        return 0.0, dtype
    try:
        return float(formula(*args, **kwargs, out_val=out)), dtype
    except Exception:  # a formula that cannot read these arguments prices nothing
        return 0.0, dtype


def trace_step(step_fn: Callable, *args, device_kind: str = DEFAULT_DEVICE_KIND) -> StepTracer:
    """Run ``step_fn(*args)`` (meta tensors in ``args``) under a
    :class:`StepTracer`, tune-table lookups resolving as on ``device_kind``
    (``tune.priced_device_kind``), and return the tracer."""
    from rocket_tpu_torch.tune import priced_device_kind

    _spec(device_kind)
    tracer = StepTracer()
    with priced_device_kind(device_kind), record_launches(sink=tracer), tracer:
        step_fn(*args)
    return tracer


def collect_launch_facts(step_fn: Callable, *args, device_kind: str = DEFAULT_DEVICE_KIND) -> list:
    """Run ``step_fn(*args)`` (meta tensors in ``args``) and return the
    facts of every kernel launch it would make on ``device_kind``, in
    launch order."""
    return trace_step(step_fn, *args, device_kind=device_kind).launches


# -- per-op roofline costs -----------------------------------------------------------


@dataclass
class OpCost:
    """One op with its roofline cost attribution (the reference's fields)."""

    name: str
    opcode: str
    kind: str            # "compute" | "memory" | "comm" | "free"
    time_s: float
    flops: float
    hbm_bytes: int
    comm_bytes: int      # bytes a rank sends for a collective, else 0
    is_comm: bool
    operands: Tuple[str, ...]
    where: str = ""
    is_dcn: bool = False  # the reference's cross-slice flag: no slices here

    @property
    def intensity(self) -> float:
        return self.flops / self.hbm_bytes if self.hbm_bytes else 0.0


def cost_ops(ops: Sequence[TracedOp], spec) -> list:
    """Roofline-cost every traced op on the card ``spec`` (module
    docstring): ``max(flops / peak, bytes / hbm_bw)``, the binding resource
    deciding compute- or memory-bound; a collective's bytes over the
    NVLink rate plus the collective latency."""
    out = []
    for op in ops:
        if op.comm is not None:
            nbytes = int(op.comm.bytes)
            out.append(OpCost(op.name, op.opcode, "comm",
                              nbytes / spec.link_bw + spec.collective_latency_s, 0.0, 0, nbytes,
                              True, op.operands, op.where))
            continue
        peak = spec.flops_bf16 if op.flop_dtype in _HALF else spec.flops_f32
        t_flops, t_mem = op.flops / peak, op.nbytes / spec.hbm_bw
        out.append(OpCost(op.name, op.opcode, "compute" if t_flops >= t_mem else "memory",
                          max(t_flops, t_mem), op.flops, op.nbytes, 0, False, op.operands,
                          op.where))
    return out


# -- the two-stream schedule simulation --------------------------------------


@dataclass
class SimResult:
    """One simulation pass over the scheduled ops."""

    makespan_s: float
    compute_bound_s: float   # compute-stream time on MXU-bound ops
    memory_bound_s: float    # compute-stream time on HBM-bound ops
    comm_total_s: float      # total collective time (both passes agree)
    exposed_comm_s: float    # collective time with the compute stream idle
    stall_s: float           # compute idle not explained by communication
    ops: list = field(default_factory=list)


def _interval_overlap(a: list, b: list) -> float:
    """Total overlap between two sorted, non-overlapping interval lists."""
    total, i, j = 0.0, 0, 0
    while i < len(a) and j < len(b):
        lo = max(a[i][0], b[j][0])
        hi = min(a[i][1], b[j][1])
        if hi > lo:
            total += hi - lo
        if a[i][1] <= b[j][1]:
            i += 1
        else:
            j += 1
    return total


def simulate(ops: Sequence[OpCost], *, overlap: bool) -> SimResult:
    """Simulate the schedule on a compute stream + a collective stream (the
    reference's, ``:563``, unchanged).

    ``overlap=False`` prices the step as issued: ops run in issue order
    and a synchronous collective blocks the compute stream until it
    completes (a collective waited on at once); async ``-start`` ops (a
    collective waited on later) overlap. Makespan decomposes exactly into
    compute-bound + memory-bound + exposed-comm + stall.

    ``overlap=True`` prices the ideal: greedy dataflow list scheduling —
    collectives run (in order) on their own stream, the compute stream
    picks the earliest-ready op regardless of schedule position. The
    difference between the two passes is communication that independent
    compute COULD hide with a better schedule or async collectives.
    """
    if overlap:
        return _simulate_dataflow(ops)
    finish: dict[str, float] = {}
    compute_clock = 0.0
    comm_clock = 0.0
    comm_busy: list = []
    compute_idle: list = []
    compute_bound = memory_bound = comm_total = 0.0

    for op in ops:
        dep_t = max(
            (finish[d] for d in op.operands if d in finish), default=0.0
        )
        if op.kind == "free":
            finish[op.name] = dep_t
            continue
        if op.is_comm:
            if op.opcode.endswith("-done"):
                finish[op.name] = dep_t
                continue
            # A collective-permute (a point-to-point hop) is issued and
            # the program runs on: it floats to its dependency time and
            # only its CONSUMERS wait.
            sync = not (
                op.opcode.endswith("-start")
                or op.opcode.startswith("collective-permute")
            )
            # A sync collective is issued by the in-order sequencer: it
            # cannot start before the compute stream reaches it. Only
            # async -start ops float back to their dependency time.
            start = max(comm_clock, dep_t, compute_clock if sync else 0.0)
            end = start + op.time_s
            comm_clock = end
            comm_total += op.time_s
            if op.time_s > 0:
                comm_busy.append((start, end))
            finish[op.name] = end
            if sync and end > compute_clock:
                compute_idle.append((compute_clock, end))
                compute_clock = end
            continue
        start = max(compute_clock, dep_t)
        if start > compute_clock:
            compute_idle.append((compute_clock, start))
        end = start + op.time_s
        if op.kind == "compute":
            compute_bound += op.time_s
        else:
            memory_bound += op.time_s
        compute_clock = end
        finish[op.name] = end

    makespan = max(
        [compute_clock, comm_clock] + list(finish.values()) or [0.0]
    )
    if makespan > compute_clock:
        compute_idle.append((compute_clock, makespan))
    exposed = _interval_overlap(comm_busy, compute_idle)
    idle_total = sum(hi - lo for lo, hi in compute_idle)
    return SimResult(
        makespan_s=makespan,
        compute_bound_s=compute_bound,
        memory_bound_s=memory_bound,
        comm_total_s=comm_total,
        exposed_comm_s=exposed,
        stall_s=max(0.0, idle_total - exposed),
        ops=list(ops),
    )


def _simulate_dataflow(ops: Sequence[OpCost]) -> SimResult:
    """Greedy two-stream dataflow schedule (the ideal-overlap pass; the
    reference's, ``:652``, unchanged).

    The collective stream keeps schedule order (in-order DMA queue);
    the compute stream repeatedly runs the first op in schedule order
    whose dependencies have finished, advancing time only when nothing
    is ready. O(n^2) worst case — a step's ops are a few thousand."""
    finish: dict[str, float] = {}
    done: list[bool] = [False] * len(ops)
    # Dependencies resolve against ops of this step only; outside names
    # (never produced here) resolve to t=0.
    produced = {op.name for op in ops}

    def dep_t(op) -> Optional[float]:
        t = 0.0
        for d in op.operands:
            if d in finish:
                t = max(t, finish[d])
            elif d in produced:
                return None  # dependency not yet scheduled
        return t

    compute_clock = comm_clock = 0.0
    comm_busy: list = []
    compute_busy: list = []
    compute_bound = memory_bound = comm_total = 0.0
    comm_idx = [i for i, op in enumerate(ops) if op.is_comm]
    comm_pos = 0

    remaining = len(ops)
    while remaining:
        progressed = False
        # Drain every free/instant op that is ready (zero cost, any stream).
        for i, op in enumerate(ops):
            if done[i] or not (
                op.kind == "free"
                or (op.is_comm and op.opcode.endswith("-done"))
            ):
                continue
            t = dep_t(op)
            if t is None:
                continue
            finish[op.name] = t
            done[i] = True
            remaining -= 1
            progressed = True
        # Head-of-line collective.
        while comm_pos < len(comm_idx) and done[comm_idx[comm_pos]]:
            comm_pos += 1
        comm_candidate = None
        if comm_pos < len(comm_idx):
            op = ops[comm_idx[comm_pos]]
            t = dep_t(op)
            if t is not None:
                comm_candidate = (max(comm_clock, t), comm_idx[comm_pos])
        # First ready compute op in schedule order.
        compute_candidate = None
        for i, op in enumerate(ops):
            if done[i] or op.is_comm or op.kind == "free":
                continue
            t = dep_t(op)
            if t is None:
                continue
            compute_candidate = (max(compute_clock, t), i)
            break
        if comm_candidate is None and compute_candidate is None:
            if progressed:
                continue
            break  # cyclic/unresolvable: stop cleanly
        # Run whichever stream can start earlier (tie -> compute).
        if compute_candidate is not None and (
            comm_candidate is None
            or compute_candidate[0] <= comm_candidate[0]
        ):
            start, i = compute_candidate
            op = ops[i]
            end = start + op.time_s
            if op.time_s > 0:
                compute_busy.append((start, end))
            if op.kind == "compute":
                compute_bound += op.time_s
            else:
                memory_bound += op.time_s
            compute_clock = max(compute_clock, end)
        else:
            start, i = comm_candidate
            op = ops[i]
            end = start + op.time_s
            comm_total += op.time_s
            if op.time_s > 0:
                comm_busy.append((start, end))
            comm_clock = max(comm_clock, end)
        finish[op.name] = end
        done[i] = True
        remaining -= 1

    makespan = max(finish.values(), default=0.0)
    compute_busy.sort()
    idle: list = []
    cursor = 0.0
    for lo, hi in compute_busy:
        if lo > cursor:
            idle.append((cursor, lo))
        cursor = max(cursor, hi)
    if makespan > cursor:
        idle.append((cursor, makespan))
    comm_busy.sort()
    exposed = _interval_overlap(comm_busy, idle)
    idle_total = sum(hi - lo for lo, hi in idle)
    return SimResult(
        makespan_s=makespan,
        compute_bound_s=compute_bound,
        memory_bound_s=memory_bound,
        comm_total_s=comm_total,
        exposed_comm_s=exposed,
        stall_s=max(0.0, idle_total - exposed),
        ops=list(ops),
    )



# -- prediction + report ---------------------------------------------------------------


def predict(ops: Sequence[TracedOp], device_kind: str = DEFAULT_DEVICE_KIND) -> tuple:
    """Price a traced step for ``device_kind`` (the reference's
    ``predict_compiled``, ``:863``): returns ``(scheduled, ideal, record)``,
    the as-issued simulation, the ideal-overlap one and the budget record
    (the reference's keys). Raises ``ValueError`` for an unknown card."""
    spec = _spec(device_kind)
    costed = cost_ops(ops, spec)
    scheduled = simulate(costed, overlap=False)
    ideal = simulate(costed, overlap=True)
    flops = sum(op.flops for op in costed if op.kind in ("compute", "memory"))
    hbm_bytes = sum(op.hbm_bytes for op in costed if not op.is_comm)
    step = max(scheduled.makespan_s, 1e-12)
    record = {
        "device_kind": spec.kind,
        "predicted_step_time_us": round(scheduled.makespan_s * 1e6, 3),
        "compute_us": round(scheduled.compute_bound_s * 1e6, 3),
        "memory_us": round(scheduled.memory_bound_s * 1e6, 3),
        "exposed_comm_us": round(scheduled.exposed_comm_s * 1e6, 3),
        "stall_us": round(scheduled.stall_s * 1e6, 3),
        "comm_total_us": round(scheduled.comm_total_s * 1e6, 3),
        "overlap_headroom_us": round(max(0.0, scheduled.makespan_s - ideal.makespan_s) * 1e6, 3),
        "overlap_fraction": round(1.0 - scheduled.exposed_comm_s / scheduled.comm_total_s, 4)
        if scheduled.comm_total_s > 0 else 1.0,
        "fractions": {
            "compute": round(scheduled.compute_bound_s / step, 4),
            "memory": round(scheduled.memory_bound_s / step, 4),
            "exposed_comm": round(scheduled.exposed_comm_s / step, 4),
            "stall": round(scheduled.stall_s / step, 4),
        },
        "bound": max(("compute", scheduled.compute_bound_s), ("memory", scheduled.memory_bound_s),
                     ("comm", scheduled.exposed_comm_s), key=lambda kv: kv[1])[0],
        "flops_per_step": float(flops),
        "hbm_bytes_per_step": int(hbm_bytes),
        "predicted_mfu": round(flops / (step * spec.flops_bf16), 4),
        "n_ops": len(costed),
        "n_collectives": sum(op.is_comm for op in costed),
    }
    return scheduled, ideal, record


@dataclass
class SchedAuditReport:
    """One audited step: its label, the launches it would make, the
    findings, both simulations and the record the budget gate reads."""

    label: str
    launches: list = field(default_factory=list)
    findings: list = field(default_factory=list)
    scheduled: Optional[SimResult] = None
    ideal: Optional[SimResult] = None
    record: dict = field(default_factory=dict)
    ops: list = field(default_factory=list)

    @property
    def clean(self) -> bool:
        return not self.findings


def audit_schedule(step_fn: Callable, *args, device_kind: str = DEFAULT_DEVICE_KIND,
                   label: str = "step", roofline: bool = False, mfu_floor: float = 0.0,
                   exposed_frac_min: float = 0.15, exposed_min_s: float = 20e-6,
                   convoy_min: int = 6, bucket_bytes: int = 4 << 20,
                   memory_frac_max: float = 0.6, memory_min_bytes: int = 1 << 20,
                   mesh: Optional[Mapping[str, int]] = None) -> SchedAuditReport:
    """Audit ``step_fn(*args)`` (meta tensors in ``args``) on
    ``device_kind``: trace it (:func:`trace_step`) and hold its launches
    to the card (RKT504, each launch's declared accumulation dtype
    included); with ``roofline`` (every target's audit) also
    price it (:func:`predict`) and run RKT501-503 and RKT505 with the
    reference's thresholds."""
    spec = _spec(device_kind)
    tracer = trace_step(step_fn, *args, device_kind=device_kind)
    report = SchedAuditReport(label=label, launches=list(tracer.launches), ops=tracer.ops)
    findings = check_launches(tracer.launches, spec, label=label)
    findings += check_numerics_declared(tracer.launches, label=label)
    if roofline:
        scheduled, ideal, record = predict(tracer.ops, device_kind)
        report.scheduled, report.ideal = scheduled, ideal
        report.record = dict(record, mesh=dict(mesh or {"data": 1}),
                             n_launches=len(tracer.launches))
        findings += check_exposed_comm(scheduled, ideal, exposed_frac_min=exposed_frac_min,
                                       exposed_min_s=exposed_min_s, label=label)
        findings += check_convoys(scheduled.ops, convoy_min=convoy_min,
                                  bucket_bytes=bucket_bytes, label=label)
        findings += check_memory_bound(scheduled.ops, scheduled.makespan_s, spec.ridge,
                                       memory_frac_max=memory_frac_max,
                                       min_bytes=memory_min_bytes, label=label)
        findings += check_mfu_floor(record["predicted_mfu"], mfu_floor, label=label)
    report.findings = findings
    return report


def render_record(label: str, record: Mapping) -> str:
    """One line of a target's priced step: its time, split and MFU."""
    return (f"{label}: predicted step {record['predicted_step_time_us']:.1f} us on "
            f"{record['device_kind']} (compute {record['compute_us']:.1f}, memory "
            f"{record['memory_us']:.1f}, exposed comm {record['exposed_comm_us']:.1f} us), "
            f"predicted MFU {record['predicted_mfu']:.4f}, {record['n_ops']} ops, "
            f"{record['n_collectives']} collectives")


# -- targets ---------------------------------------------------------------------------


@dataclass(frozen=True)
class SchedTarget:
    """One configuration the CLI audits: ``build() -> (step_fn, args)``
    with meta tensors in ``args``. ``mesh_shape`` is the world one rank's
    program is traced in (the record's ``mesh``), ``mfu_floor`` RKT505's
    floor (0 disables), ``overrides`` threshold overrides of
    :func:`audit_schedule` where the defaults would mis-scale for the
    target, ``roofline`` False for a kernel-launch-only demo. A demo target
    runs only when named."""

    name: str
    build: Callable[[], tuple]
    doc: str = ""
    demo: bool = False
    mesh_shape: Mapping[str, int] = field(default_factory=lambda: {"data": 1})
    mfu_floor: float = 0.0
    roofline: bool = True
    overrides: Mapping[str, Any] = field(default_factory=dict)


def _meta(*shape, dtype=torch.bfloat16) -> torch.Tensor:
    return torch.empty(shape, dtype=dtype, device="meta")


def _meta_params(model, device="meta", params=None):
    """``model``'s params drawn on meta tensors (or from seed 0 on
    ``device``; or ``params``, drawn already), and their leaves in the
    Module's order, each needing a gradient."""
    from rocket_tpu_torch import optim

    device = torch.device(device)
    if params is None:
        with torch.device("meta") if device.type == "meta" else contextlib.nullcontext():
            params = model.init(torch.Generator().manual_seed(0), device=device)
    leaves = optim.param_leaves(params)
    for t in leaves:
        t.requires_grad_()
    return params, leaves


def _train_parts(model, batch: dict, *, make_opt=None, loss_fn, remat: bool = True,
                 device="meta", params=None, keep_grads: bool = False):
    """The Module's train step (``core/module.py``: ``_train_step``,
    ``_forward``, ``_update``) built from its pieces, since the Module
    itself needs a Runtime on a device: the forward (under the
    whole-forward remat, ``torch.utils.checkpoint`` non-reentrant, with
    ``remat``), the loss in f32, the gradient of every leaf, and the
    optimizer's step on ``.grad`` (``make_opt`` None: the reference's SGD
    audit update). The optimizer runs its foreach implementation, as
    ``torch.optim`` picks for CUDA params (on meta it would fall back to
    its per-param loop). The params live on ``device`` (meta for the
    audit, a real device for the calibration's measured leg: the same aten
    sequence; ``params`` drawn already, or seed 0's). The step carries
    ``leaves`` and ``optimizer``, the train state the memory audit reads,
    and with ``keep_grads`` ``grads``, the last step's gradients (for a
    health word; off for the audits, whose liveness they would change)."""
    from torch.utils.checkpoint import checkpoint

    from rocket_tpu_torch.nn import keys

    params, leaves = _meta_params(model, device, params)
    opt = None if make_opt is None else make_opt(params)
    for group in opt.param_groups if opt is not None else ():
        group["foreach"] = True
    rng = keys.fold_in(keys.key(0), 0)

    def step(params, batch):
        def forward(b):
            return model.apply(params, b, mode="train", rng=rng)

        with torch.enable_grad():
            out = checkpoint(forward, batch, use_reentrant=False) if remat else forward(batch)
            loss = loss_fn(out).float()
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads = [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)]
        if keep_grads:
            step.grads = grads
        if opt is None:
            _sgd_(leaves, grads)
            return loss.detach()
        for p, g in zip(leaves, grads):
            p.grad = g
        for group in opt.param_groups:
            group["lr"] = 1e-4
        opt.step()
        for p in leaves:
            p.grad = None
        return loss.detach()

    step.leaves, step.optimizer = leaves, opt
    return step, (params, batch)


def _gpt2_parts(seq_len: int, batch: int = 8, device="meta", params=None,
                keep_grads: bool = False):
    """GPT-2 124M at full width, B=8, bf16 compute, as ``chip_smoke.py``'s
    train phases take a step (``examples/gpt2.build``): dropout 0.1 and
    its counter-hash keys, the whole-forward remat (each layer's forward
    runs twice), the next-token loss, the backward and AdamW (weight decay
    0.1 on the matrices). ``params``: f32 params on ``device`` drawn
    already (seed 0's are drawn otherwise); ``keep_grads`` as
    :func:`_train_parts`."""
    from rocket_tpu_torch import optim
    from rocket_tpu_torch.models.transformer import (
        TransformerConfig,
        TransformerLM,
        next_token_loss,
    )

    model = TransformerLM(TransformerConfig.gpt2_124m(max_seq_len=seq_len))
    tokens = torch.zeros((batch, seq_len), dtype=torch.int32, device=device)
    return _train_parts(model, {"tokens": tokens}, make_opt=optim.adamw(weight_decay=0.1),
                        loss_fn=next_token_loss(), device=device, params=params,
                        keep_grads=keep_grads)


def _train_flash_parts():
    """Rows 3-4: GPT-2 124M's train step at T=1024, the fused flash forward
    (twice a layer under the remat) and the backward with dq partials
    (``chip_smoke.py`` train phase)."""
    return _gpt2_parts(1024)


def _train_flash_long_parts():
    """Row 5: the same at T=2048, where the dq partial buffer passes
    ``ops/flash_native.DQ_PARTIALS_MAX_BYTES`` and the backward adds the
    accumulating dq kernel (``chip_smoke.py`` train_long phase)."""
    return _gpt2_parts(2048)


def _train_flash_tp_parts():
    """Rows 3-4 on one rank of GPT-2 124M's tensor-parallel train step at
    ``--model-axis 2``: each of the 12 layers' attention runs on the rank's
    6 of 12 heads (``MultiHeadAttention._apply_tp``'s ``flash_bthd`` on
    the gathered sequence, B=8, T=1024, D=64), forward and backward
    (``chip_smoke.py`` tp_train phase). The collectives around it launch no
    hand kernel."""
    from rocket_tpu_torch.ops.flash_native import flash_bthd

    heads = 12 // 2
    q, k, v = (_meta(8, 1024, heads * 64).requires_grad_() for _ in range(3))

    def step(q, k, v):
        grads = ()
        for _ in range(12):
            grads += torch.autograd.grad(flash_bthd(q, k, v, heads, heads).float().sum(),
                                         (q, k, v))
        return grads

    return step, (q, k, v)


def _qkv_flash_parts():
    """Rows 6-7: forward and backward of the stacked (3, 8, 12, 1024, 64)
    bf16 operand at both square tile pairs, 128 and 64 (the shapes
    ``chip_smoke.py``'s parity_flash_qkv and tune phases run)."""
    from rocket_tpu_torch.ops.flash_attention import flash_attention_qkv

    qkv = _meta(3, 8, 12, 1024, 64).requires_grad_()

    def step(qkv):
        grads = []
        for block in (128, 64):
            out = flash_attention_qkv(qkv, causal=True, block_q=block, block_k=block)
            grads.append(torch.autograd.grad(out.float().sum(), qkv)[0])
        return grads

    return step, (qkv,)


def _fused_kernels_parts():
    """Rows 8-11 and the grouped products at the reference's
    ``fused_kernels`` shapes (``sched_audit.py:1181-1183``), bf16: the BN
    epilogue over (262144, 64) under both schedules (``"twopass"``: moments,
    finalize and normalise in one launch; ``"stats_xla"``: normalise
    alone), the fused block at (64, 256, 256) with 4 heads under both
    epilogues, gather-GMM of 2048 x 768 rows into (4, 768, 3072), and the
    dropless MoE FFN's grouped products at GPT-2 widths (16384 routed rows,
    4 experts): the in- and out-projection forward, gmm with the transposed
    rhs and tgmm in their backward."""
    from rocket_tpu_torch.ops.fused_block import block_attn_half
    from rocket_tpu_torch.ops.fused_conv import fused_bn_act
    from rocket_tpu_torch.ops.gather_gmm import gather_gmm
    from rocket_tpu_torch.ops.grouped_matmul import grouped_matmul

    f32, i32 = torch.float32, torch.int32
    m, dim, ffn, e = 16384, 768, 3072, 4
    operands = {
        "x_conv": _meta(262144, 64), "bn_scale": _meta(64, dtype=f32),
        "bn_bias": _meta(64, dtype=f32),
        "x_blk": _meta(64, 256, 256), "ln_scale": _meta(256, dtype=f32),
        "ln_bias": _meta(256, dtype=f32), "wqkv": _meta(256, 768, dtype=f32),
        "bqkv": _meta(768, dtype=f32), "wproj": _meta(256, 256, dtype=f32),
        "bproj": _meta(256, dtype=f32),
        "x_tok": _meta(2048, dim), "experts": _meta(e, dim, ffn),
        "row_ids": _meta(2048, dtype=i32), "group_sizes": _meta(e, dtype=i32),
        "h_in": _meta(m, dim).requires_grad_(), "w_in": _meta(e, dim, ffn).requires_grad_(),
        "w_out": _meta(e, ffn, dim).requires_grad_(), "sizes": _meta(e, dtype=i32),
    }

    def step(p):
        outs = [fused_bn_act(p["x_conv"], p["bn_scale"], p["bn_bias"], schedule=schedule)[0]
                for schedule in ("twopass", "stats_xla")]
        outs += [block_attn_half(p["x_blk"], p["ln_scale"], p["ln_bias"], p["wqkv"], p["bqkv"],
                                 p["wproj"], p["bproj"], num_heads=4, epilogue=epilogue)
                 for epilogue in ("fused", "separate")]
        outs.append(gather_gmm(p["x_tok"], p["experts"], p["row_ids"], p["group_sizes"]))
        up = grouped_matmul(p["h_in"], p["w_in"], p["sizes"])
        down = grouped_matmul(up, p["w_out"], p["sizes"])
        outs += torch.autograd.grad(down.float().sum(), (p["h_in"], p["w_in"], p["w_out"]))
        return outs

    return step, (operands,)


def _serve_parts():
    """Rows 1-2 at ``chip_smoke.py``'s serve shapes, bf16, GPT-2 heads
    (Hq = Hkv = 12, D = 64): a paged decode wave of 8 slots over 64 blocks
    of 16 rows each, and ``generate()``'s cached decode step at B=4 against
    a 192-row cache."""
    from rocket_tpu_torch.ops.decode_attention import decode_attention
    from rocket_tpu_torch.ops.paged_attention import paged_decode

    s, mb, bl, h, d = 8, 64, 16, 12, 64
    pool = _meta(1 + s * mb, bl, h, d)
    paged = (_meta(s, h, d), pool, pool, _meta(s, mb, dtype=torch.int32),
             _meta(s, dtype=torch.int32))
    cache = _meta(4, h, 192, d)
    dense = (_meta(4, h, d), _meta(4, h, d), _meta(4, h, d), cache, cache, 191)

    def step(paged, dense):
        return paged_decode(*paged), decode_attention(*dense)

    return step, (paged, dense)


def _vit_flash_parts():
    """Rows 3-4 at ViT's shape: the ``vit_cifar`` example's train step
    (``vit_tiny``: D=192, 9 blocks, 3 heads of 64, dropout 0.1) at B=512 on
    32x32 images in 4x4 patches, bf16: T = 65 tokens (a second 64-row tile
    holding one row), non-causal, the fused qkv operand (``chip_smoke.py``
    vit_train phase)."""
    from rocket_tpu_torch.models.vit import vit_tiny
    from rocket_tpu_torch.nn import keys
    from rocket_tpu_torch.nn.module import map_params

    model = vit_tiny(dropout=0.1)
    meta = torch.device("meta")
    with meta:
        params = model.init(torch.Generator().manual_seed(0), device=meta)
    leaves = []
    map_params(lambda t: leaves.append(t.requires_grad_()), params)

    def step(params, images, labels):
        out = model.apply(params, {"image": images}, mode="train", rng=keys.key(0))
        loss = torch.nn.functional.cross_entropy(out["logits"].float(), labels.long())
        return torch.autograd.grad(loss, leaves)

    return step, (params, _meta(512, 32, 32, 3), _meta(512, dtype=torch.int32))


def _llama_flash_parts():
    """Rows 3-4 and 2 at the ``llama_lm`` example's shapes, bf16: its train
    step (dim 256, 6 layers, 8 query heads over 4 K/V heads of 32, RoPE) at
    B=128, T=256 on the bthd GQA operands, and one decode step of its
    nucleus sample (B=1, a 68-row cache, the last position), a group of 2
    (``chip_smoke.py`` llama_train phase)."""
    from rocket_tpu_torch.examples.llama_lm import config_for
    from rocket_tpu_torch.models.transformer import TransformerLM, next_token_loss
    from rocket_tpu_torch.nn import keys
    from rocket_tpu_torch.nn.module import map_params
    from rocket_tpu_torch.ops.decode_attention import decode_attention

    model = TransformerLM(config_for(vocab_size=64, seq_len=256))
    meta = torch.device("meta")
    with meta:
        params = model.init(torch.Generator().manual_seed(0), device=meta)
    leaves = []
    map_params(lambda t: leaves.append(t.requires_grad_()), params)
    cache = _meta(1, 4, 68, 32)
    dense = (_meta(1, 8, 32), _meta(1, 4, 32), _meta(1, 4, 32), cache, cache, 67)

    def step(params, tokens, dense):
        out = model.apply(params, {"tokens": tokens}, mode="train", rng=keys.key(0))
        return torch.autograd.grad(next_token_loss()(out), leaves), decode_attention(*dense)

    return step, (params, _meta(128, 256, dtype=torch.int32), dense)


def _flash_d128_parts():
    """Rows 3-7 at head dim 128, bf16, causal: the Llama-3-8B attention
    width (B=2, T=2048, 32 query heads over 8 K/V heads of 128, bthd GQA;
    its dq partials would pass ``DQ_PARTIALS_MAX_BYTES``, so the backward
    is row 4 without dq and row 5), Phi-3-mini's 32 heads of 96 on the fused
    operand (B=1, padded to 128: row 4 with dq partials), and the stacked
    (3, 2, 32, 2048, 128) operand at its one compiled tile pair, 64 x 64
    (``chip_smoke.py``'s parity_flash_d128 phase)."""
    from rocket_tpu_torch.ops.flash_attention import flash_attention_qkv
    from rocket_tpu_torch.ops.flash_native import flash_bthd, flash_fused

    q, k, v = (_meta(2, 2048, w).requires_grad_() for w in (32 * 128, 8 * 128, 8 * 128))
    fused = _meta(1, 2048, 3 * 32 * 96).requires_grad_()
    qkv = _meta(3, 2, 32, 2048, 128).requires_grad_()

    def step(q, k, v, fused, qkv):
        grads = torch.autograd.grad(flash_bthd(q, k, v, 32, 8).float().sum(), (q, k, v))
        grads += torch.autograd.grad(flash_fused(fused, 32).float().sum(), (fused,))
        return grads + torch.autograd.grad(
            flash_attention_qkv(qkv, True, 64, 64).float().sum(), (qkv,))

    return step, (q, k, v, fused, qkv)


# -- the reference's multi-rank roofline targets ---------------------------------------


class _MetaRuntime:
    """Rank 0 of a world laid out as ``mesh`` with no process group: the
    Runtime surface the parallel pieces read (``tp_overlap``,
    ``bridge.local_params``, sync-BN's ``Runtime.current()``), every group
    None. Its collectives take their meta route (a ``CommFact`` each)."""

    DATA_AXES = ("data",)
    grouped = True
    data_index = 0

    def __init__(self, mesh: Mapping[str, int]) -> None:
        self.mesh = dict(mesh)

    def axis_size(self, axis: str) -> int:
        return int(self.mesh.get(axis, 1))

    @property
    def data_axis_size(self) -> int:
        return self.axis_size("data")

    @property
    def model_axis_size(self) -> int:
        return self.axis_size("model")

    def axis_index(self, axis: str) -> int:
        return 0

    def axis_ranks(self, axis: str) -> tuple:
        return tuple(range(self.axis_size(axis)))

    def axis_group(self, axis: str):
        return None

    def plane_group(self, axes):
        return None


@contextlib.contextmanager
def _current(runtime):
    """``runtime`` as ``Runtime.current()`` for the block (sync-BN reads it)."""
    from rocket_tpu_torch.runtime import Runtime

    previous, Runtime._current = Runtime._current, runtime
    try:
        yield runtime
    finally:
        Runtime._current = previous


def _lm_config(**overrides):
    """The reference's audit LM (``shard_audit._lm_config``): a tiny
    SwiGLU, RMSNorm, RoPE, untied TransformerLM whose every
    ``gpt2_tp_rules`` glob is live, with the reference's plain attention
    (``"auto"`` would take the flash kernels on the card and on meta, the
    plain path on the CPU)."""
    from rocket_tpu_torch.models.transformer import TransformerConfig

    base = dict(vocab_size=256, max_seq_len=64, dim=128, num_layers=2, num_heads=8,
                pos_embedding="rope", norm="rmsnorm", mlp="swiglu", tied_embeddings=False,
                dropout=0.0, attention_impl="plain")
    base.update(overrides)
    return TransformerConfig(**base)


def _sgd_(leaves, grads) -> None:
    """The reference's audit update, ``p - 1e-3 g``, in one foreach op."""
    with torch.no_grad():
        torch._foreach_add_(list(leaves), list(grads), alpha=-1e-3)


def _parallel_lm_parts(mesh: Mapping[str, int], rule, *, train: bool = True,
                       global_batch: int = 16, config=None):
    """One rank's step of the audit LM at ``mesh`` under ``rule``, built
    as ``core/module.py`` builds it (``_shard``, ``_setup_grad_sync``,
    ``_full_params``, ``_tp``): the rank's shards of the params
    (``bridge.local_params``), the data-sharded leaves all-gathered whole
    before the forward in the Module's buckets (``grad_sync.gather_buckets``), the forward under ``tp_overlap`` over a model axis (the
    collective matmuls, the sequence-sharded residual stream), and the
    backward's gradients reduced by ``GradSync`` (bucketed all-reduces, an
    FSDP leaf's reduce-scatter, the norms summed over the model group),
    then the reference's SGD update. ``train=False``: the eval forward's
    logits. The batch is this rank's stripe of ``global_batch`` sequences.
    A rule set without the TP marker over a model axis runs the Module's
    replicated program instead: each model shard gathered whole at step
    entry as a data shard is, and this rank's chunk of its gradient kept
    (``Module._full_params``, ``_grad_maps``). The step carries
    ``leaves``, this rank's param leaves (the train state the memory audit
    reads)."""
    from rocket_tpu_torch import bridge, optim
    from rocket_tpu_torch.core.module import _paths
    from rocket_tpu_torch.models.transformer import TransformerLM, next_token_loss
    from rocket_tpu_torch.nn import keys
    from rocket_tpu_torch.nn.module import map_params
    from rocket_tpu_torch.parallel import collectives as coll
    from rocket_tpu_torch.parallel import grad_sync as gs

    cfg = config or _lm_config()
    model = TransformerLM(cfg)
    runtime = _MetaRuntime(mesh)
    whole, whole_leaves = _meta_params(model)
    paths = list(_paths(whole))
    layouts = gs.shard_layout(zip(paths, whole_leaves), rule, runtime.mesh, runtime.DATA_AXES)
    local = bridge.local_params(map_params(lambda t: t.detach(), whole), rule, runtime)
    leaves = optim.param_leaves(local)
    for t in leaves:
        t.requires_grad_()
    data, model_n = runtime.data_axis_size, runtime.model_axis_size
    tp = model_n > 1 and getattr(rule, "tp_axis", None) is not None
    dims = [None if lay is None or lay.axis != "data" else lay.dim for lay in layouts]
    # (dim, world, axis) of each leaf gathered whole at step entry.
    gathered = [(lay.dim, runtime.axis_size(lay.axis), lay.axis) if lay is not None and (
        lay.axis == "data" or (lay.axis == "model" and not tp)) else None for lay in layouts]
    maps = [(lambda g, d=lay.dim: g.chunk(model_n, d)[0].contiguous())
            if lay is not None and lay.axis == "model" and not tp else None for lay in layouts]
    partial = [frozenset({"model"}) if tp and (lay is None or lay.dim is None)
               and model.tp_partial(path) else None for path, lay in zip(paths, layouts)]
    sync = None
    if train and (data > 1 or any(partial)):
        narrow = getattr(rule, "fsdp_axis", None) is not None
        # The backward's shapes: this rank's model shards, a data shard whole.
        shapes = [tuple(w.shape) if d is not None else tuple(t.shape)
                  for t, w, d in zip(leaves, whole_leaves, dims)]
        sync = gs.GradSync(shapes, [t.dtype for t in leaves],
                           dims, data, wire_dtype="bfloat16" if narrow else None,
                           partial=partial, groups={frozenset({"model"}): None},
                           plane_sizes={frozenset({"model"}): data * model_n})
    tokens = _meta(global_batch // data, cfg.max_seq_len, dtype=torch.int32)
    rng = keys.fold_in(keys.key(0), 0)

    def full_params(local):
        # The Module's buckets, one flat all-gather each, every gather
        # started before the first wait.
        mine = optim.param_leaves(local)
        started = [gs.gather_buckets([(i, t.detach(), g[0]) for i, (t, g) in enumerate(
            zip(mine, gathered)) if g is not None and g[2] == axis], runtime.axis_size(axis))
            for axis in sorted({g[2] for g in gathered if g is not None})]
        full = list(mine)
        for pending in started:
            for i, whole_t in gs.gathered(pending):
                full[i] = whole_t.requires_grad_(True) if train else whole_t
        it = iter(full)
        return map_params(lambda t: next(it), local), full

    def step(local, tokens):
        with contextlib.ExitStack() as stack:
            if tp:
                stack.enter_context(coll.tp_overlap(
                    runtime, axis="model",
                    vocab_sharded_embed=bool(getattr(rule, "tp_vocab_sharded", False))))
            params, compute = full_params(local)
            if not train:
                return model.apply(params, {"tokens": tokens}, mode="eval")["logits"]
            with torch.enable_grad():
                if sync is not None:
                    sync.begin(compute, maps=maps)
                out = model.apply(params, {"tokens": tokens}, mode="train", rng=rng)
                loss = next_token_loss()(out).float()
                grads = torch.autograd.grad(loss, compute, allow_unused=True)
        loss = loss.detach()
        if sync is not None:
            grads, loss = sync.finish(grads, loss)
        else:
            grads = [g if f is None or g is None else f(g) for f, g in zip(maps, grads)]
        _sgd_(leaves, [torch.zeros_like(p) if g is None else g for p, g in zip(leaves, grads)])
        return loss

    step.leaves = leaves
    return step, (local, tokens)


def _tp_2x4_parts():
    from rocket_tpu_torch.parallel.sharding import gpt2_tp_rules

    return _parallel_lm_parts({"data": 2, "model": 4}, gpt2_tp_rules(axis="model"))


def _tp_1x8_parts():
    from rocket_tpu_torch.parallel.sharding import gpt2_tp_rules

    return _parallel_lm_parts({"data": 1, "model": 8}, gpt2_tp_rules(axis="model"))


def _tp_2x4_eval_parts():
    from rocket_tpu_torch.parallel.sharding import gpt2_tp_rules

    return _parallel_lm_parts({"data": 2, "model": 4}, gpt2_tp_rules(axis="model"), train=False)


def _fsdp_1x8_parts():
    from rocket_tpu_torch.parallel.sharding import fsdp_rules

    return _parallel_lm_parts({"data": 8}, fsdp_rules(axis="data", min_size=4096))


def _tp_flash_parts():
    """The reference's ``tp_flash`` (``:1161``): the audit LM with flash
    attention at T=256 over ``{"data": 1, "model": 8}``, one head of 16 a
    rank (rows 3-4 on heads zero-padded to the compiled D=32)."""
    from rocket_tpu_torch.parallel.sharding import gpt2_tp_rules

    return _parallel_lm_parts({"data": 1, "model": 8}, gpt2_tp_rules(axis="model"),
                              config=_lm_config(attention_impl="flash", max_seq_len=256))


def _dp_resnet_parts(global_batch: int = 64):
    """The reference's ``dp_resnet_1x8`` (``:1124``): ResNet-18 with the
    CIFAR stem, f32, one rank of 8 data ranks (8 images of 32x32): sync-BN
    (an all-reduce of each BN's sums forward and backward), the softmax
    cross-entropy, the gradients' bucketed f32 all-reduce (the
    Optimizer's default 4 MiB buckets), the reference's SGD update."""
    from rocket_tpu_torch.models.resnet import resnet18
    from rocket_tpu_torch.parallel import grad_sync as gs

    model = resnet18(num_classes=10, stem="cifar")
    runtime = _MetaRuntime({"data": 8})
    params, leaves = _meta_params(model)
    state = model.init_state(device=torch.device("meta"))
    sync = gs.GradSync([tuple(t.shape) for t in leaves], [t.dtype for t in leaves],
                       [None] * len(leaves), 8, wire_dtype=None)
    b = global_batch // 8

    def step(params, images, labels):
        with _current(runtime), torch.enable_grad():
            sync.begin(leaves)
            out, _state = model.apply(params, {"image": images}, state=state, mode="train")
            loss = torch.nn.functional.cross_entropy(out["logits"].float(), labels.long())
            grads = torch.autograd.grad(loss, leaves, allow_unused=True)
        grads, loss = sync.finish(grads, loss.detach())
        _sgd_(leaves, grads)
        return loss

    step.leaves, step.model_state = leaves, state
    return step, (params, _meta(b, 32, 32, 3, dtype=torch.float32),
                  _meta(b, dtype=torch.int32))


# -- the seeded-bad demos --------------------------------------------------------------


def _psum(t: torch.Tensor, n: int) -> torch.Tensor:
    """A blocking all-reduce of meta ``t`` over ``n`` data ranks."""
    from rocket_tpu_torch.parallel.collectives import collective

    out = torch.empty_like(t)
    collective("all_reduce", None, (t,), (out,), 2 * (n - 1) / n * _nbytes(t), n, "data")
    return out


def _all_gather(t: torch.Tensor, n: int) -> torch.Tensor:
    """A blocking all-gather of meta ``t`` over ``n`` data ranks -> (n, *t.shape)."""
    from rocket_tpu_torch.parallel.collectives import collective

    out = torch.empty((n,) + tuple(t.shape), dtype=t.dtype, device=t.device)
    collective("all_gather", None, (t,), (out,), (n - 1) * _nbytes(t), n, "data")
    return out


def _badsched_parts():
    """The reference's seeded-bad step (``:1236``), one rank of 8: a
    dependency-chained convoy of 8 tiny all-reduces (RKT502), a 4 MiB
    all-gather whose result is read only after an independent matmul chain
    (RKT501: the dataflow hides it, the step as issued waits on it), an
    elementwise chain over the gathered buffer at arithmetic intensity ~0
    (RKT503), and an unreachable MFU floor (RKT505)."""
    def bad_step(w, x):
        v = x[0, :128]
        for _ in range(8):
            v = _psum(v, 8) * 0.125
        g = _all_gather(x, 8)                      # (8, 128, 1024) f32 = 4 MiB
        h = torch.tanh(x @ w) @ w                  # independent of g
        m = torch.tanh(g * 1.0001) + torch.log1p(torch.abs(g))
        return _psum(h.sum() + m.sum() + v.sum(), 8)

    return bad_step, (_meta(1024, 1024, dtype=torch.float32),
                      _meta(128, 1024, dtype=torch.float32))


def _badoverlap_parts():
    """The reference's seeded-bad data-parallel step (``:1280``), one rank of
    8: a blocking all-gather of the whole batch issued first and read only
    at the end while the 12-layer chain after it is independent of it
    (RKT501), and an unbucketed per-parameter gradient all-reduce convoy,
    one tiny f32 all-reduce per leaf chained at the step's tail (RKT502,
    its latency exposed too)."""
    def bad_step(x, *ws):
        gathered = _all_gather(x, 8).reshape(-1, x.shape[1])
        h, sums = x, []
        for w in ws:
            h = torch.tanh(h @ w)
            s = h.sum(0)
            sums.append(s)
            h = h + s * 0.0
        tail = h.sum() * 0.0
        total = torch.zeros(512, dtype=torch.float32, device=x.device)
        for s in sums:
            total = total + _psum(s + tail + total * 0.0, 8)
        return _psum(h.sum() + gathered[-1].sum() * 1e-6 + total.sum(), 8)

    return bad_step, (_meta(256, 512, dtype=torch.float32),
                      *(_meta(512, 512, dtype=torch.float32) for _ in range(12)))


def _badpallas_parts():
    """Row 12, the seeded-bad demo: the fixture's two launches on a
    (4096, 4096) f32 array, 2 * x in (7, 100) blocks over grid (4,) — a tile
    misfit on both dims — and in one whole-array block, 64 MiB of shared
    memory. Exactly RKT504, once of each kind, and nothing else."""
    from rocket_tpu_torch.ops.badpallas import bad_scale

    def step(x):
        y = bad_scale(x, block=(7, 100), grid=(4,))
        z = bad_scale(x, block=tuple(x.shape), grid=())
        return y, z

    return step, (_meta(4096, 4096, dtype=torch.float32),)


#: RKT503's gate on a step whose large ops are nearly all memory-bound
#: today: eager PyTorch issues every elementwise op on its own (the dropout
#: counter hash, the casts, the norms, AdamW's foreach passes), 87-90% of
#: the GPT-2 steps' predicted time. The gate sits above that, so only NEW
#: memory-bound weight fails, as the reference's ``dp_resnet_1x8`` override
#: does; the step-time budget (RKT506) gates growth.
_MEMORY_HEAVY = {"memory_frac_max": 0.95}
#: A step of memory-bound ops alone at these shapes (rows 1-2 and 6-7,
#: and the narrow ViT and Llama examples, whose flash intensity T/4 and
#: D-wide matmuls sit under the H100's ~295 FLOP/B ridge): RKT503 cannot
#: tell a regression here, RKT506's step-time budget does.
_MEMORY_ONLY = {"memory_frac_max": 1.0}

#: name -> target; the CLI's default sweep runs every non-demo one. Each
#: MFU floor sits ~35% under the port's first priced MFU on the H100 (the
#: reference's headroom; its floors were priced for a TPU and do not carry
#: over), that MFU in the comment after it: a structural regression blows
#: through, noise does not.
SCHED_TARGETS = {target.name: target for target in (
    SchedTarget("train_flash", _train_flash_parts, "GPT-2 124M train step, B=8 T=1024 (rows 3-4)",
                mfu_floor=0.069, overrides=_MEMORY_HEAVY),                      # of 0.1064
    SchedTarget("train_flash_long", _train_flash_long_parts,
                "GPT-2 124M train step, B=8 T=2048 (rows 3-5)",
                mfu_floor=0.079, overrides=_MEMORY_HEAVY),                      # of 0.1219
    SchedTarget("train_flash_tp", _train_flash_tp_parts, "GPT-2 124M tensor-parallel train "
                "step, one rank at --model-axis 2: 6 of 12 heads, B=8 T=1024 (rows 3-4)",
                mesh_shape={"data": 1, "model": 2}, mfu_floor=0.11,
                overrides=_MEMORY_HEAVY),                                        # of 0.1692
    SchedTarget("qkv_flash", _qkv_flash_parts, "stacked-qkv flash, (3, 8, 12, 1024, 64), "
                "tiles 128 and 64 (rows 6-7)", mfu_floor=0.068,
                overrides=_MEMORY_ONLY),                                         # of 0.1056
    SchedTarget("fused_kernels", _fused_kernels_parts, "BN epilogue, fused block, gather-GMM, "
                "gmm/tgmm (rows 8-11)", mfu_floor=0.456),                       # of 0.7020
    SchedTarget("serve", _serve_parts, "paged decode wave and cached decode step (rows 1-2)",
                mfu_floor=0.0022, overrides=_MEMORY_ONLY),                       # of 0.0034
    SchedTarget("vit_flash", _vit_flash_parts, "ViT-Ti train step, B=512 T=65 non-causal "
                "(rows 3-4)", mfu_floor=0.0188, overrides=_MEMORY_ONLY),        # of 0.0289
    SchedTarget("llama_flash", _llama_flash_parts, "Llama char-LM train step, B=128 T=256 GQA "
                "D=32, and its decode step (rows 2-4)", mfu_floor=0.056,
                overrides=_MEMORY_ONLY),                                         # of 0.0864
    SchedTarget("train_flash_d128", _flash_d128_parts, "head dim 128: Llama-3-8B GQA "
                "B=2 T=2048 (rows 3-5), Phi-3-mini D=96 padded (rows 3-4), stacked 64x64 "
                "(rows 6-7)", mfu_floor=0.111, overrides=_MEMORY_HEAVY),        # of 0.1708
    # The reference's multi-rank targets: comm priced for 8 H100 SXM over NVLink.
    SchedTarget("tp_2x4", _tp_2x4_parts, "audit LM train step, one rank of data 2 x model 4",
                mesh_shape={"data": 2, "model": 4}, mfu_floor=0.0016),          # of 0.0024
    SchedTarget("tp_1x8", _tp_1x8_parts, "audit LM train step, one rank of model 8",
                mesh_shape={"data": 1, "model": 8}, mfu_floor=0.0014),          # of 0.0022
    SchedTarget("fsdp_1x8", _fsdp_1x8_parts, "audit LM train step, one rank of 8 FSDP ranks",
                mesh_shape={"data": 8}, mfu_floor=0.0020),                       # of 0.0031
    SchedTarget("tp_2x4_eval", _tp_2x4_eval_parts, "audit LM eval forward, one rank of data 2 "
                "x model 4", mesh_shape={"data": 2, "model": 4}, mfu_floor=0.0012),  # of 0.0018
    SchedTarget("dp_resnet_1x8", _dp_resnet_parts, "ResNet-18 CIFAR train step with sync-BN, "
                "one rank of 8 data ranks", mesh_shape={"data": 8},
                mfu_floor=0.0153),                                               # of 0.0235
    SchedTarget("tp_flash", _tp_flash_parts, "audit LM with flash attention, T=256, one rank "
                "of model 8 (rows 3-4)", mesh_shape={"data": 1, "model": 8},
                mfu_floor=0.0034),                                               # of 0.0053
    # The demos: the reference's thresholds, and RKT503's set under each
    # demo's own memory share as the port prices it (19% and 7% of the
    # step), so the rules name the shapes they were seeded with.
    SchedTarget("badsched", _badsched_parts, "seeded-bad: exposed all-gather, all-reduce "
                "convoy, memory-bound chain, unreachable MFU floor", demo=True,
                mesh_shape={"data": 8}, mfu_floor=0.9,
                overrides={"convoy_min": 4, "bucket_bytes": 1 << 20, "memory_frac_max": 0.1,
                           "exposed_frac_min": 0.05, "exposed_min_s": 1e-6}),
    SchedTarget("badoverlap", _badoverlap_parts, "seeded-bad: unbucketed gradient all-reduce "
                "convoy and an all-gather issued before independent layers", demo=True,
                mesh_shape={"data": 8},
                overrides={"convoy_min": 6, "bucket_bytes": 1 << 20, "memory_frac_max": 0.05,
                           "exposed_frac_min": 0.05, "exposed_min_s": 1e-6}),
    SchedTarget("badpallas", _badpallas_parts, "seeded-bad 2*x: misaligned and over-budget "
                "blocks (row 12)", demo=True, roofline=False),
)}


def run_sched_target(target: SchedTarget, device_kind: str = DEFAULT_DEVICE_KIND
                     ) -> SchedAuditReport:
    step_fn, args = target.build()
    return audit_schedule(step_fn, *args, device_kind=device_kind, label=target.name,
                          roofline=target.roofline, mfu_floor=target.mfu_floor,
                          mesh=target.mesh_shape, **dict(target.overrides))
