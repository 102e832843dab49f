"""The memory audit for the port: the liveness of an eager step, its
in-place update and its out-of-memory frontier (RKT801-805; counterpart
of ``rocket_tpu/analysis/mem_audit.py``).

The schedule audit prices a step's *time*; this module prices its
*space*. The reference replayed XLA's schedule, a buffer born at its
producer and dead after its last consumer. Eager PyTorch has no schedule
to replay: it allocates when an op writes a new storage and frees when
the last reference to it drops. :class:`LivenessTracer` records exactly
that while the step runs on meta tensors (shapes and dtypes, no memory):

* a ``TorchDispatchMode`` sees every aten op below autograd, the
  backward's and the remat's recompute included; each op output on a new
  storage is a birth, its bytes rounded up to the CUDA caching
  allocator's 512-byte block; a ``weakref.finalize`` on the storage
  records its death when the last view of it dies. The tracer holds no
  reference to any tensor, so it sees every death where the card would;
* views and other aliasing ops add no bytes (the storage is known), nor
  do writes into the step's own arguments (the in-place update): those are
  RKT801's covered bytes;
* the arguments (the train state the target declares: params and
  optimizer moments; every other device tensor the step reads is its
  batch) are live for the whole step, as the reference's parameters are;
* saved-for-backward is what ``torch.autograd.graph.saved_tensors_hooks``
  packs outside any ``torch.utils.checkpoint`` region (a non-reentrant
  checkpoint packs its region's saves into hooks of its own), each
  storage once, arguments left out. The reference's structural definition
  (born before the forward/backward boundary, consumed after it) is kept
  beside it (``saved_carried_bytes``): the boundary is the first op the
  autograd engine runs.

The peak of the watermark is split into state / batch / saved
activations / collective buffers (the outputs of the collectives' meta
routes, ``CommFact``) / temps. Wrapper scratch counts: every hand kernel's
wrapper allocates its scratch (row 4's f32 dq partials, 402,653,184 bytes
at GPT-2's shape) with ``torch.empty`` on the caller's device before its
meta route. The out-of-memory frontier of each card of
``utils.perf.DEVICE_SPECS`` comes from the batch-proportional part of the
peak: a second trace at twice the batch gives it.

On the card the model is held to the allocator: ``chip_smoke.py``'s
``mem`` phase runs the same step (``sched_audit._gpt2_parts(device=
"cuda")``) and reconciles ``torch.cuda.max_memory_allocated()`` with the
predicted peak (RKT805). On the CPU ``measured_peak_bytes`` is null. What
the card allocates and meta never does (cuBLAS workspaces, blocks the
allocator does not split) is the gap PERF.md names.

CLI: ``python -m rocket_tpu_torch.analysis mem`` (budgets under
``tests/fixtures/torch_budgets/mem/``).
"""

from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Callable, Mapping, Optional, Sequence

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten, tree_map

from rocket_tpu_torch.analysis.findings import Finding
from rocket_tpu_torch.analysis.rules.mem_rules import (
    check_donation_coverage,
    check_oom_frontier,
    check_reconciliation,
    check_remat_effectiveness,
)
from rocket_tpu_torch.analysis.sched_audit import _ALLOCATIONS, DEFAULT_DEVICE_KIND, _aliases
from rocket_tpu_torch.analysis.shard_audit import collective_op
from rocket_tpu_torch.ops._launch import CommFact, record_launches
from rocket_tpu_torch.utils.perf import DEVICE_SPECS, device_spec

__all__ = [
    "BLOCK_BYTES",
    "LivenessTracer",
    "LivenessResult",
    "simulate_liveness",
    "train_state",
    "MemAuditReport",
    "audit_memory",
    "MemTarget",
    "MEM_TARGETS",
    "run_mem_target",
]

#: The CUDA caching allocator's block: every allocation rounds up to it.
BLOCK_BYTES = 512


def _blocks(nbytes: int) -> int:
    return -(-int(nbytes) // BLOCK_BYTES) * BLOCK_BYTES


def _device_tensors(tree) -> list:
    return [t for t in tree_flatten(tree)[0]
            if isinstance(t, torch.Tensor) and t.device.type != "cpu"]


def _storage(t: torch.Tensor):
    try:
        return t.untyped_storage()
    except (RuntimeError, NotImplementedError):  # a tensor without storage
        return None


def _current_node():
    current = getattr(torch._C, "_current_autograd_node", None)
    return current() if current is not None else None


def _written(func, args, kwargs) -> list:
    """The tensors an op writes in place: its arguments the schema marks
    as written (``self`` of ``add_``, ``out=``, a foreach op's list)."""
    out = []
    schema = func._schema
    for i, arg in enumerate(schema.arguments):
        if arg.alias_info is None or not arg.alias_info.is_write:
            continue
        value = args[i] if i < len(args) else kwargs.get(arg.name)
        out.extend(_device_tensors(value))
    return out


@dataclass
class _Buffer:
    """One storage the tracer saw: its bytes (rounded to the block), where
    it was born (-1: before the step, an argument), its kind (``"state"``,
    ``"batch"`` or ``"temp"``), whether a collective wrote it, and the ops
    that read it (first and last, views and allocations left out)."""

    nbytes: int
    born: int
    kind: str
    raw_bytes: int = 0
    collective: bool = False
    first_read: Optional[int] = None
    last_read: Optional[int] = None
    died: Optional[int] = None


class LivenessTracer(TorchDispatchMode):
    """Records the lifetime of every device storage a step touches while it
    runs on meta tensors (module docstring). ``state`` are the train
    state's tensors, live for the whole step. Use through
    :func:`simulate_liveness`."""

    def __init__(self, state: Sequence[torch.Tensor] = ()) -> None:
        super().__init__()
        self.buffers: dict = {}        # key -> _Buffer
        self.events: list = []         # (op index, key, +bytes or -bytes)
        self.n_ops = 0
        self.boundary: Optional[int] = None
        self.inplace: set = set()      # state keys written in place
        self.saved: set = set()        # temp keys packed by the outer hook
        self.collectives: list = []
        self._key_of: dict = {}        # id(storage) -> key while it lives
        self._finalizers: list = []
        for t in state:
            self._key(t, "state")

    def _key(self, t: torch.Tensor, kind: str):
        """The key of ``t``'s storage; an unknown one is registered as
        ``kind`` (an argument if not a temp)."""
        s = _storage(t)
        if s is None:
            return None
        key = self._key_of.get(id(s))
        if key is not None:
            return key
        key = len(self.buffers)
        raw = s.nbytes()
        self.buffers[key] = _Buffer(_blocks(raw), -1 if kind != "temp" else self.n_ops, kind,
                                    raw)
        self._key_of[id(s)] = key
        self._finalizers.append(weakref.finalize(s, self._die, key, id(s)))
        if kind == "temp" and raw:
            self.events.append((self.n_ops, key, self.buffers[key].nbytes))
        return key

    def _die(self, key: int, sid: int) -> None:
        self._key_of.pop(sid, None)
        buf = self.buffers[key]
        buf.died = self.n_ops
        if buf.kind == "temp" and buf.raw_bytes:
            self.events.append((self.n_ops, key, -buf.nbytes))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        index = self.n_ops
        if self.boundary is None and _current_node() is not None:
            self.boundary = index
        ins = _device_tensors((args, kwargs))
        written = _written(func, args, kwargs)
        reads = not _aliases(func) and func._schema.name not in _ALLOCATIONS
        for t in ins:
            key = self._key(t, "batch")
            if key is not None and reads:
                buf = self.buffers[key]
                if buf.first_read is None:
                    buf.first_read = index
                buf.last_read = index
        for t in written:
            key = self._key(t, "batch")
            if key is not None and self.buffers[key].kind == "state":
                self.inplace.add(key)
        out = func(*args, **kwargs)
        for t in _device_tensors(out):
            self._key(t, "temp")
        self.n_ops += 1
        return out

    # -- the saved-tensor hooks and the collectives' meta routes ---------------

    def _pack(self, t: torch.Tensor):
        if t.device.type != "cpu":
            s = _storage(t)
            key = None if s is None else self._key_of.get(id(s))
            if key is not None and self.buffers[key].kind == "temp":
                self.saved.add(key)
        # A detached view: packing the tensor itself would tie it to its own
        # grad_fn in a cycle only the garbage collector frees.
        return t.detach()

    @staticmethod
    def _unpack(t):
        return t

    def note(self, facts, inputs, outputs) -> None:
        """``record_launches``' sink: a collective's results are collective
        buffers; a kernel's launch adds nothing (its outputs and scratch are
        the wrapper's allocations, already seen)."""
        for fact in facts:
            if not isinstance(fact, CommFact):
                continue
            self.collectives.append(collective_op(fact, inputs, outputs))
            for t in _device_tensors(list(outputs) or list(inputs)):
                key = self._key(t, "temp")
                if key is not None:
                    self.buffers[key].collective = True

    @contextlib.contextmanager
    def tracing(self, device_kind: str = DEFAULT_DEVICE_KIND):
        """The block runs under the tracer, its saved-tensor hooks and its
        collective sink, tune-table lookups resolving as on
        ``device_kind``."""
        from rocket_tpu_torch.tune import priced_device_kind

        try:
            with priced_device_kind(device_kind), record_launches(sink=self), \
                    torch.autograd.graph.saved_tensors_hooks(self._pack, self._unpack), self:
                yield self
        finally:
            for fin in self._finalizers:  # deaths after the step are not the step's
                fin.detach()


@dataclass
class LivenessResult:
    """The simulated watermark and its attribution (the reference's fields,
    and the port's saved-set check)."""

    peak_bytes: int                  # arguments + peak live temps
    peak_temp_bytes: int
    peak_index: int                  # op index of the watermark
    argument_bytes: int              # every storage live before the step
    state_bytes: int                 # the declared train state among them
    inplace_bytes: int               # state written in place (RKT801; unrounded)
    saved_activation_bytes: int      # packed outside any checkpoint
    saved_carried_bytes: int         # born before the boundary, read after
    #: live-at-peak attribution: state / batch / saved_activations /
    #: collectives / temps (bytes each)
    peak_breakdown: dict = field(default_factory=dict)
    n_buffers: int = 0
    n_ops: int = 0
    boundary_index: Optional[int] = None
    saved: frozenset = frozenset()   # keys of the hook's set
    carried: frozenset = frozenset()  # keys of the structural set
    collectives: list = field(default_factory=list)

    @property
    def batch_bytes(self) -> int:
        return self.argument_bytes - self.state_bytes

    @property
    def undonated_arg_bytes(self) -> int:
        return max(0, self.argument_bytes - self.inplace_bytes)


def summarize(tracer: LivenessTracer) -> LivenessResult:
    """The watermark of a finished :class:`LivenessTracer`: its peak (the
    first time the live temps reach their maximum), the live set there
    split five ways, and both saved sets."""
    buffers = tracer.buffers
    live = peak = 0
    peak_event = -1
    for i, (_index, _key, delta) in enumerate(tracer.events):
        live += delta
        if live > peak:
            peak, peak_event = live, i
    at_peak: set = set()
    for _index, key, delta in tracer.events[:peak_event + 1]:
        if delta > 0:
            at_peak.add(key)
        else:
            at_peak.discard(key)
    peak_index = tracer.events[peak_event][0] if peak_event >= 0 else 0
    args = [b for b in buffers.values() if b.kind != "temp"]
    argument_bytes = sum(b.nbytes for b in args)
    state_bytes = sum(b.nbytes for b in args if b.kind == "state")
    boundary = tracer.boundary
    carried = frozenset(
        key for key, b in buffers.items()
        if b.kind == "temp" and boundary is not None and b.born < boundary
        and b.first_read is not None and b.first_read < boundary
        and b.last_read is not None and b.last_read >= boundary)
    saved = frozenset(tracer.saved)
    breakdown = {"state": state_bytes, "batch": argument_bytes - state_bytes,
                 "saved_activations": 0, "collectives": 0, "temps": 0}
    for key in at_peak:
        b = buffers[key]
        part = ("collectives" if b.collective else
                "saved_activations" if key in saved else "temps")
        breakdown[part] += b.nbytes
    return LivenessResult(
        peak_bytes=argument_bytes + peak,
        peak_temp_bytes=peak,
        peak_index=peak_index,
        argument_bytes=argument_bytes,
        state_bytes=state_bytes,
        inplace_bytes=sum(buffers[k].raw_bytes for k in tracer.inplace),
        saved_activation_bytes=sum(buffers[k].nbytes for k in saved),
        saved_carried_bytes=sum(buffers[k].nbytes for k in carried),
        peak_breakdown=breakdown,
        n_buffers=len(buffers),
        n_ops=tracer.n_ops,
        boundary_index=boundary,
        saved=saved,
        carried=carried,
        collectives=list(tracer.collectives),
    )


def simulate_liveness(step_fn: Callable, *args, state: Sequence[torch.Tensor] = (),
                      device_kind: str = DEFAULT_DEVICE_KIND) -> LivenessResult:
    """Run ``step_fn(*args)`` (meta tensors in ``args``) under a
    :class:`LivenessTracer` and summarize its watermark. ``state`` are the
    train state's tensors (params, optimizer moments); every other device
    tensor the step reads counts as its batch."""
    tracer = LivenessTracer(state)
    with tracer.tracing(device_kind):
        step_fn(*args)
    return summarize(tracer)


def train_state(step_fn) -> tuple:
    """``(device tensors, host bytes)`` of the train state a target's step
    carries (``sched_audit``'s builders): its ``leaves``, the optimizer's
    tensors on the device (AdamW's two moments), the model state's
    (running statistics). ``torch.optim``'s step counters live on the host
    unless ``capturable``, so they are not device state: their bytes come
    back apart."""
    tensors = list(getattr(step_fn, "leaves", ()))
    host = 0
    opt = getattr(step_fn, "optimizer", None)
    for per_param in (opt.state.values() if opt is not None else ()):
        for value in per_param.values():
            if not isinstance(value, torch.Tensor):
                continue
            if value.device.type == "cpu":
                host += value.numel() * value.element_size()
            else:
                tensors.append(value)
    tensors += _device_tensors(getattr(step_fn, "model_state", None))
    return tensors, host


# -- the audit -----------------------------------------------------------------------


@dataclass
class MemAuditReport:
    """Findings plus the memory record the budget gate consumes."""

    label: str
    findings: list = field(default_factory=list)
    liveness: Optional[LivenessResult] = None
    record: dict = field(default_factory=dict)

    @property
    def clean(self) -> bool:
        return not self.findings


def _nbytes(tensors) -> int:
    """Bytes of ``tensors``, each storage once (unrounded)."""
    seen: dict = {}
    for t in tensors:
        s = _storage(t)
        if s is not None:
            seen[id(s)] = s.nbytes()
    return sum(seen.values())


def _scaled(args, keep: set, factor: int):
    """``args`` with every device tensor outside ``keep`` (storage ids)
    grown ``factor``-fold on its leading dim: the batch at a multiple."""
    def grow(t):
        if not isinstance(t, torch.Tensor) or t.device.type == "cpu" or not t.dim():
            return t
        s = _storage(t)
        if s is not None and id(s) in keep:
            return t
        return torch.empty((t.shape[0] * factor,) + tuple(t.shape[1:]), dtype=t.dtype,
                           device=t.device)
    return tree_map(grow, args)


def _batch_size(args, keep: set) -> int:
    for t in _device_tensors(args):
        s = _storage(t)
        if t.dim() and (s is None or id(s) not in keep):
            return int(t.shape[0])
    return 0


def audit_memory(
    step_fn: Callable,
    *args,
    state=(),
    warmup: int = 0,
    mesh_shape: Optional[Mapping[str, int]] = None,
    device_kind: str = DEFAULT_DEVICE_KIND,
    expects_donation: Optional[bool] = None,
    coverage_min: float = 0.9,
    remat_saved_max: int = 0,
    capacity_bytes: int = 0,
    recon_floor: float = 0.5,
    measured_peak_bytes: Optional[int] = None,
    slope: bool = True,
    label: str = "step",
) -> MemAuditReport:
    """Audit the memory of ``step_fn(*args)`` (meta tensors in ``args``).

    ``state`` is the train state (params, optimizer moments): a sequence of
    tensors, or a callable returning ``(tensors, host bytes)`` read after
    ``warmup`` untraced steps (the first step of ``torch.optim``'s AdamW
    creates its moments: the priced step is the one after, with the
    moments as arguments). RKT801 holds the bytes written in place to the
    state's (``expects_donation`` defaults to whether there is state; eval
    steps pass False), RKT802 the saved set to ``remat_saved_max`` (0
    disables), RKT804 the peak to ``capacity_bytes`` (0: the audited
    card's memory), RKT805 the peak to ``measured_peak_bytes`` (the
    allocator's, from a run on the card; None skips it); RKT803 is the
    CLI's budget gate over the record this returns. With ``slope`` the
    step is traced again at twice its batch (every non-state device tensor
    grown on its leading dim), which gives the batch-proportional part of
    the peak the frontier is read from; otherwise the reference's split
    (all above the state is per sample). Nothing runs on a device.
    """
    spec = device_spec(device_kind)
    if spec is None:
        raise ValueError(
            f"mem_audit: unknown device kind {device_kind!r} — add it "
            "to rocket_tpu_torch.utils.perf.DEVICE_SPECS"
        )
    from rocket_tpu_torch.tune import priced_device_kind

    with priced_device_kind(device_kind):
        for _ in range(warmup):
            step_fn(*args)
    tensors, host_bytes = state() if callable(state) else (list(state), 0)
    if expects_donation is None:
        expects_donation = bool(tensors)
    report = MemAuditReport(label=label)
    liveness = simulate_liveness(step_fn, *args, state=tensors, device_kind=device_kind)
    report.liveness = liveness
    expected_state = _nbytes(tensors)
    keep = {id(_storage(t)) for t in tensors}
    batch_size = _batch_size(args, keep)

    peak = liveness.peak_bytes
    fixed, per_sample = min(expected_state, peak), 0.0
    if batch_size > 0 and slope:
        double = simulate_liveness(step_fn, *_scaled(args, keep, 2), state=tensors,
                                   device_kind=device_kind)
        per_sample = max(0.0, (double.peak_bytes - peak) / batch_size)
        fixed = max(0, int(peak - per_sample * batch_size))
    elif batch_size > 0:
        per_sample = max(0, peak - fixed) / batch_size
    frontier: dict[str, int] = {}
    if per_sample > 0:
        for kind, dev in sorted(DEVICE_SPECS.items()):
            frontier[kind] = max(0, int((dev.hbm_bytes - fixed) // per_sample))
    capacity = capacity_bytes or spec.hbm_bytes

    findings: list[Finding] = []
    findings.extend(check_donation_coverage(
        liveness.inplace_bytes, expected_state, expects_donation=expects_donation,
        coverage_min=coverage_min, label=label,
    ))
    findings.extend(check_remat_effectiveness(
        liveness.saved_activation_bytes, remat_saved_max, label=label,
    ))
    findings.extend(check_oom_frontier(
        peak, capacity, frontier=frontier, batch_size=batch_size, label=label,
    ))
    findings.extend(check_reconciliation(
        peak, measured_peak_bytes, floor=recon_floor, label=label,
    ))

    recon = None
    if measured_peak_bytes:
        recon = round(abs(peak - measured_peak_bytes) / measured_peak_bytes, 4)
    report.record = {
        "device_kind": spec.kind,
        "mesh": dict(mesh_shape or {"data": 1}),
        "batch_size": batch_size,
        "predicted_peak_bytes": int(peak),
        "peak_temp_bytes": int(liveness.peak_temp_bytes),
        "argument_bytes": int(liveness.argument_bytes),
        "donated_bytes": int(liveness.inplace_bytes),
        "undonated_argument_bytes": int(liveness.undonated_arg_bytes),
        "expected_state_bytes": int(expected_state),
        "host_state_bytes": int(host_bytes),
        "saved_activation_bytes": int(liveness.saved_activation_bytes),
        "saved_carried_bytes": int(liveness.saved_carried_bytes),
        "peak_breakdown": {k: int(v) for k, v in liveness.peak_breakdown.items()},
        "measured_peak_bytes": measured_peak_bytes,
        "reconciliation_error": recon,
        "fixed_bytes": int(fixed),
        "per_sample_bytes": int(per_sample),
        "oom_frontier": frontier,
        "capacity_bytes": int(capacity),
        "n_buffers": int(liveness.n_buffers),
        "n_ops": int(liveness.n_ops),
    }
    report.findings = findings
    return report


def render_mem(label: str, record: Mapping) -> str:
    """One line of a target's memory: its peak, the split and the
    frontier per card."""
    gb = 1e9
    split = ", ".join(f"{k} {v / gb:.3f}" for k, v in record["peak_breakdown"].items())
    frontier = ", ".join(f"{k} {v}" for k, v in record["oom_frontier"].items())
    return (f"{label}: predicted peak {record['predicted_peak_bytes'] / gb:.3f} GB at batch "
            f"{record['batch_size']} on {record['device_kind']} ({split} GB; saved "
            f"{record['saved_activation_bytes'] / gb:.3f} GB), OOM frontier: "
            f"{frontier or 'n/a'}")


# -- builtin targets ---------------------------------------------------------------


@dataclass(frozen=True)
class MemTarget:
    """One self-gate configuration the CLI audits: ``build() ->
    (step_fn, args)`` with meta tensors in ``args``, its train state read
    by :func:`train_state`. ``warmup`` untraced steps come first (AdamW
    creates its moments in its first); ``remat_saved_max`` (RKT802) and
    ``capacity_bytes`` (RKT804) default to disabled / the card's memory;
    ``expects_donation=False`` exempts eval steps from RKT801."""

    name: str
    mesh_shape: Mapping[str, int]
    build: Callable[[], tuple]
    doc: str = ""
    warmup: int = 0
    expects_donation: bool = True
    remat_saved_max: int = 0
    capacity_bytes: int = 0
    slope: bool = True
    demo: bool = False


def _badmem_parts(checkpointed: bool = False):
    """Seeded-bad train step for the true-positive fixture tests (the
    reference's 12-link chain): the params are updated OUT of place
    (``p - 1e-3 g`` into fresh tensors: RKT801, the transient 2x copy), the
    forward is a remat-free ``tanh(h @ w)`` chain of 256x256 f32 links
    whose every output survives for the backward (RKT802 against the
    target's declared ceiling), and the target's ``capacity_bytes`` is set
    below the resulting watermark (RKT804). ``checkpointed`` wraps links
    2-12 in a non-reentrant ``torch.utils.checkpoint`` (the tests' remat
    check)."""
    from torch.utils.checkpoint import checkpoint

    meta = torch.device("meta")
    ws = [torch.empty(256, 256, device=meta, requires_grad=True) for _ in range(12)]
    x = torch.empty(256, 256, device=meta)

    def chain(h, *links):
        for w in links:
            # tanh pins every link's output into the saved set: its
            # backward needs the output, and nothing is rematerialized.
            h = torch.tanh(h @ w)
        return h

    def bad_step(x, *params):
        with torch.enable_grad():
            h = chain(x, params[0])
            h = (checkpoint(chain, h, *params[1:], use_reentrant=False) if checkpointed
                 else chain(h, *params[1:]))
            loss = (h * h).mean()
            grads = torch.autograd.grad(loss, params)
        # Out of place: the seeded RKT801.
        return [p.detach() - 1e-3 * g for p, g in zip(params, grads)], loss.detach()

    bad_step.leaves = ws
    return bad_step, (x, *ws)


def _train_flash_mem_parts():
    from rocket_tpu_torch.analysis.sched_audit import _gpt2_parts

    return _gpt2_parts(1024)


def _parallel(mesh, rules: str, train: bool = True):
    def build():
        from rocket_tpu_torch.analysis.sched_audit import _parallel_lm_parts
        from rocket_tpu_torch.parallel import sharding

        rule = (sharding.gpt2_tp_rules(axis="model") if rules == "tp"
                else sharding.fsdp_rules(axis="data", min_size=4096))
        return _parallel_lm_parts(mesh, rule, train=train)
    return build


def _resnet_parts():
    from rocket_tpu_torch.analysis.sched_audit import _dp_resnet_parts

    return _dp_resnet_parts()


#: name -> target. The default sweep runs the non-demo entries: the
#: reference's five train/eval pairings (one rank's step, as the SPMD and
#: schedule audits trace it) and the port's ``train_flash``, the step
#: ``chip_smoke.py``'s ``mem`` phase reconciles on the card.
MEM_TARGETS: dict[str, MemTarget] = {target.name: target for target in (
    MemTarget("train_flash", {"data": 1}, _train_flash_mem_parts,
              "GPT-2 124M train step, B=8 T=1024, bf16, remat, AdamW (its second step)",
              warmup=1),
    MemTarget("tp_1x8", {"data": 1, "model": 8}, _parallel({"data": 1, "model": 8}, "tp"),
              "audit LM train step, one rank of model 8"),
    MemTarget("tp_2x4", {"data": 2, "model": 4}, _parallel({"data": 2, "model": 4}, "tp"),
              "audit LM train step, one rank of data 2 x model 4"),
    MemTarget("tp_2x4_eval", {"data": 2, "model": 4},
              _parallel({"data": 2, "model": 4}, "tp", train=False),
              "audit LM eval forward, one rank of data 2 x model 4", expects_donation=False),
    MemTarget("fsdp_1x8", {"data": 8}, _parallel({"data": 8}, "fsdp"),
              "audit LM train step, one rank of 8 FSDP ranks"),
    MemTarget("dp_resnet_1x8", {"data": 8}, _resnet_parts,
              "ResNet-18 CIFAR train step with sync-BN, one rank of 8 data ranks"),
    # The chain saves 12 x 256x256 f32 activations (3 MiB); a declared
    # 64 KiB remat ceiling makes RKT802 undeniable, and a capacity below
    # the watermark RKT804's seeded out-of-memory.
    MemTarget("badmem", {"data": 1}, _badmem_parts,
              "seeded-bad: out-of-place update, remat-free chain, 2 MiB capacity",
              remat_saved_max=1 << 16, capacity_bytes=2 << 20, slope=False, demo=True),
)}


def run_mem_target(target: MemTarget, device_kind: Optional[str] = None) -> MemAuditReport:
    """Build the target's step and audit it, priced as ``device_kind``
    (default: the H100)."""
    step_fn, args = target.build()
    return audit_memory(
        step_fn, *args, state=lambda: train_state(step_fn), warmup=target.warmup,
        mesh_shape=target.mesh_shape, device_kind=device_kind or DEFAULT_DEVICE_KIND,
        expects_donation=target.expects_donation, remat_saved_max=target.remat_saved_max,
        capacity_bytes=target.capacity_bytes, slope=target.slope, label=target.name,
    )
