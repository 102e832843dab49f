"""The schedule audit's rules, ``RKT5xx``, for Hopper (counterpart of
``rocket_tpu/analysis/rules/sched_rules.py``).

The roofline rules are the reference's checks, facts in and findings out,
over the port's cost model (``analysis/sched_audit.py``: every op of a
step traced on meta tensors, priced against the card's peaks and its
NVLink, and simulated on a compute and a collective stream):

* **RKT501** (:func:`check_exposed_comm`, reference ``:81``) — collective
  time exposed in the step as issued that the ideal-overlap simulation
  hides behind independent compute;
* **RKT502** (:func:`check_convoys`, ``:118``) — runs of small
  back-to-back collectives, latency-bound;
* **RKT503** (:func:`check_memory_bound`, ``:168``) — memory-bound ops of
  1 MiB or more (arithmetic intensity under the card's ridge, bf16 peak
  over HBM bandwidth: ~295 FLOP/B on the H100) taking most of the step.
  Eager PyTorch does not fuse: every elementwise op pays its own read and
  write, which is the port's truth, not a flaw of the model;
* **RKT505** (:func:`check_mfu_floor`, ``:262``) — the predicted MFU
  under the target's floor;
* **RKT506** — the schedule budgets (``analysis/budgets.py``'s
  ``SCHED_GATED_KEYS`` through its ``diff_budget``).

The kernel-launch rule, RKT504 (``check_pallas`` at ``:209-260`` on the
TPU), is the port's own. On the TPU the rule held each ``pallas_call``'s
blocks to the chip's VMEM (double-buffered estimate) and to its (8, 128)
tile. On Hopper every hand kernel of the port states its launch exactly
(``ops/_launch.LaunchFact``: grid, threads, dynamic and static shared
memory, and the operand tiles a CTA stages or streams), and
:func:`check_launches` holds each fact to the card of
``utils.perf.device_spec(kind)``:

* **budget** — ``dynamic_smem + static_smem`` over ``spec.smem_bytes``
  (232,448 bytes on the H100: the 227 KB a block may opt into, NVIDIA's
  Hopper tuning guide). The port allocates exactly what it
  declares, so there is no double-buffering estimate. Such a launch is
  refused by the card, never run.
* **tile misfit** — a tile whose rows do not span whole 32-byte sectors
  (the last dim's bytes not a multiple of :data:`SECTOR_BYTES`), or a tile
  of more than one row whose row count is not a multiple of
  :data:`ROW_MULTIPLE` for its itemsize (8 for 4-byte types, 16 for 2-byte
  ones: the rows of an ``mma.sync`` m16n8k16 A fragment, the counterpart of
  the reference's sublane multiple). A dim equal to the full dim of the
  operand's plane is waived, as in the reference: there is nothing more to
  fetch.

Two refinements of the TPU rule, both for what Hopper is. Loads are
fastest 16 bytes a thread, neighbouring threads on neighbouring addresses,
and device memory is read in 32-byte sectors (the CUDA C++ Programming
Guide's global-memory access rules), so a row of any whole number of
sectors is read without waste. A 128-byte
multiple (one L1 line) would flag the 64-byte rows of every 32-deep bf16
slice the tensor-core kernels stage, which coalesce into whole sectors.
And a one-row tile is a vector read with no fragment to fill, whose cost
is its byte span, which the first check covers.
"""

from __future__ import annotations

from typing import Iterable, Optional, Sequence

from rocket_tpu_torch.analysis.findings import Finding

__all__ = [
    "SCHED_RULES", "SECTOR_BYTES", "ROW_MULTIPLE", "check_convoys", "check_exposed_comm",
    "check_launches", "check_memory_bound", "check_mfu_floor", "check_numerics_declared",
]

SCHED_RULES = (
    ("RKT501", "exposed-collective",
     "collective time sits exposed on the critical path while independent "
     "compute exists to hide it (the step as issued and the ideal-overlap "
     "simulation diverge): overlap the collectives or reshard to shorten "
     "the step"),
    ("RKT502", "collective-convoy",
     "a run of small back-to-back collectives with no real compute between "
     "them: per-op latency dominates bytes — bucket or fuse them into fewer "
     "larger collectives"),
    ("RKT503", "memory-bound-critical-path",
     "large memory-bound ops (arithmetic intensity below the card's ridge "
     "point) dominate the predicted step time: the step is paying HBM "
     "bandwidth, not the tensor cores — fuse, cast down, or restructure the "
     "chain"),
    ("RKT504", "kernel-launch-misfit",
     "a hand kernel's launch asks for more shared memory per CTA than the "
     "card lets a block opt into (the launch is refused), or stages an "
     "operand tile whose rows do not span whole 32-byte sectors or whose "
     "row count is not a multiple of the tensor-core fragment's (8 for "
     "4-byte types, 16 for 2-byte ones), full dims waived"),
    ("RKT505", "predicted-mfu-floor",
     "the roofline-predicted MFU of the traced step fell below the "
     "target's declared floor: the step regressed structurally (new "
     "collectives, an op that lost its kernel, serialized communication) "
     "even if no budget metric moved"),
    ("RKT506", "schedule-budget-regression",
     "the predicted step time or exposed-communication time grew more than "
     "the tolerance over the checked-in schedule budget file"),
)

#: Bytes of one device-memory sector: a tile row should be a whole number.
SECTOR_BYTES = 32
#: Row multiple of a tile by itemsize (the ``mma.sync`` fragment's rows).
ROW_MULTIPLE = {4: 8, 2: 16, 1: 32}
_ITEMSIZE = {"float64": 8, "float32": 4, "int32": 4, "bfloat16": 2, "float16": 2,
             "int16": 2, "int8": 1, "uint8": 1, "float8_e4m3fn": 1, "float8_e5m2": 1}


def _path(label: str) -> str:
    return f"<sched:{label}>"


def _tile_faults(rows: int, cols: int, dtype: str, full: Sequence[int]) -> list:
    size = _ITEMSIZE[dtype]
    faults = []
    if (cols * size) % SECTOR_BYTES and cols != full[1]:
        faults.append(f"last dim {cols} x {size} B = {cols * size} B % {SECTOR_BYTES}")
    multiple = ROW_MULTIPLE.get(size, 8)
    if rows > 1 and rows % multiple and rows != full[0]:
        faults.append(f"rows {rows} % {multiple} ({dtype})")
    return faults


def check_launches(facts: Iterable, spec, *, label: str = "step") -> list:
    """RKT504 over ``facts`` (``ops._launch.LaunchFact``) against the card
    ``spec`` (``utils.perf.DeviceSpec``): one finding per kernel over the
    budget, and one per (kernel, tile shape, dtype) that misfits."""
    findings, seen = [], set()
    for fact in facts:
        if fact.smem_bytes > spec.smem_bytes and (fact.name, "smem") not in seen:
            seen.add((fact.name, "smem"))
            findings.append(Finding(
                "RKT504", _path(label), 0,
                f"kernel-launch-misfit: {fact.name} asks for {fact.smem_bytes:,} B of shared "
                f"memory per CTA ({fact.dynamic_smem:,} dynamic + {fact.static_smem:,} static) "
                f"over the {spec.smem_bytes:,} B a block can opt into on {spec.kind}: the card "
                "refuses the launch; shrink the tiles or split the grid",
            ))
        for (rows, cols), dtype, full in fact.tiles:
            faults = _tile_faults(rows, cols, dtype, full)
            if not faults or (fact.name, rows, cols, dtype) in seen:
                continue
            seen.add((fact.name, rows, cols, dtype))
            findings.append(Finding(
                "RKT504", _path(label), 0,
                f"kernel-launch-misfit: {fact.name} tile [{rows}, {cols}] {dtype} misaligns "
                f"with the card ({'; '.join(faults)}): its rows straddle sectors or leave "
                "fragment rows idle on every CTA; align the tile or use the full dim",
            ))
    return findings


def check_numerics_declared(facts: Iterable, *, label: str = "step") -> list:
    """RKT504's declaration leg: a launch whose fact names no ``acc_dtype``
    (``ops._launch.with_work``'s ``acc``). A ctypes launch shows the trace no
    aten op, so the kernel's own declaration is the only record of what it
    accumulates in; without it the precision audit cannot hold the kernel
    to the f32-accumulation convention. One finding per kernel."""
    findings, seen = [], set()
    for fact in facts:
        if getattr(fact, "acc_dtype", None) or fact.name in seen:
            continue
        seen.add(fact.name)
        findings.append(Finding(
            "RKT504", _path(label), 0,
            f"kernel-launch-misfit: {fact.name} declares no accumulation dtype: its launch "
            "fact must carry acc_dtype (ops._launch.with_work(..., acc=...)), what its .cu "
            "accumulates products and sums in",
        ))
    return findings


def _us(seconds: float) -> str:
    return f"{seconds * 1e6:.1f}us"


def check_exposed_comm(sim, ideal, *, exposed_frac_min: float = 0.15,
                       exposed_min_s: float = 20e-6, label: str = "step") -> list:
    """RKT501: exposed collective time the dataflow itself could hide.

    ``sim`` prices the step as issued (a collective waited on at once
    blocks the compute stream); ``ideal`` re-runs the same dataflow with
    every collective on its own stream. The difference is communication
    that independent compute COULD hide — exposure that is structural (a
    collective feeding the very next op) appears in both and is not
    flagged."""
    headroom = max(0.0, sim.exposed_comm_s - ideal.exposed_comm_s)
    step = max(sim.makespan_s, 1e-12)
    if headroom < exposed_min_s or headroom / step < exposed_frac_min:
        return []
    worst = sorted((op for op in sim.ops if op.is_comm and op.time_s > 0),
                   key=lambda op: op.time_s, reverse=True)[:3]
    tops = "; ".join(f"{op.opcode} {_us(op.time_s)} ({op.where or op.name})" for op in worst)
    return [Finding(
        "RKT501", _path(label), 0,
        f"exposed-collective: {_us(headroom)} of {_us(sim.exposed_comm_s)} exposed collective "
        f"time ({headroom / step * 100:.0f}% of the {_us(step)} step) could hide behind "
        f"independent compute — overlap the collectives or reshard to remove them; "
        f"largest: {tops}",
    )]


def check_convoys(ops: Sequence, *, convoy_min: int = 6, bucket_bytes: int = 4 << 20,
                  gap_bytes: int = 1 << 16, label: str = "step") -> list:
    """RKT502: runs of small collectives back-to-back in the step.

    A run is broken only by an op that moves more than ``gap_bytes`` of
    HBM traffic (tiny interleaved ops — a scalar scale, a bias add — do
    not hide latency). Runs of ``convoy_min``+ collectives whose MEAN
    payload is under ``bucket_bytes`` are latency-dominated: one bucketed
    collective would move the same bytes at a fraction of the latency."""
    findings = []
    run: list = []

    def flush():
        if len(run) < convoy_min:
            return
        total = sum(op.comm_bytes for op in run)
        mean = total / len(run)
        if mean >= bucket_bytes:
            return
        kinds: dict = {}
        for op in run:
            kinds[op.opcode] = kinds.get(op.opcode, 0) + 1
        kind_s = ", ".join(f"{n}x {k}" for k, n in sorted(kinds.items()))
        findings.append(Finding(
            "RKT502", _path(label), 0,
            f"collective-convoy: {len(run)} back-to-back collectives ({kind_s}) moving "
            f"{total / 2**20:.2f} MiB total (mean {mean / 2**10:.0f} KiB/op, "
            f"{_us(sum(op.time_s for op in run))}) — bucket/fuse them into fewer larger "
            f"collectives; first at {run[0].where or run[0].name}",
        ))

    for op in ops:
        if op.is_comm:
            if op.comm_bytes > 0 or op.time_s > 0:
                run.append(op)
            continue
        if op.hbm_bytes > gap_bytes:
            flush()
            run = []
    flush()
    return findings


def check_memory_bound(ops: Sequence, makespan_s: float, ridge: float, *,
                       memory_frac_max: float = 0.6, min_bytes: int = 1 << 20,
                       label: str = "step") -> list:
    """RKT503: large memory-bound ops dominating the predicted step.

    Only ops moving ``min_bytes``+ count — a tiny model is legitimately
    all memory-bound and a norm's scale is policy, not a hazard. The
    finding names the top offenders so the fix (fuse, narrow the dtype,
    restructure) has an address."""
    heavy = [op for op in ops
             if op.kind == "memory" and not op.is_comm and op.hbm_bytes >= min_bytes]
    total = sum(op.time_s for op in heavy)
    step = max(makespan_s, 1e-12)
    if not heavy or total / step <= memory_frac_max:
        return []
    worst = sorted(heavy, key=lambda op: op.time_s, reverse=True)[:3]
    tops = "; ".join(
        f"{op.opcode} {op.hbm_bytes / 2**20:.1f} MiB AI={op.intensity:.1f} "
        f"{_us(op.time_s)} ({op.where or op.name})" for op in worst)
    return [Finding(
        "RKT503", _path(label), 0,
        f"memory-bound-critical-path: {len(heavy)} ops moving >= {min_bytes >> 20} MiB each "
        f"at arithmetic intensity below the ridge ({ridge:.0f} FLOP/B) take {_us(total)} of "
        f"the {_us(step)} step ({total / step * 100:.0f}%) — the step pays HBM bandwidth, not "
        f"the tensor cores; worst: {tops}",
    )]


def check_mfu_floor(predicted_mfu: Optional[float], floor: float, *,
                    label: str = "step") -> list:
    """RKT505: roofline-predicted MFU below the target's declared floor."""
    if predicted_mfu is None or floor <= 0 or predicted_mfu >= floor:
        return []
    return [Finding(
        "RKT505", _path(label), 0,
        f"predicted-mfu-floor: roofline-predicted MFU {predicted_mfu:.3f} fell below this "
        f"target's floor {floor:.3f} — the traced step regressed (new collectives, an op that "
        "lost its kernel, serialized communication); inspect the step-time attribution and "
        "re-baseline the floor only if the regression is intended",
    )]
