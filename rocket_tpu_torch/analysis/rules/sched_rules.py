"""The schedule audit's kernel-launch rule, RKT504, for Hopper (counterpart
of ``rocket_tpu/analysis/rules/sched_rules.py``, ``:39-70`` and
``check_pallas`` at ``:209-260``).

On the TPU the rule held each ``pallas_call``'s blocks to the chip's VMEM
(double-buffered estimate) and to its (8, 128) tile. On Hopper every hand
kernel of the port states its launch exactly (``ops/_launch.LaunchFact``:
grid, threads, dynamic and static shared memory, and the operand tiles a
CTA stages or streams), and :func:`check_launches` holds each fact to the
card of ``utils.perf.device_spec(kind)``:

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

from typing import Iterable, Sequence

from rocket_tpu_torch.analysis.findings import Finding

__all__ = ["SCHED_RULES", "SECTOR_BYTES", "ROW_MULTIPLE", "check_launches"]

SCHED_RULES = (
    ("RKT504", "kernel-launch-misfit",
     "a hand kernel's launch asks for more shared memory per CTA than the "
     "card lets a block opt into (the launch is refused), or stages an "
     "operand tile whose rows do not span whole 32-byte sectors or whose "
     "row count is not a multiple of the tensor-core fragment's (8 for "
     "4-byte types, 16 for 2-byte ones), full dims waived"),
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
