"""Device peak tables (counterpart of ``rocket_tpu/utils/perf.py``), keyed
by ``torch.cuda.get_device_name()`` instead of the TPU kind: the MFU
denominator of the Profiler capsule (``PEAK_FLOPS``, ``peak_flops``) and
the per-card constants the tuner's legality rules read (``DeviceSpec``,
``device_spec``). Matching is longest prefix in both."""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional

import torch

__all__ = ["PEAK_FLOPS", "peak_flops", "DeviceSpec", "DEVICE_SPECS", "device_spec"]

@dataclass(frozen=True)
class DeviceSpec:
    """Per-card constants: ``flops_bf16`` and ``flops_f32`` (dense, FLOP/s),
    ``hbm_bw`` (bytes/s), ``smem_bytes``, the shared memory one block may
    opt into — the budget the tuner's legality rules and the schedule
    audit's RKT504 hold a kernel's tiles to (the reference's
    ``vmem_bytes``) — and ``sms``, the streaming multiprocessors, which
    size the grids that fill the card.

    For the schedule audit's cost model (the reference's ICI fields):
    ``link_bw``, the bytes/s a card sends one way over its NVLink ports,
    which prices every collective and point-to-point hop of a one-node
    group (the NVSwitch fabric gives each card its whole link rate to any
    peer), and ``collective_latency_s``, the fixed cost added to each
    collective on top of its bytes (what makes a convoy of tiny
    collectives cost what it does). ``ridge`` is the arithmetic intensity
    (FLOP/byte) past which a bf16 op is compute-bound.

    For the memory audit: ``hbm_bytes``, the card's memory capacity (the
    reference's field), which its out-of-memory frontier and RKT804 read."""

    kind: str
    flops_bf16: float
    flops_f32: float
    hbm_bw: float
    smem_bytes: int
    sms: int
    link_bw: float = 450e9
    collective_latency_s: float = 5e-6
    hbm_bytes: int = 80 << 30

    @property
    def ridge(self) -> float:
        return self.flops_bf16 / self.hbm_bw


#: Constants by ``torch.cuda.get_device_name()`` prefix: NVIDIA's data
#: sheets (SXM parts, dense, at their full power limit; NVLink 4 at 900
#: GB/s both ways per card, so 450e9 bytes/s one way) and the Hopper
#: tuning guide's 227 KB (232,448 bytes) shared-memory opt-in per block.
#: The collective latency is the cost model's constant, not a data-sheet
#: figure: a few microseconds, the order of one small NCCL collective
#: inside an NVLink node (PERF.md keeps it an open question: the card's
#: ranks here share one card, so no run measures it). The capacities are
#: the data sheets' (NVIDIA H100 and H200 Tensor Core GPU, SXM): 80 GB of
#: HBM3 and 141 GB of HBM3e, read as GiB (the H100's five 16 GiB stacks);
#: the driver keeps part of it, so the card's ``total_memory`` reads
#: somewhat less.
DEVICE_SPECS = {
    spec.kind: spec
    for spec in (
        DeviceSpec("NVIDIA H100", 989e12, 67e12, 3.35e12, 232448, 132, hbm_bytes=80 << 30),
        DeviceSpec("NVIDIA H200", 989e12, 67e12, 4.8e12, 232448, 132, hbm_bytes=141 << 30),
    )
}

#: Dense bf16 tensor-core peak by device-name prefix — the MFU denominator.
PEAK_FLOPS = {kind: spec.flops_bf16 for kind, spec in DEVICE_SPECS.items()}


def _longest_prefix(table: dict, kind: str):
    best = None
    for prefix, value in table.items():
        if kind.startswith(prefix) and (best is None or len(prefix) > best[0]):
            best = (len(prefix), value)
    return None if best is None else best[1]


def device_name(device=None) -> str:
    """``torch.cuda.get_device_name`` of ``device`` (default: the current
    CUDA device), or ``"cpu"`` off the card."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda" and torch.cuda.is_available():
        return torch.cuda.get_device_name(device)
    return "cpu"


def peak_flops(device=None) -> Optional[float]:
    """The bf16 peak of ``device`` (default: the current CUDA device), or
    None on the CPU or an unknown card — callers then omit MFU rather than
    compute it against the wrong peak."""
    return _longest_prefix(PEAK_FLOPS, device_name(device))


def device_spec(device=None) -> Optional[DeviceSpec]:
    """The constants of a device or a device-name string, or None when the
    card is unknown (callers skip the check rather than price against the
    wrong card). A string prices a card that is not present."""
    named = isinstance(device, str) and not device.startswith(("cpu", "cuda"))
    kind = device if named else device_name(device)
    return _longest_prefix(DEVICE_SPECS, kind)
