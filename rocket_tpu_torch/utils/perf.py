"""Device peak table — the MFU denominator of the Profiler capsule
(counterpart of ``rocket_tpu/utils/perf.py``'s ``PEAK_FLOPS`` and
``peak_flops``, keyed by the CUDA device name instead of the TPU kind).
The roofline ``DeviceSpec`` table waits for the analysis tooling."""

from __future__ import annotations

from typing import Optional

import torch

__all__ = ["PEAK_FLOPS", "peak_flops"]

#: Dense bf16 tensor-core peak by ``torch.cuda.get_device_name()`` prefix
#: (NVIDIA's data sheets, SXM parts at their full power limit). Matching is
#: longest prefix.
PEAK_FLOPS = {
    "NVIDIA H100": 989e12,
    "NVIDIA H200": 989e12,
}


def peak_flops(device=None) -> Optional[float]:
    """The bf16 peak of ``device`` (default: the current CUDA device), or
    None on the CPU or an unknown card — callers then omit MFU rather than
    compute it against the wrong peak."""
    device = torch.device("cuda") if device is None else torch.device(device)
    if device.type == "cuda" and torch.cuda.is_available():
        name = torch.cuda.get_device_name(device)
    else:
        name = device.type
    best = None
    for prefix, value in PEAK_FLOPS.items():
        if name.startswith(prefix) and (best is None or len(prefix) > len(best[0])):
            best = (prefix, value)
    return None if best is None else best[1]
