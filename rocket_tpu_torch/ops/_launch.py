"""Argument checks shared by the kernel wrappers."""

from __future__ import annotations

import torch

__all__ = ["DTYPE_CODES", "check_cuda_operands", "stream_of"]

#: Operand dtypes the kernels are compiled for, and their code in the C ABI.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def check_cuda_operands(what: str, **tensors: torch.Tensor) -> None:
    """Every operand on one CUDA device and contiguous; raise otherwise."""
    device = None
    for name, t in tensors.items():
        if t.device.type != "cuda":
            raise ValueError(f"{what}: {name} is on {t.device}, expected a CUDA device")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, other operands on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream
