"""Device resolution for the port's entry points."""

from __future__ import annotations

from typing import Optional, Union

import torch

__all__ = ["resolve_device"]


def resolve_device(device: Optional[Union[str, torch.device]] = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the GPU: it returns ``cuda`` and RAISES when no GPU is
    present — there is no silent CPU fallback, so a measurement path can
    never report CPU numbers as device numbers. The CPU is used only when
    the caller asks for it explicitly (``device="cpu"``, as the tests do).
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "resolve_device: no CUDA device is available; pass "
                "device='cpu' to run on the CPU explicitly"
            )
        return torch.device("cuda")
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(f"resolve_device: {dev} requested but CUDA is unavailable")
    return dev
