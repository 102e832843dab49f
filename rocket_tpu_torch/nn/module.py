"""The layer protocol of the port: a layer is a description, its parameters
an explicit nested dict of tensors threaded through :meth:`Layer.apply`.

The dicts are laid out exactly as the JAX package's param pytrees
(``{"w", "b"}``, ``{"scale", "bias"}``, ``{"table"}``), so a JAX tree
converts with a rename-free copy (``rocket_tpu_torch.bridge``). Only the
inference half of the JAX protocol is here: no ``state``, no ``mode`` and
no rng — the ported layers run in eval semantics.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["Layer", "map_params"]


class Layer:
    """Base layer: ``init_params(gen)`` draws float32 parameters on the CPU
    from a ``torch.Generator``; ``apply(params, x)`` computes the output."""

    def init_params(self, gen: torch.Generator) -> dict:
        return {}

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        return self.apply(params, x)

    def __repr__(self) -> str:
        return type(self).__name__


def map_params(fn: Callable[[torch.Tensor], Any], tree):
    """Apply ``fn`` to every tensor leaf of a nested param dict."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    return fn(tree)
