"""The layer protocol of the port: a layer is a description, its parameters
an explicit nested dict of tensors threaded through :meth:`Layer.apply`.

The dicts are laid out exactly as the JAX package's param pytrees
(``{"w", "b"}``, ``{"scale", "bias"}``, ``{"table"}``), so a JAX tree
converts with a rename-free copy (``rocket_tpu_torch.bridge``). Layers
that behave differently in training (dropout, attention) take keyword
``mode`` and ``rng`` (a counter-hash key, ``nn/keys.py``).

State: a layer that holds some (``BatchNorm``'s running mean and
variance, and the conv blocks and models built on it) defines
:meth:`Layer.init_state`, takes it as the keyword ``state`` and returns
``(y, new_state)`` from ``apply`` (the JAX package's ``variables["state"]``
threading). The state is a nested dict of f32 tensors laid out as the JAX
``variables["state"]``; the train step replaces it by the new state after
each step. Stateless layers keep ``apply(params, x) -> y``.
"""

from __future__ import annotations

from typing import Any, Callable

import torch

__all__ = ["Layer", "map_params"]


class Layer:
    """Base layer: ``init_params(gen)`` draws float32 parameters on the CPU
    from a ``torch.Generator``; ``apply(params, x)`` computes the output.
    A stateful layer also defines ``init_state()`` and returns ``(y,
    new_state)`` from ``apply(params, x, *, state, mode)``."""

    def init_params(self, gen: torch.Generator) -> dict:
        return {}

    def apply(self, params: dict, x: torch.Tensor) -> torch.Tensor:
        raise NotImplementedError

    def __call__(self, params: dict, x: torch.Tensor, **kwargs) -> torch.Tensor:
        return self.apply(params, x, **kwargs)

    def __repr__(self) -> str:
        return type(self).__name__


def map_params(fn: Callable[[torch.Tensor], Any], tree):
    """Apply ``fn`` to every tensor leaf of a nested param (or state) dict."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    return fn(tree)
