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

Composition (counterparts of ``rocket_tpu/nn/module.py``): :class:`Lambda`
wraps a tensor function as a layer, :class:`Sequential` chains layers
under the param keys ``"0"``, ``"1"``, ... (the reference's names), and
:class:`Model` is a batch-level model that reads fields of the batch dict
and writes new ones. :func:`merge_state` replaces the state of a
``{"params", "state"}`` pair.
"""

from __future__ import annotations

import inspect
from typing import Any, Callable, Optional

import torch

__all__ = ["Layer", "Lambda", "Sequential", "Model", "Variables", "map_params", "merge_state"]

#: A layer's variables: the nested dict of its params (and state).
Variables = dict


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

    @property
    def stateful(self) -> bool:
        """Whether ``apply`` takes ``state`` and returns ``(y, new_state)``."""
        return hasattr(self, "init_state")

    def __repr__(self) -> str:
        return type(self).__name__


class Lambda(Layer):
    """A tensor function (an activation, a reshape) as a layer without
    params."""

    def __init__(self, fn: Callable[[torch.Tensor], torch.Tensor], name: str = ""):
        self.fn = fn
        self.name = name or getattr(fn, "__name__", "fn")

    def apply(self, params, x):
        return self.fn(x)

    def __repr__(self) -> str:
        return f"Lambda({self.name})"


def _keywords(layer: Layer) -> frozenset:
    """The keywords of ``layer.apply`` among ``state``, ``mode`` and ``rng``."""
    return frozenset(inspect.signature(layer.apply).parameters) & {"state", "mode", "rng"}


class Sequential(Layer):
    """Layers applied in turn, their params (and the stateful ones' state)
    under ``str(index)``. Each layer gets the keywords it takes: ``state``
    (its own), ``mode`` and ``rng`` (``fold_in(rng, index)``). When a layer
    is stateful, so is the chain: ``apply`` then returns ``(y, new_state)``
    with every stateful layer's new state."""

    def __init__(self, *layers: Layer):
        self.layers = tuple(layers)
        self._kw = tuple(_keywords(layer) for layer in self.layers)

    @property
    def stateful(self) -> bool:
        return any(layer.stateful for layer in self.layers)

    def init_params(self, gen):
        return {str(i): layer.init_params(gen) for i, layer in enumerate(self.layers)}

    def init_state(self):
        return {str(i): layer.init_state() for i, layer in enumerate(self.layers)
                if layer.stateful}

    def apply(self, params, x, *, state: Optional[dict] = None, mode: str = "train", rng=None):
        from rocket_tpu_torch.nn import keys

        if self.stateful and state is None:
            raise ValueError("Sequential: a chain with stateful layers needs its state")
        new_state = {}
        for i, (layer, kw) in enumerate(zip(self.layers, self._kw)):
            key = str(i)
            args = {}
            if "mode" in kw:
                args["mode"] = mode
            if "rng" in kw:
                args["rng"] = None if rng is None else keys.fold_in(rng, i)
            if layer.stateful:
                x, new_state[key] = layer.apply(params[key], x, state=state[key], **args)
            else:
                x = layer.apply(params[key], x, **args)
        return (x, new_state) if self.stateful else x

    def __repr__(self) -> str:
        return f"Sequential({', '.join(repr(layer) for layer in self.layers)})"


class Model:
    """A batch-level model: ``apply(params, batch, *, mode, rng)`` reads
    fields of the batch dict and returns a copy with its outputs added (the
    reference's forward-replaces-batch contract); a model with state also
    defines ``init_state(device)``, takes ``state`` and returns ``(batch,
    new_state)``, as the ``Module`` capsule expects.

    :meth:`init` draws :meth:`init_params` on the CPU from a
    ``torch.Generator`` (seed 0 when None) and moves them to ``device``
    (``runtime.resolve_device``: the GPU unless the caller asks for the
    CPU)."""

    def init_params(self, gen: torch.Generator) -> dict:
        raise NotImplementedError

    def init(self, generator: Optional[torch.Generator] = None, device=None) -> dict:
        from rocket_tpu_torch.runtime import resolve_device

        device = resolve_device(device)
        gen = generator if generator is not None else torch.Generator().manual_seed(0)
        return map_params(lambda t: t.to(device), self.init_params(gen))

    def apply(self, params: dict, batch: dict, *, mode: str = "train", rng=None) -> dict:
        raise NotImplementedError

    def __repr__(self) -> str:
        return type(self).__name__


def merge_state(variables: dict, new_state: Any) -> dict:
    """``{"params", "state"}`` with the state replaced."""
    return {"params": variables["params"], "state": new_state}


def map_params(fn: Callable[[torch.Tensor], Any], tree):
    """Apply ``fn`` to every tensor leaf of a nested param (or state) dict."""
    if isinstance(tree, dict):
        return {k: map_params(fn, v) for k, v in tree.items()}
    return fn(tree)
