"""Host-side batch assembly and placement (counterpart of
``rocket_tpu/data/collate.py``).

``default_collate`` turns a list of samples into one batch:

* numpy arrays stack into one array and torch tensors into one tensor,
  along a new leading batch axis (objects with ``__array__``, numpy
  scalars among them, stack as numpy);
* ``str``, ``bytes``, Python numbers, ``None`` and tuples are left as they
  are: the batch is the list of samples;
* a mapping sample collates key by key and a list sample position by
  position, each into a container of the first sample's type;
* anything else is left as the list of samples.

``default_move`` copies every array leaf of a batch to a device as a
tensor and leaves scalars and strings alone, keeping the containers.
"""

from __future__ import annotations

from collections.abc import Mapping, Sequence
from typing import Any

import numpy as np
import torch

__all__ = ["default_collate", "default_move", "to_tensor"]

#: Leaf types that a batch keeps as the plain list of its samples.
_AS_LIST = (str, bytes, tuple, int, float, bool, type(None))


def _rebuild(like, values):
    """``values`` in a container of ``like``'s type where that type can be
    built from them, else as they are."""
    try:
        return type(like)(values)
    except TypeError:
        return values


def default_collate(samples: Sequence[Any]) -> Any:
    """One batch from a list of samples (the module docstring's rules).

    >>> default_collate([np.zeros(3), np.ones(3)]).shape
    (2, 3)
    >>> default_collate([(1, 2), (3, 4)])
    [(1, 2), (3, 4)]
    """
    if not samples:
        raise ValueError("default_collate: no samples")
    head = samples[0]
    if isinstance(head, torch.Tensor):
        return torch.stack(list(samples))
    if isinstance(head, np.ndarray):
        return np.stack([np.asarray(s) for s in samples])
    if isinstance(head, _AS_LIST):
        return list(samples)
    if isinstance(head, Mapping):
        return _rebuild(head, {key: default_collate([s[key] for s in samples]) for key in head})
    if isinstance(head, Sequence):
        return _rebuild(head, [default_collate(list(column)) for column in zip(*samples)])
    if hasattr(head, "__array__"):
        return np.stack([np.asarray(s) for s in samples])
    return list(samples)


def to_tensor(leaf) -> torch.Tensor:
    """A host array (bfloat16 from ``ml_dtypes`` included) as a tensor that
    shares its memory where torch can."""
    if isinstance(leaf, torch.Tensor):
        return leaf
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        return torch.from_numpy(np.ascontiguousarray(arr).view(np.int16)).view(torch.bfloat16)
    return torch.as_tensor(arr)


def default_move(tree: Any, device) -> Any:
    """``tree`` with each array leaf (numpy array, tensor, or anything with
    ``__array__``) copied to ``device`` as a tensor. Mappings, named and
    plain tuples and lists keep their types; strings, numbers and ``None``
    are returned as they are."""

    def move(leaf):
        return to_tensor(leaf).to(device)

    def walk(node):
        if isinstance(node, (torch.Tensor, np.ndarray)):
            return move(node)
        if isinstance(node, (str, bytes, int, float, bool, type(None))):
            return node
        if isinstance(node, Mapping):
            return _rebuild(node, {key: walk(value) for key, value in node.items()})
        if isinstance(node, tuple):
            items = [walk(value) for value in node]
            return type(node)(*items) if hasattr(node, "_fields") else tuple(items)
        if isinstance(node, Sequence):
            return _rebuild(node, [walk(value) for value in node])
        if hasattr(node, "__array__"):
            return move(np.asarray(node))
        return node

    return walk(tree)
