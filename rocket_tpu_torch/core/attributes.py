"""Attributes — the shared mutable dataflow bag threaded through every event
call (counterpart of ``rocket_tpu/core/attributes.py``): a dict with
attribute-style access where a *missing key reads as None*, the contract
every capsule leans on.

Values placed in the bag are arbitrary Python objects; on the hot path
they are tensors or dicts of tensors.
"""

from __future__ import annotations

import copy
from collections.abc import Iterator, Mapping
from typing import Any


class Attributes(dict):
    """A dict with attribute get/set/del where a missing key reads as ``None``.

    >>> attrs = Attributes()
    >>> attrs.batch is None        # missing key -> None, never AttributeError
    True
    >>> attrs.batch = [1, 2]
    >>> attrs["batch"]
    [1, 2]
    >>> del attrs.batch
    >>> attrs.batch is None
    True

    Nested dicts assigned into the bag are wrapped on *read* so that chained
    access (``attrs.looper.state.loss``) works regardless of how the inner
    mapping was created.
    """

    __slots__ = ()

    def __getattr__(self, name: str) -> Any:
        # Called only when normal attribute lookup fails -> treat as key.
        if name.startswith("__") and name.endswith("__"):
            # Preserve protocol behavior (pickle, copy, ...).
            raise AttributeError(name)
        value = self.get(name, None)
        if type(value) is dict:
            # Wrap in place so subsequent writes through the wrapper stick.
            value = Attributes(value)
            self[name] = value
        return value

    def __setattr__(self, name: str, value: Any) -> None:
        self[name] = value

    def __delattr__(self, name: str) -> None:
        # Deleting a missing key is a no-op, matching the missing->None reads.
        self.pop(name, None)

    def __getitem__(self, key: Any) -> Any:
        return self.get(key, None) if key not in self else super().__getitem__(key)

    # -- convenience -------------------------------------------------------

    def copy(self) -> "Attributes":
        return Attributes(self)

    def deepcopy(self) -> "Attributes":
        """A copy that shares nothing mutable with this bag (tensors copied
        too)."""
        return copy.deepcopy(self)

    def flat_items(self, prefix: str = "") -> Iterator[tuple[str, Any]]:
        """``("a.b.c", value)`` for every leaf of the nested mappings, in
        insertion order; an empty mapping is a leaf (a logging aid)."""
        for key, value in self.items():
            path = f"{prefix}{key}"
            if isinstance(value, Mapping) and value:
                yield from Attributes(value).flat_items(path + ".")
            else:
                yield path, value

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        inner = ", ".join(f"{k}={v!r}" for k, v in self.items())
        return f"Attributes({inner})"
