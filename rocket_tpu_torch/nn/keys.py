"""Counter-hash random keys for the training path (dropout), standing in
for ``jax.random``'s ``fold_in`` / ``split`` / ``bernoulli``.

A key is a plain 32-bit Python int. :func:`fold_in` and :func:`split`
derive child keys on the host, so a step's keys follow from ``(base
seed, step, layer, salt)`` alone; :func:`uniform` hashes ``(key,
element index)`` on the tensor's device into uniforms in (0, 1). No
generator state exists anywhere, which is what dropout under
``torch.utils.checkpoint`` needs: checkpointing replays the default
generators' state but not an explicit ``torch.Generator``, so a
generator-drawn mask would differ between the forward and its
recompute and the gradients would be silently wrong. A counter hash
gives the recompute the same mask by construction.

Under data parallelism each rank's dropout draws the elements of its
stripe of the global batch: the Module's train step runs under
:func:`data_shard`, and :func:`shard_offset` moves a rank's element
indices to those of its rows in the global array (rank times the local
element count; the stripes are equal), so two ranks draw the masks of
the one-rank run of the same global batch, as the reference draws those
of the global array. Under tensor parallelism a rank holds a sequence
shard ``(B, T/n, D)`` or a head shard ``(B, T, H/n, Dh)``, not a
contiguous run of the global elements: :func:`dropout_mask` with a
``split`` maps each local element to its global index, so the ranks of a
model group together draw exactly the one-rank run's masks. A sequence
rank's activations are a chunk of dim 1 the same way, and a pipeline
microbatch a chunk of dim 0 of its data stripe; the pipeline runs each
microbatch under :func:`activation_split`, which the layers read
(:func:`current_split`), so a pipelined run draws its unpipelined run's
masks.

The bits cannot match JAX's; the tests compare distributions and the
forward/recompute identity, and run the JAX comparisons with dropout 0.

:func:`record_draws` is the determinism audit's view of all this
(``analysis/repro_audit.py``, RKT901): inside it every key made by
:func:`key`, every child derived by :func:`fold_in` (and :func:`split`,
which folds), and every draw (:func:`uniform`, :func:`bernoulli`,
:func:`dropout_mask`, and ``models.sampling.draw``'s Gumbel draws, keyed
by their seed and salt) is noted with its key, the element indices it
hashes, its shape and the code that drew it. A draw made while autograd
runs a node is a checkpoint's recompute replaying the forward's draw (the
identity this module exists for) and is marked so.

A checkpoint carries the key as the reference's key data, two uint32
words (``jax.random.key_data``): :func:`to_data` writes a key as ``(0,
k)``, and :func:`from_data` derives the int from two words as ``w1 ^
mix(w0)``, which gives ``k`` back for ``(0, k)`` (``mix(0) == 0``). A
train state that keeps the words it was loaded with writes them back
unchanged, so a key crosses the packages both ways with the same bits.
"""

from __future__ import annotations

import contextlib
import os
import sys
from typing import Any, NamedTuple

import numpy as np
import torch

from rocket_tpu_torch.models.sampling import _mix, _mix_int

__all__ = ["key", "fold_in", "split", "uniform", "bernoulli", "to_data", "from_data",
           "data_shard", "shard_offset", "global_index", "dropout_mask", "activation_split",
           "current_split", "Draw", "KeyRecord", "record_draws", "note_draw"]

_M32 = 0xFFFFFFFF


class Draw(NamedTuple):
    """One random draw: ``kind`` (``"uniform"``, ``"dropout_mask"``,
    ``"sample"``), its ``key`` (an int, or ``(seed, salt)`` for a sampling
    draw, the salt an int or the salt tensor itself), ``domain``, the
    element indices it hashes (``("range", first, end)``, or ``("split",
    split, data rank, shape)`` for a chunk of a sharded array), its
    ``shape``, ``site`` (``path:line (function)`` of the code that drew it) and
    ``replay`` (made during a backward: a checkpoint's recompute)."""

    kind: str
    key: Any
    domain: tuple
    shape: tuple
    site: str
    replay: bool


class KeyRecord:
    """What :func:`record_draws` saw: ``creations`` (root keys made),
    ``derivations`` (``child -> (parent, data)``) and ``draws``."""

    def __init__(self) -> None:
        self.creations: list = []
        self.derivations: dict = {}
        self.draws: list = []

    def origin(self, k) -> tuple:
        """The chain of (parent, data) folds that made ``k``, root first."""
        chain = []
        while k in self.derivations and len(chain) < 64:
            parent, data = self.derivations[k]
            chain.append((parent, data))
            k = parent
        return tuple(reversed(chain))


#: The open recorders, process-wide (a CUDA backward runs on autograd's
#: device threads).
_RECORDERS: list = []
_HERE = os.path.abspath(__file__)


@contextlib.contextmanager
def record_draws():
    """Note every key made, derived and drawn inside the block (module
    docstring); yields the :class:`KeyRecord`."""
    record = KeyRecord()
    _RECORDERS.append(record)
    try:
        yield record
    finally:
        _RECORDERS.remove(record)


def _site() -> str:
    frame = sys._getframe(2)
    while frame is not None and (os.path.abspath(frame.f_code.co_filename) == _HERE
                                 or frame.f_code.co_filename.endswith("sampling.py")):
        frame = frame.f_back
    if frame is None:
        return ""
    path = os.path.abspath(frame.f_code.co_filename)
    root = os.path.dirname(os.path.dirname(os.path.dirname(_HERE)))
    rel = os.path.relpath(path, root) if path.startswith(root) else os.path.basename(path)
    return f"{rel}:{frame.f_lineno} ({frame.f_code.co_name})"


def note_draw(kind: str, k, domain: tuple, shape) -> None:
    """Hand one draw to every open :func:`record_draws` block."""
    if not _RECORDERS:
        return
    replay = torch._C._current_autograd_node() is not None
    draw = Draw(kind, k, tuple(domain), tuple(int(s) for s in shape), _site(), replay)
    for record in _RECORDERS:
        record.draws.append(draw)


def key(seed: int) -> int:
    """The root key of a seed."""
    k = _mix_int(int(seed) ^ 0x5EED0001)
    for record in _RECORDERS:
        record.creations.append(k)
    return k


def to_data(k: int) -> np.ndarray:
    """A key as the reference's key data: uint32 ``[0, k]``."""
    return np.array([0, int(k) & _M32], dtype=np.uint32)


def from_data(words) -> int:
    """The key of two uint32 words of key data (``to_data``'s inverse on
    its image; any other pair hashes both words)."""
    w0, w1 = (int(w) & _M32 for w in np.asarray(words).reshape(2))
    return w1 ^ _mix_int(w0)


def fold_in(k: int, data: int) -> int:
    """A child key of ``k`` for the integer ``data`` (``jax.random.fold_in``)."""
    child = _mix_int(k ^ _mix_int((int(data) * 0x61C88647 + 0x7F4A7C15) & _M32))
    for record in _RECORDERS:
        record.derivations.setdefault(child, (k, int(data)))
    return child


def split(k: int, num: int = 2) -> list:
    """``num`` child keys of ``k`` (``jax.random.split``); a domain apart
    from :func:`fold_in`'s small integers."""
    return [fold_in(k, 0x5B11_7000 + i) for i in range(num)]


#: The data-parallel rank of the train step running in this process. One
#: value for the whole process, not per thread: a CUDA backward (and the
#: remat recompute inside it) runs on autograd's device threads.
_DATA_SHARD = [0]


@contextlib.contextmanager
def data_shard(index: int):
    """Run the block as data-parallel rank ``index`` (see the module
    docstring); the previous rank is put back after."""
    previous, _DATA_SHARD[0] = _DATA_SHARD[0], int(index)
    try:
        yield
    finally:
        _DATA_SHARD[0] = previous


#: The chunk of the rank's activations a layer is running on, ``(dim,
#: index, count)``, or None; process-wide, as :data:`_DATA_SHARD`.
_SPLIT = [None]


@contextlib.contextmanager
def activation_split(split):
    """Run the block on chunk ``split = (dim, index, count)`` of this
    rank's activations (a pipeline microbatch: ``(0, m, M)``); None for the
    whole. The previous split is put back after."""
    previous, _SPLIT[0] = _SPLIT[0], None if split is None else tuple(int(v) for v in split)
    try:
        yield
    finally:
        _SPLIT[0] = previous


def current_split():
    """The :func:`activation_split` in force, or None."""
    return _SPLIT[0]


def shard_offset(numel: int) -> int:
    """The global index of this rank's first element of a batch-led tensor
    of ``numel`` local elements (0 outside :func:`data_shard`)."""
    return _DATA_SHARD[0] * int(numel)


def _uniform_at(k: int, idx: torch.Tensor) -> torch.Tensor:
    bits = _mix((idx * 0x61C88647 + _mix_int(k)) & _M32)
    return ((bits >> 8).float() + 0.5) * (1.0 / (1 << 24))


def uniform(k: int, shape, device, offset: int = 0) -> torch.Tensor:
    """f32 uniforms in (0, 1) of ``shape``: element ``i`` (row-major) is a
    hash of ``(k, offset + i)``, so one key gives the same values on any
    call."""
    n = 1
    for s in shape:
        n *= int(s)
    note_draw("uniform", k, ("range", int(offset), int(offset) + n), shape)
    idx = torch.arange(offset, offset + n, device=device, dtype=torch.int64)
    return _uniform_at(k, idx).reshape(shape)


def global_index(shape, device, split) -> torch.Tensor:
    """The global row-major index of each element of a batch-led local
    tensor of ``shape`` that is chunk ``index`` of ``count`` on dim ``dim``
    of the global array (``split = (dim, index, count)``), in this
    process's data stripe (:func:`data_shard`): int64 of ``shape``."""
    dim, index, count = (int(v) for v in split)
    shape = tuple(int(s) for s in shape)
    gshape = list(shape)
    gshape[dim] *= count
    strides = [1] * len(gshape)
    for d in range(len(gshape) - 2, -1, -1):
        strides[d] = strides[d + 1] * gshape[d + 1]
    idx = torch.full((1,) * len(shape), _DATA_SHARD[0] * gshape[0] * strides[0],
                     dtype=torch.int64, device=device)
    for d, n in enumerate(shape):
        start = index * n if d == dim else 0
        view = [1] * len(shape)
        view[d] = n
        idx = idx + (torch.arange(start, start + n, dtype=torch.int64, device=device)
                     * strides[d]).reshape(view)
    return idx


def dropout_mask(k: int, p: float, shape, device, split=None) -> torch.Tensor:
    """The keep mask (True with probability ``p``) of this process's part
    of the global array: its data stripe's run of elements, or with
    ``split = (dim, index, count)`` its chunk on ``dim`` of that stripe."""
    if split is None:
        n = 1
        for s in shape:
            n *= int(s)
        return bernoulli(k, p, shape, device, shard_offset(n))
    note_draw("dropout_mask", k, ("split", tuple(int(v) for v in split), _DATA_SHARD[0],
                                  tuple(int(v) for v in shape)), shape)
    return _uniform_at(k, global_index(shape, device, split)) < p


def bernoulli(k: int, p: float, shape, device, offset: int = 0) -> torch.Tensor:
    """A boolean mask of ``shape``, True with probability ``p``."""
    return uniform(k, shape, device, offset) < p
