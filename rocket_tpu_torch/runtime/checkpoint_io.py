"""Checkpoint I/O — the counterpart of
``rocket_tpu/runtime/checkpoint_io.py``, with the same on-disk layout, so
each package reads what the other writes, at any process count:

* ``index.json`` maps each leaf path (the nested keys joined by ``/``) to
  ``{"kind": "array", "shape", "dtype", "chunks": [{"file", "key",
  "index"}]}`` or ``{"kind": "json", "value"}`` for ``None``, bools, ints,
  floats and strings;
* each process writes only the chunks it owns to ``shard_p{process}.npz``
  (no pickle), and the main process writes the index, which is a pure
  function of the leaves' layouts, so no rank exchanges metadata: a whole
  tensor is one chunk owned by process 0; a :class:`ShardedLeaf` (one
  rank's shard of a leaf split evenly on a dim) is one chunk per shard,
  chunk ``j`` owned by process ``owners[j]`` (``j`` over a data-only
  mesh; over a model or expert axis the ranks at data coordinate 0, one
  writer per model or expert shard), as the reference lays out a sharded
  leaf; an
  :class:`OwnedLeaf` (a pipeline stage's layer, whole) is one chunk owned
  by its stage's writer, and every other rank names it by shape and dtype
  alone. The reader assembles any chunk layout
  (the resharding restore): a checkpoint written by any number of
  processes, in either package, reads here.

Write protocol: :func:`snapshot` pulls every tensor to host synchronously
(after it returns the live tensors may change), :func:`write_snapshot`
does file I/O only and may run on :class:`AsyncWriter`'s thread. Every
file is committed by :func:`atomic_write` (write a temp file, fsync it,
replace), through the filesystem seam :class:`HostFS` that :func:`use_fs`
swaps. A leaf whose dtype numpy lacks (``bfloat16``) raises: params and
AdamW moments are f32.

Two optional leaves, as in the reference (``rocket_tpu/runtime/
checkpoint_io.py:350-362``), each matched exactly (the name itself or under
``name/``): the EMA shadow (``ema_params/...``, a Module's ``ema_decay``),
which a checkpoint written before EMA was enabled seeds from its
``params/...`` twin with one warning (:func:`seed_optional`, and the same
rule under a ``template``); and the health sentinels' state
(``health/...``), which a pre-health checkpoint leaves fresh (the live
values are kept). Any other missing leaf fails.
"""

from __future__ import annotations

import contextlib
import io
import json
import logging
import os
import tempfile
import threading
from typing import Any, Callable, Optional

import numpy as np
import torch

__all__ = [
    "HostFS", "use_fs", "atomic_write", "ShardedLeaf", "OwnedLeaf", "snapshot", "write_snapshot",
    "save_pytree", "load_leaf", "load_pytree", "unflatten", "AsyncWriter", "seed_optional",
]

logger = logging.getLogger(__name__)

_INDEX = "index.json"


def _shard_file(process: int) -> str:
    return f"shard_p{process}.npz"


class ShardedLeaf:
    """One process's shard of a leaf of shape ``shape`` split evenly on
    ``dim`` into ``count`` shards: ``local`` is shard ``index``. In a tree
    given to :func:`snapshot` it is saved as ``count`` chunks, chunk ``j``
    by process ``owners[j]`` (default ``j``)."""

    __slots__ = ("local", "shape", "dim", "index", "count", "owners")

    def __init__(self, local, shape, dim: int, index: int, count: int, owners=None) -> None:
        self.local, self.shape, self.dim = local, tuple(int(d) for d in shape), int(dim)
        self.index, self.count = int(index), int(count)
        self.owners = tuple(range(self.count)) if owners is None else tuple(int(o) for o in owners)

    def region(self, j: int) -> list:
        """``[lo, hi]`` per dim of shard ``j``."""
        step = self.shape[self.dim] // self.count
        return [[j * step, (j + 1) * step] if d == self.dim else [0, n]
                for d, n in enumerate(self.shape)]

    def zeros_like(self) -> "ShardedLeaf":
        local = (torch.zeros_like(self.local) if isinstance(self.local, torch.Tensor)
                 else np.zeros_like(self.local))
        return ShardedLeaf(local, self.shape, self.dim, self.index, self.count, self.owners)


class OwnedLeaf:
    """A whole leaf that process ``owner`` saves (a pipeline stage's own
    layer): ``local`` is the value on the rank that holds it, None on the
    others, which name the leaf by ``shape`` and ``dtype`` (a torch or
    numpy dtype) so the main process can write its index entry."""

    __slots__ = ("local", "shape", "dtype", "owner")

    def __init__(self, local, shape, dtype, owner: int) -> None:
        self.local, self.shape, self.dtype = local, tuple(int(d) for d in shape), dtype
        self.owner = int(owner)

    def zeros_like(self) -> "OwnedLeaf":
        local = None
        if isinstance(self.local, torch.Tensor):
            local = torch.zeros_like(self.local)
        elif self.local is not None:
            local = np.zeros_like(self.local)
        return OwnedLeaf(local, self.shape, self.dtype, self.owner)

    def dtype_name(self) -> str:
        if isinstance(self.dtype, torch.dtype):
            return torch.empty((), dtype=self.dtype).numpy().dtype.name
        return np.dtype(self.dtype).name


class HostFS:
    """The real filesystem behind the write paths: every durable effect
    goes through ``makedirs`` / ``mktemp`` / ``write`` / ``fsync`` /
    ``replace``, so a recording shim (:func:`use_fs`) sees the exact
    effect sequence. An atomic commit is write(tmp) -> fsync(tmp) ->
    replace(tmp, final)."""

    def makedirs(self, path: str) -> None:
        os.makedirs(path, exist_ok=True)

    def mktemp(self, directory: str, suffix: str = ".tmp") -> str:
        fd, tmp = tempfile.mkstemp(dir=directory, suffix=suffix)
        os.close(fd)
        return tmp

    def write(self, path: str, data: bytes) -> None:
        with open(path, "wb") as f:
            f.write(data)

    def fsync(self, path: str) -> None:
        fd = os.open(path, os.O_RDONLY)
        try:
            os.fsync(fd)
        finally:
            os.close(fd)

    def replace(self, src: str, dst: str) -> None:
        os.replace(src, dst)


_FS: HostFS = HostFS()


@contextlib.contextmanager
def use_fs(fs):
    """Swap the module's filesystem for the duration of the block. Not
    reentrant; the caller drains any :class:`AsyncWriter` inside it."""
    global _FS
    previous, _FS = _FS, fs
    try:
        yield fs
    finally:
        _FS = previous


def atomic_write(path: str, data: bytes) -> None:
    """Commit ``data`` at ``path`` so that a crash leaves either the old
    file or the whole new one: temp file, fsync, rename."""
    fs = _FS
    directory = os.path.dirname(path) or "."
    fs.makedirs(directory)
    tmp = fs.mktemp(directory)
    try:
        fs.write(tmp, data)
        fs.fsync(tmp)
        fs.replace(tmp, path)
    except BaseException:
        if os.path.exists(tmp):
            os.unlink(tmp)
        raise


# -- save -----------------------------------------------------------------------


def _leaves(tree, prefix=()):
    """(path tuple, leaf) of a nested dict / list / tuple, depth first."""
    if isinstance(tree, dict):
        for k, v in tree.items():
            yield from _leaves(v, prefix + (str(k),))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from _leaves(v, prefix + (str(i),))
    else:
        yield prefix, tree


def _to_numpy(name: str, leaf) -> np.ndarray:
    if isinstance(leaf, torch.Tensor):
        if leaf.dtype == torch.bfloat16 or leaf.is_complex():
            raise TypeError(
                f"checkpoint leaf {name!r} has dtype {leaf.dtype}, which the npz format cannot "
                "hold; cast it (params and optimizer moments are float32)"
            )
        return leaf.detach().to("cpu", copy=True).numpy()
    arr = np.asarray(leaf)
    if arr.dtype.name == "bfloat16":
        raise TypeError(f"checkpoint leaf {name!r} has dtype bfloat16, which the npz format "
                        "cannot hold; cast it first")
    return arr


def snapshot(tree: Any, process: int = 0) -> dict:
    """Phase 1: the whole index and this ``process``'s chunks pulled to
    host (synchronous). Tensors and numpy arrays become npz entries (one
    chunk, process 0's), a :class:`ShardedLeaf` one chunk per process;
    ``None``, bools, ints, floats and strings stay inline as JSON."""
    index: dict = {}
    local: dict = {}
    for path, leaf in _leaves(tree):
        name = "/".join(path)
        if name in index:
            raise ValueError(f"checkpoint: duplicate leaf path {name!r}")
        if isinstance(leaf, ShardedLeaf):
            arr = _to_numpy(name, leaf.local)
            index[name] = {
                "kind": "array", "shape": list(leaf.shape), "dtype": arr.dtype.name,
                "chunks": [{"file": _shard_file(leaf.owners[j]), "key": f"{name}:{j}",
                            "index": leaf.region(j)} for j in range(leaf.count)],
            }
            if leaf.owners[leaf.index] == process:
                local[f"{name}:{leaf.index}"] = arr
        elif isinstance(leaf, OwnedLeaf):
            key = f"{name}:0"
            index[name] = {
                "kind": "array", "shape": list(leaf.shape), "dtype": leaf.dtype_name(),
                "chunks": [{"file": _shard_file(leaf.owner), "key": key,
                            "index": [[0, d] for d in leaf.shape]}],
            }
            if leaf.owner == process and leaf.local is not None:
                local[key] = _to_numpy(name, leaf.local)
        elif isinstance(leaf, (torch.Tensor, np.ndarray, np.generic)):
            key = f"{name}:0"
            arr = _to_numpy(name, leaf) if process == 0 else None
            shape = tuple(leaf.shape)
            dtype = (arr.dtype.name if arr is not None else
                     _to_numpy(name, leaf.reshape(-1)[:0]).dtype.name)
            index[name] = {
                "kind": "array", "shape": list(shape), "dtype": dtype,
                "chunks": [{"file": _shard_file(0), "key": key,
                            "index": [[0, d] for d in shape]}],
            }
            if arr is not None:
                local[key] = arr
        elif leaf is None or isinstance(leaf, (bool, int, float, str)):
            index[name] = {"kind": "json", "value": leaf}
        else:
            raise TypeError(f"checkpoint leaf {name!r} has unsupported type "
                            f"{type(leaf).__name__}; convert it to a tensor or a scalar")
    return {"process": int(process), "index": index, "local": local}


def write_snapshot(path: str, plan: dict) -> None:
    """Phase 2: file I/O only (safe on a background thread). This
    process's shard file first, then (main process) ``index.json``, whose
    presence marks a complete main-process write."""
    _FS.makedirs(path)
    buf = io.BytesIO()
    np.savez(buf, **plan["local"])
    atomic_write(os.path.join(path, _shard_file(plan["process"])), buf.getvalue())
    if plan["process"] == 0:
        atomic_write(os.path.join(path, _INDEX), json.dumps(plan["index"]).encode("utf-8"))


def save_pytree(path: str, tree: Any) -> None:
    """:func:`snapshot` and :func:`write_snapshot` in one call."""
    write_snapshot(path, snapshot(tree))


# -- restore --------------------------------------------------------------------


class _ChunkReader:
    """Lazy npz access: opens each shard file once, loads only the keys asked for."""

    def __init__(self, path: str) -> None:
        self._path = path
        self._files: dict = {}

    def read(self, file: str, key: str) -> np.ndarray:
        npz = self._files.get(file)
        if npz is None:
            full = os.path.join(self._path, file)
            if not os.path.exists(full):
                raise FileNotFoundError(f"checkpoint shard {full} missing — incomplete save?")
            npz = self._files[file] = np.load(full, allow_pickle=False)
        return npz[key]


def _assemble(meta: dict, reader: _ChunkReader) -> np.ndarray:
    """The whole array from the saved chunks (any chunk layout: one per
    process of any process count)."""
    shape = tuple(meta["shape"])
    out = np.empty(shape, dtype=np.dtype(meta["dtype"]))
    filled = 0
    for chunk in meta["chunks"]:
        have = [tuple(p) for p in chunk["index"]]
        region = tuple(slice(lo, hi) for lo, hi in have)
        out[region] = reader.read(chunk["file"], chunk["key"])
        filled += int(np.prod([hi - lo for lo, hi in have])) if have else 1
    if filled < (int(np.prod(shape)) if shape else 1):
        raise ValueError("checkpoint chunks do not cover the array — torn or mixed-version save?")
    return out


def _read_index(path: str) -> dict:
    with open(os.path.join(path, _INDEX), "r", encoding="utf-8") as f:
        return json.load(f)


def _value(meta: dict, reader: _ChunkReader):
    return meta["value"] if meta["kind"] == "json" else _assemble(meta, reader)


def load_leaf(path: str, name: str) -> Any:
    """One leaf of a checkpoint directory, to host (numpy or a scalar)."""
    return _value(_read_index(path)[name], _ChunkReader(path))


def _is_optional_leaf(name: str) -> bool:
    """The EMA shadow's or the health sentinels' leaves, matched exactly
    (``ema_params`` or under ``ema_params/``, ``health`` or under
    ``health/``): a leaf merely starting with the string is not one."""
    return any(name == root or name.startswith(root + "/") for root in ("ema_params", "health"))


def _is_health_leaf(name: str) -> bool:
    return name == "health" or name.startswith("health/")


def seed_optional(flat: dict, path: str) -> dict:
    """A ``{leaf path: value}`` mapping of a checkpoint (its values or its
    index entries) with the EMA shadow filled in from its ``params/...``
    twins where the checkpoint has none (a run that enabled ``ema_decay``
    after the save), with one warning. Called for a model that keeps an
    EMA shadow; a checkpoint that has one is returned as it is."""
    if any(name == "ema_params" or name.startswith("ema_params/") for name in flat):
        return flat
    seeded = {"ema_" + name: value for name, value in flat.items()
              if name.startswith("params/")}
    if seeded:
        logger.warning("checkpoint at %s predates the 'ema_params' leaves — seeding the EMA "
                       "shadow from the checkpoint's params", path)
    return {**flat, **seeded}


def load_pytree(path: str, template: Any | None = None) -> Any:
    """Restore a checkpoint directory.

    With ``template`` (a nested dict / list of tensors and scalars): a
    tree of the template's structure, each tensor leaf rebuilt with the
    template leaf's dtype and device (its shape must match), each other
    leaf the stored value; a template with ``ema_params`` reads them from
    the params of a checkpoint that has none (:func:`seed_optional`).
    Without: a flat ``{leaf path: value}`` dict of
    numpy arrays and scalars (:func:`unflatten` nests it)."""
    index = _read_index(path)
    reader = _ChunkReader(path)
    if template is None:
        return {name: _value(meta, reader) for name, meta in index.items()}

    if isinstance(template, dict) and "ema_params" in template:
        index = seed_optional(index, path)
    warned: list = []

    def rebuild(tree, prefix):
        if isinstance(tree, dict):
            return {k: rebuild(v, prefix + (str(k),)) for k, v in tree.items()}
        if isinstance(tree, (list, tuple)):
            return type(tree)(rebuild(v, prefix + (str(i),)) for i, v in enumerate(tree))
        name = "/".join(prefix)
        meta = index.get(name)
        if meta is None and _is_health_leaf(name):
            if not warned:
                warned.append(name)
                logger.warning("checkpoint at %s predates the 'health' leaves — keeping the "
                               "live sentinel state", path)
            return tree
        if meta is None:
            raise KeyError(f"checkpoint at {path} has no leaf {name!r} "
                           f"(has: {sorted(index)[:8]}...)")
        value = _value(meta, reader)
        if not isinstance(tree, torch.Tensor):
            return value
        if tuple(meta["shape"]) != tuple(tree.shape):
            raise ValueError(f"checkpoint leaf {name!r} shape {tuple(meta['shape'])} != live "
                             f"shape {tuple(tree.shape)}")
        return torch.from_numpy(np.asarray(value)).to(device=tree.device, dtype=tree.dtype)

    return rebuild(template, ())


def unflatten(flat: dict) -> dict:
    """``{"a/b/c": v}`` -> ``{"a": {"b": {"c": v}}}`` (keys stay strings)."""
    tree: dict = {}
    for name, value in flat.items():
        node = tree
        *parents, last = name.split("/")
        for key in parents:
            node = node.setdefault(key, {})
        node[last] = value
    return tree


# -- async write ----------------------------------------------------------------


class AsyncWriter:
    """One-deep background write queue: the snapshot stays on the
    caller's thread, only file I/O overlaps training. Submitting while a
    write runs first waits for it; an error surfaces on the next
    :meth:`submit` or :meth:`wait`."""

    def __init__(self) -> None:
        self._thread: Optional[threading.Thread] = None
        self._error: Optional[BaseException] = None

    def submit(self, fn: Callable[[], None]) -> None:
        self.wait()

        def run():
            try:
                fn()
            except BaseException as e:  # surfaced on the next wait()
                self._error = e

        self._thread = threading.Thread(target=run, name="rocket-tpu-torch-ckpt-writer",
                                        daemon=True)
        self._thread.start()

    def wait(self) -> None:
        if self._thread is not None:
            self._thread.join()
            self._thread = None
        if self._error is not None:
            err, self._error = self._error, None
            raise RuntimeError("async checkpoint write failed") from err
