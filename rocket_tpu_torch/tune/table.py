"""Tuned-config tables and the runtime lookup (counterpart of
``rocket_tpu/tune/table.py``).

One JSON file per kernel (``rocket_tpu_torch/tune/configs/<kernel>.json``,
the reference's schema: ``version: 1``, ``kernel``, ``entries`` of
``device_kind``, ``dtype``, ``shape``, ``shape_bucket``, ``config``). The
tuner writes them with ``python -m rocket_tpu_torch.tune --update-table``;
``--check`` re-validates every entry against its
:class:`~rocket_tpu_torch.tune.space.TuneSpace`.

:func:`get_config` is what the kernels' call sites read: keyed ``(device
name, shape bucket, dtype)`` with longest-prefix matching on the device
name (``torch.cuda.get_device_name()``: an ``"NVIDIA H100"`` entry serves
``"NVIDIA H100 80GB HBM3"``) and exact matching on bucket and dtype. No
match returns ``None`` and the caller runs its default, so an empty table,
the CPU and an unknown card run what an untuned checkout runs.

Every lookup lands in a bounded provenance log (:func:`lookup_log`).
``ROCKET_TPU_TUNE=0`` disables every lookup; ``ROCKET_TPU_TUNE_DIR`` points
the lookup at another table directory; :func:`priced_device_kind` resolves
lookups against another device name.
"""

from __future__ import annotations

import contextlib
import functools
import json
import os
import threading
from typing import Mapping, Optional

from rocket_tpu_torch.tune.space import TUNE_SPACES, canonical_dtype
from rocket_tpu_torch.utils.perf import DEVICE_SPECS, _longest_prefix, device_name, device_spec

__all__ = [
    "CONFIGS_DIR", "get_config", "load_table", "load_tables", "write_table",
    "validate_tables", "tables_summary", "priced_device_kind", "tuning_disabled",
    "reset_lookup_log", "lookup_log", "lookup_log_summary", "reset_table_cache",
]

#: The shipped table directory (inside the package).
CONFIGS_DIR = os.path.join(os.path.dirname(os.path.abspath(__file__)), "configs")

TABLE_VERSION = 1

_ENTRY_REQUIRED = ("device_kind", "dtype", "shape", "shape_bucket", "config")

_lock = threading.Lock()
_table_cache: dict[str, Optional[dict]] = {}
_lookup_log: list[dict] = []
_LOOKUP_LOG_MAX = 256

_override = threading.local()


def _configs_dir() -> str:
    """``ROCKET_TPU_TUNE_DIR`` or the shipped directory."""
    return os.environ.get("ROCKET_TPU_TUNE_DIR") or CONFIGS_DIR


def _enabled() -> bool:
    return os.environ.get("ROCKET_TPU_TUNE", "1") not in ("0", "off")


@contextlib.contextmanager
def tuning_disabled():
    """Force every :func:`get_config` lookup inside the block to miss. The
    tuner sweeps under this, so an existing entry never stands in for the
    default it is re-measured against."""
    prev = os.environ.get("ROCKET_TPU_TUNE")
    os.environ["ROCKET_TPU_TUNE"] = "0"
    try:
        yield
    finally:
        if prev is None:
            os.environ.pop("ROCKET_TPU_TUNE", None)
        else:
            os.environ["ROCKET_TPU_TUNE"] = prev


@contextlib.contextmanager
def priced_device_kind(kind: Optional[str]):
    """Resolve every lookup inside the block against device name ``kind``
    instead of the local card's; ``None`` is a no-op."""
    prev = getattr(_override, "kind", None)
    _override.kind = kind
    try:
        yield
    finally:
        _override.kind = prev


def table_path(kernel: str, configs_dir: Optional[str] = None) -> str:
    return os.path.join(configs_dir or _configs_dir(), f"{kernel}.json")


def load_table(kernel: str, configs_dir: Optional[str] = None,
               use_cache: bool = True) -> Optional[dict]:
    """The parsed table for ``kernel``, or None when absent or malformed
    (the lookup never dies on a bad file; :func:`validate_tables` reports
    it)."""
    path = table_path(kernel, configs_dir)
    if use_cache:
        with _lock:
            if path in _table_cache:
                return _table_cache[path]
    try:
        with open(path) as fh:
            table = json.load(fh)
        if not isinstance(table, dict) or not isinstance(table.get("entries"), list):
            table = None
    except (OSError, ValueError):
        table = None
    if use_cache:
        with _lock:
            _table_cache[path] = table
    return table


def load_tables(configs_dir: Optional[str] = None) -> dict:
    """kernel -> table for every registered TuneSpace (None when missing)."""
    return {kernel: load_table(kernel, configs_dir) for kernel in TUNE_SPACES}


def reset_table_cache() -> None:
    """Drop the per-process table cache (``ROCKET_TPU_TUNE_DIR`` moved)."""
    with _lock:
        _table_cache.clear()


def write_table(kernel: str, entries: list, configs_dir: Optional[str] = None) -> str:
    """Atomically write ``entries`` as ``kernel``'s table; returns the path."""
    directory = configs_dir or _configs_dir()
    os.makedirs(directory, exist_ok=True)
    path = table_path(kernel, directory)
    table = {
        "version": TABLE_VERSION,
        "kernel": kernel,
        "entries": sorted(
            (dict(e) for e in entries),
            key=lambda e: (e.get("device_kind", ""), e.get("shape_bucket", ""),
                           e.get("dtype", "")),
        ),
    }
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(table, fh, indent=1, sort_keys=True)
        fh.write("\n")
    os.replace(tmp, path)
    reset_table_cache()
    return path


# -- runtime lookup -----------------------------------------------------------


@functools.lru_cache(maxsize=None)
def _local_kind() -> str:
    """The current card's name, or ``"cpu"`` (read once: the lookup runs on
    hot paths)."""
    return device_name()


def _resolve_kind(device_kind: Optional[str]) -> str:
    kind = getattr(_override, "kind", None)
    if kind is not None:
        return kind
    if device_kind is not None:
        return device_kind
    return _local_kind()


def device_kind() -> str:
    """The device name lookups resolve against: the kind being priced inside
    :func:`priced_device_kind`, else the local card's (``"cpu"`` without
    one)."""
    return _resolve_kind(None)


def _log(record: dict) -> None:
    with _lock:
        if len(_lookup_log) < _LOOKUP_LOG_MAX:
            _lookup_log.append(record)


def get_config(kernel: str, *, shape: Mapping, dtype,
               device_kind: Optional[str] = None) -> Optional[dict]:
    """The tuned config for ``kernel`` at ``shape`` / ``dtype`` on the
    (resolved) device, or ``None`` when no entry matches — the caller then
    runs its default. ``shape`` holds the keys the kernel's TuneSpace
    declares."""
    space = TUNE_SPACES.get(kernel)
    if space is None:
        raise KeyError(f"tune.get_config: unknown kernel {kernel!r} — "
                       f"known: {sorted(TUNE_SPACES)}")
    if not _enabled():
        return None
    bucket = space.bucket(shape)
    dtype_name = canonical_dtype(dtype)
    kind = _resolve_kind(device_kind)
    record = {"kernel": kernel, "shape_bucket": bucket, "dtype": dtype_name,
              "device_kind": kind, "source": "default"}
    table = load_table(kernel)
    config = None
    if table is not None:
        by_kind: dict[str, dict] = {}
        for entry in table["entries"]:
            if entry.get("shape_bucket") != bucket or entry.get("dtype") != dtype_name:
                continue
            ekind = entry.get("device_kind")
            if isinstance(ekind, str) and isinstance(entry.get("config"), dict):
                by_kind[ekind] = entry["config"]
        if by_kind:
            config = _longest_prefix(by_kind, kind)
    if config is not None:
        record["source"] = "table"
        record["config"] = dict(config)
        _log(record)
        return dict(config)
    _log(record)
    return None


# -- lookup provenance ------------------------------------------------------


def reset_lookup_log() -> None:
    with _lock:
        _lookup_log.clear()


def lookup_log() -> list:
    with _lock:
        return [dict(r) for r in _lookup_log]


def lookup_log_summary() -> list:
    """Deduplicated lookup records since the last reset (table hit vs
    default, with the resolved config on hits)."""
    seen = set()
    out = []
    for record in lookup_log():
        key = (record["kernel"], record["shape_bucket"], record["dtype"],
               record["device_kind"], record["source"])
        if key not in seen:
            seen.add(key)
            out.append(record)
    return out


# -- validation (the table gate) ----------------------------------------------


def _validate_entry(kernel: str, index: int, entry, known_kinds) -> list:
    space = TUNE_SPACES[kernel]
    where = f"{kernel}.json entries[{index}]"
    if not isinstance(entry, Mapping):
        return [f"{where}: not an object"]
    problems = [f"{where}: missing required key {key!r}"
                for key in _ENTRY_REQUIRED if key not in entry]
    if problems:
        return problems
    kind = entry["device_kind"]
    if _longest_prefix(known_kinds, kind) is None:
        problems.append(f"{where}: unknown device kind {kind!r} — add it to "
                        "rocket_tpu_torch.utils.perf.DEVICE_SPECS or drop the entry")
        spec = None
    else:
        spec = device_spec(kind)
    shape = entry["shape"]
    if not isinstance(shape, Mapping):
        return problems + [f"{where}: shape is not an object"]
    missing = [k for k in space.shape_keys if k not in shape]
    if missing:
        return problems + [f"{where}: shape missing keys {missing}"]
    if entry["shape_bucket"] != space.bucket(shape):
        problems.append(f"{where}: shape_bucket {entry['shape_bucket']!r} does not match "
                        f"shape (expected {space.bucket(shape)!r})")
    config = entry["config"]
    if not isinstance(config, Mapping):
        return problems + [f"{where}: config is not an object"]
    stale_covered = set()
    for axis in space.structural:
        value = config.get(axis)
        if axis in config and value not in space.axes.get(axis, ()):
            # A structural winner whose variant is gone fails loudly: the
            # lookup would hand the stale value to the call site.
            problems.append(
                f"{where}: stale structural winner — {axis}={value!r} is no longer a "
                f"variant of the {kernel} TuneSpace (candidates: "
                f"{list(space.axes.get(axis, ()))}); re-tune on the device or drop the entry")
            stale_covered.add(f"{axis}={value!r} not in candidates {space.axes[axis]}")
    for violation in space.violations(config, shape, spec, entry["dtype"]):
        if violation not in stale_covered:
            problems.append(f"{where}: illegal config — {violation}")
    return problems


def validate_tables(configs_dir: Optional[str] = None) -> list:
    """Every problem in the table directory, as strings (empty = the gate
    passes): a parseable file for every registered kernel, the schema, no
    unknown device names, bucket/shape consistency, legality of every
    config against its TuneSpace, no table without a TuneSpace."""
    directory = configs_dir or _configs_dir()
    problems = []
    known_kinds = dict(DEVICE_SPECS)
    for kernel in sorted(TUNE_SPACES):
        path = table_path(kernel, directory)
        if not os.path.exists(path):
            problems.append(f"{kernel}.json: missing — every tunable kernel ships a table "
                            "(empty entries when nothing is tuned); run "
                            "`python -m rocket_tpu_torch.tune --update-table`")
            continue
        table = load_table(kernel, directory, use_cache=False)
        if table is None:
            problems.append(f"{kernel}.json: unreadable or malformed")
            continue
        if table.get("version") != TABLE_VERSION:
            problems.append(f"{kernel}.json: version {table.get('version')!r} != "
                            f"{TABLE_VERSION}")
        if table.get("kernel") != kernel:
            problems.append(f"{kernel}.json: kernel field {table.get('kernel')!r} does not "
                            "match the file name")
        for i, entry in enumerate(table["entries"]):
            problems.extend(_validate_entry(kernel, i, entry, known_kinds))
    for name in sorted(os.listdir(directory)) if os.path.isdir(directory) else []:
        stem, ext = os.path.splitext(name)
        if ext == ".json" and stem not in TUNE_SPACES:
            problems.append(f"{name}: no TuneSpace named {stem!r} — stale table for a "
                            "removed kernel?")
    return problems


def _structural_variant(space, entry) -> Optional[dict]:
    """The structural-axis values an entry pins away from the default."""
    if not space.structural:
        return None
    config, shape = entry.get("config"), entry.get("shape")
    if not isinstance(config, Mapping) or not isinstance(shape, Mapping):
        return None
    try:
        default = space.default(shape)
    except Exception:  # noqa: BLE001 — the summary must survive a bad shape
        default = {}
    variant = {axis: config[axis] for axis in space.structural
               if axis in config and config.get(axis) != default.get(axis)}
    return variant or None


def tables_summary(configs_dir: Optional[str] = None) -> Optional[dict]:
    """Per-kernel entry summary (device name, bucket, dtype, config,
    speedup) plus ``structural_wins``, the entries pinning a structural
    variant away from the default. None when the directory is absent."""
    directory = configs_dir or _configs_dir()
    if not os.path.isdir(directory):
        return None
    kernels = {}
    structural_wins = []
    for kernel in sorted(TUNE_SPACES):
        space = TUNE_SPACES[kernel]
        table = load_table(kernel, directory, use_cache=False)
        entries = []
        for entry in (table or {}).get("entries", []):
            if not isinstance(entry, Mapping):
                continue
            entries.append({key: entry.get(key)
                            for key in ("device_kind", "shape_bucket", "dtype", "config",
                                        "speedup", "tuned_us", "default_us")
                            if entry.get(key) is not None})
            variant = _structural_variant(space, entry)
            if variant is not None:
                structural_wins.append({
                    "kernel": kernel, "case": entry.get("case"),
                    "device_kind": entry.get("device_kind"),
                    "shape_bucket": entry.get("shape_bucket"), "dtype": entry.get("dtype"),
                    "variant": variant, "speedup": entry.get("speedup"),
                    "tuned_us": entry.get("tuned_us"), "default_us": entry.get("default_us"),
                })
        kernels[kernel] = {"n_entries": len(entries), "entries": entries,
                           "structural_axes": list(space.structural)}
    return {"kernels": kernels, "structural_wins": structural_wins,
            "source": os.path.abspath(directory)}
