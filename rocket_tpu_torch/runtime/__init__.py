"""The port's runtime: device resolution for the entry points, the
:class:`Runtime` shared by a capsule tree with its process group and data
mesh, its ops plane (telemetry, health, flight recorder,
:class:`StrictMode`), and the one helper every deliberate host transfer
goes through (:func:`explicit_transfer`) — the counterpart of
``rocket_tpu/runtime/context.py``. The Runtime also holds the resilience
plumbing (the drain flag, the fault injector, the live Checkpointers) and
starts the live export plane. ``checkpoint_io`` holds the checkpoint file
format."""

from __future__ import annotations

import atexit
import contextlib
import logging
import os
from typing import Any, Optional, Sequence, Union

import torch

from rocket_tpu_torch.nn import keys

__all__ = ["resolve_device", "Runtime", "IdentityRegistry", "StrictMode", "explicit_transfer"]

_TRUE = ("1", "true", "yes", "on")


def _env_flag(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in _TRUE


def _guard_available() -> bool:
    """Whether torch's CUDA sync guard exists here (a CUDA build with a
    card); without one, strict mode is inert, as the reference's guard is
    on a CPU backend."""
    return torch.cuda.is_available()


@contextlib.contextmanager
def explicit_transfer():
    """The port's one explicit-transfer helper: the block runs with the
    strict guard lifted (``torch.cuda.set_sync_debug_mode(0)``) and puts
    back whatever mode was set. Every deliberate host read or upload of the
    framework goes through it — the Tracker's flush, the health monitor's
    fetch, the Meter's gather, the progress bar's postfix, a checkpoint's
    snapshot — as the reference's ``jax.device_get``/``device_put`` stay
    legal under its transfer guard."""
    if not _guard_available():
        yield
        return
    mode = torch.cuda.get_sync_debug_mode()
    if mode:
        torch.cuda.set_sync_debug_mode(0)
    try:
        yield
    finally:
        if mode:
            torch.cuda.set_sync_debug_mode(mode)


class StrictMode:
    """Opt-in enforcement of the step path's contract: no host read or
    synchronising copy the framework did not ask for (counterpart of the
    reference's ``StrictMode``, ``context.py:33-151``).

    The guard is ``torch.cuda.set_sync_debug_mode``: ``"error"`` for the
    reference's ``"disallow"`` (a ``.item()``, a ``float(t)``, a blocking
    copy either way or a ``synchronize`` raises at the line that did it),
    ``"warn"`` for its ``"log"``. Run-wide, it is on from :meth:`activate`
    (the Runtime's construction) to :meth:`deactivate` (``end_training``).
    torch's guard cannot tell the directions apart: it flags a blocking
    host-to-device copy as it flags a read. So the Launcher's SETUP, each
    phase's SET and RESET and the DESTROY run under :meth:`lifted`, as the
    reference leaves uploads unguarded at setup, and so does the first wave
    of each Looper launch, as in the reference (it builds the kernels and
    uploads the epoch's order). Every wave after it runs guarded. The
    framework's own transfers go through :func:`explicit_transfer`. On the
    CPU (no card) the guard is inert, as the reference's D2H guard is on a
    CPU backend (its caveat, ``context.py:50-53``).

    ``note_retraces`` exists for the reference's API and returns None:
    eager torch has no compile cache whose size could be counted. So
    ``max_retraces`` (``Runtime(strict_max_retraces=...)``) is accepted for
    the reference's signature and ignored: nothing reads it.
    ``note_collectives`` records an audited per-step collective count.

    On with ``Runtime(strict=True)`` or ``ROCKET_TPU_STRICT=1``."""

    _MODES = {"disallow": "error", "error": "error", "log": "warn", "warn": "warn"}

    def __init__(self, transfer_guard: str = "disallow", max_retraces: int = 8) -> None:
        if transfer_guard not in self._MODES:
            raise ValueError(f"StrictMode: transfer_guard must be one of {sorted(self._MODES)}, "
                             f"got {transfer_guard!r}")
        self._transfer_guard = transfer_guard
        self._active = False
        self._previous = 0
        self.collective_counts: dict = {}
        #: The run's Telemetry (set by the Runtime): audited counts mirror
        #: into its registry.
        self.telemetry = None

    @property
    def enabled(self) -> bool:
        return self._active

    @property
    def transfer_guard(self) -> str:
        return self._transfer_guard

    @property
    def sync_debug_mode(self) -> str:
        """The ``torch.cuda.set_sync_debug_mode`` level of the guard."""
        return self._MODES[self._transfer_guard]

    def activate(self) -> None:
        if self._active:
            return
        self._active = True
        if _guard_available():
            self._previous = torch.cuda.get_sync_debug_mode()
            torch.cuda.set_sync_debug_mode(self.sync_debug_mode)

    def deactivate(self) -> None:
        if not self._active:
            return
        self._active = False
        if _guard_available():
            torch.cuda.set_sync_debug_mode(self._previous)

    @contextlib.contextmanager
    def lifted(self):
        """The block runs unguarded (a no-op when strict mode is off)."""
        if not self._active:
            yield
            return
        with explicit_transfer():
            yield

    def note_retraces(self, label: str, step_fn=None) -> None:
        """The reference counts a jitted step's compiles here; an eager
        torch step compiles nothing, so there is nothing to count."""
        return None

    def note_collectives(self, label: str, count: int) -> int:
        """Record an audited per-step collective-op count for ``label``."""
        count = int(count)
        self.collective_counts[label] = count
        if self.telemetry is not None and self.telemetry.enabled:
            self.telemetry.registry.gauge(f"strict/audited_collectives/{label}").set(count)
        return count


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


class IdentityRegistry:
    """Prepare-once registry keyed by object identity and an optional
    ``extra_key`` (a loader's settings): two capsules wrapping the same raw
    object (a model shared by a train and an eval Module, a dataset read
    twice with one batching) share one prepared record, and preparing it
    twice is an error. :meth:`retain` and :meth:`release` count the holders
    of a record, so that only the last of them tears it down."""

    def __init__(self, kind: str) -> None:
        self._kind = kind
        self._entries: dict = {}  # (id(raw), extra_key) -> (raw, prepared)
        self._holders: dict = {}  # (id(raw), extra_key) -> count

    def lookup(self, raw: Any, extra_key: Any = None) -> Optional[Any]:
        entry = self._entries.get((id(raw), extra_key))
        return None if entry is None else entry[1]

    def add(self, raw: Any, prepared: Any, extra_key: Any = None) -> Any:
        key = (id(raw), extra_key)
        if key in self._entries:
            raise RuntimeError(f"Registry[{self._kind}]: object {type(raw).__name__} is already "
                               "prepared; share the prepared handle instead.")
        self._entries[key] = (raw, prepared)
        return prepared

    def remove(self, raw: Any, extra_key: Any = None) -> None:
        key = (id(raw), extra_key)
        self._entries.pop(key, None)
        self._holders.pop(key, None)

    def retain(self, raw: Any, extra_key: Any = None) -> None:
        """Count one more holder of the record."""
        key = (id(raw), extra_key)
        self._holders[key] = self._holders.get(key, 0) + 1

    def release(self, raw: Any, extra_key: Any = None) -> bool:
        """Drop one holder. True when it was the last one (a record never
        retained counts as one holder): the record is then removed, and the
        caller tears the prepared object down."""
        key = (id(raw), extra_key)
        left = self._holders.get(key, 1) - 1
        if left > 0:
            self._holders[key] = left
            return False
        self.remove(raw, extra_key)
        return True

    def __len__(self) -> int:
        return len(self._entries)

    def values(self) -> list:
        """The prepared records in registration order."""
        return [prepared for _, prepared in self._entries.values()]


#: Seconds the closing barrier waits for the other ranks: past it a peer
#: is taken as gone and the group closes without it.
CLOSE_TIMEOUT_S = 10.0


def _close_group(device_ids=None) -> None:
    """Close the group this process's Runtime opened, collectively: a
    barrier under :data:`CLOSE_TIMEOUT_S`, then every rank but the store's
    host (rank 0) closes, and rank 0 closes last, once the others said so
    through the store. A rank that closed its pairs while a peer still
    used them could abort that peer (SIGABRT from gloo's or the store's
    threads) after its work was done. A barrier that fails or times out (a
    dead peer) closes at once, so the process keeps its own exit code."""
    import datetime
    import time

    import torch.distributed as dist

    if not dist.is_initialized():
        return
    world, rank = dist.get_world_size(), dist.get_rank()
    together = world > 1
    if together:
        try:
            work = (dist.barrier(async_op=True, device_ids=device_ids) if device_ids
                    else dist.barrier(async_op=True))
            work.wait(timeout=datetime.timedelta(seconds=CLOSE_TIMEOUT_S))
        except Exception:  # noqa: BLE001 — a dead peer; close alone
            together = False
    if together:
        try:
            store = dist.distributed_c10d._get_default_store()
            if rank:
                store.add("rocket_tpu_torch/closed", 1)
            else:
                deadline = time.monotonic() + CLOSE_TIMEOUT_S
                while (store.add("rocket_tpu_torch/closed", 0) < world - 1
                       and time.monotonic() < deadline):
                    time.sleep(0.01)
                # The others' sockets close after their word.
                time.sleep(0.05)
        except Exception:  # noqa: BLE001 — the store's host is gone
            pass
    dist.destroy_process_group()


def _seq_slice(tree, index: int, count: int):
    """``tree`` with every array leaf of two or more dims whose dim 1
    divides by ``count`` cut to chunk ``index`` of that dim."""
    if isinstance(tree, dict):
        return {k: _seq_slice(v, index, count) for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(_seq_slice(v, index, count) for v in tree)
    shape = getattr(tree, "shape", ())
    if len(shape) >= 2 and shape[1] % count == 0:
        step = shape[1] // count
        return tree[:, index * step:(index + 1) * step]
    return tree


class Runtime:
    """Execution context shared by every capsule of a tree: the process
    group and data mesh, the device, the seeds, gradient accumulation, the
    models and dataloaders registries, the device-resident datasets, the
    checkpoint stack of stateful capsules and the tracker backends.

    The process group (the reference's ``context.py:243-262``): a group
    the caller already opened (``torch.distributed.init_process_group``)
    is adopted; else, when ``MASTER_ADDR`` and ``WORLD_SIZE`` are set (as
    ``python -m rocket_tpu_torch.launch`` sets them, with ``RANK`` and
    ``LOCAL_RANK``), one is opened: NCCL on a CUDA device, gloo on the CPU
    (``ROCKET_TPU_DIST_BACKEND`` names another: gloo lets several ranks
    share one card). Without either the Runtime is one process.
    ``mesh_shape`` (default ``{"data": world size}``; the axes ``data``,
    ``model``, ``seq``, ``pipe`` and ``expert``, in the shape's order, the
    last axis fastest) must cover the ranks, one device each, and builds the
    ``DeviceMesh`` (``device_mesh``); with a ``model``, ``seq``, ``pipe``
    or ``expert`` axis larger than 1 every row of each axis also gets a
    process group of its own (:meth:`axis_group`, :meth:`axis_ranks`,
    :meth:`axis_index`; :attr:`data_index` is the rank's stripe), and so
    does every plane of two or more of the axes larger than 1 that is not
    the whole mesh (:meth:`plane_group`). Two of those four axes may be
    larger than 1 at once, but ``seq`` with ``pipe`` and ``pipe`` with
    ``expert`` refuse, naming what the reference raises for them
    (:attr:`REFUSED_PAIRS`; ROADMAP Queue A 6 item 8).
    ``seq_axis`` (default ``"seq"`` when the mesh has it, as in the
    reference) is the axis a batch's token dim is sharded over. Each rank
    of one model, seq, pipe or expert row holds the same stripe of the
    global batch (:meth:`shard_batch`; a seq rank keeps its slice of the
    tokens) and
    every rank starts from the same params, made from the same seed.
    :meth:`wait_for_everyone`
    is a barrier over every rank. A group the Runtime opened closes
    collectively at exit (:func:`_close_group`); one the caller opened
    stays the caller's to close.

    ``device`` resolves through :func:`resolve_device` (CUDA unless
    ``"cpu"`` is asked for; ``cuda:LOCAL_RANK`` when the launcher set
    ``LOCAL_RANK``). Every seed a capsule takes derives from
    ``seed`` and the number of earlier draws (:meth:`next_seed`).
    ``device_placement``: the default of ``Dataset(device_placement=)``,
    whether streamed batches are copied to ``device``.
    ``device_cache_bytes``: the size up to which ``Dataset(device_cache=
    "auto")`` keeps a dataset on the device (the reference's default, 1
    GiB, not a measurement of this card).

    The ops arguments are the reference's (``context.py:367-391``), with its
    environment variables and precedence (an argument wins over the
    variable): ``project_dir`` (where ``runs/`` goes); ``strict``
    (``ROCKET_TPU_STRICT``), ``strict_transfer_guard`` and
    ``strict_max_retraces`` (:class:`StrictMode`; accepted and ignored,
    eager torch counting no compiles); ``telemetry``
    (``ROCKET_TPU_TELEMETRY``), ``telemetry_dir`` and ``watchdog_secs``
    (``ROCKET_TPU_WATCHDOG``); ``health`` and ``anomaly_action``
    (``ROCKET_TPU_HEALTH=1|warn|skip_step|dump_and_halt``),
    ``blackbox_steps`` and ``health_fetch_lag``; the live export plane's
    ``export`` (``ROCKET_TPU_EXPORT``: truthy, or a number that also sets
    the interval), ``export_interval_s``, ``metrics_port``
    (``ROCKET_TPU_METRICS_PORT``; ``/metrics`` on that port plus the rank,
    0 for an ephemeral one) and ``slo`` (``ROCKET_TPU_SLO``: a spec file or
    ``default:train``). ``health=True``, a ``watchdog_secs`` or an active
    export implies telemetry. The health monitor always exists, inert when
    off.

    Resilience (the reference's ``context.py:575-610``): ``drain`` is the
    :class:`~rocket_tpu_torch.resilience.faults.DrainState` every Looper
    polls at wave boundaries; ``checkpointers`` the live Checkpointers
    (their setup and destroy keep it), which a drain in a phase without
    one saves through; ``faults`` the injector of ``ROCKET_TPU_FAULTS``
    (None without a plan); ``supervised`` whether
    ``ROCKET_TPU_SUPERVISED`` is set, which arms the watchdog's
    ``EXIT_WEDGED`` escalation. The SIGTERM (and first SIGINT) drain
    handler is installed only when supervised or under
    ``ROCKET_TPU_DRAIN=1``: a library does not take an application's
    signals unasked."""

    #: Most recently constructed Runtime (the ambient context).
    _current: Optional["Runtime"] = None

    @classmethod
    def current(cls) -> Optional["Runtime"]:
        return cls._current

    #: The mesh axes a batch is split over (the reference's ``DATA_AXES``).
    DATA_AXES: tuple = ("data",)
    #: The mesh axes the port lays out: the data axes, the model
    #: (tensor-parallel) axis, the sequence axis of ring attention, the
    #: pipeline-stage axis and the expert axis (each rank of an expert row
    #: holds its share of every MoE layer's experts).
    MESH_AXES: tuple = ("data", "model", "seq", "pipe", "expert")
    #: The axes other than the data axis; two of them may be larger than 1
    #: at once, but for the pairs of :attr:`REFUSED_PAIRS`.
    SPLIT_AXES: tuple = ("model", "seq", "pipe", "expert")
    #: The pairs of split axes the reference itself cannot run on the JAX it
    #: is tested with, and what it raises there.
    REFUSED_PAIRS: dict = {
        frozenset(("seq", "pipe")): (
            "the reference's ring attention inside its 1F1B stages fails with 'The context "
            "mesh ... should match the mesh passed to shard_map'"),
        frozenset(("pipe", "expert")): (
            "the reference's GPipe fails with 'psum is a variant->invariant collective' and "
            "its 1F1B refuses the MoE"),
    }

    @classmethod
    def _refused_pair(cls, split) -> Optional[str]:
        """Why the port refuses these split axes together, or None."""
        if len(split) > 2:
            return "the port runs at most two of them beside the data axis"
        return cls.REFUSED_PAIRS.get(frozenset(split)) if len(split) == 2 else None

    def __init__(self, device=None, seed: int = 0, gradient_accumulation_steps: int = 1,
                 device_placement: bool = True, device_cache_bytes: int = 1 << 30,
                 project_dir: str = ".", strict: Optional[bool] = None,
                 strict_transfer_guard: str = "disallow", strict_max_retraces: int = 8,
                 telemetry: Optional[bool] = None, telemetry_dir: Optional[str] = None,
                 watchdog_secs: Optional[float] = None, health: Optional[bool] = None,
                 anomaly_action: Optional[str] = None, blackbox_steps: int = 256,
                 health_fetch_lag: int = 2, export: Optional[bool] = None,
                 export_interval_s: Optional[float] = None, metrics_port: Optional[int] = None,
                 slo: Optional[str] = None, mesh_shape: Optional[dict] = None,
                 seq_axis: Optional[str] = None) -> None:
        if gradient_accumulation_steps < 1:
            raise RuntimeError("gradient_accumulation_steps must be >= 1")
        if device is None and os.environ.get("LOCAL_RANK", "").isdigit():
            device = f"cuda:{int(os.environ['LOCAL_RANK'])}"
        self.device = resolve_device(device)
        self._init_process_group(mesh_shape)
        if seq_axis is None and "seq" in self._mesh_shape:
            seq_axis = "seq"
        if seq_axis is not None and seq_axis not in self._mesh_shape:
            raise RuntimeError(f"Runtime: seq_axis {seq_axis!r} not in mesh axes "
                               f"{tuple(self._mesh_shape)}.")
        self.seq_axis = seq_axis
        self._seed = int(seed)
        self._seed_counter = 0
        self.gradient_accumulation_steps = int(gradient_accumulation_steps)
        self.device_placement = bool(device_placement)
        self.device_cache_bytes = int(device_cache_bytes)
        self.models = IdentityRegistry("models")
        # One loader per (raw dataset, loader settings), shared by the
        # Dataset capsules that ask for it and closed by the last of them.
        self.dataloaders = IdentityRegistry("dataloaders")
        # The device-resident copy of a dataset per (id(raw dataset), cache
        # dtype), shared by every loader over it (a train and a val loader
        # upload once).
        self.device_cache_store: dict = {}
        self.trackers: dict = {}
        self._checkpoint_stack: list = []
        self.project_dir = project_dir
        from rocket_tpu_torch.obs.export import ExportConfig

        export_config = ExportConfig.from_env(enabled=export, interval_s=export_interval_s,
                                              metrics_port=metrics_port, slo_path=slo)
        self._init_ops(strict, strict_transfer_guard, strict_max_retraces, telemetry,
                       telemetry_dir, watchdog_secs, health, anomaly_action, blackbox_steps,
                       health_fetch_lag, export_config)
        self._init_resilience()
        Runtime._current = self

    def _init_ops(self, strict, transfer_guard, max_retraces, telemetry, telemetry_dir,
                  watchdog_secs, health, anomaly_action, blackbox_steps, fetch_lag,
                  export_config) -> None:
        """The ops plane, resolved as the reference resolves it
        (``context.py:454-573``): arguments over environment variables."""
        from rocket_tpu_torch.obs import FlightRecorder, HealthConfig, HealthMonitor, Telemetry
        from rocket_tpu_torch.obs.export import host_identity
        from rocket_tpu_torch.obs.health import ANOMALY_ACTIONS

        logger = self.get_logger("obs")
        env_health = os.environ.get("ROCKET_TPU_HEALTH", "").strip().lower()
        if health is None:
            health = env_health in _TRUE or env_health in ANOMALY_ACTIONS
        if anomaly_action is None:
            anomaly_action = env_health if env_health in ANOMALY_ACTIONS else "warn"
        if telemetry is None:
            # A watchdog, health or live export is an explicit ask for what
            # lives inside telemetry, so it implies it.
            telemetry = (watchdog_secs is not None or bool(health) or export_config.active
                         or _env_flag("ROCKET_TPU_TELEMETRY"))
        elif not telemetry and watchdog_secs is not None:
            self.get_logger("runtime").warning(
                "watchdog_secs=%s ignored: telemetry=False turns the whole ops plane off, "
                "watchdog included.", watchdog_secs)
        if watchdog_secs is None and os.environ.get("ROCKET_TPU_WATCHDOG", "").strip():
            raw = os.environ["ROCKET_TPU_WATCHDOG"].strip()
            try:
                watchdog_secs = float(raw)
            except ValueError:
                self.get_logger("runtime").warning(
                    "ROCKET_TPU_WATCHDOG=%r is not a number — watchdog disabled", raw)
        self.telemetry = Telemetry(enabled=telemetry, out_dir=telemetry_dir,
                                   watchdog_secs=watchdog_secs, logger=logger)
        config = HealthConfig(enabled=bool(health), action=anomaly_action, fetch_lag=fetch_lag)
        self.flight = (FlightRecorder(max_steps=blackbox_steps, telemetry=self.telemetry,
                                      runtime=self, logger=logger)
                       if config.enabled else None)
        self.health = HealthMonitor(config, registry=self.telemetry.registry,
                                    flight=self.flight, logger=logger)
        self.telemetry.flight, self.telemetry.health = self.flight, self.health
        self.telemetry.identity = host_identity(self.process_index)
        self.telemetry.start()
        self.telemetry.start_export(export_config,
                                    default_dir=os.path.join(self.project_dir, "runs", "telemetry"))
        self.strict = StrictMode(transfer_guard=transfer_guard, max_retraces=max_retraces)
        self.strict.telemetry = self.telemetry
        if strict is None:
            strict = _env_flag("ROCKET_TPU_STRICT")
        if strict:
            self.strict.activate()

    def _init_resilience(self) -> None:
        """The drain flag, the live Checkpointers, the fault injector and,
        under a supervisor, the escalation exit and the signal drain (the
        reference's ``context.py:575-610``)."""
        from rocket_tpu_torch.resilience.faults import (
            DRAIN_ENV,
            EXIT_WEDGED,
            SUPERVISED_ENV,
            DrainState,
            FaultInjector,
            env_truthy,
            install_signal_drain,
        )

        logger = self.get_logger("resilience")
        self.drain = DrainState()
        self.checkpointers: list = []
        self.faults = FaultInjector.from_env(process_index=self.process_index, logger=logger)
        if self.faults is not None:
            self.faults.install()
        self.supervised = env_truthy(SUPERVISED_ENV)
        if self.supervised:
            self.telemetry.escalation_exit_code = EXIT_WEDGED
        if self.supervised or env_truthy(DRAIN_ENV):
            install_signal_drain(self.drain, logger=logger)

    # -- processes and the data mesh ----------------------------------------------

    def _init_process_group(self, mesh_shape) -> None:
        """Adopt or open the process group, then check ``mesh_shape`` and
        build the data mesh over the ranks."""
        import torch.distributed as dist

        self.grouped = dist.is_available() and dist.is_initialized()
        env = os.environ
        if not self.grouped and env.get("MASTER_ADDR") and env.get("WORLD_SIZE"):
            if self.device.type == "cuda":
                torch.cuda.set_device(self.device)
            # A rank that cannot reach the rendezvous raises here, after
            # torch's timeout: no rank runs alone.
            backend = env.get("ROCKET_TPU_DIST_BACKEND") or (
                "nccl" if self.device.type == "cuda" else "gloo")
            dist.init_process_group(backend, init_method="env://", world_size=int(env["WORLD_SIZE"]),
                                    rank=int(env.get("RANK", "0")))
            self.grouped = True
            # The group this Runtime opened closes, collectively, before the
            # interpreter's teardown, which can abort a process whose gloo
            # group is open.
            atexit.register(_close_group, [self.device.index or 0]
                            if self.device.type == "cuda" else None)
        self._world = dist.get_world_size() if self.grouped else 1
        self._rank = dist.get_rank() if self.grouped else 0
        self.backend = dist.get_backend() if self.grouped else None
        shape = dict(mesh_shape) if mesh_shape is not None else {"data": self._world}
        size = 1
        for axis, n in shape.items():
            size *= int(n)
            if axis not in self.MESH_AXES and int(n) > 1:
                raise NotImplementedError(
                    f"Runtime: mesh axis {axis!r} of size {n}: the port's mesh axes are "
                    f"{self.MESH_AXES} (ROADMAP Queue A 6)")
        split = [axis for axis in self.SPLIT_AXES if int(shape.get(axis, 1)) > 1]
        refused = self._refused_pair(split)
        if refused:
            raise NotImplementedError(
                f"Runtime: mesh {shape} splits over {', '.join(split)} at once: {refused} "
                "(ROADMAP Queue A 6 item 8)")
        if size != self._world:
            raise RuntimeError(f"Runtime: mesh_shape {shape} needs {size} ranks (one device "
                               f"each), the process group has {self._world}")
        self._mesh_shape = shape
        # Mesh coordinates in the shape's axis order, the last axis fastest
        # (the reference's device order): rank = data * model + model index.
        self._coords = self._coords_of(self._rank)
        self._axis_groups: dict = {}
        self.device_mesh = None
        if self.grouped and self._world > 1:
            from torch.distributed.device_mesh import DeviceMesh

            self.device_mesh = DeviceMesh(self.device.type, torch.arange(self._world).reshape(
                tuple(int(n) for n in shape.values())), mesh_dim_names=tuple(shape))
            if any(int(shape.get(axis, 1)) > 1 for axis in self.SPLIT_AXES):
                self._init_axis_groups(dist)

    def _init_axis_groups(self, dist) -> None:
        """One process group per row of each axis larger than 1, and per
        plane of each proper subset of two or more of those axes, every
        rank taking part in every ``new_group`` in one order. The mesh's
        own sub-groups are not used: torch hands out the default group
        for an axis spanning every rank, which would put the model group's
        collectives in one queue with the gradient reduction's."""
        import itertools

        shape = self._mesh_shape
        big = [axis for axis, n in shape.items() if int(n) > 1]
        for axis in big:
            for ranks in self._rows(axis):
                group = dist.new_group(ranks)
                if self._rank in ranks:
                    self._axis_groups[axis] = (group, tuple(ranks))
        for k in range(2, len(big)):
            for axes in itertools.combinations(big, k):
                for ranks in self._rows(axes):
                    group = dist.new_group(ranks)
                    if self._rank in ranks:
                        self._axis_groups[frozenset(axes)] = (group, tuple(ranks))

    def _rows(self, axes) -> list:
        """Every row of ``axes`` (one axis name or several): the global
        ranks that differ only in their coordinates on them, in coordinate
        order (the mesh's order of the axes, the last fastest)."""
        axes = (axes,) if isinstance(axes, str) else tuple(axes)
        names = list(self._mesh_shape)
        grid = torch.arange(self._world).reshape(tuple(int(n) for n in self._mesh_shape.values()))
        dims = sorted(names.index(axis) for axis in axes)
        rest = [d for d in range(len(names)) if d not in dims]
        size = 1
        for d in dims:
            size *= grid.shape[d]
        return [row.tolist() for row in grid.permute(rest + dims).reshape(-1, size)]

    def plane_group(self, axes):
        """The process group of this rank's plane over ``axes`` (the ranks
        that differ only on them): the default group (None) where that
        plane is every rank, an axis's own group where one of ``axes`` is
        larger than 1, else the plane's group."""
        big = frozenset(a for a in axes if int(self._mesh_shape.get(a, 1)) > 1)
        if len(big) == len([n for n in self._mesh_shape.values() if int(n) > 1]):
            return None
        if len(big) == 1:
            return self.axis_group(next(iter(big)))
        if not big:
            raise RuntimeError("Runtime.plane_group: a plane of one rank has no group")
        return self._axis_groups[big][0]

    def axis_index(self, axis: str) -> int:
        """This rank's coordinate on the mesh axis ``axis`` (0 off the mesh)."""
        return int(self._coords.get(axis, 0))

    def axis_ranks(self, axis: str) -> tuple:
        """The global ranks of this rank's row of ``axis``, in coordinate order."""
        if int(self._mesh_shape.get(axis, 1)) <= 1:
            return (self._rank,)
        if axis in self._axis_groups:
            return self._axis_groups[axis][1]
        return tuple(next(row for row in self._rows(axis) if self._rank in row))

    def axis_owners(self, axis: str, at: Optional[dict] = None) -> tuple:
        """The ranks that save the chunks of a leaf sharded over ``axis``:
        the row of ``axis`` at coordinate 0 on every other axis, or at the
        coordinates ``at`` gives (a pipeline stage's layer: ``{"pipe":
        stage}``)."""
        if int(self._mesh_shape.get(axis, 1)) <= 1:
            return (0,)
        at = at or {}
        return tuple(next(row for row in self._rows(axis)
                          if all(c == int(at.get(a, 0)) for a, c in self._coords_of(row[0]).items()
                                 if a != axis)))

    def _coords_of(self, rank: int) -> dict:
        """``rank``'s coordinate on every mesh axis."""
        coords, rest = {}, rank
        for axis in reversed(list(self._mesh_shape)):
            coords[axis] = rest % int(self._mesh_shape[axis])
            rest //= int(self._mesh_shape[axis])
        return coords

    def axis_group(self, axis: str):
        """The process group of this rank's row of ``axis``: its own group
        under a model, seq, pipe or expert axis, else (a data-only mesh)
        the default group (None)."""
        if axis in self._axis_groups:
            return self._axis_groups[axis][0]
        return None

    @property
    def mesh(self) -> dict:
        """The mesh's axes and sizes (``{"data": ranks}``); the torch
        ``DeviceMesh`` over the ranks is :attr:`device_mesh`."""
        return dict(self._mesh_shape)

    @property
    def data_axis_size(self) -> int:
        size = 1
        for axis in self.DATA_AXES:
            size *= int(self._mesh_shape.get(axis, 1))
        return size

    @property
    def model_axis_size(self) -> int:
        return int(self._mesh_shape.get("model", 1))

    @property
    def seq_axis_size(self) -> int:
        """Ranks over which a batch's token dim is sharded (1 without a
        sequence axis)."""
        return int(self._mesh_shape.get(self.seq_axis, 1)) if self.seq_axis else 1

    def axis_size(self, axis: str) -> int:
        """The size of mesh axis ``axis`` (1 off the mesh)."""
        return int(self._mesh_shape.get(axis, 1))

    @property
    def data_index(self) -> int:
        """This rank's stripe of the global batch: its data coordinate
        (every rank of one model, seq, pipe or expert row reads the same
        rows: under an expert axis that is the reference's batch,
        replicated over ``expert``)."""
        return self.axis_index("data")

    @property
    def is_main_process(self) -> bool:
        return self._rank == 0

    @property
    def is_local_main_process(self) -> bool:
        local = os.environ.get("LOCAL_RANK", "")
        return (int(local) if local.isdigit() else self._rank) == 0

    @property
    def process_index(self) -> int:
        return self._rank

    @property
    def process_count(self) -> int:
        return self._world

    def wait_for_everyone(self) -> None:
        """A barrier over every rank (the reference's runs on all ranks
        too); nothing to wait for without a process group. A deliberate
        host wait, so it is legal under strict mode."""
        if not self.grouped:
            return
        import torch.distributed as dist

        with explicit_transfer():
            if self.backend == "nccl":
                dist.barrier(device_ids=[self.device.index or 0])
            else:
                dist.barrier()

    def broadcast_int(self, value: int, src: int = 0) -> int:
        """``value`` as rank ``src`` has it, on every rank (the
        reference's ``broadcast_one_to_all``)."""
        if self._world <= 1:
            return int(value)
        import torch.distributed as dist

        with explicit_transfer():
            t = torch.tensor([int(value)], dtype=torch.int64, device=self.device)
            dist.broadcast(t, src=src)
            return int(t.item())

    def shard_batch(self, batch):
        """A host batch, this rank's stripe of the global batch, on the
        device (the reference's ``shard_batch``: each rank holds its
        stripe). Stripes that do not divide over the data axis raise in a
        multi-process run, as there; one process places the batch as it
        is. Under a sequence axis larger than 1 a leaf of two or more dims
        whose second dim divides over it keeps this rank's slice of that
        dim (the reference shards the token dim over ``seq_axis``). Strings
        and other opaque leaves pass through."""
        from rocket_tpu_torch.data.collate import default_move

        procs, n = self._world, self.data_axis_size
        if procs > 1:
            from rocket_tpu_torch.data.device_cache import tree_leaves

            for leaf in tree_leaves(batch):
                if getattr(leaf, "ndim", 0) >= 1 and (leaf.shape[0] * procs) % n:
                    raise RuntimeError(f"shard_batch: global batch {leaf.shape[0] * procs} not "
                                       f"divisible over data axis ({n}) in a {procs}-process "
                                       "run.")
        seq_n = self.seq_axis_size
        if seq_n > 1:
            batch = _seq_slice(batch, self.axis_index(self.seq_axis), seq_n)
        return default_move(batch, self.device)

    # -- seeds ----------------------------------------------------------------

    @property
    def seed(self) -> int:
        return self._seed

    def next_seed(self) -> int:
        """A fresh 31-bit seed, deterministic given (seed, prior draws)."""
        value = keys.fold_in(keys.key(self._seed), self._seed_counter) & 0x7FFFFFFF
        self._seed_counter += 1
        return value

    def rng_state_dict(self) -> dict:
        """The seed and the draw counter (``rng.json`` of a checkpoint)."""
        return {"seed": self._seed, "key_counter": self._seed_counter}

    def load_rng_state_dict(self, state: dict) -> None:
        self._seed = int(state["seed"])
        self._seed_counter = int(state["key_counter"])

    # -- checkpoint stack -------------------------------------------------------

    @property
    def checkpoint_stack(self) -> Sequence[Any]:
        """The stateful capsules in setup order (what a checkpoint saves)."""
        return tuple(self._checkpoint_stack)

    def register_for_checkpointing(self, obj: Any) -> None:
        if any(existing is obj for existing in self._checkpoint_stack):
            raise RuntimeError(
                f"Runtime: {type(obj).__name__} registered for checkpointing twice."
            )
        self._checkpoint_stack.append(obj)

    def unregister_from_checkpointing(self, obj: Any) -> None:
        """Pop the stack, verifying LIFO identity: destroy unwinds setup."""
        if not self._checkpoint_stack:
            raise RuntimeError(
                f"Runtime: checkpoint stack empty while unregistering {type(obj).__name__}."
            )
        top = self._checkpoint_stack.pop()
        if top is not obj:
            raise RuntimeError(
                f"Runtime: checkpoint stack corrupted — expected {type(obj).__name__}, found "
                f"{type(top).__name__}. Destroy order must unwind setup order."
            )

    # -- logging and teardown -------------------------------------------------

    def get_logger(self, name: str) -> logging.Logger:
        return logging.getLogger(f"rocket_tpu_torch.{name}")

    # -- trackers ---------------------------------------------------------------

    def get_tracker(self, name: str):
        return self.trackers.get(name)

    def init_tracker(self, name: str, tracker: Any) -> Any:
        self.trackers[name] = tracker
        return tracker

    def end_training(self) -> None:
        """End of a launch: close every registered tracker backend, each
        on its own (one failing ``close`` must not leak the others), lift
        strict mode's process-wide guard, decode the health words still in
        their fetch lag (never raising: the run is over), then write the
        telemetry files, last, so the span file records the closes."""
        logger = self.get_logger("runtime")
        for name, tracker in list(self.trackers.items()):
            close = getattr(tracker, "close", None)
            if close is None:
                continue
            try:
                close()
            except Exception as exc:  # noqa: BLE001 — isolate per backend
                logger.warning("tracker backend %r failed to close: %r", name, exc)
        self.trackers.clear()
        self.strict.deactivate()
        try:
            self.health.drain(raise_on_anomaly=False)
        except Exception as exc:  # noqa: BLE001 — teardown must complete
            logger.warning("health drain failed at teardown: %r", exc)
        self.telemetry.close(default_dir=os.path.join(self.project_dir, "runs", "telemetry"),
                             write=self.is_main_process)
