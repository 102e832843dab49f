"""Deterministic fault injection and the cooperative drain (counterpart of
``rocket_tpu/resilience/faults.py``).

The supervisor (``resilience/supervisor.py``) treats a worker's death as
an event; this module holds the two halves that live in the worker:

* **FaultPlan / FaultInjector**: a seedable schedule of injected failures
  (kill a rank at a step, SIGTERM at a step or a wall time, wedge a step,
  poison a batch) read from ``ROCKET_TPU_FAULTS``, so the real launcher,
  Looper and Checkpointer are what fails. A fault belongs to one
  supervisor generation (``gen=``, default 0, matched against
  ``ROCKET_TPU_GENERATION``), so a restarted generation runs clean.
* **DrainState / GracefulDrain**: the cooperative preemption protocol. A
  SIGTERM sets the Runtime's :class:`DrainState`; the Looper polls it at
  every wave boundary, writes a synchronous checkpoint
  (``Checkpointer.save_drain``) and raises :class:`GracefulDrain`, a
  ``SystemExit`` carrying :data:`EXIT_DRAINED`, so the process unwinds
  through its normal teardown and exits with the "drained" code.

The exit codes and environment names are the reference's: the two packages
share one supervisor-worker contract, as they share ``ROCKET_TPU_TELEMETRY``
and ``ROCKET_TPU_WATCHDOG``. Standard library only at module level (numpy
and torch are imported inside the poison path), so the supervisor's parent
process imports it without touching a device.
"""

from __future__ import annotations

import dataclasses
import os
import random
import signal
import sys
import threading
import time
from typing import Optional

__all__ = ["EXIT_DRAINED", "EXIT_WEDGED", "Fault", "FaultPlan", "FaultInjector", "DrainState",
           "GracefulDrain", "install_signal_drain", "env_truthy"]

#: Exit code of a worker that finished a cooperative drain (in-flight wave
#: done, drain checkpoint written): a clean stop to the supervisor. 84 is
#: clear of the shell's 126/127, Python's 1/2 and the 128+signal band.
EXIT_DRAINED = 84

#: Exit code of a worker whose watchdog escalated a wedged step under a
#: supervisor: the black box is written and a restart is the only recovery.
EXIT_WEDGED = 85

#: The environment of the supervisor-worker contract.
FAULTS_ENV = "ROCKET_TPU_FAULTS"
GENERATION_ENV = "ROCKET_TPU_GENERATION"
SUPERVISED_ENV = "ROCKET_TPU_SUPERVISED"
DRAIN_ENV = "ROCKET_TPU_DRAIN"

_KINDS = ("kill", "sigterm", "wedge", "poison")


def env_truthy(name: str) -> bool:
    return os.environ.get(name, "").strip().lower() in ("1", "true", "yes", "on")


@dataclasses.dataclass(frozen=True)
class Fault:
    """One scheduled fault. ``step`` counts the iteration waves this
    process has driven since the injector was made (its own counter, so a
    resumed generation does not replay generation 0's step numbers), or the
    batches it has consumed for ``poison``. ``wall`` (sigterm only) is
    seconds after install. ``rank=None`` matches every process; ``gen``
    scopes the fault to one supervisor generation; ``secs`` is a wedge's
    length."""

    kind: str
    step: Optional[int] = None
    wall: Optional[float] = None
    rank: Optional[int] = None
    gen: int = 0
    secs: float = 3600.0

    def __post_init__(self) -> None:
        if self.kind not in _KINDS:
            raise ValueError(f"FaultPlan: unknown fault kind {self.kind!r} (expected one of "
                             f"{_KINDS})")
        if self.kind == "sigterm":
            if self.step is None and self.wall is None:
                raise ValueError("FaultPlan: sigterm fault needs step= or wall=")
        elif self.step is None:
            raise ValueError(f"FaultPlan: {self.kind} fault needs step=")

    def to_spec(self) -> str:
        parts = []
        for key in ("step", "wall", "rank", "secs"):
            value = getattr(self, key)
            if value is None or (key == "secs" and self.kind != "wedge"):
                continue
            parts.append(f"{key}={value:g}" if isinstance(value, float) else f"{key}={value}")
        parts.append(f"gen={self.gen}")
        return f"{self.kind}:" + ",".join(parts)


class FaultPlan:
    """An ordered list of :class:`Fault` with a text form, the value of
    ``ROCKET_TPU_FAULTS``::

        kill:step=23;sigterm:wall=3.5;wedge:step=7,secs=600;poison:step=3,rank=1,gen=1

    Entries are ``;``-separated, each ``kind:key=value,...``. Parsing is
    strict: a mistyped kind or key raises, since a plan that silently
    injects nothing reads as a passing test."""

    def __init__(self, faults: list) -> None:
        self.faults = list(faults)

    def __iter__(self):
        return iter(self.faults)

    def __len__(self) -> int:
        return len(self.faults)

    def to_spec(self) -> str:
        return ";".join(f.to_spec() for f in self.faults)

    @classmethod
    def parse(cls, spec: str) -> "FaultPlan":
        faults = []
        for entry in spec.split(";"):
            entry = entry.strip()
            if not entry:
                continue
            kind, _, rest = entry.partition(":")
            kwargs: dict = {}
            for item in rest.split(","):
                item = item.strip()
                if not item:
                    continue
                key, sep, value = item.partition("=")
                key = key.strip()
                if not sep:
                    raise ValueError(f"FaultPlan: malformed item {item!r} in {entry!r} "
                                     "(expected key=value)")
                if key in ("step", "rank", "gen"):
                    kwargs[key] = int(value)
                elif key in ("wall", "secs"):
                    kwargs[key] = float(value)
                else:
                    raise ValueError(f"FaultPlan: unknown key {key!r} in {entry!r}")
            faults.append(Fault(kind=kind.strip(), **kwargs))
        return cls(faults)

    @classmethod
    def sample(cls, seed: int, max_step: int = 50, nproc: int = 1,
               kinds: tuple = ("kill", "sigterm", "wedge", "poison"), n: int = 1) -> "FaultPlan":
        """A random plan, the same for the same arguments (the reference's
        draws, in its order): a seed sweep in CI reproduces every failure."""
        rng = random.Random(seed)
        faults = []
        for _ in range(n):
            kind = rng.choice(list(kinds))
            step = rng.randrange(1, max_step)
            rank = rng.randrange(nproc) if nproc > 1 else None
            faults.append(Fault(kind=kind, step=step, rank=rank))
        return cls(faults)


class FaultInjector:
    """Runs a :class:`FaultPlan` inside a worker. The Looper calls
    :meth:`step_hook` at the top of every wave and the Dataset passes each
    consumed batch through :meth:`poison_hook`; with no plan the Runtime
    holds no injector and both cost one attribute check. The actions are
    injectable for tests; the defaults are the real ones (SIGKILL or
    SIGTERM to this process, a ``time.sleep`` wedge)."""

    def __init__(self, plan: FaultPlan, process_index: int = 0, generation: int = 0,
                 logger=None, kill_fn=None, sigterm_fn=None, sleep_fn=time.sleep) -> None:
        self._logger = logger
        self._kill = kill_fn or (lambda: os.kill(os.getpid(), signal.SIGKILL))
        self._sigterm = sigterm_fn or (lambda: os.kill(os.getpid(), signal.SIGTERM))
        self._sleep = sleep_fn
        self.generation = generation
        self.process_index = process_index
        self.active = [f for f in plan if f.gen == generation
                       and (f.rank is None or f.rank == process_index)]
        self._waves = 0
        self._batches = 0
        self._fired: list = []
        self._timers: list = []

    @classmethod
    def from_env(cls, process_index: int = 0, logger=None,
                 environ=None) -> Optional["FaultInjector"]:
        """From ``ROCKET_TPU_FAULTS`` and ``ROCKET_TPU_GENERATION``; None
        when no plan is set."""
        environ = os.environ if environ is None else environ
        spec = environ.get(FAULTS_ENV, "").strip()
        if not spec:
            return None
        generation = int(environ.get(GENERATION_ENV, "0") or 0)
        return cls(FaultPlan.parse(spec), process_index=process_index, generation=generation,
                   logger=logger)

    def install(self) -> None:
        """Arm the wall-clock faults (daemon timers for ``sigterm:wall=``)."""
        for fault in self.active:
            if fault.kind == "sigterm" and fault.wall is not None:
                timer = threading.Timer(fault.wall, self._fire, args=(fault, "wall"))
                timer.daemon = True
                timer.start()
                self._timers.append(timer)

    def step_hook(self, tag: str, batch_idx: int) -> None:
        """The Looper's call at the top of each wave."""
        self._waves += 1
        for fault in self.active:
            if fault.kind in ("kill", "wedge") or (fault.kind == "sigterm" and fault.wall is None):
                if fault.step == self._waves:
                    self._fire(fault, f"{tag}[{batch_idx}]")

    def poison_hook(self, batch):
        """The Dataset's call for every consumed batch: NaN-fills the
        floating leaves of the scheduled one, so the health sentinels'
        anomaly policy runs through the real data path. A CUDA tensor is
        replaced by a NaN tensor made on its own card (no upload inside the
        step), a numpy array by a host NaN array. A batch with nothing
        floating (GPT-2's token ids) passes through NOT fired, with a
        warning: a fault plan that silently does nothing would read as a
        passing test."""
        self._batches += 1
        for fault in self.active:
            if fault.kind == "poison" and fault.step == self._batches:
                poisoned, count = _poison_tree(batch)
                if count == 0:
                    self._warn(f"fault injection: poison fault {fault.to_spec()} matched "
                               f"batch[{self._batches}] but found no floating-point leaves "
                               "(integer token ids?) — NOT firing")
                    return batch
                self._note(fault, f"batch[{self._batches}]")
                return poisoned
        return batch

    @property
    def fired(self) -> tuple:
        return tuple(self._fired)

    def _note(self, fault: Fault, where: str) -> None:
        self._fired.append(f"{fault.kind}@{where}")
        self._warn(f"fault injection: firing {fault.to_spec()} at {where} "
                   f"(gen {self.generation}, rank {self.process_index})")

    def _warn(self, message: str) -> None:
        if self._logger is not None:
            self._logger.warning("%s", message)
        else:
            print(message, file=sys.stderr, flush=True)

    def _fire(self, fault: Fault, where: str) -> None:
        self._note(fault, where)
        if fault.kind == "kill":
            self._kill()
        elif fault.kind == "sigterm":
            self._sigterm()
        elif fault.kind == "wedge":
            # The loop blocks without exiting: no beat reaches the watchdog,
            # whose escalation (obs/telemetry.py) turns the wedge into an
            # EXIT_WEDGED restart under a supervisor.
            self._sleep(fault.secs)


def _poison_tree(batch):
    """``(poisoned, count)``: every floating leaf of a nested dict / list /
    tuple batch NaN-filled, and how many leaves were. A torch tensor becomes
    ``torch.full_like(leaf, nan)`` on its own device; a numpy array (or
    anything else with a floating ``dtype`` and a ``shape``) a host NaN
    array, as in the reference. Integer and boolean leaves stay."""
    if isinstance(batch, dict):
        out, total = {}, 0
        for key, value in batch.items():
            out[key], n = _poison_tree(value)
            total += n
        return out, total
    if isinstance(batch, (list, tuple)):
        parts = [_poison_tree(v) for v in batch]
        return type(batch)(p for p, _ in parts), sum(n for _, n in parts)
    if type(batch).__module__.startswith("torch"):
        import torch

        if isinstance(batch, torch.Tensor):
            if batch.is_floating_point() or batch.is_complex():
                return torch.full_like(batch, float("nan")), 1
            return batch, 0
    dtype, shape = getattr(batch, "dtype", None), getattr(batch, "shape", None)
    if dtype is not None and shape is not None:
        import numpy as np

        try:
            inexact = np.issubdtype(dtype, np.inexact)
        except TypeError:
            inexact = False
        if inexact:
            return np.full(shape, np.nan, dtype=dtype), 1
    return batch, 0


class GracefulDrain(SystemExit):
    """Raised by the Looper once a drain request is honoured: a
    ``SystemExit`` with :data:`EXIT_DRAINED`, so the process unwinds
    through every ``finally`` (the Launcher's destroy, the telemetry flush,
    the checkpoint writer) with no help from the script. The Looper's
    black-box handler (``except Exception``) does not catch it: a drain is
    not a failure."""

    def __init__(self, checkpoint: Optional[str] = None, reason: str = "drain") -> None:
        super().__init__(EXIT_DRAINED)
        self.checkpoint = checkpoint
        self.reason = reason


class DrainState:
    """The Runtime's drain flag: set by the SIGTERM handler (or by code, a
    preemption-notice poller), polled by every Looper at wave boundaries.
    Plain attribute writes, False to True only."""

    def __init__(self) -> None:
        self.requested = False
        self.reason: Optional[str] = None
        self.requested_at: Optional[float] = None

    def request(self, reason: str = "drain") -> None:
        if not self.requested:
            self.requested = True
            self.reason = reason
            self.requested_at = time.time()


def install_signal_drain(drain: DrainState, logger=None) -> bool:
    """Route SIGTERM into ``drain.request()``; False when it cannot be
    installed (off the main thread, or no signals here). A previous
    Python-level SIGTERM handler is chained; the default and ignore
    dispositions are replaced. SIGINT is routed too, once: the first
    Ctrl-C requests a drain and puts the previous SIGINT disposition back,
    so a second one interrupts hard. The handlers only set the flag (no
    logging: the logging module takes a lock a signal could land inside);
    the Looper logs the reason when it honours the request."""
    if threading.current_thread() is not threading.main_thread():
        if logger is not None:
            logger.warning("drain: not installing SIGTERM handler off the main thread")
        return False
    try:
        previous = signal.getsignal(signal.SIGTERM)

        def handler(signum, frame):
            drain.request("SIGTERM")
            if callable(previous) and previous not in (signal.SIG_IGN, signal.SIG_DFL,
                                                       signal.default_int_handler):
                previous(signum, frame)

        signal.signal(signal.SIGTERM, handler)
        previous_int = signal.getsignal(signal.SIGINT)

        def int_handler(signum, frame):
            drain.request("SIGINT")
            signal.signal(signal.SIGINT, previous_int)

        signal.signal(signal.SIGINT, int_handler)
        return True
    except (ValueError, OSError) as exc:
        if logger is not None:
            logger.warning("drain: cannot install SIGTERM handler: %r", exc)
        return False
