"""Argument checks shared by the kernel wrappers, and the launch facts they
declare.

Every wrapper takes three routes by the device of its tensors: the CPU
runs the plain version, CUDA launches the kernel (or raises), and
``meta`` — torch's abstract tensors, shapes and dtypes with no storage —
launches nothing: the wrapper records the :class:`LaunchFact` of each
launch it would make and returns its outputs, empty meta tensors of the
kernel's shapes. ``meta`` needs no card and no memory, so a whole train
or serve step traces at full model width on the CPU; the schedule audit
(``rocket_tpu_torch.analysis.sched_audit``) reads the facts under
:func:`record_launches`. A meta launch is not a launch: it leaves every
wrapper's ``launches`` count alone.

Each fact also carries the work of its launch, ``flops`` and ``bytes``:
the operations it does and the HBM bytes it moves, each input read once
and each output written once, the quantities PERF.md's bound column is
computed from. The schedule audit's cost model prices a hand kernel by
them. And it declares its numerics, which no aten-op trace can see inside
a ctypes launch: ``acc_dtype``, the dtype the kernel accumulates its
products and sums in, and ``acc_order``, whether those sums run in a
fixed order (``"fixed"``) or in whatever order the card's threads arrive
(``"any"``: a float ``atomicAdd``). The precision audit reads the first,
the determinism audit the second; the schedule audit refuses a fact that
declares no ``acc_dtype``. The collectives (``parallel.collectives``,
``parallel.grad_sync``) record a :class:`CommFact` the same way on meta
tensors.
"""

from __future__ import annotations

import contextlib
import ctypes
import dataclasses
import threading
from dataclasses import dataclass
from typing import Iterable, Iterator, Optional

import torch

__all__ = [
    "DTYPE_CODES", "CommFact", "LaunchFact", "check_cuda_operands", "dtype_name", "itemsize",
    "query_launch", "record", "record_launches", "sm_count", "stream_of", "tile", "with_work",
]

#: Operand dtypes the kernels are compiled for, and their code in the C ABI.
DTYPE_CODES = {torch.float32: 0, torch.bfloat16: 1}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.bfloat16`` -> ``"bfloat16"``."""
    return str(dtype).removeprefix("torch.")


def itemsize(dtype: torch.dtype) -> int:
    """Bytes of one element of ``dtype``."""
    return torch.empty((), dtype=dtype).element_size()


def tile(rows: int, cols: int, dtype: torch.dtype, full_rows: int, full_cols: int) -> tuple:
    """One operand tile of a launch: ``rows`` x ``cols`` elements of
    ``dtype`` cut from a ``full_rows`` x ``full_cols`` plane of its operand
    (the extent the full-dimension waiver of RKT504 compares against)."""
    return ((int(rows), int(cols)), dtype_name(dtype), (int(full_rows), int(full_cols)))


@dataclass(frozen=True)
class LaunchFact:
    """What one kernel launch asks of the card: its grid (3 ints), threads
    per CTA, dynamic and static shared memory per CTA in bytes, and
    ``tiles``, a tuple of :func:`tile` entries for every operand tile a CTA
    stages in shared memory or streams through its loops; ``flops`` and
    ``bytes``, the launch's work (module docstring), and ``flop_dtype``, the
    dtype whose peak rate its operations run at (``"bfloat16"`` on the
    tensor cores, ``"float32"`` on the CUDA cores); ``acc_dtype`` and
    ``acc_order``, its accumulation (module docstring; None: undeclared)."""

    name: str
    grid: tuple
    threads: int
    dynamic_smem: int
    static_smem: int
    tiles: tuple = ()
    flops: float = 0.0
    bytes: int = 0
    flop_dtype: str = "float32"
    acc_dtype: Optional[str] = None
    acc_order: str = "fixed"

    @property
    def smem_bytes(self) -> int:
        return self.dynamic_smem + self.static_smem

    @property
    def geometry(self) -> tuple:
        """``(grid, threads, dynamic_smem, static_smem)``: what a library's
        launch-info query reports for the same launch."""
        return (tuple(self.grid), self.threads, self.dynamic_smem, self.static_smem)


def with_work(fact: LaunchFact, nbytes: float, flops: float, dtype: torch.dtype, *,
              acc: torch.dtype, order: str = "fixed") -> LaunchFact:
    """``fact`` with its work, ``nbytes`` moved and ``flops`` done at the
    rate of ``dtype``, and its numerics: accumulation in ``acc``, in a
    ``"fixed"`` or ``"any"`` order."""
    if order not in ("fixed", "any"):
        raise ValueError(f"with_work: order must be 'fixed' or 'any', not {order!r}")
    return dataclasses.replace(fact, flops=float(flops), bytes=int(nbytes),
                               flop_dtype=dtype_name(dtype), acc_dtype=dtype_name(acc),
                               acc_order=order)


@dataclass(frozen=True)
class CommFact:
    """One collective a rank would issue: ``kind`` (``"all_gather"``,
    ``"all_to_all"``, ``"all_reduce"`` or ``"send_recv"``), ``bytes``, what
    the rank sends over its links (a
    ring all-reduce 2 (n - 1) / n of its payload, an all-gather (n - 1)
    shards, an all-to-all (n - 1) / n of its buffer, a hop its payload),
    ``group``, the ranks taking part, and ``axis``, the mesh axis (or
    plane, or path) it runs over. ``overlapped`` marks a collective whose
    wait comes later than its issue (a ring hop, a gradient bucket): the
    next op need not wait on it."""

    kind: str
    bytes: int
    group: int
    axis: str = ""
    overlapped: bool = False


_recorders = threading.local()


def _stack() -> list:
    stack = getattr(_recorders, "stack", None)
    if stack is None:
        stack = _recorders.stack = []
    return stack


@contextlib.contextmanager
def record_launches(sink=None) -> Iterator[list]:
    """Collect the :class:`LaunchFact` of every meta launch (and the
    :class:`CommFact` of every meta collective) made inside the block into
    the yielded list (or ``sink``), in launch order, on this thread."""
    facts: list = [] if sink is None else sink
    stack = _stack()
    stack.append(facts)
    try:
        yield facts
    finally:
        stack.pop()


def record(facts: Iterable, inputs: tuple = (), outputs: tuple = ()) -> None:
    """A wrapper's (or a collective's) meta route: hand the facts of the
    launches it would make to every open :func:`record_launches` block.
    ``inputs`` and ``outputs``, the meta tensors the launches read and
    write, go to a sink that tracks dataflow (one with a ``note`` method:
    the schedule audit's tracer)."""
    facts = tuple(facts)
    for sink in _stack():
        note = getattr(sink, "note", None)
        if note is not None:
            note(facts, tuple(inputs), tuple(outputs))
        else:
            sink.extend(facts)


def check_cuda_operands(what: str, **tensors: torch.Tensor) -> None:
    """Every operand on one CUDA device (or every one on ``meta``) and
    contiguous; raise otherwise."""
    device = None
    for name, t in tensors.items():
        if t.device.type not in ("cuda", "meta"):
            raise ValueError(f"{what}: {name} is on {t.device}, expected a CUDA device")
        if device is None:
            device = t.device
        elif t.device != device:
            raise ValueError(f"{what}: {name} is on {t.device}, other operands on {device}")
        if not t.is_contiguous():
            raise ValueError(f"{what}: {name} must be contiguous")


def sm_count(t: torch.Tensor, what: str) -> int:
    """The SMs of ``t``'s card, which size a grid that fills it; for a meta
    tensor, of the card being priced (``tune.priced_device_kind``), else of
    the local one. ``what`` names the kernel in the error."""
    if t.device.type != "meta":
        return torch.cuda.get_device_properties(t.device).multi_processor_count
    from rocket_tpu_torch.tune import device_kind
    from rocket_tpu_torch.utils.perf import device_spec

    spec = device_spec(device_kind())
    if spec is None:
        raise ValueError(f"{what}: no SM count for device {device_kind()!r} to size the grid "
                         "of a meta launch; trace under tune.priced_device_kind(<card name>)")
    return spec.sms


def stream_of(t: torch.Tensor) -> int:
    """The raw handle of the current stream on ``t``'s device."""
    return torch.cuda.current_stream(t.device).cuda_stream


def query_launch(fn, *args: int) -> tuple:
    """Call a library's ``rkt_<lib>_launch_info(*args, long long info[6])``
    and return ``(grid, threads, dynamic_smem, static_smem)``; the static
    part is ``cudaFuncGetAttributes().sharedSizeBytes`` of the kernel, so
    this needs the card. Raises on a CUDA error."""
    info = (ctypes.c_longlong * 6)()
    err = fn(*args, info)
    if err:
        raise RuntimeError(f"{fn.__name__}: launch-info query failed with cudaError {err}")
    return (tuple(info[:3]), info[3], info[4], info[5])
