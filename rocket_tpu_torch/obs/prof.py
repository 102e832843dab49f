"""Device-trace capture and the measured half of the roofline loop
(counterpart of ``rocket_tpu/obs/prof.py``, over ``torch.profiler``'s
Chrome trace where the reference reads XLA's).

* **capture**: :class:`TraceSession` opens a ``torch.profiler`` window
  (CPU and, on a card, CUDA activity) and writes it with
  ``export_chrome_trace`` into its directory, with a
  :data:`CAPTURE_META_FILE` sidecar naming the machine that measured it
  (the card's name and power limit, the torch and CUDA versions). The
  bounded-overhead policy is :class:`ProfPolicy` (``ROCKET_TPU_PROF``:
  off by default; ``N@M`` traces N steps every M); the Profiler capsule
  drives it for training, the serve engine's ``capture_trace`` window
  (``--trace-steps A:B``) for serving.
* **parse**: :func:`parse_trace` reads the device slices of a torch
  trace (events of category ``kernel``, ``gpu_memcpy`` and
  ``gpu_memset``), names each by its kernel (template arguments and the
  parameter list canonicalised away, :func:`canonical_op_name`), sorts
  it into a category (:func:`categorize`), and files it under the step
  whose host range LAUNCHED it: the slice's ``correlation`` id joins it
  to its runtime launch event (``cudaLaunchKernel``, ``cuLaunchKernel``,
  ``cudaMemcpyAsync``, ...), and the launch's host timestamp falls in
  one step annotation. A timestamp join would misfile: the serve engine
  enqueues wave N+1 while wave N runs, so a kernel often runs after the
  next step's host range opened. Step annotations are the serve
  engine's ``serve_tick#N`` ranges and the Profiler capsule's
  ``ProfilerStep#N``. Per step it measures the device span (first to
  last slice), the busy union, and exposed communication: collective
  time no compute slice covers (0 on one card).
* **surface**: ``python -m rocket_tpu_torch.obs prof <trace>`` renders
  the attribution table; :func:`publish_prof` lands the headline numbers
  as ``obs/prof/*`` gauges. With ``--target`` it reconciles the trace
  against the analysis' priced step (``analysis/calib.py``).
* **join**: :func:`parse_op_trace` buckets the device time by the op
  that launched it, for that reconciliation: a kernel's launch event
  (joined by correlation id, as above) sits inside the host ranges of the
  aten ops that issued it, and the outermost of them that the priced step
  knows is its op; a hand kernel (:data:`KERNEL_FACTS`), launched through
  ctypes under no aten op, is its own. The k-th such op of one name in a
  step is ``<name>#<k>``, the priced op's name; the kernels of one op
  (cuBLAS's split-K and its reduce) sum. A CPU trace has no device
  slices: its outermost priced ops are measured as themselves.

Categories (:func:`categorize`), first match wins:

==============  ===========================================================
``memory``      ``gpu_memcpy`` / ``gpu_memset`` slices
``collective``  kernels named ``nccl*``
``compute``     the port's own ``csrc`` kernels (:data:`PORT_KERNELS`, by
                entry name); GEMM and convolution kernels of cuBLAS,
                CUTLASS and cuDNN (names holding ``gemm``, ``cublas``,
                ``cutlass``, ``xmma``, cuBLAS's ``nvjet``, ``cudnn``,
                ``conv`` ...)
``memory``      elementwise, reduce, copy, fill, index, gather, scatter and
                concatenation kernels (ATen's ``elementwise_kernel``,
                ``reduce_kernel``, ``CatArrayBatchedCopy``, ``foreach``
                kernels, ...)
``other``       the rest
==============  ===========================================================

Everything but :class:`TraceSession` is stdlib-only, so the CLI and the
tests parse traces with no device.
"""

from __future__ import annotations

import glob
import gzip
import json
import os
import re
import subprocess
import time
from dataclasses import dataclass, field
from typing import Iterable, Mapping, Optional, Tuple

__all__ = [
    "ProfPolicy",
    "TraceSession",
    "capture_metadata",
    "OpSlice",
    "MeasuredOp",
    "StepRecord",
    "TraceSummary",
    "find_trace_file",
    "load_trace_events",
    "parse_trace",
    "prof_record",
    "publish_prof",
    "render_prof",
    "parse_step_window",
    "canonical_op_name",
    "opcode_of",
    "categorize",
    "PORT_KERNELS",
    "KERNEL_FACTS",
    "CAPTURE_META_FILE",
    "parse_op_trace",
]

#: The port's ``csrc`` kernel entry names -> the wrapper (``ops/``) that
#: launches them. A wrapper call launches each of its entries at most once.
PORT_KERNELS = {
    "paged_split_kernel": "paged_decode",
    "paged_combine_kernel": "paged_decode",
    "decode_split_kernel": "decode_attention",
    "decode_combine_kernel": "decode_attention",
    "flash_fwd_kernel": "flash_fwd",
    "flash_fwd_tc_kernel": "flash_fwd",
    "flash_bwd_kernel": "flash_bwd",
    "flash_bwd_tc_kernel": "flash_bwd",
    "flash_dq_kernel": "flash_dq",
    "flash_dq_tc_kernel": "flash_dq",
    "qkv_fwd_kernel": "flash_qkv_fwd",
    "qkv_fwd_tc_kernel": "flash_qkv_fwd",
    "qkv_bwd_kernel": "flash_qkv_bwd",
    "qkv_bwd_tc_kernel": "flash_qkv_bwd",
    "fused_block_kernel": "fused_block",
    "fused_block_tc_kernel": "fused_block",
    "twopass_kernel": "bn_twopass",
    "twopass_any_kernel": "bn_twopass",
    "normalize_kernel": "bn_normalize",
    "normalize_any_kernel": "bn_normalize",
    "gmm_kernel": "gather_gmm",
    "grouped_wgmma_kernel": "grouped_gemm",
    "tgmm_kernel": "tgmm",
    "bad_scale_kernel": "badpallas",
}

#: The port's ``csrc`` kernel entry names -> the ``LaunchFact`` name its
#: wrapper declares for that launch (``ops/*_launch``), the calibration's
#: join key of a hand kernel. The grouped products share one wgmma kernel
#: across three wrappers and are not named here.
KERNEL_FACTS = {
    "paged_split_kernel": "paged_decode", "paged_combine_kernel": "paged_decode_combine",
    "decode_split_kernel": "decode_attention",
    "decode_combine_kernel": "decode_attention_combine",
    "flash_fwd_kernel": "flash_fwd", "flash_fwd_tc_kernel": "flash_fwd",
    "flash_bwd_kernel": "flash_bwd", "flash_bwd_tc_kernel": "flash_bwd",
    "flash_dq_kernel": "flash_dq", "flash_dq_tc_kernel": "flash_dq",
    "qkv_fwd_kernel": "flash_qkv_fwd", "qkv_fwd_tc_kernel": "flash_qkv_fwd",
    "qkv_bwd_kernel": "flash_qkv_bwd", "qkv_bwd_tc_kernel": "flash_qkv_bwd",
    "fused_block_kernel": "fused_block", "fused_block_tc_kernel": "fused_block",
    "twopass_kernel": "bn_twopass", "twopass_any_kernel": "bn_twopass_any",
    "normalize_kernel": "bn_normalize", "normalize_any_kernel": "bn_normalize_any",
    "tgmm_kernel": "tgmm", "bad_scale_kernel": "bad_scale",
}

#: Device-slice categories of torch's Chrome trace.
DEVICE_CATS = frozenset({"kernel", "gpu_memcpy", "gpu_memset"})

_STEP_RE = re.compile(r"^(ProfilerStep|serve_tick)#(\d+)$")
_COMPUTE_WORDS = ("gemm", "cublas", "cutlass", "xmma", "nvjet", "cudnn", "conv", "wgmma",
                  "matmul", "sm90_", "sm80_")
_MEMORY_WORDS = ("elementwise", "reduce", "copy", "fill", "index", "gather", "scatter", "cat",
                 "foreach", "memcpy", "memset")


# -- capture policy --------------------------------------------------------------


@dataclass(frozen=True)
class ProfPolicy:
    """Trace-window policy (``ROCKET_TPU_PROF``).

    ``steps`` consecutive steps are traced per window; with ``every`` > 0
    a new window opens each time the step counter crosses another
    multiple of ``every``, otherwise exactly one window opens at
    ``start``. The tracer is live for ``steps / every`` of the run.

    Env grammar (off unless set):

    * ``ROCKET_TPU_PROF=1`` — one window, defaults (3 steps at step 10);
    * ``ROCKET_TPU_PROF=A:B`` — one window over steps ``[A, B)``;
    * ``ROCKET_TPU_PROF=N@M`` — N steps every M steps (first window at
      step M).
    """

    steps: int = 3
    every: int = 0
    start: int = 10

    @classmethod
    def from_env(cls, value: Optional[str]) -> Optional["ProfPolicy"]:
        """Parse the ``ROCKET_TPU_PROF`` grammar; None = tracing off. Raises
        ``ValueError`` on a malformed value: a typo'd policy must not run
        untraced."""
        if value is None:
            return None
        text = value.strip()
        if text in ("", "0", "off", "false"):
            return None
        if text in ("1", "on", "true"):
            return cls()
        if "@" in text:
            steps_s, _, every_s = text.partition("@")
            steps, every = int(steps_s), int(every_s)
            if steps <= 0 or every <= steps:
                raise ValueError(f"ROCKET_TPU_PROF={value!r}: N@M needs 0 < N < M")
            return cls(steps=steps, every=every, start=every)
        if ":" in text:
            try:
                start, stop = parse_step_window(text)
            except ValueError as exc:
                raise ValueError(f"ROCKET_TPU_PROF={value!r}: {exc}") from exc
            return cls(steps=stop - start, every=0, start=start)
        raise ValueError(f"ROCKET_TPU_PROF={value!r}: expected '1', 'A:B' or 'N@M'")

    def window_start(self, step: int) -> bool:
        """Does a trace window open at ``step``?"""
        if self.every > 0:
            return step >= self.start and (step - self.start) % self.every == 0
        return step == self.start


def parse_step_window(text: str) -> Tuple[int, int]:
    """``"A:B"`` -> (A, B) with 0 <= A < B (the serve CLI's
    ``--trace-steps`` grammar)."""
    start_s, sep, stop_s = text.partition(":")
    if not sep:
        raise ValueError(f"trace window {text!r}: expected 'A:B'")
    start, stop = int(start_s), int(stop_s)
    if start < 0 or stop <= start:
        raise ValueError(f"trace window {text!r}: needs 0 <= A < B")
    return start, stop


# -- capture ---------------------------------------------------------------------

#: Sidecar written next to every capture: which machine MEASURED the
#: trace, so a re-render elsewhere does not claim its own card.
CAPTURE_META_FILE = "capture.json"


def _card_power_limit() -> Optional[str]:
    """``name, power.limit`` as ``nvidia-smi`` reports them, or None."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=10, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else None


class TraceSession:
    """One ``torch.profiler`` capture window written as a Chrome trace.

    ``start()`` is a no-op while a window is open, ``stop()`` when none
    is. ``stop()`` first synchronises the card (so the window's kernels
    end inside it; through the explicit-transfer helper, legal under
    strict mode), then writes ``window_<n>.trace.json`` and the
    :data:`CAPTURE_META_FILE` sidecar, and returns the trace file. A
    failure to write either raises."""

    def __init__(self, trace_dir: str) -> None:
        import torch

        self.trace_dir = trace_dir
        self.active = False
        #: The card's ``name, power.limit`` for the sidecar, read when the
        #: session is made: ``nvidia-smi`` is a process of its own, which
        #: ``stop()`` inside a serving tick would wait for.
        self.card = _card_power_limit() if torch.cuda.is_available() else None
        self.windows = 0
        self._prof = None
        #: The last closed window's ``torch.profiler.profile`` (its own
        #: ``key_averages()`` stay readable).
        self.last_profile = None
        #: Seconds the last ``start()`` took (CUPTI's start-up), and the
        #: last ``stop()``'s synchronise, collection and export.
        self.start_s = None
        self.stop_s: dict = {}

    def start(self) -> bool:
        if self.active:
            return False
        import torch
        from torch.profiler import ProfilerActivity, profile

        os.makedirs(self.trace_dir, exist_ok=True)
        activities = [ProfilerActivity.CPU]
        if torch.cuda.is_available() and torch.cuda.is_initialized():
            activities.append(ProfilerActivity.CUDA)
        t0 = time.perf_counter()
        self._prof = profile(activities=activities)
        self._prof.start()
        self.start_s = time.perf_counter() - t0
        self.active = True
        return True

    def stop(self) -> Optional[str]:
        """Close the window; returns its trace file (None when no window
        was open)."""
        if not self.active:
            return None
        import torch

        from rocket_tpu_torch.runtime import explicit_transfer

        t0 = time.perf_counter()
        cuda = torch.cuda.is_available() and torch.cuda.is_initialized()
        if cuda:
            with explicit_transfer():
                torch.cuda.synchronize()
        prof, self._prof = self._prof, None
        self.active = False
        t1 = time.perf_counter()
        prof.stop()
        self.last_profile = prof
        t2 = time.perf_counter()
        path = os.path.join(self.trace_dir, f"window_{self.windows}.trace.json")
        prof.export_chrome_trace(path)
        self.stop_s = {"sync": t1 - t0, "collect": t2 - t1, "export": time.perf_counter() - t2}
        self.windows += 1
        meta = {"platform": "gpu" if cuda else "cpu", "torch": torch.__version__,
                "cuda": torch.version.cuda}
        if cuda:
            meta.update(device_kind=torch.cuda.get_device_name(0),
                        n_devices=torch.cuda.device_count(), card=self.card)
        target = os.path.join(self.trace_dir, CAPTURE_META_FILE)
        tmp = target + ".tmp"
        with open(tmp, "w", encoding="utf-8") as f:
            json.dump(meta, f)
        os.replace(tmp, target)
        return path


def capture_metadata(path: str) -> dict:
    """The :data:`CAPTURE_META_FILE` sidecar of a trace file or capture
    directory (searched upward a few levels), or ``{}`` when absent or
    corrupt."""
    directory = path if os.path.isdir(path) else os.path.dirname(path)
    for _ in range(4):
        candidate = os.path.join(directory, CAPTURE_META_FILE)
        if os.path.isfile(candidate):
            try:
                with open(candidate, "r", encoding="utf-8") as f:
                    meta = json.load(f)
                return meta if isinstance(meta, dict) else {}
            except (OSError, ValueError):
                return {}
        parent = os.path.dirname(directory)
        if parent == directory:
            break
        directory = parent
    return {}


# -- trace loading ---------------------------------------------------------------


def find_trace_file(path: str) -> Optional[str]:
    """``path`` as a trace-event file: a file as it is; a directory
    searched recursively for ``*.trace.json(.gz)``, then the Profiler
    capsule's ``window_*.json`` — the newest wins, so repeated windows
    into one directory resolve to the last capture."""
    if os.path.isfile(path):
        return path
    candidates: list = []
    for pattern in ("**/*.trace.json.gz", "**/*.trace.json", "**/window_*.json"):
        candidates = glob.glob(os.path.join(path, pattern), recursive=True)
        if candidates:
            break
    if not candidates:
        return None
    return max(candidates, key=os.path.getmtime)


def load_trace_events(path: str) -> list:
    """Chrome trace-event JSON (plain or gzipped; object or bare array
    form) -> its event list. Raises ``ValueError`` on anything else."""
    opener = gzip.open if path.endswith(".gz") else open
    try:
        with opener(path, "rt", encoding="utf-8") as f:
            doc = json.load(f)
    except (OSError, ValueError, EOFError) as exc:
        raise ValueError(f"{path}: cannot read trace events: {exc}") from exc
    events = doc.get("traceEvents") if isinstance(doc, dict) else doc
    if not isinstance(events, list):
        raise ValueError(f"{path}: not a trace-event file (no event list)")
    return events


# -- parsing ---------------------------------------------------------------------


@dataclass(frozen=True)
class OpSlice:
    """One device slice: a kernel, copy or set."""

    name: str            # raw event name
    canon: str           # canonical kernel name (join key)
    opcode: str          # the kernel's entry name
    category: str        # "compute" | "memory" | "collective" | "other"
    module: str          # the port wrapper of a csrc kernel, else ""
    ts_us: float
    dur_us: float
    step: Optional[int] = None


@dataclass
class MeasuredOp:
    """All slices of one kernel, aggregated."""

    name: str
    opcode: str
    category: str
    module: str
    total_us: float = 0.0
    count: int = 0

    @property
    def mean_us(self) -> float:
        return self.total_us / self.count if self.count else 0.0


@dataclass
class StepRecord:
    """One annotated step's device-side accounting."""

    name: str
    step: int
    start_us: float
    end_us: float
    #: host wall time of the annotation range
    wall_us: float = 0.0
    #: first-to-last device activity launched inside the range
    device_span_us: float = 0.0
    #: union of device busy intervals (parallel streams counted once)
    device_busy_us: float = 0.0
    #: collective time not overlapped by any non-collective device slice
    exposed_comm_us: float = 0.0
    categories: dict = field(default_factory=dict)
    #: slices per kernel entry name launched inside the range
    kernels: dict = field(default_factory=dict)


@dataclass
class TraceSummary:
    """Everything the CLI table and the gauges need."""

    ops: list            # list[MeasuredOp]
    steps: list          # list[StepRecord], annotated steps only
    modules: dict        # module -> total device us
    n_slices: int = 0
    unattributed_us: float = 0.0  # device time launched outside any step

    def module_ops(self, module: Optional[str]) -> list:
        if module is None:
            return list(self.ops)
        return [op for op in self.ops if op.module == module]

    @property
    def device_total_us(self) -> float:
        return sum(op.total_us for op in self.ops)

    def mean(self, attr: str) -> float:
        """Mean of a StepRecord field over the attributed steps."""
        if not self.steps:
            return 0.0
        return sum(getattr(s, attr) for s in self.steps) / len(self.steps)

    def category_totals(self, module: Optional[str] = None) -> dict:
        totals: dict = {}
        for op in self.module_ops(module):
            totals[op.category] = totals.get(op.category, 0.0) + op.total_us
        return totals

    def step_launches(self, wrapper: str) -> int:
        """Calls of a port wrapper (:data:`PORT_KERNELS`) launched inside the
        steps' host ranges: per step the most slices of any one of its
        kernels (a kernel launched before the window opened, still running
        in it, is not one)."""
        entries = [e for e, w in PORT_KERNELS.items() if w == wrapper]
        return sum(max((s.kernels.get(e, 0) for e in entries), default=0) for s in self.steps)


def _strip_balanced(text: str, open_ch: str, close_ch: str) -> str:
    """``text`` with every top-level ``open_ch ... close_ch`` group removed."""
    out, depth = [], 0
    for ch in text:
        if ch == open_ch:
            depth += 1
        elif ch == close_ch and depth:
            depth -= 1
        elif not depth:
            out.append(ch)
    return "".join(out)


def canonical_op_name(name: str) -> str:
    """A kernel's event name as its canonical op name: the return type,
    the parameter list and template arguments dropped (``void
    paged_split_kernel<__nv_bfloat16, 64>(...)`` -> ``paged_split_kernel``;
    ``void at::native::vectorized_elementwise_kernel<4, ...>(int, ...)``
    -> ``at::native::vectorized_elementwise_kernel``). A generic launcher
    (``cutlass::Kernel2<...>``, ``device_kernel<...>``) keeps the name of
    its template argument, which is what names the kernel."""
    text = name.strip()
    if text.startswith("void "):
        text = text[len("void "):]
    text = text.replace("(anonymous namespace)::", "")
    if text.endswith(")"):
        depth = 0
        for i in range(len(text) - 1, -1, -1):
            depth += {")": 1, "(": -1}.get(text[i], 0)
            if depth == 0:
                text = text[:i]
                break
    head = _strip_balanced(text, "<", ">").strip()
    last = head.rsplit("::", 1)[-1]
    if re.fullmatch(r"(Kernel\d*|device_kernel|kernel)", last) and "<" in text:
        inner = text[text.index("<") + 1:]
        inner = _strip_balanced(inner.split(",")[0].rstrip(">"), "<", ">").strip()
        return f"{head}<{inner}>"
    return head


def opcode_of(name: str) -> str:
    """The entry name of a canonical kernel name (its last ``::``
    component, a launcher's template argument kept)."""
    return name.rsplit("::", 1)[-1] if "<" not in name else name


def categorize(name: str, cat: Optional[str] = None) -> str:
    """compute / memory / collective / other for a device slice (the
    table in the module docstring): ``name`` the raw or canonical kernel
    name, ``cat`` its trace category."""
    if cat in ("gpu_memcpy", "gpu_memset"):
        return "memory"
    lower = name.lower()
    if "nccl" in lower:
        return "collective"
    entry = canonical_op_name(name).rsplit("::", 1)[-1]
    if entry in PORT_KERNELS or any(w in lower for w in _COMPUTE_WORDS):
        return "compute"
    if any(w in lower for w in _MEMORY_WORDS):
        return "memory"
    return "other"


def _union_length(intervals: list) -> float:
    """Total covered length of (start, end) intervals."""
    return sum(hi - lo for lo, hi in _merge(intervals))


def _merge(intervals: list) -> list:
    """Sorted, non-overlapping union of (start, end) intervals."""
    merged: list = []
    for lo, hi in sorted(intervals):
        if merged and lo <= merged[-1][1]:
            merged[-1] = (merged[-1][0], max(merged[-1][1], hi))
        else:
            merged.append((lo, hi))
    return merged


def _uncovered(intervals: list, cover: list) -> float:
    """Length of ``intervals``' union not overlapped by ``cover``'s union
    (measured exposed communication)."""
    merged_cover = _merge(cover)
    exposed = 0.0
    for lo, hi in _merge(intervals):
        covered = 0.0
        for clo, chi in merged_cover:
            if chi <= lo:
                continue
            if clo >= hi:
                break
            covered += min(hi, chi) - max(lo, clo)
        exposed += (hi - lo) - covered
    return exposed


def parse_trace(events: Iterable[Mapping], step_name: Optional[str] = None) -> TraceSummary:
    """Bucket a torch trace's device slices by kernel and by the step that
    launched them.

    Device slices are the complete (``ph == "X"``) events of category
    ``kernel``, ``gpu_memcpy`` or ``gpu_memset``. Steps are host ranges
    named ``serve_tick#N`` or ``ProfilerStep#N`` (``step_name`` keeps one
    of the two); a range entered more than once under one step merges.
    Each slice's ``args.correlation`` finds the host event that launched
    it (any other event carrying the same correlation id), and the slice
    belongs to the step whose range holds that launch; a slice with no
    launch event, or launched outside every step, is unattributed."""
    slices: list = []
    correlations: list = []  # (correlation id, slice index)
    launches: dict = {}      # correlation id -> host launch ts
    windows: dict = {}       # (name, step) -> [start, end]
    for event in events:
        if event.get("ph") != "X":
            continue
        args = event.get("args") or {}
        cat = str(event.get("cat", ""))
        ts = float(event.get("ts", 0.0))
        dur = float(event.get("dur", 0.0))
        name = str(event.get("name", ""))
        if cat in DEVICE_CATS:
            if dur <= 0:
                continue
            canon = canonical_op_name(name)
            opcode = opcode_of(canon)
            slices.append(OpSlice(name=name, canon=canon, opcode=opcode,
                                  category=categorize(name, cat),
                                  module=PORT_KERNELS.get(opcode, ""), ts_us=ts, dur_us=dur))
            if "correlation" in args:
                correlations.append((args["correlation"], len(slices) - 1))
            continue
        if cat.startswith("gpu_"):
            continue  # device-side projections of host annotations
        if "correlation" in args:
            launches.setdefault(args["correlation"], ts)
        match = _STEP_RE.match(name)
        if match is not None and (step_name is None or match.group(1) == step_name):
            window = windows.setdefault((match.group(1), int(match.group(2))), [ts, ts + dur])
            window[0] = min(window[0], ts)
            window[1] = max(window[1], ts + dur)

    steps = [StepRecord(name=name, step=step, start_us=lo, end_us=hi, wall_us=hi - lo)
             for (name, step), (lo, hi) in sorted(windows.items(), key=lambda kv: kv[0][1])]

    per_step: dict = {i: [] for i in range(len(steps))}
    attributed: set = set()
    for corr, index in correlations:
        t = launches.get(corr)
        if t is None:
            continue
        for i, rec in enumerate(steps):
            if rec.start_us <= t < rec.end_us:
                per_step[i].append(slices[index])
                attributed.add(index)
                break
    unattributed_us = sum(s.dur_us for i, s in enumerate(slices) if i not in attributed)

    for i, rec in enumerate(steps):
        group = per_step[i]
        if not group:
            continue
        intervals = [(s.ts_us, s.ts_us + s.dur_us) for s in group]
        rec.device_span_us = max(hi for _, hi in intervals) - min(lo for lo, _ in intervals)
        rec.device_busy_us = _union_length(intervals)
        comm = [(s.ts_us, s.ts_us + s.dur_us) for s in group if s.category == "collective"]
        cover = [(s.ts_us, s.ts_us + s.dur_us) for s in group if s.category != "collective"]
        rec.exposed_comm_us = _uncovered(comm, cover) if comm else 0.0
        for s in group:
            rec.categories[s.category] = rec.categories.get(s.category, 0.0) + s.dur_us
            rec.kernels[s.opcode] = rec.kernels.get(s.opcode, 0) + 1

    ops: dict = {}
    modules: dict = {}
    for s in slices:
        key = (s.module, s.canon)
        op = ops.get(key)
        if op is None:
            op = ops[key] = MeasuredOp(name=s.canon, opcode=s.opcode, category=s.category,
                                       module=s.module)
        op.total_us += s.dur_us
        op.count += 1
        modules[s.module] = modules.get(s.module, 0.0) + s.dur_us

    return TraceSummary(ops=sorted(ops.values(), key=lambda o: -o.total_us), steps=steps,
                        modules=modules, n_slices=len(slices), unattributed_us=unattributed_us)


# -- records / gauges / rendering --------------------------------------------------


def prof_record(summary: TraceSummary, top: int = 10) -> dict:
    """The flat record the gauges and the CLI's JSON read: per-step means
    over the attributed steps and the whole trace's category split."""
    n_steps = len(summary.steps)
    totals = summary.category_totals()
    device_total = sum(totals.values()) or 1.0
    record = {
        "n_steps": n_steps,
        "n_slices": summary.n_slices,
        "measured_step_us": round(summary.mean("device_span_us"), 3),
        "wall_step_us": round(summary.mean("wall_us"), 3),
        "device_busy_us": round(summary.mean("device_busy_us"), 3),
        "exposed_comm_us": round(summary.mean("exposed_comm_us"), 3),
        "categories_us": {k: round(v, 3) for k, v in sorted(totals.items())},
        "category_fractions": {k: round(v / device_total, 4) for k, v in sorted(totals.items())},
        "top_ops": [
            {"name": op.name, "category": op.category, "module": op.module,
             "total_us": round(op.total_us, 3), "count": op.count}
            for op in summary.ops[:top]
        ],
    }
    if n_steps:
        busy = summary.mean("device_busy_us")
        span = summary.mean("device_span_us")
        record["device_busy_frac"] = round(busy / span, 4) if span else 0.0
    return record


def publish_prof(registry, record: Mapping, prefix: str = "obs/prof") -> None:
    """Land a :func:`prof_record`'s scalars as registry gauges, and count
    the window in ``<prefix>/windows_parsed``."""
    for key in ("n_steps", "measured_step_us", "wall_step_us", "device_busy_us",
                "exposed_comm_us", "device_busy_frac"):
        value = record.get(key)
        if isinstance(value, (int, float)):
            registry.gauge(f"{prefix}/{key}").set(float(value))
    for cat, frac in (record.get("category_fractions") or {}).items():
        registry.gauge(f"{prefix}/frac_{cat}").set(float(frac))
    registry.counter(f"{prefix}/windows_parsed").inc()


def render_prof(summary: TraceSummary, record: Optional[Mapping] = None, top: int = 15) -> str:
    """Human table: the per-step headline and the top ops."""
    record = record or prof_record(summary, top=top)
    lines = [
        f"device trace: {summary.n_slices} slices, {record['n_steps']} annotated step(s), "
        f"{len(summary.modules)} module(s)",
    ]
    if record["n_steps"]:
        lines.append(
            f"per step: wall {record['wall_step_us']:.1f} us, device span "
            f"{record['measured_step_us']:.1f} us (busy {record['device_busy_us']:.1f} us), "
            f"exposed comm {record['exposed_comm_us']:.1f} us"
        )
    cats = record["categories_us"]
    if cats:
        fracs = record["category_fractions"]
        lines.append("category totals:")
        for cat in sorted(cats, key=lambda c: -cats[c]):
            lines.append(f"  {cat:<12} {cats[cat]:>12.1f} us  {fracs[cat]:>7.1%}")
    ops = summary.ops[:top]
    if ops:
        lines.append(f"{'op':<44} {'category':<11} {'count':>6} {'total_us':>11} {'mean_us':>9}")
        for op in ops:
            lines.append(f"{op.name[:44]:<44} {op.category:<11} {op.count:>6} "
                         f"{op.total_us:>11.1f} {op.mean_us:>9.2f}")
    return "\n".join(lines)


# -- the calibration's join ----------------------------------------------------------


def _top_ops(ops: list, names) -> list:
    """One thread's ``(start, end, name)`` host ranges -> the outermost of
    them named in ``names`` (none of their enclosing ranges is), sorted."""
    top, stack = [], []
    for lo, hi, name in sorted(ops, key=lambda o: (o[0], -o[1])):
        while stack and stack[-1][1] <= lo:
            stack.pop()
        if name in names and not any(entry[2] for entry in stack):
            top.append((lo, hi, name))
        stack.append((lo, hi, name in names))
    return top


def _enclosing(top: list, starts: list, t: float):
    """The range of ``top`` (sorted, disjoint) holding ``t``, or None."""
    import bisect

    i = bisect.bisect_right(starts, t) - 1
    return top[i] if i >= 0 and top[i][0] <= t < top[i][1] else None


def parse_op_trace(events: Iterable[Mapping], op_names, step_name: Optional[str] = None
                   ) -> TraceSummary:
    """A trace's device time by the op that launched it (the module
    docstring's join), per annotated step: each :class:`MeasuredOp` is one
    op of the step named ``<op>#<k>`` (the k-th op of that name the step
    issued, or the k-th launch of a hand kernel under its ``LaunchFact``
    name), its ``total_us`` summed over the steps and ``count`` the steps
    that ran it. ``op_names`` are the aten ops the priced step holds
    (``"aten::mm"``, ...). A device slice whose launch sits under none of
    them keeps its kernel's name and category (unjoined). Slices launched
    outside every step are left out (``unattributed_us``). A trace with no
    device slices (a CPU run) measures its outermost ``op_names`` ranges
    as the slices."""
    names = frozenset(op_names)
    host: dict = {}          # (pid, tid) -> [(start, end, name)]
    launches: dict = {}      # correlation id -> (pid, tid, ts)
    device: list = []        # (correlation, name, cat, ts, dur)
    windows: dict = {}
    for event in events:
        if event.get("ph") != "X":
            continue
        args = event.get("args") or {}
        cat, name = str(event.get("cat", "")), str(event.get("name", ""))
        ts, dur = float(event.get("ts", 0.0)), float(event.get("dur", 0.0))
        if cat in DEVICE_CATS:
            if dur > 0:
                device.append((args.get("correlation"), name, cat, ts, dur))
            continue
        if cat.startswith("gpu_"):
            continue
        where = (event.get("pid"), event.get("tid"))
        if cat == "cpu_op":
            host.setdefault(where, []).append((ts, ts + dur, name))
        if "correlation" in args:
            launches.setdefault(args["correlation"], (where, ts))
        match = _STEP_RE.match(name)
        if match is not None and (step_name is None or match.group(1) == step_name):
            window = windows.setdefault((match.group(1), int(match.group(2))), [ts, ts + dur])
            window[0] = min(window[0], ts)
            window[1] = max(window[1], ts + dur)
    steps = [StepRecord(name=name, step=step, start_us=lo, end_us=hi, wall_us=hi - lo)
             for (name, step), (lo, hi) in sorted(windows.items(), key=lambda kv: kv[0][1])]
    tops = {where: _top_ops(ops, names) for where, ops in host.items()}
    starts = {where: [lo for lo, _, _ in top] for where, top in tops.items()}

    # (host time, instance, key name, category, device ts, dur) per slice.
    measured: list = []
    if device:
        for corr, name, cat, ts, dur in device:
            canon = canonical_op_name(name)
            opcode = opcode_of(canon)
            launch = launches.get(corr)
            if launch is None:
                continue
            where, t = launch
            category = categorize(name, cat)
            if opcode in KERNEL_FACTS:
                measured.append((t, ("launch", corr), KERNEL_FACTS[opcode], category, ts, dur))
                continue
            op = _enclosing(tops.get(where, []), starts.get(where, []), t)
            if op is None:
                measured.append((t, None, canon, category, ts, dur))
            else:
                measured.append((t, (where, op[0]), op[2], category, ts, dur))
    else:
        for where, top in tops.items():
            for lo, hi, name in top:
                measured.append((lo, (where, lo), name, categorize(name), lo, hi - lo))

    ops: dict = {}
    attributed = 0.0
    total = sum(m[5] for m in measured)
    for i, rec in enumerate(steps):
        group = [m for m in measured if rec.start_us <= m[0] < rec.end_us]
        if not group:
            continue
        intervals = [(m[4], m[4] + m[5]) for m in group]
        rec.device_span_us = max(hi for _, hi in intervals) - min(lo for lo, _ in intervals)
        rec.device_busy_us = _union_length(intervals)
        comm = [(m[4], m[4] + m[5]) for m in group if m[3] == "collective"]
        cover = [(m[4], m[4] + m[5]) for m in group if m[3] != "collective"]
        rec.exposed_comm_us = _uncovered(comm, cover) if comm else 0.0
        first: dict = {}     # instance -> host time of its first slice
        for m in group:
            if m[1] is not None:
                first.setdefault((m[1], m[2]), m[0])
        ordinal: dict = {}
        key_of: dict = {}
        for (instance, name), _t in sorted(first.items(), key=lambda kv: kv[1]):
            k = ordinal.get(name, 0)
            ordinal[name] = k + 1
            key_of[(instance, name)] = f"{name}#{k}"
        seen = set()
        for m in group:
            rec.categories[m[3]] = rec.categories.get(m[3], 0.0) + m[5]
            key = key_of.get((m[1], m[2]), m[2])
            op = ops.get(key)
            if op is None:
                op = ops[key] = MeasuredOp(name=key, opcode=m[2], category=m[3], module="")
            op.total_us += m[5]
            if key not in seen:
                seen.add(key)
                op.count += 1
            attributed += m[5]
    return TraceSummary(ops=sorted(ops.values(), key=lambda o: -o.total_us), steps=steps,
                        modules={"": attributed}, n_slices=len(measured),
                        unattributed_us=total - attributed)
