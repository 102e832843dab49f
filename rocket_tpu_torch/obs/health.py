"""Training-health sentinels: a health word computed on the card inside
every train step (counterpart of ``rocket_tpu/obs/health.py``).

Two halves, as in the reference:

* **On the card** (torch ops on the step's own tensors, no host read):
  non-finite flags for the loss and, per top-level branch of the params
  tree, for the gradients and the updated params; the global gradient
  norm, the param norm, the update ratio ||update|| / ||params||, and a
  z-score of the loss against an exponential moving average. They are
  packed into one small f32 tensor, the *health word*, whose layout is the
  reference's (:data:`HEADER_SLOTS` header slots, then one gradient flag
  and one param flag per branch), so the two packages' words compare slot
  for slot. A few state tensors (the loss moments and the skip and anomaly
  counts, :func:`init_state`) live in the train state and checkpoint with
  it (``health/...``). When the anomaly action gates updates, the Module
  applies its update through ``optim.gated_step``: a step whose loss or
  gradients are not finite leaves every param, moment, count and EMA
  bitwise as it was, with no branch on a device value.
* **On the host** (:class:`HealthMonitor`): each word is copied to pinned
  host memory by a ``non_blocking`` copy with a CUDA event recorded behind
  it, and read only once it is ``fetch_lag`` steps old, after its event has
  completed, through the runtime's one explicit-transfer helper
  (``runtime.explicit_transfer``). The step path therefore never waits on
  the card, and stays legal under ``Runtime(strict=True)``. Decoded words
  feed the registry (``health/*``), the flight recorder and the anomaly
  policy (:data:`ANOMALY_ACTIONS`): ``warn`` logs and counts,
  ``skip_step`` logs the update the gate already held, ``dump_and_halt``
  writes a black-box bundle and raises :class:`HealthAnomalyError`.

Enable with ``Runtime(health=True, anomaly_action=...)`` or
``ROCKET_TPU_HEALTH=1|warn|skip_step|dump_and_halt``.
"""

from __future__ import annotations

import collections
import math
import time
from dataclasses import dataclass
from typing import Optional, Sequence

import numpy as np
import torch

__all__ = [
    "ANOMALY_ACTIONS", "HEADER_SLOTS", "HealthAnomalyError", "HealthConfig", "HealthMonitor",
    "branch_names", "branch_sumsq", "decode_word", "init_state", "step_flags",
    "update_sentinels", "word_length",
]

#: What ``Runtime(anomaly_action=)`` takes.
ANOMALY_ACTIONS = ("warn", "skip_step", "dump_and_halt")

# The word's header slots (the reference's layout, ``:170``), f32 all.
SLOT_STEP, SLOT_FLAGS, SLOT_LOSS, SLOT_LOSS_Z = 0, 1, 2, 3
SLOT_GRAD_NORM, SLOT_PARAM_NORM, SLOT_UPDATE_RATIO = 4, 5, 6
SLOT_SKIPPED, SLOT_ANOMALIES, SLOT_STEP_HI = 7, 8, 9
HEADER_SLOTS = 10
#: f32 is exact for integers below 2^24 only, so the step rides as
#: ``hi * 2^20 + lo``.
_STEP_SPLIT = 1 << 20

FLAG_LOSS_NONFINITE, FLAG_GRADS_NONFINITE, FLAG_PARAMS_NONFINITE, FLAG_LOSS_ZSCORE = 1, 2, 4, 8
_FLAG_NAMES = {FLAG_LOSS_NONFINITE: "loss_nonfinite", FLAG_GRADS_NONFINITE: "grads_nonfinite",
               FLAG_PARAMS_NONFINITE: "params_nonfinite", FLAG_LOSS_ZSCORE: "loss_zscore_breach"}
#: Flags that make a step an anomaly; a z-score breach only warns.
_ANOMALY_MASK = FLAG_LOSS_NONFINITE | FLAG_GRADS_NONFINITE | FLAG_PARAMS_NONFINITE


@dataclass
class HealthConfig:
    """The sentinels' knobs (the Runtime owns one). ``fetch_lag``: a word
    is read this many steps after its step; ``ema_decay``, ``zscore_max``,
    ``zscore_warmup``: the loss z-score's baseline, threshold and warmup."""

    enabled: bool = False
    action: str = "warn"
    fetch_lag: int = 2
    ema_decay: float = 0.98
    zscore_max: float = 8.0
    zscore_warmup: int = 20

    def __post_init__(self) -> None:
        if self.action not in ANOMALY_ACTIONS:
            raise ValueError(f"anomaly_action must be one of {ANOMALY_ACTIONS}, "
                             f"got {self.action!r}")
        if self.fetch_lag < 1:
            raise ValueError(f"health fetch_lag must be >= 1, got {self.fetch_lag}")

    @property
    def gated(self) -> bool:
        """Whether the step gates its update on the step-ok predicate (both
        halting actions do, so an emergency checkpoint holds finite state)."""
        return self.action in ("skip_step", "dump_and_halt")


class HealthAnomalyError(RuntimeError):
    """Raised under ``dump_and_halt``; ``record`` is the decoded word and
    ``bundle`` the black-box directory (None when none was written)."""

    def __init__(self, message: str, record: Optional[dict] = None,
                 bundle: Optional[str] = None) -> None:
        super().__init__(message)
        self.record = record
        self.bundle = bundle


# -- on the card ---------------------------------------------------------------


def branch_names(params) -> tuple:
    """The word's branch order: a dict's top-level keys, sorted; one
    ``"params"`` branch for anything else."""
    if isinstance(params, dict) and params:
        return tuple(sorted(str(k) for k in params))
    return ("params",)


def _branches(tree) -> list:
    if isinstance(tree, dict) and tree:
        return [tree[k] for k in sorted(tree, key=str)]
    return [tree]


def _float_leaves(tree) -> list:
    if isinstance(tree, dict):
        return [leaf for v in tree.values() for leaf in _float_leaves(v)]
    if isinstance(tree, (list, tuple)):
        return [leaf for v in tree for leaf in _float_leaves(v)]
    return [tree] if isinstance(tree, torch.Tensor) and tree.is_floating_point() else []


def word_length(n_branches: int) -> int:
    return HEADER_SLOTS + 2 * n_branches


def init_state(device=None) -> dict:
    """The sentinel state kept in the train state (``state["health"]``)."""
    f32 = dict(dtype=torch.float32, device=device)
    i32 = dict(dtype=torch.int32, device=device)
    return {"loss_ema": torch.zeros((), **f32), "loss_sq_ema": torch.zeros((), **f32),
            "count": torch.zeros((), **i32), "skipped": torch.zeros((), **i32),
            "anomalies": torch.zeros((), **i32)}


def branch_sumsq(tree) -> torch.Tensor:
    """f32 sum of squares of each top-level branch, in :func:`branch_names`
    order, from one multi-tensor pass over all the leaves
    (``torch._foreach_norm``, each leaf's norm squared and summed per branch
    in f32). A NaN or Inf anywhere in a branch makes its sum non-finite, so
    the same numbers give the branch flags and the global norm. As in the
    reference, a finite branch whose sum of squares overflows f32 reads as
    non-finite."""
    groups = [_float_leaves(branch) for branch in _branches(tree)]
    leaves = [leaf for group in groups for leaf in group]
    if not leaves:
        return torch.zeros(len(groups), dtype=torch.float32)
    squares = torch.stack(torch._foreach_norm(leaves)).float().square()
    sums, start = [], 0
    for group in groups:
        part = squares[start:start + len(group)]
        sums.append(part.sum() if len(group) else squares.new_zeros(()))
        start += len(group)
    return torch.stack(sums)


def step_flags(loss, grads, g_sq=None):
    """The pre-update predicates: ``(step_ok, loss_ok, grad_branch_ok,
    grad_norm)``, ``grad_branch_ok`` f32 per branch (1.0 finite). The gate
    keys on ``step_ok`` (finite loss and gradients); param flags come after
    the update (:func:`update_sentinels`) and flag but never gate. ``g_sq``:
    the branches' sums of squares when the caller made them (a sharded
    layout sums its shards over the ranks), else :func:`branch_sumsq`."""
    loss_ok = torch.isfinite(loss.float())
    if g_sq is None:
        g_sq = branch_sumsq(grads)
    grad_branch_ok = torch.isfinite(g_sq).float()
    step_ok = loss_ok & (grad_branch_ok > 0.5).all()
    return step_ok, loss_ok, grad_branch_ok, g_sq.sum().sqrt()


def update_sentinels(h_state: dict, *, loss, step: int, step_ok, loss_ok, grad_branch_ok,
                     grad_norm, update_norm, new_params, gated: bool, ema_decay: float,
                     zscore_max: float, zscore_warmup: int, p_sq=None):
    """The post-update half: fold this step into the sentinel state and pack
    the word. Returns ``(new_h_state, word, {"update_ratio", "param_norm"})``.
    ``update_norm`` is ||update|| of the step (0 for a held one); ``step``
    a host int. Every value is made on the card (``torch.full`` for the
    step's halves: no host-to-device copy)."""
    loss32 = loss.float()
    count, ema, sq_ema = h_state["count"], h_state["loss_ema"], h_state["loss_sq_ema"]
    # The z-score against the moments before this step, off in warmup and
    # on a non-finite loss.
    var = torch.clamp(sq_ema - ema * ema, min=0.0)
    z_raw = (loss32 - ema) / torch.sqrt(var + 1e-12)
    scoring = (count >= zscore_warmup) & loss_ok
    z = torch.where(scoring, z_raw, 0.0)
    z_breach = scoring & (z.abs() > zscore_max)
    # Only a finite loss moves the moments; the first one seeds them.
    safe = torch.where(loss_ok, loss32, ema)
    first = count == 0
    new_ema = torch.where(loss_ok, torch.where(first, safe,
                                               ema_decay * ema + (1.0 - ema_decay) * safe), ema)
    new_sq = torch.where(loss_ok, torch.where(first, safe * safe, ema_decay * sq_ema
                                              + (1.0 - ema_decay) * safe * safe), sq_ema)
    if p_sq is None:  # else the caller's, summed over a sharded layout's ranks
        p_sq = branch_sumsq(new_params)
    param_branch_ok = torch.isfinite(p_sq).float()
    param_norm = p_sq.sum().sqrt()
    update_ratio = update_norm.float() / (param_norm + 1e-12)
    grads_ok = (grad_branch_ok > 0.5).all()
    params_ok = (param_branch_ok > 0.5).all()
    flags = ((~loss_ok).float() * FLAG_LOSS_NONFINITE
             + (~grads_ok).float() * FLAG_GRADS_NONFINITE
             + (~params_ok).float() * FLAG_PARAMS_NONFINITE
             + z_breach.float() * FLAG_LOSS_ZSCORE)
    skipped = h_state["skipped"] + ((~step_ok).int() if gated else 0)
    anomalies = h_state["anomalies"] + (~step_ok | ~params_ok).int()
    device = loss32.device
    header = torch.stack([
        torch.full((), float(int(step) % _STEP_SPLIT), device=device), flags, loss32, z,
        grad_norm.float(), param_norm, update_ratio, skipped.float(), anomalies.float(),
        torch.full((), float(int(step) // _STEP_SPLIT), device=device)])
    word = torch.cat([header, 1.0 - grad_branch_ok, 1.0 - param_branch_ok])
    new_state = {"loss_ema": new_ema, "loss_sq_ema": new_sq,
                 "count": count + loss_ok.int(), "skipped": skipped, "anomalies": anomalies}
    return new_state, word, {"update_ratio": update_ratio, "param_norm": param_norm}


# -- on the host ---------------------------------------------------------------


def decode_word(word, branches: Sequence[str]) -> dict:
    """A fetched word as the JSON-friendly record the flight recorder keeps."""
    w = np.asarray(word, np.float64)
    flags = int(w[SLOT_FLAGS]) if math.isfinite(w[SLOT_FLAGS]) else 0
    n = len(branches)
    grad_bad, param_bad = w[HEADER_SLOTS:HEADER_SLOTS + n], w[HEADER_SLOTS + n:HEADER_SLOTS + 2 * n]
    return {
        "step": int(w[SLOT_STEP]) + int(w[SLOT_STEP_HI]) * _STEP_SPLIT,
        "flags": flags,
        "flag_names": [name for bit, name in _FLAG_NAMES.items() if flags & bit],
        "loss": float(w[SLOT_LOSS]), "loss_zscore": float(w[SLOT_LOSS_Z]),
        "grad_norm": float(w[SLOT_GRAD_NORM]), "param_norm": float(w[SLOT_PARAM_NORM]),
        "update_ratio": float(w[SLOT_UPDATE_RATIO]),
        "skipped_total": int(w[SLOT_SKIPPED]), "anomalies_total": int(w[SLOT_ANOMALIES]),
        "bad_grad_branches": [b for b, v in zip(branches, grad_bad) if v > 0.5],
        "bad_param_branches": [b for b, v in zip(branches, param_bad) if v > 0.5],
    }


class _InFlight:
    """One word on its way to the host: a ``non_blocking`` copy into pinned
    memory with a CUDA event behind it (a CPU word is just kept)."""

    __slots__ = ("host", "event")

    def __init__(self, word: torch.Tensor) -> None:
        word = word.detach()
        if word.device.type == "cuda":
            self.host = torch.empty(word.shape, dtype=word.dtype, pin_memory=True)
            self.host.copy_(word, non_blocking=True)
            self.event = torch.cuda.Event()
            self.event.record()
        else:
            self.host, self.event = word.clone(), None

    def read(self) -> np.ndarray:
        """The word as numpy, once its copy has landed. Through the explicit
        transfer helper: by ``fetch_lag`` steps the event has as a rule
        completed, so the wait costs nothing; when it has not, this is the
        one place the host waits for the card."""
        if self.event is not None:
            from rocket_tpu_torch.runtime import explicit_transfer

            with explicit_transfer():
                self.event.synchronize()
        return self.host.numpy().copy()


class HealthMonitor:
    """The host consumer of health words, one per Runtime: lagged fetch,
    decode, registry gauges, the flight recorder's feed and the anomaly
    policy. Inert (every call returns at once) when disabled."""

    def __init__(self, config: Optional[HealthConfig] = None, registry=None, flight=None,
                 logger=None) -> None:
        self.config = config or HealthConfig()
        self._registry = registry
        self.flight = flight
        self._logger = logger
        self._layouts: dict = {}   # label -> branch names
        self._pending: dict = {}   # label -> deque of (step, _InFlight, context)
        self.anomaly_records: list = []
        self.last_good_step: Optional[int] = None
        self._skipped_seen = self._anomalies_seen = 0
        self._zscore_breaches = self._nonfinite_metrics = 0
        self._halted = False

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    def register_step(self, label: str, branches: Sequence[str]) -> str:
        """Record the branch layout a Module's words carry under ``label``;
        returns the label to :meth:`observe` under — ``label#2`` and on when
        another layout already holds it, the same label for the same one."""
        branches, base, n = tuple(branches), label, 2
        while self._layouts.get(label, branches) != branches:
            label, n = f"{base}#{n}", n + 1
        self._layouts[label] = branches
        return label

    def observe(self, label: str, step: int, word, context: Optional[dict] = None) -> None:
        """Start this step's word on its way to the host, and decode the one
        that is now ``fetch_lag`` steps old."""
        if not self.config.enabled:
            return
        queue = self._pending.setdefault(label, collections.deque())
        queue.append((step, _InFlight(word), context))
        if len(queue) > self.config.fetch_lag:
            step, flight, context = queue.popleft()
            self._handle(label, step, flight.read(), context)

    def drain(self, raise_on_anomaly: bool = True) -> None:
        """Decode every queued word (epoch end, teardown), so an anomaly in
        the last ``fetch_lag`` steps acts; raises the first anomaly error
        after all are decoded."""
        if not self.config.enabled:
            return
        entries = [(label, *entry) for label, queue in self._pending.items() for entry in queue]
        for queue in self._pending.values():
            queue.clear()
        first: Optional[HealthAnomalyError] = None
        for label, step, flight, context in entries:
            try:
                self._handle(label, step, flight.read(), context)
            except HealthAnomalyError as exc:
                first = first or exc
        if first is not None and raise_on_anomaly:
            raise first

    def _handle(self, label: str, step: int, host_word, context: Optional[dict]) -> None:
        record = decode_word(host_word, self._layouts.get(label, ("params",)))
        record.update(label=label, wall_time=time.time(), **(context or {}))
        if self._registry is not None:
            for key, field in (("loss", "loss"), ("loss_zscore", "loss_zscore"),
                               ("grad_norm", "grad_norm"), ("param_norm", "param_norm"),
                               ("update_ratio", "update_ratio"),
                               ("skipped_steps", "skipped_total"),
                               ("anomalies", "anomalies_total")):
                self._registry.gauge(f"health/{key}").set(record[field])
        if self.flight is not None:
            self.flight.record(record)
        if record["flags"] & _ANOMALY_MASK:
            self._on_anomaly(record)
            return
        if record["flags"] & FLAG_LOSS_ZSCORE:
            self._zscore_breaches += 1
            if self._registry is not None:
                self._registry.counter("health/zscore_breaches").inc()
            self._warn(f"health: loss z-score breach at step {record['step']} "
                       f"(z={record['loss_zscore']:.2f}, loss={record['loss']:.4g})")
        self.last_good_step = record["step"]
        if self._registry is not None:
            self._registry.gauge("health/last_good_step").set(record["step"])

    def _on_anomaly(self, record: dict) -> None:
        self._anomalies_seen += 1
        self._skipped_seen = max(self._skipped_seen, record["skipped_total"])
        self.anomaly_records = (self.anomaly_records + [record])[-64:]
        if self.flight is not None:
            self.flight.note_anomaly(record)
        detail = f"step {record['step']}: {'+'.join(record['flag_names'])}"
        if record["bad_grad_branches"]:
            detail += f" grads[{','.join(record['bad_grad_branches'])}]"
        if record["bad_param_branches"]:
            detail += f" params[{','.join(record['bad_param_branches'])}]"
        action = self.config.action
        if action == "skip_step":
            self._warn(f"health: anomaly at {detail} — optimizer update skipped "
                       f"({record['skipped_total']} total)")
        elif action == "warn":
            self._warn(f"health: anomaly at {detail} (action=warn, continuing)")
        elif not self._halted:  # dump_and_halt: one bundle, one raise
            self._halted = True
            bundle = None
            if self.flight is not None:
                bundle = self.flight.dump(reason=f"anomaly_step{record['step']}",
                                          extra={"anomaly": record})
            raise HealthAnomalyError(
                f"health: anomaly at {detail} — black-box bundle "
                f"{bundle or '(not written on this process)'}; halting.",
                record=record, bundle=bundle)

    def note_nonfinite_metric(self, tag: str) -> None:
        """An eval metric came out non-finite (the Meter's publish), which
        the step sentinels cannot see."""
        if not self.config.enabled:
            return
        self._nonfinite_metrics += 1
        if self._registry is not None:
            self._registry.counter("health/nonfinite_metrics").inc()
        self._warn(f"health: published metric {tag!r} is non-finite")

    def summary(self) -> dict:
        """The ``health`` section of ``telemetry.json``."""
        return {"enabled": self.config.enabled, "action": self.config.action,
                "fetch_lag": self.config.fetch_lag, "anomalies": self._anomalies_seen,
                "skipped_steps": self._skipped_seen, "zscore_breaches": self._zscore_breaches,
                "nonfinite_metrics": self._nonfinite_metrics,
                "last_good_step": self.last_good_step}

    def _warn(self, message: str) -> None:
        if self._logger is not None:
            self._logger.warning("%s", message)
